"""The zoo's leaf codecs for the wire frame (port of ``repro.compress.wire``,
DESIGN.md §11).

``repro_torch.api.codecs`` owns the frame and ships the ``omc`` and ``raw``
kinds; this module registers ``topk``, ``ternary`` and ``pipeline``, so
strategy-encoded trees travel through the same ``encode_payload`` /
``decode_payload``.  Each kind's section is exactly
``StrategyLeaf.wire_body_bytes()`` bytes, the number every ledger reports,
and its layout is the reference's, so a frame from either package decodes
in the other.  The decoders take the device to decode to: ternary codes
unpack there (``unpack``, B4, on the card), top-k positions widen there
from the wire's uint32.  None of these kinds has a delta rule.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.api import codecs
from repro_torch.core import packing
from repro_torch.core.formats import FloatFormat, widen

from .pipeline import PipelineVariable
from .ternary import TERNARY_BITS, TernaryVariable
from .topk import TopKSparseVariable


def _host(t: torch.Tensor, dtype) -> bytes:
    return np.ascontiguousarray(t.detach().cpu().numpy().astype(dtype, copy=False)).tobytes()


def _read(body: memoryview, dtype, count: int, off: int, device) -> Tuple[torch.Tensor, int]:
    arr = np.frombuffer(body, dtype, count, off).copy()
    return torch.from_numpy(arr).to(device), off + arr.nbytes


def _encode_topk(leaf: TopKSparseVariable, base) -> Tuple[Dict[str, Any], List[bytes]]:
    meta = dict(kind="topk", shape=list(leaf.shape), k=leaf.k, vfmt=leaf.value_fmt.name,
                mode="full")
    vdtype = np.float32 if leaf.value_fmt.is_identity else np.uint32
    return meta, [_host(leaf.idx, np.uint32), _host(leaf.values, vdtype)]


def _decode_topk(meta: Dict[str, Any], body: memoryview, off: int, base, device):
    fmt = FloatFormat.parse(meta["vfmt"])
    k = int(meta["k"])
    idx, off = _read(body, np.uint32, k, off, device)
    if fmt.is_identity:
        vals, off = _read(body, np.float32, k, off, device)
    else:
        vals, off = _read(body, np.uint32, packing.packed_words(k, fmt.bits), off, device)
    return TopKSparseVariable(widen(idx), vals, tuple(meta["shape"]), fmt), off


def _encode_ternary(leaf: TernaryVariable, base) -> Tuple[Dict[str, Any], List[bytes]]:
    # a 0-d scale is written as shape [1], as the reference's
    # np.ascontiguousarray writes it
    meta = dict(kind="ternary", shape=list(leaf.shape), sb_shape=list(leaf.scale.shape) or [1],
                mode="full")
    words = packing.pack(leaf.codes.reshape(-1), TERNARY_BITS)
    return meta, [_host(words, np.uint32), _host(leaf.scale, np.float32)]


def _decode_ternary(meta: Dict[str, Any], body: memoryview, off: int, base, device):
    shape, sb_shape = tuple(meta["shape"]), tuple(meta["sb_shape"])
    n = math.prod(shape)
    words, off = _read(body, np.uint32, packing.packed_words(n, TERNARY_BITS), off, device)
    scale, off = _read(body, np.float32, math.prod(sb_shape), off, device)
    codes = packing.unpack(words, TERNARY_BITS, n, torch.uint8).reshape(shape)
    return TernaryVariable(codes, scale.reshape(sb_shape), shape), off


def _encode_pipeline(leaf: PipelineVariable, base) -> Tuple[Dict[str, Any], List[bytes]]:
    meta = dict(kind="pipeline", shape=list(leaf.shape), k=int(leaf.k), fmt=leaf.fmt.name,
                blen=len(leaf.blob), mode="full")
    return meta, [leaf.blob]


def _decode_pipeline(meta: Dict[str, Any], body: memoryview, off: int, base, device):
    blen = int(meta["blen"])
    blob = bytes(body[off:off + blen])
    if len(blob) != blen:
        raise codecs.CodecError("pipeline blob truncated")
    return PipelineVariable(blob, int(meta["k"]), tuple(meta["shape"]),
                            FloatFormat.parse(meta["fmt"]), torch.device(device)), off + blen


def register() -> None:
    codecs.register_leaf_codec("topk", TopKSparseVariable, _encode_topk, _decode_topk)
    codecs.register_leaf_codec("ternary", TernaryVariable, _encode_ternary, _decode_ternary)
    codecs.register_leaf_codec("pipeline", PipelineVariable, _encode_pipeline,
                               _decode_pipeline)


register()
