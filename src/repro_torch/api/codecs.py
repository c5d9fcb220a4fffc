"""Versioned binary wire codec for compressed parameter trees.

Port of ``repro.api.codecs``; payloads are byte-identical with the
reference's for the ``omc`` and ``raw`` leaf kinds, full and delta.  A
*payload* is the serialized form of a storage tree: ``CompressedVariable``
leaves travel as their exact-width packed bitstream (11 bits/param for
S1E3M7), everything else travels raw.  ``decode(encode(t)) == t``
code-for-code.

Frame layout (little-endian, version 1)::

    magic     4s   b"OMCW"
    version   u16
    flags     u16  bit 0: payload is a delta against a base tree
    round     u32  producer round index (informational)
    mlen      u32  manifest length in bytes
    blen      u64  body length in bytes
    crc       u32  zlib.crc32(manifest + body)
    digest    u32  tree_digest of the delta base (0 for full payloads)
    manifest  mlen bytes of JSON (tagged leaf paths, kinds, shapes, modes)
    body      blen bytes (per-leaf sections in manifest order)

Per-leaf body sections:

  * ``omc``/``full``:  s (f32), b (f32), packed codes (u32 words).
  * ``omc``/``delta``: s, b, sorted u32 indices of changed codes, packed
    XOR-of-codes for those indices (against the base tree's codes).
  * ``raw``/``full``:  the array bytes.
  * ``raw``/``delta``: sorted u32 indices + u32 XOR words over the array's
    32-bit bitview (4-byte dtypes only).

The encoder picks ``delta`` per leaf only when it is smaller than ``full``.

Packing runs where the codes live: on the card for CUDA trees (the ``pack``
and ``unpack`` kernels), with the plain versions for CPU trees; framing,
JSON and crc32 stay on the host.  The compression-strategy zoo's leaf kinds
(``topk``, ``ternary``, ``pipeline``) and strategy-tagged frames are not
ported yet and raise :class:`CodecError`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import struct
import zlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.formats import FloatFormat, narrow, widen
from repro_torch.core.store import CompressedVariable, is_compressed

MAGIC = b"OMCW"
WIRE_VERSION = 1
SUPPORTED_VERSIONS = (1,)

FLAG_DELTA = 1 << 0

# magic, version, flags, round, manifest len, body len, crc, base digest
_HEADER = struct.Struct("<4sHHIIQII")


class CodecError(ValueError):
    """Malformed, corrupt, version-incompatible or not-yet-ported payload."""


@dataclasses.dataclass(frozen=True)
class PayloadInfo:
    """Parsed frame metadata (available without decoding the body)."""

    version: int
    flags: int
    round_index: int
    header_bytes: int  # fixed header + manifest
    body_bytes: int
    total_bytes: int
    num_leaves: int
    num_compressed: int
    num_delta: int
    base_digest: int  # tree_digest of the delta base; 0 for full payloads

    @property
    def is_delta(self) -> bool:
        return bool(self.flags & FLAG_DELTA)


# ---------------------------------------------------------------------------
# tree <-> flat (path, leaf) list.  Container types are recorded in the path
# tags ('k' dict key, 'i' list index, 't' tuple index) so decode rebuilds the
# exact structure.
# ---------------------------------------------------------------------------


def _flatten(tree) -> List[Tuple[List[Any], Any]]:
    out: List[Tuple[List[Any], Any]] = []

    def walk(node, prefix):
        if is_compressed(node):
            out.append((prefix, node))
        elif isinstance(node, dict):
            if not node:
                raise CodecError("empty dict container is not serializable")
            for k in sorted(node):  # JAX tree order: sorted dict keys
                if not isinstance(k, str):
                    raise CodecError(f"non-string dict key {k!r} in wire tree")
                walk(node[k], prefix + [["k", k]])
        elif isinstance(node, (list, tuple)):
            if not node:
                raise CodecError("empty sequence container is not serializable")
            tag = "i" if isinstance(node, list) else "t"
            for j, v in enumerate(node):
                walk(v, prefix + [[tag, j]])
        else:
            out.append((prefix, node))

    walk(tree, [])
    return out


class _Node:
    __slots__ = ("tag", "kids")

    def __init__(self, tag):
        self.tag = tag
        self.kids: Dict[Any, Any] = {}


def _unflatten(entries: List[Tuple[List[Any], Any]]):
    """Rebuild nested dicts/lists/tuples from tagged paths."""
    if not entries:
        return {}
    if not entries[0][0]:
        if len(entries) != 1:
            raise CodecError("multiple leaves with an empty path")
        return entries[0][1]
    root = _Node(entries[0][0][0][0])
    for parts, leaf in entries:
        node = root
        for depth, (tag, key) in enumerate(parts):
            if node.tag != tag:
                raise CodecError("inconsistent container tags in manifest")
            if depth == len(parts) - 1:
                node.kids[key] = leaf
            else:
                child = node.kids.get(key)
                if not isinstance(child, _Node):
                    child = _Node(parts[depth + 1][0])
                    node.kids[key] = child
                node = child

    def materialize(n):
        if not isinstance(n, _Node):
            return n
        if n.tag == "k":
            return {k: materialize(v) for k, v in n.kids.items()}
        try:
            seq = [materialize(n.kids[i]) for i in range(len(n.kids))]
        except KeyError as e:
            raise CodecError(f"missing sequence index in manifest: {e}") from e
        return seq if n.tag == "i" else tuple(seq)

    return materialize(root)


def _path_key(parts: List[Any]) -> str:
    return "/".join(str(v) for _, v in parts)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a contiguous host array (numpy dtype of the tensor)."""
    return np.ascontiguousarray(t.detach().cpu().numpy())


def _f32_bytes(t: torch.Tensor) -> bytes:
    return _host(t.to(torch.float32)).tobytes()


def tree_digest(tree) -> int:
    """crc32 fingerprint of a storage tree (paths + codes + PVT scalars)."""
    h = 0
    for parts, leaf in _flatten(tree):
        h = zlib.crc32(_path_key(parts).encode(), h)
        if is_compressed(leaf):
            h = zlib.crc32(_host(leaf.codes).tobytes(), h)
            h = zlib.crc32(_f32_bytes(leaf.s), h)
            h = zlib.crc32(_f32_bytes(leaf.b), h)
            h = zlib.crc32(leaf.fmt.name.encode(), h)
        else:
            h = zlib.crc32(_host(leaf).tobytes(), h)
    return h


# ---------------------------------------------------------------------------
# per-leaf encoding
# ---------------------------------------------------------------------------


def _encode_omc(cv: CompressedVariable, base) -> Tuple[Dict[str, Any], List[bytes]]:
    fmt = cv.fmt
    codes = cv.codes.reshape(-1)
    meta = dict(
        kind="omc",
        fmt=fmt.name,
        shape=list(cv.codes.shape),
        # record the true (s, b) shape so 0-d PVT scalars survive the roundtrip
        sb_shape=list(cv.s.shape),
        mode="full",
    )
    full_words = packing.pack(codes, fmt.bits)
    chunks = [_f32_bytes(cv.s), _f32_bytes(cv.b)]
    if (
        base is not None
        and is_compressed(base)
        and base.fmt == fmt
        and tuple(base.codes.shape) == tuple(cv.codes.shape)
    ):
        xor = widen(codes) ^ widen(base.codes.reshape(-1).to(codes.device))
        idx = torch.nonzero(xor).reshape(-1)
        nnz = idx.numel()
        delta_bytes = 4 * nnz + 4 * packing.packed_words(max(nnz, 1), fmt.bits)
        if nnz and delta_bytes < 4 * full_words.numel():
            meta["mode"] = "delta"
            meta["nnz"] = nnz
            chunks.append(_host(idx).astype(np.uint32).tobytes())
            xor_codes = narrow(xor[idx], fmt.container_dtype)
            chunks.append(_host(packing.pack(xor_codes, fmt.bits)).tobytes())
            return meta, chunks
        if nnz == 0:
            meta["mode"] = "delta"
            meta["nnz"] = 0
            return meta, chunks
    chunks.append(_host(full_words).tobytes())
    return meta, chunks


def _encode_raw(leaf: torch.Tensor, base) -> Tuple[Dict[str, Any], List[bytes]]:
    arr = _host(leaf)
    meta = dict(kind="raw", dtype=arr.dtype.str, shape=list(arr.shape), mode="full")
    if (
        isinstance(base, torch.Tensor)
        and base.dtype == leaf.dtype
        and tuple(base.shape) == arr.shape
        and arr.dtype.itemsize == 4
    ):
        xor = arr.view(np.uint32).reshape(-1) ^ _host(base).view(np.uint32).reshape(-1)
        (idx,) = np.nonzero(xor)
        if 8 * idx.size < arr.nbytes:
            meta["mode"] = "delta"
            meta["nnz"] = int(idx.size)
            return meta, [idx.astype(np.uint32).tobytes(),
                          np.ascontiguousarray(xor[idx]).tobytes()]
    return meta, [arr.tobytes()]


def _read(body: memoryview, dtype, count: int, off: int, device) -> Tuple[torch.Tensor, int]:
    """``count`` items of ``dtype`` at byte ``off`` -> a tensor on ``device``."""
    arr = np.frombuffer(body, dtype, count, off).copy()
    return torch.from_numpy(arr).to(device), off + arr.nbytes


def _decode_omc(meta: Dict[str, Any], body: memoryview, off: int, base, device):
    fmt = FloatFormat.parse(meta["fmt"])
    shape = tuple(meta["shape"])
    sb_shape = tuple(meta.get("sb_shape", ()))
    n = math.prod(shape)
    n_sb = math.prod(sb_shape)
    s, off = _read(body, np.float32, n_sb, off, device)
    b, off = _read(body, np.float32, n_sb, off, device)
    if meta["mode"] == "delta":
        if base is None or not is_compressed(base):
            raise CodecError("delta leaf but no compressed base variable was supplied")
        if base.fmt != fmt or tuple(base.codes.shape) != shape:
            raise CodecError("delta base mismatch (format or shape)")
        codes = widen(base.codes.reshape(-1).to(device))
        nnz = int(meta["nnz"])
        if nnz:
            idx, off = _read(body, np.uint32, nnz, off, device)
            idx = widen(idx)
            words, off = _read(body, np.uint32, packing.packed_words(nnz, fmt.bits), off, device)
            codes[idx] ^= widen(packing.unpack(words, fmt.bits, nnz, fmt.container_dtype))
        codes = narrow(codes, fmt.container_dtype)
    else:
        words, off = _read(body, np.uint32, packing.packed_words(n, fmt.bits), off, device)
        codes = packing.unpack(words, fmt.bits, n, fmt.container_dtype)
    cv = CompressedVariable(codes.reshape(shape), s.reshape(sb_shape), b.reshape(sb_shape), fmt)
    return cv, off


def _decode_raw(meta: Dict[str, Any], body: memoryview, off: int, base, device):
    dtype = np.dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    n = math.prod(shape)
    if meta["mode"] == "delta":
        if not isinstance(base, torch.Tensor):
            raise CodecError("delta leaf but no matching raw base was supplied")
        barr = _host(base)
        if barr.dtype != dtype or barr.shape != shape:
            raise CodecError("delta base mismatch (dtype or shape)")
        bits = barr.view(np.uint32).reshape(-1).copy()
        nnz = int(meta["nnz"])
        if nnz:
            idx = np.frombuffer(body, np.uint32, nnz, off)
            off += 4 * nnz
            bits[idx] ^= np.frombuffer(body, np.uint32, nnz, off)
            off += 4 * nnz
        arr = torch.from_numpy(bits.view(dtype).reshape(shape)).to(device)
    else:
        arr, off = _read(body, dtype, n, off, device)
        arr = arr.reshape(shape)
    return arr, off


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def encode_payload(tree, *, base=None, round_index: int = 0) -> bytes:
    """Serialize a storage tree to a wire payload.

    ``base`` (the tree the receiver already holds) switches each leaf to
    sparse XOR-delta encoding when that is smaller; the receiver must then
    pass the same base to :func:`decode_payload`.
    """
    base_leaves: Dict[str, Any] = {}
    if base is not None:
        base_leaves = {_path_key(p): leaf for p, leaf in _flatten(base)}

    manifest: List[Dict[str, Any]] = []
    chunks: List[bytes] = []
    any_delta = False
    for parts, leaf in _flatten(tree):
        bleaf = base_leaves.get(_path_key(parts))
        if is_compressed(leaf):
            meta, ch = _encode_omc(leaf, bleaf)
        elif isinstance(leaf, torch.Tensor):
            meta, ch = _encode_raw(leaf, bleaf)
        else:
            raise CodecError(f"leaf of type {type(leaf).__name__} at "
                             f"{_path_key(parts)!r}: strategy leaf kinds are not yet ported")
        any_delta |= meta["mode"] == "delta"
        meta["path"] = parts
        manifest.append(meta)
        chunks.extend(ch)

    mjson = json.dumps(dict(leaves=manifest), separators=(",", ":")).encode()
    body = b"".join(chunks)
    flags = FLAG_DELTA if any_delta else 0
    digest = tree_digest(base) if any_delta else 0
    crc = zlib.crc32(body, zlib.crc32(mjson))
    header = _HEADER.pack(MAGIC, WIRE_VERSION, flags, int(round_index), len(mjson),
                          len(body), crc, digest)
    return header + mjson + body


def _parse_frame(data: bytes) -> Tuple[PayloadInfo, Dict[str, Any], memoryview]:
    """Validate framing + checksum; parse the manifest exactly once."""
    if len(data) < _HEADER.size:
        raise CodecError(f"payload truncated: {len(data)} bytes")
    magic, ver, flags, rnd, mlen, blen, crc, digest = _HEADER.unpack_from(data)
    if magic != MAGIC:
        raise CodecError(f"bad magic {magic!r}")
    if ver not in SUPPORTED_VERSIONS:
        raise CodecError(f"unsupported wire version {ver}; supported: {SUPPORTED_VERSIONS}")
    if len(data) != _HEADER.size + mlen + blen:
        raise CodecError(f"length mismatch: header says {_HEADER.size + mlen + blen}, "
                         f"got {len(data)}")
    mview = memoryview(data)
    payload = mview[_HEADER.size:]
    if zlib.crc32(payload) != crc:
        raise CodecError("checksum mismatch: payload corrupt")
    try:
        manifest = json.loads(bytes(payload[:mlen]).decode())
        leaves = manifest["leaves"]
    except (ValueError, KeyError, TypeError) as e:
        raise CodecError(f"malformed manifest: {e}") from e
    if manifest.get("strategy") is not None:
        raise CodecError(f"strategy-tagged payload ({manifest['strategy']!r}): the "
                         f"compression-strategy zoo is not yet ported")
    info = PayloadInfo(
        version=ver,
        flags=flags,
        round_index=rnd,
        header_bytes=_HEADER.size + mlen,
        body_bytes=blen,
        total_bytes=len(data),
        num_leaves=len(leaves),
        num_compressed=sum(1 for leaf in leaves if leaf["kind"] != "raw"),
        num_delta=sum(1 for leaf in leaves if leaf["mode"] == "delta"),
        base_digest=digest,
    )
    return info, manifest, mview[info.header_bytes:]


def decode_payload(data: bytes, *, base=None, device="cuda") -> Tuple[Any, PayloadInfo]:
    """Payload bytes -> (storage tree on ``device``, PayloadInfo).  Bit-exact
    inverse of :func:`encode_payload`.

    Delta payloads require the encoder's ``base`` and verify it by digest.
    For full payloads ``base`` is ignored.
    """
    info, manifest, body = _parse_frame(data)
    if info.is_delta:
        if base is None:
            raise CodecError("delta payload requires the base tree it was built on")
        if tree_digest(base) != info.base_digest:
            raise CodecError("delta base mismatch: payload was encoded against a different "
                             "tree than the one supplied (stale or wrong-round base)")
    base_leaves: Dict[str, Any] = {}
    if base is not None:
        base_leaves = {_path_key(p): leaf for p, leaf in _flatten(base)}

    entries = []
    off = 0
    for meta in manifest["leaves"]:
        parts = [list(p) for p in meta["path"]]
        bleaf = base_leaves.get(_path_key(parts))
        if meta["kind"] == "omc":
            leaf, off = _decode_omc(meta, body, off, bleaf, device)
        elif meta["kind"] == "raw":
            leaf, off = _decode_raw(meta, body, off, bleaf, device)
        else:
            raise CodecError(f"leaf kind {meta['kind']!r} is not yet ported")
        entries.append((parts, leaf))
    if off != info.body_bytes:
        raise CodecError(f"body length mismatch: consumed {off}, have {info.body_bytes}")
    return _unflatten(entries), info
