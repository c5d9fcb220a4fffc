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
JSON and crc32 stay on the host.

Strategy leaves: :func:`register_leaf_codec` registers a leaf kind beyond
the built-in ``omc`` and ``raw``, as the reference's does, and the encode,
:func:`decode_payload`, :func:`tree_digest` and :func:`payload_bytes_report`
consult the registry.  ``repro_torch.compress`` registers the zoo's kinds
(``topk``, ``ternary``, ``pipeline``).  A frame holding a strategy's leaves
(or encoded with ``strategy=``) carries the strategy's tag and wire version
in its manifest, as the reference's does; decoding an unknown tag or another
wire version raises :class:`CodecError`.  Frames of either package decode
in the other.

Byte accounting: for a full payload the body is exactly
``packed_bytes(n, fmt) + 8·s.size`` per compressed leaf plus ``itemsize·n``
per raw leaf (:func:`payload_bytes_report` computes it without serializing).
"""

from __future__ import annotations

import dataclasses
import json
import math
import struct
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
_PVT_BYTES_PER_ENTRY = 8  # s and b, f32 each


class CodecError(ValueError):
    """Malformed, corrupt or version-incompatible payload."""


# ---------------------------------------------------------------------------
# strategy leaf-codec registry
# ---------------------------------------------------------------------------

_LEAF_CODECS: Dict[str, Tuple[type, Any, Any]] = {}


def register_leaf_codec(kind: str, leaf_type: type, encode_fn, decode_fn) -> None:
    """Register a strategy leaf kind: ``encode_fn(leaf, base) -> (meta,
    [chunks])`` and ``decode_fn(meta, body, off, base, device) -> (leaf,
    off)``, the leaf's tensors on ``device`` (the reference's decoders take
    no device: its leaves live on the host).  The body section must measure
    exactly ``leaf.wire_body_bytes()`` bytes, so that every ledger
    reconciles."""
    if kind in ("omc", "raw"):
        raise ValueError(f"leaf kind {kind!r} is built in")
    prev = _LEAF_CODECS.get(kind)
    if prev is not None and prev[0] is not leaf_type:
        raise ValueError(f"leaf kind {kind!r} already registered")
    _LEAF_CODECS[kind] = (leaf_type, encode_fn, decode_fn)


def _ensure_strategy_codecs() -> None:
    """Import the zoo (idempotent): its leaf codecs register at import."""
    import repro_torch.compress  # noqa: F401


def _leaf_kind(leaf) -> Optional[str]:
    for kind, (leaf_type, _, _) in _LEAF_CODECS.items():
        if isinstance(leaf, leaf_type):
            return kind
    return None


def _check_strategy_tag(manifest: Dict[str, Any]) -> None:
    """Reject an unknown strategy tag or another wire version (CodecError)."""
    name = manifest.get("strategy")
    if name is None:
        return
    _ensure_strategy_codecs()
    from repro_torch.compress import available_strategies, strategy_class

    try:
        cls = strategy_class(name)
    except KeyError:
        raise CodecError(f"unknown compression strategy tag {name!r}; "
                         f"registered zoo: {available_strategies()}") from None
    sver = int(manifest.get("strategy_version", 0))
    if sver != cls.wire_version:
        raise CodecError(f"strategy {name!r} wire version mismatch: payload carries "
                         f"v{sver}, this zoo speaks v{cls.wire_version}")


def _strategy_tag(strategy, kinds_seen) -> Optional[Tuple[str, int]]:
    """The frame's (strategy, wire_version) stamp, if any."""
    if strategy is None and not kinds_seen:
        return None
    _ensure_strategy_codecs()
    from repro_torch.compress import strategy_class

    if strategy is not None:
        if isinstance(strategy, str):
            cls = strategy_class(strategy)
            return cls.name, cls.wire_version
        return strategy.name, strategy.wire_version
    if len(kinds_seen) > 1:
        raise CodecError(f"tree mixes strategy leaf kinds {sorted(kinds_seen)}; pass "
                         f"strategy= explicitly to tag the frame")
    cls = strategy_class(next(iter(kinds_seen)))
    return cls.name, cls.wire_version


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
    strategy: Optional[str] = None  # zoo strategy tag (None: a plain OMC frame)
    strategy_version: int = 0  # per-strategy wire version (0: untagged)

    @property
    def is_delta(self) -> bool:
        return bool(self.flags & FLAG_DELTA)


def negotiate_version(peer_versions: Sequence[int]) -> int:
    """Highest wire version both ends speak (the server calls this per client)."""
    common = set(SUPPORTED_VERSIONS) & {int(v) for v in peer_versions}
    if not common:
        raise CodecError(f"no common wire version: we speak {SUPPORTED_VERSIONS}, "
                         f"peer speaks {tuple(peer_versions)}")
    return max(common)


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
        kind = _leaf_kind(leaf)
        if kind is not None:  # strategy leaves: the canonical wire chunks
            meta, chunks = _LEAF_CODECS[kind][1](leaf, None)
            h = zlib.crc32(json.dumps(meta, separators=(",", ":"), sort_keys=True).encode(), h)
            for c in chunks:
                h = zlib.crc32(c, h)
        elif is_compressed(leaf):
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


def encode_payload(tree, *, base=None, round_index: int = 0, strategy=None) -> bytes:
    """Serialize a storage tree to a wire payload.

    ``base`` (the tree the receiver already holds) switches each leaf to
    sparse XOR-delta encoding when that is smaller; the receiver must then
    pass the same base to :func:`decode_payload`.  ``strategy`` (a
    ``CompressionStrategy`` or a registered name) stamps the frame with its
    tag and wire version; a tree holding one kind of strategy leaf is
    stamped with it unasked.  Untagged frames stay those of wire version 1.
    """
    base_leaves: Dict[str, Any] = {}
    if base is not None:
        base_leaves = {_path_key(p): leaf for p, leaf in _flatten(base)}

    manifest: List[Dict[str, Any]] = []
    chunks: List[bytes] = []
    any_delta = False
    kinds_seen = set()
    for parts, leaf in _flatten(tree):
        bleaf = base_leaves.get(_path_key(parts))
        if is_compressed(leaf):
            meta, ch = _encode_omc(leaf, bleaf)
        elif (kind := _leaf_kind(leaf)) is not None:
            meta, ch = _LEAF_CODECS[kind][1](leaf, bleaf)
            kinds_seen.add(kind)
        elif isinstance(leaf, torch.Tensor):
            meta, ch = _encode_raw(leaf, bleaf)
        else:
            raise CodecError(f"leaf of type {type(leaf).__name__} at {_path_key(parts)!r} "
                             f"has no registered leaf codec")
        any_delta |= meta["mode"] == "delta"
        meta["path"] = parts
        manifest.append(meta)
        chunks.extend(ch)

    frame: Dict[str, Any] = dict(leaves=manifest)
    tag = _strategy_tag(strategy, kinds_seen)
    if tag is not None:
        frame["strategy"], frame["strategy_version"] = tag
    mjson = json.dumps(frame, separators=(",", ":")).encode()
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
    _check_strategy_tag(manifest)
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
        strategy=manifest.get("strategy"),
        strategy_version=int(manifest.get("strategy_version", 0)),
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
            if meta["kind"] not in _LEAF_CODECS:
                _ensure_strategy_codecs()
            if meta["kind"] not in _LEAF_CODECS:
                raise CodecError(f"unknown leaf kind {meta['kind']!r}")
            leaf, off = _LEAF_CODECS[meta["kind"]][2](meta, body, off, bleaf, device)
        entries.append((parts, leaf))
    if off != info.body_bytes:
        raise CodecError(f"body length mismatch: consumed {off}, have {info.body_bytes}")
    return _unflatten(entries), info


def peek_payload(data: bytes) -> PayloadInfo:
    """Validate framing + checksum and return sizes, without decoding."""
    return _parse_frame(data)[0]


def payload_manifest(data: bytes) -> List[Dict[str, Any]]:
    """The manifest's leaf records (path, kind, shape, mode and, for a delta
    leaf, ``nnz``), framing and checksum validated, without decoding: what
    tells how many ``pack``/``unpack`` launches the payload's encode and
    decode take."""
    return _parse_frame(data)[1]["leaves"]


def header_base_digest(data: bytes) -> int:
    """Base digest straight from the header, with no checksum scan: for cheap
    delta-vs-full routing; integrity is still enforced at decode."""
    if len(data) < _HEADER.size:
        raise CodecError(f"payload truncated: {len(data)} bytes")
    magic, _, flags, _, _, _, _, digest = _HEADER.unpack_from(data)
    if magic != MAGIC:
        raise CodecError(f"bad magic {magic!r}")
    return digest if flags & FLAG_DELTA else 0


def payload_bytes_report(tree) -> Dict[str, Any]:
    """Theoretical full-payload body size for a storage tree, the
    reference's report key for key: ``packed_bytes`` plus 8 bytes of PVT
    scalars per entry for ``omc`` leaves, a strategy leaf's
    ``wire_body_bytes`` otherwise, ``itemsize·n`` for raw leaves; so
    ``wire_bytes`` equals ``state_bytes_report``'s ``packed_bytes`` for a
    pure OMC tree, and a full payload's ``body_bytes``.  ``per_strategy``
    breaks the body down by leaf kind.  Only shapes are read."""
    wire = fp32 = n_params = n_comp = 0
    per: Dict[str, Dict[str, int]] = {}

    def bucket(kind: str) -> Dict[str, int]:
        return per.setdefault(kind, dict(payload_bytes=0, index_bytes=0, meta_bytes=0,
                                         num_leaves=0, num_params=0))

    for _, leaf in _flatten(tree):
        if is_compressed(leaf):
            n = leaf.size
            meta = _PVT_BYTES_PER_ENTRY * leaf.s.numel()
            body = packing.packed_bytes(n, leaf.fmt) + meta
            n_comp += n
            b = bucket("omc")
            b["meta_bytes"] += meta
        elif (kind := _leaf_kind(leaf)) is not None:
            n = math.prod(leaf.shape)
            body = int(leaf.wire_body_bytes())
            n_comp += n
            b = bucket(kind)
            b["index_bytes"] += int(leaf.index_bytes())
            b["meta_bytes"] += int(leaf.meta_bytes())
        else:
            n = leaf.numel()
            body = n * leaf.element_size()
            b = bucket("raw")
        n_params += n
        fp32 += 4 * n
        wire += body
        b["payload_bytes"] += body
        b["num_leaves"] += 1
        b["num_params"] += n
    return dict(num_params=n_params, num_compressed=n_comp, fp32_bytes=fp32, wire_bytes=wire,
                wire_ratio=wire / max(fp32, 1), per_strategy=per)
