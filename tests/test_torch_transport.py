"""PyTorch port vs the JAX reference: one variable's transport form and the
wire codec's reports and helpers.

The reference compresses the qwen2.5-3b smoke tree (``compress_params``),
which is carried across with ``repro_torch.interop``.  Held exactly, with no
tolerance: ``pack_for_transport``'s words, ``nbytes`` and fields, the
roundtrip through ``unpack_from_transport``, ``packed_bytes_width``,
``payload_bytes_report``, ``peek_payload`` and ``header_base_digest`` on the
reference's payloads, ``negotiate_version`` and ``register_leaf_codec``'s
guards, with ``decode_payload`` consulting the registry.
"""

import functools
import json
import struct
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.api import codecs as jcodecs
from repro.configs import qwen2_5_3b as jcfg
from repro.core import packing as jpacking
from repro.core import store as jstore
from repro.core.omc import OMCConfig as JOMC
from repro.federated import state as jstate
from repro.models import transformer as jtr
from repro_torch import interop
from repro_torch.api import codecs
from repro_torch.core import packing
from repro_torch.core.formats import FloatFormat
from repro_torch.core.store import (CompressedVariable, bit_equal, is_compressed,
                                    pack_for_transport, unpack_from_transport)
from repro_torch.core.tree import tree_items
from repro_torch.federated.state import state_bytes_report

torch.set_num_threads(1)

FMTS = ["S1E2M3", "S1E3M7", "S1E4M14"]  # u8, u16 and u32 containers


@functools.lru_cache(maxsize=None)
def _jstorage(name, bump=None):
    """Reference storage of the qwen2.5-3b smoke tree; ``bump`` nudges a few
    weights, like a small server step (for a delta payload)."""
    @jax.jit
    def build(key):
        cfg = jcfg.smoke_config()
        params = jtr.init(key, cfg)
        if bump is not None:
            params["blocks"]["w1"] = params["blocks"]["w1"].at[0, :2, :5].add(bump)
        return jstate.compress_params(params, jtr.param_specs(cfg), JOMC.parse(name))

    return build(jax.random.PRNGKey(0))


def _pairs(name):
    jtree = _jstorage(name)
    jleaves = {"/".join(str(k.key) for k in p): leaf for p, leaf in
               jax.tree_util.tree_flatten_with_path(jtree, is_leaf=jstore.is_compressed)[0]}
    tree = interop.storage_from_numpy(jtree, device="cpu")
    return [(path, leaf, jleaves["/".join(path)]) for path, leaf in tree_items(tree)
            if is_compressed(leaf)]


@pytest.mark.parametrize("name", FMTS)
def test_pack_for_transport_matches_reference(name):
    pairs = _pairs(name)
    assert len(pairs) == 8
    for path, leaf, jleaf in pairs:
        blob, jblob = pack_for_transport(leaf), jstore.pack_for_transport(jleaf)
        assert sorted(blob) == sorted(jblob)
        assert blob["words"].dtype == torch.uint32
        assert blob["words"].numpy().tobytes() == np.asarray(jblob["words"]).tobytes(), path
        assert blob["nbytes"] == jblob["nbytes"]
        assert blob["fmt"] == jblob["fmt"] and blob["shape"] == jblob["shape"]
        back = unpack_from_transport(blob)
        assert back.fmt == leaf.fmt and back.codes.dtype == leaf.fmt.container_dtype
        assert all(bit_equal(x, y) for x, y in ((back.codes, leaf.codes), (back.s, leaf.s),
                                                 (back.b, leaf.b))), path
        # each side unpacks the other's blob to the same codes
        jblob_t = dict(blob, words=torch.from_numpy(np.array(jblob["words"])))
        assert bit_equal(unpack_from_transport(jblob_t).codes, leaf.codes)
        jback = jstore.unpack_from_transport(dict(jblob, words=blob["words"].numpy()))
        assert np.array_equal(np.asarray(jback.codes), leaf.codes.numpy())


def test_transport_offsets_are_64_bit():
    """A field index times the width past 2**32 bits: the word index must not
    wrap (ROADMAP C6); checked on the offsets alone, no 2**32-bit tensor."""
    n, width = 811_597_824, 11  # qwen2.5-3b's stacked w1 leaf at S1E3M7
    idx = torch.tensor([n - 1, (1 << 32) // width + 1], dtype=torch.int64)
    word, shift = packing.bit_offsets(idx, width)
    assert word.tolist() == [((n - 1) * width) >> 5, (((1 << 32) // width + 1) * width) >> 5]
    assert shift.tolist() == [((n - 1) * width) & 31, (((1 << 32) // width + 1) * width) & 31]
    assert packing.packed_words(n, width) * 32 >= n * width > 1 << 32


@pytest.mark.parametrize("width", [1, 2, 3, 11, 19, 31, 32])
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000, 811_597_824])
def test_packed_bytes_width_matches_reference(n, width):
    assert packing.packed_bytes_width(n, width) == jpacking.packed_bytes_width(n, width)


@pytest.mark.parametrize("name", FMTS)
def test_payload_bytes_report_matches_reference(name):
    jtree = _jstorage(name)
    tree = interop.storage_from_numpy(jtree, device="cpu")
    rep = codecs.payload_bytes_report(tree)
    assert rep == jcodecs.payload_bytes_report(jtree)
    # the body of a full payload, and the state report's packed bytes
    assert rep["wire_bytes"] == codecs.peek_payload(codecs.encode_payload(tree)).body_bytes
    assert rep["wire_bytes"] == state_bytes_report(tree)["packed_bytes"]


def test_peek_and_header_digest_on_reference_payloads():
    jbase, jnew = _jstorage("S1E3M7"), _jstorage("S1E3M7", bump=0.05)
    full = jcodecs.encode_payload(jnew, round_index=7)
    delta = jcodecs.encode_payload(jnew, base=jbase, round_index=8)
    for payload in (full, delta):
        assert codecs.peek_payload(payload).__dict__ == jcodecs.peek_payload(payload).__dict__
        assert codecs.header_base_digest(payload) == jcodecs.header_base_digest(payload)
    base = interop.storage_from_numpy(jbase, device="cpu")
    assert codecs.header_base_digest(delta) == codecs.tree_digest(base) != 0
    assert codecs.header_base_digest(full) == 0
    with pytest.raises(codecs.CodecError, match="truncated"):
        codecs.header_base_digest(full[:10])
    with pytest.raises(codecs.CodecError, match="bad magic"):
        codecs.header_base_digest(b"XXXX" + full[4:])
    corrupt = full[:-1] + bytes([full[-1] ^ 1])
    assert codecs.header_base_digest(corrupt) == 0  # no checksum scan
    with pytest.raises(codecs.CodecError, match="checksum"):
        codecs.peek_payload(corrupt)


@pytest.mark.parametrize("peer", [(1,), (1, 2), (0, 1, 5), (2, 3), ()])
def test_negotiate_version_matches_reference(peer):
    try:
        want = jcodecs.negotiate_version(peer)
    except jcodecs.CodecError:
        with pytest.raises(codecs.CodecError, match="no common wire version"):
            codecs.negotiate_version(peer)
    else:
        assert codecs.negotiate_version(peer) == want


class _Dummy:
    """A strategy-like leaf: int8 values travel as raw bytes."""

    def __init__(self, values):
        self.values = values
        self.shape = tuple(values.shape)

    def wire_body_bytes(self):
        return self.values.numel()

    def index_bytes(self):
        return 0

    def meta_bytes(self):
        return 0


def _encode_dummy(leaf, base):
    return dict(kind="dummy", shape=list(leaf.shape), mode="full"), [leaf.values.numpy().tobytes()]


def _decode_dummy(meta, body, off, base, device):
    n = int(np.prod(meta["shape"]))
    vals = np.frombuffer(body, np.int8, n, off).reshape(meta["shape"]).copy()
    return _Dummy(torch.from_numpy(vals).to(device)), off + n


@pytest.fixture
def dummy_kind():
    codecs.register_leaf_codec("dummy", _Dummy, _encode_dummy, _decode_dummy)
    yield
    codecs._LEAF_CODECS.pop("dummy", None)


def _frame(leaves, body: bytes) -> bytes:
    mjson = json.dumps(dict(leaves=leaves), separators=(",", ":")).encode()
    crc = zlib.crc32(body, zlib.crc32(mjson))
    return struct.pack("<4sHHIIQII", b"OMCW", 1, 0, 0, len(mjson), len(body), crc, 0) + \
        mjson + body


def test_register_leaf_codec_guards(dummy_kind):
    for kind in ("omc", "raw"):
        with pytest.raises(ValueError, match="built in"):
            codecs.register_leaf_codec(kind, _Dummy, _encode_dummy, _decode_dummy)
    codecs.register_leaf_codec("dummy", _Dummy, _encode_dummy, _decode_dummy)  # same type: ok
    with pytest.raises(ValueError, match="already registered"):
        codecs.register_leaf_codec("dummy", CompressedVariable, _encode_dummy, _decode_dummy)
    for kind in ("omc", "raw"):  # the reference's guards say the same
        with pytest.raises(ValueError, match="built in"):
            jcodecs.register_leaf_codec(kind, _Dummy, _encode_dummy, _decode_dummy)


def test_decode_consults_registered_kinds(dummy_kind):
    vals = torch.tensor([[1, -2, 3], [4, 5, -6]], dtype=torch.int8)
    meta, chunks = _encode_dummy(_Dummy(vals), None)
    w = torch.arange(4, dtype=torch.float32)
    leaves = [dict(meta, path=[["k", "d"]]),
              dict(kind="raw", dtype="<f4", shape=[4], mode="full", path=[["k", "w"]])]
    payload = _frame(leaves, chunks[0] + w.numpy().tobytes())
    tree, info = codecs.decode_payload(payload, device="cpu")
    assert torch.equal(tree["d"].values, vals) and torch.equal(tree["w"], w)
    assert info.num_leaves == 2 and info.num_compressed == 1
    rep = codecs.payload_bytes_report(tree)
    assert rep["per_strategy"]["dummy"]["payload_bytes"] == 6 == info.body_bytes - 16
    assert rep["wire_bytes"] == info.body_bytes and rep["num_compressed"] == 6
    assert codecs.tree_digest(tree) != codecs.tree_digest({"w": w})
    # a strategy-tagged frame encodes and decodes; untagged, the frame is
    # tagged by its leaf kind, and "dummy" names no strategy (KeyError, as
    # in the reference)
    tagged, = [codecs.encode_payload(tree, strategy="topk")]
    back, tinfo = codecs.decode_payload(tagged, device="cpu")
    assert (tinfo.strategy, tinfo.strategy_version) == ("topk", 1)
    assert torch.equal(back["d"].values, vals) and torch.equal(back["w"], w)
    with pytest.raises(KeyError, match="dummy"):
        codecs.encode_payload(tree)
    codecs._LEAF_CODECS.pop("dummy")
    with pytest.raises(codecs.CodecError, match="unknown leaf kind"):
        codecs.decode_payload(payload, device="cpu")


def test_transport_of_a_scalar_pvt_leaf():
    fmt = FloatFormat.parse("S1E4M14")
    codes = torch.tensor([0, 1, (1 << 19) - 1, 12345, 7], dtype=torch.uint32)
    cv = CompressedVariable(codes, torch.tensor(1.5), torch.tensor(-0.25), fmt)
    blob = pack_for_transport(cv)
    assert blob["nbytes"] == 4 * packing.packed_words(5, 19) + 8 and blob["shape"] == (5,)
    back = unpack_from_transport(blob)
    assert bit_equal(back.codes, codes) and back.s.shape == ()
