"""PyTorch port vs the JAX reference: the wire codec, byte for byte.

The reference's storage tree (its ``compress_params`` on the qwen2.5-3b smoke
tree) is carried across with ``repro_torch.interop``.  Both encoders must
emit identical payload bytes, full and delta, and each decoder must rebuild
the other's tree bit for bit.  No tolerance anywhere: the codec is defined
in bytes.
"""

import functools
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import codecs as jcodecs
from repro.configs import qwen2_5_3b as jcfg
from repro.core.omc import OMCConfig as JOMC
from repro.federated import state as jstate
from repro.models import transformer as jtr
from repro_torch import interop
from repro_torch.api import codecs
from repro_torch.core.store import is_compressed
from repro_torch.core.tree import tree_items

torch.set_num_threads(1)

FMTS = ["S1E2M3", "S1E3M7", "S1E4M14"]  # u8, u16 and u32 containers


@functools.partial(jax.jit, static_argnames=("name", "bump"))
def _build(key, name, bump):
    """One compiled program instead of many small eager ones (same math)."""
    cfg = jcfg.smoke_config()
    params = jtr.init(key, cfg)
    if bump is not None:
        params["blocks"]["w1"] = params["blocks"]["w1"].at[0, :2, :5].add(bump)
        params["final_norm"] = params["final_norm"].at[3].add(bump)
    return jstate.compress_params(params, jtr.param_specs(cfg), JOMC.parse(name))


@functools.lru_cache(maxsize=None)
def _jstorage(name, seed=0, bump=None):
    """Reference storage (immutable, so shared between tests); ``bump``
    nudges a few weights, like a small server step."""
    return _build(jax.random.PRNGKey(seed), name, bump)


def _assert_port_tree_equals_reference(tree, jtree):
    jflat = {"/".join(str(k.key) for k in p): leaf for p, leaf in
             jax.tree_util.tree_flatten_with_path(jtree, is_leaf=lambda x: hasattr(x, "codes"))[0]}
    flat = {"/".join(p): leaf for p, leaf in tree_items(tree)}
    assert sorted(flat) == sorted(jflat)
    for path, leaf in flat.items():
        jleaf = jflat[path]
        if is_compressed(leaf):
            assert leaf.fmt.name == jleaf.fmt.name
            pairs = [(leaf.codes, jleaf.codes), (leaf.s, jleaf.s), (leaf.b, jleaf.b)]
        else:
            pairs = [(leaf, jleaf)]
        for t, j in pairs:
            j = np.asarray(j)
            assert t.numpy().dtype == j.dtype and t.shape == j.shape, path
            assert t.numpy().tobytes() == j.tobytes(), path


@pytest.mark.parametrize("name", FMTS)
def test_full_payload_byte_identical(name):
    jtree = _jstorage(name)
    tree = interop.storage_from_numpy(jtree, device="cpu")
    payload = codecs.encode_payload(tree, round_index=3)
    jpayload = jcodecs.encode_payload(jtree, round_index=3)
    assert payload == jpayload
    assert codecs.tree_digest(tree) == jcodecs.tree_digest(jtree)
    # each side decodes the other's payload into the identical tree
    back, info = codecs.decode_payload(jpayload, device="cpu")
    assert not info.is_delta and info.num_compressed == 8
    _assert_port_tree_equals_reference(back, jtree)
    jback, _ = jcodecs.decode_payload(payload)
    _assert_port_tree_equals_reference(tree, jback)


@pytest.mark.parametrize("name", FMTS)
def test_delta_payload_byte_identical(name):
    jbase, jnew = _jstorage(name), _jstorage(name, bump=0.05)
    base = interop.storage_from_numpy(jbase, device="cpu")
    new = interop.storage_from_numpy(jnew, device="cpu")
    payload = codecs.encode_payload(new, base=base, round_index=4)
    jpayload = jcodecs.encode_payload(jnew, base=jbase, round_index=4)
    assert payload == jpayload
    info = codecs.decode_payload(payload, base=base, device="cpu")[1]
    assert info.is_delta and info.num_delta > 0
    back, _ = codecs.decode_payload(jpayload, base=base, device="cpu")
    _assert_port_tree_equals_reference(back, jnew)
    jback, _ = jcodecs.decode_payload(payload, base=jbase)
    _assert_port_tree_equals_reference(new, jback)
    # an unchanged tree is an all-delta payload with no changed codes
    same = codecs.encode_payload(base, base=base)
    assert same == jcodecs.encode_payload(jbase, base=jbase)


def test_delta_needs_the_right_base():
    jbase, jnew = _jstorage("S1E3M7"), _jstorage("S1E3M7", bump=0.05)
    base = interop.storage_from_numpy(jbase, device="cpu")
    payload = codecs.encode_payload(interop.storage_from_numpy(jnew, device="cpu"), base=base)
    with pytest.raises(codecs.CodecError, match="requires the base"):
        codecs.decode_payload(payload, device="cpu")
    other = interop.storage_from_numpy(_jstorage("S1E3M7", seed=1), device="cpu")
    with pytest.raises(codecs.CodecError, match="base mismatch"):
        codecs.decode_payload(payload, base=other, device="cpu")


def test_malformed_and_unported_payloads_raise():
    jtree = _jstorage("S1E3M7")
    payload = jcodecs.encode_payload(jtree)
    corrupt = payload[:-1] + bytes([payload[-1] ^ 1])
    with pytest.raises(codecs.CodecError, match="checksum"):
        codecs.decode_payload(corrupt, device="cpu")
    with pytest.raises(codecs.CodecError, match="bad magic"):
        codecs.decode_payload(b"XXXX" + payload[4:], device="cpu")
    with pytest.raises(codecs.CodecError, match="truncated"):
        codecs.decode_payload(payload[:10], device="cpu")
    tagged = jcodecs.encode_payload(jtree, strategy="omc")  # strategy zoo frame
    tree, info = codecs.decode_payload(tagged, device="cpu")  # decodes since the zoo came
    assert info.strategy == "omc" and codecs.tree_digest(tree) == jcodecs.tree_digest(jtree)
    unknown = tagged.replace(b'"strategy":"omc"', b'"strategy":"zzz"')
    # the crc (header bytes 24-28) covers the manifest and body after the header
    unknown = unknown[:24] + struct.pack("<I", zlib.crc32(unknown[32:])) + unknown[28:]
    with pytest.raises(codecs.CodecError, match="unknown compression strategy tag"):
        codecs.decode_payload(unknown, device="cpu")
    with pytest.raises(codecs.CodecError, match="no registered leaf codec"):
        codecs.encode_payload({"w": object()})


def test_roundtrip_keeps_scalar_pvt_shapes():
    """0-d (s, b) of the embedding stay 0-d; stacked ones stay [L, 1, 1]."""
    tree = interop.storage_from_numpy(_jstorage("S1E3M7"), device="cpu")
    back, _ = codecs.decode_payload(codecs.encode_payload(tree), device="cpu")
    assert back["embed"].s.shape == () and back["blocks"]["w1"].s.shape == (2, 1, 1)
    assert back["embed"].codes.dtype == torch.uint16
    assert jnp.asarray(back["final_norm"].numpy()).dtype == jnp.float32
