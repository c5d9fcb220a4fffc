"""PyTorch port vs the JAX reference: storage-mode compression of a tree, the
paper's byte accounting, the pack kernels' moved bytes, and the reference's
op names in the port's kernel layer.

Tolerances: ``tree_bytes_report`` / ``omc.bytes_report`` equal key for key
and to the byte (Python arithmetic on shapes in both packages), on the full
configs of conformer_s, qwen2.5-3b and recurrentgemma-2b (shapes from
``jax.eval_shape`` and from the port's init on the meta device: no full
model is built); ``compress_tree`` / ``omc.compress`` codes bit-exact, with
(s, b) within tests/test_torch_engine.py's rtol=1e-4 on s and atol=1e-5 on b
(the reference solves them with its compensated sums, the port by the
closed form on ``quantize_stats``' sums) wherever that solve is well
conditioned; ``omc.decompress`` of one storage tree within 1 ulp (the
affine's fused-vs-unfused rounding, ROADMAP C5); moved bytes as integers.

Conditioning: the least-squares ``s`` divides by ``n·ΣṼ² − (ΣṼ)²``, which
cancels to a relative error of about ``κ·2**-24`` with ``κ = mean(Ṽ²) /
var(Ṽ)``.  A LayerNorm scale near 1 with a spread of 0.01 has κ near 1e4,
so a one-ulp difference in any f32 sum (another summation order; the
reference's own compensated solver and its closed form differ as much)
moves ``s`` by about 1e-3.  There ``b = (ΣV − s·ΣṼ)/n`` follows ``s``, so
the decoded leaves ``s·Ṽ + b`` differ by ``Δs·(Ṽ − mean Ṽ)`` only: such
leaves (κ > 100) are held to decoded values within ``16·κ·2**-24·|s|·
max|Ṽ − mean Ṽ|``, sixteen ulps of the closed form's conditioning.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import omc as jomc
from repro.core import store as jstore
from repro.core.formats import FloatFormat as JFormat
from repro.core.policy import QuantizePolicy as JPolicy
from repro.kernels import bitpack as jbp
from repro.roofline.analysis import packbits_bound_bytes
from repro_torch import interop
from repro_torch.core import omc, prng, store
from repro_torch.core.formats import FloatFormat
from repro_torch.core.policy import QuantizePolicy
from repro_torch.core.tree import tree_items
from repro_torch.kernels import bitpack as bp
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

ARCHS = [("conformer", "conformer_s"), ("transformer", "qwen2_5_3b"),
         ("griffin", "recurrentgemma_2b")]
REPORT_FMTS = ["S1E8M23", "S1E4M14", "S1E3M7", "S1E2M3", "S1E3M9"]
ALL_PARAMS = dict(weights_only=False, min_ndim=0, min_size=1)  # Table 4 / Fig. 3's policy
POLICIES = {"default": {}, "all-params": ALL_PARAMS}


@functools.lru_cache(maxsize=None)
def _full_shapes(family: str, arch: str):
    """(reference ShapeDtypeStruct tree, port meta-tensor tree) of the full config."""
    jfam = importlib.import_module(f"repro.models.{family}")
    jcfg = importlib.import_module(f"repro.configs.{arch}").config()
    fam = importlib.import_module(f"repro_torch.models.{family}")
    cfg = importlib.import_module(f"repro_torch.configs.{arch}").config()
    jshapes = jax.eval_shape(lambda k: jfam.init(k, jcfg), jax.random.PRNGKey(0))
    return jshapes, fam.init(prng.PRNGKey(0), cfg, "meta")


@pytest.mark.parametrize("fmt", REPORT_FMTS)
@pytest.mark.parametrize("family,arch", ARCHS, ids=[a for _, a in ARCHS])
def test_bytes_reports_equal_the_reference_on_full_configs(family, arch, fmt):
    jshapes, meta = _full_shapes(family, arch)
    assert {p: tuple(v.shape) for p, v in tree_items(meta)} == {
        tuple(k.key for k in p): tuple(v.shape)
        for p, v in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    for policy in POLICIES.values():
        for fraction in (1.0, 0.9):
            want = jstore.tree_bytes_report(jshapes, JFormat.parse(fmt), JPolicy(**policy),
                                            fraction=fraction)
            got = store.tree_bytes_report(meta, FloatFormat.parse(fmt), QuantizePolicy(**policy),
                                          fraction=fraction)
            assert got == want, (policy, fraction)
            cfg = omc.OMCConfig.parse(fmt, quantize_fraction=fraction,
                                      policy=QuantizePolicy(**policy))
            jcfg = jomc.OMCConfig.parse(fmt, quantize_fraction=fraction,
                                        policy=JPolicy(**policy))
            assert omc.bytes_report(meta, cfg) == jomc.bytes_report(jshapes, jcfg) == want


def test_table1_memory_column_on_conformer_s():
    """Table 1's S1E4M14 ``mem_pct`` at full width (the default policy and PPQ 0.9)."""
    _, meta = _full_shapes("conformer", "conformer_s")
    r = omc.bytes_report(meta, omc.OMCConfig.parse("S1E4M14"))
    # the reference's policy counts a stacked leaf's own rank: the 16 stacked
    # [17, d] vectors are selected here too, as in the reference's report
    assert r["num_params"] == 103_535_104 and r["num_quantizable_vars"] == 29
    assert round(100 * r["packed_ratio"]) == 63  # the paper: 64%


@pytest.fixture(scope="module")
def tree():
    """The reference's conformer_s smoke init, every leaf moved off its
    constant (1-D scales and biases included), plus a 0-d and a 1-d leaf."""
    from repro.configs import conformer_s as jcs
    from repro.models import conformer as jcf

    params = jax.jit(lambda k: jcf.init(k, jcs.smoke_config()))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.01 * rng.standard_normal(a.shape).astype(np.float32), params)
    params["extra"] = dict(scalar=np.float32(0.37), vec=rng.standard_normal(5).astype(np.float32))
    return params


def _compress_both(tree, fmt, policy, pvt):
    jcfg = jomc.OMCConfig.parse(fmt, pvt=pvt, policy=JPolicy(**policy))
    cfg = omc.OMCConfig.parse(fmt, pvt=pvt, policy=QuantizePolicy(**policy))
    # jit: one compiled program instead of many small eager ones (same math)
    jstorage = jax.jit(lambda t: jomc.compress(t, jcfg))(jax.tree_util.tree_map(jnp.asarray, tree))
    return jstorage, omc.compress(interop.params_from_numpy(tree, "cpu"), cfg)


# (format, policy, pvt) as the tables compress: Table 4's S1E3M7 variants (every
# parameter with PVT off and on, weights only), Fig. 3's S1E5M10 and S1E2M3 with
# PVT off and on, Table 1's S1E4M14 (and, every parameter, a u32 container with
# 0-d and 1-d leaves), Fig. 4's 13-bit formats
COMPRESS_CASES = [("S1E3M7", "all-params", False), ("S1E3M7", "all-params", True),
                  ("S1E3M7", "default", True), ("S1E3M7", "default", False),
                  ("S1E5M10", "default", False), ("S1E5M10", "default", True),
                  ("S1E2M3", "default", False), ("S1E2M3", "default", True),
                  ("S1E4M14", "default", True), ("S1E4M14", "all-params", True),
                  ("S1E3M9", "default", True), ("S1E4M8", "default", True),
                  ("S1E5M7", "default", True)]


@pytest.mark.parametrize("fmt,policy,pvt", COMPRESS_CASES,
                         ids=[f"{f}-{p}-{'pvt' if v else 'no-pvt'}" for f, p, v in COMPRESS_CASES])
def test_compress_tree_matches_reference(tree, fmt, policy, pvt):
    want, got = _compress_both(tree, fmt, POLICIES[policy], pvt)
    want = {tuple(k.key for k in p): v for p, v in jax.tree_util.tree_flatten_with_path(
        want, is_leaf=jstore.is_compressed)[0]}
    got = dict(tree_items(got))
    assert sorted(got) == sorted(want)
    n_compressed = 0
    for path, leaf in got.items():
        w = want[path]
        assert store.is_compressed(leaf) == jstore.is_compressed(w), path
        if not store.is_compressed(leaf):
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(w))
            continue
        n_compressed += 1
        assert leaf.fmt.name == w.fmt.name and leaf.s.shape == () and leaf.b.shape == ()
        np.testing.assert_array_equal(leaf.codes.numpy(), np.asarray(w.codes), err_msg=str(path))
        q = np.asarray(w.dequantize() if not pvt else jstore.CompressedVariable(
            w.codes, jnp.float32(1), jnp.float32(0), w.fmt).dequantize(), np.float64)
        kappa = np.mean(q * q) / q.var() if q.size > 1 and q.var() > 0 else 1.0
        if kappa > 100:
            tol = 16 * kappa * 2.0**-24 * abs(float(w.s)) * np.abs(q - q.mean()).max()
            np.testing.assert_allclose(leaf.dequantize().numpy(), np.asarray(w.dequantize()),
                                       rtol=0, atol=tol, err_msg=str(path))
            continue
        np.testing.assert_allclose(leaf.s.numpy(), np.asarray(w.s), rtol=1e-4, err_msg=str(path))
        np.testing.assert_allclose(leaf.b.numpy(), np.asarray(w.b), atol=1e-5, err_msg=str(path))
    # the all-params policy reaches the 1-d and 0-d leaves too
    assert n_compressed == (33 if policy == "all-params" else 13)
    assert store.is_compressed(got[("extra", "scalar")]) == (policy == "all-params")


def test_decompress_matches_reference_on_one_storage_tree(tree):
    jstorage, _ = _compress_both(tree, "S1E3M7", ALL_PARAMS, True)
    want = {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jomc.decompress(jstorage))[0]}
    got = {p: v.numpy() for p, v in tree_items(omc.decompress(
        interop.storage_from_numpy(jstorage, "cpu")))}
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        np.testing.assert_array_max_ulp(x, want[path], maxulp=1)


@pytest.mark.parametrize("width", [1, 2, 6, 11, 16, 19, 32])
@pytest.mark.parametrize("n", [1, 33, 8191, 8192, 8193, 100_003, 811_597_824])
def test_pack_moved_bytes_against_the_reference(width, n):
    """The port's tiles read and write no padding: in u32 codes its count is
    the reference's byte bound, and never above the reference kernel's own
    (padded) count; a narrower container reads fewer bytes."""
    got = bp.pack_moved_bytes(n, width)
    assert got == bp.unpack_moved_bytes(n, width) == packbits_bound_bytes(n, width)
    assert got <= jbp.pack_moved_bytes(n, width) == jbp.unpack_moved_bytes(n, width)
    for dtype in (torch.uint8, torch.uint16):
        if width <= 8 * dtype.itemsize:
            assert bp.pack_moved_bytes(n, width, dtype) == got - (4 - dtype.itemsize) * n


def test_reference_op_names_share_the_launch_counter():
    """C9: ``dispatch_counts``/``reset_dispatch_counts``/``pack_bits``/
    ``unpack_bits`` are the reference's names over the port's one counter,
    counted once per launch."""
    ops.reset_dispatch_counts()
    assert ops.launch_counts() == ops.dispatch_counts() == {}
    codes = torch.arange(1000).remainder(2048).to(torch.int32).view(torch.uint32)
    words = ops.pack_bits(codes, 11)
    again = ops.pack_bits(codes, 11)
    assert store.bit_equal(words, again) and store.bit_equal(words, ref.ref_pack(codes, 11))
    back = ops.unpack_bits(words, 11, 1000)
    assert store.bit_equal(back, codes)
    assert ops.dispatch_counts() == ops.launch_counts() == {"pack.ref": 2, "unpack.ref": 1}
    ops.reset_launch_counts()
    assert ops.dispatch_counts() == {}
