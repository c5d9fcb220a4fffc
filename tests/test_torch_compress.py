"""PyTorch port vs the JAX reference: the compression-strategy zoo
(``repro_torch.compress``), its wire frames, its byte ledgers and the six
``core`` names that came with it.

Inputs are the reference's ``_tree`` shapes (tests/test_compress.py: two
policy-selected matrices and a raw vector), made from fixed numpy seeds and
run through both packages.  Gates:

  * codes, top-k positions, packed words, DEFLATE blobs, payload bytes and
    decoded trees bit-exact for every strategy of ``default_zoo()`` (and
    top-k with S1E3M7 values) on these tie-free inputs; OMC's (s, b) within
    rtol 1e-5 (the f32 sums' order);
  * ternary scales within 32 ulp and no code flipped on the fixed samples
    (ROADMAP C18: XLA's f32 means and PyTorch's differ in order; measured
    gaps up to 18 ulp of the scale and 13 of Δ, and 1 flip in 524,288 on
    a sample outside this file's);
  * ties at the top-k threshold go to the lowest positions in the port
    (ROADMAP C17), where the reference leaves the choice to numpy;
  * each package's payload decodes in the other; an unknown tag or another
    wire version raises ``CodecError``;
  * the three byte ledgers reconcile (``tree_wire_bytes``, the codec's
    report, a payload's body) and the plan equals the measured size; the
    strategy wire ledgers equal the reference's to the byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.compress as jcompress
from repro.api import codecs as jcodecs
from repro.core import formats as jformats
from repro.core import policy as jpolicy
from repro.core import pvt as jpvt
from repro.core.omc import OMCConfig as JOMC
from repro.federated import accounting as jaccounting
from repro.models import conformer as jcf
import repro_torch.compress as compress
from repro_torch import interop
from repro_torch.api import codecs
from repro_torch.compress import base as compress_base
from repro_torch.compress.topk import top_positions
from repro_torch.core import formats, policy, pvt
from repro_torch.core.formats import FloatFormat
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import is_compressed
from repro_torch.federated import accounting
from repro_torch.kernels import ops
from repro_torch.models import conformer as cf

torch.set_num_threads(1)

OMC, JOMC_ = OMCConfig.parse("S1E3M7"), JOMC.parse("S1E3M7")
S1E3M7 = FloatFormat.parse("S1E3M7")
TERNARY_ULP = 32  # C18: the scale's gate against XLA's f32 reduction order


def _zoo(pkg, fmt_cls):
    zoo = pkg.default_zoo()
    return zoo + [pkg.get_strategy("topk", value_fmt=fmt_cls.parse("S1E3M7"))]


ZOO, JZOO = _zoo(compress, FloatFormat), _zoo(jcompress, jformats.FloatFormat)
IDS = [s.label for s in ZOO]
CASES = list(zip(ZOO, JZOO))


def _tree(seed=0):
    """The reference's shapes: two selected matrices and one raw vector."""
    rng = np.random.default_rng(seed)
    return dict(w=rng.normal(size=(32, 24)).astype(np.float32),
                emb=rng.normal(size=(40, 16)).astype(np.float32),
                bias=rng.normal(size=(8,)).astype(np.float32))


def _both(seed=0):
    t = _tree(seed)
    return {k: torch.from_numpy(v.copy()) for k, v in t.items()}, \
        {k: jnp.asarray(v) for k, v in t.items()}


def _np(tree):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


def _assert_leaf_equal(port_leaf, ref_leaf, rtol_sb=1e-5):
    """A port wire leaf against the reference's: every array field bit-exact,
    but OMC's (s, b) (rtol) and ternary's scale (C18)."""
    if is_compressed(port_leaf):
        np.testing.assert_array_equal(port_leaf.codes.numpy(), np.asarray(ref_leaf.codes))
        np.testing.assert_allclose(port_leaf.s.numpy(), np.asarray(ref_leaf.s), rtol=rtol_sb)
        np.testing.assert_allclose(port_leaf.b.numpy(), np.asarray(ref_leaf.b), rtol=rtol_sb,
                                   atol=1e-7)
    elif port_leaf.kind == "topk":
        np.testing.assert_array_equal(port_leaf.idx.numpy(), ref_leaf.idx.astype(np.int64))
        np.testing.assert_array_equal(port_leaf.values.numpy(), np.asarray(ref_leaf.values))
    elif port_leaf.kind == "ternary":
        np.testing.assert_array_equal(port_leaf.codes.numpy(), np.asarray(ref_leaf.codes))
        # a decoded 0-d scale is [1] in both packages' frames
        np.testing.assert_array_max_ulp(port_leaf.scale.numpy().reshape(-1),
                                        np.asarray(ref_leaf.scale).reshape(-1), TERNARY_ULP)
    else:
        assert port_leaf.blob == ref_leaf.blob and port_leaf.k == ref_leaf.k


# ---------------------------------------------------------------------------
# core: the six names that came with the strategies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["S1E3M7", "S1E4M3", "S1E2M3", "S1E5M10", "S1E8M23"])
def test_core_qdq_and_ste_match_reference(name):
    x = (np.random.default_rng(1).standard_normal(4096) * 3).astype(np.float32)
    fmt, jfmt = FloatFormat.parse(name), jformats.FloatFormat.parse(name)
    t = torch.from_numpy(x).requires_grad_(True)
    np.testing.assert_array_equal(formats.qdq(t, fmt).detach().numpy(),
                                  np.asarray(jformats.qdq(jnp.asarray(x), jfmt)))
    ste = formats.qdq_ste(t, fmt)
    # the reference's x + stop_gradient(q - x), whose value is not always q
    np.testing.assert_array_equal(ste.detach().numpy(),
                                  np.asarray(jformats.qdq_ste(jnp.asarray(x), jfmt)))
    ste.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.ones_like(x))
    assert formats.FP32 == FloatFormat(8, 23) and formats.FP32.name == jformats.FP32.name


def test_core_qdq_pvt_selection_and_coverage_match_reference():
    x = (np.random.default_rng(2).standard_normal((64, 48)) * 0.05).astype(np.float32)
    got = pvt.qdq_pvt(torch.from_numpy(x), S1E3M7).numpy()
    want = np.asarray(jpvt.qdq_pvt(jnp.asarray(x), jformats.FloatFormat.parse("S1E3M7")))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)
    tree, jtree = _both(3)
    for pol, jpol in ((policy.QuantizePolicy(), jpolicy.QuantizePolicy()),
                      (policy.QuantizePolicy(exclude_re=("emb",)),
                       jpolicy.QuantizePolicy(exclude_re=("emb",))),
                      (policy.QuantizePolicy(min_size=700), jpolicy.QuantizePolicy(min_size=700))):
        assert policy.selection_mask_tree(tree, pol) == jpolicy.selection_mask_tree(jtree, jpol)
        assert policy.coverage(tree, pol) == jpolicy.coverage(jtree, jpol)


# ---------------------------------------------------------------------------
# per-strategy encode / decode / qdq against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy,jstrategy", CASES, ids=IDS)
def test_encode_decode_and_payload_match_reference(strategy, jstrategy):
    tree, jtree = _both(0)
    enc = compress.encode_tree(strategy, tree, OMC)
    jenc = jcompress.encode_tree(jstrategy, jtree, JOMC_)
    for k in ("w", "emb"):
        _assert_leaf_equal(enc[k], jenc[k])
    assert torch.equal(enc["bias"], tree["bias"])
    payload = codecs.encode_payload(enc, strategy=strategy)
    jpayload = jcodecs.encode_payload(jenc, strategy=jstrategy)
    if strategy.name in ("topk", "pipeline"):
        assert payload == jpayload  # the whole frame, byte for byte
    assert len(payload) == len(jpayload)
    # each package decodes the other's frame; the decoded trees agree
    ours, info = codecs.decode_payload(jpayload, device="cpu")
    theirs, jinfo = jcodecs.decode_payload(payload)
    assert (info.strategy, info.strategy_version) == (jinfo.strategy, jinfo.strategy_version) \
        == (strategy.name, strategy.wire_version)
    for k in ("w", "emb"):
        _assert_leaf_equal(ours[k], jenc[k])
        _assert_leaf_equal(enc[k], theirs[k])
    dec, jdec = _np(compress.decode_tree(ours)), _np(jcompress.decode_tree(jenc))
    for k in tree:
        if strategy.name == "omc":  # an affine of the same codes: f32 rounding apart
            np.testing.assert_allclose(dec[k], jdec[k], rtol=1e-5, atol=1e-6)
        elif strategy.name == "ternary":
            np.testing.assert_array_max_ulp(dec[k], jdec[k], TERNARY_ULP)
        else:
            np.testing.assert_array_equal(dec[k], jdec[k])
    # encoding the decoded tree again gives the same leaves (OMC's (s, b)
    # are solved again from the decoded values, so only the sparse kinds)
    if strategy.name in ("topk", "pipeline"):
        again = compress.encode_tree(strategy, compress.decode_tree(enc), OMC)
        assert codecs.encode_payload(again, strategy=strategy) == payload


@pytest.mark.parametrize("strategy,jstrategy", CASES, ids=IDS)
def test_qdq_matches_decode_and_reference(strategy, jstrategy):
    tree, jtree = _both(1)
    via_wire = _np(compress.decode_tree(compress.encode_tree(strategy, tree, OMC)))
    via_qdq = _np(compress.qdq_tree(strategy, tree, OMC))
    ref = _np(jcompress.qdq_tree(jstrategy, jtree, JOMC_))
    for k in tree:
        if strategy.name == "omc":
            np.testing.assert_allclose(via_wire[k], via_qdq[k], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(via_qdq[k], ref[k], rtol=1e-5, atol=1e-6)
        elif strategy.name == "ternary":
            np.testing.assert_array_equal(via_wire[k], via_qdq[k])
            np.testing.assert_array_max_ulp(via_qdq[k], ref[k], TERNARY_ULP)
        else:
            np.testing.assert_array_equal(via_wire[k], via_qdq[k])
            np.testing.assert_array_equal(via_qdq[k], ref[k])


@pytest.mark.parametrize("strategy,jstrategy", CASES, ids=IDS)
def test_qdq_ste_value_and_straight_through_gradient(strategy, jstrategy):
    x = np.random.default_rng(2).normal(size=(24, 16)).astype(np.float32)
    v = torch.from_numpy(x).requires_grad_(True)
    out = strategy.qdq_ste_leaf(v)
    out.sum().backward()
    np.testing.assert_array_equal(v.grad.numpy(), np.ones_like(x))
    q = strategy.qdq_leaf(torch.from_numpy(x))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  (torch.from_numpy(x) + (q - torch.from_numpy(x))).numpy())
    want = np.asarray(jstrategy.qdq_ste_leaf(jnp.asarray(x)))
    if strategy.name in ("omc", "ternary"):
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(out.detach().numpy(), want)


@pytest.mark.parametrize("strategy,jstrategy", CASES, ids=IDS)
def test_bytes_reconcile_three_ways_and_plan(strategy, jstrategy):
    tree, jtree = _both(3)
    enc = compress.encode_tree(strategy, tree, OMC)
    twb = compress.tree_wire_bytes(enc)
    rep = codecs.payload_bytes_report(enc)
    info = codecs.peek_payload(codecs.encode_payload(enc, strategy=strategy))
    assert twb["wire_bytes"] == rep["wire_bytes"] == info.body_bytes
    assert twb["per_strategy"] == rep["per_strategy"]
    assert twb == jcompress.tree_wire_bytes(jcompress.encode_tree(jstrategy, jtree, JOMC_))
    for k in ("w", "emb"):
        plan = strategy.plan_wire_bytes(tree[k].numel(), 1)
        measured = strategy.leaf_wire_bytes(enc[k])
        assert plan == jstrategy.plan_wire_bytes(tree[k].numel(), 1)
        assert plan is None and strategy.name == "pipeline" or plan == measured


@pytest.mark.parametrize("stack,batch_axes", [((3, 40, 24), 0), ((3, 40, 24), 1),
                                              ((2, 2, 16, 16), 1), ((2, 2, 16, 16), 2)],
                         ids=str)
def test_stacked_leaves_match_reference(stack, batch_axes):
    """Per-entry scales and (s, b) on stacked leaves, each strategy."""
    x = (np.random.default_rng(5).standard_normal(stack) * 0.1).astype(np.float32)
    for strategy, jstrategy in CASES:
        leaf = strategy.encode_leaf(torch.from_numpy(x), batch_axes=batch_axes)
        jleaf = jstrategy.encode_leaf(jnp.asarray(x), batch_axes=batch_axes)
        _assert_leaf_equal(leaf, jleaf, rtol_sb=1e-4)
        plan = strategy.plan_wire_bytes(x.size, int(np.prod(stack[:batch_axes])))
        assert plan is None or plan == strategy.leaf_wire_bytes(leaf) \
            == jstrategy.leaf_wire_bytes(jleaf)


# ---------------------------------------------------------------------------
# C17: ties at the top-k threshold; C18: ternary scales and flips
# ---------------------------------------------------------------------------


def test_topk_ties_go_to_the_lowest_positions():
    """C17: among equal magnitudes at the threshold the port keeps the lowest
    positions; the reference keeps k of the candidates, numpy's choice."""
    x = np.asarray([1.0, -1.0, 1.0, 0.5, -1.0, 2.0, -1.0, 0.25], np.float32)
    s, js = compress.get_strategy("topk", density=0.375), jcompress.get_strategy(
        "topk", density=0.375)  # k = 3
    leaf = s.encode_leaf(torch.from_numpy(x))
    assert leaf.idx.tolist() == [0, 1, 5]
    jidx = set(js.encode_leaf(jnp.asarray(x)).idx.tolist())
    assert len(jidx) == 3 and 5 in jidx and jidx <= {0, 1, 2, 4, 5, 6}
    # the qdq view keeps every tie, as the reference's mask does
    np.testing.assert_array_equal(s.qdq_leaf(torch.from_numpy(x)).numpy(),
                                  np.asarray(js.qdq_leaf(jnp.asarray(x))))
    assert top_positions(torch.tensor([3.0, -3.0, 3.0]), 2).tolist() == [0, 1]


C18_SAMPLES = [((32, 24), 0), ((40, 16), 0), ((3, 40, 24), 1), ((17, 64, 32), 1),
               ((4096,), 0), ((2, 3, 300), 2)]
# 524,288 values each, seeds on which one code flips (found by search)
C18_LARGE = [((512, 1024), 0, 0, 1), ((8, 256, 256), 1, 56, 1)]


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


def _ternary_flips(x, batch_axes):
    """(flips, scale gap in ulps).  Every flipped |v| must lie between the
    two packages' thresholds Δ = 0.7·mean|v| of its stacked entry.  A flip
    moves its entry's scale (one value more or less in the mean of the kept
    ones), so the gap is taken over the entries without one; every scale,
    flipped or not, is within the gate of its own mask's mean in f64."""
    t, scale = compress.ternarize(torch.from_numpy(x), batch_axes)
    jt, jscale = jcompress.ternarize(jnp.asarray(x), batch_axes)
    t, jt = t.numpy(), np.asarray(jt)
    flipped = t != jt
    axes = tuple(range(batch_axes, x.ndim))
    mag = np.abs(x)
    delta = (0.7 * torch.from_numpy(mag).mean(dim=axes, keepdim=True)).numpy()
    jdelta = np.asarray(0.7 * jnp.mean(jnp.abs(jnp.asarray(x)), axis=axes, keepdims=True))
    lo = np.broadcast_to(np.minimum(delta, jdelta), x.shape)[flipped]
    hi = np.broadcast_to(np.maximum(delta, jdelta), x.shape)[flipped]
    assert np.all((lo <= mag[flipped]) & (mag[flipped] <= hi)), (mag[flipped], lo, hi)
    for sc, codes in ((scale.numpy(), t), (np.asarray(jscale), jt)):
        kept = codes != 0
        f64 = (np.where(kept, mag, 0).sum(axes, dtype=np.float64)
               / np.maximum(kept.sum(axes), 1)).astype(np.float32)
        assert _ulps(sc, f64).max() <= TERNARY_ULP
    clean = ~flipped.any(axis=axes)
    gap = _ulps(scale.numpy(), jscale)[clean]
    return int(flipped.sum()), int(gap.max(initial=0))


@pytest.mark.parametrize("shape,batch_axes", C18_SAMPLES, ids=str)
def test_ternary_flips_and_scale_gap(shape, batch_axes):
    """C18: codes flip only where |v| lies within the gap of Δ; on these fixed
    samples none does (gate 0), and the scales are within the gate."""
    rng = np.random.default_rng(sum(shape) + batch_axes)
    x = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    flips, gap = _ternary_flips(x, batch_axes)
    assert flips == 0, flips
    assert gap <= TERNARY_ULP, gap


@pytest.mark.parametrize("shape,batch_axes,seed,want", C18_LARGE, ids=str)
def test_ternary_flips_lie_within_the_gap_of_delta(shape, batch_axes, seed, want):
    """C18 at 524,288 values: the flips counted, each |v| between the two
    packages' Δ (an ulp or a few apart), the scales within the gate."""
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)
    flips, gap = _ternary_flips(x, batch_axes)
    assert flips == want, flips
    assert gap <= TERNARY_ULP, gap


# ---------------------------------------------------------------------------
# frames: tags, versions, cross-package
# ---------------------------------------------------------------------------


def test_wire_version_mismatch_and_unknown_tag_raise(monkeypatch):
    s = compress.get_strategy("topk")
    tree, _ = _both(4)
    payload = codecs.encode_payload(compress.encode_tree(s, tree, OMC), strategy=s)
    monkeypatch.setattr(type(s), "wire_version", s.wire_version + 1)
    with pytest.raises(codecs.CodecError, match="wire version mismatch"):
        codecs.decode_payload(payload, device="cpu")
    with pytest.raises(codecs.CodecError, match="wire version mismatch"):
        codecs.peek_payload(payload)
    monkeypatch.undo()
    monkeypatch.delitem(compress_base._REGISTRY, "topk")
    with pytest.raises(codecs.CodecError, match="unknown compression strategy"):
        codecs.decode_payload(payload, device="cpu")


def test_omc_tagged_frames_cross_packages_and_mixed_kinds_need_a_tag():
    tree, jtree = _both(5)
    s, js = compress.get_strategy("omc"), jcompress.get_strategy("omc")
    enc, jenc = compress.encode_tree(s, tree, OMC), jcompress.encode_tree(js, jtree, JOMC_)
    # the reference's omc-tagged frame decodes in the port, and back
    back, info = codecs.decode_payload(jcodecs.encode_payload(jenc, strategy="omc"),
                                       device="cpu")
    assert info.strategy == "omc" and info.strategy_version == 1
    np.testing.assert_array_equal(back["w"].codes.numpy(), np.asarray(jenc["w"].codes))
    jback, jinfo = jcodecs.decode_payload(codecs.encode_payload(enc, strategy="omc"))
    assert jinfo.strategy == "omc"
    np.testing.assert_array_equal(np.asarray(jback["w"].codes), enc["w"].codes.numpy())
    # an untagged OMC frame stays untagged, as the reference's
    assert codecs.peek_payload(codecs.encode_payload(enc)).strategy is None
    mixed = dict(a=compress.get_strategy("topk").encode_leaf(tree["w"]),
                 b=compress.get_strategy("ternary").encode_leaf(tree["emb"]))
    with pytest.raises(codecs.CodecError, match="mixes strategy leaf kinds"):
        codecs.encode_payload(mixed)
    assert codecs.peek_payload(codecs.encode_payload(mixed, strategy="topk")).strategy == "topk"


def test_wire_launches_on_the_plain_versions():
    """On the CPU every strategy runs the plain versions, launch for launch as
    the card's prediction in chip_smoke (B1-B4 per selected leaf)."""
    tree, _ = _both(6)
    omc = dict(quantize_stats=2, pack=2, unpack=2, dequantize=2)
    want = {"omc-s1e3m7": omc, "omc-s1e4m3": omc, "topk-0.1": {},
            "ternary-tnt": dict(pack=2, unpack=2),
            "pipe-s1e3m7-0.1": dict(quantize=2, pack=2, unpack=2),
            "topk-0.1-s1e3m7": dict(quantize=2, pack=2, unpack=2)}
    for s in ZOO:
        ops.reset_launch_counts()
        enc = compress.encode_tree(s, tree, OMC)
        back, _ = codecs.decode_payload(codecs.encode_payload(enc, strategy=s), device="cpu")
        compress.decode_tree(back)
        assert ops.launch_counts() == {f"{k}.ref": v for k, v in want[s.label].items()}, s.label


# ---------------------------------------------------------------------------
# strategy wire ledgers
# ---------------------------------------------------------------------------

JCFG = jcf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)
CFG = cf.ConformerConfig(**JCFG.__dict__)


@pytest.fixture(scope="module")
def tables():
    jp = jax.jit(lambda k: jcf.init(k, JCFG))(jax.random.PRNGKey(0))
    params = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return (accounting.build_wire_table(params, cf.param_specs(CFG), OMC),
            jaccounting.build_wire_table(jp, jcf.param_specs(JCFG), JOMC_))


@pytest.mark.parametrize("strategy,jstrategy", CASES, ids=IDS)
def test_strategy_ledgers_match_reference(tables, strategy, jstrategy):
    table, jtable = tables
    if strategy.name == "pipeline":
        for fn in (lambda t, s: t.strategy_var_bytes(s),
                   lambda t, s: t.download_bytes_strategy(s)):
            with pytest.raises(ValueError, match="data-dependent"):
                fn(table, strategy)
        with pytest.raises(ValueError, match="data-dependent"):
            accounting.client_upload_bytes_strategy(table, OMC, strategy, 0, 3)
        return
    np.testing.assert_array_equal(table.strategy_var_bytes(strategy),
                                  jtable.strategy_var_bytes(jstrategy))
    assert table.download_bytes_strategy(strategy) == jtable.download_bytes_strategy(jstrategy)
    assert (accounting.download_bytes_train(table, OMC, strategy)
            == jaccounting.download_bytes_train(jtable, JOMC_, jstrategy))
    for r in range(3):
        ids = [0, 3, 7, 11, 15]
        np.testing.assert_array_equal(
            accounting.cohort_upload_bytes_strategy(table, OMC, strategy, r, ids),
            jaccounting.cohort_upload_bytes_strategy(jtable, JOMC_, jstrategy, r,
                                                     np.asarray(ids, np.int32)))
        for c in ids:
            assert (accounting.client_upload_bytes_strategy(table, OMC, strategy, r, c)
                    == jaccounting.client_upload_bytes_strategy(jtable, JOMC_, jstrategy, r, c))
    if strategy.label == "omc-s1e3m7":  # the OMC strategy is the plain ledger
        assert table.download_bytes_strategy(strategy) == table.download_bytes(OMC)
    stats = accounting.AsyncWireStats(table, strategy=strategy)
    jstats = jaccounting.AsyncWireStats(jtable, strategy=jstrategy)
    for st, o in ((stats, OMC), (jstats, JOMC_)):
        st.start_round(o, 0, 2)
        st.start_round(o, 0, 5)
        st.finish_round(o, 0, 2, staleness=0)
        st.finish_round(o, 0, 5, staleness=1)
    assert stats.snapshot() == jstats.snapshot()
