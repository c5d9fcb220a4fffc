"""PyTorch port vs the JAX reference: the roofline's bounds, MODEL_FLOPS and
``RooflineTerms``, and ``TransformerConfig.param_count`` against the init.

Tolerances: every bound, count and FLOP figure is exact (integer or the
same float arithmetic on the same integers); ``to_dict`` equal key for key.
"""

import dataclasses

import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.shapes import SHAPES as JSHAPES
from repro.roofline import analysis as janalysis
from repro_torch.configs import qwen2_5_3b, registry, shapes
from repro_torch.core import prng
from repro_torch.core.tree import tree_items
from repro_torch.models import transformer
from repro_torch.roofline import analysis

torch.set_num_threads(1)


def test_shapes_are_the_references():
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("width", range(1, 33))
def test_packbits_bound_bytes_matches_reference(width):
    for n in (0, 1, 31, 32, 33, 1000, 65_536, 311_164_928, 811_597_824):
        assert analysis.packbits_bound_bytes(n, width) == janalysis.packbits_bound_bytes(n, width)


@pytest.mark.parametrize("container", [1, 2, 4])
def test_fused_aggregate_bound_bytes_matches_reference(container):
    for cohort in (1, 8, 33, 64):
        for n in (1, 16_384, 262_144, 17 * 512 * 2048):
            assert (analysis.fused_aggregate_bound_bytes(cohort, n, container)
                    == janalysis.fused_aggregate_bound_bytes(cohort, n, container))


@pytest.mark.parametrize("arch_id", registry.list_archs())
def test_model_flops_matches_reference(arch_id):
    """MODEL_FLOPS of every ported arch at each shape cell, through the
    port's own ``param_count`` (the transformer's new one included)."""
    arch, jarch = registry.get_arch(arch_id), jregistry.get_arch(arch_id)
    cfg, jcfg = arch.config(), jarch.config()
    assert cfg.param_count() == jcfg.param_count()
    for name, shape in shapes.SHAPES.items():
        got = analysis.model_flops(arch, cfg, shape)
        assert got == janalysis.model_flops(jarch, jcfg, JSHAPES[name]) and got > 0


def test_qwen_param_count_is_the_inits_leaf_sizes():
    """C8's check for the transformer: the count equals the sum of the
    init's leaf sizes, the tied head counted once (it is the embedding)."""
    cfg = qwen2_5_3b.config()
    params = transformer.init(prng.PRNGKey(0), cfg, "meta")
    assert "lm_head" not in params and cfg.tie_embeddings
    total = sum(leaf.numel() for _, leaf in tree_items(params))
    assert cfg.param_count() == total == 3_085_938_688
    untied = transformer.TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                                           d_ff=160, vocab=512, head_dim=16)
    leaves = transformer.init(prng.PRNGKey(0), untied, "meta")
    assert untied.param_count() == sum(v.numel() for _, v in tree_items(leaves))


def test_roofline_terms_match_reference():
    kw = dict(compute_s=1.5e-3, memory_s=2.25e-3, collective_s=0.0, hlo_flops=3.0e15,
              hlo_bytes=7.0e12, wire_bytes=0.0, per_collective={}, collective_ops={},
              model_flops=1.2e15)
    got, want = analysis.RooflineTerms(**kw), janalysis.RooflineTerms(**kw)
    assert got.to_dict() == want.to_dict()
    for prop in ("dominant", "step_time_s", "step_time_overlap_s", "useful_flops_ratio",
                 "mfu_bound"):
        assert getattr(got, prop) == getattr(want, prop), prop
    compute = dict(kw, compute_s=5e-3)
    assert analysis.RooflineTerms(**compute).to_dict() == janalysis.RooflineTerms(
        **compute).to_dict()
    empty = dict(kw, hlo_flops=0.0, compute_s=0.0, memory_s=0.0)
    assert analysis.RooflineTerms(**empty).to_dict() == janalysis.RooflineTerms(
        **empty).to_dict()
