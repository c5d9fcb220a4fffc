"""PyTorch port vs the JAX reference: the meta-device dry-run, its JSON and
the roofline report, and ``kernels_micro`` on the CPU.

The port builds each cell on ``torch.device("meta")``; the reference's
shapes come from ``jax.eval_shape`` of its ``init_state`` and
``init_decode_state``, and its layouts from its ``resolve_spec`` on a stub
mesh, so nothing full-size is allocated on either side.

Declared (ROADMAP C25): the decode state's ``length`` is a host int in the
port (a 0-d int32 leaf in the reference), and the port's tokens are int64
(the reference's int32), so a batch takes twice the reference's bytes.

Tolerances: leaf paths, shapes, dtypes and byte counts exact.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.omc import OMCConfig as JOMC
from repro.core.store import is_compressed as j_is_compressed
from repro.federated.state import init_state as j_init_state
from repro.launch import specs as jspecs
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.models import griffin as jgriffin
from repro.models import transformer as jtransformer
from repro.models import xlstm as jxlstm
from repro.optim import fedavg as jfedavg
from repro_torch.configs import qwen2_5_3b, recurrentgemma_2b, seamless_m4t_medium, xlstm_350m
from repro_torch.configs.registry import ASSIGNED
from repro_torch.configs.shapes import SHAPES, Shape
from repro_torch.core.store import is_compressed
from repro_torch.launch import dryrun
from repro_torch.launch import specs as specs_lib
from repro_torch.roofline import analysis

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks_torch import kernels_micro, roofline_report  # noqa: E402

torch.set_num_threads(1)

PORTED_CELLS = {("qwen2.5-3b", "train_4k"), ("qwen2.5-3b", "prefill_32k"),
                ("qwen2.5-3b", "decode_32k"), ("recurrentgemma-2b", "prefill_32k"),
                ("recurrentgemma-2b", "decode_32k"), ("recurrentgemma-2b", "long_500k")}
# the decoder-only zoo: every cell the reference runs (long_500k for the two
# sliding-window archs only)
PORTED_CELLS |= {(a, s) for a in ("h2o-danube-3-4b", "qwen1.5-110b", "mistral-nemo-12b",
                                  "internvl2-1b", "dbrx-132b", "mixtral-8x7b")
                 for s in ("train_4k", "prefill_32k", "decode_32k")}
PORTED_CELLS |= {("h2o-danube-3-4b", "long_500k"), ("mixtral-8x7b", "long_500k")}
# the last families: griffin's training cell, xlstm's four, seamless' three
PORTED_CELLS |= {("recurrentgemma-2b", "train_4k")}
PORTED_CELLS |= {("xlstm-350m", s) for s in SHAPES}
PORTED_CELLS |= {("seamless-m4t-medium", s) for s in ("train_4k", "prefill_32k", "decode_32k")}
FULL_ATTENTION = {"qwen2.5-3b", "qwen1.5-110b", "mistral-nemo-12b", "internvl2-1b",
                  "dbrx-132b", "seamless-m4t-medium"}


class StubMesh:
    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty(shape)


def _small(arch):
    """``--set`` overrides that turn the full config into its smoke config."""
    full, smoke = arch.config(), arch.smoke_config()
    return {f.name: str(getattr(smoke, f.name)) for f in dataclasses.fields(full)
            if getattr(smoke, f.name) != getattr(full, f.name)}


def _jflat(tree, path=()):
    """(path, leaf) of a reference tree: dicts, CompressedVariable, KVCache."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jflat(tree[k], path + (k,))
    elif j_is_compressed(tree):
        for f in ("codes", "s", "b"):
            yield from _jflat(getattr(tree, f), path + (f,))
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _jflat(getattr(tree, f), path + (f,))
    else:
        yield path, tree


def _flat(tree, path=()):
    """(path, Sharded) of an annotated port tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif is_compressed(tree) or dataclasses.is_dataclass(tree) and not isinstance(
            tree, specs_lib.Sharded):
        for f in dataclasses.fields(tree):
            if f.name != "fmt":
                yield from _flat(getattr(tree, f.name), path + (f.name,))
    else:
        yield path, tree


def _reference_cell(arch, shape: Shape, fmt: str):
    """The reference's params and decode state for the small config, as
    ``jax.eval_shape`` structs (nothing allocated)."""
    jfam = dict(transformer=jtransformer, griffin=jgriffin, xlstm=jxlstm,
                encdec=jencdec)[arch.FAMILY]
    smoke = arch.smoke_config()
    jcfg = getattr(jfam, type(smoke).__name__)(**dataclasses.asdict(smoke))
    params = jax.eval_shape(
        lambda k: j_init_state(k, jfam, jcfg, JOMC.parse(fmt), jfedavg(1.0)).params,
        jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: jfam.init_decode_state(jcfg, shape.global_batch,
                                                          shape.seq_len))
    return jfam, jcfg, params, cache


@pytest.mark.parametrize("arch", [qwen2_5_3b, recurrentgemma_2b, xlstm_350m,
                                  seamless_m4t_medium], ids=lambda a: a.ID)
def test_meta_build_matches_reference_shapes_and_bytes(arch):
    """The meta build of a small config against the reference's
    ``eval_shape``: leaf paths, shapes and dtypes of the storage tree and
    the decode state; then the per-device argument bytes on the 16x16 mesh
    against the sum over the reference's leaves of its shard shape x
    itemsize, from the reference's ``resolve_spec``."""
    shape, fmt = Shape("t", "decode", 256, 32), "S1E4M14"
    cell = dryrun.build_cell(arch.ID, shape, fmt=fmt, overrides=_small(arch))
    assert cell.cfg == arch.smoke_config()
    jfam, jcfg, jparams, jcache = _reference_cell(arch, shape, fmt)
    stub = StubMesh((16, 16), ("data", "model"))
    jspec_of = dict(_jflat(jfam.param_specs(jcfg)))
    got_bytes = dryrun.argument_bytes(cell)

    def ref_bytes(path, leaf, axes):
        spec = jcommon.resolve_spec(axes, leaf.shape, stub)
        sizes = dict(data=16, model=16)
        n = 1
        for e in spec:
            for a in (() if e is None else (e,) if isinstance(e, str) else e):
                n *= sizes[a]
        return math.prod(leaf.shape) * leaf.dtype.itemsize // n

    for name, jtree, ours in (("params", jparams, cell.inputs["params"]),
                              ("cache", jcache, cell.inputs["cache"])):
        want = [(p, l) for p, l in _jflat(jtree) if p[-1] != "length"]
        have = [(p, l) for p, l in _flat(ours) if p[-1] != "length"]  # host ints (C25)
        assert [p for p, _ in have] == [p for p, _ in want], name
        total = 0
        for (path, leaf), (_, placed) in zip(want, have):
            assert tuple(placed.shape) == tuple(leaf.shape), (name, path)
            assert str(placed.dtype).replace("torch.", "") == str(leaf.dtype), (name, path)
            if name == "params":
                compressed = path[:-1] in jspec_of and path[-1] in ("codes", "s", "b")
                spec = jspec_of[path[:-1] if compressed else path]
                axes = (() if compressed and path[-1] != "codes"  # (s, b) replicated
                        else jcommon._pad_spec(spec.storage, len(leaf.shape)))
            else:
                axes = _cache_axes(arch.FAMILY, path)[:len(leaf.shape)]
            total += ref_bytes(path, leaf, axes)
            assert placed.shard_nbytes() == ref_bytes(path, leaf, axes), (name, path)
        assert got_bytes[name] == total, name
    tokens = math.prod((shape.global_batch, 1)) * 4 // 16  # int32, batch over data
    assert got_bytes["batch"] == 2 * tokens  # int64 tokens (C25)
    assert dryrun.argument_bytes(cell) == got_bytes


def _cache_axes(family, path):
    axes = jspecs.decode_state_axes(family, None, dict(extra_rec=None, extra_m=None))
    for k in path:
        axes = getattr(axes, k) if hasattr(axes, "_fields") else axes[k]
    return axes


def test_full_width_decode_cell_and_report(tmp_path):
    """qwen2.5-3b x decode_32k at full width on the 16x16 mesh, through
    ``run_cell`` into a directory, then ``roofline_report`` on it."""
    out = dryrun.run_cell("qwen2.5-3b", "decode_32k", out_dir=str(tmp_path))
    path = tmp_path / "qwen2.5-3b_decode_32k_pod.json"
    saved = json.loads(path.read_text())
    assert saved == json.loads(json.dumps(out))
    mem = saved["memory_analysis"]
    assert mem["argument_size_in_bytes"] == sum(mem["argument_bytes_by_input"].values())
    # bf16 K and V and int32 positions, batch over data and the cache's slots over model
    kv, pos = 36 * 128 * 32_768 * 2 * 128 * 2, 36 * 128 * 32_768 * 4
    assert mem["argument_bytes_by_input"]["cache"] == (2 * kv + pos) // 256
    r = saved["roofline"]
    cfg = qwen2_5_3b.config()
    assert r["model_flops"] == analysis.model_flops(qwen2_5_3b, cfg, SHAPES["decode_32k"])
    assert r["collective_s"] == 0 and r["per_collective"] == {}
    assert r["hlo_flops"] > r["model_flops"] > 0 and r["dominant"] == "memory"
    assert saved["kernel_calls"] == {"dequant_matmul": 7 * 36, "dequantize": 2}
    assert saved["n_chips"] == 256 and saved["mesh"] == [16, 16]
    rows = roofline_report.run(tmp_path)
    assert len(rows) == 1
    row = rows[0]
    assert (row["arch"], row["shape"], row["mesh"], row["fmt"], row["tag"]) == (
        "qwen2.5-3b", "decode_32k", "16x16", "S1E4M14", "base")
    assert row["coll_ms"] == 0 and row["dominant"] == "memory" and 0 < row["useful"] < 1


def test_cli_writes_a_griffin_cell(tmp_path):
    dryrun.main(["--arch", "recurrentgemma-2b", "--shape", "long_500k", "--fmt", "S1E3M7",
                 "--out-dir", str(tmp_path), "--quiet"])
    saved = json.loads((tmp_path / "recurrentgemma-2b_long_500k_pod.json").read_text())
    assert saved["fmt"] == "S1E3M7" and saved["kernel_calls"]["dequant_matmul"] == 200


def test_all_skips_every_unported_cell_by_name():
    ran = set()
    for arch_id in ASSIGNED:
        for name, shape in SHAPES.items():
            reason = dryrun.skip_reason(arch_id, shape)
            if reason is None:
                ran.add((arch_id, name))
            else:
                assert arch_id in FULL_ATTENTION and name == "long_500k", (arch_id, name)
                assert "full attention" in reason
    assert ran == PORTED_CELLS and len(ran) == 34
    with pytest.raises(SystemExit, match="SKIP qwen2.5-3b x long_500k"):
        dryrun.build_cell("qwen2.5-3b", "long_500k")


def test_kernels_micro_smoke_on_the_cpu():
    """``kernels_micro --smoke --device cpu``: the plain versions at the
    reference's smoke sizes, its moved-over-bound assertions included."""
    out = kernels_micro.run(smoke=True, device="cpu")
    assert [r["width"] for r in out["bitpack"]] == [2, 6, 11, 16, 19, 32]
    assert all(r["moved_over_bound"] <= 2.0 and r["unpack_moved_over_bound"] <= 2.0
               for r in out["bitpack"])
    assert [r["fmt"] for r in out["fused_aggregate"]] == ["S1E3M7", "S1E4M14"]
    assert all(1.0 <= r["moved_over_bound"] <= 2.0 for r in out["fused_aggregate"])
    assert {r["kernel"] for r in out["codec"]} == {"quantize", "dequantize", "dequant_matmul"}
    assert all("share" not in r for r in out["codec"] + out["fused_aggregate"])
