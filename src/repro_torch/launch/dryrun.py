"""Meta-device dry-run: every (arch x shape x mesh) cell built and stepped
on ``torch.device("meta")`` (port of ``repro.launch.dryrun``).

Nothing is allocated.  A cell is the storage tree from ``init_state`` at
``--fmt`` (S1E4M14; ``--fp32-baseline``: S1E8M23), the batch from
``specs.batch_specs`` and, for prefill and decode cells, the decode state
from the family's ``init_decode_state``, each leaf annotated with where it
would live on the production mesh (``specs.annotate_state``,
``annotate_tree``, ``annotate_cache``).  Then the cell's step runs on meta
(the federated round's forward and backward, a prefill, or one decode
step) under :class:`CostCounter`, which sums every aten op's FLOPs
(``torch.utils.flop_counter``'s formulas) and the bytes of its inputs and
outputs, and the kernels' calls the same way (``kernels.ops`` reports them
on meta).  Those sums stand in for XLA's ``cost_analysis`` FLOPs and bytes
accessed; the port compiles nothing, so there is no collective schedule and
no temporary-buffer size (ROADMAP C25).

Per cell, JSON under ``experiments/dryrun_torch/`` (named as the reference
names its files): ``memory_analysis.argument_size_in_bytes`` (per device:
the sum over leaves of the shard shape's size times the itemsize), the
``RooflineTerms`` (compute = counted FLOPs / chips / ``PEAK_FLOPS_BF16``,
memory = counted bytes / chips / ``HBM_BW``, collective 0), ``model_flops``
and the build and trace seconds.  The counts are of the port's own ops,
which compute in f32 (the serving path's only dtype, C16), over one device's
unsharded program; the times they imply are bounds from the H100's data
sheet, not card times.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all      # every ported cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun ... --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun ... --fp32-baseline

``--all`` runs ``ASSIGNED`` x ``SHAPES`` (34 cells) and names each cell it
skips: a full-attention arch at ``long_500k`` (6 cells), as the reference
does.  A MoE cell on the production mesh stores ``ep_partitions`` experts a
shard as the reference does (``specs.maybe_ep_partitions``), and
dispatches over the whole batch (ROADMAP C27).  The recurrences are host
loops, so a trace walks every step: xlstm-350m's ``prefill_32k`` runs
32,768 sLSTM steps in each of its 3 sLSTM blocks and 512 mLSTM chunks in
each of its 21 mLSTM blocks, and its ``train_4k`` 4,096 sLSTM steps in the
forward pass, again in the recompute and in the backward pass; the counts
are the whole program's (ROADMAP C25).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import Counter
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.registry import ASSIGNED, get_arch
from repro_torch.configs.shapes import SHAPES, Shape
from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.federated.round import make_round_fn, make_serve_fns
from repro_torch.federated.state import init_state
from repro_torch.kernels import ops
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, Mesh, make_production_mesh
from repro_torch.models.common import activate_mesh
from repro_torch.models.registry import get_family
from repro_torch.obs.log import Logger
from repro_torch.optim import fedavg
from repro_torch.roofline.analysis import RooflineTerms, model_flops

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# module-level so run_cell keeps its signature for programmatic callers;
# main() rebinds it from --quiet
log = Logger()

_aten = torch.ops.aten
_ALLOCATIONS = {_aten.empty.memory_format, _aten.empty_strided.default,
                _aten.empty_like.default, _aten.new_empty.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Sums FLOPs and bytes moved over the ops run inside it.

    An aten op counts the bytes of its tensor inputs and outputs, and its
    FLOPs by ``torch.utils.flop_counter``'s formula where it has one (matmul,
    convolution, attention; elementwise ops count none).  A view or an empty
    allocation moves nothing.  A kernel wrapper called on meta tensors
    counts the same way, its FLOPs as ``kernels.ops`` reports them.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops: Counter = Counter()
        self._listen = ops.meta_listener(self._kernel)

    def __enter__(self):
        self._listen.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._listen.__exit__(*exc)

    def _kernel(self, op, inputs, outputs, flops) -> None:
        self.ops[f"kernel.{op}"] += 1
        self.flops += flops
        self.bytes += sum(_nbytes(t) for t in list(inputs) + list(outputs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _ALLOCATIONS:
            return out
        self.ops[str(func.overloadpacket)] += 1
        tensors = [t for t in tree_leaves((args, kwargs, out)) if isinstance(t, torch.Tensor)]
        self.bytes += sum(_nbytes(t) for t in tensors)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        return out


@dataclasses.dataclass
class Cell:
    """One (arch x shape x mesh) cell on meta: its annotated inputs and its step."""

    arch_id: str
    shape: Shape
    arch: ModuleType
    family: ModuleType
    cfg: Any
    mesh: Mesh
    fmt: str
    inputs: Dict[str, Any]  # "state" or "params", "batch", "cache": annotated trees
    step: Callable[[], Any]


def skip_reason(arch_id: str, shape: Shape) -> Optional[str]:
    """Why ``--all`` skips this cell, or None when it runs."""
    if shape.sub_quadratic_only and not get_arch(arch_id).LONG_CONTEXT_OK:
        return "full attention: long-context decode requires sub-quadratic state (DESIGN.md §6)"
    return None


def _override(cfg, overrides):
    typed = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            typed[k] = v in ("1", "true", "True")
        else:
            typed[k] = type(cur)(v) if cur is not None else v
    return dataclasses.replace(cfg, **typed)


def build_cell(arch_id: str, shape: Union[str, Shape], *, multi_pod: bool = False,
               mesh: Optional[Mesh] = None, fmt: str = "S1E4M14", fp32_baseline: bool = False,
               cache_dtype: torch.dtype = torch.bfloat16, overrides=None) -> Cell:
    """The cell's storage tree, batch and decode state on meta, annotated
    against ``mesh`` (the production mesh by default), and its step.
    ``cache_dtype`` is the decode state's K/V dtype (the reference's default,
    bf16; a ``ServeSession`` keeps f32)."""
    arch = get_arch(arch_id)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if shape.sub_quadratic_only and not arch.LONG_CONTEXT_OK:
        raise SystemExit(f"SKIP {arch_id} x {shape.name}: full-attention arch, long-context "
                         f"decode requires sub-quadratic state (DESIGN.md §6)")
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    family = get_family(arch.FAMILY)
    cfg = S.maybe_ep_partitions(arch.config(), mesh)
    if overrides:
        cfg = _override(cfg, overrides)
    fmt = "S1E8M23" if fp32_baseline else fmt
    omc = OMCConfig.parse(fmt)
    specs = family.param_specs(cfg)
    key = prng.PRNGKey(0)

    with activate_mesh(mesh):
        batch = S.batch_specs(arch, cfg, shape)
        inputs: Dict[str, Any] = {}
        if shape.kind == "train":
            opt = fedavg(1.0)
            state = init_state(key, family, cfg, omc, opt, device="meta")
            inputs["state"] = S.annotate_state(state, specs, mesh)
            round_fn = make_round_fn(family, cfg, omc, opt, client_lr=1e-2)
            step = lambda: round_fn(state, batch)  # noqa: E731
        else:
            params = init_state(key, family, cfg, omc, fedavg(1.0), device="meta").params
            inputs["params"] = S.annotate_tree(params, specs, mesh)
            cache = family.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                             dtype=cache_dtype, device="meta")
            inputs["cache"] = S.annotate_cache(cache, arch.FAMILY, cfg, mesh)
            prefill_fn, decode_fn = make_serve_fns(family, cfg)
            if shape.kind == "prefill":
                step = lambda: prefill_fn(params, batch, cache)  # noqa: E731
            else:
                step = lambda: decode_fn(params, cache, batch["tokens"])  # noqa: E731
        inputs["batch"] = S.annotate_batch(batch, mesh)
    return Cell(arch_id, shape, arch, family, cfg, mesh, fmt, inputs, step)


def sharded_leaves(tree):
    """Every :class:`specs.Sharded` leaf of an annotated tree (dicts, named
    tuples, ``TrainState``, ``KVCache``, ``CompressedVariable``)."""
    if isinstance(tree, S.Sharded):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from sharded_leaves(tree[k])
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from sharded_leaves(getattr(tree, f.name))
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from sharded_leaves(v)


def argument_bytes(cell: Cell) -> Dict[str, int]:
    """Per-device bytes of each input, by name: the sum over its leaves of
    the shard shape's size times the itemsize."""
    return {name: sum(leaf.shard_nbytes() for leaf in sharded_leaves(tree))
            for name, tree in cell.inputs.items()}


def trace_cell(cell: Cell) -> CostCounter:
    """Run the cell's step on meta under a :class:`CostCounter`."""
    with activate_mesh(cell.mesh), CostCounter() as counter:
        cell.step()
    return counter


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
             fmt: str = "S1E4M14", fp32_baseline: bool = False,
             out_dir: Optional[str] = None, tag: str = "", overrides=None) -> Dict[str, Any]:
    t0 = time.perf_counter()
    cell = build_cell(arch_id, shape_name, multi_pod=multi_pod, fmt=fmt,
                      fp32_baseline=fp32_baseline, overrides=overrides)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    counter = trace_cell(cell)
    trace_s = time.perf_counter() - t0

    n_chips = cell.mesh.devices.size
    by_input = argument_bytes(cell)
    terms = RooflineTerms(
        compute_s=counter.flops / n_chips / PEAK_FLOPS_BF16,
        memory_s=counter.bytes / n_chips / HBM_BW,
        collective_s=0.0,
        hlo_flops=float(counter.flops),
        hlo_bytes=float(counter.bytes),
        wire_bytes=0.0,
        per_collective={},
        collective_ops={},
        model_flops=model_flops(cell.arch, cell.cfg, cell.shape),
    )
    result = dict(
        arch=arch_id, shape=shape_name, mesh=list(cell.mesh.devices.shape), n_chips=n_chips,
        fmt=cell.fmt, build_s=round(build_s, 2), trace_s=round(trace_s, 2),
        memory_analysis=dict(argument_size_in_bytes=sum(by_input.values()),
                             argument_bytes_by_input=by_input),
        roofline=terms.to_dict(),
        kernel_calls={k[len("kernel."):]: v for k, v in sorted(counter.ops.items())
                      if k.startswith("kernel.")},
    )
    od = Path(out_dir) if out_dir else OUT_DIR
    od.mkdir(parents=True, exist_ok=True)
    mesh_tag = "multipod" if multi_pod else "pod"
    suffix = f"_{tag}" if tag else ("_fp32" if fp32_baseline else "")
    path = od / f"{arch_id}_{shape_name}_{mesh_tag}{suffix}.json"
    path.write_text(json.dumps(result, indent=1))
    log.result(
        f"OK {arch_id} x {shape_name} [{mesh_tag}] build={build_s:.1f}s trace={trace_s:.1f}s "
        f"args={result['memory_analysis']['argument_size_in_bytes']:,} B/device "
        f"dominant={terms.dominant} terms=({terms.compute_s * 1e3:.3f}, "
        f"{terms.memory_s * 1e3:.3f}, 0) ms -> {path}",
        arch=arch_id, shape=shape_name, mesh=mesh_tag, build_s=round(build_s, 2),
        trace_s=round(trace_s, 2), dominant=terms.dominant, path=str(path))
    return result


def main(argv=None):
    global log
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fmt", default="S1E4M14")
    ap.add_argument("--fp32-baseline", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (repeatable)")
    ap.add_argument("--quiet", action="store_true", help="suppress stderr text")
    args = ap.parse_args(argv)
    log = Logger(quiet=args.quiet)
    overrides = dict(s.split("=", 1) for s in args.set) or None

    if not args.all:
        run_cell(args.arch, args.shape, multi_pod=args.multi_pod, fmt=args.fmt,
                 fp32_baseline=args.fp32_baseline, out_dir=args.out_dir, tag=args.tag,
                 overrides=overrides)
        return
    ran, skipped = [], []
    for arch_id in ASSIGNED:
        for shape_name, shape in SHAPES.items():
            reason = skip_reason(arch_id, shape)
            if reason:
                log.warn(f"SKIP {arch_id} x {shape_name}: {reason}", arch=arch_id,
                         shape=shape_name, reason=reason)
                skipped.append((arch_id, shape_name))
                continue
            run_cell(arch_id, shape_name, multi_pod=args.multi_pod, fmt=args.fmt,
                     fp32_baseline=args.fp32_baseline, out_dir=args.out_dir, tag=args.tag,
                     overrides=overrides)
            ran.append((arch_id, shape_name))
    log.result(f"ALL CELLS PASSED: {len(ran)} ran, {len(skipped)} skipped by name",
               ran=len(ran), skipped=len(skipped))


if __name__ == "__main__":
    main()
