"""Roofline terms and bounds (port of ``repro.roofline.analysis``).

  compute    = FLOPs       / (chips x peak FLOP/s)
  memory     = bytes       / (chips x HBM bytes/s)
  collective = wire bytes  / (chips x link bytes/s)

The port has no compiler to ask: ``launch/dryrun.py`` counts FLOPs and
bytes over the aten ops (and the kernels' calls) of a meta-device trace of
the cell's step, and reports no collective schedule, so its collective term
is 0.  The reference's ``analyze_compiled``, ``collective_bytes``,
``collective_counts`` and ``hlo_cost.py`` read XLA's HLO text and have no
counterpart here (ROADMAP C25).

The byte bounds of the compressed-domain kernels (DESIGN.md §13) are the
reference's: ``benchmarks_torch/kernels_micro.py`` holds each kernel's moved
bytes (the ``*_moved_bytes`` helpers of ``repro_torch.kernels``) within 2x
of them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.packing import packed_words


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    wire_bytes: float
    per_collective: Dict[str, float]
    collective_ops: Dict[str, int]
    model_flops: float = 0.0
    top_collectives: list = dataclasses.field(default_factory=list)
    top_bytes: list = dataclasses.field(default_factory=list)
    xla_cost_analysis_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = dict(compute=self.compute_s, memory=self.memory_s,
                     collective=self.collective_s)
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap estimate: sum of terms (upper bound)."""
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def step_time_overlap_s(self) -> float:
        """Perfect-overlap estimate: max of terms (lower bound)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: recompute and redundancy."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the overlap-optimistic step time."""
        if self.step_time_overlap_s == 0:
            return 0.0
        return (self.model_flops and
                (self.model_flops / self.hlo_flops) * self.compute_s
                / self.step_time_overlap_s) or 0.0

    def to_dict(self):
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, step_time_s=self.step_time_s,
                 step_time_overlap_s=self.step_time_overlap_s,
                 useful_flops_ratio=self.useful_flops_ratio)
        return d


def packbits_bound_bytes(n: int, width: int) -> int:
    """Minimal device-memory bytes to (un)pack ``n`` ``width``-bit codes:
    one read of the u32 code plane and one write of the exact
    ``ceil(n·width/32)``-word stream (or the reverse); no padding."""
    return 4 * n + 4 * packed_words(n, width)


def fused_aggregate_bound_bytes(cohort: int, n: int, container_bytes: int) -> int:
    """Minimal device-memory bytes for one fused compressed-domain server
    round: the server plane and ``cohort`` client planes read once, the new
    plane written once, ``(C + 2)·n`` container elements; the O(C)
    per-client scalars are ignored."""
    return (cohort + 2) * n * container_bytes


def model_flops(arch_mod, cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for inference (N = active)."""
    n = (cfg.active_param_count() if hasattr(cfg, "active_param_count")
         else cfg.param_count())
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
