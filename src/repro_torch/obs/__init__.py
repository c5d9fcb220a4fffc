"""Telemetry for every training and serving path (port of ``repro.obs``,
DESIGN.md §15).

One handle, three layers:

  * **metrics** (:mod:`.metrics`): scalar bundles (loss, per-leaf
    quantization-error norms, the update norm, EF residual norms, alive
    counts) built after a round returns and folded into a
    :class:`~.metrics.MetricsSink`;
  * **tracing** (:mod:`.trace`): wall-clock spans (round, dispatch, flush,
    hot-swap, payload encode and decode) and virtual-clock spans for the
    async runtime's simulated timeline;
  * **export** (:mod:`.export`): a JSONL event log and a Chrome-trace /
    Perfetto JSON under ``experiments/obs/``, rendered by
    ``python -m repro_torch.obs.report``.

The contract every instrumented call site keeps: ``obs=None`` (the default
everywhere) is a **true no-op**, with no extra outputs, no spans and no
files; and with a handle on, a round only hands back what it already
computed (the cohort mean), and every statistic of the bundle runs after
the round returns, so the stored tree and the wire ledgers are the same
bits and bytes as with ``obs=None`` (tests/test_torch_obs.py).  Wall spans
time the host and never synchronize the card (:mod:`.trace`).

Typical use::

    obs = Obs(run_name="engine_c8")
    storage, hist = run_training_vectorized(..., obs=obs)
    paths = obs.flush()   # experiments/obs/engine_c8.{obs.jsonl,perfetto.json}
    # python -m repro_torch.obs.report experiments/obs/engine_c8.obs.jsonl
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

from .metrics import Bundle, MetricsSink
from .trace import Span, Tracer, maybe_span

__all__ = [
    "Obs", "MetricsSink", "Tracer", "Span", "Bundle",
    "maybe_span", "null_span",
]

DEFAULT_OUT_DIR = os.path.join("experiments", "obs")


class Obs:
    """A run's telemetry handle: a sink, a tracer and their export.

    ``metrics=False`` keeps the rounds bundle-free (spans only);
    ``trace=False`` drops the spans.  Call sites accept ``obs=None`` and
    treat it as fully off.
    """

    def __init__(self, run_name: str = "run", out_dir: Optional[str] = None, *,
                 metrics: bool = True, trace: bool = True) -> None:
        self.run_name = str(run_name)
        self.out_dir = out_dir if out_dir is not None else DEFAULT_OUT_DIR
        self.sink = MetricsSink()
        self.tracer: Optional[Tracer] = Tracer() if trace else None
        self._metrics = bool(metrics)

    @property
    def collect_metrics(self) -> bool:
        """Whether rounds hand back their cohort mean and build a bundle."""
        return self._metrics

    def record(self, kind: str, bundle: Optional[Bundle] = None,
               **fields: Any) -> Dict[str, Any]:
        return self.sink.record(kind, bundle, **fields)

    @contextmanager
    def span(self, name: str, **args: Any) -> Iterator[Dict[str, Any]]:
        with maybe_span(self.tracer, name, **args) as a:
            yield a

    def vspan(self, name: str, ts: float, dur: float, **args: Any) -> None:
        if self.tracer is not None:
            self.tracer.vspan(name, ts, dur, **args)

    def flush(self) -> Dict[str, str]:
        """Write ``<out_dir>/<run>.obs.jsonl`` (and ``.perfetto.json`` when
        tracing); return their paths.

        A ``kind=meta`` record comes first, with the run's name and
        ``kernels.ops.dispatch_counts()``.  In the port those count kernel
        *launches* (one per call, ``"<op>.cuda"`` or ``"<op>.ref"``), where
        the reference's count traces (ROADMAP C9): the field's name and
        schema are the same, its meaning is not."""
        from repro_torch.kernels import ops as kernel_ops

        from .export import export_run

        meta = {"kind": "meta", "run": self.run_name,
                "dispatch_counts": kernel_ops.dispatch_counts()}
        return export_run(self.out_dir, self.run_name, [meta] + self.sink.records(),
                          self.tracer)


@contextmanager
def null_span(obs: Optional[Obs], name: str, **args: Any) -> Iterator[Dict[str, Any]]:
    """``obs.span`` that takes ``obs=None`` (then it yields ``args`` and
    records nothing): the instrumented call sites' span."""
    if obs is None:
        yield args
    else:
        with obs.span(name, **args) as a:
            yield a
