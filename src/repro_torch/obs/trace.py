"""Span tracer: wall-clock and virtual-clock timing (port of
``repro.obs.trace``, DESIGN.md §15).

Two clocks, one span type:

  * **wall** spans time host-side phases (dispatch, flush, hot-swap,
    payload encode/decode, a round) with ``time.perf_counter``.  No span
    synchronizes the device: on the card a wall span times the host's
    dispatch up to the span's end, and work the span queued may still be
    running when it closes (a later synchronizing call pays for it).  So a
    handle leaves the device's timeline as it is with ``obs=None``.
  * **virtual** spans carry the async runtime's simulated clock: a client
    round is a span at its check-in time with the sampled latency as its
    duration.  Virtual spans are *constructed*, never timed: the event loop
    knows both ends when the check-in fires.

The tracer only appends (one list append a span); export to
Chrome-trace/Perfetto JSON lives in :mod:`.export`, so the hot path never
touches the filesystem.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

#: span categories (the ``cat`` field), the reference's
WALL = "wall"
VIRTUAL = "virtual"


@dataclass(frozen=True)
class Span:
    """One closed interval on either clock.

    ``ts``/``dur`` are **seconds** on the span's own clock: wall spans use
    the tracer's epoch (the first span at about 0), virtual spans the async
    runtime's simulated time.
    """

    name: str
    ts: float
    dur: float
    cat: str = WALL
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def end(self) -> float:
        return self.ts + self.dur


class Tracer:
    """Collects :class:`Span`\\ s for one run; not thread-safe.

    Every span goes through :meth:`add`; :meth:`span` is the wall-clock
    context manager and :meth:`vspan` the virtual-clock constructor.
    ``tracer=None`` call sites use :func:`maybe_span`, a no-op then.
    """

    def __init__(self) -> None:
        self._spans: List[Span] = []
        self._epoch = time.perf_counter()

    def __len__(self) -> int:
        return len(self._spans)

    def now(self) -> float:
        """Seconds since this tracer's epoch (wall clock)."""
        return time.perf_counter() - self._epoch

    def add(self, span: Span) -> Span:
        self._spans.append(span)
        return span

    @contextmanager
    def span(self, name: str, **args: Any) -> Iterator[Dict[str, Any]]:
        """Wall-clock span around a ``with`` body.  Yields the mutable
        ``args`` dict, so the body can attach results (byte counts, say)
        before the span closes."""
        t0 = self.now()
        try:
            yield args
        finally:
            self.add(Span(name=name, ts=t0, dur=self.now() - t0, args=args))

    def vspan(self, name: str, ts: float, dur: float, **args: Any) -> Span:
        """Record a virtual-clock span at simulated time ``ts``."""
        return self.add(Span(name=name, ts=float(ts), dur=float(dur), cat=VIRTUAL, args=args))

    def spans(self, cat: Optional[str] = None, name: Optional[str] = None) -> List[Span]:
        out = self._spans
        if cat is not None:
            out = [s for s in out if s.cat == cat]
        if name is not None:
            out = [s for s in out if s.name == name]
        return list(out)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per ``cat:name``: count, total and mean seconds."""
        agg: Dict[str, Dict[str, float]] = {}
        for s in self._spans:
            rec = agg.setdefault(f"{s.cat}:{s.name}", {"count": 0.0, "total_s": 0.0})
            rec["count"] += 1
            rec["total_s"] += s.dur
        for rec in agg.values():
            rec["mean_s"] = rec["total_s"] / max(rec["count"], 1.0)
        return agg


@contextmanager
def maybe_span(tracer: Optional[Tracer], name: str, **args: Any) -> Iterator[Dict[str, Any]]:
    """``tracer.span(...)`` when tracing, else a free no-op."""
    if tracer is None:
        yield args
    else:
        with tracer.span(name, **args) as a:
            yield a
