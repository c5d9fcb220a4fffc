"""Client availability and latency traces for the async runtime (port of
``repro.federated.traces``, DESIGN.md §10).

A trace answers the two questions the event-driven runtime
(:mod:`repro_torch.federated.async_engine`) asks about every client:

  * **availability** — after finishing (or at t=0), how long until this
    client next *checks in* (``checkin_delay`` / ``first_checkin``)?
  * **latency** — once checked in, how long does one full client round
    (download + local train + upload) take (``round_latency``)?

All times are *virtual seconds*: the runtime advances a virtual clock over
trace-scheduled events, so a planet-scale diurnal day simulates in
milliseconds of wall time.  Traces are pure, deterministic functions of
``(seed, client_id, event_index)`` — the runtime hands each client a
monotonically increasing event counter, and resuming from a checkpoint
replays the identical schedule (the counters are part of the checkpointed
state; see :func:`repro_torch.checkpoint.save_async_state`).

Built-ins cover the scenario axes the cookbook needs:

  * :class:`FixedTrace` — constant latency/interval (± optional uniform
    jitter).  With zero jitter this is the degenerate *synchronous* trace
    used by the async-vs-sync equivalence gate.
  * :class:`ParetoTrace` — heavy-tail straggler latency (Pareto tail index
    ``alpha``; smaller = heavier).  The canonical "p99 device is 30x the
    median" production distribution.
  * :class:`DiurnalTrace` — sine-modulated availability over a virtual day:
    clients check in eagerly at peak and rarely in the trough.
  * :class:`TieredTrace` — wraps another trace and scales its latency per
    device tier, tier membership following the engine's round-robin
    striping (``client_id % n_tiers`` — the same convention as
    :class:`repro_torch.federated.engine.CohortSpec`), so latency correlates
    with the :class:`~repro_torch.federated.engine.DeviceProfile` bitwidth
    tiers.

The draws are numpy's ``default_rng`` keyed by ``(seed, client, event,
salt)``, as in the reference, so every schedule equals the reference's
exactly; this module uses no torch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np


def _uniform(seed: int, client_id: int, event_index: int, salt: int) -> float:
    """Deterministic U[0,1) from a counter-based stream (no global state)."""
    rng = np.random.default_rng(
        (int(seed), int(client_id), int(event_index), int(salt))
    )
    return float(rng.random())


@dataclasses.dataclass(frozen=True)
class ClientTrace:
    """Base trace: constant interval/latency, optional symmetric jitter.

    Subclasses override :meth:`round_latency` and/or :meth:`checkin_delay`;
    both receive the client's event counter (monotone per client) and the
    virtual ``now`` so schedules can be counter-deterministic *and*
    time-of-day aware.
    """

    seed: int = 0
    interval: float = 0.0  # idle gap between upload and next check-in
    latency: float = 1.0  # one full download+train+upload round

    def first_checkin(self, client_id: int) -> float:
        """Virtual time of the client's first check-in (default: t=0)."""
        return 0.0

    def checkin_delay(self, client_id: int, event_index: int,
                      now: float) -> float:
        return float(self.interval)

    def round_latency(self, client_id: int, event_index: int,
                      now: float) -> float:
        return float(self.latency)


@dataclasses.dataclass(frozen=True)
class FixedTrace(ClientTrace):
    """Constant latency ± ``jitter`` (fraction, uniform).  ``jitter=0`` is
    the synchronous degenerate trace of the equivalence gate."""

    jitter: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    def round_latency(self, client_id: int, event_index: int,
                      now: float) -> float:
        if self.jitter == 0.0:
            return float(self.latency)
        u = _uniform(self.seed, client_id, event_index, 0x1A7)
        return float(self.latency) * (1.0 + self.jitter * (2.0 * u - 1.0))


@dataclasses.dataclass(frozen=True)
class ParetoTrace(ClientTrace):
    """Heavy-tail straggler latency: ``latency * Pareto(alpha)`` with the
    minimum pinned at ``latency`` (Lomax-shifted).  ``alpha <= 2`` gives the
    infinite-variance tail where sync rounds are makespan-dominated by one
    straggler — the async runtime's motivating regime."""

    alpha: float = 1.5

    def __post_init__(self):
        if self.alpha <= 0:
            raise ValueError(f"alpha must be > 0, got {self.alpha}")

    def round_latency(self, client_id: int, event_index: int,
                      now: float) -> float:
        u = _uniform(self.seed, client_id, event_index, 0x9A3)
        # inverse-CDF Pareto with scale = latency: x = L * (1-u)^(-1/alpha)
        return float(self.latency) * (1.0 - u) ** (-1.0 / self.alpha)


@dataclasses.dataclass(frozen=True)
class DiurnalTrace(ClientTrace):
    """Sine-modulated availability over a virtual day of ``period`` seconds.

    Availability ``a(t) = (1-depth) + depth * (1+sin(2πt/P + φ_c))/2`` swings
    between ``1-depth`` (trough) and 1 (peak); the idle gap before the next
    check-in stretches by ``1/a(t)``.  Each client gets a deterministic
    phase offset ``φ_c`` (timezone spread) so the population's check-ins
    roll around the clock instead of thundering in herd.
    """

    period: float = 24.0
    depth: float = 0.8
    phase_spread: float = 1.0  # fraction of 2π spread across clients

    def __post_init__(self):
        if not 0.0 <= self.depth < 1.0:
            raise ValueError(f"depth must be in [0, 1), got {self.depth}")
        if self.period <= 0:
            raise ValueError(f"period must be > 0, got {self.period}")

    def _availability(self, client_id: int, t: float) -> float:
        phase = 2.0 * math.pi * self.phase_spread * _uniform(
            self.seed, client_id, 0, 0xD1A
        )
        s = 0.5 * (1.0 + math.sin(2.0 * math.pi * t / self.period + phase))
        return (1.0 - self.depth) + self.depth * s

    def first_checkin(self, client_id: int) -> float:
        # stagger starts across the first day so the trough is populated too
        return self.period * _uniform(self.seed, client_id, 0, 0xF1)

    def checkin_delay(self, client_id: int, event_index: int,
                      now: float) -> float:
        base = max(float(self.interval), 1e-3 * self.period)
        return base / self._availability(client_id, now)

    def round_latency(self, client_id: int, event_index: int,
                      now: float) -> float:
        return float(self.latency)


@dataclasses.dataclass(frozen=True)
class TieredTrace(ClientTrace):
    """Latency correlated with device tier (DeviceProfile bitwidths).

    Wraps a ``base`` trace and multiplies its latency by the client tier's
    factor; tier membership is ``client_id % n_tiers`` — the identical
    round-robin striping :class:`repro_torch.federated.engine.CohortSpec` uses, so
    a mixed-bitwidth cohort's slow tier is the *same clients* in both the
    compute model and the transport schedule.  ``multipliers`` defaults from
    the profiles' formats via :func:`tier_multipliers` (coarser format =
    older device = slower).
    """

    base: Optional[ClientTrace] = None  # default: FixedTrace from own fields
    profiles: Tuple = ()  # DeviceProfile per tier (engine.PROFILES values)
    multipliers: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.base is None:
            # no explicit base: the inherited seed/interval/latency fields
            # seed a FixedTrace, so TieredTrace(latency=5.0, ...) behaves
            # as documented on ClientTrace
            object.__setattr__(
                self, "base",
                FixedTrace(seed=self.seed, interval=self.interval,
                           latency=self.latency),
            )
        elif (self.seed, self.interval, self.latency) != (0, 0.0, 1.0):
            raise ValueError(
                "pass timing via the base trace, not TieredTrace's own "
                "seed/interval/latency fields (they would be ignored)"
            )
        if not self.profiles and self.multipliers is None:
            raise ValueError("TieredTrace needs profiles or multipliers")
        if self.multipliers is None:
            object.__setattr__(
                self, "multipliers", tier_multipliers(self.profiles)
            )
        if self.profiles and len(self.multipliers) != len(self.profiles):
            raise ValueError("one multiplier per profile")

    @property
    def n_tiers(self) -> int:
        return len(self.multipliers)

    def tier_of(self, client_id: int) -> int:
        return int(client_id) % self.n_tiers

    def first_checkin(self, client_id: int) -> float:
        return self.base.first_checkin(client_id)

    def checkin_delay(self, client_id: int, event_index: int,
                      now: float) -> float:
        return self.base.checkin_delay(client_id, event_index, now)

    def round_latency(self, client_id: int, event_index: int,
                      now: float) -> float:
        m = self.multipliers[self.tier_of(client_id)]
        return m * self.base.round_latency(client_id, event_index, now)


def tier_multipliers(profiles: Sequence) -> Tuple[float, ...]:
    """Default tier latency factors from DeviceProfile formats.

    An f32 tier (no transport compression) models the newest hardware at
    1.0x; compressed tiers scale with how much narrower their format is —
    an 8-bit S1E4M3 device runs ~2x slower than flagship, the 11-bit
    S1E3M7 mid-tier ~1.7x.  Purely a simulation default; pass explicit
    ``multipliers`` to calibrate against fleet measurements.
    """
    from repro_torch.core.formats import FloatFormat

    out = []
    for p in profiles:
        fmt = FloatFormat.parse(p.fmt) if p.fmt is not None else None
        if fmt is None or fmt.is_identity:
            out.append(1.0)
        else:
            out.append(1.0 + (32 - fmt.bits) / 24.0)
    return tuple(out)
