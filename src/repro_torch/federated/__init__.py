"""Federated runtime over compressed state (port of ``repro.federated``):
OMC materialization, the round, cohorts, wire accounting, and the paper's
loop in four execution paths (DESIGN.md §9/§10):

  * :mod:`.simulate` — the per-client reference loop (numerics ground truth),
  * :mod:`.engine` — the heterogeneous-cohort engine (the reference's
    vmap/scan over stacked client states; the port runs the clients one
    after another and aggregates the stack),
  * :mod:`.async_engine` — the event-driven non-barrier runtime (virtual
    clock, :mod:`.traces` availability/latency models, buffered
    staleness-weighted aggregation; straggler-dominated fleets),
  * :mod:`.round` — the federated round over the server's training state.
"""

from .materialize import OMCMaterializer, QParam, make_sinks, pack_qparams
from .state import TrainState, init_state, state_bytes_report
from .round import make_round_fn, make_eval_fn
from .cohort import CohortPlan, sample_cohort, survival_mask
from .accounting import WireTable, build_wire_table
from .cohort import validate_report_goal
from .engine import (
    CohortSpec,
    DeviceProfile,
    PROFILES,
    run_round_vectorized,
    run_training_vectorized,
    sample_tiered_cohort,
)
from .async_engine import (
    AsyncConfig,
    AsyncRunner,
    buffer_weights,
    flush_weights,
    run_async_training,
    staleness_weights,
)
from .traces import (
    ClientTrace,
    DiurnalTrace,
    FixedTrace,
    ParetoTrace,
    TieredTrace,
)
