"""Sharded population runtime (port of ``repro.scale``, DESIGN.md §14).

Layers (each usable alone):

  * :mod:`.store`: :class:`ShardLayout` and :class:`PopulationStore`, the
    per-client server state (EF residuals, counters) sharded by client-id
    blocks and kept on the host, packed at rest when asked;
  * :mod:`.stream`: the fixed-capacity partial-aggregate function (peak
    memory bounded by ``capacity``, not by the cohort);
  * :mod:`.hierarchy`: two-level tree aggregation (per-shard partials, one
    root combine), held to the flat engine;
  * :mod:`.serve_driver`: hot-swap under sustained query traffic.

Entry points run on the card unless ``device="cpu"`` is passed.
"""

from .hierarchy import make_root_fn, run_round_sharded, run_training_sharded, tree_aggregate
from .serve_driver import run_serve_under_swap, synthetic_token_batch
from .store import ArrayCounters, PopulationStore, ShardLayout
from .stream import iter_chunks, make_stream_fn, pad_chunk

__all__ = [
    "ArrayCounters",
    "PopulationStore",
    "ShardLayout",
    "iter_chunks",
    "make_root_fn",
    "make_stream_fn",
    "pad_chunk",
    "run_round_sharded",
    "run_serve_under_swap",
    "run_training_sharded",
    "synthetic_token_batch",
    "tree_aggregate",
]
