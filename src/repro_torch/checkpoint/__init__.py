"""Atomic checkpoints of federated server state (port of ``repro.checkpoint``).

Sync state goes through :func:`save_state` / :func:`restore_state` and the
async runtime's mid-buffer snapshot (server storage, buffer, version-stamped
pending tickets, trace counters, ledger) through :func:`save_async_state` /
:func:`restore_async_state` (DESIGN.md §10), and the sharded population's (a
``scale.PopulationStore``'s counters and EF rows, f32 or packed) through
:func:`save_population_state` / :func:`restore_population_state`, in the
reference's layout: each package restores the other's.
"""

from .ckpt import (
    gc_checkpoints,
    latest_checkpoint,
    restore_async_state,
    restore_population_state,
    restore_state,
    save_async_state,
    save_population_state,
    save_state,
)

__all__ = [
    "save_state", "restore_state", "latest_checkpoint", "gc_checkpoints",
    "save_async_state", "restore_async_state",
    "save_population_state", "restore_population_state",
]
