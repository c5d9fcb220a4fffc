"""Wire-byte accounting shared by the loop, the engine and the async runtime
(port of ``repro.federated.accounting``).

A :class:`WireTable` is built once per model from the f32 parameter tree:
one row per policy-selected variable, in the order ``ppq_mask`` indexes
them.  Per-round bytes then follow from the PPQ masks alone:

  * download — the server's compressed state (every selected variable
    packed under the server format plus 8 B of (s, b) per stacked entry,
    everything else f32);
  * upload — a client's transport payload: selected variables whose PPQ bit
    is set travel packed under the client's format, the rest f32.

The masks equal the reference's bit for bit (``core.prng``), so the ledgers
equal its ledgers byte for byte.  :class:`AsyncWireStats` is the async
runtime's event-granular ledger.  Under a compression strategy
(``repro_torch.compress``, DESIGN.md §12) the per-variable sizes come from
the strategy's ``plan_wire_bytes``; a strategy whose size depends on the
data (``pipeline``) raises ``ValueError``.  :class:`StreamLedger` states the
resident-bytes bound of the streamed round of ``repro_torch.scale``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import packing
from repro_torch.core.omc import OMCConfig
from repro_torch.core.partial import ppq_mask, ppq_masks_batch
from repro_torch.core.policy import path_str
from repro_torch.core.tree import tree_items

from .state import n_stack_axes, selected

_PVT_BYTES_PER_ENTRY = 8  # s and b, f32 each — matches the codec and store


@dataclasses.dataclass(frozen=True)
class WireTable:
    """Per-selected-variable wire sizes, in PPQ mask-index order."""

    names: Tuple[str, ...]  # selected variable paths
    n_elems: Tuple[int, ...]  # element count per variable
    stack_entries: Tuple[int, ...]  # PVT (s, b) entries (stacked-axis product)
    raw_bytes: int  # non-selected leaves: f32 wire bytes

    @property
    def num_vars(self) -> int:
        return len(self.names)

    @property
    def fp32_total(self) -> int:
        """Wire bytes of the whole model sent uncompressed."""
        return self.raw_bytes + 4 * sum(self.n_elems)

    def _packed(self, omc: OMCConfig) -> np.ndarray:
        """int64[V]: per-variable bytes when packed under ``omc.fmt``."""
        sb = np.asarray(self.stack_entries if omc.pvt else (1,) * self.num_vars, np.int64)
        packed = np.asarray([packing.packed_bytes(n, omc.fmt) for n in self.n_elems], np.int64)
        return packed + _PVT_BYTES_PER_ENTRY * sb

    def _fp32_vars(self) -> np.ndarray:
        return 4 * np.asarray(self.n_elems, np.int64)

    def download_bytes(self, omc: OMCConfig) -> int:
        """One client's full download: the server's compressed-at-rest state."""
        if not omc.enabled:
            return self.fp32_total
        return int(self._packed(omc).sum()) + self.raw_bytes

    def upload_bytes(self, mask, omc: OMCConfig) -> int:
        """One client's transport-compressed upload under its PPQ ``mask``."""
        if not omc.enabled:
            return self.fp32_total
        m = np.asarray(mask, bool)
        if m.shape != (self.num_vars,):
            raise ValueError(f"mask has shape {m.shape}, expected ({self.num_vars},)")
        return int(np.where(m, self._packed(omc), self._fp32_vars()).sum()) + self.raw_bytes

    # -- strategy budgets (DESIGN.md §11) -------------------------------------

    def strategy_var_bytes(self, strategy) -> np.ndarray:
        """int64[V]: per-variable wire bytes under a zoo strategy, from its
        ``plan_wire_bytes``; raises for a data-dependent strategy (measure an
        encoded tree with ``repro_torch.compress.tree_wire_bytes``)."""
        rows = [strategy.plan_wire_bytes(n, sb)
                for n, sb in zip(self.n_elems, self.stack_entries)]
        if any(r is None for r in rows):
            raise ValueError(f"strategy {strategy.name!r} has data-dependent wire bytes; "
                             f"measure an encoded tree with repro_torch.compress.tree_wire_bytes")
        return np.asarray(rows, np.int64)

    def download_bytes_strategy(self, strategy) -> int:
        """The full model's download with every selected variable under
        ``strategy`` (``download_bytes(omc)`` for the OMC strategy)."""
        return int(self.strategy_var_bytes(strategy).sum()) + self.raw_bytes

    def upload_bytes_strategy(self, strategy, mask=None) -> int:
        """Upload bytes under ``strategy``; with a PPQ ``mask`` the unmasked
        variables travel f32."""
        sizes = self.strategy_var_bytes(strategy)
        if mask is not None:
            m = np.asarray(mask, bool)
            if m.shape != (self.num_vars,):
                raise ValueError(f"mask has shape {m.shape}, expected ({self.num_vars},)")
            sizes = np.where(m, sizes, self._fp32_vars())
        return int(sizes.sum()) + self.raw_bytes


def walk_selected(params_f32, specs, omc: OMCConfig):
    """``([(name, spec, leaf)] of the selected variables, raw f32 bytes of the
    rest)``.  The list order is the ``ppq_mask`` index order, for the loop's
    ``client_view``, the engine's ``masked_upload_tree`` and the ledger."""
    spec_of = dict(tree_items(specs))
    sel, raw = [], 0
    for path, leaf in tree_items(params_f32):
        name = path_str(path)
        if selected(omc, name, spec_of[path], leaf):
            sel.append((name, spec_of[path], leaf))
        elif hasattr(leaf, "numel"):
            raw += 4 * leaf.numel()
    return sel, raw


def selected_names(params_f32, specs, omc: OMCConfig):
    """Selected variable paths in PPQ mask-index order."""
    return [name for name, _, _ in walk_selected(params_f32, specs, omc)[0]]


def build_wire_table(params_f32, specs, omc: OMCConfig) -> WireTable:
    """One table per model; valid for every round (shapes are static)."""
    sel, raw = walk_selected(params_f32, specs, omc)
    names, n_elems, stacks = [], [], []
    for name, spec, leaf in sel:
        names.append(name)
        n_elems.append(leaf.numel())
        k = n_stack_axes(spec, leaf)
        stacks.append(math.prod(leaf.shape[:k]) if k else 1)
    return WireTable(tuple(names), tuple(n_elems), tuple(stacks), raw)


def client_upload_bytes(table: WireTable, omc: OMCConfig, round_index: int,
                        client_id: int) -> int:
    """Scalar path (the loop): one client's upload bytes."""
    if not omc.enabled or table.num_vars == 0:
        return table.fp32_total
    mask = ppq_mask(omc.ppq_key(), round_index, client_id, table.num_vars,
                    omc.quantize_fraction)
    return table.upload_bytes(mask.numpy(), omc)


def cohort_upload_bytes(table: WireTable, omc: OMCConfig, round_index: int,
                        client_ids: Sequence[int]) -> np.ndarray:
    """Batched path (the engine): int64[C] upload bytes, one per client."""
    c = len(client_ids)
    if not omc.enabled or table.num_vars == 0:
        return np.full((c,), table.fp32_total, np.int64)
    masks = ppq_masks_batch(omc.ppq_key(), round_index, client_ids, table.num_vars,
                            omc.quantize_fraction).numpy()
    per_var = np.where(masks, table._packed(omc)[None, :], table._fp32_vars()[None, :])
    return per_var.sum(axis=1) + table.raw_bytes


def client_upload_bytes_strategy(table: WireTable, omc: OMCConfig, strategy,
                                 round_index: int, client_id: int) -> int:
    """One client's upload bytes when training under a zoo strategy: the
    variables whose PPQ bit is set travel strategy-encoded, the rest f32."""
    if not omc.enabled or table.num_vars == 0:
        return table.fp32_total
    mask = ppq_mask(omc.ppq_key(), round_index, client_id, table.num_vars,
                    omc.quantize_fraction)
    return table.upload_bytes_strategy(strategy, mask.numpy())


def cohort_upload_bytes_strategy(table: WireTable, omc: OMCConfig, strategy,
                                 round_index: int, client_ids: Sequence[int]) -> np.ndarray:
    """Batched (engine) counterpart of :func:`client_upload_bytes_strategy`."""
    c = len(client_ids)
    if not omc.enabled or table.num_vars == 0:
        return np.full((c,), table.fp32_total, np.int64)
    masks = ppq_masks_batch(omc.ppq_key(), round_index, client_ids, table.num_vars,
                            omc.quantize_fraction).numpy()
    sizes = table.strategy_var_bytes(strategy)
    per_var = np.where(masks, sizes[None, :], table._fp32_vars()[None, :])
    return per_var.sum(axis=1) + table.raw_bytes


def download_bytes_train(table: WireTable, omc: OMCConfig, strategy=None) -> int:
    """Per-client download bytes when training under ``strategy``: upload-only
    strategies (top-k, ternary, pipeline) download the dense at-rest state,
    ``download_bytes(omc)``; dense ones re-encode it under their format."""
    if strategy is None or strategy.upload_only:
        return table.download_bytes(omc)
    return table.download_bytes_strategy(strategy)


@dataclasses.dataclass
class AsyncWireStats:
    """Wire-byte ledger for the non-barrier runtime (DESIGN.md §10).

    The async runtime has no rounds: downloads and uploads interleave across
    server versions, so this ledger counts bytes at event granularity and
    splits uploads by staleness.  An upload whose base version is behind the
    server at arrival costs full wire bytes and carries a decayed weight
    (``stale_up_bytes``); one past ``max_staleness`` is waste
    (``dropped_up_bytes``, not in ``up_bytes``).  ``in_flight_bytes`` is the
    volume of started-but-unfinished client rounds (the download issued plus
    the upload it commits to); its peak bounds the transport buffering a
    deployment must provision.  Sizes come from the same :class:`WireTable`
    rows as the sync paths, so the totals equal theirs byte for byte.

    ``strategy`` switches the ledger to training-under-strategy sizes:
    uploads through :func:`client_upload_bytes_strategy` per ``(round,
    client)`` PPQ mask, downloads through :func:`download_bytes_train`.  For
    the OMC strategy that is the plain ledger, byte for byte.
    """

    table: WireTable
    strategy: Optional[Any] = None
    down_bytes: int = 0
    up_bytes: int = 0  # every accepted upload; stale ones are also in stale_up_bytes
    stale_up_bytes: int = 0  # arrived with staleness > 0 (subset of up_bytes)
    dropped_up_bytes: int = 0  # discarded past max_staleness (NOT in up_bytes)
    in_flight_bytes: int = 0
    peak_in_flight_bytes: int = 0
    n_downloads: int = 0
    n_uploads: int = 0
    n_stale: int = 0
    n_dropped: int = 0
    _pending: dict = dataclasses.field(default_factory=dict, repr=False)

    def _up(self, omc: OMCConfig, round_index: int, client_id: int) -> int:
        if self.strategy is not None:
            return client_upload_bytes_strategy(self.table, omc, self.strategy, round_index,
                                                client_id)
        return client_upload_bytes(self.table, omc, round_index, client_id)

    def start_round(self, omc: OMCConfig, round_index: int, client_id: int) -> None:
        """Client checked in: the full download now, the upload committed.
        ``round_index`` is the client's own round counter (it keys the PPQ
        mask), not the server version."""
        down = download_bytes_train(self.table, omc, self.strategy)
        up = self._up(omc, round_index, client_id)
        self.down_bytes += down
        self.n_downloads += 1
        self._pending[client_id] = down + up
        self.in_flight_bytes += down + up
        self.peak_in_flight_bytes = max(self.peak_in_flight_bytes, self.in_flight_bytes)

    def finish_round(self, omc: OMCConfig, round_index: int, client_id: int, staleness: int,
                     dropped: bool = False) -> int:
        """The client's upload arrived; returns its wire bytes."""
        up = self._up(omc, round_index, client_id)
        self.in_flight_bytes -= self._pending.pop(client_id)
        if dropped:
            self.dropped_up_bytes += up
            self.n_dropped += 1
            return up
        self.up_bytes += up
        self.n_uploads += 1
        if staleness > 0:
            self.stale_up_bytes += up
            self.n_stale += 1
        return up

    def snapshot(self) -> dict:
        """The ledger now, with the reference's keys.  ``stale_fraction`` is
        the share of accepted upload bytes that arrived stale,
        ``dropped_fraction`` the share of all finished upload bytes dropped
        past ``max_staleness``; both 0.0 before any upload.  These two and
        ``peak_in_flight_bytes`` are a schema (DESIGN.md §15): renaming them
        breaks readers."""
        finished = self.up_bytes + self.dropped_up_bytes
        return dict(
            down_bytes=int(self.down_bytes),
            up_bytes=int(self.up_bytes),
            stale_up_bytes=int(self.stale_up_bytes),
            dropped_up_bytes=int(self.dropped_up_bytes),
            in_flight_bytes=int(self.in_flight_bytes),
            peak_in_flight_bytes=int(self.peak_in_flight_bytes),
            n_downloads=int(self.n_downloads),
            n_uploads=int(self.n_uploads),
            n_stale=int(self.n_stale),
            n_dropped=int(self.n_dropped),
            stale_fraction=(float(self.stale_up_bytes / self.up_bytes)
                            if self.up_bytes else 0.0),
            dropped_fraction=float(self.dropped_up_bytes / finished) if finished else 0.0,
        )


@dataclasses.dataclass
class StreamLedger:
    """Peak-memory ledger of the fixed-capacity streamed round (DESIGN.md §14).

    The :class:`AsyncWireStats` counterpart for *resident bytes* instead of
    wire bytes: the streamed round's contract is that its peak live model
    state is a function of the stream ``capacity`` alone, never of the
    cohort or population size.  :meth:`peak_bound_bytes` states that bound
    from the same :class:`WireTable` rows every other ledger uses:

      * the compressed-at-rest server storage (``download_bytes``),
      * its transient f32 decode (``fp32_total``),
      * one ``capacity``-wide stack of f32 client models,
      * one f32 partial-sum accumulator tree.

    ``on_chunk`` records the streaming (and optionally a measured device
    bytes sample from the round's instrumentation hook);
    ``benchmarks_torch/population_scale.py`` asserts the bound is the same
    across a 1k to 100k population sweep and the measured peaks flat.
    """

    table: WireTable
    omc: OMCConfig
    capacity: int
    chunks: int = 0
    clients_streamed: int = 0
    peak_measured_bytes: int = 0

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")

    @property
    def chunk_stack_bytes(self) -> int:
        """One fixed-width stack of f32 client models."""
        return self.capacity * self.table.fp32_total

    @property
    def accumulator_bytes(self) -> int:
        """The running f32 partial-sum tree (one model's worth)."""
        return self.table.fp32_total

    def peak_bound_bytes(self) -> int:
        """Peak resident model bytes, determined by the capacity alone."""
        return (self.table.download_bytes(self.omc)  # storage at rest
                + self.table.fp32_total  # transient server decode
                + self.chunk_stack_bytes
                + self.accumulator_bytes)

    def on_chunk(self, n_real: int, measured_bytes: Optional[int] = None) -> None:
        if not 1 <= n_real <= self.capacity:
            raise ValueError(f"chunk holds {n_real} clients, capacity is {self.capacity}")
        self.chunks += 1
        self.clients_streamed += n_real
        if measured_bytes is not None:
            self.peak_measured_bytes = max(self.peak_measured_bytes, int(measured_bytes))

    def snapshot(self) -> dict:
        return dict(
            capacity=int(self.capacity),
            chunks=int(self.chunks),
            clients_streamed=int(self.clients_streamed),
            chunk_stack_bytes=int(self.chunk_stack_bytes),
            accumulator_bytes=int(self.accumulator_bytes),
            peak_bound_bytes=int(self.peak_bound_bytes()),
            peak_measured_bytes=int(self.peak_measured_bytes),
        )
