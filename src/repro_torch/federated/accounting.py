"""Wire-byte accounting shared by the loop and the engine (port of
``repro.federated.accounting``, without the strategy and async ledgers).

A :class:`WireTable` is built once per model from the f32 parameter tree:
one row per policy-selected variable, in the order ``ppq_mask`` indexes
them.  Per-round bytes then follow from the PPQ masks alone:

  * download — the server's compressed state (every selected variable
    packed under the server format plus 8 B of (s, b) per stacked entry,
    everything else f32);
  * upload — a client's transport payload: selected variables whose PPQ bit
    is set travel packed under the client's format, the rest f32.

The masks equal the reference's bit for bit (``core.prng``), so the ledgers
equal its ledgers byte for byte.  ``AsyncWireStats`` and ``StreamLedger``
belong to the async and sharded runtimes, not ported yet (ROADMAP A8, A9).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core import packing
from repro_torch.core.omc import OMCConfig
from repro_torch.core.partial import ppq_mask, ppq_masks_batch
from repro_torch.core.policy import path_str
from repro_torch.core.tree import tree_items

from .state import n_stack_axes, selected

_PVT_BYTES_PER_ENTRY = 8  # s and b, f32 each — matches the codec and store


def _no_strategy(strategy) -> None:
    if strategy is not None:
        raise NotImplementedError("compression strategies are not ported yet (ROADMAP A7)")


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


def download_bytes_train(table: WireTable, omc: OMCConfig, strategy=None) -> int:
    """Per-client download bytes when training (no strategy: the ordinary
    ``download_bytes``)."""
    _no_strategy(strategy)
    return table.download_bytes(omc)
