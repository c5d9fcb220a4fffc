"""Sharded population state, compressed at rest (port of ``repro.scale.store``,
DESIGN.md §14).

Everything the server holds *per client* (error-feedback residuals,
round counters, trace event counters) lives here as one
:class:`PopulationStore`, partitioned into contiguous client-id shards by a
:class:`ShardLayout`.  The layout is *logical*: it says which shard owns
which client rows, whatever the devices.  On one card it drives the
host-side shard grouping of :mod:`repro_torch.scale.hierarchy`;
:meth:`PopulationStore.device_ef` places the rows on a population mesh,
beside the layout ``launch.specs.population_sharding`` gives them.

State at rest lives on the host, as numpy arrays, as in the reference:
counters as int64, residual rows either f32 (``ef_fmt=None``, bit-exact
with the engines' dense EF state) or packed as OMC minifloat bitstreams
(``core.packing`` words, one PVT ``(s, b)`` pair per client row), so a
large population's residuals shrink by about bits/32.  Rows are decoded
onto the store's ``device`` when a chunk gathers them and re-encoded when it
scatters them back, so they exist decoded only for the chunk in flight.  On
the card the packed codec is the port's kernels: one ``quantize_stats``
launch encodes a chunk's ``[C, n]`` rows (codes and per-row PVT sums, solved
in closed form), one ``pack`` launch a row writes its words (each row pads
to ``packed_words(n, bits)``, so rows cannot share a stream), one
``unpack`` a row and one ``dequantize`` with the per-row ``(s, b)`` decode
them.  Bit math stays in int64 and bit offsets 64-bit (ROADMAP C2, C6).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.formats import FloatFormat
from repro_torch.core.omc import OMCConfig
from repro_torch.core.pvt import pvt_from_sums
from repro_torch.kernels import ops as kernel_ops


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Contiguous balanced partition of ``num_clients`` into ``num_shards``.

    Shard ``i`` owns the id block ``[starts[i], starts[i+1])``; the first
    ``num_clients % num_shards`` shards are one client larger.  Contiguous
    blocks keep every per-shard gather a slice and make the layout
    describable by two integers, which the checkpoint stamp records and
    refuses to silently reshape across.
    """

    num_clients: int
    num_shards: int

    def __post_init__(self):
        if not 1 <= self.num_shards <= self.num_clients:
            raise ValueError(f"num_shards must satisfy 1 <= num_shards <= {self.num_clients}, "
                             f"got {self.num_shards}")

    @property
    def shard_sizes(self) -> Tuple[int, ...]:
        base, rem = divmod(self.num_clients, self.num_shards)
        return tuple(base + (1 if i < rem else 0) for i in range(self.num_shards))

    @property
    def starts(self) -> np.ndarray:
        """int64[num_shards + 1]: shard i owns [starts[i], starts[i+1])."""
        return np.concatenate([[0], np.cumsum(self.shard_sizes)]).astype(np.int64)

    def shard_of(self, client_ids) -> np.ndarray:
        """int64[...]: owning shard per client id (vectorized)."""
        ids = np.asarray(client_ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_clients):
            raise ValueError(f"client ids must be in [0, {self.num_clients}), got range "
                             f"[{ids.min()}, {ids.max()}]")
        return np.searchsorted(self.starts, ids, side="right") - 1

    def clients_of(self, shard: int) -> np.ndarray:
        s = self.starts
        return np.arange(s[shard], s[shard + 1], dtype=np.int64)

    def describe(self) -> Dict[str, int]:
        """The checkpoint-stamped identity of this layout."""
        return dict(num_clients=int(self.num_clients), num_shards=int(self.num_shards))


@dataclasses.dataclass
class _EFVar:
    """One selected variable's population residuals, f32 or packed at rest."""

    name: str
    shape: Tuple[int, ...]  # per-client row shape
    raw: Optional[np.ndarray] = None  # f32 [N, *shape] (exact mode)
    words: Optional[np.ndarray] = None  # uint32 [N, n_words] (packed mode)
    s: Optional[np.ndarray] = None  # f32 [N] per-row PVT scale
    b: Optional[np.ndarray] = None  # f32 [N] per-row PVT bias

    @property
    def n(self) -> int:
        return math.prod(self.shape)

    def at_rest_bytes(self) -> int:
        if self.raw is not None:
            return int(self.raw.nbytes)
        return int(self.words.nbytes + self.s.nbytes + self.b.nbytes)


def encode_rows(rows: torch.Tensor, fmt: FloatFormat):
    """Packed form of ``rows[C, ...]`` on their device:
    ``(words uint32[C, packed_words(n, bits)], s f32[C], b f32[C])`` with
    one PVT pair per row over its ``n`` values (the reference's
    ``pvt_solve_fast`` with one batch axis, in closed form)."""
    c = rows.shape[0]
    flat = rows.reshape(c, -1).to(torch.float32).contiguous()
    codes, sums = kernel_ops.quantize_stats(flat, fmt, 1)
    s, b = pvt_from_sums(sums, flat.shape[1])
    words = torch.empty((c, packing.packed_words(flat.shape[1], fmt.bits)), dtype=torch.uint32,
                        device=rows.device)
    for i in range(c):  # one stream a row, each padded to whole words
        words[i].copy_(packing.pack(codes[i], fmt.bits))
    return words, s, b


def decode_rows(words: torch.Tensor, s: torch.Tensor, b: torch.Tensor, fmt: FloatFormat,
                shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`encode_rows`: f32 ``[C, *shape]`` on the words' device."""
    c, n = words.shape[0], math.prod(shape)
    codes = torch.empty((c, n), dtype=fmt.container_dtype, device=words.device)
    for i in range(c):
        codes[i].copy_(packing.unpack(words[i], fmt.bits, n, fmt.container_dtype))
    vals = kernel_ops.dequantize(codes, fmt, s.reshape(c, 1), b.reshape(c, 1))
    return vals.reshape((c,) + tuple(shape))


class PopulationStore:
    """All server-held per-client state for one simulated population.

    Counters are dense host arrays (8 B + 8 B per client); residual state is
    optional and attached by :meth:`init_ef`.  The row API
    (:meth:`gather_ef` / :meth:`scatter_ef`) is what the streamed round
    consumes: gathers decode on the way out onto ``device`` (default the
    card), scatters re-encode on the way in, so rows exist decoded only for
    the chunk in flight (bounded by the stream capacity, never by the
    population).
    """

    def __init__(self, layout: ShardLayout, device="cuda"):
        self.layout = layout
        self.device = torch.device(device)
        n = layout.num_clients
        # rounds started / trace events per client: the async runtime's dict
        # counters, as arrays (ArrayCounters adapts them back)
        self.round_counters = np.zeros((n,), np.int64)
        self.event_counters = np.zeros((n,), np.int64)
        self.ef_fmt: Optional[FloatFormat] = None
        self._ef: Dict[str, _EFVar] = {}

    # -- counters -----------------------------------------------------------

    def round_view(self) -> "ArrayCounters":
        return ArrayCounters(self.round_counters)

    def event_view(self) -> "ArrayCounters":
        return ArrayCounters(self.event_counters)

    def note_round(self, client_ids, alive=None) -> None:
        """Sync-path trace accounting: invited clients start a round;
        survivors (``alive`` mask) complete an upload event."""
        ids = np.asarray(client_ids, np.int64)
        self.round_counters[ids] += 1
        if alive is not None:
            self.event_counters[ids[np.asarray(alive, bool)]] += 1

    # -- error-feedback rows ------------------------------------------------

    @property
    def has_ef(self) -> bool:
        return bool(self._ef)

    @property
    def ef_names(self) -> List[str]:
        return list(self._ef)

    def init_ef(self, params_f32, specs, omc: OMCConfig,
                ef_fmt: Optional[FloatFormat] = None) -> None:
        """Allocate zeroed residuals for every policy-selected variable.

        The same ``accounting.walk_selected`` order (and so the same keys)
        as ``compress.feedback.init_ef_state``: a store-backed run and a
        dense-EF run index the same state.  ``ef_fmt=None`` keeps rows f32;
        a format packs them at rest (zero encodes to zero codes with
        ``s=1, b=0``, so a fresh store is exact either way).  Only the
        leaves' shapes are read (meta tensors will do).
        """
        from repro_torch.federated import accounting

        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to the "
                               "PopulationStore to keep its rows on the CPU")
        if isinstance(ef_fmt, str):
            ef_fmt = FloatFormat.parse(ef_fmt)
        self.ef_fmt = ef_fmt
        sel, _ = accounting.walk_selected(params_f32, specs, omc)
        n = self.layout.num_clients
        self._ef = {}
        for name, _, leaf in sel:
            var = _EFVar(name, tuple(leaf.shape))
            if ef_fmt is None:
                var.raw = np.zeros((n,) + var.shape, np.float32)
            else:
                var.words = np.zeros((n, packing.packed_words(var.n, ef_fmt.bits)), np.uint32)
                var.s = np.ones((n,), np.float32)
                var.b = np.zeros((n,), np.float32)
            self._ef[name] = var

    def gather_ef(self, client_ids) -> Dict[str, torch.Tensor]:
        """Decoded residual rows ``{name: f32[C, *shape]}`` of a chunk, on the
        store's device."""
        return self._gather(client_ids, self.device)

    def _gather(self, client_ids, device: torch.device) -> Dict[str, torch.Tensor]:
        ids = np.asarray(client_ids, np.int64)
        out = {}
        for name, var in self._ef.items():
            if var.raw is not None:
                # each row copied from its place at rest, no host-side gather
                rows = torch.empty((ids.size,) + var.shape, dtype=torch.float32, device=device)
                for j, i in enumerate(ids.tolist()):
                    rows[j].copy_(torch.from_numpy(var.raw[i]))
                out[name] = rows
            else:
                out[name] = decode_rows(*(torch.from_numpy(a[ids]).to(device)
                                          for a in (var.words, var.s, var.b)),
                                        self.ef_fmt, var.shape)
        return out

    def scatter_ef(self, client_ids, rows: Dict[str, torch.Tensor], mask=None) -> None:
        """Write updated rows back (re-encoding them in packed mode).

        ``mask`` (bool[C]) keeps un-masked clients' previous residuals: the
        alive-masked scatter the engines apply (a dead client never
        uploaded, so its residual must not move).
        """
        ids = np.asarray(client_ids, np.int64)
        keep = np.ones(ids.shape, bool) if mask is None else np.asarray(mask, bool)
        ids = ids[keep]
        if ids.size == 0:
            return
        for name, var in self._ef.items():
            new = rows[name]
            if not keep.all():
                new = new[torch.from_numpy(np.flatnonzero(keep)).to(new.device)]
            if var.raw is not None:
                for j, i in enumerate(ids.tolist()):  # into its place at rest
                    torch.from_numpy(var.raw[i]).copy_(new[j].detach())
            else:
                words, s, b = encode_rows(new.detach(), self.ef_fmt)
                var.words[ids] = words.cpu().numpy()
                var.s[ids] = s.cpu().numpy()
                var.b[ids] = b.cpu().numpy()

    def device_ef(self, mesh, client_ids=None) -> Dict[str, Any]:
        """Residual rows placed on a population mesh (all clients by
        default): gathered onto the mesh's first device (a packed store
        decodes them there, ``unpack`` + ``dequantize``), each beside its
        ``launch.specs.population_sharding`` (``clients`` axis partitioned;
        one card replicates) as a ``launch.specs.Sharded``."""
        from repro_torch.launch import specs as launch_specs

        ids = np.arange(self.layout.num_clients) if client_ids is None else client_ids
        rows = self._gather(ids, mesh.devices.flat[0])
        return {k: launch_specs.Sharded(v, launch_specs.population_sharding(mesh, v.ndim))
                for k, v in rows.items()}

    # -- accounting / checkpointing -----------------------------------------

    def bytes_report(self) -> Dict[str, Any]:
        """Host bytes at rest against the f32-dense baseline the engines hold."""
        counter_bytes = int(self.round_counters.nbytes + self.event_counters.nbytes)
        ef_rest = sum(v.at_rest_bytes() for v in self._ef.values())
        ef_fp32 = sum(4 * self.layout.num_clients * v.n for v in self._ef.values())
        return dict(
            num_clients=self.layout.num_clients,
            num_shards=self.layout.num_shards,
            counter_bytes=counter_bytes,
            ef_at_rest_bytes=int(ef_rest),
            ef_fp32_bytes=int(ef_fp32),
            ef_fmt=self.ef_fmt.name if self.ef_fmt is not None else None,
            total_bytes=int(counter_bytes + ef_rest),
            fp32_equivalent_bytes=int(counter_bytes + ef_fp32),
        )

    def describe_ef(self) -> Optional[Dict[str, Any]]:
        if not self._ef:
            return None
        return dict(fmt=self.ef_fmt.name if self.ef_fmt is not None else None,
                    vars={name: list(v.shape) for name, v in self._ef.items()})

    def state_tree(self) -> Dict[str, Any]:
        """Array state for ``checkpoint.save_population_state``."""
        ef: Dict[str, Any] = {}
        for name, var in self._ef.items():
            if var.raw is not None:
                ef[name] = dict(raw=var.raw)
            else:
                ef[name] = dict(words=var.words, s=var.s, b=var.b)
        return dict(round_counters=self.round_counters, event_counters=self.event_counters,
                    ef=ef)

    def load_state_tree(self, tree: Dict[str, Any]) -> None:
        """Inverse of :meth:`state_tree` (layout already validated)."""
        self.round_counters = np.asarray(tree["round_counters"], np.int64)
        self.event_counters = np.asarray(tree["event_counters"], np.int64)
        for name, var in self._ef.items():
            entry = tree["ef"][name]
            if var.raw is not None:
                var.raw = np.asarray(entry["raw"], np.float32)
            else:
                var.words = np.asarray(entry["words"], np.uint32)
                var.s = np.asarray(entry["s"], np.float32)
                var.b = np.asarray(entry["b"], np.float32)


class ArrayCounters:
    """Mutable-mapping view over a dense per-client counter array.

    The async runtime (``federated.async_engine.AsyncRunner``) keeps
    ``{client_id: int}`` counter dicts; at a million clients two dicts of
    boxed ints cost about 100 MB and serialize as megabytes of JSON.  This
    adapter exposes a :class:`PopulationStore` counter array through the
    same mapping surface (``c[cid]``, ``c[cid] = v``, ``.items()``), so the
    runner's event loop is unchanged while the state lives in one numpy
    array and checkpoints as such.
    """

    def __init__(self, arr: np.ndarray):
        self.arr = arr

    def __getitem__(self, cid) -> int:
        return int(self.arr[cid])

    def __setitem__(self, cid, value) -> None:
        self.arr[cid] = int(value)

    def __contains__(self, cid) -> bool:
        return 0 <= int(cid) < len(self.arr)

    def __len__(self) -> int:
        return len(self.arr)

    def __iter__(self):
        return iter(range(len(self.arr)))

    def get(self, cid, default=0) -> int:
        return self[cid] if cid in self else default

    def items(self):
        for c in range(len(self.arr)):
            yield c, int(self.arr[c])
