"""FL and serving sessions over the wire codec (port of ``repro.api.session``).

``FLSession`` is the server side of the paper's training loop at the
client/server boundary: the server state is *compressed at rest*
(``CompressedVariable`` leaves); each round it hands out a wire payload of
that state (full, or a sparse delta against the previous round for clients
that hold it), ingests client uploads (wire payloads, usually delta-encoded
against the download), takes their FedAvg mean and re-compresses.  No f32
master persists between rounds.  ``enable_async`` switches it to the
buffered, version-stamped protocol (FedBuff with staleness weights).
``FLClient`` is the loopback client: decode, train, upload.

``ServeSession`` is the inference side: batched prefill/decode over the
compressed weights via ``make_serve_fns``, with ``hot_swap`` ingesting a new
round's payload between rounds.  The decode state is the family's own: a
``KVCache`` for the dense transformer, a dict for griffin; the session
passes it through unchanged.

Every session runs on one device, ``cuda`` unless the caller passes
``device="cpu"``; without a card the CUDA default raises.  On the card a
round runs ``quantize_stats`` (``compress_params``), ``dequantize``
(``decompress_tree``) and ``pack``/``unpack`` (the codec) as kernels.

``strategy=`` (a ``repro_torch.compress`` strategy or its registry name)
switches the *upload* direction to a zoo compressor (DESIGN.md §12):
clients send strategy-encoded frames, for upload-only strategies their
update with an error-feedback residual where the strategy keeps one, and
the server reconstructs each report (:func:`_reported_model`); downloads
stay the compressed OMC state.  ``obs=`` (a ``repro_torch.obs.Obs``) records
``encode_payload``, ``decode_payload``, ``flush`` and ``hot_swap`` wall
spans with their byte counts; ``obs=None`` records nothing.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import decompress_tree
from repro_torch.core.tree import tree_items, tree_map
from repro_torch.federated import cohort as cohort_lib
from repro_torch.federated.async_engine import flush_weights
from repro_torch.federated.round import make_serve_fns
from repro_torch.federated.simulate import stack_into
from repro_torch.federated.state import compress_params, state_bytes_report
from repro_torch.obs import null_span

from . import codecs


def _resolve_strategy(strategy):
    """A strategy, its registry name, or None."""
    if strategy is None or not isinstance(strategy, str):
        return strategy
    from repro_torch.compress import get_strategy  # the zoo imports this package's codec

    return get_strategy(strategy)


def _reported_model(tree, base_storage, strategy):
    """The server's f32 view of one decoded upload (DESIGN.md §12).

    ``strategy=None``: the OMC path, the report decoded.  Upload-only
    strategies send the client's *update*, so the report is
    ``base + update`` (a sparse frame's zeros off its support never shrink
    the aggregated model); dense strategies send the whole model."""
    from repro_torch.compress import decode_tree

    if strategy is None:
        return decompress_tree(tree)
    decoded = decode_tree(tree)
    if not strategy.upload_only:
        return decoded
    return tree_map(torch.add, decompress_tree(base_storage), decoded)


def _tree_device(tree) -> torch.device:
    for _, leaf in tree_items(tree):
        return leaf.device  # a tensor or a CompressedVariable
    raise ValueError("empty storage tree")


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def session_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``RuntimeError`` for CUDA without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "session on the CPU")
    return device


def _server_step(storage, mean_model, server_lr: float, specs, omc: OMCConfig):
    """``old + lr·(mean − old)`` on the decoded storage, re-compressed."""
    new_f32 = tree_map(lambda old, new: old + server_lr * (new - old),
                       decompress_tree(storage), mean_model)
    return compress_params(new_f32, specs, omc) if omc.enabled else new_f32


@dataclasses.dataclass
class RoundTicket:
    """What the server hands a transport for one round of downloads.

    ``profiles`` maps each invited client to its device-profile name: the
    download is the same server-format model for every tier, and the
    transport uses the profile to anticipate the client's upload format."""

    round_index: int
    client_ids: List[int]
    payload: bytes  # full payload (new / fallen-behind clients)
    delta_payload: Optional[bytes]  # vs the previous round's model, if any
    delta_base_digest: int = 0  # tree_digest the delta applies to (0: none)
    issued_bytes: List[int] = dataclasses.field(default_factory=list)
    issued_delta: int = 0  # how many clients actually took the delta
    profiles: Dict[int, str] = dataclasses.field(default_factory=dict)

    def payload_for(self, *, has_previous_round: bool) -> bytes:
        """Pick the download for one client and record its size (the
        session folds ``issued_bytes`` into traffic at close_round)."""
        if has_previous_round and self.delta_payload is not None:
            blob = self.delta_payload
            self.issued_delta += 1
        else:
            blob = self.payload
        self.issued_bytes.append(len(blob))
        return blob


@dataclasses.dataclass
class AsyncTicket:
    """A version-stamped download handed to one checking-in client.

    The upload that comes back is decoded against the storage of
    ``server_version``, and its staleness is ``current_version -
    server_version``.  ``delta_payload`` (vs the version the client said it
    holds) is taken only when the client's digest matches; the session folds
    the issued bytes into traffic at ingestion."""

    client_id: int
    server_version: int
    payload: bytes  # full state at server_version
    delta_payload: Optional[bytes] = None  # vs the client's held version
    delta_base_digest: int = 0
    issued_bytes: int = 0
    took_delta: bool = False

    def payload_for(self, *, held_digest: int = 0) -> bytes:
        """Pick delta when the client verifiably holds the base, else full."""
        if self.delta_payload is not None and held_digest == self.delta_base_digest:
            blob = self.delta_payload
            self.took_delta = True
        else:
            blob = self.payload
        self.issued_bytes = len(blob)
        return blob


class FLSession:
    """Server-side federated session over compressed wire payloads.

    Lifecycle per round::

        ticket = sess.begin_round()            # cohort ids + download payload
        for cid in ticket.client_ids:          # transport delivers payloads,
            blob = client.run_round(ticket)    # clients train and upload
            sess.ingest(cid, blob)
        metrics = sess.close_round()           # aggregate + re-compress

    ``ingest`` accepts uploads delta-encoded against this round's download or
    full payloads; ``close_round`` takes the FedAvg mean of the reports that
    arrived, in the order they arrived (a partial cohort is fine), and
    applies the server step with learning rate ``server_lr``.  Each report
    is decoded into its row of one ``[cohort, ...]`` stack as it lands, so
    the round holds each reported model once.

    ``init_params`` is an f32 tree of the port's tensors (for instance
    ``interop.params_from_numpy`` of the reference's init); without it the
    family's init is drawn from ``PRNGKey(seed)`` on ``device``.

    ``strategy`` (a strategy or a registry name) switches the uploads to a
    zoo compressor: for upload-only strategies each report carries the
    client's update and ``ingest`` reconstructs ``download + update``;
    downloads stay the compressed-at-rest OMC state either way.
    """

    def __init__(self, family, cfg, omc: OMCConfig, *,
                 plan: Optional[cohort_lib.CohortPlan] = None, server_lr: float = 1.0,
                 seed: int = 0, init_params=None,
                 profile_fn: Optional[Callable[[int], str]] = None, strategy=None, obs=None,
                 device="cuda"):
        self.device = session_device(device)
        self.family = family
        self.cfg = cfg
        self.omc = omc
        self.plan = plan
        self.strategy = _resolve_strategy(strategy)
        self.obs = obs  # None records nothing and changes nothing
        self.profile_fn = profile_fn
        self.server_lr = float(server_lr)
        self.specs = family.param_specs(cfg)
        key = prng.PRNGKey(seed)
        if init_params is None:
            params = family.init(key, cfg, self.device)
        else:
            params = tree_map(lambda x: x.to(self.device), init_params)
        self.storage = compress_params(params, self.specs, omc) if omc.enabled else params
        del params
        self._prev_storage = None  # round r-1 model: delta base for downloads
        self._cohort_key = prng.fold_in(key, 0xC047)
        self.round_index = 0
        self._report_rows: Dict[int, int] = {}  # client id -> its row, in ingest order
        self._report_stack = None  # [cohort, ...] stacks of the decoded reports
        self._ticket: Optional[RoundTicket] = None
        # the f32 baseline depends only on leaf shapes: constant for the session
        self._fp32_bytes = state_bytes_report(self.storage)["fp32_bytes"]
        self.traffic = dict(down_bytes=0, up_bytes=0, down_fp32_bytes=0, up_fp32_bytes=0)

    # -- payload side -------------------------------------------------------

    def server_payload(self, *, delta: bool = False) -> bytes:
        """Wire payload of the current server model (optionally vs round r-1)."""
        base = self._prev_storage if delta else None
        with null_span(self.obs, "encode_payload", delta=delta) as a:
            blob = codecs.encode_payload(self.storage, base=base, round_index=self.round_index)
            a["bytes"] = len(blob)
        return blob

    def begin_round(self) -> RoundTicket:
        """Sample the round's cohort and build its download payload(s)."""
        if self._ticket is not None:
            raise RuntimeError("round already open; call close_round() first")
        if self.plan is not None:
            ids = [int(i) for i in cohort_lib.sample_cohort(self._cohort_key, self.plan,
                                                            self.round_index)]
        else:
            ids = [0]
        full = self.server_payload()
        delta = self.server_payload(delta=True) if self._prev_storage is not None else None
        self._ticket = RoundTicket(
            self.round_index, ids, full, delta,
            delta_base_digest=codecs.header_base_digest(delta) if delta is not None else 0,
            profiles=({cid: self.profile_fn(cid) for cid in ids}
                      if self.profile_fn is not None else {}),
        )
        self._report_rows, self._report_stack = {}, None
        return self._ticket

    def ingest(self, client_id: int, blob: bytes) -> codecs.PayloadInfo:
        """Accept one client upload (delta vs this round's download, or full).
        A client that reports again replaces its report, in its first place."""
        if self._ticket is None:
            raise RuntimeError("no open round; call begin_round() first")
        if client_id not in self._ticket.client_ids:
            raise KeyError(f"client {client_id} is not in this round's cohort")
        with null_span(self.obs, "decode_payload", client=client_id, bytes=len(blob)):
            tree, info = codecs.decode_payload(blob, base=self.storage, device=self.device)
        row = self._report_rows.setdefault(client_id, len(self._report_rows))
        self._report_stack = stack_into(self._report_stack, row,
                                        _reported_model(tree, self.storage, self.strategy),
                                        len(self._ticket.client_ids))
        self.traffic["up_bytes"] += info.total_bytes
        self.traffic["up_fp32_bytes"] += self._fp32_bytes
        return info

    def close_round(self) -> Dict[str, Any]:
        """Aggregate the received reports, apply the server step, re-compress."""
        if self._ticket is None:
            raise RuntimeError("no open round; call begin_round() first")
        if not self._report_rows:
            raise RuntimeError("round closed with zero reports")
        n = len(self._report_rows)
        stacked = tree_map(lambda x: x[:n], self._report_stack)
        self._report_stack = None
        mean_model = cohort_lib.aggregate_weighted(stacked, torch.ones(n, dtype=torch.float32))
        del stacked
        self._prev_storage = self.storage
        self.storage = _server_step(self.storage, mean_model, self.server_lr, self.specs,
                                    self.omc)
        self.traffic["down_bytes"] += sum(self._ticket.issued_bytes)
        self.traffic["down_fp32_bytes"] += self._fp32_bytes * len(self._ticket.issued_bytes)
        metrics = dict(round=self.round_index, reports=n, invited=len(self._ticket.client_ids),
                       **{k: int(v) for k, v in self.traffic.items()})
        self.round_index += 1
        self._ticket = None
        self._report_rows = {}
        return metrics

    # -- async (buffered, version-stamped) side -----------------------------

    def enable_async(self, buffer_goal: int, *, decay: float = 0.0, decay_mode: str = "poly",
                     delta_horizon: int = 4) -> None:
        """Switch the session to the non-barrier protocol.

        ``buffer_goal`` (K): aggregate whenever K uploads accumulate; it
        passes the same gate as the sync report goal.  After this, drive the
        session with :meth:`checkin` / :meth:`ingest_async`; each flush
        applies a staleness-weighted FedBuff step and bumps
        ``server_version``.  ``delta_horizon`` bounds how many past version
        storages are kept as delta bases (versions a pending ticket
        references are always kept)."""
        cohort_lib.validate_report_goal(
            buffer_goal, self.plan.cohort_size if self.plan is not None else buffer_goal,
            what="buffer_goal")
        if self._ticket is not None:
            raise RuntimeError("close the open sync round before enable_async")
        self.async_cfg = dict(buffer_goal=int(buffer_goal), decay=float(decay),
                              decay_mode=decay_mode, delta_horizon=int(delta_horizon))
        self.server_version = 0
        self._full_cache: Optional[Tuple[int, bytes]] = None
        self._version_storages: Dict[int, Any] = {0: self.storage}
        self._async_pending: Dict[int, AsyncTicket] = {}
        self._async_buffer: List[Tuple[int, int]] = []  # (client id, base version)
        self._async_stack = None  # [K, ...] stacks of the buffered models, in arrival order
        self.async_history: List[Dict[str, Any]] = []

    def checkin(self, client_id: int, held_version: Optional[int] = None) -> AsyncTicket:
        """Issue one client a version-stamped download ticket.

        The full payload carries the current state, encoded once per
        version; if the client holds a version still in the delta window, a
        sparse delta against that version's storage rides along."""
        if not hasattr(self, "async_cfg"):
            raise RuntimeError("call enable_async() first")
        if client_id in self._async_pending:
            raise RuntimeError(f"client {client_id} already has an open ticket")
        if self._full_cache is None or self._full_cache[0] != self.server_version:
            self._full_cache = (self.server_version, codecs.encode_payload(
                self.storage, round_index=self.server_version))
        full = self._full_cache[1]
        delta, digest = None, 0
        base = self._version_storages.get(held_version) if held_version is not None else None
        if base is not None:
            delta = codecs.encode_payload(self.storage, base=base,
                                          round_index=self.server_version)
            digest = codecs.header_base_digest(delta)
        ticket = AsyncTicket(client_id, self.server_version, full, delta,
                             delta_base_digest=digest)
        self._async_pending[client_id] = ticket
        return ticket

    def ingest_async(self, client_id: int, blob: bytes) -> codecs.PayloadInfo:
        """Accept one upload against its ticket's version; flush at K.

        The upload is decoded against the storage at the ticket's version
        (kept while the ticket is open), so a stale client's delta decodes
        exactly; its staleness is charged by the flush's decay weights."""
        ticket = self._async_pending.pop(client_id, None)
        if ticket is None:
            raise KeyError(f"client {client_id} has no open ticket")
        base = self._version_storages[ticket.server_version]
        with null_span(self.obs, "decode_payload", client=client_id, bytes=len(blob)):
            tree, info = codecs.decode_payload(blob, base=base, device=self.device)
        self._async_stack = stack_into(self._async_stack, len(self._async_buffer),
                                       _reported_model(tree, base, self.strategy),
                                       self.async_cfg["buffer_goal"])
        self._async_buffer.append((client_id, ticket.server_version))
        self.traffic["up_bytes"] += info.total_bytes
        self.traffic["up_fp32_bytes"] += self._fp32_bytes
        self.traffic["down_bytes"] += ticket.issued_bytes
        self.traffic["down_fp32_bytes"] += self._fp32_bytes
        if len(self._async_buffer) >= self.async_cfg["buffer_goal"]:
            self._flush_async()
        return info

    def _flush_async(self) -> None:
        with null_span(self.obs, "flush", version=self.server_version):
            self._flush_async_inner()

    def _flush_async_inner(self) -> None:
        entries, self._async_buffer = self._async_buffer, []
        stacked, self._async_stack = self._async_stack, None
        staleness = torch.tensor([self.server_version - base for _, base in entries],
                                 dtype=torch.float32)
        w = flush_weights(staleness, self.async_cfg["decay"], self.async_cfg["decay_mode"])
        mean_model = cohort_lib.aggregate_weighted(stacked, w)
        del stacked
        self.storage = _server_step(self.storage, mean_model, self.server_lr, self.specs,
                                    self.omc)
        self.server_version += 1
        self._version_storages[self.server_version] = self.storage
        self._gc_version_storages()
        self.async_history.append(dict(
            version=self.server_version,
            buffer=len(entries),
            staleness_max=int(staleness.max()),
            **{k: int(v) for k, v in self.traffic.items()},
        ))

    def _gc_version_storages(self) -> None:
        keep = {t.server_version for t in self._async_pending.values()}
        keep.add(self.server_version)
        horizon = self.server_version - self.async_cfg["delta_horizon"]
        for v in [v for v in self._version_storages if v not in keep and v < horizon]:
            del self._version_storages[v]


class FLClient:
    """Loopback client: decode the download, train, upload a delta payload.

    ``train_fn(params_f32, client_id, round_index) -> params_f32`` is the
    local optimization.  The client caches the last model it decoded and
    takes the delta download only when the delta's base digest matches that
    cache (a client that skipped a round holds a stale model and takes the
    full payload, never a wrong-base decode).  Downloads decode onto
    ``device``.  The upload is re-compressed under the session policy and
    delta-encoded against the received model, so unchanged codes cost
    about 0 wire bytes.

    With a ``strategy`` (the session's) the upload is strategy-encoded
    instead: dense strategies send the whole trained model, upload-only
    ones the update ``trained - received``, with an error-feedback residual
    carried across this client's rounds where the strategy keeps one.  The
    residual is exactly ``compensated - decode(encode(compensated))``, so
    client and server never disagree on what was dropped, and it lives on
    the client's device.  ``obs`` times the download's decode and the
    upload's encode.
    """

    def __init__(self, client_id: int, family, cfg, omc: OMCConfig,
                 train_fn: Callable[[Any, int, int], Any], strategy=None, *, device="cuda",
                 obs=None):
        self.device = session_device(device)
        self.client_id = client_id
        self.specs = family.param_specs(cfg)
        self.omc = omc
        self.train_fn = train_fn
        self.strategy = _resolve_strategy(strategy)
        self.obs = obs
        self._cache = None  # last decoded download tree (this client's model)
        self._cache_digest = 0
        self._residual = None  # error-feedback accumulator (EF strategies)

    def run_round(self, ticket: RoundTicket) -> bytes:
        use_delta = (ticket.delta_payload is not None and self._cache is not None
                     and ticket.delta_base_digest == self._cache_digest)
        blob = ticket.payload_for(has_previous_round=use_delta)
        with null_span(self.obs, "decode_payload", client=self.client_id, bytes=len(blob)):
            tree, _ = codecs.decode_payload(blob, base=self._cache if use_delta else None,
                                            device=self.device)
        self._cache = tree
        self._cache_digest = codecs.tree_digest(tree)
        params = decompress_tree(tree)
        trained = self.train_fn(params, self.client_id, ticket.round_index)
        with null_span(self.obs, "encode_payload", client=self.client_id) as a:
            if self.strategy is not None:
                up = self._strategy_upload(params, trained, ticket.round_index)
            else:
                upload_tree = compress_params(trained, self.specs, self.omc) \
                    if self.omc.enabled else trained
                up = codecs.encode_payload(upload_tree, base=tree,
                                           round_index=ticket.round_index)
            a["bytes"] = len(up)
        return up

    def _strategy_upload(self, received, trained, round_index: int) -> bytes:
        from repro_torch.compress import decode_tree, encode_tree

        with torch.no_grad():
            if not self.strategy.upload_only:
                upload_tree = encode_tree(self.strategy, trained, self.omc, self.specs)
                return codecs.encode_payload(upload_tree, round_index=round_index)
            comp = tree_map(torch.sub, trained, received)
            if self.strategy.error_feedback:
                if self._residual is None:
                    self._residual = tree_map(torch.zeros_like, comp)
                comp = tree_map(torch.add, comp, self._residual)
            upload_tree = encode_tree(self.strategy, comp, self.omc, self.specs)
            if self.strategy.error_feedback:
                self._residual = tree_map(torch.sub, comp, decode_tree(upload_tree))
            return codecs.encode_payload(upload_tree, round_index=round_index)


class ServeSession:
    """Batched decode over compressed weights with payload hot-swap.

    The session runs on the device its storage tree lives on; payloads are
    decoded onto that device.  ``compute_dtype`` is float32 only (the
    reference's default); ``obs`` times each ``hot_swap``.
    """

    def __init__(self, family, cfg, storage, compute_dtype=torch.float32, obs=None):
        if compute_dtype != torch.float32:
            raise ValueError(f"compute_dtype {compute_dtype} is not supported: the port serves "
                             f"in torch.float32 only")
        self.family = family
        self.cfg = cfg
        self.storage = storage
        self.obs = obs
        self.device = _tree_device(storage)
        self._prefill, self._decode = make_serve_fns(family, cfg)
        self.swaps = 0
        self.queries = 0
        self.swap_ms: List[float] = []  # per-swap wall ms: decode payload + new storage ready

    @classmethod
    def from_payload(cls, family, cfg, payload: bytes, *, device="cuda",
                     **kw) -> "ServeSession":
        """A session serving the model a full payload carries, on ``device``."""
        storage, _ = codecs.decode_payload(payload, device=session_device(device))
        return cls(family, cfg, storage, **kw)

    def hot_swap(self, payload: bytes) -> codecs.PayloadInfo:
        """Ingest a new round's model; delta payloads apply against the
        currently served tree (digest-verified).  Wall time lands in
        ``swap_ms``."""
        t0 = time.perf_counter()
        with null_span(self.obs, "hot_swap", swap=int(self.swaps), bytes=len(payload)):
            self.storage, info = codecs.decode_payload(payload, base=self.storage,
                                                       device=self.device)
            sync(self.device)
        self.swaps += 1
        self.swap_ms.append((time.perf_counter() - t0) * 1e3)
        return info

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype = torch.float32):
        """The family's empty decode state on the session's device."""
        return self.family.init_decode_state(self.cfg, batch, max_len, dtype=dtype,
                                             device=self.device)

    def prefill(self, batch, cache):
        return self._prefill(self.storage, batch, cache)

    def decode_step(self, cache, tokens):
        return self._decode(self.storage, cache, tokens)

    def generate(self, batch, cache, steps: int, *,
                 sample: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        """Greedy (or ``sample``-driven) generation; returns (decode state,
        tokens [B, steps])."""
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        pick = sample or (lambda logits: torch.argmax(logits, dim=-1))
        cache, logits = self.prefill(batch, cache)
        tok = pick(logits[:, -1])[:, None]
        out = [tok]
        for _ in range(steps - 1):
            cache, logits = self.decode_step(cache, tok)
            tok = pick(logits[:, -1])[:, None]
            out.append(tok)
        self.queries += 1
        return cache, torch.cat(out, dim=1)

    def serve_stats(self) -> Dict[str, Any]:
        """Swap/query telemetry."""
        return dict(
            swaps=int(self.swaps),
            queries=int(self.queries),
            swap_ms_mean=statistics.fmean(self.swap_ms) if self.swap_ms else 0.0,
            swap_ms_max=max(self.swap_ms) if self.swap_ms else 0.0,
        )
