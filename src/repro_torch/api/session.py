"""Serving session over the wire codec (port of ``repro.api.session``).

``ServeSession`` is the inference side: batched prefill/decode over the
compressed weights via ``make_serve_fns``, with ``hot_swap`` ingesting a new
round's payload between rounds.  The decode state is the family's own: a
``KVCache`` for the dense transformer, a dict for griffin (``rec``, ``att``,
optional ``extra_rec`` and the host-int ``length``); the session passes it
through unchanged.  The FL side (``FLSession``, ``FLClient``)
belongs to the training slice.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.tree import tree_items
from repro_torch.federated.round import make_serve_fns

from . import codecs


def _tree_device(tree) -> torch.device:
    for _, leaf in tree_items(tree):
        return leaf.device  # a tensor or a CompressedVariable
    raise ValueError("empty storage tree")


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeSession:
    """Batched decode over compressed weights with payload hot-swap.

    The session runs on the device its storage tree lives on; payloads are
    decoded onto that device.
    """

    def __init__(self, family, cfg, storage):
        self.family = family
        self.cfg = cfg
        self.storage = storage
        self.device = _tree_device(storage)
        self._prefill, self._decode = make_serve_fns(family, cfg)
        self.swaps = 0
        self.queries = 0
        self.swap_ms: List[float] = []  # per-swap wall ms: decode payload + new storage ready

    def hot_swap(self, payload: bytes) -> codecs.PayloadInfo:
        """Ingest a new round's model; delta payloads apply against the
        currently served tree (digest-verified).  Wall time lands in
        ``swap_ms``."""
        t0 = time.perf_counter()
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
