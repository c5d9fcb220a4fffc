"""Pluggable non-IID client partitioners (port of ``repro.data.partition``).

A *partitioner* decides how the global data distribution is split across the
client population.  Every partitioner is a frozen dataclass exposing

  ``source_weights(key, client_id, num_sources, device) -> f32[num_sources]``
      the client's mixing distribution over latent "sources" (speakers /
      label shards / topic clusters — the unit of statistical heterogeneity),
  ``domain_of(client_id) -> int``
      which task domain the client lives in (for adaptation scenarios).

Both are functions of ``(seed, client_id)`` alone.  The classic FL splits
are provided:

  * :class:`IIDPartition` — uniform mixing; every client sees the same
    distribution (paper Table 1 conditions),
  * :class:`DirichletPartition` — per-client Dirichlet(α) source weights
    (``prng.dirichlet``, jax's gamma sampler), the standard label-skew
    benchmark (smaller α = more skew; paper Table 3),
  * :class:`ShardPartition` — each client holds exactly
    ``shards_per_client`` of the sources (the pathological FedAvg split),
  * :class:`DomainPartition` — clients split across task domains (paper
    Table 2's Multi-Domain analogue).

``make_partitioned_batch_fn`` binds a partitioner to a
:class:`~repro_torch.data.synthetic.FrameTask`: each example draws a source
from the client's mixing weights and shifts its frames by that source's bias
vector, and the label probe follows the client's domain.  The result has the
engine's ``data_fn(client_id, round, step)`` signature and draws on
``task.device``.  The keys and the uniform bits equal the reference's; the
Dirichlet weights, the normals and the labels agree as ``core.prng`` and
``synthetic`` state (ROADMAP C3).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Protocol

import torch

from repro_torch.core import prng

from .synthetic import FrameTask


class Partitioner(Protocol):
    """Structural interface: any frozen dataclass with these two methods
    plugs into the engine's data path."""

    def source_weights(self, key: prng.Key, client_id: int, num_sources: int,
                       device=None) -> torch.Tensor: ...

    def domain_of(self, client_id: int) -> int: ...


def _client_key(key: prng.Key, seed: int, client_id: int) -> prng.Key:
    return prng.fold_in(prng.fold_in(key, seed), int(client_id))


@dataclasses.dataclass(frozen=True)
class IIDPartition:
    seed: int = 0

    def source_weights(self, key, client_id, num_sources, device=None):
        del key, client_id
        return torch.full((num_sources,), 1.0 / num_sources, dtype=torch.float32, device=device)

    def domain_of(self, client_id):
        return 0


@dataclasses.dataclass(frozen=True)
class DirichletPartition:
    alpha: float = 0.3
    seed: int = 0

    def source_weights(self, key, client_id, num_sources, device=None):
        alpha = torch.full((num_sources,), self.alpha, dtype=torch.float32)
        return prng.dirichlet(_client_key(key, self.seed, client_id), alpha, device=device)

    def domain_of(self, client_id):
        return 0


@dataclasses.dataclass(frozen=True)
class ShardPartition:
    shards_per_client: int = 2
    seed: int = 0

    def source_weights(self, key, client_id, num_sources, device=None):
        scores = prng.uniform(_client_key(key, self.seed, client_id), (num_sources,), device)
        # exact-k selection; the uniform is bit-exact, so are the ranks
        ranks = torch.argsort(torch.argsort(scores, stable=True), stable=True)
        held = ranks < self.shards_per_client
        return held.to(torch.float32) / max(int(held.sum()), 1)

    def domain_of(self, client_id):
        return 0


@dataclasses.dataclass(frozen=True)
class DomainPartition:
    """Clients striped across ``num_domains`` task domains; within a domain
    sources mix by an inner partitioner (default IID)."""

    num_domains: int = 2
    inner: Partitioner = IIDPartition()

    def source_weights(self, key, client_id, num_sources, device=None):
        return self.inner.source_weights(key, client_id, num_sources, device)

    def domain_of(self, client_id):
        return int(client_id) % self.num_domains


@functools.lru_cache(maxsize=1024)
def _source_weights(part, key: prng.Key, client_id: int, num_sources: int,
                    device: str) -> torch.Tensor:
    """A client's mixing weights, cached: a function of its arguments."""
    return part.source_weights(key, client_id, num_sources, device)


def make_partitioned_batch_fn(task: FrameTask, part: Partitioner, batch_size: int,
                              num_sources: int = 16):
    """Engine-compatible ``data_fn(client_id, round_index, step) -> batch``
    (``{"frames": f32 [B, S, d_in], "labels": int32 [B, S]}`` on
    ``task.device``).

    Per example: draw a source from the client's mixing weights, add that
    source's fixed bias vector to the frames (scaled by
    ``task.speaker_bias``), label with the client's domain probe.  A function
    of (task.seed, part, client_id, round, step), drawn as the reference
    draws it.  ``data_fn.sources(client_id, round_index, step)`` gives the
    batch's sources (int64 ``[B]``), ``data_fn.weights(client_id)`` the
    client's mixing weights, for checks; the reference returns neither.
    """
    device = str(task.device)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; make the task with device='cpu' to "
                           "draw on the CPU")
    # fixed per-source signatures — the heterogeneity the clients disagree on
    source_bias = prng.normal(prng.PRNGKey(task.seed + 5), (num_sources, task.d_in), device)

    def keys(client_id, round_index, step):
        k = prng.fold_in(prng.fold_in(prng.fold_in(prng.PRNGKey(task.seed + 6), int(client_id)),
                                      int(round_index)), int(step))
        return prng.split(k)  # frames' key, sources' key

    def weights(client_id):
        return _source_weights(part, prng.PRNGKey(task.seed + 7), int(client_id), num_sources,
                               device)

    def sources(client_id, round_index, step):
        ks = keys(client_id, round_index, step)[1]
        return prng.categorical(ks, torch.log(weights(client_id) + 1e-9), shape=(batch_size,))

    def data_fn(client_id, round_index, step):
        kf = keys(client_id, round_index, step)[0]
        frames = prng.normal(kf, (batch_size, task.seq_len, task.d_in), device)
        srcs = sources(client_id, round_index, step)
        frames = frames + task.speaker_bias * source_bias[srcs][:, None, :]
        probe = task.probe(part.domain_of(client_id))
        c = task.context
        padded = torch.nn.functional.pad(frames, (0, 0, c, c))
        windows = torch.cat([padded[:, i:i + task.seq_len] for i in range(2 * c + 1)], dim=-1)
        labels = torch.argmax(windows @ probe, dim=-1)
        return dict(frames=frames, labels=labels.to(torch.int32))

    data_fn.sources, data_fn.weights = sources, weights
    return data_fn
