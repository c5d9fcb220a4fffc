"""Synthetic ASR frame task with IID / non-IID clients (port of
``repro.data.synthetic``, frame task only).

Frame embeddings whose labels are the argmax of a fixed random linear probe
over a local context window; non-IID clients add a per-speaker bias vector
to their frames.  Everything is a function of (seed, client, round, step)
drawn from ``core.prng``: the uniform bits equal ``jax.random``'s, and the
normals are within 4 ulp of them (XLA's ``erf_inv`` polynomial, with
another library's ``log1p``).  Labels are an argmax, so
they equal the reference's unless two logits lie within that rounding.
The LM task and the partitioners (``repro.data.partition``) are not ported
yet (ROADMAP A3).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import prng


@dataclasses.dataclass(frozen=True)
class Partitioner:
    """Client data distribution control."""

    num_clients: int
    iid: bool = True
    alpha: float = 0.3  # Dirichlet concentration for non-IID skew (LM task)


@dataclasses.dataclass(frozen=True)
class FrameTask:
    d_in: int
    n_classes: int
    seq_len: int
    part: Partitioner
    seed: int = 0
    domain: int = 0  # domain id: different probe = different domain (MD)
    context: int = 2  # label depends on +-context frames
    speaker_bias: float = 1.0  # non-IID frame shift magnitude
    device: str = "cuda"  # where batches are drawn

    @functools.lru_cache(maxsize=4)
    def probe(self, domain=None) -> torch.Tensor:
        """Label probe ``[d_in·(2·context+1), n_classes]`` for ``domain``
        (default: the task's own).  Cached: it is a function of the task."""
        d = self.domain if domain is None else domain
        k = prng.fold_in(prng.PRNGKey(self.seed + 10), d)
        return prng.normal(k, (self.d_in * (2 * self.context + 1), self.n_classes), self.device)

    def batch(self, client_id, round_index, step, batch_size: int):
        return frame_batch(self, client_id, round_index, step, batch_size)


def frame_batch(task: FrameTask, client_id, round_index, step, batch_size: int):
    """``{"frames": f32 [B, S, d_in], "labels": int32 [B, S]}`` on ``task.device``."""
    k = prng.fold_in(prng.fold_in(prng.fold_in(prng.PRNGKey(task.seed + 3), int(client_id)),
                                  int(round_index)), int(step))
    frames = prng.normal(k, (batch_size, task.seq_len, task.d_in), task.device)
    if not task.part.iid:
        kb = prng.fold_in(prng.PRNGKey(task.seed + 4), int(client_id))
        frames = frames + task.speaker_bias * prng.normal(kb, (task.d_in,), task.device)
    c = task.context
    padded = torch.nn.functional.pad(frames, (0, 0, c, c))
    windows = torch.cat([padded[:, i:i + task.seq_len] for i in range(2 * c + 1)], dim=-1)
    labels = torch.argmax(windows @ task.probe(), dim=-1)
    return dict(frames=frames, labels=labels.to(torch.int32))


def make_frame_task(d_in=16, n_classes=32, seq_len=48, num_clients=16, iid=True, alpha=0.3,
                    seed=0, domain=0, device="cuda") -> FrameTask:
    return FrameTask(d_in, n_classes, seq_len, Partitioner(num_clients, iid, alpha), seed,
                     domain, device=device)
