"""Synthetic learnable tasks (port of ``repro.data.synthetic``).

  * :class:`LMTask` — token streams from a random first-order Markov chain
    over the vocab (IID clients only here).
  * :class:`FrameTask` — synthetic ASR: frame embeddings whose labels are the
    argmax of a fixed random linear probe over a local context window;
    non-IID clients add a per-speaker bias vector to their frames.

Everything is a function of (seed, client, round, step) drawn from
``core.prng``: the uniform bits equal ``jax.random``'s, and the normals are
within 4 ulp of them (XLA's ``erf_inv`` polynomial, with another library's
``log1p``).  Frame labels are an argmax and LM tokens a Gumbel argmax
(``prng.categorical``), so they equal the reference's unless two candidates
lie within that rounding (ROADMAP C3); a token that flips sends that row's
chain its own way from there.  The non-IID LM task (a Dirichlet draw per
client) and the partitioners (``repro.data.partition``) are not ported yet
(ROADMAP A3).
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


# ---------------------------------------------------------------------------
# Language-model task (token streams)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LMTask:
    vocab: int
    seq_len: int
    part: Partitioner
    seed: int = 0
    temperature: float = 1.5
    device: str = "cuda"  # where batches are drawn

    def __post_init__(self):
        if not self.part.iid:
            raise NotImplementedError("the non-IID LM task re-weights each client's transitions "
                                      "with a dirichlet draw, which is not ported yet (ROADMAP A3)")

    @functools.lru_cache(maxsize=2)
    def _logits(self) -> torch.Tensor:
        """Transition logits ``[vocab, vocab]``, row = current token.  Cached:
        a function of the task."""
        k = prng.PRNGKey(self.seed)
        return prng.normal(k, (self.vocab, self.vocab), self.device) * self.temperature

    def client_logits(self, client_id) -> torch.Tensor:
        return self._logits()  # IID: every client shares the chain

    def batch(self, client_id, round_index, step, batch_size: int):
        return lm_batch(self, client_id, round_index, step, batch_size)


def lm_batch(task: LMTask, client_id, round_index, step, batch_size: int):
    """Sample ``[B, S+1]`` Markov tokens -> ``{"tokens", "labels"}``, int32
    ``[B, S]`` each on ``task.device`` (next-token LM).  The reference's
    ``lax.scan`` over ``seq_len`` steps is a loop here, each step one
    ``categorical`` draw under its own key of ``split(kseq, seq_len)``."""
    logits = task.client_logits(client_id)
    k = prng.fold_in(prng.fold_in(prng.fold_in(prng.PRNGKey(task.seed + 2), int(client_id)),
                                  int(round_index)), int(step))
    k0, kseq = prng.split(k)
    tok = prng.randint(k0, (batch_size,), 0, task.vocab, task.device)
    seq = [tok]
    for kk in prng.split(kseq, task.seq_len):
        tok = prng.categorical(kk, logits[tok])
        seq.append(tok)
    seq = torch.stack(seq, dim=1).to(torch.int32)  # [B, S+1]
    return dict(tokens=seq[:, :-1], labels=seq[:, 1:])


def make_lm_task(vocab=256, seq_len=64, num_clients=16, iid=True, alpha=0.3, seed=0,
                 device="cuda") -> LMTask:
    return LMTask(vocab, seq_len, Partitioner(num_clients, iid, alpha), seed, device=device)


# ---------------------------------------------------------------------------
# Frame-classification task (synthetic ASR)
# ---------------------------------------------------------------------------


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
