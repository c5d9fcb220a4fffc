"""Grouped-query attention and its KV cache (port of ``repro.models.attention``).

Written with plain torch ops (einsum, softmax).  GQA is computed grouped —
q is viewed as [B, S, KVH, G, hd] against K/V of [B, S, KVH, hd] — so the KV
heads are never repeated.  The reference chunks train/prefill attention with
an online softmax to bound its score transient on TPU; the serve path here
attends over prompts of a few dozen tokens, so one softmax over the full
score matrix computes the same function.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .common import shard_hint

NEG_INF = -1e30


def _mask_bias(q_pos, k_pos, *, causal: bool, window: Optional[int], k_valid=None):
    """[.., Sq, Sk] additive bias from positional visibility rules."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    if k_valid is not None:
        ok = ok & k_valid[..., None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _grouped_attention(q, k, v, bias):
    """q [B,Sq,H,hd], k/v [B,Sk,KVH,hd], bias [B,Sq,Sk] -> [B,Sq,H,hd] (q dtype)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = (q.to(torch.float32) * (1.0 / math.sqrt(hd))).reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.to(torch.float32))
    s = s + bias[:, :, None, None, :]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(b, sq, h, hd).to(q.dtype)


def attend(q, k, v, q_pos, k_pos, *, causal: bool = True,
           window: Optional[int] = None) -> torch.Tensor:
    """Attention of q [B, Sq, H, hd] over k/v [B, Sk, KVH, hd] at absolute
    positions q_pos [B, Sq] / k_pos [B, Sk].  Returns [B, Sq, H, hd]."""
    bias = _mask_bias(q_pos, k_pos, causal=causal, window=window)
    return _grouped_attention(q, k, v, bias)


@dataclasses.dataclass
class KVCache:
    """Per-layer-stacked KV cache.

    k/v: [L, B, S_buf, KVH, hd].  For sliding-window configs S_buf = window
    (ring buffer), otherwise S_buf = max context.  ``pos`` holds the absolute
    position written at each slot (-1 = empty).  ``length`` is the number of
    tokens seen so far, a host int.
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor  # [L, B, S_buf] int32
    length: int = 0

    @property
    def buf_len(self) -> int:
        return self.k.shape[2]


def init_cache(n_layers: int, batch: int, buf_len: int, kv_heads: int, head_dim: int,
               dtype=torch.float32, device="cuda") -> KVCache:
    shape = (n_layers, batch, buf_len, kv_heads, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((n_layers, batch, buf_len), -1, dtype=torch.int32, device=device),
        length=0,
    )


def cache_shard_hint(c: KVCache) -> KVCache:
    """The reference's cache layout: batch->data; KV heads->tensor when
    divisible, else cache sequence->model (``common.shard_hint``)."""
    return KVCache(k=shard_hint(c.k, None, "batch", "kv_seq", "tensor", None),
                   v=shard_hint(c.v, None, "batch", "kv_seq", "tensor", None),
                   pos=shard_hint(c.pos, None, "batch", "kv_seq"), length=c.length)


def cache_insert(layer_k, layer_v, layer_pos, k_new, v_new, position: int, ring: bool):
    """Write one token's K/V at absolute ``position``, in place.

    layer_k/v: [B, S_buf, KVH, hd]; k_new/v_new: [B, 1, KVH, hd].  Ring
    buffers (sliding window) wrap; otherwise the last slot is reused past
    the end, as in the reference.
    """
    s_buf = layer_k.shape[1]
    slot = position % s_buf if ring else min(position, s_buf - 1)
    layer_k[:, slot] = k_new[:, 0].to(layer_k.dtype)
    layer_v[:, slot] = v_new[:, 0].to(layer_v.dtype)
    layer_pos[:, slot] = position
    return layer_k, layer_v, layer_pos


def decode_attend(q, layer_k, layer_v, layer_pos, q_position: int, *,
                  window: Optional[int] = None, causal: bool = True) -> torch.Tensor:
    """Single-token attention of q [B, 1, H, hd] against one layer's cache
    (``causal=False`` for cross-attention to an encoder's memory: every
    filled slot is visible whatever its position)."""
    q_pos = torch.full((q.shape[0], 1), q_position, dtype=torch.int32, device=q.device)
    bias = _mask_bias(q_pos, layer_pos, causal=causal, window=window, k_valid=layer_pos >= 0)
    return _grouped_attention(q, layer_k, layer_v, bias)
