"""Dense decoder-only transformer LM with GQA (port of ``repro.models.transformer``).

Serving only: ``prefill`` and ``decode_step`` against a KV cache, over any
parameter tree a :class:`~repro_torch.models.common.Materializer` turns into
compute weights (the identity for f32 params, ``OMCMaterializer`` for OMC
storage).  Training (``loss``/``forward``) waits for the training slice.

The stacked block parameters are consumed by a Python loop over layers.  The
seven block matrices of a layer (``OPERANDS``) go through ``common.linear``:
over OMC storage each streams its codes through the ``dequant_matmul``
kernel.  The tied head stays ``x @ dec(E).T``, a decode and a matmul, as the
reference computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from . import attention as attn
from .common import (
    Materializer,
    ParamSpec,
    RSPEC,
    apply_rope,
    dense_init,
    embed_init,
    embed_lookup,
    linear,
    rms_norm,
    stack_entry,
    swiglu,
    wspec,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    qkv_bias: bool = False  # qwen family
    window: Optional[int] = None  # sliding-window attention, every layer
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd


# ---------------------------------------------------------------------------
# init / specs
# ---------------------------------------------------------------------------


def init(gen: torch.Generator, cfg: TransformerConfig) -> Dict[str, Any]:
    """Random f32 params on ``gen.device``, block leaves stacked on a layer axis.

    The draws differ from the reference's (``jax.random`` vs a
    ``torch.Generator``); the distributions and the tree are the same.
    """
    d, f, L = cfg.d_model, cfg.d_ff, (cfg.n_layers,)
    dev = gen.device
    blocks = dict(
        attn_norm=torch.ones((cfg.n_layers, d), device=dev),
        wq=dense_init(gen, d, cfg.q_dim, layers=L),
        wk=dense_init(gen, d, cfg.kv_dim, layers=L),
        wv=dense_init(gen, d, cfg.kv_dim, layers=L),
        wo=dense_init(gen, cfg.q_dim, d, layers=L),
        mlp_norm=torch.ones((cfg.n_layers, d), device=dev),
        w1=dense_init(gen, d, f, layers=L),
        w3=dense_init(gen, d, f, layers=L),
        w2=dense_init(gen, f, d, layers=L),
    )
    if cfg.qkv_bias:
        blocks.update(
            bq=torch.zeros((cfg.n_layers, cfg.q_dim), device=dev),
            bk=torch.zeros((cfg.n_layers, cfg.kv_dim), device=dev),
            bv=torch.zeros((cfg.n_layers, cfg.kv_dim), device=dev),
        )
    params = dict(
        embed=embed_init(gen, cfg.vocab, d),
        blocks=blocks,
        final_norm=torch.ones((d,), device=dev),
    )
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, cfg.vocab)
    return params


def block_specs(cfg: TransformerConfig) -> Dict[str, ParamSpec]:
    s = dict(
        attn_norm=RSPEC,
        wq=wspec("fsdp", "tensor"),
        wk=wspec("fsdp", "tensor"),
        wv=wspec("fsdp", "tensor"),
        wo=wspec("tensor", "fsdp"),
        mlp_norm=RSPEC,
        w1=wspec("fsdp", "tensor"),
        w3=wspec("fsdp", "tensor"),
        w2=wspec("tensor", "fsdp"),
    )
    if cfg.qkv_bias:
        s.update(bq=wspec("tensor"), bk=wspec("tensor"), bv=wspec("tensor"))
    return s


def param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    specs = dict(
        embed=ParamSpec(storage=("fsdp", "tensor"), gathered=(None, "tensor")),
        blocks=block_specs(cfg),
        final_norm=RSPEC,
    )
    if not cfg.tie_embeddings:
        specs["lm_head"] = wspec("fsdp", "tensor")
    return specs


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode against a KV cache
# ---------------------------------------------------------------------------


OPERANDS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")  # the block's matmul operands


def _qkv(w, x, cfg: TransformerConfig):
    b, s, _ = x.shape
    q = linear(x, w["wq"])
    k = linear(x, w["wk"])
    v = linear(x, w["wv"])
    if "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    return (q.reshape(b, s, cfg.n_heads, cfg.hd), k.reshape(b, s, cfg.n_kv_heads, cfg.hd),
            v.reshape(b, s, cfg.n_kv_heads, cfg.hd))


def _head_weight(cfg: TransformerConfig, params, mat: Materializer) -> torch.Tensor:
    if cfg.tie_embeddings:
        return mat.leaf(params["embed"]).T  # the whole table, every step
    return mat.leaf(params["lm_head"])


def init_decode_state(cfg: TransformerConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cuda") -> attn.KVCache:
    buf = max_len if cfg.window is None else min(max_len, cfg.window)
    return attn.init_cache(cfg.n_layers, batch, buf, cfg.n_kv_heads, cfg.hd, dtype, device)


def prefill(cfg: TransformerConfig, params, batch, mat: Materializer,
            cache: attn.KVCache) -> Tuple[attn.KVCache, torch.Tensor]:
    """Run the prompt, fill a new cache shaped like ``cache``, return the
    logits of the last position [B, 1, V]."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens, mat)
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    buf = cache.buf_len
    new = attn.init_cache(cfg.n_layers, b, buf, cfg.n_kv_heads, cfg.hd, cache.k.dtype,
                          x.device)
    t = min(buf, s)  # cache tail: the last `buf` positions (ring slot = pos % buf)
    for i in range(cfg.n_layers):
        w = mat(stack_entry(params["blocks"], i), operands=OPERANDS)
        h = rms_norm(x, w["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(w, h, cfg)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = attn.attend(q, k, v, positions, positions, causal=True, window=cfg.window)
        x = x + linear(o.reshape(b, s, cfg.q_dim), w["wo"])
        h = rms_norm(x, w["mlp_norm"], cfg.norm_eps)
        x = x + swiglu(h, w["w1"], w["w3"], w["w2"])
        new.k[i, :, :t] = k[:, -t:].to(new.k.dtype)
        new.v[i, :, :t] = v[:, -t:].to(new.v.dtype)
        new.pos[i, :, :t] = positions[:, -t:]
        del w
    if cfg.window is not None and s >= buf:
        # ring layout: rotate so that slot index == pos % buf
        roll = s % buf
        new.k, new.v, new.pos = (torch.roll(a, roll, dims=2) for a in (new.k, new.v, new.pos))
    new.length = s
    x = rms_norm(x, mat.leaf(params["final_norm"]), cfg.norm_eps)
    return new, x[:, -1:] @ _head_weight(cfg, params, mat)


def decode_step(cfg: TransformerConfig, params, cache: attn.KVCache, tokens: torch.Tensor,
                mat: Materializer) -> Tuple[attn.KVCache, torch.Tensor]:
    """One new token [B, 1] against the cache -> (cache', logits [B, 1, V]).

    The new K/V are written into ``cache``'s tensors in place (the reference
    returns a fresh cache); the returned cache shares them, one token longer.
    """
    b = tokens.shape[0]
    x = embed_lookup(params["embed"], tokens, mat)
    position = cache.length
    positions = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    ring = cfg.window is not None
    for i in range(cfg.n_layers):
        w = mat(stack_entry(params["blocks"], i), operands=OPERANDS)
        h = rms_norm(x, w["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(w, h, cfg)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        kc, vc, pc = attn.cache_insert(cache.k[i], cache.v[i], cache.pos[i], k, v, position,
                                       ring=ring)
        o = attn.decode_attend(q, kc, vc, pc, position, window=cfg.window)
        x = x + linear(o.reshape(b, 1, cfg.q_dim), w["wo"])
        h = rms_norm(x, w["mlp_norm"], cfg.norm_eps)
        x = x + swiglu(h, w["w1"], w["w3"], w["w2"])
        del w
    x = rms_norm(x, mat.leaf(params["final_norm"]), cfg.norm_eps)
    return dataclasses.replace(cache, length=position + 1), x @ _head_weight(cfg, params, mat)
