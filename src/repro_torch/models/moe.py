"""Mixture-of-Experts decoder LM (mixtral-8x7b, dbrx-132b), port of
``repro.models.moe``.

The dense transformer's attention with, in place of its MLP, a routed
expert FFN: a router picks each token's ``top_k`` experts, and each expert
takes at most ``capacity`` of the (token, expert) pairs routed to it, by
gate value, runs its SwiGLU FFN on them and adds its gated output back.
Every shape is fixed before the data is seen (capacity from the token
count; no ``nonzero``, no boolean indexing), so a step traces on the meta
device and never syncs with the host on the card.

Expert weights are stored as ``[E * ep_partitions, D, F / ep_partitions]``
stacks: with ``ep_partitions > 1`` each expert's FFN dim is split over
that many stored experts, which process the same tokens and whose partial
outputs add.  Over OMC storage a layer's expert stack is one
``CompressedVariable`` with one ``(s, b)``; the materializer keeps it in
code form and each stored expert's ``[D, F]`` entry streams through the
``dequant_matmul`` kernel (``common.linear``).  The router decodes through
``dequantize``, like every leaf that is not a matmul operand.

The reference dispatches under a mesh with ``shard_map`` (each model shard
its own experts, one ``psum``); the port runs on one card and has no
``shard_map``: under an active mesh it runs the same single-device dispatch
over the whole batch (ROADMAP C27), so its capacity comes from the global
token count.  Top-k picks the lower index among equal values, as
``jax.lax.top_k`` does (a stable descending sort; ROADMAP C26).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.core.store import is_compressed

from . import attention as attn
from .common import (
    Materializer,
    ParamSpec,
    RSPEC,
    apply_rope,
    dense_init,
    embed_init,
    embed_lookup,
    init_layers,
    linear,
    rms_norm,
    scan_blocks,
    shard_hint,
    softmax_xent_chunked,
    stack_entry,
    swiglu,
    wspec,
)
from .transformer import OPERANDS, TransformerConfig, _head_weight, _qkv
from .transformer import param_specs as _dense_param_specs


@dataclasses.dataclass(frozen=True)
class MoEConfig(TransformerConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    ep_partitions: int = 1  # FFN-dim split when E < model axis (set by launch)
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3

    @property
    def stored_experts(self) -> int:
        return self.n_experts * self.ep_partitions

    @property
    def f_local(self) -> int:
        return self.d_ff // self.ep_partitions

    def _count(self, experts: int) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        per_layer = (d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
                     + 3 * d * f * experts + d * self.n_experts + 2 * d)
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def param_count(self) -> int:
        """The reference's count (``moe.py:77-84``)."""
        return self._count(self.n_experts)

    def active_param_count(self) -> int:
        """Parameters one token passes through: ``top_k`` experts a layer."""
        return self._count(self.top_k)


# ---------------------------------------------------------------------------
# init / specs
# ---------------------------------------------------------------------------


def _expert_stack(key: prng.Key, n: int, d_in: int, d_out: int, device) -> torch.Tensor:
    """``stack([dense_init(k, d_in, d_out) for k in split(key, n)])``, each
    expert drawn into its slot."""
    out = torch.empty((n, d_in, d_out), device=device)
    for i, k in enumerate(prng.split(key, n)):
        out[i].copy_(dense_init(k, d_in, d_out, device=device))
    return out


def _block_init(key: prng.Key, cfg: MoEConfig, device) -> Dict[str, Any]:
    """One block from ``split(key, 8)``, one key a stored expert."""
    ks = prng.split(key, 8)
    d, fl, we = cfg.d_model, cfg.f_local, cfg.stored_experts
    return dict(
        attn_norm=torch.ones((d,), device=device),
        wq=dense_init(ks[0], d, cfg.q_dim, device=device),
        wk=dense_init(ks[1], d, cfg.kv_dim, device=device),
        wv=dense_init(ks[2], d, cfg.kv_dim, device=device),
        wo=dense_init(ks[3], cfg.q_dim, d, device=device),
        mlp_norm=torch.ones((d,), device=device),
        router=dense_init(ks[4], d, cfg.n_experts, device=device),
        w1=_expert_stack(ks[5], we, d, fl, device),
        w3=_expert_stack(ks[6], we, d, fl, device),
        w2=_expert_stack(ks[7], we, fl, d, device),
    )


def block_specs(cfg: MoEConfig) -> Dict[str, ParamSpec]:
    return dict(
        attn_norm=RSPEC,
        wq=wspec("fsdp", "tensor"),
        wk=wspec("fsdp", "tensor"),
        wv=wspec("fsdp", "tensor"),
        wo=wspec("tensor", "fsdp"),
        mlp_norm=RSPEC,
        router=wspec("fsdp", None),
        w1=wspec("expert", "fsdp", None),
        w3=wspec("expert", "fsdp", None),
        w2=wspec("expert", "fsdp", None),
    )


def init(key: prng.Key, cfg: MoEConfig, device=None) -> Dict[str, Any]:
    """The reference's ``init(key, cfg)``: the same key tree, so the same
    params within ``prng.normal``'s 4 ulp; f32 on ``device`` (the CPU by
    default), block leaves stacked on a layer axis."""
    kb, ke, kh = prng.split(key, 3)
    params = dict(
        embed=embed_init(ke, cfg.vocab, cfg.d_model, device=device),
        blocks=init_layers(lambda k: _block_init(k, cfg, device),
                           prng.split(kb, cfg.n_layers)),
        final_norm=torch.ones((cfg.d_model,), device=device),
    )
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(kh, cfg.d_model, cfg.vocab, device=device)
    return params


def param_specs(cfg: MoEConfig) -> Dict[str, Any]:
    specs = _dense_param_specs(cfg)
    specs["blocks"] = block_specs(cfg)
    return specs


# ---------------------------------------------------------------------------
# MoE FFN: routing + capacity dispatch
# ---------------------------------------------------------------------------


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, the lower index first among equal values (a stable
    sort; ``torch.topk`` promises no order for ties)."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _route(x2d: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig):
    """[T, D] -> (gate values [T, k], expert ids [T, k], aux loss)."""
    logits = (x2d @ router_w).float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gval, gidx = top_k(probs, cfg.top_k)
    gval = gval / torch.clamp(gval.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux (Switch-style): E * sum_e fraction_e * prob_e
    dispatch_frac = F.one_hot(gidx[:, 0], cfg.n_experts).float().mean(0)
    prob_frac = probs.mean(0)
    aux = cfg.n_experts * torch.sum(dispatch_frac * prob_frac)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return gval, gidx, cfg.router_aux_weight * aux + cfg.router_z_weight * z


def _expert_ffn(xe: torch.Tensor, w1e, w3e, w2e) -> torch.Tensor:
    """[C, D] through one expert's weights -> [C, D] (SwiGLU)."""
    return swiglu(xe, w1e, w3e, w2e)


def _expert(w, i: int):
    """Stored expert ``i`` of a layer's stack: an f32 ``[D, F]`` slice, or
    in code form the entry's codes with the stack's one ``(s, b)``."""
    if is_compressed(w):
        return type(w)(w.codes[i], w.s.reshape(()), w.b.reshape(()), w.fmt)
    return w[i]


def _dispatch_compute(x2d, gval, gidx, w1, w3, w2, cfg: MoEConfig,
                      local_experts: List[int], capacity: int) -> torch.Tensor:
    """Gather-compute-scatter over the stored experts.

    x2d [T, D]; w1/w3/w2 [n_local, D, F_l] / [n_local, F_l, D] (tensors or
    ``CompressedVariable`` stacks); ``local_experts[i]``: the expert id of
    stored expert ``i``.  Each expert takes its ``capacity`` highest-gated
    pairs (unrouted pairs score -1 and are masked out), and its gated
    outputs are added to their tokens in expert order, as the reference's
    scan adds them.
    """
    t = x2d.shape[0]
    flat_gv = gval.reshape(-1)  # [T*k]
    flat_eid = gidx.reshape(-1)
    token_of_pair = torch.arange(flat_eid.shape[0], device=x2d.device) // cfg.top_k
    y = torch.zeros((t, x2d.shape[1]), dtype=torch.float32, device=x2d.device)
    for i, e in enumerate(local_experts):
        score = torch.where(flat_eid == e, flat_gv, -1.0)
        top_v, top_i = top_k(score, capacity)
        valid = (top_v > 0.0).float()  # dropped / unrouted slots
        tok = token_of_pair[top_i]
        xe = x2d[tok] * valid[:, None]
        he = _expert_ffn(xe, _expert(w1, i), _expert(w3, i), _expert(w2, i))
        y.index_add_(0, tok, he * (top_v * valid)[:, None])
    return y


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    c = int(math.ceil(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    c = max(8, -(-c // 8) * 8)  # pad to multiple of 8, floor 8
    return min(c, tokens * cfg.top_k)  # can't exceed the pair count


def local_experts(cfg: MoEConfig) -> List[int]:
    """Expert id of each stored expert: ``repeat(arange(E), ep_partitions)``."""
    return [e for e in range(cfg.n_experts) for _ in range(cfg.ep_partitions)]


def moe_ffn(x: torch.Tensor, w: Dict[str, Any], cfg: MoEConfig):
    """[B, S, D] -> ([B, S, D], aux loss).  ``w`` holds router/w1/w3/w2.
    The reference's single-device path, with or without a mesh (C27)."""
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d).float()
    gval, gidx, aux = _route(x2d, w["router"], cfg)
    y = _dispatch_compute(x2d, gval, gidx, w["w1"], w["w3"], w["w2"], cfg,
                          local_experts(cfg), _capacity(t, cfg))
    return y.reshape(b, s, d).to(x.dtype), aux


# ---------------------------------------------------------------------------
# forward / loss / serve
# ---------------------------------------------------------------------------


def _attention(cfg: MoEConfig, w, x, positions, window):
    b, s, _ = x.shape
    h = rms_norm(x, w["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(w, h, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attn.attend(q, k, v, positions, positions, causal=True, window=window)
    return x + shard_hint(linear(o.reshape(b, s, cfg.q_dim), w["wo"]), "batch", None, None), k, v


def _block_apply(cfg: MoEConfig, w, x, aux, positions, window):
    x, _, _ = _attention(cfg, w, x, positions, window)
    y, aux_l = moe_ffn(rms_norm(x, w["mlp_norm"], cfg.norm_eps), w, cfg)
    return x + y, aux + aux_l


def _embeds(cfg: MoEConfig, params, tokens, mat: Materializer):
    b, s = tokens.shape
    x = shard_hint(embed_lookup(params["embed"], tokens, mat), "batch", None, None)
    return x, torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def forward(cfg: MoEConfig, params, batch, mat: Materializer):
    """Tokens -> (final hidden states [B, S, D], summed router aux loss)."""
    x, positions = _embeds(cfg, params, batch["tokens"], mat)
    aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = scan_blocks(
        lambda carry, w, _: _block_apply(cfg, w, carry[0], carry[1], positions, cfg.window),
        params["blocks"], (x, aux0), mat)
    return rms_norm(x, mat.leaf(params["final_norm"]), cfg.norm_eps), aux


def loss(cfg: MoEConfig, params, batch, mat: Materializer) -> torch.Tensor:
    """Next-token cross-entropy plus the router losses over the layers."""
    hidden, aux = forward(cfg, params, batch, mat)
    ce = softmax_xent_chunked(hidden, _head_weight(cfg, params, mat), batch["labels"],
                              batch.get("mask"))
    return ce + aux / cfg.n_layers


def init_decode_state(cfg: MoEConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cuda") -> attn.KVCache:
    buf = max_len if cfg.window is None else min(max_len, cfg.window)
    return attn.init_cache(cfg.n_layers, batch, buf, cfg.n_kv_heads, cfg.hd, dtype, device)


def _require_untied(cfg: MoEConfig) -> None:
    """The reference's MoE serve path has no tied head: its prefill
    multiplies by None there and its decode step reads ``lm_head``."""
    if cfg.tie_embeddings:
        raise ValueError("MoE serving with a tied head is undefined in the reference "
                         "(ROADMAP C28)")


def prefill(cfg: MoEConfig, params, batch, mat: Materializer,
            cache: attn.KVCache) -> Tuple[attn.KVCache, torch.Tensor]:
    """Run the prompt, fill a new cache shaped like ``cache``, return the
    logits of the last position [B, 1, V]."""
    _require_untied(cfg)
    x, positions = _embeds(cfg, params, batch["tokens"], mat)
    b, s = positions.shape
    buf = cache.buf_len
    new = attn.init_cache(cfg.n_layers, b, buf, cfg.n_kv_heads, cfg.hd, cache.k.dtype,
                          x.device)
    t = min(buf, s)  # cache tail: the last `buf` positions (ring slot = pos % buf)
    for i in range(cfg.n_layers):
        w = mat(stack_entry(params["blocks"], i), operands=OPERANDS)
        x, k, v = _attention(cfg, w, x, positions, cfg.window)
        y, _ = moe_ffn(rms_norm(x, w["mlp_norm"], cfg.norm_eps), w, cfg)
        x = x + y
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
    return attn.cache_shard_hint(new), x[:, -1:] @ mat.leaf(params["lm_head"])


def decode_step(cfg: MoEConfig, params, cache: attn.KVCache, tokens: torch.Tensor,
                mat: Materializer) -> Tuple[attn.KVCache, torch.Tensor]:
    """One new token [B, 1] against the cache -> (cache', logits [B, 1, V]),
    the new K/V written into ``cache``'s tensors in place."""
    _require_untied(cfg)
    x, _ = _embeds(cfg, params, tokens, mat)
    b = tokens.shape[0]
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
        y, _ = moe_ffn(rms_norm(x, w["mlp_norm"], cfg.norm_eps), w, cfg)
        x = x + y
        del w
    x = rms_norm(x, mat.leaf(params["final_norm"]), cfg.norm_eps)
    return (attn.cache_shard_hint(dataclasses.replace(cache, length=position + 1)),
            x @ mat.leaf(params["lm_head"]))
