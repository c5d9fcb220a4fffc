"""Griffin / RecurrentGemma hybrid (port of ``repro.models.griffin``): RG-LRU
recurrent blocks and local attention in a repeating (recurrent, recurrent,
attention) pattern, each followed by a GeGLU MLP (arXiv:2402.19427).

Training (``forward``/``loss``: each block through ``common.layer_call``,
under its own ``checkpoint`` when gradients are taken, and the chunked
cross-entropy against the tied head) and serving (``prefill`` and
``decode_step`` over a dict decode state: the recurrent blocks' conv carry
and RG-LRU state, the attention blocks' ring cache, the host-int
``length``).  Parameters keep the reference's tree: ``embed``,
``super_blocks/{rec, att}``, ``extra_rec`` and ``final_norm``, with the
recurrent leaves of the super blocks stacked on two axes
``[n_super, rec_per_super, ...]`` (unbound per entry in training).

Every projection matrix (``REC_OPERANDS``, ``ATT_OPERANDS``) goes through
``common.linear``: over OMC storage it streams its codes through the
``dequant_matmul`` kernel.  ``conv_w``, a compressed ``[k, r]`` leaf used
elementwise, is decoded by the materializer; the tied head is ``x @ dec(E).T``,
as the reference computes it.

The RG-LRU recurrence ``h_t = a_t·h_{t-1} + b_t`` runs as a log-depth scan
(the reference's ``lax.associative_scan`` computes the same function; the
rounding order differs).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import prng

from . import attention as attn
from .common import (
    Materializer,
    ParamSpec,
    RSPEC,
    apply_rope,
    as_f32,
    dense_init,
    embed_init,
    embed_lookup,
    gelu,
    init_layers,
    layer_call,
    linear,
    rms_norm,
    scan_blocks,
    shard_hint,
    softmax_xent_chunked,
    stack_entry,
    unstack,
    wspec,
)

REC_OPERANDS = ("w_x", "w_gate", "w_rg", "w_ig", "w_out", "w1", "w3", "w2")
ATT_OPERANDS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


@dataclasses.dataclass(frozen=True)
class GriffinConfig:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    lru_width: Optional[int] = None  # defaults to d_model
    window: int = 2048
    conv_kernel: int = 4
    pattern_period: int = 3  # 1 attention block per period
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    a_param_init: float = 0.95  # initial recurrence magnitude

    @property
    def lru(self) -> int:
        return self.lru_width or self.d_model

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_super(self) -> int:
        return self.n_layers // self.pattern_period

    @property
    def rec_per_super(self) -> int:
        return self.pattern_period - 1

    @property
    def n_extra_rec(self) -> int:
        return self.n_layers - self.n_super * self.pattern_period

    def param_count(self) -> int:
        d, f, r = self.d_model, self.d_ff, self.lru
        mlp = 3 * d * f + d
        rec = 2 * d * r + self.conv_kernel * r + 2 * r + 2 * r + r * d + d + mlp
        att = (d * (self.n_heads + 2 * self.n_kv_heads) * self.hd
               + self.n_heads * self.hd * d + d + mlp)
        n_att = self.n_super
        n_rec = self.n_layers - n_att
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return n_rec * rec + n_att * att + emb + d


# ---------------------------------------------------------------------------
# init / specs
# ---------------------------------------------------------------------------


def _rec_init(key: prng.Key, cfg: GriffinConfig, device) -> Dict[str, Any]:
    """One recurrent block from ``split(key, 7)``; ``ks[0]`` and ``ks[1]``
    draw ``w3`` and ``w2`` again, as the reference draws them."""
    ks = prng.split(key, 7)
    d, r, f = cfg.d_model, cfg.lru, cfg.d_ff
    # Λ so that a_t = exp(-8·softplus(Λ)·r_t) equals a_param_init at r_t = 1
    s0 = -math.log(cfg.a_param_init) / 8.0
    lam = math.log(math.expm1(s0))
    return dict(
        norm=torch.ones((d,), device=device),
        w_x=dense_init(ks[0], d, r, device=device),  # main branch
        w_gate=dense_init(ks[1], d, r, device=device),  # gelu gate branch
        conv_w=prng.normal(ks[2], (cfg.conv_kernel, r), device).mul_(as_f32(0.1)),
        lam=torch.full((r,), lam, device=device),  # RG-LRU Λ (1-D: not compressed)
        w_rg=dense_init(ks[3], r, r, scale=0.5, device=device),  # recurrence gate
        b_rg=torch.zeros((r,), device=device),
        w_ig=dense_init(ks[4], r, r, scale=0.5, device=device),  # input gate
        b_ig=torch.zeros((r,), device=device),
        w_out=dense_init(ks[5], r, d, device=device),
        mlp_norm=torch.ones((d,), device=device),
        w1=dense_init(ks[6], d, f, device=device),
        w3=dense_init(ks[0], d, f, device=device),
        w2=dense_init(ks[1], f, d, device=device),
    )


def _att_init(key: prng.Key, cfg: GriffinConfig, device) -> Dict[str, Any]:
    ks = prng.split(key, 7)
    d, f = cfg.d_model, cfg.d_ff
    return dict(
        norm=torch.ones((d,), device=device),
        wq=dense_init(ks[0], d, cfg.n_heads * cfg.hd, device=device),
        wk=dense_init(ks[1], d, cfg.n_kv_heads * cfg.hd, device=device),
        wv=dense_init(ks[2], d, cfg.n_kv_heads * cfg.hd, device=device),
        wo=dense_init(ks[3], cfg.n_heads * cfg.hd, d, device=device),
        mlp_norm=torch.ones((d,), device=device),
        w1=dense_init(ks[4], d, f, device=device),
        w3=dense_init(ks[5], d, f, device=device),
        w2=dense_init(ks[6], f, d, device=device),
    )


def _rec_specs() -> Dict[str, ParamSpec]:
    vec = ParamSpec(storage=("dstate",), gathered=("dstate",))
    return dict(
        norm=RSPEC,
        w_x=wspec("fsdp", "dstate"),
        w_gate=wspec("fsdp", "dstate"),
        conv_w=ParamSpec(storage=(None, "dstate"), gathered=(None, "dstate")),
        lam=vec,
        w_rg=wspec("fsdp", "dstate"),
        b_rg=vec,
        w_ig=wspec("fsdp", "dstate"),
        b_ig=vec,
        w_out=wspec("dstate", "fsdp"),
        mlp_norm=RSPEC,
        w1=wspec("fsdp", "tensor"),
        w3=wspec("fsdp", "tensor"),
        w2=wspec("tensor", "fsdp"),
    )


def _att_specs() -> Dict[str, ParamSpec]:
    return dict(
        norm=RSPEC,
        wq=wspec("fsdp", "tensor"),
        wk=wspec("fsdp", "tensor"),
        wv=wspec("fsdp", "tensor"),
        wo=wspec("tensor", "fsdp"),
        mlp_norm=RSPEC,
        w1=wspec("fsdp", "tensor"),
        w3=wspec("fsdp", "tensor"),
        w2=wspec("tensor", "fsdp"),
    )


def init(key: prng.Key, cfg: GriffinConfig, device=None) -> Dict[str, Any]:
    """The reference's ``init(key, cfg)``: the same key tree (``split(key,
    4)``, one key a block; an untied head drawn from the embedding's key),
    so the same params within ``prng.normal``'s 4 ulp; f32 on ``device``
    (the CPU by default), in the reference's tree, the constant Λ included."""
    kr, ka, ke, kx = prng.split(key, 4)
    n_rec = cfg.n_super * cfg.rec_per_super
    rec = init_layers(lambda k: _rec_init(k, cfg, device), prng.split(kr, max(n_rec, 1)))
    rec = {k: v.reshape((cfg.n_super, cfg.rec_per_super) + v.shape[1:]) for k, v in rec.items()}
    params = dict(
        embed=embed_init(ke, cfg.vocab, cfg.d_model, device=device),
        super_blocks=dict(rec=rec, att=init_layers(lambda k: _att_init(k, cfg, device),
                                                   prng.split(ka, max(cfg.n_super, 1)))),
        final_norm=torch.ones((cfg.d_model,), device=device),
    )
    if cfg.n_extra_rec:
        params["extra_rec"] = init_layers(lambda k: _rec_init(k, cfg, device),
                                          prng.split(kx, cfg.n_extra_rec))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(ke, cfg.d_model, cfg.vocab, device=device)
    return params


def param_specs(cfg: GriffinConfig) -> Dict[str, Any]:
    specs = dict(
        embed=ParamSpec(storage=("fsdp", "tensor"), gathered=(None, "tensor")),
        super_blocks=dict(rec=_rec_specs(), att=_att_specs()),
        final_norm=RSPEC,
    )
    if cfg.n_extra_rec:
        specs["extra_rec"] = _rec_specs()
    if not cfg.tie_embeddings:
        specs["lm_head"] = wspec("fsdp", "tensor")
    return specs


# ---------------------------------------------------------------------------
# RG-LRU, causal conv, blocks
# ---------------------------------------------------------------------------


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t·h_{t-1} + b_t`` along axis 1 from ``h_{-1} = 0``, in log
    depth (Hillis-Steele): the reference's associative scan with the combine
    ``(a1, b1), (a2, b2) -> (a1·a2, a2·b1 + b2)``."""
    shift, s = 1, a.shape[1]
    while shift < s:
        b = torch.cat([b[:, :shift], b[:, shift:] + a[:, shift:] * b[:, :-shift]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def _rg_lru(x: torch.Tensor, w, h0: Optional[torch.Tensor] = None):
    """x [B, S, R] -> (y [B, S, R], h_last [B, R]).

    a_t = sigmoid(Λ)^(8·r_t),  r_t = sigmoid(x_t @ w_rg + b_rg)
    h_t = a_t h_{t-1} + sqrt(1 - a_t²) · (i_t ⊙ x_t),  i_t = sigmoid(x @ w_ig + b_ig)
    """
    r_gate = torch.sigmoid(linear(x, w["w_rg"]) + w["b_rg"])
    i_gate = torch.sigmoid(linear(x, w["w_ig"]) + w["b_ig"])
    log_a = -8.0 * r_gate * F.softplus(w["lam"])
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i_gate * x)
    if h0 is not None:
        # fold the carried state into the first step's additive term
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = _linear_scan(a, b)
    return h, h[:, -1]


def _causal_conv(x: torch.Tensor, conv_w: torch.Tensor, carry: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time: x [B, S, R], conv_w [k, R]; the carry
    holds the last k-1 inputs [B, k-1, R] (zeros when None)."""
    k = conv_w.shape[0]
    if carry is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([carry.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * conv_w[i] for i in range(k))
    new_carry = xp[:, -(k - 1):] if k > 1 else None
    return y, new_carry


def _mlp(cfg: GriffinConfig, w, x: torch.Tensor) -> torch.Tensor:
    """GeGLU MLP with its pre-norm: gelu(h @ w1) * (h @ w3) @ w2."""
    h = rms_norm(x, w["mlp_norm"], cfg.norm_eps)
    return linear(gelu(linear(h, w["w1"])) * linear(h, w["w3"]), w["w2"])


def rec_block(cfg: GriffinConfig, w, x, conv_carry=None, h0=None):
    """Recurrent mixer + MLP.  Returns (x', (conv_carry', h_last))."""
    dtype_in = x.dtype
    hin = rms_norm(x, w["norm"], cfg.norm_eps)
    gate = gelu(linear(hin, w["w_gate"]))
    main = linear(hin, w["w_x"])
    main, conv_carry = _causal_conv(main, w["conv_w"], conv_carry)
    y, h_last = _rg_lru(main, w, h0)
    x = x + linear(y * gate, w["w_out"])
    x = (x + _mlp(cfg, w, x)).to(dtype_in)
    return x, (conv_carry, h_last)


def att_block(cfg: GriffinConfig, w, x, positions, cache_slice=None, position=None):
    """Local-attention mixer + MLP.  Prefill (``cache_slice=None``: returns the
    new K/V and positions) or one decode step (writes ``cache_slice`` in
    place at ``position``, a ring of the window's slots)."""
    b, s, _ = x.shape
    dtype_in = x.dtype
    hin = rms_norm(x, w["norm"], cfg.norm_eps)
    q = linear(hin, w["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
    k = linear(hin, w["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = linear(hin, w["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache_slice is None:
        o = attn.attend(q, k, v, positions, positions, causal=True, window=cfg.window)
        new_cache = (k, v, positions)
    else:
        kc, vc, pc = attn.cache_insert(*cache_slice, k, v, position, ring=True)
        o = attn.decode_attend(q, kc, vc, pc, position, window=cfg.window)
        new_cache = (kc, vc, pc)
    x = x + linear(o.reshape(b, s, cfg.n_heads * cfg.hd), w["wo"])
    x = (x + _mlp(cfg, w, x)).to(dtype_in)
    return x, new_cache


# ---------------------------------------------------------------------------
# training: forward and loss
# ---------------------------------------------------------------------------


def forward(cfg: GriffinConfig, params, batch, mat: Materializer) -> torch.Tensor:
    """Tokens -> final hidden states [B, S, D] (pre-head): per super block
    its recurrent stack and its attention block, then ``extra_rec``."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = shard_hint(embed_lookup(params["embed"], tokens, mat), "batch", None, None)
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

    def r_layer(c, w, i):
        return rec_block(cfg, w, c)[0]

    def a_layer(c, w, i):
        return att_block(cfg, w, c, positions)[0]

    sb = params["super_blocks"]
    for rec, att in zip(unstack(sb["rec"]), unstack(sb["att"])):
        x = scan_blocks(r_layer, rec, x, mat)
        x = layer_call(a_layer, att, x, mat)
    if cfg.n_extra_rec:
        x = scan_blocks(r_layer, params["extra_rec"], x, mat)
    return rms_norm(x, mat.leaf(params["final_norm"]), cfg.norm_eps)


def loss(cfg: GriffinConfig, params, batch, mat: Materializer) -> torch.Tensor:
    """Mean next-token cross-entropy (over ``batch["mask"]`` where given)."""
    hidden = forward(cfg, params, batch, mat)
    return softmax_xent_chunked(hidden, _head_weight(cfg, params, mat), batch["labels"],
                                batch.get("mask"))


# ---------------------------------------------------------------------------
# serving — O(window) attention cache + O(1) recurrent state
# ---------------------------------------------------------------------------


def init_decode_state(cfg: GriffinConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device="cuda") -> Dict[str, Any]:
    """``rec``/``extra_rec``: conv carry [.., B, k-1, R] and RG-LRU state
    [.., B, R] (f32); ``att``: a ring of ``min(max_len, window)`` slots per
    attention block (``pos`` -1 = empty); ``length``: tokens seen, a host int."""
    buf = min(max_len, cfg.window)
    b, km1, r = batch, cfg.conv_kernel - 1, cfg.lru

    def rec(lead):
        return dict(conv=torch.zeros(lead + (b, km1, r), dtype=torch.float32, device=device),
                    h=torch.zeros(lead + (b, r), dtype=torch.float32, device=device))

    kv = (cfg.n_super, b, buf, cfg.n_kv_heads, cfg.hd)
    state = dict(
        rec=rec((cfg.n_super, cfg.rec_per_super)),
        att=dict(k=torch.zeros(kv, dtype=dtype, device=device),
                 v=torch.zeros(kv, dtype=dtype, device=device),
                 pos=torch.full(kv[:3], -1, dtype=torch.int32, device=device)),
        length=0,
    )
    if cfg.n_extra_rec:
        state["extra_rec"] = rec((cfg.n_extra_rec,))
    return state


def state_shard_hint(state):
    """The reference's decode-state layout (``common.shard_hint``): batch->
    data, the recurrent feature dim->dstate, the ring's slots->kv_seq."""
    out = dict(state)
    out["rec"] = dict(
        conv=shard_hint(state["rec"]["conv"], None, None, "batch", None, "dstate"),
        h=shard_hint(state["rec"]["h"], None, None, "batch", "dstate"))
    out["att"] = dict(
        k=shard_hint(state["att"]["k"], None, "batch", "kv_seq", None, None),
        v=shard_hint(state["att"]["v"], None, "batch", "kv_seq", None, None),
        pos=shard_hint(state["att"]["pos"], None, "batch", "kv_seq"))
    if "extra_rec" in state:
        out["extra_rec"] = dict(
            conv=shard_hint(state["extra_rec"]["conv"], None, "batch", None, "dstate"),
            h=shard_hint(state["extra_rec"]["h"], None, "batch", "dstate"))
    return out


def _rec_stack(cfg: GriffinConfig, stack_p, stack_st, x, mat: Materializer):
    """Run a stack of recurrent blocks (leaves ``[n, ...]``) from their
    carried state ``{conv: [n, ...], h: [n, ...]}``; return (x, new state)."""
    conv, h = torch.empty_like(stack_st["conv"]), torch.empty_like(stack_st["h"])
    for j in range(conv.shape[0]):
        w = mat(stack_entry(stack_p, j), operands=REC_OPERANDS)
        x, (conv_j, h_j) = rec_block(cfg, w, x, conv_carry=stack_st["conv"][j],
                                     h0=stack_st["h"][j])
        conv[j], h[j] = conv_j, h_j
    return x, dict(conv=conv, h=h)


def _run(cfg: GriffinConfig, params, state, tokens, mat: Materializer, start_pos: int):
    """Shared prefill/decode body: run ``tokens`` [B, S] from ``start_pos``.

    Decode (S = 1) writes each attention block's ring in place and returns a
    state that shares it; prefill fills new ring tensors shaped like the
    state's.  Returns (state', logits of the last position [B, 1, V]).
    """
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens, mat)
    positions = start_pos + torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    att = state["att"]
    buf = att["k"].shape[2]
    decode = s == 1
    new_att = att if decode else dict(k=torch.zeros_like(att["k"]), v=torch.zeros_like(att["v"]),
                                      pos=torch.full_like(att["pos"], -1))
    new_rec = dict(conv=torch.empty_like(state["rec"]["conv"]),
                   h=torch.empty_like(state["rec"]["h"]))
    sb = params["super_blocks"]
    for g in range(cfg.n_super):
        x, rst = _rec_stack(cfg, stack_entry(sb["rec"], g), stack_entry(state["rec"], g), x, mat)
        new_rec["conv"][g], new_rec["h"][g] = rst["conv"], rst["h"]
        w = mat(stack_entry(sb["att"], g), operands=ATT_OPERANDS)
        if decode:
            x, _ = att_block(cfg, w, x, positions,
                             cache_slice=(att["k"][g], att["v"][g], att["pos"][g]),
                             position=start_pos)
            continue
        x, (kc, vc, pc) = att_block(cfg, w, x, positions)
        t = min(buf, s)  # the last `buf` positions; ring slot = pos % buf
        kc, vc, pc = kc[:, -t:], vc[:, -t:], pc[:, -t:]
        if t == buf and s % buf:
            kc, vc, pc = (torch.roll(a, s % buf, dims=1) for a in (kc, vc, pc))
        new_att["k"][g, :, :t] = kc.to(new_att["k"].dtype)
        new_att["v"][g, :, :t] = vc.to(new_att["v"].dtype)
        new_att["pos"][g, :, :t] = pc
    new_state = dict(rec=new_rec, att=new_att, length=start_pos + s)
    if cfg.n_extra_rec:
        x, new_state["extra_rec"] = _rec_stack(cfg, params["extra_rec"], state["extra_rec"], x,
                                               mat)
    x = rms_norm(x, mat.leaf(params["final_norm"]), cfg.norm_eps)
    return state_shard_hint(new_state), x[:, -1:] @ _head_weight(cfg, params, mat)


def _head_weight(cfg: GriffinConfig, params, mat: Materializer) -> torch.Tensor:
    if cfg.tie_embeddings:
        return mat.leaf(params["embed"]).T  # the whole table, every step
    return mat.leaf(params["lm_head"])


def prefill(cfg: GriffinConfig, params, batch, mat: Materializer, state):
    """Run the prompt ``batch["tokens"]`` [B, S] from position 0 with the
    state's carries -> (state', logits [B, 1, V])."""
    return _run(cfg, params, state, batch["tokens"], mat, 0)


def decode_step(cfg: GriffinConfig, params, state, tokens: torch.Tensor, mat: Materializer):
    """One new token [B, 1] -> (state', logits [B, 1, V])."""
    return _run(cfg, params, state, tokens, mat, state["length"])
