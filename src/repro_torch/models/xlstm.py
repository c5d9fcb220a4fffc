"""xLSTM language model, sLSTM + mLSTM blocks (port of ``repro.models.xlstm``;
xlstm-350m, arXiv:2405.04517).

Residual blocks whose sequence mixer is an mLSTM (a matrix memory with no
hidden-to-hidden recurrence) or an sLSTM (a scalar memory with true
``h_{t-1}`` feedback), in super blocks of ``slstm_every - 1`` mLSTM blocks
and one sLSTM block, then ``n_extra_m`` mLSTM blocks.  There is no separate
MLP: the up and down projections inside each block mix the channels.

Parameters keep the reference's tree: ``embed``, ``super_blocks/{mlstm,
slstm}``, ``extra_m`` and ``final_norm``, the mLSTM leaves of the super
blocks stacked on two axes ``[n_super, m_per_super, ...]``.  Training
(``forward``/``loss``) runs each block through ``common.layer_call``, under
its own ``checkpoint`` when gradients are taken.  Serving (``prefill``,
``decode_step``) carries a constant-size f32 state: each mLSTM block's conv
carry and cell ``(C, n, m)``, each sLSTM block's ``(c, n, m, h)``, and the
host-int ``length``.

Every projection matrix (``M_OPERANDS``, ``S_OPERANDS``) goes through
``common.linear``: over OMC storage it streams its codes through the
``dequant_matmul`` kernel.  ``conv_w`` and ``r_gates``, used elementwise and
per head, are decoded by the materializer; the tied head is ``x @ dec(E).T``,
as the reference computes it.

The time recurrences run as host loops: the mLSTM's recurrent form (one
step a token; decode) and its chunkwise-parallel form (one step a chunk,
each chunk under ``checkpoint`` in training; prefill and training), which compute the same function up to f32 reassociation, and
the sLSTM's one step a token.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng

from .common import (
    Materializer,
    ParamSpec,
    RSPEC,
    as_f32,
    dense_init,
    embed_init,
    embed_lookup,
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
from .griffin import _causal_conv

M_OPERANDS = ("w_up", "wq", "wk", "wv", "w_if", "w_down")
S_OPERANDS = ("w_gates", "w_down")
S_KEYS = ("c", "n", "m", "h")  # the sLSTM state, in the reference's tuple order
NEG = -1e30  # the stabilizer's start


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    n_layers: int
    d_model: int
    n_heads: int
    vocab: int
    slstm_every: int = 8  # 1-in-N blocks are sLSTM (xLSTM[7:1] ratio)
    m_proj_factor: int = 2  # mLSTM inner width = factor * d_model
    conv_kernel: int = 4
    mlstm_impl: str = "chunked"  # "chunked" (prefill and training) | "recurrent"
    mlstm_chunk: int = 64
    norm_eps: float = 1e-6
    tie_embeddings: bool = True

    @property
    def d_inner(self) -> int:
        return self.m_proj_factor * self.d_model

    @property
    def m_head_dim(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def s_head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_super(self) -> int:
        return self.n_layers // self.slstm_every

    @property
    def m_per_super(self) -> int:
        return self.slstm_every - 1

    @property
    def n_extra_m(self) -> int:
        return self.n_layers - self.n_super * self.slstm_every

    @property
    def n_slstm(self) -> int:
        return self.n_super

    def param_count(self) -> int:
        """The reference's formula (``xlstm.py:87-95``), kept because the
        roofline's MODEL_FLOPS reads it.  It counts an mLSTM block's ``b_if``
        (``2H``) as a second ``d``-vector, so it exceeds the init's leaf sizes
        by ``(d - 2H)`` an mLSTM block: 21,336 for xlstm-350m (ROADMAP C29)."""
        d, di, h = self.d_model, self.d_inner, self.n_heads
        m = d * 2 * di + self.conv_kernel * di + 3 * di * di + di * 2 * h + di * d + 2 * d + di
        ds = d
        s = d * 4 * ds + h * self.s_head_dim * 4 * self.s_head_dim + 4 * ds + ds * d + d + ds
        n_m = self.n_layers - self.n_slstm
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return n_m * m + self.n_slstm * s + emb + d


# ---------------------------------------------------------------------------
# init / specs
# ---------------------------------------------------------------------------


def _mlstm_init(key: prng.Key, cfg: XLSTMConfig, device) -> Dict[str, Any]:
    ks = prng.split(key, 7)
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    b_if = torch.zeros((2 * h,), device=device)
    b_if[h:] = 3.0
    return dict(
        norm=torch.ones((d,), device=device),
        w_up=dense_init(ks[0], d, 2 * di, device=device),
        conv_w=prng.normal(ks[1], (cfg.conv_kernel, di), device).mul_(as_f32(0.1)),
        wq=dense_init(ks[2], di, di, device=device),
        wk=dense_init(ks[3], di, di, device=device),
        wv=dense_init(ks[4], di, di, device=device),
        w_if=dense_init(ks[5], di, 2 * h, device=device),  # i/f gate pre-activations a head
        b_if=b_if,
        gn_scale=torch.ones((di,), device=device),
        w_down=dense_init(ks[6], di, d, device=device),
    )


def _slstm_init(key: prng.Key, cfg: XLSTMConfig, device) -> Dict[str, Any]:
    ks = prng.split(key, 3)
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.s_head_dim
    return dict(
        norm=torch.ones((d,), device=device),
        w_gates=dense_init(ks[0], d, 4 * d, device=device),  # i, f, z, o stacked
        r_gates=prng.normal(ks[1], (h, dh, 4 * dh), device).div_(as_f32(math.sqrt(dh))),
        b_gates=torch.zeros((4 * d,), device=device),
        gn_scale=torch.ones((d,), device=device),
        w_down=dense_init(ks[2], d, d, device=device),
    )


def _mlstm_specs() -> Dict[str, ParamSpec]:
    return dict(
        norm=RSPEC,
        w_up=wspec("fsdp", "tensor"),
        conv_w=ParamSpec(storage=(None, "tensor"), gathered=(None, "tensor")),
        wq=wspec("fsdp", None),
        wk=wspec("fsdp", None),
        wv=wspec("fsdp", "dstate"),
        w_if=wspec("fsdp", None),
        b_if=RSPEC,
        gn_scale=RSPEC,
        w_down=wspec("dstate", "fsdp"),
    )


def _slstm_specs() -> Dict[str, ParamSpec]:
    return dict(
        norm=RSPEC,
        w_gates=wspec("fsdp", None),
        r_gates=ParamSpec(storage=(None, None, "fsdp"), gathered=(None, None, None)),
        b_gates=RSPEC,
        gn_scale=RSPEC,
        w_down=wspec("fsdp", None),
    )


def block_specs(cfg: XLSTMConfig) -> Dict[str, Any]:
    return dict(mlstm=_mlstm_specs(), slstm=_slstm_specs())


def init(key: prng.Key, cfg: XLSTMConfig, device=None) -> Dict[str, Any]:
    """The reference's ``init(key, cfg)``: the same key tree (``split(key,
    4)``, one key a block; an untied head drawn from the embedding's key), so
    the same params within ``prng.normal``'s 4 ulp; f32 on ``device`` (the
    CPU by default), in the reference's tree."""
    km, ks, ke, kx = prng.split(key, 4)
    n_m = cfg.n_super * cfg.m_per_super
    m_blocks = init_layers(lambda k: _mlstm_init(k, cfg, device), prng.split(km, max(n_m, 1)))
    m_blocks = {k: v.reshape((cfg.n_super, cfg.m_per_super) + v.shape[1:])
                for k, v in m_blocks.items()}
    s_blocks = init_layers(lambda k: _slstm_init(k, cfg, device),
                           prng.split(ks, max(cfg.n_super, 1)))
    params = dict(
        embed=embed_init(ke, cfg.vocab, cfg.d_model, device=device),
        super_blocks=dict(mlstm=m_blocks, slstm=s_blocks),
        final_norm=torch.ones((cfg.d_model,), device=device),
    )
    if cfg.n_extra_m:
        params["extra_m"] = init_layers(lambda k: _mlstm_init(k, cfg, device),
                                        prng.split(kx, cfg.n_extra_m))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(ke, cfg.d_model, cfg.vocab, device=device)
    return params


def param_specs(cfg: XLSTMConfig) -> Dict[str, Any]:
    specs = dict(
        embed=ParamSpec(storage=("fsdp", "tensor"), gathered=(None, "tensor")),
        super_blocks=dict(mlstm=_mlstm_specs(), slstm=_slstm_specs()),
        final_norm=RSPEC,
    )
    if cfg.n_extra_m:
        specs["extra_m"] = _mlstm_specs()
    if not cfg.tie_embeddings:
        specs["lm_head"] = wspec("fsdp", "tensor")
    return specs


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def _zero_cell(b: int, h: int, dk: int, dv: int, device):
    return (torch.zeros((b, h, dv, dk), device=device), torch.zeros((b, h, dk), device=device),
            torch.full((b, h), NEG, device=device))


def _mlstm_scan(q, k, v, i_pre, f_pre, state):
    """The mLSTM recurrence, one step a token.

    q/k [B,S,H,dk], v [B,S,H,dv], i_pre/f_pre [B,S,H]; state (C [B,H,dv,dk],
    n [B,H,dk], m [B,H]) or None.  Returns h [B,S,H,dv] and the new state.
    ``torch.maximum`` splits a tie's gradient evenly, as ``jnp.maximum`` does.
    """
    b, s, h, dk = q.shape
    C, n, m = state if state is not None else _zero_cell(b, h, dk, v.shape[-1], q.device)
    one = torch.ones((), device=q.device)
    hs = []
    for t in range(s):
        qt, kt, vt, it, ft = q[:, t], k[:, t], v[:, t], i_pre[:, t], f_pre[:, t]
        f_log = F.logsigmoid(ft)
        m_new = torch.maximum(f_log + m, it)
        i_sc = torch.exp(it - m_new)
        f_sc = torch.exp(f_log + m - m_new)
        C = f_sc[..., None, None] * C + i_sc[..., None, None] * (vt[..., :, None] * kt[..., None, :])
        n = f_sc[..., None] * n + i_sc[..., None] * kt
        num = torch.einsum("bhvk,bhk->bhv", C, qt)
        den = torch.abs(torch.einsum("bhk,bhk->bh", n, qt))
        hs.append(num / torch.maximum(den, one)[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (C, n, m)


def _mlstm_chunk(C_prev, n_prev, m_prev, qc, kc, vc, ic, fc):
    """One chunk of :func:`_mlstm_chunked`: q/k [B,H,c,dk], v [B,H,c,dv],
    i/f [B,H,c] -> (C, n, m, h [B,H,c,dv])."""
    c = qc.shape[2]
    tri = torch.ones((c, c), dtype=torch.bool, device=qc.device).tril()
    f_log = F.logsigmoid(fc)
    Fc = torch.cumsum(f_log, dim=-1)  # F_i (inclusive)
    D = Fc[..., :, None] - Fc[..., None, :] + ic[..., None, :]
    D = torch.where(tri, D, torch.full((), -math.inf, device=D.device))
    b_i = m_prev[..., None] + Fc
    m_i = torch.maximum(b_i, torch.amax(D, dim=-1))
    w_inter = torch.exp(b_i - m_i)  # [B,H,c]
    w_intra = torch.exp(D - m_i[..., None])  # [B,H,c,c]
    p = w_intra * torch.einsum("bhid,bhjd->bhij", qc, kc)
    h_intra = torch.einsum("bhij,bhjv->bhiv", p, vc)
    h_inter = w_inter[..., None] * torch.einsum("bhvk,bhik->bhiv", C_prev, qc)
    n_intra = p.sum(-1)
    n_inter = w_inter * torch.einsum("bhk,bhik->bhi", n_prev, qc)
    den = torch.abs(n_inter + n_intra)
    hv = (h_inter + h_intra) / torch.maximum(den, torch.ones((), device=den.device))[..., None]
    # chunk-boundary state: step j's contribution decays by F_c - F_j
    F_c = Fc[..., -1]
    g = F_c[..., None] - Fc + ic  # [B,H,c]
    m_next = torch.maximum(m_prev + F_c, torch.amax(g, dim=-1))
    wj = torch.exp(g - m_next[..., None])
    decay = torch.exp(m_prev + F_c - m_next)
    C_next = decay[..., None, None] * C_prev + torch.einsum("bhj,bhjv,bhjk->bhvk", wj, vc, kc)
    n_next = decay[..., None] * n_prev + torch.einsum("bhj,bhjk->bhk", wj, kc)
    return C_next, n_next, m_next, hv


def _mlstm_chunked(q, k, v, i_pre, f_pre, state, chunk: int = 64):
    """Chunkwise-parallel mLSTM, the same function as :func:`_mlstm_scan`
    up to f32 reassociation (the reference's ``_mlstm_chunked``).

    Within a chunk the contributions are computed in parallel with exact
    exponential-gating stabilizers (``F_i`` the cumulative log-decay, ``D_ij
    = F_i - F_j + ĩ_j`` for ``j <= i``, ``-inf`` above the diagonal); the
    state ``C`` is materialized once a chunk.  The chunk is the largest
    divisor of S up to ``chunk`` (a prime prompt runs at chunk 1).  In
    training each chunk runs under ``checkpoint``, so the backward pass
    recomputes its [c, c] tiles instead of keeping them.
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    C, n, m = state if state is not None else _zero_cell(b, h, dk, dv, q.device)
    c = min(chunk, s)
    while s % c:
        c -= 1

    def to_chunks(x):  # [B, S, H, ...] -> [B, H, n_chunks, c, ...]
        x = x.float().reshape((b, s // c, c, h) + x.shape[3:])
        return x.permute((0, 3, 1, 2) + tuple(range(4, x.ndim)))

    qs, ks, vs, is_, fs = (to_chunks(x) for x in (q, k, v, i_pre, f_pre))
    hs = []
    for j in range(s // c):
        args = (C, n, m, qs[:, :, j], ks[:, :, j], vs[:, :, j], is_[:, :, j], fs[:, :, j])
        if q.requires_grad:
            C, n, m, hv = checkpoint(_mlstm_chunk, *args, use_reentrant=False)
        else:
            C, n, m, hv = _mlstm_chunk(*args)
        hs.append(hv)
    out = torch.stack(hs, dim=2)  # [B, H, n_chunks, c, dv]
    return out.permute(0, 2, 3, 1, 4).reshape(b, s, h, dv), (C, n, m)


def _group_norm_heads(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head group norm (population variance).  x [B, S, H, dh]; scale [H*dh]."""
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    xn = (x - mu) * torch.rsqrt(var + eps)
    b, s, h, dh = x.shape
    return xn.reshape(b, s, h * dh) * scale


def mlstm_block(cfg: XLSTMConfig, w, x, conv_carry=None, cell_state=None):
    """x [B,S,D] -> (x', (conv_carry', cell_state')).  Prefill and training
    (S > 1) run the chunked form, decode (S = 1) the recurrent one."""
    b, s, _ = x.shape
    nh, dh = cfg.n_heads, cfg.m_head_dim
    hin = rms_norm(x, w["norm"], cfg.norm_eps)
    main, z = linear(hin, w["w_up"]).chunk(2, dim=-1)  # [B,S,Di] each
    main_c, conv_carry = _causal_conv(main, w["conv_w"], conv_carry)
    main_c = F.silu(main_c)
    q = linear(main_c, w["wq"]).reshape(b, s, nh, dh)
    k = linear(main_c, w["wk"]).reshape(b, s, nh, dh) / as_f32(math.sqrt(dh))
    v = linear(main, w["wv"]).reshape(b, s, nh, dh)  # from the unconvolved branch
    i_pre, f_pre = (linear(main_c, w["w_if"]) + w["b_if"]).chunk(2, dim=-1)  # [B,S,H] each
    if cfg.mlstm_impl == "chunked" and s > 1:
        hs, cell_state = _mlstm_chunked(q, k, v, i_pre, f_pre, cell_state,
                                        chunk=cfg.mlstm_chunk)
    else:
        hs, cell_state = _mlstm_scan(q, k, v, i_pre, f_pre, cell_state)
    hs = _group_norm_heads(hs, w["gn_scale"], cfg.norm_eps) * F.silu(z)
    out = linear(hs, w["w_down"])
    return (x + shard_hint(out, "batch", None, None)).to(x.dtype), (conv_carry, cell_state)


def slstm_block(cfg: XLSTMConfig, w, x, state=None):
    """x [B,S,D] -> (x', (c, n, m, h)).  The true recurrence (h_{t-1}
    feedback through the per-head ``r_gates``), one step a token."""
    b, s, _ = x.shape
    nh, dh = cfg.n_heads, cfg.s_head_dim
    hin = rms_norm(x, w["norm"], cfg.norm_eps)
    gates_x = (linear(hin, w["w_gates"]) + w["b_gates"]).reshape(b, s, 4, nh, dh)
    if state is None:
        z = torch.zeros((b, nh, dh), device=x.device)
        state = (z, z, torch.full((b, nh, dh), NEG, device=x.device), z)
    c, n, m, h_prev = state
    one = torch.ones((), device=x.device)
    r = w["r_gates"]
    hs = []
    for t in range(s):
        gr = torch.einsum("bhd,hde->bhe", h_prev, r).reshape(b, nh, 4, dh).transpose(1, 2)
        gi, gf, gz, go = (gates_x[:, t] + gr).unbind(1)
        f_log = F.logsigmoid(gf)
        m_new = torch.maximum(f_log + m, gi)
        i_sc = torch.exp(gi - m_new)
        f_sc = torch.exp(f_log + m - m_new)
        c = f_sc * c + i_sc * torch.tanh(gz)
        n = f_sc * n + i_sc  # exactly 1 at the first step: the tie below splits as in JAX
        h_prev = torch.sigmoid(go) * c / torch.maximum(n, one)
        m = m_new
        hs.append(h_prev)
    hs = _group_norm_heads(torch.stack(hs, dim=1), w["gn_scale"], cfg.norm_eps)
    out = linear(hs, w["w_down"])
    return (x + shard_hint(out, "batch", None, None)).to(x.dtype), (c, n, m, h_prev)


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------


def forward(cfg: XLSTMConfig, params, batch, mat: Materializer) -> torch.Tensor:
    """Tokens -> final hidden states [B, S, D] (pre-head); each block through
    ``layer_call``, the doubly stacked mLSTM leaves unbound per entry."""
    x = shard_hint(embed_lookup(params["embed"], batch["tokens"], mat), "batch", None, None)

    def m_layer(c, w, i):
        return mlstm_block(cfg, w, c)[0]

    def s_layer(c, w, i):
        return slstm_block(cfg, w, c)[0]

    sb = params["super_blocks"]
    for m_stack, s_params in zip(unstack(sb["mlstm"]), unstack(sb["slstm"])):
        x = scan_blocks(m_layer, m_stack, x, mat)
        x = layer_call(s_layer, s_params, x, mat)
    if cfg.n_extra_m:
        x = scan_blocks(m_layer, params["extra_m"], x, mat)
    return rms_norm(x, mat.leaf(params["final_norm"]), cfg.norm_eps)


def _head_weight(cfg: XLSTMConfig, params, mat: Materializer) -> torch.Tensor:
    if cfg.tie_embeddings:
        return mat.leaf(params["embed"]).T  # the whole table, every step
    return mat.leaf(params["lm_head"])


def loss(cfg: XLSTMConfig, params, batch, mat: Materializer) -> torch.Tensor:
    """Mean next-token cross-entropy (over ``batch["mask"]`` where given)."""
    hidden = forward(cfg, params, batch, mat)
    return softmax_xent_chunked(hidden, _head_weight(cfg, params, mat), batch["labels"],
                                batch.get("mask"))


# ---------------------------------------------------------------------------
# serving: a constant-size recurrent state
# ---------------------------------------------------------------------------


def init_decode_state(cfg: XLSTMConfig, batch: int, max_len: int, dtype=torch.float32,
                      device="cuda") -> Dict[str, Any]:
    """The state is f32 whatever ``dtype`` says, and its size does not
    depend on ``max_len``, as in the reference (both kept for the API):
    ``mlstm`` ([n_super, m_per_super, ...]) and ``extra_m`` ([n_extra, ...])
    hold each block's conv carry [B, k-1, Di] and cell C [B, H, dv, dk], n
    [B, H, dk], m [B, H] (-1e30); ``slstm`` each block's c, n, m (-1e30), h
    [B, H, dh]; ``length`` is a host int."""
    del max_len, dtype
    b, h, dk = batch, cfg.n_heads, cfg.m_head_dim

    def m_state(lead):
        return dict(
            conv=torch.zeros(lead + (b, cfg.conv_kernel - 1, cfg.d_inner), device=device),
            C=torch.zeros(lead + (b, h, dk, dk), device=device),
            n=torch.zeros(lead + (b, h, dk), device=device),
            m=torch.full(lead + (b, h), NEG, device=device),
        )

    s_shape = (cfg.n_super, b, h, cfg.s_head_dim)
    state = dict(
        mlstm=m_state((cfg.n_super, cfg.m_per_super)),
        slstm={k: torch.full(s_shape, NEG if k == "m" else 0.0, device=device) for k in S_KEYS},
        length=0,
    )
    if cfg.n_extra_m:
        state["extra_m"] = m_state((cfg.n_extra_m,))
    return state


def state_shard_hint(state):
    """The reference's decode-state layout: batch->data, the value dim of
    C and the conv carry's features->dstate (the sLSTM state replicated)."""
    out = dict(state)

    def m_hint(st, lead):
        return dict(conv=shard_hint(st["conv"], *lead, "batch", None, "dstate"),
                    C=shard_hint(st["C"], *lead, "batch", None, "dstate", None),
                    n=shard_hint(st["n"], *lead, "batch", None, None),
                    m=shard_hint(st["m"], *lead, "batch", None))

    out["mlstm"] = m_hint(state["mlstm"], (None, None))
    if "extra_m" in state:
        out["extra_m"] = m_hint(state["extra_m"], (None,))
    return out


def _mlstm_stack(cfg: XLSTMConfig, stack_p, stack_st, x, mat: Materializer):
    """A stack of mLSTM blocks (leaves ``[n, ...]``) from their carried state
    (``conv``, ``C``, ``n``, ``m``: ``[n, ...]``) -> (x, new state)."""
    new = {k: torch.empty_like(v) for k, v in stack_st.items()}
    for j in range(new["C"].shape[0]):
        w = mat(stack_entry(stack_p, j), operands=M_OPERANDS)
        x, (conv, (C, n, m)) = mlstm_block(
            cfg, w, x, conv_carry=stack_st["conv"][j],
            cell_state=(stack_st["C"][j], stack_st["n"][j], stack_st["m"][j]))
        new["conv"][j], new["C"][j], new["n"][j], new["m"][j] = conv, C, n, m
    return x, new


def _run(cfg: XLSTMConfig, params, state, tokens, mat: Materializer):
    """Shared prefill/decode body: ``tokens`` [B, S] from the state's
    carries -> (state' without ``length``, logits of the last position)."""
    x = shard_hint(embed_lookup(params["embed"], tokens, mat), "batch", None, None)
    sb = params["super_blocks"]
    new_m = {k: torch.empty_like(v) for k, v in state["mlstm"].items()}
    new_s = {k: torch.empty_like(v) for k, v in state["slstm"].items()}
    for g in range(cfg.n_super):
        x, st = _mlstm_stack(cfg, stack_entry(sb["mlstm"], g), stack_entry(state["mlstm"], g),
                             x, mat)
        for k, v in st.items():
            new_m[k][g] = v
        w = mat(stack_entry(sb["slstm"], g), operands=S_OPERANDS)
        x, cell = slstm_block(cfg, w, x, state=tuple(state["slstm"][k][g] for k in S_KEYS))
        for k, v in zip(S_KEYS, cell):
            new_s[k][g] = v
    new_state = dict(mlstm=new_m, slstm=new_s)
    if cfg.n_extra_m:
        x, new_state["extra_m"] = _mlstm_stack(cfg, params["extra_m"], state["extra_m"], x, mat)
    x = rms_norm(x, mat.leaf(params["final_norm"]), cfg.norm_eps)
    return new_state, x[:, -1:] @ _head_weight(cfg, params, mat)


def prefill(cfg: XLSTMConfig, params, batch, mat: Materializer, state):
    """Run the prompt ``batch["tokens"]`` [B, S] from the state's carries
    -> (state' with ``length`` = S, as the reference sets it; logits [B, 1, V])."""
    new_state, logits = _run(cfg, params, state, batch["tokens"], mat)
    new_state["length"] = batch["tokens"].shape[1]
    return state_shard_hint(new_state), shard_hint(logits, "batch", None, "tensor")


def decode_step(cfg: XLSTMConfig, params, state, tokens: torch.Tensor, mat: Materializer):
    """One token [B, 1] through the recurrence -> (state', logits [B, 1, V])."""
    new_state, logits = _run(cfg, params, state, tokens, mat)
    new_state["length"] = state["length"] + 1
    return state_shard_hint(new_state), shard_hint(logits, "batch", None, "tensor")
