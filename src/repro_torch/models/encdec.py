"""Encoder-decoder transformer, the seamless-m4t-medium backbone (port of
``repro.models.encdec``).

The audio frontend is a stub, as in the reference: ``batch["frames"]``
carries precomputed frame embeddings [B, S_enc, d_model].  The encoder is
bidirectional multi-head attention without RoPE; the decoder adds causal
self-attention (RoPE on its own stream) and cross-attention to the encoder
memory.  Each block is pre-LayerNorm with a tanh-gelu MLP with biases.

Training (``encode``, ``decode_train``, ``loss``) runs each block through
``common.scan_blocks``, under its own ``checkpoint`` when gradients are
taken; serving's prefill runs the same ``encode``, its matrices in code
form.  Serving: ``prefill`` runs the encoder once, computes each decoder
layer's cross K/V from the memory once (kept in the state) and prefills the
decoder's self cache, left-aligned; ``decode_step`` extends the decoder by
one token, its self K/V written in place (past the buffer's end into the
last slot, as the reference's ``cache_insert(ring=False)`` does), its
cross-attention reading the memory unmasked by position.

Every projection matrix (``ENC_OPERANDS``, ``DEC_OPERANDS``) goes through
``common.linear``: over OMC storage it streams its codes through the
``dequant_matmul`` kernel.  The embedding rows and the untied ``lm_head``
are decoded by the materializer, the head whole at every step, as the
reference decodes it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.core import prng

from . import attention as attn
from .common import (
    Materializer,
    ParamSpec,
    RSPEC,
    apply_rope,
    dense_init,
    embed_init,
    embed_lookup,
    gelu_mlp,
    init_layers,
    layer_norm,
    linear,
    scan_blocks,
    shard_hint,
    softmax_xent_chunked,
    stack_entry,
    wspec,
)

ATT = ("wq", "wk", "wv", "wo")
ENC_OPERANDS = ATT + ("w1", "w2")
DEC_OPERANDS = ATT + tuple("c_" + k for k in ATT) + ("w1", "w2")


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    dec_ratio: int = 4  # dec_len = enc_len // dec_ratio for train shapes
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        """The reference's formula (``encdec.py:60-69``), kept because the
        roofline's MODEL_FLOPS reads it.  It counts ``2d`` for the final
        norms, which hold ``4d`` (the encoder's and the decoder's scale and
        bias), so it falls ``2d`` short of the init's leaf sizes: 2,048 for
        seamless-m4t-medium (ROADMAP C29)."""
        d, f = self.d_model, self.d_ff
        att = d * (self.n_heads + 2 * self.n_kv_heads) * self.hd + self.n_heads * self.hd * d
        mlp = 2 * d * f + d + f
        enc = att + mlp + 4 * d
        dec = 2 * att + mlp + 6 * d
        return (self.n_enc_layers * enc + self.n_dec_layers * dec
                + 2 * self.vocab * d + 2 * d)


# ---------------------------------------------------------------------------
# init / specs
# ---------------------------------------------------------------------------


def _attn_params(key: prng.Key, cfg: EncDecConfig, device, prefix: str = ""):
    ks = prng.split(key, 4)
    d, qd = cfg.d_model, cfg.n_heads * cfg.hd
    kvd = cfg.n_kv_heads * cfg.hd
    return {prefix + "wq": dense_init(ks[0], d, qd, device=device),
            prefix + "wk": dense_init(ks[1], d, kvd, device=device),
            prefix + "wv": dense_init(ks[2], d, kvd, device=device),
            prefix + "wo": dense_init(ks[3], qd, d, device=device)}


def _attn_specs(prefix: str = "") -> Dict[str, ParamSpec]:
    return {prefix + "wq": wspec("fsdp", "tensor"), prefix + "wk": wspec("fsdp", "tensor"),
            prefix + "wv": wspec("fsdp", "tensor"), prefix + "wo": wspec("tensor", "fsdp")}


def _norms(names, d: int, device) -> Dict[str, torch.Tensor]:
    out = {}
    for n in names:
        out[n + "_scale"] = torch.ones((d,), device=device)
        out[n + "_bias"] = torch.zeros((d,), device=device)
    return out


def _mlp_init(k1, k2, cfg: EncDecConfig, device):
    d, f = cfg.d_model, cfg.d_ff
    return dict(w1=dense_init(k1, d, f, device=device), b1=torch.zeros((f,), device=device),
                w2=dense_init(k2, f, d, device=device), b2=torch.zeros((d,), device=device))


def _enc_block_init(key: prng.Key, cfg: EncDecConfig, device):
    k1, k2, k3 = prng.split(key, 3)
    return dict(**_norms(("attn", "mlp"), cfg.d_model, device),
                **_mlp_init(k1, k2, cfg, device), **_attn_params(k3, cfg, device))


def _dec_block_init(key: prng.Key, cfg: EncDecConfig, device):
    k1, k2, k3, k4 = prng.split(key, 4)
    return dict(**_norms(("self", "cross", "mlp"), cfg.d_model, device),
                **_mlp_init(k1, k2, cfg, device), **_attn_params(k3, cfg, device),
                **_attn_params(k4, cfg, device, prefix="c_"))


def _mlp_specs() -> Dict[str, ParamSpec]:
    return dict(w1=wspec("fsdp", "tensor"), b1=wspec("tensor"), w2=wspec("tensor", "fsdp"),
                b2=RSPEC)


def _enc_specs() -> Dict[str, ParamSpec]:
    return dict(attn_scale=RSPEC, attn_bias=RSPEC, mlp_scale=RSPEC, mlp_bias=RSPEC,
                **_mlp_specs(), **_attn_specs())


def _dec_specs() -> Dict[str, ParamSpec]:
    return dict(self_scale=RSPEC, self_bias=RSPEC, cross_scale=RSPEC, cross_bias=RSPEC,
                mlp_scale=RSPEC, mlp_bias=RSPEC, **_mlp_specs(), **_attn_specs(),
                **_attn_specs("c_"))


def init(key: prng.Key, cfg: EncDecConfig, device=None) -> Dict[str, Any]:
    """The reference's ``init(key, cfg)``: the same key tree (``split(key,
    4)``: encoder, decoder, embedding, head), so the same params within
    ``prng.normal``'s 4 ulp; f32 on ``device`` (the CPU by default)."""
    ke, kd, kt, kh = prng.split(key, 4)
    d = cfg.d_model
    return dict(
        embed=embed_init(kt, cfg.vocab, d, device=device),
        enc_blocks=init_layers(lambda k: _enc_block_init(k, cfg, device),
                               prng.split(ke, cfg.n_enc_layers)),
        dec_blocks=init_layers(lambda k: _dec_block_init(k, cfg, device),
                               prng.split(kd, cfg.n_dec_layers)),
        **_norms(("enc_norm", "dec_norm"), d, device),
        lm_head=dense_init(kh, d, cfg.vocab, device=device),
    )


def param_specs(cfg: EncDecConfig) -> Dict[str, Any]:
    return dict(
        embed=ParamSpec(storage=("fsdp", "tensor"), gathered=(None, "tensor")),
        enc_blocks=_enc_specs(),
        dec_blocks=_dec_specs(),
        enc_norm_scale=RSPEC, enc_norm_bias=RSPEC,
        dec_norm_scale=RSPEC, dec_norm_bias=RSPEC,
        lm_head=wspec("fsdp", "tensor"),
    )


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _heads(cfg: EncDecConfig, x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], n, cfg.hd)


def _out(cfg: EncDecConfig, w, o: torch.Tensor, prefix: str = "") -> torch.Tensor:
    b, s = o.shape[:2]
    return shard_hint(linear(o.reshape(b, s, cfg.n_heads * cfg.hd), w[prefix + "wo"]),
                      "batch", None, None)


def _mha(cfg: EncDecConfig, w, x, kv_x, q_pos, k_pos, causal: bool, prefix: str = ""):
    """Attention of ``x`` over ``kv_x`` (``x`` itself when None), without a
    cache; RoPE only on the causal (self) stream."""
    src = x if kv_x is None else kv_x
    q = _heads(cfg, linear(x, w[prefix + "wq"]), cfg.n_heads)
    k = _heads(cfg, linear(src, w[prefix + "wk"]), cfg.n_kv_heads)
    v = _heads(cfg, linear(src, w[prefix + "wv"]), cfg.n_kv_heads)
    if causal:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, k_pos, cfg.rope_theta)
    o = attn.attend(q, k, v, q_pos, k_pos, causal=causal)
    return _out(cfg, w, o, prefix), (k, v)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _ln(cfg: EncDecConfig, x, w, name: str):
    return layer_norm(x, w[name + "_scale"], w[name + "_bias"], cfg.norm_eps)


def _mlp(cfg: EncDecConfig, w, x):
    return gelu_mlp(_ln(cfg, x, w, "mlp"), w["w1"], w["b1"], w["w2"], w["b2"])


def _enc_block(cfg: EncDecConfig, w, x, pos):
    o, _ = _mha(cfg, w, _ln(cfg, x, w, "attn"), None, pos, pos, causal=False)
    x = x + o
    return x + _mlp(cfg, w, x)


def encode(cfg: EncDecConfig, params, frames, mat: Materializer) -> torch.Tensor:
    """frames [B, S_enc, D] -> encoder memory [B, S_enc, D]."""
    x = shard_hint(frames.float(), "batch", None, None)
    pos = _positions(x.shape[0], x.shape[1], x.device)
    x = scan_blocks(lambda c, w, i: _enc_block(cfg, w, c, pos), params["enc_blocks"], x, mat,
                    ENC_OPERANDS)
    return layer_norm(x, mat.leaf(params["enc_norm_scale"]), mat.leaf(params["enc_norm_bias"]),
                      cfg.norm_eps)


def _dec_final(cfg: EncDecConfig, params, x, mat: Materializer):
    return layer_norm(x, mat.leaf(params["dec_norm_scale"]), mat.leaf(params["dec_norm_bias"]),
                      cfg.norm_eps)


def decode_train(cfg: EncDecConfig, params, tokens, memory, mat: Materializer):
    """The decoder over a whole target sequence -> hidden states [B, S_dec, D]."""
    x = shard_hint(embed_lookup(params["embed"], tokens, mat), "batch", None, None)
    b, s = tokens.shape
    pos = _positions(b, s, x.device)
    mem_pos = _positions(b, memory.shape[1], x.device)

    def body(x_, w, i):
        o, _ = _mha(cfg, w, _ln(cfg, x_, w, "self"), None, pos, pos, causal=True)
        x_ = x_ + o
        o, _ = _mha(cfg, w, _ln(cfg, x_, w, "cross"), memory, pos, mem_pos, causal=False,
                    prefix="c_")
        x_ = x_ + o
        return x_ + _mlp(cfg, w, x_)

    return _dec_final(cfg, params, scan_blocks(body, params["dec_blocks"], x, mat), mat)


def loss(cfg: EncDecConfig, params, batch, mat: Materializer) -> torch.Tensor:
    """Mean next-token cross-entropy of the decoder over the encoded frames."""
    memory = encode(cfg, params, batch["frames"], mat)
    hidden = decode_train(cfg, params, batch["tokens"], memory, mat)
    return softmax_xent_chunked(hidden, mat.leaf(params["lm_head"]), batch["labels"],
                                batch.get("mask"))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_decode_state(cfg: EncDecConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device="cuda") -> Dict[str, Any]:
    """``max_len`` is the encoder's length: the cross K/V hold ``max_len``
    positions (``cross_pos`` -1 until prefill), the decoder's self cache
    ``max(max_len // dec_ratio, 8)`` slots; ``length`` is a host int."""
    dec_buf = max(max_len // cfg.dec_ratio, 8)
    cross = (cfg.n_dec_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return dict(
        self_kv=attn.init_cache(cfg.n_dec_layers, batch, dec_buf, cfg.n_kv_heads, cfg.hd,
                                dtype, device),
        cross_k=torch.zeros(cross, dtype=dtype, device=device),
        cross_v=torch.zeros(cross, dtype=dtype, device=device),
        cross_pos=torch.full(cross[:3], -1, dtype=torch.int32, device=device),
        length=0,
    )


def _state_hint(state):
    """The reference's layout: the self cache's, and the cross K/V's
    positions -> kv_seq, heads -> tensor."""
    return dict(
        self_kv=attn.cache_shard_hint(state["self_kv"]),
        cross_k=shard_hint(state["cross_k"], None, "batch", "kv_seq", "tensor", None),
        cross_v=shard_hint(state["cross_v"], None, "batch", "kv_seq", "tensor", None),
        cross_pos=shard_hint(state["cross_pos"], None, "batch", "kv_seq"),
        length=state["length"],
    )


def _head(cfg: EncDecConfig, params, x, mat: Materializer) -> torch.Tensor:
    x = _dec_final(cfg, params, x, mat)
    return shard_hint(x[:, -1:] @ mat.leaf(params["lm_head"]), "batch", None, "tensor")


def prefill(cfg: EncDecConfig, params, batch, mat: Materializer, state):
    """Encoder pass, each decoder layer's cross K/V from the memory (computed
    once; the reference computes them twice and XLA merges the two), and the
    decoder's prompt into a new self cache shaped like the state's, its first
    ``min(buf, S_dec)`` positions left-aligned -> (state', logits [B, 1, V])."""
    memory = encode(cfg, params, batch["frames"], mat)
    b, s_enc, _ = memory.shape
    tokens = batch["tokens"]
    s_dec = tokens.shape[1]
    x = shard_hint(embed_lookup(params["embed"], tokens, mat), "batch", None, None)
    pos = _positions(b, s_dec, x.device)
    mem_pos = _positions(b, s_enc, x.device)
    sk = state["self_kv"]
    buf, kv_dtype = sk.buf_len, sk.k.dtype
    new = attn.init_cache(cfg.n_dec_layers, b, buf, cfg.n_kv_heads, cfg.hd, kv_dtype, x.device)
    cross = (cfg.n_dec_layers, b, s_enc, cfg.n_kv_heads, cfg.hd)
    cks = torch.empty(cross, dtype=kv_dtype, device=x.device)
    cvs = torch.empty(cross, dtype=kv_dtype, device=x.device)
    t = min(buf, s_dec)
    for i in range(cfg.n_dec_layers):
        w = mat(stack_entry(params["dec_blocks"], i), operands=DEC_OPERANDS)
        o, (k, v) = _mha(cfg, w, _ln(cfg, x, w, "self"), None, pos, pos, causal=True)
        x = x + o
        h = _ln(cfg, x, w, "cross")
        ck = _heads(cfg, linear(memory, w["c_wk"]), cfg.n_kv_heads)
        cv = _heads(cfg, linear(memory, w["c_wv"]), cfg.n_kv_heads)
        q = _heads(cfg, linear(h, w["c_wq"]), cfg.n_heads)
        x = x + _out(cfg, w, attn.attend(q, ck, cv, pos, mem_pos, causal=False), "c_")
        x = x + _mlp(cfg, w, x)
        new.k[i, :, :t] = k[:, :t].to(kv_dtype)
        new.v[i, :, :t] = v[:, :t].to(kv_dtype)
        new.pos[i, :, :t] = pos[:, :t]
        cks[i], cvs[i] = ck.to(kv_dtype), cv.to(kv_dtype)
        del w
    new.length = s_dec
    new_state = _state_hint(dict(
        self_kv=new, cross_k=cks, cross_v=cvs,
        cross_pos=mem_pos.expand((cfg.n_dec_layers,) + mem_pos.shape).contiguous(),
        length=s_dec))
    return new_state, _head(cfg, params, x, mat)


def decode_step(cfg: EncDecConfig, params, state, tokens: torch.Tensor, mat: Materializer):
    """One new decoder token [B, 1] -> (state', logits [B, 1, V]).  Its self
    K/V are written into the state's cache in place (the returned state
    shares it); the cross K/V are read as prefill left them."""
    b = tokens.shape[0]
    x = shard_hint(embed_lookup(params["embed"], tokens, mat), "batch", None, None)
    position = state["length"]
    pos = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    sk = state["self_kv"]
    for i in range(cfg.n_dec_layers):
        w = mat(stack_entry(params["dec_blocks"], i), operands=DEC_OPERANDS)
        h = _ln(cfg, x, w, "self")
        q = apply_rope(_heads(cfg, linear(h, w["wq"]), cfg.n_heads), pos, cfg.rope_theta)
        k = apply_rope(_heads(cfg, linear(h, w["wk"]), cfg.n_kv_heads), pos, cfg.rope_theta)
        v = _heads(cfg, linear(h, w["wv"]), cfg.n_kv_heads)
        kc, vc, pc = attn.cache_insert(sk.k[i], sk.v[i], sk.pos[i], k, v, position, ring=False)
        x = x + _out(cfg, w, attn.decode_attend(q, kc, vc, pc, position))
        q = _heads(cfg, linear(_ln(cfg, x, w, "cross"), w["c_wq"]), cfg.n_heads)
        o = attn.decode_attend(q, state["cross_k"][i], state["cross_v"][i],
                               state["cross_pos"][i], position, causal=False)
        x = x + _out(cfg, w, o, "c_")
        x = x + _mlp(cfg, w, x)
        del w
    new_state = _state_hint(dict(
        self_kv=dataclasses.replace(sk, length=sk.length + 1), cross_k=state["cross_k"],
        cross_v=state["cross_v"], cross_pos=state["cross_pos"], length=position + 1))
    return new_state, _head(cfg, params, x, mat)
