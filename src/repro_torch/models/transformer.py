"""Dense decoder-only transformer LM with GQA (port of ``repro.models.transformer``).

Training (``forward``/``loss``: the token stream through ``scan_blocks``,
each layer decoded inside its ``checkpoint``, and the chunked cross-entropy
against the head) and serving (``prefill`` and ``decode_step`` against a KV
cache), over any parameter tree a
:class:`~repro_torch.models.common.Materializer` turns into compute weights
(the identity for f32 params, ``OMCMaterializer`` for OMC storage and for
the training round's ``QParam`` tree).  A config with ``prefix_embeds >
0`` is the VLM (internvl2-1b): ``batch["patches"]``, the stubbed vision
frontend's precomputed embeddings, are prepended to the token rows and
carry no next-token target.  A config whose windows differ between layers
(``swa_every > 1``) runs each layer with its own window.  ``loss_clients``
is ``loss`` of C clients at once, each with its own parameters and batch:
the embedding and the head under ``torch.func.vmap``, each layer under a
checkpoint around a vmapped block (``common.scan_blocks_clients``).

When serving, the stacked block parameters are consumed by a Python loop
over layers.  The seven block matrices of a layer (``OPERANDS``) go through
``common.linear``: over OMC storage each streams its codes through the
``dequant_matmul`` kernel.  The tied head stays ``x @ dec(E).T``, a decode
and a matmul, as the reference computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import prng

from . import attention as attn
from .common import (
    IDENTITY_MAT,
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
    scan_blocks_clients,
    shard_hint,
    softmax_xent_chunked,
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
    window: Optional[int] = None  # sliding-window attention (mistral family)
    swa_every: int = 1  # 1 = every layer windowed; n>1: 1 in n full attention
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # Frontend stubs (vlm/audio): number of pre-embedded positions prepended
    # to the token stream; their embeddings arrive via batch["patches"].
    prefix_embeds: int = 0
    # The reference's sequence-sharded residual stream (Megatron-SP): a
    # layout hint, the identity on one card.
    sp_residuals: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    def layer_window(self, layer_idx: int) -> Optional[int]:
        if self.window is None:
            return None
        if self.swa_every <= 1:
            return self.window
        return None if (layer_idx % self.swa_every == self.swa_every - 1) else self.window

    @property
    def uniform_window(self) -> Optional[int]:
        """The window if it is the same in every layer, else None."""
        ws = {self.layer_window(i) for i in range(self.n_layers)}
        return None if len(ws) > 1 else next(iter(ws))

    def param_count(self) -> int:
        """The reference's count (``transformer.py:92-98``): the init's leaf
        sizes summed, a tied head counted once."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        per_layer = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d + 3 * d * f + 2 * d
        if self.qkv_bias:
            per_layer += self.q_dim + 2 * self.kv_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d


# ---------------------------------------------------------------------------
# init / specs
# ---------------------------------------------------------------------------


def _block_init(key: prng.Key, cfg: TransformerConfig, device) -> Dict[str, Any]:
    """One block from ``split(key, 6)``; ``ks[4]`` draws ``w1`` and, again,
    ``w2``, as the reference draws them."""
    ks = prng.split(key, 6)
    d, f = cfg.d_model, cfg.d_ff
    p = dict(
        attn_norm=torch.ones((d,), device=device),
        wq=dense_init(ks[0], d, cfg.q_dim, device=device),
        wk=dense_init(ks[1], d, cfg.kv_dim, device=device),
        wv=dense_init(ks[2], d, cfg.kv_dim, device=device),
        wo=dense_init(ks[3], cfg.q_dim, d, device=device),
        mlp_norm=torch.ones((d,), device=device),
        w1=dense_init(ks[4], d, f, device=device),
        w3=dense_init(ks[5], d, f, device=device),
        w2=dense_init(ks[4], f, d, device=device),
    )
    if cfg.qkv_bias:
        p.update(bq=torch.zeros((cfg.q_dim,), device=device),
                 bk=torch.zeros((cfg.kv_dim,), device=device),
                 bv=torch.zeros((cfg.kv_dim,), device=device))
    return p


def init(key: prng.Key, cfg: TransformerConfig, device=None) -> Dict[str, Any]:
    """The reference's ``init(key, cfg)``: the same key tree (``split(key,
    3)``, one key a block), so the same params within ``prng.normal``'s 4
    ulp; f32 on ``device`` (the CPU by default), block leaves stacked on a
    layer axis."""
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
# training: forward and loss
# ---------------------------------------------------------------------------


def _res_hint(x, cfg: TransformerConfig):
    seq = "seq" if (cfg.sp_residuals and x.shape[1] > 1) else None
    return shard_hint(x, "batch", seq, None)


def _block_apply(cfg: TransformerConfig, w, x, positions, window):
    """One decoder block (pre-norm GQA attention + SwiGLU MLP)."""
    b, s, _ = x.shape
    h = rms_norm(x, w["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(w, h, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attn.attend(q, k, v, positions, positions, causal=True, window=window)
    x = _res_hint(x + linear(o.reshape(b, s, cfg.q_dim), w["wo"]), cfg)
    h = rms_norm(x, w["mlp_norm"], cfg.norm_eps)
    return _res_hint(x + swiglu(h, w["w1"], w["w3"], w["w2"]), cfg)


def _input_embeds(cfg: TransformerConfig, params, batch, mat: Materializer):
    """Token rows, after the modality prefix when ``prefix_embeds > 0``
    (``batch["patches"]``, precomputed) -> (x [B, S, D], positions [B, S])."""
    tokens = batch["tokens"]
    b = tokens.shape[0]
    x = embed_lookup(params["embed"], tokens, mat)
    if cfg.prefix_embeds:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    x = _res_hint(x, cfg)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    return x, positions


def forward(cfg: TransformerConfig, params, batch, mat: Materializer) -> torch.Tensor:
    """Token stream (after any prefix) -> final hidden states [B, S, D]
    (pre-head), each layer with its own window (``cfg.layer_window``)."""
    x, positions = _input_embeds(cfg, params, batch, mat)
    x = scan_blocks(lambda carry, w, i: _block_apply(cfg, w, carry, positions,
                                                     cfg.layer_window(i)),
                    params["blocks"], x, mat)
    return rms_norm(x, mat.leaf(params["final_norm"]), cfg.norm_eps)


def loss(cfg: TransformerConfig, params, batch, mat: Materializer) -> torch.Tensor:
    """Mean next-token cross-entropy (over ``batch["mask"]`` where given);
    the prefix positions carry no target."""
    return _xent(cfg, params, forward(cfg, params, batch, mat), batch, mat)


def loss_clients(cfg: TransformerConfig, params, batch) -> torch.Tensor:
    """:func:`loss` of C clients, ``[C]``: every leaf of ``params`` (f32) and
    every tensor of ``batch`` carries a leading client axis."""
    embed = {"embed": params["embed"]}
    x = torch.func.vmap(lambda p, bt: _input_embeds(cfg, p, bt, IDENTITY_MAT)[0])(embed, batch)
    b, s = x.shape[1:3]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x = scan_blocks_clients(lambda carry, w, i: _block_apply(cfg, w, carry, positions,
                                                             cfg.layer_window(i)),
                            params["blocks"], x)
    head = {k: params[k] for k in ("final_norm", "embed", "lm_head") if k in params}

    def head_loss(p, h, bt):
        hidden = rms_norm(h, p["final_norm"], cfg.norm_eps)
        return _xent(cfg, p, hidden, bt, IDENTITY_MAT)

    return torch.func.vmap(head_loss)(head, x, batch)


def _xent(cfg: TransformerConfig, params, hidden, batch, mat: Materializer) -> torch.Tensor:
    labels, mask = batch["labels"], batch.get("mask")
    if cfg.prefix_embeds:
        b = labels.shape[0]
        labels = torch.cat([labels.new_zeros((b, cfg.prefix_embeds)), labels], dim=1)
        if mask is None:
            mask = torch.ones(batch["labels"].shape, dtype=torch.float32, device=labels.device)
        mask = torch.cat([torch.zeros((b, cfg.prefix_embeds), dtype=torch.float32,
                                      device=labels.device), mask.float()], dim=1)
    return softmax_xent_chunked(hidden, _head_weight(cfg, params, mat), labels, mask)


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
    """Run the prompt (after any prefix), fill a new cache shaped like
    ``cache``, return the logits of the last position [B, 1, V].  Every
    layer attends with ``cfg.uniform_window``, as the reference's prefill
    does (None, full attention, when the windows are mixed)."""
    x, positions = _input_embeds(cfg, params, batch, mat)
    b, s = positions.shape
    window = cfg.uniform_window
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
        o = attn.attend(q, k, v, positions, positions, causal=True, window=window)
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
    return attn.cache_shard_hint(new), x[:, -1:] @ _head_weight(cfg, params, mat)


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
    return (attn.cache_shard_hint(dataclasses.replace(cache, length=position + 1)),
            x @ _head_weight(cfg, params, mat))
