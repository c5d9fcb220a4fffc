"""Conformer encoder — the paper's own model family (§3.1), port of
``repro.models.conformer``.

Block = ½·FFN → MHSA (RoPE, causal and windowed for the streaming variant)
→ conv module (pointwise-GLU → depthwise causal conv → GroupNorm → swish →
pointwise) → ½·FFN → LayerNorm.  The audio frontend is a stub:
``batch["frames"]`` carries frame embeddings ``[B, S, d_in]``; the objective
is framewise cross-entropy against ``batch["labels"]``.  The backward pass
is autograd's.  Parameters are nested dicts keyed like the reference's, so
its trees carry across as numpy (``repro_torch.interop``).  ``loss_clients``
is ``loss`` of C clients at once, each with its own parameters and batch
(the reference ``vmap``s ``loss`` over a cohort): the stem and the head
under ``torch.func.vmap``, each layer under a checkpoint around a vmapped
block (``common.scan_blocks_clients``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import prng

from . import attention as attn
from .common import (
    IDENTITY_MAT,
    RSPEC,
    Materializer,
    ParamSpec,
    apply_rope,
    as_f32,
    dense_init,
    group_norm,
    init_layers,
    layer_norm,
    scan_blocks,
    scan_blocks_clients,
    softmax_xent_chunked,
    wspec,
)


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int
    d_in: int = 80
    conv_kernel: int = 8
    gn_groups: int = 4
    window: Optional[int] = None  # not None -> streaming variant
    causal_conv: bool = True
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        d, f = self.d_model, self.d_ff
        ffn = d * f + f + f * d + d + 2 * d
        att = 4 * d * d + 2 * d
        conv = d * 2 * d + self.conv_kernel * d + d * d + 4 * d + 2 * d
        blk = 2 * ffn + att + conv + 2 * d
        return self.n_layers * blk + self.d_in * d + d + d * self.n_classes + self.n_classes


def _block_init(key: prng.Key, cfg: ConformerConfig, device) -> Dict[str, Any]:
    """One block, drawn from the reference's keys: ``split(key, 10)``, with
    ``ks[0]`` drawn again for ``ffn2``'s ``w2`` as the reference draws it."""
    ks = prng.split(key, 10)
    d, f = cfg.d_model, cfg.d_ff

    def ones(n):
        return torch.ones((n,), device=device)

    def zeros(n):
        return torch.zeros((n,), device=device)

    def ffn(k1, k2):
        return dict(scale=ones(d), bias=zeros(d), w1=dense_init(k1, d, f, device=device),
                    b1=zeros(f), w2=dense_init(k2, f, d, device=device), b2=zeros(d))

    return dict(
        ffn1=ffn(ks[0], ks[1]),
        attn_scale=ones(d), attn_bias=zeros(d),
        wq=dense_init(ks[2], d, d, device=device), wk=dense_init(ks[3], d, d, device=device),
        wv=dense_init(ks[4], d, d, device=device), wo=dense_init(ks[5], d, d, device=device),
        conv_scale=ones(d), conv_bias=zeros(d),
        conv_pw1=dense_init(ks[6], d, 2 * d, device=device),
        conv_dw=prng.normal(ks[7], (cfg.conv_kernel, d), device).mul_(as_f32(0.1)),
        conv_gn_scale=ones(d), conv_gn_bias=zeros(d),
        conv_pw2=dense_init(ks[8], d, d, device=device),
        ffn2=ffn(ks[9], ks[0]),
        out_scale=ones(d), out_bias=zeros(d),
    )


def init(key: prng.Key, cfg: ConformerConfig, device=None) -> Dict[str, Any]:
    """The reference's ``init(key, cfg)``: the same key tree (``split(key,
    3)``, one key a block), so the same params within ``prng.normal``'s 4
    ulp; f32 on ``device`` (the CPU by default), block leaves stacked on a
    layer axis."""
    kb, ki, ko = prng.split(key, 3)
    d = cfg.d_model
    return dict(
        in_proj=dense_init(ki, cfg.d_in, d, device=device),
        in_bias=torch.zeros((d,), device=device),
        blocks=init_layers(lambda k: _block_init(k, cfg, device),
                           prng.split(kb, cfg.n_layers)),
        out_proj=dense_init(ko, d, cfg.n_classes, device=device),
        out_bias=torch.zeros((cfg.n_classes,), device=device),
    )


def _ffn_specs():
    return dict(scale=RSPEC, bias=RSPEC, w1=wspec("fsdp", "tensor"),
                b1=wspec("tensor"), w2=wspec("tensor", "fsdp"), b2=RSPEC)


def block_specs(cfg: ConformerConfig) -> Dict[str, Any]:
    return dict(
        ffn1=_ffn_specs(),
        attn_scale=RSPEC, attn_bias=RSPEC,
        wq=wspec("fsdp", "tensor"), wk=wspec("fsdp", "tensor"),
        wv=wspec("fsdp", "tensor"), wo=wspec("tensor", "fsdp"),
        conv_scale=RSPEC, conv_bias=RSPEC,
        conv_pw1=wspec("fsdp", "tensor"),
        conv_dw=ParamSpec(storage=(None, "tensor"), gathered=(None, "tensor")),
        conv_gn_scale=RSPEC, conv_gn_bias=RSPEC,
        conv_pw2=wspec("tensor", "fsdp"),
        ffn2=_ffn_specs(),
        out_scale=RSPEC, out_bias=RSPEC,
    )


def param_specs(cfg: ConformerConfig) -> Dict[str, Any]:
    return dict(
        in_proj=wspec("fsdp", None), in_bias=RSPEC,
        blocks=block_specs(cfg),
        out_proj=wspec("fsdp", "tensor"), out_bias=wspec("tensor"),
    )


def _half_ffn(x, p, eps):
    h = layer_norm(x, p["scale"], p["bias"], eps)
    h = F.silu(h @ p["w1"] + p["b1"])
    return x + 0.5 * (h @ p["w2"] + p["b2"])


def _conv_module(cfg: ConformerConfig, w, x):
    h = layer_norm(x, w["conv_scale"], w["conv_bias"], cfg.norm_eps)
    a, g = (h @ w["conv_pw1"]).chunk(2, dim=-1)
    h = a * torch.sigmoid(g)  # GLU
    k, s = cfg.conv_kernel, x.shape[1]
    left = k - 1 if cfg.causal_conv else (k - 1) // 2
    hp = F.pad(h, (0, 0, left, k - 1 - left))
    # depthwise conv: the k shifted windows stacked on a leading tap axis,
    # times the taps, summed over that axis (on the CPU tap by tap: the
    # reference's order).  A cuDNN convolution would run in TF32 by default;
    # unfold's backward has no batching rule under vmap; slices and stack
    # do, and with the tap axis leading the vmapped backward stays fast.
    win = torch.stack([hp[:, i:i + s] for i in range(k)])  # [k, B, S, D]
    acc = (win * w["conv_dw"][:, None, None, :]).sum(0)
    h = group_norm(acc, w["conv_gn_scale"], w["conv_gn_bias"], cfg.gn_groups, cfg.norm_eps)
    return x + F.silu(h) @ w["conv_pw2"]


def _block_apply(cfg: ConformerConfig, w, x, positions):
    b, s, d = x.shape
    x = _half_ffn(x, w["ffn1"], cfg.norm_eps)
    h = layer_norm(x, w["attn_scale"], w["attn_bias"], cfg.norm_eps)
    q = (h @ w["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
    k = (h @ w["wk"]).reshape(b, s, cfg.n_heads, cfg.hd)
    v = (h @ w["wv"]).reshape(b, s, cfg.n_heads, cfg.hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    causal = cfg.window is not None  # the streaming variant is causal and windowed
    o = attn.attend(q, k, v, positions, positions, causal=causal, window=cfg.window)
    x = x + o.reshape(b, s, d) @ w["wo"]
    x = _conv_module(cfg, w, x)
    x = _half_ffn(x, w["ffn2"], cfg.norm_eps)
    return layer_norm(x, w["out_scale"], w["out_bias"], cfg.norm_eps)


STEM = ("in_proj", "in_bias")
HEAD = ("out_proj", "out_bias")


def _stem(params, batch, mat: Materializer) -> torch.Tensor:
    frames = batch["frames"].float()
    return frames @ mat.leaf(params["in_proj"]) + mat.leaf(params["in_bias"])


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[-3:-1]
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def _head_loss(params, hidden, batch, mat: Materializer) -> torch.Tensor:
    """Framewise cross-entropy; ``out_bias`` enters as an extra row of the
    head against a ones column of the hidden state, as in the reference."""
    head = mat.leaf(params["out_proj"])
    bias = mat.leaf(params["out_bias"])
    b, s, _ = hidden.shape
    hidden_aug = torch.cat([hidden, torch.ones((b, s, 1), dtype=hidden.dtype,
                                               device=hidden.device)], -1)
    head_aug = torch.cat([head, bias[None, :]], 0)
    return softmax_xent_chunked(hidden_aug, head_aug, batch["labels"], batch.get("mask"))


def forward(cfg: ConformerConfig, params, batch, mat: Materializer) -> torch.Tensor:
    x = _stem(params, batch, mat)
    positions = _positions(x)
    return scan_blocks(lambda carry, w, _: _block_apply(cfg, w, carry, positions),
                       params["blocks"], x, mat)


def loss(cfg: ConformerConfig, params, batch, mat: Materializer) -> torch.Tensor:
    """Framewise cross-entropy of :func:`forward`'s hidden states."""
    return _head_loss(params, forward(cfg, params, batch, mat), batch, mat)


def loss_clients(cfg: ConformerConfig, params, batch) -> torch.Tensor:
    """:func:`loss` of C clients, ``[C]``: every leaf of ``params`` (f32) and
    every tensor of ``batch`` carries a leading client axis."""
    x = torch.func.vmap(lambda p, bt: _stem(p, bt, IDENTITY_MAT))(
        {k: params[k] for k in STEM}, batch)
    positions = _positions(x)
    x = scan_blocks_clients(lambda carry, w, _: _block_apply(cfg, w, carry, positions),
                            params["blocks"], x)
    return torch.func.vmap(lambda p, h, bt: _head_loss(p, h, bt, IDENTITY_MAT))(
        {k: params[k] for k in HEAD}, x, batch)
