"""Conformer encoder — the paper's own model family (§3.1), port of
``repro.models.conformer``.

Block = ½·FFN → MHSA (RoPE, causal and windowed for the streaming variant)
→ conv module (pointwise-GLU → depthwise causal conv → GroupNorm → swish →
pointwise) → ½·FFN → LayerNorm.  The audio frontend is a stub:
``batch["frames"]`` carries frame embeddings ``[B, S, d_in]``; the objective
is framewise cross-entropy against ``batch["labels"]``.  The backward pass
is autograd's.  Parameters are nested dicts keyed like the reference's, so
its trees carry across as numpy (``repro_torch.interop``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from . import attention as attn
from .common import (
    RSPEC,
    Materializer,
    ParamSpec,
    apply_rope,
    dense_init,
    group_norm,
    layer_norm,
    scan_blocks,
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


def init(gen: torch.Generator, cfg: ConformerConfig) -> Dict[str, Any]:
    """Random f32 params on ``gen.device``, block leaves stacked on a layer axis.

    Same shapes and scales as the reference's init, not its numbers (those
    come from ``jax.random``; tests carry them across instead)."""
    dev = gen.device
    d, f, L = cfg.d_model, cfg.d_ff, (cfg.n_layers,)

    def ones(*shape):
        return torch.ones(L + shape, device=dev)

    def zeros(*shape):
        return torch.zeros(L + shape, device=dev)

    def ffn():
        return dict(scale=ones(d), bias=zeros(d), w1=dense_init(gen, d, f, layers=L),
                    b1=zeros(f), w2=dense_init(gen, f, d, layers=L), b2=zeros(d))

    blocks = dict(
        ffn1=ffn(),
        attn_scale=ones(d), attn_bias=zeros(d),
        wq=dense_init(gen, d, d, layers=L), wk=dense_init(gen, d, d, layers=L),
        wv=dense_init(gen, d, d, layers=L), wo=dense_init(gen, d, d, layers=L),
        conv_scale=ones(d), conv_bias=zeros(d),
        conv_pw1=dense_init(gen, d, 2 * d, layers=L),
        conv_dw=torch.randn(L + (cfg.conv_kernel, d), generator=gen, device=dev).mul_(0.1),
        conv_gn_scale=ones(d), conv_gn_bias=zeros(d),
        conv_pw2=dense_init(gen, d, d, layers=L),
        ffn2=ffn(),
        out_scale=ones(d), out_bias=zeros(d),
    )
    return dict(
        in_proj=dense_init(gen, cfg.d_in, d),
        in_bias=torch.zeros((d,), device=dev),
        blocks=blocks,
        out_proj=dense_init(gen, d, cfg.n_classes),
        out_bias=torch.zeros((cfg.n_classes,), device=dev),
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
    # depthwise conv: the k shifted products as one windowed product and a sum
    # over the taps (the reference adds them one by one; a cuDNN convolution
    # would run in TF32 by default)
    acc = (hp.unfold(1, k, 1) * w["conv_dw"].T).sum(-1)  # [B, S, D, k] -> [B, S, D]
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


def forward(cfg: ConformerConfig, params, batch, mat: Materializer) -> torch.Tensor:
    frames = batch["frames"].float()
    x = frames @ mat.leaf(params["in_proj"]) + mat.leaf(params["in_bias"])
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    return scan_blocks(lambda carry, w: _block_apply(cfg, w, carry, positions),
                       params["blocks"], x, mat)


def loss(cfg: ConformerConfig, params, batch, mat: Materializer) -> torch.Tensor:
    """Framewise cross-entropy; ``out_bias`` enters as an extra row of the
    head against a ones column of the hidden state, as in the reference."""
    hidden = forward(cfg, params, batch, mat)
    head = mat.leaf(params["out_proj"])
    bias = mat.leaf(params["out_bias"])
    b, s, _ = hidden.shape
    hidden_aug = torch.cat([hidden, torch.ones((b, s, 1), dtype=hidden.dtype,
                                               device=hidden.device)], -1)
    head_aug = torch.cat([head, bias[None, :]], 0)
    return softmax_xent_chunked(hidden_aug, head_aug, batch["labels"], batch.get("mask"))
