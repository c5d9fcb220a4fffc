"""Per-Variable Transformation (paper §2.3), port of ``repro.core.pvt``.

After dequantization OMC applies an affine correction ``V̄ = s·Ṽ + b`` per
variable, with ``(s, b)`` the least-squares minimizer of ``‖s·Ṽ + b − V‖₂²``:

    s = (n·ΣVṼ − ΣV·ΣṼ) / (n·ΣṼ² − (ΣṼ)²)
    b = (ΣV − s·ΣṼ) / n

Degenerate case (constant Ṽ): s = 1, and b absorbs the mean error.

Two solvers, as in the reference: ``pvt_solve_fast`` (plain f32 sums,
optional batch axes; storage and transport) and ``pvt_solve`` (one
variable, sums accurate to about f64; the clients' quantize-dequantize
view).
"""

from __future__ import annotations

from typing import Tuple

import torch


def pvt_from_sums(sums: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form (s, b) from ``sums[..., 4] = [ΣV, ΣṼ, ΣVṼ, ΣṼ²]`` over n values.

    All arithmetic is f32, as in the reference.
    """
    s_v, s_q, s_vq, s_qq = sums.to(torch.float32).unbind(-1)
    nf = torch.tensor(float(n), dtype=torch.float32, device=sums.device)
    den = nf * s_qq - s_q * s_q
    num = nf * s_vq - s_v * s_q
    degenerate = den <= 0
    one = torch.ones_like(den)
    s = torch.where(degenerate, one, num / torch.where(degenerate, one, den))
    b = (s_v - s * s_q) / nf
    return s, b


_CHUNK = 1024


def _csum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a 1-D f32 tensor to about f64 accuracy, as an f32 0-d tensor.

    The reference (``repro.core.pvt._comp_sum``) takes f32 sums of 1024-value
    chunks, then a Neumaier-compensated cascade over the chunk sums, one
    chunk at a time.  A sequential cascade over the 17,408 chunks of a
    conformer_s leaf is far too slow on the card, so the chunk sums are added
    in float64 instead, which is exact to well below f32 resolution for any
    count of chunks a model has.  Both results round the chunk sums' exact
    total to f32 (up to an ulp); the chunk sums themselves differ from the
    reference's by the order of the f32 reduction inside a chunk.
    """
    pad = (-x.numel()) % _CHUNK
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.reshape(-1, _CHUNK).sum(1).to(torch.float64).sum().to(torch.float32)


def pvt_solve(v: torch.Tensor, v_tilde: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve (s, b) minimizing ‖s·Ṽ + b − V‖₂² over the whole tensor (0-d f32)."""
    vf = v.reshape(-1).to(torch.float32)
    qf = v_tilde.reshape(-1).to(torch.float32)
    sums = torch.stack([_csum(vf), _csum(qf), _csum(vf * qf), _csum(qf * qf)])
    return pvt_from_sums(sums, vf.numel())


def pvt_solve_fast(
    v: torch.Tensor, v_tilde: torch.Tensor, batch_axes: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PVT solve with plain f32 sums, optional leading batch axes.

    With ``batch_axes=k`` the leading k axes are independent variables
    (stacked layers) and s, b come back with shape
    ``v.shape[:k] + (1,) * (v.ndim - k)``; with k = 0 they are 0-d.
    """
    vf = v.to(torch.float32)
    qf = v_tilde.to(torch.float32)
    axes = tuple(range(batch_axes, vf.ndim))
    n = 1
    for a in axes:
        n *= vf.shape[a]
    if axes:
        sums = torch.stack([vf.sum(axes), qf.sum(axes), (vf * qf).sum(axes),
                            (qf * qf).sum(axes)], dim=-1)
    else:
        sums = torch.stack([vf, qf, vf * qf, qf * qf], dim=-1)
    s, b = pvt_from_sums(sums, n)
    shape = vf.shape[:batch_axes] + (1,) * (vf.ndim - batch_axes) if batch_axes else ()
    return s.reshape(shape), b.reshape(shape)


def pvt_apply(v_tilde: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """V̄ = s·Ṽ + b (s, b broadcast against Ṽ), multiply then add, unfused."""
    return v_tilde * s + b
