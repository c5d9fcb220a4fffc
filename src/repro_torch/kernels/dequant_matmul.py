"""CUDA kernel for Hopper: the serve path's weight-stream matmul ``A @ (s·dec(W) + b)``.

Wrapper over ``csrc/dequant_matmul.cu`` (see its header for the design and
the bound).  Replaces the Pallas kernel
``repro/kernels/dequant_matmul.py::dequant_matmul``.

:func:`check_inputs` is the contract shared by the kernel and its plain
version (``ref.ref_dequant_matmul``): ``a`` f32 ``[M, K]``, ``codes``
``[K, N]`` in the format's container, both contiguous, and one ``(s, b)``
pair as one-element f32 tensors (a whole variable's 0-d scalars, or one
entry ``v[i]`` of a stacked leaf, shaped ``[1, 1]``).  ``s`` and ``b`` are
passed to the kernel by pointer, so a launch never syncs with the host.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import FloatFormat

from . import build
from .quantize import _stream

_INT_MAX = 2**31 - 1


def check_inputs(a: torch.Tensor, codes: torch.Tensor, fmt: FloatFormat, s: torch.Tensor,
                 b: torch.Tensor) -> None:
    """Raise ``ValueError`` on anything the kernel does not take."""
    if a.dtype != torch.float32 or a.ndim != 2 or not a.is_contiguous():
        raise ValueError(f"dequant_matmul: a must be a contiguous f32 [M, K] matrix, got "
                         f"{a.dtype} {tuple(a.shape)} (contiguous={a.is_contiguous()})")
    if codes.dtype != fmt.container_dtype or codes.ndim != 2 or not codes.is_contiguous():
        raise ValueError(f"dequant_matmul: codes must be a contiguous [K, N] matrix of "
                         f"{fmt.container_dtype} for {fmt.name}, got {codes.dtype} "
                         f"{tuple(codes.shape)} (contiguous={codes.is_contiguous()})")
    if a.shape[1] != codes.shape[0]:
        raise ValueError(f"dequant_matmul: a {tuple(a.shape)} and codes {tuple(codes.shape)} "
                         f"do not chain")
    for name, v in (("s", s), ("b", b)):
        if not isinstance(v, torch.Tensor) or v.dtype != torch.float32 or v.numel() != 1:
            raise ValueError(f"dequant_matmul: {name} must be one f32 value in a tensor")
    if max(a.shape[0], *codes.shape) > _INT_MAX or (a.shape[0] + 127) // 128 > 65535:
        raise ValueError(f"dequant_matmul: shape {tuple(a.shape)} x {tuple(codes.shape)} "
                         f"is too large")


def dequant_matmul(a: torch.Tensor, codes: torch.Tensor, fmt: FloatFormat, s: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """``a @ (s·decode(codes) + b)`` in f32 on the card, as ``s·(a @ decode(codes)) +
    b·rowsum(a)``."""
    if codes.device.type != "cuda":
        raise ValueError(f"dequant_matmul kernel needs CUDA tensors, got {codes.device}")
    check_inputs(a, codes, fmt, s, b)
    dev = codes.device
    for name, t in (("a", a), ("s", s), ("b", b)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    (m, k), n = a.shape, codes.shape[1]
    cb = fmt.container_bytes_per_value
    lib = build.load_library()
    # the weight-stream path (M <= 8) splits K and needs a scratch for the
    # splits' partial tiles and row sums; the tiled path needs none
    splits = lib.omc_dequant_matmul_splits(codes.data_ptr(), cb, m, k, n)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    partial = rowpart = None
    if splits:  # one allocation: the partial tiles [splits, m, n], then the row sums [splits, m]
        scratch = torch.empty(splits * m * (n + 1), dtype=torch.float32, device=dev)
        partial = scratch.data_ptr()
        rowpart = partial + 4 * splits * m * n
    rc = lib.omc_dequant_matmul(a.data_ptr(), codes.data_ptr(), cb, s.data_ptr(), b.data_ptr(),
                                out.data_ptr(), partial, rowpart, splits, m, k, n,
                                fmt.exp_bits, fmt.mant_bits, _stream(dev))
    build.check(rc, "dequant_matmul")
    return out


def dequant_matmul_moved_bytes(m: int, k: int, n: int, fmt: FloatFormat) -> int:
    """Least bytes the function moves: ``a`` and the codes read once, the
    output written once, and the (s, b) pair (the weight-stream path's
    scratch is the kernel's own traffic, not the function's)."""
    return 4 * m * k + fmt.container_bytes_per_value * k * n + 4 * m * n + 8


def dequant_matmul_flops(m: int, k: int, n: int) -> int:
    """f32 operations of the product: one multiply and one add per term."""
    return 2 * m * k * n
