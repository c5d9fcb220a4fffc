"""CUDA kernel for Hopper: the serve path's weight-stream matmul ``A @ (s·dec(W) + b)``.

Wrapper over ``csrc/dequant_matmul.cu`` (see its header for the design and
the bound).  Replaces the Pallas kernel
``repro/kernels/dequant_matmul.py::dequant_matmul``.  One launch per
product, on one of two paths the kernel picks from the shape:

  * the weight stream (M <= 8, N a whole number of code vectors): the codes
    stream through a cp.async ring in shared memory and are decoded by a
    branch-free decode; K is split over warps and a thread-block cluster,
    and the splits are summed in a fixed order inside the launch;
  * the tile (everything else, e.g. prefill at M = 128): 128 x 88 output
    tiles on the tensor cores (wgmma, TF32), with A split into two TF32
    halves so that the product is f32-accurate ("2xTF32"; a third pass for
    formats whose decoded values are not exact in TF32).

:func:`kernel_variant` states the kernel's choice of its compile-time
format and of the tile path's passes, which the C entry makes from the
format itself (``variant`` in the source; :func:`plan` reports it, and the
tests on the card hold the two against each other).  The wrapper allocates
only the output: the kernel needs no scratch.

:func:`check_inputs` is the contract shared by the kernel and its plain
version (``ref.ref_dequant_matmul``): ``a`` f32 ``[M, K]``, ``codes``
``[K, N]`` in the format's container, both contiguous, and one ``(s, b)``
pair as one-element f32 tensors (a whole variable's 0-d scalars, or one
entry ``v[i]`` of a stacked leaf, shaped ``[1, 1]``).  ``s`` and ``b`` are
passed to the kernel by pointer, so a launch never syncs with the host.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.formats import FloatFormat

from . import build
from .quantize import _stream

_INT_MAX = 2**31 - 1
TILE_M = 128  # rows of A one tile of the tile path takes (grid z counts them)
_GRID_Z_MAX = 65535

CODEC_RUNTIME = 0  # the kernel reads the format's fields at run time
CODEC_S1E3M7 = 1  # the serve format, compiled in (u16)
_COMPILED = {(3, 7): CODEC_S1E3M7}
TF32_MANT_BITS = 10  # mantissa bits TF32 keeps


def tf32_exact(fmt: FloatFormat) -> bool:
    """Whether every decoded value of ``fmt`` is exact in TF32 (its f32
    pattern's low 13 bits are zero): at most 10 mantissa bits."""
    return fmt.mant_bits <= TF32_MANT_BITS


def kernel_variant(fmt: FloatFormat) -> Tuple[int, int]:
    """``(codec, passes)`` the kernel takes for ``fmt``: the compile-time
    format it decodes with (``CODEC_S1E3M7`` or ``CODEC_RUNTIME``), and the
    TF32 passes of the tile path: 2 (``A_hi@dec + A_lo@dec``) where the
    decoded weight is exact in TF32, else 3 (``+ A_hi@dec_lo``).  The rule
    of ``variant`` in ``csrc/dequant_matmul.cu``, which decides."""
    return _COMPILED.get((fmt.exp_bits, fmt.mant_bits), CODEC_RUNTIME), (
        2 if tf32_exact(fmt) else 3)


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
    if (max(a.shape[0], *codes.shape) > _INT_MAX
            or -(-a.shape[0] // TILE_M) > _GRID_Z_MAX):
        raise ValueError(f"dequant_matmul: shape {tuple(a.shape)} x {tuple(codes.shape)} "
                         f"is too large")


def _check_device(a, codes, s, b) -> torch.device:
    if codes.device.type != "cuda":
        raise ValueError(f"dequant_matmul kernel needs CUDA tensors, got {codes.device}")
    dev = codes.device
    for name, t in (("a", a), ("s", s), ("b", b)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    return dev


def dequant_matmul(a: torch.Tensor, codes: torch.Tensor, fmt: FloatFormat, s: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """``a @ (s·decode(codes) + b)`` in f32 on the card, as ``s·(a @ decode(codes)) +
    b·rowsum(a)``."""
    dev = _check_device(a, codes, s, b)
    check_inputs(a, codes, fmt, s, b)
    (m, k), n = a.shape, codes.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    rc = build.load_library().omc_dequant_matmul(
        a.data_ptr(), codes.data_ptr(), fmt.container_bytes_per_value, s.data_ptr(),
        b.data_ptr(), out.data_ptr(), m, k, n, fmt.exp_bits, fmt.mant_bits, _stream(dev))
    build.check(rc, "dequant_matmul")
    return out


def plan(a: torch.Tensor, codes: torch.Tensor, fmt: FloatFormat) -> dict:
    """The path, grid and variant the kernel takes for this product (on the
    card): ``{"path": "stream" | "tile", "grid": (x, cluster, z), "codec":
    c, "passes": p}``, z the code vectors per warp row (stream) or the row
    tiles (tile), ``(c, p)`` as :func:`kernel_variant` states them."""
    (m, k), n = a.shape, codes.shape[1]
    out = (ctypes.c_int * 5)()
    path = build.load_library().omc_dequant_matmul_plan(
        a.data_ptr(), codes.data_ptr(), fmt.container_bytes_per_value, fmt.exp_bits,
        fmt.mant_bits, m, k, n, ctypes.addressof(out))
    return dict(path="stream" if path == 1 else "tile", grid=tuple(out[:3]), codec=out[3],
                passes=out[4])


def dequant_matmul_moved_bytes(m: int, k: int, n: int, fmt: FloatFormat) -> int:
    """Least bytes the function moves: ``a`` and the codes read once, the
    output written once, and the (s, b) pair."""
    return 4 * m * k + fmt.container_bytes_per_value * k * n + 4 * m * n + 8


def dequant_matmul_flops(m: int, k: int, n: int) -> int:
    """f32 operations of the product: one multiply and one add per term."""
    return 2 * m * k * n
