"""Compressed parameter storage (paper Fig. 1), port of ``repro.core.store``.

``CompressedVariable`` holds one variable in OMC storage form: the minifloat
bitfield codes in the smallest uint container (the resident form on the
device), plus the per-variable transformation scalars ``s, b`` — 0-d for a
single variable, ``[L, 1, ...]`` for a stack of L independent entries.
``compress_tree`` is the storage-mode compression of a whole tree under a
policy; ``tree_bytes_report`` the byte accounting behind the paper's
"parameter memory / communication" columns.
``pack_for_transport`` / ``unpack_from_transport`` are one variable's exact
wire form, through the ``pack`` / ``unpack`` kernels for CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from . import packing
from .formats import SIGNED_TWIN, FloatFormat
from .policy import QuantizePolicy, path_str
from .pvt import pvt_from_sums
from .tree import tree_items, tree_map, tree_map_with_path


@dataclasses.dataclass
class CompressedVariable:
    """One variable in OMC storage form."""

    codes: torch.Tensor  # uint container, original shape
    s: torch.Tensor  # f32 PVT scale: 0-d, or [L, 1, ...] for stacked entries
    b: torch.Tensor  # f32 PVT bias, same shape as s
    fmt: FloatFormat

    @property
    def size(self) -> int:
        return self.codes.numel()

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def __getitem__(self, index) -> "CompressedVariable":
        """Index the stacked leading axis (codes, s and b together)."""
        if self.s.ndim == 0:
            raise IndexError("a single (unstacked) variable has no entry axis")
        return CompressedVariable(self.codes[index], self.s[index], self.b[index], self.fmt)

    def unbind(self, dim: int = 0):
        """The entries of the stacked leading axis, as ``tensor.unbind(0)``
        gives a tensor's (views of codes, s and b; ``dim`` must be 0)."""
        if dim != 0:
            raise ValueError("a CompressedVariable unbinds only its leading axis")
        return [self[i] for i in range(self.codes.shape[0])]

    def rows(self, index: torch.Tensor) -> "CompressedVariable":
        """Gather rows of a single variable; decode and affine are elementwise
        with scalar (s, b), so decoding the gathered rows equals gathering the
        decoded table, bit for bit."""
        if self.s.ndim != 0:
            raise ValueError("rows() needs a single variable with scalar (s, b)")
        # gather through the signed twin: indexing kernels cover every signed dtype
        twin = SIGNED_TWIN.get(self.codes.dtype, self.codes.dtype)
        codes = self.codes.view(twin)[index].view(self.codes.dtype)
        return CompressedVariable(codes, self.s, self.b, self.fmt)

    def to(self, device) -> "CompressedVariable":
        return CompressedVariable(self.codes.to(device), self.s.to(device),
                                  self.b.to(device), self.fmt)

    def dequantize(self) -> torch.Tensor:
        from repro_torch.kernels import ops  # deferred: kernels imports core

        return ops.dequantize(self.codes, self.fmt, self.s, self.b)


def compress_variable(
    v: torch.Tensor, fmt: FloatFormat, *, pvt: bool = True, batch_axes: int = 0,
) -> CompressedVariable:
    """Quantize one variable to OMC storage form in one fused pass.

    ``batch_axes > 0`` treats the leading axes as stacked independent
    variables: (s, b) are solved per entry.  With ``pvt`` the codes and the
    four PVT sums come from one ``quantize_stats`` launch and (s, b) from the
    closed form on those plain f32 sums — the reference's ``fast=True``
    solver, which its ``compress_params`` and transport use.  Without it the
    ``quantize`` kernel writes the codes alone and (s, b) = (1, 0).
    """
    from repro_torch.kernels import ops  # deferred: kernels imports core

    lead = tuple(v.shape[:batch_axes])
    if pvt:
        codes, sums = ops.quantize_stats(v, fmt, batch_axes)
        s, b = pvt_from_sums(sums, math.prod(v.shape[batch_axes:]))
    else:
        codes = ops.quantize(v, fmt)
        s = torch.ones(lead, dtype=torch.float32, device=v.device)
        b = torch.zeros(lead, dtype=torch.float32, device=v.device)
    shape = lead + (1,) * (v.ndim - batch_axes) if batch_axes else ()
    return CompressedVariable(codes, s.reshape(shape), b.reshape(shape), fmt)


def is_compressed(x: Any) -> bool:
    return isinstance(x, CompressedVariable)


def compress_tree(params, fmt: FloatFormat, policy: QuantizePolicy, *, pvt: bool = True):
    """Compress the policy-selected leaves, one (s, b) for each whole leaf
    (stacked leaves included, as the reference compresses them); the rest
    pass through unchanged.  The codes are the reference's bit for bit; its
    (s, b) come from the compensated solver, these from ``quantize_stats``'
    sums by the closed form: equal up to f32 rounding, which the solve
    amplifies on a nearly constant leaf (tests/test_torch_omc_bytes.py)."""

    def f(path, leaf):
        if policy.selects(path_str(path), leaf):
            return compress_variable(leaf, fmt, pvt=pvt)
        return leaf

    return tree_map_with_path(f, params)


def decompress_tree(ctree):
    return tree_map(lambda x: x.dequantize() if is_compressed(x) else x, ctree)


# Byte accounting: the paper's "Parameter Memory / Communication" columns.

_PVT_OVERHEAD_BYTES = 8  # s and b, f32 each


def tree_bytes_report(params, fmt: FloatFormat, policy: QuantizePolicy, *,
                      fraction: float = 1.0) -> Dict[str, Any]:
    """Theoretical parameter memory / communication for a model under OMC,
    the reference's report key for key and to the byte.

    ``fraction < 1`` models PPQ: the expected bytes when each client
    quantizes ``fraction`` of the selected variables and keeps the rest in
    f32.  ``fp32_bytes`` is everything in f32, ``container_bytes`` the codes
    in their uint8/16/32 containers (the in-memory form), ``packed_bytes``
    the exact bitstream (the wire form).  As the reference, it charges 8
    bytes of (s, b) per selected variable, a stacked leaf included (whose
    storage holds one pair per entry: ``federated.state.state_bytes_report``
    counts those), and computes in Python floats truncated by ``int``.
    Only shapes are read, so meta tensors do.
    """
    n_sel = n_tot = 0
    container = packed = fp32 = overhead = 0
    num_vars = 0
    for path, leaf in tree_items(params):
        if not isinstance(leaf, torch.Tensor):
            continue
        sz = leaf.numel()
        n_tot += sz
        fp32 += 4 * sz
        if policy.selects(path_str(path), leaf):
            n_sel += sz
            num_vars += 1
            container += fmt.container_bytes_per_value * sz
            packed += packing.packed_bytes(sz, fmt)
            overhead += _PVT_OVERHEAD_BYTES
        else:
            container += 4 * sz
            packed += 4 * sz
    q = float(fraction)
    container_ppq = q * container + (1 - q) * fp32
    packed_ppq = q * packed + (1 - q) * fp32
    return dict(
        fmt=fmt.name,
        num_params=n_tot,
        num_quantizable=n_sel,
        num_quantizable_vars=num_vars,
        coverage=n_sel / max(n_tot, 1),
        fp32_bytes=fp32,
        container_bytes=int(container_ppq) + overhead,
        packed_bytes=int(packed_ppq) + overhead,
        container_ratio=(container_ppq + overhead) / max(fp32, 1),
        packed_ratio=(packed_ppq + overhead) / max(fp32, 1),
        avg_bits_packed=8 * (packed_ppq + overhead) / max(n_tot, 1),
    )


def pack_for_transport(cv: CompressedVariable) -> Dict[str, Any]:
    """Exact wire encoding of one compressed variable (uint32 bitstream),
    the reference's dict key for key; ``nbytes`` charges 8 bytes of (s, b)
    whatever their shape, as the reference does.  Bit offsets are 64-bit
    (``core.packing``), so a stacked leaf of more than 2**32 bits packs
    whole."""
    words = packing.pack(cv.codes, cv.fmt.bits)
    return dict(words=words, s=cv.s, b=cv.b, fmt=cv.fmt.name, shape=tuple(cv.codes.shape),
                nbytes=words.numel() * 4 + _PVT_OVERHEAD_BYTES)


def unpack_from_transport(blob: Dict[str, Any]) -> CompressedVariable:
    """Inverse of :func:`pack_for_transport`: codes in the format's container."""
    fmt = FloatFormat.parse(blob["fmt"])
    shape = tuple(blob["shape"])
    codes = packing.unpack(blob["words"], fmt.bits, math.prod(shape), fmt.container_dtype)
    return CompressedVariable(codes.reshape(shape), blob["s"], blob["b"], fmt)


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bits (NaN payloads and signed zeros included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    twin = {**SIGNED_TWIN, torch.float32: torch.int32}.get(a.dtype, a.dtype)
    return torch.equal(a.view(twin), b.view(twin).to(a.device))


def trees_bit_equal(a, b) -> bool:
    """Same paths and formats, and every tensor (codes, s, b, raw leaves)
    equal bit for bit."""
    la, lb = list(tree_items(a)), list(tree_items(b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False
    for (_, x), (_, y) in zip(la, lb):
        if is_compressed(x) != is_compressed(y):
            return False
        if is_compressed(x):
            if x.fmt != y.fmt or not all(bit_equal(u, v) for u, v in
                                         ((x.codes, y.codes), (x.s, y.s), (x.b, y.b))):
                return False
        elif not bit_equal(x, y):
            return False
    return True
