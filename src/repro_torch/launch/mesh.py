"""Meshes: named device grids that say where each leaf would live (port of
``repro.launch.mesh``).

A :class:`Mesh` has the reference's two attributes, ``axis_names`` and
``devices`` (a numpy object array of ``torch.device``, so ``devices.shape``
and ``devices.size`` read as jax's do).  It allocates nothing and starts no
process group: the port runs on one card, and ``models.common``'s sharding
helpers resolve layouts against a mesh's axis sizes only.

The production meshes keep the reference's logical 16x16 and 2x16x16
layouts on the ``meta`` device; they describe no H100 cluster that was run
(ROADMAP C25).  The 1-D ``("clients",)`` population mesh maps
``repro_torch.scale``'s per-client state onto the visible cards.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray  # object array of torch.device, one per mesh position
    axis_names: Tuple[str, ...]


def _visible(device: str) -> int:
    """How many devices of this kind a mesh may use (meta: any number)."""
    kind = torch.device(device).type
    if kind == "meta":
        return 1 << 30
    if kind == "cpu":
        return 1
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA device; pass device='cpu' to place "
                               "the mesh on the host")
        return torch.cuda.device_count()
    raise ValueError(f"no mesh on device {device!r}")


def compat_make_mesh(shape: Sequence[int], axes: Sequence[str], device: str = "meta") -> Mesh:
    """A mesh of ``shape`` named ``axes`` over ``device``'s devices, in order
    (the reference's shim around ``jax.make_mesh``)."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n = int(np.prod(shape))
    if n > _visible(device):
        raise ValueError(f"a {shape} mesh needs {n} {device} devices; "
                         f"{_visible(device)} are visible")
    kind = torch.device(device).type
    flat = np.empty(n, dtype=object)
    for i in range(n):
        flat[i] = torch.device(kind, i) if kind == "cuda" else torch.device(kind)
    return Mesh(flat.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's 16x16 single-pod or 2x16x16 multi-pod layout, every
    position a ``meta`` device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, device: str = "cuda") -> Mesh:
    """A small ``("data", "model")`` mesh over the visible cards (or the
    host, ``device="cpu"``, which holds one position)."""
    return compat_make_mesh((data, model), ("data", "model"), device)


def make_population_mesh(num_shards: Optional[int] = None, device: str = "cuda") -> Mesh:
    """1-D ``("clients",)`` mesh for sharded population state (DESIGN.md
    §14).  ``num_shards`` is clamped to the visible device count: the
    logical shard count (``ShardLayout.num_shards``) may exceed it, and then
    several logical shards share a device (one card holds them all)."""
    n = _visible(device)
    if num_shards is not None:
        n = max(1, min(int(num_shards), n))
    return compat_make_mesh((n,), ("clients",), device)


# NVIDIA H100 SXM5 constants (per card), from NVIDIA's H100 Tensor Core GPU
# data sheet, dense rates at the full 700 W; the card these were checked
# against reads "NVIDIA H100 80GB HBM3, 700.00 W".  Used by the roofline.
PEAK_FLOPS_BF16 = 989.4e12  # FLOP/s, BF16 tensor cores without sparsity
HBM_BW = 3.35e12  # bytes/s, HBM3
ICI_BW = 25e9  # bytes/s each way over one NVLink-4 link (18 links: 450 GB/s each way)
PEAK_FLOPS_TF32 = 494.7e12  # FLOP/s, TF32 tensor cores without sparsity (f32 products)
