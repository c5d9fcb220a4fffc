"""OMC materialization for serving and training (port of
``repro.federated.materialize``).

The storage tree keeps policy-selected variables as ``CompressedVariable``
(uint bitfield codes + PVT scalars).  Per layer, the materializer hands the
model its weights:

  * serving: a compressed 2-D leaf that the layer uses as a matmul operand
    (a key the model names in ``operands``) stays in code form, one entry
    with its own ``(s, b)``: ``models.common.linear`` streams its codes
    through the ``dequant_matmul`` kernel, so the f32 weight never exists in
    device memory (DESIGN.md §2).  So does a layer's MoE expert stack
    (codes ``[E, D, F]`` with the layer's one ``(s, b)``), whose experts
    ``models.moe`` multiplies by one at a time;
  * every other compressed leaf is decoded and PVT-corrected on the fly,
    one ``dequantize`` launch per leaf on CUDA, into a transient f32 tensor
    dropped after use (the paper's decompress-on-the-fly, Fig. 1);
  * a raw leaf passes through as f32;
  * training: a :class:`QParam` pairs a storage leaf with its f32 zero
    "gradient sink".  It always comes back decoded (never in code form:
    ``dequant_matmul`` has no backward) and grafted onto its sink,
    ``w = decoded + sink``, whose value is the decoded weight (the sink is
    zeros) and whose gradient lands in the sink: ``autograd.grad(loss,
    sinks)`` is d loss / d W_effective, the client delta, and no gradient
    reaches the integer codes.  The decoded leaf needs no gradient of its
    own, so no ``autograd.Function`` is needed.

Under ``models.common.scan_blocks`` a stacked ``QParam`` is unbound one
layer at a time (codes, ``(s, b)`` and sink together) and materialized
inside that layer's ``checkpoint``, so the backward pass decodes the layer
again, as the reference's remat does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.store import is_compressed
from repro_torch.core.tree import tree_map
from repro_torch.models.common import Materializer


@dataclasses.dataclass
class QParam:
    """Storage-form parameter paired with its gradient sink.

    value: CompressedVariable (selected variables) or f32 tensor (the rest).
    sink:  f32 zeros of the decoded shape that require grad; None in
           inference mode (no gradient wanted).
    """

    value: Any
    sink: Optional[torch.Tensor] = None

    def unbind(self, dim: int = 0):
        """The layers of a stacked leaf, value and sink sliced together."""
        sinks = self.sink.unbind(dim) if self.sink is not None else None
        return [QParam(v, None if sinks is None else sinks[i])
                for i, v in enumerate(self.value.unbind(dim))]

    def rows(self, index: torch.Tensor) -> "QParam":
        """Rows of a single (embedding) variable and of its sink: decoding
        them equals the rows of the decoded table, bit for bit, and their
        gradient lands in the sink's rows."""
        v = self.value.rows(index) if is_compressed(self.value) else self.value[index]
        return QParam(v, None if self.sink is None else self.sink[index])


def make_sinks(params):
    """f32 zero tree shaped like the decoded params, each leaf requiring grad."""

    def zero(leaf):
        shape = leaf.codes.shape if is_compressed(leaf) else leaf.shape
        return torch.zeros(shape, dtype=torch.float32, device=leaf.device, requires_grad=True)

    return tree_map(zero, params)


def pack_qparams(params, sinks=None):
    """Zip storage params with sinks into a QParam tree (the model's input)."""
    if sinks is None:
        return tree_map(lambda v: QParam(v, None), params)
    return tree_map(QParam, params, sinks)


def _operand(v) -> bool:
    """A compressed matmul operand the kernel takes: one matrix, or a stack
    of expert matrices sharing one ``(s, b)``."""
    return is_compressed(v) and (v.codes.ndim == 2
                                 or (v.codes.ndim == 3 and v.s.numel() == 1))


class OMCMaterializer(Materializer):
    """Materializer that decodes ``CompressedVariable`` and ``QParam`` leaves,
    but for the compressed matmul operands named in ``operands`` (a matrix or
    an expert stack), which stay in code form (serving only)."""

    def __call__(self, subtree, operands=()):
        if not operands:
            return tree_map(self.leaf, subtree)
        return {k: v if k in operands and _operand(v) else tree_map(self.leaf, v)
                for k, v in subtree.items()}

    def leaf(self, x):
        if isinstance(x, QParam):
            w = self.leaf(x.value).detach()
            return w if x.sink is None else w + x.sink
        if is_compressed(x):
            return x.dequantize()
        return x.to(torch.float32)
