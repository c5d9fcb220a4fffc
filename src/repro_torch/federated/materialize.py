"""OMC materialization for serving (port of ``repro.federated.materialize``).

The storage tree keeps policy-selected variables as ``CompressedVariable``
(uint bitfield codes + PVT scalars).  Per layer, the materializer hands the
model its weights:

  * a compressed 2-D leaf that the layer uses as a matmul operand (a key the
    model names in ``operands``) stays in code form, one entry with its own
    ``(s, b)``: ``models.common.linear`` streams its codes through the
    ``dequant_matmul`` kernel, so the f32 weight never exists in device
    memory (DESIGN.md §2);
  * every other compressed leaf (one used elementwise, such as griffin's
    ``conv_w``, the embedding rows, a tied head) is decoded and
    PVT-corrected on the fly, one ``dequantize`` launch per leaf on CUDA,
    into a transient f32 tensor dropped after use (the paper's
    decompress-on-the-fly, Fig. 1);
  * a raw leaf passes through as f32.

Inference mode only: the reference's gradient sinks (``QParam``) belong to
the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.core.store import is_compressed
from repro_torch.core.tree import tree_map
from repro_torch.models.common import Materializer


class OMCMaterializer(Materializer):
    """Materializer that decodes ``CompressedVariable`` leaves, but for the
    2-D matmul operands named in ``operands``, which stay in code form."""

    def __call__(self, subtree, operands=()):
        if not operands:
            return tree_map(self.leaf, subtree)
        return {k: v if k in operands and is_compressed(v) and v.codes.ndim == 2
                else tree_map(self.leaf, v) for k, v in subtree.items()}

    def leaf(self, x):
        if is_compressed(x):
            return x.dequantize()
        return x.to(torch.float32)
