"""OMC materialization for serving (port of ``repro.federated.materialize``).

The storage tree keeps policy-selected variables as ``CompressedVariable``
(uint bitfield codes + PVT scalars).  Each layer's leaves are decoded and
PVT-corrected on the fly — one launch of the ``dequantize`` kernel per
compressed leaf on CUDA — into a transient f32 weight that is dropped after
the layer uses it (the paper's decompress-on-the-fly, Fig. 1).

Inference mode only: the reference's gradient sinks (``QParam``) belong to
the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.core.store import is_compressed
from repro_torch.core.tree import tree_map
from repro_torch.models.common import Materializer


class OMCMaterializer(Materializer):
    """Materializer that decodes ``CompressedVariable`` leaves.

    Per leaf: a CompressedVariable is decoded to f32 with its PVT affine
    fused; a raw leaf passes through as f32.
    """

    def __call__(self, subtree):
        return tree_map(self.leaf, subtree)

    def leaf(self, x):
        if is_compressed(x):
            return x.dequantize()
        return x.to(torch.float32)
