"""Carry parameter and storage trees over from the JAX package, as numpy.

The tests feed both packages the same model: the reference builds its trees
(``family.init``, ``compress_params``), and these functions turn them into
the port's trees on a chosen device — ``np.asarray`` on each leaf, same
shapes and dtypes.  Nothing here imports the reference: a compressed leaf is
any object with ``codes``, ``s``, ``b`` and ``fmt`` (a format or its name).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import FloatFormat
from repro_torch.core.store import CompressedVariable


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def params_from_numpy(tree, device="cuda"):
    """Nested dict of arrays -> nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def storage_from_numpy(tree, device="cuda"):
    """Like :func:`params_from_numpy`, with compressed leaves turned into
    ``CompressedVariable`` (codes in their uint container, f32 ``s``/``b``)."""
    if isinstance(tree, dict):
        return {k: storage_from_numpy(v, device) for k, v in tree.items()}
    if all(hasattr(tree, a) for a in ("codes", "s", "b", "fmt")):
        fmt = tree.fmt if isinstance(tree.fmt, str) else tree.fmt.name
        return CompressedVariable(_tensor(tree.codes, device), _tensor(tree.s, device),
                                  _tensor(tree.b, device), FloatFormat.parse(fmt))
    return _tensor(tree, device)
