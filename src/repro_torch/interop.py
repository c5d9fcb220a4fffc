"""Carry parameter and storage trees and training states over from the JAX
package, as numpy.

The tests feed both packages the same model: the reference builds its trees
(``family.init``, ``compress_params``, ``init_state``), and these functions
turn them into the port's on a chosen device — ``np.asarray`` on each leaf,
same shapes and dtypes.  Nothing here imports the reference: a compressed
leaf is any object with ``codes``, ``s``, ``b`` and ``fmt`` (a format or its
name), a state any object with ``params``, ``opt_state``, ``round`` and
``rng``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import FloatFormat
from repro_torch.core.store import CompressedVariable
from repro_torch.federated.state import TrainState
from repro_torch.optim import optimizers


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


def _opt_from_numpy(tree, device):
    """An optimizer state: the reference's ``NamedTuple`` becomes the port's
    of the same name (``_CountState``, ``_MomentumState``, ``_AdamState``,
    fedadagrad's ``_State``); a 0-d ``count`` becomes an int."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = getattr(optimizers, type(tree).__name__)
        return cls(*(int(np.asarray(v)) if f == "count" else storage_from_numpy(v, device)
                     for f, v in zip(tree._fields, tree)))
    return storage_from_numpy(tree, device)


def state_from_numpy(state, device="cuda") -> TrainState:
    """A reference ``TrainState`` -> the port's: storage and optimizer trees
    on ``device``, ``round`` an int, ``rng`` the key from its uint32 ``[2]``."""
    k0, k1 = (int(w) for w in np.asarray(state.rng, dtype=np.uint32))
    return TrainState(params=storage_from_numpy(state.params, device),
                      opt_state=_opt_from_numpy(state.opt_state, device),
                      round=int(np.asarray(state.round)), rng=(k0, k1))
