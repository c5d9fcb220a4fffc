"""Checkpoint/restart for the federated server state (port of
``repro.checkpoint.ckpt``, DESIGN.md §5).

The layout is the reference's, so that each package restores the other's
checkpoints:

  * **Atomic**: write to ``<dir>/tmp.<step>.*``, fsync, then ``os.replace``
    to ``<dir>/ckpt_<step>``; a crash mid-write never corrupts the latest
    checkpoint.
  * **Logical layout**: ``arrays.npz`` holds leaf ``i`` as ``a{i}``, or a
    compressed leaf as ``a{i}_codes`` (its uint container), ``a{i}_s`` and
    ``a{i}_b``; ``manifest.json`` holds ``step``, ``kinds``, ``treedef``,
    ``process_index`` and ``extra``.  Restore puts each array on the device
    of the template's leaf.
  * **Keep-K GC** and ``latest_checkpoint`` resume discovery.

The leaf order is JAX's ``tree_flatten(state, is_leaf=is_compressed)``:
``TrainState`` fields in declaration order, ``NamedTuple`` fields in order,
dict keys sorted, a ``CompressedVariable`` one leaf; ``round`` and an
optimizer's ``count`` are saved as int32 0-d arrays and ``rng`` as the
uint32 ``[2]`` key.  ``treedef`` is the port's own description; restore
reads the structure from the template only, as the reference's does.

The codes of an OMC state are stored in their uint containers, so the
checkpoint is itself compressed (about the paper's parameter-memory ratio on
disk, for a format whose container is narrower than f32).

The async runtime's and the sharded population's checkpoints wait for their
modules (ROADMAP A8, A9).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import FloatFormat
from repro_torch.core.store import CompressedVariable, is_compressed
from repro_torch.federated.state import TrainState

_CKPT_RE = re.compile(r"^ckpt_(\d+)$")


def _leaves(tree) -> List[Any]:
    """JAX's leaf order; the key ``rng`` as its uint32 words."""
    if isinstance(tree, TrainState):
        return (_leaves(tree.params) + _leaves(tree.opt_state)
                + [tree.round, np.asarray(tree.rng, dtype=np.uint32)])
    if is_compressed(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(template, it):
    """``template``'s structure with its leaves taken from ``it`` in order."""
    if isinstance(template, TrainState):
        params, opt_state = _rebuild(template.params, it), _rebuild(template.opt_state, it)
        rnd = next(it)
        k0, k1 = (int(w) for w in next(it))
        return TrainState(params=params, opt_state=opt_state, round=rnd, rng=(k0, k1))
    if is_compressed(template):
        return next(it)
    if isinstance(template, dict):
        out = {k: _rebuild(template[k], it) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):  # NamedTuple
        return type(template)(*(_rebuild(v, it) for v in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, it) for v in template)
    return next(it)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, int):
        return np.asarray(x, dtype=np.int32)
    return np.asarray(x)


def _flatten_state(state) -> Tuple[Dict[str, np.ndarray], Tuple[str, List[Dict[str, Any]]]]:
    """Tree -> (flat name -> np.ndarray, (treedef description, kinds))."""
    arrays: Dict[str, np.ndarray] = {}
    kinds: List[Dict[str, Any]] = []
    leaves = _leaves(state)
    for i, leaf in enumerate(leaves):
        if is_compressed(leaf):
            arrays[f"a{i}_codes"] = _numpy(leaf.codes)
            arrays[f"a{i}_s"] = _numpy(leaf.s)
            arrays[f"a{i}_b"] = _numpy(leaf.b)
            kinds.append(dict(kind="compressed", fmt=leaf.fmt.name))
        else:
            arrays[f"a{i}"] = _numpy(leaf)
            kinds.append(dict(kind="array"))
    treedef = f"repro_torch {type(state).__name__} with {len(leaves)} leaves"
    return arrays, (treedef, kinds)


def save_state(ckpt_dir: str, step: int, state, keep: int = 3,
               extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomically save ``state`` as ``ckpt_<step>``.  Returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, (treedef, kinds) = _flatten_state(state)
    manifest = dict(step=int(step), kinds=kinds, treedef=treedef, process_index=0,
                    extra=extra or {})
    tmp = tempfile.mkdtemp(prefix=f"tmp.{step}.", dir=ckpt_dir)
    try:
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(ckpt_dir, f"ckpt_{step}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    gc_checkpoints(ckpt_dir, keep)
    return final


def latest_checkpoint(ckpt_dir: str) -> Optional[Tuple[str, int]]:
    """``(path, step)`` of the newest complete checkpoint, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            step = int(m.group(1))
            if best is None or step > best[1]:
                best = (os.path.join(ckpt_dir, name), step)
    return best


def gc_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Keep the newest ``keep`` checkpoints; remove stale ``tmp.*`` directories."""
    entries = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m:
            entries.append((int(m.group(1)), name))
    entries.sort(reverse=True)
    for _, name in entries[keep:]:
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
    for name in os.listdir(ckpt_dir):  # stale tmp dirs from crashes
        if name.startswith("tmp."):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def _checked(arr: np.ndarray, want_shape) -> np.ndarray:
    if tuple(arr.shape) != tuple(want_shape):
        raise ValueError(f"checkpoint array shape {arr.shape} != template {tuple(want_shape)} "
                         f"— wrong config for this checkpoint")
    return arr


def _put(arr: np.ndarray, want_shape, device) -> torch.Tensor:
    return torch.from_numpy(np.array(_checked(arr, want_shape), copy=True)).to(device)


def restore_state(path: str, template):
    """Restore into the structure of ``template`` -> ``(state, manifest)``.

    Each array lands on the device of the template's leaf; an int leaf
    (``round``, a ``count``) comes back as an int and ``rng`` as a key.
    """
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _leaves(template)
    if len(manifest["kinds"]) != len(leaves):
        raise ValueError(f"checkpoint has {len(manifest['kinds'])} leaves, template has "
                         f"{len(leaves)} — structure mismatch")
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (kind, leaf) in enumerate(zip(manifest["kinds"], leaves)):
            if kind["kind"] == "compressed":
                if not is_compressed(leaf):
                    raise ValueError(f"leaf {i}: checkpoint compressed, template not")
                out.append(CompressedVariable(
                    codes=_put(data[f"a{i}_codes"], leaf.codes.shape, leaf.device),
                    s=_put(data[f"a{i}_s"], leaf.s.shape, leaf.device),
                    b=_put(data[f"a{i}_b"], leaf.b.shape, leaf.device),
                    fmt=FloatFormat.parse(kind["fmt"])))
            elif is_compressed(leaf):
                raise ValueError(f"leaf {i}: template compressed, checkpoint not")
            elif isinstance(leaf, torch.Tensor):
                out.append(_put(data[f"a{i}"], leaf.shape, leaf.device))
            elif isinstance(leaf, int):
                out.append(int(_checked(data[f"a{i}"], ())))
            else:  # the key's words
                out.append(_checked(data[f"a{i}"], np.shape(leaf)))
    return _rebuild(template, iter(out)), manifest


def _unported(name: str, item: str):
    def f(*args, **kwargs):
        raise NotImplementedError(f"checkpoint.{name} waits for its module (ROADMAP {item})")

    f.__name__ = name
    return f


save_async_state = _unported("save_async_state", "A8, the async runtime")
restore_async_state = _unported("restore_async_state", "A8, the async runtime")
save_population_state = _unported("save_population_state", "A9, scale.store")
restore_population_state = _unported("restore_population_state", "A9, scale.store")
