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

The async runtime's snapshot (:func:`save_async_state` /
:func:`restore_async_state`) rides on the same layout: its arrays are one
tree (``storage``, ``buffer``, ``versions``, ``trained``) and its event
loop's scalars the manifest's ``extra``, in the reference's keys.  The
sharded population's store (:func:`save_population_state` /
:func:`restore_population_state`) rides on it too: its counters and rows are
numpy arrays on the host, and restore hands them back as such.
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
from repro_torch.core.tree import tree_map
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


def _decompressed_template(storage):
    """A tree shaped like a trained client model (the decoded storage), on
    the storage's devices, holding no memory: ``restore_state`` reads only
    each leaf's shape and device."""

    return tree_map(lambda x: torch.empty((), device=x.device).expand(x.codes.shape)
                    if is_compressed(x) else x, storage)


def _async_state_tree(runner) -> Dict[str, Any]:
    """The runner's array-bearing state as one tree (DESIGN.md §10): the
    server storage, the buffered models, the storages of the versions that
    pending tickets still reference, and the trained-but-not-uploaded cache,
    so a killed run resumes mid-buffer with nothing retrained and nothing
    downloaded again.  Keys as the reference's: versions ``str(v)``, the
    cache ``"v|c"``; the leaf order sorts them as strings, as JAX does.
    Under an error-feedback strategy the per-client residuals ``runner.ef``
    ride along: a resume needs the residuals of trained, unflushed updates."""
    tree = dict(
        storage=runner.storage,
        buffer=[e.model for e in runner.buffer],
        versions={str(v): s for v, s in sorted(runner.version_storages.items())},
        trained={f"{v}|{c}": m for (v, c), (m, _) in sorted(runner.trained.items())},
    )
    if runner.ef is not None:
        tree["ef"] = dict(runner.ef)
    if runner.population is not None:
        # population-backed counters ride in the npz as arrays: a large
        # population's counters as manifest JSON would be megabytes (§14)
        tree["counters"] = dict(round=runner.population.round_counters,
                                event=runner.population.event_counters)
    return tree


def save_async_state(ckpt_dir: str, runner, keep: int = 3) -> str:
    """Checkpoint a :class:`repro_torch.federated.async_engine.AsyncRunner`.

    Arrays go through :func:`save_state`; the event loop's scalars (virtual
    clock, version, pending tickets, trace counters, history, wire ledger)
    travel in the manifest's ``extra``, in the reference's keys, which is all
    a deterministic resume needs (traces are functions of their counters).
    The step is ``events_processed``.  A population-backed runner's counters
    travel as arrays in the npz and the manifest stamps its layout.
    """
    pop = runner.population
    extra = dict(
        kind="async_runner",
        version=int(runner.version),
        clock=float(runner.clock),
        events_processed=int(runner.events_processed),
        completed=int(runner.completed),
        dropped_stale=int(runner.dropped_stale),
        buffer_meta=[[int(e.client_id), int(e.base_version), float(e.loss)]
                     for e in runner.buffer],
        pending=[[int(c), int(p.base_version), int(p.round_index), float(p.upload_at)]
                 for c, p in runner.pending.items()],
        idle=[[int(c), float(t)] for c, t in runner.idle.items()],
        version_keys=sorted(int(v) for v in runner.version_storages),
        event_counters=(None if pop is not None else
                        {str(c): int(k) for c, k in runner.event_counters.items()}),
        round_counters=(None if pop is not None else
                        {str(c): int(k) for c, k in runner.round_counters.items()}),
        population_layout=pop.layout.describe() if pop is not None else None,
        trained_losses={f"{v}|{c}": float(l) for (v, c), (_, l) in runner.trained.items()},
        has_ef=runner.ef is not None,
        fused_agg=bool(runner.fused_agg),
        history=runner.history,
        stats=(dict(snapshot=runner.stats.snapshot(),
                    pending={str(c): int(b) for c, b in runner.stats._pending.items()})
               if runner.stats is not None else None),
    )
    return save_state(ckpt_dir, runner.events_processed, _async_state_tree(runner), keep=keep,
                      extra=extra)


_STATS_FIELDS = ("down_bytes", "up_bytes", "stale_up_bytes", "dropped_up_bytes",
                 "in_flight_bytes", "peak_in_flight_bytes", "n_downloads", "n_uploads",
                 "n_stale", "n_dropped")


def restore_async_state(path: str, runner) -> Dict[str, Any]:
    """Restore a :func:`save_async_state` checkpoint (either package's) into
    ``runner``, a freshly built ``AsyncRunner`` with the same family, config,
    trace and data: its storage gives the templates (fused buffer entries
    are shaped like the storage, unfused ones like the decoded tree), and
    every mutable field is overwritten in place.  Returns the manifest's
    ``extra``."""
    with open(os.path.join(path, "manifest.json")) as f:
        extra = json.load(f)["extra"]
    if extra.get("kind") != "async_runner":
        raise ValueError(f"not an async-runner checkpoint: {path}")
    fused = bool(extra.get("fused_agg"))
    if fused != bool(runner.fused_agg):
        raise ValueError(
            f"fused_agg mismatch: checkpoint was written with fused_agg={fused} but the "
            f"runner has fused_agg={bool(runner.fused_agg)} — construct the runner the same "
            "way (DESIGN.md §13)")
    pop = runner.population
    ck_layout = extra.get("population_layout")
    my_layout = pop.layout.describe() if pop is not None else None
    if ck_layout != my_layout:
        raise ValueError(
            f"population layout mismatch: checkpoint was written with "
            f"layout={ck_layout} but the runner has layout={my_layout} — "
            "construct the runner with the same ShardLayout (or None); cross-layout restore "
            "needs an offline reshard (DESIGN.md §14)")
    has_ef = bool(extra.get("has_ef"))
    if has_ef != (runner.ef is not None):
        raise ValueError(
            f"error-feedback state mismatch: checkpoint {'has' if has_ef else 'lacks'} "
            f"residuals but the runner {'lacks' if has_ef else 'has'} them — construct the "
            "runner with the same strategy= the checkpointed run used")
    entry_t = runner.storage if fused else _decompressed_template(runner.storage)
    template = dict(
        storage=runner.storage,
        buffer=[entry_t] * len(extra["buffer_meta"]),
        versions={str(v): runner.storage for v in extra["version_keys"]},
        trained={k: entry_t for k in sorted(extra["trained_losses"])},
    )
    if has_ef:
        template["ef"] = dict(runner.ef)
    if pop is not None:
        template["counters"] = dict(round=pop.round_counters, event=pop.event_counters)
    state, _ = restore_state(path, template)

    from repro_torch.federated.async_engine import _BufferEntry, _Pending

    runner.storage = state["storage"]
    runner.version = int(extra["version"])
    runner.clock = float(extra["clock"])
    runner.events_processed = int(extra["events_processed"])
    runner.completed = int(extra["completed"])
    runner.dropped_stale = int(extra["dropped_stale"])
    runner.buffer = [_BufferEntry(int(c), int(b), m, float(l))
                     for (c, b, l), m in zip(extra["buffer_meta"], state["buffer"])]
    runner.pending = {int(c): _Pending(int(b), int(r), float(t))
                      for c, b, r, t in extra["pending"]}
    runner.idle = {int(c): float(t) for c, t in extra["idle"]}
    if pop is not None:
        # in-place writes keep the runner's ArrayCounters views bound
        pop.round_counters[:] = np.asarray(state["counters"]["round"], np.int64)
        pop.event_counters[:] = np.asarray(state["counters"]["event"], np.int64)
    else:
        runner.event_counters = {int(c): int(k) for c, k in extra["event_counters"].items()}
        runner.round_counters = {int(c): int(k) for c, k in extra["round_counters"].items()}
    runner.version_storages = {int(v): s for v, s in state["versions"].items()}
    runner.trained = {(int(k.split("|")[0]), int(k.split("|")[1])): (state["trained"][k], float(l))
                      for k, l in extra["trained_losses"].items()}
    if has_ef:
        runner.ef = dict(state["ef"])
    runner.history = list(extra["history"])
    if extra["stats"] is not None and runner.stats is not None:
        snap = extra["stats"]["snapshot"]
        for field in _STATS_FIELDS:
            setattr(runner.stats, field, int(snap[field]))
        runner.stats._pending = {int(c): int(b) for c, b in extra["stats"]["pending"].items()}
    runner._rebuild_heap()
    return extra


def save_population_state(ckpt_dir: str, step: int, store, keep: int = 3) -> str:
    """Checkpoint a :class:`repro_torch.scale.PopulationStore` (DESIGN.md §14).

    Counters and residual rows (f32, or packed words with their per-row PVT
    pair: the at-rest compression survives on disk) go through
    :func:`save_state`; the manifest stamps the shard layout and the EF
    format, so :func:`restore_population_state` refuses a mismatched load
    instead of silently giving rows to the wrong clients.
    """
    extra = dict(kind="population_store", layout=store.layout.describe(),
                 ef=store.describe_ef())
    return save_state(ckpt_dir, step, store.state_tree(), keep=keep, extra=extra)


def restore_population_state(path: str, store) -> Dict[str, Any]:
    """Restore a :func:`save_population_state` checkpoint (either package's)
    into ``store``, built with the same ``ShardLayout`` and ``init_ef``
    configuration the saved run used; a layout, EF variable set or at-rest
    format that differs raises ``ValueError``.  Returns the manifest's
    ``extra``."""
    with open(os.path.join(path, "manifest.json")) as f:
        extra = json.load(f)["extra"]
    if extra.get("kind") != "population_store":
        raise ValueError(f"not a population-store checkpoint: {path}")
    if extra["layout"] != store.layout.describe():
        raise ValueError(
            f"population layout mismatch: checkpoint was written with layout={extra['layout']} "
            f"but the store has layout={store.layout.describe()} — cross-layout restore needs "
            "an offline reshard (DESIGN.md §14)")
    want_ef = store.describe_ef()
    if extra.get("ef") != want_ef:
        raise ValueError(
            f"population EF state mismatch: checkpoint has {extra.get('ef')} but the store has "
            f"{want_ef} — call init_ef with the same selection policy and ef_fmt before "
            "restoring")
    state, _ = restore_state(path, store.state_tree())
    store.load_state_tree(state)
    return extra
