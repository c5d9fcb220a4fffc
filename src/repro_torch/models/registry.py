"""Model families by name (port of ``repro.models.registry``).

A family module exposes ``init`` and ``param_specs``; a servable one also
``prefill``, ``decode_step`` and ``init_decode_state``, a trainable one
``loss``.  ``"vlm"`` resolves to the transformer (``prefix_embeds > 0`` in
the config; the vision frontend is a stub).  ``"conformer"`` has no
decode step (encoder-only; the paper's benchmarks).
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict

from . import conformer, encdec, griffin, moe, transformer, xlstm

_FAMILIES: Dict[str, ModuleType] = {
    "transformer": transformer,
    "vlm": transformer,  # prefix_embeds > 0 in the config
    "moe": moe,
    "xlstm": xlstm,
    "griffin": griffin,
    "encdec": encdec,
    "conformer": conformer,
}

SERVABLE = {"transformer", "vlm", "moe", "xlstm", "griffin", "encdec"}


def get_family(name: str) -> ModuleType:
    if name not in _FAMILIES:
        raise KeyError(f"unknown model family {name!r}; have {sorted(_FAMILIES)}")
    return _FAMILIES[name]


def is_servable(name: str) -> bool:
    return name in SERVABLE
