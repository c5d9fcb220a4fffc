"""Model families by name (port of ``repro.models.registry``).

A family module exposes ``init`` and ``param_specs``; a servable one also
``prefill``, ``decode_step`` and ``init_decode_state``, a trainable one
``loss``.  ``"vlm"`` resolves to the transformer (``prefix_embeds > 0`` in
the config; the vision frontend is a stub).  The dense transformer, the VLM
and the MoE (serve and train), griffin (serve) and the conformer (train)
are ported; ``xlstm`` and ``encdec`` are queued in ROADMAP.md (queue A10).
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict

from . import conformer, griffin, moe, transformer

_FAMILIES: Dict[str, ModuleType] = {
    "transformer": transformer,
    "vlm": transformer,  # prefix_embeds > 0 in the config
    "moe": moe,
    "griffin": griffin,
    "conformer": conformer,
}

# the reference's servable families; xlstm and encdec are not ported yet
SERVABLE = {"transformer", "vlm", "moe", "xlstm", "griffin", "encdec"}


def get_family(name: str) -> ModuleType:
    if name not in _FAMILIES:
        raise KeyError(f"model family {name!r} is not ported to repro_torch yet (see "
                       f"ROADMAP.md, queue A10); ported: {sorted(_FAMILIES)}")
    return _FAMILIES[name]


def is_servable(name: str) -> bool:
    return name in SERVABLE
