"""Architecture registry: ``--arch <id>`` -> config module (qwen2.5-3b,
recurrentgemma-2b, conformer_s).

Only the architectures the port has reached are listed; the rest of the
reference's zoo is queued in ROADMAP.md (queue A10).
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict

from . import conformer_s, qwen2_5_3b, recurrentgemma_2b

ARCHS: Dict[str, ModuleType] = {m.ID: m for m in (qwen2_5_3b, recurrentgemma_2b, conformer_s)}


def get_arch(arch_id: str) -> ModuleType:
    if arch_id not in ARCHS:
        raise KeyError(f"arch {arch_id!r} is not ported to repro_torch yet (see ROADMAP.md, "
                       f"queue A10); ported: {sorted(ARCHS)}")
    return ARCHS[arch_id]
