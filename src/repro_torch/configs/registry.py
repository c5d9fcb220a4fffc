"""Architecture registry: ``--arch <id>`` -> config module.

Only the architectures the port has reached are listed in ``ARCHS``:
xlstm-350m and seamless-m4t-medium are queued in ROADMAP.md (queue A10).
``ASSIGNED`` keeps the reference's ten dry-run ids in its order, ported or
not: a caller skips an id that :func:`get_arch` refuses, naming A10.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, List

from . import (
    conformer_s,
    dbrx_132b,
    h2o_danube3_4b,
    internvl2_1b,
    mistral_nemo_12b,
    mixtral_8x7b,
    qwen1_5_110b,
    qwen2_5_3b,
    recurrentgemma_2b,
)

ARCHS: Dict[str, ModuleType] = {m.ID: m for m in (
    qwen2_5_3b, h2o_danube3_4b, qwen1_5_110b, mistral_nemo_12b, internvl2_1b, dbrx_132b,
    mixtral_8x7b, recurrentgemma_2b, conformer_s)}

# the reference's 10 assigned dry-run architectures (conformer_s is benchmark-only)
ASSIGNED: List[str] = [
    "qwen2.5-3b", "h2o-danube-3-4b", "qwen1.5-110b", "mistral-nemo-12b", "internvl2-1b",
    "seamless-m4t-medium", "dbrx-132b", "mixtral-8x7b", "xlstm-350m", "recurrentgemma-2b",
]


def get_arch(arch_id: str) -> ModuleType:
    if arch_id not in ARCHS:
        raise KeyError(f"arch {arch_id!r} is not ported to repro_torch yet (see ROADMAP.md, "
                       f"queue A10); ported: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def list_archs() -> List[str]:
    """The ported architecture ids (the reference lists its whole zoo)."""
    return list(ARCHS)
