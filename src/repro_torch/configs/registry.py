"""Architecture registry: ``--arch <id>`` -> config module (port of
``repro.configs.registry``): the reference's ten assigned dry-run
architectures, in its order, and the benchmark-only ``conformer_s``."""

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
    seamless_m4t_medium,
    xlstm_350m,
)

_MODULES = [
    qwen2_5_3b, h2o_danube3_4b, qwen1_5_110b, mistral_nemo_12b,
    internvl2_1b, seamless_m4t_medium, dbrx_132b, mixtral_8x7b,
    xlstm_350m, recurrentgemma_2b, conformer_s,
]

ARCHS: Dict[str, ModuleType] = {m.ID: m for m in _MODULES}

# the 10 assigned dry-run architectures (conformer_s is benchmark-only)
ASSIGNED: List[str] = [m.ID for m in _MODULES if m is not conformer_s]


def get_arch(arch_id: str) -> ModuleType:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]


def list_archs() -> List[str]:
    return list(ARCHS)
