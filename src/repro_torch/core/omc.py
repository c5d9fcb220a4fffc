"""Online Model Compression configuration (paper §2), port of ``repro.core.omc``.

Only ``OMCConfig`` and its parser are ported.  The simulation mode
(``effective_params``, partial parameter quantization) needs the reference's
threefry PRNG stream and waits for its port (ROADMAP A1).
"""

from __future__ import annotations

import dataclasses

from .formats import FloatFormat
from .policy import QuantizePolicy

DEFAULT_POLICY = QuantizePolicy()


@dataclasses.dataclass(frozen=True)
class OMCConfig:
    """Configuration of Online Model Compression."""

    fmt: FloatFormat = FloatFormat(3, 7)  # S1E3M7 — the paper's 11-bit format
    pvt: bool = True
    quantize_fraction: float = 0.9  # PPQ; 1.0 = all selected vars quantized
    policy: QuantizePolicy = DEFAULT_POLICY

    @classmethod
    def parse(cls, fmt: str, **kw) -> "OMCConfig":
        return cls(fmt=FloatFormat.parse(fmt), **kw)

    @property
    def enabled(self) -> bool:
        return not self.fmt.is_identity or self.quantize_fraction < 1.0
