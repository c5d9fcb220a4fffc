"""Roofline terms and the compressed-domain kernels' byte bounds (port of
``repro.roofline``; ``analyze_compiled`` and ``collective_bytes`` read XLA's
HLO and have no counterpart, ROADMAP C25)."""

from .analysis import RooflineTerms, model_flops

__all__ = ["RooflineTerms", "model_flops"]
