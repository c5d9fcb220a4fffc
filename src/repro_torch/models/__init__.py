"""Model families (port of ``repro.models``: the dense transformer and its
VLM prefix, the MoE, griffin, xlstm, the encoder-decoder and the conformer),
plain functions over parameter trees."""

from .registry import get_family, is_servable

__all__ = ["get_family", "is_servable"]
