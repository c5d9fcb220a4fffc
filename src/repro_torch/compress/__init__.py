"""Transport-compression strategies (port of ``repro.compress``, DESIGN.md
§11-§12).

One interface, :class:`CompressionStrategy`, with the zoo behind it:

  * :class:`OMCQuantStrategy` — the paper's minifloat + PVT quantization
    over ``repro_torch.core`` (the reference point),
  * :class:`TopKSparseStrategy` — magnitude top-k with index packing
    (Konečný et al., arxiv 1610.05492),
  * :class:`TernaryTNTStrategy` — 2-bit TNT/TWN ternary weights,
  * :class:`PipelineStrategy` — quantize → sparsify → entropy-code
    (Grativol et al., arxiv 2310.14693).

Every strategy encodes the policy-selected variables to self-describing wire
leaves that the codec serializes (with a strategy tag and a per-strategy
wire version in the frame), offers a quantize→dequantize and
straight-through view for training, and counts its wire bytes exactly.
:mod:`.feedback` holds the per-client error-feedback residuals.  The package
imports ``torch``, numpy and ``zlib``; on a CUDA tree its encodes and
decodes run the kernels (``quantize_stats``, ``quantize``, ``dequantize``,
``pack``, ``unpack``) and raise where one cannot launch.
"""

from .base import (  # noqa: F401
    CompressionStrategy,
    StrategyLeaf,
    available_strategies,
    decode_tree,
    default_zoo,
    encode_tree,
    get_strategy,
    is_encoded_leaf,
    is_strategy_leaf,
    qdq_tree,
    register_strategy,
    strategy_class,
    tree_wire_bytes,
)
from . import feedback  # noqa: F401  (error-feedback residuals, DESIGN.md §12)
from .omc_quant import OMCQuantStrategy  # noqa: F401
from .pipeline import PipelineStrategy, PipelineVariable  # noqa: F401
from .ternary import TernaryTNTStrategy, TernaryVariable, ternarize  # noqa: F401
from .topk import TopKSparseStrategy, TopKSparseVariable  # noqa: F401

from . import wire  # noqa: F401  (registers the leaf codecs with repro_torch.api)

__all__ = [
    "CompressionStrategy",
    "OMCQuantStrategy",
    "PipelineStrategy",
    "PipelineVariable",
    "StrategyLeaf",
    "TernaryTNTStrategy",
    "TernaryVariable",
    "TopKSparseStrategy",
    "TopKSparseVariable",
    "available_strategies",
    "decode_tree",
    "default_zoo",
    "encode_tree",
    "feedback",
    "get_strategy",
    "is_encoded_leaf",
    "is_strategy_leaf",
    "qdq_tree",
    "register_strategy",
    "strategy_class",
    "ternarize",
    "tree_wire_bytes",
]
