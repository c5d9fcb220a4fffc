"""OMC codec: formats, PVT, policy, PPQ, packing, storage, and the threefry
PRNG the reference's streams come from (port of ``repro.core``).

The package re-exports the reference's 35 names.
"""

from .formats import FP32, FloatFormat, decode, encode, qdq, qdq_ste, value_quantize
from .omc import (
    OMCConfig,
    bytes_report,
    compress,
    decompress,
    effective_params,
    qdq_pvt_leaf,
)
from .packing import pack, packed_bytes, packed_words, unpack
from .partial import ppq_mask, ppq_masks_batch
from .policy import QuantizePolicy, coverage, quantizable_names, selection_mask_tree
from .pvt import pvt_apply, pvt_solve, pvt_solve_fast, qdq_pvt
from .store import (
    CompressedVariable,
    compress_tree,
    compress_variable,
    decompress_tree,
    is_compressed,
    pack_for_transport,
    tree_bytes_report,
    unpack_from_transport,
)

__all__ = [
    "FP32",
    "FloatFormat",
    "OMCConfig",
    "QuantizePolicy",
    "CompressedVariable",
    "bytes_report",
    "compress",
    "compress_tree",
    "compress_variable",
    "coverage",
    "decode",
    "decompress",
    "decompress_tree",
    "effective_params",
    "encode",
    "is_compressed",
    "pack",
    "pack_for_transport",
    "packed_bytes",
    "packed_words",
    "ppq_mask",
    "ppq_masks_batch",
    "pvt_apply",
    "pvt_solve",
    "pvt_solve_fast",
    "qdq",
    "qdq_pvt",
    "qdq_pvt_leaf",
    "qdq_ste",
    "quantizable_names",
    "selection_mask_tree",
    "tree_bytes_report",
    "unpack",
    "unpack_from_transport",
    "value_quantize",
]
