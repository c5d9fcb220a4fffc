"""OMC codec: formats, PVT, policy, PPQ, packing, storage, and the threefry
PRNG the reference's streams come from (port of ``repro.core``).

The package re-exports the reference's names that the port defines.  Six of
the reference's 35 come with the compression strategies and are not here
yet (ROADMAP A7): ``FP32``, ``qdq``, ``qdq_ste``, ``qdq_pvt``, ``coverage``
and ``selection_mask_tree``.
"""

from .formats import FloatFormat, decode, encode, value_quantize
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
from .policy import QuantizePolicy, quantizable_names
from .pvt import pvt_apply, pvt_solve, pvt_solve_fast
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
    "FloatFormat",
    "OMCConfig",
    "QuantizePolicy",
    "CompressedVariable",
    "bytes_report",
    "compress",
    "compress_tree",
    "compress_variable",
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
    "qdq_pvt_leaf",
    "quantizable_names",
    "tree_bytes_report",
    "unpack",
    "unpack_from_transport",
    "value_quantize",
]
