"""Build the port's CUDA kernels into one shared library, loaded with ``ctypes``.

The sources in ``csrc/`` have a plain C interface (no PyTorch headers), so
``nvcc`` builds them in seconds: one ``nvcc -c`` per source, all started
together, then one link.  The library is built at first use, only from the
sources in this package, into
``<repo>/build/repro_torch/<hash of sources and flags>/``; a later process
with the same sources reuses it.  A failed build raises with nvcc's stderr.

Flags: ``sm_90a`` (Hopper), and no ``--use_fast_math`` — it turns on
flush-to-zero and approximate division, which break the codec's bit-exact
contracts.  ``-Xptxas -v`` writes each kernel's registers and spills to
``nvcc.log`` beside the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
HEADERS = ("minifloat.cuh", "reduce.cuh", "decode.cuh")
SOURCES = ("quantize.cu", "bitpack.cu", "agg.cu", "dequant_matmul.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libomc_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # name: (restype, argtypes)
    "omc_error_string": (ctypes.c_char_p, [_I]),
    "omc_quantize_stats_blocks": (_LL, [_LL]),
    # srv, cl, out, m, entries, clients, container_bytes, exp, mant, plan[4]
    "omc_fused_aggregate_plan": (_I, [_P, _P, _P, _LL, _I, _I, _I, _I, _I, _P]),
    # n, width, container_bytes, plan[3]
    "omc_pack_plan": (_I, [_LL, _I, _I, _P]),
    # x, codes, container_bytes, n, exp, mant, stream
    "omc_quantize": (_I, [_P, _P, _I, _LL, _I, _I, _P]),
    # codes, container_bytes, s, b, out, n_per_entry, entries, exp_bits, mant_bits, stream
    "omc_dequantize": (_I, [_P, _I, _P, _P, _P, _LL, _I, _I, _I, _P]),
    # x, codes, container_bytes, partials, sums, n_per_entry, entries, exp, mant, stream
    "omc_quantize_stats": (_I, [_P, _P, _I, _P, _P, _LL, _I, _I, _I, _P]),
    # codes, container_bytes, words, n, nwords, width, stream
    "omc_pack": (_I, [_P, _I, _P, _LL, _LL, _I, _P]),
    # words, nwords, out, container_bytes, n, width, stream
    "omc_unpack": (_I, [_P, _LL, _P, _I, _LL, _I, _P]),
    # srv, srv_s, srv_b, cl, cl_s, cl_b, w, clients, lr, out, container_bytes,
    # partials, sums, tickets, m, entries, exp, mant, stream
    "omc_fused_aggregate": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _F, _P, _I, _P, _P, _P, _LL,
                                 _I, _I, _I, _P]),
    # a, codes, container_bytes, exp, mant, m, k, n, plan[5]
    "omc_dequant_matmul_plan": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _P]),
    # a, codes, container_bytes, s, b, out, m, k, n, exp, mant, stream
    "omc_dequant_matmul": (_I, [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source at "
                       "first use and need the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the sources if this hash has no library yet; return its path."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [path.with_name(f"{src}.{tag}.o") for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    (path.parent / "nvcc.log").write_text("".join(logs))
    failed = [(src, log) for src, p, log in zip(SOURCES, procs, logs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"{s}:\n{log}" for s, log in failed))
    tmp = path.with_name(f"{LIB_NAME}.{tag}")
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"linking the kernels failed with exit code {proc.returncode}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees a partial file
    return path


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels; declare signatures."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(rc: int, op: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if rc != 0:
        msg = load_library().omc_error_string(rc).decode()
        raise RuntimeError(f"{op}: CUDA error {rc} ({msg})")
