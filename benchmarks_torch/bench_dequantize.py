#!/usr/bin/env python3
"""B2 ``dequantize`` on the card, beside its design alternatives and an earlier tree's kernel.

    python3 benchmarks_torch/bench_dequantize.py [--parent DIR] [--variants]

Times the kernel at the main paths' shapes: the tied head [151936, 2048]
and one MLP slice [2048, 11008] of qwen2.5-3b in S1E3M7 (the serve path),
and conformer_s' stacked leaf [17, 512, 2048] with one (s, b) per entry in
S1E3M7 (the engine and the async runtime) and in S1E4M14 (the training
driver).  Each time is taken twice, in the order A B ... B A, by CUDA events
around the call (``chip_smoke.Timer``: median of 20, L2 flushed; for small
calls it includes the host's time to launch) and by the profiler's device
time alone (``Timer.device``).  Every result is checked bit for bit against
the plain version first.

``--parent DIR``: also build and time the kernel of another tree, e.g. the
parent commit unpacked with ``git archive <commit> | tar -x -C DIR`` into a
directory that ``.gitignore`` lists (the same C interface).

``--variants``: also build this tree's ``quantize.cu`` with a line or two
changed, to compare the design with what it was chosen against: 2 or 4
code vectors a thread (``loads2``, ``loads4``), blocks of 128 or 512
threads, ``__launch_bounds__`` asking for 8 resident blocks (``min8``),
streaming loads (``cs_loads``, ld.global.cs) and evict-first stores
(``cs_stores``, st.global.cs), the grid capped at the blocks the card holds
at once (the occupancy API), each thread striding over the rest
(``persistent``, and with 4 vectors a thread), and the run-time decode for
every format (``runtime``).

One JSON line per case, then one for the run with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from benchmarks_torch.bench_pack_agg import _patched, abba  # noqa: E402
from repro_torch.core.formats import FloatFormat  # noqa: E402
from repro_torch.core.store import bit_equal  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import quantize as qk  # noqa: E402

OUT = cs.ROOT / "build" / "bench_dequantize"
U = "kVecsInFlight = 1;"
STORE = ("          o[q] = make_float4(affine(v[4 * q], s, b), affine(v[4 * q + 1], s, b),\n"
         "                             affine(v[4 * q + 2], s, b), affine(v[4 * q + 3], s, b));\n")
CS_STORE = ("          __stcs(o + q, make_float4(affine(v[4 * q], s, b), affine(v[4 * q + 1], s, b),\n"
            "                                    affine(v[4 * q + 2], s, b), "
            "affine(v[4 * q + 3], s, b)));\n")
BLOCKS = "  p.blocks = need < 1 ? 1 : (need < kMaxBlocks ? need : kMaxBlocks);\n"
# the grid capped at the blocks resident at once (the occupancy API), each
# block striding over as many chunks as it takes, none more than another
PERSISTENT = BLOCKS + """  {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (p.vec) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dequantize_vec_kernel<T, Y, Z,
                                                    uint32_t>, kDqThreads, 0);
    } else {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dequantize_scalar_kernel<T, Y, Z,
                                                    uint32_t>, kDqThreads, 0);
    }
    const long long fill = (long long)sms * per_sm, rounds = (p.blocks + fill - 1) / fill;
    p.blocks = (p.blocks + rounds - 1) / rounds;
  }
"""
VARIANTS = {
    "loads2": ((U, "kVecsInFlight = 2;"),),
    "loads4": ((U, "kVecsInFlight = 4;"),),
    "threads128": (("kDqThreads = 256;", "kDqThreads = 128;"),),
    "threads512": (("kDqThreads = 256;", "kDqThreads = 512;"),),
    "min8": (("__launch_bounds__(kDqThreads)\n    dequantize_vec_kernel",
              "__launch_bounds__(kDqThreads, 8)\n    dequantize_vec_kernel"),),
    "cs_loads": (("raw[k] = __ldg(codes + i);", "raw[k] = __ldcs(codes + i);"),),
    "cs_stores": ((STORE, CS_STORE),),
    "persistent": ((BLOCKS, PERSISTENT),),
    "persistent_loads4": ((BLOCKS, PERSISTENT), (U, "kVecsInFlight = 4;")),
    "runtime": (("  if (container_bytes == 2 && exp_bits == 3 && mant_bits == 7) "
                 "return kDecodeS1E3M7;\n", ""),
                ("  if (container_bytes == 4 && exp_bits == 4 && mant_bits == 14) "
                 "return kDecodeS1E4M14;\n", "")),
}


def build_libs(parent: Path | None, variants: bool) -> dict:
    """name -> CDLL; one nvcc per library, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}  # name -> (source, include dir)
    if parent is not None:
        csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
        jobs["parent"] = (csrc / "quantize.cu", csrc)
    if variants:
        src = (build.CSRC / "quantize.cu").read_text()
        for name, edits in VARIANTS.items():
            (OUT / f"quantize_{name}.cu").write_text(_patched(src, edits))
            jobs[name] = (OUT / f"quantize_{name}.cu", build.CSRC)
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(inc), "-shared", "-o",
         str(OUT / f"lib_{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, inc) in jobs.items()}
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"bench_dequantize: building {name} failed:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(OUT / f"lib_{name}.so"))
        restype, argtypes = build._SIGNATURES["omc_dequantize"]
        lib.omc_dequantize.restype, lib.omc_dequantize.argtypes = restype, argtypes
        libs[name] = lib
    return libs


def runner(lib):
    """The wrapper's launch through another library: (s, b) one pair per entry."""

    def run(codes, fmt, s, b):
        entries = s.numel()
        out = torch.empty(codes.shape, dtype=torch.float32, device="cuda")
        build.check(lib.omc_dequantize(
            codes.data_ptr(), fmt.container_bytes_per_value, s.data_ptr(), b.data_ptr(),
            out.data_ptr(), codes.numel() // entries, entries, fmt.exp_bits, fmt.mant_bits,
            torch.cuda.current_stream().cuda_stream), "dequantize")
        return out
    return run


def bench(libs, timer) -> list:
    runners = {"this tree": qk.dequantize}
    runners.update({k: runner(lib) for k, lib in libs.items()})
    rows = []
    for name, shape, batch_axes in (("S1E3M7", cs.EMBED, 0), ("S1E3M7", cs.MLP_SLICE, 0),
                                    ("S1E3M7", cs.TRAIN_LEAF, 1),
                                    ("S1E4M14", cs.TRAIN_LEAF, 1)):
        fmt = FloatFormat.parse(name)
        x = cs._inputs(shape, fmt, seed=sum(shape), specials=False)
        codes = qk.quantize_stats(x, fmt, batch_axes)[0]
        del x
        lead = tuple(shape[:batch_axes])
        bshape = lead + (1,) * (len(shape) - batch_axes)
        g = torch.Generator(device="cuda").manual_seed(len(shape))
        s = (1 + 0.05 * torch.randn(lead, generator=g, device="cuda")).reshape(bshape)
        b = (0.01 * torch.randn(lead, generator=g, device="cuda")).reshape(bshape)
        want = ref.ref_dequantize(codes, fmt, s, b)
        for k, fn in runners.items():
            got = fn(codes, fmt, s, b)
            torch.cuda.synchronize()
            cs.require(bit_equal(got, want), f"dequantize {k} differs {name} {shape}")
            del got
        del want
        run = {k: (lambda fn=fn: fn(codes, fmt, s, b)) for k, fn in runners.items()}
        row = dict(kernel="dequantize", fmt=name, shape=list(shape), entries=math.prod(lead),
                   plan=qk.dequantize_plan(codes, fmt, s),
                   bound_ms=cs.bound_ms(codes.numel() * (fmt.container_bytes_per_value + 4)),
                   device_ms=abba(runners, lambda k: timer.device(run[k])),
                   ms=abba(runners, lambda k: timer(run[k])))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del codes
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a tree whose kernel is timed beside this one")
    ap.add_argument("--variants", action="store_true", help="time the design alternatives")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_dequantize: no CUDA device available")
    env = cs.phase_environment()
    libs = build_libs(args.parent, args.variants)
    rows = bench(libs, cs.Timer())
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), smi=env["smi"], cases=rows)))


if __name__ == "__main__":
    main()
