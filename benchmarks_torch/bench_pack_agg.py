#!/usr/bin/env python3
"""B4 ``pack`` and B5 ``fused_aggregate`` on the card, beside their design alternatives.

    python3 benchmarks_torch/bench_pack_agg.py [--parent DIR] [--variants]

Times the two kernels at chip_smoke's shapes: ``pack`` on the tied embedding
[151936, 2048] and the stacked w1 leaf [36, 2048, 11008] (S1E3M7, 11 bits
in u16) and on 8 Mi codes of 6 bits in u8 and of 19 bits in u32;
``fused_aggregate`` on conformer_s' leaves [17, 512, 2048], [17, 512, 512]
and [512, 1024] in S1E3M7 and [17, 512, 2048] in S1E4M3, at cohort 8 with
clients 1 and 6 dead (and [17, 512, 2048] with none dead).  Each time is
taken twice, in the order A B ... B A, by CUDA events around the call
(``chip_smoke.Timer``: median of 20, L2 flushed; for small calls it reads the
host's time to launch) and, for ``fused_aggregate``, by the profiler's
device time alone (``Timer.device``).  Every result is checked bit for bit
against the plain version first.

``--parent DIR``: also build and time the kernels of another tree, e.g. the
parent commit unpacked with ``git archive <commit> | tar -x -C DIR`` into a
directory that ``.gitignore`` lists; its C interface may be this tree's or
the one before the single-launch ``fused_aggregate`` (a separate reduce
launch, no tickets).

``--variants``: also build this tree's sources with one line changed, to
compare the designs that were chosen against: ``pack`` loading its tiles
through registers with plain 16-byte loads (``loads``); ``fused_aggregate``
with tables for S1E3M7 (``tables``), with the run-time decode for every
format (``runtime``), with 1, 2 or 8 items a thread (``iters1`` ...), 8
clients' loads in flight (``batch8``), and half the minimum grid
(``fill528``).

One JSON line per case, then one for the run with the card's name and
power limit.  About two minutes on an H100 with both options.
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

from repro_torch.core import packing  # noqa: E402
from repro_torch.core.formats import FloatFormat, narrow, widen  # noqa: E402
from repro_torch.core.store import bit_equal  # noqa: E402
from repro_torch.kernels import agg, build, ref  # noqa: E402
from repro_torch.kernels import bitpack as bk  # noqa: E402
from repro_torch.kernels import quantize as qk  # noqa: E402

OUT = cs.ROOT / "build" / "bench_pack_agg"
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_PARENT_AGG = [_P, _P, _P, _P, _P, _P, _P, _I, _F, _P, _I, _P, _P, _LL, _I, _I, _I, _P]

PLAIN_LOADS = (  # pack's tile loads through registers instead of cp.async
    ('      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(smem_addr(slot)),\n'
     '                   "l"(src + f0));\n',
     "      *slot = __ldg(reinterpret_cast<const uint4*>(src + f0));\n"),)
S1E3M7_LINE = ("  if (container_bytes == 2 && exp_bits == 3 && mant_bits == 7) "
               "return kDecodeS1E3M7;\n")
AGG_VARIANTS = {
    "tables": ((S1E3M7_LINE, ""),),
    "runtime": ((S1E3M7_LINE, "  return kDecodeRuntime;\n"),),
    "iters1": (("kMinIters = 4;", "kMinIters = 1;"),),
    "iters2": (("kMinIters = 4;", "kMinIters = 2;"),),
    "iters8": (("kMinIters = 4;", "kMinIters = 8;"),),
    "batch8": (("kClientBatch = 4;", "kClientBatch = 8;"),),
    "fill528": (("kFillBlocks = 132 * 8;", "kFillBlocks = 132 * 4;"),),
}


def _patched(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"bench_pack_agg: the source no longer has {old.strip()!r}")
        src = src.replace(old, new)
    return src


def build_libs(parent: Path | None, variants: bool) -> dict:
    """name -> (CDLL, interface); one nvcc per library, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}  # name -> (sources, include dir, interface)
    if parent is not None:
        csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
        jobs["parent"] = ([csrc / "bitpack.cu", csrc / "agg.cu"], csrc, None)
    if variants:
        pack_src = (build.CSRC / "bitpack.cu").read_text()
        (OUT / "bitpack_loads.cu").write_text(_patched(pack_src, PLAIN_LOADS))
        jobs["loads"] = ([OUT / "bitpack_loads.cu"], build.CSRC, "pack")
        agg_src = (build.CSRC / "agg.cu").read_text()
        for name, edits in AGG_VARIANTS.items():
            (OUT / f"agg_{name}.cu").write_text(_patched(agg_src, edits))
            jobs[name] = ([OUT / f"agg_{name}.cu"], build.CSRC, "agg")
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(inc), "-shared", "-o",
         str(OUT / f"lib_{name}.so"), *map(str, srcs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (srcs, inc, _) in jobs.items()}
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"bench_pack_agg: building {name} failed:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(OUT / f"lib_{name}.so"))
        kind = jobs[name][2]
        if name == "parent":
            kind = "agg" if hasattr(lib, "omc_fused_aggregate_plan") else "agg_parent"
        for fn, (restype, argtypes) in build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
        if kind == "agg_parent":
            lib.omc_fused_aggregate_blocks.restype = _LL
            lib.omc_fused_aggregate_blocks.argtypes = [_LL, _I]
            lib.omc_fused_aggregate.argtypes = _PARENT_AGG
        libs[name] = (lib, kind)
    return libs


def pack_runner(lib):
    def run(flat, width):
        n = flat.numel()
        nwords = packing.packed_words(n, width)
        words = torch.empty(nwords, dtype=torch.uint32, device="cuda")
        build.check(lib.omc_pack(flat.data_ptr(), flat.dtype.itemsize, words.data_ptr(), n,
                                 nwords, width, torch.cuda.current_stream().cuda_stream), "pack")
        return words
    return run


def agg_runner(lib, kind):
    """The wrapper's launch through another library (``kind`` "agg": this
    tree's C interface; "agg_parent": a separate reduce launch, no tickets)."""
    tickets = torch.zeros(agg.MAX_ENTRIES, dtype=torch.int32, device="cuda")

    def run(args, fmt, batch_axes):
        lay = agg.layout(*args, batch_axes)
        (entries, m), c = lay.srv.shape, lay.cl.shape[0]
        out = torch.empty(args[0].shape, dtype=fmt.container_dtype, device="cuda")
        if kind == "agg":
            p = (ctypes.c_longlong * 4)()
            build.check(lib.omc_fused_aggregate_plan(
                lay.srv.data_ptr(), lay.cl.data_ptr(), out.data_ptr(), m, entries, c,
                fmt.container_bytes_per_value, fmt.exp_bits, fmt.mant_bits,
                ctypes.addressof(p)), "plan")
            blocks = p[0]
        else:
            blocks = lib.omc_fused_aggregate_blocks(m, entries)
        scratch = torch.empty(entries * 4 * (1 + blocks), device="cuda")
        head = (lay.srv.data_ptr(), lay.srv_s.data_ptr(), lay.srv_b.data_ptr(), lay.cl.data_ptr(),
                lay.cl_s.data_ptr(), lay.cl_b.data_ptr(), lay.w.data_ptr(), c, 0.7,
                out.data_ptr(), fmt.container_bytes_per_value,
                scratch.data_ptr() + 16 * entries, scratch.data_ptr())
        extra = (tickets.data_ptr(),) if kind == "agg" else ()
        build.check(lib.omc_fused_aggregate(*head, *extra, m, entries, fmt.exp_bits,
                                            fmt.mant_bits, torch.cuda.current_stream().cuda_stream),
                    "fused_aggregate")
        return out, scratch[:entries * 4].view(entries, 4)
    return run


def abba(names, measure) -> dict:
    """Each name measured twice, in the order A B ... B A."""
    times = {}
    for name in list(names) + list(names)[::-1]:
        times.setdefault(name, []).append(measure(name))
    return times


def bench_pack(libs, timer) -> list:
    runners = {"this tree": bk.pack}
    runners.update({k: pack_runner(lib) for k, (lib, kind) in libs.items()
                    if kind in ("pack", "agg", "agg_parent")
                    and k in ("parent", "loads")})
    rows = []
    for shape, width, dtype in ((cs.EMBED, 11, torch.uint16), (cs.STACKED_MLP, 11, torch.uint16),
                                ((8 << 20,), 6, torch.uint8), ((8 << 20,), 19, torch.uint32)):
        n = math.prod(shape)
        g = torch.Generator(device="cuda").manual_seed(width)
        flat = narrow(torch.randint(0, 1 << width, (n,), generator=g, device="cuda"), dtype)
        want = ref.ref_pack(flat[-(1 << 20):], width) if n * width % 32 == 0 else None
        for name, fn in runners.items():
            words = fn(flat, width)
            torch.cuda.synchronize()
            if want is not None:
                cs.require(bit_equal(words[-want.numel():], want), f"pack {name} differs")
            del words
        reps = 5 if n > 4e8 else 20
        row = dict(kernel="pack", shape=list(shape), width=width, container=str(dtype),
                   bound_ms=cs.bound_ms(n * dtype.itemsize + 4 * packing.packed_words(n, width)),
                   ms=abba(runners, lambda k: timer(lambda: runners[k](flat, width), reps=reps)))
        print(json.dumps(row))
        rows.append(row)
        del flat
        torch.cuda.empty_cache()
    return rows


def bench_agg(libs, timer) -> list:
    runners = {"this tree": lambda a, f, b: agg.fused_aggregate(*a, 0.7, f, batch_axes=b)}
    runners.update({k: agg_runner(lib, kind) for k, (lib, kind) in libs.items()
                    if kind in ("agg", "agg_parent")})
    rows = []
    for name, shape, batch_axes, dead in (
            ("S1E3M7", cs.TRAIN_LEAF, 1, (1, 6)), ("S1E3M7", (17, 512, 512), 1, (1, 6)),
            ("S1E3M7", (512, 1024), 0, (1, 6)), ("S1E3M7", cs.TRAIN_LEAF, 1, ()),
            ("S1E4M3", cs.TRAIN_LEAF, 1, (1, 6))):
        fmt = FloatFormat.parse(name)
        g = torch.Generator(device="cuda").manual_seed(sum(shape))
        lead = tuple(shape[:batch_axes])
        srv = qk.quantize(torch.randn(shape, generator=g, device="cuda") * 0.05, fmt)
        cl = widen(qk.quantize(torch.randn((cs.COHORT,) + shape, generator=g, device="cuda")
                               * 0.05, fmt))
        w = torch.ones(cs.COHORT, device="cuda")
        nan_code = (((1 << fmt.exp_bits) - 1) << fmt.mant_bits) | (1 << (fmt.mant_bits - 1))
        for c in dead:
            w[c] = 0.0
            cl[c] = nan_code
        args = (srv, 1 + 0.05 * torch.randn(lead, generator=g, device="cuda"),
                0.01 * torch.randn(lead, generator=g, device="cuda"),
                narrow(cl, fmt.container_dtype),
                1 + 0.05 * torch.randn((cs.COHORT,) + lead, generator=g, device="cuda"),
                0.01 * torch.randn((cs.COHORT,) + lead, generator=g, device="cuda"), w)
        del cl
        want = ref.ref_fused_aggregate(*args, 0.7, fmt, batch_axes=batch_axes)
        for k, fn in runners.items():
            codes, sums = fn(args, fmt, batch_axes)
            torch.cuda.synchronize()
            cs.require(bit_equal(codes, want[0]), f"fused_aggregate {k} codes differ {shape}")
            cs.require(torch.allclose(sums, want[1], rtol=1e-4, atol=1e-4),
                       f"fused_aggregate {k} sums differ {shape}")
        entries = math.prod(lead)
        n = srv.numel()
        run = {k: (lambda fn=fn: fn(args, fmt, batch_axes)) for k, fn in runners.items()}
        row = dict(kernel="fused_aggregate", fmt=name, shape=list(shape), cohort=cs.COHORT,
                   dead=len(dead), plan=agg.plan(agg.layout(*args, batch_axes), fmt),
                   bound_ms=cs.bound_ms(agg.fused_aggregate_moved_bytes(
                       cs.COHORT, n, fmt, stack_entries=entries, live=cs.COHORT - len(dead))),
                   bound_all_planes_ms=cs.bound_ms(agg.fused_aggregate_moved_bytes(
                       cs.COHORT, n, fmt, stack_entries=entries)),
                   device_ms=abba(runners, lambda k: timer.device(run[k])),
                   ms=abba(runners, lambda k: timer(run[k])))
        print(json.dumps(row))
        rows.append(row)
        del args, srv, want
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a tree whose kernels are timed beside these")
    ap.add_argument("--variants", action="store_true", help="time the design alternatives")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_pack_agg: no CUDA device available")
    env = cs.phase_environment()
    libs = build_libs(args.parent, args.variants)
    timer = cs.Timer()
    rows = bench_pack(libs, timer) + bench_agg(libs, timer)
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), smi=env["smi"], cases=rows)))


if __name__ == "__main__":
    main()
