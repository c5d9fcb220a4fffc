#!/usr/bin/env python3
"""Kernel micro-bench on the port: codec, bitpack and fused-aggregate times
against their byte bounds (counterpart of ``benchmarks/kernels_micro.py``).

Three tables, at the reference's sizes:

  * codec: ``quantize`` (B3), ``dequantize`` (B2) on a [1024, 1024] f32
    matrix and ``dequant_matmul`` (B6) of a [256, 1024] matrix by it, in
    S1E3M7 and S1E4M14;
  * bitpack: ``pack`` / ``unpack`` (B4) at every zoo width (2, 6, 11, 16, 19,
    32) on u32 codes: the bytes the kernel moves
    (``bitpack.pack_moved_bytes`` / ``unpack_moved_bytes``) over the roofline
    bound (``roofline.analysis.packbits_bound_bytes``);
  * fused aggregate (B5): one compressed-domain server round at cohort 8 in
    S1E3M7 and S1E4M14, moved bytes (``agg.fused_aggregate_moved_bytes``)
    over ``fused_aggregate_bound_bytes``, beside the plain version's time.

It asserts the reference's acceptance: every moved byte count within 2x of
its bound.  Each row carries ``bound_ms``, the least time an H100 could
take (``launch.mesh``'s data-sheet rates: bytes over ``HBM_BW``, or for
``dequant_matmul`` its tile path's TF32 passes over ``PEAK_FLOPS_TF32``,
whichever is larger), and the device it ran on.

    python3 benchmarks_torch/kernels_micro.py                        # on the card
    python3 benchmarks_torch/kernels_micro.py --smoke --device cpu   # CI size, plain versions

On the card the kernels run through ``kernels.ops`` and are timed with CUDA
events (median of 20 after 3 warm-ups, the L2 cache flushed before each
launch), and each row carries the card's name and power limit
(``nvidia-smi``).  On the CPU (``--device cpu``) the same wrappers run the
plain versions, timed by the host clock (median of 5): those times are the
CPU's, not a device metric, and carry no share of the bound.  Without a card
and without ``--device cpu`` it raises.  Writes
``experiments/bench_torch/kernels_micro[_smoke].json``.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks_torch.common import print_table, save_result  # noqa: E402
from repro_torch.core.formats import FloatFormat  # noqa: E402
from repro_torch.core.store import compress_variable  # noqa: E402
from repro_torch.kernels import agg, bitpack, ops, ref  # noqa: E402
from repro_torch.kernels import dequant_matmul as dm  # noqa: E402
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_TF32  # noqa: E402
from repro_torch.roofline.analysis import (  # noqa: E402
    fused_aggregate_bound_bytes,
    packbits_bound_bytes,
)

# (label, width): every zoo format width + the ternary 2-bit codes
PACK_WIDTHS = [("ternary", 2), ("S1E2M3", 6), ("S1E3M7", 11),
               ("S1E5M10", 16), ("S1E4M14", 19), ("S1E8M23", 32)]
MAX_MOVED_OVER_BOUND = 2.0
COHORT = 8


def card_info() -> str:
    """``name, power limit`` of the card as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


class Timer:
    """Milliseconds of one call: on the card the median CUDA-event time of 20
    launches after 3 warm-ups, the L2 cache flushed before each; on the CPU
    the median host time of 5 calls after one."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._flush = (torch.empty(64 << 20, dtype=torch.int32, device=device)  # 256 MiB
                       if self.cuda else None)

    def __call__(self, fn) -> float:
        if not self.cuda:
            fn()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)
        for _ in range(3):
            fn()
        times = []
        for _ in range(20):
            self._flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bytes_ms(nbytes: int) -> float:
    return nbytes / HBM_BW * 1e3


def _share(row: dict, timer: Timer) -> dict:
    """The kernel's share of its bound, on the card only."""
    if timer.cuda:
        row["share"] = row["bound_ms"] / row["ms"]
    return row


def _codec_rows(timer: Timer, device: torch.device):
    rows = []
    g = torch.Generator(device=device).manual_seed(0)
    for fmt_s in ("S1E3M7", "S1E4M14"):
        fmt = FloatFormat.parse(fmt_s)
        cb = fmt.container_bytes_per_value
        x = torch.randn((1024, 1024), generator=g, device=device)
        a = torch.randn((256, 1024), generator=g, device=device)
        v = compress_variable(x * 0.02, fmt)
        n = x.numel()
        (m, k), nn = a.shape, x.shape[1]
        mm_bytes = dm.dequant_matmul_moved_bytes(m, k, nn, fmt)
        mm_ops = dm.kernel_variant(fmt)[1] * dm.dequant_matmul_flops(m, k, nn) / PEAK_FLOPS_TF32
        for name, fn, plain, moved, ops_ms in (
                ("quantize", lambda: ops.quantize(x, fmt), lambda: ref.ref_quantize(x, fmt),
                 (4 + cb) * n, 0.0),
                ("dequantize", lambda: ops.dequantize(v.codes, fmt, v.s, v.b),
                 lambda: ref.ref_dequantize(v.codes, fmt, v.s, v.b), (cb + 4) * n + 8, 0.0),
                ("dequant_matmul", lambda: ops.dequant_matmul(a, v.codes, fmt, v.s, v.b),
                 lambda: ref.ref_dequant_matmul(a, v.codes, fmt, v.s, v.b), mm_bytes,
                 mm_ops * 1e3)):
            bound = max(bytes_ms(moved), ops_ms)
            rows.append(_share(dict(
                kernel=name, fmt=fmt_s, shape=list(a.shape) + [nn] if name == "dequant_matmul"
                else list(x.shape), ms=timer(fn), plain_ms=timer(plain), moved_bytes=moved,
                bound_ms=bound, bound_by="bytes" if bytes_ms(moved) >= ops_ms
                else f"operations (TF32 x {dm.kernel_variant(fmt)[1]})"), timer))
    print_table("Codec kernels (B3, B2, B6)", rows,
                ["kernel", "fmt", "shape", "ms", "plain_ms", "bound_ms", "bound_by", "share"])
    return rows


def _pack_rows(n: int, timer: Timer, device: torch.device):
    rows = []
    for label, width in PACK_WIDTHS:
        rng = np.random.default_rng(width)
        codes = torch.from_numpy(rng.integers(
            0, (1 << width) - 1 if width < 32 else 0xFFFFFFFF, size=n, endpoint=True,
            dtype=np.uint64).astype(np.uint32)).to(device)
        words = ops.pack_bits(codes, width)
        bound = packbits_bound_bytes(n, width)
        moved = dict(pack=bitpack.pack_moved_bytes(n, width, torch.uint32),
                     unpack=bitpack.unpack_moved_bytes(n, width, torch.uint32))
        for op, ratio in ((op, m / bound) for op, m in moved.items()):
            assert ratio <= MAX_MOVED_OVER_BOUND, (
                f"{op} width={width}: moved {moved[op]} B > {MAX_MOVED_OVER_BOUND}x roofline "
                f"bound {bound} B")
        rows.append(dict(fmt=label, width=width, n=n,
                         pack_ms=timer(lambda: ops.pack_bits(codes, width)),
                         unpack_ms=timer(lambda: ops.unpack_bits(words, width, n)),
                         moved_bytes=moved["pack"], bound_bytes=bound,
                         bound_ms=bytes_ms(bound), moved_over_bound=moved["pack"] / bound,
                         unpack_moved_over_bound=moved["unpack"] / bound))
        if timer.cuda:
            rows[-1].update(pack_share=rows[-1]["bound_ms"] / rows[-1]["pack_ms"],
                            unpack_share=rows[-1]["bound_ms"] / rows[-1]["unpack_ms"])
    print_table("Exact-width bitpack, B4 (bytes against the roofline bound)", rows,
                ["fmt", "width", "n", "pack_ms", "unpack_ms", "bound_ms", "moved_bytes",
                 "bound_bytes", "moved_over_bound", "unpack_moved_over_bound"])
    return rows


def _fused_rows(n: int, timer: Timer, device: torch.device, cohort: int = COHORT):
    rows = []
    g = torch.Generator(device=device).manual_seed(3)
    for fmt_s in ("S1E3M7", "S1E4M14"):
        fmt = FloatFormat.parse(fmt_s)
        srv = ref.ref_quantize(torch.randn((n,), generator=g, device=device), fmt)
        cl = ref.ref_quantize(torch.randn((cohort, n), generator=g, device=device) * 0.7, fmt)
        one = torch.ones((), device=device)
        zero = torch.zeros((), device=device)
        s1 = torch.ones((cohort,), device=device)
        b0 = torch.zeros((cohort,), device=device)
        w = torch.ones((cohort,), device=device)
        args = (srv, one, zero, cl, s1, b0, w, 0.5, fmt)
        moved = agg.fused_aggregate_moved_bytes(cohort, n, fmt)
        bound = fused_aggregate_bound_bytes(cohort, n, fmt.container_bytes_per_value)
        ratio = moved / bound
        assert ratio <= MAX_MOVED_OVER_BOUND, (
            f"fused {fmt_s}: moved {moved} B > {MAX_MOVED_OVER_BOUND}x roofline bound {bound} B")
        rows.append(_share(dict(
            fmt=fmt_s, cohort=cohort, n=n, ms=timer(lambda: ops.fused_aggregate(*args)),
            plain_ms=timer(lambda: ref.ref_fused_aggregate(*args)), moved_bytes=moved,
            bound_bytes=bound, bound_ms=bytes_ms(bound), moved_over_bound=ratio,
            unfused_extra_f32_bytes=(cohort + 1) * n * 4), timer))
    print_table("Fused compressed-domain aggregate, B5 (cohort round)", rows,
                ["fmt", "cohort", "n", "ms", "plain_ms", "bound_ms", "share", "moved_bytes",
                 "bound_bytes", "moved_over_bound"])
    return rows


def run(smoke: bool = False, device: str = "cuda") -> dict:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run the plain "
                           "versions on the CPU")
    n_pack = 1 << 16 if smoke else 1 << 20
    n_fused = 1 << 14 if smoke else 1 << 18
    timer = Timer(dev)
    device = card_info() if dev.type == "cuda" else "cpu (plain versions)"
    payload = dict(device=device, codec=_codec_rows(timer, dev),
                   bitpack=_pack_rows(n_pack, timer, dev),
                   fused_aggregate=_fused_rows(n_fused, timer, dev))
    for rows in (payload["codec"], payload["bitpack"], payload["fused_aggregate"]):
        for row in rows:
            row["device"] = device
    save_result("kernels_micro_smoke" if smoke else "kernels_micro", payload)
    return payload


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="the reference's CI sizes")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(smoke=args.smoke, device=args.device)
    print(f"\n{out['device']}")


if __name__ == "__main__":
    main()
