#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase's failure is caught:

  1. Environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, the CPU's instruction set as ATen dispatches it and its
     threads (the plain versions' side), and the build of the kernels from
     ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel,
     sm_90a), with its time.
  2. Each of the seven kernels against its plain PyTorch version, on the card:
     at the serve path's shapes (qwen2.5-3b's MLP slice [2048, 11008] and
     embedding [151936, 2048] in S1E3M7), at the training path's shapes
     (``quantize`` on a transport stack [8, 17, 512, 2048] and a storage leaf
     [17, 512, 2048]; ``fused_aggregate`` on conformer_s leaves [17, 512, 2048]
     and [17, 512, 512] stacked, and [512, 1024] flat, at cohort 8) and at
     small odd-tail shapes in S1E2M3 (u8) and S1E4M14 (u32): codes, streams
     and decodes bit-exact, PVT sums within rtol=1e-4.  ``pack`` at every
     width 1-32 in every container it fits, at tile and superblock edges
     and odd tails, aligned and one element off, its C tiling
     ``pack_plan``'s.  ``fused_aggregate`` in each of its variants at a
     cohort where it applies (S1E3M7 compiled in at C = 1, 8, 33; tables for
     S1E4M3 and S1E2M3; the run-time decode for S1E5M10 and S1E4M14), on
     vectors and scalars, with a NaN code in a live row too: the variant the
     one ``kernel_variant`` states, and codes and sums the same bits from
     two launches with a launch on all-NaN client codes between them; its
     bound counts the live client planes (a dead client's is never read).  ``dequant_matmul``
     at the serve paths' products in S1E3M7 (decode [4, 2048]x[2048, 11008],
     [4, 11008]x[11008, 2048], [4, 2048]x[2048, 256], [4, 2560]x[2560, 7680];
     prefill [128, 2048]x[2048, 11008], and the prefill products whose tile
     splits K over a cluster: qwen's [128, 2048]x[2048, 2048], [128, 2048]x
     [2048, 256] and [128, 11008]x[11008, 2048], griffin's [128, 2560]x
     [2560, 256] and [128, 7680]x[7680, 2560]), odd tails [3, 37]x[37, 53]
     in u8 and u32, and per-entry (s, b) of a doubly stacked leaf, all with
     b != 0: elementwise within 2e-5 * (|A| @ |s*dec(W) + b|), the same bits
     from two launches with a launch on an all-NaN A between them, the
     kernel's variant (decode, TF32 passes) the one ``kernel_variant``
     states, the error over the bound printed for each; and every
     finite code of S1E2M3, S1E3M7, S1E4M3, S1E5M10 and S1E4M14 decoded
     inside the kernel, on both of its paths, exactly as the plain decode.
     Kernel and plain version are timed with CUDA events (3 warm-ups,
     median of 20, L2 flushed before each launch); ``pack`` and
     ``fused_aggregate`` also by the profiler's device time alone; beside
     ``dequant_matmul``, ``torch.matmul`` on the pre-decoded f32 weight
     ("matmul alone", not the same function), and its bound both ways:
     the tile path's TF32 passes over the tensor cores' rate, and f32
     operations over the rate outside them.
  3. Serve at full width: ``repro_torch.launch.serve.run`` on qwen2.5-3b,
     S1E3M7, --wire-roundtrip, batch 4, prompt 32, 16 new tokens — init on
     the card, compress (quantize_stats), encode (pack), hot-swap (unpack,
     checked bit-identical), prefill and decode (dequant_matmul for the 252
     block matrices, dequantize for the embedding rows and the tied head) —
     then three more request batches through ``ServeSession.generate``.
     Launch counters are zeroed just before and read just after: 252
     ``dequant_matmul`` and 2 ``dequantize`` launches per forward pass, every
     serve kernel launched, no plain version run.
  4. Card against CPU at full width: the served storage tree cut to 2 layers,
     prefill and 2 decode steps on the card (kernels), twice (the same bits
     both times), and on the CPU (plain versions); the largest logit
     difference must be <= 1e-3.  The sha256 of each step's logits, on the
     card and on the CPU, is printed, so that runs can be compared.
  5. Serve recurrentgemma-2b (griffin) at full width the same way (26 layers,
     d 2560, vocab 256,000; batch 4, prompt 32, 16 new tokens, with the wire
     roundtrip): 200 ``dequant_matmul`` and 20 ``dequantize`` launches per
     forward pass, no plain version run, payload ratio <= 0.35.
  6. Card against CPU for griffin: its storage cut to 5 layers (the first
     super block and the two extra recurrent blocks) at full width, prefill
     and 2 decode steps, as in phase 4.
  7. Federated training at full width through the engine
     (``engine.run_training_vectorized``, ``engine.run_round_vectorized``):
     conformer_s (17 layers, d 512), random weights from a seed on the card,
     the synthetic frame task (80-dim frames, 1024 classes, 256 frames, 16
     clients, batch 8), cohort 8 of 16 with failure rate 0.25, 2 local steps
     at lr 0.1, S1E3M7 with PVT and PPQ 0.9.  After a warm round: 3 rounds
     with ``fused_agg=True``, 3 unfused rounds from the same seed (ledgers
     byte-equal, trees within max 6e-3 and mean 1e-3), and one fused round
     with PVT off (Table 4's "quant" row).  Counters are zeroed around each
     run: ``fused_aggregate`` 13 launches per fused round, ``quantize`` in the
     PVT-off run, ``quantize_stats`` and ``dequantize`` in every run, no
     plain version anywhere.
  8. Card against CPU for training: the same configuration cut to 2 layers
     at full width, cohort 4, 1 fused round of 1 local step, on the card
     (kernels) and on the CPU (plain versions): ledgers equal, trees within
     the gate of phase 7.

It then prints one JSON line describing each kernel and, last, the line
``{"ok": true, "device": {...}}``.  f32 matmuls run in full f32: TF32 is
switched off for matmuls and cuDNN.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.api.session import ServeSession  # noqa: E402
from repro_torch.configs import conformer_s, qwen2_5_3b, recurrentgemma_2b  # noqa: E402
from repro_torch.core import packing, prng  # noqa: E402
from repro_torch.core.formats import FloatFormat, narrow, widen  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.core.store import bit_equal, compress_variable, decompress_tree  # noqa: E402
from repro_torch.core.tree import tree_items, tree_map  # noqa: E402
from repro_torch.data.synthetic import make_frame_task  # noqa: E402
from repro_torch.federated import accounting, engine, simulate  # noqa: E402
from repro_torch.federated.cohort import CohortPlan  # noqa: E402
from repro_torch.federated.state import compress_params  # noqa: E402
from repro_torch.kernels import agg  # noqa: E402
from repro_torch.kernels import bitpack as bk  # noqa: E402
from repro_torch.kernels import dequant_matmul as dm  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import quantize as qk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import conformer, griffin, transformer  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores (NVIDIA data sheet)
TF32_FLOP_PER_S = 494.7e12  # H100 SXM dense TF32 tensor-core rate (NVIDIA data sheet)
FMT = FloatFormat.parse("S1E3M7")
CFG = qwen2_5_3b.config()
MLP_SLICE = (CFG.d_model, CFG.d_ff)  # one layer's w1 / w3
EMBED = (CFG.vocab, CFG.d_model)
STACKED_MLP = (CFG.n_layers, CFG.d_model, CFG.d_ff)  # a stacked w1 leaf
GCFG = recurrentgemma_2b.config()
DECODE_W1 = (4, CFG.d_model, CFG.d_ff)  # (M, K, N) of a decode step's w1 product
PREFILL = 128  # rows of A in a 4 x 32 prefill
# (M, K, N) of the serve paths' products: decode w1, w2, wk, prefill w1 and
# griffin's decode w1; then the prefill products whose tile splits K over a
# cluster of blocks: qwen's wq/wo, wk/wv and w2, griffin's wk/wv and w2
DM_SERVE = [DECODE_W1, (4, CFG.d_ff, CFG.d_model), (4, CFG.d_model, CFG.kv_dim),
            (PREFILL, CFG.d_model, CFG.d_ff), (4, GCFG.d_model, GCFG.d_ff)]
DM_PREFILL_SPLIT_K = [(PREFILL, CFG.d_model, CFG.q_dim), (PREFILL, CFG.d_model, CFG.kv_dim),
                      (PREFILL, CFG.d_ff, CFG.d_model),
                      (PREFILL, GCFG.d_model, GCFG.n_kv_heads * GCFG.hd),
                      (PREFILL, GCFG.d_ff, GCFG.d_model)]
TRAIN_CFG = conformer_s.config()
TRAIN_LEAF = (TRAIN_CFG.n_layers, TRAIN_CFG.d_model, TRAIN_CFG.d_ff)  # stacked w1 / w2ᵀ
COHORT = 8
VARIANTS = {agg.DECODE_RUNTIME: "decode at run time", agg.DECODE_S1E3M7: "S1E3M7 compiled in",
            agg.TABLE: "tables"}
SOURCES = dict(quantize_stats="src/repro_torch/kernels/csrc/quantize.cu",
               dequantize="src/repro_torch/kernels/csrc/quantize.cu",
               pack="src/repro_torch/kernels/csrc/bitpack.cu",
               unpack="src/repro_torch/kernels/csrc/bitpack.cu",
               quantize="src/repro_torch/kernels/csrc/quantize.cu",
               fused_aggregate="src/repro_torch/kernels/csrc/agg.cu",
               dequant_matmul="src/repro_torch/kernels/csrc/dequant_matmul.cu")
REPLACES = dict(quantize_stats="src/repro/kernels/quantize.py:116",
                dequantize="src/repro/kernels/quantize.py:93",
                pack="src/repro/kernels/bitpack.py:96",
                unpack="src/repro/kernels/bitpack.py:120",
                quantize="src/repro/kernels/quantize.py:77",
                fused_aggregate="src/repro/kernels/agg.py:114",
                dequant_matmul="src/repro/kernels/dequant_matmul.py:58")
SERVE_KERNELS = ("quantize_stats", "dequantize", "pack", "unpack", "dequant_matmul")
# launches per forward pass: block matrices through dequant_matmul; the
# embedding rows, the tied head and griffin's 18 conv_w through dequantize
QWEN_PER_FORWARD = dict(dequant_matmul=7 * CFG.n_layers, dequantize=2)
GRIFFIN_PER_FORWARD = dict(
    dequant_matmul=8 * (GCFG.n_layers - GCFG.n_super) + 7 * GCFG.n_super,
    dequantize=GCFG.n_layers - GCFG.n_super + 2)
TREE_MAX, TREE_MEAN = 6e-3, 1e-3  # the reference engine's fused-vs-unfused gate


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


class Timer:
    """Median CUDA-event time of a call, with the L2 cache flushed before each."""

    def __init__(self):
        self._flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MiB

    def __call__(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self._flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device(self, fn, reps: int = 20, warmup: int = 3) -> float:
        """Device time of one call of ``fn`` from the profiler, with the L2
        cache flushed before each call: the card's time alone, where the host's
        time to launch may exceed it (small calls).  Each kernel ``fn``
        launches once a call; its mean is taken over the launches the profiler
        recorded, and a shortfall is printed (records can be dropped)."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                self._flush.zero_()
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_time_total > 0 and "Fill" not in e.key]  # not the flush
        require(bool(kernels), "the profiler saw no device time")
        for e in kernels:
            if e.count != reps:
                print(f"  profiler: {e.count} of {reps} launches recorded for {e.key[:60]}")
        return sum(e.device_time_total / e.count for e in kernels) / 1e3


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# 1. environment
# ---------------------------------------------------------------------------


def phase_environment() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    print(f"CPU (the plain versions): {torch.backends.cpu.get_cpu_capability()} as ATen "
          f"dispatches it, {torch.get_num_threads()} threads")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    cached = build.library_path().exists()
    t0 = time.perf_counter()
    build.load_library()
    build_s = time.perf_counter() - t0
    print(f"kernels: {build.library_path()} ({'cached' if cached else 'built'} in "
          f"{build_s:.2f} s)")
    log = (build.library_path().parent / "nvcc.log")
    if log.exists():  # ptxas -v: registers of each kernel, and any spills
        lines = log.read_text().splitlines()
        regs = [int(x.split("Used ")[1].split()[0]) for x in lines if "Used " in x]
        spills = [x.strip() for x in lines if "spill" in x and " 0 bytes spill stores" not in x]
        print(f"  ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers; "
              f"{len(spills)} with spills")
        for line in spills:
            print("  ptxas:", line.split("ptxas info    : ")[-1])
    return dict(smi=smi, build_s=build_s)


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------


def _inputs(shape, fmt: FloatFormat, seed: int, specials: bool = True) -> torch.Tensor:
    """Weights-like normals, optionally led by specials (±0, ±inf, NaN, huge,
    f32 subnormals)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda").mul_(0.02)
    if not specials:
        return x
    flat = x.view(-1)
    vals = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                         fmt.max_normal * 4, -fmt.min_normal / 3, 1e-40, -3e-39], device="cuda")
    k = min(flat.numel(), vals.numel())
    flat[:k] = vals[:k]
    return x


def check_quantize_stats(x, fmt, batch_axes, timer=None):
    codes, sums = qk.quantize_stats(x, fmt, batch_axes)
    torch.cuda.synchronize()
    rcodes, rsums = ref.ref_quantize_stats(x, fmt, batch_axes)
    require(bit_equal(codes, rcodes), f"quantize_stats codes differ {fmt.name} {tuple(x.shape)}")
    finite = torch.isfinite(rsums)
    require(torch.equal(finite, torch.isfinite(sums)), "quantize_stats: non-finite sums differ")
    err = (sums[finite] - rsums[finite]).abs().max().item() if finite.any() else 0.0
    require(torch.allclose(sums[finite], rsums[finite], rtol=1e-4, atol=1e-4),
            f"quantize_stats sums differ {fmt.name} {tuple(x.shape)}: max err {err}")
    out = dict(shape=list(x.shape), fmt=fmt.name, max_abs_err=err)
    if timer:
        out.update(ms=timer(lambda: qk.quantize_stats(x, fmt, batch_axes)),
                   plain_ms=timer(lambda: ref.ref_quantize_stats(x, fmt, batch_axes)),
                   bound_ms=bound_ms(x.numel() * (4 + fmt.container_bytes_per_value)))
    return codes, out


def check_dequantize(codes, fmt, timer=None, batch_axes=0):
    """With ``batch_axes``, one (s, b) pair per stacked entry, shaped
    ``[*stack, 1, ...]`` as a stacked ``CompressedVariable`` holds them."""
    lead = tuple(codes.shape[:batch_axes])
    shape = lead + (1,) * (codes.ndim - batch_axes) if batch_axes else ()
    g = torch.Generator(device="cuda").manual_seed(codes.numel())
    s = (1.0 + 0.05 * torch.randn(lead, generator=g, device="cuda")).reshape(shape)
    b = (0.01 * torch.randn(lead, generator=g, device="cuda")).reshape(shape)
    got = qk.dequantize(codes, fmt, s, b)
    torch.cuda.synchronize()
    want = ref.ref_dequantize(codes, fmt, s, b)
    require(bit_equal(got, want), f"dequantize differs {fmt.name} {tuple(codes.shape)}")
    fin = torch.isfinite(want)
    out = dict(shape=list(codes.shape), fmt=fmt.name,
               max_abs_err=(got[fin] - want[fin]).abs().max().item())
    if timer:
        out.update(ms=timer(lambda: qk.dequantize(codes, fmt, s, b)),
                   plain_ms=timer(lambda: ref.ref_dequantize(codes, fmt, s, b)),
                   bound_ms=bound_ms(codes.numel() * (fmt.container_bytes_per_value + 4)))
    return out


def check_pack_unpack(codes, width, timer=None):
    n = codes.numel()
    flat = codes.reshape(-1)
    words = bk.pack(flat, width)
    torch.cuda.synchronize()
    require(bit_equal(words, ref.ref_pack(flat, width)), f"pack differs w={width} n={n}")
    back = bk.unpack(words, width, n, codes.dtype)
    torch.cuda.synchronize()
    require(bit_equal(back, ref.ref_unpack(words, width, n, codes.dtype)),
            f"unpack differs w={width} n={n}")
    require(bit_equal(back, flat), f"unpack(pack(codes)) != codes, w={width} n={n}")
    nbytes = n * codes.dtype.itemsize + 4 * packing.packed_words(n, width)
    outs = [dict(shape=list(codes.shape), width=width, max_abs_err=0.0),
            dict(shape=list(codes.shape), width=width, max_abs_err=0.0)]
    if timer:
        outs[0].update(ms=timer(lambda: bk.pack(flat, width)),
                       device_ms=timer.device(lambda: bk.pack(flat, width)),
                       plain_ms=timer(lambda: ref.ref_pack(flat, width)),
                       bound_ms=bound_ms(nbytes))
        outs[1].update(ms=timer(lambda: bk.unpack(words, width, n, codes.dtype)),
                       plain_ms=timer(lambda: ref.ref_unpack(words, width, n, codes.dtype)),
                       bound_ms=bound_ms(nbytes))
    return outs


def check_pack_widths() -> list:
    """``pack`` at every width 1-32 in every container it fits, at tile
    (8192 fields) and superblock (32) edges and odd tails, from an aligned
    codes pointer and one off the 16-byte grid: the plain version's words,
    ``unpack(pack(x)) == x``, and the C entry's tiling ``pack_plan``'s."""
    rows = []
    tile = bk.TILE_FIELDS
    ns = (1, 33, tile - 1, tile, tile + 1, 3 * tile + 31, 100_003)
    for dtype in (torch.uint8, torch.uint16, torch.uint32):
        for width in range(1, 8 * dtype.itemsize + 1):
            for n in ns:
                g = torch.Generator(device="cuda").manual_seed(n * 64 + width)
                vals = torch.randint(0, min(1 << width, 1 << 31), (n + 1,), generator=g,
                                     device="cuda")
                if width == 32:
                    vals = vals * 2 + (vals & 1)  # reach the top bit too
                codes = narrow(vals, dtype)
                for flat in (codes[:n], codes[1:]):
                    words = bk.pack(flat, width)
                    require(bit_equal(words, ref.ref_pack(flat, width)),
                            f"pack differs w={width} {dtype} n={n} offset={flat.data_ptr() % 16}")
                    require(bit_equal(bk.unpack(words, width, n, dtype), flat),
                            f"unpack(pack(codes)) != codes, w={width} {dtype} n={n}")
                require(bk.kernel_pack_plan(n, width, dtype) == bk.pack_plan(n, width, dtype),
                        f"pack's C tiling differs from pack_plan w={width} {dtype} n={n}")
            rows.append(dict(shape=list(ns), width=width, container=str(dtype), max_abs_err=0.0))
    return rows


def check_quantize(x, fmt, want_codes, timer=None):
    """``quantize`` against its plain version and against ``quantize_stats``'
    codes for the same input: all bit-exact."""
    codes = qk.quantize(x, fmt)
    torch.cuda.synchronize()
    require(bit_equal(codes, want_codes), f"quantize codes differ from quantize_stats' "
            f"{fmt.name} {tuple(x.shape)}")
    require(bit_equal(codes, ref.ref_quantize(x, fmt)),
            f"quantize differs from its plain version {fmt.name} {tuple(x.shape)}")
    out = dict(shape=list(x.shape), fmt=fmt.name, max_abs_err=0.0)
    if timer:
        out.update(ms=timer(lambda: qk.quantize(x, fmt)),
                   plain_ms=timer(lambda: ref.ref_quantize(x, fmt)),
                   bound_ms=bound_ms(x.numel() * (4 + fmt.container_bytes_per_value)))
    return out


def check_fused_aggregate(shape, batch_axes, fmt, timer=None, dead=(1, 6), cohort=COHORT,
                          live_nan=False):
    """``fused_aggregate`` against its plain version: server and client codes
    from random weights, per-entry (s, b), dead clients holding a NaN code
    (with ``live_nan``, one element of live client 0 NaN too).  Codes
    bit-exact, sums within rtol=1e-4 (NaN where the plain version's are);
    the kernel's variant the one ``kernel_variant`` states; the same bits
    from a second launch, after one on all-NaN client codes."""
    g = torch.Generator(device="cuda").manual_seed(sum(shape) + batch_axes + cohort)
    lead = tuple(shape[:batch_axes])
    srv = qk.quantize(torch.randn(shape, generator=g, device="cuda") * 0.05, fmt)
    cl = widen(qk.quantize(torch.randn((cohort,) + shape, generator=g, device="cuda") * 0.05,
                           fmt))
    w = torch.ones(cohort, device="cuda")
    nan_code = (((1 << fmt.exp_bits) - 1) << fmt.mant_bits) | (1 << (fmt.mant_bits - 1))
    for c in dead:
        w[c] = 0.0
        cl[c] = nan_code
    if live_nan:
        require(w[0] > 0, "live_nan needs client 0 alive")
        cl[0].view(-1)[srv.numel() // 2] = nan_code
    args = (srv, 1 + 0.05 * torch.randn(lead, generator=g, device="cuda"),
            0.01 * torch.randn(lead, generator=g, device="cuda"), narrow(cl, fmt.container_dtype),
            1 + 0.05 * torch.randn((cohort,) + lead, generator=g, device="cuda"),
            0.01 * torch.randn((cohort,) + lead, generator=g, device="cuda"), w, 0.7, fmt)
    plan = agg.plan(agg.layout(*args[:7], batch_axes), fmt)
    require(plan["variant"] == agg.kernel_variant(fmt, cohort),
            f"fused_aggregate {fmt.name} C={cohort}: the kernel's variant {plan} is not "
            f"kernel_variant's")
    codes, sums = agg.fused_aggregate(*args, batch_axes=batch_axes)
    all_nan = narrow(torch.full_like(cl, nan_code), fmt.container_dtype)
    agg.fused_aggregate(*args[:3], all_nan, *args[4:], batch_axes=batch_axes)
    again = agg.fused_aggregate(*args, batch_axes=batch_axes)
    torch.cuda.synchronize()
    require(bit_equal(codes, again[0]) and bit_equal(sums, again[1]),
            f"fused_aggregate {fmt.name} {shape} C={cohort}: two launches differ")
    rcodes, rsums = ref.ref_fused_aggregate(*args, batch_axes=batch_axes)
    require(bit_equal(codes, rcodes), f"fused_aggregate codes differ {fmt.name} {shape}")
    finite = torch.isfinite(rsums)
    require(bool(finite.all()) or live_nan, f"fused_aggregate sums not finite {shape}")
    require(torch.equal(finite, torch.isfinite(sums)), f"fused_aggregate: NaN sums differ {shape}")
    err = (sums[finite] - rsums[finite]).abs().max().item() if finite.any() else 0.0
    require(torch.allclose(sums[finite], rsums[finite], rtol=1e-4, atol=1e-4),
            f"fused_aggregate sums differ {fmt.name} {shape}: max err {err}")
    out = dict(shape=list(shape), fmt=fmt.name, cohort=cohort, dead=len(dead), live_nan=live_nan,
               variant=VARIANTS[plan["variant"]], blocks=plan["blocks"], vec=plan["vec"],
               max_abs_err=err, same_bits=True)
    if timer:
        entries = math.prod(lead)
        run = lambda: agg.fused_aggregate(*args, batch_axes=batch_axes)  # noqa: E731
        out.update(ms=timer(run), device_ms=timer.device(run),
                   plain_ms=timer(lambda: ref.ref_fused_aggregate(*args, batch_axes=batch_axes)),
                   bound_ms=bound_ms(agg.fused_aggregate_moved_bytes(
                       cohort, srv.numel(), fmt, stack_entries=entries,
                       live=cohort - len(dead))))
    return out


def check_stacked_mlp(timer) -> dict:
    """The stacked w1 leaf exactly as the serve path compresses and packs it:
    [36, 2048, 11008], batch_axes=1, 811,597,824 codes, 8.9e9 stream bits.
    Too large for the plain versions at once, so they check the first and
    last entries, and the stream's tail beyond bit 2**32."""
    x = _inputs(STACKED_MLP, FMT, seed=3, specials=False)
    codes, sums = qk.quantize_stats(x, FMT, batch_axes=1)
    torch.cuda.synchronize()
    for entry in (0, STACKED_MLP[0] - 1):
        rc, rs = ref.ref_quantize_stats(x[entry], FMT)
        require(bit_equal(codes[entry], rc), f"stacked quantize_stats codes, entry {entry}")
        fin = torch.isfinite(rs)
        require(torch.allclose(sums[entry][fin], rs[fin], rtol=1e-4, atol=1e-4),
                f"stacked quantize_stats sums, entry {entry}")
    ms_stats = timer(lambda: qk.quantize_stats(x, FMT, batch_axes=1), reps=5, warmup=1)
    del x
    n, w = codes.numel(), FMT.bits
    flat = codes.reshape(-1)
    words = bk.pack(flat, w)
    torch.cuda.synchronize()
    require(n * w > 2**32, "stacked leaf should cross 2**32 stream bits")
    tail = (n - (1 << 24)) // 32 * 32  # a field index whose bit offset is a multiple of 32
    require(tail * w > 2**32, "tail should start past bit 2**32")
    require(bit_equal(words[tail * w // 32:], ref.ref_pack(flat[tail:], w)),
            "pack differs past bit 2**32")
    back = bk.unpack(words, w, n, codes.dtype)
    require(bit_equal(back, flat), "unpack(pack(stacked codes)) != codes")
    out = dict(shape=list(STACKED_MLP), quantize_stats_ms=ms_stats,
               quantize_stats_bound_ms=bound_ms(n * (4 + FMT.container_bytes_per_value)),
               pack_ms=timer(lambda: bk.pack(flat, w), reps=5, warmup=1),
               pack_device_ms=timer.device(lambda: bk.pack(flat, w), reps=5, warmup=1),
               unpack_ms=timer(lambda: bk.unpack(words, w, n, codes.dtype), reps=5, warmup=1),
               pack_bound_ms=bound_ms(n * 2 + 4 * words.numel()))
    return out


def check_dequant_matmul(mkn, fmt, timer=None, seed=0, entry=()):
    """``dequant_matmul`` against its plain version, elementwise within
    ``2e-5 * (|A| @ |W_eff|)``: random weights compressed on the card
    (``entry`` indexes a stacked leaf of that many leading entries, each
    with its own (s, b)), the bias moved off zero; a second launch, after
    one on an all-NaN A that leaves NaN in the kernel's shared memory, must
    give the same bits.  The kernel's variant (its decode and the tile
    path's passes) must be the one ``kernel_variant`` states.  Timed:
    ``bound_ms`` is the larger of the bytes over the memory rate and, on the
    tile path, the TF32 passes' operations over the tensor cores' TF32
    rate; ``f32_simt_bound_ms`` beside it divides the f32 operations by the
    rate outside the tensor cores (the SIMT kernel's bound)."""
    m, k, n = mkn
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(tuple(entry) + (k, n), generator=g, device="cuda") * 0.02
    v = compress_variable(w, fmt, batch_axes=len(entry))
    del w
    for i in entry:
        v = v[i - 1]  # the last entry of each stacked axis
    codes, s, b = v.codes, v.s, v.b + 0.003
    a = torch.randn((m, k), generator=g, device="cuda")
    plan = dm.plan(a, codes, fmt)
    require((plan["codec"], plan["passes"]) == dm.kernel_variant(fmt),
            f"dequant_matmul {fmt.name}: the kernel's variant {plan} is not kernel_variant's")
    got = dm.dequant_matmul(a, codes, fmt, s, b)
    dm.dequant_matmul(torch.full_like(a, math.nan), codes, fmt, s, b)
    again = dm.dequant_matmul(a, codes, fmt, s, b)
    torch.cuda.synchronize()
    require(bit_equal(got, again), f"dequant_matmul {fmt.name} {mkn}: two launches differ")
    want = ref.ref_dequant_matmul(a, codes, fmt, s, b)
    w_eff = ref.ref_dequantize(codes, fmt, s, b)
    bound = 2e-5 * (a.abs() @ w_eff.abs())
    err = (got - want).abs()
    require(bool((err <= bound).all()), f"dequant_matmul differs {fmt.name} {mkn} entry {entry}: "
            f"max err {err.max().item()} over a bound of {bound.min().item()}")
    path = plan["path"]
    out = dict(shape=[m, k, n], fmt=fmt.name, path=path, grid=list(plan["grid"]),
               max_abs_err=err.max().item(), max_err_over_bound=(err / bound).max().item(),
               same_bits=True)
    if timer:
        bytes_ms = bound_ms(dm.dequant_matmul_moved_bytes(m, k, n, fmt))
        passes = plan["passes"]
        ops_ms = passes * dm.dequant_matmul_flops(m, k, n) / TF32_FLOP_PER_S * 1e3
        if path == "stream":  # f32 FMAs outside the tensor cores, bound by the bytes
            ops_ms = dm.dequant_matmul_flops(m, k, n) / F32_FLOP_PER_S * 1e3
        out.update(ms=timer(lambda: dm.dequant_matmul(a, codes, fmt, s, b)),
                   plain_ms=timer(lambda: ref.ref_dequant_matmul(a, codes, fmt, s, b)),
                   bound_ms=max(ops_ms, bytes_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else (
                       "operations" if path == "stream" else f"operations (TF32 x {passes})"),
                   f32_simt_bound_ms=max(bytes_ms, dm.dequant_matmul_flops(m, k, n)
                                         / F32_FLOP_PER_S * 1e3),
                   matmul_alone_ms=timer(lambda: torch.matmul(a, w_eff)))
    return out


def check_dequant_matmul_decode(name: str, path: str) -> dict:
    """Every finite code of ``name`` decoded inside the kernel on ``path``:
    the codes laid out as 8 (stream) or 128 (tile) rows of whole 16-code
    vectors, A the identity, s = 1, b = 0, so the product is the decoded
    codes, which must equal the plain decode exactly (as values: -0.0 comes
    out as +0.0)."""
    fmt = FloatFormat.parse(name)
    rows = 8 if path == "stream" else 128
    c = torch.arange(1 << fmt.bits, device="cuda")
    top = (1 << fmt.exp_bits) - 1
    c = c[((c >> fmt.mant_bits) & top) != top]
    cols = -(-c.numel() // (rows * 16)) * 16
    c = torch.cat([c, torch.zeros(rows * cols - c.numel(), dtype=c.dtype, device="cuda")])
    codes = narrow(c.reshape(rows, cols), fmt.container_dtype)
    a = torch.eye(rows, device="cuda")
    one, zero = torch.ones((), device="cuda"), torch.zeros((), device="cuda")
    require(dm.plan(a, codes, fmt)["path"] == path, f"decode check {name}: not on the {path} path")
    got = dm.dequant_matmul(a, codes, fmt, one, zero)
    again = dm.dequant_matmul(a, codes, fmt, one, zero)
    torch.cuda.synchronize()
    require(torch.equal(got, ref.ref_dequantize(codes, fmt)),
            f"dequant_matmul decodes a code of {name} wrongly on the {path} path")
    require(bit_equal(got, again), f"decode check {name} {path}: two launches differ")
    return dict(shape=[rows, rows, cols], fmt=name, path=path, codes=int(c.numel()),
                max_abs_err=0.0, max_err_over_bound=0.0, same_bits=True)


def phase_kernels() -> dict:
    timer = Timer()
    results = {k: [] for k in SOURCES}
    # small odd-tail shapes, other containers (u8, u32), with specials
    for fmt in (FloatFormat.parse("S1E2M3"), FloatFormat.parse("S1E4M14"), FMT):
        for shape, batch_axes in (((129,), 0), ((37, 53), 0), ((3, 1001), 1), ((2, 3, 65), 2)):
            x = _inputs(shape, fmt, seed=sum(shape))
            codes, r = check_quantize_stats(x, fmt, batch_axes)
            results["quantize_stats"].append(r)
            results["dequantize"].append(check_dequantize(codes, fmt, batch_axes=batch_axes))
            results["quantize"].append(check_quantize(x, fmt, codes))
            p, u = check_pack_unpack(codes, fmt.bits)
            results["pack"].append(p)
            results["unpack"].append(u)
    # odd tails at every width the wire uses, incl. 2 and 32
    for width, dtype in ((2, torch.uint8), (6, torch.uint8), (11, torch.uint16),
                         (16, torch.uint16), (19, torch.uint32), (32, torch.uint32)):
        hi = 1 << width
        g = torch.Generator(device="cuda").manual_seed(width)
        vals = torch.randint(0, min(hi, 1 << 31), (1_000_003,), generator=g, device="cuda")
        if width == 32:
            vals = vals * 2 + (vals & 1)  # reach the top bit too
        p, u = check_pack_unpack(narrow(vals, dtype), width)
        results["pack"].append(p)
        results["unpack"].append(u)
    results["pack"] += check_pack_widths()
    # the serve path's shapes, timed
    for shape in (MLP_SLICE, EMBED):
        x = _inputs(shape, FMT, seed=shape[0], specials=False)
        codes, r = check_quantize_stats(x, FMT, 0, timer)
        del x
        results["quantize_stats"].append(r)
        results["dequantize"].append(check_dequantize(codes, FMT, timer))
        p, u = check_pack_unpack(codes, FMT.bits, timer)
        results["pack"].append(p)
        results["unpack"].append(u)
        del codes
    torch.cuda.empty_cache()
    stacked = check_stacked_mlp(timer)
    torch.cuda.empty_cache()
    # the training path's shapes, timed: transport stack and storage leaf
    for shape in ((COHORT,) + TRAIN_LEAF, TRAIN_LEAF):
        x = _inputs(shape, FMT, seed=len(shape), specials=False)
        results["quantize"].append(check_quantize(x, FMT, qk.quantize_stats(x, FMT)[0], timer))
        del x
        torch.cuda.empty_cache()
    # fused_aggregate: odd tails in u8 and u32 with NaN dead rows, every
    # batch_axes, all clients dead; then conformer_s' leaves at cohort 8, timed
    for fmt in (FloatFormat.parse("S1E2M3"), FloatFormat.parse("S1E4M14"), FMT):
        for shape, batch_axes in (((1001,), 0), ((3, 257), 1), ((2, 3, 65), 2)):
            results["fused_aggregate"].append(check_fused_aggregate(shape, batch_axes, fmt))
    results["fused_aggregate"].append(check_fused_aggregate((3, 257), 1, FMT, dead=range(COHORT)))
    # each variant at a cohort where it applies, on 16-byte vectors and on
    # scalars, with a NaN code in a live row too: S1E3M7 compiled in at C =
    # 1 and 33, tables for S1E4M3 and S1E2M3 (u8), the run-time decode for
    # S1E5M10 (u16) and S1E4M14 (u32)
    for name, cohort in (("S1E3M7", 1), ("S1E3M7", 33), ("S1E4M3", 8), ("S1E2M3", 33),
                         ("S1E5M10", 33), ("S1E4M14", 8)):
        for shape in ((17, 4096), (3, 1001)):
            results["fused_aggregate"].append(check_fused_aggregate(
                shape, 1, FloatFormat.parse(name), cohort=cohort,
                dead=() if cohort == 1 else (1, 6), live_nan=True))
    for shape, batch_axes in ((TRAIN_LEAF, 1), ((TRAIN_CFG.n_layers, 512, 512), 1),
                              ((TRAIN_CFG.d_model, TRAIN_CFG.n_classes), 0)):
        results["fused_aggregate"].append(check_fused_aggregate(shape, batch_axes, FMT, timer))
        torch.cuda.empty_cache()
    # dequant_matmul: odd tails in u8 and u32, per-entry (s, b) of a doubly
    # stacked leaf, then the serve paths' products in S1E3M7, timed
    for name in ("S1E2M3", "S1E3M7", "S1E4M3", "S1E5M10", "S1E4M14"):
        for path in ("stream", "tile"):
            results["dequant_matmul"].append(check_dequant_matmul_decode(name, path))
    for fmt in (FloatFormat.parse("S1E2M3"), FloatFormat.parse("S1E4M14"), FMT):
        results["dequant_matmul"].append(check_dequant_matmul((3, 37, 53), fmt, seed=1))
    results["dequant_matmul"].append(check_dequant_matmul((4, 256, 384), FMT, seed=2,
                                                          entry=(2, 2)))
    for mkn in DM_SERVE + DM_PREFILL_SPLIT_K:
        r = check_dequant_matmul(mkn, FMT, timer, seed=sum(mkn))
        require(mkn not in DM_PREFILL_SPLIT_K or r["grid"][1] > 1,
                f"dequant_matmul {mkn}: K is not split over a cluster ({r['grid']})")
        results["dequant_matmul"].append(r)
        torch.cuda.empty_cache()
    for name, rows in results.items():
        for r in rows:
            if "ms" in r:
                print(f"  {name:15s} {str(r['shape']):20s} kernel {r['ms']:.4f} ms  "
                      f"plain {r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms"
                      + (f" ({r['bound_by']}; f32 SIMT bound {r['f32_simt_bound_ms']:.4f} ms)"
                         f"  matmul alone {r['matmul_alone_ms']:.4f} ms"
                         if "matmul_alone_ms" in r else ""))
    for r in results["fused_aggregate"]:
        print(f"  fused_aggregate {r['fmt']} {r['shape']} C={r['cohort']}: {r['variant']}, "
              f"{r['blocks']} blocks an entry, {'vectors' if r['vec'] else 'scalars'}, "
              f"same bits twice {r['same_bits']}"
              + (f", device {r['device_ms']:.4f} ms" if "device_ms" in r else ""))
    for r in results["dequant_matmul"]:
        print(f"  dequant_matmul {r['fmt']} {r['shape']} {r['path']}: max err over bound "
              f"{r['max_err_over_bound']:.4g}, same bits twice {r['same_bits']}")
    print(f"  stacked w1 {stacked}")
    print(f"kernels match their plain versions: "
          f"{ {k: len(v) for k, v in results.items()} } cases")
    return dict(results=results, stacked=stacked)


# ---------------------------------------------------------------------------
# 3-6. serve at full width, card against CPU
# ---------------------------------------------------------------------------


def require_per_forward(counts: dict, run: str, forwards: int, per_forward: dict) -> None:
    """Exact launches of each op for ``forwards`` forward passes, every serve
    kernel launched, and no plain version run."""
    require(not any(k.endswith(".ref") for k in counts), f"{run}: a plain version ran: {counts}")
    for op in SERVE_KERNELS:
        require(counts.get(f"{op}.cuda", 0) > 0, f"{run}: {op} kernel never launched")
    for op, n in per_forward.items():
        got = counts.get(f"{op}.cuda", 0)
        require(got == n * forwards, f"{run}: {op} launched {got} times in {forwards} forward "
                f"passes, expected {n} per pass: {counts}")


def serve_full_width(arch: str, more_batches: int) -> dict:
    """``serve.run`` at full width with the wire roundtrip, batch 4, prompt 32,
    16 new tokens, then ``more_batches`` request batches through
    ``ServeSession.generate``; counters zeroed just before, read just after."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    report = serve.run(serve.parse_args([
        "--arch", arch, "--fmt", FMT.name, "--wire-roundtrip", "--batch", "4",
        "--prompt-len", "32", "--gen", "16", "--quiet"]))
    sess = report.pop("session")
    require(report["swap_bit_identical"], f"{arch}: hot-swapped tree differs from the one encoded")
    require(report["payload_ratio"] <= 0.35, f"{arch}: payload ratio {report['payload_ratio']}")
    vocab = sess.cfg.vocab
    g = torch.Generator(device="cuda").manual_seed(1)
    t0 = time.perf_counter()
    for _ in range(more_batches):
        toks = torch.randint(0, vocab, (4, 32), generator=g, device="cuda")
        _, out = sess.generate(dict(tokens=toks), sess.init_cache(4, 4 * (32 + 16)), 16)
        require(out.shape == (4, 16) and bool(((out >= 0) & (out < vocab)).all()),
                f"{arch}: generate returned bad tokens")
    torch.cuda.synchronize()
    more_ms = (time.perf_counter() - t0) * 1e3
    report.update(forward_passes=1 + 16 + 16 * more_batches, more_batches_ms=more_ms,
                  max_memory_allocated=torch.cuda.max_memory_allocated(),
                  launch_counts=ops.launch_counts(), serve_stats=sess.serve_stats())
    report.pop("tokens")
    for k in ("num_params", "payload_bytes", "fp32_bytes", "payload_ratio", "roundtrip_ms",
              "prefill_ms", "decode_ms_per_token", "tok_per_s", "more_batches_ms",
              "max_memory_allocated", "forward_passes", "launch_counts"):
        print(f"  {arch} {k}: {report[k]}")
    return dict(report=report, session=sess)


def phase_serve() -> dict:
    served = serve_full_width("qwen2.5-3b", more_batches=3)
    report = served["report"]
    require_per_forward(report["launch_counts"], "qwen2.5-3b", report["forward_passes"],
                        QWEN_PER_FORWARD)
    return served


def phase_serve_griffin() -> dict:
    served = serve_full_width("recurrentgemma-2b", more_batches=0)
    report = served["report"]
    require(report["num_params"] == 2_894_528_000, f"griffin params {report['num_params']}")
    require_per_forward(report["launch_counts"], "recurrentgemma-2b", report["forward_passes"],
                        GRIFFIN_PER_FORWARD)
    return served


def card_vs_cpu(run: str, family, cfg, cut) -> float:
    """Prefill and 2 decode steps of ``cut`` on the card (kernels) and on the
    CPU (plain versions); the largest logit difference must be <= 1e-3."""
    gpu = ServeSession(family, cfg, cut)
    cpu = ServeSession(family, cfg, tree_map(lambda x: x.to("cpu"), cut))
    g = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (4, 32), generator=g, device="cuda")

    def steps(sess, tokens, pick=None):
        """The logits of prefill and 2 decode steps, on the host; the decode
        steps take ``pick``'s tokens (else their own argmax)."""
        c, lg = sess.prefill(dict(tokens=tokens), sess.init_cache(4, 64))
        out = [lg.cpu()]
        for i in range(2):
            tok = (pick[i] if pick else torch.argmax(out[-1][:, -1], dim=-1))[:, None]
            c, lg = sess.decode_step(c, tok.to(tokens.device))
            out.append(lg.cpu())
        return out

    card = steps(gpu, toks)
    again = steps(gpu, toks)  # the whole path twice in one process: the same bits
    picks = [torch.argmax(lg[:, -1], dim=-1) for lg in card[:2]]
    host = steps(cpu, toks.cpu(), picks)
    diffs = [(lg - lc).abs().max().item() for lg, lc in zip(card, host)]
    worst = max(diffs)
    print(f"  {run}: card vs CPU, max |logit diff| per step {diffs}; logits' sha256 per "
          f"step: card {[digest(x) for x in card]}, CPU {[digest(x) for x in host]}")
    require(all(bit_equal(x, y) for x, y in zip(card, again)),
            f"{run}: the card's logits differ between two runs of the same requests")
    require(worst <= 1e-3, f"{run}: card and CPU logits differ by {worst}")
    return worst


def digest(x: torch.Tensor) -> str:
    """The first 12 hex digits of the sha256 of a tensor's bytes."""
    return hashlib.sha256(x.contiguous().numpy().tobytes()).hexdigest()[:12]


def phase_card_vs_cpu(sess: ServeSession) -> float:
    st = sess.storage
    cut = dict(embed=st["embed"], final_norm=st["final_norm"],
               blocks={k: v[:2] for k, v in st["blocks"].items()})
    return card_vs_cpu("qwen2.5-3b, 2 layers", transformer,
                       dataclasses.replace(CFG, n_layers=2), cut)


def phase_griffin_card_vs_cpu(sess: ServeSession) -> float:
    """The first super block (two recurrent blocks and one attention block)
    and the two extra recurrent blocks: 5 layers at full width."""
    st = sess.storage
    cut = dict(embed=st["embed"], final_norm=st["final_norm"], extra_rec=st["extra_rec"],
               super_blocks={part: {k: v[:1] for k, v in leaves.items()}
                             for part, leaves in st["super_blocks"].items()})
    cfg5 = dataclasses.replace(GCFG, n_layers=5)
    require((cfg5.n_super, cfg5.n_extra_rec) == (1, GCFG.n_extra_rec), "griffin cut")
    return card_vs_cpu("recurrentgemma-2b, 5 layers", griffin, cfg5, cut)


# ---------------------------------------------------------------------------
# 7. federated training at full width, 8. card against CPU
# ---------------------------------------------------------------------------


def tree_gap(a, b) -> tuple:
    """(largest per-leaf max |d|, largest per-leaf mean |d|) between two
    decompressed storage trees, on a common device."""
    da, db = dict(tree_items(decompress_tree(a))), dict(tree_items(decompress_tree(b)))
    require(da.keys() == db.keys(), "trees differ in structure")
    worst_max = worst_mean = 0.0
    for path, x in da.items():
        y = db[path].to(x.device)
        require(x.shape == y.shape, f"leaf {path} shapes differ")
        require(bool(torch.isfinite(x).all() and torch.isfinite(y).all()), f"leaf {path} not finite")
        d = (x - y).abs()
        worst_max, worst_mean = max(worst_max, d.max().item()), max(worst_mean, d.mean().item())
    return worst_max, worst_mean


def ledger(history) -> list:
    return [{k: h[k] for k in ("round", "cohort", "dropped", "down_bytes", "up_bytes")}
            for h in history]


def require_launches(counts: dict, run: str, **want) -> None:
    """``want``: op -> exact count, or None for "at least once"."""
    require(not any(k.endswith(".ref") for k in counts), f"{run}: a plain version ran: {counts}")
    for op, n in want.items():
        got = counts.get(f"{op}.cuda", 0)
        require(got > 0 if n is None else got == n, f"{run}: {op} launched {got} times, "
                f"expected {'some' if n is None else n}: {counts}")


def phase_train() -> dict:
    cfg = TRAIN_CFG
    omc = OMCConfig.parse(FMT.name)  # PVT on, PPQ 0.9
    sim = simulate.SimConfig(local_steps=2, client_lr=0.1)
    spec = engine.CohortSpec(CohortPlan(num_clients=16, cohort_size=COHORT, failure_rate=0.25))
    task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=256, num_clients=16)
    data_fn = lambda c, r, s: task.batch(c, r, s, 8)  # noqa: E731
    key = prng.PRNGKey(0)
    params = conformer.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    n_params = sum(v.numel() for _, v in tree_items(params))
    specs = conformer.param_specs(cfg)

    def train(rounds, fused):
        return engine.run_training_vectorized(conformer, cfg, omc, sim, spec, data_fn, key,
                                              rounds, init_params=params, fused_agg=fused)

    t0 = time.perf_counter()
    train(1, True)  # warm round: allocator, cuBLAS handles, lazy kernel loading
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    runs = {}
    for fused in (True, False):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        storage, history = train(3, fused)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[fused] = dict(storage=storage, history=history, round_s=wall / 3,
                           counts=ops.launch_counts(),
                           max_memory_allocated=torch.cuda.max_memory_allocated())
    require_launches(runs[True]["counts"], "fused", fused_aggregate=13 * 3, quantize_stats=None,
                     dequantize=None)
    require_launches(runs[False]["counts"], "unfused", fused_aggregate=0, quantize_stats=None,
                     dequantize=None)
    require(ledger(runs[True]["history"]) == ledger(runs[False]["history"]),
            "fused and unfused ledgers differ")
    for h in runs[True]["history"] + runs[False]["history"]:
        require(math.isfinite(h["loss"]) and 0 < h["loss"] < 20, f"bad loss {h}")
    for hf, hu in zip(runs[True]["history"], runs[False]["history"]):
        require(abs(hf["loss"] - hu["loss"]) < 1e-3, f"fused and unfused losses differ: {hf} {hu}")
    gap = tree_gap(runs[True]["storage"], runs[False]["storage"])
    require(gap[0] <= TREE_MAX and gap[1] <= TREE_MEAN, f"fused vs unfused trees differ: {gap}")

    # Table 4's "quant" row: PVT off; storage and transport encode with `quantize`
    omc_q = OMCConfig.parse(FMT.name, pvt=False)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    storage_q = compress_params(params, specs, omc_q)
    table_q = accounting.build_wire_table(params, specs, omc_q)
    storage_q, metrics_q = engine.run_round_vectorized(
        conformer, cfg, specs, omc_q, sim, storage_q, data_fn, spec, 0,
        prng.fold_in(key, 0xC047), wire_table=table_q, fused_agg=True)
    torch.cuda.synchronize()
    quant = dict(round_s=time.perf_counter() - t0, metrics=metrics_q,
                 counts=ops.launch_counts(),
                 max_memory_allocated=torch.cuda.max_memory_allocated())
    require_launches(quant["counts"], "pvt=False", quantize=None, fused_aggregate=13,
                     dequantize=None)
    require(math.isfinite(metrics_q["loss"]), f"bad loss {metrics_q}")
    for _, leaf in tree_items(decompress_tree(storage_q)):
        require(bool(torch.isfinite(leaf).all()), "pvt=False tree not finite")

    print(f"  conformer_s: {n_params:,} parameters; warm round {warm_s:.2f} s")
    for fused, r in runs.items():
        print(f"  {'fused  ' if fused else 'unfused'} {r['round_s'] * 1e3:.1f} ms per round, "
              f"peak {r['max_memory_allocated'] / 1e9:.2f} GB, launches {r['counts']}")
        for h in r["history"]:
            print(f"    {h}")
    print(f"  fused vs unfused trees: max |d| {gap[0]:.3g}, mean |d| {gap[1]:.3g}")
    print(f"  pvt=False fused round {quant['round_s'] * 1e3:.1f} ms (with storage compress), "
          f"{metrics_q}, launches {quant['counts']}")
    counts = {}
    for c in (runs[True]["counts"], runs[False]["counts"], quant["counts"]):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return dict(n_params=n_params, warm_s=warm_s, gap=gap, quant=quant, counts=counts,
                runs={("fused" if f else "unfused"): {k: v for k, v in r.items() if k != "storage"}
                      for f, r in runs.items()})


def phase_train_card_vs_cpu() -> tuple:
    cfg = dataclasses.replace(TRAIN_CFG, n_layers=2)
    omc = OMCConfig.parse(FMT.name)
    sim = simulate.SimConfig(local_steps=1, client_lr=0.1)
    spec = engine.CohortSpec(CohortPlan(num_clients=16, cohort_size=4, failure_rate=0.25))
    params = conformer.init(torch.Generator(device="cuda").manual_seed(1), cfg)
    out = {}
    for dev in ("cuda", "cpu"):
        task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=256,
                               num_clients=16, device=dev)
        out[dev] = engine.run_training_vectorized(
            conformer, cfg, omc, sim, spec, lambda c, r, s, t=task: t.batch(c, r, s, 8),
            prng.PRNGKey(0), 1, init_params=tree_map(lambda x, d=dev: x.to(d), params),
            fused_agg=True)
    require(ledger(out["cuda"][1]) == ledger(out["cpu"][1]), "card and CPU ledgers differ")
    gap = tree_gap(out["cuda"][0], out["cpu"][0])
    print(f"  card vs CPU, 2 layers at full width, 1 round: losses "
          f"{out['cuda'][1][0]['loss']} / {out['cpu'][1][0]['loss']}, trees max |d| {gap[0]:.3g},"
          f" mean |d| {gap[1]:.3g}")
    require(abs(out["cuda"][1][0]["loss"] - out["cpu"][1][0]["loss"]) < 1e-3,
            "card and CPU losses differ")
    require(gap[0] <= TREE_MAX and gap[1] <= TREE_MEAN, f"card and CPU trees differ: {gap}")
    return gap


def kernel_line(kernels: dict, counts_by_path: dict) -> dict:
    primary = dict(quantize_stats=list(EMBED), dequantize=list(MLP_SLICE), pack=list(EMBED),
                   unpack=list(EMBED), quantize=[COHORT, *TRAIN_LEAF],
                   fused_aggregate=list(TRAIN_LEAF), dequant_matmul=list(DECODE_W1))
    keys = ("shape", "path", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "f32_simt_bound_ms", "matmul_alone_ms", "max_err_over_bound", "variant")
    entries = []
    for name, rows in kernels["results"].items():
        timed = [r for r in rows if "ms" in r]
        main = next(r for r in timed if r["shape"] == primary[name])
        by_path = {path: c.get(f"{name}.cuda", 0) for path, c in counts_by_path.items()}
        entries.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=sum(by_path.values()), launches_by_path=by_path, matched=True,
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main.get("bound_by", "bytes"), library_ms=None, shape=main["shape"],
            at_shapes=[{k: r[k] for k in keys if k in r} for r in timed],
            **({"max_err_over_bound": max(r["max_err_over_bound"] for r in rows)}
               if name == "dequant_matmul" else {})))
    return dict(kernels=entries,
                library_ms_note="no single PyTorch call encodes, decodes or packs a minifloat, "
                                "or aggregates client codes, or multiplies by a minifloat "
                                "matrix; dequant_matmul's matmul_alone_ms is torch.matmul on "
                                "the pre-decoded f32 weight, not the same function",
                stacked_mlp=kernels["stacked"])


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    phase_environment()
    kernels = phase_kernels()
    served = phase_serve()
    phase_card_vs_cpu(served["session"])
    del served["session"]
    served_g = phase_serve_griffin()
    phase_griffin_card_vs_cpu(served_g["session"])
    del served_g["session"]
    torch.cuda.empty_cache()
    trained = phase_train()
    phase_train_card_vs_cpu()
    print(json.dumps(kernel_line(kernels, dict(serve=served["report"]["launch_counts"],
                                               serve_griffin=served_g["report"]["launch_counts"],
                                               train=trained["counts"]))))
    print(json.dumps(dict(ok=True, device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                                               count=torch.cuda.device_count()))))


if __name__ == "__main__":
    main()
