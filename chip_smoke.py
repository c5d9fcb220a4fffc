#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase's failure is caught:

  1. Environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, and the build of the kernels from ``src/repro_torch/
     kernels/csrc`` (nvcc, sm_90a), with its time.
  2. Each kernel against its plain PyTorch version, on the card, at the serve
     path's shapes (qwen2.5-3b's MLP slice [2048, 11008] and embedding
     [151936, 2048] in S1E3M7) and at small odd-tail shapes in S1E2M3 and
     S1E4M14: codes, streams and decodes bit-exact, PVT sums within
     rtol=1e-4.  Kernel and plain version are timed with CUDA events (3
     warm-ups, median of 20, L2 flushed before each launch).
  3. Serve at full width: ``repro_torch.launch.serve.run`` on qwen2.5-3b,
     S1E3M7, --wire-roundtrip, batch 4, prompt 32, 16 new tokens — init on
     the card, compress (quantize_stats), encode (pack), hot-swap (unpack,
     checked bit-identical), prefill and decode (dequantize) — then three more
     request batches through ``ServeSession.generate``.  Launch counters are
     zeroed just before and read just after: every kernel must have launched,
     and no plain version may have run.
  4. Card against CPU at full width: the served storage tree cut to 2 layers,
     prefill and 2 decode steps on the card (kernels) and on the CPU (plain
     versions); the largest logit difference must be <= 1e-3.

It then prints one JSON line describing each kernel and, last, the line
``{"ok": true, "device": {...}}``.  f32 matmuls run in full f32: TF32 is
switched off for matmuls and cuDNN.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.api.session import ServeSession  # noqa: E402
from repro_torch.configs import qwen2_5_3b  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core.formats import FloatFormat, narrow  # noqa: E402
from repro_torch.core.store import bit_equal  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.kernels import bitpack as bk  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import quantize as qk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FMT = FloatFormat.parse("S1E3M7")
CFG = qwen2_5_3b.config()
MLP_SLICE = (CFG.d_model, CFG.d_ff)  # one layer's w1 / w3
EMBED = (CFG.vocab, CFG.d_model)
STACKED_MLP = (CFG.n_layers, CFG.d_model, CFG.d_ff)  # a stacked w1 leaf
SOURCES = dict(quantize_stats="src/repro_torch/kernels/csrc/quantize.cu",
               dequantize="src/repro_torch/kernels/csrc/quantize.cu",
               pack="src/repro_torch/kernels/csrc/bitpack.cu",
               unpack="src/repro_torch/kernels/csrc/bitpack.cu")
REPLACES = dict(quantize_stats="src/repro/kernels/quantize.py:116",
                dequantize="src/repro/kernels/quantize.py:93",
                pack="src/repro/kernels/bitpack.py:96",
                unpack="src/repro/kernels/bitpack.py:120")


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
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip().split("ptxas info    : ")[-1])
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


def check_dequantize(codes, fmt, timer=None):
    s = torch.tensor(1.05, device="cuda")
    b = torch.tensor(-0.01, device="cuda")
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
                       plain_ms=timer(lambda: ref.ref_pack(flat, width)),
                       bound_ms=bound_ms(nbytes))
        outs[1].update(ms=timer(lambda: bk.unpack(words, width, n, codes.dtype)),
                       plain_ms=timer(lambda: ref.ref_unpack(words, width, n, codes.dtype)),
                       bound_ms=bound_ms(nbytes))
    return outs


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
               unpack_ms=timer(lambda: bk.unpack(words, w, n, codes.dtype), reps=5, warmup=1),
               pack_bound_ms=bound_ms(n * 2 + 4 * words.numel()))
    return out


def phase_kernels() -> dict:
    timer = Timer()
    results = {k: [] for k in SOURCES}
    # small odd-tail shapes, other containers (u8, u32), with specials
    for fmt in (FloatFormat.parse("S1E2M3"), FloatFormat.parse("S1E4M14"), FMT):
        for shape, batch_axes in (((129,), 0), ((37, 53), 0), ((3, 1001), 1), ((2, 3, 65), 2)):
            x = _inputs(shape, fmt, seed=sum(shape))
            codes, r = check_quantize_stats(x, fmt, batch_axes)
            results["quantize_stats"].append(r)
            results["dequantize"].append(check_dequantize(codes, fmt))
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
    for name, rows in results.items():
        for r in rows:
            if "ms" in r:
                print(f"  {name:15s} {str(r['shape']):20s} kernel {r['ms']:.3f} ms  "
                      f"plain {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms")
    print(f"  stacked w1 {stacked}")
    print(f"kernels match their plain versions: "
          f"{ {k: len(v) for k, v in results.items()} } cases")
    return dict(results=results, stacked=stacked)


# ---------------------------------------------------------------------------
# 3. serve at full width, 4. card against CPU
# ---------------------------------------------------------------------------


def phase_serve() -> dict:
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    report = serve.run(serve.parse_args([
        "--arch", "qwen2.5-3b", "--fmt", FMT.name, "--wire-roundtrip", "--batch", "4",
        "--prompt-len", "32", "--gen", "16", "--quiet"]))
    sess = report.pop("session")
    require(report["swap_bit_identical"], "hot-swapped tree differs from the one encoded")
    g = torch.Generator(device="cuda").manual_seed(1)
    t0 = time.perf_counter()
    for _ in range(3):
        toks = torch.randint(0, CFG.vocab, (4, 32), generator=g, device="cuda")
        _, out = sess.generate(dict(tokens=toks), sess.init_cache(4, 4 * (32 + 16)), 16)
        require(out.shape == (4, 16) and bool(((out >= 0) & (out < CFG.vocab)).all()),
                "generate returned bad tokens")
    torch.cuda.synchronize()
    more_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    for op in SOURCES:
        require(counts.get(f"{op}.cuda", 0) > 0, f"{op} kernel never launched on the main path")
        require(counts.get(f"{op}.ref", 0) == 0, f"{op} plain version ran on the main path")
    report.update(more_batches_ms=more_ms, max_memory_allocated=torch.cuda.max_memory_allocated(),
                  launch_counts=counts, serve_stats=sess.serve_stats())
    report.pop("tokens")
    for k in ("num_params", "payload_bytes", "fp32_bytes", "payload_ratio", "roundtrip_ms",
              "prefill_ms", "decode_ms_per_token", "tok_per_s", "more_batches_ms",
              "max_memory_allocated", "launch_counts"):
        print(f"  serve {k}: {report[k]}")
    return dict(report=report, session=sess)


def phase_card_vs_cpu(sess: ServeSession) -> float:
    cfg2 = dataclasses.replace(CFG, n_layers=2)
    st = sess.storage
    cut = dict(embed=st["embed"], final_norm=st["final_norm"],
               blocks={k: v[:2] for k, v in st["blocks"].items()})
    gpu = ServeSession(transformer, cfg2, cut)
    cpu = ServeSession(transformer, cfg2, tree_map(lambda x: x.to("cpu"), cut))
    g = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, CFG.vocab, (4, 32), generator=g, device="cuda")
    cg, lg = gpu.prefill(dict(tokens=toks), gpu.init_cache(4, 64))
    cc, lc = cpu.prefill(dict(tokens=toks.cpu()), cpu.init_cache(4, 64))
    diffs = [(lg.cpu() - lc).abs().max().item()]
    for _ in range(2):
        tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        cg, lg = gpu.decode_step(cg, tok)
        cc, lc = cpu.decode_step(cc, tok.cpu())
        diffs.append((lg.cpu() - lc).abs().max().item())
    worst = max(diffs)
    print(f"  card vs CPU, 2 layers at full width: max |logit diff| per step {diffs}")
    require(worst <= 1e-3, f"card and CPU logits differ by {worst}")
    return worst


def kernel_line(kernels: dict, counts: dict) -> dict:
    primary = dict(quantize_stats=list(EMBED), dequantize=list(MLP_SLICE), pack=list(EMBED),
                   unpack=list(EMBED))
    entries = []
    for name, rows in kernels["results"].items():
        timed = [r for r in rows if "ms" in r]
        main = next(r for r in timed if r["shape"] == primary[name])
        entries.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=counts.get(f"{name}.cuda", 0), matched=True,
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by="bytes",
            library_ms=None, shape=main["shape"],
            at_shapes=[{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms")}
                       for r in timed]))
    return dict(kernels=entries,
                library_ms_note="no single PyTorch call decodes or packs a minifloat",
                stacked_mlp=kernels["stacked"])


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    phase_environment()
    kernels = phase_kernels()
    served = phase_serve()
    phase_card_vs_cpu(served["session"])
    print(json.dumps(kernel_line(kernels, served["report"]["launch_counts"])))
    print(json.dumps(dict(ok=True, device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                                               count=torch.cuda.device_count()))))


if __name__ == "__main__":
    main()
