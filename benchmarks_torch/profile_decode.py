#!/usr/bin/env python3
"""Where a decode step's time goes: device kernel time against host wall time.

    python3 benchmarks_torch/profile_decode.py            # qwen2.5-3b, full width, on the card
    python3 benchmarks_torch/profile_decode.py --arch recurrentgemma-2b
    python3 benchmarks_torch/profile_decode.py --smoke --device cpu

Builds the session with ``repro_torch.launch.serve.build_session`` (random
weights from seed 0, S1E3M7 storage), prefills a batch of 4 prompts of 32
tokens, runs two warm decode steps, times three more on the host clock
(around ``torch.cuda.synchronize``), then profiles three with
``torch.profiler``.  Prints one JSON line: wall ms per step without and with
the profiler, device busy ms per step (the sum of the kernels' durations on
the card; one stream, so kernels do not overlap), the device's idle share
under the profiler, the top-level torch ops dispatched per step, the
``dequant_matmul`` and ``dequantize`` launches per step, the peak device
memory of the run, and the kernels that took the most device time.  Then
the same prefill once more on the host clock, and once under the profiler:
its device busy time and top kernels.  On the card the line names the
card and its power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.api.session import sync  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

STEPS = 3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b", help="a servable arch (serve.py's --arch)")
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    sess, key, _ = serve.build_session(serve.parse_args(
        ["--arch", args.arch, "--device", args.device] + (["--smoke"] if args.smoke else [])))
    device, cfg = sess.device, sess.cfg
    toks = serve.prompt_tokens(key, 4, 32, cfg.vocab, device)
    cache, logits = sess.prefill(dict(tokens=toks), sess.init_cache(4, 64))
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for _ in range(2):  # warm: allocator, cuBLAS handles, lazily loaded kernels
        cache, logits = sess.decode_step(cache, tok)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                           else [])

    def timed_steps() -> float:
        nonlocal cache
        sync(device)
        t0 = time.perf_counter()
        for _ in range(STEPS):
            cache, _ = sess.decode_step(cache, tok)
        sync(device)
        return (time.perf_counter() - t0) * 1e3 / STEPS

    wall_ms = timed_steps()
    ops.reset_launch_counts()
    with profile(activities=activities) as prof:
        profiled_ms = timed_steps()
    events = prof.events()
    top_ops = sum(1 for e in events if e.name.startswith("aten::")
                  and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))
    kernels = device_kernels(events, STEPS)
    busy_ms = sum(ms for _, ms in kernels)
    on_card = device.type == "cuda"
    launches = ops.launch_counts()
    backend = "cuda" if on_card else "ref"

    def prefill() -> float:  # the same 4 x 32 prompts again, on the host clock
        sync(device)
        t0 = time.perf_counter()
        sess.prefill(dict(tokens=toks), sess.init_cache(4, 64))
        sync(device)
        return (time.perf_counter() - t0) * 1e3

    prefill_ms = prefill()
    with profile(activities=activities) as prof:
        prefill()
    prefill_kernels = device_kernels(prof.events(), 1)
    smi = "" if not on_card else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(
        arch=args.arch, smoke=args.smoke, device=str(device),
        device_name=torch.cuda.get_device_name(0) if on_card else "cpu", smi=smi,
        steps=STEPS, wall_ms_per_step=wall_ms, profiled_wall_ms_per_step=profiled_ms,
        device_busy_ms_per_step=busy_ms if on_card else None,
        device_idle_share=(1 - busy_ms / profiled_ms) if on_card else None,
        top_level_ops_per_step=top_ops / STEPS,
        dequant_matmul_launches_per_step=launches.get(f"dequant_matmul.{backend}", 0) / STEPS,
        dequantize_launches_per_step=launches.get(f"dequantize.{backend}", 0) / STEPS,
        max_memory_allocated=torch.cuda.max_memory_allocated() if on_card else None,
        top_kernels=top(kernels),
        prefill_wall_ms=prefill_ms,
        prefill_device_busy_ms=sum(ms for _, ms in prefill_kernels) if on_card else None,
        prefill_top_kernels=top(prefill_kernels))))


def device_kernels(events, steps: int) -> list:
    """(kernel name, device ms per step) from a profile's events."""
    per_kernel: dict = {}
    for e in events:  # device-side events only: CPU ops would count their kernels twice
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return [(name, ms / steps) for name, ms in per_kernel.items()]


def top(kernels: list, n: int = 8) -> list:
    """The ``n`` kernels of the most device time, names cut to 80 characters."""
    return [dict(name=k[:80], ms_per_step=ms)
            for k, ms in sorted(kernels, key=lambda kv: -kv[1])[:n]]


if __name__ == "__main__":
    main()
