#!/usr/bin/env python3
"""Where a federated training round's time goes: host phases and device kernels.

    python3 benchmarks_torch/profile_round.py             # conformer_s, full width, on the card
    python3 benchmarks_torch/profile_round.py --smoke --device cpu

The configuration of chip_smoke.py's phase 5: conformer_s, random weights
from seed 0, the synthetic frame task (80-dim frames, 256 frames, batch 8,
16 clients), cohort 8 with failure rate 0.25, 2 local steps at lr 0.1,
S1E3M7 with PVT and PPQ 0.9, fused server round
(``engine.run_round_vectorized(..., fused_agg=True)``).  After a warm round
it times, on the host clock around ``torch.cuda.synchronize``: two rounds;
the pieces of one client alone (its batches, one quantize→dequantize view,
the whole client body); and the server's decode of its storage.  Then it
profiles one round with ``torch.profiler``.  Prints one JSON line: ms per
round, the pieces' ms, device busy ms per round (the sum of the kernels'
durations on the card; one stream, so kernels do not overlap), the device's
idle share under the profiler, kernel launches per round, and the kernels
that took the most device time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import conformer_s  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.core.store import decompress_tree  # noqa: E402
from repro_torch.data.synthetic import make_frame_task  # noqa: E402
from repro_torch.federated import engine, simulate  # noqa: E402
from repro_torch.federated.cohort import CohortPlan  # noqa: E402
from repro_torch.federated.state import compress_params  # noqa: E402
from repro_torch.models import conformer  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="conformer_s' smoke config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = conformer_s.smoke_config() if args.smoke else conformer_s.config()
    seq, batch = (24, 4) if args.smoke else (256, 8)
    task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=seq,
                           num_clients=16, device=str(device))
    data_fn = lambda c, r, s: task.batch(c, r, s, batch)  # noqa: E731
    omc = OMCConfig.parse("S1E3M7")
    sim = simulate.SimConfig(local_steps=2, client_lr=0.1)
    spec = engine.CohortSpec(CohortPlan(num_clients=16, cohort_size=8, failure_rate=0.25))
    specs = conformer.param_specs(cfg)
    key = prng.fold_in(prng.PRNGKey(0), 0xC047)
    storage = compress_params(conformer.init(torch.Generator(device=device).manual_seed(0), cfg),
                              specs, omc)
    round_fn = engine.make_round_fn(conformer, cfg, specs, omc, sim, spec, data_fn,
                                    fused_agg=True)

    def run_round(r):
        return engine.run_round_vectorized(conformer, cfg, specs, omc, sim, storage, data_fn,
                                           spec, r, key, round_fn=round_fn)

    def timed(fn, reps=1) -> float:
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        sync()
        timed.out = out
        return (time.perf_counter() - t0) * 1e3 / reps

    timed(lambda: run_round(0))  # warm: allocator, cuBLAS handles, lazily loaded kernels
    round_ms = timed(lambda: run_round(1), reps=2)
    decode_ms = timed(lambda: decompress_tree(storage))
    server_f32 = timed.out
    client_fn = simulate.make_client_fn(conformer, cfg, specs, omc, sim)
    batches_ms = timed(lambda: simulate.client_batches(data_fn, 3, 1, sim.local_steps))
    batches = timed.out
    with torch.no_grad():
        view_ms = timed(lambda: simulate.client_view(server_f32, specs, omc, 1, 3))
    client_ms = timed(lambda: client_fn(server_f32, batches, 1, 3))

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        profiled_ms = timed(lambda: run_round(1))
    per_kernel: dict = {}
    launches = 0
    for e in prof.events():  # device-side events only: CPU ops would count their kernels twice
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            launches += 1
    busy_ms = sum(per_kernel.values())
    print(json.dumps(dict(
        arch="conformer_s", smoke=args.smoke, device=str(device),
        device_name=torch.cuda.get_device_name(0) if on_card else "cpu",
        round_ms=round_ms, server_decode_ms=decode_ms, client_batches_ms=batches_ms,
        client_view_ms=view_ms, client_body_ms=client_ms,
        client_train_ms=client_ms - 2 * view_ms,
        profiled_round_ms=profiled_ms,
        device_busy_ms_per_round=busy_ms if on_card else None,
        device_idle_share=(1 - busy_ms / profiled_ms) if on_card else None,
        kernel_launches_per_round=launches if on_card else None,
        top_kernels=[dict(name=k[:80], ms=ms)
                     for k, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]])))


if __name__ == "__main__":
    main()
