#!/usr/bin/env python3
"""Wire-format benchmark on the port: payload size and codec latency
(counterpart of ``benchmarks/api_wire.py``).

Per minifloat format (S1E5M10, S1E4M8, S1E3M7), one loopback round of
``FLSession`` / ``FLClient``, then the server's download payload: full and
round-over-round delta bytes against f32, encode and decode wall ms (the
card synchronized), and the reconciliation the reference asserts: the
codec's ``wire_bytes`` equals ``state_bytes_report``'s ``packed_bytes``.

    python3 benchmarks_torch/api_wire.py            # conformer_s at full width, on the card
    python3 benchmarks_torch/api_wire.py --smoke    # the reference's size, on the CPU

``--smoke`` is the reference's configuration (a 4-layer, d 128 transformer,
vocab 512, 4 clients, cohort 2, one SGD step on a 4 x 32 LM batch) through
the plain versions.  Without it the model is conformer_s' published config
(17 layers, d 512, 103,535,104 parameters) on the card, one SGD step on an
8 x 48 frame batch per client: encodes run ``pack``, decodes ``unpack``,
the server step ``dequantize`` and ``quantize_stats``.  Times are the median
of 3 after one untimed call.  Writes ``experiments/bench_torch/api_wire.json``
(``api_wire_smoke.json`` with ``--smoke``).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from benchmarks_torch.common import bench_device, device_name, print_table, save_result  # noqa: E402
from repro_torch.api.codecs import decode_payload, payload_bytes_report  # noqa: E402
from repro_torch.api.session import FLClient, FLSession, sync  # noqa: E402
from repro_torch.configs import conformer_s  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.data.synthetic import make_frame_task, make_lm_task  # noqa: E402
from repro_torch.federated.cohort import CohortPlan  # noqa: E402
from repro_torch.federated.simulate import sgd_steps  # noqa: E402
from repro_torch.federated.state import state_bytes_report  # noqa: E402
from repro_torch.models import conformer, transformer as tr  # noqa: E402

FORMATS = ("S1E5M10", "S1E4M8", "S1E3M7")
SMOKE_CFG = tr.TransformerConfig(n_layers=4, d_model=128, n_heads=8, n_kv_heads=4, d_ff=256,
                                 vocab=512)


def setup(smoke: bool):
    """``(family, cfg, batch_fn, device)``: the reference's transformer on the
    LM task on the CPU, or conformer_s on the frame task on the card."""
    device = bench_device(smoke)
    if smoke:
        task = make_lm_task(vocab=SMOKE_CFG.vocab, seq_len=32, num_clients=4, device=str(device))
        return tr, SMOKE_CFG, lambda c, r: task.batch(c, r, 0, 4), device
    cfg = conformer_s.config()
    task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=48, num_clients=4,
                           device=str(device))
    return conformer, cfg, lambda c, r: task.batch(c, r, 0, 8), device


def _ms(fn, device, reps: int = 3) -> float:
    """Median wall ms of ``fn()`` after one untimed call, the device synchronized."""
    fn()
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def one_wire_round(family, cfg, batch_fn, device, fmt: str, client_lr: float = 0.05) -> dict:
    """One loopback round; sizes and timings of the full download and of the
    next round's delta download (what a repeat client would fetch)."""
    omc = OMCConfig.parse(fmt)

    def train_fn(params, cid, r):
        return sgd_steps(family, cfg, params, [batch_fn(cid, r)], client_lr)[0]

    sess = FLSession(family, cfg, omc, plan=CohortPlan(num_clients=4, cohort_size=2),
                     device=device)
    clients = {c: FLClient(c, family, cfg, omc, train_fn, device=device) for c in range(4)}

    full = sess.server_payload()
    encode_ms = _ms(sess.server_payload, device)
    decode_ms = _ms(lambda: decode_payload(full, device=device), device)

    ticket = sess.begin_round()
    for cid in ticket.client_ids:
        sess.ingest(cid, clients[cid].run_round(ticket))
    sess.close_round()

    delta = sess.server_payload(delta=True)
    delta_ms = _ms(lambda: sess.server_payload(delta=True), device)

    rep = payload_bytes_report(sess.storage)
    state_rep = state_bytes_report(sess.storage)
    if rep["wire_bytes"] != state_rep["packed_bytes"]:
        raise RuntimeError(f"{fmt}: codec {rep['wire_bytes']} B, state_bytes_report "
                           f"{state_rep['packed_bytes']} B")
    return dict(
        fmt=fmt,
        full_bytes=len(full),
        delta_bytes=len(delta),
        fp32_bytes=rep["fp32_bytes"],
        full_pct=round(100 * len(full) / rep["fp32_bytes"], 1),
        delta_pct=round(100 * len(delta) / rep["fp32_bytes"], 1),
        encode_ms=round(encode_ms, 1),
        decode_ms=round(decode_ms, 1),
        delta_encode_ms=round(delta_ms, 1),
        reconciled=True,
        device=device_name(device),
    )


def run(smoke: bool = False):
    family, cfg, batch_fn, device = setup(smoke)
    rows = [one_wire_round(family, cfg, batch_fn, device, fmt) for fmt in FORMATS]
    print_table("Wire payloads (download; delta = round-over-round)", rows,
                ["fmt", "full_bytes", "full_pct", "delta_bytes", "delta_pct", "encode_ms",
                 "decode_ms", "delta_encode_ms"])
    save_result("api_wire_smoke" if smoke else "api_wire", rows)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's configuration, on the CPU")
    args = ap.parse_args()
    t0 = time.perf_counter()
    run(smoke=args.smoke)
    print(f"\n{device_name(bench_device(args.smoke))}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
