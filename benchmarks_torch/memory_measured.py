#!/usr/bin/env python3
"""Paper §3.4: measured parameter memory on the port (counterpart of
``benchmarks/memory_measured.py``).

The reference's configuration and rows: a 4-layer transformer (d 128, 8
heads, 4 KV heads, ff 256, vocab 512) under ``init_state`` in S1E8M23,
S1E5M10 and S1E3M7 with ``fedavg(1.0)``, and one round of
``make_round_fn`` on a [4, 32] batch of ones.  Columns:

  * ``container_pct`` / ``packed_pct``: ``state_bytes_report`` of the
    actual state, the reference's to the byte (tests/test_torch_round.py);
  * ``arg_mb``: device bytes the state and the batch hold (the reference's
    ``memory_analysis().argument_size_in_bytes``);
  * ``temp_mb``: the round's peak device bytes above them, new state
    included (``torch.cuda.max_memory_allocated``, standing in for XLA's
    ``temp_size_in_bytes`` of the compiled round).

On the CPU (``--device cpu``) the two device columns are not measured
(None).  Results go to ``experiments/bench_torch/memory_measured.json``.

    python3 benchmarks_torch/memory_measured.py                # on the card
    python3 benchmarks_torch/memory_measured.py --device cpu   # byte columns only
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from benchmarks_torch.common import print_table, save_result  # noqa: E402
from repro_torch.api.session import sync  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.federated.round import make_round_fn  # noqa: E402
from repro_torch.federated.state import init_state, state_bytes_report  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.optim import fedavg  # noqa: E402

CFG = tr.TransformerConfig(n_layers=4, d_model=128, n_heads=8, n_kv_heads=4, d_ff=256,
                           vocab=512)
FMTS = ("S1E8M23", "S1E5M10", "S1E3M7")


def run(device="cuda"):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu for the byte "
                           "columns alone")
    on_card = device.type == "cuda"
    rows = []
    for fmt in FMTS:
        omc = OMCConfig.parse(fmt)
        if on_card:
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(device)
        state = init_state(prng.PRNGKey(0), tr, CFG, omc, fedavg(1.0), device=device)
        rep = state_bytes_report(state.params)
        ones = torch.ones((4, 32), dtype=torch.int32, device=device)
        batch = dict(tokens=ones, labels=ones)
        fn = make_round_fn(tr, CFG, omc, fedavg(1.0))
        row = dict(fmt=fmt, container_pct=round(100 * rep["container_ratio"]),
                   packed_pct=round(100 * rep["packed_ratio"]), arg_mb=None, temp_mb=None)
        if on_card:
            sync(device)
            held = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        state, metrics = fn(state, batch)
        sync(device)
        if on_card:
            row.update(arg_mb=round((held - base) / 1e6, 2),
                       temp_mb=round((torch.cuda.max_memory_allocated(device) - held) / 1e6, 2))
        if not torch.isfinite(metrics["loss"]):
            raise RuntimeError(f"{fmt}: non-finite loss {metrics}")
        rows.append(row)
        del state, batch, metrics
    print_table("Measured memory (paper §3.4 analogue)", rows,
                ["fmt", "container_pct", "packed_pct", "arg_mb", "temp_mb"])
    save_result("memory_measured", rows)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args().device)
