#!/usr/bin/env python3
"""Strategy-zoo walkthrough: pick a compressor, ship a model (port of
``examples/compress_strategies.py``).

Encodes a small Conformer's parameter tree under a registered
:class:`repro_torch.compress.CompressionStrategy`, serializes it through the
wire codec (strategy tag and per-strategy wire version in the frame),
decodes it back bit for bit, and prints the reconciled byte ledger and the
eval-loss cost of the lossy transport.

    python3 examples_torch/compress_strategies.py                    # the zoo, on the card
    python3 examples_torch/compress_strategies.py --strategy topk --density 0.05
    python3 examples_torch/compress_strategies.py --strategy omc --fmt S1E4M3
    python3 examples_torch/compress_strategies.py --smoke --device cpu

``--strategy`` takes any name of ``repro_torch.compress.available_strategies``
(omc / pipeline / ternary / topk); without it the default zoo is swept.
Without a card it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import compress  # noqa: E402
from repro_torch.api import codecs  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.core.tree import tree_items  # noqa: E402
from repro_torch.data.synthetic import make_frame_task  # noqa: E402
from repro_torch.federated.simulate import sgd_steps  # noqa: E402
from repro_torch.models import conformer as cf  # noqa: E402
from repro_torch.models.common import IDENTITY_MAT  # noqa: E402

CFG = cf.ConformerConfig(n_layers=2, d_model=32, n_heads=4, d_ff=64, n_classes=16, d_in=8)
OMC = OMCConfig.parse("S1E3M7")  # supplies the weights-only selection policy


def _pick(args) -> list:
    if args.strategy is None:
        return compress.default_zoo()
    if args.strategy == "omc":
        return [compress.OMCQuantStrategy.parse(args.fmt)]
    if args.strategy == "pipeline":
        return [compress.PipelineStrategy.parse(args.fmt, density=args.density)]
    kw = dict(density=args.density) if args.strategy == "topk" else {}
    return [compress.get_strategy(args.strategy, **kw)]


def _eval(params, batches) -> float:
    with torch.no_grad():
        return float(sum(cf.loss(CFG, params, b, IDENTITY_MAT) for b in batches) / len(batches))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--strategy", choices=compress.available_strategies(), default=None,
                    help="one strategy (default: sweep the zoo)")
    ap.add_argument("--fmt", default="S1E3M7", help="minifloat for the omc/pipeline strategies")
    ap.add_argument("--density", type=float, default=0.1,
                    help="kept fraction for the topk/pipeline strategies")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")

    steps = 4 if args.smoke else 30
    batch = 2 if args.smoke else 4
    task = make_frame_task(d_in=CFG.d_in, n_classes=CFG.n_classes, seq_len=32, num_clients=4,
                           device=str(device))
    params = cf.init(prng.PRNGKey(0), CFG, device)
    for i in range(steps):
        params, _ = sgd_steps(cf, CFG, params, [task.batch(i % 4, i, 0, batch)], 0.1)
    eval_batches = [task.batch(100 + i, 10_000, 0, 4) for i in range(2)]
    baseline = _eval(params, eval_batches)
    specs = cf.param_specs(CFG)
    fp32_mb = sum(4 * x.numel() for _, x in tree_items(params)) / 2**20
    print(f"baseline: loss={baseline:.4f}  fp32={fp32_mb:.3f} MiB  device={device}")

    for s in _pick(args):
        tree = compress.encode_tree(s, params, OMC, specs)
        payload = codecs.encode_payload(tree, strategy=s)
        info = codecs.peek_payload(payload)
        twb = compress.tree_wire_bytes(tree)
        assert info.body_bytes == twb["wire_bytes"]  # the ledger is the payload's body

        decoded, _ = codecs.decode_payload(payload, device=device)
        assert codecs.tree_digest(decoded) == codecs.tree_digest(tree)
        loss = _eval(compress.decode_tree(decoded), eval_batches)

        over = {k: f"idx={v['index_bytes']}B meta={v['meta_bytes']}B"
                for k, v in twb["per_strategy"].items() if k != "raw"}
        print(f"{s.label:<18} tag={info.strategy} v{info.strategy_version}  "
              f"wire={twb['wire_bytes'] / 2**20:.3f} MiB ({100 * twb['wire_ratio']:.1f}% of fp32)  "
              f"loss={loss:.4f} (Δ{loss - baseline:+.4f})  overhead={over}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
