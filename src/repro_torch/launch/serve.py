"""Serving CLI: batched generation over OMC-compressed weights.

Port of ``repro.launch.serve``.  Weights stay compressed on the device (the
paper's storage model): every block matrix streams its codes through the
``dequant_matmul`` kernel, and the few leaves used otherwise (embedding
rows, a tied head, griffin's ``conv_w``) are decoded on the fly by
``dequantize``.  The CLI runs on a
:class:`repro_torch.api.session.ServeSession`; it reports prefill and
per-token decode latency and throughput.  ``--arch`` is any ported
servable arch: qwen2.5-3b, h2o-danube-3-4b, mistral-nemo-12b, qwen1.5-110b
(dense), mixtral-8x7b, dbrx-132b (MoE: every expert matrix through
``dequant_matmul``, the router decoded), internvl2-1b (VLM),
recurrentgemma-2b, xlstm-350m (``conv_w`` and ``r_gates`` decoded) or
seamless-m4t-medium (encoder-decoder: the untied head decoded).  The batch
is ``dict(tokens=...)``; the VLM's also holds ``patches``, the stubbed
vision frontend's embeddings, and the encoder-decoder's ``frames``, the
stubbed audio frontend's, drawn as the reference draws them.  The decode
state holds ``4 * (prompt + gen)`` positions, as the reference sizes it
(the encoder-decoder: that many frames, a quarter of them decoder slots),
without the VLM's prefix: the reference's quirk, kept so that both CLIs
give the same logits (ROADMAP C28).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --batch 4 --prompt-len 32 --gen 16 --fmt S1E3M7 --wire-roundtrip

``--layers N`` serves the first N layers at full width: a depth cut for
the configs whose codes do not fit one card whole (mixtral-8x7b,
dbrx-132b, qwen1.5-110b); the encoder-decoder keeps N encoder and N
decoder layers.  ``--wire-roundtrip`` first pushes the weights
through the wire codec
(``pack`` kernel -> payload bytes -> ``unpack`` kernel -> ``hot_swap``) and
checks that the served tree came back bit-identical.  ``--device`` defaults
to ``cuda``; without a card the CLI raises unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.api.codecs import encode_payload
from repro_torch.api.session import ServeSession, sync
from repro_torch.configs.registry import get_arch
from repro_torch.core import prng
from repro_torch.core.omc import OMCConfig
from repro_torch.core.store import trees_bit_equal
from repro_torch.federated.state import compress_params, state_bytes_report
from repro_torch.models.registry import get_family, is_servable
from repro_torch.obs.log import Logger


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--fmt", default="S1E3M7")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the first N layers at full width (default: the config's)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--wire-roundtrip", action="store_true",
                    help="serialize weights through the wire codec first")
    ap.add_argument("--quiet", action="store_true", help="suppress stderr text")
    return ap.parse_args(argv)


def build_session(args: argparse.Namespace) -> Tuple[ServeSession, prng.Key, float]:
    """The reference's random weights from ``PRNGKey(--seed)`` (within
    ``prng.normal``'s 4 ulp) on ``--device``, compressed to ``--fmt``,
    behind a fresh :class:`ServeSession`; also returns the key, from which
    :func:`prompt_tokens` draws the prompts, and the init's wall ms."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to serve on the CPU")
    arch = get_arch(args.arch)
    if not is_servable(arch.FAMILY):
        raise SystemExit(f"{args.arch} ({arch.FAMILY}) has no decode step")
    cfg = arch.smoke_config() if args.smoke else arch.config()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, **{k: args.layers for k in depth_fields(cfg)})
    family = get_family(arch.FAMILY)
    key = prng.PRNGKey(args.seed)
    sync(device)
    t0 = time.perf_counter()
    params = family.init(key, cfg, device)
    sync(device)
    init_ms = (time.perf_counter() - t0) * 1e3
    storage = compress_params(params, family.param_specs(cfg), OMCConfig.parse(args.fmt))
    del params
    return ServeSession(family, cfg, storage), key, init_ms


def depth_fields(cfg) -> Tuple[str, ...]:
    """The config's layer counts: ``n_layers``, or the encoder-decoder's
    ``n_enc_layers`` and ``n_dec_layers``."""
    return ("n_layers",) if hasattr(cfg, "n_layers") else ("n_enc_layers", "n_dec_layers")


def prompt_tokens(key: prng.Key, batch: int, prompt_len: int, vocab: int,
                  device) -> torch.Tensor:
    """The reference's prompts: ``randint(fold_in(key, 1), (batch,
    prompt_len), 0, vocab)``, bit for bit."""
    return prng.randint(prng.fold_in(key, 1), (batch, prompt_len), 0, vocab, device)


def request_batch(key: prng.Key, family: str, cfg, batch: int, prompt_len: int,
                  device, gen: int = 0) -> Dict[str, torch.Tensor]:
    """The reference CLI's request: :func:`prompt_tokens`, and for the VLM
    ``patches = normal(fold_in(key, 2), (batch, prefix_embeds, d_model))``,
    for the encoder-decoder ``frames = normal(fold_in(key, 2), (batch, 4 *
    (prompt_len + gen), d_model))`` (within ``prng.normal``'s 4 ulp)."""
    out = dict(tokens=prompt_tokens(key, batch, prompt_len, cfg.vocab, device))
    if family == "vlm":
        out["patches"] = prng.normal(prng.fold_in(key, 2),
                                     (batch, cfg.prefix_embeds, cfg.d_model), device)
    if family == "encdec":
        out["frames"] = prng.normal(prng.fold_in(key, 2),
                                    (batch, 4 * (prompt_len + gen), cfg.d_model), device)
    return out


def run(args: argparse.Namespace) -> Dict[str, Any]:
    """Serve once as the CLI would; return the report (and the live session
    under ``"session"``, which ``main`` does not print)."""
    log = Logger(quiet=args.quiet)
    sess, key, init_ms = build_session(args)
    storage, cfg, device = sess.storage, sess.cfg, sess.device
    report: Dict[str, Any] = dict(arch=args.arch, smoke=bool(args.smoke),
                                  **{k: getattr(cfg, k) for k in depth_fields(cfg)},
                                  fmt=OMCConfig.parse(args.fmt).fmt.name,
                                  device=str(device), init_ms=init_ms,
                                  **state_bytes_report(storage))
    if args.wire_roundtrip:
        sync(device)
        t0 = time.perf_counter()
        payload = encode_payload(storage)
        sess.hot_swap(payload)
        roundtrip_ms = (time.perf_counter() - t0) * 1e3
        if not trees_bit_equal(storage, sess.storage):
            raise RuntimeError("wire roundtrip changed the served tree")
        report.update(payload_bytes=len(payload), roundtrip_ms=roundtrip_ms,
                      payload_ratio=len(payload) / report["fp32_bytes"],
                      swap_bit_identical=True)
        log.info(f"wire roundtrip: {len(payload)} B payload in {roundtrip_ms:.1f} ms",
                 payload_bytes=len(payload), roundtrip_ms=roundtrip_ms)
        del payload
    del storage

    b, s = args.batch, args.prompt_len
    batch = request_batch(key, get_arch(args.arch).FAMILY, cfg, b, s, device, args.gen)
    cache = sess.init_cache(b, 4 * (s + args.gen), dtype=torch.float32)
    sync(device)
    t0 = time.perf_counter()
    cache, logits = sess.prefill(batch, cache)
    sync(device)
    t_prefill = time.perf_counter() - t0
    log.info(f"prefill [{b}x{s}] in {t_prefill * 1e3:.1f} ms", batch=b, prompt_len=s,
             prefill_ms=t_prefill * 1e3)

    out_tokens = []
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    t0 = time.perf_counter()
    for _ in range(args.gen):
        cache, logits = sess.decode_step(cache, tok)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out_tokens.append(tok)
    sync(device)
    dt = time.perf_counter() - t0
    log.result(f"decoded {args.gen} tokens x {b} seqs in {dt * 1e3:.1f} ms "
               f"({args.gen * b / dt:.1f} tok/s, {dt / args.gen * 1e3:.2f} ms/tok)",
               gen_tokens=args.gen, batch=b, decode_ms=dt * 1e3, tok_per_s=args.gen * b / dt)
    gen_ids = torch.cat(out_tokens, dim=1)
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")
    report.update(batch=b, prompt_len=s, gen=args.gen, prefill_ms=t_prefill * 1e3,
                  decode_ms=dt * 1e3, decode_ms_per_token=dt / args.gen * 1e3,
                  tok_per_s=args.gen * b / dt, logits_shape=list(logits.shape),
                  tokens=gen_ids.tolist(), session=sess)
    return report


def main(argv: Optional[Sequence[str]] = None) -> None:
    report = run(parse_args(argv))
    report.pop("session")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
