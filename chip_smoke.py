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
     and decodes bit-exact, PVT sums within rtol=1e-4; ``quantize_stats``,
     ``dequantize`` and ``quantize`` also in the paper tables' formats S1E5M10,
     S1E3M9, S1E4M8 and S1E5M7 at 0-d and 1-d leaves, conformer_s' stacked
     vectors [17, 512] and its stacked leaf [17, 512, 2048].  ``pack`` at every
     width 1-32 in every container it fits, at tile and superblock edges
     and odd tails, aligned and one element off, its C tiling
     ``pack_plan``'s.  ``fused_aggregate`` in each of its variants at a
     cohort where it applies (S1E3M7 compiled in at C = 1, 8, 33; tables for
     S1E4M3 and S1E2M3; the run-time decode for S1E5M10 and S1E4M14), on
     vectors and scalars, with a NaN code in a live row too: the variant the
     one ``kernel_variant`` states, and codes and sums the same bits from
     two launches with a launch on all-NaN client codes between them; its
     bound counts the live client planes (a dead client's is never read);
     and at [17, 512, 2048] with an async flush's K = 8 staleness weights
     (poly decay 0.5, fractional; decay 200, underflowed to exactly 0 for the
     stale entries), bit-exact as with 0/1 weights.  ``dequant_matmul``
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
     ``dequantize`` decodes every code of the same five formats, inf and
     NaN included, exactly as the plain version does, each in the variant
     ``kernel_variant`` states (S1E3M7 and S1E4M14 compiled in, the others
     at run time), on vectors with one (s, b) and with 16 stacked entries'
     pairs, and off the 16-byte grid (scalars); every ``dequantize`` case
     gives the same bits from two launches with one on all-NaN codes
     between them, and prints its variant.  It is also timed at
     conformer_s' stacked leaf [17, 512, 2048] with per-entry (s, b) in
     S1E3M7 and in S1E4M14 (the training driver's format).
     Kernel and plain version are timed with CUDA events (3 warm-ups,
     median of 20, L2 flushed before each launch); ``dequantize``, ``pack``
     and ``fused_aggregate`` also by the profiler's device time alone; beside
     ``dequant_matmul``, ``torch.matmul`` on the pre-decoded f32 weight
     ("matmul alone", not the same function), and its bound both ways:
     the tile path's TF32 passes over the tensor cores' rate, and f32
     operations over the rate outside them.
  3. Serve at full width: ``repro_torch.launch.serve.run`` on qwen2.5-3b,
     S1E3M7, --wire-roundtrip, batch 4, prompt 32, 16 new tokens — init on
     the card as the reference draws it (its time printed as ``init_ms``),
     compress (quantize_stats), encode (pack), hot-swap (unpack,
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
     and 1 decode step (cut from 2 to keep the script within its time
     limit: the CPU side decodes the 256,000 x 2560 tied head once a
     forward pass), as in phase 4.
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
  9. The paper tables at full width: each of ``benchmarks_torch``'s six
     scripts (Tables 1-4, Figs. 3-4) runs its ``run()`` on conformer_s' full
     config through ``simulate.run_training``, for ``TABLE_ROUNDS`` rounds
     (Table 2: ``TABLE2_ROUNDS``, the fewest at which its assertion that
     S1E2M3 beats before-adaptation holds here), each table printed as the
     reference prints it, with the script's wall time and peak device
     memory.  Counters are zeroed around each script: ``quantize_stats`` and
     ``dequantize`` launched in every one, ``quantize`` in Table 4 and Fig. 3
     (their PVT-off rows), no plain version.  The byte columns (Table 1's
     ``mem_ratio`` and ``mem_pct``, Table 2's ``mem_pct``) must equal
     ``tree_bytes_report`` computed on the host from the config's shapes.
 10. Card against CPU for the tables' loop: ``simulate.run_training`` on
     conformer_s cut to 2 layers at full width, 1 round, cohort 4 of 16
     with failure rate 0.25, S1E3M7 with PVT and PPQ 0.9, byte ledger on,
     on the card (kernels) and on the CPU (plain versions): ledgers equal,
     trees within the gate of phase 7; then ``omc.compress``
     (``compress_tree``) in five of the tables' formats and policies, PVT
     on and off: the same codes on the card as on the CPU.
 11. The training driver at full width: ``repro_torch.launch.train.run`` on
     conformer_s with the reference's defaults (S1E4M14, batch 8, 48
     frames, 16 clients, client lr 0.05, ``fedavg(1.0)``), 6 rounds with a
     checkpoint every 3 into ``build/train_driver/``; then a second ``run``
     resuming from a copy of ``ckpt_3`` to round 6, which must end in the
     same bits as the uninterrupted run (state and ``ckpt_6``); then
     ``pack_for_transport`` / ``unpack_from_transport`` of every compressed
     leaf of the trained state, bit-identical.  Counters are zeroed around
     each part: every round launches ``quantize_stats`` and ``dequantize``
     exactly as often as the plain versions do in a round of the same
     config on the CPU (``make_round_fn`` from the trained state), the
     transport part launches ``pack`` and ``unpack`` once a leaf, and no
     plain version runs.  Prints ms per round after the first, peak device
     memory, ``state_bytes_report``, the checkpoint's bytes on disk against
     f32, and ``benchmarks_torch/memory_measured.py``'s table.
 12. Card against CPU for the round: ``make_round_fn`` with ``fedavg(1.0)``
     on conformer_s cut to 2 layers at full width (S1E4M14, a frame batch
     8 x 48; 2 rounds) and on qwen2.5-3b cut to 2 layers at full width (d
     2048, vocab 151,936, tied head; S1E3M7, a 4 x 32 batch of the non-IID
     LM task, ``make_lm_task(vocab=4096, seq_len=32, iid=False)``, drawn on
     the card; 1 round, cut from 2 to keep the script under 900 s: its CPU
     side is the script's largest cost), from one state each, on the card
     (kernels) and on the CPU (plain versions), both on the card's batch:
     losses within rtol 1e-4, trees within phase 7's gate; the card's
     checkpoint restores on the CPU to the same bits.  The same LM batch is
     drawn on the CPU too: at most 1 in 1000 tokens and labels differ (the
     count printed), the client's 4096-entry Dirichlet draw takes the same
     rejection path on both sides, and ``client_logits`` agree within the
     base's 4 ulp a side plus the Dirichlet gate carried through the log.
 13. The async runtime at full width (``federated.async_engine.AsyncRunner``),
     under ``torch.use_deterministic_algorithms(True)``: phase 7's model,
     task and format, 1 local step at lr 0.1.  A degenerate trace (8
     clients, ``buffer_goal`` 8, ``FixedTrace``, decay 0, 2 flushes) against
     2 rounds of the engine at cohort 8 of 8: ledgers equal the engine's
     summed, trees within phase 7's gate.  A straggler run (32 clients,
     ``buffer_goal`` 8, ``ParetoTrace(alpha=1.5)``, poly decay 0.5,
     ``max_staleness`` 4, 3 flushes), fused and unfused from one seed: the
     same history rows but the loss (buffer, staleness, clock, ledger),
     losses within 1e-3, trees within the reference's async gate (4 S1E3M7
     steps max and 1 mean at each leaf's scale).  The fused run saves
     ``save_async_state`` mid-buffer into ``build/async/``, after its second
     flush with uploads buffered and a trained cache; a fresh runner restores
     it and runs to flush 3: storage, history and ledger the same bits.
     Counters are zeroed around each part: B1 and B2 launch exactly as often
     as the plain versions do in the same runs on the CPU (repeated at the
     smoke config with 8-frame batches: the schedule and the 13 compressed
     leaves do not depend on depth, width or batch), B5 once a compressed
     leaf a fused flush, the resumed run exactly what the straight run
     launched after the save; no plain version.  Prints ms per flush, peak
     device memory, completed updates per virtual second, ``stale_fraction``
     and ``dropped_fraction``, the checkpoint's bytes and its save and
     restore times.
 14. Card against CPU for the async runtime: the straggler run cut to 2
     layers at full width, 16 clients, ``buffer_goal`` 4, 2 fused flushes,
     on the card (kernels) and on the CPU (plain versions): the same
     history rows but the loss, losses within 1e-3, the same launches, trees
     within phase 7's gate.

 15. The FL sessions at full width (``api.session``): conformer_s, S1E3M7 with
     PVT, ``CohortPlan(8, 4)``, each ``FLClient`` training 2 plain SGD steps
     at lr 0.05 on 8 x 48-frame batches (autograd through ``conformer.loss``
     on the card).  Two sync rounds (``begin_round``, ``run_round``,
     ``ingest``, ``close_round``): every report arrives, round 1's delta is
     smaller than its full payload and decodes to the full payload's tree
     bit for bit, the download stays <= 60% of f32, the codec's
     ``wire_bytes`` equals ``state_bytes_report``'s ``packed_bytes``.  Then a
     second session with ``enable_async(4, decay=0.5)``: 8 check-ins, 2
     flushes, one upload stale by a version, a client back with
     ``held_version=0`` whose delta decodes to the state bit for bit; the
     versions after each ingest, the history and the kept versions as the
     protocol dictates.  Counters are zeroed around each round and each
     flush's stretch, and every count must equal the one predicted from the
     13 compressed leaves and the codec operations run (a ``quantize_stats``
     and a ``dequantize`` a leaf per compress and decompress; ``pack`` and
     ``unpack`` a leaf per payload, one more for each leaf sent as a delta
     with changed codes, as each payload's manifest says).  Then
     ``repro_torch.api.demo.main`` at its default configuration on the card
     (``ServeSession`` after ``hot_swap`` runs ``dequant_matmul``).  Last, the
     same protocol cut to 2 layers at full width, with a bit-exact client
     update (a raw leaf times 0.9) from a model on the format's grid, on the
     card and on the CPU: cohorts, payload lengths, traffic, the async
     history and every part's launches equal, ``quantize_stats`` and
     ``dequantize`` per part equal to full width's, codes equal (or trees
     within phase 7's gate).  Prints seconds per round and per flush, ms per
     full-payload encode and decode, payload bytes against f32 and the peak
     device memory.
 16. The non-IID path at full width (``data.partition``): phase 7's model,
     task, cohort and format, through ``engine.run_training_vectorized``
     with ``fused_agg=True`` over ``make_partitioned_batch_fn``.
     ``DirichletPartition(alpha=0.1)`` for 2 rounds of 2 local steps: losses
     finite, 13 ``fused_aggregate`` launches a round, ``quantize_stats`` and
     ``dequantize`` in every round (counts read after each round), no plain
     version; the mean over the sampled clients of each client's largest
     source share at least 0.4 (printed; IID gives 1/16); each sampled
     client's 16-entry Dirichlet draw takes the same rejection path on the
     card as on the CPU.  ``ShardPartition(2)``
     for 1 round: every source drawn is one of the client's two.
     ``DomainPartition(2)`` for 1 round of 1 local step: odd clients'
     labels are exactly the argmax under domain 1's probe, even clients'
     under domain 0's.  For each run, every batch the cohort drew is drawn
     again on the card and on the CPU: sources equal, frames within 4 ulp
     of max(|x|, 1), label flips counted and printed, at most 1 in 1000.
     Then ``examples_torch/cohort_scenarios.py --smoke`` (its four
     scenarios) and ``examples_torch/quickstart.py`` (10 rounds) on the
     card, each with its launch counts printed: ``quantize_stats`` and
     ``dequantize`` launched, no plain version.

Each phase's wall seconds are printed on a line of their own.  It then
prints one JSON line describing each kernel (``launches_by_path`` has the
main paths of phases 3, 5, 7, 9, 11, 13, 15 and 16) and, last, the line
``{"ok": true, "device": {...}}``.  f32 matmuls run in full f32: TF32 is
switched off for matmuls and cuDNN.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.api import codecs, demo, session  # noqa: E402
from repro_torch.api.session import FLClient, FLSession, ServeSession  # noqa: E402
from repro_torch.configs import conformer_s, qwen2_5_3b, recurrentgemma_2b  # noqa: E402
from repro_torch.core import omc as omc_lib  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.formats import FloatFormat, narrow, widen  # noqa: E402
from repro_torch.core.omc import OMCConfig  # noqa: E402
from repro_torch.core.policy import QuantizePolicy  # noqa: E402
from repro_torch.core.store import (bit_equal, compress_variable, decompress_tree,  # noqa: E402
                                    is_compressed, pack_for_transport, tree_bytes_report,
                                    trees_bit_equal, unpack_from_transport)
from repro_torch.core.tree import tree_items, tree_map, tree_map_with_path  # noqa: E402
from repro_torch.data.partition import (DirichletPartition, DomainPartition,  # noqa: E402
                                        ShardPartition, make_partitioned_batch_fn)
from repro_torch.data.synthetic import make_frame_task, make_lm_task  # noqa: E402
from repro_torch.federated import accounting, async_engine, engine, simulate  # noqa: E402
from repro_torch.federated import traces  # noqa: E402
from repro_torch.federated.cohort import CohortPlan  # noqa: E402
from repro_torch import checkpoint as ck  # noqa: E402
from repro_torch.federated.round import make_round_fn  # noqa: E402
from repro_torch.federated.state import (compress_params, init_state,  # noqa: E402
                                         state_bytes_report)
from repro_torch.kernels import agg  # noqa: E402
from repro_torch.kernels import bitpack as bk  # noqa: E402
from repro_torch.kernels import dequant_matmul as dm  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import quantize as qk  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import conformer, griffin, transformer  # noqa: E402
from repro_torch.optim import fedavg  # noqa: E402

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
# the paper tables' formats that phases 2-8 do not otherwise put through B1-B3
TABLE_FMTS = ("S1E5M10", "S1E3M9", "S1E4M8", "S1E5M7")
TABLE_SCRIPTS = ("table1_iid", "table2_adaptation", "table3_noniid", "table4_ablation",
                 "fig3_pvt_stability", "fig4_ppq_vs_apq")
PVT_OFF_SCRIPTS = ("table4_ablation", "fig3_pvt_stability")  # rows encoding by `quantize`
TABLE_ROUNDS = 2  # BENCH_ROUNDS of phase 9's scripts
TABLE2_ROUNDS = 1  # the fewest at which Table 2's S1E2M3 beats before-adaptation here
DRIVER_ROUNDS, DRIVER_CKPT_EVERY = 6, 3  # phase 11: the driver's run and its checkpoints
DRIVER_DIR = ROOT / "build" / "train_driver"
ASYNC_DIR = ROOT / "build" / "async"  # phase 13's mid-buffer checkpoint
ASYNC_SIM = simulate.SimConfig(local_steps=1, client_lr=0.1)
ASYNC_FLUSHES = 3  # phase 13's straggler run
ASYNC_STALENESS = np.asarray([0, 0, 1, 1, 2, 3, 5, 8], np.float32)  # phase 2's K = 8 buffer
SESSION_PLAN = CohortPlan(num_clients=8, cohort_size=4)  # phase 15
SESSION_ROUNDS, SESSION_BUFFER, SESSION_DECAY = 2, 4, 0.5
SESSION_STEPS, SESSION_LR = 2, 0.05  # each client's local SGD
NONIID_ROUNDS = 2  # phase 16's Dirichlet run


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
        recorded, and a shortfall is printed (records can be dropped; a
        window in which it recorded none is measured again, twice at most)."""
        for _ in range(warmup):
            fn()
        for _ in range(3):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    self._flush.zero_()
                    fn()
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages()
                       if e.device_time_total > 0 and "Fill" not in e.key]  # not the flush
            if kernels:
                break
            print("  profiler: no device time recorded; measuring again")
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


DQ_VARIANTS = {qk.DECODE_RUNTIME: "decode at run time", qk.DECODE_S1E3M7: "S1E3M7 compiled in",
               qk.DECODE_S1E4M14: "S1E4M14 compiled in"}


def nan_codes(codes: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """A tensor like ``codes`` holding one NaN code everywhere."""
    nan = (((1 << fmt.exp_bits) - 1) << fmt.mant_bits) | (1 << (fmt.mant_bits - 1))
    return narrow(torch.full(codes.shape, nan, device=codes.device), fmt.container_dtype)


def check_dequantize(codes, fmt, timer=None, batch_axes=0):
    """With ``batch_axes``, one (s, b) pair per stacked entry, shaped
    ``[*stack, 1, ...]`` as a stacked ``CompressedVariable`` holds them.  The
    launch's variant must be the one ``kernel_variant`` states, and a second
    launch, after one on all-NaN codes, must give the same bits."""
    lead = tuple(codes.shape[:batch_axes])
    shape = lead + (1,) * (codes.ndim - batch_axes) if batch_axes else ()
    g = torch.Generator(device="cuda").manual_seed(codes.numel())
    s = (1.0 + 0.05 * torch.randn(lead, generator=g, device="cuda")).reshape(shape)
    b = (0.01 * torch.randn(lead, generator=g, device="cuda")).reshape(shape)
    plan = qk.dequantize_plan(codes, fmt, s)
    require(plan["variant"] == qk.kernel_variant(fmt),
            f"dequantize {fmt.name}: the kernel's variant {plan} is not kernel_variant's")
    got = qk.dequantize(codes, fmt, s, b)
    qk.dequantize(nan_codes(codes, fmt), fmt, s, b)
    again = qk.dequantize(codes, fmt, s, b)
    torch.cuda.synchronize()
    want = ref.ref_dequantize(codes, fmt, s, b)
    require(bit_equal(got, want), f"dequantize differs {fmt.name} {tuple(codes.shape)}")
    require(bit_equal(got, again), f"dequantize {fmt.name} {tuple(codes.shape)}: two launches "
            f"differ")
    fin = torch.isfinite(want)
    out = dict(shape=list(codes.shape), fmt=fmt.name, variant=DQ_VARIANTS[plan["variant"]],
               vec=plan["vec"], same_bits=True,
               max_abs_err=(got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0)
    if timer:
        out.update(ms=timer(lambda: qk.dequantize(codes, fmt, s, b)),
                   device_ms=timer.device(lambda: qk.dequantize(codes, fmt, s, b)),
                   plain_ms=timer(lambda: ref.ref_dequantize(codes, fmt, s, b)),
                   bound_ms=bound_ms(codes.numel() * (fmt.container_bytes_per_value + 4)),
                   blocks=plan["blocks"])
    return out


def check_dequantize_decode(name: str) -> list:
    """Every code of ``name``, inf and NaN included, through ``dequantize``
    exactly as the plain version decodes it (b != 0): on 16-byte vectors
    with one (s, b), as 16 stacked entries with one pair each, and one
    element off the 16-byte grid (the scalar pass)."""
    fmt = FloatFormat.parse(name)
    # every code, repeated up to 256 of them for S1E2M3: 16 entries of whole vectors
    c = narrow(torch.arange(max(1 << fmt.bits, 256), device="cuda") % (1 << fmt.bits),
               fmt.container_dtype)
    rows = []
    for codes, batch_axes, vec in ((c, 0, True), (c.reshape(16, -1), 1, True),
                                   (c[1:], 0, False)):
        r = check_dequantize(codes, fmt, batch_axes=batch_axes)
        require(r["vec"] == vec, f"decode check {name} {r['shape']}: expected "
                f"{'vectors' if vec else 'scalars'}")
        rows.append(dict(r, codes=int(codes.numel())))
    return rows


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
    nbytes = bk.pack_moved_bytes(n, width, codes.dtype)
    outs = [dict(shape=list(codes.shape), width=width, max_abs_err=0.0),
            dict(shape=list(codes.shape), width=width, max_abs_err=0.0)]
    if timer:
        outs[0].update(ms=timer(lambda: bk.pack(flat, width)),
                       device_ms=timer.device(lambda: bk.pack(flat, width)),
                       plain_ms=timer(lambda: ref.ref_pack(flat, width)),
                       bound_ms=bound_ms(nbytes))
        outs[1].update(ms=timer(lambda: bk.unpack(words, width, n, codes.dtype)),
                       plain_ms=timer(lambda: ref.ref_unpack(words, width, n, codes.dtype)),
                       bound_ms=bound_ms(bk.unpack_moved_bytes(n, width, codes.dtype)))
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
                          live_nan=False, weights=None):
    """``fused_aggregate`` against its plain version: server and client codes
    from random weights, per-entry (s, b), dead clients holding a NaN code
    (with ``live_nan``, one element of live client 0 NaN too), or with
    ``weights`` (an async flush's staleness weights) those client weights
    and no dead client.  Codes bit-exact, sums within rtol=1e-4 (NaN where
    the plain version's are); the kernel's variant the one
    ``kernel_variant`` states; the same bits from a second launch, after one
    on all-NaN client codes."""
    g = torch.Generator(device="cuda").manual_seed(sum(shape) + batch_axes + cohort)
    lead = tuple(shape[:batch_axes])
    srv = qk.quantize(torch.randn(shape, generator=g, device="cuda") * 0.05, fmt)
    cl = widen(qk.quantize(torch.randn((cohort,) + shape, generator=g, device="cuda") * 0.05,
                           fmt))
    w = torch.ones(cohort, device="cuda")
    nan_code = (((1 << fmt.exp_bits) - 1) << fmt.mant_bits) | (1 << (fmt.mant_bits - 1))
    if weights is not None:
        w, dead = weights.to("cuda", torch.float32), ()
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
    if weights is not None:
        out["weights"] = [round(x, 6) for x in w.tolist()]
    if timer:
        entries = math.prod(lead)
        run = lambda: agg.fused_aggregate(*args, batch_axes=batch_axes)  # noqa: E731
        out.update(ms=timer(run), device_ms=timer.device(run),
                   plain_ms=timer(lambda: ref.ref_fused_aggregate(*args, batch_axes=batch_axes)),
                   bound_ms=bound_ms(agg.fused_aggregate_moved_bytes(
                       cohort, srv.numel(), fmt, stack_entries=entries,
                       live=int((w > 0).sum()))))
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
               pack_bound_ms=bound_ms(bk.pack_moved_bytes(n, w, flat.dtype)))
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


def check_table_formats(results: dict) -> None:
    """The tables' formats (Fig. 3's S1E5M10, Fig. 4's S1E3M9, S1E4M8, S1E5M7)
    through B1, B2 and B3 at the leaves the tables compress: 0-d and 1-d
    (Table 4's and Fig. 3's every-parameter policy), conformer_s' stacked
    vectors and a stacked weight leaf, with specials in all but the 0-d leaf."""
    for name in TABLE_FMTS:
        fmt = FloatFormat.parse(name)
        for shape, batch_axes in (((), 0), ((5,), 0), ((TRAIN_CFG.d_model,), 0),
                                  ((TRAIN_CFG.n_layers, TRAIN_CFG.d_model), 1),
                                  (TRAIN_LEAF, 1)):
            x = _inputs(shape, fmt, seed=sum(shape) + fmt.bits, specials=shape != ())
            codes, r = check_quantize_stats(x, fmt, batch_axes)
            results["quantize_stats"].append(r)
            results["dequantize"].append(check_dequantize(codes, fmt, batch_axes=batch_axes))
            results["quantize"].append(check_quantize(x, fmt, codes))
            del x, codes


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
    check_table_formats(results)
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
    # dequantize: every code of five formats, each in its variant; conformer_s'
    # stacked leaf with per-entry (s, b) in S1E3M7 (engine, async) and in
    # S1E4M14 (the training driver), timed
    for name in ("S1E2M3", "S1E3M7", "S1E4M3", "S1E5M10", "S1E4M14"):
        results["dequantize"] += check_dequantize_decode(name)
    for fmt in (FMT, FloatFormat.parse("S1E4M14")):
        x = _inputs(TRAIN_LEAF, fmt, seed=fmt.bits, specials=False)
        codes = qk.quantize_stats(x, fmt, batch_axes=1)[0]
        del x
        results["dequantize"].append(check_dequantize(codes, fmt, timer, batch_axes=1))
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
    # an async flush's weights at the same leaf, K = 8: fractional (poly decay
    # 0.5), and at decay 200 underflowed to exactly 0 for the stale entries
    for decay in (0.5, 200.0):
        w = async_engine.flush_weights(ASYNC_STALENESS, decay, "poly")
        results["fused_aggregate"].append(check_fused_aggregate(
            TRAIN_LEAF, 1, FMT, timer if decay == 0.5 else None, weights=w))
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
    for r in results["dequantize"]:
        print(f"  dequantize {r['fmt']} {r['shape']}: {r['variant']}, "
              f"{'vectors' if r['vec'] else 'scalars'}, same bits twice {r['same_bits']}"
              + (f", device {r['device_ms']:.4f} ms, {r['blocks']} blocks"
                 if "device_ms" in r else ""))
    for r in results["fused_aggregate"]:
        print(f"  fused_aggregate {r['fmt']} {r['shape']} C={r['cohort']}: {r['variant']}, "
              f"{r['blocks']} blocks an entry, {'vectors' if r['vec'] else 'scalars'}, "
              f"same bits twice {r['same_bits']}"
              + (f", device {r['device_ms']:.4f} ms" if "device_ms" in r else "")
              + (f", weights {r['weights']}" if "weights" in r else ""))
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
    for k in ("num_params", "init_ms", "payload_bytes", "fp32_bytes", "payload_ratio",
              "roundtrip_ms", "prefill_ms", "decode_ms_per_token", "tok_per_s", "more_batches_ms",
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


def card_vs_cpu(run: str, family, cfg, cut, decode_steps: int = 2) -> float:
    """Prefill and ``decode_steps`` decode steps of ``cut`` on the card
    (kernels) and on the CPU (plain versions); the largest logit difference
    must be <= 1e-3."""
    gpu = ServeSession(family, cfg, cut)
    cpu = ServeSession(family, cfg, tree_map(lambda x: x.to("cpu"), cut))
    g = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (4, 32), generator=g, device="cuda")

    def steps(sess, tokens, pick=None):
        """The logits of prefill and the decode steps, on the host; the
        decode steps take ``pick``'s tokens (else their own argmax)."""
        c, lg = sess.prefill(dict(tokens=tokens), sess.init_cache(4, 64))
        out = [lg.cpu()]
        for i in range(decode_steps):
            tok = (pick[i] if pick else torch.argmax(out[-1][:, -1], dim=-1))[:, None]
            c, lg = sess.decode_step(c, tok.to(tokens.device))
            out.append(lg.cpu())
        return out

    card = steps(gpu, toks)
    again = steps(gpu, toks)  # the whole path twice in one process: the same bits
    picks = [torch.argmax(lg[:, -1], dim=-1) for lg in card[:decode_steps]]
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
    # one decode step: the CPU side decodes the 256,000 x 2560 tied head in
    # plain PyTorch once a forward pass, and the script's time limit is fixed
    return card_vs_cpu("recurrentgemma-2b, 5 layers", griffin, cfg5, cut, decode_steps=1)


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
    params = conformer.init(key, cfg, "cuda")
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
    params = conformer.init(prng.PRNGKey(1), cfg, "cuda")
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


# ---------------------------------------------------------------------------
# 9. the paper tables at full width, 10. the simulate loop, card against CPU
# ---------------------------------------------------------------------------


def phase_tables() -> dict:
    """Each table script's ``run()`` at full width on the card, counters
    zeroed around each: ``quantize_stats`` and ``dequantize`` launched in
    every script, ``quantize`` in those with PVT-off rows, no plain version;
    every row's losses finite; the byte columns equal to
    ``tree_bytes_report`` on the host from the config's shapes alone."""
    results, counts = {}, {}
    for name in TABLE_SCRIPTS:
        mod = importlib.import_module(f"benchmarks_torch.{name}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rows = mod.run(rounds=TABLE2_ROUNDS if name == "table2_adaptation" else TABLE_ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = ops.launch_counts()
        require_launches(got, name, quantize_stats=None, dequantize=None,
                         **({"quantize": None} if name in PVT_OFF_SCRIPTS else {}))
        for r in rows:
            require(math.isfinite(r["final_eval"]), f"{name}: {r}")
            for x in r.get("train_curve", []) + r.get("eval_curve", []):
                require(math.isfinite(x), f"{name}: non-finite curve {r}")
        results[name] = dict(rows=rows, wall_s=wall, counts=got,
                             max_memory_allocated=torch.cuda.max_memory_allocated())
        print(f"  {name}: {wall:.1f} s, peak {results[name]['max_memory_allocated'] / 1e9:.2f} "
              f"GB, launches {got}")
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
    # the byte columns: Table 1's (PPQ 0.9) and Table 2's (PPQ 0.9, streaming)
    shapes = conformer.init(prng.PRNGKey(0), TRAIN_CFG, "meta")
    for name, rows in (("table1_iid", results["table1_iid"]["rows"]),
                       ("table2_adaptation", results["table2_adaptation"]["rows"][1:])):
        for r in rows:
            want = tree_bytes_report(shapes, FloatFormat.parse(r["fmt"]), QuantizePolicy(),
                                     fraction=0.9)
            require(r["mem_pct"] == round(100 * want["packed_ratio"]),
                    f"{name} {r['fmt']}: mem_pct {r['mem_pct']} != {want['packed_ratio']}")
            if "mem_ratio" in r:  # Table 1's packed_ratio column
                require(r["mem_ratio"] == want["packed_ratio"], f"{name} {r['fmt']}: "
                        f"packed_ratio {r['mem_ratio']} != {want['packed_ratio']}")
    print(f"  tables: {sum(r['wall_s'] for r in results.values()):.1f} s in all; "
          f"byte columns equal tree_bytes_report's from the shapes; launches {counts}")
    return dict(results=results, counts=counts)


def phase_tables_card_vs_cpu() -> tuple:
    """``simulate.run_training`` (the tables' loop) on conformer_s cut to 2
    layers at full width, 1 round, cohort 4 of 16 with failure rate 0.25,
    S1E3M7 with PVT and PPQ 0.9, the byte ledger on: on the card (kernels)
    and on the CPU (plain versions), ledgers equal, trees within phase 7's
    gate.  Then ``omc.compress`` (``compress_tree``) of the same params in
    the tables' formats and policies: the same codes on both."""
    cfg = dataclasses.replace(TRAIN_CFG, n_layers=2)
    omc = OMCConfig.parse(FMT.name)
    sim = simulate.SimConfig(local_steps=1, client_lr=0.1)
    plan = CohortPlan(num_clients=16, cohort_size=4, failure_rate=0.25)
    params = conformer.init(prng.PRNGKey(2), cfg, "cuda")
    on = {dev: tree_map(lambda x, d=dev: x.to(d), params) for dev in ("cuda", "cpu")}
    out = {}
    for dev in ("cuda", "cpu"):
        task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=32,
                               num_clients=16, device=dev)
        ops.reset_launch_counts()
        out[dev] = simulate.run_training(conformer, cfg, omc, sim, plan,
                                         lambda c, r, s, t=task: t.batch(c, r, s, 4),
                                         prng.PRNGKey(0), 1, init_params=on[dev], wire=True)
        want_backend = "cuda" if dev == "cuda" else "ref"
        got = ops.launch_counts()
        require(all(k.endswith(want_backend) for k in got) and got, f"loop on {dev}: {got}")
    require(ledger(out["cuda"][1]) == ledger(out["cpu"][1]), "card and CPU ledgers differ")
    require(abs(out["cuda"][1][0]["loss"] - out["cpu"][1][0]["loss"]) < 1e-3,
            "card and CPU losses differ")
    gap = tree_gap(out["cuda"][0], out["cpu"][0])
    require(gap[0] <= TREE_MAX and gap[1] <= TREE_MEAN, f"card and CPU trees differ: {gap}")
    print(f"  loop, card vs CPU, 2 layers at full width, 1 round: {ledger(out['cuda'][1])}, "
          f"losses {out['cuda'][1][0]['loss']} / {out['cpu'][1][0]['loss']}, trees max |d| "
          f"{gap[0]:.3g}, mean |d| {gap[1]:.3g}")
    every = QuantizePolicy(weights_only=False, min_ndim=0, min_size=1)
    for name, pvt, policy in (("S1E3M7", True, QuantizePolicy()), ("S1E3M7", False, every),
                              ("S1E5M10", False, QuantizePolicy()), ("S1E4M14", True, every),
                              ("S1E3M9", True, QuantizePolicy())):
        c = OMCConfig.parse(name, pvt=pvt, policy=policy)
        card, host = (dict(tree_items(omc_lib.compress(on[d], c))) for d in ("cuda", "cpu"))
        n = 0
        for path, leaf in card.items():
            require(is_compressed(leaf) == is_compressed(host[path]), f"compress_tree {path}")
            if is_compressed(leaf):
                n += 1
                require(bit_equal(leaf.codes, host[path].codes),
                        f"compress_tree {name} pvt={pvt}: codes of {path} differ")
        print(f"  compress_tree {name} pvt={pvt} {'every parameter' if policy is every else ''}"
              f": {n} leaves, the same codes on the card and the CPU")
    return gap


# ---------------------------------------------------------------------------
# 11. the training driver at full width, 12. the round, card against CPU
# ---------------------------------------------------------------------------


def npz_equal(a: Path, b: Path) -> bool:
    """Two checkpoints' arrays: the same names, dtypes and bytes."""
    with np.load(a / "arrays.npz") as x, np.load(b / "arrays.npz") as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes() for k in x.files)


def states_bit_equal(a, b) -> bool:
    """Two fedavg ``TrainState``s: params bit for bit, count, round and key."""
    return (trees_bit_equal(a.params, b.params) and a.opt_state == b.opt_state
            and a.round == b.round and a.rng == b.rng)


def as_cuda(counts: dict) -> dict:
    return {k.replace(".ref", ".cuda"): v for k, v in counts.items()}


def phase_train_driver() -> dict:
    shutil.rmtree(DRIVER_DIR, ignore_errors=True)
    argv = ["--rounds", str(DRIVER_ROUNDS), "--ckpt-every", str(DRIVER_CKPT_EVERY), "--quiet"]
    counts = {}
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    straight = train.run(train.parse_args(argv + ["--ckpt-dir", str(DRIVER_DIR / "straight")]))
    counts["straight"] = ops.launch_counts()
    require_launches(counts["straight"], "train driver", quantize_stats=None, dequantize=None)
    require(all(math.isfinite(x) and 0 < x < 20 for x in straight["losses"]),
            f"bad losses {straight['losses']}")

    # the plain versions' launches in one round of the same config on the CPU,
    # from the trained state (the driver's round is this make_round_fn)
    cfg, omc = conformer_s.config(), OMCConfig.parse(straight["fmt"])
    task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=48, num_clients=16)
    batch = {k: v.cpu() for k, v in task.batch(0, 0, 0, 8).items()}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    make_round_fn(conformer, cfg, omc, fedavg(1.0), client_lr=0.05)(
        straight["state"].to("cpu"), batch)
    plain_s = time.perf_counter() - t0
    want_round = as_cuda(ops.launch_counts())
    require(set(want_round) == {"quantize_stats.cuda", "dequantize.cuda"},
            f"plain round launches {ops.launch_counts()}")
    require(straight["round_launches"] == [want_round] * DRIVER_ROUNDS,
            f"driver rounds launched {straight['round_launches']}, the plain versions "
            f"{want_round} a round")
    n_comp = sum(is_compressed(v) for _, v in tree_items(straight["state"].params))
    require(straight["init_launches"] == {"quantize_stats.cuda": n_comp},
            f"init launched {straight['init_launches']} for {n_comp} compressed leaves")

    # a killed run, rerun: resume from a copy of ckpt_3 and train to round 6
    resumed_dir = DRIVER_DIR / "resumed"
    resumed_dir.mkdir(parents=True)
    shutil.copytree(DRIVER_DIR / "straight" / f"ckpt_{DRIVER_CKPT_EVERY}",
                    resumed_dir / f"ckpt_{DRIVER_CKPT_EVERY}")
    ops.reset_launch_counts()
    resumed = train.run(train.parse_args(argv + ["--ckpt-dir", str(resumed_dir)]))
    counts["resumed"] = ops.launch_counts()
    require(resumed["start_round"] == DRIVER_CKPT_EVERY, f"resumed at {resumed['start_round']}")
    require(resumed["round_launches"] == [want_round] * (DRIVER_ROUNDS - DRIVER_CKPT_EVERY),
            f"resumed rounds launched {resumed['round_launches']}")
    require(resumed["losses"] == straight["losses"][DRIVER_CKPT_EVERY:],
            f"resumed losses {resumed['losses']} != {straight['losses'][DRIVER_CKPT_EVERY:]}")
    require(states_bit_equal(straight["state"], resumed["state"]),
            "the resumed run's state differs from the uninterrupted run's")
    last = f"ckpt_{DRIVER_ROUNDS}"
    require(npz_equal(DRIVER_DIR / "straight" / last, resumed_dir / last),
            f"the resumed run's {last} differs from the uninterrupted run's")

    # transport: every compressed leaf of the trained state through the wire form
    leaves = [v for _, v in tree_items(straight["state"].params) if is_compressed(v)]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wire_bytes = 0
    for leaf in leaves:
        blob = pack_for_transport(leaf)
        wire_bytes += blob["nbytes"]
        back = unpack_from_transport(blob)
        require(all(bit_equal(x, y) for x, y in ((back.codes, leaf.codes), (back.s, leaf.s),
                                                  (back.b, leaf.b))), "transport changed a leaf")
    torch.cuda.synchronize()
    transport_ms = (time.perf_counter() - t0) * 1e3
    counts["transport"] = ops.launch_counts()
    require_launches(counts["transport"], "transport", pack=len(leaves), unpack=len(leaves))

    rep = straight["state_bytes"]
    ms = straight["round_ms"][1:]  # after the first round
    print(f"  conformer_s, {rep['num_params']:,} parameters, S1E4M14: "
          f"{statistics.median(ms):.1f} ms per round (median of rounds 2-{DRIVER_ROUNDS}; "
          f"all {[round(x, 1) for x in straight['round_ms']]}), peak "
          f"{straight['max_memory_allocated'] / 1e9:.2f} GB")
    print(f"  losses {straight['losses']}, grad norms {straight['grad_norms']}")
    print(f"  launches per round {want_round} (the plain versions' in a round on the CPU, "
          f"{plain_s:.1f} s), init {straight['init_launches']}")
    print(f"  state_bytes_report {rep}")
    print(f"  checkpoint {last}: {straight['ckpt_bytes']:,} bytes on disk, "
          f"{straight['ckpt_bytes'] / rep['fp32_bytes']:.1%} of f32; resumed from "
          f"ckpt_{DRIVER_CKPT_EVERY} in {sum(resumed['round_ms']):.0f} ms of rounds: the same bits")
    print(f"  transport: {len(leaves)} leaves, {wire_bytes:,} wire bytes "
          f"({wire_bytes / rep['fp32_bytes']:.1%} of f32), packed and unpacked in "
          f"{transport_ms:.1f} ms, bit-identical; launches {counts['transport']}")
    mem = importlib.import_module("benchmarks_torch.memory_measured")
    ops.reset_launch_counts()
    mem_rows = mem.run()
    require_launches(ops.launch_counts(), "memory_measured", quantize_stats=None,
                     dequantize=None)
    total = {}
    for c in counts.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return dict(counts=total, round_ms=straight["round_ms"], losses=straight["losses"],
                max_memory_allocated=straight["max_memory_allocated"], state_bytes=rep,
                ckpt_bytes=straight["ckpt_bytes"], transport_ms=transport_ms,
                memory_measured=mem_rows, per_round=want_round)


def round_card_vs_cpu(name: str, family, cfg, fmt: str, batch: dict, rounds: int) -> tuple:
    """``rounds`` rounds of ``make_round_fn`` from one state on the card and
    on the CPU; returns (card losses, CPU losses, tree gap)."""
    omc = OMCConfig.parse(fmt)
    state = init_state(prng.PRNGKey(3), family, cfg, omc, fedavg(1.0), device="cuda")
    fn = make_round_fn(family, cfg, omc, fedavg(1.0), client_lr=0.05)
    out = {}
    for dev in ("cuda", "cpu"):
        st = state.to(dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        ops.reset_launch_counts()
        losses = []
        for _ in range(rounds):
            st, m = fn(st, b)
            losses.append(m["loss"].item())
        got = ops.launch_counts()
        backend = "cuda" if dev == "cuda" else "ref"
        require(got and all(k.endswith(backend) for k in got), f"{name} on {dev}: {got}")
        out[dev] = (st, losses)
    (card, card_losses), (host, host_losses) = out["cuda"], out["cpu"]
    for x, y in zip(card_losses, host_losses):
        require(math.isfinite(x) and abs(x - y) <= 1e-4 * abs(y),
                f"{name}: card and CPU losses differ: {card_losses} {host_losses}")
    gap = tree_gap(card.params, tree_map(lambda x: x.to("cuda"), host.params))  # decoded on the card
    require(gap[0] <= TREE_MAX and gap[1] <= TREE_MEAN, f"{name}: card and CPU trees differ: {gap}")
    path = ck.save_state(str(DRIVER_DIR / f"card_{name}"), rounds, card)
    restored, _ = ck.restore_state(path, state.to("cpu"))
    require(states_bit_equal(restored, card.to("cpu")),
            f"{name}: the card's checkpoint restored on the CPU to other bits")
    print(f"  {name}: losses card {card_losses} / CPU {host_losses}, trees max |d| "
          f"{gap[0]:.3g}, mean |d| {gap[1]:.3g}; the card's checkpoint restores on the CPU "
          f"to the same bits")
    del state, card, host, restored
    shutil.rmtree(DRIVER_DIR / f"card_{name}")
    return card_losses, host_losses, gap


def phase_round_card_vs_cpu() -> dict:
    ccfg = dataclasses.replace(TRAIN_CFG, n_layers=2)
    task = make_frame_task(d_in=ccfg.d_in, n_classes=ccfg.n_classes, seq_len=48, num_clients=16)
    conf = round_card_vs_cpu("conformer_s", conformer, ccfg, "S1E4M14", task.batch(0, 0, 0, 8), 2)
    torch.cuda.empty_cache()
    qcfg = dataclasses.replace(CFG, n_layers=2)
    lm = lm_batch_card_vs_cpu()
    # 1 round: the CPU side (the plain versions on the 311 M-value
    # embedding) is the script's largest cost, cut to keep it under 900 s
    qwen = round_card_vs_cpu("qwen2.5-3b", transformer, qcfg, "S1E3M7", lm.pop("batch"), 1)
    torch.cuda.empty_cache()
    return dict(conformer_s=conf, qwen=qwen, lm_batch=lm)


def lm_batch_card_vs_cpu(client: int = 1) -> dict:
    """Phase 12's qwen batch: the non-IID LM task (vocab 4096, 32 tokens,
    Dirichlet(0.3) per client) drawn on the card, 4 rows of ``client``;
    the same batch drawn on the CPU must agree in all but at most 1 in 1000
    tokens and labels, the client's Dirichlet draw must take the same
    rejection path on both (iteration counts equal), and ``client_logits``
    must agree within the base's 4 ulp a side plus the Dirichlet gate of
    tests/test_torch_partition.py carried through the log."""
    out = {}
    for dev in ("cuda", "cpu"):
        task = make_lm_task(vocab=4096, seq_len=32, iid=False, device=dev)
        sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        batch = task.batch(client, 0, 0, 4)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        kc = prng.fold_in(prng.PRNGKey(task.seed + 1), client)
        lg, iters = prng.loggamma(kc, torch.full((4096,), task.part.alpha), device=dev,
                                  return_iterations=True)
        out[dev] = dict(batch=batch, ms=ms, iters=iters.cpu(), loggamma=lg.cpu(),
                        bias=task.client_bias(client).cpu(),
                        logits=task.client_logits(client).cpu())
    card, host = out["cuda"], out["cpu"]
    flips = sum(int((card["batch"][k].cpu() != host["batch"][k]).sum())
                for k in ("tokens", "labels"))
    total = 2 * host["batch"]["tokens"].numel()
    iter_diff = int((card["iters"] != host["iters"]).sum())
    eps = torch.finfo(torch.float32).eps
    scale = 16 * eps * max(host["loggamma"].abs().max().item(), 1.0)
    bias_err = (card["bias"] - host["bias"]).abs()
    bias_tol = scale + 2 * eps * host["bias"].abs()
    logit_err = (card["logits"] - host["logits"]).abs()
    logit_tol = bias_tol[None, :] + 1.5 * 8 * 2.0 ** -20 + eps * host["logits"].abs()
    print(f"  non-IID LM batch (vocab 4096, 4 x 32, client {client}): drawn in "
          f"{card['ms']:.1f} ms on the card, {host['ms']:.1f} ms on the CPU; "
          f"{flips} of {total} tokens and labels differ; dirichlet iterations differ in "
          f"{iter_diff} of 4096 (max {int(card['iters'].max())}); client_logits max |d| "
          f"{logit_err.max().item():.3g}, bias max |d| {bias_err.max().item():.3g}")
    require(flips * 1000 <= total, f"non-IID LM batch: {flips} of {total} tokens differ")
    require(iter_diff == 0, f"non-IID LM task: {iter_diff} dirichlet entries took another path")
    require(bool((bias_err <= bias_tol).all()), "non-IID LM task: client bias card vs CPU")
    require(bool((logit_err <= logit_tol).all()), "non-IID LM task: client_logits card vs CPU")
    b = card["batch"]
    require(b["tokens"].device.type == "cuda" and b["tokens"].shape == (4, 32), "LM batch")
    return dict(batch=b, flips=flips, total=total, card_ms=card["ms"], cpu_ms=host["ms"])


# ---------------------------------------------------------------------------
# 13. the async runtime at full width, 14. card against CPU
# ---------------------------------------------------------------------------


def async_data(cfg, clients: int, device="cuda", seq: int = 256, batch: int = 8):
    task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=seq,
                           num_clients=clients, device=device)
    return lambda c, r, s: task.batch(c, r, s, batch)


def async_runner(cfg, params, data_fn, clients: int, acfg, trace, fused: bool):
    return async_engine.AsyncRunner(conformer, cfg, OMCConfig.parse(FMT.name), ASYNC_SIM, acfg, trace,
                                    num_clients=clients, data_fn=data_fn, init_params=params,
                                    fused_agg=fused)


def straggler(clients: int, goal: int):
    """The straggler run's knobs: Pareto latencies (alpha 1.5), poly decay 0.5,
    ``max_staleness`` 4."""
    return (async_engine.AsyncConfig(buffer_goal=goal, decay=0.5, max_staleness=4),
            traces.ParetoTrace(seed=0, latency=1.0, alpha=1.5))


def schedule(history) -> list:
    """A history's rows without the loss: buffer, staleness, clock, ledger."""
    return [{k: v for k, v in h.items() if k != "loss"} for h in history]


def plain_async_counts(clients: int, acfg, trace, fused: bool, flushes: int) -> dict:
    """The plain versions' launches in the same run on the CPU: the schedule,
    the training groups and the 13 compressed leaves do not depend on depth,
    width or batch, so the run is repeated at the smoke config with a
    1 x 8-frame batch; returned as ``.cuda`` keys."""
    cfg = conformer_s.smoke_config()
    shapes = {c: conformer.init(prng.PRNGKey(0), c, "meta") for c in (cfg, TRAIN_CFG)}
    names = {c: accounting.selected_names(p, conformer.param_specs(c), OMCConfig.parse(FMT.name))
             for c, p in shapes.items()}
    require(names[cfg] == names[TRAIN_CFG], f"smoke and full configs select other leaves {names}")
    params = conformer.init(prng.PRNGKey(0), cfg, "cpu")
    ops.reset_launch_counts()
    runner = async_runner(cfg, params, async_data(cfg, clients, "cpu", seq=8, batch=1), clients,
                          acfg, trace, fused)
    runner.run_until(flushes=flushes)
    got = ops.launch_counts()
    require(got and all(k.endswith(".ref") for k in got), f"plain async run: {got}")
    return as_cuda(got)


def fused_gate(a, b) -> tuple:
    """The reference's fused-vs-unfused async gate: at each leaf's scale, max
    |d| within 4 S1E3M7 steps and mean |d| within 1; returns the worst
    (max / step, mean / step)."""
    da, db = dict(tree_items(decompress_tree(a))), dict(tree_items(decompress_tree(b)))
    require(da.keys() == db.keys(), "trees differ in structure")
    worst = (0.0, 0.0)
    for path, x in da.items():
        y = db[path].to(x.device)
        require(bool(torch.isfinite(x).all() and torch.isfinite(y).all()), f"leaf {path} not finite")
        d = (x - y).abs()
        scale = max(x.abs().max().item(), y.abs().max().item(), 2.0 ** -6)
        step = 2.0 ** (math.floor(math.log2(scale)) - 7)
        worst = (max(worst[0], d.max().item() / step), max(worst[1], d.mean().item() / step))
    require(worst[0] <= 4 and worst[1] <= 1, f"fused vs unfused async trees: {worst} steps")
    return worst


def _async_save_point(runner) -> bool:
    """Mid-buffer after the second flush: buffered uploads and a trained but
    not uploaded cache, both non-empty."""
    return runner.version == 2 and bool(runner.buffer) and bool(runner.trained)


def phase_async() -> dict:
    """The async runtime at full width, under deterministic algorithms;
    launch counters zeroed around each part."""
    deterministic = torch.are_deterministic_algorithms_enabled()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        return _phase_async()
    finally:
        torch.use_deterministic_algorithms(deterministic)


def _phase_async() -> dict:
    cfg, omc = TRAIN_CFG, OMCConfig.parse(FMT.name)
    params = conformer.init(prng.PRNGKey(0), cfg, "cuda")
    counts = {}

    # degenerate trace: 8 clients, buffer 8, fixed latency, decay 0 -> the engine
    data8 = async_data(cfg, 8)
    acfg, trace = async_engine.AsyncConfig(buffer_goal=8), traces.FixedTrace(latency=1.0)
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    runner = async_runner(cfg, params, data8, 8, acfg, trace, fused=False)
    runner.run_until(flushes=2)
    counts["degenerate"] = ops.launch_counts()
    want = plain_async_counts(8, acfg, trace, False, 2)
    require_launches(counts["degenerate"], "async degenerate", fused_aggregate=0,
                     **{k.split(".")[0]: v for k, v in want.items()})
    require(set(counts["degenerate"]) == set(want), f"degenerate: {counts['degenerate']} {want}")
    est, ehist = engine.run_training_vectorized(conformer, cfg, omc, ASYNC_SIM,
                                                engine.CohortSpec(CohortPlan(8, 8)), data8,
                                                prng.PRNGKey(0), 2, init_params=params)
    for i, h in enumerate(runner.history):
        require(h["buffer"] == 8 and h["staleness_max"] == 0, f"degenerate flush {h}")
        for k in ("down_bytes", "up_bytes"):
            require(h[k] == sum(e[k] for e in ehist[:i + 1]), f"degenerate {k}: {h} {ehist}")
        require(abs(h["loss"] - ehist[i]["loss"]) < 1e-3, f"degenerate losses {h} {ehist[i]}")
    gap = tree_gap(runner.storage, est)
    require(gap[0] <= TREE_MAX and gap[1] <= TREE_MEAN, f"degenerate vs engine trees {gap}")
    print(f"  degenerate trace, 8 clients, 2 flushes: ledgers equal the engine's summed "
          f"({runner.history[-1]['down_bytes']:,} down, {runner.history[-1]['up_bytes']:,} up), "
          f"trees max |d| {gap[0]:.3g}, mean |d| {gap[1]:.3g}; launches "
          f"{counts['degenerate']} (the plain versions' on the CPU)")
    del runner, est

    # straggler run: 32 clients, buffer 8, Pareto latencies; fused and
    # unfused from one seed; the fused run saves mid-buffer
    data32 = async_data(cfg, 32)
    acfg, trace = straggler(32, 8)
    shutil.rmtree(ASYNC_DIR, ignore_errors=True)
    runs = {}
    for fused in (True, False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        runner = async_runner(cfg, params, data32, 32, acfg, trace, fused)
        t0 = time.perf_counter()
        saved, flush_s, at_save, save_s = None, [], None, None
        while runner.version < ASYNC_FLUSHES:
            v = runner.version
            runner.step()
            if runner.version > v:
                torch.cuda.synchronize()
                flush_s.append(time.perf_counter() - t0)
            if fused and saved is None and _async_save_point(runner):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                at_save = ops.launch_counts()
                saved = ck.save_async_state(str(ASYNC_DIR), runner)
                save_s = time.perf_counter() - t1
                t0 += save_s  # the save is not part of the run's time
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[fused] = dict(runner=runner, wall_s=wall, flush_at_s=flush_s,
                           counts=ops.launch_counts(), saved=saved, at_save=at_save,
                           save_s=save_s, max_memory_allocated=torch.cuda.max_memory_allocated())
        runner.trained.clear()  # trained but never uploaded: free the card
    fr, ur = runs[True]["runner"], runs[False]["runner"]
    require(runs[True]["saved"] is not None, "the fused run passed no mid-buffer save point")
    require(schedule(fr.history) == schedule(ur.history),
            f"fused and unfused async schedules differ: {fr.history} {ur.history}")
    for hf, hu in zip(fr.history, ur.history):
        require(math.isfinite(hf["loss"]) and abs(hf["loss"] - hu["loss"]) < 1e-3,
                f"fused and unfused async losses differ: {hf} {hu}")
    steps = fused_gate(fr.storage, ur.storage)
    n_comp = sum(is_compressed(v) for _, v in tree_items(fr.storage))
    for fused in (True, False):
        want = plain_async_counts(32, acfg, trace, fused, ASYNC_FLUSHES)
        got = runs[fused]["counts"]
        require(set(got) == set(want), f"straggler fused={fused}: {got}, plain {want}")
        require_launches(got, f"straggler fused={fused}",
                         **{k.split(".")[0]: v for k, v in want.items()})
    require(runs[True]["counts"]["fused_aggregate.cuda"] == n_comp * ASYNC_FLUSHES,
            f"fused_aggregate launched {runs[True]['counts']}")
    counts["straggler_fused"], counts["straggler_unfused"] = (runs[True]["counts"],
                                                              runs[False]["counts"])
    last = fr.history[-1]
    for fused, r in runs.items():
        fl = r["flush_at_s"]
        print(f"  straggler {'fused  ' if fused else 'unfused'}: 32 clients, buffer 8, "
              f"{ASYNC_FLUSHES} flushes in {r['wall_s']:.2f} s (flushes at "
              f"{[round(x, 2) for x in fl]} s; {r['wall_s'] / ASYNC_FLUSHES * 1e3:.1f} ms per "
              f"flush), peak {r['max_memory_allocated'] / 1e9:.2f} GB, launches {r['counts']}")
    print(f"  straggler: {last['completed'] / last['clock']:.4f} updates per virtual second "
          f"({last['completed']} in {last['clock']} virtual s), stale_fraction "
          f"{last['stale_fraction']:.4f}, dropped_fraction {last['dropped_fraction']:.4f}, "
          f"staleness max {[h['staleness_max'] for h in fr.history]}; fused vs unfused: "
          f"max |d| {steps[0]:.3g} steps, mean {steps[1]:.3g} steps")
    for h in fr.history:
        print(f"    {h}")
    del ur, runs[False]

    # mid-buffer resume: a fresh runner restores the fused run's checkpoint
    # and runs to the same flush, the same bits
    torch.cuda.empty_cache()
    path = Path(runs[True]["saved"])
    ckpt_bytes = sum(f.stat().st_size for f in path.iterdir())
    fresh = async_runner(cfg, params, data32, 32, acfg, trace, fused=True)
    t0 = time.perf_counter()
    extra = ck.restore_async_state(str(path), fresh)
    restore_s = time.perf_counter() - t0
    require(extra["buffer_meta"] and extra["trained_losses"], "the save was not mid-buffer")
    ops.reset_launch_counts()
    fresh.run_until(flushes=ASYNC_FLUSHES - fresh.version)
    counts["resumed"] = ops.launch_counts()
    want = {k: v - runs[True]["at_save"].get(k, 0) for k, v in runs[True]["counts"].items()}
    require({k: v for k, v in counts["resumed"].items() if v}
            == {k: v for k, v in want.items() if v},
            f"resumed launches {counts['resumed']}, the straight run's after the save {want}")
    require(trees_bit_equal(fresh.storage, fr.storage), "the resumed storage differs")
    require(fresh.history == fr.history, "the resumed history differs")
    require(fresh.stats.snapshot() == fr.stats.snapshot(), "the resumed ledger differs")
    print(f"  resume: {path.name} after {extra['events_processed']} events (buffer "
          f"{len(extra['buffer_meta'])}, trained cache {len(extra['trained_losses'])}, versions "
          f"{extra['version_keys']}), {ckpt_bytes:,} bytes, saved in {runs[True]['save_s']:.2f} s, "
          f"restored in {restore_s:.2f} s; flush {ASYNC_FLUSHES}: the same bits; launches "
          f"{counts['resumed']}")
    del fresh, fr, runs
    shutil.rmtree(ASYNC_DIR, ignore_errors=True)
    total = {}
    for c in counts.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return dict(counts=total, by_part=counts, history=last)


def phase_async_card_vs_cpu() -> tuple:
    """The straggler run cut to 2 layers at full width, 16 clients, buffer 4,
    2 fused flushes, on the card (kernels) and on the CPU (plain versions):
    the same schedule and ledger, the same launches, trees within phase 7's
    gate."""
    cfg = dataclasses.replace(TRAIN_CFG, n_layers=2)
    params = conformer.init(prng.PRNGKey(4), cfg, "cuda")
    acfg, trace = straggler(16, 4)
    out = {}
    for dev in ("cuda", "cpu"):
        ops.reset_launch_counts()
        runner = async_runner(cfg, tree_map(lambda x, d=dev: x.to(d), params),
                              async_data(cfg, 16, dev), 16, acfg, trace, fused=True)
        runner.run_until(flushes=2)
        got = ops.launch_counts()
        backend = "cuda" if dev == "cuda" else "ref"
        require(got and all(k.endswith(backend) for k in got), f"async on {dev}: {got}")
        out[dev] = (runner, got)
    (card, cc), (host, hc) = out["cuda"], out["cpu"]
    require(cc == as_cuda(hc), f"async launches: card {cc}, CPU {hc}")
    require(schedule(card.history) == schedule(host.history), "card and CPU async schedules differ")
    for a, b in zip(card.history, host.history):
        require(abs(a["loss"] - b["loss"]) < 1e-3, f"card and CPU async losses differ: {a} {b}")
    gap = tree_gap(card.storage, tree_map(lambda x: x.to("cuda"), host.storage))
    require(gap[0] <= TREE_MAX and gap[1] <= TREE_MEAN, f"card and CPU async trees differ: {gap}")
    print(f"  async, 2 layers at full width, 16 clients, buffer 4, 2 fused flushes: schedules "
          f"and ledgers equal, losses card {[h['loss'] for h in card.history]} / CPU "
          f"{[h['loss'] for h in host.history]}, trees max |d| {gap[0]:.3g}, mean |d| "
          f"{gap[1]:.3g}; launches {cc}")
    return gap


# ---------------------------------------------------------------------------
# 15. the FL sessions at full width, card against CPU
# ---------------------------------------------------------------------------


class Expect:
    """The launches a stretch of the session protocol should take, from the
    number of compressed leaves and the codec operations it ran: per
    ``compress_params`` one ``quantize_stats`` a compressed leaf, per
    ``decompress_tree`` one ``dequantize`` a compressed leaf; per payload
    encoded one ``pack`` a compressed leaf, and one more for each leaf sent
    as a delta with changed codes; per payload decoded one ``unpack`` for
    each compressed leaf sent whole or as a delta with changed codes (the
    payload's manifest says which)."""

    def __init__(self, n_comp: int, backend: str):
        self.n, self.backend, self.want = n_comp, backend, {}

    def _add(self, op: str, k: int) -> None:
        key = f"{op}.{self.backend}"
        self.want[key] = self.want.get(key, 0) + k

    def compress(self) -> None:
        self._add("quantize_stats", self.n)

    def decompress(self) -> None:
        self._add("dequantize", self.n)

    def _leaves(self, blob: bytes):
        leaves = [m for m in codecs.payload_manifest(blob) if m["kind"] == "omc"]
        require(len(leaves) == self.n, f"a payload holds {len(leaves)} compressed leaves")
        return leaves, sum(1 for m in leaves if m["mode"] == "delta" and m["nnz"])

    def encode(self, blob: bytes) -> None:
        leaves, changed = self._leaves(blob)
        self._add("pack", len(leaves) + changed)

    def decode(self, blob: bytes) -> None:
        leaves, changed = self._leaves(blob)
        self._add("unpack", sum(1 for m in leaves if m["mode"] == "full") + changed)

    def take(self) -> dict:
        out, self.want = {k: v for k, v in self.want.items() if v}, {}
        return out


def session_sgd(cfg, device):
    """``FLClient.train_fn``: SESSION_STEPS plain SGD steps at SESSION_LR on
    the client's frame batches (8 x 48 frames), autograd through
    ``conformer.loss``."""
    task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=48, num_clients=8,
                           device=str(device))
    def train_fn(params, cid, r):
        batches = [task.batch(cid, r, s, 8) for s in range(SESSION_STEPS)]
        return simulate.sgd_steps(conformer, cfg, params, batches, SESSION_LR)[0]

    return train_fn


def session_exact(params, cid, r):
    """A bit-exact client update: the first leaf times 0.9 (conformer's is the
    raw ``blocks/attn_bias``), as the reference's session tests train."""
    first = next(tree_items(params))[0]
    return tree_map_with_path(lambda path, x: x * 0.9 if path == first else x, params)


def session_protocol(cfg, device: str, init_params, train_fn) -> dict:
    """Phase 15's protocol on ``device``: SESSION_ROUNDS sync rounds of
    ``FLSession``/``FLClient`` at cohort 4 of 8, then a second session with
    ``enable_async(4, decay=0.5)``: 8 check-ins and 2 flushes, client 4's
    upload stale by one version, client 0 back with ``held_version=0`` for a
    delta.  Counters are zeroed around each part (the init, each round, each
    flush's stretch) and held to :class:`Expect`; returns the record."""
    backend = "cuda" if device == "cuda" else "ref"
    omc = OMCConfig.parse(FMT.name)
    specs = conformer.param_specs(cfg)
    rec = dict(parts={}, ids=[], lengths=[], round_s=[], flush_s=[])

    def part(name: str, ex: Expect, t0: float) -> float:
        session.sync(torch.device(device))
        got, want = ops.launch_counts(), ex.take()
        require(got == want, f"sessions {name} on {device}: launched {got}, predicted {want}")
        rec["parts"][name] = got
        return time.perf_counter() - t0

    # the sync cycle
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sess = FLSession(conformer, cfg, omc, plan=SESSION_PLAN, init_params=init_params,
                     device=device)
    n_comp = sum(is_compressed(v) for _, v in tree_items(sess.storage))
    ex = Expect(n_comp, backend)
    ex.compress()
    part("init", ex, t0)
    clients = {c: FLClient(c, conformer, cfg, omc, train_fn, device=device)
               for c in range(SESSION_PLAN.num_clients)}
    prev_full = None
    for r in range(SESSION_ROUNDS):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        ticket = sess.begin_round()
        ex.encode(ticket.payload)
        if ticket.delta_payload is not None:
            ex.encode(ticket.delta_payload)
        ups = []
        for cid in ticket.client_ids:
            took = ticket.issued_delta
            up = clients[cid].run_round(ticket)
            ex.decode(ticket.delta_payload if ticket.issued_delta > took else ticket.payload)
            ex.decompress()
            ex.compress()
            ex.encode(up)
            sess.ingest(cid, up)
            ex.decode(up)
            ex.decompress()
            ups.append(len(up))
        m = sess.close_round()
        ex.decompress()
        ex.compress()
        rec["round_s"].append(part(f"round {r}", ex, t0))
        require(m["reports"] == m["invited"] == SESSION_PLAN.cohort_size, f"round {r}: {m}")
        rec["ids"].append(ticket.client_ids)
        rec["lengths"].append([len(ticket.payload), len(ticket.delta_payload or b"")] + ups)
        if ticket.delta_payload is not None:
            require(len(ticket.delta_payload) < len(ticket.payload),
                    f"round {r}: delta {len(ticket.delta_payload)} B, full {len(ticket.payload)} B")
            base, _ = codecs.decode_payload(prev_full, device=device)
            got, _ = codecs.decode_payload(ticket.delta_payload, base=base, device=device)
            want, _ = codecs.decode_payload(ticket.payload, device=device)
            require(trees_bit_equal(got, want), f"round {r}: the delta decodes to other bits")
            del base, got, want
        prev_full = ticket.payload
    t = sess.traffic
    require(t["down_bytes"] <= 0.60 * t["down_fp32_bytes"], f"download over 60% of f32: {t}")
    wire, state_rep = codecs.payload_bytes_report(sess.storage), state_bytes_report(sess.storage)
    require(wire["wire_bytes"] == state_rep["packed_bytes"], f"codec {wire}, state {state_rep}")
    rec.update(traffic=dict(t), wire=wire, session=sess, full=prev_full, delta=ticket.delta_payload,
               n_comp=n_comp)

    # the async protocol, on a second session
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    asess = FLSession(conformer, cfg, omc, plan=SESSION_PLAN, init_params=init_params,
                      device=device)
    ex.compress()
    part("async init", ex, t0)
    asess.enable_async(SESSION_BUFFER, decay=SESSION_DECAY)
    held, versions, ups, up_lengths = {}, [], {}, []
    cached = set()  # versions whose full payload the session has encoded

    def checkin(cid, held_version=None):
        ticket = asess.checkin(cid, held_version=held_version)
        if ticket.server_version not in cached:
            cached.add(ticket.server_version)
            ex.encode(ticket.payload)
        if ticket.delta_payload is not None:
            ex.encode(ticket.delta_payload)
        return ticket

    def work(cid, ticket):
        """The loopback client: decode (a delta when it holds the base), train,
        upload a delta against what it received."""
        h = held.get(cid)
        blob = ticket.payload_for(held_digest=codecs.tree_digest(h) if h is not None else 0)
        tree, _ = codecs.decode_payload(blob, base=h, device=device)
        ex.decode(blob)
        held[cid] = tree
        trained = train_fn(decompress_tree(tree), cid, ticket.server_version)
        ex.decompress()
        ups[cid] = codecs.encode_payload(compress_params(trained, specs, omc), base=tree,
                                         round_index=ticket.server_version)
        ex.compress()
        ex.encode(ups[cid])

    def ingest(cid):
        v, up = asess.server_version, ups.pop(cid)
        asess.ingest_async(cid, up)
        ex.decode(up)
        ex.decompress()
        if asess.server_version > v:  # flushed: decode the storage, re-compress
            ex.decompress()
            ex.compress()
        versions.append(asess.server_version)
        up_lengths.append(len(up))

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tickets = {c: checkin(c) for c in range(5)}
    for c in range(5):
        work(c, tickets[c])
    for c in range(4):
        ingest(c)
    rec["flush_s"].append(part("flush 1", ex, t0))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tickets = {5: checkin(5), 6: checkin(6), 0: checkin(0, held_version=0)}
    for c in (5, 6, 0):
        work(c, tickets[c])
    for c in (4, 5, 6, 0):  # client 4 downloaded version 0: stale by one
        ingest(c)
    rec["flush_s"].append(part("flush 2", ex, t0))
    require(versions == [0, 0, 0, 1, 1, 1, 1, 2], f"server versions after each ingest {versions}")
    require([h["version"] for h in asess.async_history] == [1, 2]
            and [h["buffer"] for h in asess.async_history] == [SESSION_BUFFER] * 2
            and [h["staleness_max"] for h in asess.async_history] == [0, 1],
            f"async history {asess.async_history}")
    back = tickets[0]
    require(back.took_delta and len(back.delta_payload) < len(back.payload),
            "the returning client took no smaller delta")
    require(trees_bit_equal(held[0], asess._version_storages[1]),
            "the returning client's delta decodes to other bits than version 1's state")
    require(sorted(asess._version_storages) == [0, 1, 2], f"kept {sorted(asess._version_storages)}")
    rec.update(versions=versions, history=asess.async_history, async_traffic=dict(asess.traffic),
               async_lengths=up_lengths + [len(back.payload), len(back.delta_payload)],
               async_session=asess)
    return rec


def _sum_counts(parts) -> dict:
    total = {}
    for c in parts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_sessions() -> dict:
    """The FL sessions at full width on the card, the demo, then the same
    protocol at 2 layers, card against CPU."""
    cfg = TRAIN_CFG
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = conformer.init(prng.PRNGKey(0), cfg, "cuda")
    t_phase = time.perf_counter()
    rec = session_protocol(cfg, "cuda", params, session_sgd(cfg, "cuda"))
    del params
    sess, full = rec["session"], rec["full"]
    enc_ms = min_ms(lambda: sess.server_payload())
    dec_ms = min_ms(lambda: codecs.decode_payload(full, device="cuda"))
    peak = torch.cuda.max_memory_allocated()
    fp32 = rec["wire"]["fp32_bytes"]
    t = rec["traffic"]
    for name, c in rec["parts"].items():
        print(f"    {name}: {c}")
    print(f"  sessions, conformer_s ({rec['wire']['num_params']:,} parameters, {rec['n_comp']} "
          f"compressed leaves), S1E3M7, cohort 4 of 8, {SESSION_STEPS} SGD steps a client: "
          f"{[round(x, 2) for x in rec['round_s']]} s per sync round, "
          f"{[round(x, 2) for x in rec['flush_s']]} s per flush (check-ins, client work and "
          f"ingests included); launches as predicted from the payloads")
    print(f"  payloads: full {len(full):,} B ({len(full) / fp32:.2%} of f32 {fp32:,} B), "
          f"round-1 delta {len(rec['delta']):,} B ({len(rec['delta']) / fp32:.2%}); encode "
          f"{enc_ms:.1f} ms, decode {dec_ms:.1f} ms (full payload, best of 3); traffic {t}, down "
          f"{t['down_bytes'] / t['down_fp32_bytes']:.2%} / up {t['up_bytes'] / t['up_fp32_bytes']:.2%}"
          f" of f32; async {rec['history']}; peak {peak / 1e9:.2f} GB")
    del rec["session"], rec["async_session"], sess
    torch.cuda.empty_cache()

    # the loopback demo at its default configuration: the served transformer
    # after hot_swap runs dequant_matmul
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    require(demo.main(["--device", "cuda", "--quiet"]) == 0, "the demo failed")
    torch.cuda.synchronize()
    demo_counts = ops.launch_counts()
    require_launches(demo_counts, "demo", quantize_stats=None, dequantize=None, pack=None,
                     unpack=None, dequant_matmul=None)
    print(f"  demo (default config, 8 rounds): {time.perf_counter() - t0:.1f} s, launches "
          f"{demo_counts}")
    main_s = time.perf_counter() - t_phase

    # card against CPU at 2 layers: the same protocol with a bit-exact client
    # update, from a model already on the format's grid (the codes then stay
    # put when the storage is decoded and re-compressed)
    cut = dataclasses.replace(cfg, n_layers=2)
    t0 = time.perf_counter()
    grid = decompress_tree(compress_params(conformer.init(prng.PRNGKey(4), cut, "cuda"),
                                           conformer.param_specs(cut), OMCConfig.parse(FMT.name)))
    side = {}
    for dev in ("cuda", "cpu"):
        side[dev] = session_protocol(cut, dev, tree_map(lambda x, d=dev: x.to(d), grid),
                                     session_exact)
    card, host = side["cuda"], side["cpu"]
    for k in ("ids", "lengths", "traffic", "versions", "history", "async_traffic",
              "async_lengths"):
        require(card[k] == host[k], f"card and CPU sessions differ in {k}: {card[k]} {host[k]}")
    for name, c in card["parts"].items():
        require(c == as_cuda(host["parts"][name]), f"{name}: card {c}, CPU {host['parts'][name]}")
        for op in ("quantize_stats", "dequantize"):  # pack/unpack follow the data
            require(rec["parts"][name].get(f"{op}.cuda") == c.get(f"{op}.cuda"),
                    f"{name}: {op} at full width {rec['parts'][name]}, at 2 layers {c}")
    gaps = {}
    for which in ("session", "async_session"):
        a, b = card[which].storage, host[which].storage
        same = sum(bool(torch.equal(x.codes.cpu(), y.codes)) for (_, x), (_, y)
                   in zip(tree_items(a), tree_items(b)) if is_compressed(x))
        gaps[which] = (same, tree_gap(a, tree_map(lambda x: x.to("cuda"), b)))
        require(same == card["n_comp"] or (gaps[which][1][0] <= TREE_MAX
                                             and gaps[which][1][1] <= TREE_MEAN),
                f"{which}: card and CPU storages differ {gaps[which]}")
    print(f"  card against CPU, 2 layers at full width, bit-exact update: cohorts "
          f"{card['ids']}, payload lengths {card['lengths']} and {card['async_lengths']}, traffic "
          f"and async history equal; codes equal in {gaps['session'][0]} / "
          f"{gaps['async_session'][0]} of {card['n_comp']} leaves (sync / async), trees max |d| "
          f"{gaps['session'][1][0]:.3g} / {gaps['async_session'][1][0]:.3g}; launches equal "
          f"({card['parts']}); {time.perf_counter() - t0:.1f} s")
    del card["session"], card["async_session"], host["session"], host["async_session"]
    return dict(counts=_sum_counts(list(rec["parts"].values()) + [demo_counts]),
                round_s=rec["round_s"], flush_s=rec["flush_s"], encode_ms=enc_ms,
                decode_ms=dec_ms, peak=peak, main_s=main_s)


# ---------------------------------------------------------------------------
# 16. the non-IID path at full width
# ---------------------------------------------------------------------------


def _recording(data_fn, calls: list):
    """``data_fn`` that records each ``(client, round, step)`` it draws."""

    def fn(c, r, s):
        calls.append((int(c), int(r), int(s)))
        return data_fn(c, r, s)

    return fn


def _round_windows(marks: list) -> list:
    """The launches between consecutive launch counts in ``marks``."""
    return [{k: b.get(k, 0) - a.get(k, 0) for k in b if b.get(k, 0) != a.get(k, 0)}
            for a, b in zip(marks, marks[1:])]


def noniid_batches_card_vs_cpu(name: str, card_fn, host_fn, calls) -> dict:
    """The cohort clients' batches, drawn again on the card and on the CPU:
    sources equal, frames within 4 ulp of max(|x|, 1), labels flipped in at
    most 1 in 1000 frames."""
    flips = total = 0
    worst = 0.0
    for c, r, st in calls:
        src_card, src_host = card_fn.sources(c, r, st).cpu(), host_fn.sources(c, r, st)
        require(torch.equal(src_card, src_host), f"{name}: client {c} sources card vs CPU")
        b, h = card_fn(c, r, st), host_fn(c, r, st)
        ulp = torch.finfo(torch.float32).eps * h["frames"].abs().clamp(min=1.0)
        worst = max(worst, ((b["frames"].cpu() - h["frames"]).abs() / ulp).max().item())
        flips += int((b["labels"].cpu() != h["labels"]).sum())
        total += h["labels"].numel()
    print(f"  {name}: {len(calls)} batches card vs CPU: sources equal, frames within "
          f"{worst:.2f} ulp, {flips} of {total} labels differ")
    require(worst <= 4.0, f"{name}: frames differ by {worst} ulp")
    require(flips * 1000 <= total, f"{name}: {flips} of {total} labels differ")
    return dict(worst_ulp=worst, flips=flips, total=total)


def phase_noniid() -> dict:
    """Phase 7's configuration on partitioned data: Dirichlet(0.1) for
    ``NONIID_ROUNDS`` fused rounds, 2 shards a client for 1, 2 domains for 1
    (1 local step); then the two examples on the card."""
    cfg = TRAIN_CFG
    omc = OMCConfig.parse(FMT.name)
    spec = engine.CohortSpec(CohortPlan(num_clients=16, cohort_size=COHORT, failure_rate=0.25))
    key = prng.PRNGKey(0)
    params = conformer.init(key, cfg, "cuda")
    task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=256, num_clients=16)
    host_task = dataclasses.replace(task, device="cpu")
    parts, counts = {}, []

    def train(name, part, rounds, local_steps=2):
        card_fn = make_partitioned_batch_fn(task, part, 8)
        calls = []
        sim = simulate.SimConfig(local_steps=local_steps, client_lr=0.1)
        ops.reset_launch_counts()
        marks = [{}]  # the counts after each round (its log line); round 0's window
        t0 = time.perf_counter()  # also holds the storage's initial compress
        _, history = engine.run_training_vectorized(
            conformer, cfg, omc, sim, spec, _recording(card_fn, calls), key, rounds,
            init_params=params, fused_agg=True, eval_every=1,
            log=lambda _: marks.append(ops.launch_counts()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = ops.launch_counts()
        windows = _round_windows(marks)
        require(len(windows) == rounds, f"{name}: {len(windows)} rounds drew batches")
        require_launches(got, name, fused_aggregate=13 * rounds)
        for i, w in enumerate(windows):
            require_launches(w, f"{name} round {i}", quantize_stats=None, dequantize=None)
        for h in history:
            require(math.isfinite(h["loss"]) and 0 < h["loss"] < 20, f"{name}: bad loss {h}")
        clients = sorted({c for c, _, _ in calls})
        print(f"  {name}: {rounds} fused round(s) of {local_steps} local step(s), "
              f"{wall / rounds:.2f} s a round, clients {clients}, launches {got}")
        for h in history:
            print(f"    {h}")
        counts.append(got)
        host_fn = make_partitioned_batch_fn(host_task, part, 8)
        parts[name] = dict(round_s=wall / rounds, history=history, counts=got, clients=clients,
                           batches=noniid_batches_card_vs_cpu(name, card_fn, host_fn, calls))
        return card_fn, host_fn, calls, clients

    # (a) Dirichlet(0.1): real skew, the same draws and rejection paths on both sides
    part = DirichletPartition(alpha=0.1)
    card_fn, _, _, clients = train("dirichlet(0.1)", part, NONIID_ROUNDS)
    shares = {c: card_fn.weights(c).max().item() for c in clients}
    mean_share = sum(shares.values()) / len(shares)
    print(f"  dirichlet(0.1): largest source share per sampled client "
          f"{ {c: round(v, 3) for c, v in shares.items()} }, mean {mean_share:.3f} "
          f"(IID: {1 / 16:.4f})")
    require(mean_share >= 0.4, f"dirichlet(0.1): mean largest share {mean_share:.3f} < 0.4")
    iter_diff = 0
    for c in clients:
        kc = prng.fold_in(prng.fold_in(prng.PRNGKey(task.seed + 7), part.seed), c)
        alpha = torch.full((16,), part.alpha)
        w_card, it_card = prng.dirichlet(kc, alpha, device="cuda", return_iterations=True)
        w_host, it_host = prng.dirichlet(kc, alpha, device="cpu", return_iterations=True)
        iter_diff += int((it_card.cpu() != it_host).sum())
        require(torch.equal(w_card.cpu(), card_fn.weights(c).cpu()), "weights cache")
    print(f"  dirichlet(0.1): the sampled clients' dirichlet iterations differ card vs CPU in "
          f"{iter_diff} of {16 * len(clients)} entries")
    require(iter_diff == 0, f"dirichlet: {iter_diff} entries took another rejection path")

    # (b) 2 shards a client: every source drawn is one of the client's two
    card_fn, _, calls, _ = train("shards(2)", ShardPartition(2), 1)
    for c, r, st in calls:
        held = set(torch.nonzero(card_fn.weights(c)).flatten().tolist())
        drawn = set(card_fn.sources(c, r, st).tolist())
        require(len(held) == 2 and drawn <= held, f"shards: client {c} drew {drawn} of {held}")

    # (c) 2 domains: odd clients are labelled by domain 1's probe, even by domain 0's
    card_fn, _, calls, _ = train("domains(2)", DomainPartition(2), 1, local_steps=1)
    c_ = task.context
    routed = 0
    for c, r, st in calls:
        b = card_fn(c, r, st)
        padded = torch.nn.functional.pad(b["frames"], (0, 0, c_, c_))
        windows = torch.cat([padded[:, i:i + task.seq_len] for i in range(2 * c_ + 1)], -1)
        want = torch.argmax(windows @ task.probe(c % 2), dim=-1).to(torch.int32)
        other = torch.argmax(windows @ task.probe(1 - c % 2), dim=-1).to(torch.int32)
        require(torch.equal(b["labels"], want), f"domains: client {c}'s labels")
        require(not torch.equal(b["labels"], other), f"domains: client {c} not routed")
        routed += c % 2
    print(f"  domains(2): {len(calls)} batches labelled by their domain's probe, {routed} of "
          f"them by domain 1's")

    # (d) the examples, on the card
    examples = {}
    for script, argv in (("cohort_scenarios", ["--smoke"]), ("quickstart", [])):
        spec_ = importlib.util.spec_from_file_location(f"_ex_{script}",
                                                       ROOT / "examples_torch" / f"{script}.py")
        mod = importlib.util.module_from_spec(spec_)
        spec_.loader.exec_module(mod)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc = mod.main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        got = ops.launch_counts()
        examples[script] = dict(s=time.perf_counter() - t0, counts=got)
        print(f"  examples_torch/{script}.py {' '.join(argv)}: {examples[script]['s']:.1f} s, "
              f"launches {got}")
        require(rc == 0, f"{script} exited {rc}")
        require_launches(got, script, quantize_stats=None, dequantize=None)
        counts.append(got)
    return dict(parts=parts, mean_share=mean_share, examples=examples,
                counts=_sum_counts(counts))


def min_ms(fn, reps: int = 3) -> float:
    """Best wall ms of ``fn()`` over ``reps`` calls, the card synchronized."""
    best = math.inf
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def kernel_line(kernels: dict, counts_by_path: dict) -> dict:
    primary = dict(quantize_stats=list(EMBED), dequantize=list(MLP_SLICE), pack=list(EMBED),
                   unpack=list(EMBED), quantize=[COHORT, *TRAIN_LEAF],
                   fused_aggregate=list(TRAIN_LEAF), dequant_matmul=list(DECODE_W1))
    keys = ("shape", "path", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "f32_simt_bound_ms", "matmul_alone_ms", "max_err_over_bound", "variant", "weights")
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


def timed(number: int, name: str, fn, *args):
    """Run one phase and print its wall seconds on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    print(f"phase {number} ({name}): {time.perf_counter() - t0:.1f} s")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    t0 = time.perf_counter()
    timed(1, "environment and build", phase_environment)
    kernels = timed(2, "kernels against their plain versions", phase_kernels)
    served = timed(3, "serve qwen2.5-3b", phase_serve)
    timed(4, "qwen2.5-3b card against CPU", phase_card_vs_cpu, served["session"])
    del served["session"]
    served_g = timed(5, "serve recurrentgemma-2b", phase_serve_griffin)
    timed(6, "recurrentgemma-2b card against CPU", phase_griffin_card_vs_cpu, served_g["session"])
    del served_g["session"]
    torch.cuda.empty_cache()
    trained = timed(7, "train conformer_s", phase_train)
    timed(8, "train card against CPU", phase_train_card_vs_cpu)
    tables = timed(9, "paper tables", phase_tables)
    timed(10, "tables' loop card against CPU", phase_tables_card_vs_cpu)
    driver = timed(11, "training driver", phase_train_driver)
    timed(12, "round card against CPU", phase_round_card_vs_cpu)
    torch.cuda.empty_cache()
    asynced = timed(13, "async runtime", phase_async)
    torch.cuda.empty_cache()
    timed(14, "async card against CPU", phase_async_card_vs_cpu)
    torch.cuda.empty_cache()
    sessions = timed(15, "FL sessions at full width", phase_sessions)
    torch.cuda.empty_cache()
    noniid = timed(16, "non-IID path at full width", phase_noniid)
    print(f"all phases: {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernel_line(kernels, {"serve": served["report"]["launch_counts"],
                                           "serve_griffin": served_g["report"]["launch_counts"],
                                           "train": trained["counts"],
                                           "tables": tables["counts"],
                                           "train_driver": driver["counts"],
                                           "async": asynced["counts"],
                                           "sessions": sessions["counts"],
                                           "noniid": noniid["counts"]})))
    print(json.dumps(dict(ok=True, device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                                               count=torch.cuda.device_count()))))


if __name__ == "__main__":
    main()
