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
     embedding [151936, 2048] in S1E3M7, timed, and ``quantize_stats`` and
     ``dequantize`` on recurrentgemma-2b's tied embedding [256000, 2560],
     the plain versions on blocks of 32,768 rows, ``dequantize`` timed), at
     the training path's shapes
     (``quantize_stats`` and ``quantize`` on a transport stack [8, 17, 512,
     2048], one (s, b) per client and layer, and a storage leaf [17, 512,
     2048], all timed; ``fused_aggregate`` on conformer_s leaves [17, 512, 2048]
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
     [2560, 256] and [128, 7680]x[7680, 2560]; the zoo's: mixtral's experts
     [8, 4096]x[4096, 14336], [8, 14336]x[14336, 4096] and [40, 4096]x[4096,
     14336], internvl2's [4, 896]x[896, 128] and [4, 896]x[896, 4864], h2o's
     [4, 3840]x[3840, 960], qwen1.5-110b's [4, 8192]x[8192, 49152]; phase
     22's: xlstm-350m's [4, 1024]x[1024, 4096], [4, 2048]x[2048, 2048],
     [4, 2048]x[2048, 8] (w_if, N = 8), [4, 2048]x[2048, 1024], and at
     prefill [128, 2048]x[2048, 8] and [128, 1024]x[1024, 4096];
     seamless-m4t-medium's [4, 1024]x[1024, 1024], [4, 4096]x[4096, 1024]
     and its encoder's over 4 x 192 frames, [768, 1024]x[1024, 1024],
     [768, 1024]x[1024, 4096], [768, 4096]x[4096, 1024]), odd tails [3, 37]x[37, 53]
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
     S1E3M7 and in S1E4M14 (the training driver's format), and at an
     sLSTM block's ``r_gates`` [4, 256, 1024] (phase 22).
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
  4. Card against CPU at full width: the served storage tree cut to 1 layer
     and to the first 32,768 rows of the tied embedding's codes (its
     per-variable (s, b) unchanged, prompts drawn below 32,768), prefill and
     1 decode step on the card (kernels), twice (the same bits both times),
     and on the CPU over the tree decoded once by the plain version (the
     same bits as the plain ``dequant_matmul``, which decodes the weight at
     every forward pass and multiplies); the largest logit difference must be
     <= 1e-3.  The CPU side decodes the tied head in plain PyTorch once a
     forward pass, which at 151,936 rows was most of the phase: phase 3
     still serves the full vocabulary on the card, and phase 2 holds B1, B2
     and B4 on the full [151936, 2048] head.  The sha256 of each step's logits, on the
     card and on the CPU, is printed, so that runs can be compared.
  5. Serve recurrentgemma-2b (griffin) at full width the same way (26 layers,
     d 2560, vocab 256,000; batch 4, prompt 32, 16 new tokens, with the wire
     roundtrip): 200 ``dequant_matmul`` and 20 ``dequantize`` launches per
     forward pass, no plain version run, payload ratio <= 0.35.
  6. Card against CPU for griffin: its storage cut to 3 layers (the first
     super block: two recurrent blocks and one attention block) at full width and to
     phase 4's 32,768-row vocabulary (the 256,000-row head decoded on the
     CPU once a forward pass was the script's largest cost; phase 5 serves
     the full vocabulary on the card, and phase 2 holds B1 and B2 on the
     full [256000, 2560] head), prefill and 1 decode step, as in
     phase 4.
  7. Federated training at full width through the engine
     (``engine.run_training_vectorized``, ``engine.run_round_vectorized``):
     conformer_s (17 layers, d 512), random weights from a seed on the card,
     the synthetic frame task (80-dim frames, 1024 classes, 256 frames, 16
     clients, batch 8), cohort 8 of 16 with failure rate 0.25, 2 local steps
     at lr 0.1, S1E3M7 with PVT and PPQ 0.9.  After a warm round: 3 rounds
     with ``fused_agg=True``, 3 unfused rounds from the same seed (ledgers
     byte-equal, trees within max 6e-3 and mean 1e-3), and one fused round
     with PVT off (Table 4's "quant" row).  Every engine run trains each
     tier's clients batched (``client_chunk=None``, one forward and backward
     pass for the cohort); from the first round's storage one fused round
     on that default and one at ``client_chunk=1`` (the clients one after
     another): ledgers equal, losses within 1e-3, trees within the gate
     above, the same launches, each with its ms and peak printed.  Counters
     are zeroed around each run: ``fused_aggregate`` 13 launches per fused
     round, ``quantize`` in the PVT-off run, ``quantize_stats`` and
     ``dequantize`` in every run, no plain version anywhere.
  8. Card against CPU for training: the same configuration cut to 1 layer
     at full width, cohort 4, 1 fused round of 1 local step, on the card
     (kernels) and on the CPU (plain versions): ledgers equal, trees within
     the gate of phase 7.
  9. The paper tables at full width: each of ``benchmarks_torch``'s six
     scripts (Tables 1-4, Figs. 3-4) runs its ``run()`` on conformer_s' full
     config through ``simulate.run_training``, for ``TABLE_ROUNDS`` round
     (one timed round a row after the process's warm round; Table 2:
     ``TABLE2_ROUNDS``, the fewest at which its assertion that S1E2M3 beats
     before-adaptation holds here), each table printed as the
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
     on conformer_s cut to 1 layer at full width (S1E4M14, a frame batch
     8 x 48; 1 round) and on qwen2.5-3b cut to 1 layer at full width (d
     2048, tied head) and to the LM batch's vocabulary of 4096 (S1E3M7, a
     4 x 32 batch of the non-IID LM task, ``make_lm_task(vocab=4096,
     seq_len=32, iid=False)``, drawn on the card; 1 round: the CPU side's
     plain versions on the full 151,936-row embedding were half the phase,
     and phase 3 still serves the full vocabulary), from one state each, on the card
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
     clients, ``buffer_goal`` 8, ``FixedTrace``, decay 0, 1 flush) against
     1 round of the engine at cohort 8 of 8: ledgers equal the engine's,
     trees within phase 7's gate.  A straggler run (32 clients,
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
 14. Card against CPU for the async runtime: the straggler run cut to 1
     layer at full width, 16 clients, ``buffer_goal`` 4, 2 fused flushes,
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
     for ``DEMO_ROUNDS`` round (the fewest at which its ``ServeSession``,
     snapshotted before the last round, hot-swaps that round's delta and
     serves through ``dequant_matmul``).  Last, the
     same protocol cut to 1 layer at full width, with a bit-exact client
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
     ``DirichletPartition(alpha=0.1)`` for 1 round of 2 local steps: losses
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
 17. The compression strategies at full width (``repro_torch.compress``),
     under deterministic algorithms.  Wire: for each of ``default_zoo()``
     (omc S1E3M7 and S1E4M3, top-k 0.1, ternary, pipeline) and top-k with
     S1E3M7 values, ``encode_tree`` -> ``encode_payload`` ->
     ``decode_payload`` -> ``decode_tree`` over conformer_s at full width
     (random weights, seed 0): ``tree_wire_bytes`` = the payload body = the
     plan where the strategy has one; the decoded frame encodes to the same
     bytes (and, for top-k, the decoded tree re-encodes to the same
     leaves); B1-B4 launches in each step exactly as predicted
     from the 13 selected leaves; bytes over f32 and encode / decode ms
     printed.  Card against CPU on four of those leaves (conv_pw1,
     [17, 512, 1024], and the three smallest): the CPU's plain versions
     write the card's frame byte for byte (top-k with S1E3M7 values, the
     pipeline); ternary's frame parsed on the CPU holds the card's codes
     and scales, and the CPU's own ``ternarize`` is held to ROADMAP C18;
     every frame decoded on the CPU is the card's decode bit for bit.
     Training: the engine at phase 7's configuration, unfused: strategy
     omc against None, 1 round each, the same bits; top-k 0.1 with error
     feedback 1 round, ternary with it 1 round, the pipeline 1 round
     without the ledger (None's and top-k's rounds are also phase 19's
     references); each with its s a round, peak memory,
     ``ef_bytes`` and residual norm, its launches equal to the same run's
     on the CPU at the smoke config, and its ledger equal to the
     reference's rule restated.  Card against CPU at 2 layers (batches of
     2 x 32 frames, 1 local step): the loop under top-k + EF for 2 rounds,
     cohort 2 of 4 (the second from the CPU's state on both sides): trees
     within phase 7's gate, residuals within 1e-6 but for at most 32
     threshold flips a round (ROADMAP C17), each kept on one side and
     dropped on the other by that side's own rule on its recorded
     compensated update, the dropped magnitude within 640 ulp of its
     side's threshold; the async runtime under top-k + EF on the
     degenerate trace (2 clients, buffer 2, 2 flushes), a mid-buffer
     checkpoint resumed to the same bits, card against CPU within the gates.
 18. Telemetry (``repro_torch.obs``) and the sessions' strategy uploads at
     full width, under deterministic algorithms.  The engine at phase 7's
     configuration, unfused and fused: 1 round with ``obs=None``, then 1
     from the same state with a live ``Obs`` writing into ``build/obs/``:
     storage the same bits, history and ledger the same bytes, one
     ``round`` record with a finite ``update_norm``, ``qerr_norm`` and the
     13 ``qerr/*`` only unfused; B1 and B5 launches unchanged and B2 up by
     exactly the bundle's two decodes (old and new storage) of each
     compressed leaf a round.  The summed ``round`` wall spans are printed
     beside the host clock around ``synchronize``, and the peak beside phase
     7's.  One sync round of ``FLSession``/``FLClient`` at cohort 4 of 8
     (phase 15's clients) under top-k 0.1 with S1E3M7 values and error
     feedback: each upload's body the strategy plan's bytes, each part's
     launches as predicted from the 13 leaves (B3 and B4 at each upload's
     encode, B4 ``unpack`` at each decode), every residual on the card.  The
     async runtime (4 clients, buffer 2, the straggler knobs), 2 flushes: a
     ``client_round`` virtual span per check-in, a ``flush`` record with its
     staleness list per flush.  Every handle is flushed to JSONL and
     Perfetto files (their bytes printed) and ``python -m
     repro_torch.obs.report`` renders the unfused engine's, exit 0.
 19. The sharded population runtime at full width (``repro_torch.scale``),
     phase 7's model, task and configuration.  (a) ``run_training_sharded``
     at cohort 8 of 16, 2 shards, capacity 3, one round unfused and one
     fused, against the engine's round from the same key (phase 17's
     strategy-None round and phase 7's warm round): the same invited and
     alive clients (the store's counters), ledgers to the byte, trees within
     6e-3 max and 1e-4 / 1e-3 mean (the reference's gates), no
     ``fused_aggregate`` (the root is unfused, as in the reference).  (b)
     One round each at populations 1,000 and 100,000, cohort 16, capacity 4,
     4 shards, through one stream and one root function, (a)'s rounds its
     warm-up: the ``StreamLedger`` bound the same, ``max_memory_allocated``
     within 1.5x; s a round, updates/s, the bound, the peak and the host
     counter bytes printed.  (c) Top-k 0.1 with error feedback at population
     16, cohort 8, capacity 4, under deterministic algorithms: an f32
     ``PopulationStore`` against phase 17's dense-EF engine round within
     1e-5 max and 1e-6 mean; a packed S1E3M7 store, its words for one chunk
     of its three smallest leaves bit for bit the plain versions' encode of the
     same rows on the CPU, ``(s, b)`` within 1e-5 relative, its decode the
     plain decode's bits, at rest under half of f32; peaks printed beside the
     dense engine's.  (d) That packed store through
     ``save_population_state`` into a fresh store, bit-equal; a
     population-backed ``AsyncRunner`` at 2 layers (4 clients, buffer 2, one
     flush) with the dict-backed run's counters, history and storage, its
     checkpoint stamped with the layout.  (e) ``run_serve_under_swap`` on the
     demo's transformer: 2 payloads, 4 queries each, 2 swaps, the stall
     under 10x, ``dequant_matmul`` launched.  Counters are zeroed around each
     part's runs (not its comparisons): B1, B2, B4 and B6 launched.
 20. Launch and roofline on the card (``repro_torch.launch``,
     ``roofline``).  (a) For qwen2.5-3b and recurrentgemma-2b, phases 3 and
     5's served storage (kept in host memory since phases 4 and 6) against
     ``launch.dryrun``'s meta build of the same cell (``make_host_mesh(1,
     1)``, S1E3M7, batch 4, the serve path's f32 decode state of 4 x (32 +
     16) slots): every leaf's shape and dtype equal, the predicted
     ``argument_size_in_bytes`` equal to the nbytes of the storage, decode
     state and token batch put back on the card, exactly, with
     ``memory_allocated`` around placing them printed beside; the meta
     trace of one decode step calls each kernel as often as a forward pass
     launched it in phase 3 or 5.  The same for mixtral-8x7b at phase 21
     (a)'s depth (``--set n_layers=4``), against phase 21 (a)'s storage,
     still on the card (phase 20 runs after phase 21): B6 112 and B2 6 a
     decode step.  (b) ``benchmarks_torch/kernels_micro.py``
     in card mode, in process: B3, B2 and B6 at the reference's codec sizes,
     B4 at six widths and B5 at cohort 8 in S1E3M7 and S1E4M14, each row's
     ms (CUDA events, L2 flushed), ``bound_ms`` and moved over bound, every
     moved/bound <= 2.  (c) ``PopulationStore.device_ef`` on phase 19 (c)'s
     packed S1E3M7 store: ``make_population_mesh(num_shards=4)`` clamps to
     the one card, and every row is the same bits as ``gather_ef``'s.
     Counters are zeroed around (b) and (c) (not (c)'s comparison).
 21. The decoder-only zoo at full width (run before phase 20, which reads
     its mixtral storage): ``serve.run`` on each arch at full width and the
     depth ``ZOO_DEPTH`` gives with its reason (printed), S1E3M7, batch 4,
     prompt 32: (a) mixtral-8x7b (4 of 32 layers, 8 experts top-2) with the
     wire roundtrip (payload ratio <= 0.35, swap bit-identical), 16 tokens;
     (b) mixtral cut to 1 layer, prompt 8, 2 decode steps, on the card twice
     (the same bits) and on the CPU over the codes decoded by the plain
     version: routing flips counted, each a near-tie (k-th and (k+1)-th
     router probabilities within ``ROUTE_GAP`` relative on both sides, C26),
     capacity flips counted, logits within 1e-3 on the rows that never
     flipped; then ``ep_partitions=2`` on the card over the same codes
     resliced, within ``EP_GAP`` (1e-4) of each step's largest logit of
     ``ep_partitions=1``'s (f32 reassociation of w2's K = 14,336 sum); (c) dbrx-132b (2 of 40
     layers, 16 experts top-4), 16 tokens; (d) internvl2-1b at full depth
     with 1,024 patches, 16 tokens (the reference's cache sizing, C28), then
     prefill(n) + decode against prefill(n + 1) within 5e-4 with a cache
     that holds the whole stream; (e) h2o-danube-3-4b at full depth, 16
     tokens (no wire roundtrip: (a) runs the wire), then at 2 layers, batch 1, a prompt of 4,128
     tokens through its 4,096-slot ring, prefill(n) + decode against
     prefill(n + 1) within 5e-4; (f) mistral-nemo-12b (2 of 40 layers) and
     qwen1.5-110b (1 of 80), 4 tokens.  Counters are zeroed around each
     serve: ``dequant_matmul`` and ``dequantize`` launch exactly
     ``zoo_formula``'s count a forward pass (a MoE layer: 4 + 3 per stored
     expert, and its router decoded), which a CPU dry run of the smoke
     widths at 1 and 2 layers predicts, scaled to the served depth; no plain
     version.  Prints each part's init, prefill and decode ms a token and
     peak memory, and its seconds.
 22. The last families at full width (after phase 20): ``serve.run`` at
     full width and full depth, S1E3M7, batch 4, prompt 32, 16 new tokens:
     (a) xlstm-350m (24 layers: 3 super blocks of 7 mLSTM blocks and 1
     sLSTM block, d 1024) with the wire roundtrip, and phase 20's meta
     prediction for its tree (every leaf's shape, dtype and bytes; the
     decode step's kernel calls); (b) seamless-m4t-medium (12 + 12 layers,
     d 1024, vocab 256,256, 192 random frames, the untied head decoded each
     step).  Counters are zeroed around each serve: ``dequant_matmul`` and
     ``dequantize`` launch exactly the formula's count, which a CPU dry run
     at the smoke widths with the full layout predicts (xlstm 132 and 26 a
     forward pass; seamless 192 and 2 a prefill, 96 and 2 a decode step);
     no plain version; then prefill(n) + decode against prefill(n + 1) on
     the card within 5e-4.  (c) Card against CPU at full width on phase
     4's vocabulary cut, prefill and 1 decode step within 1e-3: xlstm at 8
     layers (one super block), seamless at 1 + 1 layers.  (d)
     ``launch.train.run`` on recurrentgemma-2b and on xlstm-350m at full
     width and depth (S1E4M14, batch 8, 48 tokens, the LM task), 2
     rounds: each round's ``quantize_stats`` and ``dequantize`` launches
     are the storage tree's formula (an encode and a decode a compressed
     leaf, two decodes a stacked entry, the embedding's rows and the tied
     head), which the same driver on the CPU at the smoke config launches
     on its own tree; ms a round and peak printed.  (e) griffin's round
     card against CPU at one super block (3 layers) and phase 12's
     4,096-token vocabulary, within phase 12's gates.
 23. The reference's last scripts on the card.  (a)
     ``examples_torch/serve_omc.py`` as a subprocess (qwen2.5-3b's smoke
     config, batch 4, prompt 32, 16 tokens, S1E3M7): exit 0 (the CLI raises
     on non-finite logits), its 4 x 16 tokens in the vocabulary; then its
     arguments with ``--wire-roundtrip`` through ``serve.run`` in process:
     the same tokens, the swap bit-identical, B6 and B2 a forward pass the
     count a CPU dry run at the smoke config predicts.  (b)
     ``examples_torch/train_100m.py --full --rounds 6 --ckpt-every 3`` as a
     subprocess into ``build/scripts/``: conformer_s at 103,535,104
     parameters in S1E3M7, finite losses, ``ckpt_3`` and ``ckpt_6``, each
     round's B1 and B2 the storage tree's formula (13 and 389), which the
     driver on the CPU at the smoke config launches on its own tree; the
     same command again resumes at round 6, trains no round, and reports
     the same bytes and checkpoint.  (c)
     ``examples_torch/compress_strategies.py`` and
     ``train_under_strategy.py`` at their default arguments, in process on
     the card and as subprocesses on the CPU: every wire-byte figure the
     same (neither side runs ``--smoke``: the rounds' bytes depend on the
     round index and the pipeline's DEFLATE on the data), losses finite.
     (d) ``benchmarks_torch/async_scale.py --reference-row`` as a
     subprocess on the card: the virtual-clock and byte columns of the row
     it writes equal the reference's row, the losses within an absolute
     2e-3 of it (``REFERENCE_ROW_*``, measured on the reference's code).
     (e) every ``BENCHES`` and ``TOOLS`` module of ``benchmarks_torch.run``
     imports, and every ``ARTIFACTS`` file is in the tree and records its
     card.  The subprocesses of (a)-(d) start just before phase 22 (e),
     which times nothing, and run beside it (each takes seconds to reach
     the card and is host-bound); they load phase 1's library: no kernel
     is built again.  Counters are zeroed around each part's in-process
     runs; (b)'s launches are its reports', (d)'s are not counted.

Each phase's wall seconds are printed on a line of their own.  It then
prints one JSON line describing each kernel (``launches_by_path`` has the
main paths of phases 3, 5, 7, 9, 11, 13, 15-23) and, last, the
line
``{"ok": true, "device": {...}}``.  f32 matmuls run in full f32: TF32 is
switched off for matmuls and cuDNN.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import hashlib
import io
import importlib
import importlib.util
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import compress, scale  # noqa: E402
from repro_torch.api import codecs, demo, session  # noqa: E402
from repro_torch.api.session import FLClient, FLSession, ServeSession  # noqa: E402
from repro_torch.configs import (conformer_s, mixtral_8x7b, qwen2_5_3b,  # noqa: E402
                                 recurrentgemma_2b, seamless_m4t_medium, xlstm_350m)
from repro_torch.core import omc as omc_lib  # noqa: E402
from repro_torch.core import packing, prng  # noqa: E402
from repro_torch.core.formats import SIGNED_TWIN, FloatFormat, narrow, widen  # noqa: E402
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
from repro_torch.core.partial import ppq_masks_batch  # noqa: E402
from repro_torch.federated import cohort, materialize, traces  # noqa: E402
from repro_torch.federated.cohort import CohortPlan  # noqa: E402
from repro_torch import checkpoint as ck  # noqa: E402
from repro_torch.federated.round import make_round_fn  # noqa: E402
from repro_torch.federated.state import (compress_params, init_state,  # noqa: E402
                                         n_stack_axes, state_bytes_report)
from repro_torch.configs.shapes import Shape  # noqa: E402
from repro_torch.kernels import agg  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import specs as launch_specs  # noqa: E402
from repro_torch.kernels import bitpack as bk  # noqa: E402
from repro_torch.kernels import dequant_matmul as dm  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import quantize as qk  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.models import conformer, encdec, griffin, moe, transformer, xlstm  # noqa: E402
from repro_torch.models.registry import get_family  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.obs import report as obs_report  # noqa: E402
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
GHEAD = (GCFG.vocab, GCFG.d_model)  # griffin's tied embedding, its head at every forward pass
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
# phase 21's products at the zoo's widths: mixtral's experts at decode (M = 8,
# the capacity of a batch of 4) and prefill (M = 40 for 4 x 32), internvl2's
# wk (N = 128) and w1 (K = 896), h2o's wk (head_dim 120: N = 960) and
# qwen1.5-110b's w1 (K = 8192, N = 49,152)
MIXTRAL = mixtral_8x7b.config()
DM_ZOO = [(8, MIXTRAL.d_model, MIXTRAL.d_ff), (8, MIXTRAL.d_ff, MIXTRAL.d_model),
          (40, MIXTRAL.d_model, MIXTRAL.d_ff), (4, 896, 128), (4, 896, 4864), (4, 3840, 960),
          (4, 8192, 49152)]
# phase 22's products: xlstm-350m's w_up / w_gates (and seamless' w1), wq /
# wk / wv, w_if (N = 8), w_down at decode and w_if and w_up at prefill (M =
# 128); seamless' attention matrices and w2 at decode, and its encoder's at
# M = 4 x 192 = 768 frames, on the tile path
XCFG = xlstm_350m.config()
SCFG = seamless_m4t_medium.config()
DM_LAST = [(4, XCFG.d_model, 2 * XCFG.d_inner), (4, XCFG.d_inner, XCFG.d_inner),
           (4, XCFG.d_inner, 2 * XCFG.n_heads), (4, XCFG.d_inner, XCFG.d_model),
           (PREFILL, XCFG.d_inner, 2 * XCFG.n_heads), (PREFILL, XCFG.d_model, 2 * XCFG.d_inner),
           (4, SCFG.d_model, SCFG.d_model), (4, SCFG.d_ff, SCFG.d_model),
           (768, SCFG.d_model, SCFG.d_model), (768, SCFG.d_model, SCFG.d_ff),
           (768, SCFG.d_ff, SCFG.d_model)]
RGATES = (XCFG.n_heads, XCFG.s_head_dim, 4 * XCFG.s_head_dim)  # an sLSTM block's r_gates
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
TABLE_ROUNDS = 1  # BENCH_ROUNDS of phase 9's scripts (a row times its one round after the warm one)
TABLE2_ROUNDS = 1  # the fewest at which Table 2's S1E2M3 beats before-adaptation here
DRIVER_ROUNDS, DRIVER_CKPT_EVERY = 6, 3  # phase 11: the driver's run and its checkpoints
DRIVER_DIR = ROOT / "build" / "train_driver"
ASYNC_DIR = ROOT / "build" / "async"  # phase 13's mid-buffer checkpoint
ASYNC_SIM = simulate.SimConfig(local_steps=1, client_lr=0.1)
ASYNC_FLUSHES = 3  # phase 13's straggler run
DEGENERATE_FLUSHES = 1  # phase 13's degenerate trace against the engine
ASYNC_STALENESS = np.asarray([0, 0, 1, 1, 2, 3, 5, 8], np.float32)  # phase 2's K = 8 buffer
SESSION_PLAN = CohortPlan(num_clients=8, cohort_size=4)  # phase 15
# phase 15's card against CPU: the protocol at one layer (at two, the CPU's
# plain codec on every payload took most of the phase)
SESSION_CUT_LAYERS = 1
# phase 15's demo: one round still snapshots a ServeSession and hot-swaps the
# round's delta into it, which then serves through dequant_matmul
DEMO_ROUNDS = 1
SESSION_ROUNDS, SESSION_BUFFER, SESSION_DECAY = 2, 4, 0.5
SESSION_STEPS, SESSION_LR = 2, 0.05  # each client's local SGD
NONIID_ROUNDS = 1  # phase 16's Dirichlet run (2 before phase 21 came)
CUT_VOCAB = 32_768  # phases 4 and 6: the tied heads' first rows, card against CPU
LM_VOCAB = 4096  # phase 12's non-IID LM batch, and its qwen round's vocabulary
OBS_DIR = ROOT / "build" / "obs"  # phase 18's JSONL and Perfetto files
OBS_ROUNDS = 1  # phase 18: engine rounds a run, obs off and on (2 before phase 21 came)
OBS_SESSION_STRATEGY = dict(name="topk", density=0.1, value_fmt=FMT)  # phase 18's uploads
OBS_ASYNC_CLIENTS, OBS_ASYNC_BUFFER = 4, 2  # phase 18's async run (8 and 4 took 4.9 s)


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` inside (phases 13, 17, 18
    and 19's part (c) compare runs bit for bit); the previous setting after."""
    was = torch.are_deterministic_algorithms_enabled()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


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


def row_blocks(t: torch.Tensor, rows):
    """Indices of blocks of ``rows`` leading rows covering ``t`` (the whole
    of it without ``rows``): a head too large for the plain versions' int64
    math in one piece is held against them block by block."""
    if rows is None:
        return [...]
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def check_quantize_stats(x, fmt, batch_axes, timer=None, block_rows=None):
    """With ``block_rows`` (``batch_axes`` 0), the kernel runs on the whole
    tensor and the plain version on blocks of rows: codes block by block,
    the sums against the blocks' sums added in float64."""
    codes, sums = qk.quantize_stats(x, fmt, batch_axes)
    torch.cuda.synchronize()
    require(block_rows is None or batch_axes == 0, "blocks need one (s, b) per variable")
    rsums = 0
    for k in row_blocks(x, block_rows):
        rcodes, part = ref.ref_quantize_stats(x[k], fmt, batch_axes)
        require(bit_equal(codes[k], rcodes),
                f"quantize_stats codes differ {fmt.name} {tuple(x.shape)} rows {k}")
        rsums = rsums + (part if block_rows is None else part.double())
        del rcodes
    rsums = rsums.to(sums.dtype)
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


def check_dequantize(codes, fmt, timer=None, batch_axes=0, block_rows=None):
    """With ``batch_axes``, one (s, b) pair per stacked entry, shaped
    ``[*stack, 1, ...]`` as a stacked ``CompressedVariable`` holds them.  The
    launch's variant must be the one ``kernel_variant`` states, and a second
    launch, after one on all-NaN codes, must give the same bits.  With
    ``block_rows`` (``batch_axes`` 0) the plain version runs on blocks of
    rows, and its time is the blocks' times added."""
    require(block_rows is None or batch_axes == 0, "blocks need one (s, b) per variable")
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
    blocks = row_blocks(codes, block_rows)
    err = 0.0
    for k in blocks:
        want = ref.ref_dequantize(codes[k], fmt, s, b)
        require(bit_equal(got[k], want), f"dequantize differs {fmt.name} {tuple(codes.shape)} "
                f"rows {k}")
        fin = torch.isfinite(want)
        if fin.any():
            err = max(err, (got[k][fin] - want[fin]).abs().max().item())
        del want, fin
    require(bit_equal(got, again), f"dequantize {fmt.name} {tuple(codes.shape)}: two launches "
            f"differ")
    del got, again
    out = dict(shape=list(codes.shape), fmt=fmt.name, variant=DQ_VARIANTS[plan["variant"]],
               vec=plan["vec"], same_bits=True, max_abs_err=err)
    if timer:
        out.update(ms=timer(lambda: qk.dequantize(codes, fmt, s, b)),
                   device_ms=timer.device(lambda: qk.dequantize(codes, fmt, s, b)),
                   plain_ms=sum(timer(lambda k=k: ref.ref_dequantize(codes[k], fmt, s, b))
                                for k in blocks),
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
    # the serve paths' shapes, timed: qwen's w1 slice and tied head
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
    # griffin's tied head, which phase 5 decodes whole at every forward pass
    # (phases 4 and 6 compare card and CPU on vocabulary cuts): B1, and B2
    # timed, the plain versions on blocks of rows (whole, their int64 math
    # does not fit in the card's memory)
    x = _inputs(GHEAD, FMT, seed=GHEAD[0], specials=False)
    codes, r = check_quantize_stats(x, FMT, 0, block_rows=CUT_VOCAB)
    del x
    results["quantize_stats"].append(r)
    results["dequantize"].append(check_dequantize(codes, FMT, timer, block_rows=CUT_VOCAB))
    del codes
    torch.cuda.empty_cache()
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
    # an sLSTM block's r_gates [4, 256, 1024] (phase 22 decodes one a block)
    x = _inputs(RGATES, FMT, seed=RGATES[1], specials=False)
    codes = qk.quantize_stats(x, FMT)[0]
    del x
    results["dequantize"].append(check_dequantize(codes, FMT, timer))
    del codes
    torch.cuda.empty_cache()
    stacked = check_stacked_mlp(timer)
    torch.cuda.empty_cache()
    # the training path's shapes, timed: transport stack (the fused encode's
    # B1, one (s, b) per client and layer) and storage leaf (one per layer)
    for shape in ((COHORT,) + TRAIN_LEAF, TRAIN_LEAF):
        x = _inputs(shape, FMT, seed=len(shape), specials=False)
        codes, r = check_quantize_stats(x, FMT, len(shape) - 2, timer)
        results["quantize_stats"].append(r)
        results["quantize"].append(check_quantize(x, FMT, codes, timer))
        del x, codes
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
    for mkn in DM_SERVE + DM_PREFILL_SPLIT_K + DM_ZOO + DM_LAST:
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


def require_per_forward(counts: dict, run: str, forwards: int, per_forward: dict,
                        kernels=SERVE_KERNELS) -> None:
    """Exact launches of each op for ``forwards`` forward passes, every one
    of ``kernels`` launched, and no plain version run."""
    require(not any(k.endswith(".ref") for k in counts), f"{run}: a plain version ran: {counts}")
    for op in kernels:
        require(counts.get(f"{op}.cuda", 0) > 0, f"{run}: {op} kernel never launched")
    for op, n in per_forward.items():
        got = counts.get(f"{op}.cuda", 0)
        require(got == n * forwards, f"{run}: {op} launched {got} times in {forwards} forward "
                f"passes, expected {n} per pass: {counts}")


def serve_full_width(arch: str, more_batches: int, *, layers=None, roundtrip: bool = True,
                     gen: int = 16) -> dict:
    """``serve.run`` at full width (the first ``layers`` layers where given)
    with the wire roundtrip, batch 4, prompt 32, ``gen`` new tokens, then
    ``more_batches`` request batches through ``ServeSession.generate``;
    counters zeroed just before, read just after."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    report = serve.run(serve.parse_args(
        ["--arch", arch, "--fmt", FMT.name, "--batch", "4", "--prompt-len", "32", "--gen",
         str(gen), "--quiet"] + (["--wire-roundtrip"] if roundtrip else [])
        + (["--layers", str(layers)] if layers else [])))
    sess = report.pop("session")
    if roundtrip:
        require(report["swap_bit_identical"],
                f"{arch}: hot-swapped tree differs from the one encoded")
        require(report["payload_ratio"] <= 0.35,
                f"{arch}: payload ratio {report['payload_ratio']}")
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
    report.update(forward_passes=1 + gen + 16 * more_batches, more_batches_ms=more_ms,
                  max_memory_allocated=torch.cuda.max_memory_allocated(),
                  launch_counts=ops.launch_counts(), serve_stats=sess.serve_stats())
    report.pop("tokens")
    for k in ("n_layers", "n_enc_layers", "n_dec_layers", "num_params", "init_ms", "payload_bytes", "fp32_bytes",
              "payload_ratio", "roundtrip_ms", "prefill_ms", "decode_ms_per_token", "tok_per_s",
              "more_batches_ms", "max_memory_allocated", "forward_passes", "launch_counts"):
        if k in report:
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


def card_vs_cpu(run: str, family, cfg, cut, decode_steps: int = 2, frames: int = 0) -> float:
    """Prefill and ``decode_steps`` decode steps of ``cut`` on the card
    (kernels) and on the CPU over ``cut`` decoded once as the plain version
    decodes (:func:`plain_decoded`): each step's logits are the plain path's
    bits, without decoding every weight again at every step.  The largest
    logit difference must be <= 1e-3.  ``frames``: an encoder-decoder's
    random frames, the decode state holding that many."""
    gpu = ServeSession(family, cfg, cut)
    cpu = ServeSession(family, cfg, plain_decoded(tree_map(lambda x: x.to("cpu"), cut)))
    g = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (4, 32), generator=g, device="cuda")
    extra = dict(frames=torch.randn((4, frames, cfg.d_model), generator=g, device="cuda")
                 ) if frames else {}

    def steps(sess, tokens, pick=None):
        """The logits of prefill and the decode steps, on the host; the
        decode steps take ``pick``'s tokens (else their own argmax)."""
        batch = dict(tokens=tokens, **{k: v.to(tokens.device) for k, v in extra.items()})
        c, lg = sess.prefill(batch, sess.init_cache(4, frames or 64))
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


def plain_decoded(tree):
    """A storage tree on the host with each compressed leaf decoded by the
    plain version, bit for bit: ``ref_dequantize`` of every code of the
    format as a table, each leaf's codes gathered from it, then its affine
    (``s·x + b``, multiply then add, as the plain version applies it).  A
    slice of each leaf is held to ``ref_dequantize`` itself.  The plain
    ``dequant_matmul`` decodes its weight this way and multiplies, so a
    forward pass over this tree gives the plain path's bits; decoding
    through the table takes seconds where the plain decode's int64 bit math
    took minutes at mixtral's width."""

    def leaf(v):
        if not is_compressed(v):
            return v
        every = narrow(torch.arange(1 << v.fmt.bits), v.codes.dtype)
        table = ref.ref_dequantize(every, v.fmt)
        out = table[widen(v.codes)] * v.s + v.b
        cut = v.codes[..., :8]
        require(bit_equal(out[..., :8], ref.ref_dequantize(cut, v.fmt, v.s, v.b)),
                f"the table decode of a {v.fmt.name} leaf {tuple(v.codes.shape)} is not the "
                f"plain version's")
        return out

    return tree_map(leaf, tree)


def digest(x: torch.Tensor) -> str:
    """The first 12 hex digits of the sha256 of a tensor's bytes."""
    return hashlib.sha256(x.contiguous().numpy().tobytes()).hexdigest()[:12]


def vocab_cut(embed, rows: int = CUT_VOCAB):
    """The first ``rows`` rows of a compressed tied embedding's codes, its
    per-variable (s, b) unchanged: the same model restricted to those
    tokens, its head a ``rows``-entry slice of the full one."""
    require(is_compressed(embed) and embed.s.numel() == 1, "the embedding's (s, b) per variable")
    return type(embed)(embed.codes[:rows], embed.s, embed.b, embed.fmt)


def phase_card_vs_cpu(sess: ServeSession) -> float:
    st = sess.storage
    cut = dict(embed=vocab_cut(st["embed"]), final_norm=st["final_norm"],
               blocks={k: v[:1] for k, v in st["blocks"].items()})
    # one decode step on a vocabulary cut (the first 32,768 rows of the tied
    # head; prompts drawn below it): the CPU side decodes the tied head in
    # plain PyTorch once a forward pass, and at 151,936 rows that was the
    # phase's cost.  The full vocabulary is still served on the card in
    # phase 3, and phase 2 holds B2 (and B1, B4) against the plain versions
    # on the full [151936, 2048] head
    # one layer: a second ran the same block's code again on the CPU, and
    # phase 3 serves all 36 on the card
    return card_vs_cpu(f"qwen2.5-3b, 1 layer, vocab {CUT_VOCAB:,}", transformer,
                       dataclasses.replace(CFG, n_layers=1, vocab=CUT_VOCAB), cut,
                       decode_steps=1)


def phase_griffin_card_vs_cpu(sess: ServeSession) -> float:
    """The first super block (two recurrent blocks and one attention block):
    3 layers at full width."""
    st = sess.storage
    cut = dict(embed=vocab_cut(st["embed"]), final_norm=st["final_norm"],
               super_blocks={part: {k: v[:1] for k, v in leaves.items()}
                             for part, leaves in st["super_blocks"].items()})
    cfg3 = dataclasses.replace(GCFG, n_layers=3, vocab=CUT_VOCAB)
    require((cfg3.n_super, cfg3.n_extra_rec) == (1, 0), "griffin cut")
    # one decode step on phase 4's vocabulary cut: the CPU side decoded the
    # 256,000 x 2560 tied head in plain PyTorch once a forward pass, the
    # script's largest cost.  Phase 5 serves the full vocabulary on the
    # card, and phase 2 holds B1 and B2 against the plain versions on the
    # full [256000, 2560] head.  The two extra recurrent blocks ran the
    # recurrent block's code again on the CPU: 3 layers hold each block kind
    # once, and phase 5 runs all 26 on the card
    return card_vs_cpu(f"recurrentgemma-2b, 3 layers, vocab {CUT_VOCAB:,}", griffin, cfg3, cut,
                       decode_steps=1)


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
    # warm round: allocator, cuBLAS handles, lazy kernel loading; phase 19
    # holds its sharded fused round against it
    warm = train(1, True)
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
    axis = client_axis_rounds(cfg, omc, sim, spec, data_fn, key, params, specs)

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
    for chunk, r in axis["runs"].items():
        print(f"  client_chunk={chunk}: fused round {r['ms']:.1f} ms, peak "
              f"{r['max_memory_allocated'] / 1e9:.2f} GB, {r['metrics']}, launches {r['counts']}")
    print(f"  batched vs client_chunk=1: trees max |d| {axis['gap'][0]:.3g}, mean |d| "
          f"{axis['gap'][1]:.3g}")
    print(f"  pvt=False fused round {quant['round_s'] * 1e3:.1f} ms (with storage compress), "
          f"{metrics_q}, launches {quant['counts']}")
    counts = {}
    for c in (runs[True]["counts"], runs[False]["counts"], quant["counts"],
              *(r["counts"] for r in axis["runs"].values())):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return dict(n_params=n_params, warm_s=warm_s, gap=gap, quant=quant, counts=counts, warm=warm,
                client_axis={str(k): {x: y for x, y in r.items() if x != "storage"}
                             for k, r in axis["runs"].items()},
                runs={("fused" if f else "unfused"): {k: v for k, v in r.items() if k != "storage"}
                      for f, r in runs.items()})


def client_axis_rounds(cfg, omc, sim, spec, data_fn, key, params, specs) -> dict:
    """One fused round from the same storage on the batched default (each
    tier's clients in one call) and on the serial path (``client_chunk=1``):
    ledgers equal, losses within 1e-3, trees within the gate, the same
    launches; ms a round and peak memory of each."""
    storage = compress_params(params, specs, omc)
    table = accounting.build_wire_table(params, specs, omc)
    # the one-client body's shapes once, untimed (the batched ones are warm
    # from the runs above): cuBLAS picks and loads its kernels per shape
    simulate.make_client_fn(conformer, cfg, specs, omc, sim)(
        decompress_tree(storage), simulate.client_batches(data_fn, 0, 0, sim.local_steps), 0, 0)
    runs = {}
    for chunk in (None, 1):
        spec_c = dataclasses.replace(spec, client_chunk=chunk)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        new, metrics = engine.run_round_vectorized(conformer, cfg, specs, omc, sim, storage,
                                                   data_fn, spec_c, 0, prng.fold_in(key, 0xC047),
                                                   wire_table=table, fused_agg=True)
        torch.cuda.synchronize()
        runs[chunk] = dict(storage=new, metrics=metrics, ms=(time.perf_counter() - t0) * 1e3,
                           counts=ops.launch_counts(),
                           max_memory_allocated=torch.cuda.max_memory_allocated())
    a, b = runs[None], runs[1]
    keys = ("cohort", "dropped", "down_bytes", "up_bytes")
    require({k: a["metrics"][k] for k in keys} == {k: b["metrics"][k] for k in keys},
            f"batched and serial ledgers differ: {a['metrics']} {b['metrics']}")
    require(abs(a["metrics"]["loss"] - b["metrics"]["loss"]) < 1e-3,
            f"batched and serial losses differ: {a['metrics']} {b['metrics']}")
    require(a["counts"] == b["counts"], f"launches differ: {a['counts']} {b['counts']}")
    require_launches(a["counts"], "batched", fused_aggregate=13, quantize_stats=None,
                     dequantize=None)
    gap = tree_gap(a["storage"], b["storage"])
    require(gap[0] <= TREE_MAX and gap[1] <= TREE_MEAN, f"batched vs serial trees differ: {gap}")
    return dict(runs=runs, gap=gap)


def phase_train_card_vs_cpu() -> tuple:
    cfg = dataclasses.replace(TRAIN_CFG, n_layers=1)  # phase 7 trains all 17 on the card
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
    print(f"  card vs CPU, 1 layer at full width, 1 round: losses "
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
    ccfg = dataclasses.replace(TRAIN_CFG, n_layers=1)  # phase 11 trains all 17 on the card
    task = make_frame_task(d_in=ccfg.d_in, n_classes=ccfg.n_classes, seq_len=48, num_clients=16)
    conf = round_card_vs_cpu("conformer_s", conformer, ccfg, "S1E4M14", task.batch(0, 0, 0, 8), 1)
    torch.cuda.empty_cache()
    # 1 layer at full width (d 2048) and the LM batch's vocabulary of 4096:
    # the CPU side's plain versions on the full 151,936 x 2048 tied
    # embedding took half the phase (the qwen round 120.1 s at the full
    # vocabulary against 57.3 s at 4096 on an H100 80GB HBM3 at 700 W); the
    # full vocabulary serves in phase 3 and is held in phase 2.  A second
    # layer ran the same block's code again on the CPU; phase 11's driver
    # trains every layer of conformer_s on the card
    qcfg = dataclasses.replace(CFG, n_layers=1, vocab=LM_VOCAB)
    lm = lm_batch_card_vs_cpu()
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
        task = make_lm_task(vocab=LM_VOCAB, seq_len=32, iid=False, device=dev)
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
    with deterministic_algorithms():
        return _phase_async()


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
    runner.run_until(flushes=DEGENERATE_FLUSHES)
    counts["degenerate"] = ops.launch_counts()
    want = plain_async_counts(8, acfg, trace, False, DEGENERATE_FLUSHES)
    require_launches(counts["degenerate"], "async degenerate", fused_aggregate=0,
                     **{k.split(".")[0]: v for k, v in want.items()})
    require(set(counts["degenerate"]) == set(want), f"degenerate: {counts['degenerate']} {want}")
    est, ehist = engine.run_training_vectorized(conformer, cfg, omc, ASYNC_SIM,
                                                engine.CohortSpec(CohortPlan(8, 8)), data8,
                                                prng.PRNGKey(0), DEGENERATE_FLUSHES,
                                                init_params=params)
    for i, h in enumerate(runner.history):
        require(h["buffer"] == 8 and h["staleness_max"] == 0, f"degenerate flush {h}")
        for k in ("down_bytes", "up_bytes"):
            require(h[k] == sum(e[k] for e in ehist[:i + 1]), f"degenerate {k}: {h} {ehist}")
        require(abs(h["loss"] - ehist[i]["loss"]) < 1e-3, f"degenerate losses {h} {ehist[i]}")
    gap = tree_gap(runner.storage, est)
    require(gap[0] <= TREE_MAX and gap[1] <= TREE_MEAN, f"degenerate vs engine trees {gap}")
    print(f"  degenerate trace, 8 clients, {DEGENERATE_FLUSHES} flush: ledgers equal the "
          f"engine's summed "
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
    """The straggler run cut to 1 layer at full width, 16 clients, buffer 4,
    2 fused flushes, on the card (kernels) and on the CPU (plain versions):
    the same schedule and ledger, the same launches, trees within phase 7's
    gate.  A second layer ran the same block's code again on the CPU
    (phase 13 runs all 17 on the card)."""
    cfg = dataclasses.replace(TRAIN_CFG, n_layers=1)
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
    print(f"  async, 1 layer at full width, 16 clients, buffer 4, 2 fused flushes: schedules "
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
    protocol at 1 layer, card against CPU."""
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
    require(demo.main(["--device", "cuda", "--quiet", "--rounds", str(DEMO_ROUNDS)]) == 0,
            "the demo failed")
    torch.cuda.synchronize()
    demo_counts = ops.launch_counts()
    require_launches(demo_counts, "demo", quantize_stats=None, dequantize=None, pack=None,
                     unpack=None, dequant_matmul=None)
    print(f"  demo (default config, {DEMO_ROUNDS} round): {time.perf_counter() - t0:.1f} s, launches "
          f"{demo_counts}")
    main_s = time.perf_counter() - t_phase

    # card against CPU at SESSION_CUT_LAYERS: the same protocol, a bit-exact client
    # update, from a model already on the format's grid (the codes then stay
    # put when the storage is decoded and re-compressed)
    cut = dataclasses.replace(cfg, n_layers=SESSION_CUT_LAYERS)
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
    print(f"  card against CPU, {SESSION_CUT_LAYERS} layer at full width, bit-exact update: cohorts "
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


# ---------------------------------------------------------------------------
# 17. the compression strategies at full width
# ---------------------------------------------------------------------------


STRAT_SIM = simulate.SimConfig(local_steps=2, client_lr=0.1)  # phase 7's
STRAT_PLAN = CohortPlan(num_clients=16, cohort_size=COHORT, failure_rate=0.25)
STRAT_DIR = ROOT / "build" / "strategies"  # the async runner's mid-buffer checkpoint
RESID = 1e-6  # the reference's residual gate (tests/test_train_strategy.py)
# a large selected leaf ([17, 512, 1024]) and the three smallest, whose
# frames the CPU's plain versions must write byte for byte
CHECK_LEAVES = ("blocks/conv_pw1", "blocks/conv_dw", "in_proj", "out_proj")
FLIPS = 32  # C17: top-k threshold flips allowed a round, card against CPU
C18_ULPS = 32  # C18: ternary scales card against CPU (the CPU tests' gate)
# C17: a flip's |comp| below its dropping side's threshold, twice the
# largest reading on an H100 against its host's CPU (320 ulp; the two
# sides' updates differ by up to 2048 ulp of the threshold in those rows)
FLIP_ULPS = 640


def strategy_zoo() -> list:
    """``default_zoo()`` and top-k with S1E3M7 values, so that B3 and B4 run
    for top-k too."""
    return compress.default_zoo() + [compress.get_strategy("topk", value_fmt=FMT)]


def wire_prediction(strategy, leaves: int) -> dict:
    """The kernels' launches in each step of a wire roundtrip, from the number
    of selected leaves: OMC's encode is B1 and its decode B2, its codec B4;
    ternary codes pack and unpack in the codec; top-k with minifloat values
    and the pipeline write codes with B3 and pack them at encode, unpack at
    decode; f32 top-k launches nothing."""
    if strategy.name == "omc":
        steps = dict(encode=dict(quantize_stats=leaves), payload=dict(pack=leaves),
                     parse=dict(unpack=leaves), decode=dict(dequantize=leaves))
    elif strategy.name == "ternary":
        steps = dict(encode={}, payload=dict(pack=leaves), parse=dict(unpack=leaves), decode={})
    elif strategy.name == "pipeline" or not strategy.value_fmt.is_identity:
        steps = dict(encode=dict(quantize=leaves, pack=leaves), payload={}, parse={},
                     decode=dict(unpack=leaves))
    else:
        steps = dict(encode={}, payload={}, parse={}, decode={})
    return {step: {f"{k}.cuda": v for k, v in want.items()} for step, want in steps.items()}


def subtree(tree, names) -> dict:
    """The leaves of ``tree`` at the '/'-joined ``names``, nested as there."""
    out: dict = {}
    for path, leaf in tree_items(tree):
        if "/".join(path) in names:
            node = out
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = leaf
    return out


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in f32 ulps (same-signed finite values)."""
    return (a.float().cpu().view(torch.int32).long()
            - b.float().cpu().view(torch.int32).long()).abs()


def ternary_card_vs_cpu(params, specs) -> tuple:
    """ROADMAP C18 on the card: ``ternarize`` on the card and on the CPU.
    The means are f32 reductions in another order, so Δ and the scales may
    differ by ulps: each flipped code's |v| must lie between the two Δ of
    its stacked entry, and the scales of entries without a flip within
    C18_ULPS.  Returns (flips, values, largest scale gap)."""
    flips = n = gap = 0
    for (path, x), (_, spec) in zip(tree_items(params), tree_items(specs)):
        ax = n_stack_axes(spec, x)
        axes = tuple(range(ax, x.ndim))
        (tc, sc), (th, sh) = compress.ternarize(x, ax), compress.ternarize(x.cpu(), ax)
        dc = (0.7 * x.abs().mean(dim=axes, keepdim=True)).cpu()
        dh = 0.7 * x.cpu().abs().mean(dim=axes, keepdim=True)
        flipped = tc.cpu() != th
        mag = x.cpu().abs()[flipped]
        lo = torch.minimum(dc, dh).expand(x.shape)[flipped]
        hi = torch.maximum(dc, dh).expand(x.shape)[flipped]
        require(bool(((lo <= mag) & (mag <= hi)).all()),
                f"ternary {'/'.join(path)}: a code flips outside the gap of Δ: "
                f"{mag[:4].tolist()} {lo[:4].tolist()} {hi[:4].tolist()}")
        clean = ulps(sc, sh)[~flipped.reshape(*x.shape[:ax], -1).any(-1)]
        gap = max(gap, int(clean.max()) if clean.numel() else 0)
        flips += int(flipped.sum())
        n += x.numel()
    require(gap <= C18_ULPS, f"ternary scales {gap} ulp apart card against CPU")
    return flips, n, gap


def wire_card_vs_cpu(strategy, params, specs, omc, enc, dec) -> str:
    """The check leaves' frame, card against CPU.  Where the encode launches
    a kernel (top-k with S1E3M7 values, the pipeline), the CPU encodes the
    same weights with the plain versions and must write the card's frame
    byte for byte (omc's B1 is held in phases 2 and 15; f32 top-k launches
    none and selects as top-k with S1E3M7 values does).  Ternary packs in
    the codec: the card's frame, parsed on the CPU, must hold the card's
    codes and scales, and the CPU's own ``ternarize`` is held to C18.  The
    card's frame, decoded on the CPU, must give the card's decode bit for
    bit (every strategy).  Returns what was checked, for the printed
    line."""
    card = subtree(enc, CHECK_LEAVES)
    require(sorted("/".join(p) for p, x in tree_items(card) if compress.is_encoded_leaf(x))
            == sorted(CHECK_LEAVES), f"{strategy.label}: check leaves not all encoded")
    frame = codecs.encode_payload(card, strategy=strategy)
    back, _ = codecs.decode_payload(frame, device="cpu")
    said = f"frame ({len(frame):,} B)"
    if strategy.name == "pipeline" or (strategy.name == "topk"
                                       and not strategy.value_fmt.is_identity):
        host = tree_map(lambda x: x.cpu(), subtree(params, CHECK_LEAVES))
        host_enc = compress.encode_tree(strategy, host, omc, subtree(specs, CHECK_LEAVES))
        require(codecs.encode_payload(host_enc, strategy=strategy) == frame,
                f"{strategy.label}: the CPU's frame of {CHECK_LEAVES} is not the card's")
        said += " the CPU's own, byte for byte,"
    elif strategy.name == "ternary":
        parsed = dict(tree_items(back))
        for path, leaf in tree_items(card):
            # a 0-d scale travels as shape [1], as the reference writes it
            require(torch.equal(parsed[path].codes, leaf.codes.cpu())
                    and bit_equal(parsed[path].scale.reshape(leaf.scale.shape),
                                  leaf.scale.cpu()),
                    f"ternary: {'/'.join(path)}'s frame parsed on the CPU is not the card's")
        flips, n, gap = ternary_card_vs_cpu(subtree(params, CHECK_LEAVES),
                                            subtree(specs, CHECK_LEAVES))
        said += (f" parsed on the CPU to the card's codes and scales (the CPU's ternarize: "
                 f"{flips} code flips of {n:,}, each within the gap of Δ; scales within "
                 f"{gap} ulp, C18),")
    host_dec = dict(tree_items(compress.decode_tree(back)))
    for path, leaf in tree_items(subtree(dec, CHECK_LEAVES)):
        require(bit_equal(leaf.cpu(), host_dec[path]),
                f"{strategy.label}: {'/'.join(path)} decodes otherwise on the CPU")
    return said + " decoded on the CPU to the card's bits"


def strategies_wire(params, specs, omc) -> dict:
    """Each strategy's wire roundtrip over the full-width tree, launches
    counted step by step against the prediction."""
    table = accounting.build_wire_table(params, specs, omc)
    out, counts = {}, {}
    for strategy in strategy_zoo():
        want = wire_prediction(strategy, table.num_vars)
        got, ms = {}, {}

        def step(name, fn):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
            got[name] = ops.launch_counts()
            return res

        enc = step("encode", lambda: compress.encode_tree(strategy, params, omc, specs))
        payload = step("payload", lambda: codecs.encode_payload(enc, strategy=strategy))
        back, info = step("parse", lambda: codecs.decode_payload(payload, device="cuda"))
        dec = step("decode", lambda: compress.decode_tree(back))
        require(got == want, f"{strategy.label}: launches {got}, predicted {want}")
        for c in got.values():
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
        twb = compress.tree_wire_bytes(enc)
        rows = [strategy.plan_wire_bytes(n, sb)
                for n, sb in zip(table.n_elems, table.stack_entries)]
        plan = None if None in rows else sum(rows) + table.raw_bytes
        require(twb["wire_bytes"] == info.body_bytes
                == codecs.payload_bytes_report(back)["wire_bytes"],
                f"{strategy.label}: bytes {twb['wire_bytes']} / body {info.body_bytes}")
        require(plan is None or plan == info.body_bytes,
                f"{strategy.label}: plan {plan} against {info.body_bytes} measured")
        require((info.strategy, info.strategy_version) == (strategy.name, strategy.wire_version),
                f"{strategy.label}: frame tagged {info.strategy} v{info.strategy_version}")
        # the decoded tree encodes to the same frame; top-k also re-encodes
        # from the decoded values to the same leaves (the pipeline's are top-k's
        # positions and B3's codes of them, and its DEFLATE takes seconds)
        require(codecs.encode_payload(back, strategy=strategy) == payload,
                f"{strategy.label}: re-encoding the decoded frame changed its bytes")
        if strategy.name == "topk":
            again = compress.encode_tree(strategy, dec, omc, specs)
            require(codecs.encode_payload(again, strategy=strategy) == payload,
                    f"{strategy.label}: re-encoding the decoded tree changed its leaves")
        for path, leaf in tree_items(dec):
            ref = dict(tree_items(params))[path]
            require(leaf.shape == ref.shape and leaf.device.type == "cuda"
                    and bool(torch.isfinite(leaf).all()), f"{strategy.label}: leaf {path}")
        t0 = time.perf_counter()
        cross = wire_card_vs_cpu(strategy, params, specs, omc, enc, dec)
        cross_s = time.perf_counter() - t0
        out[strategy.label] = dict(wire_bytes=info.body_bytes, plan=plan,
                                   ratio=info.body_bytes / table.fp32_total,
                                   per_strategy=twb["per_strategy"], ms=ms, launches=got,
                                   check=cross, check_s=cross_s)
        print(f"  {strategy.label}: {info.body_bytes:,} B ({info.body_bytes / table.fp32_total:.2%}"
              f" of f32), plan {plan if plan is None else f'{plan:,}'}; encode "
              f"{ms['encode'] + ms['payload']:.1f} ms (tree {ms['encode']:.1f}), decode "
              f"{ms['parse'] + ms['decode']:.1f} ms (tree {ms['decode']:.1f}); launches "
              f"{ {k: v for k, v in got.items() if v} }; check leaves' {cross} "
              f"({cross_s:.1f} s)")
        del enc, payload, back, dec
    return dict(rows=out, counts=counts, leaves=table.num_vars, fp32=table.fp32_total)


def ledger_rule(table, omc, strategy, ids, alive, round_index) -> tuple:
    """The reference's ledger, restated: every invited client downloads the
    at-rest state (an upload-only strategy) or the strategy's plan of it;
    every survivor uploads its PPQ-masked variables under the strategy's
    plan, the rest f32."""
    plan = np.asarray([strategy.plan_wire_bytes(n, sb) if strategy is not None else
                       packing.packed_bytes(n, omc.fmt) + 8 * sb
                       for n, sb in zip(table.n_elems, table.stack_entries)], np.int64)
    f32 = 4 * np.asarray(table.n_elems, np.int64)
    at_rest = int(sum(packing.packed_bytes(n, omc.fmt) + 8 * sb
                      for n, sb in zip(table.n_elems, table.stack_entries))) + table.raw_bytes
    down = len(ids) * (at_rest if strategy is None or strategy.upload_only
                       else int(plan.sum()) + table.raw_bytes)
    masks = ppq_masks_batch(omc.ppq_key(), round_index, ids, table.num_vars,
                            omc.quantize_fraction).numpy()
    up = sum(int(np.where(m, plan, f32).sum()) + table.raw_bytes
             for m, ok in zip(masks, alive) if ok)
    return down, up


class recorded_comps:
    """Within the block, the loop's ``strategy_upload`` records each
    client's compensated update ``comp = (trained - received) + residual``
    of each leaf it has a residual for (the expression ``compensate_leaf``
    evaluates, on the same device: the same bits) in ``store[(client,
    path)]``."""

    def __init__(self, store: dict):
        self.store, self.inner = store, simulate.strategy_upload

    def __enter__(self):
        def upload(trained, received, residual, specs, omc, strategy, round_index, client_id,
                   ste=False):
            t, r = dict(tree_items(trained)), dict(tree_items(received))
            for path in t:
                name = "/".join(path)
                if residual is not None and name in residual:
                    self.store[(client_id, name)] = (t[path] - r[path]) + residual[name]
            return self.inner(trained, received, residual, specs, omc, strategy, round_index,
                              client_id, ste)

        simulate.strategy_upload = upload
        return self.store

    def __exit__(self, *exc):
        simulate.strategy_upload = self.inner


def flip_count(a: dict, b: dict, comps_a: dict, comps_b: dict, density: float) -> tuple:
    """Residuals of two runs of f32 top-k with error feedback: (entries
    beyond RESID, entries in all, the largest gap and the largest comp
    difference of a flipped row, both in ulps of the threshold).  Each
    entry beyond RESID must be a flip (ROADMAP C17): kept (residual 0) on
    one side and dropped (residual = comp) on the other, each side's choice
    its own rule ``|comp| >= the k-th largest |comp|`` of the client's
    leaf, and the dropped |comp| within FLIP_ULPS of its side's
    threshold."""
    flips = total = 0
    worst = noise = 0.0
    for name in a:
        x, y = a[name].to("cpu"), b[name].to("cpu")
        total += x.numel()
        off = (x - y).abs() > RESID
        for c in off.flatten(1).any(1).nonzero().flatten().tolist():
            pos = off[c].flatten().nonzero().flatten()
            ca, cb = (comps[(c, name)].to("cpu").flatten() for comps in (comps_a, comps_b))
            k = compress.topk.num_kept(ca.numel(), density)
            ta, tb = (torch.topk(v.abs(), k).values[-1] for v in (ca, cb))
            ma, mb = ca[pos].abs(), cb[pos].abs()
            keep_a, keep_b = ma >= ta, mb >= tb
            require(bool((keep_a != keep_b).all()),
                    f"residual {name} client {c}: entries beyond {RESID} kept or dropped on "
                    f"both sides: {ca[pos][keep_a == keep_b][:4].tolist()}")
            ra, rb = x[c].flatten()[pos], y[c].flatten()[pos]
            dropped = torch.where(keep_a, cb[pos], ca[pos])
            require(bool((torch.where(keep_a, ra, rb) == 0).all())
                    and bit_equal(torch.where(keep_a, rb, ra), dropped),
                    f"residual {name} client {c}: a flip's residuals are not 0 and comp")
            t = torch.where(keep_a, tb, ta).double()
            ulp = float(torch.nextafter(ta, torch.tensor(math.inf)) - ta)
            gap = (t - torch.where(keep_a, mb, ma).double()) / ulp
            worst = max(worst, float(gap.max()))
            noise = max(noise, float((ca.abs().double() - cb.abs().double()).abs().max()) / ulp)
            require(bool((gap <= FLIP_ULPS).all()),
                    f"residual {name} client {c}: a dropped |comp| {gap.max():.0f} ulp under "
                    f"its threshold")
            flips += pos.numel()
    return flips, total, worst, noise


def strategies_train(params, specs, omc) -> dict:
    """The engine at phase 7's configuration (unfused) under the strategies,
    launches against a CPU dry run at the smoke config (the engine's launches
    depend on the 13 compressed leaves and the cohort, not on depth or
    width)."""
    cfg = TRAIN_CFG
    key = prng.PRNGKey(0)
    spec = engine.CohortSpec(STRAT_PLAN)
    task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=256, num_clients=16)
    data_fn = lambda c, r, s: task.batch(c, r, s, 8)  # noqa: E731
    table = accounting.build_wire_table(params, specs, omc)
    smoke = conformer_s.smoke_config()
    smoke_params = conformer.init(prng.PRNGKey(0), smoke, "cpu")
    smoke_task = make_frame_task(d_in=smoke.d_in, n_classes=smoke.n_classes, seq_len=8,
                                 num_clients=16, device="cpu")
    require(accounting.selected_names(smoke_params, conformer.param_specs(smoke), omc)
            == list(table.names), "smoke and full configs select other leaves")
    runs, counts = {}, {}

    def train(name, strategy, rounds, wire=True):
        takes_ef = strategy is not None and compress.feedback.takes_residual(omc, strategy)
        ef = compress.feedback.init_ef_state(params, specs, omc, 16) if takes_ef else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        storage, hist = engine.run_training_vectorized(
            conformer, cfg, omc, STRAT_SIM, spec, data_fn, key, rounds, init_params=params,
            wire=wire, strategy=strategy, ef=ef)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = ops.launch_counts()
        # the same run on the CPU at the smoke config: the plain versions' launches
        ops.reset_launch_counts()
        smoke_ef = (compress.feedback.init_ef_state(smoke_params, conformer.param_specs(smoke),
                                                    omc, 16) if takes_ef else None)
        engine.run_training_vectorized(
            conformer, smoke, omc, STRAT_SIM, spec,
            lambda c, r, s: smoke_task.batch(c, r, s, 1), key, rounds,
            init_params=smoke_params, wire=False, strategy=strategy, ef=smoke_ef)
        want = as_cuda(ops.launch_counts())
        # B1: the init compress and each round's re-compress, 13 leaves each
        require(got == want and got.get("quantize_stats.cuda", 0) == 13 * (rounds + 1),
                f"{name}: launches {got}, the CPU dry run's {want}")
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        for r, h in enumerate(hist):
            require(math.isfinite(h["loss"]) and 0 < h["loss"] < 20, f"{name}: bad loss {h}")
            if wire:
                ids = cohort.sample_cohort(prng.fold_in(key, 0xC047), STRAT_PLAN, r).tolist()
                alive = cohort.survival_mask(prng.fold_in(key, 0xC047), STRAT_PLAN, r).tolist()
                rule = ledger_rule(table, omc, strategy, ids, alive, r)
                require((h["down_bytes"], h["up_bytes"]) == rule,
                        f"{name}: ledger {h} against the reference's rule {rule}")
        runs[name] = dict(storage=storage, history=hist, s_per_round=wall / rounds,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9, counts=got,
                          ef_bytes=compress.feedback.ef_bytes(ef),
                          ef_norm=compress.feedback.total_norm(ef) if ef else 0.0)
        if ef:
            require(runs[name]["ef_norm"] > 0 and math.isfinite(runs[name]["ef_norm"]),
                    f"{name}: residual norm {runs[name]['ef_norm']}")
        del ef
        torch.cuda.empty_cache()
        print(f"  engine {name}: {rounds} round(s), {wall / rounds:.2f} s a round, peak "
              f"{runs[name]['peak_gb']:.2f} GB, ef_bytes {runs[name]['ef_bytes']:,}, residual "
              f"norm {runs[name]['ef_norm']:.4g}, launches {got} (the CPU dry run's); "
              + "; ".join(f"round {h['round']}: loss {h['loss']:.4f}"
                          + (f", down {h['down_bytes']:,} up {h['up_bytes']:,}" if wire else "")
                          for h in hist))

    train("none", None, 1)
    train("omc", compress.get_strategy("omc"), 1)
    require(runs["none"]["history"] == runs["omc"]["history"]
            and trees_bit_equal(runs["none"]["storage"], runs["omc"]["storage"]),
            "strategy omc and strategy None trained different bits")
    print("  strategy omc against None: storage, history and ledger the same bits")
    # phase 19 holds its sharded rounds against the engine's unfused round
    none = (runs["none"]["storage"], runs["none"]["history"])
    for name in ("none", "omc"):
        runs[name].pop("storage")
    train("topk-0.1+ef", compress.get_strategy("topk", density=0.1), 1)
    # phase 19 holds its store-backed EF round against this one
    topk = {k: runs["topk-0.1+ef"][k] for k in ("storage", "history")}
    topk["peak"] = runs["topk-0.1+ef"]["peak_gb"] * 1e9
    train("ternary+ef", compress.get_strategy("ternary"), 1)
    train("pipeline+ef", compress.get_strategy("pipeline"), 1, wire=False)
    for r in runs.values():
        r.pop("storage", None)
    return dict(runs=runs, counts=counts, topk=topk, none=none)


def strategies_card_vs_cpu() -> dict:
    """Conformer_s cut to 2 layers at full width: the loop under top-k with
    error feedback, 2 rounds, and the async runtime under it on the
    degenerate trace, on the card (kernels) and on the CPU (plain versions).
    Round 2 of the loop starts from the CPU's state on both sides, so the
    residual gate holds round by round (one re-compress step on a boundary
    element moves many entries across the threshold in the next round)."""
    # 2 layers: at 1, a residual flip's dropped |comp| lay 768 ulp under its
    # threshold on an H100, over C17's 640-ulp gate (ROADMAP C17)
    cfg = dataclasses.replace(TRAIN_CFG, n_layers=2)
    omc = OMCConfig.parse(FMT.name)
    sim = simulate.SimConfig(local_steps=1, client_lr=0.1)
    plan = CohortPlan(num_clients=4, cohort_size=2)
    topk = compress.get_strategy("topk", density=0.1)
    params = conformer.init(prng.PRNGKey(1), cfg, "cuda")
    specs = conformer.param_specs(cfg)
    key = prng.fold_in(prng.PRNGKey(0), 0xC047)
    devs = dict(card="cuda", host="cpu")
    tasks = {side: make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=32,
                                   num_clients=4, device=d) for side, d in devs.items()}
    table = accounting.build_wire_table(params, specs, omc)
    out = {}

    def loop_round(side, storage, ef, r):
        with recorded_comps({}) as comps:
            st, m = simulate.run_round(
                conformer, cfg, specs, omc, sim, storage,
                lambda c, rr, s, t=tasks[side]: t.batch(c, rr, s, 2), plan, r, key,
                wire_table=table, strategy=topk, ef=ef)
        return dict(st=st, m=m, ef=ef, comps=comps)

    def to(tree, dev):
        return tree_map(lambda x: x.to(dev), tree)

    runs = {}
    for side, dev in devs.items():
        p = to(params, dev)
        ef = compress.feedback.init_ef_state(p, specs, omc, 4)
        ops.reset_launch_counts()
        runs[side] = loop_round(side, compress_params(p, specs, omc), ef, 0)
        runs[side]["counts"] = ops.launch_counts()
    require(runs["card"]["counts"] == as_cuda(runs["host"]["counts"]),
            f"loop launches: card {runs['card']['counts']}, CPU {runs['host']['counts']}")
    gaps, flips, ulps = [], [], []
    for r in (0, 1):
        if r:  # round 2 from the CPU's state on both sides
            start, start_ef = runs["host"]["st"], runs["host"]["ef"]
            for side, dev in devs.items():
                ef = {k: v.to(dev).clone() for k, v in start_ef.items()}
                runs[side] = loop_round(side, to(start, dev), ef, 1)
        mc, mh = runs["card"]["m"], runs["host"]["m"]
        require({k: mc[k] for k in ("cohort", "dropped", "down_bytes", "up_bytes")}
                == {k: mh[k] for k in ("cohort", "dropped", "down_bytes", "up_bytes")}
                and abs(mc["loss"] - mh["loss"]) < 1e-3, f"loop round {r}: {mc} {mh}")
        gap = tree_gap(runs["card"]["st"], to(runs["host"]["st"], "cuda"))
        require(gap[0] <= TREE_MAX and gap[1] <= TREE_MEAN, f"loop round {r} trees {gap}")
        f, n, u, z = flip_count(runs["card"]["ef"], runs["host"]["ef"],
                                runs["card"]["comps"], runs["host"]["comps"], topk.density)
        require(f <= FLIPS, f"loop round {r}: {f} flips of {n} residual entries")
        gaps.append(gap)
        flips.append(f)
        ulps.append((u, z))
    out["loop"] = dict(gaps=gaps, flips=flips, entries=n, flip_ulps=ulps)
    print(f"  loop, 2 layers at full width, top-k 0.1 + EF, cohort 2 of 4, 2 x 32 frames, 2 "
          f"rounds: ledgers equal, trees max |d| {[f'{g[0]:.3g}' for g in gaps]}, residual "
          f"flips {flips} of {n:,} (C17; each kept on one side and dropped on the other by "
          f"its own rule, at most {[f'{u:.0f}' for u, _ in ulps]} ulp under its threshold; "
          f"comp card against CPU up to {[f'{z:.0f}' for _, z in ulps]} ulp of it in those "
          f"rows)")

    # the async runtime on the degenerate trace, a mid-buffer checkpoint on the card
    acfg, trace = async_engine.AsyncConfig(buffer_goal=2), traces.FixedTrace(latency=1.0)

    def runner(side):
        return async_engine.AsyncRunner(conformer, cfg, omc, sim, acfg, trace, num_clients=2,
                                        data_fn=lambda c, r, s, t=tasks[side]: t.batch(c, r, s, 2),
                                        init_params=to(params, devs[side]), strategy=topk)

    shutil.rmtree(STRAT_DIR, ignore_errors=True)
    card = runner("card")
    card.run_until(flushes=1)
    card.run_until(uploads=1)  # mid-buffer: one upload waits for the next flush
    path = ck.save_async_state(str(STRAT_DIR), card)
    card.run_until(flushes=1)
    fresh = runner("card")
    ck.restore_async_state(path, fresh)
    fresh.run_until(flushes=1)
    require(trees_bit_equal(fresh.storage, card.storage) and fresh.history == card.history
            and all(bit_equal(fresh.ef[k], card.ef[k]) for k in card.ef),
            "the async EF resume differs from the straight run")
    host = runner("host")
    host.run_until(flushes=2)
    require(schedule(card.history) == schedule(host.history), "async schedules differ")
    for a, b in zip(card.history, host.history):
        require(abs(a["loss"] - b["loss"]) < 1e-3, f"async losses {a} {b}")
    gap = tree_gap(card.storage, to(host.storage, "cuda"))
    require(gap[0] <= TREE_MAX and gap[1] <= TREE_MEAN, f"async trees {gap}")
    shutil.rmtree(STRAT_DIR, ignore_errors=True)
    out["async"] = dict(gap=gap)
    print(f"  async, 2 layers at full width, top-k 0.1 + EF, degenerate trace (2 clients, "
          f"buffer 2), 2 flushes: a mid-buffer checkpoint resumed to the same bits "
          f"(storage, history, residuals); card against CPU schedules and ledgers equal, trees "
          f"max |d| {gap[0]:.3g}")
    return out


def phase_strategies() -> dict:
    """The zoo at full width: each strategy's wire roundtrip, the engine under
    the strategies, and the loop and async runtime card against CPU; under
    deterministic algorithms (strategy omc against None is compared bit for
    bit)."""
    with deterministic_algorithms():
        cfg, omc = TRAIN_CFG, OMCConfig.parse(FMT.name)
        params = conformer.init(prng.PRNGKey(0), cfg, "cuda")
        specs = conformer.param_specs(cfg)
        t0 = time.perf_counter()
        wire = strategies_wire(params, specs, omc)
        t1 = time.perf_counter()
        trained = strategies_train(params, specs, omc)
        t2 = time.perf_counter()
        del params
        torch.cuda.empty_cache()
        cross = strategies_card_vs_cpu()
        print(f"  parts: wire {t1 - t0:.1f} s, engine {t2 - t1:.1f} s, card against CPU "
              f"{time.perf_counter() - t2:.1f} s")
    counts = dict(wire["counts"])
    for k, v in trained["counts"].items():
        counts[k] = counts.get(k, 0) + v
    return dict(wire=wire, train=trained, cross=cross, counts=counts)


# ---------------------------------------------------------------------------
# 18. telemetry and the sessions' strategy uploads at full width
# ---------------------------------------------------------------------------


def _counted(fn, *args, **kw):
    """``(fn(...), its launches)``, the counters zeroed just before."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, ops.launch_counts()


def _plus(*parts) -> dict:
    """Launch dicts summed, ``op`` keys as ``op.cuda``; zeros dropped."""
    out = {}
    for part in parts:
        for k, v in part.items():
            k = k if k.endswith(".cuda") else f"{k}.cuda"
            out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def obs_engine(params, omc, fused: bool, train_peaks=None) -> dict:
    """Phase 7's engine for OBS_ROUNDS rounds with ``obs=None``, then from
    the same state with a live ``Obs``: the same bits, the same ledger, a
    bundle a round, and B2 up by exactly the bundle's two decodes (old and
    new storage) of each compressed leaf a round."""
    cfg, name = TRAIN_CFG, "fused" if fused else "unfused"
    sim = simulate.SimConfig(local_steps=2, client_lr=0.1)
    spec = engine.CohortSpec(CohortPlan(num_clients=16, cohort_size=COHORT, failure_rate=0.25))
    task = make_frame_task(d_in=cfg.d_in, n_classes=cfg.n_classes, seq_len=256, num_clients=16)
    data_fn = lambda c, r, s: task.batch(c, r, s, 8)  # noqa: E731
    runs = {}
    for on in (False, True):
        obs = Obs(run_name=f"engine_{name}", out_dir=str(OBS_DIR)) if on else None
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (storage, hist), counts = _counted(
            engine.run_training_vectorized, conformer, cfg, omc, sim, spec, data_fn,
            prng.PRNGKey(0), OBS_ROUNDS, init_params=params, fused_agg=fused, obs=obs)
        runs[on] = dict(storage=storage, history=hist, wall=time.perf_counter() - t0,
                        counts=counts, peak=torch.cuda.max_memory_allocated(), obs=obs)
    off, on = runs[False], runs[True]
    require(trees_bit_equal(off["storage"], on["storage"]), f"{name}: obs moved stored bits")
    require(off["history"] == on["history"], f"{name}: obs moved the history or the ledger")
    obs = on["obs"]
    recs = obs.sink.records("round")
    require(len(recs) == OBS_ROUNDS and all(math.isfinite(r["update_norm"]) and r["update_norm"] > 0
                                            for r in recs), f"{name}: round records {recs}")
    for r in recs:
        qerr = sorted(k for k in r if k.startswith("qerr/"))
        require(("qerr_norm" in r) == (not fused) and bool(qerr) == (not fused),
                f"{name}: qerr fields {qerr} in a {'fused' if fused else 'unfused'} round")
        require(fused or (len(qerr) == 13 and math.isfinite(r["qerr_norm"])),
                f"{name}: {len(qerr)} qerr leaves, qerr_norm {r.get('qerr_norm')}")
    n_comp = sum(is_compressed(x) for _, x in tree_items(on["storage"]))
    bundle_b2 = 2 * n_comp * OBS_ROUNDS  # predicted: old and new storage, each leaf, a round
    want = _plus(off["counts"], {"dequantize": bundle_b2})
    require(on["counts"] == want, f"{name}: obs launches {on['counts']}, predicted {want}")
    require(off["counts"].get("fused_aggregate.cuda", 0) == (13 * OBS_ROUNDS if fused else 0),
            f"{name}: B5 {off['counts']}")
    span_s = sum(sp.dur for sp in obs.tracer.spans("wall", "round"))
    require(len(obs.tracer.spans("wall", "round")) == OBS_ROUNDS, f"{name}: round spans")
    del off["storage"], on["storage"]
    print(f"  engine {name}: {OBS_ROUNDS} rounds obs off {off['wall']:.2f} s / on "
          f"{on['wall']:.2f} s (host clock around synchronize, init included), summed round "
          f"spans {span_s:.2f} s; storage the same bits, ledger the same bytes; B2 "
          f"{off['counts'].get('dequantize.cuda', 0)} -> {on['counts'].get('dequantize.cuda', 0)}"
          f" (+{bundle_b2} predicted: 2 x {n_comp} leaves x {OBS_ROUNDS} rounds), B1 "
          f"{on['counts'].get('quantize_stats.cuda', 0)} and B5 "
          f"{on['counts'].get('fused_aggregate.cuda', 0)} unchanged; peak off "
          f"{off['peak'] / 1e9:.2f} / on {on['peak'] / 1e9:.2f} GB"
          + (f" (phase 7's {name} run: {train_peaks[name] / 1e9:.2f} GB)" if train_peaks else ""))
    print("    " + "; ".join(
        f"round {r['round']}: update_norm {r['update_norm']:.5g}"
        + (f", qerr_norm {r['qerr_norm']:.5g}" if "qerr_norm" in r else "") for r in recs))
    return dict(obs=obs, counts=_plus(off["counts"], on["counts"]), off_s=off["wall"],
                on_s=on["wall"], span_s=span_s, peak=(off["peak"], on["peak"]))


def obs_sessions(params, omc) -> dict:
    """One sync round of ``FLSession``/``FLClient`` at cohort 4 of 8 under
    top-k 0.1 with S1E3M7 values and error feedback, under a live ``Obs``:
    each upload's body the plan's bytes, each part's launches as predicted
    from the selected and compressed leaves, the residual on the card."""
    cfg, specs = TRAIN_CFG, conformer.param_specs(TRAIN_CFG)
    strategy = compress.get_strategy(**OBS_SESSION_STRATEGY)
    require(strategy.error_feedback and strategy.upload_only, f"{strategy.label}: EF upload")
    table = accounting.build_wire_table(params, specs, omc)
    plan_bytes, n_sel = table.download_bytes_strategy(strategy), len(table.names)
    obs = Obs(run_name="sessions_topk", out_dir=str(OBS_DIR))
    sess = FLSession(conformer, cfg, omc, plan=SESSION_PLAN, init_params=params,
                     strategy=strategy, obs=obs)
    n_comp = sum(is_compressed(x) for _, x in tree_items(sess.storage))
    train_fn = session_sgd(cfg, "cuda")
    clients = {c: FLClient(c, conformer, cfg, omc, train_fn, strategy=strategy, obs=obs)
               for c in range(SESSION_PLAN.num_clients)}
    wire = wire_prediction(strategy, n_sel)
    t0 = time.perf_counter()
    ticket, got = _counted(sess.begin_round)
    parts = {"begin_round": (got, _plus({"pack": n_comp}))}
    bodies = []
    for cid in ticket.client_ids:
        blob, got = _counted(clients[cid].run_round, ticket)
        # the download's parse and decode, the upload's encode, the residual's decode
        parts[f"client {cid}"] = (got, _plus({"unpack": n_comp, "dequantize": n_comp},
                                             wire["encode"], wire["decode"]))
        bodies.append(codecs.peek_payload(blob).body_bytes)
        _, got = _counted(sess.ingest, cid, blob)
        # the frame's decode, and the base the update lands on
        parts[f"ingest {cid}"] = (got, _plus(wire["parse"], wire["decode"],
                                             {"dequantize": n_comp}))
        res = clients[cid]._residual
        require(res is not None and all(x.is_cuda for _, x in tree_items(res)),
                f"client {cid}: the residual is not on the card")
    metrics, got = _counted(sess.close_round)
    parts["close_round"] = (got, _plus({"dequantize": n_comp, "quantize_stats": n_comp}))
    round_s = time.perf_counter() - t0
    for part, (got, want) in parts.items():
        require(got == want, f"sessions {part}: launches {got}, predicted {want}")
    require(bodies == [plan_bytes] * len(bodies),
            f"upload bodies {bodies}, the plan's {plan_bytes}")
    spans = obs.tracer.summary()
    require(spans["wall:encode_payload"]["count"] == 1 + len(ticket.client_ids)
            and spans["wall:decode_payload"]["count"] == 2 * len(ticket.client_ids),
            f"session spans {spans}")
    print(f"  sessions under {strategy.label} with EF, cohort 4 of 8: {round_s:.2f} s a round; "
          f"each upload body {plan_bytes:,} B (the plan's; {plan_bytes / table.fp32_total:.2%} "
          f"of f32), residuals on the card; launches as predicted: "
          + "; ".join(f"{k} {v[0]}" for k, v in list(parts.items())[:3])
          + f"; traffic {metrics}")
    return dict(obs=obs, counts=_plus(*(got for got, _ in parts.values())), round_s=round_s,
                body_bytes=plan_bytes)


def obs_async(params, omc) -> dict:
    """Two flushes of the async runtime (4 clients, buffer 2, the straggler
    knobs) under a live ``Obs``: a ``client_round`` virtual span per
    check-in, a ``flush`` record with its staleness list per flush."""
    acfg, trace = straggler(OBS_ASYNC_CLIENTS, OBS_ASYNC_BUFFER)
    obs = Obs(run_name="async", out_dir=str(OBS_DIR))
    runner = async_engine.AsyncRunner(conformer, TRAIN_CFG, omc, ASYNC_SIM, acfg, trace,
                                      num_clients=OBS_ASYNC_CLIENTS,
                                      data_fn=async_data(TRAIN_CFG, OBS_ASYNC_CLIENTS),
                                      init_params=params, obs=obs)
    t0 = time.perf_counter()
    _, counts = _counted(runner.run_until, flushes=2)
    wall = time.perf_counter() - t0
    vspans = obs.tracer.spans("virtual", "client_round")
    checkins = sum(runner.round_counters.values())
    require(len(vspans) == checkins > 0, f"{len(vspans)} client_round spans, {checkins} check-ins")
    recs = obs.sink.records("flush")
    require(len(recs) == 2, f"flush records {len(recs)}")
    for r, h in zip(recs, runner.history):
        st = r["staleness"]
        require(len(st) == acfg.buffer_goal and max(st) == h["staleness_max"]
                and abs(sum(st) / len(st) - h["staleness_mean"]) < 1e-6
                and math.isfinite(r["update_norm"]) and "qerr_norm" in r,
                f"flush record {r} against history {h}")
    print(f"  async, {OBS_ASYNC_CLIENTS} clients, buffer {OBS_ASYNC_BUFFER}, 2 flushes: "
          f"{wall:.2f} s; {len(vspans)} client_round virtual spans ({checkins} check-ins), "
          f"flush staleness {[r['staleness'] for r in recs]}, "
          f"{len(obs.tracer.spans('wall', 'dispatch'))} dispatch spans; launches {counts}")
    return dict(obs=obs, counts=counts, wall=wall)


def phase_obs(train_peaks=None) -> dict:
    """Telemetry at full width (phase 7's configuration) and the sessions'
    strategy uploads, under deterministic algorithms.  ``train_peaks``:
    phase 7's peak device bytes by run (``fused``, ``unfused``), printed
    beside phase 18's when given."""
    with deterministic_algorithms():
        return _phase_obs(train_peaks)


def _phase_obs(train_peaks) -> dict:
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    omc = OMCConfig.parse(FMT.name)
    params = conformer.init(prng.PRNGKey(0), TRAIN_CFG, "cuda")
    times, parts = {}, {}
    for name, fn, args in (("engine unfused", obs_engine, (params, omc, False, train_peaks)),
                           ("engine fused", obs_engine, (params, omc, True, train_peaks)),
                           ("sessions", obs_sessions, (params, omc)),
                           ("async", obs_async, (params, omc))):
        t0 = time.perf_counter()
        parts[name] = fn(*args)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    sizes = {}
    for name, part in parts.items():
        paths = part["obs"].flush()
        require(all(os.path.getsize(p) > 0 for p in paths.values()), f"{name}: {paths}")
        sizes[name] = {k: os.path.getsize(p) for k, p in paths.items()}
    out = io.StringIO()
    jsonl = str(OBS_DIR / "engine_unfused.obs.jsonl")
    with contextlib.redirect_stdout(out):
        rc = obs_report.main([jsonl])
    require(rc == 0 and f"== rounds ({OBS_ROUNDS}) ==" in out.getvalue(),
            f"report: {rc} {out.getvalue()}")
    print("  exported (bytes): " + "; ".join(f"{k} {v}" for k, v in sizes.items()))
    print("  python -m repro_torch.obs.report build/obs/engine_unfused.obs.jsonl:")
    for line in out.getvalue().splitlines():
        if line.strip():
            print(f"    {line}")
    print("  parts: " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    return dict(counts=_plus(*(p["counts"] for p in parts.values())), times=times,
                sizes=sizes, engine={k: {kk: v for kk, v in parts[k].items() if kk != "obs"}
                                     for k in ("engine unfused", "engine fused")})


# ---------------------------------------------------------------------------
# 19. the population runtime at full width
# ---------------------------------------------------------------------------

SCALE_DIR = ROOT / "build" / "scale"  # the packed store's and the async runner's checkpoints
SCALE_UNFUSED_MEAN = 1e-4  # the reference's sharded-against-engine gates (tests/test_scale.py)
SCALE_EF_MAX, SCALE_EF_MEAN = 1e-5, 1e-6  # store-backed EF against the engine's dense EF
SCALE_POPULATIONS = (1_000, 100_000)  # part (b)'s populations: cohort 16, capacity 4, 4 shards
SCALE_PEAK_RATIO = 1.5  # the reference benchmark's acceptance on the measured peaks
SCALE_STALL = 10.0  # the reference benchmark's swap-stall limit
SCALE_CHECK_LEAVES = CHECK_LEAVES[1:]  # (c)'s codec check: the three smallest selected leaves


def scale_vs_engine(params, omc, engine_fused=None, engine_unfused=None) -> dict:
    """(a) One sharded round unfused and one fused (cohort 8 of 16, 2 shards,
    capacity 3) against the engine's round from the same key: the same
    invited and alive clients, ledgers to the byte, trees within the
    reference's gates.  ``engine_fused`` / ``engine_unfused``: phase 7's warm
    round and phase 17's strategy-None round (the engine's rounds from this
    key and init), ``(storage, history)``; each is run here when not given."""
    cfg, layout = TRAIN_CFG, scale.ShardLayout(16, 2)
    data_fn, key = async_data(TRAIN_CFG, 16), prng.PRNGKey(0)
    spec = engine.CohortSpec(STRAT_PLAN)
    ids = engine.sample_tiered_cohort(prng.fold_in(key, 0xC047), spec, 0)[0].numpy()
    alive = cohort.survival_mask(prng.fold_in(key, 0xC047), STRAT_PLAN, 0).numpy()
    out, counts = {}, []
    for fused in (False, True):
        store = scale.PopulationStore(layout)  # counters only: who was invited, who uploaded
        t0 = time.perf_counter()
        (storage, hist, ledger_), got = _counted(
            scale.run_training_sharded, conformer, cfg, omc, STRAT_SIM, STRAT_PLAN, layout,
            data_fn, key, 1, capacity=3, fused_agg=fused, store=store, init_params=params)
        wall = time.perf_counter() - t0
        require_launches(got, f"sharded fused={fused}", quantize_stats=None, dequantize=None,
                         fused_aggregate=0)
        counts.append(got)
        if fused and engine_fused is None:
            engine_fused = engine.run_training_vectorized(conformer, cfg, omc, STRAT_SIM, spec,
                                                          data_fn, key, 1, init_params=params,
                                                          fused_agg=True)
        if not fused and engine_unfused is None:
            engine_unfused = engine.run_training_vectorized(conformer, cfg, omc, STRAT_SIM, spec,
                                                            data_fn, key, 1, init_params=params)
        eng_storage, eng_hist = engine_fused if fused else engine_unfused
        require(np.array_equal(np.flatnonzero(store.round_counters), np.sort(ids))
                and np.array_equal(np.flatnonzero(store.event_counters), np.sort(ids[alive])),
                f"fused={fused}: the sharded round invited {np.flatnonzero(store.round_counters)} "
                f"with {np.flatnonzero(store.event_counters)} alive; the engine {ids}, {alive}")
        require(ledger(hist) == ledger(eng_hist), f"fused={fused}: ledgers {hist} {eng_hist}")
        require(abs(hist[0]["loss"] - eng_hist[0]["loss"]) < 1e-3, f"losses {hist} {eng_hist}")
        gap = tree_gap(storage, eng_storage)
        mean_gate = TREE_MEAN if fused else SCALE_UNFUSED_MEAN
        require(gap[0] <= TREE_MAX and gap[1] <= mean_gate,
                f"fused={fused}: sharded against engine {gap}")
        out["fused" if fused else "unfused"] = dict(gap=gap, wall=wall, history=hist,
                                                   ledger=ledger_.snapshot(), counts=got)
        print(f"  (a) sharded {'fused  ' if fused else 'unfused'} round: {wall:.2f} s, "
              f"{hist[0]['chunks']} chunks over {hist[0]['shards']} shards at capacity 3; "
              f"invited and alive clients and ledger the engine's (down {hist[0]['down_bytes']:,}"
              f" up {hist[0]['up_bytes']:,}); trees max |d| {gap[0]:.3g}, mean |d| {gap[1]:.3g}"
              f" (gates {TREE_MAX:g} / {mean_gate:g}); launches {got}")
        del storage, eng_storage
    del engine_fused, engine_unfused
    return dict(runs=out, counts=_plus(*counts))


def scale_memory(params, omc) -> dict:
    """(b) One timed round at each of SCALE_POPULATIONS (cohort 16, capacity
    4, 4 shards) through one stream and one root function: the StreamLedger
    bound the same, the measured peaks within 1.5x.  Part (a)'s two sharded
    rounds are its shared warm-up: the port compiles nothing per stream
    function, so a streamed round of the same model warms what a first round
    pays for (the allocator, cuBLAS's handles, lazily loaded kernels)."""
    cfg, specs = TRAIN_CFG, conformer.param_specs(TRAIN_CFG)
    data_fn, key = async_data(TRAIN_CFG, max(SCALE_POPULATIONS)), prng.PRNGKey(0)
    table = accounting.build_wire_table(params, specs, omc)
    storage = compress_params(params, specs, omc)
    stream_fn = scale.make_stream_fn(conformer, cfg, specs, omc, STRAT_SIM, data_fn, 4)
    root_fn = scale.make_root_fn(specs, omc, STRAT_SIM)

    def one_round(population, r, storage, ledger_=None):
        plan = CohortPlan(num_clients=population, cohort_size=16, failure_rate=0.25)
        layout = scale.ShardLayout(population, 4)
        store = scale.PopulationStore(layout)
        new, m = scale.run_round_sharded(conformer, cfg, specs, omc, STRAT_SIM, storage, data_fn,
                                         plan, layout, r, key, capacity=4, stream_fn=stream_fn,
                                         root_fn=root_fn, store=store, wire_table=table,
                                         ledger=ledger_)
        return new, m, store

    rows, counts = [], []
    for population in SCALE_POPULATIONS:
        ledger_ = accounting.StreamLedger(table, omc, 4)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (new, m, store), got = _counted(one_round, population, 0, storage, ledger_)
        wall = time.perf_counter() - t0
        counts.append(got)
        rows.append(dict(population=population, round_s=wall,
                         updates_per_s=(m["cohort"] + m["dropped"]) / wall, chunks=m["chunks"],
                         bound=ledger_.peak_bound_bytes(),
                         peak=torch.cuda.max_memory_allocated(),
                         counter_bytes=store.bytes_report()["counter_bytes"], loss=m["loss"]))
        require(math.isfinite(m["loss"]), f"population {population}: loss {m}")
        del new
    require(len({r["bound"] for r in rows}) == 1, f"the bound moved with the population: {rows}")
    peaks = [r["peak"] for r in rows]
    require(max(peaks) <= SCALE_PEAK_RATIO * min(peaks), f"peaks grew with the population: {rows}")
    print("  (b) bounded memory, cohort 16, capacity 4, 4 shards (warmed by (a)): " + "; ".join(
              f"population {r['population']:,}: {r['round_s']:.2f} s a round, "
              f"{r['updates_per_s']:.2f} updates/s, {r['chunks']} chunks, bound "
              f"{r['bound']:,} B, peak {r['peak']:,} B (max_memory_allocated), host counters "
              f"{r['counter_bytes']:,} B" for r in rows)
          + f"; peaks {max(peaks) / min(peaks):.3f}x apart")
    return dict(rows=rows, counts=_plus(*counts))


def scale_ef(params, omc, engine_topk=None) -> dict:
    """(c) Top-k 0.1 with error feedback at population 16, cohort 8,
    capacity 4, one round: an f32 store against the engine's dense EF
    (``engine_topk``: phase 17's round, run here when not given), then a
    packed S1E3M7 store, its words for one chunk against the CPU's plain
    encode of the same rows, its decode against the CPU's plain decode."""
    cfg, specs, layout = TRAIN_CFG, conformer.param_specs(TRAIN_CFG), scale.ShardLayout(16, 2)
    data_fn, key = async_data(TRAIN_CFG, 16), prng.PRNGKey(0)
    strategy = compress.get_strategy("topk", density=0.1)
    if engine_topk is None:
        ef = compress.feedback.init_ef_state(params, specs, omc, 16)
        torch.cuda.reset_peak_memory_stats()
        storage, hist = engine.run_training_vectorized(
            conformer, cfg, omc, STRAT_SIM, engine.CohortSpec(STRAT_PLAN), data_fn, key, 1,
            init_params=params, wire=False, strategy=strategy, ef=ef)
        engine_topk = dict(storage=storage, history=hist, peak=torch.cuda.max_memory_allocated())
        del ef
    runs, counts = {}, []
    for fmt in (None, FMT):
        name = fmt.name if fmt else "f32"
        store = scale.PopulationStore(layout)
        store.init_ef(params, specs, omc, ef_fmt=fmt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (storage, hist, _), got = _counted(
            scale.run_training_sharded, conformer, cfg, omc, STRAT_SIM, STRAT_PLAN, layout,
            data_fn, key, 1, capacity=4, strategy=strategy, store=store, wire=False,
            init_params=params)
        wall = time.perf_counter() - t0
        counts.append(got)
        require_launches(got, f"store {name}", quantize_stats=None, dequantize=None,
                         **({"pack": None, "unpack": None} if fmt else {}))
        runs[name] = dict(store=store, storage=storage, history=hist, wall=wall, counts=got,
                          peak=torch.cuda.max_memory_allocated(), report=store.bytes_report())
    gap = tree_gap(runs["f32"]["storage"], engine_topk["storage"])
    require(gap[0] <= SCALE_EF_MAX and gap[1] <= SCALE_EF_MEAN,
            f"f32 store against the engine's dense EF: {gap}")
    require(abs(runs["f32"]["history"][0]["loss"] - engine_topk["history"][0]["loss"]) < 1e-3,
            f"losses {runs['f32']['history']} {engine_topk['history']}")
    packed, raw = runs[FMT.name]["store"], runs["f32"]["store"]
    rep = runs[FMT.name]["report"]
    require(rep["ef_at_rest_bytes"] < 0.5 * rep["ef_fp32_bytes"], f"at rest {rep}")
    # one chunk: the first alive clients of the round, at most 4
    moved = np.flatnonzero(packed.event_counters)[:4]
    require(moved.size > 0, "no client uploaded")
    checked = {}
    card_rows = packed.gather_ef(moved)  # a comparison: B4 unpack and B2, not counted
    for name in SCALE_CHECK_LEAVES:
        var, rvar = packed._ef[name], raw._ef[name]
        want_words, want_s, want_b = scale.store.encode_rows(torch.from_numpy(rvar.raw[moved]),
                                                             FMT)
        require(np.array_equal(var.words[moved], want_words.numpy()),
                f"{name}: the store's words differ from the plain encode of the same rows")
        s_gap = np.abs(var.s[moved] - want_s.numpy()) / np.abs(want_s.numpy())
        # b relative to the row's largest |value| (a drained row, all zeros,
        # must give b = 0 exactly)
        rows_max = np.abs(rvar.raw[moved]).reshape(moved.size, -1).max(1)
        b_gap = np.abs(var.b[moved] - want_b.numpy()) / np.where(rows_max > 0, rows_max, np.inf)
        require(bool(np.all((rows_max > 0) | (var.b[moved] == 0))), f"{name}: b of a zero row")
        require(s_gap.max() <= 1e-5 and b_gap.max() <= 1e-5, f"{name}: (s, b) {s_gap} {b_gap}")
        plain = scale.store.decode_rows(torch.from_numpy(var.words[moved]),
                                        torch.from_numpy(var.s[moved]),
                                        torch.from_numpy(var.b[moved]), FMT, var.shape)
        require(torch.equal(card_rows[name].cpu(), plain),
                f"{name}: the card's decode differs from the plain decode")
        checked[name] = (var.n, float(s_gap.max()), float(b_gap.max()))
    del card_rows
    eng_peak = engine_topk["peak"]
    print(f"  (c) top-k 0.1 + EF, population 16, cohort 8, capacity 4: f32 store "
          f"{runs['f32']['wall']:.2f} s, trees against the engine's dense EF max |d| "
          f"{gap[0]:.3g}, mean |d| {gap[1]:.3g} (gates {SCALE_EF_MAX:g} / {SCALE_EF_MEAN:g}); "
          f"packed {FMT.name} store {runs[FMT.name]['wall']:.2f} s, at rest "
          f"{rep['ef_at_rest_bytes']:,} B against f32 {rep['ef_fp32_bytes']:,} B "
          f"({rep['ef_at_rest_bytes'] / rep['ef_fp32_bytes']:.4f}); clients {moved.tolist()}: "
          f"words the plain encode's bit for bit, decode the plain decode's, (s, b) within 1e-5 "
          f"relative on {checked}; peak f32 store {runs['f32']['peak'] / 1e9:.2f} GB, packed "
          f"{runs[FMT.name]['peak'] / 1e9:.2f} GB, the engine's dense EF "
          f"{eng_peak / 1e9:.2f} GB (its [16, ...] residuals on the card: "
          f"{4 * 16 * sum(v.n for v in raw._ef.values()) / 1e9:.2f} GB); launches "
          f"{runs[FMT.name]['counts']}")
    return dict(packed=packed, counts=_plus(*counts), gap=gap, report=rep,
                walls={k: r["wall"] for k, r in runs.items()},
                peaks={k: r["peak"] for k, r in runs.items()}, engine_peak=eng_peak)


def scale_checkpoints(params, omc, packed) -> dict:
    """(d) The packed store through ``save_population_state`` into a fresh
    store, bit-equal; a population-backed ``AsyncRunner`` at 2 layers (4
    clients, buffer 2, one flush) with the dict-backed run's counters, its
    checkpoint stamped with the layout."""
    shutil.rmtree(SCALE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    path = ck.save_population_state(str(SCALE_DIR / "store"), 1, packed)
    save_s = time.perf_counter() - t0
    fresh = scale.PopulationStore(packed.layout)
    fresh.init_ef(params, conformer.param_specs(TRAIN_CFG), omc, ef_fmt=FMT)
    t0 = time.perf_counter()
    ck.restore_population_state(path, fresh)
    restore_s = time.perf_counter() - t0
    a, b = packed.state_tree(), fresh.state_tree()
    require(all(np.array_equal(a[k], b[k]) for k in ("round_counters", "event_counters"))
            and all(np.array_equal(a["ef"][n][f], b["ef"][n][f]) for n in a["ef"]
                    for f in ("words", "s", "b")), "the restored store differs")
    disk = sum(p.stat().st_size for p in Path(path).iterdir())

    cut = dataclasses.replace(TRAIN_CFG, n_layers=2)
    small = conformer.init(prng.PRNGKey(0), cut, "cuda")
    acfg, trace = straggler(4, 2)
    layout = scale.ShardLayout(4, 2)
    runs, counts = {}, {}
    for backed in (False, True):
        store = scale.PopulationStore(layout) if backed else None
        runner = async_engine.AsyncRunner(conformer, cut, omc, ASYNC_SIM, acfg, trace,
                                          num_clients=4, data_fn=async_data(cut, 4),
                                          init_params=small, population=store)
        _, counts[backed] = _counted(runner.run_until, flushes=1)
        runs[backed] = runner
    plain, pop = runs[False], runs[True]
    require(isinstance(pop.round_counters, scale.ArrayCounters)
            and dict(pop.round_counters.items()) == plain.round_counters
            and dict(pop.event_counters.items()) == plain.event_counters
            and pop.history == plain.history and trees_bit_equal(pop.storage, plain.storage),
            f"population-backed async: counters {dict(pop.round_counters.items())} "
            f"{plain.round_counters}, history {pop.history} {plain.history}")
    apath = ck.save_async_state(str(SCALE_DIR / "async"), pop, keep=1)
    with open(Path(apath) / "manifest.json") as f:
        extra = json.load(f)["extra"]
    require(extra["population_layout"] == layout.describe() and extra["event_counters"] is None,
            f"async checkpoint stamp {extra['population_layout']}")
    print(f"  (d) packed store checkpoint {disk:,} B on disk, save {save_s:.2f} s, restore "
          f"{restore_s:.2f} s, restored bit-equal; population-backed async runner (2 layers, 4 "
          f"clients, buffer 2, 1 flush): counters, history and storage the dict-backed run's, "
          f"checkpoint stamped {extra['population_layout']}; launches {counts[True]}")
    return dict(counts=counts[True], disk=disk, save_s=save_s, restore_s=restore_s)


def scale_serve(omc) -> dict:
    """(e) ``run_serve_under_swap`` on the demo's transformer (4 layers,
    d 128, vocab 512): 2 payloads, 4 queries each; 2 swaps, the stall under
    10x, ``dequant_matmul`` launched."""
    cfg = transformer.TransformerConfig(n_layers=4, d_model=128, n_heads=8, n_kv_heads=4,
                                        d_ff=256, vocab=512)
    specs = transformer.param_specs(cfg)
    key = prng.PRNGKey(1)
    params = transformer.init(key, cfg, "cuda")
    sess = ServeSession(transformer, cfg, compress_params(params, specs, omc))
    payloads = []
    for i in range(2):
        k = prng.fold_in(key, i + 1)
        payloads.append(codecs.encode_payload(compress_params(
            tree_map(lambda p: p + 0.01 * prng.normal(k, p.shape, p.device), params), specs, omc),
            round_index=i + 1))
    stats, counts = _counted(
        scale.run_serve_under_swap, sess, payloads,
        make_query=lambda i: scale.synthetic_token_batch(1, 4, cfg.vocab, seed=i),
        queries_per_swap=4, decode_steps=4)
    require_launches(counts, "serve under swap", dequant_matmul=None, unpack=None,
                     dequantize=None)
    require(stats["swaps"] == 2 and stats["swap_stall_ratio"] < SCALE_STALL,
            f"serve under swap: {stats}")
    print(f"  (e) serve under swap (the demo's transformer): {stats}; launches {counts}")
    return dict(stats=stats, counts=counts)


def phase_scale(engine_fused=None, engine_unfused=None, engine_topk=None) -> dict:
    """The population runtime at full width (phase 7's configuration).
    ``engine_fused``: phase 7's warm round; ``engine_unfused``: phase 17's
    strategy-None round (both ``(storage, history)``); ``engine_topk``: phase
    17's top-k + EF round ``{storage, history, peak}``; each is run here when
    not given.  Part (c) runs under deterministic algorithms, as phase 17
    does: its f32 store must give the engine's residual rows."""
    omc = OMCConfig.parse(FMT.name)
    params = conformer.init(prng.PRNGKey(0), TRAIN_CFG, "cuda")

    def store_backed_ef():
        with deterministic_algorithms():
            return scale_ef(params, omc, engine_topk)

    times, parts = {}, {}
    steps = (("(a) sharded against the engine",
              lambda: scale_vs_engine(params, omc, engine_fused, engine_unfused)),
             ("(b) bounded memory", lambda: scale_memory(params, omc)),
             ("(c) store-backed EF", store_backed_ef),
             ("(d) checkpoints and async", lambda: scale_checkpoints(
                 params, omc, parts["(c) store-backed EF"]["packed"])),
             ("(e) serve under swap", lambda: scale_serve(omc)))
    for name, fn in steps:
        t0 = time.perf_counter()
        parts[name] = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    counts = _plus(*(p["counts"] for p in parts.values()))
    require_launches(counts, "scale", quantize_stats=None, dequantize=None, pack=None,
                     unpack=None, dequant_matmul=None)
    print("  parts: " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    return dict(counts=counts, times=times, parts=parts,
                packed=parts["(c) store-backed EF"].pop("packed"))


# ---------------------------------------------------------------------------
# 20. launch and roofline on the card
# ---------------------------------------------------------------------------

SERVE_CACHE_LEN = 4 * (32 + 16)  # serve_full_width's decode state: 4 x (prompt + new tokens)
LAUNCH_ARCHS = (("qwen2.5-3b", transformer, CFG, QWEN_PER_FORWARD),
                ("recurrentgemma-2b", griffin, GCFG, GRIFFIN_PER_FORWARD))


def to_host(tree, arch_id: str):
    """A served storage tree copied to host memory, where it waits for phase
    20 (kept on the card, it would add its bytes to phases 7-19's peaks)."""
    t0 = time.perf_counter()
    out = tree_map(lambda x: x.to("cpu"), tree)
    print(f"  {arch_id}'s served storage to the host for phase 20: "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def launch_dryrun_vs_card(arch_id: str, family, cfg, per_forward: dict, storage,
                          overrides=None) -> dict:
    """(a) The dry-run's meta build of the served cell (``make_host_mesh(1,
    1)``, S1E3M7, batch 4, the serve path's f32 cache of ``SERVE_CACHE_LEN``)
    against the same objects on the card: every leaf's shape and dtype, and
    the predicted ``argument_size_in_bytes`` equal to the card's nbytes
    exactly; ``memory_allocated`` around placing them printed beside (a
    tree already on the card is not copied).  The meta trace of one decode
    step calls each kernel as often as a forward pass launched it in phase
    3, 5 or 21.  ``overrides``: the served depth, as ``--set`` gives it."""
    mesh = launch_mesh.make_host_mesh(1, 1)
    t0 = time.perf_counter()
    cell = dryrun.build_cell(arch_id, Shape("phase3", "decode", SERVE_CACHE_LEN, 4), mesh=mesh,
                             fmt=FMT.name, cache_dtype=torch.float32, overrides=overrides)
    require(cell.cfg == cfg, f"{arch_id}: the meta cell's config {cell.cfg} is not the served one")
    counter = dryrun.trace_cell(cell)
    meta_s = time.perf_counter() - t0
    predicted = dryrun.argument_bytes(cell)
    calls = {k[len("kernel."):]: v for k, v in counter.ops.items() if k.startswith("kernel.")}
    require(calls == per_forward, f"{arch_id}: the meta decode step calls {calls}, a forward pass "
            f"on the card launched {per_forward}")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    card = dict(params=tree_map(lambda x: x.to("cuda"), storage),
                cache=family.init_decode_state(cfg, 4, SERVE_CACHE_LEN, dtype=torch.float32,
                                               device="cuda"),
                batch=dict(tokens=torch.zeros((4, 1), dtype=torch.int64, device="cuda")))
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    placed = dict(params=launch_specs.annotate_tree(card["params"], family.param_specs(cfg), mesh),
                  cache=launch_specs.annotate_cache(card["cache"], cell.arch.FAMILY, cfg, mesh),
                  batch=launch_specs.annotate_batch(card["batch"], mesh))
    nbytes = {}
    for name, tree in placed.items():
        got = list(dryrun.sharded_leaves(tree))
        want = list(dryrun.sharded_leaves(cell.inputs[name]))
        require(len(got) == len(want) > 0, f"{arch_id} {name}: {len(got)} leaves, {len(want)} "
                f"predicted")
        for g, w in zip(got, want):
            require(g.shape == w.shape and g.dtype == w.dtype and g.value.is_cuda,
                    f"{arch_id} {name}: card {tuple(g.shape)} {g.dtype}, meta {tuple(w.shape)} "
                    f"{w.dtype}")
        nbytes[name] = sum(g.value.nbytes for g in got)
    require(predicted == nbytes, f"{arch_id}: predicted {predicted}, on the card {nbytes}")
    total = sum(nbytes.values())
    print(f"  (a) {arch_id}: predicted argument_size_in_bytes {sum(predicted.values()):,} B "
          f"({predicted}) = the card's nbytes {total:,} B; memory_allocated around placing "
          f"them {allocated:,} B ({allocated / total:.6f}x); meta build and decode-step trace "
          f"{meta_s:.2f} s, kernel calls {calls}")
    del card, placed
    return dict(predicted=predicted, nbytes=nbytes, allocated=allocated, meta_s=meta_s,
                calls=calls)


def launch_kernels_micro() -> dict:
    """(b) ``benchmarks_torch/kernels_micro.py`` in card mode, in process:
    every moved byte count within 2x of its roofline bound."""
    km = importlib.import_module("benchmarks_torch.kernels_micro")
    out = km.run(smoke=False, device="cuda")
    for r in out["bitpack"]:
        for key in ("moved_over_bound", "unpack_moved_over_bound"):
            require(r[key] <= km.MAX_MOVED_OVER_BOUND, f"B4 width {r['width']}: {key} {r[key]}")
    for r in out["fused_aggregate"]:
        require(r["moved_over_bound"] <= km.MAX_MOVED_OVER_BOUND, f"B5 {r['fmt']}: {r}")
    for r in out["codec"]:
        print(f"  (b) {r['kernel']} {r['fmt']} {r['shape']}: {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share {r['share']:.3f}; plain "
              f"{r['plain_ms']:.4f} ms")
    for r in out["bitpack"]:
        print(f"  (b) B4 width {r['width']}, n {r['n']:,}: pack {r['pack_ms']:.4f} / unpack "
              f"{r['unpack_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, moved/bound "
              f"{r['moved_over_bound']:.4f} / {r['unpack_moved_over_bound']:.4f}")
    for r in out["fused_aggregate"]:
        print(f"  (b) B5 {r['fmt']} cohort {r['cohort']}, n {r['n']:,}: {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms, moved/bound {r['moved_over_bound']:.4f}; plain "
              f"{r['plain_ms']:.4f} ms")
    return out


def launch_device_ef(packed) -> dict:
    """(c) ``PopulationStore.device_ef`` on phase 19 (c)'s packed S1E3M7
    store: the population mesh clamped to the one card, every row decoded
    there (B4 ``unpack`` + B2) the same bits as ``gather_ef``'s."""
    mesh = launch_mesh.make_population_mesh(num_shards=4)
    require(mesh.axis_names == ("clients",) and mesh.devices.shape == (1,)
            and mesh.devices.flat[0].type == "cuda", f"population mesh {mesh.devices}")
    ids = np.arange(packed.layout.num_clients)
    rows, counts = _counted(packed.device_ef, mesh)
    require_launches(counts, "device_ef", unpack=None, dequantize=None)
    want = packed.gather_ef(ids)  # the comparison: not counted
    for name, v in rows.items():
        require(v.sharding.spec == () and v.value.is_cuda and v.shape[0] == ids.size,
                f"device_ef {name}: {v.sharding} {tuple(v.shape)}")
        require(bit_equal(v.value, want[name]), f"device_ef {name}: rows differ from gather_ef")
    nonzero = sum(int(bool((v.value != 0).any())) for v in rows.values())
    print(f"  (c) device_ef on the packed {packed.ef_fmt.name} store: {ids.size} clients x "
          f"{len(rows)} leaves on the population mesh clamped to {mesh.devices.size} card "
          f"(num_shards 4), replicated; every row the same bits as gather_ef's ({nonzero} "
          f"leaves with non-zero rows); launches {counts}")
    return dict(counts=counts, leaves=len(rows))


def phase_launch(served=None, packed=None, mixtral=None) -> dict:
    """``served``: ``{arch_id: host storage tree}`` from phases 3 and 5;
    ``packed``: phase 19 (c)'s packed store; ``mixtral``: phase 21 (a)'s
    storage, on the card.  Each is made here when not given (the phase run
    alone)."""
    if served is None:
        served = {}
        for arch_id, *_ in LAUNCH_ARCHS:
            sess = serve_full_width(arch_id, more_batches=0)["session"]
            served[arch_id] = to_host(sess.storage, arch_id)
            del sess
    if mixtral is None:
        mixtral = zoo_serve("mixtral-8x7b", roundtrip=False, gen=1)["session"].storage
    if packed is None:
        packed = scale.PopulationStore(scale.ShardLayout(16, 2))
        shapes = conformer.init(prng.PRNGKey(0), TRAIN_CFG, "meta")
        packed.init_ef(shapes, conformer.param_specs(TRAIN_CFG), OMCConfig.parse(FMT.name),
                       ef_fmt=FMT)
        g = torch.Generator(device="cuda").manual_seed(5)
        packed.scatter_ef([2, 9], {k: torch.randn((2,) + v.shape, generator=g, device="cuda")
                                   * 0.01 for k, v in packed._ef.items()})
    parts, times = {}, {}
    for arch_id, family, cfg, per_forward in LAUNCH_ARCHS:
        t0 = time.perf_counter()
        parts[arch_id] = launch_dryrun_vs_card(arch_id, family, cfg, per_forward,
                                               served.pop(arch_id))
        times[f"(a) {arch_id}"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    depth = ZOO_DEPTH["mixtral-8x7b"][0]
    mcfg = dataclasses.replace(get_arch("mixtral-8x7b").config(), n_layers=depth)
    t0 = time.perf_counter()
    parts["mixtral-8x7b"] = launch_dryrun_vs_card("mixtral-8x7b", moe, mcfg, zoo_formula(mcfg),
                                                  mixtral, overrides={"n_layers": str(depth)})
    times["(a) mixtral-8x7b"] = time.perf_counter() - t0
    del mixtral
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    micro = launch_kernels_micro()
    micro_counts = ops.launch_counts()
    times["(b) kernels_micro"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ef = launch_device_ef(packed)
    times["(c) device_ef"] = time.perf_counter() - t0
    counts = _plus(micro_counts, ef["counts"])
    require_launches(counts, "launch", quantize=None, dequantize=None, dequant_matmul=None,
                     pack=None, unpack=None, fused_aggregate=None)
    print("  parts: " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    return dict(counts=counts, parts=parts, micro=micro, times=times)


# ---------------------------------------------------------------------------
# 21. the decoder-only zoo at full width
# ---------------------------------------------------------------------------

# depth cuts at full width: S1E3M7 codes (2 B) beside the f32 init (4 B) take
# 6 B a parameter, and one card holds 80 GB; the rest serve at full depth
ZOO_DEPTH = {
    "mixtral-8x7b": (4, "46.70 B parameters need 93.4 GB of S1E3M7 codes alone; 4 of 32 "
                        "layers (1.45 B each) with the embedding and head keep the f32 init "
                        "and the codes near 35 GB, and the init and wire roundtrip within "
                        "phase 21's time"),
    "dbrx-132b": (2, "131.6 B parameters (3.26 B a layer); 2 of 40 layers with the 1.23 B "
                     "embedding and head, about 47 GB with the f32 init"),
    "mistral-nemo-12b": (2, "12.2 B parameters need 73.5 GB at 6 B each, too close to 80 GB; "
                            "2 of 40 layers"),
    "qwen1.5-110b": (1, "111.2 B parameters (1.36 B a layer); 1 of 80 layers beside the "
                        "2.49 B untied embedding and head"),
    "internvl2-1b": (None, "full depth (0.63 B parameters)"),
    "h2o-danube-3-4b": (None, "full depth (3.96 B parameters, about 24 GB with the f32 init)"),
}
ZOO_KERNELS = ("quantize_stats", "dequantize", "dequant_matmul")  # a serve without the wire
ROUTE_GAP = 1e-3  # C26: a routing flip's k-th and (k+1)-th probabilities within this, relative
ZOO_RING_PROMPT = 4128  # phase 21 (e): past h2o's 4,096-slot ring
EP_GAP = 1e-4  # phase 21 (b): ep_partitions 2 against 1, relative to the largest logit


def zoo_formula(cfg) -> dict:
    """Launches a forward pass: the block matrices through dequant_matmul (a
    MoE layer: attention's 4 and each stored expert's 3), and through
    dequantize the embedding rows, the head and each MoE layer's router."""
    if isinstance(cfg, moe.MoEConfig):
        return dict(dequant_matmul=cfg.n_layers * (4 + 3 * cfg.stored_experts),
                    dequantize=cfg.n_layers + 2)
    return dict(dequant_matmul=7 * cfg.n_layers, dequantize=2)


def zoo_cpu_per_forward(arch_id: str, layers: int) -> dict:
    """A CPU dry run at the smoke config's widths (with the full config's
    experts and top-k), 1 and 2 layers, counting the plain versions' launches
    of one prefill; the per-layer and fixed counts scaled to ``layers``."""
    arch = get_arch(arch_id)
    full, family = arch.config(), get_family(arch.FAMILY)
    counts = []
    for n in (1, 2):
        cfg = dataclasses.replace(arch.smoke_config(), n_layers=n)
        if isinstance(full, moe.MoEConfig):
            cfg = dataclasses.replace(cfg, n_experts=full.n_experts, top_k=full.top_k)
        storage = compress_params(family.init(prng.PRNGKey(0), cfg, "cpu"),
                                  family.param_specs(cfg), OMCConfig.parse(FMT.name))
        batch = serve.request_batch(prng.PRNGKey(0), arch.FAMILY, cfg, 2, 4, "cpu")
        ops.reset_launch_counts()
        family.prefill(cfg, storage, batch, materialize.OMCMaterializer(),
                       family.init_decode_state(cfg, 2, 16, dtype=torch.float32, device="cpu"))
        counts.append({k[:-len(".ref")]: v for k, v in ops.launch_counts().items()})
    return {op: counts[0][op] + (counts[1][op] - counts[0][op]) * (layers - 1)
            for op in counts[0]}


def zoo_serve(arch_id: str, roundtrip: bool, gen: int = 16) -> dict:
    """``serve.run`` of one zoo arch at full width and its depth, the
    launches a forward pass exactly ``zoo_formula``'s and the CPU dry run's."""
    layers, why = ZOO_DEPTH[arch_id]
    cfg = get_arch(arch_id).config()
    depth = layers or cfg.n_layers
    print(f"  {arch_id}: {depth} of {cfg.n_layers} layers at full width (d {cfg.d_model}, "
          f"vocab {cfg.vocab:,}); {why}")
    served = serve_full_width(arch_id, more_batches=0, layers=layers, roundtrip=roundtrip,
                              gen=gen)
    report, sess = served["report"], served["session"]
    want = zoo_formula(sess.cfg)
    predicted = zoo_cpu_per_forward(arch_id, depth)
    require(predicted == want, f"{arch_id}: the CPU dry run predicts {predicted}, the "
            f"formula {want}")
    require_per_forward(report["launch_counts"], arch_id, report["forward_passes"], want,
                        SERVE_KERNELS if roundtrip else ZOO_KERNELS)
    print(f"  {arch_id}: {want} a forward pass, as the CPU dry run at the smoke widths "
          f"predicts, over {report['forward_passes']} passes")
    served.update(depth=depth, why=why, per_forward=want)
    return served


@contextlib.contextmanager
def recorded_routes(log: list):
    """Inside, each ``moe._route`` call appends (probs, ids, gates) on the host."""
    route = moe._route

    def recording(x2d, router_w, cfg):
        out = route(x2d, router_w, cfg)
        log.append((torch.softmax((x2d @ router_w).float(), -1).cpu(), out[1].cpu(),
                    out[0].cpu()))
        return out

    moe._route = recording
    try:
        yield log
    finally:
        moe._route = route


def kept_pairs(gates, ids, cfg, capacity: int) -> torch.Tensor:
    """[T * k] bool: the (token, expert) pairs inside their expert's capacity,
    by the dispatch's rule."""
    flat_g, flat_e = gates.reshape(-1), ids.reshape(-1)
    kept = torch.zeros(flat_e.shape, dtype=torch.bool)
    for e in range(cfg.n_experts):
        v, i = moe.top_k(torch.where(flat_e == e, flat_g, -1.0), capacity)
        kept[i[v > 0]] = True
    return kept


def near_tie(probs: torch.Tensor, k: int) -> float:
    """Relative gap between a token's k-th and (k+1)-th router probabilities."""
    top = torch.sort(probs, descending=True).values
    return ((top[k - 1] - top[k]) / top[k - 1]).item()


def zoo_steps(sess, tokens, decode_steps: int, pick=None, log=None) -> list:
    """Prefill and ``decode_steps`` decode steps (the tokens of ``pick``, else
    the argmax); the logits on the host; routes recorded into ``log``."""
    with recorded_routes(log if log is not None else []):
        c, lg = sess.prefill(dict(tokens=tokens), sess.init_cache(tokens.shape[0], 64))
        out = [lg.cpu()]
        for i in range(decode_steps):
            tok = (pick[i] if pick else torch.argmax(out[-1][:, -1], dim=-1))[:, None]
            c, lg = sess.decode_step(c, tok.to(tokens.device))
            out.append(lg.cpu())
    return out


def reslice_experts(cv, parts: int, down: bool):
    """An expert stack ``[L, E, D, F]`` (``w2``: ``[L, E, F, D]``) in code form
    as ``[L, E * parts, D, F / parts]``: each expert's FFN dim split over
    ``parts`` stored experts, the same codes and (s, b)."""
    twin = cv.codes.view(SIGNED_TWIN[cv.codes.dtype])  # copies cover the signed dtypes
    n, e, r, c = twin.shape
    if down:
        out = twin.reshape(n, e * parts, r // parts, c)
    else:
        out = twin.reshape(n, e, r, parts, c // parts).permute(0, 1, 3, 2, 4).reshape(
            n, e * parts, r, c // parts)
    return type(cv)(out.contiguous().view(cv.codes.dtype), cv.s, cv.b, cv.fmt)


def zoo_mixtral_card_vs_cpu(sess) -> dict:
    """(b) mixtral at 1 layer of full width, prompt 8, 2 decode tokens, batch
    4: the card (kernels) against the CPU over the same codes decoded once as
    the plain version decodes (:func:`plain_decoded`).  Routing
    flips counted, each checked to be a near-tie on both sides (ROADMAP C26),
    logits compared on the rows that never flipped; then ``ep_partitions=2``
    on the card over the same codes resliced, against ``ep_partitions=1``."""
    st = sess.storage
    cut = dict(embed=st["embed"], final_norm=st["final_norm"], lm_head=st["lm_head"],
               blocks={k: v[:1] for k, v in st["blocks"].items()})
    cfg = dataclasses.replace(sess.cfg, n_layers=1)
    g = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (4, 8), generator=g, device="cuda")
    card_log, host_log = [], []
    gpu = ServeSession(moe, cfg, cut)
    t0 = time.perf_counter()
    card = zoo_steps(gpu, toks, 2, log=card_log)
    again = zoo_steps(gpu, toks, 2)
    card_s = time.perf_counter() - t0
    require(all(bit_equal(x, y) for x, y in zip(card, again)),
            "mixtral: the card's logits differ between two runs of the same requests")
    picks = [torch.argmax(lg[:, -1], dim=-1) for lg in card[:2]]
    t0 = time.perf_counter()
    decoded = plain_decoded(tree_map(lambda x: x.to("cpu"), cut))
    host = zoo_steps(ServeSession(moe, cfg, decoded), toks.cpu(), 2, picks, host_log)
    host_s = time.perf_counter() - t0
    del decoded
    # flips: a token whose chosen experts differ, or a pair kept on one side only
    rows_of = [lambda t: t // 8] + [lambda t: t] * 2  # prefill's 4 x 8 tokens, then 4
    excluded, flips, cap_flips, gaps = set(), 0, 0, []
    for step, ((pc, ic, gc), (ph, ih, gh)) in enumerate(zip(card_log, host_log)):
        tokens = ic.shape[0]
        cap = moe._capacity(tokens, cfg)
        same = (ic.sort(-1).values == ih.sort(-1).values).all(-1)
        kc = kept_pairs(gc, ic, cfg, cap).reshape(tokens, -1)
        kh = kept_pairs(gh, ih, cfg, cap).reshape(tokens, -1)
        step_cap = 0
        for t in range(tokens):
            if same[t] and torch.equal(kc[t], kh[t]):
                continue
            if same[t]:
                step_cap += 1
            else:
                flips += 1
                gap = max(near_tie(pc[t], cfg.top_k), near_tie(ph[t], cfg.top_k))
                gaps.append(gap)
                require(gap <= ROUTE_GAP, f"mixtral: token {t} of step {step} routes to "
                        f"{ic[t].tolist()} on the card, {ih[t].tolist()} on the CPU, with its "
                        f"k-th and (k+1)-th probabilities {gap:.3g} apart (C26 allows "
                        f"{ROUTE_GAP})")
            excluded.add(rows_of[step](t))
        load = max(torch.bincount(x.reshape(-1), minlength=cfg.n_experts).max().item()
                   for x in (ic, ih))
        require(step_cap == 0 or load > cap, "mixtral: a capacity flip with no expert full")
        cap_flips += step_cap
    diffs = []
    for step, (lc, lh) in enumerate(zip(card, host)):
        rows = [r for r in range(4) if r not in excluded]
        if rows:
            diffs.append((lc[rows] - lh[rows]).abs().max().item())
    worst = max(diffs) if diffs else 0.0
    require(worst <= 1e-3, f"mixtral: card and CPU logits differ by {worst} on unflipped rows")
    # ep_partitions=2 on the card over the same codes, resliced
    cfg2 = dataclasses.replace(cfg, ep_partitions=2)
    cut2 = dict(cut, blocks=dict(cut["blocks"], **{
        k: reslice_experts(cut["blocks"][k], 2, down=k == "w2") for k in ("w1", "w3", "w2")}))
    ep2 = zoo_steps(ServeSession(moe, cfg2, cut2), toks, 2, picks)
    # each expert's w2 product sums K = 14,336 terms in one launch with one
    # partition, in two of 7,168 with two: f32 reassociation, about
    # eps * sqrt(K) = 1.4e-5 of the hidden state's scale, and the largest of
    # 384,000 logits a few times that; gated at EP_GAP of each step's
    # largest logit (an absolute 1e-5 failed at 4.03e-5 on an H100)
    ep_rel = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(ep2, card))
    ep_diff = max((a - b).abs().max().item() for a, b in zip(ep2, card))
    require(ep_rel <= EP_GAP, f"mixtral: ep_partitions=2 differs from 1 by {ep_diff} "
            f"({ep_rel:.3g} of the largest logit)")
    print(f"  (b) mixtral 1 layer, batch 4, prompt 8, 2 decode steps: card {card_s:.1f} s "
          f"(twice, the same bits), CPU {host_s:.1f} s; routing flips {flips} (gaps {gaps}), "
          f"capacity flips {cap_flips}, rows excluded {sorted(excluded)}; max |logit diff| on "
          f"the rest per step {diffs}; ep_partitions=2 against 1 on the card: max |d| "
          f"{ep_diff:.3g}, {ep_rel:.3g} of the largest logit")
    return dict(flips=flips, capacity_flips=cap_flips, gaps=gaps, worst=worst, ep_diff=ep_diff,
                ep_rel=ep_rel, card_s=card_s, host_s=host_s)


def zoo_prefix_consistency(sess, arch_id: str, batch: int, prompt: int, cache_len: int,
                           cut=None) -> float:
    """prefill(n) + one decode step against prefill(n + 1), within the
    reference's 5e-4 (tests/test_models_smoke.py), with a cache of
    ``cache_len`` slots; ``cut``: a (cfg, storage) to serve instead."""
    cfg, storage = cut if cut else (sess.cfg, sess.storage)
    s = ServeSession(sess.family, cfg, storage)
    full = serve.request_batch(prng.PRNGKey(7), get_arch(arch_id).FAMILY, cfg, batch,
                               prompt + 1, "cuda")
    part = dict(full, tokens=full["tokens"][:, :prompt])
    _, la = s.prefill(full, s.init_cache(batch, cache_len))
    c, _ = s.prefill(part, s.init_cache(batch, cache_len))
    _, lb = s.decode_step(c, full["tokens"][:, prompt:prompt + 1])
    err = (la - lb).abs().max().item()
    require(bool(torch.isfinite(lb).all()) and torch.allclose(la, lb, rtol=5e-4, atol=5e-4),
            f"{arch_id}: prefill(n) + decode differs from prefill(n + 1) by {err}")
    return err


def phase_zoo() -> dict:
    """(a) mixtral-8x7b with the wire roundtrip, (b) its card against CPU and
    ``ep_partitions=2``, (c) dbrx-132b, (d) internvl2-1b with 1,024 patches,
    (e) h2o-danube-3-4b, and its ring wrap at 2 layers, (f) mistral-nemo-12b
    and qwen1.5-110b; (c)-(f) without the wire roundtrip, which (a) runs.  Counters zeroed around each serve (the main path);
    the comparisons are not counted.  Returns mixtral's storage, kept on the
    card for phase 20."""
    times, parts, counts = {}, {}, []

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    served = step("(a) mixtral-8x7b", zoo_serve, "mixtral-8x7b", True)
    counts.append(served["report"]["launch_counts"])
    parts["mixtral"] = {k: served["report"][k] for k in (
        "n_layers", "init_ms", "prefill_ms", "decode_ms_per_token", "max_memory_allocated",
        "payload_ratio", "roundtrip_ms")}
    parts["mixtral_card_vs_cpu"] = step("(b) mixtral card against CPU", zoo_mixtral_card_vs_cpu,
                                        served["session"])
    mixtral = served["session"].storage
    del served
    for name, arch_id, roundtrip, gen in (("(c)", "dbrx-132b", False, 16),
                                         ("(d)", "internvl2-1b", False, 16),
                                         ("(e)", "h2o-danube-3-4b", False, 16),
                                         ("(f)", "mistral-nemo-12b", False, 4),
                                         ("(f)", "qwen1.5-110b", False, 4)):
        served = step(f"{name} {arch_id}", zoo_serve, arch_id, roundtrip, gen)
        counts.append(served["report"]["launch_counts"])
        parts[arch_id] = {k: served["report"][k] for k in (
            "n_layers", "init_ms", "prefill_ms", "decode_ms_per_token", "max_memory_allocated")}
        sess = served.pop("session")
        if arch_id == "internvl2-1b":  # a cache that holds the whole prefixed stream
            err = step("(d) internvl2 prefix check", zoo_prefix_consistency, sess, arch_id, 4,
                       32, sess.cfg.prefix_embeds + 64)
            print(f"  (d) internvl2-1b, 1,024 patches + 32 tokens, batch 4: prefill(n) + "
                  f"decode against prefill(n + 1), max |d| {err:.3g}")
        if arch_id == "h2o-danube-3-4b":  # 2 layers, batch 1, past the 4,096-slot ring
            st = sess.storage
            cut = (dataclasses.replace(sess.cfg, n_layers=2),
                   dict(st, blocks={k: v[:2] for k, v in st["blocks"].items()}))
            err = step("(e) h2o ring wrap", zoo_prefix_consistency, sess, arch_id, 1,
                       ZOO_RING_PROMPT, 2 * ZOO_RING_PROMPT, cut)
            print(f"  (e) h2o-danube-3-4b, 2 layers, prompt {ZOO_RING_PROMPT} past the "
                  f"{sess.cfg.window}-slot ring: prefill(n) + decode against prefill(n + 1), "
                  f"max |d| {err:.3g}")
        del sess, served
        torch.cuda.empty_cache()
    print("  parts: " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    return dict(counts=_plus(*counts), parts=parts, times=times, mixtral=mixtral)


# ---------------------------------------------------------------------------
# 22. the last families: xlstm-350m and seamless-m4t-medium served, griffin
#     and xlstm trained through the driver's round
# ---------------------------------------------------------------------------

# launches a forward pass: every projection matrix through dequant_matmul;
# through dequantize the embedding rows, the head and (xlstm) each mLSTM
# block's conv_w and each sLSTM block's r_gates.  seamless' prefill runs the
# encoder (6 matrices a layer) and the decoder (10: the cross K/V from the
# memory once), its decode step the decoder alone (8: the cross K/V cached)
N_MLSTM = XCFG.n_layers - XCFG.n_slstm
XLSTM_PER_FORWARD = dict(dequant_matmul=6 * N_MLSTM + 2 * XCFG.n_slstm,
                         dequantize=2 + N_MLSTM + XCFG.n_slstm)
SEAMLESS_PREFILL = dict(dequant_matmul=6 * SCFG.n_enc_layers + 10 * SCFG.n_dec_layers,
                        dequantize=2)
SEAMLESS_DECODE = dict(dequant_matmul=8 * SCFG.n_dec_layers, dequantize=2)
LAST_GEN = 16  # phase 22's serves: batch 4, prompt 32, 16 new tokens
LAST_FRAMES = 4 * (32 + LAST_GEN)  # seamless' frames, as the serve CLI draws them
# (d): griffin trained at full depth when one round's peak is under 70 GB,
# else at the deepest whole super block that fits (None: full depth)
GRIFFIN_TRAIN_DEPTH = (None, "full depth")
LAST_TRAIN_ROUNDS = 2  # the driver's rounds on each (the first one warms up)


def last_cpu_per_forward(arch_id: str) -> tuple:
    """A CPU dry run at the smoke config's widths with the full config's
    layout (its layer counts and sLSTM ratio): the plain versions' launches
    in one prefill and one decode step, batch 2, prompt 4."""
    arch = get_arch(arch_id)
    full, family = arch.config(), get_family(arch.FAMILY)
    layout = {k: getattr(full, k) for k in serve.depth_fields(full)}
    if arch.FAMILY == "xlstm":
        layout["slstm_every"] = full.slstm_every
    cfg = dataclasses.replace(arch.smoke_config(), **layout)
    storage = compress_params(family.init(prng.PRNGKey(0), cfg, "cpu"),
                              family.param_specs(cfg), OMCConfig.parse(FMT.name))
    batch = serve.request_batch(prng.PRNGKey(0), arch.FAMILY, cfg, 2, 4, "cpu", 2)
    mat = materialize.OMCMaterializer()
    out = []
    ops.reset_launch_counts()
    state, logits = family.prefill(cfg, storage, batch, mat, family.init_decode_state(
        cfg, 2, 4 * (4 + 2), dtype=torch.float32, device="cpu"))
    out.append({k[:-len(".ref")]: v for k, v in ops.launch_counts().items()})
    ops.reset_launch_counts()
    family.decode_step(cfg, storage, state, torch.argmax(logits[:, -1], -1)[:, None], mat)
    out.append({k[:-len(".ref")]: v for k, v in ops.launch_counts().items()})
    return tuple(out)


def last_serve(arch_id: str, roundtrip: bool, per_prefill: dict, per_decode: dict) -> dict:
    """``serve.run`` at full width and full depth; the launches of the
    prefill and the 16 decode steps exactly the formula's, which the CPU dry
    run predicts; then prefill(n) + decode against prefill(n + 1) on the
    card within 5e-4, with a decode state that holds the whole stream."""
    predicted = last_cpu_per_forward(arch_id)
    require(predicted == (per_prefill, per_decode), f"{arch_id}: the CPU dry run predicts "
            f"{predicted}, the formula {(per_prefill, per_decode)}")
    served = serve_full_width(arch_id, more_batches=0, roundtrip=roundtrip, gen=LAST_GEN)
    report, sess = served["report"], served["session"]
    counts = report["launch_counts"]
    require_per_forward(counts, arch_id, 0, {}, SERVE_KERNELS if roundtrip else ZOO_KERNELS)
    for op in per_prefill:
        want = per_prefill[op] + LAST_GEN * per_decode[op]
        require(counts.get(f"{op}.cuda", 0) == want, f"{arch_id}: {op} launched "
                f"{counts.get(f'{op}.cuda', 0)} times in a prefill and {LAST_GEN} decode "
                f"steps, expected {want}: {counts}")
    err = zoo_prefix_consistency(sess, arch_id, 4, 32, 4 * 33)
    print(f"  {arch_id}: {per_prefill} a prefill and {per_decode} a decode step, as the CPU "
          f"dry run at the smoke widths predicts; prefill(n) + decode against prefill(n + 1), "
          f"max |d| {err:.3g}")
    served.update(per_prefill=per_prefill, per_decode=per_decode, prefix_err=err)
    return served


def last_card_vs_cpu(xsess, ssess) -> dict:
    """(c) Card against CPU at full width and cut depth on phase 4's
    vocabulary cut: xlstm-350m's first super block (7 mLSTM blocks and the
    sLSTM block, 8 layers), seamless-m4t-medium at 1 + 1 layers (its untied
    head's first 32,768 columns) over 192 frames; prefill and 1 decode step."""
    st = xsess.storage
    cut = dict(embed=vocab_cut(st["embed"]), final_norm=st["final_norm"],
               super_blocks={part: {k: v[:1] for k, v in leaves.items()}
                             for part, leaves in st["super_blocks"].items()})
    cfg8 = dataclasses.replace(XCFG, n_layers=XCFG.slstm_every, vocab=CUT_VOCAB)
    require((cfg8.n_super, cfg8.n_extra_m) == (1, 0), "xlstm cut")
    x = card_vs_cpu(f"xlstm-350m, 8 layers, vocab {CUT_VOCAB:,}", xlstm, cfg8, cut,
                    decode_steps=1)
    st = ssess.storage
    head = st["lm_head"]
    cut = dict(embed=vocab_cut(st["embed"]),
               lm_head=type(head)(head.codes[:, :CUT_VOCAB].contiguous(), head.s, head.b,
                                  head.fmt),
               enc_blocks={k: v[:1] for k, v in st["enc_blocks"].items()},
               dec_blocks={k: v[:1] for k, v in st["dec_blocks"].items()},
               **{k: v for k, v in st.items() if k.endswith(("_scale", "_bias"))})
    cfg1 = dataclasses.replace(SCFG, n_enc_layers=1, n_dec_layers=1, vocab=CUT_VOCAB)
    s = card_vs_cpu(f"seamless-m4t-medium, 1 + 1 layers, vocab {CUT_VOCAB:,}", encdec, cfg1,
                    cut, decode_steps=1, frames=LAST_FRAMES)
    return dict(xlstm=x, seamless=s)


def round_formula(params, backend: str = "cuda") -> dict:
    """B1/B2 launches of one driver round on a tied-head model, from its
    storage tree: one encode and one decode per compressed leaf at the
    update; in the forward pass and again in its recompute one decode per
    stacked entry of each compressed leaf but the embedding (one (s, b) an
    entry); the embedding's rows and the tied head once each."""
    comp = [(p, v) for p, v in tree_items(params) if is_compressed(v)]
    entries = sum(v.s.numel() for p, v in comp if p[0] != "embed")
    return {f"quantize_stats.{backend}": len(comp),
            f"dequantize.{backend}": len(comp) + 2 * entries + 2}


def last_train(arch_id: str) -> dict:
    """(d) ``launch.train.run`` at full width (S1E4M14, batch 8, 48 tokens,
    the LM task over 4,096 tokens), ``LAST_TRAIN_ROUNDS`` rounds; each
    round's launches the storage tree's formula, which the same driver on
    the CPU at the smoke config also launches on its own tree."""
    cpu = train.run(train.parse_args(["--arch", arch_id, "--smoke", "--device", "cpu",
                                      "--rounds", "1", "--quiet", "--batch", "2", "--seq", "16"]))
    want_cpu = round_formula(cpu["state"].params, "ref")
    require(cpu["round_launches"] == [want_cpu], f"{arch_id} on the CPU at the smoke config: "
            f"{cpu['round_launches']}, the formula {want_cpu}")
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    report = train.run(train.parse_args(["--arch", arch_id, "--rounds", str(LAST_TRAIN_ROUNDS),
                                         "--quiet"]))
    counts = ops.launch_counts()
    want = round_formula(report["state"].params)
    require(report["round_launches"] == [want] * LAST_TRAIN_ROUNDS,
            f"{arch_id}: rounds launched {report['round_launches']}, the formula {want}")
    require(all(math.isfinite(x) and 0 < x < 20 for x in report["losses"]),
            f"{arch_id}: bad losses {report['losses']}")
    rep = report["state_bytes"]
    print(f"  (d) {arch_id}: {rep['num_params']:,} parameters, S1E4M14, batch 8 x 48: round ms "
          f"{[round(x, 1) for x in report['round_ms']]}, peak "
          f"{report['max_memory_allocated'] / 1e9:.2f} GB, losses {report['losses']}, "
          f"launches a round {want} (the formula; on the CPU at the smoke config {want_cpu})")
    out = dict(round_ms=report["round_ms"], peak=report["max_memory_allocated"],
               losses=report["losses"], per_round=want, counts=counts,
               num_params=rep["num_params"])
    del report
    torch.cuda.empty_cache()
    return out


def phase_last(before_e=None) -> dict:
    """(a) xlstm-350m served with the wire roundtrip, and phase 20's meta
    prediction for its tree; (b) seamless-m4t-medium; (c) both card against
    CPU at cut depth; (d) the driver's rounds on recurrentgemma-2b and
    xlstm-350m; (e) griffin's round card against CPU at one super block.
    Counters are zeroed around each serve and each driver run (the main
    path); the comparisons are not counted.  ``before_e()``, where given,
    is called just before (e) (which times nothing) and its result returned
    under ``"before_e"``: phase 23 starts its subprocesses there."""
    times, parts, counts = {}, {}, []

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    keys = ("init_ms", "prefill_ms", "decode_ms_per_token", "max_memory_allocated")
    xs = step("(a) xlstm-350m", last_serve, "xlstm-350m", True, XLSTM_PER_FORWARD,
              XLSTM_PER_FORWARD)
    require(xs["report"]["num_params"] == 467_347_624, f"xlstm params {xs['report']['num_params']}")
    counts.append(xs["report"]["launch_counts"])
    parts["xlstm-350m"] = {k: xs["report"][k] for k in keys + ("payload_ratio", "roundtrip_ms")}
    parts["xlstm_meta"] = step("(a) xlstm meta prediction", launch_dryrun_vs_card, "xlstm-350m",
                               xlstm, XCFG, XLSTM_PER_FORWARD, xs["session"].storage)
    ss = step("(b) seamless-m4t-medium", last_serve, "seamless-m4t-medium", False,
              SEAMLESS_PREFILL, SEAMLESS_DECODE)
    require(ss["report"]["num_params"] == 877_383_680,
            f"seamless params {ss['report']['num_params']}")
    counts.append(ss["report"]["launch_counts"])
    parts["seamless-m4t-medium"] = {k: ss["report"][k] for k in keys}
    parts["card_vs_cpu"] = step("(c) card against CPU", last_card_vs_cpu, xs["session"],
                                ss["session"])
    del xs, ss
    torch.cuda.empty_cache()
    for arch_id in ("recurrentgemma-2b", "xlstm-350m"):
        parts[f"train {arch_id}"] = step(f"(d) train {arch_id}", last_train, arch_id)
        counts.append(parts[f"train {arch_id}"].pop("counts"))
    started = before_e() if before_e else None
    gcfg = dataclasses.replace(GCFG, n_layers=GCFG.pattern_period, vocab=LM_VOCAB)
    task = make_lm_task(vocab=LM_VOCAB, seq_len=32, num_clients=16, device="cuda")
    parts["griffin_round_card_vs_cpu"] = step(
        "(e) griffin round card against CPU", round_card_vs_cpu, "recurrentgemma-2b", griffin,
        gcfg, "S1E3M7", task.batch(0, 0, 0, 4), 1)
    print("  parts: " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    return dict(counts=_plus(*counts), parts=parts, times=times, before_e=started)


# ---------------------------------------------------------------------------
# 23. the reference's last scripts on the card
# ---------------------------------------------------------------------------

SCRIPTS_DIR = ROOT / "build" / "scripts"  # (b)'s checkpoints
SCRIPTS_ROUNDS, SCRIPTS_EVERY = 6, 3  # (b): train_100m --full cut to 6 rounds
SCRIPTS_TRAIN = ["--full", "--rounds", str(SCRIPTS_ROUNDS), "--ckpt-every", str(SCRIPTS_EVERY),
                 "--quiet"]
SCRIPTS_TRAIN_PARAMS = 103_535_104  # conformer_s
SCRIPT_TIMEOUT = 600  # seconds a script may take; its process group is killed after
# (d): the reference's default row as its own code prints it: `PYTHONPATH=src
# JAX_PLATFORMS=cpu python benchmarks/async_scale.py` at commit 8c82901, on a CPU.
# Not experiments/bench/async_scale.json, which predates that code (ROADMAP C30).
REFERENCE_ROW_EXACT = dict(update_budget=320, sync_updates_per_vs=0.8848,
                           async_updates_per_vs=26.9794, vtime_speedup=30.49,
                           sync_wire_mb=31.851, async_wire_mb=34.729,
                           async_stale_fraction=0.9493, async_dropped_fraction=0.0,
                           peak_in_flight_mb=6.405)
REFERENCE_ROW_LOSSES = dict(init_loss=3.1152, sync_loss=2.8296, async_loss=2.921)
REFERENCE_LOSS_GAP = 2e-3  # (d): absolute, each loss of the row against the reference's
WIRE_RE = re.compile(r"(?:[\w-]+=)?[\d.]+ ?MiB(?: \([\d.]+% of fp32\))?|[\w-]+=\d+B\b")
LOSS_RE = re.compile(r"loss=(\S+)")


def run_script(path: str, args, timeout: int = SCRIPT_TIMEOUT) -> tuple:
    """``python3 <path> <args>`` from the repo's root, exit 0 required;
    returns (stdout, seconds).  On a timeout its whole process group (the
    script and the CLI it starts) is killed."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, str(ROOT / path), *args], cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SystemExit(f"chip_smoke FAILED: {path} {args} ran over {timeout} s")
    require(proc.returncode == 0, f"{path} {args} exited {proc.returncode}: {err[-3000:]}")
    return out, time.perf_counter() - t0


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def builds() -> list:
    """Every built kernel library under ``build/``, with its mtime."""
    return sorted((str(p), p.stat().st_mtime_ns)
                  for p in build.BUILD_ROOT.glob(f"*/{build.LIB_NAME}"))


def scripts_serve(job) -> dict:
    """(a) ``examples_torch/serve_omc.py`` as a subprocess (``job``, the
    future of its ``run_script``), and its arguments with
    ``--wire-roundtrip`` through ``serve.run`` in process."""
    cfg = get_arch("qwen2.5-3b").smoke_config()
    example = importlib.import_module("examples_torch.serve_omc")
    argv = example.command(["--wire-roundtrip", "--quiet"])[3:]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    again = serve.run(serve.parse_args(argv))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    again.pop("session")
    require(again["swap_bit_identical"], "serve_omc --wire-roundtrip: swap not bit-identical")
    out, secs = job.result()
    report = last_json(out)
    toks = torch.tensor(report["tokens"])
    require(report["smoke"] and report["fmt"] == FMT.name and toks.shape == (4, 16)
            and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
            f"serve_omc: bad report {({k: report[k] for k in ('smoke', 'fmt', 'tokens')})}")
    # the CLI raises on non-finite logits, so exit 0 says they were finite
    require(report["logits_shape"] == [4, 1, cfg.vocab], f"logits {report['logits_shape']}")
    require(again["tokens"] == report["tokens"],
            "serve_omc: the in-process run's tokens differ from the script's")
    want = zoo_formula(cfg)
    predicted = zoo_cpu_per_forward("qwen2.5-3b", cfg.n_layers)
    require(predicted == want, f"serve_omc: the CPU dry run at the smoke config predicts "
            f"{predicted}, the formula {want}")
    require_per_forward(counts, "serve_omc --wire-roundtrip", 1 + 16, want)
    print(f"  (a) serve_omc.py: exit 0 in {secs:.1f} s, prefill {report['prefill_ms']:.1f} ms, "
          f"decode {report['decode_ms_per_token']:.2f} ms a token; with --wire-roundtrip in "
          f"process: {want} a forward pass over 17 (the CPU dry run's), payload "
          f"{again['payload_ratio']:.3f} of f32, launches {counts}")
    return dict(counts=counts, script_s=secs, prefill_ms=report["prefill_ms"],
                decode_ms_per_token=report["decode_ms_per_token"])


def conformer_round_formula(params) -> dict:
    """B1/B2 launches of one driver round on a conformer tree: one encode
    and one decode a compressed leaf at the update; in the forward pass one
    decode a stacked entry of ``blocks`` and one a flat leaf, and the
    stacked entries again in the recompute."""
    comp = [(p, v) for p, v in tree_items(params) if is_compressed(v)]
    stacked = sum(v.s.numel() for p, v in comp if p[0] == "blocks")
    flat = sum(v.s.numel() for p, v in comp if p[0] != "blocks")
    return {"quantize_stats.cuda": len(comp), "dequantize.cuda": len(comp) + 2 * stacked + flat}


TRAIN_100M_DIR = SCRIPTS_DIR / "train_100m"
TRAIN_100M_LAST = SCRIPTS_DIR / "train_100m_last"  # the first run's last checkpoint


def train_100m_twice() -> tuple:
    """(b)'s two subprocesses: ``train_100m.py`` with ``SCRIPTS_TRAIN``, a
    copy of its last checkpoint, then the same command again; returns
    ``(first stdout, seconds, rerun stdout, seconds)``."""
    shutil.rmtree(TRAIN_100M_DIR, ignore_errors=True)
    shutil.rmtree(TRAIN_100M_LAST, ignore_errors=True)
    argv = SCRIPTS_TRAIN + ["--ckpt-dir", str(TRAIN_100M_DIR)]
    first = run_script("examples_torch/train_100m.py", argv)
    shutil.copytree(TRAIN_100M_DIR / f"ckpt_{SCRIPTS_ROUNDS}", TRAIN_100M_LAST)
    return first + run_script("examples_torch/train_100m.py", argv)


def scripts_train(job) -> dict:
    """(b) ``examples_torch/train_100m.py --full`` cut to 6 rounds as a
    subprocess, then the same command again (``job``, the future of
    :func:`train_100m_twice`): it resumes at round 6 and trains no further
    round."""
    rounds, every = SCRIPTS_ROUNDS, SCRIPTS_EVERY
    # the formula on a tree of conformer_s' layout at the smoke widths, which
    # the driver on the CPU at the smoke config also launches on its own tree
    cpu = train.run(train.parse_args(["--smoke", "--device", "cpu", "--rounds", "1", "--quiet",
                                      "--fmt", "S1E3M7"]))
    require(as_cuda(cpu["round_launches"][0]) == conformer_round_formula(cpu["state"].params),
            f"the driver on the CPU launched {cpu['round_launches']}")
    layout = dataclasses.replace(conformer_s.smoke_config(), n_layers=TRAIN_CFG.n_layers)
    want = conformer_round_formula(init_state(prng.PRNGKey(0), conformer, layout,
                                              OMCConfig.parse("S1E3M7"), fedavg(1.0),
                                              device="cpu").params)
    out, secs, rerun_out, resume_s = job.result()
    first = last_json(out)
    require(first["state_bytes"]["num_params"] == SCRIPTS_TRAIN_PARAMS and not first["smoke"]
            and first["fmt"] == "S1E3M7", f"train_100m: {first['state_bytes']}, "
            f"smoke {first['smoke']}, fmt {first['fmt']}")
    require(len(first["losses"]) == rounds
            and all(math.isfinite(x) and 0 < x < 20 for x in first["losses"]),
            f"train_100m: losses {first['losses']}")
    require(first["round_launches"] == [want] * rounds,
            f"train_100m: rounds launched {first['round_launches']}, the formula {want}")
    names = sorted(p.name for p in TRAIN_100M_DIR.iterdir() if p.name.startswith("ckpt_"))
    require(names == sorted(f"ckpt_{r}" for r in range(every, rounds + 1, every)),
            f"train_100m: checkpoints {names}")
    rerun = last_json(rerun_out)
    require(rerun["start_round"] == rounds and rerun["losses"] == []
            and rerun["round_launches"] == [], f"train_100m rerun: started at "
            f"{rerun['start_round']}, trained {len(rerun['losses'])} rounds")
    same = ("arch", "smoke", "fmt", "rounds", "state_bytes", "init_launches", "ckpt_bytes")
    require(all(rerun[k] == first[k] for k in same)
            and npz_equal(TRAIN_100M_LAST, TRAIN_100M_DIR / f"ckpt_{rounds}"),
            f"train_100m rerun: its report or ckpt_{rounds} differs from the first run's")
    counts = _plus(first["init_launches"], *first["round_launches"], rerun["init_launches"])
    print(f"  (b) train_100m.py {' '.join(SCRIPTS_TRAIN)}: exit 0 in {secs:.1f} s, "
          f"{SCRIPTS_TRAIN_PARAMS:,} parameters, S1E3M7, rounds ms "
          f"{[round(x, 1) for x in first['round_ms']]}, peak "
          f"{first['max_memory_allocated'] / 1e9:.2f} GB, losses {first['losses']}, "
          f"{want} a round (the formula), {first['ckpt_bytes']:,} B a checkpoint; rerun "
          f"in {resume_s:.1f} s: resumed at round {rounds}, the same report and ckpt_{rounds}")
    return dict(counts=counts, script_s=secs, rerun_s=resume_s, round_ms=first["round_ms"],
                peak=first["max_memory_allocated"], losses=first["losses"],
                ckpt_bytes=first["ckpt_bytes"], per_round=want)


def run_example(name: str, argv) -> str:
    """``examples_torch/<name>.py``'s ``main(argv)`` in process; its stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = importlib.import_module(f"examples_torch.{name}").main(argv)
    require(rc == 0, f"{name} {argv} returned {rc}")
    return out.getvalue()


def wire_lines(text: str) -> list:
    """The byte figures of each output line that has any, in order."""
    return [found for line in text.splitlines() if (found := WIRE_RE.findall(line))]


STRATEGY_EXAMPLES = ("compress_strategies", "train_under_strategy")


def scripts_strategies(jobs: dict) -> dict:
    """(c) the two strategy examples at their default arguments on the card,
    in process, and on the CPU at the same arguments (``jobs[name]``, the
    futures of their ``run_script`` with ``--device cpu``): the per-round
    wire bytes depend on the round index and the pipeline's DEFLATE on the
    data, so neither side runs ``--smoke``."""
    out, counts = {}, {}
    for name in STRATEGY_EXAMPLES:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        card = run_example(name, [])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        counts[name] = ops.launch_counts()
        require_launches(counts[name], name, quantize_stats=None, dequantize=None)
        host, host_s = jobs[name].result()
        lines = wire_lines(card)
        require(lines and lines == wire_lines(host), f"{name}: wire lines differ card against "
                f"CPU:\n{lines}\n{wire_lines(host)}")
        losses = [float(x) for x in LOSS_RE.findall(card)]
        require(losses and all(map(math.isfinite, losses)), f"{name}: losses {losses}")
        print(f"  (c) {name}: card {card_s:.1f} s, CPU {host_s:.1f} s (a process); {len(lines)} wire "
              f"lines equal, e.g. {lines[-1]}; losses {losses}; launches {counts[name]}")
        out[name] = dict(card_s=card_s, cpu_s=host_s, wire=lines, losses=losses)
    return dict(counts=_plus(*counts.values()), runs=out)


REFERENCE_ROW_JSON = ROOT / "experiments" / "bench_torch" / "async_scale_reference_row.json"


def scripts_reference_row(job) -> dict:
    """(d) ``async_scale.py --reference-row`` on the card as a subprocess
    (``job``, the future of its ``run_script``) against the reference's
    row: the virtual-clock and byte columns equal, the losses within
    ``REFERENCE_LOSS_GAP``."""
    _, secs = job.result()
    payload = json.loads(REFERENCE_ROW_JSON.read_text())
    row = payload["rows"][0]
    require(row["device"] == torch.cuda.get_device_name(0) and payload["card"],
            f"reference row ran on {row['device']}")
    got = {k: row[k] for k in REFERENCE_ROW_EXACT}
    require(got == REFERENCE_ROW_EXACT, f"reference row: {got} != {REFERENCE_ROW_EXACT}")
    gaps = {k: abs(row[k] - v) for k, v in REFERENCE_ROW_LOSSES.items()}
    require(max(gaps.values()) <= REFERENCE_LOSS_GAP,
            f"reference row losses {({k: row[k] for k in gaps})} against the reference's "
            f"{REFERENCE_ROW_LOSSES}: gaps {gaps} over {REFERENCE_LOSS_GAP}")
    print(f"  (d) async_scale --reference-row: exit 0 in {secs:.1f} s; {len(got)} columns "
          f"equal the reference's ({got}); losses {({k: row[k] for k in gaps})}, gaps "
          f"{({k: f'{v:.2g}' for k, v in gaps.items()})} (gate {REFERENCE_LOSS_GAP}); "
          f"sync {row['sync_wall_s_per_round']} s a round, async "
          f"{row['async_wall_s_per_flush']} s a flush")
    return dict(script_s=secs, row=row, gaps=gaps)


def scripts_registry() -> dict:
    """(e) every ``BENCHES`` and ``TOOLS`` module of ``benchmarks_torch.run``
    imports, and every ``ARTIFACTS`` file is in the tree with its card."""
    registry = importlib.import_module("benchmarks_torch.run")
    for name, module in registry.BENCHES.items():
        require(hasattr(importlib.import_module(module), "run"), f"{module} has no run()")
    for name in registry.TOOLS:
        importlib.import_module(f"benchmarks_torch.{name}")
    cards = {}
    for artifact in registry.ARTIFACTS:
        path = ROOT / "experiments" / "bench_torch" / artifact
        require(path.exists(), f"artifact {artifact} is not in the tree")
        cards[artifact] = json.loads(path.read_text()).get("card")
        require(cards[artifact], f"artifact {artifact} records no card")
    print(f"  (e) benchmarks_torch.run: {len(registry.BENCHES)} benches and "
          f"{len(registry.TOOLS)} tools import; artifacts {cards}")
    return dict(cards=cards)


def start_script_jobs(pool) -> dict:
    """Phase 23's subprocesses, submitted to ``pool`` (their futures by
    part): (a) ``serve_omc.py``, (b) ``train_100m.py`` twice, (c) the
    strategy examples on the CPU, (d) ``async_scale.py --reference-row``;
    with the kernel libraries built so far.  Each takes seconds to reach
    the card and is host-bound, so ``main`` starts them beside phase 22
    (e), a comparison that times nothing."""
    REFERENCE_ROW_JSON.unlink(missing_ok=True)
    jobs = dict(builds=builds(),
                serve=pool.submit(run_script, "examples_torch/serve_omc.py", []),
                train=pool.submit(train_100m_twice),
                reference_row=pool.submit(run_script, "benchmarks_torch/async_scale.py",
                                          ["--reference-row"]))
    for name in STRATEGY_EXAMPLES:
        jobs[name] = pool.submit(run_script, f"examples_torch/{name}.py", ["--device", "cpu"])
    return jobs


def phase_scripts(jobs: dict) -> dict:
    """(a) serve_omc, (b) train_100m, (c) the strategy examples, (d)
    async_scale's reference row, (e) the script registry.  ``jobs`` are
    :func:`start_script_jobs`'s subprocesses, which load the kernels built
    in phase 1: no library is built or rebuilt.  Counters are zeroed
    around each in-process run; (b)'s launches are its reports', (d)'s
    are not counted.  Each part's seconds are its in-process work and its
    wait for its jobs; each job prints its own."""
    times, parts = {}, {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    torch.cuda.empty_cache()
    parts["strategies"] = step("(c) strategy examples", scripts_strategies, jobs)
    parts["serve_omc"] = step("(a) serve_omc", scripts_serve, jobs["serve"])
    parts["train_100m"] = step("(b) train_100m", scripts_train, jobs["train"])
    parts["reference_row"] = step("(d) async_scale --reference-row", scripts_reference_row,
                                  jobs["reference_row"])
    require(builds() == jobs["builds"], f"the scripts built kernels: {jobs['builds']} -> "
            f"{builds()}")
    parts["registry"] = step("(e) benchmarks_torch.run", scripts_registry)
    print("  parts: " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    counts = _plus(*(p.pop("counts") for p in parts.values() if "counts" in p))
    return dict(counts=counts, parts=parts, times=times)


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
    on_host = {"qwen2.5-3b": to_host(served.pop("session").storage, "qwen2.5-3b")}
    served_g = timed(5, "serve recurrentgemma-2b", phase_serve_griffin)
    timed(6, "recurrentgemma-2b card against CPU", phase_griffin_card_vs_cpu, served_g["session"])
    on_host["recurrentgemma-2b"] = to_host(served_g.pop("session").storage, "recurrentgemma-2b")
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
    torch.cuda.empty_cache()
    strategies = timed(17, "strategies at full width", phase_strategies)
    torch.cuda.empty_cache()
    telemetry = timed(18, "telemetry and strategy sessions at full width", phase_obs,
                      {k: r["max_memory_allocated"] for k, r in trained["runs"].items()})
    torch.cuda.empty_cache()
    scaled = timed(19, "population runtime at full width", phase_scale, trained.pop("warm"),
                   strategies["train"].pop("none"), strategies["train"].pop("topk"))
    torch.cuda.empty_cache()
    zoo = timed(21, "the decoder-only zoo at full width", phase_zoo)
    launched = timed(20, "launch and roofline on the card", phase_launch, on_host,
                     scaled.pop("packed"), zoo.pop("mixtral"))
    torch.cuda.empty_cache()
    with concurrent.futures.ThreadPoolExecutor(2 + len(STRATEGY_EXAMPLES) + 1) as pool:
        last = timed(22, "the last families at full width", phase_last,
                     lambda: start_script_jobs(pool))
        scripts = timed(23, "the reference's last scripts on the card", phase_scripts,
                        last.pop("before_e"))
    print(f"all phases: {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernel_line(kernels, {"serve": served["report"]["launch_counts"],
                                           "serve_griffin": served_g["report"]["launch_counts"],
                                           "train": trained["counts"],
                                           "tables": tables["counts"],
                                           "train_driver": driver["counts"],
                                           "async": asynced["counts"],
                                           "sessions": sessions["counts"],
                                           "noniid": noniid["counts"],
                                           "strategies": strategies["counts"],
                                           "obs": telemetry["counts"],
                                           "scale": scaled["counts"],
                                           "launch": launched["counts"],
                                           "zoo": zoo["counts"],
                                           "last": last["counts"],
                                           "scripts": scripts["counts"]})))
    print(json.dumps(dict(ok=True, device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                                               count=torch.cuda.device_count()))))


if __name__ == "__main__":
    main()
