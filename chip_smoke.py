#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    PYTHONPATH=src python3 chip_smoke.py

It drives the plane-packed analog path (``ServeEngine.from_ta_state`` ->
``analog-cuda-packed2`` -> ``imbue_infer_planes``), its lower tiers
(``EngineConfig(pack_planes=False)`` -> ``analog-cuda-packed`` ->
``imbue_infer_packed``; ``EngineConfig(packed=False)`` -> ``analog-cuda``
-> ``imbue_infer``), the chaos round (``ServeEngine.inject_faults``), one
``CrossbarState`` through ``api.class_sums``, the coalesced path
(``ServeEngine.from_coalesced`` -> ``coalesced-cuda-packed2`` ->
``tm_infer_planes``, with its lower tiers on ``tm_infer_packed`` and
``tm_infer``), the digital fused tier through ``api.class_sums``, and the
training path: ``tm_train.fit`` (batch steps on ``clause_eval_packed``,
sequential steps on ``clause_eval``), ``OnlineTrainer``, a checkpoint
round trip and ``coalesced.fit``, whose trained states the engine then
serves; the streaming path (``StreamServer`` sessions over the analog
engine -> ``imbue_infer_planes``, over the coalesced engine ->
``tm_infer_planes``; KWS-6 and anomaly training -> ``clause_eval_packed``;
the ``repro_torch.launch.stream`` CLI) and the Monte-Carlo variation
studies; and flash attention (``flash_attention_trainable`` forward and
backward -> ``flash_fwd``, ``flash_bwd_dkv``, ``flash_bwd_dq``;
``flash_attention`` -> ``flash_fwd``) at the attention widths of
qwen2-0.5b, gemma2-2b and the whisper-large-v3 encoder.  Every fused
dispatch carries the committed tuning table's tiles for its backend,
shape bucket and card (``src/repro_torch/kernels/tuning_table.json``;
none, the kernel's own geometry, where the sweep found no tile clearly
faster in every served state), and every ``BatcherConfig.for_max_batch``
engine its ladder.

Phases, each printing JSON lines (any failure raises, so the exit code
is non-zero and no result line is printed):

1. environment — the card's name, power limit and max SM clock
   (``nvidia-smi``), the torch and CUDA versions, and the build of every
   kernel (``nvcc``, sm_90a, one process per source, all started
   together), with each flash bf16 instance's route (all on ``wgmma``),
   registers, spills, shared memory and ``HGMMA`` count in its SASS
   (``cuobjdump -sass``; an instance on ``wgmma`` without one fails),
   each analog kernel instance's registers, spills, static shared
   memory and its ``LOP3`` bit tests, ``FSEL``, ``FADD`` and predicated
   ``FADD`` counts (all three kernels run ``csrc/imbue_core.cuh``'s inner
   loop: an instance without predicated ``FADD``s, or with a tensor-core
   instruction, fails), and the registers, spills and ``BMMA`` / ``LOP3``
   / ``POPC`` counts of each instance of the four kernels on
   ``csrc/tm_b1.cuh`` (``clause_eval_packed``, ``tm_infer_planes``,
   ``tm_infer_packed``, ``tm_infer``; an instance without a ``BMMA``, the
   b1 tensor-core product, fails);
2. kernels — every kernel against its plain PyTorch version on the card,
   tolerance 0: ``imbue_infer_planes`` at the imbue-tm-mnist width (R in
   {1, 4}, B in ``CHECK_BATCHES`` = {1, 8, 64, 128, 129}, with and
   without the deviation plane), one ragged small shape, and R = 4,
   B = 128 at the streaming widths (KWS: C = 1800, L = 768, M = 6;
   anomaly: C = 600, L = 512, M = 2);
   ``imbue_infer_packed`` and ``imbue_infer`` at the same width on the
   g / leak planes of D2D-programmed and of nominal chips (R in {1, 4},
   B in ``CHECK_BATCHES``) and one ragged shape;
   the three TM kernels at the digital width (imbue-tm-mnist, C = 2000)
   and the coalesced width (C = 1000), B in {8, 64, 128}, one ragged
   shape (ragged: C not a multiple of the clause tile, L not a multiple
   of 32, B odd, an empty clause), and B = 128 at the streaming widths
   (KWS, its coalesced pool ``STREAM_COALESCED`` of C = 900, anomaly);
   guards on the share of non-zero sums and of fired clauses.  The two clause-bit kernels
   (``clause_eval_packed``, ``clause_eval``) at the digital and the
   coalesced width with one clause in 16 emptied, B in ``CLAUSE_BATCHES``
   = {1, 8, 64, 208, 256} (256: the batch training step; 208: an extra
   ragged batch, a multiple of 16 but of no 64-row tile), the streaming
   widths at their training step (B = ``STREAM_TRAIN_BATCH`` = 200),
   and the ragged shape: every empty clause reads 1, 5-95 % of bits fire
   (at least 1 % of the non-empty clauses' bits).  Then the cross-tier
   check: on one D2D + stuck-at plane-packed stack at full width, read
   without C2C, the three analog CUDA backends return identical
   ``[R, B, M]``.  The three flash kernels on ``FLASH_ROWS`` (main:
   qwen2-0.5b ``[4, 4096, 14, 64]`` bf16 causal, 2 kv heads gathered to
   14; local: gemma2-2b ``[1, 8192, 8, 256]`` bf16, causal, window 4096,
   softcap 50; bidir: whisper-large-v3 encoder ``[4, 1500, 20, 64]`` bf16)
   and ``FLASH_SMALL`` (each mask combination of ``tests/test_kernels.py``
   at every float32 head dim and the bf16 ones the rows leave out): each
   kernel against its plain version on the same inputs (the bf16
   kernels on the tensor cores, ``wgmma`` fed by TMA, the backward with P
   and dS split into bf16 hi + lo; the float32 instances on FFMA), then
   ``flash_attention_trainable``'s ``o`` and the gradients of ``sum((o -
   tgt)^2)`` against the plain ones, within ``FLASH_TOL`` (float32: the
   reference's bounds on ``max|err| / max|plain|``; bf16: one ulp plus
   2e-3 (``o``) or 1e-3 (``dq``, ``dk``, ``dv``) of ``max|plain|``
   elementwise, the trainable's gradients 5e-3 of ``||plain||``); ``o``, ``dq``, ``dk`` and ``dv`` non-zero on 99 % of
   their rows, ``lse`` finite, ``flash_attention`` equal to the trainable
   forward;
3. serving — (a) ``ServeEngine.from_ta_state`` at imbue-tm-mnist with
   R = 4 serves 512 requests in ``round_robin`` and in ``ensemble``
   through ``analog-cuda-packed2``, first with D2D + C2C (no CSA
   offset), then at nominal, where every response must equal the digital
   TM; (b) the same on the lower analog tiers, ``analog-cuda-packed`` and
   ``analog-cuda``; (c) the chaos round: the default engine on a nominal
   pool, ``inject_faults`` (1 % stuck at LRS, 1 % at HRS) into replica 1,
   512 requests in ``ensemble`` (a deviation plane grows, replicas 0, 2
   and 3 keep the digital TM's sums), then ``repair_replica(1)`` and
   ``_set_pool`` elide the plane again; (d) one ``CrossbarState``
   through the three analog CUDA backends with ``api.class_sums``;
   (e) ``ServeEngine.from_coalesced`` at 10 classes x 1000 clauses x 784
   features serves 512 requests on each tier
   (``coalesced-cuda-packed2``, ``-packed``, ``coalesced-cuda``) in
   ``round_robin``, and on the default tier in ``ensemble``; every
   response must equal ``core.coalesced.forward``; (f)
   ``digital-cuda-packed`` and ``digital-cuda`` must equal
   ``digital-torch`` at imbue-tm-mnist; (g) the live path at
   imbue-tm-mnist (R = 4): ``AsyncServeEngine`` against ``ServeEngine``
   on one seed under D2D + C2C, in ``ensemble`` and ``round_robin``, 512
   requests submitted 128 at a time with a ``pump()`` each, and all at
   once then drained (bit-equal Responses, ``max_in_flight`` reached in
   the burst, requests/s and ``overlap_fraction`` of both, and one more
   issue that must not synchronize); a nominal ensemble pool with
   ``enable_health``, ``CHAOS`` in
   replica 1, ``probe()`` (exactly replica 1 quarantined, the others at
   1.0), 512 requests equal to the digital TM with replica 1's load flat,
   ``RepairPolicy.check()`` (readmitted at 1.0); ``HotSwapper`` on the
   async engine (canary 0.25 over 512 requests, ``promote`` equal to a
   fresh ``from_ta_state`` pool, a second rollout rolled back equal to
   its snapshot); the coalesced engine at ``COALESCED``: ``hot_swap``
   with new weights, a 25 % + 25 % injury held by the last-healthy floor,
   ``RepairPolicy.repair``; (h) the streaming path: KWS-6 (``KWS_TASK``:
   imbue-tm-kws6's 6 x 300 clauses and hyperparameters at the windower's
   8 frames x 12 mels x 4 bits = 384 features) and the sensor anomaly
   model (``ANOMALY_TASK``: 2 x 300 clauses, 8 x 8 x 4 = 256 features),
   their streams drawn on a CPU generator (the train frames' sha256
   printed), windowed with numpy and trained ``STREAM_EPOCHS`` epochs of
   ``fit(parallel=True, batch_size=200)`` (KWS at least
   ``KWS_ACCURACY_FLOOR``); ``STREAM_SESSIONS`` = 64 KWS sessions of 256
   frames fed one hop a session a round with a ``pump()`` each round, on
   R = 4 chips under ``BatcherConfig.for_max_batch(128)``: at nominal in
   ``ensemble`` and ``round_robin`` on both engines (every window equal
   to offline ``api.predict`` and the digital TM, every keyword the
   vote; decisions/s, per-session p50 / p99 window latency,
   ``mean_batch``, ``padding_overhead``, ``overlap_fraction``; one more
   round of each engine under ``torch.profiler`` for the device's idle
   share), under D2D + C2C on both engines (bit-equal decisions, keyword
   accuracy); 32 anomaly sessions in ``margin`` mode on the async engine,
   half of them latency-class (margins equal ``margin_of`` on offline
   ``api.class_sums``); the 64 sessions through a coalesced pool at the
   KWS width (``STREAM_COALESCED``, ``coalesced-cuda-packed2``; every
   window equal to ``core.coalesced.forward``); and the streaming CLI,
   ``launch.stream.main`` with ``STREAM_CLI_ARGS``, KWS and anomaly.
   (i) the cli path, the entry points a user runs: ``launch.serve
   .build_engine`` at imbue-tm-mnist (``--routing ensemble --nominal
   --batch 128``, R = 4), sync and async, 512 requests equal to the
   digital TM with one ``imbue_infer_planes`` launch a dispatch;
   ``launch.serve.main`` with ``CLI_SERVE_ARGS`` on each analog tier (its
   kernel alone launched, once a dispatch, 0 fallbacks) and at its
   defaults (``VariationConfig()``: a warning, ``analog-torch``, every
   dispatch a counted fallback, no analog launch), a line a run with
   requests/s, p50 / p95 / p99, ``mean_batch``, padding and accuracy;
   ``launch.chaos.main`` with ``--smoke`` (to ``smoke_ok``) and with
   ``CLI_CHAOS_ARGS`` sync and async (0 oracle mismatches, none expired
   or rejected, ``tm_infer`` launched, and, as the reference reads at
   that width, no chip quarantined); ``launch.retrain.main`` with
   ``--smoke`` and with ``CLI_RETRAIN_ARGS`` sync and async (every request
   answered, none expired or rejected; the decision, agreement and
   requests by version recorded); ``benchmarks/serve_bench_torch`` and
   ``stream_bench_torch`` with ``--smoke`` and at their defaults (the
   sync / async, planes, capacity and serial / batched rows); each
   example's ``main`` (``CLI_EXAMPLE_DEPTH`` cuts the XOR quickstarts'
   sequential epochs) and ``benchmarks/run_torch.py --fast``; (j) the
   mesh path: (a) a one-rank gloo group and ``make_replica_mesh(1, 1)``:
   imbue-tm-mnist at R = 4 under D2D + C2C and at nominal in both
   routings, and the coalesced pool at ``COALESCED``, each equal to the
   same engine without a mesh, on ``analog-cuda-packed2`` /
   ``coalesced-cuda-packed2`` with 0 fallbacks (the engines without a
   mesh serve first, outside the counted run); (b) ``MESH_RANKS`` = 4
   spawned ranks sharing the card over gloo (NCCL refuses two ranks on
   one GPU): imbue-tm-mnist at R = 4 on a ``2x2`` mesh, sync and async,
   both routings, D2D + C2C and nominal, on ``analog-cuda-packed2``
   (each rank launches ``imbue_infer_planes`` on its two replicas and
   its half of the rows, 0 fallbacks; every rank's Responses equal, and
   equal bit for bit to the single-device kernel engine; at nominal the
   digital TM; one async issue under the sync debug mode; each rank's
   host split of submit, issue, device wait, cut agreement and gather),
   one ``tm_train_step`` at B = ``TRAIN_BATCH`` on a ``(data 2, model
   2)`` mesh equal to the single-device step, and on 2 ranks the
   coalesced pool class-parallel on ``2x1`` on ``coalesced-cuda-packed2``
   (``tm_infer_planes`` on each rank's five class columns); every rank
   reports its launches of the mesh engines and of the mesh training
   step, and each must have launched its leg's kernels; (c)
   ``launch.serve`` with ``MESH_CLI_ARGS`` under
   ``torch.distributed.run``, rank 0's summary showing the mesh, the
   plane-packed kernel and the accuracy of the same arguments without
   one; (k) the models path, the LM side path (``repro_torch.models``):
   qwen2-0.5b, gemma2-2b, xlstm-125m, zamba2-1.2b, whisper-large-v3 and
   deepseek-v2-lite-16b at their published widths (``MODEL_ARCHS``;
   deepseek with bf16 weights, its one override, reported as
   ``reduced``), weights from a seeded generator: ``decode_step`` over 64
   positions against ``forward`` at float32 (``MODEL_DECODE_TOL``, MoE at
   capacity E / K, whisper's cross caches from its encoder); qwen2 and
   xlstm at float32 on the card against the same weights on the host
   (``MODEL_HOST_TOL``, TF32 off; the TF32 gap and the rounding floor
   read beside); qwen2 at S = 8192, ``_blocked_causal`` against
   ``_sdpa``; qwen2's bf16 prefill (4 x 2048) and decode (B = 4, 2,048
   slots) readings; every ``smoke()`` arch on the card against the host,
   decode against forward for the reference's six; and the GPipe demo on
   ``PIPELINE_RANKS`` ranks sharing the card under
   ``torch.distributed.run``.  It launches none of the eleven kernels:
   their counts, read around the path, must be 0; (l) the lm_train path,
   LM training (``repro_torch.optim``, ``train.train_step``,
   ``data.pipeline``, ``launch.train``): one float32 AdamW step of
   qwen2-0.5b at its published widths and depth on the card against the
   same weights on the host (loss, every gradient leaf, the updated
   parameters; ``LM_HOST_TOL``), remat against none at 8 x 256 (equal
   gradients, each one's peak memory); ``python -m
   repro_torch.launch.train --full`` in this process on qwen2-0.5b,
   zamba2-1.2b (2 microbatches) and whisper-large-v3 (``LM_TRAIN_RUNS``:
   finite losses, the last below the first, ms a step and tokens/s from
   CUDA events, peak memory; one more qwen2 step under ``torch.profiler``)
   and xlstm-125m's resume cycle (8 steps with checkpoints every 4, a
   restart to 12 that prints ``resumed from step 8``, its losses against
   an uninterrupted run within ``LM_RESUME_TOL``); the ten ``smoke()``
   archs, 8 steps each on the card and the host (the loss falls, every
   parameter moves, the first loss within ``LM_SMOKE_TOL``); and
   ``LM_RANKS`` = 4 ranks sharing the card over gloo: the data-parallel
   step of smoke qwen2 and deepseek on ``(2, 2)`` and ``(4, 1)`` against
   one rank (the reference's bars), ``compressed_psum_grads`` (0.05 of
   max |g|, 2 bytes an element on the wire), and the trainer's ``--mesh
   debug`` resume cycle under ``torch.distributed.run``.  Like the models
   it launches none of the eleven kernels (counts read around the path
   and on every rank, all 0); (m) the roofline path, the port's cost
   model (``repro_torch.roofline``, ``launch.dryrun``): the dry run of
   ``ROOFLINE_CELLS`` on the production meshes (a fake group of 256 / 512
   ranks, meta tensors, one process a cell, all at once; no failure, the
   skipped cells ``launch.shapes``' own, positive terms); three steps the
   port runs on the card (the trainer's qwen2-0.5b step, the bf16 prefill
   and decode of ``MODEL_BF16``) counted under ``StepCost`` on the card
   and on meta (FLOPs equal, bytes within ``ROOFLINE_BYTES_RTOL``), timed
   (CUDA events) at or above their roofline bound, the dry run's peak
   estimate beside ``max_memory_allocated``; and whisper-large-v3's
   decode on the default bf16 cache against its forward; no kernel
   launch; (n) the tp path, tensor parallelism on the model axis for the
   LM side path: four ranks sharing the card over gloo on a ``(2, 2)``
   mesh, qwen2-0.5b at full width (depth ``TP_QWEN_LAYERS``) training a
   step (loss, gradients, the train step's own gradients and the AdamW
   update within ``TP_TOL`` of one rank's, each entry's move within
   ``TP_MOVE_TOL`` x lr of one rank's where its gradient is not near
   0), deepseek-v2-lite-16b at full width with bf16 weights (depth
   ``TP_DEEPSEEK_LAYERS``) forward and ``TP_DECODE`` decode steps on a
   ``kv_seq``-split cache within ``MODEL_DECODE_TOL`` of one process, a
   ``seq_parallel`` smoke arch; each rank's peak memory, collective bytes
   and ms a step; the step counted on the card against meta on a fake
   ``(2, 2)`` group; no kernel launch.
   Each path's launch counters are zeroed just before it and read just
   after: one launch per dispatch (plus one per probe read and canary
   shadow read on the live path, one ``tm_infer`` per probe commit, and
   on the stream path the offline ``api.predict`` / ``api.class_sums``
   checks and the training steps), 0 fallbacks;
4. training — on a numpy-drawn image task (``IMAGE_TASK``): at
   imbue-tm-mnist, ``init_ta_state`` then ``TRAIN_EPOCHS`` epochs of
   ``fit(parallel=True, batch_size=256)`` (test accuracy and ms per step
   each epoch, one ``clause_eval_packed`` launch per step, states int16
   in [1, 2N], the last accuracy at least ``TRAIN_ACCURACY_FLOOR``);
   ``fit(parallel=False)`` over 256 examples (256 ``clause_eval``
   launches); ``OnlineTrainer`` refits twice (versions 1 and 2, the
   second replayed as ``fit`` from the first); the coalesced pool
   (``COALESCED``) trained with ``coalesced.fit`` (weights within
   ``±max_weight``).  Then one batch step from one CUDA generator seed
   with the kernel and with its plain version (identical states), a
   checkpoint round trip, and the trained states served: 512 test
   requests through ``ServeEngine.from_ta_state`` (R = 4, nominal), each
   equal to the digital TM, and through ``ServeEngine.from_coalesced``,
   each equal to ``core.coalesced.forward``; the Monte-Carlo row:
   ``monte_carlo_accuracy`` and ``clause_error_rate``, ``MC_DRAWS`` = 16
   draws on ``MC_ROWS`` = 512 requests of the serving phases'
   imbue-tm-mnist model (at nominal every draw equal to the digital
   accuracy and no clause error; under ``VariationConfig()`` the mean
   accuracy at least the digital one - 0.02, the worst clause error rate
   at most 0.01; ms a draw); then the flash path: at the
   main row, ``FLASH_PATH_STEPS`` forward + backward steps of
   ``flash_attention_trainable`` (exactly one launch of each flash kernel
   a step) and one ``flash_attention`` (the forward kernel alone);
   then the tuning phase (after every path, before the timing): (a) the
   six fused inference kernels at every tile of the autotuner's full
   grid (analog ``ng`` in {1, 2, 4} x ``ks`` in {2, 4, 8}, TM ``wm`` x
   ``wn`` in {1, 2, 4}) and ``"auto"`` against their plain versions,
   tolerance 0: the analog ones at imbue-tm-mnist and the KWS and anomaly
   widths, B in ``CHECK_BATCHES``, with and without the deviation plane
   (D2D and nominal planes for the dense two) and the ragged small shape
   (where a ks past its 3 columns must raise and launch nothing); the TM
   ones at the digital, coalesced, KWS, KWS-coalesced and anomaly widths,
   B in ``TM_CHECK_BATCHES``, and the ragged shape; (b)
   ``autotune(smoke=True, register=False)``, and ``lazy_tune`` at an
   unseen shape bucket measuring once for two engines (then the tuned
   engine equal to the digital TM); (c) engines under
   ``BatcherConfig.for_max_batch(128)`` at imbue-tm-mnist (R = 4,
   ``ensemble``) and at the coalesced width report the committed entry's
   ladder and tiles (``buckets_tuned_for``, ``kernel_tiles``) and serve
   512 nominal requests equal to the digital TM / ``core.coalesced
   .forward``, one launch a dispatch; (d) each fused kernel's device
   time at the committed tiles beside ``"auto"`` at B = 128 and the full
   widths (``time_ms``), the analog ones in both served states the sweep
   measures (R = 4 D2D, R = 1 nominal); (e) the nominal KWS ``ensemble``
   stream round on both engines on the static ladder and on the tuned
   one, in the order static, tuned, tuned, static, with each ladder's
   medians (decisions/s, ``mean_batch``, ``padding_overhead``, window
   p50 / p99; recorded only);
5. timing — each kernel's median device time (CUDA events, L2 flushed,
   the host's enqueue hidden behind a spin kernel; the six fused
   inference kernels at the tiles their main path's engine launches, with
   ``"auto"`` beside them) beside its bound, what sets the bound, and the
   plain version's time:
   ``imbue_infer_planes`` at R = 4 and R = 1 with the deviation plane
   (and the C2C pre-pass) and at R = 1 without it, B in {8, 64, 128};
   ``imbue_infer_packed`` and ``imbue_infer`` at R = 4, B in {8, 64, 128}
   (with the eager conductance pre-pass, with and without C2C, and
   ``torch.einsum`` of the two column-current products alone as a
   partial yardstick); each analog row with the inner loop's issue floor
   and the digital TM's fired share, and for all three (each on
   ``csrc/imbue_core.cuh``) their grid, block, resident blocks an SM,
   launched warps an SM and the share of (warp, row, column) steps the
   early exit skipped; the TM
   kernels at B in {8, 64, 128} at the coalesced and the digital width,
   beside ``torch.matmul`` of the violation product alone (a partial
   bracket: no threshold, no combine) and the ``[B, M]`` zero fill that
   the wrappers run before each (inside every TM row's time: the three
   kernels add their sums with int32 atomics), with the geometry and
   launched warps an SM of the three (all on ``csrc/tm_b1.cuh``), and
   the clock's floor (events
   around no device work); the host time of one
   backend call per coalesced tier; the clause-bit kernels at the digital
   and the coalesced width, B in ``CLAUSE_BATCHES``, with the route each
   took (``clause_eval``: a warp per clause up to ``B_SMALL`` rows of
   ``csrc/clause_eval.cu``, tiles above; ``clause_eval_packed``: the b1
   tensor-core product, with its geometry and launched warps an SM) and
   the ``torch.matmul`` bracket, and the batch
   training step's split into kernel and eager TA update; the flash
   kernels on each bf16 row with their plain versions and bounds
   (bytes, matmul FLOPs at the tensor rate, exp / tanh at the SFU rate),
   SDPA's forward, backward and both on the ``[b, h, s, d]`` transposes
   with the backend that ran (none for the softcapped local row), the
   backward pair's ms over SDPA's backward, the split's tensor work
   beside the bound, and the port's trainable forward + backward.

Then the launches of each path, the ``{"kernels": [...]}`` line (with
each inference kernel's tiles and ``auto_ms``, and each kernel's
launches on its main path: the plane-packed analog path for
``imbue_infer_planes``, the lower analog tiers for ``imbue_infer_packed``
and ``imbue_infer``, the coalesced path for the TM kernels, the training
path for the clause-bit kernels, the trainable attention steps for the
flash kernels; the stream and mesh paths' counts are in the ``launches`` line),
the ``nvidia-smi`` line, and last ``{"ok": true,
"device": {...}}``.  The
serving phases' models are built with numpy from a seed, without
training: each clause includes 8-16 literals that are 1 on a class
prototype; requests are prototypes with 8 % of bits flipped.  The
training phase trains its own from ``init_ta_state``.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.roofline import analysis as roofline  # noqa: E402

SEED = 2026
N_REQUESTS = 512
FLIP = 0.08
MODEL = "imbue-tm-mnist"
REPLICAS = 4
# The coalesced serving width.  The repo's capacity rule gives a coalesced
# pool "ONE shared pool with HALF the clause rows" of the per-class TM it
# stands for (benchmarks/serve_bench.py, make_capacity_models); at
# imbue-tm-mnist (10 classes x 200 clauses, 784 features) that is 1000
# clauses.
COALESCED = dict(n_classes=10, n_clauses=1000, n_features=784,
                 n_states=127)
BATCHES = (8, 64, 128)
# The analog kernels' checks against their plain versions at full width:
# one row, the timed batches, and one row past a 128-row block.
CHECK_BATCHES = (1, 8, 64, 128, 129)
SPIN_CYCLES = 2_000_000        # the timing spin kernel: ~1 ms at 1.98 GHz
# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit), from
# the port's roofline module.
HBM_BYTES_PER_S = roofline.HBM_BW
FP32_FLOP_PER_S = roofline.FP32_FLOPS   # outside the tensor cores
INT8_OP_PER_S = roofline.INT8_OPS       # dense, tensor cores, int32 acc.
# POPC rate on compute capability 9.0, per clock per SM (the arithmetic
# instruction throughput table of NVIDIA's CUDA C++ documentation).
POPC_PER_CLOCK_PER_SM = 16
# 32-bit logic (LOP3) on compute capability 9.0, per clock per SM (same
# table).
LOP3_PER_CLOCK_PER_SM = 64
KERNELS = {
    "imbue_infer_planes": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/imbue_infer_planes.cu",
        "replaces": "src/repro/kernels/imbue_infer.py:111",
    },
    "imbue_infer_packed": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/imbue_infer_packed.cu",
        "replaces": "src/repro/kernels/imbue_infer.py:65",
    },
    "imbue_infer": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/imbue_infer.cu",
        "replaces": "src/repro/kernels/imbue_infer.py:35",
    },
    "tm_infer_planes": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tm_infer_planes.cu",
        "replaces": "src/repro/kernels/clause_eval.py:146",
    },
    "tm_infer_packed": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tm_infer_packed.cu",
        "replaces": "src/repro/kernels/clause_eval.py:121",
    },
    "tm_infer": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tm_infer.cu",
        "replaces": "src/repro/kernels/clause_eval.py:65",
    },
    "clause_eval_packed": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/clause_eval_packed.cu",
        "replaces": "src/repro/kernels/clause_eval.py:105",
    },
    "clause_eval": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/clause_eval.cu",
        "replaces": "src/repro/kernels/clause_eval.py:48",
    },
    "flash_fwd": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
    },
    "flash_bwd_dkv": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_bwd_dkv.cu",
        "replaces": "src/repro/kernels/flash_attention.py:179",
    },
    "flash_bwd_dq": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_bwd_dq.cu",
        "replaces": "src/repro/kernels/flash_attention.py:219",
    },
}
TM_KERNELS = ("tm_infer_planes", "tm_infer_packed", "tm_infer")
# The TM kernels' checks: CHECK_BATCHES and 256 (one more 128-row tile).
TM_CHECK_BATCHES = CHECK_BATCHES + (256,)
# The dense-plane analog kernels and the backends of the three analog tiers.
DENSE_KERNELS = ("imbue_infer_packed", "imbue_infer")
ANALOG_BACKENDS = ("analog-cuda-packed2", "analog-cuda-packed", "analog-cuda")
CHAOS = dict(stuck_lrs_rate=0.01, stuck_hrs_rate=0.01)
# The training-time clause-bit kernels and the batches they are checked at
# (B = 256 is the batch training step, B = 1 the sequential step; 208 is
# an extra ragged shape: the training paths drop a ragged tail).
CLAUSE_KERNELS = ("clause_eval_packed", "clause_eval")
CLAUSE_BATCHES = (1, 8, 64, 208, 256)
# Training at imbue-tm-mnist on a numpy-drawn stand-in of the reference's
# synthetic_image_dataset (10 classes of 28 x 28 prototypes at density
# 0.25, 8 % of pixels flipped; 512 test rows, all served afterwards).
IMAGE_TASK = dict(n_classes=10, side=28, density=0.25, noise=0.08,
                  n_train=2000, n_test=512, seed=0)
TRAIN_EPOCHS = 4
TRAIN_BATCH = 256
COALESCED_EPOCHS = 3
# Test-accuracy floor of the trained imbue-tm-mnist state after
# TRAIN_EPOCHS epochs of fit(parallel=True, batch_size=TRAIN_BATCH).  The
# reference's own run on the same arrays, config, epochs and batch (JAX
# on the CPU: benchmarks/reference_train_accuracy.py) is in PERF.md; the
# floor leaves room for the port's other random draws.
TRAIN_ACCURACY_FLOOR = 0.95
# The streaming path (phase 3 (h)).  KWS: the imbue-tm-kws6 zoo entry's
# clauses and hyperparameters (src/repro/configs/imbue_tm.py:23-25: 6 x 300
# clauses, N = 127, T = 50, s = 10; copied) at the windower's width, 8
# frames x 12 mels x 4 bits = 384 Boolean features (L = 768).  The zoo's
# 377 features are Table IV's, which no window x mels x bits product gives.
# Anomaly: 2 x 300 clauses over 8 frames x 8 sensors x 4 bits = 256
# features.  Streams of 32 frames windowed every 4 frames (7 windows a
# stream), drawn on a CPU generator from ``seed``, train set first.
KWS_TASK = dict(kind="kws", n_classes=6, clauses_per_class=300, channels=12,
                bits=4, window=8, hop=4, n_train=480, n_test=160,
                n_frames=32, seed=SEED)
ANOMALY_TASK = dict(kind="anomaly", n_classes=2, clauses_per_class=300,
                    channels=8, bits=4, window=8, hop=4, n_train=240,
                    n_test=80, n_frames=32, seed=SEED + 1)
STREAM_HPARAMS = dict(n_states=127, threshold=50, specificity=10.0)
STREAM_EPOCHS = 6
STREAM_TRAIN_BATCH = 200
# The streaming rounds: STREAM_SESSIONS KWS sessions of 8 utterances (256
# frames, 63 windows each), fed one hop a session a round with a pump()
# each round; ANOMALY_SESSIONS sensor sessions of 64 frames.
STREAM_SESSIONS = 64
STREAM_UTTERANCES = 8
ANOMALY_SESSIONS = 32
ANOMALY_FRAMES = 64
STREAM_BATCH = 128
STREAM_VOTE = 5
# The streaming CLI's runs (round 6), each also with --workload anomaly.
STREAM_CLI_ARGS = ("--clauses", "300", "--sessions", "64", "--replicas",
                   "4", "--routing", "ensemble", "--async-serve", "--json")
STREAM_KERNELS = ("imbue_infer_planes", "tm_infer_planes",
                  "clause_eval_packed")
# The coalesced streaming round: one shared pool of half the KWS model's
# clause rows (COALESCED's rule), at the KWS width.
STREAM_COALESCED = dict(n_classes=6, n_clauses=900, n_features=384,
                        n_states=127)
# Test window accuracy floor of the trained KWS model after STREAM_EPOCHS
# epochs: the reference's accuracy on the same arrays (train frames' sha256
# ed1b7fef...), config, epochs and batch, 0.9982 (JAX on the CPU,
# benchmarks/reference_train_accuracy.py; PERF.md), minus 0.05 for the
# port's other random draws.
KWS_ACCURACY_FLOOR = 0.948
# The Monte-Carlo row (phase 4): draws of monte_carlo_accuracy and
# clause_error_rate on MC_ROWS requests of the serving phases' numpy-built
# imbue-tm-mnist model.
MC_DRAWS = 16
MC_ROWS = 512
# The cli path (phase 3 (i)): the entry points a user runs, at full width.
# The serve CLI's tiers (--nominal, R = 4, ensemble, batch 128, 512
# requests; then --no-packed and --backend analog-cuda-packed), and once
# at its defaults, where CSA offset sends it to analog-torch with a counted
# fallback; the chaos CLI at imbue-tm-mnist's width; the retrain CLI at the
# KWS width; the examples, the sequential XOR quickstarts cut to
# CLI_EXAMPLE_DEPTH (the port's sequential step is a host loop of ~2 ms an
# example, so the reference's 80 / 30 epochs would take minutes).
CLI_SERVE_ARGS = ("--nominal", "--replicas", "4", "--routing", "ensemble",
                  "--batch", "128", "--requests", "512", "--json")
CLI_SERVE_TIERS = (("planes", (), "analog-cuda-packed2",
                    "imbue_infer_planes"),
                   ("no-packed", ("--no-packed",), "analog-cuda",
                    "imbue_infer"),
                   ("dense-packed", ("--backend", "analog-cuda-packed"),
                    "analog-cuda-packed", "imbue_infer_packed"))
CLI_SERVE_DEFAULTS = ("--requests", "512", "--json")
CLI_CHAOS_ARGS = ("--classes", "10", "--clauses", "200", "--features",
                  "784", "--replicas", "4", "--requests", "512")
CLI_RETRAIN_ARGS = ("--clauses", "300", "--replicas", "4", "--requests",
                    "192")
CLI_EXAMPLE_DEPTH = {"torch_quickstart": dict(EPOCHS=1),
                     "torch_serve_quickstart": dict(EPOCHS=1)}
CLI_KERNELS = ("imbue_infer_planes", "imbue_infer_packed", "imbue_infer",
               "tm_infer_planes", "tm_infer", "clause_eval_packed",
               "clause_eval")
ANALOG_KERNELS = ("imbue_infer_planes",) + DENSE_KERNELS
# The mesh path, phase 3 (j): (a) a one-rank mesh in this process; (b)
# MESH_RANKS spawned ranks sharing the card over gloo (NCCL refuses two
# ranks on one GPU), each leg under MESH_TIMEOUT_S; (c) the serve CLI
# under torch.distributed.run with MESH_CLI_ARGS, beside the unsharded run
# with the same arguments.
MESH_RANKS = 4
MESH_TIMEOUT_S = 600
MESH_CLI_ARGS = ("--mesh", "2x2") + CLI_SERVE_ARGS
# The models path, phase 3 (k): the LM side path's forward, loss and
# decode (repro_torch.models) at the published widths of six archs
# (repro_torch.configs.archs), weights drawn from a seeded generator.
# Each runs at float32 compute (TF32 off) for its checks: decode
# against forward over MODEL_DECODE = (batch, positions), whisper's cross
# caches filled from its encoder first, MoE at capacity factor E / K (an
# expert then has a slot for every token of a row, so the forward drops
# none that decode keeps; the reference's test uses 8, which at
# deepseek-v2-lite's 64 experts top-6 gives 48 slots for 64 tokens and
# drops 2.6 % of them on these weights).
MODEL_ARCHS = ("qwen2-0.5b", "gemma2-2b", "xlstm-125m", "zamba2-1.2b",
               "whisper-large-v3", "deepseek-v2-lite-16b")
# deepseek-v2-lite-16b's published param_dtype is float32: its 15.7 B
# float32 weights leave no room on one 80 GB card, so its weights are
# bf16 and every shape is as published (reported as "reduced").
MODEL_OVERRIDES = {"deepseek-v2-lite-16b": {"param_dtype": "bfloat16"}}
MODEL_DECODE = (2, 64)
MODEL_DECODE_TOL = 2e-2      # the reference's bar (rtol = atol)
# float32 on the card against float32 on the host, one weight set drawn
# on the host and copied to the card, at (B, S) = MODEL_HOST_SHAPE, rtol =
# atol = MODEL_HOST_TOL[arch] on the logits.  Beside the gap the phase
# reads the gap with TF32 allowed and the model's rounding floor: how far
# its logits move on the card when every weight is scaled by 1 + 1e-7 x a
# normal draw.  xlstm-125m's stack amplifies rounding (on the host its
# smoke logits move 3.6e-4 under such a nudge), hence its wider bound.
MODEL_HOST_ARCHS = ("qwen2-0.5b", "xlstm-125m")
MODEL_HOST_SHAPE = (1, 256)
MODEL_HOST_TOL = {"qwen2-0.5b": 1e-3, "xlstm-125m": 1e-2}
MODEL_NUDGE = 1e-7
# qwen2-0.5b at its published blocked_attn_threshold (8192): the blocked
# online-softmax path against the SDPA path (threshold raised) on the
# same float32 input, the final hidden states within MODEL_BLOCKED_TOL.
MODEL_BLOCKED_SHAPE = (1, 8192)
MODEL_BLOCKED_TOL = 1e-3
# bf16 readings of qwen2-0.5b at its published compute dtype (not
# claims): prefill of B x S with last_only, and decode steps at B against
# a cache of `cache` slots, CUDA events, median of `reps`.
MODEL_BF16 = dict(arch="qwen2-0.5b", batch=4, prefill=2048, cache=2048,
                  warmup_steps=4, steps=32, reps=3)
# Every arch's smoke() on the card against the host (float32), and
# decode against forward at MODEL_SMOKE_DECODE for the reference's six
# (tests/test_models_smoke.py); B = 2, S = 64 for the forward.
MODEL_SMOKE_TOL = 1e-3
MODEL_SMOKE_DECODE = (2, 32)
MODEL_SMOKE_DECODE_ARCHS = ("qwen2-0.5b", "gemma2-2b", "xlstm-125m",
                            "zamba2-1.2b", "deepseek-v2-lite-16b",
                            "whisper-large-v3")
# The GPipe demo (repro_torch.distributed.pipeline) on PIPELINE_RANKS
# ranks sharing the card over gloo, under torch.distributed.run: the
# pipelined forward against sequential_apply within its 2e-5.
PIPELINE_RANKS = 4
# The lm_train path, phase 3 (l): LM training (repro_torch.optim,
# train.train_step, data.pipeline, launch.train).  Like the models it
# launches none of the eleven kernels.  (a) One AdamW step of qwen2-0.5b
# at its published widths and depth, float32 (float32_config, remat on as
# published), B x S = LM_HOST_SHAPE, from one weight set drawn on the host
# and copied to the card: the loss within rtol LM_HOST_TOL["loss"], every
# gradient leaf within LM_HOST_TOL["grad"] x max |g| (PR 27's float32
# forward gap at this arch was 6.7e-6 on logits of max 2.86; the backward
# sums over the batch in another order on each side), and the updated
# parameters within 2 x LM_HOST_LR: AdamW's first step moves a parameter
# by lr x g / (|g| + eps), so a gradient whose sign the two sides round
# differently (one near 0) moves it by at most 2 lr; the count of
# parameters past 1e-6 is read beside.  Then remat on against off on the
# card at LM_REMAT_SHAPE: the gradients within LM_REMAT_TOL x max |g| (the
# recomputation is the same arithmetic; the backward's atomics may add in
# another order) and each one's peak memory.
LM_HOST_ARCH = "qwen2-0.5b"
LM_HOST_SHAPE = (2, 64)
LM_HOST_LR = 1e-3
LM_HOST_TOL = {"loss": 1e-5, "grad": 1e-4}
LM_REMAT_SHAPE = (8, 256)
LM_REMAT_TOL = 1e-5
# (b) The trainer at full width, `python -m repro_torch.launch.train
# --full` in this process (bf16 compute, float32 parameters and AdamW
# state, the config's remat), one model at a time: each run's losses
# finite and the last below the first; ms a step and tokens/s from CUDA
# events around each step (the median after the first), the peak memory.
# xlstm-125m (the launcher's default arch) runs the resume cycle: 8 steps
# with checkpoints every 4, a restart to 12 that resumes from step 8, and
# one uninterrupted 12-step run, whose steps 8-11 the resumed ones equal
# within LM_RESUME_TOL (absolute; the CE's gather backward adds with
# atomics on the card, so equality is read, not assumed).  The warm-up is
# 20 steps, so a run of 8 and one of 12 share the schedule up to step 12;
# the runs take --lr LM_TRAIN_LR (10x the launcher's default), so that
# the warm-up's first 6-12 steps move the loss past the noise between
# batches.
LM_TRAIN_LR = "3e-3"
LM_TRAIN_RUNS = (
    ("qwen2-0.5b", ("--arch", "qwen2-0.5b", "--batch", "8", "--seq", "256",
                    "--steps", "12")),
    ("zamba2-1.2b", ("--arch", "zamba2-1.2b", "--batch", "8", "--seq", "256",
                     "--microbatches", "2", "--steps", "6")),
    ("whisper-large-v3", ("--arch", "whisper-large-v3", "--batch", "8",
                          "--seq", "256", "--steps", "6")),
)
LM_RESUME = dict(arch="xlstm-125m", first=8, total=12, every=4)
LM_RESUME_TOL = 1e-3
# One more step of this run under torch.profiler: where the eager step's
# time goes (host against device, launches, the heaviest kernels).
LM_PROFILE_RUN = "qwen2-0.5b"
# (c) Every smoke() arch: LM_SMOKE["steps"] AdamW steps at lr 3e-3 on one
# fixed batch (the reference's test_smoke_loss_decreases), on the card and
# on the host from the same weights: the CE falls, the first step moves
# every parameter, and the first step's loss on the card equals the
# host's within LM_SMOKE_TOL (PR 27's smoke forwards: under 5e-6 on
# logits, xlstm 7.1e-4).
LM_SMOKE = dict(steps=8, lr=3e-3, batch=2, seq=64)
LM_SMOKE_TOL = {"xlstm-125m": 2e-3}
LM_SMOKE_TOL_DEFAULT = 1e-4
# (d) LM_RANKS ranks sharing the card over gloo: one data-parallel AdamW
# step (lr 1e-2, B = 4 x 64) of smoke qwen2-0.5b and smoke
# deepseek-v2-lite-16b (d_model 64) on make_debug_mesh(2, 2) and (4, 1)
# against one rank on the whole batch, at the reference's bars (loss rtol
# 2e-4, parameters 3e-3; tests/test_distributed.py:40-81);
# compressed_psum_grads on a data mesh of 4 within 0.05 of max |g|, 2
# bytes an element on the wire; then the trainer with LM_MESH_CLI_ARGS
# under torch.distributed.run: 8 steps, a restart to 12 from step 8.
LM_RANKS = 4
LM_DP = dict(d_model=64, batch=4, seq=64, lr=1e-2, loss_rtol=2e-4,
             param_tol=3e-3)
LM_MESH_CLI_ARGS = ("--mesh", "debug", "--arch", "qwen2-0.5b", "--batch",
                    "8", "--seq", "64", "--ckpt-every", "4", "--log-every",
                    "1")
# The roofline path, phase 3 (m): the port's cost model
# (repro_torch.roofline, launch.dryrun).  (a) The dry run on the
# production meshes (torch's in-process fake group of 256 / 512 ranks, the
# meta device), one process a cell, all started together: every kind at
# full width.  Every record has positive memory_s and model_flops, and
# positive compute_s but for tm_train, whose plain clause evaluation
# (AND + popcount over packed words) runs no product; the skipped cells
# are launch.shapes' own.
ROOFLINE_CELLS = (
    ("qwen2-0.5b", "train_4k", "both"),
    ("deepseek-v2-lite-16b", "prefill_32k", "single"),
    ("arctic-480b", "decode_32k", "single"),
    ("zamba2-1.2b", "long_500k", "single"),
    ("imbue-tm-mnist", "tm_train_4k", "single"),
    ("imbue-tm-mnist", "tm_infer_32k", "single"),
    ("imbue-tm-mnist", "imbue_infer_32k", "single"),
)
ROOFLINE_TIMEOUT_S = 600
# (b) Three steps the port runs on the card, each counted there under
# roofline.StepCost and on meta (one rank): FLOPs equal, bytes within
# ROOFLINE_BYTES_RTOL; the step timed with CUDA events (median of
# ROOFLINE_REPS after a warm-up) at or above its bound max(compute_s,
# memory_s); the dry run's peak estimate beside max_memory_allocated, the
# ratio within ROOFLINE_PEAK_BAND.  The trainer's qwen2-0.5b step of
# LM_TRAIN_RUNS (bf16 compute, float32 AdamW), and the models path's
# MODEL_BF16 prefill and decode.
ROOFLINE_BYTES_RTOL = 0.01
ROOFLINE_REPS = 5
ROOFLINE_PEAK_BAND = (0.5, 2.0)
# (c) The bf16-cache repair: whisper-large-v3 at published width (float32
# compute, so float32 queries meet the bf16 cross caches) decodes
# ROOFLINE_WHISPER_DECODE = (batch, steps) from init_decode_state's
# default bf16 state against its own forward at MODEL_DECODE_TOL.
ROOFLINE_WHISPER_DECODE = (2, 8)
# The tp path, phase 3 (n): tensor parallelism on the model axis for the
# LM side path (sharding.use_sharding under launch.mesh.rules_for: heads,
# MLP, vocab, experts and the decode cache's sequence on "model"),
# TP_RANKS ranks sharing the card over gloo on make_debug_mesh(2, 2),
# each checked against the same work on one rank.  (a) qwen2-0.5b at its
# published widths, depth cut to TP_QWEN_LAYERS layers, float32
# (float32_config), B x S = TP_SHAPE: loss_fn's loss and every gradient
# within TP_TOL x max |g| of one rank's; one AdamW step at TP_LR (lr x
# g / (|g| + eps) moves an entry whose gradient is near eps by up to lr
# under any reordering of the sums, so lr keeps that inside the bar) with
# the updated parameters within TP_TOL x max |p| and every leaf the
# one-rank step moves moved as far; that bar is wider than the whole
# update, so the step is also held by what it is made of: the gradients
# the train step hands the optimizer (rows split over "data" and
# averaged) within TP_TOL x max |g| of the one-rank step's, and each
# entry's move within TP_MOVE_TOL x lr of the one-rank move wherever the
# one-rank step's gradient is at least TP_MOVE_MIN_G of its largest (the
# move there is lr x sign(g)); then the trainer's step
# (launch.dryrun.build_step, AdamW) counted on the card under StepCost
# (a rank's FLOPs, bytes and collective bytes) and timed (CUDA events,
# median of TP_REPS), and each rank's peak max_memory_allocated.  (b)
# deepseek-v2-lite-16b at its published widths with bf16 weights
# (MODEL_OVERRIDES), depth cut to TP_DEEPSEEK_LAYERS (the dense MLA
# prologue layer and one MoE layer), float32 compute with MoE at capacity
# E / K (float32_config): the forward at TP_SHAPE and TP_DECODE decode
# steps on a kv_seq-split cache of TP_DECODE slots (half on each model
# rank), against one process, run first in this process and released
# before the ranks start, within MODEL_DECODE_TOL.  (c) arctic-480b's
# smoke() with seq_parallel on (as launch.shapes sets it), remat on and
# two CE chunks: (a)'s checks.  (d) The trainer's step of (a) counted on
# meta on a fake (2, 2) group in this process against rank 0's count on
# the card: FLOPs equal, bytes within ROOFLINE_BYTES_RTOL.  (e) The SSM
# mixers on "model": zamba2-1.2b at its published widths cut to
# TP_ZAMBA_LAYERS (the two-layer Mamba2 prologue and one super-block: the
# shared attention + MLP and five Mamba2 layers; 64 heads, 32 a rank) and
# xlstm-125m cut to TP_XLSTM_LAYERS (one super-block: five mLSTM layers,
# whose 4 heads split 2 a rank, and the replicated sLSTM), float32: each
# rank's loss_fn loss within TP_TOL, every gradient within the larger of
# TP_TOL x max |g| and TP_FLOOR_X x the models' rounding floor, and
# TP_DECODE decode steps (the SSM caches hold a rank's heads) within
# MODEL_DECODE_TOL, of the same work on one rank at TP_SHAPE.  The floor
# is read in the same run: the most one process's gradients move when
# every weight is scaled by 1 + MODEL_NUDGE x a normal draw.  At these
# widths it is at or past TP_TOL on its own (on an H100, two draws moved
# zamba2's gradients 2.2e-5 and 2.4e-5 of the largest, xlstm's 4.7e-5
# and 6.6e-5), and a reordering of the sums is a perturbation of that
# size.  Ranks sharing one card over gloo make these mechanism readings
# only.
TP_RANKS = 4
TP_SHAPE = (2, 64)
TP_QWEN_LAYERS = 4
TP_DEEPSEEK_LAYERS = 2
TP_ZAMBA_LAYERS = 8
TP_XLSTM_LAYERS = 6
TP_FLOOR_X = 2
TP_DECODE = 8
TP_TOL = 2e-5
TP_LR = 1e-5
TP_MOVE_TOL = 0.05
TP_MOVE_MIN_G = 1e-3
TP_REPS = 3
TP_TIMEOUT_S = 600
# Flash attention at the attention widths of three architectures the repo
# registers (src/repro/configs/archs.py; the numbers are copied, the port
# imports nothing of the reference), in the models' compute dtype (bf16),
# the kv heads gathered up to the q heads as the models' _expand_kv does
# (q head i reads kv head i // (h // kv)).
FLASH_ROWS = {
    # train_4k's sequence; 2 kv heads gathered to 14.
    "main": dict(arch="qwen2-0.5b", b=4, s=4096, h=14, kv=2, d=64,
                 causal=True, window=0, softcap=0.0, dtype="bfloat16"),
    # Every mask at once; S > window, so the window bites.
    "local": dict(arch="gemma2-2b", b=1, s=8192, h=8, kv=4, d=256,
                  causal=True, window=4096, softcap=50.0, dtype="bfloat16"),
    # Non-causal and ragged (1500 post-conv frames) at a real width.
    "bidir": dict(arch="whisper-large-v3 encoder", b=4, s=1500, h=20, kv=20,
                  d=64, causal=False, window=0, softcap=0.0,
                  dtype="bfloat16"),
}
# Edge cases, each mask combination of tests/test_kernels.py:148-154, so
# that every dtype x head-dim instance of the kernels is checked: float32
# at every head dim, bfloat16 at the two the model rows leave out.
FLASH_SMALL = [dict(arch="small", b=2, s=s, h=2, kv=2, d=d, causal=causal,
                    window=window, softcap=cap, dtype=dtype)
               for dtype, shapes in (
                   ("float32", ((300, 32), (200, 64), (256, 128), (160, 256))),
                   ("bfloat16", ((300, 32), (256, 128))))
               for s, d in shapes
               for causal, window, cap in ((True, 0, 0.0), (True, 100, 0.0),
                                           (True, 0, 50.0), (False, 0, 0.0))]
# One bf16 ulp is at most 2^-7 of the value it rounds.
BF16_ULP = 2.0 ** -7
# Each compared tensor's limit, as (measure, limit) on the measures of
# flash_err.  float32: the reference's own bounds on max|kernel - plain| /
# max|plain| (tests/test_kernels.py:166,207), 2e-5 forward, 5e-4
# gradients.  bfloat16: kernel and plain version read the same bf16
# inputs, compute in float32 and round to bf16, so they may differ by one
# ulp where the two float32 values straddle a rounding step, plus float
# order; "ulp_excess" holds every element at |kernel - plain| <= BF16_ULP
# |plain| + limit * max|plain|: 1e-3 for dQ, dK and dV, 2e-3 for o, whose
# P is rounded to bf16 on both sides, so a float-order difference in a
# score can move P by one bf16 ulp and o by up to 2^-8 |v| / l.  lse is
# float32 from float32 scores in both dtypes.  The trainable's bf16
# gradients run through dO = 2 (o - tgt) of the kernel's own o, whose
# one-ulp flips spread over whole rows of dK / dV: "norm_rel", ||kernel -
# plain|| / ||plain||.  Readings and margins are in PERF.md (PR 15).
FLASH_TOL = {
    "float32": {"o": ("max_rel", 2e-5), "lse": ("max_rel", 2e-5),
                "grad": ("max_rel", 5e-4), "trainable": ("max_rel", 5e-4)},
    "bfloat16": {"o": ("ulp_excess", 2e-3), "lse": ("max_rel", 2e-5),
                 "grad": ("ulp_excess", 1e-3),
                 "trainable": ("norm_rel", 5e-3)},
}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
FLASH_PATH_STEPS = 3
# The bf16 backward kernels split P and dS into bf16 hi + lo and run
# two products for each of them: 6 products of 2 * d a visible pair
# where the algorithm needs 4 (dK / dV), 4 where it needs 3 (dQ).  The
# bound stays the algorithm's; the timing rows show the split's tensor
# work beside it.
SPLIT_PRODUCTS = {"flash_bwd_dkv": 6 / 4, "flash_bwd_dq": 4 / 3}
BF16_FLOP_PER_S = roofline.BF16_FLOPS   # dense, tensor cores
# Special-function unit (exp, tanh) rate on compute capability 9.0, per
# clock per SM (the same table as the POPC rate).
SFU_PER_CLOCK_PER_SM = 16


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str, *fmt: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=" + ",".join(("csv", "noheader", *fmt))], check=True,
        capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def nvidia_smi_line() -> str:
    return nvidia_smi("name,power.limit")


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's max SM clock (``nvidia-smi``)."""
    return float(nvidia_smi("clocks.max.sm", "nounits")) * 1e6


def popc_per_s() -> float:
    """The card's POPC rate: 16 per clock per SM x its SMs x its max SM
    clock."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return POPC_PER_CLOCK_PER_SM * n_sm * sm_clock_hz()


def lop3_per_s() -> float:
    """The card's 32-bit logic rate: 64 per clock per SM x its SMs x its
    max SM clock."""
    return popc_per_s() * LOP3_PER_CLOCK_PER_SM / POPC_PER_CLOCK_PER_SM


def kernel_pair(name):
    """``(wrapper, plain version)`` of kernel ``name``."""
    from repro_torch.kernels import clause_eval, flash_attention, imbue_infer
    if name.startswith("flash"):
        return (getattr(flash_attention, name),
                getattr(flash_attention, f"{name}_plain"))
    mod = imbue_infer if name.startswith("imbue") else clause_eval
    return getattr(mod, name), getattr(mod, f"{name}_ref")


# ------------------------------------------------------------------ data

def prototype_task(cfg, n, seed, flip=FLIP):
    """A TA state whose clauses recognise numpy-drawn class prototypes,
    and ``n`` labelled requests (prototypes with ``flip`` of bits
    flipped).  Positive clauses of class m include 8-16 literals that are
    1 on prototype m; negative ones do the same for another class."""
    rng = np.random.default_rng(seed)
    m_cls, f = cfg.n_classes, cfg.n_features
    protos = (rng.random((m_cls, f)) < 0.5).astype(np.uint8)
    proto_lits = np.concatenate([protos, 1 - protos], axis=1)
    include = np.zeros((cfg.n_clauses, cfg.n_literals), bool)
    for c in range(cfg.n_clauses):
        m, j = divmod(c, cfg.clauses_per_class)
        src = m if j % 2 == 0 else (m + 1 + (j // 2) % (m_cls - 1)) % m_cls
        ones = np.flatnonzero(proto_lits[src])
        k = int(rng.integers(8, 17))
        include[c, rng.choice(ones, size=min(k, ones.size),
                              replace=False)] = True
    n_st = cfg.n_states
    ta = np.where(include, rng.integers(n_st + 1, 2 * n_st + 1,
                                        include.shape),
                  rng.integers(1, n_st + 1, include.shape)).astype(np.int16)
    y = rng.integers(0, m_cls, n)
    x = protos[y] ^ (rng.random((n, f)) < flip).astype(np.uint8)
    return ta, x.astype(np.uint8), y


def coalesced_task(ccfg, n, seed, flip=FLIP, protos=None):
    """A coalesced model and ``n`` labelled requests.  Clause ``c`` has
    class ``c % M`` and includes 8-16 literals that are 1 on that class's
    prototype (drawn uniformly unless ``protos`` ``[M, F]`` is given); its
    weights are integers in [-127, 127], 64-127 for its own class and
    -127..31 for the others, so predictions are not noise."""
    rng = np.random.default_rng(seed)
    m_cls, f, c_n = ccfg.n_classes, ccfg.n_features, ccfg.n_clauses
    if protos is None:
        protos = (rng.random((m_cls, f)) < 0.5).astype(np.uint8)
    proto_lits = np.concatenate([protos, 1 - protos], axis=1)
    own = np.arange(c_n) % m_cls
    include = np.zeros((c_n, ccfg.n_literals), bool)
    for c in range(c_n):
        ones = np.flatnonzero(proto_lits[own[c]])
        k = int(rng.integers(8, 17))
        include[c, rng.choice(ones, size=min(k, ones.size),
                              replace=False)] = True
    n_st = ccfg.n_states
    ta = np.where(include, rng.integers(n_st + 1, 2 * n_st + 1,
                                        include.shape),
                  rng.integers(1, n_st + 1, include.shape)).astype(np.int16)
    w = rng.integers(-127, 32, (c_n, m_cls))
    w[np.arange(c_n), own] = rng.integers(64, 128, c_n)
    y = rng.integers(0, m_cls, n)
    x = protos[y] ^ (rng.random((n, f)) < flip).astype(np.uint8)
    return ta, w.astype(np.int32), x.astype(np.uint8), y


def image_task(n_classes, side, density, noise, n_train, n_test, seed):
    """``(x_train, y_train, x_test, y_test)`` drawn with numpy: one random
    prototype per class (each pixel on with ``density``), and each example
    its class's prototype with every pixel flipped with ``noise``; ``x``
    uint8 ``[n, side * side]``, ``y`` int64."""
    rng = np.random.default_rng(seed)
    f = side * side
    protos = (rng.random((n_classes, f)) < density).astype(np.uint8)

    def make(n):
        y = rng.integers(0, n_classes, n)
        flips = (rng.random((n, f)) < noise).astype(np.uint8)
        return protos[y] ^ flips, y
    return (*make(n_train), *make(n_test))


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def draw_streams(kind, gen, n, n_frames, channels):
    """``n`` raw streams from the port's generator on the CPU ``gen``
    (numpy): KWS ``(frames [n, T, mels], utterance labels [n])``, anomaly
    ``(frames [n, T, sensors], per-frame labels [n, T])``."""
    from repro_torch.data import tm_datasets
    if kind == "kws":
        x, y = tm_datasets.synthetic_kws6(gen, n, n_frames, channels,
                                          device="cpu")
    else:
        x, y = tm_datasets.synthetic_sensor_anomaly(gen, n, n_frames,
                                                    channels, device="cpu")
    return x.numpy(), y.numpy()


def stream_arrays(task):
    """A streaming task's ``(x_train, labels_train, x_test, labels_test)``,
    drawn on one CPU generator seeded ``task["seed"]``, train first."""
    gen = torch.Generator().manual_seed(task["seed"])
    return (*draw_streams(task["kind"], gen, task["n_train"],
                          task["n_frames"], task["channels"]),
            *draw_streams(task["kind"], gen, task["n_test"],
                          task["n_frames"], task["channels"]))


def stream_fields(task):
    """``TMConfig`` fields of a streaming task."""
    return dict(n_classes=task["n_classes"],
                clauses_per_class=task["clauses_per_class"],
                n_features=task["window"] * task["channels"] * task["bits"],
                **STREAM_HPARAMS)


def stream_config(task):
    from repro_torch.core.tm import TMConfig
    return TMConfig(**stream_fields(task))


def coalesced_config():
    from repro_torch.core.coalesced import CoalescedConfig
    return CoalescedConfig(**COALESCED)


def tm_case(include, x, comb, device):
    """Operands of the three TM kernels for one shape: ``{"packed":
    (litw, incw, comb), "dense": (lits, include, comb)}``, plus the share
    of (row, clause) pairs that fire."""
    from repro_torch.core import tm
    from repro_torch.kernels import ops
    lits = tm.literals(torch.from_numpy(x).to(device)).contiguous()
    include = include.to(device).contiguous()
    comb = comb.to(device).contiguous()
    fired = tm.clause_outputs_from_include(include, lits)
    return ({"packed": (ops.pack_literals(lits), ops.pack_literals(include),
                        comb),
             "dense": (lits, include, comb)},
            float(fired.float().mean()))


def tm_widths(device, n=128, seed=SEED):
    """The TM kernels' main-path widths: ``(label, include, comb, x)`` at
    the digital width (imbue-tm-mnist, polarity) and the coalesced width
    (weights), both combine matrices with empty clauses zeroed."""
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core import tm
    from repro_torch.kernels import ops
    cfg = tm_config(MODEL)
    ta, x, _ = prototype_task(cfg, n, seed)
    inc = tm.include_mask(torch.from_numpy(ta).to(device), cfg)
    out = [("digital", inc, ops.polarity_matrix(cfg, inc, device=device), x)]
    ccfg = coalesced_config()
    cta, w, cx, _ = coalesced_task(ccfg, n, seed + 1)
    cinc = torch.from_numpy(cta > ccfg.n_states).to(device)
    out.append(("coalesced", cinc,
                ops.coalesced_combine(torch.from_numpy(w).to(device),
                                      cinc.any(dim=-1)), cx))
    return out


def stream_widths(device, n=128, seed=SEED + 5):
    """The TM and clause kernels' operands at the streaming path's widths:
    ``(label, include, comb, x)`` at the KWS width (C = 1800, L = 768,
    M = 6; polarity), its coalesced pool (C = 900; weights) and the anomaly
    width (C = 600, L = 512, M = 2; polarity), ``n`` prototype requests
    each."""
    from repro_torch.core import tm
    from repro_torch.core.coalesced import CoalescedConfig
    from repro_torch.kernels import ops
    out = []
    for label, task in (("kws", KWS_TASK), ("anomaly", ANOMALY_TASK)):
        cfg = stream_config(task)
        ta, x, _ = prototype_task(cfg, n, seed)
        inc = tm.include_mask(torch.from_numpy(ta).to(device), cfg)
        out.append((label, inc, ops.polarity_matrix(cfg, inc, device=device),
                    x))
    ccfg = CoalescedConfig(**STREAM_COALESCED)
    cta, w, cx, _ = coalesced_task(ccfg, n, seed + 1)
    cinc = torch.from_numpy(cta > ccfg.n_states).to(device)
    out.insert(1, ("kws-coalesced", cinc, ops.coalesced_combine(
        torch.from_numpy(w).to(device), cinc.any(dim=-1)), cx))
    return out


def check_rows(x, b):
    """The first ``b`` rows of the 128 requests ``x``; past 128 the rest
    are the first rows again, each with one bit flipped."""
    if b <= len(x):
        return x[:b]
    extra = x[:b - len(x)].copy()
    extra[:, 0] ^= 1
    return np.concatenate([x, extra])


def planes_case(cfg, ta, x, n_replicas, with_dev, seed, device):
    """Kernel operands for one shape: literal words, index words, the
    deviation plane of ``n_replicas`` D2D-programmed chips (or None), the
    polarity matrix and the scalars."""
    from repro_torch.api.states import _deviation_plane
    from repro_torch.core import tm
    from repro_torch.core.imbue import IMBUEConfig, program_replica_stack
    from repro_torch.core.variations import VariationConfig
    from repro_torch.kernels import ops
    include = tm.include_mask(torch.from_numpy(ta).to(device), cfg)
    incw = ops.pack_literals(include)
    dev = None
    if with_dev:
        gen = torch.Generator(device=device).manual_seed(seed)
        r = program_replica_stack(include, gen, n_replicas,
                                  VariationConfig(csa_offset=False))
        _, dev = _deviation_plane(r, include)
    lits = tm.literals(torch.from_numpy(x).to(device))
    litw = ops.pack_literals(lits)
    pol = ops.polarity_matrix(cfg, include, device=device)
    scal = ops.plane_scalars(IMBUEConfig(), cfg.n_literals)
    return litw, incw, dev, pol.contiguous(), scal


def operand_bytes_and_ops(litw, incw, dev, pol, scal):
    """Bytes each input is read once and the output written once, and the
    fp32 operations this input needs (4 per cell: bit test, select, add,
    compare amortised), for the roofline bound."""
    b, lw = litw.shape
    c, m = pol.shape
    r = 1 if dev is None else dev.shape[0]
    nbytes = (litw.numel() + incw.numel() + pol.numel() + r * b * m) * 4
    if dev is not None:
        nbytes += dev.numel() * 4
    ops = 4 * r * b * c * scal.l_valid
    return nbytes, ops


def dense_case(cfg, ta, x, n_replicas, d2d, seed, device):
    """Operands of the two dense-plane kernels for one shape, keyed by
    kernel: literal words or bytes, the g / leak planes ``[R, C, L]`` of
    ``n_replicas`` D2D-programmed (or nominal) chips, the polarity matrix,
    ``i_ref`` and ``v_read``; plus the share of (row, clause) pairs that
    fire in the digital TM."""
    from repro_torch.core import tm
    from repro_torch.core.imbue import (IMBUEConfig, conductances,
                                        program_replica_stack)
    from repro_torch.core.variations import VariationConfig
    from repro_torch.kernels import ops
    include = tm.include_mask(torch.from_numpy(ta).to(device), cfg)
    vcfg = (VariationConfig(csa_offset=False) if d2d
            else VariationConfig.nominal())
    gen = torch.Generator(device=device).manual_seed(seed)
    icfg = IMBUEConfig()
    g, leak = conductances(program_replica_stack(include, gen, n_replicas,
                                                 vcfg), include, icfg)
    lits = tm.literals(torch.from_numpy(x).to(device)).contiguous()
    rest = (g.contiguous(), leak.contiguous(),
            ops.polarity_matrix(cfg, include, device=device).contiguous(),
            icfg.reference_voltage() / icfg.r_divider, icfg.v_read)
    fired = tm.clause_outputs_from_include(include, lits)
    return ({"imbue_infer_packed": (ops.pack_literals(lits), *rest),
             "imbue_infer": (lits, *rest)}, float(fired.float().mean()))


def dense_bytes_and_ops(a, g, leak, pol, i_ref, v_read):
    """Bytes each input is read once and the output written once, and the
    fp32 operations this input needs (4 per (r, b, c, l): bit test,
    select, add, compare amortised, as for ``imbue_infer_planes``)."""
    r, c, l = g.shape
    b, m = a.shape[0], pol.shape[1]
    nbytes = (a.numel() * a.element_size()
              + (g.numel() + leak.numel() + pol.numel() + r * b * m) * 4)
    return nbytes, 4 * r * b * c * l


def issue_floor_ms(fp32_ops):
    """The analog inner loop's issue floor: three instructions a (row,
    cell) (bit to predicate, FSEL, FADD) where the bound counts four fp32
    operations, at 4 schedulers x 32 lanes an SM and the max SM clock."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return 0.75 * fp32_ops / (n_sm * 4 * 32 * sm_clock_hz()) * 1e3


def bound_ms(nbytes, work):
    """The larger of the bytes' time and the operations' time; ``work`` is
    ``[(ops, ops_per_s), ...]``, one term per operand type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(ops / rate for ops, rate in work) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def tm_bytes_and_work(name, args):
    """Bytes each input is read once and the output written once, and the
    operations this input needs with the rate of their type: for the
    packed kernels B*C*Lw word steps of one 32-bit logic operation each
    (only viol == 0 is kept, an OR of ~lit & inc, as for
    ``clause_eval_packed``); for ``tm_infer`` 2*B*C*L operations of the
    violation product, whose operands are 0/1 bytes, at the card's int8
    rate; for all three 2*B*C*M operations of the int32 combine at the
    32-bit rate outside the tensor cores."""
    a, inc, comb = args
    (b, k), (c, m) = a.shape, comb.shape
    nbytes = (a.numel() * a.element_size() + inc.numel() * inc.element_size()
              + comb.numel() * 4 + b * m * 4)
    combine = (2 * b * c * m, FP32_FLOP_PER_S)
    if name == "tm_infer":
        return nbytes, [(2 * b * c * k, INT8_OP_PER_S), combine]
    return nbytes, [(b * c * k, lop3_per_s()), combine]


# ---------------------------------------------------------------- phases

def phase_environment():
    from repro_torch.kernels import _build
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    secs = _build.build(list(KERNELS))
    ptxas = [ln.strip() for name in KERNELS
             for ln in _build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln or "wgmma" in ln]
    instances = flash_bf16_instances()
    bare = [r for r in instances if r["route"] == "wgmma" and not r["hgmma"]]
    if bare:
        raise AssertionError(f"flash bf16 instances on wgmma without an "
                             f"HGMMA in their SASS: {bare}")
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "sm_count": torch.cuda.get_device_properties(0)
          .multi_processor_count,
          "max_sm_clock_mhz": nvidia_smi("clocks.max.sm", "nounits"),
          "popc_per_s": popc_per_s(),
          "build_s": time.perf_counter() - t0, "build_s_per_kernel": secs,
          "ptxas": ptxas, "flash_bf16_instances": instances,
          "analog_instances": analog_instances(),
          "b1_instances": b1_instances()})
    return smi


def ptxas_entries(log):
    """``{mangled entry: {"registers", "spill_stores", "spill_loads",
    "smem_static"}}`` from the ``-Xptxas -v`` lines of a build log."""
    entries, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = entries.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem_static"] = int(m.group(1)) if m else 0
    return entries


def sass_counts(lib, patterns):
    """``{mangled function: {key: number of SASS instructions matching
    patterns[key]}}`` in a built library (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1)
            counts[cur] = dict.fromkeys(patterns, 0)
        elif cur:
            for key, pat in patterns.items():
                if re.search(pat, ln):
                    counts[cur][key] += 1
    return counts


def hgmma_counts(lib):
    """``{mangled function: number of HGMMA.*.F32.BF16 instructions}`` in
    the SASS of a built library."""
    return {f: c["hgmma"] for f, c in sass_counts(
        lib, {"hgmma": r"HGMMA\.\S*\.F32\.BF16"}).items()}


# SASS opcodes recorded for the analog kernels: the inner loop's bit
# test (LOP3 to a predicate), its predicated adds (two a (row, cell) on
# csrc/imbue_core.cuh, one of which runs), any select, and any
# tensor-core instruction (there must be none: the column currents are
# IEEE float32).
ANALOG_SASS = {"LOP3_to_P": r"\bLOP3\.LUT P\d", "FSEL": r"\bFSEL\b",
               "FADD": r"\bFADD\b",
               "FADD_predicated": r"@!?P\d+\s+FADD\b",
               "tensor": r"\b(HMMA|HGMMA|IMMA|DMMA)\b"}


def analog_instances():
    """Each entry function of the three analog kernels: registers, spills
    and static shared memory (ptxas), and its ``ANALOG_SASS``
    instruction counts (``cuobjdump -sass``).  A tensor-core instruction,
    or an instance without the core's predicated adds (at least one a
    cell of its four rows at once), fails."""
    from repro_torch.kernels import _build
    rows = []
    for name in ("imbue_infer_planes",) + DENSE_KERNELS:
        sass = sass_counts(_build.library_path(name), ANALOG_SASS)
        for entry, info in ptxas_entries(_build.build_log(name)).items():
            rows.append({"kernel": name, "entry": entry, **info,
                         **sass.get(entry, {})})
    bad = [r for r in rows if r.get("tensor")
           or r.get("FADD_predicated", 0) < 4 * 32]
    if bad or not rows:
        raise AssertionError(f"analog kernels with tensor-core "
                             f"instructions or without predicated adds, "
                             f"or none built: {bad}")
    return rows


# The kernels on the b1 tensor-core core (csrc/tm_b1.cuh).
B1_KERNELS = ("clause_eval_packed", "tm_infer_planes", "tm_infer_packed",
              "tm_infer")


def b1_instances():
    """Each entry function of the four kernels on ``csrc/tm_b1.cuh``
    (``B1_KERNELS``): registers and spills (ptxas) and its ``BMMA`` (the
    b1 tensor-core product), ``LOP3`` and ``POPC`` counts.  An instance
    without a ``BMMA`` fails."""
    from repro_torch.kernels import _build
    rows = []
    for name in B1_KERNELS:
        sass = sass_counts(_build.library_path(name),
                           {"BMMA": r"\bBMMA\b", "LOP3": r"\bLOP3\b",
                            "POPC": r"(?<![.\w])POPC\b"})
        rows += [{"kernel": name, "entry": entry, **info,
                  **sass.get(entry, {})}
                 for entry, info in ptxas_entries(
                     _build.build_log(name)).items()]
    bare = [r for r in rows if not r.get("BMMA")]
    if bare or {r["kernel"] for r in rows} != set(B1_KERNELS):
        raise AssertionError(f"b1 kernels with an instance without a BMMA, "
                             f"or not built: {rows}")
    return rows


def flash_bf16_instances():
    """Each bf16 instance of the flash kernels: its route (the ``_tc``
    kernels on wgmma; any bf16 instance of the FFMA kernels would show as
    ``ffma``), head dim, registers, spills and shared memory (static from
    ptxas; the dynamic share from the ``<name>_tc_smem`` query), and the
    HGMMA instructions in its SASS."""
    import ctypes
    from repro_torch.kernels import _build
    rows = []
    for name in FLASH_KERNELS:
        path = _build.library_path(name)
        lib = ctypes.CDLL(str(path))
        smem = getattr(lib, f"{name}_tc_smem", None)
        hgmma = hgmma_counts(path)
        for entry, info in ptxas_entries(_build.build_log(name)).items():
            tc = "_tc" in entry
            if not (tc or "__nv_bfloat16" in entry):
                continue
            d = int(re.search(r"Li(\d+)E", entry).group(1))
            rows.append({"kernel": name, "d": d,
                         "route": "wgmma" if tc else "ffma", **info,
                         "smem_dynamic": smem(d) if tc and smem else None,
                         "hgmma": hgmma.get(entry, 0)})
    return sorted(rows, key=lambda r: (r["kernel"], r["d"]))


def phase_kernels(device):
    """Each kernel against its plain version on the card."""
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core.tm import TMConfig
    from repro_torch.kernels.imbue_infer import (imbue_infer_planes,
                                                 imbue_infer_planes_ref)
    cfg = tm_config(MODEL)
    ta, x, _ = prototype_task(cfg, 128, SEED)
    shapes = [(cfg, ta, check_rows(x, b), r, with_dev)
              for with_dev in (False, True)
              for r in ((1, 4) if with_dev else (1,))
              for b in CHECK_BATCHES]
    small = TMConfig(n_classes=4, clauses_per_class=8, n_features=37,
                     n_states=100)
    sta, sx, _ = prototype_task(small, 13, SEED + 1)
    shapes.append((small, sta, sx, 3, True))
    for task in (KWS_TASK, ANOMALY_TASK):              # the stream path
        cfg_t = stream_config(task)
        tta, tx, _ = prototype_task(cfg_t, 128, SEED + 5)
        shapes.append((cfg_t, tta, tx, REPLICAS, True))
    rows, max_err = [], 0
    for i, (cfg_i, ta_i, x_i, r, with_dev) in enumerate(shapes):
        ops_in = planes_case(cfg_i, ta_i, x_i, r, with_dev, SEED + i, device)
        got = imbue_infer_planes(*ops_in)
        want = imbue_infer_planes_ref(*ops_in)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        nonzero = float((want != 0).float().mean())
        rows.append({"C": cfg_i.n_clauses, "L": cfg_i.n_literals,
                     "R": r, "B": int(x_i.shape[0]), "dev": with_dev,
                     "max_abs_err": err, "nonzero_frac": nonzero})
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"imbue_infer_planes disagrees with its "
                                 f"plain version: {rows[-1]}")
        if nonzero < 0.05:
            raise AssertionError(f"parity of (mostly) zeros: {rows[-1]}")
        max_err = max(max_err, err)
    emit({"phase": "kernels", "kernels": ["imbue_infer_planes"],
          "tolerance": 0, "cases": rows})
    return {"imbue_infer_planes": max_err}


def unaligned_bytes(t):
    """A contiguous copy of byte tensor ``t`` that starts one byte past a
    16-byte boundary (a ``[1:]`` slice of a wider buffer)."""
    buf = torch.empty(t.numel() + 1, dtype=torch.uint8, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t.view(torch.uint8))
    if not view.is_contiguous() or view.data_ptr() % 16 != 1:
        raise AssertionError("the unaligned view is not one byte past 16")
    return view


def phase_tm_kernels(device):
    """The three TM kernels against their plain versions, tolerance 0, at
    both widths, B in CHECK_BATCHES and 256, the ragged shape, the
    streaming widths at B = 128, and ``tm_infer`` on byte operands one
    byte past a 16-byte boundary."""
    from repro_torch.core.coalesced import CoalescedConfig
    from repro_torch.kernels import ops
    cases = [(label, inc, comb, x[:b], False) for label, inc, comb, x
             in tm_widths(device, n=TM_CHECK_BATCHES[-1])
             for b in TM_CHECK_BATCHES]
    ragged = CoalescedConfig(n_classes=3, n_clauses=101, n_features=37,
                             n_states=100)                 # C=101, L=74
    rta, rw, rx, _ = coalesced_task(ragged, 13, SEED + 2)   # B=13
    rinc = torch.from_numpy(rta > ragged.n_states)
    rinc[50] = False                                        # empty clause
    cases.append(("ragged", rinc, ops.coalesced_combine(
        torch.from_numpy(rw), rinc.any(dim=-1)), rx, False))
    cases += [(label, inc, comb, x, False)
              for label, inc, comb, x in stream_widths(device)]
    label, inc, comb, x, _ = next(c for c in cases if c[0] == "coalesced"
                                  and len(c[3]) == 128)
    cases.append((label, inc, comb, x, True))               # unaligned
    rows, max_err = [], dict.fromkeys(TM_KERNELS, 0)
    for label, inc, comb, x, unaligned in cases:
        args, fired = tm_case(inc, x, comb, device)
        names = ("tm_infer",) if unaligned else TM_KERNELS
        for name in names:
            fn, ref = kernel_pair(name)
            a = args["dense" if name == "tm_infer" else "packed"]
            if unaligned:
                a = (unaligned_bytes(a[0]), unaligned_bytes(a[1]), a[2])
            got, want = fn(*a), ref(*a)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            nonzero = float((want != 0).float().mean())
            rows.append({"kernel": name, "width": label,
                         "C": int(inc.shape[0]), "L": int(inc.shape[1]),
                         "B": int(x.shape[0]), "unaligned": unaligned,
                         "max_abs_err": err, "nonzero_frac": nonzero,
                         "fired_frac": fired})
            if err != 0 or not torch.equal(got, want):
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {rows[-1]}")
            if nonzero < 0.05 or fired < 0.01:
                raise AssertionError(f"parity of (mostly) zeros or of "
                                     f"unfired clauses: {rows[-1]}")
            max_err[name] = max(max_err[name], err)
    emit({"phase": "kernels", "kernels": list(TM_KERNELS), "tolerance": 0,
          "cases": rows})
    return max_err


def phase_dense_kernels(device):
    """The two dense-plane analog kernels against their plain versions,
    tolerance 0, on D2D and nominal planes, then the cross-tier check."""
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core.tm import TMConfig
    cfg = tm_config(MODEL)
    ta, x, _ = prototype_task(cfg, 128, SEED)
    shapes = [(cfg, ta, check_rows(x, b), r, d2d) for d2d in (True, False)
              for r in (1, 4) for b in CHECK_BATCHES]
    small = TMConfig(n_classes=4, clauses_per_class=8, n_features=37,
                     n_states=100)                         # C=32, L=74
    sta, sx, _ = prototype_task(small, 13, SEED + 1)       # B=13
    sta[5] = 1                                             # empty clause
    shapes.append((small, sta, sx, 3, True))
    rows, max_err = [], dict.fromkeys(DENSE_KERNELS, 0)
    for i, (cfg_i, ta_i, x_i, r, d2d) in enumerate(shapes):
        cases, fired = dense_case(cfg_i, ta_i, x_i, r, d2d, SEED + i, device)
        for name in DENSE_KERNELS:
            fn, ref = kernel_pair(name)
            got, want = fn(*cases[name]), ref(*cases[name])
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            nonzero = float((want != 0).float().mean())
            rows.append({"kernel": name, "C": cfg_i.n_clauses,
                         "L": cfg_i.n_literals, "R": r,
                         "B": int(x_i.shape[0]), "d2d": d2d,
                         "max_abs_err": err, "nonzero_frac": nonzero,
                         "fired_frac": fired})
            if err != 0 or not torch.equal(got, want):
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {rows[-1]}")
            if nonzero < 0.05 or fired < 0.01:
                raise AssertionError(f"parity of (mostly) zeros or of "
                                     f"unfired clauses: {rows[-1]}")
            max_err[name] = max(max_err[name], err)
    emit({"phase": "kernels", "kernels": list(DENSE_KERNELS),
          "tolerance": 0, "cases": rows})
    cross_tier_check(cfg, ta, x, device)
    return max_err


def cross_tier_check(cfg, ta, x, device):
    """On one D2D + stuck-at plane-packed stack at full width, read without
    C2C, the three analog CUDA backends give identical ``[R, B, M]``."""
    from repro_torch import api
    from repro_torch.core import tm
    from repro_torch.core.variations import FaultConfig, VariationConfig
    include = tm.include_mask(torch.from_numpy(ta).to(device), cfg)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    st = api.ReplicaStackState.program(
        include, gen, REPLICAS, cfg,
        VariationConfig(csa_offset=False)).pack_planes()
    # Rates low enough that most clauses survive: a check on live sums.
    st = st.inject_faults(gen, FaultConfig(stuck_lrs_rate=0.001,
                                           stuck_hrs_rate=0.001))
    lits = tm.literals(torch.from_numpy(x).to(device))
    outs = {name: api.get_backend(name).fn(st, lits)
            for name in ANALOG_BACKENDS}
    torch.cuda.synchronize()
    want = outs["analog-cuda-packed2"]
    for name, got in outs.items():
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from analog-cuda-packed2 "
                                 "on the faulted stack")
    nonzero = float((want != 0).float().mean())
    if st.plane_dev is None or nonzero < 0.05:
        raise AssertionError(f"cross-tier check on a degenerate stack "
                             f"(nonzero {nonzero})")
    emit({"phase": "kernels", "check": "cross-tier",
          "backends": list(ANALOG_BACKENDS), "R": REPLICAS,
          "B": int(x.shape[0]), "faulted_cells": int(
              (st.fault_mask != 0).sum()),
          "identical": True, "nonzero_frac": nonzero})


def serve_round(cfg, ta, x, y, vcfg, ecfg_kw, backend, kernel, device):
    """Serve ``x`` through one analog engine on ``backend``: one launch of
    ``kernel`` per dispatch, 0 fallbacks, and at nominal every response
    equal to the digital TM."""
    from repro_torch.core import tm
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    fn, _ = kernel_pair(kernel)
    eng = ServeEngine.from_ta_state(
        torch.from_numpy(ta), cfg, n_replicas=REPLICAS, seed=SEED,
        vcfg=vcfg, ecfg=EngineConfig(**ecfg_kw), device=device)
    if eng.backend.name != backend or eng.selection.fell_back:
        raise AssertionError(f"round not on {backend}: "
                             f"{eng.backend.name} {eng.selection}")
    routing = eng.ecfg.routing
    launches0 = fn.launches
    t0 = time.perf_counter()
    eng.submit_many(list(x))
    eng.pump()
    out = eng.drain()
    wall = time.perf_counter() - t0
    s = eng.summary()
    launches = fn.launches - launches0
    if len(out) != len(x) or s["fallback_dispatches"] != 0:
        raise AssertionError(f"served {len(out)} of {len(x)}, "
                             f"{s['fallback_dispatches']} fallbacks")
    if launches != s["batches"]:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{s['batches']} dispatches")
    preds = np.array([r.pred for r in out])
    digital = tm.forward(torch.from_numpy(ta).to(device),
                         torch.from_numpy(x).to(device), cfg).cpu().numpy()
    row = {"phase": "serving", "vcfg": {"d2d": vcfg.d2d, "c2c": vcfg.c2c,
                                        "csa_offset": vcfg.csa_offset},
           "routing": routing, "backend": eng.backend.name,
           "kernel": kernel, "requests": len(out),
           "dispatches": s["batches"],
           "launches": launches, "accuracy": float((preds == y).mean()),
           "digital_accuracy": float((digital.argmax(1) == y).mean()),
           "agree_with_digital": float((preds == digital.argmax(1)).mean()),
           "requests_per_s": len(out) / wall, "wall_s": wall,
           "p50_ms": s["p50_ms"], "p99_ms": s["p99_ms"]}
    if not (vcfg.d2d or vcfg.c2c):
        factor = REPLICAS if routing == "ensemble" else 1
        sums = np.stack([r.class_sums for r in out])
        if not np.array_equal(sums, factor * digital):
            raise AssertionError("nominal class sums differ from the "
                                 "digital TM")
        row["nominal_equals_digital"] = True
    emit(row)
    return launches


def analog_rounds(ecfg_kw, backend, kernel, seed, device):
    """One analog tier: 512 requests in ``round_robin`` and in
    ``ensemble``, under D2D + C2C (no CSA offset) and at nominal."""
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core.variations import VariationConfig
    cfg = tm_config(MODEL)
    ta, x, y = prototype_task(cfg, N_REQUESTS, seed)
    for vcfg in (VariationConfig(csa_offset=False),
                 VariationConfig.nominal()):
        for routing in ("round_robin", "ensemble"):
            serve_round(cfg, ta, x, y, vcfg, dict(ecfg_kw, routing=routing),
                        backend, kernel, device)


def phase_serving(device):
    """The plane-packed analog path; returns its launches."""
    return path_launches(
        lambda: analog_rounds({}, "analog-cuda-packed2",
                              "imbue_infer_planes", SEED + 100, device),
        ("imbue_infer_planes",))


def phase_analog_tiers(device):
    """The lower analog tiers, ``EngineConfig(pack_planes=False)`` and
    ``EngineConfig(packed=False)``; returns their launches."""
    def drive():
        analog_rounds({"pack_planes": False}, "analog-cuda-packed",
                      "imbue_infer_packed", SEED + 400, device)
        analog_rounds({"packed": False}, "analog-cuda", "imbue_infer",
                      SEED + 400, device)
    return path_launches(drive, DENSE_KERNELS)


def phase_chaos(device):
    """The chaos round on the default engine; returns its launches."""
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core import tm
    from repro_torch.core.variations import FaultConfig, VariationConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.imbue_infer import imbue_infer_planes
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    cfg = tm_config(MODEL)
    ta, x, y = prototype_task(cfg, N_REQUESTS, SEED + 500)
    digital = tm.forward(torch.from_numpy(ta).to(device),
                         torch.from_numpy(x).to(device), cfg)

    def chip_sums(eng):
        """``[R, N, M]`` sums of every chip, 128 rows a call."""
        return torch.cat([eng.backend.fn(eng.state, ops.pack_literals(
            tm.literals(torch.from_numpy(x[i:i + 128]).to(device))))
            for i in range(0, len(x), 128)], dim=1)

    def drive():
        eng = ServeEngine.from_ta_state(
            torch.from_numpy(ta), cfg, n_replicas=REPLICAS, seed=SEED,
            vcfg=VariationConfig.nominal(),
            ecfg=EngineConfig(routing="ensemble"), device=device)
        if eng.backend.name != "analog-cuda-packed2" or \
                eng.state.plane_dev is not None:
            raise AssertionError("chaos round: not a nominal packed2 pool")
        resident0 = eng.summary()["resident_nbytes_full"]
        gen = torch.Generator(device=device).manual_seed(SEED + 5)
        eng.inject_faults(gen, FaultConfig(**CHAOS), replicas=[1])
        s = eng.summary()
        if s.get("fault_injections") != [{"replicas": [1]}]:
            raise AssertionError(f"fault_injections: "
                                 f"{s.get('fault_injections')}")
        if eng.state.plane_dev is None:
            raise AssertionError("the injury grew no deviation plane")
        faulted = int((eng.pool.fault_mask != 0).sum())
        launches0 = imbue_infer_planes.launches
        t0 = time.perf_counter()
        eng.submit_many(list(x))
        out = eng.drain()
        wall = time.perf_counter() - t0
        s = eng.summary()
        launches = imbue_infer_planes.launches - launches0
        if len(out) != len(x) or s["fallback_dispatches"] != 0 or \
                launches != s["batches"]:
            raise AssertionError(f"chaos serving: {len(out)} served, "
                                 f"{s['fallback_dispatches']} fallbacks, "
                                 f"{launches} launches for {s['batches']}")
        preds = np.array([r.pred for r in out])
        want = digital.argmax(-1).cpu().numpy()
        sums = chip_sums(eng)
        for i in (0, 2, 3):
            if not torch.equal(sums[i], digital):
                raise AssertionError(f"healthy replica {i} left the "
                                     "digital TM")
        hurt_rows = float((sums[1] != digital).any(-1).float().mean())
        if not np.array_equal(preds, want) or hurt_rows == 0.0:
            raise AssertionError("the 3-of-4 majority lost the digital "
                                 "answer, or the injury changed nothing")
        eng._set_pool(eng.pool.repair_replica(1, gen))
        if eng.pool.fault_mask is not None or \
                eng.state.plane_dev is not None:
            raise AssertionError("repair did not elide the plane")
        if not torch.equal(chip_sums(eng), digital.expand(REPLICAS,
                                                          *digital.shape)):
            raise AssertionError("the repaired pool left the digital TM")
        emit({"phase": "serving", "path": "chaos", "fault": CHAOS,
              "replicas": [1], "requests": len(out),
              "dispatches": s["batches"], "launches": launches,
              "faulted_cells": faulted,
              "resident_nbytes_full": [resident0,
                                       s["resident_nbytes_full"]],
              "replica1_rows_off_digital": hurt_rows,
              "healthy_equal_digital": True, "preds_equal_digital": True,
              "accuracy": float((preds == y).mean()),
              "repaired_plane_elided": True,
              "requests_per_s": len(out) / wall, "wall_s": wall})
    return path_launches(drive, ("imbue_infer_planes",))


def phase_crossbar(device):
    """One ``CrossbarState`` through the three analog CUDA backends with
    ``api.class_sums``, 128 rows a call; returns the launches."""
    from repro_torch import api
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core import tm
    from repro_torch.core.variations import VariationConfig
    cfg = tm_config(MODEL)
    ta, x, _ = prototype_task(cfg, N_REQUESTS, SEED + 600)
    include = tm.include_mask(torch.from_numpy(ta).to(device), cfg)
    st = api.CrossbarState.program(
        include, torch.Generator(device=device).manual_seed(SEED + 6), cfg,
        VariationConfig(csa_offset=False)).pack_planes()
    for name in ANALOG_BACKENDS:
        if api.select_backend(st, prefer=name).fell_back:
            raise AssertionError(f"{name} does not serve a CrossbarState")

    def drive():
        calls, nonzero = 0, 0
        for i in range(0, len(x), 128):
            lits = tm.literals(torch.from_numpy(x[i:i + 128]).to(device))
            outs = [api.class_sums(st, lits, backend=name)
                    for name in ANALOG_BACKENDS]
            if outs[0].shape != (lits.shape[0], cfg.n_classes) or not all(
                    torch.equal(o, outs[0]) for o in outs):
                raise AssertionError("the analog backends disagree on a "
                                     "CrossbarState")
            calls += 1
            nonzero += int((outs[0] != 0).sum())
        emit({"phase": "serving", "path": "crossbar",
              "backends": list(ANALOG_BACKENDS), "requests": len(x),
              "calls": calls, "identical": True,
              "nonzero_frac": nonzero / (len(x) * cfg.n_classes)})
    counts = path_launches(drive, ("imbue_infer_planes",) + DENSE_KERNELS)
    if set(counts.values()) != {len(x) // 128}:
        raise AssertionError(f"crossbar path launches {counts}")
    return counts


def coalesced_round(ccfg, ta, w, x, y, ecfg_kw, backend, kernel, device):
    """Serve ``x`` through one coalesced engine; every response must equal
    ``core.coalesced.forward``, with 0 fallbacks and one launch of the
    tier's kernel per dispatch."""
    from repro_torch.core import coalesced as co
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    fn, _ = kernel_pair(kernel)
    eng = ServeEngine.from_coalesced(
        torch.from_numpy(ta), torch.from_numpy(w), ccfg,
        ecfg=EngineConfig(**ecfg_kw), device=device)
    if eng.backend.name != backend or eng.selection.fell_back:
        raise AssertionError(f"coalesced round not on {backend}: "
                             f"{eng.backend.name} {eng.selection}")
    launches0 = fn.launches
    t0 = time.perf_counter()
    eng.submit_many(list(x))
    eng.pump()
    out = eng.drain()
    wall = time.perf_counter() - t0
    s = eng.summary()
    launches = fn.launches - launches0
    if len(out) != len(x) or s["fallback_dispatches"] != 0:
        raise AssertionError(f"served {len(out)} of {len(x)}, "
                             f"{s['fallback_dispatches']} fallbacks")
    if launches != s["batches"]:
        raise AssertionError(f"{launches} {kernel} launches for "
                             f"{s['batches']} dispatches")
    sums = np.stack([r.class_sums for r in out])
    want = co.forward(torch.from_numpy(ta).to(device),
                      torch.from_numpy(w).to(device),
                      torch.from_numpy(x).to(device), ccfg).cpu().numpy()
    if not np.array_equal(sums, want):
        raise AssertionError(f"{backend}: class sums differ from "
                             "core.coalesced.forward")
    preds = np.array([r.pred for r in out])
    emit({"phase": "serving", "path": "coalesced", "ecfg": ecfg_kw,
          "routing": eng.ecfg.routing, "backend": eng.backend.name,
          "kernel": kernel, "requests": len(out),
          "dispatches": s["batches"], "launches": launches,
          "equals_forward": True,
          "accuracy": float((preds == y).mean()),
          "nonzero_frac": float((sums != 0).mean()),
          "requests_per_s": len(out) / wall, "wall_s": wall,
          "p50_ms": s["p50_ms"], "p99_ms": s["p99_ms"],
          "resident_nbytes_slice": s["resident_nbytes_slice"]})


def digital_round(cfg, ta, x, backend, kernel, device, batch=128):
    """``api.class_sums`` on ``backend`` in batches of ``batch`` must equal
    ``digital-torch``, one launch per call."""
    from repro_torch import api
    from repro_torch.core import tm
    fn, _ = kernel_pair(kernel)
    state = api.DigitalState.from_ta(torch.from_numpy(ta).to(device), cfg)
    if backend.endswith("packed"):
        state = state.pack()
    if api.select_backend(state, prefer=backend).fell_back:
        raise AssertionError(f"{backend} does not serve the digital state")
    launches0, calls, nonzero = fn.launches, 0, 0
    for i in range(0, len(x), batch):
        lits = tm.literals(torch.from_numpy(x[i:i + batch]).to(device))
        got = api.class_sums(state, lits, backend=backend)
        want = api.class_sums(state, lits, backend="digital-torch")
        if not torch.equal(got, want):
            raise AssertionError(f"{backend} differs from digital-torch")
        calls += 1
        nonzero += int((want != 0).sum())
    launches = fn.launches - launches0
    if launches != calls:
        raise AssertionError(f"{launches} {kernel} launches for {calls} "
                             "calls")
    emit({"phase": "serving", "path": "digital", "backend": backend,
          "kernel": kernel, "requests": len(x), "calls": calls,
          "launches": launches, "equals_digital_torch": True,
          "nonzero_frac": nonzero / (len(x) * cfg.n_classes)})


def path_launches(drive, kernels):
    """Zero the counters of ``kernels`` just before ``drive()`` and read
    them just after: the launches of that path alone.  Fails if one of
    them was not launched."""
    fns = {name: kernel_pair(name)[0] for name in kernels}
    for fn in fns.values():
        fn.launches = 0
    drive()
    counts = {name: fn.launches for name, fn in fns.items()}
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on its path")
    return counts


def phase_coalesced_serving(device):
    """The coalesced path on each tier; returns its launches per kernel."""
    ccfg = coalesced_config()
    ta, w, x, y = coalesced_task(ccfg, N_REQUESTS, SEED + 200)

    def drive():
        for ecfg_kw, backend, kernel in (
                ({}, "coalesced-cuda-packed2", "tm_infer_planes"),
                ({"pack_planes": False}, "coalesced-cuda-packed",
                 "tm_infer_packed"),
                ({"packed": False}, "coalesced-cuda", "tm_infer"),
                ({"routing": "ensemble"}, "coalesced-cuda-packed2",
                 "tm_infer_planes")):
            coalesced_round(ccfg, ta, w, x, y, ecfg_kw, backend, kernel,
                            device)
    return path_launches(drive, TM_KERNELS)


def phase_digital_fused(device):
    """The digital fused tier; returns its launches per kernel."""
    from repro_torch.configs.imbue_tm import tm_config
    cfg = tm_config(MODEL)
    ta, x, _ = prototype_task(cfg, N_REQUESTS, SEED + 300)

    def drive():
        digital_round(cfg, ta, x, "digital-cuda-packed", "tm_infer_packed",
                      device)
        digital_round(cfg, ta, x, "digital-cuda", "tm_infer", device)
    return path_launches(drive, ("tm_infer_packed", "tm_infer"))


# ------------------------------------------------------------ live path

LIVE_CHUNK = 128               # requests submitted between two pump()s
LIVE_PROBES = 64               # HealthConfig.n_probes of the live rounds
LIVE_COALESCED_FAULT = dict(stuck_lrs_rate=0.25, stuck_hrs_rate=0.25)


def serve_chunks(eng, x, chunk=LIVE_CHUNK, force=False):
    """Submit ``x`` ``chunk`` rows at a time with a pump() after each (the
    host packs the next chunk while an async engine's last issue runs),
    then drain; returns ``(the Responses of x, wall seconds)``."""
    t0 = time.perf_counter()
    rids = []
    for lo in range(0, len(x), chunk):
        rids += eng.submit_many(list(x[lo:lo + chunk]))
        eng.pump(force=force)
    eng.drain()
    wall = time.perf_counter() - t0
    return [eng.take(r) for r in rids], wall


def check_launches(what, launches, want):
    if launches != want:
        raise AssertionError(f"live {what}: {launches} launches, "
                             f"{want} expected")


def live_async_round(cfg, ta, x, routing, device):
    """(a) ``AsyncServeEngine`` against ``ServeEngine`` on one seed under
    D2D + C2C, in two arrival patterns: ``chunked`` (128 requests, then a
    pump(): the host packs the next chunk while the last issue runs) and
    ``burst`` (all queued, then drained: back-to-back issues, where the
    async engine must reach ``max_in_flight``).  Bit-equal Responses, one
    launch a dispatch, 0 fallbacks."""
    from repro_torch.core.variations import VariationConfig
    from repro_torch.kernels.imbue_infer import imbue_infer_planes
    from repro_torch.serve import AsyncServeEngine, EngineConfig, ServeEngine
    row = {"phase": "live", "round": "async", "routing": routing,
           "R": REPLICAS, "requests": len(x)}
    for pattern, chunk in (("chunked", LIVE_CHUNK), ("burst", len(x))):
        outs = {}
        for cls in (ServeEngine, AsyncServeEngine):
            eng = cls.from_ta_state(
                torch.from_numpy(ta), cfg, n_replicas=REPLICAS, seed=SEED,
                vcfg=VariationConfig(csa_offset=False),
                ecfg=EngineConfig(routing=routing), device=device)
            if eng.backend.name != "analog-cuda-packed2":
                raise AssertionError(f"live async: on {eng.backend.name}")
            depth = []
            if cls is AsyncServeEngine:
                orig = eng._dispatch

                def dispatch(batch, eng=eng, orig=orig):
                    orig(batch)
                    depth.append(eng.in_flight)
                eng._dispatch = dispatch
            launches0 = imbue_infer_planes.launches
            out, wall = serve_chunks(eng, x, chunk=chunk)
            s = eng.summary()
            check_launches("async", imbue_infer_planes.launches - launches0,
                           s["batches"])
            if len(out) != len(x) or s["fallback_dispatches"] != 0:
                raise AssertionError(f"live async: {len(out)} served, "
                                     f"{s['fallback_dispatches']} fallbacks")
            key = f"{pattern}_{'async' if depth else 'sync'}"
            outs[key] = out
            row[key] = {"requests_per_s": len(out) / wall, "wall_s": wall,
                        "dispatches": s["batches"],
                        "overlap_fraction": s["overlap_fraction"],
                        "host_pack_s": s["host_pack_s"],
                        "device_wait_s": s["device_wait_s"],
                        "p50_ms": s["p50_ms"], "p99_ms": s["p99_ms"]}
            if depth:
                row[key]["max_in_flight_reached"] = max(depth)
                if pattern == "burst" and \
                        max(depth) != eng.ecfg.max_in_flight:
                    raise AssertionError(f"live async: in_flight reached "
                                         f"{max(depth)} in a burst")
        for g, w in zip(outs[f"{pattern}_async"], outs[f"{pattern}_sync"]):
            if (g.rid, g.pred, g.replica) != (w.rid, w.pred, w.replica) or \
                    not np.array_equal(g.class_sums, w.class_sums):
                raise AssertionError("live async: a Response differs from "
                                     "the sync engine's")
    row["bit_equal_to_sync"] = True
    # Every host wait of a dispatch must be in its collect, where the
    # overlap accounting counts it: one more issue on the warm async
    # engine, under the sync debug mode that raises on a synchronizing
    # CUDA operation.
    eng.submit_many(list(x[:LIVE_CHUNK]))
    batch = eng.batcher.cut(eng.clock(), force=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fl = eng._issue(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng._collect(fl)
    row["issue_syncs"] = 0
    emit(row)


def live_health_round(cfg, ta, x, device):
    """(b) probe -> quarantine -> degraded serving -> RepairPolicy.check on
    a nominal R = 4 ensemble pool with CHAOS in replica 1."""
    from repro_torch.core import tm
    from repro_torch.core.variations import FaultConfig, VariationConfig
    from repro_torch.kernels.clause_eval import tm_infer
    from repro_torch.kernels.imbue_infer import imbue_infer_planes
    from repro_torch.serve import (EngineConfig, HealthConfig, RepairPolicy,
                                   ServeEngine)
    eng = ServeEngine.from_ta_state(
        torch.from_numpy(ta), cfg, n_replicas=REPLICAS, seed=SEED,
        vcfg=VariationConfig.nominal(),
        ecfg=EngineConfig(routing="ensemble"), device=device)
    planes0, tm0 = imbue_infer_planes.launches, tm_infer.launches
    eng.enable_health(HealthConfig(n_probes=LIVE_PROBES))
    if eng.probe() != {i: 1.0 for i in range(REPLICAS)}:
        raise AssertionError("live health: a fresh chip failed its probe")
    eng.inject_faults(torch.Generator(device=device).manual_seed(SEED + 7),
                      FaultConfig(**CHAOS), replicas=[1])
    hurt = eng.probe()
    if not (hurt[1] < 0.75 and all(hurt[i] == 1.0 for i in (0, 2, 3))
            and eng.quarantined == [1]):
        raise AssertionError(f"live health: probe {hurt}, quarantined "
                             f"{eng.quarantined}")
    load1 = eng.router.rows_dispatched[1]
    out, wall = serve_chunks(eng, x)
    digital = tm.forward(torch.from_numpy(ta).to(device),
                         torch.from_numpy(x).to(device), cfg).cpu().numpy()
    sums = np.stack([r.class_sums for r in out])
    if not (np.array_equal([r.pred for r in out], digital.argmax(-1))
            and np.array_equal(sums, (REPLICAS - 1) * digital)
            and eng.router.rows_dispatched[1] == load1):
        raise AssertionError("live health: the quarantined pool left the "
                             "digital TM or replica 1 took load")
    tick = RepairPolicy(eng).check()
    rep = tick["repairs"].get(1, {})
    if not (rep.get("readmitted") and rep.get("health") == 1.0
            and eng.quarantined == [] and eng.pool.fault_mask is None):
        raise AssertionError(f"live health: repair {tick}")
    final = eng.probe()
    if final != {i: 1.0 for i in range(REPLICAS)}:
        raise AssertionError(f"live health: after repair {final}")
    s = eng.summary()
    reads = s["probe_rounds"] * -(-LIVE_PROBES // eng.batcher.cfg.max_batch)
    reads *= REPLICAS
    check_launches("health imbue_infer_planes",
                   imbue_infer_planes.launches - planes0,
                   s["batches"] + reads)
    check_launches("health tm_infer", tm_infer.launches - tm0, 2)
    emit({"phase": "live", "round": "health", "R": REPLICAS,
          "fault": CHAOS, "replicas": [1], "probes": LIVE_PROBES,
          "health_fresh": 1.0, "health_injured": hurt,
          "quarantined": [1], "requests": len(out),
          "dispatches": s["batches"], "probe_reads": reads,
          "preds_equal_digital": True, "replica1_load_flat": True,
          "repair": rep, "health_repaired": final,
          "quarantine_events": s["quarantine_events"],
          "fallback_dispatches": s["fallback_dispatches"],
          "requests_per_s": len(out) / wall})


def live_swap_round(cfg, device):
    """(c) HotSwapper on the async engine: canary at 0.25, promote ==
    a fresh from_ta_state pool; a second rollout rolled back == its
    snapshot."""
    import tempfile
    from repro_torch.core.variations import VariationConfig
    from repro_torch.kernels.imbue_infer import imbue_infer_planes
    from repro_torch.serve import (CANARY, AsyncServeEngine, EngineConfig,
                                   HotSwapper, ServeEngine, SwapConfig,
                                   restore_pool)
    vcfg = VariationConfig(csa_offset=False)
    ta, x, _ = prototype_task(cfg, N_REQUESTS, SEED + 700)
    ta2, x2, _ = prototype_task(cfg, N_REQUESTS, SEED + 701)
    eng = AsyncServeEngine.from_ta_state(
        torch.from_numpy(ta), cfg, n_replicas=REPLICAS, seed=SEED,
        vcfg=vcfg, ecfg=EngineConfig(routing="ensemble"), device=device)
    launches0 = imbue_infer_planes.launches
    row = {"phase": "live", "round": "swap", "R": REPLICAS}
    with tempfile.TemporaryDirectory() as ckpt:
        sw = HotSwapper(eng, ckpt, SwapConfig(canary_fraction=0.25,
                                              min_canary_rows=64))
        cand = sw.begin(torch.from_numpy(ta2), seed=SEED + 1)
        out, _ = serve_chunks(eng, x2, chunk=64, force=True)
        canary = [r for r in out if r.replica == CANARY]
        if not canary or {r.version for r in canary} != {cand} or \
                {r.version for r in out if r.replica != CANARY} != {0}:
            raise AssertionError("live swap: canary traffic wrong")
        row.update(canary_rows=sw.rows(), canary_agreement=sw.agreement(),
                   decision=sw.decision(), requests=len(out))
        if sw.promote() != cand:
            raise AssertionError("live swap: promote")
        fresh = ServeEngine.from_ta_state(
            torch.from_numpy(ta2), cfg, n_replicas=REPLICAS, seed=SEED + 1,
            vcfg=vcfg, device=device)
        if not torch.equal(eng.pool.r_stack, fresh.pool.r_stack):
            raise AssertionError("live swap: promoted pool != fresh pool")
        del fresh
        snap = eng.pool.r_stack.clone()
        sw.begin(torch.from_numpy(ta), seed=SEED + 2)
        out2, _ = serve_chunks(eng, x, chunk=64, force=True)
        if sw.rollback() != cand:
            raise AssertionError("live swap: rollback version")
        if not (torch.equal(eng.pool.r_stack, snap) and torch.equal(
                restore_pool(eng.pool, ckpt, cand).r_stack, snap)):
            raise AssertionError("live swap: rolled-back pool != snapshot")
    s = eng.summary()
    check_launches("swap", imbue_infer_planes.launches - launches0,
                   s["batches"] + s["canary"]["batches"])
    if s["fallback_dispatches"] != 0 or eng.in_flight != 0:
        raise AssertionError("live swap: fallbacks or work in flight")
    row.update(second_rollout_requests=len(out2), promoted_equals_fresh=True,
               rollback_equals_snapshot=True, swaps=s["swaps"],
               canary_batches=s["canary"]["batches"],
               dispatches=s["batches"],
               overlap_fraction=s["overlap_fraction"])
    emit(row)


def live_coalesced_round(device):
    """(d) The coalesced engine: hot_swap(weights=...), a 25 % + 25 %
    injury held by the last-healthy floor, then RepairPolicy.repair."""
    from repro_torch.core import coalesced as co
    from repro_torch.core.variations import FaultConfig
    from repro_torch.kernels.clause_eval import tm_infer, tm_infer_planes
    from repro_torch.serve import (EngineConfig, HealthConfig, RepairPolicy,
                                   ServeEngine, hot_swap)
    ccfg = coalesced_config()
    ta, w, _, _ = coalesced_task(ccfg, N_REQUESTS, SEED + 800)
    ta2, w2, x2, _ = coalesced_task(ccfg, N_REQUESTS, SEED + 801)
    planes0, tm0 = tm_infer_planes.launches, tm_infer.launches
    eng = ServeEngine.from_coalesced(
        torch.from_numpy(ta), torch.from_numpy(w), ccfg,
        ecfg=EngineConfig(health=HealthConfig(n_probes=LIVE_PROBES)),
        device=device)
    if eng.backend.name != "coalesced-cuda-packed2" or \
            eng.probe() != {0: 1.0}:
        raise AssertionError("live coalesced: backend or fresh probe")
    if hot_swap(eng, torch.from_numpy(ta2), weights=torch.from_numpy(w2)) \
            != 1:
        raise AssertionError("live coalesced: hot_swap version")
    out, wall = serve_chunks(eng, x2)
    want = co.forward(torch.from_numpy(ta2).to(device),
                      torch.from_numpy(w2).to(device),
                      torch.from_numpy(x2).to(device), ccfg).cpu().numpy()
    if not np.array_equal(np.stack([r.class_sums for r in out]), want) or \
            {r.version for r in out} != {1}:
        raise AssertionError("live coalesced: swapped model differs from "
                             "core.coalesced.forward")
    eng.inject_faults(torch.Generator(device=device).manual_seed(SEED + 8),
                      FaultConfig(**LIVE_COALESCED_FAULT))
    hurt = eng.probe()
    events = eng.summary().get("quarantine_events", [])
    if not (hurt[0] < 0.75 and eng.quarantined == [] and events
            and events[-1]["kind"] == "held_last_healthy"):
        raise AssertionError(f"live coalesced: probe {hurt}, {events}")
    rep = RepairPolicy(eng).repair(hurt)
    final = eng.probe()
    if not (rep.get(0, {}).get("health") == 1.0 and final == {0: 1.0}
            and eng.pool.fault_mask is None):
        raise AssertionError(f"live coalesced: repair {rep} {final}")
    s = eng.summary()
    reads = s["probe_rounds"] * -(-LIVE_PROBES // eng.batcher.cfg.max_batch)
    check_launches("coalesced tm_infer_planes",
                   tm_infer_planes.launches - planes0, s["batches"] + reads)
    check_launches("coalesced tm_infer", tm_infer.launches - tm0, 3)
    emit({"phase": "live", "round": "coalesced", "width": COALESCED,
          "swapped_version": 1, "requests": len(out),
          "equals_forward": True, "fault": LIVE_COALESCED_FAULT,
          "health_injured": hurt, "quarantined": [],
          "held_last_healthy": True, "repair": rep,
          "health_repaired": final, "dispatches": s["batches"],
          "probe_reads": reads,
          "fallback_dispatches": s["fallback_dispatches"],
          "requests_per_s": len(out) / wall})


def phase_live(device):
    """Live operations at full width; returns the launches per kernel."""
    from repro_torch.configs.imbue_tm import tm_config
    cfg = tm_config(MODEL)
    ta, x, _ = prototype_task(cfg, N_REQUESTS, SEED + 900)

    def drive():
        for routing in ("ensemble", "round_robin"):
            live_async_round(cfg, ta, x, routing, device)
        live_health_round(cfg, ta, x, device)
        live_swap_round(cfg, device)
        live_coalesced_round(device)
    return path_launches(drive, ("imbue_infer_planes", "tm_infer_planes",
                                 "tm_infer"))


# ---------------------------------------------------------- stream path

def stream_model(task, device):
    """(h) round 1: a streaming task trained on the card.  Its streams are
    drawn on the CPU, windowed with numpy by a quantile booleanizer fit on
    the train frames (on the card), and trained with ``fit(parallel=True,
    batch_size=STREAM_TRAIN_BATCH)`` from ``init_ta_state``, one epoch a
    call: test window accuracy and ms per step each epoch, one
    ``clause_eval_packed`` launch a step, states int16 in [1, 2N]."""
    from repro_torch.core import tm, tm_train
    from repro_torch.core.booleanize import StreamingBooleanizer, fit_quantile
    from repro_torch.data import tm_datasets
    from repro_torch.kernels.clause_eval import clause_eval_packed
    cfg = stream_config(task)
    xtr, ltr, xte, lte = stream_arrays(task)
    b = fit_quantile(xtr.reshape(-1, task["channels"]), task["bits"],
                     device=device)
    sb = StreamingBooleanizer(b, task["window"], task["hop"])
    windows = (tm_datasets.kws6_windows if task["kind"] == "kws"
               else tm_datasets.sensor_anomaly_windows)
    rtr, ytr = windows(xtr, ltr, sb)
    rte, yte = windows(xte, lte, sb)
    dtr, dytr, dte, dyte = (torch.from_numpy(a).to(device)
                            for a in (rtr, ytr, rte, yte))
    gen = torch.Generator(device=device).manual_seed(task["seed"] + 700)
    ta = tm.init_ta_state(gen, cfg, device)
    steps = len(rtr) // STREAM_TRAIN_BATCH
    rows = []
    for epoch in range(1, STREAM_EPOCHS + 1):
        launches0 = clause_eval_packed.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ta = tm_train.fit(ta, gen, dtr, dytr, cfg, epochs=1,
                          batch_size=STREAM_TRAIN_BATCH, parallel=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = clause_eval_packed.launches - launches0
        if launches != steps:
            raise AssertionError(f"{task['kind']}: {launches} "
                                 f"clause_eval_packed launches for {steps} "
                                 "batch steps")
        check_states(ta, cfg.n_states, f"{task['kind']} fit")
        rows.append({"epoch": epoch, "steps": steps, "launches": launches,
                     "test_accuracy": float(tm.accuracy(ta, dte, dyte, cfg)),
                     "ms_per_step": wall * 1e3 / steps})
    acc = rows[-1]["test_accuracy"]
    floor = KWS_ACCURACY_FLOOR if task is KWS_TASK else None
    emit({"phase": "stream", "round": "training", "task": task["kind"],
          "config": stream_fields(task), "C": cfg.n_clauses,
          "L": cfg.n_literals, "train_windows": len(rtr),
          "test_windows": len(rte), "train_frames_sha256": sha256(xtr),
          "batch": STREAM_TRAIN_BATCH, "epochs": rows,
          "accuracy_floor": floor})
    if floor is not None and acc < floor:
        raise AssertionError(f"KWS accuracy {acc} below the floor {floor}")
    return {"task": task, "cfg": cfg, "ta": ta, "booleanizer": b,
            "accuracy": acc, "train_windows": (rtr, ytr)}


def kws_sessions():
    """STREAM_SESSIONS sessions of STREAM_UTTERANCES KWS utterances, drawn
    on a CPU generator from SEED + 2: frames ``[S, 256, mels]`` and each
    frame's utterance label ``[S, 256]``."""
    t = KWS_TASK["n_frames"]
    x, y = draw_streams("kws", torch.Generator().manual_seed(SEED + 2),
                        STREAM_SESSIONS * STREAM_UTTERANCES, t,
                        KWS_TASK["channels"])
    return (x.reshape(STREAM_SESSIONS, STREAM_UTTERANCES * t, -1),
            np.repeat(y, t).reshape(STREAM_SESSIONS, -1))


def stream_round(eng, model, frames, scfg_kw=None, latency=0):
    """Feed every session of ``frames`` ``[S, T, F]`` one hop a round, with
    a ``pump()`` each round, then drain; the first ``latency`` sessions
    under the latency QoS class.  Returns ``(server, wall s)``."""
    from repro_torch.serve import QOS_LATENCY, StreamConfig, StreamServer
    task = model["task"]
    hop = task["hop"]
    server = StreamServer(eng, model["booleanizer"], StreamConfig(
        window=task["window"], hop=hop, vote=STREAM_VOTE, **(scfg_kw or {})))
    sids = [f"s{i}" for i in range(len(frames))]
    for i, sid in enumerate(sids):
        server.session(sid, qos=QOS_LATENCY if i < latency else None)
    t0 = time.perf_counter()
    for lo in range(0, frames.shape[1], hop):
        for sid, f in zip(sids, frames):
            server.feed(sid, f[lo:lo + hop])
        server.pump()
    server.drain()
    return server, time.perf_counter() - t0


def stream_stats(server, wall):
    """Decisions/s, per-session window latency (each session's p50 and
    p99, the median over sessions and the worst), batching and overlap of
    one streaming round."""
    s = server.summary()
    pct = np.array([np.percentile([d.latency_s for d in sess.decisions],
                                  (50, 99)) * 1e3
                    for sess in server.sessions.values()])
    n = sum(len(sess.decisions) for sess in server.sessions.values())
    return {"sessions": len(server.sessions), "decisions": n,
            "decisions_per_s": n / wall, "wall_s": wall,
            "dispatches": s["batches"],
            "session_p50_ms_median": float(np.median(pct[:, 0])),
            "session_p99_ms_median": float(np.median(pct[:, 1])),
            "session_p99_ms_max": float(pct[:, 1].max()),
            "mean_batch": s["mean_batch"],
            "padding_overhead": s["padding_overhead"],
            "overlap_fraction": s["overlap_fraction"],
            "fallback_dispatches": s["fallback_dispatches"]}


def stream_engine(cls, model, vcfg, routing, device, batcher=None):
    """An analog engine of R = REPLICAS chips on the stream model, under
    ``batcher`` (default ``BatcherConfig.for_max_batch(STREAM_BATCH)``,
    whose ladder the tuning table replaces), on the planes tier."""
    from repro_torch.serve import BatcherConfig, EngineConfig
    eng = cls.from_ta_state(
        model["ta"], model["cfg"], n_replicas=REPLICAS, seed=SEED, vcfg=vcfg,
        ecfg=EngineConfig(routing=routing, batcher=batcher or BatcherConfig
                          .for_max_batch(STREAM_BATCH)), device=device)
    if eng.backend.name != "analog-cuda-packed2" or eng.selection.fell_back:
        raise AssertionError(f"stream engine on {eng.backend.name}")
    return eng


def stream_launches(what, fn, launches0, s):
    """One launch of ``fn`` a dispatch and no fallback."""
    launches = fn.launches - launches0
    if launches != s["batches"] or s["fallback_dispatches"] != 0:
        raise AssertionError(f"stream {what}: {launches} launches for "
                             f"{s['batches']} dispatches, "
                             f"{s['fallback_dispatches']} fallbacks")
    return launches


def offline_rows(model, frames, device):
    """Each session's windows, all at once (``transform_offline``)."""
    from repro_torch.core.booleanize import StreamingBooleanizer
    task = model["task"]
    sb = StreamingBooleanizer(model["booleanizer"], task["window"],
                              task["hop"])
    return [torch.from_numpy(sb.transform_offline(f)).to(device)
            for f in frames]


def stream_nominal_round(model, frames, routing, cls, device, batcher=None,
                         label="nominal"):
    """(h) round 2: 64 sessions at nominal.  Every session's per-window
    predictions equal offline ``api.predict`` and the digital TM on its
    windows, every keyword the vote over the last STREAM_VOTE windows; one
    ``imbue_infer_planes`` launch a dispatch, no fallback.  ``batcher``
    and ``label``: the tuning phase's ladder rounds (e)."""
    from repro_torch import api
    from repro_torch.core import tm
    from repro_torch.core.variations import VariationConfig
    from repro_torch.kernels.imbue_infer import imbue_infer_planes
    from repro_torch.serve import majority_vote
    eng = stream_engine(cls, model, VariationConfig.nominal(), routing,
                        device, batcher)
    launches0 = imbue_infer_planes.launches
    server, wall = stream_round(eng, model, frames)
    summ = eng.summary()
    launches = stream_launches("nominal", imbue_infer_planes, launches0,
                               summ)
    classes = set()
    for sess, rows in zip(server.sessions.values(),
                          offline_rows(model, frames, device)):
        preds = [d.pred for d in sess.decisions]
        if preds != api.predict(eng.state, rows).tolist() or \
                preds != tm.predict(model["ta"], rows, model["cfg"]).tolist():
            raise AssertionError(f"stream {sess.sid}: streamed windows "
                                 "differ from offline api.predict / digital")
        for i, d in enumerate(sess.decisions):
            if d.keyword != majority_vote(preds[max(0, i - STREAM_VOTE + 1):
                                                i + 1]):
                raise AssertionError(f"stream {sess.sid}: keyword {i} is "
                                     "not the vote")
        classes.update(preds)
    row = {"phase": "stream", "round": label, "engine": cls.__name__,
           "routing": routing, "R": REPLICAS, "launches": launches,
           "equals_offline_and_digital": True, "classes_seen": len(classes),
           "bucket_sizes": summ["bucket_sizes"],
           "buckets_tuned_for": summ["buckets_tuned_for"],
           "kernel_tiles": summ["kernel_tiles"],
           **stream_stats(server, wall)}
    if row["decisions"] != STREAM_SESSIONS * (
            (frames.shape[1] - KWS_TASK["window"]) // KWS_TASK["hop"] + 1):
        raise AssertionError(f"stream: {row['decisions']} decisions")
    emit(row)
    return row


def stream_idle_share(model, frames, cls, device):
    """One more nominal ``ensemble`` round under ``torch.profiler``: device
    ms summed over the device-side events against the traced round's wall
    time (the profiler's own host cost is in that wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.variations import VariationConfig
    eng = stream_engine(cls, model, VariationConfig.nominal(), "ensemble",
                        device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = stream_round(eng, model, frames)
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3
    return {"traced_wall_ms": wall * 1e3, "device_ms": device_ms,
            "dispatches": eng.summary()["batches"],
            "device_idle_share": 1.0 - device_ms / (wall * 1e3)}


def stream_c2c_round(model, frames, labels, device):
    """(h) round 3: the 64 sessions under D2D + C2C, ``ensemble``, on the
    sync and the async engine from one seed: bit-equal decisions; keyword
    accuracy against the utterance of each window's last frame."""
    from repro_torch.core.variations import VariationConfig
    from repro_torch.kernels.imbue_infer import imbue_infer_planes
    from repro_torch.serve import AsyncServeEngine, ServeEngine
    task = model["task"]
    row = {"phase": "stream", "round": "d2d_c2c", "routing": "ensemble",
           "R": REPLICAS}
    decided = {}
    for cls in (ServeEngine, AsyncServeEngine):
        eng = stream_engine(cls, model, VariationConfig(csa_offset=False),
                            "ensemble", device)
        launches0 = imbue_infer_planes.launches
        server, wall = stream_round(eng, model, frames)
        stream_launches("d2d_c2c", imbue_infer_planes, launches0,
                        eng.summary())
        decided[cls.__name__] = [[(d.index, d.pred, d.keyword, d.version)
                                  for d in sess.decisions]
                                 for sess in server.sessions.values()]
        row[cls.__name__] = stream_stats(server, wall)
    if decided["AsyncServeEngine"] != decided["ServeEngine"]:
        raise AssertionError("stream d2d_c2c: async decisions differ from "
                             "the sync engine's")
    last = task["window"] - 1
    hits = np.array([(labels[i][idx * task["hop"] + last] == kw,
                      labels[i][idx * task["hop"] + last] == pred)
                     for i, sess in enumerate(decided["ServeEngine"])
                     for idx, pred, kw, _ in sess])
    row.update(bit_equal_sync_async=True,
               keyword_accuracy=float(hits[:, 0].mean()),
               window_accuracy=float(hits[:, 1].mean()),
               digital_window_accuracy=model["accuracy"])
    emit(row)


def stream_anomaly_round(model, device):
    """(h) round 4: ANOMALY_SESSIONS sensor sessions in ``margin`` decision
    mode (class 1, threshold 0) on the async engine at nominal, half of
    them under the latency QoS class: every margin equals ``margin_of`` on
    offline ``api.class_sums`` of the same windows."""
    from repro_torch import api
    from repro_torch.core import tm
    from repro_torch.core.variations import VariationConfig
    from repro_torch.kernels.imbue_infer import imbue_infer_planes
    from repro_torch.serve import AsyncServeEngine, margin_of
    task = model["task"]
    frames, flabels = draw_streams(
        "anomaly", torch.Generator().manual_seed(SEED + 3), ANOMALY_SESSIONS,
        ANOMALY_FRAMES, task["channels"])
    eng = stream_engine(AsyncServeEngine, model, VariationConfig.nominal(),
                        "round_robin", device)
    launches0 = imbue_infer_planes.launches
    server, wall = stream_round(
        eng, model, frames, dict(decision="margin", margin_class=1,
                                 margin_threshold=0.0),
        latency=ANOMALY_SESSIONS // 2)
    s = eng.summary()
    launches = stream_launches("anomaly", imbue_infer_planes, launches0, s)
    hits = []
    for i, (sess, rows) in enumerate(zip(server.sessions.values(),
                                         offline_rows(model, frames,
                                                      device))):
        sums = api.class_sums(eng.state, tm.literals(rows))    # [R, B, M]
        if not bool((sums == sums[0]).all()):
            raise AssertionError("stream anomaly: nominal chips disagree")
        want = [margin_of(r, 1) for r in sums[0].cpu().numpy()]
        if [d.margin for d in sess.decisions] != want or \
                [d.pred for d in sess.decisions] != [int(m >= 0)
                                                     for m in want]:
            raise AssertionError(f"stream anomaly {sess.sid}: margins "
                                 "differ from the offline class sums")
        hits += [d.pred == flabels[i][d.index * task["hop"]:
                                      d.index * task["hop"]
                                      + task["window"]].max()
                 for d in sess.decisions]
    emit({"phase": "stream", "round": "anomaly", "engine": "AsyncServeEngine",
          "decision": "margin", "launches": launches,
          "margins_equal_offline": True, "alert_accuracy": float(np.mean(
              hits)), "digital_window_accuracy": model["accuracy"],
          "qos": s.get("qos"), **stream_stats(server, wall)})


def stream_coalesced_round(model, frames, device):
    """(h) round 5: the 64 sessions through ``coalesced-cuda-packed2`` on a
    numpy-built coalesced pool at the KWS width (STREAM_COALESCED; its
    class prototypes the majority bits of each class's training windows):
    every window's prediction equals ``core.coalesced.forward``'s argmax;
    one ``tm_infer_planes`` launch a dispatch."""
    from repro_torch.core import coalesced as co
    from repro_torch.kernels.clause_eval import tm_infer_planes
    from repro_torch.serve import BatcherConfig, EngineConfig, ServeEngine
    ccfg = co.CoalescedConfig(**STREAM_COALESCED)
    rtr, ytr = model["train_windows"]
    protos = np.stack([rtr[ytr == c].mean(axis=0) > 0.5
                       for c in range(ccfg.n_classes)]).astype(np.uint8)
    ta, w, _, _ = coalesced_task(ccfg, 0, SEED + 6, protos=protos)
    eng = ServeEngine.from_coalesced(
        torch.from_numpy(ta), torch.from_numpy(w), ccfg, ecfg=EngineConfig(
            batcher=BatcherConfig.for_max_batch(STREAM_BATCH)), device=device)
    if eng.backend.name != "coalesced-cuda-packed2" or \
            eng.selection.fell_back:
        raise AssertionError(f"stream coalesced on {eng.backend.name}")
    launches0 = tm_infer_planes.launches
    server, wall = stream_round(eng, model, frames)
    launches = stream_launches("coalesced", tm_infer_planes, launches0,
                               eng.summary())
    ta_d, w_d = torch.from_numpy(ta).to(device), torch.from_numpy(w).to(device)
    classes = set()
    for sess, rows in zip(server.sessions.values(),
                          offline_rows(model, frames, device)):
        preds = [d.pred for d in sess.decisions]
        want = co.forward(ta_d, w_d, rows, ccfg).argmax(dim=-1).tolist()
        if preds != want:
            raise AssertionError(f"stream coalesced {sess.sid}: windows "
                                 "differ from core.coalesced.forward")
        classes.update(preds)
    emit({"phase": "stream", "round": "coalesced", "config": STREAM_COALESCED,
          "backend": eng.backend.name, "launches": launches,
          "equals_forward": True, "classes_seen": len(classes),
          **stream_stats(server, wall)})


def stream_cli_round():
    """(h) round 6: ``repro_torch.launch.stream.main`` on the card, KWS and
    anomaly (STREAM_CLI_ARGS: 300 clauses a class, 64 sessions, R = 4,
    ``ensemble``, the async engine): a summary with ``decision_accuracy`` and no backend
    fallback.  The CLI's JSON goes to a buffer; one line a run here."""
    from repro_torch.launch import stream as cli
    for workload in ("kws", "anomaly"):
        argv = ["--workload", workload, *STREAM_CLI_ARGS]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            summ = cli.main(argv)
        wall = time.perf_counter() - t0
        if "decision_accuracy" not in summ or summ["forward_fallbacks"] or \
                summ["fallback_dispatches"]:
            raise AssertionError(f"stream CLI {workload}: no accuracy or a "
                                 "backend fallback")
        emit({"phase": "stream", "round": "cli", "workload": workload,
              "argv": argv, "backend": summ["backend"],
              "decision_accuracy": summ["decision_accuracy"],
              "digital_window_accuracy": summ["digital_window_accuracy"],
              "requests": summ["requests"], "dispatches": summ["batches"],
              "mean_batch": summ["mean_batch"], "wall_s": wall})


def phase_stream(device, keep):
    """Phase 3 (h), the streaming path; returns its launches per kernel
    and leaves the trained KWS model and its session frames in ``keep``
    (for the tuning phase's ladder rounds)."""
    from repro_torch.serve import AsyncServeEngine, ServeEngine

    def drive():
        kws = stream_model(KWS_TASK, device)
        anomaly = stream_model(ANOMALY_TASK, device)
        frames, labels = kws_sessions()
        keep.update(kws=kws, frames=frames)
        for routing in ("ensemble", "round_robin"):
            for cls in (ServeEngine, AsyncServeEngine):
                stream_nominal_round(kws, frames, routing, cls, device)
        emit({"phase": "stream", "round": "traced", "routing": "ensemble",
              **{cls.__name__: stream_idle_share(kws, frames, cls, device)
                 for cls in (ServeEngine, AsyncServeEngine)}})
        stream_c2c_round(kws, frames, labels, device)
        stream_anomaly_round(anomaly, device)
        stream_coalesced_round(kws, frames, device)
        stream_cli_round()
    return path_launches(drive, STREAM_KERNELS)


# ------------------------------------------------------------ the cli path

def quiet(fn, *args):
    """``fn(*args)`` with its standard output kept in a buffer and every
    warning recorded: ``(result, warnings)``."""
    import warnings
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.redirect_stdout(io.StringIO()):
        warnings.simplefilter("always")
        out = fn(*args)
    return out, [str(w.message) for w in caught]


def counted(kernels, fn, *args):
    """``fn(*args)`` quietly, with the launches of each of ``kernels``
    during it and its wall seconds: ``(result, warnings, launches,
    wall)``."""
    fns = {name: kernel_pair(name)[0] for name in kernels}
    before = {name: f.launches for name, f in fns.items()}
    t0 = time.perf_counter()
    out, caught = quiet(fn, *args)
    wall = time.perf_counter() - t0
    return out, caught, {name: f.launches - before[name]
                         for name, f in fns.items()}, wall


def cli_engine_round(device, async_serve):
    """(i) (a): ``launch.serve.build_engine`` on the serving phases'
    imbue-tm-mnist model (``--routing ensemble --nominal --batch 128``,
    R = 4): 512 requests equal to the digital TM, one
    ``imbue_infer_planes`` launch a dispatch, 0 fallbacks."""
    import argparse
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core import tm
    from repro_torch.launch import serve as cli
    cfg = tm_config(MODEL)
    ta, x, y = prototype_task(cfg, N_REQUESTS, SEED + 900)
    args = argparse.Namespace(
        nominal=True, batch=128, max_wait_ms=2.0, routing="ensemble",
        backend=None, packed=True, max_in_flight=2, async_serve=async_serve,
        replicas=REPLICAS, device=str(device))

    def serve():
        eng = cli.build_engine(args, cfg, torch.from_numpy(ta).to(device))
        eng.submit_many(list(x))
        eng.pump()
        return eng, eng.drain()

    (eng, out), _, launches, wall = counted(ANALOG_KERNELS, serve)
    s = eng.summary()
    digital = tm.forward(torch.from_numpy(ta).to(device),
                         torch.from_numpy(x).to(device), cfg).cpu().numpy()
    sums = np.stack([r.class_sums for r in out])
    if len(out) != len(x) or not np.array_equal(sums, REPLICAS * digital):
        raise AssertionError("cli engine: responses differ from the "
                             "digital TM")
    if eng.backend.name != "analog-cuda-packed2" or \
            s["fallback_dispatches"] or \
            launches != {"imbue_infer_planes": s["batches"],
                         "imbue_infer_packed": 0, "imbue_infer": 0}:
        raise AssertionError(f"cli engine: {eng.backend.name}, "
                             f"{s['fallback_dispatches']} fallbacks, "
                             f"launches {launches} for {s['batches']} "
                             "dispatches")
    emit({"phase": "cli", "round": "build_engine",
          "engine": type(eng).__name__, "backend": eng.backend.name,
          "requests": len(out), "dispatches": s["batches"],
          "launches": launches["imbue_infer_planes"],
          "equals_digital": True, "accuracy": float(np.mean(
              np.array([r.pred for r in out]) == y)),
          "requests_per_s": len(out) / wall})


def cli_serve_row(label, argv, s, launches, wall):
    return {"phase": "cli", "round": "serve", "run": label, "argv": argv,
            "backend": s["backend"], "requests": s["requests"],
            "dispatches": s["batches"], "requests_per_s": s["throughput_rps"],
            "p50_ms": s["p50_ms"], "p95_ms": s["p95_ms"],
            "p99_ms": s["p99_ms"], "mean_batch": s["mean_batch"],
            "padding_overhead": s["padding_overhead"],
            "analog_accuracy": s["analog_accuracy"],
            "fallback_dispatches": s["fallback_dispatches"],
            "launches": launches, "wall_s": wall}


def cli_serve_runs():
    """(i) (b): ``launch.serve.main`` on each analog tier
    (``CLI_SERVE_ARGS``), each tier's kernel launched once a dispatch and
    no other; then at its defaults, where it must warn, count every
    dispatch as a fallback and launch no analog kernel."""
    from repro_torch.launch import serve as cli
    for label, extra, backend, kernel in CLI_SERVE_TIERS:
        argv = [*CLI_SERVE_ARGS, *extra]
        s, _, launches, wall = counted(ANALOG_KERNELS, cli.main, argv)
        want = {k: (s["batches"] if k == kernel else 0)
                for k in ANALOG_KERNELS}
        if s["backend"] != backend or s["fallback_dispatches"] or \
                launches != want or \
                s["requests"] != int(argv[argv.index("--requests") + 1]):
            raise AssertionError(f"serve CLI {label}: {s['backend']}, "
                                 f"{s['fallback_dispatches']} fallbacks, "
                                 f"launches {launches}, want {want}")
        emit(cli_serve_row(label, argv, s, launches, wall))
    argv = list(CLI_SERVE_DEFAULTS)
    s, caught, launches, wall = counted(ANALOG_KERNELS, cli.main, argv)
    if not any("serve backend fallback" in w for w in caught) or \
            s["backend"] != "analog-torch" or not s["forward_fallbacks"] or \
            s["fallback_dispatches"] != s["batches"] or s["batches"] == 0 or \
            any(launches.values()):
        raise AssertionError(f"serve CLI defaults: the CSA-offset fallback "
                             f"was not loud and counted: {s['backend']}, "
                             f"{s['fallback_dispatches']} of {s['batches']}"
                             f", launches {launches}, warnings {caught}")
    emit({**cli_serve_row("defaults", argv, s, launches, wall),
          "warned": True, "fallback_reason": s["forward_fallbacks"][0]})


def cli_chaos_runs():
    """(i) (c): ``launch.chaos.main(["--smoke"])`` to ``smoke_ok`` (the
    injure, quarantine and repair loop), then at imbue-tm-mnist's width
    (``CLI_CHAOS_ARGS``) sync and async.  The full-width runs check
    serving and oracle equality only: 0 oracle mismatches, none expired
    or rejected, ``tm_infer`` launched (the probe commits), and what the
    reference CLI reads at these flags (no chip quarantined, every health
    1.0; its model's clauses never fire, so the injury changes no
    answer).  The fault loop is covered by ``--smoke``."""
    from repro_torch.launch import chaos
    rep, _, launches, wall = counted(("tm_infer",), chaos.main, ["--smoke"])
    if not rep.get("smoke_ok") or not launches["tm_infer"]:
        raise AssertionError(f"chaos smoke: {rep}")
    emit({"phase": "cli", "round": "chaos", "run": "smoke", "smoke_ok": True,
          "served": rep["served"], "launches": launches, "wall_s": wall})
    for extra in ((), ("--async-serve",)):
        argv = [*CLI_CHAOS_ARGS, *extra]
        rep, _, launches, wall = counted(("tm_infer", "imbue_infer_planes"),
                                         chaos.main, argv)
        rnd = rep["rounds"][0]
        if rep["oracle_mismatches"] or rep["expired"] or rep["rejected"] \
                or not launches["tm_infer"] or rep["served"] != 3 * int(
                    argv[argv.index("--requests") + 1]):
            raise AssertionError(f"chaos {argv}: {rep}")
        # What the reference CLI holds at these flags (JAX on the CPU):
        # every chip reads 1.0 before and after the injury and none is
        # quarantined.  At L = 1568 a 10 % include draw puts x_i and its
        # complement into nearly every clause (0.99 ** 784 of them escape),
        # so no clause fires, every class sum is 0 and the injury changes
        # no answer: the width hides it (ROADMAP queue 3).
        healths = [*rep["baseline_health"].values(),
                   *rnd["injured_health"].values()]
        if rnd["quarantined"] or any(h != 1.0 for h in healths):
            raise AssertionError(f"chaos {argv}: not what the reference "
                                 f"reads at this width: {rnd}")
        emit({"phase": "cli", "round": "chaos", "argv": argv,
              "served": rep["served"], "oracle_mismatches": 0,
              "expired": 0, "rejected": 0,
              "baseline_health": rep["baseline_health"],
              "injured_health": rnd["injured_health"],
              "quarantined": rnd["quarantined"], "repairs": rnd["repairs"],
              "launches": launches, "wall_s": wall})


def cli_retrain_runs():
    """(i) (d): ``launch.retrain.main(["--smoke"])``, then at the KWS width
    (``CLI_RETRAIN_ARGS``) sync and async: the decision, agreement and
    requests by version; by the engine's own counters, every request
    served was served by a pool version, none expired or rejected."""
    from repro_torch.launch import retrain
    kernels = ("clause_eval_packed", "imbue_infer_planes")
    rep, _, launches, wall = counted(kernels, retrain.main, ["--smoke"])
    if not rep.get("smoke_ok"):
        raise AssertionError(f"retrain smoke: {rep}")
    emit({"phase": "cli", "round": "retrain", "run": "smoke",
          "smoke_ok": True, "cycles": rep["cycles"], "launches": launches,
          "wall_s": wall})
    for extra in ((), ("--async-serve",)):
        argv = [*CLI_RETRAIN_ARGS, *extra]
        rep, _, launches, wall = counted(kernels, retrain.main, argv)
        s = rep["summary"]
        by_version = s["requests_by_version"]
        # One refit cycle: a pre-swap and a post-settle phase of
        # --requests each, and the canary's traffic between them.
        least = 2 * int(argv[argv.index("--requests") + 1])
        if s["expired"] or s["rejected"] or s["requests"] < least or \
                s["requests"] != sum(by_version.values()) or \
                not all(launches.values()):
            raise AssertionError(f"retrain {argv}: {rep}, launches "
                                 f"{launches}")
        emit({"phase": "cli", "round": "retrain", "argv": argv,
              "cycles": rep["cycles"], "requests": s["requests"],
              "requests_by_version": by_version, "dropped": 0,
              "backend": s["backend"], "launches": launches,
              "wall_s": wall})


def bench_module(name):
    """``benchmarks/<name>.py``, imported from the checkout's root."""
    import importlib
    root = str(Path(__file__).resolve().parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module(f"benchmarks.{name}")


def pair_row(a, b, key="wall_throughput_rps"):
    return {"first": a.get("backend"), "second": b.get("backend"),
            key: [a[key], b[key]], "ratio": b[key] / a[key]}


def cli_bench_runs():
    """(i) (e): the serve and stream benches' smokes (their bit-exact and
    clean-backend checks) and one default run of each; the headline
    rows, beside each bench model's ``model_activity`` (the reference's
    sparse random models, whose clauses hardly ever fire: mechanism
    readings, not a model whose clauses fire)."""
    serve_bench = bench_module("serve_bench_torch")
    stream_bench = bench_module("stream_bench_torch")
    for mod, label in ((serve_bench, "serve_bench"),
                       (stream_bench, "stream_bench")):
        rep, _, launches, wall = counted(CLI_KERNELS, mod.main, ["--smoke"])
        if not rep["smoke_ok"]:
            raise AssertionError(f"{label} smoke failed: {rep}")
        emit({"phase": "cli", "round": label, "run": "smoke",
              "smoke_ok": True, "launches": launches, "wall_s": wall})
    rep, _, launches, wall = counted(CLI_KERNELS, serve_bench.main, [])
    sync, asy = rep["sync_r4_b64_paired"], rep["async_r4_b64"]
    before, after = rep["planes_before_r4_b64"], rep["planes_after_r4_b64"]
    emit({"phase": "cli", "round": "serve_bench", "run": "default",
          "device": rep["device"], "model_activity": rep["model_activity"],
          "serial_rps": rep["serial_baseline"]["wall_throughput_rps"],
          "batched": [{k: r[k] for k in ("n_replicas", "max_batch",
                                         "wall_throughput_rps", "p99_ms",
                                         "speedup_vs_serial", "backend")}
                      for r in rep["sweep"]],
          "sync_async": pair_row(sync, asy),
          "overlap_fraction": [sync["overlap_fraction"],
                               asy["overlap_fraction"]],
          "planes": {**pair_row(before, after),
                     "resident_bytes_per_dispatch": [
                         before["resident_bytes_per_dispatch"],
                         after["resident_bytes_per_dispatch"]]},
          "capacity": {**pair_row(rep["capacity_analog_r4_b64"],
                                  rep["capacity_coalesced_b64"]),
                       "n_ta_total": [
                           rep["capacity_analog_r4_b64"]["n_ta_total"],
                           rep["capacity_coalesced_b64"]["n_ta_total"]]},
          "before_unpacked_static_rps":
              rep["before_unpacked_static"]["wall_throughput_rps"],
          "launches": launches, "wall_s": wall})
    rep, _, launches, wall = counted(CLI_KERNELS, stream_bench.main, [])
    emit({"phase": "cli", "round": "stream_bench", "run": "default",
          "device": rep["device"], "model_activity": rep["model_activity"],
          "lazy_tuning": rep["lazy_tuning"],
          "sweep": [{k: r[k] for k in ("sessions", "hop",
                                       "decisions_per_s_wall", "mean_batch",
                                       "padding_overhead")}
                    for r in rep["sweep"]],
          "sync_async": pair_row(rep["sync_s8_h4"], rep["async_s8_h4"],
                                 "decisions_per_s_wall"),
          "mixed_qos": rep["mixed_qos"]["qos"],
          "anomaly_decisions_per_s": rep["anomaly"]["decisions_per_s_wall"],
          "launches": launches, "wall_s": wall})


def example_module(name):
    """``examples/<name>.py`` as a module, with ``CLI_EXAMPLE_DEPTH``'s
    cuts applied."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in CLI_EXAMPLE_DEPTH.get(name, {}).items():
        setattr(mod, k, v)
    return mod


def cli_example_runs():
    """(i) (f): each example's ``main`` on the card (``image_imbue`` with
    ``--quick``), then ``benchmarks/run_torch.py --fast`` (every check
    must pass)."""
    for name, argv in (("torch_quickstart", []),
                       ("torch_serve_quickstart", []),
                       ("torch_stream_quickstart", []),
                       ("torch_swap_quickstart", []),
                       ("torch_image_imbue", ["--quick"])):
        out, caught, launches, wall = counted(CLI_KERNELS,
                                              example_module(name).main,
                                              argv)
        keep = {k: v for k, v in out.items()
                if isinstance(v, (int, float, str, bool))}
        if name == "torch_serve_quickstart" and not (
                out["fallback_dispatches"] == out["batches"] > 0
                and any("serve backend fallback" in w for w in caught)):
            raise AssertionError(f"{name}: the fallback was not counted")
        emit({"phase": "cli", "round": "example", "example": name,
              "depth": CLI_EXAMPLE_DEPTH.get(name, {}), **keep,
              "launches": {k: n for k, n in launches.items() if n},
              "wall_s": wall})
    run, _, launches, wall = counted(CLI_KERNELS,
                                     bench_module("run_torch").main,
                                     ["--fast"])
    if not all(ok for _, ok, _ in run["checks"]):
        raise AssertionError(f"run_torch --fast: {run['checks']}")
    emit({"phase": "cli", "round": "run_torch", "checks": len(run["checks"]),
          "all_pass": True, "device": run["device"],
          "bench_us": {k: v["us"] for k, v in run["benches"].items()},
          "kernels": run["benches"]["kernels"]["rows"],
          "launches": {k: n for k, n in launches.items() if n},
          "wall_s": wall})


def phase_cli(device):
    """Phase 3 (i), the cli path; returns its launches per kernel."""
    def drive():
        t0 = time.perf_counter()
        for async_serve in (False, True):
            cli_engine_round(device, async_serve)
        cli_serve_runs()
        cli_chaos_runs()
        cli_retrain_runs()
        cli_bench_runs()
        cli_example_runs()
        emit({"phase": "cli", "round": "total",
              "wall_s": time.perf_counter() - t0})
    return path_launches(drive, CLI_KERNELS)


# ------------------------------------------------------------------ mesh

def mesh_responses(out):
    """``(preds [n], sums [n, M])`` of Responses."""
    return (np.array([r.pred for r in out]),
            np.stack([r.class_sums for r in out]))


def mesh_one_rank(device):
    """(j) (a): a one-rank gloo group and ``make_replica_mesh(1, 1)`` on
    the card.  imbue-tm-mnist at R = 4 under D2D + C2C and at nominal in
    both routings, and the coalesced pool at ``COALESCED``: the mesh
    partitions nothing, so the kernel backends serve (0 fallbacks) and
    every Response equals the engine's without a mesh, bit for bit.  The
    engines without a mesh serve first; the launches returned are the
    mesh engines' alone."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core.variations import VariationConfig
    from repro_torch.launch.mesh import make_replica_mesh
    from repro_torch.serve import EngineConfig, ServeEngine
    t0 = time.perf_counter()
    dist.init_process_group(
        "gloo", init_method=f"file://{tempfile.mkdtemp()}/rendezvous",
        rank=0, world_size=1)
    try:
        mesh = make_replica_mesh(1, 1, device_type=device.type)
        cfg = tm_config(MODEL)
        ta, x, _ = prototype_task(cfg, N_REQUESTS, SEED + 1000)
        ccfg = coalesced_config()
        cta, w, cx, _ = coalesced_task(ccfg, N_REQUESTS, SEED + 1100)
        rounds = []
        for vname, vcfg in (("d2d_c2c", VariationConfig(csa_offset=False)),
                            ("nominal", VariationConfig.nominal())):
            for routing in ("round_robin", "ensemble"):
                rounds.append((
                    f"analog {vname} {routing}", "analog-cuda-packed2",
                    lambda m, vcfg=vcfg, routing=routing:
                    ServeEngine.from_ta_state(
                        torch.from_numpy(ta), cfg, n_replicas=REPLICAS,
                        seed=SEED, vcfg=vcfg,
                        ecfg=EngineConfig(routing=routing), device=device,
                        mesh=m), x))
        rounds.append(("coalesced", "coalesced-cuda-packed2",
                       lambda m: ServeEngine.from_coalesced(
                           torch.from_numpy(cta), torch.from_numpy(w), ccfg,
                           device=device, mesh=m), cx))

        def served(what, backend, eng, rows, want_mesh):
            got = mesh_responses(serve_all(eng, rows))
            s = eng.summary()
            if (eng.backend.name != backend or s["sharded"]
                    or s["mesh"] != want_mesh
                    or s["fallback_dispatches"]):
                raise AssertionError(
                    f"mesh (a) {what}: {eng.backend.name}, sharded "
                    f"{s['sharded']}, mesh {s['mesh']}, "
                    f"{s['fallback_dispatches']} fallbacks")
            return got

        control = {what: served(what, backend, build(None), rows, None)
                   for what, backend, build, rows in rounds}

        def drive():
            for what, backend, build, rows in rounds:
                got = served(what, backend, build(mesh), rows,
                             {"replica": 1, "batch": 1})
                for a, b in zip(got, control[what]):
                    if not np.array_equal(a, b):
                        raise AssertionError(f"mesh (a) {what}: the one-rank "
                                             "mesh changed a Response")
        launches = path_launches(drive, ("imbue_infer_planes",
                                         "tm_infer_planes"))
    finally:
        dist.destroy_process_group()
    emit({"phase": "mesh", "leg": "one_rank", "rounds": len(rounds),
          "requests": N_REQUESTS, "equal_to_no_mesh": True,
          "launches": launches,
          "wall_s": time.perf_counter() - t0, "card": nvidia_smi_line()})
    return launches


def rank_launches(kernels):
    """Every rank's launch counts of ``kernels`` since they were last
    zeroed, ``{rank: {kernel: n}}`` on every rank (one all-gather)."""
    import torch.distributed as dist
    mine = {name: kernel_pair(name)[0].launches for name in kernels}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return {str(r): c for r, c in enumerate(every)}


def zero_launches(kernels):
    for name in kernels:
        kernel_pair(name)[0].launches = 0


def mesh_split(eng, x):
    """Serve ``x`` on ``eng`` (submit, then drain) and return ``(preds,
    sums)`` with this rank's host split of the run: submitting, issuing
    (the rows' copies and the launches), waiting for the device at
    collect, agreeing on the cuts and gathering the blocks."""
    t0 = time.perf_counter()
    rids = eng.submit_many(list(x))
    t_submit = time.perf_counter() - t0
    eng.pump()
    out = {r.rid: r for r in eng.drain()}
    wall = time.perf_counter() - t0
    s = eng.summary()
    split = {"wall_s": wall, "submit_s": t_submit, "issue_s": s["issue_s"],
             "device_wait_s": s["device_wait_s"], "agree_s": s["agree_s"],
             "gather_s": s["gather_s"], "dispatches": s["batches"]}
    return mesh_responses([out[i] for i in rids]), split


def mesh_serving_rank(device_name, out_dir):
    """(j) (b), one of ``MESH_RANKS`` ranks on the card: imbue-tm-mnist at
    R = 4 on a ``2x2`` mesh, sync and async, routed and ensemble, under
    D2D + C2C and at nominal, on the plane-packed kernel (each rank its
    two replicas and its half of the rows), equal bit for bit to the
    single-device engine; then ``tm_train_step`` at imbue-tm-mnist, B =
    256, on a ``(data 2, model 2)`` mesh.  The counters are zeroed after
    the single-device engines, and every rank's launches of the mesh
    engines and of the mesh training step are reported.  Rank 0 writes
    ``mesh_b.json``."""
    import warnings

    import torch.distributed as dist
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core import tm
    from repro_torch.core import tm_distributed as tmd
    from repro_torch.core.tm_train import train_step_batch
    from repro_torch.core.variations import VariationConfig
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_debug_mesh, make_replica_mesh
    from repro_torch.serve import AsyncServeEngine, EngineConfig, ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(device_name)
    rank = dist.get_rank()
    mesh = make_replica_mesh(2, 2, device_type=device.type)
    cfg = tm_config(MODEL)
    ta, x, _ = prototype_task(cfg, N_REQUESTS, SEED + 1200)
    ta_t = torch.from_numpy(ta)
    digital = tm.forward(ta_t.to(device), torch.from_numpy(x).to(device),
                         cfg).cpu().numpy()
    report = {"rounds": []}

    def engine(cls, vcfg, routing, mesh_=None):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = cls.from_ta_state(ta_t, cfg, n_replicas=REPLICAS,
                                    seed=SEED, vcfg=vcfg, device=device,
                                    ecfg=EngineConfig(routing=routing),
                                    mesh=mesh_)
        return eng, [str(w.message) for w in caught]

    variations = (("d2d_c2c", VariationConfig(csa_offset=False)),
                  ("nominal", VariationConfig.nominal()))
    rounds = [(v, vcfg, routing) for v, vcfg in variations
              for routing in ("round_robin", "ensemble")]
    single = {}
    for vname, vcfg, routing in rounds:
        t0 = time.perf_counter()
        eng, _ = engine(ServeEngine, vcfg, routing)
        single[vname, routing] = mesh_responses(serve_all(eng, x))
        single[vname, routing, "wall_s"] = time.perf_counter() - t0
    serving = ("imbue_infer_planes",)
    zero_launches(serving)
    for vname, vcfg, routing in rounds:
        want = single[vname, routing]
        row = {"variation": vname, "routing": routing,
               "single_device_wall_s": single[vname, routing, "wall_s"]}
        for cls in (ServeEngine, AsyncServeEngine):
            eng, caught = engine(cls, vcfg, routing, mesh)
            got, split = mesh_split(eng, x)
            s = eng.summary()
            block = sharding.local_block(eng.state.r_stack)[0]
            what = f"mesh (b) {vname} {routing} {cls.__name__}"
            if not (s["sharded"] and s["plane_packed"]
                    and eng.backend.name == "analog-cuda-packed2"
                    and not eng.selection.fell_back and not caught
                    and s["fallback_dispatches"] == 0 and s["batches"] > 0
                    and block.device.type == device.type):
                raise AssertionError(
                    f"{what}: sharded {s['sharded']}, {eng.backend.name}, "
                    f"{s['fallback_dispatches']} fallbacks of "
                    f"{s['batches']}, block on {block.device}, "
                    f"warnings {caught}")
            for a, b in zip(got, want):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{what}: differs from the "
                                         "single-device kernel engine")
            sums = torch.from_numpy(np.ascontiguousarray(got[1]))
            every = [torch.empty_like(sums) for _ in
                     range(dist.get_world_size())]
            dist.all_gather(every, sums)
            if not all(torch.equal(e, sums) for e in every):
                raise AssertionError(f"{what}: ranks disagree")
            if vname == "nominal":
                scale = REPLICAS if routing == "ensemble" else 1
                if not np.array_equal(got[1], scale * digital):
                    raise AssertionError(f"{what}: nominal sums differ "
                                         "from the digital TM")
            splits = [None] * dist.get_world_size()
            dist.all_gather_object(splits, split)
            row[cls.__name__] = {
                "wall_s": split["wall_s"],
                "requests_per_s": len(x) / split["wall_s"],
                "dispatches": s["batches"], "backend": eng.backend.name,
                "fallback_dispatches": s["fallback_dispatches"],
                "overlap_fraction": s["overlap_fraction"],
                "p50_ms": s["p50_ms"], "p99_ms": s["p99_ms"],
                "mesh": s["mesh"], "split_by_rank": splits}
        report["rounds"].append(row)
    # One more issue of the warm async mesh engine at nominal, under the
    # sync debug mode that raises on a synchronizing CUDA operation: the
    # block's copy, the gather and the vote all wait for the collect.
    eng, _ = engine(AsyncServeEngine, VariationConfig.nominal(), "ensemble",
                    mesh)
    serve_all(eng, x[:128])
    eng.submit_many(list(x[:128]))
    batch = eng.batcher.cut(eng.clock(), force=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fl = eng._issue(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng._collect(fl)
    report["issue_syncs"] = 0
    report["serving_launches_by_rank"] = rank_launches(serving)
    # Training: clauses over model, rows over data.
    xtr, ytr, _, _ = image_task(**IMAGE_TASK)
    xtr, ytr = xtr[:TRAIN_BATCH], ytr[:TRAIN_BATCH]
    xb = torch.from_numpy(xtr).to(device)
    yb = torch.from_numpy(ytr).to(device)
    gen = torch.Generator(device=device)
    ta0 = tm.init_ta_state(gen.manual_seed(SEED), cfg, device)
    train_step_batch(ta0, gen.manual_seed(SEED + 1), xb, yb, cfg)   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = train_step_batch(ta0, gen.manual_seed(SEED + 1), xb, yb, cfg)
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    tmesh = make_debug_mesh(2, 2, device_type=device.type)
    st_sh, x_sh, y_sh = tmd.tm_shardings(cfg, tmesh, TRAIN_BATCH)
    placed = (st_sh.place(ta0), x_sh.place(xb), y_sh.place(yb))
    zero_launches(CLAUSE_KERNELS)
    tmd.tm_train_step(placed[0], gen.manual_seed(SEED + 1), *placed[1:],
                      cfg)                                         # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = tmd.tm_train_step(placed[0], gen.manual_seed(SEED + 1),
                            *placed[1:], cfg)
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    train_launches = rank_launches(CLAUSE_KERNELS)
    if not (sharding.partitioned(got)
            and torch.equal(sharding.gather(got), want)
            and not torch.equal(want, ta0)):
        raise AssertionError("mesh (b): tm_train_step differs from the "
                             "single-device step")
    report["training"] = {"batch": TRAIN_BATCH, "mesh": {"data": 2,
                                                          "model": 2},
                          "equal_to_single_device": True,
                          "mesh_steps": 2, "launches_by_rank": train_launches,
                          "mesh_step_s": t_mesh, "single_step_s": t_single}
    if rank == 0:
        with open(Path(out_dir) / "mesh_b.json", "w") as f:
            json.dump(report, f)


def mesh_coalesced_rank(device_name, out_dir):
    """(j) (b), one of two ranks: the coalesced pool at ``COALESCED``
    class-parallel on a ``2x1`` mesh (its M = 10 weight columns split in
    two), sync and async, on the plane-packed kernel (each rank its five
    class columns), equal to the single-device engine and to
    ``core.coalesced.forward``.  Rank 0 writes ``mesh_coalesced.json``
    with every rank's launches of the mesh engines."""
    import torch.distributed as dist
    from repro_torch.core.coalesced import forward as co_forward
    from repro_torch.launch.mesh import make_replica_mesh
    from repro_torch.serve import AsyncServeEngine, ServeEngine
    device = torch.device(device_name)
    mesh = make_replica_mesh(2, 1, device_type=device.type)
    ccfg = coalesced_config()
    ta, w, x, _ = coalesced_task(ccfg, N_REQUESTS, SEED + 1400)
    ta_t, w_t = torch.from_numpy(ta), torch.from_numpy(w)
    want = co_forward(ta_t.to(device), w_t.to(device),
                      torch.from_numpy(x).to(device), ccfg).cpu().numpy()
    single = mesh_responses(serve_all(ServeEngine.from_coalesced(
        ta_t, w_t, ccfg, device=device), x))
    report = {}
    zero_launches(("tm_infer_planes",))
    for cls in (ServeEngine, AsyncServeEngine):
        eng = cls.from_coalesced(ta_t, w_t, ccfg, device=device, mesh=mesh)
        got, split = mesh_split(eng, x)
        s = eng.summary()
        if not (s["sharded"] and eng.backend.name == "coalesced-cuda-packed2"
                and not eng.selection.fell_back
                and np.array_equal(got[1], want)
                and all(np.array_equal(a, b) for a, b in zip(got, single))):
            raise AssertionError(f"mesh (b) coalesced {cls.__name__}: "
                                 f"{eng.backend.name}, sharded "
                                 f"{s['sharded']}, or sums differ")
        splits = [None] * dist.get_world_size()
        dist.all_gather_object(splits, split)
        report[cls.__name__] = {"wall_s": split["wall_s"],
                                "requests_per_s": len(x) / split["wall_s"],
                                "dispatches": s["batches"],
                                "backend": eng.backend.name,
                                "mesh": s["mesh"], "split_by_rank": splits}
    report["launches_by_rank"] = rank_launches(("tm_infer_planes",))
    if dist.get_rank() == 0:
        with open(Path(out_dir) / "mesh_coalesced.json", "w") as f:
            json.dump(report, f)


def mesh_shared_card(device):
    """(j) (b): ``mesh_serving_rank`` on ``MESH_RANKS`` spawned ranks and
    ``mesh_coalesced_rank`` on two, each rank on the one card.  Fails if
    a rank launched no kernel of its leg; returns the launches summed
    over the ranks."""
    import tempfile

    from repro_torch.launch.hostdev import run_host_ranks
    totals = {}
    for fn, ranks, name in ((mesh_serving_rank, MESH_RANKS, "mesh_b.json"),
                            (mesh_coalesced_rank, 2,
                             "mesh_coalesced.json")):
        out = tempfile.mkdtemp()
        t0 = time.perf_counter()
        run_host_ranks(fn, ranks, (str(device), out), rdzv_dir=out,
                       timeout=MESH_TIMEOUT_S)
        with open(Path(out) / name) as f:
            report = json.load(f)
        for key in ("serving_launches_by_rank", "launches_by_rank"):
            for by_rank in (report.get(key), report.get("training", {})
                            .get(key)):
                for rank, counts in (by_rank or {}).items():
                    for kernel, n in counts.items():
                        if kernel in ("clause_eval",):
                            continue      # the sequential step's kernel
                        if n == 0:
                            raise AssertionError(
                                f"mesh (b) {name}: rank {rank} launched "
                                f"no {kernel}")
                        totals[kernel] = totals.get(kernel, 0) + n
        emit({"phase": "mesh", "leg": name.split(".")[0], "ranks": ranks,
              "transport": "gloo", **report,
              "wall_s": time.perf_counter() - t0, "card": nvidia_smi_line()})
    return totals


def mesh_cli(device):
    """(j) (c): ``launch.serve`` with ``MESH_CLI_ARGS`` under
    ``torch.distributed.run`` (``MESH_RANKS`` ranks, gloo on the one card):
    rank 0's summary shows the mesh and the plane-packed kernel, and its
    accuracy equals the same arguments' run without a mesh in this
    process."""
    import os

    from repro_torch.launch import serve as cli
    args = list(MESH_CLI_ARGS)
    if device.type != "cuda":
        args += ["--device", str(device)]
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(MESH_RANKS), "-m",
         "repro_torch.launch.serve", *args], capture_output=True, text=True,
        timeout=MESH_TIMEOUT_S,
        env={**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent
                                             / "src")})
    wall = time.perf_counter() - t0
    if run.returncode:
        raise AssertionError(f"mesh (c): torch.distributed.run exited "
                             f"{run.returncode}: {run.stderr[-3000:]}")
    s = json.loads(run.stdout[run.stdout.index("\n{") + 1:])
    whole, _ = quiet(cli.main, [a for a in args
                                if a not in MESH_CLI_ARGS[:2]])
    if not (s["sharded"] and s["mesh"] == {"replica": 2, "batch": 2}
            and s["backend"] == whole["backend"] == "analog-cuda-packed2"
            and s["analog_accuracy"] == whole["analog_accuracy"]):
        raise AssertionError(f"mesh (c): mesh {s['mesh']}, sharded "
                             f"{s['sharded']}, backend {s['backend']}, "
                             f"accuracy "
                             f"{s['analog_accuracy']} against "
                             f"{whole['analog_accuracy']} unsharded")
    emit({"phase": "mesh", "leg": "cli", "launcher": "torch.distributed.run",
          "ranks": MESH_RANKS, "argv": args, "mesh": s["mesh"],
          "backend": s["backend"], "analog_accuracy": s["analog_accuracy"],
          "unsharded_accuracy": whole["analog_accuracy"],
          "unsharded_backend": whole["backend"],
          "requests_per_s": s["throughput_rps"], "p99_ms": s["p99_ms"],
          "wall_s": wall, "card": nvidia_smi_line()})


def phase_mesh(device):
    """Phase 3 (j), the mesh path; returns the launches of its mesh
    engines: leg (a)'s in this process and leg (b)'s summed over the
    spawned ranks."""
    launches = {"one_rank": mesh_one_rank(device),
                "shared_card": mesh_shared_card(device)}
    mesh_cli(device)
    return launches


def clause_case(inc, x, device):
    """Operands of the two clause-bit kernels for one shape, keyed by
    kernel, and the share of (row, clause) pairs that fire, over all
    clauses and over the non-empty ones."""
    from repro_torch.core import tm
    from repro_torch.kernels import ops
    lits = tm.literals(torch.from_numpy(x).to(device)).contiguous()
    inc = inc.to(device).contiguous()
    fired = tm.clause_outputs_from_include(inc, lits, training=True).float()
    nonempty = inc.any(dim=-1)
    return ({"clause_eval_packed": (ops.pack_literals(lits),
                                    ops.pack_include(inc)),
             "clause_eval": (lits, inc)},
            float(fired.mean()), float(fired[:, nonempty].mean()))


def clause_shapes(device):
    """``(label, include, x)`` of the clause-kernel checks: the digital
    (C = 2000) and the coalesced (C = 1000) widths with one clause in 16
    emptied, at each of CLAUSE_BATCHES, the streaming widths (one clause
    in 16 emptied) at B = STREAM_TRAIN_BATCH, and one ragged shape
    (C = 101, L = 74, B = 13, an empty clause)."""
    from repro_torch.core.coalesced import CoalescedConfig
    shapes = []
    for label, inc, _, x in tm_widths(device, n=max(CLAUSE_BATCHES)):
        inc = inc.clone()
        inc[5::16] = False                                 # empty clauses
        shapes += [(label, inc, x[:b]) for b in CLAUSE_BATCHES]
    for label, inc, _, x in stream_widths(device, n=STREAM_TRAIN_BATCH):
        inc = inc.clone()
        inc[5::16] = False
        shapes.append((label, inc, x))           # the stream training step
    ragged = CoalescedConfig(n_classes=3, n_clauses=101, n_features=37,
                             n_states=100)
    rta, _, rx, _ = coalesced_task(ragged, 13, SEED + 2)
    rinc = torch.from_numpy(rta > ragged.n_states)
    rinc[50] = False
    shapes.append(("ragged", rinc, rx))
    return shapes


def phase_clause_kernels(device):
    """The two clause-bit kernels against their plain versions, tolerance
    0; empty clauses read 1; between 5 % and 95 % of bits fire, and at
    least 1 % of the non-empty clauses' bits."""
    rows, max_err = [], dict.fromkeys(CLAUSE_KERNELS, 0)
    for label, inc, x in clause_shapes(device):
        args, fired, fired_nonempty = clause_case(inc, x, device)
        empty = ~args["clause_eval"][1].any(dim=-1)
        for name in CLAUSE_KERNELS:
            fn, ref = kernel_pair(name)
            got, want = fn(*args[name]), ref(*args[name])
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            rows.append({"kernel": name, "width": label,
                         "C": int(inc.shape[0]), "L": int(inc.shape[1]),
                         "B": int(x.shape[0]), "max_abs_err": err,
                         "fired_frac": fired,
                         "fired_frac_nonempty": fired_nonempty,
                         "empty_clauses": int(empty.sum())})
            if err != 0 or not torch.equal(got, want) or \
                    got.dtype != torch.uint8:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {rows[-1]}")
            if not bool((got[:, empty] == 1).all()) or not empty.any():
                raise AssertionError(f"{name}: an empty clause did not "
                                     f"fire: {rows[-1]}")
            if not 0.05 <= fired <= 0.95 or fired_nonempty < 0.01:
                raise AssertionError(f"parity of (mostly) constant clause "
                                     f"bits: {rows[-1]}")
            max_err[name] = max(max_err[name], err)
    emit({"phase": "kernels", "kernels": list(CLAUSE_KERNELS),
          "tolerance": 0, "cases": rows})
    return max_err


def training_data(device):
    """The image task as tensors on ``device``, and its numpy arrays."""
    arrays = image_task(**IMAGE_TASK)
    return [torch.from_numpy(a).to(device) for a in arrays], arrays


def check_states(ta, n_states, what):
    if ta.dtype != torch.int16 or int(ta.min()) < 1 or \
            int(ta.max()) > 2 * n_states:
        raise AssertionError(f"{what}: TA states left [1, 2N] or int16: "
                             f"{ta.dtype} {int(ta.min())}..{int(ta.max())}")


def train_digital(cfg, data, gen, device):
    """``fit(parallel=True)`` from ``init_ta_state``, one epoch a call: test
    accuracy and host ms per step / epoch; one ``clause_eval_packed``
    launch per step.  Returns the trained state and the timings."""
    from repro_torch.core import tm, tm_train
    from repro_torch.kernels.clause_eval import clause_eval_packed
    xtr, ytr, xte, yte = data
    steps = xtr.shape[0] // TRAIN_BATCH
    ta = tm.init_ta_state(gen, cfg, device)
    rows = []
    for epoch in range(1, TRAIN_EPOCHS + 1):
        launches0 = clause_eval_packed.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ta = tm_train.fit(ta, gen, xtr, ytr, cfg, epochs=1,
                          batch_size=TRAIN_BATCH, parallel=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = clause_eval_packed.launches - launches0
        if launches != steps:
            raise AssertionError(f"{launches} clause_eval_packed launches "
                                 f"for {steps} batch steps")
        check_states(ta, cfg.n_states, "fit(parallel=True)")
        rows.append({"epoch": epoch, "steps": steps, "launches": launches,
                     "test_accuracy": float(tm.accuracy(ta, xte, yte, cfg)),
                     "ms_per_epoch": wall * 1e3,
                     "ms_per_step": wall * 1e3 / steps})
        emit({"phase": "training", "model": MODEL, "driver":
              "tm_train.fit(parallel=True)", "batch": TRAIN_BATCH,
              **rows[-1]})
    if rows[-1]["test_accuracy"] < TRAIN_ACCURACY_FLOOR:
        raise AssertionError(f"trained accuracy {rows[-1]['test_accuracy']}"
                             f" below the floor {TRAIN_ACCURACY_FLOOR}")
    return ta, rows


def train_sequential(cfg, ta, data, gen, n=TRAIN_BATCH):
    """``fit(parallel=False)`` over ``n`` examples: one ``clause_eval``
    launch per example."""
    from repro_torch.core import tm, tm_train
    from repro_torch.kernels.clause_eval import clause_eval
    xtr, ytr, xte, yte = data
    launches0 = clause_eval.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tm_train.fit(ta, gen, xtr[:n], ytr[:n], cfg, epochs=1,
                       parallel=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = clause_eval.launches - launches0
    if launches != n:
        raise AssertionError(f"{launches} clause_eval launches for {n} "
                             "sequential examples")
    check_states(out, cfg.n_states, "fit(parallel=False)")
    emit({"phase": "training", "model": MODEL,
          "driver": "tm_train.fit(parallel=False)", "examples": n,
          "launches": launches, "ms_per_example": wall * 1e3 / n,
          "test_accuracy": float(tm.accuracy(out, xte, yte, cfg))})


def train_online(cfg, arrays, gen, device):
    """``OnlineTrainer``: ingest the train set, refit twice (versions 1 and
    2); the second refit must be ``fit`` from the first one's state."""
    from repro_torch.core import tm_train
    from repro_torch.train.online import OnlineTrainer, OnlineTrainerConfig
    xtr, ytr = arrays[0], arrays[1]
    trainer = OnlineTrainer(cfg, gen, device=device, cfg=OnlineTrainerConfig(
        epochs=1, batch_size=TRAIN_BATCH))
    if trainer.ingest(xtr, ytr) != len(xtr):
        raise AssertionError("OnlineTrainer dropped rows below its cap")
    tv1 = trainer.refit()
    gen_state = gen.get_state()
    tv2 = trainer.refit()
    replay_gen = torch.Generator(device=device)
    replay_gen.set_state(gen_state)
    replay = tm_train.fit(tv1.ta_state, replay_gen, xtr, ytr, cfg, epochs=1,
                          batch_size=TRAIN_BATCH, parallel=True)
    if (tv1.version, tv2.version) != (1, 2) or \
            not torch.equal(replay, tv2.ta_state):
        raise AssertionError("OnlineTrainer: versions "
                             f"{tv1.version}, {tv2.version}; second refit "
                             "not warm from the first")
    check_states(tv2.ta_state, cfg.n_states, "OnlineTrainer")
    emit({"phase": "training", "driver": "OnlineTrainer.refit",
          "versions": [tv1.version, tv2.version],
          "train_accuracy": [tv1.accuracy, tv2.accuracy],
          "n_examples": tv2.n_examples, "warm_start_replayed": True})


def checkpoint_round_trip(ta, weights, device):
    """``checkpoint.save`` then ``restore`` onto the card: identical leaves
    and the manifest's digest."""
    import tempfile
    from repro_torch.distributed import checkpoint
    tree = {"ta_state": ta, "weights": weights}
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, tree, extra={"model": MODEL})
        step, got, manifest = checkpoint.restore_latest(d, tree, device)
    digest = checkpoint.content_digest(
        {k: v.cpu().numpy() for k, v in tree.items()})
    if step != 1 or manifest["extra"][checkpoint.DIGEST_KEY] != digest or \
            not all(torch.equal(got[k], tree[k]) for k in tree):
        raise AssertionError("checkpoint round trip changed the model")
    emit({"phase": "training", "check": "checkpoint", "identical": True,
          "digest": digest[:16]})


def batch_step_exactness(cfg, ta, data, device):
    """One ``train_step_batch`` from one CUDA generator seed, as shipped
    and with the ops wrapper swapped for its plain version: bit-identical
    TA states."""
    from repro_torch.core import tm_train
    from repro_torch.kernels import clause_eval
    xtr, ytr = data[0][:TRAIN_BATCH], data[1][:TRAIN_BATCH]
    outs = []
    for plain in (False, True):
        real = clause_eval.clause_eval_packed
        if plain:
            clause_eval.clause_eval_packed = clause_eval.clause_eval_packed_ref
        try:
            gen = torch.Generator(device=device).manual_seed(SEED + 800)
            outs.append(tm_train.train_step_batch(ta, gen, xtr, ytr, cfg))
        finally:
            clause_eval.clause_eval_packed = real
    moved = int((outs[0] != ta).sum())
    if not torch.equal(outs[0], outs[1]) or moved == 0:
        raise AssertionError(f"batch step: kernel and plain states differ "
                             f"(or nothing moved: {moved})")
    emit({"phase": "training", "check": "batch step, kernel == plain",
          "B": TRAIN_BATCH, "identical": True, "states_moved": moved})


def phase_training(device):
    """The training path at imbue-tm-mnist and at the coalesced width;
    returns the clause kernels' launches on it and the timings."""
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core import coalesced as co
    from repro_torch.core.variations import VariationConfig
    cfg = tm_config(MODEL)
    ccfg = coalesced_config()
    data, arrays = training_data(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 700)
    out = {}

    def drive():
        ta, out["epochs"] = train_digital(cfg, data, gen, device)
        out["ta"] = ta
        train_sequential(cfg, ta, data, gen)
        train_online(cfg, arrays, gen, device)
        cta, cw = co.init_coalesced(gen, ccfg, device)
        rows = []
        for epoch in range(1, COALESCED_EPOCHS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cta, cw = co.fit(cta, cw, gen, data[0], data[1], ccfg, epochs=1,
                             batch_size=TRAIN_BATCH)
            torch.cuda.synchronize()
            steps = data[0].shape[0] // TRAIN_BATCH
            rows.append({"epoch": epoch, "ms_per_step":
                         (time.perf_counter() - t0) * 1e3 / steps,
                         "test_accuracy": float(co.accuracy(
                             cta, cw, data[2], data[3], ccfg))})
        check_states(cta, ccfg.n_states, "coalesced.fit")
        if int(cw.abs().max()) > ccfg.max_weight or cw.dtype != torch.int32:
            raise AssertionError("coalesced weights left ±max_weight")
        emit({"phase": "training", "model": "coalesced", "config": COALESCED,
              "driver": "coalesced.fit", "batch": TRAIN_BATCH,
              "epochs": rows, "max_abs_weight": int(cw.abs().max())})
        out["coalesced"] = (cta, cw)

    launches = path_launches(drive, CLAUSE_KERNELS)
    ta = out["ta"]
    batch_step_exactness(cfg, ta, data, device)
    checkpoint_round_trip(ta, out["coalesced"][1], device)
    # Hand the trained states to the serving paths built in slices 1-3.
    xte, yte = arrays[2], arrays[3]
    serve_round(cfg, ta.cpu().numpy(), xte, yte, VariationConfig.nominal(),
                {}, "analog-cuda-packed2", "imbue_infer_planes", device)
    cta, cw = out["coalesced"]
    coalesced_round(ccfg, cta.cpu().numpy(), cw.cpu().numpy(), xte, yte, {},
                    "coalesced-cuda-packed2", "tm_infer_planes", device)
    monte_carlo_round(device)
    return launches, out["epochs"]


def monte_carlo_round(device):
    """The Monte-Carlo row: ``monte_carlo_accuracy`` and
    ``clause_error_rate`` (MC_DRAWS draws, each one programmed chip and one
    read; eager, as in the reference) on MC_ROWS requests of the serving
    phases' imbue-tm-mnist model.  At nominal every draw equals the digital
    accuracy and no clause errs; under ``VariationConfig()`` (D2D + C2C +
    CSA offset) the mean accuracy is at least the digital one - 0.02 and
    the worst clause error rate at most 0.01 (``tests/test_imbue.py``'s
    bars).  Every draw, their mean and spread, ms a draw."""
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core import imbue, tm
    from repro_torch.core.variations import VariationConfig
    cfg = tm_config(MODEL)
    ta, x, y = (torch.from_numpy(a).to(device)
                for a in prototype_task(cfg, MC_ROWS, SEED))
    digital = float(tm.accuracy(ta, x, y, cfg))
    row = {"phase": "training", "check": "monte carlo", "model": MODEL,
           "rows": MC_ROWS, "draws": MC_DRAWS, "digital_accuracy": digital}
    for name, vcfg in (("nominal", VariationConfig.nominal()),
                       ("d2d_c2c_csa", VariationConfig())):
        gen = torch.Generator(device=device).manual_seed(SEED + 1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accs = imbue.monte_carlo_accuracy(ta, x, y, gen, cfg, vcfg, MC_DRAWS,
                                          device=device).cpu().numpy()
        t1 = time.perf_counter()
        errs = imbue.clause_error_rate(ta, x, gen, cfg, vcfg, MC_DRAWS,
                                       device=device).cpu().numpy()
        t2 = time.perf_counter()
        row[name] = {"accuracy": accs.tolist(),
                     "accuracy_mean": float(accs.mean()),
                     "accuracy_std": float(accs.std(ddof=1)),
                     "clause_error": errs.tolist(),
                     "clause_error_mean": float(errs.mean()),
                     "clause_error_max": float(errs.max()),
                     "accuracy_ms_per_draw": (t1 - t0) * 1e3 / MC_DRAWS,
                     "clause_error_ms_per_draw": (t2 - t1) * 1e3 / MC_DRAWS}
    nom, var_ = row["nominal"], row["d2d_c2c_csa"]
    if not all(a == np.float32(digital) for a in nom["accuracy"]) or \
            nom["clause_error_max"] != 0.0:
        raise AssertionError(f"monte carlo at nominal differs from digital: "
                             f"{nom}")
    if var_["accuracy_mean"] < digital - 0.02 or \
            var_["clause_error_max"] > 0.01:
        raise AssertionError(f"monte carlo under variation: {var_}")
    emit(row)


def clause_bytes_and_work(name, args):
    """Bytes each input is read once and the ``[B, C]`` bits written once,
    and the operations: B*C*Lw word steps of one 32-bit logic operation
    each (packed: only viol == 0 is kept, an OR of ~lit & inc), or 2*B*C*L
    operations on 0/1 bytes at the card's int8 rate (dense).  The packed
    figure is the floor on the CUDA cores; the kernel counts on the b1
    tensor cores, whose Hopper rate is not published, so its own floor
    may be lower, down to the bytes' time."""
    a, inc = args
    b, k = a.shape
    c = inc.shape[0]
    nbytes = (a.numel() * a.element_size() + inc.numel() * inc.element_size()
              + b * c)
    if name == "clause_eval":
        return nbytes, [(2 * b * c * k, INT8_OP_PER_S)]
    return nbytes, [(b * c * k, lop3_per_s())]


def clause_route(name, b, l):
    """Which kernel of ``name``'s library a ``[b, l]`` launch takes:
    ``clause_eval`` has a warp-per-clause kernel for small batches and the
    32 x 64 tile kernel, as ``clause_eval_small_route`` reports;
    ``clause_eval_packed`` has one, the b1 tensor-core product."""
    import ctypes
    from repro_torch.kernels import _build
    if name == "clause_eval_packed":
        return "b1mma"
    lib = ctypes.CDLL(str(_build.library_path(name)))
    return "warp per clause" if lib.clause_eval_small_route(b, l) else "tile"


def b1_geometry(name, *shape, tiles=None):
    """The launch geometry of ``name`` (a kernel on ``csrc/tm_b1.cuh``) at
    ``shape``, as its ``<name>_geometry`` export reports it: grid,
    threads, shared bytes, resident blocks an SM, K-split, block tile,
    and the launched warps an SM (the grid's warps / SMs, capped by what
    is resident).  ``shape``: ``(B, C, Lw)`` for ``clause_eval_packed``,
    ``(B, C, Lw, M)`` for ``tm_infer_planes`` and ``tm_infer_packed``,
    ``(B, C, L, M)`` for ``tm_infer``, the three inference kernels with
    the tile override ``tiles`` (None: the kernel's own layout)."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.clause_eval import tm_tiles
    lib = ctypes.CDLL(str(_build.library_path(name)))
    info = (ctypes.c_int * 9)()
    if name != "clause_eval_packed":
        shape = (*shape, *tm_tiles(tiles))
    if getattr(lib, f"{name}_geometry")(*shape, info) != 0:
        raise RuntimeError(f"{name}_geometry failed")
    gx, gy, threads, smem, per_sm, ksplit, bt, ct, _ = list(info)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return {"grid": [gx, gy], "threads": threads, "smem_bytes": smem,
            "blocks_per_sm": per_sm, "k_split": ksplit, "tile": [bt, ct],
            "warps_per_sm": min(gx * gy * threads / 32 / n_sm,
                                per_sm * threads / 32)}


def phase_clause_timing(device, train_epochs):
    """Both clause kernels at the digital and the coalesced width, B in
    CLAUSE_BATCHES: device time, the route taken, plain version, bound and
    the ``torch.matmul`` bracket (``(1 - lits) @ include^T == 0`` on
    float32 operands, TF32 off); for ``clause_eval_packed`` its geometry;
    and the training step's split into kernel and eager TA update."""
    flush = torch.empty(256 * 2 ** 20 // 4, dtype=torch.float32,
                        device=device)
    rows = []
    for label, inc, _, x in tm_widths(device, n=max(CLAUSE_BATCHES)):
        for b in CLAUSE_BATCHES:
            args, _, _ = clause_case(inc, x[:b], device)
            lit0 = 1.0 - args["clause_eval"][0].float()
            inc_f = args["clause_eval"][1].float()
            bracket = time_ms(lambda: torch.matmul(lit0, inc_f.T) == 0, 20,
                              flush)
            for name in CLAUSE_KERNELS:
                fn, ref = kernel_pair(name)
                a = args[name]
                ms = time_ms(lambda: fn(*a), 20, flush)
                plain = time_ms(lambda: ref(*a), 5, flush)
                nbytes, work = clause_bytes_and_work(name, a)
                bms, by = bound_ms(nbytes, work)
                row = {"kernel": name, "width": label,
                       "C": int(inc.shape[0]), "L": int(inc.shape[1]),
                       "B": b, "route": clause_route(
                           name, b, int(inc.shape[1])),
                       "ms": ms, "plain_ms": plain,
                       "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                       "ops": [ops for ops, _ in work],
                       "ops_per_s": [rate for _, rate in work],
                       "bound_share": bms / ms,
                       "matmul_bracket_ms": bracket}
                if name == "clause_eval_packed":
                    row.update(b1_geometry(name, b, *a[1].shape))
                rows.append(row)
    step_ms = train_epochs[-1]["ms_per_step"]
    kernel_ms = next(r["ms"] for r in rows if r["B"] == TRAIN_BATCH
                     and r["width"] == "digital"
                     and r["kernel"] == "clause_eval_packed")
    emit({"phase": "timing", "kernels": list(CLAUSE_KERNELS),
          "clock": "cuda events, median, L2 flushed, host enqueue "
                   "hidden behind a spin kernel",
          "bound": "max(bytes / 3.35 TB/s, ops / rate); packed: B*C*Lw "
                   "word steps at the 32-bit logic rate (64 per clock per "
                   "SM), the CUDA cores' floor (the kernel runs on the b1 "
                   "tensor cores, whose rate is not published); dense: "
                   "2*B*C*L at 1979 TOP/s (int8)", "rows": rows,
          "train_step_B256": {"host_ms_per_step": step_ms,
                              "clause_eval_packed_ms": kernel_ms,
                              "rest_ms": step_ms - kernel_ms}})
    return rows


# ------------------------------------------------------------ tuning

def main_path_tiles(backend, c, l, device):
    """The tiles an engine serving ``backend`` at a ``[C, L]`` model
    launches on this card: the committed entry's where they fit the model
    (``ServeEngine``'s rule), else none ("auto", ``{}``)."""
    from repro_torch import api
    from repro_torch.kernels import autotune
    entry = api.get_tuning(backend, api.shape_bucket_key(c, l), device)
    tiles = dict((entry or {}).get("tiles") or {})
    return tiles if autotune.tiles_fit(tiles, l) else {}


def tm_backend(family, name):
    """The fused ``family`` ("digital" or "coalesced") backend that runs
    TM kernel ``name``, or None (there is no digital planes backend)."""
    from repro_torch.kernels import autotune
    tier = {"tm_infer_planes": "-packed2", "tm_infer_packed": "-packed",
            "tm_infer": ""}[name]
    backend = f"{family}-cuda{tier}"
    return backend if backend in autotune.KERNEL_OF else None


def tile_label(tiles):
    """``"auto"`` for no override, else the tile's table key."""
    from repro_torch.kernels import autotune
    return autotune.tile_key(tiles)


def timed_at_tiles(fn, args, tiles, flush):
    """``(ms, auto_ms)``: ``fn``'s device time with the tile override
    ``tiles`` and without one ("auto"); one timing when there is none."""
    ms = time_ms(lambda: fn(*args, tiles=tiles), 20, flush)
    return ms, (time_ms(lambda: fn(*args), 20, flush) if tiles else ms)


def check_tiles(name, args, lw, rows, label, **extra):
    """``name`` at every tile of its full grid and "auto" on ``args``
    against its plain version, tolerance 0: one launch a tile; a ks past
    the ``lw`` columns raises ``ValueError`` and launches nothing."""
    from repro_torch.kernels import autotune
    fn, ref = kernel_pair(name)
    want = ref(*args)
    analog = name.startswith("imbue")
    n_ok = 0
    for tiles in autotune.grid_tiles(autotune.ANALOG_GRID if analog
                                     else autotune.TM_GRID):
        before = fn.launches
        if analog and tiles.get("ks", 0) > lw:
            try:
                fn(*args, tiles=tiles)
            except ValueError:
                if fn.launches != before:
                    raise AssertionError(f"{name}: a refused tile launched")
                continue
            raise AssertionError(f"{name}: ks {tiles['ks']} past {lw} "
                                 "columns was not refused")
        got = fn(*args, tiles=tiles)
        torch.cuda.synchronize()
        if fn.launches != before + 1 or not torch.equal(got, want):
            raise AssertionError(f"{name} at tile {tiles} disagrees with "
                                 f"its plain version ({label}, {extra})")
        n_ok += 1
    rows.append({"kernel": name, "width": label, **extra, "tiles": n_ok,
                 "nonzero_frac": float((want != 0).float().mean())})


def tuning_exactness(device):
    """(a) the six fused inference kernels at every tile of the full grid
    plus "auto", exact against their plain versions: the analog kernels at
    imbue-tm-mnist and the KWS and anomaly widths, B in CHECK_BATCHES, with
    and without the deviation plane (D2D and nominal planes for the dense
    two), and the ragged small shape; the TM kernels at the digital,
    coalesced and streaming widths, B in TM_CHECK_BATCHES, and the ragged
    shape."""
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core.coalesced import CoalescedConfig
    from repro_torch.core.tm import TMConfig
    from repro_torch.kernels import ops
    rows = []
    small = TMConfig(n_classes=4, clauses_per_class=8, n_features=37,
                     n_states=100)                         # C=32, L=74
    widths = [("imbue-tm-mnist", tm_config(MODEL), SEED, CHECK_BATCHES),
              ("kws", stream_config(KWS_TASK), SEED + 5, CHECK_BATCHES),
              ("anomaly", stream_config(ANOMALY_TASK), SEED + 5,
               CHECK_BATCHES), ("ragged", small, SEED + 1, (13,))]
    for label, cfg, seed, batches in widths:
        ta, x, _ = prototype_task(cfg, max(128, *batches), seed)
        if label == "ragged":
            ta[5] = 1                                      # empty clause
        lw = -(-cfg.n_literals // 32)
        for b in batches:
            xb = check_rows(x, b)
            for dev in (False, True):
                r = 3 if label == "ragged" else REPLICAS
                args = planes_case(cfg, ta, xb, r if dev else 1, dev,
                                   seed + b, device)
                check_tiles("imbue_infer_planes", args, lw, rows, label,
                            B=b, R=r if dev else 1, dev=dev)
                cases, _ = dense_case(cfg, ta, xb, r, dev, seed + b, device)
                for name in DENSE_KERNELS:
                    check_tiles(name, cases[name], lw, rows, label, B=b, R=r,
                                d2d=dev)
                del cases
    tm_cases = [(label, inc, comb, x[:b]) for label, inc, comb, x
                in tm_widths(device, n=TM_CHECK_BATCHES[-1]) +
                stream_widths(device, n=TM_CHECK_BATCHES[-1])
                for b in TM_CHECK_BATCHES]
    ragged = CoalescedConfig(n_classes=3, n_clauses=101, n_features=37,
                             n_states=100)                 # C=101, L=74
    rta, rw, rx, _ = coalesced_task(ragged, 13, SEED + 2)   # B=13
    rinc = torch.from_numpy(rta > ragged.n_states)
    rinc[50] = False                                        # empty clause
    tm_cases.append(("ragged", rinc, ops.coalesced_combine(
        torch.from_numpy(rw), rinc.any(dim=-1)), rx))
    for label, inc, comb, x in tm_cases:
        args, _ = tm_case(inc, x, comb, device)
        for name in TM_KERNELS:
            check_tiles(name, args["dense" if name == "tm_infer"
                                   else "packed"], 0, rows, label,
                        B=int(x.shape[0]), C=int(inc.shape[0]))
    for kernel, label in {(r["kernel"], r["width"]) for r in rows}:
        if max(r["nonzero_frac"] for r in rows if r["kernel"] == kernel
               and r["width"] == label) < 0.05:
            raise AssertionError(f"{kernel}: parity of (mostly) zeros at "
                                 f"the {label} width")
    emit({"phase": "tuning", "part": "a", "check": "every tile exact",
          "tolerance": 0, "tiles_checked": sum(r["tiles"] for r in rows),
          "cases": rows})


def tuning_smoke_and_lazy(device):
    """(b) ``autotune(smoke=True, register=False)`` on the card; then
    ``ensure_tuning`` at a shape the table lacks measures once, and a
    second engine at that bucket does not measure again."""
    from repro_torch import api
    from repro_torch.core import tm
    from repro_torch.core.variations import VariationConfig
    from repro_torch.kernels import autotune
    from repro_torch.serve import BatcherConfig, EngineConfig, ServeEngine
    t0 = time.perf_counter()
    smoke = autotune.autotune(smoke=True, register=False, device=device)
    smoke_s = time.perf_counter() - t0
    if set(smoke) != set(autotune.KERNEL_OF) or not all(
            autotune.AUTO in e["tile_latency_us"] and e["bucket_sizes"]
            and e["device_name"] == torch.cuda.get_device_name(device)
            for shapes in smoke.values() for e in shapes.values()):
        raise AssertionError(f"autotune smoke: {smoke}")
    cfg = tm.TMConfig(n_classes=3, clauses_per_class=20, n_features=100,
                      n_states=100)                   # c64-l256: unseen
    key = api.shape_bucket_key(cfg.n_clauses, cfg.n_literals)
    snap = api.tuning_snapshot()
    measure, calls = autotune.autotune_backend, []

    def counted(backend, **kw):
        calls.append(backend.name)
        return measure(backend, **kw)

    autotune.autotune_backend = counted
    try:
        if api.get_tuning("analog-cuda-packed2", key, device) is not None:
            raise AssertionError(f"{key} is not an unseen shape")
        ta, x, _ = prototype_task(cfg, 64, SEED + 9)
        engines = [ServeEngine.from_ta_state(
            torch.from_numpy(ta), cfg, n_replicas=REPLICAS, seed=SEED,
            vcfg=VariationConfig.nominal(), ecfg=EngineConfig(
                lazy_tune=True, batcher=BatcherConfig.for_max_batch(128)),
            device=device) for _ in range(2)]
        if calls != ["analog-cuda-packed2"]:
            raise AssertionError(f"lazy tune measured {calls}")
        entry = engines[0].tuning
        for eng in engines:
            s = eng.summary()
            if not (s["tuning_lazy"] and s["shape_key"] == key
                    and s["kernel_tiles"] == entry["tiles"]
                    and eng.tuning == entry):
                raise AssertionError(f"lazy tune: {s}")
        out = serve_all(engines[1], x)
        sums = np.stack([r.class_sums for r in out])
        want = tm.forward(torch.from_numpy(ta).to(device),
                          torch.from_numpy(x).to(device), cfg).cpu().numpy()
        if not np.array_equal(sums, want):
            raise AssertionError("lazily tuned engine differs from the "
                                 "digital TM")
    finally:
        autotune.autotune_backend = measure
        api.restore_tuning(snap)
    emit({"phase": "tuning", "part": "b", "smoke_cells": sum(
        len(v) for v in smoke.values()), "smoke_s": smoke_s,
        "smoke": {n: {k: {"tiles": e["tiles"], "buckets": e["bucket_sizes"]}
                      for k, e in v.items()} for n, v in smoke.items()},
        "lazy_shape_key": key, "lazy_measurements": len(calls),
        "lazy_engines": 2, "lazy_entry": {
            k: entry[k] for k in ("tiles", "bucket_sizes", "tile_latency_us",
                                  "bucket_latency_us", "tile_estimator")}})


def serve_all(eng, x):
    """Submit every row of ``x``, drain, and return the Responses in
    submission order."""
    rids = eng.submit_many(list(x))
    eng.pump()
    out = {r.rid: r for r in eng.drain()}
    return [out[i] for i in rids]


def tuned_engine_round(kind, device):
    """(c) an engine under ``BatcherConfig.for_max_batch(128)`` at
    imbue-tm-mnist (R = 4, ``analog-cuda-packed2``, ensemble) or at the
    coalesced width (``coalesced-cuda-packed2``) consumes the committed
    table's entry for its backend, shape bucket and card: its ladder and
    its tiles in ``summary()``; 512 nominal requests equal the digital TM
    / ``core.coalesced.forward``, 0 fallbacks, one launch a dispatch."""
    from repro_torch import api
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core import coalesced as co
    from repro_torch.core import tm
    from repro_torch.core.variations import VariationConfig
    from repro_torch.serve import BatcherConfig, EngineConfig, ServeEngine
    ecfg = EngineConfig(batcher=BatcherConfig.for_max_batch(128),
                        routing="ensemble")
    if kind == "analog":
        cfg = tm_config(MODEL)
        ta, x, _ = prototype_task(cfg, N_REQUESTS, SEED + 400)
        eng = ServeEngine.from_ta_state(
            torch.from_numpy(ta), cfg, n_replicas=REPLICAS, seed=SEED,
            vcfg=VariationConfig.nominal(), ecfg=ecfg, device=device)
        want = REPLICAS * tm.forward(torch.from_numpy(ta).to(device),
                                     torch.from_numpy(x).to(device), cfg)
        backend, kernel = "analog-cuda-packed2", "imbue_infer_planes"
    else:
        cfg = coalesced_config()
        ta, w, x, _ = coalesced_task(cfg, N_REQUESTS, SEED + 401)
        eng = ServeEngine.from_coalesced(
            torch.from_numpy(ta), torch.from_numpy(w), cfg, ecfg=ecfg,
            device=device)
        want = co.forward(torch.from_numpy(ta).to(device),
                          torch.from_numpy(w).to(device),
                          torch.from_numpy(x).to(device), cfg)
        backend, kernel = "coalesced-cuda-packed2", "tm_infer_planes"
    entry = api.get_tuning(backend, eng.shape_key, device)
    s0 = eng.summary()
    ladder = [b for b in entry["bucket_sizes"] if b < 128] + [128] \
        if entry else None
    if (eng.backend.name != backend or entry is None
            or s0["buckets_tuned_for"] != backend
            or s0["kernel_tiles"] != entry["tiles"]
            or s0["bucket_sizes"] != ladder):
        raise AssertionError(f"{kind} engine does not report the committed "
                             f"entry: {s0} vs {entry}")
    fn, _ = kernel_pair(kernel)
    launches0 = fn.launches
    t0 = time.perf_counter()
    out = serve_all(eng, x)
    wall = time.perf_counter() - t0
    s = eng.summary()
    launches = fn.launches - launches0
    sums = np.stack([r.class_sums for r in out])
    if (len(out) != len(x) or s["fallback_dispatches"] != 0
            or launches != s["batches"]
            or not np.array_equal(sums, want.cpu().numpy())):
        raise AssertionError(f"tuned {kind} engine: {len(out)} served, "
                             f"{launches} launches for {s['batches']} "
                             "dispatches, or sums off the reference")
    emit({"phase": "tuning", "part": "c", "engine": kind, "backend": backend,
          "shape_key": s["shape_key"], "kernel_tiles": s["kernel_tiles"],
          "bucket_sizes": s["bucket_sizes"],
          "buckets_tuned_for": s["buckets_tuned_for"],
          "entry_device": entry["device_name"],
          "entry_power_limit_w": entry["power_limit_w"],
          "requests": len(out), "dispatches": s["batches"],
          "launches": launches, "fallback_dispatches": 0,
          "equals_reference": True, "requests_per_s": len(out) / wall,
          "mean_batch": s["mean_batch"],
          "padding_overhead": s["padding_overhead"]})


def tuning_tile_times(device):
    """(d) each fused kernel's device time at the committed tiles beside
    "auto" (no override), at B = 128 and the full widths, with
    ``time_ms`` (L2 flushed, enqueue behind a spin kernel): the analog
    kernels at R = 4 on D2D planes (the planes kernel also nominal, R = 1,
    as the sweep measured it), the TM kernels on each width's operands."""
    from repro_torch import api
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.kernels import autotune
    flush = torch.empty(256 * 2 ** 20 // 4, dtype=torch.float32,
                        device=device)
    rows = []

    def timed(backend, key, name, args, label, **extra):
        entry = api.get_tuning(backend, key, device)
        if entry is None:
            raise AssertionError(f"no committed entry {backend} @ {key}")
        fn, _ = kernel_pair(name)
        tiles = entry["tiles"]
        auto = time_ms(lambda: fn(*args), 20, flush)
        tuned = time_ms(lambda: fn(*args, tiles=tiles), 20, flush)
        rows.append({"backend": backend, "kernel": name, "width": label,
                     "shape_key": key, **extra, "tiles": tiles or "auto",
                     "tuned_ms": tuned, "auto_ms": auto,
                     "tuned_over_auto": tuned / auto,
                     "sweep_us": entry["tile_latency_by_state"]})

    widths = [("imbue-tm-mnist", tm_config(MODEL), SEED),
              ("kws", stream_config(KWS_TASK), SEED + 5),
              ("anomaly", stream_config(ANOMALY_TASK), SEED + 5)]
    for label, cfg, seed in widths:
        key = api.shape_bucket_key(cfg.n_clauses, cfg.n_literals)
        ta, x, _ = prototype_task(cfg, 128, seed)
        for r, dev in ((REPLICAS, True), (1, False)):
            timed("analog-cuda-packed2", key, "imbue_infer_planes",
                  planes_case(cfg, ta, x, r, dev, seed, device), label,
                  R=r, dev=dev)
        cases, _ = dense_case(cfg, ta, x, REPLICAS, True, seed, device)
        for backend, name in (("analog-cuda-packed", "imbue_infer_packed"),
                              ("analog-cuda", "imbue_infer")):
            timed(backend, key, name, cases[name], label, R=REPLICAS,
                  dev=True)
        del cases
    tm_sets = tm_widths(device) + stream_widths(device)
    for label, inc, comb, x in tm_sets:
        key = api.shape_bucket_key(*inc.shape)
        args, _ = tm_case(inc, x[:128], comb, device)
        family = ("coalesced" if label in ("coalesced", "kws-coalesced")
                  else "digital")
        for name in TM_KERNELS:
            backend = tm_backend(family, name)
            if backend is None:
                continue                   # no digital planes backend
            timed(backend, key, name,
                  args["dense" if name == "tm_infer" else "packed"], label)
    emit({"phase": "tuning", "part": "d", "B": 128,
          "clock": "cuda events, median of 20, L2 flushed, host enqueue "
                   "hidden behind a spin kernel",
          "rows": rows})
    return rows


def tuning_ladders(device, keep):
    """(e) the phase 3 (h) nominal KWS ``ensemble`` round on both engines,
    on the static ladder (a hand-picked ``BatcherConfig``, which the table
    never replaces) and on the tuned one (``for_max_batch``), in the order
    static, tuned, tuned, static; each ladder's medians are recorded
    only."""
    from repro_torch.serve import AsyncServeEngine, BatcherConfig, \
        ServeEngine
    from repro_torch.serve.batching import STATIC_BUCKETS
    static = BatcherConfig(max_batch=STREAM_BATCH,
                           bucket_sizes=tuple(b for b in STATIC_BUCKETS
                                              if b <= STREAM_BATCH))
    for cls in (ServeEngine, AsyncServeEngine):
        rows = {"ladder-static": [], "ladder-tuned": []}
        for label in ("ladder-static", "ladder-tuned", "ladder-tuned",
                      "ladder-static"):
            rows[label].append(stream_nominal_round(
                keep["kws"], keep["frames"], "ensemble", cls, device,
                batcher=static if label == "ladder-static" else None,
                label=label))
        emit({"phase": "tuning", "part": "e", "engine": cls.__name__,
              "order": "static, tuned, tuned, static", "medians": {
                  label: {key: statistics.median(r[key] for r in rs)
                          for key in ("decisions_per_s", "mean_batch",
                                      "padding_overhead",
                                      "session_p50_ms_median",
                                      "session_p99_ms_median")}
                  | {"bucket_sizes": rs[0]["bucket_sizes"]}
                  for label, rs in rows.items()}})


def phase_tuning(device, keep):
    """The tuning phase: (a) every tile exact, (b) the smoke sweep and one
    lazy measurement, (c) engines on the committed table, (d) tuned tiles
    against "auto", (e) the static ladder against the tuned one."""
    t0 = time.perf_counter()
    tuning_exactness(device)
    t_a = time.perf_counter()
    tuning_smoke_and_lazy(device)
    for kind in ("analog", "coalesced"):
        tuned_engine_round(kind, device)
    tuning_tile_times(device)
    tuning_ladders(device, keep)
    emit({"phase": "tuning", "exactness_s": t_a - t0,
          "wall_s": time.perf_counter() - t0})


def time_ms(fn, reps, flush):
    """Median device ms of ``fn`` over ``reps`` runs, CUDA events around
    each.  Before every run L2 is flushed and the card is held busy by a
    spin kernel (about 1 ms) while the host enqueues ``fn``, so the events
    time the device work alone, not the host's launch gaps."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def analog_launch_record(name, args, tiles=None):
    """Kernel ``name``'s launch on the wrapper's operands ``args`` (an
    analog kernel, all three on ``csrc/imbue_core.cuh``) with the tile
    override ``tiles``: its grid, block, shared memory, resident blocks an
    SM (``<name>_geometry``), the launched warps an SM (the grid's warps /
    SMs, capped by what is resident), and from one counted launch
    (``<name>_launch_counted``, outside every launch counter, held
    against ``<name>_ref``; it runs the kernel's own geometry) the share
    of (warp, row, column) steps the early exit skipped."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import imbue_infer as ii
    lib = ctypes.CDLL(str(_build.library_path(name)))
    info = (ctypes.c_int * 9)()
    steps_run = torch.zeros(1, dtype=torch.int64, device=args[0].device)
    stream = torch.cuda.current_stream().cuda_stream
    counted = getattr(lib, f"{name}_launch_counted")
    geometry = getattr(lib, f"{name}_geometry")
    if name == "imbue_infer_planes":
        litw, incw, dev, pol, scal = args
        (b, lw), (c, m) = litw.shape, pol.shape
        r = 1 if dev is None else dev.shape[0]
        err = geometry(r, b, c, lw, int(dev is not None),
                       *ii.analog_tiles(tiles, lw), info)
        counted.argtypes = ii._ARGTYPES[:-3] + [ctypes.c_void_p] * 2
        out = torch.zeros((r, b, m), dtype=torch.int32, device=litw.device)
        err = err or counted(
            litw.data_ptr(), incw.data_ptr(),
            None if dev is None else dev.data_ptr(), pol.data_ptr(),
            out.data_ptr(), r, b, lw, c, m, scal.l_valid, scal.i_ref,
            scal.v_read, scal.r_lrs, scal.r_hrs, scal.leak_inc,
            scal.leak_exc, scal.series_factor, steps_run.data_ptr(), stream)
    else:           # literal words (imbue_infer_packed) or bytes
        lits, g, leak, pol, i_ref, v_read = args
        (r, c, l), (b, m) = g.shape, (lits.shape[0], pol.shape[1])
        lw = -(-l // 32)
        err = geometry(r, b, c, l, *ii.analog_tiles(tiles, lw), info)
        counted.argtypes = ii._DENSE_ARGTYPES[:-3] + [ctypes.c_void_p] * 2
        out = torch.zeros((r, b, m), dtype=torch.int32, device=lits.device)
        err = err or counted(
            lits.data_ptr(), g.data_ptr(), leak.data_ptr(), pol.data_ptr(),
            out.data_ptr(), r, b, l, c, m, ii._f32(i_ref), ii._f32(v_read),
            steps_run.data_ptr(), stream)
    want = getattr(ii, f"{name}_ref")(*args)
    torch.cuda.synchronize()
    if err != 0 or not torch.equal(out, want):
        raise AssertionError(f"{name}: the counted launch failed ({err}) or "
                             "disagrees with the plain version")
    gx, gy, gz, threads, smem, per_sm, ks, ng, steps = list(info)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    warps = gx * gy * gz * threads // 32
    return {"grid": [gx, gy, gz], "threads": threads, "smem_bytes": smem,
            "blocks_per_sm": per_sm, "column_splits": ks,
            "row_groups": ng, "steps": steps,
            "warps_per_sm": min(warps / n_sm, per_sm * threads / 32),
            "skipped_share": 1.0 - int(steps_run) / (r * gy * b * lw)}


def fired_share(cfg, ta, x, device):
    """The share of (row, clause) pairs that fire in the digital TM."""
    from repro_torch.core import tm
    include = tm.include_mask(torch.from_numpy(ta).to(device), cfg)
    lits = tm.literals(torch.from_numpy(x).to(device))
    return float(tm.clause_outputs_from_include(include, lits).float()
                 .mean())


def phase_timing(device):
    """``imbue_infer_planes`` at R = 4 and R = 1 with the deviation plane
    (and the C2C pre-pass) and at R = 1 without it (nominal), B in
    BATCHES, at the tiles the analog path's engine launches (the committed
    entry's; "auto" timed beside them)."""
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core.variations import VariationConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.imbue_infer import (imbue_infer_planes,
                                                 imbue_infer_planes_ref)
    cfg = tm_config(MODEL)
    ta, x, _ = prototype_task(cfg, 128, SEED)
    flush = torch.empty(256 * 2 ** 20 // 4, dtype=torch.float32,
                        device=device)              # > 50 MB of L2
    vcfg = VariationConfig(csa_offset=False)
    tiles = main_path_tiles("analog-cuda-packed2", cfg.n_clauses,
                            cfg.n_literals, device)
    rows = []
    for r, with_dev in ((REPLICAS, True), (1, True), (1, False)):
        for b in BATCHES:
            args = planes_case(cfg, ta, x[:b], r, with_dev, SEED, device)
            ms, auto_ms = timed_at_tiles(imbue_infer_planes, args, tiles,
                                         flush)
            plain = time_ms(lambda: imbue_infer_planes_ref(*args), 3, flush)
            nbytes, nops = operand_bytes_and_ops(*args)
            bms, by = bound_ms(nbytes, [(nops, FP32_FLOP_PER_S)])
            row = {"R": r, "B": b, "dev": with_dev, "ms": ms,
                   "tiles": tile_label(tiles), "auto_ms": auto_ms,
                   "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                   "issue_floor_ms": issue_floor_ms(nops),
                   "bytes": nbytes, "fp32_ops": nops,
                   "bound_share": bms / ms,
                   "fired_frac": fired_share(cfg, ta, x[:b], device),
                   **analog_launch_record("imbue_infer_planes", args,
                                          tiles)}
            if with_dev:
                litw, incw, dev, _, _ = args
                gen = torch.Generator(device=device).manual_seed(SEED)
                row["c2c_prepass_ms"] = time_ms(
                    lambda: ops.c2c_deviation(gen, incw, dev, r, vcfg,
                                              cfg.n_literals),
                    10, flush)
            rows.append(row)
    emit({"phase": "timing", "kernel": "imbue_infer_planes",
          "clock": "cuda events, median, L2 flushed, host enqueue "
                   "hidden behind a spin kernel", "rows": rows})
    return rows


def phase_dense_timing(device):
    """The dense-plane analog kernels at R = 4, B in {8, 64, 128}, at the
    tiles the lower analog tiers' engines launch ("auto" beside them), with
    the eager conductance pre-pass and a partial library yardstick."""
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core import tm
    from repro_torch.core.imbue import (IMBUEConfig, conductances,
                                        program_replica_stack)
    from repro_torch.core.variations import VariationConfig
    cfg = tm_config(MODEL)
    ta, x, _ = prototype_task(cfg, 128, SEED)
    flush = torch.empty(256 * 2 ** 20 // 4, dtype=torch.float32,
                        device=device)              # > 50 MB of L2
    tiles = {name: main_path_tiles(backend, cfg.n_clauses, cfg.n_literals,
                                   device)
             for name, backend in (
                 ("imbue_infer_packed", "analog-cuda-packed"),
                 ("imbue_infer", "analog-cuda"))}
    rows = []
    for b in BATCHES:
        cases, fired = dense_case(cfg, ta, x[:b], REPLICAS, True, SEED,
                                  device)
        for name in DENSE_KERNELS:
            fn, ref = kernel_pair(name)
            args = cases[name]
            ms, auto_ms = timed_at_tiles(fn, args, tiles[name], flush)
            plain = time_ms(lambda: ref(*args), 3, flush)
            nbytes, nops = dense_bytes_and_ops(*args)
            bms, by = bound_ms(nbytes, [(nops, FP32_FLOP_PER_S)])
            # Partial yardstick: the two column-current products alone, as
            # cuBLAS runs them (TF32 off), without threshold, AND or votes.
            r, c, l = args[1].shape
            kw = -(-l // 32)
            pad = functools.partial(torch.nn.functional.pad,
                                    pad=(0, 32 * kw - l))
            lits = pad(cases["imbue_infer"][0].float())
            v_drive = ((1.0 - lits) * args[5]).view(b, kw, 32)
            lit1 = lits.view(b, kw, 32)
            g4 = pad(args[1]).view(r, c, kw, 32)
            leak4 = pad(args[2]).view(r, c, kw, 32)
            einsum_ms = time_ms(lambda: (
                torch.einsum("bkw,rckw->rbck", v_drive, g4),
                torch.einsum("bkw,rckw->rbck", lit1, leak4)), 10, flush)
            row = {"kernel": name, "R": r, "B": b, "ms": ms,
                   "tiles": tile_label(tiles[name]), "auto_ms": auto_ms,
                   "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                   "issue_floor_ms": issue_floor_ms(nops),
                   "bytes": nbytes, "fp32_ops": nops,
                   "bound_share": bms / ms, "fired_frac": fired,
                   "column_current_einsum_ms": einsum_ms,
                   **analog_launch_record(name, args, tiles[name])}
            rows.append(row)
    include = tm.include_mask(torch.from_numpy(ta).to(device), cfg)
    vcfg = VariationConfig(csa_offset=False)
    gen = torch.Generator(device=device).manual_seed(SEED)
    r_stack = program_replica_stack(include, gen, REPLICAS, vcfg)
    icfg = IMBUEConfig()
    prepass = {
        "conductances_ms": time_ms(
            lambda: conductances(r_stack, include, icfg), 10, flush),
        "conductances_c2c_ms": time_ms(
            lambda: conductances(r_stack, include, icfg, gen, vcfg), 10,
            flush)}
    emit({"phase": "timing", "kernels": list(DENSE_KERNELS),
          "clock": "cuda events, median, L2 flushed, host enqueue "
                   "hidden behind a spin kernel",
          "bound": "max(bytes / 3.35 TB/s, 4*R*B*C*L / 67 TFLOP/s)",
          "prepass_R4": prepass, "rows": rows})
    return rows


def phase_tm_timing(device):
    """The three TM kernels at both widths, B in BATCHES: device time at
    the tiles the width's engine launches ("auto" beside them), plain
    version, bound, the ``torch.matmul`` bracket of the violation
    product, the wrapper's ``[B, M]`` zero fill alone (inside every TM
    row's time), and the geometry and launched warps an SM of each (all
    three on ``csrc/tm_b1.cuh``); the timing clock's floor; then the host
    time of one backend call per coalesced tier."""
    from repro_torch import api
    from repro_torch.core import tm
    from repro_torch.kernels import ops
    flush = torch.empty(256 * 2 ** 20 // 4, dtype=torch.float32,
                        device=device)
    rows = []
    for label, inc, comb, x in tm_widths(device):
        for b in BATCHES:
            args, _ = tm_case(inc, x[:b], comb, device)
            # The bracket: torch.matmul of the violation product alone
            # (float32 on the unpacked operands, TF32 off), without the
            # threshold and the combine.
            lit0 = 1.0 - args["dense"][0].float()
            inc_f = args["dense"][1].float()
            bracket = time_ms(lambda: torch.matmul(lit0, inc_f.T), 20, flush)
            # Inside every TM row: the [B, M] zero fill the wrapper runs
            # before the kernel (its atomics add into it).
            m = int(comb.shape[1])
            fill = time_ms(lambda: torch.zeros((b, m), dtype=torch.int32,
                                               device=device), 20, flush)
            for name in TM_KERNELS:
                fn, ref = kernel_pair(name)
                a = args["dense" if name == "tm_infer" else "packed"]
                backend = tm_backend(label, name)
                tiles = ({} if backend is None else main_path_tiles(
                    backend, *inc.shape, device))
                ms, auto_ms = timed_at_tiles(fn, a, tiles, flush)
                plain = time_ms(lambda: ref(*a), 5, flush)
                nbytes, work = tm_bytes_and_work(name, a)
                bms, by = bound_ms(nbytes, work)
                row = {"kernel": name, "width": label,
                       "C": int(inc.shape[0]), "L": int(inc.shape[1]),
                       "B": b, "ms": ms, "tiles": tile_label(tiles),
                       "auto_ms": auto_ms, "plain_ms": plain, "bound_ms": bms,
                       "bound_by": by, "bytes": nbytes,
                       "ops": [ops for ops, _ in work],
                       "ops_per_s": [rate for _, rate in work],
                       "bound_share": bms / ms,
                       "violation_matmul_ms": bracket, "zero_fill_ms": fill}
                if name in B1_KERNELS:
                    row.update(b1_geometry(name, b, int(a[1].shape[0]),
                                           int(a[1].shape[1]), m,
                                           tiles=tiles))
                rows.append(row)
    emit({"phase": "timing", "kernels": list(TM_KERNELS),
          "clock": "cuda events, median, L2 flushed, host enqueue "
                   "hidden behind a spin kernel",
          # The clock's own floor: the events around no device work.
          "timing_floor_ms": time_ms(lambda: None, 20, flush),
          "bound": "max(bytes / 3.35 TB/s, sum of ops / rate); packed: "
                   "B*C*Lw word steps at the 32-bit logic rate (64 per "
                   "clock per SM); tm_infer: the violation product at "
                   "1979 TOP/s (int8); all three: the combine, 2*B*C*M at "
                   "67 T/s (32-bit)",
          "zero_fill": "the [B, M] fill runs before each of the three "
                       "kernels and is inside every row's ms",
          "rows": rows})
    # Host time of one backend call per coalesced tier at B = 128 (what a
    # dispatch costs once launch and host overhead are counted).
    ccfg = coalesced_config()
    ta, w, x, _ = coalesced_task(ccfg, 128, SEED + 1)
    base = api.CoalescedState(ta_state=torch.from_numpy(ta).to(device),
                              weights=torch.from_numpy(w).to(device),
                              cfg=ccfg)
    lits = tm.literals(torch.from_numpy(x).to(device))
    calls = []
    for backend, st, l_in in (
            ("coalesced-cuda-packed2", base.pack_planes(),
             ops.pack_literals(lits)),
            ("coalesced-cuda-packed", base.pack(), ops.pack_literals(lits)),
            ("coalesced-cuda", base, lits)):
        fn = api.get_backend(backend).fn
        fn(st, l_in)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn(st, l_in)
        torch.cuda.synchronize()
        calls.append({"backend": backend, "B": 128,
                      "host_ms_per_call": (time.perf_counter() - t0) * 10})
    emit({"phase": "timing", "backend_calls": calls,
          "clock": "host perf_counter over 100 calls, synchronised"})
    return rows


# ------------------------------------------------------- flash attention

def flash_inputs(row, seed, device):
    """``(q, k, v, tgt)`` ``[b, s, h, d]`` in the row's dtype, drawn with
    numpy from ``seed``; k and v drawn with ``kv`` heads and gathered up to
    ``h``."""
    rng = np.random.default_rng(seed)
    b, s, h, kv, d = (row[x] for x in ("b", "s", "h", "kv", "d"))
    dtype = getattr(torch, row["dtype"])

    def draw(heads):
        a = rng.standard_normal((b, s, heads, d), dtype=np.float32)
        return torch.from_numpy(a).to(device).to(dtype)
    idx = torch.arange(h, device=device) // (h // kv)
    q = draw(h)
    k, v = (draw(kv)[:, :, idx].contiguous() for _ in range(2))
    return q, k, v, draw(h)


def flash_opts(row):
    return dict(causal=row["causal"], window=row["window"],
                softcap=row["softcap"])


def flash_label(row):
    return {x: row[x] for x in ("arch", "b", "s", "h", "kv", "d", "causal",
                                "window", "softcap", "dtype")}


def flash_err(got, want):
    """The measures FLASH_TOL holds: ``max_rel`` (max|got - want| /
    max|want|), ``norm_rel`` (||got - want|| / ||want||), ``ulp_excess``
    (max(|got - want| - BF16_ULP |want|, 0) / max|want|), and ``max_abs``
    (max|got - want|)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    wmax = float(w.abs().max())
    return {"max_rel": float(diff.max()) / wmax,
            "norm_rel": float(torch.linalg.vector_norm(diff)
                              / torch.linalg.vector_norm(w)),
            "ulp_excess": float((diff - BF16_ULP * w.abs()).clamp_min(0)
                                .max()) / wmax,
            "max_abs": float(diff.max())}


def flash_plain(q, k, v, tgt, opts):
    """The plain versions on one input: ``o``, ``lse`` (valid rows), the
    ``dO`` of ``sum((o - tgt)^2)``, ``D`` and ``(dq, dk, dv)``."""
    from repro_torch.kernels import flash_attention as fa
    o, lse = fa.flash_fwd_plain(q, k, v, **opts)
    do = (2.0 * (o.float() - tgt.float())).to(q.dtype)
    dd = fa.row_dots(do, o)
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, dd, **opts)
    dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, dd, **opts)
    return o, lse, do, dd, (dq, dk, dv)


def nonzero_rows(g):
    """Share of the ``[b, s, h]`` rows of ``g`` with a non-zero entry."""
    return float((g.float().abs().amax(-1) > 0).float().mean())


def flash_check(row, seed, device):
    """Each flash kernel against its plain version on the same inputs, then
    ``flash_attention_trainable``'s ``o`` and gradients of ``sum((o -
    tgt)^2)`` against the plain ones, and ``flash_attention`` equal to the
    trainable forward.  Returns the row and each kernel's max abs error."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, tgt = flash_inputs(row, seed, device)
    opts = flash_opts(row)
    tol = FLASH_TOL[row["dtype"]]
    o_p, lse_p, do, dd, grads_p = flash_plain(q, k, v, tgt, opts)
    o, lse = fa.flash_fwd(q, k, v, **opts)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_p, dd, **opts)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_p, dd, **opts)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention_trainable(*leaves, **opts)
    ((out.float() - tgt.float()) ** 2).sum().backward()
    fwd_only = fa.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    # name -> (kernel, plain, FLASH_TOL key)
    pairs = {"o": (o, o_p, "o"), "lse": (lse, lse_p, "lse"),
             "dq": (dq, grads_p[0], "grad"), "dk": (dk, grads_p[1], "grad"),
             "dv": (dv, grads_p[2], "grad"),
             "trainable o": (out.detach(), o_p, "o")}
    pairs.update({f"trainable {n}": (t.grad, g, "trainable") for n, t, g in
                  zip(("dq", "dk", "dv"), leaves, grads_p)})
    err = {n: flash_err(got, want) for n, (got, want, _) in pairs.items()}
    rows = {n: nonzero_rows(t) for n, t in
            (("o", o), *zip(("dq", "dk", "dv"), (t.grad for t in leaves)))}
    result = {"phase": "kernels", "check": "flash", **flash_label(row),
              "err": err,
              "tolerance": {n: tol[key] for n, (_, _, key) in pairs.items()},
              "nonzero_rows": rows,
              "o_max_abs": float(o.float().abs().max()),
              "o_mean_abs": float(o.float().abs().mean()),
              "fwd_equals_trainable": torch.equal(fwd_only, out.detach())}
    emit(result)
    bad = [n for n, (_, _, key) in pairs.items()
           if not err[n][tol[key][0]] <= tol[key][1]]
    if bad:
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions ({bad}): {result}")
    if (result["o_max_abs"] == 0.0
            or not bool(torch.isfinite(lse).all())
            or min(rows.values()) < 0.99
            or not result["fwd_equals_trainable"]):
        raise AssertionError(f"flash check vacuous or inconsistent: "
                             f"{result}")
    return {"flash_fwd": max(err["o"]["max_abs"], err["lse"]["max_abs"]),
            "flash_bwd_dkv": max(err["dk"]["max_abs"], err["dv"]["max_abs"]),
            "flash_bwd_dq": err["dq"]["max_abs"]}


def phase_flash_kernels(device):
    """The flash kernels against their plain versions at the three model
    rows and the float32 edge cases; returns each kernel's max abs
    error."""
    max_err = dict.fromkeys(FLASH_KERNELS, 0.0)
    rows = [*FLASH_ROWS.values(), *FLASH_SMALL]
    for i, row in enumerate(rows):
        for name, e in flash_check(row, SEED + 900 + i, device).items():
            max_err[name] = max(max_err[name], e)
        torch.cuda.empty_cache()
    return max_err


def phase_flash_path(device):
    """``flash_attention_trainable`` forward and backward FLASH_PATH_STEPS
    times at the main row (one launch of each kernel a step), then
    ``flash_attention`` once (the forward kernel alone); returns the
    launches of the training steps."""
    from repro_torch.kernels import flash_attention as fa
    row = FLASH_ROWS["main"]
    q, k, v, tgt = flash_inputs(row, SEED + 950, device)
    opts = flash_opts(row)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    losses = []

    def drive():
        for _ in range(FLASH_PATH_STEPS):
            for t in leaves:
                t.grad = None
            out = fa.flash_attention_trainable(*leaves, **opts)
            loss = ((out.float() - tgt.float()) ** 2).sum()
            loss.backward()
            losses.append(float(loss.detach()))
    counts = path_launches(drive, FLASH_KERNELS)
    if counts != dict.fromkeys(FLASH_KERNELS, FLASH_PATH_STEPS) or not all(
            bool(torch.isfinite(t.grad).all()) for t in leaves):
        raise AssertionError(f"flash training path: launches {counts}")
    fns = [kernel_pair(name)[0] for name in FLASH_KERNELS]
    for fn in fns:
        fn.launches = 0
    o = fa.flash_attention(q, k, v, **opts)
    infer = {name: fn.launches for name, fn in zip(FLASH_KERNELS, fns)}
    if infer != {"flash_fwd": 1, "flash_bwd_dkv": 0, "flash_bwd_dq": 0} \
            or not bool(torch.isfinite(o).all()):
        raise AssertionError(f"flash_attention path: launches {infer}")
    emit({"phase": "flash_path", **flash_label(row),
          "driver": "flash_attention_trainable forward + backward",
          "steps": FLASH_PATH_STEPS, "losses": losses, "launches": counts,
          "flash_attention_launches": infer})
    return counts


def visible_pairs(row):
    """The (query, key) pairs the masks keep, over every head."""
    s, window = row["s"], row["window"]
    q = np.arange(s)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(s, np.int64)
    hi = q + 1 if row["causal"] else np.full(s, s)
    return row["b"] * row["h"] * int(np.maximum(hi - lo, 0).sum())


def sfu_per_s():
    """The card's exp / tanh rate: 16 per clock per SM, like POPC."""
    return popc_per_s() * SFU_PER_CLOCK_PER_SM / POPC_PER_CLOCK_PER_SM


def flash_bound(name, row, pairs):
    """``(bound_ms, by, terms)``: the largest of bytes (each input read
    once, each output written once) at 3.35 TB/s, the matmul FLOPs (2, 4
    and 3 products of 2 * d a visible pair for the forward, dK / dV and dQ)
    at the dense tensor rate of the row's dtype, and the exp (and softcap
    tanh) count at the SFU rate."""
    b, s, h, d = row["b"], row["s"], row["h"], row["d"]
    esize = 2 if row["dtype"] == "bfloat16" else 4
    t = b * s * h * d * esize                       # one [b, s, h, d] tensor
    stats = b * h * s * 4                           # one [b * h, s] f32
    nbytes, products = {"flash_fwd": (4 * t + stats, 2),
                        "flash_bwd_dkv": (6 * t + 2 * stats, 4),
                        "flash_bwd_dq": (5 * t + 2 * stats, 3)}[name]
    rate = BF16_FLOP_PER_S if esize == 2 else FP32_FLOP_PER_S
    sfu = pairs * (2 if row["softcap"] else 1)
    terms = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "matmul_ms": products * 2 * d * pairs / rate * 1e3,
             "sfu_ms": sfu / sfu_per_s() * 1e3}
    bms = max(terms.values())
    return bms, ("bytes" if bms == terms["bytes_ms"] else "operations"), \
        {**terms, "bytes": nbytes, "flop": products * 2 * d * pairs,
         "sfu_ops": sfu}


def sdpa_backends(fn):
    """The ``aten`` SDPA ops one call of ``fn`` ran (which backend)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted({e.key for e in prof.key_averages()
                   if "scaled_dot_product" in e.key
                   and e.key != "aten::scaled_dot_product_attention"})


def sdpa_times(q, k, v, do, causal, flush):
    """``torch.nn.functional.scaled_dot_product_attention`` on the
    ``[b, h, s, d]`` transposes: the forward alone, the backward alone
    (dQ, dK and dV in one call) and both, and the backends they ran."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return sdpa(qt, kt, vt, is_causal=causal)
    with torch.no_grad():
        fwd_ms = time_ms(fwd, 10, flush)
        fwd_backend = sdpa_backends(fwd)
    out = fwd()
    bwd_ms = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 10, flush)
    both_ms = time_ms(lambda: torch.autograd.grad(fwd(), (qt, kt, vt), dot),
                      10, flush)
    return {"sdpa_fwd_ms": fwd_ms, "sdpa_bwd_ms": bwd_ms,
            "sdpa_fwd_bwd_ms": both_ms, "sdpa_fwd_backend": fwd_backend,
            "sdpa_train_backend": sdpa_backends(lambda: torch.autograd.grad(
                fwd(), (qt, kt, vt), dot))}


def phase_flash_timing(device):
    """On each bf16 model row: each flash kernel's device time, its plain
    version's, its bound, and the library call (SDPA; none takes a
    softcap, so the local row has none); the port's trainable forward +
    backward beside SDPA's.  Returns the rows."""
    from repro_torch.kernels import flash_attention as fa
    flush = torch.empty(256 * 2 ** 20 // 4, dtype=torch.float32,
                        device=device)
    rows = []
    for label, row in FLASH_ROWS.items():
        q, k, v, tgt = flash_inputs(row, SEED + 980, device)
        opts = flash_opts(row)
        o, lse, do, dd, _ = flash_plain(q, k, v, tgt, opts)
        pairs = visible_pairs(row)
        calls = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **opts),
                          lambda: fa.flash_fwd_plain(q, k, v, **opts)),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse, dd, **opts),
                lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, dd,
                                               **opts)),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq(q, k, v, do, lse, dd, **opts),
                lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, dd, **opts))}
        lib = (None if row["softcap"]
               else sdpa_times(q, k, v, do, row["causal"], flush))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        port_ms = time_ms(lambda: torch.autograd.grad(
            fa.flash_attention_trainable(*leaves, **opts), leaves, do), 5,
            flush)
        for name, (kernel, plain) in calls.items():
            bms, by, terms = flash_bound(name, row, pairs)
            ms = time_ms(kernel, 10, flush)
            library = None
            if lib is not None:
                library = lib["sdpa_fwd_ms" if name == "flash_fwd"
                              else "sdpa_bwd_ms"]
            rows.append({"kernel": name, "row": label, **flash_label(row),
                         "pairs": pairs, "ms": ms,
                         "plain_ms": time_ms(plain, 3, flush),
                         "bound_ms": bms, "bound_by": by, **terms,
                         "bound_share": bms / ms, "library_ms": library,
                         "split_matmul_ms": (terms["matmul_ms"]
                                             * SPLIT_PRODUCTS[name]
                                             if name in SPLIT_PRODUCTS
                                             and row["dtype"] == "bfloat16"
                                             else None)})
        # The backward pair against SDPA's one backward call in this run:
        # a ratio that compares across cards and power limits.
        pair_ms = sum(r["ms"] for r in rows[-2:])
        emit({"phase": "timing", "kernels": list(FLASH_KERNELS),
              "row": label, **flash_label(row),
              "bwd_pair_ms": pair_ms,
              "bwd_pair_over_sdpa_bwd": (None if lib is None
                                         else pair_ms / lib["sdpa_bwd_ms"]),
              "clock": "cuda events, median, L2 flushed, host enqueue "
                       "hidden behind a spin kernel",
              "bound": "max(bytes / 3.35 TB/s, matmul FLOPs / dense "
                       "tensor rate, exp (+ tanh) / SFU rate)",
              "rows": rows[-3:], "port_fwd_bwd_ms": port_ms,
              "library": lib if lib is not None else
              "null: no SDPA call takes a softcap"})
        del q, k, v, tgt, o, lse, do, dd, leaves, calls
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- models

def model_batch(cfg, b, s, seed, device):
    """Tokens (+ the VLM / audio stubs' inputs) drawn with numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, s)))}
    if cfg.vision_tokens:
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32))
    if cfg.is_encoder_decoder:
        batch["audio_frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return {k: v.to(device) for k, v in batch.items()}


def float32_config(cfg):
    """``cfg`` at float32 compute, MoE at capacity factor E / K (a whole
    sequence then drops no token that decode keeps)."""
    import dataclasses
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def held(got, want, tol, what):
    """``max |got - want|``; fails unless every value is finite and within
    rtol = atol = ``tol``."""
    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max())
    if not (bool(torch.isfinite(got).all())
            and torch.allclose(got, want, rtol=tol, atol=tol)):
        raise AssertionError(f"models {what}: max |err| {err} past {tol}")
    return err


def decode_against_forward(model, cfg, b, s, seed, device):
    """``(decode logits [b, s, V], forward logits)``: token-by-token
    ``decode_step`` from an empty cache (whisper's cross caches filled
    from its encoder first) beside one forward, and the seconds of each."""
    from repro_torch.models import transformer as tf
    batch = model_batch(cfg, b, s, seed, device)
    t0 = time.perf_counter()
    want, aux = tf.forward(model, batch, cfg, return_aux=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if float(aux.get("moe_drop_frac", 0.0)):
        raise AssertionError(f"models {cfg.name}: the forward dropped "
                             f"{float(aux['moe_drop_frac'])} of its slots")
    state = tf.init_decode_state(cfg, b, s, dtype=torch.float32,
                                 device=device)
    if cfg.is_encoder_decoder:
        state = tf.fill_cross_cache(model, state, batch, cfg)
    outs = []
    for t in range(s):
        logits, state = tf.decode_step(model, state,
                                       batch["tokens"][:, t:t + 1], t, cfg)
        outs.append(logits[:, 0])
    got = torch.stack(outs, 1)
    torch.cuda.synchronize()
    return got, want, t1 - t0, time.perf_counter() - t1


def release_card():
    """Return the memory of the tensors just dropped to the card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def events_ms(fn, reps):
    """Median ms of ``fn`` over ``reps`` runs after one warm-up, CUDA
    events around each run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nudged(model, device):
    """A copy of ``model`` with every weight scaled by 1 + MODEL_NUDGE x a
    normal draw (seed ``SEED``): float32 rounding of its inputs."""
    import copy
    out = copy.deepcopy(model)
    gen = torch.Generator(device).manual_seed(SEED)
    with torch.no_grad():
        for p in out.parameters():
            p.mul_(1 + MODEL_NUDGE * torch.randn(
                p.shape, generator=gen, device=device, dtype=p.dtype))
    return out


def models_card_vs_host(arch, host, card, cfg, device):
    """float32 forward on the card against the same weights on the host at
    ``MODEL_HOST_SHAPE``; the gap with TF32 allowed and the rounding floor
    (``MODEL_NUDGE``) are read beside it (not held)."""
    from repro_torch.models import transformer as tf
    b, s = MODEL_HOST_SHAPE
    batch = model_batch(cfg, b, s, SEED + 7, "cpu")
    t0 = time.perf_counter()
    want = tf.forward(host, batch, cfg)
    host_s = time.perf_counter() - t0
    on_card = {k: v.to(device) for k, v in batch.items()}
    got = tf.forward(card, on_card, cfg)
    tol = MODEL_HOST_TOL[arch]
    err = held(got, want, tol, f"{arch} card vs host")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = tf.forward(card, on_card, cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    floor = float((tf.forward(nudged(card, device), on_card, cfg) - got)
                  .abs().max())
    emit({"phase": "models", "check": "card_vs_host", "arch": arch,
          "shape": [b, s], "dtype": "float32", "max_abs_err": err,
          "max_abs_logit": float(want.abs().max()), "tol": tol,
          "tf32_max_abs_err": float((tf32.cpu() - want).abs().max()),
          "rounding_floor": floor, "nudge": MODEL_NUDGE,
          "host_forward_s": host_s, "card": nvidia_smi_line()})


def models_blocked(model, cfg, device):
    """qwen2-0.5b at S = 8192: ``_blocked_causal`` (its published
    threshold) against ``_sdpa`` (threshold raised) on one float32
    input, the final hidden states and the last position's logits."""
    import dataclasses

    from repro_torch.models import transformer as tf
    assert cfg.blocked_attn_threshold <= MODEL_BLOCKED_SHAPE[1]
    plain = dataclasses.replace(cfg, blocked_attn_threshold=1 << 30)
    batch = model_batch(cfg, *MODEL_BLOCKED_SHAPE, SEED + 8, device)
    out = {}
    for name, c in (("blocked", cfg), ("sdpa", plain)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            hidden, _ = tf.forward_hidden(model, batch, c)
            logits = tf.forward(model, batch, c, last_only=True)
        torch.cuda.synchronize()
        out[name] = (hidden, logits, time.perf_counter() - t0)
    err = held(out["blocked"][0], out["sdpa"][0], MODEL_BLOCKED_TOL,
               "blocked vs sdpa hidden")
    lerr = held(out["blocked"][1], out["sdpa"][1], MODEL_BLOCKED_TOL,
                "blocked vs sdpa logits")
    emit({"phase": "models", "check": "blocked_attention",
          "arch": MODEL_BF16["arch"], "shape": list(MODEL_BLOCKED_SHAPE),
          "dtype": "float32", "chunks": [cfg.attn_chunk_q, cfg.attn_chunk_k],
          "hidden_max_abs_err": err, "logits_max_abs_err": lerr,
          "tol": MODEL_BLOCKED_TOL, "blocked_s": out["blocked"][2],
          "sdpa_s": out["sdpa"][2], "card": nvidia_smi_line()})


def models_bf16(model, cfg, device):
    """Readings at the published compute dtype (bf16): prefill tokens/s
    and decode ms a step, CUDA events (recorded, not claimed)."""
    from repro_torch.models import transformer as tf
    r = MODEL_BF16
    b = r["batch"]
    batch = model_batch(cfg, b, r["prefill"], SEED + 9, device)
    prefill_ms = events_ms(
        lambda: tf.forward(model, batch, cfg, last_only=True), r["reps"])
    state = tf.init_decode_state(cfg, b, r["cache"], dtype=torch.bfloat16,
                                 device=device)
    tokens = batch["tokens"]
    pos = 0

    def steps(n):
        nonlocal state, pos
        for _ in range(n):
            _, state = tf.decode_step(model, state,
                                      tokens[:, pos:pos + 1], pos, cfg)
            pos += 1

    steps(r["warmup_steps"])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    steps(r["steps"])
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / r["steps"]
    emit({"phase": "models", "check": "bf16_readings", "arch": r["arch"],
          "compute_dtype": cfg.compute_dtype,
          "param_dtype": cfg.param_dtype,
          "prefill": {"batch": b, "seq": r["prefill"], "last_only": True,
                      "ms": prefill_ms,
                      "tokens_per_s": b * r["prefill"] / prefill_ms * 1e3},
          "decode": {"batch": b, "cache_slots": r["cache"],
                     "steps": r["steps"], "ms_per_step": step_ms,
                     "tokens_per_s": b / step_ms * 1e3},
          "card": nvidia_smi_line()})


def models_full_width(device):
    """The six archs at their published widths on the card."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    for arch in MODEL_ARCHS:
        t0 = time.perf_counter()
        reduced = MODEL_OVERRIDES.get(arch)
        published = get_config(arch)
        cfg = dataclasses.replace(published, **(reduced or {}))
        f32 = float32_config(cfg)
        if arch in MODEL_HOST_ARCHS:
            host = tf.init_params(torch.Generator().manual_seed(SEED), cfg,
                                  "cpu")
            model = copy.deepcopy(host).to(device)
            models_card_vs_host(arch, host, model, f32, device)
            del host
        else:
            model = tf.init_params(
                torch.Generator(device).manual_seed(SEED), cfg, device)
        n_params = sum(p.numel() for p in model.parameters())
        got, want, fwd_s, dec_s = decode_against_forward(
            model, f32, *MODEL_DECODE, SEED + 10, device)
        err = held(got, want, MODEL_DECODE_TOL, f"{arch} decode vs forward")
        emit({"phase": "models", "check": "decode_vs_forward", "arch": arch,
              "params": n_params, "param_dtype": cfg.param_dtype,
              "compute_dtype": f32.compute_dtype,
              "reduced": ({"published": {k: getattr(published, k)
                                         for k in reduced},
                           "run": reduced} if reduced else None),
              "batch": MODEL_DECODE[0], "positions": MODEL_DECODE[1],
              "max_abs_err": err, "max_abs_logit": float(want.abs().max()),
              "tol": MODEL_DECODE_TOL, "forward_s": fwd_s,
              "decode_s": dec_s,
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "wall_s": time.perf_counter() - t0, "card": nvidia_smi_line()})
        del got, want
        release_card()
        if arch == MODEL_BF16["arch"]:
            models_blocked(model, f32, device)
            release_card()
            models_bf16(model, cfg, device)
        del model
        release_card()
        torch.cuda.reset_peak_memory_stats()


def models_smoke(device):
    """Every arch's ``smoke()`` on the card against the host (the same
    weights), decode against forward for the reference's six."""
    import copy

    from repro_torch.configs import get_config, list_archs, smoke
    from repro_torch.models import transformer as tf
    rows = []
    for arch in list_archs():
        cfg = smoke(get_config(arch))
        host = tf.init_params(torch.Generator().manual_seed(SEED), cfg,
                              "cpu")
        card = copy.deepcopy(host).to(device)
        batch = model_batch(cfg, 2, 64, SEED + 11, "cpu")
        # One intra-op thread: these host ops are tiny, and more threads
        # only add wake-up cost.
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            want, want_aux = tf.forward(host, batch, cfg, return_aux=True)
        finally:
            torch.set_num_threads(threads)
        got, aux = tf.forward(card, {k: v.to(device)
                                     for k, v in batch.items()}, cfg,
                              return_aux=True)
        if tuple(got.shape) != (2, 64, cfg.vocab_size):
            raise AssertionError(f"models smoke {arch}: {tuple(got.shape)}")
        row = {"arch": arch, "card_vs_host": held(
            got, want, MODEL_SMOKE_TOL, f"smoke {arch} card vs host")}
        for k in want_aux:
            held(aux[k].reshape(1), want_aux[k].reshape(1), MODEL_SMOKE_TOL,
                 f"smoke {arch} {k}")
        if arch in MODEL_SMOKE_DECODE_ARCHS:
            d, f, _, _ = decode_against_forward(
                card, float32_config(cfg), *MODEL_SMOKE_DECODE, SEED + 12,
                device)
            row["decode_vs_forward"] = held(d, f, MODEL_SMOKE_TOL,
                                            f"smoke {arch} decode")
        rows.append(row)
        del card, host
        release_card()
    emit({"phase": "models", "check": "smoke", "archs": len(rows),
          "tol": MODEL_SMOKE_TOL, "rows": rows, "card": nvidia_smi_line()})


def models_pipeline(device):
    """The GPipe demo on ``PIPELINE_RANKS`` ranks sharing the card over
    gloo, under ``torch.distributed.run``: pipelined equal to
    sequential."""
    import os
    args = [] if device.type == "cuda" else ["--device", str(device)]
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(PIPELINE_RANKS), "-m",
         "repro_torch.distributed.pipeline", *args], capture_output=True,
        text=True, timeout=MESH_TIMEOUT_S,
        env={**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent
                                             / "src")})
    if run.returncode:
        errors = [ln for ln in run.stderr.splitlines() if "Error" in ln]
        raise AssertionError(f"models pipeline: exited {run.returncode}: "
                             + "\n".join(errors[:20]) + "\n"
                             + run.stderr[-2000:])
    line = json.loads([ln for ln in run.stdout.splitlines()
                       if ln.startswith("{")][-1])
    if not line["equal_to_sequential"] or line["stages"] != PIPELINE_RANKS:
        raise AssertionError(f"models pipeline: {line}")
    emit({"phase": "models", "check": "pipeline",
          "launcher": "torch.distributed.run", "transport": "gloo",
          **line, "launch_wall_s": time.perf_counter() - t0,
          "card": nvidia_smi_line()})


def phase_models(device):
    """Phase 3 (k), the models path: the full-width archs, the smoke
    reductions and the GPipe demo.  It launches none of the hand-written
    kernels (the models' products are plain matrix products, as the
    reference's); returns their counts, read around the path, which must
    all be 0."""
    fns = {name: kernel_pair(name)[0] for name in KERNELS}
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    models_full_width(device)
    models_smoke(device)
    models_pipeline(device)
    counts = {name: fn.launches for name, fn in fns.items()}
    if any(counts.values()):
        raise AssertionError(f"models path launched kernels: {counts}")
    emit({"phase": "models", "round": "total",
          "wall_s": time.perf_counter() - t0})
    return counts


# -------------------------------------------------------------- lm_train

def lm_grads(model, batch, cfg):
    """``(loss, {name: gradient})`` of ``loss_fn`` by autograd."""
    from repro_torch.models import transformer as tf
    loss, _ = tf.loss_fn(model, batch, cfg)
    named = list(model.named_parameters())
    gs = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(named, gs)}


def grad_gap(got, want):
    """``(max |got - want| over every leaf, max |want|)``, on the host."""
    err = max(float((got[n].float().cpu() - want[n].float().cpu()).abs()
                    .max()) for n in want)
    return err, max(float(want[n].abs().max()) for n in want)


def lm_card_vs_host(device):
    """(a): one AdamW step of ``LM_HOST_ARCH`` at full width, float32, on
    the card against the host from the same weights; then remat on
    against off on the card with each one's peak memory."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
    cfg = float32_config(get_config(LM_HOST_ARCH))
    host = tf.init_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    card = copy.deepcopy(host).to(device)
    batch = model_batch(cfg, *LM_HOST_SHAPE, SEED + 20, "cpu")
    t0 = time.perf_counter()
    want_loss, want = lm_grads(host, batch, cfg)
    host_s = time.perf_counter() - t0
    got_loss, got = lm_grads(card, {k: v.to(device) for k, v in
                                    batch.items()}, cfg)
    err, g_max = grad_gap(got, want)
    loss_err = abs(float(got_loss) - float(want_loss))
    for model, grads in ((host, want), (card, got)):
        make_optimizer(model, OptimizerConfig(lr=LM_HOST_LR)).step(0, grads)
    del got, want
    p_err, past = 0.0, 0
    card_p = dict(card.named_parameters())
    for n, p in host.named_parameters():
        d = (card_p[n].detach().cpu() - p.detach()).abs()
        p_err = max(p_err, float(d.max()))
        past += int((d > 1e-6).sum())
    n_params = sum(p.numel() for p in host.parameters())
    ok = (loss_err <= LM_HOST_TOL["loss"] * abs(float(want_loss))
          and err <= LM_HOST_TOL["grad"] * g_max
          and p_err <= 2 * LM_HOST_LR)
    row = {"phase": "lm_train", "check": "card_vs_host",
           "arch": LM_HOST_ARCH, "shape": list(LM_HOST_SHAPE),
           "dtype": "float32", "remat": cfg.remat, "params": n_params,
           "loss": float(want_loss), "loss_abs_err": loss_err,
           "grad_max_abs_err": err, "grad_max_abs": g_max,
           "grad_rel_err": err / g_max, "tol": LM_HOST_TOL,
           "lr": LM_HOST_LR, "param_max_abs_err": p_err,
           "param_bound": 2 * LM_HOST_LR, "params_past_1e-6": past,
           "host_fwd_bwd_s": host_s, "card": nvidia_smi_line()}
    emit(row)
    if not ok:
        raise AssertionError(f"lm_train card vs host: {row}")
    del host
    release_card()
    # remat on against off, on the card, at LM_REMAT_SHAPE
    batch = model_batch(cfg, *LM_REMAT_SHAPE, SEED + 21, device)
    out = {}
    for remat in (True, False):
        # peaks are read over what the card holds before each pass (the
        # weights, and after the first pass its gradients)
        c = dataclasses.replace(cfg, remat=remat)
        release_card()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, grads = lm_grads(card, batch, c)
        torch.cuda.synchronize()
        out[remat] = (loss, grads, time.perf_counter() - t0,
                      torch.cuda.max_memory_allocated(),
                      torch.cuda.max_memory_allocated() - base)
    err, g_max = grad_gap(out[True][1], out[False][1])
    row = {"phase": "lm_train", "check": "remat", "arch": LM_HOST_ARCH,
           "shape": list(LM_REMAT_SHAPE), "dtype": "float32",
           "loss_equal": bool(torch.equal(out[True][0], out[False][0])),
           "grad_max_abs_err": err, "grad_max_abs": g_max,
           "tol": LM_REMAT_TOL,
           "peak_gib": {"remat": out[True][3] / 2 ** 30,
                        "no_remat": out[False][3] / 2 ** 30},
           "peak_over_weights_gib": {"remat": out[True][4] / 2 ** 30,
                                     "no_remat": out[False][4] / 2 ** 30},
           "fwd_bwd_s": {"remat": out[True][2], "no_remat": out[False][2]},
           "card": nvidia_smi_line()}
    emit(row)
    if err > LM_REMAT_TOL * g_max or not out[True][4] < out[False][4]:
        raise AssertionError(f"lm_train remat: {row}")
    del out, card
    release_card()


def lm_trainer(argv, device):
    """``launch.train.main(argv)`` on ``device`` in this process, its
    standard output kept: ``(TrainRun, log, peak bytes)``."""
    from repro_torch.launch import train as train_cli
    release_card()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = train_cli.main(list(argv) + ["--device", device.type])
    peak = torch.cuda.max_memory_allocated()
    return run, buf.getvalue(), peak


def lm_run_row(label, argv, run, log, peak):
    """A run's JSON line; fails unless every loss is finite and the last
    is below the first."""
    steps = sorted(run.losses)
    losses = [run.losses[s] for s in steps]
    later = [run.step_s[s] for s in steps[1:]] or [run.step_s[steps[0]]]
    ms = statistics.median(later) * 1e3
    row = {"phase": "lm_train", "check": "trainer", "run": label,
           "argv": list(argv), "params": sum(
               p.numel() for p in run.model.parameters()),
           "compute_dtype": run.cfg.compute_dtype,
           "param_dtype": run.cfg.param_dtype, "remat": run.cfg.remat,
           "start_step": run.start_step, "losses": losses,
           "first_step_ms": run.step_s[steps[0]] * 1e3, "ms_per_step": ms,
           "tokens_per_s": run.tokens_per_step / ms * 1e3,
           "peak_gib": peak / 2 ** 30,
           "log_lines": sum(ln.startswith("[train] step")
                            for ln in log.splitlines()),
           "card": nvidia_smi_line()}
    emit(row)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"lm_train {label}: losses {losses}")
    return row


def lm_step_profile(run, label, device):
    """One more train step of a finished ``TrainRun`` (its next synthetic
    batch) under ``torch.profiler``: host ms, device ms (the kernels'
    time), the device's idle share, kernel launches and the five kernels
    that take the most device time (recorded, not held)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.train.train_step import make_train_step
    step_idx = max(run.losses) + 1
    args = run.batch_shape
    batch = {k: torch.from_numpy(v.astype(np.int64) if k == "tokens"
                                 else v).to(device)
             for k, v in synth_batch(run.cfg, DataConfig(), step_idx,
                                     *args).items()}
    step = make_train_step(run.cfg, run.optimizer)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(run.model, step_idx, batch)["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    # A named range (the optimizer's step) also shows on the device's
    # timeline as a span over its kernels: read it apart, not as work.
    spans = [e for e in cuda if getattr(e, "is_user_annotation", False)
             or e.key.startswith(("Optimizer.", "ProfilerStep"))]
    kernels = [e for e in cuda if e not in spans]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    emit({"phase": "lm_train", "check": "step_profile", "run": label,
          "batch": list(args), "host_ms": wall * 1e3,
          "device_ms": device_ms,
          "device_idle_share": 1.0 - device_ms / (wall * 1e3),
          "kernel_launches": sum(e.count for e in kernels),
          "spans_ms": {e.key: e.device_time_total / 1e3 for e in spans},
          "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3]
                             for e in top],
          "card": nvidia_smi_line()})


def lm_full_width(device):
    """(b): the trainer at full width; xlstm-125m's resume cycle."""
    import shutil
    import tempfile
    for label, args in LM_TRAIN_RUNS:
        argv = ("--full", "--log-every", "1", "--lr", LM_TRAIN_LR) + args
        run, log, peak = lm_trainer(argv, device)
        lm_run_row(label, argv, run, log, peak)
        if label == LM_PROFILE_RUN:
            lm_step_profile(run, label, device)
        del run
    r = LM_RESUME
    ckpt_dir = tempfile.mkdtemp(prefix="lm_resume-")
    try:
        base = ("--full", "--arch", r["arch"], "--lr", LM_TRAIN_LR,
                "--ckpt-dir", ckpt_dir, "--ckpt-every", str(r["every"]),
                "--log-every", "1")
        t0 = time.perf_counter()
        first, log1, peak1 = lm_trainer(base + ("--steps", str(r["first"])),
                                        device)
        lm_run_row(f"{r['arch']} steps 0-{r['first'] - 1}",
                   base + ("--steps", str(r["first"])), first, log1, peak1)
        del first
        again, log2, peak2 = lm_trainer(base + ("--steps", str(r["total"])),
                                        device)
        lm_run_row(f"{r['arch']} resumed", base + ("--steps",
                                                   str(r["total"])),
                   again, log2, peak2)
        cycle_s = time.perf_counter() - t0
        argv = ("--full", "--arch", r["arch"], "--lr", LM_TRAIN_LR,
                "--log-every", "1", "--steps", str(r["total"]))
        straight, log3, peak3 = lm_trainer(argv, device)
        lm_run_row(f"{r['arch']} uninterrupted", argv, straight, log3, peak3)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    steps = range(r["first"], r["total"])
    gaps = [abs(again.losses[s] - straight.losses[s]) for s in steps]
    row = {"phase": "lm_train", "check": "resume", "arch": r["arch"],
           "resumed_line": f"[train] resumed from step {r['first']}" in log2,
           "start_step": again.start_step,
           "resumed_losses": [again.losses[s] for s in steps],
           "uninterrupted_losses": [straight.losses[s] for s in steps],
           "max_abs_gap": max(gaps), "tol": LM_RESUME_TOL,
           "bitwise_equal": all(g == 0.0 for g in gaps),
           "cycle_wall_s": cycle_s, "card": nvidia_smi_line()}
    emit(row)
    if not (row["resumed_line"] and again.start_step == r["first"]
            and max(gaps) <= LM_RESUME_TOL):
        raise AssertionError(f"lm_train resume: {row}")
    del again, straight
    release_card()


def lm_smoke(device):
    """(c): every ``smoke()`` arch trains on the card; its first loss
    equals the host's from the same weights."""
    import copy

    from repro_torch.configs import get_config, list_archs, smoke
    from repro_torch.models import transformer as tf
    from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
    from repro_torch.train.train_step import make_train_step
    r = LM_SMOKE
    rows = []
    for arch in list_archs():
        cfg = smoke(get_config(arch))
        host = tf.init_params(torch.Generator().manual_seed(SEED), cfg,
                              "cpu")
        card = copy.deepcopy(host).to(device)
        start = {n: p.detach().clone() for n, p in card.named_parameters()}
        batch = model_batch(cfg, r["batch"], r["seq"], SEED + 22, "cpu")
        out = {}
        t0 = time.perf_counter()
        for side, model, b in (("card", card, {k: v.to(device) for k, v in
                                                batch.items()}),
                               ("host", host, batch)):
            threads = torch.get_num_threads()
            if side == "host":
                torch.set_num_threads(1)
            try:
                opt = make_optimizer(model, OptimizerConfig(lr=r["lr"]))
                step = make_train_step(cfg, opt)
                losses = []
                for i in range(r["steps"]):
                    losses.append(float(step(model, i, b)["ce_loss"]))
                    if i == 0 and side == "card":
                        moved = min(float((p.detach() - start[n]).abs()
                                          .max()) for n, p in
                                    model.named_parameters())
            finally:
                torch.set_num_threads(threads)
            out[side] = losses
            if side == "card":
                card_s = time.perf_counter() - t0
        tol = LM_SMOKE_TOL.get(arch, LM_SMOKE_TOL_DEFAULT)
        gap = abs(out["card"][0] - out["host"][0])
        row = {"arch": arch, "first_loss": out["card"][0],
               "card_vs_host": gap, "tol": tol,
               "card_vs_host_all_steps": max(
                   abs(a - b) for a, b in zip(out["card"], out["host"])),
               "last_loss": out["card"][-1], "least_first_step_move": moved,
               "card_s": card_s}
        rows.append(row)
        if not (gap <= tol and out["card"][-1] < out["card"][0]
                and moved > 0):
            raise AssertionError(f"lm_train smoke {arch}: {row}, "
                                 f"card {out['card']}, host {out['host']}")
        del card, host
        release_card()
    emit({"phase": "lm_train", "check": "smoke", "archs": len(rows),
          "steps": r["steps"], "lr": r["lr"], "rows": rows,
          "card": nvidia_smi_line()})


def lm_dp_rank(device_name, out_dir):
    """(d), one of ``LM_RANKS`` ranks on the card: the data-parallel step
    of smoke qwen2 and deepseek on ``(2, 2)`` and ``(4, 1)`` against this
    rank's own whole-batch step, and ``compressed_psum_grads`` on a data
    mesh of 4.  Every rank reports its launches (all must be 0); rank 0
    writes ``lm_dp.json``."""
    import copy

    import torch.distributed as dist
    from repro_torch.configs import get_config, smoke
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import _mesh, make_debug_mesh, rules_for
    from repro_torch.models import transformer as tf
    from repro_torch.optim.compression import (GradCompressor,
                                               compressed_psum_grads)
    from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
    from repro_torch.train.train_step import make_train_step
    device = torch.device(device_name)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    zero_launches(KERNELS)
    d = LM_DP
    report = {"dp": []}

    def one_step(model, cfg, batch):
        opt = make_optimizer(model, OptimizerConfig(lr=d["lr"]))
        return make_train_step(cfg, opt)(model, 0, batch)

    for arch in ("qwen2-0.5b", "deepseek-v2-lite-16b"):
        cfg = smoke(get_config(arch), d_model=d["d_model"])
        base = tf.init_params(torch.Generator(device).manual_seed(SEED), cfg,
                              device)
        batch = model_batch(cfg, d["batch"], d["seq"], SEED + 23, device)
        single = copy.deepcopy(base)
        want = one_step(single, cfg, batch)
        want_p = dict(single.named_parameters())
        for shape in ((2, 2), (4, 1)):
            mesh = make_debug_mesh(*shape, device_type=device.type)
            rules = rules_for(cfg, mesh, global_batch=d["batch"])
            model = sharding.shard_module(copy.deepcopy(base), mesh, rules)
            t0 = time.perf_counter()
            with sharding.use_sharding(mesh, rules):
                got = one_step(model, cfg, batch)
            step_s = time.perf_counter() - t0
            worst = max(float((sharding.gather(p.detach())
                               - want_p[n].detach()).abs().max())
                        for n, p in model.named_parameters())
            loss_rel = abs(float(got["loss"]) - float(want["loss"])) \
                / abs(float(want["loss"]))
            row = {"arch": arch, "mesh": list(shape), "loss": float(
                got["loss"]), "single_loss": float(want["loss"]),
                "loss_rel_err": loss_rel, "param_max_abs_err": worst,
                "step_s": step_s,
                "moe_aux_loss": float(got.get("moe_aux_loss", 0.0)),
                "single_moe_aux_loss": float(want.get("moe_aux_loss", 0.0))}
            report["dp"].append(row)
            if not (loss_rel <= d["loss_rtol"] and worst < d["param_tol"]):
                raise AssertionError(f"lm_train dp: {row}")
    # the int8 reduction on a data mesh of 4
    mesh = _mesh((LM_RANKS,), ("data",), device.type)
    rng = np.random.default_rng(SEED + 24)
    params = {"w": torch.from_numpy(rng.standard_normal(
        (64, 64)).astype(np.float32)).to(device),
        "b": torch.zeros(3, device=device)}
    x = torch.from_numpy(rng.standard_normal((32, 64)).astype(
        np.float32)).to(device)

    def grad_fn(p, xb):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = (torch.tanh(xb @ leaves["w"]) ** 2).mean() \
            + leaves["b"].sum() * 0
        return dict(zip(leaves, torch.autograd.grad(loss,
                                                    list(leaves.values()))))

    comp = GradCompressor(min_size=16)
    fn = compressed_psum_grads(grad_fn, mesh, "data", comp)
    grads, _ = fn(params, x, comp.init_state(params))
    ref = grad_fn(params, x)
    err = float((grads["w"] - ref["w"]).abs().max() / ref["w"].abs().max())
    report["compressed"] = {"rel_err": err, "tol": 0.05,
                            "wire_bytes": fn.wire_bytes,
                            "wire_bytes_per_element":
                                fn.wire_bytes.get("w", 0) / 64 / 64}
    if not (err < 0.05 and fn.wire_bytes == {"w": 64 * 64 * 2}):
        raise AssertionError(f"lm_train compressed: {report['compressed']}")
    report["launches_by_rank"] = rank_launches(KERNELS)
    if dist.get_rank() == 0:
        with open(Path(out_dir) / "lm_dp.json", "w") as f:
            json.dump(report, f)


def lm_mesh(device):
    """(d): ``lm_dp_rank`` on ``LM_RANKS`` spawned ranks sharing the card,
    then the trainer's ``--mesh debug`` resume cycle under
    ``torch.distributed.run``."""
    import os
    import re
    import shutil
    import tempfile

    from repro_torch.launch.hostdev import run_host_ranks
    out = tempfile.mkdtemp(prefix="lm_dp-")
    t0 = time.perf_counter()
    run_host_ranks(lm_dp_rank, LM_RANKS, (str(device), out), rdzv_dir=out,
                   timeout=MESH_TIMEOUT_S)
    with open(Path(out) / "lm_dp.json") as f:
        report = json.load(f)
    for rank, counts in report["launches_by_rank"].items():
        if any(counts.values()):
            raise AssertionError(f"lm_train dp: rank {rank} launched "
                                 f"kernels: {counts}")
    emit({"phase": "lm_train", "check": "data_parallel", "ranks": LM_RANKS,
          "transport": "gloo", **report, "wall_s": time.perf_counter() - t0,
          "card": nvidia_smi_line()})
    ckpt_dir = tempfile.mkdtemp(prefix="lm_mesh_ckpt-")
    args = list(LM_MESH_CLI_ARGS) + ["--ckpt-dir", ckpt_dir]
    if device.type != "cuda":
        args += ["--device", str(device)]
    logs, walls = [], []
    try:
        for steps in ("8", "12"):
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", str(LM_RANKS), "-m",
                 "repro_torch.launch.train", *args, "--steps", steps],
                capture_output=True, text=True, timeout=MESH_TIMEOUT_S,
                env={**os.environ, "PYTHONPATH": str(
                    Path(__file__).resolve().parent / "src")})
            walls.append(time.perf_counter() - t0)
            if run.returncode:
                raise AssertionError(f"lm_train mesh trainer: exited "
                                     f"{run.returncode}: "
                                     f"{run.stderr[-3000:]}")
            logs.append(run.stdout)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        shutil.rmtree(out, ignore_errors=True)
    losses = [[float(x) for x in re.findall(r"loss (\d+\.\d+)", log)]
              for log in logs]
    row = {"phase": "lm_train", "check": "mesh_trainer",
           "launcher": "torch.distributed.run", "ranks": LM_RANKS,
           "argv": args, "losses_first": losses[0],
           "losses_resumed": losses[1],
           "resumed_line": "[train] resumed from step 8" in logs[1],
           "wall_s": walls, "card": nvidia_smi_line()}
    emit(row)
    if not (row["resumed_line"] and len(losses[0]) == 8
            and len(losses[1]) == 4 and losses[1][-1] < losses[0][0]):
        raise AssertionError(f"lm_train mesh trainer: {row}")


def phase_lm_train(device):
    """Phase 3 (l), the lm_train path: (a) card against host, (b) the
    trainer at full width with the resume cycle, (c) the smoke archs,
    (d) four ranks sharing the card.  It launches none of the eleven
    kernels; returns their counts, read around the path, which must all
    be 0."""
    fns = {name: kernel_pair(name)[0] for name in KERNELS}
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    walls = {}
    for name, part in (("card_vs_host", lm_card_vs_host),
                       ("trainer", lm_full_width), ("smoke", lm_smoke),
                       ("mesh", lm_mesh)):
        t1 = time.perf_counter()
        part(device)
        walls[name] = time.perf_counter() - t1
    counts = {name: fn.launches for name, fn in fns.items()}
    if any(counts.values()):
        raise AssertionError(f"lm_train path launched kernels: {counts}")
    emit({"phase": "lm_train", "round": "total", "wall_s":
          time.perf_counter() - t0, "parts_s": walls})
    return counts


# -------------------------------------------------------------- roofline

def roofline_dryrun():
    """(a): ``python -m repro_torch.launch.dryrun`` on ``ROOFLINE_CELLS``,
    one process a cell (each its own fake group), all at once; one line a
    record (``roofline.report`` renders them).  Fails on a failure, a
    missing record, a skipped list that is not ``launch.shapes``' or a
    record whose terms are not positive."""
    import os
    import tempfile

    from repro_torch.launch import shapes
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent
                                           / "src")}
    want_skipped = [{"arch": a, "shape": s, "reason": why}
                    for a, s, ok, why in shapes.cells(include_skipped=True)
                    if not ok]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        runs = []
        for i, (arch, shape, mesh) in enumerate(ROOFLINE_CELLS):
            out = Path(tmp) / f"{i}.json"
            runs.append((arch, shape, mesh, out, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", mesh,
                 "--out", str(out)], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env)))
        records = []
        try:
            for arch, shape, mesh, out, proc in runs:
                _, err = proc.communicate(timeout=ROOFLINE_TIMEOUT_S)
                if proc.returncode:
                    raise AssertionError(
                        f"roofline dryrun {arch} x {shape} exited "
                        f"{proc.returncode}: {err[-3000:]}")
                got = json.loads(out.read_text())
                want_n = 2 if mesh == "both" else 1
                if (got["failures"] or len(got["results"]) != want_n
                        or got["skipped"] != want_skipped):
                    raise AssertionError(f"roofline dryrun {arch} x {shape}:"
                                         f" {got['failures']}")
                records += got["results"]
        finally:
            for *_, proc in runs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    for r in records:
        positive = ["memory_s", "model_flops"]
        if r["kind"] != "tm_train":
            positive.append("compute_s")
        if not all(r[k] > 0 for k in positive):
            raise AssertionError(f"roofline dryrun record: {r}")
        emit({"phase": "roofline", "check": "dryrun", "record": r})
    emit({"phase": "roofline", "check": "dryrun_total", "cells":
          len(ROOFLINE_CELLS), "records": len(records),
          "skipped": len(want_skipped),
          "wall_s": time.perf_counter() - t0})


def roofline_inputs(cfg, kind, b, s, seed, device):
    """A held step's inputs on ``device``: the batch (numpy-drawn tokens),
    or a decode step's token at position 0."""
    batch = model_batch(cfg, b, s, seed, device)
    if kind == "decode":
        return {"token": batch["tokens"][:, :1], "pos": 0}
    return batch


def roofline_meta_inputs(inputs):
    """``inputs`` as meta tensors of the same shapes and dtypes."""
    return {k: (torch.empty(v.shape, dtype=v.dtype, device="meta")
                if isinstance(v, torch.Tensor) else v)
            for k, v in inputs.items()}


def roofline_held_step(label, cfg, kind, b, s, device):
    """(b): one step counted on the card and on meta, timed, its memory
    read; fails unless the counts agree and the time is at or above the
    bound."""
    from repro_torch.launch import dryrun, shapes
    from repro_torch.models import transformer as tf

    def state(dev):
        return (tf.init_decode_state(cfg, b, s, torch.bfloat16, dev)
                if kind == "decode" else None)
    inputs = roofline_inputs(cfg, kind, b, s, SEED + 11, device)
    meta_cost, meta_mem, trace_s = dryrun.count_step(dryrun.build_step(
        cfg, kind, shapes.abstract_params(cfg), roofline_meta_inputs(inputs),
        state=state(shapes.META)))
    release_card()
    model = tf.init_params(torch.Generator(device).manual_seed(SEED), cfg,
                           device)
    step = dryrun.build_step(cfg, kind, model, inputs, state=state(device))
    step.run()                                     # warm-up
    torch.cuda.synchronize()
    release_card()
    torch.cuda.reset_peak_memory_stats()
    card_cost, card_mem, count_s = dryrun.count_step(step)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = events_ms(step.run, ROOFLINE_REPS)
    t = roofline.step_times(card_cost)
    bound_s = max(t["compute_s"], t["memory_s"])
    share = bound_s * 1e3 / ms
    bytes_gap = abs(card_cost.bytes - meta_cost.bytes) / meta_cost.bytes
    row = {"phase": "roofline", "check": "held_step", "step": label,
           "kind": kind, "batch": b, "seq": s,
           "compute_dtype": cfg.compute_dtype,
           "card_flops": card_cost.flops, "meta_flops": meta_cost.flops,
           "flops_by_dtype": card_cost.flops_by_dtype,
           "card_bytes": card_cost.bytes, "meta_bytes": meta_cost.bytes,
           "bytes_rel_gap": bytes_gap, "card_ops": card_cost.ops,
           "meta_ops": meta_cost.ops, "compute_ms": t["compute_s"] * 1e3,
           "memory_ms": t["memory_s"] * 1e3, "bound_ms": bound_s * 1e3,
           "bound_by": "operations" if t["compute_s"] >= t["memory_s"]
           else "bytes", "ms": ms, "roofline_share": share,
           "peak_estimate_gib": meta_mem["peak_bytes"] / 2 ** 30,
           "card_estimate_gib": card_mem["peak_bytes"] / 2 ** 30,
           "max_memory_allocated_gib": peak / 2 ** 30,
           "peak_ratio": meta_mem["peak_bytes"] / peak,
           "meta_trace_s": trace_s, "card_count_s": count_s,
           "card": nvidia_smi_line()}
    emit(row)
    lo, hi = ROOFLINE_PEAK_BAND
    if (card_cost.flops != meta_cost.flops
            or bytes_gap > ROOFLINE_BYTES_RTOL or share > 1.0
            or not lo <= row["peak_ratio"] <= hi):
        raise AssertionError(f"roofline held step {label}: {row}")
    del step
    release_card()
    return row


def roofline_held_steps(device):
    """(b): the trainer's qwen2-0.5b step, the models path's bf16 prefill
    and decode."""
    from repro_torch.configs import get_config
    args = dict(LM_TRAIN_RUNS)["qwen2-0.5b"]
    b, s = (int(args[args.index(k) + 1]) for k in ("--batch", "--seq"))
    cfg = get_config("qwen2-0.5b")
    roofline_held_step("trainer qwen2-0.5b", cfg, "train", b, s, device)
    r = MODEL_BF16
    cfg = get_config(r["arch"])
    roofline_held_step(f"{r['arch']} prefill", cfg, "prefill", r["batch"],
                       r["prefill"], device)
    roofline_held_step(f"{r['arch']} decode", cfg, "decode", r["batch"],
                       r["cache"], device)


def roofline_whisper(device):
    """(c): whisper-large-v3 decodes on the default bf16 cache against its
    own forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    cfg = float32_config(get_config("whisper-large-v3"))
    b, s = ROOFLINE_WHISPER_DECODE
    model = tf.init_params(torch.Generator(device).manual_seed(SEED), cfg,
                           device)
    batch = model_batch(cfg, b, s, SEED + 13, device)
    want = tf.forward(model, batch, cfg)
    state = tf.init_decode_state(cfg, b, s, device=device)
    dtypes = {t.dtype for blk in state["blocks"] for c in blk.values()
              for t in (c["cross_k"], c["self"]["k"])}
    state = tf.fill_cross_cache(model, state, batch, cfg)
    outs = []
    for t in range(s):
        logits, state = tf.decode_step(model, state,
                                       batch["tokens"][:, t:t + 1], t, cfg)
        outs.append(logits[:, 0])
    err = held(torch.stack(outs, 1), want, MODEL_DECODE_TOL,
               "whisper-large-v3 bf16-cache decode")
    emit({"phase": "roofline", "check": "whisper_bf16_decode",
          "cache_dtypes": sorted(str(d) for d in dtypes),
          "compute_dtype": cfg.compute_dtype, "batch": b, "steps": s,
          "max_abs_err": err, "tol": MODEL_DECODE_TOL,
          "card": nvidia_smi_line()})
    if dtypes != {torch.bfloat16}:
        raise AssertionError(f"roofline whisper: cache dtypes {dtypes}")
    del model, state
    release_card()


def phase_roofline(device):
    """Phase 3 (m), the roofline path: (a) the dry run on the production
    meshes, (b) three steps' counts held to the card, (c) whisper's decode
    on a bf16 cache.  It launches none of the eleven kernels; returns
    their counts, read around the path, which must all be 0."""
    fns = {name: kernel_pair(name)[0] for name in KERNELS}
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    walls = {}
    for name, part in (("dryrun", lambda _: roofline_dryrun()),
                       ("held_steps", roofline_held_steps),
                       ("whisper", roofline_whisper)):
        t1 = time.perf_counter()
        part(device)
        walls[name] = time.perf_counter() - t1
    counts = {name: fn.launches for name, fn in fns.items()}
    if any(counts.values()):
        raise AssertionError(f"roofline path launched kernels: {counts}")
    emit({"phase": "roofline", "round": "total", "wall_s":
          time.perf_counter() - t0, "parts_s": walls})
    return counts


# -------------------------------------------------------------------- tp

def tp_configs():
    """``{label: config}`` of the path's five models (constants above)."""
    import dataclasses

    from repro_torch.configs import get_config, smoke
    qwen = float32_config(get_config("qwen2-0.5b"))
    arch = "deepseek-v2-lite-16b"
    deep = float32_config(dataclasses.replace(
        get_config(arch), **MODEL_OVERRIDES[arch]))
    return {"qwen2-0.5b": dataclasses.replace(qwen, n_layers=TP_QWEN_LAYERS),
            arch: dataclasses.replace(deep, n_layers=TP_DEEPSEEK_LAYERS),
            "arctic-480b smoke seq_parallel": dataclasses.replace(
                smoke(get_config("arctic-480b")), seq_parallel=True,
                remat=True, loss_chunk=32),
            "zamba2-1.2b": float32_config(dataclasses.replace(
                get_config("zamba2-1.2b"), n_layers=TP_ZAMBA_LAYERS)),
            "xlstm-125m": float32_config(dataclasses.replace(
                get_config("xlstm-125m"), n_layers=TP_XLSTM_LAYERS))}


def tp_model(cfg, device):
    from repro_torch.models import transformer as tf
    return tf.init_params(torch.Generator(device).manual_seed(SEED), cfg,
                          device)


def tp_decode(model, cfg, batch):
    """``TP_DECODE`` decode steps from an empty float32 cache of as many
    slots (made under the active sharding: a rank's slice of them)."""
    from repro_torch.models import transformer as tf
    state = tf.init_decode_state(cfg, TP_SHAPE[0], TP_DECODE,
                                 dtype=torch.float32,
                                 device=batch["tokens"].device)
    outs = []
    for t in range(TP_DECODE):
        logits, state = tf.decode_step(model, state,
                                       batch["tokens"][:, t:t + 1], t, cfg)
        outs.append(logits[:, 0])
    return torch.stack(outs, 1)


def tp_within(got, want, what, floor=0.0):
    """``(max |err| over the leaves, bar)``; fails past the larger of
    TP_TOL x the largest |value| of ``want``'s leaves and ``floor``."""
    if not isinstance(want, dict):
        got, want = {"": got}, {"": want}
    top = max(float(w.abs().max()) for w in want.values())
    err = max(float((got[n].float() - w.float()).abs().max())
              for n, w in want.items())
    bar = max(TP_TOL * top, floor)
    if not err <= bar:
        raise AssertionError(f"tp {what}: max |err| {err} past the larger "
                             f"of {TP_TOL} x {top} and {floor}")
    return err, bar


def tp_step_gradients(opt):
    """The gradients the train step hands ``opt.step``, whole, by name
    (filled when the step runs)."""
    from repro_torch.distributed import sharding
    seen = {}
    inner = opt.step

    def spy(step_idx, grads=None):
        seen.update({n: sharding.gather(g).detach().clone()
                     for n, g in grads.items()})
        return inner(step_idx, grads)

    opt.step = spy
    return seen


def tp_moves_within(got, want, want_g, what):
    """``(max |err| of the moves held, share of entries held)``: each
    entry's move within TP_MOVE_TOL x TP_LR of the one-rank move where
    the one-rank step's gradient is at least TP_MOVE_MIN_G of its
    largest."""
    top = max(float(g.abs().max()) for g in want_g.values())
    err, held, total = 0.0, 0, 0
    for n, g in want_g.items():
        mask = g.abs() >= TP_MOVE_MIN_G * top
        if bool(mask.any()):
            err = max(err, float((got[n] - want[n])[mask].abs().max()))
        held += int(mask.sum())
        total += mask.numel()
    if not err <= TP_MOVE_TOL * TP_LR or not held:
        raise AssertionError(f"tp {what}: a move off by {err} past "
                             f"{TP_MOVE_TOL} x {TP_LR}, or {held} of "
                             f"{total} entries held")
    return err, held / total


def tp_train_check(label, cfg, mesh, device):
    """(a) / (c) on this rank: gradients and one AdamW step against one
    rank; returns the row."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import rules_for
    from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
    from repro_torch.train.train_step import make_train_step
    batch = model_batch(cfg, *TP_SHAPE, SEED + 31, device)
    single = tp_model(cfg, device)
    want_loss, want_g = lm_grads(single, batch, cfg)
    before = {n: p.detach().clone() for n, p in single.named_parameters()}
    opt = make_optimizer(single, OptimizerConfig(lr=TP_LR))
    want_sg = tp_step_gradients(opt)
    make_train_step(cfg, opt)(single, 0, batch)
    want_p = {n: p.detach() for n, p in single.named_parameters()}
    del single
    rules = rules_for(cfg, mesh, global_batch=TP_SHAPE[0])
    model = sharding.shard_module(tp_model(cfg, device), mesh, rules)
    with sharding.use_sharding(mesh, rules):
        loss, g = lm_grads(model, batch, cfg)
        opt = make_optimizer(model, OptimizerConfig(lr=TP_LR))
        got_sg = tp_step_gradients(opt)
        make_train_step(cfg, opt)(model, 0, batch)
    got_g = {n: sharding.gather(v) for n, v in g.items()}
    got_p = {n: sharding.gather(p.detach())
             for n, p in model.named_parameters()}
    loss_err, _ = tp_within(loss, want_loss, f"{label} loss")
    g_err, g_bar = tp_within(got_g, want_g, f"{label} gradients")
    sg_err, sg_bar = tp_within(got_sg, want_sg,
                               f"{label} train-step gradients")
    p_err, p_bar = tp_within(got_p, want_p, f"{label} AdamW step")
    for n, w in want_p.items():
        moved = float((w - before[n]).abs().max())
        if float((got_p[n] - before[n]).abs().max()) < 0.5 * moved:
            raise AssertionError(f"tp {label}: {n} did not move")
    move_err, move_share = tp_moves_within(
        {n: got_p[n] - before[n] for n in before},
        {n: want_p[n] - before[n] for n in before}, want_sg,
        f"{label} AdamW moves")
    split = sum(sharding.partitioned(p) for p in model.parameters())
    return {"model": label, "check": "train_step", "loss": float(loss),
            "loss_err": loss_err, "grad_max_abs_err": g_err,
            "grad_bar": g_bar, "step_grad_max_abs_err": sg_err,
            "step_grad_bar": sg_bar, "param_max_abs_err": p_err,
            "param_bar": p_bar, "move_max_abs_err": move_err,
            "move_bar": TP_MOVE_TOL * TP_LR, "move_share_held": move_share,
            "lr": TP_LR, "leaves_split": split,
            "seq_parallel": cfg.seq_parallel}


def tp_rounding_floor(model, batch, cfg, want_g):
    """The most ``model``'s gradients move from ``want_g`` (its own, at
    ``batch``) when its weights are nudged (:func:`nudged`)."""
    _, g = lm_grads(nudged(model, batch["tokens"].device), batch, cfg)
    return max(float((g[n] - w).abs().max()) for n, w in want_g.items())


def tp_ssm_check(label, cfg, mesh, device):
    """(e) on this rank: ``loss_fn``'s loss and gradients and
    ``TP_DECODE`` decode steps against one rank; returns the row."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import ssm
    batch = model_batch(cfg, *TP_SHAPE, SEED + 33, device)
    single = tp_model(cfg, device)
    want_loss, want_g = lm_grads(single, batch, cfg)
    want_dec = tp_decode(single, cfg, batch)
    floor = tp_rounding_floor(single, batch, cfg, want_g)
    del single
    release_card()
    rules = rules_for(cfg, mesh, global_batch=TP_SHAPE[0])
    model = sharding.shard_module(tp_model(cfg, device), mesh, rules)
    n_heads = ssm._mlstm_dims(cfg)[1]       # Mamba2's and mLSTM's alike
    with sharding.use_sharding(mesh, rules):
        heads = ssm._head_split(n_heads)[1]
        t0 = time.perf_counter()
        loss, g = lm_grads(model, batch, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec = tp_decode(model, cfg, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    got_g = {n: sharding.gather(v) for n, v in g.items()}
    loss_err, _ = tp_within(loss, want_loss, f"{label} loss")
    g_err, g_bar = tp_within(got_g, want_g, f"{label} gradients",
                             TP_FLOOR_X * floor)
    g_top = max(float(w.abs().max()) for w in want_g.values())
    return {"model": label, "check": "grads_decode", "layers": cfg.n_layers,
            "ssm_heads": n_heads,
            "ssm_heads_a_rank": heads.stop - heads.start, "loss": float(loss),
            "loss_err": loss_err, "grad_max_abs_err": g_err,
            "grad_bar": g_bar, "grad_tp_tol_bar": TP_TOL * g_top,
            "rounding_floor": floor, "nudge": MODEL_NUDGE,
            "decode_err": held(dec, want_dec, MODEL_DECODE_TOL,
                               f"tp {label} decode"),
            "tol": MODEL_DECODE_TOL, "grads_s": t1 - t0, "decode_s": t2 - t1}


def tp_rank(device_name, out_dir, ref_path):
    """One of ``TP_RANKS`` ranks on the card: (a), (b), (c), (e); every rank
    reports its launches, peak memory, collective bytes and ms a step;
    rank 0 writes ``tp.json``."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh, rules_for
    from repro_torch.models import transformer as tf
    device = torch.device(device_name)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    zero_launches(KERNELS)
    mesh = make_debug_mesh(2, 2, device_type=device.type)
    cfgs = tp_configs()
    rows = []
    qwen, deep, sp, zamba, xlstm = cfgs
    rows.append(tp_train_check(qwen, cfgs[qwen], mesh, device))
    release_card()
    # the trainer's step of (a), counted and timed on this rank
    cfg = cfgs[qwen]
    rules = rules_for(cfg, mesh, global_batch=TP_SHAPE[0])
    batch = model_batch(cfg, *TP_SHAPE, SEED + 31, device)
    torch.cuda.reset_peak_memory_stats()
    with sharding.use_sharding(mesh, rules):
        step = dryrun.build_step(cfg, "train", tp_model(cfg, device), batch,
                                 mesh=mesh, rules=rules)
        cost, mem, count_s = dryrun.count_step(step)
        ms = events_ms(step.run, TP_REPS)
    mine = {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "flops": cost.flops, "bytes": cost.bytes,
            "collective_bytes": cost.collective_bytes,
            "collective_ops": dict(cost.collective_detail),
            "step_ms": ms, "count_s": count_s,
            "params_bytes": mem["params_bytes"]}
    del step
    release_card()
    # (b): the one-process results came from the parent
    cfg = cfgs[deep]
    want = torch.load(ref_path)
    batch = model_batch(cfg, *TP_SHAPE, SEED + 32, device)
    rules = rules_for(cfg, mesh, global_batch=TP_SHAPE[0])
    model = sharding.shard_module(tp_model(cfg, device), mesh, rules)
    release_card()
    with sharding.use_sharding(mesh, rules):
        t0 = time.perf_counter()
        fwd = tf.forward(model, batch, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec = tp_decode(model, cfg, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    rows.append({"model": deep, "check": "forward_decode",
                 "forward_err": held(fwd, want["forward"], MODEL_DECODE_TOL,
                                     f"tp {deep} forward"),
                 "decode_err": held(dec, want["decode"], MODEL_DECODE_TOL,
                                    f"tp {deep} decode"),
                 "tol": MODEL_DECODE_TOL, "forward_s": t1 - t0,
                 "decode_s": t2 - t1, "cache_slots_a_rank": TP_DECODE // 2})
    del model, fwd, dec
    release_card()
    rows.append(tp_train_check(sp, cfgs[sp], mesh, device))
    release_card()
    for label in (zamba, xlstm):
        rows.append(tp_ssm_check(label, cfgs[label], mesh, device))
        release_card()
    mine["peak_gib_all"] = torch.cuda.max_memory_allocated() / 2 ** 30
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    launches = rank_launches(KERNELS)
    if dist.get_rank() == 0:
        with open(Path(out_dir) / "tp.json", "w") as f:
            json.dump({"rows": rows, "by_rank": every,
                       "launches_by_rank": launches}, f)


def tp_one_process(device, path):
    """(b)'s one-process forward and decode, saved to ``path``; the model
    is released before the ranks start."""
    from repro_torch.models import transformer as tf
    cfg = tp_configs()["deepseek-v2-lite-16b"]
    model = tp_model(cfg, device)
    batch = model_batch(cfg, *TP_SHAPE, SEED + 32, device)
    t0 = time.perf_counter()
    fwd, aux = tf.forward(model, batch, cfg, return_aux=True)
    if float(aux["moe_drop_frac"]):
        raise AssertionError("tp deepseek: the forward dropped slots")
    dec = tp_decode(model, cfg, batch)
    torch.cuda.synchronize()
    torch.save({"forward": fwd.cpu(), "decode": dec.cpu()}, path)
    n_params = sum(p.numel() for p in model.parameters())
    del model, fwd, dec
    release_card()
    return {"params": n_params, "one_process_s": time.perf_counter() - t0}


def tp_meta_count():
    """(d): the trainer's step of (a) counted on meta on a fake (2, 2)
    group in this process (rank 0)."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun, shapes
    from repro_torch.launch.mesh import make_debug_mesh, rules_for
    cfg = tp_configs()["qwen2-0.5b"]
    dryrun.fake_group(TP_RANKS)
    try:
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        rules = rules_for(cfg, mesh, global_batch=TP_SHAPE[0])
        inputs = roofline_meta_inputs(model_batch(cfg, *TP_SHAPE, SEED + 31,
                                                  "cpu"))
        with sharding.use_sharding(mesh, rules):
            cost, mem, _ = dryrun.count_step(dryrun.build_step(
                cfg, "train", shapes.abstract_params(cfg), inputs,
                mesh=mesh, rules=rules))
    finally:
        dist.destroy_process_group()
    return cost, mem


def phase_tp(device):
    """Phase 3 (n), the tp path: (b)'s one process, (d)'s meta count, then
    ``tp_rank`` on ``TP_RANKS`` spawned ranks sharing the card ((a), (b),
    (c), (e)).  It launches none of the eleven kernels; returns their
    counts, read around the path and on every rank, which must all be
    0."""
    import shutil
    import tempfile

    from repro_torch.launch.hostdev import run_host_ranks
    fns = {name: kernel_pair(name)[0] for name in KERNELS}
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = tempfile.mkdtemp(prefix="tp-")
    try:
        ref = tp_one_process(device, str(Path(out) / "deepseek.pt"))
        meta, meta_mem = tp_meta_count()
        t1 = time.perf_counter()
        run_host_ranks(tp_rank, TP_RANKS,
                       (str(device), out, str(Path(out) / "deepseek.pt")),
                       rdzv_dir=out, timeout=TP_TIMEOUT_S)
        ranks_s = time.perf_counter() - t1
        with open(Path(out) / "tp.json") as f:
            report = json.load(f)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for rank, counts in report["launches_by_rank"].items():
        if any(counts.values()):
            raise AssertionError(f"tp: rank {rank} launched kernels: "
                                 f"{counts}")
    card = nvidia_smi_line()
    for row in report["rows"]:
        emit({"phase": "tp", "ranks": TP_RANKS, "mesh": [2, 2],
              "transport": "gloo", **row, "card": card})
    card0 = report["by_rank"][0]
    gap = abs(card0["bytes"] - meta.bytes) / meta.bytes
    emit({"phase": "tp", "check": "per_rank", "model": "qwen2-0.5b",
          "layers": TP_QWEN_LAYERS, "batch": TP_SHAPE[0],
          "seq": TP_SHAPE[1], "by_rank": report["by_rank"],
          "deepseek_one_process": ref, "card": card})
    row = {"phase": "tp", "check": "meta_count", "card_flops":
           card0["flops"], "meta_flops": meta.flops,
           "card_bytes": card0["bytes"], "meta_bytes": meta.bytes,
           "bytes_rel_gap": gap, "card_collective_bytes":
           card0["collective_bytes"], "meta_collective_bytes":
           meta.collective_bytes, "meta_peak_gib":
           meta_mem["peak_bytes"] / 2 ** 30, "card": card}
    emit(row)
    if card0["flops"] != meta.flops or gap > ROOFLINE_BYTES_RTOL:
        raise AssertionError(f"tp meta count: {row}")
    counts = {name: fn.launches for name, fn in fns.items()}
    if any(counts.values()):
        raise AssertionError(f"tp path launched kernels: {counts}")
    emit({"phase": "tp", "round": "total", "wall_s":
          time.perf_counter() - t0, "ranks_s": ranks_s, "card": card})
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # IEEE fp32 plain paths
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    stream_keep = {}
    smi = phase_environment()
    max_err = phase_kernels(device)
    max_err.update(phase_dense_kernels(device))
    max_err.update(phase_tm_kernels(device))
    max_err.update(phase_clause_kernels(device))
    max_err.update(phase_flash_kernels(device))
    by_path = {"analog": phase_serving(device),
               "analog_tiers": phase_analog_tiers(device),
               "chaos": phase_chaos(device),
               "crossbar": phase_crossbar(device),
               "coalesced": phase_coalesced_serving(device),
               "digital": phase_digital_fused(device),
               "live": phase_live(device),
               "stream": phase_stream(device, stream_keep),
               "cli": phase_cli(device),
               "mesh": phase_mesh(device),
               "models": phase_models(device),
               "lm_train": phase_lm_train(device),
               "roofline": phase_roofline(device),
               "tp": phase_tp(device)}
    by_path["training"], train_epochs = phase_training(device)
    by_path["flash"] = phase_flash_path(device)
    emit({"phase": "launches", "by_path": by_path})
    phase_tuning(device, stream_keep)
    # The kernels line counts each kernel on its main path: the analog
    # path for imbue_infer_planes, the lower analog tiers for the
    # dense-plane kernels, the coalesced path for the TM kernels, the
    # training path for the clause-bit kernels, the trainable attention
    # steps for the flash kernels.
    launches = {**by_path["analog"], **by_path["analog_tiers"],
                **by_path["coalesced"], **by_path["training"],
                **by_path["flash"]}
    main_rows = {"imbue_infer_planes": next(
        r for r in phase_timing(device)
        if r["dev"] and r["R"] == REPLICAS and r["B"] == 128)}
    for r in phase_dense_timing(device):
        if r["B"] == 128:
            main_rows[r["kernel"]] = r
    for r in phase_tm_timing(device):
        if r["width"] == "coalesced" and r["B"] == 128:
            main_rows[r["kernel"]] = r
    # The clause kernels' main-path rows: the batch training step (B = 256)
    # for the packed one, the sequential step (B = 1) for the dense one.
    for r in phase_clause_timing(device, train_epochs):
        if r["width"] == "digital" and (r["kernel"], r["B"]) in (
                ("clause_eval_packed", TRAIN_BATCH), ("clause_eval", 1)):
            main_rows[r["kernel"]] = r
    # No single PyTorch call computes thresholded class sums, so the
    # inference kernels have no library yardstick (the partial ones, a
    # product alone, are in the timing lines: the column-current einsums,
    # the TM kernels' violation matmul).  clause_eval's is torch.matmul of
    # its own operands as float32 then == 0; the packed words have none.
    library = {"clause_eval": main_rows["clause_eval"]["matmul_bracket_ms"]}
    # The flash kernels at the main row (qwen2-0.5b); the library call is
    # SDPA's forward for flash_fwd and SDPA's one backward call (dQ, dK and
    # dV together) for both backward kernels.
    for r in phase_flash_timing(device):
        if r["row"] == "main":
            main_rows[r["kernel"]] = r
            library[r["kernel"]] = r["library_ms"]
    emit({"kernels": [dict(
        name=name, **KERNELS[name], launches=launches[name],
        max_abs_err=max_err[name], ms=main_rows[name]["ms"],
        plain_ms=main_rows[name]["plain_ms"],
        bound_ms=main_rows[name]["bound_ms"],
        bound_by=main_rows[name]["bound_by"],
        library_ms=library.get(name),
        # The six fused inference kernels run the committed tiles on their
        # main paths ("auto": none); ms is timed at them, auto_ms without.
        tiles=main_rows[name].get("tiles"),
        auto_ms=main_rows[name].get("auto_ms"))
        for name in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
