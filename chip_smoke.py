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
qwen2-0.5b, gemma2-2b and the whisper-large-v3 encoder.

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
5. timing — each kernel's median device time (CUDA events, L2 flushed,
   the host's enqueue hidden behind a spin kernel) beside
   its bound, what sets the bound, and the plain version's time:
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

Then the launches of each path, the ``{"kernels": [...]}`` line (each
kernel's launches on its main path: the plane-packed analog path for
``imbue_infer_planes``, the lower analog tiers for ``imbue_infer_packed``
and ``imbue_infer``, the coalesced path for the TM kernels, the training
path for the clause-bit kernels, the trainable attention steps for the
flash kernels; the stream path's counts are in the ``launches`` line),
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
# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12        # outside the tensor cores
INT8_OP_PER_S = 1979e12        # dense, tensor cores, int32 accumulation
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
BF16_FLOP_PER_S = 989e12       # dense, tensor cores
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


def stream_engine(cls, model, vcfg, routing, device):
    """An analog engine of R = REPLICAS chips on the stream model, under
    ``BatcherConfig.for_max_batch(STREAM_BATCH)``, on the planes tier."""
    from repro_torch.serve import BatcherConfig, EngineConfig
    eng = cls.from_ta_state(
        model["ta"], model["cfg"], n_replicas=REPLICAS, seed=SEED, vcfg=vcfg,
        ecfg=EngineConfig(routing=routing, batcher=BatcherConfig
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


def stream_nominal_round(model, frames, routing, cls, device):
    """(h) round 2: 64 sessions at nominal.  Every session's per-window
    predictions equal offline ``api.predict`` and the digital TM on its
    windows, every keyword the vote over the last STREAM_VOTE windows; one
    ``imbue_infer_planes`` launch a dispatch, no fallback."""
    from repro_torch import api
    from repro_torch.core import tm
    from repro_torch.core.variations import VariationConfig
    from repro_torch.kernels.imbue_infer import imbue_infer_planes
    from repro_torch.serve import majority_vote
    eng = stream_engine(cls, model, VariationConfig.nominal(), routing,
                        device)
    launches0 = imbue_infer_planes.launches
    server, wall = stream_round(eng, model, frames)
    launches = stream_launches("nominal", imbue_infer_planes, launches0,
                               eng.summary())
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
    row = {"phase": "stream", "round": "nominal", "engine": cls.__name__,
           "routing": routing, "R": REPLICAS, "launches": launches,
           "equals_offline_and_digital": True, "classes_seen": len(classes),
           **stream_stats(server, wall)}
    if row["decisions"] != STREAM_SESSIONS * (
            (frames.shape[1] - KWS_TASK["window"]) // KWS_TASK["hop"] + 1):
        raise AssertionError(f"stream: {row['decisions']} decisions")
    emit(row)


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


def phase_stream(device):
    """Phase 3 (h), the streaming path; returns its launches per kernel."""
    from repro_torch.serve import AsyncServeEngine, ServeEngine

    def drive():
        kws = stream_model(KWS_TASK, device)
        anomaly = stream_model(ANOMALY_TASK, device)
        frames, labels = kws_sessions()
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


def b1_geometry(name, *shape):
    """The launch geometry of ``name`` (a kernel on ``csrc/tm_b1.cuh``) at
    ``shape``, as its ``<name>_geometry`` export reports it: grid,
    threads, shared bytes, resident blocks an SM, K-split, block tile,
    and the launched warps an SM (the grid's warps / SMs, capped by what
    is resident).  ``shape``: ``(B, C, Lw)`` for ``clause_eval_packed``,
    ``(B, C, Lw, M)`` for ``tm_infer_planes`` and ``tm_infer_packed``,
    ``(B, C, L, M)`` for ``tm_infer``."""
    import ctypes
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(str(_build.library_path(name)))
    info = (ctypes.c_int * 9)()
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


def analog_launch_record(name, args):
    """Kernel ``name``'s launch on the wrapper's operands ``args`` (an
    analog kernel, all three on ``csrc/imbue_core.cuh``): its grid,
    block, shared memory, resident blocks an SM (``<name>_geometry``),
    the launched warps an SM (the grid's warps / SMs, capped by what is
    resident), and from one counted launch (``<name>_launch_counted``,
    outside every launch counter, held against ``<name>_ref``) the share
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
        err = geometry(r, b, c, lw, int(dev is not None), info)
        counted.argtypes = ii._ARGTYPES[:-1] + [ctypes.c_void_p] * 2
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
        err = geometry(r, b, c, l, info)
        counted.argtypes = ii._DENSE_ARGTYPES[:-1] + [ctypes.c_void_p] * 2
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
    BATCHES."""
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
    rows = []
    for r, with_dev in ((REPLICAS, True), (1, True), (1, False)):
        for b in BATCHES:
            args = planes_case(cfg, ta, x[:b], r, with_dev, SEED, device)
            ms = time_ms(lambda: imbue_infer_planes(*args), 20, flush)
            plain = time_ms(lambda: imbue_infer_planes_ref(*args), 3, flush)
            nbytes, nops = operand_bytes_and_ops(*args)
            bms, by = bound_ms(nbytes, [(nops, FP32_FLOP_PER_S)])
            row = {"R": r, "B": b, "dev": with_dev, "ms": ms,
                   "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                   "issue_floor_ms": issue_floor_ms(nops),
                   "bytes": nbytes, "fp32_ops": nops,
                   "bound_share": bms / ms,
                   "fired_frac": fired_share(cfg, ta, x[:b], device),
                   **analog_launch_record("imbue_infer_planes", args)}
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
    """The dense-plane analog kernels at R = 4, B in {8, 64, 128}, with the
    eager conductance pre-pass and a partial library yardstick."""
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core import tm
    from repro_torch.core.imbue import (IMBUEConfig, conductances,
                                        program_replica_stack)
    from repro_torch.core.variations import VariationConfig
    cfg = tm_config(MODEL)
    ta, x, _ = prototype_task(cfg, 128, SEED)
    flush = torch.empty(256 * 2 ** 20 // 4, dtype=torch.float32,
                        device=device)              # > 50 MB of L2
    rows = []
    for b in BATCHES:
        cases, fired = dense_case(cfg, ta, x[:b], REPLICAS, True, SEED,
                                  device)
        for name in DENSE_KERNELS:
            fn, ref = kernel_pair(name)
            args = cases[name]
            ms = time_ms(lambda: fn(*args), 20, flush)
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
                   "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                   "issue_floor_ms": issue_floor_ms(nops),
                   "bytes": nbytes, "fp32_ops": nops,
                   "bound_share": bms / ms, "fired_frac": fired,
                   "column_current_einsum_ms": einsum_ms,
                   **analog_launch_record(name, args)}
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
    """The three TM kernels at both widths, B in BATCHES: device time,
    plain version, bound, the ``torch.matmul`` bracket of the violation
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
                ms = time_ms(lambda: fn(*a), 20, flush)
                plain = time_ms(lambda: ref(*a), 5, flush)
                nbytes, work = tm_bytes_and_work(name, a)
                bms, by = bound_ms(nbytes, work)
                row = {"kernel": name, "width": label,
                       "C": int(inc.shape[0]), "L": int(inc.shape[1]),
                       "B": b, "ms": ms, "plain_ms": plain, "bound_ms": bms,
                       "bound_by": by, "bytes": nbytes,
                       "ops": [ops for ops, _ in work],
                       "ops_per_s": [rate for _, rate in work],
                       "bound_share": bms / ms,
                       "violation_matmul_ms": bracket, "zero_fill_ms": fill}
                if name in B1_KERNELS:
                    row.update(b1_geometry(name, b, int(a[1].shape[0]),
                                           int(a[1].shape[1]), m))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # IEEE fp32 plain paths
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
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
               "stream": phase_stream(device)}
    by_path["training"], train_epochs = phase_training(device)
    by_path["flash"] = phase_flash_path(device)
    emit({"phase": "launches", "by_path": by_path})
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
        library_ms=library.get(name))
        for name in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
