#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    PYTHONPATH=src python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, so the exit
code is non-zero and no result line is printed):

1. environment — the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions, and the kernel build (``nvcc``, sm_90a);
2. kernels — every kernel of the path against its plain PyTorch version
   on the card, at the imbue-tm-mnist width (R in {1, 4}, B in
   {8, 64, 128}, with and without the deviation plane) and one ragged
   small shape; class sums must be equal (tolerance 0);
3. serving — ``ServeEngine.from_ta_state`` at imbue-tm-mnist with R = 4
   serves 512 requests in ``round_robin`` and in ``ensemble`` through
   ``analog-cuda-packed2``, first with D2D + C2C (no CSA offset), then at
   nominal, where every response must equal the digital TM; the launch
   counters are zeroed before this phase and must show one launch per
   dispatch;
4. timing — the kernel's median time (CUDA events, cold L2) at R = 4,
   B in {8, 64, 128}, with and without the deviation plane, beside its
   bound, the plain version's time and the C2C pre-pass's time.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  The TA state is built with numpy from
a seed, without training: each clause includes 8-16 literals that are 1
on a class prototype; requests are prototypes with 8 % of bits flipped.
"""

from __future__ import annotations

import json
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
# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
KERNELS = {
    "imbue_infer_planes": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/imbue_infer_planes.cu",
        "replaces": "src/repro/kernels/imbue_infer.py:111",
    },
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


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


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------- phases

def phase_environment():
    from repro_torch.kernels import _build
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    secs = _build.build(list(KERNELS))
    ptxas = [ln.strip() for name in KERNELS
             for ln in _build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "environment", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "build_s": time.perf_counter() - t0, "build_s_per_kernel": secs,
          "ptxas": ptxas})
    return smi


def phase_kernels(device):
    """Each kernel against its plain version on the card."""
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core.tm import TMConfig
    from repro_torch.kernels.imbue_infer import (imbue_infer_planes,
                                                 imbue_infer_planes_ref)
    cfg = tm_config(MODEL)
    ta, x, _ = prototype_task(cfg, 128, SEED)
    shapes = [(cfg, ta, x[:b], r, with_dev)
              for with_dev in (False, True)
              for r in ((1, 4) if with_dev else (1,))
              for b in (8, 64, 128)]
    small = TMConfig(n_classes=4, clauses_per_class=8, n_features=37,
                     n_states=100)
    sta, sx, _ = prototype_task(small, 13, SEED + 1)
    shapes.append((small, sta, sx, 3, True))
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
    emit({"phase": "kernels", "kernels": list(KERNELS), "tolerance": 0,
          "cases": rows})
    return max_err


def serve_round(cfg, ta, x, y, vcfg, routing, device):
    from repro_torch.core import tm
    from repro_torch.kernels.imbue_infer import imbue_infer_planes
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    eng = ServeEngine.from_ta_state(
        torch.from_numpy(ta), cfg, n_replicas=REPLICAS, seed=SEED,
        vcfg=vcfg, ecfg=EngineConfig(routing=routing), device=device)
    if eng.backend.name != "analog-cuda-packed2" or eng.selection.fell_back:
        raise AssertionError(f"main path not on the kernel backend: "
                             f"{eng.backend.name} {eng.selection}")
    launches0 = imbue_infer_planes.launches
    t0 = time.perf_counter()
    eng.submit_many(list(x))
    eng.pump()
    out = eng.drain()
    wall = time.perf_counter() - t0
    s = eng.summary()
    launches = imbue_infer_planes.launches - launches0
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
           "requests": len(out), "dispatches": s["batches"],
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


def phase_serving(device):
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core.variations import VariationConfig
    from repro_torch.kernels.imbue_infer import imbue_infer_planes
    cfg = tm_config(MODEL)
    ta, x, y = prototype_task(cfg, N_REQUESTS, SEED + 100)
    imbue_infer_planes.launches = 0       # count the main path only
    for vcfg in (VariationConfig(csa_offset=False),
                 VariationConfig.nominal()):
        for routing in ("round_robin", "ensemble"):
            serve_round(cfg, ta, x, y, vcfg, routing, device)
    return {"imbue_infer_planes": imbue_infer_planes.launches}


def time_ms(fn, reps, flush):
    """Median ms of ``fn`` over ``reps`` runs, CUDA events around each,
    with L2 flushed before every run."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_timing(device):
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
    for with_dev in (True, False):
        for b in (8, 64, 128):
            args = planes_case(cfg, ta, x[:b], REPLICAS, with_dev, SEED,
                               device)
            ms = time_ms(lambda: imbue_infer_planes(*args), 20, flush)
            plain = time_ms(lambda: imbue_infer_planes_ref(*args), 3, flush)
            nbytes, nops = operand_bytes_and_ops(*args)
            bms, by = bound_ms(nbytes, nops)
            row = {"R": REPLICAS if with_dev else 1, "B": b,
                   "dev": with_dev, "ms": ms, "plain_ms": plain,
                   "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                   "fp32_ops": nops, "bound_share": bms / ms}
            if with_dev:
                litw, incw, dev, _, _ = args
                gen = torch.Generator(device=device).manual_seed(SEED)
                row["c2c_prepass_ms"] = time_ms(
                    lambda: ops.c2c_deviation(gen, incw, dev, REPLICAS,
                                              vcfg, cfg.n_literals),
                    10, flush)
            rows.append(row)
    emit({"phase": "timing", "kernel": "imbue_infer_planes",
          "clock": "cuda events, median, L2 flushed", "rows": rows})
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
    launches = phase_serving(device)
    rows = phase_timing(device)
    main_row = next(r for r in rows if r["dev"] and r["B"] == 128)
    emit({"kernels": [dict(
        name=name, **KERNELS[name], launches=launches[name],
        max_abs_err=max_err, ms=main_row["ms"],
        plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
        bound_by=main_row["bound_by"], library_ms=None)
        for name in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
