"""Serving-engine benchmark of the PyTorch port: dynamic batching x
replica-pool sweep (port of ``benchmarks/serve_bench.py``).

Measures the port's serving throughput and latency on one device across
(max-batch, replica-count) configurations and against the per-request
serial path (one dispatch per request).  The rows:

* **sweep** — R in {1, 2, 4} x max batch in {8, 32, 64}, round robin, on
  the default plane-packed wire and resident format with the tuning
  table's ladder and tiles for this device;
* **ensemble** — R = 4, batch 64, majority vote over the chips;
* **sync / async pair** — ``ServeEngine`` against ``AsyncServeEngine`` at
  R = 4, batch 64, runs interleaved so host drift moves both alike;
* **planes pair** — dense resident planes (``analog-cuda-packed``)
  against the plane-packed stack (``analog-cuda-packed2``), interleaved,
  with ``resident_bytes_per_dispatch``;
* **capacity pair** — one 8-class workload served by a replicated
  per-class analog pool (R = 4) and by ONE coalesced shared pool with
  half the clause rows, interleaved;
* **before_unpacked_static** — the dense uint8 wire on the static ladder
  with the kernels' own tiles;
* **degraded** (``--smoke``) — the ensemble with one chip injured,
  quarantined, served around and repaired;
* **sharded** (with more than one rank: ``--host-devices N``, or under
  ``torch.distributed.run``) — the pool's ``[R, C, L]`` stack split over
  a ``replica`` mesh of all the ranks (``make_replica_mesh``), R in {4, 8}
  where the ranks divide it, sync and async, routed and ensemble, on the
  kernel ladder (each rank launches on its own replicas).  The ranks
  share the host (and, on the card, the card), so with more than one
  rank the bench runs these rows alone: a single-device row measured
  beside the other ranks' work would read their contention.  Every rank
  runs every row, and rank 0 reports.

The model is the reference's: training-free, 10 % random includes over
the 2F literals.  Its clauses hardly ever fire on the requests (a clause
of ~13 includes fires on a random row with odds near 2^-13), so nearly
every class sum is 0 and the analog kernels mostly take their early
exit: the rows are readings of the serving mechanics on that model, not
of a model whose clauses fire.  ``model_activity`` in the report says how
many (request, clause) pairs fire and how many class sums are non-zero.

Each timed configuration runs ``--repeats`` times on one warmed engine
and the best run is reported.  A timed run ends in
``torch.cuda.synchronize()`` on the card.  The times are the device's
that ran them: on the card, its name and power limit (``nvidia-smi``)
head the report; ``--device cpu`` runs the plain versions on the host
and says so.  The modeled chip's figures of merit are in each row's
``hardware`` block (``serve.metrics.hardware_figures``).

The report is printed as one JSON line; it is written to a file only
with ``--out`` (``--smoke-out`` for the smoke's).

  PYTHONPATH=src python -m benchmarks.serve_bench_torch
  PYTHONPATH=src python -m benchmarks.serve_bench_torch --smoke
  PYTHONPATH=src python -m benchmarks.serve_bench_torch --smoke --device cpu
  PYTHONPATH=src python -m benchmarks.serve_bench_torch --device cpu \\
      --host-devices 4                       # + the sharded rows
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch._device import device_label, resolve_device
from repro_torch.core import tm
from repro_torch.core.coalesced import CoalescedConfig
from repro_torch.core.tm import TMConfig
from repro_torch.core.variations import FaultConfig, VariationConfig
from repro_torch.distributed.sharding import mesh_shape, world_size
from repro_torch.launch import hostdev
from repro_torch.launch.chaos import sparse_ta
from repro_torch.launch.mesh import make_replica_mesh
from repro_torch.launch.stream import ANALOG_BACKENDS
from repro_torch.serve import (AsyncServeEngine, BatcherConfig, EngineConfig,
                               HealthConfig, RepairConfig, RepairPolicy,
                               ServeEngine)
from repro_torch.serve.batching import STATIC_BUCKETS


def make_model(seed: int = 0):
    """Small training-free TM (sparse random includes): the bench measures
    serving mechanics, not accuracy."""
    cfg = TMConfig(n_classes=4, clauses_per_class=8, n_features=64,
                   n_states=100)
    return cfg, sparse_ta(cfg, torch.Generator().manual_seed(seed))


def model_activity(cfg, ta, x) -> dict:
    """How much of the model the rows ``x`` exercise: the share of (row,
    clause) pairs that fire and of (row, class) sums that are non-zero,
    on the digital TM."""
    x = torch.as_tensor(np.asarray(x))
    ta = ta.cpu()
    fired = tm.clause_outputs(ta, tm.literals(x), cfg)
    sums = tm.class_sums(fired, cfg)
    return {"rows": int(x.shape[0]),
            "clause_fire_share": float(fired.float().mean()),
            "nonzero_sum_share": float((sums != 0).float().mean())}


def activity_line(name, act) -> str:
    return (f"{name}: {act['clause_fire_share']:.2e} of (row, clause) "
            f"pairs fire, {act['nonzero_sum_share']:.2e} of class sums "
            f"non-zero over {act['rows']} rows")


def sync_device(device: torch.device) -> None:
    """Wait for the card, so a host clock reads finished work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_drain(eng, xs) -> float:
    """Seconds to submit ``xs`` and drain, the device idle at both ends."""
    sync_device(eng.device)
    t0 = time.perf_counter()
    eng.submit_many(list(xs))
    eng.drain()
    sync_device(eng.device)
    return time.perf_counter() - t0


def warm(eng, xs, max_batch: int) -> None:
    """One full batch through ``eng`` before timing it."""
    eng.submit_many([xs[0]] * max_batch)
    eng.drain()


def make_engine(cfg, ta, device, *, max_batch, n_replicas,
                routing="round_robin", backend=None, packed=True,
                pack_planes=True, static_buckets=False,
                engine_cls=ServeEngine, mesh=None):
    # CSA offset off so serving stays on the fused kernels (capability
    # selection would send a CSA-offset read to analog-torch).
    if static_buckets:
        sizes = tuple(b for b in STATIC_BUCKETS if b < max_batch)
        batcher = BatcherConfig(max_batch=max_batch,
                                bucket_sizes=sizes + (max_batch,))
    else:
        batcher = BatcherConfig.for_max_batch(max_batch)
    return engine_cls.from_ta_state(
        ta, cfg, n_replicas=n_replicas, seed=3,
        vcfg=VariationConfig(csa_offset=False),
        ecfg=EngineConfig(batcher=batcher, routing=routing,
                          backend=backend, packed=packed,
                          pack_planes=pack_planes),
        device=device, mesh=mesh)


def _row(summary, wall, n, max_batch):
    summary["wall_s"] = wall
    summary["wall_throughput_rps"] = n / wall
    summary["max_batch"] = max_batch
    return summary


def run_interleaved(engines, xs, max_batch, repeats):
    """Time each engine of ``engines`` (name -> warmed engine) on the same
    requests, runs interleaved: alternating engines run for run keeps a
    ratio robust to host drift in a way two back-to-back sweeps are not.
    Best of ``repeats`` per engine; returns name -> row."""
    best = {name: (float("inf"), None) for name in engines}
    for _ in range(max(1, repeats)):
        for name, eng in engines.items():
            eng.metrics = type(eng.metrics)()
            wall = timed_drain(eng, xs)
            if wall < best[name][0]:
                best[name] = (wall, eng.summary())
    return {name: _row(s, wall, len(xs), max_batch)
            for name, (wall, s) in best.items()}


def run_batched(cfg, ta, xs, device, *, max_batch, n_replicas, routing,
                backend=None, packed=True, static_buckets=False,
                repeats=3, engine_cls=ServeEngine, mesh=None):
    """Submit everything, then drain: batches cut at ``max_batch``.  Best
    of ``repeats`` timed runs on one warmed engine."""
    engine = make_engine(cfg, ta, device, max_batch=max_batch,
                         n_replicas=n_replicas, routing=routing,
                         backend=backend, packed=packed,
                         static_buckets=static_buckets,
                         engine_cls=engine_cls, mesh=mesh)
    warm(engine, xs, max_batch)
    out = run_interleaved({0: engine}, xs, max_batch, repeats)[0]
    out["async"] = engine_cls is AsyncServeEngine
    return out


def run_async_pair(cfg, ta, xs, device, *, max_batch, n_replicas,
                   repeats=3, backend=None, packed=True):
    """Sync vs async on the SAME workload, runs interleaved."""
    engines = {}
    for is_async in (False, True):
        engines[is_async] = make_engine(
            cfg, ta, device, max_batch=max_batch, n_replicas=n_replicas,
            backend=backend, packed=packed,
            engine_cls=AsyncServeEngine if is_async else ServeEngine)
        warm(engines[is_async], xs, max_batch)
    rows = run_interleaved(engines, xs, max_batch, repeats)
    for is_async, row in rows.items():
        row["async"] = is_async
    return rows[False], rows[True]


def run_planes_pair(cfg, ta, xs, device, *, max_batch, n_replicas,
                    repeats=3, packed=True):
    """Dense resident planes vs plane-packed at the headline cell, runs
    interleaved: ``pack_planes=False`` serves on ``analog-cuda-packed``
    (dense float32 conductance and leak planes each dispatch), the
    default on ``analog-cuda-packed2`` (the int32 index bitplane + the
    deviation plane); the resident bytes a dispatch are exact."""
    engines = {}
    for planes in (False, True):
        engines[planes] = make_engine(
            cfg, ta, device, max_batch=max_batch, n_replicas=n_replicas,
            packed=packed, pack_planes=planes)
        warm(engines[planes], xs, max_batch)
    rows = run_interleaved(engines, xs, max_batch, repeats)
    return rows[False], rows[True]


def make_capacity_models(seed: int = 7):
    """The equal-device-budget pair: one 8-class workload, two
    architectures, weights random (serving mechanics, not accuracy).

    * **analog**: the per-class TM (8 classes x 8 clauses = 64 clause
      rows) replicated across R routed chips;
    * **coalesced**: ONE shared pool with HALF the clause rows (clauses
      shared between classes) plus the weighted digital tail."""
    gen = torch.Generator().manual_seed(seed)
    acfg = TMConfig(n_classes=8, clauses_per_class=8, n_features=64,
                    n_states=100)
    ta = sparse_ta(acfg, gen)
    ccfg = CoalescedConfig(n_classes=8, n_clauses=acfg.n_clauses // 2,
                           n_features=64, n_states=100)
    cta = sparse_ta(ccfg, gen)
    w = torch.randint(-ccfg.max_weight, ccfg.max_weight + 1,
                      (ccfg.n_clauses, ccfg.n_classes), generator=gen,
                      dtype=torch.int32)
    return acfg, ta, ccfg, cta, w


def run_capacity_pair(xs, device, *, max_batch, n_replicas=4, repeats=3,
                      packed=True):
    """Replicated analog vs coalesced shared pool, runs interleaved.  Each
    row carries ``host_cpus`` and its total TA-cell budget."""
    acfg, ta, ccfg, cta, w = make_capacity_models()
    ecfg = EngineConfig(batcher=BatcherConfig.for_max_batch(max_batch),
                        routing="round_robin", packed=packed)
    engines = {
        "analog": ServeEngine.from_ta_state(
            ta, acfg, n_replicas=n_replicas, seed=3,
            vcfg=VariationConfig(csa_offset=False), ecfg=ecfg,
            device=device),
        "coalesced": ServeEngine.from_coalesced(cta, w, ccfg, ecfg=ecfg,
                                                device=device),
    }
    for eng in engines.values():
        warm(eng, xs, max_batch)
    rows = run_interleaved(engines, xs, max_batch, repeats)
    for row in rows.values():
        row["host_cpus"] = os.cpu_count()
    rows["analog"]["n_ta_total"] = int(acfg.n_ta) * n_replicas
    rows["coalesced"]["n_ta_total"] = int(ccfg.n_ta)
    return rows["analog"], rows["coalesced"]


def run_serial(cfg, ta, xs, device, *, n_replicas=1, backend=None,
               packed=True, repeats=3):
    """The per-request path: one dispatch per request."""
    engine = make_engine(cfg, ta, device, max_batch=8,
                         n_replicas=n_replicas, backend=backend,
                         packed=packed)
    engine.submit(xs[0])
    engine.drain()                             # warm the bucket-8 path
    best_wall, best_summary = float("inf"), None
    for _ in range(max(1, repeats)):
        engine.metrics = type(engine.metrics)()
        sync_device(device)
        t0 = time.perf_counter()
        for x in xs:
            engine.submit(x)
            engine.drain()                     # force: batch of 1, now
        sync_device(device)
        wall = time.perf_counter() - t0
        if wall < best_wall:
            best_wall, best_summary = wall, engine.summary()
    return _row(best_summary, best_wall, len(xs), 1)


def run_before_unpacked_static(cfg, ta, xs, device, *, repeats=3):
    """Dense uint8 wire, static bucket ladder, the kernels' own tiles:
    the "before" half of the headline before / after pair."""
    saved = api.tuning_snapshot()
    api.clear_tuning()
    try:
        return run_batched(cfg, ta, xs, device, max_batch=64, n_replicas=4,
                           routing="round_robin", packed=False,
                           static_buckets=True, repeats=repeats)
    finally:
        api.restore_tuning(saved)


def run_degraded(cfg, ta, xs, device, *, max_batch, n_replicas=4,
                 packed=True, repeats=3):
    """Ensemble throughput with one replica injured and quarantined,
    beside the same engine's healthy figure.

    An R-replica ensemble engine with health probing (D2D-only noise, so
    probe scores are deterministic): a healthy timed pass, stuck-at faults
    into replica 1, a probe (which quarantines it), a degraded timed pass
    over the healthy majority, then ``RepairPolicy`` and a re-probe.  The
    dispatch shape is unchanged while a chip is down (the vote mask is an
    operand), so ``degraded_vs_healthy`` reads the cost of the vote."""
    ecfg = EngineConfig(batcher=BatcherConfig.for_max_batch(max_batch),
                        routing="ensemble", packed=packed,
                        health=HealthConfig(n_probes=64, seed=5))
    engine = ServeEngine.from_ta_state(
        ta, cfg, n_replicas=n_replicas, seed=3,
        vcfg=VariationConfig(c2c=False, csa_offset=False), ecfg=ecfg,
        device=device)
    warm(engine, xs, max_batch)

    def timed_pass():
        return len(xs) / run_interleaved({0: engine}, xs, max_batch,
                                         repeats)[0]["wall_s"]

    healthy_rps = timed_pass()
    baseline_health = engine.probe()
    engine.inject_faults(
        torch.Generator(device=device).manual_seed(99),
        FaultConfig(stuck_lrs_rate=0.15, stuck_hrs_rate=0.15),
        replicas=[1])
    injured_health = engine.probe()            # quarantines replica 1
    quarantined = sorted(engine.quarantined)
    degraded_rps = timed_pass()                # healthy-majority serving
    tick = RepairPolicy(engine, RepairConfig()).check()
    row = engine.summary()
    row.update({
        "max_batch": max_batch,
        "healthy_rps": healthy_rps,
        "degraded_rps": degraded_rps,
        "degraded_vs_healthy": degraded_rps / healthy_rps,
        "baseline_health": baseline_health,
        "injured_health": injured_health,
        "quarantined_during_degraded": quarantined,
        "repairs": tick["repairs"],
        "post_repair_health": tick["health"],
        "recovered": not engine.quarantined,
    })
    return row


def write_report(report, path):
    if not hostdev.is_rank0():
        return
    with open(path, "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(f"wrote {path}")


def run_sharded(cfg, ta, xs, device, *, repeats=3, backend=None,
                packed=True):
    """The sharded rows on a ``replica`` mesh of every rank: R in {4, 8}
    where the ranks divide it (none with one rank)."""
    ranks = world_size()
    if ranks == 1:
        return []
    mesh = make_replica_mesh(ranks, 1, device_type=device.type)
    rows = []
    for n_replicas, use_async, routing in (
            (4, False, "round_robin"), (4, True, "round_robin"),
            (8, True, "round_robin"), (8, False, "ensemble")):
        if n_replicas % ranks:
            continue
        row = run_batched(cfg, ta, xs, device, max_batch=64,
                          n_replicas=n_replicas, routing=routing,
                          backend=backend, packed=packed, repeats=repeats,
                          mesh=mesh,
                          engine_cls=(AsyncServeEngine if use_async
                                      else ServeEngine))
        row["mesh"] = mesh_shape(mesh)
        rows.append(row)
    return rows


def sharded_only(args, cfg, ta, xs, device, where, activity):
    """The bench on several ranks: the sharded rows alone (module
    docstring); the smoke passes when every row served without a
    fallback."""
    print = hostdev.rank0_print
    rows = run_sharded(cfg, ta, xs, device, repeats=args.repeats,
                       backend=args.backend, packed=args.packed)
    for row in rows:
        print(f"[serve_bench_torch]   sharded R={row['n_replicas']} "
              f"batch=64 ({row['routing']}"
              f"{', async' if row['async'] else ''}): "
              f"{row['wall_throughput_rps']:.1f} req/s on {row['backend']}, "
              f"mesh {row['mesh']}, overlap "
              f"{100 * row['overlap_fraction']:.0f}%", flush=True)
    ok = bool(rows) and all(r["forward_fallbacks"] == [] for r in rows)
    report = {"smoke": args.smoke, "smoke_ok": ok, "device": where,
              "torch": torch.__version__, "ranks": world_size(),
              "model_activity": activity, "host_cpus": os.cpu_count(),
              "requests": args.requests, "repeats": args.repeats,
              "sharded": rows}
    print(json.dumps(report, default=str), flush=True)
    out = args.smoke_out if args.smoke else args.out
    if out:
        write_report(report, out)
    if args.smoke and not ok:
        raise SystemExit(1)
    return report


def main(argv=None):
    """The bench; with ``--host-devices N``, on N spawned host ranks (the
    exit code then)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    code = hostdev.run_main(main, argv)
    if code is not None:
        return code
    with hostdev.launched_group():
        return _bench(argv)


def _bench(argv):
    print = hostdev.rank0_print
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=192,
                    help="requests per batched configuration")
    ap.add_argument("--serial-requests", type=int, default=48,
                    help="requests for the serial baseline (slow path)")
    ap.add_argument("--backend", default=None, choices=ANALOG_BACKENDS,
                    help="forward-backend preference (repro_torch.api name)")
    ap.add_argument("--packed", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="32-bit literal wire format (default on)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs per configuration (best reported)")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke: one sweep cell and the pairs, the "
                         "degraded leg, pass/fail checks")
    ap.add_argument("--smoke-out", default=None,
                    help="write the smoke report JSON here")
    ap.add_argument("--out", default=None,
                    help="write the full report JSON here (default: print "
                         "it only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions on the host)")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="run on N spawned host ranks (one gloo group), "
                         "which adds the sharded rows")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.smoke:
        args.requests = min(args.requests, 64)
        args.serial_requests = min(args.serial_requests, 8)
        args.repeats = 1
    where = device_label(device)
    print(f"[serve_bench_torch] on {where}", flush=True)

    cfg, ta = make_model(0)
    xs = (torch.rand((args.requests, cfg.n_features),
                     generator=torch.Generator().manual_seed(1)) < 0.4
          ).numpy().astype(np.uint8)

    activity = model_activity(cfg, ta, xs)
    print(f"[serve_bench_torch] {activity_line('model', activity)}",
          flush=True)
    if world_size() > 1:
        return sharded_only(args, cfg, ta, xs, device, where, activity)

    serial = run_serial(cfg, ta, xs[:args.serial_requests], device,
                        backend=args.backend, packed=args.packed,
                        repeats=args.repeats)
    print(f"[serve_bench_torch]   serial: "
          f"{serial['wall_throughput_rps']:.1f} req/s", flush=True)

    def vs_serial(row):
        row["speedup_vs_serial"] = (row["wall_throughput_rps"]
                                    / serial["wall_throughput_rps"])
        return row

    sweep = []
    grid = (((4, 64),) if args.smoke
            else tuple((r, b) for r in (1, 2, 4) for b in (8, 32, 64)))
    for n_replicas, max_batch in grid:
        row = vs_serial(run_batched(
            cfg, ta, xs, device, max_batch=max_batch, n_replicas=n_replicas,
            routing="round_robin", backend=args.backend, packed=args.packed,
            repeats=args.repeats))
        sweep.append(row)
        print(f"[serve_bench_torch]   R={n_replicas} batch={max_batch}: "
              f"{row['wall_throughput_rps']:.1f} req/s "
              f"({row['speedup_vs_serial']:.1f}x serial), "
              f"p99 {row['p99_ms']:.2f} ms [{row['backend']}, "
              f"{row['bytes_per_dispatch']:.0f} B/dispatch, "
              f"buckets {row['bucket_sizes']}]", flush=True)
    ens = vs_serial(run_batched(
        cfg, ta, xs, device, max_batch=64, n_replicas=4, routing="ensemble",
        backend=args.backend, packed=args.packed, repeats=args.repeats))
    print(f"[serve_bench_torch]   ensemble R=4 batch=64: "
          f"{ens['wall_throughput_rps']:.1f} req/s", flush=True)

    sync_row, async_row = run_async_pair(
        cfg, ta, xs, device, max_batch=64, n_replicas=4,
        backend=args.backend, packed=args.packed, repeats=args.repeats)
    for row in (sync_row, async_row):
        vs_serial(row)
    async_speedup = (async_row["wall_throughput_rps"]
                     / sync_row["wall_throughput_rps"])
    print(f"[serve_bench_torch]   async R=4 batch=64: "
          f"{async_row['wall_throughput_rps']:.1f} req/s = "
          f"{async_speedup:.2f}x sync "
          f"({sync_row['wall_throughput_rps']:.1f} req/s paired), "
          f"overlap {100 * async_row['overlap_fraction']:.0f}%", flush=True)

    planes_before, planes_after = run_planes_pair(
        cfg, ta, xs, device, max_batch=64, n_replicas=4, packed=args.packed,
        repeats=args.repeats)
    resident_ratio = (
        planes_after["resident_bytes_per_dispatch"]
        / planes_before["resident_bytes_per_dispatch"]
        if planes_before["resident_bytes_per_dispatch"] else None)
    print(f"[serve_bench_torch]   planes R=4 batch=64: "
          f"{planes_after['backend']} resident "
          f"{planes_before['resident_bytes_per_dispatch']:.0f} -> "
          f"{planes_after['resident_bytes_per_dispatch']:.0f} B/dispatch "
          f"({resident_ratio:.4f}x), "
          f"{planes_after['wall_throughput_rps']:.1f} vs "
          f"{planes_before['wall_throughput_rps']:.1f} req/s paired",
          flush=True)

    cap_analog, cap_coalesced = run_capacity_pair(
        xs, device, max_batch=64, n_replicas=4, packed=args.packed,
        repeats=args.repeats)
    cap_ratio = (cap_coalesced["wall_throughput_rps"]
                 / cap_analog["wall_throughput_rps"])
    print(f"[serve_bench_torch]   capacity batch=64: coalesced "
          f"{cap_coalesced['wall_throughput_rps']:.1f} req/s on "
          f"{cap_coalesced['backend']} "
          f"({cap_coalesced['n_ta_total']} TA cells) vs analog R=4 "
          f"{cap_analog['wall_throughput_rps']:.1f} req/s on "
          f"{cap_analog['backend']} ({cap_analog['n_ta_total']} TA "
          f"cells) = {cap_ratio:.2f}x", flush=True)

    if not args.smoke:
        print("[serve_bench_torch]   sharded rows skipped: one rank (pass "
              "--host-devices N, or run under torch.distributed.run)",
              flush=True)

    common = {"device": where, "torch": torch.__version__,
              "model_activity": activity,
              "host_cpus": os.cpu_count(), "requests": args.requests,
              "repeats": args.repeats, "serial_baseline": serial,
              "sweep": sweep, "ensemble": ens,
              "sync_r4_b64_paired": sync_row, "async_r4_b64": async_row,
              "async_speedup_vs_sync_r4_b64": async_speedup,
              "planes_before_r4_b64": planes_before,
              "planes_after_r4_b64": planes_after,
              "resident_bytes_ratio_planes": resident_ratio,
              "capacity_analog_r4_b64": cap_analog,
              "capacity_coalesced_b64": cap_coalesced,
              "capacity_coalesced_vs_analog": cap_ratio}

    if args.smoke:
        deg = run_degraded(cfg, ta, xs, device, max_batch=64, n_replicas=4,
                           packed=args.packed, repeats=args.repeats)
        print(f"[serve_bench_torch]   degraded R=4 batch=64: "
              f"{deg['degraded_rps']:.1f} req/s with "
              f"{deg['quarantined_during_degraded']} quarantined = "
              f"{deg['degraded_vs_healthy']:.2f}x healthy "
              f"({deg['healthy_rps']:.1f} req/s), "
              f"recovered={deg['recovered']}")
        row = sweep[0]
        coalesced_ok = (
            cap_coalesced["backend"].startswith("coalesced")
            and cap_coalesced["forward_fallbacks"] == [])
        degraded_ok = (deg["quarantined_during_degraded"] == [1]
                       and deg["recovered"]
                       and deg["forward_fallbacks"] == [])
        planes_ok = (
            planes_after["backend"] == "analog-cuda-packed2"
            and planes_after["forward_fallbacks"] == []
            and planes_after["resident_bytes_per_dispatch"]
            < planes_before["resident_bytes_per_dispatch"])
        ok = (row["speedup_vs_serial"] >= 1.5
              and row["forward_fallbacks"] == []
              and async_row["forward_fallbacks"] == []
              and coalesced_ok and degraded_ok and planes_ok)
        report = {"smoke": True, "smoke_ok": ok, **common,
                  "degraded_ensemble_r4_b64": deg}
        print(f"[serve_bench_torch] SMOKE {'PASS' if ok else 'FAIL'}: "
              f"{row['speedup_vs_serial']:.1f}x serial on "
              f"{row['backend']}, async {async_speedup:.2f}x sync, "
              f"coalesced leg on {cap_coalesced['backend']} "
              f"({'clean' if coalesced_ok else 'FALLBACK'}), "
              f"degraded leg {'healed' if degraded_ok else 'FAILED'}, "
              f"planes leg {resident_ratio:.4f}x resident "
              f"({'clean' if planes_ok else 'FAILED'})")
        print(json.dumps(report, default=str), flush=True)
        if args.smoke_out:
            write_report(report, args.smoke_out)
        if not ok:
            raise SystemExit(1)
        return report

    before = run_before_unpacked_static(cfg, ta, xs, device,
                                        repeats=args.repeats)
    print(f"[serve_bench_torch]   before R=4 batch=64 (uint8 wire, static "
          f"ladder, the kernels' own tiles): "
          f"{before['wall_throughput_rps']:.1f} req/s "
          f"[{before['backend']}, "
          f"{before['bytes_per_dispatch']:.0f} B/dispatch]")
    at64 = [r for r in sweep
            if r["max_batch"] == 64 and r["n_replicas"] == 1]
    report = {
        "model": {"n_clauses": cfg.n_clauses, "n_literals": cfg.n_literals,
                  "n_classes": cfg.n_classes},
        **common,
        "before_unpacked_static": before,
        "speedup_batch64_vs_serial": at64[0]["speedup_vs_serial"],
        "headline_r4_b64_rps": sync_row["wall_throughput_rps"],
        "headline_speedup_vs_before": (sync_row["wall_throughput_rps"]
                                       / before["wall_throughput_rps"]),
        "bytes_per_dispatch_before": before["bytes_per_dispatch"],
        "bytes_per_dispatch_after": sync_row["bytes_per_dispatch"],
    }
    print(json.dumps(report, default=str), flush=True)
    if args.out:
        write_report(report, args.out)
    return report


if __name__ == "__main__":
    main()
