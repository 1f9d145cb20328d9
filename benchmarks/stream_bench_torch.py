"""Streaming KWS-6 serving benchmark of the PyTorch port: sessions x
hop-rate sweep (port of ``benchmarks/stream_bench.py``).

S concurrent keyword sessions each complete one window a hop and every
window is one classifier read.  This bench measures the streaming front
end (``repro_torch.serve.stream``) end to end at the synthetic KWS-6
model shape, with ``lazy_tune=True``: the first engine at a shape bucket
the tuning table lacks for this device measures it once and every later
engine reuses the entry.

Rows:

* **sweep** — sessions in {1, 4, 16} x hop in {2, 4, 8} on the
  synchronous engine: wall-clock decisions/s, per-session decision
  latency, padding and bytes from the shared batcher;
* **sync / async pair** — 8 sessions at hop 4, the two engines timed
  interleaved run for run;
* **mixed_qos** — two ``latency`` and two ``bulk`` sessions saturating
  ONE engine, bulk feeding bursts under a long batching deadline while
  latency windows cut early; the full run asserts latency-class p99 (and
  queue p99) below bulk's;
* **anomaly** — sensor streams in ``margin`` decision mode on the
  latency class, on the same windowing and dispatch path;
* **sharded** (with more than one rank: ``--host-devices N``, or under
  ``torch.distributed.run``) — the 8-session cell with the replica pool
  split over a ``replica`` mesh of all the ranks (R in {4, 8} where the
  ranks divide it), each checked bit-exact first; the smoke is then the
  mesh leg of the bit-exactness check.  The ranks share the host (and,
  on the card, the card), so with more than one rank the bench runs
  these alone: a single-device row measured beside the other ranks'
  work would read their contention.  Every rank runs every row, and rank
  0 reports.

Bit-exactness is asserted before timing: the streamed per-window
predictions equal offline ``api.predict`` over
``StreamingBooleanizer.transform_offline`` of the same frames (sync, and
async in the smoke), and the streamed anomaly margins equal the digital
TM's on the same windows.

The models are the reference's training-free sparse TMs (10 % random
includes): at these widths their clauses hardly ever fire, so nearly
every class sum is 0 and the bit-exact checks compare sums that are
nearly all 0; the rows are readings of the streaming mechanics on those
models.  ``model_activity`` in the report says how many (window, clause)
pairs fire and how many class sums are non-zero.  They sit on
booleanizers fitted to frames drawn on host ``torch.Generator``s (KWS
seed 0, anomaly seed 11; session ``s``'s stream seed 7 + s, mixed-QoS
31 / 41 + s, sensors 21 + s).  The times are the device's that ran
them (the card's name and power limit head the report; ``--device cpu``
runs the plain versions on the host).  The report is printed as one
JSON line and written to a file only with ``--out`` (``--smoke-out``
for the smoke's).

  PYTHONPATH=src python -m benchmarks.stream_bench_torch
  PYTHONPATH=src python -m benchmarks.stream_bench_torch --smoke
  PYTHONPATH=src python -m benchmarks.stream_bench_torch --smoke --device cpu
  PYTHONPATH=src python -m benchmarks.stream_bench_torch --smoke \\
      --device cpu --host-devices 4          # + the mesh leg
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
from repro_torch.core.booleanize import StreamingBooleanizer, fit_quantile
from repro_torch.core.tm import TMConfig
from repro_torch.core.variations import VariationConfig
from repro_torch.data.tm_datasets import (synthetic_kws6,
                                          synthetic_sensor_anomaly)
from repro_torch.distributed.sharding import mesh_shape, world_size
from repro_torch.launch import hostdev
from repro_torch.launch.chaos import sparse_ta
from repro_torch.launch.mesh import make_replica_mesh
from repro_torch.launch.stream import ANALOG_BACKENDS
from repro_torch.serve import (QOS_BULK, QOS_LATENCY, AsyncServeEngine,
                               BatcherConfig, EngineConfig, ServeEngine,
                               StreamConfig, StreamServer, margin_of)

from benchmarks.serve_bench_torch import (activity_line, model_activity,
                                          sync_device, write_report)

# Full-size stream geometry (window * mels * bits = 384 Boolean
# features, 6 x 10 clauses).
FULL = dict(n_mels=12, bits=4, window=8, clauses_per_class=10)
# Smoke geometry: the same code paths at a small shape.
SMOKE = dict(n_mels=6, bits=2, window=4, clauses_per_class=8)

# Anomaly workload geometry: 2-class margin-mode detection over
# multichannel sensor streams.
ANOMALY_FULL = dict(n_sensors=8, bits=2, window=8, hop=4,
                    clauses_per_class=10)
ANOMALY_SMOKE = dict(n_sensors=4, bits=2, window=4, hop=2,
                     clauses_per_class=8)


def _kws_frames(seed, n_utterances, n_frames, n_mels):
    return synthetic_kws6(torch.Generator().manual_seed(seed),
                          n_utterances=n_utterances, n_frames=n_frames,
                          n_mels=n_mels, device="cpu")


def _sensor_frames(seed, n_streams, n_frames, n_sensors):
    return synthetic_sensor_anomaly(torch.Generator().manual_seed(seed),
                                    n_streams=n_streams, n_frames=n_frames,
                                    n_sensors=n_sensors, device="cpu")


def make_kws_model(device, *, n_mels, bits, window, clauses_per_class,
                   seed=0):
    """Synthetic KWS-6 booleanizer + training-free sparse TM at the
    streaming shape (the bench measures serving mechanics, not accuracy:
    ``launch/stream.py`` trains a real one)."""
    frames, _ = _kws_frames(seed, 24, 32, n_mels)
    booleanizer = fit_quantile(frames.numpy().reshape(-1, n_mels),
                               bits=bits, device=device)
    cfg = TMConfig(n_classes=6, clauses_per_class=clauses_per_class,
                   n_features=window * n_mels * bits, n_states=100)
    return cfg, sparse_ta(cfg, torch.Generator().manual_seed(seed + 1)), \
        booleanizer


def make_anomaly_model(device, *, n_sensors, bits, window, hop,
                       clauses_per_class, seed=11):
    """Sensor-anomaly booleanizer + training-free sparse 2-class TM at the
    streaming shape (mechanics, not accuracy)."""
    frames, _ = _sensor_frames(seed, 12, 32, n_sensors)
    booleanizer = fit_quantile(frames.numpy().reshape(-1, n_sensors),
                               bits=bits, device=device)
    cfg = TMConfig(n_classes=2, clauses_per_class=clauses_per_class,
                   n_features=window * n_sensors * bits, n_states=100)
    return cfg, sparse_ta(cfg, torch.Generator().manual_seed(seed + 1)), \
        booleanizer


def sensor_streams(n_sessions, n_frames, n_sensors, seed=21):
    """One long sensor stream a session."""
    return [_sensor_frames(seed + s, 1, n_frames, n_sensors)[0][0].numpy()
            for s in range(n_sessions)]


def window_activity(cfg, ta, booleanizer, window, hop, streams) -> dict:
    """``model_activity`` over the windows of ``streams``."""
    sb = StreamingBooleanizer(booleanizer, window, hop)
    return model_activity(cfg, ta, np.concatenate(
        [sb.transform_offline(x) for x in streams]))


def session_streams(n_sessions, n_frames, n_mels, seed=7):
    """One long frame stream a session (concatenated utterances)."""
    return [_kws_frames(seed + s, max(1, n_frames // 32), 32, n_mels)[0]
            .numpy().reshape(-1, n_mels)[:n_frames]
            for s in range(n_sessions)]


def make_engine(cfg, ta, device, *, engine_cls=ServeEngine, backend=None,
                packed=True, max_batch=64, n_replicas=2,
                routing="round_robin", nominal=False, batcher=None,
                mesh=None):
    # Timed cells run with the realistic noise model (C2C on); the
    # bit-exactness checks build their OWN engine at nominal(): the
    # streamed == offline invariant holds only without read noise.
    return engine_cls.from_ta_state(
        ta, cfg, n_replicas=n_replicas, seed=3,
        vcfg=(VariationConfig.nominal() if nominal
              else VariationConfig(csa_offset=False)),
        ecfg=EngineConfig(batcher=(batcher if batcher is not None
                                   else BatcherConfig.for_max_batch(
                                       max_batch)),
                          routing=routing, backend=backend, packed=packed,
                          lazy_tune=True),
        device=device, mesh=mesh)


def stream_once(engine, booleanizer, scfg, streams, tag):
    """Feed every session one hop of frames a tick (round robin),
    pumping between ticks; drain at the end.  Returns (wall_s, server,
    n_decisions)."""
    server = StreamServer(engine, booleanizer, scfg)
    n_frames = min(len(s) for s in streams)
    sync_device(engine.device)
    t0 = time.perf_counter()
    for lo in range(0, n_frames, scfg.hop):
        for i, stream in enumerate(streams):
            server.feed(f"{tag}-s{i}", stream[lo:lo + scfg.hop])
        server.pump()
    server.drain()
    sync_device(engine.device)
    wall = time.perf_counter() - t0
    return wall, server, sum(len(s.decisions)
                             for s in server.sessions.values())


def _feed_all(server, streams, hop, prefix):
    for i, stream in enumerate(streams):
        for lo in range(0, len(stream), hop):
            server.feed(f"{prefix}-s{i}", stream[lo:lo + hop])
            server.pump()
    server.drain()


def check_bit_exact(cfg, ta, booleanizer, scfg, streams, device,
                    **engine_kw):
    """Streamed per-window preds == offline batched ``api.predict`` over
    the same windows.  Builds its own engine at
    ``VariationConfig.nominal()``: the invariant is promised only without
    read noise."""
    engine = make_engine(cfg, ta, device, nominal=True, **engine_kw)
    server = StreamServer(engine, booleanizer, scfg)
    _feed_all(server, streams, scfg.hop, "check")
    sb = StreamingBooleanizer(booleanizer, scfg.window, scfg.hop)
    for i, stream in enumerate(streams):
        rows = torch.from_numpy(sb.transform_offline(stream)).to(device)
        offline = api.predict(engine.state, rows).cpu().numpy()
        streamed = np.array(
            [d.pred for d in server.sessions[f"check-s{i}"].decisions])
        np.testing.assert_array_equal(streamed, offline)
    return True


def check_margin_bit_exact(acfg, ata, booleanizer, scfg, streams, device):
    """Streamed margin-mode decisions == the digital oracle on the same
    windows: margins equal ``margin_of`` over ``tm.forward`` class sums
    and preds follow the threshold rule.  One replica at nominal, so the
    oracle comparison is direct."""
    engine = make_engine(acfg, ata, device, nominal=True, n_replicas=1)
    server = StreamServer(engine, booleanizer, scfg)
    _feed_all(server, streams, scfg.hop, "anom")
    sb = StreamingBooleanizer(booleanizer, scfg.window, scfg.hop)
    mc = scfg.margin_class
    for i, stream in enumerate(streams):
        rows = torch.from_numpy(sb.transform_offline(stream)).to(device)
        sums = tm.forward(ata.to(device), rows, acfg).cpu().numpy()
        offline_margins = np.array([margin_of(s, mc) for s in sums])
        decs = server.sessions[f"anom-s{i}"].decisions
        streamed_margins = np.array([d.margin for d in decs])
        np.testing.assert_array_equal(streamed_margins, offline_margins)
        for d, s in zip(decs, sums):
            want = (mc if d.margin >= scfg.margin_threshold
                    else int(np.delete(np.arange(acfg.n_classes), mc)[
                        np.delete(s, mc).argmax()]))
            assert d.pred == want, (d, s)
    return True


def run_mixed_qos_cell(cfg, ta, booleanizer, device, *, window, hop, frames,
                       backend=None, packed=True, n_replicas=2,
                       bulk_wait_s=0.25, latency_wait_s=1e-3,
                       bulk_burst=4, max_batch=64):
    """Two latency + two bulk sessions saturating ONE shared engine.
    Latency sessions feed one hop a tick under a ~1 ms batching deadline;
    bulk sessions feed ``bulk_burst`` hops a tick under a long deadline,
    so bulk windows accumulate across ticks and ride big buckets while
    latency windows cut early.  Returns the summary row with the
    per-class ``qos`` percentile block."""
    bcfg = BatcherConfig.for_max_batch(max_batch, max_wait_s=bulk_wait_s,
                                       latency_max_wait_s=latency_wait_s)
    engine = make_engine(cfg, ta, device, backend=backend, packed=packed,
                         n_replicas=n_replicas, batcher=bcfg)
    scfg = StreamConfig(window=window, hop=hop, vote=5)
    n_mels = cfg_mels(booleanizer)
    lat_streams = session_streams(2, frames, n_mels, seed=31)
    bulk_streams = session_streams(2, frames * bulk_burst, n_mels, seed=41)
    # synthetic_kws6 emits whole utterances: clamp to what both stream
    # sets hold so every tick's slices are non-empty.
    frames = min(min(len(s) for s in lat_streams),
                 min(len(s) for s in bulk_streams) // bulk_burst)

    def tick_feed(server, lo):
        for i in range(2):
            server.feed(f"lat-s{i}", lat_streams[i][lo:lo + hop])
            blo = lo * bulk_burst
            server.feed(f"bulk-s{i}",
                        bulk_streams[i][blo:blo + hop * bulk_burst])

    # Warm every bucket of the ladder, so no first dispatch of a bucket
    # lands inside the timed loop, then reset the metrics.
    sb = StreamingBooleanizer(booleanizer, window, hop)
    row0 = sb.transform_offline(lat_streams[0][:window])[0]
    for b in engine.batcher.cfg.bucket_sizes:
        for _ in range(b):
            engine.submit(row0)
        engine.drain()
    engine.metrics = type(engine.metrics)()

    server = StreamServer(engine, booleanizer, scfg)
    for i in range(2):                       # pin each session's class
        server.session(f"lat-s{i}", qos=QOS_LATENCY)
        server.session(f"bulk-s{i}", qos=QOS_BULK)
    sync_device(device)
    t0 = time.perf_counter()
    n_dec = 0
    for lo in range(0, frames, hop):
        tick_feed(server, lo)
        n_dec += len(server.pump())
    n_dec += len(server.drain())
    sync_device(device)
    wall = time.perf_counter() - t0
    row = dict(server.summary())
    row.pop("sessions", None)
    row.update(latency_sessions=2, bulk_sessions=2, bulk_burst=bulk_burst,
               hop=hop, window=window, frames_per_session=frames,
               bulk_wait_s=bulk_wait_s, latency_wait_s=latency_wait_s,
               decisions=n_dec, wall_s=wall,
               decisions_per_s_wall=n_dec / wall, n_replicas=n_replicas)
    return row


def run_anomaly_cell(acfg, ata, booleanizer, geo, device, *, frames,
                     sessions=4, backend=None, packed=True, n_replicas=2):
    """Sensor sessions in margin decision mode on the latency class:
    times the cell and reports alert mechanics (decision count, alert
    fraction, median margin)."""
    engine = make_engine(acfg, ata, device, backend=backend, packed=packed,
                         n_replicas=n_replicas)
    scfg = StreamConfig(window=geo["window"], hop=geo["hop"], vote=3,
                        qos=QOS_LATENCY, decision="margin",
                        margin_class=1, margin_threshold=0.0)
    streams = sensor_streams(sessions, frames, geo["n_sensors"])
    wall, server, _ = stream_once(engine, booleanizer, scfg, streams,
                                  "sensor")
    decs = [d for s in server.sessions.values() for d in s.decisions]
    margins = np.array([d.margin for d in decs])
    row = dict(server.summary())
    row.pop("sessions", None)
    row.update(sessions=sessions, window=geo["window"], hop=geo["hop"],
               frames_per_session=frames, decisions=len(decs),
               wall_s=wall, decisions_per_s_wall=len(decs) / wall,
               alert_fraction=(float(np.mean(
                   [d.pred == scfg.margin_class for d in decs]))
                   if decs else None),
               margin_p50=(float(np.median(margins)) if len(margins)
                           else None),
               n_replicas=n_replicas)
    return row


def run_cell(cfg, ta, booleanizer, device, *, sessions, hop, window, vote=5,
             frames=96, repeats=3, engine_cls=ServeEngine, backend=None,
             packed=True, n_replicas=2, routing="round_robin", mesh=None):
    """One timed cell (best of ``repeats``, warmed engine)."""
    engine = make_engine(cfg, ta, device, engine_cls=engine_cls,
                         backend=backend, packed=packed,
                         n_replicas=n_replicas, routing=routing, mesh=mesh)
    scfg = StreamConfig(window=window, hop=hop, vote=vote)
    streams = session_streams(sessions, frames, cfg_mels(booleanizer))
    stream_once(engine, booleanizer, scfg, streams, "warm")
    best = (float("inf"), None, 0)
    for r in range(max(1, repeats)):
        engine.metrics = type(engine.metrics)()
        wall, server, n_dec = stream_once(engine, booleanizer, scfg,
                                          streams, f"r{r}")
        if wall < best[0]:
            best = (wall, server.summary(), n_dec)
    wall, summary, n_dec = best
    row = dict(summary)
    # per-session summaries are bulky: keep an aggregate
    sess = row.pop("sessions", {})
    lat = [v["p50_ms"] for v in sess.values()]
    row.update(sessions=sessions, hop=hop, window=window,
               frames_per_session=frames, decisions=n_dec,
               wall_s=wall, decisions_per_s_wall=n_dec / wall,
               async_engine=engine_cls is AsyncServeEngine,
               n_replicas=n_replicas, routing=routing,
               session_p50_ms_median=(float(np.median(lat)) if lat
                                      else None),
               per_session_decisions=(n_dec / sessions if sessions else 0))
    return row, engine


def cfg_mels(booleanizer) -> int:
    return booleanizer.thresholds.shape[0]


def run_pair(cfg, ta, booleanizer, device, *, sessions, hop, window, frames,
             repeats, backend=None, packed=True, n_replicas=2):
    """Sync vs async on the SAME streaming workload, runs interleaved."""
    scfg = StreamConfig(window=window, hop=hop, vote=5)
    streams = session_streams(sessions, frames, cfg_mels(booleanizer))
    engines = {}
    for is_async in (False, True):
        eng = make_engine(cfg, ta, device,
                          engine_cls=(AsyncServeEngine if is_async
                                      else ServeEngine),
                          backend=backend, packed=packed,
                          n_replicas=n_replicas)
        stream_once(eng, booleanizer, scfg, streams, "warm")
        engines[is_async] = eng
    best = {False: (float("inf"), None, 0), True: (float("inf"), None, 0)}
    for r in range(max(1, repeats)):
        for is_async in (False, True):
            eng = engines[is_async]
            eng.metrics = type(eng.metrics)()
            wall, server, n_dec = stream_once(eng, booleanizer, scfg,
                                              streams, f"p{r}")
            if wall < best[is_async][0]:
                best[is_async] = (wall, server.summary(), n_dec)
    rows = {}
    for is_async in (False, True):
        wall, summary, n_dec = best[is_async]
        row = dict(summary)
        row.pop("sessions", None)
        row.update(sessions=sessions, hop=hop, window=window, wall_s=wall,
                   decisions=n_dec, decisions_per_s_wall=n_dec / wall,
                   async_engine=is_async, n_replicas=n_replicas)
        rows[is_async] = row
    return rows[False], rows[True]


def run_sharded(cfg, ta, booleanizer, device, scfg, streams, *, window,
                frames, repeats, backend=None, packed=True):
    """The sharded rows on a ``replica`` mesh of every rank, each checked
    bit-exact first (none with one rank)."""
    ranks = world_size()
    if ranks == 1:
        return []
    mesh = make_replica_mesh(ranks, 1, device_type=device.type)
    rows = []
    for n_replicas, use_async, routing in ((4, False, "round_robin"),
                                           (4, True, "round_robin"),
                                           (8, False, "ensemble")):
        if n_replicas % ranks:
            continue
        cls = AsyncServeEngine if use_async else ServeEngine
        check_bit_exact(cfg, ta, booleanizer, scfg, streams, device,
                        engine_cls=cls, mesh=mesh, n_replicas=n_replicas,
                        routing=routing, packed=packed)
        row, _ = run_cell(cfg, ta, booleanizer, device, sessions=8, hop=4,
                          window=window, frames=frames, repeats=repeats,
                          backend=backend, packed=packed, mesh=mesh,
                          n_replicas=n_replicas, routing=routing,
                          engine_cls=cls)
        row["mesh"] = mesh_shape(mesh)
        rows.append(row)
    return rows


def sharded_only(args, cfg, ta, booleanizer, device, geo, where):
    """The bench on several ranks (module docstring): the smoke is the
    mesh leg of the bit-exactness check, the full run the sharded rows."""
    print = hostdev.rank0_print
    ranks = world_size()
    scfg = StreamConfig(window=geo["window"], hop=4, vote=5)
    streams2 = session_streams(2, min(args.frames, 64), geo["n_mels"])
    report = {"smoke": args.smoke, "device": where,
              "torch": torch.__version__, "ranks": ranks}
    if args.smoke:
        check_bit_exact(cfg, ta, booleanizer, scfg, streams2, device,
                        mesh=make_replica_mesh(ranks, 1,
                                               device_type=device.type),
                        n_replicas=ranks, routing="ensemble",
                        packed=args.packed)
        print(f"[stream_bench_torch] bit-exactness: streamed == offline "
              f"(mesh R={ranks} ensemble)", flush=True)
        report.update(smoke_ok=True, mesh_bit_exact_checked=True)
    else:
        rows = run_sharded(cfg, ta, booleanizer, device, scfg, streams2,
                           window=geo["window"], frames=args.frames,
                           repeats=args.repeats, backend=args.backend,
                           packed=args.packed)
        for row in rows:
            print(f"[stream_bench_torch]   sharded R={row['n_replicas']} "
                  f"({row['routing']}"
                  f"{', async' if row['async_engine'] else ''}): "
                  f"{row['decisions_per_s_wall']:.0f} decisions/s on "
                  f"{row['backend']}, mesh {row['mesh']} (bit-exact)",
                  flush=True)
        report["sharded"] = rows
    print(json.dumps(report, default=str), flush=True)
    out = args.smoke_out if args.smoke else args.out
    if out:
        write_report(report, out)
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
    ap.add_argument("--frames", type=int, default=96,
                    help="frames streamed a session a cell")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs a cell (best reported)")
    ap.add_argument("--backend", default=None, choices=ANALOG_BACKENDS,
                    help="forward-backend preference (repro_torch.api name)")
    ap.add_argument("--packed", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--smoke", action="store_true",
                    help="smoke: small model, one cell, the bit-exactness "
                         "and lazy-tuning assertions")
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
                         "which adds the mesh rows")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    geo = SMOKE if args.smoke else FULL
    if args.smoke:
        args.frames = min(args.frames, 48)
        args.repeats = 1
    window = geo["window"]
    where = device_label(device)

    cfg, ta, booleanizer = make_kws_model(device, **geo)
    shape_key = api.shape_bucket_key(cfg.n_clauses, cfg.n_literals)
    print(f"[stream_bench_torch] KWS-6 model: C={cfg.n_clauses} "
          f"L={cfg.n_literals} (shape bucket {shape_key}) on {where}",
          flush=True)

    if world_size() > 1:
        return sharded_only(args, cfg, ta, booleanizer, device, geo, where)

    # Lazy shape-aware tuning: the first engine construction measures this
    # (backend, shape bucket) cell unless the table has it; the second
    # must reuse it.
    t0 = time.perf_counter()
    eng0 = make_engine(cfg, ta, device, backend=args.backend,
                       packed=args.packed, n_replicas=args.replicas)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng1 = make_engine(cfg, ta, device, backend=args.backend,
                       packed=args.packed, n_replicas=args.replicas)
    t_second = time.perf_counter() - t0
    tuning = eng1.tuning or {}
    lazy_info = {
        "backend": eng1.backend.name, "shape_key": shape_key,
        "tiles": tuning.get("tiles"),
        "bucket_sizes": tuning.get("bucket_sizes"),
        "lazy": bool(tuning.get("lazy")),
        "first_construction_s": t_first, "reuse_construction_s": t_second,
    }
    assert eng0.tuning == eng1.tuning, "lazy entry must be reused"
    src = ("measured lazily once" if lazy_info["lazy"]
           else "from the committed table")
    print(f"[stream_bench_torch] shape tuning @ {shape_key}: "
          f"tiles={lazy_info['tiles']} buckets={lazy_info['bucket_sizes']} "
          f"({src}; constructions {t_first:.2f}s then {t_second:.2f}s)",
          flush=True)

    scfg = StreamConfig(window=window, hop=4, vote=5)
    streams2 = session_streams(2, min(args.frames, 64), geo["n_mels"])
    activity = {"kws": window_activity(cfg, ta, booleanizer, window, 4,
                                       streams2)}
    print(f"[stream_bench_torch] "
          f"{activity_line('KWS model', activity['kws'])}", flush=True)
    check_bit_exact(cfg, ta, booleanizer, scfg, streams2, device,
                    backend=args.backend, packed=args.packed,
                    n_replicas=args.replicas)
    print("[stream_bench_torch] bit-exactness: streamed == offline batched "
          "predict (sync)", flush=True)

    if args.smoke:
        check_bit_exact(cfg, ta, booleanizer, scfg, streams2, device,
                        engine_cls=AsyncServeEngine, backend=args.backend,
                        packed=args.packed, n_replicas=args.replicas)
        print("[stream_bench_torch] bit-exactness: streamed == offline "
              "(async)", flush=True)
        row, eng = run_cell(cfg, ta, booleanizer, device, sessions=4, hop=4,
                            window=window, frames=args.frames, repeats=1,
                            backend=args.backend, packed=args.packed,
                            n_replicas=args.replicas)
        ok = bool(row["decisions"] > 0 and row["forward_fallbacks"] == []
                  and (eng.tuning or {}).get("lazy"))
        print(f"[stream_bench_torch] SMOKE {'PASS' if ok else 'FAIL'}: "
              f"{row['decisions']} decisions at "
              f"{row['decisions_per_s_wall']:.0f}/s on {row['backend']} "
              f"(lazy-tuned @ {row['shape_key']})", flush=True)

        # Mixed QoS: the per-class percentile block must be present and
        # populated for both classes; the p99 ORDERING is asserted only in
        # the full run, whose load saturates the engine.
        qrow = run_mixed_qos_cell(cfg, ta, booleanizer, device,
                                  window=window, hop=4, frames=args.frames,
                                  backend=args.backend, packed=args.packed,
                                  n_replicas=args.replicas,
                                  bulk_wait_s=0.05, bulk_burst=2,
                                  max_batch=32)
        qs = qrow.get("qos")
        assert qs is not None, "mixed-QoS summary must carry a qos block"
        for qc in (QOS_LATENCY, QOS_BULK):
            assert qs[qc]["requests"] > 0, (qc, qs)
            assert qs[qc]["p99_ms"] is not None, (qc, qs)
            assert qs[qc]["queue_p99_ms"] is not None, (qc, qs)
        print(f"[stream_bench_torch] mixed-QoS smoke: latency p99 "
              f"{qs[QOS_LATENCY]['p99_ms']:.2f} ms vs bulk "
              f"{qs[QOS_BULK]['p99_ms']:.2f} ms "
              f"({qrow['decisions']} decisions, per-class block present)",
              flush=True)

        # Anomaly workload: margin-mode decisions must bit-equal the
        # digital oracle's margins at nominal.
        ageo = ANOMALY_SMOKE
        acfg, ata, abool = make_anomaly_model(device, **ageo)
        ascfg = StreamConfig(window=ageo["window"], hop=ageo["hop"],
                             vote=3, decision="margin", margin_class=1,
                             margin_threshold=0.0)
        astreams = sensor_streams(2, 32, ageo["n_sensors"])
        activity["anomaly"] = window_activity(
            acfg, ata, abool, ageo["window"], ageo["hop"], astreams)
        print(f"[stream_bench_torch] "
              f"{activity_line('anomaly model', activity['anomaly'])}",
              flush=True)
        check_margin_bit_exact(acfg, ata, abool, ascfg, astreams, device)
        print("[stream_bench_torch] bit-exactness: streamed anomaly "
              "margins == digital oracle (margin mode)", flush=True)
        arow = run_anomaly_cell(acfg, ata, abool, ageo, device, frames=32,
                                sessions=2, backend=args.backend,
                                packed=args.packed,
                                n_replicas=args.replicas)
        assert arow["decisions"] > 0
        print(f"[stream_bench_torch] anomaly smoke: {arow['decisions']} "
              f"margin decisions, alert fraction "
              f"{arow['alert_fraction']:.2f}", flush=True)
        report = {"smoke": True, "smoke_ok": ok, "device": where,
                  "torch": torch.__version__, "lazy_tuning": lazy_info,
                  "model_activity": activity,
                  "cell": row, "mixed_qos": qrow, "anomaly": arow,
                  "margin_bit_exact": True}
        print(json.dumps(report, default=str), flush=True)
        if args.smoke_out:
            write_report(report, args.smoke_out)
        if not ok:
            raise SystemExit(1)
        return report

    # ------------------------------------------------- sessions x hop rate
    sweep = []
    for sessions in (1, 4, 16):
        for hop in (2, 4, 8):
            row, _ = run_cell(cfg, ta, booleanizer, device,
                              sessions=sessions, hop=hop, window=window,
                              frames=args.frames, repeats=args.repeats,
                              backend=args.backend, packed=args.packed,
                              n_replicas=args.replicas)
            sweep.append(row)
            print(f"[stream_bench_torch]   S={sessions:>2} hop={hop}: "
                  f"{row['decisions_per_s_wall']:.0f} decisions/s "
                  f"({row['decisions']} windows, mean batch "
                  f"{row['mean_batch']:.1f}, padding "
                  f"{100 * row['padding_overhead']:.0f}%)", flush=True)

    # ------------------------------------------- sync / async headline pair
    sync_row, async_row = run_pair(cfg, ta, booleanizer, device, sessions=8,
                                   hop=4, window=window, frames=args.frames,
                                   repeats=args.repeats,
                                   backend=args.backend, packed=args.packed,
                                   n_replicas=args.replicas)
    speedup = (async_row["decisions_per_s_wall"]
               / sync_row["decisions_per_s_wall"])
    print(f"[stream_bench_torch]   async S=8 hop=4: "
          f"{async_row['decisions_per_s_wall']:.0f} decisions/s = "
          f"{speedup:.2f}x sync "
          f"({sync_row['decisions_per_s_wall']:.0f}), overlap "
          f"{100 * async_row['overlap_fraction']:.0f}% vs "
          f"{100 * sync_row['overlap_fraction']:.0f}%", flush=True)

    print("[stream_bench_torch]   sharded rows skipped: one rank (pass "
          "--host-devices N, or run under torch.distributed.run)",
          flush=True)

    # -------------------------------------------- mixed-QoS heavy traffic
    qos_row = run_mixed_qos_cell(cfg, ta, booleanizer, device,
                                 window=window, hop=4, frames=args.frames,
                                 backend=args.backend, packed=args.packed,
                                 n_replicas=args.replicas)
    qs = qos_row["qos"]
    assert qs[QOS_LATENCY]["p99_ms"] < qs[QOS_BULK]["p99_ms"], qs
    assert (qs[QOS_LATENCY]["queue_p99_ms"]
            < qs[QOS_BULK]["queue_p99_ms"]), qs
    print(f"[stream_bench_torch]   mixed QoS (2 latency + 2 bulk, burst x"
          f"{qos_row['bulk_burst']}): latency p99 "
          f"{qs[QOS_LATENCY]['p99_ms']:.2f} ms < bulk p99 "
          f"{qs[QOS_BULK]['p99_ms']:.2f} ms on one engine "
          f"({qos_row['decisions']} decisions, queue p99 "
          f"{qs[QOS_LATENCY]['queue_p99_ms']:.2f} vs "
          f"{qs[QOS_BULK]['queue_p99_ms']:.2f} ms)", flush=True)

    # --------------------------------------------------- anomaly workload
    ageo = ANOMALY_FULL
    acfg, ata, abool = make_anomaly_model(device, **ageo)
    ascfg = StreamConfig(window=ageo["window"], hop=ageo["hop"], vote=3,
                         decision="margin", margin_class=1,
                         margin_threshold=0.0)
    astreams = sensor_streams(2, 64, ageo["n_sensors"])
    activity["anomaly"] = window_activity(acfg, ata, abool, ageo["window"],
                                          ageo["hop"], astreams)
    print(f"[stream_bench_torch] "
          f"{activity_line('anomaly model', activity['anomaly'])}",
          flush=True)
    check_margin_bit_exact(acfg, ata, abool, ascfg, astreams, device)
    anomaly_row = run_anomaly_cell(acfg, ata, abool, ageo, device,
                                   frames=args.frames, backend=args.backend,
                                   packed=args.packed,
                                   n_replicas=args.replicas)
    anomaly_row["margin_bit_exact"] = True
    print(f"[stream_bench_torch]   anomaly (margin mode, latency class): "
          f"{anomaly_row['decisions']} decisions at "
          f"{anomaly_row['decisions_per_s_wall']:.0f}/s, alert fraction "
          f"{anomaly_row['alert_fraction']:.2f} (margins bit-exact vs the "
          "digital TM)", flush=True)

    report = {
        "model": {"n_clauses": cfg.n_clauses, "n_literals": cfg.n_literals,
                  "n_classes": cfg.n_classes},
        "stream": {"window": window, "vote": 5, "n_mels": geo["n_mels"],
                   "bits": geo["bits"],
                   "frames_per_session": args.frames},
        "device": where,
        "torch": torch.__version__,
        "model_activity": activity,
        "host_cpus": os.cpu_count(),
        "repeats": args.repeats,
        "lazy_tuning": lazy_info,
        "sweep": sweep,
        "sync_s8_h4": sync_row,
        "async_s8_h4": async_row,
        "async_speedup_vs_sync_s8_h4": speedup,
        "mixed_qos": qos_row,
        "anomaly": anomaly_row,
    }
    print(json.dumps(report, default=str), flush=True)
    if args.out:
        write_report(report, args.out)
    return report


if __name__ == "__main__":
    main()
