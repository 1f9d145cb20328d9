"""Streaming serving CLI: per-session windowed inference over the
dynamic-batching engine (port of ``repro.launch.stream``).

Two workloads share one windowing and dispatch path:

* ``--workload kws`` (default): synthetic KWS-6 keyword spotting, frames
  thermometer-booleanized by a sliding window, the per-window argmax
  smoothed by a majority vote: the paper's always-on audio deployment.
* ``--workload anomaly``: multichannel sensor anomaly detection, a
  2-class TM trained on windows labelled 1 iff a frame overlaps a fault
  burst, served in ``margin`` decision mode (alert iff the anomaly
  class's class-sum margin clears ``--margin-threshold``).

``--latency-sessions N`` runs the first N sessions under the ``latency``
QoS class and the rest under ``bulk``; the summary then carries the
per-class block.  Training and serving run on ``--device`` (the CUDA card
by default; ``--device cpu`` runs the plain versions).  The frames are
drawn on the host from ``torch.Generator``s seeded as the reference seeds
its keys (train 0, test 1, session ``s`` 10 + s), so a run is the same
data on either device; the TA init, the training and the engine take
seeds 2, 3 and 4.  ``--lazy-tune`` (on by default, as in the reference)
measures the engine's kernel tiles and bucket ladder once when the
tuning table has no entry for the model's shape bucket on this device
(``kernels/autotune.py``).

  PYTHONPATH=src python -m repro_torch.launch.stream --sessions 8
  PYTHONPATH=src python -m repro_torch.launch.stream --workload anomaly \\
      --latency-sessions 4
  PYTHONPATH=src python -m repro_torch.launch.stream --device cpu \\
      --sessions 2 --frames 32 --epochs 1
  PYTHONPATH=src python -m repro_torch.launch.stream --device cpu \\
      --async-serve --host-devices 4 --mesh 4   # sharded + overlapped

``--mesh`` and ``--host-devices`` work as in ``launch.serve``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import tm, tm_train
from repro_torch.core.booleanize import StreamingBooleanizer, fit_quantile
from repro_torch.core.tm import TMConfig
from repro_torch.core.variations import VariationConfig
from repro_torch.data.tm_datasets import (kws6_windows,
                                          sensor_anomaly_windows,
                                          synthetic_kws6,
                                          synthetic_sensor_anomaly)
from repro_torch.distributed.sharding import mesh_shape
from repro_torch.launch import hostdev
from repro_torch.launch.mesh import parse_mesh_spec
from repro_torch.serve import (QOS_LATENCY, AsyncServeEngine, BatcherConfig,
                               EngineConfig, ServeEngine, StreamConfig,
                               StreamServer)

ANALOG_BACKENDS = ("analog-cuda-packed2", "analog-cuda-packed",
                   "analog-cuda", "analog-torch")


def _frames(anomaly: bool, seed: int, n: int, n_frames: int, n_ch: int):
    """``n`` raw streams drawn on the host from ``seed``: ``(frames [n, T,
    ch], per-frame labels [n, T])`` for anomaly, ``(frames, utterance
    labels [n])`` for kws; numpy."""
    gen = torch.Generator().manual_seed(seed)
    if anomaly:
        x, lab = synthetic_sensor_anomaly(gen, n_streams=n,
                                          n_frames=n_frames,
                                          n_sensors=n_ch, device="cpu")
    else:
        x, lab = synthetic_kws6(gen, n_utterances=n, n_frames=n_frames,
                                n_mels=n_ch, device="cpu")
    return x.numpy(), lab.numpy()


def main(argv=None):
    """The CLI; with ``--host-devices N``, on N spawned host ranks (the
    exit code then)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    code = hostdev.run_main(main, argv)
    if code is not None:
        return code
    with hostdev.launched_group():
        return _stream(argv)


def _stream(argv):
    print = hostdev.rank0_print
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="kws",
                    choices=("kws", "anomaly"),
                    help="kws: keyword argmax+vote; anomaly: 2-class "
                         "sensor fault detection in margin decision mode")
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--latency-sessions", type=int, default=0,
                    help="run the first N sessions under the latency QoS "
                         "class (the rest stay bulk)")
    ap.add_argument("--frames", type=int, default=128,
                    help="frames streamed per session")
    ap.add_argument("--mels", type=int, default=12)
    ap.add_argument("--sensors", type=int, default=8,
                    help="sensor channels (anomaly workload)")
    ap.add_argument("--margin-threshold", type=float, default=0.0,
                    help="class-sum margin the anomaly class must clear "
                         "to alert (anomaly workload)")
    ap.add_argument("--bits", type=int, default=4,
                    help="thermometer bits per mel bin")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--hop", type=int, default=4)
    ap.add_argument("--vote", type=int, default=5,
                    help="majority-vote horizon (windows)")
    ap.add_argument("--clauses", type=int, default=10,
                    help="clauses per keyword class")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=64,
                    help="max dynamic batch (largest kernel bucket)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--routing", default="round_robin",
                    choices=("round_robin", "least_loaded", "ensemble"))
    ap.add_argument("--backend", default=None, choices=ANALOG_BACKENDS)
    ap.add_argument("--packed", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--lazy-tune", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="measure kernel tiles and a bucket ladder on first "
                         "sight of this model's shape bucket on this device "
                         "(default on)")
    ap.add_argument("--mesh", default=None, metavar="RxB",
                    help="shard the replica pool over a (replica, batch) "
                         "mesh of R x B ranks")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="run on N spawned host ranks (one gloo group)")
    ap.add_argument("--async-serve", action="store_true")
    ap.add_argument("--max-in-flight", type=int, default=2)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="snapshot the programmed pool here at startup "
                         "(rollback point for live hot-swaps; absent = "
                         "identical serving behavior, no restore point)")
    ap.add_argument("--nominal", action="store_true",
                    help="disable D2D/C2C/CSA variation")
    ap.add_argument("--device", default=None,
                    help="torch device for training and serving (default: "
                         "the CUDA card; 'cpu' runs the plain versions)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ------------------------------------------------ data + booleanizer
    anomaly = args.workload == "anomaly"
    n_ch = args.sensors if anomaly else args.mels    # channels per frame
    n_feat = args.window * n_ch * args.bits
    cfg = TMConfig(n_classes=(2 if anomaly else 6),
                   clauses_per_class=args.clauses,
                   n_features=n_feat, n_states=100, threshold=15,
                   specificity=5.0)
    xtr, ltr = _frames(anomaly, 0, 120, 32, n_ch)
    xte, lte = _frames(anomaly, 1, 40, 32, n_ch)
    booleanizer = fit_quantile(xtr.reshape(-1, n_ch), bits=args.bits,
                               device=device)
    windower = StreamingBooleanizer(booleanizer, args.window, args.hop)
    windows = sensor_anomaly_windows if anomaly else kws6_windows
    rtr, wytr = windows(xtr, ltr, windower)
    rte, wyte = windows(xte, lte, windower)
    print(f"[stream] {args.workload} windows: {len(rtr)} train / "
          f"{len(rte)} test, {n_feat} Boolean features "
          f"(C={cfg.n_clauses}, L={cfg.n_literals}) on {device}")

    # --------------------------------------------------------- train TM
    gen = torch.Generator(device=device)
    ta = tm.init_ta_state(gen.manual_seed(2), cfg, device)
    ta = tm_train.fit(ta, gen.manual_seed(3), rtr, wytr, cfg,
                      epochs=args.epochs, batch_size=200, parallel=True)
    acc = float(tm.accuracy(ta, torch.from_numpy(rte).to(device),
                            torch.from_numpy(wyte).to(device), cfg))
    print(f"[stream] digital per-window accuracy {acc:.3f}")

    # ------------------------------------------------------------ engine
    vcfg = (VariationConfig.nominal() if args.nominal
            else VariationConfig(csa_offset=False))
    ecfg = EngineConfig(
        batcher=BatcherConfig.for_max_batch(args.batch),
        routing=args.routing, backend=args.backend, packed=args.packed,
        max_in_flight=args.max_in_flight, lazy_tune=args.lazy_tune)
    mesh = (parse_mesh_spec(args.mesh, device_type=device.type)
            if args.mesh else None)
    cls = AsyncServeEngine if args.async_serve else ServeEngine
    engine = cls.from_ta_state(ta, cfg, n_replicas=args.replicas, seed=4,
                               vcfg=vcfg, ecfg=ecfg, device=device,
                               mesh=mesh)
    tuning = engine.tuning or {}
    print(f"[stream] pool of {args.replicas} crossbars "
          f"(pool version {engine.version}), routing={args.routing}, "
          f"backend={engine.backend.name}, shape bucket {engine.shape_key} "
          f"(tiles {tuning.get('tiles') or 'default'}"
          f"{', lazily measured' if tuning.get('lazy') else ''})")
    if args.checkpoint_dir:
        from repro_torch.serve import snapshot_pool
        path = snapshot_pool(engine.pool, args.checkpoint_dir)
        print(f"[stream] pool v{engine.version} snapshot -> {path}")
    if engine.selection.fell_back:
        print(f"[stream] BACKEND FALLBACK: "
              f"{engine.selection.fallback_reason}")
    if engine.mesh is not None:
        print(f"[stream] pool sharded over mesh {mesh_shape(engine.mesh)} "
              f"({engine.mesh.size()} ranks)")

    # ------------------------------------------------- streaming sessions
    scfg = StreamConfig(window=args.window, hop=args.hop, vote=args.vote,
                        decision=("margin" if anomaly else "argmax"),
                        margin_class=1,
                        margin_threshold=args.margin_threshold)
    server = StreamServer(engine, booleanizer, scfg)
    streams, truth = [], []
    for s in range(args.sessions):
        if anomaly:
            x, lab = _frames(True, 10 + s, 1, args.frames, n_ch)
            streams.append(x[0])
            truth.append(lab[0])                         # per-frame 0/1
        else:
            x, y = _frames(False, 10 + s, max(1, args.frames // 32), 32,
                           n_ch)
            streams.append(x.reshape(-1, n_ch)[:args.frames])
            truth.append(np.repeat(y, 32)[:args.frames])
    n_frames = min(args.frames, min(len(s) for s in streams))
    for i in range(args.sessions):
        server.session(f"client-{i}",
                       qos=(QOS_LATENCY if i < args.latency_sessions
                            else None))
    for lo in range(0, n_frames, args.hop):
        for i, stream in enumerate(streams):
            server.feed(f"client-{i}", stream[lo:lo + args.hop])
        server.pump()
    server.drain()

    # Scoring.  KWS: the smoothed keyword against the label of the
    # utterance the window's last frame is in.  Anomaly: the raw margin
    # decision against the window's label (1 iff a frame of the window is
    # in a fault burst, as sensor_anomaly_windows rolls it up).
    correct = total = 0
    for i in range(args.sessions):
        sess = server.sessions[f"client-{i}"]
        for d in sess.decisions:
            span = truth[i][d.index * args.hop:
                            d.index * args.hop + args.window]
            want = int(span.max()) if anomaly else span[-1]
            got = d.pred if anomaly else d.keyword
            correct += int(got == want)
            total += 1
    summary = server.summary()
    summary["decision_accuracy"] = correct / max(total, 1)
    summary["keyword_accuracy"] = summary["decision_accuracy"]
    summary["digital_window_accuracy"] = acc

    if args.json:
        print(json.dumps(summary, indent=2, default=str))
        return summary
    sess = summary.get("sessions", {})
    rates = [v["decisions_per_s"] for v in sess.values()
             if v["decisions_per_s"]]
    p50s = [v["p50_ms"] for v in sess.values()]
    label = "alert accuracy" if anomaly else "keyword accuracy"
    print(f"[stream] {total} decisions across {args.sessions} sessions: "
          f"{label} {summary['decision_accuracy']:.3f} "
          + (f"(margin >= {args.margin_threshold:g} on class 1 over "
             f"{summary['digital_window_accuracy']:.3f} per-window)"
             if anomaly else
             f"(vote={args.vote} smoothing over "
             f"{summary['digital_window_accuracy']:.3f} per-window)"))
    for qc, q in summary.get("qos", {}).items():
        print(f"[stream]   qos[{qc}]: {q['requests']} served, "
              f"p99 {q['p99_ms']:.1f} ms "
              f"(queue p99 {q['queue_p99_ms']:.1f} ms), "
              f"rejected {q['rejected']}, expired {q['expired']}")
    print(f"[stream] {summary['batches']} batches, mean "
          f"{summary['mean_batch']:.1f} windows/batch "
          f"({100 * summary['padding_overhead']:.1f}% padding) — "
          f"cross-session batching at work")
    rate_p50 = np.median(rates) if rates else float("nan")
    lat_p50 = np.median(p50s) if p50s else float("nan")
    print(f"[stream] per-session decision rate p50 "
          f"{rate_p50:.1f}/s, window latency p50 "
          f"{lat_p50:.1f} ms, overlap "
          f"{100 * summary['overlap_fraction']:.0f}%")
    return summary


if __name__ == "__main__":
    main()
