"""IMBUE inference serving CLI: a thin front-end over ``repro_torch.serve``
(port of ``repro.launch.serve``).

Trains a TM, programs a replica pool of crossbars, then streams single
requests through the dynamic-batching engine — the deployment model of
the paper (program once, read forever), scaled out to R chips.  Reports
the engine's latency and throughput, measured on ``--device``, beside
the modeled ReRAM chip's figures of merit.

The data is drawn on the host from a ``torch.Generator`` seeded 0, so a
run trains on the same rows on either device; the TA init, the training
and the engine take seeds 1, 2 and 3.  With the default
``VariationConfig()`` (CSA offset on) no fused kernel models the read,
so the engine falls back, loudly, to the eager ``analog-torch`` backend;
``--nominal`` serves on the kernels.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 256
  PYTHONPATH=src python -m repro_torch.launch.serve --routing ensemble \\
      --nominal --batch 128
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --epochs 1 --requests 64
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --host-devices 4 --mesh 2x2 --replicas 4 --async-serve  # sharded
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.serve --mesh 2x2 \\
      --replicas 4 --nominal          # four ranks on the card, over gloo

``--mesh RxB`` shards the pool over a ``(replica, batch)`` mesh of R x B
ranks: ``--host-devices N`` spawns N host ranks here, and under
``torch.distributed.run`` the launcher's ranks join a gloo group.  Every
rank trains and serves the same model on the same requests; rank 0
prints.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch._device import device_label, resolve_device
from repro_torch.core import tm, tm_train
from repro_torch.core.tm import TMConfig
from repro_torch.core.variations import VariationConfig
from repro_torch.data.tm_datasets import synthetic_image_dataset
from repro_torch.distributed.sharding import mesh_shape
from repro_torch.launch import hostdev
from repro_torch.launch.mesh import parse_mesh_spec
from repro_torch.launch.stream import ANALOG_BACKENDS
from repro_torch.serve import (AsyncServeEngine, BatcherConfig, EngineConfig,
                               ServeEngine)


def build_engine(args, cfg: TMConfig, ta: torch.Tensor) -> ServeEngine:
    """The engine ``args`` asks for over TA state ``ta``, on
    ``args.device``, programmed from seed 3."""
    vcfg = (VariationConfig.nominal() if args.nominal
            else VariationConfig())
    ecfg = EngineConfig(
        batcher=BatcherConfig.for_max_batch(
            args.batch, max_wait_s=args.max_wait_ms * 1e-3),
        routing=args.routing,
        backend=args.backend,
        packed=args.packed,
        max_in_flight=args.max_in_flight)
    device = resolve_device(args.device)
    spec = getattr(args, "mesh", None)
    mesh = parse_mesh_spec(spec, device_type=device.type) if spec else None
    cls = AsyncServeEngine if args.async_serve else ServeEngine
    return cls.from_ta_state(ta, cfg, n_replicas=args.replicas, seed=3,
                             vcfg=vcfg, ecfg=ecfg, device=device, mesh=mesh)


def main(argv=None):
    """The CLI; with ``--host-devices N``, on N spawned host ranks (the
    exit code then)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    code = hostdev.run_main(main, argv)
    if code is not None:
        return code
    with hostdev.launched_group():
        return _serve(argv)


def _serve(argv):
    print = hostdev.rank0_print
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64,
                    help="max dynamic batch (largest kernel bucket)")
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--routing", default="round_robin",
                    choices=("round_robin", "least_loaded", "ensemble"))
    ap.add_argument("--backend", default=None, choices=ANALOG_BACKENDS,
                    help="forward-backend preference (repro_torch.api "
                         "name); capability selection may fall back loudly")
    ap.add_argument("--packed", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="32-bit packed literal wire format (default on; "
                         "--no-packed forces the dense uint8 datapath)")
    ap.add_argument("--mesh", default=None, metavar="RxB",
                    help="shard the replica pool over a (replica, batch) "
                         "mesh of R x B ranks, e.g. '4' or '2x2'; the "
                         "[R, C, L] stack splits over 'replica'")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="run on N spawned host ranks (one gloo group) so "
                         "that --mesh runs without a launcher")
    ap.add_argument("--async-serve", action="store_true",
                    help="AsyncServeEngine: keep dispatches in flight so "
                         "host batching overlaps device compute")
    ap.add_argument("--max-in-flight", type=int, default=2,
                    help="async depth: un-collected dispatches allowed")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="snapshot the programmed pool here at startup "
                         "(digest-verified restore point for live hot-swap "
                         "rollback; without it the engine serves exactly "
                         "as before, just without a rollback point)")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--nominal", action="store_true",
                    help="disable D2D/C2C/CSA variation")
    ap.add_argument("--device", default=None,
                    help="torch device for training and serving (default: "
                         "the CUDA card; 'cpu' runs the plain versions)")
    ap.add_argument("--json", action="store_true",
                    help="dump the summary as JSON")
    args = ap.parse_args(argv)
    if args.batch % 8 or args.batch > 128:
        ap.error("--batch must be a multiple of 8, at most 128 "
                 "(kernel batch-tile buckets)")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    device = resolve_device(args.device)

    cfg = TMConfig(n_classes=10, clauses_per_class=20, n_features=784,
                   n_states=127, threshold=15, specificity=5.0)
    xtr, ytr, xte, yte = synthetic_image_dataset(
        torch.Generator().manual_seed(0), n_train=2000, n_test=2048,
        device="cpu")
    xtr, ytr = xtr.to(device), ytr.to(device)
    print(f"[serve] training TM ({cfg.n_ta} TA cells) on {device}...")
    gen = torch.Generator(device=device)
    ta = tm.init_ta_state(gen.manual_seed(1), cfg, device)
    ta = tm_train.fit(ta, gen.manual_seed(2), xtr, ytr, cfg,
                      epochs=args.epochs, batch_size=200, parallel=True)
    stats = tm.include_stats(ta, cfg)
    acc = float(tm.accuracy(ta, xte.to(device), yte.to(device), cfg))
    print(f"[serve] digital accuracy {acc:.3f}, "
          f"includes {stats['include_pct']:.2f}%")

    engine = build_engine(args, cfg, ta)
    bcfg = engine.batcher.cfg
    print(f"[serve] pool of {args.replicas} crossbars programmed "
          f"(pool version {engine.version}), "
          f"routing={args.routing}, backend={engine.backend.name}, "
          f"packed_io={engine.packed_io}")
    if args.checkpoint_dir:
        from repro_torch.serve import snapshot_pool
        path = snapshot_pool(engine.pool, args.checkpoint_dir)
        print(f"[serve] pool v{engine.version} snapshot -> {path}")
    if engine.mesh is not None:
        print(f"[serve] pool sharded over mesh {mesh_shape(engine.mesh)} "
              f"({engine.mesh.size()} ranks); "
              f"async={'on' if args.async_serve else 'off'}")
    print(f"[serve] buckets {list(bcfg.bucket_sizes)} "
          f"({'tuned for ' + bcfg.tuned_for if bcfg.tuned_for else 'static'}"
          f"), kernel tiles "
          f"{engine.tuning.get('tiles') if engine.tuning else 'default'}")
    if engine.selection.fell_back:
        print(f"[serve] BACKEND FALLBACK: "
              f"{engine.selection.fallback_reason}")

    # Stream individual requests; pump as they queue (the engine cuts a
    # batch when a bucket fills or the oldest request times out).
    rng = np.random.default_rng(0)
    xte_np = xte.numpy().astype(np.uint8)
    yte_np = yte.numpy().astype(int)
    idx = rng.integers(0, xte_np.shape[0], size=args.requests)
    for i in idx:
        engine.submit(xte_np[i])
        engine.pump()
    responses = engine.drain()

    correct = sum(int(r.pred == yte_np[i])
                  for r, i in zip(responses, idx))
    summary = engine.summary(includes=stats["includes"])
    summary["analog_accuracy"] = correct / len(responses)

    if args.json:
        print(json.dumps(summary, indent=2))
        return summary
    hw = summary["hardware"]
    print(f"[serve] {summary['requests']} requests in "
          f"{summary['batches']} batches (mean {summary['mean_batch']:.1f}"
          f"/batch, {100 * summary['padding_overhead']:.1f}% padding): "
          f"analog acc {summary['analog_accuracy']:.3f}")
    # throughput_rps is None (not a number) until the served span is
    # positive: a one-tick run has no meaningful rate.
    tput = summary["throughput_rps"]
    print(f"[serve] latency p50/p95/p99: {summary['p50_ms']:.1f}/"
          f"{summary['p95_ms']:.1f}/{summary['p99_ms']:.1f} ms; "
          f"{f'{tput:.0f}' if tput is not None else 'n/a'} inf/s "
          f"({device_label(device)}); replica rows "
          f"{summary['replica_load_rows']}")
    print(f"[serve] overlap: {100 * summary['overlap_fraction']:.0f}% of "
          f"device time hidden behind host work "
          f"(pack {summary['host_pack_s'] * 1e3:.1f} ms, blocked wait "
          f"{summary['device_wait_s'] * 1e3:.1f} ms)")
    print(f"[serve] modeled ReRAM chip's figures: "
          f"{hw['latency_ns']:.0f} ns/datapoint, "
          f"{hw['energy_nj_per_dp']:.3f} nJ/datapoint, "
          f"{hw['top_j_inv']:.0f} TopJ^-1, pool "
          f"{hw['pool_throughput_dps']:.2e} dp/s")
    return summary


if __name__ == "__main__":
    main()
