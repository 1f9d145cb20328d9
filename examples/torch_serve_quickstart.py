"""Serving-engine quickstart on the PyTorch port: train a tiny TM, serve
it from a pool of four simulated crossbar chips with dynamic batching and
ensemble voting (port of ``examples/serve_quickstart.py``).

  PYTHONPATH=src python examples/torch_serve_quickstart.py [--no-packed]
  PYTHONPATH=src python examples/torch_serve_quickstart.py --device cpu
  PYTHONPATH=src python examples/torch_serve_quickstart.py --device cpu \
      --host-devices 4 --mesh 4                  # sharded over 4 ranks

``--mesh R[xB]`` shards the pool's programmed ``[R, C, L]`` stack over a
``(replica, batch)`` mesh of ranks (``--host-devices N`` spawns N host
ranks; on the card, ``torch.distributed.run``); the responses stay
bit-identical to the single-device eager engine's.

The pool reads with the full noise model, ``VariationConfig()``: no
fused kernel models the per-column CSA offset, so capability selection
falls back to the eager ``analog-torch`` backend (which also gives up the
packed wire) and says so: a warning at construction, the fallback on the
backend line, and ``fallback_dispatches`` in the summary.  The training
is the reference's, ``EPOCHS`` sequential epochs; the port's sequential
step is a host loop (PERF.md §5), so lower ``EPOCHS`` for a quicker
look.  For the overlapped dispatch schedule and the full flag surface,
see ``repro_torch.launch.serve``.
"""

import argparse
import sys

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import tm, tm_train
from repro_torch.core.tm import TMConfig
from repro_torch.core.variations import VariationConfig
from repro_torch.data.tm_datasets import noisy_xor
from repro_torch.distributed.sharding import mesh_shape
from repro_torch.launch import hostdev
from repro_torch.launch.mesh import parse_mesh_spec
from repro_torch.serve import BatcherConfig, EngineConfig, ServeEngine

N_TRAIN, N_TEST = 3000, 200
EPOCHS = 30
N_REQUESTS = 64


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    code = hostdev.run_main(main, argv)
    if code is not None:
        return code
    with hostdev.launched_group():
        return _quickstart(argv)


def _quickstart(argv):
    print = hostdev.rank0_print
    ap = argparse.ArgumentParser()
    ap.add_argument("--packed", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="32-bit packed literal wire format (default on)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions)")
    ap.add_argument("--mesh", default=None, metavar="RxB",
                    help="shard the replica pool over a (replica, batch) "
                         "mesh of ranks, e.g. '4' or '2x2'")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="run on N spawned host ranks (one gloo group)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = (parse_mesh_spec(args.mesh, device_type=device.type)
            if args.mesh else None)

    cfg = TMConfig(n_classes=2, clauses_per_class=12, n_features=12,
                   n_states=100)
    xtr, ytr, xte, yte = noisy_xor(torch.Generator().manual_seed(0),
                                   N_TRAIN, N_TEST, device="cpu")
    gen = torch.Generator(device=device)
    ta = tm.init_ta_state(gen.manual_seed(1), cfg, device)
    ta = tm_train.fit(ta, gen.manual_seed(2), xtr.to(device),
                      ytr.to(device), cfg, epochs=EPOCHS, batch_size=1500)
    digital = float(tm.accuracy(ta, xte.to(device), yte.to(device), cfg))
    print(f"digital accuracy: {digital:.3f} on {device}")

    # Four independently programmed chips (distinct D2D draws); batches
    # of up to 32 requests, majority vote across all four chips a read.
    engine = ServeEngine.from_ta_state(
        ta, cfg, n_replicas=4, seed=3, vcfg=VariationConfig(),
        ecfg=EngineConfig(routing="ensemble", packed=args.packed,
                          batcher=BatcherConfig(max_batch=32,
                                                bucket_sizes=(8, 16, 32))),
        device=device, mesh=mesh)
    bcfg = engine.batcher.cfg
    print(f"backend: {engine.backend.name} (packed_io={engine.packed_io}, "
          f"buckets={list(bcfg.bucket_sizes)}"
          + (f", tuned for {bcfg.tuned_for}" if bcfg.tuned_for else "")
          + ")"
          + (f" (fallback: {engine.selection.fallback_reason})"
             if engine.selection.fell_back else ""))
    if mesh is not None:
        print(f"pool sharded over mesh {mesh_shape(mesh)}")

    xs = xte.numpy().astype(np.uint8)
    engine.submit_many(list(xs[:N_REQUESTS]))
    responses = engine.drain()

    preds = np.array([r.pred for r in responses])
    acc = float((preds == yte.numpy()[:N_REQUESTS]).mean())
    s = engine.summary()
    print(f"analog ensemble accuracy on {len(responses)} requests: "
          f"{acc:.3f}")
    print(f"{s['batches']} batches, mean {s['mean_batch']:.1f} req/batch, "
          f"{100 * s['padding_overhead']:.1f}% padding, "
          f"{s['bytes_per_dispatch']:.0f} operand bytes/dispatch, "
          f"{s['fallback_dispatches']} fallback dispatches")
    hw = s["hardware"]
    print(f"modeled ReRAM chip: {hw['latency_ns']:.0f} ns/read, "
          f"{hw['ensemble_energy_nj_per_dp']:.4f} nJ/datapoint (4 chips), "
          f"{hw['top_j_inv']:.0f} TopJ^-1/chip")
    s["analog_accuracy"], s["digital_accuracy"] = acc, digital
    s["ta_state"], s["preds"] = ta.cpu(), preds
    s["data"] = tuple(t.numpy() for t in (xtr, ytr, xte, yte))
    return s


if __name__ == "__main__":
    main()
