"""Distributed TM training and inference on a ``(data 2, model 4)`` mesh
(port of ``examples/tm_scaleout.py``).

Shards an image-scale TM the way the production mesh would: the batch
over ``data``, the clauses over ``model``.  Every rank runs this program
on its blocks: batch-parallel training steps (``tm_train_step``, equal bit
for bit to the single-device step) and fused digital inference
(``tm_infer_step``).  Without a launcher it spawns 8 host ranks; on the
card ``torch.distributed.run`` starts them (gloo, since the ranks share
the one card).

  PYTHONPATH=src python examples/torch_tm_scaleout.py --device cpu
  PYTHONPATH=src python examples/torch_tm_scaleout.py --device cpu \\
      --host-devices 4 --mesh 2x2 --epochs 1 --train-rows 512
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 8 examples/torch_tm_scaleout.py
"""

import argparse
import os
import sys
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.core import tm
from repro_torch.core import tm_distributed as tmd
from repro_torch.core.tm import TMConfig
from repro_torch.core.tm_train import epoch_batches
from repro_torch.data.tm_datasets import synthetic_image_dataset
from repro_torch.distributed import sharding
from repro_torch.launch import hostdev
from repro_torch.launch.mesh import make_debug_mesh

N_TRAIN, N_TEST = 2048, 512
BATCH = 256
EPOCHS = 6


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2x4", metavar="DxM",
                    help="(data, model) mesh; its size is the rank count")
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--train-rows", type=int, default=N_TRAIN,
                    help="training rows (a multiple of the batch, 256)")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="spawn N host ranks (default 8 without a "
                         "launcher)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions)")
    return ap


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    resolve_device(_parser().parse_args(argv).device)  # before any spawn
    if hostdev.parse_host_devices(argv) is None and \
            "WORLD_SIZE" not in os.environ:
        argv += ["--host-devices", "8"]       # the reference's 8 devices
    code = hostdev.run_main(main, argv)
    if code is not None:
        return code
    with hostdev.launched_group():
        return _scaleout(_parser().parse_args(argv))


def _scaleout(args):
    print = hostdev.rank0_print
    device = resolve_device(args.device)
    n_data, n_model = (int(v) for v in args.mesh.lower().split("x"))

    # image-scale TM (reduced clause count for the host demo)
    cfg = TMConfig(n_classes=10, clauses_per_class=40, n_features=784,
                   n_states=127, threshold=15, specificity=5.0)
    mesh = make_debug_mesh(n_data, n_model, device_type=device.type)
    print(f"mesh {sharding.mesh_shape(mesh)}, TM {cfg.n_ta} TA cells, "
          f"clauses sharded over 'model'")

    xtr, ytr, xte, yte = synthetic_image_dataset(
        torch.Generator().manual_seed(0), n_train=args.train_rows,
        n_test=N_TEST, device="cpu")
    xtr, ytr, xte = xtr.to(device), ytr.to(device), xte.to(device)
    st_sh, x_sh, y_sh = tmd.tm_shardings(cfg, mesh, BATCH)
    gen = torch.Generator(device=device)
    ta = st_sh.place(tm.init_ta_state(gen.manual_seed(1), cfg, device))
    gen.manual_seed(2)
    accs = []
    t0 = time.time()
    for epoch in range(args.epochs):
        for idx in epoch_batches(gen, xtr.shape[0], BATCH, device):
            ta = tmd.tm_train_step(ta, gen, x_sh.place(xtr[idx]),
                                   y_sh.place(ytr[idx]), cfg)
        pred = tmd.tm_infer_step(ta, x_sh.place(xte), cfg)
        accs.append(float((pred.cpu() == yte).float().mean()))
        print(f"epoch {epoch}: test acc {accs[-1]:.3f} "
              f"({time.time() - t0:.0f}s)")
    stats = tm.include_stats(sharding.gather(ta), cfg)
    print(f"includes: {stats['include_pct']:.2f}% "
          f"(drives the IMBUE energy advantage)")
    return {"accuracy": accs, "include_pct": stats["include_pct"]}


if __name__ == "__main__":
    main()
