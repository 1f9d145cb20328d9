"""End-to-end LM training driver with fault tolerance (port of
``repro.launch.train``).

* auto-resume: restores the latest committed checkpoint (parameters,
  optimizer state, step); the data pipeline is step-indexed, so the
  replay is exact;
* atomic checkpoints every ``--ckpt-every`` steps and at the end, in the
  reference's layout (stacked superblocks; ``convert.lm_tree_to_numpy``),
  so a checkpoint of either package resumes in the other;
* straggler watchdog: per-step times against a rolling median; slow
  steps are flagged and logged;
* elastic restore: the checkpoint holds whole tensors, so ``--mesh
  debug`` resumes a run written on any other rank count;
* NaN sentry: a non-finite loss raises before a checkpoint can be
  poisoned (a restart resumes from the last good step).

``--mesh debug`` trains on a ``(data 2, model 2)`` mesh under
``launch.mesh.rules_for``: data-parallel over ``data`` (each rank its
rows of the batch) and tensor-parallel over ``model`` (each rank its
block of the heads, MLP, vocab and experts), the parameters stored as
blocks (FSDP over ``data``); it needs a process group of 4
ranks: ``--host-devices 4`` on the host, or ``python -m
torch.distributed.run --nproc-per-node 4`` (gloo, which lets ranks share
one card).  ``single`` / ``multi`` build the production meshes and need
256 / 512 ranks.  On the card a step is timed with CUDA events around
it; ``ms`` and ``tok/s`` in the log are that time.

Usage (the card; add ``--device cpu`` on the host):

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --steps 300 --batch 8 --seq 256 --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --host-devices 4 --mesh debug --arch qwen2-0.5b --batch 8 --seq 64
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import statistics
import sys
import time
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch._device import resolve_device
from repro_torch.configs import get_config, smoke
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import sharding as shd
from repro_torch.launch import hostdev
from repro_torch.launch.mesh import (make_debug_mesh, make_production_mesh,
                                     rules_for)
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizers import (OptimizerConfig, cosine_schedule,
                                          make_optimizer)
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class Watchdog:
    """Flags steps slower than ``threshold`` x rolling median."""

    threshold: float = 2.0
    window: int = 32
    times: list = dataclasses.field(default_factory=list)
    flagged: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        hist = self.times[-self.window:]
        slow = bool(hist) and len(hist) >= 8 and \
            dt > self.threshold * statistics.median(hist)
        self.times.append(dt)
        if slow:
            self.flagged.append((step, dt))
        return slow


@dataclasses.dataclass
class TrainRun:
    """What :func:`main` trained: the model and optimizer, the first step
    this process ran, each step's loss and seconds, and the batch shape
    ``(batch, seq)``."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    cfg: object
    start_step: int
    losses: Dict[int, float]
    step_s: Dict[int, float]
    batch_shape: Tuple[int, int]
    watchdog: Watchdog

    @property
    def tokens_per_step(self) -> int:
        return self.batch_shape[0] * self.batch_shape[1]


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--full", action="store_true",
                    help="full config (default: reduced ~100M-class)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--mesh", choices=["none", "debug", "single", "multi"],
                    default="none")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    ap.add_argument(hostdev.FLAG, type=int, default=None, metavar="N",
                    help="run on N spawned host ranks (gloo)")
    return ap


def _config(args):
    cfg = get_config(args.arch)
    if not args.full:
        cfg = smoke(cfg, d_model=256, n_super=2, vocab=2048)
        cfg = dataclasses.replace(cfg, remat=False)
    if args.seq and cfg.ssm is not None and args.seq % cfg.ssm.chunk:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm,
                                         chunk=min(cfg.ssm.chunk,
                                                   args.seq)))
    return cfg


def _state(model, opt):
    """The checkpointed tree, in the reference's layout."""
    return {"params": convert.lm_tree_to_numpy(model),
            "opt": convert.lm_tree_to_numpy(opt.state_tree())}


class _StepTimer:
    """Seconds of one step: CUDA events around it on the card (the
    stream's time from the step's first enqueue to its last), the host
    clock elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            self.s = self.start.elapsed_time(self.end) / 1e3
        else:
            self.s = time.perf_counter() - self.t0


def train(argv=None) -> TrainRun:
    """The run ``argv`` describes, in this process (a rank of the group a
    launcher set up, under ``--mesh``)."""
    args = _parser().parse_args(argv)
    print_ = hostdev.rank0_print
    device = resolve_device(args.device)
    cfg = _config(args)

    mesh = None
    if args.mesh == "debug":
        mesh = make_debug_mesh(device_type=device.type)
    elif args.mesh in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device_type=device.type)

    model = tf.init_params(torch.Generator(device).manual_seed(0), cfg,
                           device)
    ctx = contextlib.nullcontext()
    if mesh is not None:
        rules = rules_for(cfg, mesh, global_batch=args.batch)
        shd.shard_module(model, mesh, rules)
        ctx = shd.use_sharding(mesh, rules)
    opt = make_optimizer(model, OptimizerConfig(lr=args.lr),
                         cosine_schedule(args.lr, warmup=20,
                                         total=args.steps))
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)
    start_step = 0

    # ---- auto-resume --------------------------------------------------
    if args.ckpt_dir:
        got = ckpt.restore_latest(args.ckpt_dir, _state(model, opt), device)
        if got is not None:
            start_step, tree, _ = got
            convert.load_lm_params(model, tree["params"])
            opt.load_state_tree(convert.lm_opt_state_from_numpy(
                tree["opt"], model, device))
            print_(f"[train] resumed from step {start_step}")

    dcfg = DataConfig()
    wd = Watchdog()
    n_params = sum(p.numel() for p in model.parameters())
    print_(f"[train] arch={cfg.name} params={n_params / 1e6:.1f}M "
           f"steps={args.steps} batch={args.batch}x{args.seq}")
    run = TrainRun(model, opt, cfg, start_step, {}, {},
                   (args.batch, args.seq), wd)
    timer = _StepTimer(device)

    with ctx:
        t_start = time.time()
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(
                v.astype(np.int64) if k == "tokens" else v).to(device)
                for k, v in synth_batch(cfg, dcfg, step, args.batch,
                                        args.seq).items()}
            with timer:
                metrics = step_fn(model, step, batch)
                loss = float(metrics["loss"])
            dt = timer.s
            if not np.isfinite(loss):
                raise RuntimeError(
                    f"non-finite loss at step {step}; restart resumes "
                    f"from the last committed checkpoint")
            run.losses[step], run.step_s[step] = loss, dt
            if wd.observe(step, dt):
                print_(f"[watchdog] step {step} straggled: {dt:.2f}s")
            if step % args.log_every == 0 or step == args.steps - 1:
                tput = args.batch * args.seq / dt
                print_(f"[train] step {step:5d} loss {loss:.4f} "
                       f"{dt * 1e3:6.0f} ms  {tput:9.0f} tok/s")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                ckpt.save(args.ckpt_dir, step + 1, _state(model, opt),
                          extra={"arch": cfg.name})
        if args.ckpt_dir:
            ckpt.save(args.ckpt_dir, args.steps, _state(model, opt),
                      extra={"arch": cfg.name})
    total = time.time() - t_start
    print_(f"[train] done: {args.steps - start_step} steps in {total:.0f}s;"
           f" {len(wd.flagged)} straggler flags")
    return run


def main(argv=None):
    """The trainer: ``train(argv)``'s :class:`TrainRun` (its ``model`` is
    what the reference's ``main`` returns), or, under ``--host-devices
    N``, rank 0's exit code.  Joins the process group that
    ``torch.distributed.run`` describes, if any."""
    argv = list(sys.argv[1:] if argv is None else argv)
    code = hostdev.run_main(_ranked, argv)
    if code is not None:
        return code
    with hostdev.launched_group():
        return train(hostdev.strip_host_devices(argv))


def _ranked(argv) -> int:
    """One host rank of ``--host-devices N``."""
    train(argv)
    return 0


if __name__ == "__main__":
    main()
