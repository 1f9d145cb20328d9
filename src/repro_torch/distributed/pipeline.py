"""GPipe-style pipeline parallelism on ``torch.distributed`` (port of
``repro.distributed.pipeline``).

Layers are partitioned into S stages along a ``"pipe"`` mesh axis
(``launch.mesh.make_pipeline_mesh``), one rank a stage; microbatches
stream through the pipeline.  The schedule is the classic GPipe
fill / steady / drain loop: ``S + M - 1`` ticks for M microbatches (bubble
fraction ``(S-1)/(S+M-1)``).  Each tick stage 0 injects the next
microbatch, a stage computes only while it holds a real microbatch (it is
*live*), the last stage stores what it finishes, and every stage hands
its output to the next around the ring: a paired send and receive posted
together through ``dist.batch_isend_irecv``, so no rank waits on a
neighbour that is itself waiting to send.  At the end the last stage's
outputs are all-gathered, so every rank returns the whole batch.

The handoff and the gather go through host tensors: gloo's send and
receive take CPU tensors, and gloo is the backend where ranks share one
card (NCCL refuses two ranks on one GPU).  So on the card each stage
computes on the device and hands off through a host copy.

The demo stage is a 2-layer MLP block, as in the reference.  Run it as

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.distributed.pipeline [--device cpu]

which holds the pipelined forward to ``sequential_apply`` on the same
weights and prints one JSON line on rank 0.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import mesh_shape, partitioned

# The demo's shapes: the reference test's (tests/test_distributed.py).
DEMO = dict(batch=8, seq=16, d=32, microbatches=4)
DEMO_TOL = 2e-5


def init_pipeline_params(gen: torch.Generator, n_stages: int, d: int,
                         device: DeviceLike = None
                         ) -> Dict[str, torch.Tensor]:
    """Per-stage params stacked on axis 0: a 2-layer MLP per stage, drawn
    from ``gen`` (a generator on ``device``)."""
    device = resolve_device(device)
    w1, w2 = [], []
    for _ in range(n_stages):
        w1.append(torch.randn((d, 4 * d), generator=gen, device=device)
                  / d ** 0.5)
        w2.append(torch.randn((4 * d, d), generator=gen, device=device)
                  / (4 * d) ** 0.5)
    return {"w1": torch.stack(w1), "w2": torch.stack(w2)}


def _stage(params, x):
    # jax.nn.gelu's default, the tanh approximation.
    h = F.gelu(x @ params["w1"], approximate="tanh")
    return x + h @ params["w2"]


@torch.no_grad()
def sequential_apply(params, x):
    n_stages = params["w1"].shape[0]
    for s in range(n_stages):
        x = _stage({k: v[s] for k, v in params.items()}, x)
    return x


def _stage_params(params, stage: int):
    """This stage's weights: its block of a leaf partitioned over the
    pipe axis, or row ``stage`` of a whole stacked leaf."""
    return {k: v.to_local()[0] if partitioned(v) else v[stage]
            for k, v in params.items()}


def _handoff(y: torch.Tensor, prev: int, nxt: int, group) -> torch.Tensor:
    """Send ``y`` to the next stage and receive the previous stage's
    output, both posted together (through host tensors: gloo)."""
    send = y.detach().to("cpu").contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, nxt, group),
           dist.P2POp(dist.irecv, recv, prev, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(y.device)


@torch.no_grad()
def pipeline_apply(params, x, mesh, *, microbatches: int):
    """GPipe forward over the ``"pipe"`` mesh axis.  x [B, T, D], whole on
    every rank; ``params`` stacked per stage (whole, or partitioned over
    ``pipe``).  Every rank of the mesh calls it and returns the whole
    output."""
    n_stages = mesh_shape(mesh)["pipe"]
    b = x.shape[0]
    if b % microbatches:
        raise ValueError("batch must divide into microbatches")
    mb = b // microbatches
    stage = mesh.get_local_rank("pipe")
    group = mesh.get_group("pipe")
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prev = dist.get_global_rank(group, (stage - 1) % n_stages)
    p = _stage_params(params, stage)
    xs = x.reshape(microbatches, mb, *x.shape[1:])
    buf = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    for t in range(n_stages + microbatches - 1):
        cur = xs[min(t, microbatches - 1)] if stage == 0 else buf
        live = 0 <= t - stage < microbatches
        y = _stage(p, cur) if live else cur
        if live and stage == n_stages - 1:
            outs[t - (n_stages - 1)] = y
        buf = _handoff(y, prev, nxt, group) if n_stages > 1 else y
    # only the last stage holds real outputs; gather them to every rank
    host = outs.to("cpu").contiguous()
    every = [torch.empty_like(host) for _ in range(n_stages)]
    dist.all_gather(every, host, group=group)
    return every[-1].to(x.device).reshape(b, *x.shape[1:])


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The demo on the process group a launcher describes (one rank a
    stage): pipelined against sequential on the same seeded weights."""
    from repro_torch.launch.hostdev import launched_group, rank0_print
    from repro_torch.launch.mesh import make_pipeline_mesh
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with launched_group():
        if not dist.is_initialized():
            raise SystemExit("run under python -m torch.distributed.run "
                             "--nproc-per-node N")
        mesh = make_pipeline_mesh(dist.get_world_size(),
                                  device_type=device.type)
        n_stages = mesh_shape(mesh)["pipe"]
        params = {k: v.to(device) for k, v in init_pipeline_params(
            torch.Generator().manual_seed(0), n_stages, DEMO["d"],
            "cpu").items()}
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (DEMO["batch"], DEMO["seq"], DEMO["d"])).astype(np.float32)
        ).to(device)
        ref = sequential_apply(params, x)
        t0 = time.perf_counter()
        got = pipeline_apply(params, x, mesh,
                             microbatches=DEMO["microbatches"])
        wall = time.perf_counter() - t0
        err = float((got - ref).abs().max())
        ok = bool(torch.allclose(got, ref, rtol=DEMO_TOL, atol=DEMO_TOL))
        rank0_print(json.dumps({
            "pipeline": "gpipe", "stages": n_stages,
            "microbatches": DEMO["microbatches"],
            "ticks": n_stages + DEMO["microbatches"] - 1,
            "shape": [DEMO["batch"], DEMO["seq"], DEMO["d"]],
            "device": str(device), "max_abs_err": err, "tol": DEMO_TOL,
            "equal_to_sequential": ok, "wall_s": wall}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
