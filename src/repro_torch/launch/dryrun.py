"""Multi-pod dry run: trace every (arch x shape) cell on the production
meshes without allocating a single parameter (port of
``repro.launch.dryrun``).

For each cell the real step function runs once (``train_step`` with its
optimizer, the prefill forward, or ``decode_step``) on ``meta`` tensors
(``launch.shapes``), placed as the port places them on:

  * the single-pod mesh (16 x 16 = 256 ranks), and
  * the multi-pod mesh (2 x 16 x 16 = 512 ranks),

under ``roofline.analysis.StepCost``, which counts the ops rank 0
dispatches (every rank of an SPMD program runs the same ones).  The
meshes come from torch's in-process fake process group: one process
stands for rank 0 of 256 or 512, and its collectives complete without
moving data, where the reference forces 512 host devices into one
process.  What a rank counts is what the port runs: parameters stored
as blocks (``sharding.shard_module`` under ``rules_for``), each rank its
rows of the batch (``batch_rows``) where the rules shard it, the
partitioned layers computed on the rank's block of heads, hidden units,
vocab and experts (tensor parallelism on ``model``, and sequence
parallelism where the cell's config sets ``seq_parallel``) with the
FSDP blocks gathered over ``data`` at use, the other parameters
gathered whole, and a decode cache of the rank's rows and its slice of
the sequence (``kv_seq``).  Its collective bytes count each
reduce-scatter as the all-reduce and slice the port runs in its place
(gloo has none).  Records go to JSON under the reference's keys
(``roofline.analysis.analyze_step``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --tm \\
      --mesh both --out dryrun_results.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import make_production_mesh, rules_for
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
from repro_torch.roofline import analysis as roof
from repro_torch.train.train_step import make_train_step


def optimizer_for(cfg, model):
    """Arch-appropriate optimizer over ``model``: a bf16 config (the
    480B class) takes Adafactor with bf16 state (memory fit), everything
    else AdamW."""
    if cfg.param_dtype == "bfloat16":
        return make_optimizer(model, OptimizerConfig(
            name="adafactor", state_dtype="bfloat16"))
    return make_optimizer(model, OptimizerConfig(name="adamw"))


@dataclasses.dataclass
class Step:
    """One step ready to run: ``run()`` runs it once; ``held`` are the
    tensors it holds before it starts, by role (``params``, ``optimizer``,
    ``inputs``), each counted at this rank's share."""

    run: Callable[[], object]
    held: Dict[str, object]
    model: torch.nn.Module


def _rows(tree, sl: slice):
    """``tree`` (a batch, a decode state) with each tensor cut to the rows
    ``sl`` of its first dimension."""
    if isinstance(tree, dict):
        return {k: _rows(v, sl) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rows(v, sl) for v in tree]
    return tree[sl] if isinstance(tree, torch.Tensor) else tree


def build_step(cfg, kind: str, model, inputs: dict, *, state=None,
               mesh=None, rules=None, microbatches: int = 1) -> Step:
    """The step of ``kind`` (train | prefill | decode) of ``cfg`` over
    ``model`` (on any device; on meta, shapes only), whose parameters are
    stored on ``mesh`` per ``rules``.  ``inputs`` is the global batch
    (train, prefill) or ``{"token": [B, 1], "pos": int}`` (decode, against
    ``state``, the caches of the same ``B`` rows); the rank takes its
    rows of each."""
    dp = None
    if mesh is not None:
        shd.shard_module(model, mesh, rules)
        dp = shd.data_parallel_of(mesh, rules)
    if kind == "train":
        opt = optimizer_for(cfg, model)
        step = make_train_step(
            cfg, opt, microbatches=microbatches,
            accum_dtype=torch.bfloat16 if cfg.param_dtype == "bfloat16"
            else torch.float32)
        n = next(iter(inputs.values())).shape[0]
        held = {"params": model, "optimizer": list(opt.state.values()),
                "inputs": _rows(inputs, shd.batch_rows(n, dp))}
        return Step(lambda: step(model, 0, inputs), held, model)
    if kind == "prefill":
        n = next(iter(inputs.values())).shape[0]
        batch = _rows(inputs, shd.batch_rows(n, dp))
        return Step(lambda: tf.forward(model, batch, cfg, last_only=True),
                    {"params": model, "inputs": batch}, model)
    rows = shd.batch_rows(inputs["token"].shape[0], dp)
    token, state = inputs["token"][rows], _rows(state, rows)
    return Step(lambda: tf.decode_step(model, state, token, inputs["pos"],
                                       cfg),
                {"params": model, "inputs": [token, state]}, model)


def _view_bytes(tree) -> int:
    """Bytes of the elements ``tree``'s tensors address (a rank's rows of
    a batch are views of it)."""
    return sum(roof.tensor_bytes(t) for t in roof.tree_tensors(tree))


def count_step(step: Step):
    """``(cost, memory, seconds)``: ``step`` run once under
    ``StepCost``; ``memory`` its bytes by role and the peak estimate
    (what it holds plus the most the step allocates at once)."""
    cost = roof.StepCost()
    t0 = time.perf_counter()
    with cost:
        step.run()
    secs = time.perf_counter() - t0
    mem = {"params_bytes": roof.tree_bytes(step.held["params"]),
           "optimizer_bytes": roof.tree_bytes(step.held.get("optimizer",
                                                            [])),
           "args_bytes": _view_bytes(step.held["inputs"])}
    mem["step_peak_bytes"] = cost.peak_bytes
    mem["peak_bytes"] = (mem["params_bytes"] + mem["optimizer_bytes"]
                         + mem["args_bytes"] + cost.peak_bytes)
    return cost, mem, secs


def trace_cell(arch: str, shape: str, mesh, *, verbose=True) -> dict:
    """Trace one LM cell on ``mesh`` (rank 0); returns its record."""
    cfg = shp.cell_config(arch, shape)
    spec = shp.SHAPES[shape]
    rules = rules_for(cfg, mesh, global_batch=spec.global_batch,
                      pure_dp=(arch in shp.PURE_DP_ARCHS
                               and spec.kind == "train"))
    t0 = time.perf_counter()
    with shd.use_sharding(mesh, rules):
        step = build_step(
            cfg, spec.kind, shp.abstract_params(cfg),
            shp.input_specs(cfg, shape),
            state=shp.abstract_decode_state(cfg, shape)
            if spec.kind == "decode" else None,
            mesh=mesh, rules=rules,
            microbatches=shp.TRAIN_MICROBATCHES.get(arch, 1)
            if spec.kind == "train" else 1)
        cost, mem, _ = count_step(step)
    trace_s = time.perf_counter() - t0
    mflops = roof.model_flops_per_step(cfg, step.model.named_parameters(),
                                       spec.kind, spec.global_batch,
                                       spec.seq)
    rec = roof.analyze_step(arch, shape, mesh, spec.kind, cost, mflops, mem,
                            trace_s)
    if verbose:
        print(f"  memory: {mem}")
        print(f"  flops={rec['hlo_flops']:.3e} bytes={rec['hlo_bytes']:.3e}"
              f" collective_bytes={rec['collective_bytes']:.3e}")
        print(f"  traced in {trace_s:.1f}s ({cost.ops} ops)")
    return rec


TM_SHAPES = {"tm_train_4k": ("train", 4096),
             "tm_infer_32k": ("infer", 32768),
             "imbue_infer_32k": ("analog", 32768)}
TM_CELL_ARCHS = ["imbue-tm-mnist", "imbue-tm-fmnist"]


def trace_tm_cell(arch: str, shape: str, mesh, *, verbose=True) -> dict:
    """The paper's TM workload through the same dry-run machinery.  On
    meta the steps run the kernels' plain versions (no kernel can run
    there, and a ``ctypes`` launch is not a dispatcher op): those are
    what is counted, beside the reference's analytic ``model_flops``."""
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.core import tm_distributed as tmd
    from repro_torch.core.imbue import IMBUEConfig

    cfg = tmd.pad_clauses_for_mesh(tm_config(arch), mesh)
    kind, batch = TM_SHAPES[shape]
    st_sh, x_sh, y_sh = tmd.tm_shardings(cfg, mesh, batch)
    c, l = cfg.n_clauses, cfg.n_literals
    meta = shp.META

    def place(sh, t):
        return sh.place(t) if sh.partitions else t

    x = place(x_sh, torch.empty((batch, cfg.n_features), dtype=torch.uint8,
                                device=meta))
    t0 = time.perf_counter()
    cost = roof.StepCost()
    if kind == "train":
        st = place(st_sh, torch.empty((c, l), dtype=torch.int16,
                                      device=meta))
        y = place(y_sh, torch.empty((batch,), dtype=torch.int64,
                                    device=meta))
        held = [st, x, y]
        with cost:
            tmd.tm_train_step(st, torch.Generator().manual_seed(0), x, y,
                              cfg)
        mult, active = 4.0, 1.0   # fwd eval + delta passes (analytic)
    elif kind == "infer":
        st = place(st_sh, torch.empty((c, l), dtype=torch.int16,
                                      device=meta))
        held = [st, x]
        with cost:
            tmd.tm_infer_step(st, x, cfg)
        mult, active = 2.0, 1.0
    else:   # analog
        g, lk, inc = (place(st_sh, torch.empty((c, l), dtype=dt,
                                               device=meta))
                      for dt in (torch.float32, torch.float32, torch.bool))
        held = [g, lk, inc, x]
        icfg = IMBUEConfig()
        with cost:
            tmd.imbue_infer_step(g, lk, inc, x, cfg, v_read=icfg.v_read,
                                 r_div=icfg.r_divider,
                                 v_ref=icfg.reference_voltage())
        mult, active = 4.0, 1.0   # on-path + leak-path products
    trace_s = time.perf_counter() - t0
    args = _view_bytes(held)
    mem = {"params_bytes": 0, "optimizer_bytes": 0, "args_bytes": args,
           "step_peak_bytes": cost.peak_bytes,
           "peak_bytes": args + cost.peak_bytes}
    rec = roof.analyze_step(arch, shape, mesh, f"tm_{kind}", cost,
                            mult * batch * c * l * active, mem, trace_s,
                            extra={"counted": "plain versions"})
    if verbose:
        print(f"  flops={rec['hlo_flops']:.3e} bytes={rec['hlo_bytes']:.3e}"
              f" collective_bytes={rec['collective_bytes']:.3e}"
              f" dominant={rec['dominant']}")
    return rec


def fake_group(world_size: int) -> None:
    """This process as rank 0 of an in-process fake group of
    ``world_size`` ranks (an existing default group is destroyed first):
    its collectives complete without moving data."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def production_mesh(multi_pod: bool):
    """The production mesh on a fake group of its size (256 or 512)."""
    fake_group(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tm", action="store_true",
                    help="include the paper's TM cells")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        todo = [(a, s) for a, s, ok, _ in shp.cells() if ok]
        if args.tm:
            todo += [(a, s) for a in TM_CELL_ARCHS for s in TM_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        todo = [(args.arch, args.shape)]

    results, failures = [], []
    try:
        for multi in meshes:
            mesh = production_mesh(multi)
            mname = "multi(2x16x16)" if multi else "single(16x16)"
            for arch, shape in todo:
                print(f"[dryrun] {arch} x {shape} on {mname}", flush=True)
                try:
                    if arch.startswith("imbue-tm"):
                        rec = trace_tm_cell(arch, shape, mesh)
                    else:
                        rec = trace_cell(arch, shape, mesh)
                    results.append(rec)
                except Exception as e:  # noqa: BLE001
                    # a cell's failure is recorded; the others go on
                    traceback.print_exc()
                    failures.append({"arch": arch, "shape": shape,
                                     "mesh": mname, "error": str(e)[:500]})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    skipped = [{"arch": a, "shape": s, "reason": why}
               for a, s, ok, why in shp.cells(include_skipped=True)
               if not ok]
    out = {"results": results, "failures": failures, "skipped": skipped}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\n{len(results)} cells traced, {len(failures)} failures, "
          f"{len(skipped)} skipped-by-rule -> {args.out}")
    if failures:
        for f_ in failures:
            print("FAIL:", f_["arch"], f_["shape"], f_["mesh"],
                  f_["error"][:200])
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
