"""Serving and debug meshes on ``torch.distributed`` (port of
``repro.launch.mesh``).

A mesh here is a ``DeviceMesh`` over the ranks of the default process
group, one process a rank, so making one needs a group of exactly its
size: ``--host-devices N`` on the CLIs spawns N host ranks
(``launch.hostdev``), and on the card ``python -m torch.distributed.run
--standalone --nproc-per-node N ...`` starts them (gloo where ranks share
one card, which NCCL refuses).  ``rules_for`` adapts the LM sharding
rules to an arch, a mesh and a workload; ``make_production_mesh`` is the
reference's pod mesh, which needs a group of 256 (or 512) ranks.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch._device import resolve_device
from repro_torch.distributed.sharding import ShardingRules, mesh_shape
from repro_torch.models.config import ModelConfig


def _mesh(shape, names, device_type: Optional[str]) -> DeviceMesh:
    """A mesh of ``shape`` over the default group's ranks, on
    ``device_type`` (default: the CUDA card; ``"cpu"`` on host ranks)."""
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise ValueError(
            f"a mesh of shape {tuple(shape)} needs a process group of {n} "
            "ranks and none is initialised; run under --host-devices N or "
            "python -m torch.distributed.run --nproc-per-node N")
    if dist.get_world_size() != n:
        raise ValueError(
            f"a mesh of shape {tuple(shape)} needs {n} ranks but the "
            f"process group has {dist.get_world_size()}")
    device_type = device_type or resolve_device(None).type
    if device_type == "cuda" and not torch.cuda.is_initialized():
        # DeviceMesh would select card LOCAL_RANK, which a machine whose
        # ranks share fewer cards lacks: select it modulo the cards.
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
        torch.cuda.init()
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """Single pod: 16x16 = 256 ranks (data, model).  Multi-pod: 2 pods of
    256 = 512 ranks (pod, data, model).  Raises unless the process group
    has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    device_type: Optional[str] = None) -> DeviceMesh:
    """Small ``(data, model)`` mesh for multi-rank tests."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)


def make_pipeline_mesh(stages: int = 4, *,
                       device_type: Optional[str] = None) -> DeviceMesh:
    """Pipeline-parallel mesh ``(pipe,)``."""
    return _mesh((stages,), ("pipe",), device_type)


def make_replica_mesh(n_replica: int, n_batch: int = 1, *,
                      device_type: Optional[str] = None) -> DeviceMesh:
    """Serving mesh for sharded replica pools: ``("replica", "batch")``.

    The ``replica`` axis splits a pool's programmed ``[R, C, L]`` stack
    (a shard of chips a rank); the ``batch`` axis splits request rows for
    data-parallel reads.  Consumed by ``ReplicaPool.shard`` through
    ``distributed.sharding.replica_rules``."""
    return _mesh((n_replica, n_batch), ("replica", "batch"), device_type)


def parse_mesh_spec(spec: str, *,
                    device_type: Optional[str] = None) -> DeviceMesh:
    """``"8"`` or ``"2x4"`` -> a replica[xbatch] serving mesh.

    The product must equal the process group's size (``--host-devices N``
    on the CLIs, or ``torch.distributed.run``)."""
    parts = spec.lower().split("x")
    if not 1 <= len(parts) <= 2:
        raise ValueError(f"bad mesh spec {spec!r}; want 'R' or 'RxB'")
    try:
        dims = [int(p) for p in parts]
    except ValueError:
        raise ValueError(f"bad mesh spec {spec!r}; want 'R' or 'RxB'")
    n_replica, n_batch = dims[0], dims[1] if len(dims) == 2 else 1
    if n_replica < 1 or n_batch < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec!r}")
    return make_replica_mesh(n_replica, n_batch, device_type=device_type)


def batch_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def _batch_ranks(sizes, axes) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def rules_for(cfg: ModelConfig, mesh, *, global_batch: Optional[int] = None,
              pure_dp: bool = False) -> ShardingRules:
    """Sharding rules adapted to arch + mesh + workload (the reference's,
    rule for rule).

    - batch shards over (pod, data) — dropped entirely if the global batch
      doesn't divide;
    - tensor/expert axes stay on "model";
    - sequence parallelism is declared when ``cfg.seq_parallel``;
    - ``pure_dp``: sub-1B archs fold "model" into the batch axes and keep
      parameters FSDP over "data".
    """
    sizes = mesh_shape(mesh)
    if pure_dp and "model" in sizes:
        b_axes = tuple(a for a in ("data", "model") if a in sizes)
        n = _batch_ranks(sizes, b_axes)
        if global_batch is None or global_batch % n == 0:
            return ShardingRules(
                batch=b_axes, seq=None, embed=None, heads=None,
                kv_seq=None, expert=None, vocab=None, mlp=None,
                fsdp="data", tensor=None)
    b_axes = batch_axes(mesh)
    if global_batch is not None and \
            global_batch % _batch_ranks(sizes, b_axes):
        b_axes = ()
    return ShardingRules(
        batch=b_axes if b_axes else None,
        seq="model" if cfg.seq_parallel else None,
        embed=None,
        heads="model",
        kv_seq="model",
        expert="model",
        vocab="model",
        mlp="model",
        fsdp="data" if "data" in sizes else None,
        tensor="model" if "model" in sizes else None,
    )
