"""Roofline analysis of one step as the port runs it (port of
``repro.roofline.analysis``).

The reference walks XLA's optimized, SPMD-partitioned HLO text.  The port
runs eagerly, so its counterpart counts the ops themselves: :class:`StepCost`
is a ``TorchDispatchMode`` that sees every aten and ``c10d`` op the step
dispatches, on one rank (every rank of an SPMD program runs the same
ops), on the card or on the ``meta`` device, where shapes and dtypes flow
and nothing is allocated or computed (the dry run, ``launch.dryrun``):

* **flops**: the matrix products (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions, attention; ``torch.utils.flop_counter``'s
  formulas), as the reference counts ``dot`` s only, split by the
  product's dtype because the card's rate depends on it.
* **bytes**: per op, result + operand bytes: the HBM-traffic proxy.  In
  eager mode every op is a kernel and a round trip, so this counts real
  traffic.  The reference's corrections (``_io_bytes``): metadata-only
  ops (views, ``reshape`` as a view, ``expand``, ``t`` / ``transpose``,
  ``slice`` / ``select``, ``detach``, ``alias``, ``empty``) count 0;
  ``index_select`` / ``gather`` / ``embedding`` read 2 x the result; an
  in-place ``copy_`` / ``index_copy_`` / ``index_put_`` (a cache slot, a
  stack's row) 2 x the update; fills and ``*_like`` factories the result
  alone.
* **collective_bytes**: operand bytes of the ``c10d`` collectives,
  classified as all-gather, all-reduce (x 2, the algorithmic factor, as
  the reference), reduce-scatter, all-to-all, send-recv (the reference's
  collective-permute: bytes sent) and broadcast.  The port reduces and
  scatters (an FSDP gradient, a sequence-parallel exit) by an
  all-reduce and a slice on every backend, since gloo has no
  reduce-scatter, so those count at an all-reduce's bytes.
* **peak memory**: the most bytes live at once among the storages the
  step allocates (a view shares its base's bytes; a storage dies when its
  last tensor does), to which the caller adds its arguments' bytes.

The counts are per device already: ``compute_s`` = sum over dtypes of
FLOPs / the card's rate for the dtype, ``memory_s`` = bytes / HBM,
``collective_s`` = collective bytes / ``LINK_BW``.

What has no counterpart here: ``parse_computations``, ``_trip_count``
and ``xla_cost_dict`` read XLA's HLO text and cost dict.  Eager PyTorch
runs a Python loop unrolled, so every iteration is dispatched and
counted, and there is no trip count to recover.  A CUDA kernel launched
through ``ctypes`` is not a dispatcher op, so the mode cannot see it; on
meta the TM cells run the kernels' plain versions, and those are what is
counted.

Hardware constants: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity, at the 700 W limit): 989 TFLOP/s in bf16 and fp16 on the
tensor cores, 67 TFLOP/s in float32 outside them (the port runs IEEE
float32, never TF32), 1,979 TFLOP/s in fp8 and 1,979 TOP/s in int8,
3.35 TB/s of HBM.  ``LINK_BW`` is one 400 Gb/s NDR InfiniBand port a GPU
(50 GB/s): every axis of both production meshes spans 16 ranks, more than
one 8-GPU NVLink node; NVLink's 450 GB/s each way holds for groups of 8
or fewer.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

BF16_FLOPS = 989e12           # bf16 / fp16, dense, tensor cores
FP32_FLOPS = 67e12            # float32 outside the tensor cores
INT8_OPS = 1979e12            # int8 (and fp8), dense, tensor cores
HBM_BW = 3.35e12
LINK_BW = 50e9                # one NDR port a GPU (axes of 16 ranks)

# The card's rate for a product of each dtype; products of other dtypes
# (integers wider than 8 bits, float64) count at the float32 rate.
PEAK_FLOPS: Dict[str, float] = {
    "bfloat16": BF16_FLOPS, "float16": BF16_FLOPS,
    "float32": FP32_FLOPS,
    "float8_e4m3fn": INT8_OPS, "float8_e5m2": INT8_OPS,
    "int8": INT8_OPS, "uint8": INT8_OPS,
}

_SKIP_BYTES_OPS = {
    "_unsafe_view", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "empty_permuted", "set_", "record_stream",
}
_GATHER_OPS = {"index_select", "gather", "embedding"}
# in-place writes of an update into a slice: the update's argument index
_UPDATE_ARG = {"copy_": 1, "index_copy_": 3, "index_put_": 2}
_RESULT_ONLY_OPS = {
    "zeros_like", "ones_like", "full_like", "rand_like", "randn_like",
    "randint_like", "new_zeros", "new_ones", "new_full", "zero_", "fill_",
    "normal_", "uniform_", "random_", "bernoulli_", "exponential_",
}
# c10d op name -> (kind, index of the operand argument)
_COLLECTIVES = {
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "all_to_all_single": ("all-to-all", 0),
    "send": ("send-recv", 0),
    "broadcast_": ("broadcast", 0),
    "broadcast": ("broadcast", 0),
}
# the receiving half of a send-recv pair (its bytes are the sender's)
_NO_COLLECTIVE_BYTES = {"recv_", "recv_any_source_", "barrier",
                        "monitored_barrier_"}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's block on this rank (what the rank holds and moves)."""
    inner = getattr(t, "_local_tensor", None)
    return inner if isinstance(inner, torch.Tensor) else t


def tensor_bytes(t) -> int:
    """Bytes of the elements ``t`` addresses (a view's, not its base's)."""
    if not isinstance(t, torch.Tensor):
        return 0
    t = _local(t)
    return t.numel() * t.element_size()


def tree_tensors(tree) -> Iterable[torch.Tensor]:
    """The tensors among ``tree``'s leaves."""
    return (x for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


def tree_bytes(tree) -> int:
    """Bytes held by the tensors of ``tree`` (a module's parameters, an
    optimizer's state, a batch, a decode state), each storage once."""
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    seen, total = set(), 0
    for t in tree_tensors(tree):
        st = _local(t).untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


class StepCost(TorchDispatchMode):
    """The per-device count of the ops dispatched inside the block: FLOPs
    by dtype, bytes, collective bytes by kind and the peak of the bytes
    the block allocated (module docstring).  On the card autograd runs the
    backward on its own threads, which carry the mode; the counts are
    taken under a lock."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = {}
        self.bytes = 0.0
        self.collective_bytes = 0.0
        self.collective_detail: Dict[str, float] = {}
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: Dict[int, int] = {}
        self._lock = threading.RLock()

    @property
    def flops(self) -> float:
        return sum(self.flops_by_dtype.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        with self._lock:
            self._count(func, args, kwargs, out)
        return out

    # -- counting -----------------------------------------------------
    def _count(self, func, args, kwargs, out) -> None:
        self.ops += 1
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        packet = func.overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            res = next(iter(tree_tensors(out)), None)
            key = str(res.dtype).replace("torch.", "") if res is not None \
                else "float32"
            self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0.0) + n
        if ns in ("c10d", "_c10d_functional"):
            self._collective(name, args)
        self.bytes += self._io_bytes(func, name, args, out)
        self._track(args, out)

    def _collective(self, name: str, args) -> None:
        if name in _NO_COLLECTIVE_BYTES:
            return
        kind, i = _COLLECTIVES.get(name, (name, 0))
        factor = 2.0 if kind == "all-reduce" else 1.0
        nbytes = factor * sum(tensor_bytes(t) for t in tree_tensors(args[i]))
        self.collective_bytes += nbytes
        self.collective_detail[kind] = \
            self.collective_detail.get(kind, 0.0) + nbytes

    @staticmethod
    def _io_bytes(func, name: str, args, out) -> float:
        if func.is_view or name in _SKIP_BYTES_OPS:
            return 0.0
        result = sum(tensor_bytes(t) for t in tree_tensors(out))
        if name in _GATHER_OPS:
            return 2.0 * result
        if name in _UPDATE_ARG:
            return 2.0 * tensor_bytes(args[_UPDATE_ARG[name]])
        if name in _RESULT_ONLY_OPS:
            return float(result)
        return float(result + sum(tensor_bytes(t) for t in tree_tensors(args)))

    def _track(self, args, out) -> None:
        """New storages among the results join the live bytes until their
        last tensor dies."""
        inputs = {id(_local(t).untyped_storage()) for t in tree_tensors(args)}
        for t in tree_tensors(out):
            st = _local(t).untyped_storage()
            key = id(st)
            if key in inputs or key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        with self._lock:
            self.live_bytes -= self._storages.pop(key, 0)


def step_times(cost: StepCost) -> dict:
    """``compute_s``, ``memory_s``, ``collective_s`` and the ``dominant``
    term of a per-device count."""
    compute_s = sum(n / PEAK_FLOPS.get(dt, FP32_FLOPS)
                    for dt, n in cost.flops_by_dtype.items())
    memory_s = cost.bytes / HBM_BW
    coll_s = cost.collective_bytes / LINK_BW
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", coll_s)), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s, "dominant": dominant}


def collective_bytes(cost: StepCost) -> Dict[str, float]:
    """``{"total": bytes, kind: bytes, ...}`` of a count."""
    return {"total": cost.collective_bytes, **cost.collective_detail}


def model_flops_per_step(cfg, params, kind: str, global_batch: int,
                         seq: int) -> float:
    """Analytic MODEL_FLOPS: 6*N*D (train) / 2*N_active*D (fwd-only),
    N = active non-embedding params.  ``params``: a module or ``(name,
    tensor)`` pairs, under the reference's leaf names."""
    if isinstance(params, torch.nn.Module):
        params = params.named_parameters()
    total = 0
    expert_total = 0
    for path, leaf in params:
        if "embeddings" in path:
            continue
        n = 1
        for d in leaf.shape:
            n *= d
        total += n
        if "experts_" in path:
            expert_total += n
    active = total
    if cfg.moe is not None:
        frac = cfg.moe.top_k / cfg.moe.n_experts
        active = total - expert_total + expert_total * frac
    tokens = global_batch * (seq if kind in ("train", "prefill") else 1)
    mult = 6.0 if kind == "train" else 2.0
    return mult * active * tokens


def mesh_name(mesh) -> str:
    """``"data=16xmodel=16"``, as the reference names a mesh."""
    return "x".join(f"{k}={v}" for k, v in zip(mesh.mesh_dim_names,
                                               mesh.shape))


def analyze_step(arch: str, shape: str, mesh, kind: str, cost: StepCost,
                 model_flops: float, memory: dict, trace_s: float,
                 extra: Optional[dict] = None) -> dict:
    """One roofline record, under the reference's keys (``hlo_*``: counted
    over the traced step, global = per device x devices)."""
    n_dev = mesh.size() if mesh is not None else 1
    t = step_times(cost)
    rec = {
        "arch": arch, "shape": shape,
        "mesh": mesh_name(mesh) if mesh is not None else "single-rank",
        "devices": n_dev, "kind": kind,
        "hlo_flops": cost.flops * n_dev,
        "hlo_bytes": cost.bytes * n_dev,
        "collective_bytes": cost.collective_bytes * n_dev,
        "per_device": {"flops": cost.flops, "bytes": cost.bytes,
                       "collective_bytes": cost.collective_bytes},
        "flops_by_dtype": dict(cost.flops_by_dtype),
        **t,
        "model_flops": model_flops,
        "useful_ratio": model_flops / max(cost.flops * n_dev, 1.0),
        "collective_ops": dict(cost.collective_detail),
        "memory_analysis": memory,
        "trace_s": round(trace_s, 1),
    }
    if extra:
        rec.update(extra)
    return rec
