"""Logical-axis sharding on ``torch.distributed`` (port of
``repro.distributed.sharding``).

Models never mention mesh axes.  They call ``constrain(x, *logical_axes)``
with *logical* names ("batch", "seq", "heads", ...); the launcher
activates a :class:`ShardingRules` mapping logical -> mesh axes for the
current mesh.  With no active rules every call is a no-op, and it never
moves a plain tensor (see :func:`constrain`).

A spec is a tuple with one entry per tensor dimension: a mesh-axis name,
a tuple of names (the dimension splits over their product, the first
name outermost), or ``None`` (whole).  Parameter specs are name-based:
:func:`param_pspec` maps a leaf's dot-joined path to a spec
(Megatron-style TP on ``model`` + FSDP on ``data``; the serving pools'
``r_stack`` and coalesced ``weights`` split over ``replica``) and drops
an axis that does not divide its dimension on the mesh.

The process model differs from the reference's.  A jax mesh is many
devices in one process; here a ``DeviceMesh`` has one process a rank, all
running the same program.  A tensor that is whole on every rank is a
plain tensor: that is what replication is under one process a rank.  A
leaf whose spec partitions it (a mesh axis of size > 1) becomes a
``DTensor`` holding this rank's block, cut from the whole tensor every
rank holds, with no communication (:func:`distribute`).  Eager code
never runs on a ``DTensor``: a partitioned read takes each operand's
local block (:func:`local_block`), computes its block of the result and
gathers the blocks (:func:`assemble`), which is where the reference's
GSPMD partitioning of its jnp paths lands in this port.  The LM models
partition their layers over the tensor axis themselves, Megatron-style
(:class:`TensorParallel`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

Spec = Tuple


def P(*axes) -> Spec:
    """A spec: one entry per tensor dimension (the reference's
    ``PartitionSpec``)."""
    return tuple(axes)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical axis -> mesh axis (or None = replicated)."""

    batch: Optional[Tuple[str, ...] | str] = ("pod", "data")
    seq: Optional[str] = None           # sequence parallelism when "model"
    embed: Optional[str] = None         # activation d_model axis
    heads: Optional[str] = "model"      # attention heads / q projections
    kv_seq: Optional[str] = "model"     # KV-cache sequence axis (decode)
    expert: Optional[str] = "model"     # MoE expert axis
    vocab: Optional[str] = "model"      # logits vocab axis
    mlp: Optional[str] = "model"        # ffn hidden axis
    fsdp: Optional[str] = "data"        # parameter fsdp axis
    tensor: Optional[str] = "model"     # parameter TP axis
    replica: Optional[str] = None       # serve-pool [R, ...] leading dim

    def resolve(self, logical: Optional[str]):
        if logical is None:
            return None
        return getattr(self, logical)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (the reference's
    ``mesh.shape``); a mapping, or an object with a ``shape`` mapping,
    passes through."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: Spec

    def placements(self) -> List:
        return placements(self.mesh, self.spec)

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """The whole tensor ``x`` placed per this sharding: a ``DTensor``
        (:func:`distribute`)."""
        return distribute(x, self.mesh, self.spec)

    @property
    def partitions(self) -> bool:
        """True when the spec splits some dimension over more than one
        rank."""
        shape = mesh_shape(self.mesh)
        return any(_axis_size(shape, ax) > 1 for ax in self.spec)


_ACTIVE: contextvars.ContextVar[Optional["ActiveSharding"]] = \
    contextvars.ContextVar("active_sharding", default=None)


@dataclasses.dataclass(frozen=True)
class ActiveSharding:
    mesh: Any
    rules: ShardingRules


@contextlib.contextmanager
def use_sharding(mesh, rules: ShardingRules):
    """Inside the block ``constrain`` places per ``rules`` on ``mesh``, and
    the models compute their partitioned layers on this rank's block
    where ``rules`` put a tensor axis of more than one rank on ``mesh``
    (:func:`tensor_parallel_of`; process-wide, see :data:`_TP`)."""
    tok = _ACTIVE.set(ActiveSharding(mesh, rules))
    prev, _TP[0] = _TP[0], tensor_parallel_of(mesh, rules)
    try:
        yield
    finally:
        _TP[0] = prev
        _ACTIVE.reset(tok)


def active() -> Optional[ActiveSharding]:
    return _ACTIVE.get()


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """Place ``x`` per the active rules (a no-op without them): a
    ``DTensor`` is redistributed.  A plain tensor passes as it is: eager
    code places its activations itself (the models' tensor-parallel
    layers, :class:`TensorParallel`), so the sites where the reference
    hints a layout to its partitioner place nothing here."""
    act = _ACTIVE.get()
    if act is None or not isinstance(x, DTensor):
        return x
    spec = P(*(act.rules.resolve(a) for a in logical_axes))
    return x.redistribute(act.mesh, placements(act.mesh, spec))


# ------------------------------------------------------- parameter specs

# (regex on the dot-joined path, spec builder).  Rules give the spec of
# the unstacked parameter; param_pspec pads extra leading (layer-stack)
# dimensions with None.
_PARAM_RULES = [
    # serve replica pools: programmed chips split over the replica axis,
    # shared TA actions (include planes) replicated
    (r"r_stack$",          lambda r: P(r.replica, None, None)),
    # coalesced pools: the shared [C, L] clause pool replicates, the
    # [C, M] per-class weight columns split over the replica axis
    # (class-parallel serving)
    (r"(^|\.)weights$",    lambda r: P(None, r.replica)),
    # embeddings / head
    (r"embed$",            lambda r: P(r.tensor, r.fsdp)),
    (r"unembed$",          lambda r: P(r.fsdp, r.tensor)),
    (r"w_vision$",         lambda r: P(None, r.fsdp)),
    # attention (q/k/v: [D, H, dh]; o: [H, dh, D])
    (r"w_q$",              lambda r: P(r.fsdp, r.tensor, None)),
    (r"w_k$",              lambda r: P(r.fsdp, r.tensor, None)),
    (r"w_v$",              lambda r: P(r.fsdp, r.tensor, None)),
    (r"w_o$",              lambda r: P(r.tensor, None, r.fsdp)),
    (r"b_[qkv]$",          lambda r: P(r.tensor, None)),
    # MLA
    (r"w_dkv$",            lambda r: P(r.fsdp, None)),
    (r"w_kpe$",            lambda r: P(r.fsdp, None)),
    (r"w_uk$",             lambda r: P(None, r.tensor, None)),
    (r"w_uv$",             lambda r: P(None, r.tensor, None)),
    (r"kv_norm$",          lambda r: P(None)),
    # dense MLP
    (r"w_up$",             lambda r: P(r.fsdp, r.tensor)),
    (r"w_gate$",           lambda r: P(r.fsdp, r.tensor)),
    (r"w_down$",           lambda r: P(r.tensor, r.fsdp)),
    # MoE
    (r"router$",           lambda r: P(r.fsdp, None)),
    (r"experts_up$",       lambda r: P(r.expert, r.fsdp, None)),
    (r"experts_gate$",     lambda r: P(r.expert, r.fsdp, None)),
    (r"experts_down$",     lambda r: P(r.expert, None, r.fsdp)),
    # mamba2 (split projections: z/x shard on d_inner, B/C/dt replicated)
    (r"w_[zx]$",           lambda r: P(r.fsdp, r.tensor)),
    (r"w_bc$",             lambda r: P(r.fsdp, None)),
    (r"w_dt$",             lambda r: P(r.fsdp, None)),
    (r"w_out$",            lambda r: P(r.tensor, r.fsdp)),
    (r"conv_x_w$",         lambda r: P(None, r.tensor)),
    (r"conv_x_b$",         lambda r: P(r.tensor)),
    (r"conv_bc_[wb]$",     lambda r: P(None)),
    # xlstm (mLSTM projections shard on d_inner; sLSTM R is tiny)
    (r"w_m[qkv]$",         lambda r: P(r.fsdp, r.tensor)),
    (r"w_gates$",          lambda r: P(r.fsdp, None)),
    (r"r_gates$",          lambda r: P(None, None, None)),
    (r"w_ogate$",          lambda r: P(r.fsdp, r.tensor)),
    (r"gate_bias$",        lambda r: P(None)),
    # norms / scalars: replicated
    (r"(scale|bias|a_log|d_skip|dt_bias|norm_scale|f_bias)$",
     lambda r: P(None)),
]


def _axis_size(shape: Mapping[str, int], ax) -> int:
    """Ranks that mesh axis ``ax`` (a name, a tuple of names or None)
    spans in ``shape``."""
    if ax is None:
        return 1
    n = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        n *= shape[a]
    return n


def param_pspec(path: str, shape: tuple, rules: ShardingRules,
                mesh=None) -> Spec:
    """The spec of the parameter leaf at dot-joined ``path``.

    Extra leading (layer-stack) dimensions are padded with None; Adafactor
    state leaves derive from their parameter (``.row`` drops the last
    axis, ``.col`` the second-to-last, ``.full`` keeps it).  With ``mesh``,
    an axis that does not divide its dimension is dropped (2 KV heads
    cannot split 16 ways: that dimension stays whole)."""
    ndim = len(shape)
    suffix = None
    for sfx in (".row", ".col", ".full"):
        if path.endswith(sfx):
            suffix = sfx[1:]
            path = path[: -len(sfx)]
            break
    for pat, fn in _PARAM_RULES:
        if re.search(pat, path):
            spec = tuple(fn(rules))
            if suffix == "row" and len(spec) >= 1:
                spec = spec[:-1]
            elif suffix == "col" and len(spec) >= 2:
                spec = spec[:-2] + spec[-1:]
            pad = ndim - len(spec)
            if pad < 0:
                axes = list(spec[-ndim:] if ndim else ())
            else:
                axes = [None] * pad + list(spec)
            return P(*axes) if mesh is None else fit_spec(shape, mesh, axes)
    return P()   # default: replicated


def fit_spec(shape: tuple, mesh, spec) -> Spec:
    """``spec`` with every axis that does not divide its dimension of
    ``shape`` on ``mesh`` dropped (that dimension stays whole)."""
    sizes = mesh_shape(mesh)
    return P(*(ax if dim % _axis_size(sizes, ax) == 0 else None
               for dim, ax in zip(shape, spec)))


# ----------------------------------------------------------------- trees
#
# A tree is nested dicts, lists and tuples with tensors as leaves; a
# dataclass instance (a backend state, a pool) is a node whose children
# are its fields that hold tensors or containers (configs and scalars are
# kept as they are).  Paths join dict keys, sequence indices and field
# names with ".", as the reference joins its pytree keys.

def _is_leaf(x) -> bool:
    return isinstance(x, torch.Tensor) or (
        hasattr(x, "shape") and not isinstance(x, (dict, list, tuple))
        and not dataclasses.is_dataclass(x))


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) or (
        dataclasses.is_dataclass(x) and not isinstance(x, type))


def _dataclass_children(obj) -> Dict[str, Any]:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if _is_leaf(v) or isinstance(v, (dict, list, tuple)):
            out[f.name] = v
    return out


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, *,
                       as_dict: bool = False, _path: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)`` (``None``
    stays ``None``).  A dataclass node is rebuilt with
    ``dataclasses.replace``, or, with ``as_dict``, becomes a dict of its
    mapped fields (for trees of specs, which no dataclass would accept)."""
    def sub(key):
        return f"{_path}.{key}" if _path else str(key)

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, as_dict=as_dict, _path=sub(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_leaf(tree):
        out = [tree_map_with_path(fn, v, as_dict=as_dict, _path=sub(i))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    if _is_node(tree) and not _is_leaf(tree):
        mapped = {k: tree_map_with_path(fn, v, as_dict=as_dict,
                                        _path=sub(k))
                  for k, v in _dataclass_children(tree).items()}
        return mapped if as_dict else dataclasses.replace(tree, **mapped)
    return fn(_path, tree)


def tree_leaves(tree) -> List:
    out = []
    tree_map_with_path(lambda _, x: out.append(x), tree, as_dict=True)
    return out


def tree_pspecs(tree, rules: ShardingRules, mesh=None):
    """The spec tree matching ``tree`` (a dataclass maps to a dict)."""
    return tree_map_with_path(
        lambda path, leaf: param_pspec(path, tuple(leaf.shape), rules, mesh),
        tree, as_dict=True)


def tree_shardings(tree, mesh, rules: ShardingRules):
    """The :class:`NamedSharding` tree matching ``tree`` on ``mesh``."""
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, param_pspec(path, tuple(leaf.shape), rules, mesh)),
        tree, as_dict=True)


def batch_pspec(rules: ShardingRules) -> Spec:
    return P(rules.batch)


def cache_pspec(shape: tuple, mesh, rules: ShardingRules, batch_size: int,
                seq_len: int) -> Spec:
    """Decode-cache leaf spec: shard the batch-sized axis on the batch
    axes and the context-length axis on ``kv_seq``; everything else
    replicated.  Purely size-driven, so it covers KV caches, MLA latents,
    SSM states and conv windows alike."""
    sizes = mesh_shape(mesh)
    axes = [None] * len(shape)
    used_batch = used_seq = False
    for i, dim in enumerate(shape):
        if (not used_batch and rules.batch and batch_size > 1
                and dim == batch_size
                and dim % _axis_size(sizes, rules.batch) == 0):
            axes[i] = rules.batch
            used_batch = True
        elif (not used_seq and rules.kv_seq and dim == seq_len
                and dim % _axis_size(sizes, rules.kv_seq) == 0):
            axes[i] = rules.kv_seq
            used_seq = True
    return P(*axes)


def cache_shardings(tree, mesh, rules: ShardingRules, batch_size: int,
                    seq_len: int):
    return tree_map_with_path(
        lambda _, leaf: NamedSharding(mesh, cache_pspec(
            tuple(leaf.shape), mesh, rules, batch_size, seq_len)),
        tree, as_dict=True)


def replica_rules(mesh) -> ShardingRules:
    """Serving rules for a replica-pool mesh (``launch.mesh
    .make_replica_mesh``): the programmed ``[R, ...]`` stack splits over
    ``replica``; request rows optionally split over ``batch``.  Every
    model-parallel axis is off: replica reads are embarrassingly
    parallel."""
    names = mesh_shape(mesh)
    return ShardingRules(
        batch="batch" if "batch" in names else None,
        seq=None, embed=None, heads=None, kv_seq=None, expert=None,
        vocab=None, mlp=None, fsdp=None, tensor=None,
        replica="replica" if "replica" in names else None)


def validate_divisibility(tree, mesh, rules: ShardingRules) -> list:
    """``(path, shape, spec)`` of every leaf whose mesh-unaware spec does
    not divide its shape (where the mesh-aware fix-up dropped an axis)."""
    bad = []

    def check(path, leaf):
        shape = tuple(leaf.shape)
        spec = param_pspec(path, shape, rules)
        if spec != param_pspec(path, shape, rules, mesh):
            bad.append((path, shape, spec))
    tree_map_with_path(check, tree, as_dict=True)
    return bad


# ------------------------------------------------- placement on the mesh

def placements(mesh, spec: Spec) -> List:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that splits tensor dimension ``d``, ``Replicate()`` on
    the others."""
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return out


def _block_slices(shape, mesh, pls) -> Tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` under placements
    ``pls``: one slice a dimension.  Mesh dimensions that split the same
    tensor dimension nest, the first outermost."""
    coord = mesh.get_coordinate()
    idx = [0] * len(shape)
    parts = [1] * len(shape)
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            n = mesh.size(i)
            idx[p.dim] = idx[p.dim] * n + coord[i]
            parts[p.dim] *= n
    out = []
    for dim, (k, n) in enumerate(zip(idx, parts)):
        if shape[dim] % n:
            raise ValueError(
                f"dimension {dim} of size {shape[dim]} does not split "
                f"evenly over {n} ranks; drop the axis (param_pspec does "
                "so with a mesh) or pad the dimension")
        step = shape[dim] // n
        out.append(slice(k * step, (k + 1) * step))
    return tuple(out)


def distribute(x: torch.Tensor, mesh, spec: Spec) -> DTensor:
    """The whole tensor ``x`` (every rank holds it) as a ``DTensor`` of
    ``spec`` on ``mesh``: this rank keeps its block (a view of ``x`` where
    the block is contiguous).  No communication."""
    pls = placements(mesh, spec)
    local = x[_block_slices(tuple(x.shape), mesh, pls)]
    return DTensor.from_local(local.contiguous(), mesh, pls,
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def _store(x: torch.Tensor, mesh, spec: Spec) -> DTensor:
    """:func:`distribute` for a tensor kept past the call (a parameter):
    the block is a copy, so that it does not keep the whole tensor's
    storage alive."""
    d = distribute(x, mesh, spec)
    return DTensor.from_local(
        d.to_local().clone(memory_format=torch.contiguous_format), mesh,
        d.placements, run_check=False, shape=d.shape, stride=d.stride())


def partitioned(x) -> bool:
    """True iff ``x`` is a DTensor split over a mesh dimension of more
    than one rank (a replicated or one-rank placement is not)."""
    if not isinstance(x, DTensor):
        return False
    mesh = x.device_mesh
    return any(isinstance(p, Shard) and mesh.size(i) > 1
               for i, p in enumerate(x.placements))


def tree_is_sharded(tree) -> bool:
    """True if any leaf is partitioned across more than one rank (backends
    declare ``CAP_SHARDED`` when their dispatch handles that; see
    ``repro_torch.api.registry``)."""
    return any(partitioned(leaf) for leaf in tree_leaves(tree))


def shard_tree(tree, mesh, rules: Optional[ShardingRules] = None):
    """Place ``tree`` onto ``mesh`` per ``rules`` (default
    :func:`replica_rules`): each leaf its spec partitions becomes a
    ``DTensor`` of this rank's block, every other leaf stays whole.  THE
    placement recipe behind the pools' and states' ``shard`` and the
    serving engine's mesh path."""
    rules = rules if rules is not None else replica_rules(mesh)

    def place(path, leaf):
        sh = NamedSharding(mesh, param_pspec(path, tuple(leaf.shape), rules,
                                             mesh))
        return _store(leaf, mesh, sh.spec) if sh.partitions else leaf
    return tree_map_with_path(place, tree)


def shard_module(module: torch.nn.Module, mesh,
                 rules: ShardingRules) -> torch.nn.Module:
    """Store ``module``'s parameters on ``mesh`` per ``rules`` (in place):
    each parameter whose spec (:func:`param_pspec` of its dot-joined
    ``named_parameters`` path) partitions it becomes a ``DTensor``
    parameter holding this rank's block; the others stay whole.  The
    models read a parameter through ``models.layers.full``, which gathers
    a block at its use."""
    for path, prm in list(module.named_parameters()):
        sh = NamedSharding(mesh, param_pspec(path, tuple(prm.shape), rules,
                                             mesh))
        if not sh.partitions:
            continue
        owner, _, name = path.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        setattr(sub, name, torch.nn.Parameter(
            _store(prm.detach(), mesh, sh.spec),
            requires_grad=prm.requires_grad))
    return module


def local_block(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...],
                                          Tuple[int, ...]]:
    """``(block, offsets, global shape)``: this rank's block of ``x``, the
    global index of its first element along each dimension, and the
    whole tensor's shape (a plain tensor is its own block at 0)."""
    if not isinstance(x, DTensor):
        return x, (0,) * x.ndim, tuple(x.shape)
    shape = tuple(x.shape)
    sl = _block_slices(shape, x.device_mesh, x.placements)
    return x.to_local(), tuple(s.start for s in sl), shape


def result_layout(*operands) -> Optional[Tuple[Any, List]]:
    """``(mesh, placements)`` of a result whose dimensions follow its
    operands' partitioned dimensions: each ``(tensor, {operand dim:
    result dim})`` maps a split operand dimension onto the result.
    ``None`` when no operand is partitioned."""
    mesh, pls = None, None
    for x, dims in operands:
        if not partitioned(x):
            continue
        if mesh is None:
            mesh = x.device_mesh
            pls = [Replicate()] * mesh.ndim
        elif x.device_mesh != mesh:
            raise ValueError("operands are placed on different meshes")
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim in dims and mesh.size(i) > 1:
                pls[i] = Shard(dims[p.dim])
    return None if mesh is None else (mesh, pls)


def local(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``x`` (a plain tensor is its own block)."""
    return x.to_local() if isinstance(x, DTensor) else x


def block_like(like: torch.Tensor, block: torch.Tensor, placements=None):
    """``block`` as a block of ``like``'s layout (a ``DTensor`` on its mesh
    with its placements, or ``placements``); ``block`` itself when
    ``like`` is a plain tensor."""
    if not isinstance(like, DTensor):
        return block
    return DTensor.from_local(block, like.device_mesh,
                              placements or like.placements, run_check=False)


def from_block(block: torch.Tensor, layout) -> DTensor:
    """This rank's block of a result, as a ``DTensor`` of ``layout``."""
    mesh, pls = layout
    return DTensor.from_local(block, mesh, pls, run_check=False)


# Dtypes gloo's collectives refuse, carried as a wider type and cast back.
_WIRE_DTYPES = {torch.int16: torch.int32, torch.bool: torch.uint8,
                torch.bfloat16: torch.float32}


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    if t.dtype == torch.bfloat16:
        # a gather does no arithmetic: bf16 travels as its bytes, not
        # widened to float32 as a sum must be
        wire = t.contiguous().reshape(-1).view(torch.uint8)
        out = [torch.empty_like(wire)
               for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, wire, group=group)
        return [o.view(torch.bfloat16).reshape(t.shape) for o in out]
    wire = t.to(_WIRE_DTYPES.get(t.dtype, t.dtype)).contiguous()
    out = [torch.empty_like(wire)
           for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, wire, group=group)
    return [o.to(t.dtype) for o in out]


def assemble(block: torch.Tensor, mesh, pls) -> torch.Tensor:
    """The whole tensor from every rank's ``block`` under placements
    ``pls``: an all-gather over each mesh dimension that splits it,
    innermost first.  Every rank of the mesh must call it, in the same
    order as its other collectives."""
    out = block
    for i in reversed(range(len(pls))):
        p = pls[i]
        if isinstance(p, Shard) and mesh.size(i) > 1:
            out = torch.cat(_all_gather(out, mesh.get_group(i)), dim=p.dim)
    return out


def split_dims(x, dim: int) -> List[int]:
    """The mesh dimensions (of more than one rank) that split dimension
    ``dim`` of ``x`` (none for a plain tensor)."""
    if not isinstance(x, DTensor):
        return []
    return [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim
            and x.device_mesh.size(i) > 1]


def all_reduce_sum(t: torch.Tensor, mesh, mesh_dims) -> torch.Tensor:
    """``t`` summed over the ranks of each mesh dimension in
    ``mesh_dims`` (a new tensor; every rank of those groups calls it)."""
    t = t.clone()
    for i in mesh_dims:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group(i))
    return t


class _Gather(torch.autograd.Function):
    """:func:`assemble` with a backward: the whole-tensor gradient,
    averaged over the data-parallel ranks of the forward's
    :func:`data_parallel` block, cut to this rank's block."""

    @staticmethod
    def forward(ctx, block, mesh, pls, shape, dp):
        ctx.layout = (mesh, pls, shape, dp)
        return assemble(block, mesh, pls)

    @staticmethod
    def backward(ctx, grad):
        mesh, pls, shape, dp = ctx.layout
        if dp is not None:
            grad = all_reduce_mean(grad, dp.mesh, dp.dims)
        return (grad[_block_slices(shape, mesh, pls)].contiguous(), None,
                None, None, None)


def gather(x):
    """``x`` whole on every rank (a plain tensor passes through).  Under
    autograd the gather is differentiable (FSDP-style): the gradient of a
    block is its slice of the whole gradient, averaged over the
    data-parallel ranks (:func:`data_parallel`)."""
    if not isinstance(x, DTensor):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x.to_local(), x.device_mesh,
                             tuple(x.placements), tuple(x.shape),
                             _DP[0])
    return assemble(x.to_local(), x.device_mesh, x.placements)


def gather_tree(tree):
    """``tree`` with every DTensor leaf gathered whole (see
    :func:`gather`); a tree without one is returned as it is."""
    if not any(isinstance(x, DTensor) for x in tree_leaves(tree)):
        return tree
    return tree_map_with_path(lambda _, x: gather(x), tree)


def map_blocks(fn: Callable[[torch.Tensor], torch.Tensor], x):
    """``fn`` applied to this rank's block of ``x``, keeping its layout
    (``fn`` must keep the block's shape); a plain tensor is mapped
    whole."""
    if not isinstance(x, DTensor):
        return fn(x)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


# ----------------------------------------------------- data parallelism
#
# Under a data-parallel training step each rank computes on its rows of
# the global batch (the rows ``rules.batch`` gives its mesh coordinates;
# ranks that differ only on other axes share rows).  The step's loss is
# the mean of the ranks' losses, so every gradient is the mean of theirs:
# a whole parameter's gradient is all-reduced after the backward, a
# block's inside :func:`gather`'s backward, and the few statistics that
# are not means over rows (the MoE load-balance loss multiplies two batch
# means) are averaged in the forward through :func:`batch_mean`.


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """The mesh and its dimensions (of more than one rank) that split the
    batch."""

    mesh: Any
    dims: Tuple[int, ...]

    @property
    def ranks(self) -> int:
        n = 1
        for i in self.dims:
            n *= self.mesh.size(i)
        return n


# Process-wide, not a context variable: on the card the autograd engine
# runs the backward (and the recomputation of a checkpointed block, which
# must average as the forward did) on its own device threads.
_DP: List[Optional[DataParallel]] = [None]


def data_parallel_of(mesh, rules: ShardingRules) -> Optional[DataParallel]:
    """The data parallelism ``rules.batch`` declares on ``mesh``, or None
    when no mesh dimension of more than one rank splits the batch."""
    axes = rules.batch
    if mesh is None or axes is None:
        return None
    names = list(mesh.mesh_dim_names)
    dims = tuple(names.index(a)
                 for a in (axes if isinstance(axes, tuple) else (axes,))
                 if mesh.size(names.index(a)) > 1)
    return DataParallel(mesh, dims) if dims else None


@contextlib.contextmanager
def data_parallel(dp: Optional[DataParallel]):
    """Inside the block, gradients and :func:`batch_mean` average over
    ``dp``'s ranks (None: a no-op block)."""
    prev, _DP[0] = _DP[0], dp
    try:
        yield
    finally:
        _DP[0] = prev


def active_data_parallel() -> Optional[DataParallel]:
    return _DP[0]


def batch_rows(n_rows: int, dp: Optional[DataParallel]) -> slice:
    """This rank's rows of a global batch of ``n_rows`` under ``dp``: the
    block its coordinates on ``dp.dims`` give (the first outermost)."""
    if dp is None:
        return slice(0, n_rows)
    coord = dp.mesh.get_coordinate()
    k = 0
    for i in dp.dims:
        k = k * dp.mesh.size(i) + coord[i]
    if n_rows % dp.ranks:
        raise ValueError(f"a batch of {n_rows} rows does not split over "
                         f"{dp.ranks} data-parallel ranks")
    step = n_rows // dp.ranks
    return slice(k * step, (k + 1) * step)


def all_reduce_mean(t: torch.Tensor, mesh, mesh_dims) -> torch.Tensor:
    """The mean of ``t`` over the ranks of the mesh dimensions
    ``mesh_dims`` (a new tensor)."""
    n = 1
    for i in mesh_dims:
        n *= mesh.size(i)
    return all_reduce_sum(t, mesh, mesh_dims) / n


class _BatchMean(torch.autograd.Function):
    """The mean over data-parallel ranks; its adjoint is the same mean
    (every rank's loss holds the averaged value once)."""

    @staticmethod
    def forward(ctx, t, dp):
        ctx.dp = dp
        return all_reduce_mean(t, dp.mesh, dp.dims)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_mean(grad, ctx.dp.mesh, ctx.dp.dims), None


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """``t`` averaged over the ranks of the active :func:`data_parallel`
    block (differentiable); ``t`` itself outside one."""
    dp = _DP[0]
    if dp is None:
        return t
    return _BatchMean.apply(t, dp)


# --------------------------------------------------- tensor parallelism
#
# Megatron-style tensor parallelism on the rules' tensor axis ("model"):
# every rank of a model group holds the same rows, and a partitioned
# layer computes on this rank's block of its heads, hidden units, vocab
# or experts.  A replicated tensor enters such a layer through
# :func:`copy_to_model` (its gradient is the sum of the ranks' partial
# ones) and a partial result leaves it through :func:`reduce_from_model`
# (the sum of the ranks' blocks), so the activations between layers stay
# replicated over the group, or split on the sequence
# (:func:`slice_along` / :func:`gather_along`) where ``rules.seq`` says
# so.  Gloo has no reduce-scatter: an all-reduce and a slice stand in.


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The mesh dimension (of more than one rank) that the rules' tensor
    axis names, and which logical axes it carries."""

    mesh: Any
    dim: int
    heads: bool = False
    mlp: bool = False
    vocab: bool = False
    expert: bool = False
    kv_seq: bool = False
    seq: bool = False

    @property
    def size(self) -> int:
        return self.mesh.size(self.dim)

    @property
    def rank(self) -> int:
        """This rank's coordinate on the model dimension."""
        return self.mesh.get_coordinate()[self.dim]

    @property
    def group(self):
        return self.mesh.get_group(self.dim)

    def block(self, n: int, rank: Optional[int] = None) -> slice:
        """Rank ``rank``'s (default: this rank's) block of ``n`` items,
        ``n`` a multiple of :attr:`size`."""
        step = n // self.size
        r = self.rank if rank is None else rank
        return slice(r * step, (r + 1) * step)


# Process-wide, as :data:`_DP`: the backward and a checkpointed block's
# recomputation run on the autograd engine's device threads.
_TP: List[Optional[TensorParallel]] = [None]


def tensor_parallel_of(mesh, rules: ShardingRules) -> Optional[
        TensorParallel]:
    """The tensor parallelism ``rules.tensor`` declares on ``mesh`` (each
    logical axis the rules map to that mesh axis is carried by it), or
    None when the axis is off, absent or of one rank."""
    axis = rules.tensor
    names = getattr(mesh, "mesh_dim_names", None)
    if axis is None or not names or axis not in names:
        return None
    dim = list(names).index(axis)
    if mesh.size(dim) == 1:
        return None
    return TensorParallel(mesh, dim, **{
        name: getattr(rules, name) == axis
        for name in ("heads", "mlp", "vocab", "expert", "kv_seq", "seq")})


def tensor_parallel() -> Optional[TensorParallel]:
    """The active tensor parallelism (None outside :func:`use_sharding`
    or where it has none)."""
    return _TP[0]


def model_all_reduce(t: torch.Tensor, tp: TensorParallel,
                     op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced by ``op`` over the model group (a new tensor)."""
    w = t.to(dtype=_WIRE_DTYPES.get(t.dtype, t.dtype),
             memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(w, op=op, group=tp.group)
    return w.to(t.dtype)


def _model_all_gather(t: torch.Tensor, tp: TensorParallel,
                      dim: int) -> torch.Tensor:
    return torch.cat(_all_gather(t, tp.group), dim=dim)


def _narrow(t: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    sl = tp.block(t.shape[dim])
    return t.narrow(dim, sl.start, sl.stop - sl.start).contiguous()


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return model_all_reduce(grad, ctx.tp), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return model_all_reduce(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherAlong(torch.autograd.Function):
    """The ranks' blocks joined along ``dim``; the backward takes this
    rank's block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _model_all_gather(x, tp, dim)

    @staticmethod
    def backward(ctx, grad):
        return _narrow(grad, ctx.tp, ctx.dim), None, None


class _SliceAlong(torch.autograd.Function):
    """This rank's block along ``dim``; the backward joins the ranks'
    gradient blocks."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _narrow(x, tp, dim)

    @staticmethod
    def backward(ctx, grad):
        return _model_all_gather(grad, ctx.tp, ctx.dim), None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` (replicated over the model group) entering a partitioned
    computation: unchanged, with a gradient summed over the group."""
    tp = _TP[0]
    return x if tp is None else _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` (replicated after it)."""
    tp = _TP[0]
    return x if tp is None else _ReduceFromModel.apply(x, tp)


def gather_along(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``x`` joined along ``dim`` (sequence
    parallelism's all-gather, the vocab blocks of the logits)."""
    tp = _TP[0]
    return x if tp is None else _GatherAlong.apply(x, tp, dim % x.ndim)


def slice_along(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of the replicated ``x`` along ``dim``."""
    tp = _TP[0]
    return x if tp is None else _SliceAlong.apply(x, tp, dim % x.ndim)


def model_block(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of parameter ``x``, whole on its
    other dimensions.  A leaf stored with its ``dim`` split over the model
    dimension alone is all-gathered over its FSDP dimensions only and
    keeps its block (the gradient of the block: averaged over the
    data-parallel ranks and cut to the stored block, as :func:`gather`'s);
    any other leaf is read whole and its block cut from it
    (:func:`param_slice`)."""
    tp = _TP[0]
    if tp is None:
        return gather(x)
    if (isinstance(x, DTensor) and x.device_mesh == tp.mesh
            and split_dims(x, dim) == [tp.dim]):
        pls = tuple(Replicate() if i == tp.dim else p
                    for i, p in enumerate(x.placements))
        shape = list(x.shape)
        shape[dim] //= tp.size
        if torch.is_grad_enabled() and x.requires_grad:
            return _Gather.apply(x.to_local(), x.device_mesh, pls,
                                 tuple(shape), _DP[0])
        return assemble(x.to_local(), x.device_mesh, pls)
    sl = tp.block(x.shape[dim])
    return param_slice(x, dim, sl.start, sl.stop)


def param_slice(x: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    """``x[lo:hi]`` along ``dim``, read whole (:func:`gather`) and cut:
    the cut is rank-specific, so the whole leaf's gradient is summed over
    the model group (:func:`copy_to_model`)."""
    return copy_to_model(gather(x)).narrow(dim, lo, hi - lo)


# ------------------------------------------------------------ agreement

def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def broadcast_values(values: Sequence[float]) -> List[float]:
    """Rank 0's ``values`` on every rank, in one broadcast over the
    default group (a CPU tensor, which gloo carries; every rank passes as
    many)."""
    t = torch.tensor(list(values), dtype=torch.float64)
    dist.broadcast(t, src=0)
    return t.tolist()


def all_min(value: int) -> int:
    """The least of every rank's ``value`` (one all-reduce)."""
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def all_agree(flag: bool) -> bool:
    """True on every rank iff ``flag`` is true on every rank."""
    return all_min(1 if flag else 0) == 1
