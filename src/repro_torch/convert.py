"""Carry programmed arrays across from the reference package.

The two packages draw different random numbers from the same seed, so a
parity check programs ONE pool with the reference and hands its arrays
(``np.asarray(pool.r_stack)``, ``np.asarray(pool.include)``, a TA state,
a coalesced model's TA state and weights, a single chip's ``r_mem``, a
fault mask, a booleanizer's thresholds, an LM's parameters and optimizer
state) to the port through these functions.  Both then compute the same
thing.  Nothing here imports the reference: it takes numpy arrays.  The
LM trees go both ways: ``lm_tree_to_numpy`` gives a port model's
parameters, gradients or optimizer state in the reference's stacked
layout (the LM trainer's checkpoint format).
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.api.states import CrossbarState
from repro_torch.core.booleanize import Booleanizer
from repro_torch.core.coalesced import CoalescedConfig
from repro_torch.core.imbue import IMBUEConfig
from repro_torch.core.tm import TMConfig
from repro_torch.core.variations import VariationConfig
from repro_torch.distributed.sharding import _block_slices, gather
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serve.replica import CoalescedPool, ReplicaPool


def _planes(r: np.ndarray, include: np.ndarray, ndim: int, device):
    """``(r, include)`` as float32 / bool tensors on ``device``, checked."""
    r = np.asarray(r, dtype=np.float32)
    inc = np.asarray(include, dtype=bool)
    if r.ndim != ndim or r.shape[-2:] != inc.shape:
        raise ValueError(f"resistances {r.shape} do not match include "
                         f"{inc.shape}")
    return (torch.from_numpy(r.copy()).to(device),
            torch.from_numpy(inc.copy()).to(device))


def pool_from_numpy(r_stack: np.ndarray, include: np.ndarray,
                    icfg: IMBUEConfig = IMBUEConfig(),
                    vcfg: VariationConfig = VariationConfig(),
                    version: int = 0,
                    fault_mask: Optional[np.ndarray] = None,
                    device: DeviceLike = None) -> ReplicaPool:
    """A port ``ReplicaPool`` holding ``r_stack`` ``[R, C, L]`` (float32
    Ω, bit for bit), ``include`` ``[C, L]`` and, if given, the int8
    ``fault_mask`` ``[R, C, L]`` of an injured pool, on ``device``."""
    device = resolve_device(device)
    r, inc = _planes(r_stack, include, 3, device)
    fm = None
    if fault_mask is not None:
        fm_np = np.asarray(fault_mask, dtype=np.int8)
        if fm_np.shape != tuple(r.shape):
            raise ValueError(f"fault_mask {fm_np.shape} != r_stack "
                             f"{tuple(r.shape)}")
        fm = torch.from_numpy(fm_np.copy()).to(device)
    return ReplicaPool(r_stack=r, include=inc, icfg=icfg, vcfg=vcfg,
                       version=int(version), fault_mask=fm)


def crossbar_state_from_numpy(r_mem: np.ndarray, include: np.ndarray,
                              tm_cfg: TMConfig,
                              icfg: IMBUEConfig = IMBUEConfig(),
                              vcfg: VariationConfig = VariationConfig(),
                              device: DeviceLike = None) -> CrossbarState:
    """A port ``CrossbarState`` holding one chip's ``r_mem`` ``[C, L]``
    (float32 Ω, bit for bit) and ``include`` ``[C, L]`` on ``device``."""
    r, inc = _planes(r_mem, include, 2, resolve_device(device))
    return CrossbarState(r_mem=r, include=inc, tm_cfg=tm_cfg, icfg=icfg,
                         vcfg=vcfg)


def ta_from_numpy(ta_state: np.ndarray, cfg: TMConfig,
                  device: DeviceLike = None) -> torch.Tensor:
    """A TA state ``[C, L]`` as a ``cfg.state_dtype`` tensor on
    ``device``."""
    device = resolve_device(device)
    ta = np.asarray(ta_state)
    if ta.shape != (cfg.n_clauses, cfg.n_literals):
        raise ValueError(f"TA state {ta.shape} != "
                         f"{(cfg.n_clauses, cfg.n_literals)}")
    return torch.from_numpy(ta.astype(np.int64)).to(device=device,
                                                    dtype=cfg.state_dtype)


def coalesced_pool_from_numpy(ta_state: np.ndarray, weights: np.ndarray,
                              cfg: CoalescedConfig, version: int = 0,
                              device: DeviceLike = None) -> CoalescedPool:
    """A port ``CoalescedPool`` holding ``ta_state`` ``[C, L]`` (as
    ``cfg.state_dtype``) and ``weights`` ``[C, M]`` (as int32), bit for
    bit, on ``device``."""
    device = resolve_device(device)
    ta = np.asarray(ta_state)
    w = np.asarray(weights)
    if ta.shape != (cfg.n_clauses, cfg.n_literals):
        raise ValueError(f"TA state {ta.shape} != "
                         f"{(cfg.n_clauses, cfg.n_literals)}")
    if w.shape != (cfg.n_clauses, cfg.n_classes):
        raise ValueError(f"weights {w.shape} != "
                         f"{(cfg.n_clauses, cfg.n_classes)}")
    return CoalescedPool(
        ta_state=torch.from_numpy(ta.astype(np.int64)).to(
            device=device, dtype=cfg.state_dtype),
        weights=torch.from_numpy(w.astype(np.int32)).to(device),
        cfg=cfg, version=int(version))


def booleanizer_from_numpy(thresholds: np.ndarray,
                           device: DeviceLike = None) -> Booleanizer:
    """A port ``Booleanizer`` holding ``thresholds`` ``[F, K]`` (float32,
    bit for bit: ``np.asarray(reference.thresholds)``) on ``device``."""
    thr = np.asarray(thresholds, dtype=np.float32)
    if thr.ndim != 2:
        raise ValueError(f"thresholds must be [F, K], got {thr.shape}")
    return Booleanizer(thresholds=torch.from_numpy(thr.copy()).to(
        resolve_device(device)))


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{dot-joined path: array}`` of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


# A port path's superblock index: ``blocks.<i>.`` (or
# ``encoder.blocks.<i>.``), at the start or after a prefix such as an
# optimizer state's ``m.``.  The reference stacks those subtrees over
# superblocks on axis 0.
_STACKED = re.compile(r"(^|\.)((?:encoder\.)?blocks)\.(\d+)\.")


def _reference_leaf(path: str):
    """``(reference path, superblock index or None)`` of a port path:
    ``blocks.<i>.<rest>`` is row ``i`` of the reference's stacked
    ``blocks.<rest>`` (``encoder.blocks`` alike, under any prefix); every
    other name is the reference's own."""
    m = _STACKED.search(path)
    if m is None:
        return path, None
    return path[:m.start(3)] + path[m.end(3) + 1:], int(m.group(3))


def _leaf_array(t) -> np.ndarray:
    """A tensor (a block is gathered whole: a collective) or array as
    numpy; bfloat16 widens to float32, which numpy holds exactly."""
    if isinstance(t, torch.Tensor):
        t = gather(t.detach())
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def _nest(flat: Dict[str, np.ndarray]):
    """Dot-joined paths -> nested dicts; ``prologue`` (and a prefixed
    one) is a list, as in the reference's tree."""
    root: dict = {}
    for path, v in flat.items():
        node = root
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v

    def lists(node, key=None):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v, k) for k, v in node.items()}
        if key == "prologue":
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(root)


def lm_tree_to_numpy(tree):
    """A model's parameters, gradients or optimizer state in the
    reference's stacked layout, as numpy: ``tree`` is a module, a
    ``{name: tensor}`` mapping over its parameter names, or a tree of such
    mappings (``{"m": {...}, "v": {...}}``, Adafactor's ``v`` leaves
    ``{"row", "col"}`` / ``{"full"}``).  Superblock rows are stacked on
    axis 0; the result's leaves flatten to the reference's paths.  Blocks
    (``DTensor``) are gathered: in a process group every rank calls it."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    rows: Dict[str, dict] = {}
    for path, leaf in _flatten(tree).items():
        ref, row = _reference_leaf(path)
        rows.setdefault(ref, {})[row] = _leaf_array(leaf)
    flat = {}
    for ref, by_row in rows.items():
        if None in by_row:
            flat[ref] = by_row[None]
            continue
        if sorted(by_row) != list(range(len(by_row))):
            raise ValueError(f"{ref}: superblock rows {sorted(by_row)}")
        flat[ref] = np.stack([by_row[i] for i in range(len(by_row))])
    return _nest(flat)


def _row(leaves, ref: str, row):
    if ref not in leaves:
        raise ValueError(f"the reference tree has no leaf {ref!r}")
    arr = leaves[ref]
    return arr if row is None else arr[row]


def load_lm_params(model, tree) -> None:
    """Copy the reference-layout parameter tree ``tree`` (numpy arrays or
    tensors, e.g. a restored checkpoint's ``params``) into ``model`` in
    place, cast to each parameter's dtype; a parameter stored as blocks
    takes its block.  Raises on a missing or extra leaf, or a shape that
    does not match."""
    leaves = _flatten(tree)
    used = set()
    with torch.no_grad():
        for path, prm in model.named_parameters():
            ref, row = _reference_leaf(path)
            arr = _row(leaves, ref, row)
            if tuple(arr.shape) != tuple(prm.shape):
                raise ValueError(f"{ref!r}: shape {tuple(arr.shape)} does "
                                 f"not match the port's {tuple(prm.shape)}")
            src = arr if isinstance(arr, torch.Tensor) else \
                torch.from_numpy(np.array(arr, dtype=np.float32))
            dst = prm
            if isinstance(prm, DTensor):
                src = src[_block_slices(tuple(prm.shape), prm.device_mesh,
                                        prm.placements)]
                dst = prm.to_local()
            dst.copy_(src.to(device=dst.device, dtype=dst.dtype))
            used.add(ref)
    extra = sorted(set(leaves) - used)
    if extra:
        raise ValueError(f"leaves of the reference tree the port has no "
                         f"parameter for: {extra}")


def lm_params_from_numpy(tree, cfg: ModelConfig, device: DeviceLike = None):
    """A port ``Transformer`` of ``cfg`` on ``device`` holding the
    reference's parameter pytree ``tree`` (nested dicts / lists of numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``): ``blocks`` and
    ``encoder.blocks`` are unstacked on axis 0 into the per-superblock
    modules, every other leaf keeps its name.  Values are cast to each
    port parameter's dtype.  Raises on a missing or extra leaf, or a shape
    that does not match."""
    device = resolve_device(device)
    model = transformer.init_params(torch.Generator(device).manual_seed(0),
                                    cfg, device)
    load_lm_params(model, tree)
    return model


def lm_opt_state_from_numpy(tree, model, device: DeviceLike = None):
    """The port's optimizer state tree (``{"m": {name: tensor}, "v":
    {name: tensor or {"row", "col"} / {"full"}}}``, float32, whole, on
    ``device``) of the reference's ``{"m", "v"}`` state ``tree`` (numpy
    arrays, or tensors of a restored checkpoint) for ``model``'s
    parameters; load it with ``opt.load_state_tree``, which
    casts to the state dtype and cuts blocks."""
    device = resolve_device(device)
    leaves = _flatten(tree)

    def get(ref, row):
        leaf = _row(leaves, ref, row)
        if isinstance(leaf, torch.Tensor):
            return leaf.to(device=device, dtype=torch.float32)
        return torch.from_numpy(np.array(leaf, dtype=np.float32)).to(device)

    out = {"m": {}, "v": {}}
    for path, _ in model.named_parameters():
        ref, row = _reference_leaf(path)
        out["m"][path] = get(f"m.{ref}", row)
        if f"v.{ref}" in leaves:
            out["v"][path] = get(f"v.{ref}", row)
        else:
            out["v"][path] = {k: get(f"v.{ref}.{k}", row)
                              for k in ("row", "col", "full")
                              if f"v.{ref}.{k}" in leaves}
    return out


def pipeline_params_from_numpy(tree, device: DeviceLike = None
                               ) -> Dict[str, torch.Tensor]:
    """The pipeline demo's stacked stage weights (``{"w1": [S, d, 4d],
    "w2": [S, 4d, d]}``) as float32 tensors on ``device``."""
    device = resolve_device(device)
    if set(tree) != {"w1", "w2"}:
        raise ValueError(f"pipeline params need w1 and w2, got {sorted(tree)}")
    return {k: torch.from_numpy(np.asarray(v, dtype=np.float32).copy()).to(
        device) for k, v in tree.items()}
