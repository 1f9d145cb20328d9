"""Carry programmed arrays across from the reference package.

The two packages draw different random numbers from the same seed, so a
parity check programs ONE pool with the reference and hands its arrays
(``np.asarray(pool.r_stack)``, ``np.asarray(pool.include)``, a TA state,
a coalesced model's TA state and weights, a single chip's ``r_mem``, a
fault mask, a booleanizer's thresholds) to the port through these
functions.  Both then compute the same thing.  Nothing here imports the
reference: it takes numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.api.states import CrossbarState
from repro_torch.core.booleanize import Booleanizer
from repro_torch.core.coalesced import CoalescedConfig
from repro_torch.core.imbue import IMBUEConfig
from repro_torch.core.tm import TMConfig
from repro_torch.core.variations import VariationConfig
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


# Subtrees the reference stacks over superblocks on axis 0.
_STACKED = ("blocks.", "encoder.blocks.")


def _reference_leaf(path: str):
    """``(reference path, superblock index or None)`` of a port parameter
    path: ``blocks.<i>.<rest>`` is row ``i`` of the reference's stacked
    ``blocks.<rest>`` (``encoder.blocks`` alike); every other name is the
    reference's own."""
    for pre in _STACKED:
        if path.startswith(pre):
            i, rest = path[len(pre):].split(".", 1)
            return pre + rest, int(i)
    return path, None


def lm_params_from_numpy(tree, cfg: ModelConfig, device: DeviceLike = None):
    """A port ``Transformer`` of ``cfg`` on ``device`` holding the
    reference's parameter pytree ``tree`` (nested dicts / lists of numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``): ``blocks`` and
    ``encoder.blocks`` are unstacked on axis 0 into the per-superblock
    modules, every other leaf keeps its name.  Values are cast to each
    port parameter's dtype.  Raises on a missing or extra leaf, or a shape
    that does not match."""
    device = resolve_device(device)
    leaves = _flatten(tree)
    model = transformer.init_params(torch.Generator(device).manual_seed(0),
                                    cfg, device)
    used = set()
    with torch.no_grad():
        for path, prm in model.named_parameters():
            ref, row = _reference_leaf(path)
            if ref not in leaves:
                raise ValueError(f"the reference tree has no leaf {ref!r} "
                                 f"for the port's {path!r}")
            arr = np.asarray(leaves[ref])
            if row is not None:
                arr = arr[row]
            if tuple(arr.shape) != tuple(prm.shape):
                raise ValueError(f"{ref!r}: shape {arr.shape} does not "
                                 f"match the port's {tuple(prm.shape)}")
            prm.copy_(torch.from_numpy(
                np.ascontiguousarray(arr.astype(np.float32))))
            used.add(ref)
    extra = sorted(set(leaves) - used)
    if extra:
        raise ValueError(f"leaves of the reference tree the port has no "
                         f"parameter for: {extra}")
    return model


def pipeline_params_from_numpy(tree, device: DeviceLike = None
                               ) -> Dict[str, torch.Tensor]:
    """The pipeline demo's stacked stage weights (``{"w1": [S, d, 4d],
    "w2": [S, 4d, d]}``) as float32 tensors on ``device``."""
    device = resolve_device(device)
    if set(tree) != {"w1", "w2"}:
        raise ValueError(f"pipeline params need w1 and w2, got {sorted(tree)}")
    return {k: torch.from_numpy(np.asarray(v, dtype=np.float32).copy()).to(
        device) for k, v in tree.items()}
