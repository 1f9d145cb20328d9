"""Carry programmed arrays across from the reference package.

The two packages draw different random numbers from the same seed, so a
parity check programs ONE pool with the reference and hands its arrays
(``np.asarray(pool.r_stack)``, ``np.asarray(pool.include)``, a TA state,
a coalesced model's TA state and weights) to the port through these
functions.  Both then compute the same thing.
Nothing here imports the reference: it takes numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.coalesced import CoalescedConfig
from repro_torch.core.imbue import IMBUEConfig
from repro_torch.core.tm import TMConfig
from repro_torch.core.variations import VariationConfig
from repro_torch.serve.replica import CoalescedPool, ReplicaPool


def pool_from_numpy(r_stack: np.ndarray, include: np.ndarray,
                    icfg: IMBUEConfig = IMBUEConfig(),
                    vcfg: VariationConfig = VariationConfig(),
                    version: int = 0,
                    device: DeviceLike = None) -> ReplicaPool:
    """A port ``ReplicaPool`` holding ``r_stack`` ``[R, C, L]`` (float32
    Ω, bit for bit) and ``include`` ``[C, L]`` on ``device``."""
    device = resolve_device(device)
    r = np.asarray(r_stack, dtype=np.float32)
    inc = np.asarray(include, dtype=bool)
    if r.ndim != 3 or r.shape[1:] != inc.shape:
        raise ValueError(f"r_stack {r.shape} does not match include "
                         f"{inc.shape}")
    return ReplicaPool(r_stack=torch.from_numpy(r.copy()).to(device),
                       include=torch.from_numpy(inc.copy()).to(device),
                       icfg=icfg, vcfg=vcfg, version=int(version))


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
