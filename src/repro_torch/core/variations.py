"""ReRAM device and CMOS variation models (port of
``repro.core.variations``; paper §III-C, Fig. 7, Table III).

Same constants and the same distributions as the reference: D2D is a
lognormal HRS draw and a truncated-normal LRS draw, both clipped to the
published ranges; C2C is a uniform multiplicative excursion of ±5 % (HRS)
or ±1 % (LRS) per read; the CSA offset is a normal input-referred
voltage.  Randomness comes from an explicit ``torch.Generator`` where the
reference takes a jax key.  The two give different numbers from the same
seed, so the parity tests feed both packages numpy-drawn arrays and check
these samplers by distribution.

The persistent fault model is the reference's too: ``sample_fault_mask``
draws one uniform per cell into disjoint stuck-at-LRS / stuck-at-HRS
bands (int8 codes), and ``apply_fault_overlay`` pins stuck cells at the
nominal means and ages the healthy ones by the retention drift, in the
reference's op order, so the same resistances and mask give the same
float32 bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

# --- published device constants (Table I, §III-C) -------------------------
LRS_MEAN_OHM = 1.64e3
LRS_MIN_OHM = 1.55e3
LRS_MAX_OHM = 1.67e3
HRS_MEAN_OHM = 65.56e3
HRS_MIN_OHM = 31.0e3
HRS_MAX_OHM = 155.0e3
SERIES_FACTOR = 1.61            # 1T1R read-path multiplier (PMOS)
V_READ = 0.2                    # literal '0' read voltage (V)
V_LIT1 = 0.0                    # literal '1' -> no drive
I_LEAK_INCLUDE = 137e-9         # Table I leakage at literal '1'
I_LEAK_EXCLUDE = 9.9e-9

C2C_HRS_FRAC = 0.05             # +-5% per cycle
C2C_LRS_FRAC = 0.01             # +-1% per cycle
CSA_OFFSET_SIGMA_V = 0.3e-3     # input-referred CSA offset (V)

FAULT_NONE = 0
FAULT_STUCK_LRS = 1
FAULT_STUCK_HRS = 2


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Persistent device-fault knobs (stuck-at + retention drift)."""

    stuck_lrs_rate: float = 0.0
    stuck_hrs_rate: float = 0.0
    drift_rate: float = 0.0
    read_age: float = 0.0

    def __post_init__(self):
        if not (0.0 <= self.stuck_lrs_rate <= 1.0
                and 0.0 <= self.stuck_hrs_rate <= 1.0):
            raise ValueError("stuck-at rates must be in [0, 1], got "
                             f"{self.stuck_lrs_rate}/{self.stuck_hrs_rate}")
        if self.stuck_lrs_rate + self.stuck_hrs_rate > 1.0:
            raise ValueError("stuck_lrs_rate + stuck_hrs_rate must be <= 1")
        if self.drift_rate < 0.0 or self.read_age < 0.0:
            raise ValueError("drift_rate and read_age must be >= 0")

    @property
    def is_nominal(self) -> bool:
        """True when this config is the identity overlay."""
        return (self.stuck_lrs_rate == 0.0 and self.stuck_hrs_rate == 0.0
                and self.drift_rate * self.read_age == 0.0)


@dataclasses.dataclass(frozen=True)
class VariationConfig:
    """Knobs for the variation model."""

    d2d: bool = True
    c2c: bool = True
    csa_offset: bool = True
    c2c_hrs_frac: float = C2C_HRS_FRAC
    c2c_lrs_frac: float = C2C_LRS_FRAC
    csa_sigma_v: float = CSA_OFFSET_SIGMA_V
    fault: Optional[FaultConfig] = None

    @staticmethod
    def nominal() -> "VariationConfig":
        return VariationConfig(d2d=False, c2c=False, csa_offset=False)


# Lognormal sigma such that the published [min, max] range sits at ~3 sigma.
_HRS_LOG_SIGMA = (math.log(HRS_MAX_OHM / HRS_MEAN_OHM)
                  + math.log(HRS_MEAN_OHM / HRS_MIN_OHM)) / 6.0
_LRS_SIGMA = (LRS_MAX_OHM - LRS_MIN_OHM) / 6.0


def split_generator(generator: torch.Generator, n: int
                    ) -> List[torch.Generator]:
    """``n`` independent generators seeded from ``generator`` — the
    counterpart of ``jax.random.split``: the parent advances once, and
    each child stream is its own."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=generator.device).manual_seed(s)
            for s in seeds]


def _normal(generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def sample_hrs(generator: torch.Generator, shape, device) -> torch.Tensor:
    """D2D HRS draw (Ω), lognormal, clipped to the published range."""
    r = HRS_MEAN_OHM * torch.exp(_HRS_LOG_SIGMA
                                 * _normal(generator, shape, device))
    return r.clamp(HRS_MIN_OHM, HRS_MAX_OHM)


def sample_lrs(generator: torch.Generator, shape, device) -> torch.Tensor:
    """D2D LRS draw (Ω), truncated normal."""
    r = LRS_MEAN_OHM + _LRS_SIGMA * _normal(generator, shape, device)
    return r.clamp(LRS_MIN_OHM, LRS_MAX_OHM)


def sample_device_resistance(generator: Optional[torch.Generator],
                             include: torch.Tensor,
                             cfg: VariationConfig) -> torch.Tensor:
    """Per-cell programmed memristor resistance (Ω, float32): include ->
    LRS, exclude -> HRS, with a D2D draw when ``cfg.d2d``."""
    shape, dev = include.shape, include.device
    if cfg.d2d:
        g_h, g_l = split_generator(generator, 2)
        hrs = sample_hrs(g_h, shape, dev)
        lrs = sample_lrs(g_l, shape, dev)
    else:
        hrs = torch.full(shape, HRS_MEAN_OHM, dtype=torch.float32, device=dev)
        lrs = torch.full(shape, LRS_MEAN_OHM, dtype=torch.float32, device=dev)
    return torch.where(include, lrs, hrs)


def apply_c2c(generator: torch.Generator, r_mem: torch.Tensor,
              include: torch.Tensor, cfg: VariationConfig) -> torch.Tensor:
    """Per-read multiplicative C2C excursion ``r * (1 + frac * u)`` with
    ``u ~ U[-1, 1)``."""
    if not cfg.c2c:
        return r_mem
    frac = torch.where(include, cfg.c2c_lrs_frac,
                       cfg.c2c_hrs_frac).to(torch.float32)
    u = torch.rand(r_mem.shape, generator=generator, device=r_mem.device,
                   dtype=torch.float32) * 2.0 - 1.0
    return r_mem * (1.0 + frac * u)


def csa_offset(generator: torch.Generator, shape, cfg: VariationConfig,
               device=None) -> torch.Tensor:
    """Input-referred CSA offset voltage draw (V, float32)."""
    if not cfg.csa_offset:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return cfg.csa_sigma_v * _normal(generator, shape, device)


def sample_fault_mask(generator: torch.Generator, shape, fcfg: FaultConfig,
                      device=None) -> torch.Tensor:
    """A persistent per-cell fault mask (int8 codes): one uniform per cell,
    ``u < p_lrs`` stuck at LRS, ``p_lrs <= u < p_lrs + p_hrs`` stuck at
    HRS, the rest healthy, so the two stuck populations never overlap."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    p_lrs = fcfg.stuck_lrs_rate
    p_hrs = fcfg.stuck_hrs_rate
    mask = torch.where(u < p_lrs, FAULT_STUCK_LRS,
                       torch.where(u < p_lrs + p_hrs, FAULT_STUCK_HRS,
                                   FAULT_NONE))
    return mask.to(torch.int8)


def apply_fault_overlay(r_mem: torch.Tensor, mask: torch.Tensor,
                        fcfg: FaultConfig) -> torch.Tensor:
    """Bake a fault mask into programmed resistances: stuck cells read at
    the nominal LRS/HRS mean whatever was programmed; healthy cells drift,
    their resistance scaled by ``exp(drift_rate * read_age)`` (computed in
    double on the host, rounded to float32 once).  Returns ``r_mem``
    itself when ``fcfg`` is nominal."""
    if fcfg.is_nominal:
        return r_mem
    drift = np.float32(math.exp(fcfg.drift_rate * fcfg.read_age))
    drifted = r_mem * torch.tensor(drift, device=r_mem.device)
    return torch.where(mask == FAULT_STUCK_LRS, LRS_MEAN_OHM,
                       torch.where(mask == FAULT_STUCK_HRS, HRS_MEAN_OHM,
                                   drifted)).to(torch.float32)


def merge_fault_masks(mask: torch.Tensor,
                      old: Optional[torch.Tensor]) -> torch.Tensor:
    """Re-injection compounds: the new codes win, old faults stay."""
    return mask if old is None else torch.where(mask != 0, mask, old)


def inject_stack_faults(generator: torch.Generator, r_stack: torch.Tensor,
                        fcfg: FaultConfig, replicas=None,
                        old_mask: Optional[torch.Tensor] = None):
    """Faults baked into the chips ``replicas`` (all when None) of an
    ``[R, C, L]`` stack: ``(injured r_stack, merged int8 mask)``.  Each
    chip draws its mask from its own split of ``generator``, so chip
    ``i``'s defects do not depend on which chips are targeted; the other
    chips keep their resistances bit for bit."""
    n = r_stack.shape[0]
    gens = split_generator(generator, n)
    mask = torch.stack([sample_fault_mask(g, r_stack.shape[1:], fcfg,
                                          r_stack.device) for g in gens])
    injured = apply_fault_overlay(r_stack, mask, fcfg)
    if replicas is not None:
        sel = torch.zeros(n, dtype=torch.bool, device=r_stack.device)
        sel[list(replicas)] = True
        mask = torch.where(sel[:, None, None], mask, 0).to(torch.int8)
        injured = torch.where(sel[:, None, None], injured, r_stack)
    return injured, merge_fault_masks(mask, old_mask)
