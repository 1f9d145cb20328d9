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

``FaultConfig`` is ported as configuration only; fault injection comes
with a later slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

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
