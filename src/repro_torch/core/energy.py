"""IMBUE energy/latency model (paper §IV, Tables II & IV, Figs. 6 & 9);
a copy of the numpy-only ``repro.core.energy``.

The paper evaluates energy with "a Python script using the power
consumption values seen in Table II and the timing presented in Fig. 6".
This module is that script, reconstructed:

* **Physical model** — per-event energies = Table II powers x the 35 ns
  read pulse, summed over the events a datapoint triggers (includes driven
  by literal '0' dominate; exclude leakage is the 0.377 uW term the paper
  rounds to ~0), plus a per-column CSA sense energy.
* **Paper-calibrated model** — solving Table IV's five rows for the linear
  model ``E = a * includes + b * CSAs`` gives ``a ~ 514 fJ`` (= the include
  x literal-'0' read energy with every include assumed active) and ``b ~
  43 fJ`` per CSA sense; this reproduces the published energies to ~1%
  (validated in benchmarks/table_iv.py).  ``calibrate_to_paper()`` performs
  that least-squares fit at runtime rather than hard-coding the result.
* **CMOS TM baseline [9]** — all five Table IV rows satisfy
  ``E = 15.95 fJ x TA cells`` exactly; exposed as ``cmos_tm_energy``.
* **TopJ^-1** (Fig. 9) — trillion TA operations per joule:
  ``ta_cells / E_datapoint / 1e12``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import numpy as np

# --- Table II: per-cell power (W) -----------------------------------------
P_PROGRAM_EXCLUDE = 54.54e-6
P_PROGRAM_INCLUDE = 215.1e-6
P_INCLUDE_LIT0 = 14.37e-6
P_EXCLUDE_LIT0 = 377.2e-9
P_OTHERWISE = 0.0

# --- Fig. 5/6 timing (s) ---------------------------------------------------
T_READ = 35e-9          # Col_line read pulse
T_SENSE = 20e-9         # SE high (overlaps read)
T_DISCHARGE = 5e-9      # Dis spark
T_CYCLE = 60e-9         # one full CSA sense cycle (read + discharge + idle)
T_PROGRAM = 35e-9       # programming pulse (one-time)

# --- derived per-event energies (J) ----------------------------------------
E_INCLUDE_LIT0 = P_INCLUDE_LIT0 * T_READ          # ~503 fJ
E_EXCLUDE_LIT0 = P_EXCLUDE_LIT0 * T_READ          # ~13.2 fJ
E_PROGRAM_INCLUDE = P_PROGRAM_INCLUDE * T_PROGRAM
E_PROGRAM_EXCLUDE = P_PROGRAM_EXCLUDE * T_PROGRAM

# CSA sense energy: 65 nm latch at 1.2 V; the paper-calibrated fit (below)
# recovers ~43 fJ, consistent with a ~30 fF sensing node at 1.2 V.
E_CSA_SENSE_DEFAULT = 43e-15

# CMOS TM digital baseline [9]: energy per TA cell per datapoint, recovered
# exactly from every Table IV row (50.01 nJ / 3,136,000 cells = 15.95 fJ).
E_CMOS_TM_PER_CELL = 15.95e-15


@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    include_on_j: float
    exclude_leak_j: float
    csa_j: float

    @property
    def total_j(self) -> float:
        return self.include_on_j + self.exclude_leak_j + self.csa_j

    @property
    def total_nj(self) -> float:
        return self.total_j * 1e9


def imbue_energy_per_datapoint(
    includes: int,
    ta_cells: int,
    csas: int,
    *,
    p_lit0_include: float = 1.0,
    p_lit0_exclude: float = 0.0,
    e_csa: float = E_CSA_SENSE_DEFAULT,
    e_include: float = E_INCLUDE_LIT0,
    e_exclude: float = E_EXCLUDE_LIT0,
) -> EnergyBreakdown:
    """Physical event model.

    ``p_lit0_*`` are the probabilities that a cell of that action sees
    literal '0'.  The paper's script takes the conservative corner
    (every include conducts each datapoint; exclude leak ~ 0), which the
    defaults reproduce; pass dataset literal statistics for the expected-
    case estimate.
    """
    excludes = ta_cells - includes
    return EnergyBreakdown(
        include_on_j=includes * p_lit0_include * e_include,
        exclude_leak_j=excludes * p_lit0_exclude * e_exclude,
        csa_j=csas * e_csa,
    )


def cmos_tm_energy(ta_cells: int) -> float:
    """Digital CMOS TM baseline [9] energy/datapoint (J)."""
    return ta_cells * E_CMOS_TM_PER_CELL


def programming_energy(includes: int, ta_cells: int) -> float:
    """One-time crossbar programming energy (J), Fig. 5 phases 1/3."""
    excludes = ta_cells - includes
    return includes * E_PROGRAM_INCLUDE + excludes * E_PROGRAM_EXCLUDE


def top_j_inv(ta_cells: int, energy_j: float) -> float:
    """Trillion TA operations per joule (Fig. 9 metric)."""
    return ta_cells / energy_j / 1e12


def inference_latency_s(n_columns: int, *, parallel_columns: int = 0) -> float:
    """Per-datapoint latency from the Fig. 6 cycle.

    ``parallel_columns == 0`` -> fully parallel sensing (one cycle);
    otherwise columns are multiplexed ``parallel_columns`` at a time via
    the column line selector.
    """
    if parallel_columns <= 0:
        return T_CYCLE
    import math
    return math.ceil(n_columns / parallel_columns) * T_CYCLE


def calibrate_to_paper(
    rows: Iterable,           # PaperModelStats iterable
    *,
    exclude_names: Tuple[str, ...] = ("noisy-xor",),
) -> Dict[str, float]:
    """Least-squares (a, b) of ``E = a*includes + b*CSAs`` on Table IV.

    noisy-xor is excluded from the fit by default: its published energy has
    a single significant digit (0.02 nJ).  Returns the fit and per-row
    relative errors.
    """
    fit_rows = [r for r in rows if r.name not in exclude_names]
    A = np.array([[r.includes, r.csas] for r in fit_rows], dtype=np.float64)
    e = np.array([r.imbue_nj * 1e-9 for r in fit_rows], dtype=np.float64)
    (a, b), *_ = np.linalg.lstsq(A, e, rcond=None)
    out = {"a_per_include_j": float(a), "b_per_csa_j": float(b)}
    for r in fit_rows:
        pred = a * r.includes + b * r.csas
        out[f"rel_err_{r.name}"] = float(abs(pred - r.imbue_nj * 1e-9)
                                         / (r.imbue_nj * 1e-9))
    return out
