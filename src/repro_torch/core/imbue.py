"""IMBUE: the analog Boolean-to-Current crossbar in PyTorch (port of
``repro.core.imbue``; paper §II).

Pipeline: program TA actions into memristor resistances (include -> LRS,
exclude -> HRS, D2D at program time); drive literals as read voltages
(literal '0' -> ``v_read``, '1' -> 0 V, so only violations conduct); sum
each 32-cell column's current (KCL); compare each column voltage with
``v_ref`` (CSA, plus an optional per-column offset); AND the partial
clauses.  This is the eager full-noise model — ``analog-torch`` — and
the float32 reference the kernel path is held to.

Noise follows the reference's key discipline with generators: one read
splits its generator into a C2C stream and a CSA stream
(``analog_clause_outputs_raw``), exactly as ``repro.core.imbue`` splits
its key.  The replica axis ``R`` is written out as a leading tensor
dimension where the reference uses ``vmap``.

The Monte-Carlo studies (``monte_carlo_accuracy``, ``clause_error_rate``)
stay eager, as in the reference: one programmed chip and one read per
draw, each draw's two generators split off the caller's, and the draw
axis a loop, so one read's column currents are live at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import variations as var
from repro_torch.core.mapping import CrossbarMapping, pad_to_columns
from repro_torch.core.tm import (TMConfig, class_sums, clause_outputs,
                                 include_mask, literals)

# Nominal single-cell read currents (Table I).
I_INCLUDE_ON = var.V_READ / (var.SERIES_FACTOR * var.LRS_MEAN_OHM)   # ~75.7 uA
I_EXCLUDE_ON = var.V_READ / (var.SERIES_FACTOR * var.HRS_MEAN_OHM)   # ~1.89 uA


@dataclasses.dataclass(frozen=True)
class IMBUEConfig:
    """Electrical configuration of the crossbar (paper §II/III)."""

    width: int = 32                 # W: TA cells per partial-clause column
    r_divider: float = 100.0        # column divider resistance (Ω)
    v_read: float = var.V_READ      # literal '0' drive voltage (V)
    series_factor: float = var.SERIES_FACTOR
    v_ref: Optional[float] = None   # None -> computed from width

    def reference_voltage(self) -> float:
        """Midway between the all-exclude leak band and one include
        violation (the sensing margin of §II-B)."""
        if self.v_ref is not None:
            return self.v_ref
        i_leak_band = self.width * I_EXCLUDE_ON
        return self.r_divider * 0.5 * (i_leak_band + I_INCLUDE_ON)

    def sensing_margin(self) -> float:
        """Half-width of the [all-exclude, one-include] current band (V)."""
        return self.r_divider * 0.5 * (I_INCLUDE_ON - self.width * I_EXCLUDE_ON)


@dataclasses.dataclass
class ProgrammedCrossbar:
    """A crossbar with TA actions programmed into memristor states."""

    r_mem: torch.Tensor        # [C, L] programmed memristor resistance (Ω)
    include: torch.Tensor      # [C, L] bool TA actions
    mapping: CrossbarMapping
    cfg: IMBUEConfig


def program_crossbar(include: torch.Tensor,
                     generator: Optional[torch.Generator],
                     vcfg: var.VariationConfig = var.VariationConfig(),
                     cfg: IMBUEConfig = IMBUEConfig()) -> ProgrammedCrossbar:
    """One-time programming: D2D drawn at SET/RESET time."""
    c, l = include.shape
    r_mem = var.sample_device_resistance(generator, include, vcfg)
    return ProgrammedCrossbar(
        r_mem=r_mem, include=include,
        mapping=CrossbarMapping(n_clauses=c, n_literals=l, width=cfg.width),
        cfg=cfg)


def conductances(r_mem: torch.Tensor, include: torch.Tensor, cfg: IMBUEConfig,
                 generator: Optional[torch.Generator] = None,
                 vcfg: var.VariationConfig = var.VariationConfig()):
    """Per-cell on-path conductance and leak current for one read cycle,
    ``[..., C, L]`` float32 each (same op order as the reference)."""
    r = r_mem
    if generator is not None:
        r = var.apply_c2c(generator, r, include, vcfg)
    g_on = 1.0 / (cfg.series_factor * r)
    i_leak_nom = torch.where(include, var.I_LEAK_INCLUDE,
                             var.I_LEAK_EXCLUDE).to(torch.float32)
    r_nom = torch.where(include, var.LRS_MEAN_OHM,
                        var.HRS_MEAN_OHM).to(torch.float32)
    i_leak = i_leak_nom * (r_nom / r)
    return g_on, i_leak


def cell_conductances(xbar: ProgrammedCrossbar,
                      generator: Optional[torch.Generator],
                      vcfg: var.VariationConfig):
    """Per-cell on-path conductance and leak current for this read."""
    return conductances(xbar.r_mem, xbar.include, xbar.cfg, generator, vcfg)


def column_currents_raw(g_on: torch.Tensor, i_leak: torch.Tensor,
                        lits: torch.Tensor, mapping: CrossbarMapping,
                        cfg: IMBUEConfig) -> torch.Tensor:
    """KCL column currents (A): ``[..., C, L]`` planes and ``[B, L]``
    literals -> ``[..., B, C, columns_per_clause]``."""
    lit0 = pad_to_columns((1 - lits.to(torch.float32)) * cfg.v_read, mapping)
    lit1 = pad_to_columns(lits.to(torch.float32), mapping)
    g_f = pad_to_columns(g_on, mapping)                    # [..., C, K, W]
    leak_f = pad_to_columns(i_leak, mapping)
    on = torch.einsum("bkw,...ckw->...bck", lit0, g_f)
    leak = torch.einsum("bkw,...ckw->...bck", lit1, leak_f)
    return on + leak


def column_currents(xbar: ProgrammedCrossbar, lits: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    vcfg: var.VariationConfig = var.VariationConfig()
                    ) -> torch.Tensor:
    """KCL column currents ``[B, C, columns_per_clause]`` (amps)."""
    g_on, i_leak = cell_conductances(xbar, generator, vcfg)
    return column_currents_raw(g_on, i_leak, lits, xbar.mapping, xbar.cfg)


def csa_sense(i_col: torch.Tensor, cfg: IMBUEConfig,
              generator: Optional[torch.Generator] = None,
              vcfg: var.VariationConfig = var.VariationConfig()
              ) -> torch.Tensor:
    """CSA compare: partial clause = 1 iff ``V_col < V_ref + offset``."""
    v_col = i_col * cfg.r_divider
    v_ref = cfg.reference_voltage()
    if generator is None:
        return (v_col < v_ref).to(torch.uint8)
    off = var.csa_offset(generator, i_col.shape, vcfg, i_col.device)
    return (v_col < v_ref + off).to(torch.uint8)


def analog_clause_outputs_raw(
    r_mem: torch.Tensor,              # [..., C, L] programmed resistance (Ω)
    include: torch.Tensor,            # [C, L] bool
    lits: torch.Tensor,               # [B, L]
    mapping: CrossbarMapping,
    cfg: IMBUEConfig,
    generator: Optional[torch.Generator] = None,
    vcfg: var.VariationConfig = var.VariationConfig(),
) -> torch.Tensor:
    """Clause outputs ``[..., B, C]`` uint8 from raw device arrays: one
    read, its generator split into a C2C and a CSA stream."""
    if generator is not None:
        g_c2c, g_csa = var.split_generator(generator, 2)
    else:
        g_c2c = g_csa = None
    g_on, i_leak = conductances(r_mem, include, cfg, g_c2c, vcfg)
    i_col = column_currents_raw(g_on, i_leak, lits, mapping, cfg)
    partial = csa_sense(i_col, cfg, g_csa, vcfg)             # [..., B, C, K]
    return partial.amin(dim=-1)                               # AND over cols


def analog_clause_outputs(xbar: ProgrammedCrossbar, lits: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          vcfg: var.VariationConfig = var.VariationConfig()
                          ) -> torch.Tensor:
    """Full clause outputs ``[B, C]`` via the partial-clause AND."""
    return analog_clause_outputs_raw(xbar.r_mem, xbar.include, lits,
                                     xbar.mapping, xbar.cfg, generator, vcfg)


def analog_forward(xbar: ProgrammedCrossbar, x: torch.Tensor,
                   tm_cfg: TMConfig,
                   generator: Optional[torch.Generator] = None,
                   vcfg: var.VariationConfig = var.VariationConfig()
                   ) -> torch.Tensor:
    """Class sums ``[B, M]`` from the analog crossbar; empty clauses are
    masked by the digital tail."""
    cls = analog_clause_outputs(xbar, literals(x), generator, vcfg)
    cls = cls * xbar.include.any(dim=-1)[None, :].to(cls.dtype)
    return class_sums(cls, tm_cfg)


def analog_predict(xbar: ProgrammedCrossbar, x: torch.Tensor,
                   tm_cfg: TMConfig,
                   generator: Optional[torch.Generator] = None,
                   vcfg: var.VariationConfig = var.VariationConfig()
                   ) -> torch.Tensor:
    return torch.argmax(analog_forward(xbar, x, tm_cfg, generator, vcfg),
                        dim=-1)


def program_replica_stack(include: torch.Tensor,
                          generator: Optional[torch.Generator],
                          n_replicas: int,
                          vcfg: var.VariationConfig = var.VariationConfig()
                          ) -> torch.Tensor:
    """Program ``R`` independent chips: resistances ``[R, C, L]`` float32,
    one D2D draw per chip."""
    stack = include.expand(n_replicas, *include.shape)
    return var.sample_device_resistance(generator, stack, vcfg)


def stacked_clause_outputs(
    r_stack: torch.Tensor,            # [R, C, L] per-replica resistance
    include: torch.Tensor,            # [C, L] bool (shared TA actions)
    lits: torch.Tensor,               # [B, L]
    tm_cfg: TMConfig,
    generator: Optional[torch.Generator] = None,
    vcfg: var.VariationConfig = var.VariationConfig(),
    cfg: IMBUEConfig = IMBUEConfig(),
) -> torch.Tensor:
    """Clause outputs ``[R, B, C]``: every replica reads the batch with its
    own fresh C2C and CSA noise (the R axis is written out)."""
    c, l = include.shape
    mapping = CrossbarMapping(n_clauses=c, n_literals=l, width=cfg.width)
    return analog_clause_outputs_raw(r_stack, include, lits, mapping, cfg,
                                     generator, vcfg)


def stacked_class_sums(
    r_stack: torch.Tensor,            # [R, C, L]
    include: torch.Tensor,            # [C, L] bool
    x: torch.Tensor,                  # [B, F] raw Boolean features
    tm_cfg: TMConfig,
    generator: Optional[torch.Generator] = None,
    vcfg: var.VariationConfig = var.VariationConfig(),
    cfg: IMBUEConfig = IMBUEConfig(),
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Per-replica class sums ``[R, B, M]`` int32 (the stacked analog
    forward), empty clauses masked, on ``device``."""
    device = resolve_device(device)
    include = include.to(device)
    cls = stacked_clause_outputs(r_stack.to(device), include,
                                 literals(x.to(device)), tm_cfg, generator,
                                 vcfg, cfg)                     # [R, B, C]
    cls = cls * include.any(dim=-1)[None, None, :].to(cls.dtype)
    return class_sums(cls, tm_cfg)


# --------------------------------------------------------------------------
# Monte-Carlo variation studies (paper §III-C / Fig. 7)
# --------------------------------------------------------------------------

def _draws(generator: torch.Generator, draws: int):
    """One ``(program, read)`` generator pair per draw: ``draws`` children
    split off ``generator``, each split in two."""
    return [var.split_generator(g, 2)
            for g in var.split_generator(generator, draws)]


def monte_carlo_accuracy(
    ta_state: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    generator: torch.Generator,
    tm_cfg: TMConfig,
    vcfg: var.VariationConfig = var.VariationConfig(),
    draws: int = 16,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Accuracy over independent device / cycle draws, ``[draws]`` float32
    on ``device`` (where ``generator`` lives).

    Each draw programs a fresh crossbar (D2D), then reads the batch under
    fresh C2C + CSA-offset noise: one manufactured chip and one read
    cycle.
    """
    device = resolve_device(device)
    inc = include_mask(ta_state.to(device), tm_cfg)
    x, y = x.to(device), y.to(device)
    accs = torch.empty(draws, dtype=torch.float32, device=device)
    for i, (g_prog, g_read) in enumerate(_draws(generator, draws)):
        xbar = program_crossbar(inc, g_prog, vcfg)
        pred = analog_predict(xbar, x, tm_cfg, g_read, vcfg)
        accs[i] = (pred == y).to(torch.float32).mean()
    return accs


def clause_error_rate(
    ta_state: torch.Tensor,
    x: torch.Tensor,
    generator: torch.Generator,
    tm_cfg: TMConfig,
    vcfg: var.VariationConfig = var.VariationConfig(),
    draws: int = 16,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Share of (datapoint, clause) cells where the analog readout
    disagrees with the digital oracle (training semantics: an empty clause
    fires), per draw: ``[draws]`` float32 on ``device``."""
    device = resolve_device(device)
    ta_state = ta_state.to(device)
    inc = include_mask(ta_state, tm_cfg)
    lits = literals(x.to(device))
    oracle = clause_outputs(ta_state, lits, tm_cfg, training=True)
    errs = torch.empty(draws, dtype=torch.float32, device=device)
    for i, (g_prog, g_read) in enumerate(_draws(generator, draws)):
        xbar = program_crossbar(inc, g_prog, vcfg)
        got = analog_clause_outputs(xbar, lits, g_read, vcfg)
        errs[i] = (got != oracle).to(torch.float32).mean()
    return errs
