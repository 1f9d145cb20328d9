"""Public wrappers around the port's kernels (port of the fused parts of
``repro.kernels.ops``).

* ``polarity_matrix(cfg, include)``             -> [C, M] signed one-hot
* ``coalesced_combine(w, nonempty)``            -> [C, M] weighted combine
* ``pack_literals(lits)``                       -> [.., ceil(L/32)] int32
* ``pack_include(include)``                     -> [.., C, ceil(L/32)] int32
* ``clause_eval(lits, include)``                -> [B, C] uint8 clause bits
* ``clause_eval_packed(litw, include_w)``       -> [B, C] uint8, AND + popcount
* ``imbue_class_sums_planes(litw, idx, dev)``   -> [B, M] analog sums
* ``imbue_class_sums_stack_planes(litw, ...)``  -> [R, B, M], one launch
* ``imbue_class_sums_raw(lits, g, leak, ...)``  -> [B, M], dense planes
* ``imbue_class_sums_raw_packed(litw, ...)``    -> [B, M], packed literals
* ``imbue_class_sums(lits, xbar, cfg)``         -> [B, M], one crossbar
* ``imbue_class_sums_stack(lits, r_stack, ...)``  -> [R, B, M], one launch
* ``imbue_class_sums_stack_packed(litw, ...)``  -> [R, B, M], one launch
* ``tm_class_sums(lits, include, comb)``        -> [B, M] digital or
  coalesced (``comb`` the polarity matrix or the weights), fused
* ``tm_class_sums_packed(litw, incw, comb)``    -> [B, M] AND + popcount
* ``tm_class_sums_planes(litw, incw, comb)``    -> [B, M], the resident
  include plane staged whole and counted on the b1 tensor cores

The two ``clause_eval`` wrappers return clause bits with training
semantics (an empty clause fires): they are what the training steps
evaluate clauses with, one launch per call.

The combine matrices are int32 ``[C, M]`` with the rows of empty clauses
zeroed (the inference-time empty-clause mask, folded into the sum), and
no padding of the class axis.  The digital and coalesced states build
theirs once (``state.combine``) and the backends pass it to the fused
wrappers.

The plane-packed resident operand is the include-index bitplane plus an
optional per-cell additive deviation plane (``dev = r - r_nom``).  C2C
noise is drawn per read here, before the kernel, exactly as the
reference draws it in jnp: the deviation plane becomes
``apply_c2c(generator, r_nom + dev, include, vcfg) - r_nom``.  The dense
tiers read the programmed resistances: the conductance and leak planes
``[R, C, L]`` (with the read's C2C draw, when a generator is given) are
built here in the reference's op order (``core.imbue.conductances``)
before the one launch.  The CSA offset is not modelled (scalar
reference); capability selection routes such reads to ``analog-torch``.

No tile padding is needed: the CUDA kernel masks the ragged batch and
clause edges itself, and the word padding past ``l_valid`` is masked by
the kernel's validity test.  Entry points run on ``device`` (default
``cuda``; ``None`` without CUDA raises).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import variations as var
from repro_torch.core.imbue import (IMBUEConfig, ProgrammedCrossbar,
                                    cell_conductances, conductances)
from repro_torch.core.tm import TMConfig, polarity
from repro_torch.kernels import bitpack
from repro_torch.kernels import clause_eval as clause_kernels
from repro_torch.kernels.clause_eval import (tm_infer, tm_infer_packed,
                                             tm_infer_planes)
from repro_torch.kernels.imbue_infer import (PlaneScalars, _f32, imbue_infer,
                                             imbue_infer_packed,
                                             imbue_infer_planes)


def polarity_matrix(cfg: TMConfig, include: Optional[torch.Tensor] = None,
                    device=None) -> torch.Tensor:
    """Signed one-hot ``[C, M]`` int32: ``P[c, m] = polarity(c) *
    [class(c) == m]``, rows of empty clauses zeroed when ``include`` is
    given (the inference-time empty-clause mask, folded into the sum)."""
    c = cfg.n_clauses
    cls_of = torch.arange(c, device=device) // cfg.clauses_per_class
    onehot = torch.nn.functional.one_hot(cls_of, cfg.n_classes)
    p = (onehot * polarity(cfg, device)[:, None]).to(torch.int32)
    if include is not None:
        p = p * include.any(dim=-1)[:, None].to(torch.int32)
    return p


def pack_literals(lits: torch.Tensor) -> torch.Tensor:
    """``[..., L]`` 0/1 literals -> ``[..., ceil(L/32)] int32`` words."""
    return bitpack.pack_bits(lits)


def pack_include(include: torch.Tensor) -> torch.Tensor:
    """``[..., C, L]`` bool include plane -> ``[..., C, ceil(L/32)]``
    int32 words."""
    return bitpack.pack_bits(include)


def _nonempty_from_packed(include_w: torch.Tensor) -> torch.Tensor:
    """``[C, Lw]`` words -> ``[C]`` bool "clause has any include"."""
    return (include_w != 0).any(dim=-1)


def plane_scalars(icfg: IMBUEConfig, l_valid: int) -> PlaneScalars:
    """The kernel's float32 scalars for one crossbar configuration."""
    return PlaneScalars.make(
        v_ref=icfg.reference_voltage(), r_div=icfg.r_divider,
        v_read=icfg.v_read, r_lrs=var.LRS_MEAN_OHM, r_hrs=var.HRS_MEAN_OHM,
        leak_inc=var.I_LEAK_INCLUDE, leak_exc=var.I_LEAK_EXCLUDE,
        series_factor=icfg.series_factor, l_valid=l_valid)


def c2c_deviation(generator: torch.Generator, plane_index: torch.Tensor,
                  plane_dev: Optional[torch.Tensor], n_replicas: int,
                  vcfg: var.VariationConfig, l_valid: int) -> torch.Tensor:
    """One read's deviation plane ``[R, C, L]`` with a fresh C2C draw per
    cell of every replica: ``apply_c2c(r_nom + dev) - r_nom``."""
    include = bitpack.unpack_bits(plane_index, l_valid).to(torch.bool)
    r_nom = torch.where(include, var.LRS_MEAN_OHM,
                        var.HRS_MEAN_OHM).to(torch.float32)
    r = r_nom if plane_dev is None else r_nom + plane_dev
    r = r.expand(n_replicas, *include.shape)
    return var.apply_c2c(generator, r, include, vcfg) - r_nom


def imbue_class_sums_stack_planes(
    litw: torch.Tensor,               # [B, ceil(L/32)] int32 literal words
    plane_index: torch.Tensor,        # [C, ceil(L/32)] int32 (shared)
    plane_dev: Optional[torch.Tensor],  # [R, C, L] f32 deviations, or None
    icfg: IMBUEConfig,
    cfg: TMConfig,
    generator: Optional[torch.Generator] = None,
    *,
    vcfg: Optional[var.VariationConfig] = None,
    l_valid: int,
    n_replicas: int,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Plane-packed replica-stack inference -> ``[R, B, M]`` int32.

    One kernel launch per call: R is a grid axis of the kernel.  A
    nominal stack with no C2C read is ONE launch for a single replica,
    expanded over R — replicas are identical by construction.  A C2C
    read (``generator`` given and ``vcfg.c2c``) draws fresh noise for
    every replica before the launch.
    """
    vcfg = vcfg or var.VariationConfig.nominal()
    device = resolve_device(device)
    litw = litw.to(device=device, dtype=torch.int32).contiguous()
    plane_index = plane_index.to(device=device, dtype=torch.int32)
    dev = None if plane_dev is None else plane_dev.to(device=device,
                                                      dtype=torch.float32)
    if dev is not None and dev.shape[0] != n_replicas:
        raise ValueError(f"plane_dev has {dev.shape[0]} replicas, "
                         f"expected {n_replicas}")
    if generator is not None and vcfg.c2c:
        dev = c2c_deviation(generator, plane_index, dev, n_replicas, vcfg,
                            l_valid)
    pol = polarity_matrix(cfg, device=device)
    pol = pol * _nonempty_from_packed(plane_index)[:, None].to(torch.int32)
    out = imbue_infer_planes(
        litw, plane_index.contiguous(),
        None if dev is None else dev.contiguous(), pol.contiguous(),
        plane_scalars(icfg, l_valid))
    if dev is None:
        return out.expand(n_replicas, *out.shape[1:])
    return out


def imbue_class_sums_planes(
    litw: torch.Tensor,               # [B, ceil(L/32)] int32 literal words
    plane_index: torch.Tensor,        # [C, ceil(L/32)] int32 index plane
    plane_dev: Optional[torch.Tensor],  # [C, L] f32 deviation, or None
    icfg: IMBUEConfig,
    cfg: TMConfig,
    generator: Optional[torch.Generator] = None,
    *,
    vcfg: Optional[var.VariationConfig] = None,
    l_valid: int,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Fused analog inference from ONE plane-packed chip -> ``[B, M]``."""
    dev = None if plane_dev is None else plane_dev[None]
    return imbue_class_sums_stack_planes(
        litw, plane_index, dev, icfg, cfg, generator, vcfg=vcfg,
        l_valid=l_valid, n_replicas=1, device=device)[0]


# ------------------------------------------------ analog, dense planes

def _dense_class_sums(kernel, lits: torch.Tensor, g: torch.Tensor,
                      leak: torch.Tensor, include: torch.Tensor,
                      v_read: float, r_div: float, v_ref: float,
                      cfg: TMConfig, width: int) -> torch.Tensor:
    """One launch of ``kernel`` on ``[R, C, L]`` planes (on ``lits``'
    device) -> ``[R, B, M]`` int32."""
    if width != bitpack.WORD:
        raise ValueError(f"the analog kernels sense {bitpack.WORD}-cell "
                         f"columns; IMBUEConfig.width is {width}")
    device = lits.device
    g = g.to(device=device, dtype=torch.float32).contiguous()
    leak = leak.to(device=device, dtype=torch.float32).contiguous()
    pol = polarity_matrix(cfg, include.to(device=device, dtype=torch.bool),
                          device=device)
    return kernel(lits, g, leak, pol.contiguous(), _f32(v_ref / r_div),
                  _f32(v_read))


def _lits(lits: torch.Tensor, device: DeviceLike) -> torch.Tensor:
    return lits.to(device=resolve_device(device),
                   dtype=torch.uint8).contiguous()


def _litw(litw: torch.Tensor, device: DeviceLike) -> torch.Tensor:
    return litw.to(device=resolve_device(device),
                   dtype=torch.int32).contiguous()


def imbue_class_sums_raw(
    lits: torch.Tensor,               # [B, L] 0/1 literals
    g_on: torch.Tensor,               # [C, L] on-path conductance (S)
    i_leak: torch.Tensor,             # [C, L] leak currents (A)
    include: torch.Tensor,            # [C, L] bool (empty-clause mask)
    v_read: float,
    r_div: float,
    v_ref: float,
    cfg: TMConfig,
    *,
    width: int = bitpack.WORD,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Fused analog inference on explicit conductances -> ``[B, M]`` int32
    (the ``imbue_infer`` kernel)."""
    return _dense_class_sums(imbue_infer, _lits(lits, device), g_on[None],
                             i_leak[None], include, v_read, r_div, v_ref,
                             cfg, width)[0]


def imbue_class_sums_raw_packed(
    litw: torch.Tensor,               # [B, ceil(L/32)] int32 literal words
    g_on: torch.Tensor,               # [C, L] on-path conductance (S)
    i_leak: torch.Tensor,             # [C, L] leak currents (A)
    include: torch.Tensor,            # [C, L] bool (empty-clause mask)
    v_read: float,
    r_div: float,
    v_ref: float,
    cfg: TMConfig,
    *,
    width: int = bitpack.WORD,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Fused analog inference from packed literals -> ``[B, M]`` int32
    (the ``imbue_infer_packed`` kernel; the planes stay dense float32)."""
    return _dense_class_sums(imbue_infer_packed, _litw(litw, device),
                             g_on[None], i_leak[None], include, v_read,
                             r_div, v_ref, cfg, width)[0]


def imbue_class_sums(lits: torch.Tensor, xbar: ProgrammedCrossbar,
                     cfg: TMConfig, *,
                     generator: Optional[torch.Generator] = None,
                     vcfg: Optional[var.VariationConfig] = None,
                     device: DeviceLike = None) -> torch.Tensor:
    """Fused analog inference from a ``ProgrammedCrossbar`` (one read, C2C
    drawn from ``generator`` when given) -> ``[B, M]`` int32."""
    vcfg = vcfg or var.VariationConfig.nominal()
    g_on, i_leak = cell_conductances(xbar, generator, vcfg)
    return imbue_class_sums_raw(
        lits, g_on, i_leak, xbar.include, xbar.cfg.v_read,
        xbar.cfg.r_divider, xbar.cfg.reference_voltage(), cfg,
        width=xbar.cfg.width, device=device)


def _stack_sums(kernel, lits: torch.Tensor, r_stack: torch.Tensor,
                include: torch.Tensor, icfg: IMBUEConfig, cfg: TMConfig,
                generator: Optional[torch.Generator],
                vcfg: Optional[var.VariationConfig]) -> torch.Tensor:
    vcfg = vcfg or var.VariationConfig.nominal()
    include = include.to(device=lits.device, dtype=torch.bool)
    g_on, i_leak = conductances(r_stack.to(lits.device), include, icfg,
                                generator, vcfg)           # [R, C, L] each
    return _dense_class_sums(kernel, lits, g_on, i_leak, include,
                             icfg.v_read, icfg.r_divider,
                             icfg.reference_voltage(), cfg, icfg.width)


def imbue_class_sums_stack(
    lits: torch.Tensor,               # [B, L] 0/1 literals
    r_stack: torch.Tensor,            # [R, C, L] programmed resistances
    include: torch.Tensor,            # [C, L] bool (shared TA actions)
    icfg: IMBUEConfig,
    cfg: TMConfig,
    generator: Optional[torch.Generator] = None,
    *,
    vcfg: Optional[var.VariationConfig] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Replica-stack inference -> ``[R, B, M]`` int32 in ONE launch (R is
    a grid axis of ``imbue_infer``).  The conductance planes are built
    eagerly in ``[R, C, L]`` first; a C2C read (``generator`` given and
    ``vcfg.c2c``) draws fresh noise for every cell of every replica."""
    return _stack_sums(imbue_infer, _lits(lits, device), r_stack, include,
                       icfg, cfg, generator, vcfg)


def imbue_class_sums_stack_packed(
    litw: torch.Tensor,               # [B, ceil(L/32)] int32 literal words
    r_stack: torch.Tensor,            # [R, C, L] programmed resistances
    include: torch.Tensor,            # [C, L] bool (shared TA actions)
    icfg: IMBUEConfig,
    cfg: TMConfig,
    generator: Optional[torch.Generator] = None,
    *,
    vcfg: Optional[var.VariationConfig] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Packed-literal replica-stack inference -> ``[R, B, M]`` int32 in
    ONE launch of ``imbue_infer_packed``; noise as
    :func:`imbue_class_sums_stack`."""
    return _stack_sums(imbue_infer_packed, _litw(litw, device), r_stack,
                       include, icfg, cfg, generator, vcfg)


# ------------------------------------------- digital / coalesced, fused

def coalesced_combine(weights: torch.Tensor,
                      nonempty: torch.Tensor) -> torch.Tensor:
    """``[C, M]`` integer weights -> ``[C, M]`` int32 combine matrix with
    the rows of empty clauses zeroed (the coalesced analogue of
    :func:`polarity_matrix`)."""
    return (weights.to(torch.int32)
            * nonempty[:, None].to(torch.int32)).contiguous()


def _packed_operands(litw: torch.Tensor, include_w: torch.Tensor,
                     device: DeviceLike):
    litw = _litw(litw, device)
    return litw, include_w.to(device=litw.device,
                              dtype=torch.int32).contiguous()


def _dense_operands(lits: torch.Tensor, include: torch.Tensor,
                    device: DeviceLike):
    lits = _lits(lits, device)
    return lits, include.to(device=lits.device, dtype=torch.bool).contiguous()


def _comb(comb: torch.Tensor, device: torch.device) -> torch.Tensor:
    return comb.to(device=device, dtype=torch.int32).contiguous()


def tm_class_sums(lits: torch.Tensor, include: torch.Tensor,
                  comb: torch.Tensor, *,
                  device: DeviceLike = None) -> torch.Tensor:
    """Fused inference: ``[B, L]`` literals, the ``[C, L]`` include plane
    and the ``[C, M]`` combine matrix (:func:`polarity_matrix` for a
    digital TM, :func:`coalesced_combine` for a coalesced pool) ->
    ``[B, M]`` int32 (the ``tm_infer`` kernel)."""
    lits, include = _dense_operands(lits, include, device)
    return tm_infer(lits, include, _comb(comb, lits.device))


def tm_class_sums_packed(litw: torch.Tensor, include_w: torch.Tensor,
                         comb: torch.Tensor, *,
                         device: DeviceLike = None) -> torch.Tensor:
    """:func:`tm_class_sums` from packed words -> ``[B, M]`` int32 (the
    ``tm_infer_packed`` kernel)."""
    litw, incw = _packed_operands(litw, include_w, device)
    return tm_infer_packed(litw, incw, _comb(comb, litw.device))


def tm_class_sums_planes(litw: torch.Tensor, include_w: torch.Tensor,
                         comb: torch.Tensor, *,
                         device: DeviceLike = None) -> torch.Tensor:
    """:func:`tm_class_sums` on the resident include plane, staged whole
    and counted on the b1 tensor cores -> ``[B, M]`` int32 (the
    ``tm_infer_planes`` kernel; the same integers as
    :func:`tm_class_sums_packed`)."""
    litw, incw = _packed_operands(litw, include_w, device)
    return tm_infer_planes(litw, incw, _comb(comb, litw.device))


# ------------------------------------------- clause bits, training semantics

def clause_eval(lits: torch.Tensor, include: torch.Tensor, *,
                device: DeviceLike = None) -> torch.Tensor:
    """Digital clause outputs ``[B, C]`` uint8 with training semantics
    (empty clauses fire) from ``[B, L]`` 0/1 literals and the ``[C, L]``
    include plane (bool or 0/1 bytes): one launch of ``clause_eval``."""
    lits = _lits(lits, device)
    include = include.to(device=lits.device)
    if include.dtype != torch.bool:
        include = include.to(torch.uint8)
    return clause_kernels.clause_eval(lits, include.contiguous())


def clause_eval_packed(litw: torch.Tensor, include_w: torch.Tensor, *,
                       device: DeviceLike = None) -> torch.Tensor:
    """Digital clause outputs ``[B, C]`` uint8 from packed operands
    (:func:`pack_literals` / :func:`pack_include`), training semantics as
    :func:`clause_eval`: one launch of ``clause_eval_packed``."""
    litw, incw = _packed_operands(litw, include_w, device)
    return clause_kernels.clause_eval_packed(litw, incw)
