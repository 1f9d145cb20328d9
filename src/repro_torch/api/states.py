"""Backend states: the *data* half of the port's backend API (port of
``repro.api.states``).

Frozen dataclasses whose tensors live on one device and whose configs are
frozen (hashable) dataclasses:

* ``DigitalState``      — the Boolean-domain TM (``include [C, L]``);
* ``CrossbarState``     — one programmed chip (``r_mem [C, L]`` Ω +
  ``include``);
* ``ReplicaStackState`` — R independently programmed chips
  (``r_stack [R, C, L]`` Ω) sharing one set of TA actions: the serving
  hot path;
* ``CoalescedState``    — a shared clause pool with per-class integer
  weights (``ta_state [C, L]``, ``weights [C, M]``).

``pack()`` attaches the int32 include bitplane ``[C, ceil(L/32)]``;
``pack_planes()`` folds the programmed chips into the plane-packed
resident format the ``analog-cuda-packed2`` backend streams: the LRS/HRS
include-index bitplane (``plane_index``, the same words as
``include_packed``) plus the per-cell additive deviation plane
``plane_dev = r - r_nom`` (float32, ``[C, L]`` / ``[R, C, L]``), elided
(None) when every cell sits at its class-nominal resistance.  Off
nominal, packing quantizes each resistance to its own reconstruction so
that ``r == r_nom + plane_dev`` holds bitwise, exactly as the reference
does.  A coalesced pool is digital: its ``plane_index`` is the packed
include plane itself, with no deviation plane.

``DigitalState`` and ``CoalescedState`` carry their int32 ``[C, M]``
combine matrix (``combine``: the signed class one-hot, or the weights,
with the rows of empty clauses zeroed), built once when the state is
made; ``pack()`` and ``pack_planes()`` keep it, and the fused backends
hand it to the kernel wrappers instead of rebuilding it on every call.

``inject_faults`` bakes a stuck-at / drift overlay into the programmed
resistances (or, for the digital coalesced pool, the TA plane) and keeps
the int8 ``fault_mask``; on a plane-packed state the index bitplane
stays (it records the intended actions) and the deviation plane is
re-derived from the injured resistances.  ``reprogram`` writes new TA
actions with fresh D2D draws and drops every derived plane.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import torch

from repro_torch.core import variations as var
from repro_torch.core.coalesced import CoalescedConfig
from repro_torch.core.imbue import (IMBUEConfig, ProgrammedCrossbar,
                                    program_replica_stack)
from repro_torch.core.mapping import CrossbarMapping
from repro_torch.core.tm import TMConfig, include_mask
from repro_torch.kernels import bitpack, ops


class _PackedMixin:
    """Packed-wire-format support shared by the include-carrying states."""

    @property
    def packed(self) -> bool:
        return self.include_packed is not None

    @property
    def plane_packed(self) -> bool:
        """True when the resident conductance planes are packed (the
        ``pack_planes()`` format ``analog-cuda-packed2`` keys on)."""
        return getattr(self, "plane_index", None) is not None

    def pack(self):
        """This state with the packed include plane attached (idempotent)."""
        if self.packed:
            return self
        return dataclasses.replace(
            self, include_packed=bitpack.pack_bits(self.include))


def _deviation_plane(r: torch.Tensor, include: torch.Tensor
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(r_quantized, r - r_nom)`` as float32, the deviation ``None``
    when every cell is class-nominal.

    Same quantization as the reference: ``dev = fl(r - r_nom)`` and
    ``r_q = fl(r_nom + dev)``, so ``r_q == r_nom + dev`` holds bitwise
    (at most 0.5 ulp from the drawn resistance).  The elision check syncs
    to the host once, at pack time, never on the dispatch path.
    """
    r_nom = torch.where(include, var.LRS_MEAN_OHM,
                        var.HRS_MEAN_OHM).to(torch.float32)
    dev = (r - r_nom).to(torch.float32)
    if not bool((dev != 0.0).any()):
        return r.to(torch.float32), None
    return (r_nom + dev).to(torch.float32), dev


def stuck_ta(ta_state: torch.Tensor, mask: torch.Tensor,
             n_states: int) -> torch.Tensor:
    """A TA plane with the stuck cells of ``mask`` pinned: stuck at LRS
    to the top state (a hard include), stuck at HRS to state 1."""
    return torch.where(mask == var.FAULT_STUCK_LRS, 2 * n_states,
                       torch.where(mask == var.FAULT_STUCK_HRS, 1, ta_state)
                       ).to(ta_state.dtype)


@dataclasses.dataclass(frozen=True)
class DigitalState(_PackedMixin):
    """The Boolean-domain TM: include actions (+ optional TA states)."""

    include: torch.Tensor                    # [C, L] bool TA actions
    ta_state: Optional[torch.Tensor]         # [C, L] int, or None
    tm_cfg: TMConfig
    include_packed: Optional[torch.Tensor] = None   # [C, L/32] int32 words
    combine: Optional[torch.Tensor] = None          # [C, M] int32

    def __post_init__(self):
        if self.combine is None:
            object.__setattr__(self, "combine", ops.polarity_matrix(
                self.tm_cfg, self.include, device=self.include.device))

    @classmethod
    def from_ta(cls, ta_state: torch.Tensor, tm_cfg: TMConfig
                ) -> "DigitalState":
        return cls(include=include_mask(ta_state, tm_cfg),
                   ta_state=ta_state, tm_cfg=tm_cfg)

    @classmethod
    def from_include(cls, include: torch.Tensor, tm_cfg: TMConfig
                     ) -> "DigitalState":
        """The TM of the ``[C, L]`` include actions alone (no TA states):
        the clean model a health probe answers from."""
        return cls(include=torch.as_tensor(include).to(torch.bool),
                   ta_state=None, tm_cfg=tm_cfg)

    @property
    def device(self) -> torch.device:
        return self.include.device


def check_geometry(include: torch.Tensor, like: torch.Tensor) -> None:
    """Re-programming keeps the crossbar geometry: raise if ``include``
    does not have the shape of the programmed ``like``."""
    if include.shape != like.shape:
        raise ValueError(
            f"reprogram include shape {tuple(include.shape)} != crossbar "
            f"shape {tuple(like.shape)}: re-programming keeps the crossbar "
            "geometry")


class _AnalogMixin:
    """What one chip and a stack of chips share: the crossbar mapping and
    re-deriving the deviation plane after an injury."""

    @property
    def mapping(self) -> CrossbarMapping:
        c, l = self.include.shape
        return CrossbarMapping(n_clauses=c, n_literals=l,
                               width=self.icfg.width)

    def _with_injury(self, field: str, injured: torch.Tensor,
                     mask: torch.Tensor):
        """This state with ``field`` (``r_mem`` / ``r_stack``) injured.  The
        index bitplane records the intended actions and stays; the
        deviation plane re-derives from the injured resistances (keeping
        the old one would serve healthy values)."""
        if not self.plane_packed:
            return dataclasses.replace(self, **{field: injured},
                                       fault_mask=mask)
        r_q, dev = _deviation_plane(injured, self.include)
        return dataclasses.replace(self, **{field: r_q}, fault_mask=mask,
                                   plane_dev=dev)


@dataclasses.dataclass(frozen=True)
class CrossbarState(_PackedMixin, _AnalogMixin):
    """One programmed IMBUE chip: memristor resistances + TA actions."""

    r_mem: torch.Tensor                      # [C, L] programmed Ω, f32
    include: torch.Tensor                    # [C, L] bool TA actions
    tm_cfg: TMConfig
    icfg: IMBUEConfig = IMBUEConfig()
    vcfg: var.VariationConfig = var.VariationConfig()
    include_packed: Optional[torch.Tensor] = None   # [C, L/32] int32 words
    fault_mask: Optional[torch.Tensor] = None       # [C, L] int8 codes
    plane_index: Optional[torch.Tensor] = None      # [C, L/32] int32 LRS/HRS
    plane_dev: Optional[torch.Tensor] = None        # [C, L] f32 r - r_nom

    def pack_planes(self) -> "CrossbarState":
        """This chip with its resident plane packed: the index bitplane
        plus the deviation plane (elided for a nominal chip).  Implies
        :meth:`pack`."""
        if self.plane_packed:
            return self
        packed = self.pack()
        r_q, dev = _deviation_plane(packed.r_mem, packed.include)
        return dataclasses.replace(
            packed, r_mem=r_q, plane_index=packed.include_packed,
            plane_dev=dev)

    @classmethod
    def program(cls, include: torch.Tensor,
                generator: Optional[torch.Generator], tm_cfg: TMConfig,
                vcfg: var.VariationConfig = var.VariationConfig(),
                icfg: IMBUEConfig = IMBUEConfig()) -> "CrossbarState":
        """One-time programming: D2D resistance draws at SET/RESET time."""
        include = include.to(torch.bool)
        return cls(r_mem=var.sample_device_resistance(generator, include,
                                                      vcfg),
                   include=include, tm_cfg=tm_cfg, icfg=icfg, vcfg=vcfg)

    @classmethod
    def from_crossbar(cls, xbar: ProgrammedCrossbar, tm_cfg: TMConfig,
                      vcfg: var.VariationConfig = var.VariationConfig()
                      ) -> "CrossbarState":
        """Adopt a ``ProgrammedCrossbar``."""
        return cls(r_mem=xbar.r_mem, include=xbar.include.to(torch.bool),
                   tm_cfg=tm_cfg, icfg=xbar.cfg, vcfg=vcfg)

    @property
    def device(self) -> torch.device:
        return self.r_mem.device

    def reprogram(self, include: torch.Tensor,
                  generator: Optional[torch.Generator]) -> "CrossbarState":
        """This chip re-programmed with new TA actions: fresh D2D draws
        under the same configs; every derived plane is dropped."""
        include = include.to(torch.bool)
        check_geometry(include, self.include)
        return dataclasses.replace(
            self, r_mem=var.sample_device_resistance(generator, include,
                                                     self.vcfg),
            include=include, include_packed=None, fault_mask=None,
            plane_index=None, plane_dev=None)

    def inject_faults(self, generator: torch.Generator,
                      fcfg: Optional[var.FaultConfig] = None
                      ) -> "CrossbarState":
        """This chip with persistent faults baked in (``fcfg`` defaults to
        ``vcfg.fault``; a missing or nominal config returns ``self``).
        ``include`` keeps the intended actions; re-injection compounds."""
        fcfg = fcfg if fcfg is not None else self.vcfg.fault
        if fcfg is None or fcfg.is_nominal:
            return self
        mask = var.sample_fault_mask(generator, self.include.shape, fcfg,
                                     self.device)
        injured = var.apply_fault_overlay(self.r_mem, mask, fcfg)
        return self._with_injury(
            "r_mem", injured, var.merge_fault_masks(mask, self.fault_mask))


@dataclasses.dataclass(frozen=True)
class ReplicaStackState(_PackedMixin, _AnalogMixin):
    """R independently programmed chips sharing one set of TA actions."""

    r_stack: torch.Tensor                    # [R, C, L] programmed Ω, f32
    include: torch.Tensor                    # [C, L] bool (shared actions)
    tm_cfg: TMConfig
    icfg: IMBUEConfig = IMBUEConfig()
    vcfg: var.VariationConfig = var.VariationConfig()
    include_packed: Optional[torch.Tensor] = None   # [C, L/32] int32 words
    fault_mask: Optional[torch.Tensor] = None       # [R, C, L] int8 codes
    plane_index: Optional[torch.Tensor] = None      # [C, L/32] int32 LRS/HRS
    plane_dev: Optional[torch.Tensor] = None        # [R, C, L] f32 r - r_nom

    @classmethod
    def program(cls, include: torch.Tensor,
                generator: Optional[torch.Generator], n_replicas: int,
                tm_cfg: TMConfig,
                vcfg: var.VariationConfig = var.VariationConfig(),
                icfg: IMBUEConfig = IMBUEConfig()) -> "ReplicaStackState":
        """Program R chips with independent D2D draws (the draws of
        :func:`~repro_torch.serve.replica.program_replica_pool`)."""
        include = include.to(torch.bool)
        return cls(r_stack=program_replica_stack(include, generator,
                                                 n_replicas, vcfg),
                   include=include, tm_cfg=tm_cfg, icfg=icfg, vcfg=vcfg)

    def pack_planes(self) -> "ReplicaStackState":
        """The stack with its resident planes packed: ONE shared index
        bitplane plus the per-replica deviation plane (elided for a
        nominal stack).  Implies :meth:`pack`."""
        if self.plane_packed:
            return self
        packed = self.pack()
        r_q, dev = _deviation_plane(packed.r_stack, packed.include)
        return dataclasses.replace(
            packed, r_stack=r_q, plane_index=packed.include_packed,
            plane_dev=dev)

    @property
    def device(self) -> torch.device:
        return self.r_stack.device

    @property
    def n_replicas(self) -> int:
        return int(self.r_stack.shape[0])

    def replica_slice(self, i: int) -> "ReplicaStackState":
        """Single-chip view ``[1, C, L]`` of replica ``i``."""
        fm = None if self.fault_mask is None else self.fault_mask[i:i + 1]
        pd = None if self.plane_dev is None else self.plane_dev[i:i + 1]
        return dataclasses.replace(self, r_stack=self.r_stack[i:i + 1],
                                   fault_mask=fm, plane_dev=pd)

    def replica(self, i: int) -> CrossbarState:
        """Chip ``i`` as a standalone ``CrossbarState``."""
        fm = None if self.fault_mask is None else self.fault_mask[i]
        pd = None if self.plane_dev is None else self.plane_dev[i]
        return CrossbarState(r_mem=self.r_stack[i], include=self.include,
                             tm_cfg=self.tm_cfg, icfg=self.icfg,
                             vcfg=self.vcfg,
                             include_packed=self.include_packed,
                             fault_mask=fm, plane_index=self.plane_index,
                             plane_dev=pd)

    def reprogram(self, include: torch.Tensor,
                  generator: Optional[torch.Generator]
                  ) -> "ReplicaStackState":
        """All R chips re-programmed with new TA actions: the draws of
        :meth:`program` with the same generator; derived planes dropped."""
        include = include.to(torch.bool)
        check_geometry(include, self.include)
        return dataclasses.replace(
            self, r_stack=program_replica_stack(include, generator,
                                                self.n_replicas, self.vcfg),
            include=include, include_packed=None, fault_mask=None,
            plane_index=None, plane_dev=None)

    def inject_faults(self, generator: torch.Generator,
                      fcfg: Optional[var.FaultConfig] = None,
                      replicas: Optional[Iterable[int]] = None
                      ) -> "ReplicaStackState":
        """The stack with persistent faults baked into the chips
        ``replicas`` (all when None); the others stay bit-untouched.  Per
        chip as :meth:`CrossbarState.inject_faults`."""
        fcfg = fcfg if fcfg is not None else self.vcfg.fault
        if fcfg is None or fcfg.is_nominal:
            return self
        injured, mask = var.inject_stack_faults(
            generator, self.r_stack, fcfg, replicas, self.fault_mask)
        return self._with_injury("r_stack", injured, mask)


@dataclasses.dataclass(frozen=True)
class CoalescedState(_PackedMixin):
    """Shared clause pool + per-class integer weights (coalesced TM)."""

    ta_state: torch.Tensor                   # [C, L] int TA states
    weights: torch.Tensor                    # [C, M] int per-class weights
    cfg: CoalescedConfig
    include_packed: Optional[torch.Tensor] = None   # [C, L/32] int32 words
    fault_mask: Optional[torch.Tensor] = None       # [C, L] int8 codes
    plane_index: Optional[torch.Tensor] = None      # [C, L/32] int32 words
    combine: Optional[torch.Tensor] = None          # [C, M] int32

    def __post_init__(self):
        if self.combine is None:
            object.__setattr__(self, "combine", ops.coalesced_combine(
                self.weights.to(self.ta_state.device),
                self.include.any(dim=-1)))

    def reprogram(self, ta_state: torch.Tensor,
                  weights: torch.Tensor) -> "CoalescedState":
        """This model with new TA states and weights.  The tail is digital,
        so re-programming draws nothing; derived planes are dropped."""
        ta_state, weights = torch.as_tensor(ta_state), torch.as_tensor(weights)
        if (ta_state.shape != self.ta_state.shape
                or weights.shape != self.weights.shape):
            raise ValueError(
                f"reprogram shapes {tuple(ta_state.shape)}/"
                f"{tuple(weights.shape)} != model shapes "
                f"{tuple(self.ta_state.shape)}/{tuple(self.weights.shape)}")
        return dataclasses.replace(self, ta_state=ta_state, weights=weights,
                                   include_packed=None, fault_mask=None,
                                   plane_index=None, combine=None)

    def inject_faults(self, generator: torch.Generator,
                      fcfg: Optional[var.FaultConfig] = None
                      ) -> "CoalescedState":
        """Stuck-at faults baked into the TA plane: stuck at LRS reads as
        a hard include, stuck at HRS as a hard exclude (drift has no
        digital analogue).  The packed planes are dropped: faults change
        the include actions."""
        if fcfg is None or fcfg.is_nominal:
            return self
        mask = var.sample_fault_mask(generator, self.ta_state.shape, fcfg,
                                     self.device)
        return dataclasses.replace(
            self, ta_state=stuck_ta(self.ta_state, mask, self.cfg.n_states),
            fault_mask=var.merge_fault_masks(mask, self.fault_mask),
            include_packed=None, plane_index=None, combine=None)

    def pack_planes(self) -> "CoalescedState":
        """The model in the plane-packed format: the pool is digital, so
        the resident plane is the packed include plane itself (one shared
        buffer), marked as ``plane_index`` so that selection routes to
        ``coalesced-cuda-packed2``.  Implies :meth:`pack`."""
        if self.plane_packed:
            return self
        packed = self.pack()
        return dataclasses.replace(packed,
                                   plane_index=packed.include_packed)

    @property
    def include(self) -> torch.Tensor:
        """``[C, L]`` bool TA actions (include iff state > n_states)."""
        return self.ta_state > self.cfg.n_states

    @property
    def n_classes(self) -> int:
        return self.cfg.n_classes

    @property
    def n_clauses(self) -> int:
        return self.cfg.n_clauses

    @property
    def n_literals(self) -> int:
        return self.cfg.n_literals

    @property
    def device(self) -> torch.device:
        return self.ta_state.device
