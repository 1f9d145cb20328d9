"""Backend states: the *data* half of the port's backend API (port of
``repro.api.states``).

Frozen dataclasses whose tensors live on one device and whose configs are
frozen (hashable) dataclasses:

* ``DigitalState``      — the Boolean-domain TM (``include [C, L]``);
* ``ReplicaStackState`` — R independently programmed chips
  (``r_stack [R, C, L]`` Ω) sharing one set of TA actions: the serving
  hot path;
* ``CoalescedState``    — a shared clause pool with per-class integer
  weights (``ta_state [C, L]``, ``weights [C, M]``).

``pack()`` attaches the int32 include bitplane ``[C, ceil(L/32)]``;
``pack_planes()`` folds the programmed stack into the plane-packed
resident format the ``analog-cuda-packed2`` backend streams: the LRS/HRS
include-index bitplane (``plane_index``, the same words as
``include_packed``) plus the per-cell additive deviation plane
``plane_dev = r - r_nom`` (float32 ``[R, C, L]``), elided (None) when
every cell sits at its class-nominal resistance.  Off nominal, packing
quantizes each resistance to its own reconstruction so that
``r == r_nom + plane_dev`` holds bitwise, exactly as the reference does.
A coalesced pool is digital: its ``plane_index`` is the packed include
plane itself, with no deviation plane.

``CrossbarState`` comes with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import variations as var
from repro_torch.core.coalesced import CoalescedConfig
from repro_torch.core.imbue import IMBUEConfig
from repro_torch.core.mapping import CrossbarMapping
from repro_torch.core.tm import TMConfig, include_mask
from repro_torch.kernels import bitpack


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


@dataclasses.dataclass(frozen=True)
class DigitalState(_PackedMixin):
    """The Boolean-domain TM: include actions (+ optional TA states)."""

    include: torch.Tensor                    # [C, L] bool TA actions
    ta_state: Optional[torch.Tensor]         # [C, L] int, or None
    tm_cfg: TMConfig
    include_packed: Optional[torch.Tensor] = None   # [C, L/32] int32 words

    @classmethod
    def from_ta(cls, ta_state: torch.Tensor, tm_cfg: TMConfig
                ) -> "DigitalState":
        return cls(include=include_mask(ta_state, tm_cfg),
                   ta_state=ta_state, tm_cfg=tm_cfg)

    @property
    def device(self) -> torch.device:
        return self.include.device


@dataclasses.dataclass(frozen=True)
class ReplicaStackState(_PackedMixin):
    """R independently programmed chips sharing one set of TA actions."""

    r_stack: torch.Tensor                    # [R, C, L] programmed Ω, f32
    include: torch.Tensor                    # [C, L] bool (shared actions)
    tm_cfg: TMConfig
    icfg: IMBUEConfig = IMBUEConfig()
    vcfg: var.VariationConfig = var.VariationConfig()
    include_packed: Optional[torch.Tensor] = None   # [C, L/32] int32 words
    plane_index: Optional[torch.Tensor] = None      # [C, L/32] int32 LRS/HRS
    plane_dev: Optional[torch.Tensor] = None        # [R, C, L] f32 r - r_nom

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

    @property
    def mapping(self) -> CrossbarMapping:
        c, l = self.include.shape
        return CrossbarMapping(n_clauses=c, n_literals=l,
                               width=self.icfg.width)

    def replica_slice(self, i: int) -> "ReplicaStackState":
        """Single-chip view ``[1, C, L]`` of replica ``i``."""
        pd = None if self.plane_dev is None else self.plane_dev[i:i + 1]
        return dataclasses.replace(self, r_stack=self.r_stack[i:i + 1],
                                   plane_dev=pd)


@dataclasses.dataclass(frozen=True)
class CoalescedState(_PackedMixin):
    """Shared clause pool + per-class integer weights (coalesced TM)."""

    ta_state: torch.Tensor                   # [C, L] int TA states
    weights: torch.Tensor                    # [C, M] int per-class weights
    cfg: CoalescedConfig
    include_packed: Optional[torch.Tensor] = None   # [C, L/32] int32 words
    plane_index: Optional[torch.Tensor] = None      # [C, L/32] int32 words

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
