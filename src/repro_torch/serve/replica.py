"""Replica pool: R independently programmed crossbars behind one TM (port
of ``repro.serve.replica``).

* ``ReplicaPool`` — frozen device state: the programmed ``[R, C, L]``
  resistances, the shared include plane, the static configs, the model
  ``version`` and the int8 ``fault_mask`` of the injured chips.
* ``RouterState`` — mutable host-side routing counters (round-robin
  cursor, per-replica load, quarantined chips), kept out of the pool.
* ``ensemble_vote`` — majority (or summed) vote over per-replica class
  sums, masked to the healthy chips;
* ``CoalescedPool`` — ONE shared coalesced clause pool (``n_replicas ==
  1``) behind the same engine surface.

Each pool kind supplies what the engine and the live-operations modules
must not branch on: its backend ladder (``BACKENDS``, best tier first,
and ``default_backend(state)``), its routed single-chip states
(``routes(state)``), its hot-swap compatibility check
(``check_compatible``), the clean model a health probe answers from
(``clean_reference``), its snapshot tensors (``KIND``, ``leaves`` /
``from_leaves``) and its re-programming from trained TA states
(``reprogrammed``).

``reprogram`` writes a new model (``version`` + 1); ``inject_faults``
hurts the hardware and ``repair_replica`` re-programs one chip, neither
changing ``version``.  A replica pool bakes faults into its resistances;
the coalesced pool keeps its TA plane clean and applies the stored mask
in ``state()``.

``shard(mesh, rules)`` places a pool on a ``DeviceMesh`` as its state
does (``api.states``): a replica pool's ``r_stack`` splits over
``replica``, a coalesced pool's weight columns too.  The routed
single-chip states of a partitioned replica pool are cut from its stack
gathered whole, so a routed read is one chip's, as on one device; the
injuring and repairing methods work on the gathered pool and return it
whole, for the engine to place again.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Set, Tuple

import torch

from repro_torch.api.states import (CoalescedState, DigitalState,
                                    ReplicaStackState, Shardable,
                                    check_geometry, stuck_ta)
from repro_torch.core import variations as var
from repro_torch.core.coalesced import CoalescedConfig
from repro_torch.core.imbue import (IMBUEConfig, ProgrammedCrossbar,
                                    program_replica_stack)
from repro_torch.core.mapping import CrossbarMapping
from repro_torch.core.tm import TMConfig, include_mask
from repro_torch.distributed import sharding
from repro_torch.trace import span


@dataclasses.dataclass
class RouterState:
    """Mutable host-side routing counters (NOT device state)."""

    rows_dispatched: List[int]
    batches_dispatched: List[int]
    rr_next: int = 0
    quarantined: Set[int] = dataclasses.field(default_factory=set)

    @classmethod
    def create(cls, n_replicas: int) -> "RouterState":
        return cls(rows_dispatched=[0] * n_replicas,
                   batches_dispatched=[0] * n_replicas)

    @property
    def n_replicas(self) -> int:
        return len(self.rows_dispatched)

    def healthy_replicas(self) -> List[int]:
        """Indices eligible for routing, with a floor of one: if every
        chip is quarantined, all stay eligible — serving degrades, it
        never halts."""
        h = [i for i in range(self.n_replicas) if i not in self.quarantined]
        return h if h else list(range(self.n_replicas))

    def quarantine(self, i: int) -> None:
        self.quarantined.add(i)

    def readmit(self, i: int) -> None:
        self.quarantined.discard(i)

    def pick(self, policy: str) -> int:
        healthy = self.healthy_replicas()
        if policy == "round_robin":
            # Advance the cursor past quarantined chips so the healthy
            # subset still sees an even rotation.
            i = self.rr_next % self.n_replicas
            while i not in healthy:
                i = (i + 1) % self.n_replicas
            self.rr_next = (i + 1) % self.n_replicas
            return i
        if policy == "least_loaded":
            return min(healthy, key=lambda i: self.rows_dispatched[i])
        raise ValueError(f"unknown routing policy {policy!r}")

    def note_dispatch(self, i: int, rows: int) -> None:
        self.rows_dispatched[i] += rows
        self.batches_dispatched[i] += 1


def _ladder_pick(ladder: Tuple[str, str, str], state) -> str:
    """The tier of ``ladder`` (plane-packed, packed, dense) that matches
    ``state``'s wire format."""
    if state.plane_packed:
        return ladder[0]
    return ladder[1] if state.packed else ladder[2]


@dataclasses.dataclass(frozen=True)
class ReplicaPool(Shardable):
    """R programmed crossbars sharing one set of TA actions."""

    # The engine's default backends, the reference's analog ladder:
    # plane-packed, packed literals, dense.
    BACKENDS = ("analog-cuda-packed2", "analog-cuda-packed", "analog-cuda")
    KIND = "replica"                # the snapshot manifest's pool kind

    r_stack: torch.Tensor           # [R, C, L] programmed resistances (Ω)
    include: torch.Tensor           # [C, L] bool TA actions
    icfg: IMBUEConfig
    vcfg: var.VariationConfig
    version: int = 0                # monotonic model generation
    fault_mask: Optional[torch.Tensor] = None   # [R, C, L] int8 codes

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

    def to(self, device) -> "ReplicaPool":
        """This pool with its tensors on ``device``."""
        fm = None if self.fault_mask is None else self.fault_mask.to(device)
        return dataclasses.replace(self, r_stack=self.r_stack.to(device),
                                   include=self.include.to(device),
                                   fault_mask=fm)

    def state(self, tm_cfg: TMConfig) -> ReplicaStackState:
        """The pool as a backend ``ReplicaStackState``.  Faults are baked
        into ``r_stack`` already, so the state carries no mask: backends
        need no fault plumbing."""
        return ReplicaStackState(r_stack=self.r_stack, include=self.include,
                                 tm_cfg=tm_cfg, icfg=self.icfg,
                                 vcfg=self.vcfg)

    def router(self) -> RouterState:
        """A fresh routing-counter block sized for this pool."""
        return RouterState.create(self.n_replicas)

    def default_backend(self, state: ReplicaStackState) -> str:
        return _ladder_pick(self.BACKENDS, state)

    def routes(self, state: ReplicaStackState) -> List[ReplicaStackState]:
        """The ``[1, C, L]`` single-chip views routed dispatch reads, one
        per replica (of the stack gathered whole when it is
        partitioned: every rank of the mesh must call this)."""
        state = sharding.gather_tree(state)
        return [state.replica_slice(i) for i in range(self.n_replicas)]

    def check_compatible(self, other: "ReplicaPool") -> None:
        """Raise unless ``other`` can replace this pool under a running
        engine: the same model shape and crossbar / noise configs."""
        if other.include.shape != self.include.shape:
            raise ValueError(
                f"install_pool: model shape changed "
                f"({tuple(self.include.shape)} -> "
                f"{tuple(other.include.shape)})")
        if (other.icfg, other.vcfg) != (self.icfg, self.vcfg):
            raise ValueError(
                "install_pool: crossbar/noise config changed; backend "
                "selection is static per engine — build a new engine "
                "instead")

    def clean_reference(self, tm_cfg: TMConfig) -> DigitalState:
        """The digital TM of the programmed model: faults live in
        ``r_stack``, never in ``include``, so this is the clean answer."""
        return DigitalState.from_include(self.include, tm_cfg)

    def leaves(self) -> dict:
        """The tensors a snapshot saves."""
        return {"r_stack": self.r_stack, "include": self.include}

    def from_leaves(self, tree: dict, version: int) -> "ReplicaPool":
        """This pool's configs around saved :meth:`leaves`; snapshots hold
        only the programmed model, so the result carries no fault mask."""
        return dataclasses.replace(
            self, r_stack=tree["r_stack"],
            include=tree["include"].to(torch.bool), version=int(version),
            fault_mask=None)

    def reprogrammed(self, ta_state: torch.Tensor,
                     generator: Optional[torch.Generator], tm_cfg: TMConfig,
                     *, weights: Optional[torch.Tensor] = None
                     ) -> "ReplicaPool":
        """:meth:`reprogram` from trained TA states (``weights`` is for a
        coalesced pool and unused here)."""
        del weights
        include = include_mask(torch.as_tensor(ta_state).to(self.device),
                               tm_cfg)
        return self.reprogram(include, generator)

    def crossbar(self, i: int) -> ProgrammedCrossbar:
        """Replica ``i`` as a standalone ``ProgrammedCrossbar``."""
        return ProgrammedCrossbar(r_mem=self.r_stack[i], include=self.include,
                                  mapping=self.mapping, cfg=self.icfg)

    def reprogram(self, include: torch.Tensor,
                  generator: Optional[torch.Generator]) -> "ReplicaPool":
        """The pool re-programmed with new TA actions: fresh D2D draws for
        every chip (the draws of :func:`program_replica_pool` with the same
        generator), ``version`` + 1, no faults."""
        include = include.to(device=self.device, dtype=torch.bool)
        check_geometry(include, self.include)
        r_stack = program_replica_stack(include, generator, self.n_replicas,
                                        self.vcfg)
        return dataclasses.replace(self, r_stack=r_stack, include=include,
                                   version=self.version + 1,
                                   fault_mask=None)

    def inject_faults(self, generator: torch.Generator,
                      fcfg: Optional[var.FaultConfig] = None,
                      replicas: Optional[Iterable[int]] = None
                      ) -> "ReplicaPool":
        """The pool with persistent faults baked into the chips
        ``replicas`` (all when None): stuck cells pinned at the nominal
        LRS/HRS, healthy cells aged by the drift, the mask kept.  ``fcfg``
        defaults to ``vcfg.fault``; missing or nominal returns ``self``."""
        fcfg = fcfg if fcfg is not None else self.vcfg.fault
        if fcfg is None or fcfg.is_nominal:
            return self
        whole = sharding.gather_tree(self)
        injured, mask = var.inject_stack_faults(
            generator, whole.r_stack, fcfg, replicas, whole.fault_mask)
        return dataclasses.replace(whole, r_stack=injured, fault_mask=mask)

    def repair_replica(self, i: int,
                       generator: Optional[torch.Generator]) -> "ReplicaPool":
        """Chip ``i`` re-programmed: fresh D2D draws replace its
        resistances and clear its mask rows; the other chips are
        bit-untouched.  When the last injured chip is repaired the mask
        drops back to ``None``."""
        if not 0 <= i < self.n_replicas:
            raise IndexError(f"replica {i} out of range "
                             f"[0, {self.n_replicas})")
        whole = sharding.gather_tree(self)
        r_stack = whole.r_stack.clone()
        r_stack[i] = var.sample_device_resistance(generator, self.include,
                                                  self.vcfg)
        fm = whole.fault_mask
        if fm is not None:
            fm = fm.clone()
            fm[i] = 0
            if not bool(fm.any()):
                fm = None
        return dataclasses.replace(whole, r_stack=r_stack, fault_mask=fm)


@dataclasses.dataclass(frozen=True)
class CoalescedPool(Shardable):
    """ONE shared coalesced clause pool behind the serving engine.

    Instead of R chips each holding M per-class clause banks, one
    crossbar's clause pool serves all M classes through per-(clause,
    class) weights in the digital tail.  The pool presents the surface
    ``ServeEngine`` drives (``router()``, ``state()``, ``to()``,
    ``n_replicas``, ``include``, ``vcfg``, ``version``) with
    ``n_replicas == 1``: routing lands on the one chip, and "ensemble" is
    the argmax.  The weighted tail is digital and noise-free, so ``vcfg``
    is pinned nominal.
    """

    # The coalesced family's ladder, in the same tier order.
    BACKENDS = ("coalesced-cuda-packed2", "coalesced-cuda-packed",
                "coalesced-cuda")
    KIND = "coalesced"

    ta_state: torch.Tensor          # [C, L] trained TA states
    weights: torch.Tensor           # [C, M] per-(clause, class) weights
    cfg: CoalescedConfig
    version: int = 0                # monotonic model generation
    fault_mask: Optional[torch.Tensor] = None   # [C, L] int8 codes

    @property
    def n_replicas(self) -> int:
        return 1

    @property
    def vcfg(self) -> var.VariationConfig:
        """Digital weighted tail: no analog noise model applies."""
        return var.VariationConfig.nominal()

    @property
    def include(self) -> torch.Tensor:
        """``[C, L]`` bool TA actions (hardware-figure accounting)."""
        return self.ta_state > self.cfg.n_states

    @property
    def device(self) -> torch.device:
        return self.ta_state.device

    def to(self, device) -> "CoalescedPool":
        """This pool with its tensors on ``device``."""
        fm = None if self.fault_mask is None else self.fault_mask.to(device)
        return dataclasses.replace(self, ta_state=self.ta_state.to(device),
                                   weights=self.weights.to(device),
                                   fault_mask=fm)

    def state(self, cfg: Optional[CoalescedConfig] = None) -> CoalescedState:
        """The pool as a backend ``CoalescedState``; ``cfg``, if given,
        must be the pool's own.  The stored fault mask is applied here
        (stuck at LRS: a hard include, at HRS: a hard exclude); the
        trained TA plane itself stays clean, so repair clears the mask."""
        if cfg is not None and cfg != self.cfg:
            raise ValueError("CoalescedPool.state(cfg) must match the "
                             "pool's own CoalescedConfig")
        ta = self.ta_state
        if self.fault_mask is not None:
            ta = stuck_ta(ta, self.fault_mask, self.cfg.n_states)
        return CoalescedState(ta_state=ta, weights=self.weights,
                              cfg=self.cfg)

    def router(self) -> RouterState:
        return RouterState.create(self.n_replicas)

    def default_backend(self, state: CoalescedState) -> str:
        return _ladder_pick(self.BACKENDS, state)

    def routes(self, state: CoalescedState) -> List[CoalescedState]:
        """One shared chip: every route reads the full state."""
        return [state]

    def check_compatible(self, other: "CoalescedPool") -> None:
        """Raise unless ``other`` has this pool's config and shapes."""
        if other.cfg != self.cfg:
            raise ValueError("install_pool: coalesced config changed; "
                             "build a new engine instead")
        if (other.ta_state.shape != self.ta_state.shape
                or other.weights.shape != self.weights.shape):
            raise ValueError("install_pool: model shape changed")

    def clean_reference(self, tm_cfg: Optional[CoalescedConfig] = None
                        ) -> CoalescedState:
        """The state without the fault mask: the TA plane is clean by
        design (:meth:`state` applies the mask on the fly)."""
        del tm_cfg
        return CoalescedState(ta_state=self.ta_state, weights=self.weights,
                              cfg=self.cfg)

    def leaves(self) -> dict:
        return {"ta_state": self.ta_state, "weights": self.weights}

    def from_leaves(self, tree: dict, version: int) -> "CoalescedPool":
        return dataclasses.replace(
            self, ta_state=tree["ta_state"], weights=tree["weights"],
            version=int(version), fault_mask=None)

    def reprogrammed(self, ta_state: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     tm_cfg: Optional[CoalescedConfig] = None, *,
                     weights: Optional[torch.Tensor] = None
                     ) -> "CoalescedPool":
        """:meth:`reprogram`; the digital tail draws nothing, so
        ``generator`` is unused, and ``weights`` is required."""
        del generator, tm_cfg
        if weights is None:
            raise ValueError("a coalesced pool re-programs from "
                             "(ta_state, weights); pass weights=")
        return self.reprogram(ta_state, weights)

    def reprogram(self, ta_state: torch.Tensor,
                  weights: torch.Tensor) -> "CoalescedPool":
        """The pool re-programmed with new TA states and weights;
        ``version`` + 1.  The tail is digital: nothing is drawn."""
        ta_state = torch.as_tensor(ta_state).to(self.device)
        weights = torch.as_tensor(weights).to(self.device)
        if (ta_state.shape != self.ta_state.shape
                or weights.shape != self.weights.shape):
            raise ValueError(
                f"reprogram shapes {tuple(ta_state.shape)}/"
                f"{tuple(weights.shape)} != pool shapes "
                f"{tuple(self.ta_state.shape)}/{tuple(self.weights.shape)}")
        return dataclasses.replace(self, ta_state=ta_state, weights=weights,
                                   version=self.version + 1, fault_mask=None)

    def inject_faults(self, generator: torch.Generator,
                      fcfg: Optional[var.FaultConfig] = None,
                      replicas: Optional[Iterable[int]] = None
                      ) -> "CoalescedPool":
        """Stuck-at faults on the one chip: the mask is stored and applied
        by :meth:`state`.  Only chip 0 exists, so a ``replicas`` without it
        is a no-op; drift has no digital analogue."""
        if fcfg is None or fcfg.is_nominal:
            return self
        if replicas is not None and 0 not in list(replicas):
            return self
        mask = var.sample_fault_mask(generator, self.ta_state.shape, fcfg,
                                     self.device)
        return dataclasses.replace(
            self, fault_mask=var.merge_fault_masks(mask, self.fault_mask))

    def repair_replica(self, i: int,
                       generator: Optional[torch.Generator] = None
                       ) -> "CoalescedPool":
        """Chip ``i`` (== 0) repaired: the stored mask is cleared and the
        clean TA plane serves again (``generator`` is unused: digital
        re-programming draws nothing)."""
        del generator
        if not 0 <= i < self.n_replicas:
            raise IndexError(f"replica {i} out of range "
                             f"[0, {self.n_replicas})")
        return dataclasses.replace(self, fault_mask=None)


def program_replica_pool(
    include: torch.Tensor,           # [C, L] bool include mask
    generator: Optional[torch.Generator],
    n_replicas: int,
    vcfg: var.VariationConfig = var.VariationConfig(),
    icfg: IMBUEConfig = IMBUEConfig(),
) -> ReplicaPool:
    """Program ``n_replicas`` chips (independent D2D draws per chip) on
    ``include``'s device."""
    include = include.to(torch.bool)
    r_stack = program_replica_stack(include, generator, n_replicas, vcfg)
    return ReplicaPool(r_stack=r_stack, include=include, icfg=icfg,
                       vcfg=vcfg)


def ensemble_vote(sums: torch.Tensor, mode: str = "majority",
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Combine per-replica class sums ``[R, B, M]`` into predictions
    ``[B]``.

    ``majority`` — one vote per chip (its argmax), ties toward the lowest
    class index; ``sum`` — pool the class sums before the argmax.
    ``mask`` (``[R]`` bool) zeroes quarantined chips out of the vote; all
    True is identical to no mask.
    """
    with span("repro_torch.serve.ensemble_vote"):
        if mode == "sum":
            if mask is not None:
                sums = torch.where(mask[:, None, None], sums, 0)
            return torch.argmax(sums.sum(dim=0), dim=-1)
        if mode != "majority":
            raise ValueError(f"unknown ensemble mode {mode!r}")
        m = sums.shape[-1]
        per_chip = torch.argmax(sums, dim=-1)                   # [R, B]
        votes = torch.nn.functional.one_hot(per_chip, m)        # [R, B, M]
        if mask is not None:
            votes = votes * mask[:, None, None].to(votes.dtype)
        return torch.argmax(votes.sum(dim=0), dim=-1)
