"""Replica pool: R independently programmed crossbars behind one TM (port
of ``repro.serve.replica``).

* ``ReplicaPool`` — frozen device state: the programmed ``[R, C, L]``
  resistances, the shared include plane, the static configs and the
  model ``version``.
* ``RouterState`` — mutable host-side routing counters (round-robin
  cursor, per-replica load, quarantined chips), kept out of the pool.
* ``ensemble_vote`` — majority (or summed) vote over per-replica class
  sums, masked to the healthy chips;
* ``CoalescedPool`` — ONE shared coalesced clause pool (``n_replicas ==
  1``) behind the same engine surface.

Sharding, re-programming, fault injection and repair come with later
slices.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Set

import torch

from repro_torch.api.states import CoalescedState, ReplicaStackState
from repro_torch.core import variations as var
from repro_torch.core.coalesced import CoalescedConfig
from repro_torch.core.imbue import IMBUEConfig, program_replica_stack
from repro_torch.core.tm import TMConfig


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


@dataclasses.dataclass(frozen=True)
class ReplicaPool:
    """R programmed crossbars sharing one set of TA actions."""

    r_stack: torch.Tensor           # [R, C, L] programmed resistances (Ω)
    include: torch.Tensor           # [C, L] bool TA actions
    icfg: IMBUEConfig
    vcfg: var.VariationConfig
    version: int = 0                # monotonic model generation

    @property
    def device(self) -> torch.device:
        return self.r_stack.device

    @property
    def n_replicas(self) -> int:
        return int(self.r_stack.shape[0])

    def to(self, device) -> "ReplicaPool":
        """This pool with its tensors on ``device``."""
        return dataclasses.replace(self, r_stack=self.r_stack.to(device),
                                   include=self.include.to(device))

    def state(self, tm_cfg: TMConfig) -> ReplicaStackState:
        """The pool as a backend ``ReplicaStackState``."""
        return ReplicaStackState(r_stack=self.r_stack, include=self.include,
                                 tm_cfg=tm_cfg, icfg=self.icfg,
                                 vcfg=self.vcfg)

    def router(self) -> RouterState:
        """A fresh routing-counter block sized for this pool."""
        return RouterState.create(self.n_replicas)


@dataclasses.dataclass(frozen=True)
class CoalescedPool:
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

    ta_state: torch.Tensor          # [C, L] trained TA states
    weights: torch.Tensor           # [C, M] per-(clause, class) weights
    cfg: CoalescedConfig
    version: int = 0                # monotonic model generation

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
        return dataclasses.replace(self, ta_state=self.ta_state.to(device),
                                   weights=self.weights.to(device))

    def state(self, cfg: Optional[CoalescedConfig] = None) -> CoalescedState:
        """The pool as a backend ``CoalescedState``; ``cfg``, if given,
        must be the pool's own."""
        if cfg is not None and cfg != self.cfg:
            raise ValueError("CoalescedPool.state(cfg) must match the "
                             "pool's own CoalescedConfig")
        return CoalescedState(ta_state=self.ta_state, weights=self.weights,
                              cfg=self.cfg)

    def router(self) -> RouterState:
        return RouterState.create(self.n_replicas)


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
    if mode == "sum":
        if mask is not None:
            sums = torch.where(mask[:, None, None], sums, 0)
        return torch.argmax(sums.sum(dim=0), dim=-1)
    if mode != "majority":
        raise ValueError(f"unknown ensemble mode {mode!r}")
    m = sums.shape[-1]
    per_chip = torch.argmax(sums, dim=-1)                       # [R, B]
    votes = torch.nn.functional.one_hot(per_chip, m)            # [R, B, M]
    if mask is not None:
        votes = votes * mask[:, None, None].to(votes.dtype)
    return torch.argmax(votes.sum(dim=0), dim=-1)
