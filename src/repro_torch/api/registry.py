"""Capability-based backend registry (port of ``repro.api.registry``).

Every backend implements ONE signature

    class_sums(state, lits, generator=None) -> int32 [..., M]

and declares which state types it accepts and which capabilities it
models.  :func:`select_backend` matches the capabilities a state needs
against what each backend provides; when a preferred backend cannot
serve, the choice falls back to the best one that can and
``Selection.fallback_reason`` says why — callers surface it, never hide
it.  Kernel tiles are module defaults in this slice: there is no tuning
table yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple, Type

from repro_torch.api.states import (CoalescedState, CrossbarState,
                                     DigitalState, ReplicaStackState)

CAP_DIGITAL = "digital"                     # Boolean-domain evaluation
CAP_ANALOG = "analog"                       # current-domain crossbar model
CAP_FUSED_KERNEL = "fused_kernel"           # one hand-written kernel launch
CAP_MODELS_C2C = "models_c2c"               # cycle-to-cycle R excursions
CAP_MODELS_CSA_OFFSET = "models_csa_offset"  # per-column CSA input offset
CAP_REPLICA_VMAP = "supports_replica_vmap"  # [R, C, L] in one dispatch
CAP_COALESCED = "coalesced_weights"         # weighted digital tail
CAP_PACKED_IO = "packed_io"                 # int32 bitplane literal wire
CAP_PACKED_PLANES = "packed_planes"         # resident index+dev plane format

KNOWN_CAPABILITIES = frozenset({
    CAP_DIGITAL, CAP_ANALOG, CAP_FUSED_KERNEL, CAP_MODELS_C2C,
    CAP_MODELS_CSA_OFFSET, CAP_REPLICA_VMAP, CAP_COALESCED, CAP_PACKED_IO,
    CAP_PACKED_PLANES,
})


@dataclasses.dataclass(frozen=True)
class Backend:
    """One registered forward implementation."""

    name: str
    fn: Callable                            # class_sums(state, lits, gen)
    state_types: Tuple[Type, ...]
    capabilities: FrozenSet[str]
    priority: int = 0                       # higher wins among candidates
    doc: str = ""
    predicate: Optional[Callable] = None    # extra acceptance check

    def accepts(self, state) -> bool:
        if not isinstance(state, self.state_types):
            return False
        return self.predicate is None or bool(self.predicate(state))

    def provides(self, caps) -> bool:
        return frozenset(caps) <= self.capabilities


@dataclasses.dataclass(frozen=True)
class Selection:
    """Outcome of one capability-based backend choice."""

    backend: Backend
    required: FrozenSet[str]
    preferred: Optional[str] = None
    fallback_reason: Optional[str] = None   # set iff preference overridden

    @property
    def fell_back(self) -> bool:
        return self.fallback_reason is not None


_REGISTRY: Dict[str, Backend] = {}


def register_backend(name: str, *, state_types, capabilities,
                     priority: int = 0, doc: str = "", predicate=None):
    """Decorator: register ``fn`` as backend ``name``."""
    unknown = frozenset(capabilities) - KNOWN_CAPABILITIES
    if unknown:
        raise ValueError(f"unknown capabilities {sorted(unknown)}; extend "
                         "KNOWN_CAPABILITIES to add vocabulary")

    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"backend {name!r} already registered")
        first_line = (fn.__doc__ or "").strip().splitlines()
        _REGISTRY[name] = Backend(
            name=name, fn=fn, state_types=tuple(state_types),
            capabilities=frozenset(capabilities), priority=priority,
            doc=doc or (first_line[0] if first_line else ""),
            predicate=predicate)
        return fn

    return deco


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def list_backends() -> List[Backend]:
    return sorted(_REGISTRY.values(), key=lambda b: b.name)


def required_capabilities(state, generator=None) -> FrozenSet[str]:
    """The capability floor implied by ``state`` (and a noise generator).

    A replica stack needs single-dispatch replica support; an analog state
    read noisily against a ``VariationConfig`` with ``csa_offset`` needs a
    backend that models the per-column CSA offset — the kernels threshold
    against one scalar reference and do NOT — and one with ``c2c`` needs
    C2C.  A coalesced pool needs the weighted digital tail.
    """
    noisy = generator is not None
    need = set()
    if isinstance(state, ReplicaStackState):
        need.add(CAP_REPLICA_VMAP)
    if isinstance(state, (CrossbarState, ReplicaStackState)):
        need.add(CAP_ANALOG)
        if noisy and state.vcfg.csa_offset:
            need.add(CAP_MODELS_CSA_OFFSET)
        if noisy and state.vcfg.c2c:
            need.add(CAP_MODELS_C2C)
    if isinstance(state, DigitalState):
        need.add(CAP_DIGITAL)
    if isinstance(state, CoalescedState):
        need.update((CAP_DIGITAL, CAP_COALESCED))
    return frozenset(need)


def _candidates(state, need) -> List[Backend]:
    cands = [b for b in _REGISTRY.values()
             if b.accepts(state) and b.provides(need)]
    return sorted(cands, key=lambda b: (-b.priority, b.name))


def select_backend(state, *, generator=None, prefer: Optional[str] = None,
                   require=()) -> Selection:
    """Pick the backend for ``state`` by explicit capability matching.

    ``prefer`` names a backend to use *if it satisfies* the required set;
    otherwise the highest-priority satisfying backend is chosen and
    ``Selection.fallback_reason`` records which capabilities forced it.
    """
    need = (frozenset(required_capabilities(state, generator))
            | frozenset(require))
    cands = _candidates(state, need)
    if not cands:
        raise ValueError(
            f"no registered backend accepts {type(state).__name__} with "
            f"capabilities {sorted(need)}; registered: "
            f"{[(b.name, sorted(b.capabilities)) for b in list_backends()]}")
    if prefer is not None:
        pref = get_backend(prefer)
        if not pref.accepts(state):
            reason = f"{prefer} does not accept {type(state).__name__}"
        elif not pref.provides(need):
            reason = f"{prefer} lacks {sorted(need - pref.capabilities)}"
        else:
            return Selection(backend=pref, required=need, preferred=prefer)
        return Selection(backend=cands[0], required=need, preferred=prefer,
                         fallback_reason=f"{reason}; selected "
                                         f"{cands[0].name}")
    return Selection(backend=cands[0], required=need)
