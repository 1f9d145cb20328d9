"""Capability-based backend registry (port of ``repro.api.registry``).

Every backend implements ONE signature

    class_sums(state, lits, generator=None) -> int32 [..., M]

and declares which state types it accepts and which capabilities it
models.  :func:`select_backend` matches the capabilities a state needs
against what each backend provides; when a preferred backend cannot
serve, the choice falls back to the best one that can and
``Selection.fallback_reason`` says why — callers surface it, never hide
it.

The registry also holds the measured per-``(backend, shape bucket)``
tuning table (kernel tiles and a batch-bucket ladder; the lower half of
this module): ``kernels/autotune.py`` measures it on the card and a
committed table (``kernels/tuning_table.json``) is loaded at the first
lookup.  An entry is applied only on the device it was measured on
(:func:`get_tuning`).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple, Type

import torch

from repro_torch._device import DeviceLike, resolve_device

from repro_torch.api.states import (CoalescedState, CrossbarState,
                                     DigitalState, ReplicaStackState)
from repro_torch.distributed.sharding import tree_is_sharded

CAP_DIGITAL = "digital"                     # Boolean-domain evaluation
CAP_ANALOG = "analog"                       # current-domain crossbar model
CAP_FUSED_KERNEL = "fused_kernel"           # one hand-written kernel launch
CAP_MODELS_C2C = "models_c2c"               # cycle-to-cycle R excursions
CAP_MODELS_CSA_OFFSET = "models_csa_offset"  # per-column CSA input offset
CAP_REPLICA_VMAP = "supports_replica_vmap"  # [R, C, L] in one dispatch
CAP_COALESCED = "coalesced_weights"         # weighted digital tail
CAP_PACKED_IO = "packed_io"                 # int32 bitplane literal wire
CAP_SHARDED = "sharded_dispatch"            # reads a state split over a mesh
CAP_PACKED_PLANES = "packed_planes"         # resident index+dev plane format

KNOWN_CAPABILITIES = frozenset({
    CAP_DIGITAL, CAP_ANALOG, CAP_FUSED_KERNEL, CAP_MODELS_C2C,
    CAP_MODELS_CSA_OFFSET, CAP_REPLICA_VMAP, CAP_COALESCED, CAP_PACKED_IO,
    CAP_SHARDED, CAP_PACKED_PLANES,
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
    C2C.  A coalesced pool needs the weighted digital tail.  A state
    partitioned across ranks (``state.shard(mesh)``) needs a backend that
    reads it block by block (every registered one does: a kernel launch
    on the rank's own block, ``api.backends``).
    """
    noisy = generator is not None
    need = set()
    if tree_is_sharded(state):
        need.add(CAP_SHARDED)
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


# ---------------------------------------------------------------------------
# Per-(backend, shape bucket) tuning tables (measured autotuning)
# ---------------------------------------------------------------------------
#
# ``kernels/autotune.py`` times tile candidates (each kernel's launch
# geometry override, ``{"ks", "ng"}`` analog, ``{"wm", "wn"}`` TM, or
# "auto", the kernel's own choice) and batch buckets against each fused
# backend and registers the result here.  Consumers (``ServeEngine``,
# ``BatcherConfig.for_max_batch``) read the table instead of hard-coding
# tiles or buckets.  A committed default table
# (``repro_torch/kernels/tuning_table.json``, regenerated on the card by
# ``benchmarks/kernel_bench_torch.py``) is loaded lazily at the first
# lookup.
#
# Entries are keyed by (backend name, shape bucket): ``shape_bucket_key``
# rounds (n_clauses, n_literals) up to powers of two ("c64-l1024"), so
# near-identical shapes share an entry and other workloads get their own,
# measured once on first sight when the engine opts in
# (``EngineConfig.lazy_tune`` -> ``kernels.autotune.ensure_tuning``).
#
# Entry schema (plain JSON-shaped dict):
#   {"tiles": {"ks": int, "ng": int} | {"wm": int, "wn": int} | {},
#    "bucket_sizes": [int, ...],              # measured-good batch buckets
#    "bucket_latency_us": {"8": float, ...},  # evidence, summed over
#    "bucket_latency_by_state": {state: {"8": float, ...}},  # the served
#    "tile_latency_us": {"ks4-ng2": float, ..., "auto": float},  # states
#    "tile_latency_by_state": {state: {"ks4-ng2": float, ...}},
#    "tile_margin": float,                    # an override's least win
#    "tile_geometry": {...},                  # what the tiles launch
#    "shape": {...},                          # exact workload measured
#    "platform": "cuda" | "cpu",              # withholding guard, with
#    "device_name": str,                      # the device's name
#    "power_limit_w": float | None, "torch": str,
#    "tile_estimator": str, "bucket_estimator": str,
#    "lazy": bool}                            # measured on first sight?

# The serve-bench reference bucket: TMConfig(4 classes x 8 clauses,
# 64 features) -> C = 32, L = 128.  Lookups without a shape key and
# entries without shape information land here.
REF_SHAPE_KEY = "c32-l128"

_TUNING: Dict[str, Dict[str, dict]] = {}      # name -> shape_key -> entry
_TUNING_DEFAULTS_LOADED = False


def _pow2ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def shape_bucket_key(n_clauses: int, n_literals: int) -> str:
    """The tuning-table shape bucket for a ``[C, L]`` model: both dims
    rounded up to the next power of two (``"c64-l1024"``)."""
    return f"c{_pow2ceil(n_clauses)}-l{_pow2ceil(n_literals)}"


def shape_key_of(shape: dict) -> str:
    """Bucket key of an entry's recorded ``shape`` dict.

    Per-class shapes carry ``{"n_classes", "clauses_per_class",
    "n_features"}``; coalesced shapes carry the total pool directly as
    ``"n_clauses"``."""
    n_clauses = shape.get("n_clauses")
    if n_clauses is None:
        n_clauses = shape["n_classes"] * shape["clauses_per_class"]
    return shape_bucket_key(n_clauses, 2 * shape["n_features"])


def device_signature(device: DeviceLike = None) -> Tuple[str, str]:
    """``(platform, device_name)`` of ``device`` as tuning entries record
    them: ``("cuda", torch.cuda.get_device_name(device))`` for a card,
    ``("cpu", "cpu")`` for the host (``None`` is the CUDA card and raises
    without one)."""
    device = resolve_device(device)
    if device.type == "cuda":
        return "cuda", torch.cuda.get_device_name(device)
    return device.type, device.type


def register_tuning(name: str, entry: dict,
                    shape_key: Optional[str] = None) -> None:
    """Install (or overwrite) the measured entry for ``(backend, shape
    bucket)``.  ``shape_key`` defaults to the bucket of the entry's own
    recorded ``shape`` (or :data:`REF_SHAPE_KEY` for a shapeless
    entry)."""
    _load_tuning_defaults()        # an early register must not shadow the
    if shape_key is None:          # committed entries of OTHER buckets
        shape_key = (shape_key_of(entry["shape"]) if entry.get("shape")
                     else REF_SHAPE_KEY)
    _TUNING.setdefault(name, {})[shape_key] = dict(entry)


def get_tuning(name: str, shape_key: Optional[str] = None,
               device: DeviceLike = None) -> Optional[dict]:
    """The measured entry for ``(backend, shape bucket)`` that applies on
    ``device`` (the device the caller serves on; ``None`` is the CUDA
    card), or None.

    ``shape_key`` is a :func:`shape_bucket_key` string; None means the
    serve-bench reference bucket (:data:`REF_SHAPE_KEY`).  The committed
    table is loaded at the first lookup.

    Two withholding rules: a near-miss entry falls back to the kernels'
    own geometry and the static ladder, never applies quietly.

    * Another **shape bucket** is another key, so tiles measured in one
      bucket are never handed to a model of another.  Within a bucket
      the models differ, so a caller checks the entry's tiles against its
      own model before it launches them (``kernels.autotune.tiles_fit``,
      as the engine does).
    * An entry whose recorded ``(platform, device_name)`` is not
      :func:`device_signature` of ``device`` is withheld, and so is one
      that records no pair: tiles measured on an H100 apply only on an
      H100, never on another card or on the host, and nothing measured
      on the host reaches a card (re-run
      ``benchmarks/kernel_bench_torch.py`` on the target to tune it).
    """
    signature = device_signature(device)
    if name not in _TUNING:
        _load_tuning_defaults()
    entry = _TUNING.get(name, {}).get(shape_key or REF_SHAPE_KEY)
    if entry is None or (entry.get("platform"),
                         entry.get("device_name")) != signature:
        return None
    return entry


def tuning_snapshot() -> Dict[str, Dict[str, dict]]:
    """A deep copy of the whole loaded table (defaults included): pair
    with :func:`restore_tuning` around code that mutates it (benchmarks,
    tests).  Deep, so that in-place edits of an entry's nested values
    cannot leak through a restore."""
    _load_tuning_defaults()
    return {name: {k: copy.deepcopy(e) for k, e in shapes.items()}
            for name, shapes in _TUNING.items()}


def restore_tuning(snapshot: Dict[str, Dict[str, dict]]) -> None:
    """Replace the table with a :func:`tuning_snapshot` copy."""
    global _TUNING_DEFAULTS_LOADED
    _TUNING_DEFAULTS_LOADED = True            # the snapshot folded them in
    _TUNING.clear()
    for name, shapes in snapshot.items():
        for k, e in shapes.items():
            _TUNING.setdefault(name, {})[k] = copy.deepcopy(e)


def _load_tuning_defaults() -> None:
    global _TUNING_DEFAULTS_LOADED
    if _TUNING_DEFAULTS_LOADED:
        return
    _TUNING_DEFAULTS_LOADED = True
    # Imported here: autotune imports this package.  normalize_table is
    # the one reader of both table schemas (save_table uses it too).
    from repro_torch.kernels.autotune import (load_default_table,
                                              normalize_table)
    for bname, shapes in normalize_table(load_default_table()).items():
        for skey, entry in shapes.items():
            _TUNING.setdefault(bname, {}).setdefault(skey, entry)


def clear_tuning(name: Optional[str] = None) -> None:
    """Drop one backend's (or every) tuning entry.

    Clearing everything empties the table for good (no later lazy load
    brings it back); clearing one name loads the committed defaults for
    the other backends first, then drops every shape bucket of that
    backend."""
    global _TUNING_DEFAULTS_LOADED
    if name is None:
        _TUNING_DEFAULTS_LOADED = True
        _TUNING.clear()
    else:
        _load_tuning_defaults()
        _TUNING.pop(name, None)
