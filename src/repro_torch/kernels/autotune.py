"""Measured per-backend kernel autotuning on the card (port of
``repro.kernels.autotune``).

The port's fused kernels pick their launch geometry with one fixed rule
each (``imbue::choose`` for the three analog kernels, ``tmb::choose`` for
``tm_infer_planes`` / ``tm_infer_packed``, ``tm_infer``'s own), and the
batcher cuts batches to a static bucket ladder.  Both are measurements in
disguise: the right geometry depends on the model's (C, L) and on the
card, and the right ladder on how a dispatch's cost scales with the
batch.  This module measures both, per fused backend and model shape,
and registers the result in the capability registry
(``repro_torch.api.register_tuning`` / ``get_tuning``), with a committed
table next to this file (``tuning_table.json``, regenerated on the card
by ``python -m benchmarks.kernel_bench_torch``).

**The tiles are each kernel's geometry override**: ``{"ks", "ng"}``
(column splits, 32-row groups a block) for the analog kernels,
``{"wm", "wn"}`` (warp tiles a block) for the TM ones; the candidate
``"auto"`` is the kernel's own choice (no override, ``tiles == {}``),
which an entry keeps unless a tile wins clearly (below).

**Shape-aware**: entries are keyed by ``(backend, shape bucket)``
(``api.shape_bucket_key``: (C, L) rounded up to powers of two).  Any shape
without an entry runs on the kernels' own geometry and the static ladder,
or, when the engine opts in (``EngineConfig.lazy_tune``), is measured ONCE
on first sight by :func:`ensure_tuning` with a small sweep and then reused
by every later engine at the same bucket.

**Device-bound**: every entry records the platform and device name it was
measured on (and the card's power limit and the torch version), and
``api.get_tuning`` applies it only on a device with the same pair: the
committed H100 table never reaches the CPU or another card.

**Measured on the states the engine serves**: the engine routes one chip
(``[1, C, L]``) or reads the whole replica stack (ensemble routing, the
stream server), on a nominal pool or on one programmed with
device-to-device variation (a deviation plane).  Both sweeps run on the
two ends of that range for the analog backends, one nominal chip and a
stack of ``SERVED_REPLICAS`` D2D chips (``ANALOG_STATES``); the TM
kernels have neither a replica axis nor a plane (``TM_STATES``).  A tile
override is committed only where it beats ``"auto"`` by more than
``TILE_MARGIN`` in every served state (:func:`pick_tiles`), so a pick
inside the noise, or one that wins on one state and loses on another,
leaves the kernel's own geometry in place.  The ladder is the union of
the states' pruned ladders: a bucket stays where any served state pays
for padding past it.

Two clocks, recorded in each entry:

* the **tile sweep** reads the device time of one backend call by CUDA
  events, the median of at least ``TILE_REPS_MIN`` calls, each enqueued
  behind a spin kernel with L2 flushed first, so that the events time the
  device work alone on cold operands, as ``chip_smoke.py`` times the
  kernels (the TM kernels take ~0.011 ms and move ~0.001 ms between
  processes: a host clock would pick noise); the reps are taken in turns
  over the candidates, so that clock drift moves them alike;
* the **bucket sweep** reads the wall time of one whole backend call
  ending in ``torch.cuda.synchronize()``, the minimum of the reps (taken
  in turns over the buckets), as the reference does: the ladder decides
  what a dispatch costs, and the host dominates that cost.

On the host (``device="cpu"``, the tests) the plain versions ignore the
tiles, so there is no tile sweep (``tiles`` is ``{}``) and the bucket
sweep reads the wall clock, the minimum of the reps.

Unlike the reference, the measured model is a numpy prototype model
whose clauses fire (as ``chip_smoke.py``'s serving models), not 10 %
dense random includes: the analog kernels' early exit makes their cost
depend on the drawn values, and under random includes every row dies in
the first column.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

DEFAULT_TABLE_PATH = os.path.join(os.path.dirname(__file__),
                                  "tuning_table.json")

# The serve-bench reference workload (the reference's REF_SHAPE).
REF_SHAPE = {"n_classes": 4, "clauses_per_class": 8, "n_features": 64}

# The reference's KWS-6 streaming workload: 6 keywords, a window of 8
# frames x 12 mel bins x 4 thermometer bits = 384 Boolean features,
# C = 60.  Its own shape bucket, so it gets its own measured tiles.
KWS_SHAPE = {"n_classes": 6, "clauses_per_class": 10, "n_features": 384}

# Candidate grids, 3 x 3 each like the reference's (ct, kt) grid, plus
# "auto" (the kernel's own geometry).  Analog: ng 32-row groups x ks
# column splits a block (ks past the model's ceil(L / 32) columns is
# skipped); TM: wm x wn warp tiles a block.
ANALOG_GRID = {"ng": (1, 2, 4), "ks": (2, 4, 8)}
TM_GRID = {"wm": (1, 2, 4), "wn": (1, 2, 4)}
BUCKET_CANDIDATES = (8, 16, 24, 32, 48, 64, 96, 128)
SMOKE_ANALOG = {"ng": (1, 4), "ks": (2, 8)}
SMOKE_TM = {"wm": (1, 4), "wn": (1, 4)}
SMOKE_BUCKETS = (8, 64)
# Lazy first-sight measurement (ensure_tuning): small on purpose, since an
# engine construction pays it once per (backend, shape bucket) per
# process.  Still measured, never guessed.
LAZY_ANALOG = {"ng": (1, 4), "ks": (2, 8)}
LAZY_TM = {"wm": (1, 2), "wn": (1, 4)}
LAZY_BUCKETS = (8, 32, 128)
LAZY_REPS = 2

AUTO = "auto"                  # the tile candidate without an override
TILE_REPS_MIN = 25             # device-time samples a tile candidate
SPIN_CYCLES = 2_000_000        # the spin kernel ahead of a timed call
FLUSH_BYTES = 256 * 2 ** 20    # zeroed before a timed call: > 50 MB of L2

# The served states both sweeps measure, (label, replicas, D2D plane).
# Analog: one nominal chip (routed dispatches) and a stack of
# SERVED_REPLICAS D2D-programmed chips (ensemble routing and the stream
# server, as chip_smoke.py serves them).  TM: no replica axis, no plane.
SERVED_REPLICAS = 4
ANALOG_STATES = (("r1-nominal", 1, False),
                 (f"r{SERVED_REPLICAS}-d2d", SERVED_REPLICAS, True))
TM_STATES = (("tm", 1, False),)

# An override must beat "auto" by more than this share in every served
# state to be committed.  The TM kernels' device time moves by up to
# 0.0013 of 0.011 ms between processes (PERF.md section 7), and a pick
# inside that spread is noise that would override the kernel's own rule.
TILE_MARGIN = 0.10

# Keep a smaller bucket in the ladder only if it is meaningfully cheaper
# than padding up to the next kept bucket; when a dispatch's cost is flat
# in the batch, the ladder collapses.
LADDER_KEEP_RATIO = 0.85

# The kernel behind each fused backend (for the winner's geometry).
KERNEL_OF = {
    "analog-cuda-packed2": "imbue_infer_planes",
    "analog-cuda-packed": "imbue_infer_packed",
    "analog-cuda": "imbue_infer",
    "digital-cuda-packed": "tm_infer_packed",
    "coalesced-cuda-packed": "tm_infer_packed",
    "coalesced-cuda-packed2": "tm_infer_planes",
    "digital-cuda": "tm_infer",
    "coalesced-cuda": "tm_infer",
}

Grid = Dict[str, Sequence[int]]


def _tunable_backends():
    """Registered backends that take kernel tile options."""
    from repro_torch import api
    return [b for b in api.list_backends()
            if api.CAP_FUSED_KERNEL in b.capabilities]


def is_analog(backend) -> bool:
    """Whether ``backend`` runs an analog kernel (``{"ks", "ng"}`` tiles)
    rather than a TM one (``{"wm", "wn"}``)."""
    from repro_torch import api
    return api.CoalescedState not in backend.state_types and \
        api.DigitalState not in backend.state_types


def tile_key(tiles: Optional[dict]) -> str:
    """``"auto"`` for no override, else ``"ks4-ng2"`` / ``"wm1-wn4"``."""
    if not tiles:
        return AUTO
    return "-".join(f"{k}{int(v)}" for k, v in sorted(tiles.items()))


def parse_tile_key(key: str) -> dict:
    """Inverse of :func:`tile_key`."""
    if key == AUTO:
        return {}
    return {part[:2]: int(part[2:]) for part in key.split("-")}


def grid_tiles(grid: Grid) -> List[dict]:
    """``{}`` ("auto") and every tile of ``grid``."""
    names = sorted(grid)
    return [{}] + [dict(zip(names, vals))
                   for vals in itertools.product(*(grid[n] for n in names))]


def tiles_fit(tiles: Optional[dict], n_literals: int) -> bool:
    """Whether an override can launch on a model of ``n_literals``
    literals: an analog ks at most its ``ceil(L / 32)`` columns, the one
    bound of a tile that depends on the model (TM tiles fit any shape).
    An entry covers a shape bucket, so a caller checks its tiles against
    its own model before it launches them."""
    return (tiles or {}).get("ks", 0) <= -(-n_literals // 32)


def tile_candidates(backend, shape: Dict[str, int],
                    grid: Optional[Grid] = None) -> List[dict]:
    """``{}`` ("auto") and every tile of ``grid`` (the backend family's
    full grid by default) that fits ``shape`` (:func:`tiles_fit`)."""
    grid = grid or (ANALOG_GRID if is_analog(backend) else TM_GRID)
    return [t for t in grid_tiles(grid)
            if tiles_fit(t, 2 * shape["n_features"])]


def served_states(backend) -> Tuple[Tuple[str, int, bool], ...]:
    """The ``(label, replicas, D2D plane)`` states both sweeps measure
    ``backend`` on."""
    return ANALOG_STATES if is_analog(backend) else TM_STATES


def _n_clauses(shape: Dict[str, int]) -> int:
    n = shape.get("n_clauses")
    return n if n is not None else (shape["n_classes"]
                                    * shape["clauses_per_class"])


def _prototype_model(shape: Dict[str, int], n_rows: int, per_class: bool,
                     rng: np.random.Generator):
    """Include plane ``[C, 2F]`` and ``n_rows`` requests ``[n_rows, F]``
    of a prototype model: clause c belongs to class ``c // per class`` (a
    per-class TM) or ``c % M`` (a coalesced pool) and includes 8-16
    literals that are 1 on its class's prototype; a request is a class
    prototype with 8 % of its bits flipped."""
    m, f, c = shape["n_classes"], shape["n_features"], _n_clauses(shape)
    protos = (rng.random((m, f)) < 0.5).astype(np.uint8)
    proto_lits = np.concatenate([protos, 1 - protos], axis=1)
    own = (np.arange(c) // shape["clauses_per_class"] if per_class
           else np.arange(c) % m)
    include = np.zeros((c, 2 * f), bool)
    for i in range(c):
        ones = np.flatnonzero(proto_lits[own[i]])
        k = int(rng.integers(8, 17))
        include[i, rng.choice(ones, size=min(k, ones.size),
                              replace=False)] = True
    y = rng.integers(0, m, n_rows)
    x = protos[y] ^ (rng.random((n_rows, f)) < 0.08).astype(np.uint8)
    return include, x


def _reference_state(backend, shape: Dict[str, int], device: torch.device,
                     n_rows: int = max(BUCKET_CANDIDATES),
                     replicas: int = 1, d2d: bool = False):
    """A synthetic state and a literal operand of ``n_rows`` rows for
    ``backend`` at ``shape``, on ``device`` (numpy draws from one seed):
    an analog stack of ``replicas`` chips, nominal or D2D-programmed
    (``d2d``: a deviation plane); a TM state ignores both."""
    from repro_torch import api
    from repro_torch.core import tm
    from repro_torch.core.coalesced import CoalescedConfig
    from repro_torch.core.variations import VariationConfig
    from repro_torch.kernels import ops

    rng = np.random.default_rng(20260801)
    if api.CoalescedState in backend.state_types:
        # Coalesced pools are keyed by the TOTAL clause count; a per-class
        # shape is flattened into one shared pool of the same size.
        ccfg = CoalescedConfig(n_classes=shape["n_classes"],
                               n_clauses=_n_clauses(shape),
                               n_features=shape["n_features"], n_states=100)
        include, x = _prototype_model(shape, n_rows, False, rng)
        ta = np.where(include, ccfg.n_states + 1, ccfg.n_states)
        w = rng.integers(-ccfg.max_weight, ccfg.max_weight + 1,
                         (ccfg.n_clauses, ccfg.n_classes))
        state = api.CoalescedState(
            ta_state=torch.from_numpy(ta.astype(np.int16)).to(device),
            weights=torch.from_numpy(w.astype(np.int32)).to(device),
            cfg=ccfg)
    else:
        if "clauses_per_class" not in shape:
            raise ValueError(f"{backend.name} needs a per-class shape, got "
                             f"{shape}")
        cfg = tm.TMConfig(n_states=100, **shape)
        include, x = _prototype_model(shape, n_rows, True, rng)
        inc = torch.from_numpy(include).to(device)
        if api.DigitalState in backend.state_types:
            state = api.DigitalState.from_include(inc, cfg)
        else:
            gen = torch.Generator(device=device).manual_seed(20260801)
            vcfg = (VariationConfig(c2c=False, csa_offset=False) if d2d
                    else VariationConfig.nominal())
            state = api.ReplicaStackState.program(inc, gen, replicas, cfg,
                                                  vcfg)
    if api.CAP_PACKED_IO in backend.capabilities:
        state = state.pack()
    if api.CAP_PACKED_PLANES in backend.capabilities:
        state = state.pack_planes()
    lits = tm.literals(torch.from_numpy(x).to(device))
    if api.CAP_PACKED_IO in backend.capabilities:
        lits = ops.pack_literals(lits)
    return state, lits.contiguous()


def _host_times_us(fns: Dict[int, Callable], reps: int,
                   sync: bool) -> Dict[int, float]:
    """Min-of-reps wall time in microseconds of each of ``fns`` (after
    one warm-up), each call ended by ``torch.cuda.synchronize()`` when
    ``sync``.  The minimum is the latency estimator on a shared host:
    every positive excursion is scheduler interference.  The reps are
    taken in turns (one call of each a round), so that a slow spell of the
    host slows every bucket alike instead of one bucket's whole run."""
    for fn in fns.values():
        fn()
    if sync:
        torch.cuda.synchronize()
    best = {key: float("inf") for key in fns}
    for _ in range(max(1, reps)):
        for key, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            if sync:
                torch.cuda.synchronize()
            best[key] = min(best[key], time.perf_counter() - t0)
    return {key: t * 1e6 for key, t in best.items()}


def _device_times_us(fns: Dict[str, Callable], reps: int,
                     flush: Optional[torch.Tensor] = None
                     ) -> Dict[str, float]:
    """Median device time in microseconds of each of ``fns``' work over
    ``reps`` calls: CUDA events around each call, enqueued behind a spin
    kernel (about 1 ms) so that the events time the device work alone;
    ``flush`` (a buffer past the L2's size) is zeroed before each call.
    The reps are taken in turns (one call of each a round), so that the
    card's clocks drifting during the sweep move every candidate alike."""
    for fn in fns.values():
        fn()
    times: Dict[str, List[float]] = {key: [] for key in fns}
    for _ in range(reps):
        for key, fn in fns.items():
            if flush is not None:
                flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[key].append(start.elapsed_time(end) * 1e3)
    return {key: statistics.median(t) for key, t in times.items()}


def power_limit_w(device: torch.device) -> Optional[float]:
    """The card's power limit in W from ``nvidia-smi``, or None where there
    is no ``nvidia-smi`` or no card (the host)."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            check=True, capture_output=True, text=True, timeout=60).stdout
        return float(out.strip().splitlines()[device.index or 0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _tile_geometry(backend, label: str, replicas: int, state, n_rows: int,
                   tiles: dict, device: torch.device) -> Optional[dict]:
    """The committed tiles' launch in served state ``label`` as the
    kernel's ``<name>_geometry`` reports it (None on the host)."""
    if device.type != "cuda":
        return None
    from repro_torch.kernels import clause_eval, imbue_infer
    name = KERNEL_OF[backend.name]
    if name.startswith("imbue"):
        c, l = state.include.shape
        has_dev = getattr(state, "plane_dev", None) is not None
        return {"kernel": name, "state": label,
                **imbue_infer.launch_geometry(name, replicas, n_rows, c, l,
                                              has_dev, tiles)}
    c, l = state.include.shape
    m = state.combine.shape[1]
    k = l if name == "tm_infer" else -(-l // 32)
    return {"kernel": name, "state": label, **clause_eval.launch_geometry(
        name, n_rows, c, k, m, tiles)}


def prune_bucket_ladder(latency_us: Dict[int, float],
                        keep_ratio: float = LADDER_KEEP_RATIO
                        ) -> Tuple[int, ...]:
    """Measured ladder: walk down from the largest bucket, keeping a
    smaller one only when it is ``keep_ratio`` cheaper than the bucket it
    would otherwise pad up to."""
    sizes = sorted(latency_us)
    kept = [sizes[-1]]
    for b in reversed(sizes[:-1]):
        if latency_us[b] <= keep_ratio * latency_us[kept[0]]:
            kept.insert(0, b)
    return tuple(kept)


def pick_tiles(latency_by_state: Dict[str, Dict[str, float]],
               margin: float = TILE_MARGIN) -> dict:
    """The override to commit from a tile sweep ``{state: {tile_key:
    us}}``: of the candidates faster than ``(1 - margin)`` times
    ``"auto"`` in every served state, the one with the least summed
    time; ``{}`` (the kernel's own geometry) when none is, or when there
    was no sweep."""
    if not latency_by_state:
        return {}
    lats = list(latency_by_state.values())
    wins = [k for k in lats[0] if k != AUTO
            and all(lat[k] < (1.0 - margin) * lat[AUTO] for lat in lats)]
    if not wins:
        return {}
    return parse_tile_key(min(wins, key=lambda k: sum(lat[k]
                                                      for lat in lats)))


def autotune_backend(backend, *,
                     shape: Optional[Dict[str, int]] = None,
                     tile_grid: Optional[Grid] = None,
                     bucket_candidates: Sequence[int] = BUCKET_CANDIDATES,
                     reps: int = 5, device: DeviceLike = None) -> Dict:
    """Measure one backend on ``device`` in each of its served states
    (:func:`served_states`): on the card the tile sweep (``"auto"`` and
    every tile of ``tile_grid``, the family's full grid by default) at the
    largest bucket, committed by :func:`pick_tiles`; then each bucket's
    latency at the committed tiles, the ladder being the union of the
    states' pruned ladders.  Returns the registry entry (a plain
    JSON-shaped dict)."""
    from repro_torch import api
    device = resolve_device(device)
    on_card = device.type == "cuda"
    shape = dict(shape or REF_SHAPE)
    bt_ref = max(bucket_candidates)
    states = {label: (replicas, _reference_state(backend, shape, device,
                                                 bt_ref, replicas, d2d))
              for label, replicas, d2d in served_states(backend)}

    def call(label: str, bt: int, tiles: dict) -> Callable:
        state, lits = states[label][1]
        return lambda: backend.fn(state, lits[:bt], None, tiles=tiles)

    # The plain versions ignore tiles: the host has nothing to sweep.
    tile_reps = max(reps, TILE_REPS_MIN)
    tile_lat: Dict[str, Dict[str, float]] = {}
    if on_card:
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                            device=device)
        candidates = tile_candidates(backend, shape, tile_grid)
        tile_lat = {label: {k: round(v, 3) for k, v in _device_times_us(
            {tile_key(t): call(label, bt_ref, t) for t in candidates},
            tile_reps, flush).items()} for label in states}
        del flush
    best = pick_tiles(tile_lat)         # on the recorded (rounded) times

    bucket_lat = {label: _host_times_us(
        {b: call(label, b, best) for b in bucket_candidates}, reps,
        sync=on_card) for label in states}
    ladder = sorted(set().union(*(prune_bucket_ladder(lat)
                                  for lat in bucket_lat.values())))
    platform, device_name = api.device_signature(device)
    last = list(states)[-1]                  # the heaviest served state
    return {
        "tiles": best,
        "bucket_sizes": [int(b) for b in ladder],
        "bucket_latency_us": {str(b): round(sum(lat[b] for lat in
                                                bucket_lat.values()), 2)
                              for b in bucket_candidates},
        "bucket_latency_by_state": {
            label: {str(b): round(v, 2) for b, v in lat.items()}
            for label, lat in bucket_lat.items()},
        "tile_latency_us": ({k: round(sum(lat[k] for lat in
                                          tile_lat.values()), 3)
                             for k in next(iter(tile_lat.values()))}
                            if tile_lat else {}),
        "tile_latency_by_state": tile_lat,
        "tile_margin": TILE_MARGIN,
        "tile_geometry": _tile_geometry(backend, last, states[last][0],
                                        states[last][1][0], bt_ref, best,
                                        device),
        "shape": shape,
        "platform": platform,
        "device_name": device_name,
        "power_limit_w": power_limit_w(device),
        "torch": torch.__version__,
        "tile_estimator": (
            f"device time of one call at B = {bt_ref} in each served "
            f"state (tile_latency_us: their sum), cuda events, median of "
            f"{tile_reps} calls, each enqueued behind a spin kernel with "
            f"L2 flushed; an override must beat auto by more than "
            f"{TILE_MARGIN:.0%} in every state; reps taken in turns "
            "over the candidates" if on_card else
            "none: the plain versions ignore tiles"),
        "bucket_estimator": (
            ("wall time of one call ending in torch.cuda.synchronize(), "
             if on_card else "wall time of one call, ")
            + f"min of {max(1, reps)} taken in turns over the buckets, in "
              "each served state "
              "(bucket_latency_us: their sum); the ladder is the union "
              "of the states' pruned ladders"),
    }


def ensure_tuning(backend, tm_cfg, *, device: DeviceLike = None,
                  reps: int = LAZY_REPS) -> Dict:
    """Get-or-measure the ``(backend, shape bucket)`` entry for a model on
    ``device``.

    The lazy half of shape-aware autotuning: when the registry has no
    entry that applies on ``device`` for this backend at ``tm_cfg``'s
    shape bucket, run the small first-sight sweep (``LAZY_*`` grids) at
    the EXACT model shape, register it under the bucket and return it.
    The registry hit means the second engine at the same (backend,
    bucket) never measures again."""
    from repro_torch import api
    device = resolve_device(device)
    shape_key = api.shape_bucket_key(tm_cfg.n_clauses, tm_cfg.n_literals)
    entry = api.get_tuning(backend.name, shape_key=shape_key, device=device)
    if entry is not None:
        return entry
    shape = {"n_classes": tm_cfg.n_classes,
             "n_features": tm_cfg.n_features}
    if hasattr(tm_cfg, "clauses_per_class"):
        shape["clauses_per_class"] = tm_cfg.clauses_per_class
    else:                       # CoalescedConfig: one shared pool, no
        shape["n_clauses"] = tm_cfg.n_clauses   # per-class split exists
    entry = autotune_backend(
        backend, shape=shape,
        tile_grid=LAZY_ANALOG if is_analog(backend) else LAZY_TM,
        bucket_candidates=LAZY_BUCKETS, reps=reps, device=device)
    entry["lazy"] = True
    api.register_tuning(backend.name, entry, shape_key=shape_key)
    return entry


def autotune(backend_names: Optional[Iterable[str]] = None, *,
             smoke: bool = False, reps: int = 5, register: bool = True,
             shapes: Optional[Sequence[Dict[str, int]]] = None,
             device: DeviceLike = None) -> Dict[str, Dict[str, Dict]]:
    """Measure every (or the named) tunable backend at every requested
    shape on ``device`` and register the entries in the registry.

    ``smoke`` shrinks the sweep to a 2 x 2 tile grid, two buckets, one
    rep, and the reference shape only.  Per-class shapes are measured on
    every fused backend; a coalesced shape (``n_clauses``) only on the
    coalesced ones.  Returns the nested table ``{backend: {shape_key:
    entry}}``."""
    from repro_torch import api
    device = resolve_device(device)
    backends = _tunable_backends()
    if backend_names is not None:
        names = set(backend_names)
        backends = [b for b in backends if b.name in names]
    if shapes is None:
        shapes = (REF_SHAPE,) if smoke else (REF_SHAPE, KWS_SHAPE)
    entries: Dict[str, Dict[str, Dict]] = {}
    for backend in backends:
        coalesced = api.CoalescedState in backend.state_types
        grid = ((SMOKE_ANALOG if is_analog(backend) else SMOKE_TM)
                if smoke else None)
        for shape in shapes:
            if "clauses_per_class" not in shape and not coalesced:
                continue
            entry = autotune_backend(
                backend, shape=shape, tile_grid=grid,
                bucket_candidates=SMOKE_BUCKETS if smoke
                else BUCKET_CANDIDATES,
                reps=1 if smoke else reps, device=device)
            skey = api.shape_key_of(shape)
            entries.setdefault(backend.name, {})[skey] = entry
            if register:
                api.register_tuning(backend.name, entry, shape_key=skey)
    return entries


def normalize_table(raw: Dict) -> Dict[str, Dict[str, Dict]]:
    """Accept either schema: nested ``{backend: {shape_key: entry}}`` or
    the reference's older flat ``{backend: entry}`` (key derived from the
    entry's recorded shape)."""
    from repro_torch import api
    table: Dict[str, Dict[str, Dict]] = {}
    for bname, shapes in raw.items():
        if "tiles" in shapes:                         # flat entry
            skey = (api.shape_key_of(shapes["shape"])
                    if shapes.get("shape") else api.REF_SHAPE_KEY)
            shapes = {skey: shapes}
        table[bname] = dict(shapes)
    return table


def save_table(entries: Dict[str, Dict[str, Dict]],
               path: str = DEFAULT_TABLE_PATH, *,
               merge: bool = True) -> str:
    """Persist a nested ``{backend: {shape_key: entry}}`` table.

    ``merge`` (default) folds the new entries over whatever the file
    already holds, so regenerating one shape never drops another shape's
    measurements."""
    table: Dict[str, Dict[str, Dict]] = {}
    if merge and os.path.exists(path):
        try:
            table = normalize_table(load_table(path))
        except (OSError, json.JSONDecodeError):
            table = {}
    for bname, shapes in normalize_table(entries).items():
        table.setdefault(bname, {}).update(shapes)
    with open(path, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_table(path: str) -> Dict[str, Dict]:
    with open(path) as f:
        return json.load(f)


def load_default_table() -> Dict[str, Dict]:
    """The committed default table (empty dict when not generated yet)."""
    if not os.path.exists(DEFAULT_TABLE_PATH):
        return {}
    try:
        return load_table(DEFAULT_TABLE_PATH)
    except (OSError, json.JSONDecodeError):
        return {}
