"""The IMBUE serving engine: requests in, deadline-batched analog reads out
(port of ``repro.serve.engine``).

  submit() -> DynamicBatcher — in packed mode the request is packed to
              32-bit literal words HERE, once; the queue and every
              host->device copy carry ``[bucket, L/32]`` words
           -> RouterState routing (round-robin / least-loaded / ensemble,
              masked to the healthy chips)
           -> ONE forward per batch: the capability-selected backend
              (``analog-cuda-packed2`` by default, one kernel launch for
              the whole replica stack), then the argmax or ensemble vote
           -> Response records + metrics accounting.

A coalesced pool (``ServeEngine.from_coalesced``) is one shared chip
behind the same surface: every route lands on it, the backend returns
``[B, M]`` sums and ensemble routing reduces to the argmax.  The pool
supplies its default backend ladder and its routed single-chip states,
so the engine never branches on the pool's kind.

The backend is selected once at construction, down the reference's
ladder: ``analog-cuda-packed2`` for a plane-packed state (the default),
``analog-cuda-packed`` with ``EngineConfig(pack_planes=False)``,
``analog-cuda`` with ``EngineConfig(packed=False)``.  A fallback (e.g. a
``csa_offset`` pool, which the kernels do not model, going to
``analog-torch``) warns and is counted per dispatch in ``ServeMetrics``.
The registry's tuning table (``kernels/autotune.py``) is read once too,
for the selected backend, the model's shape bucket and the engine's
device: its kernel tiles go into every fused dispatch, its bucket ladder
replaces a ``for_max_batch`` batcher's static one, and
``EngineConfig.lazy_tune`` measures a missing entry once
(``summary()``: ``kernel_tiles``, ``buckets_tuned_for``, ``shape_key``,
``tuning_lazy``).
An injectable ``clock`` makes deadline behaviour deterministic under
test, and every analog read draws its noise from one engine-owned
``torch.Generator``, in issue order.

A dispatch is split in two.  On a CUDA device ``_issue`` never waits for
the card: it stages the batch's rows in a page-locked host slot, copies
them to the device without blocking, launches the forward, starts
non-blocking copies of the sums and predictions back into the same slot
and records a ``torch.cuda.Event`` behind them.  ``_collect`` waits on
that event, copies the valid rows out of the slot (no ``Response`` points
into page-locked memory) and hands the slot back.  The engine owns one
slot per dispatch it may have outstanding, allocated once.
``ServeEngine`` collects each issue at once; :class:`AsyncServeEngine`
keeps up to ``max_in_flight`` issues outstanding, so the host packs batch
N+1 while the card computes batch N, and ``summary()['overlap_fraction']``
reports the share of the in-flight time the host spent on that work
rather than waiting (every host wait is in a collect, so it is counted).
On the CPU a result is complete when its op returns: there is no event
and nothing is pinned.

Live operations, between dispatches:

* ``install_pool`` — quiesce (collect everything in flight), check the
  new pool is hot-compatible, swap pool, state and routes in one step;
  queued requests serve at the new ``version``.
* ``arm_canary`` — a candidate chip serves a deterministic ``fraction``
  of batches (``Response.replica == CANARY``); each canary batch is read
  again on the stable pool with the same noise (the serving generator's
  state is replayed), and the argmax agreement lands in ``ServeMetrics``.
  ``serve/swap.py`` drives snapshot -> canary -> promote / rollback.
* ``enable_health`` / ``probe`` — committed probe rows read on every chip
  through the serving backend, with their own noise stream (a probe never
  moves the serving generator); chips below the threshold are
  quarantined from routing and the ensemble vote, never the last healthy
  one, and readmitted after repair (``serve/swap.py``'s ``RepairPolicy``).
* ``inject_faults`` — the chaos surface: hurt the serving pool in place.

On a mesh (``mesh=``, ``launch.mesh.make_replica_mesh``) the pool is
placed with ``pool.shard(mesh)`` (``sharding.replica_rules``) before
anything reads it: a replica stack's ``[R, C, L]`` resistances split
over ``replica``, a coalesced pool's weight columns too.  There is one
process a rank, and every rank builds the same engine from the same seed
and submits the same requests.  A partitioned state is plane-packed
block by block and served by the same kernel ladder as on one device
(``CAP_SHARDED``): each rank launches the kernel on its own replicas
(or class columns) and on its request rows, which split over ``batch``
where the bucket divides (``_place_lits``).  The ``[R_local, B_local,
M]`` block comes to the host like any result; ``_collect`` gathers the
blocks over the mesh and only then votes or takes the argmax, so an
issue makes no collective and no synchronization.  With more than one
rank, the cut decisions are rank 0's: at every cut, one broadcast
carries rank 0's clock reading and the enqueue stamps (and batching and
request deadlines) of the requests submitted since the last cut, and
every rank reaps and cuts on those numbers; the async engine collects
early only the dispatches that are ready on every rank (one all-reduce a
pump).  So all ranks cut the same batches and call their collectives in
one order.  Every other clock reading is the rank's own; rank 0's
metrics are the ones its entry points report.  ``summary()`` splits a
rank's host time on the mesh into ``agree_s`` (the cut broadcasts and
readiness all-reduces) and ``gather_s`` (the gathers at collect), beside
``issue_s`` (the host time of every issue).
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import api
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.api.registry import (CAP_FUSED_KERNEL, CAP_PACKED_IO,
                                      CAP_PACKED_PLANES, CAP_SHARDED)
from repro_torch.core import tm
from repro_torch.core.coalesced import CoalescedConfig
from repro_torch.core.imbue import IMBUEConfig
from repro_torch.core.tm import TMConfig
from repro_torch.core.variations import (FaultConfig, VariationConfig,
                                         split_generator)
from repro_torch.distributed import sharding
from repro_torch.kernels.autotune import ensure_tuning, tiles_fit
from repro_torch.serve.batching import (QOS_BULK, Batch, BatcherConfig,
                                        DynamicBatcher, QueueFull,
                                        pack_request_np, validate_qos)
from repro_torch.serve.health import HealthConfig, HealthProbe
from repro_torch.serve.metrics import (RequestRecord, ServeMetrics,
                                       hardware_figures)
from repro_torch.serve.replica import (CoalescedPool, ReplicaPool,
                                       RouterState, ensemble_vote,
                                       program_replica_pool)

ENSEMBLE = -1      # Response.replica value when every chip voted
CANARY = -2        # Response.replica value when the canary chip served
EXPIRED = -3       # Response.replica value when the deadline expired queued

# The default backend preferences, the pools' ladders (best tier first):
# capability selection overrides each when the pool's noise model needs
# physics the kernels do not implement.
(DEFAULT_PLANES_BACKEND, DEFAULT_PACKED_BACKEND,
 DEFAULT_BACKEND) = ReplicaPool.BACKENDS
(DEFAULT_COALESCED_PLANES_BACKEND, DEFAULT_COALESCED_PACKED_BACKEND,
 DEFAULT_COALESCED_BACKEND) = CoalescedPool.BACKENDS


def _resident_model_nbytes(state, backend: api.Backend) -> int:
    """Programmed-model operand bytes one dispatch of ``state`` reads:
    the int32 index bitplane plus the optional f32 deviation plane for the
    plane-packed backends; the include plane (int32 words when packed,
    4 bytes a cell otherwise, as the reference counts) for a coalesced or
    digital state; two f32 planes per cell for the dense analog paths."""
    if CAP_PACKED_PLANES in backend.capabilities and state.plane_packed:
        n = state.plane_index.numel() * 4
        dev = getattr(state, "plane_dev", None)
        if dev is not None:
            n += dev.numel() * 4
        return n
    if isinstance(state, api.CoalescedState):
        if CAP_PACKED_IO in backend.capabilities and state.packed:
            return state.include_packed.numel() * 4
        return state.ta_state.numel() * 4
    if isinstance(state, api.ReplicaStackState):
        return 2 * state.r_stack.numel() * 4
    if isinstance(state, api.CrossbarState):
        return 2 * state.r_mem.numel() * 4
    return state.include.numel() * 4


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving policy knobs."""

    batcher: BatcherConfig = BatcherConfig()
    routing: str = "round_robin"     # round_robin | least_loaded | ensemble
    ensemble_mode: str = "majority"  # majority | sum (see ensemble_vote)
    # Pack requests to 32-bit literal words and attach the packed include
    # plane to the pool state.
    packed: bool = True
    # After packing, fold the programmed stack into the index bitplane +
    # deviation plane (elided at nominal) that the CUDA kernel streams.
    pack_planes: bool = True
    # Backend *preference* (registry name); None -> the pool's default.
    backend: Optional[str] = None
    # DEPRECATED: the old Boolean kernel toggle.  True maps to
    # backend="analog-cuda", False to "analog-torch".
    use_kernel: Optional[bool] = None
    # AsyncServeEngine only: how many issued batches may be outstanding
    # (uncollected) at once; 2 is double buffering.
    max_in_flight: int = 2
    # Shape-aware autotuning: the tuning table is keyed by (backend,
    # shape bucket) and bound to the device it was measured on, so an
    # engine whose model shape has no entry for its device serves on the
    # kernels' own geometry and the static ladder.  With lazy_tune=True
    # a fused backend measures the missing entry ONCE at construction (a
    # small tile / bucket sweep, ``kernels.autotune.ensure_tuning``) and
    # registers it for every later engine at the same (backend, bucket).
    lazy_tune: bool = False
    # Queued-but-undispatched requests held before submit() raises
    # QueueFull (None = unbounded).
    max_queue_depth: Optional[int] = None
    # A HealthConfig commits probe rows at construction so probe() works
    # at once; None leaves probing to enable_health().  Probing never
    # happens on its own: pump() is pure serving.
    health: Optional[HealthConfig] = None

    def backend_preference(self) -> Optional[str]:
        """The explicit preference, or None for the pool's default."""
        if self.use_kernel is not None:
            warnings.warn(
                "EngineConfig.use_kernel is deprecated; set "
                "EngineConfig.backend to a repro_torch.api backend name "
                "('analog-cuda' / 'analog-torch')",
                DeprecationWarning, stacklevel=2)
            if self.backend is not None:
                raise ValueError("set EngineConfig.backend or the "
                                 "deprecated use_kernel, not both")
            return "analog-cuda" if self.use_kernel else "analog-torch"
        return self.backend


@dataclasses.dataclass
class Response:
    """One served prediction."""

    rid: int
    pred: int
    class_sums: np.ndarray           # [M] (summed over chips in ensemble)
    replica: int                     # serving chip, ENSEMBLE/CANARY/EXPIRED
    latency_s: float
    version: int = 0                 # pool model generation that served it
    expired: bool = False            # deadline elapsed while queued


class _HostSlot:
    """The page-locked host buffers one CUDA dispatch owns from issue to
    collect: its rows on their way to the card and its results on their
    way back, and the event recorded behind them.  Each buffer is made at
    its first use, ``rows`` (the largest bucket) deep, and reused; the
    engine hands a slot out again only after its dispatch was collected,
    so no copy in flight reads or writes a buffer that is being reused."""

    def __init__(self, rows: int):
        self.rows = rows
        self._bufs: Dict[str, torch.Tensor] = {}
        self.event = torch.cuda.Event()

    def buffer(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """The first ``len(like)`` rows of buffer ``name``, made at its
        first use with ``like``'s row shape and dtype (an engine's wire
        format and result types never change)."""
        buf = self._bufs.get(name)
        if buf is None:
            buf = self._bufs[name] = torch.empty(
                (self.rows, *like.shape[1:]), dtype=like.dtype,
                pin_memory=True)
        return buf[:like.shape[0]]


@dataclasses.dataclass
class InFlight:
    """One issued-but-not-collected dispatch: the host tensors its results
    land in, the event behind their copies, and the timestamps the overlap
    accounting needs."""

    batch: Batch
    # [bucket, M] int32 on the host; for a partitioned read this rank's
    # block of the backend's sums, rows first, gathered and reduced at
    # collect (preds None until then).
    sums: torch.Tensor
    preds: Optional[torch.Tensor]    # [bucket] host
    replica: int                     # serving chip, ENSEMBLE or CANARY
    t_dispatch: float                # clock at dispatch start
    t_issue: float                   # clock right after the launches
    # Engine-cumulative blocked-wait seconds at issue: the collect side
    # subtracts OTHER batches' waits from this batch's in-flight window.
    blocked_snapshot: float = 0.0
    # Pool model generation serving this batch, captured at issue.
    version: int = 0
    # Canary batches only: the stable pool's predictions on the same rows
    # with the same noise, for the agreement tally at collect.
    shadow_preds: Optional[torch.Tensor] = None
    # Resident-model operand bytes this dispatch streamed.
    resident_nbytes: int = 0
    # CUDA only: recorded after the device-to-host copies (None on the
    # CPU, where the results are complete when issue returns), the device
    # tensors those copies read, kept alive until collect, and the host
    # slot that holds the rows and the results.
    event: Optional[object] = None
    device_tensors: Tuple[torch.Tensor, ...] = ()
    slot: Optional[_HostSlot] = None
    # A partitioned read only: (mesh, placements, the block's row
    # dimension) of its sums, and the vote mask on the host.
    layout: Optional[tuple] = None
    mask: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _Canary:
    """One armed canary: a dispatchable single-chip state beside the
    stable pool, its candidate version and its traffic share."""

    state: object
    version: int
    fraction: float


class ServeEngine:
    """Dynamic-batching inference engine over a crossbar replica pool or
    one shared coalesced pool."""

    def __init__(
        self,
        pool: ReplicaPool | CoalescedPool,
        tm_cfg: TMConfig | CoalescedConfig,
        ecfg: EngineConfig = EngineConfig(),
        *,
        generator: Optional[torch.Generator] = None,
        clock: Callable[[], float] = time.monotonic,
        device: DeviceLike = None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        # Ranks must agree on every batch cut and on when to collect.
        self._multi_rank = mesh is not None and sharding.world_size() > 1
        pool = self._place(pool.to(self.device))
        self.tm_cfg = tm_cfg     # a CoalescedConfig for a coalesced pool
        self.ecfg = ecfg
        self.clock = clock
        self.metrics = ServeMetrics()
        self.router: RouterState = pool.router()
        state = self._state_of(pool)
        self._generator = (generator if generator is not None else
                           torch.Generator(device=self.device).manual_seed(0))
        self._noise_free = not (pool.vcfg.c2c or pool.vcfg.csa_offset)
        # Capability selection, once: the noise model is static per engine.
        sel_gen = None if self._noise_free else self._generator
        self.selection: api.Selection = api.select_backend(
            state, generator=sel_gen,
            prefer=ecfg.backend_preference() or pool.default_backend(state))
        self.backend: api.Backend = self.selection.backend
        if self.selection.fell_back:
            warnings.warn(
                f"serve backend fallback: {self.selection.fallback_reason} "
                "(noise semantics differ from the preferred backend; see "
                "engine.summary()['forward_fallbacks'])", stacklevel=2)
        # Wire format follows the SELECTED backend: a fallback off the
        # packed kernel also falls back to the dense uint8 queue.
        self.packed_io = CAP_PACKED_IO in self.backend.capabilities
        # Measured tuning (kernels/autotune.py) for this backend, model
        # shape and device: kernel tiles for every fused dispatch (probe
        # and canary reads too), and the bucket ladder when the batcher
        # config was built by for_max_batch (auto_tune), never over a
        # hand-picked one.
        self.shape_key: str = api.shape_bucket_key(tm_cfg.n_clauses,
                                                   tm_cfg.n_literals)
        fused = CAP_FUSED_KERNEL in self.backend.capabilities
        self.tuning: Optional[dict] = api.get_tuning(
            self.backend.name, shape_key=self.shape_key, device=self.device)
        # Not on a mesh of several ranks: each would time its own sweep,
        # and ranks that pick different ladders cut different batches.
        if self.tuning is None and ecfg.lazy_tune and fused and \
                not self._multi_rank:
            self.tuning = ensure_tuning(self.backend, tm_cfg,
                                        device=self.device)
        tiles = dict((self.tuning or {}).get("tiles") or {})
        if tiles and not tiles_fit(tiles, tm_cfg.n_literals):
            # The entry covers a shape bucket and was measured at one model
            # in it; its ks cannot launch on this model's fewer columns.
            warnings.warn(
                f"tuning entry {self.backend.name} @ {self.shape_key}: "
                f"tiles {tiles} do not fit L = {tm_cfg.n_literals}; serving "
                "on the kernel's own geometry (summary()['kernel_tiles'])",
                stacklevel=2)
            tiles = {}
        self._kernel_opts = {"tiles": tiles} if fused and tiles else {}
        bcfg = ecfg.batcher
        if bcfg.auto_tune and self.tuning and \
                self.tuning.get("bucket_sizes"):
            bcfg = bcfg.with_tuned_buckets(self.tuning["bucket_sizes"],
                                           self.backend.name)
        self.batcher = DynamicBatcher(bcfg, packed=self.packed_io)
        self._set_pool(pool, state)
        self._mask_one_host = torch.ones(1, dtype=torch.bool)
        self._mask_one = self._mask_one_host.to(self.device)
        self._healthy_mask_host = torch.ones(pool.n_replicas,
                                             dtype=torch.bool)
        self._healthy_mask = self._healthy_mask_host.to(self.device)
        self._next_rid = 0
        self._submitted: List[int] = []
        self._results: Dict[int, Response] = {}
        self._taken: set = set()
        self._discard: set = set()
        self._blocked_s = 0.0            # cumulative blocked collect time
        self._gather_s = 0.0             # host seconds gathering blocks
        self._agree_s = 0.0              # host seconds agreeing on cuts
        self._issue_s = 0.0              # host seconds issuing dispatches
        # Several ranks: the requests submitted since the last cut, whose
        # stamps the next cut's broadcast replaces with rank 0's.
        self._unagreed: List = []
        self._free_slots: List[_HostSlot] = []   # CUDA host slots, idle
        self._n_slots = 0
        self._canary: Optional[_Canary] = None
        self._canary_acc = 0.0
        # Health probes read with their own noise stream, so probing never
        # moves the serving generator.
        self.health: Optional[HealthProbe] = None
        self._health_generator = torch.Generator(
            device=self.device).manual_seed(0)
        if ecfg.health is not None:
            self.enable_health(ecfg.health)

    @classmethod
    def from_ta_state(
        cls,
        ta_state: torch.Tensor,
        tm_cfg: TMConfig,
        *,
        n_replicas: int = 1,
        seed: int = 0,
        vcfg: VariationConfig = VariationConfig(),
        icfg: IMBUEConfig = IMBUEConfig(),
        ecfg: EngineConfig = EngineConfig(),
        clock: Callable[[], float] = time.monotonic,
        device: DeviceLike = None,
        mesh=None,
    ) -> "ServeEngine":
        """Program a fresh pool from TA state and wrap an engine; ``seed``
        feeds one generator, split into a programming and a serving
        stream.  Programming comes before the placement on ``mesh``, so
        every rank's shard holds the single-device draws."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        g_prog, g_serve = split_generator(gen, 2)
        include = tm.include_mask(ta_state.to(device), tm_cfg)
        pool = program_replica_pool(include, g_prog, n_replicas, vcfg, icfg)
        return cls(pool, tm_cfg, ecfg, generator=g_serve, clock=clock,
                   device=device, mesh=mesh)

    @classmethod
    def from_coalesced(
        cls,
        ta_state: torch.Tensor,
        weights: torch.Tensor,
        cfg: CoalescedConfig,
        *,
        ecfg: EngineConfig = EngineConfig(),
        generator: Optional[torch.Generator] = None,
        clock: Callable[[], float] = time.monotonic,
        device: DeviceLike = None,
        mesh=None,
    ) -> "ServeEngine":
        """Serve a coalesced model: one shared clause pool, the weighted
        digital tail as the combine matrix.  The engine surface is
        unchanged; the pool behind it is a single-chip
        :class:`~repro_torch.serve.replica.CoalescedPool`.  A ``mesh``
        splits its weight columns over ``replica`` (class-parallel)."""
        device = resolve_device(device)
        pool = CoalescedPool(ta_state=torch.as_tensor(ta_state).to(device),
                             weights=torch.as_tensor(weights).to(device),
                             cfg=cfg)
        return cls(pool, cfg, ecfg, generator=generator, clock=clock,
                   device=device, mesh=mesh)

    def _place(self, pool):
        """``pool`` placed on this engine's mesh (itself off a mesh)."""
        return pool if self.mesh is None else pool.shard(self.mesh)

    def _state_of(self, pool):
        """The pool's backend state in this engine's wire format."""
        return self._wire_format(pool.state(self.tm_cfg))

    def _wire_format(self, state):
        """``state`` packed as this engine's ``EngineConfig`` asks (a
        partitioned state block by block)."""
        if self.ecfg.packed:
            state = state.pack()
            if self.ecfg.pack_planes:
                state = state.pack_planes()
        return state

    def _set_pool(self, pool, state=None) -> None:
        """Replace the serving pool, its state and the routed slices in one
        step, between dispatches (callers quiesce first).  Same shapes and
        static configs, so the selected backend stays."""
        state = self._state_of(pool) if state is None else state
        self.pool = pool
        self.state = state
        self._slices = pool.routes(state)
        self._refresh_resident_nbytes()

    def _refresh_resident_nbytes(self) -> None:
        """Per-dispatch resident operand bytes for the full state (ensemble)
        and one slice (routed), recomputed whenever the pool changes: an
        injury can grow a nominal plane-packed pool a deviation plane."""
        self._resident_full = _resident_model_nbytes(self.state,
                                                     self.backend)
        self._resident_slice = _resident_model_nbytes(self._slices[0],
                                                      self.backend)

    def _read(self, state, lits: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        """The backend's sums of one batch: ``[R, B, M]`` or ``[B, M]``,
        or this rank's block of them for a partitioned read."""
        return self.backend.fn(state, lits, generator, **self._kernel_opts)

    def _forward(self, state, lits: torch.Tensor,
                 generator: Optional[torch.Generator], mask: torch.Tensor):
        """Backend forward + prediction for one batch, gathered at once:
        ``[B, M]`` sums and ``[B]`` predictions (summed/voted over the
        healthy chips in ensemble mode)."""
        return self._reduce(
            sharding.gather(self._read(state, lits, generator)), mask)

    def _reduce(self, sums: torch.Tensor, mask: torch.Tensor):
        """``[R, B, M]`` or ``[B, M]`` sums -> ``([B, M] sums, [B]
        predictions)``: the vote over the chips of ``mask`` in ensemble
        mode, the one chip's argmax otherwise."""
        if sums.ndim == 3:                       # replica-stacked output
            if self.ecfg.routing == "ensemble":
                preds = ensemble_vote(sums, self.ecfg.ensemble_mode,
                                      mask=mask)
                sums = torch.where(mask[:, None, None], sums, 0).sum(
                    dim=0, dtype=torch.int32)
            else:
                sums = sums[0]
                preds = torch.argmax(sums, dim=-1)
        else:            # one shared coalesced chip: ensemble == argmax
            preds = torch.argmax(sums, dim=-1)
        return sums, preds

    def _device_lits(self, rows: np.ndarray, packed: bool,
                     slot: Optional[_HostSlot] = None) -> torch.Tensor:
        """Host rows -> the backend's literal operand on the device.  A
        dispatch's rows go through its page-locked ``slot`` and reach the
        card without blocking the host; without a slot (a probe, which is
        a barrier anyway, or the CPU) the copy is synchronous."""
        x = torch.from_numpy(rows.view(np.int32) if packed else rows)
        if slot is not None:
            x = slot.buffer("rows", x).copy_(x).to(self.device,
                                                    non_blocking=True)
        else:
            x = x.to(self.device)
        return x if packed else tm.literals(x)

    def _place_lits(self, lits: torch.Tensor) -> torch.Tensor:
        """The batch operand on the mesh: rows split over the ``batch``
        axis when the bucket divides and the backend reads partitioned
        operands (data-parallel reads), whole otherwise.  No
        communication."""
        if self.mesh is None or CAP_SHARDED not in self.backend.capabilities:
            return lits
        batch = sharding.replica_rules(self.mesh).batch
        sh = sharding.NamedSharding(self.mesh, sharding.fit_spec(
            tuple(lits.shape), self.mesh, sharding.P(batch)))
        return sh.place(lits) if sh.partitions else lits

    def _max_outstanding(self) -> int:
        """Dispatches this engine may have issued and not yet collected."""
        return 1

    def _take_slot(self) -> Optional[_HostSlot]:
        """An idle host slot for one CUDA dispatch (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        if self._free_slots:
            return self._free_slots.pop()
        if self._n_slots >= self._max_outstanding():
            raise RuntimeError(
                f"{self._n_slots} dispatches are in flight, the most this "
                "engine holds; collect one before issuing another")
        self._n_slots += 1
        return _HostSlot(self.batcher.cfg.max_batch)

    # --------------------------------------------------------------- intake

    def submit(self, x: np.ndarray, *,
               deadline_s: Optional[float] = None,
               qos: str = QOS_BULK) -> int:
        """Queue one request (``[F]`` Boolean features); returns its id.

        ``deadline_s`` is a request deadline relative to now: if it
        elapses while the request is still queued, the request resolves
        to a ``Response`` with ``expired=True`` (pred ``-1``) and is never
        dispatched.  ``qos`` picks the deadline class (``"latency"`` or
        ``"bulk"``).  A full queue (``max_queue_depth`` or the class's own
        limit) raises :class:`QueueFull`, and the rejection is metered.
        """
        validate_qos(qos)
        if (self.ecfg.max_queue_depth is not None
                and len(self.batcher) >= self.ecfg.max_queue_depth):
            self.metrics.note_rejected(qos=qos)
            raise QueueFull(
                f"queue depth {len(self.batcher)} is at "
                f"max_queue_depth={self.ecfg.max_queue_depth}; retry "
                "after pump() or raise the limit")
        class_depth = self.batcher.cfg.queue_depth_for(qos)
        if (class_depth is not None
                and self.batcher.depth(qos) >= class_depth):
            self.metrics.note_rejected(qos=qos)
            raise QueueFull(
                f"{qos} class depth {self.batcher.depth(qos)} is at its "
                f"per-class limit {class_depth}; retry after pump() or "
                "raise the limit")
        rid = self._next_rid
        self._next_rid += 1
        req = self.batcher.submit(rid, x, self.clock(),
                                  deadline_s=deadline_s, qos=qos)
        if self._multi_rank:
            self._unagreed.append(req)
        self._submitted.append(rid)
        return rid

    def submit_many(self, xs: Sequence[np.ndarray], *,
                    deadline_s: Optional[float] = None,
                    qos: str = QOS_BULK) -> List[int]:
        return [self.submit(x, deadline_s=deadline_s, qos=qos)
                for x in xs]

    # ------------------------------------------------------------- serving

    def _reap_expired(self, now: float) -> None:
        """Resolve queued requests whose deadline has passed (never
        dispatched; abandoned ones are dropped without a Response)."""
        for req in self.batcher.reap_expired(now):
            self.metrics.note_expired(qos=req.qos)
            if req.rid in self._discard:
                self._discard.discard(req.rid)
                continue
            self._results[req.rid] = Response(
                rid=req.rid, pred=-1,
                class_sums=np.zeros(self.tm_cfg.n_classes, np.int32),
                replica=EXPIRED, latency_s=now - req.t_enqueue,
                version=self.pool.version, expired=True)

    def pump(self, force: bool = False) -> int:
        """Cut and dispatch every due batch; returns #requests served.
        Expiry is re-checked at every cut with the cut's own clock
        reading, so no request is dispatched past its deadline."""
        self._prune_consumed()
        served = 0
        while True:
            now = self._cut_clock()
            self._reap_expired(now)
            batch = self.batcher.cut(now, force=force)
            if batch is None:
                return served
            self._dispatch(batch)
            served += batch.n_valid

    def _cut_clock(self) -> float:
        """The clock reading a cut decides on.  On several ranks it is rank
        0's, broadcast in one collective with rank 0's stamps of the
        requests submitted since the last cut (enqueue time, batching
        deadline, expiry), which replace this rank's own: every rank then
        reaps and cuts on the same numbers."""
        now = self.clock()
        if not self._multi_rank:
            return now
        t0 = time.perf_counter()
        mine = [now]
        for req in self._unagreed:
            mine += [req.t_enqueue, req.deadline,
                     math.nan if req.expiry is None else req.expiry]
        agreed = sharding.broadcast_values(mine)
        for i, req in enumerate(self._unagreed):
            req.t_enqueue, req.deadline, expiry = agreed[1 + 3 * i:4 + 3 * i]
            req.expiry = None if math.isnan(expiry) else expiry
        self._unagreed.clear()
        self._agree_s += time.perf_counter() - t0
        return agreed[0]

    def drain(self) -> List[Response]:
        """Force-serve everything queued and collect everything in flight;
        responses in submission order (excluding those already consumed by
        :meth:`take` / :meth:`discard`)."""
        self.pump(force=True)
        self._collect_pending()
        return [self._results[rid] for rid in self._submitted
                if rid in self._results]

    def _prune_consumed(self) -> None:
        if self._taken:
            self._submitted = [r for r in self._submitted
                               if r not in self._taken]
            self._taken.clear()

    def result(self, rid: int) -> Optional[Response]:
        """The Response of ``rid``, collecting in-flight dispatches if it
        is not there yet."""
        if rid not in self._results:
            self._collect_pending()
        return self._results.get(rid)

    def poll(self, rid: int) -> Optional[Response]:
        """The Response if its batch has been collected, else None (never
        waits on the device)."""
        return self._results.get(rid)

    def take(self, rid: int) -> Optional[Response]:
        """:meth:`poll` + forget, so long-running callers do not grow the
        engine's bookkeeping."""
        resp = self.poll(rid)
        if resp is not None:
            del self._results[rid]
            self._taken.add(rid)
        return resp

    def discard(self, rid: int) -> None:
        """Forget ``rid``: drop its Response now, or on arrival if it is
        still queued or in flight (the read still happens and is still
        metered)."""
        if self._results.pop(rid, None) is None:
            self._discard.add(rid)
        self._taken.add(rid)

    def _collect_pending(self) -> None:
        """Collect outstanding dispatches (none: the synchronous engine
        collects inside ``_dispatch``; AsyncServeEngine overrides)."""

    # ------------------------------------------------------------ dispatch

    def _read_generator(self) -> Optional[torch.Generator]:
        """The noise stream for one analog read (None when the pool is
        noise-free, keeping the nominal path generator-independent)."""
        return None if self._noise_free else self._generator

    def _dispatch(self, batch: Batch) -> None:
        """Synchronous dispatch: issue, then collect at once."""
        self._collect(self._issue(batch))

    def _issue(self, batch: Batch) -> InFlight:
        """Launch one batch's forward without waiting for it."""
        t_dispatch = self.clock()
        t0 = time.perf_counter()
        slot = self._take_slot()
        try:
            return self._launch(batch, slot, t_dispatch)
        except BaseException:
            if slot is not None:
                # Dropped, not reused: a copy may still read it (the host
                # allocator keeps its memory until that copy is done).
                self._n_slots -= 1
            raise
        finally:
            self._issue_s += time.perf_counter() - t0

    def _launch(self, batch: Batch, slot: Optional[_HostSlot],
                t_dispatch: float) -> InFlight:
        lits = self._place_lits(self._device_lits(batch.x, batch.packed,
                                                  slot))
        generator = self._read_generator()
        if self.selection.fell_back:
            self.metrics.note_forward_fallback(
                self.selection.fallback_reason)
        canary = self._take_canary_turn()
        ensemble = self.ecfg.routing == "ensemble"
        if canary is not None:
            # The candidate chip SERVES this batch and the stable pool
            # reads the same rows with the same noise (the generator's
            # state replayed), so the argmax agreement measures the model
            # change, not a different draw.  The stable chip did a real
            # read, so its router load still advances.
            replay = None if generator is None else generator.get_state()
            sums, preds = self._forward(canary.state, lits, generator,
                                        self._mask_one)
            if replay is not None:
                generator.set_state(replay)
            if ensemble:
                _, shadow = self._forward(self.state, lits, generator,
                                          self._healthy_mask)
                for i in self.router.healthy_replicas():
                    self.router.note_dispatch(i, batch.bucket)
            else:
                stable = self.router.pick(self.ecfg.routing)
                _, shadow = self._forward(self._slices[stable], lits,
                                          generator, self._mask_one)
                self.router.note_dispatch(stable, batch.bucket)
            resident = (_resident_model_nbytes(canary.state, self.backend)
                        + (self._resident_full if ensemble
                           else self._resident_slice))
            return self._in_flight(batch, slot, (sums, preds, None),
                                   CANARY, t_dispatch, canary.version,
                                   resident, shadow)
        if ensemble:
            raw = self._read(self.state, lits, generator)
            mask, mask_host = self._healthy_mask, self._healthy_mask_host
            replica = ENSEMBLE
            # Only voting chips count as load: a quarantined chip's sums
            # are computed but masked out of the vote.
            for i in self.router.healthy_replicas():
                self.router.note_dispatch(i, batch.bucket)
            resident = self._resident_full
        else:
            replica = self.router.pick(self.ecfg.routing)
            raw = self._read(self._slices[replica], lits, generator)
            mask, mask_host = self._mask_one, self._mask_one_host
            self.router.note_dispatch(replica, batch.bucket)
            resident = self._resident_slice
        if sharding.partitioned(raw):
            # This rank's block, rows first; the gather and the vote wait
            # for collect, so the issue makes no collective.
            rows = raw.ndim - 2
            results = (raw.to_local().movedim(rows, 0), None,
                       (raw.device_mesh, raw.placements, rows))
        else:
            results = (*self._reduce(raw, mask), None)
        return self._in_flight(batch, slot, results, replica, t_dispatch,
                               self.pool.version, resident, mask=mask_host)

    def _in_flight(self, batch: Batch, slot: Optional[_HostSlot],
                   results: tuple, replica: int, t_dispatch: float,
                   version: int, resident: int,
                   shadow: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None) -> InFlight:
        """Package one issue: ``results`` is ``(sums, preds, layout)``,
        ``layout`` set for a partitioned read's block (no preds yet).  On
        a CUDA device the results start their way into ``slot`` without
        blocking, and an event is recorded behind the copies on the
        current stream; on the CPU the tensors are the results."""
        sums, preds, layout = results
        named = {"block" if layout else "sums": sums, "preds": preds,
                 "shadow": shadow}
        dev = {k: t for k, t in named.items() if t is not None}
        event = None
        if slot is not None:
            hosts = {k: slot.buffer(k, t).copy_(t, non_blocking=True)
                     for k, t in dev.items()}
            event = slot.event
            event.record()
            dev = tuple(dev.values())
        else:
            hosts, dev = dev, ()
        return InFlight(batch=batch, sums=hosts["block" if layout else "sums"],
                        preds=hosts.get("preds"),
                        replica=replica, t_dispatch=t_dispatch,
                        t_issue=self.clock(),
                        blocked_snapshot=self._blocked_s, version=version,
                        shadow_preds=hosts.get("shadow"),
                        resident_nbytes=resident, event=event,
                        device_tensors=dev, slot=slot, layout=layout,
                        mask=mask)

    def _take_canary_turn(self) -> Optional[_Canary]:
        """Deterministic traffic split: an accumulator hands ~fraction of
        batches to the armed canary.  No RNG: a fixed request trace
        replays to the same canary/stable schedule."""
        if self._canary is None:
            return None
        self._canary_acc += self._canary.fraction
        if self._canary_acc >= 1.0 - 1e-9:
            self._canary_acc -= 1.0
            return self._canary
        return None

    @staticmethod
    def _is_ready(fl: InFlight) -> bool:
        """Whether ``fl``'s results have reached the host."""
        return fl.event is None or fl.event.query()

    def _collect(self, fl: InFlight) -> None:
        """Wait for one in-flight dispatch and materialize its Responses.

        Overlap accounting: of the window ``t_issue -> collection start``,
        only the part the host spent on other work counts as overlapped;
        stalls inside OTHER batches' collects (tracked via ``_blocked_s``
        snapshots) are subtracted.  An issue never waits for the device,
        so this batch's remaining device time is its own blocked wait."""
        t_wait0 = self.clock()
        if fl.event is not None:
            fl.event.synchronize()
        t_done = self.clock()
        blocked_elsewhere = self._blocked_s - fl.blocked_snapshot
        overlapped = max(0.0, (t_wait0 - fl.t_issue) - blocked_elsewhere)
        self._blocked_s += t_done - t_wait0
        batch = fl.batch
        sums_t, preds_t = fl.sums, fl.preds
        if fl.layout is not None:
            # A partitioned read: gather every rank's block on the host,
            # then vote.
            mesh, pls, rows = fl.layout
            t_gather = time.perf_counter()
            whole = sharding.assemble(sums_t.movedim(0, rows), mesh, pls)
            self._gather_s += time.perf_counter() - t_gather
            sums_t, preds_t = self._reduce(whole, fl.mask)
        # Only the valid rows, copied out of the host slot: the slot is
        # reused, and no Response may hold page-locked memory.
        n = batch.n_valid
        preds = preds_t.numpy()[:n].copy()
        sums = sums_t.numpy()[:n].copy()
        if fl.shadow_preds is not None:       # canary batch: score the
            # stable pool's argmax on the valid rows
            agree = int((preds == fl.shadow_preds.numpy()[:n]).sum())
            self.metrics.note_canary(n, agree)
        if fl.slot is not None:
            self._free_slots.append(fl.slot)
        records = []
        for row, req in enumerate(batch.requests):
            if req.rid in self._discard:
                self._discard.discard(req.rid)
            else:
                self._results[req.rid] = Response(
                    rid=req.rid, pred=int(preds[row]),
                    class_sums=sums[row], replica=fl.replica,
                    latency_s=t_done - req.t_enqueue, version=fl.version)
            records.append(RequestRecord(
                rid=req.rid, t_enqueue=req.t_enqueue,
                t_dispatch=fl.t_dispatch, t_done=t_done,
                bucket=batch.bucket, n_valid=batch.n_valid,
                replica=fl.replica, version=fl.version, qos=req.qos))
        # Pad rows are dropped by construction: only batch.requests rows
        # produce Responses.
        self.metrics.record_batch(records, batch.bucket, batch.nbytes,
                                  resident_nbytes=fl.resident_nbytes)
        self.metrics.note_dispatch_timing(
            pack_s=batch.pack_s, wait_s=t_done - t_wait0,
            overlapped_s=overlapped)

    # ------------------------------------------------------------ hot swap

    @property
    def version(self) -> int:
        """Model generation of the serving pool."""
        return self.pool.version

    @property
    def canary_active(self) -> bool:
        return self._canary is not None

    def quiesce(self) -> None:
        """Wait until no dispatch is in flight.  Queued requests stay
        queued: quiescing is a barrier between dispatches, not a drain."""
        self._collect_pending()

    def install_pool(self, pool, *, kind: str = "swap") -> None:
        """Install a new pool version between dispatches, atomically.

        In-flight dispatches are collected first (they complete at their
        issue-time version); then pool, state and routes are replaced in
        one step and the next issue serves the new version.  Nothing
        queued is dropped.  The new pool must be hot-compatible (same pool
        kind, replica count, model shape and static configs), because
        backend selection was made once at construction and is kept, with
        the routing counters, metrics and the serving generator.  An armed
        canary is disarmed; the health probe is re-committed against the
        new clean model.  ``kind`` labels the swap event ("swap",
        "promote", "rollback", "repair")."""
        old = self.pool
        if type(pool) is not type(old):
            raise ValueError(
                f"install_pool: pool type changed "
                f"({type(old).__name__} -> {type(pool).__name__}); "
                "build a new engine instead")
        if pool.n_replicas != old.n_replicas:
            raise ValueError(
                f"install_pool: n_replicas changed ({old.n_replicas} -> "
                f"{pool.n_replicas}); the router and the vote mask are "
                "sized to the pool — build a new engine instead")
        old.check_compatible(pool)
        pool = self._place(pool.to(self.device))
        self.quiesce()
        self._set_pool(pool)
        self.disarm_canary()
        if self.health is not None:
            # Deterministic, so a same-model install (a repair)
            # re-commits the same expected answers.
            self.health = HealthProbe.commit(self.pool, self.tm_cfg,
                                             self.health.hcfg)
        self.metrics.note_swap(old.version, pool.version, kind)

    def arm_canary(self, state, version: int, fraction: float) -> None:
        """Mount a candidate single-chip state beside the stable pool.

        While armed, a deterministic ``fraction`` of batches are served by
        ``state`` (``Response.replica == CANARY``, ``Response.version ==
        version``) and shadow-read on the stable pool; the agreement tally
        lands in ``ServeMetrics``.  ``state`` is brought to the serving
        wire format here; it must be a route of a pool with this engine's
        shapes and configs (``serve/swap.py`` builds it)."""
        if not (0.0 < fraction <= 1.0):
            raise ValueError(f"canary fraction must be in (0, 1], "
                             f"got {fraction}")
        self._canary = _Canary(state=self._wire_format(state),
                               version=int(version),
                               fraction=float(fraction))
        self._canary_acc = 0.0

    def disarm_canary(self) -> None:
        self._canary = None
        self._canary_acc = 0.0

    # ------------------------------------------------- health + self-healing

    @property
    def quarantined(self) -> List[int]:
        """Replica indices currently masked out of routing/voting."""
        return sorted(self.router.quarantined)

    def enable_health(self, hcfg: Optional[HealthConfig] = None) -> None:
        """Commit probe rows + known-good answers for this pool's clean
        model, and seed the health noise stream (``hcfg.seed + 1``)."""
        hcfg = hcfg if hcfg is not None else HealthConfig()
        self.health = HealthProbe.commit(self.pool, self.tm_cfg, hcfg)
        self._health_generator = torch.Generator(
            device=self.device).manual_seed(hcfg.seed + 1)

    def _health_read_generator(self) -> Optional[torch.Generator]:
        """The probe reads' noise stream: never the serving one."""
        return None if self._noise_free else self._health_generator

    def inject_faults(self, generator: torch.Generator,
                      fcfg: Optional[FaultConfig] = None,
                      replicas: Optional[Sequence[int]] = None) -> None:
        """Chaos surface: bake persistent device faults into the serving
        pool (``fcfg``, default the pool's ``vcfg.fault``; the chips
        ``replicas``, default all), re-pack its state and meter the event.
        Quiesces first, so the swap is batch-atomic.  The pool version
        stays (the model did not change); a nominal or missing ``fcfg`` is
        a no-op.  ``generator`` must live on the engine's device."""
        pool = self.pool.inject_faults(generator, fcfg, replicas=replicas)
        if pool is self.pool:
            return
        self.quiesce()
        self._set_pool(self._place(pool))
        self.metrics.note_fault_injection(
            None if replicas is None else sorted(int(r) for r in replicas))

    def probe(self, probe: Optional[HealthProbe] = None) -> Dict[int, float]:
        """Score every replica against the committed probe set and apply
        quarantine / readmit.

        Each chip reads the probe rows through the serving backend (same
        bucket shapes, the packed wire if serving uses it), one forward
        per chunk and chip, with one draw of the health stream per chunk
        shared by all chips (its state replayed), so the chips differ only
        by their programmed arrays.  Row-exact agreement of a chip's class
        sums with the digital reference is its health.  Chips below
        ``quarantine_threshold`` leave routing and the vote; quarantined
        chips at or above ``readmit_threshold`` come back; the last
        healthy chip is never quarantined.  The scores land in
        ``summary()['replica_health']``."""
        if probe is None:
            if self.health is None:
                self.enable_health()
            probe = self.health
        self.quiesce()
        n_rep = self.pool.n_replicas
        mb = self.batcher.cfg.max_batch
        sums: List[List[torch.Tensor]] = [[] for _ in range(n_rep)]
        for start in range(0, probe.n_probes, mb):
            chunk = probe.x[start:start + mb]
            bucket = self.batcher.cfg.bucket_for(len(chunk))
            if self.packed_io:
                rows = np.stack([pack_request_np(r) for r in chunk])
            else:
                rows = np.asarray(chunk, np.uint8)
            if bucket > len(chunk):
                pad = np.zeros((bucket - len(chunk), rows.shape[1]),
                               rows.dtype)
                rows = np.concatenate([rows, pad], axis=0)
            lits = self._device_lits(rows, self.packed_io)
            generator = self._health_read_generator()
            replay = None if generator is None else generator.get_state()
            for i in range(n_rep):
                if replay is not None:
                    generator.set_state(replay)
                s, _ = self._forward(self._slices[i], lits, generator,
                                     self._mask_one)
                sums[i].append(s[:len(chunk)])
        health = {i: probe.score(torch.cat(sums[i]).cpu().numpy())
                  for i in range(n_rep)}
        self._apply_health(health, probe)
        return health

    def _apply_health(self, health: Dict[int, float],
                      probe: HealthProbe) -> None:
        """Turn probe scores into quarantine / readmit transitions."""
        self.metrics.note_health(health)
        actions = probe.classify(health, self.router.quarantined)
        for i, act in actions.items():
            if act == "quarantine":
                if self.router.healthy_replicas() == [i]:
                    # Floor: degrading to zero chips would halt serving;
                    # the held chip keeps serving, and the event says so.
                    self.metrics.note_quarantine(i, health[i],
                                                 "held_last_healthy")
                    continue
                self.router.quarantine(i)
                self.metrics.note_quarantine(i, health[i], "quarantine")
            elif act == "readmit":
                self.router.readmit(i)
                self.metrics.note_quarantine(i, health[i], "readmit")
        self._refresh_healthy_mask()

    def _refresh_healthy_mask(self) -> None:
        """The ``[R]`` vote mask on the device, rebuilt only when the
        quarantine set changes (never per dispatch)."""
        mask = torch.ones(self.pool.n_replicas, dtype=torch.bool)
        for i in self.router.quarantined:
            if 0 <= i < len(mask):
                mask[i] = False
        if not bool(mask.any()):          # same floor as RouterState
            mask[:] = True
        self._healthy_mask_host = mask
        self._healthy_mask = mask.to(self.device)

    # ------------------------------------------------------------- metrics

    def summary(self, includes: Optional[int] = None) -> Dict:
        """Serving metrics + the crossbar's hardware figures of merit."""
        out = self.metrics.summary()
        out["replica_load_rows"] = list(self.router.rows_dispatched)
        out["routing"] = self.ecfg.routing
        out["pool_version"] = self.version
        out["canary_active"] = self.canary_active
        out["n_replicas"] = self.pool.n_replicas
        out["quarantined"] = self.quarantined
        out["backend"] = self.backend.name
        out["backend_preferred"] = self.selection.preferred
        out["packed_io"] = self.packed_io
        out["plane_packed"] = bool(self.state.plane_packed)
        out["sharded"] = bool(self.state.is_sharded)
        out["gather_s"] = self._gather_s
        out["agree_s"] = self._agree_s
        out["issue_s"] = self._issue_s
        out["mesh"] = (sharding.mesh_shape(self.mesh)
                       if self.mesh is not None else None)
        out["resident_nbytes_full"] = self._resident_full
        out["resident_nbytes_slice"] = self._resident_slice
        out["device"] = str(self.device)
        out["bucket_sizes"] = list(self.batcher.cfg.bucket_sizes)
        out["buckets_tuned_for"] = self.batcher.cfg.tuned_for
        out["kernel_tiles"] = dict(self._kernel_opts.get("tiles", {}))
        out["shape_key"] = self.shape_key
        out["tuning_lazy"] = bool((self.tuning or {}).get("lazy"))
        if includes is None:
            includes = int(self.pool.include.sum())
        out["hardware"] = hardware_figures(
            self.tm_cfg, includes, self.pool.n_replicas,
            ensemble=self.ecfg.routing == "ensemble")
        return out


class AsyncServeEngine(ServeEngine):
    """Double-buffered serving: overlap host batching with device compute.

    The construction surface, routing and per-seed noise stream of
    :class:`ServeEngine`; only the schedule changes.  ``_dispatch`` issues
    a batch (its launches and the device-to-host copies queued on the
    stream, an event behind them) and collects the oldest only once
    ``ecfg.max_in_flight`` issues are outstanding, a result is asked for,
    or the engine drains.  The generator draws in issue order, so on the
    same seed the Responses equal the synchronous engine's bit for bit."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if self.ecfg.max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        self._pending: Deque[InFlight] = deque()

    def _max_outstanding(self) -> int:
        return self.ecfg.max_in_flight

    @property
    def in_flight(self) -> int:
        """Issued-but-uncollected dispatches right now."""
        return len(self._pending)

    def _dispatch(self, batch: Batch) -> None:
        while len(self._pending) >= self.ecfg.max_in_flight:
            self._collect(self._pending.popleft())
        self._pending.append(self._issue(batch))

    def pump(self, force: bool = False) -> int:
        served = super().pump(force)
        # Collect the dispatches whose results already reached the host:
        # results land as early as the caller's loop allows, and idle time
        # between pumps is not counted as overlap.
        for _ in range(self._ready_everywhere()):
            self._collect(self._pending.popleft())
        return served

    def _ready_everywhere(self) -> int:
        """How many of the oldest pending dispatches have their results on
        the host, on every rank of a mesh of more than one (where a
        collect gathers, all ranks must collect together: one all-reduce
        agrees on the count)."""
        ready = 0
        while ready < len(self._pending) and \
                self._is_ready(self._pending[ready]):
            ready += 1
        if not self._multi_rank:
            return ready
        t0 = time.perf_counter()
        ready = sharding.all_min(ready)
        self._agree_s += time.perf_counter() - t0
        return ready

    def _collect_pending(self) -> None:
        while self._pending:
            self._collect(self._pending.popleft())
