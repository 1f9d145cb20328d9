"""The IMBUE serving engine: requests in, deadline-batched analog reads out
(port of the synchronous ``repro.serve.engine.ServeEngine``).

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
``[B, M]`` sums and ensemble routing reduces to the argmax.

The backend is selected once at construction, down the reference's
ladder: ``analog-cuda-packed2`` for a plane-packed state (the default),
``analog-cuda-packed`` with ``EngineConfig(pack_planes=False)``,
``analog-cuda`` with ``EngineConfig(packed=False)``.  A fallback (e.g. a
``csa_offset`` pool, which the kernels do not model, going to
``analog-torch``) warns and is counted per dispatch in ``ServeMetrics``.
The engine is synchronous: ``pump()`` cuts and dispatches every due
batch, and each dispatch is collected before the next.  An injectable
``clock`` makes deadline behaviour deterministic under test, and every
analog read draws its noise from one engine-owned ``torch.Generator``.

``inject_faults`` (the chaos surface) hurts the serving pool in place,
between dispatches, and re-packs its state: a nominal plane-packed pool
grows a deviation plane.  The asynchronous engine (CUDA streams and
events), canary, hot swap and health probes come with later slices.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import api
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.api.registry import CAP_PACKED_IO, CAP_PACKED_PLANES
from repro_torch.core import tm
from repro_torch.core.coalesced import CoalescedConfig
from repro_torch.core.imbue import IMBUEConfig
from repro_torch.core.tm import TMConfig
from repro_torch.core.variations import (FaultConfig, VariationConfig,
                                         split_generator)
from repro_torch.serve.batching import (QOS_BULK, Batch, BatcherConfig,
                                        DynamicBatcher, QueueFull,
                                        validate_qos)
from repro_torch.serve.metrics import (RequestRecord, ServeMetrics,
                                       hardware_figures)
from repro_torch.serve.replica import (CoalescedPool, ReplicaPool,
                                       RouterState, ensemble_vote,
                                       program_replica_pool)

ENSEMBLE = -1      # Response.replica value when every chip voted
EXPIRED = -3       # Response.replica value when the deadline expired queued

# The default backend preferences, the reference's ladder: the
# plane-packed kernel when the pool state is plane-packed (the default),
# the packed-literal kernel when it is packed, else the dense kernel.
# Capability selection overrides each when the pool's noise model needs
# physics the kernels do not implement.
DEFAULT_BACKEND = "analog-cuda"
DEFAULT_PACKED_BACKEND = "analog-cuda-packed"
DEFAULT_PLANES_BACKEND = "analog-cuda-packed2"
# Coalesced pools get the same ladder in their own family.
DEFAULT_COALESCED_BACKEND = "coalesced-cuda"
DEFAULT_COALESCED_PACKED_BACKEND = "coalesced-cuda-packed"
DEFAULT_COALESCED_PLANES_BACKEND = "coalesced-cuda-packed2"


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
    # Backend *preference* (registry name); None -> the default above.
    backend: Optional[str] = None
    # Queued-but-undispatched requests held before submit() raises
    # QueueFull (None = unbounded).
    max_queue_depth: Optional[int] = None


@dataclasses.dataclass
class Response:
    """One served prediction."""

    rid: int
    pred: int
    class_sums: np.ndarray           # [M] (summed over chips in ensemble)
    replica: int                     # serving chip, ENSEMBLE or EXPIRED
    latency_s: float
    version: int = 0                 # pool model generation that served it
    expired: bool = False            # deadline elapsed while queued


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
    ):
        self.device = resolve_device(device)
        pool = pool.to(self.device)
        self.tm_cfg = tm_cfg     # a CoalescedConfig for a coalesced pool
        self.ecfg = ecfg
        self.clock = clock
        self.metrics = ServeMetrics()
        self.router: RouterState = pool.router()
        self.state = self._state_of(pool)
        self._generator = (generator if generator is not None else
                           torch.Generator(device=self.device).manual_seed(0))
        self._noise_free = not (pool.vcfg.c2c or pool.vcfg.csa_offset)
        # Capability selection, once: the noise model is static per engine.
        sel_gen = None if self._noise_free else self._generator
        if isinstance(self.state, api.CoalescedState):
            default = (DEFAULT_COALESCED_PLANES_BACKEND
                       if self.state.plane_packed
                       else DEFAULT_COALESCED_PACKED_BACKEND
                       if self.state.packed
                       else DEFAULT_COALESCED_BACKEND)
        else:
            default = (DEFAULT_PLANES_BACKEND if self.state.plane_packed
                       else DEFAULT_PACKED_BACKEND if self.state.packed
                       else DEFAULT_BACKEND)
        self.selection: api.Selection = api.select_backend(
            self.state, generator=sel_gen, prefer=ecfg.backend or default)
        self.backend: api.Backend = self.selection.backend
        if self.selection.fell_back:
            warnings.warn(
                f"serve backend fallback: {self.selection.fallback_reason} "
                "(noise semantics differ from the preferred backend; see "
                "engine.summary()['forward_fallbacks'])", stacklevel=2)
        # Wire format follows the SELECTED backend: a fallback off the
        # packed kernel also falls back to the dense uint8 queue.
        self.packed_io = CAP_PACKED_IO in self.backend.capabilities
        self.batcher = DynamicBatcher(ecfg.batcher, packed=self.packed_io)
        self._set_pool(pool, self.state)
        self._mask_one = torch.ones(1, dtype=torch.bool, device=self.device)
        self._next_rid = 0
        self._submitted: List[int] = []
        self._results: Dict[int, Response] = {}
        self._taken: set = set()
        self._discard: set = set()

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
    ) -> "ServeEngine":
        """Program a fresh pool from TA state and wrap an engine; ``seed``
        feeds one generator, split into a programming and a serving
        stream."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        g_prog, g_serve = split_generator(gen, 2)
        include = tm.include_mask(ta_state.to(device), tm_cfg)
        pool = program_replica_pool(include, g_prog, n_replicas, vcfg, icfg)
        return cls(pool, tm_cfg, ecfg, generator=g_serve, clock=clock,
                   device=device)

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
    ) -> "ServeEngine":
        """Serve a coalesced model: one shared clause pool, the weighted
        digital tail as the combine matrix.  The engine surface is
        unchanged; the pool behind it is a single-chip
        :class:`~repro_torch.serve.replica.CoalescedPool`."""
        device = resolve_device(device)
        pool = CoalescedPool(ta_state=torch.as_tensor(ta_state).to(device),
                             weights=torch.as_tensor(weights).to(device),
                             cfg=cfg)
        return cls(pool, cfg, ecfg, generator=generator, clock=clock,
                   device=device)

    def _state_of(self, pool):
        """The pool's backend state in this engine's wire format."""
        state = pool.state(self.tm_cfg)
        if self.ecfg.packed:
            state = state.pack()
            if self.ecfg.pack_planes:
                state = state.pack_planes()
        return state

    def _set_pool(self, pool, state=None) -> None:
        """Replace the serving pool, its state and the routed slices in one
        step, between dispatches.  Same shapes and static configs, so the
        selected backend stays."""
        state = self._state_of(pool) if state is None else state
        self.pool = pool
        self.state = state
        # Single-replica views for routed dispatch; a coalesced pool has
        # one shared chip, so every route lands on the full state.
        if hasattr(state, "replica_slice"):
            self._slices = [state.replica_slice(i)
                            for i in range(pool.n_replicas)]
        else:
            self._slices = [state] * pool.n_replicas
        self._refresh_resident_nbytes()

    def _refresh_resident_nbytes(self) -> None:
        """Per-dispatch resident operand bytes for the full state (ensemble)
        and one slice (routed), recomputed whenever the pool changes: an
        injury can grow a nominal plane-packed pool a deviation plane."""
        self._resident_full = _resident_model_nbytes(self.state,
                                                     self.backend)
        self._resident_slice = _resident_model_nbytes(self._slices[0],
                                                      self.backend)

    def inject_faults(self, generator: torch.Generator,
                      fcfg: Optional[FaultConfig] = None,
                      replicas: Optional[Sequence[int]] = None) -> None:
        """Chaos surface: bake persistent device faults into the serving
        pool (``fcfg``, default the pool's ``vcfg.fault``; the chips
        ``replicas``, default all), re-pack its state and meter the event.
        The synchronous engine has collected every dispatch before this
        runs, so the swap is batch-atomic.  The pool version stays (the
        model did not change); a nominal or missing ``fcfg`` is a no-op.
        ``generator`` must live on the engine's device."""
        pool = self.pool.inject_faults(generator, fcfg, replicas=replicas)
        if pool is self.pool:
            return
        self._set_pool(pool)
        self.metrics.note_fault_injection(
            None if replicas is None else sorted(int(r) for r in replicas))

    def _forward(self, state, lits: torch.Tensor,
                 generator: Optional[torch.Generator], mask: torch.Tensor):
        """Backend forward + prediction for one batch: ``[B, M]`` sums and
        ``[B]`` predictions (summed/voted over the healthy chips in
        ensemble mode)."""
        sums = self.backend.fn(state, lits, generator)   # [R, B, M] | [B, M]
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

    def _healthy_mask(self) -> torch.Tensor:
        """``[R]`` bool vote mask of the chips the router may use."""
        mask = torch.zeros(self.pool.n_replicas, dtype=torch.bool)
        mask[self.router.healthy_replicas()] = True
        return mask.to(self.device)

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
        self.batcher.submit(rid, x, self.clock(), deadline_s=deadline_s,
                            qos=qos)
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
            now = self.clock()
            self._reap_expired(now)
            batch = self.batcher.cut(now, force=force)
            if batch is None:
                return served
            self._dispatch(batch)
            served += batch.n_valid

    def drain(self) -> List[Response]:
        """Force-serve everything queued; responses in submission order
        (excluding those already consumed by :meth:`take` /
        :meth:`discard`)."""
        self.pump(force=True)
        return [self._results[rid] for rid in self._submitted
                if rid in self._results]

    def _prune_consumed(self) -> None:
        if self._taken:
            self._submitted = [r for r in self._submitted
                               if r not in self._taken]
            self._taken.clear()

    def result(self, rid: int) -> Optional[Response]:
        """The Response of ``rid`` (the synchronous engine has nothing in
        flight to collect, so this is :meth:`poll`)."""
        return self._results.get(rid)

    def poll(self, rid: int) -> Optional[Response]:
        """The Response if its batch has been served, else None."""
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
        still queued (the read still happens and is still metered)."""
        if self._results.pop(rid, None) is None:
            self._discard.add(rid)
        self._taken.add(rid)

    # ------------------------------------------------------------ dispatch

    def _read_generator(self) -> Optional[torch.Generator]:
        """The noise stream for one analog read (None when the pool is
        noise-free, keeping the nominal path generator-independent)."""
        return None if self._noise_free else self._generator

    def _dispatch(self, batch: Batch) -> None:
        """Serve one batch: one forward, collected before returning."""
        t_dispatch = self.clock()
        x = torch.from_numpy(batch.x.view(np.int32) if batch.packed
                             else batch.x).to(self.device)
        lits = x if batch.packed else tm.literals(x)
        generator = self._read_generator()
        if self.selection.fell_back:
            self.metrics.note_forward_fallback(
                self.selection.fallback_reason)
        if self.ecfg.routing == "ensemble":
            replica = ENSEMBLE
            sums, preds = self._forward(self.state, lits, generator,
                                        self._healthy_mask())
            # Only voting chips count as load.
            for i in self.router.healthy_replicas():
                self.router.note_dispatch(i, batch.bucket)
            resident = self._resident_full
        else:
            replica = self.router.pick(self.ecfg.routing)
            sums, preds = self._forward(self._slices[replica], lits,
                                        generator, self._mask_one)
            self.router.note_dispatch(replica, batch.bucket)
            resident = self._resident_slice
        t_wait0 = self.clock()
        sums = sums.cpu().numpy()                 # waits for the device
        preds = preds.cpu().numpy()
        t_done = self.clock()
        records = []
        for row, req in enumerate(batch.requests):
            if req.rid in self._discard:
                self._discard.discard(req.rid)
            else:
                self._results[req.rid] = Response(
                    rid=req.rid, pred=int(preds[row]),
                    class_sums=sums[row], replica=replica,
                    latency_s=t_done - req.t_enqueue,
                    version=self.pool.version)
            records.append(RequestRecord(
                rid=req.rid, t_enqueue=req.t_enqueue, t_dispatch=t_dispatch,
                t_done=t_done, bucket=batch.bucket, n_valid=batch.n_valid,
                replica=replica, version=self.pool.version, qos=req.qos))
        # Pad rows are dropped by construction: only batch.requests rows
        # produce Responses.
        self.metrics.record_batch(records, batch.bucket, batch.nbytes,
                                  resident_nbytes=resident)
        self.metrics.note_dispatch_timing(pack_s=batch.pack_s,
                                          wait_s=t_done - t_wait0,
                                          overlapped_s=0.0)

    # ------------------------------------------------------------- metrics

    @property
    def version(self) -> int:
        """Model generation of the serving pool."""
        return self.pool.version

    @property
    def quarantined(self) -> List[int]:
        """Replica indices currently masked out of routing/voting."""
        return sorted(self.router.quarantined)

    def summary(self, includes: Optional[int] = None) -> Dict:
        """Serving metrics + the crossbar's hardware figures of merit."""
        out = self.metrics.summary()
        out["replica_load_rows"] = list(self.router.rows_dispatched)
        out["routing"] = self.ecfg.routing
        out["pool_version"] = self.version
        out["n_replicas"] = self.pool.n_replicas
        out["quarantined"] = self.quarantined
        out["backend"] = self.backend.name
        out["backend_preferred"] = self.selection.preferred
        out["packed_io"] = self.packed_io
        out["plane_packed"] = bool(self.state.plane_packed)
        out["resident_nbytes_full"] = self._resident_full
        out["resident_nbytes_slice"] = self._resident_slice
        out["device"] = str(self.device)
        out["bucket_sizes"] = list(self.batcher.cfg.bucket_sizes)
        if includes is None:
            includes = int(self.pool.include.sum())
        out["hardware"] = hardware_figures(
            self.tm_cfg, includes, self.pool.n_replicas,
            ensemble=self.ecfg.routing == "ensemble")
        return out
