"""Deadline-aware dynamic batching for the IMBUE serving engine (a copy
of the numpy-only ``repro.serve.batching``, with its own ``WORD`` and
``words_for``; words stay numpy ``uint32`` here and become the port's
int32 bit patterns at dispatch).

Individual requests queue up; a batch is cut when either (a) enough
requests are waiting to fill the largest bucket, or (b) the oldest
request's batching deadline expires.  Cut batches are padded up to the
smallest *bucket* that fits — multiples of 8 up to ``max_batch`` (128
by default) — so the batch shapes a kernel sees stay few and bounded.
An explicit ``bucket_sizes`` tuple sets the ladder; the measured
per-backend ladders of the reference's tuning table
(``BatcherConfig.with_tuned_buckets``) come with the port's autotuner in
a later slice.

The batcher owns the **wire format**: in packed mode (the packed_io
backends) each request's Boolean features are packed ONCE at submit time
into the 32-bit literal bitplane (``[ceil(2F/32)]`` words), so the queue
and every host->device transfer carry 32x less than f32 (8x less than
uint8) per literal.  Padding rows are zeros — a zero-packed row is a
valid "all literals 0" input, and pad results are dropped on unpad
(asserted), so a kernel bug can never silently alias a real request's
prediction.

**QoS classes**: every request carries a class — ``latency``
or ``bulk``.  The batcher keeps one FIFO queue per class and never mixes
classes in a batch: latency requests get a shorter batching deadline
(``latency_max_wait_s``, default ``max_wait_s / 4``) so they cut small
batches early, while bulk requests wait the full ``max_wait_s`` to ride
the largest bucket.  Cut priority goes to the latency class, but only
among *ready* queues — a ready bulk queue is cut on the very next pump
after its own deadline fires, so early latency cuts can delay bulk by at
most one dispatch, never starve it.  Admission control is also
per-class: ``queue_depth_for`` bounds each class independently on top of
the engine-level global depth.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

WORD = 32                      # bits per packed literal word


def words_for(n_bits: int) -> int:
    """Number of 32-bit words holding ``n_bits`` booleans."""
    return -(-n_bits // WORD)


STATIC_BUCKETS = (8, 16, 32, 64, 128)     # pre-autotuning fallback ladder

# QoS classes.  ``latency`` cuts early and is popped first among ready
# queues; ``bulk`` (the default, and the behaviour of every pre-QoS
# engine) waits out the full batching deadline to fill large buckets.
QOS_LATENCY = "latency"
QOS_BULK = "bulk"
QOS_CLASSES: Tuple[str, ...] = (QOS_LATENCY, QOS_BULK)


def validate_qos(qos: str) -> str:
    if qos not in QOS_CLASSES:
        raise ValueError(f"unknown QoS class {qos!r}; expected one of "
                         f"{QOS_CLASSES}")
    return qos


class QueueFull(RuntimeError):
    """Typed admission-control rejection: raised by
    ``ServeEngine.submit`` when ``EngineConfig.max_queue_depth`` queued
    requests are already waiting, or when the request's QoS
    class is at its per-class depth limit / a ``StreamServer`` is at
    ``max_sessions``.  Callers catch it to shed load or retry after a
    ``pump()``; every raise is metered (``summary()['rejected']``)."""


class NonBooleanInput(ValueError):
    """Typed rejection for request features outside {0, 1}.

    ``pack_request_np`` builds the complement plane with
    ``np.subtract(1, x)`` in uint8, which WRAPS for ``x > 1`` (x=2 ->
    255) so after packbits both the literal and its complement read as
    1 — silent corruption.  Instead of thresholding (which would make
    packed and unpacked paths disagree), non-Boolean inputs are rejected
    at submit on BOTH paths with this error.
    """


def _check_boolean(x: np.ndarray) -> None:
    """Reject features outside {0, 1} before they hit the wire format."""
    if x.size and ((x != 0) & (x != 1)).any():
        bad = x[(x != 0) & (x != 1)].flat[0]
        raise NonBooleanInput(
            f"request features must be Boolean (0/1); got value {bad!r} — "
            "booleanize inputs (repro.data.booleanize) before submit")


def pack_request_np(x: np.ndarray) -> np.ndarray:
    """``[F]`` Boolean features -> ``[ceil(2F/32)]`` uint32 literal words.

    Builds the literal vector (features then complements, matching
    ``repro.core.tm.literals``) and packs it host-side — called once per
    request at submit, never per dispatch, so it is written to minimize
    per-call temporaries (one zeroed word-aligned buffer, one packbits).
    Raises :class:`NonBooleanInput` for values outside {0, 1}: the uint8
    complement ``1 - x`` wraps for x > 1, which would silently pack both
    planes as 1.
    """
    arr = np.asarray(x)
    _check_boolean(arr)
    x = arr.astype(np.uint8, copy=False)
    f = x.shape[-1]
    buf = np.zeros(words_for(2 * f) * WORD, dtype=np.uint8)  # pad bits = 0
    buf[:f] = x
    np.subtract(1, x, out=buf[f:2 * f])
    return np.packbits(buf, bitorder="little").view("<u4")


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    """Knobs for the dynamic batcher."""

    max_batch: int = 128                # largest bucket
    max_wait_s: float = 2e-3            # batching deadline (bulk class)
    bucket_sizes: Tuple[int, ...] = STATIC_BUCKETS
    # True -> the engine may replace bucket_sizes with the measured
    # per-backend ladder from the registry tuning table (set by
    # for_max_batch; explicit bucket_sizes constructions keep theirs).
    auto_tune: bool = False
    # Name of the backend whose measured table produced bucket_sizes
    # (None for the static/hand-picked ladder).
    tuned_for: Optional[str] = None
    # Batching deadline for the latency class.  None -> max_wait_s / 4:
    # latency requests cut (small) batches early instead of waiting to
    # fill the big bucket.  Bulk always uses max_wait_s.
    latency_max_wait_s: Optional[float] = None
    # Per-class admission depth limits (None = only the engine-level
    # global max_queue_depth applies).  A full class rejects with
    # QueueFull naming the class, without touching the other class.
    latency_queue_depth: Optional[int] = None
    bulk_queue_depth: Optional[int] = None

    def __post_init__(self):
        sizes = tuple(sorted(self.bucket_sizes))
        object.__setattr__(self, "bucket_sizes", sizes)
        if not sizes:
            raise ValueError("need at least one bucket size")
        if sizes[-1] != self.max_batch:
            raise ValueError(
                f"largest bucket {sizes[-1]} must equal max_batch "
                f"{self.max_batch}")
        if any(s % 8 for s in sizes):
            raise ValueError("bucket sizes must be multiples of the f32 "
                             "sublane count (8)")
        if self.latency_max_wait_s is not None and \
                self.latency_max_wait_s <= 0:
            raise ValueError("latency_max_wait_s must be positive")
        for name in ("latency_queue_depth", "bulk_queue_depth"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"{name} must be >= 1")

    @classmethod
    def for_max_batch(cls, max_batch: int, **kw) -> "BatcherConfig":
        """Standard tile buckets up to ``max_batch`` (itself the top
        bucket, so any multiple of 8 up to 128 is a valid max).  Marks
        the config ``auto_tune`` so the engine swaps in the measured
        per-backend ladder once the backend is known."""
        buckets = tuple(b for b in STATIC_BUCKETS if b < max_batch)
        return cls(max_batch=max_batch,
                   bucket_sizes=buckets + (max_batch,), auto_tune=True,
                   **kw)

    def with_tuned_buckets(self, bucket_sizes: Sequence[int],
                           backend: str) -> "BatcherConfig":
        """This config with the measured ladder (capped at max_batch)."""
        tuned = tuple(b for b in sorted(bucket_sizes) if b < self.max_batch)
        return dataclasses.replace(self,
                                   bucket_sizes=tuned + (self.max_batch,),
                                   tuned_for=backend)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding ``n`` requests."""
        i = bisect.bisect_left(self.bucket_sizes, n)
        if i == len(self.bucket_sizes):
            raise ValueError(f"batch of {n} exceeds max_batch "
                             f"{self.max_batch}")
        return self.bucket_sizes[i]

    def wait_for(self, qos: str) -> float:
        """Batching deadline for ``qos`` relative to submit time."""
        if qos == QOS_LATENCY:
            return (self.max_wait_s / 4 if self.latency_max_wait_s is None
                    else self.latency_max_wait_s)
        return self.max_wait_s

    def queue_depth_for(self, qos: str) -> Optional[int]:
        """Per-class admission depth limit (None = unbounded)."""
        return (self.latency_queue_depth if qos == QOS_LATENCY
                else self.bulk_queue_depth)


@dataclasses.dataclass
class Request:
    """One queued inference request."""

    rid: int
    # [F] uint8 features, or [Lw] uint32 packed literal words (packed mode)
    x: np.ndarray
    t_enqueue: float
    deadline: float                     # absolute batching deadline
    # Absolute REQUEST deadline: past this instant a
    # still-queued request must not be dispatched — the engine reaps it
    # into an ``expired=True`` Response.  None = never expires.  The
    # batching ``deadline`` above shapes batch cutting; this one is a
    # client SLO.
    expiry: Optional[float] = None
    qos: str = QOS_BULK


@dataclasses.dataclass
class Batch:
    """A cut batch, padded to a bucketed kernel shape."""

    requests: List[Request]
    x: np.ndarray                       # [bucket, F] uint8 | [bucket, Lw] u32
    bucket: int
    packed: bool = False
    # Host time spent assembling this batch's operand (stack + pad) —
    # the per-dispatch "host pack" half of the overlap accounting.
    pack_s: float = 0.0
    qos: str = QOS_BULK                 # batches never mix QoS classes

    @property
    def n_valid(self) -> int:
        return len(self.requests)

    @property
    def n_padding(self) -> int:
        return self.bucket - len(self.requests)

    @property
    def nbytes(self) -> int:
        """Bytes this batch moves host->device per dispatch."""
        return int(self.x.nbytes)


class DynamicBatcher:
    """Per-QoS-class FIFO queues with deadline/size-triggered cutting.

    One deque per class; batches never mix classes.  All cut paths —
    ``cut`` with or without ``force`` — first move already-expired
    requests into an internal outbox drained by :meth:`reap_expired`, so
    a ``drain()`` can never dispatch a request whose client SLO has
    already passed.
    """

    def __init__(self, cfg: BatcherConfig = BatcherConfig(), *,
                 packed: bool = False):
        self.cfg = cfg
        self.packed = packed
        self._queues: Dict[str, Deque[Request]] = {
            q: deque() for q in QOS_CLASSES}
        self._expired_outbox: List[Request] = []

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def depth(self, qos: str) -> int:
        """Queued requests in one QoS class."""
        return len(self._queues[validate_qos(qos)])

    def submit(self, rid: int, x: np.ndarray, now: float,
               deadline_s: Optional[float] = None,
               qos: str = QOS_BULK) -> Request:
        """Queue one request; in packed mode the features are packed to
        literal words HERE (once), not at dispatch.  ``deadline_s`` is
        the request's expiry relative to ``now`` (see
        :attr:`Request.expiry`).  Raises :class:`NonBooleanInput` for
        features outside {0, 1} on both wire formats."""
        validate_qos(qos)
        if self.packed:
            row = pack_request_np(x)
        else:
            arr = np.asarray(x)
            _check_boolean(arr)
            row = arr.astype(np.uint8, copy=False)
        req = Request(rid=rid, x=row, t_enqueue=now,
                      deadline=now + self.cfg.wait_for(qos),
                      expiry=None if deadline_s is None
                      else now + deadline_s,
                      qos=qos)
        self._queues[qos].append(req)
        return req

    def _reap_into_outbox(self, now: float) -> None:
        """Move already-expired queued requests into the outbox (queue
        order of survivors preserved).  Called by every cut path so no
        cut — forced or not — can dispatch a request past its expiry."""
        for qos, q in self._queues.items():
            if any(r.expiry is not None and now >= r.expiry for r in q):
                self._expired_outbox.extend(
                    r for r in q if r.expiry is not None and now >= r.expiry)
                self._queues[qos] = deque(
                    r for r in q if r.expiry is None or now < r.expiry)

    def reap_expired(self, now: float) -> List[Request]:
        """Remove and return every queued request whose expiry has
        passed (including any a cut path already set aside).  A request
        already cut into a batch can no longer expire (dispatch wins
        races by design — the deadline guards *queue* time)."""
        self._reap_into_outbox(now)
        expired, self._expired_outbox = self._expired_outbox, []
        return expired

    def _ready_class(self, now: float) -> Optional[str]:
        """First class (latency priority) that is ready to cut: its
        queue fills the largest bucket, or its oldest request has hit
        its batching deadline."""
        for qos in QOS_CLASSES:            # latency first
            q = self._queues[qos]
            if q and (len(q) >= self.cfg.max_batch
                      or now >= q[0].deadline):
                return qos
        return None

    def ready(self, now: float) -> bool:
        """A batch should be cut from some class."""
        return self._ready_class(now) is not None

    def next_deadline(self) -> Optional[float]:
        heads = [q[0].deadline for q in self._queues.values() if q]
        return min(heads) if heads else None

    def cut(self, now: float, force: bool = False) -> Optional[Batch]:
        """Pop up to ``max_batch`` requests (FIFO, one class) into a
        padded batch.  Expired requests are reaped first — a forced
        drain returns them via :meth:`reap_expired`, never in a batch."""
        self._reap_into_outbox(now)
        qos = self._ready_class(now)
        if qos is None:
            if not force:
                return None
            qos = next((c for c in QOS_CLASSES if self._queues[c]), None)
            if qos is None:
                return None
        q = self._queues[qos]
        take = min(len(q), self.cfg.max_batch)
        reqs = [q.popleft() for _ in range(take)]
        return self.pad(reqs)

    def pad(self, reqs: Sequence[Request]) -> Batch:
        t0 = time.perf_counter()
        bucket = self.cfg.bucket_for(len(reqs))
        x = np.stack([r.x for r in reqs])
        if bucket > len(reqs):
            # Zero rows, NOT a replay of a real request: a pad row that
            # leaks through unpad must surface as an obviously-wrong
            # all-zero input rather than duplicating request 0's answer.
            fill = np.zeros((bucket - len(reqs), x.shape[1]), dtype=x.dtype)
            x = np.concatenate([x, fill], axis=0)
        return Batch(requests=list(reqs), x=np.ascontiguousarray(x),
                     bucket=bucket, packed=self.packed,
                     pack_s=time.perf_counter() - t0,
                     qos=reqs[0].qos if reqs else QOS_BULK)
