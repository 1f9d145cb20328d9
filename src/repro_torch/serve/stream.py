"""Streaming inference front-end: per-session windows over the engine
(port of ``repro.serve.stream``).

The paper's KWS-6 workload is the always-on case for "program once, read
forever": frames arrive continuously, every hop completes one window of
recent frames, and each window is one classifier read.  This module is
that front-end over the existing dispatch path; it adds no device code:

  session.feed(frames) -> StreamingBooleanizer (the session's ring buffer;
                          one Boolean row per completed hop window)
                       -> ServeEngine.submit: the shared engine's batcher
                          packs rows from every live session into fused
                          dispatches (sync or async; nothing here is
                          stream-specific)
  server.pump()        -> engine.pump + per-session collection
  session decisions    -> per-window argmax (or class-sum margin),
                          smoothed by a majority vote over the session's
                          last ``vote`` windows

Sharing one engine is the point: S sessions at hop rate h feed the
batcher S*h rows/s, so dispatches run at real batch sizes though no
session alone would fill a bucket.

The invariant: at ``VariationConfig.nominal()`` a streamed session's
per-window predictions equal offline ``api.predict`` over
``StreamingBooleanizer.transform_offline`` of the same frames, for the
sync and the async engine and every routing; the smoothing is
deterministic on top.  Per-session latency and decisions/s land in
``ServeMetrics`` (``summary()["sessions"]``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional

import numpy as np

from repro_torch.core.booleanize import Booleanizer, StreamingBooleanizer
from repro_torch.serve.batching import QOS_BULK, QueueFull, validate_qos
from repro_torch.serve.engine import Response, ServeEngine

DECISION_MODES = ("argmax", "margin")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Windowing and smoothing knobs shared by a server's sessions."""

    window: int = 8          # frames per classifier read
    hop: int = 4             # frames between successive reads
    vote: int = 5            # majority-vote horizon (windows)
    # Decisions kept per session (oldest dropped first), so an always-on
    # session cannot grow host memory forever; counts and rates live on in
    # ServeMetrics.
    history: int = 4096
    # QoS class every window of a session submits under ("bulk" or
    # "latency"); StreamServer.session(sid, qos=...) overrides it.
    qos: str = QOS_BULK
    # Per-window decision rule.  "argmax": the class-sum argmax (KWS).
    # "margin": pred = margin_class iff the class-sum margin of
    # margin_class over the best other class is >= margin_threshold
    # (anomaly detection).  Post-dispatch arithmetic on
    # Response.class_sums only, so nominal exactness extends to margins.
    decision: str = "argmax"
    margin_class: int = 1
    margin_threshold: float = 0.0
    # Admission control: live sessions a StreamServer accepts (None =
    # unbounded); one more raises QueueFull.
    max_sessions: Optional[int] = None

    def __post_init__(self):
        if self.window < 1 or self.hop < 1 or self.vote < 1:
            raise ValueError("window, hop and vote must all be >= 1, got "
                             f"{self.window}/{self.hop}/{self.vote}")
        if self.history < 1:
            raise ValueError(f"history must be >= 1, got {self.history}")
        validate_qos(self.qos)
        if self.decision not in DECISION_MODES:
            raise ValueError(f"unknown decision mode {self.decision!r}; "
                             f"expected one of {DECISION_MODES}")
        if self.margin_class < 0:
            raise ValueError(f"margin_class must be >= 0, got "
                             f"{self.margin_class}")
        if self.max_sessions is not None and self.max_sessions < 1:
            raise ValueError(f"max_sessions must be >= 1, got "
                             f"{self.max_sessions}")


def margin_of(class_sums, margin_class: int) -> float:
    """Class-sum margin of ``margin_class`` over the best other class: the
    scalar the anomaly workload thresholds, and the offline reference a
    streamed margin is held to (from ``api.class_sums`` of the windows)."""
    sums = np.asarray(class_sums, dtype=np.int64)
    if not 0 <= margin_class < sums.shape[-1]:
        raise ValueError(f"margin_class {margin_class} out of range for "
                         f"{sums.shape[-1]} classes")
    others = np.delete(sums, margin_class, axis=-1)
    return float(sums[margin_class] - others.max())


def majority_vote(preds: Iterable[int]) -> int:
    """Most frequent class among ``preds``; ties go to the lowest class
    index (as ``replica.ensemble_vote``)."""
    counts = np.bincount(np.asarray(list(preds), dtype=np.int64))
    return int(counts.argmax())


@dataclasses.dataclass
class Decision:
    """One smoothed decision (one completed window)."""

    session: str
    index: int               # window index within the session's stream
    pred: int                # raw per-window decision
    keyword: int             # majority vote over the last ``votes`` windows
    votes: int               # windows that voted (<= StreamConfig.vote)
    latency_s: float         # window enqueue -> served (queue wait included)
    version: int = 0         # pool generation that served the window
    # The class-sum margin the decision thresholded (margin mode only).
    margin: Optional[float] = None


class StreamSession:
    """One client's stream over a shared serving engine.

    The session owns its ring buffer of recent frames (the
    ``StreamingBooleanizer``) and its vote deque; the engine is shared, so
    windows from many sessions batch together.  ``feed`` never waits on
    the device: rows are queued into the engine's batcher, and
    :meth:`collect` (or ``StreamServer.pump``) turns served windows into
    decisions.
    """

    def __init__(self, sid: str, engine: ServeEngine,
                 booleanizer: Booleanizer,
                 scfg: StreamConfig = StreamConfig()):
        self.sid = str(sid)
        self.engine = engine
        self.scfg = scfg
        self.windows = StreamingBooleanizer(booleanizer, scfg.window,
                                            scfg.hop)
        self._pending: Deque[int] = deque()      # submitted, undecided rids
        self._votes: Deque[int] = deque(maxlen=scfg.vote)
        self._n_decided = 0                      # lifetime decision count
        self.decisions: Deque[Decision] = deque(maxlen=scfg.history)

    @property
    def backlog(self) -> int:
        """Windows submitted but not yet decided."""
        return len(self._pending)

    @property
    def keyword(self) -> Optional[int]:
        """Latest smoothed keyword (None before the first decision)."""
        return self.decisions[-1].keyword if self.decisions else None

    def feed(self, frames) -> List[int]:
        """Push raw ``[T, F]`` frames; submits every window they complete
        under the session's QoS class.  Returns the request ids."""
        rids = [self.engine.submit(row, qos=self.scfg.qos)
                for row in self.windows.push(frames)]
        self._pending.extend(rids)
        return rids

    def _decide(self, resp: Response) -> tuple:
        """``(pred, margin)`` of one served window.  Margin mode: pred =
        ``margin_class`` iff its margin clears ``margin_threshold``, else
        the argmax over the other classes (original indexing).  An expired
        window keeps its -1."""
        if self.scfg.decision != "margin" or resp.expired:
            return int(resp.pred), None
        sums = np.asarray(resp.class_sums, dtype=np.int64)
        mc = self.scfg.margin_class
        margin = margin_of(sums, mc)
        if margin >= self.scfg.margin_threshold:
            return mc, margin
        others = np.delete(np.arange(sums.shape[-1]), mc)
        return int(others[sums[others].argmax()]), margin

    def collect(self) -> List[Decision]:
        """Turn already-served windows into decisions, in stream order.

        Never waits: ``engine.take`` polls and forgets, so an async
        engine's dispatches are not forced early and the engine's
        bookkeeping stays bounded.  Stops at the first window still queued
        or in flight, so the smoothing state stays deterministic.
        """
        out = []
        while self._pending:
            resp = self.engine.take(self._pending[0])
            if resp is None:
                break
            self._pending.popleft()
            pred, margin = self._decide(resp)
            self._votes.append(pred)
            d = Decision(session=self.sid, index=self._n_decided, pred=pred,
                         keyword=majority_vote(self._votes),
                         votes=len(self._votes), latency_s=resp.latency_s,
                         version=resp.version, margin=margin)
            self._n_decided += 1
            self.decisions.append(d)
            self.engine.metrics.note_decision(self.sid, resp.latency_s,
                                              self.engine.clock())
            out.append(d)
        return out

    def abandon_pending(self) -> None:
        """Give up every submitted, undecided window: the engine still
        serves and counts them but drops their Responses on arrival."""
        for rid in self._pending:
            self.engine.discard(rid)
        self._pending.clear()

    def reset(self) -> None:
        """Forget the stream, the votes and the decision history (window
        indices restart at 0); pending windows are abandoned."""
        self.windows.reset()
        self.abandon_pending()
        self._votes.clear()
        self.decisions.clear()
        self._n_decided = 0


class StreamServer:
    """Many sessions multiplexed onto one serving engine.

    ``session(sid)`` creates a :class:`StreamSession` on first use (all
    share the server's booleanizer and :class:`StreamConfig`), ``pump()``
    advances the engine and collects every session's served windows,
    ``drain()`` serves everything outstanding and collects it.  With
    ``StreamConfig.max_sessions`` set, a session beyond the limit raises
    :class:`QueueFull` (metered) until :meth:`close` frees a slot.
    """

    def __init__(self, engine: ServeEngine, booleanizer: Booleanizer,
                 scfg: StreamConfig = StreamConfig()):
        self.engine = engine
        self.booleanizer = booleanizer
        self.scfg = scfg
        self.sessions: Dict[str, StreamSession] = {}

    def session(self, sid: str, *, qos: Optional[str] = None,
                decision: Optional[str] = None) -> StreamSession:
        """Get or create a session.  ``qos`` / ``decision`` override the
        server's config for a NEW session only (changing a live session's
        would corrupt its votes and margins)."""
        sid = str(sid)
        if sid not in self.sessions:
            if (self.scfg.max_sessions is not None
                    and len(self.sessions) >= self.scfg.max_sessions):
                self.engine.metrics.note_rejected(
                    qos=qos if qos is not None else self.scfg.qos)
                raise QueueFull(
                    f"live sessions {len(self.sessions)} at "
                    f"max_sessions={self.scfg.max_sessions}; close() a "
                    "session or raise the limit")
            scfg = self.scfg
            if qos is not None or decision is not None:
                scfg = dataclasses.replace(
                    scfg, qos=qos if qos is not None else scfg.qos,
                    decision=(decision if decision is not None
                              else scfg.decision))
            self.sessions[sid] = StreamSession(sid, self.engine,
                                               self.booleanizer, scfg)
        return self.sessions[sid]

    def feed(self, sid: str, frames) -> List[int]:
        return self.session(sid).feed(frames)

    def close(self, sid: str) -> Optional[StreamSession]:
        """Retire a session: discard its pending windows and drop its
        registry and metrics entries, so session churn accumulates nothing.
        Returns the closed session (its decisions intact), or None."""
        sess = self.sessions.pop(str(sid), None)
        if sess is not None:
            sess.abandon_pending()
            self.engine.metrics.session_decisions.pop(str(sid), None)
        return sess

    def _collect(self) -> List[Decision]:
        out: List[Decision] = []
        for s in self.sessions.values():
            out.extend(s.collect())
        return out

    def pump(self) -> List[Decision]:
        """Cut and dispatch due batches, then collect served windows.
        Returns the new decisions of all sessions."""
        self.engine.pump()
        return self._collect()

    def drain(self) -> List[Decision]:
        """Serve everything queued or in flight, then collect."""
        self.engine.drain()
        return self._collect()

    def summary(self) -> Dict:
        """The engine's summary (with the per-session decision block)."""
        return self.engine.summary()
