"""Serving metrics: simulated latency/throughput + the paper's energy
figures of merit folded into one report (a copy of the numpy-only
``repro.serve.metrics``).

Two timebases coexist on purpose:

* **wall-clock** (simulation) — how fast this *simulator*
  serves requests on the host: queue wait, kernel time, p50/p95/p99,
  throughput, padding overhead, per-replica load.
* **hardware model** (``core/energy.py``) — what the physical crossbar
  would cost per datapoint: the 60 ns read cycle, nJ/datapoint and
  TopJ⁻¹ from Table II/IV calibration.  These depend on the model's
  include count and CSA count, not on host speed.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import energy
from repro_torch.core.mapping import csa_count_packed
from repro_torch.core.tm import TMConfig
from repro_torch.serve.batching import QOS_BULK


@dataclasses.dataclass
class RequestRecord:
    """Timing of one served request (simulation wall-clock seconds)."""

    rid: int
    t_enqueue: float
    t_dispatch: float
    t_done: float
    bucket: int
    n_valid: int
    replica: int
    version: int = 0        # pool model generation that served it
    qos: str = QOS_BULK     # QoS class that shaped its batching

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_enqueue

    @property
    def queue_wait_s(self) -> float:
        return self.t_dispatch - self.t_enqueue


def _percentile(sorted_vals: np.ndarray, q: float) -> float:
    """Nearest-rank percentile: smallest value with at least ``q`` of
    the sample at or below it, i.e. index ``ceil(q*n) - 1``.

    The previous ``int(round(q * (n - 1)))`` went through Python's
    banker's rounding, which lands on the wrong rank at even window
    sizes (n=4, q=0.5 -> round(1.5) -> index 2, the *third* order
    statistic, where the nearest-rank median is the second).
    """
    n = len(sorted_vals)
    if n == 0:
        return float("nan")
    i = min(n - 1, max(0, math.ceil(q * n) - 1))
    return float(sorted_vals[i])


class ServeMetrics:
    """Accumulates per-request records and batch accounting."""

    # Per-request records retained for latency percentiles: a recent
    # window, not the whole history — an always-on streaming deployment
    # serves millions of windows and must not grow host memory without
    # bound (counts/rates below use lifetime counters, not this window).
    RECORDS_WINDOW = 65536

    def __init__(self):
        self.records: Deque[RequestRecord] = deque(
            maxlen=self.RECORDS_WINDOW)
        self.n_requests = 0             # lifetime served-request count
        self.batches = 0
        self.padded_rows = 0
        self.valid_rows = 0
        self.bytes_moved = 0            # host->device operand bytes, total
        # Resident-model operand bytes the fused forward streamed from
        # HBM per dispatch: the conductance/include planes,
        # NOT the literal wire.  Plane-packed states collapse the two
        # dense f32 conductance+leak planes to a uint32 index bitplane
        # (+ an optional f32 deviation plane), so this is where the
        # packed-plane win shows up in serve_bench.
        self.resident_bytes = 0
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        # Capability-selection fallbacks (distinct reasons + count of
        # affected dispatches).  Non-empty means the serving path is NOT
        # the preferred backend — e.g. csa_offset forced the jnp path —
        # so noise semantics differ from the preference.  Loud on purpose.
        self.forward_fallbacks: List[str] = []
        self.fallback_dispatches = 0
        # Overlap accounting (async serving): per dispatch, how long the
        # host spent packing/bucketing the batch, how long it *blocked*
        # on the device at collection, and how much of the in-flight
        # window it spent on other host work.  A synchronous engine
        # collects immediately, so its overlapped_s is only the
        # bookkeeping between issue and collect.
        self.host_pack_s = 0.0
        self.device_wait_s = 0.0
        self.overlapped_s = 0.0
        # Live hot-swap accounting: which pool model
        # generation served each request, every swap/promote/rollback
        # event, and the canary comparison tallies.  ``canary_rows``
        # counts requests SERVED by the canary chip; each one is also
        # shadow-evaluated on the stable pool (same read key), and
        # ``canary_agree_rows`` counts argmax agreement — the promote /
        # roll-back evidence.
        self.requests_by_version: Dict[int, int] = {}
        self.swap_events: List[dict] = []
        self.canary_batches = 0
        self.canary_rows = 0
        self.canary_agree_rows = 0
        # Robustness accounting.  ``expired``/``rejected`` are
        # lifetime counters and ALWAYS appear in the summary — a zero is
        # the "nothing was dropped" evidence the chaos harness asserts
        # on, so it must not be elided.  ``replica_health`` holds the
        # latest probe round's per-chip agreement; quarantine/readmit
        # transitions and fault injections are audit-trail event lists
        # (bounded by operator/probe actions, not traffic).
        self.expired_requests = 0
        self.rejected_requests = 0
        self.replica_health: Dict[int, float] = {}
        self.probe_rounds = 0
        self.quarantine_events: List[dict] = []
        self.fault_injections: List[dict] = []
        # Per-QoS-class accounting: a bounded window of
        # (latency_s, queue_wait_s) pairs per class for percentiles,
        # plus lifetime served/rejected/expired counters.  The summary
        # block is elided while only the default ``bulk`` class has ever
        # been seen, so pre-QoS engines keep byte-identical summaries.
        self.qos_records: Dict[str, Deque[Tuple[float, float]]] = {}
        self.qos_counts: Dict[str, int] = {}
        self.qos_rejected: Dict[str, int] = {}
        self.qos_expired: Dict[str, int] = {}
        # Streaming sessions: per-session keyword-decision
        # aggregates — count, first/last decision clock time, and a
        # BOUNDED window of recent latencies (always-on sessions must
        # not grow metrics forever; the engine's request bookkeeping is
        # bounded for the same reason).  Window latency is the served
        # request's enqueue -> done span, so it includes queue wait:
        # the figure a streaming client feels.
        self.session_decisions: Dict[str, dict] = {}

    def note_forward_fallback(self, reason: str) -> None:
        """Record one dispatch served by a fallback backend."""
        self.fallback_dispatches += 1
        if reason not in self.forward_fallbacks:
            self.forward_fallbacks.append(reason)

    def note_swap(self, from_version: int, to_version: int,
                  kind: str = "swap") -> None:
        """Record one pool transition (``kind``: swap | promote |
        rollback).  The event list is the audit trail a deployment reads
        back after an incident — bounded by the number of swaps, which
        is operator-driven, not traffic-driven."""
        self.swap_events.append({"from_version": int(from_version),
                                 "to_version": int(to_version),
                                 "kind": str(kind)})

    def note_canary(self, rows: int, agree_rows: int) -> None:
        """Account one canary-served batch: ``rows`` valid requests, of
        which ``agree_rows`` matched the stable pool's argmax."""
        self.canary_batches += 1
        self.canary_rows += int(rows)
        self.canary_agree_rows += int(agree_rows)

    def canary_agreement(self) -> Optional[float]:
        """Canary-vs-stable argmax agreement so far (None before any
        canary traffic)."""
        if not self.canary_rows:
            return None
        return self.canary_agree_rows / self.canary_rows

    # Per-class percentile window: smaller than RECORDS_WINDOW (the
    # classes partition it) but big enough for a stable p99.
    QOS_WINDOW = 8192

    def _qos_window(self, qos: str) -> Deque[Tuple[float, float]]:
        win = self.qos_records.get(qos)
        if win is None:
            win = self.qos_records[qos] = deque(maxlen=self.QOS_WINDOW)
        return win

    def note_expired(self, n: int = 1, qos: Optional[str] = None) -> None:
        """Account ``n`` requests whose deadline elapsed while queued."""
        self.expired_requests += int(n)
        if qos is not None:
            self.qos_expired[qos] = self.qos_expired.get(qos, 0) + int(n)

    def note_rejected(self, n: int = 1, qos: Optional[str] = None) -> None:
        """Account ``n`` submissions refused by admission control."""
        self.rejected_requests += int(n)
        if qos is not None:
            self.qos_rejected[qos] = self.qos_rejected.get(qos, 0) + int(n)

    def note_health(self, health: Dict[int, float]) -> None:
        """Record one probe round's per-replica agreement scores."""
        self.probe_rounds += 1
        self.replica_health = {int(i): float(h) for i, h in health.items()}

    def note_quarantine(self, replica: int, health: float,
                        kind: str) -> None:
        """Record one quarantine transition (``kind``: quarantine |
        readmit | held_last_healthy)."""
        self.quarantine_events.append({"replica": int(replica),
                                       "health": float(health),
                                       "kind": str(kind)})

    def note_fault_injection(self, replicas: Optional[List[int]]) -> None:
        """Record one chaos fault injection (``replicas`` None = all)."""
        self.fault_injections.append({"replicas": replicas})

    def note_dispatch_timing(self, pack_s: float, wait_s: float,
                             overlapped_s: float) -> None:
        """Account one dispatch's host-pack time, blocked device wait,
        and the in-flight span that host work overlapped."""
        self.host_pack_s += max(0.0, pack_s)
        self.device_wait_s += max(0.0, wait_s)
        self.overlapped_s += max(0.0, overlapped_s)

    # Latency percentiles are computed over the most recent window of
    # decisions; counts/rates cover the whole stream.
    SESSION_LATENCY_WINDOW = 2048

    def note_decision(self, session: str, latency_s: float,
                      now: float) -> None:
        """Account one streamed keyword decision for ``session``."""
        rec = self.session_decisions.setdefault(str(session), {
            "n": 0, "t_first": float(now), "t_last": float(now),
            "recent": deque(maxlen=self.SESSION_LATENCY_WINDOW)})
        rec["n"] += 1
        rec["t_last"] = float(now)
        rec["recent"].append(float(latency_s))

    def sessions_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-session decision counts, decision rate, and latency.

        ``decisions_per_s`` is None (JSON null, never NaN — the summary
        must stay strict-JSON serializable) until a session has two
        decisions with a positive clock span."""
        out: Dict[str, Dict[str, float]] = {}
        for sid, rec in self.session_decisions.items():
            span = rec["t_last"] - rec["t_first"]
            lats = np.sort(np.asarray(rec["recent"])) * 1e3
            out[sid] = {
                "decisions": rec["n"],
                "decisions_per_s": ((rec["n"] - 1) / span
                                    if rec["n"] > 1 and span > 0 else None),
                "p50_ms": _percentile(lats, 0.50),
                "p95_ms": _percentile(lats, 0.95),
                "p99_ms": _percentile(lats, 0.99),
            }
        return out

    def overlap_fraction(self) -> float:
        """Of the dispatches' in-flight windows (end of issue to end of
        collect), the share the host spent on other work rather than
        blocked on the device: ``overlapped / (overlapped + blocked
        wait)``; -> 1 when the host never waits.  Device time that
        elapses while an issue is still launching is in neither term, so
        when the device keeps pace with the launches both terms are a
        few microseconds a dispatch and the synchronous engine's ratio
        says little: read ``device_wait_s`` beside it."""
        busy = self.overlapped_s + self.device_wait_s
        return self.overlapped_s / busy if busy > 0 else 0.0

    def record_batch(self, records: List[RequestRecord], bucket: int,
                     nbytes: int = 0, resident_nbytes: int = 0) -> None:
        """Account one dispatched batch; ``nbytes`` is the size of the
        literal operand that crossed host->device (the packed wire
        format shrinks this ~32x vs f32, ~8x vs uint8) and
        ``resident_nbytes`` the programmed-model operand bytes the
        kernel streamed from HBM for this dispatch (plane-packed states
        shrink this ~64x at nominal)."""
        self.records.extend(records)
        self.n_requests += len(records)
        self.batches += 1
        self.valid_rows += len(records)
        self.padded_rows += bucket - len(records)
        self.bytes_moved += int(nbytes)
        self.resident_bytes += int(resident_nbytes)
        for r in records:
            self.requests_by_version[r.version] = \
                self.requests_by_version.get(r.version, 0) + 1
            self._qos_window(r.qos).append((r.latency_s, r.queue_wait_s))
            self.qos_counts[r.qos] = self.qos_counts.get(r.qos, 0) + 1
        t0 = min(r.t_enqueue for r in records)
        t1 = max(r.t_done for r in records)
        self.t_first = t0 if self.t_first is None else min(self.t_first, t0)
        self.t_last = t1 if self.t_last is None else max(self.t_last, t1)

    # ------------------------------------------------------------ summaries

    def latency_ms(self) -> Dict[str, float]:
        """Latency percentiles over the retained (recent) records."""
        lats = np.sort([r.latency_s for r in self.records]) * 1e3
        return {"p50_ms": _percentile(lats, 0.50),
                "p95_ms": _percentile(lats, 0.95),
                "p99_ms": _percentile(lats, 0.99)}

    def queue_wait_ms(self) -> Dict[str, float]:
        """Queue-wait percentiles (enqueue -> dispatch) over the
        retained records — the tail that quarantine-induced degradation
        shows up in first (fewer chips, same traffic)."""
        waits = np.sort([r.queue_wait_s for r in self.records]) * 1e3
        return {"queue_p50_ms": _percentile(waits, 0.50),
                "queue_p95_ms": _percentile(waits, 0.95),
                "queue_p99_ms": _percentile(waits, 0.99)}

    def throughput(self) -> Optional[float]:
        """Served requests per second of simulation wall-clock.

        None (JSON null, never inf/NaN — the summary must stay
        strict-JSON serializable) until the served span is positive: a
        single dispatch landing within one clock tick has
        ``t_last == t_first`` and no meaningful rate.
        """
        if not self.n_requests or self.t_first is None:
            return None
        elapsed = self.t_last - self.t_first
        if elapsed <= 0:
            return None
        return self.n_requests / elapsed

    def qos_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-QoS-class served counts, latency and queue-wait
        percentiles (recent window), and rejected/expired counters."""
        out: Dict[str, Dict[str, float]] = {}
        classes = (set(self.qos_records) | set(self.qos_rejected)
                   | set(self.qos_expired))
        for qos in sorted(classes):
            win = self.qos_records.get(qos, ())
            lats = np.sort([lat for lat, _ in win]) * 1e3
            waits = np.sort([w for _, w in win]) * 1e3

            def pct(vals, q):
                # None, not NaN, for a class seen only via rejections:
                # the summary must stay strict-JSON serializable.
                return _percentile(vals, q) if len(vals) else None

            out[qos] = {
                "requests": self.qos_counts.get(qos, 0),
                "p50_ms": pct(lats, 0.50),
                "p95_ms": pct(lats, 0.95),
                "p99_ms": pct(lats, 0.99),
                "queue_p50_ms": pct(waits, 0.50),
                "queue_p95_ms": pct(waits, 0.95),
                "queue_p99_ms": pct(waits, 0.99),
                "rejected": self.qos_rejected.get(qos, 0),
                "expired": self.qos_expired.get(qos, 0),
            }
        return out

    def padding_overhead(self) -> float:
        """Fraction of dispatched kernel rows that were padding."""
        total = self.valid_rows + self.padded_rows
        return self.padded_rows / total if total else 0.0

    def summary(self) -> Dict[str, float]:
        out = {"requests": self.n_requests, "batches": self.batches,
               "throughput_rps": self.throughput(),
               "padding_overhead": self.padding_overhead(),
               "mean_batch": (self.valid_rows / self.batches
                              if self.batches else 0.0),
               "bytes_moved": self.bytes_moved,
               "bytes_per_dispatch": (self.bytes_moved / self.batches
                                      if self.batches else 0.0),
               "resident_bytes_moved": self.resident_bytes,
               "resident_bytes_per_dispatch": (
                   self.resident_bytes / self.batches
                   if self.batches else 0.0),
               "forward_fallbacks": list(self.forward_fallbacks),
               "fallback_dispatches": self.fallback_dispatches,
               "host_pack_s": self.host_pack_s,
               "device_wait_s": self.device_wait_s,
               "overlap_fraction": self.overlap_fraction(),
               # Always present (zeros = the no-drop evidence chaos
               # harnesses assert on), never elided like the optional
               # blocks below.
               "expired": self.expired_requests,
               "rejected": self.rejected_requests}
        sessions = self.sessions_summary()
        if sessions:                    # streaming only — keep plain
            out["sessions"] = sessions  # serving summaries noise-free
        # Per-class block only once a NON-default class has been seen
        # (served, rejected, or expired): bulk-only engines — i.e. every
        # pre-QoS caller — keep their summary keys unchanged.
        qos_classes = (set(self.qos_records) | set(self.qos_rejected)
                       | set(self.qos_expired))
        if qos_classes - {QOS_BULK}:
            out["qos"] = self.qos_summary()
        # Hot-swap blocks appear only once a swap or canary actually
        # happened — a plain always-v0 deployment keeps its summary
        # unchanged (and strictly JSON-serializable: int keys stringify).
        if self.swap_events or len(self.requests_by_version) > 1:
            out["requests_by_version"] = {
                str(v): n for v, n in sorted(
                    self.requests_by_version.items())}
            out["swaps"] = list(self.swap_events)
        if self.canary_batches:
            out["canary"] = {"batches": self.canary_batches,
                             "rows": self.canary_rows,
                             "agreement": self.canary_agreement()}
        # Health/fault blocks appear once probing or chaos actually
        # happened — a plain deployment's summary is unchanged.
        if self.probe_rounds:
            out["replica_health"] = {
                str(i): h for i, h in sorted(self.replica_health.items())}
            out["probe_rounds"] = self.probe_rounds
        if self.quarantine_events:
            out["quarantine_events"] = list(self.quarantine_events)
        if self.fault_injections:
            out["fault_injections"] = list(self.fault_injections)
        out.update(self.latency_ms())
        out.update(self.queue_wait_ms())
        return out


def hardware_figures(tm_cfg: TMConfig, includes: int,
                     n_replicas: int = 1,
                     ensemble: bool = False) -> Dict[str, float]:
    """The crossbar's per-datapoint figures of merit (host-independent).

    Routed pools send each datapoint to ONE chip: per-datapoint energy is
    single-chip and hardware throughput scales with R.  Ensemble pools
    read every datapoint on ALL chips: energy scales with R and the pool
    serves at single-chip throughput.
    """
    csas = csa_count_packed(tm_cfg.n_ta)
    e_dp = energy.imbue_energy_per_datapoint(includes, tm_cfg.n_ta,
                                             csas).total_j
    reads_per_dp = n_replicas if ensemble else 1
    chips_serving = 1 if ensemble else n_replicas
    return {
        "latency_ns": energy.inference_latency_s(csas) * 1e9,
        "energy_nj_per_dp": e_dp * 1e9 * reads_per_dp,
        "chip_energy_nj_per_read": e_dp * 1e9,
        "top_j_inv": energy.top_j_inv(tm_cfg.n_ta, e_dp),
        "program_energy_nj_per_chip":
            energy.programming_energy(includes, tm_cfg.n_ta) * 1e9,
        "ensemble_energy_nj_per_dp": e_dp * 1e9 * n_replicas,
        "pool_throughput_dps":
            chips_serving / energy.inference_latency_s(csas),
    }
