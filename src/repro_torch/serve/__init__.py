"""IMBUE serving in PyTorch: dynamic batching over a replica pool.

* ``batching`` — deadline-aware, QoS-classed request batching and the
  packed literal wire format;
* ``replica``  — the programmed ``ReplicaPool``, the shared
  ``CoalescedPool``, ``RouterState`` counters and ensemble voting;
* ``engine``   — ``ServeEngine`` (issue, then collect at once) and
  ``AsyncServeEngine`` (up to ``max_in_flight`` issues outstanding, on
  CUDA events), with hot install, canary dispatch and health probes;
* ``health``   — committed probe rows with digital-reference answers,
  scored per replica into quarantine / readmit decisions;
* ``swap``     — snapshot -> canary -> promote / rollback over a live
  engine, and the ``RepairPolicy`` self-healing loop;
* ``metrics``  — latency/throughput and the paper's energy figures;
* ``stream``   — per-session sliding windows over a shared engine
  (``StreamServer``), argmax or margin decisions smoothed by a vote.
"""

from repro_torch.serve.batching import (QOS_BULK, QOS_CLASSES, QOS_LATENCY,
                                        Batch, BatcherConfig, DynamicBatcher,
                                        NonBooleanInput, QueueFull, Request,
                                        validate_qos)
from repro_torch.serve.engine import (CANARY, DEFAULT_BACKEND,
                                      DEFAULT_COALESCED_BACKEND,
                                      DEFAULT_COALESCED_PACKED_BACKEND,
                                      DEFAULT_COALESCED_PLANES_BACKEND,
                                      DEFAULT_PACKED_BACKEND,
                                      DEFAULT_PLANES_BACKEND, ENSEMBLE,
                                      EXPIRED, AsyncServeEngine,
                                      EngineConfig, InFlight, Response,
                                      ServeEngine)
from repro_torch.serve.health import HealthConfig, HealthProbe, probe_replicas
from repro_torch.serve.metrics import (RequestRecord, ServeMetrics,
                                       hardware_figures)
from repro_torch.serve.replica import (CoalescedPool, ReplicaPool,
                                       RouterState, ensemble_vote,
                                       program_replica_pool)
from repro_torch.serve.swap import (HotSwapper, RepairConfig, RepairPolicy,
                                    SwapConfig, hot_swap, reprogrammed_pool,
                                    restore_pool, snapshot_pool)
from repro_torch.serve.stream import (DECISION_MODES, Decision,
                                      StreamConfig, StreamServer,
                                      StreamSession, majority_vote,
                                      margin_of)

__all__ = [
    "QOS_BULK", "QOS_CLASSES", "QOS_LATENCY", "Batch", "BatcherConfig",
    "DynamicBatcher", "NonBooleanInput", "QueueFull", "Request",
    "validate_qos", "CANARY", "DEFAULT_BACKEND", "DEFAULT_COALESCED_BACKEND",
    "DEFAULT_COALESCED_PACKED_BACKEND", "DEFAULT_COALESCED_PLANES_BACKEND",
    "DEFAULT_PACKED_BACKEND", "DEFAULT_PLANES_BACKEND", "ENSEMBLE",
    "EXPIRED", "AsyncServeEngine", "EngineConfig", "InFlight", "Response",
    "ServeEngine", "HealthConfig", "HealthProbe", "probe_replicas",
    "RequestRecord", "ServeMetrics", "hardware_figures", "CoalescedPool",
    "ReplicaPool", "RouterState", "ensemble_vote", "program_replica_pool",
    "HotSwapper", "RepairConfig", "RepairPolicy", "SwapConfig", "hot_swap",
    "reprogrammed_pool", "restore_pool", "snapshot_pool",
    "DECISION_MODES", "Decision", "StreamConfig", "StreamServer",
    "StreamSession", "majority_vote", "margin_of",
]
