"""IMBUE serving in PyTorch: dynamic batching over a replica pool.

* ``batching`` — deadline-aware, QoS-classed request batching and the
  packed literal wire format;
* ``replica``  — the programmed ``ReplicaPool``, the shared
  ``CoalescedPool``, ``RouterState`` counters and ensemble voting;
* ``engine``   — the synchronous ``ServeEngine``;
* ``metrics``  — latency/throughput and the paper's energy figures.
"""

from repro_torch.serve.batching import (QOS_BULK, QOS_CLASSES, QOS_LATENCY,
                                        Batch, BatcherConfig, DynamicBatcher,
                                        NonBooleanInput, QueueFull, Request,
                                        validate_qos)
from repro_torch.serve.engine import (DEFAULT_BACKEND,
                                      DEFAULT_COALESCED_BACKEND,
                                      DEFAULT_COALESCED_PACKED_BACKEND,
                                      DEFAULT_COALESCED_PLANES_BACKEND,
                                      DEFAULT_PLANES_BACKEND, ENSEMBLE,
                                      EXPIRED, EngineConfig, Response,
                                      ServeEngine)
from repro_torch.serve.metrics import (RequestRecord, ServeMetrics,
                                       hardware_figures)
from repro_torch.serve.replica import (CoalescedPool, ReplicaPool,
                                       RouterState, ensemble_vote,
                                       program_replica_pool)

__all__ = [
    "QOS_BULK", "QOS_CLASSES", "QOS_LATENCY", "Batch", "BatcherConfig",
    "DynamicBatcher", "NonBooleanInput", "QueueFull", "Request",
    "validate_qos", "DEFAULT_BACKEND", "DEFAULT_COALESCED_BACKEND",
    "DEFAULT_COALESCED_PACKED_BACKEND", "DEFAULT_COALESCED_PLANES_BACKEND",
    "DEFAULT_PLANES_BACKEND", "ENSEMBLE", "EXPIRED", "EngineConfig",
    "Response", "ServeEngine", "RequestRecord", "ServeMetrics",
    "hardware_figures", "CoalescedPool", "ReplicaPool", "RouterState",
    "ensemble_vote", "program_replica_pool",
]
