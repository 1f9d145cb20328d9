"""call_p95_ms.digital: the nearest-rank 95th percentile of the digital
calls' latency, issue to predictions on the host, in the traced window."""

from imbue_bench.kinds.score import p95


def read(ctx):
    lat = ctx.counters.get("latencies_s")
    if not lat:
        return None
    return p95(lat) * 1e3
