"""call_host_ms.score: host milliseconds a scoring call inside the
program's outermost spans (``repro_torch.tm.literals``,
``repro_torch.api.class_sums``, ``repro_torch.serve.ensemble_vote``)."""

from imbue_bench import spans


def read(ctx):
    calls = ctx.counters["calls"]
    if not ctx.trace.device_ops or not calls:
        return None
    found = spans.program_spans(ctx.trace)
    if not found:
        return None
    return spans.covered_us(found) / 1e3 / calls
