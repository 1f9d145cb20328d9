"""draw_host_ms.train: host milliseconds a training step inside the
program's ``repro_torch.tm_train.split`` and ``repro_torch.tm_train.draw``
spans (the per-example generators and their feedback draws)."""

from imbue_bench import spans

DRAW = ("repro_torch.tm_train.split", "repro_torch.tm_train.draw")


def read(ctx):
    steps = ctx.counters["steps"]
    if not ctx.trace.device_ops or not steps:
        return None
    found = spans.program_spans(ctx.trace, DRAW)
    if not found:
        return None
    return spans.covered_us(found) / 1e3 / steps
