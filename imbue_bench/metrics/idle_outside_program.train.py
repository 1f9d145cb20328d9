"""idle_outside_program.train: the share of the traced training window in
which the device is idle while no program span is open (the harness's
own work between the program's calls), in %."""

from imbue_bench import spans


def read(ctx):
    if not ctx.trace.device_ops:
        return None
    found = spans.program_spans(ctx.trace)
    if not found:
        return None
    idle = spans.idle_by_span(ctx.trace, found)
    return 100.0 * idle[None] / (ctx.trace.window_s * 1e6)
