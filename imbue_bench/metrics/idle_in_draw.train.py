"""idle_in_draw.train: the share of the traced training window in which
the device is idle while the innermost open program span is
``repro_torch.tm_train.split`` or ``repro_torch.tm_train.draw``, in %."""

from imbue_bench import spans

DRAW = ("repro_torch.tm_train.split", "repro_torch.tm_train.draw")


def read(ctx):
    if not ctx.trace.device_ops:
        return None
    found = spans.program_spans(ctx.trace)
    if not any(name in DRAW for name, _, _ in found):
        return None
    idle = spans.idle_by_span(ctx.trace, found)
    return 100.0 * sum(idle[n] for n in DRAW) / (ctx.trace.window_s * 1e6)
