"""train_device_ms: device milliseconds of operations a training step."""


def read(ctx):
    steps = ctx.counters["steps"]
    if not ctx.trace.device_ops or not steps:
        return None
    return ctx.trace.device_s() * 1e3 / steps
