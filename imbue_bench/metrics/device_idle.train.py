"""device_idle.train: the share of the traced training window in which no
operation ran on the device, in %."""


def read(ctx):
    if not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
