"""launches_per_step.train: device kernels launched a training step."""


def read(ctx):
    steps = ctx.counters["steps"]
    kernels = ctx.trace.kernels()
    if not kernels or not steps:
        return None
    return len(kernels) / steps
