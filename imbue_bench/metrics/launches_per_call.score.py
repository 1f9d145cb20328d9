"""launches_per_call.score: device kernels launched a scoring call."""


def read(ctx):
    calls = ctx.counters["calls"]
    kernels = ctx.trace.kernels()
    if not kernels or not calls:
        return None
    return len(kernels) / calls
