"""aux_device_ms.score: device milliseconds a scoring call spends outside
its main kernel (the analog or the digital one): the C2C pre-pass, the
literal build and packing, the vote and argmax, the copy of the
predictions."""

MAIN = r"core_kernel<.*PlaneSource|\bpacked_kernel\b"


def read(ctx):
    calls = ctx.counters["calls"]
    if not ctx.trace.device_ops or not calls:
        return None
    main = ctx.trace.device_s(ctx.trace.kernels(MAIN))
    return (ctx.trace.device_s() - main) * 1e3 / calls
