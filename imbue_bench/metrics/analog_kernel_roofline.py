"""analog_kernel_roofline: the plane-packed analog kernel
(``kernels/csrc/imbue_infer_planes.cu`` on ``imbue_core.cuh``): its least
time at the call's shapes (``counts.analog_planes``) over its device time
a call, in %."""

from imbue_bench import counts

KERNEL = r"core_kernel<.*PlaneSource"


def read(ctx):
    ops = ctx.trace.kernels(KERNEL)
    calls = ctx.counters["calls"]
    if not ops or not calls:
        return None
    s = ctx.shape
    least = counts.bound_s(*counts.analog_planes(
        s["rows"], s["replicas"], s["clauses"], s["literals"], s["classes"]))
    return 100.0 * least / (ctx.trace.device_s(ops) / calls)
