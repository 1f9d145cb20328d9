"""tm_kernel_roofline: the packed digital TM kernel
(``kernels/csrc/tm_infer_packed.cu`` on ``tm_b1.cuh``): its least time at
the call's shapes (``counts.tm_packed``) over its device time a call, in
%."""

from imbue_bench import counts

KERNEL = r"\bpacked_kernel\b"


def read(ctx):
    ops = ctx.trace.kernels(KERNEL)
    calls = ctx.counters["calls"]
    if not ops or not calls:
        return None
    s = ctx.shape
    least = counts.bound_s(*counts.tm_packed(
        s["rows"], s["clauses"], s["literals"], s["classes"]))
    return 100.0 * least / (ctx.trace.device_s(ops) / calls)
