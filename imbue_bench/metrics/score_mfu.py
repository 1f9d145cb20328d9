"""score_mfu: the scoring window's share of the card's dense int8 peak,
counting one operation a clause-literal pair a chip read
(``counts.score_ops``), in %."""

from imbue_bench import counts


def read(ctx):
    c, s = ctx.counters, ctx.shape
    if not c["calls"]:
        return None
    ops = counts.score_ops(c["rows"], s["replicas"], s["ta_cells"])
    return 100.0 * ops / (c["window_s"] * counts.INT8_OP_PER_S)
