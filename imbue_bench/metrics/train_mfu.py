"""train_mfu: the training window's share of the card's dense int8 peak,
counting two operations a TA cell an example (``counts.train_ops``), in
%."""

from imbue_bench import counts


def read(ctx):
    c, s = ctx.counters, ctx.shape
    if not c["steps"]:
        return None
    ops = counts.train_ops(c["examples"], s["ta_cells"])
    return 100.0 * ops / (c["window_s"] * counts.INT8_OP_PER_S)
