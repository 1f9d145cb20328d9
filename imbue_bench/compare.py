"""The comparisons that decide ``correct``: the program's outputs, read
after the window, against the plain reference
(``imbue_bench/reference/``), which works everything out again from the
inputs the harness made.

* Analog scoring: ``widest_margin``.  The reference computes every
  column current of the read in float64.  A class sum of the program that
  differs from the reference's by ``d`` is explained only by turning
  over ``|d|`` clauses of that class whose votes move it that way; the
  reading is the least relative change of column current that does so
  (the ``|d|``-th smallest flip margin among them).  The number compared
  is the widest such margin over every class sum of the sampled reads: 0
  where all agree, about float32's rounding where the program's float32
  sums put a column that lies that near the threshold on the other side.
  A class sum that no turning of clauses explains, or a prediction that
  is not the first class of the program's pooled sums, reads
  ``UNEXPLAINED``.
* Digital scoring: ``wrong_answers``, the class sums and predictions
  that differ from the reference's (exact).
* Training: ``ta_cells_off``, the most TA cells that differ from the
  reference's after any of the checked steps (exact).
"""

from __future__ import annotations

import torch

from imbue_bench.reference import imbue_tm as ref

UNEXPLAINED = 1.0e3


def widest_margin(sums: torch.Tensor, pred: torch.Tensor, x: torch.Tensor,
                  include: torch.Tensor, r_read: torch.Tensor,
                  n_classes: int, clauses_per_class: int, *,
                  rows: int = 256) -> float:
    """The analog reading of one read: the program's ``sums [R, B, M]``
    and ``pred [B]`` against the float64 reference read of ``x [B, F]``
    on ``r_read [R, C, L]``."""
    sums = sums.to(include.device)
    pred = pred.to(include.device)
    pooled = sums.sum(dim=0)
    if not torch.equal(pred, ref.predictions(pooled)):
        return UNEXPLAINED
    pol = ref.polarity(n_classes, clauses_per_class, include.device)
    worst = 0.0
    for i in range(0, x.shape[0], rows):
        m = ref.column_margins(ref.literals(x[i:i + rows]), include, r_read)
        fires, flip = ref.analog_clauses(m, include)
        del m
        d = sums[:, i:i + rows] - ref.class_sums(fires, n_classes,
                                                 clauses_per_class)
        where = d.nonzero(as_tuple=True)
        if not where[0].numel():
            continue
        shape = (*fires.shape[:2], n_classes, clauses_per_class)
        # The vote change of turning each clause over: +1 or -1.
        move = (pol * (1 - 2 * fires.to(torch.int32))).reshape(shape)
        flip = flip.reshape(shape)[where]                  # [N, J]
        want = d[where].sign()[:, None]
        cand = torch.where(move[where] == want, flip, float("inf"))
        need = cand.sort(dim=-1).values
        k = d[where].abs().to(torch.int64) - 1
        got = torch.where(k < clauses_per_class,
                          need.gather(-1, k.clamp(max=clauses_per_class - 1)
                                      [:, None])[:, 0],
                          float("inf"))
        worst = max(worst, float(got.max()))
    return min(worst, UNEXPLAINED)


def wrong_answers(sums: torch.Tensor, pred: torch.Tensor,
                  ref_sums: torch.Tensor) -> int:
    """The digital reading: class sums and predictions that differ from
    the reference's."""
    sums = sums.to(ref_sums.device)
    pred = pred.to(ref_sums.device)
    return int((sums != ref_sums).sum()) + int(
        (pred != ref.predictions(ref_sums)).sum())


def cells_off(states, ref_states) -> int:
    """The training reading: the most TA cells that differ over the
    checked steps."""
    return max(int((s.to(r.device) != r).sum())
               for s, r in zip(states, ref_states))
