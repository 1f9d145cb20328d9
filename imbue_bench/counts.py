"""The benchmark's frozen yardstick: the H100's published peaks and the
operations and bytes of the work each cell asks for.

Copied from ``chip_smoke.py`` (``bound_ms``, ``tm_bytes_and_work``,
``dense_bytes_and_ops``) and the peaks of
``src/repro_torch/roofline/analysis.py``, with one change: where those
read the card's SM clock (``lop3_per_s``), this module takes the
published boost clock, so that a cell's bound is a constant.  The counts
describe the model's work at the call's shapes, whatever kernel does it.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
"""

from __future__ import annotations

WORD = 32                       # literals a packed word (a crossbar column)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12         # float32 outside the tensor cores
INT8_OP_PER_S = 1979e12         # dense int8, tensor cores: the MFU peak
N_SM = 132
BOOST_CLOCK_HZ = 1.98e9
# 32-bit logic (LOP3) per clock per SM on compute capability 9.0 (the
# arithmetic instruction throughput table of the CUDA C++ guide).
LOP3_PER_CLOCK_PER_SM = 64
LOP3_PER_S = LOP3_PER_CLOCK_PER_SM * N_SM * BOOST_CLOCK_HZ


def words(n_literals: int) -> int:
    return -(-n_literals // WORD)


def bound_s(nbytes: float, work) -> float:
    """The least time: the larger of the bytes' time and the operations'
    time; ``work`` is ``[(ops, ops_per_s), ...]``, one term per operand
    type (``chip_smoke.bound_ms``, in seconds)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(ops / rate for ops, rate in work)
    return max(t_bytes, t_ops)


def analog_planes(rows: int, replicas: int, clauses: int, literals: int,
                  classes: int):
    """``(bytes, work)`` of one plane-packed analog read of ``rows`` rows
    on ``replicas`` chips: the packed literal words, the include-index
    words and the ``[R, C, L]`` float32 deviation plane read once, the
    ``[C, M]`` polarity read once and the ``[R, B, M]`` int32 sums written
    once; 4 fp32 operations a (replica, row, cell): bit test, select, add,
    the compare amortised (``chip_smoke.dense_bytes_and_ops``)."""
    lw = words(literals)
    nbytes = 4 * (rows * lw + clauses * lw + replicas * clauses * literals
                  + clauses * classes + replicas * rows * classes)
    return nbytes, [(4 * replicas * rows * clauses * literals,
                     FP32_FLOP_PER_S)]


def tm_packed(rows: int, clauses: int, literals: int, classes: int):
    """``(bytes, work)`` of one packed digital inference: the literal and
    include words and the int32 ``[C, M]`` combine read once, the ``[B,
    M]`` sums written once; ``B * C * Lw`` word steps of one 32-bit logic
    operation each and ``2 * B * C * M`` int32 operations of the combine
    outside the tensor cores (``chip_smoke.tm_bytes_and_work``)."""
    lw = words(literals)
    nbytes = 4 * (rows * lw + clauses * lw + clauses * classes
                  + rows * classes)
    return nbytes, [(rows * clauses * lw, LOP3_PER_S),
                    (2 * rows * clauses * classes, FP32_FLOP_PER_S)]


def score_ops(rows: int, replicas: int, ta_cells: int) -> int:
    """The model's work of scoring ``rows`` rows on ``replicas`` chips:
    one operation a clause-literal pair a chip read."""
    return rows * replicas * ta_cells


def train_ops(examples: int, ta_cells: int) -> int:
    """The model's work of training on ``examples`` examples: two
    operations a TA cell an example, the clause evaluation and the TA
    update."""
    return 2 * examples * ta_cells
