"""The plain reference of the IMBUE Tsetlin machines (imbue-tm-mnist,
imbue-tm-kmnist): digital inference, the analog crossbar read and the
batch training step, in plain PyTorch.

It imports torch alone: nothing of the port and nothing of the JAX
package.  The equations are the paper's (arXiv 2305.12914, section II;
Table I for the device constants) as the port documents them:

* a clause fires iff none of its included literals is 0; at inference
  an empty clause does not vote, in training it fires;
* class sums are the polarity-weighted clause votes (``+1`` for the even
  clauses of a class, ``-1`` for the odd ones); the prediction is the
  first class of the largest sum;
* an analog read drives each literal '0' at ``V_READ`` through its
  cell's programmed resistance (include -> LRS, exclude -> HRS) times the
  1T1R series factor, each literal '1' carries its cell's leak current,
  a column of 32 cells sums its currents, and a column passes iff its
  current lies below ``I_REF``, midway between 32 excluded cells and one
  included cell at their nominal resistances; a clause fires iff all its
  columns pass.  A read scales each programmed resistance by ``1 + frac
  * (2u - 1)``, ``u`` one uniform float32 draw a cell of every chip
  (``frac`` 1 % on LRS, 5 % on HRS), the leak by ``r_nom / r``;
* a training step (Type I / Type II feedback, the batch against its
  start state) draws its numbers in the order
  ``src/repro_torch/core/tm_train.py`` documents: a seed per example from
  the step's generator, then per example the negative class, the clause
  uniforms and the two Type-I byte masks.

The analog read runs in float64 here, the digital violation count in
float32 with TF32 off (exact for 0/1 operands).  ``precision`` selects a
lower precision for the controls of ``imbue_bench/control.py``.
"""

from __future__ import annotations

import contextlib

import torch

# Table I and section III-C of the paper (the port's core/variations.py).
LRS_MEAN_OHM = 1.64e3
LRS_MIN_OHM = 1.55e3
LRS_MAX_OHM = 1.67e3
HRS_MEAN_OHM = 65.56e3
HRS_MIN_OHM = 31.0e3
HRS_MAX_OHM = 155.0e3
SERIES_FACTOR = 1.61
V_READ = 0.2
I_LEAK_INCLUDE = 137e-9
I_LEAK_EXCLUDE = 9.9e-9
C2C_LRS_FRAC = 0.01
C2C_HRS_FRAC = 0.05
WIDTH = 32
I_REF = 0.5 * (WIDTH * V_READ / (SERIES_FACTOR * HRS_MEAN_OHM)
               + V_READ / (SERIES_FACTOR * LRS_MEAN_OHM))

_DTYPES = {"float64": torch.float64, "float32": torch.float32,
           "tf32": torch.float32, "bfloat16": torch.bfloat16}


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 matrix products on (the TF32 control) or off (the
    reference)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def literals(x: torch.Tensor) -> torch.Tensor:
    """``[B, F]`` 0/1 -> ``[B, 2F]`` uint8: features, then complements."""
    x = x.to(torch.uint8)
    return torch.cat([x, 1 - x], dim=-1)


def polarity(n_classes: int, clauses_per_class: int,
             device) -> torch.Tensor:
    j = torch.arange(clauses_per_class, device=device)
    return torch.where(j % 2 == 0, 1, -1).to(torch.int32).repeat(n_classes)


def class_sums(bits: torch.Tensor, n_classes: int,
               clauses_per_class: int) -> torch.Tensor:
    """``[..., C]`` clause bits -> ``[..., M]`` int32 polarity-weighted
    sums."""
    votes = bits.to(torch.int32) * polarity(n_classes, clauses_per_class,
                                            bits.device)
    return votes.reshape(*bits.shape[:-1], n_classes,
                         clauses_per_class).sum(-1, dtype=torch.int32)


def predictions(sums: torch.Tensor) -> torch.Tensor:
    """The first class of the largest sum, a row."""
    return torch.argmax(sums, dim=-1)


def violations(lits: torch.Tensor, include: torch.Tensor) -> torch.Tensor:
    """``[B, C]`` float32 count of included literals that are 0 (exact:
    0/1 operands, float32 accumulation, TF32 off)."""
    with tf32(False):
        return (1.0 - lits.to(torch.float32)) @ include.to(torch.float32).T


def digital_sums(x: torch.Tensor, include: torch.Tensor, n_classes: int,
                 clauses_per_class: int, *, rows: int = 2048,
                 max_violations: int = 0) -> torch.Tensor:
    """``[B, M]`` int32 inference class sums of the TM ``include [C, L]``
    over ``x [B, F]``, in blocks of ``rows``.  ``max_violations`` above 0
    is the digital control: a clause with that many violations still
    fires."""
    nonempty = include.any(dim=-1)
    out = []
    for i in range(0, x.shape[0], rows):
        viol = violations(literals(x[i:i + rows]), include)
        fires = (viol <= max_violations) & nonempty
        out.append(class_sums(fires, n_classes, clauses_per_class))
    return torch.cat(out)


# ----------------------------------------------------------------- analog

def read_resistances(r_d2d: torch.Tensor, include: torch.Tensor,
                     u: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """``[R, C, L]`` resistances of one read: the programmed ones scaled
    by ``1 + frac * (2u - 1)``."""
    frac = torch.where(include, C2C_LRS_FRAC, C2C_HRS_FRAC).to(dtype)
    return r_d2d.to(dtype) * (1.0 + frac * (u.to(dtype) * 2.0 - 1.0))


def column_margins(lits: torch.Tensor, include: torch.Tensor,
                   r_read: torch.Tensor, precision: str = "float64"
                   ) -> torch.Tensor:
    """``[R, B, C, K]`` column currents of ``lits [B, L]`` on the chips
    ``r_read [R, C, L]``, as ``(i - I_REF) / I_REF``: a column passes iff
    its margin is below 0.  ``precision`` is the arithmetic: float64 (the
    reference), or float32 with TF32 products, or bfloat16 (controls)."""
    dt = _DTYPES[precision]
    rr, c, l = r_read.shape
    b = lits.shape[0]
    k = -(-l // WIDTH)
    pad = k * WIDTH - l
    r = r_read.to(dt)
    r_nom = torch.where(include, LRS_MEAN_OHM, HRS_MEAN_OHM).to(dt)
    g = 1.0 / (SERIES_FACTOR * r)
    leak = torch.where(include, I_LEAK_INCLUDE, I_LEAK_EXCLUDE).to(dt) * (
        r_nom / r)
    lit = lits.to(dt)
    drive = (1.0 - lit) * V_READ
    if pad:
        g, leak = (torch.nn.functional.pad(t, (0, pad)) for t in (g, leak))
        drive, lit = (torch.nn.functional.pad(t, (0, pad))
                      for t in (drive, lit))
    with tf32(precision == "tf32"):
        i_col = (torch.einsum("bkw,rckw->rbck", drive.view(b, k, WIDTH),
                              g.view(rr, c, k, WIDTH))
                 + torch.einsum("bkw,rckw->rbck", lit.view(b, k, WIDTH),
                                leak.view(rr, c, k, WIDTH)))
    return (i_col.to(torch.float64) - I_REF) / I_REF


def analog_clauses(margins: torch.Tensor, include: torch.Tensor):
    """``(fires [R, B, C] bool, flip [R, B, C] float64)`` from column
    margins: a nonempty clause fires iff all its columns pass; ``flip`` is
    the least relative change of column currents that turns the clause
    over (its nearest column to the threshold when it fires, its farthest
    failing column when it does not; inf for an empty clause)."""
    passes = margins < 0
    fires = passes.all(dim=-1)
    nearest = margins.abs().amin(dim=-1)
    farthest_fail = torch.where(passes, 0.0, margins).amax(dim=-1)
    flip = torch.where(fires, nearest, farthest_fail)
    nonempty = include.any(dim=-1)
    return fires & nonempty, torch.where(nonempty, flip, float("inf"))


def analog_sums(x: torch.Tensor, include: torch.Tensor, r_read: torch.Tensor,
                n_classes: int, clauses_per_class: int, *, rows: int = 256,
                precision: str = "float64") -> torch.Tensor:
    """``[R, B, M]`` int32 class sums of one read of ``x [B, F]`` at
    ``precision``, in blocks of ``rows``."""
    out = []
    for i in range(0, x.shape[0], rows):
        m = column_margins(literals(x[i:i + rows]), include, r_read,
                           precision)
        fires, _ = analog_clauses(m, include)
        out.append(class_sums(fires, n_classes, clauses_per_class))
    return torch.cat(out, dim=1)


# --------------------------------------------------------------- training

def _u8_threshold(p: float) -> int:
    return min(255, round(p * 256.0))


def train_step(ta: torch.Tensor, generator: torch.Generator,
               x: torch.Tensor, y: torch.Tensor, n_classes: int,
               clauses_per_class: int, n_states: int, threshold: int,
               specificity: float, precision: str = "float32",
               tally: dict | None = None) -> torch.Tensor:
    """One batch step: every example's feedback against the start state
    ``ta [C, L]``, the integer deltas summed, the state clipped to ``[1,
    2N]``.  ``precision`` is that of the feedback probabilities and their
    compare with the clause uniforms (float32; bfloat16 is the control).
    ``tally``, where given, gains the step's counts of each branch:
    ``pairs`` and ``fired`` (clause-example pairs, and those whose clause
    fires), ``type1_up``, ``type1_down``, ``type2_up`` (TA-cell deltas of
    each kind) and ``clipped`` (cells the clip moved)."""
    dev = ta.device
    dt = _DTYPES[precision]
    c_n, l_n = ta.shape
    lits = literals(x)
    include = ta > n_states
    fires = violations(lits, include) == 0                       # [B, C]
    counts = dict.fromkeys(("type1_up", "type1_down", "type2_up"), 0)
    sums = class_sums(fires, n_classes, clauses_per_class)
    pos = polarity(n_classes, clauses_per_class, dev) > 0
    clause_class = torch.arange(c_n, device=dev) // clauses_per_class
    t = float(threshold)
    thr_hi = _u8_threshold((specificity - 1.0) / specificity)
    thr_lo = _u8_threshold(1.0 / specificity)
    seeds = torch.randint(0, 2 ** 62, (x.shape[0],), generator=generator,
                          device=generator.device).tolist()
    total = torch.zeros((c_n, l_n), dtype=torch.int32, device=dev)
    for i, s in enumerate(seeds):
        g = torch.Generator(device=generator.device).manual_seed(s)
        yi = y[i]
        q = torch.randint(0, n_classes - 1, (), generator=g, device=dev)
        q = q + (q >= yi).to(q.dtype)
        u = torch.rand((c_n,), generator=g, device=dev)
        r_hi = torch.randint(0, 256, (c_n, l_n), dtype=torch.uint8,
                             generator=g, device=dev) < thr_hi
        r_lo = torch.randint(0, 256, (c_n, l_n), dtype=torch.uint8,
                             generator=g, device=dev) < thr_lo
        s_y = sums[i, yi].to(torch.float32).clamp(-t, t).to(dt)
        s_q = sums[i, q].to(torch.float32).clamp(-t, t).to(dt)
        p_tgt = (t - s_y) / (2.0 * t)
        p_neg = (t + s_q) / (2.0 * t)
        u = u.to(dt)
        sel_tgt = (clause_class == yi) & (u < p_tgt)
        sel_neg = (clause_class == q) & (u < p_neg)
        type1 = ((sel_tgt & pos) | (sel_neg & ~pos))[:, None]
        type2 = ((sel_tgt & ~pos) | (sel_neg & pos))[:, None]
        lit1 = (lits[i] == 1)[None, :]
        cl1 = fires[i][:, None]
        up = cl1 & lit1 & r_hi & type1
        down = (~cl1 | ~lit1) & r_lo & type1
        up2 = cl1 & ~lit1 & ~include & type2
        total += up.to(torch.int32) - down.to(torch.int32) + up2.to(
            torch.int32)
        if tally is not None:
            for key, cells in (("type1_up", up), ("type1_down", down),
                               ("type2_up", up2)):
                counts[key] += cells.sum()
    new = (ta.to(torch.int32) + total).clamp(1, 2 * n_states)
    if tally is not None:
        counts.update(pairs=fires.numel(), fired=fires.sum(),
                      clipped=(new != ta.to(torch.int32) + total).sum())
        for key, n in counts.items():
            tally[key] = tally.get(key, 0) + int(n)
    return new.to(ta.dtype)
