"""Coalesced Tsetlin Machine in PyTorch (port of ``repro.core.coalesced``;
Glimsdal & Granmo 2021, arXiv:2108.07594).

ONE pool of clauses is shared by all classes, and each (clause, class)
pair carries an integer weight: ``sums = clauses @ W``.  The crossbar
half is the digital TM's (same include plane, same violation count);
only the tail swaps the +-1 polarity counters for weighted counters, so
the fused kernels take W as their ``[C, M]`` combine matrix.

Training: per example, the target class strengthens firing clauses
(``w += 1``, TA Type I) and one sampled negative class weakens them
(``w -= 1``, TA Type II on firing clauses).  ``train_step_batch``
evaluates the batch's clauses with one ``ops.clause_eval_packed`` launch
and sums the per-example deltas over chunks, as
``core.tm_train.train_step_batch`` does; each example draws from its own
split of the step's generator (``q``, ``u [C, M]``, ``r_hi``, ``r_lo``),
and :func:`_example_update_apply` is the apply half (the reference's
``_example_update`` without its draws) that the tests feed the
reference's draws to.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import tm_train
from repro_torch.core.tm import clause_outputs_from_include, literals
from repro_torch.core.variations import split_generator
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class CoalescedConfig:
    n_classes: int
    n_clauses: int              # TOTAL shared clause pool
    n_features: int
    n_states: int = 127
    threshold: int = 15
    specificity: float = 3.9
    max_weight: int = 127
    state_dtype: torch.dtype = torch.int16

    def __post_init__(self):
        # Fail at construction, not deep inside a kernel with an opaque
        # shape/overflow error.
        if self.n_classes < 2:
            raise ValueError(
                f"n_classes must be >= 2 (got {self.n_classes}): a "
                "coalesced pool shares clauses BETWEEN classes")
        if self.n_clauses < 1 or self.n_features < 1:
            raise ValueError(
                f"n_clauses={self.n_clauses} and n_features="
                f"{self.n_features} must both be >= 1")
        if self.max_weight < 1:
            raise ValueError(f"max_weight must be >= 1, got "
                             f"{self.max_weight}")
        info = torch.iinfo(self.state_dtype)
        name = str(self.state_dtype).removeprefix("torch.")
        if self.max_weight > info.max:
            raise ValueError(
                f"max_weight={self.max_weight} does not fit state_dtype="
                f"{name} (max {info.max}); weight clipping would silently "
                "wrap")
        if 2 * self.n_states + 1 > info.max:
            raise ValueError(
                f"TA states span 1..{2 * self.n_states}, which does not "
                f"fit state_dtype={name} (max {info.max})")

    @property
    def n_literals(self) -> int:
        return 2 * self.n_features

    @property
    def n_ta(self) -> int:
        return self.n_clauses * self.n_literals


def clause_outputs(ta_state: torch.Tensor, lits: torch.Tensor,
                   cfg: CoalescedConfig, *,
                   training: bool = False) -> torch.Tensor:
    """``uint8 [B, C]``: a clause fires iff none of its included literals
    is 0; empty clauses fire in training and not at inference."""
    return clause_outputs_from_include(ta_state > cfg.n_states, lits,
                                       training=training)


def class_sums(clauses: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``[B, C]`` 0/1 clauses x ``[C, M]`` integer weights -> ``[B, M]``
    int32.  The product runs in float64, exact for these integers."""
    return (clauses.to(torch.float64)
            @ weights.to(torch.float64)).to(torch.int32)


def forward(ta_state: torch.Tensor, weights: torch.Tensor, x: torch.Tensor,
            cfg: CoalescedConfig) -> torch.Tensor:
    """Class sums for raw Boolean features ``x [B, F]`` -> ``[B, M]``."""
    return class_sums(clause_outputs(ta_state, literals(x), cfg), weights)


def predict(ta_state: torch.Tensor, weights: torch.Tensor, x: torch.Tensor,
            cfg: CoalescedConfig) -> torch.Tensor:
    """Argmax classification ``[B, F] -> [B]`` (ties to the lowest
    class)."""
    return torch.argmax(forward(ta_state, weights, x, cfg), dim=-1)


def accuracy(ta_state: torch.Tensor, weights: torch.Tensor, x: torch.Tensor,
             y: torch.Tensor, cfg: CoalescedConfig) -> torch.Tensor:
    return (predict(ta_state, weights, x, cfg) == y).to(torch.float32).mean()


# ------------------------------------------------------------------ training

def init_coalesced(generator: torch.Generator, cfg: CoalescedConfig,
                   device: DeviceLike = None):
    """``(ta_state [C, L], weights [C, M])``: states on the include /
    exclude boundary (``N`` or ``N + 1`` with probability 1/2, drawn from
    ``generator``, which must live on ``device``) and unit int32
    weights."""
    device = resolve_device(device)
    u = torch.rand((cfg.n_clauses, cfg.n_literals), generator=generator,
                   device=device) < 0.5
    ta = (cfg.n_states + u.to(cfg.state_dtype)).to(cfg.state_dtype)
    w = torch.ones((cfg.n_clauses, cfg.n_classes), dtype=torch.int32,
                   device=device)
    return ta, w


def _example_update_apply(ta_state: torch.Tensor, weights: torch.Tensor,
                          lits: torch.Tensor, cls: torch.Tensor,
                          sums: torch.Tensor, y: torch.Tensor, draws,
                          cfg: CoalescedConfig):
    """Deltas of ``k`` examples against one model: ``(d_state int8
    [k, C, L], d_w int8 [k, C, M])`` from ``lits [k, L]``, ``cls [k, C]``,
    ``sums [k, M]``, ``y [k]`` and their draws (``u`` is ``[k, C, M]``).

    Vanilla-multiclass CoTM: the target class pulls with prob
    ``(T - s_y)/2T`` and ONE sampled negative pushes with prob
    ``(T + s_q)/2T``; the feedback type mirrors the weight's sign for the
    feedback class.  The clip and the division run in float32, in the
    reference's order."""
    m = cfg.n_classes
    t = float(cfg.threshold)
    is_tgt = torch.nn.functional.one_hot(y, m).to(torch.bool)       # [k, M]
    active = is_tgt | torch.nn.functional.one_hot(draws.q, m).to(torch.bool)
    clipped = sums.to(torch.float32).clamp(-t, t)
    p = torch.where(is_tgt, (t - clipped) / (2 * t),
                    (t + clipped) / (2 * t)) * active
    sel = draws.u < p[:, None, :]                                    # [k, C, M]

    fired = cls == 1                                                 # [k, C]
    lit1 = (lits == 1)[:, None, :]
    f = fired[:, :, None]
    pos = weights >= 0                                               # [C, M]
    tgt = is_tgt[:, None, :]
    type1 = (sel & torch.where(tgt, pos, ~pos)).any(-1)              # [k, C]
    type2 = (sel & torch.where(tgt, ~pos, pos)).any(-1)

    d1 = (tm_train._type1_delta(f, lit1, draws)
          * type1[..., None].to(torch.int8))
    excl = ta_state <= cfg.n_states
    inc_t2 = f & ~lit1 & excl
    d2 = inc_t2.to(torch.int8) * (type2 & fired)[..., None].to(torch.int8)
    dw = torch.where(tgt, 1, -1).to(torch.int8) * (sel & f).to(torch.int8)
    return d1 + d2, dw


def train_step_batch(ta_state: torch.Tensor, weights: torch.Tensor,
                     generator: torch.Generator, x, y, cfg: CoalescedConfig):
    """Batch-parallel coalesced update -> ``(ta_state, weights)``: deltas
    against the start-of-batch model, summed over chunks of examples;
    states clipped to ``[1, 2N]``, weights to ``±max_weight``.  One
    ``clause_eval_packed`` launch per step."""
    device = ta_state.device
    x, y = tm_train._batch(x, y, device)
    lits_b = literals(x)
    cls = ops.clause_eval_packed(ops.pack_literals(lits_b),
                                 ops.pack_include(ta_state > cfg.n_states),
                                 device=device)                       # [B, C]
    sums = class_sums(cls, weights)
    gens = split_generator(generator, x.shape[0])
    d_state = torch.zeros(ta_state.shape, dtype=torch.int32, device=device)
    d_w = torch.zeros(weights.shape, dtype=torch.int32, device=device)
    step = tm_train._chunk_size(cfg.n_ta)
    for i in range(0, x.shape[0], step):
        part = slice(i, i + step)
        draws = tm_train._draw_feedback(
            gens[part], y[part], cfg.n_classes,
            (cfg.n_clauses, cfg.n_classes), tuple(ta_state.shape),
            cfg.specificity, device)
        ds, dw = _example_update_apply(ta_state, weights, lits_b[part],
                                       cls[part], sums[part], y[part],
                                       draws, cfg)
        d_state += ds.sum(0, dtype=torch.int32)
        d_w += dw.sum(0, dtype=torch.int32)
    new_state = tm_train._clip_state(ta_state.to(torch.int32) + d_state, cfg)
    new_w = (weights.to(torch.int32) + d_w).clamp(-cfg.max_weight,
                                                   cfg.max_weight)
    return new_state, new_w


def fit(ta_state: torch.Tensor, weights: torch.Tensor,
        generator: torch.Generator, x, y, cfg: CoalescedConfig, *,
        epochs: int = 10, batch_size: int = 256):
    """``epochs`` shuffled epochs of :func:`train_step_batch` in full
    batches of ``batch_size`` (not clamped: fewer rows than one batch
    train nothing, as in the reference)."""
    x, y = tm_train._batch(x, y, ta_state.device)
    for _ in range(epochs):
        for idx in tm_train.epoch_batches(generator, x.shape[0], batch_size,
                                          ta_state.device):
            ta_state, weights = train_step_batch(ta_state, weights,
                                                 generator, x[idx], y[idx],
                                                 cfg)
    return ta_state, weights
