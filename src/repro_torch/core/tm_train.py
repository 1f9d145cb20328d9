"""Tsetlin Machine training (Type I / Type II feedback) in PyTorch (port of
``repro.core.tm_train``).

The standard simplified feedback rules.  Per example ``(x, y)`` with
literals ``l`` and class sums ``s``:

* target class ``y`` — clause feedback prob ``p = (T - clip(s_y)) / 2T``;
  positive-polarity clauses receive **Type I**, negative **Type II**
* random other class ``q`` — prob ``p = (T + clip(s_q)) / 2T``;
  positive-polarity clauses receive **Type II**, negative **Type I**

Type I, applied per TA: clause 1 and literal 1 -> ``+1`` w.p. ``(s-1)/s``;
clause 1 and literal 0, or clause 0 -> ``-1`` w.p. ``1/s``.  Type II:
clause 1, literal 0 and the TA excluding -> ``+1``.  States clip to
``[1, 2N]`` after the (summed) delta is applied.

``train_step``        sequential: each example sees the states the
                      previous one left; clauses evaluated by one
                      ``ops.clause_eval`` launch per example, on the
                      include bytes ``state > N``.
``train_step_batch``  batch-parallel: every example's feedback is
                      computed against the start-of-batch state and the
                      integer deltas are summed; clauses evaluated by ONE
                      ``ops.clause_eval_packed`` launch per step, on the
                      batch's literal words and the packed include plane.

Randomness.  A step splits its generator into one generator per example
(``variations.split_generator``, the counterpart of the reference's
per-example keys), and each example draws, in this order, its negative
class ``q``, its clause-selection uniforms ``u`` and its two Type-I byte
masks ``r_hi`` / ``r_lo`` (:func:`_draw_feedback`).  Both steps draw the
same numbers for the same example, so ``train_step == train_step_batch``
at B = 1.  The draws are apart from their use (:func:`_ta_delta_apply`),
so a test can feed the reference's own draws to the apply half.

Memory.  The batch step sums its int8 deltas into an int32 ``[C, L]``
over chunks of examples instead of materializing ``[B, C, L]``; integer
sums do not depend on their order, so the result does not depend on the
chunk size.  The TA update is eager PyTorch, as the reference's is jnp
outside any Pallas kernel.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

from repro_torch.core.tm import (TMConfig, class_sums, include_mask,
                                 literals, polarity)
from repro_torch.core.variations import split_generator
from repro_torch.kernels import ops
from repro_torch.trace import span

# Cells of [chunk, C, L] per chunk of the batch step's delta sum.
_CHUNK_CELLS = 1 << 26


class FeedbackDraws(NamedTuple):
    """The random numbers of ``k`` examples' feedback."""

    q: torch.Tensor        # [k] int64 negative class, != y
    u: torch.Tensor        # [k, C] (coalesced: [k, C, M]) float32 in [0, 1)
    r_hi: torch.Tensor     # [k, C, L] bool, Bernoulli((s-1)/s)
    r_lo: torch.Tensor     # [k, C, L] bool, Bernoulli(1/s)


def _clip_state(state: torch.Tensor, cfg) -> torch.Tensor:
    return state.clamp(1, 2 * cfg.n_states).to(cfg.state_dtype)


def _u8_threshold(p: float) -> int:
    return min(255, round(p * 256.0))


def _bernoulli_u8(generator: torch.Generator, p: float, shape,
                  device) -> torch.Tensor:
    """Bernoulli(p) at 1/256 resolution, the reference's rule: one uniform
    random byte per draw, below ``min(255, round(256 p))``.  (The
    reference takes its bytes from threefry words; here they are drawn as
    bytes, one per draw.)"""
    b = torch.randint(0, 256, shape, dtype=torch.uint8, generator=generator,
                      device=device)
    return b < _u8_threshold(p)


def _draw_feedback(gens: Sequence[torch.Generator], y: torch.Tensor,
                   n_classes: int, u_shape, ta_shape, specificity: float,
                   device) -> FeedbackDraws:
    """Example ``i`` draws from ``gens[i]``: ``q`` uniform over the classes
    other than ``y[i]``, ``u`` of ``u_shape``, then ``r_hi`` and ``r_lo``
    of ``ta_shape`` — always in this order, whatever the batch."""
    s = float(specificity)
    qs, us, his, los = [], [], [], []
    for g, yy in zip(gens, y):
        q = torch.randint(0, n_classes - 1, (), generator=g, device=device)
        qs.append(q + (q >= yy).to(q.dtype))
        us.append(torch.rand(u_shape, generator=g, device=device))
        his.append(_bernoulli_u8(g, (s - 1.0) / s, ta_shape, device))
        los.append(_bernoulli_u8(g, 1.0 / s, ta_shape, device))
    return FeedbackDraws(torch.stack(qs), torch.stack(us), torch.stack(his),
                         torch.stack(los))


def _feedback_probs(sums: torch.Tensor, y: torch.Tensor, q: torch.Tensor,
                    cfg: TMConfig):
    """``[k]`` float32 feedback probabilities of the target class ``y`` and
    the negative class ``q`` from ``[k, M]`` sums: the clip and the
    division run in float32, in the reference's order."""
    t = float(cfg.threshold)
    sy = sums.gather(-1, y[:, None])[:, 0].to(torch.float32).clamp(-t, t)
    sq = sums.gather(-1, q[:, None])[:, 0].to(torch.float32).clamp(-t, t)
    return (t - sy) / (2.0 * t), (t + sq) / (2.0 * t)


def _type1_delta(cl1: torch.Tensor, lit1: torch.Tensor,
                 draws: FeedbackDraws) -> torch.Tensor:
    """int8 Type-I delta ``[k, C, L]`` before the per-clause gate."""
    inc_t1 = cl1 & lit1 & draws.r_hi
    dec_t1 = (~cl1 | (cl1 & ~lit1)) & draws.r_lo
    return inc_t1.to(torch.int8) - dec_t1.to(torch.int8)


def _ta_delta_apply(state: torch.Tensor, lits: torch.Tensor,
                    clauses: torch.Tensor, sums: torch.Tensor,
                    y: torch.Tensor, draws: FeedbackDraws,
                    cfg: TMConfig, rows: slice = slice(None)) -> torch.Tensor:
    """int8 state deltas ``[k, C, L]`` of ``k`` examples (Type I + II)
    against one state ``[C, L]``: ``lits [k, L]``, ``clauses [k, C]``,
    ``sums [k, M]``, ``y [k]`` and their draws.  ``rows`` names the
    clauses a block of the state holds (``core.tm_distributed``: the
    state, ``clauses`` and the clause draws are then that block's)."""
    p_tgt, p_neg = _feedback_probs(sums, y, draws.q, cfg)
    clause_class = (torch.arange(cfg.n_clauses, device=state.device)
                    // cfg.clauses_per_class)[rows]                 # [C]
    pos = (polarity(cfg, state.device) > 0)[rows]                   # [C]
    sel_tgt = (clause_class == y[:, None]) & (draws.u < p_tgt[:, None])
    sel_neg = (clause_class == draws.q[:, None]) & (draws.u < p_neg[:, None])
    type1 = (sel_tgt & pos) | (sel_neg & ~pos)                      # [k, C]
    type2 = (sel_tgt & ~pos) | (sel_neg & pos)

    lit1 = (lits == 1)[:, None, :]                                  # [k, 1, L]
    cl1 = (clauses == 1)[:, :, None]                                # [k, C, 1]
    d1 = _type1_delta(cl1, lit1, draws) * type1[..., None].to(torch.int8)
    excl = ~include_mask(state, cfg)
    inc_t2 = cl1 & ~lit1 & excl
    d2 = inc_t2.to(torch.int8) * type2[..., None].to(torch.int8)
    return d1 + d2


def _ta_delta(generator: torch.Generator, state: torch.Tensor,
              lits: torch.Tensor, clauses: torch.Tensor, sums: torch.Tensor,
              y: torch.Tensor, cfg: TMConfig) -> torch.Tensor:
    """int8 state delta ``[C, L]`` of one example (``lits [L]``,
    ``clauses [C]``, ``sums [M]``, scalar ``y``), drawing from
    ``generator``."""
    y = y.reshape(1)
    draws = _draw_feedback([generator], y, cfg.n_classes, (cfg.n_clauses,),
                           tuple(state.shape), cfg.specificity, state.device)
    return _ta_delta_apply(state, lits[None], clauses[None], sums[None], y,
                           draws, cfg)[0]


def _batch(x, y, device):
    """``x`` as uint8 and ``y`` as int64 tensors on ``device``."""
    return (torch.as_tensor(x).to(device=device, dtype=torch.uint8),
            torch.as_tensor(y).to(device=device, dtype=torch.int64))


def _chunk_size(n_cells: int) -> int:
    """Examples per chunk of a batch step's delta sum: as many as keep
    ``[chunk, C, L]`` within ``_CHUNK_CELLS`` cells."""
    return max(1, _CHUNK_CELLS // max(1, n_cells))


def train_step(ta_state: torch.Tensor, generator: torch.Generator, x, y,
               cfg: TMConfig) -> torch.Tensor:
    """Sequential (exact) TM update over one batch: example ``i`` sees the
    state example ``i - 1`` left.  One ``clause_eval`` launch per
    example."""
    device = ta_state.device
    x, y = _batch(x, y, device)
    lits_b = literals(x)
    state = ta_state
    for i, g in enumerate(split_generator(generator, x.shape[0])):
        lits = lits_b[i:i + 1]
        cls = ops.clause_eval(lits, include_mask(state, cfg), device=device)
        sums = class_sums(cls, cfg)
        delta = _ta_delta(g, state, lits[0], cls[0], sums[0], y[i], cfg)
        state = _clip_state(state.to(torch.int32) + delta, cfg)
    return state


def train_step_batch(ta_state: torch.Tensor, generator: torch.Generator, x,
                     y, cfg: TMConfig) -> torch.Tensor:
    """Batch-parallel TM update: deltas against the start-of-batch state,
    summed, then clipped.  One ``clause_eval_packed`` launch per step;
    the delta sum runs over chunks of :func:`_chunk_size` examples.  Its
    spans (``repro_torch.trace``): ``tm_train.step`` holding
    ``clause_eval``, ``split``, a ``draw`` and an ``update`` a chunk, and
    ``clip``."""
    with span("repro_torch.tm_train.step"):
        device = ta_state.device
        x, y = _batch(x, y, device)
        with span("repro_torch.tm_train.clause_eval"):
            lits_b = literals(x)
            incw = ops.pack_include(include_mask(ta_state, cfg))
            cls = ops.clause_eval_packed(ops.pack_literals(lits_b), incw,
                                         device=device)            # [B, C]
            sums = class_sums(cls, cfg)
        with span("repro_torch.tm_train.split"):
            gens = split_generator(generator, x.shape[0])
        total = torch.zeros(ta_state.shape, dtype=torch.int32, device=device)
        step = _chunk_size(cfg.n_ta)
        for i in range(0, x.shape[0], step):
            part = slice(i, i + step)
            with span("repro_torch.tm_train.draw"):
                draws = _draw_feedback(gens[part], y[part], cfg.n_classes,
                                       (cfg.n_clauses,),
                                       tuple(ta_state.shape),
                                       cfg.specificity, device)
            with span("repro_torch.tm_train.update"):
                total += _ta_delta_apply(ta_state, lits_b[part], cls[part],
                                         sums[part], y[part], draws,
                                         cfg).sum(0, dtype=torch.int32)
        with span("repro_torch.tm_train.clip"):
            return _clip_state(ta_state.to(torch.int32) + total, cfg)


def epoch_batches(generator: torch.Generator, n: int, batch_size: int,
                  device) -> List[torch.Tensor]:
    """One shuffled epoch's batches of row indices: a permutation drawn
    from ``generator``, cut into full batches of ``batch_size`` (the
    ragged tail is dropped, as the reference drops it)."""
    perm = torch.randperm(n, generator=generator,
                          device=generator.device).to(device)
    return [perm[i:i + batch_size]
            for i in range(0, n - batch_size + 1, batch_size)]


def train_epoch(ta_state: torch.Tensor, generator: torch.Generator, x, y,
                cfg: TMConfig, *, batch_size: int = 0,
                parallel: bool = False) -> torch.Tensor:
    """One shuffled epoch over ``(x, y)``.  ``batch_size`` is clamped to
    the dataset (0 means the whole dataset), so a small replay buffer
    still trains."""
    x, y = _batch(x, y, ta_state.device)
    n = x.shape[0]
    bs = min(batch_size, n) if batch_size else n
    step = train_step_batch if parallel else train_step
    for idx in epoch_batches(generator, n, bs, ta_state.device):
        ta_state = step(ta_state, generator, x[idx], y[idx], cfg)
    return ta_state


def fit(ta_state: torch.Tensor, generator: torch.Generator, x, y,
        cfg: TMConfig, *, epochs: int = 10, batch_size: int = 0,
        parallel: bool = False) -> torch.Tensor:
    """Host-loop trainer: ``epochs`` shuffled epochs (:func:`train_epoch`)
    on the device of ``ta_state``; ``generator`` lives there too."""
    for _ in range(epochs):
        ta_state = train_epoch(ta_state, generator, x, y, cfg,
                               batch_size=batch_size, parallel=parallel)
    return ta_state
