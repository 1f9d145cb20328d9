"""TM training and inference over a mesh (port of
``repro.core.tm_distributed``).

The paper's workload on a ``(data, model)`` mesh: batch -> ``data``,
clauses -> ``model``.  The reference writes one jnp program and lets
GSPMD partition it; here every rank runs the same program on its blocks
(``distributed.sharding.local_block``) and the collectives are written
out:

* ``tm_train_step`` — the batch-parallel Type I/II update, bit for bit
  the single-device ``train_step_batch``: each rank evaluates its rows
  against its clauses (one ``clause_eval_packed`` launch), the partial
  class sums are all-reduced over ``model``, each rank takes from the
  step's per-example generators exactly the draws the single-device step
  makes for its rows and clauses (drawn at the whole step's shape, then
  cut), and the integer TA deltas of the batch blocks are summed over
  ``data``.
* ``tm_infer_step`` — fused digital inference (violation product ->
  threshold -> polarity product), the plain formulation of the
  ``tm_infer`` kernel.
* ``imbue_infer_step`` — the analog current-domain inference on
  programmed conductances.

Both inference steps round their operands to bf16 where the reference
does and take the products in float32 (TF32 off on the card): the
reference's products are bf16 with float32 accumulation and a float32
result, and a bf16 result would round class sums that reach 1,000.
These are plain products outside any kernel, so ``torch.matmul`` is
right here.  Placements for a mesh come from ``tm_shardings``; inputs
without a partitioned operand run on one device.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import tm_train
from repro_torch.core.tm import TMConfig, include_mask, literals
from repro_torch.core.variations import split_generator
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.kernels import ops


def tm_shardings(cfg: TMConfig, mesh, batch: int):
    """``(state, batch_x, batch_y)`` shardings on ``mesh``: clauses over
    ``model`` when they divide it, rows over the batch axes when the
    batch divides them."""
    shape = sharding.mesh_shape(mesh)
    b_axes = tuple(a for a in ("pod", "data") if a in shape)
    n_b = 1
    for a in b_axes:
        n_b *= shape[a]
    bspec = b_axes if (b_axes and batch % n_b == 0) else None
    clause_ax = ("model" if "model" in shape
                 and cfg.n_clauses % shape["model"] == 0 else None)
    return (NamedSharding(mesh, P(clause_ax, None)),
            NamedSharding(mesh, P(bspec, None)),
            NamedSharding(mesh, P(bspec)))


def pad_clauses_for_mesh(cfg: TMConfig, mesh) -> TMConfig:
    """Round ``clauses_per_class`` up so the clauses divide the ``model``
    axis.

    Without it a clause count like F-MNIST's 5000 leaves the TA state
    whole (5000 % 16 != 0) and every rank does every clause's work.  The
    padding is class-blocked, so clause -> class indexing holds; at
    inference the extra clauses are programmed all-exclude (empty
    clauses output 0), for training it is a slightly larger TM."""
    shape = sharding.mesh_shape(mesh)
    if "model" not in shape:
        return cfg
    m = shape["model"]
    if cfg.n_clauses % m == 0:
        return cfg
    # per-class count must be even (polarity pairs) and make M*J % m == 0
    j = cfg.clauses_per_class
    while True:
        j += 2
        if (cfg.n_classes * j) % m == 0:
            return dataclasses.replace(cfg, clauses_per_class=j)


def _mesh_of(*xs):
    for x in xs:
        if sharding.partitioned(x):
            return x.device_mesh
    return None


def _partial_sums(clauses: torch.Tensor, pol: torch.Tensor) -> torch.Tensor:
    """``[B, C_local]`` 0/1 clauses x ``[C_local, M]`` signed one-hot ->
    ``[B, M]`` int32, exact."""
    return (clauses.to(torch.int32)[:, :, None] * pol[None]).sum(
        1, dtype=torch.int32)


def tm_train_step(ta_state: torch.Tensor, generator: torch.Generator, x, y,
                  cfg: TMConfig) -> torch.Tensor:
    """One batch-parallel TM step.  With the state split over ``model``
    and ``x`` / ``y`` over the batch axes (``tm_shardings``), each rank
    updates its clause block and the result keeps the state's placement;
    it equals ``tm_train.train_step_batch`` on the whole operands from the
    same generator.  Every rank of the mesh calls it."""
    mesh = _mesh_of(ta_state, x, y)
    if mesh is None:                      # nothing split: one device's step
        ta_state, x, y = (sharding.local_block(t)[0] for t in (ta_state, x, y))
        return tm_train.train_step_batch(ta_state, generator, x, y, cfg)
    state, (c0, _), _ = sharding.local_block(ta_state)
    xl, (b0, _), (n, _) = sharding.local_block(x)
    yl, _, _ = sharding.local_block(y)
    device = state.device
    xl, yl = tm_train._batch(xl, yl, device)
    rows = slice(c0, c0 + state.shape[0])
    lits = literals(xl)
    cls = ops.clause_eval_packed(ops.pack_literals(lits),
                                 ops.pack_include(include_mask(state, cfg)),
                                 device=device)              # [B_l, C_l]
    sums = sharding.all_reduce_sum(
        _partial_sums(cls, ops.polarity_matrix(cfg, device=device)[rows]),
        mesh, sharding.split_dims(ta_state, 0))              # [B_l, M]
    gens = split_generator(generator, n)[b0:b0 + xl.shape[0]]
    total = torch.zeros(state.shape, dtype=torch.int32, device=device)
    step = tm_train._chunk_size(cfg.n_ta)
    for i in range(0, xl.shape[0], step):
        part = slice(i, i + step)
        d = tm_train._draw_feedback(
            gens[part], yl[part], cfg.n_classes, (cfg.n_clauses,),
            (cfg.n_clauses, cfg.n_literals), cfg.specificity, device)
        draws = tm_train.FeedbackDraws(d.q, d.u[:, rows], d.r_hi[:, rows],
                                       d.r_lo[:, rows])
        total += tm_train._ta_delta_apply(
            state, lits[part], cls[part], sums[part], yl[part], draws, cfg,
            rows).sum(0, dtype=torch.int32)
    total = sharding.all_reduce_sum(total, mesh, sharding.split_dims(x, 0))
    new = tm_train._clip_state(state.to(torch.int32) + total, cfg)
    if not isinstance(ta_state, DTensor):
        return new
    return sharding.from_block(new, (ta_state.device_mesh,
                                     ta_state.placements))


@contextlib.contextmanager
def _ieee_fp32():
    """Float32 products without TF32 on the card, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, as float32 for the product."""
    return t.to(torch.bfloat16).to(torch.float32)


def _predict(clauses: torch.Tensor, include: torch.Tensor, rows: slice,
             cfg: TMConfig, state, x) -> torch.Tensor:
    """Predictions ``[B]`` from a block's ``[B_l, C_l]`` clause outputs:
    the polarity product (empty clauses' rows zeroed), summed over the
    clause blocks of ``state``, the argmax, gathered over the row blocks
    of ``x``."""
    pol = (ops.polarity_matrix(cfg, device=include.device)[rows]
           * include.any(dim=-1)[:, None].to(torch.int32))
    with _ieee_fp32():
        sums = _bf16(clauses.to(torch.float32)) @ _bf16(pol.to(torch.float32))
    mesh = _mesh_of(state, x)
    if mesh is not None:
        sums = sharding.all_reduce_sum(sums, mesh,
                                       sharding.split_dims(state, 0))
    preds = torch.argmax(sums, dim=-1)
    if mesh is None or not sharding.split_dims(x, 0):
        return preds
    return sharding.gather(sharding.from_block(
        preds, sharding.result_layout((x, {0: 0}))))


def tm_infer_step(ta_state: torch.Tensor, x: torch.Tensor,
                  cfg: TMConfig) -> torch.Tensor:
    """Digital fused inference -> predictions ``[B]`` (whole on every
    rank).  The violation counts are small integers, exact in bf16
    operands with a float32 product."""
    state, (c0, _), _ = sharding.local_block(ta_state)
    xl, _, _ = sharding.local_block(x)
    lits = literals(xl.to(state.device))
    inc = include_mask(state, cfg)
    with _ieee_fp32():
        viol = _bf16(1 - lits.to(torch.float32)) @ _bf16(
            inc.to(torch.float32)).T
    rows = slice(c0, c0 + state.shape[0])
    return _predict(viol == 0, inc, rows, cfg, ta_state, x)


def imbue_infer_step(g_on, i_leak, include, x: torch.Tensor, cfg: TMConfig,
                     *, v_read, r_div, v_ref, width=32) -> torch.Tensor:
    """Analog (current-domain) inference -> predictions ``[B]``.

    Currents from bf16 operands with float32 accumulation for the KCL
    sums (relative error ~0.4 % against the ~11 % sensing margin); the
    order of the float32 sums can differ from XLA's, so a column current
    within rounding of ``v_ref`` may compare the other way.  ``g_on``,
    ``i_leak`` and ``include`` may be split over ``model`` by clause."""
    g, (c0, _), _ = sharding.local_block(g_on)
    lk, _, _ = sharding.local_block(i_leak)
    rows = slice(c0, c0 + g.shape[0])
    inc, _, _ = sharding.local_block(include)
    if not sharding.partitioned(include):
        inc = inc[rows]
    xl, _, _ = sharding.local_block(x)
    lits = literals(xl.to(g.device))
    pad = (-lits.shape[-1]) % width
    if pad:
        lits = torch.nn.functional.pad(lits, (0, pad), value=1)
        g = torch.nn.functional.pad(g, (0, pad))
        lk = torch.nn.functional.pad(lk, (0, pad))
    b, c, k = lits.shape[0], g.shape[0], lits.shape[-1] // width
    v_drive = _bf16((1.0 - lits.to(torch.float32)) * v_read).reshape(
        b, k, width)
    lit1 = _bf16(lits.to(torch.float32)).reshape(b, k, width)
    with _ieee_fp32():
        i_col = (torch.einsum("bkw,ckw->bck", v_drive,
                              _bf16(g).reshape(c, k, width))
                 + torch.einsum("bkw,ckw->bck", lit1,
                                _bf16(lk).reshape(c, k, width)))
    clauses = (i_col * r_div < v_ref).all(dim=-1)
    return _predict(clauses, inc, rows, cfg, g_on, x)
