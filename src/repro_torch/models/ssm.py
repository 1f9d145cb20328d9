"""Recurrent sequence mixers: Mamba2 (SSD), mLSTM and sLSTM (xLSTM), port
of ``repro.models.ssm``.

All three expose a module, ``apply_*`` and ``*_decode``, with chunked
(sub-quadratic) training forms where the math allows:

* **Mamba2** — chunked state-space duality: quadratic *within* a chunk,
  linear state carry *across* chunks (a loop over chunks), the SSD
  algorithm of Dao & Gu 2024;
* **mLSTM** — matrix-memory LSTM with exponential gating, in a stabilized
  chunked-parallel form: per-chunk log-space weights with a running
  max-stabilizer carried across chunks (Beck et al. 2024, §A);
* **sLSTM** — scalar-memory LSTM with hidden-state recurrence (block-
  diagonal per-head R), inherently sequential: a loop over time.

Masked entries are set to -1e30 before the ``exp``, as in the reference.
Decode steps are O(1)-state recurrences; caches are dicts of tensors.

Under tensor parallelism (``sharding.use_sharding`` with a model axis of
more than one rank) Mamba2 and mLSTM compute this rank's block of their
heads, Megatron-style: the input enters through ``copy_to_model``, the
d_inner projections are column-parallel, ``w_out`` row-parallel with one
``reduce_from_model``, and the gated norm sums its squares over the
group.  A mixer whose head count does not divide the group computes
whole, as sLSTM always does (the reference's rules replicate it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (const, dtype_of, fan_in_init, full,
                                       param_dtype)

_MASKED = -1e30


def _head_split(nh: int) -> Tuple[Optional[sharding.TensorParallel],
                                  slice]:
    """``(tp, heads)``: the tensor parallelism that splits a mixer of
    ``nh`` heads and the heads this rank computes, its block of them; or
    ``(None, all heads)`` with no model axis or where ``nh`` does not
    divide the group (the mixer then computes whole)."""
    tp = sharding.tensor_parallel()
    if tp is None or nh % tp.size:
        return None, slice(0, nh)
    return tp, tp.block(nh)


def _enter(u: torch.Tensor, tp) -> torch.Tensor:
    """The mixer's input, replicated over the group, as this rank's heads
    read it: its gradient is summed over the group under ``tp``."""
    return u if tp is None else sharding.copy_to_model(u)


def _cut(t: torch.Tensor, dim: int, sl: slice) -> torch.Tensor:
    """``t[sl]`` along ``dim``, read whole and cut, its gradient summed
    over the model group (``sharding.param_slice``)."""
    return sharding.param_slice(t, dim, sl.start, sl.stop)


def _shared(t: torch.Tensor) -> torch.Tensor:
    """A leaf read whole for this rank's heads: its gradient is summed over
    the model group."""
    return sharding.copy_to_model(full(t))


def _check_cache(held: int, want: int, what: str) -> None:
    """Raise unless a decode cache holds the ``want`` heads (or channels)
    this rank computes: one made under another split would broadcast or
    fail deep in an einsum."""
    if held != want:
        raise ValueError(
            f"the decode cache's {what} holds {held} where this rank "
            f"computes {want}: make the decode state (init_decode_state) "
            f"under the sharding that decodes it")


def _gated_rmsnorm(y, z, scale, eps, tp=None):
    """Mamba2-style output norm: RMSNorm(y * silu(z)) * scale.  Under
    ``tp`` ``y``, ``z`` and ``scale`` are this rank's block of d_inner: the
    sum of squares is summed over the group and divided by the whole
    width.  Each block's variance feeds that block alone, so the gradient
    of the summed squares is partial on each rank and is summed over the
    group too (``copy_to_model``)."""
    g = y * F.silu(z.float()).to(y.dtype)
    if tp is None:
        var = torch.mean(torch.square(g.float()), -1, keepdim=True)
    else:
        total = sharding.copy_to_model(sharding.reduce_from_model(
            torch.square(g.float()).sum(-1, keepdim=True)))
        var = total / (g.shape[-1] * tp.size)
    return (g.float() * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _mixer_out(y: torch.Tensor, w_out: torch.Tensor, tp) -> torch.Tensor:
    """``y @ w_out``; under ``tp`` the row-parallel product's partial sums
    added over the group."""
    out = y @ w_out
    return out if tp is None else sharding.reduce_from_model(out)


def _tril(q: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((q, q), dtype=torch.bool, device=device))


# ===================================================================== SSD

def _mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.state_dim
    return d_inner, n_heads, conv_ch


class Mamba2(nn.Module):
    """Projections split per segment (``w_z`` / ``w_x`` / ``w_bc`` /
    ``w_dt``) so tensor-parallel sharding never crosses a segment; depthwise
    causal convs ``conv_x_*`` / ``conv_bc_*``; per-head ``a_log``,
    ``d_skip``, ``dt_bias``; the gated norm's ``norm_scale``; ``w_out``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, *, device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        d_inner, nh, _ = _mamba_dims(cfg)
        gn = s.n_groups * s.state_dim
        pd = param_dtype(cfg, dtype)
        self.w_z = fan_in_init(gen, (d, d_inner), d, pd, device)
        self.w_x = fan_in_init(gen, (d, d_inner), d, pd, device)
        self.w_bc = fan_in_init(gen, (d, 2 * gn), d, pd, device)
        self.w_dt = fan_in_init(gen, (d, nh), d, pd, device)
        self.conv_x_w = fan_in_init(gen, (s.conv_width, d_inner),
                                    s.conv_width, pd, device)
        self.conv_x_b = const((d_inner,), 0.0, device, pd)
        self.conv_bc_w = fan_in_init(gen, (s.conv_width, 2 * gn),
                                     s.conv_width, pd, device)
        self.conv_bc_b = const((2 * gn,), 0.0, device, pd)
        self.a_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, nh, dtype=torch.float32, device=device)))
        self.d_skip = const((nh,), 1.0, device)
        self.dt_bias = const((nh,), 0.0, device)
        self.norm_scale = const((d_inner,), 1.0, device)
        self.w_out = fan_in_init(gen, (d_inner, d), d_inner, pd, device)


def _causal_conv(x, w, b):
    """Depthwise causal conv: x [B,S,C], w [W,C] -> [B,S,C]."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out + b


_MAMBA_LEAVES = ("w_z", "w_x", "w_bc", "w_dt", "conv_x_w", "conv_x_b",
                 "conv_bc_w", "conv_bc_b", "a_log", "d_skip", "dt_bias",
                 "norm_scale", "w_out")


def _mamba_weights(p: Mamba2, cfg: ModelConfig, tp) -> dict:
    """Mamba2's leaves as this rank computes with them: whole without
    ``tp``.  Under it: the rank's d_inner block of the column-parallel
    ``w_z`` / ``w_x`` / ``conv_x_*`` and of ``norm_scale``, the rows of
    the row-parallel ``w_out``, its heads' ``w_dt`` columns and per-head
    scalars, and the B / C leaves whole (the group's heads share them).
    A leaf read whole or cut for this rank's heads has its gradient
    summed over the group."""
    if tp is None:
        return {n: full(getattr(p, n)) for n in _MAMBA_LEAVES}
    d_inner, nh, _ = _mamba_dims(cfg)
    heads, chans = tp.block(nh), tp.block(d_inner)
    return {"w_z": sharding.model_block(p.w_z, 1),
            "w_x": sharding.model_block(p.w_x, 1),
            "w_bc": _shared(p.w_bc), "w_dt": _cut(p.w_dt, 1, heads),
            "conv_x_w": sharding.model_block(p.conv_x_w, 1),
            "conv_x_b": sharding.model_block(p.conv_x_b, 0),
            "conv_bc_w": _shared(p.conv_bc_w),
            "conv_bc_b": _shared(p.conv_bc_b),
            "a_log": _cut(p.a_log, 0, heads),
            "d_skip": _cut(p.d_skip, 0, heads),
            "dt_bias": _cut(p.dt_bias, 0, heads),
            "norm_scale": _cut(p.norm_scale, 0, chans),
            "w_out": sharding.model_block(p.w_out, 0)}


def _mamba_project(w: dict, u, cfg: ModelConfig):
    """Returns z [B,S,d_inner], x_pre [B,S,d_inner], bc_pre [B,S,2GN],
    dt_pre [B,S,H] (pre-conv, pre-activation; d_inner and H this rank's
    under a split)."""
    cd = dtype_of(cfg.compute_dtype)
    uc = u.to(cd)
    return tuple(uc @ w[n].to(cd) for n in ("w_z", "w_x", "w_bc", "w_dt"))


def _mamba_split_bc(bc, cfg: ModelConfig, heads: slice):
    """B and C ``[B,S,h,N]`` of the model's heads ``heads``: head ``i``
    reads group ``i // (H / n_groups)``, so a rank's first head need not
    start a group.  Heads that share one group are a broadcast view of
    it; only the groups the heads read are repeated."""
    s = cfg.ssm
    _, nh, _ = _mamba_dims(cfg)
    gn = s.n_groups * s.state_dim
    b, sl = bc.shape[0], bc.shape[1]
    rep = nh // s.n_groups
    g0, g1 = heads.start // rep, -(-heads.stop // rep)
    skip = heads.start - g0 * rep

    def per_head(t):
        t = t.reshape(b, sl, s.n_groups, 1, s.state_dim)[:, :, g0:g1]
        t = t.expand(b, sl, g1 - g0, rep, s.state_dim).reshape(
            b, sl, (g1 - g0) * rep, s.state_dim)
        return t[:, :, skip:skip + heads.stop - heads.start]
    return per_head(bc[..., :gn]), per_head(bc[..., gn:2 * gn])


def apply_mamba2(p: Mamba2, u, cfg: ModelConfig) -> torch.Tensor:
    """Chunked SSD forward.  u [B,S,D] -> [B,S,D].  S % chunk == 0."""
    s = cfg.ssm
    cd = dtype_of(cfg.compute_dtype)
    bsz, slen, _ = u.shape
    q = min(s.chunk, slen)
    if slen % q:
        raise ValueError(f"seq {slen} not divisible by ssm chunk {q}")
    _, nh, _ = _mamba_dims(cfg)
    tp, heads = _head_split(nh)
    nh = heads.stop - heads.start
    w = _mamba_weights(p, cfg, tp)
    u = _enter(u, tp)

    z, x_pre, bc_pre, dt_pre = _mamba_project(w, u, cfg)
    x = F.silu(_causal_conv(x_pre, w["conv_x_w"].to(cd),
                            w["conv_x_b"].to(cd)))
    x = x.reshape(bsz, slen, nh, s.head_dim)
    bc = F.silu(_causal_conv(bc_pre, w["conv_bc_w"].to(cd),
                             w["conv_bc_b"].to(cd)))
    bb, cc = _mamba_split_bc(bc, cfg, heads)
    dt = F.softplus(dt_pre.float() + w["dt_bias"])
    da = -torch.exp(w["a_log"]) * dt                              # <= 0
    xdt = x.float() * dt[..., None]
    bb, cc = bb.float(), cc.float()
    mask = _tril(q, u.device)[None, :, :, None]

    state = torch.zeros((bsz, nh, s.head_dim, s.state_dim),
                        dtype=torch.float32, device=u.device)
    ys = []
    for c0 in range(0, slen, q):
        xdt_i, b_i, c_i, da_i = (t[:, c0:c0 + q] for t in (xdt, bb, cc, da))
        cum = torch.cumsum(da_i, dim=1)                   # [B,q,H]
        # intra-chunk (masked quadratic); mask BEFORE exp
        rel = cum[:, :, None, :] - cum[:, None, :, :]      # [B,q,q,H] i-j
        l_w = torch.exp(torch.where(mask, rel, _MASKED))
        sc = torch.einsum("bihn,bjhn->bijh", c_i, b_i) * l_w
        y = torch.einsum("bijh,bjhp->bihp", sc, xdt_i)
        # inter-chunk (state from previous chunks)
        y = y + torch.einsum("bihn,bhpn,bih->bihp", c_i, state,
                             torch.exp(cum))
        # state update for the next chunk
        decay_out = torch.exp(cum[:, -1:, :] - cum)        # [B,q,H]
        state = state * torch.exp(cum[:, -1])[..., None, None] + \
            torch.einsum("bjhn,bjhp,bjh->bhpn", b_i, xdt_i, decay_out)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + w["d_skip"][:, None] * x.float()
    y = y.reshape(bsz, slen, nh * s.head_dim).to(cd)
    y = _gated_rmsnorm(y, z, w["norm_scale"], cfg.norm_eps, tp)
    return _mixer_out(y, w["w_out"].to(cd), tp)


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """Conv windows and the SSD state of the heads this rank computes
    (all of them without a split); the B / C window is whole."""
    s = cfg.ssm
    _, heads = _head_split(_mamba_dims(cfg)[1])
    nh = heads.stop - heads.start
    gn = s.n_groups * s.state_dim
    return {
        "conv_x": torch.zeros((batch, s.conv_width - 1, nh * s.head_dim),
                              dtype=dtype, device=device),
        "conv_bc": torch.zeros((batch, s.conv_width - 1, 2 * gn),
                               dtype=dtype, device=device),
        "state": torch.zeros((batch, nh, s.head_dim, s.state_dim),
                             dtype=torch.float32, device=device),
    }


def mamba2_decode(p: Mamba2, u, cache: dict, cfg: ModelConfig):
    """One-token recurrent step.  u [B,1,D]."""
    s = cfg.ssm
    cd = dtype_of(cfg.compute_dtype)
    bsz = u.shape[0]
    _, nh, _ = _mamba_dims(cfg)
    tp, heads = _head_split(nh)
    nh = heads.stop - heads.start
    _check_cache(cache["state"].shape[1], nh, "SSD state (heads)")
    _check_cache(cache["conv_x"].shape[-1], nh * s.head_dim,
                 "x conv window (channels)")
    w = _mamba_weights(p, cfg, tp)
    u = _enter(u, tp)
    z, x_pre, bc_pre, dt_pre = _mamba_project(w, u, cfg)
    win_x = torch.cat([cache["conv_x"].to(cd), x_pre], dim=1)
    win_bc = torch.cat([cache["conv_bc"].to(cd), bc_pre], dim=1)
    x_t = F.silu(torch.einsum("bwc,wc->bc", win_x, w["conv_x_w"].to(cd))
                 + w["conv_x_b"].to(cd))
    bc_t = F.silu(
        torch.einsum("bwc,wc->bc", win_bc, w["conv_bc_w"].to(cd))
        + w["conv_bc_b"].to(cd))
    x = x_t.reshape(bsz, nh, s.head_dim)
    bb, cc = _mamba_split_bc(bc_t[:, None, :], cfg, heads)
    bb, cc = bb[:, 0], cc[:, 0]                        # [B,H,N]
    dt_t = F.softplus(dt_pre[:, 0].float() + w["dt_bias"])
    decay = torch.exp(-torch.exp(w["a_log"]) * dt_t)         # [B,H]
    state = cache["state"] * decay[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", x.float() * dt_t[..., None], bb.float())
    y = torch.einsum("bhpn,bhn->bhp", state, cc.float())
    y = y + w["d_skip"][:, None] * x.float()
    y = y.reshape(bsz, 1, nh * s.head_dim).to(cd)
    y = _gated_rmsnorm(y, z, w["norm_scale"], cfg.norm_eps, tp)
    new_cache = {"conv_x": win_x[:, 1:, :].to(cache["conv_x"].dtype),
                 "conv_bc": win_bc[:, 1:, :].to(cache["conv_bc"].dtype),
                 "state": state}
    return _mixer_out(y, w["w_out"].to(cd), tp), new_cache


# =================================================================== mLSTM

def _mlstm_dims(cfg: ModelConfig):
    d_inner = cfg.ssm.expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm.head_dim


class MLSTM(nn.Module):
    """``w_mq`` / ``w_mk`` / ``w_mv`` / ``w_ogate`` [d, d_inner],
    ``w_gates`` [d, 2H] (input and forget pre-activations), ``f_bias``
    (3.0: open forget gates), ``norm_scale``, ``w_out``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, *, device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = cfg.d_model
        d_inner, nh = _mlstm_dims(cfg)
        pd = param_dtype(cfg, dtype)
        self.w_mq = fan_in_init(gen, (d, d_inner), d, pd, device)
        self.w_mk = fan_in_init(gen, (d, d_inner), d, pd, device)
        self.w_mv = fan_in_init(gen, (d, d_inner), d, pd, device)
        self.w_gates = fan_in_init(gen, (d, 2 * nh), d, pd, device)
        self.w_ogate = fan_in_init(gen, (d, d_inner), d, pd, device)
        self.norm_scale = const((d_inner,), 1.0, device)
        self.w_out = fan_in_init(gen, (d_inner, d), d_inner, pd, device)
        self.f_bias = const((nh,), 3.0, device)


_MLSTM_LEAVES = ("w_mq", "w_mk", "w_mv", "w_gates", "w_ogate", "f_bias",
                 "norm_scale", "w_out")


def _mlstm_weights(p: MLSTM, cfg: ModelConfig, tp) -> dict:
    """mLSTM's leaves as this rank computes with them: whole without
    ``tp``.  Under it: the rank's d_inner block of the column-parallel
    ``w_mq`` / ``w_mk`` / ``w_mv`` / ``w_ogate`` and of ``norm_scale``,
    the rows of the row-parallel ``w_out``, and its heads' columns of
    both halves of ``w_gates`` (input gates, then forget gates) and of
    ``f_bias``, whose gradients are summed over the group."""
    if tp is None:
        return {n: full(getattr(p, n)) for n in _MLSTM_LEAVES}
    d_inner, nh = _mlstm_dims(cfg)
    heads, chans = tp.block(nh), tp.block(d_inner)
    gates = _shared(p.w_gates)
    return {"w_mq": sharding.model_block(p.w_mq, 1),
            "w_mk": sharding.model_block(p.w_mk, 1),
            "w_mv": sharding.model_block(p.w_mv, 1),
            "w_gates": torch.cat([gates[:, heads],
                                  gates[:, nh + heads.start:
                                        nh + heads.stop]], 1),
            "w_ogate": sharding.model_block(p.w_ogate, 1),
            "f_bias": _cut(p.f_bias, 0, heads),
            "norm_scale": _cut(p.norm_scale, 0, chans),
            "w_out": sharding.model_block(p.w_out, 0)}


def _mlstm_qkv(w: dict, u, nh: int, cfg: ModelConfig):
    s = cfg.ssm
    cd = dtype_of(cfg.compute_dtype)
    b, sl, _ = u.shape
    uc = u.to(cd)
    q = (uc @ w["w_mq"].to(cd)).reshape(b, sl, nh, s.head_dim)
    k = (uc @ w["w_mk"].to(cd)).reshape(b, sl, nh, s.head_dim)
    v = (uc @ w["w_mv"].to(cd)).reshape(b, sl, nh, s.head_dim)
    gates = (uc @ w["w_gates"].to(cd)).float()
    i_pre, f_pre = gates[..., :nh], gates[..., nh:]
    logf = F.logsigmoid(f_pre + w["f_bias"])
    k = k / torch.full((), float(s.head_dim), dtype=cd,
                       device=u.device).sqrt()
    return q, k, v, i_pre, logf


def _mlstm_out(w: dict, y, u, cfg: ModelConfig, tp):
    cd = dtype_of(cfg.compute_dtype)
    o = torch.sigmoid(u.to(cd) @ w["w_ogate"].to(cd))
    y = _gated_rmsnorm(y, torch.zeros_like(y) + 1.7159, w["norm_scale"],
                       cfg.norm_eps, tp) * o
    return _mixer_out(y, w["w_out"].to(cd), tp)


def apply_mlstm(p: MLSTM, u, cfg: ModelConfig) -> torch.Tensor:
    """Stabilized chunked-parallel mLSTM.  u [B,S,D] -> [B,S,D]."""
    s = cfg.ssm
    cd = dtype_of(cfg.compute_dtype)
    bsz, slen, _ = u.shape
    qq = min(s.chunk, slen)
    if slen % qq:
        raise ValueError(f"seq {slen} not divisible by ssm chunk {qq}")
    tp, heads = _head_split(_mlstm_dims(cfg)[1])
    nh = heads.stop - heads.start
    w = _mlstm_weights(p, cfg, tp)
    u = _enter(u, tp)
    q, k, v, i_pre, logf = _mlstm_qkv(w, u, nh, cfg)
    q, k, v = q.float(), k.float(), v.float()
    mask = _tril(qq, u.device)[None, :, :, None]
    p_dim = s.head_dim

    c_mat = torch.zeros((bsz, nh, p_dim, p_dim), dtype=torch.float32,
                        device=u.device)
    n_vec = torch.zeros((bsz, nh, p_dim), dtype=torch.float32,
                        device=u.device)
    m_run = torch.full((bsz, nh), _MASKED, dtype=torch.float32,
                       device=u.device)
    ys = []
    for c0 in range(0, slen, qq):
        qi, ki, vi, ii, fi = (t[:, c0:c0 + qq]
                              for t in (q, k, v, i_pre, logf))
        f_cum = torch.cumsum(fi, dim=1)                 # F_t  [B,q,H]
        b_log = ii - f_cum                              # b_j = i_j - F_j
        g = torch.maximum(torch.cummax(b_log, dim=1).values,
                          m_run[:, None, :])            # [B,q,H]
        m_i = f_cum + g                                 # stabilizer per pos
        # intra-chunk weights w_ij = exp(F_i + b_j - m_i), j <= i; the
        # argument is masked before the exp
        w_arg = b_log[:, None, :, :] - g[:, :, None, :]        # [B,i,j,H]
        wts = torch.exp(torch.where(mask, w_arg, _MASKED))
        qk = torch.einsum("bihp,bjhp->bijh", qi, ki)
        num = torch.einsum("bijh,bijh,bjhp->bihp", qk, wts, vi)
        # inter-chunk contribution with factor exp(m_prev - g_i)
        inter_w = torch.exp(m_run[:, None, :] - g)      # [B,q,H]
        num = num + torch.einsum("bihr,bhpr,bih->bihp", qi, c_mat, inter_w)
        # denominator: n_i = sum_j w_ij k_j + inter_w * n_prev
        n_i = torch.einsum("bijh,bjhp->bihp", wts, ki) + \
            inter_w[..., None] * n_vec[:, None, :, :]
        dot = torch.einsum("bihp,bihp->bih", qi, n_i)
        den = torch.maximum(torch.abs(dot), torch.exp(-m_i))
        ys.append(num / den[..., None])
        # carry update at chunk end
        g_end = g[:, -1, :]
        m_new = f_cum[:, -1, :] + g_end
        w_end = torch.exp(b_log - g_end[:, None, :])    # [B,j,H]
        c_mat = torch.exp(m_run - g_end)[..., None, None] * c_mat + \
            torch.einsum("bjh,bjhp,bjhr->bhpr", w_end, vi, ki)
        n_vec = torch.exp(m_run - g_end)[..., None] * n_vec + \
            torch.einsum("bjh,bjhp->bhp", w_end, ki)
        m_run = m_new
    y = torch.cat(ys, dim=1).reshape(bsz, slen, nh * p_dim).to(cd)
    return _mlstm_out(w, y, u, cfg, tp)


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """The matrix memory, normalizer and stabilizer of the heads this rank
    computes (all of them without a split)."""
    s = cfg.ssm
    _, heads = _head_split(_mlstm_dims(cfg)[1])
    nh = heads.stop - heads.start
    return {"C": torch.zeros((batch, nh, s.head_dim, s.head_dim),
                             dtype=torch.float32, device=device),
            "n": torch.zeros((batch, nh, s.head_dim), dtype=torch.float32,
                             device=device),
            "m": torch.full((batch, nh), _MASKED, dtype=torch.float32,
                            device=device)}


def mlstm_decode(p: MLSTM, u, cache: dict, cfg: ModelConfig):
    """One-token mLSTM recurrence (Beck et al. eqs. 19-27)."""
    cd = dtype_of(cfg.compute_dtype)
    bsz = u.shape[0]
    tp, heads = _head_split(_mlstm_dims(cfg)[1])
    nh = heads.stop - heads.start
    _check_cache(cache["C"].shape[1], nh, "matrix memory (heads)")
    w = _mlstm_weights(p, cfg, tp)
    u = _enter(u, tp)
    q, k, v, i_pre, logf = _mlstm_qkv(w, u, nh, cfg)
    q, k, v = (t[:, 0].float() for t in (q, k, v))
    i_t, f_t = i_pre[:, 0], logf[:, 0]                   # [B,H]
    m_new = torch.maximum(f_t + cache["m"], i_t)
    f_fac = torch.exp(f_t + cache["m"] - m_new)
    i_fac = torch.exp(i_t - m_new)
    c_new = f_fac[..., None, None] * cache["C"] + \
        i_fac[..., None, None] * torch.einsum("bhp,bhr->bhpr", v, k)
    n_new = f_fac[..., None] * cache["n"] + i_fac[..., None] * k
    num = torch.einsum("bhpr,bhr->bhp", c_new, q)
    dot = torch.einsum("bhp,bhp->bh", q, n_new)
    den = torch.maximum(torch.abs(dot), torch.exp(-m_new))
    y = (num / den[..., None]).reshape(bsz, 1, nh * cfg.ssm.head_dim).to(cd)
    return _mlstm_out(w, y, u, cfg, tp), {"C": c_new, "n": n_new,
                                          "m": m_new}


# =================================================================== sLSTM

class SLSTM(nn.Module):
    """``w_gates`` [d, 4d] (z, i, f, o), block-diagonal recurrence
    ``r_gates`` [H, dh, 4dh], ``gate_bias`` (forget 3.0), ``norm_scale``,
    ``w_out``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, *, device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = cfg.d_model
        nh = cfg.n_heads
        dh = d // nh
        pd = param_dtype(cfg, dtype)
        self.w_gates = fan_in_init(gen, (d, 4 * d), d, pd, device)
        self.r_gates = fan_in_init(gen, (nh, dh, 4 * dh), dh, pd, device)
        bias = torch.zeros((4 * d,), dtype=torch.float32, device=device)
        bias[2 * d:3 * d] = 3.0
        self.gate_bias = nn.Parameter(bias)
        self.norm_scale = const((d,), 1.0, device)
        self.w_out = fan_in_init(gen, (d, d), d, pd, device)


def _slstm_weights(p: SLSTM) -> tuple:
    """``(w_gates, r_gates, gate_bias)`` read once for every step (whole:
    sLSTM is replicated on every rank).  Each step casts the matrices to
    its dtype, as the reference's scan body does, so that their gradients
    add up over the steps in the parameter dtype."""
    return full(p.w_gates), full(p.r_gates), full(p.gate_bias)


def _slstm_step(w: tuple, x_t, state, cfg: ModelConfig):
    """x_t [B,D]; ``w`` = :func:`_slstm_weights`; state = (h, c, n, m)
    each [B,D] (heads folded)."""
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    w_gates, r_gates, gate_bias = w
    h, c, n, m = state
    bsz = x_t.shape[0]
    wx = x_t @ w_gates.to(x_t.dtype)                              # [B,4D]
    hh = h.reshape(bsz, nh, dh)
    rh = torch.einsum("bhd,hde->bhe", hh, r_gates.to(x_t.dtype))
    rh = rh.reshape(bsz, nh, 4, dh).transpose(1, 2).reshape(bsz, 4 * d)
    pre = (wx + rh).float() + gate_bias
    z_p, i_p, f_p, o_p = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(z_p)
    o = torch.sigmoid(o_p)
    logf = F.logsigmoid(f_p)
    m_new = torch.maximum(logf + m, i_p)
    i_g = torch.exp(i_p - m_new)
    f_g = torch.exp(logf + m - m_new)
    c_new = f_g * c + i_g * z
    n_new = f_g * n + i_g
    h_new = o * (c_new / torch.clamp(n_new, min=1e-6))
    return (h_new.to(x_t.dtype), c_new, n_new, m_new)


def _slstm_out(p, y, cfg: ModelConfig):
    cd = dtype_of(cfg.compute_dtype)
    var = torch.mean(torch.square(y.float()), -1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + cfg.norm_eps)
         * full(p.norm_scale)).to(cd)
    return y @ full(p.w_out).to(cd)


def apply_slstm(p: SLSTM, u, cfg: ModelConfig) -> torch.Tensor:
    """Sequential sLSTM over time.  u [B,S,D] -> [B,S,D]."""
    cd = dtype_of(cfg.compute_dtype)
    bsz, slen, d = u.shape
    uc = u.to(cd)
    cache = init_slstm_cache(cfg, bsz, cd, u.device)
    state = (cache["h"], cache["c"], cache["n"], cache["m"])
    w = _slstm_weights(p)
    hs = []
    for t in range(slen):
        state = _slstm_step(w, uc[:, t], state, cfg)
        hs.append(state[0])
    return _slstm_out(p, torch.stack(hs, dim=1), cfg)


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d = cfg.d_model
    return {"h": torch.zeros((batch, d), dtype=dtype, device=device),
            "c": torch.zeros((batch, d), dtype=torch.float32, device=device),
            "n": torch.zeros((batch, d), dtype=torch.float32, device=device),
            "m": torch.full((batch, d), _MASKED, dtype=torch.float32,
                            device=device)}


def slstm_decode(p: SLSTM, u, cache: dict, cfg: ModelConfig):
    cd = dtype_of(cfg.compute_dtype)
    state = (cache["h"].to(cd), cache["c"], cache["n"], cache["m"])
    new = _slstm_step(_slstm_weights(p), u[:, 0].to(cd), state, cfg)
    out = _slstm_out(p, new[0][:, None, :], cfg)
    return out, {"h": new[0], "c": new[1], "n": new[2], "m": new[3]}
