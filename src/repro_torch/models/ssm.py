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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (const, dtype_of, fan_in_init, full,
                                       param_dtype)

_MASKED = -1e30


def _gated_rmsnorm(y, z, scale, eps):
    """Mamba2-style output norm: RMSNorm(y * silu(z)) * scale."""
    g = y * F.silu(z.float()).to(y.dtype)
    var = torch.mean(torch.square(g.float()), -1, keepdim=True)
    return (g.float() * torch.rsqrt(var + eps) * scale).to(y.dtype)


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


def _mamba_project(p, u, cfg: ModelConfig):
    """Returns z [B,S,d_inner], x_pre [B,S,d_inner], bc_pre [B,S,2GN],
    dt_pre [B,S,H] (pre-conv, pre-activation)."""
    cd = dtype_of(cfg.compute_dtype)
    uc = u.to(cd)
    return tuple(uc @ full(w).to(cd) for w in (p.w_z, p.w_x, p.w_bc, p.w_dt))


def _mamba_split_bc(bc, cfg: ModelConfig):
    s = cfg.ssm
    _, nh, _ = _mamba_dims(cfg)
    gn = s.n_groups * s.state_dim
    bb, cc = bc[..., :gn], bc[..., gn:2 * gn]
    b, sl = bb.shape[0], bb.shape[1]
    rep = nh // s.n_groups
    bb = torch.repeat_interleave(
        bb.reshape(b, sl, s.n_groups, s.state_dim), rep, dim=2)
    cc = torch.repeat_interleave(
        cc.reshape(b, sl, s.n_groups, s.state_dim), rep, dim=2)
    return bb, cc


def apply_mamba2(p: Mamba2, u, cfg: ModelConfig) -> torch.Tensor:
    """Chunked SSD forward.  u [B,S,D] -> [B,S,D].  S % chunk == 0."""
    s = cfg.ssm
    cd = dtype_of(cfg.compute_dtype)
    bsz, slen, _ = u.shape
    d_inner, nh, _ = _mamba_dims(cfg)
    q = min(s.chunk, slen)
    if slen % q:
        raise ValueError(f"seq {slen} not divisible by ssm chunk {q}")

    z, x_pre, bc_pre, dt_pre = _mamba_project(p, u, cfg)
    x = F.silu(_causal_conv(x_pre, full(p.conv_x_w).to(cd),
                            full(p.conv_x_b).to(cd)))
    x = x.reshape(bsz, slen, nh, s.head_dim)
    bc = F.silu(_causal_conv(bc_pre, full(p.conv_bc_w).to(cd),
                             full(p.conv_bc_b).to(cd)))
    bb, cc = _mamba_split_bc(bc, cfg)
    dt = F.softplus(dt_pre.float() + full(p.dt_bias))
    da = -torch.exp(full(p.a_log)) * dt                           # <= 0
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
    y = y + full(p.d_skip)[:, None] * x.float()
    y = y.reshape(bsz, slen, d_inner).to(cd)
    y = _gated_rmsnorm(y, z, full(p.norm_scale), cfg.norm_eps)
    return y @ full(p.w_out).to(cd)


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    s = cfg.ssm
    d_inner, nh, _ = _mamba_dims(cfg)
    gn = s.n_groups * s.state_dim
    return {
        "conv_x": torch.zeros((batch, s.conv_width - 1, d_inner),
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
    d_inner, nh, _ = _mamba_dims(cfg)
    z, x_pre, bc_pre, dt_pre = _mamba_project(p, u, cfg)
    win_x = torch.cat([cache["conv_x"].to(cd), x_pre], dim=1)
    win_bc = torch.cat([cache["conv_bc"].to(cd), bc_pre], dim=1)
    x_t = F.silu(torch.einsum("bwc,wc->bc", win_x, full(p.conv_x_w).to(cd))
                 + full(p.conv_x_b).to(cd))
    bc_t = F.silu(
        torch.einsum("bwc,wc->bc", win_bc, full(p.conv_bc_w).to(cd))
        + full(p.conv_bc_b).to(cd))
    x = x_t.reshape(bsz, nh, s.head_dim)
    bb, cc = _mamba_split_bc(bc_t[:, None, :], cfg)
    bb, cc = bb[:, 0], cc[:, 0]                        # [B,H,N]
    dt_t = F.softplus(dt_pre[:, 0].float() + full(p.dt_bias))
    decay = torch.exp(-torch.exp(full(p.a_log)) * dt_t)      # [B,H]
    state = cache["state"] * decay[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", x.float() * dt_t[..., None], bb.float())
    y = torch.einsum("bhpn,bhn->bhp", state, cc.float())
    y = y + full(p.d_skip)[:, None] * x.float()
    y = y.reshape(bsz, 1, d_inner).to(cd)
    y = _gated_rmsnorm(y, z, full(p.norm_scale), cfg.norm_eps)
    new_cache = {"conv_x": win_x[:, 1:, :].to(cache["conv_x"].dtype),
                 "conv_bc": win_bc[:, 1:, :].to(cache["conv_bc"].dtype),
                 "state": state}
    return y @ full(p.w_out).to(cd), new_cache


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


def _mlstm_qkv(p, u, cfg: ModelConfig):
    s = cfg.ssm
    cd = dtype_of(cfg.compute_dtype)
    b, sl, _ = u.shape
    _, nh = _mlstm_dims(cfg)
    uc = u.to(cd)
    q = (uc @ full(p.w_mq).to(cd)).reshape(b, sl, nh, s.head_dim)
    k = (uc @ full(p.w_mk).to(cd)).reshape(b, sl, nh, s.head_dim)
    v = (uc @ full(p.w_mv).to(cd)).reshape(b, sl, nh, s.head_dim)
    gates = (uc @ full(p.w_gates).to(cd)).float()
    i_pre, f_pre = gates[..., :nh], gates[..., nh:]
    logf = F.logsigmoid(f_pre + full(p.f_bias))
    k = k / torch.full((), float(s.head_dim), dtype=cd,
                       device=u.device).sqrt()
    return q, k, v, i_pre, logf


def _mlstm_out(p, y, u, cfg: ModelConfig):
    cd = dtype_of(cfg.compute_dtype)
    o = torch.sigmoid(u.to(cd) @ full(p.w_ogate).to(cd))
    y = _gated_rmsnorm(y, torch.zeros_like(y) + 1.7159, full(p.norm_scale),
                       cfg.norm_eps) * o
    return y @ full(p.w_out).to(cd)


def apply_mlstm(p: MLSTM, u, cfg: ModelConfig) -> torch.Tensor:
    """Stabilized chunked-parallel mLSTM.  u [B,S,D] -> [B,S,D]."""
    s = cfg.ssm
    cd = dtype_of(cfg.compute_dtype)
    bsz, slen, _ = u.shape
    d_inner, nh = _mlstm_dims(cfg)
    qq = min(s.chunk, slen)
    if slen % qq:
        raise ValueError(f"seq {slen} not divisible by ssm chunk {qq}")
    q, k, v, i_pre, logf = _mlstm_qkv(p, u, cfg)
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
        w = torch.exp(torch.where(mask, w_arg, _MASKED))
        qk = torch.einsum("bihp,bjhp->bijh", qi, ki)
        num = torch.einsum("bijh,bijh,bjhp->bihp", qk, w, vi)
        # inter-chunk contribution with factor exp(m_prev - g_i)
        inter_w = torch.exp(m_run[:, None, :] - g)      # [B,q,H]
        num = num + torch.einsum("bihr,bhpr,bih->bihp", qi, c_mat, inter_w)
        # denominator: n_i = sum_j w_ij k_j + inter_w * n_prev
        n_i = torch.einsum("bijh,bjhp->bihp", w, ki) + \
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
    y = torch.cat(ys, dim=1).reshape(bsz, slen, d_inner).to(cd)
    return _mlstm_out(p, y, u, cfg)


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    s = cfg.ssm
    _, nh = _mlstm_dims(cfg)
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
    d_inner, _ = _mlstm_dims(cfg)
    q, k, v, i_pre, logf = _mlstm_qkv(p, u, cfg)
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
    y = (num / den[..., None]).reshape(bsz, 1, d_inner).to(cd)
    return _mlstm_out(p, y, u, cfg), {"C": c_new, "n": n_new, "m": m_new}


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


def _slstm_step(p, x_t, state, cfg: ModelConfig):
    """x_t [B,D]; state = (h, c, n, m) each [B,D] (heads folded)."""
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    h, c, n, m = state
    bsz = x_t.shape[0]
    wx = x_t @ full(p.w_gates).to(x_t.dtype)                      # [B,4D]
    hh = h.reshape(bsz, nh, dh)
    rh = torch.einsum("bhd,hde->bhe", hh, full(p.r_gates).to(x_t.dtype))
    rh = rh.reshape(bsz, nh, 4, dh).transpose(1, 2).reshape(bsz, 4 * d)
    pre = (wx + rh).float() + full(p.gate_bias)
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
    hs = []
    for t in range(slen):
        state = _slstm_step(p, uc[:, t], state, cfg)
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
    new = _slstm_step(p, u[:, 0].to(cd), state, cfg)
    out = _slstm_out(p, new[0][:, None, :], cfg)
    return out, {"h": new[0], "c": new[1], "n": new[2], "m": new[3]}
