"""Attention mixers: GQA (+RoPE, softcap, local windows, blocked long-seq
form), DeepSeek-V2 MLA (with absorbed decode), and KV-cache decode steps
(port of ``repro.models.attention``).

Layouts:  q ``[B, S, Hp, Dh]`` where ``Hp`` is the *padded* head count
(heads are padded with dummies so the head axis divides the
tensor-parallel mesh axis; dummy outputs are masked, so semantics match
the unpadded model exactly).  K/V are projected at the true ``Hkv`` and
gather-expanded to ``Hp`` (GQA grouping for any ``Hp/Hkv`` ratio).  All
matmuls run in the config compute dtype with float32 softmax; masked
scores take the finite ``NEG_INF``, as in the reference.  Caches are
dicts storing *unexpanded* KV; a decode step writes the new slot into the
cache tensors in place.

These are plain matrix products: like the reference, the models never
call the flash-attention kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (const, dtype_of, fan_in_init, full,
                                       param_dtype, softcap)

NEG_INF = -1e30


def padded_heads(cfg: ModelConfig) -> int:
    return cfg.head_pad_to or cfg.n_heads


def _head_mask(cfg: ModelConfig, dtype, device):
    hp = padded_heads(cfg)
    if hp == cfg.n_heads:
        return None
    return (torch.arange(hp, device=device) < cfg.n_heads).to(dtype)


def _kv_map(cfg: ModelConfig, device=None) -> torch.Tensor:
    """For each (padded) q head, the kv head it attends with."""
    hp, h, kv = padded_heads(cfg), cfg.n_heads, cfg.n_kv_heads
    g = max(h // kv, 1)
    return torch.clamp(torch.arange(hp, device=device) // g, 0, kv - 1)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


# ------------------------------------------------------------------ RoPE

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding on the leading ``fraction`` of the head dim.

    x [B, S, H, D]; positions [B, S] (absolute token positions).
    """
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                # [B, S, half]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1 = xr[..., :half].float()
    x2 = xr[..., half:].float()
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), xp], dim=-1)


# ------------------------------------------------------- core attention

def _sdpa(q, k, v, *, scale, causal, q_pos, k_pos, window=0, cap=0.0):
    """Per-head scaled-dot-product attention with float32 softmax.

    q [B,S,H,D], k/v [B,T,H,D] (already head-expanded); q_pos [B,S],
    k_pos [B,T] absolute positions for causal/window masks.
    """
    scores = torch.einsum("bshd,bthd->bhst", q, k).float()
    scores = softcap(scores * scale, cap)
    mask = None
    if causal:
        mask = q_pos[:, :, None] >= k_pos[:, None, :]
    if window:
        near = q_pos[:, :, None] - k_pos[:, None, :] < window
        mask = near if mask is None else mask & near
    if mask is not None:
        scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _blocked_causal(q, k, v, *, scale, q_pos, k_pos, window, cap,
                    chunk_q, chunk_k):
    """Memory-bounded causal attention: a loop over q chunks, an inner
    loop over k chunks with online softmax.  Rectangle+mask, as the
    reference (every chunk pair is computed); peak score memory
    [B, H, chunk_q, chunk_k]."""
    b, s, h, d = q.shape
    t = k.shape[1]
    nq, nk = s // chunk_q, t // chunk_k
    outs = []
    for i in range(nq):
        qi = q[:, i * chunk_q:(i + 1) * chunk_q]
        qpi = q_pos[:, i * chunk_q:(i + 1) * chunk_q]
        m = torch.full((b, h, chunk_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, chunk_q), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, h, chunk_q, d), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            ki = k[:, j * chunk_k:(j + 1) * chunk_k]
            vi = v[:, j * chunk_k:(j + 1) * chunk_k]
            kpi = k_pos[:, j * chunk_k:(j + 1) * chunk_k]
            sc = torch.einsum("bshd,bthd->bhst", qi, ki)
            sc = softcap(sc.float() * scale, cap)
            msk = qpi[:, :, None] >= kpi[:, None, :]
            if window:
                msk = msk & (qpi[:, :, None] - kpi[:, None, :] < window)
            sc = torch.where(msk[:, None, :, :], sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhst,bthd->bhsd", p.to(vi.dtype), vi).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2))                    # [B,cq,H,D]
    return torch.cat(outs, dim=1)


# --------------------------------------------------------------- GQA attn

class Attention(nn.Module):
    """``w_q`` [d, Hp, dh], ``w_k`` / ``w_v`` [d, Hkv, dh], ``w_o``
    [Hp, dh, d]; ``b_q`` / ``b_k`` / ``b_v`` with ``qkv_bias``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, *, device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d, kv, dh = cfg.d_model, cfg.n_kv_heads, cfg.resolved_head_dim
        hp = padded_heads(cfg)
        pd = param_dtype(cfg, dtype)
        self.w_q = fan_in_init(gen, (d, hp, dh), d, pd, device)
        self.w_k = fan_in_init(gen, (d, kv, dh), d, pd, device)
        self.w_v = fan_in_init(gen, (d, kv, dh), d, pd, device)
        self.w_o = fan_in_init(gen, (hp, dh, d), cfg.n_heads * dh, pd,
                               device)
        for name, shape in (("b_q", (hp, dh)), ("b_k", (kv, dh)),
                            ("b_v", (kv, dh))):
            if cfg.qkv_bias:
                setattr(self, name, const(shape, 0.0, device, pd))
            else:
                self.register_parameter(name, None)


def _project_q(p, x, cfg: ModelConfig, positions, use_rope=True):
    cd = dtype_of(cfg.compute_dtype)
    q = torch.einsum("bsd,dhe->bshe", x.to(cd), full(p.w_q).to(cd))
    if p.b_q is not None:
        q = q + full(p.b_q).to(cd)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    return constrain(q, "batch", None, "heads", None)


def _project_kv(p, x, cfg: ModelConfig, positions, use_rope=True):
    cd = dtype_of(cfg.compute_dtype)
    k = torch.einsum("bsd,dhe->bshe", x.to(cd), full(p.w_k).to(cd))
    v = torch.einsum("bsd,dhe->bshe", x.to(cd), full(p.w_v).to(cd))
    if p.b_k is not None:
        k, v = k + full(p.b_k).to(cd), v + full(p.b_v).to(cd)
    if use_rope:
        k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return k, v


def _expand_kv(k, v, cfg: ModelConfig):
    """Gather kv heads up to the padded q-head count (GQA for any ratio)."""
    idx = _kv_map(cfg, k.device)
    return k[:, :, idx, :], v[:, :, idx, :]


def _finish(p, out, cfg: ModelConfig):
    cd = dtype_of(cfg.compute_dtype)
    mask = _head_mask(cfg, out.dtype, out.device)
    if mask is not None:
        out = out * mask[None, None, :, None]
    return torch.einsum("bshe,hed->bsd", out.to(cd), full(p.w_o).to(cd))


def attention(p: Attention, x, cfg: ModelConfig, *, positions, causal=True,
              window=0, cross_kv=None) -> torch.Tensor:
    """Full-sequence attention (train / prefill / encoder / cross)."""
    dh = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(dh)
    if cross_kv is not None:
        q = _project_q(p, x, cfg, positions, use_rope=False)
        k, v = _expand_kv(*cross_kv, cfg)
        k_pos = _positions(k.shape[0], k.shape[1], k.device)
        out = _sdpa(q, k, v, scale=scale, causal=False, q_pos=positions,
                    k_pos=k_pos, cap=cfg.attn_softcap)
        return _finish(p, out, cfg)
    q = _project_q(p, x, cfg, positions)
    k, v = _project_kv(p, x, cfg, positions)
    k, v = _expand_kv(k, v, cfg)
    s = x.shape[1]
    long_seq = (s >= cfg.blocked_attn_threshold and causal
                and s % cfg.attn_chunk_q == 0
                and k.shape[1] % cfg.attn_chunk_k == 0)
    if long_seq:
        out = _blocked_causal(q, k, v, scale=scale, q_pos=positions,
                              k_pos=positions, window=window,
                              cap=cfg.attn_softcap,
                              chunk_q=cfg.attn_chunk_q,
                              chunk_k=cfg.attn_chunk_k)
    else:
        out = _sdpa(q, k, v, scale=scale, causal=causal, q_pos=positions,
                    k_pos=positions, window=window, cap=cfg.attn_softcap)
    return _finish(p, out, cfg)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device) -> dict:
    kv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    return {"k": torch.zeros((batch, max_len, kv, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, kv, dh), dtype=dtype,
                             device=device)}


def attention_decode(p: Attention, x, cache: Optional[dict], pos: int,
                     cfg: ModelConfig, *, window=0, cross_kv=None):
    """One-token decode step.  ``x [B, 1, D]``, ``pos`` the current length
    (a Python int).  Returns (out, cache): the new K/V are written into
    slot ``pos`` of the cache tensors in place."""
    b = x.shape[0]
    dh = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(dh)
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    if cross_kv is not None:
        q = _project_q(p, x, cfg, positions, use_rope=False)
        # the cross caches keep the state's dtype (bf16 by default); the
        # products take q's, as the self-attention branch reads its cache
        k, v = _expand_kv(*(c.to(q.dtype) for c in cross_kv), cfg)
        k_pos = _positions(b, k.shape[1], k.device)
        out = _sdpa(q, k, v, scale=scale, causal=False, q_pos=positions,
                    k_pos=k_pos, cap=cfg.attn_softcap)
        return _finish(p, out, cfg), cache
    q = _project_q(p, x, cfg, positions)
    k_new, v_new = _project_kv(p, x, cfg, positions)
    cache["k"][:, pos:pos + 1] = k_new.to(cache["k"].dtype)
    cache["v"][:, pos:pos + 1] = v_new.to(cache["v"].dtype)
    t = cache["k"].shape[1]
    k_pos = _positions(b, t, x.device)
    k_valid = k_pos <= pos
    # grouped decode: contract each kv head's group of real q heads
    # against the UNEXPANDED cache (the [B, T, Hp, Dh] head-expanded KV
    # never materializes).  q head i reads kv head i // (H / Hkv), as the
    # forward's _kv_map; the padded dummy heads read zero (masked in
    # _finish).  The reference groups the *padded* heads (Hp / Hkv a
    # group), which disagrees with its forward whenever GQA heads are
    # padded (qwen2-0.5b: 14 -> 16 heads, 2 kv heads).
    hp, h, kv = padded_heads(cfg), cfg.n_heads, cfg.n_kv_heads
    g = h // kv
    kc = cache["k"].to(q.dtype)
    vc = cache["v"].to(q.dtype)
    qg = q[:, :, :h].reshape(b, 1, kv, g, dh)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, kc).float()
    sc = softcap(sc * scale, cfg.attn_softcap)
    mask = k_valid[:, None, :]
    if window:
        mask = mask & (positions[:, :, None] - k_pos[:, None, :] < window)
    sc = torch.where(mask[:, None, None, :, :], sc, NEG_INF)
    probs = torch.softmax(sc, dim=-1).to(vc.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, vc).reshape(b, 1, h, dh)
    if hp > h:
        out = F.pad(out, (0, 0, 0, hp - h))
    return _finish(p, out, cfg), cache


# ------------------------------------------------------------------- MLA

class MLA(nn.Module):
    """DeepSeek-V2 multi-head latent attention: ``w_q`` [d, H, nope+rope],
    ``w_dkv`` [d, r], ``w_kpe`` [d, rope], ``kv_norm`` [r], ``w_uk``
    [r, H, nope], ``w_uv`` [r, H, v], ``w_o`` [H, v, d]."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, *, device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        pd = param_dtype(cfg, dtype)
        qd = m.qk_nope_dim + m.qk_rope_dim
        self.w_q = fan_in_init(gen, (d, h, qd), d, pd, device)
        self.w_dkv = fan_in_init(gen, (d, m.kv_lora_rank), d, pd, device)
        self.w_kpe = fan_in_init(gen, (d, m.qk_rope_dim), d, pd, device)
        self.kv_norm = const((m.kv_lora_rank,), 1.0, device)
        self.w_uk = fan_in_init(gen, (m.kv_lora_rank, h, m.qk_nope_dim),
                                m.kv_lora_rank, pd, device)
        self.w_uv = fan_in_init(gen, (m.kv_lora_rank, h, m.v_head_dim),
                                m.kv_lora_rank, pd, device)
        self.w_o = fan_in_init(gen, (h, m.v_head_dim, d), h * m.v_head_dim,
                               pd, device)


def _mla_latents(p, x, cfg: ModelConfig, positions):
    """Shared path: compressed KV latent + roped positional key."""
    cd = dtype_of(cfg.compute_dtype)
    ckv = x.to(cd) @ full(p.w_dkv).to(cd)                    # [B,S,r]
    var = torch.mean(torch.square(ckv.float()), -1, keepdim=True)
    ckv = (ckv.float() * torch.rsqrt(var + cfg.norm_eps)
           * full(p.kv_norm)).to(cd)
    kpe = (x.to(cd) @ full(p.w_kpe).to(cd))[:, :, None, :]
    kpe = rope(kpe, positions, cfg.rope_theta)[:, :, 0, :]  # [B,S,r']
    return ckv, kpe


def _mla_queries(p, x, cfg: ModelConfig, positions):
    m, cd = cfg.mla, dtype_of(cfg.compute_dtype)
    q = torch.einsum("bsd,dhe->bshe", x.to(cd), full(p.w_q).to(cd))
    q = constrain(q, "batch", None, "heads", None)
    q_nope, q_pe = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_pe = rope(q_pe, positions, cfg.rope_theta)
    return q_nope, q_pe


def mla_attention(p: MLA, x, cfg: ModelConfig, *, positions) -> torch.Tensor:
    """Training / prefill MLA (explicit k/v materialization)."""
    m, cd = cfg.mla, dtype_of(cfg.compute_dtype)
    ckv, kpe = _mla_latents(p, x, cfg, positions)
    q_nope, q_pe = _mla_queries(p, x, cfg, positions)
    k_nope = torch.einsum("btr,rhe->bthe", ckv, full(p.w_uk).to(cd))
    v = torch.einsum("btr,rhe->bthe", ckv, full(p.w_uv).to(cd))
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    sc = (torch.einsum("bshe,bthe->bhst", q_nope, k_nope)
          + torch.einsum("bshe,bte->bhst", q_pe, kpe)).float()
    mask = positions[:, :, None] >= positions[:, None, :]
    sc = torch.where(mask[:, None, :, :], sc * scale, NEG_INF)
    probs = torch.softmax(sc, -1).to(cd)
    out = torch.einsum("bhst,bthe->bshe", probs, v)
    return torch.einsum("bshe,hed->bsd", out, full(p.w_o).to(cd))


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank),
                               dtype=dtype, device=device),
            "kpe": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dtype,
                               device=device)}


def mla_decode(p: MLA, x, cache: dict, pos: int, cfg: ModelConfig):
    """Absorbed one-token MLA decode: attend in the r-dim latent space —
    the cache stays compressed (DeepSeek-V2 §2.1)."""
    m, cd = cfg.mla, dtype_of(cfg.compute_dtype)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    ckv_new, kpe_new = _mla_latents(p, x, cfg, positions)
    cache["ckv"][:, pos:pos + 1] = ckv_new.to(cache["ckv"].dtype)
    cache["kpe"][:, pos:pos + 1] = kpe_new.to(cache["kpe"].dtype)
    q_nope, q_pe = _mla_queries(p, x, cfg, positions)
    q_abs = torch.einsum("bshe,rhe->bshr", q_nope, full(p.w_uk).to(cd))
    t = cache["ckv"].shape[1]
    ckv, kpe = cache["ckv"].to(cd), cache["kpe"].to(cd)
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    sc = (torch.einsum("bshr,btr->bhst", q_abs, ckv)
          + torch.einsum("bshe,bte->bhst", q_pe, kpe)).float()
    valid = torch.arange(t, device=x.device)[None, :] <= pos
    sc = torch.where(valid[:, None, None, :], sc * scale, NEG_INF)
    probs = torch.softmax(sc, -1).to(cd)
    ctx = torch.einsum("bhst,btr->bshr", probs, ckv)
    out = torch.einsum("bshr,rhe->bshe", ctx, full(p.w_uv).to(cd))
    return torch.einsum("bshe,hed->bsd", out, full(p.w_o).to(cd)), cache
