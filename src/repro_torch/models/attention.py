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

Under tensor parallelism on ``heads`` (``sharding.use_sharding``, the
padded q heads dividing the model group) a rank computes its block of
the q heads, the kv heads those read (its own ``w_k`` / ``w_v`` block
where every rank's q heads read exactly its block; otherwise the leaves
are read whole and cut, since a padded GQA rank's q heads may read
another rank's kv head) and a row-parallel ``w_o``.  Under ``kv_seq`` a
decode cache holds this rank's slice of the sequence (``init_decode_state``
allocates it): the rank owning slot ``pos`` writes it, and each rank
attends every head over its positions, combined by an all-reduce of the
softmax's max and sum (flash-decoding).

These are plain matrix products: like the reference, the models never
call the flash-attention kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

import torch.distributed as dist

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (const, dtype_of, fan_in_init, full,
                                       param_dtype, softcap, tp_splits)

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


def _kv_heads(cfg: ModelConfig):
    """``(lo, hi, own)`` under tensor parallelism on heads: the kv heads
    ``[lo, hi)`` this rank's q heads read (:func:`_kv_map`), and whether
    every rank's q heads read exactly its own block of the kv heads (then
    each reads its stored block; the test is the same on every rank,
    which all must take the same path)."""
    tp = sharding.tensor_parallel()
    kv_map = _kv_map(cfg).tolist()

    def read(r):
        ks = kv_map[tp.block(len(kv_map), r)]
        return min(ks), max(ks) + 1

    kv = cfg.n_kv_heads
    own = kv % tp.size == 0 and all(
        read(r) == (tp.block(kv, r).start, tp.block(kv, r).stop)
        for r in range(tp.size))
    return (*read(tp.rank), own)


def _head_w(t: torch.Tensor, dim: int, tp: bool) -> torch.Tensor:
    """A head-indexed parameter: this rank's block of heads along ``dim``
    under tensor parallelism, else whole."""
    return sharding.model_block(t, dim) if tp else full(t)


def _kv_w(t: torch.Tensor, dim: int, heads) -> torch.Tensor:
    """``w_k`` / ``w_v`` (``dim`` 1) or a bias (``dim`` 0) at the kv heads
    ``heads`` (:func:`_kv_heads`; None: whole)."""
    if heads is None:
        return full(t)
    lo, hi, own = heads
    return sharding.model_block(t, dim) if own else \
        sharding.param_slice(t, dim, lo, hi)


def _seq_split() -> Optional[sharding.TensorParallel]:
    """The tensor parallelism that splits a decode cache's sequence
    (``kv_seq``), or None."""
    tp = sharding.tensor_parallel()
    return tp if tp is not None and tp.kv_seq else None


def cache_len(max_len: int) -> int:
    """A decode cache's slots on this rank: ``max_len`` split over the
    model group under ``kv_seq`` (rounded up: slots past ``max_len`` are
    never written and always masked)."""
    seq = _seq_split()
    return max_len if seq is None else -(-max_len // seq.size)


def _write_slot(cache: dict, pos: int, **new) -> int:
    """Write each ``new[key]`` into slot ``pos`` of ``cache[key]`` where
    this rank holds it; returns the global position of its first slot.
    No collective here: only the owner writes.  Raises where no rank of
    the active sharding holds slot ``pos`` (a state made under another
    sharding, or too short), which would otherwise drop the write."""
    seq = _seq_split()
    t = next(iter(cache.values())).shape[1]
    ranks = seq.size if seq is not None else 1
    if not 0 <= pos < ranks * t:
        raise ValueError(
            f"decode position {pos} is past the cache's {ranks} x {t} "
            f"slots: make the decode state (init_decode_state) under the "
            f"sharding that decodes it")
    off = seq.rank * t if seq is not None else 0
    if off <= pos < off + t:
        for key, val in new.items():
            cache[key][:, pos - off:pos - off + 1] = val.to(cache[key].dtype)
    return off


def _softmax_positions(sc: torch.Tensor) -> torch.Tensor:
    """Softmax along the last axis, the cache's positions.  Under
    ``kv_seq`` those are this rank's slice: the max and the sum are
    all-reduced over the group, and the result is this rank's share of
    the whole softmax (its products then sum over the group)."""
    seq = _seq_split()
    if seq is None:
        return torch.softmax(sc, dim=-1)
    m = sharding.model_all_reduce(sc.amax(-1, keepdim=True), seq,
                                  dist.ReduceOp.MAX)
    e = torch.exp(sc - m)
    return e / sharding.model_all_reduce(e.sum(-1, keepdim=True), seq)


def _sum_positions(t: torch.Tensor) -> torch.Tensor:
    """A product over the cache's positions, summed over the ranks that
    split them."""
    seq = _seq_split()
    return t if seq is None else sharding.model_all_reduce(t, seq)


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


def _project_q(p, x, cfg: ModelConfig, positions, use_rope=True, tp=False):
    """q ``[B, S, Hp, Dh]``, or this rank's block of its heads (``tp``)."""
    cd = dtype_of(cfg.compute_dtype)
    q = torch.einsum("bsd,dhe->bshe", x.to(cd),
                     _head_w(p.w_q, 1, tp).to(cd))
    if p.b_q is not None:
        q = q + _head_w(p.b_q, 0, tp).to(cd)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    return constrain(q, "batch", None, "heads", None)


def _project_kv(p, x, cfg: ModelConfig, positions, use_rope=True,
                heads=None):
    """k, v ``[B, S, Hkv, Dh]``, or at the kv heads ``heads``
    (:func:`_kv_heads`)."""
    cd = dtype_of(cfg.compute_dtype)
    k = torch.einsum("bsd,dhe->bshe", x.to(cd),
                     _kv_w(p.w_k, 1, heads).to(cd))
    v = torch.einsum("bsd,dhe->bshe", x.to(cd),
                     _kv_w(p.w_v, 1, heads).to(cd))
    if p.b_k is not None:
        k = k + _kv_w(p.b_k, 0, heads).to(cd)
        v = v + _kv_w(p.b_v, 0, heads).to(cd)
    if use_rope:
        k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return k, v


def _expand_kv(k, v, cfg: ModelConfig, heads=None):
    """Gather kv heads up to the padded q-head count (GQA for any ratio);
    with ``heads`` (:func:`_kv_heads`), ``k`` / ``v`` hold the kv heads
    ``[lo, hi)`` and expand to this rank's q heads."""
    idx = _kv_map(cfg, k.device)
    if heads is not None:
        idx = idx[sharding.tensor_parallel().block(len(idx))] - heads[0]
    return k[:, :, idx, :], v[:, :, idx, :]


def _finish(p, out, cfg: ModelConfig, tp=False):
    """Mask the dummy heads, project with ``w_o`` (row-parallel under
    ``tp``: ``out`` holds this rank's heads, the ranks' products summed)."""
    cd = dtype_of(cfg.compute_dtype)
    mask = _head_mask(cfg, out.dtype, out.device)
    if mask is not None:
        if tp:
            mask = mask[sharding.tensor_parallel().block(len(mask))]
        out = out * mask[None, None, :, None]
    y = torch.einsum("bshe,hed->bsd", out.to(cd),
                     _head_w(p.w_o, 0, tp).to(cd))
    return sharding.reduce_from_model(y) if tp else y


def attention(p: Attention, x, cfg: ModelConfig, *, positions, causal=True,
              window=0, cross_kv=None) -> torch.Tensor:
    """Full-sequence attention (train / prefill / encoder / cross).  ``x``
    (and ``cross_kv``) replicated over the model group; under tensor
    parallelism on heads a rank computes its block of the heads."""
    dh = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(dh)
    tp = tp_splits("heads", padded_heads(cfg))
    heads = _kv_heads(cfg) if tp else None
    if tp:
        x = sharding.copy_to_model(x)
    if cross_kv is not None:
        q = _project_q(p, x, cfg, positions, use_rope=False, tp=tp)
        if tp:
            lo, hi, _ = heads
            cross_kv = tuple(sharding.copy_to_model(c).narrow(2, lo, hi - lo)
                             for c in cross_kv)
        k, v = _expand_kv(*cross_kv, cfg, heads)
        k_pos = _positions(k.shape[0], k.shape[1], k.device)
        out = _sdpa(q, k, v, scale=scale, causal=False, q_pos=positions,
                    k_pos=k_pos, cap=cfg.attn_softcap)
        return _finish(p, out, cfg, tp)
    q = _project_q(p, x, cfg, positions, tp=tp)
    k, v = _project_kv(p, x, cfg, positions, heads=heads)
    k, v = _expand_kv(k, v, cfg, heads)
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
    return _finish(p, out, cfg, tp)


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
    slot ``pos`` of the cache tensors in place (by the rank holding it
    under ``kv_seq``)."""
    b = x.shape[0]
    dh = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(dh)
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    hp, h, kv = padded_heads(cfg), cfg.n_heads, cfg.n_kv_heads
    tp = tp_splits("heads", hp)
    if cross_kv is not None:
        heads = _kv_heads(cfg) if tp else None
        q = _project_q(p, x, cfg, positions, use_rope=False, tp=tp)
        # the cross caches keep the state's dtype (bf16 by default); the
        # products take q's, as the self-attention branch reads its cache
        ks = tuple(c.to(q.dtype) for c in cross_kv)
        if tp:
            ks = tuple(c.narrow(2, heads[0], heads[1] - heads[0])
                       for c in ks)
        k, v = _expand_kv(*ks, cfg, heads)
        k_pos = _positions(b, k.shape[1], k.device)
        out = _sdpa(q, k, v, scale=scale, causal=False, q_pos=positions,
                    k_pos=k_pos, cap=cfg.attn_softcap)
        return _finish(p, out, cfg, tp), cache
    q = _project_q(p, x, cfg, positions, tp=tp)
    if tp:
        q = sharding.gather_along(q, 2)          # every head: it is tiny
    # the new K/V of every kv head (the cache holds every head of its
    # positions): each rank's block of them joined, where they divide
    heads = None
    if tp and kv % sharding.tensor_parallel().size == 0:
        blk = sharding.tensor_parallel().block(kv)
        heads = (blk.start, blk.stop, True)
    k_new, v_new = _project_kv(p, x, cfg, positions, heads=heads)
    if heads is not None:
        k_new = sharding.gather_along(k_new, 2)
        v_new = sharding.gather_along(v_new, 2)
    off = _write_slot(cache, pos, k=k_new, v=v_new)
    t = cache["k"].shape[1]
    k_pos = off + _positions(b, t, x.device)
    k_valid = k_pos <= pos
    # grouped decode: contract each kv head's group of real q heads
    # against the UNEXPANDED cache (the [B, T, Hp, Dh] head-expanded KV
    # never materializes).  q head i reads kv head i // (H / Hkv), as the
    # forward's _kv_map; the padded dummy heads read zero (masked in
    # _finish).  The reference groups the *padded* heads (Hp / Hkv a
    # group), which disagrees with its forward whenever GQA heads are
    # padded (qwen2-0.5b: 14 -> 16 heads, 2 kv heads).
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
    probs = _softmax_positions(sc).to(vc.dtype)
    out = _sum_positions(torch.einsum("bkgst,btkd->bskgd", probs, vc))
    out = out.reshape(b, 1, h, dh)
    if hp > h:
        out = F.pad(out, (0, 0, 0, hp - h))
    if tp:
        out = out[:, :, sharding.tensor_parallel().block(hp)]
    return _finish(p, out, cfg, tp), cache


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


def _mla_queries(p, x, cfg: ModelConfig, positions, tp=False):
    m, cd = cfg.mla, dtype_of(cfg.compute_dtype)
    q = torch.einsum("bsd,dhe->bshe", x.to(cd),
                     _head_w(p.w_q, 1, tp).to(cd))
    q = constrain(q, "batch", None, "heads", None)
    q_nope, q_pe = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_pe = rope(q_pe, positions, cfg.rope_theta)
    return q_nope, q_pe


def mla_attention(p: MLA, x, cfg: ModelConfig, *, positions) -> torch.Tensor:
    """Training / prefill MLA (explicit k/v materialization).  Under
    tensor parallelism on heads the latents are computed replicated
    (``w_dkv`` / ``w_kpe`` / ``kv_norm`` whole) and a rank's heads read
    them."""
    m, cd = cfg.mla, dtype_of(cfg.compute_dtype)
    tp = tp_splits("heads", cfg.n_heads)
    ckv, kpe = _mla_latents(p, x, cfg, positions)
    if tp:
        ckv, kpe, x = (sharding.copy_to_model(t) for t in (ckv, kpe, x))
    q_nope, q_pe = _mla_queries(p, x, cfg, positions, tp)
    k_nope = torch.einsum("btr,rhe->bthe", ckv, _head_w(p.w_uk, 1, tp).to(cd))
    v = torch.einsum("btr,rhe->bthe", ckv, _head_w(p.w_uv, 1, tp).to(cd))
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    sc = (torch.einsum("bshe,bthe->bhst", q_nope, k_nope)
          + torch.einsum("bshe,bte->bhst", q_pe, kpe)).float()
    mask = positions[:, :, None] >= positions[:, None, :]
    sc = torch.where(mask[:, None, :, :], sc * scale, NEG_INF)
    probs = torch.softmax(sc, -1).to(cd)
    out = torch.einsum("bhst,bthe->bshe", probs, v)
    y = torch.einsum("bshe,hed->bsd", out, _head_w(p.w_o, 0, tp).to(cd))
    return sharding.reduce_from_model(y) if tp else y


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank),
                               dtype=dtype, device=device),
            "kpe": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dtype,
                               device=device)}


def mla_decode(p: MLA, x, cache: dict, pos: int, cfg: ModelConfig):
    """Absorbed one-token MLA decode: attend in the r-dim latent space —
    the cache stays compressed (DeepSeek-V2 §2.1).  Under tensor
    parallelism the rank's heads' absorbed queries are joined, every head
    attends over the rank's positions, and the rank's heads take the
    context into ``w_uv`` / ``w_o``."""
    m, cd = cfg.mla, dtype_of(cfg.compute_dtype)
    b = x.shape[0]
    tp = tp_splits("heads", cfg.n_heads)
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    ckv_new, kpe_new = _mla_latents(p, x, cfg, positions)
    off = _write_slot(cache, pos, ckv=ckv_new, kpe=kpe_new)
    q_nope, q_pe = _mla_queries(p, x, cfg, positions, tp)
    q_abs = torch.einsum("bshe,rhe->bshr", q_nope,
                         _head_w(p.w_uk, 1, tp).to(cd))
    if tp:
        q_abs = sharding.gather_along(q_abs, 2)
        q_pe = sharding.gather_along(q_pe, 2)
    t = cache["ckv"].shape[1]
    ckv, kpe = cache["ckv"].to(cd), cache["kpe"].to(cd)
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    sc = (torch.einsum("bshr,btr->bhst", q_abs, ckv)
          + torch.einsum("bshe,bte->bhst", q_pe, kpe)).float()
    valid = off + torch.arange(t, device=x.device)[None, :] <= pos
    sc = torch.where(valid[:, None, None, :], sc * scale, NEG_INF)
    probs = _softmax_positions(sc).to(cd)
    ctx = _sum_positions(torch.einsum("bhst,btr->bshr", probs, ckv))
    if tp:
        ctx = ctx[:, :, sharding.tensor_parallel().block(cfg.n_heads)]
    out = torch.einsum("bshr,rhe->bshe", ctx, _head_w(p.w_uv, 1, tp).to(cd))
    y = torch.einsum("bshe,hed->bsd", out, _head_w(p.w_o, 0, tp).to(cd))
    return (sharding.reduce_from_model(y) if tp else y), cache
