"""Flash (online-softmax) attention: the forward and the two backward
kernels, their plain PyTorch versions, their launch counters, and the two
entry points (port of ``repro.kernels.flash_attention``).

Entry points, on ``q / k / v [B, S, H, D]`` (one sequence length, heads
already expanded: for GQA gather the kv heads first), float32 or
bfloat16, ``D`` in {32, 64, 128, 256}:

* ``flash_attention(q, k, v, *, causal, window, softcap, bq, bk)`` — the
  forward alone, ``o [B, S, H, D]`` in q's dtype;
* ``flash_attention_trainable(q, k, v, causal, window, softcap, bq, bk)``
  — the same ``o`` through a ``torch.autograd.Function`` that saves
  ``(q, k, v, o, lse)`` and whose backward is the two backward kernels.

Masks (the reference's ``_block_mask``): keys past ``S`` never count;
``causal`` keeps ``q >= k`` (top-left aligned, as SDPA's ``is_causal``);
``window > 0`` keeps ``q - k < window`` (with or without ``causal``);
``softcap > 0`` caps the scaled score ``x`` at ``softcap * tanh(x /
softcap)``.  The scale is ``1 / sqrt(D)``, rounded to float32 once.

Kernel wrappers, one per CUDA source in ``csrc/``:

* ``flash_fwd(q, k, v, ...) -> (o, lse)`` (``flash_fwd.cu``,
  ``_flash_kernel``);
* ``flash_bwd_dkv(q, k, v, do, lse, dd, ...) -> (dk, dv)``
  (``flash_bwd_dkv.cu``, ``_flash_dkv_kernel``);
* ``flash_bwd_dq(q, k, v, do, lse, dd, ...) -> dq`` (``flash_bwd_dq.cu``,
  ``_flash_dq_kernel``);

with ``lse`` (the forward's log-sum-exp) and ``dd = rowsum(do * o)`` as
``[B * H, S]`` float32: the reference pads ``lse`` to ``[B * H, Sp]``,
the port keeps only the valid rows, so the backward reads the forward's
``lse`` as it is.  Of the reference's block sizes only ``bk`` is
meaningful here: it sets the key blocks of the plain forward's online
softmax (its float order).  The CUDA kernels pick their own tiles, and
``bq`` never changed a valid row; the entry points take both for the
reference's signature.

On CPU tensors a wrapper computes with its plain PyTorch version (same
arguments).  On CUDA tensors it launches its hand-written kernel or
raises: there is no fallback.  ``<wrapper>.launches`` counts kernel
launches, nothing else.  The plain versions compute in float32 (float64
for float64 inputs, which only the plain versions take), scores as
``q.float() @ k.float()`` so that bf16 scores are not rounded.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# flash_fwd_launch(q, k, v, o, lse, B, H, S, D, bf16, scale, cap, causal,
#                  window, stream)
_FWD_ARGTYPES = [_P] * 5 + [_I] * 5 + [_F] * 2 + [_I] * 2 + [_P]
# flash_bwd_dkv_launch(q, k, v, do, lse, dd, dk, dv, B, H, S, D, bf16,
#                      scale, cap, causal, window, stream)
_DKV_ARGTYPES = [_P] * 8 + [_I] * 5 + [_F] * 2 + [_I] * 2 + [_P]
# flash_bwd_dq_launch(q, k, v, do, lse, dd, dq, B, H, S, D, bf16, scale,
#                     cap, causal, window, stream)
_DQ_ARGTYPES = [_P] * 7 + [_I] * 5 + [_F] * 2 + [_I] * 2 + [_P]


# ---------------------------------------------------------------- checks

def _check_qkv(name: str, q, k, v, *extra) -> None:
    """q, k, v (and ``extra``: dO) are ``[B, S, H, D]`` tensors of one
    shape, dtype and device, float32 or bfloat16, D in HEAD_DIMS,
    contiguous."""
    ts = (q, k, v, *extra)
    if not all(isinstance(t, torch.Tensor) for t in ts):
        raise TypeError(f"{name}: operands must be tensors")
    if q.ndim != 4:
        raise ValueError(f"{name}: q must be [B, S, H, D], got "
                         f"{tuple(q.shape)}")
    for t in ts[1:]:
        if t.shape != q.shape:
            raise ValueError(f"{name}: operands must share q's shape "
                             f"{tuple(q.shape)}, got {tuple(t.shape)}")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{name}: operands must all be float32 or all "
                        f"bfloat16, got {[t.dtype for t in ts]}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim must be one of {HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{name}: operands are on different devices: "
                         f"{[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: operands must be contiguous")


def _check_opts(name: str, causal, window, softcap, *blocks) -> None:
    """The mask options, and ``blocks`` (bq, bk) ints >= 1."""
    if not isinstance(causal, bool):
        raise TypeError(f"{name}: causal must be a bool, got {causal!r}")
    if isinstance(window, bool) or not isinstance(window, int) or window < 0:
        raise ValueError(f"{name}: window must be an int >= 0, got "
                         f"{window!r}")
    if not isinstance(softcap, (int, float)) or isinstance(softcap, bool) \
            or not math.isfinite(softcap) or softcap < 0:
        raise ValueError(f"{name}: softcap must be a finite number >= 0, "
                         f"got {softcap!r}")
    for blk in blocks:
        if isinstance(blk, bool) or not isinstance(blk, int) or blk < 1:
            raise ValueError(f"{name}: bq and bk must be ints >= 1, got "
                             f"{blocks!r}")


def _check_stats(name: str, q, lse, dd) -> None:
    """lse and dd are ``[B * H, S]`` float32 on q's device."""
    b, s, h, _ = q.shape
    for what, t in (("lse", lse), ("dd", dd)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
                or tuple(t.shape) != (b * h, s):
            raise ValueError(f"{name}: {what} must be [{b * h}, {s}] "
                             f"float32, got {getattr(t, 'shape', t)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous on "
                             f"{q.device}")


def _scale(d: int) -> float:
    """``1 / sqrt(d)`` rounded to float32 once, as the kernels take it."""
    return ctypes.c_float(1.0 / math.sqrt(d)).value


# -------------------------------------------------------- plain versions

def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _fold(t: torch.Tensor) -> torch.Tensor:
    """``[B, S, H, D] -> [B * H, S, D]``."""
    b, s, h, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _unfold(t: torch.Tensor, b: int, s: int, h: int) -> torch.Tensor:
    return t.reshape(b, h, s, -1).permute(0, 2, 1, 3).contiguous()


def _mask(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """``[len(q_pos), len(k_pos)]`` bool: the pairs that count."""
    qp, kp = q_pos[:, None], k_pos[None, :]
    mask = torch.ones(len(q_pos), len(k_pos), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask = mask & (qp >= kp)
    if window:
        mask = mask & (qp - kp < window)
    return mask


def _capped(x: torch.Tensor, softcap: float) -> torch.Tensor:
    return softcap * torch.tanh(x / softcap) if softcap else x


def flash_fwd_plain(q, k, v, causal=True, window=0, softcap=0.0, bk=128):
    """Plain version of ``flash_fwd``: the reference's online softmax over
    key blocks of ``bk``, vectorised over every query row (the reference's
    padded keys are masked, so they add nothing).  Returns ``(o [B, S, H,
    D] in q's dtype, lse [B * H, S])``."""
    b, s, h, d = q.shape
    acc_t = _acc_dtype(q.dtype)
    scale = _scale(d)
    qf = _fold(q).to(acc_t)
    kf = _fold(k).to(acc_t)
    vf = _fold(v)
    pos = torch.arange(s, device=q.device)
    m = torch.full((b * h, s, 1), NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b * h, s, d), dtype=acc_t, device=q.device)
    for k0 in range(0, s, bk):
        x = (qf @ kf[:, k0:k0 + bk].transpose(1, 2)) * scale
        sc = torch.where(_mask(pos, pos[k0:k0 + bk], causal, window),
                         _capped(x, softcap), NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        # P is rounded to v's dtype before P . V, as in the reference.
        acc = acc * corr + p.to(v.dtype).to(acc_t) @ vf[:, k0:k0 + bk].to(
            acc_t)
        m = m_new
    lm = l.clamp_min(1e-30)
    o = _unfold(acc / lm, b, s, h).to(q.dtype)
    return o, (m + torch.log(lm))[..., 0]


def _bwd_scores(q, k, v, do, lse, dd, causal, window, softcap):
    """``(p, ds, qf, kf, dof)`` of the explicit flash backward, unfused over
    ``[B * H, S, S]`` (flash_attention.py:195-208)."""
    b, s, h, d = q.shape
    acc_t = _acc_dtype(q.dtype)
    scale = _scale(d)
    qf, kf, vf, dof = (_fold(t).to(acc_t) for t in (q, k, v, do))
    x = (qf @ kf.transpose(1, 2)).mul_(scale)
    pos = torch.arange(s, device=q.device)
    p = torch.where(_mask(pos, pos, causal, window), _capped(x, softcap),
                    NEG_INF)
    p = p.sub_(lse.to(acc_t)[:, :, None]).exp_()
    ds = (dof @ vf.transpose(1, 2)).sub_(dd.to(acc_t)[:, :, None]).mul_(p)
    if softcap:
        ds.mul_(1.0 - torch.tanh(x.div_(softcap)).square_())
    del x
    return p, ds.mul_(scale), qf, kf, dof


def flash_bwd_dkv_plain(q, k, v, do, lse, dd, causal=True, window=0,
                        softcap=0.0):
    """Plain version of ``flash_bwd_dkv``: ``dV = P^T dO``, ``dK = dS^T Q``
    over ``[B * H, S, S]``.  Returns ``(dk, dv)`` in k's and v's dtypes."""
    b, s, h, _ = q.shape
    p, ds, qf, _, dof = _bwd_scores(q, k, v, do, lse, dd, causal, window,
                                    softcap)
    dv = p.transpose(1, 2) @ dof
    del p
    dk = ds.transpose(1, 2) @ qf
    return (_unfold(dk, b, s, h).to(k.dtype), _unfold(dv, b, s, h).to(v.dtype))


def flash_bwd_dq_plain(q, k, v, do, lse, dd, causal=True, window=0,
                       softcap=0.0):
    """Plain version of ``flash_bwd_dq``: ``dQ = dS K`` over
    ``[B * H, S, S]``, in q's dtype."""
    b, s, h, _ = q.shape
    p, ds, _, kf, _ = _bwd_scores(q, k, v, do, lse, dd, causal, window,
                                  softcap)
    del p
    return _unfold(ds @ kf, b, s, h).to(q.dtype)


def row_dots(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``D = rowsum(dO * o)`` as ``[B * H, S]`` float32 (float64 for
    float64 operands), computed outside the kernels as the reference does
    (flash_attention.py:266)."""
    b, s, h, _ = o.shape
    acc_t = _acc_dtype(o.dtype)
    return (do.to(acc_t) * o.to(acc_t)).sum(-1).transpose(1, 2).reshape(
        b * h, s).contiguous()


# -------------------------------------------------------------- launches

def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels read rows four elements at a time: a view that does not
    start on 16 bytes is copied."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _device_kind(name: str, q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{q.device}")
    return q.device.type


def _launch(wrapper, argtypes, ins, outs, *scalars) -> None:
    """Launch ``wrapper``'s kernel on ``ins`` (aligned first) and ``outs``
    with ``scalars`` on the current stream, and count the launch."""
    name = wrapper.__name__
    ptrs = [_aligned(t).data_ptr() for t in ins] + [t.data_ptr() for t in outs]
    with torch.cuda.device(outs[0].device):
        launch = _build.load(name, argtypes)
        err = launch(*ptrs, *scalars,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    wrapper.launches += 1


def _mask_args(q, causal, window, softcap):
    """``(B, H, S, D, bf16, scale, cap, causal, window)`` as the kernels
    take them."""
    b, s, h, d = q.shape
    return (b, h, s, d, int(q.dtype == torch.bfloat16), _scale(d),
            float(softcap), int(causal), int(window))


# -------------------------------------------------------------- wrappers

def flash_fwd(q, k, v, *, causal=True, window=0, softcap=0.0, bk=128):
    """``(o [B, S, H, D] in q's dtype, lse [B * H, S] float32)``; ``bk``
    sets only the plain version's key blocks."""
    _check_qkv("flash_fwd", q, k, v)
    _check_opts("flash_fwd", causal, window, softcap, bk)
    if _device_kind("flash_fwd", q) == "cpu":
        return flash_fwd_plain(q, k, v, causal, window, softcap, bk)
    b, s, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    if o.numel():
        _launch(flash_fwd, _FWD_ARGTYPES, (q, k, v), (o, lse),
                *_mask_args(q, causal, window, softcap))
    return o, lse


def flash_bwd_dkv(q, k, v, do, lse, dd, *, causal=True, window=0,
                  softcap=0.0):
    """``(dk, dv)``, ``[B, S, H, D]`` in k's and v's dtype."""
    _check_qkv("flash_bwd_dkv", q, k, v, do)
    _check_stats("flash_bwd_dkv", q, lse, dd)
    _check_opts("flash_bwd_dkv", causal, window, softcap)
    if _device_kind("flash_bwd_dkv", q) == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, dd, causal, window,
                                   softcap)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel():
        _launch(flash_bwd_dkv, _DKV_ARGTYPES, (q, k, v, do, lse, dd),
                (dk, dv), *_mask_args(q, causal, window, softcap))
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, dd, *, causal=True, window=0,
                 softcap=0.0):
    """``dq``, ``[B, S, H, D]`` in q's dtype."""
    _check_qkv("flash_bwd_dq", q, k, v, do)
    _check_stats("flash_bwd_dq", q, lse, dd)
    _check_opts("flash_bwd_dq", causal, window, softcap)
    if _device_kind("flash_bwd_dq", q) == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, dd, causal, window,
                                  softcap)
    dq = torch.empty_like(q)
    if dq.numel():
        _launch(flash_bwd_dq, _DQ_ARGTYPES, (q, k, v, do, lse, dd), (dq,),
                *_mask_args(q, causal, window, softcap))
    return dq


flash_fwd.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


# ----------------------------------------------------------- entry points

def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0, bq=128,
                    bk=128):
    """``q / k / v [B, S, H, D]`` -> ``o [B, S, H, D]``, the forward only
    (for gradients use ``flash_attention_trainable``)."""
    _check_opts("flash_attention", causal, window, softcap, bq, bk)
    o, _ = flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                     causal=causal, window=window, softcap=softcap, bk=bk)
    return o


class _FlashAttention(torch.autograd.Function):
    """Forward: ``flash_fwd``; backward: ``flash_bwd_dkv`` and
    ``flash_bwd_dq`` from the saved ``(q, k, v, o, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, bk):
        o, lse = flash_fwd(q, k, v, causal=causal, window=window,
                           softcap=softcap, bk=bk)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()        # autograd may hand an expanded dO
        dd = row_dots(do, o)
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        dq = dk = dv = None
        if need_k or need_v:
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, dd, **ctx.opts)
        if need_q:
            dq = flash_bwd_dq(q, k, v, do, lse, dd, **ctx.opts)
        return (dq, dk if need_k else None, dv if need_v else None,
                None, None, None, None)


def flash_attention_trainable(q, k, v, causal=True, window=0, softcap=0.0,
                              bq=128, bk=128):
    """Differentiable flash attention: ``o`` as ``flash_attention`` gives
    it, with the flash backward as its gradient."""
    _check_opts("flash_attention_trainable", causal, window, softcap, bq, bk)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, window, softcap, bk)
