"""Port parity for flash attention: the port's forward and backward (their
plain versions, on the CPU) against the reference's
``repro.kernels.flash_attention`` (Pallas in interpret mode, as
``tests/test_kernels.py`` runs it), and against torch autograd through an
unfused oracle.

Inputs are drawn with numpy from a seed.  Tolerances are the reference's
own (``tests/test_kernels.py``): float32 forward 2e-5 (atol and rtol; the
two packages sum in other orders), float32 gradients 5e-4, bfloat16 2e-2
(P is rounded to bf16 before P . V, and o is written in bf16).
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attention as ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

FWD_TOL = 2e-5
GRAD_TOL = 5e-4
BF16_TOL = 2e-2

# (s, h, d, causal, window, cap, bq, bk): tests/test_kernels.py:148-154,
# plus a window without causal (legal: it masks q - k < window only).
FWD_CASES = [
    (256, 3, 64, True, 0, 0.0, 128, 128),
    (300, 2, 32, True, 0, 0.0, 128, 128),      # ragged seq
    (256, 2, 64, True, 100, 0.0, 64, 64),      # local window
    (256, 2, 128, True, 0, 50.0, 128, 128),    # gemma2 softcap
    (256, 2, 64, False, 0, 0.0, 128, 128),     # bidirectional
    (200, 2, 32, False, 50, 30.0, 64, 64),     # window, no causal, softcap
]
# (causal, window, cap): tests/test_kernels.py:183-185.
GRAD_CONFIGS = [(True, 0, 0.0), (True, 100, 0.0), (True, 0, 50.0),
                (False, 0, 0.0)]


def _draw(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(a).to(dtype).requires_grad_(grad)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               atol=tol, rtol=tol)


def _oracle(q, k, v, causal=True, window=0, cap=0.0):
    """Unfused softmax attention in torch (autograd runs through it)."""
    s, d = q.shape[1], q.shape[3]
    sc = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(d)
    if cap:
        sc = cap * torch.tanh(sc / cap)
    pos = torch.arange(s)
    mask = torch.ones(s, s, dtype=torch.bool)
    if causal:
        mask = pos[:, None] >= pos[None, :]
    if window:
        mask = mask & (pos[:, None] - pos[None, :] < window)
    sc = torch.where(mask, sc, -1e30)
    return torch.einsum("bhst,bthd->bshd", torch.softmax(sc, -1), v)


@pytest.mark.parametrize("s,h,d,causal,window,cap,bq,bk", FWD_CASES)
def test_forward_matches_reference(s, h, d, causal, window, cap, bq, bk):
    q, k, v = _draw((2, s, h, d), 3, s + h + d)
    want_o, want_lse = ref._flash_fwd_raw(_j(q), _j(k), _j(v), causal,
                                          window, cap, bq, bk, True)
    got_o, got_lse = fa.flash_fwd(_t(q), _t(k), _t(v), causal=causal,
                                  window=window, softcap=cap, bk=bk)
    assert got_o.dtype == torch.float32 and got_o.shape == (2, s, h, d)
    # The reference's lse is [B * H, Sp]; the port keeps the valid rows.
    assert got_lse.shape == (2 * h, s)
    _close(got_o, want_o, FWD_TOL)
    _close(got_lse, np.asarray(want_lse)[:, :s], FWD_TOL)
    o = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                           window=window, softcap=cap, bq=bq, bk=bk)
    assert torch.equal(o, got_o)
    assert float(o.abs().max()) > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_dtypes(dtype):
    """tests/test_kernels.py:169-180: the working dtype against the float32
    oracle, and against the reference in the same dtype."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    q, k, v = _draw((1, 128, 2, 64), 3, 0)
    tq, tk, tv = (_t(a, tdt) for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv)
    assert got.dtype == tdt
    want32 = _oracle(*(t.float() for t in (tq, tk, tv)))
    _close(got.float(), want32, BF16_TOL)
    want_ref = ref.flash_attention(_j(q, jdt), _j(k, jdt), _j(v, jdt),
                                   interpret=True)
    tol = FWD_TOL if dtype == "float32" else BF16_TOL
    _close(got.float(), np.asarray(want_ref, np.float32), tol)


def test_bf16_lse_matches_reference():
    """bf16 scores are exact products summed in float32, so lse stays
    within the float32 tolerance of the reference's."""
    q, k, v = _draw((2, 200, 2, 64), 3, 4)
    jq, jk, jv = (_j(a, jnp.bfloat16) for a in (q, k, v))
    _, want = ref._flash_fwd_raw(jq, jk, jv, True, 0, 0.0, 64, 64, True)
    _, got = fa.flash_fwd(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                          bk=64)
    assert got.dtype == torch.float32
    _close(got, np.asarray(want)[:, :200], FWD_TOL)


def _grads_port(q, k, v, tgt, causal, window, cap, bq=128, bk=128,
                dtype=torch.float32):
    tq, tk, tv = (_t(a, dtype, grad=True) for a in (q, k, v))
    o = fa.flash_attention_trainable(tq, tk, tv, causal, window, cap, bq, bk)
    ((o.float() - _t(tgt)) ** 2).sum().backward()
    return o, (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize("causal,window,cap", GRAD_CONFIGS)
def test_gradients_match_reference(causal, window, cap):
    """tests/test_kernels.py:183-207: gradients of sum((o - tgt)^2)."""
    q, k, v, tgt = _draw((2, 256, 2, 64), 4, 7)

    def loss(q, k, v):
        return jnp.sum((ref.flash_attention_trainable(
            q, k, v, causal, window, cap) - _j(tgt)) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    _, got = _grads_port(q, k, v, tgt, causal, window, cap)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("causal,window,cap", GRAD_CONFIGS + [
    (False, 40, 20.0)])
def test_plain_backward_matches_autograd_oracle(causal, window, cap):
    """The explicit backward formula against torch autograd through the
    unfused oracle, on a ragged length (tolerance: float32 gradients)."""
    q, k, v, tgt = _draw((2, 150, 2, 32), 4, 11)
    _, got = _grads_port(q, k, v, tgt, causal, window, cap, 64, 64)
    oq, ok, ov = (_t(a, grad=True) for a in (q, k, v))
    ((_oracle(oq, ok, ov, causal, window, cap) - _t(tgt)) ** 2).sum() \
        .backward()
    for g, w in zip(got, (oq.grad, ok.grad, ov.grad)):
        _close(g, w, GRAD_TOL)
        assert float(w.abs().max()) > 0.1


def test_expanded_grad_output():
    """``o.sum()`` hands the backward an expanded dO."""
    q, k, v = _draw((1, 64, 2, 32), 3, 12)
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    fa.flash_attention_trainable(tq, tk, tv).sum().backward()
    oq, ok, ov = (_t(a, grad=True) for a in (q, k, v))
    _oracle(oq, ok, ov).sum().backward()
    for g, w in zip((tq.grad, tk.grad, tv.grad), (oq.grad, ok.grad, ov.grad)):
        _close(g, w, GRAD_TOL)


def test_only_requested_gradients():
    """``ctx.needs_input_grad``: q and k without grad get none."""
    q, k, v, tgt = _draw((1, 64, 2, 32), 4, 13)
    tq, tk, tv = _t(q), _t(k), _t(v, grad=True)
    ((fa.flash_attention_trainable(tq, tk, tv) - _t(tgt)) ** 2).sum() \
        .backward()
    assert tq.grad is None and tk.grad is None
    _, (_, _, want) = _grads_port(q, k, v, tgt, True, 0, 0.0)
    assert torch.equal(tv.grad, want)


def test_forward_and_trainable_agree():
    """tests/test_kernels.py:209-219, exactly."""
    q, k, v = _draw((1, 128, 2, 32), 3, 9)
    a = fa.flash_attention(_t(q), _t(k), _t(v))
    b = fa.flash_attention_trainable(_t(q, grad=True), _t(k), _t(v))
    assert torch.equal(a, b.detach())


@pytest.mark.parametrize("causal,window,cap", [(True, 0, 0.0),
                                               (True, 90, 50.0)])
def test_block_size_independence(causal, window, cap):
    """bq / bk = 64 and 128 give the same o, lse and gradients, within
    float order (forward and gradient tolerances)."""
    q, k, v, tgt = _draw((1, 200, 2, 64), 4, 14)
    outs = []
    for blk in (64, 128):
        o, grads = _grads_port(q, k, v, tgt, causal, window, cap, blk, blk)
        _, lse = fa.flash_fwd(_t(q), _t(k), _t(v), causal=causal,
                              window=window, softcap=cap, bk=blk)
        outs.append((o.detach(), lse, grads))
    (o1, l1, g1), (o2, l2, g2) = outs
    _close(o1, o2, FWD_TOL)
    _close(l1, l2, FWD_TOL)
    for a, b in zip(g1, g2):
        _close(a, b, GRAD_TOL)


def test_head_dim_256_matches_reference():
    """D = 256 (gemma2-2b), causal, window and softcap at once."""
    q, k, v, tgt = _draw((1, 160, 2, 256), 4, 15)
    want_o = ref.flash_attention(_j(q), _j(k), _j(v), window=64,
                                 softcap=50.0, interpret=True)

    def loss(q, k, v):
        return jnp.sum((ref.flash_attention_trainable(
            q, k, v, True, 64, 50.0) - _j(tgt)) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    o, got = _grads_port(q, k, v, tgt, True, 64, 50.0)
    _close(o.detach(), want_o, FWD_TOL)
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL)


def test_bf16_gradients_match_float32():
    """bf16 gradients (P and dO kept in float32 inside) within the bf16
    tolerance, relative to the largest float32 gradient."""
    q, k, v, tgt = _draw((1, 128, 2, 64), 4, 16)
    _, g16 = _grads_port(q, k, v, tgt, True, 0, 0.0, dtype=torch.bfloat16)
    _, g32 = _grads_port(q, k, v, tgt, True, 0, 0.0)
    for a, b in zip(g16, g32):
        assert a.dtype == torch.bfloat16
        err = float((a.float() - b).abs().max()) / float(b.abs().max())
        assert err <= BF16_TOL, err


class _PlainAttention(torch.autograd.Function):
    """The plain forward and the plain backward, in float64, for
    gradcheck."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap):
        o, lse = fa.flash_fwd_plain(q, k, v, causal, window, cap, bk=8)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, window, cap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dd = fa.row_dots(do, o)
        dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, dd, *ctx.opts)
        dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, dd, *ctx.opts)
        return dq, dk, dv, None, None, None


@pytest.mark.parametrize("causal,window,cap", [(True, 3, 2.0),
                                               (False, 0, 0.0)])
def test_plain_backward_gradcheck(causal, window, cap):
    rng = np.random.default_rng(17)
    ts = [torch.from_numpy(rng.standard_normal((1, 7, 2, 4)))
          .requires_grad_(True) for _ in range(3)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: _PlainAttention.apply(q, k, v, causal, window, cap),
        ts, eps=1e-6, atol=1e-6, rtol=1e-5)


def _qkv(shape=(1, 16, 2, 32), dtype=torch.float32):
    return [torch.zeros(shape, dtype=dtype) for _ in range(3)]


@pytest.mark.parametrize("args,kw,err", [
    (_qkv((16, 2, 32)), {}, ValueError),                  # not 4-d
    (_qkv()[:2] + [torch.zeros(1, 17, 2, 32)], {}, ValueError),
    (_qkv((1, 16, 2, 48)), {}, ValueError),               # head dim
    (_qkv(dtype=torch.float16), {}, TypeError),
    (_qkv(dtype=torch.float64), {}, TypeError),
    (_qkv()[:2] + [torch.zeros(1, 16, 2, 32, dtype=torch.bfloat16)], {},
     TypeError),                                          # mixed dtypes
    (_qkv(), {"window": -1}, ValueError),
    (_qkv(), {"softcap": -1.0}, ValueError),
    (_qkv(), {"bk": 0}, ValueError),
    (_qkv(), {"causal": 1}, TypeError),
])
def test_typed_errors(args, kw, err):
    with pytest.raises(err):
        fa.flash_fwd(*args, **kw)
    with pytest.raises(err):
        fa.flash_attention(*args, **kw)


@pytest.mark.parametrize("entry", ["flash_attention",
                                   "flash_attention_trainable"])
def test_entry_points_check_bq(entry):
    """bq (the reference's query block) is checked by the entry points,
    though no valid row depends on it."""
    with pytest.raises(ValueError):
        getattr(fa, entry)(*_qkv(), bq=0)
    q, k, v = _draw((1, 40, 1, 32), 3, 19)
    a, b = (getattr(fa, entry)(_t(q), _t(k), _t(v), bq=blk, bk=16)
            for blk in (8, 128))
    assert torch.equal(a, b)


def test_backward_wrappers_check_their_statistics():
    q, k, v = _qkv()
    do = torch.zeros_like(q)
    good = torch.zeros(2, 16)
    for lse, dd in ((torch.zeros(2, 128), good), (good, good.double()),
                    (good, torch.zeros(2, 16, 1))):
        for fn in (fa.flash_bwd_dkv, fa.flash_bwd_dq):
            with pytest.raises(ValueError):
                fn(q, k, v, do, lse, dd)
    with pytest.raises(ValueError):
        fa.flash_bwd_dq(q, k, v, do[:, :8], good, good)
    with pytest.raises(ValueError):
        fa.flash_fwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))


def test_cpu_tensors_never_count_launches():
    q, k, v, tgt = _draw((1, 32, 2, 32), 4, 18)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches,
              fa.flash_bwd_dq.launches)
    fa.flash_fwd(_t(q), _t(k), _t(v))
    _grads_port(q, k, v, tgt, True, 0, 0.0)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches,
            fa.flash_bwd_dq.launches) == before
