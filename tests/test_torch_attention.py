"""Attention of the port's models (``repro_torch.models.attention``): the
seven invariants of ``tests/test_attention_properties.py`` (head
padding, GQA grouping, causality, local windows, RoPE, softcap) on the
port's own seeded weights, the blocked long-sequence path against SDPA
(with local windows, as ``tests/test_models_smoke.py``), and the
attention and decode functions against the reference's on the same
numpy-drawn weights and inputs.

Tolerances: the invariants' own bounds (1e-5; 2e-4 for the RoPE shift);
blocked against SDPA and the port against the reference within
``TOL`` = 1e-5 (float32 at these sizes; the reference holds blocked to
SDPA within 2e-2).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as ref_attn  # noqa: E402
from repro.models.config import LayerSpec as RefLayerSpec  # noqa: E402
from repro.models.config import ModelConfig as RefModelConfig  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.config import LayerSpec, ModelConfig  # noqa: E402
from repro_torch.models.layers import softcap  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(h=4, kv=2, d=32, pad=0, ref=False, **kw):
    cls, spec = (RefModelConfig, RefLayerSpec) if ref else \
        (ModelConfig, LayerSpec)
    return cls(
        name="t", family="dense", n_layers=1, d_model=d, n_heads=h,
        n_kv_heads=kv, d_ff=4 * d, vocab_size=64, head_dim=d // h,
        head_pad_to=pad, block_pattern=(spec("attn"),),
        param_dtype="float32", compute_dtype="float32", **kw)


def _init(cfg, seed=0):
    return attn.Attention(torch.Generator().manual_seed(seed), cfg,
                          device="cpu")


def _x(shape, seed=1):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(
            np.float32))


def _pos(b, s, shift=0):
    return torch.arange(s)[None].expand(b, s) + shift


@torch.no_grad()
def test_head_padding_is_exact():
    """Padded dummy heads must not change the output at all."""
    cfg = _cfg(h=3, kv=3, d=48)
    cfg_pad = _cfg(h=3, kv=3, d=48, pad=8)
    p = _init(cfg)
    p_pad = _init(cfg_pad)
    # copy the real heads into the padded params; dummies stay random —
    # the mask must null them
    p_pad.w_q[:, :3, :] = p.w_q
    p_pad.w_o[:3, :, :] = p.w_o
    p_pad.w_k.copy_(p.w_k)
    p_pad.w_v.copy_(p.w_v)
    x = _x((2, 16, 48))
    a = attn.attention(p, x, cfg, positions=_pos(2, 16))
    b = attn.attention(p_pad, x, cfg_pad, positions=_pos(2, 16))
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@torch.no_grad()
def test_gqa_equals_mha_with_repeated_kv():
    """GQA(kv=2) == MHA whose kv heads are explicit repeats."""
    cfg_gqa, cfg_mha = _cfg(h=4, kv=2), _cfg(h=4, kv=4)
    p = _init(cfg_gqa)
    p_mha = _init(cfg_mha)
    idx = attn._kv_map(cfg_gqa)                 # [0, 0, 1, 1]
    assert idx.tolist() == [0, 0, 1, 1]
    p_mha.w_q.copy_(p.w_q)
    p_mha.w_o.copy_(p.w_o)
    p_mha.w_k.copy_(p.w_k[:, idx, :])
    p_mha.w_v.copy_(p.w_v[:, idx, :])
    x = _x((1, 12, 32))
    a = attn.attention(p, x, cfg_gqa, positions=_pos(1, 12))
    b = attn.attention(p_mha, x, cfg_mha, positions=_pos(1, 12))
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@torch.no_grad()
def test_causality():
    """Changing future tokens cannot change past outputs."""
    cfg = _cfg()
    p = _init(cfg)
    x = _x((1, 16, 32))
    a = attn.attention(p, x, cfg, positions=_pos(1, 16))
    x2 = x.clone()
    x2[:, 10:, :] = _x((1, 6, 32), seed=2)
    b = attn.attention(p, x2, cfg, positions=_pos(1, 16))
    torch.testing.assert_close(a[:, :10], b[:, :10], atol=1e-5, rtol=0)


@torch.no_grad()
def test_local_window_blocks_distant_keys():
    cfg = _cfg()
    p = _init(cfg)
    x = _x((1, 32, 32))
    a = attn.attention(p, x, cfg, positions=_pos(1, 32), window=4)
    # tokens beyond the window cannot influence position 31
    x2 = x.clone()
    x2[:, :8, :] = 0.0
    b = attn.attention(p, x2, cfg, positions=_pos(1, 32), window=4)
    torch.testing.assert_close(a[:, 31], b[:, 31], atol=1e-5, rtol=0)


@torch.no_grad()
def test_rope_relative_position_invariance():
    """RoPE attention scores depend only on relative offsets: shifting
    all positions by a constant leaves outputs unchanged."""
    cfg = _cfg()
    p = _init(cfg)
    x = _x((1, 16, 32))
    a = attn.attention(p, x, cfg, positions=_pos(1, 16))
    b = attn.attention(p, x, cfg, positions=_pos(1, 16, shift=37))
    torch.testing.assert_close(a, b, atol=2e-4, rtol=0)


def test_rope_partial_fraction_leaves_tail_unrotated():
    x = _x((1, 8, 2, 16), seed=0)
    out = attn.rope(x, _pos(1, 8), theta=1e4, fraction=0.25)
    assert torch.equal(out[..., 4:], x[..., 4:])
    assert not torch.allclose(out[..., :4], x[..., :4])


def test_softcap_bounds_scores():
    y = softcap(torch.tensor([-1e4, -10.0, 0.0, 10.0, 1e4]), 50.0)
    assert (y.abs() <= 50.0 + 1e-5).all()
    assert float(y[2]) == 0.0
    assert float(y[3]) > 9.0   # near-linear in the small regime


@pytest.mark.parametrize("arch,window", [("qwen2-0.5b", 0),
                                         ("gemma2-2b", 48)])
def test_blocked_attention_matches_sdpa(arch, window):
    """The long-sequence blocked path (chunks of 32, S = 128) equals plain
    attention through the whole model; gemma2 with a 48-token local
    window on its local layers and its attention softcap."""
    cfg = smoke(get_config(arch))
    cfg = dataclasses.replace(cfg, blocked_attn_threshold=64,
                              attn_chunk_q=32, attn_chunk_k=32,
                              local_window=window or cfg.local_window)
    cfg_plain = dataclasses.replace(cfg, blocked_attn_threshold=10_000)
    model = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 128)))
    a = tf.forward(model, {"tokens": tokens}, cfg)
    b = tf.forward(model, {"tokens": tokens}, cfg_plain)
    torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)


def _ref_params(p):
    return {k: jnp.asarray(v.detach().numpy()) for k, v in
            p.named_parameters()}


@pytest.mark.parametrize("case", [
    dict(h=4, kv=2, pad=8, qkv_bias=True, attn_softcap=50.0),
    dict(h=3, kv=3, pad=8, rope_fraction=0.25),
    dict(h=4, kv=4, blocked_attn_threshold=32, attn_chunk_q=16,
         attn_chunk_k=16)], ids=["gqa-pad-bias-cap", "pad-partial-rope",
                                 "blocked"])
@pytest.mark.parametrize("window", [0, 8])
def test_attention_and_decode_match_reference(case, window):
    """``attention`` against the reference's on the same weights (padded
    heads, QKV bias, softcap, partial RoPE, the blocked path), and each
    ``attention_decode`` step against the reference's forward on the
    prefix (its last position) and, where no GQA head is padded, against
    the reference's ``attention_decode`` too."""
    h, kv, pad = case["h"], case["kv"], case.get("pad", 0)
    kw = {k: v for k, v in case.items() if k not in ("h", "kv", "pad")}
    cfg = _cfg(h=h, kv=kv, d=48 if h == 3 else 32, pad=pad, **kw)
    rcfg = _cfg(h=h, kv=kv, d=48 if h == 3 else 32, pad=pad, ref=True, **kw)
    p = _init(cfg, seed=4)
    with torch.no_grad():
        for name in ("b_q", "b_k", "b_v"):
            if getattr(p, name) is not None:
                getattr(p, name).normal_(generator=torch.Generator()
                                         .manual_seed(9))
    rp = _ref_params(p)
    b, s = 2, 32
    x = _x((b, s, cfg.d_model), seed=5)
    pos = _pos(b, s)
    rx, rpos = jnp.asarray(x.numpy()), jnp.asarray(pos.numpy())
    got = attn.attention(p, x, cfg, positions=pos, window=window)
    want = ref_attn.attention(rp, rx, rcfg, positions=rpos, window=window)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    cache = attn.init_kv_cache(cfg, b, s, torch.float32, "cpu")
    rcache = ref_attn.init_kv_cache(rcfg, b, s, jnp.float32)
    for t in range(4):
        with torch.no_grad():
            out, cache = attn.attention_decode(p, x[:, t:t + 1], cache, t,
                                               cfg, window=window)
        prefix = ref_attn.attention(
            rp, rx[:, :t + 1],
            dataclasses.replace(rcfg, blocked_attn_threshold=1 << 30),
            positions=rpos[:, :t + 1], window=window)[:, -1:]
        np.testing.assert_allclose(out.numpy(), np.asarray(prefix),
                                   rtol=TOL, atol=TOL)
        rout, rcache = ref_attn.attention_decode(
            rp, rx[:, t:t + 1], rcache, jnp.int32(t), rcfg, window=window)
        if pad == 0:
            np.testing.assert_allclose(out.numpy(), np.asarray(rout),
                                       rtol=TOL, atol=TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(rcache["k"]),
                               rtol=TOL, atol=TOL)


@torch.no_grad()
def test_padded_gqa_decode_follows_the_forward():
    """With GQA heads padded (4 q heads -> 8, 2 kv heads: groups of 2 in
    the forward's ``_kv_map``) the port's decode equals its forward.  The
    reference's grouped decode splits the *padded* heads into groups of
    4, so q heads 2 and 3 read the wrong kv head and its decode leaves its
    forward (the fault this records; qwen2-0.5b's 14 -> 16 heads over 2
    kv heads at full width)."""
    cfg = _cfg(h=4, kv=2, pad=8)
    rcfg = _cfg(h=4, kv=2, pad=8, ref=True)
    p = _init(cfg, seed=6)
    rp = _ref_params(p)
    b, s = 1, 6
    x = _x((b, s, cfg.d_model), seed=7)
    fwd = attn.attention(p, x, cfg, positions=_pos(b, s))
    cache = attn.init_kv_cache(cfg, b, s, torch.float32, "cpu")
    rcache = ref_attn.init_kv_cache(rcfg, b, s, jnp.float32)
    ref_gap = 0.0
    for t in range(s):
        out, cache = attn.attention_decode(p, x[:, t:t + 1], cache, t, cfg)
        torch.testing.assert_close(out, fwd[:, t:t + 1], rtol=TOL, atol=TOL)
        rout, rcache = ref_attn.attention_decode(
            rp, jnp.asarray(x[:, t:t + 1].numpy()), rcache, jnp.int32(t),
            rcfg)
        ref_gap = max(ref_gap, float(np.abs(np.asarray(rout)
                                            - fwd[:, t:t + 1].numpy()).max()))
    assert ref_gap > 1e-2, ref_gap
