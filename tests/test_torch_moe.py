"""The port's MoE layer (``repro_torch.models.moe``): the five cases of
``tests/test_moe_properties.py`` on the port's own seeded weights, and
exact agreement with the reference on the same numpy-drawn weights and
inputs at a capacity that drops tokens: the experts chosen (ties to the
lower index, as ``jax.lax.top_k``), every token's slot and whether it got
one, the ``[B, E, C]`` dispatch table and its live mask, and
``moe_drop_frac``, all bit for bit; the output within ``TOL`` = 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.models import moe as ref_moe  # noqa: E402
from repro.models.config import LayerSpec as RefLayerSpec  # noqa: E402
from repro.models.config import ModelConfig as RefModelConfig  # noqa: E402
from repro.models.config import MoEConfig as RefMoEConfig  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.config import (LayerSpec, ModelConfig,  # noqa: E402
                                       MoEConfig)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(e=4, k=2, cf=8.0, d=32, shared=0, dense=False, ref=False):
    mc, lc, cc = (RefModelConfig, RefLayerSpec, RefMoEConfig) if ref else \
        (ModelConfig, LayerSpec, MoEConfig)
    return mc(
        name="t", family="moe", n_layers=1, d_model=d, n_heads=2,
        n_kv_heads=2, d_ff=4 * d, vocab_size=64,
        block_pattern=(lc("attn", "moe"),),
        moe=cc(n_experts=e, top_k=k, d_ff_expert=2 * d,
               capacity_factor=cf, n_shared_experts=shared,
               dense_residual=dense),
        param_dtype="float32", compute_dtype="float32")


def _init(cfg, seed=0):
    return moe_mod.MoE(torch.Generator().manual_seed(seed), cfg,
                       device="cpu")


def _x(shape, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


@torch.no_grad()
def test_moe_no_drops_at_high_capacity_matches_dense_gather():
    """With capacity >> need, MoE == explicit per-token expert mix."""
    cfg = _cfg(cf=16.0)
    p = _init(cfg)
    x = _x((2, 16, cfg.d_model))
    y, aux = moe_mod.apply_moe(p, x, cfg)
    assert float(aux["moe_drop_frac"]) == 0.0
    probs = torch.softmax(x @ p.router, -1)
    gates, idx = moe_mod.top_k(probs, cfg.moe.top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    want = torch.zeros_like(y)
    for b in range(2):
        for s in range(16):
            for kk in range(cfg.moe.top_k):
                e = int(idx[b, s, kk])
                tok = x[b, s]
                h = torch.nn.functional.silu(tok @ p.experts_gate[e]) * (
                    tok @ p.experts_up[e])
                want[b, s] += gates[b, s, kk] * (h @ p.experts_down[e])
    torch.testing.assert_close(y, want, atol=1e-4, rtol=0)


@torch.no_grad()
def test_moe_capacity_drops_reported():
    cfg = _cfg(e=2, k=2, cf=0.5)     # starved capacity
    _, aux = moe_mod.apply_moe(_init(cfg), _x((1, 32, cfg.d_model)), cfg)
    assert float(aux["moe_drop_frac"]) > 0.2


@torch.no_grad()
def test_moe_shared_and_dense_paths_add():
    cfg = _cfg(shared=1, dense=True, cf=8.0)
    p = _init(cfg)
    assert p.shared is not None and p.dense is not None
    x = _x((1, 8, cfg.d_model))
    y, _ = moe_mod.apply_moe(p, x, cfg)
    # zeroing the shared + dense weights changes the output
    for mlp in (p.shared, p.dense):
        for w in mlp.parameters():
            w.zero_()
    y2, _ = moe_mod.apply_moe(p, x, cfg)
    assert float((y - y2).abs().max()) > 1e-4


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(2, 6), st.integers(1, 3))
def test_moe_gates_convex_and_capacity_respected(seed, e, k):
    k = min(k, e)
    cfg = _cfg(e=e, k=k, cf=1.0)
    with torch.no_grad():
        y, aux = moe_mod.apply_moe(_init(cfg, seed % 1000),
                                   _x((1, 16, cfg.d_model), seed), cfg)
    assert torch.isfinite(y).all()
    assert 0.0 <= float(aux["moe_drop_frac"]) <= 1.0
    assert moe_mod.expert_capacity(cfg, 16) == int(np.ceil(k * 16 / e))


@torch.no_grad()
def test_moe_aux_losses_positive_and_balanced_router():
    cfg = _cfg(cf=8.0)
    p = _init(cfg)
    # uniform router -> aux loss at its minimum E * (1/E) * 1 * weight
    p.router.zero_()
    _, aux = moe_mod.apply_moe(p, _x((2, 32, cfg.d_model)), cfg)
    e = cfg.moe.n_experts
    want = e * (1.0 / e) * 1.0 * cfg.moe.aux_loss_weight
    np.testing.assert_allclose(float(aux["moe_aux_loss"]), want, rtol=0.05)


def _ref_dispatch(probs, k, cap):
    """The reference's routing (``src/repro/models/moe.py:68-85``) on jnp,
    returning the same tuple as the port's ``moe.dispatch``."""
    b, s, e = probs.shape
    gate_vals, idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    assign = jax.nn.one_hot(idx, e, dtype=jnp.int32).sum(2)
    pos_e = jnp.cumsum(assign, axis=1) - assign
    pos_k = jnp.take_along_axis(pos_e, idx, axis=2)
    valid = pos_k < cap
    b_idx = jnp.broadcast_to(jnp.arange(b)[:, None, None], (b, s, k))
    s_idx = jnp.broadcast_to(jnp.arange(s)[None, :, None], (b, s, k))
    slot = jnp.where(valid, pos_k, cap)
    d_idx = jnp.zeros((b, e, cap + 1), jnp.int32).at[
        b_idx, idx, slot].set(s_idx, mode="drop")[:, :, :cap]
    live = jnp.zeros((b, e, cap + 1), jnp.bool_).at[
        b_idx, idx, slot].set(True, mode="drop")[:, :, :cap]
    return gate_vals, idx, assign, pos_k, valid, d_idx, live


@pytest.mark.parametrize("e,k,cf", [(4, 2, 0.5), (8, 3, 0.75),
                                    (6, 2, 1.0), (4, 2, 8.0)])
def test_dispatch_and_drops_equal_reference(e, k, cf):
    """On the same weights and tokens: the routing tables and
    ``moe_drop_frac`` bit for bit, the output within ``TOL``.  The tied
    case (a zero router: every probability 1/E) checks the top-k order."""
    cfg, rcfg = _cfg(e=e, k=k, cf=cf, shared=1), _cfg(e=e, k=k, cf=cf,
                                                      shared=1, ref=True)
    p = _init(cfg, seed=2)
    rp = {n.replace("shared.", ""): jnp.asarray(v.detach().numpy())
          for n, v in p.named_parameters()}
    rp = {**{n: v for n, v in rp.items() if n.startswith(("router",
                                                          "experts"))},
          "shared": {n: v for n, v in rp.items()
                     if not n.startswith(("router", "experts"))}}
    x = _x((2, 24, cfg.d_model), seed=3)
    cap = moe_mod.expert_capacity(cfg, 24)
    assert cap == ref_moe.expert_capacity(rcfg, 24)
    for router in ("drawn", "tied"):
        if router == "tied":
            with torch.no_grad():
                p.router.zero_()
            rp["router"] = jnp.zeros_like(rp["router"])
        with torch.no_grad():
            y, aux = moe_mod.apply_moe(p, x, cfg)
            probs = torch.softmax(x @ p.router, -1)
        ry, raux = ref_moe.apply_moe(rp, jnp.asarray(x.numpy()), rcfg)
        got = moe_mod.dispatch(probs, k, cap)
        want = _ref_dispatch(jnp.asarray(probs.numpy()), k, cap)
        for name, a, b in zip(("gate_vals", "idx", "assign", "pos_k",
                               "valid", "d_idx", "live"), got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{router} {name}")
        assert float(aux["moe_drop_frac"]) == float(raux["moe_drop_frac"])
        if cf < 1.0:
            assert float(aux["moe_drop_frac"]) > 0.0
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=TOL,
                                   atol=TOL)
        for key in ("moe_aux_loss", "moe_z_loss"):
            np.testing.assert_allclose(float(aux[key]), float(raux[key]),
                                       rtol=TOL, atol=TOL)
