"""The LM trainer's optimizers, gradient compression and data pipeline
(``repro_torch.optim``, ``repro_torch.data.pipeline``, the ``Watchdog``
of ``launch/train.py``) against the reference on the same numpy inputs;
ports of ``tests/test_optim.py``, ``tests/test_optim_properties.py`` and
``tests/test_distributed.py::test_gradient_compression_roundtrip``.

Bounds: AdamW and Adafactor updates within float32 rounding of the
reference's (rtol = atol = ``TOL`` = 1e-5 on parameters and float32
state over 3 steps; a bfloat16 state leaf within one bfloat16 step,
rtol = atol = 2 ** -7, since a float32 ulp can move a rounding boundary,
and the parameters then within lr times that step); the cosine schedule
within float32 rounding of its peak;
``synth_batch`` bit for bit; ``compress_decompress`` within ``TOL`` on
every element but a quantum's worth where a rounding tie falls
differently (none did on these draws).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.optim import compression as ref_comp  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, Prefetcher,  # noqa: E402
                                       synth_batch)
from repro_torch.launch.train import Watchdog  # noqa: E402
from repro_torch.optim.compression import GradCompressor  # noqa: E402
from repro_torch.optim.optimizers import (OptimizerConfig,  # noqa: E402
                                          cosine_schedule, make_adafactor,
                                          make_adamw, make_optimizer)

TOL = 1e-5
BF16_TOL = 2.0 ** -7


def _quad_params():
    return {"w": torch.tensor([3.0, -2.0, 1.5], requires_grad=True),
            "nested.b": torch.tensor([[1.0, -1.0]] * 64,
                                     requires_grad=True)}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_minimizes_quadratic(name):
    params = _quad_params()
    opt = make_optimizer(params, OptimizerConfig(name=name, lr=0.1,
                                                 weight_decay=0.0))

    def loss():
        return torch.sum(params["w"] ** 2) + torch.sum(params["nested.b"] ** 2)

    l0 = float(loss().detach())
    for i in range(50):
        opt.zero_grad()
        loss().backward()
        opt.step(i)
    assert float(loss().detach()) < 0.05 * l0


def test_adamw_matches_reference_first_step():
    """One AdamW step against the closed form (bias-corrected)."""
    cfg = OptimizerConfig(name="adamw", lr=0.01, b1=0.9, b2=0.999,
                          eps=1e-8, weight_decay=0.0)
    p = {"w": torch.tensor([1.0, 2.0])}
    opt = make_adamw(p, cfg)
    g = torch.tensor([0.5, -0.25])
    opt.step(0, {"w": g})
    # step 1: m_hat = g, v_hat = g^2 -> update = g/(|g|+eps) = sign(g)
    want = np.array([1.0, 2.0]) - 0.01 * np.sign(g.numpy())
    np.testing.assert_allclose(p["w"].numpy(), want, rtol=1e-4)


def test_adafactor_factored_state_is_small():
    opt = make_adafactor({"big": torch.zeros(512, 256),
                          "small": torch.zeros(4, 8),
                          "hi_rank": torch.zeros(4, 512, 256)},
                         OptimizerConfig(name="adafactor",
                                         factored_min_dim=128))
    v = opt.state_tree()["v"]
    assert set(v["big"]) == {"row", "col"}
    assert v["big"]["row"].shape == (512,)
    assert v["big"]["col"].shape == (256,)
    assert set(v["small"]) == {"full"}
    # >2D params factor over (lead, last)
    assert set(v["hi_rank"]) == {"row", "col"}
    assert v["hi_rank"]["row"].shape == (4, 512)
    assert v["hi_rank"]["col"].shape == (4, 256)


def test_grad_clip_bounds_update():
    cfg = OptimizerConfig(name="adamw", lr=1.0, grad_clip=1e-3,
                          weight_decay=0.0)
    p = {"w": torch.zeros(16)}
    opt = make_adamw(p, cfg)
    norm = opt.step(0, {"w": 1e6 * torch.ones(16)})
    assert float(norm) == pytest.approx(4e6)
    assert float(p["w"].abs().max()) <= 1.5   # lr * sign-ish


def test_cosine_schedule_shape_and_reference():
    fn = cosine_schedule(1e-3, warmup=10, total=100)
    s = np.array([float(fn(i)) for i in range(100)])
    assert s[0] == 0.0
    assert abs(s[10] - 1e-3) < 1e-9          # peak after warmup
    assert s[99] < 1e-4                       # decayed
    assert (np.diff(s[:10]) > 0).all()        # warmup monotone
    ref = ref_opt.cosine_schedule(1e-3, warmup=10, total=100)
    want = np.array([float(ref(jnp.asarray(i))) for i in range(100)])
    # float32 rounding of the peak (1 + cos cancels near the end)
    np.testing.assert_allclose(s, want, rtol=1e-6, atol=1e-3 * 2.0 ** -23)


def test_watchdog_flags_stragglers():
    wd = Watchdog(threshold=2.0)
    for i in range(10):
        assert not wd.observe(i, 1.0)
    assert wd.observe(10, 5.0)                # 5x median
    assert not wd.observe(11, 1.1)
    assert wd.flagged == [(10, 5.0)]


# Leaves of every kind: factored 2-D and 3-D (min dim 128), full 2-D, and
# a vector (no weight decay).
SHAPES = {"big": (256, 160), "hi_rank": (2, 130, 128), "small": (4, 8),
          "vec": (16,)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_update_matches_reference_three_steps(name, state_dtype):
    """Three updates (cosine schedule, the clip active on step 2) from the
    same numpy parameters and gradients: parameters and state."""
    rng = np.random.default_rng(0)
    p_np = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    g_np = [{k: (rng.standard_normal(s) * (30.0 if i == 1 else 0.01)
                 ).astype(np.float32) for k, s in SHAPES.items()}
            for i in range(3)]
    cfg = OptimizerConfig(name=name, lr=1e-2, state_dtype=state_dtype,
                          factored_min_dim=128)
    sched = (1e-2, 1, 3)
    ref = ref_opt.make_optimizer(ref_opt.OptimizerConfig(
        name=name, lr=1e-2, state_dtype=state_dtype, factored_min_dim=128),
        ref_opt.cosine_schedule(*sched))
    rp = {k: jnp.asarray(v) for k, v in p_np.items()}
    rs = ref.init(rp)
    params = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    opt = make_optimizer(params, cfg, cosine_schedule(*sched))
    for i in range(3):
        rp, rs = ref.update({k: jnp.asarray(v) for k, v in g_np[i].items()},
                            rs, rp, jnp.asarray(i, jnp.int32))
        opt.step(i, {k: torch.from_numpy(v) for k, v in g_np[i].items()})
    # a bfloat16 momentum a step off by one bfloat16 step moves a
    # parameter by up to lr times that step
    ptol = cfg.lr * BF16_TOL if state_dtype == "bfloat16" else TOL
    for k in SHAPES:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(rp[k]),
                                   rtol=TOL, atol=ptol, err_msg=k)
    got = opt.state_tree()
    tol = BF16_TOL if state_dtype == "bfloat16" else TOL
    for k in SHAPES:
        assert got["m"][k].dtype == getattr(torch, state_dtype)
        np.testing.assert_allclose(
            got["m"][k].float().numpy(),
            np.asarray(rs["m"][k], np.float32), rtol=tol, atol=tol,
            err_msg=f"m {k}")
        want_v = rs["v"][k]
        if name == "adamw":
            np.testing.assert_allclose(
                got["v"][k].float().numpy(), np.asarray(want_v, np.float32),
                rtol=tol, atol=tol, err_msg=f"v {k}")
        else:
            assert set(got["v"][k]) == set(want_v)
            for part in want_v:
                np.testing.assert_allclose(
                    got["v"][k][part].numpy(), np.asarray(want_v[part]),
                    rtol=TOL, atol=1e-12, err_msg=f"v {k} {part}")


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-76b",
                                  "whisper-large-v3"])
def test_synth_batch_is_the_reference_bit_for_bit(arch):
    """Tokens (with the VLM / audio stubs' inputs) for a few steps, and a
    host slice."""
    cfg, rcfg = smoke(get_config(arch)), ref_smoke(ref_get_config(arch))
    d, rd = DataConfig(seed=7), ref_pipeline.DataConfig(seed=7)
    for step in (0, 3, 1000):
        got = synth_batch(cfg, d, step, 4, 32)
        want = ref_pipeline.synth_batch(rcfg, rd, step, 4, 32)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    part = synth_batch(cfg, d, 3, 8, 16, host_slice=slice(2, 6))
    want = ref_pipeline.synth_batch(rcfg, rd, 3, 8, 16,
                                    host_slice=slice(2, 6))
    for k in want:
        np.testing.assert_array_equal(part[k], want[k])
    np.testing.assert_array_equal(
        synth_batch(cfg, d, 3, 8, 16)["tokens"][2:6], part["tokens"])


def test_prefetcher_yields_the_stream_in_order():
    cfg = smoke(get_config("qwen2-0.5b"))
    d = DataConfig(seed=3)
    pf = Prefetcher(cfg, d, 2, 16, start_step=5)
    try:
        it = iter(pf)
        for want_step in (5, 6, 7):
            step, b = next(it)
            assert step == want_step
            np.testing.assert_array_equal(
                b["tokens"], synth_batch(cfg, d, step, 2, 16)["tokens"])
    finally:
        pf.close()


hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 10_000), st.integers(1, 64))
def test_pipeline_determinism(step, batch):
    """Batch i is a pure function of (seed, i): restart-exact replay."""
    cfg = smoke(get_config("qwen2-0.5b"))
    d = DataConfig(seed=7)
    a = synth_batch(cfg, d, step, batch, 32)
    b = synth_batch(cfg, d, step, batch, 32)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = synth_batch(cfg, d, step + 1, batch, 32)
    assert not np.array_equal(a["tokens"], c["tokens"])


# ----------------------------------------------------------- compression

def _compression_grads(i, w):
    return {"w": w * (1.0 + 0.01 * i), "b": np.ones(3, np.float32)}


def test_compress_decompress_matches_reference():
    """20 steps of the same numpy gradients through both compressors: the
    dequantized gradients and the error feedback."""
    w = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    comp = GradCompressor(min_size=16)
    ref = ref_comp.GradCompressor(min_size=16)
    state = comp.init_state({"w": torch.zeros(64, 64), "b": torch.zeros(3)})
    rstate = ref.init_state({"w": jnp.zeros((64, 64)), "b": jnp.zeros(3)})
    for i in range(20):
        g = _compression_grads(i, w)
        got, state = comp.compress_decompress(
            {k: torch.from_numpy(v) for k, v in g.items()}, state)
        want, rstate = ref.compress_decompress(
            {k: jnp.asarray(v) for k, v in g.items()}, rstate)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        np.testing.assert_allclose(state["w"].numpy(),
                                   np.asarray(rstate["w"]), rtol=TOL,
                                   atol=TOL)
        assert state["b"] is None and rstate["b"] is None


def test_gradient_compression_error_feedback_round_trip():
    """Accumulated dequantized gradients converge to the accumulated true
    ones (the reference's bar, 5e-3 of the max)."""
    comp = GradCompressor(min_size=16)
    state = comp.init_state({"w": torch.zeros(64, 64), "b": torch.zeros(3)})
    assert state["b"] is None and state["w"].shape == (64, 64)
    w = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    acc_true = torch.zeros(64, 64)
    acc_deq = torch.zeros(64, 64)
    for i in range(20):
        g = {k: torch.from_numpy(v) for k, v in
             _compression_grads(i, w).items()}
        deq, state = comp.compress_decompress(g, state)
        acc_true += g["w"]
        acc_deq += deq["w"]
        assert deq["b"].dtype == torch.float32
    rel = float((acc_true - acc_deq).abs().max() / acc_true.abs().max())
    assert rel < 5e-3, rel
