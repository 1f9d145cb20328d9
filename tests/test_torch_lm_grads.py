"""LM gradients and the train step against the reference, dense and
encoder-decoder archs (qwen2-0.5b: GQA with bias and tied embeddings;
whisper-large-v3: the encoder and cross-attention); the MoE / MLA and
xLSTM archs are in ``test_torch_lm_grads_moe.py`` (two files, so that no
one test worker carries every jax compile).

Each arch's ``smoke(n_super=1)`` parameters are drawn by the reference
(``init_params(PRNGKey(0))``) and moved to the port through
``convert.lm_params_from_numpy``; both differentiate ``loss_fn`` on the
same numpy batch (B = 2, S = 32, float32), the reference with
``jax.value_and_grad``, the port with autograd.  Every gradient leaf is
compared in the reference's stacked layout (``convert.lm_tree_to_numpy``)
within ``GRAD_TOL`` = 1e-5 of ``max |g_ref|`` (measured: under 1e-6).

Then the slice as a whole: 3 ``make_train_step`` steps of both packages
(AdamW, lr 1e-2 on a cosine schedule) from the same parameters on the
reference's ``synth_batch`` batches, held to the reference's bars for a
sharded step against a single one: loss within rtol 2e-4, parameters
within 3e-3.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro.train import train_step as ref_train  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim.optimizers import (OptimizerConfig,  # noqa: E402
                                          cosine_schedule, make_optimizer)
from repro_torch.train.train_step import make_train_step  # noqa: E402

GRAD_TOL = 1e-5
GRAD_TOL_XLSTM = 1e-4      # its stack amplifies rounding (PERF.md, PR 27)
LOSS_TOL = 1e-5
STEP_LOSS_RTOL = 2e-4      # the reference's bars (tests/test_distributed.py)
STEP_PARAM_TOL = 3e-3
STEP_LR = 1e-2
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models' many small host ops run on one intra-op thread (more
    only add wake-up overhead at these sizes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch_np(cfg, b=B, s=S, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.vision_tokens:
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["audio_frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def to_ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_port(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def pair(arch, n_super=1):
    """``(ref cfg, ref params, numpy tree, port cfg)`` of an arch's
    ``smoke(n_super=...)``, drawn once by the reference."""
    cfg = ref_smoke(ref_get_config(arch), n_super=n_super)
    params = ref_tf.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, jax.tree.map(np.asarray, params), \
        smoke(get_config(arch), n_super=n_super)


def port_grads(model, batch, cfg):
    """``(loss, metrics, {name: grad})`` of the port's ``loss_fn``."""
    loss, metrics = tf.loss_fn(model, to_port(batch), cfg)
    named = list(model.named_parameters())
    gs = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return loss, metrics, {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(named, gs)}


def check_grads_against_reference(arch, tol):
    cfg, params, tree, pcfg = pair(arch)
    batch = batch_np(cfg)
    (want, want_m), ref_g = jax.jit(jax.value_and_grad(
        lambda p, b: ref_tf.loss_fn(p, b, cfg), has_aux=True))(
            params, to_ref(batch))
    model = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    loss, metrics, grads = port_grads(model, batch, pcfg)
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_TOL)
    assert set(metrics) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]),
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=k)
    got = convert._flatten(convert.lm_tree_to_numpy(grads))
    ref = convert._flatten(jax.tree.map(np.asarray, ref_g))
    assert set(got) == set(ref)
    g_max = max(float(np.abs(v).max()) for v in ref.values())
    assert g_max > 0
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= tol * g_max, (k, err, g_max)


def run_train_steps(arch, n_steps=3):
    """``n_steps`` AdamW steps of both packages from the reference's
    parameters on the reference's synthetic batches: ``(port losses,
    reference losses, port params, reference params)``."""
    cfg, params, tree, pcfg = pair(arch)
    sched = (STEP_LR, 1, n_steps)
    opt = ref_opt.make_optimizer(ref_opt.OptimizerConfig(lr=STEP_LR),
                                 ref_opt.cosine_schedule(*sched))
    state = opt.init(params)
    step = jax.jit(ref_train.make_train_step(cfg, opt))
    model = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    popt = make_optimizer(model, OptimizerConfig(lr=STEP_LR),
                          cosine_schedule(*sched))
    pstep = make_train_step(pcfg, popt)
    dcfg = ref_pipeline.DataConfig()
    want, got = [], []
    for i in range(n_steps):
        batch = ref_pipeline.synth_batch(cfg, dcfg, i, B, S)
        params, state, m = step(params, state, jnp.int32(i), to_ref(batch))
        want.append(float(m["loss"]))
        got.append(float(pstep(model, i, to_port(batch))["loss"]))
    return got, want, model, params


def check_train_steps(arch):
    got, want, model, params = run_train_steps(arch)
    np.testing.assert_allclose(got, want, rtol=STEP_LOSS_RTOL)
    mine = convert._flatten(convert.lm_tree_to_numpy(model))
    ref = convert._flatten(jax.tree.map(np.asarray, params))
    worst = max(float(np.abs(mine[k] - ref[k]).max()) for k in ref)
    assert worst < STEP_PARAM_TOL, worst
    start = convert._flatten(pair(arch)[2])
    assert max(float(np.abs(mine[k] - start[k]).max()) for k in ref) > 0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-large-v3"])
def test_gradients_match_reference(arch):
    check_grads_against_reference(arch, GRAD_TOL)


def test_train_steps_match_reference():
    check_train_steps("qwen2-0.5b")


def test_loss_fn_value_is_the_same_with_and_without_grad():
    """``loss_fn`` builds a graph only when grad is on; its value is the
    same either way."""
    cfg, _, tree, pcfg = pair("qwen2-0.5b")
    model = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    batch = to_port(batch_np(cfg))
    with torch.no_grad():
        plain, _ = tf.loss_fn(model, batch, pcfg)
    graph, _ = tf.loss_fn(model, batch, pcfg)
    assert plain.grad_fn is None and graph.grad_fn is not None
    assert torch.equal(plain, graph.detach())
