"""LM gradients and the train step against the reference: the MoE / MLA
and recurrent archs (deepseek-v2-lite-16b: MLA, MoE with shared experts
and its dense prologue layer; xlstm-125m: mLSTM + sLSTM), and the train
step's options in the port: microbatches, remat and the compressor.
Inputs, the comparison and the bars as in ``test_torch_lm_grads.py``;
xlstm-125m's gradients within ``GRAD_TOL_XLSTM`` = 1e-4 of ``max |g|``
(measured: 1.0e-5), since its stack amplifies rounding (a 1e-7 relative
nudge of its embeddings moved its smoke logits by 3.6e-4, ``PERF.md``,
PR 27).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_lm_grads as base  # noqa: E402
from repro.optim import compression as ref_comp  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro.train import train_step as ref_train  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim.compression import GradCompressor  # noqa: E402
from repro_torch.optim.optimizers import (OptimizerConfig,  # noqa: E402
                                          make_optimizer)
from repro_torch.train.train_step import make_train_step  # noqa: E402

one_thread = base.one_thread


@pytest.mark.parametrize("arch,tol", [
    ("deepseek-v2-lite-16b", base.GRAD_TOL),
    ("xlstm-125m", base.GRAD_TOL_XLSTM)])
def test_gradients_match_reference(arch, tol):
    base.check_grads_against_reference(arch, tol)


def test_train_steps_match_reference_moe():
    base.check_train_steps("deepseek-v2-lite-16b")


def _model_and_batch(arch="qwen2-0.5b", b=4):
    cfg, _, tree, pcfg = base.pair(arch)
    return (convert.lm_params_from_numpy(tree, pcfg, "cpu"), pcfg,
            base.to_port(base.batch_np(cfg, b=b)))


def test_microbatches_equal_one_batch():
    """``microbatches=2`` (float32 accumulation) against one batch of the
    same 4 rows: the loss within float32 rounding, the parameters after
    one step within the reference's bar."""
    out = []
    for mb in (1, 2):
        model, cfg, batch = _model_and_batch()
        opt = make_optimizer(model, OptimizerConfig(lr=base.STEP_LR))
        m = make_train_step(cfg, opt, microbatches=mb)(model, 0, batch)
        out.append((float(m["loss"]), {n: p.detach().clone()
                                       for n, p in model.named_parameters()}))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    worst = max(float((out[1][1][n] - out[0][1][n]).abs().max())
                for n in out[0][1])
    assert worst < base.STEP_PARAM_TOL, worst
    with pytest.raises(ValueError, match="microbatches"):
        model, cfg, batch = _model_and_batch(b=3)
        opt = make_optimizer(model, OptimizerConfig())
        make_train_step(cfg, opt, microbatches=2)(model, 0, batch)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-large-v3",
                                  "zamba2-1.2b"])
def test_remat_gives_the_same_gradients(arch):
    """``cfg.remat`` (activation checkpointing of each superblock, each
    encoder block and each CE chunk) recomputes the same values: loss and
    gradients bit for bit."""
    model, cfg, batch = _model_and_batch(arch, b=2)
    cfg = dataclasses.replace(cfg, loss_chunk=16)
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        loss, _ = tf.loss_fn(model, batch, c)
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_train_step_with_compressor_matches_reference():
    """One step with ``GradCompressor(min_size=16)``: the compressed
    gradients' update and the error feedback against the reference's."""
    cfg, params, tree, pcfg = base.pair("qwen2-0.5b")
    batch = base.batch_np(cfg)
    comp = ref_comp.GradCompressor(min_size=16)
    opt = ref_opt.make_optimizer(ref_opt.OptimizerConfig(lr=base.STEP_LR))
    step = jax.jit(ref_train.make_train_step(cfg, opt, compressor=comp))
    rp, _, rm, ref_ef = step(params, opt.init(params), jnp.int32(0),
                             base.to_ref(batch), comp.init_state(params))
    model = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    popt = make_optimizer(model, OptimizerConfig(lr=base.STEP_LR))
    pcomp = GradCompressor(min_size=16)
    metrics, ef = make_train_step(pcfg, popt, compressor=pcomp)(
        model, 0, base.to_port(batch), pcomp.init_state(model))
    np.testing.assert_allclose(float(metrics["loss"]), float(rm["loss"]),
                               rtol=base.STEP_LOSS_RTOL)
    mine = convert._flatten(convert.lm_tree_to_numpy(model))
    ref = convert._flatten(jax.tree.map(np.asarray, rp))
    worst = max(float(np.abs(mine[k] - ref[k]).max()) for k in ref)
    assert worst < base.STEP_PARAM_TOL, worst
    got_ef = convert._flatten(convert.lm_tree_to_numpy(
        {n: e for n, e in ef.items() if e is not None}))
    want_ef = {k: v for k, v in convert._flatten(
        jax.tree.map(np.asarray, ref_ef)).items() if v is not None}
    assert set(got_ef) == set(want_ef)
    # The feedback is the rounding residue, |e| <= half a quantum: float32
    # differences in the gradients move it by ~1e-6 of max |g|, and where
    # a rounding tie falls the other way by one quantum (<= 2 max |e|).
    for k in want_ef:
        half_q = float(np.abs(want_ef[k]).max())
        diff = np.abs(got_ef[k] - want_ef[k])
        assert float(diff.max()) <= 2.0 * half_q * (1 + 1e-3), k
        assert float(np.mean(diff <= 1e-3 * half_q)) >= 0.99, k
