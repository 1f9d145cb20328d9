"""LM training in the port alone: every ``smoke()`` arch trains (ports of
``tests/test_models_smoke.py::test_smoke_train_step`` and
``::test_smoke_loss_decreases``), and the trainer ``launch/train.py``
resumes a run (the port of
``tests/test_train_e2e.py::test_sharded_train_checkpoint_resume_cycle``
on one process; its ``--mesh debug`` form runs on 4 ranks in
``test_torch_lm_distributed.py``) from checkpoints in the reference's
layout.

The smoke runs: 8 AdamW steps at lr 3e-3 on one fixed numpy batch
(B = 2, S = 64): the first step's loss is finite and moves every
parameter, and the CE falls (the batch is memorized).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, smoke  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim.optimizers import (OptimizerConfig,  # noqa: E402
                                          make_optimizer)
from repro_torch.train.train_step import make_train_step  # noqa: E402

ARCHS = ref_list_archs()
SMOKE_STEPS = 8
SMOKE_LR = 3e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_batch(cfg, b=2, s=64, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                   (b, s)))}
    if cfg.vision_tokens:
        out["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32))
    if cfg.is_encoder_decoder:
        out["audio_frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return out


@functools.lru_cache(maxsize=None)
def smoke_run(arch):
    """8 steps of ``arch``'s ``smoke()``: (first step's metrics, the
    largest parameter change of the first step, CE losses)."""
    cfg = smoke(get_config(arch))
    model = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = make_optimizer(model, OptimizerConfig(lr=SMOKE_LR))
    step = make_train_step(cfg, opt)
    batch = smoke_batch(cfg)
    losses, first, moved = [], None, None
    for i in range(SMOKE_STEPS):
        m = step(model, i, batch)
        if i == 0:
            first = {k: float(v) for k, v in m.items()}
            moved = {n: float((p.detach() - start[n]).abs().max())
                     for n, p in model.named_parameters()}
        losses.append(float(m["ce_loss"]))
    return first, moved, losses


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step(arch):
    first, moved, _ = smoke_run(arch)
    assert np.isfinite(first["loss"])
    # every parameter actually changes (the reference checks the largest)
    assert min(moved.values()) > 0, min(moved, key=moved.get)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_loss_decreases(arch):
    losses = smoke_run(arch)[2]
    assert losses[-1] < losses[0], losses


def _trainer_args(d, steps):
    return ["--arch", "qwen2-0.5b", "--batch", "4", "--seq", "64",
            "--ckpt-dir", str(d), "--ckpt-every", "4", "--log-every", "2",
            "--steps", str(steps), "--device", "cpu"]


def test_trainer_resume_cycle(tmp_path, capsys):
    """8 steps with checkpoints at 4 and 8, then a restart to 12 resumes
    from step 8 exactly: the resumed steps' losses equal an uninterrupted
    run's, and the loss falls across the restart."""
    first = train_cli.main(_trainer_args(tmp_path / "a", 8))
    out1 = capsys.readouterr().out
    assert "step     0" in out1 and "step     7" in out1
    assert ckpt.latest_step(str(tmp_path / "a")) == 8
    again = train_cli.main(_trainer_args(tmp_path / "a", 12))
    out2 = capsys.readouterr().out
    assert "resumed from step 8" in out2
    assert "step     8" in out2 and "step    11" in out2
    assert again.losses[11] < first.losses[0]
    straight = train_cli.main(_trainer_args(tmp_path / "b", 12))
    for s in range(8, 12):
        assert again.losses[s] == straight.losses[s], s
    for n, p in straight.model.named_parameters():
        assert torch.equal(p, dict(again.model.named_parameters())[n]), n


def test_trainer_checkpoint_is_the_reference_layout(tmp_path):
    """The saved leaves are the reference trainer's: the paths and shapes
    of ``{"params": params, "opt": opt.init(params)}`` of the same
    config."""
    train_cli.main(_trainer_args(tmp_path, 1))
    step = ckpt.latest_step(str(tmp_path))
    with np.load(tmp_path / f"step-{step:09d}" / "leaves.npz") as z:
        got = {k: z[k].shape for k in z.files}
    cfg = ref_smoke(ref_get_config("qwen2-0.5b"), d_model=256, n_super=2,
                    vocab=2048)
    params = jax.eval_shape(lambda: ref_tf.init_params(
        jax.random.PRNGKey(0), cfg))
    opt = ref_opt.make_optimizer(ref_opt.OptimizerConfig())
    tree = {"params": params, "opt": jax.eval_shape(opt.init, params)}
    want = {"/".join(k.split(".")): tuple(v.shape)
            for k, v in convert._flatten(tree).items()}
    assert got == want


def test_trainer_refuses_a_non_finite_loss(tmp_path, monkeypatch):
    """A NaN loss raises before any checkpoint is written."""
    real = train_cli.make_train_step

    def poisoned(*a, **kw):
        step = real(*a, **kw)

        def run(*args, **kwargs):
            m = step(*args, **kwargs)
            m["loss"] = m["loss"] * float("nan")
            return m
        return run

    monkeypatch.setattr(train_cli, "make_train_step", poisoned)
    with pytest.raises(RuntimeError, match="non-finite loss at step 0"):
        train_cli.main(_trainer_args(tmp_path, 4))
    assert ckpt.latest_step(str(tmp_path)) is None


def test_trainer_needs_the_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "qwen2-0.5b", "--steps", "1"])


def test_trainer_production_mesh_needs_its_ranks():
    with pytest.raises(ValueError, match="256 ranks"):
        train_cli.main(["--mesh", "single", "--device", "cpu", "--steps",
                        "1"])
