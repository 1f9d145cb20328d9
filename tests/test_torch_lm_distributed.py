"""LM training across ranks: data parallelism, the LM checkpoints and the
int8 compressed gradient reduction (the port of the LM cases of
``tests/test_distributed.py``: ``:40``, ``:84``, ``:121``, ``:207``, and
of ``tests/test_train_e2e.py::test_sharded_train_checkpoint_resume_cycle``).

The multi-rank cases run once on 4 gloo host ranks
(``tests/torch_mesh_cases.py::lm_train_case``, rendezvous under
``tmp_path``):

* one data-parallel AdamW step (lr 1e-2, B = 4 x 64) of qwen2-0.5b and
  deepseek-v2-lite-16b ``smoke(d_model=64)`` (MoE + MLA + prologue) on a
  ``(data 2, model 2)`` and a ``(data 4, model 1)`` mesh, parameters stored as
  blocks per ``rules_for``, against one rank on the whole batch, at the
  reference's bars: loss within rtol 2e-4, every parameter within 3e-3
  (and the MoE aux metrics within rtol 2e-4: their batch means are
  averaged over the ranks before the product);
* the elastic restore of stablelm ``smoke(d_model=64)``: saved whole,
  restored onto blocks on ``(2, 2)`` and back, exact;
* a checkpoint the reference wrote (its qwen2 ``smoke(d_model=64)``
  parameters and AdamW state after one step) restored onto the ``(2, 2)``
  mesh and trained one more step, held here to the reference's own
  second step at the same bars;
* ``compressed_psum_grads`` on a ``(data 4,)`` mesh against the float32
  gradient of the whole batch, within 0.05 of ``max|g|``, with 2 bytes
  an element on the wire (the reference checks an ``s16`` all-reduce in
  its HLO; the port packs two quanta into each int32 word);
* the trainer with ``--mesh debug`` (qwen2, the launcher's reduced
  config, ``--batch 8 --seq 64 --ckpt-every 4``): 8 steps, then a
  restart to 12 resumes from step 8 with the loss below its first.
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.distributed import checkpoint as ref_ckpt  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro.train import train_step as ref_train  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import hostdev  # noqa: E402
from repro_torch.optim.compression import (  # noqa: E402
    GradCompressor, compressed_psum_grads, pack_int16_pairs,
    unpack_int16_pairs)

RANKS = 4


def _reference_two_steps(ckpt_dir):
    """The reference's qwen2 ``smoke(d_model=64)``: one AdamW step from
    ``PRNGKey(0)`` saved at step 1 to ``ckpt_dir``, and its second step
    on the case's second batch: ``(loss, params as numpy)``."""
    cfg = ref_smoke(ref_get_config("qwen2-0.5b"),
                    d_model=cases.LM_DP["d_model"])
    params = ref_tf.init_params(jax.random.PRNGKey(0), cfg)
    opt = ref_opt.make_optimizer(ref_opt.OptimizerConfig(
        lr=cases.LM_DP["lr"]))
    state = opt.init(params)
    step = jax.jit(ref_train.make_train_step(cfg, opt))
    tok = cases.lm_dp_tokens(cfg.vocab_size).astype(np.int32)
    params, state, _ = step(params, state, jnp.int32(0),
                            {"tokens": jnp.asarray(tok)})
    ref_ckpt.save(ckpt_dir, 1, {"params": params, "opt": state})
    tok = cases.lm_dp_tokens(cfg.vocab_size, seed=6).astype(np.int32)
    params, _, metrics = step(params, state, jnp.int32(1),
                              {"tokens": jnp.asarray(tok)})
    return float(metrics["loss"]), convert._flatten(
        jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The cases once on 4 host ranks: ``(status by check, arrays,
    reference's second step)``."""
    out = tmp_path_factory.mktemp("lm_mesh")
    ref_dir = out / "ref_ckpt"
    want = _reference_two_steps(str(ref_dir))
    hostdev.run_host_ranks(cases.lm_train_case, RANKS,
                           (str(out), str(out / "ckpt"), str(ref_dir)),
                           rdzv_dir=str(out), timeout=400)
    with open(out / "results.json") as f:
        status = json.load(f)
    with np.load(out / "arrays.npz") as z:
        arrays = dict(z)
    return status, arrays, want


def _ok(mesh_run, name):
    assert mesh_run[0][name] == "ok", mesh_run[0][name]


@pytest.mark.parametrize("arch", ["qwen2", "deepseek"])
def test_data_parallel_step_matches_one_rank(mesh_run, arch):
    _ok(mesh_run, f"dp_{arch}")
    for label in cases.LM_DP_MESHES:
        key = [k for k in mesh_run[1] if k.startswith(arch)
               and k.endswith(f"adamw_{label}_loss")]
        got, want, worst = mesh_run[1][key[0]]
        np.testing.assert_allclose(got, want, rtol=cases.LM_LOSS_RTOL)
        assert worst < cases.LM_PARAM_TOL


def test_adafactor_on_blocks_matches_one_rank(mesh_run):
    """Adafactor (factored row / col state, ``factored_min_dim=16``) on
    parameters stored as blocks on ``(2, 2)``: the data-parallel step
    against one rank, the loss at rtol 2e-4 and the parameters within
    1e-6 (Adafactor's first update is smooth in the gradient, where
    AdamW's is its sign, so float order moves it by ~lr x 1e-6)."""
    _ok(mesh_run, "adafactor_blocks")
    got, want, worst = mesh_run[1]["qwen2-0.5b_adafactor_2x2_loss"]
    np.testing.assert_allclose(got, want, rtol=cases.LM_LOSS_RTOL)
    assert worst < cases.LM_ADAFACTOR_PARAM_TOL


def test_compressor_on_gradient_blocks(mesh_run):
    """``GradCompressor`` on gradient blocks equals it on the whole
    gradients bit for bit (the scale is the whole tensor's max)."""
    _ok(mesh_run, "compressor_blocks")


def test_elastic_lm_checkpoint_restore(mesh_run):
    _ok(mesh_run, "elastic")


def test_reference_checkpoint_resumes_on_the_mesh(mesh_run):
    """The ranks' second step from the reference's checkpoint equals the
    reference's second step at the reference's bars."""
    _ok(mesh_run, "reference_checkpoint")
    _, arrays, (want_loss, want) = mesh_run
    np.testing.assert_allclose(arrays["refckpt_loss"][0], want_loss,
                               rtol=cases.LM_LOSS_RTOL)
    got = {k[len("refckpt."):]: v for k, v in arrays.items()
           if k.startswith("refckpt.")}
    assert set(got) == set(want)
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert worst < cases.LM_PARAM_TOL, worst


def test_compressed_psum_grads_on_four_ranks(mesh_run):
    _ok(mesh_run, "compressed")
    assert mesh_run[1]["compressed_err"][0] < 0.05


def test_trainer_mesh_resume_cycle(mesh_run):
    _ok(mesh_run, "launcher")
    losses = mesh_run[1]["launcher_losses"]
    assert losses.shape == (12,) and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_int16_pairs_round_trip_and_sum():
    """Two signed lanes a word: the packed words' int32 sum over ranks
    unpacks to each lane's sum, for lane sums up to 2**15 - 1 in
    magnitude, odd counts included."""
    rng = np.random.default_rng(0)
    for n in (1, 7, 64, 4097):
        qs = [torch.from_numpy(rng.integers(-127, 128, n)) for _ in range(4)]
        words = sum(pack_int16_pairs(q) for q in qs)
        assert words.dtype == torch.int32
        assert words.numel() * words.element_size() == 2 * (n + n % 2)
        assert torch.equal(unpack_int16_pairs(words, n),
                           sum(qs).to(torch.int32))
    edge = torch.tensor([32767, -32767, -1, 1, 0, -32767], dtype=torch.int32)
    assert torch.equal(unpack_int16_pairs(pack_int16_pairs(edge), 6), edge)


def test_compressed_psum_guard():
    """The int16-accumulation guard of the reference: ``n * qmax >=
    2**15`` raises before any collective."""
    class Mesh:
        mesh_dim_names = ("data",)

        def size(self, i):
            return 259

    with pytest.raises(ValueError, match="overflows"):
        compressed_psum_grads(lambda p, b: {}, Mesh(), "data",
                              GradCompressor())


def test_data_parallel_block_reaches_other_threads():
    """The data-parallel block is process-wide: on the card the autograd
    engine runs the backward, and a checkpointed block's recomputation,
    on its own threads, which must average as the forward did."""
    dp = sharding.DataParallel(mesh=None, dims=(0,))
    seen = []
    with sharding.data_parallel(dp):
        t = threading.Thread(
            target=lambda: seen.append(sharding.active_data_parallel()))
        t.start()
        t.join()
    assert seen == [dp] and sharding.active_data_parallel() is None
