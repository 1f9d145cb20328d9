"""Tensor parallelism on the ``model`` axis for the LM side path: the
port's partitioned layers (``sharding.use_sharding`` under
``launch.mesh.rules_for``) against one rank, and against the reference's
single-device functions on the same numpy parameters.

Seven smoke variants (``tests/torch_mesh_cases.py::TP_VARIANTS``) cover
padded GQA (qwen2: 6 heads padded to 8 over 2 kv heads, so at TP 2 rank
0's q head 3 reads kv head 1, held by rank 1), window + softcaps + tied
embeddings with a vocab that does not divide by 4 (gemma2), MLA and MoE
with shared experts (deepseek), MoE with 6 experts under sequence
parallelism (arctic), the encoder and cross attention with a ``d_ff``
that does not divide by 4 (whisper), Mamba2 split on both meshes beside
shared attention, its 8 heads over 2 B / C groups (zamba2), and mLSTM's
2 heads split on ``(2, 2)`` and computed whole on ``(1, 4)`` beside a
replicated sLSTM (xlstm).  The reference draws each variant's
parameters (``init_params(PRNGKey(0), cfg)``); the ranks load them
through ``convert.lm_params_from_numpy``.

The multi-rank checks run once, on 4 gloo host ranks
(``tests/torch_mesh_cases.py::tp_case``), for both ``(data 2, model 2)``
and ``(data 1, model 4)``: forward logits, ``loss_fn`` and every
gradient, one AdamW step (the gradients the train step builds on the
rank's rows, and the updated parameters) and 8 decode steps on a
``kv_seq``-split cache equal one rank's within ``TP_TOL`` = 2e-5 of the
one-rank result's largest |value| (float32); each entry's AdamW move is
held within ``TP_MOVE_TOL`` x lr where its one-rank gradient is not
near 0.  Rank 0's partitioned logits, loss, gradients
and decode logits are then held here to the reference's ``forward``,
``jax.grad(loss_fn)`` and ``decode_step`` at the same bar.  The
reference's ``decode_step`` groups the *padded* q heads of a GQA model
(``Hp / Hkv`` a group), which disagrees with its own forward whenever
GQA heads are padded; the padded qwen2 variant's decode is therefore held
to the reference's forward over the same positions (decoding from an
empty cache is the causal forward, position by position).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import hostdev  # noqa: E402
from repro_torch.launch.mesh import rules_for  # noqa: E402

RANKS = 4
VARIANTS = list(cases.TP_VARIANTS)
# the reference's decode_step disagrees with its forward on padded GQA
DECODE_BY_FORWARD = ("qwen2-padded",)


def _reference(name, params_dir):
    """Draw the variant's parameters with the reference, save them for
    the ranks, and return its ``(logits, loss, {path: grad}, decode
    logits)`` on the case's batch."""
    cfg = cases.tp_config(name, ref_configs)
    params = ref_tf.init_params(jax.random.PRNGKey(0), cfg)
    np.savez(params_dir / f"{name}.npz",
             **convert._flatten(jax.tree.map(np.asarray, params)))
    batch = {k: jnp.asarray(v.astype(np.int32) if k == "tokens" else v)
             for k, v in cases.tp_batch(cfg).items()}
    logits = jax.jit(lambda p, b: ref_tf.forward(p, b, cfg))(params, batch)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_tf.loss_fn(p, b, cfg)[0]))(params, batch)
    if name in DECODE_BY_FORWARD:
        dec = logits[:, :cases.TP_DECODE]
    else:
        dec = _reference_decode(cfg, params, batch)
    return (np.asarray(logits), float(loss),
            convert._flatten(jax.tree.map(np.asarray, grads)),
            np.asarray(dec))


def _reference_decode(cfg, params, batch):
    """``TP_DECODE`` reference decode steps from an empty cache of
    ``TP_CACHE`` slots (whisper's cross caches filled from its encoder,
    as ``tests/test_models_smoke.py`` does)."""
    state = ref_tf.init_decode_state(cfg, cases.TP_BATCH, cases.TP_CACHE,
                                     dtype=jnp.float32)
    if cfg.is_encoder_decoder:
        enc = ref_tf._encode(params, batch, cfg)

        def fill(c, p):
            ck, cv = ref_attn._project_kv(p["cross"], enc, cfg, None,
                                          use_rope=False)
            return {**c, "cross_k": ck, "cross_v": cv}
        state["blocks"] = jax.vmap(
            lambda c, p: {k: fill(c[k], p[k]) for k in c})(
                state["blocks"], params["blocks"])
    step = jax.jit(ref_tf.decode_step, static_argnames=("cfg",))
    outs = []
    for t in range(cases.TP_DECODE):
        logits, state = step(params, state, batch["tokens"][:, t:t + 1],
                             jnp.int32(t), cfg)
        outs.append(logits[:, 0])
    return jnp.stack(outs, axis=1)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """The reference's results, then the case once on 4 host ranks:
    ``(status by variant, rank 0's arrays, reference by variant)``."""
    out = tmp_path_factory.mktemp("tp")
    want = {name: _reference(name, out) for name in VARIANTS}
    hostdev.run_host_ranks(cases.tp_case, RANKS, (str(out), str(out)),
                           rdzv_dir=str(out), timeout=600)
    with open(out / "results.json") as f:
        status = json.load(f)
    with np.load(out / "arrays.npz") as z:
        arrays = dict(z)
    return status, arrays, want


def _within(got, want, what):
    tol = cases.TP_TOL * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max |err| {err} past {tol}"


@pytest.mark.parametrize("name", VARIANTS)
def test_tensor_parallel_matches_one_rank(tp_run, name):
    """Logits, loss, every gradient, one AdamW step and 8 decode steps on
    both meshes equal one rank's (checked on the ranks)."""
    assert tp_run[0][name] == "ok", tp_run[0][name]


@pytest.mark.parametrize("mesh", list(cases.TP_MESHES))
@pytest.mark.parametrize("name", VARIANTS)
def test_tensor_parallel_matches_reference(tp_run, name, mesh):
    """Rank 0's partitioned results against the reference's single-device
    ``forward``, ``jax.grad(loss_fn)`` and ``decode_step``."""
    _, arrays, want = tp_run
    logits, loss, grads, dec = want[name]
    tag = f"{name}/{mesh}"
    _within(arrays[f"{tag}/logits"], logits, f"{tag} logits")
    _within(arrays[f"{tag}/loss"], np.float32(loss), f"{tag} loss")
    _within(arrays[f"{tag}/decode"], dec, f"{tag} decode")
    prefix = f"{tag}/grad/"
    got = convert._flatten(convert.lm_tree_to_numpy({
        k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items()
        if k.startswith(prefix)}))
    assert set(got) == set(grads)
    g_max = max(float(np.abs(v).max()) for v in grads.values())
    for k, g in grads.items():
        err = float(np.abs(got[k] - g).max())
        assert err <= cases.TP_TOL * g_max, (k, err, g_max)


def test_decode_state_of_another_split_raises(tp_run):
    """A decode state made under ``kv_seq`` (half the slots a rank on
    ``(2, 2)``, a quarter on ``(1, 4)``) and decoded with no sharding or
    on ``(2, 2)`` raises at the first slot no rank holds (checked on the
    ranks)."""
    assert tp_run[0]["stale_split"] == "ok", tp_run[0]["stale_split"]


def test_ssm_decode_state_of_another_split_raises(tp_run):
    """Mamba2 and mLSTM decode caches hold the heads of the split they
    were made under: a state made with no sharding or on ``(1, 4)`` and
    decoded on ``(2, 2)`` raises (checked on the ranks)."""
    assert tp_run[0]["stale_ssm_split"] == "ok", \
        tp_run[0]["stale_ssm_split"]


def test_slstm_collectives_do_not_grow_with_the_sequence(tp_run):
    """One ``apply_slstm`` on ``(2, 2)`` (``w_gates`` stored FSDP-split)
    issues as many all-gathers in its forward, and as many all-gathers
    and all-reduces in its backward, at ``TP_SLSTM_SEQS`` = 8 and 16
    steps: the step loop reads its parameters once."""
    assert tp_run[0]["slstm_collectives"] == "ok", \
        tp_run[0]["slstm_collectives"]
    counts = tp_run[1]["slstm/collectives"]
    assert counts.shape == (len(cases.TP_SLSTM_SEQS), 3)
    assert (counts == counts[0]).all(), counts
    assert counts[0, 0] > 0 and counts[0, 2] > 0, counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_reads_once_as_it_read_each_step(dtype):
    """No mesh: ``apply_slstm``, which reads its parameters once, is bit
    for bit, forward and gradients, the loop that read them at every
    step; ``slstm_decode`` equals one such step."""
    import dataclasses
    from repro_torch.models import ssm
    cfg = dataclasses.replace(cases.tp_config("xlstm", port_configs),
                              compute_dtype=dtype)
    layer = ssm.SLSTM(torch.Generator().manual_seed(0), cfg, device="cpu")
    u = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)).requires_grad_()
    cd = getattr(torch, dtype)

    def per_step_reads():
        cache = ssm.init_slstm_cache(cfg, 2, cd, "cpu")
        state = (cache["h"], cache["c"], cache["n"], cache["m"])
        hs = []
        for t in range(u.shape[1]):
            state = ssm._slstm_step(ssm._slstm_weights(layer),
                                    u[:, t].to(cd), state, cfg)
            hs.append(state[0])
        return ssm._slstm_out(layer, torch.stack(hs, dim=1), cfg)

    leaves = [u, *layer.parameters()]
    got, want = ssm.apply_slstm(layer, u, cfg), per_step_reads()
    assert torch.equal(got, want)
    for a, b in zip(torch.autograd.grad(got.float().square().sum(), leaves),
                    torch.autograd.grad(want.float().square().sum(),
                                        leaves)):
        assert torch.equal(a, b)
    with torch.no_grad():
        step, _ = ssm.slstm_decode(layer, u[:, :1],
                                   ssm.init_slstm_cache(cfg, 2, cd, "cpu"),
                                   cfg)
    assert torch.equal(step, got[:, :1])


def test_decode_past_the_cache_raises():
    """One rank, no sharding: a decode step at ``pos`` = the cache's
    length raises instead of dropping the new K/V."""
    from repro_torch.models import transformer as tf
    cfg = cases.tp_config("qwen2-padded", port_configs)
    model = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    state = tf.init_decode_state(cfg, 1, 2, dtype=torch.float32,
                                 device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int64)
    for t in range(2):
        tf.decode_step(model, state, tok, t, cfg)
    with pytest.raises(ValueError, match="past the cache"):
        tf.decode_step(model, state, tok, 2, cfg)


def test_rules_carry_every_logical_axis_on_model():
    """``tensor_parallel_of`` reads ``rules_for``'s heads / mlp / vocab /
    expert / kv_seq (and seq under ``seq_parallel``) off the model axis;
    ``pure_dp`` and a model axis of one rank carry none."""

    class Mesh:
        mesh_dim_names = ("data", "model")

        def __init__(self, shape):
            self.shape = shape

        def size(self, i):
            return self.shape[i]

    cfg = port_configs.smoke(port_configs.get_config("qwen2-0.5b"))
    tp = sharding.tensor_parallel_of(Mesh((2, 2)), rules_for(cfg, {
        "data": 2, "model": 2}))
    assert (tp.dim, tp.heads, tp.mlp, tp.vocab, tp.expert, tp.kv_seq,
            tp.seq) == (1, True, True, True, True, True, False)
    sp = rules_for(cases.tp_config("arctic", port_configs),
                   {"data": 2, "model": 2})
    assert sharding.tensor_parallel_of(Mesh((2, 2)), sp).seq
    dp = rules_for(cfg, {"data": 2, "model": 2}, global_batch=4,
                   pure_dp=True)
    assert sharding.tensor_parallel_of(Mesh((2, 2)), dp) is None
    one = rules_for(cfg, {"data": 4, "model": 1})
    assert sharding.tensor_parallel_of(Mesh((4, 1)), one) is None


def test_tensor_parallel_reaches_other_threads():
    """The tensor-parallel state is process-wide, as the data-parallel
    block: the autograd engine's device threads run the backward and a
    checkpointed block's recomputation."""
    import threading
    tp = sharding.TensorParallel(mesh=None, dim=1)
    seen = []
    prev, sharding._TP[0] = sharding._TP[0], tp
    try:
        t = threading.Thread(
            target=lambda: seen.append(sharding.tensor_parallel()))
        t.start()
        t.join()
    finally:
        sharding._TP[0] = prev
    assert seen == [tp] and sharding.tensor_parallel() is None
