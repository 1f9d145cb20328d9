"""The LM side path's models: the port (``repro_torch.models``,
``repro_torch.configs``) against the reference on the same parameters.

Each arch's ``smoke()`` parameters are drawn once by the reference
(``init_params(PRNGKey(0), cfg)``), moved to the port through
``convert.lm_params_from_numpy``, and both run on the same numpy-drawn
batch (B = 2, S = 64, float32).  The reference runs under ``jax.jit`` on
the CPU, one compile per function and arch.

Tolerances (float32): logits and aux within rtol = atol = ``TOL`` = 1e-4,
except xlstm-125m at ``TOL_XLSTM`` = 1e-3.  The xLSTM stack amplifies
rounding: the reference's own logits move by 3.6e-4 when its embedding
table is scaled by 1 + 1e-7 noise (measured at this size), while each of
its mixers alone agrees with the port within 2.1e-6 (held here at
``TOL``).  Decode equals forward within the same tolerances.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.configs import smoke as ref_smoke  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, list_archs, smoke  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ARCHS = ref_list_archs()
# The reference's decode list (tests/test_models_smoke.py).
DECODE_ARCHS = ("qwen2-0.5b", "gemma2-2b", "xlstm-125m", "zamba2-1.2b",
                "deepseek-v2-lite-16b", "whisper-large-v3")
TOL = 1e-4
TOL_XLSTM = 1e-3
B, S = 2, 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models' many small host ops run on one intra-op thread: more
    only add wake-up overhead at these sizes (restored after the
    module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(arch):
    return TOL_XLSTM if arch == "xlstm-125m" else TOL


def batch_np(cfg, b=B, s=S, seed=1):
    """Tokens (+ stub vision / audio inputs) drawn with numpy."""
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
def pair(arch):
    """``(ref cfg, ref params, numpy tree, port cfg, port model)`` of an
    arch's ``smoke()``, drawn once by the reference."""
    cfg = ref_smoke(ref_get_config(arch))
    params = ref_tf.init_params(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, params)
    pcfg = smoke(get_config(arch))
    return cfg, params, tree, pcfg, convert.lm_params_from_numpy(tree, pcfg,
                                                                 "cpu")


@functools.lru_cache(maxsize=None)
def ref_forward(arch):
    cfg, params, _, _, _ = pair(arch)
    logits, aux = jax.jit(lambda p, b: ref_tf.forward(
        p, b, cfg, return_aux=True))(params, to_ref(batch_np(cfg)))
    return np.asarray(logits), {k: float(v) for k, v in aux.items()}


def test_registry_matches_reference():
    assert list_archs() == ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference_field_for_field(arch):
    full = get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        ref_get_config(arch))
    assert dataclasses.asdict(smoke(full)) == dataclasses.asdict(
        ref_smoke(ref_get_config(arch)))
    for kw in (dict(d_model=32, n_super=1, vocab=128),):
        assert dataclasses.asdict(smoke(full, **kw)) == dataclasses.asdict(
            ref_smoke(ref_get_config(arch), **kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    _, _, _, pcfg, model = pair(arch)
    want, want_aux = ref_forward(arch)
    got, aux = tf.forward(model, to_port(batch_np(pcfg)), pcfg,
                          return_aux=True)
    assert got.shape == (B, S, pcfg.vocab_size) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    tol = _tol(arch)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    assert set(aux) == set(want_aux)
    for k, v in want_aux.items():
        np.testing.assert_allclose(float(aux[k]), v, rtol=tol, atol=tol,
                                   err_msg=k)


def test_forward_last_only_is_the_last_position():
    _, _, _, pcfg, model = pair("gemma2-2b")
    batch = to_port(batch_np(pcfg))
    whole = tf.forward(model, batch, pcfg)
    last = tf.forward(model, batch, pcfg, last_only=True)
    assert last.shape == (B, 1, pcfg.vocab_size)
    torch.testing.assert_close(last, whole[:, -1:], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["mlstm", "slstm"])
def test_xlstm_mixers_match_reference(name):
    """Each xLSTM mixer alone, on the same normal input: within ``TOL``."""
    cfg, params, _, pcfg, model = pair("xlstm-125m")
    i = [s.mixer for s in cfg.block_pattern].index(name)
    p = jax.tree.map(lambda a: a[0], params["blocks"])[str(i)]["mix"]
    x = np.random.default_rng(0).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: getattr(ref_ssm, "apply_" + name)(
        p, x, cfg))(p, jnp.asarray(x))
    got = getattr(ssm, "apply_" + name)(model.blocks[0][str(i)].mix,
                                        torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-lite-16b",
                                  "internvl2-76b"])
def test_loss_matches_reference(arch):
    """``loss_fn``'s value and metrics; qwen2 with ``loss_chunk`` = 32 so
    the chunked CE runs (two chunks of S = 64); internvl2 masks its vision
    slots; deepseek adds the MoE aux losses."""
    cfg, params, _, pcfg, model = pair(arch)
    if arch == "qwen2-0.5b":
        cfg = dataclasses.replace(cfg, loss_chunk=32)
        pcfg = dataclasses.replace(pcfg, loss_chunk=32)
    batch = batch_np(cfg)
    want, want_m = jax.jit(lambda p, b: ref_tf.loss_fn(p, b, cfg))(
        params, to_ref(batch))
    got, got_m = tf.loss_fn(model, to_port(batch), pcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL, atol=TOL)
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def _moe_cf8(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_forward(arch):
    """Token-by-token ``decode_step`` over 32 positions equals the
    forward's logits (the reference's test: MoE at capacity factor 8 so
    the forward drops no token; whisper's cross caches filled from the
    encoder first)."""
    _, _, _, pcfg, model = pair(arch)
    cfg = _moe_cf8(pcfg)
    b, s = 2, 32
    batch = to_port(batch_np(cfg, b, s))
    want = tf.forward(model, batch, cfg)
    state = tf.init_decode_state(cfg, b, s, dtype=torch.float32,
                                 device="cpu")
    if cfg.is_encoder_decoder:
        state = tf.fill_cross_cache(model, state, batch, cfg)
    outs = []
    for t in range(s):
        logits, state = tf.decode_step(model, state,
                                       batch["tokens"][:, t:t + 1], t, cfg)
        outs.append(logits[:, 0])
    tol = _tol(arch)
    torch.testing.assert_close(torch.stack(outs, 1), want, rtol=tol,
                               atol=tol)


def test_decode_matches_reference_decode():
    """The port's decode logits against the reference's ``decode_step`` on
    the same parameters: qwen2 for 8 positions."""
    cfg, params, _, pcfg, model = pair("qwen2-0.5b")
    b, s = 2, 8
    tokens = batch_np(cfg, b, s)["tokens"]
    rstate = ref_tf.init_decode_state(cfg, b, s, dtype=jnp.float32)
    pstate = tf.init_decode_state(pcfg, b, s, dtype=torch.float32,
                                  device="cpu")
    step = jax.jit(ref_tf.decode_step, static_argnames=("cfg",))
    for t in range(s):
        want, rstate = step(params, rstate, jnp.asarray(tokens[:, t:t + 1]),
                            jnp.int32(t), cfg)
        got, pstate = tf.decode_step(
            model, pstate, torch.from_numpy(tokens[:, t:t + 1].astype(
                np.int64)), t, pcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


# bf16 decode state, rtol = atol: tighter than the reference's decode bar
# (chip_smoke's MODEL_DECODE_TOL, 2e-2).  The port's cross products read
# the bf16 caches as float32 where the reference rounds its softmax to
# bf16 before the value product: 8.1e-4 apart on logits of max 0.52 here.
BF16_DECODE_TOL = 2e-3


def test_whisper_decode_on_bf16_state_matches_reference():
    """whisper-large-v3 decodes on ``init_decode_state``'s default bf16
    state (its cross caches bf16 beside float32 queries) and agrees with
    the reference's ``decode_step`` on the same bf16 state: the cross
    caches the port fills from the encoder, copied into the reference's
    state bit for bit, then 8 positions at ``BF16_DECODE_TOL``."""
    cfg, params, _, pcfg, model = pair("whisper-large-v3")
    b, s = 2, 8
    batch = batch_np(cfg, b, s)
    pstate = tf.init_decode_state(pcfg, b, s, device="cpu")
    pstate = tf.fill_cross_cache(model, pstate, to_port(batch), pcfg)
    rstate = ref_tf.init_decode_state(cfg, b, s)
    for i in range(len(cfg.block_pattern)):
        for name in ("cross_k", "cross_v"):
            caches = [blk[str(i)][name] for blk in pstate["blocks"]]
            assert all(c.dtype == torch.bfloat16 for c in caches)
            rstate["blocks"][str(i)][name] = jnp.asarray(
                np.stack([c.float().numpy() for c in caches]),
                dtype=jnp.bfloat16)
    step = jax.jit(ref_tf.decode_step, static_argnames=("cfg",))
    tokens = batch["tokens"]
    for t in range(s):
        want, rstate = step(params, rstate, jnp.asarray(tokens[:, t:t + 1]),
                            jnp.int32(t), cfg)
        got, pstate = tf.decode_step(
            model, pstate, torch.from_numpy(tokens[:, t:t + 1].astype(
                np.int64)), t, pcfg)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=BF16_DECODE_TOL,
                                   atol=BF16_DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_forward_shapes_and_finite(arch):
    """The port's own initialisation (a seeded generator): forward shapes
    and finite values, as the reference's smoke test."""
    cfg = smoke(get_config(arch))
    model = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    logits = tf.forward(model, to_port(batch_np(cfg)), cfg)
    assert logits.shape == (B, S, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    # the same leaf names and shapes as the reference's tree
    ref_tree = pair(arch)[2]
    port = {n: tuple(p.shape) for n, p in model.named_parameters()}
    ref = {}
    for path, arr in convert._flatten(ref_tree).items():
        for pre in ("blocks.", "encoder.blocks."):
            if path.startswith(pre):
                n = arr.shape[0]
                for i in range(n):
                    ref[f"{pre}{i}.{path[len(pre):]}"] = tuple(arr.shape[1:])
                break
        else:
            ref[path] = tuple(arr.shape)
    assert port == ref


@pytest.mark.parametrize("kind,fan_in,scale", [
    ("fan_in", 256, 256 ** -0.5), ("normal", None, 0.02)])
def test_init_distributions_match_reference(kind, fan_in, scale):
    """``fan_in_init`` / ``normal_init``: a standard normal truncated to
    [-2, 2] times the scale.  The port's draw has the reference's std
    within 1 % (1M samples each; the truncated normal's std is 0.8796 of
    the scale), mean within 4 standard errors of 0, and no value past
    2 x scale."""
    shape = (1024, 1024)
    gen = torch.Generator().manual_seed(3)
    if kind == "fan_in":
        got = layers.fan_in_init(gen, shape, fan_in, torch.float32, "cpu")
        want = ref_layers.fan_in_init(jax.random.PRNGKey(3), shape, fan_in,
                                      jnp.float32)
    else:
        got = layers.normal_init(gen, shape, scale, torch.float32, "cpu")
        want = ref_layers.normal_init(jax.random.PRNGKey(3), shape, scale,
                                      jnp.float32)
    got = got.detach().double().numpy()
    want = np.asarray(want, dtype=np.float64)
    assert abs(got.std() / want.std() - 1.0) < 0.01
    assert abs(got.std() / (0.8796 * scale) - 1.0) < 0.01
    assert abs(got.mean()) < 4 * got.std() / np.sqrt(got.size)
    assert np.abs(got).max() <= 2.0 * scale * (1 + 1e-6)
    bf = layers.fan_in_init(gen, (64, 64), 64, torch.bfloat16, "cpu")
    assert bf.dtype == torch.bfloat16


def test_model_init_is_seeded_and_typed():
    """Two models from one seed are equal; weights take ``param_dtype``
    (or the override), norms, scalars and the router stay float32."""
    cfg = smoke(get_config("deepseek-v2-lite-16b"))
    a = tf.init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    b = tf.init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    bf = tf.init_params(torch.Generator().manual_seed(5), cfg, "cpu",
                        dtype=torch.bfloat16)
    for n, p in bf.named_parameters():
        f32 = n.endswith(("scale", "bias", "kv_norm", "router"))
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), n
    # a generator on another device than the model's is refused (a stub
    # stands in for a card's generator); on meta, where nothing is drawn,
    # the host's serves
    card_gen = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="generator"):
        tf.init_params(card_gen, cfg, "cpu")
    meta = tf.init_params(torch.Generator().manual_seed(5), cfg, "meta")
    assert all(p.is_meta for p in meta.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_model_matches_host_model(arch):
    """A model built on ``"meta"`` (the dry run's abstract parameters)
    has the host-built model's parameter names, shapes and dtypes, and
    allocates nothing."""
    cfg = smoke(get_config(arch))
    host = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    meta = tf.init_params(torch.Generator().manual_seed(0), cfg, "meta")
    want = {n: (tuple(p.shape), p.dtype) for n, p in host.named_parameters()}
    got = {n: (tuple(p.shape), p.dtype) for n, p in meta.named_parameters()}
    assert got == want
    assert all(p.device.type == "meta" for p in meta.parameters())


def test_converter_rejects_missing_extra_and_misshapen_leaves():
    _, _, tree, pcfg, _ = pair("qwen2-0.5b")

    def edited(fn):
        t = jax.tree.map(lambda a: a, tree)
        fn(t)
        return t

    missing = edited(lambda t: t["embeddings"].pop("embed"))
    with pytest.raises(ValueError, match="no leaf 'embeddings.embed'"):
        convert.lm_params_from_numpy(missing, pcfg, "cpu")
    extra = edited(lambda t: t["embeddings"].update(
        stray=np.zeros(3, np.float32)))
    with pytest.raises(ValueError, match="embeddings.stray"):
        convert.lm_params_from_numpy(extra, pcfg, "cpu")
    bad = edited(lambda t: t["final_norm"].update(
        scale=np.ones(7, np.float32)))
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params_from_numpy(bad, pcfg, "cpu")
    model = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    # the superblock axis is unstacked: block i holds row i
    np.testing.assert_array_equal(
        model.blocks[1]["0"].mix.w_q.detach().numpy(),
        tree["blocks"]["0"]["mix"]["w_q"][1])
