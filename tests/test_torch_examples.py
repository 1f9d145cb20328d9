"""The port's examples (``examples/torch_*.py``) run end to end on the
CPU, each through its ``main`` with ``--device cpu``, and are held to the
JAX reference on the same numpy rows.

Two kinds of check:

* What follows training is held on the example's own trained TA state,
  carried to the reference: the reference's ``tm.accuracy`` of that state
  equals the example's digital accuracy exactly, and the reference's
  reads of it (programmed under the same ``VariationConfig`` from its own
  draws) agree with the example's analog reads within the tolerance
  stated at each check; the image flow's modeled energies equal the
  reference's energy model on the same include count (rtol 1e-6).
* Training, at the cut depth, against the reference's ``fit`` /
  ``OnlineTrainer`` on the same rows.  The packages draw differently (a
  ``torch.Generator`` against threefry), so one port run is held within
  4 standard deviations (and at least 0.05) of the mean over three
  reference seeds (``_near_reference``), and the reference's mean must
  clear chance by ``LEARNS`` so that a port that does not learn fails.
  The image flow at its cut depth (3 steps of 100 rows) is still at
  chance in both packages, so its training is held by the include share
  instead: it falls from the initial ~50 % to ~3 %.

The examples keep the reference's training recipes in module constants;
the sequential ones (the XOR quickstarts) are a host loop of eager steps
in the port, so the tests cut those constants (depth, not shapes: the
models, batchers and pools are the examples' own) to where the reference
leaves chance.
"""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro import serve as ref_serve  # noqa: E402
from repro.core import booleanize as ref_bool  # noqa: E402
from repro.core import energy as ref_energy  # noqa: E402
from repro.core import imbue as ref_imbue  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro.core import tm_train as ref_train  # noqa: E402
from repro.core.mapping import csa_count_packed  # noqa: E402
from repro.core.variations import VariationConfig  # noqa: E402
from repro.data import tm_datasets as ref_data  # noqa: E402
from repro.train import OnlineTrainer, OnlineTrainerConfig  # noqa: E402
from repro_torch import api  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SEEDS = 3           # reference seeds a training comparison draws
LEARNS = 0.1        # the reference's mean accuracy clears chance by this


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these runs are no faster on more, and the
    suite runs several workers side by side, whose thread pools would
    oversubscribe the cores and stretch a seconds-long smoke to
    minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _tuning_restored():
    snap = api.tuning_snapshot()
    yield
    api.restore_tuning(snap)


def _j(a, dtype=None):
    return jnp.asarray(np.asarray(a), dtype)


def _ref_fit_accuracies(kw, xtr, ytr, xev, yev, **fit):
    """The reference's ``tm_train.fit`` from ``SEEDS`` key pairs on the
    same rows; the accuracy of each on ``(xev, yev)``."""
    cfg = ref_tm.TMConfig(**kw)
    accs = []
    for s in range(SEEDS):
        ta = ref_train.fit(
            ref_tm.init_ta_state(jax.random.PRNGKey(1 + 10 * s), cfg),
            jax.random.PRNGKey(2 + 10 * s), _j(xtr), _j(ytr, jnp.int32),
            cfg, **fit)
        accs.append(float(ref_tm.accuracy(ta, _j(xev), _j(yev, jnp.int32),
                                          cfg)))
    return np.array(accs)


def _near_reference(got, ref, chance):
    tol = max(4 * float(ref.std()), 0.05)
    assert float(ref.mean()) > chance + LEARNS, ref        # it learns
    assert abs(got - float(ref.mean())) <= tol, (got, ref, tol)


def _digital_equal(out, kw, x, y):
    """The reference's accuracy of the example's own TA state equals the
    example's digital accuracy."""
    cfg = ref_tm.TMConfig(**kw)
    ta = _j(out["ta_state"].numpy())
    assert float(ref_tm.accuracy(ta, _j(x), _j(y, jnp.int32), cfg)) == \
        pytest.approx(out["digital_accuracy"], abs=1e-7)
    return ta, cfg


XOR = dict(n_classes=2, clauses_per_class=12, n_features=12, n_states=100)
XOR_T = dict(XOR, threshold=15, specificity=3.9)


def test_quickstart_reads_through_the_eager_analog_backend():
    """Training (2000 rows, 4 sequential epochs: the reference's test
    accuracy over six seeds was 0.76 +- 0.04) within 4 sd of the
    reference's; the one noisy read and the Monte-Carlo mean within 0.02
    of the reference's reads of the same state under
    ``VariationConfig()`` (its clause error is at most 1 %, so nearly
    every read is the digital answer)."""
    mod = _load("torch_quickstart")
    mod.N_TRAIN, mod.EPOCHS, mod.MC_DRAWS = 2000, 4, 2
    mod.N_TEST = 200
    out = mod.main(["--device", "cpu"])
    # A noisy read with a CSA offset: only analog-torch models it.
    assert out["backend"] == "analog-torch"
    xtr, ytr, xte, yte = out["data"]
    ta, cfg = _digital_equal(out, XOR_T, xte, yte)
    _near_reference(out["digital_accuracy"], _ref_fit_accuracies(
        XOR_T, xtr, ytr, xte, yte, epochs=mod.EPOCHS, batch_size=2000),
        chance=0.5)
    state = ref_api.CrossbarState.program(
        ref_tm.include_mask(ta, cfg), jax.random.PRNGKey(3), cfg,
        VariationConfig())
    pred = np.asarray(ref_api.predict(state, _j(xte), jax.random.PRNGKey(4)))
    assert out["analog_accuracy"] == pytest.approx(
        float((pred == yte).mean()), abs=0.02)
    mc = np.asarray(ref_imbue.monte_carlo_accuracy(
        ta, _j(xte), _j(yte, jnp.int32), jax.random.PRNGKey(4), cfg,
        VariationConfig(), draws=mod.MC_DRAWS))
    assert len(out["mc_accuracy"]) == mod.MC_DRAWS
    assert np.mean(out["mc_accuracy"]) == pytest.approx(mc.mean(), abs=0.02)


_SERVE_REF = {}


@pytest.mark.parametrize("packed", [[], ["--no-packed"]],
                         ids=["packed", "no-packed"])
def test_serve_quickstart_falls_back_loudly(packed):
    """The CSA-offset pool falls back loudly to ``analog-torch``; the
    training (2000 rows, 3 sequential epochs: reference 0.65 +- 0.06
    over six seeds) is within 4 sd of the reference's; the ensemble's
    answers to the 64 requests agree with the reference engine's
    (``analog-jnp``, four chips of its own draws, the same batcher) on
    the same TA state on at least 95 % of requests, and their accuracies
    within 0.05."""
    mod = _load("torch_serve_quickstart")
    mod.N_TRAIN, mod.EPOCHS = 2000, 3
    with pytest.warns(UserWarning, match="serve backend fallback"):
        s = mod.main(["--device", "cpu", *packed])
    assert s["backend"] == "analog-torch"
    assert s["requests"] == mod.N_REQUESTS
    assert s["fallback_dispatches"] == s["batches"] > 0
    xtr, ytr, xte, yte = s["data"]
    ta, cfg = _digital_equal(s, XOR, xte, yte)
    if "fit" not in _SERVE_REF:    # the same rows and depth for both ids
        _SERVE_REF["fit"] = _ref_fit_accuracies(
            XOR, xtr, ytr, xte, yte, epochs=mod.EPOCHS, batch_size=1500)
    _near_reference(s["digital_accuracy"], _SERVE_REF["fit"], chance=0.5)
    eng = ref_serve.ServeEngine.from_ta_state(
        ta, cfg, n_replicas=4, key=jax.random.PRNGKey(3),
        vcfg=VariationConfig(),
        ecfg=ref_serve.EngineConfig(
            routing="ensemble", packed=not packed,
            batcher=ref_serve.BatcherConfig(max_batch=32,
                                            bucket_sizes=(8, 16, 32))))
    xs = xte.astype(np.uint8)[:mod.N_REQUESTS]
    eng.submit_many(list(xs))
    ref_preds = np.array([r.pred for r in eng.drain()])
    assert np.mean(s["preds"] == ref_preds) >= 0.95
    assert s["analog_accuracy"] == pytest.approx(
        float(np.mean(ref_preds == yte[:mod.N_REQUESTS])), abs=0.05)


def test_stream_quickstart_serves_both_sessions():
    """At the example's own depth (120 utterances, 6 epochs): the port's
    booleanizer and windowing give the reference's window rows bit for
    bit; the training within 4 sd of the reference's (0.68 +- 0.03 over
    six seeds; chance 1/6); each session's per-window decisions (D2D +
    C2C reads) agree with the reference's digital TM on the same state and
    the same windows on at least 90 % of windows, and each session's
    keyword is the vote of its last ``VOTE`` decisions."""
    mod = _load("torch_stream_quickstart")
    out = mod.main(["--device", "cpu"])
    assert out["summary"]["forward_fallbacks"] == []
    xtr, ytr = out["frames"]
    rows, labels = out["windows"]
    windower = ref_bool.StreamingBooleanizer(
        ref_bool.fit_quantile(xtr.reshape(-1, mod.MELS), bits=mod.BITS),
        mod.WINDOW, mod.HOP)
    ref_rows, ref_labels = ref_data.kws6_windows(xtr, ytr, windower)
    np.testing.assert_array_equal(rows, ref_rows)
    np.testing.assert_array_equal(labels, ref_labels)
    kw = dict(n_classes=6, clauses_per_class=10,
              n_features=rows.shape[1], n_states=100, threshold=15,
              specificity=5.0)
    ta, cfg = _digital_equal(
        {**out, "digital_accuracy": out["digital_window_accuracy"]},
        kw, rows, labels)
    _near_reference(out["digital_window_accuracy"], _ref_fit_accuracies(
        kw, rows, labels, rows, labels, epochs=mod.EPOCHS, batch_size=200,
        parallel=True), chance=1 / 6)
    assert set(out["heard"]) == set(out["streams"]) == {"alice", "bob"}
    for sid, frames in out["streams"].items():
        windower.reset()
        ref_pred = np.asarray(ref_tm.predict(
            ta, _j(windower.transform_offline(frames)), cfg))
        got = np.array(out["window_preds"][sid])
        assert got.shape == ref_pred.shape and len(got) >= mod.VOTE
        assert np.mean(got == ref_pred) >= 0.9, (sid, got, ref_pred)
        assert out["heard"][sid] == int(np.argmax(np.bincount(
            got[-mod.VOTE:], minlength=cfg.n_classes)))


def test_swap_quickstart_settles_the_canary():
    """At the example's own depth: v1 and v2's training accuracies and
    v2's test accuracy within 4 sd of the reference ``OnlineTrainer``'s
    on the same rows (over six seeds: v1 0.66 +- 0.02, v2 0.57 +- 0.01
    on labels 40 % flipped, v2 test 0.73 +- 0.06); the verdict is the
    one the canary's agreement and the 0.5 bar give, the pool version
    and audit trail follow it, and the D2D-only reads after the swap
    score what the serving model's digital TM scores on those rows."""
    mod = _load("torch_swap_quickstart")
    out = mod.main(["--device", "cpu"])
    xtr, ytr, xte, yte = out["data"]
    v1, v2 = out["versions"]
    cfg = ref_tm.TMConfig(**XOR_T)
    ref = []
    for s in range(SEEDS):
        tr = OnlineTrainer(cfg, jax.random.PRNGKey(1 + 10 * s),
                           cfg=OnlineTrainerConfig(epochs=mod.EPOCHS,
                                                   batch_size=500))
        tr.ingest(xtr[:150], ytr[:150])
        r1 = tr.refit()
        tr.ingest(xtr, ytr)
        r2 = tr.refit()
        ref.append((r1.accuracy, r2.accuracy, float(ref_tm.accuracy(
            r2.ta_state, _j(xte), _j(yte, jnp.int32), cfg))))
    ref = np.array(ref)
    v2_test = float(ref_tm.accuracy(_j(v2.ta_state.numpy()), _j(xte),
                                    _j(yte, jnp.int32), cfg))
    for got, col in ((v1.accuracy, 0), (v2.accuracy, 1), (v2_test, 2)):
        tol = max(4 * float(ref[:, col].std()), 0.05)
        assert abs(got - float(ref[:, col].mean())) <= tol, (col, got, ref)
    assert float(ref[:, 2].mean()) > 0.5 + LEARNS, ref
    want = "promote" if out["agreement"] >= 0.5 else "rollback"
    assert out["decision"] == want
    assert out["version"] == (1 if want == "promote" else 0)
    assert [e["kind"] for e in out["swaps"]] == [want]
    serving = v2 if want == "promote" else v1
    idx = np.random.default_rng(0).integers(0, len(xte), 200)
    digital = float(ref_tm.accuracy(_j(serving.ta_state.numpy()),
                                    _j(xte[idx]), _j(yte[idx], jnp.int32),
                                    cfg))
    assert out["accuracy"] == pytest.approx(digital, abs=0.02)


def test_image_imbue_quick_reads_on_the_dense_kernel_tier():
    """The dense kernel tier serves the D2D-only read; its accuracy within
    0.02 of the reference's read (``analog-jnp``, no read key) of the
    same state programmed from its own draws; the modeled energies equal
    the reference's model on the same include count and literal
    activity; training moves the include share as the reference's does
    (within 4 sd of its mean: 2.7 +- 0.1 % over three seeds, from ~50 %
    at init)."""
    mod = _load("torch_image_imbue")
    mod.N_TRAIN, mod.N_TEST = 100, 100
    out = mod.main(["--quick", "--device", "cpu"])
    # No read generator: D2D only, which the fused tier serves.
    assert out["backend"] == "analog-cuda" and not out["fell_back"]
    xtr, ytr, xte, yte = out["data"]
    kw = dict(n_classes=10, clauses_per_class=20, n_features=784,
              n_states=127, threshold=15, specificity=5.0)
    ta, cfg = _digital_equal(out, kw, xte, yte)
    rows = mod.KERNEL_ROWS
    state = ref_api.CrossbarState.program(
        ref_tm.include_mask(ta, cfg), jax.random.PRNGKey(3), cfg,
        VariationConfig())
    pred = np.asarray(ref_api.predict(state, _j(xte[:rows]),
                                      backend="analog-jnp"))
    assert out["kernel_accuracy"] == pytest.approx(
        float((pred == yte[:rows]).mean()), abs=0.02)
    stats = ref_tm.include_stats(ta, cfg)
    p_lit0 = float((1 - ref_tm.literals(_j(xte))).mean())
    assert out["p_lit0"] == pytest.approx(p_lit0, rel=1e-6)
    csas = csa_count_packed(cfg.n_ta)
    want = {
        "conservative": ref_energy.imbue_energy_per_datapoint(
            stats["includes"], cfg.n_ta, csas).total_nj,
        "measured": ref_energy.imbue_energy_per_datapoint(
            stats["includes"], cfg.n_ta, csas, p_lit0_include=p_lit0,
            p_lit0_exclude=p_lit0).total_nj,
        "cmos": ref_energy.cmos_tm_energy(cfg.n_ta) * 1e9}
    for k, v in want.items():
        assert out["energy_nj"][k] == pytest.approx(v, rel=1e-6), k
    shares = []
    for s in range(SEEDS):
        rta = ref_train.fit(
            ref_tm.init_ta_state(jax.random.PRNGKey(1 + 10 * s), cfg),
            jax.random.PRNGKey(2 + 10 * s), _j(xtr), _j(ytr, jnp.int32),
            cfg, epochs=3, batch_size=200, parallel=True)   # --quick
        shares.append(ref_tm.include_stats(rta, cfg)["include_pct"])
    shares = np.array(shares)
    assert shares.mean() < 25, shares         # the reference's moved
    assert abs(stats["include_pct"] - shares.mean()) <= max(
        4 * shares.std(), 0.05), (stats["include_pct"], shares)


def test_lm_train_example_trains_from_the_reference_loss(capsys):
    """``examples/torch_lm_train.py`` at a few steps (qwen2-0.5b, the
    trainer's reduced config): it checkpoints into a temporary directory
    it removes, logs every step, and its first loss equals the
    reference's ``loss_fn`` on the same initial parameters (carried over
    through ``convert.lm_tree_to_numpy``) and the same ``synth_batch``
    rows, within rtol 1e-5 (float32)."""
    from repro.configs import get_config as ref_get_config
    from repro.configs import smoke as ref_smoke
    from repro.data import pipeline as ref_pipeline
    from repro.models import transformer as ref_tf
    from repro_torch import convert
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as tf

    ex = _load("torch_lm_train")
    argv = ["--device", "cpu", "--arch", "qwen2-0.5b", "--steps", "4",
            "--batch", "2", "--seq", "32", "--log-every", "1"]
    run = ex.main(argv)
    out = capsys.readouterr().out
    assert "resumed" not in out and "step     3" in out
    assert sorted(run.losses) == [0, 1, 2, 3]
    assert all(np.isfinite(v) for v in run.losses.values())
    cfg = train_cli._config(train_cli._parser().parse_args(argv))
    start = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    rcfg = ref_smoke(ref_get_config("qwen2-0.5b"), d_model=256, n_super=2,
                     vocab=2048)
    batch = ref_pipeline.synth_batch(rcfg, ref_pipeline.DataConfig(), 0, 2,
                                     32)
    want, _ = jax.jit(lambda p, b: ref_tf.loss_fn(p, b, rcfg))(
        jax.tree.map(jnp.asarray, convert.lm_tree_to_numpy(start)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert run.losses[0] == pytest.approx(float(want), rel=1e-5)
