"""Port parity for the Monte-Carlo variation studies
(``repro_torch.core.imbue``: ``stacked_class_sums``,
``monte_carlo_accuracy``, ``clause_error_rate``), the KWS-6 and
sensor-anomaly generators of ``repro_torch.data.tm_datasets`` and KWS-6
training, against ``repro.core.imbue`` / ``repro.data.tm_datasets``.

* ``stacked_class_sums`` equals the reference exactly on numpy-drawn
  ``[R, C, L]`` resistance stacks read without noise.
* The ports of ``tests/test_parity.py:17,25,61`` and
  ``tests/test_imbue.py:58,67``, on numpy-drawn states and a noisy-XOR
  state the reference trains and the port receives.
* The draws differ between the packages (a ``torch.Generator`` against a
  jax key), so the Monte-Carlo distributions are compared by mean: under
  a CSA offset of 2.5 mV (accuracy spread over draws), the two means of
  32 draws agree within 4 standard errors of their difference.
* ``synthetic_kws6`` / ``synthetic_sensor_anomaly`` by property against
  the reference's on the same arguments (the two draw from different
  generators): shapes, dtypes, label rates, per-class mean spectra, the
  bursts.
* KWS-6 training: ``tm_train.fit`` of both packages on the same windows,
  test accuracies within 0.05.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import imbue as ref_imbue  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro.core import tm_train as ref_train  # noqa: E402
from repro.core import variations as ref_var  # noqa: E402
from repro.data import tm_datasets as ref_data  # noqa: E402
from repro_torch.convert import ta_from_numpy  # noqa: E402
from repro_torch.core import imbue, tm, tm_train  # noqa: E402
from repro_torch.core import variations as var  # noqa: E402
from repro_torch.core.booleanize import (StreamingBooleanizer,  # noqa: E402
                                         fit_quantile)
from repro_torch.data import tm_datasets  # noqa: E402

CFG = tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=37,
                  n_states=100)
REF_CFG = ref_tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=37,
                          n_states=100)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _model(seed, density=0.1, n=64):
    """A sparse TA state at CFG and ``n`` Boolean rows, numpy-drawn."""
    rng = np.random.default_rng(seed)
    inc = rng.random((CFG.n_clauses, CFG.n_literals)) < density
    ta = np.where(inc, CFG.n_states + 1, CFG.n_states).astype(np.int16)
    x = (rng.random((n, CFG.n_features)) < 0.4).astype(np.uint8)
    return ta, x


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------ stacked_class_sums

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stacked_class_sums_equal_reference_on_numpy_stacks(seed):
    """A numpy-drawn D2D-like ``[R, C, L]`` stack (LRS near 1.64 kΩ, HRS
    lognormal about 65.56 kΩ, both clipped to the published ranges; one
    clause empty), read without noise: the port's ``[R, B, M]`` sums equal
    the reference's exactly."""
    rng = np.random.default_rng(seed)
    r_n = 3
    inc = rng.random((CFG.n_clauses, CFG.n_literals)) < 0.04
    inc[2] = False
    lrs = np.clip(rng.normal(var.LRS_MEAN_OHM, 20.0, (r_n,) + inc.shape),
                  var.LRS_MIN_OHM, var.LRS_MAX_OHM)
    hrs = np.clip(var.HRS_MEAN_OHM * np.exp(0.27 * rng.normal(
        size=(r_n,) + inc.shape)), var.HRS_MIN_OHM, var.HRS_MAX_OHM)
    r = np.where(inc, lrs, hrs).astype(np.float32)
    x = (rng.random((16, CFG.n_features)) < 0.5).astype(np.uint8)
    got = imbue.stacked_class_sums(_t(r), _t(inc), _t(x), CFG,
                                   device="cpu")
    want = np.asarray(ref_imbue.stacked_class_sums(
        jnp.asarray(r), jnp.asarray(inc), jnp.asarray(x), REF_CFG))
    assert got.dtype == torch.int32 and got.shape == (r_n, 16, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).mean() > 0.2


# ---------------------------------- ports of tests/test_parity.py

def test_clause_error_rate_zero_at_zero_variation():
    ta, x = _model(3)
    err = imbue.clause_error_rate(_t(ta), _t(x), _gen(1), CFG,
                                  var.VariationConfig.nominal(), draws=4,
                                  device="cpu")
    assert err.dtype == torch.float32 and err.shape == (4,)
    np.testing.assert_array_equal(err.numpy(), 0.0)
    ref = ref_imbue.clause_error_rate(
        jnp.asarray(ta), jnp.asarray(x), jax.random.PRNGKey(1), REF_CFG,
        ref_var.VariationConfig.nominal(), draws=4)
    np.testing.assert_array_equal(np.asarray(ref), 0.0)


def test_clause_error_rate_monotone_in_c2c_sigma():
    """Mean clause error is non-decreasing in the C2C excursion: D2D and
    the CSA offset off, one generator seed for every sigma, so the same
    uniforms scale up (LRS keeps the published 5:1 ratio to HRS)."""
    ta, x = _model(4)
    means = []
    for f in (0.0, 0.05, 0.3, 0.75, 0.95):
        vcfg = var.VariationConfig(d2d=False, c2c=True, csa_offset=False,
                                   c2c_hrs_frac=f, c2c_lrs_frac=f / 5.0)
        err = imbue.clause_error_rate(_t(ta), _t(x), _gen(2), CFG, vcfg,
                                      draws=4, device="cpu")
        means.append(float(err.mean()))
    assert means[0] == 0.0
    for lo, hi in zip(means, means[1:]):
        assert hi >= lo - 1e-9, means
    assert means[-1] > 0.0, means


def test_monte_carlo_accuracy_nominal_equals_digital():
    """Zero-variation draws all reproduce the digital accuracy exactly."""
    ta, x = _model(5)
    y = tm.predict(_t(ta), _t(x), CFG)
    accs = imbue.monte_carlo_accuracy(_t(ta), _t(x), y, _gen(3), CFG,
                                      var.VariationConfig.nominal(),
                                      draws=4, device="cpu")
    assert accs.dtype == torch.float32 and accs.shape == (4,)
    np.testing.assert_array_equal(accs.numpy(), 1.0)
    assert len(set(y.tolist())) > 1


# ---------------------------------- ports of tests/test_imbue.py

@pytest.fixture(scope="module")
def trained():
    """The reference's noisy-XOR fixture (2 x 12 clauses, 12 features, 50
    epochs of batch 1500, 3000 train and 500 test rows) on a numpy-drawn
    noisy XOR (40 % of the training labels flipped), trained by the
    reference; its TA state and test set, carried to the port."""
    cfg = ref_tm.TMConfig(n_classes=2, clauses_per_class=12, n_features=12,
                          n_states=100)
    rng = np.random.default_rng(0)
    x = (rng.random((3500, 12)) < 0.5).astype(np.uint8)
    y = (x[:, 0] ^ x[:, 1]).astype(np.int32)
    flip = rng.random(3000) < 0.4
    xtr, ytr = x[:3000], np.where(flip, 1 - y[:3000], y[:3000])
    xte, yte = x[3000:], y[3000:]
    ta = ref_tm.init_ta_state(jax.random.PRNGKey(1), cfg)
    ta = ref_train.fit(ta, jax.random.PRNGKey(2), jnp.asarray(xtr),
                       jnp.asarray(ytr), cfg, epochs=50, batch_size=1500)
    pcfg = tm.TMConfig(n_classes=2, clauses_per_class=12, n_features=12,
                       n_states=100)
    return dict(cfg=pcfg, ref_cfg=cfg, ta_np=np.asarray(ta),
                ta=ta_from_numpy(np.asarray(ta), pcfg, device="cpu"),
                x=np.asarray(xte), y=np.asarray(yte).astype(np.int64))


def test_variation_tolerance(trained):
    """D2D / C2C / CSA variations stay within the sensing margin: the mean
    accuracy over draws is within 0.02 of the digital accuracy."""
    cfg, ta = trained["cfg"], trained["ta"]
    x, y = _t(trained["x"]), _t(trained["y"])
    accs = imbue.monte_carlo_accuracy(ta, x, y, _gen(7), cfg,
                                      var.VariationConfig(), draws=8,
                                      device="cpu")
    base = float(tm.accuracy(ta, x, y, cfg))
    assert float(accs.mean()) >= base - 0.02


def test_clause_error_rate_small_under_variation(trained):
    err = imbue.clause_error_rate(trained["ta"], _t(trained["x"][:128]),
                                  _gen(8), trained["cfg"],
                                  var.VariationConfig(), draws=4,
                                  device="cpu")
    assert float(err.max()) <= 0.01


def test_monte_carlo_distribution_matches_reference_by_mean(trained):
    """With a CSA offset of 2.5 mV (about 3x the sensing margin's half
    width, so reads fail and accuracy spreads over draws), 32 draws of
    each package: the mean accuracies, and the mean clause error rates,
    agree within 4 standard errors of their difference."""
    sig = 2.5e-3
    cfg, rcfg = trained["cfg"], trained["ref_cfg"]
    x, y = trained["x"], trained["y"]
    pairs = {
        "accuracy": (
            imbue.monte_carlo_accuracy(
                trained["ta"], _t(x), _t(y), _gen(7), cfg,
                var.VariationConfig(csa_sigma_v=sig), draws=32,
                device="cpu").numpy(),
            np.asarray(ref_imbue.monte_carlo_accuracy(
                jnp.asarray(trained["ta_np"]), jnp.asarray(x),
                jnp.asarray(y.astype(np.int32)), jax.random.PRNGKey(7),
                rcfg, ref_var.VariationConfig(csa_sigma_v=sig), draws=32))),
        "clause_error": (
            imbue.clause_error_rate(
                trained["ta"], _t(x[:128]), _gen(8), cfg,
                var.VariationConfig(csa_sigma_v=sig), draws=32,
                device="cpu").numpy(),
            np.asarray(ref_imbue.clause_error_rate(
                jnp.asarray(trained["ta_np"]), jnp.asarray(x[:128]),
                jax.random.PRNGKey(8), rcfg,
                ref_var.VariationConfig(csa_sigma_v=sig), draws=32)))}
    for name, (got, want) in pairs.items():
        assert got.shape == want.shape == (32,)
        assert got.std() > 0 and want.std() > 0, name      # it spreads
        se = np.sqrt(got.var(ddof=1) / 32 + want.var(ddof=1) / 32)
        assert abs(got.mean() - want.mean()) <= 4 * se, (
            name, got.mean(), want.mean(), se)


# ------------------------------------------- datasets by property

def test_synthetic_kws6_matches_reference_by_property():
    """Same arguments: shapes and dtypes (labels int64 in the port, int32
    in the reference), every class drawn at about 1/6, and per-class mean
    spectra (averaged over frames) within 0.1 of the reference's."""
    n, t, m = 600, 32, 12
    x, y = tm_datasets.synthetic_kws6(_gen(0), n, t, m, device="cpu")
    rx, ry = ref_data.synthetic_kws6(jax.random.PRNGKey(0), n, t, m)
    rx, ry = np.asarray(rx), np.asarray(ry)
    assert x.shape == rx.shape == (n, t, m)
    assert x.dtype == torch.float32 and rx.dtype == np.float32
    assert y.dtype == torch.int64 and ry.dtype == np.int32
    x, y = x.numpy(), y.numpy()
    for labels in (y, ry):
        rates = np.bincount(labels, minlength=6) / n
        assert labels.min() >= 0 and labels.max() < 6
        assert np.all(np.abs(rates - 1 / 6) < 0.05), rates
    for c in range(6):
        got, want = x[y == c].mean(axis=(0, 1)), rx[ry == c].mean(axis=(0, 1))
        np.testing.assert_allclose(got, want, atol=0.1, err_msg=str(c))
    assert abs(x.std() - rx.std()) < 0.05 * rx.std()


def test_synthetic_sensor_anomaly_matches_reference_by_property():
    """Same arguments: shapes and dtypes, the anomalous share of streams
    within 0.05 of ``anomaly_rate`` (both packages), each anomalous stream
    one contiguous burst of ``burst_frames``, and the mean frame in and
    out of bursts within 0.05 of the reference's."""
    n, t, s, burst = 1000, 48, 8, 12
    x, lab = tm_datasets.synthetic_sensor_anomaly(
        _gen(1), n, t, s, anomaly_rate=0.3, burst_frames=burst,
        device="cpu")
    rx, rlab = ref_data.synthetic_sensor_anomaly(
        jax.random.PRNGKey(1), n, t, s, anomaly_rate=0.3,
        burst_frames=burst)
    rx, rlab = np.asarray(rx), np.asarray(rlab)
    assert x.shape == rx.shape == (n, t, s) and x.dtype == torch.float32
    assert lab.shape == rlab.shape == (n, t) and lab.dtype == torch.int64
    x, lab = x.numpy(), lab.numpy()
    for frames, labels in ((x, lab), (rx, rlab)):
        per_stream = labels.sum(axis=1)
        assert set(np.unique(per_stream)) <= {0, burst}
        assert abs((per_stream > 0).mean() - 0.3) < 0.05
        for row in labels[per_stream > 0][:50]:
            on = np.flatnonzero(row)
            assert on[-1] - on[0] == burst - 1          # contiguous
    for on in (0, 1):
        np.testing.assert_allclose(x[lab == on].mean(), rx[rlab == on].mean(),
                                   atol=0.05, err_msg=str(on))
    with pytest.raises(ValueError, match="burst_frames"):
        tm_datasets.synthetic_sensor_anomaly(_gen(0), 2, 8, 2,
                                             burst_frames=9, device="cpu")


def test_paper_table_iv_is_the_reference_table():
    assert list(tm_datasets.PAPER_TABLE_IV) == list(ref_data.PAPER_TABLE_IV)
    for name, row in tm_datasets.PAPER_TABLE_IV.items():
        ref = ref_data.PAPER_TABLE_IV[name]
        assert dataclasses.asdict(row) == dataclasses.asdict(ref)
        assert (row.features, row.include_pct) == (ref.features,
                                                   ref.include_pct)


# ------------------------------------------------------ KWS-6 training

def test_kws6_training_matches_reference_accuracy():
    """Both packages train a 6 x 20-clause TM for 6 epochs (batches of 64)
    on the same windows (the port's generator, numpy windowing); their
    test accuracies are within 0.05 of each other, and above chance."""
    mels, bits, window, hop = 6, 2, 4, 2
    g = _gen(1)
    xtr, ytr = tm_datasets.synthetic_kws6(g, 120, 24, mels, device="cpu")
    xte, yte = tm_datasets.synthetic_kws6(g, 60, 24, mels, device="cpu")
    sb = StreamingBooleanizer(fit_quantile(xtr.reshape(-1, mels).numpy(),
                                           bits, device="cpu"), window, hop)
    rtr, wtr = tm_datasets.kws6_windows(xtr, ytr, sb)
    rte, wte = tm_datasets.kws6_windows(xte, yte, sb)
    kw = dict(n_classes=6, clauses_per_class=20,
              n_features=window * mels * bits, n_states=100, threshold=15,
              specificity=5.0)
    cfg, rcfg = tm.TMConfig(**kw), ref_tm.TMConfig(**kw)
    ta = tm.init_ta_state(_gen(1), cfg, "cpu")
    ta = tm_train.fit(ta, _gen(11), rtr, wtr, cfg, epochs=6, batch_size=64,
                      parallel=True)
    acc = float(tm.accuracy(ta, _t(rte), _t(wte), cfg))
    rta = ref_tm.init_ta_state(jax.random.PRNGKey(1), rcfg)
    rta = ref_train.fit(rta, jax.random.PRNGKey(11), jnp.asarray(rtr),
                        jnp.asarray(wtr.astype(np.int32)), rcfg, epochs=6,
                        batch_size=64, parallel=True)
    ref_acc = float(ref_tm.accuracy(rta, jnp.asarray(rte),
                                    jnp.asarray(wte.astype(np.int32)), rcfg))
    assert abs(acc - ref_acc) <= 0.05, (acc, ref_acc)
    assert min(acc, ref_acc) > 0.5
