"""Port parity: the digital TM (``repro_torch.core.tm``) and the digital
backend against ``repro.core.tm`` on numpy-seeded inputs, exactly."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.configs import imbue_tm as ref_zoo  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs import imbue_tm as zoo  # noqa: E402
from repro_torch.convert import ta_from_numpy  # noqa: E402
from repro_torch.core import tm  # noqa: E402

SHAPES = [(4, 8, 37), (3, 6, 16), (2, 12, 12)]


def _cfgs(m, j, f):
    return (tm.TMConfig(n_classes=m, clauses_per_class=j, n_features=f,
                        n_states=100),
            ref_tm.TMConfig(n_classes=m, clauses_per_class=j, n_features=f,
                            n_states=100))


def _ta_and_x(cfg, seed, b=24):
    """TA states with ~4% includes (a few per clause, so clauses fire),
    two forced-empty clauses, and Boolean features."""
    rng = np.random.default_rng(seed)
    inc = rng.random((cfg.n_clauses, cfg.n_literals)) < 0.04
    inc[1] = False
    inc[-2] = False
    ta = np.where(inc, cfg.n_states + 1 + rng.integers(0, 50, inc.shape),
                  rng.integers(1, cfg.n_states + 1, inc.shape))
    x = (rng.random((b, cfg.n_features)) < 0.5).astype(np.uint8)
    return ta.astype(np.int16), x


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", (0, 1))
def test_forward_and_predict_match_reference(shape, seed):
    cfg, ref_cfg = _cfgs(*shape)
    ta, x = _ta_and_x(cfg, seed)
    t_ta = ta_from_numpy(ta, cfg, device="cpu")
    got = tm.forward(t_ta, torch.from_numpy(x), cfg)
    want = np.asarray(ref_tm.forward(jnp.asarray(ta), jnp.asarray(x),
                                     ref_cfg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).sum() > 0          # not parity of zeros
    np.testing.assert_array_equal(
        tm.predict(t_ta, torch.from_numpy(x), cfg).numpy(),
        np.asarray(ref_tm.predict(jnp.asarray(ta), jnp.asarray(x), ref_cfg)))


@pytest.mark.parametrize("training", (False, True))
def test_clause_outputs_empty_clause_semantics(training):
    cfg, ref_cfg = _cfgs(4, 8, 37)
    ta, x = _ta_and_x(cfg, seed=3)
    lits = tm.literals(torch.from_numpy(x))
    got = tm.clause_outputs(torch.from_numpy(ta), lits, cfg,
                            training=training).numpy()
    want = np.asarray(ref_tm.clause_outputs(
        jnp.asarray(ta), ref_tm.literals(jnp.asarray(x)), ref_cfg,
        training=training))
    np.testing.assert_array_equal(got, want)
    assert (got[:, 1] == (1 if training else 0)).all()


def test_digital_backend_matches_reference_backend():
    cfg, ref_cfg = _cfgs(4, 8, 37)
    ta, x = _ta_and_x(cfg, seed=4)
    state = api.DigitalState.from_ta(torch.from_numpy(ta), cfg)
    ref_state = ref_api.DigitalState.from_ta(jnp.asarray(ta), ref_cfg)
    lits = tm.literals(torch.from_numpy(x))
    # The fused backend outranks the eager reference, as digital-pallas
    # outranks digital-jnp.
    sel = api.select_backend(state)
    assert sel.backend.name == "digital-cuda" and not sel.fell_back
    want = np.asarray(ref_api.get_backend("digital-jnp").fn(
        ref_state, ref_tm.literals(jnp.asarray(x))))
    np.testing.assert_array_equal(api.class_sums(state, lits).numpy(), want)
    np.testing.assert_array_equal(
        api.class_sums(state, lits, backend="digital-torch").numpy(), want)


def test_polarity_literals_and_config_match_reference():
    cfg, ref_cfg = _cfgs(3, 6, 16)
    np.testing.assert_array_equal(tm.polarity(cfg).numpy(),
                                  np.asarray(ref_tm.polarity(ref_cfg)))
    x = (np.random.default_rng(5).random((7, 16)) < 0.5).astype(np.uint8)
    np.testing.assert_array_equal(
        tm.literals(torch.from_numpy(x)).numpy(),
        np.asarray(ref_tm.literals(jnp.asarray(x))))
    assert (cfg.n_literals, cfg.n_clauses, cfg.n_ta) == (
        ref_cfg.n_literals, ref_cfg.n_clauses, ref_cfg.n_ta)
    with pytest.raises(ValueError):
        tm.TMConfig(n_classes=2, clauses_per_class=3, n_features=4)
    with pytest.raises(ValueError):
        tm.TMConfig(n_classes=2, clauses_per_class=2, n_features=4,
                    n_states=0)


@pytest.mark.parametrize("name", sorted(ref_zoo.TM_ZOO))
def test_model_zoo_matches_reference(name):
    got = dataclasses.asdict(zoo.tm_config(name))
    want = dataclasses.asdict(ref_zoo.tm_config(name))
    got.pop("state_dtype")
    want.pop("state_dtype")
    assert got == want
    assert zoo.tm_config(name).state_dtype == torch.int16
