"""Shared fixtures for the tier-1 suite.

Provides a tiny TMConfig + random (training-free) TA state so serving,
kernel and parity tests don't each pay a training loop, plus seeded PRNG
keys.  Registers the ``slow`` marker so long e2e / Monte-Carlo tests can
be deselected with ``-m "not slow"``.
"""

import jax
import pytest

from repro.core.tm import TMConfig


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running e2e / Monte-Carlo tests "
                   "(deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one "
                   "(run on the card with -m cuda)")


@pytest.fixture(scope="session")
def small_cfg() -> TMConfig:
    """A TM small enough that interpret-mode Pallas calls stay fast."""
    return TMConfig(n_classes=4, clauses_per_class=8, n_features=32,
                    n_states=100)


@pytest.fixture(scope="session")
def keys():
    """Deterministic named PRNG keys shared across tests."""
    names = ("init", "data", "program", "read", "route")
    ks = jax.random.split(jax.random.PRNGKey(2026), len(names))
    return dict(zip(names, ks))


@pytest.fixture(scope="session")
def random_ta(small_cfg, keys):
    """Training-free TA state with a realistic include density (~10%).

    Random boundary init gives ~50% includes, which leaves no clause
    sensing headroom; instead draw states so roughly 10% of TAs land in
    the include half — matching the sparse trained models of Table IV.
    """
    cfg = small_cfg
    inc = jax.random.bernoulli(keys["init"], 0.1,
                               (cfg.n_clauses, cfg.n_literals))
    state = jax.numpy.where(inc, cfg.n_states + 1, cfg.n_states)
    return state.astype(cfg.state_dtype)


@pytest.fixture(scope="session")
def boolean_batch(small_cfg, keys):
    """[64, F] random Boolean features for inference tests."""
    return jax.random.bernoulli(
        keys["data"], 0.4, (64, small_cfg.n_features)).astype("uint8")
