"""Port parity for TM training (``repro_torch.core.tm_train``, the training
half of ``repro_torch.core.coalesced``, ``repro_torch.data.tm_datasets``
and ``repro_torch.train.online``) against the JAX reference.

The port cannot reproduce threefry, so exactness goes through the split
of each update into its draws and their use:

* the apply halves (``tm_train._ta_delta_apply``,
  ``coalesced._example_update_apply``) take the reference's own draws —
  built with the same ``jax.random.split`` calls as the reference's
  ``_ta_delta`` / ``_example_update`` and ``train_step_batch`` — and must
  give the reference's int8 deltas and clipped states bit for bit;
* inside the port, ``train_step == train_step_batch`` at B = 1 and the
  batch step does not depend on its chunk size, exactly;
* what the port's generators draw is held by distribution, and training
  by accuracy bars (noisy XOR: the reference's own 0.97 / 0.95) and by
  the reference's accuracy on the same numpy dataset (within 3 points).

Tolerance 0 for every integer result.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import coalesced as ref_co  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro.core import tm_train as ref_tt  # noqa: E402
from repro_torch.core import coalesced as co  # noqa: E402
from repro_torch.core import tm, tm_train  # noqa: E402
from repro_torch.core.tm_train import FeedbackDraws  # noqa: E402
from repro_torch.data import tm_datasets  # noqa: E402
from repro_torch.kernels import clause_eval, ops  # noqa: E402
from repro_torch.train.online import (OnlineTrainer,  # noqa: E402
                                      OnlineTrainerConfig, TrainedVersion)

CPU = "cpu"
# (M, J, F, N, T, s): small digital configs, ragged L, odd thresholds.
DIGITAL = [(3, 6, 20, 20, 7, 3.3), (2, 4, 13, 16, 15, 3.9),
           (4, 2, 37, 100, 5, 10.0)]
# (M, C, F, N, T, s, max_weight): small coalesced configs.
COALESCED = [(3, 14, 20, 20, 7, 3.3, 3), (2, 9, 13, 16, 15, 3.9, 127),
             (4, 33, 37, 100, 5, 10.0, 5)]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _pair(kind, spec):
    if kind == "digital":
        m, j, f, n, t, s = spec
        kw = dict(n_classes=m, clauses_per_class=j, n_features=f, n_states=n,
                  threshold=t, specificity=s)
        return ref_tm.TMConfig(**kw), tm.TMConfig(**kw)
    m, c, f, n, t, s, w = spec
    kw = dict(n_classes=m, n_clauses=c, n_features=f, n_states=n,
              threshold=t, specificity=s, max_weight=w)
    return ref_co.CoalescedConfig(**kw), co.CoalescedConfig(**kw)


def _sparse_state(rng, shape, n):
    """States on both sides of the boundary with ~10 % includes, so that
    clauses fire and every feedback branch is taken."""
    inc = rng.random(shape) < 0.1
    return np.where(inc, rng.integers(n + 1, 2 * n + 1, shape),
                    rng.integers(1, n + 1, shape)).astype(np.int16)


def _batch(rng, b, f, m):
    x = (rng.random((b, f)) < 0.5).astype(np.uint8)
    return x, rng.integers(0, m, b).astype(np.int32)


def _ref_draws(key, y, m, u_shape, ta_shape, s):
    """One example's draws, exactly as the reference's ``_ta_delta`` /
    ``_example_update`` make them from ``key``."""
    k_neg, k_sel, k_hi, k_lo = jax.random.split(key, 4)
    q = jax.random.randint(k_neg, (), 0, m - 1)
    q = jnp.where(q >= y, q + 1, q)
    u = jax.random.uniform(k_sel, u_shape)
    hi = ref_tt._bernoulli_u8(k_hi, (s - 1.0) / s, ta_shape)
    lo = ref_tt._bernoulli_u8(k_lo, 1.0 / s, ta_shape)
    return [np.asarray(v) for v in (q, u, hi, lo)]


def _stack_draws(draws):
    q, u, hi, lo = (np.stack(v) for v in zip(*draws))
    return FeedbackDraws(torch.from_numpy(q.astype(np.int64)),
                         torch.from_numpy(u), torch.from_numpy(hi),
                         torch.from_numpy(lo))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))          # an owned, writable copy
    return t if dtype is None else t.to(dtype)


# ----------------------------------------------------- exact apply halves

@pytest.mark.parametrize("spec", DIGITAL)
def test_ta_delta_apply_matches_reference_on_its_draws(spec):
    rcfg, cfg = _pair("digital", spec)
    rng = np.random.default_rng(sum(spec[:3]))
    state = _sparse_state(rng, (cfg.n_clauses, cfg.n_literals),
                          cfg.n_states)
    x, y = _batch(rng, 6, cfg.n_features, cfg.n_classes)
    lits = ref_tm.literals(jnp.asarray(x))
    cls = ref_tm.clause_outputs(jnp.asarray(state), lits, rcfg,
                                training=True)
    sums = ref_tm.class_sums(cls, rcfg)
    assert 0 < float(cls.mean()) < 1
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(9), 6)):
        want = np.asarray(ref_tt._ta_delta(key, jnp.asarray(state), lits[i],
                                           cls[i], sums[i], y[i], rcfg))
        draws = _stack_draws([_ref_draws(key, y[i], cfg.n_classes,
                                         (cfg.n_clauses,), state.shape,
                                         cfg.specificity)])
        got = tm_train._ta_delta_apply(
            _t(state), _t(lits[i:i + 1]), _t(cls[i:i + 1]),
            _t(sums[i:i + 1]), _t(y[i:i + 1], torch.int64), draws, cfg)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("spec", DIGITAL)
def test_batch_step_matches_reference_on_its_draws(spec):
    """The reference's ``train_step_batch`` (per-example keys split from
    the step key) against the port's clause evaluation (the packed op),
    sums, summed apply half and clip, on the reference's draws."""
    rcfg, cfg = _pair("digital", spec)
    rng = np.random.default_rng(3 * sum(spec[:3]))
    state = _sparse_state(rng, (cfg.n_clauses, cfg.n_literals),
                          cfg.n_states)
    b = 11
    x, y = _batch(rng, b, cfg.n_features, cfg.n_classes)
    key = jax.random.PRNGKey(spec[0] + 17)
    want = np.asarray(ref_tt.train_step_batch(
        jnp.asarray(state), key, jnp.asarray(x), jnp.asarray(y), rcfg))
    draws = _stack_draws([
        _ref_draws(k, y[i], cfg.n_classes, (cfg.n_clauses,), state.shape,
                   cfg.specificity)
        for i, k in enumerate(jax.random.split(key, b))])
    st_t = _t(state)
    lits = tm.literals(_t(x))
    cls = ops.clause_eval_packed(ops.pack_literals(lits),
                                 ops.pack_include(tm.include_mask(st_t, cfg)),
                                 device=CPU)
    delta = tm_train._ta_delta_apply(st_t, lits, cls,
                                     tm.class_sums(cls, cfg),
                                     _t(y, torch.int64), draws, cfg)
    got = tm_train._clip_state(
        st_t.to(torch.int32) + delta.sum(0, dtype=torch.int32), cfg)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != state).any()


@pytest.mark.parametrize("spec", COALESCED)
def test_example_update_apply_matches_reference_on_its_draws(spec):
    rcfg, cfg = _pair("coalesced", spec)
    rng = np.random.default_rng(sum(spec[:3]))
    state = _sparse_state(rng, (cfg.n_clauses, cfg.n_literals),
                          cfg.n_states)
    w = rng.integers(-cfg.max_weight, cfg.max_weight + 1,
                     (cfg.n_clauses, cfg.n_classes)).astype(np.int32)
    x, y = _batch(rng, 5, cfg.n_features, cfg.n_classes)
    lits = ref_tm.literals(jnp.asarray(x))
    cls = ref_co.clause_outputs(jnp.asarray(state), lits, rcfg,
                                training=True)
    sums = cls.astype(jnp.int32) @ jnp.asarray(w)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(4), 5)):
        ds, dw = ref_co._example_update(key, jnp.asarray(state),
                                        jnp.asarray(w), lits[i], cls[i],
                                        sums[i], y[i], rcfg)
        draws = _stack_draws([_ref_draws(
            key, y[i], cfg.n_classes, (cfg.n_clauses, cfg.n_classes),
            state.shape, cfg.specificity)])
        gs, gw = co._example_update_apply(
            _t(state), _t(w), _t(lits[i:i + 1]), _t(cls[i:i + 1]),
            _t(sums[i:i + 1]), _t(y[i:i + 1], torch.int64), draws, cfg)
        assert gs.dtype == torch.int8 and gw.dtype == torch.int8
        np.testing.assert_array_equal(gs[0].numpy(), np.asarray(ds))
        np.testing.assert_array_equal(gw[0].numpy(), np.asarray(dw))


@pytest.mark.parametrize("spec", COALESCED)
def test_coalesced_batch_step_matches_reference_on_its_draws(spec):
    rcfg, cfg = _pair("coalesced", spec)
    rng = np.random.default_rng(5 * sum(spec[:3]))
    state = _sparse_state(rng, (cfg.n_clauses, cfg.n_literals),
                          cfg.n_states)
    w = rng.integers(-cfg.max_weight, cfg.max_weight + 1,
                     (cfg.n_clauses, cfg.n_classes)).astype(np.int32)
    b = 9
    x, y = _batch(rng, b, cfg.n_features, cfg.n_classes)
    key = jax.random.PRNGKey(spec[1])
    ws, ww = ref_co.train_step_batch(jnp.asarray(state), jnp.asarray(w), key,
                                     jnp.asarray(x), jnp.asarray(y), rcfg)
    draws = _stack_draws([
        _ref_draws(k, y[i], cfg.n_classes, (cfg.n_clauses, cfg.n_classes),
                   state.shape, cfg.specificity)
        for i, k in enumerate(jax.random.split(key, b))])
    st_t, w_t = _t(state), _t(w)
    lits = tm.literals(_t(x))
    cls = ops.clause_eval_packed(ops.pack_literals(lits),
                                 ops.pack_include(st_t > cfg.n_states),
                                 device=CPU)
    ds, dw = co._example_update_apply(st_t, w_t, lits, cls,
                                      co.class_sums(cls, w_t),
                                      _t(y, torch.int64), draws, cfg)
    gs = tm_train._clip_state(st_t.to(torch.int32)
                              + ds.sum(0, dtype=torch.int32), cfg)
    gw = (w_t + dw.sum(0, dtype=torch.int32)).clamp(-cfg.max_weight,
                                                    cfg.max_weight)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))


def test_feedback_probs_match_reference_in_float32():
    """``p = (T -/+ clip(s)) / 2T`` in float32, in the reference's order,
    over every clipped sum value and both signs past the clip."""
    rcfg, cfg = _pair("digital", (3, 2, 4, 16, 7, 3.9))
    sums = np.array([[s, -s, 0] for s in range(-9, 10)], np.int32)
    y = np.zeros(len(sums), np.int32)
    q = np.ones(len(sums), np.int32)
    p_t, p_n = tm_train._feedback_probs(_t(sums), _t(y, torch.int64),
                                        _t(q, torch.int64), cfg)
    for i in range(len(sums)):
        rt, rn = ref_tt._feedback_probs(jnp.asarray(sums[i]), y[i], q[i],
                                        rcfg)
        assert p_t[i].dtype == torch.float32
        assert float(p_t[i]) == float(rt) and float(p_n[i]) == float(rn)


# ------------------------------------------------------- inside the port

@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), n_classes=st.integers(2, 4),
       clauses_per_class=st.sampled_from([2, 4, 10]),
       n_features=st.integers(2, 24), threshold=st.integers(1, 15),
       specificity=st.floats(1.5, 8.0))
def test_train_step_batch_equals_sequential_at_batch_one(
        seed, n_classes, clauses_per_class, n_features, threshold,
        specificity):
    """Same generator seed, same example: bit-identical TA states out."""
    cfg = tm.TMConfig(n_classes=n_classes,
                      clauses_per_class=clauses_per_class,
                      n_features=n_features, n_states=16,
                      threshold=threshold, specificity=specificity)
    rng = np.random.default_rng(seed)
    state = tm.init_ta_state(_gen(seed), cfg, CPU)
    x = _t((rng.random((1, n_features)) < 0.5).astype(np.uint8))
    y = torch.tensor([seed % n_classes])
    seq = tm_train.train_step(state, _gen(seed + 1), x, y, cfg)
    par = tm_train.train_step_batch(state, _gen(seed + 1), x, y, cfg)
    assert torch.equal(seq, par)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2 ** 16), b=st.integers(1, 6))
def test_train_steps_respect_state_and_weight_bounds(seed, b):
    """From states AT the bounds (and weights at ±max_weight), one step of
    each driver stays in ``[1, 2N]`` on the configured dtype, and the
    coalesced weights in ``±max_weight``: the clip is part of the
    update."""
    rng = np.random.default_rng(seed)
    cfg = tm.TMConfig(n_classes=2, clauses_per_class=4, n_features=6,
                      n_states=16, threshold=5, specificity=3.0)
    edge = rng.random((cfg.n_clauses, cfg.n_literals)) < 0.5
    state = _t(np.where(edge, 2 * cfg.n_states, 1).astype(np.int16))
    x = _t((rng.random((b, 6)) < 0.5).astype(np.uint8))
    y = _t(rng.integers(0, 2, b))
    for step in (tm_train.train_step, tm_train.train_step_batch):
        out = step(state, _gen(seed), x, y, cfg)
        assert out.dtype == torch.int16
        assert int(out.min()) >= 1 and int(out.max()) <= 2 * cfg.n_states
    ccfg = co.CoalescedConfig(n_classes=2, n_clauses=8, n_features=6,
                              n_states=16, threshold=5, specificity=3.0,
                              max_weight=2)
    w = _t(np.where(rng.random((8, 2)) < 0.5, 2, -2).astype(np.int32))
    cs, cw = co.train_step_batch(state, w, _gen(seed), x, y, ccfg)
    assert cs.dtype == torch.int16 and cw.dtype == torch.int32
    assert int(cs.min()) >= 1 and int(cs.max()) <= 2 * ccfg.n_states
    assert int(cw.abs().max()) <= ccfg.max_weight


@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_batch_steps_do_not_depend_on_the_chunk_size(chunk, monkeypatch):
    rng = np.random.default_rng(11)
    cfg = tm.TMConfig(n_classes=3, clauses_per_class=6, n_features=20,
                      n_states=20, threshold=7, specificity=3.3)
    state = _t(_sparse_state(rng, (cfg.n_clauses, cfg.n_literals), 20))
    x, y = _batch(rng, 13, 20, 3)
    ccfg = co.CoalescedConfig(n_classes=3, n_clauses=14, n_features=20,
                              n_states=20, threshold=7, specificity=3.3)
    w = _t(rng.integers(-3, 4, (14, 3)).astype(np.int32))
    cstate = state[:14].contiguous()
    whole = tm_train.train_step_batch(state, _gen(1), x, y, cfg)
    cwhole = co.train_step_batch(cstate, w, _gen(2), x, y, ccfg)
    assert tm_train._chunk_size(cfg.n_ta) >= 13          # one chunk
    assert (whole != state).any()
    # Cells per chunk such that each step runs in chunks of ``chunk``.
    monkeypatch.setattr(tm_train, "_CHUNK_CELLS", chunk * cfg.n_ta)
    assert tm_train._chunk_size(cfg.n_ta) == chunk
    assert torch.equal(tm_train.train_step_batch(state, _gen(1), x, y, cfg),
                       whole)
    monkeypatch.setattr(tm_train, "_CHUNK_CELLS", chunk * ccfg.n_ta)
    cs, cw = co.train_step_batch(cstate, w, _gen(2), x, y, ccfg)
    assert torch.equal(cs, cwhole[0]) and torch.equal(cw, cwhole[1])


def test_steps_evaluate_clauses_through_the_kernel_wrappers(monkeypatch):
    """The sequential step calls ``clause_eval`` once per example, the batch
    steps ``clause_eval_packed`` once per step (counted here on the CPU by
    wrapping the wrappers ``ops`` calls)."""
    calls = {"clause_eval": 0, "clause_eval_packed": 0}
    for name in calls:
        real = getattr(clause_eval, name)

        def counted(*args, _real=real, _name=name):
            calls[_name] += 1
            return _real(*args)
        monkeypatch.setattr(clause_eval, name, counted)
    rng = np.random.default_rng(2)
    cfg = tm.TMConfig(n_classes=2, clauses_per_class=4, n_features=6)
    state = tm.init_ta_state(_gen(0), cfg, CPU)
    x, y = _batch(rng, 5, 6, 2)
    tm_train.train_step(state, _gen(1), x, y, cfg)
    assert calls == {"clause_eval": 5, "clause_eval_packed": 0}
    tm_train.train_step_batch(state, _gen(1), x, y, cfg)
    ccfg = co.CoalescedConfig(n_classes=2, n_clauses=8, n_features=6)
    ta, w = co.init_coalesced(_gen(3), ccfg, CPU)
    co.train_step_batch(ta, w, _gen(4), x, y, ccfg)
    assert calls == {"clause_eval": 5, "clause_eval_packed": 2}


def test_fit_is_reproducible_from_a_seed():
    cfg = tm.TMConfig(n_classes=2, clauses_per_class=4, n_features=12)
    xtr, ytr, _, _ = tm_datasets.noisy_xor(_gen(0), 64, 8, device=CPU)
    runs = [tm_train.fit(tm.init_ta_state(_gen(1), cfg, CPU), _gen(2), xtr,
                         ytr, cfg, epochs=2, batch_size=16, parallel=par)
            for par in (True, True, False, False)]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[2], runs[3])
    assert not torch.equal(runs[0], runs[2])


# --------------------------------------------------- draws by distribution

@pytest.mark.parametrize("p", [1.0 / 3.9, 2.9 / 3.9, 0.1, 0.9, 0.999])
def test_bernoulli_u8_rate_and_threshold_rule(p):
    thresh = min(255, round(p * 256.0))
    assert tm_train._u8_threshold(p) == thresh
    n = 400_000
    got = tm_train._bernoulli_u8(_gen(5), p, (n,), CPU)
    assert got.dtype == torch.bool
    rate = thresh / 256.0
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float(got.float().mean()) - rate) < 5 * sigma
    ref = np.asarray(ref_tt._bernoulli_u8(jax.random.PRNGKey(0), p, (n,)))
    assert abs(ref.mean() - rate) < 5 * sigma       # the same rule


def test_init_states_sit_on_the_boundary_at_half_include():
    cfg = tm.TMConfig(n_classes=4, clauses_per_class=50, n_features=100,
                      n_states=127)
    st_t = tm.init_ta_state(_gen(0), cfg, CPU)
    assert st_t.dtype == torch.int16
    assert tuple(st_t.shape) == (cfg.n_clauses, cfg.n_literals)
    assert set(st_t.unique().tolist()) == {cfg.n_states, cfg.n_states + 1}
    share = float(tm.include_mask(st_t, cfg).float().mean())
    assert abs(share - 0.5) < 5 * (0.25 / cfg.n_ta) ** 0.5
    stats = tm.include_stats(st_t, cfg)
    ref = ref_tm.include_stats(jnp.asarray(st_t.numpy()), cfg)
    assert stats == ref
    ccfg = co.CoalescedConfig(n_classes=3, n_clauses=200, n_features=50)
    ta, w = co.init_coalesced(_gen(1), ccfg, CPU)
    assert set(ta.unique().tolist()) == {ccfg.n_states, ccfg.n_states + 1}
    assert w.dtype == torch.int32 and bool((w == 1).all())
    assert tuple(w.shape) == (200, 3)


def test_draws_follow_their_distributions():
    """``q`` is uniform over the classes other than ``y``; ``u`` uniform in
    [0, 1); the byte masks at (s-1)/s and 1/s on the 1/256 grid."""
    cfg = tm.TMConfig(n_classes=4, clauses_per_class=10, n_features=50,
                      specificity=3.9)
    n = 600
    y = torch.arange(n) % 4
    gens = [_gen(1000 + i) for i in range(n)]
    d = tm_train._draw_feedback(gens, y, 4, (cfg.n_clauses,),
                                (cfg.n_clauses, cfg.n_literals), 3.9, CPU)
    assert bool((d.q != y).all()) and int(d.q.min()) >= 0
    assert int(d.q.max()) <= 3
    counts = torch.bincount(d.q[y == 0], minlength=4)[1:].float()
    assert float(counts.min()) > 0.6 * float(counts.mean())
    assert d.u.dtype == torch.float32 and 0 <= float(d.u.min())
    assert float(d.u.max()) < 1 and abs(float(d.u.mean()) - 0.5) < 0.01
    for mask, p in ((d.r_hi, 2.9 / 3.9), (d.r_lo, 1 / 3.9)):
        rate = tm_train._u8_threshold(p) / 256
        assert abs(float(mask.float().mean()) - rate) < 0.002


# ------------------------------------------------------------- datasets

def test_noisy_xor_by_property():
    xtr, ytr, xte, yte = tm_datasets.noisy_xor(_gen(0), 20000, 5000,
                                               device=CPU)
    assert xtr.dtype == torch.uint8 and tuple(xtr.shape) == (20000, 12)
    assert tuple(xte.shape) == (5000, 12) and ytr.dtype == torch.int64
    assert set(xtr.unique().tolist()) == {0, 1}
    assert abs(float(xtr.float().mean()) - 0.5) < 0.01
    assert torch.equal(yte, (xte[:, 0] ^ xte[:, 1]).long())    # clean test
    flipped = float((ytr != (xtr[:, 0] ^ xtr[:, 1]).long()).float().mean())
    assert abs(flipped - 0.4) < 0.015


def test_synthetic_image_dataset_by_property():
    xtr, ytr, xte, yte = tm_datasets.synthetic_image_dataset(
        _gen(0), n_classes=10, n_train=2000, n_test=500, device=CPU)
    assert tuple(xtr.shape) == (2000, 784) and tuple(xte.shape) == (500, 784)
    assert xtr.dtype == torch.uint8 and ytr.dtype == torch.int64
    assert set(ytr.unique().tolist()) == set(range(10))
    x = torch.cat([xtr, xte]).float()
    y = torch.cat([ytr, yte])
    # Recover each class's prototype by majority; the flip rate and the
    # prototype density follow.
    protos = torch.stack([(x[y == m].mean(0) > 0.5).float()
                          for m in range(10)])
    flips = float((x != protos[y]).float().mean())
    assert abs(flips - 0.08) < 0.005
    assert abs(float(protos.mean()) - 0.25) < 0.02


# ---------------------------------------------------------------- learning

XOR_CFG = dict(n_classes=2, clauses_per_class=12, n_features=12,
               n_states=100, threshold=15, specificity=3.9)


@pytest.mark.parametrize("parallel,epochs,batch_size,bar", [
    (False, 20, 1500, 0.97), (True, 60, 64, 0.95)],
    ids=["sequential", "batch-parallel"])
def test_training_learns_noisy_xor(parallel, epochs, batch_size, bar):
    """The reference's bars (tests/test_tm_core.py: 3000 examples, batches
    of 1500 sequential and 64 batch-parallel) on port-drawn data.  The
    final accuracy of this 24-clause TM swings by several points from
    epoch to epoch and from seed to seed, in the reference as in the
    port, so the seed is fixed here as the reference's test fixes its
    keys; the sequential run takes 20 epochs instead of 60 to stay
    within the CPU suite's time (it learns XOR in fewer epochs)."""
    g = _gen(5)
    xtr, ytr, xte, yte = tm_datasets.noisy_xor(g, 3000, 1000, device=CPU)
    cfg = tm.TMConfig(**XOR_CFG)
    ta = tm_train.fit(tm.init_ta_state(g, cfg, CPU), g, xtr, ytr, cfg,
                      epochs=epochs, batch_size=batch_size,
                      parallel=parallel)
    assert float(tm.accuracy(ta, xte, yte, cfg)) >= bar


def _image_task(seed, classes=4, side=8, n_train=400, n_test=200):
    """An MNIST-shaped stand-in at a small width, drawn with numpy."""
    rng = np.random.default_rng(seed)
    f = side * side
    protos = (rng.random((classes, f)) < 0.25).astype(np.uint8)

    def make(n):
        y = rng.integers(0, classes, n)
        return protos[y] ^ (rng.random((n, f)) < 0.08).astype(np.uint8), y
    return (*make(n_train), *make(n_test))


def test_port_and_reference_train_to_the_same_accuracy():
    """Same numpy dataset, same config, epochs and batch: the two trained
    models' test accuracies lie within 3 points (their draws differ)."""
    xtr, ytr, xte, yte = _image_task(0)
    kw = dict(n_classes=4, clauses_per_class=20, n_features=64,
              n_states=127, threshold=15, specificity=5.0)
    rcfg, cfg = ref_tm.TMConfig(**kw), tm.TMConfig(**kw)
    ref = ref_tt.fit(ref_tm.init_ta_state(jax.random.PRNGKey(1), rcfg),
                     jax.random.PRNGKey(2), jnp.asarray(xtr),
                     jnp.asarray(ytr.astype(np.int32)), rcfg, epochs=4,
                     batch_size=50, parallel=True)
    ref_acc = float(ref_tm.accuracy(ref, jnp.asarray(xte),
                                    jnp.asarray(yte.astype(np.int32)), rcfg))
    g = _gen(1)
    port = tm_train.fit(tm.init_ta_state(g, cfg, CPU), g, xtr, ytr, cfg,
                        epochs=4, batch_size=50, parallel=True)
    acc = float(tm.accuracy(port, _t(xte), _t(yte), cfg))
    assert ref_acc > 0.8, ref_acc
    assert abs(acc - ref_acc) <= 0.03, (acc, ref_acc)


def test_coalesced_fit_learns_within_its_bounds():
    xtr, ytr, xte, yte = _image_task(1)
    ccfg = co.CoalescedConfig(n_classes=4, n_clauses=40, n_features=64,
                              threshold=15, specificity=5.0, max_weight=20)
    g = _gen(2)
    ta, w = co.init_coalesced(g, ccfg, CPU)
    ta, w = co.fit(ta, w, g, xtr, ytr, ccfg, epochs=4, batch_size=50)
    assert int(w.abs().max()) <= 20 and int(ta.min()) >= 1
    assert float(co.accuracy(ta, w, _t(xte), _t(yte), ccfg)) > 0.8


# ---------------------------------------------------------- OnlineTrainer

def _trainer(**kw):
    cfg = tm.TMConfig(n_classes=2, clauses_per_class=4, n_features=6)
    return OnlineTrainer(cfg, _gen(0), cfg=OnlineTrainerConfig(**kw),
                         device=CPU)


def test_online_config_validation():
    for bad in (dict(epochs=0), dict(buffer_cap=0), dict(min_examples=0)):
        with pytest.raises(ValueError):
            OnlineTrainerConfig(**bad)


def test_online_ingest_evicts_oldest_first():
    tr = _trainer(buffer_cap=10)
    x = np.arange(7 * 6).reshape(7, 6) % 2
    assert tr.ingest(x, np.zeros(7)) == 7
    assert tr.ingest(x[:5], np.ones(5)) == 10          # 2 oldest rows go
    bx, by = tr.buffer()
    assert bx.shape == (10, 6) and bx.dtype == np.uint8
    np.testing.assert_array_equal(bx[:5], x[2:])
    np.testing.assert_array_equal(by, [0] * 5 + [1] * 5)
    assert tr.ingest(x[:3], np.full(3, 1)) == 10       # a whole chunk too
    np.testing.assert_array_equal(tr.buffer()[0][-3:], x[:3])
    with pytest.raises(ValueError, match="ingest expects"):
        tr.ingest(x[:2], np.zeros(3))
    empty = _trainer()
    assert empty.buffer()[0].shape[0] == 0 and empty.n_buffered == 0


def test_online_refit_refuses_below_min_examples():
    tr = _trainer(min_examples=8)
    tr.ingest(np.zeros((7, 6)), np.zeros(7))
    with pytest.raises(ValueError, match=">= 8"):
        tr.refit()
    assert tr.version == 0


def test_online_refit_versions_are_monotonic_and_start_warm():
    xtr, ytr, _, _ = tm_datasets.noisy_xor(_gen(3), 200, 1, n_features=6,
                                           device=CPU)
    tr = _trainer(epochs=2, batch_size=50)
    tr.ingest(xtr.numpy(), ytr.numpy())
    tv1 = tr.refit()
    assert isinstance(tv1, TrainedVersion) and tv1.version == 1
    assert tv1.n_examples == 200 and tv1.epochs == 2
    gen_state = tr._gen.get_state()
    tv2 = tr.refit()
    assert tv2.version == 2
    # Warm: the second refit is fit() from the first refit's state.
    replay = tm_train.fit(tv1.ta_state, torch.Generator().set_state(
        gen_state), xtr, ytr, tr.tm_cfg, epochs=2, batch_size=50,
        parallel=True)
    assert torch.equal(replay, tv2.ta_state)
    assert torch.equal(tr.ta_state, tv2.ta_state)
    assert 0.0 <= tv2.accuracy <= 1.0
    warm = OnlineTrainer(tr.tm_cfg, _gen(5), init_state=tv2.ta_state,
                         device=CPU)
    assert torch.equal(warm.ta_state, tv2.ta_state)
