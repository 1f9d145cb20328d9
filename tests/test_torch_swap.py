"""Port parity for the live hot swap (``repro_torch.serve.swap``,
``ServeEngine.install_pool`` / ``arm_canary``), against
``tests/test_swap.py``'s engine cases.

Both engines serve the same reference-programmed pool (carried across
with ``pool_from_numpy``), and every swap installs the same
reference-programmed candidate in both: ``HotSwapper.begin`` in the port
is handed the reference's candidate by replacing ``reprogrammed_pool``.
The comparisons are exact (tolerance 0): ``pred``, ``class_sums``,
``version`` and ``replica`` (``CANARY`` included) of every ``Response``,
the canary tallies, ``HotSwapper.decision()`` and the swap events.  The
port's own programming (``hot_swap`` / ``begin`` from a seed) is held to
a fresh ``ServeEngine.from_ta_state`` on the same seed, bit for bit, and
its rollback to the snapshot.  Reads are D2D only (no C2C), the
configuration under which bit-equality of predictions is assertable,
except for the canary replay case, which reads under C2C.  Shapes are
small (4 classes x 8 clauses, 32 features); the reference's Pallas runs
in interpret mode.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import coalesced as ref_co  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro.core import variations as ref_var  # noqa: E402
from repro.serve import batching as ref_batching  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve import replica as ref_replica  # noqa: E402
from repro.serve import swap as ref_swap  # noqa: E402
from repro_torch.convert import (coalesced_pool_from_numpy,  # noqa: E402
                                 pool_from_numpy, ta_from_numpy)
from repro_torch.core import coalesced as co  # noqa: E402
from repro_torch.core import tm  # noqa: E402
from repro_torch.core import variations as var  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import (CANARY, AsyncServeEngine,  # noqa: E402
                               BatcherConfig, CoalescedPool, EngineConfig,
                               HotSwapper, ServeEngine, SwapConfig, hot_swap,
                               program_replica_pool, restore_pool,
                               snapshot_pool, swap)

CFG = tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=32,
                  n_states=100)
REF_CFG = ref_tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=32,
                          n_states=100)
D2D = var.VariationConfig(c2c=False, csa_offset=False)
REF_D2D = ref_var.VariationConfig(c2c=False, csa_offset=False)
BATCHER = dict(max_batch=16, bucket_sizes=(8, 16))
ENGINES = {"sync": (ServeEngine, ref_engine.ServeEngine),
           "async": (AsyncServeEngine, ref_engine.AsyncServeEngine)}


def _ta(seed, density=0.12):
    rng = np.random.default_rng(seed)
    inc = rng.random((CFG.n_clauses, CFG.n_literals)) < density
    return np.where(inc, CFG.n_states + 1, CFG.n_states).astype(np.int16)


def _xs(seed, n=64):
    rng = np.random.default_rng(seed)
    return (rng.random((n, CFG.n_features)) < 0.4).astype(np.uint8)


def _inc(ta):
    return ta > CFG.n_states


def _carry(ref_pool):
    return pool_from_numpy(np.asarray(ref_pool.r_stack),
                           np.asarray(ref_pool.include), vcfg=D2D,
                           version=ref_pool.version, device="cpu")


def _engines(ta, *, kind="sync", n_replicas=2, routing="round_robin"):
    cls, ref_cls = ENGINES[kind]
    ref_pool = ref_replica.program_replica_pool(
        jnp.asarray(_inc(ta)), jax.random.PRNGKey(7), n_replicas, REF_D2D)
    ref = ref_cls(ref_pool, REF_CFG, ref_engine.EngineConfig(
        batcher=ref_batching.BatcherConfig(**BATCHER), routing=routing),
        key=jax.random.PRNGKey(3))
    port = cls(_carry(ref_pool), CFG, EngineConfig(
        batcher=BatcherConfig(**BATCHER), routing=routing), device="cpu")
    return ref, port


def _candidate(ref, ta2):
    """The reference's re-programmed candidate pool and its port copy."""
    cand = ref_swap.reprogrammed_pool(ref, jnp.asarray(ta2),
                                      jax.random.PRNGKey(5))
    return cand, _carry(cand)


def _port_engine(ta, cls=ServeEngine, seed=7, **ecfg_kw):
    return cls.from_ta_state(
        ta_from_numpy(ta, CFG, device="cpu"), CFG, n_replicas=2, seed=seed,
        vcfg=D2D, ecfg=EngineConfig(batcher=BatcherConfig(**BATCHER),
                                    **ecfg_kw), device="cpu")


def _spy_batches(engine):
    """Record the set of Response versions per dispatched batch."""
    seen = []
    orig = engine.metrics.record_batch

    def spy(records, bucket, nbytes=0, **kw):
        seen.append({r.version for r in records})
        orig(records, bucket, nbytes, **kw)

    engine.metrics.record_batch = spy
    return seen


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.rid, g.pred, g.replica, g.version) == \
            (w.rid, w.pred, w.replica, w.version)
        np.testing.assert_array_equal(g.class_sums, np.asarray(w.class_sums))


# ------------------------------------------- snapshots (digest-verified)

def test_snapshot_restore_roundtrip_preserves_versions(tmp_path):
    ta, ta2 = _ta(0), _ta(1)
    pool = program_replica_pool(torch.from_numpy(_inc(ta)),
                                torch.Generator().manual_seed(1), 2, D2D)
    snapshot_pool(pool, str(tmp_path))
    pool1 = pool.reprogram(torch.from_numpy(_inc(ta2)),
                           torch.Generator().manual_seed(2))
    snapshot_pool(pool1, str(tmp_path))
    for want in (pool, pool1):
        got = restore_pool(pool1, str(tmp_path), want.version)
        assert got.version == want.version and got.fault_mask is None
        assert torch.equal(got.r_stack, want.r_stack)
        assert torch.equal(got.include, want.include)
        assert got.include.dtype == torch.bool


def test_snapshots_restore_across_the_two_packages(tmp_path):
    """A reference snapshot restores in the port and a port snapshot in
    the reference, array for array (both write the same checkpoint
    format and content digest)."""
    ta = _ta(2)
    ref_pool = ref_replica.program_replica_pool(
        jnp.asarray(_inc(ta)), jax.random.PRNGKey(4), 3, REF_D2D)
    ref_swap.snapshot_pool(ref_pool, str(tmp_path / "ref"))
    port_pool = _carry(ref_pool)
    got = restore_pool(port_pool, str(tmp_path / "ref"), 0)
    assert torch.equal(got.r_stack, port_pool.r_stack)
    assert torch.equal(got.include, port_pool.include)
    snapshot_pool(port_pool, str(tmp_path / "port"))
    back = ref_swap.restore_pool(ref_pool, str(tmp_path / "port"), 0)
    np.testing.assert_array_equal(np.asarray(back.r_stack),
                                  np.asarray(ref_pool.r_stack))


def test_corrupted_snapshot_refuses_to_restore(tmp_path):
    pool = program_replica_pool(torch.from_numpy(_inc(_ta(3))),
                                torch.Generator().manual_seed(1), 2, D2D)
    path = snapshot_pool(pool, str(tmp_path))
    npz = os.path.join(path, "leaves.npz")
    with np.load(npz) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    arrays["r_stack"].reshape(-1)[0] += 1.0       # one bit-rotted cell
    np.savez(npz, **arrays)
    with pytest.raises(ValueError, match="digest"):
        restore_pool(pool, str(tmp_path), pool.version)


# --------------------------------------------------- engine atomic swap

def test_hot_swap_sync_zero_drops_and_unmixed_batches():
    ta, xs = _ta(4), _xs(0)
    ref, port = _engines(ta)
    batches = _spy_batches(port)
    rids_pre = port.submit_many(list(xs[:20]))
    ref.submit_many(list(xs[:20]))
    port.pump(force=True)
    ref.pump(force=True)
    rids_queued = port.submit_many(list(xs[20:32]))     # still queued
    ref.submit_many(list(xs[20:32]))
    ref_cand, cand = _candidate(ref, _ta(5))
    ref.install_pool(ref_cand, kind="swap")
    port.install_pool(cand, kind="swap")
    assert port.version == ref.version == 1
    _same(port.drain(), ref.drain())
    pre = [port.result(r) for r in rids_pre]
    queued = [port.result(r) for r in rids_queued]
    assert all(r is not None for r in pre + queued)     # zero drops
    assert {r.version for r in pre} == {0}
    assert {r.version for r in queued} == {1}
    assert batches and all(len(s) == 1 for s in batches)
    s, rs = port.summary(), ref.summary()
    assert s["requests_by_version"] == rs["requests_by_version"] == \
        {"0": 20, "1": 12}
    assert s["swaps"] == rs["swaps"] == [
        {"from_version": 0, "to_version": 1, "kind": "swap"}]


def test_hot_swap_predictions_bit_equal_fresh_engine():
    """The port's own re-programming from a seed equals a fresh engine's
    pool on that seed, and the two serve the same answers."""
    ta, ta2, xs = _ta(6), _ta(7), _xs(1)
    engine = _port_engine(ta)
    for _ in range(2):            # the round-robin cursor returns to 0
        engine.submit_many(list(xs[:8]))
        engine.drain()
    assert hot_swap(engine, ta_from_numpy(ta2, CFG, device="cpu"),
                    seed=11) == 1
    fresh = _port_engine(ta2, seed=11)
    assert torch.equal(engine.pool.r_stack, fresh.pool.r_stack)
    assert torch.equal(engine.pool.include, fresh.pool.include)

    def serve(e):
        rids = e.submit_many(list(xs))
        e.drain()
        return [(e.result(r).pred, e.result(r).replica,
                 e.result(r).class_sums.tolist()) for r in rids]

    assert serve(engine) == serve(fresh)


def test_async_swap_quiesces_in_flight_then_serves_new_version():
    ta, xs = _ta(8), _xs(2)
    ref, port = _engines(ta, kind="async")
    batches = _spy_batches(port)
    rids_a = port.submit_many(list(xs[:16]))
    ref.submit_many(list(xs[:16]))
    port.pump(force=True)
    ref.pump(force=True)
    rids_b = port.submit_many(list(xs[16:28]))
    ref.submit_many(list(xs[16:28]))
    ref_cand, cand = _candidate(ref, _ta(9))
    ref.install_pool(ref_cand, kind="swap")
    port.install_pool(cand, kind="swap")           # quiesces, installs
    assert port.in_flight == ref.in_flight == 0
    _same(port.drain(), ref.drain())
    assert {port.result(r).version for r in rids_a} == {0}
    assert {port.result(r).version for r in rids_b} == {1}
    assert all(len(s) == 1 for s in batches)


def test_install_pool_rejects_incompatible_pools():
    ta = _ta(10)
    engine = _port_engine(ta)
    inc = torch.from_numpy(_inc(ta))
    gen = torch.Generator().manual_seed(3)
    with pytest.raises(ValueError, match="n_replicas"):
        engine.install_pool(program_replica_pool(inc, gen, 3, D2D))
    with pytest.raises(ValueError, match="noise config"):
        engine.install_pool(program_replica_pool(
            inc, gen, 2, var.VariationConfig.nominal()))
    with pytest.raises(ValueError, match="shape"):
        engine.install_pool(program_replica_pool(inc[:, :-2], gen, 2, D2D))
    ccfg = co.CoalescedConfig(n_classes=2, n_clauses=8, n_features=12,
                              n_states=100)
    with pytest.raises(ValueError, match="type"):
        engine.install_pool(CoalescedPool(
            ta_state=torch.full((8, 24), 100, dtype=torch.int16),
            weights=torch.ones(8, 2, dtype=torch.int32), cfg=ccfg))
    assert engine.version == 0 and "swaps" not in engine.summary()


@pytest.mark.parametrize("bad", [0.0, -0.5, 1.5])
def test_arm_canary_validates_fraction(bad):
    engine = _port_engine(_ta(11))
    with pytest.raises(ValueError, match="fraction"):
        engine.arm_canary(engine._slices[0], 1, bad)
    assert not engine.canary_active


# -------------------------------------------------------- canary rollout

def _begin_both(monkeypatch, ref, port, tmp_path, scfg_kw):
    """Begin a rollout in both engines on the reference's candidate."""
    ref_sw = ref_swap.HotSwapper(ref, str(tmp_path / "ref"),
                                 ref_swap.SwapConfig(**scfg_kw))
    sw = HotSwapper(port, str(tmp_path / "port"), SwapConfig(**scfg_kw))
    ta2 = _ta(12)
    ref_v = ref_sw.begin(jnp.asarray(ta2), jax.random.PRNGKey(5))
    ref_cand, cand = _candidate(ref, ta2)
    monkeypatch.setattr(swap, "reprogrammed_pool",
                        lambda *a, **k: cand)
    assert sw.begin(ta_from_numpy(ta2, CFG, device="cpu")) == ref_v == 1
    return ref_sw, sw, cand


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_canary_promote_flow(monkeypatch, tmp_path, kind):
    ta, xs = _ta(13), _xs(3)
    ref, port = _engines(ta, kind=kind)
    batches = _spy_batches(port)
    ref_sw, sw, cand = _begin_both(monkeypatch, ref, port, tmp_path, dict(
        canary_fraction=0.5, min_canary_rows=8, min_agreement=0.0))
    assert port.canary_active and port.version == 0
    rng = np.random.default_rng(0)
    resps, ref_resps = [], []
    while sw.decision() == "wait":
        rows = list(xs[rng.integers(0, len(xs), 8)])
        rids = port.submit_many(rows)
        ref_rids = ref.submit_many(rows)
        port.pump(force=True)
        ref.pump(force=True)
        resps += [port.result(r) for r in rids]
        ref_resps += [ref.result(r) for r in ref_rids]
        assert sw.decision() == ref_sw.decision()
    _same(resps, ref_resps)
    canary = [r for r in resps if r.replica == CANARY]
    stable = [r for r in resps if r.replica != CANARY]
    assert canary and stable
    assert {r.version for r in canary} == {1}
    assert {r.version for r in stable} == {0}
    assert all(len(s) == 1 for s in batches)
    assert (sw.rows(), sw.agreement()) == (ref_sw.rows(), ref_sw.agreement())
    assert sw.status() == ref_sw.status()
    assert sw.decision() == ref_sw.decision() == "promote"
    assert sw.promote() == ref_sw.promote() == port.version == 1
    assert not port.canary_active and not sw.active
    assert port.pool is not None and torch.equal(port.pool.r_stack,
                                                 cand.r_stack)
    s, rs = port.summary(), ref.summary()
    for k in ("canary", "swaps", "requests_by_version"):
        assert s[k] == rs[k], k
    rids = port.submit_many(list(xs[:8]))
    ref.submit_many(list(xs[:8]))
    _same(port.drain(), ref.drain())
    assert {port.result(r).version for r in rids} == {1}


def test_promote_equals_a_fresh_engine(tmp_path):
    """``begin`` programs the whole candidate from its seed as
    ``from_ta_state`` does, so the promoted pool is the fresh one."""
    ta, ta2 = _ta(14), _ta(15)
    engine = _port_engine(ta)
    sw = HotSwapper(engine, str(tmp_path), SwapConfig(canary_fraction=1.0,
                                                      min_canary_rows=8))
    sw.begin(ta_from_numpy(ta2, CFG, device="cpu"), seed=21)
    engine.submit_many(list(_xs(4)[:16]))
    engine.drain()
    assert sw.rows() == 16
    sw.promote()
    assert torch.equal(engine.pool.r_stack,
                       _port_engine(ta2, seed=21).pool.r_stack)


def test_canary_rollback_restores_pool_bit_for_bit(monkeypatch, tmp_path):
    ta, xs = _ta(16), _xs(5)
    ref, port = _engines(ta)
    stack0 = port.pool.r_stack.clone()
    ref_sw, sw, _ = _begin_both(monkeypatch, ref, port, tmp_path,
                                dict(canary_fraction=0.5, min_canary_rows=4))
    for lo in (0, 8):                     # two batches: one on the canary
        port.submit_many(list(xs[lo:lo + 8]))
        ref.submit_many(list(xs[lo:lo + 8]))
        port.pump(force=True)
        ref.pump(force=True)
    _same(port.drain(), ref.drain())
    assert port.metrics.canary_rows == ref.metrics.canary_rows == 8
    assert sw.rollback() == ref_sw.rollback() == port.version == 0
    assert not port.canary_active and not sw.active
    assert torch.equal(port.pool.r_stack, stack0)
    assert port.pool.fault_mask is None
    assert port.summary()["swaps"] == ref.summary()["swaps"]
    assert port.summary()["swaps"][-1]["kind"] == "rollback"
    rids = port.submit_many(list(xs[:8]))
    ref.submit_many(list(xs[:8]))
    _same(port.drain(), ref.drain())
    assert {port.result(r).version for r in rids} == {0}


def test_swapper_state_machine(tmp_path):
    engine = _port_engine(_ta(17))
    swapper = HotSwapper(engine, str(tmp_path))
    assert swapper.decision() == "idle" and not swapper.active
    with pytest.raises(RuntimeError, match="promote"):
        swapper.promote()
    with pytest.raises(RuntimeError, match="roll back"):
        swapper.rollback()
    swapper.begin(ta_from_numpy(_ta(18), CFG, device="cpu"), seed=1)
    with pytest.raises(RuntimeError, match="already active"):
        swapper.begin(ta_from_numpy(_ta(19), CFG, device="cpu"), seed=1)
    status = swapper.status()
    assert status["active"] and status["candidate_version"] == 1
    assert status["decision"] == "wait"       # no canary traffic yet
    assert swapper.rollback() == 0


@pytest.mark.parametrize("kw,match", [
    (dict(canary_fraction=0.0), "canary_fraction"),
    (dict(min_agreement=1.5), "min_agreement"),
    (dict(min_canary_rows=0), "min_canary_rows")])
def test_swap_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        SwapConfig(**kw)
    with pytest.raises(ValueError, match=match):
        ref_swap.SwapConfig(**kw)


def test_canary_of_the_serving_state_agrees_under_c2c():
    """At R = 1 under C2C, a canary armed with the serving state itself
    reads the same noise as its shadow (the generator's state is
    replayed): agreement 1.0, and a C2C read that does change the sums
    would not give that by chance."""
    ta, xs = _ta(20), _xs(6, n=48)
    eng = ServeEngine.from_ta_state(
        ta_from_numpy(ta, CFG, device="cpu"), CFG, n_replicas=1, seed=3,
        vcfg=var.VariationConfig(csa_offset=False),
        ecfg=EngineConfig(batcher=BatcherConfig(max_batch=8,
                                                bucket_sizes=(8,))),
        device="cpu")
    shadows = []
    orig = eng._forward

    def spy(state, lits, generator, mask):
        sums, preds = orig(state, lits, generator, mask)
        shadows.append(sums.clone())
        return sums, preds

    eng._forward = spy
    eng.arm_canary(eng._slices[0], 1, 1.0)
    eng.submit_many(list(xs))
    out = eng.drain()
    assert all(r.replica == CANARY for r in out)
    assert eng.metrics.canary_rows == len(xs)
    assert eng.metrics.canary_agreement() == 1.0
    assert len(shadows) == 2 * (len(xs) // 8)
    for canary, shadow in zip(shadows[::2], shadows[1::2]):
        assert torch.equal(canary, shadow)
    # The replay is what makes them equal: two draws in a row differ.
    gen = torch.Generator().manual_seed(0)
    st = eng.state
    state0 = gen.get_state()
    d1 = ops.c2c_deviation(gen, st.plane_index, st.plane_dev, 1,
                           eng.pool.vcfg, CFG.n_literals)
    d2 = ops.c2c_deviation(gen, st.plane_index, st.plane_dev, 1,
                           eng.pool.vcfg, CFG.n_literals)
    gen.set_state(state0)
    d3 = ops.c2c_deviation(gen, st.plane_index, st.plane_dev, 1,
                           eng.pool.vcfg, CFG.n_literals)
    assert not torch.equal(d1, d2) and torch.equal(d1, d3)


# ------------------------------------------------------------- coalesced

def test_coalesced_engine_hot_swap():
    ccfg = co.CoalescedConfig(n_classes=2, n_clauses=8, n_features=12,
                              n_states=100)
    ref_ccfg = ref_co.CoalescedConfig(n_classes=2, n_clauses=8,
                                      n_features=12, n_states=100)
    ta, w = (np.array(a) for a in ref_co.init_coalesced(
        jax.random.PRNGKey(1), ref_ccfg))
    ta2, w2 = (np.array(a) for a in ref_co.init_coalesced(
        jax.random.PRNGKey(2), ref_ccfg))
    ref = ref_engine.ServeEngine.from_coalesced(jnp.asarray(ta),
                                                jnp.asarray(w), ref_ccfg)
    port = ServeEngine(coalesced_pool_from_numpy(ta, w, ccfg, device="cpu"),
                       ccfg, device="cpu")
    t2, tw2 = torch.from_numpy(ta2), torch.from_numpy(w2)
    with pytest.raises(ValueError, match="weights"):
        hot_swap(port, t2)                        # coalesced needs weights=
    assert hot_swap(port, t2, weights=tw2) == port.version == 1
    assert ref_swap.hot_swap(ref, jnp.asarray(ta2),
                             weights=jnp.asarray(w2)) == 1
    xs = list((np.random.default_rng(3).random((16, 12)) < 0.4)
              .astype(np.uint8))
    fresh = ServeEngine(coalesced_pool_from_numpy(ta2, w2, ccfg,
                                                  device="cpu"),
                        ccfg, device="cpu")
    port.submit_many(xs)
    ref.submit_many(xs)
    fresh.submit_many(xs)
    live, want = port.drain(), ref.drain()
    _same(live, want)
    assert [r.pred for r in live] == [r.pred for r in fresh.drain()]
    assert port.summary()["swaps"] == ref.summary()["swaps"]
