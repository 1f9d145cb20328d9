"""Port parity for fault injection, the chaos path: ``sample_fault_mask``
/ ``apply_fault_overlay``, ``inject_faults`` / ``reprogram`` on the
states and pools, ``repair_replica``, the coalesced pool's stored
overlay, and ``ServeEngine.inject_faults`` re-packing the planes.

Where the reference and the port meet, they take the same numpy arrays
(resistances, masks) and must agree bit for bit; the port's own mask
sampler is checked by distribution, as the reference's is in
``tests/test_health.py``, since torch and jax draw different numbers from
the same seed.  Shapes are small: C = 2 classes x 4 clauses, F = 21
(L = 42), R = 4 chips.
"""

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
from repro_torch import api  # noqa: E402
from repro_torch.convert import (coalesced_pool_from_numpy,  # noqa: E402
                                 pool_from_numpy)
from repro_torch.core import coalesced as co  # noqa: E402
from repro_torch.core import tm  # noqa: E402
from repro_torch.core import variations as var  # noqa: E402
from repro_torch.serve import batching, engine, replica  # noqa: E402

CFG = tm.TMConfig(n_classes=2, clauses_per_class=4, n_features=21,
                  n_states=100)
REF_CFG = ref_tm.TMConfig(n_classes=2, clauses_per_class=4, n_features=21,
                          n_states=100)
R = 4
NOMINAL = var.VariationConfig.nominal()
D2D = var.VariationConfig(d2d=True, c2c=False, csa_offset=False)
STUCK = var.FaultConfig(stuck_lrs_rate=0.05, stuck_hrs_rate=0.05)
FCFGS = {
    "stuck": (STUCK, ref_var.FaultConfig(stuck_lrs_rate=0.05,
                                         stuck_hrs_rate=0.05)),
    "stuck+drift": (var.FaultConfig(stuck_lrs_rate=0.1, stuck_hrs_rate=0.2,
                                    drift_rate=0.37, read_age=1.9),
                    ref_var.FaultConfig(stuck_lrs_rate=0.1,
                                        stuck_hrs_rate=0.2,
                                        drift_rate=0.37, read_age=1.9)),
    "drift": (var.FaultConfig(drift_rate=0.013, read_age=7.0),
              ref_var.FaultConfig(drift_rate=0.013, read_age=7.0)),
}


def _case(seed, n=9):
    rng = np.random.default_rng(seed)
    inc = rng.random((CFG.n_clauses, CFG.n_literals)) < 0.08
    inc[2] = False
    x = (rng.random((n, CFG.n_features)) < 0.5).astype(np.uint8)
    r = np.where(inc, var.LRS_MEAN_OHM, var.HRS_MEAN_OHM) * (
        1.0 + 0.2 * rng.random((R, *inc.shape)))
    mask = rng.choice(np.array([0, 1, 2], np.int8), size=(R, *inc.shape),
                      p=[0.8, 0.1, 0.1])
    return inc, x, r.astype(np.float32), mask


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _digital(inc, x):
    ta = np.where(inc, CFG.n_states + 1, CFG.n_states).astype(np.int16)
    return tm.forward(torch.from_numpy(ta), torch.from_numpy(x), CFG)


# ----------------------------------------------------------- fault model

@pytest.mark.parametrize("name", sorted(FCFGS))
def test_apply_fault_overlay_matches_reference_bitwise(name):
    _, _, r, mask = _case(1)
    fcfg, ref_fcfg = FCFGS[name]
    got = var.apply_fault_overlay(torch.from_numpy(r),
                                  torch.from_numpy(mask), fcfg)
    want = ref_var.apply_fault_overlay(jnp.asarray(r), jnp.asarray(mask),
                                       ref_fcfg)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), r)


def test_apply_fault_overlay_nominal_is_identity():
    _, _, r, mask = _case(2)
    t = torch.from_numpy(r)
    for fcfg in (var.FaultConfig(), var.FaultConfig(drift_rate=0.5)):
        assert var.apply_fault_overlay(t, torch.from_numpy(mask), fcfg) is t


def test_sample_fault_mask_rates_and_disjointness():
    fcfg = var.FaultConfig(stuck_lrs_rate=0.2, stuck_hrs_rate=0.1)
    m = var.sample_fault_mask(_gen(0), (400, 400), fcfg).numpy()
    assert m.dtype == np.int8
    assert set(np.unique(m)) <= {var.FAULT_NONE, var.FAULT_STUCK_LRS,
                                 var.FAULT_STUCK_HRS}
    assert abs((m == var.FAULT_STUCK_LRS).mean() - 0.2) < 0.01
    assert abs((m == var.FAULT_STUCK_HRS).mean() - 0.1) < 0.01
    assert not var.sample_fault_mask(_gen(0), (50, 50),
                                     var.FaultConfig()).any()
    assert torch.equal(var.sample_fault_mask(_gen(3), (9, 9), fcfg),
                       var.sample_fault_mask(_gen(3), (9, 9), fcfg))
    assert (var.FAULT_NONE, var.FAULT_STUCK_LRS, var.FAULT_STUCK_HRS) == (
        ref_var.FAULT_NONE, ref_var.FAULT_STUCK_LRS, ref_var.FAULT_STUCK_HRS)


# ----------------------------------------------------------- replica pool

def _pool(seed=3, vcfg=NOMINAL):
    inc, x, r, _ = _case(seed)
    return pool_from_numpy(r, inc, vcfg=vcfg, device="cpu"), inc, x


def test_inject_faults_on_one_chip_leaves_the_others_bit_untouched():
    pool, _, _ = _pool()
    hurt = pool.inject_faults(_gen(7), STUCK, replicas=[1])
    assert hurt.version == pool.version
    for i in (0, 2, 3):
        assert torch.equal(hurt.r_stack[i], pool.r_stack[i])
        assert not hurt.fault_mask[i].any()
    assert hurt.fault_mask[1].any()
    assert not torch.equal(hurt.r_stack[1], pool.r_stack[1])
    stuck = hurt.fault_mask[1] == var.FAULT_STUCK_LRS
    assert bool((hurt.r_stack[1][stuck] == np.float32(var.LRS_MEAN_OHM))
                .all())
    # Chip 1's defects do not depend on which chips were targeted.
    every = pool.inject_faults(_gen(7), STUCK)
    assert torch.equal(every.fault_mask[1], hurt.fault_mask[1])
    assert torch.equal(every.r_stack[1], hurt.r_stack[1])
    # Nominal or missing configs are the identity.
    assert pool.inject_faults(_gen(7), var.FaultConfig()) is pool
    assert pool.inject_faults(_gen(7)) is pool


def test_reinjection_compounds_the_masks():
    pool, _, _ = _pool()
    once = pool.inject_faults(_gen(1), STUCK, replicas=[0])
    twice = once.inject_faults(_gen(2), STUCK, replicas=[0])
    kept = once.fault_mask != 0
    assert bool((twice.fault_mask[kept] != 0).all())
    assert int((twice.fault_mask != 0).sum()) > int(kept.sum())


def test_repair_replica_restores_the_chip_and_drops_the_mask():
    pool, _, _ = _pool()
    hurt = pool.inject_faults(_gen(7), STUCK, replicas=[1, 3])
    half = hurt.repair_replica(1, _gen(8))
    assert half.fault_mask is not None and not half.fault_mask[1].any()
    assert half.fault_mask[3].any()
    for i in (0, 2, 3):
        assert torch.equal(half.r_stack[i], hurt.r_stack[i])
    # NOMINAL programming: the repaired chip is back at the class means.
    assert torch.equal(half.r_stack[1],
                       torch.where(pool.include, var.LRS_MEAN_OHM,
                                   var.HRS_MEAN_OHM).float())
    healed = half.repair_replica(3, _gen(9))
    assert healed.fault_mask is None
    assert healed.version == pool.version
    with pytest.raises(IndexError):
        healed.repair_replica(R, _gen(0))


def test_reprogram_bumps_version_and_matches_fresh_programming():
    pool, inc, _ = _pool(vcfg=D2D)
    hurt = pool.inject_faults(_gen(1), STUCK)
    new_inc = torch.from_numpy(~inc)
    fresh = hurt.reprogram(new_inc, _gen(4))
    assert fresh.version == pool.version + 1 and fresh.fault_mask is None
    want = replica.program_replica_pool(new_inc, _gen(4), R, D2D)
    assert torch.equal(fresh.r_stack, want.r_stack)
    assert torch.equal(fresh.include, new_inc)
    with pytest.raises(ValueError, match="geometry"):
        pool.reprogram(new_inc[:, :-1], _gen(4))
    xbar = fresh.crossbar(2)
    assert torch.equal(xbar.r_mem, fresh.r_stack[2])
    assert xbar.mapping == fresh.mapping


def test_pool_from_numpy_carries_a_fault_mask():
    inc, _, r, mask = _case(4)
    pool = pool_from_numpy(r, inc, fault_mask=mask, device="cpu")
    assert pool.fault_mask.dtype == torch.int8
    np.testing.assert_array_equal(pool.fault_mask.numpy(), mask)
    with pytest.raises(ValueError, match="fault_mask"):
        pool_from_numpy(r, inc, fault_mask=mask[:2], device="cpu")


# ---------------------------------------------------------------- states

def test_plane_packed_injury_rederives_the_deviation_plane():
    """After an injury on a plane-packed stack the index bitplane stays,
    ``r == r_nom + plane_dev`` holds bitwise, and the plane-packed kernel
    path equals the eager model on the same injured state."""
    inc, x, r, _ = _case(5)
    st = api.ReplicaStackState(r_stack=torch.from_numpy(r),
                               include=torch.from_numpy(inc), tm_cfg=CFG,
                               vcfg=D2D).pack_planes()
    hurt = st.inject_faults(_gen(6), FCFGS["stuck+drift"][0],
                            replicas=[0, 2])
    assert hurt.plane_index is st.plane_index
    assert hurt.fault_mask.shape == (R, *inc.shape)
    r_nom = torch.where(torch.from_numpy(inc), var.LRS_MEAN_OHM,
                        var.HRS_MEAN_OHM).float()
    assert torch.equal(hurt.r_stack, r_nom + hurt.plane_dev)
    assert torch.equal(hurt.r_stack[1], st.r_stack[1])
    lits = tm.literals(torch.from_numpy(x))
    assert torch.equal(api.get_backend("analog-cuda-packed2").fn(hurt, lits),
                       api.get_backend("analog-torch").fn(hurt, lits))
    sl = hurt.replica_slice(2)
    assert torch.equal(sl.fault_mask, hurt.fault_mask[2:3])
    assert torch.equal(hurt.replica(2).fault_mask, hurt.fault_mask[2])


def test_crossbar_state_injury_and_reprogram():
    inc, _, r, _ = _case(6)
    st = api.CrossbarState(r_mem=torch.from_numpy(r[0]),
                           include=torch.from_numpy(inc), tm_cfg=CFG,
                           vcfg=var.VariationConfig(fault=STUCK))
    assert st.inject_faults(_gen(1), var.FaultConfig()) is st
    hurt = st.inject_faults(_gen(1))                  # vcfg.fault
    assert hurt.fault_mask is not None and not hurt.plane_packed
    np.testing.assert_array_equal(
        hurt.r_mem.numpy(),
        np.asarray(ref_var.apply_fault_overlay(
            jnp.asarray(r[0]), jnp.asarray(hurt.fault_mask.numpy()),
            FCFGS["stuck"][1])))
    planes = st.pack_planes().inject_faults(_gen(1))
    assert planes.plane_dev is not None
    assert torch.equal(planes.fault_mask, hurt.fault_mask)
    fresh = hurt.pack().reprogram(torch.from_numpy(inc), _gen(3))
    assert fresh.fault_mask is None and not fresh.packed
    assert fresh.plane_dev is None


# ------------------------------------------------------------- coalesced

def _coalesced(seed):
    ccfg = co.CoalescedConfig(n_classes=3, n_clauses=10, n_features=12,
                              n_states=100)
    ref_ccfg = ref_co.CoalescedConfig(n_classes=3, n_clauses=10,
                                      n_features=12, n_states=100)
    rng = np.random.default_rng(seed)
    ta = rng.integers(1, 2 * ccfg.n_states + 1,
                      (ccfg.n_clauses, ccfg.n_literals)).astype(np.int16)
    ta = np.where(rng.random(ta.shape) < 0.85, 1, ta).astype(np.int16)
    w = rng.integers(-9, 10, (ccfg.n_clauses, 3)).astype(np.int32)
    mask = rng.choice(np.array([0, 1, 2], np.int8), size=ta.shape,
                      p=[0.9, 0.05, 0.05])
    x = (rng.random((7, ccfg.n_features)) < 0.5).astype(np.uint8)
    return ccfg, ref_ccfg, ta, w, mask, x


def test_coalesced_pool_fault_overlay_matches_reference():
    ccfg, ref_ccfg, ta, w, mask, x = _coalesced(7)
    pool = coalesced_pool_from_numpy(ta, w, ccfg, device="cpu")
    hurt = replica.CoalescedPool(ta_state=pool.ta_state,
                                 weights=pool.weights, cfg=ccfg,
                                 fault_mask=torch.from_numpy(mask))
    ref = ref_replica.CoalescedPool(ta_state=jnp.asarray(ta),
                                    weights=jnp.asarray(w), cfg=ref_ccfg,
                                    fault_mask=jnp.asarray(mask))
    got, want = hurt.state(), ref.state()
    np.testing.assert_array_equal(got.ta_state.numpy(),
                                  np.asarray(want.ta_state))
    assert got.ta_state.dtype == pool.ta_state.dtype
    assert torch.equal(hurt.ta_state, pool.ta_state)     # stays clean
    lits = tm.literals(torch.from_numpy(x))
    assert not torch.equal(api.class_sums(got, lits),
                           api.class_sums(pool.state(), lits))
    assert hurt.repair_replica(0).fault_mask is None
    # The state-level injury pins the same cells.
    st = pool.state().inject_faults(_gen(2), STUCK)
    assert torch.equal(st.ta_state, replica.CoalescedPool(
        ta_state=pool.ta_state, weights=pool.weights, cfg=ccfg,
        fault_mask=st.fault_mask).state().ta_state)
    assert st.include_packed is None and st.plane_index is None


def test_coalesced_pool_inject_reprogram_repair():
    ccfg, _, ta, w, _, _ = _coalesced(8)
    pool = coalesced_pool_from_numpy(ta, w, ccfg, device="cpu")
    assert pool.inject_faults(_gen(1), STUCK, replicas=[1]) is pool
    assert pool.inject_faults(_gen(1), None) is pool
    hurt = pool.inject_faults(_gen(1), STUCK, replicas=[0])
    assert hurt.fault_mask is not None and hurt.version == pool.version
    new = hurt.reprogram(torch.from_numpy(ta[::-1].copy()),
                         torch.from_numpy(w))
    assert new.version == pool.version + 1 and new.fault_mask is None
    with pytest.raises(ValueError, match="reprogram shapes"):
        hurt.reprogram(torch.from_numpy(ta[:, :-1]), torch.from_numpy(w))
    with pytest.raises(IndexError):
        hurt.repair_replica(1)
    st = pool.state().reprogram(torch.from_numpy(ta), torch.from_numpy(w))
    assert torch.equal(st.ta_state, pool.ta_state)


# ---------------------------------------------------------------- engine

def _engine(pool, routing="ensemble", **kw):
    return engine.ServeEngine(
        pool, CFG, engine.EngineConfig(
            batcher=batching.BatcherConfig(max_batch=8, bucket_sizes=(8,)),
            routing=routing, **kw), device="cpu")


def test_engine_inject_faults_repacks_the_planes():
    """A nominal plane-packed pool has no deviation plane; an injury into
    chip 1 grows one, the healthy chips keep the digital TM's sums, and a
    repair installed with ``_set_pool`` elides the plane again."""
    inc, x, _, _ = _case(9)
    include = torch.from_numpy(inc)
    pool = replica.program_replica_pool(include, None, R, NOMINAL)
    eng = _engine(pool)
    assert eng.backend.name == "analog-cuda-packed2"
    assert eng.state.plane_dev is None
    nominal_bytes = eng.summary()["resident_nbytes_full"]
    eng.inject_faults(_gen(5), var.FaultConfig(stuck_lrs_rate=0.3,
                                               stuck_hrs_rate=0.1),
                      replicas=[1])
    s = eng.summary()
    assert s["fault_injections"] == [{"replicas": [1]}]
    assert eng.state.plane_dev is not None
    assert s["resident_nbytes_full"] > nominal_bytes
    assert eng.pool.version == pool.version
    lits = tm.literals(torch.from_numpy(x))
    sums = eng.backend.fn(eng.state, lits)
    digital = _digital(inc, x)
    for i in (0, 2, 3):
        assert torch.equal(sums[i], digital)
    assert not torch.equal(sums[1], digital)
    eng.submit_many(list(x))
    out = eng.drain()
    assert [r.pred for r in out] == digital.argmax(-1).tolist()  # 3 of 4
    eng.inject_faults(_gen(5), var.FaultConfig())                # no-op
    assert len(eng.summary()["fault_injections"]) == 1
    eng._set_pool(eng.pool.repair_replica(1, None))
    assert eng.pool.fault_mask is None and eng.state.plane_dev is None
    assert eng.summary()["resident_nbytes_full"] == nominal_bytes
    assert torch.equal(eng.backend.fn(eng.state, lits),
                       digital.expand(R, *digital.shape))


@pytest.mark.parametrize("tier", ("planes", "dense"))
def test_engine_serves_a_reference_injured_pool_like_the_reference(tier):
    """The chaos path across the two packages: the reference injures its
    pool; the port serves the same injured arrays (resistances and mask,
    carried with ``pool_from_numpy``) and answers every request alike."""
    inc, x, _, _ = _case(10, n=17)
    ref_vcfg = ref_var.VariationConfig(d2d=True, c2c=False,
                                       csa_offset=False)
    ref_pool = ref_replica.program_replica_pool(
        jnp.asarray(inc), jax.random.PRNGKey(1), R, ref_vcfg)
    kw = {} if tier == "planes" else {"packed": False}
    ref = ref_engine.ServeEngine(ref_pool, REF_CFG, ref_engine.EngineConfig(
        batcher=ref_batching.BatcherConfig(max_batch=8, bucket_sizes=(8,)),
        routing="ensemble", **kw))
    ref.inject_faults(jax.random.PRNGKey(2), ref_var.FaultConfig(
        stuck_lrs_rate=0.1, stuck_hrs_rate=0.1), replicas=[1, 2])
    pool = pool_from_numpy(np.asarray(ref.pool.r_stack), inc,
                           vcfg=D2D, fault_mask=np.asarray(
                               ref.pool.fault_mask), device="cpu")
    port = _engine(pool, **kw)
    assert port.backend.name == ref.backend.name.replace("-pallas", "-cuda")
    ref.submit_many(list(x))
    port.submit_many(list(x))
    for g, w in zip(port.drain(), ref.drain()):
        assert g.pred == w.pred
        np.testing.assert_array_equal(g.class_sums, w.class_sums)
    assert (port.summary()["resident_nbytes_full"]
            == ref.summary()["resident_nbytes_full"])

