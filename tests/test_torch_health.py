"""Port parity for live health probing, quarantine and self-repair
(``repro_torch.serve.health``, ``ServeEngine.probe`` / ``enable_health``,
``RepairPolicy``), against ``tests/test_health.py``'s engine cases.

The reference programs and injures each pool; the port serves the same
arrays (``pool_from_numpy`` / ``coalesced_pool_from_numpy``, the fault
mask included), and both engines probe with the same ``(x, expected)``
probe arrays.  Every comparison is exact (tolerance 0): the per-replica
health dicts, the ``quarantined`` lists, the quarantine events and every
``Response``.  After a repair the two packages' chips differ (each
re-programs with its own generator), so the repaired pools are held to
the digital TM and to a score of 1.0 in both.  The port's own probe rows
come from numpy and are held by property.  Shapes are small: 4 classes x
8 clauses, 32 features; the reference's Pallas runs in interpret mode.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.core import coalesced as ref_co  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro.core import variations as ref_var  # noqa: E402
from repro.serve import batching as ref_batching  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve import health as ref_health  # noqa: E402
from repro.serve import replica as ref_replica  # noqa: E402
from repro.serve import swap as ref_swap  # noqa: E402
from repro_torch.convert import (coalesced_pool_from_numpy,  # noqa: E402
                                 pool_from_numpy)
from repro_torch.core import coalesced as co  # noqa: E402
from repro_torch.core import tm  # noqa: E402
from repro_torch.core import variations as var  # noqa: E402
from repro_torch.serve import (AsyncServeEngine, BatcherConfig,  # noqa: E402
                               EngineConfig, HealthConfig, HealthProbe,
                               RepairConfig, RepairPolicy, ServeEngine,
                               probe_replicas, program_replica_pool)

CFG = tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=32,
                  n_states=100)
REF_CFG = ref_tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=32,
                          n_states=100)
D2D = var.VariationConfig(d2d=True, c2c=False, csa_offset=False)
REF_D2D = ref_var.VariationConfig(d2d=True, c2c=False, csa_offset=False)
REF_INJURY = ref_var.FaultConfig(stuck_lrs_rate=0.15, stuck_hrs_rate=0.15)
HCFG = dict(n_probes=64, seed=5)
BATCHER = dict(max_batch=32, bucket_sizes=(8, 16, 32))
ENGINES = {"sync": (ServeEngine, ref_engine.ServeEngine),
           "async": (AsyncServeEngine, ref_engine.AsyncServeEngine)}


def _model(seed=0, n=64):
    """A sparse TA state (~10 % includes) and ``n`` Boolean requests."""
    rng = np.random.default_rng(seed)
    inc = rng.random((CFG.n_clauses, CFG.n_literals)) < 0.1
    ta = np.where(inc, CFG.n_states + 1, CFG.n_states).astype(np.int16)
    xs = (rng.random((n, CFG.n_features)) < 0.4).astype(np.uint8)
    return inc, ta, xs


def _digital(ta, xs):
    return tm.forward(torch.from_numpy(ta), torch.from_numpy(xs),
                      CFG).numpy()


def _engines(inc, *, n_replicas=4, routing="ensemble", kind="sync"):
    """The reference engine on a pool it programs (with its probe
    committed) and the port engine on the same arrays, sharing the
    reference's probe arrays."""
    cls, ref_cls = ENGINES[kind]
    ref_pool = ref_replica.program_replica_pool(
        jnp.asarray(inc), jax.random.PRNGKey(7), n_replicas, REF_D2D)
    ref = ref_cls(ref_pool, REF_CFG, ref_engine.EngineConfig(
        batcher=ref_batching.BatcherConfig(**BATCHER), routing=routing,
        health=ref_health.HealthConfig(**HCFG)), key=jax.random.PRNGKey(3))
    pool = pool_from_numpy(np.asarray(ref_pool.r_stack), inc, vcfg=D2D,
                           device="cpu")
    port = cls(pool, CFG, EngineConfig(batcher=BatcherConfig(**BATCHER),
                                       routing=routing), device="cpu")
    port.health = HealthProbe(x=np.asarray(ref.health.x),
                              expected=np.asarray(ref.health.expected),
                              hcfg=HealthConfig(**HCFG))
    return ref, port


def _injure(ref, port, inc, replicas=None):
    """Injure the reference pool and carry the injured arrays, fault mask
    included, into the port engine (``inject_faults``' own steps)."""
    ref.inject_faults(jax.random.PRNGKey(99), REF_INJURY, replicas=replicas)
    pool = pool_from_numpy(np.asarray(ref.pool.r_stack), inc, vcfg=D2D,
                           fault_mask=np.asarray(ref.pool.fault_mask),
                           device="cpu")
    port.quiesce()
    port._set_pool(pool)
    port.metrics.note_fault_injection(
        None if replicas is None else sorted(replicas))


def _same_responses(got, want):
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert (g.pred, g.replica, g.version, g.expired) == \
            (w.pred, w.replica, w.version, w.expired)
        np.testing.assert_array_equal(g.class_sums, np.asarray(w.class_sums))


# ------------------------------------------------------ probe + quarantine

def test_probe_flags_exactly_the_injured_replica():
    inc, _, _ = _model()
    ref, port = _engines(inc)
    assert port.probe() == ref.probe() == {i: 1.0 for i in range(4)}
    _injure(ref, port, inc, [1])
    h_ref, h = ref.probe(), port.probe()
    assert h == h_ref
    assert h[1] < 0.75 and all(h[i] == 1.0 for i in (0, 2, 3))
    assert port.quarantined == ref.quarantined == [1]
    assert (port.summary()["quarantine_events"]
            == ref.summary()["quarantine_events"])
    assert port.summary()["replica_health"] == ref.summary()[
        "replica_health"]


def test_probe_insensitive_to_read_noise():
    """Full C2C + CSA noise: the pool falls back to the eager analog path
    (the kernels do not model the CSA offset) and healthy chips still
    probe above both thresholds."""
    inc, _, _ = _model()
    ref_pool = ref_replica.program_replica_pool(
        jnp.asarray(inc), jax.random.PRNGKey(7), 4, ref_var.VariationConfig())
    with pytest.warns(UserWarning, match="fallback"):
        ref = ref_engine.ServeEngine(ref_pool, REF_CFG, ref_engine.EngineConfig(
            batcher=ref_batching.BatcherConfig(**BATCHER),
            health=ref_health.HealthConfig(**HCFG)))
    pool = pool_from_numpy(np.asarray(ref_pool.r_stack), inc,
                           vcfg=var.VariationConfig(), device="cpu")
    with pytest.warns(UserWarning, match="fallback"):
        port = ServeEngine(pool, CFG, EngineConfig(
            batcher=BatcherConfig(**BATCHER), health=HealthConfig(**HCFG)),
            device="cpu")
    assert port.backend.name == "analog-torch"
    probe = HealthProbe(x=np.asarray(ref.health.x),
                        expected=np.asarray(ref.health.expected),
                        hcfg=HealthConfig(**HCFG))
    h, h_ref = port.probe(probe), ref.probe()
    assert all(v >= 0.95 for v in h.values()), h
    assert all(v >= 0.95 for v in h_ref.values()), h_ref
    assert port.quarantined == ref.quarantined == []


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_quarantined_replica_never_serves(kind):
    inc, _, xs = _model()
    ref, port = _engines(inc, routing="round_robin", kind=kind)
    _injure(ref, port, inc, [1])
    assert port.probe() == ref.probe()
    assert port.quarantined == ref.quarantined == [1]
    for eng in (ref, port):
        for lo in range(0, len(xs), 8):           # one batch per chunk
            eng.submit_many(list(xs[lo:lo + 8]))
            eng.pump(force=True)
    got, want = port.drain(), ref.drain()
    _same_responses(got, want)
    assert len(got) == len(xs)
    assert {r.replica for r in got} == {0, 2, 3}
    assert port.router.rows_dispatched == ref.router.rows_dispatched
    assert port.router.rows_dispatched[1] == 0


def test_ensemble_degrades_to_healthy_majority():
    inc, ta, xs = _model()
    ref, port = _engines(inc)
    _injure(ref, port, inc, [1])
    assert port.probe() == ref.probe()
    ref.submit_many(list(xs))
    port.submit_many(list(xs))
    got = port.drain()
    _same_responses(got, ref.drain())
    np.testing.assert_array_equal([r.pred for r in got],
                                  _digital(ta, xs).argmax(-1))
    assert port.router.rows_dispatched[1] == 0


def test_last_healthy_chip_is_never_quarantined():
    inc, _, _ = _model()
    ref, port = _engines(inc, n_replicas=1)
    _injure(ref, port, inc)
    h = port.probe()
    assert h == ref.probe() and h[0] < 0.75
    assert port.quarantined == ref.quarantined == []      # floor of one
    events = port.metrics.summary()["quarantine_events"]
    assert events == ref.metrics.summary()["quarantine_events"]
    assert events and events[-1]["kind"] == "held_last_healthy"


def test_hysteresis_band_holds():
    inc, _, _ = _model()
    pool = program_replica_pool(torch.from_numpy(inc),
                                torch.Generator().manual_seed(1), 2, D2D)
    probe = HealthProbe.commit(pool, CFG, HealthConfig(
        quarantine_threshold=0.75, readmit_threshold=0.9))
    ref_probe = ref_health.HealthProbe.commit(
        ref_replica.program_replica_pool(jnp.asarray(inc),
                                         jax.random.PRNGKey(1), 2, REF_D2D),
        REF_CFG, ref_health.HealthConfig(quarantine_threshold=0.75,
                                         readmit_threshold=0.9))
    for health, quarantined in (({0: 0.8}, set()), ({0: 0.8}, {0}),
                                ({0: 0.7}, set()), ({0: 0.95}, {0}),
                                ({0: 0.75, 1: 0.9}, {1})):
        assert probe.classify(health, quarantined) == \
            ref_probe.classify(health, quarantined)
    assert probe.classify({0: 0.8}, {0}) == {0: "hold"}      # no flapping
    assert probe.classify({0: 0.7}, set()) == {0: "quarantine"}


@pytest.mark.parametrize("kw,match", [
    (dict(quarantine_threshold=0.9, readmit_threshold=0.5), "readmit"),
    (dict(quarantine_threshold=1.5), "quarantine_threshold"),
    (dict(quarantine_threshold=-0.1), "quarantine_threshold"),
    (dict(n_probes=0), "probe row")])
def test_health_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        HealthConfig(**kw)
    with pytest.raises(ValueError, match=match):
        ref_health.HealthConfig(**kw)


# ---------------------------------------------------- the port's own rows

@pytest.mark.parametrize("seed", [0, 5])
def test_commit_rows_target_clauses_and_match_reference_answers(seed):
    """Row ``i`` fires clause ``i % C`` in the clean model (every
    satisfiable one), and ``expected`` equals the reference's
    ``DigitalState.from_include`` forward on the port's rows (exact)."""
    inc, _, _ = _model(seed=3)
    inc[6] = False                                   # one empty clause
    pool = program_replica_pool(torch.from_numpy(inc),
                                torch.Generator().manual_seed(2), 3, D2D)
    hcfg = HealthConfig(n_probes=40, seed=seed)
    probe = HealthProbe.commit(pool, CFG, hcfg)
    assert probe.x.shape == (40, CFG.n_features) and probe.x.dtype == np.uint8
    fired = tm.clause_outputs_from_include(
        torch.from_numpy(inc), tm.literals(torch.from_numpy(probe.x))).numpy()
    f = CFG.n_features
    for i in range(probe.n_probes):
        c = i % CFG.n_clauses
        # Every non-empty clause that does not include a feature in both
        # polarities (which no row can satisfy) fires on its row.
        satisfiable = inc[c].any() and not (inc[c, :f] & inc[c, f:]).any()
        assert fired[i, c] == int(satisfiable), (i, c)
    assert fired[np.arange(probe.n_probes),
                 np.arange(probe.n_probes) % CFG.n_clauses].sum() \
        >= probe.n_probes // 2                      # not a degenerate model
    want = ref_api.class_sums(
        ref_api.DigitalState.from_include(jnp.asarray(inc), REF_CFG),
        ref_tm.literals(jnp.asarray(probe.x)), None)
    np.testing.assert_array_equal(probe.expected, np.asarray(want))
    assert probe.score(probe.expected) == 1.0
    again = HealthProbe.commit(pool, CFG, hcfg)       # deterministic
    np.testing.assert_array_equal(again.x, probe.x)


def test_probe_leaves_the_serving_trace_unchanged():
    """A C2C engine that probes between batches serves bit for bit what
    an engine that never probes serves: probes read with their own
    generator."""
    _, ta, xs = _model(seed=4, n=48)
    vcfg = var.VariationConfig(csa_offset=False)
    ecfg = EngineConfig(batcher=BatcherConfig(max_batch=8, bucket_sizes=(8,)),
                        routing="round_robin", health=HealthConfig(**HCFG))
    a, b = (ServeEngine.from_ta_state(torch.from_numpy(ta), CFG, n_replicas=3,
                                      seed=11, vcfg=vcfg, ecfg=ecfg,
                                      device="cpu") for _ in range(2))
    assert a.backend.name == "analog-cuda-packed2"
    out = {}
    for name, eng in (("probing", a), ("plain", b)):
        for lo in range(0, len(xs), 16):
            eng.submit_many(list(xs[lo:lo + 16]))
            eng.pump(force=True)
            if eng is a:
                assert probe_replicas(eng) == {0: 1.0, 1: 1.0, 2: 1.0}
        out[name] = eng.drain()
    _same_responses(out["probing"], out["plain"])
    assert a.summary()["probe_rounds"] == 3
    assert "probe_rounds" not in b.summary()


# ------------------------------------------------------------ chaos loops

@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_chaos_loop(kind):
    """injure -> detect -> quarantine -> serve degraded -> repair ->
    readmit: zero drops, digital answers throughout, the same health,
    quarantine and repair records as the reference."""
    inc, ta, xs = _model()
    ref, port = _engines(inc, kind=kind)
    digital = _digital(ta, xs).argmax(-1)
    rids = port.submit_many(list(xs[:16]))
    ref.submit_many(list(xs[:16]))
    _injure(ref, port, inc, [2])
    h = port.probe()
    assert h == ref.probe()
    assert h[2] < 0.75 and all(h[i] == 1.0 for i in (0, 1, 3))
    assert port.quarantined == ref.quarantined == [2]
    rids += port.submit_many(list(xs[16:32]))
    ref.submit_many(list(xs[16:32]))
    events = RepairPolicy(port, RepairConfig()).repair()
    ref_events = ref_swap.RepairPolicy(ref, ref_swap.RepairConfig()).repair()
    assert events == ref_events
    assert events[2]["readmitted"] and events[2]["attempts"] == 1
    assert port.quarantined == []
    assert port.probe() == ref.probe() == {i: 1.0 for i in range(4)}
    rids += port.submit_many(list(xs[32:]))
    ref.submit_many(list(xs[32:]))
    responses = port.drain()
    want = ref.drain()
    assert [r.rid for r in responses] == rids          # nothing dropped
    assert not any(r.expired for r in responses)
    np.testing.assert_array_equal([r.pred for r in responses], digital)
    assert [r.pred for r in responses] == [r.pred for r in want]
    assert [r.version for r in responses] == [r.version for r in want]
    s, rs = port.summary(), ref.summary()
    assert s["expired"] == 0 and s["rejected"] == 0
    assert [e["kind"] for e in s["quarantine_events"]] == \
        ["quarantine", "readmit"]
    for k in ("quarantine_events", "fault_injections", "swaps",
              "pool_version", "quarantined", "replica_health"):
        assert s[k] == rs[k], k
    assert port.version == 0       # injure/repair never bumped the model


# ---------------------------------------------------------- coalesced pool

def test_coalesced_fault_inject_probe_repair():
    ccfg = co.CoalescedConfig(n_classes=4, n_clauses=32, n_features=16,
                              n_states=100)
    ref_ccfg = ref_co.CoalescedConfig(n_classes=4, n_clauses=32,
                                      n_features=16, n_states=100)
    rng = np.random.default_rng(1)
    inc = rng.random((32, 32)) < 0.1
    ta = np.where(inc, 101, 100).astype(np.int16)
    w = rng.integers(-3, 4, (32, 4)).astype(np.int32)
    batcher = ref_batching.BatcherConfig(**BATCHER)
    ref = ref_engine.ServeEngine.from_coalesced(
        jnp.asarray(ta), jnp.asarray(w), ref_ccfg,
        ecfg=ref_engine.EngineConfig(
            batcher=batcher, health=ref_health.HealthConfig(**HCFG)))
    port = ServeEngine(coalesced_pool_from_numpy(ta, w, ccfg, device="cpu"),
                       ccfg, EngineConfig(batcher=BatcherConfig(**BATCHER)),
                       device="cpu")
    assert port.backend.name == "coalesced-cuda-packed2"
    port.health = HealthProbe(x=np.asarray(ref.health.x),
                              expected=np.asarray(ref.health.expected),
                              hcfg=HealthConfig(**HCFG))
    assert port.probe() == ref.probe() == {0: 1.0}
    ref.inject_faults(jax.random.PRNGKey(99), ref_var.FaultConfig(
        stuck_lrs_rate=0.25, stuck_hrs_rate=0.25))
    port.quiesce()
    port._set_pool(dataclasses.replace(port.pool, fault_mask=torch.from_numpy(
        np.array(ref.pool.fault_mask))))
    h = port.probe()
    assert h == ref.probe() and h[0] < 0.75
    assert port.quarantined == ref.quarantined == []   # one chip: the floor
    out = RepairPolicy(port, RepairConfig()).check()
    ref_out = ref_swap.RepairPolicy(ref, ref_swap.RepairConfig()).check()
    assert out["health"] == ref_out["health"]
    assert out["repairs"] == ref_out["repairs"]
    assert port.pool.fault_mask is None
    assert port.probe() == ref.probe() == {0: 1.0}
    xs = (rng.random((20, 16)) < 0.4).astype(np.uint8)
    port.submit_many(list(xs))
    ref.submit_many(list(xs))
    _same_responses(port.drain(), ref.drain())
