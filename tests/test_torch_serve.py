"""Port parity for the whole slice: the port's ``ServeEngine`` against the
reference ``repro.serve.engine.ServeEngine`` over the SAME programmed pool
(drawn by the reference, carried across with ``repro_torch.convert``).

Every ``Response.pred`` and ``Response.class_sums`` must be equal, the
port must serve through ``analog-cuda-packed2`` (its plain version on
the CPU), and at nominal the sums must equal the digital TM.  The
reference runs its Pallas kernel in interpret mode, so shapes are small.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import imbue as ref_imbue  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro.core import variations as ref_var  # noqa: E402
from repro.serve import batching as ref_batching  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve import metrics as ref_metrics  # noqa: E402
from repro.serve import replica as ref_replica  # noqa: E402
from repro_torch.convert import pool_from_numpy, ta_from_numpy  # noqa: E402
from repro_torch.core import imbue, tm  # noqa: E402
from repro_torch.core import variations as var  # noqa: E402
from repro_torch.kernels import imbue_infer  # noqa: E402
from repro_torch.serve import batching, engine, metrics, replica  # noqa: E402

CFG = tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=37,
                  n_states=100)
REF_CFG = ref_tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=37,
                          n_states=100)
R = 3
VCFGS = {
    "d2d": (var.VariationConfig(d2d=True, c2c=False, csa_offset=False),
            ref_var.VariationConfig(d2d=True, c2c=False, csa_offset=False)),
    "nominal": (var.VariationConfig.nominal(),
                ref_var.VariationConfig.nominal()),
}


def _data(seed, n=21):
    rng = np.random.default_rng(seed)
    inc = rng.random((CFG.n_clauses, CFG.n_literals)) < 0.04
    inc[5] = False                                   # one empty clause
    xs = (rng.random((n, CFG.n_features)) < 0.5).astype(np.uint8)
    return inc, xs


def _engines(inc, vname, routing, seed=21):
    vcfg, ref_vcfg = VCFGS[vname]
    ref_pool = ref_replica.program_replica_pool(
        jnp.asarray(inc), jax.random.PRNGKey(seed), R, ref_vcfg)
    ref_ecfg = ref_engine.EngineConfig(
        batcher=ref_batching.BatcherConfig(max_batch=8, bucket_sizes=(8,)),
        routing=routing)
    ref = ref_engine.ServeEngine(ref_pool, REF_CFG, ref_ecfg,
                                 key=jax.random.PRNGKey(3))
    pool = pool_from_numpy(np.asarray(ref_pool.r_stack),
                           np.asarray(ref_pool.include),
                           imbue.IMBUEConfig(), vcfg, device="cpu")
    ecfg = engine.EngineConfig(
        batcher=batching.BatcherConfig(max_batch=8, bucket_sizes=(8,)),
        routing=routing)
    port = engine.ServeEngine(pool, CFG, ecfg, device="cpu")
    return ref, port


@pytest.mark.parametrize("vname,routing", [
    ("d2d", "round_robin"), ("d2d", "ensemble"), ("d2d", "least_loaded"),
    ("nominal", "round_robin"), ("nominal", "ensemble")])
def test_engine_matches_reference_engine(vname, routing):
    inc, xs = _data(seed=1)
    ref, port = _engines(inc, vname, routing)
    assert ref.backend.name == "analog-pallas-packed2"
    assert port.backend.name == "analog-cuda-packed2"
    assert not port.selection.fell_back and port.packed_io
    before = imbue_infer.imbue_infer_planes.launches
    ref.submit_many(list(xs))
    port.submit_many(list(xs))
    want, got = ref.drain(), port.drain()
    assert imbue_infer.imbue_infer_planes.launches == before   # CPU: plain
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert g.pred == w.pred and g.replica == w.replica
        np.testing.assert_array_equal(g.class_sums, w.class_sums)
    sums = np.stack([r.class_sums for r in got])
    assert np.count_nonzero(sums) > sums.size // 4        # not all zeros
    s, rs = port.summary(), ref.summary()
    for k in ("requests", "batches", "padding_overhead", "bytes_moved",
              "resident_bytes_moved", "fallback_dispatches",
              "replica_load_rows", "plane_packed", "packed_io"):
        assert s[k] == rs[k], k
    assert s["hardware"] == rs["hardware"]
    if vname == "nominal":
        ta = np.where(inc, CFG.n_states + 1, CFG.n_states)
        digital = tm.forward(ta_from_numpy(ta, CFG, device="cpu"),
                             torch.from_numpy(xs), CFG).numpy()
        factor = R if routing == "ensemble" else 1
        np.testing.assert_array_equal(sums, factor * digital)


def test_csa_offset_pool_falls_back_loudly():
    inc, xs = _data(seed=2, n=10)
    include = torch.from_numpy(inc)
    pool = replica.program_replica_pool(include, torch.Generator()
                                        .manual_seed(0), R,
                                        var.VariationConfig())
    with pytest.warns(UserWarning, match="serve backend fallback"):
        eng = engine.ServeEngine(pool, CFG, device="cpu")
    assert eng.selection.fell_back
    assert "models_csa_offset" in eng.selection.fallback_reason
    assert eng.backend.name == "analog-torch" and not eng.packed_io
    eng.submit_many(list(xs))
    out = eng.drain()
    assert len(out) == 10 and all(0 <= r.pred < CFG.n_classes for r in out)
    s = eng.summary()
    assert s["fallback_dispatches"] == s["batches"] >= 1
    assert s["forward_fallbacks"] == [eng.selection.fallback_reason]
    assert s["backend_preferred"] == "analog-cuda-packed2"


def test_from_ta_state_c2c_pool_serves_through_kernel_path():
    inc, xs = _data(seed=3, n=9)
    ta = torch.from_numpy(np.where(inc, CFG.n_states + 1,
                                   CFG.n_states).astype(np.int16))
    vcfg = var.VariationConfig(csa_offset=False)
    a = engine.ServeEngine.from_ta_state(ta, CFG, n_replicas=R, seed=4,
                                         vcfg=vcfg, device="cpu")
    b = engine.ServeEngine.from_ta_state(ta, CFG, n_replicas=R, seed=4,
                                         vcfg=vcfg, device="cpu")
    assert a.backend.name == "analog-cuda-packed2"
    assert a.state.plane_dev is not None
    assert torch.equal(a.pool.r_stack, b.pool.r_stack)
    for eng in (a, b):
        eng.submit_many(list(xs))
    ra, rb = a.drain(), b.drain()
    assert [r.pred for r in ra] == [r.pred for r in rb]   # same seed, same
    for x, y in zip(ra, rb):
        np.testing.assert_array_equal(x.class_sums, y.class_sums)


def test_deadlines_qos_and_queue_limits_match_reference():
    inc, xs = _data(seed=4, n=4)
    ref, port = _engines(inc, "nominal", "round_robin")
    outcomes = []
    for eng, bcfg in ((ref, ref_batching), (port, batching)):
        now = [0.0]
        eng.clock = lambda: now[0]
        eng.batcher = type(eng.batcher)(bcfg.BatcherConfig(
            max_batch=8, bucket_sizes=(8,), max_wait_s=1.0), packed=True)
        exp = eng.submit(xs[0], deadline_s=0.5)
        lat = eng.submit(xs[1], qos="latency")
        bulk = eng.submit(xs[2])
        now[0] = 0.3
        served_lat = eng.pump()          # latency class cut at 0.25
        now[0] = 0.6
        served_exp = eng.pump()          # rid `exp` expired, bulk not due
        now[0] = 1.1
        served_bulk = eng.pump()
        s = eng.summary()
        outcomes.append((served_lat, served_exp, served_bulk,
                         eng.result(exp).expired, eng.result(exp).replica,
                         eng.result(lat).pred, eng.result(bulk).pred,
                         s["expired"], sorted(s["qos"])))
        with pytest.raises(bcfg.QueueFull):
            eng.ecfg = dataclasses.replace(eng.ecfg, max_queue_depth=0)
            eng.submit(xs[3])
        assert eng.summary()["rejected"] == 1
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][:5] == (1, 0, 1, True, engine.EXPIRED)


def test_take_poll_discard_bookkeeping():
    inc, xs = _data(seed=5, n=6)
    _, port = _engines(inc, "nominal", "round_robin")
    rids = port.submit_many(list(xs))
    assert port.poll(rids[0]) is None
    port.discard(rids[1])
    port.pump(force=True)
    assert port.take(rids[0]).rid == rids[0]
    assert port.poll(rids[0]) is None and port.poll(rids[1]) is None
    assert [r.rid for r in port.drain()] == rids[2:]
    assert port.summary()["requests"] == 6


@pytest.mark.parametrize("mode", ("majority", "sum"))
def test_ensemble_vote_matches_reference(mode):
    rng = np.random.default_rng(6)
    sums = rng.integers(-3, 4, (4, 50, 5)).astype(np.int32)  # many ties
    masks = [None, np.array([True, False, True, True]),
             np.array([False, False, False, True])]
    for mask in masks:
        got = replica.ensemble_vote(
            torch.from_numpy(sums), mode,
            None if mask is None else torch.from_numpy(mask))
        want = ref_replica.ensemble_vote(
            jnp.asarray(sums), mode, None if mask is None
            else jnp.asarray(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        replica.ensemble_vote(torch.from_numpy(sums), "nope")


def test_router_matches_reference_router():
    a, b = replica.RouterState.create(4), ref_replica.RouterState.create(4)
    picks = []
    for step in range(12):
        if step == 3:
            a.quarantine(1)
            b.quarantine(1)
        if step == 8:
            a.readmit(1)
            b.readmit(1)
        policy = "least_loaded" if step % 3 == 2 else "round_robin"
        i, j = a.pick(policy), b.pick(policy)
        a.note_dispatch(i, 8 * (step % 4 + 1))
        b.note_dispatch(j, 8 * (step % 4 + 1))
        picks.append((i, j))
    assert all(i == j for i, j in picks)
    assert a.rows_dispatched == b.rows_dispatched
    for q in range(4):
        a.quarantine(q)
    assert a.healthy_replicas() == [0, 1, 2, 3]    # floor of one


def test_metrics_and_energy_copies_match_reference():
    inc, _ = _data(seed=7)
    n_inc = int(inc.sum())
    for ens in (False, True):
        assert (metrics.hardware_figures(CFG, n_inc, 4, ensemble=ens)
                == ref_metrics.hardware_figures(REF_CFG, n_inc, 4,
                                                ensemble=ens))
    vals = np.array([3.0, 1.0, 2.0, 4.0])
    assert (metrics._percentile(np.sort(vals), 0.5)
            == ref_metrics._percentile(np.sort(vals), 0.5))
    with pytest.raises(batching.NonBooleanInput):
        batching.pack_request_np(np.array([0, 2, 1]))
    assert (imbue.I_INCLUDE_ON, imbue.I_EXCLUDE_ON) == (
        ref_imbue.I_INCLUDE_ON, ref_imbue.I_EXCLUDE_ON)
