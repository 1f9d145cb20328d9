"""Port parity for the asynchronous engine (``AsyncServeEngine``, the
issue / collect split, ``InFlight``), against the async cases of
``tests/test_serve.py`` and the mid-drain expiry case of
``tests/test_qos.py``, parametrised over both port engines.

The engines serve the same reference-programmed pool (carried across with
``pool_from_numpy`` / ``coalesced_pool_from_numpy``); ``Response``
fields (rid order, ``pred``, ``class_sums``, ``replica``, ``expired``)
are compared exactly (tolerance 0) with the reference's engine, with the
digital TM at nominal and with ``core.coalesced.forward``.  On a C2C pool
the async engine must equal the sync engine bit for bit on the same seed:
the serving generator draws in issue order.  On the CPU a result is
complete when its op returns (no event), so ``pump`` collects every
issue; the card tests in ``tests/test_torch_cuda.py`` hold the CUDA
events.  Shapes are small (4 classes x 8 clauses, 32 features); the
reference's Pallas runs in interpret mode.
"""

import warnings

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
from repro_torch.convert import (coalesced_pool_from_numpy,  # noqa: E402
                                 pool_from_numpy, ta_from_numpy)
from repro_torch.core import coalesced as co  # noqa: E402
from repro_torch.core import tm  # noqa: E402
from repro_torch.core import variations as var  # noqa: E402
from repro_torch.serve import (AsyncServeEngine, BatcherConfig,  # noqa: E402
                               EngineConfig, InFlight, ServeEngine)

CFG = tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=32,
                  n_states=100)
REF_CFG = ref_tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=32,
                          n_states=100)
ENGINES = {"sync": (ServeEngine, ref_engine.ServeEngine),
           "async": (AsyncServeEngine, ref_engine.AsyncServeEngine)}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _model(seed=0, n=64, density=0.1):
    rng = np.random.default_rng(seed)
    inc = rng.random((CFG.n_clauses, CFG.n_literals)) < density
    ta = np.where(inc, CFG.n_states + 1, CFG.n_states).astype(np.int16)
    xs = (rng.random((n, CFG.n_features)) < 0.4).astype(np.uint8)
    return inc, ta, xs


def _engines(inc, kind, *, batcher=None, n_replicas=2, **kw):
    """The reference and the port engine of one kind on the same nominal
    pool (drawn by the reference)."""
    cls, ref_cls = ENGINES[kind]
    batcher = batcher or dict(max_batch=16, bucket_sizes=(8, 16))
    ref_pool = ref_replica.program_replica_pool(
        jnp.asarray(inc), jax.random.PRNGKey(7), n_replicas,
        ref_var.VariationConfig.nominal())
    ref = ref_cls(ref_pool, REF_CFG, ref_engine.EngineConfig(
        batcher=ref_batching.BatcherConfig(**batcher), **kw),
        key=jax.random.PRNGKey(3))
    pool = pool_from_numpy(np.asarray(ref_pool.r_stack), inc,
                           vcfg=var.VariationConfig.nominal(), device="cpu")
    port = cls(pool, CFG, EngineConfig(batcher=BatcherConfig(**batcher),
                                       **kw), device="cpu")
    return ref, port


def _same(got, want):
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert (g.pred, g.replica, g.expired, g.version) == \
            (w.pred, w.replica, w.expired, w.version)
        np.testing.assert_array_equal(g.class_sums, np.asarray(w.class_sums))


@pytest.mark.parametrize("kind", sorted(ENGINES))
@pytest.mark.parametrize("routing", ["round_robin", "ensemble"])
def test_async_engine_matches_digital_and_order(kind, routing):
    """Same responses as the reference engine and the digital TM, in
    submission order, with every issue collected by drain()."""
    inc, ta, xs = _model()
    ref, port = _engines(inc, kind, routing=routing)
    rids = port.submit_many(list(xs))
    ref.submit_many(list(xs))
    got = port.drain()
    _same(got, ref.drain())
    assert [r.rid for r in got] == rids
    assert getattr(port, "in_flight", 0) == 0
    digital = tm.forward(torch.from_numpy(ta), torch.from_numpy(xs), CFG)
    np.testing.assert_array_equal([r.pred for r in got],
                                  digital.argmax(-1).numpy())


def test_async_engine_double_buffers_and_reports_overlap():
    """Issues really stay outstanding (bounded by max_in_flight),
    result() collects on demand, and the overlap accounting lands in
    summary() with the reference's keys and counts."""
    inc, _, xs = _model(1)
    ref, eng = _engines(inc, "async", max_in_flight=2,
                        batcher=dict(max_batch=8, bucket_sizes=(8,)))
    depths, issued = [], []
    orig_issue, orig_dispatch = eng._issue, eng._dispatch

    def issue(b):
        depths.append(eng.in_flight)
        fl = orig_issue(b)
        issued.append(fl)
        return fl

    def dispatch(b):
        orig_dispatch(b)
        depths.append(eng.in_flight)

    eng._issue, eng._dispatch = issue, dispatch
    rids = eng.submit_many(list(xs[:32]))            # 4 batches of 8
    ref.submit_many(list(xs[:32]))
    eng.pump(force=True)
    assert 0 <= eng.in_flight <= 2
    assert max(depths) == 2                          # reached max_in_flight
    assert all(isinstance(fl, InFlight) and fl.event is None
               and fl.device_tensors == () for fl in issued)
    first = eng.result(rids[0])                      # on-demand collect
    assert first is not None and first.rid == rids[0]
    _same(eng.drain(), ref.drain())
    assert eng.in_flight == 0
    s, rs = eng.summary(), ref.summary()
    assert s["requests"] == rs["requests"] == 32
    assert s["batches"] == rs["batches"] == 4
    assert 0.0 <= s["overlap_fraction"] <= 1.0
    assert s["host_pack_s"] >= 0 and s["device_wait_s"] >= 0
    for k in ("replica_load_rows", "bytes_moved", "resident_bytes_moved",
              "padding_overhead"):
        assert s[k] == rs[k], k
    sync = ServeEngine(eng.pool, CFG, device="cpu")
    sync.submit_many(list(xs[:8]))
    sync.drain()
    assert "overlap_fraction" in sync.summary()


@pytest.mark.parametrize("depth", [0, -1])
def test_async_engine_validates_depth(depth):
    _, ta, _ = _model()
    with pytest.raises(ValueError, match="max_in_flight"):
        AsyncServeEngine.from_ta_state(
            ta_from_numpy(ta, CFG, device="cpu"), CFG,
            vcfg=var.VariationConfig.nominal(),
            ecfg=EngineConfig(max_in_flight=depth), device="cpu")


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_coalesced_engine_matches_offline_forward(kind):
    """A coalesced engine serves bit-exactly the offline weighted forward
    and the reference engine, on the plane-packed kernel's tier, with no
    fallback."""
    ccfg = co.CoalescedConfig(n_classes=4, n_clauses=24, n_features=32,
                              n_states=100)
    ref_ccfg = ref_co.CoalescedConfig(n_classes=4, n_clauses=24,
                                      n_features=32, n_states=100)
    rng = np.random.default_rng(11)
    inc = rng.random((24, 64)) < 0.08
    ta = np.where(inc, 101, 100).astype(np.int16)
    w = rng.integers(-5, 6, (24, 4)).astype(np.int32)
    x = (rng.random((20, 32)) < 0.4).astype(np.uint8)
    cls, ref_cls = ENGINES[kind]
    want = co.forward(torch.from_numpy(ta), torch.from_numpy(w),
                      torch.from_numpy(x), ccfg).numpy()
    with warnings.catch_warnings():
        warnings.simplefilter("error")           # any fallback = failure
        eng = cls(coalesced_pool_from_numpy(ta, w, ccfg, device="cpu"),
                  ccfg, device="cpu")
    ref = ref_cls.from_coalesced(jnp.asarray(ta), jnp.asarray(w), ref_ccfg)
    eng.submit_many(list(x))
    ref.submit_many(list(x))
    resps = eng.drain()
    _same(resps, ref.drain())
    np.testing.assert_array_equal(np.stack([r.class_sums for r in resps]),
                                  want)
    assert [r.pred for r in resps] == list(np.argmax(want, axis=-1))
    s = eng.summary()
    assert s["backend"] == "coalesced-cuda-packed2"
    assert s["packed_io"] and s["forward_fallbacks"] == []
    assert s["n_replicas"] == 1


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_drain_reaps_requests_expiring_mid_drain(kind):
    """Requests whose deadline passes BETWEEN two cuts of one drain come
    back ``expired=True``, as in the reference, never dispatched late."""
    inc, _, xs = _model(2)
    ref, eng = _engines(inc, kind,
                        batcher=dict(max_batch=8, bucket_sizes=(8,)))
    for e in (eng, ref):
        # Every dispatch takes 1 s of the engine's (fake) clock: longer
        # than the queued requests' 0.5 s deadline.
        e.clock = c = FakeClock()
        orig = e._dispatch

        def dispatch_and_tick(batch, orig=orig, c=c):
            orig(batch)
            c.advance(1.0)

        e._dispatch = dispatch_and_tick
    rids = [eng.submit(xs[i], deadline_s=0.5) for i in range(16)]
    for i in range(16):
        ref.submit(xs[i], deadline_s=0.5)
    got = eng.drain()
    _same(got, ref.drain())
    by_rid = {r.rid: r for r in got}
    assert [r for r in rids if not by_rid[r].expired] == rids[:8]
    for r in rids[8:]:
        assert by_rid[r].expired and by_rid[r].pred == -1
        np.testing.assert_array_equal(by_rid[r].class_sums,
                                      np.zeros(CFG.n_classes, np.int32))
    assert eng.summary()["expired"] == ref.summary()["expired"] == 8


@pytest.mark.parametrize("routing", ["round_robin", "ensemble"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_async_equals_sync_bit_for_bit_under_c2c(routing, depth):
    """C2C draws fresh noise every read; the generator draws in issue
    order, so the async engine's Responses equal the sync engine's on the
    same seed, at any depth."""
    _, ta, xs = _model(3, n=72, density=0.04)   # clauses fire often
    vcfg = var.VariationConfig(csa_offset=False)
    ecfg = EngineConfig(batcher=BatcherConfig(max_batch=16,
                                              bucket_sizes=(8, 16)),
                        routing=routing, max_in_flight=depth)
    out = {}
    for cls in (ServeEngine, AsyncServeEngine):
        eng = cls.from_ta_state(ta_from_numpy(ta, CFG, device="cpu"), CFG,
                                n_replicas=3, seed=9, vcfg=vcfg, ecfg=ecfg,
                                device="cpu")
        assert eng.backend.name == "analog-cuda-packed2"
        for lo in range(0, len(xs), 24):
            eng.submit_many(list(xs[lo:lo + 24]))
            eng.pump(force=True)
        out[cls.__name__] = eng.drain()
    got, want = out["AsyncServeEngine"], out["ServeEngine"]
    assert len(got) == len(xs)
    _same(got, want)
    sums = np.stack([r.class_sums for r in got])
    assert np.count_nonzero(sums) > sums.size // 4        # not all zeros


# ------------------------------------------- engine surface and clean-ups

def test_async_entry_points_raise_without_device_and_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inc, ta, _ = _model()
    pool = pool_from_numpy(
        np.where(inc, var.LRS_MEAN_OHM, var.HRS_MEAN_OHM)[None].astype(
            np.float32), inc, vcfg=var.VariationConfig.nominal(),
        device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AsyncServeEngine(pool, CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AsyncServeEngine.from_ta_state(torch.from_numpy(ta), CFG)
    assert AsyncServeEngine(pool, CFG, device="cpu").device.type == "cpu"


def test_use_kernel_maps_to_a_backend_with_a_warning():
    _, ta, _ = _model()
    t = ta_from_numpy(ta, CFG, device="cpu")
    nominal = var.VariationConfig.nominal()
    for flag, name in ((True, "analog-cuda"), (False, "analog-torch")):
        with pytest.warns(DeprecationWarning, match="use_kernel"):
            eng = ServeEngine.from_ta_state(
                t, CFG, vcfg=nominal, device="cpu",
                ecfg=EngineConfig(use_kernel=flag))
        assert eng.backend.name == name and not eng.selection.fell_back
    with pytest.warns(DeprecationWarning), \
            pytest.raises(ValueError, match="not both"):
        ServeEngine.from_ta_state(t, CFG, vcfg=nominal, device="cpu",
                                  ecfg=EngineConfig(use_kernel=True,
                                                    backend="analog-cuda"))


def test_pools_supply_their_ladder_and_routes():
    """The engine takes its default tier and its routed states from the
    pool, for both pool kinds."""
    inc, ta, _ = _model()
    t = ta_from_numpy(ta, CFG, device="cpu")
    nominal = var.VariationConfig.nominal()
    for kw, name in (({}, "analog-cuda-packed2"),
                     ({"pack_planes": False}, "analog-cuda-packed"),
                     ({"packed": False}, "analog-cuda")):
        eng = ServeEngine.from_ta_state(t, CFG, n_replicas=3, vcfg=nominal,
                                        ecfg=EngineConfig(**kw),
                                        device="cpu")
        assert eng.backend.name == eng.pool.default_backend(eng.state) \
            == name
        assert len(eng._slices) == 3
        assert all(s.r_stack.shape[0] == 1 for s in eng._slices)
    ccfg = co.CoalescedConfig(n_classes=4, n_clauses=24, n_features=32)
    rng = np.random.default_rng(2)
    cta = np.where(rng.random((24, 64)) < 0.1, 200, 100).astype(np.int16)
    w = rng.integers(-3, 4, (24, 4)).astype(np.int32)
    for kw, name in (({}, "coalesced-cuda-packed2"),
                     ({"pack_planes": False}, "coalesced-cuda-packed"),
                     ({"packed": False}, "coalesced-cuda")):
        eng = ServeEngine(coalesced_pool_from_numpy(cta, w, ccfg,
                                                    device="cpu"),
                          ccfg, EngineConfig(**kw), device="cpu")
        assert eng.backend.name == name
        assert eng._slices == [eng.state]


def test_states_build_their_combine_matrix_once():
    """Digital and coalesced states carry the ``[C, M]`` combine matrix
    from construction; packing keeps the same tensor, a re-programmed or
    injured coalesced state builds its own, and every fused backend that
    reads it gives the plain backend's sums (exact)."""
    from repro_torch import api
    from repro_torch.kernels import ops
    inc, _, xs = _model(5)
    inc[3] = False
    t_inc = torch.from_numpy(inc)
    st = api.DigitalState.from_include(t_inc, CFG)
    assert torch.equal(st.combine, ops.polarity_matrix(CFG, t_inc))
    assert st.pack().combine is st.combine
    lits = tm.literals(torch.from_numpy(xs))
    want = api.class_sums(st, lits, backend="digital-torch")
    for backend in ("digital-cuda", "digital-cuda-packed"):
        assert torch.equal(api.class_sums(st.pack(), lits, backend=backend),
                           want)
    ccfg = co.CoalescedConfig(n_classes=4, n_clauses=CFG.n_clauses,
                              n_features=32)
    cta = torch.from_numpy(np.where(inc, 200, 100).astype(np.int16))
    w = torch.from_numpy(np.random.default_rng(6).integers(
        -5, 6, (CFG.n_clauses, 4)).astype(np.int32))
    cs = api.CoalescedState(ta_state=cta, weights=w, cfg=ccfg)
    assert torch.equal(cs.combine, ops.coalesced_combine(w, t_inc.any(-1)))
    planes = cs.pack_planes()
    assert planes.combine is cs.combine and planes.pack().combine is \
        cs.combine
    want = api.class_sums(cs, lits, backend="coalesced")
    for backend in ("coalesced-cuda", "coalesced-cuda-packed",
                    "coalesced-cuda-packed2"):
        assert torch.equal(api.class_sums(planes, lits, backend=backend),
                           want)
    cta2 = torch.from_numpy(np.where(~inc, 200, 100).astype(np.int16))
    moved = cs.reprogram(cta2, w)
    assert torch.equal(moved.combine,
                       ops.coalesced_combine(w, (~t_inc).any(-1)))
    hurt = cs.inject_faults(torch.Generator().manual_seed(0),
                            var.FaultConfig(stuck_lrs_rate=0.3))
    assert torch.equal(hurt.combine, ops.coalesced_combine(
        w, hurt.include.any(-1)))
