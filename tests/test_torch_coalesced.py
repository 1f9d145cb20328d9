"""Port parity for the coalesced TM: ``repro_torch.core.coalesced``,
``CoalescedState``, the coalesced backends and
``ServeEngine.from_coalesced`` against ``repro`` on numpy-seeded inputs,
exactly.  The reference runs its Pallas kernels in interpret mode, so
shapes are small.
"""

import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.core import coalesced as ref_co  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro.kernels import bitpack as ref_bitpack  # noqa: E402
from repro.serve import batching as ref_batching  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import coalesced as co  # noqa: E402
from repro_torch.core import tm  # noqa: E402
from repro_torch.kernels import bitpack  # noqa: E402
from repro_torch.serve import batching, engine, replica  # noqa: E402

SHAPES = [(4, 24, 32), (3, 37, 50), (2, 5, 3)]     # (M, C, F)


def _cfgs(m, c, f, **kw):
    return (co.CoalescedConfig(n_classes=m, n_clauses=c, n_features=f,
                               n_states=100, **kw),
            ref_co.CoalescedConfig(n_classes=m, n_clauses=c, n_features=f,
                                   n_states=100, **kw))


def _model(cfg, seed, n=20):
    """TA states with ~8 % includes, at least one in every clause but
    clause 1 (empty); weights in [-127, 127] with a bias toward each
    clause's own class; Boolean requests."""
    rng = np.random.default_rng(seed)
    inc = rng.random((cfg.n_clauses, cfg.n_literals)) < 0.08
    inc[np.arange(cfg.n_clauses),
        rng.integers(0, cfg.n_literals, cfg.n_clauses)] = True
    inc[1] = False
    ta = np.where(inc, cfg.n_states + 1 + rng.integers(0, 50, inc.shape),
                  rng.integers(1, cfg.n_states + 1, inc.shape))
    w = rng.integers(-127, 64, (cfg.n_clauses, cfg.n_classes))
    own = np.arange(cfg.n_clauses) % cfg.n_classes
    w[np.arange(cfg.n_clauses), own] = rng.integers(64, 128, cfg.n_clauses)
    x = (rng.random((n, cfg.n_features)) < 0.4).astype(np.uint8)
    return ta.astype(np.int16), w.astype(np.int32), x


# --------------------------------------------------- config validation

def test_config_rejects_single_class():
    with pytest.raises(ValueError, match="n_classes must be >= 2"):
        co.CoalescedConfig(n_classes=1, n_clauses=4, n_features=4)


def test_config_rejects_max_weight_overflowing_state_dtype():
    with pytest.raises(ValueError, match="does not fit state_dtype"):
        co.CoalescedConfig(n_classes=2, n_clauses=4, n_features=4,
                           state_dtype=torch.int8, n_states=10,
                           max_weight=1000)


def test_config_rejects_states_overflowing_state_dtype():
    with pytest.raises(ValueError, match="TA states span"):
        co.CoalescedConfig(n_classes=2, n_clauses=4, n_features=4,
                           state_dtype=torch.int8, n_states=127)


def test_config_rejects_degenerate_sizes():
    with pytest.raises(ValueError, match="must both be >= 1"):
        co.CoalescedConfig(n_classes=2, n_clauses=0, n_features=4)
    with pytest.raises(ValueError, match="max_weight must be >= 1"):
        co.CoalescedConfig(n_classes=2, n_clauses=4, n_features=4,
                           max_weight=0)


def test_valid_config_still_constructs():
    cfg = co.CoalescedConfig(n_classes=2, n_clauses=4, n_features=4,
                             state_dtype=torch.int8, n_states=50,
                             max_weight=100)
    assert cfg.n_ta == 4 * 8
    got, want = _cfgs(3, 7, 5)
    assert (got.n_literals, got.n_ta) == (want.n_literals, want.n_ta)


# ------------------------------------------------------ forward, state

@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_predict_match_reference(shape):
    cfg, ref_cfg = _cfgs(*shape)
    ta, w, x = _model(cfg, seed=sum(shape))
    t = (torch.from_numpy(ta), torch.from_numpy(w), torch.from_numpy(x))
    got = co.forward(*t, cfg)
    want = np.asarray(ref_co.forward(jnp.asarray(ta), jnp.asarray(w),
                                     jnp.asarray(x), ref_cfg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.count_nonzero(want) > 0
    np.testing.assert_array_equal(
        co.predict(*t, cfg).numpy(),
        np.asarray(ref_co.predict(jnp.asarray(ta), jnp.asarray(w),
                                  jnp.asarray(x), ref_cfg)))
    y = want.argmax(-1)
    assert float(co.accuracy(*t, torch.from_numpy(y), cfg)) == 1.0


@pytest.mark.parametrize("training", (False, True))
def test_clause_outputs_match_reference(training):
    cfg, ref_cfg = _cfgs(4, 24, 32)
    ta, _, x = _model(cfg, seed=5)
    got = co.clause_outputs(torch.from_numpy(ta),
                            tm.literals(torch.from_numpy(x)), cfg,
                            training=training).numpy()
    want = np.asarray(ref_co.clause_outputs(
        jnp.asarray(ta), ref_tm.literals(jnp.asarray(x)), ref_cfg,
        training=training))
    np.testing.assert_array_equal(got, want)
    assert (got[:, 1] == (1 if training else 0)).all()   # the empty clause


def test_state_pack_planes_and_surface():
    cfg, _ = _cfgs(4, 24, 32)
    ta, w, _ = _model(cfg, seed=6)
    st = api.CoalescedState(ta_state=torch.from_numpy(ta),
                            weights=torch.from_numpy(w), cfg=cfg)
    assert not st.packed and not st.plane_packed
    pp = st.pack_planes()
    assert pp.packed and pp.plane_packed
    assert pp.plane_index is pp.include_packed           # one shared buffer
    assert pp.pack_planes() is pp and pp.pack() is pp     # idempotent
    np.testing.assert_array_equal(
        bitpack.words_to_numpy(pp.plane_index),
        ref_bitpack.pack_bits_np(ta > cfg.n_states))
    assert torch.equal(st.include, torch.from_numpy(ta > cfg.n_states))
    assert (st.n_classes, st.n_clauses, st.n_literals) == (4, 24, 64)
    assert st.device.type == "cpu"
    need = api.required_capabilities(st)
    assert {api.CAP_COALESCED, api.CAP_DIGITAL} <= need


def test_selection_ladder_for_coalesced_states():
    """Plane-packed -> packed2 kernel, packed -> packed kernel, unpacked
    -> dense kernel; a packed backend is never offered an unpacked
    state, and no analog or digital backend serves a coalesced one."""
    cfg, _ = _cfgs(2, 4, 4)
    ta, w, _ = _model(cfg, seed=7)
    state = api.CoalescedState(ta_state=torch.from_numpy(ta),
                               weights=torch.from_numpy(w), cfg=cfg)
    for st, name in ((state, "coalesced-cuda"),
                     (state.pack(), "coalesced-cuda-packed"),
                     (state.pack_planes(), "coalesced-cuda-packed2")):
        sel = api.select_backend(st)
        assert sel.backend.name == name and not sel.fell_back
    bad = api.select_backend(state, prefer="coalesced-cuda-packed")
    assert bad.fell_back and "coalesced-cuda-packed" in bad.fallback_reason
    for other in ("analog-cuda-packed2", "digital-cuda"):
        sel = api.select_backend(state, prefer=other)
        assert sel.fell_back and sel.backend.name.startswith("coalesced")


@pytest.mark.parametrize("backend", ("coalesced", "coalesced-cuda",
                                     "coalesced-cuda-packed",
                                     "coalesced-cuda-packed2"))
def test_backends_match_reference_backend_family(backend):
    cfg, ref_cfg = _cfgs(3, 37, 50)
    ta, w, x = _model(cfg, seed=8, n=17)
    state = api.CoalescedState(ta_state=torch.from_numpy(ta),
                               weights=torch.from_numpy(w), cfg=cfg)
    state = state.pack_planes() if backend.endswith("packed2") else (
        state.pack() if backend.endswith("packed") else state)
    got = api.class_sums(state, tm.literals(torch.from_numpy(x)),
                         backend=backend)
    ref_state = ref_api.CoalescedState(ta_state=jnp.asarray(ta),
                                       weights=jnp.asarray(w), cfg=ref_cfg)
    want = ref_api.class_sums(ref_state.pack_planes(),
                              ref_tm.literals(jnp.asarray(x)),
                              backend="coalesced-pallas-packed2")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_empty_pool_sums_to_zero():
    cfg, _ = _cfgs(2, 4, 4)
    state = api.CoalescedState(
        ta_state=torch.full((4, 8), cfg.n_states, dtype=torch.int16),
        weights=torch.ones((4, 2), dtype=torch.int32), cfg=cfg)
    lits = tm.literals(torch.ones((3, 4), dtype=torch.uint8))
    for st, name in ((state, "coalesced-cuda"),
                     (state.pack(), "coalesced-cuda-packed"),
                     (state.pack_planes(), "coalesced-cuda-packed2")):
        assert not api.class_sums(st, lits, backend=name).any()


# ---------------------------------------------------------------- engine

def _engines(cfg, ref_cfg, ta, w, **ecfg_kw):
    bkw = dict(max_batch=8, bucket_sizes=(8,))
    ref = ref_engine.ServeEngine.from_coalesced(
        jnp.asarray(ta), jnp.asarray(w), ref_cfg,
        ecfg=ref_engine.EngineConfig(
            batcher=ref_batching.BatcherConfig(**bkw), **ecfg_kw))
    pool = convert.coalesced_pool_from_numpy(ta, w, cfg, device="cpu")
    port = engine.ServeEngine(
        pool, cfg, engine.EngineConfig(batcher=batching.BatcherConfig(**bkw),
                                       **ecfg_kw), device="cpu")
    return ref, port


@pytest.mark.parametrize("ecfg_kw,backend", [
    ({}, "coalesced-cuda-packed2"),
    ({"routing": "ensemble"}, "coalesced-cuda-packed2"),
    ({"pack_planes": False}, "coalesced-cuda-packed"),
    ({"pack_planes": False, "routing": "ensemble"}, "coalesced-cuda-packed"),
    ({"packed": False}, "coalesced-cuda"),
    ({"packed": False, "routing": "ensemble"}, "coalesced-cuda"),
    ({"backend": "coalesced"}, "coalesced"),
])
def test_engine_matches_reference_engine(ecfg_kw, backend):
    cfg, ref_cfg = _cfgs(4, 24, 32)
    ta, w, x = _model(cfg, seed=9, n=21)
    with warnings.catch_warnings():
        warnings.simplefilter("error")                 # any fallback fails
        ref, port = _engines(cfg, ref_cfg, ta, w, **ecfg_kw)
    assert port.backend.name == backend and not port.selection.fell_back
    assert ref.backend.name == backend.replace("cuda", "pallas")
    ref.submit_many(list(x))
    port.submit_many(list(x))
    want, got = ref.drain(), port.drain()
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, r in zip(got, want):
        assert g.pred == r.pred and g.replica == r.replica
        np.testing.assert_array_equal(g.class_sums, r.class_sums)
    sums = np.stack([r.class_sums for r in got])
    offline = co.forward(torch.from_numpy(ta), torch.from_numpy(w),
                         torch.from_numpy(x), cfg).numpy()
    np.testing.assert_array_equal(sums, offline)
    assert np.count_nonzero(sums) > sums.size // 4
    s, rs = port.summary(), ref.summary()
    for k in ("requests", "batches", "padding_overhead", "bytes_moved",
              "resident_bytes_moved", "fallback_dispatches",
              "forward_fallbacks", "replica_load_rows", "plane_packed",
              "packed_io", "n_replicas", "hardware"):
        assert s[k] == rs[k], k
    assert s["n_replicas"] == 1 and s["hardware"]["energy_nj_per_dp"] > 0


def test_from_coalesced_serves_offline_forward():
    cfg, _ = _cfgs(4, 24, 32)
    ta, w, x = _model(cfg, seed=10, n=12)
    eng = engine.ServeEngine.from_coalesced(
        torch.from_numpy(ta), torch.from_numpy(w), cfg, device="cpu")
    assert eng.backend.name == engine.DEFAULT_COALESCED_PLANES_BACKEND
    assert isinstance(eng.pool, replica.CoalescedPool)
    eng.submit_many(list(x))
    out = eng.drain()
    want = co.forward(torch.from_numpy(ta), torch.from_numpy(w),
                      torch.from_numpy(x), cfg).numpy()
    np.testing.assert_array_equal(np.stack([r.class_sums for r in out]),
                                  want)
    assert [r.pred for r in out] == list(want.argmax(-1))
    assert {r.replica for r in out} == {0}


def test_coalesced_pool_surface():
    cfg, _ = _cfgs(4, 24, 32)
    ta, w, _ = _model(cfg, seed=11)
    pool = convert.coalesced_pool_from_numpy(ta, w, cfg, device="cpu")
    assert pool.n_replicas == 1 and pool.version == 0
    assert not (pool.vcfg.c2c or pool.vcfg.csa_offset or pool.vcfg.d2d)
    assert pool.include.shape == (cfg.n_clauses, cfg.n_literals)
    assert pool.router().n_replicas == 1
    assert pool.ta_state.dtype == cfg.state_dtype
    assert pool.weights.dtype == torch.int32
    st = pool.state()
    assert st.cfg == cfg and st.n_classes == cfg.n_classes
    assert pool.state(cfg).cfg == cfg
    with pytest.raises(ValueError, match="must match"):
        pool.state(dataclasses.replace(cfg, n_states=50))
    assert pool.to("cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="TA state"):
        convert.coalesced_pool_from_numpy(ta[:-1], w, cfg, device="cpu")
    with pytest.raises(ValueError, match="weights"):
        convert.coalesced_pool_from_numpy(ta, w[:, :-1], cfg, device="cpu")
