"""Port parity for streaming serving: ``repro_torch.core.booleanize``,
``repro_torch.serve.stream`` and the window functions of
``repro_torch.data.tm_datasets``, against ``repro.core.booleanize`` /
``repro.serve.stream``.

The ports of ``tests/test_stream.py`` (every case but the sharded-mesh
one, which waits for the port's multi-device slice), of
``tests/test_booleanize_properties.py``, of the anomaly and stream-config
cases of ``tests/test_qos.py``, of ``tests/test_swap.py``'s sessions
riding through a hot swap and of ``tests/test_health.py``'s streaming
chaos loop.  Frames, TA states and coalesced weights are drawn with
numpy; the reference fits each booleanizer and the port receives its
thresholds (``booleanizer_from_numpy``) and TA state (``ta_from_numpy``),
so both packages stream the same frames through the same model.  Every
comparison is exact: emitted rows, thresholds, decisions (pred, keyword,
votes, index, version) and margins.  The reference's Pallas kernels run
in interpret mode; shapes are small.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import booleanize as ref_bz  # noqa: E402
from repro.core import coalesced as ref_co  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro.core import variations as ref_var  # noqa: E402
from repro.data import tm_datasets as ref_data  # noqa: E402
from repro.serve import batching as ref_batching  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve import health as ref_health  # noqa: E402
from repro.serve import replica as ref_replica  # noqa: E402
from repro.serve import stream as ref_stream  # noqa: E402
from repro.serve import swap as ref_swap  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.convert import (booleanizer_from_numpy,  # noqa: E402
                                 coalesced_pool_from_numpy, pool_from_numpy,
                                 ta_from_numpy)
from repro_torch.core import coalesced as co  # noqa: E402
from repro_torch.core import tm  # noqa: E402
from repro_torch.core import variations as var  # noqa: E402
from repro_torch.core.booleanize import (Booleanizer,  # noqa: E402
                                         StreamingBooleanizer, binarize,
                                         fit_quantile, fit_uniform)
from repro_torch.data.tm_datasets import (kws6_windows,  # noqa: E402
                                          sensor_anomaly_windows,
                                          synthetic_sensor_anomaly)
from repro_torch.serve import (QOS_BULK, QOS_LATENCY,  # noqa: E402
                               AsyncServeEngine, BatcherConfig, EngineConfig,
                               HealthConfig, HealthProbe, QueueFull,
                               RepairConfig, RepairPolicy, ServeEngine,
                               StreamConfig, StreamServer, majority_vote,
                               margin_of)

MELS, BITS, WINDOW, HOP, VOTE = 6, 2, 4, 2, 3
CFG = tm.TMConfig(n_classes=6, clauses_per_class=6,
                  n_features=WINDOW * MELS * BITS, n_states=100)
REF_CFG = ref_tm.TMConfig(n_classes=6, clauses_per_class=6,
                          n_features=WINDOW * MELS * BITS, n_states=100)
BATCHER = dict(max_batch=16, bucket_sizes=(8, 16))
ENGINES = {"sync": (ServeEngine, ref_engine.ServeEngine),
           "async": (AsyncServeEngine, ref_engine.AsyncServeEngine)}
NOMINAL = (var.VariationConfig.nominal(), ref_var.VariationConfig.nominal())


def _sparse_ta(cfg, seed, density=0.1):
    rng = np.random.default_rng(seed)
    inc = rng.random((cfg.n_clauses, cfg.n_literals)) < density
    return np.where(inc, cfg.n_states + 1, cfg.n_states).astype(np.int16)


@pytest.fixture(scope="module")
def kws():
    """Eight numpy-drawn utterances of 24 frames over MELS bins (a class
    bump per utterance plus noise), the reference's quantile booleanizer
    and its port, and a sparse TA state at the stream's width."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 6, 8)
    bump = np.exp(-0.5 * ((np.arange(MELS) - labels[:, None]) / 1.2) ** 2)
    frames = (bump[:, None, :] + 0.5 * rng.normal(size=(8, 24, MELS))
              ).astype(np.float32)
    ref_b = ref_bz.fit_quantile(frames.reshape(-1, MELS), bits=BITS)
    return dict(frames=frames, labels=labels, ref_b=ref_b,
                b=booleanizer_from_numpy(np.asarray(ref_b.thresholds),
                                         device="cpu"),
                ta=_sparse_ta(CFG, 5, density=0.03))


def _engines(kws, kind="sync", routing="round_robin", ta=None, **ecfg_kw):
    """The reference engine and the port engine on the same nominal pool
    (2 chips) of the same TA state."""
    cls, ref_cls = ENGINES[kind]
    ta = kws["ta"] if ta is None else ta
    ref = ref_cls.from_ta_state(
        jnp.asarray(ta), REF_CFG, n_replicas=2, key=jax.random.PRNGKey(3),
        vcfg=NOMINAL[1], ecfg=ref_engine.EngineConfig(
            batcher=ref_batching.BatcherConfig(**BATCHER), routing=routing,
            **ecfg_kw))
    port = cls.from_ta_state(
        ta_from_numpy(ta, CFG, device="cpu"), CFG, n_replicas=2, seed=3,
        vcfg=NOMINAL[0], ecfg=EngineConfig(
            batcher=BatcherConfig(**BATCHER), routing=routing, **ecfg_kw),
        device="cpu")
    return ref, port


def _servers(kws, scfg_kw=None, **engine_kw):
    scfg_kw = dict(dict(window=WINDOW, hop=HOP, vote=VOTE), **(scfg_kw or {}))
    ref, port = _engines(kws, **engine_kw)
    return (ref_stream.StreamServer(ref, kws["ref_b"],
                                    ref_stream.StreamConfig(**scfg_kw)),
            StreamServer(port, kws["b"], StreamConfig(**scfg_kw)))


def feed_stream(server, sid, stream, chunk):
    for lo in range(0, len(stream), chunk):
        server.feed(sid, stream[lo:lo + chunk])
        server.pump()
    server.drain()


def _decisions(sess):
    return [(d.index, d.pred, d.keyword, d.votes, d.version, d.margin)
            for d in sess.decisions]


def _same_decisions(port_server, ref_server, sid):
    got = _decisions(port_server.sessions[sid])
    assert got == _decisions(ref_server.sessions[sid]), sid
    return got


def _stream(kws, n):
    return kws["frames"].reshape(-1, MELS)[:n]


# ------------------------------------------------- the booleanizers

def test_fitted_thresholds_equal_the_reference(kws):
    """Both fitters give the reference's float32 thresholds bit for bit,
    and ``transform`` the reference's bits."""
    x = kws["frames"].reshape(-1, MELS)
    for fit, ref_fit in ((fit_quantile, ref_bz.fit_quantile),
                         (fit_uniform, ref_bz.fit_uniform)):
        b, rb = fit(x, 3, device="cpu"), ref_fit(x, 3)
        assert b.thresholds.dtype == torch.float32
        np.testing.assert_array_equal(b.thresholds.numpy(),
                                      np.asarray(rb.thresholds))
        np.testing.assert_array_equal(b.transform(x).numpy(),
                                      np.asarray(rb.transform(jnp.asarray(x))))
        assert (b.bits_per_feature, b.n_boolean_features) == \
            (rb.bits_per_feature, rb.n_boolean_features)
    np.testing.assert_array_equal(
        binarize(torch.from_numpy(x)).numpy(),
        np.asarray(ref_bz.binarize(jnp.asarray(x))))


def test_streaming_booleanizer_chunking_invariance(kws):
    """Any chunking emits exactly the offline rows, which are the
    reference windower's rows."""
    sb = StreamingBooleanizer(kws["b"], WINDOW, HOP)
    stream = _stream(kws, 50)
    offline = sb.transform_offline(stream)
    assert offline.shape == ((50 - WINDOW) // HOP + 1,
                             sb.n_boolean_features)
    np.testing.assert_array_equal(offline, ref_bz.StreamingBooleanizer(
        kws["ref_b"], WINDOW, HOP).transform_offline(stream))
    for chunks in ([1] * 50, [3, 7, 1, 19, 20], [50], [5] * 10):
        sb2 = StreamingBooleanizer(kws["b"], WINDOW, HOP)
        rows, lo = [], 0
        for c in chunks:
            rows.append(sb2.push(stream[lo:lo + c]))
            lo += c
        np.testing.assert_array_equal(np.concatenate(rows), offline)
    sb3 = StreamingBooleanizer(kws["b"], WINDOW, HOP)
    np.testing.assert_array_equal(
        np.concatenate([sb3.push(f) for f in stream]), offline)


def test_streaming_booleanizer_hop_geometries(kws):
    """hop > window (gaps), hop == window (tumbling): streamed == offline
    == the reference's, and the ring buffer never outgrows one window."""
    stream = _stream(kws, 40)
    for window, hop in ((3, 5), (4, 4), (1, 1), (5, 2)):
        sb = StreamingBooleanizer(kws["b"], window, hop)
        off = sb.transform_offline(stream)
        got = []
        for f in stream:
            got.append(sb.push(f))
            assert sb.frames_buffered <= max(window, hop)
        np.testing.assert_array_equal(np.concatenate(got), off)
        np.testing.assert_array_equal(off, ref_bz.StreamingBooleanizer(
            kws["ref_b"], window, hop).transform_offline(stream))


def test_streaming_booleanizer_validates(kws):
    with pytest.raises(ValueError, match="window and hop"):
        StreamingBooleanizer(kws["b"], 0, 1)
    sb = StreamingBooleanizer(kws["b"], 4, 2)
    with pytest.raises(ValueError, match="frames"):
        sb.push(np.zeros((3, MELS + 1)))
    out = sb.push(np.zeros((2, MELS)))       # no window yet
    assert out.shape == (0, sb.n_boolean_features)
    sb.reset()
    assert sb.frames_buffered == 0
    with pytest.raises(ValueError, match=r"\[F, K\]"):
        booleanizer_from_numpy(np.zeros(3), device="cpu")


def test_streaming_matches_per_frame_booleanizer(kws):
    """Row t is the plain Booleanizer's bits of window t's frames, in the
    port (torch) and the reference (jnp)."""
    stream = _stream(kws, 12)
    rows = StreamingBooleanizer(kws["b"], WINDOW, HOP).transform_offline(
        stream)
    per_frame = kws["b"].transform(torch.from_numpy(stream)).numpy()
    np.testing.assert_array_equal(
        per_frame, np.asarray(kws["ref_b"].transform(jnp.asarray(stream))))
    for t in range(rows.shape[0]):
        np.testing.assert_array_equal(
            rows[t], per_frame[t * HOP:t * HOP + WINDOW].reshape(-1))


def test_fit_uniform_windower_also_roundtrips(kws):
    x = kws["frames"].reshape(-1, MELS)
    b = fit_uniform(x, bits=3, device="cpu")
    sb = StreamingBooleanizer(b, 3, 3)
    stream = x[:20]
    got = np.concatenate([sb.push(f) for f in stream])
    np.testing.assert_array_equal(got, sb.transform_offline(stream))
    np.testing.assert_array_equal(got, ref_bz.StreamingBooleanizer(
        ref_bz.fit_uniform(x, bits=3), 3, 3).transform_offline(stream))


def test_kws6_windows_labels_follow_utterances(kws):
    sb = StreamingBooleanizer(kws["b"], WINDOW, HOP)
    rows, ys = kws6_windows(kws["frames"][:4], kws["labels"][:4], sb)
    per_utt = (24 - WINDOW) // HOP + 1
    assert rows.shape == (4 * per_utt, sb.n_boolean_features)
    assert ys.dtype == np.int64
    np.testing.assert_array_equal(ys, np.repeat(kws["labels"][:4], per_utt))
    ref_rows, ref_ys = ref_data.kws6_windows(
        kws["frames"][:4], kws["labels"][:4],
        ref_bz.StreamingBooleanizer(kws["ref_b"], WINDOW, HOP))
    np.testing.assert_array_equal(rows, ref_rows)
    np.testing.assert_array_equal(ys, ref_ys)


# --------------------------------- booleanizer properties (hypothesis)

def _data(seed, n, f, constant_cols=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)) * rng.uniform(0.1, 3.0, size=f)
    if constant_cols:
        x[:, 0] = 1.234                    # degenerate feature
    return x.astype(np.float64)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(4, 60),
       f=st.integers(1, 8), bits=st.integers(1, 8),
       constant=st.booleans())
def test_fit_thresholds_ascending(seed, n, f, bits, constant):
    """Both fitters yield ascending per-feature thresholds (constant
    features included), equal to the reference's bit for bit."""
    x = _data(seed, n, f, constant_cols=constant)
    for fit, ref_fit in ((fit_quantile, ref_bz.fit_quantile),
                         (fit_uniform, ref_bz.fit_uniform)):
        thr = fit(x, bits, device="cpu").thresholds.numpy()
        assert thr.shape == (f, bits)
        if bits > 1:
            assert (np.diff(thr, axis=1) >= 0).all(), fit.__name__
        np.testing.assert_array_equal(thr, np.asarray(ref_fit(x, bits)
                                                      .thresholds))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(4, 40),
       f=st.integers(1, 6), bits=st.integers(1, 6))
def test_transform_rows_are_descending_prefixes(seed, n, f, bits):
    """Within a feature's K bits the ones come first, and their count is
    the number of thresholds strictly below the value."""
    x = _data(seed, n, f)
    b = fit_quantile(x, bits, device="cpu")
    out = b.transform(torch.from_numpy(x.astype(np.float32))).numpy()
    assert out.shape == (n, f * bits) and out.dtype == np.uint8
    per_feat = out.reshape(n, f, bits).astype(int)
    np.testing.assert_array_equal(per_feat, -np.sort(-per_feat, axis=-1))
    thr = b.thresholds.numpy()
    want = (np.float32(x)[:, :, None] > thr[None]).sum(-1)
    np.testing.assert_array_equal(per_feat.sum(-1), want)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(4, 30),
       f=st.integers(1, 5), bits=st.integers(1, 5),
       delta=st.floats(0.0, 2.0))
def test_transform_bit_count_monotone_in_input(seed, n, f, bits, delta):
    """x -> x + delta (delta >= 0) never clears a thermometer bit."""
    x = _data(seed, n, f)
    b = fit_quantile(x, bits, device="cpu")
    lo = b.transform(x.astype(np.float32)).numpy()
    hi = b.transform((x + delta).astype(np.float32)).numpy()
    assert (hi >= lo).all()


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**16), t=st.integers(1, 40),
       f=st.integers(1, 4), bits=st.integers(1, 3),
       window=st.integers(1, 6), hop=st.integers(1, 7),
       cuts=st.lists(st.integers(0, 40), max_size=6))
def test_streaming_equals_offline_for_any_chunking(seed, t, f, bits,
                                                   window, hop, cuts):
    """Any chunk boundaries emit exactly the offline rows, for any
    (window, hop) and streams shorter than a window; the rows are the
    reference windower's."""
    x = _data(seed, max(t, 2), f)
    b = fit_quantile(x, bits, device="cpu")
    stream = _data(seed + 1, t, f)
    sb = StreamingBooleanizer(b, window, hop)
    offline = sb.transform_offline(stream)
    n_expect = 0 if t < window else 1 + (t - window) // hop
    assert offline.shape == (n_expect, window * f * bits)
    np.testing.assert_array_equal(offline, ref_bz.StreamingBooleanizer(
        ref_bz.fit_quantile(x, bits), window, hop).transform_offline(stream))
    bounds = sorted({min(c, t) for c in cuts} | {0, t})
    sb2 = StreamingBooleanizer(b, window, hop)
    got = [sb2.push(stream[a:z]) for a, z in zip(bounds, bounds[1:])]
    got = (np.concatenate(got) if got
           else np.zeros((0, sb2.n_boolean_features), np.uint8))
    np.testing.assert_array_equal(got, offline)
    assert sb2.frames_buffered <= max(window, hop)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**16), t=st.integers(2, 24),
       f=st.integers(1, 4), window=st.integers(1, 5),
       hop=st.integers(1, 5))
def test_streaming_bits_match_torch_transform(seed, t, f, window, hop):
    """The numpy windower and the tensor ``Booleanizer.transform`` agree
    bit for bit, frame by frame."""
    x = _data(seed, max(t, 4), f)
    b = fit_quantile(x, 3, device="cpu")
    stream = _data(seed + 1, t, f).astype(np.float32)
    rows = StreamingBooleanizer(b, window, hop).transform_offline(stream)
    per_frame = b.transform(torch.from_numpy(stream)).numpy()
    for i in range(rows.shape[0]):
        np.testing.assert_array_equal(
            rows[i], per_frame[i * hop:i * hop + window].reshape(-1))


# --------------------------------------------- streamed == offline

@pytest.mark.parametrize("kind", sorted(ENGINES))
@pytest.mark.parametrize("routing", ["round_robin", "ensemble"])
def test_streamed_equals_offline_batched(kws, kind, routing):
    """Per-window streamed predictions equal the reference's streamed
    decisions, offline ``api.predict`` over the same windows and the
    digital TM, for both engines and both routings."""
    ref_server, server = _servers(kws, kind=kind, routing=routing)
    stream = _stream(kws, 60)
    for s in (server, ref_server):
        feed_stream(s, "u0", stream, chunk=5)
    got = _same_decisions(server, ref_server, "u0")
    assert server.sessions["u0"].backlog == 0
    streamed = np.array([g[1] for g in got])
    rows = StreamingBooleanizer(kws["b"], WINDOW, HOP).transform_offline(
        stream)
    assert len(streamed) == len(rows)
    eng = server.engine
    offline = api.predict(eng.state, torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(streamed, offline)
    digital = tm.predict(torch.from_numpy(kws["ta"]),
                         torch.from_numpy(rows), CFG).numpy()
    np.testing.assert_array_equal(streamed, digital)
    assert len(set(streamed.tolist())) > 1        # not a constant stream


def test_coalesced_engine_streams_bit_exact(kws):
    """A coalesced engine streams unchanged: per-window predictions equal
    the reference's and offline ``core.coalesced.predict``, on the packed
    fused tier with no fallback."""
    ccfg = co.CoalescedConfig(n_classes=6, n_clauses=18,
                              n_features=WINDOW * MELS * BITS, n_states=100)
    ref_ccfg = ref_co.CoalescedConfig(n_classes=6, n_clauses=18,
                                      n_features=WINDOW * MELS * BITS,
                                      n_states=100)
    rng = np.random.default_rng(7)
    inc = rng.random((ccfg.n_clauses, ccfg.n_literals)) < 0.1
    ta = np.where(inc, ccfg.n_states + 1, ccfg.n_states).astype(np.int16)
    w = rng.integers(-ccfg.max_weight, ccfg.max_weight + 1,
                     (ccfg.n_clauses, ccfg.n_classes)).astype(np.int32)
    ecfg_kw = dict(batcher=BATCHER)
    ref = ref_engine.ServeEngine.from_coalesced(
        jnp.asarray(ta), jnp.asarray(w), ref_ccfg,
        ecfg=ref_engine.EngineConfig(
            batcher=ref_batching.BatcherConfig(**BATCHER)))
    pool = coalesced_pool_from_numpy(ta, w, ccfg, device="cpu")
    eng = ServeEngine(pool, ccfg, EngineConfig(
        batcher=BatcherConfig(**ecfg_kw["batcher"])), device="cpu")
    assert eng.backend.name == "coalesced-cuda-packed2"
    assert not eng.selection.fell_back
    scfg = dict(window=WINDOW, hop=HOP, vote=VOTE)
    server = StreamServer(eng, kws["b"], StreamConfig(**scfg))
    ref_server = ref_stream.StreamServer(ref, kws["ref_b"],
                                         ref_stream.StreamConfig(**scfg))
    stream = _stream(kws, 60)
    for s in (server, ref_server):
        feed_stream(s, "u", stream, chunk=5)
    got = _same_decisions(server, ref_server, "u")
    rows = StreamingBooleanizer(kws["b"], WINDOW, HOP).transform_offline(
        stream)
    offline = co.predict(torch.from_numpy(ta), torch.from_numpy(w),
                         torch.from_numpy(rows), ccfg).numpy()
    np.testing.assert_array_equal([g[1] for g in got], offline)
    assert eng.summary()["forward_fallbacks"] == []


def test_sessions_share_engine_without_crosstalk(kws):
    """Three sessions interleaved hop by hop on one engine each reproduce
    their own offline predictions and the reference's decisions, and
    their windows really batched together."""
    ref_server, server = _servers(kws)
    streams = {f"u{i}": kws["frames"][i * 2:i * 2 + 2].reshape(-1, MELS)
               for i in range(3)}
    for s in (server, ref_server):
        for lo in range(0, 48, HOP):
            for sid, stream in streams.items():
                s.feed(sid, stream[lo:lo + HOP])
            s.pump()
        s.drain()
    sb = StreamingBooleanizer(kws["b"], WINDOW, HOP)
    eng = server.engine
    for sid, stream in streams.items():
        got = _same_decisions(server, ref_server, sid)
        offline = api.predict(eng.state, torch.from_numpy(
            sb.transform_offline(stream))).numpy()
        np.testing.assert_array_equal([g[1] for g in got], offline,
                                      err_msg=sid)
    s = eng.summary()
    total = sum(len(v.decisions) for v in server.sessions.values())
    assert s["requests"] == total
    assert s["mean_batch"] > 1.5
    rs = ref_server.engine.summary()
    assert (s["batches"], s["mean_batch"]) == (rs["batches"],
                                               rs["mean_batch"])


def test_chunking_does_not_change_decisions(kws):
    """Frame-by-frame and big-chunk feeds give the same decisions (preds
    and smoothed keywords), which are the reference's."""
    stream = _stream(kws, 40)
    outs = []
    for chunk in (1, 7, 40):
        ref_server, server = _servers(kws)
        for s in (server, ref_server):
            feed_stream(s, "u", stream, chunk)
        outs.append(_same_decisions(server, ref_server, "u"))
    assert outs[0] == outs[1] == outs[2]


def test_streaming_keeps_engine_bookkeeping_bounded(kws):
    """Sessions consume Responses with ``take``, so the engine keeps
    nothing after collection, and a reset session's abandoned windows are
    served and counted but dropped on arrival."""
    _, server = _servers(kws)
    eng = server.engine
    feed_stream(server, "u", _stream(kws, 60), 6)
    assert len(server.sessions["u"].decisions) > 0
    assert eng._results == {}
    server.pump()                             # prune pass
    assert eng._submitted == []
    sess = server.sessions["u"]
    sess.feed(_stream(kws, 20))
    assert sess.backlog > 0
    served_before = eng.metrics.valid_rows
    sess.reset()
    assert sess.backlog == 0
    assert sess.keyword is None and len(sess.decisions) == 0
    server.drain()
    assert eng.metrics.valid_rows > served_before
    assert eng._results == {} and eng._discard == set()
    server.pump()
    assert eng._submitted == []


# ------------------------------------------------------- vote smoothing

def test_majority_vote_ties_and_counts():
    for preds in ([2, 2, 5], [5], [1, 3, 3, 1], [4, 0, 4, 0, 4]):
        assert majority_vote(preds) == ref_stream.majority_vote(preds)
    assert majority_vote([1, 3, 3, 1]) == 1       # tie -> lowest class
    assert majority_vote([4, 0, 4, 0, 4]) == 4


def test_decision_smoothing_is_majority_over_last_votes(kws):
    """Each keyword is the majority over the trailing ``vote`` preds, and
    the vote count ramps 1, 2, ..., vote."""
    ref_server, server = _servers(kws)
    for s in (server, ref_server):
        feed_stream(s, "u", _stream(kws, 60), 6)
    _same_decisions(server, ref_server, "u")
    decisions = server.sessions["u"].decisions
    preds = [d.pred for d in decisions]
    for i, d in enumerate(decisions):
        trail = preds[max(0, i - VOTE + 1):i + 1]
        assert d.votes == len(trail)
        assert d.keyword == majority_vote(trail), i
        assert d.index == i


# ----------------------------------------------------- session metrics

def test_per_session_metrics_in_summary(kws):
    ref_server, server = _servers(kws)
    for s in (server, ref_server):
        for sid in ("a", "b"):
            feed_stream(s, sid, _stream(kws, 30), 10)
    summ, ref_summ = server.summary(), ref_server.summary()
    assert set(summ["sessions"]) == set(ref_summ["sessions"]) == {"a", "b"}
    for sid, block in summ["sessions"].items():
        assert block["decisions"] == ref_summ["sessions"][sid]["decisions"]
        assert block["decisions"] == len(server.sessions[sid].decisions)
        assert block["p50_ms"] >= 0 and block["p95_ms"] >= block["p50_ms"]
        assert block["decisions_per_s"] is None \
            or block["decisions_per_s"] > 0


def test_server_close_retires_session_state(kws):
    """``close()`` drops the session, its pending windows and its metrics
    entry; closing twice is a no-op."""
    _, server = _servers(kws)
    eng = server.engine
    for sid in ("keep", "gone"):
        feed_stream(server, sid, _stream(kws, 30), 10)
    server.session("gone").feed(_stream(kws, 20))
    closed = server.close("gone")
    assert closed is not None and len(closed.decisions) > 0
    assert closed.backlog == 0
    assert set(server.sessions) == {"keep"}
    server.drain()
    assert eng._results == {}
    assert set(server.summary()["sessions"]) == {"keep"}
    assert server.close("gone") is None
    assert "sessions" not in _engines(kws)[1].summary()


def test_stream_config_validates():
    for kw, match in ((dict(window=0), "window, hop and vote"),
                      (dict(vote=0), "window, hop and vote"),
                      (dict(history=0), "history"),
                      (dict(margin_class=-1), "margin_class")):
        with pytest.raises(ValueError, match=match):
            StreamConfig(**kw)
        with pytest.raises(ValueError, match=match):
            ref_stream.StreamConfig(**kw)


# ------------------------------------------ anomaly: margin decisions

SENSORS, ABITS, AWINDOW, AHOP = 4, 2, 4, 2
ACFG = tm.TMConfig(n_classes=2, clauses_per_class=8,
                   n_features=AWINDOW * SENSORS * ABITS, n_states=100)
REF_ACFG = ref_tm.TMConfig(n_classes=2, clauses_per_class=8,
                           n_features=AWINDOW * SENSORS * ABITS,
                           n_states=100)


@pytest.fixture(scope="module")
def anomaly():
    """Six numpy-drawn sensor streams of 24 frames, half with a burst
    (a DC shift and a ring over 8 frames), the reference's booleanizer and
    its port, and a 2-class sparse TA state at the window width."""
    rng = np.random.default_rng(1)
    t = np.arange(24) / 24
    frames = np.sin(2 * np.pi * (4 * t[None, :, None]
                                 + rng.random((6, 1, SENSORS))))
    flabels = np.zeros((6, 24), np.int64)
    for i in range(0, 6, 2):
        lo = int(rng.integers(0, 17))
        flabels[i, lo:lo + 8] = 1
    frames = frames + flabels[..., None] * (1.2 + 1.8 * np.sin(
        2 * np.pi * 24 * t)[None, :, None])
    frames = (frames + 0.05 * rng.normal(size=frames.shape)).astype(
        np.float32)
    ref_b = ref_bz.fit_quantile(frames.reshape(-1, SENSORS), bits=ABITS)
    return dict(frames=frames, flabels=flabels, ref_b=ref_b,
                b=booleanizer_from_numpy(np.asarray(ref_b.thresholds),
                                         device="cpu"),
                ta=_sparse_ta(ACFG, 5, density=0.03))


def _anomaly_engines(anomaly, kind="sync"):
    cls, ref_cls = ENGINES[kind]
    ref = ref_cls.from_ta_state(
        jnp.asarray(anomaly["ta"]), REF_ACFG, n_replicas=1,
        key=jax.random.PRNGKey(3), vcfg=NOMINAL[1],
        ecfg=ref_engine.EngineConfig(
            batcher=ref_batching.BatcherConfig(**BATCHER)))
    port = cls.from_ta_state(
        ta_from_numpy(anomaly["ta"], ACFG, device="cpu"), ACFG,
        n_replicas=1, seed=3, vcfg=NOMINAL[0],
        ecfg=EngineConfig(batcher=BatcherConfig(**BATCHER)), device="cpu")
    return ref, port


def test_sensor_anomaly_dataset_shapes_and_labels():
    """The port's sensor streams by the reference case's properties: one
    8-frame burst per stream at rate 1.0, window labels 1 iff a frame of
    the window is anomalous."""
    frames, flabels = synthetic_sensor_anomaly(
        torch.Generator().manual_seed(1), n_streams=8, n_frames=32,
        n_sensors=4, anomaly_rate=1.0, burst_frames=8, device="cpu")
    assert frames.shape == (8, 32, 4) and frames.dtype == torch.float32
    assert flabels.shape == (8, 32) and flabels.dtype == torch.int64
    np.testing.assert_array_equal(flabels.sum(dim=1).numpy(), np.full(8, 8))
    bz = fit_quantile(frames.reshape(-1, 4).numpy(), bits=2, device="cpu")
    w = StreamingBooleanizer(bz, 4, 2)
    rows, y = sensor_anomaly_windows(frames, flabels, w)
    n_windows = (32 - 4) // 2 + 1
    assert rows.shape == (8 * n_windows, w.n_boolean_features)
    assert set(np.unique(y)) <= {0, 1} and y.sum() > 0
    lab = flabels.numpy()
    for i in range(n_windows):
        assert y[i] == int(lab[0, i * 2:i * 2 + 4].max())
    ref_rows, ref_y = ref_data.sensor_anomaly_windows(
        frames.numpy(), lab, ref_bz.StreamingBooleanizer(
            ref_bz.fit_quantile(frames.reshape(-1, 4).numpy(), bits=2),
            4, 2))
    np.testing.assert_array_equal(rows, ref_rows)
    np.testing.assert_array_equal(y, ref_y)


def test_margin_of_matches_manual():
    for sums, mc in (([3, 7, 5], 1), ([9, 7, 5], 1), ([4, 4], 0)):
        assert margin_of(np.array(sums), mc) == \
            ref_stream.margin_of(np.array(sums), mc)
    assert margin_of(np.array([3, 7, 5]), 1) == 2.0
    assert margin_of(np.array([9, 7, 5]), 1) == -2.0
    with pytest.raises(ValueError, match="margin_class"):
        margin_of(np.array([1, 2]), 2)


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_margin_decisions_bit_equal_offline(anomaly, kind):
    """Streamed margin decisions equal the reference's and the digital
    oracle's: the margin is ``margin_of(tm.forward(...))`` per window and
    the alert a threshold on it."""
    ref, port = _anomaly_engines(anomaly, kind)
    thr = 1.0
    scfg = dict(window=AWINDOW, hop=AHOP, vote=3, decision="margin",
                margin_class=1, margin_threshold=thr, qos=QOS_LATENCY)
    server = StreamServer(port, anomaly["b"], StreamConfig(**scfg))
    ref_server = ref_stream.StreamServer(ref, anomaly["ref_b"],
                                         ref_stream.StreamConfig(**scfg))
    stream = anomaly["frames"][0]
    for s in (server, ref_server):
        feed_stream(s, "s0", stream, 5)
    got = _same_decisions(server, ref_server, "s0")
    rows = StreamingBooleanizer(anomaly["b"], AWINDOW,
                                AHOP).transform_offline(stream)
    assert len(got) == len(rows)
    sums = api.class_sums(port.state, tm.literals(torch.from_numpy(rows)))
    margins = [margin_of(s, 1) for s in sums[0].numpy()]
    assert [g[5] for g in got] == margins
    digital = tm.forward(torch.from_numpy(anomaly["ta"]),
                         torch.from_numpy(rows), ACFG).numpy()
    assert margins == [margin_of(s, 1) for s in digital]
    assert [g[1] for g in got] == [1 if m >= thr else 0 for m in margins]
    assert len(set(margins)) > 1
    assert port.summary()["qos"][QOS_LATENCY]["requests"] == len(rows)


def test_argmax_sessions_have_no_margin(anomaly):
    """Argmax sessions keep ``margin`` None and the plain argmax."""
    ref, port = _anomaly_engines(anomaly)
    scfg = dict(window=AWINDOW, hop=AHOP, vote=1)
    server = StreamServer(port, anomaly["b"], StreamConfig(**scfg))
    ref_server = ref_stream.StreamServer(ref, anomaly["ref_b"],
                                         ref_stream.StreamConfig(**scfg))
    for s in (server, ref_server):
        s.feed("a", anomaly["frames"][1])
        s.drain()
    got = _same_decisions(server, ref_server, "a")
    rows = StreamingBooleanizer(anomaly["b"], AWINDOW,
                                AHOP).transform_offline(anomaly["frames"][1])
    preds = tm.predict(torch.from_numpy(anomaly["ta"]),
                       torch.from_numpy(rows), ACFG).numpy()
    assert [g[5] for g in got] == [None] * len(rows)
    np.testing.assert_array_equal([g[1] for g in got], preds)


def test_stream_server_max_sessions_and_qos_override(anomaly):
    _, port = _anomaly_engines(anomaly)
    server = StreamServer(port, anomaly["b"], StreamConfig(
        window=AWINDOW, hop=AHOP, max_sessions=2))
    a = server.session("a", qos=QOS_LATENCY)
    assert a.scfg.qos == QOS_LATENCY
    assert server.session("b").scfg.qos == QOS_BULK
    assert server.session("a") is a
    assert server.session("a", decision="margin").scfg.decision == "argmax"
    with pytest.raises(QueueFull, match="max_sessions"):
        server.session("c")
    assert port.summary()["rejected"] == 1
    server.close("b")
    assert server.session("c", decision="margin").scfg.decision == "margin"


def test_stream_config_validation():
    for kw, match in ((dict(qos="realtime"), "QoS"),
                      (dict(decision="softmax"), "decision"),
                      (dict(max_sessions=0), "max_sessions")):
        with pytest.raises(ValueError, match=match):
            StreamConfig(**kw)
        with pytest.raises(ValueError, match=match):
            ref_stream.StreamConfig(**kw)
    with pytest.raises(ValueError, match="latency_max_wait_s"):
        BatcherConfig(latency_max_wait_s=0.0)
    with pytest.raises(ValueError, match="latency_queue_depth"):
        BatcherConfig(latency_queue_depth=0)
    cfg = BatcherConfig(max_wait_s=8e-3)
    assert cfg.wait_for(QOS_LATENCY) == pytest.approx(2e-3)
    assert cfg.wait_for(QOS_BULK) == pytest.approx(8e-3)
    assert BatcherConfig(latency_max_wait_s=1e-3).wait_for(
        QOS_LATENCY) == pytest.approx(1e-3)


# -------------------------------------- sessions through live operations

LIVE_CFG = tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=32,
                       n_states=100)
REF_LIVE_CFG = ref_tm.TMConfig(n_classes=4, clauses_per_class=8,
                               n_features=32, n_states=100)
D2D = (var.VariationConfig(c2c=False, csa_offset=False),
       ref_var.VariationConfig(c2c=False, csa_offset=False))


def _carry(ref_pool, cfg_vcfg=D2D[0], fault_mask=None):
    return pool_from_numpy(np.asarray(ref_pool.r_stack),
                           np.asarray(ref_pool.include), vcfg=cfg_vcfg,
                           version=ref_pool.version, fault_mask=fault_mask,
                           device="cpu")


def _live_engines(inc, n_replicas, routing, batcher, **ref_ecfg_kw):
    """A reference engine on a D2D pool it programs and the port engine on
    the same arrays."""
    ref_pool = ref_replica.program_replica_pool(
        jnp.asarray(inc), jax.random.PRNGKey(7), n_replicas, D2D[1])
    ref = ref_engine.ServeEngine(ref_pool, REF_LIVE_CFG,
                                 ref_engine.EngineConfig(
                                     batcher=ref_batching.BatcherConfig(
                                         **batcher),
                                     routing=routing, **ref_ecfg_kw),
                                 key=jax.random.PRNGKey(3))
    port = ServeEngine(_carry(ref_pool), LIVE_CFG, EngineConfig(
        batcher=BatcherConfig(**batcher), routing=routing), device="cpu")
    return ref, port


def test_stream_sessions_ride_through_swap():
    """Two sessions keep streaming across a hot swap installed into both
    packages' engines: no window dropped, versions step 0 -> 1 once in
    stream order, decisions equal the reference's."""
    mels, bits, window, hop = 4, 2, 4, 2
    rng = np.random.default_rng(0)
    ref_b = ref_bz.fit_quantile(rng.normal(size=(256, mels)), bits=bits)
    b = booleanizer_from_numpy(np.asarray(ref_b.thresholds), device="cpu")
    ta = _sparse_ta(LIVE_CFG, 6, density=0.12)
    ref, port = _live_engines(ta > LIVE_CFG.n_states, 2, "round_robin",
                              BATCHER)
    scfg = dict(window=window, hop=hop, vote=3)
    server = StreamServer(port, b, StreamConfig(**scfg))
    ref_server = ref_stream.StreamServer(ref, ref_b,
                                         ref_stream.StreamConfig(**scfg))
    frames = {s: rng.normal(size=(40, mels)) for s in ("a", "b")}
    n_windows = 1 + (40 - window) // hop

    def feed_span(srv, lo, hi):
        for s, f in frames.items():
            for at in range(lo, hi, hop):
                srv.feed(s, f[at:at + hop])
            srv.pump()

    for srv in (server, ref_server):
        feed_span(srv, 0, 20)
        srv.drain()
    cand = ref_swap.reprogrammed_pool(
        ref, jnp.asarray(_sparse_ta(LIVE_CFG, 7, density=0.12)),
        jax.random.PRNGKey(5))
    ref.install_pool(cand, kind="swap")
    port.install_pool(_carry(cand), kind="swap")
    for srv in (server, ref_server):
        feed_span(srv, 20, 40)
        srv.drain()
    for s in frames:
        got = _same_decisions(server, ref_server, s)
        assert len(got) == n_windows
        assert [g[0] for g in got] == list(range(n_windows))
        versions = [g[4] for g in got]
        assert versions == sorted(versions)
        assert set(versions) == {0, 1}
    assert port.summary()["swaps"] == ref.summary()["swaps"] == [
        {"from_version": 0, "to_version": 1, "kind": "swap"}]


def test_chaos_loop_streaming():
    """A session streams across injure -> probe -> quarantine -> repair
    in both packages: every window decided, none by the quarantined chip,
    decisions equal to the reference's and to the digital TM."""
    mels, window, hop = 4, 2, 1
    rng = np.random.default_rng(0)
    stream = rng.normal(size=(66, mels)).astype(np.float32)
    ref_b = ref_bz.fit_uniform(stream, bits=4)
    b = booleanizer_from_numpy(np.asarray(ref_b.thresholds), device="cpu")
    ta = _sparse_ta(LIVE_CFG, 5)
    inc = ta > LIVE_CFG.n_states
    hcfg = dict(n_probes=64, seed=5)
    batcher = dict(max_batch=32, bucket_sizes=(8, 16, 32))
    ref, port = _live_engines(inc, 4, "ensemble", batcher,
                              health=ref_health.HealthConfig(**hcfg))
    port.health = HealthProbe(x=np.asarray(ref.health.x),
                              expected=np.asarray(ref.health.expected),
                              hcfg=HealthConfig(**hcfg))
    scfg = dict(window=window, hop=hop, vote=1)
    server = StreamServer(port, b, StreamConfig(**scfg))
    ref_server = ref_stream.StreamServer(ref, ref_b,
                                         ref_stream.StreamConfig(**scfg))

    def feed(lo, hi):
        for srv in (server, ref_server):
            for t in range(lo, hi):
                srv.feed("u", stream[t:t + 1])
                srv.pump()

    feed(0, 22)
    ref.inject_faults(jax.random.PRNGKey(99), ref_var.FaultConfig(
        stuck_lrs_rate=0.15, stuck_hrs_rate=0.15), replicas=[3])
    port.quiesce()
    port._set_pool(_carry(ref.pool,
                          fault_mask=np.asarray(ref.pool.fault_mask)))
    port.metrics.note_fault_injection([3])
    assert port.probe() == ref.probe()
    assert port.quarantined == ref.quarantined == [3]
    feed(22, 44)
    RepairPolicy(port, RepairConfig()).check()
    ref_swap.RepairPolicy(ref, ref_swap.RepairConfig()).check()
    assert port.quarantined == ref.quarantined == []
    feed(44, 66)
    for srv in (server, ref_server):
        srv.drain()
    got = _same_decisions(server, ref_server, "u")
    rows = StreamingBooleanizer(b, window, hop).transform_offline(stream)
    assert len(got) == len(rows)
    digital = tm.predict(torch.from_numpy(ta), torch.from_numpy(rows),
                         LIVE_CFG).numpy()
    np.testing.assert_array_equal([g[1] for g in got], digital)
    assert port.summary()["expired"] == 0
    assert port.summary()["replica_load_rows"][3] < \
        port.summary()["replica_load_rows"][0]


def test_booleanizer_is_a_frozen_tensor_holder():
    b = Booleanizer(thresholds=torch.zeros(3, 2))
    with pytest.raises(dataclasses.FrozenInstanceError):
        b.thresholds = torch.ones(3, 2)
    assert b(torch.ones(5, 3)).shape == (5, 6)
