"""The port's measured tuning (``repro_torch.kernels.autotune``, the
registry's tuning half, the engine's tuned ladder and tiles, ``lazy_tune``)
on the CPU, against the reference where the two compute the same thing.

The cases of ``tests/test_autotune.py`` are ported with the one
deliberate change: an entry is withheld unless its recorded
``(platform, device_name)`` is the serving device's
(``api.device_signature``), where the reference compares the jax
backend.  So the committed H100 table never reaches these CPU engines.
Every test runs against a snapshot-restored table (the table is module
state).
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.kernels import autotune as ref_autotune  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import registry as reg  # noqa: E402
from repro_torch.core import tm  # noqa: E402
from repro_torch.core.coalesced import CoalescedConfig  # noqa: E402
from repro_torch.core.variations import VariationConfig  # noqa: E402
from repro_torch.kernels import (autotune, clause_eval,  # noqa: E402
                                 imbue_infer)
from repro_torch.serve import (BatcherConfig, EngineConfig,  # noqa: E402
                               ServeEngine)

CPU = ("cpu", "cpu")
H100 = "NVIDIA H100 80GB HBM3"
ENTRY = {"tiles": {"ks": 2, "ng": 2}, "bucket_sizes": [8, 16],
         "platform": "cpu", "device_name": "cpu"}
CFG = tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=32,
                  n_states=100)                     # C = 32, L = 64
NOMINAL = VariationConfig.nominal()


@pytest.fixture(autouse=True)
def _tuning_guard():
    """Every test runs against a snapshot-restored table."""
    snap = api.tuning_snapshot()
    yield
    api.restore_tuning(snap)


def _ta(cfg=CFG, seed=0):
    rng = np.random.default_rng(seed)
    inc = rng.random((cfg.n_clauses, cfg.n_literals)) < 0.1
    ta = np.where(inc, cfg.n_states + 1, cfg.n_states).astype(np.int16)
    return torch.from_numpy(ta)


def make_engine(cfg=CFG, ta=None, **ecfg_kw):
    ecfg_kw.setdefault("batcher", BatcherConfig.for_max_batch(16))
    return ServeEngine.from_ta_state(
        _ta(cfg) if ta is None else ta, cfg, n_replicas=1, vcfg=NOMINAL,
        ecfg=EngineConfig(**ecfg_kw), device="cpu")


def _my_key(cfg=CFG):
    return api.shape_bucket_key(cfg.n_clauses, cfg.n_literals)


# ----------------------------------------------------- shape bucket keys

def test_shape_bucket_key_rounds_up_to_pow2():
    assert api.shape_bucket_key(32, 128) == "c32-l128"
    assert api.shape_bucket_key(33, 129) == "c64-l256"
    assert api.shape_bucket_key(1, 1) == "c1-l1"
    assert api.shape_bucket_key(60, 768) == "c64-l1024"
    assert api.shape_bucket_key(30, 120) == api.shape_bucket_key(32, 128)
    assert api.shape_bucket_key(32, 128) != api.shape_bucket_key(64, 128)


@pytest.mark.parametrize("c", [1, 2, 3, 31, 32, 33, 60, 600, 900, 1000,
                               1800, 2000, 4097])
@pytest.mark.parametrize("l", [1, 64, 74, 128, 129, 512, 768, 1568, 5000])
def test_shape_keys_equal_the_reference(c, l):
    assert api.shape_bucket_key(c, l) == ref_api.shape_bucket_key(c, l)
    per_class = {"n_classes": 2, "clauses_per_class": c, "n_features": l}
    pool = {"n_classes": 3, "n_clauses": c, "n_features": l}
    for shape in (per_class, pool):
        assert api.shape_key_of(shape) == ref_api.shape_key_of(shape)
    assert api.REF_SHAPE_KEY == ref_api.REF_SHAPE_KEY


def test_shape_key_of_entry_shape():
    assert api.shape_key_of(autotune.REF_SHAPE) == api.REF_SHAPE_KEY
    assert api.shape_key_of(autotune.KWS_SHAPE) == "c64-l1024"
    assert autotune.REF_SHAPE == ref_autotune.REF_SHAPE
    assert autotune.KWS_SHAPE == ref_autotune.KWS_SHAPE
    assert autotune.BUCKET_CANDIDATES == ref_autotune.BUCKET_CANDIDATES
    assert autotune.LADDER_KEEP_RATIO == ref_autotune.LADDER_KEEP_RATIO


def test_registry_is_shape_keyed():
    """A lookup without a shape key is the reference bucket, and an entry
    with a recorded shape registers under its own bucket without
    disturbing the reference bucket's."""
    api.register_tuning("analog-cuda-packed", dict(ENTRY),
                        shape_key=api.REF_SHAPE_KEY)
    entry = api.get_tuning("analog-cuda-packed", device="cpu")
    assert entry == ENTRY
    assert api.get_tuning("analog-cuda-packed",
                          shape_key=api.REF_SHAPE_KEY, device="cpu") == entry
    api.register_tuning("analog-cuda-packed",
                        dict(ENTRY, tiles={"ks": 8, "ng": 1},
                             shape=autotune.KWS_SHAPE))
    assert api.get_tuning("analog-cuda-packed", shape_key="c64-l1024",
                          device="cpu")["tiles"] == {"ks": 8, "ng": 1}
    assert api.get_tuning("analog-cuda-packed", device="cpu") == entry


def test_get_tuning_without_a_device_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.get_tuning("analog-cuda-packed2")


# ------------------------------------------------ the committed table

TABLE_SHAPES = {"c32-l128", "c64-l1024", "c2048-l2048", "c2048-l1024",
                "c1024-l512"}
COALESCED_ONLY = {"c1024-l2048", "c1024-l1024"}


def test_committed_table_is_the_cards():
    """The committed table holds every fused backend at the reference's
    two shapes and the port's full widths (the coalesced pools on the
    coalesced backends), each entry measured on an H100 with its power
    limit in every served state, the tile sweep's "auto" candidate and a
    ladder, its tiles the ones the margin rule commits."""
    table = autotune.normalize_table(autotune.load_default_table())
    fused = {b.name for b in autotune._tunable_backends()}
    assert set(table) == fused
    for name, shapes in table.items():
        want = TABLE_SHAPES | (COALESCED_ONLY if name.startswith(
            "coalesced") else set())
        assert set(shapes) == want, name
        for skey, e in shapes.items():
            assert (e["platform"], e["device_name"]) == ("cuda", H100)
            assert isinstance(e["power_limit_w"], float)
            assert autotune.AUTO in e["tile_latency_us"]
            assert e["bucket_sizes"] and e["bucket_sizes"][-1] == 128
            labels = {label for label, _, _ in autotune.served_states(
                api.get_backend(name))}
            assert set(e["tile_latency_by_state"]) == labels
            assert set(e["bucket_latency_by_state"]) == labels
            assert e["tile_margin"] == autotune.TILE_MARGIN
            assert autotune.pick_tiles(e["tile_latency_by_state"]) == \
                e["tiles"]
            assert api.shape_key_of(e["shape"]) == skey
            assert e["tile_geometry"]["kernel"] == autotune.KERNEL_OF[name]
            if e["tiles"]:
                assert autotune.tile_key(e["tiles"]) in e["tile_latency_us"]


def test_committed_table_is_withheld_on_the_cpu():
    """Every committed entry is withheld from a CPU engine: the CPU tests
    serve on the kernels' own geometry and the static ladder, as before
    the table existed."""
    table = autotune.normalize_table(autotune.load_default_table())
    assert table
    for name, shapes in table.items():
        for skey in shapes:
            assert api.get_tuning(name, shape_key=skey, device="cpu") is None
    snap = api.tuning_snapshot()
    assert set(snap) >= set(table)


# ------------------------------------------------------ withholding rules

@pytest.mark.parametrize("signature", [
    ("cuda", H100), ("cuda", "cpu"), ("cpu", H100), (None, None)],
    ids=["h100", "cuda-platform", "other-name", "no-pair"])
def test_entry_withheld_on_device_mismatch(signature):
    """Tiles measured on another device (or on none recorded) are
    ignored: the engine runs on its kernels' own geometry and the static
    ladder, never another device's tiles."""
    platform, name = signature
    entry = dict(ENTRY, platform=platform, device_name=name)
    if platform is None:
        del entry["platform"], entry["device_name"]
    api.register_tuning("analog-cuda-packed2", entry, shape_key=_my_key())
    assert api.get_tuning("analog-cuda-packed2", shape_key=_my_key(),
                          device="cpu") is None
    eng = make_engine()
    assert eng.backend.name == "analog-cuda-packed2"
    assert eng.tuning is None
    s = eng.summary()
    assert s["kernel_tiles"] == {}
    assert s["buckets_tuned_for"] is None
    assert s["bucket_sizes"] == [8, 16]
    # the same entry under the serving device's pair is consumed
    api.register_tuning("analog-cuda-packed2", dict(ENTRY),
                        shape_key=_my_key())
    assert api.device_signature("cpu") == CPU
    assert make_engine().summary()["kernel_tiles"] == ENTRY["tiles"]


def test_entry_withheld_on_shape_bucket_mismatch():
    """An entry for another shape bucket is never applied."""
    assert _my_key() == "c32-l64" != api.REF_SHAPE_KEY
    api.register_tuning("analog-cuda-packed2", dict(ENTRY),
                        shape_key=api.REF_SHAPE_KEY)
    api.register_tuning("analog-cuda-packed2", dict(ENTRY),
                        shape_key="c1024-l4096")
    assert api.get_tuning("analog-cuda-packed2", shape_key=_my_key(),
                          device="cpu") is None
    eng = make_engine()
    assert eng.shape_key == _my_key()
    assert eng.tuning is None
    assert eng.summary()["kernel_tiles"] == {}


def test_legacy_flat_table_schema_loads(monkeypatch):
    """A flat ``{backend: entry}`` table (the reference's older schema)
    loads under the bucket of each entry's recorded shape."""
    flat = {"analog-cuda-packed": dict(ENTRY, shape=autotune.KWS_SHAPE),
            "digital-cuda": dict(ENTRY, tiles={"wm": 2, "wn": 4})}
    monkeypatch.setattr(autotune, "load_default_table", lambda: flat)
    monkeypatch.setattr(reg, "_TUNING", {})
    monkeypatch.setattr(reg, "_TUNING_DEFAULTS_LOADED", False)
    assert api.get_tuning("analog-cuda-packed", shape_key="c64-l1024",
                          device="cpu")["tiles"] == ENTRY["tiles"]
    assert api.get_tuning("digital-cuda", shape_key=api.REF_SHAPE_KEY,
                          device="cpu") is not None
    assert api.get_tuning("digital-cuda", shape_key="c8-l8",
                          device="cpu") is None


def test_normalize_table_of_the_reference_table_gives_its_keys():
    raw = ref_autotune.load_default_table()
    assert raw
    ours = autotune.normalize_table(raw)
    theirs = ref_autotune.normalize_table(raw)
    assert {b: sorted(s) for b, s in ours.items()} == \
        {b: sorted(s) for b, s in theirs.items()}
    flat = {"analog-pallas": dict(raw["analog-pallas"]["c64-l1024"])}
    assert autotune.normalize_table(flat) == \
        ref_autotune.normalize_table(flat)


def test_clear_tuning_drops_all_shapes():
    api.register_tuning("analog-cuda-packed", dict(ENTRY), shape_key="c8-l8")
    api.register_tuning("analog-cuda-packed", dict(ENTRY))
    api.register_tuning("analog-cuda", dict(ENTRY))
    api.clear_tuning("analog-cuda-packed")
    assert api.get_tuning("analog-cuda-packed", device="cpu") is None
    assert api.get_tuning("analog-cuda-packed", shape_key="c8-l8",
                          device="cpu") is None
    assert "analog-cuda-packed" not in api.tuning_snapshot()
    # other backends keep their entries
    assert api.get_tuning("analog-cuda", device="cpu") == ENTRY
    api.clear_tuning()
    assert api.tuning_snapshot() == {}


def test_save_table_merges_and_round_trips(tmp_path):
    path = str(tmp_path / "table.json")
    autotune.save_table({"digital-cuda": {"c8-l8": dict(ENTRY)}}, path)
    autotune.save_table({"digital-cuda": {"c16-l16": dict(ENTRY)},
                         "coalesced-cuda": dict(ENTRY, shape=dict(
                             n_classes=2, n_clauses=5, n_features=4))},
                        path)
    table = autotune.load_table(path)
    assert sorted(table["digital-cuda"]) == ["c16-l16", "c8-l8"]
    assert list(table["coalesced-cuda"]) == ["c8-l8"]


# ------------------------------------------------------- lazy measurement

def test_lazy_tune_measures_exactly_once(monkeypatch):
    """An unseen shape triggers lazy measurement exactly once; the second
    engine at the same (backend, bucket) reuses the registered entry."""
    calls = []

    def fake_measure(backend, **kw):
        calls.append((backend.name, str(kw["device"])))
        return dict(ENTRY, shape=dict(kw.get("shape") or {}))

    monkeypatch.setattr(autotune, "autotune_backend", fake_measure)
    eng = make_engine(lazy_tune=True)
    assert calls == [("analog-cuda-packed2", "cpu")]
    assert eng.tuning is not None and eng.tuning.get("lazy")
    s = eng.summary()
    assert s["tuning_lazy"] is True and s["shape_key"] == _my_key()
    assert s["kernel_tiles"] == ENTRY["tiles"]
    # the measured ladder flowed into the for_max_batch batcher
    assert eng.batcher.cfg.bucket_sizes == (8, 16)
    assert s["buckets_tuned_for"] == "analog-cuda-packed2"
    eng2 = make_engine(lazy_tune=True)
    assert calls == [("analog-cuda-packed2", "cpu")]
    assert eng2.tuning == eng.tuning


def test_lazy_tune_never_overrides_hand_picked_buckets(monkeypatch):
    """Hand-picked bucket sizes survive a lazily measured entry; the
    tiles still flow (they are kernel-internal, not a policy)."""
    monkeypatch.setattr(autotune, "autotune_backend",
                        lambda backend, **kw: dict(ENTRY))
    eng = make_engine(lazy_tune=True,
                      batcher=BatcherConfig(max_batch=32,
                                            bucket_sizes=(16, 32)))
    assert eng.tuning is not None
    assert eng.batcher.cfg.bucket_sizes == (16, 32)
    assert eng.batcher.cfg.tuned_for is None
    assert eng.summary()["kernel_tiles"] == ENTRY["tiles"]


def test_lazy_tune_off_by_default(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("measured without lazy_tune")

    monkeypatch.setattr(autotune, "autotune_backend", boom)
    assert make_engine().tuning is None


def test_lazy_tune_skips_backends_without_a_kernel(monkeypatch):
    """A non-fused backend (the full-noise fallback) takes no tiles and
    is never measured."""
    monkeypatch.setattr(autotune, "autotune_backend",
                        lambda *a, **kw: pytest.fail("measured"))
    eng = make_engine(lazy_tune=True, backend="analog-torch")
    assert eng.backend.name == "analog-torch" and eng.tuning is None


def test_lazy_tune_real_measurement_roundtrip():
    """The real lazy path (no monkeypatch), over the plain versions: a
    small sweep at the engine's exact shape, registered under its bucket,
    with tiles from the lazy grid (or auto) and a bucket ladder."""
    api.clear_tuning("analog-cuda-packed2")
    eng = make_engine(lazy_tune=True)
    entry = api.get_tuning("analog-cuda-packed2", shape_key=_my_key(),
                           device="cpu")
    assert entry is not None and entry["lazy"]
    assert entry["shape"]["n_features"] == CFG.n_features
    assert (entry["platform"], entry["device_name"]) == CPU
    # The plain versions ignore tiles: no tile sweep on the host.
    assert entry["tiles"] == {} and entry["tile_latency_us"] == {}
    assert "plain versions ignore tiles" in entry["tile_estimator"]
    assert set(entry["bucket_latency_by_state"]) == {"r1-nominal",
                                                     "r4-d2d"}
    assert entry["bucket_sizes"][-1] == 128
    assert all(b % 8 == 0 for b in entry["bucket_sizes"])
    assert eng.tuning == entry
    eng.submit(np.zeros(CFG.n_features, np.uint8))
    assert len(eng.drain()) == 1


def test_lazy_tune_through_the_stream_cli():
    """``launch.stream --lazy-tune`` on the host: the engine measures its
    shape bucket once and says so."""
    from repro_torch.launch import stream as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summ = cli.main(["--device", "cpu", "--sessions", "2", "--frames",
                         "32", "--epochs", "1", "--lazy-tune", "--json"])
    out = buf.getvalue()
    assert "shape bucket c64-l1024" in out and "lazily measured" in out
    assert summ["tuning_lazy"] is True and summ["shape_key"] == "c64-l1024"
    assert api.get_tuning("analog-cuda-packed2", shape_key="c64-l1024",
                          device="cpu")["lazy"]
    api.clear_tuning("analog-cuda-packed2")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summ = cli.main(["--device", "cpu", "--sessions", "2", "--frames",
                         "32", "--epochs", "1", "--no-lazy-tune", "--json"])
    assert "(tiles default)" in buf.getvalue()
    assert summ["tuning_lazy"] is False and summ["kernel_tiles"] == {}


# ------------------------------------------------------------- autotuner

def test_prune_bucket_ladder():
    # flat latency -> the ladder collapses to the largest bucket
    assert autotune.prune_bucket_ladder({8: 100.0, 16: 99.0, 32: 101.0,
                                         64: 100.0}) == (64,)
    # strictly amortising latency -> every bucket survives
    assert autotune.prune_bucket_ladder({8: 10.0, 16: 15.0, 32: 30.0,
                                         64: 60.0}) == (8, 16, 32, 64)


@settings(max_examples=200, deadline=None)
@given(st.dictionaries(st.sampled_from(autotune.BUCKET_CANDIDATES),
                       st.floats(min_value=0.01, max_value=1e6,
                                 allow_nan=False), min_size=1))
def test_prune_bucket_ladder_equals_the_reference(lat):
    assert autotune.prune_bucket_ladder(lat) == \
        ref_autotune.prune_bucket_ladder(lat)


def test_autotune_smoke_produces_entries():
    """A smoke-sized sweep over the plain versions gives an entry with
    tiles (or auto), the auto candidate and a ladder for every fused
    backend, keyed by the reference shape's bucket."""
    entries = autotune.autotune(smoke=True, register=False, device="cpu")
    assert set(entries) == {b.name for b in autotune._tunable_backends()}
    assert len(entries) == 8
    for name, shapes in entries.items():
        e = shapes[api.REF_SHAPE_KEY]
        backend = api.get_backend(name)
        assert e["tiles"] == {} and e["tile_latency_us"] == {}
        assert set(e["bucket_latency_by_state"]) == {
            label for label, _, _ in autotune.served_states(backend)}
        assert e["bucket_sizes"] and all(b % 8 == 0
                                         for b in e["bucket_sizes"])
        assert e["shape"] == autotune.REF_SHAPE and e["platform"] == "cpu"
    assert api.get_tuning("no-such-backend", device="cpu") is None


def test_autotune_named_backend_at_a_coalesced_shape():
    """A coalesced shape (a total pool) is measured on the coalesced
    backends only; a per-class shape on every one."""
    pool = {"n_classes": 3, "n_clauses": 40, "n_features": 20}
    entries = autotune.autotune(
        ["coalesced-cuda-packed2", "analog-cuda"], shapes=[pool, CFG_SHAPE],
        reps=1, register=True, device="cpu")
    assert set(entries["coalesced-cuda-packed2"]) == {"c64-l64", "c32-l64"}
    assert set(entries["analog-cuda"]) == {"c32-l64"}
    assert api.get_tuning("coalesced-cuda-packed2", shape_key="c64-l64",
                          device="cpu") is not None


CFG_SHAPE = {"n_classes": CFG.n_classes,
             "clauses_per_class": CFG.clauses_per_class,
             "n_features": CFG.n_features}


def test_pick_tiles_needs_a_clear_win_in_every_state():
    """An override is committed only where it beats "auto" by more than
    the margin in every served state, and then the one with the least
    summed time; a win inside the margin, or on one state only, keeps the
    kernel's own geometry."""
    m = autotune.TILE_MARGIN
    one = {"auto": 100.0, "ks2-ng1": 100.0 * (1 - m) + 0.5,
           "ks4-ng2": 80.0}
    assert autotune.pick_tiles({"a": one}) == {"ks": 4, "ng": 2}
    assert autotune.pick_tiles({"a": one, "b": {
        "auto": 10.0, "ks2-ng1": 5.0, "ks4-ng2": 9.5}}) == {}
    assert autotune.pick_tiles({"a": {"auto": 10.0, "wm1-wn4": 8.9,
                                      "wm2-wn1": 8.0},
                                "b": {"auto": 10.0, "wm1-wn4": 5.0,
                                      "wm2-wn1": 8.5}}) == {"wm": 1, "wn": 4}
    assert autotune.pick_tiles({"a": {"auto": 10.0, "wm1-wn1": 9.5}}) == {}
    assert autotune.pick_tiles({}) == {}


@settings(max_examples=200, deadline=None)
@given(st.lists(st.dictionaries(st.sampled_from(["auto", "ks2-ng1",
                                                 "ks4-ng2", "ks8-ng4"]),
                                st.floats(min_value=1.0, max_value=1e3,
                                          allow_nan=False)),
                min_size=1, max_size=3))
def test_a_committed_tile_beats_auto_by_the_margin_everywhere(lats):
    keys = set.intersection(*(set(lat) for lat in lats)) | {"auto"}
    by_state = {f"s{i}": {k: lat.get(k, 1e3) for k in keys}
                for i, lat in enumerate(lats)}
    tiles = autotune.pick_tiles(by_state)
    if tiles:
        key = autotune.tile_key(tiles)
        assert all(lat[key] < (1 - autotune.TILE_MARGIN) * lat["auto"]
                   for lat in by_state.values())


def test_ladder_is_the_union_of_the_served_states(monkeypatch):
    """The bucket sweep runs in each served state and keeps a bucket
    where any state pays for padding past it: a flat state alone would
    collapse the ladder to [128]."""
    lat = {"r1-nominal": {8: 100.0, 32: 100.0, 128: 100.0},
           "r4-d2d": {8: 20.0, 32: 99.0, 128: 100.0}}
    sweeps = []

    def fake_times(fns, reps, sync):
        label = ("r1-nominal", "r4-d2d")[len(sweeps)]
        sweeps.append(sorted(fns))
        return dict(lat[label])

    monkeypatch.setattr(autotune, "_host_times_us", fake_times)
    e = autotune.autotune_backend(
        api.get_backend("analog-cuda-packed2"), shape=CFG_SHAPE,
        bucket_candidates=(8, 32, 128), reps=1, device="cpu")
    assert sweeps == [[8, 32, 128], [8, 32, 128]]
    assert e["bucket_sizes"] == [8, 128]
    assert e["bucket_latency_by_state"]["r4-d2d"] == {
        "8": 20.0, "32": 99.0, "128": 100.0}
    assert e["bucket_latency_us"] == {"8": 120.0, "32": 199.0,
                                      "128": 200.0}


def test_tiles_that_do_not_fit_the_model_are_not_launched():
    """An entry covers a shape bucket; a second model in the bucket with
    fewer columns than the entry's ks serves on the kernel's own geometry
    (with a warning), exactly, while a model they fit takes them."""
    wide = tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=120,
                       n_states=100)                    # L = 240: 8 columns
    narrow = tm.TMConfig(n_classes=4, clauses_per_class=8, n_features=70,
                         n_states=100)                  # L = 140: 5 columns
    assert _my_key(wide) == _my_key(narrow) == "c32-l256"
    api.register_tuning("analog-cuda-packed2",
                        dict(ENTRY, tiles={"ks": 8, "ng": 1}),
                        shape_key="c32-l256")
    assert autotune.tiles_fit({"ks": 8, "ng": 1}, wide.n_literals)
    assert not autotune.tiles_fit({"ks": 8, "ng": 1}, narrow.n_literals)
    assert autotune.tiles_fit({"wm": 4, "wn": 4}, 2)
    eng = make_engine(wide, _ta(wide))
    assert eng.summary()["kernel_tiles"] == {"ks": 8, "ng": 1}
    with pytest.warns(UserWarning, match="do not fit L = 140"):
        eng2 = make_engine(narrow, _ta(narrow, seed=1))
    s = eng2.summary()
    assert s["kernel_tiles"] == {} and s["shape_key"] == "c32-l256"
    assert s["buckets_tuned_for"] == "analog-cuda-packed2"
    rng = np.random.default_rng(7)
    xs = (rng.random((12, narrow.n_features)) < 0.5).astype(np.uint8)
    want = tm.forward(_ta(narrow, seed=1), torch.from_numpy(xs), narrow)
    got = np.stack([r.class_sums for r in _serve(eng2, xs)])
    assert np.array_equal(got, want.numpy())


def test_tile_candidates_cover_the_grids():
    analog = api.get_backend("analog-cuda-packed2")
    big = {"n_classes": 2, "clauses_per_class": 4, "n_features": 784}
    tiles = autotune.tile_candidates(analog, big)
    assert tiles[0] == {} and len(tiles) == 10
    assert {autotune.tile_key(t) for t in tiles[1:]} == {
        f"ks{ks}-ng{ng}" for ks in (2, 4, 8) for ng in (1, 2, 4)}
    # ks past the model's columns is left out (L = 64: two columns)
    assert all(t["ks"] <= 2 for t in autotune.tile_candidates(
        analog, CFG_SHAPE)[1:])
    tm_tiles = autotune.tile_candidates(api.get_backend("digital-cuda"),
                                        CFG_SHAPE)
    assert tm_tiles[0] == {} and len(tm_tiles) == 10
    assert autotune.grid_tiles(autotune.TM_GRID) == tm_tiles
    assert len(autotune.grid_tiles(autotune.ANALOG_GRID)) == 10
    for t in tiles + tm_tiles:
        assert autotune.parse_tile_key(autotune.tile_key(t)) == t


# ------------------------------------------------- tiles in the kernels

ANALOG_GOOD = [{"ks": ks, "ng": ng} for ks in range(1, 9)
               for ng in (1, 2, 4)]
ANALOG_BAD = [{"ks": 0, "ng": 1}, {"ks": 9, "ng": 1}, {"ks": 2, "ng": 3},
              {"ks": 2, "ng": 8}, {"ks": 2}, {"ng": 1},
              {"ks": 2, "ng": 1, "wm": 1}, {"ks": 2.0, "ng": 1},
              {"ks": True, "ng": 1}]
TM_GOOD = [{"wm": wm, "wn": wn} for wm in (1, 2, 4) for wn in (1, 2, 4)]
TM_BAD = [{"wm": 3, "wn": 1}, {"wm": 8, "wn": 1}, {"wm": 0, "wn": 1},
          {"wm": 1}, {"wm": 1, "wn": 1, "ks": 2}, {"wm": 1.0, "wn": 1}]


@pytest.mark.parametrize("tiles", ANALOG_GOOD, ids=autotune.tile_key)
def test_every_analog_grid_tile_is_accepted(tiles):
    assert imbue_infer.analog_tiles(tiles, 49) == (tiles["ks"],
                                                   tiles["ng"])
    assert imbue_infer.analog_tiles(None, 49) == (0, 0)
    assert imbue_infer.analog_tiles({}, 49) == (0, 0)


@pytest.mark.parametrize("tiles", ANALOG_BAD, ids=str)
def test_every_invalid_analog_tile_raises(tiles):
    with pytest.raises(ValueError, match="tile"):
        imbue_infer.analog_tiles(tiles, 49)


def test_analog_ks_past_the_columns_raises():
    assert imbue_infer.analog_tiles({"ks": 3, "ng": 1}, 3) == (3, 1)
    with pytest.raises(ValueError, match=r"ks in 1\.\.3"):
        imbue_infer.analog_tiles({"ks": 4, "ng": 1}, 3)


@pytest.mark.parametrize("tiles", TM_GOOD, ids=autotune.tile_key)
def test_every_tm_grid_tile_is_accepted(tiles):
    assert clause_eval.tm_tiles(tiles) == (tiles["wm"], tiles["wn"])
    assert clause_eval.tm_tiles(None) == (0, 0)


@pytest.mark.parametrize("tiles", TM_BAD, ids=str)
def test_every_invalid_tm_tile_raises(tiles):
    with pytest.raises(ValueError, match="tile"):
        clause_eval.tm_tiles(tiles)


def _backend_case(name, seed=3, b=13):
    """A nominal state and literal operand for backend ``name`` at CFG
    (C = 32, L = 64), the engine's wire format for it."""
    backend = api.get_backend(name)
    state, lits = autotune._reference_state(
        backend, CFG_SHAPE, torch.device("cpu"), b)
    return backend, state, lits


FUSED = sorted(autotune.KERNEL_OF)


@pytest.mark.parametrize("name", FUSED)
def test_class_sums_with_tiles_equal_the_sums_without(name):
    """On the CPU a tile changes nothing the function computes: every
    grid tile gives the sums of no override, and a bad tile raises
    before anything runs."""
    backend, state, lits = _backend_case(name)
    want = backend.fn(state, lits, None)
    assert int((want != 0).sum()) > 0
    grid = ANALOG_GOOD if autotune.is_analog(backend) else TM_GOOD
    for tiles in grid:
        if tiles.get("ks", 0) > 2:               # L = 64: two columns
            with pytest.raises(ValueError, match="tile"):
                backend.fn(state, lits, None, tiles=tiles)
            continue
        assert torch.equal(backend.fn(state, lits, None, tiles=tiles), want)
    bad = ANALOG_BAD[1] if autotune.is_analog(backend) else TM_BAD[0]
    with pytest.raises(ValueError, match="tile"):
        backend.fn(state, lits, None, tiles=bad)
    # the other family's keys are refused too: never a silent no-op
    other = TM_GOOD[0] if autotune.is_analog(backend) else ANALOG_GOOD[0]
    with pytest.raises(ValueError, match="tile"):
        backend.fn(state, lits, None, tiles=other)


# ------------------------------------------------------ engine consumers

def test_engine_consumes_registry_tuning_table():
    """A for_max_batch batcher picks up the measured buckets (capped at
    max_batch) and records which backend they were measured for; kernel
    tiles flow into the dispatch; a hand-picked ladder is never replaced
    (port of tests/test_serve.py's registry case)."""
    api.register_tuning("analog-cuda-packed2",
                        dict(ENTRY, tiles={"ks": 2, "ng": 1},
                             bucket_sizes=[8, 24, 96]),
                        shape_key=_my_key())
    eng = make_engine(batcher=BatcherConfig.for_max_batch(64))
    assert eng.backend.name == "analog-cuda-packed2"
    assert eng.shape_key == _my_key()
    assert eng.batcher.cfg.bucket_sizes == (8, 24, 64)
    assert eng.batcher.cfg.tuned_for == "analog-cuda-packed2"
    assert eng.summary()["kernel_tiles"] == {"ks": 2, "ng": 1}
    eng2 = make_engine(batcher=BatcherConfig(max_batch=16,
                                             bucket_sizes=(8, 16)))
    assert eng2.batcher.cfg.bucket_sizes == (8, 16)
    assert eng2.batcher.cfg.tuned_for is None


def _kernel_bench():
    """``benchmarks/kernel_bench_torch.py`` as a module."""
    path = Path(__file__).resolve().parents[1] / "benchmarks" / \
        "kernel_bench_torch.py"
    spec = importlib.util.spec_from_file_location("kernel_bench_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spy(eng):
    """Replace the engine's backend with one that records each call's
    keyword arguments."""
    calls = []
    fn = eng.backend.fn

    def spy(state, lits, generator, **kw):
        calls.append(kw)
        return fn(state, lits, generator, **kw)

    eng.backend = dataclasses.replace(eng.backend, fn=spy)
    return calls


@pytest.mark.parametrize("kind", ["analog", "coalesced"])
def test_tiles_reach_every_dispatch_probe_and_canary(kind):
    """The tuned tiles go into every fused call: dispatches, probe reads
    and canary reads (stable and candidate), and the answers equal an
    untuned engine's; install_pool keeps the tuning."""
    from repro_torch.serve import HealthConfig
    rng = np.random.default_rng(5)
    xs = (rng.random((40, CFG.n_features)) < 0.5).astype(np.uint8)
    if kind == "analog":
        name, tiles = "analog-cuda-packed2", {"ks": 2, "ng": 4}
        build = lambda **kw: make_engine(                  # noqa: E731
            batcher=BatcherConfig.for_max_batch(16), **kw)
    else:
        name, tiles = "coalesced-cuda-packed2", {"wm": 4, "wn": 1}
        ccfg = CoalescedConfig(n_classes=4, n_clauses=32, n_features=32)
        ta = _ta(tm.TMConfig(n_classes=4, clauses_per_class=8,
                             n_features=32, n_states=ccfg.n_states))
        w = torch.from_numpy(rng.integers(-5, 6, (32, 4)).astype(np.int32))

        def build(**kw):
            return ServeEngine.from_coalesced(
                ta, w, ccfg, device="cpu", ecfg=EngineConfig(
                    batcher=BatcherConfig.for_max_batch(16), **kw))
    plain = build()
    want = [r.pred for r in _serve(plain, xs)]
    api.register_tuning(name, dict(ENTRY, tiles=tiles),
                        shape_key=plain.shape_key)
    eng = build(health=HealthConfig(n_probes=8))
    calls = _spy(eng)
    assert [r.pred for r in _serve(eng, xs)] == want
    assert calls and all(c == {"tiles": tiles} for c in calls)
    n = len(calls)
    eng.probe()
    assert len(calls) > n and all(c == {"tiles": tiles} for c in calls)
    eng.arm_canary(eng.state if kind == "coalesced" else eng._slices[0],
                   version=1, fraction=1.0)
    n = len(calls)
    _serve(eng, xs[:8])
    assert len(calls) >= n + 2 and all(c == {"tiles": tiles} for c in calls)
    eng.disarm_canary()
    eng.install_pool(eng.pool)
    assert eng.summary()["kernel_tiles"] == tiles
    assert eng.summary()["buckets_tuned_for"] == name


def _serve(eng, xs):
    rids = eng.submit_many(list(xs))
    out = {r.rid: r for r in eng.drain()}
    return [out[i] for i in rids]


# -------------------------------------------------------- kernel_bench CLI

def test_kernel_bench_smoke_on_the_host(capsys):
    """``benchmarks/kernel_bench_torch.py --smoke --device cpu`` tunes every
    fused backend over the plain versions and writes nothing."""
    kb = _kernel_bench()
    entries = kb.main(["--smoke", "--device", "cpu",
                       "--require-backend", "coalesced-cuda-packed2"])
    out = capsys.readouterr().out
    assert "SMOKE PASS: 8 (backend, shape) cells" in out
    assert set(entries) == set(autotune.KERNEL_OF)
    pairs = kb.plane_pair_report(entries)
    assert {p["after"] for p in pairs} == {"analog-cuda-packed2",
                                           "coalesced-cuda-packed2"}
    assert [w for w, _ in kb.full_widths()] == [
        "imbue-tm-mnist", "kws6", "anomaly", "coalesced",
        "stream-coalesced"]
    assert [api.shape_key_of(s) for _, s in kb.full_widths()] == [
        "c2048-l2048", "c2048-l1024", "c1024-l512", "c1024-l2048",
        "c1024-l1024"]
    json.dumps(entries)                       # JSON-shaped


def test_kernel_roofline_on_the_h100():
    kb = _kernel_bench()
    r = kb.kernel_roofline(128, 2000, 1568, m=10, r=4, analog=True,
                           dev=True)
    assert r["bound_by"] == "operations"
    assert r["t_operations_s"] == pytest.approx(
        4 * 4 * 128 * 2000 * 1568 / 67e12)
    t = kb.kernel_roofline(128, 1000, 1568, m=10)
    assert t["t_operations_s"] == pytest.approx(
        128 * 1000 * 49 / (64 * 132 * 1.98e9) + 2 * 128 * 1000 * 10 / 67e12)
    assert kb.resident_bytes("analog-cuda-packed2", CFG_SHAPE) == 4 * 32 * 2
    assert kb.resident_bytes("analog-cuda", CFG_SHAPE) == 8 * 32 * 64
    assert kb.resident_bytes("coalesced-cuda", CFG_SHAPE) == 32 * 64
