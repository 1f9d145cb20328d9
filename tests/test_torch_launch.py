"""Port parity for the serving, chaos and retrain CLIs
(``repro_torch.launch.{serve,chaos,retrain}``).

* The reference's and the port's ``build_engine`` on one numpy TA state
  at nominal, R = 2, every routing, sync and async: the predictions equal
  each other and the digital TM.
* ``launch.serve.main`` on the CPU at one epoch: the summary carries the
  reference engine's ``summary()`` keys (but ``sharded`` / ``mesh``,
  which wait for the multi-device port) plus ``analog_accuracy``; at the
  defaults (CSA offset on) the engine warns and every dispatch is a
  counted fallback; bad ``--batch`` / ``--replicas`` exit like the
  reference's.
* The chaos and retrain ``--smoke`` runs reach their (unchanged)
  assertions on the CPU, sync and async.
"""

import argparse

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import tm as ref_tm  # noqa: E402
from repro.core.tm import TMConfig as RefTMConfig  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import tm  # noqa: E402
from repro_torch.data import tm_datasets  # noqa: E402
from repro_torch.launch import chaos, retrain, serve  # noqa: E402

CFG = dict(n_classes=4, clauses_per_class=8, n_features=32, n_states=100)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these runs are no faster on more, and the
    suite runs several workers side by side, whose thread pools would
    oversubscribe the cores and stretch a seconds-long smoke to
    minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed=0, n=40):
    """A ~10 %-include numpy TA state whose clauses fire on prototype
    rows, and ``n`` requests: prototypes with 10 % of bits flipped."""
    rng = np.random.default_rng(seed)
    cfg = tm.TMConfig(**CFG)
    protos = rng.random((cfg.n_classes, cfg.n_features)) < 0.5
    lit_protos = np.concatenate([protos, ~protos], axis=1)
    inc = np.zeros((cfg.n_clauses, cfg.n_literals), bool)
    for c in range(cfg.n_clauses):
        on = np.flatnonzero(lit_protos[c // cfg.clauses_per_class])
        inc[c, rng.choice(on, size=4, replace=False)] = True
    ta = np.where(inc, cfg.n_states + 1, cfg.n_states).astype(np.int16)
    y = rng.integers(0, cfg.n_classes, n)
    x = (protos[y] ^ (rng.random((n, cfg.n_features)) < 0.1)).astype(
        np.uint8)
    return cfg, ta, x


def _args(routing, async_serve, **kw):
    return argparse.Namespace(
        nominal=True, batch=16, max_wait_ms=2.0, routing=routing,
        backend=None, packed=True, max_in_flight=2, mesh=None,
        async_serve=async_serve, replicas=2, **kw)


def _serve_all(eng, x):
    eng.submit_many(list(x))
    eng.pump()
    return eng.drain()


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.mark.parametrize("async_serve", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("routing",
                         ["round_robin", "least_loaded", "ensemble"])
def test_build_engine_matches_the_reference(model, routing, async_serve):
    cfg, ta, x = model
    port = serve.build_engine(_args(routing, async_serve, device="cpu"),
                              cfg, convert.ta_from_numpy(ta, cfg, "cpu"))
    ref = ref_serve.build_engine(_args(routing, async_serve),
                                 RefTMConfig(**CFG), jnp.asarray(ta))
    assert type(port).__name__ == type(ref).__name__
    assert port.backend.name == "analog-cuda-packed2"
    assert not port.selection.fell_back
    got = _serve_all(port, x)
    want = _serve_all(ref, x)
    preds = [r.pred for r in got]
    assert preds == [r.pred for r in want]
    digital = tm.predict(convert.ta_from_numpy(ta, cfg, "cpu"),
                         torch.from_numpy(x), cfg).tolist()
    assert preds == digital
    assert preds == np.asarray(ref_tm.predict(
        jnp.asarray(ta), jnp.asarray(x), RefTMConfig(**CFG))).tolist()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.class_sums, np.asarray(b.class_sums))
    s = port.summary()
    assert s["fallback_dispatches"] == 0 and s["requests"] == len(x)


def test_serve_main_at_the_defaults_falls_back_loudly(model, capsys,
                                                     monkeypatch):
    """One epoch, 64 requests, the default VariationConfig(): no fused
    kernel models the CSA offset, so the engine warns, serves on
    analog-torch and counts every dispatch as a fallback.  The model the
    CLI trained, carried to the reference: its digital accuracy is the
    printed one, and the 64 analog answers (one chip a read, CSA offset
    and C2C drawn) score within 0.05 of the reference's digital TM on the
    same rows (the clause error under these variations is at most 1 %)."""
    cfg, ta, x = model
    ref_keys = set(ref_serve.build_engine(
        _args("round_robin", False), RefTMConfig(**CFG),
        jnp.asarray(ta)).summary())
    trained = {}
    build = serve.build_engine

    def keep_model(args, tm_cfg, ta_state):
        trained["ta"], trained["cfg"] = ta_state.cpu().numpy(), tm_cfg
        return build(args, tm_cfg, ta_state)

    monkeypatch.setattr(serve, "build_engine", keep_model)
    with pytest.warns(UserWarning, match="serve backend fallback"):
        summary = serve.main(["--device", "cpu", "--epochs", "1",
                              "--requests", "64", "--json"])
    out = capsys.readouterr().out
    assert "BACKEND FALLBACK" in out
    # sharded / mesh wait for the multi-device port (ROADMAP queue 1).
    assert ref_keys - {"sharded", "mesh"} <= set(summary)
    rcfg = RefTMConfig(**{k: getattr(trained["cfg"], k) for k in (
        "n_classes", "clauses_per_class", "n_features", "n_states",
        "threshold", "specificity")})
    _, _, xte, yte = (t.numpy() for t in tm_datasets.synthetic_image_dataset(
        torch.Generator().manual_seed(0), n_train=2000, n_test=2048,
        device="cpu"))
    printed = float(out.split("[serve] digital accuracy ")[1].split(",")[0])
    assert printed == pytest.approx(float(ref_tm.accuracy(
        jnp.asarray(trained["ta"]), jnp.asarray(xte),
        jnp.asarray(yte, jnp.int32), rcfg)), abs=5e-4)
    idx = np.random.default_rng(0).integers(0, xte.shape[0], size=64)
    digital = float(np.mean(np.asarray(ref_tm.predict(
        jnp.asarray(trained["ta"]), jnp.asarray(xte[idx]), rcfg))
        == yte[idx]))
    assert digital > 0.1 + 0.1, digital           # above chance (0.1)
    assert summary["analog_accuracy"] == pytest.approx(digital, abs=0.05)
    assert summary["requests"] == 64
    assert summary["backend"] == "analog-torch"
    assert summary["forward_fallbacks"]
    assert summary["fallback_dispatches"] == summary["batches"] > 0
    assert summary["device"] == "cpu"


@pytest.mark.parametrize("argv", [["--batch", "12"], ["--replicas", "0"],
                                  ["--batch", "136"]], ids=str)
def test_serve_main_rejects_bad_flags_like_the_reference(argv, capsys):
    with pytest.raises(SystemExit) as port_exit:
        serve.main([*argv, "--device", "cpu"])
    port_err = capsys.readouterr().err
    with pytest.raises(SystemExit) as ref_exit:
        ref_serve.main(argv)
    ref_err = capsys.readouterr().err
    assert port_exit.value.code == ref_exit.value.code == 2
    assert port_err.splitlines()[-1].split(": error: ")[1].split(" (")[0] \
        == ref_err.splitlines()[-1].split(": error: ")[1].split(" (")[0]


@pytest.mark.parametrize("extra", [[], ["--async-serve"]],
                         ids=["sync", "async"])
def test_chaos_smoke_holds(extra, tmp_path):
    out = tmp_path / "chaos.json"
    report = chaos.main(["--smoke", "--device", "cpu", "--smoke-out",
                         str(out), *extra])
    assert report["smoke_ok"] is True
    assert report["oracle_mismatches"] == 0
    assert report["rounds"][0]["quarantined"] == [0]
    assert out.exists()


@pytest.mark.parametrize("extra", [[], ["--async-serve"]],
                         ids=["sync", "async"])
def test_retrain_smoke_holds(extra, tmp_path):
    report = retrain.main(["--smoke", "--device", "cpu", "--checkpoint-dir",
                           str(tmp_path), *extra])
    assert report["smoke_ok"] is True
    assert [c["decision"] for c in report["cycles"]] == ["promote"]
    assert report["summary"]["expired"] == report["summary"]["rejected"] == 0
    assert set(report["summary"]["requests_by_version"]) == {"0", "1"}
