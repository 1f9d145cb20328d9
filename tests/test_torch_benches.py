"""The port's serve / stream benches and paper-table benches on the CPU.

* ``serve_bench_torch --smoke`` and ``stream_bench_torch --smoke`` pass
  on the host (their bit-exactness, fallback, lazy-tuning and degraded
  checks), and neither creates or changes the reference's committed
  ``BENCH_serve.json`` / ``BENCH_stream.json`` (bytes before and after).
* ``paper_tables_torch``: the rows that draw nothing (Tables I, II and
  IV, Figs. 5, 6, 8 and 9, the column widths' margins) equal the
  reference's, exactly or within rtol 1e-6 where float order may differ;
  the rows that draw (Table III, Fig. 7, the miss rates) are held to the
  reference's by mean within the tolerances stated at each check.
"""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import ablations as ref_ablations  # noqa: E402
from benchmarks import ablations_torch  # noqa: E402
from benchmarks import paper_tables as ref_tables  # noqa: E402
from benchmarks import paper_tables_torch as tables  # noqa: E402
from benchmarks import run_torch  # noqa: E402
from benchmarks import serve_bench_torch, stream_bench_torch  # noqa: E402
from repro.core import tm as ref_tm  # noqa: E402
from repro_torch import api  # noqa: E402

COMMITTED = [ROOT / "BENCH_serve.json", ROOT / "BENCH_stream.json"]


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


@pytest.fixture
def committed_untouched(tmp_path, monkeypatch):
    """Run in an empty directory; afterwards the committed bench files
    hold the same bytes and the directory is still empty.  The tuning
    registry is restored (a lazy host measurement registers an entry)."""
    before = {p: p.read_bytes() if p.exists() else None for p in COMMITTED}
    snap = api.tuning_snapshot()
    monkeypatch.chdir(tmp_path)
    yield
    api.restore_tuning(snap)
    assert {p: p.read_bytes() if p.exists() else None
            for p in COMMITTED} == before
    assert list(tmp_path.iterdir()) == []


def test_serve_bench_smoke_passes(committed_untouched, capsys):
    report = serve_bench_torch.main(["--smoke", "--device", "cpu"])
    assert report["smoke_ok"] is True
    assert report["device"] == "host CPU, plain PyTorch versions"
    assert report["planes_after_r4_b64"]["backend"] == "analog-cuda-packed2"
    assert report["capacity_coalesced_b64"]["backend"].startswith(
        "coalesced")
    deg = report["degraded_ensemble_r4_b64"]
    assert deg["quarantined_during_degraded"] == [1] and deg["recovered"]
    assert "SMOKE PASS" in capsys.readouterr().out


def test_stream_bench_smoke_passes(committed_untouched):
    report = stream_bench_torch.main(["--smoke", "--device", "cpu"])
    assert report["smoke_ok"] is True
    assert report["lazy_tuning"]["lazy"] is True
    assert report["margin_bit_exact"] is True
    assert report["cell"]["forward_fallbacks"] == []


def _firing_ta(cfg, rows, seed, k=3):
    """A TA state whose every clause includes ``k`` literals that are on
    in one window row drawn from ``rows``: each clause fires on its row
    and on rows like it."""
    rng = np.random.default_rng(seed)
    lits = np.concatenate([rows, 1 - rows], axis=1)
    inc = np.zeros((cfg.n_clauses, cfg.n_literals), bool)
    for c in range(cfg.n_clauses):
        on = np.flatnonzero(lits[rng.integers(len(rows))])
        inc[c, rng.choice(on, size=k, replace=False)] = True
    return np.where(inc, cfg.n_states + 1, cfg.n_states).astype(np.int16)


@pytest.mark.parametrize("broken", [False, True],
                         ids=["intact", "oracle-off-by-one"])
def test_stream_bench_checks_bite_where_clauses_fire(broken, monkeypatch):
    """The benches' models are the reference's: 10 % random includes over
    2F literals, whose clauses almost never fire, so at the bench shapes
    the smoke's bit-exact checks compare sums that are nearly all 0.  The
    same two checks (``check_bit_exact``, ``check_margin_bit_exact``) on
    the smoke geometry with models whose clauses fire: the window sums are
    the reference's ``tm.forward`` on the same rows and mostly non-zero,
    and each check passes, or fails when its oracle is moved by one
    (``broken``)."""
    sb = stream_bench_torch
    geo, ageo = sb.SMOKE, sb.ANOMALY_SMOKE
    cfg, _, booleanizer = sb.make_kws_model("cpu", **geo)
    acfg, _, abool = sb.make_anomaly_model("cpu", **ageo)
    scfg = sb.StreamConfig(window=geo["window"], hop=4, vote=5)
    ascfg = sb.StreamConfig(window=ageo["window"], hop=ageo["hop"], vote=3,
                            decision="margin", margin_class=1,
                            margin_threshold=0.0)
    streams = sb.session_streams(2, 48, geo["n_mels"])
    astreams = sb.sensor_streams(2, 32, ageo["n_sensors"])
    cases = []
    for c, b, w, hop, ss in ((cfg, booleanizer, geo["window"], 4, streams),
                             (acfg, abool, ageo["window"], ageo["hop"],
                              astreams)):
        rows = np.concatenate([sb.StreamingBooleanizer(b, w, hop)
                               .transform_offline(x) for x in ss])
        ta = _firing_ta(c, rows, seed=len(cases))
        sums = sb.tm.forward(torch.from_numpy(ta), torch.from_numpy(rows),
                             c).numpy()
        rcfg = ref_tm.TMConfig(n_classes=c.n_classes,
                               clauses_per_class=c.clauses_per_class,
                               n_features=c.n_features, n_states=c.n_states)
        np.testing.assert_array_equal(sums, np.asarray(ref_tm.forward(
            jnp.asarray(ta), jnp.asarray(rows), rcfg)))
        assert np.mean(sums != 0) > 0.5, np.mean(sums != 0)
        cases.append(torch.from_numpy(ta))
    if broken:
        predict, forward = sb.api.predict, sb.tm.forward
        monkeypatch.setattr(sb.api, "predict", lambda *a, **k: (
            predict(*a, **k) + 1) % cfg.n_classes)
        monkeypatch.setattr(sb.tm, "forward", lambda ta, x, c: forward(
            ta, x, c) + torch.tensor([0, 1]))
        with pytest.raises(AssertionError, match="not equal"):
            sb.check_bit_exact(cfg, cases[0], booleanizer, scfg, streams,
                               "cpu")
        with pytest.raises(AssertionError, match="not equal"):
            sb.check_margin_bit_exact(acfg, cases[1], abool, ascfg,
                                      astreams, "cpu")
    else:
        assert sb.check_bit_exact(cfg, cases[0], booleanizer, scfg,
                                  streams, "cpu")
        assert sb.check_margin_bit_exact(acfg, cases[1], abool, ascfg,
                                         astreams, "cpu")


def _rows(fn):
    rows, checks = fn()
    assert all(ok for _, ok, _ in checks), checks
    return rows


@pytest.mark.parametrize("name", ["table_i", "table_ii", "table_iv",
                                  "fig5_programming", "fig6_timing",
                                  "fig8_pulse", "fig9_topj"])
def test_analytic_rows_equal_the_reference(name):
    got = _rows(getattr(tables, name))
    want = _rows(getattr(ref_tables, name))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            if isinstance(b, (list, tuple)):
                np.testing.assert_allclose(np.asarray(a, float),
                                           np.asarray(b, float), rtol=1e-6)
            else:
                assert a == pytest.approx(b, rel=1e-6, abs=0)


def test_table_iii_by_mean():
    """2000 draws a row: the mean drive voltages within 1 % (their
    standard errors are ~0.1 %), the miss rates within 0.04 (4 combined
    standard errors at a rate of 0.1)."""
    got = {r[0]: r[1] for r in _rows(lambda: tables.table_iii(
        device="cpu"))}
    want = {r[0]: r[1] for r in _rows(ref_tables.table_iii)}
    assert got.keys() == want.keys()
    assert got["csa_mc_draws"] == want["csa_mc_draws"]
    assert got["vref_mV"] == pytest.approx(want["vref_mV"], rel=1e-6)
    for k in ("viol_mean_mV", "leak_mean_mV"):
        assert got[k] == pytest.approx(want[k], rel=0.01)
    for k in ("err_violation_sensed_high", "err_leak_allzero_corner"):
        assert abs(got[k] - want[k]) <= 0.04


def test_fig7_by_mean():
    """10,000 D2D draws: the means within 2 % (HRS, lognormal) and 0.5 %
    (LRS); the extremes at the clip bounds within 2 %; the C2C excursion
    within 0.1 points of the reference's (both reach ~5 %)."""
    got = {r[0]: r[1] for r in _rows(lambda: tables.fig7_variations(
        device="cpu"))}
    want = {r[0]: r[1] for r in _rows(ref_tables.fig7_variations)}
    assert got["hrs_mean_kohm"] == pytest.approx(want["hrs_mean_kohm"],
                                                  rel=0.02)
    assert got["lrs_mean_kohm"] == pytest.approx(want["lrs_mean_kohm"],
                                                  rel=0.005)
    for k in ("hrs_min_kohm", "hrs_max_kohm"):
        assert got[k] == pytest.approx(want[k], rel=0.02)
    assert abs(got["c2c_hrs_excursion_pct"]
               - want["c2c_hrs_excursion_pct"]) <= 0.1


def test_column_width_sweep_by_mean():
    """The margins are analytic (rtol 1e-6); each miss rate of 4000 draws
    within 0.05 of the reference's (4 combined standard errors at 0.5)."""
    got = _rows(lambda: ablations_torch.column_width_sweep(device="cpu"))
    want = _rows(ref_ablations.column_width_sweep)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        assert g[1] == pytest.approx(w[1], rel=1e-6)
        assert abs(g[2] - w[2]) <= 0.05


def test_run_torch_fast_passes_every_check(capsys, monkeypatch):
    # One timed rep of the kernel bench: its full-width plain versions
    # cost ~0.2 s a rep on the host.
    bench = run_torch.kernel_bench_torch.bench
    monkeypatch.setattr(run_torch.kernel_bench_torch, "bench",
                        lambda device: bench(reps=1, device=device))
    out = run_torch.main(["--fast", "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.splitlines()[0] == ("# device: host CPU, plain PyTorch "
                                    "versions")
    assert all(ok for _, ok, _ in out["checks"])
    assert {"kernel/imbue_infer_planes_equals_ref",
            "kernel/tm_infer_planes_equals_ref"} <= {
        name for name, _, _ in out["checks"]}
