"""Tiny runs of the harness on the host: the result line, the per-name
layout, the whole-name module check and the runs that must print no
result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from imbue_bench import harness
from imbue_bench.tests import tiny
from imbue_bench.tests.tiny import one_thread  # noqa: F401

CELLS = ["kmnist-train-b256", "mnist-r4-analog-score", "kmnist-digital-score"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_result_line(root, cell):
    result, lines = tiny.run(root, cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    manifest = harness.load_manifest(root)
    want = {m["name"] for m in manifest["end_to_end"]
            if harness.applies(m, cell)}
    assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    (name, check), = result["checks"].items()
    # The compared numbers are the last lines of standard error.
    assert lines[-1] == (f"check {name}: {check['value']!r} "
                         f"(limit {check['limit']!r})")
    assert all(not line.startswith("check ") for line in lines[:-1])
    json.dumps(result, allow_nan=False)


def test_traced_result_line(root):
    result, _ = tiny.run(root, "kmnist-digital-score", trace=True)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # The host runs no device operation: only the host-clock readers read.
    assert set(result["metrics"]) == {"score_mfu", "call_p95_ms.digital"}


def test_dummy_config_traffic_and_metric_are_picked_up(root, tmp_path):
    """A new configuration, traffic mix and per-layer metric, each a file
    of its own plus its manifest entry, run with no edit to a file the
    benchmark has."""
    new = tmp_path / "checkout"
    shutil.copytree(root, new, symlinks=True)
    bench = new / "imbue_bench"
    conf = json.loads((bench / "configs" / "imbue-tm-kmnist.json")
                      .read_text())
    conf.update(name="dummy-tm", clauses_per_class=10)
    (bench / "configs" / "dummy-tm.json").write_text(json.dumps(conf))
    traffic = json.loads((bench / "traffic" / "digital_score.json")
                         .read_text())
    traffic["outstanding"] = 3
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "dummy_rows.py").write_text(
        "def read(ctx):\n    return float(ctx.counters['rows'])\n")
    manifest = json.loads((new / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "dummy-tm", "source": "x",
                                "file": "imbue_bench/configs/dummy-tm.json",
                                "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": "dummy-cell", "config": "dummy-tm",
                                  "traffic": "dummy_mix", "chips": 1,
                                  "why": "a test"})
    manifest["end_to_end"][2]["workloads"].append("dummy-cell")
    manifest["per_layer"].append({
        "name": "dummy_rows", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "api",
        "moves": "score_rows_per_s", "workloads": ["dummy-cell"]})
    (new / "BENCHMARK.json").write_text(json.dumps(manifest))
    result, _ = tiny.run(new, "dummy-cell")
    assert result["correct"] and set(result["metrics"]) == {
        "setup_s", "score_rows_per_s"}
    result, _ = tiny.run(new, "dummy-cell", trace=True)
    assert result["metrics"]["dummy_rows"]["value"] == (
        result["attempted"] * tiny.IMAGES["test_rows"])


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.api", "reprod", "jaxtyping", "flaxen"],
     []),
    (["repro", "torch"], ["repro"]),
    (["repro.core.tm", "jax.numpy", "jaxlib", "flax.linen"],
     ["flax", "jax", "jaxlib", "repro"]),
])
def test_banned_modules_compare_whole_names(names, found):
    assert harness.banned_modules(names) == found


def test_a_run_that_loads_jax_prints_no_result(root, monkeypatch):
    """The program loads a module named ``jax`` during the window: the run
    raises and prints nothing."""
    from repro_torch import api
    class_sums = api.class_sums

    def loads_jax(*args, **kw):
        monkeypatch.setitem(sys.modules, "jax", sys)
        return class_sums(*args, **kw)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.setattr(api, "class_sums", loads_jax)
    with pytest.raises(harness.RunError, match="jax"):
        tiny.run(root, "kmnist-digital-score")


def test_a_metric_that_loads_jax_prints_no_result(root, tmp_path):
    """A per-layer reader, which runs after the window and the judging,
    loads a module named ``jax``: the run raises and prints nothing."""
    new = tmp_path / "checkout"
    shutil.copytree(root, new, symlinks=True)
    (new / "imbue_bench" / "metrics" / "score_mfu.py").write_text(
        "import sys\n\n\ndef read(ctx):\n"
        "    sys.modules['jax'] = sys\n    return 1.0\n")
    saved = sys.modules.pop("jax", None)
    try:
        with pytest.raises(harness.RunError, match="jax"):
            tiny.run(new, "kmnist-digital-score", trace=True)
    finally:
        if saved is None:
            sys.modules.pop("jax", None)
        else:
            sys.modules["jax"] = saved


def _run_py(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "imbue_bench/run.py", "--workload",
         "kmnist-digital-score", "--seed", "2147483999", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120)


def test_no_result_without_a_card():
    """Here there is no CUDA: the run exits non-zero and prints nothing on
    standard output."""
    proc = _run_py(tiny.ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(tiny.BENCH, tmp_path / "imbue_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
    # Past the look for a card: the program loaded is not the checkout's.
    with pytest.raises(harness.RunError, match="not"):
        tiny.run(tmp_path, "kmnist-digital-score")
