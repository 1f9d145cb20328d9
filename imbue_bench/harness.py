"""One run of one cell: read the manifest, set the cell up, measure the
window, read the per-layer metrics, judge the outputs, and build the
result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name in ``BENCHMARK.json``:

* a configuration's file is the manifest's ``file``; it names its plain
  reference, a module of ``imbue_bench/reference/``;
* a traffic mix is ``<paths[0]>/traffic/<traffic>.json``, whose ``kind``
  names the general generator that reads it, a module of
  ``imbue_bench/kinds/``;
* a per-layer metric is read by ``<paths[0]>/metrics/<name>.py``, whose
  ``read(ctx)`` returns its value or None when its trace holds nothing
  for it.

``run_cell`` takes the device: ``run.py`` gives it the card and nothing
else; the tests give it the host.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

BANNED = frozenset({"jax", "jaxlib", "flax", "repro"})


class RunError(RuntimeError):
    """A run that must print no result."""


def banned_modules(names) -> list:
    """The loaded modules whose top-level name, the part before the first
    dot, is one of ``BANNED`` (compared whole: ``repro_torch`` is not
    ``repro``)."""
    return sorted({n.split(".")[0] for n in names} & BANNED)


def load_manifest(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def resolve(root: Path, manifest: dict, workload: str):
    """``(cell, configuration file, traffic file)`` of ``workload``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = json.loads((Path(root) / conf["file"]).read_text())
    traffic = json.loads((bench_dir(root, manifest) / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def bench_dir(root: Path, manifest: dict) -> Path:
    return Path(root) / manifest["paths"][0]


def applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_reader(root: Path, manifest: dict, name: str):
    path = bench_dir(root, manifest) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"imbue_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(traffic: dict):
    return importlib.import_module(f"imbue_bench.kinds.{traffic['kind']}")


def check_program(root: Path) -> None:
    """The program must be the checkout's own ``src/repro_torch``."""
    import repro_torch
    where = Path(repro_torch.__file__).resolve()
    src = (Path(root) / "src").resolve()
    if src not in where.parents:
        raise RunError(f"repro_torch was loaded from {where}, not {src}")


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             *, device, t_start: float, chips: int | None = None,
             loaded_before=frozenset()):
    """Run one cell; returns ``(result, lines for standard error)``: what
    the check covered, if the cell says, then each number compared beside
    its limit.  ``chips`` is the number of cards the run uses (None on the
    host).  A module of ``BANNED`` loaded by the time the result is built
    is a ``RunError``; the tests, whose process has loaded JAX for other
    tests, pass the modules loaded before the run as ``loaded_before``."""
    root = Path(root)
    manifest = load_manifest(root)
    _, config, traffic = resolve(root, manifest, workload)
    check_program(root)
    cuda = torch.device(device).type == "cuda"
    runner = kind_module(traffic).Cell(device=device, seed=seed,
                                       config=config, traffic=traffic)
    runner.setup()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    tr = None
    if trace:
        from imbue_bench import trace as tracing
        counters, tr = tracing.capture(lambda: runner.window(seconds))
    else:
        counters = runner.window(seconds)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    attempted, failed = runner.attempted_failed(counters)
    runner.free()
    checks = runner.judge()

    metrics = {}
    if trace:
        ctx = SimpleNamespace(config=config, traffic=traffic,
                              counters=counters, shape=runner.shape(),
                              trace=tr)
        for entry in manifest["per_layer"]:
            if applies(entry, workload):
                value = load_reader(root, manifest, entry["name"]).read(ctx)
                if value is not None:
                    metrics[entry["name"]] = {"value": value,
                                              "unit": entry["unit"]}
    else:
        values = dict(counters, setup_s=setup_s)
        for entry in manifest["end_to_end"]:
            if applies(entry, workload):
                metrics[entry["name"]] = {"value": values[entry["name"]],
                                          "unit": entry["unit"]}
    # Last, once the window, the judging and the readers have run.
    found = banned_modules(set(sys.modules) - set(loaded_before))
    if found:
        raise RunError(f"modules loaded in the run: {', '.join(found)}")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "host CPU",
           "count": chips or 1, "memory_peak_bytes": memory_peak}
    if trace:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = tr.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    notes = getattr(runner, "notes", list)()
    lines = notes + [f"check {name}: {v!r} (limit {lim!r})"
                     for name, v, lim in checks]
    return result, lines
