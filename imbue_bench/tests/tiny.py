"""A checkout in a temporary directory whose cells are the benchmark's at
a size the host runs in seconds: the same manifest, readers and kinds,
with smaller configuration and traffic files (fewer clauses, 16 x 16 or
8 x 8 images with the border blank outside the box, fewer rows)."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

from imbue_bench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "imbue_bench"
if str(ROOT / "src") not in sys.path:         # as run.py puts it there
    sys.path.append(str(ROOT / "src"))
IMAGES = {"side": 16, "box": 8, "density": 0.25, "noise": 0.08,
          "train_rows": 512, "test_rows": 96}
# The K-MNIST cells' images are 8 x 8 with a 6 x 6 box: on them training
# leaves the all-but-empty start state within a few steps, and the
# window's checked steps fire clauses and move cells by every branch.
SMALL = dict(IMAGES, side=8, box=6)
SIZES = {"imbue-tm-mnist": {"clauses_per_class": 20, "n_features": 256},
         "imbue-tm-kmnist": {"clauses_per_class": 24, "n_features": 64}}
TRAFFIC = {"train_b256": {"batch": 64, "images": SMALL,
                          "check": {"window_steps": 8}},
           "analog_score_r4": {"images": IMAGES,
                               "check": {"reads": 3, "limit": 1e-05}},
           "digital_score": {"images": SMALL,
                             "check": {"reads": 3, "limit": 0}}}


def make_root(tmp: Path) -> Path:
    """A checkout at ``tmp``: the manifest, the benchmark's folder with
    its configuration and traffic files cut to the tiny sizes, and
    ``src`` linked to the program."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp / "imbue_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "src").symlink_to(ROOT / "src")
    for name, sizes in SIZES.items():
        path = tmp / "imbue_bench" / "configs" / f"{name}.json"
        conf = json.loads(path.read_text())
        conf.update(sizes)
        path.write_text(json.dumps(conf))
    for name, over in TRAFFIC.items():
        path = tmp / "imbue_bench" / "traffic" / f"{name}.json"
        traffic = json.loads(path.read_text())
        for key, value in over.items():
            if key != "images" and isinstance(value, dict):
                traffic[key].update(value)
            else:
                traffic[key] = value
        path.write_text(json.dumps(traffic))
    return tmp


def run(root: Path, workload: str, seed: int = 7, seconds: float = 0.3,
        trace: bool = False):
    """One tiny run on the host: ``(result, check lines)``.  Modules that
    this test process loaded before the run (JAX, for other tests) are
    not the run's."""
    torch.manual_seed(0)
    return harness.run_cell(root, workload, seed, seconds, trace,
                            device="cpu", t_start=time.perf_counter(),
                            loaded_before=frozenset(sys.modules))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as ``run.py`` runs: the tiny host ops of these
    runs slow down many times over when several test workers' thread
    pools share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
