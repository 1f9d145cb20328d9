"""Where a benchmark cell's traced window goes, by the program's spans
(``repro_torch.*``, ``src/repro_torch/trace.py``):

    python3 benchmarks/profile_spans.py --workload kmnist-train-b256 --seed 0 --seconds 20

Sets the cell up as ``imbue_bench/run.py`` does, traces ``--seconds`` of
its window under ``torch.profiler`` (CPU + CUDA) and prints one JSON
line: the steps or calls in the window, its milliseconds and the card's
busy ones, and for each span name (``null``: no span open, the harness's
own loop) its count, the host milliseconds with it open (``incl_ms``)
and innermost (``own_ms``), and the card's idle milliseconds while it is
innermost (``idle_ms``), each a step or a call; last the card's name and
power limit.  Host times are the traced ones: they carry the profiler's
own cost of about 15 us an aten operation, so a host phase reads longer
than it runs untraced.

Needs a CUDA card (``--device cpu`` runs it on the host, for a test).
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _path in (ROOT / "src", ROOT):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))
if __name__ == "__main__":
    # One host thread for torch's CPU work, as imbue_bench/run.py runs.
    os.environ["OMP_NUM_THREADS"] = "1"

import torch  # noqa: E402

from imbue_bench import harness, spans  # noqa: E402
from imbue_bench import trace as tracing  # noqa: E402


def profile(root, workload: str, seed: int, seconds: float, device) -> dict:
    """The traced window of ``workload`` in the checkout at ``root``,
    broken down by span as the module's docstring says."""
    root = Path(root)
    _, config, traffic = harness.resolve(root, harness.load_manifest(root),
                                         workload)
    runner = harness.kind_module(traffic).Cell(device=device, seed=seed,
                                               config=config,
                                               traffic=traffic)
    runner.setup()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    counters, tr = tracing.capture(lambda: runner.window(seconds))
    runner.free()
    units = counters.get("steps") or counters["calls"]
    ms = 1e-3 / units
    return {"workload": workload, "seed": seed, "units": units,
            "window_ms": tr.window_s * 1e6 * ms,
            "busy_ms": tr.busy_s * 1e6 * ms,
            "spans": {name: {"count": row["count"] / units,
                             "incl_ms": row["incl_us"] * ms,
                             "own_ms": row["own_us"] * ms,
                             "idle_ms": row["idle_us"] * ms}
                      for name, row in spans.by_span(tr).items()}}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("profile_spans: needs a CUDA card", file=sys.stderr)
            return 2
        torch.cuda.set_device(0)
    out = profile(ROOT, args.workload, args.seed, args.seconds,
                  torch.device(args.device, 0) if args.device == "cuda"
                  else torch.device(args.device))
    out["card"] = card() if args.device == "cuda" else "host CPU"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
