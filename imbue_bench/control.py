"""The readings that a cell's limit is set from (not run by ``run.py``):

    python imbue_bench/control.py --workload <name> --seeds 1 2 3 ... [--seconds 1]

For each seed, in one process on the card: the cell's set-up, a short
window at the cell's own load (``--seconds``), the program's reading of
the number compared, and the readings of the cell's controls and faults
(``Cell.controls`` of its kind), each put in the program's place on the
same sampled calls or steps.  One JSON line a seed, then the card's name
and power limit.  The limit of a cell lies above the largest program
reading and below the smallest control reading (``PERF.md``).
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(root, workload: str, seed: int, seconds: float, device) -> dict:
    """The program's and the controls' readings of one seed."""
    from imbue_bench import harness
    manifest = harness.load_manifest(root)
    _, config, traffic = harness.resolve(root, manifest, workload)
    cell = harness.kind_module(traffic).Cell(device=device, seed=seed,
                                             config=config, traffic=traffic)
    cell.setup()
    t0 = time.perf_counter()
    cell.window(seconds)
    cell.free()
    (name, value, limit), = cell.judge()
    t_judge = time.perf_counter()
    notes = getattr(cell, "notes", list)()
    controls = cell.controls()
    return {"workload": workload, "seed": seed, "number": name,
            "program": value, "limit": limit, "controls": controls,
            "notes": notes,
            "window_and_judge_s": t_judge - t0,
            "controls_s": time.perf_counter() - t_judge}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(ROOT, args.workload, seed, args.seconds,
                                  torch.device("cuda", 0))), flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
