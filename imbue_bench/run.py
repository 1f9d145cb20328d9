"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of IMBUE:

    python imbue_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cards the cell asks
for (``BENCHMARK.json``).  It drives the checkout's ``src/repro_torch``
and nothing else, measures ``--seconds`` of the cell's traffic after its
set-up, judges what the window produced against the plain reference, and
prints the result as the last line of standard output: one JSON object
with ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, read from a
``torch.profiler`` trace of the whole window), ``device``, with ``--trace
1`` ``breakdown``, and last ``checks``, each number compared beside its
limit.  Those numbers are also the last lines of standard error.

It exits with another code than 0, and prints no result, without CUDA or
with fewer cards than the cell asks for, without the checkout's program,
or when a module of JAX or of the JAX package ``repro`` was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# A library that would load JAX on its own must not (transformers: USE_FLAX).
os.environ.setdefault("USE_FLAX", "0")
# One host thread for torch's CPU work: the cells' work is on the card.
# With the default intra-op threads the training cell's rate swung by
# 10 % between runs on an H100 machine with a busy host, 1.7 % with one.
os.environ["OMP_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    torch.set_num_threads(1)

    from imbue_bench import harness
    try:
        manifest = harness.load_manifest(ROOT)
        cell, _, _ = harness.resolve(ROOT, manifest, args.workload)
        if not torch.cuda.is_available():
            raise harness.RunError("CUDA is not available")
        if torch.cuda.device_count() < cell["chips"]:
            raise harness.RunError(
                f"{args.workload} needs {cell['chips']} cards, "
                f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(0)
        result, lines = harness.run_cell(
            ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
            device=torch.device("cuda", 0), t_start=T_START,
            chips=cell["chips"])
    except (harness.RunError, ImportError, FileNotFoundError) as exc:
        print(f"imbue_bench: {exc}", file=sys.stderr)
        return 2
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
