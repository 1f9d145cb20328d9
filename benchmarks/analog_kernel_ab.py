"""Time the analog, TM and clause-bit kernels of two checkouts on one CUDA
card, in turns.

    PYTHONPATH=src python3 benchmarks/analog_kernel_ab.py --parent DIR \
        [--turns 4] [--out FILE]

DIR holds another checkout of the repository (for example ``git archive
<commit> | tar -x -C DIR``).  The script runs itself once per turn in a
fresh process on DIR's ``src/`` (the parent) or on this checkout's (the
change), in the order parent, change, change, parent, ...  Each turn
builds that tree's kernels (the first time) and times, exactly as
``chip_smoke.py`` phase 5 does (CUDA events, median of 20, L2 flushed, the
host's enqueue hidden behind a spin kernel) and on the same inputs
(``chip_smoke.prototype_task`` at imbue-tm-mnist from ``chip_smoke.SEED``):

* ``imbue_infer_planes`` at R = 4 and R = 1 with the deviation plane and
  at R = 1 without it (nominal), B in {8, 64, 128};
* ``imbue_infer`` and ``imbue_infer_packed`` at R = 4 on D2D planes,
  B in {8, 64, 128};
* ``tm_infer_planes``, ``tm_infer_packed`` and ``tm_infer`` at the digital
  (C = 2000) and the coalesced (C = 1000) width, B in {8, 64, 128};
* ``clause_eval_packed`` and ``clause_eval`` at the same two widths, B in
  ``chip_smoke.CLAUSE_BATCHES`` (1, 8, 64, 208, 256; 256 is the batch
  training step, 208 an extra ragged batch).

Rows are keyed by kernel and shape: ``R`` / ``dev`` for the analog ones,
``C`` and ``B`` for the others (``R`` and ``dev`` null).

Each turn prints one JSON line; the last line is the summary: per row the
parent's and the change's median over their turns and parent / change,
beside the card's name and power limit.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCHES = (8, 64, 128)


def child(tree: Path, label: str) -> dict:
    """One turn on ``tree``'s kernels: ``{"tree", "rows": [...]}``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                 # puts this checkout's src first
    sys.path.insert(0, str(tree / "src"))   # ... and the tree's before it
    import torch
    from repro_torch.configs.imbue_tm import tm_config
    from repro_torch.kernels import _build, clause_eval, imbue_infer

    if not Path(imbue_infer.__file__).resolve().is_relative_to(
            tree.resolve()):
        raise RuntimeError(f"imported {imbue_infer.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    _build.build(["imbue_infer_planes", "imbue_infer", "imbue_infer_packed",
                  *cs.TM_KERNELS, *cs.CLAUSE_KERNELS])
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tm_config(cs.MODEL)
    ta, x, _ = cs.prototype_task(cfg, 128, cs.SEED)
    flush = torch.empty(256 * 2 ** 20 // 4, dtype=torch.float32,
                        device=device)
    rows = []
    for r, with_dev in ((cs.REPLICAS, True), (1, True), (1, False)):
        for b in BATCHES:
            args = cs.planes_case(cfg, ta, x[:b], r, with_dev, cs.SEED,
                                  device)
            rows.append({"kernel": "imbue_infer_planes", "R": r, "B": b,
                         "dev": with_dev, "ms": cs.time_ms(
                             lambda: imbue_infer.imbue_infer_planes(*args),
                             20, flush)})
    for b in BATCHES:
        cases, _ = cs.dense_case(cfg, ta, x[:b], cs.REPLICAS, True, cs.SEED,
                                 device)
        for name in ("imbue_infer", "imbue_infer_packed"):
            fn = getattr(imbue_infer, name)
            rows.append({"kernel": name, "R": cs.REPLICAS, "B": b,
                         "dev": True, "ms": cs.time_ms(
                             lambda: fn(*cases[name]), 20, flush)})
    for _, inc, comb, x in cs.tm_widths(device):
        for b in BATCHES:
            args, _ = cs.tm_case(inc, x[:b], comb, device)
            for name in cs.TM_KERNELS:
                fn = getattr(clause_eval, name)
                a = args["dense" if name == "tm_infer" else "packed"]
                rows.append({"kernel": name, "C": int(inc.shape[0]), "B": b,
                             "ms": cs.time_ms(lambda: fn(*a), 20, flush)})
    for _, inc, _, x in cs.tm_widths(device, n=max(cs.CLAUSE_BATCHES)):
        for b in cs.CLAUSE_BATCHES:
            args, _, _ = cs.clause_case(inc, x[:b], device)
            c = int(inc.shape[0])
            for name in cs.CLAUSE_KERNELS:
                fn = getattr(clause_eval, name)
                a = args[name]
                rows.append({"kernel": name, "C": c, "B": b,
                             "ms": cs.time_ms(lambda: fn(*a), 20, flush)})
    return {"tree": label, "path": str(tree), "rows": rows,
            "device": torch.cuda.get_device_name(0),
            "nvidia_smi": cs.nvidia_smi_line()}


def key(row):
    return (row["kernel"], row.get("R"), row.get("C"), row["B"],
            row.get("dev"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the other checkout")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--out", type=Path, help="also write the lines here")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--label", default="change", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child is not None:
        print(json.dumps(child(a.child, a.label)), flush=True)
        return 0
    if a.parent is None:
        ap.error("--parent is required")
    order = [("parent", a.parent), ("change", ROOT),
             ("change", ROOT), ("parent", a.parent)]
    turns = [order[i % 4] for i in range(a.turns)]
    lines = []
    for i, (label, tree) in enumerate(turns):
        res = subprocess.run([sys.executable, __file__, "--child", str(tree),
                              "--label", label], check=True,
                             capture_output=True, text=True, timeout=900)
        line = json.loads(res.stdout.strip().splitlines()[-1])
        line["turn"] = i
        lines.append(line)
        print(json.dumps(line), flush=True)
    by = {}
    for line in lines:
        for row in line["rows"]:
            by.setdefault(key(row), {}).setdefault(line["tree"], []).append(
                row["ms"])
    summary = []
    for (kernel, r, c_, b, dev), ms in by.items():
        p = statistics.median(ms["parent"]) if "parent" in ms else None
        c = statistics.median(ms["change"]) if "change" in ms else None
        summary.append({"kernel": kernel, "R": r, "C": c_, "B": b,
                        "dev": dev, "parent_ms": p, "change_ms": c,
                        "parent_over_change": p / c if p and c else None,
                        "parent_turns": ms.get("parent", []),
                        "change_turns": ms.get("change", [])})
    out = {"summary": summary, "device": lines[0]["device"],
           "nvidia_smi": lines[0]["nvidia_smi"],
           "order": [label for label, _ in turns]}
    print(json.dumps(out), flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text("\n".join(json.dumps(x) for x in [*lines, out])
                         + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
