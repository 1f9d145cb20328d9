"""Render a dry run's JSON (``launch.dryrun --out``) into the roofline
tables (port of ``repro.roofline.report``).

    PYTHONPATH=src python -m repro_torch.roofline.report dryrun_results.json

The records carry the reference's keys, so either package's JSON renders
here; the port's records time the trace (``trace_s``) where the
reference's time a compile (``compile_s``).
"""

from __future__ import annotations

import json
import sys
from typing import List


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.1f}us"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def table(results: List[dict], mesh_filter: str) -> str:
    rows = [r for r in results
            if ("pod" in r["mesh"]) == (mesh_filter == "multi")]
    out = ["| arch | shape | compute | memory | collective | dominant |"
           " MODEL/HLO flops | step bound (s) |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        bound = max(r["compute_s"], r["memory_s"], r["collective_s"])
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} "
            f"| {fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} "
            f"| {r['dominant']} | {r['useful_ratio']:.3f} "
            f"| {fmt_s(bound)} |")
    return "\n".join(out)


def dryrun_table(results: List[dict]) -> str:
    out = ["| arch | shape | mesh | global FLOPs | global bytes |"
           " collective bytes | peak GiB / device | trace (s) |",
           "|---|---|---|---|---|---|---|---|"]
    for r in results:
        mem = r.get("memory_analysis")
        peak = (f"{mem['peak_bytes'] / 2 ** 30:.1f}"
                if isinstance(mem, dict) else "-")
        secs = r.get("trace_s", r.get("compile_s", 0))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['hlo_flops']:.2e} | {r['hlo_bytes']:.2e} "
            f"| {r['collective_bytes']:.2e} | {peak} | {secs} |")
    return "\n".join(out)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "dryrun_results.json"
    with open(path) as f:
        d = json.load(f)
    print("## Single-pod (16x16 = 256 ranks)\n")
    print(table(d["results"], "single"))
    print("\n## Multi-pod (2x16x16 = 512 ranks)\n")
    print(table(d["results"], "multi"))
    print("\n## Per cell\n")
    print(dryrun_table(d["results"]))
    print("\n## Skipped cells\n")
    for s in d.get("skipped", []):
        print(f"- {s['arch']} x {s['shape']}: {s['reason']}")


if __name__ == "__main__":
    main()
