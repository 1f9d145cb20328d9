"""Render a dry run's JSON (``launch.dryrun --out``) into the roofline
tables (port of ``repro.roofline.report``).

    PYTHONPATH=src python -m repro_torch.roofline.report dryrun_results.json
    PYTHONPATH=src python -m repro_torch.roofline.report cells/*.json

Several files (one dry run a cell, say) are merged.

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


def rank_table(results: List[dict]) -> str:
    """What one rank counts of each cell: FLOPs, bytes, collective bytes,
    its peak memory and the cell's MODEL_FLOPS over the counted FLOPs."""
    out = ["| arch | shape | mesh | FLOPs / rank | bytes / rank |"
           " collective bytes / rank | peak GiB / rank | useful_ratio |",
           "|---|---|---|---|---|---|---|---|"]
    for r in results:
        per = r["per_device"]
        mem = r.get("memory_analysis")
        peak = (f"{mem['peak_bytes'] / 2 ** 30:.1f}"
                if isinstance(mem, dict) else "-")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {per['flops']:.3e} | {per['bytes']:.3e} "
            f"| {per['collective_bytes']:.3e} | {peak} "
            f"| {r['useful_ratio']:.4f} |")
    return "\n".join(out)


def load(paths: List[str]) -> dict:
    """One dry run's JSON, or several (one a cell, say) merged."""
    d = {"results": [], "failures": [], "skipped": []}
    for path in paths:
        with open(path) as f:
            part = json.load(f)
        d["results"] += part["results"]
        d["failures"] += part.get("failures", [])
        d["skipped"] = part.get("skipped", d["skipped"])
    return d


# What the port's collective term counts, printed beside its tables.
COLLECTIVE_NOTE = (
    "The port's collective bytes count each reduce-scatter it needs (an "
    "FSDP gradient, a sequence-parallel exit) as an all-reduce (x 2) and "
    "a slice, as the port runs it on every backend: gloo has no "
    "reduce-scatter.  On a backend that has one the term would be lower.")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    d = load(argv or ["dryrun_results.json"])
    print("## Single-pod (16x16 = 256 ranks)\n")
    print(table(d["results"], "single"))
    print("\n## Multi-pod (2x16x16 = 512 ranks)\n")
    print(table(d["results"], "multi"))
    print("\n## Per rank\n")
    print(rank_table(d["results"]))
    print(f"\n{COLLECTIVE_NOTE}")
    print("\n## Per cell\n")
    print(dryrun_table(d["results"]))
    if d["failures"]:
        print("\n## Failures\n")
        for f_ in d["failures"]:
            print(f"- {f_['arch']} x {f_['shape']} on {f_['mesh']}: "
                  f"{f_['error'][:200]}")
    print("\n## Skipped cells\n")
    for s in d.get("skipped", []):
        print(f"- {s['arch']} x {s['shape']}: {s['reason']}")


if __name__ == "__main__":
    main()
