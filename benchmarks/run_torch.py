"""Benchmark driver of the PyTorch port: one function per paper table /
figure (port of ``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV rows plus a validation summary
(every check compares the port's result with the published value).  The
first line names the device every function ran on: on the card, its
name and power limit as ``nvidia-smi`` gives them; with ``--device cpu``,
the host and its plain versions.  ``us_per_call`` is the host clock
around one call of the function, ended by ``torch.cuda.synchronize()``
on the card.  ``kernels`` is ``kernel_bench_torch.bench``: the two
main-path kernels beside their ``kernels/ref.py`` oracles.

  PYTHONPATH=src python -m benchmarks.run_torch [--fast] [--device cpu]

``--fast`` skips the end-to-end TM training benches (the sequential XOR
fits take minutes on the port's host-loop trainer, PERF.md §5).
"""

from __future__ import annotations

import argparse
import functools
import inspect
import sys
import time

import torch

from benchmarks import ablations_torch, kernel_bench_torch, paper_tables_torch
from repro_torch._device import device_label, resolve_device


def kernels(device=None):
    """``kernel_bench_torch.bench`` as rows and checks: each kernel's time
    beside its oracle's and its bound; a check that the two agree."""
    out = kernel_bench_torch.bench(device=device)
    unit = "device_us" if resolve_device(device).type == "cuda" else \
        "host_us"
    rows = [(r["kernel"], r[unit], r["ref_" + unit], r["bound_us"])
            for r in out]
    checks = [(f"kernel/{r['kernel']}_equals_ref", r["ref_equal"],
               f"B={r['B']} C={r['C']} L={r['L']}") for r in out]
    return rows, checks


def benches(fast: bool):
    out = [
        ("table_i", paper_tables_torch.table_i),
        ("table_ii", paper_tables_torch.table_ii),
        ("table_iii", paper_tables_torch.table_iii),
        ("table_iv", paper_tables_torch.table_iv),
        ("fig5_programming", paper_tables_torch.fig5_programming),
        ("fig6_timing", paper_tables_torch.fig6_timing),
        ("fig7_variations", paper_tables_torch.fig7_variations),
        ("fig8_pulse", paper_tables_torch.fig8_pulse),
        ("fig9_topj", paper_tables_torch.fig9_topj),
        ("kernels", kernels),
        ("ablation_column_width", ablations_torch.column_width_sweep),
    ]
    if not fast:
        out += [("tm_accuracy", paper_tables_torch.tm_accuracy),
                ("tm_image_accuracy", paper_tables_torch.tm_image_accuracy),
                ("ablation_coalesced", ablations_torch.coalesced_vs_vanilla)]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="skip the slow end-to-end TM training benches")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    all_checks, results = [], {}
    print(f"# device: {device_label(device)}")
    print("name,us_per_call,derived")
    for name, fn in benches(args.fast):
        if "device" in inspect.signature(fn).parameters:
            fn = functools.partial(fn, device=device)
        t0 = time.perf_counter()
        rows, checks = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        us = (time.perf_counter() - t0) * 1e6
        print(f"{name},{us:.0f},rows={len(rows)}")
        for row in rows:
            print(f"{name}/{row[0]},,{','.join(str(v) for v in row[1:])}")
        all_checks.extend(checks)
        results[name] = {"us": us, "rows": rows}

    print("\n=== validation against published values ===")
    n_ok = 0
    for cname, ok, detail in all_checks:
        print(f"[{'PASS' if ok else 'FAIL'}] {cname}: {detail}")
        n_ok += bool(ok)
    print(f"{n_ok}/{len(all_checks)} checks passed")
    if n_ok != len(all_checks):
        sys.exit(1)
    return {"device": device_label(device), "checks": all_checks,
            "benches": results}


if __name__ == "__main__":
    main()
