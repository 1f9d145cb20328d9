"""Where a serving dispatch's time goes on the card: the live path's
analog configuration (``chip_smoke.MODEL``, R = ``chip_smoke.REPLICAS``,
D2D + C2C) served by ``ServeEngine`` and ``AsyncServeEngine`` on one
seed, 512 requests a run, in ``chip_smoke.py``'s two arrival patterns
(``chunked``: 128 requests, then a ``pump()``; ``burst``: all, then
drained).

    PYTHONPATH=src python3 benchmarks/profile_serve.py [--runs 7]

Needs a CUDA card (it builds the port's kernels at first use).  Prints
one JSON line per (routing, pattern, engine): requests/s over ``--runs``
unprofiled runs (each on a fresh engine; median and quartiles), the
summed blocked collect wait per dispatch and ``overlap_fraction``, then
one traced run
(``torch.profiler``, CPU + CUDA): host ms per dispatch, device ms per
dispatch summed over the device-side events, the device idle share
(1 - device / host), the CUDA runtime calls that block the host
(``cudaStreamSynchronize``, ``cudaEventSynchronize``, ``cudaMemcpy*``)
per dispatch, and the device time by kernel name (top 8); and, from
``torch.cuda.set_sync_debug_mode``, the source line of each
synchronizing operation one ``_issue`` performs.  Last, the card's name
and power limit.
"""

import argparse
import json
import statistics
import subprocess
import sys
import warnings
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import chip_smoke  # noqa: E402
from repro_torch.configs.imbue_tm import tm_config  # noqa: E402
from repro_torch.core.variations import VariationConfig  # noqa: E402
from repro_torch.serve import (AsyncServeEngine, EngineConfig,  # noqa: E402
                               ServeEngine)

BLOCKING = ("cudaStreamSynchronize", "cudaEventSynchronize",
            "cudaDeviceSynchronize", "cudaMemcpy")
PATTERNS = {"chunked": chip_smoke.LIVE_CHUNK, "burst": chip_smoke.N_REQUESTS}


def engine(cls, cfg, ta, routing, device):
    return cls.from_ta_state(
        torch.from_numpy(ta), cfg, n_replicas=chip_smoke.REPLICAS,
        seed=chip_smoke.SEED, vcfg=VariationConfig(csa_offset=False),
        ecfg=EngineConfig(routing=routing), device=device)


def quartiles(vals):
    q = statistics.quantiles(vals, n=4)
    return {"median": statistics.median(vals), "q1": q[0], "q3": q[2]}


def issue_syncs(cfg, ta, x, routing, device):
    """Synchronizing CUDA operations inside one ``_issue`` (warm)."""
    eng = engine(ServeEngine, cfg, ta, routing, device)
    eng.submit_many(list(x[:chip_smoke.LIVE_CHUNK]))
    eng.drain()
    eng.submit_many(list(x[:chip_smoke.LIVE_CHUNK]))
    batch = eng.batcher.cut(eng.clock(), force=True)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fl = eng._issue(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    eng._collect(fl)
    # The mode's own notice that it is a prototype is not a sync.
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "called a synchronizing" in str(w.message)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serve: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cfg = tm_config(chip_smoke.MODEL)
    ta, x, _ = chip_smoke.prototype_task(cfg, chip_smoke.N_REQUESTS,
                                         chip_smoke.SEED + 900)
    for cls in (ServeEngine, AsyncServeEngine):          # warm-up, builds
        chip_smoke.serve_chunks(engine(cls, cfg, ta, "ensemble", device), x)
    for routing in ("ensemble", "round_robin"):
        syncs = issue_syncs(cfg, ta, x, routing, device)
        for pattern, chunk in PATTERNS.items():
            for cls in (ServeEngine, AsyncServeEngine):
                rps, waits, overlap = [], [], []
                for _ in range(args.runs):
                    eng = engine(cls, cfg, ta, routing, device)
                    out, wall = chip_smoke.serve_chunks(eng, x, chunk=chunk)
                    s = eng.summary()
                    rps.append(len(out) / wall)
                    waits.append(s["device_wait_s"] / s["batches"] * 1e3)
                    overlap.append(s["overlap_fraction"])
                eng = engine(cls, cfg, ta, routing, device)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    _, wall = chip_smoke.serve_chunks(eng, x, chunk=chunk)
                    torch.cuda.synchronize()
                n = eng.summary()["batches"]
                events = prof.key_averages()
                by_name = sorted(
                    ((e.key, e.self_device_time_total / 1e3 / n)
                     for e in events if e.device_type == DeviceType.CUDA),
                    key=lambda r: -r[1])
                device_ms = sum(ms for _, ms in by_name)
                host_ms = wall * 1e3 / n
                blocking = {e.key: e.count / n for e in events
                            if e.key.startswith(BLOCKING)}
                print(json.dumps({
                    "routing": routing, "pattern": pattern,
                    "engine": cls.__name__, "requests": len(x),
                    "dispatches": n, "runs": args.runs,
                    "requests_per_s": quartiles(rps),
                    "collect_wait_ms_per_dispatch": quartiles(waits),
                    "overlap_fraction": quartiles(overlap),
                    "traced": {
                        "host_ms_per_dispatch": host_ms,
                        "device_ms_per_dispatch": device_ms,
                        "device_idle_share": 1.0 - device_ms / host_ms,
                        "blocking_calls_per_dispatch": blocking,
                        "device_ms_by_kernel": [
                            {"name": k[:70], "ms_per_dispatch": ms}
                            for k, ms in by_name[:8]]},
                    "syncs_in_one_issue": syncs}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
