"""Where a batch training step's time goes on the card: one
``repro_torch.core.tm_train.train_step_batch`` at imbue-tm-mnist,
B = ``chip_smoke.TRAIN_BATCH``, on ``chip_smoke.py``'s image task, traced
with ``torch.profiler`` (CPU + CUDA activities).

    PYTHONPATH=src python3 benchmarks/profile_train_step.py

Needs a CUDA card (it builds the port's kernels at first use).  Prints one
JSON line: the host time per step (synchronised, without and with the
profiler on), the device time per step summed over the device-side
events, the device idle share of an unprofiled step (1 - device / host),
and the device time by kernel name (top 12), then the card's name and
power limit.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import chip_smoke  # noqa: E402
from repro_torch.configs.imbue_tm import tm_config  # noqa: E402
from repro_torch.core import tm, tm_train  # noqa: E402

STEPS = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train_step: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cfg = tm_config(chip_smoke.MODEL)
    x, y, _, _ = (torch.from_numpy(a).to(device) for a in
                  chip_smoke.image_task(**chip_smoke.IMAGE_TASK))
    b = chip_smoke.TRAIN_BATCH
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
    ta = tm.init_ta_state(gen, cfg, device)
    for i in range(2):                                  # warm-up, builds
        ta = tm_train.train_step_batch(ta, gen, x[i * b:(i + 1) * b],
                                       y[i * b:(i + 1) * b], cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()                            # unprofiled steps
    for i in range(STEPS):
        ta = tm_train.train_step_batch(ta, gen, x[i * b:(i + 1) * b],
                                       y[i * b:(i + 1) * b], cfg)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(STEPS):
            ta = tm_train.train_step_batch(ta, gen, x[i * b:(i + 1) * b],
                                           y[i * b:(i + 1) * b], cfg)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    # Device-side events only (kernels, copies, fills): a CPU op's own
    # device time repeats its kernels'.
    by_name = sorted(((e.key, e.self_device_time_total / 1e3 / STEPS,
                       e.count // STEPS) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in by_name)
    print(json.dumps({
        "step": "tm_train.train_step_batch", "model": chip_smoke.MODEL,
        "B": b, "steps_traced": STEPS,
        "host_ms_per_step": host_ms,
        "host_ms_per_step_profiled": profiled_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": 1.0 - device_ms / host_ms,
        "device_ms_by_kernel": [
            {"name": name[:80], "ms_per_step": ms, "calls_per_step": n}
            for name, ms, n in by_name[:12]]}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
