"""Kernel micro-benchmarks, the H100 roofline of the fused inference
kernels, and the measured per-backend autotuning sweep of the PyTorch
port (port of ``benchmarks/kernel_bench.py``).

As a CLI it drives ``repro_torch.kernels.autotune`` on one CUDA card: for
every fused backend it measures each kernel's tile overrides (and
``"auto"``, the kernel's own geometry) and the bucket ladder, at the
reference's two shapes and at the full widths the port serves (each from
``chip_smoke.py``'s constants):

  imbue-tm-mnist   10 x 200 clauses, L = 1568          c2048-l2048
  KWS-6            chip_smoke.KWS_TASK, 6 x 300, L = 768   c2048-l1024
  anomaly          chip_smoke.ANOMALY_TASK, 2 x 300, L = 512   c1024-l512
  coalesced        chip_smoke.COALESCED, 1000 in all, L = 1568  c1024-l2048
  stream coalesced chip_smoke.STREAM_COALESCED, 900, L = 768   c1024-l1024

(the last two on the coalesced backends only), merges the entries into
the committed table (``src/repro_torch/kernels/tuning_table.json``, or
``--out``) and prints the whole table on one line, which
``ServeEngine`` and ``BatcherConfig.for_max_batch`` consume through the
registry on the same card.  It also reports a before/after pair per shape
bucket: the packed backend's best tile latency and resident bytes a
dispatch next to the plane-packed backend's (to stdout, or as JSON to
``--pair-out``), and the H100 roofline of the two main-path kernels.

  PYTHONPATH=src python -m benchmarks.kernel_bench_torch          # full
  PYTHONPATH=src python -m benchmarks.kernel_bench_torch --smoke  # tiny
      # sweep at the reference shape, nothing written
  PYTHONPATH=src python -m benchmarks.kernel_bench_torch --smoke \\
      --device cpu      # the same over the plain versions, on the host
  PYTHONPATH=src python -m benchmarks.kernel_bench_torch \\
      --out second.json --compare src/repro_torch/kernels/tuning_table.json
      # a second sweep beside the committed one: how many picks differ

The sweep runs on the card unless ``--device cpu`` is given; a host run
times the plain versions with the host clock and never writes the table.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))               # chip_smoke's constants

import chip_smoke  # noqa: E402
from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.configs.imbue_tm import tm_config  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.roofline import analysis as roofline  # noqa: E402

# Published H100 SXM figures at the 700 W limit (NVIDIA's data sheet and
# the CUDA C++ guide's throughput table), as chip_smoke.py and PERF.md use
# them: HBM bytes/s and fp32 FLOP/s outside the tensor cores from the
# port's roofline module; 32-bit logic (LOP3) per clock per SM, SMs and
# the boost clock.
HBM_BYTES_PER_S = roofline.HBM_BW
FP32_FLOP_PER_S = roofline.FP32_FLOPS
LOP3_PER_S = chip_smoke.LOP3_PER_CLOCK_PER_SM * 132 * 1.98e9


def full_widths():
    """The full widths the port serves, as autotune shapes, each built
    from ``chip_smoke.py``'s constants: ``[(label, shape), ...]``."""
    mnist = tm_config(chip_smoke.MODEL)
    out = [("imbue-tm-mnist", {"n_classes": mnist.n_classes,
                               "clauses_per_class": mnist.clauses_per_class,
                               "n_features": mnist.n_features})]
    for label, task in (("kws6", chip_smoke.KWS_TASK),
                        ("anomaly", chip_smoke.ANOMALY_TASK)):
        f = chip_smoke.stream_fields(task)
        out.append((label, {k: f[k] for k in ("n_classes",
                                              "clauses_per_class",
                                              "n_features")}))
    for label, pool in (("coalesced", chip_smoke.COALESCED),
                        ("stream-coalesced", chip_smoke.STREAM_COALESCED)):
        out.append((label, {k: pool[k] for k in ("n_classes", "n_clauses",
                                                 "n_features")}))
    return out


def kernel_roofline(b: int, c: int, l: int, *, m: int = 10, r: int = 1,
                    analog: bool = False, dev: bool = False) -> dict:
    """The least time the H100 could take for one main-path inference
    kernel's work at ``B = b``, ``C = c``, ``L = l`` and ``M = m``: bytes
    (each input read once, the output written once) over the HBM rate
    against operations over their type's rate.

    * analog (``imbue_infer_planes``, R = ``r``): 4 fp32 operations a
      (replica, row, clause, cell) at 67 TFLOP/s; literal and index words,
      the deviation plane when ``dev``, the polarity matrix, the sums;
    * TM (``tm_infer_planes``): one LOP3 a (row, clause, word) plus the
      combine's 2 x B x C x M at 67 T/s; literal and include words, the
      combine matrix, the sums."""
    lw = math.ceil(l / 32)
    nbytes = 4 * (b * lw + c * lw + c * m + r * b * m)
    if analog:
        if dev:
            nbytes += 4 * r * c * l
        t_ops = 4.0 * r * b * c * l / FP32_FLOP_PER_S
        ops = 4.0 * r * b * c * l
    else:
        t_ops = b * c * lw / LOP3_PER_S + 2.0 * b * c * m / FP32_FLOP_PER_S
        ops = b * c * lw + 2.0 * b * c * m
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bytes": nbytes, "operations": ops, "t_bytes_s": t_bytes,
            "t_operations_s": t_ops, "bound_s": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "intensity": ops / nbytes}


def ref_operands(name, state, lits):
    """The ``kernels/ref.py`` oracle for ``name``'s backend call on
    ``(state, lits)``, as a closure over its float operands: complemented
    literals, or drive voltages and the (nominal, C2C-free) conductance
    and leak planes of the stack's first chip, with the state's own
    polarity or combine matrix."""
    from repro_torch.core import imbue
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bitpack import unpack_bits
    c, l = state.include.shape
    bits = unpack_bits(lits, l) if lits.dtype == torch.int32 else lits
    bits = bits.to(torch.float32)
    if name.startswith("analog"):
        icfg = state.icfg
        g_on, i_leak = imbue.conductances(state.r_stack[0], state.include,
                                          icfg)
        pol = ops.polarity_matrix(state.tm_cfg, state.include,
                                  device=state.include.device)
        v_drive = (1.0 - bits) * icfg.v_read
        return lambda: ref.imbue_infer_ref(                 # noqa: E731
            v_drive, bits, g_on, i_leak, pol, icfg.width, icfg.r_divider,
            icfg.reference_voltage())
    include = state.include.to(torch.float32)
    lit0 = 1.0 - bits
    return lambda: ref.tm_infer_ref(lit0, include,        # noqa: E731
                                    state.combine)


def bench(reps: int = 25, device=None):
    """The two main-path kernels through their ops wrappers at
    imbue-tm-mnist (nominal plane-packed analog, R = 1; the coalesced
    pool at ``chip_smoke.COALESCED``), B = 128, each beside its H100
    roofline and the ``kernels/ref.py`` oracle of the same function on
    the same operands (``ref_us``; ``ref_equal``: the oracle's sums equal
    the kernel's).  Times are device time on a card (CUDA events, median)
    and the host clock on the host, named so."""
    from repro_torch import api
    device = resolve_device(device)
    on_card = device.type == "cuda"
    rows = []
    for name, shape in (("analog-cuda-packed2", full_widths()[0][1]),
                        ("coalesced-cuda-packed2", full_widths()[3][1])):
        backend = api.get_backend(name)
        state, lits = autotune._reference_state(backend, shape, device, 128)
        fns = {"kernel": lambda: backend.fn(state, lits, None),
               "ref": ref_operands(name, state, lits)}
        us = (autotune._device_times_us(fns, reps) if on_card
              else autotune._host_times_us(fns, reps, sync=False))
        got = fns["kernel"]()
        got = got[0] if got.ndim == 3 else got
        c, l = state.include.shape
        m = shape["n_classes"]
        roof = kernel_roofline(128, c, l, m=m, analog=name.startswith(
            "analog"))
        unit = "device_us" if on_card else "host_us"
        rows.append({"backend": name, "kernel": autotune.KERNEL_OF[name],
                     "B": 128, "C": int(c), "L": int(l),
                     unit: us["kernel"], "ref_" + unit: us["ref"],
                     "ref_equal": bool(torch.equal(
                         got.to(torch.float32), fns["ref"]())),
                     "bound_us": roof["bound_s"] * 1e6,
                     "bound_by": roof["bound_by"]})
    return rows


# Plane-packed "after" backends beside their packed "before" ones.
PLANE_PAIRS = (("analog-cuda-packed", "analog-cuda-packed2"),
               ("coalesced-cuda-packed", "coalesced-cuda-packed2"))


def resident_bytes(backend_name: str, shape: dict) -> int:
    """Resident-model operand bytes ONE dispatch of the port's kernel
    reads at ``shape`` (nominal programming: no deviation plane).

    The dense analog kernels read two float32 planes (conductance and
    leak); the plane-packed analog kernel reads the int32 index bitplane.
    The coalesced and digital kernels read the packed include words, or
    one byte a cell (``tm_infer``).  The reference counts 4 bytes a cell
    for the unpacked include plane (its TPU layout); the port's kernels
    read bytes."""
    c = (shape["n_clauses"] if "n_clauses" in shape
         else shape["n_classes"] * shape["clauses_per_class"])
    l = 2 * shape["n_features"]
    lw = math.ceil(l / 32)
    if backend_name.startswith(("coalesced", "digital")):
        return 4 * c * lw if "packed" in backend_name else c * l
    if backend_name.endswith("packed2"):
        return 4 * c * lw
    return 2 * 4 * c * l


def dispatch_us(entry) -> float:
    """An entry's time of one call at its committed tiles: the tile
    sweep's device time summed over the served states, or on the host
    (no tile sweep) the largest bucket's wall time summed likewise."""
    lat = entry["tile_latency_us"]
    if lat:
        return lat[autotune.tile_key(entry["tiles"])]
    return entry["bucket_latency_us"][str(max(map(int, entry[
        "bucket_latency_us"])))]


def compare_tables(new, old):
    """``(cells, tiles differing, ladders differing)`` of the cells in
    both nested tables: how far two sweeps' picks agree."""
    new, old = autotune.normalize_table(new), autotune.normalize_table(old)
    cells = [(n, k) for n in new for k in new[n] if k in old.get(n, {})]
    tiles = sum(new[n][k]["tiles"] != old[n][k]["tiles"] for n, k in cells)
    ladders = sum(new[n][k]["bucket_sizes"] != old[n][k]["bucket_sizes"]
                  for n, k in cells)
    return len(cells), tiles, ladders


def plane_pair_report(entries):
    """Before/after rows per (pair, shape bucket) out of the sweep: the
    time of one call at the committed tiles (:func:`dispatch_us`) and the
    resident bytes a dispatch."""
    rows = []
    for before, after in PLANE_PAIRS:
        common = sorted(set(entries.get(before, {}))
                        & set(entries.get(after, {})))
        for skey in common:
            eb, ea = entries[before][skey], entries[after][skey]
            lat_b, lat_a = dispatch_us(eb), dispatch_us(ea)
            rb = resident_bytes(before, eb["shape"])
            ra = resident_bytes(after, ea["shape"])
            rows.append({
                "before": before, "after": after, "shape_bucket": skey,
                "latency_us_before": lat_b, "latency_us_after": lat_a,
                "latency_ratio": lat_a / lat_b if lat_b else None,
                "resident_bytes_before": rb, "resident_bytes_after": ra,
                "resident_bytes_ratio": ra / rb if rb else None,
            })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sweep at the reference shape, no table write")
    ap.add_argument("--reps", type=int, default=30,
                    help="bucket-sweep reps (min of reps); the tile sweep "
                         "takes at least autotune.TILE_REPS_MIN")
    ap.add_argument("--out", default=autotune.DEFAULT_TABLE_PATH,
                    help="tuning-table JSON path the full sweep merges into")
    ap.add_argument("--pair-out", default=None,
                    help="write the plane-pair report here as JSON (else "
                         "it is printed)")
    ap.add_argument("--require-backend", action="append", default=[],
                    metavar="NAME",
                    help="fail unless this backend was tuned; repeatable")
    ap.add_argument("--compare", default=None, metavar="TABLE",
                    help="count the cells whose tiles or ladder differ "
                         "from this tuning-table JSON (another sweep's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "times the plain versions and writes no table)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"

    mode = "smoke" if args.smoke else "full"
    where = (f"{torch.cuda.get_device_name(device)} "
             f"({autotune.power_limit_w(device)} W limit)"
             if on_card else "the host (plain versions)")
    print(f"[kernel_bench_torch] measured autotune sweep ({mode}) on "
          f"{where}", flush=True)
    shapes = None
    if not args.smoke:
        shapes = [autotune.REF_SHAPE, autotune.KWS_SHAPE,
                  *(shape for _, shape in full_widths())]
    entries = autotune.autotune(smoke=args.smoke, reps=args.reps,
                                shapes=shapes, register=False,
                                device=device)
    flat = [(name, skey, e) for name, shapes_ in sorted(entries.items())
            for skey, e in sorted(shapes_.items())]
    for name, skey, e in flat:
        # Per served state: the committed tiles' and the fastest
        # candidate's device time over "auto"'s.
        states = "; ".join(
            f"{label} auto {lat[autotune.AUTO]:.3f} us, committed "
            f"{lat[autotune.tile_key(e['tiles'])] / lat[autotune.AUTO]:.3f}"
            f"x, fastest {min(lat, key=lat.get)} "
            f"{min(lat.values()) / lat[autotune.AUTO]:.3f}x"
            for label, lat in e["tile_latency_by_state"].items())
        print(f"[kernel_bench_torch]   {name} @ {skey}: tiles="
              f"{e['tiles'] or 'auto'} buckets={e['bucket_sizes']} "
              f"({states or 'no tile sweep on the host'})", flush=True)
    missing = sorted(set(args.require_backend) - set(entries))
    if missing:
        print(f"[kernel_bench_torch] FAIL: required backend(s) not tuned: "
              f"{missing} (tuned: {sorted(entries)})")
        raise SystemExit(1)

    pairs = plane_pair_report(entries)
    if args.pair_out:
        with open(args.pair_out, "w") as f:
            json.dump({"device": where, "plane_pairs": pairs}, f, indent=2)
        print(f"[kernel_bench_torch] wrote {args.pair_out}")
    else:
        for p in pairs:
            print(f"[kernel_bench_torch]   {p['before']} -> {p['after']} "
                  f"@ {p['shape_bucket']}: {p['latency_us_before']:.3f} -> "
                  f"{p['latency_us_after']:.3f} us "
                  f"({p['latency_ratio']:.2f}x), resident "
                  f"{p['resident_bytes_before']} -> "
                  f"{p['resident_bytes_after']} B/dispatch "
                  f"({p['resident_bytes_ratio']:.4f}x)")
    for row in bench(device=device):
        print(f"[kernel_bench_torch]   {json.dumps(row)}")

    ok = all("tiles" in e and e["bucket_sizes"] and (
        autotune.AUTO in e["tile_latency_us"] or not on_card)
        for _, _, e in flat)
    if not ok:
        print("[kernel_bench_torch] FAIL: an entry without tiles, the "
              "auto candidate or a ladder")
        raise SystemExit(1)
    if args.compare:
        cells, tiles, ladders = compare_tables(
            entries, autotune.load_table(args.compare))
        print(f"[kernel_bench_torch] against {args.compare}: {tiles} of "
              f"{cells} cells pick other tiles, {ladders} another ladder")
    if args.smoke or not on_card:
        print(f"[kernel_bench_torch] {mode.upper()} PASS: {len(flat)} "
              "(backend, shape) cells tuned (nothing written)")
        return entries
    path = autotune.save_table(entries, args.out)
    print(f"[kernel_bench_torch] wrote {path} ({len(flat)} cells)")
    print(json.dumps({"tuning_table": autotune.load_table(path)},
                     sort_keys=True), flush=True)
    return entries


if __name__ == "__main__":
    main()
