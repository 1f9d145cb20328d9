"""Chaos-engineering CLI: the self-healing loop end to end (port of
``repro.launch.chaos``).

Stands up a live R-replica ensemble engine with health probing enabled,
streams traffic at it, then — WITHOUT stopping it — injects stuck-at /
retention faults into one replica, lets the probe detect and quarantine
the chip, keeps serving from the healthy majority, repairs it through
``RepairPolicy`` (re-program + re-probe + readmit), and verifies that no
request was dropped, rejected, expired, or served by a quarantined chip
at any point.

The training-free model (about 10 % includes, the density of the paper's
trained Table IV models) is drawn on a host ``torch.Generator`` seeded 5
and the requests on one seeded 1; the engine programs from seed 7 and
round ``r``'s injury takes the ``r``-th generator split off one seeded
99.  Everything runs on ``--device`` (the CUDA card by default).

  PYTHONPATH=src python -m repro_torch.launch.chaos
  PYTHONPATH=src python -m repro_torch.launch.chaos --rounds 3 --json
  PYTHONPATH=src python -m repro_torch.launch.chaos --smoke \\
      --smoke-out smoke-chaos.json

``--smoke`` is the gate: a tiny model, one full
injure -> detect -> quarantine -> degrade -> repair -> readmit cycle on a
LIVE engine, with hard assertions:

* the probe flags EXACTLY the injured replica (healthy chips stay at the
  readmit bar; D2D-only reads are deterministic);
* every prediction served while degraded equals the digital oracle's
  (healthy-majority voting);
* repair readmits the chip and post-repair health returns past the
  readmit bar;
* zero requests dropped / expired / rejected across the whole cycle, and
  the pool version never moved (hardware was hurt, the model wasn't).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import tm
from repro_torch.core.tm import TMConfig
from repro_torch.core.variations import (FaultConfig, VariationConfig,
                                         split_generator)
from repro_torch.launch import hostdev
from repro_torch.serve import (AsyncServeEngine, BatcherConfig, EngineConfig,
                               HealthConfig, RepairConfig, RepairPolicy,
                               ServeEngine)


def _serve(engine, xs, rng, n, rids_out):
    """Submit ``n`` random rows (tracking rids), pumping as they queue;
    returns (row_indices, responses)."""
    idx = rng.integers(0, xs.shape[0], size=n)
    rids = []
    for i in idx:
        rids.append(engine.submit(xs[i]))
        engine.pump()
    engine.drain()
    rids_out.extend(rids)
    return idx, [engine.take(r) for r in rids]


def sparse_ta(cfg, generator: torch.Generator) -> torch.Tensor:
    """A training-free TA state with ~10 % includes (the density of the
    paper's trained Table IV models), drawn from ``generator``."""
    inc = torch.rand((cfg.n_clauses, cfg.n_literals),
                     generator=generator) < 0.1
    return torch.where(inc, cfg.n_states + 1, cfg.n_states).to(
        cfg.state_dtype)


def main(argv=None):
    """The CLI; with ``--host-devices N``, on N spawned host ranks (the
    exit code then)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    code = hostdev.run_main(main, argv)
    if code is not None:
        return code
    with hostdev.launched_group():
        return _chaos(argv)


def _chaos(argv):
    print = hostdev.rank0_print
    ap = argparse.ArgumentParser()
    ap.add_argument("--classes", type=int, default=6)
    ap.add_argument("--clauses", type=int, default=10,
                    help="clauses per class")
    ap.add_argument("--features", type=int, default=64)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--requests", type=int, default=96,
                    help="serving requests per traffic phase")
    ap.add_argument("--rounds", type=int, default=1,
                    help="injure/heal cycles to run")
    ap.add_argument("--stuck-lrs", type=float, default=0.15)
    ap.add_argument("--stuck-hrs", type=float, default=0.15)
    ap.add_argument("--drift-rate", type=float, default=0.0)
    ap.add_argument("--read-age", type=float, default=0.0)
    ap.add_argument("--probes", type=int, default=64,
                    help="committed probe rows per health round")
    ap.add_argument("--async-serve", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions)")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="run on N spawned host ranks (one gloo group), "
                         "each the whole program on the same seeds")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke: tiny model, one full injure -> "
                         "quarantine -> repair -> readmit cycle, "
                         "oracle-equality and zero-drop asserted")
    ap.add_argument("--smoke-out", default=None,
                    help="write the chaos report JSON here")
    args = ap.parse_args(argv)
    if args.smoke:
        args.classes, args.clauses, args.features = 4, 8, 32
        args.replicas, args.rounds = 4, 1
        args.requests = min(args.requests, 64)
    device = resolve_device(args.device)

    # Training-free sparse model (the chaos loop gates serving
    # robustness, not model quality).
    cfg = TMConfig(n_classes=args.classes, clauses_per_class=args.clauses,
                   n_features=args.features, n_states=100)
    ta = sparse_ta(cfg, torch.Generator().manual_seed(5)).to(device)
    xs = (torch.rand((256, cfg.n_features),
                     generator=torch.Generator().manual_seed(1)) < 0.4
          ).numpy().astype(np.uint8)
    oracle = tm.predict(ta, torch.from_numpy(xs).to(device),
                        cfg).cpu().numpy()

    # D2D-only noise: per-chip programming draws differ (real replica
    # diversity), reads are deterministic, so healthy chips probe at the
    # readmit bar and served bits are assertable against the oracle.
    vcfg = VariationConfig(c2c=False, csa_offset=False)
    fcfg = FaultConfig(stuck_lrs_rate=args.stuck_lrs,
                       stuck_hrs_rate=args.stuck_hrs,
                       drift_rate=args.drift_rate, read_age=args.read_age)
    ecfg = EngineConfig(routing="ensemble",
                        batcher=BatcherConfig.for_max_batch(32),
                        health=HealthConfig(n_probes=args.probes, seed=5))
    cls = AsyncServeEngine if args.async_serve else ServeEngine
    engine = cls.from_ta_state(ta, cfg, n_replicas=args.replicas, seed=7,
                               vcfg=vcfg, ecfg=ecfg, device=device)
    policy = RepairPolicy(engine, RepairConfig())
    rng = np.random.default_rng(0)
    print(f"[chaos] live engine up on {device}: {args.replicas} replicas, "
          f"backend {engine.backend.name}, {args.probes} committed probes, "
          f"injury {fcfg}")

    h0 = engine.probe()
    print(f"[chaos] baseline health: {h0}")
    report = {"smoke": bool(args.smoke), "baseline_health": h0,
              "rounds": []}
    all_rids, mismatches = [], 0

    def traffic(phase, n):
        nonlocal mismatches
        idx, resp = _serve(engine, xs, rng, n, all_rids)
        bad = int((np.array([r.pred for r in resp]) != oracle[idx]).sum())
        mismatches += bad
        print(f"[chaos]   {phase}: {len(resp)} requests served, "
              f"{bad} oracle mismatches")
        return bad

    inj_gens = split_generator(
        torch.Generator(device=device).manual_seed(99), args.rounds)
    for rnd in range(args.rounds):
        victim = rnd % args.replicas
        rrec = {"victim": victim}
        traffic("pre-injury", args.requests)
        engine.inject_faults(inj_gens[rnd], fcfg, replicas=[victim])
        h = engine.probe()
        rrec["injured_health"] = h
        rrec["quarantined"] = list(engine.quarantined)
        print(f"[chaos] round {rnd}: injured replica {victim}, health "
              f"{h}, quarantined {engine.quarantined}")
        traffic("degraded", args.requests)
        tick = policy.check()
        rrec["repairs"] = tick["repairs"]
        rrec["post_repair_health"] = tick["health"]
        print(f"[chaos]   repair: {tick['repairs']} -> health "
              f"{engine.probe()}")
        traffic("post-repair", args.requests)
        report["rounds"].append(rrec)

    summary = engine.summary()
    report["served"] = len(all_rids)
    report["oracle_mismatches"] = mismatches
    report["expired"] = summary["expired"]
    report["rejected"] = summary["rejected"]
    report["quarantine_events"] = summary.get("quarantine_events", [])
    report["fault_injections"] = summary.get("fault_injections", [])
    report["pool_version"] = summary.get("pool_version", engine.version)

    if args.smoke:
        rrec = report["rounds"][0]
        victim = rrec["victim"]
        hq = rrec["injured_health"]
        thr = ecfg.health.quarantine_threshold
        assert hq[victim] < thr, \
            f"probe missed the injury: replica {victim} health " \
            f"{hq[victim]} >= {thr}"
        # Healthy chips sit at/above the readmit ceiling (a single
        # marginal D2D draw may cost the odd probe row; the hysteresis
        # band absorbs it), the victim far below the quarantine floor.
        ceil = ecfg.health.readmit_threshold
        healthy = [i for i in range(args.replicas) if i != victim]
        assert all(hq[i] >= ceil for i in healthy), \
            f"probe flagged a healthy chip: {hq}"
        assert rrec["quarantined"] == [victim], \
            f"quarantine set {rrec['quarantined']} != [{victim}]"
        print(f"[chaos] SMOKE OK: probe flagged exactly replica "
              f"{victim} ({hq[victim]:.3f} vs healthy "
              f"{min(hq[i] for i in healthy):.3f}+)")
        rep = rrec["repairs"][victim]
        assert rep["readmitted"] and not engine.quarantined, \
            f"repair failed to readmit: {rep}"
        assert all(h >= ceil for h in engine.probe().values()), \
            "post-repair health did not recover past the readmit bar"
        print(f"[chaos] SMOKE OK: repaired + readmitted in "
              f"{rep['attempts']} attempt(s)")
        assert mismatches == 0, \
            f"{mismatches} predictions diverged from the digital oracle"
        assert summary["expired"] == 0 and summary["rejected"] == 0, \
            "requests were expired/rejected during the chaos cycle"
        assert report["served"] == 3 * args.requests * args.rounds
        assert engine.version == 0, \
            "injure/repair must not bump the model version"
        # Nominal injection is the identity: the bit-exactness guard.
        assert engine.pool.inject_faults(
            torch.Generator(device=device).manual_seed(0),
            FaultConfig()) is engine.pool
        print(f"[chaos] SMOKE OK: {report['served']} requests, 0 oracle "
              "mismatches, 0 expired, 0 rejected, version unmoved")
        report["smoke_ok"] = True

    if args.smoke_out:
        with open(args.smoke_out, "w") as f:
            json.dump(report, f, indent=2, default=str)
        print(f"[chaos] report -> {args.smoke_out}")
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(f"[chaos] served {report['served']} requests; "
              f"{mismatches} oracle mismatches; quarantine audit "
              f"{report['quarantine_events']}")
    return report


if __name__ == "__main__":
    main()
