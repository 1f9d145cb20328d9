"""Live retraining + hot-swap CLI: the retrain loop end to end (port of
``repro.launch.retrain``).

Stands up a live KWS-6 serving engine, streams traffic at it, then —
WITHOUT stopping it — re-fits the model on freshly ingested labeled
windows (``train/online.py``), canaries the candidate pool on a slice of
the live traffic, and promotes or rolls back (``serve/swap.py``).  Every
served request records the pool version; the report shows the traffic
split across versions, the canary agreement, and the swap audit trail.

The frames are drawn on the host from a ``torch.Generator`` seeded 0, so
a run sees the same windows on either device; the trainer takes seed 2,
the live engine seed 7, cycle ``c``'s candidate pool seed 11 + c and the
smoke's rollback candidate seed 99.  Training and serving run on
``--device`` (the CUDA card by default).

  PYTHONPATH=src python -m repro_torch.launch.retrain
  PYTHONPATH=src python -m repro_torch.launch.retrain --refits 3 --json
  PYTHONPATH=src python -m repro_torch.launch.retrain --smoke \\
      --smoke-out smoke-retrain.json

``--smoke`` is the gate: a tiny model, one full
retrain -> canary -> promote cycle on a LIVE engine (traffic before,
during and after the swap; nothing dropped), then two hard assertions:

* post-swap predictions are bit-identical to a FRESH engine built from
  the same TA state and seed (D2D-only noise: per-chip programming draws
  differ, reads are deterministic);
* rollback restores the pre-swap pool bit for bit from its
  digest-verified snapshot.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.booleanize import StreamingBooleanizer, fit_quantile
from repro_torch.core.tm import TMConfig
from repro_torch.core.variations import VariationConfig
from repro_torch.data.tm_datasets import kws6_windows, synthetic_kws6
from repro_torch.launch import hostdev
from repro_torch.serve import (AsyncServeEngine, BatcherConfig, EngineConfig,
                               HotSwapper, ServeEngine, SwapConfig)
from repro_torch.train.online import OnlineTrainer, OnlineTrainerConfig

SWAP_SEED = 11          # cycle c's candidate pool programs from 11 + c
ROLLBACK_SEED = 99      # the smoke's rolled-back candidate


def _pump_traffic(engine, xs, rng, n):
    """Submit ``n`` random rows, pumping as they queue; returns the
    drained responses for just these rows."""
    idx = rng.integers(0, xs.shape[0], size=n)
    rids = []
    for i in idx:
        rids.append(engine.submit(xs[i]))
        engine.pump()
    engine.drain()
    return [engine.take(r) for r in rids]


def main(argv=None):
    """The CLI; with ``--host-devices N``, on N spawned host ranks (the
    exit code then)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    code = hostdev.run_main(main, argv)
    if code is not None:
        return code
    with hostdev.launched_group():
        return _retrain(argv)


def _retrain(argv):
    print = hostdev.rank0_print
    ap = argparse.ArgumentParser()
    ap.add_argument("--mels", type=int, default=12)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--hop", type=int, default=4)
    ap.add_argument("--clauses", type=int, default=10,
                    help="clauses per keyword class")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=3,
                    help="epochs per incremental refit")
    ap.add_argument("--refits", type=int, default=1,
                    help="retrain -> canary -> settle cycles to run")
    ap.add_argument("--requests", type=int, default=192,
                    help="serving requests per traffic phase")
    ap.add_argument("--canary-fraction", type=float, default=0.25)
    ap.add_argument("--min-agreement", type=float, default=0.8)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="pool snapshot directory (rollback points); "
                         "default: a fresh temp dir")
    ap.add_argument("--async-serve", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device for training and serving (default: "
                         "the CUDA card; 'cpu' runs the plain versions)")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="run on N spawned host ranks (one gloo group), "
                         "each the whole program on the same seeds")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke: tiny model, one live "
                         "retrain -> canary -> promote cycle + rollback, "
                         "bit-equality asserted")
    ap.add_argument("--smoke-out", default=None,
                    help="write the smoke/serve report JSON here")
    args = ap.parse_args(argv)
    if args.smoke:
        # Tiny-but-real: 8 warm epochs; the smoke gates the MECHANICS
        # (canary flow, promote path, bit-equality) with an agreement bar
        # well above the ~1/6 chance floor, not a model-quality bar.
        # Seeds are fixed, so the run is deterministic.
        args.replicas, args.epochs = 2, 8
        args.requests = min(args.requests, 96)
        args.refits = 1
        args.min_agreement = 0.3
    device = resolve_device(args.device)

    ckpt_dir = (args.checkpoint_dir
                or hostdev.shared_tempdir(prefix="imbue-swap-"))

    # ------------------------------------------------ data + first model
    n_feat = args.window * args.mels * args.bits
    cfg = TMConfig(n_classes=6, clauses_per_class=args.clauses,
                   n_features=n_feat, n_states=100, threshold=15,
                   specificity=5.0)
    n_utt = 40 if args.smoke else 120
    xtr, ytr = synthetic_kws6(torch.Generator().manual_seed(0),
                              n_utterances=n_utt, n_frames=32,
                              n_mels=args.mels, device="cpu")
    xtr, ytr = xtr.numpy(), ytr.numpy()
    booleanizer = fit_quantile(xtr.reshape(-1, args.mels), bits=args.bits,
                               device=device)
    windower = StreamingBooleanizer(booleanizer, args.window, args.hop)
    rtr, wytr = kws6_windows(xtr, ytr, windower)
    rtr_np = np.asarray(rtr, np.uint8)
    wytr = np.asarray(wytr)

    trainer = OnlineTrainer(
        cfg, torch.Generator(device=device).manual_seed(2),
        cfg=OnlineTrainerConfig(epochs=args.epochs), device=device)
    half = len(rtr_np) // 2
    trainer.ingest(rtr_np[:half], wytr[:half])
    tv = trainer.refit()
    print(f"[retrain] v{tv.version}: fit on {tv.n_examples} windows, "
          f"train acc {tv.accuracy:.3f} ({n_feat} Boolean features, "
          f"{device})")

    # ------------------------------------------------------- live engine
    # D2D-only noise: per-chip programming draws differ (the pool is a
    # real replica pool), reads are deterministic: the configuration the
    # bit-equality assertions need.
    vcfg = VariationConfig(c2c=False, csa_offset=False)
    ecfg = EngineConfig(batcher=BatcherConfig.for_max_batch(32))
    cls = AsyncServeEngine if args.async_serve else ServeEngine
    engine = cls.from_ta_state(tv.ta_state, cfg, n_replicas=args.replicas,
                               seed=7, vcfg=vcfg, ecfg=ecfg, device=device)
    print(f"[retrain] live engine up: pool version {engine.version}, "
          f"{args.replicas} replicas, backend {engine.backend.name}, "
          f"snapshots -> {ckpt_dir}")

    rng = np.random.default_rng(0)
    swapper = HotSwapper(engine, ckpt_dir,
                         SwapConfig(canary_fraction=args.canary_fraction,
                                    min_canary_rows=32,
                                    min_agreement=args.min_agreement))
    report = {"cycles": [], "smoke": bool(args.smoke)}

    pre = _pump_traffic(engine, rtr_np, rng, args.requests)
    print(f"[retrain] pre-swap traffic: {len(pre)} requests at "
          f"v{engine.version}")

    for cycle in range(args.refits):
        # Incremental data arrives; re-fit warm from the last state.
        trainer.ingest(rtr_np[half:], wytr[half:])
        tv = trainer.refit()
        cand_v = swapper.begin(tv.ta_state, SWAP_SEED + cycle)
        print(f"[retrain] cycle {cycle}: trained v{tv.version} "
              f"(acc {tv.accuracy:.3f}), canary armed as pool "
              f"v{cand_v} at {args.canary_fraction:.0%} traffic")
        # Canary phase: live traffic keeps flowing, a deterministic
        # fraction served by the candidate chip + shadow-scored.
        while swapper.decision() == "wait":
            _pump_traffic(engine, rtr_np, rng, 32)
        decision = swapper.decision()
        agreement = swapper.agreement()
        canary_rows = swapper.rows()
        print(f"[retrain] canary: {canary_rows} rows, agreement "
              f"{agreement:.3f} -> {decision}")
        if decision == "promote":
            swapper.promote()
        else:
            swapper.rollback()
        report["cycles"].append({
            "trained_version": tv.version, "candidate_pool_version": cand_v,
            "train_accuracy": tv.accuracy, "canary_rows": canary_rows,
            "agreement": agreement, "decision": decision,
            "pool_version_after": engine.version})
        post = _pump_traffic(engine, rtr_np, rng, args.requests)
        print(f"[retrain] post-settle traffic: {len(post)} requests at "
              f"v{engine.version}")

    # ------------------------------------------------- smoke assertions
    if args.smoke:
        # 1. Post-swap predictions == a FRESH engine programmed from the
        #    same TA state + seed (promote must have happened: the canary
        #    compares the model against itself retrained on the same
        #    distribution, so agreement is high).
        assert report["cycles"][-1]["decision"] == "promote", \
            f"smoke expected a promote, got {report['cycles'][-1]}"
        fresh = ServeEngine.from_ta_state(
            tv.ta_state, cfg, n_replicas=args.replicas,
            seed=SWAP_SEED + args.refits - 1, vcfg=vcfg, ecfg=ecfg,
            device=device)
        probe = rtr_np[:64]
        engine.submit_many(list(probe))
        live = [r.pred for r in engine.drain()[-len(probe):]]
        fresh.submit_many(list(probe))
        ref = [r.pred for r in fresh.drain()]
        assert live == ref, \
            "post-swap predictions differ from a fresh engine built " \
            "from the same TA state and seed"
        print(f"[retrain] SMOKE OK: post-swap preds bit-equal fresh "
              f"engine over {len(probe)} probes")
        # 2. Rollback restores the (now-serving) pool bit for bit.
        stack_before = engine.pool.r_stack.cpu().clone()
        v_before = engine.version
        swapper.begin(trainer.refit().ta_state, ROLLBACK_SEED)
        _pump_traffic(engine, rtr_np, rng, 48)
        swapper.rollback()
        assert engine.version == v_before
        assert torch.equal(engine.pool.r_stack.cpu(), stack_before), \
            "rollback did not restore the pool bit for bit"
        print("[retrain] SMOKE OK: rollback restored pool "
              f"v{v_before} bit for bit from its snapshot")
        report["smoke_ok"] = True

    summary = engine.summary()
    report["summary"] = {k: summary[k] for k in
                         ("requests", "batches", "pool_version",
                          "requests_by_version", "swaps", "canary",
                          "expired", "rejected", "backend",
                          "fallback_dispatches")
                         if k in summary}
    if args.smoke_out:
        with open(args.smoke_out, "w") as f:
            json.dump(report, f, indent=2, default=str)
        print(f"[retrain] report -> {args.smoke_out}")
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(f"[retrain] served {summary['requests']} requests total; "
              f"by version {summary.get('requests_by_version')}; "
              f"swap audit {summary.get('swaps')}")
    return report


if __name__ == "__main__":
    main()
