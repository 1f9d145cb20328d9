"""Hot-swap quickstart on the PyTorch port: retrain a live model and
promote it through a canary, with zero downtime (port of
``examples/swap_quickstart.py``).

  PYTHONPATH=src python examples/torch_swap_quickstart.py
  PYTHONPATH=src python examples/torch_swap_quickstart.py --device cpu

A serving engine is "program once, read forever" until the model
drifts.  This demo stands up a live engine on a weak model, keeps
traffic flowing, then:

1. re-fits incrementally on newly labeled data
   (``repro_torch.train.online.OnlineTrainer``: warm start, a few
   epochs);
2. snapshots the serving pool and arms a canary: one chip programmed
   from the candidate model rides beside the stable pool and serves a
   deterministic fraction of LIVE traffic, shadow-scored against the
   stable pool (``repro_torch.serve.HotSwapper``);
3. promotes when agreement clears the bar: an atomic between-dispatch
   pool install; nothing queued or in flight is dropped, every response
   records which pool version served it.  (Had the canary disagreed,
   ``rollback()`` restores the snapshot bit for bit.)

The data is drawn on a host generator seeded 0; the trainer, the engine
and the candidate pool take seeds 1, 3 and 9 on ``--device``.  For the
checked version with bit-equality assertions, async serving and
rollback, see ``repro_torch.launch.retrain`` (``--smoke``).
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.tm import TMConfig
from repro_torch.core.variations import VariationConfig
from repro_torch.data.tm_datasets import noisy_xor
from repro_torch.serve import (BatcherConfig, EngineConfig, HotSwapper,
                               ServeEngine, SwapConfig)
from repro_torch.train.online import OnlineTrainer, OnlineTrainerConfig

N_TRAIN, N_TEST = 3000, 400
EPOCHS = 20


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = TMConfig(n_classes=2, clauses_per_class=12, n_features=12,
                   n_states=100, threshold=15, specificity=3.9)
    xtr, ytr, xte, yte = (t.numpy() for t in noisy_xor(
        torch.Generator().manual_seed(0), N_TRAIN, N_TEST, device="cpu"))
    xtr, xte = xtr.astype(np.uint8), xte.astype(np.uint8)

    # v1: a deliberately under-trained model (few examples, few epochs).
    trainer = OnlineTrainer(
        cfg, torch.Generator(device=device).manual_seed(1),
        cfg=OnlineTrainerConfig(epochs=EPOCHS, batch_size=500),
        device=device)
    trainer.ingest(xtr[:150], ytr[:150])
    v1 = trainer.refit()
    print(f"trained v{v1.version} on {v1.n_examples} examples "
          f"(train acc {v1.accuracy:.3f}; 40% of labels are flipped, "
          f"so ~0.6 is the ceiling) on {device}")

    # Live engine: 2 chips, D2D variation (per-chip programming draws),
    # deterministic reads.
    engine = ServeEngine.from_ta_state(
        v1.ta_state, cfg, n_replicas=2, seed=3,
        vcfg=VariationConfig(c2c=False, csa_offset=False),
        ecfg=EngineConfig(batcher=BatcherConfig.for_max_batch(32)),
        device=device)

    def serve(n):
        idx = np.random.default_rng(0).integers(0, len(xte), n)
        rids = [engine.submit(xte[i]) for i in idx]
        engine.pump(force=True)
        resps = [engine.take(r) for r in rids]
        acc = float(np.mean([r.pred == yte[i]
                             for r, i in zip(resps, idx)]))
        vers = sorted({r.version for r in resps})
        print(f"  served {n} requests at pool version(s) {vers}, "
              f"accuracy {acc:.3f}")
        return acc

    print(f"live engine up (pool v{engine.version}):")
    serve(200)

    # More labeled data arrives; re-fit warm: seconds, not a redeploy.
    trainer.ingest(xtr, ytr)
    v2 = trainer.refit()
    print(f"retrained -> v{v2.version} on {v2.n_examples} examples "
          f"(train acc {v2.accuracy:.3f})")

    # Canary rollout on LIVE traffic: snapshot, arm, observe, promote.
    with tempfile.TemporaryDirectory(prefix="imbue-swap-") as ckpt:
        swapper = HotSwapper(engine, ckpt,
                             SwapConfig(canary_fraction=0.5,
                                        min_canary_rows=64,
                                        min_agreement=0.5))
        swapper.begin(v2.ta_state, 9)
        print(f"canary armed (candidate pool v{engine.pool.version + 1}):")
        while swapper.decision() == "wait":
            serve(100)
        decision, agreement = swapper.decision(), swapper.agreement()
        print(f"canary verdict after {swapper.rows()} rows: agreement "
              f"{agreement:.3f} -> {decision}")
        if decision == "promote":
            swapper.promote()
        else:
            swapper.rollback()    # restores the snapshot bit for bit
    print(f"serving pool is now v{engine.version}:")
    acc = serve(200)
    print("swap audit trail:", engine.metrics.swap_events)
    return {"decision": decision, "version": engine.version,
            "accuracy": acc, "swaps": list(engine.metrics.swap_events),
            "agreement": agreement, "versions": (v1, v2),
            "data": (xtr, ytr, xte, yte)}


if __name__ == "__main__":
    main()
