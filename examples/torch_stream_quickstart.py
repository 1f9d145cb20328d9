"""Streaming keyword-spotting quickstart on the PyTorch port: KWS-6 over
the serving engine (port of ``examples/stream_quickstart.py``).

Train a tiny TM on synthetic KWS-6 spectral windows, program a pool of
simulated crossbar chips, then run two concurrent keyword sessions
against ONE shared engine: frames arrive a hop at a time, every
completed window is one batched analog read, and each session smooths
its per-window prediction with a majority vote — the paper's always-on
audio deployment ("program once, read forever").

The frames are drawn on host generators (training seed 0, the two
speakers 103 and 106); the TA init, the training and the engine take
seeds 1, 2 and 3 on ``--device``.

  PYTHONPATH=src python examples/torch_stream_quickstart.py
  PYTHONPATH=src python examples/torch_stream_quickstart.py --device cpu

For the full flag surface (async serving, window / hop / vote geometry),
see ``repro_torch.launch.stream``.
"""

import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.core import tm, tm_train
from repro_torch.core.booleanize import StreamingBooleanizer, fit_quantile
from repro_torch.core.tm import TMConfig
from repro_torch.core.variations import VariationConfig
from repro_torch.data.tm_datasets import (KWS6_CLASSES, kws6_windows,
                                          synthetic_kws6)
from repro_torch.serve import (BatcherConfig, EngineConfig, ServeEngine,
                               StreamConfig, StreamServer)

MELS, BITS, WINDOW, HOP, VOTE = 8, 3, 6, 3, 5
N_UTTERANCES, EPOCHS = 120, 6


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # Synthetic KWS-6: six keyword classes as spectral trajectories.
    xtr, ytr = synthetic_kws6(torch.Generator().manual_seed(0),
                              n_utterances=N_UTTERANCES, n_frames=32,
                              n_mels=MELS, device="cpu")
    booleanizer = fit_quantile(xtr.numpy().reshape(-1, MELS), bits=BITS,
                               device=device)
    windower = StreamingBooleanizer(booleanizer, WINDOW, HOP)
    rows, labels = kws6_windows(xtr.numpy(), ytr.numpy(), windower)
    rows = torch.from_numpy(rows).to(device)
    labels = torch.from_numpy(labels).to(device)

    cfg = TMConfig(n_classes=6, clauses_per_class=10,
                   n_features=windower.n_boolean_features, n_states=100,
                   threshold=15, specificity=5.0)
    gen = torch.Generator(device=device)
    ta = tm_train.fit(tm.init_ta_state(gen.manual_seed(1), cfg, device),
                      gen.manual_seed(2), rows, labels, cfg,
                      epochs=EPOCHS, batch_size=200, parallel=True)
    acc = float(tm.accuracy(ta, rows, labels, cfg))
    print(f"per-window digital accuracy: {acc:.3f} on {device}")

    # One shared engine, two streaming sessions.  lazy_tune measures
    # kernel tiles for THIS model's shape bucket on first sight where the
    # tuning table has none for this device.
    engine = ServeEngine.from_ta_state(
        ta, cfg, n_replicas=2, seed=3,
        vcfg=VariationConfig(csa_offset=False),
        ecfg=EngineConfig(batcher=BatcherConfig.for_max_batch(32),
                          lazy_tune=True),
        device=device)
    print(f"backend: {engine.backend.name}, shape bucket "
          f"{engine.shape_key}, tiles "
          f"{(engine.tuning or {}).get('tiles') or 'default'}")
    server = StreamServer(engine, booleanizer,
                          StreamConfig(window=WINDOW, hop=HOP, vote=VOTE))

    # Two clients speak one keyword each, INTERLEAVED: both feed a hop of
    # frames a tick, so every engine batch mixes their windows; that
    # cross-session batching is why the sessions share one engine.
    spoke, streams = {}, {}
    for seed, sid in ((103, "alice"), (106, "bob")):
        x, y = synthetic_kws6(torch.Generator().manual_seed(seed),
                              n_utterances=1, n_frames=32, n_mels=MELS,
                              device="cpu")
        streams[sid], spoke[sid] = x[0].numpy(), int(y[0])
    for lo in range(0, 32, HOP):
        for sid, stream in streams.items():
            server.feed(sid, stream[lo:lo + HOP])
        server.pump()
    server.drain()
    heard = {}
    for sid in streams:
        s = server.sessions[sid]
        heard[sid] = s.keyword
        print(f"{sid}: spoke {KWS6_CLASSES[spoke[sid]]!r} -> heard "
              f"{KWS6_CLASSES[s.keyword]!r} "
              f"({len(s.decisions)} windows, vote over last {VOTE})")

    m = server.summary()
    print(f"{m['batches']} fused dispatches, mean {m['mean_batch']:.1f} "
          f"windows/batch across sessions, "
          f"{m['bytes_per_dispatch']:.0f} operand bytes/dispatch")
    return {"digital_window_accuracy": acc, "spoke": spoke, "heard": heard,
            "summary": m, "ta_state": ta.cpu(),
            "frames": (xtr.numpy(), ytr.numpy()), "streams": streams,
            "windows": (rows.cpu().numpy(), labels.cpu().numpy()),
            "window_preds": {sid: [d.pred for d in
                                   server.sessions[sid].decisions]
                             for sid in streams}}


if __name__ == "__main__":
    main()
