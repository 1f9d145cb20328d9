"""Quickstart on the PyTorch port: the full IMBUE pipeline on Noisy XOR
(port of ``examples/quickstart.py``).

  1. train a Tsetlin Machine (Type I/II feedback) on ``--device``;
  2. program its TA actions into a simulated 1T1R ReRAM crossbar, an
     ``api.CrossbarState`` (D2D variation drawn at SET/RESET time);
  3. run Boolean-to-Current inference through the backend registry
     (``api.select_backend`` picks a backend by capability) under
     cycle-to-cycle + CSA-offset noise: no fused kernel models a CSA
     offset, so the read goes to the eager ``analog-torch`` backend, and
     the line says so;
  4. compare digital and analog accuracy and report the paper's energy
     model (Table II / IV).

The data is drawn on the host from a generator seeded 0; the TA init,
the training, the programming and the reads take generators on
``--device`` seeded 1, 2, 3 and 4.  The training is the reference's:
``EPOCHS`` sequential epochs (one TA update an example).  The port's
sequential step is a host loop of eager launches (PERF.md §5), so at
the reference's 80 epochs over 4000 examples this takes minutes, on the
card as on the host; lower ``EPOCHS`` for a quicker look.

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

import torch

from repro_torch import api
from repro_torch._device import resolve_device
from repro_torch.core import energy, imbue, tm, tm_train
from repro_torch.core.mapping import csa_count_packed
from repro_torch.core.tm import TMConfig
from repro_torch.core.variations import VariationConfig
from repro_torch.data.tm_datasets import noisy_xor

N_TRAIN, N_TEST = 4000, 1000
EPOCHS = 80
MC_DRAWS = 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = TMConfig(n_classes=2, clauses_per_class=12, n_features=12,
                   n_states=100, threshold=15, specificity=3.9)
    print(f"TM: {cfg.n_classes} classes x {cfg.clauses_per_class} clauses,"
          f" {cfg.n_ta} TA cells, on {device}")

    # 1. train
    xtr, ytr, xte, yte = (t.to(device) for t in noisy_xor(
        torch.Generator().manual_seed(0), N_TRAIN, N_TEST, device="cpu"))
    gen = torch.Generator(device=device)
    ta = tm.init_ta_state(gen.manual_seed(1), cfg, device)
    ta = tm_train.fit(ta, gen.manual_seed(2), xtr, ytr, cfg,
                      epochs=EPOCHS, batch_size=2000)
    acc_digital = float(tm.accuracy(ta, xte, yte, cfg))
    stats = tm.include_stats(ta, cfg)
    print(f"digital accuracy: {acc_digital:.4f} "
          f"(paper: 0.992) — includes {stats['include_pct']:.1f}%")

    # 2. program the crossbar (one-time; D2D drawn at programming)
    vcfg = VariationConfig()
    state = api.CrossbarState.program(
        tm.include_mask(ta, cfg),
        torch.Generator(device=device).manual_seed(3), cfg, vcfg)
    e_prog = energy.programming_energy(stats["includes"], cfg.n_ta)
    print(f"programmed {cfg.n_ta} cells, one-time energy "
          f"{e_prog * 1e9:.2f} nJ")

    # 3a. one noisy read through the registry: capability selection
    # routes a CSA-offset read to the backend that models it.
    read = torch.Generator(device=device)
    sel = api.select_backend(state, generator=read.manual_seed(4))
    pred = api.predict(state, xte, read.manual_seed(4))
    acc_one = float((pred == yte).to(torch.float32).mean())
    print(f"analog accuracy, one chip/one read cycle "
          f"[{sel.backend.name}, needs {sorted(sel.required)}]: "
          f"{acc_one:.4f}")

    # 3b. ...and the Monte-Carlo view: MC_DRAWS manufactured chips
    accs = imbue.monte_carlo_accuracy(ta, xte, yte, read.manual_seed(4),
                                      cfg, vcfg, draws=MC_DRAWS,
                                      device=device)
    print(f"analog accuracy under D2D+C2C+CSA variation: "
          f"{float(accs.mean()):.4f} +- {float(accs.std(correction=0)):.4f}"
          f" over {MC_DRAWS} chips")

    # 4. energy per datapoint (the paper's model of the ReRAM chip)
    csas = csa_count_packed(cfg.n_ta)
    e = energy.imbue_energy_per_datapoint(stats["includes"], cfg.n_ta,
                                          csas)
    e_cmos = energy.cmos_tm_energy(cfg.n_ta)
    print(f"modeled IMBUE energy/datapoint: {e.total_nj:.4f} nJ "
          f"(CMOS TM baseline: {e_cmos * 1e9:.4f} nJ)")
    print(f"modeled TopJ^-1: {energy.top_j_inv(cfg.n_ta, e.total_j):.1f} "
          f"trillion TA-ops/J")
    print(f"modeled latency (fully parallel columns): "
          f"{energy.inference_latency_s(csas) * 1e9:.0f} ns/datapoint")
    return {"digital_accuracy": acc_digital, "analog_accuracy": acc_one,
            "backend": sel.backend.name,
            "mc_accuracy": accs.cpu().tolist(), "ta_state": ta.cpu(),
            "data": tuple(t.cpu().numpy() for t in (xtr, ytr, xte, yte))}


if __name__ == "__main__":
    main()
