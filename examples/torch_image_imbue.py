"""Image-scale IMBUE pipeline on the PyTorch port, MNIST-shaped synthetic
data (port of ``examples/image_imbue.py``).

The paper's evaluation flow at image scale: Boolean 28 x 28 inputs ->
multi-class TM -> crossbar programming -> analog inference on the fused
analog kernel -> a Table-IV-style energy report of the modeled ReRAM chip
(conservative + measured-activity models).

The read pins ``analog-cuda`` (the dense kernel ``imbue_infer``) and
passes no read generator, as the reference pins ``analog-pallas``: one
chip programmed under ``VariationConfig()``'s D2D draws, read without
cycle noise, so the kernel serves it; the backend line says which backend
ran and whether capability selection fell back.  The data is drawn on a
host generator seeded 0; the TA init, the training and the programming
take seeds 1, 2 and 3 on ``--device``.

  PYTHONPATH=src python examples/torch_image_imbue.py [--quick]
  PYTHONPATH=src python examples/torch_image_imbue.py --quick --device cpu
"""

import argparse

import torch

from repro_torch import api
from repro_torch._device import resolve_device
from repro_torch.core import energy, tm, tm_train
from repro_torch.core.mapping import csa_count_packed
from repro_torch.core.tm import TMConfig
from repro_torch.core.variations import VariationConfig
from repro_torch.data.tm_datasets import synthetic_image_dataset

N_TRAIN, N_TEST = 2000, 500
KERNEL_ROWS = 256


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = TMConfig(n_classes=10, clauses_per_class=20, n_features=784,
                   n_states=127, threshold=15, specificity=5.0)
    xtr, ytr, xte, yte = (t.to(device) for t in synthetic_image_dataset(
        torch.Generator().manual_seed(0), n_train=N_TRAIN, n_test=N_TEST,
        device="cpu"))
    print(f"data: {xtr.shape[0]} train / {xte.shape[0]} test, "
          f"{cfg.n_ta} TA cells, on {device}")

    gen = torch.Generator(device=device)
    ta = tm.init_ta_state(gen.manual_seed(1), cfg, device)
    epochs = 3 if args.quick else 10
    ta = tm_train.fit(ta, gen.manual_seed(2), xtr, ytr, cfg,
                      epochs=epochs, batch_size=200, parallel=True)
    acc = float(tm.accuracy(ta, xte, yte, cfg))
    stats = tm.include_stats(ta, cfg)
    print(f"digital accuracy {acc:.3f}, includes "
          f"{stats['include_pct']:.2f}%")

    # The fused analog kernel through the registry: pin analog-cuda.
    state = api.CrossbarState.program(
        tm.include_mask(ta, cfg),
        torch.Generator(device=device).manual_seed(3), cfg,
        VariationConfig())
    sel = api.select_backend(state, prefer="analog-cuda")
    pred = api.predict(state, xte[:KERNEL_ROWS], backend="analog-cuda")
    acc_kernel = float((pred == yte[:KERNEL_ROWS]).to(torch.float32).mean())
    print(f"analog fused-kernel accuracy ({KERNEL_ROWS} samples, D2D chip) "
          f"[{sel.backend.name}"
          + (f", fallback: {sel.fallback_reason}" if sel.fell_back else "")
          + f"]: {acc_kernel:.3f}")

    # modeled energy: conservative (the paper's script) + measured literal
    # activity
    csas = csa_count_packed(cfg.n_ta)
    p_lit0 = float((1 - tm.literals(xte)).to(torch.float32).mean())
    e_cons = energy.imbue_energy_per_datapoint(stats["includes"],
                                               cfg.n_ta, csas)
    e_meas = energy.imbue_energy_per_datapoint(
        stats["includes"], cfg.n_ta, csas,
        p_lit0_include=p_lit0, p_lit0_exclude=p_lit0)
    e_cmos = energy.cmos_tm_energy(cfg.n_ta)
    print(f"modeled energy/datapoint: conservative {e_cons.total_nj:.2f} "
          f"nJ, measured-activity {e_meas.total_nj:.2f} nJ, "
          f"CMOS TM {e_cmos * 1e9:.2f} nJ")
    print(f"modeled TopJ^-1 (measured): "
          f"{energy.top_j_inv(cfg.n_ta, e_meas.total_j):.0f}")
    return {"digital_accuracy": acc, "kernel_accuracy": acc_kernel,
            "backend": sel.backend.name, "fell_back": sel.fell_back,
            "ta_state": ta.cpu(), "p_lit0": p_lit0,
            "energy_nj": {"conservative": e_cons.total_nj,
                          "measured": e_meas.total_nj,
                          "cmos": e_cmos * 1e9},
            "data": tuple(t.cpu().numpy() for t in (xtr, ytr, xte, yte))}


if __name__ == "__main__":
    main()
