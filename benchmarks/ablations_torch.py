"""Beyond-paper ablations on the PyTorch port (port of
``benchmarks/ablations.py``).

1. **Coalesced TM x IMBUE** (the paper's §V future work): a clause pool
   shared across classes with per-class integer weights — the same
   crossbar, a weighted digital tail.  Measures the TA-cell / energy
   saving at matched accuracy and the noise-robustness trade-off.  Its
   vanilla half trains sequentially, a host loop of eager launches in the
   port (PERF.md §5), so it takes minutes.
2. **Partial-clause width W**: the paper fixes W = 32; the sweep reads
   the analytic sensing margin and the Monte-Carlo miss rate of the
   all-exclude leak band under D2D variation, drawn on ``device`` from a
   generator seeded W (the reference folds W into one key), so the rates
   match the reference's by distribution.
"""

from __future__ import annotations

import torch

from repro_torch import api
from repro_torch._device import resolve_device
from repro_torch.core import coalesced as co
from repro_torch.core import energy, imbue, tm_train
from repro_torch.core import variations as var
from repro_torch.core.mapping import csa_count_packed
from repro_torch.core.tm import TMConfig, include_stats, init_ta_state
from repro_torch.core.variations import VariationConfig, split_generator
from repro_torch.data.tm_datasets import noisy_xor


def _acc(state, x, y) -> float:
    """Accuracy through the backend registry; a digital state pinned to
    the plain ``digital-torch`` backend, as the reference pins its jnp
    one."""
    backend = ("digital-torch" if isinstance(state, api.DigitalState)
               else None)
    pred = api.predict(state, x, backend=backend)
    return float((pred == y).to(torch.float32).mean())


def coalesced_vs_vanilla(device=None):
    """XOR at three noise levels: vanilla (12 clauses a class = 24) vs
    coalesced (12 shared): cells, accuracy, IMBUE energy."""
    device = resolve_device(device)
    rows, checks = [], []
    for noise in (0.0, 0.1, 0.4):
        xtr, ytr, xte, yte = (t.to(device) for t in noisy_xor(
            torch.Generator().manual_seed(0), 4000, 1000,
            label_noise=noise, device="cpu"))
        gen = torch.Generator(device=device)
        # vanilla
        vcfg = TMConfig(n_classes=2, clauses_per_class=12, n_features=12,
                        n_states=100, threshold=15, specificity=3.9)
        ta = init_ta_state(gen.manual_seed(1), vcfg, device)
        ta = tm_train.fit(ta, gen.manual_seed(2), xtr, ytr, vcfg,
                          epochs=40, batch_size=1000)
        acc_v = _acc(api.DigitalState.from_ta(ta, vcfg), xte, yte)
        st = include_stats(ta, vcfg)
        e_v = energy.imbue_energy_per_datapoint(
            st["includes"], vcfg.n_ta, csa_count_packed(vcfg.n_ta)).total_j
        # coalesced (half the clause pool)
        ccfg = co.CoalescedConfig(n_classes=2, n_clauses=12,
                                  n_features=12, n_states=100,
                                  threshold=15, specificity=3.9)
        cta, w = co.init_coalesced(gen.manual_seed(1), ccfg, device)
        cta, w = co.fit(cta, w, gen.manual_seed(2), xtr, ytr, ccfg,
                        epochs=40, batch_size=16)
        acc_c = _acc(api.CoalescedState(ta_state=cta, weights=w, cfg=ccfg),
                     xte, yte)
        inc_c = int((cta > ccfg.n_states).sum())
        e_c = energy.imbue_energy_per_datapoint(
            inc_c, ccfg.n_ta, csa_count_packed(ccfg.n_ta)).total_j
        rows.append((f"noise{int(noise*100)}", acc_v, acc_c,
                     vcfg.n_ta, ccfg.n_ta, e_v * 1e12, e_c * 1e12))
    # low noise: coalesced matches vanilla with HALF the cells
    checks.append(("ablation/coalesced_matches_at_low_noise",
                   rows[0][2] >= rows[0][1] - 0.03
                   and rows[1][2] >= rows[1][1] - 0.05,
                   f"acc clean {rows[0][2]:.3f} vs {rows[0][1]:.3f}, "
                   f"10% {rows[1][2]:.3f} vs {rows[1][1]:.3f} "
                   f"at {rows[0][4]}/{rows[0][3]} cells"))
    # the trade-off: heavy label noise favors vanilla (fixed polarity)
    checks.append(("ablation/coalesced_noise_tradeoff_documented",
                   rows[2][1] - rows[2][2] > 0.1,
                   f"40% noise: vanilla {rows[2][1]:.3f} vs coalesced "
                   f"{rows[2][2]:.3f} — weights amplify noisy feedback"))
    return rows, checks


def column_width_sweep(draws: int = 4000, device=None):
    """Sensing margin + Monte-Carlo miss rate of the all-exclude leak
    band against W."""
    device = resolve_device(device)
    rows, checks = [], []
    for w in (8, 16, 24, 32, 40, 48):
        icfg = imbue.IMBUEConfig(width=w)
        margin_mv = icfg.sensing_margin() * 1e3
        g1, g2 = split_generator(
            torch.Generator(device=device).manual_seed(w), 2)
        hrs = var.sample_hrs(g1, (draws, w), device)
        i_leak = (var.V_READ / (var.SERIES_FACTOR * hrs)).sum(-1)
        off = var.csa_offset(g2, (draws,), VariationConfig(), device)
        v_ref = icfg.reference_voltage()
        miss = float(((i_leak * icfg.r_divider) > v_ref + off)
                     .to(torch.float32).mean())
        rows.append((f"W{w}", margin_mv, miss))
    margin = dict((r[0], r[1]) for r in rows)
    miss = dict((r[0], r[2]) for r in rows)
    checks.append(("ablation/margin_positive_at_32", margin["W32"] > 0,
                   f"margin(W=32) = {margin['W32']:.2f} mV"))
    checks.append(("ablation/margin_dead_past_40", margin["W48"] < 0,
                   "margin(W=48) < 0 — nominal leak band crosses one "
                   "include; paper's W=32 validated"))
    checks.append(("ablation/w16_robust", miss["W16"] < 1e-3,
                   f"W=16 leak-corner miss {miss['W16']:.4f}"))
    return rows, checks
