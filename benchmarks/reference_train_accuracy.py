"""The JAX reference's side of ``chip_smoke.py``'s accuracy floors, on the
same arrays: training accuracy per epoch, and the Monte-Carlo row.

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
        python benchmarks/reference_train_accuracy.py

Rows, one JSON line each (about 4 min in all):

* ``mnist``: ``chip_smoke.image_task(**chip_smoke.IMAGE_TASK)`` drawn with
  numpy; ``repro.core.tm_train.fit`` (``parallel=True``, batches of
  ``chip_smoke.TRAIN_BATCH``) from ``init_ta_state`` for
  ``chip_smoke.TRAIN_EPOCHS`` epochs at imbue-tm-mnist, one epoch a call,
  the test accuracy after each.  Batch-parallel steps over
  ``[256, 2000, 1568]`` deltas: a few GB of host memory.
* ``coalesced``: the same for the coalesced pool (``chip_smoke.COALESCED``,
  ``coalesced.fit``, ``chip_smoke.COALESCED_EPOCHS`` epochs).
* ``kws`` / ``anomaly``: ``chip_smoke.KWS_TASK`` / ``ANOMALY_TASK``'s
  streams, drawn on the CPU generator through ``repro_torch.data``
  (``chip_smoke.stream_arrays``; the sha256 of the train frames, which
  ``chip_smoke.py`` prints too, shows they are the same arrays), windowed
  by the reference's ``fit_quantile`` / ``StreamingBooleanizer``, trained
  for ``chip_smoke.STREAM_EPOCHS`` epochs of ``chip_smoke.STREAM_TRAIN_BATCH``
  at the same width and hyperparameters: the test window accuracy per
  epoch.  ``chip_smoke.KWS_ACCURACY_FLOOR`` is the last KWS one minus 0.05.
* ``monte-carlo``: ``repro.core.imbue.monte_carlo_accuracy`` and
  ``clause_error_rate`` on ``chip_smoke.prototype_task``'s imbue-tm-mnist
  model and ``chip_smoke.MC_ROWS`` rows (the same include and rows as
  ``chip_smoke.py``'s Monte-Carlo row), ``chip_smoke.MC_DRAWS`` draws one
  at a time (one read's ``[B, C, K]`` currents are 200 MB), at nominal and
  under ``VariationConfig()``: every draw, their mean and spread.
"""

import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import chip_smoke  # noqa: E402
from repro.configs.imbue_tm import tm_config  # noqa: E402
from repro.core import coalesced, imbue, tm, tm_train  # noqa: E402
from repro.core.booleanize import (StreamingBooleanizer,  # noqa: E402
                                   fit_quantile)
from repro.core.variations import VariationConfig  # noqa: E402
from repro.data.tm_datasets import (kws6_windows,  # noqa: E402
                                    sensor_anomaly_windows)


def image_rows():
    """The ``mnist`` and ``coalesced`` rows, on one key chain."""
    xtr, ytr, xte, yte = (jnp.asarray(a) for a in chip_smoke.image_task(
        **chip_smoke.IMAGE_TASK))
    ytr, yte = ytr.astype(jnp.int32), yte.astype(jnp.int32)
    cfg = tm_config(chip_smoke.MODEL)
    key = jax.random.PRNGKey(chip_smoke.IMAGE_TASK["seed"])
    k_init, key = jax.random.split(key)
    ta = tm.init_ta_state(k_init, cfg)
    accs, secs = [], []
    for _ in range(chip_smoke.TRAIN_EPOCHS):
        key, k = jax.random.split(key)
        t0 = time.perf_counter()
        ta = tm_train.fit(ta, k, xtr, ytr, cfg, epochs=1,
                          batch_size=chip_smoke.TRAIN_BATCH, parallel=True)
        ta.block_until_ready()
        secs.append(time.perf_counter() - t0)
        accs.append(float(tm.accuracy(ta, xte, yte, cfg)))
    yield "mnist", {"model": chip_smoke.MODEL,
                    "test_accuracy_by_epoch": accs, "host_s_by_epoch": secs}
    ccfg = coalesced.CoalescedConfig(**chip_smoke.COALESCED)
    k_init, key = jax.random.split(key)
    cta, cw = coalesced.init_coalesced(k_init, ccfg)
    accs = []
    for _ in range(chip_smoke.COALESCED_EPOCHS):
        key, k = jax.random.split(key)
        cta, cw = coalesced.fit(cta, cw, k, xtr, ytr, ccfg, epochs=1,
                                batch_size=chip_smoke.TRAIN_BATCH)
        accs.append(float(coalesced.accuracy(cta, cw, xte, yte, ccfg)))
    yield "coalesced", {"model": "coalesced " + json.dumps(
        chip_smoke.COALESCED), "test_accuracy_by_epoch": accs}


def stream_row(task):
    xtr, ltr, xte, lte = chip_smoke.stream_arrays(task)
    ch = task["channels"]
    sb = StreamingBooleanizer(fit_quantile(xtr.reshape(-1, ch),
                                           task["bits"]),
                              task["window"], task["hop"])
    windows = kws6_windows if task["kind"] == "kws" else \
        sensor_anomaly_windows
    rtr, ytr = windows(xtr, ltr, sb)
    rte, yte = windows(xte, lte, sb)
    rtr, rte = jnp.asarray(rtr), jnp.asarray(rte)
    ytr, yte = jnp.asarray(ytr, jnp.int32), jnp.asarray(yte, jnp.int32)
    cfg = tm.TMConfig(**chip_smoke.stream_fields(task))
    key = jax.random.PRNGKey(task["seed"])
    k_init, key = jax.random.split(key)
    ta = tm.init_ta_state(k_init, cfg)
    accs, secs = [], []
    for _ in range(chip_smoke.STREAM_EPOCHS):
        key, k = jax.random.split(key)
        t0 = time.perf_counter()
        ta = tm_train.fit(ta, k, rtr, ytr, cfg, epochs=1,
                          batch_size=chip_smoke.STREAM_TRAIN_BATCH,
                          parallel=True)
        ta.block_until_ready()
        secs.append(time.perf_counter() - t0)
        accs.append(float(tm.accuracy(ta, rte, yte, cfg)))
    return {"model": task["kind"], "config": chip_smoke.stream_fields(task),
            "train_frames_sha256": chip_smoke.sha256(xtr),
            "train_windows": int(rtr.shape[0]),
            "test_windows": int(rte.shape[0]),
            "test_accuracy_by_epoch": accs, "host_s_by_epoch": secs}


def monte_carlo_row():
    cfg = tm_config(chip_smoke.MODEL)
    ta, x, y = chip_smoke.prototype_task(cfg, chip_smoke.MC_ROWS,
                                         chip_smoke.SEED)
    ta, x, y = jnp.asarray(ta), jnp.asarray(x), jnp.asarray(y, jnp.int32)
    out = {"model": chip_smoke.MODEL, "rows": chip_smoke.MC_ROWS,
           "draws": chip_smoke.MC_DRAWS,
           "digital_accuracy": float(tm.accuracy(ta, x, y, cfg))}
    for name, vcfg in (("nominal", VariationConfig.nominal()),
                       ("d2d_c2c_csa", VariationConfig())):
        keys = jax.random.split(jax.random.PRNGKey(chip_smoke.SEED),
                                chip_smoke.MC_DRAWS)
        accs = [float(imbue.monte_carlo_accuracy(ta, x, y, k, cfg, vcfg,
                                                 draws=1)[0]) for k in keys]
        errs = [float(imbue.clause_error_rate(ta, x, k, cfg, vcfg,
                                              draws=1)[0]) for k in keys]
        out[name] = {"accuracy": accs, "accuracy_mean": float(np.mean(accs)),
                     "accuracy_std": float(np.std(accs, ddof=1)),
                     "clause_error": errs,
                     "clause_error_mean": float(np.mean(errs)),
                     "clause_error_std": float(np.std(errs, ddof=1))}
    return out


def emit(name, row) -> None:
    print(json.dumps({"row": name, "platform": "cpu (jax)", **row}),
          flush=True)


def main() -> int:
    for name, row in image_rows():
        emit(name, row)
    emit("kws", stream_row(chip_smoke.KWS_TASK))
    emit("anomaly", stream_row(chip_smoke.ANOMALY_TASK))
    emit("monte-carlo", monte_carlo_row())
    return 0


if __name__ == "__main__":
    sys.exit(main())
