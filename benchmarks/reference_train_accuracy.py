"""Test accuracy of the JAX reference's training on ``chip_smoke.py``'s
image task: the floor that the port's trained imbue-tm-mnist state is
held to on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu \
        python benchmarks/reference_train_accuracy.py

Draws ``chip_smoke.image_task(**chip_smoke.IMAGE_TASK)`` with numpy,
trains ``repro.core.tm_train.fit`` (``parallel=True``, batches of
``chip_smoke.TRAIN_BATCH``) from ``init_ta_state`` for
``chip_smoke.TRAIN_EPOCHS`` epochs at imbue-tm-mnist, one epoch a call,
and prints the test accuracy after each epoch; then the same for the
coalesced pool (``chip_smoke.COALESCED``, ``coalesced.fit``,
``chip_smoke.COALESCED_EPOCHS`` epochs).  One JSON line per model.  The
full width runs batch-parallel steps over ``[256, 2000, 1568]`` deltas:
a few GB of host memory.
"""

import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import chip_smoke  # noqa: E402
from repro.configs.imbue_tm import tm_config  # noqa: E402
from repro.core import coalesced, tm, tm_train  # noqa: E402


def main() -> int:
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
    print(json.dumps({"model": chip_smoke.MODEL, "platform": "cpu (jax)",
                      "test_accuracy_by_epoch": accs,
                      "host_s_by_epoch": secs}), flush=True)
    ccfg = coalesced.CoalescedConfig(**chip_smoke.COALESCED)
    k_init, key = jax.random.split(key)
    cta, cw = coalesced.init_coalesced(k_init, ccfg)
    accs = []
    for _ in range(chip_smoke.COALESCED_EPOCHS):
        key, k = jax.random.split(key)
        cta, cw = coalesced.fit(cta, cw, k, xtr, ytr, ccfg, epochs=1,
                                batch_size=chip_smoke.TRAIN_BATCH)
        accs.append(float(coalesced.accuracy(cta, cw, xte, yte, ccfg)))
    print(json.dumps({"model": "coalesced " + json.dumps(
        chip_smoke.COALESCED), "platform": "cpu (jax)",
        "test_accuracy_by_epoch": accs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
