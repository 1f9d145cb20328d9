"""The plain reference on both configurations at tiny sizes on the host:
it imports nothing of the program, and it agrees with the port where the
two must agree."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from imbue_bench import compare, data
from imbue_bench.reference import imbue_tm as ref
from imbue_bench.tests.tiny import BENCH, ROOT, one_thread  # noqa: F401

CONFIGS = ["imbue-tm-mnist", "imbue-tm-kmnist"]
IMAGES = {"side": 16, "box": 8, "density": 0.25, "noise": 0.08,
          "train_rows": 128, "test_rows": 64}


def tiny_config(name):
    """The configuration with its hyperparameters (N, T, s) and fewer
    clauses and features."""
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    conf.update(clauses_per_class=2 * (conf["clauses_per_class"] // 40),
                n_features=IMAGES["side"] ** 2)
    return conf


def tm_cfg(conf):
    from repro_torch.core.tm import TMConfig
    return TMConfig(**{k: conf[k] for k in (
        "n_classes", "clauses_per_class", "n_features", "n_states",
        "threshold", "specificity")})


def model(conf, seed=5):
    sets = data.image_sets(seed, IMAGES, conf["n_classes"], "cpu",
                           train=True, test=True)
    ta = data.prototype_clauses(data.generator(seed, "model", "cpu"),
                                sets["protos"], conf["clauses_per_class"],
                                conf["n_states"])
    return sets, ta


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import imbue_bench.reference.imbue_tm, "
            "imbue_bench.compare, imbue_bench.data, imbue_bench.counts; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    loaded = set(eval(out))
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("name", CONFIGS)
def test_digital_sums_match_the_port(name):
    from repro_torch.core import tm
    conf = tiny_config(name)
    sets, ta = model(conf)
    include = ta > conf["n_states"]
    want = tm.forward(ta, sets["x_test"], tm_cfg(conf))
    got = ref.digital_sums(sets["x_test"], include, conf["n_classes"],
                           conf["clauses_per_class"], rows=16)
    assert torch.equal(got, want)
    assert torch.equal(ref.predictions(got), tm.predict(ta, sets["x_test"],
                                                        tm_cfg(conf)))


@pytest.mark.parametrize("name", CONFIGS)
def test_nominal_analog_read_is_the_digital_tm(name):
    """At nominal resistances and no C2C excursion the crossbar computes
    the digital TM exactly (the paper's sensing margin)."""
    conf = tiny_config(name)
    sets, ta = model(conf)
    include = ta > conf["n_states"]
    r_nom = torch.where(include, ref.LRS_MEAN_OHM, ref.HRS_MEAN_OHM)
    r_read = ref.read_resistances(r_nom.expand(2, *include.shape), include,
                                  torch.full((2, *include.shape), 0.5))
    got = ref.analog_sums(sets["x_test"], include, r_read,
                          conf["n_classes"], conf["clauses_per_class"])
    want = ref.digital_sums(sets["x_test"], include, conf["n_classes"],
                            conf["clauses_per_class"])
    assert torch.equal(got, want.expand(2, *want.shape))


@pytest.mark.parametrize("name", CONFIGS)
def test_port_analog_read_within_float32_of_the_reference(name):
    """The port's plane-packed read on the host (its plain version), with
    D2D and a C2C draw, against the float64 reference of the same draw."""
    from repro_torch import api
    from repro_torch.api import ReplicaStackState
    from repro_torch.core.tm import literals
    from repro_torch.core.variations import VariationConfig
    conf = tiny_config(name)
    sets, ta = model(conf)
    include = ta > conf["n_states"]
    r_d2d = data.d2d_resistances(data.generator(5, "d2d", "cpu"), include, 3)
    state = ReplicaStackState(
        r_stack=r_d2d, include=include, tm_cfg=tm_cfg(conf),
        vcfg=VariationConfig(csa_offset=False)).pack_planes()
    g = data.generator(5, "reads", "cpu")
    g_state = g.get_state()
    sums = api.class_sums(state, literals(sets["x_test"]), g,
                          backend="analog-cuda-packed2")
    g.set_state(g_state)
    u = torch.rand(r_d2d.shape, generator=g)
    r_read = ref.read_resistances(r_d2d, include, u)
    pred = ref.predictions(sums.sum(0))
    assert compare.widest_margin(sums, pred, sets["x_test"], include,
                                 r_read, conf["n_classes"],
                                 conf["clauses_per_class"]) < 1e-6
    # One vote moved: only a clause whose column lies far from the
    # threshold explains it.  A prediction moved: nothing explains it.
    bad = sums.clone()
    bad[0, 0, 0] += 1
    assert compare.widest_margin(bad, ref.predictions(bad.sum(0)),
                                 sets["x_test"], include, r_read,
                                 conf["n_classes"],
                                 conf["clauses_per_class"]) > 1e-4
    moved = pred.clone()
    moved[0] = (moved[0] + 1) % conf["n_classes"]
    assert compare.widest_margin(sums, moved, sets["x_test"], include,
                                 r_read, conf["n_classes"],
                                 conf["clauses_per_class"]) == (
        compare.UNEXPLAINED)


@pytest.mark.parametrize("name", CONFIGS)
def test_training_step_matches_the_port(name):
    from repro_torch.core import tm_train
    conf = tiny_config(name)
    sets, _ = model(conf)
    ta = data.init_ta(data.generator(3, "ta_init", "cpu"),
                      conf["n_classes"] * conf["clauses_per_class"],
                      2 * conf["n_features"], conf["n_states"])
    g_port = data.generator(3, "train", "cpu")
    g_ref = data.generator(3, "train", "cpu")
    x, y = sets["x_train"], sets["y_train"]
    want, got = ta, ta
    for i in range(2):
        rows = slice(32 * i, 32 * (i + 1))
        want = tm_train.train_step_batch(want, g_port, x[rows], y[rows],
                                         tm_cfg(conf))
        got = ref.train_step(got, g_ref, x[rows], y[rows],
                             conf["n_classes"], conf["clauses_per_class"],
                             conf["n_states"], conf["threshold"],
                             conf["specificity"])
        assert torch.equal(got, want)
    assert int((got != ta).sum()) > 0
