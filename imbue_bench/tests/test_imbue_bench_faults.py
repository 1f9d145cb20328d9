"""A run with its timed path broken underneath comes out not correct, and
so do the controls, on tiny cells on the host (the card's look is
skipped; the rest of the run is the one a card runs)."""

from __future__ import annotations

import pytest
import torch

from imbue_bench import control
from imbue_bench.tests import tiny
from imbue_bench.tests.tiny import one_thread  # noqa: F401

SCORE = ["mnist-r4-analog-score", "kmnist-digital-score"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))


def altered_answer(class_sums):
    def broken(state, lits, generator=None, **kw):
        sums = class_sums(state, lits, generator, **kw).clone()
        sums.view(-1)[0] += 1
        return sums
    return broken


def half_the_rows(class_sums):
    def broken(state, lits, generator=None, **kw):
        half = class_sums(state, lits[: lits.shape[0] // 2], generator, **kw)
        return torch.cat([half, half], dim=-2)
    return broken


@pytest.mark.parametrize("cell", SCORE)
@pytest.mark.parametrize("fault", [altered_answer, half_the_rows])
def test_scoring_faults_are_not_correct(root, monkeypatch, cell, fault):
    from repro_torch import api
    monkeypatch.setattr(api, "class_sums", fault(api.class_sums))
    result, _ = tiny.run(root, cell)
    assert result["correct"] is False


def unchanged(step):
    return lambda ta, generator, x, y, cfg: ta


def half_batch(step):
    def broken(ta, generator, x, y, cfg):
        return step(ta, generator, x[: x.shape[0] // 2],
                    y[: y.shape[0] // 2], cfg)
    return broken


def one_cell_off(step):
    def broken(ta, generator, x, y, cfg):
        out = step(ta, generator, x, y, cfg).clone()
        out.view(-1)[0] += 1
        return out
    return broken


@pytest.mark.parametrize("fault", [unchanged, half_batch, one_cell_off])
def test_training_faults_are_not_correct(root, monkeypatch, fault):
    from repro_torch.core import tm_train
    monkeypatch.setattr(tm_train, "train_step_batch",
                        fault(tm_train.train_step_batch))
    result, _ = tiny.run(root, "kmnist-train-b256")
    assert result["correct"] is False


@pytest.mark.parametrize("fault", ["no_type2", "no_type1_up"])
def test_training_without_a_feedback_branch_is_not_correct(root, fault):
    """A step that drops its Type II delta or its Type I increment: the
    window's checked steps, in which clauses fire, catch it."""
    from imbue_bench.kinds import train
    result, lines = tiny.run(root, "kmnist-train-b256")
    assert result["correct"] is True
    assert "type II up 0," not in lines[0] and "type I up 0," not in lines[0]
    with train.planted(fault):
        result, _ = tiny.run(root, "kmnist-train-b256")
    assert result["correct"] is False


# The host has no TF32: the analog control shown here is bfloat16.
CONTROLS = {"mnist-r4-analog-score": "bfloat16",
            "kmnist-digital-score": "one_violation_fires",
            "kmnist-train-b256": "bfloat16"}


@pytest.mark.parametrize("cell", sorted(CONTROLS))
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_is_not_correct(root, cell, seed):
    r = control.readings(root, cell, seed, 0.2, "cpu")
    assert r["program"] <= r["limit"] < r["controls"][CONTROLS[cell]]
