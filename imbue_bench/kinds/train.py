"""Training traffic (``"kind": "train"``): a closed loop of
``repro_torch.core.tm_train.train_step_batch`` over shuffled batches of
the training set, epoch after epoch (each epoch a permutation drawn from
the seed, its ragged tail dropped, as the port's ``epoch_batches``
drops it).

Set-up draws the training set and the TA state on the boundary (``N`` or
``N + 1``) and runs the first ``check.steps`` steps, on the first batches
of the first epoch, through the window's own call; they build the
kernels, and the TA state after each is kept.  The window goes on from
there with the same state and generator, runs at least
``check.window_steps`` steps and keeps that many of them, drawn from the
seed by reservoir sampling: the state before the step, the generator's
state, the batch and the state after it.

Afterwards the reference follows the first steps from the start state
and generator state, and redoes each kept window step from the
program's state before it (a window is too many steps to follow whole);
``ta_cells_off`` is the most TA cells that differ after any checked
step.  The window's states are the ones in which clauses fire and every
feedback branch moves cells: ``notes()`` gives the reference's count of
each over the checked steps.

Traffic parameters: ``batch``, ``images`` (``data.image_sets``),
``check``: ``steps``, ``window_steps`` and ``limit``.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from imbue_bench import compare, data
from imbue_bench.reference import imbue_tm as ref


class Cell:
    def __init__(self, *, device, seed, config, traffic):
        from repro_torch.core import tm_train
        from repro_torch.core.tm import TMConfig
        self.step = tm_train.train_step_batch
        self.device, self.seed = device, seed
        self.traffic = traffic
        self.cfg = TMConfig(**{k: config[k] for k in (
            "n_classes", "clauses_per_class", "n_features", "n_states",
            "threshold", "specificity")})
        self.batch = traffic["batch"]
        self.samples = []
        self.tally = {}

    def setup(self):
        cfg, dev, seed = self.cfg, self.device, self.seed
        sets = data.image_sets(seed, self.traffic["images"], cfg.n_classes,
                               dev, train=True, test=False)
        self.x, self.y = sets["x_train"], sets["y_train"]
        self.ta0 = data.init_ta(data.generator(seed, "ta_init", dev),
                                cfg.n_clauses, cfg.n_literals, cfg.n_states)
        self.gen = data.generator(seed, "train", dev)
        self.order = data.generator(seed, "order", dev)
        self.rng = np.random.default_rng(
            [int(seed) % (1 << 63), data.STREAMS["sample"]])
        self.batches = []
        self.gen_state0 = self.gen.get_state()
        self.checked, self.states = [], []
        ta = self.ta0
        for _ in range(self.traffic["check"]["steps"]):
            idx = self._next()
            self.checked.append(idx)
            ta = self.step(ta, self.gen, self.x[idx], self.y[idx], cfg)
            self.states.append(ta)
        self.ta = ta
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    def _next(self) -> torch.Tensor:
        if not self.batches:
            n, b = self.x.shape[0], self.batch
            perm = torch.randperm(n, generator=self.order,
                                  device=self.order.device)
            self.batches = [perm[i:i + b] for i in range(0, n - b + 1, b)]
            self.batches.reverse()
        return self.batches.pop()

    def _keep(self, n: int):
        """Reservoir sampling of ``check.window_steps`` steps over the
        window: the slot step ``n`` takes, or None."""
        k = self.traffic["check"]["window_steps"]
        if n < k:
            self.samples.append(None)
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < k else None

    def shape(self):
        c = self.cfg
        return {"batch": self.batch, "clauses": c.n_clauses,
                "literals": c.n_literals, "classes": c.n_classes,
                "ta_cells": c.n_ta}

    def window(self, seconds: float) -> dict:
        ta, steps = self.ta, 0
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while (time.perf_counter() < t_end
               or steps < self.traffic["check"]["window_steps"]):
            idx = self._next()
            j = self._keep(steps)
            if j is not None:
                # Copies: the check must not depend on the step leaving
                # its input alone.
                self.samples[j] = [steps, ta.clone(), self.gen.get_state(),
                                   idx, None]
            ta = self.step(ta, self.gen, self.x[idx], self.y[idx], self.cfg)
            if j is not None:
                self.samples[j][4] = ta.clone()
            steps += 1
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        self.ta = ta
        examples = steps * self.batch
        return {"steps": steps, "examples": examples, "window_s": window_s,
                "train_examples_per_s": examples / window_s}

    def free(self):
        """Drop the program's state before the reference runs."""
        del self.ta

    def attempted_failed(self, counters):
        return counters["steps"], 0

    def _generator(self, state) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.set_state(state)
        return g

    def _follow(self, step, rows=None):
        """The states after every checked step, each made by ``step(ta, g,
        x, y)`` on the checked batch (its first ``rows`` rows): the first
        steps one after another from the start state and generator state,
        then each kept window step from the program's state before it."""
        g = self._generator(self.gen_state0)
        ta, states = self.ta0, []
        for idx in self.checked:
            idx = idx[:rows]
            ta = step(ta, g, self.x[idx], self.y[idx])
            states.append(ta)
        for _, before, g_state, idx, _ in self.samples:
            idx = idx[:rows]
            states.append(step(before, self._generator(g_state),
                               self.x[idx], self.y[idx]))
        return states

    def _observed(self):
        """The program's states after every checked step."""
        return self.states + [after for *_, after in self.samples]

    def _starts(self):
        """The states that every checked step began from, as a step that
        returns its state unchanged would leave them."""
        return [self.ta0] * len(self.checked) + [
            before for _, before, *_ in self.samples]

    def _reference(self, precision="float32", tally=None):
        cfg = self.cfg
        return self._follow(lambda ta, g, x, y: ref.train_step(
            ta, g, x, y, cfg.n_classes, cfg.clauses_per_class, cfg.n_states,
            cfg.threshold, cfg.specificity, precision, tally))

    def judge(self):
        self.tally = {}
        want = self._reference(tally=self.tally)
        return [("ta_cells_off", compare.cells_off(self._observed(), want),
                 self.traffic["check"]["limit"])]

    def notes(self) -> list:
        """What the checked steps exercised, by the reference's count."""
        t = self.tally
        if not t:
            return []
        where = ", ".join(str(n) for n in sorted(s[0] for s in self.samples))
        return [f"checked steps: first {len(self.checked)}, window "
                f"{len(self.samples)}; clause-example pairs that fire "
                f"{t['fired']} of {t['pairs']}; TA-cell moves: type I up "
                f"{t['type1_up']}, type I down {t['type1_down']}, type II up "
                f"{t['type2_up']}, clipped {t['clipped']} (window steps "
                f"{where})"]

    def _program(self, rows=None):
        return self._follow(
            lambda ta, g, x, y: self.step(ta, g, x, y, self.cfg), rows=rows)

    def controls(self) -> dict:
        """Readings of the control (the reference's feedback probabilities
        in bfloat16) and of faults of the program's step: half of each
        batch left out, the state returned unchanged, no Type II
        feedback, no Type I increment."""
        want = self._reference()
        out = {"bfloat16": compare.cells_off(self._reference("bfloat16"),
                                             want),
               "half_batch": compare.cells_off(
                   self._program(rows=self.batch // 2), want),
               "unchanged": compare.cells_off(self._starts(), want)}
        for fault in ("no_type2", "no_type1_up"):
            with planted(fault):
                out[fault] = compare.cells_off(self._program(), want)
        return out


@contextlib.contextmanager
def planted(fault: str):
    """The program's training step with one feedback branch taken out:
    ``no_type2`` (its Type II delta, as for a state in which every literal
    is included) or ``no_type1_up`` (its Type I increment, as with
    ``r_hi`` never drawn true)."""
    from repro_torch.core import tm_train
    apply, type1 = tm_train._ta_delta_apply, tm_train._type1_delta

    def no_type2(state, lits, clauses, sums, y, draws, cfg, rows=slice(None)):
        full = torch.full_like(state, 2 * cfg.n_states)
        return apply(full, lits, clauses, sums, y, draws, cfg, rows)

    def no_type1_up(cl1, lit1, draws):
        return type1(cl1, lit1, draws._replace(
            r_hi=torch.zeros_like(draws.r_hi)))

    name, broken = {"no_type2": ("_ta_delta_apply", no_type2),
                    "no_type1_up": ("_type1_delta", no_type1_up)}[fault]
    old = getattr(tm_train, name)
    setattr(tm_train, name, broken)
    try:
        yield
    finally:
        setattr(tm_train, name, old)
