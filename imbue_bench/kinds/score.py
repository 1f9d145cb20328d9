"""Scoring traffic (``"kind": "score"``): the whole test set classified
again and again through ``repro_torch.api``, with a fixed number of calls
in flight, as an offline scorer keeps them.

A call is what ``api.predict`` composes, taken apart so that the check
can read the class sums: ``core.tm.literals`` of the rows,
``api.class_sums`` through the traffic's backend (a fresh C2C read of
every chip when the state is analog) and the serving engine's pooled
vote, ``serve.replica.ensemble_vote(..., "sum")``.  Its predictions are
copied to the host; a call's latency runs from its issue to its
predictions on the host.  The next call is issued before the oldest is
collected.

Traffic parameters: ``state`` (``analog``: R chips of D2D-drawn
resistances in the plane-packed format; ``digital``: the packed TM),
``backend``, ``replicas``, ``variation`` (the read's ``d2d``, ``c2c``,
``csa_offset``), ``images`` (``data.image_sets``), ``clause_includes``,
``outstanding``, and ``check``: ``reads``, the calls whose outputs are
compared (drawn from the seed over the window), and ``limit``.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from imbue_bench import compare, data
from imbue_bench.reference import imbue_tm as ref


class Cell:
    def __init__(self, *, device, seed, config, traffic):
        from repro_torch import api
        from repro_torch.core import tm as ptm
        from repro_torch.core.tm import TMConfig
        from repro_torch.serve.replica import ensemble_vote
        self.api, self.ptm, self.vote = api, ptm, ensemble_vote
        self.device, self.seed = device, seed
        self.traffic = traffic
        self.cfg = TMConfig(**{k: config[k] for k in (
            "n_classes", "clauses_per_class", "n_features", "n_states",
            "threshold", "specificity")})
        self.analog = traffic["state"] == "analog"
        self.replicas = traffic["replicas"] if self.analog else 1
        self.outstanding = traffic["outstanding"]
        self.backend = traffic["backend"]
        self.samples = []
        self.fallback = None

    # ---------------------------------------------------------- set-up
    def setup(self):
        from repro_torch.api import DigitalState, ReplicaStackState
        from repro_torch.core.imbue import IMBUEConfig
        from repro_torch.core.variations import VariationConfig
        cfg, dev, seed = self.cfg, self.device, self.seed
        sets = data.image_sets(seed, self.traffic["images"], cfg.n_classes,
                               dev, train=False, test=True)
        self.x = sets["x_test"]
        ta = data.prototype_clauses(
            data.generator(seed, "model", dev), sets["protos"],
            cfg.clauses_per_class, cfg.n_states,
            tuple(self.traffic["clause_includes"]))
        self.include = ta > cfg.n_states
        if self.analog:
            self.r_d2d = data.d2d_resistances(
                data.generator(seed, "d2d", dev), self.include,
                self.replicas)
            self.state = ReplicaStackState(
                r_stack=self.r_d2d, include=self.include, tm_cfg=cfg,
                icfg=IMBUEConfig(),
                vcfg=VariationConfig(**self.traffic["variation"])
            ).pack_planes()
            self.gen = data.generator(seed, "reads", dev)
        else:
            self.state = DigitalState.from_ta(ta, cfg).pack()
            self.gen = None
        self.fallback = self._fallback()
        self.rng = np.random.default_rng(
            [int(seed) % (1 << 63), data.STREAMS["sample"]])
        self.cuda = torch.device(dev).type == "cuda"
        self.outputs = {}
        if self.cuda:
            self.host = [torch.empty(self.x.shape[0], dtype=torch.int64,
                                     pin_memory=True)
                         for _ in range(self.outstanding)]
            self.events = [torch.cuda.Event()
                           for _ in range(self.outstanding)]
        for _ in range(2):                       # warm-up: builds, caches
            self._loop(calls=self.outstanding + 1, keep=False)

    def _fallback(self):
        sel = self.api.select_backend(self.state, generator=self.gen,
                                      prefer=self.backend)
        return sel.fallback_reason

    def shape(self):
        c = self.cfg
        return {"rows": int(self.x.shape[0]), "replicas": self.replicas,
                "clauses": c.n_clauses, "literals": c.n_literals,
                "classes": c.n_classes, "ta_cells": c.n_ta}

    # ---------------------------------------------------------- the call
    def _call(self):
        sums = self.api.class_sums(self.state, self.ptm.literals(self.x),
                                   self.gen, backend=self.backend)
        pred = self.vote(sums if self.analog else sums[None], "sum")
        return sums, pred

    def _keep(self, n: int):
        """Reservoir sampling of ``check.reads`` calls over the window:
        the slot call ``n`` takes, or None."""
        k = self.traffic["check"]["reads"]
        if n < k:
            self.samples.append(None)
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < k else None

    def _loop(self, *, seconds=None, calls=None, keep=True):
        pending = collections.deque()
        lat = []
        n = 0
        t0 = time.perf_counter()
        t_end = None if seconds is None else t0 + seconds

        def collect():
            m, t_issue, slot, j = pending.popleft()
            if self.cuda:
                self.events[slot].synchronize()
                pred = self.host[slot]
            else:
                pred = self.outputs[slot]
            lat.append(time.perf_counter() - t_issue)
            if j is not None and self.samples[j][0] == m:
                self.samples[j][3] = pred.clone()

        while (n < calls) if calls is not None else (
                time.perf_counter() < t_end):
            if len(pending) == self.outstanding:
                collect()
            slot = n % self.outstanding
            g_state = self.gen.get_state() if self.gen is not None else None
            t_issue = time.perf_counter()
            sums, pred = self._call()
            if self.cuda:
                self.host[slot].copy_(pred, non_blocking=True)
                self.events[slot].record()
            else:
                self.outputs[slot] = pred
            j = self._keep(n) if keep else None
            if j is not None:
                self.samples[j] = [n, g_state, sums, None]
            pending.append((n, t_issue, slot, j))
            n += 1
        while pending:
            collect()
        return n, time.perf_counter() - t0, lat

    def window(self, seconds: float) -> dict:
        n, window_s, lat = self._loop(seconds=seconds)
        rows = n * int(self.x.shape[0])
        return {"calls": n, "rows": rows, "window_s": window_s,
                "latencies_s": lat, "score_rows_per_s": rows / window_s,
                "score_p95_ms": p95(lat) * 1e3}

    # ---------------------------------------------------------- judging
    def free(self):
        """Drop the program's state before the reference runs."""
        del self.state

    def attempted_failed(self, counters):
        """Calls made, and calls whose backend fell back from the
        traffic's (the selection depends on the state alone, read before
        and after the window): all or none."""
        n = counters["calls"]
        return n, (n if self.fallback or self._fallback() else 0)

    def _read(self, g_state) -> torch.Tensor:
        """The resistances of the read that began at ``g_state``: the C2C
        uniforms redrawn as the program draws them, one ``[R, C, L]``
        float32 ``torch.rand`` from the read's generator."""
        g = torch.Generator(device=self.device)
        g.set_state(g_state)
        u = torch.rand(self.r_d2d.shape, generator=g, device=self.device,
                       dtype=torch.float32)
        return ref.read_resistances(self.r_d2d, self.include, u)

    def _reading(self, answers) -> float:
        """The number compared over the sampled calls, for ``answers``:
        ``[(sums, pred, generator state)]``."""
        cfg = self.cfg
        if self.analog:
            return max(compare.widest_margin(
                sums, pred, self.x, self.include, self._read(g_state),
                cfg.n_classes, cfg.clauses_per_class)
                for sums, pred, g_state in answers)
        ref_sums = ref.digital_sums(self.x, self.include, cfg.n_classes,
                                    cfg.clauses_per_class)
        return sum(compare.wrong_answers(sums, pred, ref_sums)
                   for sums, pred, _ in answers)

    def judge(self):
        name = "widest_margin" if self.analog else "wrong_answers"
        return [(name, self._reading([(s, p, g) for _, g, s, p
                                      in self.samples]),
                 self.traffic["check"]["limit"])]

    def controls(self) -> dict:
        """Readings of the controls, each put in the program's place on
        the sampled calls: analog, the reference read in float32 with
        TF32 products and in bfloat16; digital, which states no
        precision, a clause that fires with one violation."""
        cfg = self.cfg
        out = {}
        if self.analog:
            for precision in ("tf32", "bfloat16"):
                answers = []
                for _, g_state, _, _ in self.samples:
                    sums = ref.analog_sums(
                        self.x, self.include, self._read(g_state),
                        cfg.n_classes, cfg.clauses_per_class,
                        precision=precision)
                    answers.append((sums, ref.predictions(sums.sum(0)),
                                    g_state))
                out[precision] = self._reading(answers)
            return out
        sums = ref.digital_sums(self.x, self.include, cfg.n_classes,
                                cfg.clauses_per_class, max_violations=1)
        out["one_violation_fires"] = self._reading(
            [(sums, ref.predictions(sums), None)] * len(self.samples))
        return out


def p95(values) -> float:
    """The nearest-rank 95th percentile."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    return float(v[max(0, int(np.ceil(0.95 * v.size)) - 1)])
