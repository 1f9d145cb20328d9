"""Live replica health probing (port of ``repro.serve.health``):
committed probe rows with known-good answers, scored per chip through the
engine's own forward.

A correctly programmed chip reproduces the digital TM's class-sum vector
row-exactly (the sums are integer clause-vote counts, and the analog read
recovers each clause output at the healthy operating point), while a chip
with percent-level stuck-at faults silences or ghost-fires clauses and
its sums move.  The committed reference is therefore the digital forward
of the pool's clean model, not a per-chip snapshot, so it stays valid
across repairs and re-programming.

Two choices keep the score discriminative on sparse models, where random
inputs rarely fire a clause and the sums degenerate to all-zero ties:

* **clause-targeting rows** — probe row ``i`` satisfies clause
  ``i % n_clauses`` exactly (its positive includes set, its negated
  includes cleared, the other features random), so a stuck cell in any
  clause row has a probe that observes it;
* **exact-sum scoring** — a row agrees only when the chip's whole
  ``[n_classes]`` sum vector equals the reference.

The rows are drawn with ``numpy.random.default_rng(seed)`` (the
reference draws from ``jax.random``, so the two packages' rows differ;
both hold the clause-targeting property).  The reference answers come
from ``DigitalState.from_include`` for a replica pool (the ``tm_infer``
kernel through ``digital-cuda`` on the card) and from the overlay-free
``CoalescedState`` for a coalesced one.  Thresholds: quarantine below
0.75, readmit at 0.9 and above; healthy chips sit at 1.0, injured ones
far below.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import api
from repro_torch.core import tm


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Probing and quarantine policy knobs."""

    n_probes: int = 32               # committed probe rows per probe round
    quarantine_threshold: float = 0.75   # agreement below -> quarantine
    readmit_threshold: float = 0.9       # agreement at/above -> readmit
    seed: int = 0                    # probe-row draw + health stream seed

    def __post_init__(self):
        if not 0.0 <= self.quarantine_threshold <= 1.0:
            raise ValueError("quarantine_threshold must be in [0, 1]")
        if self.readmit_threshold < self.quarantine_threshold:
            raise ValueError(
                "readmit_threshold must be >= quarantine_threshold "
                "(the hysteresis band keeps quarantine from flapping)")
        if self.n_probes < 1:
            raise ValueError("need at least one probe row")


@dataclasses.dataclass(frozen=True)
class HealthProbe:
    """A committed probe set: Boolean rows + their known-good answers.

    ``expected`` comes from the clean digital model, so the probe survives
    repairs; engines re-commit on ``install_pool``."""

    x: np.ndarray                    # [n_probes, F] uint8 Boolean rows
    expected: np.ndarray             # [n_probes, M] known-good class sums
    hcfg: HealthConfig

    @property
    def n_probes(self) -> int:
        return int(self.x.shape[0])

    @classmethod
    def commit(cls, pool, tm_cfg, hcfg: HealthConfig = HealthConfig()
               ) -> "HealthProbe":
        """Clause-targeting probe rows and their digital reference class
        sums from ``pool``'s clean model (``pool.clean_reference``: fault
        overlays excluded), computed on the pool's device."""
        ref = pool.clean_reference(tm_cfg)
        include = ref.include.cpu().numpy()
        n_clauses, n_lits = include.shape
        n_feat = n_lits // 2
        # Row i fires clause i % n_clauses in the clean model: positive
        # includes forced 1, negated includes forced 0, the rest random
        # background at a per-row density.
        rng = np.random.default_rng(hcfg.seed)
        density = rng.uniform(0.2, 0.95, (hcfg.n_probes, 1))
        x = (rng.random((hcfg.n_probes, n_feat)) < density).astype(np.uint8)
        for i in range(hcfg.n_probes):
            c = i % n_clauses
            x[i, include[c, :n_feat]] = 1        # positive literals -> 1
            x[i, include[c, n_feat:]] = 0        # negated literals  -> 0
        lits = tm.literals(torch.from_numpy(x).to(pool.device))
        expected = api.class_sums(ref, lits, None).cpu().numpy()
        return cls(x=x, expected=expected, hcfg=hcfg)

    def score(self, sums: np.ndarray) -> float:
        """Agreement of one chip's probe class sums with the reference:
        the fraction of rows whose whole sum vector matches exactly."""
        sums = np.asarray(sums)[:self.n_probes]
        return float((sums == self.expected).all(axis=-1).mean())

    def classify(self, health: Dict[int, float],
                 quarantined: set) -> Dict[int, str]:
        """Map per-replica agreement to actions under the hysteresis band:
        ``quarantine`` (a healthy chip fell below the floor), ``readmit``
        (a quarantined chip recovered past the ceiling), or ``hold``."""
        actions = {}
        for i, h in health.items():
            if i not in quarantined and h < self.hcfg.quarantine_threshold:
                actions[i] = "quarantine"
            elif i in quarantined and h >= self.hcfg.readmit_threshold:
                actions[i] = "readmit"
            else:
                actions[i] = "hold"
        return actions


def probe_replicas(engine, probe: Optional[HealthProbe] = None
                   ) -> Dict[int, float]:
    """Convenience wrapper over ``engine.probe()`` (for callers that hold
    a probe separate from the engine)."""
    return engine.probe(probe)
