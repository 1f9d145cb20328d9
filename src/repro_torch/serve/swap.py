"""Zero-downtime hot swap: snapshot -> canary -> promote / rollback, and
closed-loop repair (port of ``repro.serve.swap``).

  swapper = HotSwapper(engine, ckpt_dir)
  swapper.begin(trained_ta_state, seed)  # snapshot the serving pool,
                                         # program the candidate pool in
                                         # FULL, arm its chip 0 as canary
  ... keep serving: a deterministic share of batches read the canary,
      shadow-read on the stable pool, tallied in ServeMetrics ...
  if swapper.decision() == "promote": swapper.promote()
  else:                               swapper.rollback()

Two invariants:

* **bit-equality on promote** — ``begin`` programs the whole candidate
  pool up front with the generator discipline of
  ``ServeEngine.from_ta_state`` (one generator from ``seed``, split in
  two, the first programs), and ``promote`` installs that pool: it equals
  the pool of a fresh engine built from the same TA state and seed.
* **bit-equality on rollback** — ``begin`` snapshots the serving pool
  through ``distributed/checkpoint.py`` (content digest in the manifest);
  ``rollback`` restores it, digest-checked, onto the engine's device.

``hot_swap`` is the one-call variant (no canary).  ``RepairPolicy``
re-programs the chips a probe quarantined and re-probes them, with its
own generator (seed 17), so repair never moves the serving stream.
Everything here is between-dispatch atomic and drops nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.variations import split_generator
from repro_torch.distributed import checkpoint
from repro_torch.serve.engine import ServeEngine

# Manifest-extra keys for pool snapshots: the checkpoint tree holds only
# the tensors; the version travels in the manifest.
POOL_VERSION_KEY = "pool_version"
POOL_KIND_KEY = "pool_kind"


def snapshot_pool(pool, ckpt_dir: str, *, keep: int = 8) -> str:
    """Save ``pool`` (tensors + version + digest) under ``ckpt_dir``; the
    checkpoint step IS the pool version."""
    return checkpoint.save(
        ckpt_dir, pool.version, pool.leaves(),
        extra={POOL_VERSION_KEY: int(pool.version),
               POOL_KIND_KEY: pool.KIND},
        keep=keep)


def restore_pool(like_pool, ckpt_dir: str, version: int):
    """The pool saved at ``version``, digest-verified, on ``like_pool``'s
    device with ``like_pool``'s static configs.  Snapshots hold only the
    clean model, so the restored pool carries no fault mask."""
    tree, manifest = checkpoint.restore(ckpt_dir, version,
                                        like_pool.leaves(),
                                        device=like_pool.device)
    extra = manifest.get("extra", {})
    return like_pool.from_leaves(
        tree, int(extra.get(POOL_VERSION_KEY, version)))


def reprogrammed_pool(engine: ServeEngine, ta_state: torch.Tensor,
                      seed: int = 0, *,
                      weights: Optional[torch.Tensor] = None):
    """The engine's pool re-programmed from freshly trained ``ta_state``.

    The pool programs with the first of ``split_generator`` of a
    generator seeded ``seed``, exactly as ``ServeEngine.from_ta_state``
    does, so a replica pool is bit-equal to a fresh engine's pool.  A
    coalesced pool re-programs from ``(ta_state, weights)`` and draws
    nothing."""
    gen = torch.Generator(device=engine.device).manual_seed(int(seed))
    g_prog, _ = split_generator(gen, 2)
    return engine.pool.reprogrammed(ta_state, g_prog, engine.tm_cfg,
                                    weights=weights)


def hot_swap(engine: ServeEngine, ta_state: torch.Tensor, seed: int = 0,
             *, weights: Optional[torch.Tensor] = None,
             ckpt_dir: Optional[str] = None) -> int:
    """One-call swap (no canary): optionally snapshot the serving pool,
    re-program from ``ta_state``, install atomically.  Returns the new
    pool version."""
    if ckpt_dir is not None:
        snapshot_pool(engine.pool, ckpt_dir)
    pool = reprogrammed_pool(engine, ta_state, seed, weights=weights)
    engine.install_pool(pool, kind="swap")
    return engine.version


@dataclasses.dataclass(frozen=True)
class SwapConfig:
    """Canary rollout policy."""

    canary_fraction: float = 0.25   # share of live batches the canary
                                    # serves while armed
    min_canary_rows: int = 64       # evidence floor before a decision
    min_agreement: float = 0.9      # promote iff canary-vs-stable argmax
                                    # agreement >= this
    keep_snapshots: int = 8         # checkpoint GC depth (rollback window)

    def __post_init__(self):
        if not (0.0 < self.canary_fraction <= 1.0):
            raise ValueError(f"canary_fraction must be in (0, 1], got "
                             f"{self.canary_fraction}")
        if not (0.0 <= self.min_agreement <= 1.0):
            raise ValueError(f"min_agreement must be in [0, 1], got "
                             f"{self.min_agreement}")
        if self.min_canary_rows < 1:
            raise ValueError(f"min_canary_rows must be >= 1, got "
                             f"{self.min_canary_rows}")


class HotSwapper:
    """Snapshot -> canary -> promote / rollback over one live engine.

    One rollout at a time.  The swapper reads engine metrics and calls
    the engine's public swap surface only, so it composes with the sync
    and the async engine unchanged."""

    def __init__(self, engine: ServeEngine, ckpt_dir: str,
                 scfg: SwapConfig = SwapConfig()):
        self.engine = engine
        self.ckpt_dir = ckpt_dir
        self.scfg = scfg
        self.candidate = None           # pre-built candidate pool
        self._snapshot_version: Optional[int] = None
        self._rows0 = 0                 # canary tallies at begin(), so
        self._agree0 = 0                # agreement scores THIS rollout

    @property
    def active(self) -> bool:
        return self.candidate is not None

    def begin(self, ta_state: torch.Tensor, seed: int = 0, *,
              weights: Optional[torch.Tensor] = None) -> int:
        """Snapshot the serving pool, program the full candidate pool, arm
        its first route as the canary.  Returns the candidate version."""
        if self.active:
            raise RuntimeError(
                "a canary rollout is already active (candidate version "
                f"{self.candidate.version}); promote or rollback first")
        snapshot_pool(self.engine.pool, self.ckpt_dir,
                      keep=self.scfg.keep_snapshots)
        self._snapshot_version = self.engine.pool.version
        self.candidate = reprogrammed_pool(self.engine, ta_state, seed,
                                           weights=weights)
        # The canary chip is a route of the pre-built candidate, so
        # promote() installing that same pool is what makes
        # promoted == freshly programmed structural.
        state = self.candidate.state(self.engine.tm_cfg)
        m = self.engine.metrics
        self._rows0, self._agree0 = m.canary_rows, m.canary_agree_rows
        self.engine.arm_canary(self.candidate.routes(state)[0],
                               self.candidate.version,
                               self.scfg.canary_fraction)
        return self.candidate.version

    # ------------------------------------------------------------ evidence

    def rows(self) -> int:
        return self.engine.metrics.canary_rows - self._rows0

    def agreement(self) -> Optional[float]:
        rows = self.rows()
        if not rows:
            return None
        agree = self.engine.metrics.canary_agree_rows - self._agree0
        return agree / rows

    def status(self) -> dict:
        return {"active": self.active,
                "candidate_version": (self.candidate.version
                                      if self.active else None),
                "stable_version": self.engine.version,
                "rows": self.rows(),
                "agreement": self.agreement(),
                "decision": self.decision()}

    def decision(self) -> str:
        """``"wait"`` until ``min_canary_rows`` of evidence, then
        ``"promote"`` or ``"rollback"`` by the agreement threshold."""
        if not self.active:
            return "idle"
        if self.rows() < self.scfg.min_canary_rows:
            return "wait"
        agreement = self.agreement()
        return ("promote" if agreement >= self.scfg.min_agreement
                else "rollback")

    # ------------------------------------------------------------- settle

    def promote(self) -> int:
        """Install the pre-built candidate pool; returns its version."""
        if not self.active:
            raise RuntimeError("no active rollout to promote")
        pool, self.candidate = self.candidate, None
        self.engine.install_pool(pool, kind="promote")
        return self.engine.version

    def rollback(self) -> int:
        """Restore the pre-swap pool bit for bit from its digest-verified
        snapshot and re-install it; returns its version."""
        if not self.active:
            raise RuntimeError("no active rollout to roll back")
        self.candidate = None
        self.engine.disarm_canary()
        pool = restore_pool(self.engine.pool, self.ckpt_dir,
                            self._snapshot_version)
        self.engine.install_pool(pool, kind="rollback")
        return self.engine.version


# --------------------------------------------------------------- auto-repair


@dataclasses.dataclass(frozen=True)
class RepairConfig:
    """Auto-repair policy knobs."""

    max_attempts: int = 2       # re-program + re-probe tries per chip

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")


class RepairPolicy:
    """Closed-loop self-healing over one live engine.

    When ``probe`` quarantines a chip (or the last-healthy floor holds a
    broken one), :meth:`repair` re-programs exactly that chip
    (``pool.repair_replica``: fresh D2D draws clear the fault overlay;
    model and version stay), installs the pool through ``install_pool``
    (kind ``"repair"``), re-probes, and lets the readmit threshold return
    the chip to rotation.  Repair draws come from the policy's own
    generator, split once per repair, so healing never moves the serving
    noise stream."""

    def __init__(self, engine: ServeEngine,
                 rcfg: RepairConfig = RepairConfig(), *,
                 generator: Optional[torch.Generator] = None):
        self.engine = engine
        self.rcfg = rcfg
        self._generator = (generator if generator is not None else
                           torch.Generator(device=engine.device)
                           .manual_seed(17))
        self.events: list = []          # audit trail of repair outcomes

    def _next_generator(self) -> torch.Generator:
        self._generator, g = split_generator(self._generator, 2)
        return g

    def repair(self, health: Optional[dict] = None) -> dict:
        """Repair every chip that needs it; returns per-chip outcomes
        (``{replica: {"attempts", "readmitted", "health"}}``).

        Targets are the quarantined chips plus, given the latest
        ``health`` scores, any chip below the quarantine threshold that
        the last-healthy floor kept in rotation."""
        targets = set(self.engine.quarantined)
        if health is not None and self.engine.health is not None:
            floor = self.engine.health.hcfg.quarantine_threshold
            targets |= {i for i, h in health.items() if h < floor}
        return {i: self._repair_one(i) for i in sorted(targets)}

    def _repair_one(self, i: int) -> dict:
        hcfg = self.engine.health.hcfg if self.engine.health else None
        health = None
        for attempt in range(1, self.rcfg.max_attempts + 1):
            pool = self.engine.pool.repair_replica(i, self._next_generator())
            self.engine.install_pool(pool, kind="repair")
            health = self.engine.probe()
            # Healed = back above the readmit ceiling AND out of
            # quarantine (a floor-held chip was never in it).
            if i not in self.engine.quarantined and (
                    hcfg is None or health.get(i, 0.0)
                    >= hcfg.readmit_threshold):
                break
        out = {"replica": int(i), "attempts": attempt,
               "readmitted": i not in self.engine.quarantined,
               "health": None if health is None else health.get(i)}
        self.events.append(out)
        return out

    def check(self) -> dict:
        """One self-healing tick: probe all chips, then repair whatever
        the probe found unhealthy (quarantined or floor-held)."""
        health = self.engine.probe()
        repairs = self.repair(health)
        return {"health": health, "repairs": repairs}
