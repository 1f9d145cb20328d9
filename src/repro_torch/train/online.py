"""Incremental TM trainer: labeled frames in, versioned TA states out (port
of ``repro.train.online``).

  trainer.ingest(x, y)   -> bounded replay buffer (newest-wins: an
                            always-on feed must not grow host memory)
  trainer.refit()        -> a few shuffled epochs of ``core.tm_train.fit``
                            over the buffer (batch-parallel
                            ``train_step_batch`` by default, one
                            ``clause_eval_packed`` launch per step),
                            starting WARM from the last trained state
                         -> a :class:`TrainedVersion`: monotonic version
                            number + TA state + training evidence

``TrainedVersion.ta_state`` is what a serving pool is programmed from
(``ServeEngine.from_ta_state``); the trainer never touches an engine.
Randomness comes from one trainer-owned generator, drawn in order, so a
fixed seed plus a fixed ingest trace reproduces every emitted state bit
for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import tm, tm_train
from repro_torch.core.tm import TMConfig


@dataclasses.dataclass(frozen=True)
class OnlineTrainerConfig:
    """Re-fit policy knobs."""

    epochs: int = 3           # shuffled epochs per refit (warm start makes
                              # a few enough)
    batch_size: int = 200     # examples per train step (clamped to buffer)
    parallel: bool = True     # train_step_batch (fast) vs train_step (exact
                              # sequential semantics)
    buffer_cap: int = 65536   # replay-buffer rows retained (newest win)
    min_examples: int = 8     # refuse to refit on fewer buffered rows

    def __post_init__(self):
        if self.epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {self.epochs}")
        if self.buffer_cap < 1:
            raise ValueError(
                f"buffer_cap must be >= 1, got {self.buffer_cap}")
        if self.min_examples < 1:
            raise ValueError(
                f"min_examples must be >= 1, got {self.min_examples}")


@dataclasses.dataclass(frozen=True)
class TrainedVersion:
    """One emitted model: the hand-off unit trainer -> serving."""

    version: int              # trainer-monotonic (1, 2, ...)
    ta_state: torch.Tensor    # [C, L] trained TA states
    n_examples: int           # buffered rows this refit trained on
    epochs: int               # epochs run
    accuracy: float           # train accuracy on the buffer (evidence,
                              # not a holdout)


class OnlineTrainer:
    """Replay-buffer re-fit loop emitting versioned TA states.

    >>> gen = torch.Generator(device="cuda").manual_seed(0)
    >>> trainer = OnlineTrainer(cfg, gen)                  # cold start, or
    >>> trainer = OnlineTrainer(cfg, gen, init_state=ta)   # warm start
    >>> trainer.ingest(x_frames, y_labels)
    >>> tv = trainer.refit()                               # version 1

    Training runs on ``device`` (default ``cuda``), where ``generator``
    must live.
    """

    def __init__(self, tm_cfg: TMConfig, generator: torch.Generator, *,
                 init_state: Optional[torch.Tensor] = None,
                 cfg: OnlineTrainerConfig = OnlineTrainerConfig(),
                 device: DeviceLike = None):
        self.tm_cfg = tm_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self._gen = generator
        self.ta_state = (torch.as_tensor(init_state).to(self.device)
                         if init_state is not None
                         else tm.init_ta_state(generator, tm_cfg,
                                               self.device))
        self.version = 0          # last emitted TrainedVersion number
        self._x: List[np.ndarray] = []     # buffered chunks (concatenated
        self._y: List[np.ndarray] = []     # lazily at refit)
        self._n = 0

    # --------------------------------------------------------------- intake

    @property
    def n_buffered(self) -> int:
        return self._n

    def ingest(self, x, y) -> int:
        """Buffer labeled examples (``[B, F]`` Boolean features, ``[B]``
        int labels); returns the buffered-row count after eviction."""
        x = np.asarray(x, dtype=np.uint8)
        y = np.asarray(y, dtype=np.int64)
        if x.ndim != 2 or y.ndim != 1 or x.shape[0] != y.shape[0]:
            raise ValueError(
                f"ingest expects x [B, F] with y [B], got {x.shape} "
                f"and {y.shape}")
        self._x.append(x)
        self._y.append(y)
        self._n += x.shape[0]
        # Newest-wins eviction: drop whole oldest chunks, then trim the
        # boundary chunk, so the buffer never exceeds cap.
        while self._n > self.cfg.buffer_cap:
            over = self._n - self.cfg.buffer_cap
            head = self._x[0].shape[0]
            if head <= over:
                self._x.pop(0)
                self._y.pop(0)
                self._n -= head
            else:
                self._x[0] = self._x[0][over:]
                self._y[0] = self._y[0][over:]
                self._n -= over
        return self._n

    def buffer(self) -> Tuple[np.ndarray, np.ndarray]:
        """The current replay buffer as two arrays (oldest first)."""
        if not self._x:
            return np.zeros((0, 0), np.uint8), np.zeros((0,), np.int64)
        if len(self._x) > 1:     # compact so repeated refits don't re-cat
            self._x = [np.concatenate(self._x)]
            self._y = [np.concatenate(self._y)]
        return self._x[0], self._y[0]

    # ---------------------------------------------------------------- refit

    def refit(self) -> TrainedVersion:
        """Re-fit on the buffer, warm from the last state; emit the next
        :class:`TrainedVersion`.  Raises if the buffer holds fewer than
        ``cfg.min_examples`` rows — an empty-buffer refit would emit the
        old model under a new version number."""
        if self._n < self.cfg.min_examples:
            raise ValueError(
                f"refit needs >= {self.cfg.min_examples} buffered "
                f"examples, have {self._n}")
        x_np, y_np = self.buffer()
        x = torch.from_numpy(x_np).to(self.device)
        y = torch.from_numpy(y_np).to(self.device)
        self.ta_state = tm_train.fit(
            self.ta_state, self._gen, x, y, self.tm_cfg,
            epochs=self.cfg.epochs, batch_size=self.cfg.batch_size,
            parallel=self.cfg.parallel)
        self.version += 1
        acc = float(tm.accuracy(self.ta_state, x, y, self.tm_cfg))
        return TrainedVersion(version=self.version,
                              ta_state=self.ta_state,
                              n_examples=int(self._n),
                              epochs=int(self.cfg.epochs),
                              accuracy=acc)
