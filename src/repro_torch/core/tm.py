"""Tsetlin Machine inference in PyTorch (port of ``repro.core.tm``).

The digital TM: literals, include actions, clause outputs,
polarity-weighted class sums, ``forward`` and ``predict`` — the bit-exact
Boolean-domain reference that every analog path of the port must
reproduce at nominal — plus what training starts and reports from:
``init_ta_state``, ``accuracy`` and ``include_stats``.  The feedback
rules are in ``core.tm_train``.

Shape conventions: ``B`` batch, ``F`` features, ``L = 2F`` literals,
``M`` classes, ``J`` clauses per class, ``C = M*J`` clauses.  TA state is
an integer tensor ``[C, L]`` in ``[1, 2N]``; include iff ``state > N``.
Clause ``c`` has polarity ``+1`` for even ``c`` and ``-1`` for odd ``c``
within its class.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class TMConfig:
    """Hyper-parameters of a (multi-class) Tsetlin Machine."""

    n_classes: int
    clauses_per_class: int          # J; must be even (half +, half - polarity)
    n_features: int                 # F booleanized input features
    n_states: int = 127             # N; TA states span [1, 2N]
    threshold: int = 15             # T; vote clamp used by training feedback
    specificity: float = 3.9        # s; Type-I feedback sharpness
    state_dtype: torch.dtype = torch.int16

    @property
    def n_literals(self) -> int:
        return 2 * self.n_features

    @property
    def n_clauses(self) -> int:
        return self.n_classes * self.clauses_per_class

    @property
    def n_ta(self) -> int:
        return self.n_clauses * self.n_literals

    def __post_init__(self):
        if self.clauses_per_class % 2 != 0:
            raise ValueError("clauses_per_class must be even (polarity pairs)")
        if self.n_states < 1:
            raise ValueError("n_states must be >= 1")


def init_ta_state(generator: torch.Generator, cfg: TMConfig,
                  device: DeviceLike = None) -> torch.Tensor:
    """Random init on the include/exclude boundary: each state is ``N`` or
    ``N + 1`` with probability 1/2, drawn from ``generator`` (which must
    live on ``device``)."""
    u = torch.rand((cfg.n_clauses, cfg.n_literals), generator=generator,
                   device=resolve_device(device)) < 0.5
    return (cfg.n_states + u.to(cfg.state_dtype)).to(cfg.state_dtype)


def literals(x: torch.Tensor) -> torch.Tensor:
    """``[B, F] -> [B, 2F]`` uint8: features followed by their complements."""
    x = x.to(torch.uint8)
    return torch.cat([x, 1 - x], dim=-1)


def include_mask(ta_state: torch.Tensor, cfg: TMConfig) -> torch.Tensor:
    """TA action: include iff state is in the upper half ``(N, 2N]``."""
    return ta_state > cfg.n_states


def polarity(cfg: TMConfig, device=None) -> torch.Tensor:
    """``[C]`` int32 vector of +1/-1 clause polarities, interleaved per
    class."""
    j = torch.arange(cfg.clauses_per_class, device=device)
    pol = torch.where(j % 2 == 0, 1, -1).to(torch.int32)
    return pol.repeat(cfg.n_classes)


def clause_outputs_from_include(include: torch.Tensor, lits: torch.Tensor, *,
                                training: bool = False) -> torch.Tensor:
    """Clause outputs ``uint8 [B, C]`` from a bool include mask.

    A clause fires iff no included literal is 0: the violation count
    ``(1 - lits) @ include.T`` is zero.  The product runs in float32,
    which is exact for 0/1 operands up to 2**24 literals.  Empty clauses
    output 1 during training and 0 at inference.
    """
    lit0 = (1 - lits.to(torch.float32))
    viol = lit0 @ include.to(torch.float32).T          # [B, C]
    fired = viol == 0
    if not training:
        fired = fired & include.any(dim=-1)[None, :]
    return fired.to(torch.uint8)


def clause_outputs(ta_state: torch.Tensor, lits: torch.Tensor, cfg: TMConfig,
                   *, training: bool = False) -> torch.Tensor:
    """Every clause on every datapoint (see
    :func:`clause_outputs_from_include`)."""
    return clause_outputs_from_include(include_mask(ta_state, cfg), lits,
                                       training=training)


def class_sums(clauses: torch.Tensor, cfg: TMConfig) -> torch.Tensor:
    """Polarity-weighted vote totals per class: ``[..., C] -> [..., M]``
    int32."""
    votes = clauses.to(torch.int32) * polarity(cfg, clauses.device)
    return votes.reshape(*clauses.shape[:-1], cfg.n_classes,
                         cfg.clauses_per_class).sum(dim=-1, dtype=torch.int32)


def forward(ta_state: torch.Tensor, x: torch.Tensor,
            cfg: TMConfig) -> torch.Tensor:
    """Class sums for raw Boolean features ``x [B, F]`` -> ``[B, M]``."""
    return class_sums(clause_outputs(ta_state, literals(x), cfg), cfg)


def predict(ta_state: torch.Tensor, x: torch.Tensor,
            cfg: TMConfig) -> torch.Tensor:
    """Argmax classification ``[B, F] -> [B]`` (ties to the lowest
    class)."""
    return torch.argmax(forward(ta_state, x, cfg), dim=-1)


def accuracy(ta_state: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             cfg: TMConfig) -> torch.Tensor:
    """Share of rows of ``x`` whose prediction is ``y`` (float32)."""
    return (predict(ta_state, x, cfg) == y).to(torch.float32).mean()


def include_stats(ta_state: torch.Tensor, cfg: TMConfig) -> dict:
    """Model statistics used throughout the paper's evaluation (Table IV)."""
    n_inc = int(include_mask(ta_state, cfg).sum())
    return {
        "ta_cells": cfg.n_ta,
        "includes": n_inc,
        "include_pct": 100.0 * n_inc / cfg.n_ta,
        "clauses": cfg.n_clauses,
        "classes": cfg.n_classes,
    }
