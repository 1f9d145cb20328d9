"""Coalesced Tsetlin Machine inference in PyTorch (port of the inference
half of ``repro.core.coalesced``; Glimsdal & Granmo 2021,
arXiv:2108.07594).

ONE pool of clauses is shared by all classes, and each (clause, class)
pair carries an integer weight: ``sums = clauses @ W``.  The crossbar
half is the digital TM's (same include plane, same violation count);
only the tail swaps the +-1 polarity counters for weighted counters, so
the fused kernels take W as their ``[C, M]`` combine matrix.

Training (``init_coalesced``, the feedback rules, ``train_step_batch``,
``fit``) comes with a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tm import clause_outputs_from_include, literals


@dataclasses.dataclass(frozen=True)
class CoalescedConfig:
    n_classes: int
    n_clauses: int              # TOTAL shared clause pool
    n_features: int
    n_states: int = 127
    threshold: int = 15
    specificity: float = 3.9
    max_weight: int = 127
    state_dtype: torch.dtype = torch.int16

    def __post_init__(self):
        # Fail at construction, not deep inside a kernel with an opaque
        # shape/overflow error.
        if self.n_classes < 2:
            raise ValueError(
                f"n_classes must be >= 2 (got {self.n_classes}): a "
                "coalesced pool shares clauses BETWEEN classes")
        if self.n_clauses < 1 or self.n_features < 1:
            raise ValueError(
                f"n_clauses={self.n_clauses} and n_features="
                f"{self.n_features} must both be >= 1")
        if self.max_weight < 1:
            raise ValueError(f"max_weight must be >= 1, got "
                             f"{self.max_weight}")
        info = torch.iinfo(self.state_dtype)
        name = str(self.state_dtype).removeprefix("torch.")
        if self.max_weight > info.max:
            raise ValueError(
                f"max_weight={self.max_weight} does not fit state_dtype="
                f"{name} (max {info.max}); weight clipping would silently "
                "wrap")
        if 2 * self.n_states + 1 > info.max:
            raise ValueError(
                f"TA states span 1..{2 * self.n_states}, which does not "
                f"fit state_dtype={name} (max {info.max})")

    @property
    def n_literals(self) -> int:
        return 2 * self.n_features

    @property
    def n_ta(self) -> int:
        return self.n_clauses * self.n_literals


def clause_outputs(ta_state: torch.Tensor, lits: torch.Tensor,
                   cfg: CoalescedConfig, *,
                   training: bool = False) -> torch.Tensor:
    """``uint8 [B, C]``: a clause fires iff none of its included literals
    is 0; empty clauses fire in training and not at inference."""
    return clause_outputs_from_include(ta_state > cfg.n_states, lits,
                                       training=training)


def class_sums(clauses: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``[B, C]`` 0/1 clauses x ``[C, M]`` integer weights -> ``[B, M]``
    int32.  The product runs in float64, exact for these integers."""
    return (clauses.to(torch.float64)
            @ weights.to(torch.float64)).to(torch.int32)


def forward(ta_state: torch.Tensor, weights: torch.Tensor, x: torch.Tensor,
            cfg: CoalescedConfig) -> torch.Tensor:
    """Class sums for raw Boolean features ``x [B, F]`` -> ``[B, M]``."""
    return class_sums(clause_outputs(ta_state, literals(x), cfg), weights)


def predict(ta_state: torch.Tensor, weights: torch.Tensor, x: torch.Tensor,
            cfg: CoalescedConfig) -> torch.Tensor:
    """Argmax classification ``[B, F] -> [B]`` (ties to the lowest
    class)."""
    return torch.argmax(forward(ta_state, weights, x, cfg), dim=-1)


def accuracy(ta_state: torch.Tensor, weights: torch.Tensor, x: torch.Tensor,
             y: torch.Tensor, cfg: CoalescedConfig) -> torch.Tensor:
    return (predict(ta_state, weights, x, cfg) == y).to(torch.float32).mean()
