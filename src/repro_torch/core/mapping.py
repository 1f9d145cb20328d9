"""TM -> crossbar mapping (port of ``repro.core.mapping``; paper Fig. 2).

A clause of L literals is split into partial clauses of at most ``W = 32``
TA cells per crossbar column; the clause is the AND of its column
outputs.  ``csa_count_packed`` is Table IV's packed CSA count.
"""

from __future__ import annotations

import dataclasses
import math

import torch

PARTIAL_CLAUSE_WIDTH = 32   # W, TA cells per crossbar column (paper §III)


@dataclasses.dataclass(frozen=True)
class CrossbarMapping:
    """Static mapping facts for a TM of C clauses x L literals."""

    n_clauses: int
    n_literals: int
    width: int = PARTIAL_CLAUSE_WIDTH

    @property
    def columns_per_clause(self) -> int:
        return math.ceil(self.n_literals / self.width)

    @property
    def n_columns(self) -> int:
        """Architectural column (CSA) count."""
        return self.n_clauses * self.columns_per_clause

    @property
    def n_cells(self) -> int:
        return self.n_clauses * self.n_literals

    @property
    def n_columns_packed(self) -> int:
        """Packed CSA count used by Table IV."""
        return math.ceil(self.n_cells / self.width)

    @property
    def padded_literals(self) -> int:
        return self.columns_per_clause * self.width


def csa_count_packed(ta_cells: int, width: int = PARTIAL_CLAUSE_WIDTH) -> int:
    return math.ceil(ta_cells / width)


def pad_to_columns(x: torch.Tensor, mapping: CrossbarMapping,
                   fill_value=0) -> torch.Tensor:
    """Pad the literal axis (last) to a multiple of W and fold it into
    ``[..., columns_per_clause, W]``.  Padding cells behave like excluded
    TAs driven by literal 1 (no current)."""
    pad = mapping.padded_literals - x.shape[-1]
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=fill_value)
    return x.reshape(*x.shape[:-1], mapping.columns_per_clause, mapping.width)
