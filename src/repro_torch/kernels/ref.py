"""Pure float32 PyTorch oracles for the kernels (port of
``repro.kernels.ref``).

Each function is the mathematical specification the kernels are held to:
no tiling, no packing, no padding tricks — the definition, as
``torch.einsum`` and ``@`` in float32.  The kernels' plain versions
(``<name>_ref`` in ``kernels/imbue_infer.py`` and
``kernels/clause_eval.py``) take the kernels' own operand layouts; these
take the reference's (complemented literals, drive voltages, float
planes), so the two are independent ways to the same sums.
"""

from __future__ import annotations

import torch


def clause_eval_ref(lit0: torch.Tensor, include: torch.Tensor) -> torch.Tensor:
    """Digital clause evaluation.

    ``lit0 [B, L]`` in {0, 1}: complemented literals (1 = literal is 0).
    ``include [C, L]`` in {0, 1}: TA include actions.
    Returns ``[B, C]`` float32 in {0, 1}: 1 iff no included literal is 0.
    """
    viol = lit0.to(torch.float32) @ include.to(torch.float32).T
    return (viol == 0).to(torch.float32)


def imbue_column_currents_ref(v_drive: torch.Tensor, lit1: torch.Tensor,
                              g_on: torch.Tensor, i_leak: torch.Tensor,
                              width: int) -> torch.Tensor:
    """Per-column KCL currents ``[B, C, K]``, ``K = L / width`` columns.

    ``v_drive [B, L]`` literal drive voltages (V; ``lit0 * v_read``),
    ``lit1 [B, L]`` the literal-is-1 mask, ``g_on [C, L]`` on-path
    conductance (S), ``i_leak [C, L]`` leak current at literal '1' (A).
    """
    b, l = v_drive.shape
    c = g_on.shape[0]
    k = l // width
    vf = v_drive.to(torch.float32).reshape(b, k, width)
    l1 = lit1.to(torch.float32).reshape(b, k, width)
    gf = g_on.to(torch.float32).reshape(c, k, width)
    lf = i_leak.to(torch.float32).reshape(c, k, width)
    on = torch.einsum("bkw,ckw->bck", vf, gf)
    leak = torch.einsum("bkw,ckw->bck", l1, lf)
    return on + leak


def imbue_clauses_ref(v_drive, lit1, g_on, i_leak, width, r_div, v_ref):
    """Analog clause outputs ``[B, C]``: CSA per column, AND across
    columns."""
    i_col = imbue_column_currents_ref(v_drive, lit1, g_on, i_leak, width)
    partial = i_col * r_div < v_ref
    return partial.all(dim=-1).to(torch.float32)


def class_sums_ref(clauses: torch.Tensor,
                   pol_matrix: torch.Tensor) -> torch.Tensor:
    """Polarity-weighted class sums: ``[B, C] x [C, M] -> [B, M]``."""
    return clauses.to(torch.float32) @ pol_matrix.to(torch.float32)


def imbue_infer_ref(v_drive, lit1, g_on, i_leak, pol_matrix, width, r_div,
                    v_ref):
    """Fused analog inference: literals -> class sums ``[B, M]``."""
    cls = imbue_clauses_ref(v_drive, lit1, g_on, i_leak, width, r_div, v_ref)
    return class_sums_ref(cls, pol_matrix)


def tm_infer_ref(lit0: torch.Tensor, include: torch.Tensor,
                 pol_matrix: torch.Tensor) -> torch.Tensor:
    """Fused digital inference: literals -> class sums ``[B, M]``."""
    return class_sums_ref(clause_eval_ref(lit0, include), pol_matrix)
