"""The analog IMBUE kernels: wrappers, plain versions and launch counters
(port of ``repro.kernels.imbue_infer``).

All three compute analog class sums ``[R, B, M]`` int32, R a grid axis of
the kernel (one launch per replica stack):

* ``imbue_infer_planes(litw, incw, dev, pol, scal)`` — packed literals and
  a plane-packed stack; the kernel rebuilds g and leak per column
  (``imbue_infer_planes_kernel``, ``csrc/imbue_infer_planes.cu``);
* ``imbue_infer_packed(litw, g, leak, pol, i_ref, v_read)`` — packed
  literals and dense float32 ``g`` / ``leak`` planes
  (``imbue_infer_packed_kernel``, ``csrc/imbue_infer_packed.cu``);
* ``imbue_infer(lits, g, leak, pol, i_ref, v_read)`` — the same from one
  byte a literal (``imbue_infer_kernel``, ``csrc/imbue_infer.cu``).

All three run ``csrc/imbue_core.cuh`` (the arithmetic, the bound and the
design); ``imbue_infer_packed`` and ``imbue_infer`` also share its
``DenseCells`` (the g / leak staging).  The dense-plane kernels'
operands, in the states' own layouts: ``litw [B, ceil(L/32)]`` int32
words or ``lits [B, L]`` uint8, ``g`` and ``leak [R, C, L]`` float32,
``pol [C, M]`` int32, and ``i_ref = v_ref / r_divider`` and ``v_read``
as float32 values.

``imbue_infer_planes`` takes:

* ``litw``  ``[B, Lw]`` int32 literal words;
* ``incw``  ``[C, Lw]`` int32 include-index words (the state's
  ``plane_index``, in the state's own layout — nothing is transposed
  per dispatch);
* ``dev``   ``[R, C, L]`` float32 deviation plane (``L = scal.l_valid``),
  or None for a nominal stack, which gives ``R = 1``;
* ``pol``   ``[C, M]`` int32 signed one-hot polarity x nonempty mask;
* ``scal``  the electrical scalars, each rounded to float32 once on the
  host, as the reference does.

On CPU tensors a wrapper computes with its plain PyTorch version (same
signature, ``<name>_ref``).  On CUDA tensors it launches its hand-written
kernel or raises — there is no fallback.  ``<wrapper>.launches`` counts
kernel launches, nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitpack import WORD, unpack_bits, words_for

KERNEL = "imbue_infer_planes"
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_float] * 7 + [ctypes.c_void_p])
# <name>_launch(lits, g, leak, pol, out, R, B, L, C, M, i_ref, v_read,
# stream) for both dense-plane kernels.
_DENSE_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class PlaneScalars:
    """The kernel's scalar operands, each a float32 value (computed in
    double on the host and rounded once)."""

    i_ref: float           # v_ref / r_divider
    v_read: float
    r_lrs: float
    r_hrs: float
    leak_inc: float
    leak_exc: float
    series_factor: float
    l_valid: int           # true literal count (word padding beyond)

    @classmethod
    def make(cls, *, v_ref, r_div, v_read, r_lrs, r_hrs, leak_inc, leak_exc,
             series_factor, l_valid) -> "PlaneScalars":
        return cls(i_ref=_f32(v_ref / r_div), v_read=_f32(v_read),
                   r_lrs=_f32(r_lrs), r_hrs=_f32(r_hrs),
                   leak_inc=_f32(leak_inc), leak_exc=_f32(leak_exc),
                   series_factor=_f32(series_factor), l_valid=int(l_valid))


def _check(litw, incw, dev, pol, scal: PlaneScalars) -> None:
    if litw.dtype != torch.int32 or litw.ndim != 2:
        raise ValueError(f"litw must be [B, Lw] int32, got "
                         f"{tuple(litw.shape)} {litw.dtype}")
    b, lw = litw.shape
    if incw.dtype != torch.int32 or incw.ndim != 2 or incw.shape[1] != lw:
        raise ValueError(f"incw must be [C, {lw}] int32, got "
                         f"{tuple(incw.shape)} {incw.dtype}")
    c = incw.shape[0]
    if not (WORD * (lw - 1) < scal.l_valid <= WORD * lw):
        raise ValueError(f"l_valid={scal.l_valid} does not fit {lw} words")
    if pol.dtype != torch.int32 or pol.ndim != 2 or pol.shape[0] != c:
        raise ValueError(f"pol must be [{c}, M] int32, got "
                         f"{tuple(pol.shape)} {pol.dtype}")
    tensors = [litw, incw, pol]
    if dev is not None:
        if (dev.dtype != torch.float32 or dev.ndim != 3
                or tuple(dev.shape[1:]) != (c, scal.l_valid)):
            raise ValueError(f"dev must be [R, {c}, {scal.l_valid}] float32, "
                             f"got {tuple(dev.shape)} {dev.dtype}")
        tensors.append(dev)
    if any(t.device != litw.device for t in tensors):
        raise ValueError("imbue_infer_planes operands are on different "
                         f"devices: {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("imbue_infer_planes operands must be contiguous")


def imbue_infer_planes_ref(litw: torch.Tensor, incw: torch.Tensor,
                           dev: Optional[torch.Tensor], pol: torch.Tensor,
                           scal: PlaneScalars) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same signature, same float32
    reconstruction op order; column sums via einsum)."""
    lp = litw.shape[1] * WORD
    bits_inc = unpack_bits(incw, lp).to(torch.bool)             # [C, Lp]
    r_nom = torch.where(bits_inc, scal.r_lrs, scal.r_hrs).to(torch.float32)
    if dev is None:
        r = r_nom[None]
    else:
        r = r_nom + torch.nn.functional.pad(dev, (0, lp - scal.l_valid))
    valid = torch.arange(lp, device=litw.device) < scal.l_valid
    g = torch.where(valid, 1.0 / (scal.series_factor * r), 0.0)
    leak_nom = torch.where(bits_inc, scal.leak_inc,
                           scal.leak_exc).to(torch.float32)
    leak = torch.where(valid, leak_nom * (r_nom / r), 0.0)     # [R, C, Lp]
    lits = unpack_bits(litw, lp).to(torch.float32)              # [B, Lp]
    return _class_sums_ref(lits, g, leak, pol, scal.i_ref, scal.v_read)


def _class_sums_ref(lits: torch.Tensor, g: torch.Tensor, leak: torch.Tensor,
                    pol: torch.Tensor, i_ref: float,
                    v_read: float) -> torch.Tensor:
    """The plain versions' shared tail: 0/1 float literals ``[B, Lp]``
    and cell planes ``[R, C, Lp]`` (``Lp`` a multiple of 32, zero past the
    real literals) -> column currents as two einsums -> CSA compare ->
    AND over columns -> ``[R, B, M]`` int32 class sums."""
    b, lp = lits.shape
    rr, c, _ = g.shape
    lw = lp // WORD
    v_drive = (1.0 - lits) * v_read
    i_on = torch.einsum("bkw,rckw->rbck", v_drive.view(b, lw, WORD),
                        g.reshape(rr, c, lw, WORD))
    i_leak = torch.einsum("bkw,rckw->rbck", lits.view(b, lw, WORD),
                          leak.reshape(rr, c, lw, WORD))
    clause = ((i_on + i_leak) < i_ref).all(dim=-1)              # [R, B, C]
    # 0/1 clauses x {-1, 0, 1} polarity: exact integers in float32.
    return (clause.to(torch.float32) @ pol.to(torch.float32)).to(torch.int32)


def imbue_infer_planes(litw: torch.Tensor, incw: torch.Tensor,
                       dev: Optional[torch.Tensor], pol: torch.Tensor,
                       scal: PlaneScalars) -> torch.Tensor:
    """``[R, B, M]`` int32 class sums (R = 1 when ``dev`` is None)."""
    _check(litw, incw, dev, pol, scal)
    if litw.device.type == "cpu":
        return imbue_infer_planes_ref(litw, incw, dev, pol, scal)
    if litw.device.type != "cuda":
        raise ValueError(f"imbue_infer_planes runs on cuda or cpu tensors, "
                         f"not {litw.device}")
    b, lw = litw.shape
    c, m = pol.shape
    r = 1 if dev is None else dev.shape[0]
    out = torch.zeros((r, b, m), dtype=torch.int32, device=litw.device)
    if b == 0 or c == 0 or m == 0 or r == 0:
        return out
    launch = _build.load(KERNEL, _ARGTYPES)
    with torch.cuda.device(litw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(litw.data_ptr(), incw.data_ptr(),
                     None if dev is None else dev.data_ptr(),
                     pol.data_ptr(), out.data_ptr(), r, b, lw, c, m,
                     scal.l_valid, scal.i_ref, scal.v_read, scal.r_lrs,
                     scal.r_hrs, scal.leak_inc, scal.leak_exc,
                     scal.series_factor, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    imbue_infer_planes.launches += 1
    return out


# ------------------------------------------------- the dense-plane kernels

def _check_dense(name: str, lits: torch.Tensor, g: torch.Tensor,
                 leak: torch.Tensor, pol: torch.Tensor, packed: bool) -> None:
    if g.dtype != torch.float32 or g.ndim != 3:
        raise ValueError(f"{name}: g must be [R, C, L] float32, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if leak.dtype != torch.float32 or leak.shape != g.shape:
        raise ValueError(f"{name}: leak must be {tuple(g.shape)} float32, "
                         f"got {tuple(leak.shape)} {leak.dtype}")
    _, c, l = g.shape
    width, dtype = (words_for(l), torch.int32) if packed else (l, torch.uint8)
    if lits.dtype != dtype or lits.ndim != 2 or lits.shape[1] != width:
        raise ValueError(f"{name}: literals must be [B, {width}] {dtype}, "
                         f"got {tuple(lits.shape)} {lits.dtype}")
    if pol.dtype != torch.int32 or pol.ndim != 2 or pol.shape[0] != c:
        raise ValueError(f"{name}: pol must be [{c}, M] int32, got "
                         f"{tuple(pol.shape)} {pol.dtype}")
    tensors = (lits, g, leak, pol)
    if any(t.device != lits.device for t in tensors):
        raise ValueError(f"{name} operands are on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} operands must be contiguous")


def _pad_cells(x: torch.Tensor, lp: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, lp - x.shape[-1]))


def imbue_infer_packed_ref(litw: torch.Tensor, g: torch.Tensor,
                           leak: torch.Tensor, pol: torch.Tensor,
                           i_ref: float, v_read: float) -> torch.Tensor:
    """Plain PyTorch version of ``imbue_infer_packed`` (same signature)."""
    lp = litw.shape[1] * WORD
    return _class_sums_ref(unpack_bits(litw, lp).to(torch.float32),
                           _pad_cells(g, lp), _pad_cells(leak, lp), pol,
                           _f32(i_ref), _f32(v_read))


def imbue_infer_ref(lits: torch.Tensor, g: torch.Tensor, leak: torch.Tensor,
                    pol: torch.Tensor, i_ref: float,
                    v_read: float) -> torch.Tensor:
    """Plain PyTorch version of ``imbue_infer`` (same signature)."""
    lp = words_for(lits.shape[1]) * WORD
    return _class_sums_ref(_pad_cells(lits.to(torch.float32), lp),
                           _pad_cells(g, lp), _pad_cells(leak, lp), pol,
                           _f32(i_ref), _f32(v_read))


def _launch_dense(wrapper, lits: torch.Tensor, g: torch.Tensor,
                  leak: torch.Tensor, pol: torch.Tensor, i_ref: float,
                  v_read: float) -> torch.Tensor:
    """Launch ``wrapper``'s kernel on CUDA operands and count the launch
    on ``wrapper.launches``; returns ``[R, B, M]`` int32."""
    name = wrapper.__name__
    if lits.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{lits.device}")
    r, c, l = g.shape
    b, m = lits.shape[0], pol.shape[1]
    out = torch.zeros((r, b, m), dtype=torch.int32, device=lits.device)
    if r == 0 or b == 0 or c == 0 or m == 0:
        return out
    launch = _build.load(name, _DENSE_ARGTYPES)
    with torch.cuda.device(lits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(lits.data_ptr(), g.data_ptr(), leak.data_ptr(),
                     pol.data_ptr(), out.data_ptr(), r, b, l, c, m,
                     _f32(i_ref), _f32(v_read), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    wrapper.launches += 1
    return out


def imbue_infer_packed(litw: torch.Tensor, g: torch.Tensor,
                       leak: torch.Tensor, pol: torch.Tensor, i_ref: float,
                       v_read: float) -> torch.Tensor:
    """``[R, B, M]`` int32 class sums from packed literal words and dense
    ``[R, C, L]`` conductance / leak planes."""
    _check_dense("imbue_infer_packed", litw, g, leak, pol, packed=True)
    if litw.device.type == "cpu":
        return imbue_infer_packed_ref(litw, g, leak, pol, i_ref, v_read)
    return _launch_dense(imbue_infer_packed, litw, g, leak, pol, i_ref,
                         v_read)


def imbue_infer(lits: torch.Tensor, g: torch.Tensor, leak: torch.Tensor,
                pol: torch.Tensor, i_ref: float,
                v_read: float) -> torch.Tensor:
    """``[R, B, M]`` int32 class sums from 0/1 literal bytes and dense
    ``[R, C, L]`` conductance / leak planes."""
    _check_dense("imbue_infer", lits, g, leak, pol, packed=False)
    if lits.device.type == "cpu":
        return imbue_infer_ref(lits, g, leak, pol, i_ref, v_read)
    return _launch_dense(imbue_infer, lits, g, leak, pol, i_ref, v_read)


imbue_infer_planes.launches = 0
imbue_infer_packed.launches = 0
imbue_infer.launches = 0
