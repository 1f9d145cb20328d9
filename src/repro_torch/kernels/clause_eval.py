"""The digital / coalesced TM inference kernels: wrappers, plain versions
and launch counters (port of the fused half of
``repro.kernels.clause_eval``).

Each computes class sums ``[B, M]`` int32: clause ``c`` fires for batch
row ``b`` iff its violation count is 0, and the fired clauses' rows of
the combine matrix are summed (see ``csrc/tm_common.cuh``):

* ``tm_infer_planes(litw, incw, comb)`` — packed words, AND + popcount,
  the include plane streamed through a two-stage ``cp.async`` ring
  (``tm_infer_planes_kernel``; the ``*-packed2`` backends);
* ``tm_infer_packed(litw, incw, comb)`` — the same arithmetic with each
  K chunk loaded synchronously (``tm_infer_packed_kernel``; the
  ``*-packed`` backends);
* ``tm_infer(lits, include, comb)`` — dense 0/1 bytes, float32 violation
  product (``tm_infer_kernel``; the unpacked fused backends).

Operands, in the layouts the states hold (nothing is transposed per
dispatch): ``litw [B, Lw]`` and ``incw [C, Lw]`` int32 words,
``lits [B, L]`` uint8, ``include [C, L]`` uint8 or bool, and
``comb [C, M]`` int32 (the polarity matrix or the coalesced weights, rows
of empty clauses zeroed by the caller).

On CPU tensors a wrapper computes with its plain PyTorch version (same
signature).  On CUDA tensors it launches its hand-written kernel or
raises — there is no fallback.  ``<wrapper>.launches`` counts kernel
launches, nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# <name>_launch(a, inc, comb, out, B, K, C, M, stream) for all three.
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _check(name: str, a: torch.Tensor, inc: torch.Tensor,
           comb: torch.Tensor, dtypes) -> None:
    if a.dtype not in dtypes or a.ndim != 2:
        raise ValueError(f"{name}: literals must be [B, K] {dtypes}, got "
                         f"{tuple(a.shape)} {a.dtype}")
    if inc.dtype not in dtypes or inc.ndim != 2 or inc.shape[1] != a.shape[1]:
        raise ValueError(f"{name}: include must be [C, {a.shape[1]}] "
                         f"{dtypes}, got {tuple(inc.shape)} {inc.dtype}")
    if (comb.dtype != torch.int32 or comb.ndim != 2
            or comb.shape[0] != inc.shape[0]):
        raise ValueError(f"{name}: comb must be [{inc.shape[0]}, M] int32, "
                         f"got {tuple(comb.shape)} {comb.dtype}")
    tensors = (a, inc, comb)
    if any(t.device != a.device for t in tensors):
        raise ValueError(f"{name} operands are on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} operands must be contiguous")


def _launch(name: str, a: torch.Tensor, inc: torch.Tensor,
            comb: torch.Tensor) -> torch.Tensor:
    """Launch ``name`` on CUDA operands; returns ``[B, M]`` int32."""
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{a.device}")
    b, k = a.shape
    c, m = comb.shape
    out = torch.zeros((b, m), dtype=torch.int32, device=a.device)
    if b == 0 or c == 0 or m == 0:
        return out
    launch = _build.load(name, _ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(a.data_ptr(), inc.data_ptr(), comb.data_ptr(),
                     out.data_ptr(), b, k, c, m, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    return out


def _popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, as int64 (SWAR, in int64 so that no
    step overflows)."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _combine(fired: torch.Tensor, comb: torch.Tensor) -> torch.Tensor:
    """``[B, C]`` bool x ``[C, M]`` int32 -> ``[B, M]`` int32.  The
    product runs in float64, exact for these integers (never TF32)."""
    return (fired.to(torch.float64) @ comb.to(torch.float64)).to(torch.int32)


def tm_infer_packed_ref(litw: torch.Tensor, incw: torch.Tensor,
                        comb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the packed kernels: AND + popcount over
    every ``[B, C, Lw]`` word triple, then the combine."""
    viol = _popcount(~litw[:, None, :] & incw[None, :, :]).sum(-1)
    return _combine(viol == 0, comb)


# The planes kernel computes the same integer function as the packed one;
# only the way the include words reach shared memory differs.
tm_infer_planes_ref = tm_infer_packed_ref


def tm_infer_ref(lits: torch.Tensor, include: torch.Tensor,
                 comb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``tm_infer``: the float32 violation
    product (exact for 0/1 operands), the threshold, the combine."""
    viol = (1.0 - lits.to(torch.float32)) @ include.to(torch.float32).T
    return _combine(viol == 0, comb)


def tm_infer_planes(litw: torch.Tensor, incw: torch.Tensor,
                    comb: torch.Tensor) -> torch.Tensor:
    """``[B, M]`` int32 class sums, include words streamed by the kernel's
    own two-stage ring."""
    _check("tm_infer_planes", litw, incw, comb, (torch.int32,))
    if litw.device.type == "cpu":
        return tm_infer_planes_ref(litw, incw, comb)
    out = _launch("tm_infer_planes", litw, incw, comb)
    tm_infer_planes.launches += 1
    return out


def tm_infer_packed(litw: torch.Tensor, incw: torch.Tensor,
                    comb: torch.Tensor) -> torch.Tensor:
    """``[B, M]`` int32 class sums from packed words, K chunks loaded
    synchronously."""
    _check("tm_infer_packed", litw, incw, comb, (torch.int32,))
    if litw.device.type == "cpu":
        return tm_infer_packed_ref(litw, incw, comb)
    out = _launch("tm_infer_packed", litw, incw, comb)
    tm_infer_packed.launches += 1
    return out


def tm_infer(lits: torch.Tensor, include: torch.Tensor,
             comb: torch.Tensor) -> torch.Tensor:
    """``[B, M]`` int32 class sums from dense 0/1 bytes (a bool include
    plane is read as its bytes, without a copy)."""
    if include.dtype == torch.bool:
        include = include.view(torch.uint8)
    _check("tm_infer", lits, include, comb, (torch.uint8,))
    if lits.device.type == "cpu":
        return tm_infer_ref(lits, include, comb)
    out = _launch("tm_infer", lits, include, comb)
    tm_infer.launches += 1
    return out


tm_infer_planes.launches = 0
tm_infer_packed.launches = 0
tm_infer.launches = 0
