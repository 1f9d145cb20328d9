"""The digital / coalesced TM kernels: wrappers, plain versions and launch
counters (port of ``repro.kernels.clause_eval``).

The fused inference kernels compute class sums ``[B, M]`` int32: clause
``c`` fires for batch row ``b`` iff its violation count is 0, and the
fired clauses' rows of the combine matrix are summed:

* ``tm_infer_planes(litw, incw, comb)`` — packed words: a block stages
  its words and its slice of the combine matrix in one ``cp.async``
  round trip and counts ``popc(~lit & inc)`` with the single-bit
  tensor-core product (``csrc/tm_b1.cuh``; ``tm_infer_planes_kernel``;
  the ``*-packed2`` backends);
* ``tm_infer_packed(litw, incw, comb)`` — the same function from the
  same words, on the same block body (``tm_infer_packed_kernel``; the
  ``*-packed`` backends);
* ``tm_infer(lits, include, comb)`` — dense 0/1 bytes, folded into bit
  words while staged, then the b1 product as ``tm_infer_planes``
  (``tm_infer_kernel``; the unpacked fused backends).

All three add their blocks' sums with int32 atomics into an output the
wrapper zero-fills first (one launch more).

The clause-evaluation kernels stop before the combine and return the
clause bits ``[B, C]`` uint8 with training semantics — a clause fires
iff it has no violation, so an empty clause fires:

* ``clause_eval_packed(litw, incw)`` — packed words, AND + popcount
  (``clause_eval_packed_kernel``; the batch training steps);
* ``clause_eval(lits, include)`` — dense 0/1 bytes, folded to bit words
  and counted the same way (``clause_eval_kernel``; the sequential
  training step): a warp per clause up to ``B_SMALL`` rows
  (``csrc/clause_eval.cu``, which reports its choice through
  ``clause_eval_small_route(B, L)``), the packed kernels' tiles above.

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

# <name>_launch(a, inc, comb, out, B, K, C, M, stream) for the fused three;
# <name>_launch(a, inc, out, B, K, C, stream) for the clause-bit two.
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_EVAL_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check_pair(name: str, a: torch.Tensor, inc: torch.Tensor,
                dtypes) -> None:
    if a.dtype not in dtypes or a.ndim != 2:
        raise ValueError(f"{name}: literals must be [B, K] {dtypes}, got "
                         f"{tuple(a.shape)} {a.dtype}")
    if inc.dtype not in dtypes or inc.ndim != 2 or inc.shape[1] != a.shape[1]:
        raise ValueError(f"{name}: include must be [C, {a.shape[1]}] "
                         f"{dtypes}, got {tuple(inc.shape)} {inc.dtype}")
    if inc.device != a.device:
        raise ValueError(f"{name} operands are on different devices: "
                         f"{a.device}, {inc.device}")
    if not (a.is_contiguous() and inc.is_contiguous()):
        raise ValueError(f"{name} operands must be contiguous")


def _check(name: str, a: torch.Tensor, inc: torch.Tensor,
           comb: torch.Tensor, dtypes) -> None:
    _check_pair(name, a, inc, dtypes)
    if (comb.dtype != torch.int32 or comb.ndim != 2
            or comb.shape[0] != inc.shape[0]):
        raise ValueError(f"{name}: comb must be [{inc.shape[0]}, M] int32, "
                         f"got {tuple(comb.shape)} {comb.dtype}")
    if comb.device != a.device:
        raise ValueError(f"{name} operands are on different devices: "
                         f"{a.device}, {comb.device}")
    if not comb.is_contiguous():
        raise ValueError(f"{name} operands must be contiguous")


def _launch(name: str, a: torch.Tensor, inc: torch.Tensor,
            comb: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Launch ``name`` on CUDA operands; returns the ``[B, M]`` int32 sums
    and the launches made: 1, or 0 (zeros) when there is no batch row,
    clause or class."""
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{a.device}")
    b, k = a.shape
    c, m = comb.shape
    out = torch.zeros((b, m), dtype=torch.int32, device=a.device)
    if b == 0 or c == 0 or m == 0:
        return out, 0
    # Rows of no words or bytes (k == 0) still launch: every clause
    # fires.  Such operands have no storage (data_ptr 0) and the kernel
    # reads none of them, but its zero-filling cp.async copies still take
    # a device address: comb's stands in.
    pa, pi = ((a.data_ptr(), inc.data_ptr()) if k
              else (comb.data_ptr(), comb.data_ptr()))
    launch = _build.load(name, _ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(pa, pi, comb.data_ptr(), out.data_ptr(), b, k, c, m,
                     stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    return out, 1


def _launch_eval(name: str, a: torch.Tensor,
                 inc: torch.Tensor) -> torch.Tensor:
    """Launch the clause-bit kernel ``name`` on CUDA operands; returns
    ``[B, C]`` uint8.  An empty batch or clause set launches nothing."""
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{a.device}")
    b, k = a.shape
    c = inc.shape[0]
    out = torch.empty((b, c), dtype=torch.uint8, device=a.device)
    if b == 0 or c == 0:
        return out
    launch = _build.load(name, _EVAL_ARGTYPES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(a.data_ptr(), inc.data_ptr(), out.data_ptr(), b, k, c,
                     stream)
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


# The planes kernel computes the same integer function as the packed one
# (the TPU kernels differ in how they move K; the CUDA ones share a body).
tm_infer_planes_ref = tm_infer_packed_ref


def tm_infer_ref(lits: torch.Tensor, include: torch.Tensor,
                 comb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``tm_infer``: the violation count as a
    float32 product (exact for 0/1 operands), the threshold, the
    combine."""
    viol = (1.0 - lits.to(torch.float32)) @ include.to(torch.float32).T
    return _combine(viol == 0, comb)


def clause_eval_packed_ref(litw: torch.Tensor,
                           incw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``clause_eval_packed``: AND + popcount over
    every ``[B, C, Lw]`` word triple; a clause fires iff its count is 0
    (an empty clause fires)."""
    viol = _popcount(~litw[:, None, :] & incw[None, :, :]).sum(-1)
    return (viol == 0).to(torch.uint8)


def clause_eval_ref(lits: torch.Tensor, include: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``clause_eval``: the float32 violation
    product (exact for 0/1 operands), then ``== 0`` (an empty clause
    fires)."""
    viol = (1.0 - lits.to(torch.float32)) @ include.to(torch.float32).T
    return (viol == 0).to(torch.uint8)


def tm_infer_planes(litw: torch.Tensor, incw: torch.Tensor,
                    comb: torch.Tensor) -> torch.Tensor:
    """``[B, M]`` int32 class sums from packed words, counted on the b1
    tensor cores."""
    _check("tm_infer_planes", litw, incw, comb, (torch.int32,))
    if litw.device.type == "cpu":
        return tm_infer_planes_ref(litw, incw, comb)
    out, launched = _launch("tm_infer_planes", litw, incw, comb)
    tm_infer_planes.launches += launched
    return out


def tm_infer_packed(litw: torch.Tensor, incw: torch.Tensor,
                    comb: torch.Tensor) -> torch.Tensor:
    """``[B, M]`` int32 class sums from packed words, counted on the b1
    tensor cores (the kernel of the ``*-packed`` backends)."""
    _check("tm_infer_packed", litw, incw, comb, (torch.int32,))
    if litw.device.type == "cpu":
        return tm_infer_packed_ref(litw, incw, comb)
    out, launched = _launch("tm_infer_packed", litw, incw, comb)
    tm_infer_packed.launches += launched
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
    out, launched = _launch("tm_infer", lits, include, comb)
    tm_infer.launches += launched
    return out


def clause_eval_packed(litw: torch.Tensor, incw: torch.Tensor) -> torch.Tensor:
    """``[B, C]`` uint8 clause bits from packed words, training semantics
    (empty clauses fire)."""
    _check_pair("clause_eval_packed", litw, incw, (torch.int32,))
    if litw.device.type == "cpu":
        return clause_eval_packed_ref(litw, incw)
    out = _launch_eval("clause_eval_packed", litw, incw)
    if out.numel():                     # an empty output launched nothing
        clause_eval_packed.launches += 1
    return out


def clause_eval(lits: torch.Tensor, include: torch.Tensor) -> torch.Tensor:
    """``[B, C]`` uint8 clause bits from dense 0/1 bytes, training
    semantics (a bool include plane is read as its bytes, without a
    copy)."""
    if include.dtype == torch.bool:
        include = include.view(torch.uint8)
    _check_pair("clause_eval", lits, include, (torch.uint8,))
    if lits.device.type == "cpu":
        return clause_eval_ref(lits, include)
    out = _launch_eval("clause_eval", lits, include)
    if out.numel():                     # an empty output launched nothing
        clause_eval.launches += 1
    return out


tm_infer_planes.launches = 0
tm_infer_packed.launches = 0
tm_infer.launches = 0
clause_eval_packed.launches = 0
clause_eval.launches = 0
