"""Gradient compression: int8 quantization with error feedback (port of
``repro.optim.compression``).

Data parallelism spends interconnect bandwidth on gradient all-reduces.
Quantizing each gradient to int8 with a per-leaf max-abs scale before the
reduction cuts those bytes; the quantization residual is carried in an
error-feedback buffer so the *accumulated* gradient signal is unbiased
over steps (Seide et al. 2014, 1-bit SGD lineage; here 8-bit).

``compressed_psum_grads`` is the reduction itself on ``torch.distributed``:
each rank quantizes its LOCAL gradients on a scale shared through an
all-reduce MAX, the quanta are summed on the wire, and the mean is
dequantized, with error feedback held per rank.  The reference sums int16
words; neither gloo nor NCCL sums a 16-bit integer, so the port packs two
signed quanta into one int32 word, ``a + (b << 16)``.  With ``n`` ranks
each lane's sum stays below ``n * qmax < 2**15`` in magnitude (the guard
below), so the words' int32 sum is exact and unpacks as ``lo`` (the low
half, sign-extended) and ``(total - lo) >> 16``: 2 bytes on the wire a
gradient element, as the reference's int16 words.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding


def _amax(g: torch.Tensor, like) -> torch.Tensor:
    """``max |g|`` over the whole tensor ``like`` is a block of (an
    all-reduce MAX over the ranks that split it)."""
    m = torch.max(torch.abs(g))
    if isinstance(like, DTensor):
        dims = sorted({i for d in range(like.ndim)
                       for i in sharding.split_dims(like, d)})
        for i in dims:
            dist.all_reduce(m, op=dist.ReduceOp.MAX,
                            group=like.device_mesh.get_group(i))
    return m


@dataclasses.dataclass(frozen=True)
class GradCompressor:
    bits: int = 8
    min_size: int = 4096     # don't compress small leaves (norm scales)

    @property
    def qmax(self) -> float:
        return 2.0 ** (self.bits - 1) - 1.0

    def init_state(self, params) -> Dict[str, Optional[torch.Tensor]]:
        """Error-feedback buffers, zero float32 (None for a leaf under
        ``min_size`` elements), keyed as ``params`` (a name -> tensor
        mapping or a module); a block's buffer is a block alike."""
        if isinstance(params, torch.nn.Module):
            params = dict(params.named_parameters())
        out = {}
        for n, p in params.items():
            if p.numel() < self.min_size:
                out[n] = None
                continue
            out[n] = sharding.block_like(p, torch.zeros_like(
                sharding.local(p), dtype=torch.float32))
        return out

    def compress_decompress(self, grads: Mapping[str, torch.Tensor],
                            state: Mapping[str, Optional[torch.Tensor]]):
        """Quantize + dequantize ``grads`` (simulating the compressed
        reduction) and update the error feedback.  Returns ``(grads',
        state')``, both keyed as ``grads``; the grads float32.  A block
        (``DTensor``) scales by the whole tensor's max."""
        qmax = self.qmax
        new_g, new_e = {}, {}
        for n, g in grads.items():
            e = state[n]
            if e is None:
                new_g[n] = g.float()
                new_e[n] = None
                continue
            gf = sharding.local(g).float() + sharding.local(e)
            scale = torch.clamp(_amax(gf, g), min=1e-12) / qmax
            q = torch.clamp(torch.round(gf / scale), -qmax, qmax)
            deq = q * scale
            new_g[n] = sharding.block_like(g, deq)
            new_e[n] = sharding.block_like(g, gf - deq)
        return new_g, new_e


def pack_int16_pairs(q: torch.Tensor) -> torch.Tensor:
    """Signed quanta (|q| < 2**15) as int32 words ``a + (b << 16)`` of
    consecutive pairs (flattened, a zero appended to an odd count)."""
    flat = q.reshape(-1).to(torch.int32)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    a, b = flat[0::2], flat[1::2]
    return a + b * 65536


def unpack_int16_pairs(words: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` signed lanes of summed words (each lane's sum below
    2**15 in magnitude), as int32."""
    lo = ((words & 0xFFFF) ^ 0x8000) - 0x8000
    hi = (words - lo) >> 16
    return torch.stack([lo, hi], dim=1).reshape(-1)[:n]


def _rows(x, sl):
    if isinstance(x, Mapping):
        return {k: v[sl] for k, v in x.items()}
    return x[sl]


def compressed_psum_grads(grad_fn: Callable, mesh, axis: str,
                          compressor: GradCompressor):
    """Manual data-parallel gradient reduction with int8 quanta on the
    wire.

    ``grad_fn(params, local_batch) -> {name: grad}`` computes this rank's
    gradients; the returned ``fn(params, batch, ef_state) -> (grads,
    ef_state)`` hands it this rank's rows of the global ``batch`` (split
    on dim 0 over mesh axis ``axis``; a tensor or a dict of tensors),
    quantizes each compressed leaf on a scale shared by an all-reduce MAX,
    sums the packed quanta (two to an int32 word) over ``axis`` and
    returns their dequantized mean, with error feedback kept per rank; a
    leaf without feedback state (under ``min_size``) is averaged in
    float32.  ``fn.wire_bytes`` holds, after each call, the bytes of each
    compressed leaf's all-reduce operand (2 an element)."""
    qmax = compressor.qmax
    names = list(mesh.mesh_dim_names)
    dim = names.index(axis)
    n_shards = mesh.size(dim)
    if n_shards * qmax >= 2 ** 15:
        raise ValueError("int16 accumulation overflows at this shard "
                         "count; lower compressor.bits")
    group = mesh.get_group(dim)
    dp = sharding.DataParallel(mesh, (dim,))

    def fn(params, batch, ef_state):
        n_rows = next(iter(batch.values())).shape[0] \
            if isinstance(batch, Mapping) else batch.shape[0]
        grads = grad_fn(params, _rows(batch, sharding.batch_rows(n_rows,
                                                                 dp)))
        out_g, out_e, wire = {}, {}, {}
        for n, g in grads.items():
            gf = g.float()
            e = ef_state[n]
            if e is None:
                out_g[n] = sharding.all_reduce_mean(gf, mesh, (dim,))
                out_e[n] = None
                continue
            gf = gf + e
            scale = torch.max(torch.abs(gf))
            dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
            scale = torch.clamp(scale / qmax, min=1e-12)
            q = torch.clamp(torch.round(gf / scale), -qmax, qmax)
            words = pack_int16_pairs(q)
            wire[n] = words.numel() * words.element_size()
            dist.all_reduce(words, op=dist.ReduceOp.SUM, group=group)
            total = unpack_int16_pairs(words, q.numel()).reshape(q.shape)
            out_g[n] = total.float() * scale / n_shards
            out_e[n] = gf - q * scale
        fn.wire_bytes = wire
        return out_g, out_e

    fn.wire_bytes = {}
    return fn
