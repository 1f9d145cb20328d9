"""Bit-packed Boolean planes: the port's copy of ``repro.kernels.bitpack``.

Layout is the reference's, bit for bit: little-endian within each 32-bit
word, so bit ``j`` of word ``w`` is Boolean element ``32*w + j``, and a
ragged length is zero-padded up to the word boundary.

Words travel as **int32 bit patterns**.  Torch has no usable ``uint32``
on the CPU (no ``~``, ``>>`` or ``<<``), so the port keeps the same 32
bits in an ``int32`` and reads bit ``j`` as ``(w >> j) & 1`` — correct for
``j = 31`` too, because the arithmetic shift only smears the sign into
bits the mask drops.  Numpy ``uint32`` words convert at the boundary with
``.view(np.int32)`` / ``.view(np.uint32)`` (:func:`words_to_torch`).
"""

from __future__ import annotations

import numpy as np
import torch

WORD = 32                      # bits per packed word


def words_for(n_bits: int) -> int:
    """Number of 32-bit words holding ``n_bits`` booleans."""
    return -(-n_bits // WORD)


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD, dtype=torch.int32, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """``[..., L]`` 0/1 -> ``[..., ceil(L/32)] int32`` words (little-endian).

    Accepts any integer/bool dtype; values must be 0/1.  The sum runs in
    int64 (bits are disjoint, so sum == OR) and folds bit 31 into the
    int32 sign at the end.
    """
    l = bits.shape[-1]
    nw = words_for(l)
    b = bits.to(torch.int64)
    pad = nw * WORD - l
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(*bits.shape[:-1], nw, WORD)
    w = (b << torch.arange(WORD, dtype=torch.int64, device=b.device)).sum(-1)
    w = torch.where(w >= 2 ** 31, w - 2 ** 32, w)
    return w.to(torch.int32)


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """``[..., W] int32`` -> ``[..., n_bits] uint8`` (inverse of pack)."""
    bits = (words.to(torch.int32)[..., :, None] >> _shifts(words.device)) & 1
    flat = bits.reshape(*words.shape[:-1], words.shape[-1] * WORD)
    return flat[..., :n_bits].to(torch.uint8)


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """Host-side pack: ``[..., L]`` 0/1 -> ``[..., ceil(L/32)] uint32``.

    ``np.packbits(bitorder='little')`` + an explicit little-endian
    ``uint32`` view, identical to the reference's host packer.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    nw = words_for(bits.shape[-1])
    by = np.packbits(bits, axis=-1, bitorder="little")   # [..., ceil(L/8)]
    pad = nw * 4 - by.shape[-1]
    if pad:
        pads = [(0, 0)] * (by.ndim - 1) + [(0, pad)]
        by = np.pad(by, pads)
    return np.ascontiguousarray(by).view("<u4")


def words_to_torch(words: np.ndarray, device=None) -> torch.Tensor:
    """Numpy ``uint32`` words -> the port's int32 bit patterns."""
    w = np.array(words, dtype=np.uint32)          # an owned, writable copy
    return torch.from_numpy(w.view(np.int32)).to(device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """The port's int32 words -> numpy ``uint32`` (same bits)."""
    return words.detach().cpu().numpy().astype(np.int32).view(np.uint32)
