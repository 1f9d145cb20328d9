"""Booleanization of raw inputs (port of ``repro.core.booleanize``; paper
Fig. 1b).

Raw scalar features become Boolean features through a thermometer code
against per-feature thresholds: bit ``k`` of feature ``f`` is
``x_f > t_{f,k}``.  Thresholds are fit from training data at uniform
quantiles (``fit_quantile``, the quantile booleanizer the paper's KWS-6
models use) or spaced uniformly over the observed range
(``fit_uniform``); the fit is host numpy in float64, rounded to float32
once, so the same data gives the reference's thresholds bit for bit.

:class:`Booleanizer` holds its thresholds as a float32 ``[F, K]`` tensor
and ``transform`` runs on their device.  :class:`StreamingBooleanizer`
is the streaming front-end's sliding window: frames are encoded as they
arrive, a ring buffer keeps only the frames a future window still needs,
and each hop emits one ``window * F * K`` bit row.  It is host numpy on
purpose, as in the reference: it runs per session before the batched
dispatch.  Both paths compare in float32, so ``push`` and
``transform_offline`` emit exactly ``Booleanizer.transform``'s bits, and
any chunking of a stream emits exactly ``transform_offline``'s rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Booleanizer:
    """Thermometer encoder: feature f -> bits ``[x > t_1, ..., x > t_k]``."""

    thresholds: torch.Tensor   # [F, K] float32, ascending per feature

    @property
    def bits_per_feature(self) -> int:
        return self.thresholds.shape[1]

    @property
    def n_boolean_features(self) -> int:
        return self.thresholds.shape[0] * self.thresholds.shape[1]

    def transform(self, x) -> torch.Tensor:
        """``[..., F]`` raw -> ``[..., F*K]`` uint8 thermometer bits, on the
        thresholds' device."""
        x = torch.as_tensor(x).to(device=self.thresholds.device,
                                  dtype=torch.float32)
        bits = x[..., :, None] > self.thresholds
        return bits.reshape(*x.shape[:-1], -1).to(torch.uint8)

    def __call__(self, x) -> torch.Tensor:
        return self.transform(x)


def _thresholds(thr: np.ndarray, device: DeviceLike) -> Booleanizer:
    return Booleanizer(thresholds=torch.from_numpy(
        np.ascontiguousarray(thr, dtype=np.float32)).to(
            resolve_device(device)))


def fit_quantile(x, bits: int, *, device: DeviceLike = None) -> Booleanizer:
    """Quantile thermometer thresholds from training data ``[N, F]``."""
    qs = np.linspace(0.0, 1.0, bits + 2)[1:-1]
    thr = np.quantile(np.asarray(x, dtype=np.float64), qs, axis=0).T  # [F, K]
    # Degenerate (constant) features: nudge ties so the bits stay ordered.
    eps = 1e-9 * (1.0 + np.abs(thr))
    return _thresholds(thr + eps * np.arange(bits)[None, :], device)


def fit_uniform(x, bits: int, *, device: DeviceLike = None) -> Booleanizer:
    """Uniformly spaced thresholds across each feature's observed range."""
    x = np.asarray(x)
    lo = np.min(x, axis=0).astype(np.float64)
    hi = np.max(x, axis=0).astype(np.float64)
    steps = np.linspace(0.0, 1.0, bits + 2)[1:-1]
    return _thresholds(lo[:, None] + (hi - lo)[:, None] * steps[None, :],
                       device)


def binarize(x: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """1-bit booleanization (``x > threshold`` as uint8), where ``x`` lies:
    the image datasets' pixels -> 784 Boolean features."""
    return (x > threshold).to(torch.uint8)


class StreamingBooleanizer:
    """Sliding-window thermometer encoder for frame streams.

    Row ``t`` covers frames ``[t*hop, t*hop + window)`` and concatenates
    their thermometer bits into one ``[window * F * K]`` uint8 row, the
    Boolean input of one classifier read.  The instance is a session's
    ring buffer: frames are encoded once on arrival and dropped as soon as
    no future window can reach them, so memory stays ``O(window)`` however
    long the stream.  Host numpy throughout.

    Chunking invariance: ``push(a); push(b)`` emits exactly the rows of
    ``transform_offline(concat(a, b))``.
    """

    def __init__(self, booleanizer: Booleanizer, window: int, hop: int):
        if window < 1 or hop < 1:
            raise ValueError(f"window and hop must be >= 1, got "
                             f"{window}/{hop}")
        self.booleanizer = booleanizer
        self.window = int(window)
        self.hop = int(hop)
        # A host copy of the thresholds: frames compare in float32 here as
        # in Booleanizer.transform, so the bits are identical.
        self._thr = booleanizer.thresholds.detach().to(
            "cpu", torch.float32).numpy()
        self.reset()

    @property
    def frame_features(self) -> int:
        """Raw features per frame (``F``)."""
        return self._thr.shape[0]

    @property
    def bits_per_frame(self) -> int:
        return self._thr.shape[0] * self._thr.shape[1]

    @property
    def n_boolean_features(self) -> int:
        """Boolean features per emitted window row."""
        return self.window * self.bits_per_frame

    @property
    def frames_buffered(self) -> int:
        return len(self._buf)

    def reset(self) -> None:
        """Forget the stream (a fresh session)."""
        self._buf = np.zeros((0, self.bits_per_frame), dtype=np.uint8)
        self._start = 0          # stream index of _buf[0]
        self._next = 0           # stream index of the next window's start

    def _encode(self, frames: np.ndarray) -> np.ndarray:
        """``[T, F]`` float32 -> ``[T, F*K]`` uint8 thermometer bits."""
        bits = frames[:, :, None] > self._thr[None, :, :]
        return bits.reshape(frames.shape[0], -1).astype(np.uint8)

    def _check_frames(self, frames) -> np.ndarray:
        if isinstance(frames, torch.Tensor):
            frames = frames.detach().cpu().numpy()
        frames = np.asarray(frames, dtype=np.float32)
        if frames.ndim == 1:
            frames = frames[None, :]
        if frames.ndim != 2 or frames.shape[1] != self.frame_features:
            raise ValueError(f"expected [T, {self.frame_features}] frames, "
                             f"got {frames.shape}")
        return frames

    def _empty(self) -> np.ndarray:
        return np.zeros((0, self.n_boolean_features), dtype=np.uint8)

    def push(self, frames) -> np.ndarray:
        """Feed ``[T, F]`` (or one ``[F]``) raw frames; returns the
        ``[n_new, window*F*K]`` rows they complete (possibly none)."""
        frames = self._check_frames(frames)
        self._buf = np.concatenate([self._buf, self._encode(frames)])
        rows = []
        end = self._start + len(self._buf)
        while self._next + self.window <= end:
            lo = self._next - self._start
            rows.append(self._buf[lo:lo + self.window].reshape(-1))
            self._next += self.hop
        drop = min(self._next - self._start, len(self._buf))
        if drop > 0:             # ring-buffer trim: frames nothing needs
            self._buf = self._buf[drop:]
            self._start += drop
        return np.stack(rows) if rows else self._empty()

    def transform_offline(self, frames) -> np.ndarray:
        """Every window row of a complete ``[T, F]`` stream at once
        (stateless: the offline side of streamed == offline)."""
        frames = self._check_frames(frames)
        n = (0 if len(frames) < self.window
             else 1 + (len(frames) - self.window) // self.hop)
        if n == 0:
            return self._empty()
        bits = self._encode(frames)
        idx = (self.hop * np.arange(n)[:, None]
               + np.arange(self.window)[None, :])
        return bits[idx].reshape(n, -1)
