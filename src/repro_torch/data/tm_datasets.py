"""Datasets for the TM evaluation (port of part of
``repro.data.tm_datasets``), drawn from a ``torch.Generator``.

* ``noisy_xor`` — the canonical TM benchmark (Granmo 2018): 12 Boolean
  features, label = XOR of the first two, the other 10 uniform noise, and
  40 % of the training labels flipped.
* ``synthetic_image_dataset`` — an MNIST-shaped stand-in: binary 28x28
  images from per-class prototype masks plus bit-flip noise.
* ``synthetic_kws6`` — a KWS-6-shaped streaming stand-in: six keyword
  classes, each a spectral trajectory over mel-like bins plus two fixed
  resonance bins, sampled as per-utterance frame streams with
  phase / amplitude jitter and white noise; ``kws6_windows`` windows them
  offline with a ``StreamingBooleanizer``.
* ``synthetic_sensor_anomaly`` — multichannel sensor streams, a share of
  them with one injected fault burst; ``sensor_anomaly_windows`` labels
  a window 1 iff any of its frames is in a burst.
* ``PAPER_TABLE_IV`` — the paper's published model statistics.

The reference draws the same recipes from ``jax.random``, so the two
agree by property (shapes, dtypes, rates), not sample by sample.  Labels
are int64, PyTorch's index type.  Draws run on ``device`` (default
``cuda``), where ``generator`` must live.  The two window functions are
host numpy, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

Split = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _bernoulli(generator: torch.Generator, p: float, shape,
               device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) < p


def noisy_xor(generator: torch.Generator, n_train: int = 5000,
              n_test: int = 5000, n_features: int = 12,
              label_noise: float = 0.4, *,
              device: DeviceLike = None) -> Split:
    """``(x_train, y_train, x_test, y_test)``: ``x`` uint8 ``[n, F]``
    uniform bits, ``y = x0 ^ x1``; a ``label_noise`` share of the training
    labels is flipped, the test labels are clean."""
    device = resolve_device(device)
    x = _bernoulli(generator, 0.5, (n_train + n_test, n_features),
                   device).to(torch.uint8)
    y = (x[:, 0] ^ x[:, 1]).to(torch.int64)
    flip = _bernoulli(generator, label_noise, (n_train,), device)
    y_train = torch.where(flip, 1 - y[:n_train], y[:n_train])
    return x[:n_train], y_train, x[n_train:], y[n_train:]


def synthetic_image_dataset(generator: torch.Generator, n_classes: int = 10,
                            n_train: int = 2000, n_test: int = 500,
                            side: int = 28, prototype_density: float = 0.25,
                            noise: float = 0.08, *,
                            device: DeviceLike = None) -> Split:
    """Binary image stand-in: one random prototype per class (each pixel
    on with ``prototype_density``), and each example its class's prototype
    with every pixel flipped with probability ``noise``.  ``x`` is uint8
    ``[n, side * side]``, ``y`` uniform over the classes."""
    device = resolve_device(device)
    f = side * side
    protos = _bernoulli(generator, prototype_density, (n_classes, f),
                        device).to(torch.uint8)

    def make(n):
        y = torch.randint(0, n_classes, (n,), generator=generator,
                          device=device)
        flips = _bernoulli(generator, noise, (n, f), device).to(torch.uint8)
        return protos[y] ^ flips, y

    x_train, y_train = make(n_train)
    x_test, y_test = make(n_test)
    return x_train, y_train, x_test, y_test


KWS6_CLASSES = ("yes", "no", "up", "down", "left", "right")


def synthetic_kws6(generator: torch.Generator, n_utterances: int = 60,
                   n_frames: int = 32, n_mels: int = 12,
                   n_classes: int = 6, noise: float = 0.15, *,
                   device: DeviceLike = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KWS-6 stand-in: ``(frames [N, T, M] float32, labels [N] int64)``.

    Keyword class ``c`` is a Gaussian energy bump over ``n_mels`` bins
    whose centre starts at bin ``1 + (M - 3) c / (n_classes - 1)``, sweeps
    by ``±M / 6`` (the sign alternates by class) and wobbles with a
    vibrato of ``1 + c % 3`` cycles, plus two fixed resonance bins, so
    every window carries class evidence.  Each utterance draws a label, a
    vibrato phase and an amplitude ``1 + 0.2 n``; white noise of std
    ``noise`` is added to every frame.  Raw frame streams, to be windowed
    by ``StreamingBooleanizer``.
    """
    device = resolve_device(device)
    y = torch.randint(0, n_classes, (n_utterances,), generator=generator,
                      device=device)
    t = torch.linspace(0.0, 1.0, n_frames, device=device)        # [T]
    m = torch.arange(n_mels, dtype=torch.float32, device=device)  # [M]
    c = torch.arange(n_classes, dtype=torch.float32, device=device)
    base = 1.0 + (n_mels - 3.0) * c / max(n_classes - 1, 1)
    slope = torch.where(c % 2 == 0, 1.0, -1.0) * (n_mels / 6.0)
    vib_f = 1.0 + c % 3
    sig1 = (c + 0.5) * n_mels / n_classes
    sig2 = torch.remainder(sig1 + n_mels / 2.0 + c % 2, float(n_mels))
    phase = torch.rand(n_utterances, generator=generator, device=device)
    amp = 1.0 + 0.2 * torch.randn(n_utterances, generator=generator,
                                  device=device)
    center = (base[y, None] + slope[y, None] * t
              + 0.8 * torch.sin(2 * math.pi * (vib_f[y, None] * t
                                               + phase[:, None])))
    center = center.clamp(0.0, n_mels - 1.0)                     # [N, T]
    bump = torch.exp(-0.5 * ((m - center[..., None]) / 1.2) ** 2)
    res = (torch.exp(-0.5 * ((m - sig1[y, None]) / 0.7) ** 2)
           + torch.exp(-0.5 * ((m - sig2[y, None]) / 0.7) ** 2))  # [N, M]
    x = amp[:, None, None] * (bump + 0.8 * res[:, None, :])
    x = x + noise * torch.randn(x.shape, generator=generator, device=device)
    return x.to(torch.float32), y


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def kws6_windows(frames, labels, windower) -> Tuple[np.ndarray, np.ndarray]:
    """Offline windowing of KWS-6 utterances for training and evaluation:
    each utterance's window rows (``windower.transform_offline``), each
    labelled with the utterance's keyword.  Returns ``(rows [NW,
    window*M*K] uint8, y [NW] int64)``."""
    frames, labels = _host(frames), _host(labels)
    rows, ys = [], []
    for i in range(frames.shape[0]):
        r = windower.transform_offline(frames[i])
        rows.append(r)
        ys.append(np.full(len(r), labels[i], dtype=np.int64))
    return np.concatenate(rows), np.concatenate(ys)


def synthetic_sensor_anomaly(generator: torch.Generator,
                             n_streams: int = 60, n_frames: int = 64,
                             n_sensors: int = 8, anomaly_rate: float = 0.3,
                             burst_frames: int = 12, noise: float = 0.05, *,
                             device: DeviceLike = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sensor-stream stand-in for the anomaly workload: ``(frames [N, T, S]
    float32, frame_labels [N, T] int64)``.

    Each stream is a smooth baseline, per-sensor sinusoids of random phase
    and frequency plus a slow shared drift; a share ``anomaly_rate`` of the
    streams carries one fault burst of ``burst_frames`` frames at a
    uniform start, a high-frequency ring (twice as strong on the odd
    sensors) plus a DC shift.  Frames inside the burst are labelled 1.
    """
    if burst_frames > n_frames:
        raise ValueError(f"burst_frames {burst_frames} exceeds n_frames "
                         f"{n_frames}")
    device = resolve_device(device)
    flags = _bernoulli(generator, anomaly_rate, (n_streams,), device)
    start = torch.randint(0, n_frames - burst_frames + 1, (n_streams,),
                          generator=generator, device=device)
    phase = torch.rand((n_streams, n_sensors), generator=generator,
                       device=device)
    freq = 0.5 + torch.rand((n_streams, n_sensors), generator=generator,
                            device=device)
    t = torch.arange(n_frames, dtype=torch.float32,
                     device=device) / n_frames                   # [T]
    s = torch.arange(n_sensors, dtype=torch.float32, device=device)
    frame = torch.arange(n_frames, device=device)
    base = torch.sin(2 * math.pi * (4.0 * freq[:, None, :] * t[:, None]
                                    + phase[:, None, :]))        # [N, T, S]
    base = base + 0.3 * torch.sin(2 * math.pi * (t[:, None]
                                                 + s / n_sensors))
    in_burst = (flags[:, None] & (frame >= start[:, None])
                & (frame < start[:, None] + burst_frames))       # [N, T]
    ring = torch.sin(2 * math.pi * 24.0 * t)[:, None] * (1.0 + s % 2)
    x = base + torch.where(in_burst[..., None], 1.8 * ring + 1.2, 0.0)
    x = x + noise * torch.randn(x.shape, generator=generator, device=device)
    return x.to(torch.float32), in_burst.to(torch.int64)


def sensor_anomaly_windows(frames, frame_labels,
                           windower) -> Tuple[np.ndarray, np.ndarray]:
    """Offline windowing of sensor streams: window ``i`` covers frames
    ``[i*hop, i*hop + window)`` and is labelled 1 iff any of them is
    anomalous, so a burst shorter than the window still alerts.  Returns
    ``(rows [NW, window*S*K] uint8, y [NW] int64)``."""
    frames, frame_labels = _host(frames), _host(frame_labels)
    rows, ys = [], []
    for i in range(frames.shape[0]):
        r = windower.transform_offline(frames[i])
        idx = (windower.hop * np.arange(len(r))[:, None]
               + np.arange(windower.window)[None, :])
        rows.append(r)
        ys.append(frame_labels[i][idx].max(axis=1).astype(np.int64))
    return np.concatenate(rows), np.concatenate(ys)


@dataclasses.dataclass(frozen=True)
class PaperModelStats:
    """One row of the paper's Table IV (published model statistics)."""

    name: str
    accuracy: float
    classes: int
    clauses_total: int
    ta_cells: int
    includes: int
    csas: int
    cmos_tm_nj: float       # CMOS TM [9] average energy/datapoint (nJ)
    imbue_nj: float         # IMBUE   average energy/datapoint (nJ)
    energy_reduction: float

    @property
    def features(self) -> int:
        # ta_cells = clauses_total * 2 * features
        return self.ta_cells // (2 * self.clauses_total)

    @property
    def include_pct(self) -> float:
        return 100.0 * self.includes / self.ta_cells


# Table IV, verbatim.
PAPER_TABLE_IV: Dict[str, PaperModelStats] = {
    s.name: s
    for s in [
        PaperModelStats("noisy-xor", 99.2, 2, 12, 576, 48, 18,
                        0.0092, 0.02, 0.36),
        PaperModelStats("mnist", 96.48, 10, 2000, 3_136_000, 18_927, 98_000,
                        50.01, 13.9, 3.597),
        PaperModelStats("kws-6", 87.1, 6, 1800, 1_357_200, 7_990, 42_413,
                        21.64, 5.91, 3.66),
        PaperModelStats("k-mnist", 88.6, 10, 5000, 7_840_000, 31_217,
                        245_000, 125.03, 26.47, 4.722),
        PaperModelStats("f-mnist", 87.67, 10, 5000, 7_840_000, 25_742,
                        245_000, 125.03, 23.66, 5.283),
    ]
}
