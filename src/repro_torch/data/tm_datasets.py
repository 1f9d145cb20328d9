"""Datasets for the TM evaluation (port of part of
``repro.data.tm_datasets``), drawn from a ``torch.Generator``.

* ``noisy_xor`` — the canonical TM benchmark (Granmo 2018): 12 Boolean
  features, label = XOR of the first two, the other 10 uniform noise, and
  40 % of the training labels flipped.
* ``synthetic_image_dataset`` — an MNIST-shaped stand-in: binary 28x28
  images from per-class prototype masks plus bit-flip noise.

The reference draws the same recipes from ``jax.random``, so the two
agree by property (shapes, dtypes, rates), not sample by sample.  Labels
are int64, PyTorch's index type.  Draws run on ``device`` (default
``cuda``), where ``generator`` must live.
"""

from __future__ import annotations

from typing import Tuple

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
