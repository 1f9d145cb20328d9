"""The cells' inputs and weights, drawn from the seed on the device in a
few large calls.

``image_sets`` follows ``chip_smoke.image_task`` (one random prototype a
class, each pixel on with ``density``; each example its class's prototype
with pixels flipped with probability ``noise``) with MNIST's frame: the
prototypes and the noise lie inside the centred ``box x box`` square of
the ``side x side`` image, and the border stays blank, as MNIST's digits
are normalised into a 20 x 20 box inside 28 x 28.  ``prototype_clauses``
follows ``chip_smoke.prototype_task``: a TA state whose positive clauses
of class m include 8-16 literals that are 1 on prototype m and whose
negative clauses do the same for another class.  ``d2d_resistances``
draws the programmed resistances of R chips from the distributions of
``src/repro_torch/core/variations.py`` (lognormal HRS, truncated-normal
LRS, both clipped to the published ranges).

Every draw takes its own generator, seeded from ``(seed, stream)``, so a
cell that needs only some of the inputs draws the same numbers for them
as one that needs all.
"""

from __future__ import annotations

import math

import torch

from imbue_bench.reference import imbue_tm as phys

STREAMS = {"protos": 1, "train_rows": 2, "test_rows": 3, "model": 4,
           "d2d": 5, "order": 6, "reads": 7, "train": 8, "ta_init": 9,
           "sample": 10}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """The generator of one input stream of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 16 + STREAMS[stream]) % (1 << 63))
    return g


def box_mask(side: int, box: int, device) -> torch.Tensor:
    """``[side * side]`` bool: the pixels of the centred ``box`` square."""
    m = torch.zeros(side, side, dtype=torch.bool, device=device)
    lo = (side - box) // 2
    m[lo:lo + box, lo:lo + box] = True
    return m.reshape(-1)


def class_prototypes(g: torch.Generator, n_classes: int, side: int,
                     box: int, density: float) -> torch.Tensor:
    """``[M, side * side]`` uint8 prototypes, blank outside the box."""
    inside = box_mask(side, box, g.device)
    on = torch.rand((n_classes, side * side), generator=g,
                    device=g.device) < density
    return (on & inside).to(torch.uint8)


def image_rows(g: torch.Generator, protos: torch.Tensor, n: int,
               noise: float, side: int, box: int):
    """``(x [n, F] uint8, y [n] int64)``: each row its class's prototype
    with the pixels inside the box flipped with probability ``noise``."""
    m_cls, f = protos.shape
    inside = box_mask(side, box, g.device)
    y = torch.randint(0, m_cls, (n,), generator=g, device=g.device)
    flips = (torch.rand((n, f), generator=g, device=g.device) < noise)
    return protos[y] ^ (flips & inside).to(torch.uint8), y


def image_sets(seed: int, images: dict, n_classes: int, device, *,
               train: bool, test: bool) -> dict:
    """The prototypes and the training and / or test rows of ``images``
    (``side``, ``box``, ``density``, ``noise``, ``train_rows``,
    ``test_rows``)."""
    side, box = images["side"], images["box"]
    protos = class_prototypes(generator(seed, "protos", device), n_classes,
                              side, box, images["density"])
    out = {"protos": protos}
    if train:
        out["x_train"], out["y_train"] = image_rows(
            generator(seed, "train_rows", device), protos,
            images["train_rows"], images["noise"], side, box)
    if test:
        out["x_test"], out["y_test"] = image_rows(
            generator(seed, "test_rows", device), protos,
            images["test_rows"], images["noise"], side, box)
    return out


def prototype_clauses(g: torch.Generator, protos: torch.Tensor,
                      clauses_per_class: int, n_states: int,
                      includes=(8, 16)) -> torch.Tensor:
    """``[C, 2F]`` int16 TA state whose clause ``c`` of class ``m`` (the
    ``j``-th of its class) includes ``includes[0]..includes[1]`` literals
    that are 1 on the prototype of class ``m`` (``j`` even, positive) or
    of class ``(m + 1 + (j // 2) % (M - 1)) % M`` (``j`` odd, negative);
    included TAs sit in ``[N + 1, 2N]``, the others in ``[1, N]``."""
    m_cls = protos.shape[0]
    dev = g.device
    proto_lits = torch.cat([protos, 1 - protos], dim=1).to(torch.bool)
    c_n = m_cls * clauses_per_class
    cls = torch.arange(c_n, device=dev) // clauses_per_class
    j = torch.arange(c_n, device=dev) % clauses_per_class
    src = torch.where(j % 2 == 0, cls,
                      (cls + 1 + (j // 2) % (m_cls - 1)) % m_cls)
    eligible = proto_lits[src]                                  # [C, L]
    score = torch.where(eligible, torch.rand(eligible.shape, generator=g,
                                             device=dev), 2.0)
    k = torch.randint(includes[0], includes[1] + 1, (c_n,), generator=g,
                      device=dev)
    include = score.argsort(dim=1).argsort(dim=1) < k[:, None]
    include &= eligible
    inc_state = torch.randint(n_states + 1, 2 * n_states + 1,
                              include.shape, generator=g, device=dev)
    exc_state = torch.randint(1, n_states + 1, include.shape, generator=g,
                              device=dev)
    return torch.where(include, inc_state, exc_state).to(torch.int16)


def init_ta(g: torch.Generator, n_clauses: int, n_literals: int,
            n_states: int) -> torch.Tensor:
    """``[C, L]`` int16 TA state on the include boundary: ``N`` or ``N +
    1`` with probability 1/2 (as ``core.tm.init_ta_state``)."""
    u = torch.rand((n_clauses, n_literals), generator=g, device=g.device)
    return (n_states + (u < 0.5).to(torch.int16)).to(torch.int16)


_HRS_LOG_SIGMA = (math.log(phys.HRS_MAX_OHM / phys.HRS_MEAN_OHM)
                  + math.log(phys.HRS_MEAN_OHM / phys.HRS_MIN_OHM)) / 6.0
_LRS_SIGMA = (phys.LRS_MAX_OHM - phys.LRS_MIN_OHM) / 6.0


def d2d_resistances(g: torch.Generator, include: torch.Tensor,
                    replicas: int) -> torch.Tensor:
    """``[R, C, L]`` float32 programmed resistances (ohm) of ``replicas``
    chips: include -> LRS, exclude -> HRS, each cell its own draw."""
    z = torch.randn((2, replicas, *include.shape), generator=g,
                    device=g.device, dtype=torch.float32)
    hrs = (phys.HRS_MEAN_OHM * torch.exp(_HRS_LOG_SIGMA * z[0])).clamp(
        phys.HRS_MIN_OHM, phys.HRS_MAX_OHM)
    lrs = (phys.LRS_MEAN_OHM + _LRS_SIGMA * z[1]).clamp(
        phys.LRS_MIN_OHM, phys.LRS_MAX_OHM)
    return torch.where(include, lrs, hrs)
