"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import subprocess
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    There is no silent fallback to the host: with ``device=None`` and no
    CUDA this raises, so a run that was meant for the card can never
    carry on with the plain CPU versions.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host")
        return torch.device("cuda")
    return torch.device(device)



def device_label(device: torch.device) -> str:
    """The name a measurement is reported under: on a card, its name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (a card set below its maximum
    runs slower under load); on the host, that the plain versions ran."""
    if device.type != "cuda":
        return "host CPU, plain PyTorch versions"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout
        return out.strip().splitlines()[device.index or 0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"
