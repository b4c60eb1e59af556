"""Default device of the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Without a
card they raise; they never drop to the CPU on their own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a `torch.device`, 'cuda' when None. Raises when a CUDA
    device is asked for (or defaulted to) and none is available."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" to run the '
            'plain PyTorch path on the CPU')
    return dev
