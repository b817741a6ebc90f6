"""The device the port's entry points put their tensors on.

Scenes, cameras and cluster tables are built on the card unless the caller
asks for another device (``device="cpu"``, as the tests do). Asking for the
card where there is none raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r}: no CUDA device is available; pass "
            "device='cpu' to build on the CPU")
    return dev
