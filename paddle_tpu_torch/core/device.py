"""Device selection (counterpart of ``paddle_tpu/core/device.py``).

The rule every entry point of the port follows: ``device=None`` means the
CUDA card.  The CPU is used only when the caller asks for it explicitly
(``device="cpu"``), as the CPU tests do.  Asking for the card where there
is none raises; nothing falls back to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; an explicit device is taken as given.  Raises
    ``RuntimeError`` when the result is a CUDA device and CUDA is not
    available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on the CUDA card by default, and no "
            "CUDA device is available; pass device='cpu' explicitly to "
            "run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (cuda or cpu)" % (dev,))
    if dev.type == "cuda" and dev.index is None:
        # the card tensors actually land on, so devices compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
