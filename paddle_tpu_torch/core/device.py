"""Device selection (counterpart of ``paddle_tpu/core/device.py``).

The rule every entry point of the port follows: ``device=None`` means the
CUDA card.  The CPU is used only when the caller asks for it explicitly
(``device="cpu"``, or ``set_device("cpu")`` for the paddle API), as the
CPU tests do.  Asking for the card where there is none raises; nothing
falls back to the CPU on its own.

The paddle API's places are handles on ``torch.device``: ``CPUPlace`` and
``CUDAPlace`` (the reference's accelerator place, ``TPUPlace``, is the
same class here).  ``set_device`` picks where new API tensors land; with
none set they land on the card, and making one where there is no card
raises.  Importing never raises.
"""
from __future__ import annotations

import contextlib
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
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError("unsupported device %r (cuda or cpu; meta for a "
                         "shard's skeleton)" % (dev,))
    if dev.type == "cuda" and dev.index is None:
        # the card tensors actually land on, so devices compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Place:
    """A device handle (reference: ``Place``)."""

    device_type: str = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return "Place(%s:%d)" % (self.device_type, self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` of the place (raises for the card where
        there is none)."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        return resolve_device("cuda:%d" % self.device_id)


class CPUPlace(Place):
    device_type = "cpu"


class CUDAPlace(Place):
    """The card (the reference's ``TPUPlace``; ``CUDAPlace`` there is an
    alias of it)."""
    device_type = "gpu"


TPUPlace = CUDAPlace


class CustomPlace(Place):
    def __init__(self, device_type: str, device_id: int = 0):
        super().__init__(device_id)
        self.device_type = device_type


_CURRENT_DEVICE: list = [None]


def _parse(device: str) -> Place:
    if ":" in device:
        dev_type, idx = device.split(":")
        idx = int(idx)
    else:
        dev_type, idx = device, 0
    if dev_type == "cpu":
        return CPUPlace(idx)
    if dev_type in ("gpu", "cuda", "tpu"):
        return CUDAPlace(idx)
    raise ValueError("unsupported device %r (cpu or gpu)" % (device,))


def set_device(device) -> Place:
    """Select the device new API tensors land on (``"cpu"``, ``"gpu"``,
    ``"gpu:1"``; ``"tpu"`` and ``"cuda"`` name the card too).  Returns
    the place."""
    place = device if isinstance(device, Place) else _parse(str(device))
    _CURRENT_DEVICE[0] = place
    return place


def get_place() -> Place:
    return _CURRENT_DEVICE[0] or CUDAPlace(0)


def get_device() -> str:
    """The current device string, e.g. ``'gpu:0'`` or ``'cpu'``."""
    p = get_place()
    return "cpu" if p.device_type == "cpu" else "%s:%d" % (p.device_type,
                                                            p.device_id)


def current_device() -> torch.device:
    """The ``torch.device`` new API tensors land on: the place set by
    :func:`set_device`, else the card (raising where there is none)."""
    return get_place().torch_device


def place_device(place) -> torch.device:
    """A ``place=`` argument (a Place, a string or a ``torch.device``;
    None for the current one) as a ``torch.device``."""
    if place is None:
        return current_device()
    if isinstance(place, Place):
        return place.torch_device
    if isinstance(place, torch.device):
        return resolve_device(place)
    return _parse(str(place)).torch_device


def place_of(dev: torch.device) -> Place:
    return CPUPlace(0) if dev.type == "cpu" else CUDAPlace(dev.index or 0)


@contextlib.contextmanager
def device_guard(device):
    old = _CURRENT_DEVICE[0]
    set_device(device)
    try:
        yield
    finally:
        _CURRENT_DEVICE[0] = old


def device_count(device_type: str = "gpu") -> int:
    if device_type == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


is_compiled_with_tpu = is_compiled_with_cuda


def synchronize():
    """Block until the card's queued work is done."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
