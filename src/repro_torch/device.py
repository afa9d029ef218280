"""Device resolution and float64 helpers shared by the port.

Every entry point of ``repro_torch`` runs on the GPU unless the caller
asks for the CPU: ``resolve_device(None)`` is ``cuda`` and raises when no
GPU is visible, so nothing silently carries on on the CPU.  The table
math is float64 throughout (the simulator's exactness contract), so the
helpers here always name ``dtype=torch.float64`` explicitly — torch's
default float type is float32.
"""
from __future__ import annotations

from typing import Union

import torch

F64 = torch.float64
I64 = torch.int64

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA request without a visible GPU raises.
    Pass ``"cpu"`` to run on the CPU deliberately."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def f64(x, device) -> torch.Tensor:
    """``x`` (array, scalar, sequence or tensor) as a float64 tensor on
    ``device``."""
    return torch.as_tensor(x, dtype=F64, device=device)


def tensor_device(x, device: DeviceLike) -> torch.device:
    """The device an op on ``x`` runs on: a tensor's own device (which
    ``device``, when given, must match), else ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        if device is not None and torch.device(device).type != x.device.type:
            raise ValueError(
                f"tensor lies on {x.device}, but device={device!r} was "
                f"requested")
        return x.device
    return resolve_device(device)
