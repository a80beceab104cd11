"""The device rule of the port's entry points.

``BatchServer``, ``materialize``, the serve and train CLIs and ``train`` run
on ``cuda`` unless the caller asks for the CPU. Without a card they raise
instead of falling back.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card is an error."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless it "
            "is given device='cpu'")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (the kernels size grids by it)."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())
