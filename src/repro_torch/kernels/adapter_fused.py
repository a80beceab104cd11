"""Launcher of the fused serial-adapter CUDA kernel (``csrc/adapter_fused.cu``).

The port of the reference's Pallas ``kernels/adapter_fused.py``. It takes CUDA
tensors only; ``kernels.ops.adapter_fused`` is the public entry, which sends a
CPU tensor to the plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

NAME = "adapter_fused"
ACTIVATIONS = {"gelu": 0, "relu": 1, "silu": 2}
DTYPES = (torch.bfloat16, torch.float32)
SMEM_LIMIT = 232_448   # bytes of shared memory one block may use on Hopper
ROWS, THREADS = 16, 256  # rows of h per block, threads per block (csrc/adapter_fused.cu)


def _lib():
    so = build.lib(NAME)
    fn = so.adapter_fused_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return so


def plan(D: int, m: int, dtype: torch.dtype) -> Tuple[bool, int]:
    """(stage, shared-memory bytes) of one block: the [16, D] h tile is staged
    in shared memory where it fits, else its rows are read from device memory."""
    base = 4 * (THREADS * ROWS + ROWS * m)             # partial sums + intermediate
    staged = base + torch.finfo(dtype).bits // 8 * ROWS * D
    return (True, staged) if staged <= SMEM_LIMIT else (False, base)


def check(h: torch.Tensor, w_down: torch.Tensor, w_up: torch.Tensor,
          activation: str) -> Tuple[bool, int]:
    """Raise unless the kernel takes these inputs (any device); return :func:`plan`."""
    if h.dim() != 2 or not h.is_contiguous():
        raise ValueError(f"h must be a contiguous [T, D] tensor, got {tuple(h.shape)}")
    T, D = h.shape
    m = w_down.shape[-1]
    if w_down.shape != (D, m) or w_up.shape != (m, D):
        raise ValueError(f"weights {tuple(w_down.shape)}, {tuple(w_up.shape)} "
                         f"do not fit h [T, {D}]")
    for t in (w_down, w_up):
        if t.device != h.device or not t.is_contiguous() or t.dtype != h.dtype:
            raise ValueError("weights must be contiguous, of h's dtype, on h's device")
    if h.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {h.dtype}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    stage, smem = plan(D, m, h.dtype)
    if not 1 <= m <= THREADS or smem > SMEM_LIMIT:
        raise ValueError(f"adapter_fused kernel does not take D={D}, m={m} in {h.dtype}")
    return stage, smem


def adapter_fused(h: torch.Tensor, w_down: torch.Tensor, w_up: torch.Tensor, *,
                  activation: str = "gelu") -> torch.Tensor:
    """h [T, D] -> h + act(h @ w_down) @ w_up; h and the weights are all bf16 or all f32."""
    if h.device.type != "cuda":
        raise ValueError("adapter_fused kernel takes CUDA tensors")
    stage, _ = check(h, w_down, w_up, activation)
    T, D = h.shape
    so = _lib()
    out = torch.empty_like(h)
    # too few row tiles to fill the card (decode): split the output columns
    row_tiles = -(-T // ROWS)
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    n_split = max(1, min(sms // max(row_tiles, 1), -(-D // 256)))
    err = so.adapter_fused_launch(
        h.data_ptr(), w_down.data_ptr(), w_up.data_ptr(), out.data_ptr(),
        T, D, w_down.shape[-1], int(h.dtype == torch.bfloat16), ACTIVATIONS[activation],
        int(stage), n_split, torch.cuda.current_stream(h.device).cuda_stream)
    build.check(NAME, err)
    return out
