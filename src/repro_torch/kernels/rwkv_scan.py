"""Launcher of the RWKV-6 wkv-recurrence CUDA kernel (``csrc/rwkv_scan.cu``).

The port of the reference's Pallas ``kernels/rwkv_scan.py``, and its backward
(training), :func:`rwkv_scan_bwd`, which recomputes the states from the
inputs and needs nothing saved by the forward. It takes CUDA
tensors only; ``kernels.ops.rwkv_scan`` is the public entry, which sends a CPU
tensor to the plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

NAME = "rwkv_scan"
HEAD_DIMS = (8, 16, 32, 64)


def _lib():
    so = build.lib(NAME)
    fn = so.rwkv_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bwd = so.rwkv_scan_bwd_launch
        bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
    return so


def check(r, k, v, lw, u, state0) -> None:
    """Raise unless the inputs are what the kernel takes (any device)."""
    if r.dim() != 3:
        raise ValueError(f"r must be [N, S, hd], got {tuple(r.shape)}")
    N, S, hd = r.shape
    if S < 1:
        raise ValueError("rwkv_scan kernel takes S >= 1")
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv_scan kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    want = {"k": (N, S, hd), "v": (N, S, hd), "lw": (N, S, hd), "u": (N, 1, hd),
            "state0": (N, hd, hd)}
    for name, t in zip(("r",) + tuple(want), (r, k, v, lw, u, state0)):
        if name != "r" and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} {tuple(t.shape)} does not fit r {tuple(r.shape)}")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != r.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on r's device")


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
              u: torch.Tensor, state0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw [N, S, hd]; u [N, 1, hd]; state0 [N, hd, hd] -> (out, final state)."""
    if r.device.type != "cuda":
        raise ValueError("rwkv_scan kernel takes CUDA tensors")
    check(r, k, v, lw, u, state0)
    if any(t.data_ptr() % 16 for t in (r, k, v, lw)):
        raise ValueError("rwkv_scan kernel takes r, k, v, lw at 16-byte aligned addresses")
    N, S, hd = r.shape
    out = torch.empty_like(r)
    state = torch.empty_like(state0)
    err = _lib().rwkv_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
        state0.data_ptr(), out.data_ptr(), state.data_ptr(), N, S, hd,
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check(NAME, err)
    return out, state


def rwkv_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
                  u: torch.Tensor, state0: torch.Tensor, dout: torch.Tensor,
                  ) -> Tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dlw, du, dstate0) of :func:`rwkv_scan` from its inputs
    and the cotangent ``dout`` [N, S, hd]; the final state's cotangent is
    zero. Deterministic: every sum runs in a fixed order."""
    if r.device.type != "cuda":
        raise ValueError("rwkv_scan_bwd kernel takes CUDA tensors")
    check(r, k, v, lw, u, state0)
    N, S, hd = r.shape
    if tuple(dout.shape) != (N, S, hd) or dout.dtype != torch.float32 \
            or not dout.is_contiguous() or dout.device != r.device:
        raise ValueError(f"dout must be a contiguous float32 {(N, S, hd)} tensor on r's "
                         f"device, got {tuple(dout.shape)} {dout.dtype}")
    dr, dk, dv, dlw = (torch.empty_like(r) for _ in range(4))
    du, ds0 = torch.empty_like(u), torch.empty_like(state0)
    err = _lib().rwkv_scan_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(),
        state0.data_ptr(), dout.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dlw.data_ptr(), du.data_ptr(), ds0.data_ptr(), N, S, hd,
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check(NAME, err)
    return dr, dk, dv, dlw, du, ds0
