"""Launcher of the selective-SSM scan CUDA kernel (``csrc/mamba_scan.cu``).

The port of the reference's Pallas ``kernels/mamba_scan.py``: from a start
state (zero when none is given), ``s_t = exp(log_a_t) * s_{t-1} + b_t`` and
``y_t = sum_N s_t * c_t``; and its backward (training), :func:`mamba_scan_bwd`,
which recomputes the states a chunk of ``CHUNK`` steps at a time from the
checkpoints the forward writes with ``checkpoints=True``. It
takes CUDA tensors only; ``kernels.ops.mamba_scan`` is the public entry, which
sends a CPU tensor to the plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NAME = "mamba_scan"
STATE_SIZES = (1, 2, 4, 8, 16, 32)     # N: the lanes of one channel within a warp
# steps between the training checkpoints: CK in the source, which the library
# returns (mamba_scan_chunk); _lib checks the two agree when it first loads it
CHUNK = 16


def _lib():
    so = build.lib(NAME)
    fn = so.mamba_scan_launch
    if fn.argtypes is None:
        if so.mamba_scan_chunk() != CHUNK:
            raise RuntimeError(f"csrc/mamba_scan.cu's CK is {so.mamba_scan_chunk()}, "
                               f"CHUNK {CHUNK}")
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bwd = so.mamba_scan_bwd_launch
        bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        so.mamba_scan_bwd_blocks.argtypes = [ctypes.c_int] * 2
        so.mamba_scan_bwd_blocks.restype = ctypes.c_longlong
    return so


def check(log_a, b, c, state0=None) -> None:
    """Raise unless the inputs are what the kernel takes (any device)."""
    if log_a.dim() != 4:
        raise ValueError(f"log_a must be [B, S, D, N], got {tuple(log_a.shape)}")
    B, S, D, N = log_a.shape
    if S < 1:
        raise ValueError("mamba_scan kernel takes S >= 1")
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan kernel takes a state size N in {STATE_SIZES}, got {N}")
    given = (("b", b, (B, S, D, N)), ("c", c, (B, S, N)))
    if state0 is not None:
        given += (("state0", state0, (B, D, N)),)
    for name, t, want in given:
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)} does not fit log_a {tuple(log_a.shape)}")
    for name, t, _ in (("log_a", log_a, None),) + given:
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != log_a.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on log_a's device")


def mamba_scan(log_a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               state0: Optional[torch.Tensor] = None, *, checkpoints: bool = False):
    """log_a, b [B, S, D, N]; c [B, S, N]; state0 [B, D, N] or None (zero)
    -> (y [B, S, D], final state [B, D, N]), and with ``checkpoints`` also the
    state before every chunk of CHUNK steps, [B, ceil(S / CHUNK), D, N] (the
    backward's input)."""
    if log_a.device.type != "cuda":
        raise ValueError("mamba_scan kernel takes CUDA tensors")
    check(log_a, b, c, state0)
    B, S, D, N = log_a.shape
    y = torch.empty((B, S, D), dtype=torch.float32, device=log_a.device)
    state = torch.empty((B, D, N), dtype=torch.float32, device=log_a.device)
    ckpt = torch.empty((B, -(-S // CHUNK), D, N), dtype=torch.float32,
                       device=log_a.device) if checkpoints else None
    err = _lib().mamba_scan_launch(
        log_a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if state0 is None else state0.data_ptr(), y.data_ptr(), state.data_ptr(),
        None if ckpt is None else ckpt.data_ptr(),
        B, S, D, N, torch.cuda.current_stream(log_a.device).cuda_stream)
    build.check(NAME, err)
    return (y, state, ckpt) if checkpoints else (y, state)


def mamba_scan_bwd(log_a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, ckpt: torch.Tensor,
                   dy: torch.Tensor,
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dlog_a, db, dc, dstate0) of :func:`mamba_scan` from its inputs, its
    checkpoints ``ckpt`` (``checkpoints=True``; they hold the start state)
    and the cotangent ``dy`` [B, S, D]; the final state's cotangent is zero.
    Deterministic: dc's sum over D runs in a fixed order."""
    if log_a.device.type != "cuda":
        raise ValueError("mamba_scan_bwd kernel takes CUDA tensors")
    check(log_a, b, c)
    B, S, D, N = log_a.shape
    for name, t, want in (("ckpt", ckpt, (B, -(-S // CHUNK), D, N)), ("dy", dy, (B, S, D))):
        if tuple(t.shape) != want or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != log_a.device:
            raise ValueError(f"{name} must be a contiguous float32 {want} tensor on log_a's "
                             f"device, got {tuple(t.shape)} {t.dtype}")
    dla, db = torch.empty_like(log_a), torch.empty_like(b)
    dc = torch.empty_like(c)
    ds0 = torch.empty((B, D, N), dtype=torch.float32, device=log_a.device)
    lib = _lib()
    # the kernel's partial sums of dc, one per (row, block, t, n): the
    # library gives its block count
    part = torch.empty((B, lib.mamba_scan_bwd_blocks(D, N), S, N), dtype=torch.float32,
                       device=log_a.device)
    err = lib.mamba_scan_bwd_launch(
        log_a.data_ptr(), b.data_ptr(), c.data_ptr(), ckpt.data_ptr(), dy.data_ptr(),
        dla.data_ptr(), db.data_ptr(), dc.data_ptr(), ds0.data_ptr(), part.data_ptr(),
        B, S, D, N,
        torch.cuda.current_stream(log_a.device).cuda_stream)
    build.check(NAME, err)
    return dla, db, dc, ds0
