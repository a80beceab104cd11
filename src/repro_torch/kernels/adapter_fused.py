"""Launcher of the fused serial-adapter CUDA kernels (``csrc/adapter_fused.cu``).

The port of the reference's Pallas ``kernels/adapter_fused.py``. Up to
``SMALL_T`` rows (decode) one thread block cluster of ``CLUSTER`` blocks
splits D (:func:`cluster_plan`, which also lays out each block's shared
memory for the kernel); above, one block per 16-row tile (:func:`plan`).
It takes CUDA tensors only; ``kernels.ops.adapter_fused`` is the public entry,
which sends a CPU tensor to the plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build

NAME = "adapter_fused"
ACTIVATIONS = {"gelu": 0, "relu": 1, "silu": 2}
DTYPES = (torch.bfloat16, torch.float32)
SMEM_LIMIT = 232_448   # bytes of shared memory one block may use on Hopper
ROWS, THREADS = 16, 256  # rows of h per block, threads per block (csrc/adapter_fused.cu)
# The decode path: blocks per cluster (CLUSTER in the source) and the most
# rows it takes (one 16-row tile), both chosen by timing them on the H100
# (PERF.md).
CLUSTER, SMALL_T = 16, 16


class ClusterPlan(NamedTuple):
    """One launch of the decode path: ``nt`` rows (the least power of two >=
    T), ``dc`` columns of D per block, and the block's shared memory in bytes:
    the offsets of its regions (``ClusterLayout`` in the source) and the total."""
    nt: int
    dc: int
    part: int
    mid: int
    hs: int
    wd: int
    wu: int
    smem: int


def _lib():
    so = build.lib(NAME)
    if so.adapter_fused_launch.argtypes is None:
        so.adapter_fused_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                            + [ctypes.c_void_p])
        so.adapter_fused_launch.restype = ctypes.c_int
        so.adapter_fused_cluster_launch.argtypes = ([ctypes.c_void_p] * 4
                                                    + [ctypes.c_int] * 13 + [ctypes.c_void_p])
        so.adapter_fused_cluster_launch.restype = ctypes.c_int
        so.adapter_fused_cluster_occupancy.argtypes = [ctypes.c_int] * 3
        so.adapter_fused_cluster_occupancy.restype = ctypes.c_int
    return so


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def plan(D: int, m: int, dtype: torch.dtype) -> Tuple[bool, int]:
    """(stage, shared-memory bytes) of one block of the tile path: the [16, D]
    h tile is staged in shared memory where it fits, else its rows are read
    from device memory."""
    base = 4 * (THREADS * ROWS + ROWS * m)             # partial sums + intermediate
    staged = base + torch.finfo(dtype).bits // 8 * ROWS * D
    return (True, staged) if staged <= SMEM_LIMIT else (False, base)


@functools.lru_cache(maxsize=None)
def cluster_plan(T: int, D: int, m: int, dtype: torch.dtype) -> Optional[ClusterPlan]:
    """The decode path's launch for h [T, D], or None where the tile path runs:
    above ``SMALL_T`` rows, or where a block's share of the weights does not
    fit in shared memory even with W_up in W_down's buffer.

    The layout, in bytes: the thread groups' fp32 partial sums [G][nt][m]
    (G * m <= THREADS) from 0, then ``part`` [nt][m] and ``mid`` [m][nt] in
    fp32, ``hs``, the block's columns of h [dc][nt] in fp32, then the block's
    rows of W_down ``wd`` [dc][m] and columns of W_up ``wu`` [m][dc] in h's
    type, 16-byte aligned; ``wu == wd`` where W_up takes W_down's buffer.
    Each block owns ceil(D / CLUSTER) columns, rounded up to 16 bytes.
    """
    if not 1 <= T <= SMALL_T or not 1 <= m <= THREADS:
        return None
    size = torch.finfo(dtype).bits // 8
    vec = 16 // size
    cols = -(-D // CLUSTER)
    dc = -(-cols // vec) * vec
    nt = 1 << (T - 1).bit_length()
    part = 4 * THREADS * nt
    mid = part + 4 * nt * m
    hs = mid + 4 * m * nt
    wd = -(-(hs + 4 * dc * nt) // 16) * 16
    weights = size * dc * m
    for wu in (wd + weights, wd):          # a buffer of its own, else W_down's
        if wu + weights <= SMEM_LIMIT:
            return ClusterPlan(nt, dc, part, mid, hs, wd, wu, wu + weights)
    return None


def cluster_size(T: int, D: int, m: int, dtype: torch.dtype) -> int:
    """Blocks per cluster of the decode path for h [T, D] (``CLUSTER``), or 0
    where the tile path runs (:func:`cluster_plan`)."""
    return CLUSTER if cluster_plan(T, D, m, dtype) else 0


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


def cluster_occupancy(T: int, D: int, m: int, dtype: torch.dtype) -> int:
    """How many decode-path clusters for h [T, D] the current card holds at
    once (``cudaOccupancyMaxActiveClusters``); 0 means none can launch."""
    p = cluster_plan(T, D, m, dtype)
    if p is None:
        raise ValueError(f"the decode path does not take h [{T}, {D}], m={m} in {dtype}")
    n = _lib().adapter_fused_cluster_occupancy(p.nt, int(dtype == torch.bfloat16), p.smem)
    build.check(NAME, -n if n < 0 else 0)
    return n


def adapter_fused(h: torch.Tensor, w_down: torch.Tensor, w_up: torch.Tensor, *,
                  activation: str = "gelu") -> torch.Tensor:
    """h [T, D] -> h + act(h @ w_down) @ w_up; h and the weights are all bf16 or all f32."""
    if h.device.type != "cuda":
        raise ValueError("adapter_fused kernel takes CUDA tensors")
    stage, _ = check(h, w_down, w_up, activation)
    T, D = h.shape
    m = w_down.shape[-1]
    so = _lib()
    out = torch.empty_like(h)
    bf16 = int(h.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    p = cluster_plan(T, D, m, h.dtype)
    if p is not None:
        err = so.adapter_fused_cluster_launch(
            h.data_ptr(), w_down.data_ptr(), w_up.data_ptr(), out.data_ptr(),
            T, D, m, bf16, ACTIVATIONS[activation], *p, stream)
    else:
        # too few row tiles to fill the card: split the output columns
        row_tiles = -(-T // ROWS)
        sms = _sm_count(h.device.index if h.device.index is not None
                        else torch.cuda.current_device())
        n_split = max(1, min(sms // max(row_tiles, 1), -(-D // 256)))
        err = so.adapter_fused_launch(
            h.data_ptr(), w_down.data_ptr(), w_up.data_ptr(), out.data_ptr(),
            T, D, m, bf16, ACTIVATIONS[activation], int(stage), n_split, stream)
    build.check(NAME, err)
    return out
