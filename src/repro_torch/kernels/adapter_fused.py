"""Launcher of the fused serial-adapter CUDA kernels (``csrc/adapter_fused.cu``).

The port of the reference's Pallas ``kernels/adapter_fused.py``. Up to
``SMALL_T`` rows (decode) one thread block cluster of ``CLUSTER`` blocks
splits D (:func:`cluster_plan`, which also lays out each block's shared
memory for the kernel). Above, bf16 runs tiles of 64 rows on the tensor
cores, each tile one cluster of up to 16 blocks that splits D
(:func:`tile_plan`); f32, and the bf16 inputs the tile path does not take,
run one block per 16-row tile on the CUDA cores (:func:`plan`).
:func:`route` says which by shape, :func:`check` by shape and alignment.
:func:`adapter_fused_bwd` is the backward (training): bf16 on 64-row tiles,
each one cluster that splits D, on the tensor cores (:func:`bwd_tile_plan`);
f32, and the bf16 inputs no plan takes, on the 16-row CUDA-core kernel
(:func:`bwd_route` by shape, :func:`bwd_check` by shape and alignment).
It takes CUDA tensors only; ``kernels.ops.adapter_fused`` is the public entry,
which sends a CPU tensor to the plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import device as dev_rule
from repro_torch.kernels import build

NAME = "adapter_fused"
ACTIVATIONS = {"gelu": 0, "relu": 1, "silu": 2}
DTYPES = (torch.bfloat16, torch.float32)
SMEM_LIMIT = 232_448   # bytes of shared memory one block may use on Hopper
SM_SMEM = 233_472      # bytes of shared memory on an SM (1024 of them reserved per block)
ROWS, THREADS = 16, 256  # rows of h per block, threads per block (csrc/adapter_fused.cu)
# The decode path: blocks per cluster (CLUSTER in the source) and the most
# rows it takes (one 16-row tile), both chosen by timing them on the H100
# (PERF.md).
CLUSTER, SMALL_T = 16, 16
# The bf16 prefill path: rows per tile (one wgmma's 64), the blocks per
# cluster the kernel takes (dividing 64; above 8 non-portable; ``tile_plan``
# uses 8 and 16, ``launch/kernel_times.py --plans`` times them all) and the
# most 64-column chunks of D one block owns; and the largest m (one column of
# each thread's partial sums in the f32 kernel).
TILE_ROWS = 64
TILE_CLUSTERS = (1, 2, 4, 8, 16)
TILE_CHUNKS = 8
MAX_M = THREADS


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


class TilePlan(NamedTuple):
    """One launch of the bf16 prefill path: tiles of ``TILE_ROWS`` rows, each
    one cluster of ``cluster`` blocks owning ``dc`` columns of D (a multiple
    of 64), m padded to ``mp`` (a multiple of 16), and the block's shared
    memory in bytes: the offsets of its regions (``TileLayout`` in the
    source) and the total."""
    cluster: int
    dc: int
    mp: int
    hs: int
    wd: int
    wu: int
    part: int
    hi: int
    lo: int
    bar: int
    smem: int


class BwdTilePlan(NamedTuple):
    """One launch of the bf16 backward's tile path: tiles of ``TILE_ROWS``
    rows, each one cluster of ``cluster`` blocks owning ``dc`` columns of D (a
    multiple of 64), m padded to ``mp`` (a multiple of 16), and the block's
    shared memory in bytes: the offsets of its regions (``BwdTileLayout`` in
    the source) and the total."""
    cluster: int
    dc: int
    mp: int
    hs: int
    gs: int
    wd: int
    wu: int
    pz: int
    pu: int
    hi: int
    lo: int
    bar: int
    smem: int


class Route(NamedTuple):
    """Which kernel a call takes: ``"cluster"`` (decode, ``plan`` a
    :class:`ClusterPlan`), ``"tile"`` (bf16 prefill, a :class:`TilePlan`), or
    the 16-row CUDA-core kernel, ``"staged"`` or ``"rows"`` (``plan`` its
    shared-memory bytes)."""
    kernel: str
    plan: object


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
        so.adapter_fused_tile_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                                                 + [ctypes.c_void_p])
        so.adapter_fused_tile_launch.restype = ctypes.c_int
        so.adapter_fused_tile_occupancy.argtypes = [ctypes.c_int] * 2
        so.adapter_fused_tile_occupancy.restype = ctypes.c_int
        so.adapter_fused_bwd_launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                                + [ctypes.c_void_p])
        so.adapter_fused_bwd_launch.restype = ctypes.c_int
        so.adapter_fused_bwd_tile_launch.argtypes = ([ctypes.c_void_p] * 7
                                                     + [ctypes.c_int] * 17 + [ctypes.c_void_p])
        so.adapter_fused_bwd_tile_launch.restype = ctypes.c_int
        so.adapter_fused_bwd_tile_occupancy.argtypes = [ctypes.c_int] * 2
        so.adapter_fused_bwd_tile_occupancy.restype = ctypes.c_int
    return so


@functools.lru_cache(maxsize=None)
def plan(D: int, m: int, dtype: torch.dtype) -> Tuple[bool, int]:
    """(stage, shared-memory bytes) of one block of the 16-row CUDA-core
    kernel: in f32 the [16, D] h tile is staged in shared memory where it
    fits, else (and always in bf16, which takes this kernel only where no tile
    plan fits) its rows are read from device memory."""
    base = 4 * (THREADS * ROWS + ROWS * m)             # partial sums + intermediate
    staged = base + 4 * ROWS * D
    return (True, staged) if dtype == torch.float32 and staged <= SMEM_LIMIT else (False, base)


def _up16(x: int, n: int = 16) -> int:
    return -(-x // n) * n


@functools.lru_cache(maxsize=None)
def tile_layout(D: int, m: int, cluster: int) -> Optional[TilePlan]:
    """The bf16 prefill path's shared memory for tiles of ``TILE_ROWS`` rows
    split over clusters of ``cluster`` blocks, or None where it does not fit.

    Each block owns ceil(D / cluster) columns rounded up to 64 (``dc``, at
    most ``TILE_CHUNKS`` chunks of 64); m is padded to 16 (``mp``). The
    regions, in bytes from the first 1024-byte aligned address of the block's
    shared memory (1024 bytes are set aside for that): the block's slice of h
    ``hs`` [64, dc], its rows of W_down ``wd`` [dc, m padded to 64] and its
    columns of W_up ``wu`` [mp, dc], each in bf16 as 64-column chunks of
    128-byte rows in the TMA's 128-byte swizzle (1024-byte aligned); the
    cluster's partial sums of the block's rows of the intermediate ``part``
    [cluster][64 / cluster][mp + 8] in fp32; the intermediate's bf16 parts
    ``hi`` and ``lo`` [64][mp + 8]; ``bar``, the mbarriers. W_down is read
    only before the cluster's first barrier, so W_up may take its buffer
    (``wu == wd``, loaded after that barrier). Of the two layouts, the one
    that lets more blocks share an SM (:func:`blocks_per_sm`), else W_up in
    a buffer of its own, loaded with h.
    """
    if cluster not in TILE_CLUSTERS or not 1 <= m <= MAX_M:
        return None
    bt, mp, mp64 = TILE_ROWS, _up16(m), _up16(m, 64)
    dc = _up16(-(-D // cluster), 64)
    if dc > 64 * TILE_CHUNKS:
        return None
    hs, wd = 0, 2 * bt * dc
    w_down, w_up = 2 * mp64 * dc, 2 * mp * dc
    part_n, mid_n, bar_n = 4 * bt * (mp + 8), 2 * bt * (mp + 8), _up16(8 * (TILE_CHUNKS + 1))
    plans = []
    for wu, part in ((wd + w_down, wd + w_down + w_up),     # W_up in a buffer of its own
                     (wd, wd + max(w_down, w_up))):         # W_up in W_down's
        hi = part + part_n
        bar = hi + 2 * mid_n
        plans.append(TilePlan(cluster, dc, mp, hs, wd, wu, part, hi, hi + mid_n, bar,
                              1024 + bar + bar_n))
    plans = [p for p in plans if p.smem <= SMEM_LIMIT]
    return min(plans, key=lambda p: (-blocks_per_sm(p.smem), p.wu == p.wd), default=None)


def blocks_per_sm(smem: int) -> int:
    """Blocks of the bf16 prefill path one SM holds with ``smem`` bytes of
    shared memory each: at most 2 (its register budget, 128 a thread)."""
    return min(2, SM_SMEM // (smem + 1024))


@functools.lru_cache(maxsize=None)
def tile_plan(T: int, D: int, m: int) -> Optional[TilePlan]:
    """The bf16 prefill path's launch for h [T, D] (T > ``SMALL_T``), or None
    where the path does not take the shape: D or m not a multiple of 8 (the
    TMA moves 16-byte rows), or no plan fits (m above 128 at wide D: m 256
    above D 2048). No model of the configs has such a shape; the 16-row
    CUDA-core kernel takes it.

    Clusters of 8 blocks where two fit on an SM, else of 16 (at the served
    shapes: 8 at D 1600 and 2048, 16 at D 4096), the plan that timed fastest
    on the H100 (``launch/kernel_times.py --plans``, PERF.md). A smaller
    cluster only gives each block more columns, so none fits where 16 do not.
    """
    if T <= SMALL_T or D % 8 or m % 8:
        return None
    eight = tile_layout(D, m, 8)
    if eight is not None and blocks_per_sm(eight.smem) == 2:
        return eight
    return tile_layout(D, m, 16)


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


def route(T: int, D: int, m: int, dtype: torch.dtype) -> Route:
    """The kernel that runs h [T, D] with bottleneck m, decided by shape alone."""
    p = cluster_plan(T, D, m, dtype)
    if p is not None:
        return Route("cluster", p)
    if dtype == torch.bfloat16:
        t = tile_plan(T, D, m)
        if t is not None:
            return Route("tile", t)
    stage, smem = plan(D, m, dtype)
    return Route("staged" if stage else "rows", smem)


def check(h: torch.Tensor, w_down: torch.Tensor, w_up: torch.Tensor,
          activation: str) -> Route:
    """Raise unless the kernels take these inputs (any device); return
    :func:`route`, but the 16-row kernel for bf16 tile-path inputs whose data
    is not 16-byte aligned."""
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
    if not 1 <= m <= MAX_M:
        raise ValueError(f"adapter_fused kernel does not take D={D}, m={m} in {h.dtype}")
    r = route(T, D, m, h.dtype)
    if r.kernel == "tile" and any(t.data_ptr() % 16 for t in (h, w_down, w_up)):
        # the TMA takes 16-byte aligned rows only (views at an odd offset)
        return Route("rows", plan(D, m, h.dtype)[1])
    return r


def cluster_occupancy(T: int, D: int, m: int, dtype: torch.dtype) -> int:
    """How many decode-path clusters for h [T, D] the current card holds at
    once (``cudaOccupancyMaxActiveClusters``); 0 means none can launch."""
    p = cluster_plan(T, D, m, dtype)
    if p is None:
        raise ValueError(f"the decode path does not take h [{T}, {D}], m={m} in {dtype}")
    n = _lib().adapter_fused_cluster_occupancy(p.nt, int(dtype == torch.bfloat16), p.smem)
    build.check(NAME, -n if n < 0 else 0)
    return n


def tile_occupancy(p: TilePlan) -> int:
    """How many clusters of the bf16 prefill path with plan ``p`` the current
    card holds at once (``cudaOccupancyMaxActiveClusters``); 0: none launch."""
    n = _lib().adapter_fused_tile_occupancy(p.cluster, p.smem)
    build.check(NAME, -n if n < 0 else 0)
    return n


def launch_tile(h: torch.Tensor, w_down: torch.Tensor, w_up: torch.Tensor, p: TilePlan, *,
                activation: str = "gelu") -> torch.Tensor:
    """The bf16 prefill path with plan ``p`` (:func:`tile_plan` chooses it;
    ``launch/kernel_times.py --plans`` times the others); inputs as
    :func:`adapter_fused`'s, bf16, checked by the kernel's launcher."""
    T, D = h.shape
    out = torch.empty_like(h)
    err = _lib().adapter_fused_tile_launch(
        h.data_ptr(), w_down.data_ptr(), w_up.data_ptr(), out.data_ptr(), T, D,
        w_down.shape[-1], ACTIVATIONS[activation], *p,
        torch.cuda.current_stream(h.device).cuda_stream)
    build.check(NAME, err)
    return out


def adapter_fused(h: torch.Tensor, w_down: torch.Tensor, w_up: torch.Tensor, *,
                  activation: str = "gelu") -> torch.Tensor:
    """h [T, D] -> h + act(h @ w_down) @ w_up; h and the weights are all bf16 or all f32."""
    if h.device.type != "cuda":
        raise ValueError("adapter_fused kernel takes CUDA tensors")
    kernel, p = check(h, w_down, w_up, activation)
    if kernel == "tile":
        return launch_tile(h, w_down, w_up, p, activation=activation)
    T, D = h.shape
    m = w_down.shape[-1]
    so = _lib()
    out = torch.empty_like(h)
    bf16 = int(h.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    if kernel == "cluster":
        err = so.adapter_fused_cluster_launch(
            h.data_ptr(), w_down.data_ptr(), w_up.data_ptr(), out.data_ptr(),
            T, D, m, bf16, ACTIVATIONS[activation], *p, stream)
    else:
        # too few row tiles to fill the card: split the output columns
        row_tiles = -(-T // ROWS)
        sms = dev_rule.sm_count(h.device)
        n_split = max(1, min(sms // max(row_tiles, 1), -(-D // 256)))
        err = so.adapter_fused_launch(
            h.data_ptr(), w_down.data_ptr(), w_up.data_ptr(), out.data_ptr(),
            T, D, m, bf16, ACTIVATIONS[activation], int(kernel == "staged"), n_split, stream)
    build.check(NAME, err)
    return out


@functools.lru_cache(maxsize=None)
def bwd_tile_layout(D: int, m: int, cluster: int) -> Optional[BwdTilePlan]:
    """The bf16 backward's shared memory for tiles of ``TILE_ROWS`` rows split
    over clusters of ``cluster`` blocks, or None where it does not fit.

    Each block owns ceil(D / cluster) columns rounded up to 64 (``dc``, at
    most ``TILE_CHUNKS`` chunks of 64); m is padded to 16 (``mp``). The
    regions, in bytes from the first 1024-byte aligned address of the block's
    shared memory (1024 bytes are set aside for that), each with room of its
    own: the block's slices of h ``hs`` and of g ``gs`` [64, dc] (g's then
    stages dh), its rows of W_down ``wd`` [dc, m padded to 64] and its columns
    of W_up ``wu`` [mp, dc], each in bf16 as 64-column chunks of 128-byte rows
    in the TMA's 128-byte swizzle (1024-byte aligned); the cluster's partial
    sums of the block's rows of z = h @ W_down ``pz`` and of u = g @ W_up^T
    ``pu``, each [cluster][64 / cluster][mp + 8] in fp32; g_mid's bf16 parts
    ``hi`` and ``lo`` [64][mp + 8]; ``bar``, the mbarriers.
    """
    if cluster not in TILE_CLUSTERS or not 1 <= m <= MAX_M:
        return None
    bt, mp, mp64 = TILE_ROWS, _up16(m), _up16(m, 64)
    dc = _up16(-(-D // cluster), 64)
    if dc > 64 * TILE_CHUNKS:
        return None
    part_n, mid_n = 4 * bt * (mp + 8), 2 * bt * (mp + 8)
    hs, gs = 0, 2 * bt * dc
    wd = gs + 2 * bt * dc
    wu = wd + 2 * mp64 * dc
    pz = wu + 2 * mp * dc
    pu = pz + part_n
    hi = pu + part_n
    lo = hi + mid_n
    bar = lo + mid_n
    smem = 1024 + bar + _up16(8 * TILE_CHUNKS)
    if smem > SMEM_LIMIT:
        return None
    return BwdTilePlan(cluster, dc, mp, hs, gs, wd, wu, pz, pu, hi, lo, bar, smem)


@functools.lru_cache(maxsize=None)
def bwd_tile_plan(T: int, D: int, m: int) -> Optional[BwdTilePlan]:
    """The bf16 backward's tile launch for g, h [T, D] (any T: up to 64 rows
    are one ragged tile), or None where the tile path does not take the
    shape: D or m not a multiple of 8 (the TMA moves 16-byte rows), or no
    plan fits (m 128 above D 2048, m 256 at any D; no model of the configs
    has such a shape). The 16-row CUDA-core kernel takes those.

    Clusters of 8 blocks where they fit, else of 16: every plan that fits
    gives one block an SM (its shared memory), and 8 timed faster than 16 at
    every training width where both fit (1600, 2048, 2560:
    ``launch/kernel_times.py --plans``, PERF.md).
    """
    if D % 8 or m % 8:
        return None
    for cluster in (8, 16):
        p = bwd_tile_layout(D, m, cluster)
        if p is not None:
            return p
    return None


def bwd_route(T: int, D: int, m: int, dtype: torch.dtype) -> Route:
    """The backward kernel that runs g, h [T, D] with bottleneck m, decided by
    shape alone: ``"tile"`` (bf16 wherever :func:`bwd_tile_plan` fits,
    ``plan`` a :class:`BwdTilePlan`) or ``"rows"``, the 16-row CUDA-core
    kernel (f32, and the bf16 shapes no plan takes; ``plan`` None: its
    launcher sizes its shared memory)."""
    if dtype == torch.bfloat16:
        p = bwd_tile_plan(T, D, m)
        if p is not None:
            return Route("tile", p)
    return Route("rows", None)


def bwd_check(g: torch.Tensor, h: torch.Tensor, w_down: torch.Tensor, w_up: torch.Tensor,
              activation: str) -> Route:
    """Raise unless the backward kernels take these inputs (any device);
    return :func:`bwd_route`, but the 16-row kernel for tile-path inputs
    whose data is not 16-byte aligned."""
    check(h, w_down, w_up, activation)
    if g.shape != h.shape or g.dtype != h.dtype or g.device != h.device or \
            not g.is_contiguous():
        raise ValueError(f"g must be a contiguous {tuple(h.shape)} {h.dtype} tensor on h's "
                         f"device, got {tuple(g.shape)} {g.dtype}")
    T, D = h.shape
    m = w_down.shape[-1]
    r = bwd_route(T, D, m, h.dtype)
    if r.kernel == "tile" and any(t.data_ptr() % 16 for t in (g, h, w_down, w_up)):
        return Route("rows", None)    # the TMA takes 16-byte aligned rows only
    return r


def bwd_tile_occupancy(p: BwdTilePlan) -> int:
    """How many clusters of the bf16 backward's tile path with plan ``p`` the
    current card holds at once (``cudaOccupancyMaxActiveClusters``); 0: none
    launch."""
    n = _lib().adapter_fused_bwd_tile_occupancy(p.cluster, p.smem)
    build.check(NAME, -n if n < 0 else 0)
    return n


def launch_bwd_tile(g: torch.Tensor, h: torch.Tensor, w_down: torch.Tensor,
                    w_up: torch.Tensor, p: BwdTilePlan, *, activation: str = "gelu",
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 backward's tile path with plan ``p`` (:func:`bwd_tile_plan`
    chooses it; ``launch/kernel_times.py --plans`` times the others); inputs
    and outputs as :func:`adapter_fused_bwd`'s, bf16, checked by the kernel's
    launcher."""
    T, D = h.shape
    m = w_down.shape[-1]
    dh = torch.empty_like(h)
    mid = torch.empty((T, m), dtype=torch.float32, device=h.device)
    g_mid = torch.empty_like(mid)
    err = _lib().adapter_fused_bwd_tile_launch(
        g.data_ptr(), h.data_ptr(), w_down.data_ptr(), w_up.data_ptr(), dh.data_ptr(),
        mid.data_ptr(), g_mid.data_ptr(), T, D, m, ACTIVATIONS[activation], *p,
        torch.cuda.current_stream(h.device).cuda_stream)
    build.check(NAME, err)
    return dh, mid, g_mid


def launch_bwd_rows(g: torch.Tensor, h: torch.Tensor, w_down: torch.Tensor,
                    w_up: torch.Tensor, *, activation: str = "gelu",
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The 16-row CUDA-core backward (``adapter_bwd_kernel``), bf16 or f32:
    the route of f32 and of the bf16 inputs no tile plan takes
    (``launch/grad_gap.py`` also runs it where the tile path would); inputs
    and outputs as :func:`adapter_fused_bwd`'s, checked by the kernel's
    launcher."""
    T, D = h.shape
    m = w_down.shape[-1]
    dh = torch.empty_like(h)
    mid = torch.empty((T, m), dtype=torch.float32, device=h.device)
    g_mid = torch.empty_like(mid)
    err = _lib().adapter_fused_bwd_launch(
        g.data_ptr(), h.data_ptr(), w_down.data_ptr(), w_up.data_ptr(), dh.data_ptr(),
        mid.data_ptr(), g_mid.data_ptr(), T, D, m, int(h.dtype == torch.bfloat16),
        ACTIVATIONS[activation], torch.cuda.current_stream(h.device).cuda_stream)
    build.check(NAME, err)
    return dh, mid, g_mid


def adapter_fused_bwd(g: torch.Tensor, h: torch.Tensor, w_down: torch.Tensor,
                      w_up: torch.Tensor, *, activation: str = "gelu",
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`adapter_fused` for the cotangent ``g`` [T, D]:
    (dh [T, D] in h's dtype, mid = act(h @ w_down) and g_mid = (g @ w_up^T) *
    act'(h @ w_down), both [T, m] fp32). The weight gradients are the plain
    products mid^T g and h^T g_mid (``kernels.ops`` forms them). The kernel is
    :func:`bwd_check`'s."""
    kernel, p = bwd_check(g, h, w_down, w_up, activation)
    if h.device.type != "cuda":
        raise ValueError("adapter_fused_bwd kernel takes CUDA tensors")
    if kernel == "tile":
        return launch_bwd_tile(g, h, w_down, w_up, p, activation=activation)
    return launch_bwd_rows(g, h, w_down, w_up, activation=activation)
