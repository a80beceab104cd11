"""Launchers of the flash-attention CUDA kernels (``csrc/flash_attention.cu``).

The port of the reference's Pallas ``kernels/flash_attention.py``, in the
model's layout: q [B, Sq, H, hd], k and v [B, Sk, K, hd], query head n reading
KV head n // (H // K). bf16 runs the tensor-core kernel, f32 the scalar one
(:func:`kernel_for`); with ``lse=True`` it also returns each row's logsumexp
for :func:`flash_attention_bwd`, the backward (training; sinks included): bf16 on
the tensor cores, its dK/dV blocks splitting the GQA group where the card
would otherwise sit idle (:func:`bwd_parts`), f32 the scalar kernels. It takes
CUDA tensors only; ``kernels.ops.flash_attention`` is the public entry, which
sends a CPU tensor to the plain versions in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from repro_torch import device as dev_rule
from repro_torch.kernels import build

NAME = "flash_attention"
HEAD_DIMS = (64, 80, 128)
# rows of the bf16 backward's tiles: keys per dK/dV block. BT in the source,
# which the library returns (flash_attention_bwd_tile); _bwd_launcher checks
# the two agree when it first loads the library
BWD_TILE = 64
# dtype -> (kernel, its C launcher in csrc/flash_attention.cu)
KERNELS = {torch.bfloat16: ("tensor_cores", "flash_attention_tc_launch"),
           torch.float32: ("scalar", "flash_attention_launch")}


def _launcher(dtype: torch.dtype):
    fn = getattr(build.lib(NAME), KERNELS[dtype][1])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_launcher():
    lib = build.lib(NAME)
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        if lib.flash_attention_bwd_tile() != BWD_TILE:
            raise RuntimeError(f"csrc/flash_attention.cu's BT is "
                               f"{lib.flash_attention_bwd_tile()}, BWD_TILE {BWD_TILE}")
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def kernel_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes these inputs on the card ("tensor_cores" for bf16,
    "scalar" for f32); raise ValueError for any input neither takes. Reads
    shapes, dtypes and strides only, so it runs on any device."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         f"expected [B, S, H, hd] and [B, S, K, hd]")
    B, Sq, H, hd = q.shape
    Bk, Sk, K, hdk = k.shape
    if Bk != B or hdk != hd or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if q.dtype not in KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {tuple(KERNELS)}")
    for t in (q, k, v):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError("q, k, v must lie on one device with a unit last stride")
    return KERNELS[q.dtype][0]


def _aligned(t: torch.Tensor) -> bool:
    """16-byte rows, as the tensor-core kernel's cp.async copies need them."""
    strides = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in strides)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    n_sink: int = 0, lse: bool = False,
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal (end-aligned), optionally windowed GQA attention; returns [B, Sq, H, hd].

    With a window, the first ``n_sink`` keys (attention sinks) pass the window
    test. ``lse=True`` (training) also returns each row's logsumexp
    of the scaled scores, fp32 [B, H, Sq] (-inf where a row sees no key).
    """
    if q.device.type != "cuda":
        raise ValueError("flash_attention kernel takes CUDA tensors")
    kernel = kernel_for(q, k, v)
    if kernel == "tensor_cores" and not all(map(_aligned, (q, k, v))):
        raise ValueError("the bf16 kernel needs 16-byte aligned q, k, v with strides "
                         "that are multiples of 8 elements")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if n_sink < 0:
        raise ValueError(f"n_sink must be >= 0, got {n_sink}")
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    row_lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if lse else None
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = _launcher(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if row_lse is None else row_lse.data_ptr(),
        B, H, K, Sq, Sk, hd, *strides, int(causal), window or 0, n_sink,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(NAME, err)
    return (out, row_lse) if lse else out


def bwd_parts(B: int, Sk: int, K: int, group: int, sms: int) -> int:
    """How many slices of each GQA group the bf16 backward's dK/dV blocks
    take: the fewest (dividing ``group``) that start at least two blocks per
    SM (one block per (64-key tile, slice, KV head, batch row)), else one per
    query head. One slice writes dK and dV directly; more write fp32 partial
    sums that a second pass adds in order. qwen2.5-3b's training shape (B 4,
    Sk 512, K 2, group 8): 8 slices, 512 blocks; stablelm-3b's (group 1): 1.

    "Two blocks per SM" rests on csrc/flash_attention.cu's
    attention_bwd_dkdv_tc_kernel: THREADS = 128 threads under
    ``__launch_bounds__(THREADS)`` (at most 255 registers, so two blocks fit
    in the 64 K registers), and launch_bwd_tc's ``smem_dkdv`` = 6 BT tile_ld
    bf16 + 4 BT fp32 (99 KB at hd 128, the widest; two fit in 228 KB). A
    change to either there changes this rule."""
    blocks = -(-Sk // BWD_TILE) * K * B
    return next(p for p in range(1, group + 1)
                if group % p == 0 and (blocks * p >= 2 * sms or p == group))


def _dense16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the bf16 kernels' cp.async rows)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None, n_sink: int = 0,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` (with a window, the first
    ``n_sink`` keys passing its test, as there) from its output
    ``out``, its row logsumexp ``lse`` [B, H, Sq] fp32 and the cotangent
    ``dout`` [B, Sq, H, hd]; shapes and dtypes as the forward's. Inputs are
    made contiguous (the kernels read the model's layout with fixed strides).
    bf16 splits the GQA group into :func:`bwd_parts` parts. Raises ValueError
    for inputs the kernels do not take (any device first, then anything but
    CUDA tensors)."""
    kernel_for(q, k, v)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not match q "
                             f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be fp32 [B, H, Sq] = {(B, H, Sq)} on q's device, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if n_sink < 0:
        raise ValueError(f"n_sink must be >= 0, got {n_sink}")
    if q.device.type != "cuda":
        raise ValueError("flash_attention_bwd kernel takes CUDA tensors")
    bf16 = q.dtype == torch.bfloat16
    parts = bwd_parts(B, Sk, K, H // K, dev_rule.sm_count(q.device)) if bf16 else 1
    q, k, v, out, dout, lse = (_dense16(t) for t in (q, k, v, out, dout, lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    work = torch.empty((2, parts, B, Sk, K, hd), dtype=torch.float32,
                       device=q.device) if parts > 1 else None
    err = _bwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if work is None else work.data_ptr(),
        B, H, K, Sq, Sk, hd, int(bf16), int(causal), window or 0, n_sink, parts,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(NAME, err)
    return dq, dk, dv
