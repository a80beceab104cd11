"""Public entries of the port's kernels: device dispatch and launch counters.

One rule for every kernel: a CPU tensor goes to the plain version in
``kernels/ref.py``; a CUDA tensor goes to the hand-written kernel, or the
launcher raises. ``impl="plain"`` forces the plain version on any device; it
exists for holding a kernel against its plain version (the tests and
``chip_smoke.py``), and nothing on the serving path selects it.

``LAUNCHES`` counts kernel launches, one per call that reached a kernel, so a
run can show that its path went through the kernels.

Gradients: where an input of ``adapter_fused`` or ``flash_attention`` needs
one, the call goes through a ``torch.autograd.Function`` whose backward is the
backward kernel on a CUDA tensor (counted as ``adapter_fused_bwd`` and
``flash_attention_bwd``) and the plain backward of ``kernels/ref.py`` on a CPU
tensor or under ``impl="plain"``. Where no input needs one (serving, the
frozen trunk under ``torch.no_grad``), the call is the forward alone: nothing
is saved and no row logsumexp is written. The scans (``rwkv_scan``,
``mamba_scan``) have no backward kernel yet: a call on a CUDA tensor that
needs a gradient raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import adapter_fused as _af
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import rwkv_scan as _rs
from repro_torch.kernels import ref

IMPLS = ("kernel", "plain")
LAUNCHES: Dict[str, int] = {"adapter_fused": 0, "adapter_fused_bwd": 0,
                            "flash_attention": 0, "flash_attention_bwd": 0,
                            "mamba_scan": 0, "rwkv_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _use_kernel(x: torch.Tensor, impl: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "kernel" and x.device.type != "cpu"


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _adapter_forward(h2: torch.Tensor, w_down: torch.Tensor, w_up: torch.Tensor,
                     activation: str, kernel: bool) -> torch.Tensor:
    if not kernel:
        return ref.adapter_fused(h2, w_down, w_up, activation=activation)
    out = _af.adapter_fused(h2.contiguous(), w_down, w_up, activation=activation)
    LAUNCHES["adapter_fused"] += 1
    return out


def adapter_weight_grads(h: torch.Tensor, g: torch.Tensor, mid: torch.Tensor,
                         g_mid: torch.Tensor, dtype: torch.dtype,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW_down, dW_up) = (h^T g_mid, mid^T g) in fp32, rounded to ``dtype``,
    from the backward kernel's fp32 mid and g_mid: two plain products, which
    the reference's autodiff forms outside its Pallas kernel too."""
    return (h.float().t() @ g_mid).to(dtype), (mid.t() @ g.float()).to(dtype)


class _AdapterFused(torch.autograd.Function):
    """adapter_fused with its backward; h [T, D]."""

    @staticmethod
    def forward(ctx, h, w_down, w_up, activation: str, kernel: bool):
        ctx.activation, ctx.kernel = activation, kernel
        ctx.save_for_backward(h, w_down, w_up)
        return _adapter_forward(h, w_down, w_up, activation, kernel)

    @staticmethod
    def backward(ctx, g):
        h, w_down, w_up = ctx.saved_tensors
        if not ctx.kernel:
            dh, dw_down, dw_up = ref.adapter_fused_bwd(g, h, w_down, w_up,
                                                       activation=ctx.activation)
            return dh, dw_down, dw_up, None, None
        g = g.contiguous()
        dh, mid, g_mid = _af.adapter_fused_bwd(g, h.contiguous(), w_down, w_up,
                                               activation=ctx.activation)
        LAUNCHES["adapter_fused_bwd"] += 1
        dw_down, dw_up = adapter_weight_grads(h, g, mid, g_mid, w_down.dtype)
        return dh, dw_down, dw_up, None, None


def adapter_fused(h: torch.Tensor, w_down: torch.Tensor, w_up: torch.Tensor, *,
                  activation: str = "gelu", impl: str = "kernel") -> torch.Tensor:
    """h [..., D] — leading dims flattened for the kernel and restored."""
    kernel = _use_kernel(h, impl)
    shape = h.shape
    h2 = h.reshape(-1, shape[-1])
    if _needs_grad(h, w_down, w_up):
        return _AdapterFused.apply(h2, w_down, w_up, activation, kernel).reshape(shape)
    if not kernel:
        return ref.adapter_fused(h, w_down, w_up, activation=activation)
    return _adapter_forward(h2, w_down, w_up, activation, kernel).reshape(shape)


class _FlashAttention(torch.autograd.Function):
    """flash_attention with its backward (no sinks)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int], kernel: bool):
        if kernel:
            out, lse = _fa.flash_attention(q, k, v, causal=causal, window=window, lse=True)
            LAUNCHES["flash_attention"] += 1
        else:
            out, lse = ref.flash_attention(q, k, v, causal=causal, window=window, lse=True)
        ctx.causal, ctx.window, ctx.kernel = causal, window, kernel
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = _fa.flash_attention_bwd if ctx.kernel else ref.flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, dout, causal=ctx.causal, window=ctx.window)
        if ctx.kernel:
            LAUNCHES["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None, n_sink: int = 0,
                    impl: str = "kernel") -> torch.Tensor:
    """q [B, Sq, H, hd]; k, v [B, Sk, K, hd]; returns [B, Sq, H, hd]. With a
    window, the first ``n_sink`` keys pass the window test (attention sinks)."""
    kernel = _use_kernel(q, impl)
    if _needs_grad(q, k, v):
        if n_sink:
            raise NotImplementedError(
                "no backward with attention sinks yet: hymba training is ROADMAP.md "
                "Queue 1, item 12")
        return _FlashAttention.apply(q, k, v, causal, window, kernel)
    if not kernel:
        return ref.flash_attention(q, k, v, causal=causal, window=window, n_sink=n_sink)
    out = _fa.flash_attention(q, k, v, causal=causal, window=window, n_sink=n_sink)
    LAUNCHES["flash_attention"] += 1
    return out


# the scans' kernels have no backward: on the card their output would carry no
# gradient, so a call that needs one is refused
_NO_SCAN_BWD = ("{} has no backward kernel yet: {} training is ROADMAP.md Queue 1, item 12")


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
              u: torch.Tensor, state0: torch.Tensor, *,
              impl: str = "kernel") -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw [N, S, hd] fp32; u [N, 1, hd]; state0 [N, hd, hd] -> (out, state)."""
    if not _use_kernel(r, impl):
        return ref.rwkv_scan(r, k, v, lw, u, state0)
    if _needs_grad(r, k, v, lw, u, state0):
        raise NotImplementedError(_NO_SCAN_BWD.format("rwkv_scan", "rwkv"))
    out = _rs.rwkv_scan(r, k, v, lw, u, state0)
    LAUNCHES["rwkv_scan"] += 1
    return out


def mamba_scan(log_a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               state0: Optional[torch.Tensor] = None, *,
               impl: str = "kernel") -> Tuple[torch.Tensor, torch.Tensor]:
    """log_a, b [B, S, D, N] fp32; c [B, S, N] -> (y [B, S, D], state [B, D, N]),
    from ``state0`` [B, D, N] fp32, or from a zero state when it is None."""
    if not _use_kernel(log_a, impl):
        return ref.mamba_scan(log_a, b, c, state0)
    if _needs_grad(log_a, b, c, *([] if state0 is None else [state0])):
        raise NotImplementedError(_NO_SCAN_BWD.format("mamba_scan", "hymba"))
    out = _ms.mamba_scan(log_a, b, c, state0)
    LAUNCHES["mamba_scan"] += 1
    return out
