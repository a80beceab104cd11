"""Public entries of the port's kernels: device dispatch and launch counters.

One rule for every kernel: a CPU tensor goes to the plain version in
``kernels/ref.py``; a CUDA tensor goes to the hand-written kernel, or the
launcher raises. ``impl="plain"`` forces the plain version on any device; it
exists for holding a kernel against its plain version (the tests and
``chip_smoke.py``), and nothing on the serving path selects it.

``LAUNCHES`` counts kernel launches, one per call that reached a kernel, so a
run can show that its path went through the kernels.

Gradients: where an input of a kernel needs one, the call goes through a
``torch.autograd.Function`` whose backward is the backward kernel on a CUDA
tensor (counted as ``adapter_fused_bwd``, ``flash_attention_bwd``,
``rwkv_scan_bwd`` and ``mamba_scan_bwd``) and the plain backward of
``kernels/ref.py`` on a CPU tensor or under ``impl="plain"``. The scans'
backwards take no cotangent of the final state (training never
differentiates it) and raise where one is given. Where no input
needs one (serving, the frozen trunk under ``torch.no_grad``), the call is
the forward alone: nothing is saved, no row logsumexp and no scan checkpoint
is written.
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
                            "mamba_scan": 0, "mamba_scan_bwd": 0,
                            "rwkv_scan": 0, "rwkv_scan_bwd": 0}


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
    """flash_attention with its backward (sinks included)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int], n_sink: int, kernel: bool):
        kw = dict(causal=causal, window=window, n_sink=n_sink, lse=True)
        if kernel:
            out, lse = _fa.flash_attention(q, k, v, **kw)
            LAUNCHES["flash_attention"] += 1
        else:
            out, lse = ref.flash_attention(q, k, v, **kw)
        ctx.causal, ctx.window, ctx.n_sink, ctx.kernel = causal, window, n_sink, kernel
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = _fa.flash_attention_bwd if ctx.kernel else ref.flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, dout, causal=ctx.causal, window=ctx.window,
                         n_sink=ctx.n_sink)
        if ctx.kernel:
            LAUNCHES["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None, n_sink: int = 0,
                    impl: str = "kernel") -> torch.Tensor:
    """q [B, Sq, H, hd]; k, v [B, Sk, K, hd]; returns [B, Sq, H, hd]. With a
    window, the first ``n_sink`` keys pass the window test (attention sinks)."""
    kernel = _use_kernel(q, impl)
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, n_sink, kernel)
    if not kernel:
        return ref.flash_attention(q, k, v, causal=causal, window=window, n_sink=n_sink)
    out = _fa.flash_attention(q, k, v, causal=causal, window=window, n_sink=n_sink)
    LAUNCHES["flash_attention"] += 1
    return out


def _no_state_grad(name: str, dstate: Optional[torch.Tensor]) -> None:
    if dstate is not None:
        raise ValueError(f"{name}'s backward takes no gradient of the final state: "
                         f"nothing in the port differentiates it")


def _rwkv_forward(r, k, v, lw, u, state0, kernel: bool):
    if not kernel:
        return ref.rwkv_scan(r, k, v, lw, u, state0)
    out = _rs.rwkv_scan(r, k, v, lw, u, state0)
    LAUNCHES["rwkv_scan"] += 1
    return out


class _RwkvScan(torch.autograd.Function):
    """rwkv_scan with its backward: the kernel recomputes the states from the
    saved inputs, so the forward saves nothing else."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, state0, kernel: bool):
        ctx.set_materialize_grads(False)
        ctx.kernel = kernel
        ctx.save_for_backward(r, k, v, lw, u, state0)
        return _rwkv_forward(r, k, v, lw, u, state0, kernel)

    @staticmethod
    def backward(ctx, dout, dstate):
        _no_state_grad("rwkv_scan", dstate)
        saved = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(saved[0])
        if not ctx.kernel:
            return (*ref.rwkv_scan_bwd(*saved, dout), None)
        grads = _rs.rwkv_scan_bwd(*saved, dout.contiguous())
        LAUNCHES["rwkv_scan_bwd"] += 1
        return (*grads, None)


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
              u: torch.Tensor, state0: torch.Tensor, *,
              impl: str = "kernel") -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw [N, S, hd] fp32; u [N, 1, hd]; state0 [N, hd, hd] -> (out, state)."""
    kernel = _use_kernel(r, impl)
    if _needs_grad(r, k, v, lw, u, state0):
        return _RwkvScan.apply(r, k, v, lw, u, state0, kernel)
    return _rwkv_forward(r, k, v, lw, u, state0, kernel)


class _MambaScan(torch.autograd.Function):
    """mamba_scan with its backward: the kernel's forward also writes the
    state at every checkpoint (``_ms.CHUNK`` steps apart), from which the
    backward kernel recomputes the states a chunk at a time; the [B, S, D, N]
    states are never saved."""

    @staticmethod
    def forward(ctx, log_a, b, c, state0, kernel: bool):
        ctx.set_materialize_grads(False)
        ctx.kernel = kernel
        if kernel:
            y, state, ckpt = _ms.mamba_scan(log_a, b, c, state0, checkpoints=True)
            LAUNCHES["mamba_scan"] += 1
        else:
            (y, state), ckpt = ref.mamba_scan(log_a, b, c, state0), None
        ctx.save_for_backward(log_a, b, c, state0, ckpt)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        _no_state_grad("mamba_scan", dstate)
        log_a, b, c, state0, ckpt = ctx.saved_tensors
        if dy is None:
            dy = log_a.new_zeros(log_a.shape[:3])
        if not ctx.kernel:
            grads = ref.mamba_scan_bwd(log_a, b, c, state0, dy)
        else:
            grads = _ms.mamba_scan_bwd(log_a, b, c, ckpt, dy.contiguous())
            LAUNCHES["mamba_scan_bwd"] += 1
        dla, db, dc, ds0 = grads
        return dla, db, dc, None if state0 is None else ds0, None


def mamba_scan(log_a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               state0: Optional[torch.Tensor] = None, *,
               impl: str = "kernel") -> Tuple[torch.Tensor, torch.Tensor]:
    """log_a, b [B, S, D, N] fp32; c [B, S, N] -> (y [B, S, D], state [B, D, N]),
    from ``state0`` [B, D, N] fp32, or from a zero state when it is None."""
    kernel = _use_kernel(log_a, impl)
    if _needs_grad(log_a, b, c, *([] if state0 is None else [state0])):
        return _MambaScan.apply(log_a, b, c, state0, kernel)
    if not kernel:
        return ref.mamba_scan(log_a, b, c, state0)
    out = _ms.mamba_scan(log_a, b, c, state0)
    LAUNCHES["mamba_scan"] += 1
    return out
