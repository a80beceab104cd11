"""Public entries of the port's kernels: device dispatch and launch counters.

One rule for every kernel: a CPU tensor goes to the plain version in
``kernels/ref.py``; a CUDA tensor goes to the hand-written kernel, or the
launcher raises. ``impl="plain"`` forces the plain version on any device; it
exists for holding a kernel against its plain version (the tests and
``chip_smoke.py``), and nothing on the serving path selects it.

``LAUNCHES`` counts kernel launches, one per call that reached a kernel, so a
run can show that its path went through the kernels.
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
LAUNCHES: Dict[str, int] = {"adapter_fused": 0, "flash_attention": 0, "mamba_scan": 0,
                            "rwkv_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _use_kernel(x: torch.Tensor, impl: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "kernel" and x.device.type != "cpu"


def adapter_fused(h: torch.Tensor, w_down: torch.Tensor, w_up: torch.Tensor, *,
                  activation: str = "gelu", impl: str = "kernel") -> torch.Tensor:
    """h [..., D] — leading dims flattened for the kernel and restored."""
    if not _use_kernel(h, impl):
        return ref.adapter_fused(h, w_down, w_up, activation=activation)
    shape = h.shape
    out = _af.adapter_fused(h.reshape(-1, shape[-1]).contiguous(), w_down, w_up,
                            activation=activation)
    LAUNCHES["adapter_fused"] += 1
    return out.reshape(shape)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None, n_sink: int = 0,
                    impl: str = "kernel") -> torch.Tensor:
    """q [B, Sq, H, hd]; k, v [B, Sk, K, hd]; returns [B, Sq, H, hd]. With a
    window, the first ``n_sink`` keys pass the window test (attention sinks)."""
    if not _use_kernel(q, impl):
        return ref.flash_attention(q, k, v, causal=causal, window=window, n_sink=n_sink)
    out = _fa.flash_attention(q, k, v, causal=causal, window=window, n_sink=n_sink)
    LAUNCHES["flash_attention"] += 1
    return out


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
              u: torch.Tensor, state0: torch.Tensor, *,
              impl: str = "kernel") -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw [N, S, hd] fp32; u [N, 1, hd]; state0 [N, hd, hd] -> (out, state)."""
    if not _use_kernel(r, impl):
        return ref.rwkv_scan(r, k, v, lw, u, state0)
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
    out = _ms.mamba_scan(log_a, b, c, state0)
    LAUNCHES["mamba_scan"] += 1
    return out
