"""Plain PyTorch versions of the port's kernels (the reference's ``kernels/ref.py``).

The CPU path of every kernel wrapper, and the version each CUDA kernel is held
against on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def act(name: str, x: torch.Tensor) -> torch.Tensor:
    """The adapter activations; gelu is the tanh form (``jax.nn.gelu``'s default)."""
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return torch.relu(x)
    if name == "silu":
        return F.silu(x)
    raise ValueError(f"unknown activation {name!r}")


def adapter_fused(h: torch.Tensor, w_down: torch.Tensor, w_up: torch.Tensor, *,
                  activation: str = "gelu") -> torch.Tensor:
    """h [..., D]; eq. (1): h + act(h @ Wd) @ Wu, fp32 internals."""
    mid = act(activation, h.float() @ w_down.float())
    return h + (mid @ w_up.float()).to(h.dtype)


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
              u: torch.Tensor, state0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential RWKV-6 wkv recurrence (the reference's definitional oracle).

    r, k, v, lw [N, S, hd] fp32 (lw = log decay <= 0); u [N, 1, hd];
    state0 [N, hd, hd] indexed [k, v]. Returns (out [N, S, hd], state [N, hd, hd]).

        out_t = r_t (S_{t-1} + u o k_t v_t^T);  S_t = e^{lw_t} o S_{t-1} + k_t v_t^T
    """
    s = state0
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]
        outs.append(torch.einsum("nk,nkv->nv", r[:, t], s + u[:, 0, :, None] * kv))
        s = torch.exp(lw[:, t])[:, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def mamba_scan(log_a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               state0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential selective-SSM recurrence (the reference's oracle), from
    ``state0`` [B, D, N] or, when it is None, from a zero state.

    log_a, b [B, S, D, N] fp32 (log_a = log decay <= 0); c [B, S, N].
    Returns (y [B, S, D], final state [B, D, N]).

        s_t = exp(log_a_t) * s_{t-1} + b_t ;  y_t = sum_N s_t * c_t
    """
    s = torch.zeros_like(log_a[:, 0]) if state0 is None else state0
    ys = []
    for t in range(log_a.shape[1]):
        s = torch.exp(log_a[:, t]) * s + b[:, t]
        ys.append(torch.einsum("bdn,bn->bd", s, c[:, t]))
    return torch.stack(ys, dim=1), s


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    n_sink: int = 0) -> torch.Tensor:
    """q [B, Sq, H, hd]; k, v [B, Sk, K, hd] with H = K * group (query head n
    reads KV head n // group). fp32 scores and softmax; the causal mask aligns
    the last query with the last key; fully masked rows give 0. With a window,
    the first ``n_sink`` keys (attention sinks) pass the window test.
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * (1.0 / math.sqrt(hd))
    qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    ki = torch.arange(Sk, device=q.device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= ki <= qi
    if window is not None:
        m &= ((qi - ki) < window) | (ki < n_sink)
    s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1).masked_fill(~m, 0.0)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)
