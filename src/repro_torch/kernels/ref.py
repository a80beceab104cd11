"""Plain PyTorch versions of the port's kernels (the reference's ``kernels/ref.py``).

The CPU path of every kernel wrapper, and the version each CUDA kernel is held
against on the card. The backward versions (training) are written out as
formulas, as the backward kernels compute them; the tests hold them against
autograd of the forwards here and against ``jax.vjp`` of the reference's.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

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


def act_grad(name: str, x: torch.Tensor) -> torch.Tensor:
    """d act / dx: tanh-GELU through its tanh; relu 0 at x <= 0; silu s (1 + x (1 - s))."""
    if name == "gelu":
        k = math.sqrt(2.0 / math.pi)
        t = torch.tanh(k * (x + 0.044715 * x ** 3))
        return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * k * (1.0 + 3 * 0.044715 * x * x)
    if name == "relu":
        return (x > 0).to(x.dtype)
    if name == "silu":
        s = torch.sigmoid(x)
        return s * (1.0 + x * (1.0 - s))
    raise ValueError(f"unknown activation {name!r}")


def adapter_fused(h: torch.Tensor, w_down: torch.Tensor, w_up: torch.Tensor, *,
                  activation: str = "gelu") -> torch.Tensor:
    """h [..., D]; eq. (1): h + act(h @ Wd) @ Wu, fp32 internals."""
    mid = act(activation, h.float() @ w_down.float())
    return h + (mid @ w_up.float()).to(h.dtype)


def adapter_fused_bwd(g: torch.Tensor, h: torch.Tensor, w_down: torch.Tensor,
                      w_up: torch.Tensor, *, activation: str = "gelu",
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dh, dw_down, dw_up) of :func:`adapter_fused` for the cotangent g [..., D].

    The reference's gradient of its casts: up's cotangent is g in fp32, and
    the input term g_mid @ Wd^T comes back to h's dtype before it joins g,
    so in bf16 dh = bf16(g + bf16(term)). The weight gradients are fp32
    products rounded once to the weights' dtype.
    """
    D = w_down.shape[0]
    dh, mid, g_mid = adapter_fused_bwd_terms(g, h, w_down, w_up, activation=activation)
    dw_down = (h.reshape(-1, D).float().t() @ g_mid).to(w_down.dtype)
    dw_up = (mid.t() @ g.reshape(-1, D).float()).to(w_up.dtype)
    return dh, dw_down, dw_up


def adapter_fused_bwd_terms(g: torch.Tensor, h: torch.Tensor, w_down: torch.Tensor,
                            w_up: torch.Tensor, *, activation: str = "gelu",
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the backward kernel computes: (dh, mid = act(z), g_mid = (g @ Wu^T)
    * act'(z)) with z = h @ Wd; mid and g_mid [rows, m] fp32."""
    D = w_down.shape[0]
    hf, gf = h.reshape(-1, D).float(), g.reshape(-1, D).float()
    z = hf @ w_down.float()
    g_mid = (gf @ w_up.float().t()) * act_grad(activation, z)
    dh = g + (g_mid @ w_down.float().t()).reshape(h.shape).to(h.dtype)
    return dh, act(activation, z), g_mid


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


def rwkv_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
                  u: torch.Tensor, state0: torch.Tensor, dout: torch.Tensor,
                  ) -> Tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dlw, du, dstate0) of :func:`rwkv_scan` for the cotangent
    ``dout`` [N, S, hd] (the final state's is zero: training never
    differentiates it), by the reverse-time recurrence. The forward states S_{t-1} are
    recomputed forward and kept (never found by dividing by e^{lw}, which may
    be 0); G_t, the cotangent of S_t, walks back:

        dr_t = S_{t-1} dout_t + u o k_t (v_t . dout_t)
        dk_t = G_t v_t + u o r_t (v_t . dout_t)
        dv_t = G_t^T k_t + (r_t . u o k_t) dout_t
        dlw_t = e^{lw_t} o rowsum(G_t o S_{t-1}),   du = sum_t r_t o k_t (v_t . dout_t)
        G_{t-1} = r_t dout_t^T + e^{lw_t} o G_t,    dstate0 = G_{-1}
    """
    S = r.shape[1]
    w = torch.exp(lw)
    u0 = u[:, 0]
    prev = [state0]                                 # prev[t] = S_{t-1}
    for t in range(S - 1):
        prev.append(w[:, t, :, None] * prev[-1] + k[:, t, :, None] * v[:, t, None, :])
    g = torch.zeros_like(state0)
    dr, dk, dv, dlw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u0)
    for t in range(S - 1, -1, -1):
        rt, kt, vt, dt = r[:, t], k[:, t], v[:, t], dout[:, t]
        vdo = (vt * dt).sum(-1, keepdim=True)
        dr[:, t] = torch.einsum("nkv,nv->nk", prev[t], dt) + u0 * kt * vdo
        dk[:, t] = torch.einsum("nkv,nv->nk", g, vt) + u0 * rt * vdo
        dv[:, t] = torch.einsum("nkv,nk->nv", g, kt) + (rt * u0 * kt).sum(-1, keepdim=True) * dt
        dlw[:, t] = w[:, t] * (g * prev[t]).sum(-1)
        du = du + rt * kt * vdo
        g = rt[:, :, None] * dt[:, None, :] + w[:, t, :, None] * g
    return dr, dk, dv, dlw, du[:, None], g


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


def mamba_scan_bwd(log_a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   state0: Optional[torch.Tensor], dy: torch.Tensor,
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dlog_a, db, dc, dstate0) of :func:`mamba_scan` for the cotangent
    ``dy`` [B, S, D] (the final state's is zero: training never
    differentiates it), by the reverse-time recurrence. The states are recomputed forward
    and kept (never found by dividing by e^{log_a}, which may be 0); g_t, the
    cotangent of s_t, walks back:

        g_t = dy_t c_t + e^{log_a_{t+1}} g_{t+1}   (g_{S-1} = dy_{S-1} c_{S-1})
        db_t = g_t,   dlog_a_t = g_t e^{log_a_t} s_{t-1},   dc_t = sum_D s_t dy_t
        dstate0 = e^{log_a_0} g_0
    """
    S = log_a.shape[1]
    a = torch.exp(log_a)
    states = [torch.zeros_like(log_a[:, 0]) if state0 is None else state0]
    for t in range(S):                              # states[t] = s_{t-1}
        states.append(a[:, t] * states[-1] + b[:, t])
    carry = torch.zeros_like(states[0])
    dla, db = torch.empty_like(log_a), torch.empty_like(b)
    dc = torch.empty_like(c)
    for t in range(S - 1, -1, -1):
        g = carry + dy[:, t, :, None] * c[:, t, None, :]
        db[:, t] = g
        dla[:, t] = g * a[:, t] * states[t]
        dc[:, t] = torch.einsum("bdn,bd->bn", states[t + 1], dy[:, t])
        carry = a[:, t] * g
    return dla, db, dc, carry


def _attention_mask(Sq: int, Sk: int, causal: bool, window: Optional[int], n_sink: int,
                    device) -> torch.Tensor:
    """[Sq, Sk]: the (query, key) pairs attention keeps (end-aligned)."""
    qi = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    ki = torch.arange(Sk, device=device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        m &= ki <= qi
    if window is not None:
        m &= ((qi - ki) < window) | (ki < n_sink)
    return m


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    n_sink: int = 0, lse: bool = False,
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """q [B, Sq, H, hd]; k, v [B, Sk, K, hd] with H = K * group (query head n
    reads KV head n // group). fp32 scores and softmax; the causal mask aligns
    the last query with the last key; fully masked rows give 0. With a window,
    the first ``n_sink`` keys (attention sinks) pass the window test.
    ``lse=True`` also returns each row's logsumexp of the scaled scores, fp32
    [B, H, Sq], -inf where the row sees no key (the backward's input).
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * (1.0 / math.sqrt(hd))
    m = _attention_mask(Sq, Sk, causal, window, n_sink, q.device)
    s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1).masked_fill(~m, 0.0)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v).reshape(B, Sq, H, hd)
    if not lse:
        return out
    row_lse = torch.logsumexp(s, dim=-1).masked_fill(~m.any(-1), -math.inf)
    return out, row_lse.reshape(B, H, Sq)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None, n_sink: int = 0,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` (its mask, the sinks' keys
    included), the FlashAttention-2 way: P recomputed from the forward's row
    logsumexp, 0 where masked;
    dV = P^T dO with P cast to v's dtype, as the forward's PV took it;
    dS = P (dO V^T - rowsum(dO o)); dQ = scale dS K; dK = scale dS^T Q.
    fp32 inside, each result rounded once to its input's dtype.
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, K, G, hd).float()
    dog = dout.reshape(B, Sq, K, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    m = _attention_mask(Sq, Sk, causal, window, n_sink, q.device)
    p = torch.where(m, torch.exp(s - lse.reshape(B, K, G, Sq, 1)), 0.0)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p.to(v.dtype).float(), dog)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, v.float())
    delta = (dout.float() * out.float()).sum(-1)                     # [B, Sq, H]
    ds = p * (dp - delta.reshape(B, Sq, K, G).permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
