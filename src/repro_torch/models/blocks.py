"""Forward computation of the dense, MoE, RWKV-6 and Hymba blocks.

    new_h, new_cache, aux = apply_block(kind, cfg, params, h, ctx, cache)

``aux`` holds a block's auxiliary losses: a moe block's ``moe_aux`` (the
load-balance loss) and ``moe_z`` (the router z-loss), f32 scalars; the other
kinds have none (an empty dict, where the reference adds zeros).

``ctx`` is a :class:`BlockCtx`: mode "seq" (a full sequence, no cache),
"prefill" (a full prompt that also fills the cache) or "step" (one new token
per row against the cache). Shapes: h [B, S, D]; a dense layer's cache is
``{"k", "v"}`` of [B, Ck, K, hd], an rwkv layer's ``{"state", "px_tm",
"px_cm"}``, a hymba layer's ``{"k", "v", "ssm", "conv"}`` (see
``models/kvcache.py``).

Attention (dense and hymba): "seq" and "prefill" attention run through
``ops.flash_attention`` (every row has positions 0..S-1, so the reference's
``_attend`` there is exactly causal end-aligned attention, key index =
position = slot); "step" attention against the cache is the plain
:func:`_attend`, as it is jnp in the reference. A model with hymba blocks has
128 attention sinks: with a window, keys in the first 128 slots pass the
window test.

Hymba: attention and the Mamba mix (:func:`mamba_mix`) read the same normed
input; their outputs are RMS-normed, averaged and projected. The selective
scan runs through ``ops.mamba_scan`` for a sequence (S > 1); one step (S = 1)
is the plain single step, as it is jnp in the reference. ``impl="plain"``
computes the reference's jnp form, an associative scan over chunks.

RWKV-6: the time mix's wkv recurrence runs through ``ops.rwkv_scan`` for a
sequence (S > 1); one step (S = 1) is the plain single-step recurrence, as it
is jnp in the reference. ``impl="plain"`` computes what the reference's jnp
path computes, :func:`_wkv_chunk` over chunks.

MoE (:func:`moe_ffn`): attention as in a dense block, then the reference's
capacity-bounded dispatch by sort with one token group, and its shared
expert. The expert products are batched matrix products, as they are jnp
in the reference. Top-k ties go to the lower expert index, as ``lax.top_k``
breaks them (:func:`moe_topk`). Dispatch and combine are gathers in both
directions (:class:`_RowGather`): every kept assignment owns its slot, so no
row is summed by atomics and a round is bit for bit repeatable; the
capacity C comes from the shapes on the host, so a step captures as a CUDA
graph.

Every block ends in the fused adapter kernel. Under autograd (training)
attention, with its sinks, and both scans go through their backward kernels
(``kernels/ops.py``); a hot block whose input and weights need no gradient
(the lowest hot layer) runs them as served.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapter import apply_adapter
from repro_torch.kernels import ops
from repro_torch.models import kvcache

NEG_INF = -1e30
_LATER = "ROADMAP.md Queue 1, 'The other block kinds'"


@dataclass
class BlockCtx:
    cfg: ModelConfig
    mode: str                                  # "seq" | "prefill" | "step"
    positions: torch.Tensor                    # [B, S] absolute positions
    causal: bool = True
    cache_positions: Optional[torch.Tensor] = None  # [B, Ck] positions held in cache
    write_slots: Optional[torch.Tensor] = None      # prefill [B, Ck] / step [B, 1]
    impl: str = "kernel"                       # "kernel" | "plain"


def rmsnorm(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * p["scale"]).to(x.dtype)


def layernorm(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The reference's LayerNorm: f32 inside, the population variance (as
    ``jnp.var``), ``rsqrt(var + 1e-5)``, ``scale`` and an optional ``bias``."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"]
    if "bias" in p:
        out = out + p["bias"]
    return out.to(x.dtype)


def norm(cfg: ModelConfig, p, x):
    return layernorm(p, x) if cfg.norm == "layernorm" else rmsnorm(p, x)


def _chunk_of(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap."""
    return max(d for d in range(1, min(n, cap) + 1) if n % d == 0)


def _ffn_act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "silu":
        return F.silu(x)
    if cfg.activation == "gelu":
        return F.gelu(x, approximate="tanh")
    if cfg.activation == "relu":
        return torch.relu(x)
    raise ValueError(cfg.activation)


def ffn(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    if cfg.glu:
        return (_ffn_act(cfg, x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    h = x @ p["w_in"]
    if "b_in" in p:
        h = h + p["b_in"].to(x.dtype)
    out = _ffn_act(cfg, h) @ p["w_out"]
    if "b_out" in p:
        out = out + p["b_out"].to(x.dtype)
    return out


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, hd]; positions [B, S]. Rotates the two halves of hd, in fp32."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].float() * freqs                    # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
            k_pos: torch.Tensor, *, causal: bool, window: Optional[int],
            n_sink: int = 0) -> torch.Tensor:
    """q [B, Sq, H, hd]; k, v [B, Sk, K, hd]; positions [B, S*] (k_pos -1 = empty slot).

    fp32 scores, masked to -1e30; probabilities zeroed where masked and cast to
    ``v.dtype`` before PV, as the reference's ``blocks._attend``. With a window,
    a key whose slot index is below ``n_sink`` passes the window test.
    """
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd).float()
    s = torch.einsum("bckgh,bskh->bkgcs", qg, k.float()) * (1.0 / math.sqrt(hd))
    m = (k_pos[:, None, :] >= 0)
    if causal:
        m = m & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        in_win = (q_pos[:, :, None] - k_pos[:, None, :]) < window
        if n_sink > 0:
            in_win = in_win | (torch.arange(k.shape[1], device=k.device) < n_sink)
        m = m & in_win
    m = m[:, None, None]                                          # [B, 1, 1, Sq, Sk]
    p = torch.softmax(s.masked_fill(~m, NEG_INF), dim=-1).masked_fill(~m, 0.0)
    out = torch.einsum("bkgcs,bskh->bckgh", p.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def attention(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor, ctx: BlockCtx,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA self-attention with RoPE, an optional sliding window and a KV cache.

    In "step" mode the cache is updated in place (the reference donates it).
    """
    if cfg.kv_quant:
        raise NotImplementedError("the int8 KV cache is not ported yet "
                                  "(ROADMAP.md Queue 1, serving: int8 KV)")
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].reshape(D, H * hd)).reshape(B, S, H, hd)
    kk = (x @ p["wk"].reshape(D, K * hd)).reshape(B, S, K, hd)
    vv = (x @ p["wv"].reshape(D, K * hd)).reshape(B, S, K, hd)
    if "bq" in p:
        q, kk, vv = q + p["bq"], kk + p["bk"], vv + p["bv"]
    if cfg.rope:
        q = rope(q, ctx.positions, cfg.rope_theta)
        kk = rope(kk, ctx.positions, cfg.rope_theta)

    n_sink = kvcache.n_sink(cfg)
    new_cache = None
    if ctx.mode == "step":
        b_idx = torch.arange(B, device=x.device)[:, None]
        cache["k"][b_idx, ctx.write_slots] = kk.to(cache["k"].dtype)
        cache["v"][b_idx, ctx.write_slots] = vv.to(cache["v"].dtype)
        new_cache = cache
        out = _attend(q, cache["k"], cache["v"], ctx.positions, ctx.cache_positions,
                      causal=ctx.causal, window=cfg.sliding_window, n_sink=n_sink)
    else:
        if ctx.mode == "prefill":
            # gather-fill: write_slots [B, Ck] is the prompt index landing in each slot
            gi = ctx.write_slots[:, :, None, None].expand(-1, -1, K, hd)
            new_cache = {"k": kk.gather(1, gi).to(cache["k"].dtype),
                         "v": vv.gather(1, gi).to(cache["v"].dtype)}
        out = ops.flash_attention(q, kk, vv, causal=ctx.causal, window=cfg.sliding_window,
                                  n_sink=n_sink, impl=ctx.impl)
    y = out.to(x.dtype).reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, D)
    return y, new_cache


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): data-dependent token shift and decay
# ---------------------------------------------------------------------------


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x[t-1] (zeros, or the cached ``prev`` [B, D], at t = 0). x: [B, S, D]."""
    if x.shape[1] == 1:
        base = torch.zeros_like(x[:, 0]) if prev is None else prev
        return base[:, None, :]
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if prev is not None:
        shifted[:, 0] = prev
    return shifted


def _ddlerp(p, xx: torch.Tensor, sx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """RWKV-6 data-dependent token-shift mixing -> the (r, k, v, w, g) inputs.

    ``mu[0]`` is the base mix; the LoRA rank is 32 for each of the five.
    """
    base = xx + sx * p["mu"][0]
    lo = torch.tanh(base @ p["tm_w1"]).reshape(*xx.shape[:-1], 5, 32)
    mws = torch.einsum("bslr,lrd->bsld", lo, p["tm_w2"])                # [B, S, 5, D]
    return tuple(xx + sx * (p["mu"][i] + mws[:, :, i].to(xx.dtype)) for i in range(5))


def _wkv_chunk(state, r, k, v, lw, u):
    """One chunk of the recurrence in the reference's chunked (matrix) form.

    state [N, hd, hd] fp32; r, k, v [N, L, hd]; lw = log decay (<= 0) [N, L, hd];
    u [N, 1, hd]. Returns (new_state, out [N, L, hd]).
    """
    L = r.shape[1]
    ca = torch.cumsum(lw, dim=1)                    # inclusive log-decay prefix
    ca_prev = ca - lw                               # exclusive
    inter = torch.einsum("nlk,nkv->nlv", r * torch.exp(ca_prev), state)
    diff = ca_prev[:, :, None, :] - ca[:, None, :, :]                   # [N, L, L, hd]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device),
                      diagonal=-1)[None, :, :, None]
    P = torch.where(mask, torch.exp(diff), 0.0)
    A = torch.einsum("ntk,ntsk,nsk->nts", r, P, k)
    intra = torch.einsum("nts,nsv->ntv", A, v)
    diag = torch.sum(r * u * k, dim=-1, keepdim=True) * v              # current-token bonus
    decay_all = torch.exp(ca[:, -1])                                    # [N, hd]
    carry_k = k * torch.exp(ca[:, -1][:, None, :] - ca)
    new_state = decay_all[:, :, None] * state + torch.einsum("nsk,nsv->nkv", carry_k, v)
    return new_state, inter + intra + diag


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, hd] -> fp32 [B*H, S, hd], contiguous (the kernel's layout)."""
    B, S, H, hd = x.shape
    return x.float().transpose(1, 2).reshape(B * H, S, hd).contiguous()


def rwkv_time_mix(cfg: ModelConfig, p, x: torch.Tensor,
                  cache: Optional[Dict[str, torch.Tensor]], impl: str = "kernel",
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    B, S, D = x.shape
    hd = cfg.ssm.head_dim
    H = D // hd
    prev = cache.get("px_tm") if cache else None
    sx = _token_shift(x, prev) - x
    xr, xk, xv, xw, xg = _ddlerp(p, x, sx)

    r = (xr @ p["wr"].reshape(D, D)).reshape(B, S, H, hd)
    k = (xk @ p["wk"].reshape(D, D)).reshape(B, S, H, hd)
    v = (xv @ p["wv"].reshape(D, D)).reshape(B, S, H, hd)
    g = (xg @ p["wg"].reshape(D, D)).reshape(B, S, H, hd)
    dd = torch.tanh(xw @ p["dd_w1"]) @ p["dd_w2"]                       # [B, S, D]
    # added in the model dtype, then cast: the reference's order
    wlog = p["decay_base"].reshape(1, 1, H, hd) + dd.reshape(B, S, H, hd)
    lw = -torch.exp(wlog.float())                                       # log decay <= 0

    rf, kf, vf, lwf = (_heads_first(t) for t in (r, k, v, lw))
    uf = p["bonus_u"].float()[None].expand(B, H, hd).reshape(B * H, 1, hd).contiguous()
    state0 = (cache["state"].reshape(B * H, hd, hd).float() if cache
              else torch.zeros((B * H, hd, hd), dtype=torch.float32, device=x.device))

    if S == 1:                                      # single-step recurrence
        kv = kf[:, 0, :, None] * vf[:, 0, None, :]
        out = torch.einsum("nk,nkv->nv", rf[:, 0], state0 + uf[:, 0, :, None] * kv)[:, None]
        state = torch.exp(lwf[:, 0])[:, :, None] * state0 + kv
    elif impl == "kernel":
        out, state = ops.rwkv_scan(rf, kf, vf, lwf, uf, state0.contiguous())
    else:
        if impl != "plain":
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        L = _chunk_of(S, 32)
        state, outs = state0, []
        for c in range(0, S, L):
            state, o = _wkv_chunk(state, rf[:, c:c + L], kf[:, c:c + L], vf[:, c:c + L],
                                  lwf[:, c:c + L], uf)
            outs.append(o)
        out = torch.cat(outs, dim=1)

    out = out.reshape(B, H, S, hd).transpose(1, 2)                      # [B, S, H, hd]
    # per-head group norm (fp32, population variance), then the gate
    mu = out.mean(dim=-1, keepdim=True)
    var = out.var(dim=-1, keepdim=True, unbiased=False)
    out = (out - mu) * torch.rsqrt(var + 1e-5)
    out = out.reshape(B, S, D) * p["ln_x"]
    out = out * F.silu(g.float()).reshape(B, S, D)
    y = out.to(x.dtype) @ p["wo"].reshape(D, D)

    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["state"] = state.reshape(B, H, hd, hd).to(cache["state"].dtype)
        new_cache["px_tm"] = x[:, -1]
    return y, new_cache


def rwkv_channel_mix(cfg: ModelConfig, p, x: torch.Tensor,
                     cache: Optional[Dict[str, torch.Tensor]],
                     ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    prev = cache.get("px_cm") if cache else None
    sx = _token_shift(x, prev) - x
    xk = x + sx * p["mu_ck"]
    xr = x + sx * p["mu_cr"]
    k = torch.square(torch.relu(xk @ p["wk_c"]))
    v = k @ p["wv_c"]
    out = torch.sigmoid((xr @ p["wr_c"]).float()).to(x.dtype) * v
    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["px_cm"] = x[:, -1]
    return out, new_cache


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (Hymba's parallel SSM heads)
# ---------------------------------------------------------------------------


def _ssm_chunks(log_a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, s0: torch.Tensor,
                L: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's jnp form of the scan: chunks of L steps, each an
    associative scan of the (a, b) pairs (here by doubling), the state carried
    from chunk to chunk. log_a, b [B, S, di, N]; c [B, S, N]; s0 [B, di, N].
    Returns (y [B, S, di], final state)."""
    B, S, di, N = log_a.shape
    nch = S // L
    a = torch.exp(log_a).reshape(B, nch, L, di, N)
    b = b.reshape(B, nch, L, di, N)
    d = 1
    while d < L:
        # step t <- (step t - d, then step t): (a_t a_{t-d}, a_t b_{t-d} + b_t)
        b = torch.cat([b[:, :, :d], a[:, :, d:] * b[:, :, :-d] + b[:, :, d:]], dim=2)
        a = torch.cat([a[:, :, :d], a[:, :, d:] * a[:, :, :-d]], dim=2)
        d *= 2
    c = c.reshape(B, nch, L, N)
    state, ys = s0, []
    for i in range(nch):
        states = a[:, i] * state[:, None] + b[:, i]                     # [B, L, di, N]
        ys.append(torch.einsum("bldn,bln->bld", states, c[:, i]))
        state = states[:, -1]
    return torch.cat(ys, dim=1), state


def mamba_mix(cfg: ModelConfig, p, x: torch.Tensor,
              cache: Optional[Dict[str, torch.Tensor]], impl: str = "kernel",
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x [B, S, D] -> y [B, S, di]; the cache's ``ssm`` state and ``conv`` tail."""
    B, S, D = x.shape
    di = cfg.n_heads * cfg.head_dim
    N, R, W = cfg.ssm.state_size, cfg.ssm.dt_rank, cfg.ssm.conv_width

    xz = x @ p["in_proj"]                                               # [B, S, di]
    # causal depthwise conv over [conv cache | x]
    prev = cache.get("conv") if cache else None
    if prev is None:
        prev = torch.zeros((B, W - 1, di), dtype=xz.dtype, device=x.device)
    xc = torch.cat([prev.to(xz.dtype), xz], dim=1)                      # [B, S+W-1, di]
    conv_w = p["conv_w"].float()
    xconv = sum(xc[:, w:w + S].float() * conv_w[w] for w in range(W)).to(xz.dtype)
    xs = F.silu(xconv)

    dt_lr, b_mat, c_mat = torch.split(xs @ p["x_proj"], [R, N, N], dim=-1)
    # in the model dtype, then f32: the reference's order
    dt = F.softplus(dt_lr @ p["dt_proj"] + p["dt_bias"]).float()        # [B, S, di]
    A = -torch.exp(p["a_log"].float())                                  # [di, N]
    log_a = dt[..., None] * A                                           # [B, S, di, N]
    bx = dt[..., None] * b_mat[:, :, None, :].float() * xs[..., None].float()
    c = c_mat.float()
    s0 = (cache["ssm"].float() if cache
          else torch.zeros((B, di, N), dtype=torch.float32, device=x.device))

    if S == 1:                                      # single step
        state = torch.exp(log_a[:, 0]) * s0 + bx[:, 0]
        ys = torch.einsum("bdn,bn->bd", state, c[:, 0])[:, None]
    elif impl == "kernel":
        ys, state = ops.mamba_scan(log_a.contiguous(), bx.contiguous(), c.contiguous(),
                                   s0.contiguous())
    else:
        if impl != "plain":
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        ys, state = _ssm_chunks(log_a, bx, c, s0, _chunk_of(S, 128))
    y = ys.to(x.dtype) + xs * p["d_skip"].to(x.dtype)

    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["ssm"] = state.to(cache["ssm"].dtype)
        new_cache["conv"] = xc[:, S:].clone() if W > 1 else cache["conv"]
    return y, new_cache


# ---------------------------------------------------------------------------
# Mixture of experts: capacity-bounded dispatch by sort (one token group)
# ---------------------------------------------------------------------------


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens: the reference's
    C = max(8, ceil(ceil(T k / E cf) / 8) 8), from the shapes alone."""
    m = cfg.moe
    C = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(8, -(-C // 8) * 8)


def moe_topk(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates, experts), each [T, k]: the k largest probabilities of each row
    and their experts, ties to the lower index (``lax.top_k``'s rule, which
    ``torch.topk`` does not promise), by a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_slots(eidx: torch.Tensor, n_experts: int, capacity: int):
    """The dispatch maps of the T k assignments (token-major) of ``eidx`` [T, k].

    Returns (slot [T k], src [E C], keep [T k]): an assignment's rank counts
    the earlier assignments to its expert (a stable sort, as the reference's:
    no [T, E] cumsum); it lands in slot ``e C + rank`` if its rank is below C,
    else in the dummy slot E C (dropped). ``src`` names each slot's assignment,
    or the sentinel T k for an empty slot. Every map is a permutation or a
    gather, so each kept slot is written once.
    """
    E, C = n_experts, capacity
    n = eidx.numel()
    flat_e = eidx.reshape(n)
    sorted_e, order = torch.sort(flat_e, stable=True)
    experts = torch.arange(E, device=eidx.device, dtype=flat_e.dtype)
    start = torch.searchsorted(sorted_e, experts)
    count = torch.searchsorted(sorted_e, experts, right=True) - start
    ar = torch.arange(n, device=eidx.device)
    ranks = torch.empty_like(ar).scatter_(0, order, ar - start[sorted_e])
    keep = ranks < C
    slot = torch.where(keep, flat_e * C + ranks, E * C)
    r = torch.arange(C, device=eidx.device)
    pos = torch.clamp(start[:, None] + r, max=n - 1)
    src = torch.where(r < count[:, None], order[pos], n).reshape(E * C)
    return slot, src, keep


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])


class _RowGather(torch.autograd.Function):
    """``out[i] = x_pad[index[i]]`` (x with a zero row appended), whose
    backward gathers the output's gradient by ``back`` and sums each run of
    ``group`` rows: dispatch and combine are each other's transposes, so both
    directions are gathers and no row is accumulated by atomics."""

    @staticmethod
    def forward(ctx, x, index, back, group: int):
        ctx.save_for_backward(back)
        ctx.rows, ctx.group = x.shape[0], group
        return _pad_row(x).index_select(0, index)

    @staticmethod
    def backward(ctx, g):
        (back,) = ctx.saved_tensors
        gx = _pad_row(g).index_select(0, back)
        if ctx.group > 1:
            gx = gx.reshape(ctx.rows, ctx.group, -1).sum(1)
        return gx, None, None, None


def moe_ffn(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, D] -> (routed + shared expert [B, S, D], {"moe_aux", "moe_z"}).

    The router in the model's dtype, then f32 softmax; top-k gates
    renormalised; each kept assignment's token copied to its expert slot
    ([E, C, D]), the experts' gated FFNs as batched products, each slot's
    output gathered back and weighted by its gate (in the model's dtype), the
    k choices summed. The gates depend on x through the softmax, so the input
    gradient flows through them and through the experts.
    """
    m = cfg.moe
    B, S, D = x.shape
    T, E, k = B * S, m.n_experts, m.top_k
    C = moe_capacity(cfg, T)
    xt = x.reshape(T, D)
    # the named ranges attribute a profiled run's device time
    # (launch/trace_train.py); no cost outside the profiler
    with record_function("moe_route"):
        logits = (xt @ p["router"].to(xt.dtype)).float()                 # [T, E]
        probs = torch.softmax(logits, dim=-1)
        gates, eidx = moe_topk(probs, k)
        gates = gates / gates.sum(dim=-1, keepdim=True)
        slot, src, keep = moe_slots(eidx, E, C)
    with record_function("moe_dispatch"):
        xe = _RowGather.apply(xt, torch.div(src, k, rounding_mode="floor"), slot, k)
    with record_function("moe_experts"):
        xe = xe.reshape(E, C, D)
        hg = torch.bmm(xe, p["we_gate"])
        hu = torch.bmm(xe, p["we_up"])
        ye = torch.bmm(_ffn_act(cfg, hg) * hu, p["we_down"]).reshape(E * C, D)
    with record_function("moe_dispatch"):
        weight = gates.reshape(T * k, 1).to(ye.dtype) * keep[:, None]
        routed = (_RowGather.apply(ye, slot, src, 1) * weight).reshape(T, k, D).sum(dim=1)
    with record_function("moe_shared"):
        shared = (_ffn_act(cfg, xt @ p["ws_gate"]) * (xt @ p["ws_up"])) @ p["ws_down"]
    out = (routed + shared).reshape(B, S, D)

    with record_function("moe_route"):
        # load balance: each expert's share of assignments times its mean probability
        me = (eidx[..., None] == torch.arange(E, device=x.device)).float().mean(dim=(0, 1))
        pe = probs.mean(dim=0)
        zl = torch.logsumexp(logits, dim=-1).square().mean()
        aux = {"moe_aux": E * torch.sum(me * pe) * m.router_aux_weight,
               "moe_z": zl * m.router_z_weight}
    return out, aux


def apply_block(kind: str, cfg: ModelConfig, p: Dict, h: torch.Tensor, ctx: BlockCtx,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]],
                           Dict[str, torch.Tensor]]:
    aux: Dict[str, torch.Tensor] = {}
    if kind in ("dense", "moe"):
        a, new_cache = attention(cfg, p["attn"], norm(cfg, p["ln1"], h), ctx, cache)
        h = h + a
        hn = norm(cfg, p["ln2"], h)
        if kind == "moe":
            f, aux = moe_ffn(cfg, p["moe"], hn)
        else:
            f = ffn(cfg, p["ffn"], hn)
        h = h + f
    elif kind == "rwkv":
        t, new_cache = rwkv_time_mix(cfg, p["rwkv"], norm(cfg, p["ln1"], h), cache,
                                     impl=ctx.impl)
        h = h + t
        c, cm_cache = rwkv_channel_mix(cfg, p["rwkv"], norm(cfg, p["ln2"], h), new_cache)
        new_cache = cm_cache if cm_cache is not None else new_cache
        h = h + c
    elif kind == "hymba":
        hn = norm(cfg, p["ln1"], h)
        a, attn_cache = attention(cfg, p["attn"], hn, ctx, cache)
        s, ssm_cache = mamba_mix(cfg, p["ssm"], hn, cache, impl=ctx.impl)
        # per-branch RMSNorm, averaged, then projected by the attention's wo. The
        # reference applies wo to the attention branch twice (once inside
        # attention), and the port is held to the reference (ROADMAP.md Queue 3).
        fused = 0.5 * (rmsnorm({"scale": p["norm_attn"]}, a)
                       + rmsnorm({"scale": p["norm_ssm"]}, s))
        wo = p["attn"]["wo"]
        h = h + fused @ wo.reshape(-1, wo.shape[-1])
        new_cache = None
        if cache is not None:
            new_cache = {**ssm_cache, "k": attn_cache["k"], "v": attn_cache["v"]}
        h = h + ffn(cfg, p["ffn"], norm(cfg, p["ln2"], h))
    else:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet ({_LATER})")
    # the paper's serial adapter, after the FFN / channel-mix sublayer
    h = apply_adapter(p["adapter"], h, activation=cfg.adapter.activation, impl=ctx.impl)
    return h, new_cache, aux
