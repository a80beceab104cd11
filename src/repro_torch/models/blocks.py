"""Forward computation of a dense decoder block, for serving.

    new_h, new_cache = apply_block("dense", cfg, params, h, ctx, cache)

``ctx`` is a :class:`BlockCtx`: mode "seq" (a full sequence, no cache),
"prefill" (a full prompt that also fills the cache) or "step" (one new token
per row against the cache). Shapes: h [B, S, D]; a layer's cache is
``{"k", "v"}`` of [B, Ck, K, hd] (see ``models/kvcache.py``).

"seq" and "prefill" attention run through ``ops.flash_attention`` (every row
has positions 0..S-1, so the reference's ``_attend`` there is exactly causal
end-aligned attention); "step" attention against the cache is the plain
:func:`_attend`, as it is jnp in the reference. Every block ends in the fused
adapter kernel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapter import apply_adapter
from repro_torch.kernels import ops

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


def norm(cfg: ModelConfig, p, x):
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"{cfg.norm} is not ported yet ({_LATER})")
    return rmsnorm(p, x)


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
            k_pos: torch.Tensor, *, causal: bool, window: Optional[int]) -> torch.Tensor:
    """q [B, Sq, H, hd]; k, v [B, Sk, K, hd]; positions [B, S*] (k_pos -1 = empty slot).

    fp32 scores, masked to -1e30; probabilities zeroed where masked and cast to
    ``v.dtype`` before PV, as the reference's ``blocks._attend``.
    """
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd).float()
    s = torch.einsum("bckgh,bskh->bkgcs", qg, k.float()) * (1.0 / math.sqrt(hd))
    m = (k_pos[:, None, :] >= 0)
    if causal:
        m = m & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        m = m & ((q_pos[:, :, None] - k_pos[:, None, :]) < window)
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

    new_cache = None
    if ctx.mode == "step":
        b_idx = torch.arange(B, device=x.device)[:, None]
        cache["k"][b_idx, ctx.write_slots] = kk.to(cache["k"].dtype)
        cache["v"][b_idx, ctx.write_slots] = vv.to(cache["v"].dtype)
        new_cache = cache
        out = _attend(q, cache["k"], cache["v"], ctx.positions, ctx.cache_positions,
                      causal=ctx.causal, window=cfg.sliding_window)
    else:
        if ctx.mode == "prefill":
            # gather-fill: write_slots [B, Ck] is the prompt index landing in each slot
            gi = ctx.write_slots[:, :, None, None].expand(-1, -1, K, hd)
            new_cache = {"k": kk.gather(1, gi).to(cache["k"].dtype),
                         "v": vv.gather(1, gi).to(cache["v"].dtype)}
        out = ops.flash_attention(q, kk, vv, causal=ctx.causal, window=cfg.sliding_window,
                                  impl=ctx.impl)
    y = out.to(x.dtype).reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, D)
    return y, new_cache


def apply_block(kind: str, cfg: ModelConfig, p: Dict, h: torch.Tensor, ctx: BlockCtx,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    if kind != "dense":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet ({_LATER})")
    a, new_cache = attention(cfg, p["attn"], norm(cfg, p["ln1"], h), ctx, cache)
    h = h + a
    h = h + ffn(cfg, p["ffn"], norm(cfg, p["ln2"], h))
    # the paper's serial adapter, after the FFN sublayer
    h = apply_adapter(p["adapter"], h, activation=cfg.adapter.activation, impl=ctx.impl)
    return h, new_cache
