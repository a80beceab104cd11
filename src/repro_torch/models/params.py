"""Parameter shapes, init scales and materialization for the port.

The definitions mirror the reference's ``models/params.py`` leaf for leaf (same
names, shapes, init kinds and fan-in scales). The port keeps one dict per layer
instead of the reference's stacked ``[repeats, count, ...]`` leaves:

    {"embed": {"tok", "pos" (learned positions, rope=False)}, "final_norm": {"scale"},
     "head": {"w"}, "blocks": [ one block's tree for each layer ]}

a dense block is ``{"ln1", "attn", "ln2", "ffn", "adapter"}``, a moe block
``{"ln1", "attn", "ln2", "moe", "adapter"}``, an rwkv block
``{"ln1", "ln2", "rwkv", "adapter"}``, a hymba block ``{"ln1", "attn", "ssm",
"norm_attn", "norm_ssm", "ln2", "ffn", "adapter"}``; a model with hymba blocks
also has the top-level ``"meta"`` leaf, its 128 learned meta tokens [128, D].

``repro_torch.bridge`` converts between the two layouts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import device as dev_rule
from repro_torch.configs.base import ModelConfig

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
_SLICED_INIT = 2 ** 30           # entries of a leaf above which it is drawn slice by slice


@dataclass(frozen=True)
class PD:
    """Declarative parameter definition."""

    shape: Tuple[int, ...]
    init: str = "normal"            # normal | zeros | ones | rwkv_decay | arange_log
    scale: Optional[float] = None   # stddev for normal; default 1/sqrt(fan-in)
    dtype: Optional[str] = None     # override the model dtype
    # rwkv_decay: (this layer's index, layer count) in its pattern entry's stack
    ramp: Tuple[int, int] = (0, 1)


def norm_defs(cfg: ModelConfig) -> Dict[str, PD]:
    d = {"scale": PD((cfg.d_model,), "ones", dtype="float32")}
    if cfg.norm == "layernorm":
        d["bias"] = PD((cfg.d_model,), "zeros", dtype="float32")
    return d


def adapter_defs(cfg: ModelConfig) -> Dict[str, PD]:
    """The paper's serial adapter: h <- h + sigma(h Wd) Wu  (eq. 1)."""
    m = cfg.adapter.bottleneck
    return {
        "w_down": PD((cfg.d_model, m)),
        "w_up": PD((m, cfg.d_model), "zeros" if cfg.adapter.zero_init_up else "normal"),
    }


def attn_defs(cfg: ModelConfig) -> Dict[str, PD]:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    d = {
        "wq": PD((D, H, hd)),
        "wk": PD((D, K, hd)),
        "wv": PD((D, K, hd)),
        "wo": PD((H, hd, D)),
    }
    if cfg.qkv_bias:
        d["bq"] = PD((H, hd), "zeros")
        d["bk"] = PD((K, hd), "zeros")
        d["bv"] = PD((K, hd), "zeros")
    return d


def ffn_defs(cfg: ModelConfig) -> Dict[str, PD]:
    D, F = cfg.d_model, cfg.d_ff
    if cfg.glu:
        return {"w_gate": PD((D, F)), "w_up": PD((D, F)), "w_down": PD((F, D))}
    d = {"w_in": PD((D, F)), "w_out": PD((F, D))}
    if cfg.norm == "layernorm":
        d["b_in"] = PD((F,), "zeros")
        d["b_out"] = PD((D,), "zeros")
    return d


def moe_defs(cfg: ModelConfig) -> Dict[str, PD]:
    """The router, the E experts' gated FFNs stacked on a leading expert
    axis, and the one shared expert the reference adds to every moe block."""
    m = cfg.moe
    D, E, F = cfg.d_model, m.n_experts, m.d_expert
    return {
        "router": PD((D, E), scale=0.02),
        "we_gate": PD((E, D, F)),
        "we_up": PD((E, D, F)),
        "we_down": PD((E, F, D)),
        "ws_gate": PD((D, F)),
        "ws_up": PD((D, F)),
        "ws_down": PD((F, D)),
    }


def rwkv_defs(cfg: ModelConfig, ramp: Tuple[int, int] = (0, 1)) -> Dict[str, PD]:
    """RWKV-6 (Finch): data-dependent token shift + decay via LoRA."""
    D = cfg.d_model
    hd = cfg.ssm.head_dim
    H = D // hd
    lora = cfg.ssm.decay_lora
    F = cfg.d_ff
    return {
        # --- time mix ---
        "mu": PD((5, D), scale=0.02),                 # r, k, v, w, g base mix
        "tm_w1": PD((D, 5 * 32), scale=0.02),         # ddlerp LoRA A (rank 32 each)
        "tm_w2": PD((5, 32, D), scale=0.02),
        "dd_w1": PD((D, lora), scale=0.02),           # decay LoRA A
        "dd_w2": PD((lora, D), scale=0.02),
        "decay_base": PD((H, hd), "rwkv_decay", ramp=ramp),
        "bonus_u": PD((H, hd), scale=0.5),
        "wr": PD((D, H, hd)),
        "wk": PD((D, H, hd)),
        "wv": PD((D, H, hd)),
        "wg": PD((D, H, hd)),
        "wo": PD((H, hd, D)),
        "ln_x": PD((D,), "ones", dtype="float32"),    # group-norm scale
        # --- channel mix ---
        "mu_ck": PD((D,), scale=0.02),
        "mu_cr": PD((D,), scale=0.02),
        "wk_c": PD((D, F)),
        "wv_c": PD((F, D)),
        "wr_c": PD((D, D)),
    }


def mamba_defs(cfg: ModelConfig) -> Dict[str, PD]:
    """Mamba-style selective SSM head bank (the SSM half of a Hymba block)."""
    D = cfg.d_model
    di = cfg.n_heads * cfg.head_dim          # d_inner matches the attention width
    N, R, W = cfg.ssm.state_size, cfg.ssm.dt_rank, cfg.ssm.conv_width
    return {
        "in_proj": PD((D, di)),
        "conv_w": PD((W, di), scale=0.2),
        "x_proj": PD((di, R + 2 * N)),
        "dt_proj": PD((R, di), scale=0.1),
        "dt_bias": PD((di,), "zeros"),
        "a_log": PD((di, N), "arange_log"),
        "d_skip": PD((di,), "ones"),
    }


def block_defs(cfg: ModelConfig, kind: str, ramp: Tuple[int, int] = (0, 1)) -> Dict[str, Any]:
    """One layer's definitions; ``ramp`` places an rwkv layer in its stack."""
    if kind == "dense":
        return {"ln1": norm_defs(cfg), "attn": attn_defs(cfg),
                "ln2": norm_defs(cfg), "ffn": ffn_defs(cfg),
                "adapter": adapter_defs(cfg)}
    if kind == "moe":
        return {"ln1": norm_defs(cfg), "attn": attn_defs(cfg),
                "ln2": norm_defs(cfg), "moe": moe_defs(cfg),
                "adapter": adapter_defs(cfg)}
    if kind == "rwkv":
        return {"ln1": norm_defs(cfg), "ln2": norm_defs(cfg),
                "rwkv": rwkv_defs(cfg, ramp), "adapter": adapter_defs(cfg)}
    if kind == "hymba":
        di = cfg.n_heads * cfg.head_dim
        return {"ln1": norm_defs(cfg), "attn": attn_defs(cfg), "ssm": mamba_defs(cfg),
                "norm_attn": PD((di,), "ones", dtype="float32"),
                "norm_ssm": PD((di,), "ones", dtype="float32"),
                "ln2": norm_defs(cfg), "ffn": ffn_defs(cfg),
                "adapter": adapter_defs(cfg)}
    raise NotImplementedError(
        f"block kind {kind!r} is not ported yet (Queue 1 slice 'other "
        f"block kinds' of ROADMAP.md); the port runs dense, moe, rwkv and hymba blocks")


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.enc_dec or cfg.frontend:
        raise NotImplementedError(f"{cfg.name}: encoders and frontends are not ported yet")
    blocks = []
    for r in range(cfg.repeats):
        for kind, count in cfg.pattern:
            blocks.extend(block_defs(cfg, kind, ramp=(r * count + c, cfg.repeats * count))
                          for c in range(count))
    embed = {"tok": PD((cfg.padded_vocab, cfg.d_model), scale=0.02)}
    if not cfg.rope:                  # learned position table
        embed["pos"] = PD((min(cfg.max_seq_len, 8192), cfg.d_model), scale=0.02)
    defs = {
        "embed": embed,
        "final_norm": norm_defs(cfg),
        "head": {"w": PD((cfg.d_model, cfg.out_dim))},
        "blocks": blocks,
    }
    if any(kind == "hymba" for kind, _ in cfg.pattern):
        defs["meta"] = PD((128, cfg.d_model), scale=0.02)      # Hymba's meta tokens
    return defs


def count_params(cfg: ModelConfig) -> int:
    return sum(math.prod(pd.shape) for pd in tree_leaves(param_defs(cfg)))


def _init_leaf(pd: PD, dtype: torch.dtype, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    dt = DTYPES[pd.dtype] if pd.dtype else dtype
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dt, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dt, device=device)
    if pd.init == "rwkv_decay":
        return _decay_ramp(pd.shape, *pd.ramp, device=device).to(dt)
    if pd.init == "arange_log":
        # the Mamba A init: -[1..N] broadcast over channels, stored as log
        a = torch.arange(1, pd.shape[-1] + 1, dtype=torch.float32, device=device)
        return torch.log(a).expand(pd.shape).to(dt).contiguous()
    # the reference's fan-in is the second-to-last dim (of the unstacked shape)
    fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
    scale = pd.scale if pd.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    if math.prod(pd.shape) > _SLICED_INIT:
        # a stack of expert matrices (llama4's are 5.4 G entries): one slice of
        # the leading axis at a time, so the f32 draw never holds the whole leaf
        out = torch.empty(pd.shape, dtype=dt, device=device)
        for i in range(pd.shape[0]):
            x = torch.randn(pd.shape[1:], generator=gen, dtype=torch.float32, device=device)
            out[i] = x * scale
        return out
    x = torch.randn(pd.shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dt)


def _decay_ramp(shape: Tuple[int, ...], index: int, count: int, device) -> torch.Tensor:
    """Layer ``index``'s slice of the reference's per-channel decay prior.

    The reference fills the whole stacked ``[repeats, count, H, hd]`` leaf with
    one f32 ``jnp.linspace(-6, -0.5, n)`` (so each layer gets its own part of the
    ramp, and the last entry is exactly -0.5). XLA compiles its
    ``start * (1 - i / (n-1)) + stop * i / (n-1)`` into two fused
    multiply-adds with the constants ``c = 1 / (n-1)`` and ``stop * c``:
    ``fma(i, stop * c, start * fma(-i, c, 1))``. The products of f32 values are
    exact in f64, so each fma here is an f64 sum rounded to f32.
    """
    n = math.prod(shape)
    div = n * count - 1
    start, stop = -6.0, -0.5
    idx = torch.arange(index * n, (index + 1) * n, device=device)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    c = f32(1.0) / f32(float(div))
    stop_c = f32(stop) * c
    i = idx.float().double()
    one_minus = (-i * c.double() + 1.0).float()
    out = (i * stop_c.double() + (start * one_minus).double()).float()
    return torch.where(idx == div, f32(stop), out).reshape(shape)


def materialize(cfg: ModelConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random parameters for ``cfg`` from ``seed``, made on ``device`` (default cuda).

    The reference's init kinds and scales with a ``torch.Generator`` on the
    device: the numbers differ from JAX's, so tests that compare the packages
    carry JAX-made weights across with ``repro_torch.bridge``.
    """
    device = dev_rule.resolve(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dtype = DTYPES[cfg.dtype]
    return tree_map(lambda pd: _init_leaf(pd, dtype, gen, device), param_defs(cfg))
