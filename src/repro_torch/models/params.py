"""Parameter shapes, init scales and materialization for the port.

The definitions mirror the reference's ``models/params.py`` leaf for leaf (same
names, shapes, init kinds and fan-in scales). The port keeps one dict per layer
instead of the reference's stacked ``[repeats, count, ...]`` leaves:

    {"embed": {"tok"}, "final_norm": {"scale"}, "head": {"w"},
     "blocks": [ {"ln1", "attn", "ln2", "ffn", "adapter"} for each layer ]}

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


@dataclass(frozen=True)
class PD:
    """Declarative parameter definition."""

    shape: Tuple[int, ...]
    init: str = "normal"            # normal | zeros | ones
    scale: Optional[float] = None   # stddev for normal; default 1/sqrt(fan-in)
    dtype: Optional[str] = None     # override the model dtype


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


def block_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    if kind != "dense":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (Queue 1 slice 'other "
            f"block kinds' of ROADMAP.md); the port runs dense decoders")
    return {"ln1": norm_defs(cfg), "attn": attn_defs(cfg),
            "ln2": norm_defs(cfg), "ffn": ffn_defs(cfg),
            "adapter": adapter_defs(cfg)}


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    if not cfg.rope or cfg.enc_dec or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: learned positions, encoders and frontends are not ported yet")
    blocks = []
    for _ in range(cfg.repeats):
        for kind, count in cfg.pattern:
            blocks.extend(block_defs(cfg, kind) for _ in range(count))
    return {
        "embed": {"tok": PD((cfg.padded_vocab, cfg.d_model), scale=0.02)},
        "final_norm": norm_defs(cfg),
        "head": {"w": PD((cfg.d_model, cfg.out_dim))},
        "blocks": blocks,
    }


def count_params(cfg: ModelConfig) -> int:
    return sum(math.prod(pd.shape) for pd in tree_leaves(param_defs(cfg)))


def _init_leaf(pd: PD, dtype: torch.dtype, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    dt = DTYPES[pd.dtype] if pd.dtype else dtype
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dt, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dt, device=device)
    # the reference's fan-in is the second-to-last dim (of the unstacked shape)
    fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
    scale = pd.scale if pd.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(pd.shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dt)


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
