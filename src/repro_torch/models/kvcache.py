"""KV and recurrent-state caches for serving.

Layout: one entry per layer,

  dense : {"k", "v"}, each [B, Ck, K, hd] (a moe layer's too)
  rwkv  : {"state": [B, H, hd, hd] f32, "px_tm": [B, D], "px_cm": [B, D]}
  hymba : dense + {"ssm": [B, di, N] f32, "conv": [B, W-1, di]}

(``px_*`` hold the last token of the time and channel mixes' normed input,
which the next token shifts against; prefill writes them at that input's
dtype; ``conv`` holds the last W-1 inputs of the Mamba mix's causal conv, and
prefill writes it at the model's dtype), plus

  {"pos": [B, Ck] int64  (absolute position held in each slot, -1 = empty),
   "next": [B] int64     (number of tokens in the cache so far)}

Sliding-window archs keep a ring buffer of ``n_sink + window`` slots; full
attention keeps ``seq_len`` slots; hymba's first ``n_sink`` = 128 slots hold
its meta tokens, never evicted. The cache is bf16 by default whatever the
model's dtype, as in the reference. RWKV caches O(1) state only.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import ModelConfig


def n_sink(cfg: ModelConfig) -> int:
    return 128 if any(k == "hymba" for k, _ in cfg.pattern) else 0


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Number of KV slots required to decode at position ``seq_len``."""
    if cfg.sliding_window is not None:
        return min(seq_len, n_sink(cfg) + cfg.sliding_window)
    return seq_len


def write_slot(cfg: ModelConfig, pos: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Ring-buffer slot for absolute position ``pos`` (any int tensor)."""
    ck = cache_len(cfg, seq_len)
    ns = n_sink(cfg)
    if cfg.sliding_window is None or ck == seq_len:
        return pos
    w = ck - ns
    return torch.where(pos < ns, pos, ns + (pos - ns) % w)


def _layer_entry(cfg: ModelConfig, kind: str, batch: int, ck: int, dtype: torch.dtype,
                 device) -> Dict[str, torch.Tensor]:
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    if kind in ("dense", "moe", "hymba"):
        shape = (batch, ck, cfg.n_kv_heads, cfg.head_dim)
        entry = {"k": zeros(*shape), "v": zeros(*shape)}
        if kind == "hymba":
            di = cfg.n_heads * cfg.head_dim
            entry["ssm"] = zeros(batch, di, cfg.ssm.state_size, dt=torch.float32)
            entry["conv"] = zeros(batch, cfg.ssm.conv_width - 1, di)
        return entry
    if kind == "rwkv":
        hd = cfg.ssm.head_dim
        return {"state": zeros(batch, cfg.d_model // hd, hd, hd, dt=torch.float32),
                "px_tm": zeros(batch, cfg.d_model), "px_cm": zeros(batch, cfg.d_model)}
    raise NotImplementedError(f"no cache for block kind {kind!r} yet")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The block kind of each layer, in order (repeats of the pattern)."""
    return [kind for _ in range(cfg.repeats) for kind, count in cfg.pattern
            for _ in range(count)]


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               dtype: torch.dtype = torch.bfloat16, device="cpu") -> Dict[str, Any]:
    ck = cache_len(cfg, seq_len)
    return {
        "layers": [_layer_entry(cfg, kind, batch, ck, dtype, device)
                   for kind in layer_kinds(cfg)],
        "pos": torch.full((batch, ck), -1, dtype=torch.int64, device=device),
        "next": torch.zeros((batch,), dtype=torch.int64, device=device),
    }
