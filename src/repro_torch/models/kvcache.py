"""KV caches for serving dense decoders.

Layout: one ``{"k", "v"}`` entry per layer, each ``[B, Ck, K, hd]``, plus

  {"pos": [B, Ck] int64  (absolute position held in each slot, -1 = empty),
   "next": [B] int64     (number of tokens in the cache so far)}

Sliding-window archs keep a ring buffer of ``n_sink + window`` slots; full
attention keeps ``seq_len`` slots. The cache is bf16 by default whatever the
model's dtype, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict

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


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               dtype: torch.dtype = torch.bfloat16, device="cpu") -> Dict[str, Any]:
    ck = cache_len(cfg, seq_len)
    shape = (batch, ck, cfg.n_kv_heads, cfg.head_dim)
    return {
        "layers": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)}
                   for _ in range(cfg.n_layers)],
        "pos": torch.full((batch, ck), -1, dtype=torch.int64, device=device),
        "next": torch.zeros((batch,), dtype=torch.int64, device=device),
    }
