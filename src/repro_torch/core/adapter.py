"""Serial adapter module — the paper's parameter-efficient trainable unit.

RingAda eq. (1):    h  <-  h + sigma(h @ W_down) @ W_up

It sits after each block's FFN sublayer. Served through the fused
``adapter_fused`` kernel on the card; ``impl="plain"`` is the plain version.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ops


def apply_adapter(p: Dict[str, torch.Tensor], h: torch.Tensor, *,
                  activation: str = "gelu", impl: str = "kernel") -> torch.Tensor:
    """Apply the serial adapter to ``h`` ([..., D])."""
    return ops.adapter_fused(h, p["w_down"], p["w_up"], activation=activation, impl=impl)
