"""Weights carried across from the JAX package's layout to the port's.

The reference stacks each layer-pattern entry's leaves as ``[repeats, count,
...]`` (``blocks`` is a tuple aligned with ``cfg.pattern``); the port keeps one
dict per layer. The stacking and unstacking happen here and nowhere else.

Input arrays are numpy (``np.asarray`` of a JAX array). bf16 arrives as the
``bfloat16`` numpy extension type and crosses through a 16-bit integer view, as
the reference's checkpoints store it, so this module needs no JAX and no
``ml_dtypes`` import.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch import device as dev_rule
from repro_torch.configs.base import ModelConfig


def to_tensor(arr: Any, device=None) -> torch.Tensor:
    """numpy (bf16 included) -> torch tensor on ``device`` (default cuda)."""
    device = dev_rule.resolve(device)
    arr = np.asarray(arr)
    if not arr.flags.writeable:        # e.g. a view of a JAX array
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device)


def unstack_layers(entry: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One pattern entry's ``[R, C, ...]`` leaves -> a list of R*C per-layer trees."""
    first = entry
    while isinstance(first, dict):
        first = next(iter(first.values()))
    R, C = first.shape[:2]
    return [tree_map(lambda x, r=r, c=c: x[r, c], entry) for r in range(R) for c in range(C)]


def stack_layers(layers: List[Dict[str, Any]], repeats: int) -> Dict[str, Any]:
    """Inverse of :func:`unstack_layers` for tensors: ``[R, C, ...]`` leaves."""
    count = len(layers) // repeats

    def stack(path_leaves):
        return torch.stack(path_leaves).reshape(
            (repeats, count) + tuple(path_leaves[0].shape))

    def rec(nodes):
        if isinstance(nodes[0], dict):
            return {k: rec([n[k] for n in nodes]) for k in nodes[0]}
        return stack(nodes)

    return rec(layers)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """The reference's parameter tree (numpy leaves) -> the port's parameters,
    on ``device`` (default cuda).

    Layers come out in the reference's order: for each repeat, each pattern
    entry's ``count`` layers. Hymba's top-level ``meta`` leaf comes along.
    """
    kinds = {k for k, _ in cfg.pattern}
    if not kinds <= {"dense", "rwkv", "hymba"} or cfg.enc_dec or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: the port carries dense, rwkv and hymba decoders only")
    device = dev_rule.resolve(device)
    conv = lambda x: to_tensor(x, device)
    entries = [unstack_layers(e) for e in tree["blocks"]]
    blocks = []
    for r in range(cfg.repeats):
        for entry, (_, count) in zip(entries, cfg.pattern):
            blocks.extend(tree_map(conv, layer) for layer in entry[r * count:(r + 1) * count])
    out = {
        "embed": tree_map(conv, dict(tree["embed"])),
        "final_norm": tree_map(conv, tree["final_norm"]),
        "head": tree_map(conv, tree["head"]),
        "blocks": blocks,
    }
    if "meta" in tree:
        out["meta"] = conv(tree["meta"])
    return out
