"""Checkpoint reading: the reference's flat-key ``.npz`` + JSON format.

A checkpoint is ``<path>.npz`` with one array per leaf under its ``::``-joined
key path, and ``<path>.json`` with the step and each key's dtype; bf16 is
stored as raw ``uint16``. Only the read side is ported so far (serving); the
write side comes with training.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np
import torch

SEP = "::"


def _as_tensor(arr: np.ndarray, dtype_tag: str, like: torch.Tensor) -> torch.Tensor:
    if dtype_tag == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.reshape(like.shape).to(like.device)


def _restore_into(like: Any, data, dtypes: Dict[str, str], prefix: str) -> Any:
    if isinstance(like, dict):
        return {k: _restore_into(v, data, dtypes, f"{prefix}{k}{SEP}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_restore_into(v, data, dtypes, f"{prefix}{i}{SEP}") for i, v in enumerate(like)]
    key = prefix[: -len(SEP)]
    if key not in data.files:
        return like                     # missing keys keep ``like``'s value
    return _as_tensor(data[key], dtypes.get(key, ""), like)


def restore(path: str, like: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (nested dicts/lists of tensors).

    Each restored leaf keeps the stored dtype and takes ``like``'s shape and
    device; a key missing from the checkpoint keeps ``like``'s value.
    """
    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path + ".npz") as data:
        tree = _restore_into(like, data, meta["dtypes"], "")
    return tree, meta
