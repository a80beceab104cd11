"""Checkpoints in the reference's format: flat-key ``.npz`` + JSON.

A checkpoint is ``<path>.npz`` with one array per leaf under its key path (a
dict key by name, a list or tuple entry by index, joined by ``::``) and
``<path>.json`` with the step, each key's dtype and the caller's ``extra``;
bf16 is stored as raw ``uint16`` tagged ``"bfloat16"``. Trees in the
reference's layout (``repro_torch.bridge``) give the reference's keys, so a
file written here restores in the JAX package's ``checkpoint`` and the
reverse, bit for bit.

``adapters_only=True`` keeps the trainable set: the keys with an ``adapter``
component and those under ``head``. Optimizer state rides along under the
reserved ``opt::`` namespace and is never filtered (the moments cover only
the trainable set, and a resume without them diverges); :func:`restore_opt`
is its strict inverse.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

SEP = "::"
OPT_NS = "opt"       # reserved top-level namespace for optimizer-state keys


def _stored(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf (tensor, numpy array or scalar) as the array the file holds and its dtype tag."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":       # a numpy bf16 (ml_dtypes) array
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{key path: leaf}`` with the reference's keys."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[: -len(SEP)]: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}{SEP}"))
    return out


def _key_filter(key: str, adapters_only: bool) -> bool:
    if not adapters_only:
        return True
    return ("adapter" in key.split(SEP)) or key.startswith("head")


def save(path: str, params: Any, *, step: int = 0, extra: Optional[Dict] = None,
         adapters_only: bool = False, opt_state: Any = None) -> None:
    """Write ``params`` (and ``opt_state`` under ``opt::``) to ``path``.npz / .json."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: v for k, v in _flatten(params).items() if _key_filter(k, adapters_only)}
    if opt_state is not None:
        flat.update({OPT_NS + SEP + k: v for k, v in _flatten(opt_state).items()})
    payload, dtypes = {}, {}
    for k, v in flat.items():
        payload[k], dtypes[k] = _stored(v)
    np.savez(path + ".npz", **payload)
    meta = {"step": step, "dtypes": dtypes, "adapters_only": adapters_only,
            "has_opt_state": opt_state is not None, "extra": extra or {}}
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def _as_tensor(arr: np.ndarray, dtype_tag: str, like: torch.Tensor) -> torch.Tensor:
    if dtype_tag == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.reshape(like.shape).to(like.device)


def _restore_into(like: Any, data, dtypes: Dict[str, str], prefix: str,
                  strict: bool = False) -> Any:
    if isinstance(like, dict):
        return {k: _restore_into(v, data, dtypes, f"{prefix}{k}{SEP}", strict)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_restore_into(v, data, dtypes, f"{prefix}{i}{SEP}", strict)
                for i, v in enumerate(like)]
    key = prefix[: -len(SEP)]
    if key not in data.files:
        if strict:
            # moments reset to the live values would make a "resumed" run
            # diverge without an error
            raise KeyError(f"checkpoint is missing key {key!r} for the requested tree "
                           f"(layout mismatch between the checkpoint and this session)")
        return like                     # missing keys keep ``like``'s value
    return _as_tensor(data[key], dtypes.get(key, ""), like)


def restore(path: str, like: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (nested dicts/lists of tensors).

    Each restored leaf keeps the stored dtype and takes ``like``'s shape and
    device; a key missing from the checkpoint keeps ``like``'s value (an
    ``adapters_only`` file leaves the frozen trunk to the caller).
    """
    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path + ".npz") as data:
        tree = _restore_into(like, data, meta["dtypes"], "")
    return tree, meta


def restore_opt(path: str, opt_like: Any) -> Any:
    """The optimizer state saved by ``save(..., opt_state=...)``, in the
    structure and shapes of ``opt_like``. Raises if the file holds none, and
    on any ``opt_like`` leaf missing from it."""
    with open(path + ".json") as f:
        meta = json.load(f)
    if not meta.get("has_opt_state"):
        raise ValueError(f"checkpoint {path!r} has no optimizer state (saved with "
                         f"opt_state=None); resuming from it would silently reset the Adam "
                         f"moments")
    with np.load(path + ".npz") as data:
        return _restore_into(opt_like, data, meta["dtypes"], OPT_NS + SEP, strict=True)
