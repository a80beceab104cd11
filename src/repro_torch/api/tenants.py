"""Reading per-tenant adapter bundles: the read side of ``AdapterStore``.

An ``AdapterStore`` is a directory of named bundles, each one tenant's
trainable set ``{"adapter": [R, C, ...] tree, "head": head tree}`` in the
checkpoint format (``<root>/<name>.npz`` + ``.json``, tagged
``AdapterStore/v1``). Training writes them; the serve registry reads them and
hot-swaps a bundle whose payload mtime moved. The write side comes with
training.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

from repro_torch.checkpoint import checkpoint as ckpt

BUNDLE_FORMAT = "AdapterStore/v1"


class AdapterStore:
    """Directory-backed store of named adapter bundles (read side)."""

    def __init__(self, root: str):
        self.root = root

    def _path(self, name: str) -> str:
        if os.sep in name or name.startswith("."):
            raise ValueError(f"bundle name {name!r} must be a plain filename")
        return os.path.join(self.root, name)

    def names(self) -> List[str]:
        return sorted(f[:-5] for f in os.listdir(self.root) if f.endswith(".json"))

    def __contains__(self, name: str) -> bool:
        return os.path.exists(self._path(name) + ".json")

    def mtime(self, name: str) -> float:
        """Payload mtime — the serve registry's staleness probe."""
        return os.path.getmtime(self._path(name) + ".npz")

    def get(self, name: str, like: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Load a bundle into the structure and shapes of ``like``; ``(bundle, meta)``."""
        bundle, meta = ckpt.restore(self._path(name), like)
        fmt = meta.get("extra", {}).get("format")
        if fmt != BUNDLE_FORMAT:
            raise ValueError(f"{self._path(name)!r} is not an adapter bundle "
                             f"(format={fmt!r}); AdapterStore only reads its own entries")
        return bundle, meta
