"""Per-tenant adapter bundles and one tenant's handle on a session (the
reference's ``api/tenants.py``).

A multi-tenant ``RingSession`` (``tenants=T``) trains T adapter-and-head
sets over one frozen trunk. This module moves them around:

  * :class:`AdapterStore`: a directory of named bundles, each one tenant's
    trainable set ``{"adapter": [R, C, ...] tree, "head": head tree}`` in the
    checkpoint format (``<root>/<name>.npz`` + ``.json``, tagged
    ``AdapterStore/v1``), its Adam moments under the ``opt::`` keys. Training
    writes them; the serve registry (``launch/serve.py``) reads them and
    hot-swaps a bundle whose payload mtime moved. A bundle written by either
    package reads in the other.
  * :class:`TenantGroup`: one tenant's view of a live session: its loss out
    of the joint round's metrics, its cache counts, and ``save_to`` /
    ``load_from`` through a store (a load frees only that tenant's cache
    rows).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint import checkpoint as ckpt

BUNDLE_FORMAT = "AdapterStore/v1"


class AdapterStore:
    """Directory-backed store of named adapter bundles (names are plain
    file names: ``[A-Za-z0-9_.-]``)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

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

    def put(self, name: str, bundle: Dict[str, Any], *, opt: Any = None, step: int = 0,
            meta: Optional[Dict[str, Any]] = None) -> None:
        """Write one tenant's ``{"adapter", "head"}`` bundle (and its moments
        under ``opt::``). The ``.npz`` lands before the ``.json`` that
        announces it, so a watching registry never reads half a bundle."""
        if set(bundle) != {"adapter", "head"}:
            raise ValueError(f"a bundle has exactly the keys {{'adapter', 'head'}} "
                             f"(RingExecutor.export_adapters's layout), got {sorted(bundle)}")
        ckpt.save(self._path(name), bundle, step=step, opt_state=opt,
                  extra={"format": BUNDLE_FORMAT, **(meta or {})})

    def get(self, name: str, like: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Load a bundle into the structure and shapes of ``like``; ``(bundle, meta)``."""
        bundle, meta = ckpt.restore(self._path(name), like)
        fmt = meta.get("extra", {}).get("format")
        if fmt != BUNDLE_FORMAT:
            raise ValueError(f"{self._path(name)!r} is not an adapter bundle "
                             f"(format={fmt!r}); AdapterStore only reads its own entries")
        return bundle, meta

    def get_opt(self, name: str, like: Any) -> Any:
        """A bundle's Adam moments (raises if it was written without them)."""
        return ckpt.restore_opt(self._path(name), like)

    def has_opt(self, name: str) -> bool:
        with open(self._path(name) + ".json") as f:
            return bool(json.load(f).get("has_opt_state"))


class TenantGroup:
    """One tenant's handle on a live session, from ``RingSession.tenants``.
    Every method addresses tenant ``index`` of the session's executor;
    ``load_from`` frees only this tenant's cache rows."""

    def __init__(self, session, index: int):
        self.session = session
        self.index = index

    def __repr__(self) -> str:
        return f"TenantGroup({self.index} of {getattr(self.session.backend, 'T', 1)})"

    @property
    def _driver(self):
        d = getattr(self.session.backend, "driver", None)
        if d is None or not hasattr(d, "export_adapters"):
            raise NotImplementedError(f"backend {self.session.backend.name!r} has no "
                                      f"per-tenant adapter surface")
        return d

    def metrics(self, m) -> Dict[str, Any]:
        """This tenant's slice of a materialized RoundMetrics: its own loss
        out of the joint round and its cache hits and misses."""
        out = {"step": m.step, "boundary": m.boundary, "depth": m.depth, "tenant": self.index}
        tl = m.extras.get("tenant_losses")
        out["loss"] = tl[self.index] if tl is not None else m.loss
        if m.cache and "tenant_cache_hits" in m.cache:
            out["cache_hits"] = m.cache["tenant_cache_hits"][self.index]
            out["cache_misses"] = m.cache["tenant_cache_misses"][self.index]
        return out

    def export_adapters(self) -> Dict[str, Any]:
        return self._driver.export_adapters(self.index)

    def export_opt(self) -> Dict[str, Any]:
        return self._driver.export_tenant_opt(self.index)

    def save_to(self, store: AdapterStore, name: str, *,
                meta: Optional[Dict[str, Any]] = None) -> None:
        """Write this tenant's adapters and moments as the store's entry
        ``name``, servable at once by a watching registry."""
        store.put(name, self.export_adapters(), opt=self.export_opt(),
                  step=self.session.step_count,
                  meta={"tenant": self.index, **(meta or {})})

    def load_from(self, store: AdapterStore, name: str) -> None:
        """Copy the store's entry ``name`` into this tenant's slot (its
        moments too, if the entry has them); only this tenant's cache rows
        are freed. A bundle whose frozen rows differ from the other
        tenants' is refused (``RingExecutor.check_shared_trunk``)."""
        bundle, _ = store.get(name, self.export_adapters())
        self._driver.import_adapters(self.index, bundle)
        if store.has_opt(name):
            self._driver.import_tenant_opt(self.index, store.get_opt(name, self.export_opt()))
