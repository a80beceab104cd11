"""Boundary-activation cache: reuse of the frozen trunk's output on the device
(the reference's ``core/actcache.py``).

RingAda's unfreeze schedule is monotone top-down, so every layer below the
boundary is frozen and Phase A (the forward-only ticks through the frozen
trunk) recomputes, round after round, inputs of stage F that are the same
bits until the boundary drops. This cache keeps them, so the executor's
``cached`` round enters the ring at stage F and skips Phase A.

Storage is one preallocated tensor on the executor's device,
``[capacity, *entry_shape]``, allocated once (at the first ``put`` or
``reserve``) and never reallocated while its shapes hold: the executor's
CUDA graphs write and read it at a fixed address. Writes go in place at a
row index that may be a device tensor (:func:`write_row`: the executor's
capture graph takes its row as an input, so one graph serves every row);
reads gather a row on the device (:func:`read_row`). This is the
counterpart of the reference's donated writer.

The entry's layout differs from the reference's. The reference stores
every stage's shard of the boundary activations, ``[S_stage, S_owner, M,
mb, seq, D]``, stage-sharded on its mesh; on one device only stage F's input
is ever read, so the port stores ``[S_owner, M, mb, seq, D]``, and
``cache_bytes_per_entry`` and ``cache_buffer_bytes`` are the reference's
divided by S. Every other ``stats()`` key is the reference's.

Entry dtypes (``dtype=``):

  * ``'native'`` (default): the bits as captured;
  * ``'f32'``: upcast to float32 (lossless for bf16 and f32 sources);
  * ``'bf16'``: bfloat16 (lossless when the model computes in bf16; half
    the bytes of f32);
  * ``'int8'``: symmetric per-row int8 over the trailing axis, ``s =
    max(max|x|, 1e-6) / 127``, round half to even, clipped to +-127, with
    the f32 scales in a sidecar ``[capacity, *entry_shape[:-1], 1]``. The
    reference's writer, as XLA compiles it, divides by 127 as a product with
    the f32 reciprocal of 127 (a constant divisor), and so does the port, so
    that both store the same scales.

Quantisation is plain tensor code, in the reference too (inside a jit, not
a Pallas kernel).

Keys are ``(slot, boundary)``. Eviction is LRU over ``capacity`` rows (an
``OrderedDict``); free rows sit in a list popped from the end. A boundary
drop makes every entry unreachable: ``invalidate()`` drops them all and
counts one event. The counts (hits, misses, evictions, invalidations,
bypasses) are kept in the reference's order.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

CACHE_DTYPES = ("native", "f32", "bf16", "int8")

_STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
_INV_127 = float(np.float32(1.0 / 127.0))       # the f32 constant the reference's writer uses


def quantize(entry: torch.Tensor, dtype: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """An entry as stored under cache dtype ``dtype``: ``(stored, scales or
    None)``. ``int8``: symmetric per row of the trailing axis, f32 scales."""
    if dtype == "int8":
        tf = entry.float()
        s = torch.clamp_min(tf.abs().amax(dim=-1, keepdim=True), 1e-6) * _INV_127
        q = torch.clamp(torch.round(tf / s), -127, 127).to(torch.int8)
        return q, s
    if dtype == "native":
        return entry, None
    return entry.to(_STORAGE[dtype]), None


def dequantize(stored: torch.Tensor, scales: Optional[torch.Tensor], dtype: str,
               out_dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize`, in the consumer's compute dtype;
    ``'native'`` entries pass through as they are."""
    if dtype == "int8":
        return (stored.float() * scales).to(out_dtype)
    if dtype == "native":
        return stored
    return stored.to(out_dtype)


def storage_dtype(dtype: str, src_dtype: torch.dtype) -> torch.dtype:
    """The buffer's dtype under cache dtype ``dtype`` for entries of ``src_dtype``."""
    return src_dtype if dtype == "native" else _STORAGE[dtype]


def _index(row, device: torch.device) -> torch.Tensor:
    """A row (an int or a 0-d integer tensor) as a one-element int64 index on ``device``."""
    return torch.as_tensor(row, dtype=torch.long, device=device).reshape(1)


def write_row(buf: torch.Tensor, scales: Optional[torch.Tensor], row, entry: torch.Tensor,
              dtype: str) -> None:
    """Quantise ``entry`` under ``dtype`` and write it into ``buf`` (and the
    int8 ``scales``) in place at ``row``, an int or a device tensor (no host
    synchronisation: a CUDA graph can hold the write)."""
    q, s = quantize(entry, dtype)
    idx = _index(row, buf.device)
    buf.index_copy_(0, idx, q.unsqueeze(0))
    if s is not None:
        scales.index_copy_(0, idx, s.unsqueeze(0))


def read_row(buf: torch.Tensor, scales: Optional[torch.Tensor], row, dtype: str,
             out_dtype: torch.dtype) -> torch.Tensor:
    """The entry at ``row`` (an int or a device tensor), gathered on the
    device and dequantised to ``out_dtype``."""
    idx = _index(row, buf.device)
    s = None if scales is None else scales.index_select(0, idx)[0]
    return dequantize(buf.index_select(0, idx)[0], s, dtype, out_dtype)


class ActivationCache:
    """LRU cache of boundary activations in one preallocated device buffer.

    ``capacity``: entries (batch slots) held at once; 0 disables the cache
    (every ``index_of`` misses, ``put`` bypasses). ``dtype``: the storage
    precision (module docstring). ``device``: where the buffer lives (by
    default the first entry's device). ``layout`` (any hashable; the
    executor passes its spans) binds the entries to the stage layout that
    produced them: ``set_layout`` flushes the cache when it changes.
    """

    def __init__(self, capacity: int, *, dtype: str = "native",
                 device: Optional[torch.device] = None, layout: Optional[Any] = None):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        if dtype not in CACHE_DTYPES:
            raise ValueError(f"dtype must be one of {CACHE_DTYPES}, got {dtype!r}")
        self.capacity = capacity
        self.dtype = dtype
        self.device = device
        self.layout = layout
        self._buf: Optional[torch.Tensor] = None
        self._scales: Optional[torch.Tensor] = None
        self._rows: "OrderedDict[Hashable, int]" = OrderedDict()   # key -> row
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._entry_shape: Optional[Tuple[int, ...]] = None
        self._src_dtype: Optional[torch.dtype] = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0       # boundary-drop (or manual) clear events
        self.bypasses = 0            # entries refused because they do not fit

    def __len__(self) -> int:
        return len(self._rows)

    @property
    def buffer(self) -> torch.Tensor:
        """The backing buffer ``[capacity, *entry_shape]``."""
        assert self._buf is not None, "cache is empty: no buffer yet"
        return self._buf

    @property
    def src_dtype(self) -> Optional[torch.dtype]:
        """The captured entries' dtype; None until the buffer is allocated."""
        return self._src_dtype

    @property
    def scales(self) -> Optional[torch.Tensor]:
        """The int8 scale sidecar ``[capacity, *entry_shape[:-1], 1]`` (f32);
        None for the other dtypes."""
        return self._scales

    def compatible(self, shape: Tuple[int, ...], dtype: Optional[torch.dtype] = None) -> bool:
        """Can an entry of this (pre-quantisation) shape, and source dtype if
        given, live in the buffer? Before the buffer exists any shape fits."""
        if self.capacity == 0:
            return False
        if self._entry_shape is None:
            return True
        if tuple(shape) != self._entry_shape:
            return False
        return dtype is None or dtype == self._src_dtype

    def entry_bytes(self) -> Optional[int]:
        """Bytes per entry (buffer row and scale row); None before allocation."""
        if self._buf is None:
            return None
        total = self._buf.element_size() * math.prod(self._buf.shape[1:])
        if self._scales is not None:
            total += self._scales.element_size() * math.prod(self._scales.shape[1:])
        return total

    def _ensure_buffer(self, shape: Tuple[int, ...], src_dtype: torch.dtype,
                       device: torch.device) -> None:
        if self._buf is not None:
            return
        self._entry_shape = tuple(shape)
        self._src_dtype = src_dtype
        device = self.device if self.device is not None else device
        full = (self.capacity,) + self._entry_shape
        self._buf = torch.zeros(full, dtype=storage_dtype(self.dtype, src_dtype), device=device)
        if self.dtype == "int8":
            self._scales = torch.zeros(full[:-1] + (1,), dtype=torch.float32, device=device)

    def reserve(self, key: Hashable, shape: Tuple[int, ...], src_dtype: torch.dtype,
                device: Optional[torch.device] = None) -> Optional[int]:
        """``put``'s bookkeeping without the write: allocate the buffer if
        there is none, take ``key``'s row (its own, else the LRU entry's,
        counted as an eviction, else a free one) and return it; None, counting
        a bypass, when such an entry cannot live in the buffer. The caller
        writes the row (:func:`write_row`, which a CUDA graph can hold)."""
        if not self.compatible(shape, src_dtype):
            self.bypasses += 1
            return None
        self._ensure_buffer(shape, src_dtype, device)
        if key in self._rows:
            row = self._rows.pop(key)
        elif len(self._rows) >= self.capacity:
            _, row = self._rows.popitem(last=False)         # evict the LRU entry
            self.evictions += 1
        else:
            row = self._free.pop()
        self._rows[key] = row
        return row

    def put(self, key: Hashable, entry: torch.Tensor) -> bool:
        """Insert ``entry`` under ``key`` (evicting the LRU entry if full).
        Returns False, counting a bypass, when it cannot live in the buffer
        (capacity 0, or a shape or source dtype other than the buffer's)."""
        row = self.reserve(key, tuple(entry.shape), entry.dtype, entry.device)
        if row is None:
            return False
        write_row(self._buf, self._scales, row, entry.to(self._buf.device), self.dtype)
        return True

    def index_of(self, key: Hashable) -> Optional[int]:
        """The buffer row of ``key`` (None on a miss). Counts the hit or the
        miss and marks the key most recently used."""
        row = self._rows.get(key)
        if row is None:
            self.misses += 1
            return None
        self._rows.move_to_end(key)
        self.hits += 1
        return row

    def set_layout(self, layout: Any) -> int:
        """Bind the cache to a stage layout, flushing it when the layout
        changes (one invalidation event). The buffer stays: on one device the
        entry's shape does not depend on the layout. Returns the entries
        dropped."""
        if layout == self.layout:
            return 0
        self.layout = layout
        return self.invalidate()

    def invalidate(self) -> int:
        """Drop every entry (a boundary drop). The buffer is kept, so the
        graphs that read and write it stay valid. Returns the entries dropped;
        counts one invalidation event if any were live."""
        n = len(self._rows)
        self._rows.clear()
        self._free = list(range(self.capacity - 1, -1, -1))
        if n:
            self.invalidations += 1
        return n

    def rebind(self, *, device: Optional[torch.device] = None, layout: Any) -> int:
        """Re-home the cache after a change of the ring's geometry (the entry
        shape carries S): drop the entries and the buffer, and with it the
        shape and dtype binding (the next ``put`` or ``reserve`` allocates
        anew), keeping the counts. A graph that held the old buffer must be
        dropped with it. Returns the entries dropped; counts one invalidation
        event if any were live."""
        n = len(self._rows)
        self._rows.clear()
        self._free = list(range(self.capacity - 1, -1, -1))
        if n:
            self.invalidations += 1
        self.device = device if device is not None else self.device
        self.layout = layout
        self._buf = None
        self._scales = None
        self._entry_shape = None
        self._src_dtype = None
        return n

    def invalidate_tenant(self, tenant: Hashable) -> int:
        """Drop only the entries whose key's first component is ``tenant``
        (the multi-tenant executor's ``(tenant, slot, boundary)`` keys); their
        rows return to the free list. Returns the entries dropped; counts one
        invalidation event if any were live."""
        dead = [k for k in self._rows
                if isinstance(k, tuple) and len(k) > 0 and k[0] == tenant]
        for k in dead:
            self._free.append(self._rows.pop(k))
        if dead:
            self.invalidations += 1
        return len(dead)

    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        eb = self.entry_bytes()
        return {
            "cache_hits": self.hits,
            "cache_misses": self.misses,
            "cache_hit_rate": self.hits / total if total else 0.0,
            "cache_evictions": self.evictions,
            "cache_invalidations": self.invalidations,
            "cache_bypasses": self.bypasses,
            "cache_entries": len(self._rows),
            "cache_capacity": self.capacity,
            "cache_dtype": self.dtype,
            "cache_bytes_per_entry": eb if eb is not None else 0,
            "cache_buffer_bytes": (eb or 0) * self.capacity,
        }
