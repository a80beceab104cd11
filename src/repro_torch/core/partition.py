"""Span layouts of the ring: which contiguous blocks each stage holds (a copy
of the reference's ``core/partition.py``).

A layout is a tuple of ``(begin, end)`` block spans, one per stage in ring
order, covering the block stack; the spans may differ in size (a ragged
layout, the heterogeneous ring). The coordinator's partitioner
(``assign_layers``, RingAda Algorithm 1, line 1) gives each device a
contiguous span so that the slowest stage is as fast as it can be, from the
profile each device uploads (``DeviceProfile``); ``spans_from_profiles`` runs
it at unit block costs, which is the CLI's ``--device-speeds``.

The copy keeps the reference's search as it is, including its fault under
memory budgets (ROADMAP.md Queue 3: it can miss the optimum there).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple, Union

Span = Tuple[int, int]


@dataclass(frozen=True)
class DeviceProfile:
    """What a client uploads at initialisation: its relative compute speed
    (1.0 = the reference device), its memory budget in MB and its egress
    rate to the next ring neighbour."""

    compute_speed: float
    memory_mb: float
    link_mbps: float = 1000.0

    def __post_init__(self):
        # a NaN speed would make every comparison of assign_layers' search
        # false, a non-positive one would invert it
        if math.isnan(self.compute_speed) or self.compute_speed <= 0:
            raise ValueError(f"compute_speed must be a positive finite number, got "
                             f"{self.compute_speed!r}")
        if math.isnan(self.memory_mb) or self.memory_mb <= 0:
            raise ValueError(f"memory_mb must be positive (inf = unconstrained), got "
                             f"{self.memory_mb!r}")
        if not self.link_mbps > 0:
            raise ValueError(f"link_mbps must be > 0, got {self.link_mbps!r}")

    def slowed(self, factor: float) -> "DeviceProfile":
        """This device, ``factor`` times slower (churn's slowdown event)."""
        if math.isnan(factor) or factor <= 0:
            raise ValueError(f"slowdown factor must be > 0, got {factor!r}")
        return DeviceProfile(compute_speed=self.compute_speed / factor,
                             memory_mb=self.memory_mb, link_mbps=self.link_mbps)


def assign_layers(layer_costs: Sequence[float], layer_mem_mb: Sequence[float],
                  devices: Sequence[DeviceProfile]) -> List[Span]:
    """``[(begin, end)]`` block spans per device, in ring order: the least
    bottleneck ``max_u (sum of the span's costs) / speed_u`` whose spans fit
    the memory budgets, by bisection over the bottleneck with a greedy
    feasibility check. ``layer_costs``: each block's time on the reference
    device."""
    n, U = len(layer_costs), len(devices)
    assert n >= U, "fewer blocks than devices"

    def feasible(T: float) -> Optional[List[Span]]:
        spans, i = [], 0
        for u, dev in enumerate(devices):
            t = m = 0.0
            j = i
            remaining_devices = U - u - 1
            while j < n and n - j > remaining_devices:
                dt = layer_costs[j] / dev.compute_speed
                dm = layer_mem_mb[j]
                if t + dt > T or m + dm > dev.memory_mb:
                    break
                t, m = t + dt, m + dm
                j += 1
            if j == i:                       # every device takes a block
                if layer_mem_mb[i] > dev.memory_mb:
                    return None
                j = i + 1
            spans.append((i, j))
            i = j
        return spans if i == n else None

    lo = max(c / max(d.compute_speed for d in devices) for c in layer_costs)
    hi = sum(layer_costs) / min(d.compute_speed for d in devices)
    best = feasible(hi)
    if best is None:
        raise ValueError("memory budgets cannot hold the model")
    for _ in range(64):
        mid = (lo + hi) / 2
        got = feasible(mid)
        if got is not None:
            best, hi = got, mid
        else:
            lo = mid
    return best


def uniform_assignment(n_blocks: int, n_stages: int) -> List[Span]:
    """Balanced contiguous split: ``n_blocks / n_stages`` blocks a stage when
    that divides, else the first ``n_blocks % n_stages`` stages take one more."""
    assert 0 < n_stages <= n_blocks, (n_blocks, n_stages)
    base, rem = divmod(n_blocks, n_stages)
    spans, i = [], 0
    for u in range(n_stages):
        j = i + base + (1 if u < rem else 0)
        spans.append((i, j))
        i = j
    return spans


def normalize_spans(spans: Union[Sequence[Span], Sequence[int]],
                    n_blocks: Optional[int] = None) -> Tuple[Span, ...]:
    """Canonical layout from ``[(begin, end), ...]`` or a sizes list like
    ``[4, 5, 2, 3]``; raises unless the spans are a contiguous cover."""
    spans = list(spans)
    assert spans, "empty span layout"
    if not isinstance(spans[0], (tuple, list)):
        out, i = [], 0
        for size in (int(s) for s in spans):
            out.append((i, i + size))
            i += size
        spans = out
    spans = [(int(b), int(e)) for b, e in spans]
    prev = 0
    for b, e in spans:
        if b != prev or e <= b:
            raise ValueError(
                f"span layout {spans} is not a contiguous cover: span "
                f"({b}, {e}) should start at {prev} and be non-empty")
        prev = e
    if n_blocks is not None and prev != n_blocks:
        raise ValueError(f"span layout {spans} covers {prev} blocks, model has {n_blocks}")
    return tuple(spans)


def span_sizes(spans: Sequence[Span]) -> Tuple[int, ...]:
    return tuple(e - b for b, e in spans)


def span_boundaries(spans: Sequence[Span]) -> Tuple[int, ...]:
    """Cumulative block counts ``[0, |s0|, |s0|+|s1|, ..., n_blocks]``: the only
    boundaries (frozen blocks from the bottom) the layout can realise."""
    return (0,) + tuple(e for _, e in spans)


def frozen_stage_count(spans: Sequence[Span], boundary: int) -> int:
    """Fully frozen stages under a span-aligned boundary; raises for a boundary
    inside a span (align it first with :func:`align_boundary`)."""
    cum = span_boundaries(spans)
    if boundary not in cum:
        raise ValueError(
            f"boundary {boundary} is not span-aligned for layout "
            f"{list(spans)} (alignable boundaries: {list(cum)})")
    return cum.index(boundary)


def align_boundary(spans: Sequence[Span], boundary: int) -> int:
    """A raw boundary rounded DOWN to the nearest span edge: fewer frozen
    blocks, never more (the stage the raw boundary falls in stays hot)."""
    return max(c for c in span_boundaries(spans) if c <= boundary)


def spans_from_profiles(n_blocks: int, devices: Sequence[DeviceProfile], *,
                        layer_costs: Optional[Sequence[float]] = None,
                        layer_mem_mb: Optional[Sequence[float]] = None) -> Tuple[Span, ...]:
    """The speed-weighted layout of a heterogeneous ring. Blocks cost 1.0 and
    memory is unconstrained unless given, so the layout minimises ``max_u
    span_u / speed_u``: speeds 1.0, 1.25, 0.5, 0.75 over 14 blocks give the
    paper's 4:5:2:3."""
    costs = list(layer_costs) if layer_costs is not None else [1.0] * n_blocks
    mems = list(layer_mem_mb) if layer_mem_mb is not None else [0.0] * n_blocks
    assert len(costs) == len(mems) == n_blocks
    return normalize_spans(assign_layers(costs, mems, devices), n_blocks)


def parse_device_profiles(speeds: Iterable[Union[float, DeviceProfile]]) -> List[DeviceProfile]:
    """Speeds (the CLI's ``--device-speeds 1.0,0.5,2.0,1.0``) or profiles ->
    profiles; a bare speed has no memory budget."""
    out = []
    for s in speeds:
        if isinstance(s, DeviceProfile):
            out.append(s)
            continue
        sp = float(s)
        if sp <= 0:
            raise ValueError(f"device speed must be > 0, got {sp}")
        out.append(DeviceProfile(compute_speed=sp, memory_mb=float("inf")))
    if not out:
        raise ValueError("empty device-profile list")
    return out
