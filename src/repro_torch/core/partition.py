"""Span layouts of the ring: which contiguous blocks each stage holds (a copy
of the reference's ``core/partition.py`` helpers, without its profiles).

A layout is a tuple of ``(begin, end)`` block spans, one per stage in ring
order, covering the block stack. The uniform ring (every span the same size)
is what the port runs; the speed-weighted partitioner ``assign_layers`` and
the device profiles come with ragged layouts (ROADMAP.md Queue 1, item 3b).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

Span = Tuple[int, int]


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
