"""Scheduled top-down adapter unfreezing (RingAda Algorithm 1, coordinator side).

A copy of the reference's ``core/unfreeze.py``. The schedule starts with only
the head and the top-most adapter trainable (``d = initial_unfreeze_depth``)
and unfreezes one more adapter every ``unfreeze_interval`` steps (the paper
uses k = 40):

    if r mod k == 0:  d <- d + 1

``depth`` counts *unfrozen* blocks from the top; the ``boundary`` the model
takes is ``boundary = R - depth_in_repeats`` (frozen repeats from the bottom).

Schedules are monotone top-down by contract: depth never shrinks, so the
boundary never rises. Construction refuses non-monotone explicit ``depths``,
and :func:`boundary_schedule` refuses a boundary that rises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.configs.base import ModelConfig, TrainConfig


@dataclass(frozen=True)
class UnfreezeSchedule:
    initial_depth: int = 1
    interval: int = 40               # k
    max_depth: Optional[int] = None  # defaults to all blocks
    # Explicit per-segment depths (segment i covers steps [i*k, (i+1)*k), the
    # last entry holds forever). Overrides the +1-per-interval rule; must be
    # non-decreasing (monotone top-down unfreezing).
    depths: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.interval < 1:
            raise ValueError(f"unfreeze_interval must be >= 1, got {self.interval}")
        if self.initial_depth < 1:
            raise ValueError(f"initial_unfreeze_depth must be >= 1, got {self.initial_depth}")
        if self.depths is not None:
            if len(self.depths) == 0 or any(d < 1 for d in self.depths):
                raise ValueError(f"explicit depths must be >= 1: {self.depths}")
            drops = [(a, b) for a, b in zip(self.depths, self.depths[1:]) if b < a]
            if drops:
                raise ValueError(
                    f"non-monotone unfreeze schedule {self.depths}: depth shrinks at "
                    f"{drops} — RingAda unfreezes top-down only (the boundary may "
                    f"never increase)")

    @staticmethod
    def from_train_config(tc: TrainConfig) -> "UnfreezeSchedule":
        return UnfreezeSchedule(initial_depth=tc.initial_unfreeze_depth,
                                interval=tc.unfreeze_interval,
                                max_depth=tc.max_unfreeze_depth)

    def depth_at(self, step: int, n_blocks: int) -> int:
        cap = min(self.max_depth or n_blocks, n_blocks)
        if self.depths is not None:
            seg = min(step // self.interval, len(self.depths) - 1)
            return min(self.depths[seg], cap)
        return min(self.initial_depth + step // self.interval, cap)


def depth_to_boundary(cfg: ModelConfig, depth: int) -> int:
    """Unfrozen-from-top depth (in blocks) -> frozen repeats from the bottom,
    the depth rounded up to whole pattern repeats."""
    per_rep = cfg.layers_per_repeat
    depth_reps = min(-(-depth // per_rep), cfg.repeats)
    return cfg.repeats - depth_reps


def boundary_schedule(cfg: ModelConfig, sched: UnfreezeSchedule, total_steps: int,
                      ) -> List[Tuple[int, int, int]]:
    """[(start_step, end_step, boundary)] segments of constant boundary; the
    training loop builds one train step per segment."""
    n_blocks = cfg.n_layers
    segs: List[Tuple[int, int, int]] = []
    start = 0
    cur = depth_to_boundary(cfg, sched.depth_at(0, n_blocks))
    for s in range(1, total_steps):
        b = depth_to_boundary(cfg, sched.depth_at(s, n_blocks))
        if b != cur:
            if b > cur:
                raise ValueError(
                    f"non-monotone unfreeze schedule: boundary rises {cur} -> {b} at "
                    f"step {s} (RingAda unfreezes top-down only; see UnfreezeSchedule)")
            segs.append((start, s, cur))
            start, cur = s, b
    segs.append((start, total_steps, cur))
    return segs
