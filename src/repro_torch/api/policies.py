"""Unfreeze policies: WHO decides the depth, decoupled from HOW (a copy of
the reference's ``api/policies.py``).

The paper's Algorithm 1 hard-wires one rule (depth += 1 every ``k`` steps);
here the rule is a protocol a session can swap without touching a driver:

    class UnfreezePolicy(Protocol):
        wants_loss: bool
        def depth_at(self, step: int, n_blocks: int) -> int: ...
        def observe(self, step: int, loss: float) -> None: ...
        def state(self) -> dict: ...            # checkpointable host state
        def load_state(self, state: dict) -> None: ...

**The monotone-boundary contract**: ``depth_at`` never returns a smaller
depth than it returned for an earlier step, so the unfreeze boundary never
rises. RingAda unfreezes top-down only, and the activation cache
(``core/actcache.py``) invalidates wholesale on boundary drops. The policies
here are monotone by construction; ``RingSession`` and
``core/executor.py`` check it again at run time.

``depth_at`` runs on the host once a step or round. Loss-driven policies set
``wants_loss = True``: the session then materializes the loss every round and
calls ``observe`` (one host sync a round, the price of adaptivity; interval
policies leave the executor's asynchronous rounds alone). ``state()`` is
JSON-equal to the reference's, since it rides in the checkpoint.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import TrainConfig
from repro_torch.core.unfreeze import UnfreezeSchedule


class IntervalPolicy:
    """The paper's k-step rule: depth = initial + step // interval (capped).

    Stateless (depth is a pure function of the step counter), so checkpoint
    resume is trivially bit-reproducible.
    """

    wants_loss = False

    def __init__(self, initial_depth: int = 1, interval: int = 40,
                 max_depth: Optional[int] = None):
        self._sched = UnfreezeSchedule(initial_depth=initial_depth,
                                       interval=interval, max_depth=max_depth)

    @staticmethod
    def from_train_config(tc: TrainConfig) -> "IntervalPolicy":
        return IntervalPolicy(initial_depth=tc.initial_unfreeze_depth,
                              interval=tc.unfreeze_interval,
                              max_depth=tc.max_unfreeze_depth)

    def depth_at(self, step: int, n_blocks: int) -> int:
        return self._sched.depth_at(step, n_blocks)

    def observe(self, step: int, loss: float) -> None:
        pass

    def state(self) -> Dict:
        return {}

    def load_state(self, state: Dict) -> None:
        pass

    def __repr__(self):
        s = self._sched
        return (f"IntervalPolicy(initial_depth={s.initial_depth}, "
                f"interval={s.interval}, max_depth={s.max_depth})")


class ExplicitPolicy:
    """An explicit per-segment depths tuple (segment i = steps [i*k, (i+1)*k)).

    Non-monotone tuples are rejected at construction by
    ``core/unfreeze.py``'s ``UnfreezeSchedule`` — the contract holds before a
    single step runs.  ``ExplicitPolicy((n_blocks,))`` is the "all hot from
    step 0" baseline (PipeAdapter/Single-style).
    """

    wants_loss = False

    def __init__(self, depths: Tuple[int, ...], interval: int = 40,
                 max_depth: Optional[int] = None):
        self._sched = UnfreezeSchedule(interval=interval, depths=tuple(depths),
                                       max_depth=max_depth)

    def depth_at(self, step: int, n_blocks: int) -> int:
        return self._sched.depth_at(step, n_blocks)

    def observe(self, step: int, loss: float) -> None:
        pass

    def state(self) -> Dict:
        return {}

    def load_state(self, state: Dict) -> None:
        pass

    def __repr__(self):
        return (f"ExplicitPolicy(depths={self._sched.depths}, "
                f"interval={self._sched.interval})")


class LossPlateauPolicy:
    """Adaptive unfreezing: open the next adapter when the loss plateaus.

    Keeps an exponential moving average of the observed loss; when the EMA
    fails to improve on its best value by at least ``min_rel_improve``
    (relatively) for ``patience`` consecutive observations, the depth is
    bumped by one and the plateau detector resets.  In the spirit of
    dynamic-chain edge adaptation (Beyond End-to-End, arXiv:2604.06819): the
    schedule reacts to training progress instead of a fixed step count.

    Monotone by construction: ``_depth`` is only ever incremented, so the
    boundary can only fall — the activation-cache invalidation contract holds
    for ANY loss sequence, including adversarial ones (oscillating, rising,
    NaN/inf).  Non-finite losses never corrupt the EMA; they count as
    "no improvement" observations (a diverging run unfreezes more capacity
    rather than wedging the detector).

    ``min_wait`` rate-limits unfreezes (at most one per ``min_wait``
    observations) so a cliff-shaped loss curve cannot unfreeze the whole
    stack in a burst of consecutive plateau detections.
    """

    wants_loss = True

    def __init__(self, initial_depth: int = 1, patience: int = 3,
                 min_rel_improve: float = 1e-3, smoothing: float = 0.6,
                 max_depth: Optional[int] = None, min_wait: int = 1):
        if initial_depth < 1:
            raise ValueError(f"initial_depth must be >= 1, got {initial_depth}")
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        if not (0.0 <= smoothing < 1.0):
            raise ValueError(f"smoothing must be in [0, 1), got {smoothing}")
        self.patience = patience
        self.min_rel_improve = min_rel_improve
        self.smoothing = smoothing
        self.max_depth = max_depth
        self.min_wait = max(min_wait, 1)
        self._depth = initial_depth
        self._ema: Optional[float] = None
        self._best: Optional[float] = None
        self._bad = 0                    # consecutive no-improvement count
        self._since_unfreeze = 0         # observations since the last bump
        self._suspended = 0              # observations to skip (recovery blips)

    def depth_at(self, step: int, n_blocks: int) -> int:
        cap = min(self.max_depth or n_blocks, n_blocks)
        return min(self._depth, cap)

    def suspend(self, rounds: int = 1) -> None:
        """Skip the next ``rounds`` observations.  The session calls this
        after an elastic layout change: a recovery round's loss blip (new
        span alignment, re-captured cache) is a geometry artifact, not
        plateau evidence — counting it would bias the unfreeze schedule."""
        self._suspended = max(self._suspended, int(rounds))

    def observe(self, step: int, loss: float) -> None:
        if self._suspended > 0:
            self._suspended -= 1
            return
        self._since_unfreeze += 1
        if loss is not None and math.isfinite(loss):
            self._ema = (loss if self._ema is None
                         else self.smoothing * self._ema
                         + (1.0 - self.smoothing) * loss)
            if (self._best is None
                    or self._ema < self._best * (1.0 - self.min_rel_improve)):
                self._best = self._ema
                self._bad = 0
                return
        # non-finite loss, or EMA failed to beat the best: one plateau tick
        self._bad += 1
        if self._bad >= self.patience and self._since_unfreeze >= self.min_wait:
            self._depth += 1             # monotone: only ever increments
            self._bad = 0
            self._since_unfreeze = 0
            self._best = self._ema       # plateau restarts from current level

    def state(self) -> Dict:
        return {"depth": self._depth, "ema": self._ema, "best": self._best,
                "bad": self._bad, "since_unfreeze": self._since_unfreeze,
                "suspended": self._suspended}

    def load_state(self, state: Dict) -> None:
        self._depth = int(state["depth"])
        self._ema = state["ema"]
        self._best = state["best"]
        self._bad = int(state["bad"])
        self._since_unfreeze = int(state["since_unfreeze"])
        # pre-elastic checkpoints have no "suspended" key
        self._suspended = int(state.get("suspended", 0))

    def __repr__(self):
        return (f"LossPlateauPolicy(depth={self._depth}, "
                f"patience={self.patience}, "
                f"min_rel_improve={self.min_rel_improve})")


def resolve_policy(policy, tc: TrainConfig):
    """None -> the paper's rule from tc; strings -> named defaults."""
    if policy is None or policy == "interval":
        return IntervalPolicy.from_train_config(tc)
    if policy == "plateau":
        return LossPlateauPolicy(initial_depth=tc.initial_unfreeze_depth,
                                 max_depth=tc.max_unfreeze_depth)
    if isinstance(policy, str):
        raise ValueError(f"unknown policy {policy!r}; use 'interval', "
                         f"'plateau', or an UnfreezePolicy instance")
    return policy
