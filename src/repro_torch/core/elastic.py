"""Elasticity: straggler detection and chaos-event parsing for the ring (a
copy of the reference's ``core/elastic.py``).

  * :class:`StragglerDetector` watches each round's per-stage times, re-fits
    each device's ``compute_speed`` by an EWMA, and proposes the
    speed-weighted span layout (Algorithm 1 over the EWMA fleet) when the
    predicted bottleneck gain clears a threshold for ``patience``
    consecutive rounds. A repartition equalises the stage times, so a stable
    skewed fleet triggers at most one repartition.
  * :func:`parse_chaos_events` reads the CLI's ``--chaos
    round:event:device[:factor]`` specs into ``ChurnEvent``\\ s.

The recovery itself (``shrink``, ``grow``, ``repartition``) is
``RingExecutor``'s; ``api/backends.ChaosBackend`` drives it. The arithmetic
is plain Python floats, the reference's, so the speeds and proposals equal
its own.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.partition import (DeviceProfile, Span, normalize_spans, span_sizes,
                                        spans_from_profiles)
from repro_torch.core.simulator import CHURN_KINDS, ChurnEvent


class StragglerDetector:
    """EWMA speed re-profiler with a hysteresis-gated repartition trigger.

    ``observe(spans, stage_times)`` feeds one round's per-stage times; each
    stage's implied speed (``span_size / stage_time``) updates its device's
    EWMA. ``propose(spans)`` returns the best layout for the EWMA fleet only
    when ``bottleneck(current) / bottleneck(best) >= threshold`` has held for
    ``patience`` consecutive observations: one slow round never restacks.
    """

    def __init__(self, profiles: Sequence[DeviceProfile], n_blocks: int, *,
                 alpha: float = 0.5, threshold: float = 1.2, patience: int = 2):
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if threshold < 1.0:
            raise ValueError(f"threshold must be >= 1.0, got {threshold}")
        self.profiles: List[DeviceProfile] = list(profiles)
        self.speeds: List[float] = [p.compute_speed for p in self.profiles]
        self.n_blocks = n_blocks
        self.alpha = alpha
        self.threshold = threshold
        self.patience = max(1, patience)
        self.streak = 0                  # consecutive over-threshold rounds
        self.repartitions = 0            # proposals returned

    # -- membership (shrink and grow keep the EWMA state aligned) --

    def remove(self, idx: int) -> None:
        del self.profiles[idx]
        del self.speeds[idx]
        self.streak = 0

    def insert(self, idx: int, profile: DeviceProfile) -> None:
        self.profiles.insert(idx, profile)
        self.speeds.insert(idx, profile.compute_speed)
        self.streak = 0

    @property
    def fleet(self) -> List[DeviceProfile]:
        """The EWMA-refit profiles (speed updated, memory and link kept)."""
        return [DeviceProfile(compute_speed=s, memory_mb=p.memory_mb, link_mbps=p.link_mbps)
                for p, s in zip(self.profiles, self.speeds)]

    # -- observation and trigger --

    def observe(self, spans: Sequence[Span], stage_times: Sequence[float]) -> None:
        spans = normalize_spans(spans)
        if len(spans) != len(self.speeds) or len(stage_times) != len(spans):
            raise ValueError(f"observation shape mismatch: {len(spans)} spans / "
                             f"{len(stage_times)} stage times vs {len(self.speeds)} tracked "
                             f"devices")
        for u, (sz, t) in enumerate(zip(span_sizes(spans), stage_times)):
            if not (t > 0):              # a missing or degenerate time
                continue
            self.speeds[u] = (1 - self.alpha) * self.speeds[u] + self.alpha * (sz / t)

    def bottleneck(self, spans: Sequence[Span]) -> float:
        """The predicted round bottleneck (the largest stage time) under the EWMA speeds."""
        spans = normalize_spans(spans)
        return max(sz / s for sz, s in zip(span_sizes(spans), self.speeds))

    def propose(self, spans: Sequence[Span]) -> Optional[Tuple[Span, ...]]:
        """A better layout, or None (the hysteresis is not cleared)."""
        spans = normalize_spans(spans, self.n_blocks)
        best = spans_from_profiles(self.n_blocks, self.fleet)
        if best == spans:
            self.streak = 0
            return None
        cur_t, best_t = self.bottleneck(spans), self.bottleneck(best)
        if best_t <= 0 or cur_t / best_t < self.threshold:
            self.streak = 0
            return None
        self.streak += 1
        if self.streak < self.patience:
            return None
        self.streak = 0
        self.repartitions += 1
        return best


def parse_chaos_events(specs: Iterable[str]) -> Tuple[ChurnEvent, ...]:
    """The CLI's ``--chaos`` specs, ``"round:event:device[:factor]"``, sorted by round.

    ``"3:crash:2"`` kills device 2 before round 3; ``"5:slowdown:1:4.0"``
    makes device 1 four times slower before round 5. Raises ``ValueError``
    naming the spec at fault.
    """
    events = []
    for spec in specs:
        parts = str(spec).split(":")
        if len(parts) not in (3, 4):
            raise ValueError(f"bad --chaos spec {spec!r}: want 'round:event:device' or "
                             f"'round:event:device:factor'")
        try:
            rnd, dev = int(parts[0]), int(parts[2])
            factor = float(parts[3]) if len(parts) == 4 else 2.0
        except ValueError as e:
            raise ValueError(f"bad --chaos spec {spec!r}: {e}") from None
        kind = parts[1].lower()
        if kind not in CHURN_KINDS:
            raise ValueError(f"bad --chaos spec {spec!r}: unknown event {kind!r} "
                             f"(one of {CHURN_KINDS})")
        events.append(ChurnEvent(round=rnd, kind=kind, device=dev, factor=factor))
    return tuple(sorted(events, key=lambda ev: ev.round))
