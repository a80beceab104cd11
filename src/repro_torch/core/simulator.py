"""Fleet churn: the events an elastic ring absorbs (a copy of the churn part
of the reference's ``core/simulator.py``).

A :class:`ChurnEvent` is one change of the ring's membership or of a
device's speed, applied before its round; :func:`apply_churn` gives the
fleet after it. ``api/backends.ChaosBackend`` fires them against a live
ring, ``core/elastic.parse_chaos_events`` reads them from the CLI.

The reference's discrete-event engine (``simulate_round``,
``spmd_tick_round``, ``full_round_ticks``, ``predict_recovery``) is not
copied here: it belongs with the port's profiling (ROADMAP Queue 1, item
13). The port's tests hold its measured recovery ledgers to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from repro_torch.core.partition import DeviceProfile

CHURN_KINDS = ("crash", "leave", "slowdown", "join")


@dataclass(frozen=True)
class ChurnEvent:
    """One change of the fleet, applied BEFORE round ``round``.

    ``kind``:
      * ``'crash'`` / ``'leave'``: device ``device`` (an index into the
        current fleet) drops out and its span is reassigned over the
        survivors (both cost a repartition and a cache re-capture);
      * ``'slowdown'``: device ``device`` becomes ``factor`` times slower;
      * ``'join'``: a device with ``profile`` joins at position ``device``
        (S grows by one).
    """

    round: int
    kind: str
    device: int
    factor: float = 2.0                         # the slowdown's multiplier
    profile: Optional[DeviceProfile] = None     # the joining device (kind 'join')

    def __post_init__(self):
        if self.kind not in CHURN_KINDS:
            raise ValueError(f"unknown churn kind {self.kind!r}; expected one of {CHURN_KINDS}")
        if self.round < 0 or self.device < 0:
            raise ValueError(f"round/device must be >= 0, got {self}")
        if self.kind == "slowdown" and not (self.factor > 0):
            raise ValueError(f"slowdown factor must be > 0, got {self.factor}")


def apply_churn(devices: Sequence[DeviceProfile], event: ChurnEvent) -> List[DeviceProfile]:
    """The fleet after ``event`` (a new list; ``devices`` is left as it is)."""
    fleet = list(devices)
    if event.device >= len(fleet) + (1 if event.kind == "join" else 0):
        raise ValueError(f"churn event {event} targets device {event.device} but the fleet "
                         f"has {len(fleet)} devices")
    if event.kind in ("crash", "leave"):
        if len(fleet) <= 1:
            raise ValueError("cannot remove the last device from the ring")
        del fleet[event.device]
    elif event.kind == "slowdown":
        fleet[event.device] = fleet[event.device].slowed(event.factor)
    else:                                           # join
        fleet.insert(event.device,
                     event.profile or DeviceProfile(compute_speed=1.0, memory_mb=float("inf")))
    return fleet
