"""The training facade of the port (the reference's ``repro.api``).

``RingSession`` drives a :mod:`~repro_torch.api.backends` adapter (the
reference, fused or cached ring, or the one-device pjit path) under a
:mod:`~repro_torch.api.policies` unfreeze policy, emits
:class:`~repro_torch.api.metrics.RoundMetrics`, and checkpoints the complete
resumable state in the reference's format. A multi-tenant session
(``tenants=T``) trains T adapter sets over one trunk; ``TenantGroup`` and
``AdapterStore`` move one tenant's set in and out. The elastic ring
(``ChaosBackend``, ``elastic=``/``chaos=``) absorbs churn: a crash shrinks
the ring, a rejoin grows it, a straggler is repartitioned away.
"""
from repro_torch.core.elastic import StragglerDetector, parse_chaos_events
from repro_torch.core.simulator import ChurnEvent

from .backends import CachedBackend, ChaosBackend, FusedBackend, PjitBackend, ReferenceBackend
from .data import PjitDataSource, RingDataSource
from .metrics import (BenchCaptureCallback, Callback, CheckpointCallback, LoggingCallback,
                      RoundMetrics)
from .policies import ExplicitPolicy, IntervalPolicy, LossPlateauPolicy, resolve_policy
from .session import BACKENDS, RingSession
from .tenants import AdapterStore, TenantGroup

__all__ = [
    "RingSession", "BACKENDS",
    "ReferenceBackend", "FusedBackend", "CachedBackend", "PjitBackend",
    "ChaosBackend", "ChurnEvent", "StragglerDetector", "parse_chaos_events",
    "IntervalPolicy", "ExplicitPolicy", "LossPlateauPolicy", "resolve_policy",
    "RoundMetrics", "Callback", "LoggingCallback", "CheckpointCallback",
    "BenchCaptureCallback",
    "RingDataSource", "PjitDataSource",
    "AdapterStore", "TenantGroup",
]
