"""The training facade of the port (the reference's ``repro.api``).

``RingSession`` drives a :mod:`~repro_torch.api.backends` adapter (the
reference, fused or cached ring, or the one-device pjit path) under a
:mod:`~repro_torch.api.policies` unfreeze policy, emits
:class:`~repro_torch.api.metrics.RoundMetrics`, and checkpoints the complete
resumable state in the reference's format. Multi-tenant sessions
(``TenantGroup``, the write side of ``AdapterStore``) wait for ROADMAP Queue 1
item 8 and the elastic ring (``ChaosBackend``) for item 9.
"""
from .backends import CachedBackend, FusedBackend, PjitBackend, ReferenceBackend
from .data import PjitDataSource, RingDataSource
from .metrics import (BenchCaptureCallback, Callback, CheckpointCallback, LoggingCallback,
                      RoundMetrics)
from .policies import ExplicitPolicy, IntervalPolicy, LossPlateauPolicy, resolve_policy
from .session import BACKENDS, RingSession

__all__ = [
    "RingSession", "BACKENDS",
    "ReferenceBackend", "FusedBackend", "CachedBackend", "PjitBackend",
    "IntervalPolicy", "ExplicitPolicy", "LossPlateauPolicy", "resolve_policy",
    "RoundMetrics", "Callback", "LoggingCallback", "CheckpointCallback",
    "BenchCaptureCallback",
    "RingDataSource", "PjitDataSource",
]
