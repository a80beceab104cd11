"""RingSession: one training API over backends, policies and caching (the
reference's ``api/session.py``).

Every execution path is a :mod:`~repro_torch.api.backends` adapter and every
unfreeze rule a :mod:`~repro_torch.api.policies` policy:

    from repro_torch.api import RingSession, LossPlateauPolicy

    sess = RingSession.create(cfg, tc, backend="cached", slots_per_epoch=8,
                              policy=LossPlateauPolicy(patience=3))
    history = sess.run(64, log_every=8)        # list of metric dicts
    sess.save("ckpt/ring")                     # adapters, head, Adam moments,
                                               # policy, data cursor, step
    sess2 = RingSession.restore("ckpt/ring", cfg, tc,
                                policy=LossPlateauPolicy(patience=3))
    sess2.run(64)                              # continues bit for bit

The session runs on ``cuda`` unless it is given ``device="cpu"``; on the card
the ring backends run the kernels through the executor's CUDA graphs.

Contracts the session keeps (beside the backends'):

  * **monotone boundary**: the boundary of a step never rises, whatever
    policy produced it; a rise raises at once (the activation cache's
    invalidation depends on it, ``core/unfreeze.py``);
  * **asynchronous metrics**: a fused round's metrics stay on the device
    between logging intervals; ``run`` materializes them in batches. A
    loss-driven policy (``wants_loss``) syncs once a round;
  * **bit-reproducible resume**: ``save`` keeps the trainable set and the
    Adam moments (in the reference's checkpoint format and layout), the
    policy's host state, the data cursor and the step; ``restore`` + ``run``
    gives what the uninterrupted run would have. A file saved by the JAX
    package's session restores here and the reverse, when both sessions hold
    the same frozen trunk (``params=``: the port's random weights are not
    JAX's).

Several tenants (``tenants=T``, the fused and cached backends): one frozen
trunk, T adapter-and-head sets trained in one joint round; per tenant the
joint session equals a solo session fed that tenant's stream
(``RingDataSource(tenant=k)``) bit for bit. ``tenants`` gives each tenant's
:class:`~repro_torch.api.tenants.TenantGroup` (save and load one tenant
through an ``AdapterStore``).

The elastic ring (``elastic=``, ``chaos=``, the ring backends): a
:class:`~repro_torch.api.backends.ChaosBackend` fires churn events before
their rounds, shrinks the ring on a crash and grows it on a rejoin, without
reading a checkpoint, and repartitions away a straggler. The data source
stays at the original S0 clients (the backend trims each batch to the
survivors), a round that moved the layout re-seeds the monotone-boundary
check, and a checkpoint records the survivors, so that ``restore`` rebuilds
the ring at S0 and replays the membership before it loads.
"""
from __future__ import annotations

import json
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.elastic import parse_chaos_events
from repro_torch.core.partition import parse_device_profiles, spans_from_profiles
from repro_torch.core.simulator import ChurnEvent

from .backends import CachedBackend, ChaosBackend, FusedBackend, PjitBackend, ReferenceBackend
from .data import PjitDataSource, RingDataSource
from .metrics import Callback, RoundMetrics
from .policies import resolve_policy
from .tenants import TenantGroup

BACKENDS = {"reference": ReferenceBackend, "fused": FusedBackend,
            "cached": CachedBackend, "pjit": PjitBackend}


class RingSession:
    """Facade over (backend, policy, data); build with :meth:`create` or
    :meth:`restore`, drive with :meth:`step` / :meth:`run`."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, backend, policy, data, *,
                 callbacks: Sequence[Callback] = (),
                 create_args: Optional[Dict[str, Any]] = None):
        self.cfg, self.tc = cfg, tc
        self.backend, self.policy, self.data = backend, policy, data
        self.callbacks: List[Callback] = list(callbacks)
        self.step_count = 0
        # a ring's rounds since its first ever (a resumed run goes on counting;
        # None where a checkpoint does not say, see _load_into)
        self.rounds: Optional[int] = 0
        self._last_boundary: Optional[int] = None
        self._create_args = create_args or {"backend": backend.name}
        if hasattr(backend, "flush_hook"):
            backend.flush_hook = self.flush_metrics
        # every un-materialized RoundMetrics handed out, flushed (host-synced
        # in place) before a backend call that changes the tensors they read
        self._live_metrics: "weakref.WeakSet[RoundMetrics]" = weakref.WeakSet()

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, cfg: ModelConfig, tc: TrainConfig, *, backend: Any = "fused",
               policy: Any = None, n_stages: Optional[int] = None,
               slots_per_epoch: Optional[int] = None, cache_capacity: Optional[int] = None,
               packed: bool = True, cache_dtype: str = "native", impl: str = "kernel",
               params: Optional[Dict[str, Any]] = None, spans: Any = None,
               device_profiles: Any = None, tenants: int = 1, elastic: bool = False,
               chaos: Any = (), data: Any = None, callbacks: Sequence[Callback] = (),
               device=None, log=print) -> "RingSession":
        """Wire a session from names: backend in {'pjit', 'reference',
        'fused', 'cached'} (or a ready backend), policy in {'interval',
        'plateau', None = the paper's rule from ``tc``} (or a policy object).

        ``cached`` needs ``slots_per_epoch`` (the cache's key space);
        ``cache_capacity`` defaults to it. ``packed`` (fused, cached) runs
        Phase A as one conveyor a round; ``cache_dtype`` in {'native', 'f32',
        'bf16', 'int8'} stores the cache's entries. ``impl`` ('kernel' or
        'plain') selects the reference backend's blocks. ``data=None`` builds
        the synthetic per-client datasets from ``tc.seed``, the reference's.
        ``params``: the port's parameter tree on ``device`` (default: random
        weights from ``tc.seed``). Ring backends: ``device_profiles`` (one
        speed or ``DeviceProfile`` per stage, ring order) runs the paper's
        speed-weighted assignment, and ``spans`` pins a layout (sizes or
        (begin, end) pairs); the layout rides in checkpoints.

        ``tenants=T > 1`` (fused and cached only): T adapter sets over one
        frozen trunk; batches ``[S, T, M, mb, seq]`` (tenant t's stream from
        ``tc.seed + 7919 t``), metrics with ``tenant_losses``, the cache
        partitioned per tenant, and its capacity by default
        ``slots_per_epoch * T``.

        ``chaos`` (a ``"round:event:device[:factor]"`` spec, a ``ChurnEvent``
        or a list of them) and ``elastic`` (ring backends): the backend is
        wrapped in a ``ChaosBackend``; with ``elastic=True`` a crash shrinks
        the ring and a straggler is repartitioned away, without it a crash
        raises. Shrinking and growing need the fused or cached backend.
        """
        if tenants < 1:
            raise ValueError(f"tenants must be >= 1, got {tenants}")
        policy = resolve_policy(policy, tc)
        S = n_stages or tc.n_stages
        if isinstance(backend, str):
            if backend not in BACKENDS:
                raise ValueError(f"unknown backend {backend!r}; known: {sorted(BACKENDS)}")
            be = BACKENDS[backend].build(
                cfg, tc, policy, n_stages=S, spans=spans, device_profiles=device_profiles,
                params=params, slots_per_epoch=slots_per_epoch, cache_capacity=cache_capacity,
                packed=packed, cache_dtype=cache_dtype, impl=impl, tenants=tenants,
                device=device, log=log)
        else:
            be = backend
            # a ready backend embeds the policy that drives its schedule: the
            # session must observe losses into that same object
            policy = getattr(be, "policy", policy)
            if getattr(be, "T", 1) != tenants and tenants != 1:
                raise ValueError(f"tenants={tenants} conflicts with the ready backend's "
                                 f"T={getattr(be, 'T', 1)}: the instance decides")
            tenants = getattr(be, "T", 1)
            if isinstance(be, CachedBackend) and data is None and not slots_per_epoch:
                raise ValueError(
                    "a CachedBackend needs slot-keyed batches: pass slots_per_epoch (for the "
                    "default data source) or a slot-yielding data=; with streaming draws "
                    "every round would bypass the cache")
        S0 = getattr(be, "S", S)           # the ring's size before any churn
        if elastic or chaos:
            if be.kind == "pjit":
                raise ValueError("elastic/chaos is a ring feature — the pjit baseline has no "
                                 "span layout to shrink or repartition")
            specs = [chaos] if isinstance(chaos, (str, ChurnEvent)) else list(chaos)
            events = (list(parse_chaos_events([e for e in specs if isinstance(e, str)]))
                      + [e for e in specs if isinstance(e, ChurnEvent)])
            be = ChaosBackend(be, events=events, elastic=elastic,
                              device_profiles=device_profiles, log=log)
        if data is None:
            # an elastic ring keeps the original S0 clients: ChaosBackend trims
            # each batch to the survivors, so the data cursor (and a resume)
            # does not depend on the churn
            data = (PjitDataSource(cfg, tc) if be.kind == "pjit"
                    else RingDataSource(cfg, tc, S0, slots_per_epoch=slots_per_epoch,
                                        tenants=tenants))
        be_spans = getattr(be, "spans", None)
        create_args = {"backend": be.name,
                       # the original ring size: the data source and a restore
                       # are anchored to it after a shrink
                       "n_stages": S0 if be.kind != "pjit" else None,
                       "slots_per_epoch": slots_per_epoch,
                       "cache_capacity": cache_capacity, "impl": impl,
                       "packed": packed, "cache_dtype": cache_dtype,
                       "tenants": tenants, "elastic": elastic,
                       # the span layout rides in the checkpoint so that restore
                       # rebuilds the same partition (JSON: [begin, end] pairs)
                       "spans": ([list(sp) for sp in be_spans]
                                 if be_spans is not None else None)}
        return cls(cfg, tc, be, policy, data, callbacks=callbacks, create_args=create_args)

    # ------------------------------------------------------------------
    @property
    def n_tenants(self) -> int:
        return getattr(self.backend, "T", 1)

    @property
    def tenants(self) -> List[TenantGroup]:
        """Each tenant's handle (one, tenant 0, at one tenant)."""
        return [TenantGroup(self, t) for t in range(self.n_tenants)]

    def export_adapters(self, tenant: int = 0) -> Dict[str, Any]:
        """One tenant's trainable set as an ``{"adapter", "head"}`` bundle,
        the unit an ``AdapterStore`` keeps and the server grafts (ring
        backends only: the pjit backend's set is not adapter-shaped)."""
        d = getattr(self.backend, "driver", None)
        if d is None or not hasattr(d, "export_adapters"):
            raise NotImplementedError(f"backend {self.backend.name!r} has no adapter bundle "
                                      f"surface; use backend.state() for its trainable set")
        return d.export_adapters(tenant)

    # ------------------------------------------------------------------
    def step(self, batch: Any = None) -> RoundMetrics:
        """One backend step (a ring round for ring backends, one optimizer
        step for pjit). The metrics may hold device tensors: call
        ``.materialize()`` (or use :meth:`run`) to read them."""
        if batch is None:
            batch = self.data.next()
        raw = self.backend.step(batch)
        if self.backend.kind == "ring":
            raw["extras"] = {"round": self.rounds, **raw.get("extras", {})}
            if self.rounds is not None:
                self.rounds += 1
        if raw.get("layout_changed"):
            # an elastic shrink, grow or repartition happened inside the step:
            # the span edges moved, so the monotone check re-seeds from this
            # round's boundary, the checkpointed layout and membership follow
            # the live ring, and a plateau policy skips the recovery blip
            self._last_boundary = None
            be_spans = getattr(self.backend, "spans", None)
            self._create_args["spans"] = ([list(sp) for sp in be_spans]
                                          if be_spans is not None else None)
            surv = getattr(self.backend, "survivors", None)
            if surv is not None:
                self._create_args["survivors"] = list(surv)
            if hasattr(self.policy, "suspend"):
                self.policy.suspend(1)
        boundary = raw["boundary"]
        if self._last_boundary is not None and boundary > self._last_boundary:
            raise RuntimeError(
                f"unfreeze boundary increased {self._last_boundary} -> {boundary} at step "
                f"{raw['step']} (policy {self.policy!r}): RingAda schedules are monotone "
                f"top-down and the activation cache's invalidation depends on it (see "
                f"core/unfreeze.py)")
        self._last_boundary = boundary
        self.step_count = raw["step"]
        m = RoundMetrics(step=raw["step"], boundary=boundary, depth=raw["depth"],
                         loss=raw["loss"], compile_count=self.backend.compile_count,
                         tokens=raw.get("tokens", 0), cache=raw.get("cache"),
                         cache_hit=raw.get("cache_hit"), extras=raw.get("extras", {}))
        if self.policy.wants_loss:
            m = m.materialize()            # adaptive policies pay one sync a round
            self.policy.observe(self.step_count, m.loss)
        else:
            self._live_metrics.add(m)      # flushed before the state changes under it
        return m

    def flush_metrics(self) -> None:
        """Host-sync (in place) every un-materialized RoundMetrics handed out.
        Called before a backend call that changes the tensors they read
        (repartition, checkpoint load)."""
        for m in list(self._live_metrics):
            m.flush_()
        self._live_metrics.clear()

    def repartition(self, spans: Any) -> None:
        """Switch the ring's span layout mid-run, pending metrics flushed first."""
        self.flush_metrics()
        self.backend.repartition(spans)
        be_spans = getattr(self.backend, "spans", None)
        self._create_args["spans"] = ([list(sp) for sp in be_spans]
                                      if be_spans is not None else None)

    def run(self, steps: int, *, log_every: int = 1,
            callbacks: Optional[Sequence[Callback]] = None) -> List[Dict[str, Any]]:
        """Drive ``steps`` backend steps off the session's data source.

        Metrics are materialized once per ``log_every`` interval, and EVERY
        step lands in the returned history (flat dicts), with the interval's
        wall ms per step as ``round_ms``. Callbacks fire per materialized step.
        """
        cbs = self.callbacks + list(callbacks or [])
        for cb in cbs:
            cb.on_start(self)
        history: List[Dict[str, Any]] = []
        pending: List[RoundMetrics] = []
        t0 = last_t = time.perf_counter()
        tokens_acc = 0

        def flush():
            nonlocal last_t, tokens_acc
            if not pending:
                return
            # the first materialization waits for the device: the interval's
            # time is taken after it
            done = [pm.materialize() for pm in pending]
            now = time.perf_counter()
            dt = now - last_t
            tps = tokens_acc / dt if dt > 0 and tokens_acc else None
            for mm in done:
                mm = mm.materialize(wall_s=round(now - t0, 2), tokens_per_sec=tps,
                                    round_ms=1e3 * dt / len(done))
                history.append(mm.to_dict())
                for cb in cbs:
                    cb.on_round(self, mm)
            pending.clear()
            last_t, tokens_acc = now, 0

        for i in range(steps):
            m = self.step()
            pending.append(m)
            tokens_acc += m.tokens
            if i % log_every == 0 or i == steps - 1:
                flush()
        flush()
        for cb in cbs:
            cb.on_end(self, history)
        return history

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """Persist the complete resumable state: the trainable set and the
        Adam moments (``checkpoint.save(..., opt_state=...)``, adapters only:
        the frozen trunk comes from the seed or ``params=``), the policy's
        host state, the data cursor and the step."""
        st = self.backend.state()
        extra = {
            "session": "RingSession/v1",
            "format": st["format"],
            "seed": self.tc.seed,
            "last_boundary": self._last_boundary,
            "policy": {"type": type(self.policy).__name__, "state": self.policy.state()},
            "data": self.data.state(),
            # a ring's rounds so far: after a shrink the step is no multiple of S
            "rounds": self.rounds if self.backend.kind == "ring" else None,
            **self._create_args,
        }
        ckpt.save(path, st["params"], step=self.step_count, opt_state=st["opt"],
                  adapters_only=True, extra=extra)

    def _load_into(self, path: str) -> "RingSession":
        """Load a checkpoint into this freshly created session of the same
        config. Raises on a backend-format or policy-type mismatch instead of
        reinterpreting moments."""
        self.flush_metrics()               # the load changes the live tensors
        st = self.backend.state()
        params, meta = ckpt.restore(path, st["params"])
        ex = meta["extra"]
        if ex.get("format") != st["format"]:
            raise ValueError(
                f"checkpoint {path!r} was saved by a {ex.get('format')!r} backend but this "
                f"session runs {st['format']!r}: optimizer moments are laid out per format "
                f"(stage-stacked or full-size) and cannot be reinterpreted. Recreate the "
                f"session with the saved backend.")
        saved_policy = ex.get("policy", {})
        if saved_policy.get("type") != type(self.policy).__name__:
            raise ValueError(
                f"checkpoint {path!r} was driven by policy {saved_policy.get('type')!r} but "
                f"this session has {type(self.policy).__name__!r}: pass the matching policy "
                f"to restore() so that the depth sequence continues.")
        opt = ckpt.restore_opt(path, st["opt"])
        # the policy first: the backend checks the state against its boundary
        self.policy.load_state(saved_policy.get("state", {}))
        self.backend.load_state(params, opt, step=meta["step"])
        if "rounds" in ex:
            self.rounds = ex["rounds"]
        elif ex.get("survivors") is None:
            # the JAX package records no round count: exact from the step
            # while the ring kept its size, unknown after it changed
            self.rounds = meta["step"] // (self._create_args.get("n_stages") or 1)
        else:
            self.rounds = None
        self.data.load_state(ex["data"])
        self.step_count = meta["step"]
        self._last_boundary = ex.get("last_boundary")
        return self

    @classmethod
    def restore(cls, path: str, cfg: ModelConfig, tc: TrainConfig, *, policy: Any = None,
                backend: Any = None, log=print, **create_kwargs) -> "RingSession":
        """Rebuild a session from a checkpoint. Backend and shape arguments
        default to what the checkpoint recorded; the policy must be of the
        type it was saved with (its host state is restored). The frozen
        trunk is the seed's unless ``params=`` gives it.

        A checkpoint saved after an elastic shrink records the surviving
        original devices: the ring is built at the original size, the
        membership is replayed (the dead stages shrunk away, the saved spans
        restored), and only then is the state loaded. With ``elastic=True``
        and ``device_profiles`` whose layout differs from the checkpoint's
        spans, the saved layout is loaded first, then the ring repartitions
        to the fleet's layout (logged old -> new)."""
        with open(path + ".json") as f:
            meta = json.load(f)
        ex = meta["extra"]
        if backend is None:
            backend = ex.get("backend", "fused")
        for k in ("n_stages", "slots_per_epoch", "cache_capacity", "impl", "packed",
                  "cache_dtype", "spans", "tenants", "elastic"):
            if k in ex and ex[k] is not None:
                if k == "impl" and ex[k] not in ("kernel", "plain"):
                    continue               # the JAX package's names its own kernels
                create_kwargs.setdefault(k, ex[k])
        if backend == "pjit":
            # a ring checkpoint's layout means nothing to pjit; the format
            # check gives the real diagnostic
            create_kwargs.pop("spans", None)
        surv = ex.get("survivors")
        saved_spans = create_kwargs.get("spans")
        shrunk = surv is not None and len(surv) < int(ex.get("n_stages") or 0)
        if shrunk:
            # build at the original size on the balanced layout (the saved
            # spans are the shrunk ring's), then replay the membership
            create_kwargs.pop("spans", None)
            create_kwargs["elastic"] = True
        sess = cls.create(cfg, tc, backend=backend, policy=policy, log=log, **create_kwargs)
        if shrunk:
            sess.backend.restore_membership(surv, spans=saved_spans)
            sess._create_args["spans"] = saved_spans
            sess._create_args["survivors"] = list(surv)
        sess._load_into(path)
        if create_kwargs.get("elastic") and create_kwargs.get("device_profiles") is not None:
            profs = parse_device_profiles(create_kwargs["device_profiles"])
            live = getattr(sess.backend, "spans", None)
            if live is not None and len(profs) == len(live):
                desired = [list(sp) for sp in spans_from_profiles(cfg.repeats, profs)]
                if desired != [list(sp) for sp in live]:
                    log(f"[elastic] checkpoint layout {[e - b for b, e in live]} is stale for "
                        f"the given fleet -> repartitioning to "
                        f"{[e - b for b, e in desired]}")
                    sess.repartition(desired)
        return sess
