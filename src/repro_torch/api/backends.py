"""Backend adapters: one ``step`` protocol over every training path (the
reference's ``api/backends.py``, no mesh).

A :class:`Backend` adapts a driver to the surface
:class:`~repro_torch.api.session.RingSession` drives:

    class Backend(Protocol):
        kind: str                 # "ring" | "pjit" (selects the data source)
        name: str                 # CLI name
        steps_per_call: int       # global steps one step() advances
        compile_count: int        # rounds or steps built so far
        @classmethod
        def build(cls, cfg, tc, policy, *, n_stages, spans, device_profiles,
                  params, slots_per_epoch, cache_capacity, packed,
                  cache_dtype, impl, tenants, device, log) -> Backend
        def step(self, batch) -> dict           # raw metrics (may hold device tensors)
        def state(self) -> dict                 # {"format", "params", "opt"}
        def load_state(self, params, opt, *, step) -> None
        def export_params(self) -> params tree  # the port's flat layout

``build`` takes the same keywords for every backend and validates or ignores
what it does not support (pjit refuses spans, the reference and pjit
backends refuse ``tenants > 1``, cached needs ``slots_per_epoch``).

Contracts every adapter keeps:

  * **monotone boundary**: the backend evaluates its policy's ``depth_at``
    per step or round; the boundary never rises (checked again in
    ``core/executor.py`` and by the session);
  * **the backend's tensors stay put**: on the card the fused rounds and
    the pjit steps are CUDA graphs that read and write the executor's or
    the backend's own tensors, so ``load_state`` copies into them and never
    rebinds them; ``state()`` returns new tensors in the reference's layout;
  * **cache invalidation**: the activation cache is keyed ``(slot,
    boundary)`` (``(tenant, slot, boundary)`` with several tenants), cleared
    on every boundary drop and on ``load_state`` (a restored session never
    serves activations from before the restore).

``state()`` gives the trainable set and the optimizer state in the
reference's layout (``repro_torch.bridge``): params ``{"blocks":
({"adapter": [R, C, ...]},), "head": ...}`` and, for the ring, the moments
in its ``[S, max_span, C, ...]`` stage stack, so a session checkpoint
restores in either package; with several tenants, the reference's
tenant-stacked layout (``bridge.ring_state_to_reference``).
``state()["format"]`` tags the moments' layout (``ring/S4``,
``ring/S4/spans4-5-2-3``, ``ring/S4/T3``, ``pjit``) as the reference does; a
checkpoint restores only into a backend of the same format.

:class:`ChaosBackend` wraps a fused or cached backend for the elastic ring:
it fires churn events (crash, leave, slowdown, join) before their rounds,
shrinks and grows the ring through ``RingExecutor.shrink``/``grow``, and
repartitions away a straggler its ``StragglerDetector`` finds.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch import bridge
from repro_torch import device as dev_rule
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import pipeline as pl
from repro_torch.core import training
from repro_torch.core.elastic import StragglerDetector
from repro_torch.core.executor import RingExecutor, _Captured, tenant_view
from repro_torch.core.partition import (DeviceProfile, parse_device_profiles, span_sizes,
                                        spans_from_profiles, uniform_assignment)
from repro_torch.core.ring import RingTrainer
from repro_torch.core.simulator import ChurnEvent
from repro_torch.core.unfreeze import depth_to_boundary
from repro_torch.data.pipeline import to_device
from repro_torch.kernels import ops
from repro_torch.models import params as prm
from repro_torch.optim import adamw

CACHE_STAT_KEYS = ("cache_hits", "cache_misses", "cache_hit_rate",
                   "cache_evictions", "cache_invalidations", "cache_bypasses",
                   "cache_entries", "cache_capacity", "cache_dtype",
                   "cache_bytes_per_entry", "cache_buffer_bytes")


def _validate_ring(cfg: ModelConfig, n_stages: int) -> None:
    """The ring's preconditions."""
    if cfg.head_out is not None:
        raise ValueError(
            f"ring backends train with the LM objective, but this config has a task head "
            f"(head_out={cfg.head_out}) — the loss would be garbage/NaN. Use an LM config, or "
            f"reduce with head_out=None like examples/ring_finetune.py.")
    if cfg.repeats < n_stages:
        raise ValueError(f"ring training needs at least one block per stage: "
                         f"cfg.repeats={cfg.repeats} < n_stages={n_stages}.")


def _block_weight_mb(cfg: ModelConfig) -> float:
    """One block's weights in MB: the memory Algorithm 1 charges a device per
    block it holds when a DeviceProfile's budget is finite."""
    kind = cfg.pattern[0][0]
    n = sum(math.prod(pd.shape) for pd in tree_leaves(prm.block_defs(cfg, kind)))
    return n * cfg.layers_per_repeat * prm.DTYPES[cfg.dtype].itemsize / 2**20


def _resolve_ring_spans(cfg: ModelConfig, n_stages: int, spans, device_profiles):
    """(spans, device_profiles) -> the span layout (None = balanced).

    ``device_profiles`` (speeds or DeviceProfile objects, ring order) runs
    the paper's speed-weighted assignment; an explicit ``spans`` ((begin,
    end) pairs or sizes like [4, 5, 2, 3]) wins. Finite ``memory_mb``
    budgets bind the assignment at one block's weights a block."""
    if spans is None and device_profiles is not None:
        profiles = parse_device_profiles(device_profiles)
        if len(profiles) != n_stages:
            raise ValueError(f"{len(profiles)} device profiles for a {n_stages}-stage ring: "
                             f"pass exactly one per stage, in ring order")
        mem = None
        if any(math.isfinite(p.memory_mb) for p in profiles):
            mem = [_block_weight_mb(cfg)] * cfg.repeats
        spans = spans_from_profiles(cfg.repeats, profiles, layer_mem_mb=mem)
    return pl.resolve_spans(cfg.repeats, n_stages, spans)


def _materialize(cfg: ModelConfig, tc: TrainConfig, params, device) -> Dict[str, Any]:
    """``params`` (on ``device``), or random weights from ``tc.seed`` there."""
    device = dev_rule.resolve(device)
    if params is None:
        return prm.materialize(cfg, seed=tc.seed, device=device)
    got = params["head"]["w"].device
    if got.type != device.type:
        raise ValueError(f"params are on {got}, the session runs on {device}")
    return params


class _RingBackendBase:
    """What the ring adapters share: the span layout, the format tag, batch
    unpacking, the checkpoint layout."""

    kind = "ring"
    T = 1                                  # tenants (the fused backends take more)

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, policy, *, n_stages: int,
                 params=None, spans=None, device_profiles=None, device=None):
        _validate_ring(cfg, n_stages)
        self.cfg, self.tc, self.policy = cfg, tc, policy
        self.S = n_stages
        self.spans = _resolve_ring_spans(cfg, n_stages, spans, device_profiles)
        self._init_params = _materialize(cfg, tc, params, device)

    @property
    def steps_per_call(self) -> int:
        return self.S                      # one round = S initiator steps

    @property
    def format(self) -> str:
        """The moments' layout tag; a layout other than the balanced one is
        part of it (the moments are stacked per span), and so are several
        tenants (``/T{T}``: tenant-stacked moments)."""
        if self.spans == tuple(uniform_assignment(self.cfg.repeats, self.S)):
            tag = f"ring/S{self.S}"
        else:
            tag = f"ring/S{self.S}/spans{'-'.join(str(n) for n in span_sizes(self.spans))}"
        return tag if self.T == 1 else f"{tag}/T{self.T}"

    def export_params(self) -> Dict[str, Any]:
        return self.driver.export_params()

    @staticmethod
    def _unpack(batch) -> Tuple[Optional[int], Any, Any]:
        if len(batch) == 3:
            return batch
        tokens, labels = batch
        return None, tokens, labels

    def _raw(self, m: Dict[str, Any], slot: Optional[int], tokens, losses) -> Dict[str, Any]:
        extras = {"losses": losses}
        if slot is not None:
            extras["slot"] = slot
        return {"loss": m["loss"], "boundary": m["boundary"],
                "depth": self.cfg.repeats - m["boundary"], "step": m["step"],
                "tokens": int(np.size(tokens)), "extras": extras}

    def _checkpoint_state(self, stage_adapters, head, opt) -> Dict[str, Any]:
        params, opt = bridge.ring_state_to_reference(stage_adapters, head, opt, self.cfg,
                                                     self.spans, self.T)
        return {"format": self.format, "params": params, "opt": opt}

    def _from_checkpoint(self, params, opt):
        """(stage adapters, head, ring opt state) from ``state()``'s layout."""
        return bridge.ring_state_from_reference(params, opt, self.cfg, self.spans, self.T)

    def repartition(self, spans) -> None:
        """Switch the live span layout (executor-backed backends only); the
        session flushes pending device metrics first."""
        d = self.driver
        if not hasattr(d, "repartition"):
            raise NotImplementedError(f"backend {self.name!r} cannot repartition mid-run")
        d.repartition(pl.resolve_spans(self.cfg.repeats, self.S, spans))
        self.spans = d.spans

    def shrink(self, dead_stage: int, profiles: Sequence[DeviceProfile]) -> None:
        """S -> S - 1 (executor-backed backends only): drop stage
        ``dead_stage`` and lay the survivors out by their ``profiles``. The
        caller flushes pending device metrics first."""
        d = self.driver
        if not hasattr(d, "shrink"):
            raise NotImplementedError(f"backend {self.name!r} cannot shrink mid-run — use "
                                      f"backend='fused' or 'cached'")
        d.shrink(dead_stage, profiles)
        self.S, self.spans = d.S, d.spans

    def grow(self, profiles: Sequence[DeviceProfile]) -> None:
        """The inverse of ``shrink``: a device joins, S grows by one;
        ``profiles`` describe the fleet after the join."""
        d = self.driver
        if not hasattr(d, "grow"):
            raise NotImplementedError(f"backend {self.name!r} cannot grow mid-run — use "
                                      f"backend='fused' or 'cached'")
        d.grow(profiles)
        self.S, self.spans = d.S, d.spans


class ReferenceBackend(_RingBackendBase):
    """The unfused ``RingTrainer`` oracle: S iterations a round, one loss
    sync each (its metrics are host floats)."""

    name = "reference"

    def __init__(self, cfg, tc, policy, *, n_stages: int, params=None, spans=None,
                 device_profiles=None, impl: str = "kernel", device=None):
        super().__init__(cfg, tc, policy, n_stages=n_stages, params=params, spans=spans,
                         device_profiles=device_profiles, device=device)
        self.driver = RingTrainer(cfg, tc, self._init_params, n_stages, tc.n_microbatches,
                                  schedule=policy, spans=self.spans, impl=impl)

    @classmethod
    def build(cls, cfg, tc, policy, *, n_stages, spans=None, device_profiles=None,
              params=None, slots_per_epoch=None, cache_capacity=None, packed=True,
              cache_dtype="native", impl="kernel", tenants=1, device=None,
              log=print) -> "ReferenceBackend":
        if tenants > 1:
            raise ValueError(
                "tenants > 1 needs the fused executable (tenant-stacked adapters + the "
                "T-tenant conveyor) — use backend='fused' or 'cached'; the reference oracle "
                "is single-tenant")
        return cls(cfg, tc, policy, n_stages=n_stages, params=params, spans=spans,
                   device_profiles=device_profiles, impl=impl, device=device)

    @property
    def compile_count(self) -> int:
        return self.driver.n_executables

    def step(self, batch) -> Dict[str, Any]:
        slot, tokens, labels = self._unpack(batch)
        m = self.driver.round(tokens, labels)
        return self._raw(m, slot, tokens, [it["loss"] for it in m["iterations"]])

    def _opt(self) -> Dict[str, Any]:
        d = self.driver
        return {"m": {"adapter": d.m_ad, "head": d.m_hd},
                "v": {"adapter": d.v_ad, "head": d.v_hd},
                "count": torch.tensor(d.step, dtype=torch.int32)}

    def state(self) -> Dict[str, Any]:
        d = self.driver
        return self._checkpoint_state(d.stage_adapters(), d.shared["head"], self._opt())

    def load_state(self, params, opt, *, step: int) -> None:
        d = self.driver
        stage_adapters, head, ring_opt = self._from_checkpoint(params, opt)
        d.stage_blocks = [[{**layer, "adapter": a} for layer, a in zip(stage, ads)]
                          for stage, ads in zip(d.stage_blocks, stage_adapters, strict=True)]
        d.shared = {**d.shared, "head": head}
        d.m_ad, d.m_hd = ring_opt["m"]["adapter"], ring_opt["m"]["head"]
        d.v_ad, d.v_hd = ring_opt["v"]["adapter"], ring_opt["v"]["head"]
        d.step = step


class FusedBackend(_RingBackendBase):
    """The fused ``RingExecutor``: one round a call, one CUDA graph per
    boundary on the card; metrics stay on the device until the session
    materializes them."""

    name = "fused"

    def __init__(self, cfg, tc, policy, *, n_stages: int, params=None,
                 cache_capacity: int = 0, packed: bool = True, cache_dtype: str = "native",
                 spans=None, device_profiles=None, tenants: int = 1, device=None):
        super().__init__(cfg, tc, policy, n_stages=n_stages, params=params, spans=spans,
                         device_profiles=device_profiles, device=device)
        self.T = tenants
        self.driver = RingExecutor(cfg, tc, self._init_params, n_stages, tc.n_microbatches,
                                   schedule=policy, packed=packed, spans=self.spans,
                                   cache_capacity=cache_capacity, cache_dtype=cache_dtype,
                                   tenants=tenants)

    @classmethod
    def build(cls, cfg, tc, policy, *, n_stages, spans=None, device_profiles=None,
              params=None, slots_per_epoch=None, cache_capacity=None, packed=True,
              cache_dtype="native", impl="kernel", tenants=1, device=None,
              log=print) -> "FusedBackend":
        return cls(cfg, tc, policy, n_stages=n_stages, params=params, packed=packed,
                   cache_dtype=cache_dtype, spans=spans, device_profiles=device_profiles,
                   tenants=tenants, device=device)

    @property
    def compile_count(self) -> int:
        return self.driver.n_executables

    def step(self, batch) -> Dict[str, Any]:
        slot, tokens, labels = self._unpack(batch)
        m = self.driver.round(tokens, labels, slot=slot)
        raw = self._raw(m, slot, tokens, m["losses"])
        if self.T > 1:
            raw["extras"]["tenant_losses"] = m["tenant_losses"]
        if self.driver.cache is not None:
            raw["cache"] = {k: m[k] for k in CACHE_STAT_KEYS}
            raw["cache_hit"] = m["cache_hit"]
            if self.T > 1:
                raw["cache"]["tenant_cache_hits"] = m["tenant_cache_hits"]
                raw["cache"]["tenant_cache_misses"] = m["tenant_cache_misses"]
        return raw

    def state(self) -> Dict[str, Any]:
        d = self.driver
        return self._checkpoint_state(d.stage_adapters(), d.shared["head"], d.opt_state)

    def load_state(self, params, opt, *, step: int) -> None:
        d = self.driver
        stage_adapters, head, ring_opt = self._from_checkpoint(params, opt)
        if self.T > 1:
            layers = [a for stage in stage_adapters for a in stage]
            d.check_shared_trunk([tenant_view(layers, t) for t in range(self.T)], step)
        # into the executor's own tensors: its graphs read and write them
        bridge.copy_into(d.stage_adapters(), stage_adapters)
        bridge.copy_into(d.shared["head"], head)
        bridge.copy_into(d.opt_state, ring_opt)
        d.step = step
        d._last_boundary = None            # the next round drops the graphs built before
        if d.cache is not None:
            d.cache.invalidate()           # never serve activations from before the restore


class CachedBackend(FusedBackend):
    """The fused executor with the frozen-trunk activation cache (Phase A
    skipped on a revisited slot). Needs slot-keyed batches
    (``slots_per_epoch``): streaming draws never revisit a key."""

    name = "cached"

    def __init__(self, cfg, tc, policy, *, n_stages: int, cache_capacity: int, params=None,
                 packed: bool = True, cache_dtype: str = "native", spans=None,
                 device_profiles=None, tenants: int = 1, device=None):
        if cache_capacity < 1:
            raise ValueError(f"CachedBackend needs cache_capacity >= 1 (got {cache_capacity}); "
                             f"use FusedBackend for uncached rounds")
        super().__init__(cfg, tc, policy, n_stages=n_stages, params=params,
                         cache_capacity=cache_capacity, packed=packed, cache_dtype=cache_dtype,
                         spans=spans, device_profiles=device_profiles, tenants=tenants,
                         device=device)

    @classmethod
    def build(cls, cfg, tc, policy, *, n_stages, spans=None, device_profiles=None,
              params=None, slots_per_epoch=None, cache_capacity=None, packed=True,
              cache_dtype="native", impl="kernel", tenants=1, device=None,
              log=print) -> "CachedBackend":
        if not slots_per_epoch:
            raise ValueError("backend='cached' needs slots_per_epoch >= 1: the activation "
                             "cache keys on stable batch slots, and streaming draws never "
                             "repeat a key. Use backend='fused' for non-repeating data.")
        # each tenant owns a (tenant, slot, boundary) key per slot
        cap = cache_capacity if cache_capacity is not None else slots_per_epoch * tenants
        if 0 < cap < slots_per_epoch * tenants:
            # round-robin slots and LRU: every slot is evicted before its revisit
            log(f"WARNING: cache_capacity {cap} < slots_per_epoch {slots_per_epoch}"
                + (f" x tenants {tenants}" if tenants > 1 else "")
                + ": the cache will thrash (0% hits, capture overhead every round); raise "
                  "the capacity or use backend='fused'")
        return cls(cfg, tc, policy, n_stages=n_stages, cache_capacity=cap, params=params,
                   packed=packed, cache_dtype=cache_dtype, spans=spans,
                   device_profiles=device_profiles, tenants=tenants, device=device)


class PjitBackend:
    """The one-device path: ``core/training.make_step`` (the QA step for a
    span head, else the LM step) built once per boundary.

    The backend's tensors stay put: each step writes the new adapters, head,
    moments and ``count`` into the tensors the backend owns, as the ring's
    raw update does, and ``load_state`` copies into them. On the card
    (``graphs=True``, the default) the first step of a (boundary, batch
    shape) warms the step up on a side stream from a copy of the state,
    puts the state back and captures it as a CUDA graph; later steps copy
    the batch into the graph's inputs and replay it (the reference jits and
    donates one step a boundary). The boundary never rises, so a drop
    frees the graphs of the higher boundaries and their pools.
    ``capture_launches`` and ``capture_seconds`` are keyed like the graphs:
    a graph's launches are counted once, at its capture (the warm-up counts
    them too), and never at a replay. On the CPU, or with ``graphs=False``,
    the same step runs eagerly."""

    kind = "pjit"
    name = "pjit"
    steps_per_call = 1

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, policy, *,
                 params: Optional[Dict[str, Any]] = None, device=None, graphs: bool = True):
        self.cfg, self.tc, self.policy = cfg, tc, policy
        self._params = _materialize(cfg, tc, params, device)
        self.device = self._params["head"]["w"].device
        self._opt = adamw.init(training.full_trainable(self._params, cfg))
        self._fns: Dict[int, Any] = {}      # boundary -> step
        self.graphs = graphs and self.device.type == "cuda"
        # (boundary, batch shapes) -> (graph, the names of its metric outputs)
        self._graphs: Dict[Tuple, Tuple[_Captured, List[str]]] = {}
        self.capture_launches: Dict[Tuple, Dict[str, int]] = {}
        self.capture_seconds: Dict[Tuple, float] = {}
        self.last_key: Optional[Tuple] = None         # the key of the last step's graph
        self._step = 0

    @classmethod
    def build(cls, cfg, tc, policy, *, n_stages=None, spans=None, device_profiles=None,
              params=None, slots_per_epoch=None, cache_capacity=None, packed=True,
              cache_dtype="native", impl="kernel", tenants=1, device=None,
              log=print) -> "PjitBackend":
        if spans is not None or device_profiles is not None:
            raise ValueError("spans/device_profiles describe the ring's stage layout: they "
                             "have no meaning for the pjit backend")
        if tenants > 1:
            raise ValueError("tenants > 1 is a ring concept (T adapter sets over one frozen "
                             "ring trunk) — use backend='fused' or 'cached'")
        return cls(cfg, tc, policy, params=params, device=device)

    @property
    def format(self) -> str:
        return "pjit"

    @property
    def compile_count(self) -> int:
        return len(self._fns)

    def _trainable(self) -> Dict[str, Any]:
        return training.full_trainable(self._params, self.cfg)

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor a step writes: the adapters, the head, the moments, ``count``."""
        return tree_leaves((self._trainable(), self._opt))

    def _fn(self, boundary: int):
        if boundary not in self._fns:
            self._fns[boundary] = training.make_step(self.cfg, self.tc, boundary)
        return self._fns[boundary]

    def _step_in_place(self, boundary: int, batch: Dict[str, torch.Tensor]):
        """The functional step, its new trainable set and optimizer state
        copied into the backend's own tensors (a frozen layer's, passed
        through, onto itself: no copy). Returns the metrics."""
        new_params, new_opt, metrics = self._fn(boundary)(self._params, self._opt, batch)
        with torch.no_grad():
            bridge.copy_into(self._trainable(), training.full_trainable(new_params, self.cfg))
            bridge.copy_into(self._opt, new_opt)
        return metrics

    def _graphed(self, boundary: int, batch: Dict[str, torch.Tensor]):
        names = sorted(batch)
        key = (boundary,) + tuple((k, tuple(batch[k].shape)) for k in names)
        if key not in self._graphs:
            stale = [k for k in self._graphs if k[0] > boundary]
            for k in stale:
                del self._graphs[k]
            if stale:
                torch.cuda.empty_cache()             # the dropped graphs' pools
            self._graphs[key] = self._capture(key, boundary, names, batch)
        self.last_key = key
        graph, metric_names = self._graphs[key]
        return dict(zip(metric_names, graph(*(batch[k] for k in names)), strict=True))

    def _capture(self, key, boundary: int, names, batch) -> Tuple[_Captured, List[str]]:
        """Warm the step up on a side stream from a copy of the state, put
        the state back, capture the step on that stream: (the graph, the
        names of its metric outputs)."""
        t0 = time.perf_counter()
        inputs = [batch[k].clone() for k in names]
        state = self.state_tensors()
        saved = [t.clone() for t in state]
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self._step_in_place(boundary, dict(zip(names, inputs)))
            for t, s_ in zip(state, saved):
                t.copy_(s_)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        del saved
        graph = torch.cuda.CUDAGraph()
        before = dict(ops.LAUNCHES)
        with torch.cuda.graph(graph, stream=stream):
            metrics = self._step_in_place(boundary, dict(zip(names, inputs)))
        self.capture_launches[key] = {k: n - before[k] for k, n in ops.LAUNCHES.items()}
        self.capture_seconds[key] = time.perf_counter() - t0
        metric_names = sorted(metrics)
        return _Captured(graph, inputs, tuple(metrics[k] for k in metric_names), None), \
            metric_names

    def step(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        depth = self.policy.depth_at(self._step, self.cfg.n_layers)
        boundary = depth_to_boundary(self.cfg, depth)
        on_device = to_device(batch, self.device)
        if self.graphs:
            metrics = self._graphed(boundary, on_device)
        else:
            metrics = self._step_in_place(boundary, on_device)
        self._step += 1
        extras = {k: v for k, v in metrics.items() if k != "loss"}
        return {"loss": metrics["loss"], "boundary": boundary, "depth": depth,
                "step": self._step, "tokens": int(np.size(batch["tokens"])),
                "extras": extras}

    def export_params(self) -> Dict[str, Any]:
        return self._params

    def state(self) -> Dict[str, Any]:
        p = self._params
        return {"format": self.format,
                "params": bridge.trainable_to_reference([b["adapter"] for b in p["blocks"]],
                                                        p["head"], self.cfg),
                "opt": bridge.opt_state_to_reference(self._opt, self.cfg)}

    def load_state(self, params, opt, *, step: int) -> None:
        """Copy the state into the backend's tensors (its graphs read them)."""
        adapters, head = bridge.trainable_from_reference(params, self.cfg)
        with torch.no_grad():
            bridge.copy_into(self._trainable(), {"adapters": adapters, "head": head})
            bridge.copy_into(self._opt, bridge.opt_state_from_reference(opt, self.cfg))
        self._step = step


class ChaosBackend:
    """Churn injection and elasticity over a ring backend.

    Wraps an executor-backed ring backend (fused or cached) and, each
    ``step``:

      1. fires every pending :class:`~repro_torch.core.simulator.ChurnEvent`
         whose round has come (``round=3``: rounds 0-2 ran on the old fleet):
         a ``crash`` or ``leave`` shrinks the ring (with ``elastic=True``;
         without it the crash raises, as a ring without elasticity would
         stall), a ``slowdown`` makes that device's true speed lower, a
         ``join`` gives a device of the original fleet its place back;
      2. trims the round's ``[S0, ...]`` batch to the survivors' rows (the
         data source keeps producing at the original ring size, so that save
         and resume replay the same batches across a shrink);
      3. runs the inner backend's step;
      4. puts the stage times of the true speeds, ``span_size / speed`` (the
         tick model; a deployment would measure them), in
         ``extras["stage_times"]``, and the survivors in
         ``extras["survivors"]``;
      5. with ``elastic=True`` feeds those times to a
         :class:`~repro_torch.core.elastic.StragglerDetector` and applies its
         hysteresis-gated repartition.

    A round that changed the layout is marked ``raw["layout_changed"]``, so
    that the session re-seeds its monotone-boundary check and suspends a
    plateau policy for the blip. Everything else delegates to the inner
    backend.
    """

    def __init__(self, inner, *, events: Sequence[ChurnEvent] = (), elastic: bool = False,
                 device_profiles=None, log=print):
        self.inner = inner
        self.elastic = elastic
        self.log = log
        self.events: List[ChurnEvent] = sorted(events, key=lambda e: e.round)
        if device_profiles is not None:
            profs = parse_device_profiles(device_profiles)
            if len(profs) != inner.S:
                raise ValueError(f"{len(profs)} device profiles for a {inner.S}-stage ring")
        else:
            profs = [DeviceProfile(1.0, float("inf")) for _ in range(inner.S)]
        # keyed by the ORIGINAL device index; survivors maps stage -> original device
        self.profiles: Dict[int, DeviceProfile] = dict(enumerate(profs))
        self.speeds: Dict[int, float] = {i: p.compute_speed for i, p in self.profiles.items()}
        self.survivors: List[int] = list(range(inner.S))
        self.detector: Optional[StragglerDetector] = (
            StragglerDetector(profs, inner.cfg.repeats) if elastic else None)
        self.flush_hook = None              # the session's: flush lazy metrics
        self.round_idx = 0                  # rounds of this run (a resumed run starts at 0)
        self.shrinks = 0
        self.repartitions = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _flush(self) -> None:
        if self.flush_hook is not None:
            self.flush_hook()

    def _survivor_profiles(self) -> List[DeviceProfile]:
        if self.detector is not None:
            return self.detector.fleet      # the EWMA-refit speeds
        return [self.profiles[d] for d in self.survivors]

    def _drop(self, device: int) -> None:
        """Shrink original device ``device``'s stage out of the ring."""
        stage = self.survivors.index(device)
        self.survivors.pop(stage)
        if self.detector is not None:
            self.detector.remove(stage)
        self.inner.shrink(stage, self._survivor_profiles())
        self.shrinks += 1

    def _apply(self, ev: ChurnEvent) -> bool:
        """Fire one event against the live ring; True if the layout moved."""
        if ev.kind in ("crash", "leave"):
            if ev.device not in self.survivors:
                raise ValueError(f"churn {ev.kind} targets device {ev.device}, which is not "
                                 f"alive (survivors: {self.survivors})")
            if not self.elastic:
                raise RuntimeError(
                    f"device {ev.device} {'crashed' if ev.kind == 'crash' else 'left'} at "
                    f"round {self.round_idx} and the ring is not elastic — run with "
                    f"elastic=True (--elastic) to shrink and continue")
            self._flush()
            old = [list(sp) for sp in self.inner.spans]
            self._drop(ev.device)
            self.log(f"[elastic] device {ev.device} {ev.kind} at round {self.round_idx}: ring "
                     f"{len(self.survivors) + 1} -> {len(self.survivors)} stages, spans {old} "
                     f"-> {[list(sp) for sp in self.inner.spans]} (cache re-captures next "
                     f"round)")
            return True
        if ev.kind == "slowdown":
            if ev.device not in self.survivors:
                raise ValueError(f"churn slowdown targets device {ev.device}, which is not "
                                 f"alive (survivors: {self.survivors})")
            self.speeds[ev.device] /= ev.factor
            self.log(f"[elastic] device {ev.device} slowed {ev.factor}x at round "
                     f"{self.round_idx}"
                     + ("" if self.elastic else
                        " (not elastic: the ring will limp, not repartition)"))
            return False                    # the detector finds it from the stage times
        # join: only a device of the original fleet can take its place back,
        # since the data source owns exactly the original S0 rows
        if ev.device in self.survivors:
            raise ValueError(f"churn join: device {ev.device} is already in the ring")
        if ev.device not in self.profiles:
            raise ValueError(f"churn join: device {ev.device} was never part of the original "
                             f"fleet — only rejoining devices are supported (the data source "
                             f"owns the original rows)")
        if not self.elastic:
            raise RuntimeError(f"device {ev.device} rejoined at round {self.round_idx} and the "
                               f"ring is not elastic — run with elastic=True (--elastic)")
        prof = ev.profile or self.profiles[ev.device]
        stage = sum(1 for d in self.survivors if d < ev.device)
        self._flush()
        self.survivors.insert(stage, ev.device)
        if self.detector is not None:
            self.detector.insert(stage, prof)
        self.inner.grow(self._survivor_profiles())
        self.log(f"[elastic] device {ev.device} rejoined at round {self.round_idx}: ring "
                 f"{len(self.survivors) - 1} -> {len(self.survivors)} stages, spans "
                 f"{[list(sp) for sp in self.inner.spans]}")
        return True

    def step(self, batch) -> Dict[str, Any]:
        layout_changed = False
        while self.events and self.events[0].round <= self.round_idx:
            layout_changed |= self._apply(self.events.pop(0))
        if len(self.survivors) != len(self.profiles):
            rows = list(self.survivors)     # axis 0 of [S0, ...] and [S0, T, ...] alike
            if len(batch) == 3:
                slot, tokens, labels = batch
                batch = (slot, tokens[rows], labels[rows])
            else:
                tokens, labels = batch
                batch = (tokens[rows], labels[rows])
        raw = self.inner.step(batch)
        stage_times = [(e - b) / self.speeds[dev]
                       for (b, e), dev in zip(self.inner.spans, self.survivors)]
        extras = raw.setdefault("extras", {})
        extras["stage_times"] = stage_times
        extras["survivors"] = list(self.survivors)
        if self.detector is not None:
            self.detector.observe(self.inner.spans, stage_times)
            prop = self.detector.propose(self.inner.spans)
            if prop is not None:
                self._flush()
                old = [list(sp) for sp in self.inner.spans]
                self.inner.repartition(prop)
                self.repartitions += 1
                layout_changed = True
                self.log(f"[elastic] straggler repartition at round {self.round_idx}: spans "
                         f"{old} -> {[list(sp) for sp in self.inner.spans]} (EWMA speeds "
                         f"{[round(s, 3) for s in self.detector.speeds]})")
        if layout_changed:
            raw["layout_changed"] = True
            extras["layout_changed"] = True
        self.round_idx += 1
        return raw

    def restore_membership(self, survivors: Sequence[int], spans=None) -> None:
        """Replay a checkpoint's fleet onto a ring freshly built at the
        original size: shrink away every device missing from ``survivors``
        (in stage order), then repartition to the saved ``spans``. Runs
        before ``load_state``, so that the stage-stacked moments land on the
        geometry they were saved from."""
        for dead in [d for d in self.survivors if d not in survivors]:
            self._drop(dead)
        if list(survivors) != self.survivors:
            raise ValueError(f"saved survivors {list(survivors)} are not a subset of the "
                             f"original fleet {sorted(self.profiles)}")
        if spans is not None:
            self.inner.repartition(spans)
