"""RingExecutor: the fused RingAda round (the reference's ``core/executor.py``).

One round runs all S owner iterations of RingAda Algorithm 1 (each client
the initiator once) as one program per unfreeze boundary:

  * every owner's microbatches are embedded once (``pipeline.gather_embeddings``);
  * Phase A, the frozen trunk, runs once for the whole round as the packed
    conveyor (``pipeline.ring_phase_a_packed``: ``S*M + F - 1`` ticks instead
    of S pipelines of ``M + F - 1``), or per owner (``ring_phase_a``) with
    ``packed=False`` and at ``F <= 1``, where packing saves nothing;
  * each owner iteration takes its stage-F inputs, runs Phase B
    (``ring_phase_b``) with autograd, and applies the raw AdamW update
    (``adamw.leaf_update`` at constant lr, no bias correction) to the hot
    stages' adapters and moments and to the head; the optimizer's ``count``
    grows by S a round.

The stage mask ``stage >= F`` of the reference is static here: on one device
the boundary is fixed per build, so the frozen stages are simply not updated
and their adapters and moments stay bit-identical.

The frozen-trunk activation cache (``core/actcache.py``): with a
``cache_capacity`` and slot-keyed batches, a boundary has up to three
rounds (``make_fused_round``'s modes):

  * ``direct``: the round above (``slot=None``, or a batch that does not fit
    the cache's buffer);
  * ``capture``: the direct round that also writes every owner's stage-F
    inputs into the cache's buffer at a row (a miss of ``(slot, boundary)``;
    the row is taken, as ``put`` takes it, before the round runs);
  * ``cached``: no tokens, no embeddings, no Phase A: the row is read on the
    device, dequantised, and each owner's Phase B and update run as in
    ``direct`` (a hit).

A boundary drop invalidates the whole cache (the schedule is monotone);
``repartition`` flushes it (``set_layout``); ``shrink`` and ``grow`` (the
elastic ring: S - 1 or S + 1 stages over the same tensors) rebind it.

On a CUDA device each (boundary, mode) round is one CUDA graph, the
counterpart of the reference's one donated executable per (boundary, mode).
The first round of a (boundary, mode) warms the round up on a side stream
(kernel builds, cuBLAS, the autograd engine), puts the trainable state back
as it was, captures the round on that stream and replays it; later rounds
copy their tokens, labels and cache row into the graph's input buffers and
replay. The row is a device tensor among the graph's inputs, so one capture
graph and one cached graph serve every row; the cache's buffer is allocated
before the first graph that uses it is captured, and is never reallocated
while that graph lives. The executor owns its trainable leaves (adapters,
head, moments, ``count``) and updates them in place, so a graph reads and
writes the same memory at every replay; the frozen backbone stays views of
the caller's parameters. A new batch shape builds another graph (the
reference retraces), and a boundary's graphs are dropped when the boundary
drops (it never runs again). A failed capture raises: nothing falls back to
eager launches on CUDA tensors. On the CPU the same round functions run
eagerly.

Several tenants (``tenants=T``): one frozen trunk and T adapter-and-head
sets. Phase A carries every tenant's microbatches on one ``T*S*M + F - 1``-
tick conveyor (the frozen stages are every tenant's, the same bits); Phase
B, its backward and the update run tenant after tenant on one-tenant shapes,
so a tenant's round equals its solo round bit for bit. The reference sums the
head's gradient over its stages a second time (a ``psum`` after
``shard_map`` has summed it); the port does not, so its joint round is its
own solo rounds' and ``RingTrainer``'s. The cache partitions per tenant under
``(tenant, slot, boundary)`` keys. On the card there is still one CUDA graph
per (boundary, mode): a joint round launches T times a solo round's Phase-B
kernels at the solo shapes.

``round()`` does not wait for the device: it returns the S losses and their
mean as device tensors; ``materialize_metrics`` turns them into floats.

The boundary is taken once per round, at the round's first step (the
reference does the same). With ``tc.unfreeze_interval`` a multiple of S this
is the ``RingTrainer``'s per-iteration boundary; otherwise a change inside a
round waits for the next round.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import bridge
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import actcache
from repro_torch.core import pipeline as pl
from repro_torch.core.actcache import ActivationCache
from repro_torch.core.partition import (DeviceProfile, Span, align_boundary, frozen_stage_count,
                                        spans_from_profiles)
from repro_torch.core.unfreeze import UnfreezeSchedule, depth_to_boundary
from repro_torch.kernels import ops
from repro_torch.models import params as prm
from repro_torch.optim import adamw

FUSED_MODES = ("direct", "capture", "cached")


def scalarize(v: Any) -> Any:
    """A metric tensor as a float (0-d) or a list of floats; anything else
    passes through. The one rule that turns a round's device metrics into host
    values (``RingExecutor.materialize_metrics``, ``api.metrics``)."""
    if isinstance(v, torch.Tensor):
        return float(v) if v.ndim == 0 else v.tolist()
    return v


def ring_opt_init(stage_adapters, head) -> Dict[str, Any]:
    """The ring's optimizer state: the adapters' moments in the stage layout,
    the head's, and the step ``count`` (a 0-d int32 tensor)."""
    m_ad, v_ad = adamw.init_moments(stage_adapters)
    m_hd, v_hd = adamw.init_moments(head)
    device = next(iter(head.values())).device
    return {"m": {"adapter": m_ad, "head": m_hd}, "v": {"adapter": v_ad, "head": v_hd},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def tenant_view(tree: Any, tenant: Optional[int]) -> Any:
    """Tenant ``tenant``'s slice of a tenant-stacked tree (each leaf's
    ``x[tenant]``, a contiguous view); ``None``: the tree as it is (one
    tenant)."""
    return tree if tenant is None else tree_map(lambda x: x[tenant], tree)


def make_fused_round(cfg: ModelConfig, tc: TrainConfig, *, n_stages: int, boundary: int,
                     n_micro: int, packed: bool = True,
                     spans: Optional[Sequence[Span]] = None,
                     tick_record: Optional[Callable[[str, int], None]] = None,
                     mode: str = "direct", cache_dtype: str = "native",
                     cache_src_dtype: Optional[torch.dtype] = None,
                     tenants: int = 1) -> Callable:
    """Build one round at ``boundary`` (span-aligned) that updates in place
    the hot stages' adapters, the head, their moments and
    ``opt_state["count"]``, and returns ``(losses [S], mean)``, in one of
    three modes:

      direct:  ``fn(stage_blocks, shared, opt_state, tokens, labels)``;
      capture: ``fn(stage_blocks, shared, opt_state, tokens, labels,
               cache_buf, cache_scales, row)``, the direct round that also
               writes every owner's stage-F inputs, ``[S, M, mb, seq, D]``
               (at F = 0 the embeddings), into ``cache_buf`` at ``row`` (an
               int or a 0-d device tensor), quantised under ``cache_dtype``
               (``cache_scales``: the int8 sidecar, else None);
      cached:  ``fn(stage_blocks, shared, opt_state, cache_buf, cache_scales,
               row, labels)``: no tokens, no embeddings, no Phase A. The row
               is gathered on the device, dequantised to ``cache_src_dtype``
               (default: the model's dtype) and feeds each owner's Phase B.

    ``tokens`` / ``labels``: ``[S, M, mb, seq]``. ``tick_record(phase,
    ticks)`` receives each tick phase's length ("phase_a_packed", "phase_a"
    or "phase_b"), as it runs.

    ``tenants=T > 1``: one frozen trunk, T adapter sets. The adapters, the
    head and their moments carry a leading tenant axis on every leaf
    (``[T, ...]``), tokens and labels are ``[S, T, M, mb, seq]``, ``row`` is
    T rows (a list or a ``[T]`` device tensor; tenant t's entry has the
    one-tenant shape), and the round returns ``(losses [S], mean,
    tenant_losses [T], grid [S, T])``: ``grid`` each owner's loss per
    tenant, ``losses`` its means over the tenants, ``mean`` its f32 mean.
    Phase A runs once for every tenant (``ring_phase_a_packed(n_tenants=T)``,
    on tenant 0's frozen adapters, which are every tenant's); Phase B, its
    backward and the update run tenant after tenant on one-tenant shapes
    (batched tenants would sum in another order), so each tenant's round is
    its solo round bit for bit."""
    if mode not in FUSED_MODES:
        raise ValueError(f"mode must be one of {FUSED_MODES}, got {mode!r}")
    if tenants < 1:
        raise ValueError(f"tenants must be >= 1, got {tenants}")
    T = tenants
    spans = pl.resolve_spans(cfg.repeats, n_stages, spans)
    F = frozen_stage_count(spans, boundary)
    rec = tick_record or (lambda phase, ticks: None)
    geometry = dict(n_stages=n_stages, boundary=boundary, n_micro=n_micro, spans=spans)
    phase_a = pl.ring_phase_a(cfg, record=lambda t: rec("phase_a", t), **geometry)
    phase_a_packed = pl.ring_phase_a_packed(cfg, record=lambda t: rec("phase_a_packed", t),
                                            n_tenants=T, **geometry)
    phase_b = pl.ring_phase_b(cfg, record=lambda t: rec("phase_b", t), **geometry)
    use_packed = packed and F >= 2       # at F <= 1 the conveyor saves no tick
    lr = tc.learning_rate
    out_dtype = cache_src_dtype if cache_src_dtype is not None else prm.DTYPES[cfg.dtype]
    tenant_ids = [None] if T == 1 else list(range(T))
    # owner o's (and tenant t's) slice of a batch or of Phase A's outputs; tenant t's row
    at = lambda x, o, t: x[o] if t is None else x[o][t]
    row_of = lambda row, t: row if t is None else row[t]

    def update(g, m, v, p):
        m2, v2, p2 = adamw.leaf_update(g, m, v, p, lr=lr, tc=tc)
        m.copy_(m2)
        v.copy_(v2)
        p.copy_(p2)

    def train_owners(stage_blocks, shared, opt_state, h_of, labels):
        """Each owner's Phase B on ``h_of(owner, tenant)`` (its M stage-F
        inputs) and the raw AdamW update, owner after owner, tenant after
        tenant (``tenant`` None at one tenant)."""
        leaf = lambda t: t.detach().requires_grad_(True)
        m, v = opt_state["m"], opt_state["v"]
        losses = [[] for _ in tenant_ids]
        for owner in range(n_stages):
            for i, t in enumerate(tenant_ids):
                h_B = h_of(owner, t)
                # tenant t's hot adapters and head (views), and leaves of them for autograd
                hot_t = [[tenant_view(layer["adapter"], t) for layer in stage]
                         for stage in stage_blocks[F:]]
                head_t = tenant_view(shared["head"], t)
                hot = [[tree_map(leaf, a) for a in stage] for stage in hot_t]
                head = tree_map(leaf, head_t)
                with torch.enable_grad():
                    loss = phase_b(pl._hot_stages(stage_blocks, hot, F),
                                   {**shared, "head": head}, h_B, at(labels, owner, t))
                    flat = [x for stage in hot for a in stage for x in a.values()] + \
                        list(head.values())
                    grads = iter(torch.autograd.grad(loss, flat))
                with torch.no_grad():
                    for u, stage in enumerate(hot_t, start=F):
                        for j, a in enumerate(stage):
                            m_a = tenant_view(m["adapter"][u][j], t)
                            v_a = tenant_view(v["adapter"][u][j], t)
                            for k in a:
                                update(next(grads), m_a[k], v_a[k], a[k])
                    m_h, v_h = tenant_view(m["head"], t), tenant_view(v["head"], t)
                    for k, p in head_t.items():
                        update(next(grads), m_h[k], v_h[k], p)
                losses[i].append(loss.detach())
        with torch.no_grad():
            opt_state["count"].add_(n_stages)
            per_tenant = [torch.stack(lt) for lt in losses]       # [S] each
            if T == 1:
                return per_tenant[0], per_tenant[0].mean()
            # a tenant's mean is its solo round's mean, the same op on the same [S]
            tenant_losses = torch.stack([lt.mean() for lt in per_tenant])
            grid = torch.stack(per_tenant, dim=1)                  # [S, T]
            return grid.mean(dim=1), grid.mean(), tenant_losses, grid

    if mode == "cached":
        def cached(stage_blocks, shared, opt_state, cache_buf, cache_scales, row, labels):
            with torch.no_grad():
                h = {t: actcache.read_row(cache_buf, cache_scales, row_of(row, t), cache_dtype,
                                          out_dtype) for t in tenant_ids}
            return train_owners(stage_blocks, shared, opt_state,
                                lambda o, t: list(h[t][o]), labels)

        return cached

    def fused(stage_blocks, shared, opt_state, tokens, labels, cache_buf=None,
              cache_scales=None, row=None):
        emb_g = pl.gather_embeddings(cfg, shared, tokens)
        # Phase A reads only the frozen stages, whose adapters every tenant shares
        trunk = [[{**layer, "adapter": tenant_view(layer["adapter"], tenant_ids[0])}
                  for layer in stage] for stage in stage_blocks]
        h_all = phase_a_packed(trunk, emb_g) if use_packed else None
        entry = {t: [] for t in tenant_ids}

        def h_of(owner, t):
            h_B = at(h_all, owner, t) if use_packed else phase_a(trunk, at(emb_g, owner, t))
            if mode == "capture":
                entry[t].append(torch.stack(h_B))
            return h_B

        out = train_owners(stage_blocks, shared, opt_state, h_of, labels)
        if mode == "capture":
            with torch.no_grad():
                for t in tenant_ids:          # in tenant order, as the rows were taken
                    actcache.write_row(cache_buf, cache_scales, row_of(row, t),
                                       torch.stack(entry[t]), cache_dtype)
        return out

    return fused


class _Captured:
    """One (boundary, mode, shape) round as a CUDA graph, with its input
    buffers (tokens, labels and the cache row; None where the mode takes
    none), its output buffers and the cache buffer it reads or writes (kept
    alive while the graph lives)."""

    def __init__(self, graph: torch.cuda.CUDAGraph, inputs: Sequence[Optional[torch.Tensor]],
                 out: Tuple[torch.Tensor, torch.Tensor], cache_buf: Optional[torch.Tensor]):
        self.graph, self.inputs, self.out, self.cache_buf = graph, inputs, out, cache_buf

    def __call__(self, *args):
        for buf, x in zip(self.inputs, args, strict=True):
            if buf is None:
                continue
            if isinstance(x, int):
                buf.fill_(x)                         # the cache row: no host-to-device copy
            elif isinstance(x, (list, tuple)):
                for i, r in enumerate(x):            # a row per tenant
                    buf[i].fill_(r)
            else:
                buf.copy_(x)
        self.graph.replay()
        # the graph's outputs are overwritten at the next replay
        return tuple(t.clone() for t in self.out)


class RingExecutor:
    """Collaborative fine-tuning over a ring of ``n_stages`` stages on one
    device (the device of ``params``), a round at a time as one program.

    The same surface as :class:`~repro_torch.core.ring.RingTrainer`, its
    oracle: ``round(tokens, labels)``, ``export_params()``, ``boundary_at``,
    ``stage_adapters()``. ``packed``: Phase A as one conveyor a round (the
    default) or per owner. ``spans``: any layout, ragged included.

    With ``cache_capacity > 0`` the executor holds an
    :class:`~repro_torch.core.actcache.ActivationCache` (``cache``) of
    ``cache_dtype`` entries, and ``round(tokens, labels, slot=s)`` with a
    stable batch-slot id skips Phase A on the revisits of ``(slot,
    boundary)``. ``slot=None`` (or capacity 0) runs the direct round.

    ``tenants=T > 1``: one frozen trunk, T adapter-and-head sets, all
    starting from ``params``' (``adamw.tenant_stack``). Every adapter, head
    and moment leaf gains a leading tenant axis, so a tenant's slice is one
    contiguous tensor (the adapter kernels build TMA descriptors on it);
    batches are ``[S, T, M, mb, seq]``; the cache keys ``(tenant, slot,
    boundary)`` and a round hits only when every tenant's key is resident;
    ``round`` adds ``tenant_losses`` and the per-tenant cache counts.
    ``export_adapters(t)`` / ``import_adapters(t, bundle)`` and
    ``export_tenant_opt(t)`` / ``import_tenant_opt(t, opt)`` move one
    tenant's set (an ``AdapterStore`` bundle's layout) in and out by copy;
    an import frees only that tenant's cache rows.
    """

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, params: Dict[str, Any],
                 n_stages: int, n_micro: int, *, schedule=None, packed: bool = True,
                 spans: Optional[Sequence[Span]] = None, cache_capacity: int = 0,
                 cache_dtype: str = "native", tenants: int = 1):
        if tenants < 1:
            raise ValueError(f"tenants must be >= 1, got {tenants}")
        self.cfg, self.tc, self.packed = cfg, tc, packed
        self.S, self.M, self.T = n_stages, n_micro, tenants
        self.spans = pl.resolve_spans(cfg.repeats, n_stages, spans)
        self.lps = None if pl.is_ragged(self.spans) else cfg.repeats // n_stages
        stage_blocks, shared = pl.stage_stack(params, cfg, n_stages, spans=self.spans)
        own = (lambda t: t.detach().clone()) if tenants == 1 else \
            (lambda t: adamw.tenant_stack(t.detach(), tenants))
        self.stage_blocks = [[{**layer, "adapter": tree_map(own, layer["adapter"])}
                              for layer in stage] for stage in stage_blocks]
        self.shared = {**shared, "head": tree_map(own, shared["head"])}
        self._params_rest = {k: v for k, v in params.items() if k != "blocks"}
        self.opt_state = ring_opt_init(self.stage_adapters(), self.shared["head"])
        self.sched = schedule if schedule is not None else UnfreezeSchedule.from_train_config(tc)
        self.device = self.shared["head"]["w"].device
        if tenants > 1 and self.device.type == "cuda":
            self._check_tenant_views()
        # per-tenant cache counts: one tenant's invalidation leaves the others'
        self.tenant_hits = [0] * tenants
        self.tenant_misses = [0] * tenants
        self.cache_dtype = cache_dtype
        self.cache: Optional[ActivationCache] = None
        if cache_capacity:
            self.cache = ActivationCache(cache_capacity, dtype=cache_dtype, device=self.device,
                                         layout=self.spans)
        self.step = 0
        self._last_boundary: Optional[int] = None
        self._rounds: Dict[Tuple, Callable] = {}       # (boundary, mode, shapes) -> built round
        # the rest keyed (boundary, mode)
        self.build_counts: Dict[Tuple[int, str], int] = {}   # captures (CPU: builds)
        self.tick_scan_lens: Dict[Tuple[int, str], Dict[str, int]] = {}
        self.capture_launches: Dict[Tuple[int, str], Dict[str, int]] = {}  # launches captured
        self.capture_seconds: Dict[Tuple[int, str], float] = {}   # warm-up and capture

    def stage_adapters(self):
        """The adapters in the stage layout: a list per stage of one dict per
        layer (leaves ``[T, ...]`` with several tenants)."""
        return [[layer["adapter"] for layer in stage] for stage in self.stage_blocks]

    def _check_tenant_views(self) -> None:
        """Every tenant's slice of every tenant-stacked leaf is contiguous and
        16-byte aligned: the adapter kernels take it as it is."""
        for x in self.trainable_tensors()[:-1]:
            for t in range(self.T):
                v = x[t]
                assert v.is_contiguous() and v.data_ptr() % 16 == 0, \
                    f"tenant {t}'s slice of a {tuple(x.shape)} leaf is not a contiguous, " \
                    f"16-byte aligned tensor"

    def boundary_at(self, step: int) -> int:
        """The span-aligned boundary (frozen repeats from the bottom) at ``step``."""
        depth = self.sched.depth_at(step, self.cfg.n_layers)
        return align_boundary(self.spans, depth_to_boundary(self.cfg, depth))

    def to_device(self, tokens, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        """[S, M, mb, seq] token ids (numpy or tensors) as int64 on the executor's device."""
        return (torch.as_tensor(tokens).long().to(self.device),
                torch.as_tensor(labels).long().to(self.device))

    def trainable_tensors(self) -> List[torch.Tensor]:
        """Every tensor a round writes: the adapters, the head, their moments
        and ``count`` (snapshot these to undo rounds)."""
        ads = [t for stage in self.stage_adapters() for a in stage for t in a.values()]
        return ads + list(self.shared["head"].values()) + \
            tree_leaves(self.opt_state["m"]) + tree_leaves(self.opt_state["v"]) + \
            [self.opt_state["count"]]

    def _build(self, boundary: int, mode: str) -> Callable:
        """The (boundary, mode) round as ``fn(tokens, labels, row)`` on the
        executor's state and cache (``tokens`` unused in ``cached`` mode,
        ``row`` in ``direct``)."""
        key = (boundary, mode)

        def tick_rec(phase, ticks):
            self.tick_scan_lens.setdefault(key, {})[phase] = ticks

        self.build_counts[key] = self.build_counts.get(key, 0) + 1
        fn = make_fused_round(self.cfg, self.tc, n_stages=self.S, boundary=boundary,
                              n_micro=self.M, packed=self.packed, spans=self.spans,
                              tick_record=tick_rec, mode=mode, cache_dtype=self.cache_dtype,
                              cache_src_dtype=None if self.cache is None
                              else self.cache.src_dtype, tenants=self.T)
        state = lambda: (self.stage_blocks, self.shared, self.opt_state)
        if mode == "direct":
            return lambda tokens, labels, row: fn(*state(), tokens, labels)
        cache = self.cache
        if mode == "capture":
            return lambda tokens, labels, row: fn(*state(), tokens, labels, cache.buffer,
                                                  cache.scales, row)
        return lambda tokens, labels, row: fn(*state(), cache.buffer, cache.scales, row, labels)

    def _capture(self, boundary: int, mode: str, tokens: torch.Tensor, labels: torch.Tensor,
                 row: Optional[int]) -> _Captured:
        """Warm the round up on a side stream from a copy of the trainable
        state, put the state back, and capture the round on that stream. The
        graph's inputs are copies of ``tokens`` and ``labels`` and a 0-d
        device tensor holding the cache row (a ``[T]`` one with several
        tenants), as the mode takes them."""
        fn = self._build(boundary, mode)
        t0 = time.perf_counter()
        inputs = (None if mode == "cached" else tokens.clone(), labels.clone(),
                  None if mode == "direct" else
                  torch.tensor(row, dtype=torch.long, device=self.device))
        state = self.trainable_tensors()
        saved = [t.clone() for t in state]
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            fn(*inputs)
            for t, s in zip(state, saved):
                t.copy_(s)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        del saved
        graph = torch.cuda.CUDAGraph()
        before = dict(ops.LAUNCHES)
        with torch.cuda.graph(graph, stream=stream):
            out = fn(*inputs)
        self.capture_launches[(boundary, mode)] = {k: n - before[k]
                                                   for k, n in ops.LAUNCHES.items()}
        self.capture_seconds[(boundary, mode)] = time.perf_counter() - t0
        return _Captured(graph, inputs, out, None if mode == "direct" else self.cache.buffer)

    def _round_fn(self, boundary: int, mode: str, tokens: torch.Tensor, labels: torch.Tensor,
                  row: Optional[int]) -> Callable:
        """The built round for (boundary, mode) at these shapes, built (on
        the card: captured) at its first use. A new shape builds anew, as the
        reference retraces; a graph that held a cache buffer the cache has
        since dropped (``rebind``) is rebuilt."""
        key = (boundary, mode, tuple(tokens.shape), tuple(labels.shape))
        fn = self._rounds.get(key)
        if isinstance(fn, _Captured) and fn.cache_buf is not None and \
                fn.cache_buf is not self.cache.buffer:
            fn = None
        if fn is None:
            if self.device.type == "cuda":
                fn = self._capture(boundary, mode, tokens, labels, row)
            else:
                fn = self._build(boundary, mode)
            self._rounds[key] = fn
        return fn

    def _entry_shape(self, labels: torch.Tensor) -> Tuple[int, ...]:
        """One cache entry's shape for this batch: every owner's stage-F
        inputs, [S_owner, M, mb, seq, D] (the reference's adds a leading
        S_stage axis: module docstring of ``core/actcache.py``); with several
        tenants, each tenant's entry, the same shape."""
        M, mb, seq = labels.shape[-3:]
        return (self.S, M, mb, seq, self.cfg.d_model)

    def _keys(self, slot: int, boundary: int) -> List[Tuple[int, ...]]:
        """The round's cache keys: ``(slot, boundary)``, or ``(tenant, slot,
        boundary)`` per tenant."""
        if self.T == 1:
            return [(slot, boundary)]
        return [(t, slot, boundary) for t in range(self.T)]

    def round(self, tokens, labels, *, slot: Optional[int] = None) -> Dict[str, Any]:
        """One training round: every client is the initiator once.

        tokens / labels: [S, M, mb, seq], each client's local data
        ([S, T, M, mb, seq] with several tenants). ``slot``:
        a stable batch-slot id (the same slot holds the same examples every
        epoch: ``RingBatcher.next_slot``), the cache's key with the boundary.
        On a hit the ``cached`` round runs, on a miss the ``capture`` round
        (its row taken before it runs); a batch that does not fit the buffer
        bypasses the cache, as ``slot=None`` does. Returns the losses of the
        S owner iterations and their mean (device tensors), the round's
        boundary, the step count, ``cache_hit`` and, with a cache, its
        ``stats()``. With several tenants the round hits only when every
        tenant's key is resident (a miss recaptures every tenant's row), and
        the record adds ``tenant_losses`` [T], ``tenant_owner_losses`` [S, T]
        (each owner's loss per tenant) and the per-tenant ``tenant_cache_hits``
        and ``tenant_cache_misses``.
        """
        tokens, labels = self.to_device(tokens, labels)
        boundary = self.boundary_at(self.step)
        if self._last_boundary is not None and boundary > self._last_boundary:
            raise RuntimeError(f"unfreeze boundary increased {self._last_boundary} -> "
                               f"{boundary} at step {self.step}; RingAda schedules are "
                               f"monotone top-down and the activation cache's invalidation "
                               f"depends on it (core/unfreeze.py)")
        if boundary != self._last_boundary:
            self._rounds.clear()                 # an earlier boundary's graphs never run again
            if self.cache is not None and self._last_boundary is not None:
                self.cache.invalidate()          # a boundary drop: every key is dead
        self._last_boundary = boundary

        mode, row = "direct", None
        if self.cache is not None and slot is not None:
            shape = self._entry_shape(labels)
            if not self.cache.compatible(shape):
                self.cache.bypasses += 1         # the batch does not fit the buffer
            else:
                keys = self._keys(slot, boundary)
                rows = [self.cache.index_of(k) for k in keys]
                if self.T > 1:
                    for t, r in enumerate(rows):
                        if r is None:
                            self.tenant_misses[t] += 1
                        else:
                            self.tenant_hits[t] += 1
                if all(r is not None for r in rows):
                    mode = "cached"
                else:
                    # put's bookkeeping before the round, in tenant order: the
                    # capture writes the rows (a hit tenant's is refreshed)
                    dtype = self.shared["embed"]["tok"].dtype
                    rows = [self.cache.reserve(k, shape, dtype) for k in keys]
                    mode = "capture"
                row = rows[0] if self.T == 1 else rows
        out = self._round_fn(boundary, mode, tokens, labels, row)(tokens, labels, row)
        self.step += self.S
        rec = {"loss": out[1], "losses": out[0], "boundary": boundary, "step": self.step,
               "cache_hit": mode == "cached"}
        if self.T > 1:
            rec["tenant_losses"], rec["tenant_owner_losses"] = out[2], out[3]
            rec["tenant_cache_hits"] = list(self.tenant_hits)
            rec["tenant_cache_misses"] = list(self.tenant_misses)
        if self.cache is not None:
            rec.update(self.cache.stats())
        return rec

    @staticmethod
    def materialize_metrics(m: Dict[str, Any]) -> Dict[str, Any]:
        """A round's metrics with its tensors as floats (waits for the device)."""
        return {k: scalarize(v) for k, v in m.items()}

    def measured_tick_ledger(self, boundary: int, mode: str = "direct") -> Dict[str, int]:
        """The round's tick totals from the tick phases the (boundary, mode)
        build ran, in the keys of ``pipeline.pipeline_tick_counts``; KeyError
        if no such round was built since the last repartition."""
        if (boundary, mode) not in self.tick_scan_lens:
            raise KeyError(f"no ({boundary}, {mode!r}) round built yet")
        rec = self.tick_scan_lens[(boundary, mode)]
        S, M = self.S, self.M
        F = frozen_stage_count(self.spans, boundary)
        if "phase_a_packed" in rec:
            a_round, a_per_owner = rec["phase_a_packed"], 0
        elif "phase_a" in rec:
            a_round, a_per_owner = S * rec["phase_a"], rec["phase_a"]
        else:                                            # cached mode or F == 0
            a_round = a_per_owner = 0
        return {"fwd_ticks": a_per_owner + rec["phase_b"], "bwd_ticks": rec["phase_b"],
                "frozen_stages": F, "hot_stages": S - F, "phase_a_round_ticks": a_round,
                "phase_a_saved_ticks": S * (M + F - 1) - a_round
                if "phase_a_packed" in rec else 0}

    @property
    def n_executables(self) -> int:
        """(boundary, mode) rounds built (CUDA graphs captured) since the last repartition."""
        return len(self.tick_scan_lens)

    def compile_counts(self) -> Dict[str, int]:
        """``{'<boundary>/<mode>': builds}``: captures on the card, builds on
        the CPU, one more for each new batch shape, as the reference counts
        its traces."""
        return {f"{b}/{mode}": n for (b, mode), n in sorted(self.build_counts.items())}

    def repartition(self, spans: Sequence[Span]) -> None:
        """Switch to another span layout mid-run: the stages and the adapters'
        moments are sliced anew (the same tensors), every built round is
        dropped, the cache is flushed (``set_layout``; its buffer stays), and
        the boundary check starts afresh (span edges moved)."""
        new = pl.resolve_spans(self.cfg.repeats, self.S, spans)
        if new != self.spans:
            self._relayout(self.S, new)

    def _relayout(self, n_stages: int, new: Tuple[Span, ...]) -> None:
        """Re-list the same per-layer tensors of the stages and of the
        adapters' moments into ``n_stages`` stages of ``new`` spans (the head,
        its moments and ``count`` stay as they are; no tensor is copied), drop
        every built round and tick ledger, and start the boundary check
        afresh. A change of S rebinds the cache (an entry's shape carries S):
        its buffer goes with the graphs that held it, and on the card the
        dropped graphs' pools go back to the device (``empty_cache``), so a
        crash and a rejoin do not leave one set of graphs' memory reserved."""
        per = self.cfg.layers_per_repeat
        restage = lambda stages: [[x for stage in stages for x in stage][b * per:e * per]
                                  for b, e in new]
        self.stage_blocks = restage(self.stage_blocks)
        for name in ("m", "v"):
            self.opt_state[name]["adapter"] = restage(self.opt_state[name]["adapter"])
        resized = n_stages != self.S
        self.S, self.spans = n_stages, new
        self.lps = None if pl.is_ragged(new) else self.cfg.repeats // n_stages
        self._rounds.clear()
        self.tick_scan_lens.clear()
        if self.cache is not None:
            if resized:
                self.cache.rebind(layout=new)
            else:
                self.cache.set_layout(new)
        if resized and self.device.type == "cuda":
            torch.cuda.empty_cache()
        if self.T > 1 and self.device.type == "cuda":
            self._check_tenant_views()
        self._last_boundary = None

    # -- elastic membership: S -> S - 1 (shrink), S -> S + 1 (grow)

    def _resize(self, n_stages: int, profiles: Sequence[DeviceProfile]) -> None:
        """Relayout onto ``n_stages`` stages at the speed-weighted spans
        (``spans_from_profiles``) of ``profiles``, one a stage."""
        R = self.cfg.repeats
        if len(profiles) != n_stages:
            raise ValueError(f"got {len(profiles)} profiles for a {n_stages}-stage ring")
        if R < n_stages:
            raise ValueError(f"cannot run {n_stages} stages over {R} blocks")
        self._relayout(n_stages, spans_from_profiles(R, list(profiles)))

    def shrink(self, dead_stage: int, profiles: Sequence[DeviceProfile]) -> None:
        """Run on as S - 1 stages after stage ``dead_stage`` dies: its span
        goes to the survivors by their ``profiles`` (one a survivor). Nothing
        is lost: on one device every stage's layers are the executor's own
        tensors, so they are re-listed into the new stages as they are (no
        checkpoint is read), the boundary aligns down to the new span edges
        at the next round, and the cache re-captures."""
        if not 0 <= dead_stage < self.S:
            raise ValueError(f"dead_stage {dead_stage} out of range for S={self.S}")
        if self.S <= 1:
            raise RuntimeError("cannot shrink a 1-stage ring")
        self._resize(self.S - 1, profiles)

    def grow(self, profiles: Sequence[DeviceProfile]) -> None:
        """The inverse of ``shrink``: a device joins and S grows by one;
        ``profiles`` describe the whole fleet after the join. One device runs
        every stage, so no device count limits S."""
        self._resize(self.S + 1, profiles)

    def export_params(self, tenant: Optional[int] = None) -> Dict[str, Any]:
        """The flat parameter tree (views of the executor's tensors): with
        several tenants, tenant ``tenant``'s model (the shared trunk, its
        adapters and head), or with ``tenant=None`` the tenant-stacked tree."""
        t = None if tenant is None else self._tenant(tenant)
        stage_blocks = [[{**layer, "adapter": tenant_view(layer["adapter"], t)}
                         for layer in stage] for stage in self.stage_blocks]
        shared = {**self.shared, "head": tenant_view(self.shared["head"], t)}
        return pl.unstack(stage_blocks, self.cfg, self._params_rest, shared, spans=self.spans)

    # -- one tenant's set: an AdapterStore bundle's layout, in and out by copy

    def _tenant(self, tenant: int) -> Optional[int]:
        """``tenant`` as ``tenant_view`` takes it (None at one tenant), checked."""
        if not 0 <= tenant < self.T:
            raise ValueError(f"tenant {tenant} outside the executor's {self.T}")
        return None if self.T == 1 else tenant

    def _bundle(self, stage_tree, head, tenant: Optional[int]) -> Dict[str, Any]:
        """``{"adapter": [R, C, ...] tree, "head": head}`` (new tensors) from
        a tree in the stage layout and a head, tenant ``tenant``'s slice."""
        layers = [tenant_view(a, tenant) for stage in stage_tree for a in stage]
        ref = bridge.trainable_to_reference(layers, tree_map(
            lambda x: x.clone(), tenant_view(head, tenant)), self.cfg)
        (entry,) = ref["blocks"]
        return {"adapter": entry["adapter"], "head": ref["head"]}

    def _unbundle(self, bundle: Dict[str, Any], stage_tree, head,
                  tenant: Optional[int]) -> None:
        """Copy a bundle into tenant ``tenant``'s slice of a stage-layout tree
        and a head (in place: the graphs read these tensors)."""
        layers, src_head = bridge.trainable_from_reference(
            {"blocks": ({"adapter": bundle["adapter"]},), "head": bundle["head"]}, self.cfg)
        dst = [tenant_view(a, tenant) for stage in stage_tree for a in stage]
        bridge.copy_into(dst, layers)
        bridge.copy_into(tenant_view(head, tenant), src_head)

    def export_adapters(self, tenant: int = 0) -> Dict[str, Any]:
        """Tenant ``tenant``'s trainable set as ``{"adapter": [R, C, ...]
        tree, "head": head}``, the unit an ``AdapterStore`` keeps and the
        server grafts (new tensors)."""
        t = self._tenant(tenant)
        return self._bundle(self.stage_adapters(), self.shared["head"], t)

    def check_shared_trunk(self, tenant_layers: Sequence[List[Dict[str, Any]]],
                           step: int) -> None:
        """Raise unless every tenant's adapters (each a flat list of per-layer
        trees, bottom up) are equal in the stages frozen at ``step``'s
        boundary. Phase A runs those stages once, on tenant 0's adapters, so
        a joint round equals each tenant's solo round, and a cache row built
        for one tenant holds for the others, only while they are equal."""
        F = frozen_stage_count(self.spans, self.boundary_at(step))
        n = sum(len(stage) for stage in self.stage_blocks[:F])
        first, *rest = tenant_layers
        for other in rest:
            for x, y in zip(tree_leaves(first[:n]), tree_leaves(other[:n]), strict=True):
                if not torch.equal(x, torch.as_tensor(y).to(x)):
                    raise ValueError(
                        f"the tenants' adapters differ in the {F} stage(s) frozen at step "
                        f"{step}; tenants share the frozen trunk (Phase A runs it on tenant "
                        f"0's adapters), so only the rows above it may differ")

    def import_adapters(self, tenant: int, bundle: Dict[str, Any]) -> None:
        """Copy a bundle into tenant ``tenant``'s adapters and head, and free
        only that tenant's cache rows (all of them at one tenant): its
        stage-F inputs may differ now, the others' stay valid. With several
        tenants a bundle whose frozen rows differ from the other tenants' is
        refused (``check_shared_trunk``)."""
        t = self._tenant(tenant)
        if t is not None:
            layers, _ = bridge.trainable_from_reference(
                {"blocks": ({"adapter": bundle["adapter"]},), "head": bundle["head"]}, self.cfg)
            other = [tenant_view(a, 1 if t == 0 else 0)
                     for stage in self.stage_adapters() for a in stage]
            self.check_shared_trunk([other, layers], self.step)
        with torch.no_grad():
            self._unbundle(bundle, self.stage_adapters(), self.shared["head"], t)
        if self.cache is not None:
            if t is None:
                self.cache.invalidate()
            else:
                self.cache.invalidate_tenant(t)

    def export_tenant_opt(self, tenant: int = 0) -> Dict[str, Any]:
        """Tenant ``tenant``'s moments in the bundle's layout, and ``count``
        (the ring's, shared by its tenants)."""
        t = self._tenant(tenant)
        o = self.opt_state
        return {**{k: self._bundle(o[k]["adapter"], o[k]["head"], t) for k in ("m", "v")},
                "count": o["count"].clone()}

    def import_tenant_opt(self, tenant: int, opt: Dict[str, Any]) -> None:
        """Copy a tenant's moments in (the inverse of ``export_tenant_opt``);
        ``count`` is copied only at one tenant (with several it is the ring's)."""
        t = self._tenant(tenant)
        o = self.opt_state
        with torch.no_grad():
            for k in ("m", "v"):
                self._unbundle(opt[k], o[k]["adapter"], o[k]["head"], t)
            if t is None:
                o["count"].copy_(torch.as_tensor(opt["count"]))
