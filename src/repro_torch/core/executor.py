"""RingExecutor: the fused RingAda round (the reference's ``core/executor.py``,
one tenant).

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
``repartition`` flushes it (``set_layout``).

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

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import actcache
from repro_torch.core import pipeline as pl
from repro_torch.core.actcache import ActivationCache
from repro_torch.core.partition import Span, align_boundary, frozen_stage_count
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


def make_fused_round(cfg: ModelConfig, tc: TrainConfig, *, n_stages: int, boundary: int,
                     n_micro: int, packed: bool = True,
                     spans: Optional[Sequence[Span]] = None,
                     tick_record: Optional[Callable[[str, int], None]] = None,
                     mode: str = "direct", cache_dtype: str = "native",
                     cache_src_dtype: Optional[torch.dtype] = None) -> Callable:
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
    or "phase_b"), as it runs."""
    if mode not in FUSED_MODES:
        raise ValueError(f"mode must be one of {FUSED_MODES}, got {mode!r}")
    spans = pl.resolve_spans(cfg.repeats, n_stages, spans)
    F = frozen_stage_count(spans, boundary)
    rec = tick_record or (lambda phase, ticks: None)
    geometry = dict(n_stages=n_stages, boundary=boundary, n_micro=n_micro, spans=spans)
    phase_a = pl.ring_phase_a(cfg, record=lambda t: rec("phase_a", t), **geometry)
    phase_a_packed = pl.ring_phase_a_packed(cfg, record=lambda t: rec("phase_a_packed", t),
                                            **geometry)
    phase_b = pl.ring_phase_b(cfg, record=lambda t: rec("phase_b", t), **geometry)
    use_packed = packed and F >= 2       # at F <= 1 the conveyor saves no tick
    lr = tc.learning_rate
    out_dtype = cache_src_dtype if cache_src_dtype is not None else prm.DTYPES[cfg.dtype]

    def update(g, m, v, p):
        m2, v2, p2 = adamw.leaf_update(g, m, v, p, lr=lr, tc=tc)
        m.copy_(m2)
        v.copy_(v2)
        p.copy_(p2)

    def train_owners(stage_blocks, shared, opt_state, h_of, labels):
        """Each owner's Phase B on ``h_of(owner)`` (its M stage-F inputs) and
        the raw AdamW update, in owner order."""
        leaf = lambda t: t.detach().requires_grad_(True)
        m, v = opt_state["m"], opt_state["v"]
        losses = []
        for owner in range(n_stages):
            h_B = h_of(owner)
            hot = [[tree_map(leaf, layer["adapter"]) for layer in stage]
                   for stage in stage_blocks[F:]]
            head = tree_map(leaf, shared["head"])
            with torch.enable_grad():
                loss = phase_b(pl._hot_stages(stage_blocks, hot, F), {**shared, "head": head},
                               h_B, labels[owner])
                flat = [t for stage in hot for a in stage for t in a.values()] + \
                    list(head.values())
                grads = iter(torch.autograd.grad(loss, flat))
            with torch.no_grad():
                for u in range(F, n_stages):
                    for j, layer in enumerate(stage_blocks[u]):
                        a = layer["adapter"]
                        for k in a:
                            update(next(grads), m["adapter"][u][j][k], v["adapter"][u][j][k],
                                   a[k])
                for k, p in shared["head"].items():
                    update(next(grads), m["head"][k], v["head"][k], p)
            losses.append(loss.detach())
        with torch.no_grad():
            opt_state["count"].add_(n_stages)
            losses = torch.stack(losses)
            return losses, losses.mean()

    if mode == "cached":
        def cached(stage_blocks, shared, opt_state, cache_buf, cache_scales, row, labels):
            with torch.no_grad():
                h = actcache.read_row(cache_buf, cache_scales, row, cache_dtype, out_dtype)
            return train_owners(stage_blocks, shared, opt_state, lambda o: list(h[o]), labels)

        return cached

    def fused(stage_blocks, shared, opt_state, tokens, labels, cache_buf=None,
              cache_scales=None, row=None):
        emb_g = pl.gather_embeddings(cfg, shared, tokens)
        h_all = phase_a_packed(stage_blocks, emb_g) if use_packed else None
        entry = []

        def h_of(owner):
            h_B = h_all[owner] if use_packed else phase_a(stage_blocks, emb_g[owner])
            if mode == "capture":
                entry.append(torch.stack(h_B))
            return h_B

        out = train_owners(stage_blocks, shared, opt_state, h_of, labels)
        if mode == "capture":
            with torch.no_grad():
                actcache.write_row(cache_buf, cache_scales, row, torch.stack(entry), cache_dtype)
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
    """

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, params: Dict[str, Any],
                 n_stages: int, n_micro: int, *, schedule=None, packed: bool = True,
                 spans: Optional[Sequence[Span]] = None, cache_capacity: int = 0,
                 cache_dtype: str = "native"):
        self.cfg, self.tc, self.packed = cfg, tc, packed
        self.S, self.M = n_stages, n_micro
        self.spans = pl.resolve_spans(cfg.repeats, n_stages, spans)
        self.lps = None if pl.is_ragged(self.spans) else cfg.repeats // n_stages
        stage_blocks, shared = pl.stage_stack(params, cfg, n_stages, spans=self.spans)
        own = lambda t: t.detach().clone()
        self.stage_blocks = [[{**layer, "adapter": tree_map(own, layer["adapter"])}
                              for layer in stage] for stage in stage_blocks]
        self.shared = {**shared, "head": tree_map(own, shared["head"])}
        self._params_rest = {k: v for k, v in params.items() if k != "blocks"}
        self.opt_state = ring_opt_init(self.stage_adapters(), self.shared["head"])
        self.sched = schedule if schedule is not None else UnfreezeSchedule.from_train_config(tc)
        self.device = self.shared["head"]["w"].device
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
        """The adapters in the stage layout: a list per stage of one dict per layer."""
        return [[layer["adapter"] for layer in stage] for stage in self.stage_blocks]

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
                              else self.cache.src_dtype)
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
        device tensor holding the cache row, as the mode takes them."""
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
        S_stage axis: module docstring of ``core/actcache.py``)."""
        _, M, mb, seq = labels.shape
        return (self.S, M, mb, seq, self.cfg.d_model)

    def round(self, tokens, labels, *, slot: Optional[int] = None) -> Dict[str, Any]:
        """One training round: every client is the initiator once.

        tokens / labels: [S, M, mb, seq], each client's local data. ``slot``:
        a stable batch-slot id (the same slot holds the same examples every
        epoch: ``RingBatcher.next_slot``), the cache's key with the boundary.
        On a hit the ``cached`` round runs, on a miss the ``capture`` round
        (its row taken before it runs); a batch that does not fit the buffer
        bypasses the cache, as ``slot=None`` does. Returns the losses of the
        S owner iterations and their mean (device tensors), the round's
        boundary, the step count, ``cache_hit`` and, with a cache, its
        ``stats()``.
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
                key = (slot, boundary)
                row = self.cache.index_of(key)
                if row is not None:
                    mode = "cached"
                else:
                    # put's bookkeeping before the round: the capture writes the row
                    row = self.cache.reserve(key, shape, self.shared["embed"]["tok"].dtype)
                    mode = "capture"
        losses, mean = self._round_fn(boundary, mode, tokens, labels, row)(tokens, labels, row)
        self.step += self.S
        out = {"loss": mean, "losses": losses, "boundary": boundary, "step": self.step,
               "cache_hit": mode == "cached"}
        if self.cache is not None:
            out.update(self.cache.stats())
        return out

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
        if new == self.spans:
            return
        per = self.cfg.layers_per_repeat
        restage = lambda stages: [[x for stage in stages for x in stage][b * per:e * per]
                                  for b, e in new]
        self.stage_blocks = restage(self.stage_blocks)
        for name in ("m", "v"):
            self.opt_state[name]["adapter"] = restage(self.opt_state[name]["adapter"])
        self.spans = new
        self.lps = None if pl.is_ragged(new) else self.cfg.repeats // self.S
        self._rounds.clear()
        self.tick_scan_lens.clear()
        if self.cache is not None:
            self.cache.set_layout(new)
        self._last_boundary = None

    def export_params(self) -> Dict[str, Any]:
        """The flat parameter tree (views of the executor's tensors)."""
        return pl.unstack(self.stage_blocks, self.cfg, self._params_rest, self.shared,
                          spans=self.spans)
