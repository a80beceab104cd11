"""The RingAda ring round on one device (the reference's ``core/pipeline.py``).

The reference maps the ring of S edge devices onto an SPMD mesh axis: stage
``u`` holds blocks ``spans[u]`` and ``ppermute`` hands activations to the next
stage. The port runs the S stages in one process on one GPU:

  * a stage is a view, the slice ``params["blocks"][b:e]`` of the per-layer
    dicts: nothing is copied into a stage-stacked tensor (at stablelm-3b the
    frozen weights alone are 5.2 GiB). The reference's padded ``[S,
    max_span, C, ...]`` layout (:func:`stack_entry`) exists for carrying its
    ring state across (``bridge.py``);
  * ``ppermute`` is the hand-off of a stage's output to the next stage's
    input buffer, and a (stage, tick) pair with no microbatch launches
    nothing. Each phase still records its ticks, the reference's tick
    ledger.

Ragged layouts (the heterogeneous ring, spans of different sizes) need no
padding here: a stage holds only its own blocks. So the reference's validity
mask (its ``_stage_valid``, which discards the padding rows' applications)
has no counterpart, and the tick counts stay in stage ticks as the
reference's do: a stage costs one tick per microbatch whatever its span.

One round (RingAda Algorithm 1, initiator ``owner``), in halves that the
fused executor (``core/executor.py``) calls directly:

  * :func:`gather_embeddings`: every owner's ``[M, mb, seq]`` microbatches
    embedded once (the embedding is outside the trainable set);
  * :func:`ring_phase_a`: the owner's microbatches through the F frozen
    stages under ``torch.no_grad`` (forward only), ``M + F - 1`` ticks, to the
    stage-F inputs ``h_B``; :func:`ring_phase_a_packed` runs every owner's
    stream back to back as one ``S*M + F - 1``-tick conveyor (slot ``o*M +
    m`` is owner o's microbatch m), which the frozen trunk allows because
    nothing it reads changes within a round;
  * :func:`ring_phase_b`: the S - F hot stages with autograd, whose backward
    stops at stage F (the terminator), the last stage's hand-off back to
    the owner (on one device, its own outputs), and the owner's loss, the
    plain fp32 mean of ``lse - gold`` over ``[M, mb, seq]``.

:func:`make_ring_round` composes them for one static owner, the form the
oracle ``RingTrainer`` runs. Only the hot adapters and the head take
gradients; the frozen weights of hot layers need none, so autograd forms
only input gradients through them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch.configs.base import ModelConfig
from repro_torch.core.partition import (Span, frozen_stage_count, normalize_spans,
                                        span_sizes, uniform_assignment)
from repro_torch.models import transformer as tfm
from repro_torch.models.blocks import BlockCtx, apply_block

Record = Optional[Callable[[int], None]]


# ---------------------------------------------------------------- geometry


def is_ragged(spans: Sequence[Span]) -> bool:
    return len(set(span_sizes(spans))) > 1


def resolve_spans(n_blocks: int, n_stages: int,
                  spans: Optional[Sequence[Span]] = None) -> Tuple[Span, ...]:
    """The given layout (``(begin, end)`` pairs or sizes such as ``[4, 5, 2,
    3]``), validated against the model, or the balanced default (ragged where
    S does not divide the block count)."""
    if spans is None:
        spans = uniform_assignment(n_blocks, n_stages)
    spans = normalize_spans(spans, n_blocks)
    if len(spans) != n_stages:
        raise ValueError(f"span layout {list(spans)} has {len(spans)} stages, the ring has "
                         f"{n_stages}")
    return spans


def span_maps(spans: Sequence[Span]) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Index maps between the flat ``[R, ...]`` block stack and the padded
    ``[S, max_span, ...]`` stage stack: ``stack_idx [S, max_span]`` (the block
    feeding row (u, j); padding rows repeat the stage's last block), ``valid
    [S, max_span]``, ``stage_of [R]`` and ``slot_of [R]``."""
    sizes = span_sizes(spans)
    S, mx = len(spans), max(sizes)
    R = spans[-1][1]
    stack_idx = np.zeros((S, mx), np.int32)
    valid = np.zeros((S, mx), bool)
    stage_of = np.zeros(R, np.int32)
    slot_of = np.zeros(R, np.int32)
    for u, (b, e) in enumerate(spans):
        n = e - b
        stack_idx[u, :n] = np.arange(b, e)
        stack_idx[u, n:] = e - 1
        valid[u, :n] = True
        stage_of[b:e] = u
        slot_of[b:e] = np.arange(n)
    return stack_idx, valid, stage_of, slot_of


def _take(x: Any, idx: Tuple[np.ndarray, ...], leading: int = 0) -> Any:
    """``x[:, ..., idx]`` (``leading`` axes passed through) for a numpy array
    or a tensor (the index moved to its device)."""
    lead = (slice(None),) * leading
    if isinstance(x, torch.Tensor):
        return x[lead + tuple(torch.as_tensor(i, dtype=torch.long, device=x.device)
                              for i in idx)]
    return np.asarray(x)[lead + tuple(idx)]


def stack_entry(entry: Any, spans: Sequence[Span], *, leading: int = 0) -> Any:
    """Flat block-entry tree (leaves ``[R, C, ...]``, numpy or torch) -> the
    reference's padded stage stack (leaves ``[S, max_span, C, ...]``): a
    reshape for uniform layouts, a gather through :func:`span_maps` for
    ragged ones, whose padding rows repeat the stage's last block.
    ``leading`` axes before the block axis pass through: the tenant-major
    ``[T, R, C, ...]`` trees stack with ``leading=1`` to ``[T, S, max_span,
    C, ...]``."""
    if not is_ragged(spans):
        S, lps = len(spans), span_sizes(spans)[0]
        return tree_map(lambda x: x.reshape(tuple(x.shape[:leading]) + (S, lps)
                                            + tuple(x.shape[leading + 1:])), entry)
    stack_idx = span_maps(spans)[0]
    return tree_map(lambda x: _take(x, (stack_idx,), leading), entry)


def unstack_entry(stacked: Any, spans: Sequence[Span], *, leading: int = 0) -> Any:
    """Inverse of :func:`stack_entry` (the padding rows dropped; ``leading``
    as there)."""
    R = spans[-1][1]
    if not is_ragged(spans):
        return tree_map(lambda x: x.reshape(tuple(x.shape[:leading]) + (R,)
                                            + tuple(x.shape[leading + 2:])), stacked)
    _, _, stage_of, slot_of = span_maps(spans)
    return tree_map(lambda x: _take(x, (stage_of, slot_of), leading), stacked)


def _check_ring(cfg: ModelConfig) -> None:
    """A stage applies the pattern's first block kind to every layer (as the
    reference's ``_apply_stage_layers`` does), so a pattern of several
    entries (llama4's dense and moe layers) has no ring."""
    if len(cfg.pattern) != 1:
        raise ValueError(f"{cfg.name}: the ring needs a uniform layer pattern (every stage "
                         f"applies one block kind to every layer), got {cfg.pattern}")


def stage_stack(params: Dict[str, Any], cfg: ModelConfig, n_stages: int, *,
                spans: Optional[Sequence[Span]] = None
                ) -> Tuple[List[List[Dict[str, Any]]], Dict[str, Any]]:
    """Split params into (stage_blocks, shared): ``stage_blocks[u]`` is the list
    slice of the per-layer dicts of stage u's repeats (views, nothing copied);
    ``shared`` the embedding, final norm and head, which every stage keeps."""
    _check_ring(cfg)
    spans = resolve_spans(cfg.repeats, n_stages, spans)
    per = cfg.layers_per_repeat
    stage_blocks = [params["blocks"][b * per:e * per] for b, e in spans]
    shared = {k: v for k, v in params.items() if k != "blocks"}
    return stage_blocks, shared


def unstack(stage_blocks: Sequence[Sequence[Dict[str, Any]]], cfg: ModelConfig,
            params: Dict[str, Any], shared: Dict[str, Any], *,
            spans: Optional[Sequence[Span]] = None) -> Dict[str, Any]:
    """Inverse of :func:`stage_stack`: the flat parameter tree."""
    spans = resolve_spans(cfg.repeats, len(stage_blocks), spans)
    per = cfg.layers_per_repeat
    for (b, e), stage in zip(spans, stage_blocks):
        if len(stage) != (e - b) * per:
            raise ValueError(f"stage of span ({b}, {e}) holds {len(stage)} layers, not "
                             f"{(e - b) * per}")
    return {**params, **shared, "blocks": [layer for stage in stage_blocks for layer in stage]}


# ---------------------------------------------------------------- the round


def _apply_stage_layers(cfg: ModelConfig, stage: Sequence[Dict[str, Any]], h: torch.Tensor,
                        ctx: BlockCtx) -> torch.Tensor:
    """This stage's blocks, in order, on h [mb, seq, D]."""
    kind = cfg.pattern[0][0]
    for layer in stage:
        h, _, _ = apply_block(kind, cfg, layer, h, ctx)
    return h


def _tick_phase(cfg: ModelConfig, stages: Sequence[Sequence[Dict[str, Any]]],
                h_inject: Sequence[torch.Tensor], first: int, depth: int, ctx: BlockCtx,
                record: Record = None) -> List[torch.Tensor]:
    """Tick pipeline over stages ``[first, first + depth)``: at tick t stage
    ``first + rel`` runs microbatch ``t - rel`` and hands its output to the next
    stage's input buffer. Returns the outputs of the last stage, in order.
    ``record`` is called with the phase's tick count."""
    M = len(h_inject)
    T = M + depth - 1
    if record is not None:
        record(T)
    inbox: List[Optional[torch.Tensor]] = [None] * depth
    outs: List[Optional[torch.Tensor]] = [None] * M
    for t in range(T):
        handed: List[Optional[torch.Tensor]] = [None] * depth
        for rel in range(depth):
            m = t - rel
            if not 0 <= m < M:
                continue                    # an inactive (stage, tick): nothing runs
            x = h_inject[m] if rel == 0 else inbox[rel]
            y = _apply_stage_layers(cfg, stages[first + rel], x, ctx)
            if rel + 1 < depth:
                handed[rel + 1] = y
            else:
                outs[m] = y
        inbox = handed
    return outs


def _hot_stages(stage_blocks, adapters, first: int):
    """The stages from ``first`` up with their adapters taken from ``adapters``
    (one list of adapter dicts per hot stage)."""
    return list(stage_blocks[:first]) + [
        [{**layer, "adapter": a} for layer, a in zip(stage, stage_ads)]
        for stage, stage_ads in zip(stage_blocks[first:], adapters)]


def _ring_geometry(cfg: ModelConfig, n_stages: int, boundary: int,
                   spans: Optional[Sequence[Span]]) -> Tuple[Tuple[Span, ...], int]:
    """(the layout, F frozen stages) for a span-aligned boundary."""
    _check_ring(cfg)
    spans = resolve_spans(cfg.repeats, n_stages, spans)
    return spans, frozen_stage_count(spans, boundary)


def _seq_ctx(cfg: ModelConfig, h: torch.Tensor, impl: str) -> BlockCtx:
    """The blocks' context for microbatches of h's ``[mb, seq]``."""
    mb, seq = h.shape[-3], h.shape[-2]
    pos = torch.arange(seq, device=h.device).expand(mb, seq)
    return BlockCtx(cfg=cfg, mode="seq", positions=pos, impl=impl)


def gather_embeddings(cfg: ModelConfig, shared: Dict[str, Any],
                      tokens: torch.Tensor) -> torch.Tensor:
    """Every owner's microbatches embedded once: tokens ``[S, M, mb, seq]`` ->
    ``[S, M, mb, seq, D]``, without gradient (the embedding is not trained,
    so it is the same for every owner iteration of a round)."""
    mb, seq = tokens.shape[-2:]
    pos = torch.arange(seq, device=tokens.device).expand(mb, seq)
    with torch.no_grad():
        return tfm.embed(cfg, shared, tokens, pos)


def ring_phase_a(cfg: ModelConfig, *, n_stages: int, boundary: int, n_micro: int,
                 spans: Optional[Sequence[Span]] = None, record: Record = None,
                 impl: str = "kernel") -> Callable:
    """Phase A for one owner: ``fn(stage_blocks, emb) -> h_B``, from the
    owner's embedded microbatches ``emb`` [M, mb, seq, D] to the M inputs of
    stage F (at F = 0, the embeddings themselves), under ``torch.no_grad``.
    ``record`` receives the phase's ``M + F - 1`` ticks (none at F = 0)."""
    _, F = _ring_geometry(cfg, n_stages, boundary, spans)

    def phase_a(stage_blocks, emb):
        if len(emb) != n_micro:
            raise ValueError(f"{len(emb)} microbatches, the round was built for {n_micro}")
        h = list(emb)
        if F == 0:
            return h
        with torch.no_grad():
            return _tick_phase(cfg, stage_blocks, h, 0, F, _seq_ctx(cfg, h[0], impl), record)

    return phase_a


def ring_phase_a_packed(cfg: ModelConfig, *, n_stages: int, boundary: int, n_micro: int,
                        spans: Optional[Sequence[Span]] = None, record: Record = None,
                        impl: str = "kernel", n_tenants: int = 1) -> Callable:
    """Phase A for every owner at once: ``fn(stage_blocks, emb_g) -> h_B_all``,
    from ``gather_embeddings``' ``[S, M, mb, seq, D]`` to a list over owners of
    each owner's M stage-F inputs. One ``S*M + F - 1``-tick conveyor in
    owner-major slot order ``o*M + m`` instead of S pipelines of ``M + F - 1``
    ticks: it saves ``(S - 1)(F - 1)`` fill and drain ticks a round. Each
    microbatch meets the same operations as in :func:`ring_phase_a`, so owner
    o's slice is that function's result for owner o.

    ``n_tenants=T > 1``: ``emb_g`` is ``[S, T, M, mb, seq, D]`` and one
    ``T*S*M + F - 1``-tick conveyor carries every tenant's round in
    tenant-major slot order ``t*S*M + o*M + m``; ``h_B_all[o][t]`` is tenant
    t's owner o. The frozen stages are the same bits for every tenant (they
    start from one init and are never updated), so ``stage_blocks`` holds
    any one tenant's adapters, and each microbatch still meets its solo
    run's operations on its solo run's shapes."""
    _, F = _ring_geometry(cfg, n_stages, boundary, spans)
    S, M, T = n_stages, n_micro, n_tenants
    lead = (S, M) if T == 1 else (S, T, M)

    def phase_a_packed(stage_blocks, emb_g):
        if tuple(emb_g.shape[:len(lead)]) != lead:
            raise ValueError(f"embeddings {tuple(emb_g.shape)}, the round was built for "
                             f"[{', '.join(map(str, lead))}, ...]")
        e = emb_g[:, None] if T == 1 else emb_g
        stream = [e[o, t, m] for t in range(T) for o in range(S) for m in range(M)]
        if F > 0:
            with torch.no_grad():
                stream = _tick_phase(cfg, stage_blocks, stream, 0, F,
                                     _seq_ctx(cfg, stream[0], impl), record)
        at = lambda t, o: stream[(t * S + o) * M:(t * S + o + 1) * M]
        if T == 1:
            return [at(0, o) for o in range(S)]
        return [[at(t, o) for t in range(T)] for o in range(S)]

    return phase_a_packed


def ring_phase_b(cfg: ModelConfig, *, n_stages: int, boundary: int, n_micro: int,
                 spans: Optional[Sequence[Span]] = None, record: Record = None,
                 impl: str = "kernel") -> Callable:
    """Phase B: ``fn(stage_blocks, shared, h_B, labels) -> loss``, the hot
    stages ``[F, S)`` on the M stage-F inputs ``h_B`` with autograd (for
    whatever leaves of the hot stages and the head require a gradient), then
    the owner's loss on its ``labels`` [M, mb, seq]: the fp32 mean of ``lse -
    gold``, with no mask. ``record`` receives the phase's ``M + S - F - 1``
    ticks."""
    _, F = _ring_geometry(cfg, n_stages, boundary, spans)

    def phase_b(stage_blocks, shared, h_B, labels):
        outs = _tick_phase(cfg, stage_blocks, h_B, F, n_stages - F,
                           _seq_ctx(cfg, h_B[0], impl), record)
        terms = []
        for m, hm in enumerate(outs):
            lf = tfm.head(cfg, shared, hm).float()
            lse = torch.logsumexp(lf, dim=-1)
            gold = torch.gather(lf, -1, labels[m][..., None])[..., 0]
            terms.append(lse - gold)
        return torch.stack(terms).mean()

    return phase_b


def make_ring_round(cfg: ModelConfig, *, n_stages: int, owner: int, boundary: int,
                    n_micro: int, spans: Optional[Sequence[Span]] = None,
                    impl: str = "kernel") -> Callable:
    """Build ``loss_fn(stage_blocks, shared, tokens, labels, record=None) -> loss``.

    Static per build: (owner, boundary, spans); ``boundary`` (frozen repeats
    from the bottom) must fall on a span edge. ``tokens`` / ``labels``:
    ``[S, M, mb, seq]`` int64 tensors, every client's local data; the round
    reads the owner's. ``record(phase, ticks)``, if given, receives each
    phase's tick count ("a" for Phase A, "b" for Phase B). Gradients flow to
    whatever leaves of the hot stages and the head require them. ``impl``:
    the blocks' kernels ("kernel") or their plain versions ("plain").
    """
    _ring_geometry(cfg, n_stages, boundary, spans)
    if not 0 <= owner < n_stages:
        raise ValueError(f"owner {owner} outside the ring of {n_stages}")
    geometry = dict(n_stages=n_stages, boundary=boundary, n_micro=n_micro, spans=spans,
                    impl=impl)

    def round_fn(stage_blocks, shared, tokens, labels, record=None):
        rec = (lambda phase: None) if record is None else (
            lambda phase: lambda ticks: record(phase, ticks))
        phase_a = ring_phase_a(cfg, record=rec("a"), **geometry)
        phase_b = ring_phase_b(cfg, record=rec("b"), **geometry)
        # 1. the owner embeds; 2. Phase A: the frozen trunk, forward only
        h_B = phase_a(stage_blocks, gather_embeddings(cfg, shared, tokens[owner]))
        # === the early-stop point: no gradient flows below stage F ===
        # 3. Phase B: the hot stages, with autograd; 4. the owner's loss
        return phase_b(stage_blocks, shared, h_B, labels[owner])

    return round_fn


def make_ring_train_round(cfg: ModelConfig, *, n_stages: int, owner: int, boundary: int,
                          n_micro: int, spans: Optional[Sequence[Span]] = None,
                          impl: str = "kernel") -> Callable:
    """Returns ``fn(stage_blocks, shared, tokens, labels, record=None) -> (loss,
    (adapter_grads, head_grads))``. ``adapter_grads`` is in the stage layout (a
    list per stage of one adapter dict per layer); the frozen stages' are
    exact zeros, and no backward runs for them."""
    spans = resolve_spans(cfg.repeats, n_stages, spans)
    F = frozen_stage_count(spans, boundary)
    loss_fn = make_ring_round(cfg, n_stages=n_stages, owner=owner, boundary=boundary,
                              n_micro=n_micro, spans=spans, impl=impl)

    def train_round(stage_blocks, shared, tokens, labels, record=None):
        leaf = lambda t: t.detach().requires_grad_(True)
        hot = [[tree_map(leaf, layer["adapter"]) for layer in stage]
               for stage in stage_blocks[F:]]
        head = tree_map(leaf, shared["head"])
        with torch.enable_grad():
            loss = loss_fn(_hot_stages(stage_blocks, hot, F), {**shared, "head": head},
                           tokens, labels, record)
            flat = [t for stage in hot for a in stage for t in a.values()] + list(head.values())
            grads = iter(torch.autograd.grad(loss, flat))
        hot_grads = [[{k: next(grads) for k in a} for a in stage] for stage in hot]
        head_grads = {k: next(grads) for k in head}
        frozen = [[tree_map(torch.zeros_like, layer["adapter"]) for layer in stage]
                  for stage in stage_blocks[:F]]
        return loss.detach(), (frozen + hot_grads, head_grads)

    return train_round


def pipeline_tick_counts(n_stages: int, n_micro: int, boundary: int,
                         lps: Optional[int] = None, *, cached: bool = False,
                         packed: bool = False,
                         spans: Optional[Sequence[Span]] = None) -> Dict[str, int]:
    """Tick counts of a round, in stage ticks. Per owner iteration: Phase A
    ``M + F - 1`` ticks (none when F = 0, or when ``packed`` hoists it out of
    the iteration), Phase B ``M + S_hot - 1`` forward and as many backward.
    ``phase_a_round_ticks`` is the round's Phase-A total, ``S (M + F - 1)``
    per owner or ``S M + F - 1`` packed; ``phase_a_saved_ticks`` the packed
    conveyor's saving, ``(S - 1)(F - 1)``. ``cached``: the activation
    cache's hit, where Phase A vanishes (``fwd_ticks`` ``M + S_hot - 1``, no
    Phase-A ticks, nothing saved by packing). Pass ``lps`` (uniform layouts,
    ``F = boundary // lps``) or ``spans`` (any layout)."""
    if spans is not None:
        spans = normalize_spans(spans)
        assert lps is None or lps * n_stages == spans[-1][1], \
            "pass lps or spans, not disagreeing both"
        F = frozen_stage_count(spans, boundary)
    else:
        assert lps is not None, "pass lps or spans"
        F = boundary // lps
    S_hot = n_stages - F
    phase_a = 0 if (cached or packed or F == 0) else n_micro + F - 1
    if cached or F == 0:
        a_round = 0
    elif packed:
        a_round = n_stages * n_micro + F - 1
    else:
        a_round = n_stages * (n_micro + F - 1)
    return {"fwd_ticks": phase_a + n_micro + S_hot - 1,
            "bwd_ticks": n_micro + S_hot - 1,
            "frozen_stages": F,
            "hot_stages": S_hot,
            "phase_a_round_ticks": a_round,
            "phase_a_saved_ticks": (n_stages - 1) * (F - 1)
            if packed and not cached and F > 0 else 0}
