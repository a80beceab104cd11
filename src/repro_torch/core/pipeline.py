"""The RingAda ring round on one device (the reference's ``core/pipeline.py``,
uniform span layouts).

The reference maps the ring of S edge devices onto an SPMD mesh axis: stage
``u`` holds blocks ``spans[u]`` and ``ppermute`` hands activations to the next
stage. The port runs the S stages in one process on one GPU:

  * a stage is a view, the slice ``params["blocks"][b:e]`` of the per-layer
    dicts: nothing is copied into a stage-stacked tensor (at stablelm-3b the
    frozen weights alone are 5.2 GiB). The stacked ``[S, lps, C, ...]``
    layout (:func:`stack_entry`) exists for carrying the reference's ring
    state across (``bridge.py``);
  * ``ppermute`` is the hand-off of a stage's output to the next stage's
    input buffer, and a (stage, tick) pair with no microbatch launches
    nothing. Each phase still records its ``M + depth - 1`` ticks, the
    reference's tick ledger.

One round (RingAda Algorithm 1, initiator ``owner``): the owner embeds its
``[M, mb, seq]`` microbatches; Phase A streams them through the F frozen
stages under ``torch.no_grad`` (forward only) and detaches the result; Phase
B runs the S - F hot stages with autograd, whose backward stops at stage F
(the terminator); the owner's loss is the plain fp32 mean of ``lse - gold``
over ``[M, mb, seq]``. Only the hot adapters and the head take gradients;
the frozen weights of hot layers need none, so autograd forms only input
gradients through them.

Ragged layouts (the heterogeneous ring) raise: ROADMAP.md Queue 1, item 3b.
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

RAGGED_LATER = ("ragged span layouts are not ported yet (ROADMAP.md Queue 1, item 3b: "
                "the heterogeneous ring)")


# ---------------------------------------------------------------- geometry


def is_ragged(spans: Sequence[Span]) -> bool:
    return len(set(span_sizes(spans))) > 1


def resolve_spans(n_blocks: int, n_stages: int,
                  spans: Optional[Sequence[Span]] = None) -> Tuple[Span, ...]:
    """The given layout, validated against the model, or the balanced default;
    a ragged one raises (including the default when S does not divide the
    block count)."""
    if spans is None:
        spans = uniform_assignment(n_blocks, n_stages)
    spans = normalize_spans(spans, n_blocks)
    if len(spans) != n_stages:
        raise ValueError(f"span layout {list(spans)} has {len(spans)} stages, the ring has "
                         f"{n_stages}")
    if is_ragged(spans):
        raise NotImplementedError(f"{RAGGED_LATER}: {list(spans)}")
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


def stack_entry(entry: Any, spans: Sequence[Span]) -> Any:
    """Flat block-entry tree (leaves ``[R, C, ...]``, numpy or torch) -> the
    stage stack (leaves ``[S, lps, C, ...]``), a reshape."""
    if is_ragged(spans):
        raise NotImplementedError(f"{RAGGED_LATER}: {list(spans)}")
    S, lps = len(spans), span_sizes(spans)[0]
    return tree_map(lambda x: x.reshape((S, lps) + tuple(x.shape[1:])), entry)


def unstack_entry(stacked: Any, spans: Sequence[Span]) -> Any:
    """Inverse of :func:`stack_entry`."""
    if is_ragged(spans):
        raise NotImplementedError(f"{RAGGED_LATER}: {list(spans)}")
    return tree_map(lambda x: x.reshape((spans[-1][1],) + tuple(x.shape[2:])), stacked)


def _check_ring(cfg: ModelConfig) -> None:
    if len(cfg.pattern) != 1:
        raise ValueError(f"{cfg.name}: the ring needs a uniform layer pattern, got {cfg.pattern}")


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
    """This stage's blocks, in order, on h [mb, seq, D] (uniform layouts)."""
    kind = cfg.pattern[0][0]
    for layer in stage:
        h, _ = apply_block(kind, cfg, layer, h, ctx)
    return h


def _tick_phase(cfg: ModelConfig, stages: Sequence[Sequence[Dict[str, Any]]],
                h_inject: Sequence[torch.Tensor], first: int, depth: int, ctx: BlockCtx,
                record: Optional[Callable[[int], None]] = None) -> List[torch.Tensor]:
    """Tick pipeline over stages ``[first, first + depth)``: at tick t stage
    ``first + rel`` runs microbatch ``t - rel`` and hands its output to the next
    stage's input buffer. Returns the M outputs of the last stage, in order.
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
    _check_ring(cfg)
    spans = resolve_spans(cfg.repeats, n_stages, spans)
    F = frozen_stage_count(spans, boundary)
    S_hot = n_stages - F
    if not 0 <= owner < n_stages:
        raise ValueError(f"owner {owner} outside the ring of {n_stages}")

    def round_fn(stage_blocks, shared, tokens, labels, record=None):
        my_tokens, my_labels = tokens[owner], labels[owner]          # [M, mb, seq]
        if my_tokens.shape[0] != n_micro:
            raise ValueError(f"{my_tokens.shape[0]} microbatches, the round was built for "
                             f"{n_micro}")
        mb, seq = my_tokens.shape[1], my_tokens.shape[2]
        pos = torch.arange(seq, device=my_tokens.device).expand(mb, seq)
        ctx = BlockCtx(cfg=cfg, mode="seq", positions=pos, impl=impl)
        rec = (lambda phase: None) if record is None else (
            lambda phase: lambda ticks: record(phase, ticks))

        # 1. the owner embeds; 2. Phase A: the frozen trunk, forward only
        with torch.no_grad():
            h = [tfm.embed(cfg, shared, my_tokens[m], pos) for m in range(n_micro)]
            if F > 0:
                h = _tick_phase(cfg, stage_blocks, h, 0, F, ctx, rec("a"))
        # === the early-stop point: no gradient flows below stage F ===
        h = [x.detach() for x in h]
        # 3. Phase B: the hot stages, with autograd
        outs = _tick_phase(cfg, stage_blocks, h, F, S_hot, ctx, rec("b"))
        # 4. back at the owner: the loss on its own labels, fp32, no mask
        terms = []
        for m, hm in enumerate(outs):
            lf = tfm.head(cfg, shared, hm).float()
            lse = torch.logsumexp(lf, dim=-1)
            gold = torch.gather(lf, -1, my_labels[m][..., None])[..., 0]
            terms.append(lse - gold)
        return torch.stack(terms).mean()

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
    """Tick counts of one owner iteration, unpacked and uncached: Phase A
    ``M + F - 1`` ticks (none when F = 0), Phase B ``M + S_hot - 1`` forward
    and as many backward. ``phase_a_round_ticks`` is the round's Phase-A
    total, ``S (M + F - 1)``. Pass ``lps`` (``F = boundary // lps``) or a
    uniform ``spans`` layout."""
    if packed:
        raise NotImplementedError("the packed Phase-A conveyor is not ported yet (ROADMAP.md "
                                  "Queue 1, item 4: the fused executor)")
    if cached:
        raise NotImplementedError("the frozen-trunk activation cache is not ported yet "
                                  "(ROADMAP.md Queue 1, item 5)")
    if spans is not None:
        spans = normalize_spans(spans)
        if is_ragged(spans):
            raise NotImplementedError(f"{RAGGED_LATER}: {list(spans)}")
        assert lps is None or lps * n_stages == spans[-1][1], \
            "pass lps or spans, not disagreeing both"
        F = frozen_stage_count(spans, boundary)
    else:
        assert lps is not None, "pass lps or spans"
        F = boundary // lps
    S_hot = n_stages - F
    phase_a = 0 if F == 0 else n_micro + F - 1
    return {"fwd_ticks": phase_a + n_micro + S_hot - 1,
            "bwd_ticks": n_micro + S_hot - 1,
            "frozen_stages": F,
            "hot_stages": S_hot,
            "phase_a_round_ticks": n_stages * phase_a,
            "phase_a_saved_ticks": 0}
