"""Weights and optimizer state carried between the JAX package's layout and
the port's, both ways.

The reference stacks each layer-pattern entry's leaves as ``[repeats, count,
...]`` (``blocks`` is a tuple aligned with ``cfg.pattern``); the port keeps one
dict per layer. The stacking and unstacking happen here and nowhere else.

Arrays on the JAX side are numpy (``np.asarray`` of a JAX array). bf16 crosses
through a 16-bit integer view, as the reference's checkpoints store it, so
this module needs no JAX and no ``ml_dtypes`` import: on the way back a bf16
leaf comes out as that view, or as the numpy dtype the caller passes
(``bf16=jnp.bfloat16``).

The ring's state crosses the same way, on any span layout: ``RingTrainer``'s
(the adapters and their moments in the stage layout, the head and its
moments) and ``RingExecutor``'s (the same, with the step count, in the
reference executor's ``opt_state`` tree). The reference's padded ``[S,
max_span, C, ...]`` stage stack is made here from the flat ``[R, C, ...]``
one (``core/pipeline.stack_entry``; a ragged layout's padding rows repeat
the stage's last block and are dropped on the way back).

The session's checkpoints (``api/session.py``) hold the trainable set and
the moments in the reference's layout too, but as tensors
(``trainable_to_reference``, ``ring_opt_to_reference``,
``opt_state_to_reference`` and their inverses), so that a file written by
either package restores in the other. A multi-tenant ring's state (every
leaf ``[T, ...]``) crosses as the reference's tenant-stacked tree
(``ring_state_to_reference``): adapters ``[T, R, C, ...]``, the head
``[T, ...]``, the adapters' moments ``[S, T, max_span, C, ...]``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch import device as dev_rule
from repro_torch.configs.base import ModelConfig
from repro_torch.core import pipeline as pl


def to_tensor(arr: Any, device=None) -> torch.Tensor:
    """numpy (bf16 included) -> torch tensor on ``device`` (default cuda).

    The tensor owns its memory, on the CPU too: a step that writes its
    trainable set in place never writes into the caller's array."""
    device = dev_rule.resolve(device)
    arr = np.asarray(arr)
    if device.type == "cpu" or not arr.flags.writeable:   # e.g. a view of a JAX array
        arr = arr.copy()
    # np.ascontiguousarray makes a 0-d array 1-d: the shape is restored
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.reshape(arr.shape).to(device)


def unstack_layers(entry: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One pattern entry's ``[R, C, ...]`` leaves -> a list of R*C per-layer trees."""
    first = entry
    while isinstance(first, dict):
        first = next(iter(first.values()))
    R, C = first.shape[:2]
    return [tree_map(lambda x, r=r, c=c: x[r, c], entry) for r in range(R) for c in range(C)]


def stack_layers(layers: List[Dict[str, Any]], repeats: int) -> Dict[str, Any]:
    """Inverse of :func:`unstack_layers` for tensors: ``[R, C, ...]`` leaves."""
    count = len(layers) // repeats

    def stack(path_leaves):
        return torch.stack(path_leaves).reshape(
            (repeats, count) + tuple(path_leaves[0].shape))

    def rec(nodes):
        if isinstance(nodes[0], dict):
            return {k: rec([n[k] for n in nodes]) for k in nodes[0]}
        return stack(nodes)

    return rec(layers)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """The reference's parameter tree (numpy leaves) -> the port's parameters,
    on ``device`` (default cuda).

    Layers come out in the reference's order: for each repeat, each pattern
    entry's ``count`` layers. Hymba's top-level ``meta`` leaf comes along.
    """
    kinds = {k for k, _ in cfg.pattern}
    if not kinds <= {"dense", "moe", "rwkv", "hymba"} or cfg.enc_dec or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: the port carries dense, moe, rwkv and hymba decoders only")
    device = dev_rule.resolve(device)
    conv = lambda x: to_tensor(x, device)
    out = {
        "embed": tree_map(conv, dict(tree["embed"])),
        "final_norm": tree_map(conv, tree["final_norm"]),
        "head": tree_map(conv, tree["head"]),
        "blocks": _unstack_entries(tree["blocks"], cfg, conv),
    }
    if "meta" in tree:
        out["meta"] = conv(tree["meta"])
    return out


def to_numpy(t: torch.Tensor, bf16: Optional[Any] = None) -> np.ndarray:
    """A tensor as a numpy array (a copy on the host); bf16 as its int16 bit
    view, or viewed as the numpy dtype ``bf16``."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    bits = t.view(torch.int16).numpy().copy()
    return bits if bf16 is None else bits.view(bf16)


def _layer_order(cfg: ModelConfig) -> List[List[int]]:
    """For each pattern entry, the port's layer indices of its ``[R, C]``
    stack in row-major order (repeat, then position in the entry)."""
    per_rep = cfg.layers_per_repeat
    starts = np.cumsum([0] + [c for _, c in cfg.pattern])
    return [[r * per_rep + int(starts[e]) + c for r in range(cfg.repeats) for c in range(count)]
            for e, (_, count) in enumerate(cfg.pattern)]


def _stack_entries(layers: List[Any], cfg: ModelConfig, bf16, tensors: bool = False) -> tuple:
    """One tree per layer -> a tuple over pattern entries of ``[R, C, ...]``
    trees: numpy (through :func:`to_numpy`), or tensors with ``tensors``."""
    out = []
    for (_, count), idx in zip(cfg.pattern, _layer_order(cfg)):
        def stack(*leaves, count=count):
            arr = torch.stack(leaves) if tensors else np.stack([to_numpy(t, bf16) for t in leaves])
            return arr.reshape((cfg.repeats, count) + tuple(arr.shape[1:]))
        out.append(tree_map(stack, *[layers[i] for i in idx]))
    return tuple(out)


def _unstack_entries(entries, cfg: ModelConfig, conv) -> List[Any]:
    """Inverse of :func:`_stack_entries`: one tree per layer, leaves through ``conv``."""
    layers: List[Any] = [None] * cfg.n_layers
    for entry, idx in zip(entries, _layer_order(cfg)):
        for i, layer in zip(idx, unstack_layers(entry)):
            layers[i] = tree_map(conv, layer)
    return layers


def params_to_jax(params: Dict[str, Any], cfg: ModelConfig, bf16=None) -> Dict[str, Any]:
    """The port's parameters -> the reference's tree with numpy leaves (the
    inverse of :func:`params_from_jax`, exact)."""
    conv = lambda t: to_numpy(t, bf16)
    out = {"embed": tree_map(conv, dict(params["embed"])),
           "final_norm": tree_map(conv, params["final_norm"]),
           "head": tree_map(conv, params["head"]),
           "blocks": _stack_entries(params["blocks"], cfg, bf16)}
    if "meta" in params:
        out["meta"] = conv(params["meta"])
    return out


def opt_state_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """The reference's AdamW state (``optim.adamw.init`` / ``update``: full-size
    ``[R, C, ...]`` adapter moments per pattern entry, the head's, the step
    count) -> the port's (one moment dict per layer), on ``device``."""
    device = dev_rule.resolve(device)
    conv = lambda x: to_tensor(x, device)
    moments = {k: {"adapters": _unstack_entries(tree[k]["adapters"], cfg, conv),
                   "head": tree_map(conv, tree[k]["head"])} for k in ("m", "v")}
    return {**moments, "count": conv(np.asarray(tree["count"], np.int32))}


def opt_state_to_jax(opt_state: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse of :func:`opt_state_from_jax`, exact."""
    return tree_map(to_numpy, opt_state_to_reference(opt_state, cfg))


# ---------------------------------------------------------------- the ring's state


def stage_layout(layers: List[Any], spans) -> List[List[Any]]:
    """One tree per layer -> a list per stage."""
    per = len(layers) // spans[-1][1]
    return [layers[b * per:e * per] for b, e in spans]


def stage_adapters_to_jax(stage_tree: List[List[Any]], cfg: ModelConfig, spans,
                          bf16=None) -> Dict[str, np.ndarray]:
    """A tree in the port's stage layout (a list per stage of one dict per
    layer: adapters or their moments) -> the reference's ``[S, max_span, C,
    ...]`` numpy stage stack (``RingTrainer.stage_blocks["adapter"]``,
    ``m_ad``, ``v_ad``)."""
    return tree_map(lambda t: to_numpy(t, bf16), stage_to_reference(stage_tree, cfg, spans))


def stage_adapters_from_jax(stacked: Dict[str, Any], cfg: ModelConfig, spans,
                            device=None) -> List[List[Dict[str, torch.Tensor]]]:
    """Inverse of :func:`stage_adapters_to_jax`, onto ``device`` (default cuda)."""
    device = dev_rule.resolve(device)
    entry = pl.unstack_entry(stacked, spans)
    layers = _unstack_entries((entry,), cfg, lambda x: to_tensor(x, device))
    return stage_layout(layers, spans)


def ring_state_to_jax(trainer, bf16=None) -> Dict[str, Any]:
    """A port ``RingTrainer``'s optimizer-facing state in the reference
    ``RingTrainer``'s layout: ``adapter`` (its ``stage_blocks["adapter"]``),
    ``m_ad``, ``v_ad`` ([S, lps, C, ...] numpy) and ``head``, ``m_hd``,
    ``v_hd`` (the head's trees)."""
    cfg, spans = trainer.cfg, trainer.spans
    out = {"adapter": stage_adapters_to_jax(trainer.stage_adapters(), cfg, spans, bf16),
           "m_ad": stage_adapters_to_jax(trainer.m_ad, cfg, spans),
           "v_ad": stage_adapters_to_jax(trainer.v_ad, cfg, spans)}
    out["head"] = tree_map(lambda t: to_numpy(t, bf16), trainer.shared["head"])
    out["m_hd"] = tree_map(to_numpy, trainer.m_hd)
    out["v_hd"] = tree_map(to_numpy, trainer.v_hd)
    return out


def ring_state_from_jax(state: Dict[str, Any], trainer, device=None) -> None:
    """Install the reference ``RingTrainer``'s state (:func:`ring_state_to_jax`'s
    keys, numpy leaves) into a port ``RingTrainer``, exactly."""
    device = dev_rule.resolve(device)
    cfg, spans = trainer.cfg, trainer.spans
    ads = stage_adapters_from_jax(state["adapter"], cfg, spans, device)
    trainer.stage_blocks = [[{**layer, "adapter": a} for layer, a in zip(stage, stage_ads)]
                            for stage, stage_ads in zip(trainer.stage_blocks, ads)]
    trainer.m_ad = stage_adapters_from_jax(state["m_ad"], cfg, spans, device)
    trainer.v_ad = stage_adapters_from_jax(state["v_ad"], cfg, spans, device)
    conv = lambda x: to_tensor(x, device)
    trainer.shared = {**trainer.shared, "head": tree_map(conv, state["head"])}
    trainer.m_hd = tree_map(conv, state["m_hd"])
    trainer.v_hd = tree_map(conv, state["v_hd"])


def copy_into(dst: Any, src: Any) -> None:
    """Copy the tensors of tree ``src`` into those of ``dst`` (the same
    structure), in place: a CUDA graph that reads or writes ``dst``'s tensors
    sees the new values."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            copy_into(dst[k], src[k])
    else:
        for d, s_ in zip(dst, src, strict=True):
            copy_into(d, s_)


def executor_state_to_jax(executor, bf16=None) -> Dict[str, Any]:
    """A port ``RingExecutor``'s trainable state in the reference
    ``RingExecutor``'s layout: ``adapter`` (its ``stage_blocks["adapter"]``),
    ``head`` (its ``shared["head"]``) and ``opt_state`` (``m`` and ``v``, each
    ``{"adapter": [S, max_span, C, ...], "head": ...}``, and ``count``), numpy."""
    cfg, spans = executor.cfg, executor.spans
    opt = {name: {"adapter": stage_adapters_to_jax(executor.opt_state[name]["adapter"], cfg,
                                                   spans),
                  "head": tree_map(to_numpy, executor.opt_state[name]["head"])}
           for name in ("m", "v")}
    return {"adapter": stage_adapters_to_jax(executor.stage_adapters(), cfg, spans, bf16),
            "head": tree_map(lambda t: to_numpy(t, bf16), executor.shared["head"]),
            "opt_state": {**opt, "count": to_numpy(executor.opt_state["count"])}}


def executor_state_from_jax(state: Dict[str, Any], executor) -> None:
    """Install the reference ``RingExecutor``'s state (:func:`executor_state_to_jax`'s
    keys, numpy leaves) into a port ``RingExecutor``, exactly, by copying into
    the tensors the executor owns (its captured rounds read and write them)."""
    cfg, spans, device = executor.cfg, executor.spans, executor.device
    conv = lambda x: to_tensor(x, device)
    staged = lambda x: stage_adapters_from_jax(x, cfg, spans, device)
    copy_into(executor.stage_adapters(), staged(state["adapter"]))
    copy_into(executor.shared["head"], tree_map(conv, state["head"]))
    for name in ("m", "v"):
        src = state["opt_state"][name]
        copy_into(executor.opt_state[name]["adapter"], staged(src["adapter"]))
        copy_into(executor.opt_state[name]["head"], tree_map(conv, src["head"]))
    executor.opt_state["count"].copy_(conv(np.asarray(state["opt_state"]["count"], np.int32)))


# ---------------------------------------------------------------- checkpoints


def trainable_to_reference(adapters: List[Dict[str, Any]], head: Dict[str, Any],
                           cfg: ModelConfig) -> Dict[str, Any]:
    """One adapter dict per layer and the head -> the reference's parameter
    tree cut to its trainable set: ``{"blocks": ({"adapter": [R, C, ...]},
    ...), "head": head}`` (the keys ``checkpoint.save(adapters_only=True)``
    keeps from the reference's full tree)."""
    return {"blocks": tuple({"adapter": e} for e in
                            _stack_entries(adapters, cfg, None, tensors=True)),
            "head": head}


def trainable_from_reference(tree: Dict[str, Any], cfg: ModelConfig):
    """Inverse of :func:`trainable_to_reference`: (one adapter dict per layer, head)."""
    layers = _unstack_entries([e["adapter"] for e in tree["blocks"]], cfg, lambda x: x)
    return layers, tree["head"]


def stage_to_reference(stage_tree: List[List[Any]], cfg: ModelConfig, spans) -> Dict[str, Any]:
    """A tree in the port's stage layout -> the reference's ``[S, max_span,
    C, ...]`` stage stack, as tensors (:func:`stage_adapters_to_jax`'s layout)."""
    (entry,) = _stack_entries([layer for stage in stage_tree for layer in stage], cfg, None,
                              tensors=True)
    return pl.stack_entry(entry, spans)


def stage_from_reference(stacked: Dict[str, Any], cfg: ModelConfig, spans) -> List[List[Any]]:
    """Inverse of :func:`stage_to_reference` (views of ``stacked``)."""
    layers = _unstack_entries((pl.unstack_entry(stacked, spans),), cfg, lambda x: x)
    return stage_layout(layers, spans)


def ring_opt_to_reference(opt: Dict[str, Any], cfg: ModelConfig, spans) -> Dict[str, Any]:
    """The ring's optimizer state (``executor.ring_opt_init``'s tree: the
    adapters' moments in the stage layout, the head's, ``count``) -> the
    reference ring's ``opt_state``, as tensors."""
    out = {k: {"adapter": stage_to_reference(opt[k]["adapter"], cfg, spans),
               "head": opt[k]["head"]} for k in ("m", "v")}
    return {**out, "count": opt["count"]}


def ring_opt_from_reference(tree: Dict[str, Any], cfg: ModelConfig, spans) -> Dict[str, Any]:
    """Inverse of :func:`ring_opt_to_reference`."""
    out = {k: {"adapter": stage_from_reference(tree[k]["adapter"], cfg, spans),
               "head": tree[k]["head"]} for k in ("m", "v")}
    return {**out, "count": tree["count"]}


def opt_state_to_reference(opt_state: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The one-device AdamW state -> the reference's (:func:`opt_state_to_jax`'s
    layout), as tensors."""
    out = {k: {"adapters": _stack_entries(opt_state[k]["adapters"], cfg, None, tensors=True),
               "head": opt_state[k]["head"]} for k in ("m", "v")}
    return {**out, "count": opt_state["count"]}


def opt_state_from_reference(tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """Inverse of :func:`opt_state_to_reference`."""
    out = {k: {"adapters": _unstack_entries(tree[k]["adapters"], cfg, lambda x: x),
               "head": tree[k]["head"]} for k in ("m", "v")}
    return {**out, "count": tree["count"]}


def ring_state_to_reference(stage_adapters, head, opt: Dict[str, Any], cfg: ModelConfig,
                            spans, tenants: int = 1):
    """The ring's trainable set and optimizer state (the executor's layout;
    leaves ``[T, ...]`` at ``tenants`` > 1) -> ``(params, opt)`` in the
    reference's layout, as tensors: :func:`trainable_to_reference` and
    :func:`ring_opt_to_reference`, or at T > 1 the reference's multi-tenant
    executor's (its ``export_params()`` and ``opt_state``): adapters
    ``[T, R, C, ...]``, the head and its moments ``[T, ...]``, the adapters'
    moments ``[S, T, max_span, C, ...]``."""
    flat = lambda tree: [a for stage in tree for a in stage]
    if tenants == 1:
        return (trainable_to_reference(flat(stage_adapters), head, cfg),
                ring_opt_to_reference(opt, cfg, spans))

    def tenant_major(stage_tree):                  # [T, R, C, ...]
        (entry,) = _stack_entries(flat(stage_tree), cfg, None, tensors=True)
        return tree_map(lambda x: x.movedim(2, 0), entry)

    def stage_stacked(stage_tree):                 # [S, T, max_span, C, ...]
        return tree_map(lambda x: x.movedim(0, 1),
                        pl.stack_entry(tenant_major(stage_tree), spans, leading=1))

    moments = {k: {"adapter": stage_stacked(opt[k]["adapter"]), "head": opt[k]["head"]}
               for k in ("m", "v")}
    return ({"blocks": ({"adapter": tenant_major(stage_adapters)},), "head": head},
            {**moments, "count": opt["count"]})


def ring_state_from_reference(params: Dict[str, Any], opt: Dict[str, Any], cfg: ModelConfig,
                              spans, tenants: int = 1):
    """Inverse of :func:`ring_state_to_reference`: (stage adapters, head,
    ring optimizer state) in the executor's layout, views of ``params`` and
    ``opt`` (leaves ``[T, ...]`` at ``tenants`` > 1)."""
    if tenants == 1:
        adapters, head = trainable_from_reference(params, cfg)
        return stage_layout(adapters, spans), head, ring_opt_from_reference(opt, cfg, spans)

    def staged(tenant_major):                      # [T, R, C, ...] -> the stage layout
        entry = tree_map(lambda x: x.movedim(0, 2), tenant_major)
        return stage_layout(_unstack_entries((entry,), cfg, lambda x: x), spans)

    (entry,) = [e["adapter"] for e in params["blocks"]]
    moments = {k: {"adapter": staged(pl.unstack_entry(
                   tree_map(lambda x: x.movedim(1, 0), opt[k]["adapter"]), spans, leading=1)),
                   "head": opt[k]["head"]} for k in ("m", "v")}
    return staged(entry), params["head"], {**moments, "count": opt["count"]}
