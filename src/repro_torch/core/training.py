"""The training step with RingAda's truncated backpropagation (the
reference's ``core/training.py``).

``split_trainable`` / ``merge_trainable`` realise the paper's trainable set:
the head and every adapter above the unfreeze boundary. Gradients are taken
only with respect to that set, so autograd builds

  * no backward at all for the frozen trunk (it runs under ``torch.no_grad``),
  * no weight gradients for frozen backbone matrices in the hot region

— the two compute savings of RingAda's early-stopped backpropagation.

Trees follow ``models/params.py``: ``{"adapters": [one adapter dict per
layer], "head": {"w"}}``; ``boundary`` counts frozen repeats from the bottom,
as the model's forward takes it.

Two objectives share one forward, backward and AdamW body: the language
model's cross-entropy and, for a span head (``cfg.head_out == 2``, the
paper's mBERT + SQuAD), ``qa_span_loss``. :func:`make_step` is the one place
that picks the step for a config. A model with moe blocks reports the
forward's ``moe_aux`` and ``moe_z`` among the metrics, detached and not added
to the loss, as the reference's LM step does.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.losses import cross_entropy, qa_span_loss
from repro_torch.optim import adamw

Batch = Dict[str, torch.Tensor]


def _n_frozen(cfg: ModelConfig, boundary: int) -> int:
    return boundary * cfg.layers_per_repeat


def split_trainable(params: Dict[str, Any], boundary: int, cfg: ModelConfig) -> Dict[str, Any]:
    """The differentiated leaves: the hot layers' adapters and the head."""
    return {"adapters": [b["adapter"] for b in params["blocks"][_n_frozen(cfg, boundary):]],
            "head": params["head"]}


def full_trainable(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The boundary-0 view, which sizes the optimizer state once."""
    return split_trainable(params, 0, cfg)


def merge_trainable(params: Dict[str, Any], trainable: Dict[str, Any], boundary: int,
                    cfg: ModelConfig) -> Dict[str, Any]:
    """The full parameter tree with the hot adapters taken from ``trainable``."""
    nf = _n_frozen(cfg, boundary)
    blocks = params["blocks"][:nf] + [{**b, "adapter": a} for b, a in
                                      zip(params["blocks"][nf:], trainable["adapters"])]
    return {**params, "blocks": blocks, "head": trainable["head"]}


def write_back(params: Dict[str, Any], new_trainable_full: Dict[str, Any]) -> Dict[str, Any]:
    """Install a full-size trainable tree (every layer's adapter, the head)."""
    blocks = [{**b, "adapter": a} for b, a in zip(params["blocks"],
                                                  new_trainable_full["adapters"])]
    return {**params, "blocks": blocks, "head": new_trainable_full["head"]}


def slice_to_full(params: Dict[str, Any], trainable_sliced: Dict[str, Any], boundary: int,
                  cfg: ModelConfig) -> Dict[str, Any]:
    """The frozen layers' adapters from ``params`` and the hot ones from
    ``trainable_sliced`` -> a full-size trainable tree."""
    frozen = [b["adapter"] for b in params["blocks"][:_n_frozen(cfg, boundary)]]
    return {"adapters": frozen + list(trainable_sliced["adapters"]),
            "head": trainable_sliced["head"]}


def has_moe(cfg: ModelConfig) -> bool:
    return any(kind == "moe" for kind, _ in cfg.pattern)


def objective(cfg: ModelConfig, logits: torch.Tensor, batch: Batch):
    """(loss, metrics) of the config's task: the span loss for a QA head
    (batch ``starts``, ``ends`` [B]), else the LM cross-entropy (``labels``
    [B, S], optional ``mask``; chunked at vocabularies of 32768 and more)."""
    if cfg.head_out == 2:
        return qa_span_loss(logits, batch["starts"], batch["ends"])
    ce_chunk = 512 if cfg.out_dim >= 32768 else None
    return cross_entropy(logits, batch["labels"], batch.get("mask"), chunk=ce_chunk)


def loss_and_grads(params: Dict[str, Any], batch: Batch, cfg: ModelConfig, boundary: int, *,
                   impl: str = "kernel") -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, grads): the config's objective on ``batch`` and its
    gradients with respect to :func:`split_trainable`'s tree (the same structure)."""
    trainable = split_trainable(params, boundary, cfg)
    leaves, spec = tree_flatten(trainable)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    tr = tree_unflatten(leaves, spec)
    with torch.enable_grad():
        logits, aux = tfm.forward(params, batch["tokens"], cfg, boundary=boundary,
                                  impl=impl, hot_adapters=tr["adapters"],
                                  head_params=tr["head"])
        loss, metrics = objective(cfg, logits, batch)
        if has_moe(cfg):
            metrics = {**metrics, **aux}
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(list(grads), spec)


def _make_step(cfg: ModelConfig, tc: TrainConfig, boundary: int, grad_norm: bool) -> Callable:
    def train_step(params, opt_state, batch: Batch):
        _, metrics, grads = loss_and_grads(params, batch, cfg, boundary)
        with torch.no_grad():
            tr_full = slice_to_full(params, split_trainable(params, boundary, cfg), boundary,
                                    cfg)
            new_tr_full, new_opt = adamw.update(grads, opt_state, tr_full, tc, boundary, cfg)
            if grad_norm:
                metrics["grad_norm"] = torch.sqrt(sum(g.float().square().sum()
                                                      for g in tree_leaves(grads)))
        return write_back(params, new_tr_full), new_opt, metrics

    return train_step


def make_train_step(cfg: ModelConfig, tc: TrainConfig, boundary: int) -> Callable:
    """A train step for a static unfreeze boundary:

        new_params, new_opt_state, metrics = step(params, opt_state, batch)

    batch: {"tokens": [B, S], "labels": [B, S], optional "mask": [B, S]}. The
    order of the reference's: split off the trainable leaves, the forward with
    the boundary, the cross-entropy, the backward, the bias-corrected AdamW
    with the boundary mask, the new leaves written back. The metrics carry
    the gradients' norm.
    """
    return _make_step(cfg, tc, boundary, grad_norm=True)


def make_qa_train_step(cfg: ModelConfig, tc: TrainConfig, boundary: int) -> Callable:
    """The SQuAD span-extraction step (the paper's task): batch {"tokens" [B,
    S], "starts" [B], "ends" [B]}, the head [B, S, 2]; metrics loss, em, f1."""
    if cfg.head_out != 2:
        raise ValueError(f"{cfg.name}: the QA step needs a span head (head_out=2)")
    return _make_step(cfg, tc, boundary, grad_norm=False)


def make_step(cfg: ModelConfig, tc: TrainConfig, boundary: int) -> Callable:
    """The step a config trains with: the QA step for a span head, else the
    LM step."""
    if cfg.head_out == 2:
        return make_qa_train_step(cfg, tc, boundary)
    return make_train_step(cfg, tc, boundary)


def make_eval_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch: Batch) -> Dict[str, torch.Tensor]:
        logits, _ = tfm.forward(params, batch["tokens"], cfg)
        return cross_entropy(logits, batch["labels"], batch.get("mask"))[1]

    return eval_step

