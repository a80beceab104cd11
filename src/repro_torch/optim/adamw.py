"""PEFT-masked AdamW (the reference's ``optim/adamw.py``).

Optimizer state exists only for the paper's trainable set (adapters + head).
Updates run on explicit tensors under ``torch.no_grad()``, not through
``torch.optim``, so the math is the reference's leaf for leaf:

  * ``leaf_update`` / ``init_moments`` / ``tree_update`` — the masked-Adam
    primitive, raw (constant lr, no correction; the ring paths) or
    bias-corrected;
  * ``init`` / ``update`` — the single-device path over the full trainable
    tree: bias-corrected, warmup lr, and the boundary mask;
  * ``lr_at`` — the warmup schedule;
  * ``tenant_stack`` — a tenant axis for the multi-tenant ring's state.

Masking (the paper updates only unfrozen adapters): where the mask is zero
the moments do not decay and the parameter does not move, so a frozen row is
bit-identical before and after the step.

Layout: the port keeps one adapter dict per layer, so the reference's
``[R, ...]`` adapter stacks with a row mask are here a list over layers whose
moments stay full-size while the boundary moves; the layers below the
boundary are its masked rows. ``count`` is a 0-d int32 tensor and lr and
the bias corrections are fp32 tensors on its device, so a step never waits
for the host.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.configs.base import ModelConfig, TrainConfig

MaskLike = Union[None, float, torch.Tensor, Callable[[torch.Tensor], Any]]


def lr_at(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup: lr * min(1, (step + 1) / warmup), in fp32."""
    s = step.float()
    warm = torch.clamp((s + 1.0) / max(tc.warmup_steps, 1), max=1.0)
    return tc.learning_rate * warm


def init_moments(tree: Any) -> Tuple[Any, Any]:
    """(m, v) fp32 zeros shaped like ``tree``."""
    zeros = lambda t: tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                     device=x.device), t)
    return zeros(tree), zeros(tree)


def tenant_stack(tree: Any, n_tenants: int) -> Any:
    """Tile every leaf with a leading tenant axis of size ``n_tenants`` (new
    tensors). All tenants start from the same values, so the frozen rows
    stay bit-identical across tenants: the shared Phase-A trunk of the
    multi-tenant ring relies on it."""
    return tree_map(lambda x: torch.stack([x] * n_tenants), tree)


@torch.no_grad()
def leaf_update(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, p: torch.Tensor, *,
                lr, tc: TrainConfig, mask: MaskLike = None,
                bias_correction: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One masked AdamW update on one leaf -> (m2, v2, p2).

    ``mask`` broadcasts against the leaf; where it is zero neither the moments
    nor the parameter move. ``bias_correction=(bc1, bc2)`` is the
    bias-corrected form; ``None`` the raw form.
    """
    gf = g.float()
    m_new = tc.beta1 * m + (1 - tc.beta1) * gf
    v_new = tc.beta2 * v + (1 - tc.beta2) * gf * gf
    if mask is None:
        mk, m2, v2 = 1.0, m_new, v_new
    else:
        mk = torch.as_tensor(mask, dtype=torch.float32, device=m.device)
        m2 = torch.where(mk > 0, m_new, m)
        v2 = torch.where(mk > 0, v_new, v)
    if bias_correction is None:
        mhat, vhat = m2, v2
    else:
        mhat, vhat = m2 / bias_correction[0], v2 / bias_correction[1]
    upd = mhat / (torch.sqrt(vhat) + tc.eps) + tc.weight_decay * p.float()
    p2 = (p.float() - lr * upd * mk).to(p.dtype)
    return m2, v2, p2


def tree_update(grads: Any, m: Any, v: Any, params: Any, tc: TrainConfig, *, lr,
                mask: MaskLike = None,
                bias_correction: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                ) -> Tuple[Any, Any, Any]:
    """Masked AdamW over a tree -> (new_params, new_m, new_v). ``mask`` is
    broadcastable against every leaf or a callable ``leaf -> mask``."""
    mask_fn = mask if callable(mask) else (lambda _leaf: mask)
    trip = tree_map(lambda gi, mi, vi, pi: leaf_update(gi, mi, vi, pi, lr=lr, tc=tc,
                                                       mask=mask_fn(pi),
                                                       bias_correction=bias_correction),
                    grads, m, v, params)
    is_trip = lambda x: isinstance(x, tuple) and len(x) == 3 and \
        all(isinstance(t, torch.Tensor) for t in x)
    pick = lambda i: tree_map(lambda t: t[i], trip, is_leaf=is_trip)
    return pick(2), pick(0), pick(1)


def init(trainable_full: Dict[str, Any]) -> Dict[str, Any]:
    """trainable_full: the full (boundary 0) trainable tree."""
    m, v = init_moments(trainable_full)
    device = tree_leaves(trainable_full)[0].device
    return {"m": m, "v": v, "count": torch.zeros((), dtype=torch.int32, device=device)}


def update(grads: Dict[str, Any], opt_state: Dict[str, Any], trainable_full: Dict[str, Any],
           tc: TrainConfig, boundary: int, cfg: ModelConfig,
           ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """One bias-corrected AdamW step of the trainable set.

    grads: {"adapters": the hot layers' adapter grads (layers from ``boundary``
    repeats up), "head": ...}; trainable_full and the moments: full-size
    (every layer). Returns (new_trainable_full, new_opt_state). The layers
    below the boundary are the reference's mask-0 rows: their tensors are
    passed on as they are (its masked update leaves them bit-identical).
    """
    n_frozen = boundary * cfg.layers_per_repeat
    count = opt_state["count"] + 1
    lr = lr_at(tc, count)
    c = count.float()
    bc = (1.0 - torch.pow(tc.beta1, c), 1.0 - torch.pow(tc.beta2, c))

    m_out = list(opt_state["m"]["adapters"][:n_frozen])
    v_out = list(opt_state["v"]["adapters"][:n_frozen])
    p_out = list(trainable_full["adapters"][:n_frozen])
    for i, gi in enumerate(grads["adapters"], start=n_frozen):
        pe, me, ve = tree_update(gi, opt_state["m"]["adapters"][i],
                                 opt_state["v"]["adapters"][i], trainable_full["adapters"][i],
                                 tc, lr=lr, bias_correction=bc)
        m_out.append(me)
        v_out.append(ve)
        p_out.append(pe)
    ph, mh, vh = tree_update(grads["head"], opt_state["m"]["head"], opt_state["v"]["head"],
                             trainable_full["head"], tc, lr=lr, bias_correction=bc)
    new_state = {"count": count, "m": {"adapters": m_out, "head": mh},
                 "v": {"adapters": v_out, "head": vh}}
    return {"adapters": p_out, "head": ph}, new_state


def opt_state_bytes(opt_state) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(opt_state))
