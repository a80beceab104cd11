"""Losses and metrics (the reference's ``models/losses.py``, language-model
cross-entropy; the QA span loss waits for the QA head, ROADMAP.md Queue 1)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """(sum nll, sum correct, sum mask) over all positions — fp32 internals."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None])[..., 0]
    nll = (lse - gold) * mask
    correct = (torch.argmax(lf, dim=-1) == labels).float() * mask
    return nll.sum(), correct.sum(), mask.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, chunk: Optional[int] = None,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-level CE. logits [B, S, V] (any float dtype), labels [B, S] int.

    Stable fp32 logsumexp. With ``chunk`` set and S a multiple of it above it,
    the sequence runs in checkpointed chunks, so the fp32 copies of the logits
    never exist whole: each chunk's are made again in the backward.
    """
    B, S = labels.shape
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    mask = mask.float()
    labels = labels.long()

    if chunk and S > chunk and S % chunk == 0:
        nll_sum = corr = msum = 0.0
        for c in range(0, S, chunk):
            n, k, m = checkpoint(_ce_terms, logits[:, c:c + chunk], labels[:, c:c + chunk],
                                 mask[:, c:c + chunk], use_reentrant=False)
            nll_sum, corr, msum = nll_sum + n, corr + k, msum + m
    else:
        nll_sum, corr, msum = _ce_terms(logits, labels, mask)

    denom = torch.clamp(msum, min=1.0)
    loss = nll_sum / denom
    acc = corr / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}
