"""Losses and metrics (the reference's ``models/losses.py``): the language
model's cross-entropy and the SQuAD span loss of a ``head_out=2`` head."""
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
            # no RNG to replay, and a CUDA graph may capture the recompute
            n, k, m = checkpoint(_ce_terms, logits[:, c:c + chunk], labels[:, c:c + chunk],
                                 mask[:, c:c + chunk], use_reentrant=False,
                                 preserve_rng_state=False)
            nll_sum, corr, msum = nll_sum + n, corr + k, msum + m
    else:
        nll_sum, corr, msum = _ce_terms(logits, labels, mask)

    denom = torch.clamp(msum, min=1.0)
    loss = nll_sum / denom
    acc = corr / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}


def qa_span_loss(logits: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SQuAD-style span prediction: logits [B, S, 2] (start, end), starts and
    ends [B] token indices. The f32 mean of the start and end cross-entropies,
    and EM and token-level F1 of the argmax spans (the first maximum on a tie)."""
    lf = logits.float()
    sl, el = lf[..., 0], lf[..., 1]
    starts, ends = starts.long(), ends.long()

    def ce1(lg, y):
        return torch.logsumexp(lg, dim=-1) - torch.gather(lg, 1, y[:, None])[:, 0]

    loss = torch.mean(ce1(sl, starts) + ce1(el, ends)) / 2.0
    ps, pe = torch.argmax(sl, dim=-1), torch.argmax(el, dim=-1)
    em = ((ps == starts) & (pe == ends)).float().mean()
    inter = torch.clamp(torch.minimum(pe, ends) - torch.maximum(ps, starts) + 1, min=0).float()
    len_p = torch.clamp(pe - ps + 1, min=1).float()
    len_g = torch.clamp(ends - starts + 1, min=1).float()
    prec, rec = inter / len_p, inter / len_g
    f1 = torch.where(inter > 0, 2 * prec * rec / (prec + rec + 1e-9), 0.0).mean()
    return loss, {"loss": loss, "em": em, "f1": f1}
