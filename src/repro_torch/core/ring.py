"""RingTrainer: the reference (unfused) RingAda trainer, Algorithm 1 (the
reference's ``core/ring.py``).

Every client acts as initiator once a round (round-robin, as in the paper's
experiments), so a round is S owner iterations. Each iteration:

  * takes the boundary from the unfreeze schedule at its step
    (``depth_at`` -> ``depth_to_boundary``) and rounds it DOWN to a span edge
    (``align_boundary``: the stage the raw boundary falls in stays hot);
  * runs one ring round (``core/pipeline.make_ring_train_round``) for that
    owner;
  * updates with the raw masked AdamW (``adamw.leaf_update`` without bias
    correction, constant ``tc.learning_rate``): the adapters under the
    stage-row mask ``stage >= F``, so the frozen stages' adapters and moments
    stay bit-identical, and the head at every iteration.

The adapters' moments live in the stage layout beside the adapters; the
head's are one pair. Any span layout runs, ragged ones (the heterogeneous
ring) included. ``core/executor.RingExecutor`` runs the same round as one
program (one CUDA graph per boundary); this class stays its oracle.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import pipeline as pl
from repro_torch.core.partition import Span, align_boundary, frozen_stage_count
from repro_torch.core.unfreeze import UnfreezeSchedule, depth_to_boundary
from repro_torch.kernels import ops
from repro_torch.optim import adamw


def mean_loss(losses) -> float:
    """A round's loss: the f32 mean of its owners' f32 losses, as the
    reference's ``RingTrainer`` and both executors take it."""
    return float(torch.tensor(losses, dtype=torch.float32).mean())


class RingTrainer:
    """Collaborative fine-tuning over a ring of ``n_stages`` stages on one
    device (the device of ``params``).

    ``schedule``: any object with ``depth_at(step, n_layers) -> depth``;
    the paper's k-rule from ``tc`` by default. ``impl``: the blocks' kernels
    ("kernel") or their plain versions ("plain").
    """

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, params: Dict[str, Any],
                 n_stages: int, n_micro: int, *, schedule=None,
                 spans: Optional[Sequence[Span]] = None, impl: str = "kernel"):
        self.cfg, self.tc, self.impl = cfg, tc, impl
        self.S, self.M = n_stages, n_micro
        self.spans = pl.resolve_spans(cfg.repeats, n_stages, spans)
        self.lps = None if pl.is_ragged(self.spans) else cfg.repeats // n_stages
        self.stage_blocks, self.shared = pl.stage_stack(params, cfg, n_stages, spans=self.spans)
        self._params_rest = {k: v for k, v in params.items() if k != "blocks"}
        self.m_ad, self.v_ad = adamw.init_moments(self.stage_adapters())
        self.m_hd, self.v_hd = adamw.init_moments(self.shared["head"])
        self.sched = schedule if schedule is not None else UnfreezeSchedule.from_train_config(tc)
        self._rounds_run: set = set()        # (owner, boundary) pairs run
        self.step = 0

    def stage_adapters(self):
        """The adapters in the stage layout: a list per stage of one dict per layer."""
        return [[layer["adapter"] for layer in stage] for stage in self.stage_blocks]

    def boundary_at(self, step: int) -> int:
        """The span-aligned boundary (frozen repeats from the bottom) at ``step``."""
        depth = self.sched.depth_at(step, self.cfg.n_layers)
        return align_boundary(self.spans, depth_to_boundary(self.cfg, depth))

    def round_fn(self, owner: int, boundary: int):
        """The ring train round of (owner, boundary)."""
        return pl.make_ring_train_round(self.cfg, n_stages=self.S, owner=owner,
                                        boundary=boundary, n_micro=self.M, spans=self.spans,
                                        impl=self.impl)

    @property
    def n_executables(self) -> int:
        """Ring rounds built: one per (owner, boundary) pair run, S a boundary,
        as the reference counts its jitted rounds (the fused executor builds
        one a boundary)."""
        return len(self._rounds_run)

    def to_device(self, tokens, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        """[S, M, mb, seq] token ids (numpy or tensors) as int64 on the trainer's device."""
        dev = self.shared["head"]["w"].device
        return torch.as_tensor(tokens).long().to(dev), torch.as_tensor(labels).long().to(dev)

    def round(self, tokens, labels) -> Dict[str, Any]:
        """One training round: every client is the initiator once.

        tokens / labels: [S, M, mb, seq], each client's local data. Returns the
        mean loss, the last iteration's boundary and the step count, and per
        iteration its owner, boundary, loss, wall ms, tick ledger and kernel
        launches.
        """
        tokens, labels = self.to_device(tokens, labels)
        iterations = []
        for owner in range(self.S):
            boundary = self.boundary_at(self.step)
            before = dict(ops.LAUNCHES)
            t0 = time.perf_counter()
            loss, ticks = self._iteration(owner, boundary, tokens, labels)
            ms = 1e3 * (time.perf_counter() - t0)          # float(loss) waited for the device
            iterations.append({"owner": owner, "boundary": boundary, "loss": loss, "ms": ms,
                               "fwd_ticks": ticks.get("a", 0) + ticks["b"],
                               "bwd_ticks": ticks["b"],
                               "launches": {k: n - before[k] for k, n in ops.LAUNCHES.items()}})
            self.step += 1
        return {"loss": mean_loss([it["loss"] for it in iterations]),
                "boundary": self.boundary_at(self.step - 1), "step": self.step,
                "iterations": iterations}

    def _iteration(self, owner: int, boundary: int, tokens, labels):
        self._rounds_run.add((owner, boundary))
        ticks: Dict[str, int] = {}
        loss, (g_ad, g_hd) = self.round_fn(owner, boundary)(
            self.stage_blocks, self.shared, tokens, labels,
            record=lambda phase, n: ticks.__setitem__(phase, n))
        lr, tc = self.tc.learning_rate, self.tc
        F = frozen_stage_count(self.spans, boundary)
        # the stage-row mask: stages below F are its zero rows, passed on as
        # they are (the masked update would leave them bit-identical)
        for u in range(F, self.S):
            stage = []
            for j, layer in enumerate(self.stage_blocks[u]):
                p, m, v = adamw.tree_update(g_ad[u][j], self.m_ad[u][j], self.v_ad[u][j],
                                            layer["adapter"], tc, lr=lr)
                self.m_ad[u][j], self.v_ad[u][j] = m, v
                stage.append({**layer, "adapter": p})
            self.stage_blocks[u] = stage
        head, self.m_hd, self.v_hd = adamw.tree_update(g_hd, self.m_hd, self.v_hd,
                                                       self.shared["head"], tc, lr=lr)
        self.shared = {**self.shared, "head": head}
        return float(loss), ticks

    def export_params(self) -> Dict[str, Any]:
        """The flat parameter tree (views of the trainer's tensors)."""
        return pl.unstack(self.stage_blocks, self.cfg, self._params_rest, self.shared,
                          spans=self.spans)
