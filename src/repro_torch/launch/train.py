"""Single-device training with RingAda's scheduled unfreezing.

The loop walks :func:`~repro_torch.core.unfreeze.boundary_schedule` and builds
one :func:`~repro_torch.core.training.make_train_step` per segment of constant
boundary; each step trains the head and the adapters above the boundary on a
batch of the merged synthetic client corpora, and prints one loss line with
its boundary. The ring (``--mode ring``) is not ported yet.

Usage (on a machine with an NVIDIA GPU; ``--device cpu`` runs the plain versions):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \\
        --steps 12 --unfreeze-interval 4
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import torch

from repro_torch import device as dev_rule
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import training
from repro_torch.core.unfreeze import UnfreezeSchedule, boundary_schedule
from repro_torch.data.pipeline import Batcher, make_client_datasets, merged, to_device
from repro_torch.models import params as prm
from repro_torch.optim import adamw

RING_LATER = "--mode ring is not ported yet (ROADMAP.md Queue 1, item 3: the ring pipeline)"


def data_source(cfg: ModelConfig, tc: TrainConfig, n_clients: int = 4,
                n_per_client: int = 256) -> Batcher:
    """The reference's single-device data: the merged client corpora, flat batches."""
    ds = merged(make_client_datasets(n_clients, vocab=cfg.vocab_size,
                                     n_per_client=n_per_client, seq=tc.seq_len, seed=tc.seed))
    return Batcher(ds, tc.batch_size, seed=tc.seed)


def train(cfg: ModelConfig, tc: TrainConfig, *, steps: int, device=None) -> Dict[str, Any]:
    """Train ``steps`` steps on ``device`` (default cuda) from random weights
    made from ``tc.seed``; returns the params, the optimizer state and the
    per-step history."""
    device = dev_rule.resolve(device)
    params = prm.materialize(cfg, seed=tc.seed, device=device)
    opt_state = adamw.init(training.full_trainable(params, cfg))
    data = data_source(cfg, tc)
    history = []
    for start, end, boundary in boundary_schedule(cfg, UnfreezeSchedule.from_train_config(tc),
                                                  steps):
        step = training.make_train_step(cfg, tc, boundary)
        for s in range(start, end):
            t0 = time.perf_counter()
            params, opt_state, metrics = step(params, opt_state, to_device(data.next(), device))
            row = {"step": s, "boundary": boundary,
                   **{k: float(v) for k, v in metrics.items()},
                   "wall_s": time.perf_counter() - t0}
            history.append(row)
            print(f"step {s} boundary {boundary} loss {row['loss']:.4f} "
                  f"accuracy {row['accuracy']:.4f} grad_norm {row['grad_norm']:.4g}")
    return {"params": params, "opt_state": opt_state, "history": history}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--mode", choices=["pjit", "ring"], default="pjit",
                    help="pjit: one device (the ring is not ported yet)")
    ap.add_argument("--reduced", action="store_true", help="the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--initial-unfreeze-depth", type=int, default=1)
    ap.add_argument("--unfreeze-interval", type=int, default=40)
    ap.add_argument("--max-unfreeze-depth", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mode == "ring":
        raise NotImplementedError(RING_LATER)

    device = dev_rule.resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tc = TrainConfig(learning_rate=args.lr, batch_size=args.batch_size, seq_len=args.seq_len,
                     steps=args.steps, initial_unfreeze_depth=args.initial_unfreeze_depth,
                     unfreeze_interval=args.unfreeze_interval,
                     max_unfreeze_depth=args.max_unfreeze_depth, seed=args.seed)
    train(cfg, tc, steps=args.steps, device=device)


if __name__ == "__main__":
    main()
