"""Training with RingAda's scheduled unfreezing, on one device or as a ring.

``--mode pjit`` (one device): the loop walks
:func:`~repro_torch.core.unfreeze.boundary_schedule` and builds one
:func:`~repro_torch.core.training.make_train_step` per segment of constant
boundary; each step trains the head and the adapters above the boundary on a
batch of the merged synthetic client corpora, and prints one loss line with
its boundary.

``--mode ring --trainer reference``: ``--stages`` stages of the model on the
device, each client with its own corpus, ``--rounds`` rounds of
:class:`~repro_torch.core.ring.RingTrainer` (every client the initiator once a
round, ``--microbatches`` microbatches of ``--batch-size`` rows each); one
line per round with its boundary, depth, loss and wall time, then the last
round's record as JSON. The depth grows by one block every
``--unfreeze-interval`` owner iterations (default: one round, the stage
count). ``--trainer fused`` (the reference's default) is the fused executor,
not ported yet. The ring's lr defaults to ``RING_LR``.

Usage (on a machine with an NVIDIA GPU; ``--device cpu`` runs the plain versions):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \\
        --steps 12 --unfreeze-interval 4
    PYTHONPATH=src python -m repro_torch.launch.train --mode ring --trainer reference \\
        --arch stablelm-3b --reduced --stages 2 --rounds 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict

import torch

from repro_torch import device as dev_rule
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import training
from repro_torch.core.ring import RingTrainer
from repro_torch.core.unfreeze import UnfreezeSchedule, boundary_schedule
from repro_torch.data.pipeline import (Batcher, RingBatcher, make_client_datasets, merged,
                                       to_device)
from repro_torch.models import params as prm
from repro_torch.optim import adamw

# The ring's update is the reference's raw AdamW (no warm-up, no bias
# correction), whose first steps move every entry by about 3 lr in its
# gradient's sign. At stablelm-3b's full width the pjit default of 1e-3 made
# the ring's loss rise every round, through the kernels and through their
# plain versions alike, and drove the weights to a non-finite forward within
# three rounds, where the plain versions on the same weights agree with the
# kernels (launch/ring_lr.py --probe; PERF.md). So the ring trains at 1e-4.
RING_LR = 1e-4
FUSED_LATER = ("--mode ring --trainer fused is not ported yet (ROADMAP.md Queue 1, item 4: "
               "the fused executor); --trainer reference runs the ring (Queue 1, item 3)")


def data_source(cfg: ModelConfig, tc: TrainConfig, n_clients: int = 4,
                n_per_client: int = 256) -> Batcher:
    """The reference's single-device data: the merged client corpora, flat batches."""
    ds = merged(make_client_datasets(n_clients, vocab=cfg.vocab_size,
                                     n_per_client=n_per_client, seq=tc.seq_len, seed=tc.seed))
    return Batcher(ds, tc.batch_size, seed=tc.seed)


def ring_data_source(cfg: ModelConfig, tc: TrainConfig, n_stages: int,
                     n_per_client: int = 128) -> RingBatcher:
    """The reference's ring data: one corpus per client, ``tc.n_microbatches``
    microbatches of ``tc.batch_size`` rows from each at every round."""
    clients = make_client_datasets(n_stages, vocab=cfg.vocab_size, n_per_client=n_per_client,
                                   seq=tc.seq_len, seed=tc.seed)
    return RingBatcher(clients, tc.n_microbatches, tc.batch_size, seed=tc.seed)


def train_ring(cfg: ModelConfig, tc: TrainConfig, *, rounds: int, n_stages: int,
               device=None) -> Dict[str, Any]:
    """``rounds`` rounds of :class:`RingTrainer` on ``device`` (default cuda)
    from random weights made from ``tc.seed``; returns the trainer and the
    per-round history."""
    device = dev_rule.resolve(device)
    params = prm.materialize(cfg, seed=tc.seed, device=device)
    trainer = RingTrainer(cfg, tc, params, n_stages, tc.n_microbatches)
    del params
    data = ring_data_source(cfg, tc, n_stages)
    history = []
    for r in range(rounds):
        t0 = time.perf_counter()
        rec = trainer.round(*data.next())
        rec = {"round": r, **rec, "depth": (cfg.repeats - rec["boundary"]) * cfg.layers_per_repeat,
               "round_ms": 1e3 * (time.perf_counter() - t0)}
        history.append(rec)
        print(f"round {r} boundary {rec['boundary']} depth {rec['depth']} "
            f"loss {rec['loss']:.4f} round_ms {rec['round_ms']:.1f}")
    return {"trainer": trainer, "history": history}


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
                    help="pjit: one device; ring: the RingAda ring, its stages on the device")
    ap.add_argument("--trainer", choices=["fused", "reference"], default="fused",
                    help="ring mode: the fused executor (not ported yet) or the RingTrainer "
                         "oracle")
    ap.add_argument("--reduced", action="store_true", help="the reduced config")
    ap.add_argument("--layers", type=int, default=None,
                    help="override the block count (after --reduced; a multiple of the "
                         "arch's layers per repeat)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=25, help="ring mode: training rounds")
    ap.add_argument("--stages", type=int, default=4, help="ring mode: ring stages")
    ap.add_argument("--microbatches", type=int, default=8,
                    help="ring mode: microbatches per client and round")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=None,
                    help=f"default 1e-3, in ring mode RING_LR ({RING_LR})")
    ap.add_argument("--initial-unfreeze-depth", type=int, default=1)
    ap.add_argument("--unfreeze-interval", type=int, default=None,
                    help="steps (ring mode: owner iterations) between unfreezes; default 40, "
                         "in ring mode the stage count (one more block a round)")
    ap.add_argument("--max-unfreeze-depth", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mode == "ring" and args.trainer == "fused":
        raise NotImplementedError(FUSED_LATER)

    device = dev_rule.resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        per = cfg.layers_per_repeat
        if args.layers % per:
            raise SystemExit(f"--layers {args.layers} must be a multiple of {cfg.name}'s "
                             f"layers-per-repeat ({per})")
        cfg = dataclasses.replace(cfg, n_layers=args.layers, repeats=args.layers // per)
    interval = args.unfreeze_interval
    if interval is None:
        interval = args.stages if args.mode == "ring" else 40
    lr = args.lr if args.lr is not None else RING_LR if args.mode == "ring" else 1e-3
    tc = TrainConfig(learning_rate=lr, batch_size=args.batch_size, seq_len=args.seq_len,
                     steps=args.steps, initial_unfreeze_depth=args.initial_unfreeze_depth,
                     unfreeze_interval=interval, max_unfreeze_depth=args.max_unfreeze_depth,
                     n_stages=args.stages, n_microbatches=args.microbatches, seed=args.seed)
    if args.mode == "pjit":
        train(cfg, tc, steps=args.steps, device=device)
        return
    out = train_ring(cfg, tc, rounds=args.rounds, n_stages=args.stages, device=device)
    last = {k: v for k, v in out["history"][-1].items() if k != "iterations"}
    print(json.dumps(last))


if __name__ == "__main__":
    main()
