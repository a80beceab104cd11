"""Training with RingAda's scheduled unfreezing, on one device or as a ring.

``--mode pjit`` (one device): the loop walks
:func:`~repro_torch.core.unfreeze.boundary_schedule` and builds one
:func:`~repro_torch.core.training.make_train_step` per segment of constant
boundary; each step trains the head and the adapters above the boundary on a
batch of the merged synthetic client corpora, and prints one loss line with
its boundary.

``--mode ring``: ``--stages`` stages of the model on the device, each client
with its own corpus, ``--rounds`` rounds (every client the initiator once a
round, ``--microbatches`` microbatches of ``--batch-size`` rows each) of
:class:`~repro_torch.core.executor.RingExecutor` (``--trainer fused``, the
default: one CUDA graph per boundary on the card; ``--no-packed`` runs Phase A
per owner) or of its oracle :class:`~repro_torch.core.ring.RingTrainer`
(``--trainer reference``); one line per round with its boundary, depth, loss
and wall time, then the last round's record as JSON. The depth grows by one
block every ``--unfreeze-interval`` steps (owner iterations in ring mode; 40
by default, as the reference's CLI). ``--device-speeds`` gives each stage a
relative speed and the spans come from the speed-weighted partitioner
(``partition.spans_from_profiles``); the balanced layout otherwise. The
ring's lr defaults to ``RING_LR``. ``--slots-per-epoch N`` cycles the data
through N epoch-stable batch slots and gives the executor a frozen-trunk
activation cache (``--cache-capacity``, default N; ``--no-cache``;
``--cache-dtype``): a revisited slot skips Phase A. Each round's line then
says ``cache_hit``, and the last JSON line carries the cache's counts.

Usage (on a machine with an NVIDIA GPU; ``--device cpu`` runs the plain versions):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \\
        --steps 12 --unfreeze-interval 4
    PYTHONPATH=src python -m repro_torch.launch.train --mode ring --arch stablelm-3b \\
        --reduced --stages 2 --rounds 4 --unfreeze-interval 2
    PYTHONPATH=src python -m repro_torch.launch.train --mode ring --arch stablelm-3b \\
        --reduced --layers 14 --stages 4 --rounds 2 --device-speeds 1.0,1.25,0.5,0.75
    PYTHONPATH=src python -m repro_torch.launch.train --mode ring --arch stablelm-3b \\
        --reduced --stages 2 --rounds 8 --unfreeze-interval 8 --slots-per-epoch 2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import device as dev_rule
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import training
from repro_torch.core.actcache import CACHE_DTYPES
from repro_torch.core.executor import RingExecutor
from repro_torch.core.partition import parse_device_profiles, spans_from_profiles
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


def data_source(cfg: ModelConfig, tc: TrainConfig, n_clients: int = 4,
                n_per_client: int = 256) -> Batcher:
    """The reference's single-device data: the merged client corpora, flat batches."""
    ds = merged(make_client_datasets(n_clients, vocab=cfg.vocab_size,
                                     n_per_client=n_per_client, seq=tc.seq_len, seed=tc.seed))
    return Batcher(ds, tc.batch_size, seed=tc.seed)


def ring_data_source(cfg: ModelConfig, tc: TrainConfig, n_stages: int,
                     n_per_client: int = 128,
                     slots_per_epoch: Optional[int] = None) -> RingBatcher:
    """The reference's ring data: one corpus per client, ``tc.n_microbatches``
    microbatches of ``tc.batch_size`` rows from each at every round, drawn
    afresh or, with ``slots_per_epoch``, from that many epoch-stable slots."""
    clients = make_client_datasets(n_stages, vocab=cfg.vocab_size, n_per_client=n_per_client,
                                   seq=tc.seq_len, seed=tc.seed)
    return RingBatcher(clients, tc.n_microbatches, tc.batch_size, seed=tc.seed,
                       slots_per_epoch=slots_per_epoch)


def train_ring(cfg: ModelConfig, tc: TrainConfig, *, rounds: int, n_stages: int,
               trainer: str = "fused", spans=None, packed: bool = True,
               slots_per_epoch: Optional[int] = None, cache_capacity: Optional[int] = None,
               cache_dtype: str = "native", device=None) -> Dict[str, Any]:
    """``rounds`` rounds of :class:`RingExecutor` (``trainer="fused"``) or
    :class:`RingTrainer` (``"reference"``) on ``device`` (default cuda) from
    random weights made from ``tc.seed``, over the layout ``spans`` (default
    balanced); returns the trainer and the per-round history.

    ``slots_per_epoch``: the data cycles through that many batch slots
    (``RingBatcher.next_slot``; the reference trainer ignores the slot), and
    the executor keeps an activation cache of ``cache_capacity`` entries
    (default ``slots_per_epoch``; 0 turns it off) in ``cache_dtype``, as the
    reference's CLI chooses its cached backend."""
    device = dev_rule.resolve(device)
    cap = cache_capacity if cache_capacity is not None else (slots_per_epoch or 0)
    cached = trainer == "fused" and bool(slots_per_epoch) and cap > 0
    if cached and cap < slots_per_epoch:
        # round-robin slots and LRU: every slot is evicted before its revisit
        print(f"WARNING: cache_capacity {cap} < slots_per_epoch {slots_per_epoch}: the cache "
              f"will thrash (0% hits, capture overhead every round); raise the capacity or "
              f"turn the cache off")
    params = prm.materialize(cfg, seed=tc.seed, device=device)
    if trainer == "fused":
        ring = RingExecutor(cfg, tc, params, n_stages, tc.n_microbatches, spans=spans,
                            packed=packed, cache_capacity=cap if cached else 0,
                            cache_dtype=cache_dtype)
    else:
        ring = RingTrainer(cfg, tc, params, n_stages, tc.n_microbatches, spans=spans)
    del params
    data = ring_data_source(cfg, tc, n_stages, slots_per_epoch=slots_per_epoch or None)
    history = []
    for r in range(rounds):
        t0 = time.perf_counter()
        if slots_per_epoch:
            slot, tokens, labels = data.next_slot()
        else:
            slot, (tokens, labels) = None, data.next()
        out = ring.round(tokens, labels, slot=slot) if trainer == "fused" \
            else ring.round(tokens, labels)
        rec = RingExecutor.materialize_metrics(out)
        rec = {"round": r, **rec, "depth": (cfg.repeats - rec["boundary"]) * cfg.layers_per_repeat,
               "round_ms": 1e3 * (time.perf_counter() - t0)}
        if slot is not None:
            rec["slot"] = slot
        history.append(rec)
        hit = f" cache_hit {rec['cache_hit']}" if "cache_hit" in rec else ""
        print(f"round {r} boundary {rec['boundary']} depth {rec['depth']} "
              f"loss {rec['loss']:.4f} round_ms {rec['round_ms']:.1f}{hit}")
    return {"trainer": ring, "history": history}


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
                    help="ring mode: the fused RingExecutor or the RingTrainer oracle")
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
    ap.add_argument("--unfreeze-interval", type=int, default=40,
                    help="steps (ring mode: owner iterations) between unfreezes")
    ap.add_argument("--max-unfreeze-depth", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device-speeds", default=None,
                    help="ring mode: comma-separated relative speeds, one per stage in ring "
                         "order (e.g. 1.0,1.25,0.5,0.75); faster stages hold longer spans "
                         "(default: balanced spans)")
    ap.add_argument("--no-packed", action="store_true",
                    help="ring mode, fused: Phase A per owner instead of one conveyor a round")
    ap.add_argument("--slots-per-epoch", type=int, default=0,
                    help="ring mode: epoch-stable batch slots (the activation cache's keys; "
                         "e.g. 8 turns the Phase-A-skipping cache on); 0 (default): batches "
                         "drawn afresh every round, no cache")
    ap.add_argument("--cache-capacity", type=int, default=None,
                    help="ring mode: activation-cache entries (default: slots-per-epoch; 0 "
                         "turns the cache off)")
    ap.add_argument("--no-cache", action="store_true",
                    help="ring mode: no activation cache (for streaming, non-repeating data)")
    ap.add_argument("--cache-dtype", choices=CACHE_DTYPES,
                    default="native",
                    help="ring mode: the cache's storage: 'native' keeps the captured bits, "
                         "'bf16' halves and 'int8' (per-row scales) quarters the bytes of an "
                         "f32 entry")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

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
    lr = args.lr if args.lr is not None else RING_LR if args.mode == "ring" else 1e-3
    tc = TrainConfig(learning_rate=lr, batch_size=args.batch_size, seq_len=args.seq_len,
                     steps=args.steps, initial_unfreeze_depth=args.initial_unfreeze_depth,
                     unfreeze_interval=args.unfreeze_interval,
                     max_unfreeze_depth=args.max_unfreeze_depth,
                     n_stages=args.stages, n_microbatches=args.microbatches, seed=args.seed)
    if args.mode == "pjit":
        train(cfg, tc, steps=args.steps, device=device)
        return
    spans = None
    if args.device_speeds:
        speeds = [float(x) for x in args.device_speeds.split(",")]
        profiles = parse_device_profiles(speeds)
        if len(profiles) != args.stages:
            raise SystemExit(f"{len(profiles)} device speeds for a {args.stages}-stage ring: "
                             f"give one per stage, in ring order")
        spans = spans_from_profiles(cfg.repeats, profiles)
        print(f"heterogeneous ring: speeds {speeds} -> spans {[list(sp) for sp in spans]}")
    out = train_ring(cfg, tc, rounds=args.rounds, n_stages=args.stages, trainer=args.trainer,
                     spans=spans, packed=not args.no_packed,
                     slots_per_epoch=args.slots_per_epoch or None,
                     cache_capacity=0 if args.no_cache else args.cache_capacity,
                     cache_dtype=args.cache_dtype, device=device)
    last = {k: v for k, v in out["history"][-1].items() if k != "iterations"}
    print(json.dumps(last))


if __name__ == "__main__":
    main()
