"""Training with RingAda's scheduled unfreezing, on one device or as a ring:
a thin CLI over :class:`~repro_torch.api.RingSession` (the reference's
``launch/train.py``).

Every mode is a (backend, policy) pair of the session:

  * ``--mode pjit`` (one device): the ``PjitBackend``, one
    :func:`~repro_torch.core.training.make_step` per boundary (on the card
    one CUDA graph per boundary) on a batch of the merged synthetic client
    corpora; one loss line a step with its boundary (and EM and F1 for a
    span head: mbert-squad, the default arch, as the reference's CLI).
    ``--scheme all_hot`` trains every adapter from step 0. Every registered
    arch trains here, rwkv6-7b and hymba-1.5b included.
  * ``--mode ring``: ``--stages`` stages of the model on the device, each
    client with its own corpus, ``--rounds`` rounds (every client the
    initiator once a round, ``--microbatches`` microbatches of
    ``--batch-size`` rows each): the ``FusedBackend`` over
    :class:`~repro_torch.core.executor.RingExecutor` (``--trainer fused``,
    the default: one CUDA graph per boundary on the card; ``--no-packed``
    runs Phase A per owner), the ``CachedBackend`` with ``--slots-per-epoch
    N`` (the data cycles through N epoch-stable slots and a revisited slot
    skips Phase A; ``--cache-capacity``, default N; ``--no-cache``;
    ``--cache-dtype``), or the ``ReferenceBackend`` over its oracle
    :class:`~repro_torch.core.ring.RingTrainer` (``--trainer reference``).
    One line a round with its boundary, depth, loss, wall ms (and
    ``cache_hit``), then the last round's record as JSON (with the cache's
    counts). ``--device-speeds`` gives each stage a relative speed and the
    spans come from the speed-weighted partitioner; the balanced layout
    otherwise. The ring's lr defaults to ``RING_LR``. ``--tenants T``
    (fused or cached) trains T adapter sets over one frozen trunk in one
    joint round (per tenant the solo run, bit for bit); ``--adapter-store
    DIR`` writes each tenant's adapters and moments after the run as the
    store's entries ``tenant0``, ``tenant1``, ..., which ``launch/serve.py
    --adapter-store DIR`` serves. ``--chaos ROUND:EVENT:DEVICE[:FACTOR]``
    (repeatable) injects churn before a round, ``--elastic`` lets the ring
    absorb it: a crash shrinks the ring to the survivors (no checkpoint is
    read), a rejoin grows it back, a straggler is repartitioned away (an
    ``[elastic]`` line each, and ``[elastic S=n]`` on the round). The ring
    refuses rwkv and hymba blocks (``core/pipeline._check_ring``).

The depth grows by one block every ``--unfreeze-interval`` steps (owner
iterations in ring mode; 40 by default, as the reference's CLI);
``--policy plateau`` unfreezes when the loss plateaus instead. ``--save``
writes the session after the run and ``--resume`` continues a saved one, bit
for bit, in the reference's checkpoint format.

Usage (on a machine with an NVIDIA GPU; ``--device cpu`` runs the plain versions):
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 12 \\
        --unfreeze-interval 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \\
        --steps 12 --unfreeze-interval 4
    PYTHONPATH=src python -m repro_torch.launch.train --mode pjit --arch rwkv6-7b \\
        --steps 6 --unfreeze-interval 2 --batch-size 4 --seq-len 512
    PYTHONPATH=src python -m repro_torch.launch.train --mode ring --arch stablelm-3b \\
        --reduced --stages 2 --rounds 4 --unfreeze-interval 2 --save ckpt/ring
    PYTHONPATH=src python -m repro_torch.launch.train --mode ring --arch stablelm-3b \\
        --reduced --stages 2 --rounds 4 --unfreeze-interval 2 --resume ckpt/ring
    PYTHONPATH=src python -m repro_torch.launch.train --mode ring --arch stablelm-3b \\
        --reduced --layers 14 --stages 4 --rounds 2 --device-speeds 1.0,1.25,0.5,0.75
    PYTHONPATH=src python -m repro_torch.launch.train --mode ring --arch stablelm-3b \\
        --reduced --stages 2 --rounds 8 --unfreeze-interval 8 --slots-per-epoch 2
    PYTHONPATH=src python -m repro_torch.launch.train --mode ring --arch qwen2.5-3b \\
        --reduced --stages 2 --rounds 4 --tenants 2 --adapter-store ckpt/adapters
    PYTHONPATH=src python -m repro_torch.launch.train --mode ring --arch stablelm-3b \\
        --reduced --rounds 6 --chaos 3:crash:2 --elastic
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, Optional

from repro_torch import device as dev_rule
from repro_torch.api import (AdapterStore, ExplicitPolicy, LoggingCallback, PjitDataSource,
                             RingDataSource, RingSession, resolve_policy)
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.actcache import CACHE_DTYPES
from repro_torch.data.pipeline import Batcher, RingBatcher

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
    return PjitDataSource(cfg, tc, n_clients=n_clients, n_per_client=n_per_client).batcher


def ring_data_source(cfg: ModelConfig, tc: TrainConfig, n_stages: int,
                     n_per_client: int = 128,
                     slots_per_epoch: Optional[int] = None) -> RingBatcher:
    """The reference's ring data: one corpus per client, ``tc.n_microbatches``
    microbatches of ``tc.batch_size`` rows from each at every round, drawn
    afresh or, with ``slots_per_epoch``, from that many epoch-stable slots."""
    return RingDataSource(cfg, tc, n_stages, n_per_client=n_per_client,
                          slots_per_epoch=slots_per_epoch).rb


def train_ring(cfg: ModelConfig, tc: TrainConfig, *, rounds: int, n_stages: int,
               trainer: str = "fused", packed: bool = True,
               slots_per_epoch: Optional[int] = None, cache_capacity: Optional[int] = None,
               cache_dtype: str = "native", device_speeds: Optional[Any] = None,
               tenants: int = 1, adapter_store: Optional[str] = None,
               chaos: Any = (), elastic: bool = False,
               policy: Any = None, save_path: Optional[str] = None,
               resume: Optional[str] = None, device=None, log=print) -> Dict[str, Any]:
    """``rounds`` rounds of the ring on ``device`` (default cuda) through a
    :class:`~repro_torch.api.RingSession`: the fused backend
    (``trainer="fused"``; the cached one with ``slots_per_epoch`` and a
    capacity, default ``slots_per_epoch``, 0 turning it off) or the
    reference one (``"reference"``), from random weights made from
    ``tc.seed``. ``device_speeds`` (one per stage, ring order) runs the
    paper's speed-weighted partitioner. ``policy``: 'interval' (the paper's
    rule, default) or 'plateau'. ``save_path`` saves the session after the
    run; ``resume`` restores a saved one (its backend, stages, slots,
    capacity, cache dtype, spans and tenants) and runs ``rounds`` more.
    ``tenants`` > 1 (the fused trainer) trains that many adapter sets over
    one trunk; ``adapter_store`` writes every tenant's bundle (``tenant0``,
    ``tenant1``, ...) there after the run. ``chaos`` (``--chaos`` specs)
    injects churn events, counted from this run's first round (a resumed run
    counts from its own), and ``elastic`` lets the ring absorb them; without
    it a crash raises. Returns the driver, the session and the per-round
    history."""
    if trainer not in ("fused", "reference"):
        raise ValueError(f"trainer must be 'fused' or 'reference', got {trainer!r}")
    if tenants > 1 and trainer != "fused":
        raise ValueError("--tenants > 1 needs the fused executor (--trainer fused)")
    if resume:
        if device_speeds is not None:
            raise ValueError(
                "--device-speeds cannot be combined with --resume: the span layout is part "
                "of the checkpointed state (the stage-stacked Adam moments are laid out per "
                "span), so resume restores the saved layout. To repartition, start a fresh "
                "run with the new speeds.")
        # the checkpoint records backend, stages, slots, capacity and spans:
        # re-deriving them from flags could resume a cached run as a
        # streaming one, on other data
        # elastic defaults to the checkpoint's value
        kw: Dict[str, Any] = {}
        if chaos:
            kw["chaos"] = chaos
        if elastic:
            kw["elastic"] = True
        sess = RingSession.restore(resume, cfg, tc, policy=policy, device=device, log=log,
                                   **kw)
        if sess.backend.kind != "ring":
            raise ValueError(f"--resume checkpoint was saved by the {sess.backend.name!r} "
                             f"backend; resume it with --mode pjit")
    else:
        cap = cache_capacity if cache_capacity is not None else (slots_per_epoch or 0)
        backend = "reference" if trainer == "reference" else \
            "cached" if slots_per_epoch and cap else "fused"
        sess = RingSession.create(cfg, tc, backend=backend, policy=policy, n_stages=n_stages,
                                  slots_per_epoch=slots_per_epoch,
                                  cache_capacity=cache_capacity, packed=packed,
                                  cache_dtype=cache_dtype, device_profiles=device_speeds,
                                  tenants=tenants, chaos=chaos, elastic=elastic,
                                  device=device, log=log)
        if device_speeds is not None:
            log(f"heterogeneous ring: speeds {list(device_speeds)} -> spans "
                f"{[list(sp) for sp in sess.backend.spans]}")
    history = sess.run(rounds, callbacks=[LoggingCallback(log)])
    if save_path:
        sess.save(save_path)
    if adapter_store:
        store = AdapterStore(adapter_store)
        for group in sess.tenants:
            group.save_to(store, f"tenant{group.index}")
        log(f"exported {sess.n_tenants} adapter bundle(s) to {adapter_store}")
    return {"trainer": sess.backend.driver, "session": sess, "history": history}


def train(cfg: ModelConfig, tc: TrainConfig, *, steps: int, scheme: str = "ringada",
          policy: Any = None, save_path: Optional[str] = None, resume: Optional[str] = None,
          device=None, log=print) -> Dict[str, Any]:
    """Train ``steps`` steps on ``device`` (default cuda) from random weights
    made from ``tc.seed``, through a :class:`~repro_torch.api.RingSession` on
    the pjit backend. ``scheme``: 'ringada' (scheduled unfreezing under
    ``policy``) or 'all_hot' (every adapter trainable from step 0).
    ``save_path`` / ``resume`` as in :func:`train_ring`. Returns the params,
    the optimizer state, the session and the per-step history."""
    if scheme not in ("ringada", "all_hot"):
        raise ValueError(f"scheme must be 'ringada' or 'all_hot', got {scheme!r}")
    if scheme == "all_hot":
        if policy not in (None, "interval"):
            raise ValueError("scheme='all_hot' fixes the policy (every adapter hot from step "
                             "0): drop --policy")
        policy = ExplicitPolicy((cfg.n_layers,))
    policy = resolve_policy(policy, tc)
    if resume:
        sess = RingSession.restore(resume, cfg, tc, backend="pjit", policy=policy,
                                   device=device, log=log)
    else:
        sess = RingSession.create(cfg, tc, backend="pjit", policy=policy, device=device,
                                  log=log)
    history = sess.run(steps, callbacks=[LoggingCallback(log)])
    if save_path:
        sess.save(save_path)
    return {"params": sess.backend.export_params(), "opt_state": sess.backend._opt,
            "session": sess, "history": history}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mbert-squad")
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
    ap.add_argument("--tenants", type=int, default=1,
                    help="ring mode (fused or cached): train this many adapter sets over one "
                         "frozen trunk in one joint round; per tenant the solo run, bit for bit")
    ap.add_argument("--adapter-store", default=None,
                    help="ring mode: write each tenant's adapters and Adam moments to this "
                         "AdapterStore directory after the run (entries tenant0, tenant1, "
                         "...), servable by launch/serve.py --adapter-store")
    ap.add_argument("--chaos", action="append", default=[],
                    metavar="ROUND:EVENT:DEVICE[:FACTOR]",
                    help="ring mode: inject a churn event (repeatable): EVENT in {crash, leave, "
                         "slowdown, join}, ROUND when it fires (the rounds before it run on "
                         "the old fleet), DEVICE the original stage index, FACTOR the "
                         "slowdown's multiplier (default 2.0); e.g. --chaos 3:crash:2 kills "
                         "device 2 before round 3; a crash needs --elastic to survive")
    ap.add_argument("--elastic", action=argparse.BooleanOptionalAction, default=False,
                    help="ring mode: absorb churn live: a crash shrinks the ring to the "
                         "survivors (no checkpoint is read), a rejoin grows it, a straggler "
                         "found from the stage times is repartitioned away")
    ap.add_argument("--policy", choices=["interval", "plateau"], default="interval",
                    help="unfreeze policy: the paper's k-step rule, or adaptive loss-plateau "
                         "unfreezing")
    ap.add_argument("--scheme", choices=["ringada", "all_hot"], default="ringada",
                    help="pjit mode: scheduled unfreezing, or every adapter trainable from "
                         "step 0")
    ap.add_argument("--save", default=None,
                    help="checkpoint path (both modes), written after the run: adapters, "
                         "head, Adam moments, policy, data cursor, step")
    ap.add_argument("--resume", default=None,
                    help="continue a --save checkpoint bit for bit (ring mode restores the "
                         "saved backend, stages, slots, cache and spans; their flags are "
                         "ignored)")
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
        if args.chaos or args.elastic:
            raise SystemExit("--chaos/--elastic are ring-mode features (--mode ring)")
        train(cfg, tc, steps=args.steps, scheme=args.scheme, policy=args.policy,
              save_path=args.save, resume=args.resume, device=device)
        return
    speeds = None
    if args.device_speeds:
        speeds = [float(x) for x in args.device_speeds.split(",")]
        if len(speeds) != args.stages:
            raise SystemExit(f"{len(speeds)} device speeds for a {args.stages}-stage ring: "
                             f"give one per stage, in ring order")
    out = train_ring(cfg, tc, rounds=args.rounds, n_stages=args.stages, trainer=args.trainer,
                     packed=not args.no_packed, slots_per_epoch=args.slots_per_epoch or None,
                     cache_capacity=0 if args.no_cache else args.cache_capacity,
                     cache_dtype=args.cache_dtype, device_speeds=speeds, tenants=args.tenants,
                     adapter_store=args.adapter_store, chaos=args.chaos,
                     elastic=args.elastic, policy=args.policy,
                     save_path=args.save, resume=args.resume, device=device)
    print(json.dumps(out["history"][-1]))

if __name__ == "__main__":
    main()
