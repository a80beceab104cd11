"""The ring's learning rate on the card: ``RingTrainer``'s rounds at each
given lr, through the blocks' kernels and through their plain versions
(``impl="plain"``), in bf16 and in f32.

The walk is ``chip_smoke.py``'s ring phase: a model at its published width
with non-zero adapters, random weights from seed 0, ``--stages`` stages,
each owner's data ``--microbatches`` microbatches of 1 x ``--seq-len``
tokens, one round at each of ``--depths``. Each (lr, path, dtype) run starts
from weights made anew from the seed and the same data. One line per owner
iteration (its boundary and loss), then one per run with the round means and
the first iteration whose loss was not finite; a run stops there.

``--probe`` also holds, before each owner iteration of the kernel runs, the
kernels against their plain versions on the trainer's present weights:
every kernel call of a forward through the kernels against its plain
version on the same inputs, with the largest |input| and |output| and the
non-finite entries of each; and the ring round's loss and gradients through
the kernels against three others: the plain versions throughout, the plain
versions above Phase A on the kernels (both hot regions start from the same
input, as ``chip_smoke.py`` holds a training step), and the backward
kernels alone swapped for their plain versions (the same forward, bit for
bit). Each gradient gap is the furthest leaf's, by its largest entry and by
its RMS, over the other path's. One ``[probe]`` line per iteration.

    PYTHONPATH=src python -m repro_torch.launch.ring_lr [--lrs 1e-3 1e-4] [--probe]

It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math

import torch
from torch.utils._pytree import tree_leaves

from repro_torch import device as dev_rule
from repro_torch.configs import TrainConfig, get_config
from repro_torch.core import pipeline as pl
from repro_torch.core.ring import RingTrainer
from repro_torch.core.unfreeze import UnfreezeSchedule
from repro_torch.kernels import adapter_fused as af
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch.kernel_times import card
from repro_torch.launch.train import ring_data_source
from repro_torch.models import params as prm

SEED = 0
RUNS = (("kernel", "bfloat16"), ("plain", "bfloat16"), ("plain", "float32"))


def _amax(t: torch.Tensor) -> float:
    return t.detach().float().abs().max().item()


def _rms(t: torch.Tensor) -> float:
    return t.detach().float().pow(2).mean().sqrt().item()


def _bad(t: torch.Tensor) -> int:
    return int((~torch.isfinite(t.detach())).sum())


def probe(trainer: RingTrainer, owner: int, boundary: int, tokens, labels) -> dict:
    """The kernels against their plain versions on the trainer's weights and
    the owner's data; nothing of the trainer changes."""
    layer_of = {id(layer["ln1"]): i for i, layer in enumerate(
        layer for stage in trainer.stage_blocks for layer in stage)}
    calls, where = [], [-1]
    real_block, real = pl.apply_block, {n: getattr(ops, n) for n in ("adapter_fused",
                                                                     "flash_attention")}

    def block(kind, cfg, layer, h, ctx):
        where[0] = layer_of.get(id(layer["ln1"]), -1)
        return real_block(kind, cfg, layer, h, ctx)

    def against_plain(name):
        def both(x, *a, **kw):
            out = real[name](x, *a, **kw)
            want = real[name](x, *a, **{**kw, "impl": "plain"})
            calls.append({"op": name, "layer": where[0], "in": _amax(x), "out": _amax(out),
                          "plain_out": _amax(want), "bad": _bad(out), "plain_bad": _bad(want),
                          "gap": _amax(out.float() - want.float()) / max(_amax(want), 1e-30)})
            return out
        return both

    ring = dict(n_stages=trainer.S, owner=owner, boundary=boundary, n_micro=trainer.M,
                spans=trainer.spans)
    pl.apply_block = block
    ops.adapter_fused = against_plain("adapter_fused")
    ops.flash_attention = against_plain("flash_attention")
    try:
        with torch.no_grad():
            pl.make_ring_round(trainer.cfg, **ring)(trainer.stage_blocks, trainer.shared,
                                                    tokens, labels)
    finally:
        pl.apply_block = real_block
        ops.adapter_fused, ops.flash_attention = real["adapter_fused"], real["flash_attention"]
    train = lambda impl: pl.make_ring_train_round(trainer.cfg, impl=impl, **ring)(
        trainer.stage_blocks, trainer.shared, tokens, labels)

    def trunk_on_kernels(kind, cfg, layer, h, ctx):
        if not torch.is_grad_enabled():                  # Phase A
            ctx = dataclasses.replace(ctx, impl="kernel")
        return real_block(kind, cfg, layer, h, ctx)

    kernel, held = train("kernel"), {"plain": train("plain")}
    bwd = af.adapter_fused_bwd, fa.flash_attention_bwd
    pl.apply_block = trunk_on_kernels
    try:
        held["plain_above_the_kernels_trunk"] = train("plain")
        pl.apply_block = real_block
        af.adapter_fused_bwd, fa.flash_attention_bwd = (ref.adapter_fused_bwd_terms,
                                                        ref.flash_attention_bwd)
        held["plain_backward_kernels"] = train("kernel")
    finally:
        pl.apply_block = real_block
        af.adapter_fused_bwd, fa.flash_attention_bwd = bwd
    first_bad = next((c for c in calls if c["bad"] and not c["plain_bad"]), None)
    return {"loss_kernel": float(kernel[0]),
            "largest_in": max(c["in"] for c in calls),
            "worst_call": max(calls, key=lambda c: c["gap"]),
            "first_call_non_finite_only_on_kernel": first_bad,
            "calls_non_finite": sum(1 for c in calls if c["bad"]),
            "plain_calls_non_finite": sum(1 for c in calls if c["plain_bad"]),
            "grads_non_finite": sum(_bad(g) for g in tree_leaves(kernel[1])),
            **{name: _grad_gaps(kernel, other) for name, other in held.items()}}


def _grad_gaps(kernel, other) -> dict:
    """The other path's loss, and the leaf whose gradient is furthest from the
    kernel path's (by the largest entry's gap and by the RMS gap, each over
    the other path's)."""
    (_, (ak, hk)), (loss, (ao, ho)) = kernel, other
    leaves = [(f"head.{k}", hk[k], ho[k]) for k in hk] + [
        (f"layer{i}.{k}", a[k], b[k]) for i, (a, b) in enumerate(
            zip([x for st in ak for x in st], [x for st in ao for x in st])) for k in a]
    gaps = [(name, _amax(g.float() - w.float()) / max(_amax(w), 1e-30),
             _rms(g.float() - w.float()) / max(_rms(w), 1e-30)) for name, g, w in leaves]
    by_max, by_rms = max(gaps, key=lambda g: g[1]), max(gaps, key=lambda g: g[2])
    return {"loss": float(loss), "worst_max_gap": by_max[:2],
            "worst_rms_gap": [by_rms[0], by_rms[2]],
            "grads_non_finite": sum(_bad(g) for g in tree_leaves(other[1]))}


def run(cfg, lr: float, impl: str, args, device) -> dict:
    S, M = args.stages, args.microbatches
    tc = TrainConfig(learning_rate=lr, batch_size=1, seq_len=args.seq_len, n_microbatches=M,
                     n_stages=S, seed=SEED)
    trainer = RingTrainer(cfg, tc, prm.materialize(cfg, seed=SEED, device=device), S, M,
                          schedule=UnfreezeSchedule(depths=tuple(args.depths), interval=S),
                          impl=impl)
    data = ring_data_source(cfg, tc, S)
    means, first_bad = [], None
    for r in range(len(args.depths)):
        tokens, labels = trainer.to_device(*data.next())
        losses = []
        for owner in range(S):                # RingTrainer.round, an iteration at a time
            boundary = trainer.boundary_at(trainer.step)
            if args.probe and impl == "kernel":
                print(f"[probe] lr={lr} round={r} owner={owner} boundary={boundary} "
                      + json.dumps(probe(trainer, owner, boundary, tokens, labels)),
                      flush=True)
            loss, _ = trainer._iteration(owner, boundary, tokens, labels)
            trainer.step += 1
            losses.append(loss)
            print(f"[ring_lr] lr={lr} impl={impl} dtype={cfg.dtype} round={r} "
                  f"owner={owner} boundary={boundary} loss={loss:.5f}", flush=True)
            if first_bad is None and not math.isfinite(loss):
                first_bad = {"round": r, "owner": owner}
        means.append(sum(losses) / S)
        if first_bad is not None:
            break
    return {"lr": lr, "impl": impl, "dtype": cfg.dtype, "round_means": means,
            "first_non_finite": first_bad}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b", help="a dense port architecture")
    ap.add_argument("--lrs", type=float, nargs="+", default=[1e-3, 1e-4])
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--depths", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--probe", action="store_true",
                    help="hold the kernels against their plain versions before each "
                         "iteration of the kernel runs")
    args = ap.parse_args(argv)
    device = dev_rule.resolve("cuda")
    print(card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 in full f32
    base = get_config(args.arch)
    base = dataclasses.replace(base, adapter=dataclasses.replace(base.adapter,
                                                                 zero_init_up=False))
    for lr in args.lrs:
        for impl, dtype in RUNS:
            out = run(dataclasses.replace(base, dtype=dtype), lr, impl, args, device)
            print("[ring_lr] " + json.dumps(out), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    print(card(), flush=True)


if __name__ == "__main__":
    main()
