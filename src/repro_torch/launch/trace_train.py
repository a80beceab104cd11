"""Where a training step's time goes, at two unfreeze depths, under torch.profiler.

One architecture at its published width (qwen2.5-3b by default; random
weights from seed 0, non-zero adapters; ``--arch stablelm-3b`` for the main
path's arch, ``--arch mbert-squad`` for the paper's QA model), batches of 4
x 512 tokens from the merged synthetic client corpora (the QA corpus for a
span head). For each depth (``--depths``, default 1 and the layer count: the
top block only, and every block) it runs ``PjitBackend.step`` (the session's
one-device step, the batch moved to the card in each step) twice: eager
(``graphs=False``) and as the boundary's CUDA graph. Each takes one step to
warm up (the graphed one's builds the graph), then the step's host wall time
without the profiler, its time by CUDA events, the memory resident before
it and its peak device memory (``torch.cuda.max_memory_allocated``; the
eager step's also the peak of its forward and backward alone, the graphed
step's the build's peak, its reserved memory, capture seconds and the
launches the capture recorded), then the traced step's device time summed
over kernels, the traced device span (first device event to last) and its
gap to that sum, the device's idle share of the unprofiled wall time, the
kernels that took the most device time and the port's own kernels (forward
and backward). Both backends share the frozen weights; each step moves the
adapters and the head, which a step's time does not depend on.

``--mode ring`` traces the RingAda ring round instead: ``--stages`` stages of
the model on the card (4 by default), each owner's data ``--microbatches``
microbatches of 1 x ``--seq-len`` tokens (4 x 512 by default: one owner
iteration sees one single-device step's tokens), for each depth (default:
one, two and every stage's layers), on the same batch:

  * ``--trainer fused`` (the default), ``RingExecutor``: one round builds the
    depth's CUDA graph (warm-up, capture, replay), then one unprofiled
    replay (wall time), one timed by CUDA events and one traced replay; it
    prints the memory resident before, the build's peak, the graph's
    reserved memory, the capture's seconds and the kernel launches it
    recorded. Then the same round from the activation cache (capacity 1):
    a capture round and a cached round build their graphs (the build peak,
    the reserved memory before and with both graphs alive beside the direct
    one, the seconds of each build), a capture replay (another slot) timed
    by CUDA events, then the cached round's unprofiled replay, the direct
    and the cached replays timed by CUDA events in turns (direct, cached,
    cached, direct), the traced cached replay, its graph's launches and the
    buffer's bytes;
  * ``--trainer reference``, ``RingTrainer``: one round to warm up, one
    unprofiled round and one traced round; it prints the memory resident
    before, the round's peak and the peak of one owner iteration's ring
    forward and backward alone, and the kernel launches per owner iteration;

then the traced round as above.

    PYTHONPATH=src python -m repro_torch.launch.trace_train [--arch stablelm-3b] [--depths 1 32]
    PYTHONPATH=src python -m repro_torch.launch.trace_train --arch mbert-squad
    PYTHONPATH=src python -m repro_torch.launch.trace_train --mode ring --arch stablelm-3b \
        [--trainer reference]

It needs a CUDA card: the numbers are device metrics.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch import device as dev_rule
from repro_torch.api import ExplicitPolicy
from repro_torch.api.backends import PjitBackend
from repro_torch.configs import TrainConfig, get_config
from repro_torch.core import training
from repro_torch.core.executor import RingExecutor
from repro_torch.core.ring import RingTrainer
from repro_torch.core.unfreeze import UnfreezeSchedule, depth_to_boundary
from repro_torch.data.pipeline import to_device
from repro_torch.launch.trace_serve import traced, wall_ms
from repro_torch.launch.train import RING_LR, data_source, ring_data_source
from repro_torch.models import params as prm

SEED = 0


def _event_ms(run) -> float:
    """One run's device time by CUDA events."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def trace_ring_fused(cfg, tc, depths, device) -> None:
    S, M = tc.n_stages, tc.n_microbatches
    ex = RingExecutor(cfg, tc, prm.materialize(cfg, seed=SEED, device=device), S, M,
                      cache_capacity=1)
    tokens, labels = ex.to_device(*ring_data_source(cfg, tc, S).next())
    run = lambda: ex.round(tokens, labels)
    run_cached = lambda: ex.round(tokens, labels, slot=0)
    for depth in depths:
        ex.sched = UnfreezeSchedule(depths=(depth,), interval=S)
        boundary = ex.boundary_at(ex.step)
        resident = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        build = wall_ms(run, device)                    # warm-up, capture, replay
        peak = torch.cuda.max_memory_allocated(device)
        unprofiled = wall_ms(run, device)
        event_ms = _event_ms(run)
        print(f"[trace] arch={cfg.name} ring fused stages={S} "
              f"microbatches={M}x1x{tc.seq_len} depth={depth} boundary={boundary} "
              f"resident_gib={resident / 2**30:.3f} build_peak_gib={peak / 2**30:.3f} "
              f"reserved_gib={torch.cuda.memory_reserved(device) / 2**30:.3f} "
              f"build_ms={build:.1f} capture_s={ex.capture_seconds[(boundary, 'direct')]:.2f} "
              f"replay_event_ms={event_ms:.3f} "
              f"launches_at_capture="
              f"{json.dumps(ex.capture_launches[(boundary, 'direct')]).replace(' ', '')} "
              f"device={torch.cuda.get_device_name(device)}")
        traced(run, device, f"ring fused depth {depth}", unprofiled)
        # the same round from the activation cache: a capture round (a miss,
        # which builds its graph), then the cached round (a hit, which builds
        # its graph), both graphs alive beside the direct one
        reserved = torch.cuda.memory_reserved(device)
        torch.cuda.reset_peak_memory_stats(device)
        capture_ms = wall_ms(run_cached, device)
        cached_build = wall_ms(run_cached, device)
        peak = torch.cuda.max_memory_allocated(device)
        capture_replay = _event_ms(lambda: ex.round(tokens, labels, slot=1))   # evicts slot 0
        run_cached()                                    # a capture again: slot 0 back in
        unprofiled = wall_ms(run_cached, device)
        turns = [_event_ms(f) for f in (run, run_cached, run_cached, run)]
        event_ms = turns[1]
        st = ex.cache.stats()
        print(f"[trace] arch={cfg.name} ring cached stages={S} "
              f"microbatches={M}x1x{tc.seq_len} depth={depth} boundary={boundary} "
              f"build_peak_gib={peak / 2**30:.3f} reserved_before_gib={reserved / 2**30:.3f} "
              f"reserved_gib={torch.cuda.memory_reserved(device) / 2**30:.3f} "
              f"capture_build_ms={capture_ms:.1f} cached_build_ms={cached_build:.1f} "
              f"capture_s={ex.capture_seconds[(boundary, 'capture')]:.2f} "
              f"cached_s={ex.capture_seconds[(boundary, 'cached')]:.2f} "
              f"capture_replay_event_ms={capture_replay:.3f} replay_event_ms={event_ms:.3f} "
              f"direct_cached_cached_direct_event_ms="
              f"{json.dumps([round(t, 3) for t in turns]).replace(' ', '')} "
              f"launches_at_capture="
              f"{json.dumps(ex.capture_launches[(boundary, 'cached')]).replace(' ', '')} "
              f"cache_bytes_per_entry={st['cache_bytes_per_entry']} "
              f"cache_buffer_bytes={st['cache_buffer_bytes']} "
              f"device={torch.cuda.get_device_name(device)}")
        traced(run_cached, device, f"ring cached depth {depth}", unprofiled)


def trace_ring(cfg, args, device) -> None:
    S, M = args.stages, args.microbatches
    tc = TrainConfig(learning_rate=RING_LR, batch_size=1, seq_len=args.seq_len, n_microbatches=M,
                     n_stages=S, seed=SEED)
    lps = cfg.n_layers // S
    depths = tuple(args.depths or (lps, 2 * lps, cfg.n_layers))
    if args.trainer == "fused":
        trace_ring_fused(cfg, tc, depths, device)
        return
    trainer = RingTrainer(cfg, tc, prm.materialize(cfg, seed=SEED, device=device), S, M)
    tokens, labels = trainer.to_device(*ring_data_source(cfg, tc, S).next())
    run = lambda: trainer.round(tokens, labels)
    for depth in depths:
        trainer.sched = UnfreezeSchedule(depths=(depth,), interval=S)
        boundary = trainer.boundary_at(trainer.step)
        launches = run()["iterations"][0]["launches"]       # warm-up: kernel build, cuBLAS
        resident = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        unprofiled = wall_ms(run, device)
        peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        trainer.round_fn(0, boundary)(trainer.stage_blocks, trainer.shared, tokens, labels)
        fwd_bwd = torch.cuda.max_memory_allocated(device)
        print(f"[trace] arch={cfg.name} ring stages={S} microbatches={M}x1x{args.seq_len} "
              f"depth={depth} boundary={boundary} "
              f"resident_gib={resident / 2**30:.3f} round_peak_gib={peak / 2**30:.3f} "
              f"fwd_bwd_peak_gib={fwd_bwd / 2**30:.3f} "
              f"launches_per_iteration={json.dumps(launches).replace(' ', '')} "
              f"device={torch.cuda.get_device_name(device)}")
        traced(run, device, f"ring depth {depth}", unprofiled)


def trace_pjit(cfg, args, device) -> None:
    """The one-device step at each depth, eager and graphed (module docstring)."""
    tc = TrainConfig(batch_size=args.batch_size, seq_len=args.seq_len, seed=SEED)
    params = prm.materialize(cfg, seed=SEED, device=device)
    batch = data_source(cfg, tc).next()
    for depth in args.depths or (1, cfg.n_layers):
        boundary = depth_to_boundary(cfg, depth)
        for graphs in (False, True):
            be = PjitBackend(cfg, tc, ExplicitPolicy((depth,)), params=params, device=device,
                             graphs=graphs)
            run = lambda: be.step(batch)
            resident = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            build = wall_ms(run, device)         # kernel build and cuBLAS, or the capture
            build_peak = torch.cuda.max_memory_allocated(device)
            run()
            torch.cuda.reset_peak_memory_stats(device)
            unprofiled = wall_ms(run, device)
            peak = torch.cuda.max_memory_allocated(device)
            event_ms = _event_ms(run)
            if graphs:
                key = be.last_key
                extra = (f"build_ms={build:.1f} build_peak_gib={build_peak / 2**30:.3f} "
                         f"reserved_gib={torch.cuda.memory_reserved(device) / 2**30:.3f} "
                         f"capture_s={be.capture_seconds[key]:.2f} launches_at_capture="
                         f"{json.dumps(be.capture_launches[key]).replace(' ', '')}")
            else:
                torch.cuda.reset_peak_memory_stats(device)
                training.loss_and_grads(params, to_device(batch, device), cfg, boundary)
                extra = f"fwd_bwd_peak_gib={torch.cuda.max_memory_allocated(device) / 2**30:.3f}"
            label = "graphed" if graphs else "eager"
            print(f"[trace] arch={cfg.name} step={label} depth={depth} boundary={boundary} "
                  f"batch={args.batch_size} seq_len={args.seq_len} "
                  f"resident_gib={resident / 2**30:.3f} step_peak_gib={peak / 2**30:.3f} "
                  f"wall_ms={unprofiled:.3f} event_ms={event_ms:.3f} {extra} "
                  f"device={torch.cuda.get_device_name(device)}")
            traced(run, device, f"train {label} depth {depth}", unprofiled)
            del be, run
            torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", help="a dense port architecture")
    ap.add_argument("--mode", choices=["pjit", "ring"], default="pjit",
                    help="pjit: the single-device step; ring: the ring round")
    ap.add_argument("--trainer", choices=["fused", "reference"], default="fused",
                    help="ring mode: RingExecutor's CUDA graphs or the RingTrainer oracle")
    ap.add_argument("--stages", type=int, default=4, help="ring mode: ring stages")
    ap.add_argument("--microbatches", type=int, default=4,
                    help="ring mode: microbatches of 1 x seq-len per owner")
    ap.add_argument("--depths", type=int, nargs="+", default=None,
                    help="unfreeze depths (default: 1 and every layer)")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=512)
    args = ap.parse_args(argv)
    device = dev_rule.resolve("cuda")
    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, adapter=dataclasses.replace(cfg.adapter, zero_init_up=False))
    if args.mode == "ring":
        trace_ring(cfg, args, device)
        return
    trace_pjit(cfg, args, device)


if __name__ == "__main__":
    main()
