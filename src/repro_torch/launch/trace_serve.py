"""Where serving time goes: one prefill and a few decode steps under torch.profiler.

At the serving path's shapes: one architecture at its published width
(qwen2.5-3b by default, or ``--arch rwkv6-7b`` / ``hymba-1.5b``; random weights
from seed 0, non-zero adapters), a batch of 4 prompts of 512 tokens (hymba
puts its 128 meta tokens before each: 640 prefill positions), then 4 decode steps. For prefill and for decode it prints the host wall time
without the profiler (taken before the profiler first runs), the device time
summed over kernels (traced), the traced device span (the first device
event's start to the last one's end) and its gap to that sum (the device's
idle time between the traced events; below 0 where events overlap), the
device's idle share of the unprofiled wall time, the kernel launches, the kernels that took the most device time, and the
device time of each of the port's own kernels.

    PYTHONPATH=src python -m repro_torch.launch.trace_serve [--arch rwkv6-7b | hymba-1.5b]

Run as a file (``python3 src/repro_torch/launch/trace_serve.py``) with another
checkout's ``src`` on PYTHONPATH to trace that checkout the same way.

It needs a CUDA card: the numbers are device metrics.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import device as dev_rule
from repro_torch.configs import get_config
from repro_torch.models import params as prm
from repro_torch.models import transformer as tfm

BATCH, PROMPT_LEN, STEPS, TOP, SEED = 4, 512, 4, 12, 0
PORT_KERNELS = ("adapter_", "flash_attention", "attention_bwd", "rwkv_scan", "mamba_scan")


def wall_ms(fn, device: torch.device) -> float:
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    return 1e3 * (time.perf_counter() - t0)


def traced(fn, device: torch.device, label: str, unprofiled_ms: float) -> None:
    """Profile ``fn``; ``unprofiled_ms`` is its wall time measured before any profiling."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_wall_ms = wall_ms(fn, device)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    ranges = [e.time_range for e in prof.events() if e.device_type.name == "CUDA"]
    span_ms = (max(r.end for r in ranges) - min(r.start for r in ranges)) / 1e3 if ranges else 0.0
    print(f"[{label}] wall_ms={unprofiled_ms:.3f} traced_wall_ms={traced_wall_ms:.3f} "
          f"device_ms={device_ms:.3f} device_span_ms={span_ms:.3f} "
          f"span_gap_ms={span_ms - device_ms:.3f} idle_share={1 - device_ms / unprofiled_ms:.3f} "
          f"kernel_launches={launches}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"[{label}]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    # the port's own kernels, wherever they rank
    for e in events:
        if any(name in e.key for name in PORT_KERNELS):
            print(f"[{label}] port kernel {e.self_device_time_total / 1e3:9.3f} ms  "
                  f"x{e.count:<5d} {e.key[:90]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", help="a port architecture, at full width")
    args = ap.parse_args(argv)
    device = dev_rule.resolve("cuda")
    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, adapter=dataclasses.replace(cfg.adapter, zero_init_up=False))
    params = prm.materialize(cfg, seed=SEED, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), generator=gen, device=device)
    horizon = tfm.n_meta(cfg) + PROMPT_LEN + 2 * STEPS + 8
    state = {}

    def prefill():
        state["logits"], state["cache"] = tfm.prefill(params, tokens, cfg, seq_len=horizon)

    def decode():
        for _ in range(STEPS):
            cur = torch.argmax(state["logits"], -1)[:, None]
            state["logits"], state["cache"] = tfm.decode_step(params, cur, state["cache"], cfg)

    with torch.inference_mode():
        prefill()                                   # warm-up: kernel build, cuBLAS
        decode()
        print(f"[trace] arch={cfg.name} layers={cfg.n_layers} batch={BATCH} "
              f"prompt_len={PROMPT_LEN} meta_tokens={tfm.n_meta(cfg)} decode_steps={STEPS} "
              f"device={device}")
        # wall times before the profiler first runs, then the traced runs
        walls = [wall_ms(prefill, device), wall_ms(decode, device)]
        traced(prefill, device, "prefill", walls[0])
        traced(decode, device, "decode", walls[1])


if __name__ == "__main__":
    main()
