"""Times the port's kernels, and its serving loop, so two checkouts can be compared in one run.

    PYTHONPATH=<checkout>/src python3 src/repro_torch/launch/kernel_times.py \
        [--serve ARCH | --plans | --backward]

Whichever ``repro_torch`` is first on the path is the one timed: run this file
against two checkouts in turns (A, B, B, A) on one card to compare them. It
uses only the public entries (``kernels.ops``, ``BatchServer``, and the
backward launchers ``adapter_fused_bwd`` and ``flash_attention_bwd``, which a
checkout from before training lacks: it then says so and times the rest).

Without ``--serve``: ``adapter_fused`` at decode (h [T, D] for 1-17 rows and
the served widths) and at prefill (h [2048, 2048] and [2048, 4096] in bf16
and f32, [2292, 1600] in bf16), ``flash_attention`` at the served
prefill shapes and at stablelm-3b's (4 x 512, 32 heads of 80), ``rwkv_scan`` at
rwkv6-7b's prefill (N 256 = 4 rows x 64 heads of 64, S 512 and 445) and
``mamba_scan`` at hymba-1.5b's ([4, 640, 1600, 16]), and the backward kernels
at the training shapes (the adapter at h, g [2048, 2048] and [2048, 2560] in
bf16 and f32, and beside it the weight gradients that ``kernels.ops`` forms
from its output, timed alone, with the fp32 casts of h and g alone; attention
at qwen2.5-3b's 4 x 512, 16 over 2 heads of 128, in bf16 and f32, at
starcoder2-7b's 4 x 512, 36 over 4 heads of 128, in bf16, at stablelm-3b's
4 x 512, 32 over 32 heads of 80, in bf16 and f32, and hd 64 with a window of
128; the scans' at rwkv6-7b's N 256, S 512, hd 64 and hymba-1.5b's [4, 640,
1600, 16], where the checkout has them; ``--backward`` times these backward
kernels alone), each on the same inputs as its plain version
(attention: the kernel forward's o and row logsumexp), each checked against
its plain version and timed three ways:
``ms``, the device time of launches captured in one CUDA graph and replayed;
``eager_ms``, launches issued from Python (for a kernel of a few microseconds,
the host's rate); ``host_us``, the host time of one call (its Python and the
launch) with the card not waited on. With ``--serve ARCH``: the architecture at
its published width (random weights from seed 0, non-zero adapters), 4 slots, 8
requests of 64-512 prompt tokens, 32 new tokens each, served after a warm-up,
``--runs`` times: tokens per second, prefill ms and decode ms per step. With
``--plans``: the bf16 prefill path of ``adapter_fused`` at the served prefill
shapes (and stablelm-3b's [2048, 2560]) under every tile plan that fits and
launches (blocks per cluster), each checked against the plain version and
timed warm (``ms``, as above) and over copies of h that together exceed the
50 MB L2 (``cold_ms``), beside the plan ``tile_plan`` chooses; then the bf16
backward's tile path at the training widths under every plan of
``bwd_tile_layout`` that fits and launches, beside ``bwd_tile_plan``'s.

Prints one JSON line per measurement, then the card's name and power limit.
It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch

SEED = 0


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds of ``fn`` on the card by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so the host's cost of each launch is not in the time
    (a kernel of a few microseconds launched from Python is otherwise timed
    by the host: ``cuda_ms``)."""
    fn()                                    # first call: build, function attributes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def host_us(fn, calls: int = 200, reps: int = 21) -> float:
    """Median over ``reps`` of the host microseconds per call of ``fn``, issued
    ``calls`` times without waiting for the card (the card is waited on
    between repetitions)."""
    times = []
    for _ in range(reps + 1):              # the first repetition warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(1e6 * (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return statistics.median(times[1:])


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def _time(name: str, shape: str, kernel, plain) -> None:
    """``kernel`` and ``plain`` return a tensor or a tuple of tensors; the
    error is the largest over the outputs, absolute and relative to each
    output's largest entry."""
    pairs = list(zip(*(o if isinstance(o, tuple) else (o,) for o in (kernel(), plain()))))
    gaps = [((a.float() - b.float()).abs().max().item(), b.float().abs().max().item())
            for a, b in pairs]
    print(json.dumps({"kernel": name, "shape": shape,
                      "max_abs_err": max(g for g, _ in gaps),
                      "max_rel_err": max(g / max(m, 1e-30) for g, m in gaps),
                      "ms": graph_ms(kernel), "eager_ms": cuda_ms(kernel),
                      "host_us": host_us(kernel)}), flush=True)


def kernels() -> None:
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rnd = lambda *s, dtype: torch.randn(s, generator=gen, device="cuda").to(dtype)
    adapters = [(T, D, torch.bfloat16) for D in (1600, 2048, 4096) for T in (1, 4, 16)]
    adapters += [(17, 2048, torch.bfloat16), (4, 4096, torch.float32),
                 (2048, 2048, torch.bfloat16), (2048, 4096, torch.bfloat16),
                 (2292, 1600, torch.bfloat16), (2048, 4096, torch.float32)]
    for T, D, dtype in adapters:
        h, wd, wu = rnd(T, D, dtype=dtype), 0.05 * rnd(D, 64, dtype=dtype), \
            0.05 * rnd(64, D, dtype=dtype)
        _time("adapter_fused", f"h[{T},{D}] m=64 gelu {str(dtype)[6:]}",
              lambda: ops.adapter_fused(h, wd, wu),
              lambda: ops.adapter_fused(h, wd, wu, impl="plain"))
    for S, (H, K, hd), window, n_sink, dtype in (
            (512, (16, 2, 128), None, 0, torch.bfloat16),
            (573, (25, 5, 64), 1024, 128, torch.bfloat16),
            (2048, (25, 5, 64), 1024, 128, torch.bfloat16),
            (512, (16, 2, 128), None, 0, torch.float32)):
        q, k, v = rnd(4, S, H, hd, dtype=dtype), rnd(4, S, K, hd, dtype=dtype), \
            rnd(4, S, K, hd, dtype=dtype)
        kw = dict(window=window, n_sink=n_sink)
        _time("flash_attention", f"q[4,{S},{H},{hd}] kv heads {K} window {window} "
              f"n_sink {n_sink} {str(dtype)[6:]}",
              lambda: ops.flash_attention(q, k, v, **kw),
              lambda: ops.flash_attention(q, k, v, impl="plain", **kw))
    # stablelm-3b's prefill and training forward: hd 80
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (rnd(4, 512, 32, 80, dtype=dtype) for _ in range(3))
        _time("flash_attention", f"q[4,512,32,80] kv heads 32 window None n_sink 0 "
              f"{str(dtype)[6:]}", lambda: ops.flash_attention(q, k, v),
              lambda: ops.flash_attention(q, k, v, impl="plain"))
    # the scans at the served models' scale (as in chip_smoke.py), called as
    # every version of the port takes them
    for S in (512, 445):
        N, hd = 256, 64
        r, k, v = (8 * rnd(N, S, hd, dtype=torch.float32) for _ in range(3))
        lw = -torch.exp(-6.0 + 5.5 * torch.rand(N, S, hd, generator=gen, device="cuda"))
        u, s0 = 0.5 * rnd(N, 1, hd, dtype=torch.float32), torch.zeros(N, hd, hd, device="cuda")
        _time("rwkv_scan", f"r/k/v/lw[{N},{S},{hd}] f32",
              lambda: ops.rwkv_scan(r, k, v, lw, u, s0),
              lambda: ops.rwkv_scan(r, k, v, lw, u, s0, impl="plain"))
    B, S, D, N = 4, 640, 1600, 16
    dt = torch.nn.functional.softplus(rnd(B, S, D, dtype=torch.float32))[..., None]
    log_a = (dt * -torch.arange(1, N + 1, device="cuda", dtype=torch.float32)).contiguous()
    b = (dt * rnd(B, S, 1, N, dtype=torch.float32) * rnd(B, S, D, 1, dtype=torch.float32)
         ).contiguous()
    c = rnd(B, S, N, dtype=torch.float32)
    _time("mamba_scan", f"log_a/b[{B},{S},{D},{N}] f32",
          lambda: ops.mamba_scan(log_a, b, c), lambda: ops.mamba_scan(log_a, b, c, impl="plain"))
    backward(rnd)


def backward(rnd) -> None:
    """The backward kernels (training), where this checkout has them."""
    from repro_torch.kernels import adapter_fused as af
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    if not hasattr(fa, "flash_attention_bwd"):
        print(json.dumps({"kernel": "backward", "note": "no backward kernels in this checkout"}),
              flush=True)
        return
    from repro_torch.kernels import ops

    for (T, D), dtype in ((shape, dtype) for shape in ((2048, 2048), (2048, 2560))
                          for dtype in (torch.bfloat16, torch.float32)):
        h, g = rnd(T, D, dtype=dtype), rnd(T, D, dtype=dtype)
        wd, wu = 0.05 * rnd(D, 64, dtype=dtype), 0.05 * rnd(64, D, dtype=dtype)
        shape = f"h,g[{T},{D}] m=64 gelu {str(dtype)[6:]}"
        _time("adapter_fused_bwd", shape, lambda: af.adapter_fused_bwd(g, h, wd, wu),
              lambda: ref.adapter_fused_bwd_terms(g, h, wd, wu))
        if hasattr(ops, "adapter_weight_grads"):
            _, mid, g_mid = af.adapter_fused_bwd(g, h, wd, wu)
            print(json.dumps({"kernel": "adapter_weight_grads", "shape": shape,
                              "ms": graph_ms(lambda: ops.adapter_weight_grads(h, g, mid, g_mid,
                                                                              dtype)),
                              "casts_ms": graph_ms(lambda: (h.float(), g.float()))}),
                  flush=True)
    for (H, K, hd), window, dtype in (((16, 2, 128), None, torch.bfloat16),
                                      ((16, 2, 128), None, torch.float32),
                                      ((36, 4, 128), None, torch.bfloat16),
                                      ((32, 32, 80), None, torch.bfloat16),
                                      ((32, 32, 80), None, torch.float32),
                                      ((16, 2, 64), 128, torch.bfloat16)):
        S = 512
        q, k, v = rnd(4, S, H, hd, dtype=dtype), rnd(4, S, K, hd, dtype=dtype), \
            rnd(4, S, K, hd, dtype=dtype)
        dout = rnd(4, S, H, hd, dtype=dtype)
        out, lse = fa.flash_attention(q, k, v, window=window, lse=True)
        _time("flash_attention_bwd", f"q,dO[4,{S},{H},{hd}] kv heads {K} window {window} "
              f"{str(dtype)[6:]}",
              lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, window=window),
              lambda: ref.flash_attention_bwd(q, k, v, out, lse, dout, window=window))
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import rwkv_scan as rs

    if not hasattr(rs, "rwkv_scan_bwd"):
        return
    f32 = torch.float32
    N, S, hd = 256, 512, 64
    r, k, v = (8 * rnd(N, S, hd, dtype=f32) for _ in range(3))
    lw = -torch.exp(-6.0 + 5.5 * torch.rand(N, S, hd, device="cuda"))
    u, s0, dout = 0.5 * rnd(N, 1, hd, dtype=f32), torch.zeros(N, hd, hd, device="cuda"), \
        rnd(N, S, hd, dtype=f32)
    _time("rwkv_scan_bwd", f"r/k/v/lw/dout[{N},{S},{hd}] f32",
          lambda: rs.rwkv_scan_bwd(r, k, v, lw, u, s0, dout),
          lambda: ref.rwkv_scan_bwd(r, k, v, lw, u, s0, dout))
    B, S, D, N = 4, 640, 1600, 16
    dt = torch.nn.functional.softplus(rnd(B, S, D, dtype=f32))[..., None]
    log_a = (dt * -torch.arange(1, N + 1, device="cuda", dtype=f32)).contiguous()
    b = (dt * rnd(B, S, 1, N, dtype=f32) * rnd(B, S, D, 1, dtype=f32)).contiguous()
    c, dy = rnd(B, S, N, dtype=f32), rnd(B, S, D, dtype=f32)
    _, _, ckpt = ms.mamba_scan(log_a, b, c, checkpoints=True)
    _time("mamba_scan_bwd", f"log_a/b[{B},{S},{D},{N}] f32",
          lambda: ms.mamba_scan_bwd(log_a, b, c, ckpt, dy),
          lambda: ref.mamba_scan_bwd(log_a, b, c, None, dy))


def cold_ms(fn, h: torch.Tensor, l2_bytes: float = 50e6) -> float:
    """``graph_ms`` of ``fn(x)`` over enough copies x of h that together exceed
    the L2 cache, taken in turn, so no call finds its input in L2 from the
    call before."""
    copies = [h.clone() for _ in range(max(2, int(l2_bytes // (h.numel() * h.element_size())) + 2))]
    turn = iter(range(1 << 30))
    return graph_ms(lambda: fn(copies[next(turn) % len(copies)]))


# the served prefill shapes of the adapter: h [T, D] of qwen2.5-3b and
# rwkv6-7b (4 x 512, and the served batches 4 x 202 and 4 x 445) and
# hymba-1.5b (meta tokens first: 4 x 573, 4 x 330, and 4 x 640 traced)
PREFILL_SHAPES = [(2048, 2048), (808, 2048), (1780, 2048), (2048, 4096), (808, 4096),
                  (1780, 4096), (2292, 1600), (1320, 1600), (2560, 1600), (2048, 2560)]
# the adapter's backward at the training widths (4 x 512 tokens): qwen2.5-3b,
# stablelm-3b, and hymba-1.5b's and rwkv6-7b's widths
TRAIN_SHAPES = [(2048, 2048), (2048, 2560), (2048, 1600), (2048, 4096)]


def plans() -> None:
    from repro_torch.kernels import adapter_fused as af
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
    m = 64
    for T, D in PREFILL_SHAPES:
        h, wd, wu = rnd(T, D), 0.05 * rnd(D, m), 0.05 * rnd(m, D)
        want = ops.adapter_fused(h, wd, wu, impl="plain").float()
        chosen = af.tile_plan(T, D, m)
        for cluster in af.TILE_CLUSTERS:
            p = af.tile_layout(D, m, cluster)
            if p is None or af.tile_occupancy(p) == 0:
                continue
            run = lambda x: af.launch_tile(x, wd, wu, p)
            err = (run(h).float() - want).abs().max().item()
            print(json.dumps({"plan": f"h[{T},{D}] m={m} gelu bfloat16", "cluster": cluster,
                              "smem": p.smem, "blocks_per_sm": af.blocks_per_sm(p.smem),
                              "share": p.wu == p.wd, "clusters_at_once": af.tile_occupancy(p),
                              "chosen": p == chosen, "max_abs_err": err,
                              "ms": graph_ms(lambda: run(h)), "cold_ms": cold_ms(run, h)}),
                  flush=True)
    if not hasattr(af, "bwd_tile_layout"):
        return
    from repro_torch.kernels import ref

    for T, D in TRAIN_SHAPES:
        h, g, wd, wu = rnd(T, D), rnd(T, D), 0.05 * rnd(D, m), 0.05 * rnd(m, D)
        want = ref.adapter_fused_bwd_terms(g, h, wd, wu)
        chosen = af.bwd_tile_plan(T, D, m)
        for cluster in af.TILE_CLUSTERS:
            p = af.bwd_tile_layout(D, m, cluster)
            if p is None or af.bwd_tile_occupancy(p) == 0:
                continue
            run = lambda: af.launch_bwd_tile(g, h, wd, wu, p)
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(run(), want))
            print(json.dumps({"bwd_plan": f"h,g[{T},{D}] m={m} gelu bfloat16",
                              "cluster": cluster, "smem": p.smem,
                              "clusters_at_once": af.bwd_tile_occupancy(p),
                              "chosen": p == chosen, "max_abs_err": err,
                              "ms": graph_ms(run)}), flush=True)


def serve(arch: str, runs: int) -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.models import params as prm
    from repro_torch.models import transformer as tfm

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, adapter=dataclasses.replace(cfg.adapter,
                                                                zero_init_up=False))
    params = prm.materialize(cfg, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED)
    max_new, slots = 32, 4
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n))
               for n in rng.integers(64, 513, size=8)]
    horizon = tfm.n_meta(cfg) + 512 + max_new + 8
    requests = lambda: [Request(i, p, max_new) for i, p in enumerate(prompts)]
    BatchServer(cfg, params, slots=slots, horizon=horizon, device="cuda").run(
        requests()[:slots], log=lambda *a: None)            # warm-up: cuBLAS, allocator
    for run in range(runs):
        server = BatchServer(cfg, params, slots=slots, horizon=horizon, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = server.run(requests(), log=lambda *a: None)
        wall = time.perf_counter() - t0
        b = server.batches
        print(json.dumps({"serve": arch, "run": run,
                          "tokens_per_s": sum(map(len, results.values())) / wall,
                          "prefill_ms": [1e3 * x["prefill_s"] for x in b],
                          "decode_ms_per_step": [1e3 * x["decode_s"] / x["decode_steps"]
                                                 for x in b]}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", default=None, help="serve this architecture instead")
    ap.add_argument("--runs", type=int, default=5, help="served runs after the warm-up")
    ap.add_argument("--plans", action="store_true",
                    help="time every tile plan of the bf16 prefill path instead")
    ap.add_argument("--backward", action="store_true",
                    help="time the backward kernels alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.serve:
        serve(args.serve, args.runs)
    elif args.plans:
        plans()
    elif args.backward:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        backward(lambda *s, dtype: torch.randn(s, generator=gen, device="cuda").to(dtype))
    else:
        kernels()
    print(card(), flush=True)


if __name__ == "__main__":
    main()
