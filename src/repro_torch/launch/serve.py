"""Batched serving loop: prefill + decode with KV caches, on the GPU.

A synchronous batcher: requests are left-padded into fixed batch slots,
prefilled once, then decoded step by step with greedy argmax. Every block runs
the fused adapter kernel; prefill attention runs the flash-attention kernel, an
rwkv block's prefill the wkv-scan kernel, a hymba block's prefill both the
flash-attention and the selective-scan kernels. The horizon a caller gives
counts hymba's 128 meta tokens too (the CLI's does).

Multi-tenant adapter hot-swap: with ``--adapter-store DIR`` pointing at an
AdapterStore, each request may carry a tenant id (a store entry name). One
shared trunk stays resident; :class:`AdapterRegistry` grafts each tenant's
adapter+head bundle into it, each batch serves one tenant, and the registry
re-checks the store's mtimes between batches, so a freshly written bundle is
served on the next batch without a restart.

Usage (on a machine with an NVIDIA GPU; ``--device cpu`` runs the plain versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --requests 8 --max-new 16 [--no-reduced] [--adapter-store DIR]
    (--arch rwkv6-7b or hymba-1.5b for the other two port architectures)
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch import device as dev_rule
from repro_torch.configs import get_config
from repro_torch.models import params as prm
from repro_torch.models import transformer as tfm


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [L] int
    max_new: int
    tenant: Optional[str] = None       # AdapterStore entry name; None = trunk


class AdapterRegistry:
    """Per-tenant parameter trees over one shared trunk.

    ``params_for(tenant)`` grafts the tenant's ``{"adapter", "head"}`` bundle
    into the base parameters (leaves swap, shapes never change).
    ``refresh()`` reloads every entry whose payload mtime moved and returns
    the names it swapped in.
    """

    def __init__(self, base_params: Dict[str, Any], store):
        self.base = base_params
        self.store = store
        blocks = base_params["blocks"]
        self._like = {"adapter": bridge.stack_layers([b["adapter"] for b in blocks],
                                                     repeats=len(blocks)),
                      "head": base_params["head"]}
        self._merged: Dict[str, Dict[str, Any]] = {}
        self._mtimes: Dict[str, float] = {}

    def refresh(self) -> List[str]:
        swapped = []
        for name in self.store.names():
            mt = self.store.mtime(name)
            if self._mtimes.get(name) == mt:
                continue
            bundle, _ = self.store.get(name, self._like)
            adapters = bridge.unstack_layers(bundle["adapter"])
            blocks = [{**layer, "adapter": ad} for layer, ad in zip(self.base["blocks"], adapters)]
            self._merged[name] = {**self.base, "head": bundle["head"], "blocks": blocks}
            self._mtimes[name] = mt
            swapped.append(name)
        return swapped

    def tenants(self) -> List[str]:
        return sorted(self._merged)

    def params_for(self, tenant: Optional[str]) -> Dict[str, Any]:
        if tenant is None:
            return self.base
        if tenant not in self._merged:
            self.refresh()
        if tenant not in self._merged:
            raise KeyError(f"unknown tenant {tenant!r}: store has {self.tenants()}")
        return self._merged[tenant]


class BatchServer:
    """Fixed-slot synchronous batcher (one KV cache per batch, per-slot positions).

    With a ``registry`` each batch is tenant-homogeneous: the queue is consumed
    in arrival order, one batch packs only requests that share the head
    request's tenant, and the registry's mtime watch runs between batches.

    ``batches`` records, for each batch of the last ``run``, its rows, the
    prefill's logits (on the device) and the seconds prefill and decode took.
    """

    def __init__(self, cfg, params, *, slots: int, horizon: int, impl: str = "kernel",
                 registry: Optional[AdapterRegistry] = None, device=None):
        self.device = dev_rule.resolve(device)
        if params["embed"]["tok"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed']['tok'].device}, "
                             f"the server on {self.device}")
        self.cfg, self.params, self.impl = cfg, params, impl
        self.registry = registry
        self.slots, self.horizon = slots, horizon
        self.batches: List[Dict[str, Any]] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def run(self, requests: List[Request], log=print) -> Dict[int, List[int]]:
        queue = list(requests)
        self.batches = []
        t0 = time.perf_counter()
        decoded_tokens = 0
        results: Dict[int, List[int]] = {}
        while queue:
            if self.registry is not None:
                for name in self.registry.refresh():    # hot-swap point
                    log(f"adapter hot-swap: reloaded {name!r}")
                tenant = queue[0].tenant
                batch = [r for r in queue if r.tenant == tenant][: self.slots]
                taken = {id(r) for r in batch}
                queue = [r for r in queue if id(r) not in taken]
                params = self.registry.params_for(tenant)
            else:
                batch, queue = queue[: self.slots], queue[self.slots:]
                params = self.params
            L = max(len(r.prompt) for r in batch)
            toks = np.zeros((len(batch), L), np.int64)
            for i, r in enumerate(batch):
                toks[i, L - len(r.prompt):] = r.prompt     # left-pad with token 0
            toks = torch.from_numpy(toks).to(self.device)
            self._sync()
            ts = time.perf_counter()
            logits, cache = tfm.prefill(params, toks, self.cfg, seq_len=self.horizon,
                                        impl=self.impl)
            cur = torch.argmax(logits, -1)[:, None]
            self._sync()
            tp = time.perf_counter()
            max_new = max(r.max_new for r in batch)
            outs = [cur]
            for _ in range(max_new - 1):
                step_logits, cache = tfm.decode_step(params, cur, cache, self.cfg,
                                                     impl=self.impl)
                cur = torch.argmax(step_logits, -1)[:, None]
                outs.append(cur)
                decoded_tokens += len(batch)
            gen = torch.cat(outs, dim=1).cpu().numpy()
            td = time.perf_counter()
            self.batches.append({"rows": len(batch), "prompt_len": L,
                                 "prefill_logits": logits, "prefill_s": tp - ts,
                                 "decode_s": td - tp, "decode_steps": max_new - 1})
            for i, r in enumerate(batch):
                results[r.rid] = gen[i, : r.max_new].tolist()
        dt = time.perf_counter() - t0
        log(f"served {len(requests)} requests, {decoded_tokens} decode steps in "
            f"{dt:.2f}s ({decoded_tokens / max(dt, 1e-9):.1f} tok/s) on {self.device}")
        return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="serve the reduced config (--no-reduced: the published widths)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--layers", type=int, default=None,
                    help="override the block count (applied after --reduced)")
    ap.add_argument("--adapter-store", default=None,
                    help="AdapterStore directory of per-tenant bundles; requests "
                         "round-robin over the entries (plus the bare trunk)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = dev_rule.resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers,
                                  repeats=args.layers // cfg.layers_per_repeat)
    params = prm.materialize(cfg, seed=args.seed, device=device)
    registry = None
    tenant_cycle: List[Optional[str]] = [None]
    if args.adapter_store:
        from repro_torch.api.tenants import AdapterStore

        registry = AdapterRegistry(params, AdapterStore(args.adapter_store))
        names = registry.refresh()
        print(f"adapter store: serving trunk + {len(names)} tenants {names}")
        tenant_cycle = [None] + list(names)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    size=rng.integers(4, args.prompt_len + 1)),
                    args.max_new, tenant=tenant_cycle[i % len(tenant_cycle)])
            for i in range(args.requests)]
    # the horizon counts the meta tokens prefill puts before every prompt
    server = BatchServer(cfg, params, slots=args.slots,
                         horizon=tfm.n_meta(cfg) + args.prompt_len + args.max_new + 8,
                         registry=registry, device=device)
    results = server.run(reqs)
    print({k: v[:8] for k, v in list(results.items())[:4]})


if __name__ == "__main__":
    main()
