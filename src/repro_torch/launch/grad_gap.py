"""Where the bf16 gradient gap between the backward kernels and their plain versions comes from.

``chip_smoke.py`` holds a full-depth train step's gradients, computed with the
backward kernels, against the same step with the backward kernels swapped for
their plain versions (the same forward, bit for bit), by the RMS gap of each
gradient leaf over the leaf's RMS (``GRAD_RMS_RTOL``). This script takes that
gap apart on the same inputs: one architecture at its published width
(random weights from seed 0, non-zero adapters), the first batch of 4 x 512
tokens of the training data, every layer hot. Against the plain backward
everywhere, it prints the worst leaf's gap of each of:

- ``plain_again``: the plain backward again (0 where the step is
  deterministic, as the comparison assumes);
- ``both``: both backward kernels (``chip_smoke.py``'s gap);
- ``adapter``: the adapter's backward kernel alone (its bf16 route);
- ``adapter_rows``: the adapter's 16-row CUDA-core kernel alone, on the same
  bf16 inputs (the route before the tile path);
- ``attention``: the attention backward kernel alone;
- ``adapter_dh`` and ``adapter_mid``: the adapter's kernel for dh alone
  (its mid and g_mid, which feed only the layer's own weight gradients,
  from the plain version), and for mid and g_mid alone;
- ``one_ulp``: the plain backward everywhere, with one element of the top
  layer's dh moved by one bf16 ulp: what any difference at all grows into.

    PYTHONPATH=src python -m repro_torch.launch.grad_gap [--arch stablelm-3b]

It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch import device as dev_rule
from repro_torch.configs import TrainConfig, get_config
from repro_torch.core import training
from repro_torch.data.pipeline import to_device
from repro_torch.kernels import adapter_fused as af
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.launch.train import data_source
from repro_torch.models import params as prm

SEED = 0


def one_ulp_terms():
    """ref.adapter_fused_bwd_terms, but the first call's (the top layer's)
    dh[0, 0] moved by one ulp of its dtype."""
    calls = []

    def terms(g, h, w_down, w_up, *, activation="gelu"):
        dh, mid, g_mid = ref.adapter_fused_bwd_terms(g, h, w_down, w_up, activation=activation)
        if not calls:
            dh = dh.clone()
            bits = dh.view(torch.int16) if dh.dtype == torch.bfloat16 else dh.view(torch.int32)
            bits.view(-1)[0] += 1
        calls.append(1)
        return dh, mid, g_mid

    return terms


def mixed(dh_from, mid_from):
    """An adapter backward whose dh is ``dh_from``'s and whose mid and g_mid
    are ``mid_from``'s."""
    def terms(g, h, w_down, w_up, *, activation="gelu"):
        dh = dh_from(g, h, w_down, w_up, activation=activation)[0]
        _, mid, g_mid = mid_from(g, h, w_down, w_up, activation=activation)
        return dh, mid, g_mid

    return terms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", help="a dense port architecture")
    args = ap.parse_args(argv)
    device = dev_rule.resolve("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, adapter=dataclasses.replace(cfg.adapter, zero_init_up=False))
    tc = TrainConfig(batch_size=4, seq_len=512, seed=SEED)
    params = prm.materialize(cfg, seed=SEED, device=device)
    batch = to_device(data_source(cfg, tc).next(), device)
    real = af.adapter_fused_bwd, fa.flash_attention_bwd
    variants = {
        "plain": (ref.adapter_fused_bwd_terms, ref.flash_attention_bwd),
        "plain_again": (ref.adapter_fused_bwd_terms, ref.flash_attention_bwd),   # 0: determinism
        "both": real,
        "adapter": (real[0], ref.flash_attention_bwd),
        "adapter_rows": (af.launch_bwd_rows, ref.flash_attention_bwd),
        "attention": (ref.adapter_fused_bwd_terms, real[1]),
        "adapter_dh": (mixed(real[0], ref.adapter_fused_bwd_terms), ref.flash_attention_bwd),
        "adapter_mid": (mixed(ref.adapter_fused_bwd_terms, real[0]), ref.flash_attention_bwd),
        "one_ulp": (one_ulp_terms(), ref.flash_attention_bwd),
    }

    def leaves(swap):
        af.adapter_fused_bwd, fa.flash_attention_bwd = swap
        try:
            _, _, g = training.loss_and_grads(params, batch, cfg, 0)
        finally:
            af.adapter_fused_bwd, fa.flash_attention_bwd = real
        out = {"head": g["head"]["w"]}
        for i, a in enumerate(g["adapters"]):
            out.update({f"L{i}.w_down": a["w_down"], f"L{i}.w_up": a["w_up"]})
        return out

    rms = lambda x: x.float().square().mean().sqrt().item()
    base = leaves(variants.pop("plain"))
    for name, swap in variants.items():
        got = leaves(swap)
        gaps = {k: rms(got[k].float() - base[k].float()) / rms(base[k]) for k in base}
        worst = max(gaps, key=gaps.get)
        print(json.dumps({"arch": cfg.name, "depth": cfg.n_layers, "dtype": cfg.dtype,
                          "variant": name, "worst_leaf": worst, "worst_gap": gaps[worst],
                          "gaps": {k: float(f"{v:.3g}") for k, v in gaps.items()},
                          "device": torch.cuda.get_device_name(device)}), flush=True)


if __name__ == "__main__":
    main()
