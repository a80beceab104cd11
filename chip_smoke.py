"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc). Imports only the port
(``src/repro_torch``), never JAX. Phases, one line each; any failure ends the
run with a non-zero exit and no result line:

  1. environment: card name and power limit, torch and nvcc versions, and the
     build of every kernel from ``src/repro_torch/kernels/csrc`` (nvcc for
     sm_90a, one process per source, all at once) with ptxas register/spill
     counts per function, and how many of ``adapter_fused``'s decode clusters,
     of its bf16 prefill path's clusters (at the served shapes' plans) and of
     its bf16 backward's clusters (at the training shapes' plans) the card
     holds at once (``cudaOccupancyMaxActiveClusters``);
  2. every kernel against its plain PyTorch version on the card, at the serving
     path's shapes, with its time by CUDA events beside the plain version's
     (and, for attention, SDPA's) and the kernel or path that ran (the
     adapter's bf16 prefill path at every served batch's shape, with ptxas's
     registers and spill, and, where its time on one h falls below the bytes
     bound, its time over copies of h that exceed the L2 cache); then,
     checked but not timed, the edge cases of the redesigned
     kernels (ragged lengths, sinks ending inside a tile, Sk > Sq, strided
     views, every width, m, activation and dtype); ``rwkv_scan`` also at
     decays down to -20 a step and S of 1, 7 and 33, and ``mamba_scan`` from
     a random start state, each timed with ptxas's registers and spill; the
     backward kernels (training) against the plain backward on the same
     inputs: ``adapter_fused_bwd`` at h [2048, 2048], m 64, bf16 and f32, and
     at stablelm-3b's h [2048, 2560] in bf16 (each with the path it ran: bf16
     the 64-row cluster tiles, f32 the 16-row kernel; and ptxas's registers
     and spill), and
     ``flash_attention_bwd`` at qwen2.5-3b's training shape (4 x 512, 16 over
     2 heads, hd 128) and stablelm-3b's (4 x 512, 32 over 32 heads of 80) in
     bf16 and f32 and at hd 64 with a window, each with its graph and eager
     time, bound, the plain version's time and, for attention, the time of
     torch.autograd through SDPA, the backward alone (a yardstick only), in a
     CUDA graph and eagerly, each beside the kernel's like time. Attention's
     forward runs at stablelm-3b's shape too (hd 80, bf16 and f32), and its
     edge cases at hd 80 in MHA and with a GQA group of 8. The ring's shapes
     (phase 3's ``phase_ring``: one microbatch of 1 x 512 tokens a launch)
     are held too, in bf16: the adapter and its backward at h [512, 2560],
     attention and its backward at [1, 512, 32, 80]; and mbert-squad's
     training shapes (phase 3's ``phase_train_qa``), forward and backward,
     bf16 and f32: the adapter at h [2048, 768], m 48, where two of each
     cluster's 8 blocks own no column (with path and ptxas), and in bf16
     at T 1, 100 and 512 and with every activation; attention at
     [4, 512, 12, 64] in MHA, beside SDPA and torch.autograd through SDPA;
     and the shapes of phases 6-9 in bf16, each timed with its bound
     (``slice_kernel_cases``): the adapter and its backward at starcoder2-7b's
     D 4608 (the tile path's cluster of 16 blocks of 320 columns, the last
     owning none) and llama4's D 5120, at 2048 and 512 rows, and decode at T
     4; attention and its backward at starcoder2's GQA group of 9 (36 over 4
     heads of 128; ``bwd_parts`` 3 at 4 x 512, 9 at 1 x 512), olmoe's MHA
     (16 heads of 128) and llama4's group of 5 (40 over 8), beside SDPA and
     torch.autograd through SDPA;
  3. qwen2.5-3b at its published width (36 layers, d_model 2048, vocab 152064
     padded), random weights from a seed with non-zero adapters, served by
     ``BatchServer`` (4 slots, 8 requests of 64-512 prompt tokens, 32 new tokens
     each); the launch counters prove the path ran the kernels. The first batch
     is served again with ``impl="plain"``, in bf16 and in f32, and each of its
     blocks (prefill and every decode step) is held to its kernel version on the
     same input; the f32 prefill logits of the two paths are held to each other,
     beside the plain path's own gap from the CPU (another summation order);
     then training on the same weights (``phase_train``): batches of 4 x 512
     tokens from the port's corpus, six steps of ``make_train_step`` with the
     unfreeze depth walking 1, 2, 36 (interval 2). Before the steps the loss
     and the gradients of the kernel path are held against ``impl="plain"``
     at depths 1 and 2, with the frozen trunk on the kernels in both (so both
     get the same boundary input); at depth 36 the plain path's loss and
     gradient norm are printed beside the kernel path's, and the gradients
     are compared with the kernel path's with its backward kernels alone
     swapped for their plain versions, in bf16 (held at GRAD_RMS_RTOL)
     and in f32 (held at DEEP_F32_RMS_RTOL); each step's launch counters must be
     exactly 36 forward launches of each kernel, d of ``adapter_fused_bwd``
     and d - 1 of ``flash_attention_bwd`` for d hot layers, and the frozen
     layers' adapters and moments must stay bit-identical; the step time and
     peak memory at depths 1 and 36 are printed, and the peak of the forward
     and backward alone (the step's own peak is AdamW's), which must be lower
     at depth 1 than at depth 36 (the early stop's saving). Then stablelm-3b
     (the main path's arch: 32 layers, d_model 2560, 32 heads of 80, d_ff
     6912, vocab 50304) trains the same way at its published width, after
     qwen2.5-3b is freed: depths 1, 2, 32, the same held checks at depths 1
     and 2 and the same counters (32, 32, d, d - 1), without the depth-36
     witnesses. Then the session's one-device step as one CUDA graph per
     boundary (``phase_pjit_graph``): on fresh stablelm-3b weights,
     ``PjitBackend`` (warm-up on a side stream from a copy of the state,
     capture, replay) against the eager ``PjitBackend`` from the same
     weights on the same batches, two steps at depth 1 and two at 32, every
     step's metrics and every adapter, head, moment and the step count
     ``torch.equal``, the capture's launches at (L, d, L, d - 1) as the
     eager step's, a build launching the step twice from Python and a replay
     not at all, the frozen layers bit-identical and the top adapter moved;
     before the last step the graphed backend steps on other data and then
     ``load_state`` copies the eager backend's state into its tensors (a
     resume), whose addresses never change; each step's CUDA-event ms,
     host wall ms and peak, graphed beside eager. Then the paper's own
     model, mbert-squad (``phase_train_qa``: 12 layers, d_model 768, 12
     heads of 64, LayerNorm, learned positions, the span head [768, 2] and
     ``qa_span_loss``, adapter m 48, vocab 119547 padded), random weights
     from the seed with non-zero adapters, batches of 4 x 512 from the QA
     corpus: the loss and gradients held to ``impl="plain"`` at depth 1 as
     for the LM; at depth 2 (where this random model's gradients turn
     chaotic) the whole hot region in bf16 as a witness, the backward
     kernels alone in bf16 and the whole hot region in f32 held; at depth 12
     the backward kernels alone in bf16; then six graphed steps at depths
     1, 2, 12 against the eager backend as above, with EM and F1. Then the RingAda ring
     (``phase_ring``) on fresh stablelm-3b weights: four stages of 8
     layers, ``RingTrainer`` for three rounds with 3, 2 and 0 frozen stages
     (depths 8, 16, 32), each owner's data 4 microbatches of 1 x 512 tokens, lr ``RING_LR``. Before each round,
     owner 0's ring loss and gradients are held against the mean of the
     single-device step's (``training.loss_and_grads``) over its 4
     microbatches, each alone (the same shapes, so the same kernels), at
     TRAIN_LOSS_RTOL and GRAD_RMS_RTOL,
     and the frozen stages' gradients must be exact zeros; every owner
     iteration must launch exactly L M of each forward kernel, (L - b) M of
     ``adapter_fused_bwd`` and (L - b - 1) M of ``flash_attention_bwd`` (b
     frozen layers), and record ``pipeline_tick_counts``' ticks; after each
     round the frozen stages' adapters and moments are bit-identical and the
     top adapter has moved. Each round's wall ms, each iteration's ms, the
     round's peak and the ring round's forward-and-backward peak are printed.
     From the same weights and batches ``RingExecutor`` (the fused round, its
     own adapters, head and moments, the frozen backbone shared) runs each
     round from the trainer's state before it, through one CUDA graph per
     boundary (warm-up on a copy of the state, capture, replay), built on
     other tokens (the round's reversed) and undone, so the checked round is
     a replay on new tokens: each owner's loss is held to the trainer's at
     TRAIN_LOSS_RTOL, each hot adapter leaf's and the head's update (after -
     before) by RMS gap at GRAD_RMS_RTOL, and then the losses, the hot
     adapters, the head and their moments must equal the trainer's bit for
     bit (the same kernels on the same shapes); the frozen stages
     bit-identical, the launches the capture recorded (the graph's, which
     each replay launches and which the kernels line counts) at S times an
     iteration's, the build's eager warm-up and capture counting them twice
     and the replay not at all, the tick ledger at
     ``pipeline_tick_counts(packed=True)``; three more replays of the round
     from the same state are timed (host wall and CUDA events) and undone,
     and the capture seconds and the build's peak are printed. Then the
     heterogeneous ring of ``--device-speeds 1.0,1.25,0.5,0.75`` (spans of 9,
     12, 4 and 7 layers) the same way, for two rounds at depths 7 and 11.
     Then the frozen-trunk activation cache on fresh weights of the same
     ring (``phase_ring_cache``): a ``RingExecutor`` with a cache of 2
     entries walks batch slots 0, 1, 0, 1 at depths 8 and 16 (capture,
     capture, hit, hit at 3 and then 2 frozen stages, the drop invalidating
     the cache), each round against a direct ``RingExecutor`` seeded with
     its state before the round: the losses and every tensor a round writes
     equal (``torch.equal``), ``stats()`` after every round at its literal
     counts (4 hits, 4 misses, 1 invalidation, no eviction or bypass at the
     end), the graph each round replays holding the direct graph's launches
     (capture) or Phase B's alone ((L - b) M S of each forward kernel,
     cached), a build counting its graph's launches twice and a replay none,
     and the tick ledgers at ``pipeline_tick_counts`` (packed; cached); each
     round's device ms by CUDA events beside the direct round's, the
     buffer's bytes, the builds' seconds, the peak and reserved memory.
     Then one int8 round at 3 frozen stages (a capture, then the cached
     round) against the direct round from the same state, within the
     reference's calibrated 8e-2 (losses) and 2e-1 (parameters). Then the
     main path's facade, ``RingSession`` (``phase_ring_session``), on fresh
     weights of the same ring: a fused session runs 4 rounds (3, 3, 2, 2
     frozen stages), each round's losses equal to the bare executor's replay
     of the same batch from the same state (run before it and undone), its
     device and wall ms printed beside the bare replay's; it saves after
     round 2 under ``build/``, is freed, and ``RingSession.restore`` rebuilds
     it for rounds 3 and 4, whose losses and every trainable tensor must
     equal the uninterrupted run's (``torch.equal``). The same for a cached
     session on 2 slots (hits F, F, T, T; after the restore, captures) and
     for a pjit session (batches of 4 x 512, saved after step 2 of 4). The
     save and restore seconds and each checkpoint's bytes are printed, and
     every training kernel must have launched in each session. Then several
     tenants over one frozen trunk (``phase_ring_tenants``), on fresh weights
     of the same ring at 3 frozen stages: a fused joint session of 4 tenants
     runs 2 rounds, then each tenant's solo session on its own stream
     (``RingDataSource(tenant=k)``, one solo alive at a time), whose losses,
     adapters, head and moments must equal the joint session's slice
     (``torch.equal``) and whose graph holds a quarter of the joint graph's
     launches (the conveyor's ledger at ``T*S*M + F - 1`` ticks); the joint
     replay's event ms beside the solo replays', the joint and one solo
     session's resident and peak memory over the trunk, the capture
     seconds. Every tenant is saved to an ``AdapterStore`` under ``build/``
     (``TenantGroup.save_to``) and served by ``BatchServer`` through an
     ``AdapterRegistry`` (2 requests of 128 tokens a tenant, 8 new tokens):
     each graft equals the session's ``export_adapters``, the launch
     counters are the served path's, the tenants' prefill logits differ,
     and tenant 1's served blocks are held to their plain versions in bf16
     as phase 3 holds them. Then a cached joint session of 2 tenants on 2
     slots (capture, capture, hit, hit) against a direct joint executor
     seeded with its state before each round (``torch.equal``), then tenant
     1's ``import_adapters``, which frees its rows alone: the next round
     hits tenant 0 and recaptures tenant 1. Then the elastic ring
     (``phase_ring_elastic``), on fresh weights of the same ring at depth 8:
     a cached ``RingSession`` on 2 slots loses device 2 before round 2
     (spans 11, 11, 10, boundary 22) and takes it back before round 5 (4
     stages of 8, boundary 24 again), each of its 8 rounds ``torch.equal`` to
     a from-scratch ``RingExecutor`` at the live spans seeded with the state
     before it (the first round after the crash also to ``RingTrainer`` at S
     = 3), each graph's launches at L·M·S forward (Phase B's alone on a
     hit), d·M·S and (d − 1)·M·S backward, each round's event ms or capture
     seconds and allocated, peak and reserved memory printed, the first hit
     of each geometry replayed once more and timed, and the reserved memory
     after the rejoin's recapture within 2 GiB of that before the crash (no
     dropped graph's pool kept); then a fused joint session of 2 tenants
     loses device 1 before round 1, each round after it ``torch.equal`` to a
     from-scratch joint executor at the shrunk spans, every tenant's slice a
     contiguous, aligned view after the restack;
  4. rwkv6-7b at its published width (32 layers, d_model 4096, 64 heads of 64,
     vocab 65536), random weights from the seed with non-zero adapters, served
     by ``BatchServer`` as in phase 3 (qwen2.5-3b is freed first); the counters
     show ``rwkv_scan`` once per layer per batch (prefill) and ``adapter_fused``
     once per layer per step. The first batch is served again with
     ``impl="plain"`` in bf16 and f32, and each block and its new cache are
     held to their kernel version on the same input, and the f32 prefill
     logits of the two paths to each other, as in phase 3 (no CPU witness);
  5. hymba-1.5b at its published width (32 layers, d_model 1600, 25 query over
     5 KV heads of 64, SSM state 16, window 1024, 128 meta tokens that are
     also the attention sinks, vocab 32001 padded to 32256), random weights
     from the seed with non-zero adapters, served by ``BatchServer`` as in
     phase 3 (rwkv6-7b is freed first; the horizon counts the meta tokens);
     the counters show ``mamba_scan`` and ``flash_attention`` once per layer
     per batch (prefill) and ``adapter_fused`` once per layer per step. The
     first batch is served again with ``impl="plain"`` in bf16 and f32, and
     each block and its new cache (k, v, ssm, conv) are held to their kernel
     version on the same input, as in phase 4;
  6. starcoder2-7b at its published width and depth (32 layers, d_model
     4608, 36 query over 4 KV heads of 128, window 4096, a plain GELU MLP,
     vocab 49152), random weights from the seed with non-zero adapters,
     served and held as qwen2.5-3b in phase 3 (no CPU witness), then its
     loss and gradients held to ``impl="plain"`` at depths 1 and 2 as
     ``phase_train`` holds them, then six ``PjitBackend`` steps at depths 1,
     2, 32, graphed against eager as in ``phase_pjit_graph`` (every step
     ``torch.equal``, the launches at (L, d, L, d - 1));
  7. olmoe-1b-7b at its published width and depth (16 moe layers, d_model
     2048, 16 heads of 128, 64 experts top 8 of d_expert 1024 and the
     reference's shared expert, vocab 50304), served, held and trained as
     starcoder2-7b (at depth 2 layer 14's gradient passes through layer 15's
     router softmax, whose backward cancels over 64 nearly equal
     probabilities: there, as mbert-squad's depth 2 in ``phase_train_qa``,
     the whole hot region in bf16 is a witness, and the backward kernels
     alone in bf16 and the whole hot region in f32 are held), then as the
     ring as ``phase_ring`` runs stablelm-3b: 4
     stages of 4 layers, 4 microbatches of 1 x 512 tokens an owner, at 3, 2
     and 0 frozen stages, ``RingTrainer`` held to the single-device step and
     the fused ``RingExecutor``'s replays equal to ``RingTrainer`` bit for
     bit. A moe block held to its plain version (serving and gradients) has
     the plain path take the kernel path's experts (``PinnedRouting``): one
     ulp before a router can send a token to another expert; the share of
     tokens the plain path's own top-k would route elsewhere is printed and
     held below MOE_ROUTED_ELSEWHERE_MAX. The serving line prints the bytes
     of the experts a decode step reads (every E x C slot is computed, as
     the reference does) and their time at HBM's rate;
  8. moonshot-v1-16b-a3b at its published width, 4 of its 48 layers (64
     experts top 6 of d_expert 1408, vocab 163840): served and held, its
     gradients held at depth 1, two graphed steps at depth 4 against eager;
  9. llama4-maverick at its published width, one repeat of its (dense, moe)
     pattern (d_model 5120, 40 over 8 heads of 128, 128 experts top 1 of
     8192, vocab 202048; 18.5 B parameters, 37 GB in bf16): served and held
     in bf16 only (its f32 copy would not fit beside it), its gradients at
     depth 1 (the repeat: both layers hot, the dense layer's gradient
     through the moe block: the bf16 whole hot region a witness, the
     backward kernels alone held) and one eager step there. Each
     of phases 6-9 frees the card first.

The last four lines are the script's total seconds, a JSON object of
per-kernel measurements, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
    sys.exit(1)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils._pytree import tree_leaves, tree_map  # noqa: E402

from repro_torch import device as dev_rule  # noqa: E402
from repro_torch.api import AdapterStore, ExplicitPolicy, IntervalPolicy, RingSession  # noqa: E402
from repro_torch.api.backends import PjitBackend  # noqa: E402
from repro_torch.api.data import PjitDataSource, RingDataSource  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import pipeline as ring_pl  # noqa: E402
from repro_torch.core import training  # noqa: E402
from repro_torch.core.executor import RingExecutor  # noqa: E402
from repro_torch.core.partition import (frozen_stage_count, parse_device_profiles,  # noqa: E402
                                        spans_from_profiles)
from repro_torch.core.ring import RingTrainer  # noqa: E402
from repro_torch.core.unfreeze import (UnfreezeSchedule, boundary_schedule,  # noqa: E402
                                       depth_to_boundary)
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.kernels import adapter_fused as af  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.kernel_times import cold_ms, cuda_ms, graph_ms  # noqa: E402
from repro_torch.launch.serve import AdapterRegistry, BatchServer, Request  # noqa: E402
from repro_torch.launch.train import RING_LR, data_source, ring_data_source  # noqa: E402
from repro_torch.models import blocks, kvcache  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
BF16_FLOPS = 989e12              # dense bf16 tensor cores, published
FP32_FLOPS = 67e12               # fp32 outside the tensor cores, published
# The kernel path against the plain path in the served model. This random
# model (the reference's init) is chaotic over 36 layers: a last-digit change
# in one block grows to an O(0.1-1) change of the logits even in f32. The
# witness printed beside it is the plain path on the CPU, which sums in
# another order (PERF.md). So each block is held to its plain version on the
# same input, the plain path's activations of the served first batch, in
# prefill and in decode (rtol of the block output's largest entry: f32
# summation order; in bf16 a few ulps). The f32 logits of the two whole paths
# are held by the RMS of their difference, which must stay below half the
# logits' RMS: a wrong kernel gives about 1.4 RMS (unrelated logits), while
# the chaos moves a few logits most (the largest gap says less than the RMS).
# The bf16 logits are only printed: bf16 rounding alone moves them by more
# than a typical logit (the plain path against f32).
BLOCK_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}
LOGIT_RMS_FRACTION = 0.5
# Kernel against plain version: the absolute tolerances of tests/test_kernels.py
# (adapter 1e-5 f32 / 2e-2 bf16, attention 1e-5 / 3e-2). The bf16 adapter also
# allows one bf16 ulp of each output (rtol 2**-7): its fp32 sums run in another
# order, which can move h + up across a bf16 rounding boundary, and among the
# 4M random values of h [2048, 2048] some exceed 4, where one ulp is 0.031. It
# also allows one bf16 ulp of the up term (adapter_excess): the plain version
# rounds up to bf16 before the residual add, and fp32 sums in another order
# can land that rounding one ulp apart, which shows where h cancels a large up.
ATOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 3e-2)}  # (adapter, attention)
ADAPTER_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
# hymba-1.5b's attention (hd 64, 5 query heads per KV head) gives bf16 outputs
# above 4, where one bf16 ulp is 0.031: the plain version rounds the normalised
# probabilities to bf16 before PV (as the reference's jnp does) and the kernel
# the unnormalised exp(s - m), so the final rounding may land one ulp apart.
# Its bf16 cases also allow one bf16 ulp of each output (rtol 2**-7), as the
# adapter's.
HYMBA_ATTENTION_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
# rwkv_scan and mamba_scan against their plain versions: relative to the
# largest entry of each output. Both sum fp32 products in their own order
# along a serial recurrence, and at the served models' scale (rwkv: r, k, v of
# std ~8, decays near 1) the state and the outputs reach 1e3-1e5, where an
# absolute tolerance says nothing.
SCAN_RTOL = 1e-4
# Backward kernels against the plain backward on the same inputs: relative to
# each gradient's largest entry, 1e-4 in f32 (fp32 sums in another order) and
# 2**-7 in bf16 (one bf16 ulp of the largest entry; tests/test_torch_gpu.py),
# by the output's dtype: the adapter's fp32 mid and g_mid are held at 1e-4.
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
# The training step, kernel path against impl="plain" with the same frozen
# trunk (the kernels'), in bf16: the loss to 2**-7 relative (bf16's
# tolerance), each gradient leaf by the RMS of the difference over the RMS of
# the plain gradient, at most 2**-5: the hot blocks round activations to
# bf16 at other places (a wrong kernel gives about 1 or more).
TRAIN_LOSS_RTOL = 2.0 ** -7
GRAD_RMS_RTOL = 2.0 ** -5
# At full depth (36 for qwen2.5-3b, 32 for stablelm-3b), in f32, the backward
# kernels against their plain versions under one forward: ten times the f32
# kernels' 1e-4, for 35 blocks of backward in a chain whose gradients grow
# 1e6-fold (qwen2.5-3b; a wrong kernel gives about 1).
DEEP_F32_RMS_RTOL = 1e-3
# unfreeze depths 1, 2 and every layer, at interval 2; batches of 4 x 512
TRAIN_INTERVAL, TRAIN_B, TRAIN_S = 2, 4, 512
STABLELM_HEADS = (32, 32, 80)    # stablelm-3b's (query heads, KV heads, head_dim)
# mbert-squad (phase train_qa): the adapter's width and bottleneck, attention's
# heads (MHA at hd 64); six graphed steps at depths 1, 2, 12 (interval 2)
MBERT_D, MBERT_M, MBERT_HEADS = 768, 48, (12, 12, 64)
# the ring: four stages, 4 microbatches of 1 x 512 tokens per owner (the
# training phase's 4 x 512), the depth walking 8, 16, 32 (3, 2, 0 frozen
# stages), at the ring's lr (launch/train.py's RING_LR).
RING_S, RING_M, RING_DEPTHS = 4, 4, (8, 16, 32)
# the heterogeneous ring: the CLI's --device-speeds 1.0,1.25,0.5,0.75, which at
# 32 layers gives spans of 9, 12, 4 and 7, at depths 7 and 11 (3 and 2 frozen
# stages, both on the packed conveyor)
RING_SPEEDS, HETERO_DEPTHS = (1.0, 1.25, 0.5, 0.75), (7, 11)
# the activation cache on the same ring (phase_ring_cache): 2 batch slots and a
# cache of 2 entries, slots 0, 1, 0, 1 at depths 8 and 16 (3 and 2 frozen
# stages): capture, capture, hit, hit, then the drop and its invalidation; then
# one int8 round at depth 8, held to the direct round at the reference's
# calibrated tolerances (tests/test_packed.py: losses 8e-2, parameters 2e-1)
CACHE_SLOTS, CACHE_DEPTHS = 2, (8, 16)
INT8_LOSS_TOL, INT8_PARAM_TOL = 8e-2, 2e-1
# the session on the same ring (phase_ring_session): 4 rounds from depth 8 at
# an interval of 2 rounds (depth 9 after round 2, whose boundary rounds down to
# the span edge: 3, then 2 frozen stages), saved after round 2 and resumed; the
# cached session on 2 slots at an interval of 4 rounds (3 frozen stages:
# capture, capture, hit, hit); the pjit session at the training phase's
# batches, saved after step 2 of 4 (depths 1, 1, 2, 2). Checkpoints go under
# build/ (listed in .gitignore) and are removed once restored.
SESSION_ROUNDS, SESSION_SAVED_AT, SESSION_DEPTH = 4, 2, 8
SESSION_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "ring_session")
# several tenants on the same ring (phase_ring_tenants): a fused joint session
# of 4 tenants for 2 rounds at depth 8 (3 frozen stages) against each tenant's
# solo session; a cached joint session of 2 tenants on 2 slots (capture,
# capture, hit, hit, then tenant 1's import and a round that recaptures only
# it); the 4 tenants' bundles served, 2 requests each, 8 new tokens
TENANTS, TENANT_ROUNDS, CACHE_TENANTS = 4, 2, 2
TENANT_PROMPT, TENANT_NEW = 128, 8
# the elastic ring (phase_ring_elastic), fresh weights of the same ring at
# depth 8: a cached session on 2 slots loses device 2 before round 2 and takes
# it back before round 5, 8 rounds (4 stages of 8 at boundary 24, then spans
# 11, 11, 10 at boundary 22, then 4 of 8 at 24 again); then a fused joint
# session of 2 tenants loses device 1 before round 1, 3 rounds. Reserved
# memory after the rejoin's recapture may exceed that after the first
# captures at S = 4 by at most ELASTIC_POOL_SLACK_GIB (a dropped graph whose
# pool stayed reserved would add GiBs: three graphs reserve about 30 at full width)
ELASTIC_CHAOS, ELASTIC_ROUNDS = ("2:crash:2", "5:join:2"), 8
ELASTIC_TENANT_CHAOS, ELASTIC_TENANT_ROUNDS = "1:crash:1", 3
ELASTIC_POOL_SLACK_GIB = 2.0
# the slice's archs (phases 6-9): starcoder2-7b's adapter width and attention
# (36 query heads over 4 of 128: a GQA group of 9), olmoe-1b-7b's attention
# (MHA, 16 heads of 128, as moonshot's), llama4-maverick's width and
# attention (40 over 8: a group of 5). moonshot runs 4 of its 48 layers and
# llama4 one repeat of its (dense, moe) pattern (18.5 B parameters, 37 GB in
# bf16; its f32 copy would not fit beside it, so its holds are bf16 only).
# olmoe's ring: 4 stages of 4 layers at depths 4, 8, 16 (3, 2, 0 frozen
# stages), 4 microbatches of 1 x 512 tokens an owner, as phase_ring's.
STARCODER2_D, STARCODER2_HEADS = 4608, (36, 4, 128)
OLMOE_HEADS = (16, 16, 128)
LLAMA4_D, LLAMA4_HEADS = 5120, (40, 8, 128)
MOONSHOT_LAYERS, LLAMA4_LAYERS = 4, 2
# a moe block held to its plain version takes the kernel path's experts
# (PinnedRouting); the share of tokens the plain path's own top-k would route
# elsewhere is printed and held below a quarter: bf16 router logits tie and
# flip on an ulp, while a wrong kernel upstream routes most tokens elsewhere
MOE_ROUTED_ELSEWHERE_MAX = 0.25
OLMOE_RING_DEPTHS = (4, 8, 16)
SOURCES = {
    "adapter_fused": ("src/repro_torch/kernels/csrc/adapter_fused.cu",
                      "src/repro/kernels/adapter_fused.py:55"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:86"),
    "rwkv_scan": ("src/repro_torch/kernels/csrc/rwkv_scan.cu",
                  "src/repro/kernels/rwkv_scan.py:86"),
    "mamba_scan": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan.py:76"),
    # the backward of the TPU kernels above (which JAX differentiates through
    # its jnp path): in the same sources
    "adapter_fused_bwd": ("src/repro_torch/kernels/csrc/adapter_fused.cu",
                          "src/repro/kernels/adapter_fused.py:55"),
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:86"),
}
# Each kernel's time at its record's shape, the adapter's at decode (T = 4,
# bf16, by D), its bf16 tile path's at prefill and its bf16 backward's at the
# training shapes, before the present versions of adapter_fused,
# adapter_fused_bwd, flash_attention and rwkv_scan: copied from PERF.md
# section 6 (earlier chip runs, NVIDIA H100 80GB HBM3, 700 W; rwkv_scan's, the
# tile path's and the backward's CUDA-graph times, the others launches issued
# from Python) and printed on a line of their own, never as this run's numbers.
PREVIOUS_MS = {"adapter_fused": 0.0736, "flash_attention": 0.3453, "rwkv_scan": 0.2717,
               "mamba_scan": 0.2677, "adapter_fused_T4_D1600": 0.0356,
               "adapter_fused_T4_D2048": 0.0572, "adapter_fused_T4_D4096": 0.0672,
               "adapter_fused_tile_T2048_D2048": 0.0574, "adapter_fused_tile_T2048_D4096": 0.1243,
               "adapter_fused_tile_T2292_D1600": 0.0963,
               "adapter_fused_bwd_T2048_D2048": 0.2483, "adapter_fused_bwd_T2048_D2560": 0.3213}
CARD = ""                        # nvidia-smi's name and power limit, beside every time
PTXAS = {}                       # mangled function name -> ptxas's register and spill lines


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if len(out) > 1 else out[0]


def in_turns(plain, kernel):
    """(kernel ms on the device, kernel ms issued eagerly, plain ms issued
    eagerly): the device time from a CUDA graph; the eager times measured
    plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return graph_ms(kernel), (k1 + k2) / 2, (p1 + p2) / 2


# ---------------------------------------------------------------- phase 1
def phase_environment() -> None:
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    say("env", card=repr(CARD), torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=repr(nvcc), sms=torch.cuda.get_device_properties(0).multi_processor_count)
    t0 = time.perf_counter()
    build.build()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}",
        dir=os.path.relpath(build.BUILD_DIR, os.path.dirname(os.path.abspath(__file__))))
    for name, rec in build.LOG.items():
        fn = ""
        for line in rec["log"].splitlines():
            if "Function properties for " in line:
                fn = line.split("Function properties for ")[-1].strip()
            elif "registers" in line or "spill" in line:
                PTXAS.setdefault(fn, []).append(line.strip().removeprefix("ptxas info    : "))
                say("ptxas", kernel=name, function=_demangle(fn),
                    info=repr(line.strip().removeprefix("ptxas info    : ")))
    for dtype in (torch.bfloat16, torch.float32):
        for D in (1600, 2048, 4096):
            say("cluster_occupancy", T=4, D=D, m=64, dtype=str(dtype).removeprefix("torch."),
                cluster=af.CLUSTER, clusters=af.cluster_occupancy(4, D, 64, dtype))
    for T, D in ((2048, 2048), (808, 2048), (2048, 4096), (808, 4096), (2292, 1600),
                 (1320, 1600)):
        p = af.tile_plan(T, D, 64)
        say("tile_occupancy", T=T, D=D, m=64, dtype="bfloat16", rows=af.TILE_ROWS,
            cluster=p.cluster, smem=p.smem, clusters=af.tile_occupancy(p))
    for D in (2048, 2560):
        p = af.bwd_tile_plan(2048, D, 64)
        say("bwd_tile_occupancy", T=2048, D=D, m=64, dtype="bfloat16", rows=af.TILE_ROWS,
            cluster=p.cluster, smem=p.smem, clusters=af.bwd_tile_occupancy(p))


def _demangle(name: str) -> str:
    """A kernel's readable name, where the toolkit's c++filt is on the PATH."""
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if not name or tool is None:
        return repr(name)
    out = subprocess.run([tool, name], capture_output=True, text=True, timeout=60).stdout
    out = re.sub(r"\((?:int|bool)\)", "", out.strip())    # template arguments' casts
    return repr(out.replace("(anonymous namespace)::", "").split("(")[0])


# ---------------------------------------------------------------- phase 2
def adapter_path(T, D, m, dtype) -> str:
    """Which kernel the launcher runs: the decode path's cluster, the bf16
    tile path (tiles of 64 rows, blocks per cluster) or the 16-row CUDA-core
    kernel (h tile staged in shared memory, or rows read from device memory)."""
    kernel, p = af.route(T, D, m, dtype)
    if kernel == "cluster":
        return f"cluster{af.CLUSTER}"
    return f"tc_tile{af.TILE_ROWS}_c{p.cluster}" if kernel == "tile" else f"tile_{kernel}"


def adapter_ptxas(T, D, m, dtype) -> str:
    """ptxas's register and spill lines of the instantiation a shape runs."""
    kernel, p = af.route(T, D, m, dtype)
    key = {"cluster": "adapter_cluster_kernel", "tile": "adapter_tile_kernel",
           "staged": "adapter_fused_kernelI", "rows": "adapter_fused_kernelI"}[kernel]
    if kernel in ("staged", "rows"):
        te = "13__nv_bfloat16" if dtype == torch.bfloat16 else "f"
        key += f"{te}Lb{int(kernel == 'staged')}E"
    return "; ".join(info for fn, lines in PTXAS.items() if key in fn for info in lines)


def adapter_bwd_path(T, D, m, dtype) -> tuple:
    """Which backward kernel the launcher runs for a shape, with ptxas's
    register and spill lines: the bf16 tile path (tiles of 64 rows, blocks
    per cluster) or the 16-row CUDA-core kernel."""
    kernel, p = af.bwd_route(T, D, m, dtype)
    if kernel == "tile":
        path, key = f"tc_tile{af.TILE_ROWS}_c{p.cluster}", "adapter_bwd_tile_kernel"
    else:
        te = "13__nv_bfloat16" if dtype == torch.bfloat16 else "f"
        path, key = "tile16_cuda_cores", f"adapter_bwd_kernelI{te}E"
    return path, "; ".join(info for fn, lines in PTXAS.items() if key in fn for info in lines)


def adapter_excess(got, want, h, wd, wu, act, dtype) -> float:
    """The kernel's largest error beyond atol plus ADAPTER_RTOL of |out| and
    of |up|, the term the plain version rounds to h's type (<= 0: agrees)."""
    up = (ref.act(act, h.float() @ wd.float()) @ wu.float()).to(dtype).float()
    bound = ATOL[dtype][0] + ADAPTER_RTOL[dtype] * (want.float().abs() + up.abs())
    return ((got.float() - want.float()).abs() - bound).max().item()


def adapter_case(T, dtype, act, gen, record=None, D=2048, m=64):
    """Returns the kernel's ms."""
    h = torch.randn(T, D, generator=gen, device="cuda").to(dtype)
    wd = (0.05 * torch.randn(D, m, generator=gen, device="cuda")).to(dtype)
    wu = (0.05 * torch.randn(m, D, generator=gen, device="cuda")).to(dtype)
    got = ops.adapter_fused(h, wd, wu, activation=act)
    want = ops.adapter_fused(h, wd, wu, activation=act, impl="plain")
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    tol = ATOL[dtype][0]
    excess = adapter_excess(got, want, h, wd, wu, act, dtype)
    ms, eager_ms, plain_ms = in_turns(
        lambda: ops.adapter_fused(h, wd, wu, activation=act, impl="plain"),
        lambda: ops.adapter_fused(h, wd, wu, activation=act))
    size = h.element_size()
    nbytes = 2 * T * D * size + 2 * D * m * wd.element_size()
    # bf16: both products at the tensor-core rate (the least the card could
    # take); f32: on the CUDA cores, where the reference's fp32 products run
    rate = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_ops = 4 * T * D * m / rate
    t_bytes = nbytes / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    # a graph of launches on one h may find it in the 50 MB L2: below the
    # bytes bound, time it again over copies of h that exceed L2
    cold = cold_ms(lambda x: ops.adapter_fused(x, wd, wu, activation=act), h) \
        if ms < bound_ms else None
    share = bound_ms / max(ms, cold or 0.0)
    dt = str(dtype).removeprefix("torch.")
    path = adapter_path(T, D, m, dtype)
    say("adapter_fused", T=T, D=D, m=m, dtype=dt, act=act, path=path,
        max_abs_err=f"{err:.3g}", atol=tol, rtol=ADAPTER_RTOL[dtype], ms=f"{ms:.4f}",
        **({"cold_ms": f"{cold:.4f}"} if cold is not None else {}),
        eager_ms=f"{eager_ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.5f}",
        share_of_bound=f"{share:.3f}",
        **({"ptxas": repr(adapter_ptxas(T, D, m, dtype))} if T > af.SMALL_T else {}),
        card=repr(CARD))
    if not excess <= 0:
        raise AssertionError(f"adapter_fused disagrees with its plain version: max error "
                             f"{err}, {excess} beyond atol {tol} + rtol {ADAPTER_RTOL[dtype]} "
                             f"of |out| and |up|")
    if record is not None:
        record.update(max_abs_err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by="operations" if t_ops > t_bytes else "bytes",
                      library_ms=None, shape=f"h[{T},{D}] m={m} {act} {dt}", path=path,
                      **({"cold_ms": cold} if cold is not None else {}))
    return ms


def rwkv_case(N, S, hd, gen, state=False, record=None, strong=False):
    """At the served model's scale: r, k, v of std 8, log decays -exp(x) with
    x uniform in the decay prior's (-6, -0.5), u of std 0.5. ``strong`` takes
    x up to 3 (decays down to -e^3 = -20 a step, where a factorisation through
    e^{-ca} would overflow)."""
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    r, k, v = 8 * rnd(N, S, hd), 8 * rnd(N, S, hd), 8 * rnd(N, S, hd)
    top = 3.0 if strong else -0.5
    lw = -torch.exp(-6.0 + (top + 6.0) * torch.rand(N, S, hd, generator=gen, device="cuda"))
    u = 0.5 * rnd(N, 1, hd)
    s0 = 100 * rnd(N, hd, hd) if state else torch.zeros(N, hd, hd, device="cuda")
    out, sT = ops.rwkv_scan(r, k, v, lw, u, s0)
    want, wT = ops.rwkv_scan(r, k, v, lw, u, s0, impl="plain")
    torch.cuda.synchronize()
    errs = [(a - b).abs().max().item() / b.abs().max().item() for a, b in ((out, want), (sT, wT))]
    ms, eager_ms, plain_ms = in_turns(lambda: ops.rwkv_scan(r, k, v, lw, u, s0, impl="plain"),
                                      lambda: ops.rwkv_scan(r, k, v, lw, u, s0))
    # each input read once, each output written once; the recurrence's 5 hd^2
    # fp32 flops per step (r.S, and the decayed rank-one state update)
    nbytes = 4 * (5 * N * S * hd + N * hd + 2 * N * hd * hd)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 5 * N * S * hd * hd / FP32_FLOPS
    bound_ms = 1e3 * max(t_ops, t_bytes)
    ptxas = [info for fn, lines in PTXAS.items() if f"rwkv_scan_kernelILi{hd}E" in fn
             for info in lines]
    say("rwkv_scan", N=N, S=S, hd=hd, state0="random" if state else "zero",
        decays="strong" if strong else "prior",
        rel_err_out=f"{errs[0]:.3g}", rel_err_state=f"{errs[1]:.3g}", rtol=SCAN_RTOL,
        max_abs_out=f"{want.abs().max().item():.4g}", ms=f"{ms:.4f}",
        eager_ms=f"{eager_ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.5f}",
        mbytes=f"{nbytes / 1e6:.1f}", ptxas=repr("; ".join(ptxas)), card=repr(CARD))
    if not max(errs) <= SCAN_RTOL:
        raise AssertionError(f"rwkv_scan disagrees with its plain version: {errs} of the "
                             f"largest entries (rtol {SCAN_RTOL})")
    if record is not None:
        record.update(max_abs_err=max((out - want).abs().max().item(),
                                      (sT - wT).abs().max().item()),
                      max_rel_err=max(errs), ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by="operations" if t_ops > t_bytes else "bytes",
                      library_ms=None, shape=f"r/k/v/lw[{N},{S},{hd}] f32")


def attention_case(S, window, dtype, gen, record=None, heads=(16, 2, 128), n_sink=0,
                   rtol=None, B=4):
    """Causal prefill attention of B rows (4: a batch; 1: a ring microbatch);
    ``heads`` = (query heads, KV heads, head_dim): qwen2.5-3b's by default,
    hymba-1.5b's (25, 5, 64) with sinks. ``rtol`` (of each output, beside the
    absolute tolerance) defaults to 0. Returns the kernel's ms."""
    H, K, hd = heads
    q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, K, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, K, hd, generator=gen, device="cuda").to(dtype)
    kw = dict(window=window, n_sink=n_sink)
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q, k, v, impl="plain", **kw)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    tol, rtol = ATOL[dtype][1], rtol or 0.0
    excess = (diff - tol - rtol * want.float().abs()).max().item()
    ms, eager_ms, plain_ms = in_turns(lambda: ops.flash_attention(q, k, v, impl="plain", **kw),
                                      lambda: ops.flash_attention(q, k, v, **kw))
    i = torch.arange(S, device="cuda")
    seen = i[None, :] <= i[:, None]                   # the (query, key) pairs the mask keeps
    if window is not None:
        seen &= (i[:, None] - i[None, :] < window) | (i[None, :] < n_sink)
    # yardstick only: one PyTorch call computing the same function (never used by the port)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None:
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)
    else:
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=seen,
                                                      enable_gqa=True)
    lib_err = (sdpa().transpose(1, 2).float() - want.float()).abs().max().item()
    library_ms, library_eager_ms = graph_ms(sdpa), cuda_ms(sdpa)
    pairs = int(seen.sum())
    t_ops = 4 * B * H * hd * pairs / (BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
    t_bytes = 2 * (q.numel() + k.numel()) * q.element_size() / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    dt = str(dtype).removeprefix("torch.")
    say("flash_attention", B=B, H=H, K=K, hd=hd, S=S, window=window, n_sink=n_sink,
        dtype=dt, kernel=fa.kernel_for(q, k, v), max_abs_err=f"{err:.3g}", tol=tol, rtol=rtol,
        ms=f"{ms:.4f}", library_ms=f"{library_ms:.4f}", ms_per_library_ms=f"{ms / library_ms:.3f}",
        eager_ms=f"{eager_ms:.4f}", library_eager_ms=f"{library_eager_ms:.4f}",
        eager_ms_per_library_eager_ms=f"{eager_ms / library_eager_ms:.3f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.5f}",
        library_err=f"{lib_err:.3g}", card=repr(CARD))
    if not excess <= 0:
        raise AssertionError(f"flash_attention disagrees with its plain version: max error "
                             f"{err}, {excess} beyond atol {tol} + rtol {rtol}")
    if record is not None:
        record.update(max_abs_err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by="operations" if t_ops > t_bytes else "bytes",
                      library_ms=library_ms, library_eager_ms=library_eager_ms,
                      shape=f"q[{B},{S},{H},{hd}] kv[{B},{S},{K},{hd}] causal {dt}"
                            + (f" window {window} n_sink {n_sink}" if n_sink else ""),
                      kernel=fa.kernel_for(q, k, v))
    return ms


def edge_cases(gen) -> None:
    """Correctness only, no timing: the bf16 attention kernel at lengths around
    a tile, sinks ending inside a tile, Sk > Sq and q, k, v as strided views of
    a fused [B, S, 3, H, hd] tensor, at both GQA groups; the adapter at decode
    and tile row counts, every width, m, activation and dtype. One line each
    with the case count and the largest error beyond the tolerance (<= 0)."""
    worst, n = -1.0, 0
    for H, K, hd in ((16, 2, 128), (25, 5, 64), (8, 8, 80), (16, 2, 80)):
        for Sq, Sk, window, n_sink in [(S, S, None, 0) for S in (1, 7, 63, 65, 130, 573)] + [
                (65, 65, 128, 0), (573, 573, 128, 0), (130, 130, 128, 100),
                (573, 573, 128, 100), (37, 100, None, 0), (65, 200, 128, 0),
                (7, 300, 128, 100)]:
            qkv = torch.randn(2, Sk, 3, H, hd, generator=gen, device="cuda").to(torch.bfloat16)
            q, k, v = qkv[:, Sk - Sq:, 0], qkv[:, :, 1, :K], qkv[:, :, 2, :K]
            kw = dict(window=window, n_sink=n_sink)
            got = ops.flash_attention(q, k, v, **kw).float()
            want = ops.flash_attention(q, k, v, impl="plain", **kw).float()
            worst = max(worst, ((got - want).abs() - ATOL[torch.bfloat16][1]).max().item())
            n += 1
    say("flash_attention_edges", cases=n, dtype="bfloat16", worst_excess=f"{worst:.3g}")
    if not worst <= 0:
        raise AssertionError(f"flash_attention edge case beyond tolerance by {worst}")
    worst, n = -1.0, 0
    for dtype in (torch.bfloat16, torch.float32):
        for D in (256, 1600, 2048, 4096, 4608):
            for m in (16, 48, 64):
                wd = (0.05 * torch.randn(D, m, generator=gen, device="cuda")).to(dtype)
                wu = (0.05 * torch.randn(m, D, generator=gen, device="cuda")).to(dtype)
                for T in (1, 3, 4, 16, 17, 100):
                    h = torch.randn(T, D, generator=gen, device="cuda").to(dtype)
                    for act in ("gelu", "relu", "silu"):
                        got = ops.adapter_fused(h, wd, wu, activation=act).float()
                        want = ops.adapter_fused(h, wd, wu, activation=act, impl="plain").float()
                        worst = max(worst, adapter_excess(got, want, h, wd, wu, act, dtype))
                        n += 1
    say("adapter_fused_edges", cases=n, worst_excess=f"{worst:.3g}")
    if not worst <= 0:
        raise AssertionError(f"adapter_fused edge case beyond tolerance by {worst}")


def mamba_case(B, S, D, N, gen, record=None, state=False):
    """At the served model's scale: dt = softplus(x) of unit-normal x (as
    dt_lr @ dt_proj + dt_bias gives), log_a = dt * A with A = -(1..N) (the
    arange_log init), b = dt * B * x and c of unit-normal B, x and c; with
    ``state``, a start state of std 3 (a cache's ``ssm``), else none (zero)."""
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    dt = F.softplus(rnd(B, S, D))[..., None]
    log_a = (dt * -torch.arange(1, N + 1, device="cuda", dtype=torch.float32)).contiguous()
    b = (dt * rnd(B, S, 1, N) * rnd(B, S, D, 1)).contiguous()
    c = rnd(B, S, N)
    s0 = 3 * rnd(B, D, N) if state else None
    y, sT = ops.mamba_scan(log_a, b, c, s0)
    want, wT = ops.mamba_scan(log_a, b, c, s0, impl="plain")
    torch.cuda.synchronize()
    errs = [(a - w).abs().max().item() / w.abs().max().item() for a, w in ((y, want), (sT, wT))]
    ms, eager_ms, plain_ms = in_turns(lambda: ops.mamba_scan(log_a, b, c, s0, impl="plain"),
                                      lambda: ops.mamba_scan(log_a, b, c, s0))
    # log_a and b read once, c read once, the start state (if any) read once, y
    # and the state written once; about four fp32 flops per (b, t, d, n): exp,
    # the fma, the product with c, one add
    nbytes = 4 * (2 * B * S * D * N + B * S * N + B * S * D + (2 if state else 1) * B * D * N)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * B * S * D * N / FP32_FLOPS
    bound_ms = 1e3 * max(t_ops, t_bytes)
    say("mamba_scan", B=B, S=S, D=D, N=N, state0="random" if state else "none",
        rel_err_y=f"{errs[0]:.3g}",
        rel_err_state=f"{errs[1]:.3g}", rtol=SCAN_RTOL,
        max_abs_y=f"{want.abs().max().item():.4g}", ms=f"{ms:.4f}",
        eager_ms=f"{eager_ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.5f}",
        mbytes=f"{nbytes / 1e6:.1f}", card=repr(CARD))
    if not max(errs) <= SCAN_RTOL:
        raise AssertionError(f"mamba_scan disagrees with its plain version: {errs} of the "
                             f"largest entries (rtol {SCAN_RTOL})")
    if record is not None:
        record.update(max_abs_err=max((y - want).abs().max().item(),
                                      (sT - wT).abs().max().item()),
                      max_rel_err=max(errs), ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by="operations" if t_ops > t_bytes else "bytes",
                      library_ms=None, shape=f"log_a/b[{B},{S},{D},{N}] f32")


def _bwd_excess(got, want) -> float:
    """The largest error beyond BWD_RTOL of each output's largest entry, at the
    output's own dtype (<= 0: agrees)."""
    return max((a.float() - b.float()).abs().max().item()
               - BWD_RTOL[b.dtype] * b.float().abs().max().item() for a, b in zip(got, want))


def adapter_bwd_case(T, D, dtype, gen, record=None, act="gelu", m=64):
    """The adapter's backward kernel (dh, mid, g_mid) against the plain
    version of the same function, at the non-zero adapters of phase 2."""
    h = torch.randn(T, D, generator=gen, device="cuda").to(dtype)
    g = torch.randn(T, D, generator=gen, device="cuda").to(dtype)
    wd = (0.05 * torch.randn(D, m, generator=gen, device="cuda")).to(dtype)
    wu = (0.05 * torch.randn(m, D, generator=gen, device="cuda")).to(dtype)
    kernel = lambda: af.adapter_fused_bwd(g, h, wd, wu, activation=act)
    plain = lambda: ref.adapter_fused_bwd_terms(g, h, wd, wu, activation=act)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    excess = _bwd_excess(got, want)
    ms, eager_ms, plain_ms = in_turns(plain, kernel)
    # h and g read once, dh written once, the weights read once, mid and g_mid
    # written once (fp32); three thin products of 2 T D m flops each
    size = h.element_size()
    nbytes = 3 * T * D * size + 2 * D * m * size + 2 * T * m * 4
    rate = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_ops, t_bytes = 6 * T * D * m / rate, nbytes / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    dt = str(dtype).removeprefix("torch.")
    path, ptxas = adapter_bwd_path(T, D, m, dtype)
    say("adapter_fused_bwd", T=T, D=D, m=m, dtype=dt, act=act, path=path,
        max_abs_err=f"{err:.3g}", rtol_dh=BWD_RTOL[dtype],
        rtol_mid_g_mid=BWD_RTOL[torch.float32], ms=f"{ms:.4f}", eager_ms=f"{eager_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.5f}",
        share_of_bound=f"{bound_ms / ms:.3f}", ptxas=repr(ptxas), card=repr(CARD))
    if not excess <= 0:
        raise AssertionError(f"adapter_fused_bwd disagrees with its plain version: max error "
                             f"{err}, {excess} beyond rtol (dh {BWD_RTOL[dtype]}, the fp32 mid "
                             f"and g_mid {BWD_RTOL[torch.float32]}) of the largest entry")
    if record is not None:
        record.update(max_abs_err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by="operations" if t_ops > t_bytes else "bytes",
                      library_ms=None, shape=f"h,g[{T},{D}] m={m} {act} {dt}", path=path)


@functools.lru_cache(maxsize=None)
def yardstick_stream() -> torch.cuda.Stream:
    """The one side stream of every autograd_graph_ms: cuBLAS keeps a workspace
    for each stream it runs on, which would stay allocated through the
    training phase's memory readings, one for each new stream."""
    return torch.cuda.Stream()


def autograd_graph_ms(forward, inputs, grad_out, iters: int = 20, replays: int = 5) -> float:
    """graph_ms of torch.autograd.grad of ``forward(*inputs)`` (run once) with
    respect to its inputs: the backward alone, captured on the stream that ran
    the forward, since autograd runs each backward op on its forward op's
    stream; the inputs become new leaves there (a leaf first used on another
    stream would make that stream wait on the capture)."""
    stream = yardstick_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        leaves = [x.detach().requires_grad_(True) for x in inputs]
        out = forward(*leaves)
        grad = lambda: torch.autograd.grad(out, leaves, grad_out, retain_graph=True)
        for _ in range(3):
            grad()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(iters):
                grad()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def attention_bwd_case(S, window, dtype, gen, record=None, heads=(16, 2, 128), B=4):
    """The attention backward kernels on B rows of S tokens (causal) against
    the plain backward on the same inputs (the kernel forward's o and lse);
    the library yardstick is torch.autograd through SDPA, the backward alone,
    timed in a CUDA graph as the kernel is and eagerly."""
    H, K, hd = heads
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q, k, v, dout = rnd(B, S, H, hd), rnd(B, S, K, hd), rnd(B, S, K, hd), rnd(B, S, H, hd)
    out, lse = fa.flash_attention(q, k, v, window=window, lse=True)
    if not torch.equal(out, fa.flash_attention(q, k, v, window=window)):
        raise AssertionError("the forward with lse is not the served forward")
    kernel = lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, window=window)
    plain = lambda: ref.flash_attention_bwd(q, k, v, out, lse, dout, window=window)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    excess = _bwd_excess(got, want)
    ms, eager_ms, plain_ms = in_turns(plain, kernel)
    i = torch.arange(S, device="cuda")
    seen = i[None, :] <= i[:, None]
    if window is not None:
        seen &= i[:, None] - i[None, :] < window
    # yardstick only: torch.autograd through SDPA, the backward alone (never used by the port)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    mask = dict(is_causal=True) if window is None else dict(attn_mask=seen)
    sdpa = lambda *x: F.scaled_dot_product_attention(*x, enable_gqa=True, **mask)
    o, dot = sdpa(qt, kt, vt), dout.transpose(1, 2)
    library_eager_ms = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                                           retain_graph=True))
    library_ms = autograd_graph_ms(sdpa, (qt, kt, vt), dot)
    # q, k, v, o, dO read once, lse read once, dq, dk, dv written once; five
    # products of 2 hd flops per kept (query, key) pair and head: QK^T and
    # dO V^T recomputed, then dV, dK and dQ
    pairs = int(seen.sum())
    size = q.element_size()
    nbytes = size * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    rate = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_ops, t_bytes = 10 * B * H * hd * pairs / rate, nbytes / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    dt = str(dtype).removeprefix("torch.")
    parts = fa.bwd_parts(B, S, K, H // K, dev_rule.sm_count(q.device)) \
        if dtype == torch.bfloat16 else 1
    say("flash_attention_bwd", B=B, H=H, K=K, hd=hd, S=S, window=window, dtype=dt,
        kernel="tensor_cores" if dtype == torch.bfloat16 else "scalar", parts=parts,
        max_abs_err=f"{err:.3g}", rtol=BWD_RTOL[dtype], ms=f"{ms:.4f}",
        eager_ms=f"{eager_ms:.4f}", plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
        ms_per_library_ms=f"{ms / library_ms:.3f}", library_eager_ms=f"{library_eager_ms:.4f}",
        eager_ms_per_library_eager_ms=f"{eager_ms / library_eager_ms:.3f}",
        bound_ms=f"{bound_ms:.5f}", bound_by="operations" if t_ops > t_bytes else "bytes",
        card=repr(CARD))
    if not excess <= 0:
        raise AssertionError(f"flash_attention_bwd disagrees with its plain version: max error "
                             f"{err}, {excess} beyond rtol {BWD_RTOL[dtype]} of the largest entry")
    if record is not None:
        record.update(max_abs_err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by="operations" if t_ops > t_bytes else "bytes",
                      library_ms=library_ms, library_eager_ms=library_eager_ms,
                      library_timer="CUDA graph (torch.autograd.grad through SDPA)", parts=parts,
                      shape=f"q,dO[{B},{S},{H},{hd}] kv[{B},{S},{K},{hd}] causal {dt}"
                            + (f" window {window}" if window else ""))
    return ms


def phase_kernels(records) -> None:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    decode = {}
    decode[2048] = adapter_case(4, bf16, "gelu", gen)      # decode: T = batch
    adapter_case(2048, bf16, "gelu", gen, records["adapter_fused"])   # prefill 4 x 512
    adapter_case(2048, bf16, "relu", gen)
    adapter_case(2048, bf16, "silu", gen)
    adapter_case(2048, f32, "gelu", gen)
    attention_case(512, None, bf16, gen, records["flash_attention"])
    for S, window, dtype in ((300, None, bf16), (512, 128, bf16), (300, 128, bf16),
                             (512, None, f32), (300, 128, f32)):
        attention_case(S, window, dtype, gen)
    # stablelm-3b's prefill and training forward: hd 80, MHA
    for dtype in (bf16, f32):
        rec = records["flash_attention"].setdefault("stablelm_hd80", {})
        attention_case(512, None, dtype, gen, rec.setdefault(str(dtype)[6:], {}),
                       heads=STABLELM_HEADS)
    attention_case(300, 128, bf16, gen, heads=STABLELM_HEADS)
    # stablelm-3b's adapter at its width (training: h [4 x 512, 2560])
    adapter_case(2048, bf16, "gelu", gen,
                 records["adapter_fused"].setdefault("stablelm_D2560", {}), D=2560)
    # the ring's (phase_ring): one microbatch of 1 x 512 tokens a launch
    adapter_case(512, bf16, "gelu", gen,
                 records["adapter_fused"].setdefault("stablelm_ring_T512", {}), D=2560)
    attention_case(512, None, bf16, gen,
                   records["flash_attention"].setdefault("stablelm_ring_B1", {}),
                   heads=STABLELM_HEADS, B=1)
    # rwkv6-7b's width: the f32 h tile does not fit in shared memory
    for T in (4, 2048):
        for dtype in (bf16, f32):
            ms = adapter_case(T, dtype, "gelu", gen, D=4096)
            if (T, dtype) == (4, bf16):
                decode[4096] = ms
    # rwkv6-7b prefill: N = 4 rows x 64 heads, the served prompt lengths
    rwkv_case(256, 512, 64, gen, record=records["rwkv_scan"])
    rwkv_case(256, 445, 64, gen)
    rwkv_case(256, 202, 64, gen, state=True)
    rwkv_case(64, 300, 32, gen, state=True)
    # the chunked kernel's edges: decays down to -20 a step, and S around and
    # below its chunk of 16 steps
    rwkv_case(256, 512, 64, gen, state=True, strong=True)
    for S in (1, 7, 33):
        rwkv_case(64, S, 64, gen, state=True)
    rwkv_case(16, 33, 16, gen, state=True, strong=True)
    rwkv_case(16, 7, 8, gen, state=True)
    # hymba-1.5b: the adapter at D = 1600 (decode; prefill 4 x 573), the scan at
    # trace_serve's prefill (128 meta + 512) and the served batches, and
    # attention with 128 sinks where they matter (S 2048, window 1024)
    decode[1600] = adapter_case(4, bf16, "gelu", gen, D=1600)
    adapter_case(2292, bf16, "gelu", gen, D=1600)
    adapter_case(2292, f32, "gelu", gen, D=1600)
    # the bf16 tile path at the served batches' prefills (4 x 202 and 4 x 445
    # for qwen2.5-3b and rwkv6-7b; 4 x 330 and 4 x 573 with hymba's meta tokens)
    for T, D in ((808, 2048), (1780, 2048), (808, 4096), (1780, 4096), (1320, 1600)):
        adapter_case(T, bf16, "gelu", gen, D=D)
    mamba_case(4, 640, 1600, 16, gen, record=records["mamba_scan"])
    mamba_case(4, 573, 1600, 16, gen)
    mamba_case(4, 330, 1600, 16, gen)
    mamba_case(2, 37, 256, 8, gen)
    mamba_case(3, 9, 40, 32, gen)
    mamba_case(4, 330, 1600, 16, gen, state=True)     # a cache's start state
    sinks = {}
    for dtype in (bf16, f32):
        hymba = dict(heads=(25, 5, 64), rtol=HYMBA_ATTENTION_RTOL[dtype])
        ms = attention_case(2048, 1024, dtype, gen, n_sink=128, **hymba)
        sinks[str(dtype).removeprefix("torch.")] = {
            "ms": ms, "no_sink_ms": attention_case(2048, 1024, dtype, gen, **hymba)}
        attention_case(573, 1024, dtype, gen, n_sink=128, **hymba)     # served prefill
        attention_case(300, 128, dtype, gen, n_sink=100, **hymba)      # sinks in a part tile
    records["flash_attention"]["sinks_S2048_w1024_n128"] = sinks
    records["adapter_fused"]["decode_T4_bf16"] = {
        f"D{D}": {"ms": ms, "path": adapter_path(4, D, 64, bf16)}
        for D, ms in sorted(decode.items())}
    edge_cases(gen)
    # the backward kernels (training), at qwen2.5-3b's training shapes
    adapter_bwd_case(2048, 2048, bf16, gen, records["adapter_fused_bwd"])
    adapter_bwd_case(2048, 2048, f32, gen)
    adapter_bwd_case(2048, 2560, bf16, gen,                      # stablelm-3b's width
                     records["adapter_fused_bwd"].setdefault("stablelm_D2560", {}))
    for act in ("relu", "silu"):
        adapter_bwd_case(300, 1000, bf16, gen, act=act)
    adapter_bwd_case(2047, 2560, bf16, gen)                      # a ragged last tile
    adapter_bwd_case(512, 2560, bf16, gen,                       # the ring's microbatch
                     records["adapter_fused_bwd"].setdefault("stablelm_ring_T512", {}))
    attention_bwd_case(512, None, bf16, gen, records["flash_attention_bwd"])
    attention_bwd_case(512, None, f32, gen)
    rec = records["flash_attention_bwd"].setdefault("stablelm_hd80", {})
    for dtype in (bf16, f32):
        attention_bwd_case(512, None, dtype, gen, rec.setdefault(str(dtype)[6:], {}),
                           heads=STABLELM_HEADS)
    attention_bwd_case(512, None, bf16, gen,                     # the ring's microbatch
                       records["flash_attention_bwd"].setdefault("stablelm_ring_B1", {}),
                       heads=STABLELM_HEADS, B=1)
    attention_bwd_case(512, 128, bf16, gen, heads=(16, 2, 64))
    attention_bwd_case(300, 128, f32, gen, heads=(25, 5, 64))
    attention_bwd_case(331, 96, bf16, gen, heads=(16, 2, 80))
    # mbert-squad's training shapes (phase train_qa): h [4 x 512, 768], m 48 (a
    # bf16 cluster of 8 blocks of 128 columns: 2 own none), attention [4, 512,
    # 12, 64] in MHA, forward and backward, bf16 (recorded) and f32
    for dtype in (bf16, f32):
        dt = str(dtype)[6:]
        adapter_case(2048, dtype, "gelu", gen,
                     records["adapter_fused"].setdefault("mbert_D768_m48", {}).setdefault(dt, {}),
                     D=MBERT_D, m=MBERT_M)
        adapter_bwd_case(2048, MBERT_D, dtype, gen,
                         records["adapter_fused_bwd"].setdefault("mbert_D768_m48", {})
                         .setdefault(dt, {}), m=MBERT_M)
        attention_case(512, None, dtype, gen,
                       records["flash_attention"].setdefault("mbert_hd64_mha", {})
                       .setdefault(dt, {}), heads=MBERT_HEADS)
        attention_bwd_case(512, None, dtype, gen,
                           records["flash_attention_bwd"].setdefault("mbert_hd64_mha", {})
                           .setdefault(dt, {}), heads=MBERT_HEADS)
    for act in ("relu", "silu"):
        adapter_case(2048, bf16, act, gen, D=MBERT_D, m=MBERT_M)
        adapter_bwd_case(2048, MBERT_D, bf16, gen, act=act, m=MBERT_M)
    for T in (1, 100, 512):                                      # decode cluster and ragged tiles
        adapter_case(T, bf16, "gelu", gen, D=MBERT_D, m=MBERT_M)
        adapter_bwd_case(T, MBERT_D, bf16, gen, m=MBERT_M)
    slice_kernel_cases(records, gen)


def slice_kernel_cases(records, gen) -> None:
    """The shapes of the slice's archs (phases 6-9), bf16, each timed with its
    bound: the adapter at starcoder2-7b's D 4608 (the tile path's cluster of
    16 with 320 columns a block: block 14 owns 128, block 15 none; decode's
    cluster 288 columns a block) and llama4's D 5120 (16 blocks of 320),
    forward and backward at a step's 4 x 512 rows and a ring microbatch's
    512, and decode at T 4; attention forward and backward at starcoder2's
    GQA group of 9 (4 x 512: ``bwd_parts`` 3; 1 x 512: 9), olmoe's MHA at
    hd 128 and llama4's group of 5 (their windows, 4096 and 8192, exceed 512
    tokens: causal), beside SDPA and torch.autograd through SDPA."""
    bf16 = torch.bfloat16
    decode = records["adapter_fused"]["decode_T4_bf16"]
    for name, D in (("starcoder2", STARCODER2_D), ("llama4", LLAMA4_D)):
        fwd = records["adapter_fused"].setdefault(f"{name}_D{D}", {})
        bwd = records["adapter_fused_bwd"].setdefault(f"{name}_D{D}", {})
        for T in (2048, 512):
            adapter_case(T, bf16, "gelu", gen, fwd.setdefault(f"T{T}", {}), D=D)
            adapter_bwd_case(T, D, bf16, gen, bwd.setdefault(f"T{T}", {}))
        decode[f"D{D}"] = {"ms": adapter_case(4, bf16, "gelu", gen, D=D),
                           "path": adapter_path(4, D, 64, bf16)}
    for name, heads, rows in (("starcoder2", STARCODER2_HEADS, (4, 1)),
                              ("olmoe", OLMOE_HEADS, (4,)), ("llama4", LLAMA4_HEADS, (4,))):
        for B in rows:
            key = f"{name}_B{B}"
            attention_case(512, None, bf16, gen, records["flash_attention"].setdefault(key, {}),
                           heads=heads, B=B)
            attention_bwd_case(512, None, bf16, gen,
                               records["flash_attention_bwd"].setdefault(key, {}),
                               heads=heads, B=B)


# ---------------------------------------------------------------- phases 3 and 4
def count_launches(records, arch: str, launches) -> None:
    """Add one main path's launch counts to the kernel records."""
    for name, n in launches.items():
        records[name]["launches"] = records[name].get("launches", 0) + n
        records[name].setdefault("launches_by_path", {})[arch] = n


def served_config(arch: str, layers=None):
    """The architecture at its published width, with non-zero adapters;
    ``layers`` cuts the depth to that many layers (whole pattern repeats)."""
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers, repeats=layers // cfg.layers_per_repeat)
    return dataclasses.replace(cfg, adapter=dataclasses.replace(cfg.adapter, zero_init_up=False))


def phase_serve(arch: str, records, cpu_witness: bool, layers=None, f32: bool = True):
    """Returns the served parameters. ``layers`` cuts the depth (a whole
    number of pattern repeats); without ``f32`` the blocks are held in bf16
    only (a model whose f32 copy does not fit beside it)."""
    cfg = served_config(arch, layers)
    t0 = time.perf_counter()
    params = prm.materialize(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    say("materialize", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.padded_vocab, params=n_params, seconds=f"{time.perf_counter() - t0:.2f}",
        gib_on_card=f"{torch.cuda.memory_allocated() / 2**30:.2f}")

    rng = np.random.default_rng(SEED)
    max_new, slots = 32, 4
    lens = rng.integers(64, 513, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in lens]
    horizon = tfm.n_meta(cfg) + 512 + max_new + 8          # hymba: 128 meta tokens first
    requests = lambda: [Request(i, p, max_new) for i, p in enumerate(prompts)]

    BatchServer(cfg, params, slots=slots, horizon=horizon, device="cuda").run(
        requests()[:slots], log=lambda *a: None)           # warm-up: cuBLAS, allocator

    server = BatchServer(cfg, params, slots=slots, horizon=horizon, device="cuda")
    ops.reset_launches()
    t0 = time.perf_counter()
    results = server.run(requests(), log=lambda *a: None)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)

    n_batches = len(server.batches)
    if sorted(results) != list(range(8)) or any(len(v) != max_new for v in results.values()):
        raise AssertionError(f"not every request got {max_new} tokens")
    # adapter: every layer, every step; the sequence kernels of each block kind:
    # every layer, once per batch (prefill)
    kinds = {kind for kind, _ in cfg.pattern}
    per_prefill = cfg.n_layers * n_batches
    want = {"adapter_fused": cfg.n_layers * max_new * n_batches,
            "flash_attention": per_prefill if kinds & {"dense", "moe", "hymba"} else 0,
            "mamba_scan": per_prefill if "hymba" in kinds else 0,
            "rwkv_scan": per_prefill if "rwkv" in kinds else 0,
            "adapter_fused_bwd": 0, "flash_attention_bwd": 0}
    if launches != want:
        raise AssertionError(f"launch counters {launches} != expected {want}")
    count_launches(records, cfg.name, launches)

    prefill_ms = [1e3 * b["prefill_s"] for b in server.batches]
    decode_ms = [1e3 * b["decode_s"] / b["decode_steps"] for b in server.batches]
    tokens = sum(len(v) for v in results.values())
    say("serve", arch=cfg.name, requests=len(results), batches=n_batches,
        prompt_lens=list(map(int, lens)), new_tokens=tokens,
        launches=json.dumps(launches).replace(" ", ""))
    # a moe layer computes all E C slots in decode (the reference's dispatch),
    # so each step reads every expert's weights: their bytes over HBM's rate
    # bound a decode step from below
    n_moe = sum(c for k, c in cfg.pattern if k == "moe") * cfg.repeats
    expert_bytes = n_moe * sum(math.prod(prm.moe_defs(cfg)[k].shape) for k in
                               ("we_gate", "we_up", "we_down")) * 2 if n_moe else 0
    say("serve_time", arch=cfg.name, prefill_ms=[f"{x:.2f}" for x in prefill_ms],
        decode_ms_per_step=[f"{x:.3f}" for x in decode_ms],
        tokens_per_s=f"{tokens / wall:.1f}", wall_s=f"{wall:.3f}",
        **({"expert_gb_per_decode_step": f"{expert_bytes / 1e9:.2f}",
            "expert_bound_ms_per_decode_step": f"{1e3 * expert_bytes / HBM_BYTES_PER_S:.3f}"}
           if n_moe else {}), card=repr(CARD))

    V = cfg.vocab_size                                  # the pad logits are -1e30
    first = requests()[:slots]
    plain, plain_results, gaps16, routed16 = _plain_run(cfg, params, first, horizon)
    k16 = server.batches[0]["prefill_logits"][:, :V].float()
    p16 = plain.batches[0]["prefill_logits"][:, :V].float()
    if not torch.isfinite(k16).all() or k16.shape != (slots, V):
        raise AssertionError(f"prefill logits: shape {tuple(k16.shape)} or non-finite values")

    gap = lambda a, b: (a - b).abs().max().item()
    rms = lambda x: x.square().mean().sqrt().item()
    held = [(torch.bfloat16, gaps16)]
    witness, routing = {}, {"bf16_routed_elsewhere": routed16} if routed16 is not None else {}
    if f32:
        # the same weights in f32 (bf16 -> f32 is exact): prefill and one decode step
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = tree_map(lambda t: t.float(), params)
        two = [Request(r.rid, r.prompt, 2) for r in first]
        kernel32 = BatchServer(cfg32, params32, slots=slots, horizon=horizon, device="cuda")
        kernel32.run(two, log=lambda *a: None)
        plain32, _, gaps32, routed32 = _plain_run(cfg32, params32, two, horizon)
        k32 = kernel32.batches[0]["prefill_logits"][:, :V].float()
        p32 = plain32.batches[0]["prefill_logits"][:, :V].float()
        held.insert(0, (torch.float32, gaps32))
        if routed32 is not None:
            routing["f32_routed_elsewhere"] = routed32
        if cpu_witness:
            # witness of the chaos: the plain path on the CPU sums in another order
            params_cpu = tree_map(lambda t: t.cpu(), params32)
            del params32
            t0 = time.perf_counter()
            cpu32 = BatchServer(cfg32, params_cpu, slots=slots, horizon=horizon, impl="plain",
                                device="cpu")
            cpu32.run([Request(r.rid, r.prompt, 1) for r in first], log=lambda *a: None)
            c32 = cpu32.batches[0]["prefill_logits"][:, :V].float().to("cuda")
            witness = {"f32_plain_vs_cpu_plain_rms": f"{rms(p32 - c32):.4g}",
                       "f32_plain_vs_cpu_plain_max": f"{gap(p32, c32):.4g}",
                       "cpu_s": f"{time.perf_counter() - t0:.1f}"}
            del params_cpu

    short = {torch.float32: "f32", torch.bfloat16: "bf16"}
    say("blocks_vs_plain", arch=cfg.name,
        **{f"{short[dt]}_{mode}": f"{g:.3g}" for dt, gaps in held for mode, g in gaps.items()},
        **{k: f"{v:.4f}" for k, v in routing.items()},
        **{f"{short[dt]}_rtol": BLOCK_RTOL[dt] for dt, _ in held})
    if f32:
        say("prefill_logits", arch=cfg.name, f32_kernel_vs_plain_rms=f"{rms(k32 - p32):.4g}",
            tol=f"{LOGIT_RMS_FRACTION * rms(p32):.4g}", rms_logit=f"{rms(p32):.4g}",
            f32_kernel_vs_plain_max=f"{gap(k32, p32):.4g}",
            max_abs_logit=f"{p32.abs().max().item():.4g}",
            bf16_kernel_vs_plain=f"{gap(k16, p16):.4g}", bf16_plain_vs_f32=f"{gap(p16, p32):.4g}",
            same_argmax=f"{int((k16.argmax(-1) == p16.argmax(-1)).sum())}/{slots}",
            same_tokens=f"{sum(results[i] == plain_results[i] for i in plain_results)}/{slots}",
            **witness)
    for dtype, gaps in held:
        if set(gaps) != {"prefill", "step", "prefill_cache", "step_cache"}:
            raise AssertionError(f"the block check saw modes {sorted(gaps)}")
        for mode, g in gaps.items():
            if not g <= BLOCK_RTOL[dtype]:
                raise AssertionError(f"a {dtype} {mode} block of {cfg.name} differs from its "
                                     f"plain version by {g} of its output "
                                     f"(rtol {BLOCK_RTOL[dtype]})")
    bad = {k: v for k, v in routing.items() if not v <= MOE_ROUTED_ELSEWHERE_MAX}
    if bad:
        raise AssertionError(f"{cfg.name}: the plain path's own top-k routes {bad} of the tokens "
                             f"elsewhere (at most {MOE_ROUTED_ELSEWHERE_MAX})")
    if f32 and not rms(k32 - p32) <= LOGIT_RMS_FRACTION * rms(p32):
        raise AssertionError(f"{cfg.name} f32 prefill logits: kernel path {rms(k32 - p32)} "
                             f"(RMS) from the plain path, beyond {LOGIT_RMS_FRACTION} x "
                             f"their RMS {rms(p32)}")
    return params


# ---------------------------------------------------------------- training
def _grad_check(cfg, params, batch, boundary, *, backward_only=False, gate=True,
                rtol=None) -> dict:
    """The loss and gradients of the kernel path against impl="plain" on one
    batch. The frozen trunk runs on the kernels in both (blocks that run with
    no gradient), so both hot regions start from the same boundary input: the
    random model is chaotic, and a last-digit change below would otherwise
    reach the gradients. A moe block of the plain path takes the kernel
    path's experts (``PinnedRouting``). With ``backward_only`` the plain path is the kernel
    path with each backward kernel swapped for its plain version (the same
    forward, bit for bit): this holds the chain of backward launches alone,
    at any depth. Without ``gate`` only a non-finite loss fails: the line is
    a witness (both paths' gradient norms), for a hot region so deep that
    the chaotic forward separates the paths. ``rtol``: the gradients' RMS
    gap held (GRAD_RMS_RTOL by default)."""
    rtol = GRAD_RMS_RTOL if rtol is None else rtol
    pin = PinnedRouting()
    with pin:
        lk, _, gk = training.loss_and_grads(params, batch, cfg, boundary, impl="kernel")
    real = tfm.apply_block, af.adapter_fused_bwd, fa.flash_attention_bwd

    def trunk_on_kernels(kind, cfg, p, h, ctx, cache=None):
        if not torch.is_grad_enabled():
            ctx = dataclasses.replace(ctx, impl="kernel")
        return real[0](kind, cfg, p, h, ctx, cache)

    if backward_only:
        af.adapter_fused_bwd, fa.flash_attention_bwd = (ref.adapter_fused_bwd_terms,
                                                        ref.flash_attention_bwd)
    else:
        tfm.apply_block = trunk_on_kernels
    try:
        pin.mode = "pin"
        with pin:
            lp, _, gp = training.loss_and_grads(params, batch, cfg, boundary,
                                                impl="kernel" if backward_only else "plain")
    finally:
        tfm.apply_block, af.adapter_fused_bwd, fa.flash_attention_bwd = real
    rms = lambda x: x.float().square().mean().sqrt().item()
    leaves = {"head": (gk["head"]["w"], gp["head"]["w"])}
    for i, (a, b) in enumerate(zip(gk["adapters"], gp["adapters"])):
        for name in ("w_down", "w_up"):
            leaves[f"L{cfg.n_layers - len(gk['adapters']) + i}.{name}"] = (a[name], b[name])
    gaps = {name: rms(a.float() - b.float()) / rms(b) for name, (a, b) in leaves.items()}
    norm = lambda g: math.sqrt(sum(t.float().square().sum().item() for t in tree_leaves(g)))
    loss_gap = abs(lk.item() - lp.item()) / abs(lp.item())
    worst = max(gaps, key=gaps.get)
    say("train_vs_plain", boundary=boundary, depth=len(gk["adapters"]),
        plain="backward kernels only" if backward_only else "whole hot region",
        loss_kernel=f"{lk.item():.5f}", loss_plain=f"{lp.item():.5f}",
        loss_rel_gap=f"{loss_gap:.3g}", loss_rtol=TRAIN_LOSS_RTOL if gate else "none (witness)",
        grad_norm_kernel=f"{norm(gk):.6g}", grad_norm_plain=f"{norm(gp):.6g}",
        worst_leaf=worst, worst_gap=f"{gaps[worst]:.3g}",
        dtype=cfg.dtype, grad_rms_rtol=rtol if gate else "none (witness)",
        **({"moe_routed_elsewhere": f"{pin.share():.4f}"} if pin.share() is not None else {}),
        grad_rms_gaps=json.dumps({k: float(f"{v:.3g}") for k, v in gaps.items()}).replace(" ", ""))
    if not (torch.isfinite(lk) and torch.isfinite(lp)):
        raise AssertionError(f"train loss: kernel {lk.item()}, plain {lp.item()}")
    if not gate:
        return gaps
    if not loss_gap <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train loss: kernel {lk.item()} against plain {lp.item()}")
    bad = {k: v for k, v in gaps.items() if not v <= rtol}
    if bad or not all(rms(b) > 0 for _, b in leaves.values()):
        raise AssertionError(f"gradients of the kernel path differ from the plain path's: {bad}")
    return gaps


def phase_train(arch: str, params, records) -> None:
    """Six train steps of the served weights at full width, the unfreeze depth
    walking down (1, 2, every layer, at TRAIN_INTERVAL), through
    make_train_step, after the kernel path's loss and gradients are held
    against the plain path's at each depth."""
    cfg = served_config(arch)
    tc = TrainConfig(batch_size=TRAIN_B, seq_len=TRAIN_S, seed=SEED)
    t0 = time.perf_counter()
    data = data_source(cfg, tc)
    say("train_data", arch=cfg.name, batch=TRAIN_B, seq_len=TRAIN_S,
        seconds=f"{time.perf_counter() - t0:.2f}")
    depths = (1, 2, cfg.n_layers)
    sched = UnfreezeSchedule(depths=depths, interval=TRAIN_INTERVAL)
    steps = TRAIN_INTERVAL * len(depths)
    segs = boundary_schedule(cfg, sched, steps)
    batches = [to_device(data.next(), "cuda") for _ in range(steps)]
    # the kernel path against the plain one before any step: at depths 1 and 2
    # held. At full depth the whole hot region's plain path is a witness (its
    # gradient norm beside the kernel path's), and the backward kernels alone
    # swapped for their plain versions are held; both in bf16, then in f32,
    # where the chain's own rounding is 2**16 times smaller
    for _, _, boundary in segs[:2]:
        _grad_check(cfg, params, batches[0], boundary)
    deep = segs[-1][2]
    _grad_check(cfg, params, batches[0], deep, gate=False)
    # held at GRAD_RMS_RTOL: the attention backward's dS goes to the tensor
    # cores as bf16 hi + lo halves; rounded once to bf16 it held BWD_RTOL in
    # each call but not this over qwen2.5-3b's 35 blocks (PERF.md)
    _grad_check(cfg, params, batches[0], deep, backward_only=True)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    _grad_check(cfg32, params32, batches[0], deep, gate=False)
    _grad_check(cfg32, params32, batches[0], deep, backward_only=True, rtol=DEEP_F32_RMS_RTOL)
    del params32
    gc.collect()
    torch.cuda.empty_cache()

    opt = adamw.init(training.full_trainable(params, cfg))
    launches = {name: 0 for name in ops.LAUNCHES}
    timing = {}
    for start, end, boundary in segs:
        step = training.make_train_step(cfg, tc, boundary)
        n_frozen = boundary * cfg.layers_per_repeat
        d = cfg.n_layers - n_frozen
        for s in range(start, end):
            # the frozen layers' adapters and moments, and the top adapter (hot)
            clone = lambda tree: {k: t.clone() for k, t in tree.items()}
            frozen = [(clone(params["blocks"][i]["adapter"]), clone(opt["m"]["adapters"][i]),
                       clone(opt["v"]["adapters"][i])) for i in range(n_frozen)]
            top = clone(params["blocks"][-1]["adapter"])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batches[s])
            loss = metrics["loss"].item()                       # waits for the step
            wall = time.perf_counter() - t0
            got = dict(ops.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            want = {"adapter_fused": cfg.n_layers, "adapter_fused_bwd": d,
                    "flash_attention": cfg.n_layers, "flash_attention_bwd": d - 1,
                    "mamba_scan": 0, "rwkv_scan": 0}
            say("train_step", step=s, depth=d, boundary=boundary, loss=f"{loss:.5f}",
                grad_norm=f"{metrics['grad_norm'].item():.4g}", step_ms=f"{1e3 * wall:.2f}",
                peak_gib=f"{peak / 2**30:.3f}", launches=json.dumps(got).replace(" ", ""),
                card=repr(CARD))
            if got != want:
                raise AssertionError(f"step {s} launch counters {got} != expected {want}")
            if not math.isfinite(loss):
                raise AssertionError(f"step {s}: loss {loss}")
            for i, trees in enumerate(frozen):
                now = (params["blocks"][i]["adapter"], opt["m"]["adapters"][i],
                       opt["v"]["adapters"][i])
                if not all(torch.equal(a[k], b[k]) for a, b in zip(now, trees) for k in a):
                    raise AssertionError(f"step {s}: frozen layer {i} moved")
            if all(torch.equal(params["blocks"][-1]["adapter"][k], t) for k, t in top.items()):
                raise AssertionError(f"step {s}: the top adapter did not move")
            for name, n in got.items():
                launches[name] += n
            timing[d] = {"step_ms": 1e3 * wall, "peak_gib": peak / 2**30}
        # the forward and backward alone (the step's peak is AdamW's, over the
        # head's 311 M parameters): the early stop's memory, in the card's numbers
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        training.loss_and_grads(params, batches[0], cfg, boundary)
        timing[d].update(resident_gib=resident / 2**30,
                         fwd_bwd_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    count_launches(records, f"{cfg.name}_train", launches)
    say("train_time", arch=cfg.name, batch=TRAIN_B, seq_len=TRAIN_S,
        **{f"depth{d}_step_ms": f"{t['step_ms']:.2f}" for d, t in timing.items()},
        **{f"depth{d}_{k}": f"{v:.3f}" for d, t in timing.items() for k, v in t.items()
           if k != "step_ms"},
        card=repr(CARD))
    shallow, deep = timing[depths[0]]["fwd_bwd_peak_gib"], timing[depths[-1]]["fwd_bwd_peak_gib"]
    if not shallow < deep:
        raise AssertionError(f"{cfg.name}: the forward and backward at depth {depths[0]} peak "
                             f"at {shallow:.3f} GiB, not below depth {depths[-1]}'s {deep:.3f}")


def _own_copy(params):
    """``params`` with its own adapters and head (the frozen weights shared):
    a second backend's trainable set, written in place by its steps."""
    clone = lambda tree: {k: t.clone() for k, t in tree.items()}
    return {**params, "blocks": [{**b, "adapter": clone(b["adapter"])} for b in params["blocks"]],
            "head": clone(params["head"])}


def _pjit_walk(cfg, tc, params, depths, label, resume_at=None):
    """``PjitBackend`` on the card, graphed (one CUDA graph per boundary),
    against the eager backend (the same functional step, launched from
    Python) from the same weights on the same batches: TRAIN_INTERVAL steps
    at each depth of ``depths``. Every step's metrics and every adapter,
    head, moment and the step count ``torch.equal``; the capture's launches
    at (L, d, L, d - 1) and the eager step's the same; a build launches the
    step twice from Python (warm-up and capture), a replay nothing; the
    frozen layers' adapters and moments bit-identical, the top adapter
    moved. At step ``resume_at`` the graphed backend first takes a step on
    other data, then ``load_state`` puts the eager backend's state back
    into its tensors (the same addresses). Returns (the launches of the
    graphed steps, counted from the captures, and per depth the replays'
    event ms, graphed and eager)."""
    steps = TRAIN_INTERVAL * len(depths)
    policy = lambda: ExplicitPolicy(depths, interval=TRAIN_INTERVAL)
    eager = PjitBackend(cfg, tc, policy(), params=_own_copy(params), device="cuda", graphs=False)
    graphed = PjitBackend(cfg, tc, policy(), params=params, device="cuda")
    data = PjitDataSource(cfg, tc)
    other = PjitDataSource(cfg, dataclasses.replace(tc, seed=SEED + 1))
    ptrs = [t.data_ptr() for t in graphed.state_tensors()]
    L = cfg.n_layers
    launches = {name: 0 for name in ops.LAUNCHES}
    times = {}
    for s in range(steps):
        resumed = s == resume_at
        if resumed:
            st = eager.state()
            saved = tree_map(torch.clone, {"params": st["params"], "opt": st["opt"]})
            graphed.step(other.next())
            graphed.load_state(saved["params"], saved["opt"], step=eager._step)
            del saved
        batch = data.next()
        boundary = depth_to_boundary(cfg, graphed.policy.depth_at(graphed._step, L))
        n_frozen = boundary * cfg.layers_per_repeat
        d = L - n_frozen
        mine, opt = graphed.export_params(), graphed._opt
        clone = lambda tree: {k: t.clone() for k, t in tree.items()}
        frozen = [(clone(mine["blocks"][i]["adapter"]), clone(opt["m"]["adapters"][i]),
                   clone(opt["v"]["adapters"][i])) for i in range(n_frozen)]
        top = clone(mine["blocks"][-1]["adapter"])
        built = not any(k[0] == boundary for k in graphed.capture_launches)
        rec = {}
        for name, be in (("graphed", graphed), ("eager", eager)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = dict(ops.LAUNCHES)
            t0 = time.perf_counter()
            out, ms = _event_round(lambda: be.step(batch))
            rec[name] = dict(out=out, ms=ms, wall=1e3 * (time.perf_counter() - t0),
                             peak=torch.cuda.max_memory_allocated() / 2**30,
                             launched={k: n - before[k] for k, n in ops.LAUNCHES.items()})
        want = {"adapter_fused": L, "adapter_fused_bwd": d, "flash_attention": L,
                "flash_attention_bwd": d - 1, "rwkv_scan": 0, "mamba_scan": 0}
        cap = graphed.capture_launches[graphed.last_key]
        from_python = rec["graphed"]["launched"]
        g, e = rec["graphed"]["out"], rec["eager"]["out"]
        metrics = {k: float(v) for k, v in g["extras"].items()}
        say(f"{label}_step", arch=cfg.name, step=s, depth=d, boundary=boundary,
            loss=f"{float(g['loss']):.5f}", **{k: f"{v:.4g}" for k, v in metrics.items()},
            built=built, resumed=resumed,
            **({"capture_s": f"{graphed.capture_seconds[graphed.last_key]:.2f}"} if built else {}),
            graphed_event_ms=f"{rec['graphed']['ms']:.3f}",
            eager_event_ms=f"{rec['eager']['ms']:.3f}",
            graphed_wall_ms=f"{rec['graphed']['wall']:.3f}",
            eager_wall_ms=f"{rec['eager']['wall']:.3f}",
            graphed_peak_gib=f"{rec['graphed']['peak']:.3f}",
            eager_peak_gib=f"{rec['eager']['peak']:.3f}",
            reserved_gib=f"{torch.cuda.memory_reserved() / 2**30:.3f}",
            launches_at_capture=json.dumps(cap).replace(" ", ""), card=repr(CARD))
        if g["boundary"] != boundary or e["boundary"] != boundary:
            raise AssertionError(f"{label} step {s}: boundaries {g['boundary']}, "
                                 f"{e['boundary']} against {boundary}")
        if cap != want or rec["eager"]["launched"] != want:
            raise AssertionError(f"{label} step {s}: launches {cap} (graph), "
                                 f"{rec['eager']['launched']} (eager) != {want}")
        expect = {k: 2 * n for k, n in want.items()} if built else \
            {k: 0 for k in want}
        if from_python != expect:
            raise AssertionError(f"{label} step {s}: the graphed step launched {from_python} "
                                 f"from Python, not {expect}")
        if not (torch.equal(g["loss"], e["loss"]) and set(g["extras"]) == set(e["extras"]) and
                all(torch.equal(v, e["extras"][k]) for k, v in g["extras"].items())):
            raise AssertionError(f"{label} step {s}: graphed metrics {g} against eager {e}")
        bad = [i for i, (a, b) in enumerate(zip(graphed.state_tensors(), eager.state_tensors(),
                                                strict=True)) if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"{label} step {s}: leaves {bad} of the graphed step differ "
                                 f"from the eager step's")
        if not math.isfinite(float(g["loss"])):
            raise AssertionError(f"{label} step {s}: loss {float(g['loss'])}")
        for i, trees in enumerate(frozen):
            now = (mine["blocks"][i]["adapter"], opt["m"]["adapters"][i], opt["v"]["adapters"][i])
            if not all(torch.equal(a[k], b[k]) for a, b in zip(now, trees) for k in a):
                raise AssertionError(f"{label} step {s}: frozen layer {i} moved")
        if all(torch.equal(mine["blocks"][-1]["adapter"][k], t) for k, t in top.items()):
            raise AssertionError(f"{label} step {s}: the top adapter did not move")
        for k, n in cap.items():
            launches[k] += n
        if not built:
            t = times.setdefault(d, {"graphed_event_ms": [], "eager_event_ms": [],
                                     "graphed_wall_ms": [], "eager_wall_ms": []})
            for name in ("graphed", "eager"):
                t[f"{name}_event_ms"].append(rec[name]["ms"])
                t[f"{name}_wall_ms"].append(rec[name]["wall"])
    if [t.data_ptr() for t in graphed.state_tensors()] != ptrs:
        raise AssertionError(f"{label}: the graphed backend's state moved")
    return launches, times


def phase_train_qa(arch: str, records) -> None:
    """The paper's own model (mbert-squad) at its published width, random
    weights from the seed with non-zero adapters, the QA corpus's batches of
    4 x 512: the loss and the gradients of the kernel path against
    impl="plain" (the module docstring says which are held), then six steps
    of ``PjitBackend`` at depths 1, 2, 12, graphed against eager
    (:func:`_pjit_walk`)."""
    cfg = served_config(arch)
    tc = TrainConfig(batch_size=TRAIN_B, seq_len=TRAIN_S, seed=SEED)
    ops.reset_launches()
    t0 = time.perf_counter()
    params = prm.materialize(cfg, seed=SEED, device="cuda")
    batch = to_device(PjitDataSource(cfg, tc).next(), "cuda")
    torch.cuda.synchronize()
    say("materialize", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", head_dim=cfg.head_dim,
        vocab=cfg.padded_vocab, head_out=cfg.head_out, norm=cfg.norm,
        params=sum(t.numel() for t in tree_leaves(params)),
        seconds=f"{time.perf_counter() - t0:.2f}",
        gib_on_card=f"{torch.cuda.memory_allocated() / 2**30:.2f}")
    # depth 1 held as phase_train holds it. Below the top layer this random
    # model's gradients are chaotic: the kernel and plain paths' forwards,
    # ulps apart in f32, give L10's adapter gradients 7% apart, and in bf16
    # each path's gradient is as far from the f32 one as from the other
    # (PERF.md section 6). So at depth 2 the whole hot region in bf16 is a
    # witness, as at full depth in phase_train, and held are the backward
    # kernels alone in bf16 and the whole hot region in f32; at depth 12 the
    # backward kernels alone in bf16
    _grad_check(cfg, params, batch, depth_to_boundary(cfg, 1))
    two = depth_to_boundary(cfg, 2)
    _grad_check(cfg, params, batch, two, gate=False)
    _grad_check(cfg, params, batch, two, backward_only=True)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    _grad_check(cfg32, params32, batch, two, rtol=DEEP_F32_RMS_RTOL)
    del params32
    _grad_check(cfg, params, batch, 0, backward_only=True)
    launches, times = _pjit_walk(cfg, tc, params, (1, 2, cfg.n_layers), "train_qa")
    _path_kernels_ran(ops.LAUNCHES, "the QA steps")
    count_launches(records, f"{cfg.name}_train_qa", launches)
    say("train_qa_time", arch=cfg.name, batch=TRAIN_B, seq_len=TRAIN_S,
        **{f"depth{d}_{k}": json.dumps([round(x, 3) for x in v]).replace(" ", "")
           for d, t in times.items() for k, v in t.items()}, card=repr(CARD))


def phase_pjit_graph(arch: str, records) -> None:
    """The one-device step of the main path's arch (stablelm-3b) at full
    width as a CUDA graph per boundary, against the eager step: depths 1 and
    32, two steps each, a resume through ``load_state`` at the second step
    at depth 32 (:func:`_pjit_walk`)."""
    cfg = served_config(arch)
    tc = TrainConfig(batch_size=TRAIN_B, seq_len=TRAIN_S, seed=SEED)
    ops.reset_launches()
    params = prm.materialize(cfg, seed=SEED, device="cuda")
    depths = (1, cfg.n_layers)
    launches, times = _pjit_walk(cfg, tc, params, depths, "pjit_graph",
                                 resume_at=TRAIN_INTERVAL * len(depths) - 1)
    _path_kernels_ran(ops.LAUNCHES, "the graphed steps")
    count_launches(records, f"{cfg.name}_pjit_graph", launches)
    say("pjit_graph_time", arch=cfg.name, batch=TRAIN_B, seq_len=TRAIN_S,
        **{f"depth{d}_{k}": json.dumps([round(x, 3) for x in v]).replace(" ", "")
           for d, t in times.items() for k, v in t.items()}, card=repr(CARD))


class PinnedRouting:
    """While a kernel path is held to its plain version: the kernel path's
    expert choices (``blocks.moe_topk``) are recorded in order, and the plain
    path, run next on the same inputs, takes the same experts (its gates
    from its own probabilities), so both compute the same function and
    differ by rounding alone. One ulp before a router can otherwise send a
    token to another expert and move its output by a whole expert's; the
    tokens the plain path's own top-k would have sent elsewhere are counted
    (``share``). Outside the ``with`` block the model routes as always."""

    def __init__(self):
        self.real, self.mode, self.choices = blocks.moe_topk, "record", []
        self.tokens = self.elsewhere = 0

    def __call__(self, probs, k):
        gates, eidx = self.real(probs, k)
        if self.mode == "record":
            self.choices.append(eidx)
            return gates, eidx
        want = self.choices.pop(0)
        self.tokens += eidx.shape[0]
        self.elsewhere += int((eidx.sort(-1).values != want.sort(-1).values).any(-1).sum())
        return probs.gather(-1, want), want

    def share(self):
        """The share of the plain path's tokens routed elsewhere by its own
        top-k, or None where no moe block ran."""
        return self.elsewhere / self.tokens if self.tokens else None

    def __enter__(self):
        blocks.moe_topk = self
        return self

    def __exit__(self, *exc):
        blocks.moe_topk = self.real


def _plain_run(cfg, params, requests, horizon):
    """Serve ``requests`` (one batch) with ``impl="plain"`` on the card. Every
    block also runs its kernel version on the same input and a copy of its
    cache (first: a moe block's plain version takes its experts,
    ``PinnedRouting``). Returns the server, its results, per block mode the
    worst gap between the two relative to the block output's largest entry
    (and, under "<mode>_cache", the worst over the new cache's leaves), and
    the share of tokens the plain path's own routing would send elsewhere
    (None without moe blocks)."""
    gaps = {}
    real = tfm.apply_block

    def rel(a, b) -> float:
        a, b = a.float(), b.float()
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    def both(kind, cfg, p, h, ctx, cache=None):
        twin = None if cache is None else {k: v.clone() for k, v in cache.items()}
        pin.mode = "record"
        hk, ck, _ = real(kind, cfg, p, h, dataclasses.replace(ctx, impl="kernel"), twin)
        pin.mode = "pin"
        out = real(kind, cfg, p, h, ctx, cache)
        gaps[ctx.mode] = max(gaps.get(ctx.mode, 0.0), rel(hk, out[0]))
        cg = max(rel(ck[name], leaf) for name, leaf in out[1].items())
        gaps[f"{ctx.mode}_cache"] = max(gaps.get(f"{ctx.mode}_cache", 0.0), cg)
        return out

    server = BatchServer(cfg, params, slots=len(requests), horizon=horizon, impl="plain",
                         device="cuda")
    tfm.apply_block = both
    try:
        with PinnedRouting() as pin:
            results = server.run(requests, log=lambda *a: None)
    finally:
        tfm.apply_block = real
    return server, results, gaps, pin.share()


def phase_train_only(arch: str, records) -> None:
    """Train an architecture that is not served here (stablelm-3b) from its
    random weights at the published width."""
    cfg = served_config(arch)
    t0 = time.perf_counter()
    params = prm.materialize(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    say("materialize", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", head_dim=cfg.d_model // cfg.n_heads,
        vocab=cfg.padded_vocab, params=sum(t.numel() for t in tree_leaves(params)),
        seconds=f"{time.perf_counter() - t0:.2f}",
        gib_on_card=f"{torch.cuda.memory_allocated() / 2**30:.2f}")
    phase_train(arch, params, records)


def _ring_check(cfg, trainer, tokens, labels, boundary) -> float:
    """Owner 0's ring loss and gradients at ``boundary``, before the round's
    updates, against the mean over its microbatches of the single-device
    step's on each microbatch alone (kernel path both). Returns the ring
    round's forward-and-backward peak GiB."""
    M, F = trainer.M, frozen_stage_count(trainer.spans, boundary)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, (g_ad, g_hd) = trainer.round_fn(0, boundary)(trainer.stage_blocks, trainer.shared,
                                                      tokens, labels)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    params = trainer.export_params()
    ref_loss, ref = 0.0, None
    for m in range(M):
        lm, _, gm = training.loss_and_grads(params, {"tokens": tokens[0, m],
                                                     "labels": labels[0, m]}, cfg, boundary)
        ref_loss += lm.item() / M
        gm = tree_map(lambda t: t.float() / M, gm)
        ref = gm if ref is None else tree_map(torch.add, ref, gm)
    rms = lambda x: x.float().square().mean().sqrt().item()
    hot = [a for stage in g_ad[F:] for a in stage]
    leaves = {"head": (g_hd["w"], ref["head"]["w"])}
    n_frozen = boundary * cfg.layers_per_repeat
    for i, (a, b) in enumerate(zip(hot, ref["adapters"])):
        for name in ("w_down", "w_up"):
            leaves[f"L{n_frozen + i}.{name}"] = (a[name], b[name])
    gaps = {name: rms(a.float() - b) / rms(b) for name, (a, b) in leaves.items()}
    loss_gap = abs(loss.item() - ref_loss) / abs(ref_loss)
    frozen_zero = all(not t.any() for stage in g_ad[:F] for a in stage for t in a.values())
    worst = max(gaps, key=gaps.get)
    say("ring_vs_step", boundary=boundary, frozen_stages=F, owner=0,
        loss_ring=f"{loss.item():.6f}", loss_steps=f"{ref_loss:.6f}",
        loss_rel_gap=f"{loss_gap:.3g}", loss_rtol=TRAIN_LOSS_RTOL, worst_leaf=worst,
        worst_gap=f"{gaps[worst]:.3g}", grad_rms_rtol=GRAD_RMS_RTOL,
        frozen_grads_zero=frozen_zero, fwd_bwd_peak_gib=f"{peak:.3f}",
        grad_rms_gaps=json.dumps({k: float(f"{v:.3g}") for k, v in gaps.items()}).replace(" ", ""))
    if not (math.isfinite(loss.item()) and loss_gap <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"ring loss {loss.item()} against the steps' {ref_loss}")
    bad = {k: v for k, v in gaps.items() if not v <= GRAD_RMS_RTOL}
    if bad or len(hot) != len(ref["adapters"]) or not frozen_zero:
        raise AssertionError(f"ring gradients differ from the single-device step's: {bad}, "
                             f"{len(hot)} hot layers, frozen stages zero: {frozen_zero}")
    return peak


def _seed_executor(ex, trainer) -> None:
    """Copy the trainer's trainable state into the executor's own tensors (in
    place: the executor's graphs read and write them)."""
    for name, mine, theirs in (("adapter", ex.stage_adapters(), trainer.stage_adapters()),
                               ("m", ex.opt_state["m"]["adapter"], trainer.m_ad),
                               ("v", ex.opt_state["v"]["adapter"], trainer.v_ad)):
        for s0, s1 in zip(mine, theirs, strict=True):
            for a, b in zip(s0, s1, strict=True):
                for k in a:
                    a[k].copy_(b[k])
    for mine, theirs in ((ex.shared["head"], trainer.shared["head"]),
                         (ex.opt_state["m"]["head"], trainer.m_hd),
                         (ex.opt_state["v"]["head"], trainer.v_hd)):
        for k in mine:
            mine[k].copy_(theirs[k])
    ex.opt_state["count"].fill_(trainer.step)
    ex.step = trainer.step


def _hot_leaves(ring, F: int):
    """The hot stages' adapter leaves and the head, by name."""
    stages = ring.stage_adapters()
    n_frozen = sum(len(stage) for stage in stages[:F])
    layers = [a for stage in stages for a in stage]
    return {**{f"L{i}.{k}": t for i, a in enumerate(layers) if i >= n_frozen
               for k, t in a.items()}, "head": ring.shared["head"]["w"]}


def _trainable_state(ring, F: int):
    """The hot stages' adapters and their moments, the head and its moments,
    by name, of a ``RingTrainer`` or a ``RingExecutor``."""
    if isinstance(ring, RingExecutor):
        m, v = ring.opt_state["m"], ring.opt_state["v"]
        trees = {"adapter": ring.stage_adapters(), "m": m["adapter"], "v": v["adapter"]}
        heads = {"head": ring.shared["head"], "m_head": m["head"], "v_head": v["head"]}
    else:
        trees = {"adapter": ring.stage_adapters(), "m": ring.m_ad, "v": ring.v_ad}
        heads = {"head": ring.shared["head"], "m_head": ring.m_hd, "v_head": ring.v_hd}
    out = {f"{name}.{k}": t for name, tree in heads.items() for k, t in tree.items()}
    for name, tree in trees.items():
        layers = [a for stage in tree[F:] for a in stage]
        out.update({f"{name}.hot{i}.{k}": t for i, a in enumerate(layers) for k, t in a.items()})
    return out


def _fused_round(cfg, ex, trainer, tokens, labels, boundary, rec, before, want) -> dict:
    """One round of the executor from the trainer's state before its round
    (``before``: the hot leaves then), held to the trainer's round ``rec``.
    The boundary's graph is built (warm-up, capture) on other tokens (the
    owners and microbatches reversed), the state put back, and the checked
    round is a replay on the round's own tokens: each owner's loss within
    TRAIN_LOSS_RTOL and each hot leaf's update by RMS gap within
    GRAD_RMS_RTOL (printed), then the losses and every hot adapter, the head
    and their moments equal to the trainer's (the same kernels on the same
    shapes), the frozen stages bit-identical, the kernel launches the
    capture recorded S times an iteration's ``want``, the tick ledger the
    packed one. Then three replays of the same round from the same state,
    timed (host wall and CUDA events), and the state put back. Returns the
    launches of the round: those the graph holds, which each replay
    launches (the build's eager warm-up and its capture each count them once
    more, and are held to that)."""
    S, F = ex.S, frozen_stage_count(ex.spans, boundary)
    frozen = [[{k: t.clone() for k, t in a.items()} for a in stage]
              for tree in (ex.stage_adapters(), ex.opt_state["m"]["adapter"],
                           ex.opt_state["v"]["adapter"]) for stage in tree[:F]]
    start_step = ex.step
    start = [t.clone() for t in ex.trainable_tensors()]
    other = (tokens.flip(0, 1).contiguous(), labels.flip(0, 1).contiguous())
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ex.round(*other)                                    # warm-up, capture, replay
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    build_launches = dict(ops.LAUNCHES)
    captured = ex.capture_launches[(boundary, "direct")]
    for t, was in zip(ex.trainable_tensors(), start):
        t.copy_(was)
    ex.step = start_step
    del start
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ex.round(tokens, labels)                      # the checked round: a replay
    torch.cuda.synchronize()
    replay_ms = 1e3 * (time.perf_counter() - t0)
    replay_counted = dict(ops.LAUNCHES)
    losses = out["losses"].tolist()
    want_losses = [it["loss"] for it in rec["iterations"]]
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, want_losses, strict=True)]
    rms = lambda x: x.float().square().mean().sqrt().item()
    mine, theirs = _hot_leaves(ex, F), _hot_leaves(trainer, F)
    gaps = {name: rms((mine[name].float() - before[name]) - (theirs[name].float() - before[name]))
            / rms(theirs[name].float() - before[name]) for name in before}
    state, oracle = _trainable_state(ex, F), _trainable_state(trainer, F)
    unequal = sorted(k for k in oracle if not torch.equal(state[k], oracle[k]))
    now = [stage for tree in (ex.stage_adapters(), ex.opt_state["m"]["adapter"],
                              ex.opt_state["v"]["adapter"]) for stage in tree[:F]]
    frozen_same = all(torch.equal(a[k], b[k]) for s0, s1 in zip(frozen, now)
                      for a, b in zip(s0, s1) for k in a)
    ledger = ex.measured_tick_ledger(boundary)
    ticks = ring_pl.pipeline_tick_counts(S, ex.M, boundary, spans=ex.spans, packed=True)
    snapshot = [t.clone() for t in ex.trainable_tensors()]
    walls, devices = [], []
    for _ in range(3):
        ex.step = start_step
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        ex.round(tokens, labels)
        e1.record()
        torch.cuda.synchronize()
        walls.append(round(1e3 * (time.perf_counter() - t0), 2))
        devices.append(round(e0.elapsed_time(e1), 2))
    for t, was in zip(ex.trainable_tensors(), snapshot):
        t.copy_(was)
    ex.step = start_step + S
    worst = max(gaps, key=gaps.get)
    say("ring_fused_round", spans=json.dumps([list(sp) for sp in ex.spans]).replace(" ", ""),
        boundary=boundary, frozen_stages=F, losses=json.dumps([round(x, 5) for x in losses]),
        worst_loss_gap=f"{max(loss_gaps):.3g}", loss_rtol=TRAIN_LOSS_RTOL, worst_leaf=worst,
        worst_update_gap=f"{gaps[worst]:.3g}", grad_rms_rtol=GRAD_RMS_RTOL,
        state_equal=not unequal and losses == want_losses, frozen_same=frozen_same,
        capture_s=f"{ex.capture_seconds[(boundary, 'direct')]:.2f}",
        build_round_ms=f"{build_ms:.1f}",
        checked_replay_ms=f"{replay_ms:.1f}", replay_wall_ms=json.dumps(walls),
        replay_device_ms=json.dumps(devices), build_peak_gib=f"{peak:.3f}",
        reserved_gib=f"{torch.cuda.memory_reserved() / 2**30:.3f}",
        phase_a_ticks=ledger["phase_a_round_ticks"],
        launches_in_graph=json.dumps(captured).replace(" ", ""),
        compile_counts=json.dumps(ex.compile_counts()).replace(" ", ""), card=repr(CARD))
    if not all(math.isfinite(x) and g <= TRAIN_LOSS_RTOL for x, g in zip(losses, loss_gaps)):
        raise AssertionError(f"fused losses {losses} against the RingTrainer's {want_losses}")
    bad = {k: v for k, v in gaps.items() if not v <= GRAD_RMS_RTOL}
    if bad or not frozen_same:
        raise AssertionError(f"fused updates differ from the RingTrainer's: {bad}; frozen "
                             f"stages unchanged: {frozen_same}")
    if losses != want_losses or unequal:
        raise AssertionError(f"the fused round is not the RingTrainer's bit for bit: losses "
                             f"{losses} against {want_losses}; unequal {unequal[:8]} "
                             f"({len(unequal)} of {len(oracle)})")
    if captured != {k: S * n for k, n in want.items()}:
        raise AssertionError(f"launches at capture {captured} != {S} x {want}")
    if build_launches != {k: 2 * n for k, n in captured.items()} or any(replay_counted.values()):
        raise AssertionError(f"the build counted {build_launches} (warm-up and capture: twice "
                             f"{captured}), the replay {replay_counted} (none)")
    if ledger != ticks or ex.compile_counts().get(f"{boundary}/direct") != 1:
        raise AssertionError(f"ledger {ledger} != {ticks}, builds {ex.compile_counts()}")
    return captured


def _ring_walk(cfg, tc, params, records, depths, spans, label: str) -> None:
    """``RingTrainer`` and ``RingExecutor`` over the same rounds of one ring,
    from the same weights: each round the trainer's is held to the
    single-device step and the executor's (seeded with the trainer's state
    before the round) to the trainer's, with the checks of the module
    docstring."""
    sched = UnfreezeSchedule(depths=depths, interval=RING_S)
    trainer = RingTrainer(cfg, tc, params, RING_S, RING_M, schedule=sched, spans=spans)
    ex = RingExecutor(cfg, tc, params, RING_S, RING_M, schedule=sched, spans=spans)
    data = ring_data_source(cfg, tc, RING_S)
    say("ring_setup", arch=cfg.name, ring=label, stages=RING_S,
        spans=json.dumps([list(sp) for sp in trainer.spans]).replace(" ", ""),
        microbatches=RING_M, microbatch=f"1x{TRAIN_S}", depths=list(depths), lr=RING_LR,
        gib_on_card=f"{torch.cuda.memory_allocated() / 2**30:.2f}")
    L = cfg.n_layers
    launches = {name: 0 for name in ops.LAUNCHES}
    fused_launches = {name: 0 for name in ops.LAUNCHES}
    for r in range(len(depths)):
        tokens, labels = trainer.to_device(*data.next())
        boundary = trainer.boundary_at(trainer.step)
        F = frozen_stage_count(trainer.spans, boundary)
        b = boundary * cfg.layers_per_repeat
        fwd_bwd_peak = _ring_check(cfg, trainer, tokens, labels, boundary)
        _seed_executor(ex, trainer)
        before = {k: t.float().clone() for k, t in _hot_leaves(trainer, F).items()}
        clone = lambda tree: [[{k: t.clone() for k, t in a.items()} for a in stage]
                              for stage in tree[:F]]
        frozen = (clone(trainer.stage_adapters()), clone(trainer.m_ad), clone(trainer.v_ad))
        top = {k: t.clone() for k, t in trainer.stage_adapters()[-1][-1].items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec = trainer.round(tokens, labels)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {"adapter_fused": L * RING_M, "flash_attention": L * RING_M,
                "adapter_fused_bwd": (L - b) * RING_M,
                "flash_attention_bwd": (L - b - 1) * RING_M, "mamba_scan": 0, "rwkv_scan": 0}
        ticks = ring_pl.pipeline_tick_counts(RING_S, RING_M, boundary, spans=trainer.spans)
        first = rec["iterations"][0]
        say("ring_round", ring=label, round=r, boundary=boundary, depth=L - b, frozen_stages=F,
            loss=f"{rec['loss']:.5f}", round_ms=f"{wall:.2f}",
            iteration_ms=json.dumps([round(it["ms"], 2) for it in rec["iterations"]]),
            step_peak_gib=f"{peak:.3f}", fwd_bwd_peak_gib=f"{fwd_bwd_peak:.3f}",
            fwd_ticks=first["fwd_ticks"], bwd_ticks=first["bwd_ticks"],
            launches=json.dumps(first["launches"]).replace(" ", ""),
            card=repr(CARD))
        for it in rec["iterations"]:
            if it["launches"] != want:
                raise AssertionError(f"round {r} owner {it['owner']}: launch counters "
                                     f"{it['launches']} != expected {want}")
            if (it["fwd_ticks"], it["bwd_ticks"]) != (ticks["fwd_ticks"], ticks["bwd_ticks"]):
                raise AssertionError(f"round {r} owner {it['owner']}: ticks "
                                     f"{it['fwd_ticks']}, {it['bwd_ticks']} != {ticks}")
            if it["boundary"] != boundary or not math.isfinite(it["loss"]):
                raise AssertionError(f"round {r} owner {it['owner']}: {it}")
            for name, n in it["launches"].items():
                launches[name] += n
        now = (trainer.stage_adapters()[:F], trainer.m_ad[:F], trainer.v_ad[:F])
        for was, tree in zip(frozen, now):
            if not all(torch.equal(a[k], b_[k]) for s0, s1 in zip(was, tree)
                       for a, b_ in zip(s0, s1) for k in a):
                raise AssertionError(f"round {r}: a frozen stage moved")
        if all(torch.equal(trainer.stage_adapters()[-1][-1][k], t) for k, t in top.items()):
            raise AssertionError(f"round {r}: the top adapter did not move")
        for name, n in _fused_round(cfg, ex, trainer, tokens, labels, boundary, rec, before,
                                    want).items():
            fused_launches[name] += n
    count_launches(records, f"{cfg.name}_{label}", launches)
    count_launches(records, f"{cfg.name}_{label}_fused", fused_launches)


def phase_ring(arch: str, records) -> None:
    """The RingAda ring at full width, four stages of the model on the card,
    ``RingTrainer`` and ``RingExecutor`` from the same weights: three rounds
    of the balanced ring, then two of the heterogeneous one, with the checks
    of the module docstring."""
    cfg = served_config(arch)
    tc = TrainConfig(learning_rate=RING_LR, batch_size=1, seq_len=TRAIN_S,
                     n_microbatches=RING_M, n_stages=RING_S, seed=SEED)
    t0 = time.perf_counter()
    params = prm.materialize(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    say("ring_weights", arch=cfg.name, seconds=f"{time.perf_counter() - t0:.2f}",
        gib_on_card=f"{torch.cuda.memory_allocated() / 2**30:.2f}")
    _ring_walk(cfg, tc, params, records, RING_DEPTHS, None, "ring")
    gc.collect()
    spans = spans_from_profiles(cfg.repeats, parse_device_profiles(RING_SPEEDS))
    _ring_walk(cfg, tc, params, records, HETERO_DEPTHS, spans, "ring_hetero")


def _copy_state(dst, src) -> None:
    """Seed executor ``dst`` with ``src``'s trainable state and step (in place:
    the executors' graphs read and write these tensors)."""
    for a, b in zip(dst.trainable_tensors(), src.trainable_tensors(), strict=True):
        a.copy_(b)
    dst.step = src.step


def _event_round(fn):
    """``fn()``'s result and its device ms by CUDA events."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def _cache_round(exc, exd, tokens, labels, slot):
    """One round of the cached executor ``exc`` and of the direct ``exd``
    seeded with its state before it: (the cached round's record, its event
    ms, the direct's, the eager launches the cached round counted, whether
    the losses and every tensor a round writes are equal)."""
    _copy_state(exd, exc)
    ops.reset_launches()
    out, ms = _event_round(lambda: exc.round(tokens, labels, slot=slot))
    counted = dict(ops.LAUNCHES)
    want, direct_ms = _event_round(lambda: exd.round(tokens, labels))
    equal = torch.equal(out["losses"], want["losses"]) and all(
        torch.equal(a, b) for a, b in zip(exc.trainable_tensors(), exd.trainable_tensors(),
                                          strict=True))
    return out, want, ms, direct_ms, counted, equal


def phase_ring_cache(arch: str, records) -> None:
    """The frozen-trunk activation cache on the ring of ``phase_ring``: a
    ``RingExecutor`` with a cache of CACHE_SLOTS entries walks slots 0, 1, 0,
    1 at each of CACHE_DEPTHS, each round against a direct ``RingExecutor``
    seeded with its state before it (losses and every tensor a round writes
    equal, ``torch.equal``); ``stats()`` after each round, the launches of
    the graph each round replays (a capture graph the direct graph's, a
    cached graph Phase B's alone) and the eager launches (a build counts its
    graph's twice, a replay none), the tick ledgers; then one int8 round."""
    cfg = served_config(arch)
    tc = TrainConfig(learning_rate=RING_LR, batch_size=1, seq_len=TRAIN_S,
                     n_microbatches=RING_M, n_stages=RING_S, seed=SEED)
    params = prm.materialize(cfg, seed=SEED, device="cuda")
    per_depth = 2 * CACHE_SLOTS
    sched = UnfreezeSchedule(depths=CACHE_DEPTHS, interval=per_depth * RING_S)
    exc = RingExecutor(cfg, tc, params, RING_S, RING_M, schedule=sched,
                       cache_capacity=CACHE_SLOTS)
    exd = RingExecutor(cfg, tc, params, RING_S, RING_M, schedule=sched)
    data = ring_data_source(cfg, tc, RING_S, slots_per_epoch=CACHE_SLOTS)
    L, per = cfg.n_layers, cfg.layers_per_repeat
    launches = {name: 0 for name in ops.LAUNCHES}
    # (hits, misses, invalidations) after each round of the walk
    want_stats = [(0, 1, 0), (0, 2, 0), (1, 2, 0), (2, 2, 0), (2, 3, 1), (2, 4, 1), (3, 4, 1),
                  (4, 4, 1)]
    say("ring_cache_setup", arch=cfg.name, stages=RING_S, microbatches=RING_M,
        microbatch=f"1x{TRAIN_S}", slots=CACHE_SLOTS, capacity=CACHE_SLOTS,
        depths=list(CACHE_DEPTHS), lr=RING_LR,
        gib_on_card=f"{torch.cuda.memory_allocated() / 2**30:.2f}")
    timed = {}
    for r in range(per_depth * len(CACHE_DEPTHS)):
        if r % per_depth == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        slot, tokens, labels = data.next_slot()
        tokens, labels = exc.to_device(tokens, labels)
        out, want, ms, direct_ms, counted, equal = _cache_round(exc, exd, tokens, labels, slot)
        boundary = out["boundary"]
        F, b = frozen_stage_count(exc.spans, boundary), boundary * per
        mode = "cached" if out["cache_hit"] else "capture"
        graph = exc.capture_launches[(boundary, mode)]
        for name, n in graph.items():
            launches[name] += n
        st = exc.cache.stats()
        phase_b = (L - b) * RING_M * RING_S
        want_graph = exd.capture_launches[(boundary, "direct")] if mode == "capture" else {
            "adapter_fused": phase_b, "flash_attention": phase_b, "adapter_fused_bwd": phase_b,
            "flash_attention_bwd": (L - b - 1) * RING_M * RING_S, "mamba_scan": 0,
            "rwkv_scan": 0}
        built = r % per_depth in (0, 2)                 # the first capture, the first hit
        want_counted = {k: 2 * n for k, n in graph.items()} if built else \
            {k: 0 for k in graph}
        ledger = exc.measured_tick_ledger(boundary, mode)
        ticks = ring_pl.pipeline_tick_counts(RING_S, RING_M, boundary, spans=exc.spans,
                                             packed=mode == "capture", cached=mode == "cached")
        if r % per_depth in (1, 3):                     # replays
            timed[(F, mode)] = ms
            timed[(F, "direct")] = timed.get((F, "direct"), []) + [direct_ms]
        say("ring_cache_round", round=r, slot=slot, boundary=boundary, frozen_stages=F,
            mode=mode, losses=json.dumps([round(x, 5) for x in out["losses"].tolist()]),
            equal_to_direct=equal, hits=st["cache_hits"], misses=st["cache_misses"],
            invalidations=st["cache_invalidations"], evictions=st["cache_evictions"],
            bypasses=st["cache_bypasses"], event_ms=f"{ms:.3f}",
            direct_event_ms=f"{direct_ms:.3f}", built=built,
            launches_in_graph=json.dumps(graph).replace(" ", ""),
            phase_a_ticks=ledger["phase_a_round_ticks"], card=repr(CARD))
        if not equal or not all(math.isfinite(x) for x in out["losses"].tolist()):
            raise AssertionError(f"round {r} ({mode}): the cached executor's round is not the "
                                 f"direct one's bit for bit: {out['losses'].tolist()} against "
                                 f"{want['losses'].tolist()}")
        if (F, out["cache_hit"]) != ((3, 2)[r // per_depth], r % per_depth >= CACHE_SLOTS):
            raise AssertionError(f"round {r}: F {F}, hit {out['cache_hit']}")
        got_stats = (st["cache_hits"], st["cache_misses"], st["cache_invalidations"])
        if got_stats != want_stats[r] or st["cache_evictions"] or st["cache_bypasses"]:
            raise AssertionError(f"round {r}: stats {st}, expected (hits, misses, "
                                 f"invalidations) {want_stats[r]}, no eviction, no bypass")
        if graph != want_graph or counted != want_counted:
            raise AssertionError(f"round {r} ({mode}): the graph holds {graph}, expected "
                                 f"{want_graph}; the round counted {counted}, expected "
                                 f"{want_counted}")
        if ledger != ticks or exc.compile_counts().get(f"{boundary}/{mode}") != 1:
            raise AssertionError(f"round {r}: ledger {ledger} != {ticks}, builds "
                                 f"{exc.compile_counts()}")
        if r % per_depth == per_depth - 1:
            say("ring_cache_boundary", boundary=boundary, frozen_stages=F,
                cached_event_ms=f"{timed[(F, 'cached')]:.3f}",
                capture_event_ms=f"{timed[(F, 'capture')]:.3f}",
                direct_event_ms=json.dumps([round(x, 3) for x in timed[(F, 'direct')]]),
                cache_bytes_per_entry=st["cache_bytes_per_entry"],
                cache_buffer_bytes=st["cache_buffer_bytes"],
                capture_s=f"{exc.capture_seconds[(boundary, 'capture')]:.2f}",
                cached_s=f"{exc.capture_seconds[(boundary, 'cached')]:.2f}",
                build_peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
                reserved_gib=f"{torch.cuda.memory_reserved() / 2**30:.3f}",
                graphs_alive="direct,capture,cached", card=repr(CARD))
    del exc, exd
    gc.collect()
    torch.cuda.empty_cache()
    # one int8 round at the first depth: a capture, then the cached round
    # against the direct round from the same state
    sched = UnfreezeSchedule(depths=CACHE_DEPTHS[:1], interval=RING_S)
    exq = RingExecutor(cfg, tc, params, RING_S, RING_M, schedule=sched, cache_capacity=1,
                       cache_dtype="int8")
    exd = RingExecutor(cfg, tc, params, RING_S, RING_M, schedule=sched)
    _, tokens, labels = ring_data_source(cfg, tc, RING_S, slots_per_epoch=1).next_slot()
    tokens, labels = exq.to_device(tokens, labels)
    first = _cache_round(exq, exd, tokens, labels, 0)
    out, want, ms, direct_ms, counted, equal = _cache_round(exq, exd, tokens, labels, 0)
    boundary = out["boundary"]
    for mode in ("capture", "cached"):
        for name, n in exq.capture_launches[(boundary, mode)].items():
            launches[name] += n
    loss_err = float((out["losses"].float() - want["losses"].float()).abs().max())
    mine, theirs = _hot_leaves(exq, 3), _hot_leaves(exd, 3)
    param_err = max(float((mine[k].float() - theirs[k].float()).abs().max()) for k in mine)
    st = exq.cache.stats()
    say("ring_cache_int8", boundary=boundary, frozen_stages=3, capture_equal=first[5],
        cache_hit=out["cache_hit"], losses=json.dumps([round(x, 5) for x in
                                                       out["losses"].tolist()]),
        direct_losses=json.dumps([round(x, 5) for x in want["losses"].tolist()]),
        max_loss_err=f"{loss_err:.3g}", loss_tol=INT8_LOSS_TOL,
        max_param_err=f"{param_err:.3g}", param_tol=INT8_PARAM_TOL, bit_equal=equal,
        event_ms=f"{ms:.3f}", direct_event_ms=f"{direct_ms:.3f}",
        cache_bytes_per_entry=st["cache_bytes_per_entry"], card=repr(CARD))
    if not (first[5] and out["cache_hit"] and math.isfinite(loss_err)
            and loss_err < INT8_LOSS_TOL and param_err < INT8_PARAM_TOL):
        raise AssertionError(f"the int8 round: capture equal {first[5]}, hit "
                             f"{out['cache_hit']}, loss error {loss_err}, parameter error "
                             f"{param_err}")
    count_launches(records, f"{cfg.name}_ring_cached", launches)


def _path_kernels_ran(counts, what: str) -> None:
    """Fail unless every kernel of the training path launched in ``counts``."""
    idle = [k for k in ("adapter_fused", "flash_attention", "adapter_fused_bwd",
                        "flash_attention_bwd") if counts.get(k, 0) == 0]
    if idle:
        raise AssertionError(f"{what}: {idle} never launched ({counts})")


def _quiet(*_) -> None:
    pass


def _session_round(sess, batch=None):
    """One session step, materialized: (metrics, CUDA-event ms, host wall ms)."""
    t0 = time.perf_counter()
    m, ms = _event_round(lambda: sess.step(batch).materialize())
    return m, ms, 1e3 * (time.perf_counter() - t0)


def _ring_state(sess):
    return [t.clone() for t in sess.backend.driver.trainable_tensors()]


def _pjit_state(sess):
    st = sess.backend.state()
    return [t.clone() for t in tree_leaves((st["params"], st["opt"]))]


def _save(sess, name: str):
    """Save ``sess`` under SESSION_DIR: (path, seconds, bytes of .npz and .json)."""
    path = os.path.join(SESSION_DIR, name)
    t0 = time.perf_counter()
    sess.save(path)
    seconds = time.perf_counter() - t0
    return path, seconds, sum(os.path.getsize(path + ext) for ext in (".npz", ".json"))


def _resume(path: str, cfg, tc, policy, state_of, want, want_state, rounds, label):
    """Restore the session saved at ``path``, run ``rounds`` more, hold its
    losses and every trainable tensor to the uninterrupted run's with
    ``torch.equal``, and return (restore seconds, the resumed metrics, the
    launches its graphs (or eager steps) made)."""
    t0 = time.perf_counter()
    back = RingSession.restore(path, cfg, tc, policy=policy, device="cuda", log=_quiet)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    launches = {name: 0 for name in ops.LAUNCHES}
    got = []
    for _ in range(rounds):
        before = dict(ops.LAUNCHES)
        m, ms, wall = _session_round(back)
        got.append(m)
        _count_session_launches(back, m, before, launches)
    keys = lambda ms_: [(m.step, m.boundary, m.loss, m.extras.get("losses")) for m in ms_]
    equal = keys(got) == keys(want) and all(
        torch.equal(a, b) for a, b in zip(state_of(back), want_state, strict=True))
    for f in (".npz", ".json"):
        os.remove(path + f)
    if not equal:
        raise AssertionError(f"{label}: the resumed run is not the uninterrupted one: "
                             f"{keys(got)} against {keys(want)}")
    return restore_s, got, launches


def _count_session_launches(sess, m, before, launches) -> None:
    """Add one session step's kernel launches: a ring round's graph, and a
    pjit step's, holds what each replay launches (``capture_launches``)."""
    ex = getattr(sess.backend, "driver", None)
    if ex is None:
        be = sess.backend
        for name, n in be.capture_launches[be.last_key].items():
            launches[name] += n
        return
    mode = "direct" if m.cache_hit is None else "cached" if m.cache_hit else "capture"
    for name, n in ex.capture_launches[(m.boundary, mode)].items():
        launches[name] += n


def phase_ring_session(arch: str, records) -> None:
    """The main path's facade at full width: a fused ``RingSession`` on the
    ring of ``phase_ring`` runs 4 rounds across a boundary drop, each round
    beside the bare executor's replay of the same batch from the same state
    (undone), saving after round 2; freed and restored, it runs rounds 3 and
    4, whose losses and every trainable tensor must equal the uninterrupted
    run's (``torch.equal``). The same for a cached session on 2 slots and a
    pjit session. The counters are zeroed before and read after each
    session, and every training kernel must have launched."""
    cfg = served_config(arch)
    tc = TrainConfig(learning_rate=RING_LR, batch_size=1, seq_len=TRAIN_S,
                     n_microbatches=RING_M, n_stages=RING_S, seed=SEED)
    os.makedirs(SESSION_DIR, exist_ok=True)
    launches = {name: 0 for name in ops.LAUNCHES}
    # -- fused, across the boundary drop, beside the bare executor
    policy = lambda: IntervalPolicy(initial_depth=SESSION_DEPTH, interval=2 * RING_S)
    ops.reset_launches()
    t0 = time.perf_counter()
    sess = RingSession.create(cfg, tc, backend="fused", n_stages=RING_S, policy=policy(),
                              device="cuda", log=_quiet)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    ex = sess.backend.driver
    want = []
    for r in range(SESSION_ROUNDS):
        batch = sess.data.next()
        _, tokens, labels = batch
        saved, step, built = [t.clone() for t in ex.trainable_tensors()], ex.step, \
            ex.n_executables
        bare, bare_ms = _event_round(lambda: ex.round(tokens, labels))
        built = ex.n_executables > built
        for t, s_ in zip(ex.trainable_tensors(), saved, strict=True):
            t.copy_(s_)
        ex.step = step
        del saved
        before = dict(ops.LAUNCHES)
        m, ms, wall = _session_round(sess, batch)
        _count_session_launches(sess, m, before, launches)
        if m.extras["losses"] != bare["losses"].tolist():
            raise AssertionError(f"session round {r}: {m.extras['losses']} against the bare "
                                 f"executor's {bare['losses'].tolist()}")
        want.append(m)
        say("ring_session_round", session="fused", round=r, boundary=m.boundary,
            frozen_stages=frozen_stage_count(ex.spans, m.boundary),
            losses=json.dumps([round(x, 5) for x in m.extras["losses"]]),
            session_event_ms=f"{ms:.3f}", session_wall_ms=f"{wall:.3f}",
            bare_event_ms=f"{bare_ms:.3f}", bare_built=built,
            overhead_ms="" if built else f"{ms - bare_ms:.3f}", card=repr(CARD))
        if r + 1 == SESSION_SAVED_AT:
            path, save_s, nbytes = _save(sess, "fused")
    _path_kernels_ran(ops.LAUNCHES, "the fused session")
    want_state = _ring_state(sess)
    del sess, ex
    freed()
    restore_s, got, resumed = _resume(path, cfg, tc, policy(), _ring_state,
                                      want[SESSION_SAVED_AT:], want_state,
                                      SESSION_ROUNDS - SESSION_SAVED_AT, "fused")
    for name, n in resumed.items():
        launches[name] += n
    say("ring_session_resume", session="fused", create_s=f"{create_s:.2f}",
        save_s=f"{save_s:.2f}", restore_s=f"{restore_s:.2f}", checkpoint_bytes=nbytes,
        resumed_losses=json.dumps([round(m.loss, 5) for m in got]), equal=True,
        trainable_tensors=len(want_state), card=repr(CARD))
    del want_state
    freed()
    # -- cached, 2 slots: capture, capture, hit, hit; resumed: capture, capture
    policy_c = lambda: IntervalPolicy(initial_depth=SESSION_DEPTH, interval=4 * RING_S)
    ops.reset_launches()
    sess = RingSession.create(cfg, tc, backend="cached", n_stages=RING_S, policy=policy_c(),
                              slots_per_epoch=CACHE_SLOTS, device="cuda", log=_quiet)
    want = []
    for r in range(SESSION_ROUNDS):
        before = dict(ops.LAUNCHES)
        m, ms, wall = _session_round(sess)
        _count_session_launches(sess, m, before, launches)
        want.append(m)
        say("ring_session_round", session="cached", round=r, slot=m.extras["slot"],
            boundary=m.boundary, cache_hit=m.cache_hit, session_event_ms=f"{ms:.3f}",
            session_wall_ms=f"{wall:.3f}", card=repr(CARD))
        if r + 1 == SESSION_SAVED_AT:
            path, save_s, nbytes = _save(sess, "cached")
    _path_kernels_ran(ops.LAUNCHES, "the cached session")
    hits = [m.cache_hit for m in want]
    if hits != [False, False, True, True]:
        raise AssertionError(f"the cached session's hits {hits}")
    want_state = _ring_state(sess)
    del sess
    freed()
    restore_s, got, resumed = _resume(path, cfg, tc, policy_c(), _ring_state,
                                      want[SESSION_SAVED_AT:], want_state,
                                      SESSION_ROUNDS - SESSION_SAVED_AT, "cached")
    for name, n in resumed.items():
        launches[name] += n
    say("ring_session_resume", session="cached", hits=json.dumps(hits).replace(" ", ""),
        resumed_hits=json.dumps([m.cache_hit for m in got]).replace(" ", ""),
        save_s=f"{save_s:.2f}", restore_s=f"{restore_s:.2f}", checkpoint_bytes=nbytes,
        equal=True, card=repr(CARD))
    del want_state
    freed()
    # -- pjit: the training phase's batches, depths 1, 1, 2, 2
    tc_p = TrainConfig(batch_size=TRAIN_B, seq_len=TRAIN_S, seed=SEED)
    policy_p = lambda: IntervalPolicy(initial_depth=1, interval=SESSION_SAVED_AT)
    ops.reset_launches()
    sess = RingSession.create(cfg, tc_p, backend="pjit", policy=policy_p(), device="cuda",
                              log=_quiet)
    want = []
    for r in range(SESSION_ROUNDS):
        before = dict(ops.LAUNCHES)
        m, ms, wall = _session_round(sess)
        _count_session_launches(sess, m, before, launches)
        want.append(m)
        say("ring_session_round", session="pjit", step=r, boundary=m.boundary,
            loss=f"{m.loss:.5f}", session_event_ms=f"{ms:.3f}",
            session_wall_ms=f"{wall:.3f}", card=repr(CARD))
        if r + 1 == SESSION_SAVED_AT:
            path, save_s, nbytes = _save(sess, "pjit")
    _path_kernels_ran(ops.LAUNCHES, "the pjit session")
    want_state = _pjit_state(sess)
    del sess
    freed()
    restore_s, got, resumed = _resume(path, cfg, tc_p, policy_p(), _pjit_state,
                                      want[SESSION_SAVED_AT:], want_state,
                                      SESSION_ROUNDS - SESSION_SAVED_AT, "pjit")
    for name, n in resumed.items():
        launches[name] += n
    say("ring_session_resume", session="pjit", save_s=f"{save_s:.2f}",
        restore_s=f"{restore_s:.2f}", checkpoint_bytes=nbytes,
        resumed_losses=json.dumps([round(m.loss, 5) for m in got]), equal=True,
        card=repr(CARD))
    _path_kernels_ran(launches, "the sessions' rounds")
    count_launches(records, f"{cfg.name}_ring_session", launches)


def _tenant_rounds(sess, rounds, launches):
    """``rounds`` session steps, each with its executor's record (device
    tensors), its CUDA-event ms and the launches its graph holds added to
    ``launches``."""
    ex = sess.backend.driver
    recs, real = [], ex.round
    ex.round = lambda *a, **kw: (recs.append(real(*a, **kw)), recs[-1])[1]
    ms = []
    for _ in range(rounds):
        before = dict(ops.LAUNCHES)
        m, t, _ = _session_round(sess)
        _count_session_launches(sess, m, before, launches)
        ms.append(t)
    ex.round = real
    return recs, ms


def _gib(nbytes) -> str:
    return f"{nbytes / 2**30:.3f}"


def phase_ring_tenants(arch: str, records) -> None:
    """Several tenants on the ring of ``phase_ring``, one frozen trunk: a fused
    joint session of TENANTS tenants against each tenant's solo session on
    its own stream (losses, adapters, head and moments ``torch.equal``; one
    solo alive at a time), the replays' ms and the sessions' memory; the
    tenants' bundles through an ``AdapterStore`` into ``BatchServer``'s
    registry (each graft ``torch.equal`` to the session's export, the served
    blocks held to their plain versions, the tenants' logits apart); then a
    cached joint session of CACHE_TENANTS tenants on 2 slots against the
    direct joint executor (hits ``torch.equal`` to direct rounds), and tenant
    1's import freeing only its rows."""
    cfg = served_config(arch)
    tc = TrainConfig(learning_rate=RING_LR, batch_size=1, seq_len=TRAIN_S,
                     n_microbatches=RING_M, n_stages=RING_S, seed=SEED)
    params = prm.materialize(cfg, seed=SEED, device="cuda")
    policy = lambda: IntervalPolicy(initial_depth=SESSION_DEPTH, interval=100 * RING_S)
    session = lambda backend, **kw: RingSession.create(
        cfg, tc, backend=backend, n_stages=RING_S, policy=policy(), params=params,
        device="cuda", log=_quiet, **kw)
    launches = {name: 0 for name in ops.LAUNCHES}
    # -- the joint session against the solo ones
    torch.cuda.synchronize()
    trunk = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    joint = session("fused", tenants=TENANTS)
    recs, joint_ms = _tenant_rounds(joint, TENANT_ROUNDS, launches)
    _path_kernels_ran(ops.LAUNCHES, "the joint session")
    torch.cuda.synchronize()
    jx = joint.backend.driver
    boundary = recs[0]["boundary"]
    F, b = frozen_stage_count(jx.spans, boundary), boundary * cfg.layers_per_repeat
    joint_mem = (torch.cuda.memory_allocated() - trunk, torch.cuda.max_memory_allocated() - trunk)
    graph = jx.capture_launches[(boundary, "direct")]
    L, per_round = cfg.n_layers, RING_M * RING_S
    want_graph = {"adapter_fused": TENANTS * L * per_round,
                  "flash_attention": TENANTS * L * per_round,
                  "adapter_fused_bwd": TENANTS * (L - b) * per_round,
                  "flash_attention_bwd": TENANTS * (L - b - 1) * per_round,
                  "mamba_scan": 0, "rwkv_scan": 0}
    ledger = jx.measured_tick_ledger(boundary)
    if graph != want_graph or ledger["phase_a_round_ticks"] != TENANTS * per_round + F - 1:
        raise AssertionError(f"the joint graph holds {graph}, expected {want_graph}; "
                             f"ledger {ledger}")
    solo_ms, solo_mem = [], None
    for t in range(TENANTS):
        torch.cuda.synchronize()
        before_solo = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        solo = session("fused")
        solo.data = RingDataSource(cfg, tc, RING_S, tenant=t)
        srecs, ms = _tenant_rounds(solo, TENANT_ROUNDS, {name: 0 for name in ops.LAUNCHES})
        torch.cuda.synchronize()
        if solo_mem is None:
            solo_mem = (torch.cuda.memory_allocated() - before_solo,
                        torch.cuda.max_memory_allocated() - before_solo)
        solo_ms.append(ms[-1])
        sx = solo.backend.driver
        equal = all(torch.equal(s["losses"], j["tenant_owner_losses"][:, t])
                    and torch.equal(s["loss"], j["tenant_losses"][t])
                    for s, j in zip(srecs, recs, strict=True))
        mine, theirs = jx.export_adapters(t), sx.export_adapters(0)
        mo, so = jx.export_tenant_opt(t), sx.export_tenant_opt(0)
        state_equal = all(torch.equal(x, y) for x, y in zip(
            tree_leaves((mine, mo["m"], mo["v"])), tree_leaves((theirs, so["m"], so["v"])),
            strict=True))
        solo_graph = sx.capture_launches[(boundary, "direct")]
        if {k: TENANTS * n for k, n in solo_graph.items()} != graph:
            raise AssertionError(f"tenant {t}: the solo graph holds {solo_graph}, the joint "
                                 f"{graph}: not a {TENANTS}th")
        say("ring_tenants_solo", tenant=t, losses=json.dumps(
            [[round(x, 5) for x in s["losses"].tolist()] for s in srecs]),
            equal_losses=equal, equal_state=state_equal, replay_event_ms=f"{ms[-1]:.3f}",
            capture_s=f"{sx.capture_seconds[(boundary, 'direct')]:.2f}", card=repr(CARD))
        if not (equal and state_equal):
            raise AssertionError(f"tenant {t}: the joint session's slice is not its solo "
                                 f"session's bit for bit")
        del solo, sx, srecs, mine, theirs, mo, so
        gc.collect()
        torch.cuda.empty_cache()
    tl = [[round(x, 5) for x in r["tenant_losses"].tolist()] for r in recs]
    say("ring_tenants_joint", tenants=TENANTS, boundary=boundary, frozen_stages=F,
        tenant_losses=json.dumps(tl), replay_event_ms=f"{joint_ms[-1]:.3f}",
        solo_replay_event_ms=json.dumps([round(x, 3) for x in solo_ms]),
        tenants_x_solo_ms=f"{sum(solo_ms):.3f}",
        joint_over_solos=f"{joint_ms[-1] / sum(solo_ms):.4f}",
        capture_s=f"{jx.capture_seconds[(boundary, 'direct')]:.2f}",
        resident_gib=_gib(joint_mem[0]), peak_gib=_gib(joint_mem[1]),
        solo_resident_gib=_gib(solo_mem[0]), solo_peak_gib=_gib(solo_mem[1]),
        extra_resident_gib_per_tenant=_gib((joint_mem[0] - solo_mem[0]) / (TENANTS - 1)),
        phase_a_ticks=ledger["phase_a_round_ticks"],
        launches_in_graph=json.dumps(graph).replace(" ", ""), card=repr(CARD))
    if len({tuple(x) for x in tl}) != TENANT_ROUNDS or len(set(tl[-1])) != TENANTS:
        raise AssertionError(f"the tenants' losses do not differ: {tl}")
    # -- the tenants' bundles served from an AdapterStore
    os.makedirs(os.path.dirname(SESSION_DIR), exist_ok=True)         # build/
    root = tempfile.mkdtemp(prefix="tenants_", dir=os.path.dirname(SESSION_DIR))
    store = AdapterStore(root)
    t0 = time.perf_counter()
    for group in joint.tenants:
        group.save_to(store, f"tenant{group.index}")
    save_s = time.perf_counter() - t0
    registry = AdapterRegistry(params, store)
    names = registry.refresh()
    for t in range(TENANTS):
        want = jx.export_adapters(t)
        got = registry.params_for(f"tenant{t}")
        same = all(torch.equal(layer["adapter"][k], want["adapter"][k][i, 0])
                   for i, layer in enumerate(got["blocks"]) for k in layer["adapter"]) and \
            all(torch.equal(got["head"][k], want["head"][k]) for k in want["head"])
        if not same:
            raise AssertionError(f"tenant {t}'s graft is not its session's export")
    del joint, jx, recs
    freed()
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=TENANT_PROMPT) for _ in range(2)]
    requests = [Request(2 * t + i, p, TENANT_NEW, tenant=f"tenant{t}")
                for t in range(TENANTS) for i, p in enumerate(prompts)]
    horizon = TENANT_PROMPT + TENANT_NEW + 8
    server = BatchServer(cfg, params, slots=2, horizon=horizon, registry=registry,
                         device="cuda")
    ops.reset_launches()
    results = server.run(requests, log=lambda *a: None)
    served = dict(ops.LAUNCHES)
    want = {"adapter_fused": L * TENANT_NEW * TENANTS, "flash_attention": L * TENANTS,
            "adapter_fused_bwd": 0, "flash_attention_bwd": 0, "mamba_scan": 0, "rwkv_scan": 0}
    logits = [bt["prefill_logits"] for bt in server.batches]
    apart = all(not torch.equal(logits[i], logits[j]) for i in range(TENANTS)
                for j in range(i))
    _, _, gaps, _ = _plain_run(cfg, registry.params_for("tenant1"), requests[2:4], horizon)
    say("ring_tenants_serve", bundles=json.dumps(names).replace(" ", ""),
        save_s=f"{save_s:.2f}", bundle_bytes=sum(os.path.getsize(os.path.join(root, f))
                                                 for f in os.listdir(root)) // TENANTS,
        requests=len(results), batches=len(server.batches),
        logits_apart=apart, launches=json.dumps(served).replace(" ", ""),
        **{f"bf16_{mode}": f"{g:.3g}" for mode, g in gaps.items()},
        bf16_rtol=BLOCK_RTOL[torch.bfloat16], card=repr(CARD))
    shutil.rmtree(root)
    if sorted(names) != [f"tenant{t}" for t in range(TENANTS)] or served != want or \
            len(server.batches) != TENANTS or not apart or \
            any(len(v) != TENANT_NEW for v in results.values()):
        raise AssertionError(f"serving the tenants: bundles {names}, launches {served} "
                             f"(expected {want}), {len(server.batches)} batches, logits "
                             f"apart {apart}")
    if set(gaps) != {"prefill", "step", "prefill_cache", "step_cache"} or \
            not all(g <= BLOCK_RTOL[torch.bfloat16] for g in gaps.values()):
        raise AssertionError(f"a served tenant's block differs from its plain version: {gaps}")
    count_launches(records, f"{cfg.name}_tenants_served", served)
    del server, registry
    freed()
    # -- the cached joint session against the direct joint executor
    ops.reset_launches()
    sess = session("cached", tenants=CACHE_TENANTS, slots_per_epoch=CACHE_SLOTS)
    exc = sess.backend.driver
    exd = RingExecutor(cfg, tc, params, RING_S, RING_M, schedule=policy(),
                       tenants=CACHE_TENANTS)
    hits, ms_of = [], {}
    for r in range(2 * CACHE_SLOTS + 1):
        if r == 2 * CACHE_SLOTS:
            entries = exc.cache.stats()["cache_entries"]
            exc.import_adapters(1, exc.export_adapters(1))     # frees only tenant 1's rows
            left = exc.cache.stats()["cache_entries"]
        slot, tokens, labels = sess.data.next()
        _copy_state(exd, exc)
        tokens_d, labels_d = exd.to_device(tokens, labels)
        before = dict(ops.LAUNCHES)
        m, ms, _ = _session_round(sess, (slot, tokens, labels))
        _count_session_launches(sess, m, before, launches)
        want, direct_ms = _event_round(lambda: exd.round(tokens_d, labels_d))
        equal = m.extras["losses"] == want["losses"].tolist() and \
            m.extras["tenant_losses"] == want["tenant_losses"].tolist() and all(
                torch.equal(x, y) for x, y in zip(exc.trainable_tensors(),
                                                  exd.trainable_tensors(), strict=True))
        hits.append(m.cache_hit)
        ms_of.setdefault("cached" if m.cache_hit else "capture", []).append(ms)
        say("ring_tenants_cache", round=r, slot=slot, cache_hit=m.cache_hit,
            tenant_hits=json.dumps(m.cache["tenant_cache_hits"]).replace(" ", ""),
            tenant_misses=json.dumps(m.cache["tenant_cache_misses"]).replace(" ", ""),
            equal_to_direct=equal, event_ms=f"{ms:.3f}", direct_event_ms=f"{direct_ms:.3f}",
            card=repr(CARD))
        if not equal:
            raise AssertionError(f"cached joint round {r} is not the direct joint round")
    _path_kernels_ran(ops.LAUNCHES, "the cached joint session")
    st = exc.cache.stats()
    say("ring_tenants_cache_end", hits=json.dumps(hits).replace(" ", ""),
        entries_before_import=entries, entries_after_import=left,
        invalidations=st["cache_invalidations"],
        tenant_hits=json.dumps(exc.tenant_hits).replace(" ", ""),
        tenant_misses=json.dumps(exc.tenant_misses).replace(" ", ""),
        capture_s=f"{exc.capture_seconds[(boundary, 'capture')]:.2f}",
        cached_s=f"{exc.capture_seconds[(boundary, 'cached')]:.2f}", card=repr(CARD))
    if hits != [False, False, True, True, False] or (entries, left) != (4, 2) or \
            exc.tenant_hits != [3, 2] or exc.tenant_misses != [2, 3] or \
            st["cache_invalidations"] != 1:
        raise AssertionError(f"the partitioned cache: hits {hits}, entries {entries} -> "
                             f"{left}, tenant hits {exc.tenant_hits}, misses "
                             f"{exc.tenant_misses}, stats {st}")
    count_launches(records, f"{cfg.name}_ring_tenants", launches)
    del sess, exc, exd


def _seed_trainer(trainer, ex) -> None:
    """Copy executor ``ex``'s trainable state into ``RingTrainer`` ``trainer``
    (the inverse of ``_seed_executor``)."""
    for mine, theirs in ((trainer.stage_adapters(), ex.stage_adapters()),
                         (trainer.m_ad, ex.opt_state["m"]["adapter"]),
                         (trainer.v_ad, ex.opt_state["v"]["adapter"])):
        for a, b in zip(tree_leaves(mine), tree_leaves(theirs), strict=True):
            a.copy_(b)
    for mine, theirs in ((trainer.shared["head"], ex.shared["head"]),
                         (trainer.m_hd, ex.opt_state["m"]["head"]),
                         (trainer.v_hd, ex.opt_state["v"]["head"])):
        for k in mine:
            mine[k].copy_(theirs[k])
    trainer.step = ex.step


def _own_trainables(params):
    """``params`` with its adapters and head cloned (a ``RingTrainer`` trains
    the tree it is given in place; the frozen trunk stays shared)."""
    return {**params, "head": {k: v.clone() for k, v in params["head"].items()},
            "blocks": [{**layer, "adapter": {k: v.clone() for k, v in layer["adapter"].items()}}
                       for layer in params["blocks"]]}


def _spans_of(ex):
    return [list(sp) for sp in ex.spans]


def _elastic_launches(cfg, S, boundary, mode, T=1):
    """What a ring round's graph launches: every layer's forward kernels for
    each owner's microbatches (Phase B's alone on a hit), the backward
    kernels over the hot layers."""
    L, b, per = cfg.n_layers, boundary * cfg.layers_per_repeat, RING_M * S * T
    fwd = (L if mode != "cached" else L - b) * per
    return {"adapter_fused": fwd, "flash_attention": fwd, "adapter_fused_bwd": (L - b) * per,
            "flash_attention_bwd": (L - b - 1) * per, "mamba_scan": 0, "rwkv_scan": 0}


def phase_ring_elastic(arch: str, records) -> None:
    """The elastic ring at full width (fresh weights of the ring of
    ``phase_ring``, depth 8). A cached session on CACHE_SLOTS slots under
    ELASTIC_CHAOS (``elastic=True``) crashes device 2 before round 2 (spans
    11, 11, 10, boundary 22) and takes it back before round 5 (4 stages of 8,
    boundary 24). Every round is held with ``torch.equal`` (losses and every
    tensor a round writes) to a from-scratch fused ``RingExecutor`` at the
    live spans seeded with the state before the round (one twin per
    geometry, dropped before the change), the first round after the crash
    also to ``RingTrainer`` at S = 3; the graph's launches to L·M·S forward
    (Phase B's alone on a hit), d·M·S and (d − 1)·M·S backward, a build
    counting them twice and a replay none; the first hit of each geometry is
    replayed once more from the same state and timed. Each round prints S,
    spans, boundary, mode, event ms or capture s, allocated, peak and
    reserved GiB; reserved after the rejoin's recapture must stay within
    ELASTIC_POOL_SLACK_GIB of reserved after the first captures at S = 4.
    Then a fused joint session of CACHE_TENANTS tenants under
    ELASTIC_TENANT_CHAOS, each round after the crash held to a from-scratch
    joint executor at the shrunk spans, every tenant's slice of every leaf a
    contiguous, aligned view after the restack."""
    cfg = served_config(arch)
    tc = TrainConfig(learning_rate=RING_LR, batch_size=1, seq_len=TRAIN_S,
                     n_microbatches=RING_M, n_stages=RING_S, seed=SEED)
    params = prm.materialize(cfg, seed=SEED, device="cuda")
    policy = lambda: IntervalPolicy(initial_depth=SESSION_DEPTH, interval=100 * RING_S)
    logs, launches = [], {name: 0 for name in ops.LAUNCHES}
    ops.reset_launches()
    sess = RingSession.create(cfg, tc, backend="cached", n_stages=RING_S, policy=policy(),
                              slots_per_epoch=CACHE_SLOTS, params=params,
                              chaos=list(ELASTIC_CHAOS), elastic=True, device="cuda",
                              log=logs.append)
    ex, be = sess.backend.driver, sess.backend
    ptrs = [t.data_ptr() for t in ex.trainable_tensors()]
    ran = {name: 0 for name in ops.LAUNCHES}            # the session's own launches
    twin, reserved, trace = None, {}, []
    crash_round = int(ELASTIC_CHAOS[0].split(":")[0])
    for r in range(ELASTIC_ROUNDS):
        if be.events and be.events[0].round == r:
            twin = None                                 # the old geometry's twin goes first
            gc.collect()
        slot, tokens, labels = sess.data.next()
        before, step = [t.clone() for t in ex.trainable_tensors()], ex.step
        builds = dict(ex.build_counts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counted = dict(ops.LAUNCHES)
        m, ms, wall = _session_round(sess, (slot, tokens, labels))
        counted = {k: ops.LAUNCHES[k] - counted[k] for k in counted}
        for k, n in counted.items():
            ran[k] += n
        mem = (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated(),
               torch.cuda.memory_reserved())
        mode = "cached" if m.cache_hit else "capture"
        built = ex.build_counts.get((m.boundary, mode), 0) != builds.get((m.boundary, mode), 0)
        graph = ex.capture_launches[(m.boundary, mode)]
        _count_session_launches(sess, m, {}, launches)
        want_graph = _elastic_launches(cfg, ex.S, m.boundary, mode)
        rows = list(be.survivors)
        tokens_d, labels_d = ex.to_device(tokens[rows], labels[rows])
        if twin is None:
            twin = RingExecutor(cfg, tc, params, ex.S, RING_M, spans=ex.spans, schedule=policy())
        if twin.spans != ex.spans:
            raise AssertionError(f"round {r}: the layout moved to {ex.spans} without an event")
        for a, b in zip(twin.trainable_tensors(), before, strict=True):
            a.copy_(b)
        twin.step = step
        trainer_equal = None
        if r == crash_round:                            # the first round after the crash
            trainer = RingTrainer(cfg, tc, _own_trainables(params), ex.S, RING_M,
                                  spans=ex.spans, schedule=policy())
            _seed_trainer(trainer, twin)
        want, twin_ms = _event_round(lambda: twin.round(tokens_d, labels_d))
        equal = m.extras["losses"] == want["losses"].tolist() and all(
            torch.equal(a, b) for a, b in zip(ex.trainable_tensors(), twin.trainable_tensors(),
                                              strict=True))
        if r == crash_round:
            rec = trainer.round(tokens_d, labels_d)
            F = frozen_stage_count(ex.spans, m.boundary)
            mine, theirs = _trainable_state(ex, F), _trainable_state(trainer, F)
            trainer_equal = [it["loss"] for it in rec["iterations"]] == m.extras["losses"] \
                and all(torch.equal(mine[k], theirs[k]) for k in theirs)
            del trainer, rec, mine, theirs
        hit_ms = None
        if mode == "cached" and built:                  # time a replay of the new hit graph
            after = [t.clone() for t in ex.trainable_tensors()]
            for a, b in zip(ex.trainable_tensors(), before, strict=True):
                a.copy_(b)
            ex.step = step
            again, hit_ms = _event_round(lambda: ex.round(tokens_d, labels_d, slot=slot))
            if not (again["cache_hit"] and again["losses"].tolist() == m.extras["losses"]
                    and all(torch.equal(a, b) for a, b in zip(ex.trainable_tensors(), after))):
                raise AssertionError(f"round {r}: the hit's replay is not its round")
            del after, again
        trace.append((ex.S, m.boundary, mode))
        say("ring_elastic_round", round=r, slot=slot, S=ex.S,
            spans=json.dumps(_spans_of(ex)).replace(" ", ""), boundary=m.boundary, mode=mode,
            layout_changed=bool(m.extras.get("layout_changed")),
            survivors=json.dumps(rows).replace(" ", ""),
            losses=json.dumps([round(x, 5) for x in m.extras["losses"]]),
            equal_to_twin=equal, equal_to_ring_trainer=trainer_equal,
            **({"capture_s": f"{ex.capture_seconds[(m.boundary, mode)]:.2f}",
                "build_round_event_ms": f"{ms:.3f}"} if built else
               {"replay_event_ms": f"{ms:.3f}"}),
            replay_wall_ms=f"{wall:.1f}", hit_replay_event_ms=None if hit_ms is None
            else f"{hit_ms:.3f}", twin_direct_event_ms=f"{twin_ms:.3f}",
            allocated_gib=_gib(mem[0]), peak_gib=_gib(mem[1]), reserved_gib=_gib(mem[2]),
            launches_in_graph=json.dumps(graph).replace(" ", ""),
            launches_counted=json.dumps(counted).replace(" ", ""), card=repr(CARD))
        reserved[r] = mem[2]
        if not equal or trainer_equal is False or not all(
                math.isfinite(x) for x in m.extras["losses"]):
            raise AssertionError(f"round {r}: not its from-scratch twin's (equal {equal}) or "
                                 f"RingTrainer's ({trainer_equal}): {m.extras['losses']} "
                                 f"against {want['losses'].tolist()}")
        if graph != want_graph or counted != ({k: 2 * n for k, n in graph.items()} if built
                                              else {k: 0 for k in graph}):
            raise AssertionError(f"round {r} ({mode}, S {ex.S}, boundary {m.boundary}): the "
                                 f"graph holds {graph}, expected {want_graph}; the round "
                                 f"counted {counted} (built: {built})")
        del before, want
    twin = None
    gc.collect()
    want_trace = [(4, 24, "capture")] * 2 + [(3, 22, "capture")] * 2 + [(3, 22, "cached")] + \
        [(4, 24, "capture")] * 2 + [(4, 24, "cached")]
    leak = (reserved[6] - reserved[1]) / 2**30
    say("ring_elastic_memory", reserved_before_crash_gib=_gib(reserved[1]),
        reserved_after_recapture_at_S3_gib=_gib(reserved[3]),
        reserved_after_rejoin_recapture_gib=_gib(reserved[6]), rise_gib=f"{leak:.3f}",
        slack_gib=ELASTIC_POOL_SLACK_GIB, card=repr(CARD))
    say("ring_elastic_log", lines=json.dumps([str(x) for x in logs]))
    if trace != want_trace or be.shrinks != 1 or be.survivors != list(range(RING_S)):
        raise AssertionError(f"the elastic walk: {trace} against {want_trace}, shrinks "
                             f"{be.shrinks}, survivors {be.survivors}")
    if leak > ELASTIC_POOL_SLACK_GIB:
        raise AssertionError(f"reserved memory rose {leak:.3f} GiB across the crash and the "
                             f"rejoin: a dropped graph's pool stayed reserved")
    if [t.data_ptr() for t in ex.trainable_tensors()] != ptrs:
        raise AssertionError("a shrink or grow reallocated a state tensor")
    _path_kernels_ran(ran, "the elastic session")
    del sess, ex, be
    freed()
    # -- a fused joint session of 2 tenants through a crash
    ops.reset_launches()
    sess = RingSession.create(cfg, tc, backend="fused", n_stages=RING_S, policy=policy(),
                              tenants=CACHE_TENANTS, params=params, chaos=ELASTIC_TENANT_CHAOS,
                              elastic=True, device="cuda", log=logs.append)
    ex, be = sess.backend.driver, sess.backend
    ran = {name: 0 for name in ops.LAUNCHES}
    twin = None
    for r in range(ELASTIC_TENANT_ROUNDS):
        slot, tokens, labels = sess.data.next()
        before, step = [t.clone() for t in ex.trainable_tensors()], ex.step
        counted = dict(ops.LAUNCHES)
        m, ms, _ = _session_round(sess, (slot, tokens, labels))
        for k in ran:
            ran[k] += ops.LAUNCHES[k] - counted[k]
        _count_session_launches(sess, m, {}, launches)
        graph = ex.capture_launches[(m.boundary, "direct")]
        equal = None
        if ex.S < RING_S:
            ex._check_tenant_views()
            rows = list(be.survivors)
            if twin is None:
                twin = RingExecutor(cfg, tc, params, ex.S, RING_M, spans=ex.spans,
                                    schedule=policy(), tenants=CACHE_TENANTS)
            for a, b in zip(twin.trainable_tensors(), before, strict=True):
                a.copy_(b)
            twin.step = step
            want = twin.round(*ex.to_device(tokens[rows], labels[rows]))
            equal = m.extras["losses"] == want["losses"].tolist() and \
                m.extras["tenant_losses"] == want["tenant_losses"].tolist() and all(
                    torch.equal(a, b) for a, b in zip(ex.trainable_tensors(),
                                                      twin.trainable_tensors(), strict=True))
        say("ring_elastic_tenants_round", round=r, S=ex.S,
            spans=json.dumps(_spans_of(ex)).replace(" ", ""), boundary=m.boundary,
            tenant_losses=json.dumps([round(x, 5) for x in m.extras["tenant_losses"]]),
            equal_to_twin=equal, event_ms=f"{ms:.3f}",
            capture_s=f"{ex.capture_seconds[(m.boundary, 'direct')]:.2f}",
            launches_in_graph=json.dumps(graph).replace(" ", ""),
            reserved_gib=_gib(torch.cuda.memory_reserved()), card=repr(CARD))
        if graph != _elastic_launches(cfg, ex.S, m.boundary, "direct", T=CACHE_TENANTS) or \
                (ex.S < RING_S and not equal) or (ex.S < RING_S) != (r >= 1):
            raise AssertionError(f"joint round {r}: S {ex.S}, equal to its twin {equal}, "
                                 f"graph {graph}")
        del before
    _path_kernels_ran(ran, "the elastic joint session")
    count_launches(records, f"{cfg.name}_ring_elastic", launches)
    del sess, ex, be, twin


# ---------------------------------------------------------------- phases 6-9
def _held_gradients(cfg, params, batch, boundary, f32: bool = True) -> None:
    """The kernel path's loss and gradients against impl="plain" at
    ``boundary``, held as phase_train holds depths 1 and 2. Where a moe
    block lies above the lowest hot layer, that layer's gradient passes
    through the block's router softmax over nearly uniform probabilities,
    whose backward (p (dp - <dp, p>)) cancels: in bf16 the two paths'
    roundings then part as mbert-squad's do below its top layer (PERF.md
    section 6). There, as phase_train_qa holds mbert's depth 2, the whole hot
    region in bf16 is a witness, and held are the backward kernels alone in
    bf16 and, with ``f32`` (where the model's f32 copy fits), the whole hot
    region in f32 at DEEP_F32_RMS_RTOL."""
    hot = kvcache.layer_kinds(cfg)[boundary * cfg.layers_per_repeat:]
    if "moe" not in hot[1:]:
        _grad_check(cfg, params, batch, boundary)
        return
    _grad_check(cfg, params, batch, boundary, gate=False)
    _grad_check(cfg, params, batch, boundary, backward_only=True)
    if f32:
        params32 = tree_map(lambda t: t.float(), params)
        _grad_check(dataclasses.replace(cfg, dtype="float32"), params32, batch, boundary,
                    rtol=DEEP_F32_RMS_RTOL)
        del params32
        gc.collect()
        torch.cuda.empty_cache()


def _slice_train(cfg, params, records, depths, grad_depths=(1, 2)) -> None:
    """The kernel path's loss and gradients against impl="plain" on one batch
    of 4 x 512 at ``grad_depths`` (:func:`_held_gradients`), then
    PjitBackend's steps at ``depths`` (TRAIN_INTERVAL each), graphed against
    eager (:func:`_pjit_walk`): every step ``torch.equal``, the launches at
    (L, d, L, d - 1)."""
    tc = TrainConfig(batch_size=TRAIN_B, seq_len=TRAIN_S, seed=SEED)
    batch = to_device(data_source(cfg, tc).next(), "cuda")
    for depth in grad_depths:
        _held_gradients(cfg, params, batch, depth_to_boundary(cfg, depth))
    del batch
    ops.reset_launches()
    launches, times = _pjit_walk(cfg, tc, params, depths, "slice_pjit")
    _path_kernels_ran(ops.LAUNCHES, f"{cfg.name}'s graphed steps")
    count_launches(records, f"{cfg.name}_pjit_graph", launches)
    say("slice_pjit_time", arch=cfg.name, layers=cfg.n_layers, batch=TRAIN_B, seq_len=TRAIN_S,
        **{f"depth{d}_{k}": json.dumps([round(x, 3) for x in v]).replace(" ", "")
           for d, t in times.items() for k, v in t.items()}, card=repr(CARD))


def _one_step(cfg, params, records) -> None:
    """One eager ``make_train_step`` at depth 1 (the top pattern repeat hot)
    on a batch of 4 x 512, after its loss and gradients are held against
    impl="plain" in bf16 (:func:`_held_gradients`; its f32 copy would not
    fit): the launches at (L, d, L, d - 1), the frozen layers' adapters
    bit-identical, the top adapter moved, moe_aux and moe_z reported."""
    tc = TrainConfig(batch_size=TRAIN_B, seq_len=TRAIN_S, seed=SEED)
    batch = to_device(data_source(cfg, tc).next(), "cuda")
    boundary = depth_to_boundary(cfg, 1)
    _held_gradients(cfg, params, batch, boundary, f32=False)
    L, n_frozen = cfg.n_layers, boundary * cfg.layers_per_repeat
    d = L - n_frozen
    opt = adamw.init(training.full_trainable(params, cfg))
    clone = lambda tree: {k: t.clone() for k, t in tree.items()}
    frozen = [clone(params["blocks"][i]["adapter"]) for i in range(n_frozen)]
    top = clone(params["blocks"][-1]["adapter"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    params, opt, metrics = training.make_train_step(cfg, tc, boundary)(params, opt, batch)
    loss = metrics["loss"].item()
    wall = 1e3 * (time.perf_counter() - t0)
    got = dict(ops.LAUNCHES)
    want = {"adapter_fused": L, "adapter_fused_bwd": d, "flash_attention": L,
            "flash_attention_bwd": d - 1, "mamba_scan": 0, "rwkv_scan": 0}
    say("slice_step", arch=cfg.name, layers=L, depth=d, boundary=boundary, loss=f"{loss:.5f}",
        **{k: f"{metrics[k].item():.4g}" for k in ("moe_aux", "moe_z", "grad_norm")},
        step_ms=f"{wall:.2f}", peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
        launches=json.dumps(got).replace(" ", ""), card=repr(CARD))
    if got != want or not math.isfinite(loss):
        raise AssertionError(f"{cfg.name} step: launches {got} != {want} or loss {loss}")
    if not all(torch.equal(params["blocks"][i]["adapter"][k], t)
               for i, tree in enumerate(frozen) for k, t in tree.items()):
        raise AssertionError(f"{cfg.name} step: a frozen adapter moved")
    if all(torch.equal(params["blocks"][-1]["adapter"][k], t) for k, t in top.items()):
        raise AssertionError(f"{cfg.name} step: the top adapter did not move")
    count_launches(records, f"{cfg.name}_train", got)


def phase_starcoder2(records) -> None:
    """starcoder2-7b at its published width and depth: served (blocks held
    to their plain versions in bf16 and f32), then the gradients at depths 1
    and 2 and six graphed steps at depths 1, 2, 32."""
    arch = "starcoder2-7b"
    params = phase_serve(arch, records, cpu_witness=False)
    cfg = served_config(arch)
    _slice_train(cfg, params, records, (1, 2, cfg.n_layers))


def phase_olmoe(records) -> None:
    """olmoe-1b-7b at its published width and depth, served and trained as
    starcoder2-7b, then as the ring (phase_ring's checks): RingTrainer and
    the fused RingExecutor, 4 stages of 4 layers at 3, 2, 0 frozen stages."""
    arch = "olmoe-1b-7b"
    params = phase_serve(arch, records, cpu_witness=False)
    cfg = served_config(arch)
    _slice_train(cfg, params, records, (1, 2, cfg.n_layers))
    gc.collect()
    torch.cuda.empty_cache()
    tc = TrainConfig(learning_rate=RING_LR, batch_size=1, seq_len=TRAIN_S,
                     n_microbatches=RING_M, n_stages=RING_S, seed=SEED)
    _ring_walk(cfg, tc, params, records, OLMOE_RING_DEPTHS, None, "ring")


def phase_moonshot(records) -> None:
    """moonshot-v1-16b-a3b at its published width, 4 of its 48 layers:
    served, then the gradients at depth 1 and two graphed steps at depth 4."""
    arch = "moonshot-v1-16b-a3b"
    params = phase_serve(arch, records, cpu_witness=False, layers=MOONSHOT_LAYERS)
    cfg = served_config(arch, MOONSHOT_LAYERS)
    _slice_train(cfg, params, records, (cfg.n_layers,), grad_depths=(1,))


def phase_llama4(records) -> None:
    """llama4-maverick at its published width, one repeat (a dense and a moe
    layer, 128 experts top 1), bf16 only: served, then one step at depth 1."""
    arch = "llama4-maverick-400b-a17b"
    params = phase_serve(arch, records, cpu_witness=False, layers=LLAMA4_LAYERS, f32=False)
    _one_step(served_config(arch, LLAMA4_LAYERS), params, records)


def freed() -> None:
    gc.collect()
    torch.cuda.empty_cache()
    say("freed", gib_on_card=f"{torch.cuda.memory_allocated() / 2**30:.2f}")


def main() -> None:
    global CARD
    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    CARD = card()
    print(CARD, flush=True)
    phase_environment()
    records = {name: {"name": name, "route": "cuda", "source": src, "replaces": rep}
               for name, (src, rep) in SOURCES.items()}
    say("previous", source="PERF.md section 6",
        timer=repr("rwkv_scan and adapter_fused_tile CUDA graph, others eager"),
        **{f"{name}_ms": ms for name, ms in PREVIOUS_MS.items()})
    phase_kernels(records)
    params = phase_serve("qwen2.5-3b", records, cpu_witness=True)
    phase_train("qwen2.5-3b", params, records)
    del params
    freed()                                             # qwen2.5-3b before stablelm-3b
    phase_train_only("stablelm-3b", records)
    freed()                                             # fresh weights, graphed steps
    t0 = time.perf_counter()
    phase_pjit_graph("stablelm-3b", records)
    say("pjit_graph", seconds=f"{time.perf_counter() - t0:.1f}")
    freed()                                             # the paper's own model
    t0 = time.perf_counter()
    phase_train_qa("mbert-squad", records)
    say("train_qa", seconds=f"{time.perf_counter() - t0:.1f}")
    freed()                                             # fresh weights for the ring
    phase_ring("stablelm-3b", records)
    freed()                                             # fresh weights for the cached ring
    phase_ring_cache("stablelm-3b", records)
    freed()                                             # fresh weights for the sessions
    t0 = time.perf_counter()
    phase_ring_session("stablelm-3b", records)
    say("ring_session", seconds=f"{time.perf_counter() - t0:.1f}")
    freed()                                             # fresh weights for the tenants
    t0 = time.perf_counter()
    phase_ring_tenants("stablelm-3b", records)
    say("ring_tenants", seconds=f"{time.perf_counter() - t0:.1f}")
    freed()                                             # fresh weights for the elastic ring
    t0 = time.perf_counter()
    phase_ring_elastic("stablelm-3b", records)
    say("ring_elastic", seconds=f"{time.perf_counter() - t0:.1f}")
    freed()                                             # stablelm-3b before rwkv6-7b
    phase_serve("rwkv6-7b", records, cpu_witness=False)
    freed()                                             # rwkv6-7b before hymba-1.5b
    phase_serve("hymba-1.5b", records, cpu_witness=False)
    for phase in (phase_starcoder2, phase_olmoe, phase_moonshot, phase_llama4):
        freed()                                         # the last arch before the next
        t0 = time.perf_counter()
        phase(records)
        say(phase.__name__.removeprefix("phase_"), seconds=f"{time.perf_counter() - t0:.1f}")
    say("total", seconds=f"{time.perf_counter() - start:.1f}")
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(CARD, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
