"""Decoder (dense, MoE, RWKV-6 and Hymba blocks): embed, blocks, head; the
training forward with RingAda's unfreeze boundary, prefill and decode.

Parameters follow ``models/params.py`` (one dict per layer). The functions
mirror the reference's ``models/transformer.py``: ``forward`` runs a full
sequence, with the static unfreeze ``boundary`` (frozen repeats from the
bottom) when training, ``prefill`` runs a prompt and fills the cache (KV by
gathers, recurrent state by the scan), and ``decode_step`` adds one token per
row. ``forward`` returns ``(logits, aux)`` as the reference's does: ``aux``
sums the moe blocks' ``moe_aux`` and ``moe_z`` over the layers (zeros for a
model without moe blocks); prefill and decode drop them.

A model with hymba blocks puts its ``n_meta`` = 128 learned meta tokens
before every prompt: positions run over the ``n_meta + S`` tokens, the meta
tokens fill the cache's first (sink) slots, and ``forward`` drops their rows
before the head.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import kvcache
from repro_torch.models.blocks import BlockCtx, apply_block, norm


AUX_KEYS = ("moe_aux", "moe_z")


def _check(cfg: ModelConfig) -> None:
    if any(kind not in ("dense", "moe", "rwkv", "hymba") for kind, _ in cfg.pattern) \
            or cfg.enc_dec or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: only dense, moe, rwkv and hymba decoders are ported yet "
            f"(ROADMAP.md Queue 1, 'The other block kinds')")


def n_meta(cfg: ModelConfig) -> int:
    """Hymba's meta tokens, prepended to every prompt (0 for other models)."""
    return 128 if any(kind == "hymba" for kind, _ in cfg.pattern) else 0


def _embed_prompt(cfg: ModelConfig, params, tokens: torch.Tensor):
    """(h [B, nm + S, D], positions [B, nm + S]): the meta rows, then the tokens."""
    B, S = tokens.shape
    nm = n_meta(cfg)
    pos = torch.arange(nm + S, device=tokens.device).expand(B, nm + S)
    h = embed(cfg, params, tokens, pos[:, nm:])
    if nm:
        meta = params["meta"][None].to(h.dtype).expand(B, nm, cfg.d_model)
        h = torch.cat([meta, h], dim=1)
    return h, pos


def embed(cfg: ModelConfig, params, tokens: torch.Tensor,
          positions: torch.Tensor) -> torch.Tensor:
    h = params["embed"]["tok"][tokens]
    if not cfg.rope and "pos" in params["embed"]:       # learned positions
        pt = params["embed"]["pos"]
        h = h + pt[torch.clamp(positions, 0, pt.shape[0] - 1)]
    return h


def head(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    logits = norm(cfg, params["final_norm"], h) @ params["head"]["w"]
    if cfg.head_out is None and cfg.padded_vocab > cfg.vocab_size:
        # the vocab is padded; pad logits never win
        ids = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = logits + torch.where(ids < cfg.vocab_size, 0.0, -1e30).to(logits.dtype)
    return logits


def _run(cfg: ModelConfig, params, h: torch.Tensor, ctx: BlockCtx, caches=None):
    new_caches = []
    for i, (kind, layer) in enumerate(zip(kvcache.layer_kinds(cfg), params["blocks"])):
        h, nc, _ = apply_block(kind, cfg, layer, h, ctx,
                               None if caches is None else caches[i])
        new_caches.append(nc)
    return h, new_caches


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *, boundary: int = 0,
            hot_adapters: Optional[List[Dict[str, torch.Tensor]]] = None,
            head_params: Optional[Dict[str, torch.Tensor]] = None,
            impl: str = "kernel") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(logits [B, S, V], aux) of a full sequence; ``aux`` is the f32 sums of
    the blocks' ``moe_aux`` and ``moe_z``.

    ``boundary`` counts frozen repeats from the bottom. Their layers run under
    ``torch.no_grad()`` and h is detached after them: RingAda's early-stop
    point, below which no gradient flows and nothing is saved for one. When
    training, the differentiated leaves come separately: ``hot_adapters``, the
    adapters of the layers above the boundary in order, and ``head_params``.
    The frozen weights of hot layers need no gradient, so autograd forms only
    input gradients through them.
    """
    _check(cfg)
    h, pos = _embed_prompt(cfg, params, tokens)
    ctx = BlockCtx(cfg=cfg, mode="seq", positions=pos, impl=impl)
    kinds = kvcache.layer_kinds(cfg)
    blocks = params["blocks"]
    n_frozen = boundary * cfg.layers_per_repeat
    if hot_adapters is not None and len(hot_adapters) != len(blocks) - n_frozen:
        raise ValueError(f"{len(hot_adapters)} hot adapters for {len(blocks) - n_frozen} "
                         f"layers above boundary {boundary}")
    aux = {k: torch.zeros((), dtype=torch.float32, device=h.device) for k in AUX_KEYS}

    def add(block_aux):
        for k, v in block_aux.items():
            aux[k] = aux[k] + v

    with torch.no_grad():                 # the frozen layers' aux carry no gradient
        for i in range(n_frozen):
            h, _, block_aux = apply_block(kinds[i], cfg, blocks[i], h, ctx)
            add(block_aux)
    # === RingAda early-stop point: no gradients flow below this line ===
    h = h.detach()
    for i in range(n_frozen, len(blocks)):
        layer = blocks[i]
        if hot_adapters is not None:
            layer = {**layer, "adapter": hot_adapters[i - n_frozen]}
        h, _, block_aux = apply_block(kinds[i], cfg, layer, h, ctx)
        add(block_aux)
    hp = params if head_params is None else {**params, "head": head_params}
    return head(cfg, hp, h[:, n_meta(cfg):]), aux


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            seq_len: Optional[int] = None, impl: str = "kernel",
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the prompt; return (last-token logits [B, V], filled cache).

    ``seq_len``: the decode horizon the cache must support (>= meta tokens +
    prompt length). Every row has positions 0..nm+S-1 (the server left-pads
    with token 0 and attends to the pads, as the reference does).
    """
    _check(cfg)
    B = tokens.shape[0]
    dev = tokens.device
    h, pos = _embed_prompt(cfg, params, tokens)
    S = pos.shape[1]                                      # meta tokens + prompt
    seq_len = seq_len or S
    cache = kvcache.init_cache(cfg, B, seq_len, device=dev)

    # for each cache slot, the last prompt position landing in it (ring
    # buffer), or -1 if unwritten: a deterministic gather-fill
    ck = kvcache.cache_len(cfg, seq_len)
    ns = kvcache.n_sink(cfg)
    if (cfg.sliding_window is None or ck >= seq_len) and S > ck:
        raise ValueError(f"prompt ({S} with {n_meta(cfg)} meta tokens) exceeds the cache "
                         f"horizon ({ck}); raise seq_len")
    slots = torch.arange(ck, device=dev)
    if cfg.sliding_window is not None and ck < seq_len:
        w = ck - ns
        cand = torch.where(slots < ns, slots,
                           slots + w * (torch.clamp(S - 1 - slots, min=0) // w))
    else:
        cand = slots
    fill_pos = torch.where(cand < S, cand, -1)
    cache["pos"] = fill_pos[None].expand(B, ck).clone()
    cache["next"] = torch.full((B,), S, dtype=torch.int64, device=dev)

    ctx = BlockCtx(cfg=cfg, mode="prefill", positions=pos, impl=impl,
                   cache_positions=cache["pos"],
                   write_slots=torch.where(fill_pos < 0, 0, fill_pos)[None].expand(B, ck))
    h, cache["layers"] = _run(cfg, params, h, ctx, cache["layers"])
    logits = head(cfg, params, h[:, -1:])[:, 0]
    return logits, cache


def decode_step(params, token: torch.Tensor, cache: Dict[str, Any], cfg: ModelConfig, *,
                impl: str = "kernel") -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. token [B, 1]. Returns (logits [B, V], the cache).

    The cache is updated in place (the reference donates it to the step).
    """
    pos = cache["next"][:, None]                                  # [B, 1]
    ck = cache["pos"].shape[1]
    seq_len_equiv = ck if cfg.sliding_window is None else cfg.max_seq_len
    slot = torch.clamp(kvcache.write_slot(cfg, pos, seq_len_equiv), max=ck - 1)
    cache["pos"].scatter_(1, slot, pos)
    ctx = BlockCtx(cfg=cfg, mode="step", positions=pos, impl=impl,
                   cache_positions=cache["pos"], write_slots=slot)
    h, cache["layers"] = _run(cfg, params, embed(cfg, params, token, pos), ctx,
                              cache["layers"])
    cache["next"] += 1
    return head(cfg, params, h)[:, 0], cache
