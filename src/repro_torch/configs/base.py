"""Model configurations for the PyTorch port (a copy of the JAX package's).

The port keeps its own copy of :class:`ModelConfig`, :class:`AdapterConfig`,
:class:`SSMConfig` and :class:`TrainConfig` so it never imports the JAX package. Field names, defaults and :meth:`ModelConfig.reduced`
are the same as the reference's, so a config built on either side describes the
same model; ``tests/test_torch_*.py`` hold the two together.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

# dense : GQA self-attention + dense FFN
# moe   : GQA self-attention + mixture-of-experts FFN
# rwkv  : RWKV-6 time-mix + channel-mix (attention-free)
# hymba : parallel attention + Mamba(SSM) heads sharing one residual, + FFN
# cross : self-attention + cross-attention (encoder memory) + dense FFN
BLOCK_KINDS = ("dense", "moe", "rwkv", "hymba", "cross")


@dataclass(frozen=True)
class AdapterConfig:
    """Serial adapter (Houlsby / MAD-X style), the paper's trainable module."""

    bottleneck: int = 64          # m — bottleneck dimension
    activation: str = "gelu"      # σ(·), tanh-form gelu as in jax.nn.gelu
    # Zero-init of W_up makes a never-trained adapter an exact identity.
    zero_init_up: bool = True


@dataclass(frozen=True)
class SSMConfig:
    """Covers both RWKV-6 and Mamba-style (hymba) recurrences."""

    state_size: int = 16          # mamba N; rwkv uses head_dim x head_dim state
    head_dim: int = 64            # rwkv head size
    dt_rank: int = 64             # mamba delta low-rank
    conv_width: int = 4           # mamba local conv
    decay_lora: int = 64          # rwkv6 data-dependent decay LoRA dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    pattern: Tuple[Tuple[str, int], ...] = (("dense", 1),)
    repeats: Optional[int] = None    # default n_layers // pattern length
    rope: bool = True
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    adapter: AdapterConfig = field(default_factory=AdapterConfig)
    moe: Optional[Any] = None        # the MoE sub-config: its block is not ported
    ssm: Optional[SSMConfig] = None
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_is_causal: bool = False
    n_frontend_tokens: int = 0
    frontend: Optional[str] = None
    head_out: Optional[int] = None   # None => LM head (vocab)
    vocab_pad_to: int = 256
    kv_quant: bool = False
    norm: str = "rmsnorm"
    activation: str = "silu"
    glu: bool = True
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    max_seq_len: int = 524_288
    source: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        per_rep = sum(c for _, c in self.pattern)
        if self.repeats is None:
            if self.n_layers % per_rep:
                raise ValueError(f"{self.name}: {self.n_layers} layers, pattern of {per_rep}")
            object.__setattr__(self, "repeats", self.n_layers // per_rep)
        if self.repeats * per_rep != self.n_layers:
            raise ValueError(f"{self.name}: pattern {self.pattern} x {self.repeats} "
                             f"!= {self.n_layers} layers")
        for kind, _ in self.pattern:
            if kind not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {kind!r}")
            if kind in ("rwkv", "hymba") and self.ssm is None:
                raise ValueError(f"{self.name}: ssm pattern without SSMConfig")

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return -(-self.vocab_size // p) * p

    @property
    def out_dim(self) -> int:
        return self.head_out or self.padded_vocab

    @property
    def layers_per_repeat(self) -> int:
        return sum(c for _, c in self.pattern)

    def param_count(self) -> int:
        """Exact backbone parameter count (the port's own ``models.params``)."""
        from repro_torch.models import params as P  # local import to avoid a cycle

        return P.count_params(self)

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family variant used by CPU tests (<=2 repeats, d<=512)."""
        small: Dict = dict(
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else self.n_kv_heads,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            head_dim=64,
            max_seq_len=4096,
        )
        per_rep = self.layers_per_repeat
        reps = 1 if per_rep > 1 else 2
        small["repeats"] = reps
        small["n_layers"] = reps * per_rep
        if self.moe is not None:
            small["moe"] = replace(self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                                   d_expert=128)
        if self.ssm is not None:
            small["ssm"] = replace(self.ssm, state_size=min(self.ssm.state_size, 8),
                                   head_dim=32, dt_rank=16, decay_lora=16)
        if self.enc_dec:
            small["n_enc_layers"] = 2
        if self.n_frontend_tokens:
            small["n_frontend_tokens"] = 16
        if self.sliding_window:
            small["sliding_window"] = 128
        small["adapter"] = replace(self.adapter, bottleneck=16)
        if self.n_kv_heads == self.n_heads:
            small["n_kv_heads"] = small["n_heads"]
        small.update(overrides)
        return replace(self, **small)


@dataclass(frozen=True)
class TrainConfig:
    """Training setup (the paper's Algorithm 1 knobs), field for field the
    reference's."""

    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    warmup_steps: int = 20
    batch_size: int = 8
    seq_len: int = 128
    steps: int = 200
    # --- RingAda schedule (Algorithm 1) ---
    initial_unfreeze_depth: int = 1   # d: head + top-most adapter
    unfreeze_interval: int = 40       # k: unfreeze one more adapter every k steps
    max_unfreeze_depth: Optional[int] = None   # default n_layers
    local_iterations: int = 1         # I per initiator
    # --- pipeline ---
    n_stages: int = 4
    n_microbatches: int = 8
    seed: int = 0


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch id {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populate the registry)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> List[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
