"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B] — MoE decoder.

48L d_model=2048 16H (MHA) d_ff=1408 vocab=163840, 64 experts top-6:
DeepSeek-style fine-grained experts (d_expert=1408) and one always-on
shared expert.
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163840,
    pattern=(("moe", 1),),
    rope=True,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408),
    glu=True, activation="silu",
    adapter=AdapterConfig(bottleneck=64),
    source="hf:moonshotai/Moonlight-16B-A3B",
))
