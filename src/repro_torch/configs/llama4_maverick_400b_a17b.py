"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family] — MoE.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, 128 experts top-1.
MoE layers alternate with dense layers (pattern [dense, moe] x 24), and each
MoE layer carries a shared expert beside the routed ones. Chunked attention
is the sliding window 8192. Its two block kinds leave it without a ring: the
ring applies one kind to every layer (``core/pipeline._check_ring``).
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    pattern=(("dense", 1), ("moe", 1)), repeats=24,
    rope=True, rope_theta=5e5,
    sliding_window=8192,
    moe=MoEConfig(n_experts=128, top_k=1, d_expert=8192, capacity_factor=1.25),
    glu=True, activation="silu",
    adapter=AdapterConfig(bottleneck=64),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
