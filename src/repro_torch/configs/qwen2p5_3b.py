"""Qwen2.5-3B [hf:Qwen/Qwen2.5-0.5B family] — dense GQA decoder with QKV bias.

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936, with the 32k sliding
window the reference enables so ``long_500k`` runs with an O(window) cache.
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab_size=151936,
    pattern=(("dense", 1),),
    rope=True, rope_theta=1e6,
    qkv_bias=True,
    sliding_window=32768,
    glu=True, activation="silu",
    adapter=AdapterConfig(bottleneck=64),
    source="hf:Qwen/Qwen2.5-0.5B",
))
