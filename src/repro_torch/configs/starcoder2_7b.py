"""StarCoder2-7B [arXiv:2402.19173] — dense GQA decoder with RoPE.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152, head_dim 128. The
real model's sliding window (4096) is kept, and its plain (non-gated) GELU
MLP: the port's ``blocks.ffn`` runs it with ``glu=False``.
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab_size=49152,
    pattern=(("dense", 1),),
    rope=True, rope_theta=1e5,
    sliding_window=4096,
    glu=False, activation="gelu",
    adapter=AdapterConfig(bottleneck=64),
    source="arXiv:2402.19173",
))
