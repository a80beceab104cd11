"""StableLM-3B [hf:stabilityai/stablelm-2-1_6b family] — dense MHA decoder.

32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304; head_dim 80. The
main path's arch: it trains at full width on the card (the attention kernels
take head_dim 80), its reduced form has head_dim 64.
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab_size=50304,
    pattern=(("dense", 1),),
    rope=True,
    glu=True, activation="silu",
    adapter=AdapterConfig(bottleneck=64),
    source="hf:stabilityai/stablelm-2-1_6b",
))
