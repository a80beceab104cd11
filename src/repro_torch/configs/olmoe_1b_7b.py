"""OLMoE-1B-7B [arXiv:2409.02060] — MoE decoder, 64 experts top-8.

16L d_model=2048 16H (MHA) d_ff=1024 vocab=50304, fine-grained experts
(d_expert=1024). Every moe block also carries the reference's shared expert
(``models/params.moe_defs``), which OLMoE itself does not have.
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    pattern=(("moe", 1),),
    rope=True,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024),
    glu=True, activation="silu",
    adapter=AdapterConfig(bottleneck=64),
    source="arXiv:2409.02060",
))
