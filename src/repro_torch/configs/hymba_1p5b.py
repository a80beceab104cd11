"""Hymba-1.5B [arXiv:2411.13676] — hybrid: parallel attention + Mamba heads.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16. Hymba
fuses attention and SSM head outputs (per-branch RMSNorm, averaged) in every
block, uses 128 learned meta tokens (attention sinks) and sliding-window
attention, so a long context runs with O(sink+window) KV plus O(1) SSM state.
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    pattern=(("hymba", 1),),
    rope=True,
    sliding_window=1024,                      # Hymba's SWA layers
    ssm=SSMConfig(state_size=16, conv_width=4, dt_rank=48),
    glu=True, activation="silu",
    adapter=AdapterConfig(bottleneck=64),
    source="arXiv:2411.13676",
))
