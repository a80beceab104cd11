"""RWKV-6 "Finch" 7B [arXiv:2404.05892] — attention-free RNN with data-dependent decay.

32L d_model=4096 (attention-free) d_ff=14336 vocab=65536; 64 heads of 64,
data-dependent token shift (ddlerp) and decay LoRA. The adapter sits after each
block's channel mix.
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab_size=65536,
    pattern=(("rwkv", 1),),
    rope=False,                # no positional encoding beyond the recurrence
    ssm=SSMConfig(head_dim=64, decay_lora=64),
    glu=False, activation="relu",   # the channel mix squares a ReLU
    adapter=AdapterConfig(bottleneck=64),
    source="arXiv:2404.05892",
))
