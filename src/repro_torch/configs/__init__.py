"""Architecture registry of the port — importing this package registers its configs.

The port registers the architectures whose block kinds it runs: the dense
decoders qwen2.5-3b, stablelm-3b and starcoder2-7b (a plain GELU MLP), the
paper's own mbert-squad (LayerNorm, a span head), the attention-free RWKV-6
rwkv6-7b, the hybrid (attention + Mamba) hymba-1.5b, and the
mixture-of-experts decoders olmoe-1b-7b, moonshot-v1-16b-a3b and
llama4-maverick-400b-a17b (dense and moe layers interleaved).
"""
from repro_torch.configs.base import (AdapterConfig, ModelConfig, MoEConfig, SSMConfig,
                                      TrainConfig, get_config, list_configs, register)

from repro_torch.configs import (hymba_1p5b, llama4_maverick_400b_a17b,  # noqa: F401
                                 mbert_squad, moonshot_v1_16b_a3b, olmoe_1b_7b, qwen2p5_3b,
                                 rwkv6_7b, stablelm_3b, starcoder2_7b)

__all__ = ["AdapterConfig", "ModelConfig", "MoEConfig", "SSMConfig", "TrainConfig",
           "get_config", "list_configs", "register"]
