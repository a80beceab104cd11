"""Architecture registry of the port — importing this package registers its configs.

The port registers the architectures whose block kinds it runs: the dense
decoders qwen2.5-3b and stablelm-3b, the paper's own mbert-squad (LayerNorm,
a span head), the attention-free RWKV-6 rwkv6-7b and the hybrid (attention +
Mamba) hymba-1.5b.
"""
from repro_torch.configs.base import (AdapterConfig, ModelConfig, SSMConfig, TrainConfig,
                                      get_config, list_configs, register)

from repro_torch.configs import (hymba_1p5b, mbert_squad,  # noqa: F401  (registration)
                                 qwen2p5_3b, rwkv6_7b, stablelm_3b)

__all__ = ["AdapterConfig", "ModelConfig", "SSMConfig", "TrainConfig", "get_config",
           "list_configs", "register"]
