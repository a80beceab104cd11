"""Architecture registry of the port — importing this package registers its configs.

The port registers the architectures whose block kinds it runs: so far the dense
decoder qwen2.5-3b.
"""
from repro_torch.configs.base import (AdapterConfig, ModelConfig, get_config,
                                      list_configs, register)

from repro_torch.configs import qwen2p5_3b  # noqa: F401  (registration)

__all__ = ["AdapterConfig", "ModelConfig", "get_config", "list_configs", "register"]
