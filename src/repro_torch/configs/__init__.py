"""Model configurations the port runs (``get_config``)."""
from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.configs.registry import ARCH_IDS, get_config

__all__ = ["ModelConfig", "ServeConfig", "ARCH_IDS", "get_config"]
