"""Architecture configs: one module per assigned architecture.

A copy of the JAX package's configs (data only), so that the port lists
the same names without importing it. Use `get_config(name)` /
`list_configs()`; every config cites its source in `source`.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, list_configs, INPUT_SHAPES, InputShape

__all__ = ["ModelConfig", "get_config", "list_configs", "INPUT_SHAPES",
           "InputShape"]
