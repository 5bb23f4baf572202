"""Architecture configs of the PyTorch port: the ten assigned architectures.

``get(name)`` accepts both canonical ids (qwen2p5_3b) and the brief's ids
(qwen2.5-3b).  Each module exposes CONFIG (exact published shape) and
smoke() (reduced same-family config for CPU tests).  An unknown id raises
``ValueError``.  ``SHAPES`` is the input-shape grid (``InputShape``);
``get_shape`` raises ``KeyError`` on an unknown name.
"""
from repro_torch.configs.base import (ALIASES, ARCH_IDS, SHAPES,
                                      ArchConfig, InputShape, all_configs,
                                      canonical, get, get_shape, get_smoke)

__all__ = ["ALIASES", "ARCH_IDS", "SHAPES", "ArchConfig", "InputShape",
           "all_configs", "canonical", "get", "get_shape", "get_smoke"]
