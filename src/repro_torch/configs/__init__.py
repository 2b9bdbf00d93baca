"""Architecture configs of the port (``qwen3-4b``, ``mamba2-130m`` and
``zamba2-7b``).

Use ``repro_torch.configs.get_arch(arch_id)`` / ``list_archs()``.
"""
from . import base, mamba2_130m, qwen3_4b, zamba2_7b
from .base import ArchConfig, LayerSpec, get_arch, list_archs

__all__ = ["ArchConfig", "LayerSpec", "base", "get_arch", "list_archs"]
