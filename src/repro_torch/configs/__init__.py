"""Architecture configs of the port: the dense decoders ``qwen3-4b``,
``gemma2-9b`` (sliding window, softcaps), ``gemma3-12b`` (sliding window)
and ``minitron-8b``, the encoder-decoder ``whisper-tiny``, the SSM
``mamba2-130m`` and the hybrid ``zamba2-7b``.

Use ``repro_torch.configs.get_arch(arch_id)`` / ``list_archs()``.
"""
from . import (base, gemma2_9b, gemma3_12b, mamba2_130m, minitron_8b,
               qwen3_4b, whisper_tiny, zamba2_7b)
from .base import ArchConfig, LayerSpec, get_arch, list_archs

__all__ = ["ArchConfig", "LayerSpec", "base", "get_arch", "list_archs"]
