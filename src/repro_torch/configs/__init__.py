"""Architecture configs of the port, all ten of the JAX package's: the
dense decoders ``qwen3-4b``, ``gemma2-9b`` (sliding window, softcaps),
``gemma3-12b`` (sliding window) and ``minitron-8b``, the encoder-decoder
``whisper-tiny``, the SSM ``mamba2-130m``, the hybrid ``zamba2-7b``, the
M-RoPE ``qwen2-vl-72b`` and the MoE models ``llama4-maverick-400b-a17b``
and ``deepseek-v3-671b`` (MLA attention).

Use ``repro_torch.configs.get_arch(arch_id)`` / ``list_archs()``.
"""
from . import (base, deepseek_v3_671b, gemma2_9b, gemma3_12b,
               llama4_maverick_400b_a17b, mamba2_130m, minitron_8b,
               qwen2_vl_72b, qwen3_4b, whisper_tiny, zamba2_7b)
from .base import ArchConfig, LayerSpec, get_arch, list_archs

__all__ = ["ArchConfig", "LayerSpec", "base", "get_arch", "list_archs"]
