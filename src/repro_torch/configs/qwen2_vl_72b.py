"""qwen2-vl-72b [vlm]: M-RoPE, dynamic resolution; the vision tower is a
stub (the model takes precomputed patch embeddings, ``embeds``, and their
3-D positions) [arXiv:2409.12191]."""
from repro_torch.configs.base import ArchConfig, LayerSpec, register_arch

CONFIG = register_arch(ArchConfig(
    arch_id="qwen2-vl-72b",
    family="vlm",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    segments=((80, (LayerSpec(kind="dense", attn="global"),)),),
    mrope_sections=(16, 24, 24),   # (t, h, w) frequency bands of half=64
    rope_theta=1000000.0,
    frontend="vision_stub",
    fsdp=True,
    optimizer="adafactor",
    param_dtype="bfloat16",
    grad_accum=4,
))
