"""qwen3-4b [dense]: GQA with qk-norm [hf:Qwen/Qwen3 family]."""
from repro_torch.configs.base import ArchConfig, LayerSpec, register_arch

CONFIG = register_arch(ArchConfig(
    arch_id="qwen3-4b",
    family="dense",
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    segments=((36, (LayerSpec(kind="dense", attn="global"),)),),
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
))
