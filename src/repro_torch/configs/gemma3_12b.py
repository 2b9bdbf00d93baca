"""gemma3-12b [dense]: 5 local (sliding window 1024) to 1 global layer,
qk-norm [hf:google/gemma-3 family]."""
from repro_torch.configs.base import ArchConfig, LayerSpec, register_arch

CONFIG = register_arch(ArchConfig(
    arch_id="gemma3-12b",
    family="dense",
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    segments=((8, (LayerSpec(kind="dense", attn="local", window=1024),) * 5
                  + (LayerSpec(kind="dense", attn="global"),)),),
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
))
