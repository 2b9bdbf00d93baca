"""gemma2-9b [dense]: local (sliding window 4096) and global layers
alternating 1:1, attention and logit softcaps [arXiv:2408.00118]."""
from repro_torch.configs.base import ArchConfig, LayerSpec, register_arch

CONFIG = register_arch(ArchConfig(
    arch_id="gemma2-9b",
    family="dense",
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    segments=((21, (LayerSpec(kind="dense", attn="local", window=4096),
                    LayerSpec(kind="dense", attn="global"))),),
    logit_softcap=30.0,
    attn_softcap=50.0,
    tie_embeddings=True,
))
