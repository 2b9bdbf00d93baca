"""mamba2-130m [ssm]: SSD blocks, attention-free [arXiv:2405.21060]."""
from repro_torch.configs.base import (ArchConfig, LayerSpec, SSMConfig,
                                      register_arch)

CONFIG = register_arch(ArchConfig(
    arch_id="mamba2-130m",
    family="ssm",
    d_model=768,
    n_heads=12,          # unused (attention-free); kept for API uniformity
    n_kv_heads=12,
    d_ff=0,              # no MLP blocks: SSD blocks only
    vocab=50280,
    segments=((24, (LayerSpec(kind="ssm", attn="none"),)),),
    ssm=SSMConfig(state_size=128, head_dim=64, expansion=2, conv_width=4,
                  chunk=128),
    tie_embeddings=True,
    subquadratic=True,
))
