"""zamba2-7b [hybrid]: a Mamba2 backbone with one SHARED attention + MLP
block applied periodically (one weight set, a KV cache per application)
[arXiv:2411.15242].

81 blocks = 13 x (5 SSD + 1 shared attention) + 3 SSD.
"""
from repro_torch.configs.base import (ArchConfig, LayerSpec, SSMConfig,
                                      register_arch)

CONFIG = register_arch(ArchConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    segments=(
        (13, (LayerSpec(kind="ssm", attn="none"),) * 5
             + (LayerSpec(kind="dense", attn="global", shared=True),)),
        (3, (LayerSpec(kind="ssm", attn="none"),)),
    ),
    ssm=SSMConfig(state_size=64, head_dim=64, expansion=2, conv_width=4,
                  chunk=128),
    subquadratic=True,
))
