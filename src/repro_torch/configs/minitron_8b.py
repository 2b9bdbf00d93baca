"""minitron-8b [dense]: a width- and depth-pruned nemotron, 32 global GQA
layers, untied head [arXiv:2407.14679]."""
from repro_torch.configs.base import ArchConfig, LayerSpec, register_arch

CONFIG = register_arch(ArchConfig(
    arch_id="minitron-8b",
    family="dense",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=256000,
    segments=((32, (LayerSpec(kind="dense", attn="global"),)),),
))
