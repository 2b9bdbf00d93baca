"""llama4-maverick-400b-a17b [moe]: 128 experts, top-1 plus one shared
expert, MoE every second layer [hf:meta-llama/Llama-4 family].

48 layers = 24 x (moe, dense): 400 B parameters in all, 17 B active.
"""
from repro_torch.configs.base import (ArchConfig, LayerSpec, MoEConfig,
                                      register_arch)

CONFIG = register_arch(ArchConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    dense_d_ff=16384,     # the interleaved dense layers
    vocab=202048,
    segments=((24, (LayerSpec(kind="moe", attn="global"),
                    LayerSpec(kind="dense", attn="global"))),),
    moe=MoEConfig(n_experts=128, top_k=1, n_shared=1, capacity_factor=1.25),
    rope_theta=500000.0,
    fsdp=True,
    optimizer="adafactor",
    param_dtype="bfloat16",
    grad_accum=8,
))
