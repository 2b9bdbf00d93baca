"""deepseek-v3-671b [moe]: MLA attention, 1 shared and 256 routed experts,
top-8 [arXiv:2412.19437].

The first 3 layers are dense (d_ff 18432), the other 58 MoE with
2048-wide experts.  The multi-token-prediction head is not reproduced.
"""
from repro_torch.configs.base import (ArchConfig, LayerSpec, MLAConfig,
                                      MoEConfig, register_arch)

CONFIG = register_arch(ArchConfig(
    arch_id="deepseek-v3-671b",
    family="moe",
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=2048,            # expert intermediate size
    dense_d_ff=18432,     # the 3 dense layers
    vocab=129280,
    segments=(
        (3, (LayerSpec(kind="dense", attn="mla"),)),
        (58, (LayerSpec(kind="moe", attn="mla"),)),
    ),
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, capacity_factor=1.25),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    rope_theta=10000.0,
    fsdp=True,
    optimizer="adafactor",
    param_dtype="bfloat16",
    grad_accum=8,
))
