"""whisper-tiny [audio]: an encoder-decoder transformer backbone; the conv
and mel frontend is a stub (the encoder takes precomputed frame embeddings,
``enc_embeds``) [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig, LayerSpec, register_arch

CONFIG = register_arch(ArchConfig(
    arch_id="whisper-tiny",
    family="audio",
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
    segments=((4, (LayerSpec(kind="dense", attn="global"),)),),  # decoder
    encoder_layers=4,
    decoder_len=256,
    frontend="audio_stub",
    seq_shard_activations=False,
))
