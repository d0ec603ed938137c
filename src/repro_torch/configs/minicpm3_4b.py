"""minicpm3-4b — dense model with Multi-head Latent Attention (MLA).

[dense] 62L d_model=2560 40H d_ff=6400 vocab=73448 [hf:openbmb/MiniCPM3-4B].
The assignment's "GQA kv=40" is the degenerate per-head view; MiniCPM3's
actual attention is MLA with a compressed latent KV cache — implemented as
such (q_lora 768, kv_lora 256, nope 64, rope 32, v 64 per the release),
which is what makes its decode shapes interesting.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    head_dim=96,   # nope + rope (query/key working dim)
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="minicpm3-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
        q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8,
        v_head_dim=8, head_dim=16, remat=False)
