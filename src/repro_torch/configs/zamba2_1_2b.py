"""zamba2-1.2b — Mamba2 backbone + shared attention blocks.

[hybrid] 38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf].  The Mamba2 mixer uses expand=2 (d_inner 4096),
head_dim 64 (64 SSD heads), 1 B/C group.  One *shared* full-attention block
(weights reused) fires after every 6th mamba layer — 6 applications — per
the Zamba2 shared-block design (simplified: no LoRA adaptation per depth,
noted in DESIGN.md).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    block_pattern="mamba",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    ssm_chunk=256,
    shared_attn_every=6,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="zamba2-reduced", num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=256, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=32, shared_attn_every=2, remat=False)
