"""qwen3-moe-30b-a3b — Qwen3 MoE.

[moe] 48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936, MoE 128 experts
top-8 [hf:Qwen/Qwen3-30B-A3B; hf].
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    num_experts=128,
    top_k=8,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-moe-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=48, vocab_size=256, num_experts=8,
        top_k=2, remat=False)
