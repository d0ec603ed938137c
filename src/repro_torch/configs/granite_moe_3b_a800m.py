"""granite-moe-3b-a800m — IBM Granite-3.0 MoE family.

[moe] 32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40 experts
top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].  The structured spec
line says 40 experts (the bracketed HF note says 32); we follow the
structured spec — `num_experts` is a single config field either way.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    top_k=8,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="granite-moe-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=32, vocab_size=256, num_experts=4,
        top_k=2, remat=False)
