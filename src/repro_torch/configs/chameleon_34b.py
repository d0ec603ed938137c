"""chameleon-34b — early-fusion vision-language model.

[vlm] 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536
[arXiv:2405.09818; unverified].  Early fusion: VQ image tokens share the
65536-entry vocabulary, so the backbone is a standard decoder with
Chameleon's qk-norm for stability.  The VQ-VAE image tokenizer is a STUB per
the assignment: input_specs() provides token ids (text + image tokens).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="chameleon-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, remat=False)
