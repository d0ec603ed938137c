"""deepseek-coder-33b — dense llama-architecture coder model.

[dense] 62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256
[arXiv:2401.14196; hf].
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-coder-reduced", num_layers=2, d_model=128,
        num_heads=8, num_kv_heads=2, d_ff=256, vocab_size=256, remat=False)
