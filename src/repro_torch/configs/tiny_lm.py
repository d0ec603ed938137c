"""tiny-lm — the end-to-end example/HPO target model (~15M params default).

Not an assigned architecture: this is the trainable-on-CPU workload the
examples and the paper-repro NN-HPO benchmarks tune (the LeNet/ResNet32
stand-in, since no image datasets ship offline).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tiny-lm",
    family="dense",
    num_layers=4,
    d_model=256,
    num_heads=8,
    num_kv_heads=4,
    d_ff=1024,
    vocab_size=4096,
    remat=False,
    dtype="float32",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="tiny-lm-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256)
