"""hubert-xlarge — encoder-only audio transformer (wav2vec2 architecture).

[audio] 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504
[arXiv:2106.07447; unverified].  Encoder-only: bidirectional attention, no
decode path (decode_32k / long_500k cells are skipped per DESIGN.md §5).
The conv feature extractor is a STUB: input_specs() provides precomputed
frame embeddings (batch, frames, d_model); the loss is masked-frame
prediction over the 504-unit codebook.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    is_encoder=True,
    rope=False,
    frontend="frames",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="hubert-reduced", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=32, remat=False)
