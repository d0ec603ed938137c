"""gemma3-4b — Gemma-3 with 5:1 local:global attention, 128k context.

[dense] 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144
[hf:google/gemma-3-1b-pt; unverified].  Local layers use a 1024-token
sliding window; every 6th layer is global.  head_dim=256 per the Gemma-3
releases (d_model/num_heads would be 320).

long_500k note (DESIGN.md §5): the sliding-window layers are O(window);
the 1-in-6 global layers keep full-cache decode attention, which at 500k is
O(S) per token — still linear, so the cell runs (memory sized by batch=1).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    head_dim=256,
    sliding_window=1024,
    global_every=6,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="gemma3-reduced", num_layers=4, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        sliding_window=8, global_every=2, remat=False)
