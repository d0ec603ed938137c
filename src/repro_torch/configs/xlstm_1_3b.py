"""xlstm-1.3b — xLSTM with mLSTM blocks.

[ssm] 48L d_model=2048 4H d_ff=0 vocab=50304 [arXiv:2405.04517; unverified].
d_ff=0 per the spec: mLSTM blocks carry an internal projection pair instead
of a separate FFN, matching the xLSTM paper's mLSTM block (the 1.3B-scale
xLSTM[7:1] is approximated as an all-mLSTM stack; sLSTM omission noted in
DESIGN.md).  The projection factor is 1.0 here so the total lands at the
published ~1.3-1.4B for 48L x 2048d (pf=2 with full-width qkv would be ~3B).
Recurrent state -> no KV cache; long_500k runs.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern="mlstm",
    mlstm_heads=4,
    mlstm_pf=1.0,
    ssm_chunk=256,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="xlstm-reduced", num_layers=2, d_model=64, num_heads=2,
        num_kv_heads=2, vocab_size=256, mlstm_heads=2, ssm_chunk=32,
        remat=False)
