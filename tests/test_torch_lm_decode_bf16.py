"""The port's prefill and decode steps against the jitted reference's in
the configs' own activation dtype (bfloat16, but tiny-lm's float32), as
`tests/test_torch_lm_decode_f32.py` holds them in float32, for the dense
archs, MLA (minicpm3) and the mLSTM stack (xlstm), and hubert's prefill.
The MoE archs and zamba2 are held to the reference run one primitive at a
time (`tests/test_torch_lm_decode_bf16_ops.py`).

Tolerance 2e-2 of each tensor's largest entry: bfloat16 keeps 8 bits (an
ulp is 2^-8 of a value), and the two packages' bfloat16 products round
their float32 sums at other points; it is the block tests' bfloat16
output tolerance (`tests/test_torch_lm_ssm.py`).  Measured: at most
1.67e-2 (gemma3's logits)."""
import pytest
from _torch_port import (DECODE_ARCHS, SERVE_PROMPT, held_serving, lm_pair,
                         serve_port, serve_reference, serve_tokens)

BF16 = 2e-2
OP_BY_OP = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b", "zamba2-1.2b")


@pytest.mark.parametrize("arch", [a for a in DECODE_ARCHS
                                  if a not in OP_BY_OP])
def test_prefill_and_decode_near_reference_bfloat16(arch):
    jcfg, tcfg, jp, tp = lm_pair(arch, capacity_factor=4.0)
    toks = serve_tokens(jcfg)
    held_serving(serve_port(tcfg, tp, toks, SERVE_PROMPT),
                 serve_reference(jcfg, jp, toks, SERVE_PROMPT), BF16)


def test_hubert_prefill_near_reference_bfloat16():
    jcfg, tcfg, jp, tp = lm_pair("hubert-xlarge")
    frames = serve_tokens(jcfg)
    held_serving(serve_port(tcfg, tp, frames, frames.shape[1]),
                 serve_reference(jcfg, jp, frames, frames.shape[1]), BF16)
