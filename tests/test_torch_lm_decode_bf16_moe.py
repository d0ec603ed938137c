"""The port's prefill and decode steps in bfloat16 against the reference
run one primitive at a time (`jax.disable_jit`), for the MoE archs, whose
jitted reference is not the function the port computes: XLA keeps float32
between fused bfloat16 ops, which flips their routing (the jitted
prefill's K cache then differs from the op-by-op one by 0.5 of its
largest entry on granite-moe; `tests/test_torch_lm_model.py` holds their
gradients the same way).  zamba2's case is
`tests/test_torch_lm_decode_bf16_zamba2.py`.  Tolerance as
`tests/test_torch_lm_decode_bf16.py`, 2e-2 (measured: bit for bit)."""
import pytest
from _torch_port import (SERVE_PROMPT, held_serving, lm_pair, serve_port,
                         serve_reference, serve_tokens)

BF16 = 2e-2


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-30b-a3b"])
def test_prefill_and_decode_near_op_by_op_reference_bfloat16(arch):
    jcfg, tcfg, jp, tp = lm_pair(arch, capacity_factor=4.0)
    toks = serve_tokens(jcfg)
    held_serving(serve_port(tcfg, tp, toks, SERVE_PROMPT),
                 serve_reference(jcfg, jp, toks, SERVE_PROMPT,
                                 op_by_op=True), BF16)
