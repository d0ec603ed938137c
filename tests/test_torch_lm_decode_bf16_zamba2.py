"""zamba2's prefill and decode steps (the Mamba-2 stack with its shared
attention block and that block's K/V slots) in bfloat16 against the
reference run one primitive at a time (`jax.disable_jit`): jitted, XLA
keeps float32 between fused bfloat16 ops, which moves the reference's SSD
state by 3e-2 of its largest entry from its own op-by-op run
(`tests/test_torch_lm_model.py` holds zamba2's gradients the same way).
Tolerance as `tests/test_torch_lm_decode_bf16.py`, 2e-2 (measured
1.4e-2)."""
from _torch_port import (SERVE_PROMPT, held_serving, lm_pair, serve_port,
                         serve_reference, serve_tokens)

BF16 = 2e-2


def test_prefill_and_decode_near_op_by_op_reference_bfloat16():
    jcfg, tcfg, jp, tp = lm_pair("zamba2-1.2b")
    toks = serve_tokens(jcfg)
    worst = held_serving(serve_port(tcfg, tp, toks, SERVE_PROMPT),
                         serve_reference(jcfg, jp, toks, SERVE_PROMPT,
                                         op_by_op=True), BF16)
    assert {"shared_k", "shared_v", "mamba/conv", "mamba/ssm"} <= set(worst)
