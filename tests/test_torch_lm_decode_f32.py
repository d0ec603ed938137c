"""The port's prefill and decode steps against the reference's, float32
activations: the same parameters (the reference's init, converted by tree
path) and tokens through both packages; the prefill's last logits and
every cache leaf, then three decode steps' logits and caches, for every
arch with `supports_decode` and no frontend (MoE dropless, capacity
factor 4.0, as `tests/test_models.py:55-83` runs them), and hubert's
prefill over frames.  Tolerance: the LM tests' F32 for hidden states and
logits, 2e-5 of each tensor's largest entry (measured: at most 9.4e-6,
zamba2's SSD state)."""
import pytest
from _torch_port import (DECODE_ARCHS, SERVE_PROMPT, held_serving, lm_pair,
                         serve_port, serve_reference, serve_tokens)

F32 = 2e-5


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_match_reference_float32(arch):
    jcfg, tcfg, jp, tp = lm_pair(arch, dtype="float32", capacity_factor=4.0)
    toks = serve_tokens(jcfg)
    held_serving(serve_port(tcfg, tp, toks, SERVE_PROMPT),
                 serve_reference(jcfg, jp, toks, SERVE_PROMPT), F32)


def test_hubert_prefill_matches_reference_float32():
    """The encoder has no decode step (`supports_decode` is False); its
    prefill over frames gives the last position's logits and the K/V."""
    jcfg, tcfg, jp, tp = lm_pair("hubert-xlarge", dtype="float32")
    assert not tcfg.supports_decode
    frames = serve_tokens(jcfg)
    worst = held_serving(serve_port(tcfg, tp, frames, frames.shape[1]),
                         serve_reference(jcfg, jp, frames, frames.shape[1]),
                         F32)
    assert sorted(worst) == ["k", "logits", "v"]
