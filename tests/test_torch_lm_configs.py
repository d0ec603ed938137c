"""The port's model configs against the reference's: every config and its
`reduced()`, field by field, with every derived property and the
parameter counts; and the trees the port builds for every kind."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.models import init_params
from repro_torch.models.common import count_params
from repro_torch.models.config import ModelConfig

ARCHS = sorted(jconfigs.REGISTRY)
PROPERTIES = ("head_dim_", "vocab_padded", "is_moe", "num_experts_padded",
              "supports_decode", "supports_long_context")
# The port builds and trains every config: dense GQA, MoE, MLA, the frames
# encoder, the mamba stack with shared attention and the mLSTM stack.
DENSE = ("tiny-lm", "granite-3-2b", "deepseek-coder-33b", "gemma3-4b",
         "chameleon-34b")
MOE_MLA = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b", "minicpm3-4b")
RECURRENT_FRAMES = ("hubert-xlarge", "zamba2-1.2b", "xlstm-1.3b")


def test_registry_matches():
    assert configs.REGISTRY == jconfigs.REGISTRY
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert set(DENSE) | set(MOE_MLA) | set(RECURRENT_FRAMES) == set(ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_field_by_field(arch, reduced):
    ref = jconfigs.get_config(arch, reduced=reduced)
    got = configs.get_config(arch, reduced=reduced)
    assert isinstance(got, ModelConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for name in PROPERTIES:
        assert getattr(got, name) == getattr(ref, name), name
    assert got.n_params() == ref.n_params()
    assert got.n_active_params() == ref.n_active_params()
    # the dtypes are torch's of the same name
    for ours, theirs in ((got.activation_dtype, ref.activation_dtype),
                         (got.parameter_dtype, ref.parameter_dtype)):
        assert isinstance(ours, torch.dtype)
        assert str(ours) == f"torch.{jnp.dtype(theirs).name}"


@pytest.mark.parametrize("arch", DENSE)
def test_dense_built_tree_counts(arch):
    """The built tree at reduced size holds exactly blocks + embedding +
    final norm + head, the vocabulary padded."""
    cfg = configs.get_config(arch, reduced=True)
    params, specs = init_params(cfg, 0, device="cpu")
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.head_dim_
    per_layer = (d * cfg.num_heads * dh * 2 + 2 * d * cfg.num_kv_heads * dh
                 + 3 * d * f + 2 * d
                 + (2 * dh if cfg.qk_norm else 0))
    want = (cfg.num_layers * per_layer + cfg.vocab_padded * d
            * (1 if cfg.tie_embeddings else 2) + d)
    assert count_params(params) == want
    assert set(specs) == set(params)


@pytest.mark.parametrize("arch", MOE_MLA)
def test_moe_and_mla_built_tree_counts(arch):
    """The built tree at reduced size: MLA's eight attention leaves, or the
    MoE router over the experts beside tables padded to
    `num_experts_padded`; with the config's own count (which counts the
    unpadded experts) the difference is exactly the padding."""
    cfg = configs.get_config(arch, reduced=True)
    params, specs = init_params(cfg, 0, device="cpu")
    d, f, h = cfg.d_model, cfg.d_ff, cfg.num_heads
    if cfg.attention == "mla":
        nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        attn = (d * qr + qr + qr * h * (nope + rdim) + d * (kvr + rdim)
                + kvr + kvr * h * nope + kvr * h * vdim + h * vdim * d)
        assert sorted(params["blocks"]["attn"]) == sorted(
            ["wdq", "q_norm", "wuq", "wdkv", "kv_norm", "wuk", "wuv", "wo"])
    else:
        dh = cfg.head_dim_
        attn = d * h * dh * 2 + 2 * d * cfg.num_kv_heads * dh
    if cfg.is_moe:
        ffn = d * cfg.num_experts + cfg.num_experts_padded * 3 * d * f
        assert params["blocks"]["moe"]["wi"].shape == (
            cfg.num_layers, cfg.num_experts_padded, d, f)
        assert specs["blocks"]["moe"]["router"] == ("layers", "embed",
                                                    "expert")
    else:
        ffn = 3 * d * f
    per_layer = attn + ffn + 2 * d
    want = (cfg.num_layers * per_layer + cfg.vocab_padded * d
            * (1 if cfg.tie_embeddings else 2) + d)
    assert count_params(params) == want
    assert set(specs) == set(params)
    pad = (cfg.num_experts_padded - cfg.num_experts) * 3 * d * f
    norms = (2 * d + (qr + kvr if cfg.attention == "mla" else 0))
    assert count_params(params) - cfg.n_params() == \
        cfg.num_layers * (pad + norms) + (cfg.vocab_padded - cfg.vocab_size) \
        * d * (1 if cfg.tie_embeddings else 2) + d


def _mixer_count(cfg) -> int:
    """One layer's mixer leaves, as `init_mamba_params` /
    `init_mlstm_params` draw them."""
    d = cfg.d_model
    if cfg.block_pattern == "mamba":
        din = cfg.ssm_expand * d
        heads = din // cfg.ssm_head_dim
        gn = cfg.ssm_groups * cfg.ssm_state
        conv = din + 2 * gn
        return (d * (2 * din + 2 * gn + heads) + 4 * conv + conv
                + 3 * heads + din + din * d)
    heads = cfg.mlstm_heads or cfg.num_heads
    dv = int(cfg.mlstm_pf * d)
    return (2 * d * dv + 4 * dv + dv + 3 * dv * dv + 2 * dv * heads
            + 2 * heads + dv + dv * d)


@pytest.mark.parametrize("arch", RECURRENT_FRAMES)
def test_recurrent_and_frames_built_tree_counts(arch):
    """The built tree at reduced size: hubert's `frame_proj` in place of the
    embedding; a mixer and a norm a layer for mamba and mLSTM; zamba2's one
    `shared_attn` block (attention and a dense MLP) beside its layers; the
    vocabulary padded.  The config's own count leaves out the norms and the
    padding, and counts the shared block once."""
    cfg = configs.get_config(arch, reduced=True)
    params, specs = init_params(cfg, 0, device="cpu")
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.head_dim_
    attn = d * cfg.num_heads * dh * 2 + 2 * d * cfg.num_kv_heads * dh
    if cfg.block_pattern == "attn":
        per_layer = attn + 3 * d * f + 2 * d
    else:
        per_layer = _mixer_count(cfg) + d
    front = d * d if cfg.frontend == "frames" else cfg.vocab_padded * d
    shared = attn + 3 * d * f + 2 * d if cfg.shared_attn_every else 0
    want = (cfg.num_layers * per_layer + front + d
            + (0 if cfg.tie_embeddings else d * cfg.vocab_padded) + shared)
    assert count_params(params) == want
    assert set(specs) == set(params)
    assert ("frame_proj" in params) == (cfg.frontend == "frames") \
        == ("embed" not in params)
    assert ("shared_attn" in params) == (cfg.shared_attn_every > 0)
    assert specs["blocks"].get("ln", ("layers", "norm")) == ("layers", "norm")
