"""The port's model configs against the reference's: every config and its
`reduced()`, field by field, with every derived property and the
parameter counts; and which kinds the port builds."""
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
# The dense GQA configs the port builds and trains; the rest wait
# (ROADMAP.md queue 1, item 2).
DENSE = ("tiny-lm", "granite-3-2b", "deepseek-coder-33b", "gemma3-4b",
         "chameleon-34b")
WAITING = {"granite-moe-3b-a800m": "MoE", "qwen3-moe-30b-a3b": "MoE",
           "minicpm3-4b": "MLA", "hubert-xlarge": "frames/encoder",
           "zamba2-1.2b": "mamba and shared attention",
           "xlstm-1.3b": "mLSTM"}


def test_registry_matches():
    assert configs.REGISTRY == jconfigs.REGISTRY
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert set(DENSE) | set(WAITING) == set(ARCHS)
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


@pytest.mark.parametrize("arch", sorted(WAITING))
def test_waiting_kinds_raise_on_build(arch):
    """A config beyond the dense GQA path is data: building its model raises
    NotImplementedError naming its ROADMAP.md entry."""
    cfg = configs.get_config(arch, reduced=True)
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP.md queue 1, item 2 .*{WAITING[arch]}"):
        init_params(cfg, 0, device="cpu")


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
