"""Architecture registry: one module per assigned architecture (the same
data as `repro/configs/`, config for config).

Usage:
    from repro_torch.configs import get_config, REGISTRY
    cfg = get_config("granite-3-2b")            # full published config
    cfg = get_config("granite-3-2b", reduced=True)   # CPU smoke config

Every module exposes `CONFIG` (the exact published numbers from the
assignment) and `reduced()` (same family, tiny dims, for CPU smoke tests).
"""
from __future__ import annotations

import importlib

_ARCHS = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "minicpm3-4b": "minicpm3_4b",
    "granite-3-2b": "granite_3_2b",
    "gemma3-4b": "gemma3_4b",
    "zamba2-1.2b": "zamba2_1_2b",
    "chameleon-34b": "chameleon_34b",
    "hubert-xlarge": "hubert_xlarge",
    "xlstm-1.3b": "xlstm_1_3b",
    # the paper's own HPO targets (LeNet/ResNet stand-ins, see bench_nn_hpo)
    "tiny-lm": "tiny_lm",
}

ARCH_IDS = [a for a in _ARCHS if a != "tiny-lm"]


def get_module(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")


def get_config(arch: str, reduced: bool = False):
    mod = get_module(arch)
    return mod.reduced() if reduced else mod.CONFIG


REGISTRY = _ARCHS
