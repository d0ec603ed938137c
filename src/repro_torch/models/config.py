"""Unified model configuration covering all assigned architecture families
(counterpart of `repro/models/config.py`, field for field).

One dataclass describes dense GQA, MLA, sliding-window, MoE, Mamba2-hybrid,
mLSTM, encoder-only and early-fusion-VLM stacks; per-arch files in
`repro_torch/configs/` instantiate it with the exact published numbers.
The port builds and trains the dense GQA stacks; a config of another kind
is still data here, and only building its model raises.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

Family = Literal["dense", "moe", "hybrid", "vlm", "audio", "ssm"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads

    # --- attention flavour ---------------------------------------------
    attention: str = "gqa"            # "gqa" | "mla" | "none"
    causal: bool = True               # False -> bidirectional encoder
    is_encoder: bool = False          # encoder-only (no decode path)
    sliding_window: int = 0           # 0 -> full attention
    global_every: int = 0             # >0: every k-th layer is global (gemma3)
    qk_norm: bool = False             # chameleon-style qk RMSNorm
    rope: bool = True
    rope_theta: float = 10_000.0

    # --- MLA (minicpm3 / deepseek-style latent attention) ---------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE -------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_dispatch: str = "sort"        # "sort" (argsort ranks) | "cumsum"
    expert_pad_to: int = 16           # pad expert WEIGHT tables to a multiple
    # (routing stays over num_experts; dummy experts never receive tokens —
    # lets a 40-expert arch use the shard_map EP path on a 16-way axis)

    # --- SSM / recurrent blocks ------------------------------------------
    # block_pattern: per-layer block kind; "attn", "mamba", "mlstm", or a
    # pattern like "mamba*5+shared_attn" handled by the per-arch stacks.
    block_pattern: str = "attn"
    ssm_state: int = 0                # Mamba2 N
    ssm_heads: int = 0                # Mamba2 H (0 -> d_model*expand/headdim)
    ssm_head_dim: int = 64            # Mamba2 P
    ssm_expand: int = 2
    ssm_groups: int = 1               # B/C groups (G)
    ssm_chunk: int = 128              # SSD chunk length
    shared_attn_every: int = 0        # zamba2: shared attn block period
    mlstm_heads: int = 0              # xLSTM heads (conv/backbone width)
    mlstm_pf: float = 2.0             # mLSTM up-projection factor

    # --- stub frontends ----------------------------------------------------
    # "none": token ids.  "frames": precomputed frame embeddings (audio).
    # VLM early fusion shares the token vocabulary ("none").
    frontend: str = "none"

    # --- numerics ----------------------------------------------------------
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"           # activation dtype
    param_dtype: str = "float32"      # master parameter dtype
    tie_embeddings: bool = False
    remat: bool = True                # activation checkpoint each block
    remat_policy: str = "nothing"     # "nothing" | "dots" (save matmul outs)
    unroll_layers: bool = False       # python-loop the stack instead of scan
    # (scan = O(1) compile time, the production default; unroll = exact
    # per-layer HLO cost_analysis, used by the dry-run since XLA's
    # HloCostAnalysis does not multiply while-loop bodies by trip count)
    vocab_round: int = 256            # pad vocab to a multiple (TP-friendly)

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding/LM-head table rows: vocab rounded up so the vocab dim
        TP-shards evenly (padded logits are masked out of the loss)."""
        r = self.vocab_round
        return ((self.vocab_size + r - 1) // r) * r

    @property
    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def parameter_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def num_experts_padded(self) -> int:
        r = max(self.expert_pad_to, 1)
        return ((self.num_experts + r - 1) // r) * r

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder

    @property
    def supports_long_context(self) -> bool:
        """True if the arch has a sub-quadratic serving path (assignment:
        long_500k only runs for SSM / hybrid / windowed-attention archs)."""
        if self.block_pattern in ("mamba", "mlstm"):
            return True
        if self.shared_attn_every > 0:     # hybrid: SSM backbone
            return True
        return self.sliding_window > 0      # windowed attention

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, h = self.d_model, self.head_dim_
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.block_pattern in ("attn",):
            if self.attention == "mla":
                qdim = self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                per_layer += d * self.q_lora_rank + self.q_lora_rank * qdim
                per_layer += d * (self.kv_lora_rank + self.qk_rope_dim)
                per_layer += self.kv_lora_rank * self.num_heads * (
                    self.qk_nope_dim + self.v_head_dim)
                per_layer += self.num_heads * self.v_head_dim * d
            else:
                per_layer += d * self.num_heads * h
                per_layer += 2 * d * self.num_kv_heads * h
                per_layer += self.num_heads * h * d
            if self.is_moe:
                per_layer += d * self.num_experts  # router
                per_layer += self.num_experts * 3 * d * self.d_ff
            else:
                per_layer += 3 * d * self.d_ff
        elif self.block_pattern == "mamba":
            din = self.ssm_expand * d
            nheads = self.ssm_heads or din // self.ssm_head_dim
            conv_dim = din + 2 * self.ssm_groups * self.ssm_state
            per_layer += d * (2 * din + 2 * self.ssm_groups * self.ssm_state
                              + nheads)
            per_layer += 4 * conv_dim
            per_layer += din * d
        elif self.block_pattern == "mlstm":
            dv = int(self.mlstm_pf * d)
            per_layer += d * 2 * dv          # up projections
            per_layer += dv * (2 * dv // 2)  # q,k (half width) ~
            per_layer += dv * dv             # v
            per_layer += 3 * dv              # gates (approx)
            per_layer += dv * d              # down
        total = emb + self.num_layers * per_layer
        if self.shared_attn_every > 0:
            # one shared attention block (+ its mlp) reused across the stack
            total += (d * self.num_heads * h * 2
                      + 2 * d * self.num_kv_heads * h + 3 * d * self.d_ff)
        return int(total)

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        dense_expert = 3 * d * self.d_ff
        inactive = (self.num_experts - self.top_k) * dense_expert
        return int(self.n_params() - self.num_layers * inactive)
