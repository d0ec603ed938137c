"""Deterministic synthetic token pipeline (counterpart of
`repro/data/pipeline.py`).

No datasets ship offline, so the pipeline synthesizes structured token
streams: Zipfian unigrams, and at a fraction `pattern_frac` of positions a
next token that is a fixed affine function of the current one,
(t * 31 + 7) mod V, so that a small LM's loss falls.  Every batch is a pure
function of (seed, step): it is drawn from a CPU `torch.Generator` seeded
from the pair and then moved to the device, so a restart resumes with the
same stream on any device, and each data-parallel host can make its own
shard (`host_local_batch`).  JAX's threefry bits cannot be reproduced, so
the stream is the reference's law, not its values.  Token ids are int64,
the port's index type.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.gp import resolve_device

Tensor = torch.Tensor

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1
    pattern_frac: float = 0.5   # fraction of positions forced to n-gram rule
    frontend: str = "none"      # "frames" -> synthetic frame embeddings
    d_model: int = 0


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of batch `step` under `seed` (the reference's
    `fold_in(PRNGKey(seed), step)`)."""
    gen = torch.Generator()
    gen.manual_seed(_splitmix64(_splitmix64(seed & _MASK64) ^ (step & _MASK64)))
    return gen


def _zipf_probs(vocab: int, alpha: float) -> Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32)
    return torch.softmax(-alpha * torch.log(ranks), dim=0)


def synth_tokens(cfg: DataConfig, step: int, batch: int | None = None, *,
                 device: str | torch.device = "cuda") -> dict[str, Tensor]:
    """Batch at `step`: dict(inputs, targets, mask), deterministic."""
    dev = resolve_device(device)
    batch = batch or cfg.global_batch
    gen = _step_generator(cfg.seed, int(step))
    if cfg.frontend == "frames":
        frames = torch.randn((batch, cfg.seq_len, cfg.d_model), generator=gen)
        # frame labels follow a projection rule of the frame content
        lab = torch.argmax(frames[..., : min(cfg.d_model, 32)], -1) \
            % cfg.vocab_size
        out = {"inputs": frames, "targets": lab}
    else:
        toks = torch.multinomial(
            _zipf_probs(cfg.vocab_size, cfg.zipf_alpha),
            batch * (cfg.seq_len + 1), replacement=True,
            generator=gen).reshape(batch, cfg.seq_len + 1)
        # Learnable structure: with prob pattern_frac, token t+1 is a fixed
        # affine function of token t (so next-token prediction has signal).
        nxt = (toks[:, :-1] * 31 + 7) % cfg.vocab_size
        use_pat = torch.rand((batch, cfg.seq_len), generator=gen) \
            < cfg.pattern_frac
        out = {"inputs": toks[:, :-1],
               "targets": torch.where(use_pat, nxt, toks[:, 1:])}
    out["mask"] = torch.ones((batch, cfg.seq_len), dtype=torch.float32)
    return {k: v.to(dev) for k, v in out.items()}


def host_local_batch(cfg: DataConfig, step: int, host_id: int,
                     num_hosts: int, *, device: str | torch.device = "cuda"
                     ) -> dict[str, Tensor]:
    """The shard of the global batch owned by `host_id` (a stream of its own
    per host; the hosts' shards together make a global batch)."""
    if cfg.global_batch % num_hosts:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"over {num_hosts} hosts")
    local = cfg.global_batch // num_hosts
    sub = dataclasses.replace(cfg, seed=cfg.seed * 1_000_003 + host_id)
    return synth_tokens(sub, step, batch=local, device=device)


class DataIterator:
    """Stateful wrapper whose entire state is the step counter."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, *,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.step = start_step
        self.device = resolve_device(device)

    def __next__(self):
        batch = synth_tokens(self.cfg, self.step, device=self.device)
        self.step += 1
        return batch

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
