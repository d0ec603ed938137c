"""Model zoo, every config's train and serving paths (counterpart of
`repro.models`)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (decode_step, forward, init_cache,
                                      init_params, lm_loss,
                                      logits_from_hidden, prefill)

__all__ = ["ModelConfig", "decode_step", "forward", "init_cache",
           "init_params", "lm_loss", "logits_from_hidden", "prefill"]
