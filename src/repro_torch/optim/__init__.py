"""Optimizers, schedules, gradient compression (counterpart of
`repro.optim`)."""
from repro_torch.optim.optimizers import (OptimizerConfig, OptState,
                                          apply_updates, clip_by_global_norm,
                                          ef_compress_grads, global_norm,
                                          init_opt_state, schedule)
__all__ = ["OptimizerConfig", "OptState", "apply_updates",
           "clip_by_global_norm", "ef_compress_grads", "global_norm",
           "init_opt_state", "schedule"]
