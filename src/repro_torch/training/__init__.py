"""Train / eval / serving step builders (counterpart of `repro.training`)."""
from repro_torch.training.steps import (TrainConfig, init_train_state,
                                        make_decode_step, make_eval_step,
                                        make_loss_fn, make_prefill_step,
                                        make_train_step, value_and_grad)
__all__ = ["TrainConfig", "init_train_state", "make_decode_step",
           "make_eval_step", "make_loss_fn", "make_prefill_step",
           "make_train_step", "value_and_grad"]
