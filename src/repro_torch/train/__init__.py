"""Training: the language-model loss and the one-device train step."""
from repro_torch.train.loss import IGNORE, cross_entropy, lm_loss, make_labels
from repro_torch.train.step import (TrainConfig, TrainState,
                                    accumulate_grads, clip_by_global_norm,
                                    init_train_state, make_loss_fn,
                                    make_train_step, start_state,
                                    trainable)

__all__ = ["IGNORE", "cross_entropy", "lm_loss", "make_labels", "TrainConfig",
           "TrainState", "accumulate_grads", "clip_by_global_norm",
           "init_train_state", "make_loss_fn", "make_train_step", "start_state",
           "trainable"]
