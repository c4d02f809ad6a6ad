"""Training: the language-model loss and the one-device train step."""
from repro_torch.train.loss import IGNORE, cross_entropy, lm_loss, make_labels
from repro_torch.train.step import (TrainConfig, TrainState,
                                    clip_by_global_norm, init_train_state,
                                    make_loss_fn, make_train_step, trainable)

__all__ = ["IGNORE", "cross_entropy", "lm_loss", "make_labels", "TrainConfig",
           "TrainState", "clip_by_global_norm", "init_train_state",
           "make_loss_fn", "make_train_step", "trainable"]
