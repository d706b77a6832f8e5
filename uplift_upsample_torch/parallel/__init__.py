"""The training and validation steps (single device; multi-GPU comes with a later slice)."""

from .train_step import (KerasAdam, TrainState, make_loss_fn, make_optimizer,  # noqa: F401
                         make_train_step, make_val_step)
