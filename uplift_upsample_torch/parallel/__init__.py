"""The training and validation steps, on one device or data-parallel over
torch.distributed ranks (`mesh.py`)."""

from .mesh import (DataParallel, all_reduce_sum_, broadcast_params_,  # noqa: F401
                   init_data_parallel)
from .train_step import (KerasAdam, TrainState, make_loss_fn, make_optimizer,  # noqa: F401
                         make_train_step, make_val_step)
