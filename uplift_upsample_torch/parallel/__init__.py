"""The training and validation steps, on one device, data-parallel over
torch.distributed ranks (`mesh.py`) or also tensor-parallel over a dp × mp
layout (`mesh.init_mesh`, `sharding.py`).

`train_step` imports the models, whose modules import `sharding`; its names
are loaded on first use so that importing the models does not cycle back."""

from .mesh import (DataParallel, Mesh, all_reduce_sum_, broadcast_params_,  # noqa: F401
                   init_data_parallel, init_mesh)
from .sharding import (TensorParallel, gather_params_tp, param_spec,  # noqa: F401
                       shard_params_tp)

_TRAIN_STEP = ("KerasAdam", "TrainState", "make_loss_fn", "make_optimizer",
               "make_train_step", "make_val_step")


def __getattr__(name):
    if name in _TRAIN_STEP:
        from . import train_step
        return getattr(train_step, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
