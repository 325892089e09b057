from cnn_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from cnn_tpu_torch.parallel.train_step import (  # noqa: F401
    TrainState,
    create_train_state,
    make_ensemble_eval_step,
    make_eval_step,
    make_forward,
    make_train_step,
    model_pspecs,
    shard_train_state,
)
