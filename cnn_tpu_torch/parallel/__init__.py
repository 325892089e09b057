from cnn_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    make_pp_mesh,
)
from cnn_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_pp_eval_step,
    make_pp_forward,
    make_pp_train_step,
    pp_decompose,
    shard_pp_train_state,
)
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
