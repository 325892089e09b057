from cnn_tpu_torch.parallel.train_step import (  # noqa: F401
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)
