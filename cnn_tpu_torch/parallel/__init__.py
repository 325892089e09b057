from cnn_tpu_torch.parallel.train_step import (  # noqa: F401
    TrainState,
    create_train_state,
    make_ensemble_eval_step,
    make_eval_step,
    make_forward,
    make_train_step,
)
