from video_filler_tpu_torch.train.step import (  # noqa: F401
    TrainState,
    init_train_state,
    make_preprocess,
    make_train_step,
)
