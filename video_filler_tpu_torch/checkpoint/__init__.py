from video_filler_tpu_torch.checkpoint.ckpt import (  # noqa: F401
    checkpoint_path,
    flatten_generator,
    prune_checkpoints,
    read_meta,
    restore_checkpoint,
    restore_latest,
    restore_subtree,
    save_checkpoint,
    wait_pending_saves,
)
from video_filler_tpu_torch.checkpoint.convert import (  # noqa: F401
    from_jax,
    to_jax,
)
