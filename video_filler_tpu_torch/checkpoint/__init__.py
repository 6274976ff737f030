from video_filler_tpu_torch.checkpoint.convert import (  # noqa: F401
    from_jax,
    to_jax,
)
