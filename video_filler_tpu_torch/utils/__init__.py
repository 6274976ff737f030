"""Host utilities of the port, copied from the JAX package's ``utils``:
PNG/GIF writers, the JSONL metrics logger and the HTTP handler base.  The
live dashboard and the compilation-cache helper are not copied: no module of
the port uses them."""

from video_filler_tpu_torch.utils.httpbase import QuietHandler  # noqa: F401
from video_filler_tpu_torch.utils.io import (  # noqa: F401
    save_gif,
    save_image_grid,
    save_png,
)
from video_filler_tpu_torch.utils.logger import MetricsLogger  # noqa: F401
