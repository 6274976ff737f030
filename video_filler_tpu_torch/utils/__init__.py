"""Host utilities of the port, copied from the JAX package's ``utils``:
PNG/GIF writers, the JSONL metrics logger, the HTTP handler base and the
live dashboard.  The compilation-cache helper is not copied: it serves the
JAX compiler only."""

from video_filler_tpu_torch.utils.dashboard import Dashboard  # noqa: F401
from video_filler_tpu_torch.utils.httpbase import QuietHandler  # noqa: F401
from video_filler_tpu_torch.utils.io import (  # noqa: F401
    save_gif,
    save_image_grid,
    save_png,
)
from video_filler_tpu_torch.utils.logger import MetricsLogger  # noqa: F401
