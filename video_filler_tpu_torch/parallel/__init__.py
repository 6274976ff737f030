"""Multi-device training and serving over torch.distributed (counterpart
of video_filler_tpu/parallel/): launch.py (``run_world``), distributed.py
(the world, per-rank batches, gathers), comm.py (collectives and their
adjoints), mesh.py (the ('data','model') mesh, DP and the TP bottleneck)
and temporal.py (sequence parallelism for video3d).

Of the JAX package's names, ``make_mesh`` and ``shard_train_state`` carry
over; its ``NamedSharding`` helpers (``batch_sharding``, ``replicate``,
``shard_batch``, ``state_shardings``) have no counterpart: each rank holds
its own rows and its own shard, and the collectives are explicit.
"""

from video_filler_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_state as shard_train_state,
)
