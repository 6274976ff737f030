"""video_filler_tpu_torch — the PyTorch/CUDA port of video_filler_tpu for an
NVIDIA H100.

The JAX package stays the reference; this package mirrors its module names:
  config       the shared option table plus ``device``
  ops/         image, mask and loss ops, NN layers; ops/cuda holds the
               hand-written Hopper kernels (sources in csrc/)
  models/      generators / discriminators of the 2-D regimes
  checkpoint/  checkpoints in the JAX package's file format; JAX parameter
               trees <-> the port's state dicts
  train/       the GAN train step of every 2-D regime, the epoch driver + CLI
  data/        indexes, host decode, samplers, prefetch, fixtures
  entry.py     the flagship video generator, ready to call

It imports torch and never jax.
"""

__version__ = "0.1.0"
