"""video_filler_tpu_torch — the PyTorch/CUDA port of video_filler_tpu for an
NVIDIA H100.

The JAX package stays the reference; this package mirrors its module names:
  config       the shared option table plus ``device``
  ops/         image, mask and loss ops, NN layers; ops/cuda holds the
               hand-written Hopper kernels (sources in csrc/)
  models/      center-regime generator / discriminator
  checkpoint/  JAX parameter trees <-> the port's state dicts
  train/       the center GAN train step and the epoch driver + CLI
  data/        folder index, host decode, sampler, prefetch, fixtures

It imports torch and never jax.
"""

__version__ = "0.1.0"
