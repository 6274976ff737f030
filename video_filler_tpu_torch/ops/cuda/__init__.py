"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

Sources live in ``video_filler_tpu_torch/csrc``; ``build`` compiles them with
nvcc at first use.  Importing this package compiles nothing."""
