"""Tensor ops of the frontend and matcher; hand-written CUDA kernels under ops/cuda."""
