"""Kernel wrappers: each dispatches CPU tensors to a plain PyTorch twin and
CUDA tensors to a hand-written kernel in ``commu_tpu_torch/csrc``."""
