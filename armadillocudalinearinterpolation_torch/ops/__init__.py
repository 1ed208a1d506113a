"""Standalone ops: batched interpolation (plain PyTorch semantics and CUDA
kernels)."""
