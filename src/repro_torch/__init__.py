"""Asyncval on PyTorch and hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``repro`` (which stays as the reference); it
mirrors that package path for path and imports nothing from it.  Entry
point: ``python -m repro_torch.core.cli``.
"""
