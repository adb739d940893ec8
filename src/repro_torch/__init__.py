"""PyTorch + CUDA port of the ``repro`` package for NVIDIA Hopper.

Mirrors ``src/repro`` module for module. Imports ``torch`` and never
``jax`` or ``repro``; every Pallas TPU kernel on a ported path becomes a
hand-written CUDA kernel under ``kernels/*/csrc``, built on first use by
``repro_torch.kernels.runtime``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, where each kernel wrapper takes its plain
PyTorch version.
"""
