"""PyTorch/CUDA port of the gs-SGD system (``repro``), for one NVIDIA H100.

Module paths mirror the JAX package: ``repro_torch/core/count_sketch.py``
is the port of ``repro/core/count_sketch.py``, and so on. P data-parallel
workers are simulated on a leading dimension of every per-worker tensor;
the Count-Sketch encode and the HEAVYMIX scoring run as hand-written CUDA
kernels (``repro_torch/csrc``) on CUDA tensors and as their plain PyTorch
versions on CPU tensors.

This package imports torch and never jax or ``repro``.
"""
