"""PyTorch/CUDA port of ``dsgcn_tpu`` for NVIDIA Hopper.

Mirrors the JAX package's module and class names.  Public tensors keep the
JAX layout: channels-last ``(N, T, V, C)`` activations and ``(N, M, T, V, C)``
model inputs.  The package imports nothing of JAX or ``dsgcn_tpu``; its CUDA
kernels are compiled from ``ops/kernels/csrc`` at first use.
"""
