"""PyTorch / CUDA port of the JAX package ``repro``, for an NVIDIA H100.

It imports torch and numpy and never JAX or ``repro``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
