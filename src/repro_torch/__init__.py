"""PyTorch/CUDA port of ``repro`` (Online Model Compression for FL).

Same subpackage layout and names as ``src/repro``; the hand-written Hopper
kernels live in ``repro_torch.kernels``.  The package imports ``torch``,
``numpy`` and the standard library only.
"""
