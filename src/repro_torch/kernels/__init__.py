"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), their plain versions
(``ref``) and the device dispatch with launch counters (``ops``)."""
