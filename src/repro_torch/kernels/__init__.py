"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their plain
PyTorch versions, and device dispatch (``ops``)."""
