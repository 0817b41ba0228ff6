"""Hand-written Hopper kernels (``csrc/``), their wrappers, their plain
PyTorch versions (``ref``) and the device dispatch (``ops``)."""
