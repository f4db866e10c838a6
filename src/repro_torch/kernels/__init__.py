"""Hopper kernels of the serving path, their plain PyTorch versions
(``ref``), and the device dispatch (``ops``)."""
