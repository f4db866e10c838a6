"""PyTorch / CUDA port of the DiffServe reproduction.

Layout mirrors the JAX package (``repro``), which stays the reference:
``config`` (own copies of the configs), ``kernels`` (hand-written Hopper
kernels, their plain PyTorch versions and the dispatch in
``kernels/ops.py``), ``models`` (UNet, DDIM, discriminator, the JAX
parameter converter), ``core/cascade.py`` and ``serving/cluster.py``.
The port imports ``torch`` and never ``jax`` or ``repro``.
"""
