"""PyTorch / CUDA port of the DiffServe reproduction.

Layout mirrors the JAX package (``repro``), which stays the reference:
``config`` and ``configs`` (own copies of the configs), ``kernels``
(hand-written Hopper kernels, their plain PyTorch versions and the
dispatch in ``kernels/ops.py``), ``models`` (UNet, DDIM, discriminator;
the dense LM and its KV cache; the JAX parameter converter),
``core/cascade.py``, ``serving/cluster.py`` and ``launch/steps.py`` (the
LM's prefill and decode steps).
The port imports ``torch`` and never ``jax`` or ``repro``.
"""
