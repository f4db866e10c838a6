"""DiffServe's offline phase (paper §3.2): the discriminator's training
data, AdamW, checkpoints in the JAX package's file format, and the
training loop."""
