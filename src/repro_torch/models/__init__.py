"""Models of the ported serving paths: latent UNet, DDIM sampler and
EfficientNet-style discriminator (diffusion); the dense decoder-only LM,
its layers and KV cache; and the JAX parameter converter."""
