"""Models of the diffusion serving path: latent UNet, DDIM sampler,
EfficientNet-style discriminator, and the JAX parameter converter."""
