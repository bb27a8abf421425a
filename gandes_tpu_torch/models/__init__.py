import torch

from gandes_tpu_torch.models.composite import MultiModalGAN, SimNN
from gandes_tpu_torch.models.gan_des import DCGANGenerator, MelDiscriminator
from gandes_tpu_torch.models.mmgan import (
    BeatGenerator,
    DiscriminatorCNN,
    DiscriminatorMLP,
    MLPGenerator,
)


def get_noise(generator: torch.Generator, n_samples: int, noise_dim: int, device=None):
    """Reference helper (`GAN_DES/SIMNN.py:37-46`, `network_tests.py:43-44`):
    N(0, 1) noise of shape (n_samples, noise_dim), drawn from ``generator``
    on its own device and moved to ``device`` (default: the generator's).
    The JAX package draws from a ``jax.random`` key: another stream."""
    noise = torch.randn(n_samples, noise_dim, generator=generator, device=generator.device)
    return noise if device is None else noise.to(device)
