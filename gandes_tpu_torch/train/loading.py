"""Inference-state loading for the server (port of
``gandes_tpu/train/loading.py``, GAN-DES part).

``--torch-checkpoint`` takes a reference-layout generator ``state_dict``:
the reference's own ``gen_*.pt`` or ``python -m gandes_tpu.cli export-torch
--model gandes`` output for weights trained in the JAX package (its orbax
directories need JAX to read). Without one the generator keeps its seeded
initialisation, as the JAX package's server does without a checkpoint.
"""

from __future__ import annotations

import torch

from gandes_tpu_torch.models.gan_des import DCGANGenerator


def load_gandes_state(cfg, torch_checkpoint: str | None = None, device="cuda"):
    """GAN-DES inference state; returns ``(generator, None)`` — the second
    slot is the training state, which inference does not carry. Without a
    checkpoint the weights are drawn from seed 0."""
    gen = DCGANGenerator(noise_dim=cfg.z_dim, generator=torch.Generator().manual_seed(0))
    if torch_checkpoint:
        sd = torch.load(torch_checkpoint, map_location="cpu", weights_only=True)
        gen.load_state_dict(sd, strict=True)
    return gen.to(device).eval(), None


def gandes_eval_forward(gen: DCGANGenerator):
    """Eval-mode DCGAN forward (BatchNorm on its running statistics) under
    ``torch.inference_mode``: z (B, z_dim) -> matrices (B, 20, 20)."""
    gen.eval()

    def forward(z: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return gen(z)

    return forward
