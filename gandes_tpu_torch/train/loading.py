"""Inference-state loading for the server and the CLI (port of
``gandes_tpu/train/loading.py``).

``--torch-checkpoint`` takes a reference-layout ``state_dict``: for GAN-DES
the reference's own ``gen_*.pt`` or a ``train-gandes`` ``gen_{step}_{ts}``
directory, for MM-GAN its ``mmgan_*_epoch_*.pth``, or
``python -m gandes_tpu.cli export-torch --model gandes|mmgan`` output for
weights trained in the JAX package (its orbax directories need JAX to
read). Without one the models keep their seeded initialisation, as the JAX
package's server does without a checkpoint.
"""

from __future__ import annotations

import os

import torch

from gandes_tpu_torch.models.gan_des import DCGANGenerator
from gandes_tpu_torch.train.checkpoint import MODEL_FILE


def load_gandes_state(cfg, torch_checkpoint: str | None = None, device="cuda"):
    """GAN-DES inference state; returns ``(generator, None)`` — the second
    slot is the training state, which inference does not carry. Without a
    checkpoint the weights are drawn from seed 0. ``torch_checkpoint`` is a
    reference-layout ``.pt``/``.pth`` or a ``gen_{step}_{ts}`` directory of
    ``train-gandes`` (its ``model.pth``)."""
    gen = DCGANGenerator(noise_dim=cfg.z_dim, generator=torch.Generator().manual_seed(0))
    if torch_checkpoint:
        if os.path.isdir(torch_checkpoint):
            torch_checkpoint = os.path.join(torch_checkpoint, MODEL_FILE)
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


def load_mmgan_state(cfg, torch_checkpoint: str | None = None, device="cuda"):
    """MM-GAN inference model (``MultiModalGAN``, eval mode, on ``device``).

    Without a checkpoint the weights are drawn from ``cfg.seed``. A
    checkpoint's discriminator sets its own roll width (its ``fc`` input),
    as the JAX package's import infers it; serving never runs D."""
    from dataclasses import replace

    from gandes_tpu_torch.train.mmgan_loop import build_mmgan

    sd = None
    if torch_checkpoint:
        sd = torch.load(torch_checkpoint, map_location="cpu", weights_only=True)
        fc_in = sd["discriminator.fc.weight"].shape[1]
        cfg = replace(cfg, sequence_length=4 * (fc_in // (32 * 32)))
    model = build_mmgan(cfg)
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    return model.to(device).eval()
