"""GAN-DES configuration (port of ``gandes_tpu/train/gandes_loop.py``'s
``GanDesConfig``). The training loop and its fields come with GAN-DES
training; serving reads the noise width."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class GanDesConfig:
    z_dim: int = 100
