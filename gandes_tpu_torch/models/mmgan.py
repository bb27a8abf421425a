"""MM-GAN model family in PyTorch (port of ``gandes_tpu/models/mmgan.py``):
adjacency generator G1, beat-conditioned parameter generator G2, and the
piano-roll discriminators.

Architecture (`MMGAN_MIDI_DES/network_tests.py`), NCHW:

* ``MLPGenerator`` (G1, :58-90): cat(noise z, aux) -> 4x [Linear -> BN ->
  sigmoid] with widths 4h, 2h, h, prod(adj_size); reshaped (B, A0, A1).
  Linear weights xavier-normal, biases 0 (weights_init :47-55); BN left at
  torch defaults (weights_init only touches BatchNorm2d, these are 1d).
  The aux input is an argument: the serving path passes the JAX package's
  constant draw (``train/mmgan_loop.py::AUX_INPUT``).
* ``BeatGenerator`` (G2, :93-123): same trunk -> output_dim sim params.
* ``DiscriminatorMLP`` (:126-144, unused by reference training but part of
  the API): Linear+LeakyReLU(0.2) stack h -> 2h -> 1.
* ``DiscriminatorCNN`` (:147-160): (B, 2, 128, T) roll -> Conv(16,k4,s2,p1)
  -> LeakyReLU(0.2) -> Conv(32,k4,s2,p1) -> LeakyReLU -> FC -> 1 logit.
  Torch-default (kaiming-uniform) init — the reference never re-inits it.

Submodules carry the reference's names (``gen.{i}.0`` Linear, ``gen.{i}.1``
BatchNorm1d, ``conv1``, ``conv2``, ``fc``), so a reference ``.pth`` loads
with ``load_state_dict``. BatchNorm: momentum 0.1 (torch convention; flax
0.9), eps 1e-5, and in train mode flax's statistics (``models/batchnorm.py``).
The Linear products stay ``torch.matmul`` (cuBLAS), as the JAX package left
them to XLA.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gandes_tpu_torch.models.batchnorm import FlaxBatchNorm1d
from gandes_tpu_torch.models.initializers import torch_default_, xavier_normal_linear_


def _gen_trunk(in_dim: int, hidden_dim: int, out_dim: int,
               generator: torch.Generator) -> nn.Sequential:
    blocks = []
    for a, b in zip((in_dim, 4 * hidden_dim, 2 * hidden_dim, hidden_dim),
                    (4 * hidden_dim, 2 * hidden_dim, hidden_dim, out_dim)):
        linear = nn.Linear(a, b)
        xavier_normal_linear_(linear, generator)
        blocks.append(nn.Sequential(linear, FlaxBatchNorm1d(b, eps=1e-5, momentum=0.1),
                                    nn.Sigmoid()))
    return nn.Sequential(*blocks)


def _run_trunk(trunk: nn.Sequential, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
    for linear, bn, act in trunk:
        x = act(bn(linear(x), update_stats=update_stats))
    return x


class MLPGenerator(nn.Module):
    """G1: (noise, aux) -> adjacency matrix in [0,1]."""

    def __init__(self, z_dim: int = 50, hidden_dim: int = 64, input_dim: int = 50,
                 adj_size: tuple[int, int] = (64, 64),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.adj_size = tuple(adj_size)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.gen = _gen_trunk(z_dim + input_dim, hidden_dim, math.prod(self.adj_size),
                              generator)

    def forward(self, noise: torch.Tensor, input_tensor: torch.Tensor,
                update_stats: bool = True) -> torch.Tensor:
        x = _run_trunk(self.gen, torch.cat([noise, input_tensor], 1), update_stats)
        return x.reshape(noise.shape[0], *self.adj_size)


class BeatGenerator(nn.Module):
    """G2: (noise, beat vector) -> simulator parameter vector in [0,1]."""

    def __init__(self, z_dim: int = 50, hidden_dim: int = 64, input_dim: int = 50,
                 output_dim: int = 20, generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.gen = _gen_trunk(z_dim + input_dim, hidden_dim, output_dim, generator)

    def forward(self, noise: torch.Tensor, input_tensor: torch.Tensor,
                update_stats: bool = True) -> torch.Tensor:
        return _run_trunk(self.gen, torch.cat([noise, input_tensor], 1), update_stats)


class DiscriminatorMLP(nn.Module):
    """Unused-by-training reference Discriminator (:126-144), kept for API
    completeness."""

    def __init__(self, hidden_dim: int = 16, roll_size: tuple[int, int, int] = (2, 128, 50),
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        widths = (math.prod(roll_size), hidden_dim, 2 * hidden_dim, 1)
        layers = []
        for a, b in zip(widths[:-1], widths[1:]):
            linear = nn.Linear(a, b)
            torch_default_(linear, generator)
            layers += [linear, nn.LeakyReLU(0.2)]
        self.disc = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.disc(x.reshape(x.shape[0], -1))


class DiscriminatorCNN(nn.Module):
    """Piano-roll discriminator; input (B, 2, 128, T), returns (B, 1) logits."""

    def __init__(self, roll_size: tuple[int, int, int] = (2, 128, 50), hidden_dim: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        c, h, w = roll_size
        self.conv1 = nn.Conv2d(c, hidden_dim, 4, 2, 1)
        self.conv2 = nn.Conv2d(hidden_dim, 2 * hidden_dim, 4, 2, 1)
        self.fc = nn.Linear(2 * hidden_dim * (h // 4) * (w // 4), 1)
        for layer in (self.conv1, self.conv2, self.fc):
            torch_default_(layer, generator)

    def forward(self, roll: torch.Tensor) -> torch.Tensor:
        x = nn.functional.leaky_relu(self.conv1(roll), 0.2)
        x = nn.functional.leaky_relu(self.conv2(x), 0.2)
        return self.fc(x.reshape(x.shape[0], -1))
