"""GAN-DES DCGAN generator in PyTorch (port of
``gandes_tpu/models/gan_des.py::DCGANGenerator``).

Architecture (`GAN_DES/SIMNN.py:62-112`), NCHW: noise (B, 100) ->
ConvT(100->128, k4, s1) -> BN -> ReLU -> ConvT(128->64, k4, s2, p1) -> BN ->
ReLU -> ConvT(64->32, k4, s2, p1) -> BN -> ReLU -> ConvT(32->1, k5, s1) ->
sigmoid, output (B, 20, 20) in [0, 1] (spatial chain 1 -> 4 -> 8 -> 16 -> 20).

Submodules carry the reference's names (``conv1..conv4``,
``batch_norm1..3``), so a reference ``gen_*.pt`` and the output of
``python -m gandes_tpu.cli export-torch --model gandes`` load with
``load_state_dict``. BatchNorm: momentum 0.1 (torch convention; flax 0.9),
eps 1e-5. The mel discriminator comes with GAN-DES training.
"""

from __future__ import annotations

import torch
from torch import nn

from gandes_tpu_torch.models.initializers import normal002_


class DCGANGenerator(nn.Module):
    def __init__(self, noise_dim: int = 100, gen_dim: int = 32, out_channels: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.noise_dim = noise_dim
        self.conv1 = nn.ConvTranspose2d(noise_dim, gen_dim * 4, 4, 1, 0, bias=False)
        self.batch_norm1 = nn.BatchNorm2d(gen_dim * 4, eps=1e-5, momentum=0.1)
        self.conv2 = nn.ConvTranspose2d(gen_dim * 4, gen_dim * 2, 4, 2, 1, bias=False)
        self.batch_norm2 = nn.BatchNorm2d(gen_dim * 2, eps=1e-5, momentum=0.1)
        self.conv3 = nn.ConvTranspose2d(gen_dim * 2, gen_dim, 4, 2, 1, bias=False)
        self.batch_norm3 = nn.BatchNorm2d(gen_dim, eps=1e-5, momentum=0.1)
        self.conv4 = nn.ConvTranspose2d(gen_dim, out_channels, 5, 1, 0, bias=False)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            normal002_(conv.weight, generator)
        for bn in (self.batch_norm1, self.batch_norm2, self.batch_norm3):
            normal002_(bn.weight, generator)  # reference weights_init quirk
            nn.init.zeros_(bn.bias)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z.reshape(z.shape[0], self.noise_dim, 1, 1)
        x = torch.relu(self.batch_norm1(self.conv1(x)))    # (B,128,4,4)
        x = torch.relu(self.batch_norm2(self.conv2(x)))    # (B,64,8,8)
        x = torch.relu(self.batch_norm3(self.conv3(x)))    # (B,32,16,16)
        x = torch.sigmoid(self.conv4(x))                   # (B,1,20,20)
        return x[:, 0]
