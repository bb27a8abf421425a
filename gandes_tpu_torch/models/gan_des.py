"""GAN-DES model family in PyTorch (port of ``gandes_tpu/models/gan_des.py``):
the DCGAN that emits 20x20 adjacency matrices and the CNN mel-spectrogram
discriminator.

* ``DCGANGenerator`` (`GAN_DES/SIMNN.py:62-112`), NCHW: noise (B, 100) ->
  ConvT(100->128, k4, s1) -> BN -> ReLU -> ConvT(128->64, k4, s2, p1) -> BN ->
  ReLU -> ConvT(64->32, k4, s2, p1) -> BN -> ReLU -> ConvT(32->1, k5, s1) ->
  sigmoid, output (B, 20, 20) in [0, 1] (spatial chain 1 -> 4 -> 8 -> 16 -> 20).
* ``MelDiscriminator`` (the reference's ``Discriminator``, `SIMNN.py:115-142`):
  (B, 128, 216) mel dB -> Conv(1->16, k2, p1) -> ReLU -> MaxPool2 ->
  Conv(16->32, k3, p1) -> ReLU -> MaxPool2 -> FC(32*32*54 -> 128) -> ReLU ->
  FC(128 -> 1) -> sigmoid. The reference feeds this *sigmoided* output into
  BCE-with-logits; that double squash is the train step's
  (``train/steps.py``), not here. Torch-default init: the reference never
  re-inits it.

The generator's submodules carry the reference's names (``conv1..conv4``,
``batch_norm1..3``), so a reference ``gen_*.pt`` and the output of
``python -m gandes_tpu.cli export-torch --model gandes`` load with
``load_state_dict``. BatchNorm: momentum 0.1 (torch convention; flax 0.9),
eps 1e-5, and in train mode flax's statistics (``models/batchnorm.py``).

``fc1`` follows an NCHW flatten, (c, h, w); the JAX package's ``Dense_0``
follows an NHWC one, (h, w, c): weights crossing between the two permute
its input axis (``train/convert.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from gandes_tpu_torch.models.batchnorm import FlaxBatchNorm2d
from gandes_tpu_torch.models.initializers import normal002_, torch_default_


class DCGANGenerator(nn.Module):
    def __init__(self, noise_dim: int = 100, gen_dim: int = 32, out_channels: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.noise_dim = noise_dim
        self.conv1 = nn.ConvTranspose2d(noise_dim, gen_dim * 4, 4, 1, 0, bias=False)
        self.batch_norm1 = FlaxBatchNorm2d(gen_dim * 4, eps=1e-5, momentum=0.1)
        self.conv2 = nn.ConvTranspose2d(gen_dim * 4, gen_dim * 2, 4, 2, 1, bias=False)
        self.batch_norm2 = FlaxBatchNorm2d(gen_dim * 2, eps=1e-5, momentum=0.1)
        self.conv3 = nn.ConvTranspose2d(gen_dim * 2, gen_dim, 4, 2, 1, bias=False)
        self.batch_norm3 = FlaxBatchNorm2d(gen_dim, eps=1e-5, momentum=0.1)
        self.conv4 = nn.ConvTranspose2d(gen_dim, out_channels, 5, 1, 0, bias=False)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            normal002_(conv.weight, generator)
        for bn in (self.batch_norm1, self.batch_norm2, self.batch_norm3):
            normal002_(bn.weight, generator)  # reference weights_init quirk
            nn.init.zeros_(bn.bias)

    def forward(self, z: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        x = z.reshape(z.shape[0], self.noise_dim, 1, 1)
        for conv, bn in ((self.conv1, self.batch_norm1), (self.conv2, self.batch_norm2),
                         (self.conv3, self.batch_norm3)):     # (B,128,4,4) (B,64,8,8) (B,32,16,16)
            x = torch.relu(bn(conv(x), update_stats=update_stats))
        return torch.sigmoid(self.conv4(x))[:, 0]             # (B,20,20)


class MelDiscriminator(nn.Module):
    """(B, 128, 216) mel dB -> (B, 1) probabilities (sigmoided)."""

    def __init__(self, mel_shape: tuple[int, int] = (128, 216),
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        h, w = mel_shape
        self.conv1 = nn.Conv2d(1, 16, 2, 1, 1)
        self.conv2 = nn.Conv2d(16, 32, 3, 1, 1)
        # Conv(k2, p1) grows each side by one, each pool floors a half
        self.fc1 = nn.Linear(32 * ((h + 1) // 2 // 2) * ((w + 1) // 2 // 2), 128)
        self.fc2 = nn.Linear(128, 1)
        for layer in (self.conv1, self.conv2, self.fc1, self.fc2):
            torch_default_(layer, generator)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = nn.functional.max_pool2d(torch.relu(self.conv1(mel[:, None])), 2)  # (B,16,64,108)
        x = nn.functional.max_pool2d(torch.relu(self.conv2(x)), 2)             # (B,32,32,54)
        x = torch.relu(self.fc1(x.reshape(x.shape[0], -1)))
        return torch.sigmoid(self.fc2(x))
