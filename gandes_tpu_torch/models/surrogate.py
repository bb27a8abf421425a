"""Learned DES surrogate in PyTorch (port of ``gandes_tpu/models/surrogate.py``,
the GAN-DES part).

The reference's generators receive exactly zero gradient: the training loop
detaches G's output before the simulator (`GAN_DES/SIMNN.py:299`), so only
D learns. ``g_update='surrogate'`` trains ``MelSurrogate`` online (one step
with the D and G updates, ``train/steps.py::make_gandes_train_step_surrogate``)
to regress the pipeline's actual mel from the matrix that produced it, and G
then trains through it straight-through.

``MelSurrogate``: (B, 20, 20) matrix -> Dense 400->512 -> LeakyReLU(0.2) ->
Dense 512->512 -> LeakyReLU(0.2) -> Dense 512->128*216, reshaped to the
(B, 128, 216) mel-dB spectrogram (a linear head: mel-dB values are signed).
The Linear products stay ``torch.matmul`` (cuBLAS), as the JAX package left
them to XLA. Init: flax ``nn.Dense``'s default (``lecun_normal_``), drawn from
a ``torch.Generator``. The MM-GAN ``RollSurrogate`` is not ported yet
(``ROADMAP.md`` Queue 1 item 4).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gandes_tpu_torch.models.initializers import lecun_normal_

HIDDEN = 512  # the JAX module's hidden_dim


class MelSurrogate(nn.Module):
    def __init__(self, mel_shape: tuple[int, int] = (128, 216),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.mel_shape = tuple(mel_shape)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.fc1 = nn.Linear(20 * 20, HIDDEN)
        self.fc2 = nn.Linear(HIDDEN, HIDDEN)
        self.fc3 = nn.Linear(HIDDEN, math.prod(self.mel_shape))
        for layer in (self.fc1, self.fc2, self.fc3):
            lecun_normal_(layer, generator)

    def forward(self, mats: torch.Tensor) -> torch.Tensor:
        x = nn.functional.leaky_relu(self.fc1(mats.reshape(mats.shape[0], -1)), 0.2)
        x = nn.functional.leaky_relu(self.fc2(x), 0.2)
        return self.fc3(x).reshape(mats.shape[0], *self.mel_shape)
