"""Flax's train-mode BatchNorm on torch's BatchNorm modules (the JAX
package's ``nn.BatchNorm(momentum=0.9)`` in ``gandes_tpu/models/mmgan.py:46-48``
and ``gandes_tpu/models/gan_des.py:46-52``).

A train-mode batch is normalised with its biased variance, as torch does
(computed as flax computes it, E[x^2] - E[x]^2, floored at 0), over every
axis but the channels (axis 1); but ``running_var`` is updated with the
*biased* variance too, where torch uses the unbiased one, n/(n-1) larger
(n the count of values per channel). ``update_stats=False`` normalises in
train mode and leaves the running statistics alone, as the JAX steps that
discard the statistics they compute do. Eval mode is torch's; the
``state_dict`` keys are unchanged.
"""

from __future__ import annotations

import torch
from torch import nn


class FlaxBatchNormMixin:
    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = (0, *range(2, x.dim()))
        mean = x.mean(dims)
        var = ((x * x).mean(dims) - mean * mean).clamp(min=0)
        if update_stats:
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(mean, alpha=self.momentum)
                self.running_var.mul_(1 - self.momentum).add_(var, alpha=self.momentum)
                self.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return ((x - mean.view(shape)) * (torch.rsqrt(var + self.eps) * self.weight).view(shape)
                + self.bias.view(shape))


class FlaxBatchNorm1d(FlaxBatchNormMixin, nn.BatchNorm1d):
    """(B, C) input: statistics over the batch (the MM-GAN generators)."""


class FlaxBatchNorm2d(FlaxBatchNormMixin, nn.BatchNorm2d):
    """(B, C, H, W) input: statistics over (B, H, W) (the GAN-DES DCGAN)."""
