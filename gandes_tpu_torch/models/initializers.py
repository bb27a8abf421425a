"""Weight initializers matching the reference's torch init semantics
(port of ``gandes_tpu/models/initializers.py``).

* ``normal002_`` — N(0, 0.02), for conv/convT kernels (GAN-DES
  `SIMNN.py:49-59, 89-95`) and, the GAN-DES quirk, for BatchNorm scales too:
  ``weights_init`` re-inits them to N(0, 0.02) *after* the N(1, 0.02) init
  (`SIMNN.py:252` applies weights_init last), leaving near-zero BN scales.
* ``xavier_normal_linear_`` — MM-GAN generator Linear layers: xavier-normal
  weights, zero biases (`network_tests.py:47-55`).
* ``torch_default_`` — torch's default Linear/Conv init, kaiming-uniform
  (a=sqrt(5)) == U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the weight and the
  bias; the MM-GAN discriminators never get a custom init.
* ``lecun_normal_`` — flax ``nn.Dense``'s default, for the JAX package's own
  modules (``MelSurrogate``).

Each takes an explicit ``torch.Generator``; the draws are a different stream
from the JAX package's ``jax.random`` keys.
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def normal002_(tensor: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return tensor.normal_(0.0, 0.02, generator=generator)


@torch.no_grad()
def xavier_normal_linear_(layer: nn.Linear, generator: torch.Generator) -> None:
    nn.init.xavier_normal_(layer.weight, generator=generator)
    nn.init.zeros_(layer.bias)


@torch.no_grad()
def torch_default_(layer: nn.Module, generator: torch.Generator) -> None:
    """``reset_parameters`` of ``nn.Linear`` / ``nn.Conv2d``, drawn from
    ``generator``."""
    nn.init.kaiming_uniform_(layer.weight, a=math.sqrt(5), generator=generator)
    fan_in = layer.weight[0].numel()
    bound = 1.0 / math.sqrt(fan_in)
    nn.init.uniform_(layer.bias, -bound, bound, generator=generator)


# std of a standard normal truncated to [-2, 2]; flax's truncated-normal
# variance scaling divides by it
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(layer: nn.Linear, generator: torch.Generator) -> None:
    """flax ``nn.Dense``'s default init: the weight from a normal of std
    sqrt(1 / fan_in) truncated at two of its stds (``lecun_normal``), the bias
    zero."""
    std = math.sqrt(1.0 / layer.weight.shape[1]) / _TRUNC_STD
    nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
    nn.init.zeros_(layer.bias)
