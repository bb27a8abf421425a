"""Weight initializers matching the reference's torch init semantics
(port of ``gandes_tpu/models/initializers.py``, GAN-DES part).

``normal002_`` — N(0, 0.02), for conv/convT kernels (GAN-DES
`SIMNN.py:49-59, 89-95`) and, the GAN-DES quirk, for BatchNorm scales too:
``weights_init`` re-inits them to N(0, 0.02) *after* the N(1, 0.02) init
(`SIMNN.py:252` applies weights_init last), leaving near-zero BN scales.

It takes an explicit ``torch.Generator``; the draws are a different stream
from the JAX package's ``jax.random`` keys.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def normal002_(tensor: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return tensor.normal_(0.0, 0.02, generator=generator)
