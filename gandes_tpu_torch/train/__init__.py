"""Steps, loops, checkpoints, weight loading, and weight conversion from the
JAX package."""

from gandes_tpu_torch.train.losses import bce_with_logits
from gandes_tpu_torch.train.steps import (
    GANState,
    make_gandes_train_step,
    make_mmgan_gen_forward,
    make_mmgan_train_step,
    make_steplr,
)
