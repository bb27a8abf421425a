"""Carry weights from the JAX package into this one.

``dcgan_state_dict_from_flax`` maps a ``gandes_tpu`` DCGAN's flax trees
(``g_params`` / ``g_stats``, as numpy) onto ``DCGANGenerator``'s
``state_dict``:

* ConvTranspose kernels (kh, kw, in, out) are flipped spatially and
  transposed to torch's (in, out, kh, kw) — ``lax.conv_transpose``
  correlates on the dilated input where torch convolves
  (``gandes_tpu/train/torch_import.py:40-42``);
* BatchNorm scale/bias/mean/var map to weight/bias/running_mean/running_var.

Orbax checkpoint directories need JAX to read; the crossing for weights
trained there is ``python -m gandes_tpu.cli export-torch --model gandes``,
whose ``.pt`` loads here directly.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def dcgan_state_dict_from_flax(params, batch_stats) -> dict:
    sd = {}
    for i in range(4):
        k = np.asarray(params[f"ConvTranspose_{i}"]["kernel"])
        sd[f"conv{i + 1}.weight"] = _t(k[::-1, ::-1].transpose(2, 3, 0, 1))
    for i in range(3):
        bn_p, bn_s = params[f"BatchNorm_{i}"], batch_stats[f"BatchNorm_{i}"]
        sd[f"batch_norm{i + 1}.weight"] = _t(bn_p["scale"])
        sd[f"batch_norm{i + 1}.bias"] = _t(bn_p["bias"])
        sd[f"batch_norm{i + 1}.running_mean"] = _t(bn_s["mean"])
        sd[f"batch_norm{i + 1}.running_var"] = _t(bn_s["var"])
        sd[f"batch_norm{i + 1}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd
