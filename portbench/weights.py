"""Model weights made by the benchmark from a configuration's ``weight_seed``.

The weights are drawn on the device with one ``torch.Generator`` in one
``randn`` call per model, then scaled tensor by tensor to the init that the
model's publication uses (xavier-normal for MM-GAN's generator layers,
torch's default fan-in scale for its discriminator, N(0, 0.02) for the
DCGAN's kernels and, as its ``weights_init`` leaves them, its BatchNorm
scales). The same state dict goes to the program (as a checkpoint in the
reference layout) and to the plain reference, so neither side's own init
is used and ``--seed`` never changes a weight.
"""

from __future__ import annotations

import math

import torch

BN_KEYS = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def _mmgan_layout(noise_dim, beat_dim, adj_size, gen2_out, roll_size, hidden=64, d_hidden=16):
    """[(key, shape, kind, fan_in, fan_out)] in the reference's key order."""
    out = []
    for g, last in (("generator1", adj_size[0] * adj_size[1]), ("generator2", gen2_out)):
        widths = (noise_dim + beat_dim, 4 * hidden, 2 * hidden, hidden, last)
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            out.append((f"{g}.gen.{i}.0.weight", (b, a), "xavier", a, b))
            out.append((f"{g}.gen.{i}.0.bias", (b,), "zeros", a, b))
            out += [(f"{g}.gen.{i}.1.{k}", (b,) if k != "num_batches_tracked" else (), k, a, b)
                    for k in BN_KEYS]
    c, h, w = roll_size
    fc_in = 2 * d_hidden * (h // 4) * (w // 4)
    for name, shape, fan_in in (("conv1", (d_hidden, c, 4, 4), c * 16),
                                ("conv2", (2 * d_hidden, d_hidden, 4, 4), d_hidden * 16),
                                ("fc", (1, fc_in), fc_in)):
        out.append((f"discriminator.{name}.weight", shape, "fan_in", fan_in, 0))
        out.append((f"discriminator.{name}.bias", shape[:1], "fan_in", fan_in, 0))
    return out


def _dcgan_layout(z_dim, gen_dim=32):
    out = []
    chans = (z_dim, 4 * gen_dim, 2 * gen_dim, gen_dim, 1)
    kernels = (4, 4, 4, 5)
    for i in range(4):
        out.append((f"conv{i + 1}.weight", (chans[i], chans[i + 1], kernels[i], kernels[i]),
                    "n002", 0, 0))
        if i < 3:
            b = chans[i + 1]
            out.append((f"batch_norm{i + 1}.weight", (b,), "n002", 0, 0))
            out += [(f"batch_norm{i + 1}.{k}", (b,) if k != "num_batches_tracked" else (), k, 0, 0)
                    for k in BN_KEYS[1:]]
    return out


def _fill(layout, seed: int, device) -> dict:
    """One ``randn`` over every drawn element, split and scaled per tensor."""
    drawn = [(k, s) for k, s, kind, _, _ in layout if kind in ("xavier", "fan_in", "n002")]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    sd, pos = {}, 0
    for key, shape, kind, fan_in, fan_out in layout:
        if kind in ("xavier", "fan_in", "n002"):
            n = math.prod(shape)
            x = flat[pos:pos + n].view(shape)
            pos += n
            if kind == "xavier":
                std = math.sqrt(2.0 / (fan_in + fan_out))
            elif kind == "fan_in":  # U(-1/sqrt(fan_in), 1/sqrt(fan_in))'s std
                std = 1.0 / math.sqrt(3.0 * fan_in)
            else:
                std = 0.02
            sd[key] = x * std
        elif kind in ("zeros", "bias", "running_mean"):
            sd[key] = torch.zeros(shape, device=device)
        elif kind in ("weight", "running_var"):
            sd[key] = torch.ones(shape, device=device)
        else:  # num_batches_tracked
            sd[key] = torch.zeros(shape, dtype=torch.int64, device=device)
    return sd


def mmgan_weights(config: dict, device) -> dict:
    """The MM-GAN state dict (G1, G2 and D, 62 tensors) from ``weight_seed``."""
    return _fill(_mmgan_layout(config["noise_dim"], config["max_beat_length"],
                               config["adj_size"], config["gen2_output_dim"],
                               (2, 128, config["sequence_length"])),
                 config["weight_seed"], device)


def gandes_weights(config: dict, device) -> dict:
    """The DCGAN generator's state dict from ``weight_seed``."""
    return _fill(_dcgan_layout(config["z_dim"]), config["weight_seed"], device)
