"""The generators and the MM-GAN discriminator step in plain PyTorch, for the
benchmark's plain reference.

Each takes the state dict that ``portbench/weights.py`` made (the reference
layout's keys) and runs in the dtype of its inputs with ``torch.nn.functional``
alone. BatchNorm in train mode normalises with the batch's mean and biased
variance, taken in two passes.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
BN_EPS = 1e-5


_TF32 = [False]


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products in float32 (``tf32=False``, the configurations'
    precision) or in TF32 (the control's), restored on exit. In TF32 the
    operands of every matrix product and convolution are also rounded to
    TF32's 10-bit mantissa here, so that the control is TF32 arithmetic even
    where cuBLAS takes a kernel without tensor cores (a matrix-vector product
    at one sample)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, _TF32[0])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    _TF32[0] = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         _TF32[0]) = old


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest, ties to even, on a 10-bit mantissa."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)


def operand(x: torch.Tensor) -> torch.Tensor:
    """A product's operand: itself, or under the TF32 control its TF32
    rounding (gradients pass through unchanged)."""
    if not _TF32[0]:
        return x
    return x + (tf32_round(x.detach()) - x).detach()


def _bn(x, sd, prefix, train: bool):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if train:
        dims = [0, *range(2, x.dim())]
        mean = x.mean(dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dims, keepdim=True)
    else:
        mean = sd[prefix + ".running_mean"].view(shape)
        var = sd[prefix + ".running_var"].view(shape)
    return ((x - mean) / torch.sqrt(var + BN_EPS) * sd[prefix + ".weight"].view(shape)
            + sd[prefix + ".bias"].view(shape))


def mmgan_generators(sd, noise1, noise2, beats, aux, train: bool):
    """G1's (B, 64, 64) matrices and G2's (B, 20) vectors: four Linear ->
    BatchNorm -> sigmoid blocks each, on cat(noise1, aux) and cat(noise2,
    beats)."""

    def trunk(name, x):
        for i in range(4):
            x = F.linear(operand(x), operand(sd[f"{name}.gen.{i}.0.weight"]),
                         sd[f"{name}.gen.{i}.0.bias"])
            x = torch.sigmoid(_bn(x, sd, f"{name}.gen.{i}.1", train))
        return x

    mats = trunk("generator1", torch.cat([noise1, aux], 1))
    side = int(round(mats.shape[1] ** 0.5))
    return mats.reshape(-1, side, side), trunk("generator2", torch.cat([noise2, beats], 1))


def dcgan_logits(sd, z):
    """The DCGAN's eval-mode (B, 1, 20, 20) last convolution, before its
    sigmoid, from (B, z_dim) noise."""
    x = z.reshape(z.shape[0], -1, 1, 1)
    for i, (stride, pad) in enumerate(((1, 0), (2, 1), (2, 1))):
        x = F.conv_transpose2d(operand(x), operand(sd[f"conv{i + 1}.weight"]), stride=stride,
                               padding=pad)
        x = torch.relu(_bn(x, sd, f"batch_norm{i + 1}", train=False))
    return F.conv_transpose2d(operand(x), operand(sd["conv4.weight"]), stride=1, padding=0)


def dcgan_generator(sd, z):
    """The DCGAN's eval-mode (B, 20, 20) matrices from (B, z_dim) noise."""
    return torch.sigmoid(dcgan_logits(sd, z))[:, 0]


def discriminator(p, roll):
    """(B, 2, 128, T) rolls -> (B,) logits: two stride-2 4x4 convolutions with
    LeakyReLU(0.2), then one dense layer."""
    x = F.leaky_relu(F.conv2d(operand(roll), operand(p["conv1.weight"]), p["conv1.bias"],
                              stride=2, padding=1), 0.2)
    x = F.leaky_relu(F.conv2d(operand(x), operand(p["conv2.weight"]), p["conv2.bias"],
                              stride=2, padding=1), 0.2)
    return F.linear(operand(x.reshape(x.shape[0], -1)), operand(p["fc.weight"]),
                    p["fc.bias"])[:, 0]


def bce_with_logits(logits, target: float):
    """Mean binary cross-entropy of logits against one label."""
    return torch.mean(logits.clamp(min=0) - logits * target
                      + torch.log1p(torch.exp(-logits.abs())))


def d_steps(params: dict, reals, fakes, lrs):
    """``len(reals)`` MM-GAN steps of ``g_update='none'`` from D's ``params``:
    D's loss (fakes to 0, reals to 1), Adam on D, then G's loss under the
    updated D. G's parameters take no gradient in this mode and do not
    move. Returns (d_losses, g_losses, the first step's gradients, the
    params after every step)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = ADAM_BETAS
    d_losses, g_losses, first_grads = [], [], None
    for t, (real, fake, lr) in enumerate(zip(reals, fakes, lrs), start=1):
        d_loss = bce_with_logits(discriminator(p, fake), 0.0) + bce_with_logits(
            discriminator(p, real), 1.0)
        grads = dict(zip(p, torch.autograd.grad(d_loss, list(p.values()))))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k in p:
                m[k].mul_(b1).add_(grads[k], alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(grads[k], grads[k], value=1 - b2)
                denom = (v2[k] / (1 - b2 ** t)).sqrt_().add_(ADAM_EPS)
                p[k].sub_(lr * (m[k] / (1 - b1 ** t)) / denom)
            g_loss = bce_with_logits(discriminator(p, fake), 1.0)
        d_losses.append(d_loss.item())
        g_losses.append(float(g_loss))
    return d_losses, g_losses, first_grads, {k: v.detach() for k, v in p.items()}


def step_noise(seed: int, count: int, batch: int, noise_dim: int):
    """Step ``count``'s (noise1, noise2, aux) of the stream ``seed``: three
    (batch, noise_dim) standard-normal blocks from a CPU generator seeded by
    ``SeedSequence((seed, count))``, the MM-GAN loop's published stream."""
    g = torch.Generator().manual_seed(
        int(np.random.SeedSequence((seed, count)).generate_state(1, np.uint64)[0]))
    return tuple(torch.randn(3, batch, noise_dim, generator=g))


# G1's aux input on the serving path (B = 1): the constant draw the service
# feeds it (the JAX package's ``jax.random.key(0)`` draw), part of the
# published eval forward rather than of the weights.
AUX_INPUT = np.array([[
    0.0761424974, -1.6157459, -1.68577242, 0.712689102, 1.14895165, 0.856830895,
    0.168348819, 0.863624394, 0.857699037, -0.230650306, 1.15995824, 0.642624676,
    -0.872872591, 0.49765113, 2.48894358, -1.99686706, 0.401625961, 0.604594886,
    1.64911008, -1.79315555, 0.497692078, -0.715039134, -0.0390294753, -0.914225817,
    1.24578238, -1.16261697, -0.455724031, 1.12790215, 1.20811868, 0.444236994,
    -0.920044959, 0.430882066, 1.05963874, -0.577415586, -0.134091884, 1.4820894,
    -1.04538238, -1.35984206, 2.46805239, -0.780823827, 1.32207394, -0.156967849,
    -1.29557621, 0.830003083, 1.47769904, 0.323430747, 1.08489454, -0.952686071,
    1.54648674, 1.61255479
]], dtype=np.float32)
