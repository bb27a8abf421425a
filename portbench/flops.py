"""Operations and bytes of the work the cells do, counted from shapes, and the
card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W).

The counts are the least work of the function, not of the program's
algorithm: a later change to a kernel is read against the same work.
"""

from __future__ import annotations

import math

import numpy as np

F32_PEAK_FLOPS = 67e12        # float32 outside the tensor cores (the steps run without TF32)
HBM_BYTES_PER_S = 3.35e12


def linear(batch, n_in, n_out) -> float:
    return 2.0 * batch * n_in * n_out


def conv2d(batch, c_in, c_out, k, out_h, out_w) -> float:
    return 2.0 * batch * c_in * c_out * k * k * out_h * out_w


def conv_transpose2d(batch, c_in, c_out, k, in_h, in_w) -> float:
    return 2.0 * batch * c_in * c_out * k * k * in_h * in_w


def mmgan_generators(batch, noise_dim=50, beat_dim=50, side=64, out2=20, hidden=64) -> float:
    """G1 and G2 forward: four dense layers each."""
    total = 0.0
    for last in (side * side, out2):
        widths = (noise_dim + beat_dim, 4 * hidden, 2 * hidden, hidden, last)
        total += sum(linear(batch, a, b) for a, b in zip(widths[:-1], widths[1:]))
    return total


def mmgan_discriminator(batch, t=50, hidden=16) -> float:
    """D forward on (batch, 2, 128, t) rolls."""
    h1, w1 = 64, t // 2
    h2, w2 = 32, t // 4
    return (conv2d(batch, 2, hidden, 4, h1, w1) + conv2d(batch, hidden, 2 * hidden, 4, h2, w2)
            + linear(batch, 2 * hidden * h2 * w2, 1))


def mmgan_none_step(batch, t=50) -> float:
    """One ``g_update='none'`` step: G1 and G2 forward, D forward on the fakes
    and the reals with its weight gradients and, past the first convolution,
    its input gradients (twice the forward, less the first convolution's
    input gradient), then D forward on the fakes for G's loss."""
    fwd = mmgan_discriminator(2 * batch, t)
    first_conv = conv2d(2 * batch, 2, 16, 4, 64, t // 2)
    return (mmgan_generators(batch) + fwd + (2 * fwd - first_conv)
            + mmgan_discriminator(batch, t))


def dcgan_generator(batch, z=100, gen_dim=32) -> float:
    return (conv_transpose2d(batch, z, 4 * gen_dim, 4, 1, 1)
            + conv_transpose2d(batch, 4 * gen_dim, 2 * gen_dim, 4, 4, 4)
            + conv_transpose2d(batch, 2 * gen_dim, gen_dim, 4, 8, 8)
            + conv_transpose2d(batch, gen_dim, 1, 5, 16, 16))


def _htk_nonzeros(sr=44100, n_fft=2048, n_mels=128, fmin=20.0, fmax=8300.0) -> int:
    from portbench.reference.mel import htk_filterbank

    return int(np.count_nonzero(htk_filterbank(sr, n_fft, n_mels, fmin, fmax)))


def mel_work(n_bucket: int, n_fft=2048, n_mels=128, mel_length=216) -> tuple[float, float]:
    """(operations, bytes) of one GAN-DES mel over a ``n_bucket``-sample
    buffer: the arithmetic of ``chip_smoke.py::mel_bound_ms`` (per frame the
    window, a real FFT of ~2.5 n log2 n operations, the power and the
    filterbank's nonzeros; the wave samples the frames read, the
    filterbank's nonzeros and the output), frozen here."""
    hop = n_bucket // (mel_length - 1)
    n_samples = mel_length * hop
    n_frames = 1 + n_samples // hop
    fb_nonzeros = _htk_nonzeros(n_fft=n_fft, n_mels=n_mels)
    n_freqs = n_fft // 2 + 1
    per_frame = n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * n_freqs + 2 * fb_nonzeros
    samples = min(n_samples, n_frames * n_fft) if hop >= n_fft else n_samples
    nbytes = 4 * samples + 4 * fb_nonzeros + 4 * n_mels * n_frames
    return n_frames * per_frame, nbytes


def mel_bound_s(n_bucket: int) -> float:
    """Least time of one mel at the card's peaks."""
    ops, nbytes = mel_work(n_bucket)
    return max(ops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)
