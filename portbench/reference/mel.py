"""The GAN-DES mel stage in plain PyTorch, for the benchmark's plain reference:
a dynamic hop that gives 216 frames, a centred (reflect-padded) STFT with a
periodic Hann window, the power spectrum, an HTK mel filterbank without
normalisation, and power dB floored 80 dB under the maximum."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.models import operand


def htk_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """(n_mels, 1 + n_fft // 2) triangular HTK filters in float64."""
    hz_to_mel = lambda f: 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)
    mel_to_hz = lambda m: 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)
    freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(f_pts)
    ramps = f_pts[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    return np.maximum(0.0, np.minimum(lower, upper))


def mel_db(wave: torch.Tensor, sr=44100, n_fft=2048, n_mels=128, fmin=20.0, fmax=8300.0,
           top_db=80.0, mel_length=216) -> torch.Tensor:
    """(n_mels, 1 + mel_length) mel dB of a 1-D float wave, in its dtype."""
    hop = int(wave.shape[0]) // (mel_length - 1)
    wave = wave[:mel_length * hop]
    wave = F.pad(wave[None, None], (n_fft // 2, n_fft // 2), mode="reflect")[0, 0]
    n = torch.arange(n_fft, dtype=torch.float64, device=wave.device)
    window = (0.5 - 0.5 * torch.cos(2 * np.pi * n / n_fft)).to(wave.dtype)
    spec = torch.fft.rfft(wave.unfold(0, n_fft, hop) * window, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.from_numpy(htk_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(wave)
    mel = operand(fb) @ operand(power.T)
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    return torch.maximum(db, db.max() - top_db)
