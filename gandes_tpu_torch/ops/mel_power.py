"""K2, the fused mel power kernel, and its plain PyTorch version.

``mel_power_cuda`` launches the hand-written CUDA kernel
(``csrc/mel_power.cu``; it replaces ``gandes_tpu/ops/pallas_mel.py``'s
Pallas kernel) on a CUDA tensor and raises on anything else: the kernel is
never emulated. ``mel_power_reference`` is the plain version — reflect pad,
``unfold`` frames, hann window, ``torch.fft.rfft``, ``|.|^2``, ``fb @ power``
— which the CPU tests run and against which the kernel is held on the card.
``music/mel.py::_mel_power_backend`` picks one by the tensor's device.

Both return the power mel ``(n_mels, n_frames)`` float32 of the centered
(reflect-padded) STFT with ``n_frames = 1 + len(wav) // hop_length``.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from gandes_tpu_torch.music.mel import (
    _hann_periodic,
    _mel_project,
    mel_filterbank,
    power_spectrogram,
)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "mel_power.cu")


def mel_power_reference(wav, sr, n_fft=2048, hop_length=512, n_mels=128, fmin=20,
                        fmax=8300, htk=True, norm_slaney=False):
    """Plain PyTorch power mel: ``power_spectrogram`` + ``_mel_project``."""
    s = power_spectrogram(wav, n_fft=n_fft, hop_length=hop_length)
    return _mel_project(s, sr, n_fft, n_mels, fmin, fmax, htk, norm_slaney)


class _Kernel:
    """The built library and the device constants it reads, made once."""

    def __init__(self):
        from gandes_tpu_torch.ops.build import build_cuda_lib

        self.lib, self.build_log = build_cuda_lib(_SRC, "libmel_power")
        p, i = ctypes.c_void_p, ctypes.c_int
        self.lib.mel_power_launch.argtypes = [p, ctypes.c_longlong, i, i, i, i, p, p, i, p,
                                              i, p, p, p]
        self.lib.mel_power_launch.restype = i
        self.lib.mel_power_error_string.argtypes = [i]
        self.lib.mel_power_error_string.restype = ctypes.c_char_p
        self.lib.mel_power_tile_constants.argtypes = [i]
        self.lib.mel_power_tile_constants.restype = i
        self.k_step = self.lib.mel_power_tile_constants(0)
        self.freq_tile = self.lib.mel_power_tile_constants(1)
        self._consts: dict = {}

    def n_freqs_padded(self, n_fft: int) -> int:
        return -(-(n_fft // 2 + 1) // self.freq_tile) * self.freq_tile

    def bases(self, n_fft: int, device):
        """Hann-windowed cos/-sin DFT bases (n_fft, n_freqs_padded), built in
        float64 and cast to f32 (as ``pallas_mel._bases``), zero past the
        real bins, kept on the device."""
        key = ("bases", n_fft, str(device))
        if key not in self._consts:
            n_freqs = n_fft // 2 + 1
            t = np.arange(n_fft)[:, None]
            k = np.arange(n_freqs)[None, :]
            ang = 2.0 * np.pi * t * k / n_fft
            win = _hann_periodic(n_fft)[:, None]
            cos = np.zeros((n_fft, self.n_freqs_padded(n_fft)), np.float32)
            sin = np.zeros_like(cos)
            cos[:, :n_freqs] = (np.cos(ang) * win).astype(np.float32)
            sin[:, :n_freqs] = (-np.sin(ang) * win).astype(np.float32)
            self._consts[key] = (torch.from_numpy(cos).to(device),
                                 torch.from_numpy(sin).to(device))
        return self._consts[key]

    def filterbank_t(self, sr, n_fft, n_mels, fmin, fmax, htk, norm_slaney, device):
        """(n_freqs_padded, n_mels) transposed filterbank, zero past the real
        bins, kept on the device."""
        key = ("fb", sr, n_fft, n_mels, fmin, fmax, htk, norm_slaney, str(device))
        if key not in self._consts:
            fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm_slaney)
            fb_t = np.zeros((self.n_freqs_padded(n_fft), n_mels), np.float32)
            fb_t[: fb.shape[1]] = fb.T
            self._consts[key] = torch.from_numpy(fb_t).to(device)
        return self._consts[key]


_KERNEL: _Kernel | None = None
_KERNEL_LOCK = threading.Lock()


def kernel() -> _Kernel:
    """The built kernel; the first call compiles ``csrc/mel_power.cu``."""
    global _KERNEL
    with _KERNEL_LOCK:
        if _KERNEL is None:
            _KERNEL = _Kernel()
        return _KERNEL


def mel_power_cuda(wav: torch.Tensor, sr, n_fft=2048, hop_length=512, n_mels=128,
                   fmin=20, fmax=8300, htk=True, norm_slaney=False):
    """Power mel (n_mels, n_frames) from the CUDA kernel; ``wav`` must be a
    1-D contiguous float32 CUDA tensor. Counts each launch in
    ``mel_power_cuda.launches``."""
    if not (isinstance(wav, torch.Tensor) and wav.is_cuda):
        raise ValueError("mel_power_cuda takes a CUDA tensor; a CPU tensor takes "
                         "mel_power_reference")
    if wav.dtype != torch.float32 or wav.dim() != 1 or not wav.is_contiguous():
        raise ValueError(f"mel_power_cuda takes a 1-D contiguous float32 wave, got "
                         f"{wav.dtype} {tuple(wav.shape)} contiguous={wav.is_contiguous()}")
    k = kernel()
    n = wav.shape[0]
    pad = n_fft // 2
    if n_fft % k.k_step or pad >= n or hop_length < 1:
        raise ValueError(f"unsupported shape: n_fft={n_fft} (multiple of {k.k_step}), "
                         f"len={n} (> n_fft/2), hop={hop_length}")
    n_frames = 1 + n // hop_length  # centered: (n + 2*pad - n_fft) // hop + 1
    device = wav.device
    cos, sin = k.bases(n_fft, device)
    fb_t = k.filterbank_t(sr, n_fft, n_mels, fmin, fmax, htk, norm_slaney, device)
    n_pad = cos.shape[1]
    partial = torch.empty((n_pad // k.freq_tile, n_frames, n_mels), dtype=torch.float32,
                          device=device)
    out = torch.empty((n_mels, n_frames), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = k.lib.mel_power_launch(
            wav.data_ptr(), n, pad, hop_length, n_frames, n_fft, cos.data_ptr(),
            sin.data_ptr(), n_pad, fb_t.data_ptr(), n_mels, partial.data_ptr(),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("mel_power kernel launch failed: "
                           + k.lib.mel_power_error_string(err).decode())
    mel_power_cuda.launches += 1
    return out


mel_power_cuda.launches = 0
