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

The kernel reads three small constants, built here in numpy and kept on the
device: the window, the FFT's twiddles (``fft_twiddles``) and the
filterbank's compact form (``compact_filterbank``).
"""

from __future__ import annotations

import ctypes
import os
import threading
from functools import lru_cache

import numpy as np
import torch

from gandes_tpu_torch.music.mel import (
    _hann_periodic,
    _mel_project,
    mel_filterbank,
    power_spectrogram,
)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "mel_power.cu")
N_FFT_MIN, N_FFT_MAX = 256, 8192  # powers of two the kernel takes


def mel_power_reference(wav, sr, n_fft=2048, hop_length=512, n_mels=128, fmin=20,
                        fmax=8300, htk=True, norm_slaney=False):
    """Plain PyTorch power mel: ``power_spectrogram`` + ``_mel_project``."""
    s = power_spectrogram(wav, n_fft=n_fft, hop_length=hop_length)
    return _mel_project(s, sr, n_fft, n_mels, fmin, fmax, htk, norm_slaney)


@lru_cache(maxsize=8)
def fft_twiddles(n_fft: int) -> np.ndarray:
    """(n_fft // 2, 2) float32: cos and sin of ``-2 pi k / n_fft``, k < n_fft/2,
    in float64 cast to f32. The kernel's n_fft/2-point FFT takes its twiddles
    at even k and the real-FFT post-processing at every k."""
    ang = -2.0 * np.pi * np.arange(n_fft // 2) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


@lru_cache(maxsize=32)
def compact_filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm_slaney):
    """``mel_filterbank`` as contiguous bands: ``(band, weights, n_bins)``.

    ``band`` is (3, n_mels) int32 — each row's first nonzero bin, its count
    of bins up to its last nonzero one, and its offset into ``weights``, the
    rows' bands packed one after another (f32). ``n_bins`` is the last
    nonzero column + 1: no higher bin reaches the output."""
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm_slaney)
    nz = fb != 0
    used = nz.any(axis=1)
    first = np.where(used, nz.argmax(axis=1), 0)
    last = np.where(used, fb.shape[1] - 1 - nz[:, ::-1].argmax(axis=1), -1)
    count = last - first + 1
    offset = np.concatenate([[0], np.cumsum(count)[:-1]])
    weights = np.concatenate([fb[m, first[m]:first[m] + count[m]] for m in range(n_mels)])
    band = np.stack([first, count, offset]).astype(np.int32)
    return band, weights.astype(np.float32), int(last.max()) + 1


class _Kernel:
    """The built library and the device constants it reads, made once."""

    def __init__(self):
        from gandes_tpu_torch.ops.build import build_cuda_lib

        self.lib, self.build_log = build_cuda_lib(_SRC, "libmel_power")
        p, i = ctypes.c_void_p, ctypes.c_int
        self.lib.mel_power_launch.argtypes = [p, ctypes.c_longlong, i, i, i, p, p, i, p, p,
                                              i, p, p]
        self.lib.mel_power_launch.restype = i
        self.lib.mel_power_error_string.argtypes = [i]
        self.lib.mel_power_error_string.restype = ctypes.c_char_p
        self._consts: dict = {}

    def tables(self, n_fft: int, device):
        """Window (n_fft) and twiddles (n_fft // 2, 2), on the device."""
        key = ("tables", n_fft, str(device))
        if key not in self._consts:
            self._consts[key] = (torch.from_numpy(_hann_periodic(n_fft)).to(device),
                                 torch.from_numpy(fft_twiddles(n_fft)).to(device))
        return self._consts[key]

    def filterbank(self, sr, n_fft, n_mels, fmin, fmax, htk, norm_slaney, device):
        """``compact_filterbank``'s band and weights on the device, and n_bins."""
        key = ("fb", sr, n_fft, n_mels, fmin, fmax, htk, norm_slaney, str(device))
        if key not in self._consts:
            band, weights, n_bins = compact_filterbank(sr, n_fft, n_mels, fmin, fmax, htk,
                                                       norm_slaney)
            self._consts[key] = (torch.from_numpy(band).to(device),
                                 torch.from_numpy(weights).to(device), n_bins)
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
    1-D contiguous float32 CUDA tensor and ``n_fft`` a power of two in
    [256, 8192]. Counts each launch in ``mel_power_cuda.launches``."""
    if not (isinstance(wav, torch.Tensor) and wav.is_cuda):
        raise ValueError("mel_power_cuda takes a CUDA tensor; a CPU tensor takes "
                         "mel_power_reference")
    if wav.dtype != torch.float32 or wav.dim() != 1 or not wav.is_contiguous():
        raise ValueError(f"mel_power_cuda takes a 1-D contiguous float32 wave, got "
                         f"{wav.dtype} {tuple(wav.shape)} contiguous={wav.is_contiguous()}")
    n = wav.shape[0]
    if (not N_FFT_MIN <= n_fft <= N_FFT_MAX or n_fft & (n_fft - 1) or n_fft // 2 >= n
            or hop_length < 1):
        raise ValueError(f"unsupported shape: n_fft={n_fft} (a power of two in "
                         f"[{N_FFT_MIN}, {N_FFT_MAX}]), len={n} (> n_fft/2), hop={hop_length}")
    k = kernel()
    n_frames = 1 + n // hop_length  # centered: (n + n_fft - n_fft) // hop + 1
    device = wav.device
    window, twiddles = k.tables(n_fft, device)
    band, weights, n_bins = k.filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm_slaney,
                                         device)
    out = torch.empty((n_mels, n_frames), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = k.lib.mel_power_launch(
            wav.data_ptr(), n, hop_length, n_frames, int(n_fft).bit_length() - 2,
            window.data_ptr(), twiddles.data_ptr(), n_bins, band.data_ptr(),
            weights.data_ptr(), n_mels, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("mel_power kernel launch failed: "
                           + k.lib.mel_power_error_string(err).decode())
    mel_power_cuda.launches += 1
    return out


mel_power_cuda.launches = 0
