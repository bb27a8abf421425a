"""WAV I/O (replaces the reference's torchaudio file handling)."""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def load_wav(path: str, normalize: bool = True, mono: bool = True):
    """Returns (waveform float32 [-1,1] if normalize, sample_rate).
    Stereo is averaged to mono (torchaudio ``.mean(dim=0)`` parity)."""
    sr, data = wavfile.read(path)
    data = np.asarray(data)
    if normalize:
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            data = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32)
    if mono and data.ndim == 2:
        data = data.mean(axis=1)
    return data, sr


def save_wav(path: str, waveform, sr: int = 44100):
    """float waveform in [-1,1] -> 16-bit PCM WAV."""
    w = np.asarray(waveform, dtype=np.float32)
    w = np.clip(w, -1.0, 1.0)
    wavfile.write(path, sr, (w * 32767.0).astype(np.int16))
