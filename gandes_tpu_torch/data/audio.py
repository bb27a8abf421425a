"""WAV I/O and audio slicing (replaces the reference's torchaudio usage).

Copied from ``gandes_tpu/data/audio.py`` (numpy and scipy), with
``save_wav`` inside a ``wav`` span (``core/profiling.py``), plus the same
WAV file built on the audio's device (``wav_tensor``) and its base64 taken
there (``Base64Text``), so that a served clip crosses to the host once, as
the text of its reply.
``split_audio_data`` matches `GAN_DES/util.py:103-119`: 5 s window / 5 s
hop, the last window right-aligned so every slice has equal length.
"""

from __future__ import annotations

import struct
import threading

import numpy as np
import torch
from scipy.io import wavfile

from gandes_tpu_torch.core.profiling import span

_B64_ALPHABET = b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/"


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
    with span("wav"):
        w = np.asarray(waveform, dtype=np.float32)
        w = np.clip(w, -1.0, 1.0)
        wavfile.write(path, sr, (w * 32767.0).astype(np.int16))


def wav_header(n_samples: int, sr: int = 44100) -> bytes:
    """The 44 bytes that ``save_wav`` writes before ``n_samples`` mono 16-bit
    samples: the RIFF header, the PCM ``fmt `` chunk and the ``data`` chunk's
    header."""
    size = 2 * n_samples
    return (b"RIFF" + struct.pack("<I", 36 + size) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, sr, 2 * sr, 2, 16)
            + b"data" + struct.pack("<I", size))


def wav_tensor(waveform: torch.Tensor, sr: int = 44100) -> torch.Tensor:
    """The bytes of the file that ``save_wav`` writes for the float
    ``waveform``, as a uint8 tensor on its device: the same clip, scale and
    cast toward zero, taken there."""
    samples = (torch.clamp(waveform, -1.0, 1.0) * 32767.0).to(torch.int16)
    header = torch.frombuffer(bytearray(wav_header(samples.numel(), sr)), dtype=torch.uint8)
    return torch.cat([header.to(samples.device), samples.view(torch.uint8)])


class Base64Text:
    """The base64 text of uint8 tensors, encoded on their device: only the
    text crosses to the host, through a pinned buffer that the object keeps
    and grows to the longest text so far."""

    def __init__(self):
        self._alphabets: dict = {}
        self._host = None
        self._lock = threading.Lock()

    def __call__(self, data: torch.Tensor) -> str:
        """``base64.b64encode(bytes(data)).decode()``."""
        pad = -data.numel() % 3
        x = torch.cat([data, data.new_zeros(pad)]).view(-1, 3).to(torch.int32)
        v = (x[:, 0] << 16) | (x[:, 1] << 8) | x[:, 2]
        digits = torch.stack([v >> 18, (v >> 12) & 63, (v >> 6) & 63, v & 63], dim=1).view(-1)
        text = self._alphabet(data.device)[digits]
        if pad:
            text[-pad:] = ord("=")
        if text.device.type == "cpu":
            return str(memoryview(text.numpy()), "ascii")
        with self._lock:
            n = text.numel()
            if self._host is None or self._host.numel() < n:
                self._host = torch.empty(1 << max(0, n - 1).bit_length(), dtype=torch.uint8,
                                         pin_memory=True)
            host = self._host[:n]
            host.copy_(text)
            return str(memoryview(host.numpy()), "ascii")

    def _alphabet(self, device) -> torch.Tensor:
        table = self._alphabets.get(device)
        if table is None:
            table = self._alphabets[device] = torch.frombuffer(
                bytearray(_B64_ALPHABET), dtype=torch.uint8).to(device)
        return table


def split_audio_data(wav_file_path, hop_length_audio=5, window_size=5):
    """5 s slicer; last slice right-aligned (`GAN_DES/util.py:103-119`)."""
    waveform, sample_rate = load_wav(wav_file_path, normalize=True, mono=True)
    split_wvs = []
    for i in np.arange(0, len(waveform) + 1, hop_length_audio * sample_rate):
        if i + hop_length_audio * sample_rate > len(waveform):
            split_wvs.append(waveform[-window_size * sample_rate:])
        else:
            split_wvs.append(waveform[int(i):int(i) + window_size * sample_rate])
    return split_wvs


def play_wav(path: str, block: bool = True, timeout_s: float = 300.0) -> bool:
    """Play a WAV through the best available backend; returns True if audio
    actually played (or was handed to a player).

    Mirrors the reference demo's pygame playback (`demo.ipynb` cells
    25-28): pygame.mixer first, then the system players (aplay/paplay/
    afplay). Headless boxes without an audio device return False instead
    of raising, so demo --play degrades gracefully.
    """
    import os as _os

    _os.environ.setdefault("PYGAME_HIDE_SUPPORT_PROMPT", "1")
    try:
        import pygame

        pygame.mixer.init()
        try:
            pygame.mixer.music.load(path)
            pygame.mixer.music.play()
            if block:
                import time

                t0 = time.time()
                while (pygame.mixer.music.get_busy()
                       and time.time() - t0 < timeout_s):
                    time.sleep(0.1)
            return True
        finally:
            if block:  # non-blocking playback must keep the mixer alive
                pygame.mixer.quit()
    except Exception:
        pass
    import shutil
    import subprocess

    for player in ("aplay", "paplay", "afplay"):
        exe = shutil.which(player)
        if exe:
            try:
                if block:
                    subprocess.run([exe, path], check=True, timeout=timeout_s,
                                   stdout=subprocess.DEVNULL,
                                   stderr=subprocess.DEVNULL)
                else:
                    # honor the non-blocking contract on the CLI-player
                    # fallback too: fire and return (the player exits on
                    # its own at end of file)
                    subprocess.Popen([exe, path],
                                     stdout=subprocess.DEVNULL,
                                     stderr=subprocess.DEVNULL)
                return True
            except Exception:
                continue
    return False
