"""WAV I/O and audio slicing (replaces the reference's torchaudio usage).

Copied from ``gandes_tpu/data/audio.py`` (numpy and scipy only).
``split_audio_data`` matches `GAN_DES/util.py:103-119`: 5 s window / 5 s
hop, the last window right-aligned so every slice has equal length.
"""

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
