"""Mel spectrograms in PyTorch (librosa- and torchaudio-compatible variants).

Port of ``gandes_tpu/music/mel.py``, which re-implements the reference's
feature extractors (`GAN_DES/util.py:7-61`) without librosa/torchaudio:

* ``melspectrogram_db`` — librosa semantics: centered reflect-padded STFT
  (hann, periodic), power spectrum, *slaney*-scale mel filterbank with
  slaney area normalization, ``power_to_db(ref=1.0, top_db)``.
* ``melspectrogram_db_tensor`` — torchaudio semantics: *htk* mel scale,
  no filter normalization, ``AmplitudeToDB(stype='power', top_db)`` whose
  floor is relative to the global max; dynamic hop
  ``len(wav) // (mel_length - 1)`` with the wave cropped to
  ``mel_length * hop`` (reference :40-44 — forcing a fixed frame count).
* ``melspectrogram_db_ref_max`` / ``melspectrogram_db_from_file`` — the
  ``_from_file`` variant's ``power_to_db(ref=max)``;
  ``melspectrogram_power_tensor`` — the ``_maestro`` variant, which returns
  the *power* mel; ``melspectrogram_db_tensor_from_file``.

The centre padding reflects again and again where the wave is shorter than
n_fft / 2, as ``jnp.pad(mode="reflect")`` does.
The filterbank and window are built in numpy (float64, cast to float32).
Every power mel goes through ``_mel_power_backend``: a CUDA tensor runs the
hand-written kernel (``ops/mel_power.py``), a CPU tensor its plain version.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_AMIN = 1e-10


# ------------------------------------------------------------- filterbanks


def _hz_to_mel(f, htk: bool):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mels)


def _mel_to_hz(m, htk: bool):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@lru_cache(maxsize=32)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
                   htk: bool, norm_slaney: bool) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) triangular filterbank.

    htk=False + norm_slaney=True == librosa defaults;
    htk=True + norm_slaney=False == torchaudio MelSpectrogram defaults.
    """
    n_freqs = 1 + n_fft // 2
    all_freqs = np.linspace(0, sr / 2, n_freqs)
    m_min, m_max = _hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz(m_pts, htk)

    fdiff = np.diff(f_pts)
    ramps = f_pts.reshape(-1, 1) - all_freqs.reshape(1, -1)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    fb = np.maximum(0.0, np.minimum(lower, upper))
    if norm_slaney:
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb *= enorm.reshape(-1, 1)
    return fb.astype(np.float32)


# ------------------------------------------------------------------- STFT


def _hann_periodic(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)


def _as_wave(wav) -> torch.Tensor:
    """1-D float32 tensor; numpy input lands on the CPU."""
    return torch.as_tensor(wav, dtype=torch.float32)


def reflect_pad(wav: torch.Tensor, pad: int) -> torch.Tensor:
    """``wav`` centre-padded by ``pad`` samples at each end as
    ``np.pad(mode="reflect")`` (and ``jnp.pad``) pads it, for any ``pad``:
    the reflection repeats, so a position folds into [0, n - 1] with period
    2 (n - 1) (a one-sample wave repeats its sample). The edges are gathered
    through that fold, the wave itself copied between them."""
    n = int(wav.shape[0])
    if n < 1:
        raise ValueError("Cannot apply 'reflect' padding to empty axis")

    def edge(lo, hi):
        idx = torch.arange(lo, hi, device=wav.device)
        if n == 1:
            return wav[torch.zeros_like(idx)]
        idx = torch.remainder(idx, 2 * (n - 1))
        return wav[torch.where(idx >= n, 2 * (n - 1) - idx, idx)]

    return torch.cat([edge(-pad, 0), wav, edge(n, n + pad)])


def power_spectrogram(wav, n_fft: int = 2048, hop_length: int = 512, center: bool = True):
    """|STFT|^2 with hann window; (1 + n_fft//2, n_frames).

    ``unfold`` frames both hop < n_fft (overlapping) and hop >= n_fft
    (the dynamic-hop long-audio case) as strided views. A wave of at most
    n_fft / 2 samples is padded by repeated reflection, as the JAX
    package's ``jnp.pad`` pads it."""
    wav = _as_wave(wav)
    if center:
        wav = reflect_pad(wav, n_fft // 2)
    window = torch.from_numpy(_hann_periodic(n_fft)).to(wav.device)
    frames = wav.unfold(0, n_fft, hop_length) * window
    spec = torch.fft.rfft(frames, dim=-1)
    return (spec.real**2 + spec.imag**2).T


def _mel_project(power_spec, sr, n_fft, n_mels, fmin, fmax, htk, norm_slaney):
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm_slaney))
    return fb.to(power_spec.device) @ power_spec


def _mel_power_backend(waveform, sr, n_fft, hop_length, n_mels, fmin, fmax,
                       htk, norm_slaney):
    """Power mel (n_mels, n_frames): the CUDA kernel for a CUDA tensor, the
    plain PyTorch version for a CPU tensor. A kernel failure raises."""
    from gandes_tpu_torch.ops.mel_power import mel_power_cuda, mel_power_reference

    waveform = _as_wave(waveform)
    fn = mel_power_cuda if waveform.is_cuda else mel_power_reference
    return fn(waveform, sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels,
              fmin=fmin, fmax=fmax, htk=htk, norm_slaney=norm_slaney)


# -------------------------------------------------------- librosa variants


def melspectrogram(wav, sr, n_fft=2048, hop_length=512, n_mels=128, fmin=20, fmax=8300):
    return _mel_power_backend(wav, sr, n_fft, hop_length, n_mels, fmin, fmax,
                              htk=False, norm_slaney=True)


def power_to_db(S, ref=1.0, amin=_AMIN, top_db=80.0):
    """librosa.power_to_db semantics (ref scalar or 'max')."""
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    if isinstance(ref, str) and ref == "max":
        ref_value = S.max()
    else:
        ref_value = torch.tensor(ref, dtype=S.dtype, device=S.device)
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref_value, min=amin))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def melspectrogram_db(wav, sr, n_fft=2048, hop_length=512, n_mels=128, fmin=20,
                      fmax=8300, top_db=80):
    """== reference ``get_melspectrogram_db`` (util.py:7-25)."""
    return power_to_db(melspectrogram(wav, sr, n_fft, hop_length, n_mels, fmin, fmax),
                       top_db=top_db)


def melspectrogram_db_ref_max(wav, sr=44100, n_fft=2048, hop_length=512, n_mels=128,
                              fmin=20, fmax=8300, top_db=80):
    """== reference ``get_melspectrogram_db_from_file`` body (util.py:28-34):
    ``power_to_db(ref=max)``; the reference passes no top_db there, so the
    default 80 applies."""
    return power_to_db(melspectrogram(wav, sr, n_fft, hop_length, n_mels, fmin, fmax),
                       ref="max", top_db=top_db)


def _load_mono(file_path, device) -> tuple[torch.Tensor, int]:
    from gandes_tpu_torch.data.audio import load_wav

    wav, sr = load_wav(file_path, normalize=True, mono=True)
    return torch.from_numpy(np.ascontiguousarray(wav, dtype=np.float32)).to(device), sr


def melspectrogram_db_from_file(file_path, sr=44100, n_fft=2048, hop_length=512,
                                n_mels=128, fmin=20, fmax=8300, top_db=80, device="cuda"):
    """== reference ``get_melspectrogram_db_from_file`` (util.py:28-34):
    load mono at ``sr``, slaney mel, ``power_to_db(ref=max)``, on
    ``device``. The reference accepts ``top_db`` and never passes it on, so
    librosa's default 80 always applies. A file at another rate is
    resampled polyphase, as the JAX package does (librosa.load uses soxr:
    the same function, not the same bits)."""
    del top_db  # accepted but unused, like the reference
    wav, file_sr = _load_mono(file_path, "cpu")
    if sr is not None and file_sr != sr:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(int(sr), int(file_sr))
        wav = torch.from_numpy(
            resample_poly(wav.numpy(), int(sr) // g, int(file_sr) // g).astype(np.float32))
    return melspectrogram_db_ref_max(wav.to(device), sr or file_sr, n_fft, hop_length,
                                     n_mels, fmin, fmax)


# ------------------------------------------------------ torchaudio variants


def amplitude_to_db_torch(S, top_db=80.0):
    """torchaudio AmplitudeToDB(stype='power'): 10log10(clamp(S, 1e-10)),
    floored at global max - top_db."""
    db = 10.0 * torch.log10(torch.clamp(S, min=_AMIN))
    if top_db is not None:
        db = torch.maximum(db, db.max() - top_db)
    return db


def melspectrogram_db_tensor(waveform, sr=44100, n_fft=2048, hop_length=512,
                             n_mels=128, fmin=20, fmax=8300, top_db=80,
                             mel_length=216):
    """== reference ``get_melspectrogram_db_tensor`` (util.py:37-61):
    dynamic hop forcing ~mel_length frames, htk mel, power dB. The mel is
    taken on the waveform's device. ``hop_length`` is accepted for the
    reference signature and replaced by the dynamic hop, as there. It opens
    no span: the pipeline's callers open ``mel`` around it
    (``bridge/gandes_decode.py``, ``data/datasets.py``, ``demo.py``), so that
    a profiler range opened around this function stays the innermost one."""
    waveform = _as_wave(waveform)
    hop_length = int(waveform.shape[0]) // (mel_length - 1)
    new_audio_length = mel_length * hop_length
    waveform = waveform[:new_audio_length]
    mel = _mel_power_backend(waveform, sr, n_fft, hop_length, n_mels, fmin, fmax,
                             True, False)
    return amplitude_to_db_torch(mel, top_db=top_db)


def melspectrogram_power_tensor(waveform, sr=44100, n_fft=2048, hop_length=512,
                                n_mels=128, fmin=20, fmax=8300, top_db=80,
                                mel_length=216):
    """== reference ``get_melspectrogram_db_tensor_maestro`` (util.py:63-87),
    whose quirk is kept: it takes the dB transform and returns the *power*
    mel, so the dB result (and ``top_db``) goes unused and is not computed
    here, as in the JAX package."""
    waveform = _as_wave(waveform)
    hop_length = int(waveform.shape[0]) // (mel_length - 1)
    waveform = waveform[:mel_length * hop_length]
    return _mel_power_backend(waveform, sr, n_fft, hop_length, n_mels, fmin, fmax,
                              True, False)


def melspectrogram_db_tensor_from_file(file_path, device="cuda"):
    """== reference ``get_melspectrogram_db_tensor_from_file`` (util.py:89-100):
    load, mono mean, dynamic-hop torchaudio-style mel dB on ``device``."""
    waveform, sample_rate = _load_mono(file_path, device)
    return melspectrogram_db_tensor(waveform, sample_rate)
