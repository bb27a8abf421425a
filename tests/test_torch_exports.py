"""Every name the JAX package's ``music``, ``data``, ``models``, ``train``
and ``bridge`` packages export resolves in gandes_tpu_torch, or is listed in
``NOT_PORTED`` with its reason; and the reference helpers of those packages
(the ``_from_file`` / ``_maestro`` mels, ``split_audio_data``, ``play_wav``,
``get_noise``) against the JAX functions on the same WAVs — the
counterparts of ``tests/test_audio_stack.py``'s cases. Mels: 0.05 dB, the
mel tests' tolerance; powers rtol 2e-3 / atol 1e-4.
"""

import importlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from gandes_tpu.data import audio as jax_audio
from gandes_tpu.music import mel as jax_mel
from gandes_tpu_torch.data import audio
from gandes_tpu_torch.music import mel

SR = 44100
DB_ATOL = 0.05
RTOL, ATOL = 2e-3, 1e-4
CPU = "cpu"

PACKAGES = ["music", "data", "models", "train", "bridge"]

# names of the JAX packages with no counterpart under the same name here
NOT_PORTED = {
    ("music", "rasterize_events_jax"):
        "the jnp/Pallas rasterizer; the port's is music.piano_roll.rasterize_events "
        "(kernel K1 on a CUDA tensor), exported under that name",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exported(pkg) -> list:
    """``__all__``, else the public non-module names the package binds."""
    mod = importlib.import_module(f"gandes_tpu.{pkg}")
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and not isinstance(v, types.ModuleType))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_jax_export_resolves_in_the_port(pkg):
    names = _exported(pkg)
    assert names, pkg
    port = importlib.import_module(f"gandes_tpu_torch.{pkg}")
    missing = [n for n in names if (pkg, n) not in NOT_PORTED and not hasattr(port, n)]
    assert not missing, f"gandes_tpu_torch.{pkg} lacks {missing}"
    for (p, n), reason in NOT_PORTED.items():
        if p == pkg:
            assert n in names and reason


def test_music_exports_are_lazy():
    """As in the JAX package (PEP 562): importing the package loads none of
    its modules; a name loads its module on first use."""
    code = ("import sys, gandes_tpu_torch.music as m\n"
            "assert 'gandes_tpu_torch.music.mel' not in sys.modules\n"
            "assert m.melspectrogram_db_tensor.__module__ == 'gandes_tpu_torch.music.mel'\n"
            "assert sorted(m.__all__) == m.__all__ and len(m.__all__) == 27\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == "ok", out.stderr
    from gandes_tpu_torch import music

    with pytest.raises(AttributeError):
        music.rasterize_events_jax


def _tone(seconds, f=440.0, amp=0.5, sr=SR):
    return (amp * np.sin(2 * np.pi * f * np.arange(int(seconds * sr)) / sr)).astype(np.float32)


def test_split_audio_data_matches_jax(tmp_path):
    w = np.random.RandomState(0).randn(int(12.5 * SR)).astype(np.float32) * 0.1
    p = str(tmp_path / "long.wav")
    audio.save_wav(p, w, SR)
    ours, ref = audio.split_audio_data(p), jax_audio.split_audio_data(p)
    assert len(ours) == len(ref) == 3  # 0-5, 5-10, the last right-aligned
    for a, b in zip(ours, ref):
        assert len(a) == 5 * SR
        np.testing.assert_array_equal(a, b)


def test_power_spectrogram_matches_numpy_and_jax():
    """The plain STFT against an independent numpy version and the JAX
    package's (n_fft 512, hop 128)."""
    wav = np.random.RandomState(1).randn(8000).astype(np.float32)
    n_fft, hop = 512, 128
    ours = mel.power_spectrogram(torch.from_numpy(wav), n_fft=n_fft, hop_length=hop).numpy()
    padded = np.pad(wav, (n_fft // 2, n_fft // 2), mode="reflect")
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    ref = np.stack([np.abs(np.fft.rfft(padded[i * hop:i * hop + n_fft] * win)) ** 2
                    for i in range(1 + len(wav) // hop)]).T
    assert ours.shape == ref.shape == (n_fft // 2 + 1, 1 + len(wav) // hop)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        ours, np.asarray(jax_mel.power_spectrogram(wav, n_fft=n_fft, hop_length=hop)),
        rtol=RTOL, atol=ATOL * float(ref.max()))


def test_mel_tone_lands_in_its_bin():
    wav = _tone(5.0, f=1000.0, amp=1.0)
    db = mel.melspectrogram_db_tensor(torch.from_numpy(wav), sr=SR).numpy()
    assert db.shape == (128, 216)
    fb = mel.mel_filterbank(SR, 2048, 128, 20, 8300, True, False)
    expected = np.argmax(fb[:, np.argmin(np.abs(np.linspace(0, SR / 2, 1025) - 1000.0))])
    assert abs(int(np.argmax(db.mean(axis=1))) - int(expected)) <= 1


def test_mel_variants_match_jax():
    wav = _tone(1.0)
    db = mel.melspectrogram_db_tensor(torch.from_numpy(wav), sr=SR).numpy()
    power = mel.melspectrogram_power_tensor(torch.from_numpy(wav), sr=SR).numpy()
    np.testing.assert_allclose(
        power, np.asarray(jax_mel.melspectrogram_power_tensor(wav, sr=SR, use_pallas=False)),
        rtol=RTOL, atol=ATOL * float(power.max()))
    # the _maestro variant returns the power mel, not dB (util.py:87 quirk)
    assert power.min() >= 0.0 and power.shape == db.shape == (128, 216)
    assert db.max() - db.min() <= 80.0 + 1e-3
    np.testing.assert_allclose(
        db, np.asarray(jax_mel.melspectrogram_db_tensor(wav, sr=SR, use_pallas=False)),
        atol=DB_ATOL)


def test_melspectrogram_db_ref_max_matches_jax():
    wav = _tone(2.0, f=660.0) + 0.05 * np.random.RandomState(1).randn(2 * SR).astype(np.float32)
    ours = mel.melspectrogram_db_ref_max(wav, SR).numpy()
    ref = np.asarray(jax_mel.melspectrogram_db_ref_max(wav, SR))
    assert ours.shape == ref.shape and ours.max() <= 1e-6  # ref = max dB
    np.testing.assert_allclose(ours, ref, atol=DB_ATOL)


def test_melspectrogram_db_from_file_matches_jax(tmp_path):
    """At the file's rate and through the polyphase resampling branch (a
    22,050 Hz file asked for at 44,100 Hz)."""
    wav = _tone(2.0)
    p, p22 = str(tmp_path / "tone.wav"), str(tmp_path / "t22.wav")
    audio.save_wav(p, wav, SR)
    audio.save_wav(p22, wav[::2], 22050)
    for path in (p, p22):
        ours = mel.melspectrogram_db_from_file(path, sr=SR, device=CPU).numpy()
        ref = np.asarray(jax_mel.melspectrogram_db_from_file(path, sr=SR))
        assert ours.shape == ref.shape and ours.shape[0] == 128
        np.testing.assert_allclose(ours, ref, atol=DB_ATOL)
    loaded, _ = audio.load_wav(p)
    np.testing.assert_array_equal(mel.melspectrogram_db_from_file(p, device=CPU).numpy(),
                                  mel.melspectrogram_db_ref_max(loaded, SR).numpy())


def test_melspectrogram_db_tensor_from_file_matches_jax(tmp_path):
    """A stereo file: both packages average the channels."""
    left, right = _tone(1.5, f=440.0), _tone(1.5, f=880.0, amp=0.3)
    p = str(tmp_path / "stereo.wav")
    audio.save_wav(p, np.stack([left, right], axis=1), SR)
    ours = mel.melspectrogram_db_tensor_from_file(p, device=CPU)
    ref = np.asarray(jax_mel.melspectrogram_db_tensor_from_file(p))
    assert ours.device.type == "cpu" and tuple(ours.shape) == ref.shape == (128, 216)
    np.testing.assert_allclose(ours.numpy(), ref, atol=DB_ATOL)


def test_play_wav_headless(tmp_path, monkeypatch):
    """``--play`` degrades gracefully: pygame with a (dummy) device plays,
    and no device returns False (or True where a system player exists)
    instead of raising, as the JAX function does."""
    p = str(tmp_path / "t.wav")
    audio.save_wav(p, np.sin(np.linspace(0, 880 * 3.14, 2205)).astype(np.float32))
    monkeypatch.setenv("SDL_AUDIODRIVER", "dummy")
    assert audio.play_wav(p) is True
    monkeypatch.setenv("SDL_AUDIODRIVER", "nonexistent-driver")
    import pygame

    pygame.mixer.quit()
    assert audio.play_wav(p) in (True, False)


def test_get_noise_is_a_seeded_torch_stream():
    from gandes_tpu_torch.models import get_noise

    a = get_noise(torch.Generator().manual_seed(3), 4, 50)
    b = get_noise(torch.Generator().manual_seed(3), 4, 50, device=CPU)
    assert a.shape == (4, 50) and a.dtype == torch.float32 and torch.equal(a, b)
    assert not torch.equal(a, get_noise(torch.Generator().manual_seed(4), 4, 50))
