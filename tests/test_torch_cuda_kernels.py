"""gandes_tpu_torch's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file imports
neither JAX nor gandes_tpu, so it runs on a machine that has only the port's
dependencies, without the suite's conftest (which configures JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from gandes_tpu_torch.music.mel import amplitude_to_db_torch, melspectrogram_db_tensor
from gandes_tpu_torch.music.piano_roll import rasterize_events
from gandes_tpu_torch.ops.mel_power import mel_power_cuda, mel_power_reference
from gandes_tpu_torch.ops.roll_rasterize import rasterize_cuda, rasterize_events_reference

SR = 44100

# (hop, n, htk, norm_slaney): fixed hops, the blank clip's slaney variant,
# and the serve path's dynamic hop len // 215 at pow2 buckets
CASES = [(512, 44100, True, False), (1025, 5 * 44100, True, False),
         (220, 44100, True, False), (512, 5 * 44100, False, True)]
CASES += [((1 << p) // 215, 1 << p, True, False) for p in (18, 20, 23)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _wave(n, device, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    w = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.randn(n)).astype(np.float32)
    return torch.from_numpy(w).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("hop,n,htk,norm_slaney", CASES)
def test_mel_power_cuda_matches_plain(cuda, hop, n, htk, norm_slaney):
    wav = _wave(n, cuda)
    kw = dict(hop_length=hop, htk=htk, norm_slaney=norm_slaney)
    launches = mel_power_cuda.launches
    out = mel_power_cuda(wav, SR, **kw)
    ref = mel_power_reference(wav, SR, **kw)
    torch.cuda.synchronize()
    assert mel_power_cuda.launches == launches + 1
    assert out.shape == ref.shape == (128, 1 + n // hop)
    torch.testing.assert_close(out, ref, rtol=2e-3, atol=1e-4)
    torch.testing.assert_close(amplitude_to_db_torch(out), amplitude_to_db_torch(ref),
                               rtol=0, atol=0.05)


@pytest.mark.cuda
def test_mel_db_tensor_dispatches_to_the_kernel(cuda):
    wav = _wave(1 << 18, cuda, seed=1)
    launches = mel_power_cuda.launches
    on_card = melspectrogram_db_tensor(wav)
    assert mel_power_cuda.launches == launches + 1
    plain = melspectrogram_db_tensor(wav.cpu())
    assert on_card.shape == plain.shape == (128, 216)
    torch.testing.assert_close(on_card.cpu(), plain, rtol=0, atol=0.05)


@pytest.mark.cuda
def test_mel_power_cuda_refuses_what_the_kernel_does_not_take(cuda):
    wav = _wave(SR, cuda)
    with pytest.raises(ValueError):
        mel_power_cuda(wav.double(), SR)
    with pytest.raises(ValueError):
        mel_power_cuda(wav[::2], SR)
    with pytest.raises(ValueError):
        mel_power_cuda(wav[:512], SR)  # shorter than the reflect pad
    launches = mel_power_cuda.launches
    for n_fft in (2016, 128, 16384):  # not a power of two; outside [256, 8192]
        with pytest.raises(ValueError):
            mel_power_cuda(wav, SR, n_fft=n_fft)
    assert mel_power_cuda.launches == launches


# (n_fft, hop, n, fmax): every FFT length's pass structure (odd and even
# log2 of n_fft / 2), the 64 KB shared-memory transform at 8192, and the
# Nyquist bin (fmax = sr / 2 uses bin n_fft / 2)
FFT_CASES = [(256, 128, SR, 8300), (512, 700, SR, 8300), (1024, 256, SR, 8300),
             (4096, 1500, 2 * SR, 8300), (8192, 2000, 2 * SR, 8300), (2048, 300, SR, SR / 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,n,fmax", FFT_CASES)
def test_mel_power_cuda_fft_lengths_match_plain(cuda, n_fft, hop, n, fmax):
    wav = _wave(n, cuda, seed=2)
    kw = dict(n_fft=n_fft, hop_length=hop, fmax=fmax)
    launches = mel_power_cuda.launches
    out = mel_power_cuda(wav, SR, **kw)
    assert mel_power_cuda.launches == launches + 1
    ref = mel_power_reference(wav, SR, **kw)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (128, 1 + n // hop)
    torch.testing.assert_close(out, ref, rtol=2e-3, atol=1e-4)


@pytest.mark.cuda
def test_mel_power_cuda_is_bitwise_repeatable(cuda):
    """One writer per output element and a fixed summation order: two
    launches on the same wave agree bit for bit, one launch per call."""
    wav = _wave(1 << 22, cuda, seed=3)
    hop = (1 << 22) // 215
    launches = mel_power_cuda.launches
    a = mel_power_cuda(wav, SR, hop_length=hop)
    b = mel_power_cuda(wav, SR, hop_length=hop)
    torch.cuda.synchronize()
    assert mel_power_cuda.launches == launches + 2
    assert torch.equal(a, b)


def _roll_events(B, E, T, start, seed=0, pad_from=None):
    """tests/test_pallas_roll.py's generator (notes in [-1, 128), ons past
    the crop on both sides, spans of -2..19 steps, velocities from -1);
    ``pad_from`` pads every slot from that index on (a shared pad tail)."""
    rng = np.random.RandomState(seed)
    notes = rng.randint(-1, 128, (B, E)).astype(np.int32)
    if pad_from is not None:
        notes[:, pad_from:] = -1
    ons = rng.randint(0, T + start + 10, (B, E)).astype(np.int32)
    offs = (ons + rng.randint(-2, 20, (B, E))).astype(np.int32)
    vels = rng.randint(-1, 127, (B, E)).astype(np.int32)
    return notes, ons, offs, vels


LAST_WRITER = (np.array([[60, 60, 60, 60, 64, 64]], np.int32),
               np.array([[10, 10, 10, 10, 5, 5]], np.int32),
               np.array([[30, 20, 15, 12, 40, 8]], np.int32),
               np.array([[100, 90, 0, -1, 70, 0]], np.int32))

# (label, events, T, start): the JAX kernel tests' shapes, the pickler's
# (8 files, E 4096, T 300), a dense one and a long roll that one CTA per
# sample could not hold in shared memory
ROLL_CASES = [
    ("jax_3x32", lambda: _roll_events(3, 32, 50, 5), 50, 5),
    ("jax_2x128", lambda: _roll_events(2, 128, 50, 100, seed=1), 50, 100),
    ("jax_1x16", lambda: _roll_events(1, 16, 96, 0, seed=2), 96, 0),
    ("last_writer", lambda: LAST_WRITER, 50, 0),
    ("pad_tail", lambda: _roll_events(4, 256, 50, 0, seed=3, pad_from=37), 50, 0),
    ("all_pad", lambda: (np.full((2, 8), -1, np.int32),) + (np.zeros((2, 8), np.int32),) * 3,
     50, 0),
    ("pickler", lambda: _roll_events(8, 4096, 300, 0, seed=4), 300, 0),
    ("dense", lambda: _roll_events(8, 16384, 300, 0, seed=5), 300, 0),
    ("long_roll", lambda: _roll_events(2, 4096, 2000, 0, seed=6), 2000, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("label,make,T,start", ROLL_CASES, ids=[c[0] for c in ROLL_CASES])
def test_rasterize_cuda_matches_plain(cuda, label, make, T, start):
    events = [torch.from_numpy(a).to(cuda) for a in make()]
    launches = rasterize_cuda.launches
    out = rasterize_events(*events, num_steps=T, start=start)
    torch.cuda.synchronize()
    assert rasterize_cuda.launches == launches + 1
    ref = rasterize_events_reference(*events, num_steps=T, start=start)
    assert out.shape == ref.shape == (events[0].shape[0], 2, 128, T)
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_rasterize_cuda_refuses_what_the_kernel_does_not_take(cuda):
    notes, ons, offs, vels = (torch.from_numpy(a).to(cuda) for a in _roll_events(2, 64, 50, 0))
    with pytest.raises(ValueError):
        rasterize_cuda(notes.long(), ons, offs, vels, num_steps=50)
    with pytest.raises(ValueError):
        rasterize_cuda(notes[:, ::2], ons[:, ::2], offs[:, ::2], vels[:, ::2], num_steps=50)
    with pytest.raises(ValueError):
        rasterize_cuda(notes, ons, offs, vels[:1], num_steps=50)
    with pytest.raises(ValueError):
        rasterize_cuda(notes, ons, offs, vels, num_steps=1 << 20)  # no tile fits
