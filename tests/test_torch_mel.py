"""gandes_tpu_torch mel front end vs the JAX package (kernel K2's plain version).

The port's plain mel power (reflect pad, unfold, hann, torch.fft.rfft, |.|^2,
fb @ power) is held against the JAX package's Pallas kernel (interpret mode
on the CPU, as tests/test_pallas_mel.py runs it) and against its XLA path
(power_spectrogram + _mel_project), on the same numpy waves: rtol 2e-3 /
atol 1e-4 in power (the JAX kernel tests' tolerance), 0.05 dB in the
dB domain. The CUDA kernel itself runs only on the card:
tests/test_torch_cuda_kernels.py holds it against the plain version there.
Here its host half is pinned: the compact filterbank and the twiddle and
window tables it reads, and a float64 model of its FFT steps on them.
"""

import numpy as np
import pytest
import torch

from gandes_tpu.music import mel as jax_mel
from gandes_tpu.ops.pallas_mel import mel_power_pallas
from gandes_tpu_torch.music import mel as torch_mel
from gandes_tpu_torch.ops.mel_power import (
    compact_filterbank,
    fft_twiddles,
    mel_power_cuda,
    mel_power_reference,
)

SR = 44100
RTOL, ATOL = 2e-3, 1e-4
DB_ATOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    timing-sensitive tests elsewhere need their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wave(n, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    return (0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.randn(n)).astype(np.float32)


# (hop, n, htk, norm_slaney): the JAX kernel tests' fixed hops, the serve
# path's dynamic hop at the smallest pow2 bucket (2^18 // 215), and the
# blank clip's librosa (slaney) variant
CASES = [(512, 44100, True, False), (1025, 5 * 44100, True, False),
         (220, 44100, True, False), ((1 << 18) // 215, 1 << 18, True, False),
         (512, 5 * 44100, False, True)]


@pytest.mark.parametrize("hop,n,htk,norm_slaney", CASES)
def test_mel_power_reference_matches_jax(hop, n, htk, norm_slaney):
    wav = _wave(n)
    ours = mel_power_reference(torch.from_numpy(wav), SR, hop_length=hop, htk=htk,
                               norm_slaney=norm_slaney).numpy()
    kernel = np.asarray(mel_power_pallas(wav, SR, hop_length=hop, htk=htk,
                                         norm_slaney=norm_slaney, interpret=True))
    s = jax_mel.power_spectrogram(wav, n_fft=2048, hop_length=hop)
    xla = np.asarray(jax_mel._mel_project(s, SR, 2048, 128, 20, 8300, htk, norm_slaney))
    assert ours.shape == kernel.shape == xla.shape == (128, 1 + n // hop)
    np.testing.assert_allclose(ours, kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, xla, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [SR, 1 << 18])
def test_melspectrogram_db_tensor_matches_jax(n):
    wav = _wave(n, seed=1)
    ours = torch_mel.melspectrogram_db_tensor(torch.from_numpy(wav), sr=SR).numpy()
    ref = np.asarray(jax_mel.melspectrogram_db_tensor(wav, sr=SR, use_pallas=False))
    assert ours.shape == ref.shape == (128, 216)
    np.testing.assert_allclose(ours, ref, atol=DB_ATOL)


def test_melspectrogram_db_librosa_variant_matches_jax():
    """The blank-clip path of matrix_to_wav (5 s, hop 512, slaney, ref=1)."""
    wav = _wave(5 * SR, seed=2)
    ours = torch_mel.melspectrogram_db(wav, sr=SR).numpy()
    ref = np.asarray(jax_mel.melspectrogram_db(wav, sr=SR))
    assert ours.shape == ref.shape == (128, 431)
    np.testing.assert_allclose(ours, ref, atol=DB_ATOL)
    silent = torch_mel.melspectrogram_db(np.zeros(5 * SR), sr=SR).numpy()
    np.testing.assert_array_equal(silent, np.asarray(jax_mel.melspectrogram_db(
        np.zeros(5 * SR), sr=SR)))


def test_db_transforms_match_jax():
    s = np.abs(np.random.RandomState(3).randn(128, 50)).astype(np.float32) ** 4
    s[0, :5] = 0.0
    for top_db in (80.0, None):
        np.testing.assert_allclose(
            torch_mel.amplitude_to_db_torch(torch.from_numpy(s), top_db=top_db).numpy(),
            np.asarray(jax_mel.amplitude_to_db_torch(s, top_db=top_db)), atol=1e-4)
        np.testing.assert_allclose(
            torch_mel.power_to_db(torch.from_numpy(s), top_db=top_db).numpy(),
            np.asarray(jax_mel.power_to_db(s, top_db=top_db)), atol=1e-4)
    np.testing.assert_allclose(
        torch_mel.power_to_db(torch.from_numpy(s), ref="max").numpy(),
        np.asarray(jax_mel.power_to_db(s, ref="max")), atol=1e-4)


def test_filterbank_and_window_are_the_jax_packages():
    for htk, norm in ((True, False), (False, True)):
        np.testing.assert_array_equal(torch_mel.mel_filterbank(SR, 2048, 128, 20, 8300, htk, norm),
                                      jax_mel.mel_filterbank(SR, 2048, 128, 20, 8300, htk, norm))
    np.testing.assert_array_equal(torch_mel._hann_periodic(2048), jax_mel._hann_periodic(2048))


# (n_fft, fmax, htk, norm_slaney): the serve and blank-clip filterbanks,
# both at fmax = sr / 2 (the band reaches bin n_fft / 2), and the shortest
# and longest FFT the kernel takes
FILTERBANKS = [(2048, 8300, True, False), (2048, 8300, False, True),
               (2048, SR / 2, True, False), (2048, SR / 2, False, True),
               (256, 8300, True, False), (8192, SR / 2, False, True)]


@pytest.mark.parametrize("n_fft,fmax,htk,norm_slaney", FILTERBANKS)
def test_compact_filterbank_rebuilds_the_filterbank(n_fft, fmax, htk, norm_slaney):
    fb = torch_mel.mel_filterbank(SR, n_fft, 128, 20, fmax, htk, norm_slaney)
    band, weights, n_bins = compact_filterbank(SR, n_fft, 128, 20, fmax, htk, norm_slaney)
    first, count, offset = band
    assert band.dtype == np.int32 and weights.dtype == np.float32
    np.testing.assert_array_equal(offset, np.concatenate([[0], np.cumsum(count)[:-1]]))
    assert weights.size == count.sum()
    rebuilt = np.zeros_like(fb)
    for m in range(128):
        rebuilt[m, first[m]:first[m] + count[m]] = weights[offset[m]:offset[m] + count[m]]
    np.testing.assert_array_equal(rebuilt, fb)
    assert n_bins == np.flatnonzero(fb.any(axis=0)).max() + 1
    assert (first + count <= n_bins).all() and n_bins <= n_fft // 2 + 1
    if (n_fft, fmax) == (2048, 8300):  # the serve path's: 761 (htk) / 759 nonzeros
        assert weights.size == np.count_nonzero(fb) == (761 if htk else 759)
        assert n_bins == 386


@pytest.mark.parametrize("n_fft", [256, 2048, 8192])
def test_kernel_tables_are_their_float64_formulas(n_fft):
    ang = -2.0 * np.pi * np.arange(n_fft // 2, dtype=np.float64) / n_fft
    tw = fft_twiddles(n_fft)
    assert tw.dtype == np.float32 and tw.shape == (n_fft // 2, 2)
    np.testing.assert_array_equal(tw[:, 0], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], np.sin(ang).astype(np.float32))
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft)
    np.testing.assert_array_equal(torch_mel._hann_periodic(n_fft), hann.astype(np.float32))


def _kernel_fold(x, n):
    """csrc/mel_power.cu's ``reflected_sample`` index arithmetic: one
    reflection at each end, then, for a position still outside [0, n), C's
    truncating ``%`` by the period and one more reflection."""
    x = np.abs(x)
    x = np.where(x >= n, 2 * (n - 1) - x, x)
    if n == 1:
        return np.zeros_like(x)
    period = 2 * (n - 1)
    out = np.fmod(x, period)  # C's % (truncation toward zero)
    out = np.where(out < 0, out + period, out)
    out = np.where(out >= n, period - out, out)
    return np.where((x >= 0) & (x < n), x, out)


def _kernel_model(wav, hop, n_fft, htk, norm_slaney):
    """float64 model of the CUDA kernel's steps on its own tables: reflected
    frame reads, window, packing as n_fft/2 complex values, their FFT
    (np.fft), the real-FFT post-processing with the kernel's twiddles (and
    W^(k+N) = -W^k), power of the bins below n_bins, sparse projection."""
    n, N = len(wav), n_fft // 2
    n_frames = 1 + n // hop
    idx = _kernel_fold(np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :] - N, n)
    x = wav.astype(np.float64)[idx] * torch_mel._hann_periodic(n_fft).astype(np.float64)
    Z = np.fft.fft(x[:, 0::2] + 1j * x[:, 1::2], axis=1)
    band, weights, n_bins = compact_filterbank(SR, n_fft, 128, 20, 8300, htk, norm_slaney)
    k = np.arange(n_bins)
    tw = fft_twiddles(n_fft).astype(np.float64)
    w = tw[k % N, 0] + 1j * tw[k % N, 1]
    w = np.where(k < N, w, -w)
    zk, zr = Z[:, k % N], np.conj(Z[:, (N - k) % N])
    X = 0.5 * (zk + zr) - 0.5j * w * (zk - zr)
    power = np.abs(X) ** 2
    out = np.zeros((128, n_frames))
    for m, (first, count, offset) in enumerate(band.T):
        out[m] = weights[offset:offset + count].astype(np.float64) @ power[:, first:first + count].T
    return out


@pytest.mark.parametrize("hop,n,htk,norm_slaney", CASES + [(1, 216, True, False),
                                                       (4, 864, True, False)])
def test_kernel_model_matches_reference_and_jax(hop, n, htk, norm_slaney):
    """Pins the post-processing formula and the sparse projection that
    csrc/mel_power.cu implements, against the plain version and the JAX
    package's Pallas kernel (interpret mode)."""
    wav = _wave(n, seed=4)
    model = _kernel_model(wav, hop, 2048, htk, norm_slaney)
    ours = mel_power_reference(torch.from_numpy(wav), SR, hop_length=hop, htk=htk,
                               norm_slaney=norm_slaney).numpy()
    kernel = np.asarray(mel_power_pallas(wav, SR, hop_length=hop, htk=htk,
                                         norm_slaney=norm_slaney, interpret=True))
    assert model.shape == ours.shape == kernel.shape == (128, 1 + n // hop)
    np.testing.assert_allclose(model, ours, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(model, kernel, rtol=RTOL, atol=ATOL)


def test_kernel_entry_point_raises_on_cpu_tensors():
    """The CUDA kernel is never emulated: a CPU tensor (or numpy) is refused,
    and the backend sends CPU tensors to the plain version instead."""
    wav = torch.from_numpy(_wave(SR))
    with pytest.raises(ValueError, match="CUDA tensor"):
        mel_power_cuda(wav, SR)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mel_power_cuda(wav.numpy(), SR)
    launches = mel_power_cuda.launches
    out = torch_mel._mel_power_backend(wav, SR, 2048, 512, 128, 20, 8300, True, False)
    np.testing.assert_array_equal(out.numpy(), mel_power_reference(wav, SR).numpy())
    assert mel_power_cuda.launches == launches


# ---------------------------------------------- waves shorter than n_fft / 2

# melspectrogram_db_tensor crops a wave to 216 * (len // 215) samples: 300 and
# 1,024 samples leave 216 and 864, 900 and 1,025 leave 864 and 1,080, every
# one of them shorter than the 1,024-sample reflect pad
SHORT = [300, 900, 1024, 1025]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 216, 1024, 1025, 3000])
@pytest.mark.parametrize("pad", [1, 4, 1024, 4096])
def test_reflect_pad_is_numpys(n, pad):
    """``jnp.pad``/``np.pad(mode='reflect')`` reflect again and again; the
    port's pad equals it at every length, bitwise, and equals the single
    reflection of ``F.pad`` wherever that one applies (pad < n)."""
    wav = _wave(n, seed=n)
    ours = torch_mel.reflect_pad(torch.from_numpy(wav), pad).numpy()
    np.testing.assert_array_equal(ours, np.pad(wav, (pad, pad), mode="reflect"))
    if n >= 216:  # jnp.pad folds in a loop of pad / n reflections: seconds at n < 10
        np.testing.assert_array_equal(ours, np.asarray(jax_mel.jnp.pad(wav, (pad, pad),
                                                                       mode="reflect")))
    if pad < n:
        single = torch.nn.functional.pad(torch.from_numpy(wav)[None, None], (pad, pad),
                                         mode="reflect")[0, 0]
        np.testing.assert_array_equal(ours, single.numpy())


@pytest.mark.parametrize("n", SHORT)
def test_short_wave_mel_db_tensor_matches_jax(n):
    wav = _wave(n, seed=5)
    ours = torch_mel.melspectrogram_db_tensor(torch.from_numpy(wav), sr=SR).numpy()
    ref = np.asarray(jax_mel.melspectrogram_db_tensor(wav, sr=SR, use_pallas=False))
    assert ours.shape == ref.shape == (128, 217)
    np.testing.assert_allclose(ours, ref, atol=DB_ATOL)
    hop = n // 215
    crop = wav[:216 * hop]
    power = mel_power_reference(torch.from_numpy(crop), SR, hop_length=hop).numpy()
    kernel = np.asarray(mel_power_pallas(crop, SR, hop_length=hop, interpret=True))
    np.testing.assert_allclose(power, kernel, rtol=RTOL, atol=ATOL)


def test_one_sample_and_empty_waves_match_jax():
    """One sample: the pad repeats it, as ``jnp.pad`` does, one frame out.
    No sample (or a wave too short for a hop of 1): both packages raise
    ValueError."""
    one = np.array([0.25], np.float32)
    ours = torch_mel.power_spectrogram(torch.from_numpy(one), n_fft=2048, hop_length=512)
    ref = np.asarray(jax_mel.power_spectrogram(one, n_fft=2048, hop_length=512))
    assert ours.shape == ref.shape == (1025, 1)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=ATOL)
    for n in (0, 100):
        wav = _wave(n)
        with pytest.raises(ValueError):
            jax_mel.melspectrogram_db_tensor(wav, sr=SR, use_pallas=False)
        with pytest.raises(ValueError, match="empty axis"):
            torch_mel.melspectrogram_db_tensor(torch.from_numpy(wav), sr=SR)


@pytest.mark.parametrize("n_fft", [128, 2000, 16384])
def test_plain_version_outside_the_kernels_n_fft_range_matches_jax(n_fft):
    """K2 takes powers of two in [256, 8192] and raises on a CUDA tensor
    outside them; the JAX backend falls back to XLA there. The port's plain
    version (the CPU's path) still matches the JAX package at any n_fft."""
    wav = _wave(2 * SR, seed=6)
    ours = mel_power_reference(torch.from_numpy(wav), SR, n_fft=n_fft, hop_length=700).numpy()
    s = jax_mel.power_spectrogram(wav, n_fft=n_fft, hop_length=700)
    ref = np.asarray(jax_mel._mel_project(s, SR, n_fft, 128, 20, 8300, True, False))
    assert ours.shape == ref.shape == (128, 1 + 2 * SR // 700)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 3, 216, 1024, 1025])
def test_kernel_fold_is_numpys_reflect_pad(n):
    """The kernel's index arithmetic lands on np.pad(mode='reflect')'s
    sample for every position of the centred frames' span."""
    x = np.arange(-4096, n + 4096)
    idx = _kernel_fold(x, n)
    assert ((idx >= 0) & (idx < n)).all()
    np.testing.assert_array_equal(idx, np.pad(np.arange(n), (4096, 4096), mode="reflect"))
