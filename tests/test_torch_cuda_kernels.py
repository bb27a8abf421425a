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
from gandes_tpu_torch.ops.mel_power import mel_power_cuda, mel_power_reference

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
