"""The GAN-DES serving slice of gandes_tpu_torch vs the JAX package, on the CPU.

The same (2, 20, 20) matrices — the JAX generator's output, so a 1e-6
difference cannot flip an ``int(x * 126)`` instrument — go through both
packages' ``matrix_to_wav`` after the same global numpy seed, with a DES wall
budget (``max_sim_time``) far above the run's need so the result does not
depend on machine load.

Tolerances: the MIDI bytes are identical; WAV int16 samples within 1 LSB
(the synths agree to ~1e-7, and the cast truncates); the port's mel of the
JAX path's own samples within 0.05 dB of the JAX path's mel. End to end, a
sample whose float value sits within ~1e-7 of an int16 step truncates to
the other step in one package (~160 of 2.3 million samples per clip), which
moves mel bins near the 80 dB floor by up to 0.14 dB; bins more than 10 dB
above the floor stay within 0.05 dB, every bin within 0.2 dB, and at most
2e-4 of the samples differ.
"""

import base64
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from gandes_tpu.bridge.gandes_decode import matrix_to_wav as jax_matrix_to_wav
from gandes_tpu.des import native as jax_native
from gandes_tpu.models.gan_des import DCGANGenerator as JaxDCGAN
from gandes_tpu_torch.bridge.gandes_decode import matrix_to_wav
from gandes_tpu_torch.music.mel import melspectrogram_db_tensor
from gandes_tpu_torch.music.synth import _pow2
from gandes_tpu_torch.des import native
from gandes_tpu_torch.serve import GenerationService, make_http_server

DB_ATOL = 0.05
FLOOR_DB_ATOL = 0.2   # every bin end to end, floor bins included
FLIP_SHARE = 2e-4     # int16 samples that truncate to the other step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    timing-sensitive tests elsewhere need their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _des_libs_loaded():
    """Both packages' native DES cores are built and loaded before any sim
    runs under a wall budget: a cold g++ build (~3 s) must not count as a
    sim's time."""
    assert jax_native.get_lib() is not None
    assert native.get_lib() is not None


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    gen = JaxDCGAN()
    z = np.random.RandomState(0).randn(2, 100).astype(np.float32)
    variables = gen.init(jax.random.key(1), jnp.asarray(z), True)
    mats = np.asarray(gen.apply(variables, jnp.asarray(z), False))
    runs = {}
    for name, fn, kw in (("jax", jax_matrix_to_wav, {}),
                         ("torch", matrix_to_wav, {"device": "cpu"})):
        d = str(tmp_path_factory.mktemp(name))
        np.random.seed(0)
        spec = fn(mats, size=20, start=0, end=216, out_dir=d,
                  log_path=os.path.join(d, "logs/"), max_sim_time=60, **kw)
        runs[name] = (np.asarray(spec), d)
    return runs


def test_matrix_to_wav_matches_jax(slice_runs):
    (ref, ref_dir), (ours, our_dir) = slice_runs["jax"], slice_runs["torch"]
    assert ours.shape == ref.shape == (2, 128, 216)
    with open(os.path.join(ref_dir, "midi", "output.mid"), "rb") as a, \
            open(os.path.join(our_dir, "midi", "output.mid"), "rb") as b:
        assert a.read() == b.read()
    for i in range(2):
        sr_a, wa = wavfile.read(os.path.join(ref_dir, "wav", f"output_{i}.wav"))
        sr_b, wb = wavfile.read(os.path.join(our_dir, "wav", f"output_{i}.wav"))
        assert sr_a == sr_b == 44100 and wa.dtype == wb.dtype == np.int16
        assert wa.shape == wb.shape
        assert np.abs(wa.astype(np.int32) - wb.astype(np.int32)).max() <= 1

        # the port's mel of the JAX path's own samples (the bucketed buffer:
        # the WAV's samples, then zeros to the pow2 length)
        q = np.zeros(_pow2(len(wa)), np.float32)
        q[: len(wa)] = wa.astype(np.float32) / 32768.0
        mel = melspectrogram_db_tensor(torch.from_numpy(q)).numpy()[:, :216]
        np.testing.assert_allclose(mel, ref[i], atol=DB_ATOL)

        above_floor = ref[i] > ref[i].min() + 10.0
        np.testing.assert_allclose(ours[i][above_floor], ref[i][above_floor], atol=DB_ATOL)
        # end to end near the floor: only truncation flips, few and 1 LSB
        # each (~7e-5 of the samples), moving those bins by at most ~0.14 dB
        assert np.count_nonzero(wa != wb) <= FLIP_SHARE * wa.size
        np.testing.assert_allclose(ours[i], ref[i], atol=FLOOR_DB_ATOL)


def test_matrix_to_wav_parallel_mode_is_not_ported():
    with pytest.raises(NotImplementedError, match="parallel"):
        matrix_to_wav(np.zeros((1, 20, 20)), parallel=2, device="cpu")


@pytest.fixture(scope="module")
def service():
    return GenerationService(model="gandes", device="cpu", lock=threading.Lock())


def test_generation_service_gandes(service, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = service.generate(n=2, seed=0)
    assert out["mel_shape"] == [2, 128, 216] and out["latency_s"] > 0
    for b64 in out["wav_b64"]:
        assert base64.b64decode(b64)[:4] == b"RIFF"
    again = service.generate(n=2, seed=0)
    assert again["wav_b64"] == out["wav_b64"]  # same seed -> same bytes
    assert service.generate(n=2, seed=1)["wav_b64"] != out["wav_b64"]
    assert not os.listdir(tmp_path)  # DES logs and WAVs stay in the request's temp dir
    with pytest.raises(ValueError):
        service.generate(n=0)


def test_http_round_trip(service, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    server = make_http_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        req = urllib.request.Request(base + "/generate/gandes",
                                     data=json.dumps({"n": 1, "seed": 3}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert out["mel_shape"] == [1, 128, 216]
        assert base64.b64decode(out["wav_b64"][0])[:4] == b"RIFF"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["model"] == "gandes"
        assert health["requests"] >= 1
        for path, body, code in (("/generate/mmgan", b"{}", 404),
                                 ("/generate/gandes", b"{not json", 400),
                                 ("/generate/gandes", json.dumps({"n": 10**6}).encode(), 400)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(base + path, data=body),
                                       timeout=30)
            assert ei.value.code == code
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.mark.parametrize("model", ["mmgan", "both"])
def test_mmgan_family_is_not_ported(model):
    """The MM-GAN family is ported now (tests/test_torch_mmgan_serve.py):
    a service takes one family, and 'both' is a server of two services, so
    ``GenerationService`` refuses it as the JAX package's does."""
    if model == "both":
        with pytest.raises(ValueError, match="unknown model"):
            GenerationService(model=model, device="cpu")
    else:
        assert GenerationService(model=model, device="cpu").model == "mmgan"


def test_cli_rejects_orbax_checkpoints():
    from gandes_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="export-torch"):
        main(["serve", "--model", "gandes", "--checkpoint", "some/orbax/dir", "--device", "cpu"])
