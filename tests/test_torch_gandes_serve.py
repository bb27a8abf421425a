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
from gandes_tpu_torch.data.audio import Base64Text, save_wav, wav_tensor
from gandes_tpu_torch.music.mel import melspectrogram_db_tensor
from gandes_tpu_torch.music.synth import _pow2
from gandes_tpu_torch.des import native
from gandes_tpu_torch.serve import GenerationService, make_http_server, reply_body

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
def jax_mats():
    gen = JaxDCGAN()
    z = np.random.RandomState(0).randn(2, 100).astype(np.float32)
    variables = gen.init(jax.random.key(1), jnp.asarray(z), True)
    return np.asarray(gen.apply(variables, jnp.asarray(z), False))


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory, jax_mats):
    mats = jax_mats
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


@pytest.mark.parametrize("parallel", [None, 2])
def test_matrix_to_wav_in_memory_matches_its_files(jax_mats, tmp_path, parallel):
    """With no log path, no output directory and a ``wavs`` list, nothing is
    written: the sim's records stay in memory and decode natively, and the
    spectrograms, the WAV bytes and the global RNG's state after the call
    equal those of the run that writes its log, MIDI and WAV files (which
    decodes the log's lines in Python on the sequential path)."""
    d = str(tmp_path / "files")
    np.random.seed(3)
    with_files = matrix_to_wav(jax_mats, size=20, start=0, end=216, out_dir=d,
                               log_path=os.path.join(d, "logs/"), max_sim_time=60,
                               parallel=parallel, device="cpu")
    after_files = np.random.get_state()
    files = []
    for i in range(len(jax_mats)):
        with open(os.path.join(d, "wav", f"output_{i}.wav"), "rb") as f:
            files.append(f.read())
    wavs = []
    work = tmp_path / "cwd"
    work.mkdir()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        np.random.seed(3)
        in_memory = matrix_to_wav(jax_mats, size=20, start=0, end=216, out_dir=None,
                                  log_path=None, wavs=wavs, max_sim_time=60,
                                  parallel=parallel, device="cpu")
    finally:
        os.chdir(cwd)
    after_memory = np.random.get_state()
    assert not os.listdir(work)
    assert torch.equal(with_files, in_memory)
    assert all(w.dtype == torch.uint8 and w.device.type == "cpu" for w in wavs)
    assert [bytes(w.numpy()) for w in wavs] == files
    assert after_files[2:] == after_memory[2:]
    assert np.array_equal(after_files[1], after_memory[1])


def test_matrix_to_wav_without_an_out_dir_writes_nothing(jax_mats, tmp_path, monkeypatch):
    """``out_dir=None`` writes no file, whatever ``write_wav`` says, and
    needs no ``wavs`` to collect the WAVs."""
    monkeypatch.chdir(tmp_path)
    np.random.seed(5)
    specs = matrix_to_wav(jax_mats[:1], size=20, start=0, end=216, out_dir=None,
                          log_path=None, write_wav=True, max_sim_time=60, device="cpu")
    assert specs.shape == (1, 128, 216)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 44_101])
def test_a_wav_built_on_the_device_is_save_wavs_file(tmp_path, n):
    """``wav_tensor`` gives the bytes ``save_wav`` writes (samples past
    [-1, 1] clipped), and ``Base64Text`` their base64, for every length
    modulo 3."""
    wave = (np.random.RandomState(n).randn(n) * 0.8).astype(np.float32)
    save_wav(str(tmp_path / "a.wav"), wave, 22050)
    with open(tmp_path / "a.wav", "rb") as f:
        written = f.read()
    built = wav_tensor(torch.from_numpy(wave), 22050)
    assert bytes(built.numpy()) == written
    text = Base64Text()
    assert text(built) == base64.b64encode(written).decode()
    assert text(built[: n % 5]) == base64.b64encode(written[: n % 5]).decode()


@pytest.mark.parametrize("payload", [
    {},
    {"wav_b64": ["UklGRg=="], "mel_shape": [1, 128, 216], "latency_s": 0.0941},
    {"midi_b64": ["TVRoZA==", None], "roll_sums": [1.5, 0.0], "failed": 1,
     "wav_b64": [None, "QQ=="], "latency_s": 0.1},
    {"wav_b64": []},
    {"error": 'ValueError: "n" é'},
    {"status": "ok", "models": {"gandes": {"counters": {"sims_run": 2}}}},
])
def test_the_reply_body_is_json_dumps(payload):
    """The reply splices base64 lists in unscanned; its bytes stay those of
    ``json.dumps(payload).encode()``."""
    assert reply_body(payload) == json.dumps(payload).encode()


def test_matrix_to_wav_parallel_mode_is_not_ported():
    """The concurrent mode is ported now (tests/test_torch_native_batch.py):
    a matrix with no routing mass fails its decode in it as in the
    sequential mode."""
    for parallel in (None, 2):
        with pytest.raises(ValueError):
            matrix_to_wav(np.zeros((1, 20, 20)), parallel=parallel, device="cpu")


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
    assert not os.listdir(tmp_path)  # DES logs, MIDI and WAVs stay in memory
    with pytest.raises(ValueError):
        service.generate(n=0)


def test_a_request_makes_no_temporary_directory(service, tmp_path, monkeypatch):
    """The sim's log, the MIDI and the WAV of a request never touch a disk."""
    import tempfile

    def no_mkdtemp(*args, **kwargs):
        raise AssertionError("a GAN-DES request made a temporary directory")

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tempfile, "mkdtemp", no_mkdtemp)
    out = service.generate(n=1, seed=4)
    assert base64.b64decode(out["wav_b64"][0])[:4] == b"RIFF"
    assert not os.listdir(tmp_path)


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
