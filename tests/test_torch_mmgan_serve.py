"""MM-GAN serving in gandes_tpu_torch vs the JAX package, on the CPU.

The port's ``GenerationService(model="mmgan")`` loads the JAX package's
seeded weights (exported to the reference ``.pth`` layout) and answers a
request. Each sample's generator outputs, recomputed from the same numpy
noise stream, go through the JAX package's ``matrix_to_midi`` after the same
``np.random.seed(seed + i)``: the MIDI bytes must equal the reply's wherever
neither slot's simulation failed (the sim budget is wall-clock). The two
packages' generators differ by an ulp, which moves the DES's sampled times,
so replies are not compared across packages directly. Then the port's HTTP
server: ``/generate/mmgan`` with and without WAVs, the two-family
(``both``) server, and the CLI.
"""

import base64
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gandes_tpu.bridge.mmgan_decode import matrix_to_midi as jax_matrix_to_midi
from gandes_tpu.des import native as jax_native
from gandes_tpu.train.loading import load_mmgan_state as jax_load_mmgan_state
from gandes_tpu.train.mmgan_loop import MMGANConfig as JaxMMGANConfig
from gandes_tpu.train.torch_import import export_mmgan_torch_checkpoint
from gandes_tpu_torch.des import native
from gandes_tpu_torch.serve import GenerationService, make_http_server, run_server
from gandes_tpu_torch.train.mmgan_loop import eval_forward


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "mmgan_64_64_epoch_0.pth")
    export_mmgan_torch_checkpoint(jax_load_mmgan_state(JaxMMGANConfig()), path)
    return path


@pytest.fixture(scope="module")
def service(checkpoint):
    return GenerationService(model="mmgan", torch_checkpoint=checkpoint, device="cpu",
                             lock=threading.Lock())


def test_mmgan_service_matches_jax(service, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = service.generate(n=3, seed=0)
    assert len(out["midi_b64"]) == len(out["roll_sums"]) == 3
    assert out["failed"] == out["midi_b64"].count(None)
    assert not os.listdir(tmp_path)  # DES logs and MIDIs stay in the request's temp dir
    cfg = service.cfg
    rng = np.random.RandomState(0)
    compared = 0
    for i in range(3):
        noise1, noise2 = (rng.randn(1, cfg.noise_dim).astype(np.float32) for _ in range(2))
        out1, out2 = eval_forward(service.mmgan, noise1, noise2,
                                  np.zeros((1, cfg.max_beat_length), np.float32))
        np.random.seed(i)
        ref_dir = str(tmp_path / f"jax_{i}")
        jax_matrix_to_midi(out1.numpy()[:, None], out2.numpy(), adj_size=cfg.adj_size,
                           instrument=cfg.instrument, start=cfg.start,
                           end=cfg.start + cfg.sequence_length, generate=True,
                           log_path=str(tmp_path / "logs") + "/", out_dir=ref_dir)
        ref_path = os.path.join(ref_dir, "generation.mid")
        if out["midi_b64"][i] is None or not os.path.exists(ref_path):
            continue
        with open(ref_path, "rb") as f:
            ref = f.read()
        assert ref[:4] == b"MThd"
        assert base64.b64decode(out["midi_b64"][i]) == ref
        compared += 1
    assert compared, out["failed"]


def test_mmgan_service_seeds(service, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    a, b, again = (service.generate(n=2, seed=s) for s in (0, 1, 0))
    for i in range(2):
        if a["midi_b64"][i] and again["midi_b64"][i]:
            assert a["midi_b64"][i] == again["midi_b64"][i]
    songs = [m for m in a["midi_b64"] + b["midi_b64"] if m]
    assert len(set(songs)) == len(songs) >= 2  # seeds 0 and 1 give different songs
    with pytest.raises(ValueError):
        service.generate(n=0)


def _post(base, path, payload, timeout=300):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _serving(services):
    server = make_http_server(services, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_http_mmgan(service, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    server, thread, base = _serving(service)
    try:
        out = _post(base, "/generate/mmgan", {"n": 1, "seed": 4, "wav": True})
        assert len(out["midi_b64"]) == len(out["wav_b64"]) == 1 and out["latency_s"] > 0
        if out["midi_b64"][0] is None:
            assert out["failed"] == 1 and out["wav_b64"][0] is None
        else:
            assert base64.b64decode(out["midi_b64"][0])[:4] == b"MThd"
            assert base64.b64decode(out["wav_b64"][0])[:4] == b"RIFF"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["model"] == "mmgan"
        assert health["requests"] >= 1
        for path, body, code in (("/generate/gandes", b"{}", 404),
                                 ("/generate/mmgan", b"[1]", 400),
                                 ("/generate/mmgan", json.dumps({"n": 10**6}).encode(), 400)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(base + path, data=body),
                                       timeout=30)
            assert ei.value.code == code
    finally:
        _stop(server, thread)


def test_http_both_families(service, tmp_path, monkeypatch):
    """``serve --model both``: one server, two endpoints, a health entry per
    family, one shared generation lock."""
    monkeypatch.chdir(tmp_path)
    gandes = GenerationService(model="gandes", device="cpu", lock=service._lock)
    server, thread, base = _serving({"mmgan": service, "gandes": gandes})
    try:
        out = _post(base, "/generate/mmgan", {"n": 1, "seed": 2})
        assert len(out["midi_b64"]) == 1 and "wav_b64" not in out
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and set(health["models"]) == {"mmgan", "gandes"}
        assert health["models"]["gandes"]["requests"] == 0
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(base + "/generate/other", data=b"{}"),
                                   timeout=30)
        assert ei.value.code == 404
    finally:
        _stop(server, thread)


def test_run_server_both_rejects_a_checkpoint(checkpoint):
    with pytest.raises(ValueError, match="both"):
        run_server(model="both", torch_checkpoint=checkpoint, device="cpu")


def test_cli_generate_mmgan(checkpoint, tmp_path, monkeypatch):
    from gandes_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)  # the DES log goes to ./logs/
    out_dir = str(tmp_path / "out")
    try:
        main(["generate-mmgan", "--torch-checkpoint", checkpoint, "--n", "2", "--seed", "0",
              "--out-dir", out_dir, "--device", "cpu"])
    except SystemExit as e:  # every sample's wall-clock sim failed
        assert e.code == 1
    written = sorted(f for f in os.listdir(out_dir) if f.startswith("generation_"))
    assert set(written) <= {"generation_0.mid", "generation_1.mid"}
    for name in written:
        with open(os.path.join(out_dir, name), "rb") as f:
            assert f.read(4) == b"MThd"
    with pytest.raises(SystemExit, match="export-torch"):
        main(["generate-mmgan", "--checkpoint", "some/orbax/dir", "--device", "cpu"])
