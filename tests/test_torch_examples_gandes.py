"""The port's GAN-DES example harness (``gandes_tpu_torch/examples/
train_gandes_demo.py``) against ``examples/train_gandes_demo.py`` on the same
inputs, on the CPU.

- ``build_dataset(n_nets=2)`` writes the same MIDI bytes in both packages;
- ``real_mels(n=4)`` matches the JAX pool at the mel tolerance: 0.05 dB
  above 10 dB over each slice's floor, 0.5 dB on every bin (each package
  renders with its own synth, whose int16 flips move bins near the floor;
  ``tests/test_torch_gandes_train.py``);
- ``generated_mels`` with the JAX DCGAN's weights carried across
  (``dcgan_state_dict_from_flax``) and the JAX noise injected: G's matrices
  at atol 2e-4, and the mels at the mel tolerance where both packages
  decode the JAX matrices (the decode takes ``int(x * 126)``, so a last-bit
  difference of G flips a note and the whole clip);
- ``gap`` on the same mels within 1e-5 of the two sides' metric means
  (``mel_metrics``' own tolerance against the JAX package; a gap is a
  difference of means, so it is held to their scale, not its own);
- one ``run(steps=1, n_nets=2, batch_size=2, device="cpu")`` writes
  ``RESULTS.json`` with the JAX harness's keys.

One torch thread, B = 2, two sim threads.
"""

import ast
import json
import os
import sys
import types

import jax
import numpy as np
import optax
import pytest
import torch

from gandes_tpu.des import native as jax_native
from gandes_tpu.eval import metrics as jax_metrics
from gandes_tpu.models.gan_des import DCGANGenerator as JaxDCGAN
from gandes_tpu.models.gan_des import MelDiscriminator as JaxMelD
from gandes_tpu.train import steps as jax_steps
from gandes_tpu.train.gandes_loop import GanDesConfig as JaxGanDesConfig
from gandes_tpu_torch.des import native
from gandes_tpu_torch.examples import train_gandes_demo
from gandes_tpu_torch.models.gan_des import DCGANGenerator
from gandes_tpu_torch.train.convert import dcgan_state_dict_from_flax
from gandes_tpu_torch.train.gandes_loop import GanDesConfig

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
sys.path.insert(0, EXAMPLES)
import train_gandes_demo as jax_demo  # noqa: E402

B = 2
DB_ATOL, FLOOR_DB_ATOL = 0.05, 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _des_libs_loaded():
    """Both packages' native DES cores are loaded before any sim runs under
    a wall budget: a cold g++ build must not count as a sim's time."""
    assert jax_native.get_lib() is not None
    assert native.get_lib() is not None


def _assert_mels_close(a, b, where):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, where
    for i in range(len(a)):
        above = b[i] > b[i].min() + 10.0
        np.testing.assert_allclose(a[i][above], b[i][above], atol=DB_ATOL, err_msg=where)
        np.testing.assert_allclose(a[i], b[i], atol=FLOOR_DB_ATOL, err_msg=where)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("gandes_demo")
    return {"jax_dir": jax_demo.build_dataset(str(base / "jax"), n_nets=2),
            "dir": train_gandes_demo.build_dataset(str(base / "torch"), n_nets=2),
            "base": base}


def test_dataset_matches_jax(data):
    names = sorted(os.listdir(data["dir"]))
    assert names == sorted(os.listdir(data["jax_dir"])) == ["net_0.mid", "net_1.mid"]
    for name in names:
        with open(os.path.join(data["dir"], name), "rb") as a, \
                open(os.path.join(data["jax_dir"], name), "rb") as b:
            assert a.read() == b.read(), name


def test_real_mels_match_jax(data, capsys):
    ours = train_gandes_demo.real_mels(data["dir"], 4, device="cpu")
    ref = jax_demo.real_mels(data["jax_dir"], 4)
    assert isinstance(ours, torch.Tensor) and ours.device.type == "cpu"
    assert tuple(ours.shape) == (4, 128, 216)
    _assert_mels_close(ours.numpy(), ref, "real mels")
    out = capsys.readouterr().out
    assert out.count("real side drawn from 2 network MIDIs") == 2


def test_gap_matches_jax():
    rng = np.random.RandomState(0)
    real, fake = (rng.rand(3, 128, 216).astype(np.float32) * -40.0 for _ in range(2))
    ours, ref = train_gandes_demo.gap(real, fake), jax_demo.gap(real, fake)
    assert ours.keys() == ref.keys() == {"db_mean_gap", "db_std_gap", "centroid_gap",
                                         "flux_gap"}
    # a gap is a difference of two batch means: held to 1e-5 of their
    # magnitudes, mel_metrics' own tolerance against the JAX package
    means = [{k: float(np.mean(v)) for k, v in jax_metrics.mel_metrics(x).items()}
             for x in (real, fake)]
    for k in ref:
        m = k.removesuffix("_gap")
        scale = abs(means[0][m]) + abs(means[1][m])
        assert abs(ours[k] - ref[k]) <= 1e-5 * scale, (k, ours[k], ref[k], scale)


def test_generated_mels_match_jax(data, monkeypatch):
    """The JAX harness's ``generated_mels`` at n = 2 from a JAX initial state
    (seed 0) against the port's with the DCGAN's weights and the JAX
    ``jax.random.key(99)`` noise carried across, after the same numpy seed;
    the port decodes the JAX matrices."""
    from gandes_tpu.bridge import gandes_decode as jax_decode
    from gandes_tpu_torch.bridge import gandes_decode

    workdir = str(data["base"] / "gen")
    os.makedirs(os.path.join(workdir, "logs"))
    tx = optax.adam(2e-4, b1=0.5, b2=0.999)
    state = jax.jit(lambda key: jax_steps.init_gandes_state(
        JaxDCGAN(), JaxMelD(), key, batch_size=B, g_tx=tx, d_tx=tx))(jax.random.key(0))
    jcfg = JaxGanDesConfig(batch_size=B)
    jax_calls, jax_mtw = [], jax_decode.matrix_to_wav

    def recording_mtw(mats, **kw):
        jax_calls.append((np.array(mats), kw))
        return jax_mtw(mats, **kw)

    monkeypatch.setattr(jax_decode, "matrix_to_wav", recording_mtw)
    ref = jax_demo.generated_mels(state, jcfg, B, seed=99, workdir=workdir)
    assert len(jax_calls) == 1 and jax_calls[0][1]["parallel"] == 16

    gen = DCGANGenerator()
    gen.load_state_dict(dcgan_state_dict_from_flax(jax.device_get(state.g_params),
                                                   jax.device_get(state.g_stats)), strict=True)
    noise = np.asarray(jax.random.normal(jax.random.key(99), (B, 100)))
    port_mtw, calls = gandes_decode.matrix_to_wav, []

    def decode_jax_matrices(mats, **kw):
        np.testing.assert_allclose(mats, jax_calls[0][0], atol=2e-4, rtol=0, err_msg="G")
        calls.append(kw)
        return port_mtw(jax_calls[0][0], **kw)

    monkeypatch.setattr(gandes_decode, "matrix_to_wav", decode_jax_matrices)
    cfg = GanDesConfig(batch_size=B)
    mels = train_gandes_demo.generated_mels(types.SimpleNamespace(gen=gen), cfg, B, seed=99,
                                            workdir=workdir, noise=noise, parallel=2)
    assert len(calls) == 1 and calls[0]["parallel"] == 2 and not calls[0]["write_wav"]
    assert calls[0]["device"] == torch.device("cpu")
    assert isinstance(mels, torch.Tensor) and tuple(mels.shape) == (B, 128, 216)
    _assert_mels_close(mels.numpy(), ref, "generated mels")


def test_eval_noise_is_a_seeded_torch_draw():
    cfg = GanDesConfig()
    a = train_gandes_demo.eval_noise(cfg, 3, 99)
    assert a.shape == (3, 100) and a.dtype == torch.float32
    assert torch.equal(a, train_gandes_demo.eval_noise(cfg, 3, 99))
    assert not torch.equal(a, train_gandes_demo.eval_noise(cfg, 3, 98))


def _results_keys(module) -> set:
    """The keys of the ``results`` dict literal in a JAX harness's source."""
    tree = ast.parse(open(module.__file__).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "results" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no results dict in {module.__file__}")


def test_run_writes_the_jax_results_keys(tmp_path, capsys):
    workdir = str(tmp_path / "run")
    results = train_gandes_demo.run(workdir, steps=1, n_nets=2, g_update="reinforce", lr=1e-3,
                                    d_lr=1e-5, batch_size=B, device="cpu")
    with open(os.path.join(workdir, "RESULTS.json")) as f:
        written = json.load(f)
    assert set(written) == set(results) == _results_keys(jax_demo)
    assert written["steps"] == 1 and written["g_update"] == "reinforce"
    assert written["lr"] == 1e-3 and written["d_lr"] == 1e-5
    assert written["gap_initial"].keys() == written["gap_final"].keys()
    assert all(np.isfinite(written["disc_losses"] + written["gen_losses"]))
    out = capsys.readouterr().out
    timing = json.loads(next(ln for ln in out.splitlines() if ln.startswith('{"train_s"')))
    assert timing["launches"] == {"mel_power": 0}  # the CPU takes K2's plain version
    assert "initial gap:" in out and "final gap:" in out
    assert os.path.isfile(os.path.join(workdir, "loss_curves.png")) or \
        "loss_curves.png skipped: matplotlib" in out


def test_main_takes_the_jax_arguments_and_the_cpu_switch(monkeypatch):
    seen = {}
    monkeypatch.setattr(train_gandes_demo, "run", lambda *a, **k: seen.update(args=a, kw=k))
    monkeypatch.setenv("GANDES_DEMO_CPU", "1")
    train_gandes_demo.main(["w", "128", "16", "reinforce", "1e-3", "1e-5"])
    assert seen["args"] == ("w",)
    assert seen["kw"] == {"steps": 128, "n_nets": 16, "g_update": "reinforce", "lr": 1e-3,
                          "d_lr": 1e-5, "device": "cpu"}
    monkeypatch.delenv("GANDES_DEMO_CPU")
    train_gandes_demo.main([])
    assert seen["args"] == ("gandes_demo",)
    assert seen["kw"] == {"steps": 128, "n_nets": 16, "g_update": "surrogate", "lr": 2e-4,
                          "d_lr": None, "device": "cuda"}
