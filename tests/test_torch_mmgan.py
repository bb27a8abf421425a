"""The port's MM-GAN models and MIDI decode vs the JAX package, on the CPU.

* G1, G2 and DiscriminatorCNN (T = 50) at the serving widths get the JAX
  models' weights through ``mmgan_state_dict_from_flax`` and the same numpy
  inputs; eval mode, BatchNorm running statistics set to non-trivial values.
  Tolerance atol 2e-4: float32 products summed in another order (XLA vs
  torch's CPU GEMM and convolution).
* ``AUX_INPUT`` equals, bit for bit, the aux vector the JAX eval forward
  draws for G1.
* ``matrix_to_midi`` in both packages on the same generator outputs and the
  same ``np.random.seed`` gives equal rolls and equal ``generation.mid``
  bytes; the sims get the largest wall budget, so they end by customer
  count and not by the clock.
"""

import os
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gandes_tpu.bridge.mmgan_decode import matrix_to_midi as jax_matrix_to_midi
from gandes_tpu.des import native as jax_native
from gandes_tpu.models.mmgan import DiscriminatorCNN as JaxDiscriminatorCNN
from gandes_tpu.train import mmgan_loop as jax_loop
from gandes_tpu.train.torch_import import export_mmgan_torch_checkpoint
from gandes_tpu_torch.bridge.mmgan_decode import matrix_to_midi
from gandes_tpu_torch.des import native
from gandes_tpu_torch.models.composite import MultiModalGAN
from gandes_tpu_torch.models.mmgan import DiscriminatorCNN
from gandes_tpu_torch.train.convert import mmgan_state_dict_from_flax
from gandes_tpu_torch.train.loading import load_mmgan_state
from gandes_tpu_torch.train.mmgan_loop import AUX_INPUT, MMGANConfig, eval_forward

ATOL = 2e-4


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


def _perturb_stats(tree, rng):
    """BatchNorm running statistics away from (0, 1)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.uniform(0.5, 2.0, x.shape) if path[-1].key == "var"
                         else rng.normal(0.0, 0.5, x.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def jax_state():
    cfg = jax_loop.MMGANConfig()
    state, _, _ = jax_loop.init_state_for_config(cfg, batch_size=2)
    g_stats = _perturb_stats(jax.device_get(state.g_stats), np.random.RandomState(5))
    return cfg, state.__class__(**{**state.__dict__, "g_stats": g_stats})


@pytest.fixture(scope="module")
def torch_model(jax_state):
    _, state = jax_state
    model = MultiModalGAN()
    sd = mmgan_state_dict_from_flax(jax.device_get(state.g_params), state.g_stats,
                                    jax.device_get(state.d_params))
    model.load_state_dict(sd, strict=True)
    return model.eval()


def test_generators_match_flax(jax_state, torch_model):
    cfg, state = jax_state
    rng = np.random.RandomState(0)
    for batch in (1, 3):
        n1, n2, beats = (rng.randn(batch, 50).astype(np.float32) for _ in range(3))
        aux = rng.randn(batch, 50).astype(np.float32)
        g1, g2, _ = jax_loop.build_mmgan(cfg)
        ref1 = g1.apply({"params": state.g_params["g1"], "batch_stats": state.g_stats["g1"]},
                        jnp.asarray(n1), jnp.asarray(aux), False)
        ref2 = g2.apply({"params": state.g_params["g2"], "batch_stats": state.g_stats["g2"]},
                        jnp.asarray(n2), jnp.asarray(beats), False)
        with torch.inference_mode():
            out1 = torch_model.generator1(torch.from_numpy(n1), torch.from_numpy(aux))
            out2 = torch_model.generator2(torch.from_numpy(n2), torch.from_numpy(beats))
        assert tuple(out1.shape) == (batch, 64, 64) and tuple(out2.shape) == (batch, 20)
        np.testing.assert_allclose(out1.numpy(), np.asarray(ref1), atol=ATOL, rtol=0)
        np.testing.assert_allclose(out2.numpy(), np.asarray(ref2), atol=ATOL, rtol=0)


def test_eval_forward_matches_jax_eval_forward(jax_state, torch_model):
    """The serving forward at B = 1, aux drawn inside the JAX module from
    key 0 and taken from ``AUX_INPUT`` in the port."""
    cfg, state = jax_state
    rng = np.random.RandomState(1)
    n1, n2 = rng.randn(1, 50).astype(np.float32), rng.randn(1, 50).astype(np.float32)
    beats = np.zeros((1, 50), np.float32)
    ref1, ref2 = jax_loop._eval_forward(cfg)(state.g_params, state.g_stats, n1, n2, beats,
                                             jax.random.key(0))
    out1, out2 = eval_forward(torch_model, n1, n2, beats)
    np.testing.assert_allclose(out1.numpy(), np.asarray(ref1), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref2), atol=ATOL, rtol=0)


def test_aux_input_is_the_jax_eval_draw(jax_state):
    cfg, state = jax_state
    draws = []
    normal = jax.random.normal

    def recording_normal(*args, **kw):
        out = normal(*args, **kw)
        draws.append(np.asarray(out))
        return out

    z = np.zeros((1, 50), np.float32)
    with jax.disable_jit(), mock.patch.object(jax.random, "normal", recording_normal):
        jax_loop._eval_forward(cfg)(state.g_params, state.g_stats, z, z, z, jax.random.key(0))
    assert len(draws) == 1  # G1's aux input; G2 takes the beats
    assert draws[0].dtype == AUX_INPUT.dtype == np.float32
    assert draws[0].shape == AUX_INPUT.shape == (1, 50)
    np.testing.assert_array_equal(draws[0].view(np.uint32), AUX_INPUT.view(np.uint32))


def test_discriminator_cnn_matches_flax(jax_state, torch_model):
    _, state = jax_state
    roll = np.random.RandomState(2).uniform(0, 127, (2, 2, 128, 50)).astype(np.float32)
    ref = JaxDiscriminatorCNN(roll_size=(2, 128, 50)).apply(
        {"params": state.d_params}, jnp.asarray(roll))
    with torch.inference_mode():
        out = torch_model.discriminator(torch.from_numpy(roll))
    assert tuple(out.shape) == (2, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)


def test_exported_checkpoint_loads_strict(jax_state, torch_model, tmp_path):
    """``gandes_tpu.cli export-torch --model mmgan`` output (the reference's
    62-key layout) is the port's ``--torch-checkpoint``: it loads strict and
    equals the direct conversion."""
    _, state = jax_state
    path = str(tmp_path / "mmgan.pth")
    export_mmgan_torch_checkpoint(state, path)
    model = load_mmgan_state(MMGANConfig(), path, device="cpu")
    ours = torch_model.state_dict()
    theirs = model.state_dict()
    assert len(theirs) == 62 and ours.keys() == theirs.keys()
    for k in ours:
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(theirs[k], ours[k], rtol=0, atol=0)


def test_seeded_init_distributions():
    """The port's own init (a torch stream, not jax.random): xavier-normal
    G Linears with zero biases, kaiming-uniform D layers, BN at defaults."""
    model = MultiModalGAN(generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    w = sd["generator1.gen.3.0.weight"]
    assert w.shape == (4096, 64)
    assert abs(float(w.std()) - (2.0 / (64 + 4096)) ** 0.5) < 1e-3
    assert not sd["generator1.gen.0.0.bias"].any()
    assert float(sd["generator1.gen.0.1.weight"].min()) == 1.0
    bound = 1.0 / (2 * 4 * 4) ** 0.5
    assert float(sd["discriminator.conv1.weight"].abs().max()) <= bound
    again = MultiModalGAN(generator=torch.Generator().manual_seed(0)).state_dict()
    for k in sd:
        assert torch.equal(sd[k], again[k])
    assert isinstance(model.discriminator, DiscriminatorCNN)


def _generator_outputs(jax_state):
    """Two samples of the JAX eval forward, with the largest sim wall budget
    (``gen2[5] = 1``), so the sims end by customer count."""
    cfg, state = jax_state
    rng = np.random.RandomState(3)
    n1, n2 = rng.randn(2, 50).astype(np.float32), rng.randn(2, 50).astype(np.float32)
    beats = np.zeros((2, 50), np.float32)
    g1, g2 = jax_loop._eval_forward(cfg)(state.g_params, state.g_stats, n1, n2, beats,
                                         jax.random.key(0))
    g2 = np.array(g2)
    g2[:, 5] = 1.0
    return np.asarray(g1)[:, None], g2


def test_matrix_to_midi_matches_jax(jax_state, torch_model, tmp_path):
    """Generator outputs decoded by both packages after the same global
    seed: equal rolls and equal generation.mid bytes."""
    g1, g2 = _generator_outputs(jax_state)
    runs = {}
    for name, fn in (("jax", jax_matrix_to_midi), ("torch", matrix_to_midi)):
        out_dir = str(tmp_path / name)
        np.random.seed(7)
        rolls, failed = fn(g1, g2, adj_size=(64, 64), instrument=0, start=100, end=150,
                           generate=True, log_path=str(tmp_path / f"{name}_logs") + "/",
                           out_dir=out_dir)
        with open(os.path.join(out_dir, "generation.mid"), "rb") as f:
            runs[name] = (rolls, failed, f.read(), np.random.get_state()[1].copy())
    (ref_rolls, ref_failed, ref_mid, ref_rng), (rolls, failed, mid, rng_after) = (
        runs["jax"], runs["torch"])
    assert failed == ref_failed == 0
    assert len(rolls) == len(ref_rolls) == 2
    for a, b in zip(rolls, ref_rolls):
        assert a.shape == (2, 128, 50)
        np.testing.assert_array_equal(a, b)
    assert mid[:4] == b"MThd" and mid == ref_mid
    assert all(r.any() for r in rolls)  # the decoded songs reach the crop
    np.testing.assert_array_equal(rng_after, ref_rng)


def test_matrix_to_midi_cold_build_is_not_sim_time(jax_state, tmp_path, monkeypatch):
    """A DES library built on first use (here a build that sleeps past the
    watchdog) is loaded before the first sim's deadline is taken: no sample
    fails, and the rolls equal a warm run's."""
    g1, g2 = _generator_outputs(jax_state)
    watchdog, build_s = 1.0, 1.5

    def decode(name):
        np.random.seed(7)
        return matrix_to_midi(g1, g2, adj_size=(64, 64), instrument=0, start=100, end=150,
                              generate=True, log_path=str(tmp_path / f"{name}_logs") + "/",
                              out_dir=str(tmp_path / name), watchdog=watchdog)

    warm_rolls, warm_failed = decode("warm")
    real_build, builds = native.build_native_lib, []

    def slow_build(*args, **kw):
        builds.append(args)
        time.sleep(build_s)
        return real_build(*args, **kw)

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "build_native_lib", slow_build)
    rolls, failed = decode("cold")
    assert len(builds) == 1 and native._lib is not None
    assert failed == warm_failed == 0
    for a, b in zip(rolls, warm_rolls, strict=True):
        np.testing.assert_array_equal(a, b)
    assert all(r.any() for r in rolls)


def test_matrix_to_midi_parallel_mode_is_not_ported():
    with pytest.raises(NotImplementedError, match="parallel"):
        matrix_to_midi(np.zeros((1, 1, 64, 64), np.float32), np.zeros((1, 20), np.float32),
                       adj_size=(64, 64), parallel=1)
