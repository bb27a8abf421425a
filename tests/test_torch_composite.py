"""gandes_tpu_torch.models.composite against the JAX package's
``gandes_tpu/models/composite.py``, on weights carried across and the same
numpy inputs.

* ``MultiModalGAN`` with ``decode=None``: train-mode G1/G2 (G1's aux input
  recorded from the JAX forward's ``jax.random.normal`` and passed as
  ``aux``), the DES round trip through each package's own
  ``matrix_to_midi`` with the constructor's arguments (the global numpy
  stream seeded alike), D's logits at atol 2e-4 (the forward tolerance of
  ``tests/test_torch_forward_parity.py``) and the failed counts equal; B = 3,
  since at B = 2 a train-mode BatchNorm maps each unit to +-1 and G's
  outputs sit on the decode's thresholds. Then ``generate_midi``: eval-mode
  G on the running statistics both forwards updated (G1's aux
  ``AUX_INPUT``, the JAX B = 1 draw) against the JAX composite's, and
  ``generation.mid``'s bytes against the JAX decode of the same matrices.
* ``SimNN``: the five heads against flax through
  ``simnn_state_dict_from_flax`` (flax flattens NHWC), square and
  non-square inputs, atol 1e-5; ``pretrain_model``'s losses over two epochs
  of two batches against the JAX method's, rtol 1e-5 (the first loss) and
  1e-4 after Adam steps.
* A JAX-style positional ``count`` raises a TypeError naming ``count=``.
"""

import copy
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from gandes_tpu.bridge.mmgan_decode import matrix_to_midi as jax_matrix_to_midi
from gandes_tpu.des import native as jax_native
from gandes_tpu.models.composite import MultiModalGAN as JaxMultiModalGAN
from gandes_tpu.models.composite import SimNN as JaxSimNN
from gandes_tpu.train import mmgan_loop as jax_loop
from gandes_tpu_torch.des import native
from gandes_tpu_torch.models import MultiModalGAN, SimNN
from gandes_tpu_torch.train.convert import mmgan_state_dict_from_flax, simnn_state_dict_from_flax
from gandes_tpu_torch.train.mmgan_loop import eval_forward

ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def composites(tmp_path_factory):
    """Both composites on the JAX composite's weights (seed 0), each writing
    into its own directories; the native DES cores loaded before any sim."""
    assert jax_native.get_lib() is not None and native.get_lib() is not None
    root = tmp_path_factory.mktemp("composite")
    kw = dict(z_dim=50, adj_size=(64, 64), roll_size=(2, 128, 50), input_dim=50,
              output_dim=20, instrument=0, start=0, end=50)
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = (str(root / name / "logs") + "/", str(root / name / "midi"))
        os.makedirs(dirs[name][0])
    jmodel = JaxMultiModalGAN(**kw, log_path=dirs["jax"][0], out_dir=dirs["jax"][1])
    pmodel = MultiModalGAN(**kw, log_path=dirs["port"][0], out_dir=dirs["port"][1])
    state = jax.device_get(jmodel.state)
    pmodel.load_state_dict(mmgan_state_dict_from_flax(state.g_params, state.g_stats,
                                                      state.d_params), strict=True)
    return jmodel, pmodel, dirs


def _jax_forward_recording_aux(jmodel, *args, **kw):
    draws = []
    normal = jax.random.normal

    def recording_normal(*a, **k):
        out = normal(*a, **k)
        draws.append(np.asarray(out))
        return out

    with jax.disable_jit(), mock.patch.object(jax.random, "normal", recording_normal):
        out = jmodel(*args, **kw)
    (aux,) = draws  # G1's aux input; G2 takes the beats
    return out, aux.copy()


def test_forward_decodes_with_its_own_arguments_as_jax(composites):
    jmodel, pmodel, dirs = composites
    rng = np.random.RandomState(5)
    noise1, noise2 = (rng.randn(3, 50).astype(np.float32) for _ in range(2))
    beats = np.zeros((3, 50), np.float32)
    np.random.seed(5)
    (j_logits, j_failed), aux = _jax_forward_recording_aux(jmodel, noise1, noise2, beats,
                                                           count=1)
    np.random.seed(5)
    p_logits, p_failed = pmodel.train()(noise1, noise2, beats, count=1, aux=aux)
    assert tuple(p_logits.shape) == (3, 1) and p_failed == j_failed
    np.testing.assert_allclose(p_logits.detach().numpy(), np.asarray(j_logits), atol=ATOL,
                               rtol=0)
    # the positional decode callable of the training loop still takes over
    # (on a copy: a train-mode forward moves the BatchNorm statistics, which
    # the next test holds to the JAX composite's)
    calls = []

    def decode(mats, vec, count):
        calls.append((tuple(mats.shape), tuple(vec.shape), count))
        return torch.zeros(3, 2, 128, 50), 2

    logits, failed = copy.deepcopy(pmodel)(noise1, noise2, beats, decode, 4, aux=aux)
    assert calls == [((3, 64, 64), (3, 20), 4)] and failed == 2
    assert tuple(logits.shape) == (3, 1)


def test_forward_refuses_a_positional_count():
    """The JAX composite's fourth positional argument is ``count``, the
    port's ``decode`` (an intended divergence): a JAX-style call raises a
    TypeError that names ``count=``, before any work."""
    model = MultiModalGAN()
    noise = np.zeros((2, 50), np.float32)
    with pytest.raises(TypeError, match="pass count= by keyword"):
        model(noise, noise, noise, 3)


def test_generate_midi_writes_the_jax_composites_midi(composites, tmp_path):
    """Eval-mode G on the running statistics the forward test moved in both
    packages equals the JAX composite's; the MIDI is the JAX decode's of
    the port's own G outputs (the decode takes ``int(x * 126)`` and other
    steps of matrix entries, so last-bit differences between the packages'
    G outputs may change a note: each package's matrices are decoded in
    both, as the loop parity tests do)."""
    jmodel, pmodel, dirs = composites
    rng = np.random.RandomState(6)
    noise1, noise2 = rng.randn(1, 50).astype(np.float32), rng.randn(1, 50).astype(np.float32)
    beats = np.zeros((1, 50), np.float32)
    np.random.seed(6)
    p_rolls = pmodel.generate_midi(noise1, noise2, beats)
    assert not pmodel.training and p_rolls[0].shape == (2, 128, 50)
    mats, vec = eval_forward(pmodel, noise1, noise2, beats)
    ref1, ref2 = jax_loop._eval_forward(jax_loop.MMGANConfig())(
        jmodel.state.g_params, jmodel.state.g_stats, noise1, noise2, beats, jax.random.key(0))
    np.testing.assert_allclose(mats.numpy(), np.asarray(ref1), atol=ATOL, rtol=0)
    np.testing.assert_allclose(vec.numpy(), np.asarray(ref2), atol=ATOL, rtol=0)
    np.random.seed(6)
    j_rolls, _ = jax_matrix_to_midi(mats.numpy()[:, None], vec.numpy(), adj_size=(64, 64),
                                    instrument=0, start=0, end=50, generate=True,
                                    log_path=dirs["jax"][0], out_dir=str(tmp_path))
    np.testing.assert_array_equal(p_rolls[0], j_rolls[0])
    with open(tmp_path / "generation.mid", "rb") as f:
        j_mid = f.read()
    with open(os.path.join(dirs["port"][1], "generation.mid"), "rb") as f:
        p_mid = f.read()
    assert p_mid[:4] == b"MThd" and p_mid == j_mid


@pytest.mark.parametrize("n,hw", [(10, (64, 64)), (4, (30, 34))])
def test_simnn_heads_match_flax(n, hw):
    jmodel = JaxSimNN(n)
    x = np.random.RandomState(0).randn(2, 1, *hw).astype(np.float32)
    v = jmodel.init(jax.random.key(0), x)
    ref = jmodel.apply(v, x)
    model = SimNN.create_model(n, hw)
    model.load_state_dict(simnn_state_dict_from_flax(jax.device_get(v["params"]), n, hw),
                          strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert [tuple(o.shape) for o in out] == [(2, n, n)] + [(2, n)] * 4
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5, rtol=0)
    assert SimNN.error_system(out) is None


def test_simnn_pretrain_losses_match_jax():
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(2):
        x = rng.randn(2, 1, 32, 32).astype(np.float32)
        targets = (rng.randn(2, 4, 4).astype(np.float32),
                   *(rng.randn(2, 4).astype(np.float32) for _ in range(4)))
        batches.append((x, targets))
    jmodel = JaxSimNN.create_model(4)
    v = jmodel.init(jax.random.key(0), batches[0][0])
    _, ref = jmodel.pretrain_model(v, batches, num_epochs=2, lr=1e-3)
    model = SimNN.create_model(4, (32, 32))
    model.load_state_dict(simnn_state_dict_from_flax(jax.device_get(v["params"]), 4, (32, 32)),
                          strict=True)
    losses = model.pretrain_model(batches, num_epochs=2, lr=1e-3)
    assert len(losses) == len(ref) == 4 and all(np.isfinite(losses))
    np.testing.assert_allclose(losses[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(losses, ref, rtol=1e-4)
    assert losses[-1] < losses[1]
