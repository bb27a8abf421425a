"""gandes_tpu_torch DCGAN generator vs the JAX package's.

Weights come from the JAX package's own initialisation (``init_gandes_state``
at full width), cross with ``train/convert.py``, and the eval-mode forwards
agree at 2e-4 (tests/test_torch_forward_parity.py's tolerance). The
reference-layout export of the JAX package loads into the port strictly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gandes_tpu.models.gan_des import DCGANGenerator as JaxDCGAN
from gandes_tpu.models.gan_des import MelDiscriminator
from gandes_tpu.train.loading import gandes_eval_forward as jax_eval_forward
from gandes_tpu.train.steps import init_gandes_state
from gandes_tpu.train.torch_import import export_gandes_torch_checkpoint
from gandes_tpu_torch.models.gan_des import DCGANGenerator
from gandes_tpu_torch.train.convert import dcgan_state_dict_from_flax
from gandes_tpu_torch.train.gandes_loop import GanDesConfig
from gandes_tpu_torch.train.loading import gandes_eval_forward, load_gandes_state

ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    timing-sensitive tests elsewhere need their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_state():
    tx = optax.adam(2e-5, b1=0.5)
    gen = JaxDCGAN()
    state = init_gandes_state(gen, MelDiscriminator(), jax.random.key(0), batch_size=3,
                              g_tx=tx, d_tx=tx)
    # non-trivial running statistics, so eval-mode BN is exercised
    rng = np.random.RandomState(5)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape).astype(np.float32)),
        state.g_stats)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32)),
        state.g_params)
    return gen, state.__class__(**{**state.__dict__, "g_params": params, "g_stats": stats})


def test_dcgan_forward_matches_jax(jax_state):
    gen, state = jax_state
    z = np.random.RandomState(0).randn(3, 100).astype(np.float32)
    ref = np.asarray(jax_eval_forward(gen)(state.g_params, state.g_stats, jnp.asarray(z)))

    port = DCGANGenerator()
    port.load_state_dict(dcgan_state_dict_from_flax(state.g_params, state.g_stats), strict=True)
    out = gandes_eval_forward(port)(torch.from_numpy(z)).numpy()
    assert out.shape == ref.shape == (3, 20, 20)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_export_torch_checkpoint_loads_strictly(jax_state, tmp_path):
    """``gandes_tpu.cli export-torch`` output is the crossing for weights
    trained in the JAX package: it loads into the port as it is."""
    gen, state = jax_state
    path = str(tmp_path / "gen.pt")
    export_gandes_torch_checkpoint(state, path)
    port, extra = load_gandes_state(GanDesConfig(), torch_checkpoint=path, device="cpu")
    assert extra is None and not port.training
    converted = dcgan_state_dict_from_flax(state.g_params, state.g_stats)
    for key, value in port.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            torch.testing.assert_close(value, converted[key], rtol=0, atol=0)


def test_generator_architecture_and_init():
    gen = DCGANGenerator(generator=torch.Generator().manual_seed(0))
    names = {k for k in gen.state_dict() if not k.endswith("num_batches_tracked")}
    expected = {f"conv{i}.weight" for i in range(1, 5)} | {
        f"batch_norm{i}.{s}" for i in range(1, 4)
        for s in ("weight", "bias", "running_mean", "running_var")}
    assert names == expected
    assert tuple(gen.conv1.weight.shape) == (100, 128, 4, 4)
    assert tuple(gen.conv4.weight.shape) == (32, 1, 5, 5)
    assert gen.batch_norm1.momentum == 0.1 and gen.batch_norm1.eps == 1e-5
    # N(0, 0.02) kernels and the reference's N(0, 0.02) BN scale quirk
    for p in (gen.conv2.weight, gen.batch_norm1.weight):
        assert abs(float(p.mean())) < 0.005 and 0.015 < float(p.std()) < 0.025
    assert float(gen.batch_norm1.bias.abs().max()) == 0.0
    same = DCGANGenerator(generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(same.conv3.weight, gen.conv3.weight, rtol=0, atol=0)
    out = gandes_eval_forward(gen.eval())(torch.randn(2, 100))
    assert out.shape == (2, 20, 20) and bool(((out >= 0) & (out <= 1)).all())
