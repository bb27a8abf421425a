"""The port's GAN-DES training vs the JAX package, on the CPU.

The same numpy inputs (``np.random.RandomState``) go through the JAX
package's functions and the port's; JAX weights and optimizer states cross
through ``gandes_train_state_from_flax`` / ``mel_surrogate_state_from_flax``.

Tolerances:

* forwards atol 2e-4; BatchNorm running statistics rtol 1e-5;
* losses (and ``s_loss`` / ``reward``) rtol 1e-5; D's gradients and both
  Adams' moments rtol 1e-5 with an absolute floor of 2e-6 of each tensor's
  largest element (one Adam step's tolerance; elements that cancel to near
  zero carry float32 summation noise only);
* params after one Adam step atol 2e-6 where both packages' gradients have
  one sign: Adam's first step maps g to lr * g / (|g| + 1e-8), so an element
  whose gradient is within float32 error of zero steps by +-lr at random in
  either package (``tests/test_torch_mmgan_train.py``);
* G's gradients in ``surrogate`` / ``reinforce`` mode are compared through
  one and the same post-update D (and surrogate): each package's own
  post-update D differs from the other's by those +-lr flips, and G's
  gradient is read through it. Through its own D each step's G moments are
  held at rtol 1e-4 / atol 1e-5 of the largest.
* mels: 0.05 dB on bins more than 10 dB above the 80 dB floor
  (``tests/test_torch_gandes_serve.py``); near the floor a sample that
  truncates to the other int16 step in one package moves a bin by up to
  0.203 dB (measured on a third step of the reinforce loop), so every bin
  is held at 0.5 dB.
* loss histories (two steps) rtol 1e-4: from the second step on, each
  package's D has taken its own Adam steps, whose +-lr flips at
  noise-level gradients (above) move the post-update losses: measured
  8e-6 at the second step, and up to 2.2e-4 at a third (``none`` 1.8e-4,
  ``reinforce`` 2.2e-4, ``surrogate`` 8.5e-5).

The loop tests run B = 2, 120 customers and a 0.3 s DES budget (the JAX
loop tests' band: the sims end by customer count), one torch thread and at
most two sim threads.
"""

import copy
import os
import random

import jax
import numpy as np
import optax
import pytest
import torch

from gandes_tpu.data import datasets as jax_datasets
from gandes_tpu.des import native as jax_native
from gandes_tpu.models.gan_des import DCGANGenerator as JaxDCGAN
from gandes_tpu.models.gan_des import MelDiscriminator as JaxMelD
from gandes_tpu.models.surrogate import MelSurrogate as JaxMelSurrogate
from gandes_tpu.train import gandes_loop as jax_loop
from gandes_tpu.train import steps as jax_steps
from gandes_tpu.train.torch_import import load_gandes_torch_checkpoint
from gandes_tpu_torch import cli
from gandes_tpu_torch.data import datasets
from gandes_tpu_torch.des import native
from gandes_tpu_torch.models.gan_des import FlaxBatchNorm2d
from gandes_tpu_torch.train import checkpoint as ckpt
from gandes_tpu_torch.train import gandes_loop
from gandes_tpu_torch.train.convert import (
    dcgan_state_dict_from_flax,
    gandes_train_state_from_flax,
    mel_disc_state_dict_from_flax,
    mel_surrogate_state_dict_from_flax,
    mel_surrogate_state_from_flax,
)
from gandes_tpu_torch.train.loading import load_gandes_state
from gandes_tpu_torch.train.steps import (
    make_gandes_gen_forward,
    make_gandes_train_step,
    make_gandes_train_step_reinforce,
    make_gandes_train_step_surrogate,
    reinforce_g_loss_and_grads,
    surrogate_g_loss_and_grads,
)

B = 2
LR = 2e-5  # the reference's
S_LR = 1e-3
SIGMA = 0.05
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-6
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


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


@pytest.fixture(scope="module")
def jax_setup():
    """The JAX GAN-DES at GanDesConfig() widths from seed 0 (lr 2e-5), its
    MelSurrogate from seed 2, their optax transforms and the three steps,
    jitted once; the port's config."""
    gen, disc, s_model = JaxDCGAN(), JaxMelD(), JaxMelSurrogate()
    tx = optax.adam(LR, b1=0.5, b2=0.999)
    s_tx = optax.adam(S_LR)
    # jitted: the eager flax init dispatches op by op (~11 s against ~4 s)
    state = jax.jit(lambda key: jax_steps.init_gandes_state(
        gen, disc, key, batch_size=B, g_tx=tx, d_tx=tx))(jax.random.key(0))
    s_state = jax.jit(lambda key: jax_steps.init_surrogate_state(
        s_model, key, batch_size=B, adj_size=(20, 20), s_tx=s_tx))(jax.random.key(2))
    steps = {"none": jax.jit(jax_steps.make_gandes_train_step(gen, disc, tx, tx)),
             "surrogate": jax.jit(jax_steps.make_gandes_train_step_surrogate(
                 gen, disc, s_model, tx, tx, s_tx)),
             "reinforce": jax.jit(jax_steps.make_gandes_train_step_reinforce(
                 gen, disc, tx, tx, sigma=SIGMA)),
             "forward": jax.jit(jax_steps.make_gandes_gen_forward(gen))}
    pcfg = gandes_loop.GanDesConfig(lr=LR, surrogate_lr=S_LR, reinforce_sigma=SIGMA)
    return {"models": (gen, disc, s_model), "state": state, "s_state": s_state,
            "steps": steps, "pcfg": pcfg}


def _port_state(setup, state=None):
    return gandes_train_state_from_flax(jax.device_get(state or setup["state"]), setup["pcfg"])


def _port_surrogate(setup, s_state=None):
    if s_state is not None:
        return mel_surrogate_state_from_flax(jax.device_get(s_state), setup["pcfg"])
    if "port_s_state" not in setup:  # its 14M-weight init takes ~1 s: convert once
        setup["port_s_state"] = mel_surrogate_state_from_flax(
            jax.device_get(setup["s_state"]), setup["pcfg"])
    return copy.deepcopy(setup["port_s_state"])


def _inputs(seed, batch=B, scale=4.0):
    """Mels in [-scale, 0) (D is not saturated on them at scale 4), noise, and
    matrices in [0, 1)."""
    rng = np.random.RandomState(seed)
    real, fake = (rng.rand(batch, 128, 216).astype(np.float32) * scale - scale
                  for _ in range(2))
    noise = rng.randn(batch, 100).astype(np.float32)
    return real, fake, noise, rng.rand(batch, 20, 20).astype(np.float32)


def _step_inputs(setup, seed):
    """``_inputs`` for one step, with the second fake mel at mel-dB scale (D
    tells the two fakes far apart, so the reinforce advantages are not
    rounding noise: with two near-equal rewards, float32's rounding of their
    mean alone moves the advantages, and so the loss, by ~1e-4 relative) and
    the matrices sampled as the reinforce loop samples them: G's train-mode
    output plus sigma * N, clipped to [0, 1]."""
    real, fake, noise, _ = _inputs(seed)
    fake[1] *= 10.0
    mu = np.asarray(setup["steps"]["forward"](setup["state"], noise)[0])
    eps = np.random.RandomState(seed + 1).randn(*mu.shape)
    return real, fake, noise, np.clip(mu + SIGMA * eps, 0.0, 1.0).astype(np.float32)


# ------------------------------------------------------------------ forwards


def test_mel_discriminator_matches_flax(jax_setup):
    """Forward at 2e-4 (NHWC flatten permuted into fc1), on mel-dB scale
    inputs and on small ones."""
    _, disc, _ = jax_setup["models"]
    params = jax.device_get(jax_setup["state"].d_params)
    port = _port_state(jax_setup).disc
    for scale in (80.0, 4.0):
        mel = _inputs(1, 3, scale)[0]
        ref = np.asarray(jax.jit(disc.apply)({"params": params}, mel))
        out = port(_t(mel)).detach().numpy()
        assert out.shape == ref.shape == (3, 1)
        np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
    assert port.fc1.in_features == 32 * 32 * 54


def test_mel_surrogate_matches_flax(jax_setup):
    _, _, s_model = jax_setup["models"]
    params = jax.device_get(jax_setup["s_state"].params)
    port = _port_surrogate(jax_setup).model
    mats = _inputs(2)[3]
    ref = np.asarray(jax.jit(s_model.apply)({"params": params}, mats))
    out = port(_t(mats)).detach().numpy()
    assert out.shape == ref.shape == (B, 128, 216)
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
    # lecun_normal_ draws flax Dense's distribution: truncated at 2 std,
    # std sqrt(1 / fan_in)
    w = gandes_loop.init_surrogate_for_config(gandes_loop.GanDesConfig(), "cpu").model.fc2.weight
    bound = 2 * np.sqrt(1 / 512) / 0.87962566
    w = w.detach()
    assert float(w.abs().max()) <= bound and abs(float(w.std()) - np.sqrt(1 / 512)) < 2e-3


@pytest.mark.parametrize("batch", [2, 16])
def test_train_mode_gen_forward_matches_flax(jax_setup, batch):
    """Train-mode DCGAN outputs and the BN running statistics they leave,
    from non-trivial running statistics, against flax's."""
    rng = np.random.RandomState(10 + batch)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.uniform(0.5, 2.0, x.shape) if path[-1].key == "var"
                         else rng.normal(0.0, 0.5, x.shape)).astype(np.float32),
        jax.device_get(jax_setup["state"].g_stats))
    state = jax_setup["state"].__class__(**{**jax_setup["state"].__dict__, "g_stats": stats})
    noise = _inputs(20 + batch, batch)[2]
    ref, new_stats = jax_setup["steps"]["forward"](state, noise)
    port = _port_state(jax_setup, state)
    mats = make_gandes_gen_forward()(port, _t(noise))
    assert tuple(mats.shape) == (batch, 20, 20)
    np.testing.assert_allclose(mats.numpy(), np.asarray(ref), atol=2e-4, rtol=0)
    ref_sd = dcgan_state_dict_from_flax(jax.device_get(state.g_params),
                                        jax.device_get(new_stats))
    sd = port.gen.state_dict()
    for name in sd:
        if "running_" in name:
            torch.testing.assert_close(sd[name], ref_sd[name], rtol=1e-5, atol=1e-7,
                                       msg=lambda m: f"{name}: {m}")


def test_plain_batchnorm2d_update_is_n_over_n_minus_1_off():
    """``nn.BatchNorm2d`` raises the running variance by n/(n-1) times flax's
    increment, n = N*H*W (2*4*4 = 32 here); the port's BatchNorm takes
    flax's, normalises the same, and ``update_stats=False`` leaves the
    statistics."""
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 8, 4, 4).astype(np.float32) * 3 + 1)
    ours, plain = FlaxBatchNorm2d(8), torch.nn.BatchNorm2d(8)
    for bn in (ours, plain):
        bn.running_var.fill_(2.0)
    y_ours, y_plain = ours(x), plain(x)
    torch.testing.assert_close(y_ours, y_plain, rtol=0, atol=1e-5)
    var = x.double().var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(ours.running_var.double(), 0.9 * 2.0 + 0.1 * var, rtol=1e-6,
                               atol=0)
    ratio = (plain.running_var - 0.9 * 2.0) / (ours.running_var - 0.9 * 2.0)
    torch.testing.assert_close(ratio, torch.full_like(ratio, 32 / 31), rtol=1e-4, atol=0)
    before = ours.running_var.clone(), ours.running_mean.clone()
    torch.testing.assert_close(ours(x, update_stats=False), y_ours, rtol=0, atol=0)
    assert torch.equal(ours.running_var, before[0]) and torch.equal(ours.running_mean, before[1])
    ours.eval()
    plain.load_state_dict(ours.state_dict())
    plain.eval()
    assert torch.equal(ours(x), plain(x))  # eval mode is nn.BatchNorm2d's


# ------------------------------------------------------------------ one step


def _assert_close_floor(name, a, ref, rtol, floor):
    """rtol with an absolute floor of ``floor`` times the reference tensor's
    largest element."""
    torch.testing.assert_close(a, ref, rtol=rtol, atol=floor * float(ref.abs().max()),
                               msg=lambda m: f"{name}: {m}")


def _assert_adam_matches(opt, jax_opt, named, moments_sd, rtol=1e-5, floor=PARAM_ATOL):
    """Each param's exp_avg / exp_avg_sq against optax's mu / nu (already
    in the port's layout), and the counts."""
    adam = jax_opt[0]
    for key, ref_sd in zip(("exp_avg", "exp_avg_sq"), moments_sd):
        for name, p in named:
            st = opt.state[p]
            assert float(st["step"]) == int(adam.count)
            _assert_close_floor(f"{name} {key}", st[key], ref_sd[name], rtol, floor)


def _assert_param_matches(name, p, ref, ref_grad):
    """atol 2e-6 wherever the two packages' gradients have one sign. Adam's
    first step moves each element by ~lr * sign(g), so where the signs
    differ the params land ~2 lr apart: those elements must be ones whose
    gradient is within the gradient tolerance of zero (float32 noise)."""
    flipped = torch.sign(p.grad) != torch.sign(ref_grad)
    torch.testing.assert_close(p.detach()[~flipped], ref[~flipped], rtol=0, atol=PARAM_ATOL,
                               msg=lambda m: f"{name}: {m}")
    if flipped.any():
        top = float(ref_grad.abs().max())
        assert float(ref_grad.abs()[flipped].max()) <= PARAM_ATOL * top, name
        assert float((p.detach() - ref).abs()[flipped].max()) <= 2.5 * LR, name


def _run_port_step(setup, mode, real, fake, noise, mats_s):
    port = _port_state(setup)
    args = [_t(a) for a in (real, fake, noise, mats_s)]
    if mode == "surrogate":
        s_state = _port_surrogate(setup)
        return make_gandes_train_step_surrogate()(port, s_state, args[0], args[1], args[3],
                                                  args[2])
    if mode == "reinforce":
        return (*make_gandes_train_step_reinforce(SIGMA)(port, args[0], args[1], args[3],
                                                        args[2]), None)
    return (*make_gandes_train_step()(port, args[0], args[1]), None)


@pytest.mark.parametrize("mode", ["none", "surrogate", "reinforce"])
def test_train_step_matches_jax(jax_setup, mode):
    """One step of each mode from one state: losses (and s_loss / reward),
    D's gradients (against ``jax.grad`` of the JAX D loss), D's params and
    both Adams' moments and counts; ``none`` leaves G bit for bit; G's
    gradients through the JAX step's own post-update D (and surrogate)
    against the JAX step's (2 * mu after one step)."""
    real, fake, noise, mats_s = _step_inputs(jax_setup, 0)
    if mode == "surrogate":
        jax_state, jax_s, jax_metrics = jax_setup["steps"][mode](
            jax_setup["state"], jax_setup["s_state"], real, fake, mats_s, noise)
        port, port_s, metrics = _run_port_step(jax_setup, mode, real, fake, noise, mats_s)
    else:
        args = (real, fake, mats_s, noise) if mode == "reinforce" else (real, fake)
        jax_state, jax_metrics = jax_setup["steps"][mode](jax_setup["state"], *args)
        port, metrics, _ = _run_port_step(jax_setup, mode, real, fake, noise, mats_s)
    keys = {"none": ["d_loss", "g_loss"], "surrogate": ["d_loss", "g_loss", "s_loss"],
            "reinforce": ["d_loss", "g_loss", "reward"]}[mode]
    assert sorted(metrics) == sorted(jax_metrics) == sorted(keys)
    for k in keys:
        np.testing.assert_allclose(float(metrics[k]), float(jax_metrics[k]), rtol=LOSS_RTOL,
                                   err_msg=k)

    # D: gradients, params after Adam, moments
    _, disc, _ = jax_setup["models"]
    d_grads = jax.device_get(jax.jit(jax.grad(jax_steps._make_gandes_d_loss(disc)))(
        jax_setup["state"].d_params, real, fake))
    ref_grads = mel_disc_state_dict_from_flax(d_grads)
    js = jax.device_get(jax_state)
    ref_d = mel_disc_state_dict_from_flax(js.d_params)
    d_named = list(port.disc.named_parameters())
    for name, p in d_named:
        _assert_close_floor(f"{name} grad", p.grad, ref_grads[name], 1e-5, PARAM_ATOL)
        _assert_param_matches(name, p, ref_d[name], ref_grads[name])
    _assert_adam_matches(port.d_opt, js.d_opt, d_named,
                         [mel_disc_state_dict_from_flax(t) for t in (js.d_opt[0].mu,
                                                                    js.d_opt[0].nu)])
    assert port.step == int(js.step) == 1

    g_named = list(port.gen.named_parameters())
    g_moments = [dcgan_state_dict_from_flax(t, js.g_stats) for t in (js.g_opt[0].mu,
                                                                     js.g_opt[0].nu)]
    before = _port_state(jax_setup).gen.state_dict()
    if mode == "none":  # zero gradients: G bit for bit, its Adam counted
        assert all(torch.equal(p.detach(), before[n]) for n, p in g_named)
        _assert_adam_matches(port.g_opt, js.g_opt, g_named, g_moments)
        return
    # through its own post-update D: moments at rtol 1e-4 / atol 1e-5
    _assert_adam_matches(port.g_opt, js.g_opt, g_named, g_moments, rtol=1e-4, floor=1e-5)
    # through the JAX step's post-update D (and surrogate): G's gradients
    # against the JAX step's, 2 * mu (mu = (1 - 0.5) g after one step)
    pinned = _port_state(jax_setup)
    pinned.disc.load_state_dict(ref_d)
    if mode == "surrogate":
        s_pinned = _port_surrogate(jax_setup, jax_s)
        _, grads = surrogate_g_loss_and_grads(pinned, s_pinned.model, _t(fake), _t(noise))
        np.testing.assert_allclose(float(metrics["s_loss"]), float(jax_metrics["s_loss"]),
                                   rtol=LOSS_RTOL)
        s_ref = mel_surrogate_state_dict_from_flax(jax.device_get(jax_s.params))
        for name, p in port_s.model.named_parameters():
            torch.testing.assert_close(p.detach(), s_ref[name], rtol=0, atol=PARAM_ATOL,
                                       msg=lambda m: f"surrogate {name}: {m}")
        assert port_s.step == int(jax_s.step) == 1
    else:
        _, grads, _ = reinforce_g_loss_and_grads(pinned, _t(fake), _t(mats_s), _t(noise), SIGMA)
    for (name, _), g in zip(g_named, grads, strict=True):
        _assert_close_floor(f"G {name} grad", g, 2 * g_moments[0][name], 1e-5, 1e-5)
    moved = [n for n, p in g_named if not torch.equal(p.detach(), before[n])]
    assert len(moved) == len(g_named)  # every G param stepped


def test_reinforce_takes_the_population_std():
    """The advantages are standardised with the population std (``jnp.std``):
    at B = 2 they are +-1/(1 + 1e-6 / half the reward gap), where
    ``torch.std``'s default (correction 1) would give +-1/sqrt(2). And a
    sigma that is not > 0 raises."""
    cfg = gandes_loop.GanDesConfig()
    state = gandes_loop.init_state_for_config(cfg, "cpu")
    real, fake, noise, mats_s = (_t(a) for a in _inputs(5))
    fake[1] *= 10.0  # two rewards far apart (see _step_inputs)
    loss, _, reward = reinforce_g_loss_and_grads(state, fake, mats_s, noise, SIGMA)
    with torch.no_grad():
        r = torch.log(state.disc(fake).reshape(-1).clamp(1e-7, 1.0)).double()
        mu = state.gen(noise, update_stats=False).double()
    logprob = -((mats_s.double() - mu) ** 2).sum((1, 2)) / (2 * SIGMA ** 2)
    for correction, equal in ((0, True), (1, False)):
        adv = (r - r.mean()) / (r.std(correction=correction) + 1e-6)
        expected = float(-(adv * logprob).mean())
        assert (float(loss.detach()) == pytest.approx(expected, rel=1e-5)) is equal
    assert float(reward) == pytest.approx(float(r.mean()), rel=1e-6)
    for sigma in (0.0, -0.1):
        with pytest.raises(ValueError, match="sigma"):
            make_gandes_train_step_reinforce(sigma)


# ---------------------------------------------------------------------- loop


def _jax_draws(seed, count, batch, reinforce):
    """The JAX loop's counted draws at step ``count``: its noise, and the
    reinforce perturbation (standard normal, unscaled)."""
    noise = np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.key(seed + 1), count), (batch, 100)))
    if not reinforce:
        return _t(noise), None
    eps = np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.key(seed + 3), count), (batch, 20, 20)))
    return _t(noise), _t(eps)


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(B, 128, 216).astype(np.float32) * 40 - 40 for _ in range(n)]


def _loop_cfg(module, tmp_path, name, **kw):
    return module.GanDesConfig(**{
        "batch_size": B, "lr": LR, "number_of_customers": 120, "max_sim_time": 0.3,
        "model_path": str(tmp_path / name / "models"), "out_dir": str(tmp_path / name / "out"),
        "log_path": str(tmp_path / name / "logs") + "/", "display_step": 1, **kw})


def _recording(monkeypatch, module, name, log):
    real = getattr(module, name)

    def recorder(*args, **kw):
        out = real(*args, **kw)
        log.append((args, kw, out))
        return out

    monkeypatch.setattr(module, name, recorder)


def _assert_mels_close(a, b, where):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, where
    for i in range(len(a)):
        above = b[i] > b[i].min() + 10.0
        np.testing.assert_allclose(a[i][above], b[i][above], atol=DB_ATOL, err_msg=where)
        np.testing.assert_allclose(a[i], b[i], atol=FLOOR_DB_ATOL, err_msg=where)


@pytest.mark.parametrize("mode,des_parallel", [("none", None), ("surrogate", 2),
                                               ("reinforce", None)])
def test_loop_histories_match_jax(jax_setup, tmp_path, monkeypatch, mode, des_parallel):
    """2 steps from one initial state (the module's JAX states, patched into
    both loops) and the JAX loop's draws, after the same np.random.seed: G's
    matrices at atol 2e-4, fake mels within the mel tolerance, losses at
    rtol 1e-4; with ``des_parallel=2`` both loops decode through their
    concurrent native host stage on two sim threads.

    The port's host stage decodes the JAX loop's matrices: the decode takes
    ``int(x * 126)`` of matrix entries (instruments, note levels), and the
    initial DCGAN's outputs sit at ~0.5 = 63/126, where a 1-ulp difference
    between the packages' G outputs flips a note and the whole clip."""
    monkeypatch.chdir(tmp_path)
    batches = _batches(2)
    jax_decodes, decodes = [], []
    monkeypatch.setattr(jax_loop, "init_gandes_state", lambda *a, **k: jax_setup["state"])
    monkeypatch.setattr(jax_steps, "init_surrogate_state", lambda *a, **k: jax_setup["s_state"])
    _recording(monkeypatch, jax_loop, "matrix_to_wav", jax_decodes)
    kw = {"g_update": mode, "des_parallel": des_parallel, "write_wav": False}
    jcfg = _loop_cfg(jax_loop, tmp_path, "jax", surrogate_lr=S_LR, reinforce_sigma=SIGMA, **kw)
    np.random.seed(0)
    _, jax_history = jax_loop.train_gandes(iter(batches), jcfg)

    cfg = _loop_cfg(gandes_loop, tmp_path, "torch", surrogate_lr=S_LR, reinforce_sigma=SIGMA,
                    **kw)
    monkeypatch.setattr(gandes_loop, "init_state_for_config",
                        lambda cfg, device: _port_state(jax_setup))
    monkeypatch.setattr(gandes_loop, "init_surrogate_for_config",
                        lambda cfg, device: _port_surrogate(jax_setup))
    draws = []
    monkeypatch.setattr(gandes_loop, "draw_step_inputs",
                        lambda seed, count, batch, z, device, perturb=False:
                        draws.append(count) or _jax_draws(seed, count, batch, perturb))
    port_decode = gandes_loop.matrix_to_wav

    def decode_jax_matrices(mats, **kw):
        jmats = jax_decodes[len(decodes)][0][0]
        np.testing.assert_allclose(mats, jmats, atol=2e-4,
                                   err_msg=f"step {len(decodes)} matrices")
        decodes.append((kw, port_decode(np.asarray(jmats), **kw)))
        return decodes[-1][1]

    monkeypatch.setattr(gandes_loop, "matrix_to_wav", decode_jax_matrices)
    np.random.seed(0)
    _, history = gandes_loop.train_gandes(iter(batches), cfg, device="cpu")

    assert draws == [0, 1] and len(decodes) == len(jax_decodes) == 2
    assert {kw["parallel"] for kw, _ in decodes} == {des_parallel}
    for i, ((_, mel), (_, jkw, jmel)) in enumerate(zip(decodes, jax_decodes)):
        assert jkw["parallel"] == des_parallel
        _assert_mels_close(mel, jmel, f"step {i} mels")
    for key in ("disc", "gen"):
        assert len(history[key]) == len(jax_history[key]) == 2
        np.testing.assert_allclose(history[key], jax_history[key], rtol=1e-4, err_msg=key)
    assert all(np.isfinite(history["disc"] + history["gen"]))


def _assert_state_equal(a, b):
    for x, y in ((a.gen.state_dict(), b.gen.state_dict()),
                 (a.disc.state_dict(), b.disc.state_dict())):
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
    for oa, ob in ((a.g_opt, b.g_opt), (a.d_opt, b.d_opt)):
        for pa, pb in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
            assert all(torch.equal(oa.state[pa][k], ob.state[pb][k])
                       for k in ("step", "exp_avg", "exp_avg_sq"))
    assert a.step == b.step


def test_resume_is_bitwise(tmp_path, monkeypatch):
    """``surrogate`` mode, 4 straight steps == 3 steps (checkpoint at step 2,
    state.step 3), then a resumed run to 4 that restores the checkpoint and
    its ``_surrogate`` companion, fast-forwards the data past the 3 trained batches, continues
    the noise stream at count 3 and, in the same process, the global numpy
    stream: states and losses bit for bit."""
    monkeypatch.chdir(tmp_path)
    batches = _batches(4, seed=1)
    draws = []
    real_draw = gandes_loop.draw_step_inputs
    monkeypatch.setattr(gandes_loop, "draw_step_inputs",
                        lambda *a, **k: draws.append(a[1]) or real_draw(*a, **k))
    kw = {"g_update": "surrogate", "save_step": 2, "resume": True, "write_wav": False}
    np.random.seed(2)
    straight, history = gandes_loop.train_gandes(
        iter(batches), _loop_cfg(gandes_loop, tmp_path, "straight", **kw), max_steps=4,
        device="cpu")
    assert draws == [0, 1, 2, 3]
    draws.clear()
    np.random.seed(2)
    cfg = _loop_cfg(gandes_loop, tmp_path, "split", **kw)
    _, first = gandes_loop.train_gandes(iter(batches), cfg, max_steps=3, device="cpu")
    names = sorted(os.listdir(cfg.model_path))
    assert len(names) == 2 and names[0].startswith("gen_2_")
    assert names[1] == names[0] + "_surrogate"
    assert sorted(os.listdir(os.path.join(cfg.model_path, names[0]))) == [
        "disc.pth", "model.pth", "optim.pt"]
    resumed, second = gandes_loop.train_gandes(iter(batches), cfg, max_steps=4, device="cpu")
    assert draws == [0, 1, 2, 3]
    _assert_state_equal(resumed, straight)
    assert resumed.step == 4
    # the surrogate's own state, restored from the companion, continued too
    # (train_gandes returns G/D's state; its last s_loss is in the history)
    for key in ("disc", "gen"):
        assert first[key] + second[key] == history[key]


# ----------------------------------------------------------------- datasets


def test_gandes_datasets_match_jax(midi_fixture_dir):
    """``MaestroDatasetGanDes`` (each file, and k below its slice count so
    ``random.sample`` picks), ``my_collate`` and ``collect_real_mels`` on the
    suite's MIDI fixtures (``midi_fixture_dir``), and ``InputSong`` on one
    of their WAVs, against the JAX datasets after the same ``random.seed``,
    at the mel tolerance."""
    root = str(midi_fixture_dir)
    ours = datasets.MaestroDatasetGanDes(batch_size=2, input_folder=root, device="cpu")
    ref = jax_datasets.MaestroDatasetGanDes(batch_size=2, input_folder=root)
    assert len(ours) == len(ref) == 3 and ours.data == ref.data
    items, ref_items = [], []
    for i in range(len(ours)):
        random.seed(i)
        items.append(ours[i])
        random.seed(i)
        ref_items.append(ref[i])
        assert items[-1].dtype == torch.float32 and items[-1].shape == (2, 128, 216)
        _assert_mels_close(items[-1], ref_items[-1], f"file {i}")
    batch = datasets.my_collate(items)
    assert torch.equal(batch, torch.cat(items)) and tuple(batch.shape) == (6, 128, 216)
    np.testing.assert_array_equal(jax_datasets.my_collate([np.asarray(m) for m in items]),
                                  batch.numpy())

    mels, n_files = datasets.collect_real_mels(root, 4, device="cpu")
    ref_mels, ref_files = jax_datasets.collect_real_mels(root, 4)
    assert n_files == ref_files and tuple(mels.shape) == ref_mels.shape == (4, 128, 216)
    _assert_mels_close(mels, ref_mels, "collect_real_mels")

    wav = os.path.join(root, "out_0", "wav", "output_0.wav")
    song, ref_song = datasets.InputSong(wav, device="cpu"), jax_datasets.InputSong(wav)
    assert len(song) == len(ref_song) >= 1
    for i in (0, len(song) - 1):
        assert song.audio_files[i].device.type == "cpu"
        _assert_mels_close(song[i][None], ref_song[i][None], f"InputSong {i}")


def test_maestro_dataset_torch_matches_jax(tmp_path):
    """Per-file ``.pt`` tuples (the reference's tensor dataset) read as numpy
    tuples, in file order, as the JAX dataset reads them."""
    rng = np.random.RandomState(9)
    for i in range(2):
        torch.save(tuple(torch.from_numpy(rng.rand(2, 3).astype(np.float32)) for _ in range(3)),
                   tmp_path / f"{i}.pt")
    ours, ref = datasets.MaestroDatasetTorch(str(tmp_path)), jax_datasets.MaestroDatasetTorch(
        str(tmp_path))
    assert len(ours) == len(ref) == 2
    for i in range(2):
        for a, b in zip(ours[i], ref[i], strict=True):
            assert isinstance(a, np.ndarray)
            np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- checkpoints


def test_checkpoint_layout_and_loaders(jax_setup, tmp_path, monkeypatch):
    """A state after a surrogate step round-trips bit for bit (the
    companion too); model.pth is the DCGAN's reference-layout state_dict,
    which the port's ``load_gandes_state`` (the file or its directory) and
    the JAX package's ``load_gandes_torch_checkpoint`` both take; and
    ``generate_song`` decodes from the directory."""
    real, fake, noise, mats_s = _inputs(7)
    port, s_state, _ = _run_port_step(jax_setup, "surrogate", real, fake, noise, mats_s)
    path = ckpt.save_gandes_state(str(tmp_path / "models" / "gen_5_1.5"), port)
    s_path = ckpt.save_surrogate_state(path + "_surrogate", s_state)
    assert sorted(os.listdir(path)) == ["disc.pth", "model.pth", "optim.pt"]
    assert sorted(os.listdir(s_path)) == ["model.pth", "optim.pt"]
    assert ckpt.latest_step_checkpoint(str(tmp_path / "models")) == (path, 5)
    cfg = jax_setup["pcfg"]
    restored = ckpt.restore_gandes_state(path, gandes_loop.init_state_for_config(cfg, "cpu"))
    _assert_state_equal(restored, port)
    s_back = ckpt.restore_surrogate_state(s_path,
                                          gandes_loop.init_surrogate_for_config(cfg, "cpu"))
    assert s_back.step == s_state.step == 1
    assert all(torch.equal(a, b) for a, b in zip(s_back.model.state_dict().values(),
                                                 s_state.model.state_dict().values()))
    optim = torch.load(os.path.join(path, "optim.pt"), weights_only=True)
    assert sorted(optim) == ["d_opt", "g_opt", "step"] and optim["step"] == 1

    model_pth = os.path.join(path, "model.pth")
    sd = torch.load(model_pth, weights_only=True)
    assert sd.keys() == port.gen.state_dict().keys() and len(sd) == 19
    for source in (model_pth, path):
        gen, _ = load_gandes_state(cfg, source, device="cpu")
        assert all(torch.equal(gen.state_dict()[k], sd[k]) for k in sd)
    jax_state = jax.device_get(load_gandes_torch_checkpoint(model_pth, jax_setup["state"]))
    back = dcgan_state_dict_from_flax(jax_state.g_params, jax_state.g_stats)
    for k, v in back.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k

    monkeypatch.chdir(tmp_path)
    np.random.seed(0)
    song_cfg = gandes_loop.GanDesConfig(number_of_customers=120, max_sim_time=5.0,
                                        out_dir=str(tmp_path / "song"))
    os.makedirs("logs")
    mels = gandes_loop.generate_song(path, song_cfg, n_samples=1, device="cpu")
    assert tuple(mels.shape) == (1, 128, 216) and bool(torch.isfinite(mels).all())


def test_cli_train_gandes_on_cpu(midi_fixture_dir, tmp_path, monkeypatch, capsys):
    """``train-gandes --device cpu`` in-process on the MIDI fixtures, two
    steps in ``reinforce`` mode; its real side's mels on the CPU."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("logs")
    random.seed(0)
    cli.main(["train-gandes", "--midi-root", str(midi_fixture_dir), "--steps", "2",
              "--batch-size", "2", "--g-update", "reinforce", "--np-seed", "0",
              "--des-parallel", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: 2 steps" in out
    assert sorted(os.listdir("adj_sim_outputs/wav")) == ["output_0.wav", "output_1.wav"]


@pytest.mark.parametrize("option,item", [
    ({"mesh_shape": (2, 1)}, 11), ({"compute_dtype": "bf16"}, 13),
    ({"trace_dir": "trace"}, 12)], ids=lambda x: str(x))
def test_unported_options_raise(tmp_path, monkeypatch, option, item):
    monkeypatch.chdir(tmp_path)
    cfg = _loop_cfg(gandes_loop, tmp_path, "unported", **option)
    with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md Queue 1 item {item},"):
        gandes_loop.train_gandes(iter(_batches(1)), cfg, device="cpu")
    assert not os.path.exists(tmp_path / "unported")
    with pytest.raises(ValueError, match="g_update"):
        gandes_loop.train_gandes(iter([]), _loop_cfg(gandes_loop, tmp_path, "x", g_update="bad"),
                                 device="cpu")


def test_sound_font_option_trains_through_the_font(tmp_path, monkeypatch):
    """``sound_font`` (which raised before SF2 playback was ported) now trains:
    one step on the CPU, the fake clips rendered through the font; a
    missing path still raises before the run starts."""
    from gandes_tpu_torch.music import sf2

    monkeypatch.chdir(tmp_path)
    font = str(tmp_path / "font.sf2")
    t = np.arange(2000)
    sf2.build_sf2(font, samples=[{"name": "s", "data": (0.5 * np.sin(2 * np.pi * t / 50)).astype(
                      np.float32), "sample_rate": 44100, "original_pitch": 60,
                      "loop_start": 200, "loop_end": 1800}],
                  instruments=[{"name": "i", "zones": [{"sample": 0, "gens": {
                      sf2.G_SAMPLE_MODES: 1, sf2.G_REVERB_SEND: 200}}]}],
                  presets=[{"name": "p", "program": 0, "zones": [{"instrument": 0}]}])
    renders = []
    _recording(monkeypatch, sf2.Sf2Synth, "render_midi", renders)
    cfg = _loop_cfg(gandes_loop, tmp_path, "font", sound_font=font, write_wav=False)
    np.random.seed(0)
    _, history = gandes_loop.train_gandes(iter(_batches(1)), cfg, device="cpu")
    assert len(history["disc"]) == 1 and np.isfinite(history["disc"][0])
    assert len(renders) == B  # each fake clip rendered by SF2 playback
    with pytest.raises(FileNotFoundError):
        gandes_loop.train_gandes(iter(_batches(1)), _loop_cfg(
            gandes_loop, tmp_path, "typo", sound_font=str(tmp_path / "typo.sf2")), device="cpu")
