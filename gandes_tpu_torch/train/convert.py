"""Carry weights from the JAX package into this one.

``dcgan_state_dict_from_flax`` maps a ``gandes_tpu`` DCGAN's flax trees
(``g_params`` / ``g_stats``, as numpy) onto ``DCGANGenerator``'s
``state_dict``:

* ConvTranspose kernels (kh, kw, in, out) are flipped spatially and
  transposed to torch's (in, out, kh, kw) — ``lax.conv_transpose``
  correlates on the dilated input where torch convolves
  (``gandes_tpu/train/torch_import.py:40-42``);
* BatchNorm scale/bias/mean/var map to weight/bias/running_mean/running_var.

``mmgan_state_dict_from_flax`` maps an MM-GAN's flax trees (``g_params`` /
``g_stats`` with ``g1``/``g2`` subtrees, ``d_params``) onto
``MultiModalGAN``'s ``state_dict``, as ``gandes_tpu/train/torch_import.py::
export_mmgan_torch_checkpoint`` writes it:

* Dense kernels (in, out) transpose to torch's (out, in);
* Conv kernels (kh, kw, in, out) to torch's (out, in, kh, kw);
* the discriminator's ``fc`` follows a flatten, which flax takes over NHWC
  and torch over NCHW: its input axis is permuted from (h, w, c) to
  (c, h, w) order.

``mmgan_train_state_from_flax`` carries a whole JAX MM-GAN ``GANState``
(as numpy) across: the weights and BN stats as above, and both optax Adam
states (``mu``, ``nu``, ``count``) into ``torch.optim.Adam`` state, with the
weights' axis permutations.

``gandes_train_state_from_flax`` does the same for a JAX GAN-DES ``GANState``
(the DCGAN as above; ``MelDiscriminator``'s ``fc1`` follows a flatten, so
its input axis is permuted from (h, w, c) to (c, h, w) as the MM-GAN D's
``fc`` is), ``mel_surrogate_state_from_flax`` for a ``MelSurrogate``'s
``SurrogateState``, and ``roll_surrogate_state_from_flax`` for a
``RollSurrogate``'s (its conv kernels HWIO to OIHW; ``fc1``'s rows for the
flattened conv map permuted from (h, w, c) to (c, h, w), the 64 rows of the
vector branch after them unchanged). ``simnn_state_dict_from_flax`` maps
the experimental ``SimNN``'s params (``fc1``'s rows permuted the same way).

Orbax checkpoint directories need JAX to read; the crossing for weights
trained there is ``python -m gandes_tpu.cli export-torch --model gandes``
(or ``--model mmgan``), whose ``.pt`` loads here directly.
"""

from __future__ import annotations

import numpy as np
import torch

from gandes_tpu_torch.train.checkpoint import load_optimizer_state, optimizer_state
from gandes_tpu_torch.train.gandes_loop import init_state_for_config as init_gandes_state_for_config
from gandes_tpu_torch.train.gandes_loop import init_surrogate_for_config
from gandes_tpu_torch.train.mmgan_loop import init_state_for_config
from gandes_tpu_torch.train.mmgan_loop import (
    init_surrogate_for_config as init_roll_surrogate_for_config,
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def dcgan_state_dict_from_flax(params, batch_stats) -> dict:
    sd = {}
    for i in range(4):
        k = np.asarray(params[f"ConvTranspose_{i}"]["kernel"])
        sd[f"conv{i + 1}.weight"] = _t(k[::-1, ::-1].transpose(2, 3, 0, 1))
    for i in range(3):
        bn_p, bn_s = params[f"BatchNorm_{i}"], batch_stats[f"BatchNorm_{i}"]
        sd[f"batch_norm{i + 1}.weight"] = _t(bn_p["scale"])
        sd[f"batch_norm{i + 1}.bias"] = _t(bn_p["bias"])
        sd[f"batch_norm{i + 1}.running_mean"] = _t(bn_s["mean"])
        sd[f"batch_norm{i + 1}.running_var"] = _t(bn_s["var"])
        sd[f"batch_norm{i + 1}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd


def _mlp_generator_state(sd, prefix, params, stats):
    for i in range(4):
        blk_p, blk_s = params[f"_GenBlock_{i}"], stats[f"_GenBlock_{i}"]
        sd[f"{prefix}.gen.{i}.0.weight"] = _t(np.asarray(blk_p["Dense_0"]["kernel"]).T)
        sd[f"{prefix}.gen.{i}.0.bias"] = _t(blk_p["Dense_0"]["bias"])
        sd[f"{prefix}.gen.{i}.1.weight"] = _t(blk_p["BatchNorm_0"]["scale"])
        sd[f"{prefix}.gen.{i}.1.bias"] = _t(blk_p["BatchNorm_0"]["bias"])
        sd[f"{prefix}.gen.{i}.1.running_mean"] = _t(blk_s["BatchNorm_0"]["mean"])
        sd[f"{prefix}.gen.{i}.1.running_var"] = _t(blk_s["BatchNorm_0"]["var"])
        sd[f"{prefix}.gen.{i}.1.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def mmgan_state_dict_from_flax(g_params, g_stats, d_params) -> dict:
    sd = {}
    _mlp_generator_state(sd, "generator1", g_params["g1"], g_stats["g1"])
    _mlp_generator_state(sd, "generator2", g_params["g2"], g_stats["g2"])
    for i, name in enumerate(["conv1", "conv2"]):
        k = np.asarray(d_params[f"Conv_{i}"]["kernel"])  # (kh, kw, in, out)
        sd[f"discriminator.{name}.weight"] = _t(k.transpose(3, 2, 0, 1))
        sd[f"discriminator.{name}.bias"] = _t(d_params[f"Conv_{i}"]["bias"])
    k = np.asarray(d_params["Dense_0"]["kernel"])  # (h*w*c, out), NHWC flatten
    c, h = 32, 32  # conv2's channels; 128 pitches / 4
    w = k.shape[0] // (c * h)
    out = k.shape[1]
    sd["discriminator.fc.weight"] = _t(
        k.reshape(h, w, c, out).transpose(3, 2, 0, 1).reshape(out, c * h * w))
    sd["discriminator.fc.bias"] = _t(d_params["Dense_0"]["bias"])
    return sd


def _load_adam_from_optax(opt: torch.optim.Adam, adam, names: dict, moments: list) -> None:
    """Load an optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) into
    ``opt``, in the device-neutral form a checkpoint holds
    (``train/checkpoint.py::optimizer_state``): ``names`` maps each param's
    id to its name, ``moments`` holds ``mu`` and ``nu`` as state dicts keyed
    by those names (the weights' axis permutations applied)."""
    sd = optimizer_state(opt)
    sd["state"] = {i: {"step": torch.tensor(float(adam.count)),
                       "exp_avg": moments[0][names[id(p)]],
                       "exp_avg_sq": moments[1][names[id(p)]]}
                   for i, p in enumerate(opt.param_groups[0]["params"])}
    load_optimizer_state(opt, sd)


def mmgan_train_state_from_flax(state, cfg):
    """A JAX MM-GAN ``GANState`` (``jax.device_get``'s numpy leaves) as this
    package's ``GANState`` on the CPU, at ``cfg``'s widths: model weights and
    BN stats, ``step``, and each optax ``adam`` state (``(ScaleByAdamState,
    ScaleByScheduleState)``) as the Adam ``state_dict`` of the same params,
    in the device-neutral form a checkpoint holds
    (``train/checkpoint.py::optimizer_state``), so a checkpoint of it restores
    into a CUDA state's capturable Adams. The Adams' learning rates are
    ``make_optimizers(cfg, 1)``'s at count 0; every train step sets them from
    its own schedules."""
    port, _ = init_state_for_config(cfg, device="cpu")
    model = port.model
    model.load_state_dict(
        mmgan_state_dict_from_flax(state.g_params, state.g_stats, state.d_params), strict=True)
    names = {id(p): name for name, p in model.named_parameters()}
    adam = state.g_opt[0]
    _load_adam_from_optax(port.g_opt, adam, names, [
        mmgan_state_dict_from_flax(t, state.g_stats, state.d_params) for t in (adam.mu, adam.nu)])
    adam = state.d_opt[0]
    _load_adam_from_optax(port.d_opt, adam, names, [
        mmgan_state_dict_from_flax(state.g_params, state.g_stats, t) for t in (adam.mu, adam.nu)])
    port.step = int(state.step)
    return port


def mel_disc_state_dict_from_flax(d_params, mel_shape=(128, 216)) -> dict:
    """A JAX ``MelDiscriminator``'s params as this package's ``state_dict``;
    ``Dense_0`` follows an NHWC flatten and ``fc1`` an NCHW one, so its input
    axis is permuted from (h, w, c) to (c, h, w) order (the reverse of
    ``gandes_tpu/train/torch_import.py::_flatten_linear_nchw_to_nhwc``)."""
    sd = {}
    for i, name in enumerate(["conv1", "conv2"]):
        k = np.asarray(d_params[f"Conv_{i}"]["kernel"])  # (kh, kw, in, out)
        sd[f"{name}.weight"] = _t(k.transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = _t(d_params[f"Conv_{i}"]["bias"])
    k = np.asarray(d_params["Dense_0"]["kernel"])  # (h*w*c, out)
    c, h, w = 32, (mel_shape[0] + 1) // 2 // 2, (mel_shape[1] + 1) // 2 // 2
    out = k.shape[1]
    sd["fc1.weight"] = _t(k.reshape(h, w, c, out).transpose(3, 2, 0, 1).reshape(out, c * h * w))
    sd["fc1.bias"] = _t(d_params["Dense_0"]["bias"])
    sd["fc2.weight"] = _t(np.asarray(d_params["Dense_1"]["kernel"]).T)
    sd["fc2.bias"] = _t(d_params["Dense_1"]["bias"])
    return sd


def gandes_train_state_from_flax(state, cfg):
    """A JAX GAN-DES ``GANState`` (numpy leaves) as this package's
    ``GanDesState`` on the CPU at ``cfg``'s widths: the DCGAN's weights and
    BN stats, D's weights, ``step``, and both optax ``adam`` states as
    device-neutral Adam ``state_dict``s (learning rates ``cfg.lr`` /
    ``cfg.d_lr``)."""
    port = init_gandes_state_for_config(cfg, device="cpu")
    port.gen.load_state_dict(dcgan_state_dict_from_flax(state.g_params, state.g_stats),
                             strict=True)
    port.disc.load_state_dict(mel_disc_state_dict_from_flax(state.d_params, cfg.mel_shape),
                              strict=True)
    adam = state.g_opt[0]
    _load_adam_from_optax(port.g_opt, adam, {id(p): n for n, p in port.gen.named_parameters()},
                          [dcgan_state_dict_from_flax(t, state.g_stats)
                           for t in (adam.mu, adam.nu)])
    adam = state.d_opt[0]
    _load_adam_from_optax(port.d_opt, adam, {id(p): n for n, p in port.disc.named_parameters()},
                          [mel_disc_state_dict_from_flax(t, cfg.mel_shape)
                           for t in (adam.mu, adam.nu)])
    port.step = int(state.step)
    return port


def mel_surrogate_state_dict_from_flax(params) -> dict:
    """A JAX ``MelSurrogate``'s params (``Dense_0..2``) as ``fc1..fc3``."""
    sd = {}
    for i in range(3):
        sd[f"fc{i + 1}.weight"] = _t(np.asarray(params[f"Dense_{i}"]["kernel"]).T)
        sd[f"fc{i + 1}.bias"] = _t(params[f"Dense_{i}"]["bias"])
    return sd


def mel_surrogate_state_from_flax(s_state, cfg):
    """A JAX ``SurrogateState`` of a ``MelSurrogate`` (numpy leaves) as this
    package's ``SurrogateState`` on the CPU: weights, ``step`` and the optax
    ``adam`` state (learning rate ``cfg.surrogate_lr``)."""
    port = init_surrogate_for_config(cfg, device="cpu")
    port.model.load_state_dict(mel_surrogate_state_dict_from_flax(s_state.params), strict=True)
    adam = s_state.opt[0]
    _load_adam_from_optax(port.opt, adam, {id(p): n for n, p in port.model.named_parameters()},
                          [mel_surrogate_state_dict_from_flax(t) for t in (adam.mu, adam.nu)])
    port.step = int(s_state.step)
    return port


def roll_surrogate_state_dict_from_flax(params, adj_size=(64, 64)) -> dict:
    """A JAX ``RollSurrogate``'s params (``Conv_0``, ``Conv_1``, ``Dense_0``
    on the vector, ``Dense_1``, ``Dense_2``) as ``conv1``, ``conv2``,
    ``fc_vec``, ``fc1``, ``fc2``."""
    sd = {}
    for i, name in enumerate(["conv1", "conv2"]):
        k = np.asarray(params[f"Conv_{i}"]["kernel"])  # (kh, kw, in, out)
        sd[f"{name}.weight"] = _t(k.transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = _t(params[f"Conv_{i}"]["bias"])
    sd["fc_vec.weight"] = _t(np.asarray(params["Dense_0"]["kernel"]).T)
    sd["fc_vec.bias"] = _t(params["Dense_0"]["bias"])
    k = np.asarray(params["Dense_1"]["kernel"])  # (h*w*c + 64, 512), NHWC flatten first
    c = np.asarray(params["Conv_1"]["kernel"]).shape[3]
    h, w = adj_size[0] // 4, adj_size[1] // 4
    out = k.shape[1]
    conv_rows = k[:h * w * c].reshape(h, w, c, out).transpose(2, 0, 1, 3).reshape(c * h * w, out)
    sd["fc1.weight"] = _t(np.concatenate([conv_rows, k[h * w * c:]]).T)
    sd["fc1.bias"] = _t(params["Dense_1"]["bias"])
    sd["fc2.weight"] = _t(np.asarray(params["Dense_2"]["kernel"]).T)
    sd["fc2.bias"] = _t(params["Dense_2"]["bias"])
    return sd


def roll_surrogate_state_from_flax(s_state, cfg):
    """A JAX ``SurrogateState`` of a ``RollSurrogate`` (numpy leaves) as this
    package's ``SurrogateState`` on the CPU at the MM-GAN ``cfg``'s widths:
    weights, ``step`` and the optax ``adam`` state (learning rate
    ``cfg.surrogate_lr``)."""
    port = init_roll_surrogate_for_config(cfg, device="cpu")
    port.model.load_state_dict(roll_surrogate_state_dict_from_flax(s_state.params, cfg.adj_size),
                               strict=True)
    adam = s_state.opt[0]
    _load_adam_from_optax(port.opt, adam, {id(p): n for n, p in port.model.named_parameters()},
                          [roll_surrogate_state_dict_from_flax(t, cfg.adj_size)
                           for t in (adam.mu, adam.nu)])
    port.step = int(s_state.step)
    return port


def simnn_state_dict_from_flax(params, n: int, input_hw=(64, 64)) -> dict:
    """A JAX ``SimNN``'s params (``Conv_0``, ``Conv_1``, ``Dense_0``,
    ``Dense_1``) as ``SimNN(n, input_hw)``'s ``conv1``, ``conv2``, ``fc1``,
    ``fc2``: conv kernels HWIO to OIHW, dense kernels transposed, and
    ``fc1``'s rows (the flattened conv map) permuted from flax's (h, w, c)
    order to torch's (c, h, w)."""
    sd = {}
    for i, name in enumerate(["conv1", "conv2"]):
        k = np.asarray(params[f"Conv_{i}"]["kernel"])  # (kh, kw, in, out)
        sd[f"{name}.weight"] = _t(k.transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = _t(params[f"Conv_{i}"]["bias"])
    k = np.asarray(params["Dense_0"]["kernel"])  # (h*w*c, 512), NHWC flatten
    c = np.asarray(params["Conv_1"]["kernel"]).shape[3]
    h, w = input_hw[0] // 4, input_hw[1] // 4
    out = k.shape[1]
    sd["fc1.weight"] = _t(k.reshape(h, w, c, out).transpose(3, 2, 0, 1).reshape(out, c * h * w))
    sd["fc1.bias"] = _t(params["Dense_0"]["bias"])
    fc2 = np.asarray(params["Dense_1"]["kernel"])
    if fc2.shape[1] != n * n + 4 * n:
        raise ValueError(f"Dense_1 has {fc2.shape[1]} outputs, SimNN({n}) has {n * n + 4 * n}")
    sd["fc2.weight"] = _t(fc2.T)
    sd["fc2.bias"] = _t(params["Dense_1"]["bias"])
    return sd
