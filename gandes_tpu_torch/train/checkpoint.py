"""Checkpoint/resume (port of ``gandes_tpu/train/checkpoint.py``).

The reference saves bare ``state_dict``s and never checkpoints optimizer
state; here the FULL training state (params, BN stats, both Adam states,
step counter) round-trips, so resume is bit-exact. A checkpoint is a
directory named as the JAX package names its orbax directories
(``mmgan_{a}_{b}_epoch_{e}``, ``gen_{step}_{ts}``) holding:

* ``model.pth`` — the model's bare ``state_dict`` in the reference's layout
  (62 keys for an MM-GAN): it loads unchanged with ``--torch-checkpoint``,
  the JAX package's ``load_mmgan_torch_checkpoint`` and the reference;
* ``optim.pt`` — ``{"g_opt": ..., "d_opt": ..., "step": int}``, both Adams'
  ``state_dict``s.

A GAN-DES ``gen_{step}_{ts}`` directory (:func:`save_gandes_state`) holds
``model.pth``, the generator's bare ``state_dict`` (the reference's
``gen_*.pt`` layout: ``serve --model gandes --torch-checkpoint`` and the JAX
package's ``load_gandes_torch_checkpoint`` load it), ``disc.pth``, the mel
discriminator's, and ``optim.pt``; in ``surrogate`` mode a companion
``gen_{step}_{ts}_surrogate`` (:func:`save_surrogate_state`) holds the
surrogate's ``model.pth`` and ``optim.pt`` (``{"opt": ..., "step": int}``).

All are saved from CPU copies and load with ``weights_only=True``. A save
writes a sibling ``.tmp`` directory and renames it into place, so a
half-written checkpoint is never the newest one.

A CUDA state's Adams are capturable (``train/steps.py``): their step counts
are device tensors and their learning rate a device tensor. The Adam
states are saved device-neutral (step counts on the CPU, the learning rate
a float, ``capturable`` off) and load into an Adam on any device
(:func:`load_optimizer_state`), so a checkpoint written by a CUDA-graph run
restores into an eager or CPU state bit for bit, and the reverse.
"""

from __future__ import annotations

import os
import re
import shutil

import torch

from gandes_tpu_torch.train.steps import GANState, GanDesState, SurrogateState

MODEL_FILE = "model.pth"
OPTIM_FILE = "optim.pt"
DISC_FILE = "disc.pth"


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu(v) for v in tree]
    return tree


def optimizer_state(opt: torch.optim.Optimizer) -> dict:
    """``opt``'s ``state_dict`` on the CPU, device-neutral: each group's
    learning rate a float and ``capturable`` off."""
    sd = _cpu(opt.state_dict())
    sd["param_groups"] = [{**g, "lr": float(g["lr"]), "capturable": False}
                          for g in sd["param_groups"]]
    return sd


def load_optimizer_state(opt: torch.optim.Optimizer, sd: dict) -> None:
    """Load a saved Adam state into ``opt`` on whatever device it lives:
    ``opt`` keeps its own ``capturable`` flag and learning-rate holder (on
    CUDA a device tensor, set to the saved value), and the step counts and
    moments move to its parameters' device (the step counts onto the card
    only for a capturable Adam)."""
    holders = [g["lr"] for g in opt.param_groups]
    opt.load_state_dict({**sd, "param_groups": [
        {**saved, "capturable": g["capturable"]}
        for saved, g in zip(sd["param_groups"], opt.param_groups, strict=True)]})
    for g, holder in zip(opt.param_groups, holders):
        if isinstance(holder, torch.Tensor):
            holder.fill_(float(g["lr"]))
            g["lr"] = holder


def _write_dir(path: str, files: dict) -> str:
    """``torch.save`` each of ``files`` (name -> object) into a sibling
    ``.tmp`` directory, then rename it to ``path``."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for name, obj in files.items():
        torch.save(obj, os.path.join(tmp, name))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def _load(path: str, name: str):
    return torch.load(os.path.join(os.path.abspath(path), name), map_location="cpu",
                      weights_only=True)


def save_state(path: str, state: GANState) -> str:
    return _write_dir(path, {
        MODEL_FILE: _cpu(state.model.state_dict()),
        OPTIM_FILE: {"g_opt": optimizer_state(state.g_opt),
                     "d_opt": optimizer_state(state.d_opt), "step": int(state.step)}})


def restore_state(path: str, template: GANState) -> GANState:
    """Load a checkpoint into ``template`` (same widths; its device is kept,
    see :func:`load_optimizer_state`)."""
    template.model.load_state_dict(_load(path, MODEL_FILE), strict=True)
    optim = _load(path, OPTIM_FILE)
    load_optimizer_state(template.g_opt, optim["g_opt"])
    load_optimizer_state(template.d_opt, optim["d_opt"])
    template.step = int(optim["step"])
    return template


def save_gandes_state(path: str, state: GanDesState) -> str:
    """A GAN-DES state as ``model.pth`` (the generator's bare state_dict),
    ``disc.pth`` and ``optim.pt``."""
    return _write_dir(path, {
        MODEL_FILE: _cpu(state.gen.state_dict()), DISC_FILE: _cpu(state.disc.state_dict()),
        OPTIM_FILE: {"g_opt": optimizer_state(state.g_opt),
                     "d_opt": optimizer_state(state.d_opt), "step": int(state.step)}})


def restore_gandes_state(path: str, template: GanDesState) -> GanDesState:
    """Load a GAN-DES checkpoint into ``template`` (its device is kept)."""
    template.gen.load_state_dict(_load(path, MODEL_FILE), strict=True)
    template.disc.load_state_dict(_load(path, DISC_FILE), strict=True)
    optim = _load(path, OPTIM_FILE)
    load_optimizer_state(template.g_opt, optim["g_opt"])
    load_optimizer_state(template.d_opt, optim["d_opt"])
    template.step = int(optim["step"])
    return template


def save_surrogate_state(path: str, s_state: SurrogateState) -> str:
    """A surrogate's state as ``model.pth`` and ``optim.pt``."""
    return _write_dir(path, {
        MODEL_FILE: _cpu(s_state.model.state_dict()),
        OPTIM_FILE: {"opt": optimizer_state(s_state.opt), "step": int(s_state.step)}})


def restore_surrogate_state(path: str, template: SurrogateState) -> SurrogateState:
    template.model.load_state_dict(_load(path, MODEL_FILE), strict=True)
    optim = _load(path, OPTIM_FILE)
    load_optimizer_state(template.opt, optim["opt"])
    template.step = int(optim["step"])
    return template


def latest_epoch_checkpoint(models_dir: str, prefix: str):
    """Find the newest ``{prefix}_epoch_{e}`` checkpoint dir, or None."""
    if not os.path.isdir(models_dir):
        return None, 0
    best, best_e = None, 0
    for name in os.listdir(models_dir):
        if name.startswith(prefix + "_epoch_"):
            try:
                e = int(name.rsplit("_", 1)[1])
            except ValueError:
                continue
            if e > best_e:
                best, best_e = os.path.join(models_dir, name), e
    return best, best_e


def latest_step_checkpoint(models_dir: str, prefix: str = "gen_"):
    """Find the newest GAN-DES ``gen_{step}_{timestamp}`` checkpoint dir
    (``*_surrogate`` companions skipped), or (None, 0). Newest = highest
    step, timestamp breaking ties."""
    if not os.path.isdir(models_dir):
        return None, 0
    best, best_key = None, (-1, -1.0)
    for name in os.listdir(models_dir):
        m = re.fullmatch(re.escape(prefix) + r"(\d+)_([\d.]+)", name)
        if m:
            try:  # [\d.]+ admits names like 1.2.3 — skip, don't crash
                key = (int(m.group(1)), float(m.group(2)))
            except ValueError:
                continue
            if key > best_key:
                best, best_key = os.path.join(models_dir, name), key
    return best, max(best_key[0], 0)
