"""GAN-DES training loop and inference (port of
``gandes_tpu/train/gandes_loop.py``).

Re-implements the reference script ``__main__`` (`GAN_DES/SIMNN.py:234-348`):
per batch of collated 5 s mel slices, a train-mode DCGAN forward on the
device -> host ``matrix_to_wav`` (DES -> MIDI -> synth -> mel, K2 once per
clip on the card) -> one train step (``train/steps.py``): the D update with
label smoothing 0.9/0.1 over the double-sigmoid BCE, then the post-update G
loss; ``g_update`` picks G's update (``none``: zero gradient, the reference's
detach at :299; ``surrogate``; ``reinforce``). Generator checkpoints save
every ``save_step`` steps as ``gen_{step}_{timestamp}`` directories
(reference naming, :344-347), full state (``train/checkpoint.py``).

Each step's noise, and in ``reinforce`` mode the perturbation of G's
matrices, come from ``draw_step_inputs(cfg.seed, step)``: a torch stream of
this package's own, not ``jax.random``'s (``ROADMAP.md`` Queue 3). Options
that are not ported yet raise ``NotImplementedError`` naming their
``ROADMAP.md`` Queue 1 item.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import datetime

import torch

from gandes_tpu_torch.bridge.gandes_decode import matrix_to_wav
from gandes_tpu_torch.core.profiling import StepTimer
from gandes_tpu_torch.models.gan_des import DCGANGenerator, MelDiscriminator
from gandes_tpu_torch.models.surrogate import MelSurrogate
from gandes_tpu_torch.music.synth import _resolve_sound_font
from gandes_tpu_torch.train import checkpoint as ckpt
from gandes_tpu_torch.train.mmgan_loop import _not_ported
from gandes_tpu_torch.train.steps import (
    GanDesState,
    SurrogateState,
    init_gandes_state,
    init_surrogate_state,
    make_gandes_gen_forward,
    make_gandes_train_step,
    make_gandes_train_step_reinforce,
    make_gandes_train_step_surrogate,
    step_generator,
)

ADJ_SIZE = (20, 20)  # the DCGAN's output matrices


@dataclass
class GanDesConfig:
    batch_size: int = 30
    z_dim: int = 100
    lr: float = 0.00002
    n_epochs: int = 1
    display_step: int = 5
    save_step: int = 5
    model_path: str = "models/"
    log_path: str = "logs/"
    out_dir: str = "adj_sim_outputs"
    mel_shape: tuple = (128, 216)
    number_of_customers: int = 1000
    max_sim_time: float = 0.5
    # >1: concurrent native DES sims per batch (fast mode, private routing
    # streams — deterministic but not the reference's sequential coupling)
    des_parallel: int | None = None
    # False skips the per-sample WAV artifacts (the reference writes them
    # every step; training never reads them)
    write_wav: bool = True
    # .sf2 path: the fake path renders by sample playback from this
    # soundfont, and so must the real dataset (train-gandes passes it to
    # both), or D separates real from fake by timbre alone (None = the
    # additive synth on both sides)
    sound_font: str | None = None
    # pad short my_collate batches up to batch_size by cycling their own
    # samples (the JAX package's way to keep one compiled program shape).
    # Opt-in; default is the reference's variable-size batches.
    pad_batches: bool = False
    # 'none' (reference semantics: G gets zero gradient through the DES),
    # 'surrogate' (G trains straight-through via a learned matrix->mel
    # surrogate fitted online to the real pipeline output), or 'reinforce'
    # (score-function estimator: the pipeline consumes N(G(z), sigma^2)
    # samples, log D(mel) on the ACTUAL output weights the Gaussian
    # log-density — unbiased through the whole DES->synth->mel chain)
    g_update: str = "none"
    surrogate_lr: float = 1e-3
    reinforce_sigma: float = 0.05
    # Separate D learning rate (opt-in GAN balance knob; None = lr, the
    # reference's single-lr semantics): with mel-dB inputs one Adam step at
    # d_lr >= 1e-4 can push D's pre-sigmoid logits past float32 sigmoid
    # underflow, after which D has no gradient
    d_lr: float | None = None
    # resume from the newest gen_{step}_{ts} checkpoint under model_path
    # (full state incl. optimizers + BN stats; the step-derived noise and
    # reinforce streams continue where the restored run stopped, and the
    # data sequence fast-forwards past the trained steps). The DES stage's
    # global-numpy stream is process-level and NOT checkpointed: an
    # in-process save/resume continues it naturally; a fresh process must
    # reseed numpy itself. The reference's GAN-DES never resumes, so False
    # is its semantics.
    resume: bool = False
    # (dp, tp) device mesh for sharded training; not ported yet, raises
    mesh_shape: tuple | None = None
    # 'float32' (reference numerics); 'bf16' (mixed precision) is not
    # ported yet and raises
    compute_dtype: str = "float32"
    seed: int = 0
    # the JAX package's switch between two derivations of one jax.random
    # stream; accepted and ignored here, where draw_step_inputs is the one
    # stream either way
    counted_rng: bool = True
    # observability: a per-phase StepTimer table (host_des vs device_step)
    # at display_step and in history["profile"]; the device phase then
    # waits for the card. trace_dir (a device trace) is not ported yet and
    # raises.
    profile: bool = False
    trace_dir: str | None = None


def build_gandes(cfg: GanDesConfig, generator: torch.Generator | None = None):
    """The DCGAN and the mel discriminator at ``cfg``'s widths, weights drawn
    from ``generator`` (default: seeded with ``cfg.seed``), G's first."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    gen = DCGANGenerator(noise_dim=cfg.z_dim, generator=generator)
    return gen, MelDiscriminator(mel_shape=cfg.mel_shape, generator=generator)


def init_state_for_config(cfg: GanDesConfig, device="cuda") -> GanDesState:
    """One construction path for training AND checkpoint-restore templates:
    the models on ``device``, both Adams at ``cfg.lr`` / ``cfg.d_lr``."""
    gen, disc = build_gandes(cfg)
    return init_gandes_state(gen.to(device), disc.to(device), cfg.lr, cfg.d_lr)


def init_surrogate_for_config(cfg: GanDesConfig, device="cuda") -> SurrogateState:
    """``MelSurrogate`` (weights from a generator seeded ``cfg.seed + 2``, the
    JAX package's key) on ``device``, its Adam at ``cfg.surrogate_lr``."""
    model = MelSurrogate(mel_shape=cfg.mel_shape,
                         generator=torch.Generator().manual_seed(cfg.seed + 2))
    return init_surrogate_state(model.to(device), cfg.surrogate_lr)


def draw_step_inputs(seed: int, count: int, batch_size: int, z_dim: int, device,
                     perturb: bool = False):
    """Step ``count``'s ``(noise, perturbation)``: (batch_size, z_dim) noise
    and, with ``perturb``, the (batch_size, 20, 20) standard normal that
    ``reinforce`` scales by sigma (else None), float32 on ``device``. One
    CPU ``torch.Generator`` seeded from ``(seed, count)``, so the values do
    not depend on the device, and a resumed run continues the stream
    instead of replaying it (``train/steps.py::step_generator``)."""
    g = step_generator(seed, count)
    noise = torch.randn(batch_size, z_dim, generator=g).to(device)
    if not perturb:
        return noise, None
    return noise, torch.randn(batch_size, *ADJ_SIZE, generator=g).to(device)


def _check_config(cfg: GanDesConfig) -> None:
    if cfg.g_update not in ("none", "surrogate", "reinforce"):
        raise ValueError(f"unknown g_update mode {cfg.g_update!r}")
    if cfg.mesh_shape is not None:
        raise _not_ported("mesh_shape", 11, "multi-GPU data parallelism")
    dtype = cfg.compute_dtype.lower()
    if dtype in ("bf16", "bfloat16"):
        raise _not_ported("compute_dtype='bf16'", 13, "mixed precision")
    if dtype not in ("f32", "float32"):
        raise ValueError(f"compute_dtype must be float32 or bf16, got {cfg.compute_dtype!r}")
    if cfg.trace_dir:
        raise _not_ported("trace_dir", 12, "tooling: device_trace -> torch.profiler")
    _resolve_sound_font(cfg.sound_font)  # a missing font raises before the run starts


def _floats(losses) -> list:
    return torch.stack(losses).tolist() if losses else []


def train_gandes(dataloader, cfg: GanDesConfig = GanDesConfig(), max_steps=None, device="cuda"):
    """Returns ``(state, history)``. ``dataloader`` yields (B, 128, 216) mel
    batches (``my_collate`` output, tensors or numpy); the model trains on
    ``device``. ``history`` holds the per-step ``"gen"`` and ``"disc"``
    losses (and ``"profile"`` under ``cfg.profile``). ``n_epochs`` and
    ``max_steps`` are total budgets: a resumed run skips the batches its
    checkpoint already trained."""
    _check_config(cfg)
    device = torch.device(device)
    state = init_state_for_config(cfg, device)
    resume_path, start_step = None, 0
    if cfg.resume:
        resume_path, _ = ckpt.latest_step_checkpoint(cfg.model_path)
        if resume_path:
            state = ckpt.restore_gandes_state(resume_path, state)
            start_step = state.step
            print(f"Loaded model from {resume_path} (continuing at step {start_step})")
        else:
            print("No saved model found, starting training from scratch")
    gen_forward = make_gandes_gen_forward()
    reinforce = cfg.g_update == "reinforce"
    s_state = None
    if cfg.g_update == "surrogate":
        s_state = init_surrogate_for_config(cfg, device)
        if resume_path and os.path.isdir(resume_path + "_surrogate"):
            s_state = ckpt.restore_surrogate_state(resume_path + "_surrogate", s_state)
        train_step = make_gandes_train_step_surrogate()
    elif reinforce:
        train_step = make_gandes_train_step_reinforce(cfg.reinforce_sigma)
    else:
        train_step = make_gandes_train_step()

    timer = StepTimer()
    gen_losses, disc_losses = [], []
    # display prints the running mean over the whole run (reference
    # semantics, SIMNN.py:337-342): host-side running sums, each display
    # fetching only the window since the last one
    fetched_n, g_sum, d_sum = 0, 0.0, 0.0

    def history():
        hist = {"gen": _floats(gen_losses), "disc": _floats(disc_losses)}
        if cfg.profile:  # phases only honest when steps wait for the card
            hist["profile"] = timer.summary()
        return hist

    # a resumed run fast-forwards the (epoch x batch) sequence past the
    # steps the checkpoint already trained rather than replaying them
    cur_step = skip = start_step
    for epoch in range(cfg.n_epochs):
        for real in dataloader:
            if skip > 0:
                skip -= 1
                continue
            if max_steps is not None and cur_step >= max_steps:
                return state, history()
            real = torch.as_tensor(real).to(device, torch.float32)
            if cfg.pad_batches and 0 < len(real) < cfg.batch_size:
                reps = -(-cfg.batch_size // len(real))  # cycle own samples
                real = torch.cat([real] * reps)[: cfg.batch_size]
            noise, perturbation = draw_step_inputs(cfg.seed, cur_step, len(real), cfg.z_dim,
                                                   device, perturb=reinforce)
            fake_mats = gen_forward(state, noise)
            if reinforce:
                # the pipeline consumes a SAMPLE from N(G(z), sigma^2),
                # clipped to [0, 1] to keep the decode semantics
                fake_mats = torch.clamp(fake_mats + cfg.reinforce_sigma * perturbation, 0.0, 1.0)

            with timer.phase("host_des"):
                fake = matrix_to_wav(
                    fake_mats.cpu().numpy(), size=20, start=0, end=cfg.mel_shape[1],
                    overwrite=True, log_path=cfg.log_path, out_dir=cfg.out_dir,
                    number_of_customers=cfg.number_of_customers, max_sim_time=cfg.max_sim_time,
                    parallel=cfg.des_parallel, write_wav=cfg.write_wav,
                    sound_font=cfg.sound_font, device=device)
            with timer.phase("device_step"):
                if s_state is not None:
                    state, s_state, metrics = train_step(state, s_state, real, fake, fake_mats,
                                                         noise)
                elif reinforce:
                    state, metrics = train_step(state, real, fake, fake_mats, noise)
                else:
                    state, metrics = train_step(state, real, fake)
                if cfg.profile and device.type == "cuda":
                    torch.cuda.synchronize(device)
            # losses stay on the device; fetched in bulk at display and return
            disc_losses.append(metrics["d_loss"])
            gen_losses.append(metrics["g_loss"])

            if cur_step % cfg.display_step == 0 and cur_step > 0:
                g_sum += float(torch.stack(gen_losses[fetched_n:]).sum())
                d_sum += float(torch.stack(disc_losses[fetched_n:]).sum())
                fetched_n = len(gen_losses)
                print(f"Epoch:{epoch} Step {cur_step}: Generator loss: {g_sum / fetched_n}, "
                      f"discriminator loss: {d_sum / fetched_n}")
                if cfg.profile:
                    print(timer.report())
            if cur_step % cfg.save_step == 0 and cur_step > 0:
                path = os.path.join(cfg.model_path,
                                    f"gen_{cur_step}_{datetime.timestamp(datetime.now())}")
                ckpt.save_gandes_state(path, state)
                if s_state is not None:
                    ckpt.save_surrogate_state(path + "_surrogate", s_state)
            cur_step += 1
    return state, history()


def generate_song(ckpt_path, cfg: GanDesConfig = GanDesConfig(), n_samples=1, device="cuda"):
    """== reference ``generate_song`` (SIMNN.py:201-216): load the generator
    (a ``gen_*`` checkpoint directory or a reference ``.pt``), sample noise
    (a generator seeded 42), decode through the DES to spectrograms on
    ``device``."""
    from gandes_tpu_torch.train.loading import gandes_eval_forward, load_gandes_state

    gen, _ = load_gandes_state(cfg, ckpt_path, device=device)
    noise = torch.randn(n_samples, cfg.z_dim, generator=torch.Generator().manual_seed(42))
    mats = gandes_eval_forward(gen)(noise.to(device))
    return matrix_to_wav(mats.cpu().numpy(), size=20, start=0, end=cfg.mel_shape[1],
                         log_path=cfg.log_path, out_dir=cfg.out_dir,
                         number_of_customers=cfg.number_of_customers,
                         max_sim_time=cfg.max_sim_time, parallel=cfg.des_parallel,
                         sound_font=cfg.sound_font, device=device)
