"""Train steps of both families (port of ``gandes_tpu/train/steps.py``).

MM-GAN:

* ``gen_forward`` — train-mode G1+G2 forward that updates the BatchNorm
  running statistics and returns the adjacency matrices / parameter vectors
  the host DES decodes;
* ``train_step`` — the discriminator update on (real, fake) and the
  generator loss readout: both BCE terms, the D gradients, D's Adam update,
  the post-update generator loss and G's Adam update.

Faithful-semantics note: both reference loops detach the generator output
before the DES (`SIMNN.py:299`, `network_tests.py:189`), so generator
parameters receive **zero gradient**. ``g_update='none'`` (default)
reproduces that exactly, including stepping G's Adam on zero gradients
(its state advances, as optax's count does, and the params stay bit for bit
unchanged). ``g_update='direct'`` trains G1/G2 against D through a
straight-through proxy around the DES (``make_default_fake_proxy``).

Each step sets both Adams' learning rates from their StepLR schedules at
the step count before the increment, as optax evaluates a schedule at the
optimizer's count before it increments it.

One launch per step on CUDA, the counterpart of the JAX package's jitted
step: :func:`graph_step` and :func:`graph_gen_forward` capture a step or the
G forward into a CUDA graph, and :func:`make_scanned_steps` captures K steps
into one. A step is three parts (``step.lrs``, ``step.body``, the count):
the learning rates are host values, written into device tensors outside
the graph before each replay; ``body`` is the device work alone. The eager
functions stay the plain versions, used on the CPU and by the tests. The
MM-GAN surrogate and reinforce steps are not ported yet (``ROADMAP.md``
Queue 1 item 4).

GAN-DES (``gandes_tpu/train/steps.py:702-866``): ``make_gandes_gen_forward``
and three eager steps, one per ``g_update`` mode (``none``, ``surrogate``,
``reinforce``), each updating a ``GanDesState`` in place under
``CUDNN_TRAIN_FLAGS``. Their learning rates are constant (``optax.adam(lr,
b1=0.5)``), so the steps set none. They are not captured as CUDA graphs: the
loop's batches vary in size (``ROADMAP.md`` Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from gandes_tpu_torch.models.composite import MultiModalGAN
from gandes_tpu_torch.models.gan_des import DCGANGenerator, MelDiscriminator
from gandes_tpu_torch.train.losses import GAN_DES_FAKE_LABEL, GAN_DES_REAL_LABEL, bce_with_logits

# optax.adam's defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8

# cuDNN inside a train step: deterministic algorithms, because on the H100
# the default weight-gradient algorithm for D's convolutions sums with
# atomics, and the same three steps run twice gave different D params (the
# deterministic one costs more device time: PERF.md); TF32 off, as the
# package's numerics policy (``gandes_tpu_torch.use_f32_numerics``) has it
CUDNN_TRAIN_FLAGS = dict(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)


def make_steplr(lr: float, step_size_epochs: int, gamma: float, steps_per_epoch: int):
    """torch ``StepLR(step_size, gamma)`` as a schedule over steps."""

    def schedule(count: int) -> float:
        epoch = count // steps_per_epoch
        return lr * (gamma ** (epoch // step_size_epochs))

    return schedule


@dataclass
class GANState:
    """All mutable training state for one MM-GAN: the model (params and
    BatchNorm statistics), both Adams, and the number of steps taken."""

    model: MultiModalGAN
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int = 0


def g_parameters(model: MultiModalGAN) -> list:
    """G1's then G2's parameters: the order of G's Adam."""
    return [*model.generator1.parameters(), *model.generator2.parameters()]


def _adam(params, lr: float, device: torch.device, betas=ADAM_BETAS) -> torch.optim.Adam:
    """optax.adam's eps and (default) betas. On CUDA the Adam is capturable:
    its step counts live on the card and its learning rate is a float32
    device tensor, so a CUDA graph can hold the update. Capturable Adam does
    not run on the CPU, where the Adam keeps ``capturable=False`` and a
    float learning rate."""
    if device.type == "cuda":
        return torch.optim.Adam(params, lr=torch.tensor(lr, device=device), betas=betas,
                                eps=ADAM_EPS, capturable=True)
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=ADAM_EPS)


def init_mmgan_state(model: MultiModalGAN, g_sched: Callable, d_sched: Callable) -> GANState:
    """Both Adams over the model's parameters (see :func:`_adam`), their
    learning rates at count 0."""
    device = next(model.parameters()).device
    return GANState(model=model, g_opt=_adam(g_parameters(model), g_sched(0), device),
                    d_opt=_adam(model.discriminator.parameters(), d_sched(0), device), step=0)


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)  # a capturable Adam's device lr, written in place
        else:
            group["lr"] = lr


def _adam_step(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads, strict=True):
        p.grad = g
    opt.step()


def _counted(body: Callable, g_sched: Callable, d_sched: Callable) -> Callable:
    """``step(state, *args) -> (state, *body's outputs)``: both Adams'
    learning rates from the schedules at ``state.step``, ``body``'s device
    work, ``state.step += 1``. ``step.lrs(count)`` and ``step.body`` let a
    CUDA graph hold the device work alone and feed it its learning rates."""

    def step(state: GANState, *args):
        _set_lr(state.g_opt, g_sched(state.step))
        _set_lr(state.d_opt, d_sched(state.step))
        out = body(state, *args)
        state.step += 1
        return (state, *out)

    step.lrs = lambda count: (g_sched(count), d_sched(count))
    step.body = body
    return step


def make_mmgan_gen_forward():
    """Train-mode G1+G2 forward that updates the BatchNorm running
    statistics; returns ``forward(state, noise1, noise2, beats, aux) ->
    (mats, vec)``. G1's aux input is an argument (the JAX G1 draws it)."""

    def forward(state: GANState, noise1, noise2, beats, aux):
        model = state.model.train()
        with torch.no_grad():
            return model.generator1(noise1, aux), model.generator2(noise2, beats)

    return forward


def make_default_fake_proxy():
    """Straight-through surrogate for ``g_update='direct'``: re-run G1/G2
    differentiably in train mode without touching their BatchNorm
    statistics, render a cheap differentiable "roll" from their outputs
    (adjacency matrix resized onto the (note, time) grid with antialiased
    bilinear interpolation, as ``jax.image.resize`` does, scaled by gen2's
    velocity/duration parameters), and route gradients through it while the
    forward VALUE stays the true DES-produced roll:

        proxy = fake_roll + (surrogate - surrogate.detach())

    The parentheses make the value ``fake_roll`` bit for bit (the JAX
    package adds then subtracts, which can round).

    The resize is separable, so it runs as two matrix products with
    ``F.interpolate``'s weights (read off the identity): its gradient is
    then a matrix product too, which repeats bit for bit on the card, where
    ``F.interpolate``'s antialiased backward sums with atomics.
    """

    def resize_matrix(n_in, n_out, like):
        """(n_out, n_in): the antialiased bilinear resize of one axis."""
        eye = torch.eye(n_in, dtype=like.dtype, device=like.device)[None, None]
        return F.interpolate(eye, size=(n_in, n_out), mode="bilinear", align_corners=False,
                             antialias=True)[0, 0].T

    def proxy(model: MultiModalGAN, noise1, noise2, beats, aux, fake_roll):
        mats = model.generator1(noise1, aux, update_stats=False)
        vec = model.generator2(noise2, beats, update_stats=False)
        _, _, h, t = fake_roll.shape
        img = (resize_matrix(mats.shape[1], h, mats) @ mats
               @ resize_matrix(mats.shape[2], t, mats).T)
        # gen2's MIDI-meta block is vec[10:]: velocity base = vec[13]*90,
        # tempo (which scales note durations in roll steps) = vec[14]*1e6
        vel = img * (126.0 * vec[:, 13][:, None, None])
        dur = img * (20.0 * vec[:, 14][:, None, None])
        surrogate = torch.stack([vel, dur], 1)
        return fake_roll + (surrogate - surrogate.detach())

    return proxy


def direct_g_loss_and_grads(model: MultiModalGAN, fake_roll, noise1, noise2, beats, aux):
    """``g_update='direct'``'s G loss, BCE(D(proxy), real) under the
    model's current D, and its gradients w.r.t. G's parameters (in
    :func:`g_parameters` order). The train step calls it after D's update."""
    roll = make_default_fake_proxy()(model, noise1, noise2, beats, aux, fake_roll)
    g_loss = bce_with_logits(model.discriminator(roll).squeeze(), 1.0)
    return g_loss, torch.autograd.grad(g_loss, g_parameters(model))


def make_mmgan_train_step(g_sched: Callable, d_sched: Callable, g_update: str = "none"):
    """Returns ``train_step(state, real_roll, fake_roll, [noise1, noise2,
    beats, aux]) -> (state, metrics)``: the D update and the G loss in one
    call, the state updated in place. ``g_update='direct'`` trains G with
    :func:`direct_g_loss_and_grads` through the updated D; the extra args
    are required then.

    The step runs under ``CUDNN_TRAIN_FLAGS`` and restores the caller's
    flags after it."""
    if g_update not in ("none", "direct"):
        raise ValueError(f"unknown g_update mode {g_update!r}")

    def body(state, real_roll, fake_roll, noise1=None, noise2=None, beats=None, aux=None):
        with torch.backends.cudnn.flags(**CUDNN_TRAIN_FLAGS):
            return (_train_body(state, real_roll, fake_roll, noise1, noise2, beats, aux),)

    def _train_body(state, real_roll, fake_roll, noise1, noise2, beats, aux):
        model = state.model.train()
        d = model.discriminator
        d_params, g_params = list(d.parameters()), g_parameters(model)
        d_loss = (bce_with_logits(d(fake_roll).squeeze(), 0.0)
                  + bce_with_logits(d(real_roll).squeeze(), 1.0))
        _adam_step(state.d_opt, d_params, torch.autograd.grad(d_loss, d_params))

        if g_update == "direct":
            g_loss, g_grads = direct_g_loss_and_grads(model, fake_roll, noise1, noise2, beats,
                                                      aux)
        else:
            # faithful: the DES round trip severed the graph; G sees zero grad
            with torch.no_grad():
                g_loss = bce_with_logits(d(fake_roll).squeeze(), 1.0)
            g_grads = [torch.zeros_like(p) for p in g_params]
        _adam_step(state.g_opt, g_params, g_grads)
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach()}

    return _counted(body, g_sched, d_sched)


def make_mmgan_step_and_next_forward(g_sched: Callable, d_sched: Callable):
    """``train_step(N)`` (``g_update='none'``) followed by ``gen_forward(N+1)``
    on the post-update state, as one call. Returns ``step(state, real, fake,
    noise1, noise2, beats, aux) -> (state, mats, vec, metrics)``."""
    train_body = make_mmgan_train_step(g_sched, d_sched).body
    gen_forward = make_mmgan_gen_forward()

    def body(state: GANState, real_roll, fake_roll, noise1, noise2, beats, aux):
        (metrics,) = train_body(state, real_roll, fake_roll)
        mats, vec = gen_forward(state, noise1, noise2, beats, aux)
        return mats, vec, metrics

    return _counted(body, g_sched, d_sched)


# ------------------------------------------------------------- CUDA graphs


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tuple(_clone(v) for v in tree)


def _state_tensors(state: GANState, optimizers: bool) -> list:
    """Every tensor a captured step reads or writes in place: params, BN
    statistics and (``optimizers``) both Adams' state."""
    opts = (state.g_opt, state.d_opt) if optimizers else ()
    return [*state.model.state_dict(keep_vars=True).values(),
            *(t for opt in opts for st in opt.state.values() for t in st.values())]


def _same_tensors(a: list, b: list) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


class _Graph:
    """``fn`` (a counted step of this module run ``k`` times, or a G forward
    when ``k`` is None) as one CUDA graph over one ``GANState``.

    The first call runs ``fn`` eagerly on a side stream: it is that call's
    real work, and it makes Adam's state, the cuBLAS/cuDNN handles and
    cuDNN's algorithm choice before capture. Then the device work is
    captured (under the step's ``CUDNN_TRAIN_FLAGS``) with that call's
    inputs as its static input buffers. Later calls copy their inputs into
    the buffers, write the learning rates of counts ``state.step ..
    state.step + k - 1`` into a (k, 2) device tensor that the captured
    Adams read (step i reads row i), replay, set the Adams' own learning
    rates to the last step's (so the state, and a checkpoint of it, reads as
    after eager steps), and return clones of the outputs. A failed capture
    or replay raises; nothing falls back to the eager function. Loading a
    checkpoint into the state after capture replaces the Adams' tensors, so
    the next call raises."""

    def __init__(self, fn: Callable, k: int | None):
        self.fn, self.k = fn, k
        self.graph = None

    def __call__(self, state: GANState, *args):
        if self.graph is None:
            return self._warm_up_and_capture(state, args)
        if state is not self.state or not _same_tensors(
                _state_tensors(state, bool(self.k)), self.bound):
            raise RuntimeError("this CUDA graph was captured over another state's tensors "
                               "(a new state, or a checkpoint loaded since): build a new one")
        for buf, a in zip(self.inputs, args, strict=True):
            if buf is None:
                if a is not None:
                    raise ValueError("an argument that was None at capture is given now")
            else:
                buf.copy_(a)
        if not self.k:
            self.graph.replay()
            return _clone(self.outputs)
        lrs = [self.fn.lrs(state.step + i) for i in range(self.k)]
        self.lr.copy_(torch.tensor(lrs, dtype=torch.float32))
        self.graph.replay()
        # the Adams' own learning rates read as after the eager steps
        _set_lr(state.g_opt, lrs[-1][0])
        _set_lr(state.d_opt, lrs[-1][1])
        state.step += self.k
        return [_clone(out) for out in self.outputs]

    def _warm_up_and_capture(self, state, args):
        device = next(state.model.parameters()).device
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs the state on a CUDA device, not {device}")
        self.state = state
        self.inputs = [None if a is None else a.clone() for a in args]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            if self.k:
                first = [self.fn(state, *self.inputs)[1:] for _ in range(self.k)]
            else:
                first = self.fn(state, *self.inputs)
        torch.cuda.current_stream(device).wait_stream(side)

        graph = torch.cuda.CUDAGraph()
        if not self.k:
            with torch.cuda.graph(graph):
                self.outputs = self.fn(state, *self.inputs)
        else:
            self.lr = torch.empty((self.k, 2), dtype=torch.float32, device=device)
            opts = (state.g_opt, state.d_opt)
            held = [[g["lr"] for g in opt.param_groups] for opt in opts]
            try:
                with torch.cuda.graph(graph):
                    self.outputs = []
                    for i in range(self.k):
                        for j, opt in enumerate(opts):
                            for g in opt.param_groups:
                                g["lr"] = self.lr[i, j]
                        self.outputs.append(self.fn.body(state, *self.inputs))
            finally:
                for opt, lrs in zip(opts, held):
                    for g, lr in zip(opt.param_groups, lrs):
                        g["lr"] = lr
        self.graph, self.bound = graph, _state_tensors(state, bool(self.k))
        return first


def graph_gen_forward(forward: Callable) -> Callable:
    """:func:`make_mmgan_gen_forward`'s ``forward`` as a CUDA graph (see
    :class:`_Graph`): ``forward(state, noise1, noise2, beats, aux) -> (mats,
    vec)``, the same values and BatchNorm updates as the eager call."""
    return _Graph(forward, None)


def graph_step(step_fn: Callable) -> Callable:
    """A counted step of this module (:func:`make_mmgan_train_step` in
    ``none`` or ``direct`` mode, :func:`make_mmgan_step_and_next_forward`) as
    a CUDA graph (see :class:`_Graph`): the step's signature and results,
    bitwise those of the eager step with the same (capturable) Adams."""
    graph = _Graph(step_fn, 1)

    def step(state: GANState, *args):
        return (state, *graph(state, *args)[0])

    return step


def make_scanned_steps(step_fn: Callable, K: int, n_carry: int = 1):
    """K train steps on the same arguments as one call, the counterpart of
    the JAX package's ``lax.scan`` (``gandes_tpu/train/steps.py:451-481``):
    ``scanned(state, *args) -> (state, stacked_metrics)``, each metric
    stacked over the K steps (the step's last output), its other outputs
    dropped. On CUDA the K steps are captured into one CUDA graph, so one
    replay runs K steps; a boundary of the StepLR schedule may fall inside
    them (each step reads its own learning rate). On the CPU it is K eager
    calls. Either way it is bitwise equal to K single steps. The carry is
    the ``GANState``, updated in place (``n_carry`` 1, the JAX default; the
    surrogate step's second carry is not ported)."""
    if n_carry != 1:
        raise NotImplementedError("make_scanned_steps carries one GANState (n_carry=1); the "
                                  "surrogate step's second carry is not ported (ROADMAP.md "
                                  "Queue 1 item 4)")
    graph = _Graph(step_fn, K)

    def scanned(state: GANState, *args):
        if next(state.model.parameters()).is_cuda:
            outs = graph(state, *args)
        else:
            outs = [step_fn(state, *args)[1:] for _ in range(K)]
        metrics = [out[-1] for out in outs]
        return state, {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}

    return scanned


# ---------------------------------------------------------------- GAN-DES

# the GAN-DES loop's optax.adam(lr, b1=0.5, b2=0.999), the reference's
# Adam(betas=(0.5, 0.999)) for G and D
GANDES_ADAM_BETAS = (0.5, 0.999)

# mel-dB spectrograms span ~[-80, 0]; normalise the surrogate regression
# residual so the MSE is O(1)
MEL_SCALE = 40.0


@dataclass
class GanDesState:
    """All mutable training state of one GAN-DES: the DCGAN (params and
    BatchNorm statistics), the mel discriminator, both Adams, and the number
    of steps taken."""

    gen: DCGANGenerator
    disc: MelDiscriminator
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    step: int = 0


@dataclass
class SurrogateState:
    """Mutable state of a learned DES surrogate: the model, its Adam and the
    number of regression steps taken."""

    model: torch.nn.Module
    opt: torch.optim.Adam
    step: int = 0


def init_gandes_state(gen: DCGANGenerator, disc: MelDiscriminator, lr: float,
                      d_lr: float | None = None) -> GanDesState:
    """Both Adams (betas (0.5, 0.999), see :func:`_adam`); D's learning rate
    is ``d_lr`` where given."""
    device = next(gen.parameters()).device
    return GanDesState(gen=gen, disc=disc,
                       g_opt=_adam(gen.parameters(), lr, device, GANDES_ADAM_BETAS),
                       d_opt=_adam(disc.parameters(), lr if d_lr is None else d_lr, device,
                                   GANDES_ADAM_BETAS))


def init_surrogate_state(model: torch.nn.Module, lr: float) -> SurrogateState:
    """The surrogate's Adam: ``optax.adam(lr)``'s default betas."""
    return SurrogateState(model=model, opt=_adam(model.parameters(), lr,
                                                 next(model.parameters()).device))


def make_gandes_gen_forward():
    """Train-mode DCGAN forward that updates the BatchNorm running
    statistics: ``forward(state, noise) -> mats`` (B, 20, 20). It runs under
    ``CUDNN_TRAIN_FLAGS``: cuDNN may otherwise pick a transposed-convolution
    (backward-data) algorithm that sums with atomics, and the host decode
    takes ``int(x * 126)`` of the matrices, so a last-bit difference can
    change a clip."""

    def forward(state: GanDesState, noise):
        gen = state.gen.train()
        with torch.no_grad(), torch.backends.cudnn.flags(**CUDNN_TRAIN_FLAGS):
            return gen(noise)

    return forward


def _gandes_d_update(state: GanDesState, real_mel, fake_mel) -> torch.Tensor:
    """D's loss, its gradients and D's Adam step; returns the loss. The
    reference's 0.9/0.1 label smoothing goes through BCE-with-logits over
    D's already-sigmoided outputs (the double squash, `SIMNN.py:283-316`)."""
    d_params = list(state.disc.parameters())
    d_loss = (bce_with_logits(state.disc(real_mel).reshape(-1), GAN_DES_REAL_LABEL)
              + bce_with_logits(state.disc(fake_mel).reshape(-1), GAN_DES_FAKE_LABEL))
    _adam_step(state.d_opt, d_params, torch.autograd.grad(d_loss, d_params))
    return d_loss.detach()


def make_gandes_train_step():
    """``g_update='none'``: ``train_step(state, real_mel, fake_mel) -> (state,
    metrics)``, the D update and the post-update G loss; G's Adam steps on
    zero gradients (faithful to the reference's detach, `SIMNN.py:299`), so
    its state advances and G's params stay bit for bit."""

    def train_step(state: GanDesState, real_mel, fake_mel):
        with torch.backends.cudnn.flags(**CUDNN_TRAIN_FLAGS):
            d_loss = _gandes_d_update(state, real_mel, fake_mel)
            with torch.no_grad():
                g_loss = bce_with_logits(state.disc(fake_mel).squeeze(), 1.0)
            g_params = list(state.gen.parameters())
            _adam_step(state.g_opt, g_params, [torch.zeros_like(p) for p in g_params])
        state.step += 1
        return state, {"d_loss": d_loss, "g_loss": g_loss.detach()}

    return train_step


def surrogate_g_loss_and_grads(state: GanDesState, s_model: torch.nn.Module, fake_mel, noise):
    """``g_update='surrogate'``'s G loss, BCE(D(proxy), real) under the
    state's current D, and its gradients w.r.t. G's parameters. G re-runs in
    train mode without touching its BatchNorm statistics; the proxy's value
    is the pipeline's ``fake_mel`` bit for bit and its gradient the
    surrogate's (``s_model`` only carries it: its own params get none):

        proxy = fake_mel + (s_mel - s_mel.detach())
    """
    gen = state.gen.train()
    s_mel = s_model(gen(noise, update_stats=False))
    proxy = fake_mel + (s_mel - s_mel.detach())
    g_loss = bce_with_logits(state.disc(proxy).squeeze(), 1.0)
    return g_loss, torch.autograd.grad(g_loss, list(gen.parameters()))


def make_gandes_train_step_surrogate():
    """``g_update='surrogate'``: ``train_step(state, s_state, real_mel,
    fake_mel, mats, noise) -> (state, s_state, metrics)``. The D update; one
    regression step of the surrogate from the matrices ``mats`` that G gave
    the pipeline to the pipeline's ``fake_mel``; then G's step through the
    just-updated surrogate (:func:`surrogate_g_loss_and_grads`)."""

    def train_step(state: GanDesState, s_state: SurrogateState, real_mel, fake_mel, mats, noise):
        with torch.backends.cudnn.flags(**CUDNN_TRAIN_FLAGS):
            d_loss = _gandes_d_update(state, real_mel, fake_mel)
            s_params = list(s_state.model.parameters())
            s_loss = torch.mean(((s_state.model(mats.detach()) - fake_mel) / MEL_SCALE) ** 2)
            _adam_step(s_state.opt, s_params, torch.autograd.grad(s_loss, s_params))
            s_state.step += 1
            g_loss, g_grads = surrogate_g_loss_and_grads(state, s_state.model, fake_mel, noise)
            _adam_step(state.g_opt, list(state.gen.parameters()), g_grads)
        state.step += 1
        return state, s_state, {"d_loss": d_loss, "g_loss": g_loss.detach(),
                                "s_loss": s_loss.detach()}

    return train_step


def reinforce_g_loss_and_grads(state: GanDesState, fake_mel, mats_s, noise, sigma: float):
    """``g_update='reinforce'``'s G loss under the state's current D, its
    gradients w.r.t. G's parameters, and the batch-mean reward. The pipeline
    consumed ``mats_s``, a sample of N(G(z), sigma^2); the reward
    log D(fake_mel) (D's output is already a probability) weights the
    Gaussian log-density of that sample under G's differentiable means
    (train mode, BatchNorm statistics untouched). Advantages are
    batch-standardised with the population std, as ``jnp.std`` takes it
    (``torch.std`` defaults to ``correction=1``)."""
    with torch.no_grad():
        reward = torch.log(state.disc(fake_mel).reshape(-1).clamp(1e-7, 1.0))
        advantage = (reward - reward.mean()) / (reward.std(correction=0) + 1e-6)
    mu = state.gen.train()(noise, update_stats=False)
    logprob = -torch.sum((mats_s.detach() - mu) ** 2, dim=(1, 2)) * (1.0 / (2.0 * sigma * sigma))
    g_loss = -torch.mean(advantage * logprob)
    return g_loss, torch.autograd.grad(g_loss, list(state.gen.parameters())), reward.mean()


def make_gandes_train_step_reinforce(sigma: float = 0.05):
    """``g_update='reinforce'``: ``train_step(state, real_mel, fake_mel,
    mats_s, noise) -> (state, metrics)``, the D update then G's
    score-function step (:func:`reinforce_g_loss_and_grads`) through the
    updated D; ``metrics['reward']`` is the batch-mean reward."""
    if not sigma > 0:
        raise ValueError(f"reinforce sigma must be > 0, got {sigma}")

    def train_step(state: GanDesState, real_mel, fake_mel, mats_s, noise):
        with torch.backends.cudnn.flags(**CUDNN_TRAIN_FLAGS):
            d_loss = _gandes_d_update(state, real_mel, fake_mel)
            g_loss, g_grads, reward = reinforce_g_loss_and_grads(state, fake_mel, mats_s, noise,
                                                                 sigma)
            _adam_step(state.g_opt, list(state.gen.parameters()), g_grads)
        state.step += 1
        return state, {"d_loss": d_loss, "g_loss": g_loss.detach(), "reward": reward}

    return train_step
