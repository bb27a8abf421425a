"""gandes_tpu_torch's CUDA kernels against their plain PyTorch versions, MM-GAN
training (every ``g_update`` mode) against the CPU, the train step's CUDA
graphs against the eager step (in float32 and bfloat16), the parallel
GAN-DES decode, GAN-DES training, the eval metrics and SF2 sample playback (against the CPU port,
bitwise repeats, a bank past 2^24 samples), on the card.

Every test here is marked ``cuda`` and skips without a GPU. The file imports
neither JAX nor gandes_tpu, so it runs on a machine that has only the port's
dependencies, without the suite's conftest (which configures JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from gandes_tpu_torch.music.mel import amplitude_to_db_torch, melspectrogram_db_tensor
from gandes_tpu_torch.music.piano_roll import rasterize_events
from gandes_tpu_torch.ops.mel_power import mel_power_cuda, mel_power_reference
from gandes_tpu_torch.ops.roll_rasterize import rasterize_cuda, rasterize_events_reference

SR = 44100

# (hop, n, htk, norm_slaney): fixed hops, the blank clip's slaney variant,
# and the serve path's dynamic hop len // 215 at pow2 buckets
CASES = [(512, 44100, True, False), (1025, 5 * 44100, True, False),
         (220, 44100, True, False), (512, 5 * 44100, False, True)]
CASES += [((1 << p) // 215, 1 << p, True, False) for p in (18, 20, 23)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _wave(n, device, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    w = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.randn(n)).astype(np.float32)
    return torch.from_numpy(w).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("hop,n,htk,norm_slaney", CASES)
def test_mel_power_cuda_matches_plain(cuda, hop, n, htk, norm_slaney):
    wav = _wave(n, cuda)
    kw = dict(hop_length=hop, htk=htk, norm_slaney=norm_slaney)
    launches = mel_power_cuda.launches
    out = mel_power_cuda(wav, SR, **kw)
    ref = mel_power_reference(wav, SR, **kw)
    torch.cuda.synchronize()
    assert mel_power_cuda.launches == launches + 1
    assert out.shape == ref.shape == (128, 1 + n // hop)
    torch.testing.assert_close(out, ref, rtol=2e-3, atol=1e-4)
    torch.testing.assert_close(amplitude_to_db_torch(out), amplitude_to_db_torch(ref),
                               rtol=0, atol=0.05)


@pytest.mark.cuda
def test_mel_db_tensor_dispatches_to_the_kernel(cuda):
    wav = _wave(1 << 18, cuda, seed=1)
    launches = mel_power_cuda.launches
    on_card = melspectrogram_db_tensor(wav)
    assert mel_power_cuda.launches == launches + 1
    plain = melspectrogram_db_tensor(wav.cpu())
    assert on_card.shape == plain.shape == (128, 216)
    torch.testing.assert_close(on_card.cpu(), plain, rtol=0, atol=0.05)


@pytest.mark.cuda
def test_mel_power_cuda_refuses_what_the_kernel_does_not_take(cuda):
    wav = _wave(SR, cuda)
    with pytest.raises(ValueError):
        mel_power_cuda(wav.double(), SR)
    with pytest.raises(ValueError):
        mel_power_cuda(wav[::2], SR)
    with pytest.raises(ValueError, match="empty axis"):
        mel_power_cuda(wav[:0], SR)
    launches = mel_power_cuda.launches
    # not a power of two; outside [256, 8192]: an intended divergence from the
    # JAX backend, which falls back to XLA there (ROADMAP.md)
    for n_fft in (2016, 128, 16384):
        with pytest.raises(ValueError, match=r"power of two in \[256, 8192\]"):
            mel_power_cuda(wav, SR, n_fft=n_fft)
    assert mel_power_cuda.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 216, 300, 864, 900, 1024, 1025, 1080])
def test_mel_power_cuda_short_waves_match_plain(cuda, n):
    """Waves shorter than the n_fft / 2 reflect pad (melspectrogram_db_tensor
    of 300-1,025 samples crops to 216-1,080): the kernel folds the
    reflection again and again, as the plain version and jnp.pad do."""
    wav = _wave(n, cuda, seed=4)
    hop = max(1, n // 215)
    launches = mel_power_cuda.launches
    out = mel_power_cuda(wav, SR, hop_length=hop)
    ref = mel_power_reference(wav, SR, hop_length=hop)
    torch.cuda.synchronize()
    assert mel_power_cuda.launches == launches + 1
    assert out.shape == ref.shape == (128, 1 + n // hop)
    torch.testing.assert_close(out, ref, rtol=2e-3, atol=1e-4)
    torch.testing.assert_close(amplitude_to_db_torch(out), amplitude_to_db_torch(ref),
                               rtol=0, atol=0.05)
    if n in (300, 900, 1024, 1025):
        db = melspectrogram_db_tensor(wav)
        assert db.shape == (128, 217) and mel_power_cuda.launches == launches + 2
        torch.testing.assert_close(db.cpu(), melspectrogram_db_tensor(wav.cpu()), rtol=0,
                                   atol=0.05)


# (n_fft, hop, n, fmax): every FFT length's pass structure (odd and even
# log2 of n_fft / 2), the 64 KB shared-memory transform at 8192, and the
# Nyquist bin (fmax = sr / 2 uses bin n_fft / 2)
FFT_CASES = [(256, 128, SR, 8300), (512, 700, SR, 8300), (1024, 256, SR, 8300),
             (4096, 1500, 2 * SR, 8300), (8192, 2000, 2 * SR, 8300), (2048, 300, SR, SR / 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,n,fmax", FFT_CASES)
def test_mel_power_cuda_fft_lengths_match_plain(cuda, n_fft, hop, n, fmax):
    wav = _wave(n, cuda, seed=2)
    kw = dict(n_fft=n_fft, hop_length=hop, fmax=fmax)
    launches = mel_power_cuda.launches
    out = mel_power_cuda(wav, SR, **kw)
    assert mel_power_cuda.launches == launches + 1
    ref = mel_power_reference(wav, SR, **kw)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (128, 1 + n // hop)
    torch.testing.assert_close(out, ref, rtol=2e-3, atol=1e-4)


@pytest.mark.cuda
def test_mel_power_cuda_is_bitwise_repeatable(cuda):
    """One writer per output element and a fixed summation order: two
    launches on the same wave agree bit for bit, one launch per call."""
    wav = _wave(1 << 22, cuda, seed=3)
    hop = (1 << 22) // 215
    launches = mel_power_cuda.launches
    a = mel_power_cuda(wav, SR, hop_length=hop)
    b = mel_power_cuda(wav, SR, hop_length=hop)
    torch.cuda.synchronize()
    assert mel_power_cuda.launches == launches + 2
    assert torch.equal(a, b)


def _roll_events(B, E, T, start, seed=0, pad_from=None, pitch=None, sorted_ons=False):
    """tests/test_pallas_roll.py's generator (notes in [-1, 128), ons past
    the crop on both sides, spans of -2..19 steps, velocities from -1);
    ``pad_from`` pads every slot from that index on (a shared pad tail),
    ``pitch`` sets every valid note to one pitch (a skewed file), and
    ``sorted_ons`` sorts each row's onsets (MIDI order)."""
    rng = np.random.RandomState(seed)
    notes = rng.randint(-1, 128, (B, E)).astype(np.int32)
    if pitch is not None:
        notes[notes >= 0] = pitch
    if pad_from is not None:
        notes[:, pad_from:] = -1
    ons = rng.randint(0, T + start + 10, (B, E)).astype(np.int32)
    if sorted_ons:
        ons.sort(axis=1)
    offs = (ons + rng.randint(-2, 20, (B, E))).astype(np.int32)
    vels = rng.randint(-1, 127, (B, E)).astype(np.int32)
    return notes, ons, offs, vels


LAST_WRITER = (np.array([[60, 60, 60, 60, 64, 64]], np.int32),
               np.array([[10, 10, 10, 10, 5, 5]], np.int32),
               np.array([[30, 20, 15, 12, 40, 8]], np.int32),
               np.array([[100, 90, 0, -1, 70, 0]], np.int32))

# (label, events, T, start): the JAX kernel tests' shapes, the pickler's
# (8 files, E 4096, T 300), a dense one, a long roll of four column tiles,
# a file whose every note is one pitch, and onsets in MIDI order with
# per-file pad tails as the pickler pads them
ROLL_CASES = [
    ("jax_3x32", lambda: _roll_events(3, 32, 50, 5), 50, 5),
    ("jax_2x128", lambda: _roll_events(2, 128, 50, 100, seed=1), 50, 100),
    ("jax_1x16", lambda: _roll_events(1, 16, 96, 0, seed=2), 96, 0),
    ("last_writer", lambda: LAST_WRITER, 50, 0),
    ("pad_tail", lambda: _roll_events(4, 256, 50, 0, seed=3, pad_from=37), 50, 0),
    ("all_pad", lambda: (np.full((2, 8), -1, np.int32),) + (np.zeros((2, 8), np.int32),) * 3,
     50, 0),
    ("pickler", lambda: _roll_events(8, 4096, 300, 0, seed=4), 300, 0),
    ("dense", lambda: _roll_events(8, 16384, 300, 0, seed=5), 300, 0),
    ("long_roll", lambda: _roll_events(2, 4096, 2000, 0, seed=6), 2000, 0),
    ("one_pitch", lambda: _roll_events(8, 4096, 300, 0, seed=7, pitch=60), 300, 0),
    ("midi_order", lambda: _roll_events(8, 3100, 300, 0, seed=8, pad_from=2900,
                                        sorted_ons=True), 300, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("label,make,T,start", ROLL_CASES, ids=[c[0] for c in ROLL_CASES])
def test_rasterize_cuda_matches_plain(cuda, label, make, T, start):
    events = [torch.from_numpy(a).to(cuda) for a in make()]
    launches = rasterize_cuda.launches
    out = rasterize_events(*events, num_steps=T, start=start)
    torch.cuda.synchronize()
    assert rasterize_cuda.launches == launches + 1
    ref = rasterize_events_reference(*events, num_steps=T, start=start)
    assert out.shape == ref.shape == (events[0].shape[0], 2, 128, T)
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_rasterize_cuda_refuses_what_the_kernel_does_not_take(cuda):
    notes, ons, offs, vels = (torch.from_numpy(a).to(cuda) for a in _roll_events(2, 64, 50, 0))
    with pytest.raises(ValueError):
        rasterize_cuda(notes.long(), ons, offs, vels, num_steps=50)
    with pytest.raises(ValueError):
        rasterize_cuda(notes[:, ::2], ons[:, ::2], offs[:, ::2], vels[:, ::2], num_steps=50)
    with pytest.raises(ValueError):
        rasterize_cuda(notes, ons, offs, vels[:1], num_steps=50)
    launches = rasterize_cuda.launches
    with pytest.raises(ValueError):
        rasterize_cuda(notes, ons, offs, vels, num_steps=0)  # any T >= 1 is taken
    assert rasterize_cuda.launches == launches


@pytest.mark.cuda
def test_rasterize_cuda_is_bitwise_repeatable(cuda):
    """The per-cell maximum does not depend on the order in which threads
    fold events in: two launches agree bit for bit, one launch per call."""
    events = [torch.from_numpy(a).to(cuda) for a in _roll_events(8, 4096, 300, 0, seed=9)]
    launches = rasterize_cuda.launches
    a = rasterize_cuda(*events, num_steps=300)
    b = rasterize_cuda(*events, num_steps=300)
    torch.cuda.synchronize()
    assert rasterize_cuda.launches == launches + 2
    assert torch.equal(a, b)


def _train_inputs(seed=0, batch=16):
    """Two piano-roll batches shaped like the pickler's windows (sparse
    velocities and durations), beats, and a step's noise/aux draws."""
    from gandes_tpu_torch.train.mmgan_loop import draw_step_inputs

    rng = np.random.RandomState(seed)
    rolls = [(rng.randint(0, 111, (batch, 2, 128, 50)) * (rng.rand(batch, 2, 128, 50) < 0.03))
             .astype(np.float32) for _ in range(2)]
    beats = rng.rand(batch, 50).astype(np.float32)
    n1, n2, aux = draw_step_inputs(0, 1, batch, 50, "cpu")
    return [torch.from_numpy(a) for a in (*rolls, beats)] + [n1, n2, aux]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "direct"])
def test_mmgan_train_step_on_card_matches_cpu(cuda, mode):
    """One step at MMGANConfig() width from one seeded state on the card and
    on the CPU: losses rtol 1e-4, and the D and G gradients rtol 1e-4 with
    an absolute floor of 1e-4 of each tensor's largest element (elements
    that cancel to near zero); the Linear biases before a BatchNorm, whose
    exact gradient is zero, below 1e-5 of the module's largest gradient
    (measured on the pickler's windows on the CPU: up to 1.7e-6). G's
    gradients (direct) are computed on the CPU through the card's
    post-update D: Adam's first step maps a D gradient element within
    rounding of zero to ~lr * sign(g), and G's gradient is read through the
    updated D. The params after Adam are not compared for the same
    reason."""
    from gandes_tpu_torch.train.mmgan_loop import MMGANConfig, init_state_for_config
    from gandes_tpu_torch.train.steps import direct_g_loss_and_grads, make_mmgan_train_step

    real, fake, beats, n1, n2, aux = _train_inputs()
    out = {}
    for dev in (cuda, torch.device("cpu")):
        state, scheds = init_state_for_config(MMGANConfig(), device=dev)
        state, metrics = make_mmgan_train_step(*scheds, g_update=mode)(
            state, real.to(dev), fake.to(dev), n1.to(dev), n2.to(dev), beats.to(dev),
            aux.to(dev))
        out[dev.type] = state, {k: float(v) for k, v in metrics.items()}
    (card, m_card), (cpu, m_cpu) = out["cuda"], out["cpu"]
    for k in m_cpu:
        assert m_card[k] == pytest.approx(m_cpu[k], rel=1e-4)
    groups = [(list(card.model.discriminator.named_parameters()),
               [p.grad for p in cpu.model.discriminator.parameters()])]
    if mode == "direct":
        pinned, _ = init_state_for_config(MMGANConfig(), device="cpu")
        pinned.model.discriminator.load_state_dict(card.model.discriminator.state_dict())
        _, g_ref = direct_g_loss_and_grads(pinned.model.train(), fake, n1, n2, beats, aux)
        groups.append(([(f"{m}.{n}", p) for m in ("generator1", "generator2")
                        for n, p in getattr(card.model, m).named_parameters()], g_ref))
    for named, refs in groups:
        top = max(float(ref.abs().max()) for ref in refs)
        for (name, p), ref in zip(named, refs, strict=True):
            g = p.grad.cpu()
            if name.endswith(".0.bias") and "gen." in name:
                # a Linear bias before a train-mode BatchNorm: its exact
                # gradient is zero, both devices hold rounding noise
                assert max(float(g.abs().max()), float(ref.abs().max())) <= 1e-5 * top, name
            else:
                torch.testing.assert_close(g, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()),
                                           msg=lambda m: f"{name}: {m}")
    assert card.step == cpu.step == 1
    assert all(st["exp_avg"].is_cuda for st in card.d_opt.state.values())


@pytest.mark.cuda
def test_mmgan_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A state trained one direct step on the card saves and restores bit for
    bit, onto the card."""
    from gandes_tpu_torch.train import checkpoint as ckpt
    from gandes_tpu_torch.train.mmgan_loop import MMGANConfig, init_state_for_config
    from gandes_tpu_torch.train.steps import make_mmgan_train_step

    args = [a.to(cuda) for a in _train_inputs(seed=1)]
    state, scheds = init_state_for_config(MMGANConfig(), device=cuda)
    state, _ = make_mmgan_train_step(*scheds, g_update="direct")(state, *args[:2], *args[3:5],
                                                                 args[2], args[5])
    path = ckpt.save_state(str(tmp_path / "mmgan_64_64_epoch_1"), state)
    template, _ = init_state_for_config(MMGANConfig(), device=cuda)
    restored = ckpt.restore_state(path, template)
    assert restored.step == state.step == 1
    a, b = restored.model.state_dict(), state.model.state_dict()
    assert all(a[k].is_cuda and torch.equal(a[k], b[k]) for k in b)
    for opt_a, opt_b in ((restored.g_opt, state.g_opt), (restored.d_opt, state.d_opt)):
        for p_a, p_b in zip(opt_a.param_groups[0]["params"], opt_b.param_groups[0]["params"]):
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(opt_a.state[p_a][k].cpu(), opt_b.state[p_b][k].cpu())
            assert opt_a.state[p_a]["exp_avg"].is_cuda


# ------------------------------------------------ CUDA graphs of the train step


def _graph_states(cuda, n=2, **cfg_kw):
    """``n`` equal fresh states at MMGANConfig() width on the card (capturable
    Adams), and their schedules."""
    from gandes_tpu_torch.train.mmgan_loop import MMGANConfig, init_state_for_config

    cfg = MMGANConfig(**cfg_kw)
    out = [init_state_for_config(cfg, 1, device=cuda) for _ in range(n)]
    return [s for s, _ in out], out[0][1]


def _step_args(mode, seed, cuda):
    real, fake, beats, n1, n2, aux = (a.to(cuda) for a in _train_inputs(seed))
    return (real, fake) if mode == "none" else (real, fake, n1, n2, beats, aux)


def _cuda_states_equal(a, b):
    """Params, BN statistics, both Adams' moments and step counts, the
    Adams' learning rates and the step, bit for bit."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    if not all(torch.equal(sa[k], sb[k]) for k in sa) or a.step != b.step:
        return False
    for oa, ob in ((a.g_opt, b.g_opt), (a.d_opt, b.d_opt)):
        if float(oa.param_groups[0]["lr"]) != float(ob.param_groups[0]["lr"]):
            return False
        for pa, pb in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
            if not all(torch.equal(oa.state[pa][k].cpu(), ob.state[pb][k].cpu())
                       for k in ("step", "exp_avg", "exp_avg_sq")):
                return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "direct"])
def test_captured_steps_equal_eager_steps(cuda, mode):
    """3 steps on new inputs each: the graph (its first call eager on a side
    stream, then capture, then 2 replays) against the eager step with the
    same capturable Adams, bit for bit, metrics included; G's forward graph
    against the eager forward too."""
    from gandes_tpu_torch.train.steps import (
        graph_gen_forward,
        graph_step,
        make_mmgan_gen_forward,
        make_mmgan_train_step,
    )

    (eager, captured), scheds = _graph_states(cuda)
    assert captured.d_opt.param_groups[0]["capturable"]
    step = make_mmgan_train_step(*scheds, g_update=mode)
    graphed = graph_step(make_mmgan_train_step(*scheds, g_update=mode))
    fwd, fwd_graph = make_mmgan_gen_forward(), graph_gen_forward(make_mmgan_gen_forward())
    for i in range(3):  # the loop's order: G forward, then the step
        g_args = _step_args("direct", 20 + i, cuda)[2:]
        for a, b in zip(fwd(eager, *g_args), fwd_graph(captured, *g_args)):
            assert torch.equal(a, b), i
        args = _step_args(mode, 10 + i, cuda)
        _, m_eager = step(eager, *args)
        _, m_graph = graphed(captured, *args)
        assert all(torch.equal(m_eager[k], m_graph[k]) for k in m_eager), i
    torch.cuda.synchronize()
    assert _cuda_states_equal(eager, captured) and captured.step == 3


@pytest.mark.cuda
def test_steplr_boundary_under_capture(cuda):
    """One step per epoch and StepLR every epoch: each of the 3 steps has
    another learning rate (0.01, 0.001, 1e-4). The graph reads them from its
    device buffer and ends bit for bit where the eager steps end."""
    from gandes_tpu_torch.train.steps import graph_step, make_mmgan_train_step

    (eager, captured), scheds = _graph_states(cuda, steplr_epochs=1)
    step = make_mmgan_train_step(*scheds, g_update="direct")
    graphed = graph_step(make_mmgan_train_step(*scheds, g_update="direct"))
    for i in range(3):
        args = _step_args("direct", 30 + i, cuda)
        step(eager, *args)
        graphed(captured, *args)
    assert float(captured.d_opt.param_groups[0]["lr"]) == pytest.approx(1e-4)
    assert _cuda_states_equal(eager, captured)


@pytest.mark.cuda
def test_scanned_steps_equal_single_captured_steps(cuda):
    """make_scanned_steps(K=4) twice (a warm-up of 4 eager steps, then one
    replay of 4 captured steps) against 8 single captured steps on the same
    arguments, across StepLR boundaries: states and stacked metrics bit for
    bit."""
    from gandes_tpu_torch.train.steps import graph_step, make_mmgan_train_step, make_scanned_steps

    (single, scanned_state), scheds = _graph_states(cuda, steplr_epochs=3)
    args = _step_args("direct", 40, cuda)
    graphed = graph_step(make_mmgan_train_step(*scheds, g_update="direct"))
    metrics = [graphed(single, *args)[1] for _ in range(8)]
    scanned = make_scanned_steps(make_mmgan_train_step(*scheds, g_update="direct"), 4)
    stacked = [scanned(scanned_state, *args)[1] for _ in range(2)]
    assert _cuda_states_equal(single, scanned_state) and scanned_state.step == 8
    for k in ("d_loss", "g_loss"):
        assert torch.equal(torch.cat([s[k] for s in stacked]), torch.stack([m[k] for m in metrics]))


@pytest.mark.cuda
def test_graph_checkpoint_restores_into_a_cpu_state(cuda, tmp_path):
    """A state after 2 captured steps saves device-neutral and restores into
    a CPU state (non-capturable Adams) bit for bit, which resumes with a
    step; restored onto the card, a new graph continues exactly as the
    original graph does."""
    from gandes_tpu_torch.train import checkpoint as ckpt
    from gandes_tpu_torch.train.mmgan_loop import MMGANConfig, init_state_for_config
    from gandes_tpu_torch.train.steps import graph_step, make_mmgan_train_step

    (state,), scheds = _graph_states(cuda, n=1)
    graphed = graph_step(make_mmgan_train_step(*scheds, g_update="direct"))
    for i in range(2):
        graphed(state, *_step_args("direct", 50 + i, cuda))
    path = ckpt.save_state(str(tmp_path / "mmgan_64_64_epoch_1"), state)

    cpu, _ = init_state_for_config(MMGANConfig(), 1, device="cpu")
    ckpt.restore_state(path, cpu)
    assert not cpu.d_opt.param_groups[0]["capturable"] and cpu.step == 2
    sa, sb = cpu.model.state_dict(), state.model.state_dict()
    assert all(torch.equal(sa[k], sb[k].cpu()) for k in sa)
    for oa, ob in ((cpu.g_opt, state.g_opt), (cpu.d_opt, state.d_opt)):
        assert float(oa.param_groups[0]["lr"]) == float(ob.param_groups[0]["lr"])
        for pa, pb in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
            assert oa.state[pa]["step"].device.type == "cpu"
            assert all(torch.equal(oa.state[pa][k], ob.state[pb][k].cpu())
                       for k in ("step", "exp_avg", "exp_avg_sq"))
    cpu_args = [a.cpu() for a in _step_args("direct", 52, cuda)]
    _, m_cpu = make_mmgan_train_step(*scheds, g_update="direct")(cpu, *cpu_args)
    assert cpu.step == 3 and all(bool(torch.isfinite(v)) for v in m_cpu.values())

    card, _ = init_state_for_config(MMGANConfig(), 1, device=cuda)
    ckpt.restore_state(path, card)
    regraphed = graph_step(make_mmgan_train_step(*scheds, g_update="direct"))
    for i in range(2, 4):
        args = _step_args("direct", 50 + i, cuda)
        graphed(state, *args)
        regraphed(card, *args)
    assert _cuda_states_equal(card, state) and card.step == 4
    with pytest.raises(RuntimeError, match="captured over another state"):
        ckpt.restore_state(path, state)  # the Adams' tensors are replaced
        graphed(state, *_step_args("direct", 54, cuda))


@pytest.mark.cuda
def test_matrix_to_wav_parallel_launches_k2_once_per_clip(cuda, tmp_path):
    """matrix_to_wav(parallel=2) on the card: concurrent native sims, the
    native v1 decode, the synth and one mel kernel launch per clip; the mels
    within the GAN-DES tolerances of the same call on the CPU (0.05 dB on
    bins more than 10 dB above the floor, 0.2 dB on every bin)."""
    from gandes_tpu_torch.bridge.gandes_decode import matrix_to_wav

    mats = np.random.RandomState(3).rand(2, 20, 20).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        launches = mel_power_cuda.launches
        np.random.seed(0)
        out[dev.type] = matrix_to_wav(mats, size=20, start=0, end=216, parallel=2,
                                      write_wav=False, out_dir=str(tmp_path / dev.type),
                                      log_path=str(tmp_path / dev.type) + "/", max_sim_time=60,
                                      device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert mel_power_cuda.launches == launches + 2
    card, cpu = out["cuda"].cpu(), out["cpu"]
    assert card.shape == cpu.shape == (2, 128, 216) and bool(torch.isfinite(card).all())
    for i in range(2):
        above = cpu[i] > cpu[i].min() + 10.0
        torch.testing.assert_close(card[i][above], cpu[i][above], rtol=0, atol=0.05)
        torch.testing.assert_close(card[i], cpu[i], rtol=0, atol=0.2)


# ------------------------------------------------------------ GAN-DES training


def _gandes_inputs(seed=0, batch=8):
    """Real and fake mel batches at mel-dB scale (the second fake at a tenth of
    it, so the reinforce rewards differ), noise, and matrices in [0, 1)."""
    rng = np.random.RandomState(seed)
    real, fake = (rng.rand(batch, 128, 216).astype(np.float32) * 80 - 80 for _ in range(2))
    fake[1] /= 10.0
    noise = rng.randn(batch, 100).astype(np.float32)
    return [torch.from_numpy(a) for a in (real, fake, noise,
                                          rng.rand(batch, 20, 20).astype(np.float32))]


def _gandes_steps(device, mode, n=2, compute_dtype="float32"):
    """``n`` steps of ``mode`` from the seed-0 state on ``device``; returns the
    state, the surrogate state (or None) and the metrics."""
    from gandes_tpu_torch.train import gandes_loop, steps

    cfg = gandes_loop.GanDesConfig(compute_dtype=compute_dtype)
    state = gandes_loop.init_state_for_config(cfg, device)
    s_state = gandes_loop.init_surrogate_for_config(cfg, device) if mode == "surrogate" else None
    step = {"none": steps.make_gandes_train_step(),
            "surrogate": steps.make_gandes_train_step_surrogate(),
            "reinforce": steps.make_gandes_train_step_reinforce(cfg.reinforce_sigma)}[mode]
    metrics = []
    for i in range(n):
        real, fake, noise, mats = (a.to(device) for a in _gandes_inputs(seed=i))
        if mode == "surrogate":
            state, s_state, m = step(state, s_state, real, fake, mats, noise)
        elif mode == "reinforce":
            state, m = step(state, real, fake, mats, noise)
        else:
            state, m = step(state, real, fake)
        metrics.append(m)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return state, s_state, metrics


def _modules_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k].cpu(), sb[k].cpu()) for k in sa)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "surrogate", "reinforce"])
def test_gandes_steps_on_card_repeat_and_match_cpu(cuda, mode):
    """Two GAN-DES steps of each mode at GanDesConfig() width (B = 8) on the
    card, twice: bitwise equal (deterministic cuDNN under
    ``CUDNN_TRAIN_FLAGS``, including the DCGAN's convT backward in the
    surrogate and reinforce modes); the first step's losses against the CPU
    at rtol 1e-4 (the Adams differ: capturable on the card)."""
    a, sa, ma = _gandes_steps(cuda, mode)
    b, sb, mb = _gandes_steps(cuda, mode)
    assert _modules_equal(a.gen, b.gen) and _modules_equal(a.disc, b.disc)
    assert all(torch.equal(x[k], y[k]) for x, y in zip(ma, mb) for k in x)
    if sa is not None:
        assert _modules_equal(sa.model, sb.model) and sa.step == sb.step == 2
    assert a.d_opt.param_groups[0]["capturable"] and a.step == 2
    assert all(st["exp_avg"].is_cuda for st in a.g_opt.state.values())
    _, _, mc = _gandes_steps(torch.device("cpu"), mode, n=1)
    for k in mc[0]:  # G's post-update losses differ by the Adams' rounding
        if k in ("d_loss", "s_loss") or mode == "none":
            assert float(ma[0][k]) == pytest.approx(float(mc[0][k]), rel=1e-4), k


@pytest.mark.cuda
def test_gandes_checkpoint_from_card_restores_on_cpu(cuda, tmp_path):
    """A surrogate-mode state trained on the card saves device-neutral and
    restores into CPU templates bit for bit (the companion too)."""
    from gandes_tpu_torch.train import checkpoint as ckpt
    from gandes_tpu_torch.train import gandes_loop

    state, s_state, _ = _gandes_steps(cuda, "surrogate")
    path = ckpt.save_gandes_state(str(tmp_path / "gen_2_1.0"), state)
    ckpt.save_surrogate_state(path + "_surrogate", s_state)
    cfg = gandes_loop.GanDesConfig()
    cpu = ckpt.restore_gandes_state(path, gandes_loop.init_state_for_config(cfg, "cpu"))
    cpu_s = ckpt.restore_surrogate_state(path + "_surrogate",
                                         gandes_loop.init_surrogate_for_config(cfg, "cpu"))
    assert cpu.step == 2 and cpu_s.step == 2 and not cpu.d_opt.param_groups[0]["capturable"]
    assert _modules_equal(cpu.gen, state.gen) and _modules_equal(cpu.disc, state.disc)
    assert _modules_equal(cpu_s.model, s_state.model)
    for oa, ob in ((cpu.g_opt, state.g_opt), (cpu.d_opt, state.d_opt), (cpu_s.opt, s_state.opt)):
        assert float(oa.param_groups[0]["lr"]) == pytest.approx(float(ob.param_groups[0]["lr"]))
        for pa, pb in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
            assert all(torch.equal(oa.state[pa][k], ob.state[pb][k].cpu())
                       for k in ("step", "exp_avg", "exp_avg_sq"))


def _write_midi(path, seconds=22.0, rate=8.0, seed=0):
    """One piano MIDI file of ``seconds`` of Poisson onsets (the port's
    writer)."""
    from gandes_tpu_torch.music.midi import Message, MetaMessage, MidiFile, MidiTrack

    rng = np.random.RandomState(seed)
    n = rng.poisson(rate * seconds)
    on = np.sort(rng.uniform(0.0, seconds, n))
    ticks = np.round(np.concatenate([on, on + 0.3]) * 960).astype(np.int64)  # 480 tpb, 120 bpm
    is_on = np.concatenate([np.ones(n, bool), np.zeros(n, bool)])
    pitch = rng.randint(40, 90, n)
    track = MidiTrack()
    track.append(MetaMessage("set_tempo", tempo=500000, time=0))
    prev = 0
    for k in np.lexsort((is_on, ticks)):
        i = k % n
        track.append(Message("note_on" if is_on[k] else "note_off", note=int(pitch[i]),
                             velocity=80 if is_on[k] else 0, time=int(ticks[k] - prev)))
        prev = ticks[k]
    mid = MidiFile(ticks_per_beat=480)
    mid.tracks.append(track)
    mid.save(str(path))


@pytest.mark.cuda
def test_gandes_dataset_takes_each_slice_on_the_card(cuda, tmp_path):
    """``MaestroDatasetGanDes`` on a 22 s file: the render stays on the card
    and each 5 s slice's mel is one K2 launch (5 slices, k = 30); with
    k = 3, three sampled slices, three launches. The mels within 0.05 dB of
    the same item on the CPU."""
    import random

    from gandes_tpu_torch.data.datasets import MaestroDatasetGanDes

    _write_midi(tmp_path / "a.mid")
    for k, slices in ((30, 5), (3, 3)):
        ds = MaestroDatasetGanDes(batch_size=k, input_folder=str(tmp_path), device=cuda)
        launches = mel_power_cuda.launches
        random.seed(0)
        mels = ds[0]
        torch.cuda.synchronize()
        assert mels.is_cuda and tuple(mels.shape) == (slices, 128, 216)
        assert mel_power_cuda.launches == launches + slices
        random.seed(0)
        cpu = MaestroDatasetGanDes(batch_size=k, input_folder=str(tmp_path), device="cpu")[0]
        above = cpu > cpu.amin((1, 2), keepdim=True) + 10.0
        torch.testing.assert_close(mels.cpu()[above], cpu[above], rtol=0, atol=0.05)


# ------------------------------------------- MM-GAN surrogate and reinforce

MODE_KNOBS = {
    "surrogate_all_knobs": dict(instance_noise=(2.0, 4), instance_noise_floor=0.5, r1_gamma=1.0,
                                moment_match=1.0, moment_match_cond=1.0),
    "surrogate_r1_fd": dict(r1_gamma=1.0, r1_mode="fd"),
    "reinforce": None,
}


def _mode_steps(device, mode, n=2, capturable=True, compute_dtype="float32"):
    """``n`` steps of ``mode`` at MMGANConfig() width (B = 16) from the seed-0
    states on ``device``, on ``_train_inputs`` (G's outputs in [0, 1));
    the Adams capturable on the card unless ``capturable`` is False (the
    CPU's configuration). Returns the state, the surrogate state (or None)
    and the metrics."""
    from gandes_tpu_torch.train import mmgan_loop, steps

    cfg = mmgan_loop.MMGANConfig(compute_dtype=compute_dtype)
    state, scheds = mmgan_loop.init_state_for_config(cfg, device=device)
    s_state = None
    if MODE_KNOBS[mode] is None:
        step = steps.make_mmgan_train_step_reinforce(*scheds, cfg.reinforce_sigma)
    else:
        s_state = mmgan_loop.init_surrogate_for_config(cfg, device)
        step = steps.make_mmgan_train_step_surrogate(*scheds, **MODE_KNOBS[mode])
    if not capturable:
        state.g_opt, state.d_opt = (
            torch.optim.Adam(p, lr=0.0, betas=steps.ADAM_BETAS, eps=steps.ADAM_EPS)
            for p in (steps.g_parameters(state.model), state.model.discriminator.parameters()))
        if s_state is not None:
            s_state.opt = torch.optim.Adam(s_state.model.parameters(), lr=cfg.surrogate_lr,
                                           betas=steps.ADAM_BETAS, eps=steps.ADAM_EPS)
    metrics = []
    for i in range(n):
        real, fake, beats, n1, n2, aux = (a.to(device) for a in _train_inputs(seed=i))
        rng = np.random.RandomState(100 + i)
        mats, vec = (torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(device)
                     for shape in ((16, 64, 64), (16, 20)))
        args = (real, fake, mats, vec, n1, n2, beats, aux)
        if s_state is not None:
            state, s_state, m = step(state, s_state, *args)
        else:
            state, m = step(state, *args)
        metrics.append(m)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return state, s_state, metrics


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODE_KNOBS))
def test_mmgan_mode_steps_on_card_repeat_and_match_cpu(cuda, mode):
    """Two steps of each mode on the card, twice: bitwise equal (the
    surrogate's R1 double backward and the G-loss forwards included). One
    step on the card against the CPU with the CPU's Adam configuration:
    losses rtol 1e-4, D's and the surrogate's gradients rtol 1e-4 with an
    absolute floor of 1e-4 of each tensor's largest element. G's gradients
    are read through each device's own post-update D and pass through four
    train-mode BatchNorms whose one-pass variance limits float32 (PERF.md
    §6); ``chip_smoke.py`` holds them."""
    a, sa, ma = _mode_steps(cuda, mode)
    b, sb, mb = _mode_steps(cuda, mode)
    assert _cuda_states_equal(a, b) and a.step == 2
    assert all(torch.equal(x[k], y[k]) for x, y in zip(ma, mb) for k in x)
    if sa is not None:
        assert _modules_equal(sa.model, sb.model) and sa.step == sb.step == 2
    card, card_s, mc = _mode_steps(cuda, mode, n=1, capturable=False)
    cpu, cpu_s, mp = _mode_steps(torch.device("cpu"), mode, n=1)
    for k in mp[0]:
        assert float(mc[0][k]) == pytest.approx(float(mp[0][k]), rel=1e-4), k
    pairs = [(card.model.discriminator, cpu.model.discriminator)]
    if card_s is not None:
        pairs.append((card_s.model, cpu_s.model))
    for m_card, m_cpu in pairs:
        for (name, p), q in zip(m_card.named_parameters(), m_cpu.parameters(), strict=True):
            torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=1e-4,
                                       atol=1e-4 * float(q.grad.abs().max()),
                                       msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
def test_two_carry_scan_and_regression_scan_on_card(cuda):
    """``make_scanned_steps(K=4, n_carry=2)`` of the surrogate step with every
    knob on, called twice (4 eager warm-up steps, then one replay of a
    captured graph of 4, each step reading its own draws), against 8 eager
    steps: both states and the metrics bit for bit; the regression scan
    (K = 4) the same way against 8 single regression steps."""
    from gandes_tpu_torch.train import mmgan_loop, steps

    cfg = mmgan_loop.MMGANConfig()

    def fresh():
        st, scheds = mmgan_loop.init_state_for_config(cfg, device=cuda)
        return st, mmgan_loop.init_surrogate_for_config(cfg, cuda), scheds

    real, fake, beats, n1, n2, aux = (a.to(cuda) for a in _train_inputs(seed=3))
    rng = np.random.RandomState(7)
    mats = torch.from_numpy(rng.rand(16, 64, 64).astype(np.float32)).to(cuda)
    vec = torch.from_numpy(rng.rand(16, 20).astype(np.float32)).to(cuda)
    args = (real, fake, mats, vec, n1, n2, beats, aux)
    (single, single_s, scheds), (scan, scan_s, _) = fresh(), fresh()
    knobs = MODE_KNOBS["surrogate_all_knobs"]
    one = steps.make_mmgan_train_step_surrogate(*scheds, **knobs)
    metrics = [one(single, single_s, *args)[2] for _ in range(8)]
    scanned = steps.make_scanned_steps(steps.make_mmgan_train_step_surrogate(*scheds, **knobs), 4,
                                       n_carry=2)
    stacked = [scanned(scan, scan_s, *args)[2] for _ in range(2)]
    torch.cuda.synchronize()
    assert _cuda_states_equal(single, scan) and scan.step == 8 and scan_s.step == 8
    assert _modules_equal(single_s.model, scan_s.model)
    for k in ("d_loss", "g_loss", "s_loss"):
        assert torch.equal(torch.cat([s[k] for s in stacked]), torch.stack([m[k] for m in metrics]))

    (_, reg_single, _), (_, reg_scan, _) = fresh(), fresh()
    one = steps.make_surrogate_regression_step()
    losses = [one(reg_single, mats, vec, fake)[1]["s_loss"] for _ in range(8)]
    run = steps.make_surrogate_regression_scan(4)
    scanned_losses = torch.cat([run(reg_scan, mats, vec, fake)[1] for _ in range(2)])
    torch.cuda.synchronize()
    assert torch.equal(scanned_losses, torch.stack(losses)) and reg_scan.step == 8
    assert _modules_equal(reg_single.model, reg_scan.model)


# ------------------------------------------------- bfloat16 mixed precision


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "direct"])
def test_bf16_captured_steps_equal_eager_steps(cuda, mode):
    """``compute_dtype='bf16'``: 3 steps, the G forward's graph and the
    step's graph against the eager forward and step, bit for bit; the
    params, Adam moments and BatchNorm statistics stay float32."""
    from gandes_tpu_torch.train.steps import (
        graph_gen_forward,
        graph_step,
        make_mmgan_gen_forward,
        make_mmgan_train_step,
    )

    (eager, captured), scheds = _graph_states(cuda, compute_dtype="bf16")
    assert captured.model.discriminator.compute_dtype == torch.bfloat16
    step = make_mmgan_train_step(*scheds, g_update=mode)
    graphed = graph_step(make_mmgan_train_step(*scheds, g_update=mode))
    fwd, fwd_graph = make_mmgan_gen_forward(), graph_gen_forward(make_mmgan_gen_forward())
    for i in range(3):
        g_args = _step_args("direct", 20 + i, cuda)[2:]
        for a, b in zip(fwd(eager, *g_args), fwd_graph(captured, *g_args)):
            assert a.dtype == torch.float32 and torch.equal(a, b), i
        args = _step_args(mode, 10 + i, cuda)
        _, m_eager = step(eager, *args)
        _, m_graph = graphed(captured, *args)
        assert all(torch.equal(m_eager[k], m_graph[k]) for k in m_eager), i
    torch.cuda.synchronize()
    assert _cuda_states_equal(eager, captured) and captured.step == 3
    assert all(t.dtype == torch.float32 for t in captured.model.state_dict().values()
               if t.is_floating_point())
    assert all(st["exp_avg"].dtype == torch.float32 for st in captured.d_opt.state.values())


@pytest.mark.cuda
def test_bf16_scans_equal_single_steps(cuda):
    """At bfloat16, ``make_scanned_steps`` K = 4 of the direct step against 8
    single captured steps, and the two-carry scan of the surrogate step with
    every knob against 8 eager steps: states and metrics bit for bit."""
    from gandes_tpu_torch.train import mmgan_loop, steps

    (single, scanned_state), scheds = _graph_states(cuda, steplr_epochs=3, compute_dtype="bf16")
    args = _step_args("direct", 40, cuda)
    graphed = steps.graph_step(steps.make_mmgan_train_step(*scheds, g_update="direct"))
    metrics = [graphed(single, *args)[1] for _ in range(8)]
    scanned = steps.make_scanned_steps(steps.make_mmgan_train_step(*scheds, g_update="direct"), 4)
    stacked = [scanned(scanned_state, *args)[1] for _ in range(2)]
    assert _cuda_states_equal(single, scanned_state)
    for k in ("d_loss", "g_loss"):
        assert torch.equal(torch.cat([s[k] for s in stacked]), torch.stack([m[k] for m in metrics]))

    cfg = mmgan_loop.MMGANConfig(compute_dtype="bf16")

    def fresh():
        st, sch = mmgan_loop.init_state_for_config(cfg, device=cuda)
        return st, mmgan_loop.init_surrogate_for_config(cfg, cuda), sch

    real, fake, beats, n1, n2, aux = (a.to(cuda) for a in _train_inputs(seed=3))
    rng = np.random.RandomState(7)
    mats = torch.from_numpy(rng.rand(16, 64, 64).astype(np.float32)).to(cuda)
    vec = torch.from_numpy(rng.rand(16, 20).astype(np.float32)).to(cuda)
    s_args = (real, fake, mats, vec, n1, n2, beats, aux)
    (one_st, one_s, sch), (scan_st, scan_s, _) = fresh(), fresh()
    knobs = MODE_KNOBS["surrogate_all_knobs"]
    one = steps.make_mmgan_train_step_surrogate(*sch, **knobs)
    metrics = [one(one_st, one_s, *s_args)[2] for _ in range(8)]
    scan = steps.make_scanned_steps(steps.make_mmgan_train_step_surrogate(*sch, **knobs), 4,
                                    n_carry=2)
    stacked = [scan(scan_st, scan_s, *s_args)[2] for _ in range(2)]
    torch.cuda.synchronize()
    assert _cuda_states_equal(one_st, scan_st) and _modules_equal(one_s.model, scan_s.model)
    for k in ("d_loss", "g_loss", "s_loss"):
        assert torch.equal(torch.cat([s[k] for s in stacked]), torch.stack([m[k] for m in metrics]))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["surrogate_all_knobs", "reinforce"])
def test_bf16_mmgan_mode_steps_repeat(cuda, mode):
    """Two bfloat16 steps of the surrogate (every knob) and reinforce modes,
    twice: bitwise equal."""
    a, sa, ma = _mode_steps(cuda, mode, compute_dtype="bf16")
    b, sb, mb = _mode_steps(cuda, mode, compute_dtype="bf16")
    assert a.model.generator1.compute_dtype == torch.bfloat16
    assert _cuda_states_equal(a, b) and a.step == 2
    assert all(torch.equal(x[k], y[k]) for x, y in zip(ma, mb) for k in x)
    if sa is not None:
        assert _modules_equal(sa.model, sb.model)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "surrogate", "reinforce"])
def test_bf16_gandes_steps_repeat(cuda, mode):
    """Two bfloat16 GAN-DES steps of each mode, twice: bitwise equal; the
    first step's D loss within bfloat16's reach (rtol 2e-2) of the CPU
    port's bfloat16 step."""
    a, sa, ma = _gandes_steps(cuda, mode, compute_dtype="bf16")
    b, sb, mb = _gandes_steps(cuda, mode, compute_dtype="bf16")
    assert a.disc.compute_dtype == torch.bfloat16
    assert _modules_equal(a.gen, b.gen) and _modules_equal(a.disc, b.disc)
    assert all(torch.equal(x[k], y[k]) for x, y in zip(ma, mb) for k in x)
    if sa is not None:
        assert _modules_equal(sa.model, sb.model)
    _, _, mc = _gandes_steps(torch.device("cpu"), mode, n=1, compute_dtype="bf16")
    assert float(ma[0]["d_loss"]) == pytest.approx(float(mc[0]["d_loss"]), rel=2e-2)


@pytest.mark.cuda
def test_eval_metrics_on_card_match_cpu(cuda):
    """``roll_metrics`` and ``pitch_class_histogram`` (an ``index_add_`` of
    integer counts, exact in any order) on the card equal the CPU's at rtol
    1e-6; ``mel_metrics`` at rtol 1e-5."""
    from gandes_tpu_torch.eval import metrics

    rng = np.random.RandomState(0)
    cells = rng.rand(6, 2, 128, 50) < 0.03
    rolls = torch.from_numpy((rng.randint(1, 127, cells.shape) * cells).astype(np.float32))
    mels = torch.from_numpy(rng.rand(4, 128, 216).astype(np.float32) * -80)
    for fn, x, rtol in ((metrics.roll_metrics, rolls, 1e-6), (metrics.mel_metrics, mels, 1e-5)):
        card, cpu = fn(x.to(cuda)), fn(x)
        for k in cpu:
            assert card[k].is_cuda
            torch.testing.assert_close(card[k].cpu(), cpu[k], rtol=rtol, atol=0)
    hist = metrics.pitch_class_histogram(rolls.to(cuda))
    assert torch.equal(hist.cpu(), metrics.pitch_class_histogram(rolls))


# ------------------------------------------------------------ SF2 playback


def _sf2_render(path, device, notes, **kw):
    import chip_smoke
    from gandes_tpu_torch.music.sf2 import Sf2Synth

    synth = Sf2Synth(path, device=device, **kw)
    mid = chip_smoke._sf2_midi(notes)
    cols, nv, _ = synth.midi_to_voices(mid, chip_smoke.SF2_SR)
    audio = synth.render_midi(mid, sr=chip_smoke.SF2_SR, min_seconds=1.0)
    return audio, 1e-4 if chip_smoke._sf2_uses_fft(cols, nv) else 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("interp", ["cubic", "linear"])
@pytest.mark.parametrize("name", ["plain_loop", "dahdsr", "filter_q", "lfos_pan",
                                  "modenv_sweeps", "effects_sends", "layers_exclusive",
                                  "full_matrix"])
def test_sf2_render_on_card_matches_cpu_and_repeats(cuda, tmp_path, name, interp):
    """Each static branch (the golden fixture cases: filter, swept filter,
    LFOs, mod env, reverb and chorus, exclusive class) on the card vs the
    CPU port: atol 2e-5, 1e-4 where an FFT runs, samples past it (gate
    flips) at most 1e-4 of the clip; a repeat on the card bitwise."""
    import chip_smoke

    build, notes = chip_smoke.SF2_CASES[name]
    path = str(tmp_path / f"{name}.sf2")
    build(path)
    card, atol = _sf2_render(path, cuda, notes, interp=interp)
    again, _ = _sf2_render(path, cuda, notes, interp=interp)
    cpu, _ = _sf2_render(path, "cpu", notes, interp=interp)
    assert card.shape == cpu.shape and np.isfinite(card).all()
    np.testing.assert_array_equal(card, again)
    assert np.count_nonzero(np.abs(card - cpu) > atol) <= 1e-4 * card.size


@pytest.mark.cuda
def test_sf2_bank_above_2_pow_24_samples_on_card(cuda, tmp_path):
    """A sample past 2^24 bank samples renders on the card bit for bit as
    the same sample at the bank's start (start-relative float32 positions,
    int64 indices), and as the CPU port within 2e-5."""
    import chip_smoke
    from gandes_tpu_torch.music import sf2

    m = sf2
    spec = {"name": "s", "data": chip_smoke._sine(3000, 37, 0.4), "sample_rate": 22050,
            "original_pitch": 60, "loop_start": 300, "loop_end": 2700}
    zone = {"sample": 0, "gens": {m.G_SAMPLE_MODES: 1, m.G_HOLD_VOL: 2786,
                                  m.G_VIB_LFO_TO_PITCH: 60}}
    preset = [{"name": "p", "program": 0, "zones": [{"instrument": 0}]}]
    small, big = str(tmp_path / "small.sf2"), str(tmp_path / "big.sf2")
    m.build_sf2(small, samples=[spec], instruments=[{"name": "i", "zones": [zone]}],
                presets=preset)
    filler = {"name": "pad", "data": np.zeros((1 << 24) + 1000, np.int16), "sample_rate": 22050}
    m.build_sf2(big, samples=[filler, spec],
                instruments=[{"name": "i", "zones": [dict(zone, sample=1)]}], presets=preset)
    notes = [(67, 100, 0.0, 0.8)]
    on_big, _ = _sf2_render(big, cuda, notes)
    on_small, _ = _sf2_render(small, cuda, notes)
    cpu, _ = _sf2_render(small, "cpu", notes)
    np.testing.assert_array_equal(on_big, on_small)
    np.testing.assert_allclose(on_big, cpu, atol=2e-5)
    assert np.abs(on_big).max() > 0.1


@pytest.mark.cuda
def test_sf2_render_events_stays_on_the_card(cuda, tmp_path):
    """``synth.render_events(sound_font=..., as_tensor=True)`` returns the
    bucketed render on the card, from one cached bank per device."""
    import chip_smoke
    from gandes_tpu_torch.music import synth

    path = str(tmp_path / "f.sf2")
    chip_smoke.SF2_CASES["full_matrix"][0](path)
    rng = np.random.RandomState(0)
    n = 40
    ons = np.sort(rng.uniform(0, 1.5, n)).astype(np.float32)
    events = (rng.randint(40, 90, n).astype(np.int32), rng.randint(30, 128, n).astype(np.float32),
              ons, ons + 0.3, np.zeros(n, np.int32), n, float(ons.max() + 0.3))
    audio, true_len = synth.render_events(events, as_tensor=True, sound_font=path, device=cuda)
    assert audio.device.type == "cuda" and audio.shape[0] >= true_len
    assert synth._get_sf2_synth(path, device=cuda).bank.device.type == "cuda"
    cpu = synth.render_events(events, sound_font=path, device="cpu")
    np.testing.assert_allclose(audio[:true_len].cpu().numpy(), cpu, atol=1e-4)
