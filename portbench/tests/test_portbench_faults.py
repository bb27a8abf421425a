"""The check that decides ``correct`` sees each fault a cell can have.

Each test skips the harness's look for a card, drives the rest of a small
run on the CPU with the timed path broken underneath, and sees ``correct``
come out false: a step that returns its state unchanged and half of the
batch left out (training); an answer altered where it is produced
(serving). The cells run on one chip, so no exchange between chips can be
left out.
"""

import pytest
import torch

from portbench.tests import small


def _false(name, seed=3, **traffic):
    run, result = small.run(name, seed, **traffic)
    assert result["correct"] is False
    return {k: v["value"] for k, v in result["checks"].items()}


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from gandes_tpu_torch.train import steps

    monkeypatch.setattr(steps, "_adam_step", lambda opt, params, grads, mesh=None: None)
    checks = _false("mmgan.train_none")
    assert checks["param_change_gap"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(monkeypatch):
    from gandes_tpu_torch.train import steps

    loss = steps.mmgan_d_loss

    def half(d, real, fake):
        n = real.shape[0] // 2
        return loss(d, real[:n], fake[:n])

    monkeypatch.setattr(steps, "mmgan_d_loss", half)
    checks = _false("mmgan.train_none")
    assert checks["loss_gap"] > 1e-2


def test_an_mmgan_answer_altered_in_the_generator(monkeypatch):
    import gandes_tpu_torch.train.mmgan_loop as ml

    forward = ml.eval_forward

    def altered(*args, **kwargs):
        out1, out2 = forward(*args, **kwargs)
        return out1 + 1e-3, out2

    monkeypatch.setattr(ml, "eval_forward", altered)
    assert _false("mmgan.serve_n1")["g_rel_gap"] > 1e-3


def test_an_mmgan_answer_altered_in_the_midi(monkeypatch):
    import gandes_tpu_torch.bridge.mmgan_decode as md

    decode = md.process_adjsim_log_v2

    def altered(**kwargs):
        kwargs["note_levels"] = [(int(x) + 1) % 128 for x in kwargs["note_levels"]]
        return decode(**kwargs)

    monkeypatch.setattr(md, "process_adjsim_log_v2", altered)
    assert _false("mmgan.serve_n1")["midi_mismatch"] >= 1


def test_a_gandes_answer_altered_in_the_synth(monkeypatch):
    import gandes_tpu_torch.bridge.gandes_decode as gd

    render = gd.render_midi

    def altered(*args, **kwargs):
        audio, n = render(*args, **kwargs)
        return audio * 0.9, n

    monkeypatch.setattr(gd, "render_midi", altered)
    assert _false("gandes.serve_n1")["wav_mismatch"] >= 1


def test_a_gandes_answer_altered_in_the_mel(monkeypatch):
    import gandes_tpu_torch.bridge.gandes_decode as gd

    mel = gd.melspectrogram_db_tensor
    monkeypatch.setattr(gd, "melspectrogram_db_tensor",
                        lambda wave, *a, **k: mel(wave, *a, **k) + 0.05)
    assert _false("gandes.serve_n1")["mel_rel_l2"] > 1e-3


def test_a_gandes_answer_altered_in_the_generator(monkeypatch):
    from gandes_tpu_torch.models.gan_des import DCGANGenerator

    forward = DCGANGenerator.forward
    monkeypatch.setattr(DCGANGenerator, "forward",
                        lambda self, z, update_stats=True: forward(self, z, update_stats)
                        + torch.full((1,), 1e-3))
    assert _false("gandes.serve_n1")["g_max_gap"] > 0


def test_a_gandes_generator_skipped_for_its_saturated_output(monkeypatch):
    from gandes_tpu_torch.models.gan_des import DCGANGenerator

    monkeypatch.setattr(DCGANGenerator, "forward",
                        lambda self, z, update_stats=True:
                        torch.sigmoid(torch.zeros(z.shape[0], 20, 20, device=z.device)))
    assert _false("gandes.serve_n1")["g_logit_gap"] == "inf"


@pytest.mark.parametrize("name,stage", [("mmgan.serve_n1", "process_adjsim_log_v2"),
                                        ("gandes.serve_n1", "process_adjsim_log_v1")])
def test_a_check_that_could_compare_little_of_its_sample(monkeypatch, name, stage):
    """Every sampled answer altered, and every sim taken as cut by its wall
    budget, so that none is compared: ``uncompared`` alone fails."""
    import gandes_tpu_torch.bridge.gandes_decode as gd
    import gandes_tpu_torch.bridge.mmgan_decode as md
    from portbench import checks as ch

    module = md if name.startswith("mmgan") else gd
    decode = getattr(module, stage)

    def altered(**kwargs):
        kwargs["note_levels"] = [(int(x) + 1) % 128 for x in kwargs["note_levels"]]
        return decode(**kwargs)

    monkeypatch.setattr(module, stage, altered)
    monkeypatch.setattr(ch, "AT_BUDGET", 0.0)
    checks = _false(name, check_requests=5)
    assert checks["uncompared"] == 5
    assert checks["midi_mismatch" if name.startswith("mmgan") else "wav_mismatch"] == 0
