"""The comparisons that decide ``correct``: what the measured window produced
against the plain reference (``portbench/reference/``), stage by stage.

Each stage is compared on its own. Where a stage's input is a float that the
next stage cuts to integers (``int(x * 126)`` in the matrix decoders), the
reference runs that stage on the program's input, which the stage before is
held to by its own number; a last-bit difference there would otherwise flip
a note. A sim that may have run into its wall budget (the request, or the
batch's host stage, took as long as the budget) ends by the clock and not
by its customer count, so its output is not a function of its inputs: such
a sim (one whose wall time reached 90 % of its budget) is counted apart
and not compared. ``uncompared`` is held too, so that a check that judged
little of its sample reads not correct: the sampled requests (of the
``check_requests`` asked for) or the training rolls left unjudged. A
sampled request that failed is an answer that never came, and counts as a
mismatch.

Every number is "lower is better" and is held to the cell's ``limits``.
"""

from __future__ import annotations

import base64
import io
import wave

import numpy as np
import torch

from portbench.reference import decode, mel as rmel, models, render

AT_BUDGET = 0.9  # a sim that ran this share of its wall budget may have been cut by it

LIMIT_KEYS = {"mmgan_serve": ("g_rel_gap", "midi_mismatch", "uncompared"),
              "gandes_serve": ("g_logit_gap", "g_max_gap", "wav_mismatch", "mel_rel_l2",
                               "uncompared"),
              "mmgan_train": ("start_gap", "g_rel_gap", "roll_mismatch", "loss_gap",
                              "grad_norm_gap", "param_change_gap", "g_params_moved",
                              "uncompared")}


def held(run, kind: str, worst: dict) -> list:
    """``(name, value, limit)`` of each number the cell's ``limits`` hold."""
    limits = run.traffic["limits"]
    return [(k, worst[k], float(limits[k])) for k in LIMIT_KEYS[kind]]


def wav_samples(b64: str) -> np.ndarray:
    with wave.open(io.BytesIO(base64.b64decode(b64))) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def sample_indices(latencies, k: int, seed: int) -> list[int]:
    """The slowest request and ``k - 1`` others drawn from ``seed``."""
    n = len(latencies)
    slowest = int(np.argmax(latencies))
    rest = [i for i in np.random.default_rng([seed, 1]).permutation(n) if i != slowest]
    return sorted([slowest, *rest[:max(0, k - 1)]])


def rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |prog - ref| over the reference's spread (its std)."""
    return float((prog - ref).abs().max() / ref.std().clamp(min=1e-30))


def power_rel_l2(prog_db: torch.Tensor, ref_db: torch.Tensor) -> float:
    """Relative L2 distance of two mel dB spectrograms taken back to power."""
    p, r = 10.0 ** (prog_db / 10.0), 10.0 ** (ref_db / 10.0)
    return float((p - r).norm() / r.norm())


def serve_checks(run, sd, replies, captured, tf32: bool = False):
    """Hold a sample of the window's requests (``check_requests`` of them)
    to the reference. ``tf32`` computes the reference's float32 products in
    TF32: that is the control, which has to come out not correct."""
    model = run.config["model"]
    mismatch = "midi_mismatch" if model == "mmgan" else "wav_mismatch"
    if len(captured) != len(replies):
        raise RuntimeError(f"{len(captured)} generator outputs for {len(replies)} requests")
    picked = sample_indices([r[1] for r in replies], run.traffic["check_requests"], run.seed)
    device = run.device
    cache = run.readings.setdefault("reference_cache", {})
    worst = {k: 0.0 for k in LIMIT_KEYS[f"{model}_serve"]}
    at_budget = compared = 0
    with models.precision(tf32):
        for i in picked:
            seed, _latency, status, reply = replies[i]
            if status != 200:
                worst[mismatch] += 1
                compared += 1
                continue
            sim_s = max(captured[i]["sim_s"], default=0.0)
            if model == "mmgan":
                out1, out2 = captured[i]["g"]
                rs = np.random.RandomState(seed)
                n1 = torch.from_numpy(rs.randn(1, 50).astype(np.float32)).to(device)
                n2 = torch.from_numpy(rs.randn(1, 50).astype(np.float32)).to(device)
                m, v = models.mmgan_generators(sd, n1, n2, torch.zeros(1, 50, device=device),
                                               torch.from_numpy(models.AUX_INPUT).to(device),
                                               train=False)
                gap = max(rel_gap(out1.float(), m), rel_gap(out2.float(), v))
                worst["g_rel_gap"] = max(worst["g_rel_gap"], gap)
                mat, vec = out1[0].cpu().numpy(), out2[0].cpu().numpy()
                budget = min(float(vec[5]), 1.0)
                if i not in cache:  # the DES stage does not depend on ``tf32``
                    cache[i] = decode.mmgan_generate_midi(
                        mat, vec, seed, start=run.config["start"],
                        end=run.config["start"] + run.config["sequence_length"])
                ref = cache[i]
                prog = reply["midi_b64"][0]
                same = prog is not None and ref == base64.b64decode(prog)
                if not same and sim_s >= AT_BUDGET * budget:
                    at_budget += 1
                    continue
                worst["midi_mismatch"] += not same
                compared += 1
            else:
                mats, spec = captured[i]["g"], captured[i]["spec"]
                z = torch.randn(1, run.config["z_dim"],
                                generator=torch.Generator(device=device).manual_seed(seed),
                                device=device)
                logits = models.dcgan_logits(sd, z)
                prog_logits = captured[i].get("logits")
                worst["g_logit_gap"] = max(worst["g_logit_gap"], (
                    rel_gap(prog_logits.float(), logits)
                    if prog_logits is not None and prog_logits.shape == logits.shape
                    else float("inf")))  # G did not run its last convolution
                worst["g_max_gap"] = max(worst["g_max_gap"], float(
                    (torch.from_numpy(mats).to(device) - torch.sigmoid(logits)[:, 0])
                    .abs().max()))
                if i not in cache:
                    cache[i] = render.gandes_render(mats[0], seed, device)
                wav, q = cache[i]
                prog = wav_samples(reply["wav_b64"][0])
                if prog.shape != wav.shape or not np.array_equal(prog, wav):
                    if sim_s >= AT_BUDGET * run.config["des_budget_s"]:
                        at_budget += 1
                    else:
                        worst["wav_mismatch"] += 1
                        compared += 1
                    continue
                ref_mel = rmel.mel_db(q)[:, :spec.shape[-1]]
                worst["mel_rel_l2"] = max(worst["mel_rel_l2"],
                                          power_rel_l2(spec[0].float(), ref_mel))
                compared += 1
    worst["uncompared"] = float(run.traffic["check_requests"] - compared)
    if not tf32:
        run.facts.update(checked=len(picked), compared=compared, at_budget=at_budget)
    return worst


def _leaf_gaps(prog: dict, ref: dict) -> float:
    """Worst leaf's gap of norms, |‖prog‖ - ‖ref‖| over the larger of the
    leaf's reference norm and the median leaf's; leaves whose reference norm
    is under a thousandth of the median leaf's are left out."""
    names = list(ref)
    ref_n = np.array([float(ref[k].norm()) for k in names])
    prog_n = np.array([float(prog[k].norm()) for k in names])
    med = float(np.median(ref_n))
    keep = ref_n >= med / 1000.0
    return float(np.max(np.abs(prog_n - ref_n)[keep] / np.maximum(ref_n[keep], med)))


def sim_pool():
    """Worker processes for the reference's Python sims (spawned: the parent
    holds a CUDA context), one per CPU; the caller closes it."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                               mp_context=multiprocessing.get_context("spawn"))


def train_checks(run, sd, tape, tf32: bool = False, half_batch: bool = False, pool=None):
    """Hold the first three steps the window's loop took to the reference:
    the start state, G's forward, the host stage, both losses, D's first
    gradient (from its Adam's first moment after one step), the change of
    D's parameters after three steps and G's (none in ``g_update='none'``).
    ``tf32``: the control, as in :func:`serve_checks`; ``half_batch``: the
    fault "half of the batch left out, the mean taken over the rest",
    planted in the reference put in the program's place."""
    device = run.device
    cfg = run.config
    d_keys = [k for k in sd if k.startswith("discriminator.")]
    g_keys = [k for k in tape.g_params0]
    start_gap = max(float((tape.d_params0[k] - sd[k]).abs().max()) for k in d_keys)
    start_gap = max(start_gap, max(float((tape.g_params0[k] - sd[k]).abs().max())
                                   for k in g_keys))
    B = run.traffic["batch_size"]
    g_gap = 0.0
    roll_mismatch = at_budget = 0
    fakes = []
    with models.precision(tf32):
        for step in tape.steps[:3]:
            n1, n2, aux = (x.to(device) for x in models.step_noise(run.seed, step["count"], B,
                                                                    cfg["noise_dim"]))
            beats = step["beats"].to(device)
            m, v = models.mmgan_generators(sd, n1, n2, beats, aux, train=True)
            g_gap = max(g_gap, rel_gap(step["mats"].to(device), m),
                        rel_gap(step["vec"].to(device), v))
            if "reference" not in step:  # the host stage does not depend on the precision
                step["reference"] = decode.mmgan_host_stage(
                    step["mats"].numpy(), step["vec"].numpy(), step["rng"], step["count"],
                    adj_size=tuple(cfg["adj_size"]), instrument=cfg["instrument"],
                    start=cfg["start"], end=cfg["start"] + cfg["sequence_length"],
                    pool=pool)
            ref_rolls, budgets = step["reference"]
            prog = step["fake"].numpy()
            for j in range(B):
                if not np.array_equal(prog[j], ref_rolls[j].astype(np.float32)):
                    # the batch's sims share one native call: its wall time bounds each
                    if step["wall_s"] >= AT_BUDGET * budgets[j]:
                        at_budget += 1
                    else:
                        roll_mismatch += 1
            fakes.append(step["fake"].to(device))
        p0 = {k[len("discriminator."):]: sd[k] for k in d_keys}
        reals = [r.to(device) for r in tape.reals[:3]]
        if half_batch:
            reals, fakes = [r[:B // 2] for r in reals], [f[:B // 2] for f in fakes]
        d_losses, g_losses, g1, p3 = models.d_steps(p0, reals, fakes, [run.traffic["lr"]] * 3)
    prog_losses = list(zip(tape.d_losses[:3], tape.g_losses[:3]))
    loss_gap = max(abs(pl - rl) / max(abs(rl), 1e-12)
                   for pair, rpair in zip(prog_losses, zip(d_losses, g_losses))
                   for pl, rl in zip(pair, rpair))
    grad_gap = _leaf_gaps({k: tape.d_grad1[f"discriminator.{k}"] for k in p0}, g1)
    change_gap = _leaf_gaps({k: tape.d_params3[f"discriminator.{k}"] - p0[k] for k in p0},
                            {k: p3[k] - p0[k] for k in p0})
    g_moved = max(float((tape.g_params3[k] - tape.g_params0[k]).abs().max()) for k in g_keys)
    worst = dict(start_gap=start_gap, g_rel_gap=g_gap, roll_mismatch=float(roll_mismatch),
                 loss_gap=loss_gap, grad_norm_gap=grad_gap, param_change_gap=change_gap,
                 g_params_moved=g_moved, uncompared=float(at_budget))
    if not (tf32 or half_batch):
        run.facts.update(at_budget=at_budget, reference_losses=[d_losses, g_losses],
                         program_losses=prog_losses)
    return worst
