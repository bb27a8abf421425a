"""MM-GAN training through the DES: ``train_mmgan`` itself, as users run it,
in a closed loop over real windows made from ``--seed``.

Set-up writes the start state (the configuration's ``weight_seed`` weights
and fresh Adams) as the ``mmgan_64_64_epoch_1`` checkpoint that the loop
resumes from, so ``--seed`` reaches only the loop's ``cfg.seed`` (its z
stream), the global numpy stream of the host stage, and the windows. The
window opens when the loop pulls the batch after ``warm`` steps and closes
at the first batch it pulls ``--seconds`` later: its rate is every step
completed in between over that time. The loop is then stopped from its
data; where its first epoch has not ended yet (that epoch's loss pickle
holds the losses the check compares), it runs on to that end first.

Traffic (the cell's ``traffic``): ``batch_size``, ``steps_per_epoch``,
``lr``, ``des_parallel``, ``save_interval``, ``print_interval``, ``warm``,
the windows' ``notes_per_s`` and ``beats_per_min`` range, and
``trace_seconds``, the window's last stretch that the traced run traces.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import time

import numpy as np
import torch

from portbench import flops
from portbench import trace as tr
from portbench import weights
from portbench.checks import held, sim_pool, train_checks


class WindowClosed(Exception):
    """Raised from the data to stop the loop once the window has closed."""


def make_windows(n: int, t: int, seed: int, notes_per_s: float, bpm: tuple):
    """``n`` real (velocity roll, duration roll, beats) windows of ``t`` one-second
    columns: Poisson note onsets at ``notes_per_s`` (MAESTRO v3.0.0's piano
    rate), pitches around middle C, velocities around 64, durations of a
    few columns, beats at a tempo drawn in ``bpm``."""
    rng = np.random.default_rng([seed, 7])
    counts = rng.poisson(notes_per_s * t, n)
    win = np.repeat(np.arange(n), counts)
    total = int(counts.sum())
    on = rng.integers(0, t, total)
    pitch = np.clip(np.rint(rng.normal(64, 12, total)), 21, 108).astype(np.int64)
    vel = np.clip(np.rint(rng.normal(64, 16, total)), 1, 127).astype(np.float32)
    dur = np.minimum(rng.geometric(0.6, total) - 1, t - 1 - on)
    rolls = np.zeros((n, 128, t), np.float32)
    durs = np.zeros((n, 128, t), np.float32)
    rolls[win, pitch, on] = vel
    for j in range(int(dur.max()) if total else 0):
        m = dur > j
        durs[win[m], pitch[m], on[m] + j] = dur[m]
    beats = (np.arange(50, dtype=np.float32)[None, :]
             * (60.0 / rng.uniform(bpm[0], bpm[1], n).astype(np.float32))[:, None])
    return rolls, durs, beats


class Windows:
    """The loop's dataset; it tells the tape when each batch is pulled."""

    def __init__(self, rolls, durs, beats, batch_size, on_batch):
        self.rolls, self.durs, self.beats = rolls, durs, beats
        self.batch_size, self.on_batch = batch_size, on_batch
        self.pulled = 0

    def __len__(self):
        return len(self.rolls)

    def __getitem__(self, i):
        if i % self.batch_size == 0:
            self.pulled += 1
            self.on_batch(self.pulled)
        return self.rolls[i], self.durs[i], self.beats[i]


class Tape:
    """What the check and the readers take from the loop: the state it
    resumed (its handle, from the checkpoint restore), the first three
    steps' host-stage inputs and outputs, D's first Adam moment after step
    1, the parameters at the start and after step 3, the window's edges,
    and the loop's StepTimer."""

    def __init__(self, run, windows_data):
        self.run = run
        self.rolls, self.durs, self.beats = windows_data
        self.state = None
        self.steps = []
        self.timers = []
        self.t0 = self.t_end = None
        self.k0 = self.k_end = None
        self.window_failed = 0
        self.pulls = []  # (batch, time) of each pull inside the window
        B = run.traffic["batch_size"]
        self.reals = [torch.from_numpy(np.stack([self.rolls[s], self.durs[s]], 1))
                      for s in (slice(k * B, (k + 1) * B) for k in range(3))]
        self.step_beats = [torch.from_numpy(self.beats[k * B:(k + 1) * B]) for k in range(3)]

    # ---- taps
    def restore(self, original):
        def restore_state(path, template):
            self.state = original(path, template)
            return self.state
        return restore_state

    def make_decode(self, original):
        traced = self.run.trace

        def make_decode(cfg, force_roll=False):
            inner = original(cfg, force_roll)

            def decode(mats, vec, count):
                if self.t0 is not None and self.t_end is None:
                    fake, failed = decode_labelled(mats, vec, count)
                    self.window_failed += int(failed)
                    return fake, failed
                if len(self.steps) < 3:
                    rng = np.random.get_state()
                    t = time.perf_counter()
                    fake, failed = inner(mats, vec, count)
                    wall = time.perf_counter() - t
                    self.steps.append(dict(
                        count=count, mats=mats.detach().float().cpu().clone(),
                        vec=vec.detach().float().cpu().clone(), rng=rng,
                        fake=fake.detach().cpu().clone(), failed=failed, wall_s=wall,
                        beats=self.step_beats[len(self.steps)]))
                    return fake, failed
                return decode_labelled(mats, vec, count)

            def decode_labelled(mats, vec, count):
                with (torch.profiler.record_function(tr.PREFIX + "host_stage") if traced
                      else contextlib.nullcontext()):
                    return inner(mats, vec, count)

            return decode

        return make_decode

    def timer_class(self, original):
        timers = self.timers

        class Timer(original):
            def __init__(self):
                super().__init__()
                timers.append(self)

        return Timer

    # ---- the data's clock
    def _sync(self):
        if self.run.device == "cuda":
            torch.cuda.synchronize()

    def _params(self, prefixes):
        return {n: p.detach().clone() for n, p in self.state.model.named_parameters()
                if n.startswith(prefixes)}

    def on_batch(self, k):
        run, traffic = self.run, self.run.traffic
        if self.state is None:
            pass  # a test of the window's clock alone
        elif k == 1:
            run.facts["setup_phases_s"]["loop_started"] = time.perf_counter() - run.t_start
            self._sync()
            self.d_params0 = self._params(("discriminator.",))
            self.g_params0 = self._params(("generator1.", "generator2."))
        elif k == 2:  # step 1 done: its gradient from D's Adam's first moment
            self._sync()
            beta1 = self.state.d_opt.param_groups[0]["betas"][0]
            self.d_grad1 = {
                n: (self.state.d_opt.state[p]["exp_avg"].detach().clone() / (1 - beta1)
                    if "exp_avg" in self.state.d_opt.state.get(p, {}) else torch.zeros_like(p))
                for n, p in self.state.model.named_parameters() if n.startswith("discriminator.")}
        elif k == 4:  # step 3 done
            self._sync()
            self.d_params3 = self._params(("discriminator.",))
            self.g_params3 = self._params(("generator1.", "generator2."))
        now = time.perf_counter()
        if k == traffic["warm"] + 1:
            self._sync()
            self.t0, self.k0 = time.perf_counter(), k
            run.setup_s = self.t0 - run.t_start
        elif self.t0 is not None and self.t_end is None:
            self.pulls.append((k, now))
            if now - self.t0 >= run.seconds:
                self._sync()
                self.t_end, self.k_end = time.perf_counter(), k
                run.tracer.close()
            elif now - self.t0 >= run.seconds - traffic["trace_seconds"]:
                run.tracer.armed = True
                run.tracer.poll()
        if self.t_end is not None and (
                os.path.exists(self.losses_path("disc")) or now - self.t_end > 120):
            raise WindowClosed

    def window(self) -> tuple[int, float]:
        """(steps, seconds) of the window: every step completed between the
        pull that opened it and the pull that closed it, over that time."""
        return self.k_end - self.k0, self.t_end - self.t0

    def losses_path(self, name):
        return os.path.join(self.run.dir, "losses", f"{name}_losses_epoch_2.pkl")



def run(run):
    import gandes_tpu_torch.train.mmgan_loop as ml
    from gandes_tpu_torch.train import checkpoint as ckpt

    cfg, traffic, device = run.config, run.traffic, run.device
    phases = run.facts.setdefault("setup_phases_s", {})
    mark = lambda name: phases.__setitem__(name, time.perf_counter() - run.t_start)
    mark("imported")
    B, spe = traffic["batch_size"], traffic["steps_per_epoch"]
    data = make_windows(B * spe, cfg["sequence_length"], run.seed, traffic["notes_per_s"],
                        traffic["beats_per_min"])
    mark("windows")
    sd = weights.mmgan_weights(cfg, device)
    mark("weights")
    prog_cfg = ml.MMGANConfig(
        batch_size=B, noise_dim=cfg["noise_dim"], adj_size=tuple(cfg["adj_size"]),
        sequence_length=cfg["sequence_length"], max_beat_length=cfg["max_beat_length"],
        gen2_output_dim=cfg["gen2_output_dim"], start=cfg["start"],
        instrument=cfg["instrument"], lr=traffic["lr"], g_update="none",
        num_epochs=traffic["num_epochs"], save_interval=traffic["save_interval"],
        print_interval=traffic["print_interval"], des_parallel=traffic["des_parallel"],
        models_dir=os.path.join(run.dir, "models"), losses_dir=os.path.join(run.dir, "losses"),
        log_path=os.path.join(run.dir, "logs") + "/",
        midi_out_dir=os.path.join(run.dir, "midi"), resume=True, seed=run.seed,
        profile=run.trace)
    start, _ = ml.init_state_for_config(prog_cfg, spe, device="cpu")
    start.model.load_state_dict({k: v.cpu() for k, v in sd.items()}, strict=True)
    ckpt.save_state(os.path.join(prog_cfg.models_dir, "mmgan_64_64_epoch_1"), start)
    del start
    mark("start_checkpoint")

    tape = run.tape = Tape(run, data)
    run.tracer = tr.Tracer(run.trace)
    run.tracer.warm()
    windows = Windows(*data, B, tape.on_batch)
    np.random.seed(run.seed % 2**32)  # the host stage's global stream
    with tr.patched([(ckpt, "restore_state", tape.restore(ckpt.restore_state)),
                     (ml, "make_decode", tape.make_decode(ml.make_decode)),
                     (ml, "StepTimer", tape.timer_class(ml.StepTimer))]):
        try:
            ml.train_mmgan(windows, prog_cfg, steps_per_epoch=spe, device=device)
        except WindowClosed:
            pass
    if tape.t_end is None:
        raise RuntimeError("the loop ended before the window closed: more epochs are needed")
    run.tracer.close()
    if device == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()

    steps, window_s = tape.window()
    run.attempted = steps * B
    # a sim that missed its watchdog leaves a blank roll: a failed sample
    run.failed = tape.window_failed
    run.end_to_end["train_steps_per_s"] = steps / window_s
    samples = tape.timers[0].samples if tape.timers else {}
    win = slice(tape.k0 - 1, tape.k_end - 1)
    run.readings.update(
        steps=steps, window_s=window_s, step_flops=flops.mmgan_none_step(B, cfg["sequence_length"]),
        host_des_s=list(samples.get("host_des", [])[win]),
        device_step_s=list(samples.get("device_step", [])[win]))
    edges = [tape.t0 + 10.0 * i for i in range(1, int(window_s // 10) + 1)]
    marks = [(tape.k0, tape.t0)] + [next(p for p in tape.pulls if p[1] >= e) for e in edges
                                    if any(p[1] >= e for p in tape.pulls)]
    run.facts["steps_per_s_by_10s"] = [round((b[0] - a[0]) / (b[1] - a[1]), 3)
                                       for a, b in zip(marks, marks[1:]) if b[1] > a[1]]
    run.facts.update(cpu_count=os.cpu_count(), affinity=sorted(os.sched_getaffinity(0)),
                     torch_threads=torch.get_num_threads(), des_parallel=traffic["des_parallel"],
                     steps_in_window=steps, window_s=window_s, trace_start_s=run.tracer.start_s,
                     first_steps_failed_sims=[s["failed"] for s in tape.steps])

    with open(tape.losses_path("disc"), "rb") as f:
        tape.d_losses = pickle.load(f)
    with open(tape.losses_path("gen"), "rb") as f:
        tape.g_losses = pickle.load(f)
    tape.state = None
    if device == "cuda":
        torch.cuda.empty_cache()
    with sim_pool() as pool:
        run.checks = held(run, "mmgan_train", train_checks(run, sd, tape, pool=pool))
    if run.control:
        run.control_readings = {"tf32": train_checks(run, sd, tape, tf32=True),
                                "half_batch": train_checks(run, sd, tape, half_batch=True)}
