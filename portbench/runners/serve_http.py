"""Generation over HTTP: one client in a closed loop against
``make_http_server(GenerationService(model))`` in this process.

Traffic (the cell's ``traffic``): ``requests_pool`` request seeds drawn once
from ``pool_seed``, sent in an order that ``--seed`` draws (a fresh
permutation each time the pool is used up), ``n`` samples a request,
``warm`` requests before the window, ``check_requests`` of the window's
requests (its slowest among them, the rest drawn from ``--seed``) held to
the reference after the window, and ``trace_seconds``, the window's last
stretch that the traced run traces. Every run serves the same set of
requests, so the seed changes their order and not the work.
"""

from __future__ import annotations

import contextlib
import gc
import http.client
import json
import threading
import time

import numpy as np
import torch

from portbench import trace as tr
from portbench import weights
from portbench.checks import held, serve_checks, wav_samples


class Client:
    def __init__(self, port: int, path: str, body: dict):
        self.port, self.path, self.body = port, path, body

    def request(self, seed: int):
        """``(latency_s, status, reply)`` of one request, timed as the client
        sees it."""
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        try:
            conn.request("POST", self.path, json.dumps({**self.body, "seed": int(seed)}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
            status = resp.status
        finally:
            conn.close()
        latency = time.perf_counter() - t0
        return latency, status, json.loads(raw)


def request_order(traffic: dict, seed: int):
    """The pool of request seeds and an endless order over it."""
    pool = np.random.default_rng(traffic["pool_seed"]).integers(0, 2**31 - 1024,
                                                                traffic["requests_pool"])
    rng = np.random.default_rng(seed)

    def order():
        while True:
            yield from pool[rng.permutation(len(pool))]

    return order()


def p95_latency(latencies, ok) -> float:
    """The 95th percentile of every request's latency; a request that failed
    counts as missing every latency limit (an infinite latency)."""
    p95 = float(np.percentile([lat if good else np.inf for lat, good in zip(latencies, ok)],
                              95))
    return np.inf if np.isnan(p95) else p95  # between two failures


def run(run):
    from gandes_tpu_torch.serve import GenerationService, make_http_server

    cfg, traffic, device = run.config, run.traffic, run.device
    phases = run.facts.setdefault("setup_phases_s", {})
    mark = lambda name: phases.__setitem__(name, time.perf_counter() - run.t_start)
    mark("imported")
    model = cfg["model"]
    make = weights.mmgan_weights if model == "mmgan" else weights.gandes_weights
    sd = make(cfg, device)
    path = f"{run.dir}/weights.pth"
    torch.save({k: v.cpu() for k, v in sd.items()}, path)
    svc = GenerationService(model, torch_checkpoint=path, device=device)
    mark("service")
    taps = capture_taps(model, run.trace, svc)
    server = make_http_server(svc, "127.0.0.1", 0)
    run.tracer = tr.Tracer(run.trace)
    if run.trace:
        svc.generate = tr.labelled(svc.generate, "generate", True)
    thread = threading.Thread(target=server.serve_forever, name="portbench-server")
    thread.start()
    order = request_order(traffic, run.seed)
    client = Client(server.server_address[1], f"/generate/{model}",
                    {"n": traffic["n"], **traffic.get("body", {})})
    replies = []
    try:
        with tr.patched(taps.patches):
            for _ in range(traffic["warm"]):
                client.request(next(order))
            run.tracer.warm()
            if device == "cuda":
                torch.cuda.synchronize()
            taps.captured.clear()
            run.setup_s = time.perf_counter() - run.t_start
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < run.seconds:
                if time.perf_counter() - t0 >= run.seconds - traffic["trace_seconds"]:
                    run.tracer.armed = True
                    run.tracer.poll()  # between two requests
                seed = int(next(order))
                latency, status, reply = client.request(seed)
                replies.append((seed, latency, status, reply))
            window_s = time.perf_counter() - t0
            run.tracer.close()
    finally:
        server.shutdown()
        thread.join()
        server.server_close()
    if device == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()

    ok = [status == 200 and not reply.get("failed") for _, _, status, reply in replies]
    run.attempted = len(replies)
    run.failed = run.attempted - sum(ok)
    lat = [r[1] for r in replies]
    run.end_to_end["gen_latency_p95_s"] = p95_latency(lat, ok)
    run.readings.update(
        window_s=window_s, latencies=[r[1] for r in replies],
        server_latencies=[r[3].get("latency_s") for r in replies],
        model=model, n=traffic["n"],
        buckets=[1 << max(0, len(wav_samples(r[3]["wav_b64"][0])) - 1).bit_length()
                 for r in replies if model == "gandes" and r[2] == 200])
    run.facts.update(cpu_count=__import__("os").cpu_count(),
                     affinity=sorted(__import__("os").sched_getaffinity(0)),
                     torch_threads=torch.get_num_threads(), requests_in_window=len(replies),
                     failed=run.failed, window_s=window_s, p50_s=float(np.median(lat)),
                     trace_start_s=run.tracer.start_s)

    captured = list(taps.captured)
    del svc, server
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    run.checks = held(run, f"{model}_serve", serve_checks(run, sd, replies, captured))
    if run.control:
        run.control_readings = {"tf32": serve_checks(run, sd, replies, captured, tf32=True)}



class capture_taps:
    """Keeps, for each request of the window, its generator output, the wall
    time of each of its sims (a sim that took its whole wall budget may have
    been cut by it) and, for GAN-DES, the DCGAN's last convolution before its
    sigmoid and the mel, for the check; in the traced run it also opens a
    ``portbench.<stage>`` range around each stage."""

    def __init__(self, model: str, traced: bool, svc):
        import gandes_tpu_torch.bridge.mmgan_decode as md
        import gandes_tpu_torch.train.mmgan_loop as ml

        self.captured = []
        lab = lambda fn, stage: tr.labelled(fn, stage, traced)
        if model == "mmgan":
            forward, simulate = ml.eval_forward, md.run_simulation

            def eval_forward(*args, **kwargs):
                out = forward(*args, **kwargs)
                self.captured.append({"g": out, "sim_s": []})
                return out

            def run_simulation(sim, num_customers):
                t = time.perf_counter()
                try:
                    return simulate(sim, num_customers)
                finally:
                    self.captured[-1]["sim_s"].append(time.perf_counter() - t)

            self.patches = [(ml, "eval_forward", lab(eval_forward, "generator")),
                            (md, "run_simulation", lab(run_simulation, "des")),
                            (md, "process_adjsim_log_v2", lab(md.process_adjsim_log_v2, "midi"))]
        else:
            import gandes_tpu_torch.bridge.gandes_decode as gd

            to_wav, sim = gd.matrix_to_wav, gd.Sim
            captured, logits = self.captured, []
            # at its published init the DCGAN's sigmoid gives 0.5 to the last
            # bit, so its output alone cannot tell a sound G from none
            svc.gen.conv4.register_forward_hook(
                lambda module, inputs, out: logits.append(out.detach().clone()))

            def matrix_to_wav(matrices, *args, **kwargs):
                entry = {"g": np.array(matrices), "logits": logits.pop() if logits else None,
                         "sim_s": []}
                logits.clear()
                captured.append(entry)
                entry["spec"] = to_wav(matrices, *args, **kwargs)
                return entry["spec"]

            class Sim(sim):
                def run(self, *args, **kwargs):
                    t = time.perf_counter()
                    try:
                        with (torch.profiler.record_function(tr.PREFIX + "des") if traced
                              else contextlib.nullcontext()):
                            return super().run(*args, **kwargs)
                    finally:
                        captured[-1]["sim_s"].append(time.perf_counter() - t)

            self.patches = [(gd, "matrix_to_wav", matrix_to_wav),
                            (gd, "Sim", Sim),
                            (gd, "process_adjsim_log_v1", lab(gd.process_adjsim_log_v1, "midi")),
                            (gd, "render_midi", lab(gd.render_midi, "synth")),
                            (gd, "save_wav", lab(gd.save_wav, "wav"))]
            if traced:  # the range's name carries the mel's input length
                mel = gd.melspectrogram_db_tensor

                def mel_db(waveform, *args, **kwargs):
                    with torch.profiler.record_function(
                            f"{tr.PREFIX}mel.{int(waveform.shape[0])}"):
                        return mel(waveform, *args, **kwargs)

                self.patches.append((gd, "melspectrogram_db_tensor", mel_db))
