"""Warm-model serving: HTTP generation endpoint over the trained GANs.

Port of ``gandes_tpu/serve.py``, with the same JSON contract:

  GET  /healthz
       -> {"status": "ok", "model": "mmgan", "requests": N,
           "avg_latency_s": ..., "busy": ..., "counters": {...}}
          (with several families: {"status": "ok", "models": {name: ...}})
  POST /generate/mmgan   {"n": 1, "seed": 0, "wav": false}
       -> {"midi_b64": [...], "roll_sums": [...], "failed": F,
           "wav_b64": [...]?, "latency_s": ...}
  POST /generate/gandes  {"n": 1, "seed": 0}
       -> {"wav_b64": [...], "mel_shape": [...], "latency_s": ...}

The generators (and GAN-DES's mel kernel) run on ``device`` (default
``"cuda"``). MM-GAN noise comes from ``np.random.RandomState(seed)`` and the
DES routing stream from ``np.random.seed(seed + i)``, as in the JAX package,
so equal weights and seeds give the two packages' generators equal inputs;
their outputs agree to float32 rounding, and an ulp can move the DES's
sampled times, so songs are equal only on equal generator outputs. GAN-DES noise
comes from ``torch.randn`` with a ``torch.Generator`` seeded by the
request's seed: a different stream from the JAX package's ``jax.random``.

Requests are serialized with a lock: generation couples the device forward
to the host DES stage, which seeds the global numpy RNG — concurrent
requests would interleave those streams.

Each service counts its requests and their summed latency (``stats``, a
``core/profiling.py::Counters``); ``/healthz`` reports them beside
``counters``, the process-wide totals of the host stage (``sims_run``,
``sims_timed_out``, ``sims_capped``, ``sims_budget_cut``, ``sims_failed``,
``des_events``, ``rolls_decoded``, ``decodes_skipped``). While a ``torch.profiler`` runs in
the process, each request records spans, which its trace shows as
``gandes.<name>`` ranges: ``lock_wait`` (the wait for the generation lock),
``request`` (the interval ``latency_s`` times) and inside it ``generator``,
``des``, ``midi`` and, with audio, ``synth``, ``wav`` and ``mel``; then
``http.reply`` (encoding and writing the reply).
"""

from __future__ import annotations

import base64
import itertools
import json
import os
import tempfile
import threading
import time
from dataclasses import replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from gandes_tpu_torch import use_f32_numerics
from gandes_tpu_torch.core.profiling import COUNTERS, Counters, span
from gandes_tpu_torch.data.audio import Base64Text

class BadRequest(ValueError):
    """Client-side error (malformed body, n out of range) -> HTTP 400.
    Internal generation failures stay plain exceptions -> HTTP 500."""


# All services in a process share this generation lock by default:
# generation seeds the process-global numpy RNG, so two concurrent
# generations would interleave the stream and break per-seed byte
# stability. Pass an explicit ``lock`` only to isolate tests.
_GENERATION_LOCK = threading.Lock()
# the trace id of each request's spans
_request_ids = itertools.count(1)


class GenerationService:
    """Loads a model once; serves repeated generation requests warm.

    ``model``: 'mmgan' (matrix+params -> DES -> MIDI) or 'gandes'
    (matrix -> DES -> MIDI -> synth WAV -> mel). ``torch_checkpoint``: a
    reference-layout state_dict (see ``train/loading.py``); None keeps the
    seeded initialisation.
    """

    def __init__(self, model: str = "mmgan", torch_checkpoint: str | None = None,
                 start: int = 100, sequence_length: int = 50, max_n: int = 64,
                 lock: threading.Lock | None = None, sound_font: str | None = None,
                 device="cuda"):
        if model not in ("mmgan", "gandes"):
            raise ValueError(f"unknown model {model!r}")
        use_f32_numerics()
        self.model = model
        self.max_n = max_n
        self.sound_font = sound_font
        self.device = torch.device(device)
        self._lock = lock or _GENERATION_LOCK
        self.stats = Counters(("requests", "latency_ns"))
        if model == "mmgan":
            from gandes_tpu_torch.train.loading import load_mmgan_state
            from gandes_tpu_torch.train.mmgan_loop import MMGANConfig

            self.cfg = MMGANConfig(start=start, sequence_length=sequence_length)
            self.mmgan = load_mmgan_state(self.cfg, torch_checkpoint, device=self.device)
        else:
            from gandes_tpu_torch.train.gandes_loop import GanDesConfig
            from gandes_tpu_torch.train.loading import gandes_eval_forward, load_gandes_state

            self.cfg = GanDesConfig()
            self.gen, _ = load_gandes_state(self.cfg, torch_checkpoint, device=self.device)
            self._fwd = gandes_eval_forward(self.gen)
            self._base64 = Base64Text()

    # ------------------------------------------------------------ handlers

    def healthz(self) -> dict:
        stats = self.stats.snapshot()
        n = stats["requests"]
        return {
            "status": "ok",
            "model": self.model,
            "requests": n,
            "avg_latency_s": round(stats["latency_ns"] * 1e-9 / n, 4) if n else None,
            "busy": self._lock.locked(),
            "counters": COUNTERS.snapshot(),
        }

    def generate(self, n: int = 1, seed: int = 0, wav: bool = False) -> dict:
        """``wav`` adds WAV renders to MM-GAN replies; GAN-DES replies always
        carry WAVs."""
        if not 1 <= n <= self.max_n:
            raise BadRequest(f"n must be in [1, {self.max_n}], got {n}")
        request_id = next(_request_ids)
        with span("lock_wait", trace_id=request_id):
            self._lock.acquire()
        try:
            with span("request", trace_id=request_id, model=self.model, n=n):
                t0 = time.perf_counter_ns()
                if self.model == "mmgan":
                    out = self._generate_mmgan(n, seed, wav)
                else:
                    out = self._generate_gandes(n, seed)
                dt = time.perf_counter_ns() - t0
            self.stats.add(requests=1, latency_ns=dt)
            out["latency_s"] = round(dt * 1e-9, 4)
            return out
        finally:
            self._lock.release()

    def _generate_mmgan(self, n, seed, wav) -> dict:
        # the CLI's inference path (mmgan_loop.generate_midi), per sample
        from gandes_tpu_torch.train.mmgan_loop import generate_midi

        rng = np.random.RandomState(seed)
        midi_b64, wav_b64, roll_sums = [], [], []
        failed = 0
        with tempfile.TemporaryDirectory() as tmp:
            # the DES log stays in the request's temp dir, as GAN-DES's does
            cfg = replace(self.cfg, log_path=os.path.join(tmp, "logs/"))
            for i in range(n):
                noise1 = rng.randn(1, cfg.noise_dim).astype(np.float32)
                noise2 = rng.randn(1, cfg.noise_dim).astype(np.float32)
                beats = np.zeros((1, cfg.max_beat_length), np.float32)
                np.random.seed(seed + i)  # DES routing stream (parity with the CLI)
                rolls = generate_midi(self.mmgan, cfg, noise1, noise2, beats, out_dir=tmp)
                roll_sums.append(float(np.sum(rolls[0])))
                path = os.path.join(tmp, "generation.mid")
                # a failed/timed-out sim leaves no file — report the slot as
                # null rather than silently re-serving the previous sample
                if not os.path.exists(path):
                    failed += 1
                    midi_b64.append(None)
                    if wav:
                        wav_b64.append(None)
                    continue
                with open(path, "rb") as f:
                    midi_b64.append(base64.b64encode(f.read()).decode())
                if wav:
                    from gandes_tpu_torch.data.audio import save_wav
                    from gandes_tpu_torch.music.synth import render_midi

                    audio = render_midi(path, sound_font=self.sound_font, device=self.device)
                    wpath = os.path.join(tmp, "generation.wav")
                    save_wav(wpath, audio)
                    with span("wav"), open(wpath, "rb") as f:
                        wav_b64.append(base64.b64encode(f.read()).decode())
                os.remove(path)  # never re-serve a stale file for sample i+1
        out = {"midi_b64": midi_b64, "roll_sums": roll_sums, "failed": failed}
        if wav:
            out["wav_b64"] = wav_b64
        return out

    def _generate_gandes(self, n, seed) -> dict:
        from gandes_tpu_torch.bridge.gandes_decode import matrix_to_wav

        with span("generator"):
            g = torch.Generator(device=self.device).manual_seed(seed)
            noise = torch.randn(n, self.cfg.z_dim, generator=g, device=self.device)
            mats = self._fwd(noise).cpu().numpy()
        np.random.seed(seed)
        # nothing on disk: the sim's log, the MIDI and the WAVs stay in memory,
        # and each WAV reaches the host once, as its base64 text
        wavs = []
        specs = matrix_to_wav(mats, size=20, start=0, end=216, log_path=None, out_dir=None,
                              wavs=wavs, sound_font=self.sound_font, device=self.device)
        with span("wav"):
            wav_b64 = [self._base64(w) for w in wavs]
        return {"wav_b64": wav_b64, "mel_shape": list(specs.shape)}


def reply_body(payload: dict) -> bytes:
    """``json.dumps(payload).encode()``, with each list under a ``*_b64`` key
    (base64 text, or None) copied in as it is: base64's alphabet needs no
    escaping, and for a clip's megabytes of WAV the scan that ``json.dumps``
    makes for escapes is most of the reply's encoding."""
    pieces = []
    for key, value in payload.items():
        pieces.append(b", " if pieces else b"{")
        if key.endswith("_b64") and isinstance(value, list):
            pieces.append(json.dumps(key).encode() + b": [")
            for i, text in enumerate(value):
                if i:
                    pieces.append(b", ")
                pieces += [b"null"] if text is None else [b'"', text.encode("ascii"), b'"']
            pieces.append(b"]")
        else:
            pieces.append(json.dumps({key: value})[1:-1].encode())
    pieces.append(b"}" if pieces else b"{}")
    return b"".join(pieces)


def make_http_server(service, host: str = "127.0.0.1",
                     port: int = 8472) -> ThreadingHTTPServer:
    """Returns an unstarted ThreadingHTTPServer bound to (host, port);
    call ``serve_forever()`` (and ``shutdown()`` from another thread).

    ``service`` is a :class:`GenerationService` or a dict
    ``{model_name: service}`` to host several model families in one
    process — each keeps its own stats, but all share the process-wide
    generation lock by default (see ``_GENERATION_LOCK``).
    """
    services = service if isinstance(service, dict) else {service.model: service}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; the services keep stats
            pass

        def _reply(self, code: int, payload: dict):
            with span("http.reply") as s:
                body = reply_body(payload)
                s.set(bytes=len(body))
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                healths = {name: svc.healthz() for name, svc in services.items()}
                if len(healths) == 1:
                    self._reply(200, next(iter(healths.values())))
                else:
                    self._reply(200, {"status": "ok", "models": healths})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            service = next((svc for name, svc in services.items()
                            if self.path == f"/generate/{name}"), None)
            if service is None:
                served = ", ".join(f"/generate/{n}" for n in services)
                self._reply(404, {"error": f"unknown path {self.path}; "
                                           f"serving {served}"})
                return
            try:  # request parsing: any failure here is the client's fault
                length = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
                n = int(req.get("n", 1))
                seed = int(req.get("seed", 0))
                wav = bool(req.get("wav", False))
            except (ValueError, TypeError) as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                self._reply(200, service.generate(n=n, seed=seed, wav=wav))
            except BadRequest as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # internal generation failure
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def run_server(model="mmgan", torch_checkpoint=None, host="127.0.0.1", port=8472,
               warmup=True, start=100, sequence_length=50, sound_font=None, device="cuda"):
    """Serve ``model`` until interrupted; ``model='both'`` hosts mmgan AND
    gandes in one process and rejects a checkpoint (it is ambiguous which
    family it targets — run one server per checkpointed model instead).
    ``warmup`` runs one request per family (kernel build, native DES build,
    first launches) before accepting traffic."""
    if model == "both" and torch_checkpoint:
        raise ValueError(
            "--model both cannot take checkpoint args (ambiguous target); "
            "serve each checkpointed model from its own process")
    models = ("mmgan", "gandes") if model == "both" else (model,)
    services = {
        m: GenerationService(model=m, torch_checkpoint=torch_checkpoint, start=start,
                             sequence_length=sequence_length, sound_font=sound_font,
                             device=device)
        for m in models}
    if warmup:
        for m, svc in services.items():
            svc.generate(n=1, seed=0)
            print(f"{m} warmup done in {svc.stats.snapshot()['latency_ns'] * 1e-9:.2f}s")
            svc.stats.reset()  # keep the warmup out of /healthz request stats
    server = make_http_server(services, host, port)
    endpoints = ", ".join(f"POST /generate/{m}" for m in services)
    print(f"serving {'+'.join(services)} on http://{host}:{port} "
          f"({endpoints}, GET /healthz)")
    server.serve_forever()
