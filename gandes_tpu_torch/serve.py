"""Warm-model serving: HTTP generation endpoint over the GAN-DES generator.

Port of ``gandes_tpu/serve.py`` for the ``gandes`` family, with the same
JSON contract:

  GET  /healthz
       -> {"status": "ok", "model": "gandes", "requests": N,
           "avg_latency_s": ..., "busy": ...}
  POST /generate/gandes  {"n": 1, "seed": 0}
       -> {"wav_b64": [...], "mel_shape": [...], "latency_s": ...}

The generator and the mel kernel run on ``device`` (default ``"cuda"``).
Noise comes from ``torch.randn`` with a ``torch.Generator`` seeded by the
request's seed: a different stream from the JAX package's ``jax.random``,
so equal seeds give different (equally valid) songs across the two
packages. The DES stage seeds the process-global numpy RNG with the same
seed, as the JAX package does.

Requests are serialized with a lock: generation couples the device forward
to the host DES stage, which seeds the global numpy RNG — concurrent
requests would interleave those streams. The MM-GAN family is not ported
yet.
"""

from __future__ import annotations

import base64
import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from gandes_tpu_torch import use_f32_numerics

_MMGAN_NOT_PORTED = ("the MM-GAN family is not ported to gandes_tpu_torch yet (it comes "
                     "with the MM-GAN slice); serve it with gandes_tpu")


class BadRequest(ValueError):
    """Client-side error (malformed body, n out of range) -> HTTP 400.
    Internal generation failures stay plain exceptions -> HTTP 500."""


# All services in a process share this generation lock by default:
# generation seeds the process-global numpy RNG, so two concurrent
# generations would interleave the stream and break per-seed byte
# stability. Pass an explicit ``lock`` only to isolate tests.
_GENERATION_LOCK = threading.Lock()


class GenerationService:
    """Loads the generator once; serves repeated generation requests warm.

    ``model``: 'gandes' (matrix -> DES -> MIDI -> synth WAV -> mel).
    ``torch_checkpoint``: a reference-layout generator state_dict (see
    ``train/loading.py``); None keeps the seeded initialisation.
    """

    def __init__(self, model: str = "gandes", torch_checkpoint: str | None = None,
                 max_n: int = 64, lock: threading.Lock | None = None,
                 sound_font: str | None = None, device="cuda"):
        if model in ("mmgan", "both"):
            raise NotImplementedError(_MMGAN_NOT_PORTED)
        if model != "gandes":
            raise ValueError(f"unknown model {model!r}")
        from gandes_tpu_torch.train.gandes_loop import GanDesConfig
        from gandes_tpu_torch.train.loading import gandes_eval_forward, load_gandes_state

        use_f32_numerics()
        self.model = model
        self.max_n = max_n
        self.sound_font = sound_font
        self.device = torch.device(device)
        self._lock = lock or _GENERATION_LOCK
        self.requests = 0
        self._latency_sum = 0.0
        self.cfg = GanDesConfig()
        self.gen, _ = load_gandes_state(self.cfg, torch_checkpoint, device=self.device)
        self._fwd = gandes_eval_forward(self.gen)

    # ------------------------------------------------------------ handlers

    def healthz(self) -> dict:
        n = self.requests
        return {
            "status": "ok",
            "model": self.model,
            "requests": n,
            "avg_latency_s": round(self._latency_sum / n, 4) if n else None,
            "busy": self._lock.locked(),
        }

    def generate(self, n: int = 1, seed: int = 0, wav: bool = False) -> dict:
        """``wav`` is accepted for the JSON contract; GAN-DES replies always
        carry WAVs."""
        if not 1 <= n <= self.max_n:
            raise BadRequest(f"n must be in [1, {self.max_n}], got {n}")
        with self._lock:
            t0 = time.perf_counter()
            out = self._generate_gandes(n, seed)
            dt = time.perf_counter() - t0
            self.requests += 1
            self._latency_sum += dt
            out["latency_s"] = round(dt, 4)
            return out

    def _generate_gandes(self, n, seed) -> dict:
        from gandes_tpu_torch.bridge.gandes_decode import matrix_to_wav

        g = torch.Generator(device=self.device).manual_seed(seed)
        noise = torch.randn(n, self.cfg.z_dim, generator=g, device=self.device)
        mats = self._fwd(noise).cpu().numpy()
        np.random.seed(seed)
        wav_b64 = []
        with tempfile.TemporaryDirectory() as tmp:
            specs = matrix_to_wav(mats, size=20, start=0, end=216, out_dir=tmp,
                                  log_path=os.path.join(tmp, "logs/"),
                                  sound_font=self.sound_font, device=self.device)
            for i in range(n):
                with open(os.path.join(tmp, "wav", f"output_{i}.wav"), "rb") as f:
                    wav_b64.append(base64.b64encode(f.read()).decode())
        return {"wav_b64": wav_b64, "mel_shape": list(specs.shape)}


def make_http_server(service: GenerationService, host: str = "127.0.0.1",
                     port: int = 8472) -> ThreadingHTTPServer:
    """Returns an unstarted ThreadingHTTPServer bound to (host, port);
    call ``serve_forever()`` (and ``shutdown()`` from another thread)."""
    endpoint = f"/generate/{service.model}"

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; the service keeps stats
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, service.healthz())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != endpoint:
                self._reply(404, {"error": f"unknown path {self.path}; "
                                           f"serving {endpoint}"})
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


def run_server(model="gandes", torch_checkpoint=None, host="127.0.0.1", port=8472,
               warmup=True, sound_font=None, device="cuda"):
    """Serve ``model`` until interrupted; ``warmup`` runs one request (kernel
    build, native DES build, first launches) before accepting traffic."""
    service = GenerationService(model=model, torch_checkpoint=torch_checkpoint,
                                sound_font=sound_font, device=device)
    if warmup:
        service.generate(n=1, seed=0)
        print(f"{model} warmup done in {service._latency_sum:.2f}s")
        # keep the warmup out of /healthz request stats
        service.requests = 0
        service._latency_sum = 0.0
    server = make_http_server(service, host, port)
    print(f"serving {model} on http://{host}:{port} "
          f"(POST /generate/{model}, GET /healthz)")
    server.serve_forever()
