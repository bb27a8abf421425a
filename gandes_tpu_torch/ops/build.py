"""Build a CUDA source of this package into a shared library, at first use.

``nvcc -O3 -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC``
compiles one ``csrc/*.cu`` file with a plain C interface into
``gandes_tpu_torch/_build/<prefix>_<hash>.so``; the hash covers the source
and the flags, so an edited kernel is rebuilt and an unchanged one is not.
The library is loaded with ``ctypes``: no PyTorch headers, no ``ninja``.

Concurrency-safe as ``des/native.py``'s g++ build: each build writes a
pid-suffixed temporary file and ``os.replace``s it in. Unlike that build,
a failure raises: a kernel has no silent fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(f"nvcc not found (looked in {cuda_home}/bin and PATH)")
    return found


def build_cuda_lib(src: str, prefix: str) -> tuple[ctypes.CDLL, str]:
    """Compile ``src`` (cached by content) and return ``(library, log)``;
    ``log`` is nvcc's ``-Xptxas -v`` report (registers, shared memory,
    spills), empty when the library was already built."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"{prefix}_{digest}.so")
    log = ""
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed ({proc.returncode}) on {src}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
            log = proc.stdout + proc.stderr
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(out), log
