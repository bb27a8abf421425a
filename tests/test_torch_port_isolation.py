"""gandes_tpu_torch imports neither JAX nor anything of gandes_tpu.

Checked twice: a fresh interpreter imports every module of the port (and
chip_smoke.py) and looks at ``sys.modules``; a source scan looks for import
statements of JAX, flax, optax, orbax or gandes_tpu.
"""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "gandes_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax_and_no_reference_package():
    body = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'gandes_tpu' or k.startswith('gandes_tpu.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
        "print('PORT_ISOLATED', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", body], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PORT_ISOLATED" in proc.stdout
    assert len(_port_modules()) >= 20


IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|flax|optax|orbax|gandes_tpu)(?:\.|\s|$)",
                       re.MULTILINE)


def test_port_sources_do_not_import_jax_or_gandes_tpu():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = {str(f.relative_to(REPO)): IMPORT_RE.findall(f.read_text()) for f in files}
    offenders = {k: v for k, v in offenders.items() if v}
    assert not offenders, offenders
    # the pattern catches what it must and spares the port's own name
    assert IMPORT_RE.findall("import jax\nfrom gandes_tpu.music import mel\n"
                             "import gandes_tpu.des\n") == ["jax", "gandes_tpu", "gandes_tpu"]
    assert not IMPORT_RE.findall("from gandes_tpu_torch.music import mel\n"
                                 "import gandes_tpu_torch\n")
