"""rufus_tpu_torch stands alone: no JAX, nothing of rufus_tpu."""

import json
import os
import pkgutil
import subprocess
import sys

import rufus_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import rufus_tpu_torch
names = ["rufus_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(rufus_tpu_torch.__path__,
                                          "rufus_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "rufus_tpu" or m.startswith("rufus_tpu.")
             or m.startswith("jax") and sys.modules[m] is not None)
print(len(names), bad)
"""


def test_port_imports_without_jax_or_rufus_tpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    want = 1 + len(list(pkgutil.walk_packages(rufus_tpu_torch.__path__,
                                              "rufus_tpu_torch.")))
    assert int(n) == want >= 15
    assert bad == "[]", bad


def test_chip_smoke_imports_nothing_of_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            mod = s.split()[1].split(".")[0]
            assert mod not in ("jax", "rufus_tpu"), s


_DECODER_PROBE = r"""
import json
from rufus_tpu_torch.io import native
native._lib()
maps = open("/proc/self/maps").read()
print(json.dumps(sorted({l.split()[-1] for l in maps.splitlines()
                         if "rufus" in l and l.endswith(".so")})))
"""


def test_port_loads_its_own_decoder():
    """The port's decoders are built from its own sources into build/, and
    the JAX package's native/librufus_native.so is never loaded."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _DECODER_PROBE], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    libs = json.loads(out.stdout.strip())
    assert len(libs) == 1, libs
    assert libs[0].startswith(os.path.join(REPO, "build", "rufus_tpu_torch"))
    assert not libs[0].endswith(os.path.join("native", "librufus_native.so"))
