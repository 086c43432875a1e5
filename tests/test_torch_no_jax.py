"""sprc_tpu_torch imports neither JAX, Flax nor any sprc_tpu module.

In a fresh interpreter, ``jax``, ``flax`` and ``sprc_tpu`` are made
unimportable (``sys.modules[name] = None``) and every module of the port is
imported (the native data-plane's ``native/`` and ``data/native.py`` among
them); importing builds no kernel and no data-plane library.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "flax", "sprc_tpu"):
    sys.modules[name] = None
import sprc_tpu_torch
mods = ["sprc_tpu_torch"]
for info in pkgutil.walk_packages(sprc_tpu_torch.__path__, "sprc_tpu_torch."):
    importlib.import_module(info.name)
    mods.append(info.name)
from sprc_tpu_torch.ops import _ext
assert _ext._lib is None, "importing built the kernels"
from sprc_tpu_torch.data import native
assert native._LIB is None, "importing built the data-plane"
assert {"sprc_tpu_torch.native", "sprc_tpu_torch.native.build", "sprc_tpu_torch.data.native"} <= set(mods)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "sprc_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(mods))
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 30
