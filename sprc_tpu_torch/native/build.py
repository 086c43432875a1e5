"""Build the native data-plane shared library.

``dataplane.cpp`` (libjpeg / libpng decode, PIL-compatible bicubic,
targetpad, CLIP normalisation, a ``std::thread`` batch API, a C ABI) is
compiled with ``g++`` into ``sprc_tpu_torch/_build/libsprc_dataplane.so``.
:mod:`sprc_tpu_torch.data.native` calls :func:`build` at first use, never at
import; the library is rebuilt when ``dataplane.cpp`` is newer than it. A
failed compile raises with the compiler's output.

    python -m sprc_tpu_torch.native.build [--force]
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "dataplane.cpp"
BUILD_DIR = HERE.parent / "_build"
OUT = BUILD_DIR / "libsprc_dataplane.so"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-ljpeg", "-lpng"]


def build(force: bool = False) -> Path:
    if not force and OUT.exists() and OUT.stat().st_mtime >= SRC.stat().st_mtime:
        return OUT
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = OUT.with_name(f"{OUT.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp), *LIBS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}"[-4000:])
    os.replace(tmp, OUT)  # atomic: a concurrent build sees all or nothing
    return OUT


if __name__ == "__main__":
    print(f"built {build(force='--force' in sys.argv)}")
