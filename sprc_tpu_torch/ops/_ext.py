"""Build and bind the CUDA kernels of ``sprc_tpu_torch/csrc``.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``, which
``wgmma`` and ``setmaxnreg`` need; C++20), one process per ``.cu`` file and
all of them at once, and linked into one shared library with a plain C
interface that is loaded through ``ctypes``. The link step names no library:
the one function of ``libcuda`` the kernels need (``cuTensorMapEncodeTiled``,
for the GEMMs' TMA tensor maps) is looked up there by name at run time. The build
happens at the first call of :func:`library`, never at import (the CPU
tests import every module of the package), and its output is cached in
``sprc_tpu_torch/_build/`` under a hash of the sources and flags, so a
second process reuses it.

    python -m sprc_tpu_torch.ops._ext [--jobs N]

rebuilds the library whatever the cache holds and prints the seconds it
took, as JSON: with ``--jobs 1`` the time of the build one source after
another, beside which the default stands.

Every C entry point launches on the stream it is given, does not
synchronise and returns ``cudaGetLastError()``; :func:`check` turns a
nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

PKG_ROOT = Path(__file__).resolve().parent.parent
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++20", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# dtype / activation codes shared with csrc/common.cuh
F32, BF16 = 0, 1
ACT = {None: 0, "quick_gelu": 1, "gelu": 2}
# output modes of sprc_gemm_i8, shared with csrc/gemm_i8.cu
OUT_S32, OUT_F32, OUT_BF16, OUT_S8 = 0, 1, 2, 3

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "sprc_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sprc_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _F, _I, _P],
    "sprc_attention_f32_warps": [_I],
    "sprc_layernorm": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    "sprc_layernorm_q8": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _P],
    "sprc_gemm_i8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P],
    "sprc_quantize_static": [_P, _P, _LL, _F, _I, _P],
    "sprc_quantize_rows": [_P, _P, _P, _I, _I, _I, _P],
    "sprc_token_max_sim": [_P, _P, _P, _I, _I, _I, _I, _P],
}

_lib = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libsprc_kernels_{digest.hexdigest()[:16]}.so"


def build(jobs: Optional[int] = None, force: bool = False) -> Path:
    """Compile the sources unless the cached library for them exists (or
    ``force``). ``jobs`` nvcc processes run at once; by default one per
    source, all started together."""
    out = library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        t0 = time.perf_counter()

        def compile_one(src):
            obj = os.path.join(tmp, src.stem + ".o")
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            return obj, proc.returncode, (f"==> {src.name} (exit {proc.returncode}, done "
                                          f"{time.perf_counter() - t0:.1f} s after the start)\n"
                                          f"{proc.stdout}")

        with ThreadPoolExecutor(max_workers=jobs or len(srcs)) as pool:
            done = list(pool.map(compile_one, srcs))
        logs = [log for _, _, log in done]
        failed = [src.name for src, (_, code, _) in zip(srcs, done) if code != 0]
        lib = os.path.join(tmp, "lib.so")
        if not failed:
            link = subprocess.run([nvcc, "-shared", "-o", lib, *(obj for obj, _, _ in done)],
                                  capture_output=True, text=True)
            logs.append(f"==> link (exit {link.returncode})\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append("link")
        (BUILD_DIR / "nvcc.log").write_text("\n".join(logs))
        if failed:  # the message ends with the failed steps' own output
            failed_logs = [log for log in logs if "(exit 0" not in log.split("\n", 1)[0]]
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(failed_logs)[-4000:])
        os.replace(lib, out)  # atomic: a concurrent build sees all or nothing
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def main(argv=None) -> None:
    import argparse
    import json

    ap = argparse.ArgumentParser(description="Rebuild the kernel library and time the build.")
    ap.add_argument("--jobs", type=int, default=None,
                    help="nvcc processes at once (default: one per source)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    build(jobs=args.jobs, force=True)
    print(json.dumps({"sources": len(list(CSRC.glob("*.cu"))), "jobs": args.jobs,
                      "build_s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
