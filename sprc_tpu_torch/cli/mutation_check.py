"""How sharp the card's checks are: a deliberately wrong s8 GEMM against them.

    python -m sprc_tpu_torch.cli.mutation_check

Copies the package into a temporary directory and changes one fp32 rounding
in the copy's ``csrc/gemm_i8.cu``: the epilogue multiplies ``(acc * w_scale)
* a`` where the TPU kernel and the plain version multiply ``acc * (w_scale
* a)``. Only the int8 ViT block passes a static scale ``a``, so only its
products change, by one bf16 step in a few outputs per million. A child
process then builds the copy and runs, over the copy, the checks of
:mod:`sprc_tpu_torch.kernel_checks` that see those products: two products of
the main path with their epilogues, one int8 block against its plain version
(a bound on a whole block's output), and the 23-block chain stage by stage.
It prints one JSON object: per check, whether it caught the mutant
(``ok`` false) and its readings. The repository's own files are not touched.
Needs CUDA and ``nvcc``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
RIGHT = "return __fmul_rn(v, __fmul_rn(cs, alpha));"
WRONG = "return __fmul_rn(__fmul_rn(v, cs), alpha);"
CHILD = """
import json, torch
torch.backends.cuda.matmul.allow_tf32 = False
from sprc_tpu_torch import kernel_checks as kc
rows = {f"gemm_i8 {n}": kc.check_gemm_i8(n) for n in ("vit qkv", "qformer self, all rows")}
rows["K5 vit_block_i8"] = kc.check_vit_block_i8()
rows["K5 vit_tower_i8"] = kc.check_vit_tower_i8()
keep = ("ok", "max_abs_err", "mean_abs_err", "epilogue_differ", "epilogue_max_abs_err", "stages")
print(json.dumps({k: {f: r[f] for f in keep if f in r} for k, r in rows.items()}))
"""


def main() -> dict:
    tmp = Path(tempfile.mkdtemp(prefix="sprc_mutant_"))
    try:
        shutil.copytree(PKG, tmp / PKG.name, ignore=shutil.ignore_patterns("_build", "__pycache__"))
        src = tmp / PKG.name / "csrc" / "gemm_i8.cu"
        text = src.read_text()
        if text.count(RIGHT) != 1:
            raise RuntimeError(f"mutation_check: {src.name} no longer holds `{RIGHT}`")
        text = text.replace(RIGHT, WRONG)
        src.write_text(text)
        child = subprocess.run([sys.executable, "-c", CHILD], cwd=tmp, capture_output=True,
                               text=True, env={**os.environ, "PYTHONPATH": str(tmp)})
        if child.returncode != 0:
            raise RuntimeError(f"mutation_check: the child failed:\n{child.stderr[-4000:]}")
        result = {"mutant": "gemm_i8 epilogue: (acc * w_scale) * a for acc * (w_scale * a)",
                  "checks": json.loads(child.stdout.strip().splitlines()[-1])}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["caught_by"] = [k for k, r in result["checks"].items() if not r["ok"]]
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
