"""The dry run of the sharded paths on the card: ``python -m
sprc_tpu_torch.parallel.dryrun --world 1 --device cuda`` (one process, a
NCCL group of one) takes the flagship's live and cached steps, the sharded
gallery with its padding and a rerank tile through kernels K1, K2 and K3,
and holds each against the same work on one device without the mesh. And
``cli/validate.py --mesh`` with no launcher's environment starts its ranks
itself (one a card) and prints the JSON the command prints without it.

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_mesh_cuda.py -m cuda
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return "cuda"


def test_dryrun_at_world_1_over_nccl(cuda):
    out = subprocess.run([sys.executable, "-m", "sprc_tpu_torch.parallel.dryrun", "--world", "1",
                          "--device", cuda], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert (summary["world"], summary["backend"]) == (1, "nccl")
    assert all(summary["launches"][k] > 0 for k in ("token_max_sim", "fused_vit_block",
                                                    "fused_qformer_layer")), summary
    assert summary["gallery"]["n"] == 3 and summary["rerank"]["candidates"] == 2


def test_a_cuda_mesh_runs_over_nccl_only(cuda):
    """A CUDA mesh needs NCCL: ``--device cuda`` never runs over gloo."""
    from sprc_tpu_torch.parallel.mesh import backend_for

    assert backend_for(cuda) == "nccl" and backend_for("cpu") == "gloo"


# a tiny EVA-layout model the card's kernels take (head dims 64), fp32
TINY = ["image_size=28", "num_query_token=4", "max_txt_len=8", "embed_dim=64",
        "vit_dtype=fp32", "qformer_dtype=fp32",
        "qformer_config_override={vocab_size: 30523, hidden_size: 128, num_layers: 2, "
        "num_heads: 2, intermediate_size: 256, encoder_width: 128, query_length: 4, "
        "dropout_rate: 0.0, dtype: fp32}",
        "vit_config_override={image_size: 28, patch_size: 14, width: 128, depth: 2, "
        "num_heads: 2, mlp_hidden: 256, qkv_fused_no_kbias: true, dtype: fp32}"]


def _cirr_val(root: Path) -> None:
    """A CIRR val split of 6 PNG images and 4 queries in the reference's layout."""
    from sprc_tpu_torch.utils.artifacts import encode_png

    rng = np.random.default_rng(5)
    names = [f"im{i}" for i in range(6)]
    (root / "dev").mkdir(parents=True)
    for n in names:
        (root / "dev" / f"{n}.png").write_bytes(
            encode_png(rng.integers(0, 256, (40, 32, 3), dtype=np.uint8)))
    triplets = [{"pairid": i, "reference": names[i], "target_hard": names[i + 1],
                 "caption": f"a red dress {i}",
                 "img_set": {"members": [names[i], names[i + 1], names[i + 2]]}}
                for i in range(4)]
    for sub, name, payload in (("captions", "cap.rc2.val.json", triplets),
                               ("image_splits", "split.rc2.val.json",
                                {n: f"dev/{n}.png" for n in names})):
        (root / "cirr" / sub).mkdir(parents=True)
        (root / "cirr" / sub / name).write_text(json.dumps(payload))


def test_validate_cli_mesh_starts_its_ranks_itself(cuda, tmp_path):
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    _cirr_val(tmp_path)
    vocab = write_synthetic_bert_vocab(str(tmp_path / "vocab.txt"))
    argv = [sys.executable, "-m", "sprc_tpu_torch.cli.validate", "--dataset", "CIRR",
            "--data-path", str(tmp_path), "--vocab-path", vocab, "--encode-batch", "4",
            "--query-batch", "2", "--workers", "2", "--no-bf16", "--model-overrides", *TINY]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    runs = [subprocess.run(argv + extra, cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=600) for extra in ([], ["--mesh"])]
    for run in runs:
        assert run.returncode == 0, run.stderr[-4000:]
    assert json.loads(runs[0].stdout) and runs[1].stdout == runs[0].stdout
