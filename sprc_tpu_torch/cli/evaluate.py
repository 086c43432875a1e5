"""Evaluate-only entry over YAML run configs (counterpart of
``sprc_tpu/cli/evaluate.py``, the LAVIS ``evaluate.py``).

Usage:
  python -m sprc_tpu_torch.cli.evaluate --cfg-path configs/runs/eval/ret_coco_blip2_eval.yaml \
      [--model-path ckpt.pth] [--vocab-path vocab.txt] [--split test] \
      [--options key=value ...] [--device cuda]

Ported: the ``retrieval`` task for the BLIP-2 stage-1 models (``blip2``,
``blip2_feature_extractor``, ``blip2_image_text_matching``): the split's
images stream through ``extract_target_features`` 64 at a time, the
captions through ``encode_text_cls``, then the two-stage
``compute_sim_matrix`` (K1, then the ITM head over each query's top
``k_test``) and the recalls, printed as the JAX CLI prints them: one JSON
line of the scalar metrics, ``agg_metrics`` = ``r_mean``. Every other task
or family exits with a message naming its ROADMAP entry; CIR datasets keep
their CLIs (``cli/validate.py``, ``cli/validate_rerank.py``,
``cli/submission.py``).

The flags are the JAX CLI's plus ``--device`` (default ``cuda``; without a
GPU the command exits nonzero). Without ``--model-path`` the weights are
random from ``run.seed``. :func:`evaluate` takes a built
:class:`~sprc_tpu_torch.config.Config`, so a caller without PyYAML passes
``Config(defaults=<the YAML as a dict>)``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch


def _image_stream(ds, chunk: int = 64):
    """The split's pixels, ``chunk`` images a batch (a COCO test split would
    be about 8 GB held at once)."""
    for s in range(0, len(ds), chunk):
        yield np.stack([np.asarray(ds[i]["image"], np.float32)
                        for i in range(s, min(s + chunk, len(ds)))])


def evaluate(cfg, args, stats: Optional[Dict[str, float]] = None) -> dict:
    """The metrics of ``cfg`` (a Config); ``stats`` receives the seconds by
    stage (``ImageTextRetrievalTask.evaluate_pairs``)."""
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.data import builders as _builders  # noqa: F401  (registers them)
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.train.tasks import ImageTextRetrievalTask
    from sprc_tpu_torch.utils.artifacts import ensure_bert_vocab

    run = dict(cfg.run)
    task_name = run.get("task")
    model_cfg = dict(cfg.model)
    arch = model_cfg.pop("arch")
    model_type = model_cfg.pop("model_type", "pretrain")
    if task_name != "retrieval":
        raise SystemExit(f"task {task_name!r}: not ported to cli/evaluate.py (captioning, VQA, "
                         "classification and dialogue come with their families, ROADMAP A8; "
                         "CIR -> cli/validate.py)")
    if arch not in loader.STAGE1_MODELS:
        raise SystemExit(f"model {arch!r}: its retrieval evaluation is not ported (BLIP-1, "
                         "ALBEF, CLIP, ALPRO: ROADMAP A8)")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model_cfg["freeze_vit"] = True  # evaluation trains nothing: the tower is built frozen
    model = loader.load_model(arch, model_type, checkpoint_path=args.model_path, device=device,
                              seed=int(run.get("seed", 42)), **model_cfg)

    datasets_cfg = dict(cfg.datasets or {})
    assert len(datasets_cfg) == 1, "one dataset builder per eval config"
    (ds_name, ds_cfg), = datasets_cfg.items()
    datasets = registry.get("dataset", ds_name)(dict(ds_cfg)).build()
    splits = run.get("test_splits") or run.get("valid_splits") or ["val"]
    split = args.split or splits[0]
    assert split in datasets, (f"builder '{ds_name}' produced splits {sorted(datasets)}; "
                               f"'{split}' not among them")
    ds = datasets[split]
    tokenizer = BertWordPieceTokenizer.from_vocab_file(ensure_bert_vocab(args.vocab_path))
    task = ImageTextRetrievalTask(tokenizer, k_test=int(run.get("k_test", 128)),
                                  max_txt_len=int(run.get("max_txt_len", 35)))
    metrics = task.evaluate_pairs(model, _image_stream(ds), ds.text, ds.img2txt, ds.txt2img,
                                  stats=stats)
    metrics["agg_metrics"] = metrics["r_mean"]
    return metrics


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg-path", required=True)
    p.add_argument("--model-path", default=None)
    p.add_argument("--vocab-path", default=None)
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--split", default=None, help="dataset split (default: run.test_splits[0])")
    p.add_argument("--options", nargs="*", default=[], help="dotlist overrides key=value")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; exits nonzero without a GPU) or cpu")
    return p


def main(argv: Optional[list] = None) -> None:
    from sprc_tpu_torch.config import Config

    args = make_parser().parse_args(argv)
    metrics = evaluate(Config(args.cfg_path, overrides=args.options), args)
    print(json.dumps({k: v for k, v in metrics.items() if isinstance(v, (int, float, str))}))


if __name__ == "__main__":
    main()
