"""YAML run-config train entry (counterpart of ``sprc_tpu/cli/train.py``, the
LAVIS ``train.py``).

Usage:
  python -m sprc_tpu_torch.cli.train --cfg-path configs/runs/pretrain_stage1.yaml \
      --vocab-path vocab.txt --options datasets.conceptual_caption_3m.build_info.annotations.train=a.json \
      datasets.conceptual_caption_3m.build_info.images=/data/images [--device cuda]
  python -m sprc_tpu_torch.cli.train --cfg-path configs/runs/retrieval_coco_blip2_ft.yaml \
      --vocab-path vocab.txt --options datasets.coco_retrieval.build_info.annotations.train=[a.json] \
      datasets.coco_retrieval.build_info.images=/data/coco
  python -m sprc_tpu_torch.cli.train --cfg-path configs/runs/cirr_finetune.yaml \
      --data-path /data/cirr_dataset --vocab-path vocab.txt

The run, model and datasets sections come through
:mod:`sprc_tpu_torch.config` (deep merge and ``key=value`` overrides). Two
routes, as in JAX:

- a generic task (``run.task`` in ``train/generic.py::TASK_ADAPTERS``, e.g.
  ``image_text_pretrain``) goes to :func:`~sprc_tpu_torch.train.generic.run_generic`
  (``retrieval_coco_blip2_ft.yaml``: ``blip2`` / ``coco``, whose EVA ViT-g
  tower trains);
- anything else is a CIR fine-tune: the run section's keys become the flags
  of ``cli/finetune.py`` by their argparse names (``dataset`` and
  ``--data-path`` first, ``model.arch`` the ``--model-name``,
  ``model.vit_model: clip_L`` the ``pretrain_vitL`` model type), and the
  port's ``cli/finetune.finetune`` runs (``run.remat`` as ``--remat``,
  ``run.mesh`` as ``--mesh``, which then joins the group of a launcher such
  as ``torchrun``). A key it has no flag for is not applied: it warns, as
  the JAX CLI warns on unknown keys.

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``; without a
GPU the command exits nonzero). ``--mesh`` trains a CIR run data-parallel
(``cli/finetune.py``'s ``--mesh``: ``torchrun``'s group, or one process per
visible CUDA device started here); the generic route trains on one device,
as JAX's ``run_generic`` does, and refuses it.
:func:`train` takes a built :class:`~sprc_tpu_torch.config.Config`, so a
caller without PyYAML passes ``Config(defaults=<the YAML as a dict>)``.
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional

log = logging.getLogger(__name__)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg-path", required=True)
    p.add_argument("--data-path", default=None,
                   help="dataset root (CIR runs; generic runs carry paths in their datasets "
                        "section)")
    p.add_argument("--vocab-path", default=None)
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--model-path", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--mesh", action="store_true")
    p.add_argument("--options", nargs="*", default=[], help="dotlist overrides key=value")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; exits nonzero without a GPU) or cpu")
    return p


def finetune_args(cfg, args) -> argparse.Namespace:
    """A CIR run config -> the namespace of ``cli/finetune.py``'s parser
    (``sprc_tpu/cli/train.py:52-84``)."""
    from sprc_tpu_torch.cli.finetune import make_parser as finetune_parser

    run, model_cfg = cfg.run, cfg.model
    ft = finetune_parser().parse_args(
        ["--dataset", str(run.get("dataset", "CIRR")), "--data-path", args.data_path,
         *(("--vocab-path", args.vocab_path) if args.vocab_path else ())])
    ft.output_dir = args.output_dir
    ft.model_path = args.model_path
    ft.resume = args.resume
    ft.mesh = getattr(args, "mesh", False)
    ft.device = args.device
    ft.model_name = model_cfg.get("arch", "blip2_cir_align_prompt")
    ft.model_type = "pretrain_vitL" if model_cfg.get("vit_model") == "clip_L" else "pretrain"
    known = {a.dest for a in finetune_parser()._actions if a.dest != "help"}
    handled = {"dataset"}
    for key, value in run.items():
        if key in handled:
            continue
        if key in known:
            setattr(ft, key, value)
        else:
            log.warning("run.%s is not a finetune flag; ignored (known: %s)", key,
                        ", ".join(sorted(known - handled)))
    return ft


def train(cfg, args):
    """Route ``cfg`` (a Config) as the module docstring says."""
    from sprc_tpu_torch.train.generic import TASK_ADAPTERS, run_generic

    if cfg.run.get("task") in TASK_ADAPTERS:
        if getattr(args, "mesh", False) or cfg.run.get("mesh"):
            raise SystemExit("--mesh: the generic route trains on one device (JAX's "
                             "run_generic takes no mesh); --mesh trains CIR runs")
        best = run_generic(cfg, args)
        print({"task": cfg.run.get("task"), "best": best})
        return best
    if args.data_path is None:
        raise SystemExit("--data-path is required for CIR runs")
    from sprc_tpu_torch.cli.finetune import finetune

    return finetune(finetune_args(cfg, args))


def main(argv: Optional[list] = None) -> None:
    from sprc_tpu_torch.config import Config

    args = make_parser().parse_args(argv)
    cfg = Config(args.cfg_path, overrides=args.options)
    if args.mesh:
        import sys

        from sprc_tpu_torch.parallel.mesh import launch_or_join

        launch_or_join("sprc_tpu_torch.cli.train", sys.argv[1:] if argv is None else argv,
                       args.device)
    train(cfg, args)


if __name__ == "__main__":
    main()
