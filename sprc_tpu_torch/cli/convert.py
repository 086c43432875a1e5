"""Checkpoint conversion to the reference's torch layout (counterpart of
``sprc_tpu/cli/convert.py``).

  python -m sprc_tpu_torch.cli.convert --model-name blip2_cir_align_prompt \
      --input <checkpoint> --output sprc_cirr_export.pt [--base-path <start.pth>] \
      [--model-overrides KEY=YAML ...] [--device cuda]

``--input`` is anything ``loader.read_checkpoint`` reads, or the port's
training state ``last_state.pt`` (its frozen tensors from ``--base-path``,
the checkpoint the run started from); the model is loaded strictly
(:func:`~sprc_tpu_torch.interop.torch_import.load_checkpoint_auto`) with
its weights kept in fp32, and ``--output`` gets ``{ClassName: state_dict}``
(the JAX model's class name, every tensor fp32, as JAX's torch direction
writes it). JAX's orbax direction has no counterpart: the port reads and
writes torch files only, and ``--to orbax`` exits saying so.
``--model-overrides`` takes the validate CLI's ``key=value`` pairs (a
configuration cut to size). ``--device`` is where the model is built
(default ``cuda``).
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch


def convert(args) -> dict:
    """Write ``args.output``; returns its state dict."""
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.cli.validate import parse_model_overrides
    from sprc_tpu_torch.interop.torch_export import export_reference_file
    from sprc_tpu_torch.interop.torch_import import load_checkpoint_auto

    to = args.to or ("torch" if args.output.endswith((".pt", ".pth")) else "orbax")
    if to == "orbax":
        raise SystemExit("--to orbax: the port reads and writes torch files only; convert to "
                         "orbax with sprc_tpu.cli.convert from a torch file")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    overrides = parse_model_overrides(args.model_overrides)
    if (args.model_name, args.model_type) in loader.MODEL_CONFIGS:
        overrides.setdefault("vit_dtype", torch.float32)  # the weights as the file holds them
    model = loader.build_model(args.model_name, args.model_type, device=device, **overrides)
    load_checkpoint_auto(args.input, model, base=args.base_path)
    sd = export_reference_file(model, args.output)
    print(f"wrote torch checkpoint ({len(sd)} tensors, key {type(model).__name__!r}) "
          f"to {args.output}")
    return sd


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-name", default="blip2_cir_align_prompt")
    p.add_argument("--model-type", default="pretrain")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--base-path", default=None,
                   help="the checkpoint a training state's run started from (its frozen "
                        "tensors)")
    p.add_argument("--to", choices=["orbax", "torch"], default=None,
                   help="target format (default: inferred from --output); orbax exits")
    p.add_argument("--model-overrides", nargs="*", default=[], metavar="KEY=YAML")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; exits nonzero without a GPU) or cpu")
    return p


def main(argv: Optional[list] = None) -> None:
    convert(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
