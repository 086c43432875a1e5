"""YAML-driven training of the non-CIR families (counterpart of
``sprc_tpu/train/generic.py:28-72``, ``:299-345``, ``:611-857``; the
reference's ``train.py --cfg-path projects/...`` over RunnerBase, BaseTask
and the dataset builders).

A run config's sections: ``run`` (task, batch_size, max_epochs,
learning_rate, weight_decay, seed, log_freq, runner), ``model`` (arch,
model_type and config overrides) and ``datasets`` (one builder). Wiring, as
in JAX: a registered dataset builder's train split -> a task adapter that
collates items into the model's inputs -> :class:`GenericTrainer`'s step
over the model's losses -> :class:`~sprc_tpu_torch.train.runner.EpochRunner`
(or ``IterRunner`` with ``run.runner: runner_iter``).

What the JAX run does and the port keeps:

- the OneCycle horizon is the run's own length (``max_epochs`` x steps an
  epoch, or ``run.total_steps`` / ``run.max_iters``), ``pct_start`` 1/50;
- the epoch's order is ``RandomState(seed + epoch).permutation``, and the
  last partial batch is dropped;
- ``run.weight_decay`` (0.05 by default) is AdamW's;
- the frozen partition is the model's ``FROZEN_PREFIXES``. The BLIP-2
  stage-2 heads have them (the tower and the LLM: ``("visual_encoder",
  "opt_model")``, ``("visual_encoder", "t5_model")``): those tensors take no
  gradient, no moments and no update, as JAX's ``set_to_zero`` leaves, even
  on the COCO caption row whose YAML sets ``freeze_vit: false``, so only
  ``ln_vision``, the Q-Former, ``query_tokens``, the projection and ``temp``
  (no gradient reaches it, so AdamW decays it) train. ``Blip2Stage1`` has
  none: a frozen tower (``pretrain``), cut off from the losses by a
  stop-gradient only, stays in AdamW's partition with zero gradients, so
  every update decays it by ``lr x weight_decay``
  (``Trainer(decay_frozen=True)``, with fp32 masters for a bf16 tower);
  LAVIS takes a frozen tower out of the optimizer instead (ROADMAP Queue C).
  A stage-1 ``coco`` model type (``freeze_vit: false``) trains its tower:
  every tower tensor gets its gradient and AdamW moments, as in the JAX run;
- ``run.skip_nonfinite`` (on by default) and the consecutive-skip abort;
- ``run.tokenizer`` (``{opt | t5: tokenizer.json}``) tokenizes with the
  LLM's own tokenizer; without it, the BERT WordPiece tokenizer of
  ``--vocab-path``. Under that fallback the OPT head masks its default pad
  id 1 (BERT's ``[UNK]``) and not BERT's pads (0), which count in the loss,
  as in the JAX run (the adapter passes no ``pad_token_id``);
- the caption adapter passes no ``prompt_length``: no prompt prefix is
  masked (LAVIS masks the model YAML's ``"a photo of"``).

Adapters: ``image_text_pretrain`` (:class:`PretrainAdapter`) and
``captioning`` (:class:`CaptionAdapter`; :class:`Seq2SeqCaptionAdapter`
for ``blip2_t5``) for the parameter-only families, which in the port are
BLIP-2 stage 1 (``blip2``, ``blip2_feature_extractor``,
``blip2_image_text_matching``) and stage 2's ``blip2_opt`` and
``blip2_t5``. The other task names of the JAX table refuse by name, with
their ROADMAP entry: VQA training (``vqa``, ``gqa``, ``aok_vqa``) trains
BLIP-1 / ALBEF's VQA models (A8.6), as do ``retrieval``,
``multimodal_classification`` and ``dialogue``.

Beyond JAX's: ``--model-path`` starts from a checkpoint (JAX's generic run
starts from its random init) and ``--resume`` restores a ``last_state.pt``;
``--device`` (default ``cuda``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from sprc_tpu_torch.train.loop import Trainer
from sprc_tpu_torch.train.runner import BaseTask


class CaptionAdapter:
    """Items {image, text_input} -> (images, input_ids, text_mask) for the
    families whose forward takes those three (reference caption collate)."""

    def __init__(self, tokenizer, max_txt_len: int = 40):
        self.tokenizer = tokenizer
        self.max_txt_len = max_txt_len

    def collate(self, items: List[dict]) -> Dict[str, np.ndarray]:
        tok = self.tokenizer([it["text_input"] for it in items], max_length=self.max_txt_len)
        return {"images": np.stack([np.asarray(it["image"], np.float32) for it in items]),
                "input_ids": tok["input_ids"], "text_mask": tok["attention_mask"]}

    def forward(self, model, batch: Dict[str, torch.Tensor], generator):
        """The model's training outputs on one collated batch (JAX's
        ``loss_fn``)."""
        return model(batch["images"], batch["input_ids"], batch["text_mask"],
                     generator=generator)

    def specialize(self, model):
        """``Blip2T5`` is seq2seq (prompt in the encoder, caption in the
        decoder); stage 1 and ``Blip2OPT`` keep the decoder-only contract;
        another family refuses (ROADMAP A8.6)."""
        from sprc_tpu_torch.models.blip2_opt import Blip2OPT
        from sprc_tpu_torch.models.blip2_stage1 import Blip2Stage1
        from sprc_tpu_torch.models.blip2_t5 import Blip2T5

        if isinstance(model, Blip2T5):
            return Seq2SeqCaptionAdapter(self.tokenizer, self.max_txt_len)
        if not isinstance(model, (Blip2Stage1, Blip2OPT)):
            raise SystemExit(f"{type(model).__name__}: no generic adapter in the port "
                             "(its family is ROADMAP A8.6)")
        return self


class Seq2SeqCaptionAdapter(CaptionAdapter):
    """Caption training of the BLIP-2 T5 head (``sprc_tpu/train/generic.py:
    75-115``): the prompt (``""``) is the encoder's input at ``max_length``
    4, the caption the decoder's output, its pads masked; the pad and the
    decoder's start id are both the tokenizer's ``pad_id``."""

    prompt: str = ""

    def collate(self, items: List[dict]) -> Dict[str, np.ndarray]:
        in_tok = self.tokenizer([self.prompt or "" for _ in items], max_length=4)
        out_tok = self.tokenizer([it["text_input"] for it in items], max_length=self.max_txt_len)
        return {"images": np.stack([np.asarray(it["image"], np.float32) for it in items]),
                "input_ids": in_tok["input_ids"], "input_mask": in_tok["attention_mask"],
                "output_ids": out_tok["input_ids"], "output_mask": out_tok["attention_mask"]}

    def forward(self, model, batch: Dict[str, torch.Tensor], generator):
        pad_id = getattr(self.tokenizer, "pad_id", 0)
        return model(batch["images"], batch["input_ids"], batch["input_mask"],
                     batch["output_ids"], batch["output_mask"], pad_token_id=pad_id,
                     decoder_start_token_id=pad_id, generator=generator)


class PretrainAdapter(CaptionAdapter):
    """image_text_pretrain over (image, text) pairs: BLIP-2 stage 1's ITC +
    ITM + LM take the caption collate (blip2_qformer.py forward). The
    momentum-queue pretrainers (``blip_pretrain``, ALBEF), which JAX sends to
    its ``RetrievalAdapter``, come with their families (ROADMAP A8)."""


def _not_ported(task: str):
    def refuse(*_a, **_k):
        raise SystemExit(f"run.task {task!r}: its adapter and models (BLIP-1, ALBEF, ALPRO, "
                         "the GPT dialogue) are not ported (ROADMAP A8.6)")
    refuse.not_ported = True
    return refuse


# the JAX table's task names (lavis/tasks/__init__.py names)
TASK_ADAPTERS: Dict[str, Any] = {
    "captioning": CaptionAdapter,
    "image_text_pretrain": PretrainAdapter,
    **{name: _not_ported(name) for name in ("vqa", "gqa", "aok_vqa", "retrieval",
                                           "multimodal_classification", "dialogue")},
}


class BuilderTask(BaseTask):
    """BaseTask over a dataset builder's train split and an adapter;
    batches collated on the host, the last partial one dropped."""

    def __init__(self, datasets: Dict[str, Any], adapter, *, batch_size: int, seed: int = 42,
                 device="cuda"):
        self.datasets = datasets
        self.adapter = adapter
        self.batch_size = batch_size
        self.seed = seed
        self.device = torch.device(device)

    def steps_per_epoch(self) -> int:
        return max(1, len(self.datasets["train"]) // self.batch_size)

    def train_loader(self, epoch: int):
        ds = self.datasets["train"]
        order = np.random.RandomState(self.seed + epoch).permutation(len(ds))
        bs = self.batch_size
        for s in range(0, len(order) - bs + 1, bs):
            yield self.adapter.collate([ds[int(i)] for i in order[s: s + bs]])

    def prepare_batch(self, batch):
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}


class GenericTrainer(Trainer):
    """The Trainer over an adapter's forward (default: the caption collate's
    (images, input_ids, text_mask))."""

    def __init__(self, model, cfg, *, adapter=None, **kw):
        super().__init__(model, cfg, **kw)
        self.adapter = adapter or CaptionAdapter(None)

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.adapter.forward(self.model, batch, self.generator)


def llm_tokenizer(run: dict, default):
    """``run.tokenizer`` = {opt | t5 | llama: tokenizer.json} -> that LLM's
    tokenizer (``text/llm_tokenizers.py``); without it, ``default()``."""
    tok_cfg = run.get("tokenizer")
    if not isinstance(tok_cfg, dict):
        return default()
    from sprc_tpu_torch.text.llm_tokenizers import llama_tokenizer, opt_tokenizer, t5_tokenizer

    (kind, path), = tok_cfg.items()
    return {"opt": opt_tokenizer, "t5": t5_tokenizer, "llama": llama_tokenizer}[kind](path)


def run_generic(cfg, args) -> Dict[str, float]:
    """Drive a generic run config end to end; returns the best validation
    results (none for pretraining). ``args``: ``output_dir``, ``vocab_path``
    and, where present, ``model_path``, ``resume`` and ``device``."""
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.data import builders as _builders  # noqa: F401  (registers them)
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.train.loop import TrainConfig
    from sprc_tpu_torch.train.runner import EpochRunner, IterRunner, RunnerConfig
    from sprc_tpu_torch.utils.artifacts import ensure_bert_vocab

    run = dict(cfg.run)
    task_name = run.get("task")
    if task_name not in TASK_ADAPTERS:
        raise ValueError(f"run.task {task_name!r} has no generic adapter (available: "
                         f"{sorted(TASK_ADAPTERS)}); CIR tasks go through cli.finetune")
    if getattr(TASK_ADAPTERS[task_name], "not_ported", False):
        TASK_ADAPTERS[task_name]()
    model_cfg = dict(cfg.model)
    arch = model_cfg.pop("arch")
    model_type = model_cfg.pop("model_type", "pretrain")
    if arch in loader.INSTRUCT_MODELS:
        # the JAX run builds the model and then fails at the adapter's call
        raise SystemExit(f"model {arch!r}: no generic task adapter fits its forward (the "
                         "instruction and LLaMA token batches), in either package; its "
                         "training forward runs through models.instruct_cir.InstructAdapter")
    if arch not in loader.STAGE1_MODELS + loader.LLM_HEADS:
        raise SystemExit(f"model {arch!r}: not ported for generic training (BLIP-1, ALBEF and "
                         "the rest of the zoo: ROADMAP A8.6)")

    datasets_cfg = dict(cfg.datasets or {})
    assert len(datasets_cfg) == 1, "one dataset builder per run config"
    (ds_name, ds_cfg), = datasets_cfg.items()
    datasets = registry.get("dataset", ds_name)(dict(ds_cfg)).build()
    assert "train" in datasets, f"builder {ds_name} produced no train split"

    device = torch.device(getattr(args, "device", "cuda"))
    if device.type == "cuda" and torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False  # the Q-Former trains in true fp32
        torch.backends.cudnn.allow_tf32 = False
    seed = int(run.get("seed", 42))
    model = loader.load_model(arch, model_type, checkpoint_path=getattr(args, "model_path", None),
                              device=device, seed=seed, **model_cfg)
    tokenizer = llm_tokenizer(run, lambda: BertWordPieceTokenizer.from_vocab_file(
        ensure_bert_vocab(getattr(args, "vocab_path", None))))
    adapter = TASK_ADAPTERS[task_name](tokenizer, max_txt_len=int(run.get("max_txt_len", 35)))
    adapter = adapter.specialize(model)
    batch_size = int(run.get("batch_size", 8))
    task = BuilderTask(datasets, adapter, batch_size=batch_size, seed=seed, device=device)

    # the OneCycle horizon is the run's own length unless the config pins it
    max_epochs = int(run.get("max_epochs", 1))
    tcfg = TrainConfig(
        learning_rate=float(run.get("learning_rate", 1e-5)),
        weight_decay=float(run.get("weight_decay", 0.05)),
        total_steps=int(run.get("total_steps", run.get(
            "max_iters", max_epochs * task.steps_per_epoch()))))
    # the stage-1 models have no FROZEN_PREFIXES: a frozen tower decays; the
    # stage-2 heads' frozen prefixes take no update
    trainer = GenericTrainer(model, tcfg, seed=seed, adapter=adapter,
                             skip_nonfinite=bool(run.get("skip_nonfinite", True)),
                             decay_frozen=not getattr(model, "FROZEN_PREFIXES", ()))
    rcfg = RunnerConfig(output_dir=args.output_dir, max_epochs=max_epochs,
                        log_every_steps=int(run.get("log_freq", 10)),
                        resume=getattr(args, "resume", None),
                        max_consecutive_nonfinite=int(run.get("max_consecutive_nonfinite", 10)))
    if run.get("runner") == "runner_iter":
        runner = IterRunner(model, trainer, task, rcfg, max_iters=int(run.get("max_iters", 1000)),
                            iters_per_inner=int(run.get("iters_per_inner_epoch", 100)))
    else:
        runner = EpochRunner(model, trainer, task, rcfg)
    return runner.train()
