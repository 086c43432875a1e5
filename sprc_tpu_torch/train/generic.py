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
``blip2_image_text_matching``), stage 2's ``blip2_opt`` and ``blip2_t5``,
and BLIP-1's captioner ``blip_caption`` (configs/runs/caption_coco_ft,
_ft_iter, _large_ft: its tower trains through K2's ``FusedViTBlock``);
``retrieval`` (:class:`RetrievalAdapter`) for the momentum-queue families
(``blip_retrieval``, ``albef_retrieval``), to which ``image_text_pretrain``
also sends ``blip_pretrain`` and
``albef_pretrain``. Those carry the trainer's aux state (the momentum
copies and queues, :mod:`sprc_tpu_torch.models.albef`), ramp ``alpha`` by
``0.4 min(1, (epoch n + i) / 2n)`` a batch (``step_extras``), collate
``[ENC]`` ids, ``[DEC]``-prefixed decoder ids (``blip_pretrain``) and host
MLM masks from ``RandomState(0)`` (``albef_pretrain``; its state is saved
with the trainer's), and draw hard negatives from the trainer's generator.
``vqa``, ``gqa`` and ``aok_vqa`` (:class:`VQAAdapter`) train BLIP-1 /
ALBEF's VQA models (``blip_vqa``, ``albef_vqa``): the weighted answers
flattened with ``ans_to_question``, dropout from the trainer's generator
(the JAX steps apply the model with the step's rng) and, with
``use_distill``, the momentum copies as aux state and ``alpha`` ramped over
ONE epoch. ``multimodal_classification`` (:class:`ClassificationAdapter`)
trains the SNLI-VE classifiers (``*_classification``) and the NLVR2 pair
models (``*_nlvr``: ``image0`` / ``image1``), without dropout, with the
momentum copies where the model distills (ALBEF's NLVR, a classifier with
``use_distill``) and ``alpha`` ramped over one epoch (two for NLVR).
The video families: ``retrieval`` sends ``alpro_retrieval`` to
:class:`AlproRetrievalAdapter` (no momentum queues: the forward's in-batch
VTC and hard-negative VTM, the negatives drawn from the trainer's
generator), ``multimodal_classification`` sends ``alpro_qa`` to
:class:`AlproQAAdapter` (classification over the answer vocabulary, which
``attach`` derives from the train split); both apply the med-BERT's
dropout from the trainer's generator, as the JAX steps apply them with the
step's rng. Another task for an ALPRO model, and ``timesformer`` (a feature
extractor), refuse: no adapter fits, in either package. ``dialogue``
(:class:`DialogueAdapter`) trains the GPT-2 video dialogue
(``gpt_dialogue``; configs/runs/dialogue_avsd_ft.yaml): the GPT-processed
AVSD items padded into ``[video prefix | text]`` batches, the model's
summed text CE and video MSE, no dropout (the JAX model has none). A run
whose feature streams are not ``len_video_ft`` wide exits before the model
is built, naming both widths (the JAX run fails at the loss's broadcast;
the shipped YAMLs name no streams, and the processor's default
``i3d_rgb`` + ``vggish`` is 2176 wide, not 4224).

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
        decoder); stage 1, ``Blip2OPT`` and BLIP-1's ``BlipCaption`` keep the
        decoder-only contract (``BlipCaption``: the plain captions, the
        loss's first ``prompt_length`` positions masked, its tower trained,
        its med decoder's dropout drawn from the trainer's generator, as the
        JAX step applies it with the step's rng); another model refuses."""
        from sprc_tpu_torch.models.blip1 import BlipCaption
        from sprc_tpu_torch.models.blip2_opt import Blip2OPT
        from sprc_tpu_torch.models.blip2_stage1 import Blip2Stage1
        from sprc_tpu_torch.models.blip2_t5 import Blip2T5

        if isinstance(model, Blip2T5):
            return Seq2SeqCaptionAdapter(self.tokenizer, self.max_txt_len)
        if not isinstance(model, (Blip2Stage1, Blip2OPT, BlipCaption)):
            raise SystemExit(f"{type(model).__name__}: its forward is not the captioners' "
                             "(images, input_ids, text_mask), in either package")
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


class RetrievalAdapter:
    """Items {image, text_input, image_id} -> the momentum-queue families'
    ITC / ITM training (``sprc_tpu/train/generic.py:200-296``): the aux
    state from ``init_albef_state``, ``alpha`` ramped over two epochs by
    ``step_extras``, the family's step function."""

    uses_aux = True

    def __init__(self, tokenizer, max_txt_len: int = 35):
        self.tokenizer = tokenizer
        self.max_txt_len = max_txt_len
        self._alpha = 0.4

    def specialize(self, model):
        from sprc_tpu_torch.models.alpro import AlproRetrieval

        if isinstance(model, AlproRetrieval):  # no momentum queues
            return AlproRetrievalAdapter(self.tokenizer, self.max_txt_len)
        if not hasattr(model, "MOMENTUM_KEYS"):
            raise SystemExit(f"run.task 'retrieval' trains the momentum-queue models "
                             f"(BLIP-1, ALBEF), not {type(model).__name__}")
        return self

    def collate(self, items: List[dict]) -> Dict[str, np.ndarray]:
        texts = [it["text_input"] for it in items]
        tok = self.tokenizer(texts, max_length=self.max_txt_len)
        enc = self.tokenizer(texts, max_length=self.max_txt_len, enc_token=True)
        return {"images": np.stack([np.asarray(it["image"], np.float32) for it in items]),
                "input_ids": tok["input_ids"], "text_mask": tok["attention_mask"],
                "enc_input_ids": enc["input_ids"],
                "image_ids": np.asarray([it["image_id"] for it in items], np.int32)}

    def step_extras(self, epoch: int, i: int, iters_per_epoch: int) -> Dict[str, np.ndarray]:
        """The batch's ``alpha`` (reference albef_retrieval.py:104-105)."""
        ramp = min(1.0, (epoch * iters_per_epoch + i) / (2 * iters_per_epoch))
        return {"alpha": np.float32(self._alpha * ramp)}

    def init_aux(self, model, params: Dict[str, torch.Tensor]) -> dict:
        from sprc_tpu_torch.models.albef import init_albef_state

        self._alpha = float(getattr(model.cfg, "alpha", 0.4))
        return init_albef_state(params, model.cfg, keys=model.MOMENTUM_KEYS)

    @staticmethod
    def step_fn(model):
        from sprc_tpu_torch.models import albef, blip1

        return {"AlbefRetrieval": albef.albef_train_step,
                "AlbefPretrain": albef.albef_pretrain_train_step,
                "BlipPretrain": blip1.blip_pretrain_train_step}.get(
            type(model).__name__, blip1.blip_retrieval_train_step)

    def forward(self, model, batch: Dict[str, torch.Tensor], generator, params, aux):
        """``(losses, new aux)`` of one step (JAX's ``apply_fn(params, aux,
        batch, rng)``)."""
        return self.step_fn(model)(model, params, aux, batch,
                                   alpha=batch.get("alpha", self._alpha), generator=generator)


class BlipPretrainAdapter(RetrievalAdapter):
    """``blip_pretrain``: the retrieval collate plus ``dec_input_ids``, the
    caption ids with ``[DEC]`` (the tokenizer's ``bos_id``; without one, the
    first row's first id, as the JAX collate falls back) at position 0."""

    def collate(self, items: List[dict]) -> Dict[str, np.ndarray]:
        out = super().collate(items)
        dec = np.array(out["input_ids"])
        bos = getattr(self.tokenizer, "bos_id", None)
        dec[:, 0] = bos if bos is not None else dec[0, 0]
        out["dec_input_ids"] = dec
        return out


class AlbefPretrainAdapter(RetrievalAdapter):
    """``albef_pretrain``: the retrieval collate plus host BERT masking
    (:func:`~sprc_tpu_torch.models.albef.mlm_mask`) of the ids from one
    ``RandomState(0)`` over the run, ``[MASK]`` (or ``[CLS]`` where the
    vocabulary has none) over the model's vocabulary; its state is saved
    with the trainer's, so a resumed run draws on."""

    def __init__(self, tokenizer, max_txt_len: int = 35, vocab_size: int = 30523):
        super().__init__(tokenizer, max_txt_len)
        self.vocab_size = vocab_size
        self.rng = np.random.RandomState(0)

    def collate(self, items: List[dict]) -> Dict[str, np.ndarray]:
        from sprc_tpu_torch.models.albef import mlm_mask

        out = super().collate(items)
        tok = self.tokenizer
        out["masked_ids"], out["mlm_labels"] = mlm_mask(
            self.rng, out["input_ids"], self.vocab_size, tok.vocab.get("[MASK]", tok.cls_id),
            pad_token_id=tok.pad_id, cls_token_id=tok.cls_id)
        return out

    def state_dict(self) -> dict:
        kind, keys, pos, has_gauss, gauss = self.rng.get_state()
        return {"mlm_rng": [kind, torch.from_numpy(keys.astype(np.int64)), pos, has_gauss, gauss]}

    def load_state_dict(self, state: dict) -> None:
        kind, keys, pos, has_gauss, gauss = state["mlm_rng"]
        self.rng.set_state((kind, keys.numpy().astype(np.uint32), pos, has_gauss, gauss))


class PretrainAdapter(CaptionAdapter):
    """image_text_pretrain over (image, text) pairs: BLIP-2 stage 1's ITC +
    ITM + LM take the caption collate (blip2_qformer.py forward); the
    momentum-queue models go to :class:`RetrievalAdapter`'s machinery
    (``blip_pretrain``: :class:`BlipPretrainAdapter`, ``albef_pretrain``:
    :class:`AlbefPretrainAdapter`), as the JAX ``specialize`` sends them."""

    def specialize(self, model):
        name = type(model).__name__
        if name == "BlipPretrain":
            return BlipPretrainAdapter(self.tokenizer, self.max_txt_len)
        if name == "AlbefPretrain":
            return AlbefPretrainAdapter(self.tokenizer, self.max_txt_len,
                                        model.cfg.text_config().vocab_size)
        if name in ("AlbefRetrieval", "BlipRetrieval"):
            return RetrievalAdapter(self.tokenizer, self.max_txt_len)
        return super().specialize(model)


class VQAAdapter:
    """Items {image, text_input, answers, weights} -> the VQA model's
    training (``sprc_tpu/train/generic.py:118-198``; reference
    vqa_datasets collate + blip_vqa.py:94-160): the questions at
    ``max_txt_len``, every question's answers flattened at 12 tokens with
    their weights and ``ans_to_question``. With ``use_distill`` (ALBEF) the
    step is :func:`~sprc_tpu_torch.models.vqa.vqa_train_step` over the aux
    state (the momentum copies), ``alpha`` ramped over one epoch."""

    uses_aux = False  # set by specialize from the model's use_distill

    def __init__(self, tokenizer, max_txt_len: int = 35, max_answer_len: int = 12):
        self.tokenizer = tokenizer
        self.max_txt_len = max_txt_len
        self.max_answer_len = max_answer_len
        self._alpha = 0.4

    def specialize(self, model):
        self._alpha = float(model.cfg.alpha)
        self.uses_aux = bool(model.cfg.use_distill)
        return self

    def collate(self, items: List[dict]) -> Dict[str, np.ndarray]:
        qtok = self.tokenizer([it["text_input"] for it in items], max_length=self.max_txt_len)
        answers, weights, ans_to_q = [], [], []
        for qi, it in enumerate(items):
            for a, w in zip(it["answers"], it["weights"]):
                answers.append(a)
                weights.append(float(w))
                ans_to_q.append(qi)
        atok = self.tokenizer(answers, max_length=self.max_answer_len)
        return {"images": np.stack([np.asarray(it["image"], np.float32) for it in items]),
                "question_ids": qtok["input_ids"], "question_mask": qtok["attention_mask"],
                "answer_ids": atok["input_ids"], "answer_mask": atok["attention_mask"],
                "ans_to_question": np.asarray(ans_to_q, np.int32),
                "weights": np.asarray(weights, np.float32)}

    def step_extras(self, epoch: int, i: int, iters_per_epoch: int) -> Dict[str, np.ndarray]:
        """The batch's ``alpha``: the one-epoch ramp (albef_vqa.py:80-81)."""
        ramp = min(1.0, (epoch * iters_per_epoch + i) / iters_per_epoch)
        return {"alpha": np.float32(self._alpha * ramp)}

    def init_aux(self, model, params: Dict[str, torch.Tensor]) -> dict:
        from sprc_tpu_torch.models.vqa import init_vqa_state

        return init_vqa_state(params)

    def forward(self, model, batch: Dict[str, torch.Tensor], generator, params=None, aux=None):
        """The losses (and with ``use_distill`` the new aux state) of one step."""
        if self.uses_aux:
            from sprc_tpu_torch.models.vqa import vqa_train_step

            return vqa_train_step(model, params, aux, batch,
                                  alpha=batch.get("alpha", self._alpha), generator=generator)
        return model(batch["images"], batch["question_ids"], batch["question_mask"],
                     batch["answer_ids"], batch["answer_mask"], batch["ans_to_question"],
                     batch["weights"], generator=generator)


class ClassificationAdapter:
    """``multimodal_classification`` (``sprc_tpu/train/generic.py:347-
    443``): SNLI-VE's (image, sentence, label) and NLVR2's (image0, image1,
    sentence, label) at ``max_txt_len``; the step distills where the model
    does (a classifier with ``use_distill``, ALBEF's NLVR) over the aux
    state, ``alpha`` ramped over one epoch (classifier) or two (NLVR); the
    model runs deterministically, as the JAX steps apply it."""

    uses_aux = False  # set by specialize

    def __init__(self, tokenizer, max_txt_len: int = 40):
        self.tokenizer = tokenizer
        self.max_txt_len = max_txt_len
        self._alpha = 0.4
        self._ramp_epochs = 1
        self._nlvr = False

    def specialize(self, model):
        from sprc_tpu_torch.models.alpro import AlproQA
        from sprc_tpu_torch.models.classification import MultimodalClassifier
        from sprc_tpu_torch.models.nlvr import NLVRClassifier

        if isinstance(model, AlproQA):  # video QA over the answer vocabulary
            return AlproQAAdapter(self.tokenizer, self.max_txt_len, model.cfg.num_classes)
        if not isinstance(model, (MultimodalClassifier, NLVRClassifier)):
            raise SystemExit(f"run.task 'multimodal_classification' trains the SNLI-VE, NLVR2 "
                             f"and ALPRO video QA models, not {type(model).__name__}")
        self._nlvr = isinstance(model, NLVRClassifier)
        self._alpha = float(model.cfg.alpha)
        self.uses_aux = model.distills if self._nlvr else bool(model.cfg.use_distill)
        self._ramp_epochs = 2 if self._nlvr else 1
        return self

    def collate(self, items: List[dict]) -> Dict[str, np.ndarray]:
        tok = self.tokenizer([it["text_input"] for it in items], max_length=self.max_txt_len)
        out = {"input_ids": tok["input_ids"], "text_mask": tok["attention_mask"],
               "labels": np.asarray([int(it["label"]) for it in items], np.int32)}
        keys = ("image0", "image1") if "image0" in items[0] else ("image",)
        for key in keys:
            out["images" if key == "image" else key] = np.stack(
                [np.asarray(it[key], np.float32) for it in items])
        return out

    def step_extras(self, epoch: int, i: int, iters_per_epoch: int) -> Dict[str, np.ndarray]:
        ramp = min(1.0, (epoch * iters_per_epoch + i) / (self._ramp_epochs * iters_per_epoch))
        return {"alpha": np.float32(self._alpha * ramp)}

    def init_aux(self, model, params: Dict[str, torch.Tensor]) -> dict:
        from sprc_tpu_torch.models.classification import init_classifier_state
        from sprc_tpu_torch.models.nlvr import init_nlvr_state

        return (init_nlvr_state if self._nlvr else init_classifier_state)(params)

    def forward(self, model, batch: Dict[str, torch.Tensor], generator, params=None, aux=None):
        images = ((batch["image0"], batch["image1"]) if self._nlvr else (batch["images"],))
        if self.uses_aux:
            from sprc_tpu_torch.models.classification import classifier_train_step
            from sprc_tpu_torch.models.nlvr import nlvr_train_step

            step = nlvr_train_step if self._nlvr else classifier_train_step
            return step(model, params, aux, batch, alpha=batch.get("alpha", self._alpha))
        return model(*images, batch["input_ids"], batch["text_mask"], batch["labels"], None, 0.0)


class AlproRetrievalAdapter:
    """ALPRO's video-text retrieval training (``sprc_tpu/train/generic.py:
    505-542``; reference alpro_retrieval.py:66-240 through
    projects/alpro/train/{msrvtt,didemo}_retrieval_ft.yaml): items {image (a
    clip [T, H, W, 3]), text_input} -> ``video``, the captions at
    ``max_txt_len``; the forward carries both losses, its hard negatives
    drawn from the trainer's generator."""

    def __init__(self, tokenizer, max_txt_len: int = 35):
        self.tokenizer = tokenizer
        self.max_txt_len = max_txt_len

    def collate(self, items: List[dict]) -> Dict[str, np.ndarray]:
        tok = self.tokenizer([it["text_input"] for it in items], max_length=self.max_txt_len)
        return {"video": np.stack([np.asarray(it["image"], np.float32) for it in items]),
                "input_ids": tok["input_ids"], "text_mask": tok["attention_mask"]}

    def forward(self, model, batch: Dict[str, torch.Tensor], generator):
        return model(batch["video"], batch["input_ids"], batch["text_mask"], generator=generator)


class AlproQAAdapter:
    """ALPRO's video QA as classification over the answer vocabulary
    (``sprc_tpu/train/generic.py:545-601``; reference alpro_qa.py through
    projects/alpro/train/{msrvtt,msvd}_qa_ft.yaml). :meth:`attach` derives
    the vocabulary from the train split's answers by frequency, ties broken
    by the string, cut to ``num_classes`` (the reference ships it as a
    file); an item's first answer outside it is the target -1, which the
    loss leaves out."""

    def __init__(self, tokenizer, max_txt_len: int = 35, num_classes: int = 0):
        self.tokenizer = tokenizer
        self.max_txt_len = max_txt_len
        self.num_classes = int(num_classes)
        self.ans2label: Dict[str, int] = {}

    def attach(self, dataset) -> None:
        counts: Dict[str, int] = {}
        for ann in getattr(dataset, "annotation", []):
            answers = ann.get("answer", ann.get("answers", []))
            for a in [answers] if isinstance(answers, str) else answers:
                counts[a] = counts.get(a, 0) + 1
        ranked = sorted(counts, key=lambda a: (-counts[a], a))
        self.ans2label = {a: i for i, a in enumerate(ranked[:self.num_classes or len(ranked)])}

    def collate(self, items: List[dict]) -> Dict[str, np.ndarray]:
        tok = self.tokenizer([it["text_input"] for it in items], max_length=self.max_txt_len)
        labels = [self.ans2label.get((it.get("answers") or [""])[0], -1) for it in items]
        return {"video": np.stack([np.asarray(it["image"], np.float32) for it in items]),
                "input_ids": tok["input_ids"], "text_mask": tok["attention_mask"],
                "labels": np.asarray(labels, np.int32)}

    def forward(self, model, batch: Dict[str, torch.Tensor], generator):
        return model(batch["video"], batch["input_ids"], batch["text_mask"], batch["labels"],
                     generator=generator)


class DialogueAdapter:
    """AVSD dialogue (``sprc_tpu/train/generic.py:446-496``; reference
    dialogue.py and the avsd_dialogue_datasets collater): GPT-processed items
    {input_ids, token_type_ids, labels, video_fts, video_token_type_ids} ->
    the padded ``[video prefix (T) | text (L)]`` batch of
    :class:`~sprc_tpu_torch.models.gpt_dialogue.GPTDialogue`: the text and
    type ids padded with ``<pad>`` (the dataset's text processor's, through
    :meth:`attach`), the features with 1.0, the labels -1 over the video
    positions and the padding, ``attn_mask`` over ``[T | L]``."""

    def __init__(self, tokenizer=None, max_txt_len: int = 0):
        self.pad_id = 0

    def specialize(self, model):
        from sprc_tpu_torch.models.gpt_dialogue import GPTDialogue

        if not isinstance(model, GPTDialogue):
            raise SystemExit(f"run.task 'dialogue' trains the GPT video dialogue "
                             f"(gpt_dialogue), not {type(model).__name__}")
        return self

    def attach(self, dataset) -> None:
        tok = getattr(dataset.text_processor, "tokenizer", None)
        if tok is not None:
            self.pad_id = tok.special_token_id("<pad>")

    def collate(self, items: List[dict]) -> Dict[str, np.ndarray]:
        B = len(items)
        L = max(len(it["input_ids"]) for it in items)
        T = max(len(it["video_fts"]) for it in items)
        D = items[0]["video_fts"].shape[1]
        ids = np.full((B, L), self.pad_id, np.int32)
        text_tt = np.full((B, L), self.pad_id, np.int32)
        labels = np.full((B, T + L), -1, np.int32)
        fts = np.ones((B, T, D), np.float32)  # the reference's pad value 1.0
        vid_tt = np.full((B, T), self.pad_id, np.int32)
        attn = np.zeros((B, T + L), np.int32)
        for i, it in enumerate(items):
            n, t = len(it["input_ids"]), len(it["video_fts"])
            ids[i, :n] = it["input_ids"]
            text_tt[i, :n] = it["token_type_ids"]
            labels[i, T:T + n] = it["labels"]
            fts[i, :t] = it["video_fts"]
            vid_tt[i, :t] = it["video_token_type_ids"]
            attn[i, :t] = 1
            attn[i, T:T + n] = 1
        return {"input_ids": ids, "video_fts": fts, "attn_mask": attn,
                "token_type_ids": np.concatenate([vid_tt, text_tt], axis=1), "labels": labels}

    def forward(self, model, batch: Dict[str, torch.Tensor], generator=None):
        return model(batch["input_ids"], batch["video_fts"], batch["attn_mask"],
                     batch["token_type_ids"], batch["labels"])


def check_dialogue_width(dataset, arch: str, model_type: str, model_cfg: dict) -> None:
    """Exit where the dataset's feature streams are not the model's
    ``len_video_ft`` wide, naming both widths (the JAX run fails at the
    video loss's broadcast); read from the split's first item, before any
    model is built."""
    from sprc_tpu_torch import loader

    want = loader.family_config(arch, model_type, **model_cfg).len_video_ft
    proc = dataset.vis_processor
    got = dataset[0]["video_fts"].shape[1]
    if got != want:
        raise SystemExit(
            f"the video features are {got} wide ({' + '.join(proc.visual_ft + proc.audio_ft)}), "
            f"the model's len_video_ft is {want}: name the streams that make {want} (4224: "
            "vis_processor visual_ft [i3d_flow, i3d_rgb], audio_ft [vggish]) or set "
            "model.len_video_ft")


# the JAX table's task names (lavis/tasks/__init__.py names)
TASK_ADAPTERS: Dict[str, Any] = {
    "captioning": CaptionAdapter,
    "vqa": VQAAdapter,
    "gqa": VQAAdapter,
    "aok_vqa": VQAAdapter,
    "image_text_pretrain": PretrainAdapter,
    "retrieval": RetrievalAdapter,
    "multimodal_classification": ClassificationAdapter,
    "dialogue": DialogueAdapter,
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
        extras = getattr(self.adapter, "step_extras", None)
        for i, s in enumerate(range(0, len(order) - bs + 1, bs)):
            batch = self.adapter.collate([ds[int(j)] for j in order[s: s + bs]])
            if extras is not None:  # the per-batch alpha of the ramp
                batch.update(extras(epoch, i, self.steps_per_epoch()))
            yield batch

    def prepare_batch(self, batch):
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}


class GenericTrainer(Trainer):
    """The Trainer over an adapter's forward (default: the caption collate's
    (images, input_ids, text_mask))."""

    def __init__(self, model, cfg, *, adapter=None, **kw):
        super().__init__(model, cfg, **kw)
        self.adapter = adapter or CaptionAdapter(None)

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if getattr(self.adapter, "uses_aux", False):
            losses, self.next_aux = self.adapter.forward(self.model, batch, self.generator,
                                                         self.param_values(), self.aux)
            return losses
        return self.adapter.forward(self.model, batch, self.generator)

    def state_dict(self) -> dict:
        state = super().state_dict()
        if hasattr(self.adapter, "state_dict"):
            state["adapter"] = self.adapter.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        if "adapter" in state:
            self.adapter.load_state_dict(state["adapter"])


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
    model_cfg = dict(cfg.model)
    arch = model_cfg.pop("arch")
    model_type = model_cfg.pop("model_type", "pretrain")
    if arch in loader.INSTRUCT_MODELS:
        # the JAX run builds the model and then fails at the adapter's call
        raise SystemExit(f"model {arch!r}: no generic task adapter fits its forward (the "
                         "instruction and LLaMA token batches), in either package; its "
                         "training forward runs through models.instruct_cir.InstructAdapter")
    if arch in loader.CLIP_MODELS + loader.CIR_FEATURE_MODELS:
        # no run YAML trains them; the JAX run builds the model and fails at the call
        raise SystemExit(f"model {arch!r}: no generic task adapter fits its forward (an "
                         "evaluation and feature model), in either package")
    if arch == "timesformer":  # no run YAML trains it; the JAX run fails at the call
        raise SystemExit(f"model {arch!r}: no generic task adapter fits its forward (a video "
                         "feature extractor), in either package")
    video_task = {"alpro_retrieval": "retrieval", "alpro_qa": "multimodal_classification"}
    if arch in video_task and task_name != video_task[arch]:
        raise SystemExit(f"model {arch!r}: no generic task adapter of run.task {task_name!r} "
                         f"fits its video forward, in either package (its task: "
                         f"{video_task[arch]})")
    if (task_name == "dialogue") != (arch in loader.DIALOGUE_MODELS):
        # the JAX run builds the model and then fails at the adapter's call
        raise SystemExit(f"model {arch!r}: no generic task adapter of run.task {task_name!r} "
                         "fits its forward, in either package (the dialogue: gpt_dialogue)")
    if arch not in (loader.STAGE1_MODELS + loader.LLM_HEADS + loader.MOMENTUM_MODELS
                    + loader.VQA_MODELS + loader.CLASSIFICATION_MODELS + tuple(video_task)
                    + loader.DIALOGUE_MODELS + ("blip_caption",)):
        raise SystemExit(f"model {arch!r}: no generic task adapter fits it, in either package")
    if task_name in ("vqa", "gqa", "aok_vqa") and arch not in loader.VQA_MODELS:
        # the JAX run builds the model and then fails at the adapter's call
        raise SystemExit(f"run.task {task_name!r} trains BLIP-1 / ALBEF's VQA models "
                         f"({', '.join(loader.VQA_MODELS)}), not {arch!r} (the BLIP-2 heads "
                         "answer zero-shot through cli/evaluate.py)")

    datasets_cfg = dict(cfg.datasets or {})
    assert len(datasets_cfg) == 1, "one dataset builder per run config"
    (ds_name, ds_cfg), = datasets_cfg.items()
    datasets = registry.get("dataset", ds_name)(dict(ds_cfg)).build()
    assert "train" in datasets, f"builder {ds_name} produced no train split"
    if task_name == "dialogue":
        check_dialogue_width(datasets["train"], arch, model_type, model_cfg)

    device = torch.device(getattr(args, "device", "cuda"))
    if device.type == "cuda" and torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False  # the Q-Former trains in true fp32
        torch.backends.cudnn.allow_tf32 = False
    seed = int(run.get("seed", 42))
    model = loader.load_model(arch, model_type, checkpoint_path=getattr(args, "model_path", None),
                              device=device, seed=seed, **model_cfg)
    tokenizer = None if task_name == "dialogue" else llm_tokenizer(  # the GPT processors' own
        run, lambda: BertWordPieceTokenizer.from_vocab_file(
            ensure_bert_vocab(getattr(args, "vocab_path", None))))
    adapter = TASK_ADAPTERS[task_name](tokenizer, max_txt_len=int(run.get("max_txt_len", 35)))
    adapter = adapter.specialize(model)
    if hasattr(adapter, "attach"):  # state from the data (ALPRO QA's answers, the pad id)
        adapter.attach(datasets["train"])
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
    if getattr(adapter, "uses_aux", False):  # the momentum copies and queues
        trainer.aux = adapter.init_aux(model, trainer.param_values())
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
