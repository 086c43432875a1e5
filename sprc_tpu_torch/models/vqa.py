"""BLIP-1 / ALBEF VQA (counterpart of ``sprc_tpu/models/vqa.py``; reference
lavis/models/blip_models/blip_vqa.py:33-340, albef_models/albef_vqa.py:28-440).

:class:`VQAModel` (``blip_vqa``, ``albef_vqa``): the ViT-B/16 tower (kernel
K2 on the card; with a graph through ``FusedViTBlock``), a med-BERT question
encoder cross-attending the image rows (BLIP: every layer; ALBEF: from
``fusion_layer``) and a causal med-BERT answer decoder cross-attending the
question states under the question mask (the med-BERT's ``image_mask``;
this is its only caller) with the BERT LM head. Both med-BERTs run unfused
in fp32, as in the JAX package, with hidden dropout in training mode (the
JAX VQA steps apply the model with the step's dropout rng).

- training: every answer's smoothed next-token NLL (label smoothing 0.1,
  the sum over its shifted non-pad tokens), weighted and summed over the
  flattened answers, over the batch size; an answer reads its question's
  states through ``ans_to_question``. With the momentum decoder's logits
  (``use_distill``, ALBEF's answer distillation) each answer mixes
  ``(1 - alpha)`` NLL with ``alpha`` times the soft-label cross-entropy;
  :func:`vqa_train_step` updates the fp32 momentum copies
  (:data:`VQA_MOMENTUM_KEYS`, the retrieval families'
  :func:`~sprc_tpu_torch.models.albef.momentum_update`) and runs the momentum forward without a graph
  (:func:`~sprc_tpu_torch.models.albef.momentum_weights`);
- :meth:`VQAModel.rank_answers`: a bos-only probe scores each candidate's
  first token, the top ``min(num_ans_candidates, A)`` are rescored by their
  whole NLL, and the least wins (the JAX package's two passes);
- :meth:`VQAModel.generate_answers`: greedy decoding of the whole prefix a
  step, rows stopping at ``eos``.

Module names are LAVIS's (``visual_encoder.blocks.{i}.attn.qkv``,
``text_encoder.encoder.layer.{i}.crossattention.self.key``,
``text_decoder.bert.*``, ``text_decoder.cls.predictions.*``), so a released
checkpoint loads through ``loader.read_checkpoint`` with ``strict=True``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from sprc_tpu_torch.models.albef import (MedEncoder, MedTowers, MedWithHead, momentum_copies,
                                         momentum_update, momentum_weights)
from sprc_tpu_torch.models.generation import stage
from sprc_tpu_torch.models.qformer import QFormerConfig
from sprc_tpu_torch.models.vit import ViTConfig, build_tower
from sprc_tpu_torch.registry import registry

Tensor = torch.Tensor

# the parameters mirrored into the momentum copies (reference albef_vqa.py:64-69:
# the tower, the question encoder, the answer decoder with its LM head)
VQA_MOMENTUM_KEYS = ("visual_encoder.", "text_encoder.", "text_decoder.")


@dataclasses.dataclass(frozen=True)
class VQAConfig(MedTowers):
    flavor: str = "blip"  # 'blip' | 'albef'
    image_size: int = 480
    max_txt_len: int = 35
    vocab_size: int = 30524
    fusion_layer: int = 6  # the albef flavour's
    use_distill: bool = False
    momentum: float = 0.995
    alpha: float = 0.4
    vit_dtype: torch.dtype = torch.bfloat16
    text_dtype: torch.dtype = torch.float32
    vit_config_override: Optional[ViTConfig] = None
    text_config_override: Optional[QFormerConfig] = None
    decoder_config_override: Optional[QFormerConfig] = None

    def decoder_config(self) -> QFormerConfig:
        return self.decoder_config_override or self.text_config()


def per_answer_nll(logits: Tensor, answer_ids: Tensor, pad_token_id: int) -> Tensor:
    """[N] the sum over each answer's shifted non-pad tokens of ``0.9 NLL +
    0.1 mean(-log p)`` (med.py's LM loss with ``reduction='none'``)."""
    labels = torch.where(answer_ids == pad_token_id, -100, answer_ids)
    logp = torch.log_softmax(logits[:, :-1, :].float(), dim=-1)
    shifted = labels[:, 1:]
    valid = shifted != -100
    nll = -logp.gather(-1, torch.where(valid, shifted, 0).long()[..., None])[..., 0]
    per_tok = 0.9 * nll + 0.1 * (-logp.mean(dim=-1))
    return (per_tok * valid).sum(dim=-1)


def per_answer_distill(logits: Tensor, soft_logits: Tensor, answer_ids: Tensor,
                       pad_token_id: int) -> Tensor:
    """[N] the sum over the same positions of ``-sum(softmax(soft) *
    log_softmax(logits))`` (med.py:1254-1259's soft labels)."""
    valid = answer_ids[:, 1:] != pad_token_id
    logp = torch.log_softmax(logits[:, :-1, :].float(), dim=-1)
    soft = torch.softmax(soft_logits[:, :-1, :].float(), dim=-1)
    return (-(soft * logp).sum(dim=-1) * valid).sum(dim=-1)


@registry.register_model("blip_vqa")
@registry.register_model("albef_vqa")
class VQAModel(nn.Module):
    """Question encoder and answer decoder (reference blip_vqa.py:94-160)."""

    CONFIG = VQAConfig
    MOMENTUM_KEYS = VQA_MOMENTUM_KEYS
    MOMENTUM_LAYOUT = True  # its LAVIS checkpoints hold the momentum modules

    def __init__(self, cfg: VQAConfig):
        super().__init__()
        self.cfg = cfg
        tcfg = cfg.text_config()
        # the decoder cross-attends the question states: its key / value
        # projections take the question encoder's width (the JAX dense layers
        # take their input's width; at full size both are 768)
        dcfg = dataclasses.replace(cfg.decoder_config(), encoder_width=tcfg.hidden_size)
        self.visual_encoder = build_tower(cfg.vit_config())
        if cfg.flavor == "albef":
            self.text_encoder = MedEncoder(tcfg, cfg.fusion_layer)
        else:  # BLIP's med: cross-attention on every layer
            self.text_encoder = MedEncoder(tcfg, tcfg.num_layers, cross_from=0)
        self.text_decoder = MedWithHead(dcfg, fusion_layer=dcfg.num_layers, cross_from=0)

    def encode_image(self, images: Tensor) -> Tensor:
        """NHWC images -> the tower's rows [B, S, W] in fp32 (with a graph
        where autograd records)."""
        return self.visual_encoder(images).float()

    def encode_question(self, images: Optional[Tensor], question_ids: Tensor,
                        question_mask: Tensor, *, image_embeds: Optional[Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> Tensor:
        """-> [B, L, H] the multimodal question states (reference :105-124);
        ``image_embeds``: the tower's rows already made."""
        if image_embeds is None:
            image_embeds = self.encode_image(images)
        return self.text_encoder(input_ids=question_ids, attention_mask=question_mask,
                                 image_embeds=image_embeds, mode="multimodal",
                                 generator=generator)

    def decode_logits(self, answer_ids: Tensor, answer_mask: Tensor, question_states: Tensor,
                      question_mask: Tensor,
                      generator: Optional[torch.Generator] = None) -> Tensor:
        """[N, La] answer ids -> [N, La, vocab] logits, the causal decoder
        cross-attending the question states under the question mask."""
        hidden = self.text_decoder.bert(input_ids=answer_ids, attention_mask=answer_mask,
                                        image_embeds=question_states, image_mask=question_mask,
                                        mode="multimodal", is_decoder=True, generator=generator)
        return self.text_decoder.cls(hidden)

    def forward(self, images: Tensor, question_ids: Tensor, question_mask: Tensor,
                answer_ids: Tensor, answer_mask: Tensor, ans_to_question: Tensor,
                weights: Tensor, *, pad_token_id: int = 0, soft_logits: Optional[Tensor] = None,
                alpha=0.0, generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """``{loss, logits}``: ``sum(w_i nll_i) / B`` over the flattened
        answers [N] (reference :155-160); with ``soft_logits`` [N, La, V]
        each ``nll_i`` is ``(1 - alpha) nll_i + alpha distill_i``
        (albef_vqa.py:203-216)."""
        question_states = self.encode_question(images, question_ids, question_mask,
                                               generator=generator)
        logits = self.decode_logits(answer_ids, answer_mask, question_states[ans_to_question],
                                    question_mask[ans_to_question], generator)
        nll = per_answer_nll(logits, answer_ids, pad_token_id)
        if soft_logits is not None:
            distill = per_answer_distill(logits, soft_logits, answer_ids, pad_token_id)
            nll = (1.0 - alpha) * nll + alpha * distill
        return {"loss": (weights * nll).sum() / images.shape[0], "logits": logits}

    # ------------------------------------------------------------- inference

    def answer_probe(self, question_states: Tensor, question_mask: Tensor,
                     answer_ids: Tensor) -> Tensor:
        """[B, A] the probability of each candidate's first token
        (``answer_ids[:, 1]``) after the bos alone (``answer_ids[0, 0]``)."""
        B = question_states.shape[0]
        bos = answer_ids[:1, :1].expand(B, 1)
        first = self.decode_logits(bos, torch.ones_like(bos), question_states, question_mask)
        return torch.softmax(first[:, 0, :].float(), dim=-1)[:, answer_ids[:, 1]]

    def rescore(self, question_states: Tensor, question_mask: Tensor, answer_ids: Tensor,
                answer_mask: Tensor, topk_ids: Tensor, pad_token_id: int = 0) -> Tensor:
        """[B] the candidate of ``topk_ids`` [B, k] with the least NLL, as an
        index into the answer list (ties: the first)."""
        B, k = topk_ids.shape
        cand_ids = answer_ids[topk_ids].reshape(B * k, -1)
        cand_mask = answer_mask[topk_ids].reshape(B * k, -1)
        logits = self.decode_logits(cand_ids, cand_mask,
                                    question_states.repeat_interleave(k, dim=0),
                                    question_mask.repeat_interleave(k, dim=0))
        best = per_answer_nll(logits, cand_ids, pad_token_id).reshape(B, k).argmin(dim=-1)
        return topk_ids.gather(1, best[:, None])[:, 0]

    @torch.no_grad()
    def rank_answers(self, images: Tensor, question_ids: Tensor, question_mask: Tensor,
                     answer_ids: Tensor, answer_mask: Tensor, *, num_ans_candidates: int = 128,
                     pad_token_id: int = 0, stats: Optional[Dict[str, float]] = None
                     ) -> Tuple[Tensor, Tensor]:
        """-> ([B] the best answer's index into the list, [B, k] the top-k
        candidates): the first-token probe, then the full rescoring
        (reference :277-340). ``stats``: seconds by stage (``tower_s``,
        ``question_s``, ``probe_s``, ``rescore_s``), added to."""
        device = images.device
        k = min(num_ans_candidates, answer_ids.shape[0])
        with stage(stats, "tower_s", device):
            image_embeds = self.encode_image(images)
        with stage(stats, "question_s", device):
            states = self.encode_question(None, question_ids, question_mask,
                                          image_embeds=image_embeds)
        with stage(stats, "probe_s", device):
            topk_ids = self.answer_probe(states, question_mask, answer_ids).topk(k, dim=-1)[1]
        with stage(stats, "rescore_s", device):
            best = self.rescore(states, question_mask, answer_ids, answer_mask, topk_ids,
                                pad_token_id)
        return best, topk_ids

    @torch.no_grad()
    def generate_answers(self, images: Tensor, question_ids: Tensor, question_mask: Tensor, *,
                         bos_token_id: int, eos_token_id: int, pad_token_id: int = 0,
                         max_new_tokens: int = 10,
                         stats: Optional[Dict[str, float]] = None) -> Tensor:
        """Greedy answers -> [B, max_new_tokens] ids (reference
        _generate_answers :238-275): the whole prefix decoded a step, each
        row's next token read at its own length; a finished row takes pads
        and a zero mask; the loop stops when every row has produced
        ``eos``. ``stats``: ``tower_s``, ``question_s``, ``decode_s``."""
        device = images.device
        B = images.shape[0]
        with stage(stats, "tower_s", device):
            image_embeds = self.encode_image(images)
        with stage(stats, "question_s", device):
            states = self.encode_question(None, question_ids, question_mask,
                                          image_embeds=image_embeds)
        total = 1 + max_new_tokens
        ids = torch.full((B, total), pad_token_id, dtype=torch.long, device=device)
        ids[:, 0] = bos_token_id
        mask = torch.zeros((B, total), dtype=torch.long, device=device)
        mask[:, 0] = 1
        rows = torch.arange(B, device=device)
        lengths = torch.ones(B, dtype=torch.long, device=device)
        finished = torch.zeros(B, dtype=torch.bool, device=device)
        with stage(stats, "decode_s", device):
            for _ in range(max_new_tokens):
                logits = self.decode_logits(ids, mask, states, question_mask)
                nxt = logits[rows, lengths - 1].float().argmax(dim=-1)
                nxt = torch.where(finished, torch.full_like(nxt, pad_token_id), nxt)
                ids[rows, lengths] = nxt
                mask[rows, lengths] = (~finished).long()
                lengths = lengths + (~finished).long()
                finished = finished | (nxt == eos_token_id)
                if bool(finished.all()):
                    break
        return ids[:, 1:]


# ------------------------------------------------- functional momentum state


def init_vqa_state(params: Dict[str, Tensor]) -> Dict[str, Any]:
    return momentum_copies(params, VQA_MOMENTUM_KEYS)


def vqa_train_step(model: VQAModel, params: Dict[str, Tensor], state: Dict[str, Any],
                   batch: Dict[str, Tensor], *, alpha,
                   generator: Optional[torch.Generator] = None):
    """One distilled VQA forward (reference albef_vqa.py:153-226): the
    momentum update, the momentum model's answer logits without a graph
    (no dropout), the weighted ``(1 - alpha)`` CE + ``alpha`` distill loss.
    ``params``: the parameters' fp32 values by name. Returns ``({loss},
    new state)``."""
    state = momentum_update(params, state, model.cfg.momentum)
    a2q, qmask = batch["ans_to_question"], batch["question_mask"]
    with torch.no_grad(), momentum_weights(model, state["params_m"]):
        states_m = model.encode_question(batch["images"], batch["question_ids"], qmask)
        logits_m = model.decode_logits(batch["answer_ids"], batch["answer_mask"], states_m[a2q],
                                       qmask[a2q])
    out = model(batch["images"], batch["question_ids"], qmask, batch["answer_ids"],
                batch["answer_mask"], a2q, batch["weights"], soft_logits=logits_m,
                alpha=torch.as_tensor(alpha, dtype=torch.float32, device=logits_m.device),
                generator=generator)
    return {"loss": out["loss"]}, state
