"""The med-BERT and the ALBEF models (counterpart of ``sprc_tpu/models/albef.py``;
reference lavis/models/med.py, albef_models/albef_retrieval.py,
albef_pretrain.py).

:class:`MedEncoder` (``MedEncoder``, :39-135) is a BERT-base encoder whose
layers may cross-attend image rows over every text position:

- mode ``"text"`` runs layers ``[0, fusion_layer)`` without cross-attention,
  mode ``"fusion"`` runs ``[fusion_layer, n)`` with it, mode ``"multimodal"``
  runs every layer, cross-attending from ``cross_from`` (ALBEF:
  ``fusion_layer``; BLIP-1: every layer has cross-attention, ``fusion_layer =
  n`` and ``cross_from = 0``, med.py:406-420);
- padding masks are the additive ``(1 - m) * -10000`` bias, an
  ``image_mask`` gives the cross-attention's;
- ``is_decoder`` adds the causal ``-10000`` bias (the captioner);
- ``gradcam_layer`` / ``gradcam_probe``: that layer's cross-attention also
  returns its softmax probabilities, with the zero-valued probe added to
  them (:func:`sprc_tpu_torch.utils.gradcam.compute_gradcam` takes the
  gradient with respect to it).

Every layer is the JAX package's unfused composition
(``QFormerAttention`` / ``QFormerFFN``; no Pallas kernel runs there), here
the port's :class:`~sprc_tpu_torch.models.qformer.QFormerAttention` through
its ``train_forward`` (``torch.matmul`` dense ops, attention through
:func:`~sprc_tpu_torch.ops.attention.dot_product_attention`, exact GELU,
post-LN residuals) and, in training mode with autograd recording, hidden
dropout at the JAX package's places. Module names are the reference's
(``embeddings.word_embeddings``, ``encoder.layer.{i}.attention.self.query``,
``crossattention.output.LayerNorm``, ``intermediate.dense``,
``output.LayerNorm``), so a released checkpoint's text tower loads by name.

The momentum-queue machinery (:func:`init_albef_state`,
:func:`momentum_update`, :func:`enqueue`, :func:`rampup_alpha`) is the JAX
package's functional state, keyed by the port's parameter names: fp32
momentum copies of the names under the model's ``MOMENTUM_KEYS`` (never
aliasing the live tensors; a bf16 tower's copies are fp32 masters, since
``0.995 m + 0.005 p`` rounds away in bf16, cast to the tower's dtype once a
step for the momentum forward, :func:`momentum_weights`), two L2-normalised
``[E, K]`` queues drawn from ``np.random.RandomState(seed)``, ``idx_queue``
(-100) and ``ptr``; the ring enqueue wraps.

:class:`AlbefRetrieval` (``albef_retrieval``, ``albef_feature_extractor``)
and :class:`AlbefPretrain` (``albef_pretrain``, its med-BERT wrapped as
LAVIS's ``BertForMaskedLM``: ``text_encoder.bert.*``, the MLM head
``text_encoder.cls.*``): momentum-distilled queue ITC with multi-positive
targets by image id, hard-negative ITM over fusion CLS rows and (pretrain)
momentum-distilled MLM over host-masked ids (:func:`mlm_mask`, the JAX
function's draws bit for bit). Hard negatives are drawn by
:func:`sample_negatives` (``torch.multinomial`` on the caller's generator
where JAX draws ``jax.random.categorical``) unless the forward is handed
them. The tower trains through kernel K2's ``FusedViTBlock`` on the card;
the med-BERT runs without dropout, as the JAX train steps apply the models
deterministically. The step functions (:func:`albef_train_step`,
:func:`albef_pretrain_train_step`) take the parameters' fp32 values by name
and the state, and return ``(losses, new state)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sprc_tpu_torch.models.lm import QFormerLMHead
from sprc_tpu_torch.models.qformer import (NEG_INF, Dense, DenseLN, QFormerAttention,
                                           QFormerConfig, QFormerEmbeddings, _ffn_train,
                                           make_additive_mask, training)
from sprc_tpu_torch.models.vit import ViTConfig, blip_vit_b_config, build_tower
from sprc_tpu_torch.ops.layers import Linear, l2_normalize
from sprc_tpu_torch.registry import registry

Tensor = torch.Tensor

MODES = ("text", "fusion", "multimodal")


class MedLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross_attention: bool):
        super().__init__()
        H, M, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.attention = QFormerAttention(cfg, H)
        if has_cross_attention:
            self.crossattention = QFormerAttention(cfg, cfg.encoder_width)
        self.intermediate = Dense(H, M, False)
        self.output = DenseLN(M, H, eps, False)


class MedEncoderLayers(nn.Module):
    def __init__(self, cfg: QFormerConfig, cross_from: int):
        super().__init__()
        self.layer = nn.ModuleList(MedLayer(cfg, i >= cross_from) for i in range(cfg.num_layers))


class MedEncoder(nn.Module):
    """The med-BERT (BertModel without its pooler). ``fusion_layer`` and
    ``cross_from`` as in the JAX module; layers from ``cross_from`` on hold
    cross-attention weights."""

    def __init__(self, cfg: QFormerConfig, fusion_layer: int, cross_from: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.fusion_layer = fusion_layer
        self.cross_from = fusion_layer if cross_from is None else cross_from
        self.embeddings = QFormerEmbeddings(cfg)
        self.encoder = MedEncoderLayers(cfg, self.cross_from)

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                image_embeds: Optional[torch.Tensor] = None,
                image_mask: Optional[torch.Tensor] = None, *, mode: str = "multimodal",
                is_decoder: bool = False, generator: Optional[torch.Generator] = None,
                gradcam_layer: Optional[int] = None,
                gradcam_probe: Optional[torch.Tensor] = None):
        """-> hidden [B, L, H] in the config's dtype; with ``gradcam_layer``,
        ``(hidden, that layer's cross-attention probabilities [B, heads, L,
        Si] or None where it has none)``."""
        cfg = self.cfg
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: expected one of {MODES}")
        hidden = (self.embeddings(input_ids, None, generator=generator) if inputs_embeds is None
                  else inputs_embeds.to(cfg.dtype))
        S = hidden.shape[1]
        bias = None
        if attention_mask is not None:
            bias = make_additive_mask(attention_mask)[:, None, None, :]
        cross_bias = None if image_mask is None else make_additive_mask(image_mask)[:, None, None, :]
        if is_decoder:
            causal = torch.tril(torch.ones((S, S), dtype=torch.float32, device=hidden.device))
            causal_bias = ((1.0 - causal) * NEG_INF)[None, None]
            bias = causal_bias if bias is None else bias + causal_bias
        start, end = {"text": (0, self.fusion_layer), "fusion": (self.fusion_layer, cfg.num_layers),
                      "multimodal": (0, cfg.num_layers)}[mode]
        image = None if image_embeds is None else image_embeds.to(cfg.dtype)
        run = cfg if training(self) else dataclasses.replace(cfg, dropout_rate=0.0)
        probs = None
        for i in range(start, end):
            layer = self.encoder.layer[i]
            hidden = layer.attention.train_forward(hidden, hidden, bias, run, generator)
            if i >= self.cross_from and image is not None:
                if gradcam_layer == i:
                    hidden, probs = layer.crossattention.train_forward(
                        hidden, image, cross_bias, run, generator, return_probs=True,
                        probs_offset=gradcam_probe)
                else:
                    hidden = layer.crossattention.train_forward(hidden, image, cross_bias, run,
                                                                generator)
            hidden = _ffn_train(layer.intermediate, layer.output, hidden, run, generator)
        if gradcam_layer is not None:
            return hidden, probs
        return hidden


class MedWithHead(nn.Module):
    """LAVIS's ``BertForMaskedLM`` / ``BertLMHeadModel`` names: the med-BERT
    under ``bert``, its LM head under ``cls`` (``cls.predictions.transform.
    dense``, ``...decoder``)."""

    def __init__(self, cfg: QFormerConfig, fusion_layer: int, cross_from: Optional[int] = None):
        super().__init__()
        self.bert = MedEncoder(cfg, fusion_layer, cross_from)
        self.cls = QFormerLMHead(cfg)


class MedTowers:
    """The two sub-configs of a BLIP-1 / ALBEF config: its override, else
    BLIP-1's ViT-B/16 and the med-BERT over its width."""

    def vit_config(self) -> ViTConfig:
        return self.vit_config_override or blip_vit_b_config(self.image_size, dtype=self.vit_dtype)

    def text_config(self) -> QFormerConfig:
        return self.text_config_override or QFormerConfig(
            vocab_size=self.vocab_size, encoder_width=self.vit_config().width,
            dtype=self.text_dtype)


@dataclasses.dataclass(frozen=True)
class AlbefConfig(MedTowers):
    image_size: int = 384
    embed_dim: int = 256
    max_txt_len: int = 30
    vocab_size: int = 30523
    fusion_layer: int = 6
    queue_size: int = 65536
    momentum: float = 0.995
    alpha: float = 0.4
    temp_init: float = 0.07
    use_distill: bool = True
    vit_dtype: torch.dtype = torch.bfloat16
    text_dtype: torch.dtype = torch.float32
    vit_config_override: Optional[ViTConfig] = None
    text_config_override: Optional[QFormerConfig] = None


# ------------------------------------------------------------ the losses


def itc_targets(image_ids: Tensor, idx_queue: Tensor) -> Tensor:
    """Multi-positive targets [B, B + K]: 1 / (#positives) where the image
    ids of the batch and the queue match a row's."""
    idx_all = torch.cat([image_ids, idx_queue.to(image_ids.dtype)])
    pos = (image_ids.reshape(-1, 1) == idx_all[None, :]).float()
    return pos / pos.sum(dim=1, keepdim=True)


def queue_itc(image_feat: Tensor, text_feat: Tensor, image_feat_m: Tensor, text_feat_m: Tensor,
              image_queue: Tensor, text_queue: Tensor, sim_targets: Tensor, temp: Tensor,
              alpha, distill: bool = True) -> Tuple[Tensor, Tensor, Tensor]:
    """The momentum-distilled queue ITC (albef.py:230-254): ``(loss,
    sim_i2t, sim_t2i)``; the soft targets mix the momentum features'
    softmax with ``sim_targets`` by ``alpha``, without a gradient."""
    image_feat_all = torch.cat([image_feat_m.t(), image_queue], dim=1)
    text_feat_all = torch.cat([text_feat_m.t(), text_queue], dim=1)
    sim_i2t = image_feat @ text_feat_all / temp
    sim_t2i = text_feat @ image_feat_all / temp
    if distill:
        with torch.no_grad():
            t = temp.detach()
            i2t_t = (alpha * torch.softmax(image_feat_m @ text_feat_all / t, dim=-1)
                     + (1 - alpha) * sim_targets)
            t2i_t = (alpha * torch.softmax(text_feat_m @ image_feat_all / t, dim=-1)
                     + (1 - alpha) * sim_targets)
    else:
        i2t_t = t2i_t = sim_targets
    loss_i2t = -(torch.log_softmax(sim_i2t, dim=-1) * i2t_t).sum(dim=1).mean()
    loss_t2i = -(torch.log_softmax(sim_t2i, dim=-1) * t2i_t).sum(dim=1).mean()
    return (loss_i2t + loss_t2i) / 2, sim_i2t, sim_t2i


def sample_negatives(weights: Tensor, generator: Optional[torch.Generator]) -> Tensor:
    """One column a row [B], drawn with probability proportional to
    ``weights + 1e-9`` (JAX: ``jax.random.categorical(key, log(w + 1e-9))``)
    from ``generator``; without one, the argmax (JAX without a ``sample``
    rng)."""
    if generator is None:
        return weights.argmax(dim=1)
    return torch.multinomial(weights + 1e-9, 1, generator=generator)[:, 0]


def hard_negatives(sim_i2t: Tensor, sim_t2i: Tensor, image_ids: Tensor,
                   generator: Optional[torch.Generator]) -> Tuple[Tensor, Tensor]:
    """In-batch hard negatives (albef.py:256-268): ``(neg_img, neg_txt)``,
    each row's pick from the softmax of its in-batch sims, its own image id's
    columns zeroed; the image picks first, as JAX splits its key."""
    bs = image_ids.shape[0]
    with torch.no_grad():
        same = image_ids.reshape(-1, 1) == image_ids[None, :]
        w_i2t = torch.softmax(sim_i2t[:, :bs] + 1e-4, dim=1).masked_fill(same, 0.0)
        w_t2i = torch.softmax(sim_t2i[:, :bs] + 1e-4, dim=1).masked_fill(same, 0.0)
        return sample_negatives(w_t2i, generator), sample_negatives(w_i2t, generator)


def itm_loss(logits: Tensor, bs: int) -> Tensor:
    """CE of [3B, 2] ITM logits: the B positives first, then 2B negatives."""
    labels = torch.cat([torch.ones(bs, dtype=torch.int64, device=logits.device),
                        torch.zeros(2 * bs, dtype=torch.int64, device=logits.device)])
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def tower_rows(tower: nn.Module, images: Tensor) -> Tensor:
    """NHWC images -> the tower's rows [B, S, W] in fp32, without a graph."""
    with torch.no_grad():
        return tower(images).float()


class _QueueModel(nn.Module):
    """What the momentum-queue models share: the tower, the projections, the
    ITM head, ``temp``, the unimodal pass and the no-dropout rule."""

    MOMENTUM_KEYS = ("visual_encoder.", "text_encoder.", "vision_proj.", "text_proj.")
    # its LAVIS checkpoints hold momentum modules and queues (loader.read_checkpoint)
    MOMENTUM_LAYOUT = True

    def _build(self, cfg, text_encoder: nn.Module) -> None:
        tcfg = cfg.text_config()
        self.visual_encoder = build_tower(cfg.vit_config())
        self.text_encoder = text_encoder
        self.vision_proj = Linear(cfg.vit_config().width, cfg.embed_dim, dtype=tcfg.dtype)
        self.text_proj = Linear(tcfg.hidden_size, cfg.embed_dim, dtype=tcfg.dtype)
        self.itm_head = Linear(tcfg.hidden_size, 2, dtype=tcfg.dtype)
        self.temp = nn.Parameter(torch.empty(()))

    @property
    def med(self) -> MedEncoder:
        """The med-BERT of the unimodal text pass."""
        return self.text_encoder

    def train(self, mode: bool = True):
        """The JAX train steps apply these models deterministically: the
        med-BERTs stay in eval mode (no dropout) whatever ``mode`` is."""
        super().train(mode)
        for module in self.modules():
            if isinstance(module, MedEncoder):
                module.eval()
        return self

    def encode_image(self, images: Tensor) -> Tensor:
        return tower_rows(self.visual_encoder, images)

    def unimodal(self, images: Tensor, input_ids: Tensor, text_mask: Tensor,
                 image_embeds: Optional[Tensor] = None):
        """-> (image rows [B, S, W] fp32, image feature [B, E], text rows,
        text feature [B, E]), the features L2-normalised; the tower records
        a graph where autograd does (``image_embeds``: rows already made)."""
        if image_embeds is None:
            image_embeds = self.visual_encoder(images).float()
        image_feat = l2_normalize(self.vision_proj(image_embeds[:, 0, :]))
        text_embeds = self.med(input_ids=input_ids, attention_mask=text_mask, mode="text")
        text_feat = l2_normalize(self.text_proj(text_embeds[:, 0, :]))
        return image_embeds, image_feat, text_embeds, text_feat

    def text_features(self, input_ids: Tensor, text_mask: Tensor) -> Tuple[Tensor, Tensor]:
        """(text rows, the CLS projection, not normalised): the evaluation's."""
        text_embeds = self.med(input_ids=input_ids, attention_mask=text_mask, mode="text")
        return text_embeds, self.text_proj(text_embeds[:, 0, :])

    def queue_losses(self, image_feat, text_feat, image_ids, image_feat_m, text_feat_m,
                     image_queue, text_queue, idx_queue, alpha, generator, negatives):
        """(loss_itc, neg_img, neg_txt)."""
        temp = self.temp.clamp(0.001, 0.5)
        loss_itc, sim_i2t, sim_t2i = queue_itc(
            image_feat, text_feat, image_feat_m, text_feat_m, image_queue, text_queue,
            itc_targets(image_ids, idx_queue), temp, alpha,
            distill=getattr(self.cfg, "use_distill", True))
        if negatives is None:
            negatives = self.pick_negatives(sim_i2t, sim_t2i, image_ids, generator)
        return loss_itc, negatives

    def pick_negatives(self, sim_i2t, sim_t2i, image_ids, generator):
        return hard_negatives(sim_i2t, sim_t2i, image_ids, generator)


@registry.register_model("albef_retrieval")
@registry.register_model("albef_feature_extractor")
class AlbefRetrieval(_QueueModel):
    """ALBEF retrieval (reference albef_retrieval.py:26-306): ViT-B, a
    med-BERT whose first ``fusion_layer`` layers are text-only and whose
    others cross-attend the image rows, the projections, ``itm_head`` and
    ``temp``."""

    CONFIG = AlbefConfig

    def __init__(self, cfg: AlbefConfig):
        super().__init__()
        self.cfg = cfg
        self._build(cfg, self._text_module(cfg.text_config()))

    def _text_module(self, tcfg: QFormerConfig) -> nn.Module:
        return MedEncoder(tcfg, self.cfg.fusion_layer)

    def fusion_cls(self, text_embeds: Tensor, text_mask: Tensor, image_embeds: Tensor) -> Tensor:
        """The fusion layers over text rows and image rows -> CLS rows [B, H]."""
        out = self.med(inputs_embeds=text_embeds, attention_mask=text_mask,
                       image_embeds=image_embeds, mode="fusion")
        return out[:, 0, :]

    def itm_scores(self, text_embeds: Tensor, text_mask: Tensor, image_embeds: Tensor) -> Tensor:
        """The match logit [B] (``itm_head(fusion_cls(...))[:, 1]``)."""
        return self.itm_head(self.fusion_cls(text_embeds, text_mask, image_embeds))[:, 1]

    def retrieval_losses(self, rows, text_mask, image_ids, image_feat_m, text_feat_m,
                         image_queue, text_queue, idx_queue, alpha, generator=None,
                         negatives=None) -> Dict[str, Tensor]:
        image_embeds, image_feat, text_embeds, text_feat = rows
        bs = image_embeds.shape[0]
        loss_itc, (neg_img, neg_txt) = self.queue_losses(
            image_feat, text_feat, image_ids, image_feat_m, text_feat_m, image_queue,
            text_queue, idx_queue, alpha, generator, negatives)
        pos_cls = self.fusion_cls(text_embeds, text_mask, image_embeds)
        neg_cls = self.fusion_cls(torch.cat([text_embeds, text_embeds[neg_txt]]),
                                  torch.cat([text_mask, text_mask[neg_txt]]),
                                  torch.cat([image_embeds[neg_img], image_embeds]))
        logits = self.itm_head(torch.cat([pos_cls, neg_cls]))
        return {"loss_itc": loss_itc, "loss_itm": itm_loss(logits, bs)}

    def forward(self, images: Tensor, input_ids: Tensor, text_mask: Tensor, image_ids: Tensor,
                image_feat_m: Tensor, text_feat_m: Tensor, image_queue: Tensor,
                text_queue: Tensor, idx_queue: Tensor, alpha, *,
                generator: Optional[torch.Generator] = None,
                negatives: Optional[Tuple[Tensor, Tensor]] = None) -> Dict[str, Tensor]:
        """``{loss_itc, loss_itm}``. ``negatives``: ``(neg_img, neg_txt)``
        [B] each, else drawn from ``generator``."""
        return self.retrieval_losses(self.unimodal(images, input_ids, text_mask), text_mask,
                                     image_ids, image_feat_m, text_feat_m, image_queue,
                                     text_queue, idx_queue, alpha, generator, negatives)


@registry.register_model("albef_pretrain")
class AlbefPretrain(AlbefRetrieval):
    """ALBEF pretraining (reference albef_pretrain.py:33-330): the retrieval
    losses plus momentum-distilled MLM over the multimodal encoder, CE on the
    masked positions mixed with ``-E[logp . softmax(logits_m)]`` by ``alpha``.
    The med-BERT is LAVIS's ``BertForMaskedLM`` (``text_encoder.bert``, the
    MLM head ``text_encoder.cls``); the head is not a momentum key, so the
    momentum MLM logits use the live head, as in JAX. The tower runs once a
    step (JAX calls it twice, and XLA merges the calls)."""

    MOMENTUM_KEYS = ("visual_encoder.", "text_encoder.bert.", "vision_proj.", "text_proj.")

    def _text_module(self, tcfg: QFormerConfig) -> nn.Module:
        return MedWithHead(tcfg, self.cfg.fusion_layer)

    @property
    def med(self) -> MedEncoder:
        return self.text_encoder.bert

    def mlm_logits(self, masked_ids: Tensor, text_mask: Tensor, image_embeds: Tensor) -> Tensor:
        hidden = self.med(input_ids=masked_ids, attention_mask=text_mask,
                          image_embeds=image_embeds, mode="multimodal")
        return self.text_encoder.cls(hidden)

    def mlm_loss(self, image_embeds, masked_ids, text_mask, mlm_labels, logits_m, alpha) -> Tensor:
        logits = self.mlm_logits(masked_ids, text_mask, image_embeds).float()
        valid = mlm_labels != -100
        denom = valid.sum().clamp_min(1)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, torch.where(valid, mlm_labels, 0).long()[..., None])[..., 0]
        loss = (nll * valid).sum() / denom
        if logits_m is not None:
            soft = torch.softmax(logits_m.detach().float(), dim=-1)
            distill = (-(logp * soft).sum(-1) * valid).sum() / denom
            loss = (1.0 - alpha) * loss + alpha * distill
        return loss

    def forward(self, images, input_ids, text_mask, masked_ids, mlm_labels, image_ids,
                image_feat_m, text_feat_m, image_queue, text_queue, idx_queue, mlm_logits_m,
                alpha, *, generator=None, negatives=None) -> Dict[str, Tensor]:
        rows = self.unimodal(images, input_ids, text_mask)
        losses = self.retrieval_losses(rows, text_mask, image_ids, image_feat_m, text_feat_m,
                                       image_queue, text_queue, idx_queue, alpha, generator,
                                       negatives)
        losses["loss_mlm"] = self.mlm_loss(rows[0], masked_ids, text_mask, mlm_labels,
                                           mlm_logits_m, alpha)
        losses["loss"] = losses["loss_itc"] + losses["loss_itm"] + losses["loss_mlm"]
        return losses


# ------------------------------------------------- functional momentum state


def init_albef_state(params: Dict[str, Tensor], cfg, seed: int = 0,
                     keys: Tuple[str, ...] = _QueueModel.MOMENTUM_KEYS) -> Dict[str, Any]:
    """Momentum copies (fp32, fresh storage) of the ``params`` (name -> the
    value) under ``keys``, the L2-normalised image and text queues [E, K]
    from ``RandomState(seed)`` (the JAX draws), ``idx_queue`` (-100) and
    ``ptr`` (0), on the parameters' device."""
    rng = np.random.RandomState(seed)
    iq = rng.randn(cfg.embed_dim, cfg.queue_size).astype(np.float32)
    tq = rng.randn(cfg.embed_dim, cfg.queue_size).astype(np.float32)
    iq /= np.linalg.norm(iq, axis=0, keepdims=True)
    tq /= np.linalg.norm(tq, axis=0, keepdims=True)
    device = next(iter(params.values())).device
    return {**momentum_copies(params, keys), "image_queue": torch.from_numpy(iq).to(device),
            "text_queue": torch.from_numpy(tq).to(device),
            "idx_queue": torch.full((cfg.queue_size,), -100, dtype=torch.int64, device=device),
            "ptr": torch.zeros((), dtype=torch.int64, device=device)}


def momentum_copies(params: Dict[str, Tensor], keys: Tuple[str, ...]) -> Dict[str, Any]:
    """``{"params_m": ...}``: fp32 copies, in fresh storage, of the
    ``params`` (name -> value) under ``keys`` (the whole state of the JAX
    ``init_vqa_state``, ``init_classifier_state`` and ``init_nlvr_state``)."""
    return {"params_m": {n: p.detach().to(torch.float32, copy=True)
                         for n, p in params.items() if n.startswith(tuple(keys))}}


@torch.no_grad()
def momentum_update(params: Dict[str, Tensor], state: Dict[str, Any],
                    momentum: float) -> Dict[str, Any]:
    """``m <- momentum m + (1 - momentum) p`` in fp32 for every copy, into
    new tensors (a skipped step keeps the old state)."""
    new_m = {n: m * momentum + params[n].float() * (1.0 - momentum)
             for n, m in state["params_m"].items()}
    return {**state, "params_m": new_m}


@torch.no_grad()
def enqueue(state: Dict[str, Any], image_feat_m: Tensor, text_feat_m: Tensor,
            image_ids: Tensor) -> Dict[str, Any]:
    """The ring enqueue (reference SharedQueueMixin._dequeue_and_enqueue):
    the batch's momentum features and ids at ``ptr``, wrapping, into new
    tensors."""
    bs = image_feat_m.shape[0]
    qs = state["image_queue"].shape[1]
    ptr = state["ptr"]
    cols = (ptr + torch.arange(bs, device=ptr.device)) % qs
    image_queue, text_queue = state["image_queue"].clone(), state["text_queue"].clone()
    idx_queue = state["idx_queue"].clone()
    image_queue[:, cols] = image_feat_m.t().float()
    text_queue[:, cols] = text_feat_m.t().float()
    idx_queue[cols] = image_ids.to(idx_queue.dtype)
    return {**state, "image_queue": image_queue, "text_queue": text_queue,
            "idx_queue": idx_queue, "ptr": (ptr + bs) % qs}


@contextlib.contextmanager
def momentum_weights(model: nn.Module, params_m: Dict[str, Tensor]) -> Iterator[nn.Module]:
    """``model`` with each named parameter replaced by its momentum copy cast
    to the parameter's dtype (once; an fp32 copy is used as it is), the live
    parameters put back on exit: JAX's ``{**params, **params_m}``. For
    forwards without a graph."""
    saved = []
    try:
        for name, m in params_m.items():
            owner, _, key = name.rpartition(".")
            module = model.get_submodule(owner)
            live = module._parameters[key]
            saved.append((module, key, live))
            module._parameters[key] = m.to(live.dtype)
        yield model
    finally:
        for module, key, live in reversed(saved):
            module._parameters[key] = live


def rampup_alpha(cfg, epoch: int, iters: int, iters_per_epoch: int) -> float:
    """The alpha ramp (reference albef_retrieval.py:104-105):
    ``alpha min(1, (epoch n + i) / 2n)``."""
    return cfg.alpha * min(1.0, (epoch * iters_per_epoch + iters) / (2 * iters_per_epoch))


def mlm_mask(rng: np.random.RandomState, input_ids: np.ndarray, vocab_size: int,
             mask_token_id: int, *, pad_token_id: int = 0, cls_token_id: int = 2,
             probability: float = 0.15):
    """Host-side BERT masking (reference albef_pretrain.py:340-370): select
    ``probability`` of the non-special tokens; 80 % -> [MASK], 10 % ->
    random, 10 % kept. ``(masked_ids, labels)``, -100 where unselected; the
    draws of the JAX function, in its order."""
    ids = np.array(input_ids, np.int32)
    special = (ids == pad_token_id) | (ids == cls_token_id)
    picked = (rng.rand(*ids.shape) < probability) & ~special
    labels = np.where(picked, ids, -100).astype(np.int32)
    r = rng.rand(*ids.shape)
    masked = np.where(picked & (r < 0.8), mask_token_id, ids)
    masked = np.where(picked & (r >= 0.8) & (r < 0.9), rng.randint(0, vocab_size, ids.shape),
                      masked).astype(np.int32)
    return masked, labels


def momentum_names(model: nn.Module) -> List[str]:
    """The parameter names under the model's ``MOMENTUM_KEYS``."""
    return [n for n, _ in model.named_parameters() if n.startswith(model.MOMENTUM_KEYS)]


def _momentum_rows(model, state, batch, mlm: bool = False):
    """The momentum model's unimodal features (and, ``mlm``, its MLM logits
    over ``masked_ids``), without a graph."""
    with torch.no_grad(), momentum_weights(model, state["params_m"]):
        image_embeds_m, image_feat_m, _, text_feat_m = model.unimodal(
            batch["images"], batch["input_ids"], batch["text_mask"])
        logits_m = (model.mlm_logits(batch["masked_ids"], batch["text_mask"], image_embeds_m)
                    if mlm else None)
    return image_feat_m, text_feat_m, logits_m


def _alpha(alpha, device) -> Tensor:
    return torch.as_tensor(alpha, dtype=torch.float32, device=device)


def queue_step(model, params, state, batch, inputs: Tuple[str, ...], *, alpha, generator=None,
               negatives=None, mlm: bool = False):
    """One step's forward of a momentum-queue model (the JAX package's four
    ``*_train_step``): momentum update -> the momentum model's features (and,
    ``mlm``, its MLM logits) -> the losses -> the enqueue. ``params``: the
    parameters' fp32 values by name (the trainer's masters); ``inputs``: the
    batch keys the forward takes before the momentum features. Returns
    ``(losses, new state)``."""
    state = momentum_update(params, state, model.cfg.momentum)
    image_feat_m, text_feat_m, logits_m = _momentum_rows(model, state, batch, mlm)
    losses = model(*(batch[k] for k in inputs), image_feat_m, text_feat_m, state["image_queue"],
                   state["text_queue"], state["idx_queue"], *((logits_m,) if mlm else ()),
                   _alpha(alpha, image_feat_m.device), generator=generator, negatives=negatives)
    return losses, enqueue(state, image_feat_m, text_feat_m, batch["image_ids"])


def albef_train_step(model, params, state, batch, **kw):
    return queue_step(model, params, state, batch,
                      ("images", "input_ids", "text_mask", "image_ids"), **kw)


def albef_pretrain_train_step(model, params, state, batch, **kw):
    """``batch['image_ids']`` should be globally unique (the diagonal ITC)."""
    return queue_step(model, params, state, batch, ("images", "input_ids", "text_mask",
                                                    "masked_ids", "mlm_labels", "image_ids"),
                      mlm=True, **kw)
