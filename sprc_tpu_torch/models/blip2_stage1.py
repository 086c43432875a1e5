"""BLIP-2 stage 1, the Q-Former that SPRC starts from (counterpart of
``sprc_tpu/models/blip2_stage1.py``; reference
src/lavis/models/blip2_models/blip2_qformer.py:95-315 and
blip2_image_text_matching.py).

Registered as ``blip2`` and ``blip2_feature_extractor``
(:class:`Blip2Stage1`), and ``blip2_image_text_matching``
(:class:`Blip2ITM`). The training forward returns three losses:

- **ITC** (:129-172): the token-max similarity of each caption's CLS
  feature and each image's 32 query features, both ways, through kernel K1
  with a gradient (:class:`~sprc_tpu_torch.ops.sim_kernels.TokenMaxSim`),
  divided by the temperature; cross-entropy smoothed by 0.1 over the
  in-batch targets.
- **ITM** (:177-247): the hardest other image of each caption and the
  hardest other caption of each image (:class:`_HardNegMixin`: the argmax of
  the masked similarities, as the JAX train step passes no ``sample`` rng);
  one joint pass of the queries and the captions over [positives, negative
  images, negative captions] (3B items) with the ``itm_head`` averaged over
  the query rows. The pass runs inside
  :func:`~sprc_tpu_torch.ops.layers.recomputing`.
- **LM** (:249-268): the decoder pass (UniLM mask) with the caption's first
  token replaced by ``bos_token_id`` (``[DEC]``, 30522), next-token
  cross-entropy smoothed by 0.1, pads ignored. The pass never reaches K3
  (the Q-Former's decoder mask takes the unfused layers), as in JAX.

The tower is frozen on the ``pretrain`` rows (no gradient reaches it), as in
the JAX model, whose ``embed_cached`` stops the gradient only under
``freeze_vit``; what the optimizer does with a frozen tower's tensors is the
trainer's business (``train/generic.py``). The ``coco`` rows say
``freeze_vit: false``: there the tower runs with a graph and trains, its
blocks through the kernels' autograd Functions (``models/vit.py``). Losses
and gradients are held against JAX's ``Blip2Stage1.__call__`` in
``tests/test_torch_stage1.py`` (frozen) and
``tests/test_torch_unfrozen_vit.py`` (the tower's gradients).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sprc_tpu_torch.models.cir_base import Blip2CirBase, CirConfig
from sprc_tpu_torch.models.cir_variants import _HardNegMixin, _itm_loss, _ones_mask
from sprc_tpu_torch.models.lm import QFormerLMHead
from sprc_tpu_torch.ops.layers import l2_normalize, recomputing
from sprc_tpu_torch.registry import registry

Tensor = torch.Tensor
Generator = Optional[torch.Generator]

BOS_TOKEN_ID = 30522  # [DEC], the row the BERT vocabulary gains


def smoothed_cross_entropy(logits: Tensor, targets: Tensor, smoothing: float = 0.1) -> Tensor:
    """Mean over rows of ``(1 - s) nll + s mean(-log p)`` in fp32 (JAX's
    ``_smoothed_ce``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[:, None])[:, 0]
    return ((1.0 - smoothing) * nll + smoothing * -logp.mean(dim=-1)).mean()


@registry.register_model("blip2")
@registry.register_model("blip2_feature_extractor")
class Blip2Stage1(Blip2CirBase, _HardNegMixin):
    """ITC + ITM + LM stage-1 pretraining."""

    LOSSES = ("loss_itc", "loss_itm", "loss_lm")

    def __init__(self, cfg: CirConfig):
        super().__init__(cfg)
        self.Qformer["cls"] = QFormerLMHead(cfg.qformer_config())

    @property
    def lm_head(self) -> QFormerLMHead:
        return self.Qformer["cls"]

    def forward(self, images: Tensor, input_ids: Tensor, text_mask: Tensor, *,
                bos_token_id: int = BOS_TOKEN_ID, pad_token_id: int = 0,
                generator: Generator = None, sample_generator: Generator = None
                ) -> Dict[str, Tensor]:
        """images [B, H, W, 3] through the tower (a frozen one without a
        graph), then the three losses. ``generator``: the dropout masks;
        ``sample_generator``: drawn hard negatives (the JAX package's opt-in
        ``sample`` rng)."""
        with self.tower_grad():
            tower = self.encode_tower(images)
        return self.losses_from_embeds(self.embed_cached(tower), input_ids, text_mask,
                                       bos_token_id=bos_token_id, pad_token_id=pad_token_id,
                                       generator=generator, sample_generator=sample_generator)

    def losses_from_embeds(self, image_embeds: Tensor, input_ids: Tensor, text_mask: Tensor, *,
                           bos_token_id: int = BOS_TOKEN_ID, pad_token_id: int = 0,
                           generator: Generator = None, sample_generator: Generator = None
                           ) -> Dict[str, Tensor]:
        bs, Q = input_ids.shape[0], self.cfg.num_query_token
        image_feats = self.target_features(image_embeds, generator)  # [B, Q, E]
        text_hidden = self.qformer(input_ids=input_ids, attention_mask=text_mask,
                                   generator=generator)
        text_feat = l2_normalize(self.text_proj(text_hidden[:, 0]))  # [B, E]

        # ITC: K1 gives [B_txt, B_img]
        sim_t2i = self.token_max_sim(text_feat, image_feats) / self.temp
        targets = torch.arange(bs, device=sim_t2i.device)
        loss_itc = 0.5 * (smoothed_cross_entropy(sim_t2i.t(), targets)
                          + smoothed_cross_entropy(sim_t2i, targets))

        # ITM with in-batch hard negatives
        neg_img, neg_txt = self._neg_indices(sim_t2i, sample_generator)
        ids_all = torch.cat([input_ids, input_ids, input_ids[neg_txt]])
        mask_all = torch.cat([text_mask, text_mask, text_mask[neg_txt]])
        images_all = torch.cat([image_embeds, image_embeds[neg_img], image_embeds])
        with recomputing():  # 3B items into the image rows: held as inputs only
            itm_hidden = self.qformer(input_ids=ids_all, query_embeds=self._queries(3 * bs),
                                      attention_mask=_ones_mask(mask_all, Q),
                                      image_embeds=images_all, generator=generator)
        loss_itm = _itm_loss(self.itm_head(itm_hidden[:, :Q]).mean(dim=1), bs)

        # LM: caption the image through the decoder mask
        decoder_ids = input_ids.clone()
        decoder_ids[:, 0] = bos_token_id
        dec_hidden = self.qformer(input_ids=decoder_ids, query_embeds=self._queries(bs),
                                  attention_mask=_ones_mask(text_mask, Q),
                                  image_embeds=image_embeds, is_decoder=True,
                                  generator=generator)
        lm_logits = self.lm_head(dec_hidden[:, Q:])
        labels = torch.where(decoder_ids == pad_token_id, -100, decoder_ids)[:, 1:]
        valid = labels != -100
        logp = torch.log_softmax(lm_logits[:, :-1].float(), dim=-1)
        nll = -logp.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
        per_tok = 0.9 * nll + 0.1 * -logp.mean(dim=-1)
        loss_lm = (per_tok * valid).sum() / valid.sum().clamp_min(1)
        return {"loss_itc": loss_itc, "loss_itm": loss_itm, "loss_lm": loss_lm}

    def forward_cached(self, tower: Tensor, input_ids: Tensor, text_mask: Tensor, **kw):
        """The training forward from :meth:`encode_tower` rows."""
        return self.losses_from_embeds(self.embed_cached(tower), input_ids, text_mask, **kw)

    # the feature-extractor surface (reference extract_features)
    def extract_image_features(self, images: Tensor) -> Tuple[Tensor, Tensor]:
        """-> (normalised query features [B, Q, E], query hidden [B, Q, H])."""
        hidden = self.embed_image_queries(self.encode_image(images))
        return l2_normalize(self.vision_proj(hidden)), hidden

    def extract_text_features(self, input_ids: Tensor, text_mask: Tensor) -> Tuple[Tensor, Tensor]:
        """-> (normalised CLS feature [B, E], text hidden [B, L, H])."""
        hidden = self.qformer(input_ids=input_ids, attention_mask=text_mask)
        return l2_normalize(self.text_proj(hidden[:, 0])), hidden


@registry.register_model("blip2_image_text_matching")
class Blip2ITM(Blip2Stage1):
    """Image-text matching (reference blip2_image_text_matching.py): ``itm``
    the positive class's mean logit through the joint pass, ``itc`` the
    token-max cosine similarity of each image with its caption."""

    def itm(self, images: Tensor, input_ids: Tensor, text_mask: Tensor) -> Tensor:
        return self.compute_itm(self.encode_image(images), input_ids, text_mask)

    def itc(self, images: Tensor, input_ids: Tensor, text_mask: Tensor) -> Tensor:
        feats, _ = self.extract_image_features(images)
        tfeat, _ = self.extract_text_features(input_ids, text_mask)
        return torch.einsum("bqe,be->bq", feats.float(), tfeat.float()).amax(dim=-1)
