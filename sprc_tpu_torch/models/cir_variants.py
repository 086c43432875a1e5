"""The eval side of two CIR variants (counterpart of the ``blip2_cir_rerank``
and ``blip2_cir_cat`` classes of ``sprc_tpu/models/cir_variants.py``).

- :class:`CirRerank` (``blip2_cir_rerank``, reference
  blip2_qformer_cir_rerank.py): a dedicated ITM reranker. A frozen twin of
  the Q-Former (``Fformer.bert``, ``query_tokens_f``, ``vision_proj_f``,
  ``text_proj_f``; the JAX package's ``fformer`` subtree) encodes the
  gallery and the text; the trainable Q-Former scores each (reference,
  candidate) pair over the concatenated memory ``[reference; candidate]`` of
  ``2 x S`` image rows (514 at 224 px), and ``inference_rerank`` returns the
  softmax of the mean ``itm_head`` logits, its positive class.
- :class:`CirCat` (``blip2_cir_cat``): ITC only. Its rerank is in feature
  space: the query is fused again against the reference, then scored
  against each candidate's projected target feats (the max over its Q
  tokens).

``RERANK_INPUT`` says which candidate representation ``inference_rerank``
takes: the index's frozen embeds (``"frozen"``) or its target feats
(``"feats"``); serving picks the candidate gather by it.

The retrieval engine scores stage 1 through ``fusion_feature``, which
``CirRerank`` does not override (as in the JAX engine,
``sprc_tpu/retrieval/engine.py:177``), while its gallery comes from the
twin; ``CirRerank.inference`` scores through the twin's text tower instead.
The training forwards of both (hard negatives drawn from JAX's PRNG for
``CirRerank``) are not ported.

Every Q-Former pass here runs kernel K3 (K4 with ``qformer_int8``) on the
card; the ``itm_head`` and the projections are plain products, as in the
JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
from torch import nn

from sprc_tpu_torch.models.cir_base import Blip2CirBase, CirConfig
from sprc_tpu_torch.models.qformer import QFormer
from sprc_tpu_torch.ops.layers import Linear, l2_normalize
from sprc_tpu_torch.registry import registry

Tensor = torch.Tensor


@registry.register_model("blip2_cir_rerank")
class CirRerank(Blip2CirBase):
    """Dedicated ITM reranker with a frozen Q-Former twin (...cir_rerank.py:85-260)."""

    RERANK_INPUT = "frozen"

    def __init__(self, cfg: CirConfig):
        super().__init__(cfg)
        qcfg = cfg.qformer_config()
        H = qcfg.hidden_size
        self.Fformer = nn.ModuleDict({"bert": QFormer(qcfg)})
        self.query_tokens_f = nn.Parameter(torch.empty(1, cfg.num_query_token, H))
        self.vision_proj_f = Linear(H, cfg.embed_dim, dtype=qcfg.dtype)
        self.text_proj_f = Linear(H, cfg.embed_dim, dtype=qcfg.dtype)

    @property
    def fformer(self) -> QFormer:
        return self.Fformer["bert"]

    @staticmethod
    def sync_fformer(state: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """A state dict with the twin refreshed from the trainable tower
        (reference ``_update_f_former``, ...cir_rerank.py:122-136; the JAX
        ``CirRerank.sync_fformer`` on a parameter tree): ``Qformer.bert.*``
        into ``Fformer.bert.*``, ``query_tokens`` into ``query_tokens_f``,
        and ``vision_proj`` / ``text_proj`` into their twins where present."""
        new = dict(state)
        src = "Qformer.bert."
        for key, value in state.items():
            if key.startswith(src):
                new["Fformer.bert." + key[len(src):]] = value.clone()
        new["query_tokens_f"] = state["query_tokens"].clone()
        for name in ("vision_proj", "text_proj"):
            for part in ("weight", "bias"):
                if f"{name}.{part}" in state:
                    new[f"{name}_f.{part}"] = state[f"{name}.{part}"].clone()
        return new

    def extract_target_features(self, images: Tensor) -> Tuple[Tensor, Tensor]:
        """Gallery encode through the twin: (feats [B, Q, E], frozen [B, S, D])."""
        frozen = self.encode_image(images)
        queries = self.query_tokens_f.expand(frozen.shape[0], -1, -1)
        hidden = self.fformer(query_embeds=queries, image_embeds=frozen)
        return l2_normalize(self.vision_proj_f(hidden)), frozen

    def inference(self, reference_embeds: Tensor, target_feats: Tensor, input_ids: Tensor,
                  text_mask: Tensor) -> Tensor:
        """Stage-1 scores through the twin's text tower (:360-397): [B, N]."""
        hidden = self.fformer(input_ids=input_ids, attention_mask=text_mask)
        return self.token_max_sim(l2_normalize(self.text_proj_f(hidden[:, 0])), target_feats)

    def inference_rerank(self, reference_embeds: Tensor, target_embeds: Tensor,
                         input_ids: Tensor, text_mask: Tensor) -> Tensor:
        """ITM over the memory ``[reference; candidate]`` (:399-445).
        reference_embeds / target_embeds [N, S, D] (queries already repeated
        per candidate) -> [N] softmax-positive scores."""
        N, Q = reference_embeds.shape[0], self.cfg.num_query_token
        attn_mask = torch.cat([text_mask.new_ones((N, Q)), text_mask], dim=1)
        memory = torch.cat([reference_embeds, target_embeds], dim=1)
        hidden = self.qformer(input_ids=input_ids, query_embeds=self._queries(N),
                              attention_mask=attn_mask, image_embeds=memory)
        del memory
        logits = self.itm_head(hidden[:, :Q]).mean(dim=1)
        return torch.softmax(logits.float(), dim=-1)[:, -1]


@registry.register_model("blip2_cir_cat")
class CirCat(Blip2CirBase):
    """Two-pass fusion, ITC only (blip2_qformer_cir_cat.py); its rerank is
    in feature space."""

    RERANK_INPUT = "feats"

    def extract_target_features(self, images: Tensor, *, target_only: bool = False,
                                ref_only: bool = False
                                ) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        """(...cir_cat.py:401-427): the frozen embeds only, the feats only, or both."""
        frozen = self.encode_image(images)
        if ref_only:
            return frozen
        feats = self.target_features(frozen)
        if target_only:
            return feats
        return feats, frozen

    def inference_rerank(self, reference_embeds: Tensor, target_feats: Tensor,
                         input_ids: Tensor, text_mask: Tensor) -> Tensor:
        """Feature-space rerank (...cir_cat.py:337-396): each query fused
        again against its (repeated) reference [B K, S, D], then its feature
        against the candidate's target feats [B K, Q, E], max over Q -> [B K]."""
        fusion = self.fusion_feature(reference_embeds, input_ids, text_mask)
        sims = torch.einsum("bqe,be->bq", target_feats.float(), fusion.float())
        return sims.max(dim=-1).values
