"""The SPRC flagship model (counterpart of ``sprc_tpu/models/cir_align_prompt.py``).

``Blip2QformerCirAlignPrompt``: the BLIP-2 CIR trunk plus the learned
``prompt_tokens`` of the sentence-level prompt. Its eval contract
(``extract_target_features``, ``fusion_feature``, ``inference``) is the
trunk's. Its training forward gives the three SPRC losses (reference
...cir_align_prompt.py:95-200):

- ``loss_itc``: the fusion feature against the target tokens' max-sim over
  the temperature, in-batch cross-entropy;
- ``loss_rtc``: ``prompt_tokens`` spliced into a no-image text pass, its CLS
  feature against the same targets (:171-191);
- ``loss_align``: MSE between the mean fused query and the mean of the
  detached prompt tokens (:193-194).

The live forward and ``forward_cached`` are the trunk's; both end here in
``losses_from_embeds``. Both max-sims go through kernel K1 with a gradient
(:class:`sprc_tpu_torch.ops.sim_kernels.TokenMaxSim`). The trainer weighs
them 1 / 0.4 / 0.4 (``sprc_tpu_torch/train/loop.py``). Under ``--mesh`` the
rank's rows score against the global batch's target feats, gathered with
their gradient (LAVIS' ``GatherLayer``, the JAX package's SPMD matrix).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from sprc_tpu_torch.models.cir_base import Blip2CirBase, CirConfig, cross_entropy_diagonal
from sprc_tpu_torch.ops.layers import l2_normalize
from sprc_tpu_torch.parallel.mesh import gather_batch
from sprc_tpu_torch.registry import registry

Tensor = torch.Tensor


@registry.register_model("blip2_cir_align_prompt")
class CirAlignPrompt(Blip2CirBase):
    """SPRC: two-pass query/text fusion + sentence-prompt alignment."""

    def __init__(self, cfg: CirConfig):
        super().__init__(cfg)
        self.prompt_tokens = nn.Parameter(
            torch.empty(1, cfg.num_query_token, cfg.qformer_config().hidden_size))

    LOSSES = ("loss_itc", "loss_rtc", "loss_align")

    def losses_from_embeds(self, ref_embeds: Tensor, tgt_embeds: Tensor, input_ids: Tensor,
                           text_mask: Tensor, *,
                           generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """The three losses from post-ln_vision image embeddings."""
        fused_queries, fusion_feats = self.fuse_reference(ref_embeds, input_ids, text_mask,
                                                          generator)
        # under --mesh the global batch's targets (parallel/mesh.py)
        target_feats = gather_batch(self.target_features(tgt_embeds, generator))
        loss_itc = cross_entropy_diagonal(self.token_max_sim(fusion_feats, target_feats)
                                          / self.temp)
        text_only = self._prompt_text_feature(input_ids, text_mask, generator)
        loss_rtc = cross_entropy_diagonal(self.token_max_sim(text_only, target_feats)
                                          / self.temp)
        prompt_mean = self.prompt_tokens.detach().float().mean(dim=1)
        loss_align = (fused_queries.float().mean(dim=1) - prompt_mean).square().mean()
        return {"loss_itc": loss_itc, "loss_rtc": loss_rtc, "loss_align": loss_align}

    def _prompt_text_feature(self, input_ids: Tensor, text_mask: Tensor,
                             generator: Optional[torch.Generator] = None) -> Tensor:
        """The relative-text feature: ``prompt_tokens`` and the text in a
        ``no_img`` pass, CLS through ``text_proj`` (:171-182)."""
        B, Q = input_ids.shape[0], self.cfg.num_query_token
        prompt = self.prompt_tokens.expand(B, -1, -1)
        attn_mask = torch.cat([text_mask.new_ones((B, Q)), text_mask], dim=1)
        hidden = self.qformer(input_ids=input_ids, query_embeds=prompt,
                              attention_mask=attn_mask, no_img=True, generator=generator)
        return l2_normalize(self.text_proj(hidden[:, 0]))
