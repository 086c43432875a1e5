"""Shared trunk of the BLIP-2 CIR models (counterpart of ``sprc_tpu/models/cir_base.py``).

ViT -> fp32 ``ln_vision`` -> Q-Former (learned queries,
cross-attention every second layer) -> 256-d vision / text projections, an
ITM head and a learned temperature (reference
blip2_qformer_cir_align_prompt.py:44-92). This module carries the encode and
scoring surface that serving runs (with ``compute_itm``, the ITM score), and
the training entry points every model shares: :meth:`Blip2CirBase.forward`
from pixels and :meth:`Blip2CirBase.forward_cached` from the tower's rows,
both handing post-``ln_vision`` embeds to the class's ``losses_from_embeds``
(:mod:`.cir_align_prompt`, :mod:`.cir_variants`).

Attribute names are the reference torch module's (``visual_encoder``,
``ln_vision``, ``Qformer.bert``, ``query_tokens``, ``vision_proj``,
``text_proj``, ``itm_head``, ``temp``), so a reference-layout state dict
loads with ``strict=True``. Images enter NHWC.

Training (the losses live in the flagship subclass): with
``freeze_vit`` (the default, the recipe's) the ViT is frozen
(``requires_grad`` off, kept in eval mode by :meth:`train`, LAVIS's
``disabled_train``) and runs under ``torch.no_grad()``, so its blocks
launch kernel K2 on every live step; ``ln_vision`` and everything after it
train. With ``freeze_vit=False`` (BLIP-2 stage 1's ``coco`` fine-tune) the
tower trains too: it takes training mode, runs with a graph and gets its
gradient through the kernels' autograd Functions (``models/vit.py``), as
the JAX model, which stops the gradient only under ``freeze_vit``. A class
whose ``FROZEN_PREFIXES`` name ``visual_encoder`` (the BLIP-2 stage-2 heads)
keeps its tower frozen whatever ``freeze_vit`` says, as the JAX optimizer's
partition does: no tower tensor takes a gradient or an update, and the
tower runs without a graph, so K2 launches as in serving.
:meth:`encode_tower` is the boundary the feature cache stores
(``sprc_tpu_torch/train/feature_cache.py``); ``forward_cached`` trains
every model from it (the JAX base's generic ``forward_cached``).

Under ``--mesh`` (``parallel/mesh.py``) each rank runs its rows of the
global batch; every in-batch term sees the global batch: the models gather
the target side (``gather_batch``, with its gradient) and
:func:`cross_entropy_diagonal` shifts its labels by the rank's offset, so a
step over W ranks is JAX's step over the batch sharded on its ``data`` axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sprc_tpu_torch.models.qformer import QFormer, QFormerConfig
from sprc_tpu_torch.models.vit import (ViTConfig, build_tower, clip_vit_l_config,
                                       eva_vit_g_config)
from sprc_tpu_torch.ops import primitives
from sprc_tpu_torch.ops.layers import LayerNormFP32, Linear, l2_normalize
from sprc_tpu_torch.ops.sim_kernels import TokenMaxSim
from sprc_tpu_torch.parallel.mesh import batch_offset

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CirConfig:
    """Configuration of the BLIP-2 CIR models (the blip2_pretrain.yaml knobs)."""

    vit_model: str = "eva_clip_g"  # or "clip_L"
    image_size: int = 224
    num_query_token: int = 32
    cross_attention_freq: int = 2
    embed_dim: int = 256
    max_txt_len: int = 32
    freeze_vit: bool = True  # False: the tower trains (BLIP-2 stage 1's coco rows)
    vocab_size: int = 30523
    vit_dtype: torch.dtype = torch.bfloat16
    qformer_dtype: torch.dtype = torch.float32
    # int8 serving: the tower's mode (ViTConfig.quant) with its calibrated
    # activation scales, and the Q-Former's int8 dense projections
    vit_quant: Optional[str] = None
    vit_act_scales: Optional[Tuple[Tuple[str, float], ...]] = None
    qformer_int8: bool = False
    # the tower's route (ViTConfig.fused_block / fused_mlp; None = the tower
    # config's own, whose defaults are the whole-block kernel, MLP kernel off)
    vit_fused_block: Optional[str] = None
    vit_fused_mlp: Optional[bool] = None
    # keep only each tower block's / Q-Former layer's input for the backward
    # (ViTConfig.remat / QFormerConfig.remat; the finetune CLI's --remat, the
    # YAML's use_grad_checkpoint for the tower)
    vit_remat: bool = False
    qformer_remat: bool = False
    # test-size overrides (None = full size)
    vit_config_override: Optional[ViTConfig] = None
    qformer_config_override: Optional[QFormerConfig] = None

    def __post_init__(self):
        if not self.freeze_vit and self.vit_quant:
            raise ValueError(f"freeze_vit=False with vit_quant={self.vit_quant!r}: the int8 "
                             "modes serve only; train the bf16/fp32 tower")

    def vit_config(self) -> ViTConfig:
        if self.vit_config_override is not None:
            cfg = self.vit_config_override
        elif self.vit_model == "eva_clip_g":
            cfg = eva_vit_g_config(self.image_size, dtype=self.vit_dtype)
        elif self.vit_model == "clip_L":
            cfg = clip_vit_l_config(self.image_size, dtype=self.vit_dtype)
        else:
            raise ValueError(f"unknown vit_model {self.vit_model!r}")
        route = {k: v for k, v in (("fused_block", self.vit_fused_block),
                                   ("fused_mlp", self.vit_fused_mlp)) if v is not None}
        if self.vit_quant:
            route.update(quant=self.vit_quant, act_scales=self.vit_act_scales)
        if self.vit_remat:
            route.update(remat=True)
        return dataclasses.replace(cfg, **route) if route else cfg

    def qformer_config(self) -> QFormerConfig:
        if self.qformer_config_override is not None:
            cfg = self.qformer_config_override
        else:
            cfg = QFormerConfig(
                vocab_size=self.vocab_size, encoder_width=self.vit_config().width,
                cross_attention_freq=self.cross_attention_freq,
                query_length=self.num_query_token, dtype=self.qformer_dtype,
            )
        extra = {k: True for k, on in (("int8", self.qformer_int8),
                                       ("remat", self.qformer_remat)) if on}
        return dataclasses.replace(cfg, **extra) if extra else cfg


class Blip2CirBase(nn.Module):
    """ViT (frozen unless ``freeze_vit=False``) + ln_vision + Q-Former +
    projection heads."""

    # False (the LLM heads, models/blip2_opt.py, blip2_t5.py, instruct_cir.py):
    # no vision / text projections and no ITM head; the JAX init of those
    # heads holds none of them
    RETRIEVAL_HEADS = True
    # False (the caption heads): a Q-Former without its text side, which
    # their queries-only pass never reaches
    QFORMER_TEXT = True
    # the parameter-name prefixes that neither take a gradient nor an update
    # (the JAX model's FROZEN_PREFIXES, in the port's module names); a class
    # that sets them calls :meth:`freeze_prefixes` once its modules exist
    FROZEN_PREFIXES: Tuple[str, ...] = ()

    def __init__(self, cfg: CirConfig):
        super().__init__()
        self.cfg = cfg
        vcfg, qcfg = cfg.vit_config(), cfg.qformer_config()
        H = qcfg.hidden_size
        # EvaViT or ClipViT, by the checkpoint layout the tower's config describes
        self.visual_encoder = build_tower(vcfg)
        # fp32 LayerNorm bridging the (b)f16 tower into the Q-Former (eps 1e-5)
        self.ln_vision = LayerNormFP32(vcfg.width, 1e-5)
        if cfg.freeze_vit:  # the reference's freeze_vit=True
            self.visual_encoder.requires_grad_(False)
        self.Qformer = nn.ModuleDict({"bert": QFormer(qcfg, text=self.QFORMER_TEXT)})
        self.query_tokens = nn.Parameter(torch.empty(1, cfg.num_query_token, H))
        if self.RETRIEVAL_HEADS:
            self.vision_proj = Linear(H, cfg.embed_dim, dtype=qcfg.dtype)
            self.text_proj = Linear(H, cfg.embed_dim, dtype=qcfg.dtype)
            self.itm_head = Linear(H, 2, dtype=qcfg.dtype)
        # learned temperature, a direct divisor (init 0.07)
        self.temp = nn.Parameter(torch.empty(()))

    @property
    def qformer(self) -> QFormer:
        return self.Qformer["bert"]

    def freeze_prefixes(self) -> None:
        """``requires_grad`` off for every parameter under
        :attr:`FROZEN_PREFIXES`."""
        for name, p in self.named_parameters():
            if name.startswith(self.FROZEN_PREFIXES):
                p.requires_grad_(False)

    @property
    def tower_frozen(self) -> bool:
        """The tower takes no gradient: ``freeze_vit``, or the class's
        ``FROZEN_PREFIXES`` hold it."""
        return self.cfg.freeze_vit or "visual_encoder" in self.FROZEN_PREFIXES

    def train(self, mode: bool = True) -> "Blip2CirBase":
        """Training mode for everything but a frozen tower, which stays in
        eval mode (LAVIS ``disabled_train``). A trainable tower takes
        training mode, as in LAVIS; it has no dropout, so no value changes."""
        super().train(mode)
        if self.tower_frozen:
            self.visual_encoder.eval()
        return self

    def tower_grad(self):
        """The context the tower runs in: ``no_grad`` for a frozen tower,
        none for a trainable one."""
        return torch.no_grad() if self.tower_frozen else contextlib.nullcontext()

    # ---------------------------------------------------------------- towers

    def encode_tower(self, images: Tensor) -> Tensor:
        """Raw tower features [B, S, D] (pre-ln_vision, tower dtype)."""
        return self.visual_encoder(images)

    def encode_image(self, images: Tensor) -> Tensor:
        """images [B, H, W, 3] -> image embeddings [B, S, D] fp32 (ln_vision
        of the tower features); the tower without a graph where it is frozen.
        A rank-3 input is :meth:`encode_tower` rows (a cache's), which only
        ``ln_vision`` takes (the JAX base's rank dispatch)."""
        if images.ndim == 3:
            return self.embed_cached(images)
        with self.tower_grad():
            tower = self.encode_tower(images)
        return self.ln_vision(tower.float())

    def embed_cached(self, tower_feats: Tensor) -> Tensor:
        """Cached or live tower features -> fp32 ln_vision embeddings; with
        ``freeze_vit`` no gradient flows into the tower (JAX's
        ``stop_gradient``)."""
        if self.tower_frozen:
            tower_feats = tower_feats.detach()
        return self.ln_vision(tower_feats.float())

    def encode_image_pair(self, reference: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
        """A training step's two image batches in one tower call of 2B
        images (every op of the tower is per image), without a graph unless
        the tower trains."""
        B = reference.shape[0]
        with self.tower_grad():
            tower = self.encode_tower(torch.cat([reference, target]))
        return self.embed_cached(tower[:B]), self.embed_cached(tower[B:])

    # ---------------------------------------------------------------- training

    # the losses the training forward returns (empty: it returns tensors, and
    # the fine-tune CLI refuses the model)
    LOSSES: Tuple[str, ...] = ()

    def forward(self, reference_images: Tensor, target_images: Tensor, input_ids: Tensor,
                text_mask: Tensor, **kw):
        """The live training forward: images [B, H, W, 3] through the tower
        (one call of 2B images, :meth:`encode_image_pair`), then
        ``losses_from_embeds``.
        ``kw``: ``generator`` (dropout), and for the hard-negative models
        ``sample_generator``."""
        ref_embeds, tgt_embeds = self.encode_image_pair(reference_images, target_images)
        return self.losses_from_embeds(ref_embeds, tgt_embeds, input_ids, text_mask, **kw)

    def forward_cached(self, reference_tower: Tensor, target_tower: Tensor, input_ids: Tensor,
                       text_mask: Tensor, **kw):
        """The training forward from :meth:`encode_tower` outputs (the feature
        cache's rows): the live forward without the tower
        (``sprc_tpu/models/cir_base.py:170-191``)."""
        return self.losses_from_embeds(self.embed_cached(reference_tower),
                                       self.embed_cached(target_tower), input_ids, text_mask,
                                       **kw)

    def losses_from_embeds(self, ref_embeds: Tensor, tgt_embeds: Tensor, input_ids: Tensor,
                           text_mask: Tensor, **kw):
        raise NotImplementedError(f"{type(self).__name__} has no training forward")

    # ------------------------------------------------------------ Q-Former passes

    def _queries(self, batch: int) -> Tensor:
        return self.query_tokens.expand(batch, -1, -1)

    def embed_image_queries(self, image_embeds: Tensor,
                            generator: Optional[torch.Generator] = None) -> Tensor:
        """Queries-only Q-Former pass over image embeds -> [B, Q, hidden]."""
        return self.qformer(query_embeds=self._queries(image_embeds.shape[0]),
                            image_embeds=image_embeds, generator=generator)

    def target_features(self, image_embeds: Tensor,
                        generator: Optional[torch.Generator] = None) -> Tensor:
        """L2-normalized per-query target features [B, Q, embed_dim]."""
        return l2_normalize(self.vision_proj(self.embed_image_queries(image_embeds, generator)))

    def fuse_reference(self, image_embeds: Tensor, input_ids: Tensor, text_mask: Tensor,
                       generator: Optional[torch.Generator] = None) -> Tuple[Tensor, Tensor]:
        """The SPRC two-pass fusion (...cir_align_prompt.py:119-139): queries +
        text cross-attend into the reference image; the fused queries are
        re-fed with the text and no image; the hidden at the first text
        position (index Q) projects to the composed-query feature.
        Returns ``(fused_queries [B, Q, hidden], fusion_feats [B, E])``."""
        B = image_embeds.shape[0]
        Q = self.cfg.num_query_token
        attn_mask = torch.cat(
            [torch.ones((B, Q), dtype=text_mask.dtype, device=text_mask.device), text_mask],
            dim=1)
        fusion_hidden = self.qformer(input_ids=input_ids, query_embeds=self._queries(B),
                                     attention_mask=attn_mask, image_embeds=image_embeds,
                                     generator=generator)
        fused_queries = fusion_hidden[:, :Q]
        text_hidden = self.qformer(input_ids=input_ids, query_embeds=fused_queries,
                                   attention_mask=attn_mask, generator=generator)
        fusion_feats = l2_normalize(self.text_proj(text_hidden[:, Q]))
        return fused_queries, fusion_feats

    def encode_text_cls(self, input_ids: Tensor, text_mask: Tensor,
                        generator: Optional[torch.Generator] = None) -> Tensor:
        """The plain text pass (no queries, no image): the normalised CLS
        feature through ``text_proj`` [B, E] (``cir_base.py:278-285``)."""
        hidden = self.qformer(input_ids=input_ids, attention_mask=text_mask, generator=generator)
        return l2_normalize(self.text_proj(hidden[:, 0]))

    # ----------------------------------------------------- default eval contract

    def extract_target_features(self, images: Tensor) -> Tuple[Tensor, Tensor]:
        """Gallery encode: [B, H, W, 3] -> (proj feats [B, Q, E], frozen [B, S, D])."""
        frozen = self.encode_image(images)
        return self.target_features(frozen), frozen

    def fusion_feature(self, reference_embeds: Tensor, input_ids: Tensor,
                       text_mask: Tensor) -> Tensor:
        """The composed-query feature [B, E]."""
        return self.fuse_reference(reference_embeds, input_ids, text_mask)[1]

    def inference(self, reference_embeds: Tensor, target_feats: Tensor, input_ids: Tensor,
                  text_mask: Tensor) -> Tensor:
        """Composed-query scoring -> [B, N] raw max-sims."""
        return self.token_max_sim(self.fusion_feature(reference_embeds, input_ids, text_mask),
                                  target_feats)

    def compute_itm(self, image_embeds: Tensor, input_ids: Tensor, text_mask: Tensor) -> Tensor:
        """ITM score [B]: queries and text cross-attend the image, the
        ``itm_head`` logits are averaged over the query positions, and the
        positive class's mean logit is returned (...cir_align_prompt.py:
        289-309). The rerank's reduction differs: a softmax of the mean
        logits (:meth:`CirRerank.inference_rerank`)."""
        B, Q = input_ids.shape[0], self.cfg.num_query_token
        attn_mask = torch.cat([text_mask.new_ones((B, Q)), text_mask], dim=1)
        hidden = self.qformer(input_ids=input_ids, query_embeds=self._queries(B),
                              attention_mask=attn_mask, image_embeds=image_embeds)
        return self.itm_head(hidden[:, :Q])[:, :, 1].mean(dim=1)

    @staticmethod
    def token_max_sim(feats: Tensor, target_feats: Tensor) -> Tensor:
        """max over target query tokens of <feat, token>: [B, E] x [N, Q, E] ->
        [B, N]; with a gradient (grad on, an input that requires it) through
        :class:`TokenMaxSim`, the same kernel forward."""
        return primitives.dispatch(TokenMaxSim, feats.float().contiguous(),
                                   target_feats.float().contiguous())


def cross_entropy_diagonal(logits: Tensor) -> Tensor:
    """Mean cross-entropy with the diagonal as labels (in-batch contrastive).
    Under an active mesh the logits are this rank's rows against the global
    batch ([b, W b]) and the labels start at the rank's offset."""
    b = logits.shape[0]
    labels = torch.arange(b, device=logits.device) + batch_offset(b)
    return F.cross_entropy(logits.float(), labels)
