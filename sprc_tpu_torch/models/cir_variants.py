"""The CIR variant zoo: the paper's ablation models (counterpart of
``sprc_tpu/models/cir_variants.py``; reference
src/lavis/models/blip2_models/blip2_qformer_cir_*.py).

Every variant shares the :class:`Blip2CirBase` trunk, its eval contract and
its training entry points (``forward`` from pixels, ``forward_cached`` from
the feature cache's tower rows); each class adds its ``losses_from_embeds``:

==========================  =====================================================
registry name               losses / mechanism (reference file)
==========================  =====================================================
blip2_cir_cat               itc only (blip2_qformer_cir_cat.py:95-167)
blip2_cir_rel               itc + rtc via the plain text pass (...cir_rel.py:169-187)
blip2_cir_z_learn_pos_align itc + rtc + align against the prompt pass's OUTPUTS
                            at positions 1..Q (...cir_z_learn_pos_align.py:191-199)
blip2_cir_neg               itc + hard-negative ITM with the fused queries
                            prepended (...cir_neg.py:168-246)
blip2_cir_neg_rel           neg + the relative-token chain rtc (...cir_neg_rel.py:250-286)
blip2_cir_full              align_prompt's three losses + the neg ITM (...cir_full.py)
blip2_cir_rerank            a dedicated ITM reranker with a frozen Q-Former twin
                            (...cir_rerank.py:85-260)
blip2_cir_cls               itc + 5-way prompt-to-prompt classification with a
                            second temperature (...cir_cls.py:85-231)
blip2_cir_slt               top-k query tokens by the CLS row's self-attention
                            (...cir_slt.py:110-174); forward returns sim_i2t
blip2_cir_prompt            forward returns the fused queries (blip2_qformer_prompt.py)
==========================  =====================================================

``LOSSES`` names what a training forward returns; ``blip2_cir_slt`` and
``blip2_cir_prompt`` return tensors and train through no CLI (the JAX step
fails on them at ``losses.items()``; the port's fine-tune CLI refuses them).

Hard negatives (:class:`_HardNegMixin`) are the argmax of the off-diagonal
similarities, and ``blip2_cir_cls``'s negative captions the stable argsort,
unless the caller passes a ``sample_generator`` (the JAX package's ``sample``
rng, which its train step never passes): then they are drawn as the
reference draws them, ``torch.multinomial`` over the softmax. The dropout
``generator`` never draws them.

Passes the JAX package runs ``deterministic`` under ``stop_gradient`` (the
rerank twin's two passes and its scores, ``blip2_cir_cls``'s text feature and
its candidate pass) run here under ``torch.no_grad()``: without a graph the
Q-Former takes its serving branch, so on the card they launch kernel K3 (and
K1 for the twin's scores) inside a training step, with no dropout, as in JAX.
Every pass with a gradient runs the Q-Former's unfused training branch and
K1 through :class:`~sprc_tpu_torch.ops.sim_kernels.TokenMaxSim`.

Under ``--mesh`` every term that mixes samples sees the global batch
(``parallel/mesh.py``): the in-batch scores are this rank's rows against the
gathered targets, the hard negatives and ``blip2_cir_cls``'s captions are
picked over the global matrix, and a pick's rows and ids come from the rank
that holds them (with their gradient where the single-device step has one).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from sprc_tpu_torch.models.cir_base import Blip2CirBase, CirConfig, cross_entropy_diagonal
from sprc_tpu_torch.models.qformer import QFormer
from sprc_tpu_torch.ops.layers import Linear, l2_normalize, recomputing
from sprc_tpu_torch.parallel.mesh import batch_offset, gather_batch
from sprc_tpu_torch.registry import registry

Tensor = torch.Tensor
Generator = Optional[torch.Generator]

NEG_DIAG = -10000.0


def _cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    return F.cross_entropy(logits.float(), labels)


def _masked_diag(sim: Tensor) -> Tensor:
    """``sim + eye * NEG_DIAG`` (the reference's ``fill_diagonal_(-10000)``,
    as the JAX package adds it), detached, fp32. Under ``--mesh`` ``sim`` is
    this rank's rows [b, W b] and its diagonal starts at the rank's offset."""
    sim = sim.detach().float()
    b = sim.shape[0]
    rows = torch.arange(b, device=sim.device)
    eye = torch.zeros_like(sim)
    eye[rows, rows + batch_offset(b)] = 1.0
    return sim + eye * NEG_DIAG


def _stable_top(x: Tensor, k: int) -> Tensor:
    """Indices of the k largest along the last axis, ties to the lower index
    (``jnp.argsort(-x)`` is stable, ``jax.lax.top_k`` prefers the lower
    index): a stable ascending sort of ``-x``."""
    return torch.sort(-x, dim=-1, stable=True).indices[..., :k]


def _itm_loss(logits: Tensor, bs: int) -> Tensor:
    """The ITM cross-entropy over [3B, 2] logits: B positives, then 2B negatives."""
    labels = (torch.arange(3 * bs, device=logits.device) < bs).long()
    return _cross_entropy(logits, labels)


def _ones_mask(mask: Tensor, n: int) -> Tensor:
    return torch.cat([mask.new_ones((mask.shape[0], n)), mask], dim=1)


class _HardNegMixin:
    """In-batch hard-negative selection (...cir_neg.py:172-198)."""

    def _neg_indices(self, sim_i2t: Tensor,
                     sample_generator: Generator = None) -> Tuple[Tensor, Tensor]:
        """(neg_target [B], neg_ref [B]): per row, the hardest other target;
        per column, the hardest other reference. Under ``--mesh`` both run
        over the global matrix (this rank's rows, then its columns: the
        gathered rows' transpose) and index the global batch."""
        sim = _masked_diag(sim_i2t)
        b, off = sim.shape[0], batch_offset(sim.shape[0])
        cols = gather_batch(sim, grad=False).t()[off: off + b]
        if sample_generator is None:
            return sim.argmax(dim=1), cols.argmax(dim=1)
        draw = lambda s: torch.multinomial(torch.softmax(s, dim=1), 1,  # noqa: E731
                                           generator=sample_generator)[:, 0]
        return draw(sim), draw(cols)


class _FusionItcBase(Blip2CirBase):
    """Shared prologue: fusion feats, target feats, in-batch ITC."""

    def _itc(self, ref_embeds: Tensor, tgt_embeds: Tensor, input_ids: Tensor, text_mask: Tensor,
             generator: Generator) -> dict:
        fused_queries, fusion_feats = self.fuse_reference(ref_embeds, input_ids, text_mask,
                                                          generator)
        # under --mesh the global batch's targets, with their gradient
        target_feats = gather_batch(self.target_features(tgt_embeds, generator))
        sim_i2t = self.token_max_sim(fusion_feats, target_feats) / self.temp
        return dict(tgt_embeds=tgt_embeds, fused_queries=fused_queries,
                    target_feats=target_feats, sim_i2t=sim_i2t,
                    loss_itc=cross_entropy_diagonal(sim_i2t))

    def _itm_fused(self, ctx: dict, input_ids: Tensor, text_mask: Tensor, generator: Generator,
                   sample_generator: Generator) -> Tensor:
        """Hard-negative ITM with the fused queries prepended to the query
        tokens (...cir_neg.py:168-246 == ...cir_full.py:170-248): 2Q query
        rows cross-attend to the targets; the ITM head reads the first Q.
        The negatives' fused queries and target embeds are detached, the
        positives' are not. Under ``--mesh`` a picked negative comes from the
        rank that holds it (its rows gathered, as LAVIS' ``image_embeds_world``)."""
        bs, Q = input_ids.shape[0], self.cfg.num_query_token
        fused = ctx["fused_queries"]
        neg_target, neg_ref = self._neg_indices(ctx["sim_i2t"], sample_generator)
        ids_all = torch.cat([input_ids, input_ids, gather_batch(input_ids, False)[neg_ref]])
        mask_all = torch.cat([text_mask, text_mask, gather_batch(text_mask, False)[neg_ref]])
        query_fusion = torch.cat([fused, fused, gather_batch(fused.detach(), False)[neg_ref]])
        query_embeds = torch.cat([query_fusion, self._queries(3 * bs)], dim=1)  # [3B, 2Q, H]
        tgt = ctx["tgt_embeds"]
        targets_all = torch.cat([tgt, gather_batch(tgt.detach(), False)[neg_target], tgt])
        with recomputing():  # 3B items: held as inputs only (the peak at batch 128)
            hidden = self.qformer(input_ids=ids_all, query_embeds=query_embeds,
                                  attention_mask=_ones_mask(mask_all, 2 * Q),
                                  image_embeds=targets_all, generator=generator)
        return _itm_loss(self.itm_head(hidden[:, :Q]).mean(dim=1), bs)


@registry.register_model("blip2_cir_cat")
class CirCat(_FusionItcBase):
    """Two-pass fusion, ITC only (blip2_qformer_cir_cat.py); its rerank is
    in feature space: each query fused again against its (repeated)
    reference, scored against the candidate's projected target feats, the
    max over its Q tokens."""

    LOSSES = ("loss_itc",)
    RERANK_INPUT = "feats"

    def losses_from_embeds(self, ref_embeds: Tensor, tgt_embeds: Tensor, input_ids: Tensor,
                           text_mask: Tensor, *, generator: Generator = None) -> Dict[str, Tensor]:
        ctx = self._itc(ref_embeds, tgt_embeds, input_ids, text_mask, generator)
        return {"loss_itc": ctx["loss_itc"]}

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
        """Feature-space rerank (...cir_cat.py:337-396): reference_embeds
        [B K, S, D], target_feats [B K, Q, E] -> [B K]."""
        fusion = self.fusion_feature(reference_embeds, input_ids, text_mask)
        sims = torch.einsum("bqe,be->bq", target_feats.float(), fusion.float())
        return sims.max(dim=-1).values


@registry.register_model("blip2_cir_rel")
class CirRel(_FusionItcBase):
    """ITC + rtc through the plain text pass, no learned prompt tokens
    (blip2_qformer_cir_rel.py:169-187)."""

    LOSSES = ("loss_itc", "loss_rtc")

    def losses_from_embeds(self, ref_embeds: Tensor, tgt_embeds: Tensor, input_ids: Tensor,
                           text_mask: Tensor, *, generator: Generator = None) -> Dict[str, Tensor]:
        ctx = self._itc(ref_embeds, tgt_embeds, input_ids, text_mask, generator)
        text_feat = self.encode_text_cls(input_ids, text_mask, generator)
        sim_r2t = self.token_max_sim(text_feat, ctx["target_feats"]) / self.temp
        return {"loss_itc": ctx["loss_itc"], "loss_rtc": cross_entropy_diagonal(sim_r2t)}


class _PromptedBase(_FusionItcBase):
    """Variants with the learned prompt tokens (the align_prompt family)."""

    def __init__(self, cfg: CirConfig):
        super().__init__(cfg)
        self.prompt_tokens = nn.Parameter(
            torch.empty(1, cfg.num_query_token, cfg.qformer_config().hidden_size))

    def _prompt_pass(self, input_ids: Tensor, text_mask: Tensor,
                     generator: Generator) -> Tuple[Tensor, Tensor, Tensor]:
        """prompt_tokens + text, no image -> (hidden, normalised CLS feature,
        the prompt tokens broadcast to the batch)."""
        B, Q = input_ids.shape[0], self.cfg.num_query_token
        prompt = self.prompt_tokens.expand(B, -1, -1)
        hidden = self.qformer(input_ids=input_ids, query_embeds=prompt,
                              attention_mask=_ones_mask(text_mask, Q), no_img=True,
                              generator=generator)
        return hidden, l2_normalize(self.text_proj(hidden[:, 0])), prompt


@registry.register_model("blip2_cir_z_learn_pos_align")
class CirZLearnPosAlign(_PromptedBase):
    """align target = the prompt pass's outputs at positions 1..Q, detached
    (...cir_z_learn_pos_align.py:191-199)."""

    LOSSES = ("loss_itc", "loss_rtc", "loss_align")

    def losses_from_embeds(self, ref_embeds: Tensor, tgt_embeds: Tensor, input_ids: Tensor,
                           text_mask: Tensor, *, generator: Generator = None) -> Dict[str, Tensor]:
        Q = self.cfg.num_query_token
        ctx = self._itc(ref_embeds, tgt_embeds, input_ids, text_mask, generator)
        hidden, feat, _ = self._prompt_pass(input_ids, text_mask, generator)
        sim_r2t = self.token_max_sim(feat, ctx["target_feats"]) / self.temp
        align_to = hidden[:, 1:Q + 1].detach().float().mean(dim=1)
        loss_align = (ctx["fused_queries"].float().mean(dim=1) - align_to).square().mean()
        return {"loss_itc": ctx["loss_itc"], "loss_rtc": cross_entropy_diagonal(sim_r2t),
                "loss_align": loss_align}


@registry.register_model("blip2_cir_neg")
class CirNeg(_FusionItcBase, _HardNegMixin):
    """ITC + the fused-query hard-negative ITM (blip2_qformer_cir_neg.py)."""

    LOSSES = ("loss_itc", "loss_itm")

    def losses_from_embeds(self, ref_embeds: Tensor, tgt_embeds: Tensor, input_ids: Tensor,
                           text_mask: Tensor, *, generator: Generator = None,
                           sample_generator: Generator = None) -> Dict[str, Tensor]:
        ctx = self._itc(ref_embeds, tgt_embeds, input_ids, text_mask, generator)
        loss_itm = self._itm_fused(ctx, input_ids, text_mask, generator, sample_generator)
        return {"loss_itc": ctx["loss_itc"], "loss_itm": loss_itm}


@registry.register_model("blip2_cir_neg_rel")
class CirNegRel(_FusionItcBase, _HardNegMixin):
    """neg + the relative-token chain rtc (blip2_qformer_cir_neg_rel.py:
    250-286): the learned ``rel_tokens`` pass through the reference image,
    their outputs through the target image, scored against the plain text
    feature."""

    LOSSES = ("loss_itc", "loss_itm", "loss_rtc")

    def __init__(self, cfg: CirConfig):
        super().__init__(cfg)
        self.rel_tokens = nn.Parameter(
            torch.empty(1, cfg.num_query_token, cfg.qformer_config().hidden_size))

    def losses_from_embeds(self, ref_embeds: Tensor, tgt_embeds: Tensor, input_ids: Tensor,
                           text_mask: Tensor, *, generator: Generator = None,
                           sample_generator: Generator = None) -> Dict[str, Tensor]:
        ctx = self._itc(ref_embeds, tgt_embeds, input_ids, text_mask, generator)
        loss_itm = self._itm_fused(ctx, input_ids, text_mask, generator, sample_generator)
        rel = self.rel_tokens.expand(input_ids.shape[0], -1, -1)
        img_hidden = self.qformer(query_embeds=rel, image_embeds=ref_embeds, generator=generator)
        rel_hidden = self.qformer(query_embeds=img_hidden, image_embeds=tgt_embeds,
                                  generator=generator)
        rel_feats = l2_normalize(self.vision_proj(rel_hidden))
        text_feat = self.encode_text_cls(input_ids, text_mask, generator)
        sim_r2t = self.token_max_sim(text_feat, gather_batch(rel_feats)) / self.temp
        return {"loss_itc": ctx["loss_itc"], "loss_itm": loss_itm,
                "loss_rtc": cross_entropy_diagonal(sim_r2t)}


@registry.register_model("blip2_cir_full")
class CirFull(_PromptedBase, _HardNegMixin):
    """align_prompt + the fused-query hard-negative ITM
    (blip2_qformer_cir_full.py:95-278)."""

    LOSSES = ("loss_itc", "loss_rtc", "loss_itm", "loss_align")

    def losses_from_embeds(self, ref_embeds: Tensor, tgt_embeds: Tensor, input_ids: Tensor,
                           text_mask: Tensor, *, generator: Generator = None,
                           sample_generator: Generator = None) -> Dict[str, Tensor]:
        ctx = self._itc(ref_embeds, tgt_embeds, input_ids, text_mask, generator)
        loss_itm = self._itm_fused(ctx, input_ids, text_mask, generator, sample_generator)
        _, feat, prompt = self._prompt_pass(input_ids, text_mask, generator)
        sim_r2t = self.token_max_sim(feat, ctx["target_feats"]) / self.temp
        prompt_mean = prompt.detach().float().mean(dim=1)
        loss_align = (ctx["fused_queries"].float().mean(dim=1) - prompt_mean).square().mean()
        return {"loss_itc": ctx["loss_itc"], "loss_rtc": cross_entropy_diagonal(sim_r2t),
                "loss_itm": loss_itm, "loss_align": loss_align}


@registry.register_model("blip2_cir_rerank")
class CirRerank(Blip2CirBase, _HardNegMixin):
    """Dedicated ITM reranker with a frozen Q-Former twin (...cir_rerank.py:
    85-260).

    The twin (``Fformer.bert``, ``query_tokens_f``, ``vision_proj_f``,
    ``text_proj_f``; the JAX package's ``fformer`` subtree) encodes the
    gallery and the text; it does not train (``FROZEN_PREFIXES``:
    ``requires_grad`` off, as the tower's) and scores the batch to mine hard
    negatives. The trainable Q-Former learns ITM over the concatenated
    memory ``[reference; target]`` of ``2 x S`` image rows (514 at 224 px);
    ``inference_rerank`` returns the softmax of the mean ``itm_head``
    logits, its positive class. ``RERANK_INPUT`` says the rerank takes the
    index's frozen embeds.

    The retrieval engine scores stage 1 through ``fusion_feature``, which
    this class does not override (as the JAX engine does,
    ``sprc_tpu/retrieval/engine.py:177``), over a gallery encoded through the
    twin; ``inference`` scores through the twin's text tower instead.
    """

    LOSSES = ("loss_itm",)
    RERANK_INPUT = "frozen"
    FROZEN_PREFIXES = ("Fformer", "query_tokens_f", "vision_proj_f", "text_proj_f")

    def __init__(self, cfg: CirConfig):
        super().__init__(cfg)
        qcfg = cfg.qformer_config()
        H = qcfg.hidden_size
        self.Fformer = nn.ModuleDict({"bert": QFormer(qcfg)})
        self.query_tokens_f = nn.Parameter(torch.empty(1, cfg.num_query_token, H))
        self.vision_proj_f = Linear(H, cfg.embed_dim, dtype=qcfg.dtype)
        self.text_proj_f = Linear(H, cfg.embed_dim, dtype=qcfg.dtype)
        self.freeze_prefixes()

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

    def _twin_scores(self, tgt_embeds: Tensor, input_ids: Tensor, text_mask: Tensor) -> Tensor:
        """The twin's text-to-target scores over the temperature [B, B]
        (:151-185), without a graph: K3 and K1 on the card."""
        with torch.no_grad():
            queries = self.query_tokens_f.expand(tgt_embeds.shape[0], -1, -1)
            target_feats = l2_normalize(self.vision_proj_f(
                self.fformer(query_embeds=queries, image_embeds=tgt_embeds)))
            text_hidden = self.fformer(input_ids=input_ids, attention_mask=text_mask)
            text_feat = l2_normalize(self.text_proj_f(text_hidden[:, 0]))
            return self.token_max_sim(text_feat, gather_batch(target_feats, False)) / self.temp

    def losses_from_embeds(self, ref_embeds: Tensor, tgt_embeds: Tensor, input_ids: Tensor,
                           text_mask: Tensor, *, generator: Generator = None,
                           sample_generator: Generator = None) -> Dict[str, Tensor]:
        """The ITM loss over the memory ``[reference; target]`` (:240-259):
        positives, then a hard-negative target for each reference, then a
        hard-negative reference (with its caption) for each target. Under
        ``--mesh`` the negatives' rows come from the ranks that hold them,
        with their gradient."""
        bs, Q = input_ids.shape[0], self.cfg.num_query_token
        sim_i2t = self._twin_scores(tgt_embeds, input_ids, text_mask)
        neg_target, neg_ref = self._neg_indices(sim_i2t, sample_generator)
        ids_all = torch.cat([input_ids, input_ids, gather_batch(input_ids, False)[neg_ref]])
        mask_all = torch.cat([text_mask, text_mask, gather_batch(text_mask, False)[neg_ref]])
        reference_all = torch.cat([ref_embeds, ref_embeds, gather_batch(ref_embeds)[neg_ref]])
        targets_all = torch.cat([tgt_embeds, gather_batch(tgt_embeds)[neg_target], tgt_embeds])
        with recomputing():  # 3B items over 2 S memory rows
            hidden = self.qformer(input_ids=ids_all, query_embeds=self._queries(3 * bs),
                                  attention_mask=_ones_mask(mask_all, Q),
                                  image_embeds=torch.cat([reference_all, targets_all], dim=1),
                                  generator=generator)
        return {"loss_itm": _itm_loss(self.itm_head(hidden[:, :Q]).mean(dim=1), bs)}

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
        memory = torch.cat([reference_embeds, target_embeds], dim=1)
        hidden = self.qformer(input_ids=input_ids, query_embeds=self._queries(N),
                              attention_mask=_ones_mask(text_mask, Q), image_embeds=memory)
        del memory
        logits = self.itm_head(hidden[:, :Q]).mean(dim=1)
        return torch.softmax(logits.float(), dim=-1)[:, -1]


@registry.register_model("blip2_cir_cls")
class CirCls(_FusionItcBase, _HardNegMixin):
    """ITC + 5-way prompt-to-prompt classification with a second
    temperature (blip2_qformer_cir_cls.py:85-231): each sample's fused
    queries against those of its own caption and of 4 hard-negative
    captions, each fused with the sample's reference image."""

    LOSSES = ("loss_itc", "loss_p2p")
    NUM_CANDIDATES = 5

    def __init__(self, cfg: CirConfig):
        super().__init__(cfg)
        self.temp2 = nn.Parameter(torch.empty(()))  # init 0.07, as temp

    def _candidates(self, sim_t2t: Tensor, sample_generator: Generator) -> Tuple[Tensor, Tensor]:
        """(cand [B, K]: K - 1 negative captions, then the sample's own;
        label [B]: where the own one stands). With a ``sample_generator`` the
        negatives are drawn without replacement from the softmax and the K
        columns permuted (:160-200). Under ``--mesh`` the captions index the
        global batch."""
        bs, K = sim_t2t.shape[0], self.NUM_CANDIDATES
        own = torch.arange(bs, device=sim_t2t.device)[:, None] + batch_offset(bs)
        if sample_generator is None:
            cand = torch.cat([_stable_top(sim_t2t, K - 1), own], dim=1)
        else:
            neg = torch.multinomial(torch.softmax(sim_t2t, dim=1), K - 1, replacement=False,
                                    generator=sample_generator)
            perm = torch.randperm(K, generator=sample_generator,
                                  device=sample_generator.device).to(sim_t2t.device)
            cand = torch.cat([neg, own], dim=1)[:, perm]
        return cand, (cand == own).int().argmax(dim=1)

    def losses_from_embeds(self, ref_embeds: Tensor, tgt_embeds: Tensor, input_ids: Tensor,
                           text_mask: Tensor, *, generator: Generator = None,
                           sample_generator: Generator = None) -> Dict[str, Tensor]:
        bs, Q, K = input_ids.shape[0], self.cfg.num_query_token, self.NUM_CANDIDATES
        ctx = self._itc(ref_embeds, tgt_embeds, input_ids, text_mask, generator)
        with torch.no_grad():  # the text-only similarity that picks the captions
            text_feat = self.encode_text_cls(input_ids, text_mask)
            sim_t2t = _masked_diag(text_feat @ gather_batch(text_feat, False).t())
        cand, label = self._candidates(sim_t2t, sample_generator)
        flat = cand.reshape(-1)
        ids_w, mask_w = gather_batch(input_ids, False), gather_batch(text_mask, False)
        with torch.no_grad():  # every candidate caption fused with the reference (:202-218)
            neg_hidden = self.qformer(input_ids=ids_w[flat], query_embeds=self._queries(bs * K),
                                      attention_mask=_ones_mask(mask_w[flat], Q),
                                      image_embeds=ref_embeds.repeat_interleave(K, dim=0))
        neg_mean = l2_normalize(neg_hidden[:, :Q].mean(dim=1).reshape(bs, K, -1))
        fusion_mean = l2_normalize(ctx["fused_queries"].mean(dim=1))
        sim_p2p = torch.einsum("bkh,bh->bk", neg_mean, fusion_mean) / self.temp2
        return {"loss_itc": ctx["loss_itc"], "loss_p2p": _cross_entropy(sim_p2p, label)}


@registry.register_model("blip2_cir_slt")
class CirSlt(Blip2CirBase):
    """The top ``NUM_PROMPT`` query tokens by the CLS row's self-attention
    weight onto the queries (the last layer's, averaged over heads), and
    only those fused with the text (blip2_qformer_cir_slt.py:110-174). The
    forward returns the raw ``sim_i2t`` [B, B] over the temperature."""

    NUM_PROMPT = 4

    def losses_from_embeds(self, ref_embeds: Tensor, tgt_embeds: Tensor, input_ids: Tensor,
                           text_mask: Tensor, *, generator: Generator = None) -> Tensor:
        B, Q, P = input_ids.shape[0], self.cfg.num_query_token, self.NUM_PROMPT
        fusion_hidden, probs = self.qformer(
            input_ids=input_ids, query_embeds=self._queries(B),
            attention_mask=_ones_mask(text_mask, Q), image_embeds=ref_embeds,
            generator=generator, output_attentions=True)
        weights = probs[:, :, Q, :Q].mean(dim=1)  # [B, Q]: the CLS row onto the queries
        top = _stable_top(weights, P)
        selected = torch.gather(fusion_hidden[:, :Q], 1,
                                top[:, :, None].expand(-1, -1, fusion_hidden.shape[-1]))
        text_hidden = self.qformer(input_ids=input_ids, query_embeds=selected,
                                   attention_mask=_ones_mask(text_mask, P), generator=generator)
        fusion_feats = l2_normalize(self.text_proj(text_hidden[:, P]))
        target_feats = self.target_features(tgt_embeds, generator)
        return self.token_max_sim(fusion_feats, target_feats) / self.temp


@registry.register_model("blip2_cir_prompt")
class CirPrompt(Blip2CirBase):
    """Feature extractor (blip2_qformer_prompt.py:89-125): the forward
    returns the fused query outputs [B, Q, H]; ``inference`` scores their
    mean, through ``text_proj``, against the gallery's target feats."""

    def forward(self, reference_images: Tensor, target_images: Tensor, input_ids: Tensor,
                text_mask: Tensor, **kw) -> Tensor:
        """Only the reference goes through the tower (the JAX ``__call__``)."""
        with torch.no_grad():
            tower = self.encode_tower(reference_images)
        return self.losses_from_embeds(self.embed_cached(tower), None, input_ids, text_mask, **kw)

    def _fused_queries(self, reference_embeds: Tensor, input_ids: Tensor, text_mask: Tensor,
                       generator: Generator = None) -> Tensor:
        Q = self.cfg.num_query_token
        hidden = self.qformer(input_ids=input_ids, query_embeds=self._queries(input_ids.shape[0]),
                              attention_mask=_ones_mask(text_mask, Q),
                              image_embeds=reference_embeds, generator=generator)
        return hidden[:, :Q]

    def losses_from_embeds(self, ref_embeds: Tensor, tgt_embeds: Optional[Tensor],
                           input_ids: Tensor, text_mask: Tensor, *,
                           generator: Generator = None) -> Tensor:
        return self._fused_queries(ref_embeds, input_ids, text_mask, generator)

    def inference(self, reference_embeds: Tensor, target_feats: Tensor, input_ids: Tensor,
                  text_mask: Tensor) -> Tensor:
        fused = self._fused_queries(reference_embeds, input_ids, text_mask)
        return self.token_max_sim(l2_normalize(self.text_proj(fused.mean(dim=1))), target_feats)
