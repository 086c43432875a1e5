"""The InstructBLIP-style CIR models over the LLaMA decoder (counterpart of
``sprc_tpu/models/instruct_cir.py``; reference blip2_vicuna_instruct.py,
blip2_instruct_cir.py).

- ``blip2_vicuna_instruct`` (:class:`VicunaInstructCir`): the Q-Former
  fuses the learned queries and the instruction text over the reference
  image (K3 on the card when serving), its 32 query rows project through
  ``llm_proj`` and are prepended to the instruction's LLaMA token
  embeddings; the frozen LLaMA's last hidden states, through ``l2q_proj``
  and a mean over every position (the query rows and the pads included, as
  in JAX), give the 768-d composed-query feature. Target features are the
  mean Q-Former query output, with no ``vision_proj``; the training loss is
  ITC over feature cosines divided by the constant 0.07 (not ``temp``);
  ``inference`` is a plain product of the two features.
- ``blip2_instruct_cir`` (:class:`InstructCir`): the instruction-tuned LM
  loss over the target span only (the query rows, the instruction and the
  pads labelled -100); :func:`instruct_generate` decodes greedily, KV-cached
  or recomputing the whole prefix every token.

Text enters tokenized: ``input_ids`` / ``text_mask`` from the BERT
tokenizer, ``llm_input_ids`` / ``llm_mask`` from the LLaMA tokenizer,
right-padded. ``FROZEN_PREFIXES`` keep the tower and the LLaMA out of the
gradient and the optimizer: the tower runs without a graph (K2 on the card)
and the gradient flows through the frozen LLaMA's activations into
``llm_proj``, ``l2q_proj`` and the Q-Former, which trains unfused in
training mode (its dropout drawn from ``generator``).

The module set is what the JAX init of each model holds, with the LLaMA's
``lm_head`` that a real checkpoint carries (the JAX retrieval init makes
none; the JAX test grafts one for generation): a Q-Former with its text
side, no retrieval heads (``vision_proj``, ``text_proj``, ``itm_head``), and
``l2q_proj`` only in the retrieval model, whose loss reaches it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sprc_tpu_torch.models import generation
from sprc_tpu_torch.models.blip2_opt import lm_loss
from sprc_tpu_torch.models.cir_base import Blip2CirBase, CirConfig, cross_entropy_diagonal
from sprc_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from sprc_tpu_torch.ops.layers import Linear, l2_normalize
from sprc_tpu_torch.registry import registry

Tensor = torch.Tensor
ITC_TEMP = 0.07  # the retrieval loss's fixed temperature (reference :236-242)


class _InstructBase(Blip2CirBase):
    """Q-Former fusion -> ``llm_proj`` -> the frozen LLaMA's hidden states."""

    RETRIEVAL_HEADS = False
    QFORMER_TEXT = True
    FROZEN_PREFIXES = ("visual_encoder", "llm_model")  # the JAX ("visual_encoder", "llm")

    def __init__(self, cfg: CirConfig, llama_config: LlamaConfig = LlamaConfig()):
        super().__init__(cfg)
        self.llama_config = llama_config
        self.llm_model = LlamaForCausalLM(llama_config)
        qcfg = cfg.qformer_config()
        self.llm_proj = Linear(qcfg.hidden_size, llama_config.hidden_size, dtype=qcfg.dtype)
        self.freeze_prefixes()

    def encode_image(self, images: Tensor, stats: Optional[Dict[str, float]] = None) -> Tensor:
        """:meth:`Blip2CirBase.encode_image`; ``stats`` gets ``image_encode_s``."""
        with generation.stage(stats, "image_encode_s", images.device):
            return super().encode_image(images)

    def _query_fusion(self, image_embeds: Tensor, input_ids: Tensor, text_mask: Tensor,
                      generator: Optional[torch.Generator] = None,
                      stats: Optional[Dict[str, float]] = None) -> Tensor:
        """Queries + instruction text cross-attending the image -> the query
        rows [B, Q, H]; ``stats`` gets ``qformer_s``."""
        B, Q = image_embeds.shape[0], self.cfg.num_query_token
        with generation.stage(stats, "qformer_s", image_embeds.device):
            attn = torch.cat([text_mask.new_ones(B, Q), text_mask], dim=1)
            hidden = self.qformer(input_ids=input_ids, query_embeds=self._queries(B),
                                  attention_mask=attn, image_embeds=image_embeds,
                                  generator=generator)
            return hidden[:, :Q]

    def _llm_inputs(self, query_outputs: Tensor, llm_input_ids: Tensor,
                    llm_mask: Tensor) -> Tuple[Tensor, Tensor]:
        """``[llm_proj(queries) | token embeddings]`` and its mask."""
        tok = self.llm_model.embed(llm_input_ids.long())
        B, Q = query_outputs.shape[:2]
        embeds = torch.cat([self.llm_proj(query_outputs).to(tok.dtype), tok], dim=1)
        return embeds, torch.cat([llm_mask.new_ones(B, Q), llm_mask], dim=1)

    def _llm_hidden(self, query_outputs: Tensor, llm_input_ids: Tensor, llm_mask: Tensor,
                    stats: Optional[Dict[str, float]] = None) -> Tensor:
        """The frozen LLaMA's hidden states over the prefixed tokens;
        ``stats`` gets ``llm_s``. The LLaMA is frozen by the optimizer's
        partition, not by a detach: the gradient flows through it."""
        with generation.stage(stats, "llm_s", query_outputs.device):
            return self.llm_model.hidden_states(
                *self._llm_inputs(query_outputs, llm_input_ids, llm_mask))


@registry.register_model("blip2_vicuna_instruct")
class VicunaInstructCir(_InstructBase):
    """CIR retrieval through the LLM (blip2_vicuna_instruct.py)."""

    def __init__(self, cfg: CirConfig, llama_config: LlamaConfig = LlamaConfig()):
        super().__init__(cfg, llama_config)
        qcfg = cfg.qformer_config()
        self.l2q_proj = Linear(llama_config.hidden_size, qcfg.hidden_size, dtype=qcfg.dtype)

    def _ref_feature(self, query_outputs: Tensor, llm_input_ids: Tensor, llm_mask: Tensor,
                     stats: Optional[Dict[str, float]] = None) -> Tensor:
        """The composed-query feature [B, H]: ``l2q_proj`` of the hidden
        states, averaged over all Q + L positions (pads included, as in JAX)."""
        hidden = self._llm_hidden(query_outputs, llm_input_ids, llm_mask, stats)
        return l2_normalize(self.l2q_proj(hidden).mean(dim=1))

    def forward(self, reference_images: Tensor, target_images: Tensor, input_ids: Tensor,
                text_mask: Tensor, llm_input_ids: Tensor, llm_mask: Tensor, *,
                generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """-> {"loss_itc"} (``sprc_tpu/models/instruct_cir.py:95-117``); the two
        image batches in one tower call of 2B images."""
        ref_embeds, tgt_embeds = self.encode_image_pair(reference_images, target_images)
        query_outputs = self._query_fusion(ref_embeds, input_ids, text_mask, generator)
        ref_feats = self._ref_feature(query_outputs, llm_input_ids, llm_mask)
        target_feats = l2_normalize(self.embed_image_queries(tgt_embeds, generator).mean(dim=1))
        sim = ref_feats.float() @ target_feats.float().t() / ITC_TEMP
        return {"loss_itc": cross_entropy_diagonal(sim)}

    def extract_target_features(self, images: Tensor,
                                stats: Optional[Dict[str, float]] = None
                                ) -> Tuple[Tensor, Tensor]:
        """Gallery encode -> (the mean query output, normalised [B, H];
        the frozen rows [B, S, D]); ``stats`` gets ``image_encode_s`` and
        ``qformer_s``."""
        frozen = self.encode_image(images, stats)
        with generation.stage(stats, "qformer_s", images.device):
            return l2_normalize(self.embed_image_queries(frozen).mean(dim=1)), frozen

    def inference(self, reference_embeds: Tensor, target_feats: Tensor, input_ids: Tensor,
                  text_mask: Tensor, llm_input_ids: Tensor, llm_mask: Tensor,
                  stats: Optional[Dict[str, float]] = None) -> Tensor:
        """Composed-query scores [B, N]: the reference feature against the
        target features, a plain product; ``stats`` gets ``qformer_s`` and
        ``llm_s``."""
        query_outputs = self._query_fusion(reference_embeds, input_ids, text_mask, stats=stats)
        ref_feats = self._ref_feature(query_outputs, llm_input_ids, llm_mask, stats)
        return ref_feats.float() @ target_feats.float().t()


@registry.register_model("blip2_instruct_cir")
class InstructCir(_InstructBase):
    """The instruction-tuned LM loss (blip2_instruct_cir.py:139-240).
    ``llm_input_ids`` is the concatenated [instruction | output] sequence;
    ``target_mask`` marks the positions that take the loss."""

    def forward(self, images: Tensor, input_ids: Tensor, text_mask: Tensor,
                llm_input_ids: Tensor, llm_mask: Tensor, target_mask: Tensor, *,
                generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """-> {"loss"}: the mean next-token NLL over the target span
        (``sprc_tpu/models/instruct_cir.py:293-325``)."""
        query_outputs = self._query_fusion(self.encode_image(images), input_ids, text_mask,
                                           generator)
        logits = self.llm_model.logits(self._llm_hidden(query_outputs, llm_input_ids, llm_mask))
        B, Q = query_outputs.shape[:2]
        labels = torch.where(target_mask.bool(), llm_input_ids.long(), -100)
        labels = torch.cat([labels.new_full((B, Q), -100), labels], dim=1)
        return {"loss": lm_loss(logits[:, :-1], labels[:, 1:])}



class InstructAdapter:
    """The trainer's forward for the two models (``GenericTrainer``'s
    ``adapter``) over a batch of ``input_ids`` / ``text_mask`` (BERT),
    ``llm_input_ids`` / ``llm_mask`` (LLaMA) and ``reference`` / ``target``
    (the retrieval model) or ``images`` / ``target_mask`` (the LM model). No
    run config reaches it: ``train/generic.py`` has no task adapter for
    these signatures, in either package."""

    @staticmethod
    def forward(model: _InstructBase, batch: Dict[str, Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        text = [batch[k] for k in ("input_ids", "text_mask", "llm_input_ids", "llm_mask")]
        if isinstance(model, VicunaInstructCir):
            return model(batch["reference"], batch["target"], *text, generator=generator)
        return model(batch["images"], *text, batch["target_mask"], generator=generator)


def instruct_generate(model: _InstructBase, images: Tensor, input_ids: Tensor, text_mask: Tensor,
                      llm_input_ids: Tensor, llm_mask: Tensor, *, eos_token_id: int,
                      pad_token_id: int, max_new_tokens: int = 30, use_cache: bool = True,
                      stats: Optional[Dict[str, float]] = None) -> Tensor:
    """Greedy LLaMA ids [B, max_new_tokens] conditioned on ``[queries |
    prompt]`` (``sprc_tpu/models/instruct_cir.py:145-275``).

    ``use_cache`` (the default): one prefill over the prefix, then
    :func:`~sprc_tpu_torch.models.generation.cached_greedy_loop` at each
    row's next buffer position. Otherwise the whole sequence is recomputed
    every token (the JAX recompute loop; the image prefix is computed once,
    as its values are the same every token). ``stats`` gets the seconds by
    stage (``image_encode_s``, ``qformer_s``, ``prefill_s``, ``decode_s``)
    and ``decode_steps``."""
    llm_input_ids, llm_mask = llm_input_ids.long(), llm_mask.long()
    B, L = llm_input_ids.shape
    device = llm_input_ids.device
    query_outputs = model._query_fusion(model.encode_image(images, stats), input_ids, text_mask,
                                        stats=stats)
    Q = query_outputs.shape[1]
    lengths = llm_mask.sum(dim=1)
    rows = torch.arange(B, device=device)
    llm = model.llm_model
    if use_cache:
        with generation.stage(stats, "prefill_s", device):
            embeds, mask = model._llm_inputs(query_outputs, llm_input_ids, llm_mask)
            hidden, cache = llm.prefill(embeds, mask, Q + L + max_new_tokens)
            logits0 = llm.logits(hidden[rows, Q + lengths - 1][:, None, :])[:, 0, :]
        steps = [0]

        def step_fn(tok, pos, cache):
            steps[0] += 1
            return llm.decode_step_logits(tok, pos, cache)

        with generation.stage(stats, "decode_s", device):
            out = generation.cached_greedy_loop(
                logits0, cache, Q + lengths, step_fn, eos_token_id=eos_token_id,
                pad_token_id=pad_token_id, max_new_tokens=max_new_tokens)
        if stats is not None:
            stats["decode_steps"] = stats.get("decode_steps", 0) + steps[0]
        return out

    total = L + max_new_tokens
    ids = torch.full((B, total), pad_token_id, dtype=torch.long, device=device)
    ids[:, :L] = llm_input_ids
    mask = torch.zeros(B, total, dtype=torch.long, device=device)
    mask[:, :L] = llm_mask
    finished = torch.zeros(B, dtype=torch.bool, device=device)
    for _ in range(max_new_tokens):
        hidden = model._llm_hidden(query_outputs, ids, mask)
        nxt = llm.logits(hidden[rows, Q + lengths - 1]).argmax(dim=-1)
        nxt = torch.where(finished, torch.full_like(nxt, pad_token_id), nxt)
        ids[rows, lengths] = nxt
        mask[rows, lengths] = (~finished).long()
        lengths = lengths + (~finished).long()
        finished |= nxt == eos_token_id
        if bool(finished.all()):
            break
    out = torch.full((B, max_new_tokens), pad_token_id, dtype=torch.long, device=device)
    base = llm_mask.sum(dim=1).tolist()
    for b, (start, end) in enumerate(zip(base, lengths.tolist())):
        out[b, :end - start] = ids[b, start:end]
    return out
