"""BLIP-2 stage 2 with the OPT decoder (registry ``blip2_opt``; counterpart
of ``sprc_tpu/models/blip2_opt.py``, reference
src/lavis/models/blip2_models/blip2_opt.py).

The frozen tower -> ``ln_vision`` -> the Q-Former's queries-only pass (K2
in the tower, K3 in each Q-Former layer on the card) -> ``opt_proj`` -> the
32 query rows prepended to the frozen OPT's token embeddings. The Q-Former
has no text side and the model no retrieval heads
(``Blip2CirBase.QFORMER_TEXT``, ``RETRIEVAL_HEADS``), so the JAX init tree, ``temp`` among
it, loads with ``strict=True``.

:meth:`Blip2OPT.forward` is the LM loss (labels -100 over the queries, the
``prompt_length`` prefix and the pads), the training forward of
``train/generic.py``: ``FROZEN_PREFIXES`` (the JAX model's ``("visual_encoder",
"opt")`` in the port's module names) keep the tower and the OPT out of the
gradient and the optimizer, whatever ``freeze_vit`` says (the COCO row says
false), so the tower runs without a graph (K2 on the card) and the gradient
flows through the frozen OPT's activations into ``opt_proj``, the Q-Former
(unfused in training mode, its dropout drawn from ``generator``),
``query_tokens`` and ``ln_vision``. :meth:`Blip2OPT.generate_ids` is the
greedy caption decode, KV-cached (prefill of ``[queries | prompt]``, then
:func:`~sprc_tpu_torch.models.generation.cached_greedy_loop`) or with the
whole sequence recomputed every token (the JAX recompute loop; the image
prefix is computed once, as its values are the same every token).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from sprc_tpu_torch.models import generation
from sprc_tpu_torch.models.cir_base import Blip2CirBase, CirConfig
from sprc_tpu_torch.models.opt import OPTConfig, OPTForCausalLM
from sprc_tpu_torch.ops.layers import Linear
from sprc_tpu_torch.registry import registry

Tensor = torch.Tensor


def query_prefix(model: Blip2CirBase, proj: Linear, images: Tensor,
                 stats: Optional[Dict[str, float]],
                 generator: Optional[torch.Generator] = None) -> Tensor:
    """images -> the projected query rows [B, Q, h]; ``stats`` gets
    ``image_encode_s`` (tower and ln_vision) and ``qformer_s`` (the
    queries-only pass and the projection); ``generator``: the Q-Former's
    dropout masks in training mode."""
    with generation.stage(stats, "image_encode_s", images.device):
        image_embeds = model.encode_image(images)
    with generation.stage(stats, "qformer_s", images.device):
        return proj(model.embed_image_queries(image_embeds, generator))


def lm_loss(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean next-token NLL in fp32 over the labels that are not -100."""
    valid = labels != -100
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1)


@registry.register_model("blip2_opt")
class Blip2OPT(Blip2CirBase):
    """LM captioning through a frozen OPT decoder."""

    RETRIEVAL_HEADS = False
    LLM_HEAD = True  # LAVIS's stage-2 checkpoint holds no temp: loader.read_checkpoint
    QFORMER_TEXT = False
    FROZEN_PREFIXES = ("visual_encoder", "opt_model")

    def __init__(self, cfg: CirConfig, opt_config: OPTConfig = OPTConfig()):
        super().__init__(cfg)
        self.opt_config = opt_config
        self.opt_model = OPTForCausalLM(opt_config)
        qcfg = cfg.qformer_config()
        self.opt_proj = Linear(qcfg.hidden_size, opt_config.hidden_size, dtype=qcfg.dtype)
        self.freeze_prefixes()

    def inputs_opt(self, images: Tensor, stats: Optional[Dict[str, float]] = None,
                   generator: Optional[torch.Generator] = None) -> Tensor:
        return query_prefix(self, self.opt_proj, images, stats, generator)

    def _prefix(self, inputs_opt: Tensor, ids: Tensor, mask: Tensor):
        """``[queries | tokens]`` embeddings and their mask."""
        tok = self.opt_model.embed(ids)
        B, Q = inputs_opt.shape[:2]
        embeds = torch.cat([inputs_opt.to(tok.dtype), tok], dim=1)
        return embeds, torch.cat([mask.new_ones(B, Q), mask], dim=1)

    def forward(self, images: Tensor, opt_input_ids: Tensor, opt_mask: Tensor, *,
                pad_token_id: int = 1, prompt_length: int = 0,
                generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """-> {"loss", "logits" [B, Q + L, V]}: the LM loss over the caption
        tokens (``sprc_tpu/models/blip2_opt.py:51-88``); ``generator``: the
        Q-Former's dropout in training mode (JAX's ``deterministic=False``)."""
        B, L = opt_input_ids.shape
        inputs_opt = self.inputs_opt(images, generator=generator)
        Q = inputs_opt.shape[1]
        embeds, mask = self._prefix(inputs_opt, opt_input_ids, opt_mask)
        logits = self.opt_model.logits(self.opt_model.hidden_states(embeds, mask))
        labels = torch.where(opt_input_ids == pad_token_id, -100, opt_input_ids.long())
        if prompt_length:
            pos = torch.arange(L, device=labels.device)[None, :]
            labels = torch.where(pos < prompt_length, -100, labels)
        labels = torch.cat([labels.new_full((B, Q), -100), labels], dim=1)
        return {"loss": lm_loss(logits[:, :-1], labels[:, 1:]), "logits": logits}

    def generate_ids(self, images: Tensor, prompt_ids: Tensor, prompt_mask: Tensor, *,
                     eos_token_id: int = 2, pad_token_id: int = 1, max_new_tokens: int = 30,
                     use_cache: bool = True,
                     stats: Optional[Dict[str, float]] = None) -> Tensor:
        """Greedy caption ids [B, max_new_tokens] from a right-padded prompt.
        ``stats`` gets the seconds by stage (``image_encode_s``,
        ``qformer_s``, ``prefill_s``, ``decode_s``) and ``decode_steps``, the
        cached steps run."""
        prompt_ids, prompt_mask = prompt_ids.long(), prompt_mask.long()
        B, L = prompt_ids.shape
        device = prompt_ids.device
        inputs_opt = self.inputs_opt(images, stats)
        Q = inputs_opt.shape[1]
        lengths = prompt_mask.sum(dim=1)
        rows = torch.arange(B, device=device)
        opt = self.opt_model
        if use_cache:
            with generation.stage(stats, "prefill_s", device):
                embeds, mask = self._prefix(inputs_opt, prompt_ids, prompt_mask)
                hidden, cache = opt.prefill(embeds, mask, Q + L + max_new_tokens)
                logits0 = opt.logits(hidden[rows, Q + lengths - 1][:, None, :])[:, 0, :]
            steps = [0]

            def step_fn(tok, pos, cache):
                steps[0] += 1
                return opt.decode_step_logits(tok, pos, cache)

            with generation.stage(stats, "decode_s", device):
                out = generation.cached_greedy_loop(
                    logits0, cache, Q + lengths, step_fn, eos_token_id=eos_token_id,
                    pad_token_id=pad_token_id, max_new_tokens=max_new_tokens)
            if stats is not None:
                stats["decode_steps"] = stats.get("decode_steps", 0) + steps[0]
            return out

        total = L + max_new_tokens
        ids = torch.full((B, total), pad_token_id, dtype=torch.long, device=device)
        ids[:, :L] = prompt_ids
        mask = torch.zeros(B, total, dtype=torch.long, device=device)
        mask[:, :L] = prompt_mask
        finished = torch.zeros(B, dtype=torch.bool, device=device)
        for _ in range(max_new_tokens):
            embeds, full_mask = self._prefix(inputs_opt, ids, mask)
            hidden = opt.hidden_states(embeds, full_mask)
            nxt = opt.logits(hidden[rows, Q + lengths - 1]).argmax(dim=-1)
            nxt = torch.where(finished, torch.full_like(nxt, pad_token_id), nxt)
            ids[rows, lengths] = nxt
            mask[rows, lengths] = (~finished).long()
            lengths = lengths + (~finished).long()
            finished |= nxt == eos_token_id
            if bool(finished.all()):
                break
        out = torch.full((B, max_new_tokens), pad_token_id, dtype=torch.long, device=device)
        base = prompt_mask.sum(dim=1).tolist()
        for b, (start, end) in enumerate(zip(base, lengths.tolist())):
            out[b, :end - start] = ids[b, start:end]
        return out
