"""BLIP-2 stage 2 with the T5 encoder-decoder (registry ``blip2_t5``;
counterpart of ``sprc_tpu/models/blip2_t5.py``, reference
src/lavis/models/blip2_models/blip2_t5.py; also registered as
``blip2_t5_instruct``, the same class, as the JAX package registers it).

The frozen tower -> ``ln_vision`` -> the Q-Former's queries-only pass (K2,
K3 on the card) -> ``t5_proj`` -> the 32 query rows prepended to the prompt's
token embeddings in the frozen T5 ENCODER. :meth:`Blip2T5.forward` is the
seq2seq loss (decoder teacher forcing with T5's shift-right, pads -100), the
training forward of ``train/generic.py``'s seq2seq adapter, with the tower
and the T5 frozen by ``FROZEN_PREFIXES`` as ``blip2_opt``'s;
:meth:`Blip2T5.generate_ids` decodes greedily from the decoder start token
0, KV-cached or recomputing the decoder every token. As for ``blip2_opt``,
the Q-Former has no text side and the model no retrieval heads.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sprc_tpu_torch.models import generation
from sprc_tpu_torch.models.blip2_opt import lm_loss, query_prefix
from sprc_tpu_torch.models.cir_base import Blip2CirBase, CirConfig
from sprc_tpu_torch.models.t5 import T5Config, T5ForConditionalGeneration
from sprc_tpu_torch.ops.layers import Linear
from sprc_tpu_torch.registry import registry

Tensor = torch.Tensor


@registry.register_model("blip2_t5_instruct")  # the same class, as in JAX (its YAMLs' rows)
@registry.register_model("blip2_t5")
class Blip2T5(Blip2CirBase):
    """Seq2seq captioning through a frozen T5."""

    RETRIEVAL_HEADS = False
    LLM_HEAD = True  # LAVIS's stage-2 checkpoint holds no temp: loader.read_checkpoint
    QFORMER_TEXT = False
    FROZEN_PREFIXES = ("visual_encoder", "t5_model")  # the JAX ("visual_encoder", "t5")

    def __init__(self, cfg: CirConfig, t5_config: T5Config = T5Config()):
        super().__init__(cfg)
        self.t5_config = t5_config
        self.t5_model = T5ForConditionalGeneration(t5_config)
        qcfg = cfg.qformer_config()
        self.t5_proj = Linear(qcfg.hidden_size, t5_config.d_model, dtype=qcfg.dtype)
        self.freeze_prefixes()

    def encode(self, images: Tensor, input_ids: Tensor, input_mask: Tensor,
               stats: Optional[Dict[str, float]] = None,
               generator: Optional[torch.Generator] = None) -> Tuple[Tensor, Tensor]:
        """The encoder over ``[t5_proj(queries) | prompt]`` -> (memory, its
        mask); ``stats`` as :meth:`generate_ids` says (the encoder is part of
        ``prefill_s``); ``generator``: the Q-Former's dropout in training mode."""
        inputs_t5 = query_prefix(self, self.t5_proj, images, stats, generator)
        with generation.stage(stats, "prefill_s", images.device):
            tok = self.t5_model.embed(input_ids.long())
            B, Q = inputs_t5.shape[:2]
            embeds = torch.cat([inputs_t5.to(tok.dtype), tok], dim=1)
            mask = torch.cat([input_mask.new_ones(B, Q), input_mask], dim=1)
            return self.t5_model.encode(embeds, mask), mask

    def forward(self, images: Tensor, input_ids: Tensor, input_mask: Tensor, output_ids: Tensor,
                output_mask: Tensor, *, pad_token_id: int = 0,
                decoder_start_token_id: int = 0,
                generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """-> {"loss", "logits" [B, L_out, V]}
        (``sprc_tpu/models/blip2_t5.py:58-88``); ``generator`` as
        :meth:`Blip2OPT.forward`'s."""
        enc_out, enc_mask = self.encode(images, input_ids, input_mask, generator=generator)
        output_ids = output_ids.long()
        dec_in = torch.cat([output_ids.new_full((output_ids.shape[0], 1), decoder_start_token_id),
                            output_ids[:, :-1]], dim=1)
        logits = self.t5_model.decode(dec_in, enc_out, enc_mask, output_mask)
        labels = torch.where(output_ids == pad_token_id, -100, output_ids)
        return {"loss": lm_loss(logits, labels), "logits": logits}

    def generate_ids(self, images: Tensor, input_ids: Tensor, input_mask: Tensor, *,
                     eos_token_id: int = 1, pad_token_id: int = 0,
                     decoder_start_token_id: int = 0, max_new_tokens: int = 30,
                     use_cache: bool = True,
                     stats: Optional[Dict[str, float]] = None) -> Tensor:
        """Greedy ids [B, max_new_tokens]. ``stats`` gets the seconds by stage
        (``image_encode_s``, ``qformer_s``, ``prefill_s``: the encoder and
        the decoder's start position, ``decode_s``) and ``decode_steps``."""
        B = input_ids.shape[0]
        device = input_ids.device
        enc_out, enc_mask = self.encode(images, input_ids, input_mask, stats)
        t5 = self.t5_model
        if use_cache:
            with generation.stage(stats, "prefill_s", device):
                start = torch.full((B, 1), decoder_start_token_id, dtype=torch.long,
                                   device=device)
                logits0, cache = t5.decode_prefill(start, enc_out, enc_mask, 1 + max_new_tokens)
            steps = [0]

            def step_fn(tok, pos, cache):
                steps[0] += 1
                return t5.decode_step_logits(tok, pos[:1], cache, enc_mask)

            with generation.stage(stats, "decode_s", device):
                out = generation.cached_greedy_loop(
                    logits0, cache, torch.ones(B, dtype=torch.long, device=device), step_fn,
                    eos_token_id=eos_token_id, pad_token_id=pad_token_id,
                    max_new_tokens=max_new_tokens)
            if stats is not None:
                stats["decode_steps"] = stats.get("decode_steps", 0) + steps[0]
            return out

        total = max_new_tokens + 1
        dec = torch.full((B, total), pad_token_id, dtype=torch.long, device=device)
        dec[:, 0] = decoder_start_token_id
        dmask = torch.zeros(B, total, dtype=torch.long, device=device)
        dmask[:, 0] = 1
        finished = torch.zeros(B, dtype=torch.bool, device=device)
        for step in range(1, total):
            logits = t5.decode(dec, enc_out, enc_mask, dmask)
            nxt = logits[:, step - 1].argmax(dim=-1)
            nxt = torch.where(finished, torch.full_like(nxt, pad_token_id), nxt)
            dec[:, step] = nxt
            dmask[:, step] = (~finished).long()
            finished |= nxt == eos_token_id
            if bool(finished.all()):
                break
        return dec[:, 1:]
