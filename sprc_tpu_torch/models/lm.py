"""The Q-Former language model and its caption decoding (counterpart of
``sprc_tpu/models/lm.py``; reference Qformer.py ``BertLMHeadModel`` and
``generate``, used by the CIR models' ``generate``,
cir_align_prompt.py:202-263).

- :class:`QFormerLMHead`: ``BertLMPredictionHead``, dense -> exact GELU ->
  fp32 LayerNorm -> decoder to the vocabulary (30,523 rows with ``[DEC]``).
  Module names are the reference's (``cls.predictions.transform.dense``,
  ``.transform.LayerNorm``, ``.decoder``), so a released stage-1
  checkpoint's head loads by name;
- :class:`QFormerLM`: the decoder-mode Q-Former (the UniLM mask: queries
  among themselves, text causal after the query prefix) and that head, as
  ``bert`` / ``cls`` (a LAVIS ``Qformer.`` state dict without its prefix,
  :func:`qformer_lm_state_from_torch`);
- :func:`greedy_generate` (over
  :func:`~sprc_tpu_torch.models.generation.greedy_generate_fn`) and
  :func:`beam_generate` recompute the whole fixed-width prefix every step
  (the JAX functions' equality oracles; the beam search is the JAX host
  loop, float64 log-probabilities and numpy's ``argsort``);
- :func:`cached_greedy_generate` and :func:`cached_beam_generate`: one
  prefill over ``[queries | BOS]`` that keeps each layer's K / V, then one
  cached step a token (self-attention over the cache, the text FFN; text
  positions never cross-attend), over
  :func:`~sprc_tpu_torch.models.generation.cached_greedy_loop` /
  :func:`~sprc_tpu_torch.models.generation.cached_beam_loop`;
- :func:`generate_captions`: a CIR model's frozen tower -> ``ln_vision`` ->
  the queries decode from ``[DEC]`` (3 beams by default; 1 beam is greedy).

Every function returns ids ``[B, max_length]``, the start token first, as
the JAX functions do; ``min_length`` holds the eos back until that
position. The decoder runs the Q-Former's unfused composition in both
packages (a full mask never reaches K3), so the one kernel on the caption
path is the tower's (K2, through ``encode_image``).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from sprc_tpu_torch.models.generation import (cached_beam_loop, cached_greedy_loop,
                                               greedy_generate_fn, stage)
from sprc_tpu_torch.models.qformer import QFormer, QFormerConfig, make_unilm_mask
from sprc_tpu_torch.ops import primitives
from sprc_tpu_torch.ops.layers import LayerNormFP32, Linear

Tensor = torch.Tensor
CACHE_MASK = -1e10  # the JAX step's bias on the cache slots not yet written


class _Transform(nn.Module):
    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size, dtype=cfg.dtype)
        self.LayerNorm = LayerNormFP32(cfg.hidden_size, cfg.layer_norm_eps)


class _Predictions(nn.Module):
    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.transform = _Transform(cfg)
        self.decoder = Linear(cfg.hidden_size, cfg.vocab_size, dtype=cfg.dtype)


class QFormerLMHead(nn.Module):
    """hidden [..., H] -> logits [..., vocab] in the Q-Former's dtype."""

    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.predictions = _Predictions(cfg)

    def forward(self, hidden: Tensor) -> Tensor:
        p = self.predictions
        h = primitives.gelu(p.transform.dense(hidden))
        return p.decoder(p.transform.LayerNorm(h))


class QFormerLM(nn.Module):
    """The decoder Q-Former and its LM head (``BertLMHeadModel``). ``bert`` /
    ``cls`` may be a model's own modules (a CIR model's Q-Former, a stage-1
    model's head): they are shared, not copied."""

    def __init__(self, cfg: QFormerConfig, bert: Optional[QFormer] = None,
                 cls: Optional[QFormerLMHead] = None):
        super().__init__()
        self.cfg = cfg
        self.bert = bert if bert is not None else QFormer(cfg)
        self.cls = cls if cls is not None else QFormerLMHead(cfg)

    def forward(self, input_ids: Tensor, query_embeds: Tensor,
                attention_mask: Optional[Tensor] = None,
                image_embeds: Optional[Tensor] = None) -> Tensor:
        """-> the logits over the text positions [B, L, vocab]."""
        hidden = self.bert(input_ids=input_ids, query_embeds=query_embeds,
                           attention_mask=attention_mask, image_embeds=image_embeds,
                           is_decoder=True)
        return self.cls(hidden[:, query_embeds.shape[1]:])

    # ------------------------------------------------------------ the KV cache

    def prefill(self, query_embeds: Tensor, image_embeds: Tensor, bos_token_id: int,
                max_length: int):
        """The decoder over ``[queries | BOS]`` -> (the logits of position 0
        [B, V], the cache state): each layer's K / V of those Q + 1 rows in
        buffers [layers, B, Q + max_length, H], and the next text position, 1."""
        cfg, bert = self.cfg, self.bert
        B, Q = query_embeds.shape[:2]
        bos = torch.full((B, 1), bos_token_id, dtype=torch.long, device=query_embeds.device)
        hidden = bert.embeddings(bos, query_embeds)
        mask = make_unilm_mask(torch.ones(B, Q + 1, dtype=torch.int32, device=hidden.device), Q)
        image = image_embeds.to(cfg.dtype).contiguous()
        shape = (cfg.num_layers, B, Q + max_length, cfg.hidden_size)
        k = torch.zeros(shape, dtype=cfg.dtype, device=hidden.device)
        v = torch.zeros_like(k)
        for i, layer in enumerate(bert.encoder.layer):
            proj = layer.attention.self
            k[i, :, :Q + 1] = proj.key(hidden)
            v[i, :, :Q + 1] = proj.value(hidden)
            hidden = layer(hidden, mask, image, Q)
        return self.cls(hidden[:, Q:])[:, 0], (k, v, Q, 1)

    def step(self, tok: Tensor, state):
        """One cached step of the tokens ``tok`` [B] at the state's text
        position t (their K / V go to slot Q + t) -> (the next logits [B, V],
        the state at t + 1)."""
        cfg, bert = self.cfg, self.bert
        k_cache, v_cache, Q, t = state
        B = tok.shape[0]
        H, D = cfg.num_heads, cfg.head_dim
        emb = bert.embeddings
        x = emb.word_embeddings(tok) + emb.position_embeddings.weight[t]
        x = emb.LayerNorm(x[:, None]).to(cfg.dtype)
        slots = k_cache.shape[2]
        bias = torch.zeros(slots, device=x.device).masked_fill(
            torch.arange(slots, device=x.device) > Q + t, CACHE_MASK)
        for i, layer in enumerate(bert.encoder.layer):
            attn = layer.attention
            k_cache[i, :, Q + t] = attn.self.key(x)[:, 0]
            v_cache[i, :, Q + t] = attn.self.value(x)[:, 0]
            q = attn.self.query(x).view(B, 1, H, D)
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                  k_cache[i].view(B, slots, H, D).float()) * D ** -0.5
            probs = torch.softmax(scores + bias, dim=-1)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(cfg.dtype),
                               v_cache[i].view(B, slots, H, D)).reshape(B, 1, H * D)
            att = attn.output.LayerNorm(attn.output.dense(ctx) + x)
            h = layer.output.dense(primitives.gelu(layer.intermediate.dense(att)))
            x = layer.output.LayerNorm(h + att)
        return self.cls(x)[:, 0], (k_cache, v_cache, Q, t + 1)


def _reorder(state, rows: Tensor):
    k, v, Q, t = state
    return k[:, rows], v[:, rows], Q, t


def _with_start(ids: Tensor, bos_token_id: int) -> Tensor:
    start = torch.full((ids.shape[0], 1), bos_token_id, dtype=ids.dtype, device=ids.device)
    return torch.cat([start, ids], dim=1)


@torch.no_grad()
def greedy_generate(lm: QFormerLM, query_embeds: Tensor, image_embeds: Tensor, *,
                    bos_token_id: int, eos_token_id: int, pad_token_id: int,
                    max_length: int = 30, min_length: int = 10) -> Tensor:
    """Greedy decode that recomputes the whole ``max_length`` prefix every
    step -> ids [B, max_length] (int64); finished rows take the pad."""
    start = torch.full((query_embeds.shape[0], 1), bos_token_id, dtype=torch.long,
                       device=query_embeds.device)
    return greedy_generate_fn(lambda ids: lm(ids, query_embeds, image_embeds=image_embeds),
                              start, eos_token_id=eos_token_id, pad_token_id=pad_token_id,
                              max_length=max_length, min_length=min_length - 1)


@torch.no_grad()
def beam_generate(lm: QFormerLM, query_embeds: Tensor, image_embeds: Tensor, *,
                  bos_token_id: int, eos_token_id: int, pad_token_id: int, num_beams: int = 3,
                  max_length: int = 30, min_length: int = 10,
                  length_penalty: float = 1.0) -> Tensor:
    """Beam search that recomputes the prefix every step, its selection on
    the host in float64 (the JAX host loop, line for line) -> ids [B,
    max_length]; the best beam by ``score / length ** length_penalty``, the
    length counting the non-pad ids."""
    B, K = query_embeds.shape[0], num_beams
    device = query_embeds.device
    q_rep = query_embeds.repeat_interleave(K, dim=0)
    img_rep = image_embeds.repeat_interleave(K, dim=0)
    ids = np.full((B * K, max_length), pad_token_id, np.int64)
    ids[:, 0] = bos_token_id
    beam_scores = np.zeros((B, K), np.float64)
    beam_scores[:, 1:] = -1e9  # every beam the same row at step 0: keep one
    finished = np.zeros((B * K,), bool)
    for step in range(1, max_length):
        logits = lm(torch.from_numpy(ids).to(device), q_rep, image_embeds=img_rep)[:, step - 1]
        logits = logits.double().cpu().numpy()
        if step < min_length:
            logits[:, eos_token_id] = -1e9
        m = logits.max(-1, keepdims=True)
        logp = logits - m - np.log(np.exp(logits - m).sum(-1, keepdims=True))
        V = logp.shape[-1]
        logp[finished] = -1e9  # a finished beam extends with the pad only, at no cost
        logp[finished, pad_token_id] = 0.0
        total = (beam_scores.reshape(B * K, 1) + logp).reshape(B, K * V)
        top_idx = np.argsort(-total, axis=-1)[:, :K]
        new_ids, new_finished = np.empty_like(ids), np.zeros_like(finished)
        new_scores = np.empty_like(beam_scores)
        for b in range(B):
            for k, flat in enumerate(top_idx[b]):
                src, tok = divmod(int(flat), V)
                row, src_row = b * K + k, b * K + src
                new_ids[row] = ids[src_row]
                new_ids[row, step] = tok
                new_scores[b, k] = total[b, flat]
                new_finished[row] = finished[src_row] or tok == eos_token_id
        ids, beam_scores, finished = new_ids, new_scores, new_finished
        if finished.all():
            break
    out = np.full((B, max_length), pad_token_id, np.int64)
    for b in range(B):
        best_k, best_score = 0, -np.inf
        for k in range(K):
            length = int((ids[b * K + k] != pad_token_id).sum())
            score = beam_scores[b, k] / (length ** length_penalty)
            if score > best_score:
                best_k, best_score = k, score
        out[b] = ids[b * K + best_k]
    return torch.from_numpy(out).to(device)


@torch.no_grad()
def cached_greedy_generate(lm: QFormerLM, query_embeds: Tensor, image_embeds: Tensor, *,
                           bos_token_id: int, eos_token_id: int, pad_token_id: int,
                           max_length: int = 30, min_length: int = 10) -> Tensor:
    """The KV-cached greedy decode (the reference's ``past_key_values``
    path), step for step :func:`greedy_generate` -> ids [B, max_length]."""
    logits0, state = lm.prefill(query_embeds, image_embeds, bos_token_id, max_length)
    pos0 = torch.ones(query_embeds.shape[0], dtype=torch.long, device=logits0.device)
    ids = cached_greedy_loop(logits0, state, pos0, lambda tok, pos, s: lm.step(tok, s),
                             eos_token_id=eos_token_id, pad_token_id=pad_token_id,
                             max_new_tokens=max_length - 1, min_new_tokens=min_length - 1)
    return _with_start(ids, bos_token_id)


@torch.no_grad()
def cached_beam_generate(lm: QFormerLM, query_embeds: Tensor, image_embeds: Tensor, *,
                         bos_token_id: int, eos_token_id: int, pad_token_id: int,
                         num_beams: int = 3, max_length: int = 30, min_length: int = 10,
                         length_penalty: float = 1.0) -> Tensor:
    """The KV-cached beam search (selection, beam reordering of the ids and
    of every layer's K / V on the device; the reference's beam 3 with HF's
    length penalty) -> ids [B, max_length]."""
    K = num_beams
    logits0, state = lm.prefill(query_embeds.repeat_interleave(K, dim=0),
                                image_embeds.repeat_interleave(K, dim=0), bos_token_id,
                                max_length)
    pos0 = torch.ones(logits0.shape[0], dtype=torch.long, device=logits0.device)
    ids = cached_beam_loop(logits0, state, pos0, lambda tok, pos, s: lm.step(tok, s), _reorder,
                           num_beams=K, eos_token_id=eos_token_id, pad_token_id=pad_token_id,
                           max_new_tokens=max_length - 1, min_new_tokens=min_length - 1,
                           length_penalty=length_penalty)
    return _with_start(ids, bos_token_id)


@torch.no_grad()
def decode_captions(cir_model, lm_head: QFormerLMHead, image_embeds: Tensor, tokenizer, *,
                    max_length: int = 30, min_length: int = 10, num_beams: int = 3,
                    stats: Optional[Dict[str, float]] = None) -> Tensor:
    """The caption ids [B, max_length] of ``image_embeds`` (a CIR model's
    ``encode_image`` rows): the model's query tokens decode through its
    Q-Former and ``lm_head`` from ``[DEC]`` (the tokenizer's ``bos_id``; eos
    its ``[SEP]``, pad its ``[PAD]``), KV-cached, with ``num_beams`` beams (1:
    greedy). ``stats`` receives ``decode_s``."""
    lm = QFormerLM(cir_model.qformer.cfg, bert=cir_model.qformer, cls=lm_head)
    queries = cir_model.query_tokens.expand(image_embeds.shape[0], -1, -1)
    kw = dict(bos_token_id=tokenizer.bos_id, eos_token_id=tokenizer.sep_id,
              pad_token_id=tokenizer.pad_id, max_length=max_length, min_length=min_length)
    with stage(stats, "decode_s", image_embeds.device):
        if num_beams > 1:
            return cached_beam_generate(lm, queries, image_embeds, num_beams=num_beams, **kw)
        return cached_greedy_generate(lm, queries, image_embeds, **kw)


@torch.no_grad()
def generate_captions(cir_model, lm_head: QFormerLMHead, images: Tensor, tokenizer, *,
                      max_length: int = 30, min_length: int = 10, num_beams: int = 3,
                      stats: Optional[Dict[str, float]] = None) -> List[str]:
    """Caption ``images`` [B, H, W, 3] with a CIR model's Q-Former and an LM
    head (``sprc_tpu/models/lm.py:279-322``): the frozen tower (K2) and
    ``ln_vision``, then :func:`decode_captions` (3 beams by default; 1:
    greedy). ``stats`` receives ``tower_s`` and ``decode_s``."""
    with stage(stats, "tower_s", images.device):
        frozen = cir_model.encode_image(images)
    ids = decode_captions(cir_model, lm_head, frozen, tokenizer, max_length=max_length,
                          min_length=min_length, num_beams=num_beams, stats=stats)
    return [tokenizer.decode(row) for row in ids.cpu().numpy()]


def qformer_lm_state_from_torch(sd: Mapping[str, Tensor],
                                prefix: str = "Qformer.") -> Dict[str, Tensor]:
    """A LAVIS ``BertLMHeadModel`` state dict (``Qformer.bert.*``,
    ``Qformer.cls.predictions.*``) -> :class:`QFormerLM`'s, for a strict
    load (``qformer_lm_params_from_torch``): the prefix taken off; the tied
    ``cls.predictions.bias`` is the decoder's bias where the file holds no
    ``decoder.bias``, and dropped where it does."""
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    bias = out.pop("cls.predictions.bias", None)
    if bias is not None:
        out.setdefault("cls.predictions.decoder.bias", bias)
    return out
