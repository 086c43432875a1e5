"""The T5 encoder-decoder of the ``blip2_t5`` caption head (counterpart of
``sprc_tpu/models/t5.py``; reference HF ``T5ForConditionalGeneration``,
FlanT5 being T5 v1.1).

RMS LayerNorm (no mean, no bias, in fp32), one bucketed relative-position
table a stack (held by the stack's first block, as HF holds it),
attention WITHOUT the ``1/sqrt(d)`` scale, pre-LN blocks, a gated-GELU
(tanh) FF for v1.1 or a ReLU FF for v1.0, and an untied ``lm_head`` (FlanT5)
or the tied head scaled by ``d_model ** -0.5`` (v1.0). Masks add -1e9 in
fp32 and softmax runs in fp32, as the JAX module does.

Module names are HF's (``encoder.block.{i}.layer.0.SelfAttention.q``,
``layer.0.layer_norm``, ``decoder.block.{i}.layer.1.EncDecAttention``,
``layer.{1|2}.DenseReluDense.wi_0``, ``encoder.block.0.layer.0.
SelfAttention.relative_attention_bias``, ``final_layer_norm``, ``shared``,
``lm_head``).

The cached decode (:meth:`T5ForConditionalGeneration.decode_prefill`,
:meth:`~T5ForConditionalGeneration.decode_step_logits`) keeps a self-attention
``(k, v)`` pair [B, s_max, H, D] a decoder block, written in place, and the
cross-attention's K/V of the encoder memory, projected once at prefill. The
decode position is the same for every row (the decoder starts from one
start token); it is passed as a one-element tensor, so no step reads the
device. Every product is ``torch.matmul``: the JAX model is plain dense
layers and einsum, no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sprc_tpu_torch.models.opt import NEG, attend, write_cache
from sprc_tpu_torch.ops.layers import Linear

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 2048
    d_kv: int = 64
    d_ff: int = 5120
    num_heads: int = 32
    num_layers: int = 24
    num_decoder_layers: int = 24
    relative_buckets: int = 32
    relative_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    gated_act: bool = True  # v1.1 / flan: gelu-gated; False = v1.0 relu
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.float32


class T5LayerNorm(nn.Module):
    """RMS norm in fp32: no mean, no bias; cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: Tensor) -> Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.weight).to(x.dtype)


def relative_bucket(rel_pos: Tensor, *, bidirectional: bool, num_buckets: int,
                    max_distance: int) -> Tensor:
    """The JAX package's ``_relative_bucket`` step for step (not HF's): the
    ``+ 1e-9`` inside the fp32 log, then truncation to int32."""
    rel_pos = rel_pos.to(torch.int32)
    ret = torch.zeros_like(rel_pos)
    n = -rel_pos
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    denom = torch.tensor(np.log(max_distance / max_exact), dtype=torch.float32)
    val_large = max_exact + (torch.log(n.float() / max_exact + 1e-9) / denom
                             * (num_buckets - max_exact)).to(torch.int32)
    val_large = val_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, relative_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = Linear(cfg.d_model, inner, cfg.dtype, bias=False)
        self.k = Linear(cfg.d_model, inner, cfg.dtype, bias=False)
        self.v = Linear(cfg.d_model, inner, cfg.dtype, bias=False)
        self.o = Linear(inner, cfg.d_model, cfg.dtype, bias=False)
        if relative_bias:  # the stack's one table, in its first block (HF's place)
            self.relative_attention_bias = nn.Embedding(cfg.relative_buckets, cfg.num_heads)
            self.relative_attention_bias.init_std = 1.0

    def project_kv(self, kv: Tensor) -> Tuple[Tensor, Tensor]:
        B, Sk, _ = kv.shape
        H, D = self.cfg.num_heads, self.cfg.d_kv
        return self.k(kv).view(B, Sk, H, D), self.v(kv).view(B, Sk, H, D)

    def forward(self, x: Tensor, kv: Optional[Tensor], bias: Tensor,
                positions: Optional[Tensor] = None,
                cache: Optional[Tuple[Tensor, Tensor]] = None,
                static_kv: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
        """``static_kv``: the cross-attention's K/V projected at prefill;
        ``cache``: the self-attention's buffers, written at ``positions``."""
        B, S, _ = x.shape
        q = self.q(x).view(B, S, self.cfg.num_heads, self.cfg.d_kv)
        k, v = static_kv if static_kv is not None else self.project_kv(kv)
        if cache is not None:
            k, v = write_cache(cache, k, v, positions)
        return self.o(attend(q, k, v, bias, None))  # T5: no 1/sqrt(d)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, relative_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class T5LayerCrossAttention(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.EncDecAttention = T5Attention(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class T5DenseReluDense(nn.Module):
    """Gated GELU (tanh approximation) for v1.1, ReLU for v1.0."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.gated = cfg.gated_act
        if cfg.gated_act:
            self.wi_0 = Linear(cfg.d_model, cfg.d_ff, cfg.dtype, bias=False)
            self.wi_1 = Linear(cfg.d_model, cfg.d_ff, cfg.dtype, bias=False)
        else:
            self.wi = Linear(cfg.d_model, cfg.d_ff, cfg.dtype, bias=False)
        self.wo = Linear(cfg.d_ff, cfg.d_model, cfg.dtype, bias=False)

    def forward(self, x: Tensor) -> Tensor:
        if self.gated:
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = torch.relu(self.wi(x))
        return self.wo(h)


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseReluDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, is_decoder: bool, relative_bias: bool):
        super().__init__()
        self.is_decoder = is_decoder
        parts = [T5LayerSelfAttention(cfg, relative_bias)]
        if is_decoder:
            parts.append(T5LayerCrossAttention(cfg))
        parts.append(T5LayerFF(cfg))
        self.layer = nn.ModuleList(parts)

    def cross_project(self, enc_out: Tensor) -> Tuple[Tensor, Tensor]:
        return self.layer[1].EncDecAttention.project_kv(enc_out)

    def forward(self, x: Tensor, self_bias: Tensor, enc_out: Optional[Tensor] = None,
                cross_bias: Optional[Tensor] = None, positions: Optional[Tensor] = None,
                cache: Optional[Tuple[Tensor, Tensor]] = None,
                cross_kv: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
        sa = self.layer[0]
        h = sa.layer_norm(x)
        x = x + sa.SelfAttention(h, h, self_bias, positions, cache)
        if self.is_decoder:
            ca = self.layer[1]
            x = x + ca.EncDecAttention(ca.layer_norm(x), enc_out, cross_bias,
                                       static_kv=cross_kv)
        ff = self.layer[-1]
        return x + ff.DenseReluDense(ff.layer_norm(x))


def cross_bias(enc_mask: Optional[Tensor], s_enc: int, device) -> Tensor:
    if enc_mask is not None:
        return (1.0 - enc_mask.float())[:, None, None, :] * NEG
    return torch.zeros(1, 1, 1, s_enc, device=device)


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, is_decoder: bool, num_layers: int):
        super().__init__()
        self.cfg = cfg
        self.is_decoder = is_decoder
        self.block = nn.ModuleList(T5Block(cfg, is_decoder, relative_bias=(i == 0))
                                   for i in range(num_layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)

    def rel_bias(self, q_len: int, k_len: int, q_positions: Optional[Tensor] = None) -> Tensor:
        """[1, H, q, k]: the stack's table at the buckets of (key - query)."""
        cfg = self.cfg
        table = self.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        ctx = (torch.arange(q_len, device=table.device)[:, None] if q_positions is None
               else q_positions.reshape(-1, 1))
        mem = torch.arange(k_len, device=table.device)[None, :]
        buckets = relative_bucket(mem - ctx, bidirectional=not self.is_decoder,
                                  num_buckets=cfg.relative_buckets,
                                  max_distance=cfg.relative_max_distance)
        return table[buckets.long()].permute(2, 0, 1)[None]

    def forward(self, inputs_embeds: Tensor, attention_mask: Optional[Tensor] = None,
                enc_out: Optional[Tensor] = None, enc_mask: Optional[Tensor] = None) -> Tensor:
        S = inputs_embeds.shape[1]
        self_bias = self.rel_bias(S, S)
        if attention_mask is not None:
            self_bias = self_bias + (1.0 - attention_mask.float())[:, None, None, :] * NEG
        if self.is_decoder:
            causal = torch.tril(torch.ones(S, S, device=inputs_embeds.device))
            self_bias = self_bias + (1.0 - causal)[None, None] * NEG
        xbias = None if enc_out is None else cross_bias(enc_mask, enc_out.shape[1],
                                                        enc_out.device)
        x = inputs_embeds.to(self.cfg.dtype)
        for block in self.block:
            x = block(x, self_bias, enc_out, xbias)
        return self.final_layer_norm(x)

    def prefill(self, inputs_embeds: Tensor, enc_out: Tensor, enc_mask: Optional[Tensor],
                s_max: int) -> Tuple[Tensor, List[Dict[str, Tensor]]]:
        """The decoder's prefix (left-aligned, no pads) filling the
        self-attention caches, and the cross-attention's K/V projected once
        -> (hidden, cache)."""
        assert self.is_decoder
        cfg = self.cfg
        B, P, _ = inputs_embeds.shape
        device = inputs_embeds.device
        causal = (torch.arange(s_max, device=device)[None, :]
                  <= torch.arange(P, device=device)[:, None])
        self_bias = self.rel_bias(P, s_max) + torch.where(causal, 0.0, NEG)[None, None]
        xbias = cross_bias(enc_mask, enc_out.shape[1], device)
        positions = torch.arange(P, device=device)
        x = inputs_embeds.to(cfg.dtype)
        cache = []
        for block in self.block:
            ck, cv = block.cross_project(enc_out)
            pair = tuple(torch.zeros(B, s_max, cfg.num_heads, cfg.d_kv, dtype=cfg.dtype,
                                     device=device) for _ in range(2))
            x = block(x, self_bias, enc_out, xbias, positions, pair, (ck, cv))
            cache.append({"k": pair[0], "v": pair[1], "ck": ck, "cv": cv})
        return self.final_layer_norm(x), cache

    def decode_step(self, embed_t: Tensor, t: Tensor, cache: List[Dict[str, Tensor]],
                    enc_mask: Optional[Tensor]) -> Tuple[Tensor, List[Dict[str, Tensor]]]:
        """One cached position ``t`` (a one-element tensor, the same for
        every row): embed_t [B, 1, d] -> (hidden [B, 1, d], cache)."""
        assert self.is_decoder
        s_max = cache[0]["k"].shape[1]
        t = t.reshape(1)
        valid = torch.arange(s_max, device=t.device)[None, None, None, :] <= t
        self_bias = self.rel_bias(1, s_max, q_positions=t) + torch.where(valid, 0.0, NEG)
        xbias = cross_bias(enc_mask, cache[0]["ck"].shape[1], t.device)
        x = embed_t.to(self.cfg.dtype)
        for block, entry in zip(self.block, cache):
            x = block(x, self_bias, None, xbias, t, (entry["k"], entry["v"]),
                      (entry["ck"], entry["cv"]))
        return self.final_layer_norm(x), cache


class T5ForConditionalGeneration(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.shared.init_std = 1.0  # the JAX init's normal(1.0)
        self.encoder = T5Stack(cfg, False, cfg.num_layers)
        self.decoder = T5Stack(cfg, True, cfg.num_decoder_layers)
        if not cfg.tie_word_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.vocab_size, cfg.dtype, bias=False)

    def embed(self, input_ids: Tensor) -> Tensor:
        return self.shared(input_ids)

    def encode(self, inputs_embeds: Tensor, attention_mask: Optional[Tensor] = None) -> Tensor:
        return self.encoder(inputs_embeds, attention_mask)

    def encode_ids(self, input_ids: Tensor, attention_mask: Optional[Tensor] = None) -> Tensor:
        return self.encoder(self.shared(input_ids), attention_mask)

    def lm_logits(self, hidden: Tensor) -> Tensor:
        """Tied (v1.0): ``hidden * d_model ** -0.5`` against ``shared`` in
        fp32; untied (FlanT5): ``lm_head``."""
        if self.cfg.tie_word_embeddings:
            hidden = hidden * self.cfg.d_model ** -0.5
            return torch.matmul(hidden.float(), self.shared.weight.float().t())
        return self.lm_head(hidden)

    def decode(self, decoder_input_ids: Tensor, enc_out: Tensor,
               enc_mask: Optional[Tensor] = None,
               decoder_mask: Optional[Tensor] = None) -> Tensor:
        hidden = self.decoder(self.shared(decoder_input_ids), decoder_mask, enc_out, enc_mask)
        return self.lm_logits(hidden)

    def decode_prefill(self, decoder_input_ids: Tensor, enc_out: Tensor,
                       enc_mask: Optional[Tensor], s_max: int):
        """-> (logits at the last prefix position [B, V], cache)."""
        hidden, cache = self.decoder.prefill(self.shared(decoder_input_ids), enc_out, enc_mask,
                                             s_max)
        return self.lm_logits(hidden[:, -1:, :])[:, 0, :], cache

    def decode_step_logits(self, tok: Tensor, t: Tensor, cache, enc_mask: Optional[Tensor] = None):
        """tok [B] at position ``t`` -> (next-token logits [B, V], cache)."""
        hidden, cache = self.decoder.decode_step(self.shared(tok)[:, None, :], t, cache, enc_mask)
        return self.lm_logits(hidden)[:, 0, :], cache

    def forward(self, input_ids: Tensor, decoder_input_ids: Tensor,
                attention_mask: Optional[Tensor] = None,
                decoder_mask: Optional[Tensor] = None) -> Tensor:
        enc = self.encode_ids(input_ids, attention_mask)
        return self.decode(decoder_input_ids, enc, attention_mask, decoder_mask)
