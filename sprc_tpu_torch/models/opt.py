"""The OPT decoder of the ``blip2_opt`` caption head (counterpart of
``sprc_tpu/models/opt.py``; reference HF ``OPTForCausalLM``).

Pre-LN decoder layers with a ReLU MLP, learned positions with OPT's +2
offset counted from the attention mask (``cumsum(mask) * mask - 1 + 2``,
clamped at 0), a final LayerNorm and the LM head tied to the token
embeddings, computed in fp32. Attention adds an fp32 bias of 0 / -1e9 to
the scaled scores and takes its softmax in fp32, as the JAX module does.

Module names are HF's (``model.decoder.layers.{i}.self_attn.q_proj``,
``self_attn_layer_norm``, ``fc1``, ``final_layer_norm``,
``model.decoder.embed_positions``), so an ``OPTForCausalLM`` state dict
without its tied ``lm_head.weight`` loads with ``strict=True``.

The K/V cache (:meth:`OPTForCausalLM.prefill`, :meth:`~OPTForCausalLM.
decode_step`) is one preallocated ``(k, v)`` pair [B, s_max, H, D] a layer,
written in place at each row's buffer position: the JAX functional cache
done as buffers. Right-padded prompts decode into their pad slots, so each
row's valid columns stay contiguous. Every product is ``torch.matmul``: the
JAX decoder is plain einsum and dense layers, no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from sprc_tpu_torch.ops.layers import LayerNormFP32, Linear

Tensor = torch.Tensor
Cache = List[Tuple[Tensor, Tensor]]
NEG = -1e9  # the additive mask of the LLM heads (fp32)


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 2560
    ffn_dim: int = 10240
    num_layers: int = 32
    num_heads: int = 32
    max_positions: int = 2048
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def write_cache(cache: Tuple[Tensor, Tensor], k: Tensor, v: Tensor,
                positions: Tensor) -> Tuple[Tensor, Tensor]:
    """Scatter k / v [B, S, H, D] into the cache pair at ``positions`` ([S]
    for every row, or [B, S]) in place; returns the pair."""
    B, S = k.shape[:2]
    pos = positions.expand(B, S) if positions.dim() == 1 else positions
    rows = torch.arange(B, device=k.device)[:, None].expand(B, S)
    ck, cv = cache
    ck[rows, pos] = k.to(ck.dtype)
    cv[rows, pos] = v.to(cv.dtype)
    return ck, cv


def attend(q: Tensor, k: Tensor, v: Tensor, bias: Tensor, scale: Optional[float]) -> Tensor:
    """[B, S, H, D] x [B, Sk, H, D] -> [B, S, H * D]: fp32 scores (times
    ``scale`` where given) plus ``bias``, softmax in fp32."""
    B, S, H, D = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    if scale is not None:
        scores = scores * scale
    probs = torch.softmax(scores + bias, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v).reshape(B, S, H * D)


class OPTAttention(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.q_proj = Linear(h, h, cfg.dtype)
        self.k_proj = Linear(h, h, cfg.dtype)
        self.v_proj = Linear(h, h, cfg.dtype)
        self.out_proj = Linear(h, h, cfg.dtype)

    def forward(self, x: Tensor, bias: Tensor, positions: Optional[Tensor] = None,
                cache: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        H, D = cfg.num_heads, cfg.head_dim
        q = self.q_proj(x).view(B, S, H, D)
        k = self.k_proj(x).view(B, S, H, D)
        v = self.v_proj(x).view(B, S, H, D)
        if cache is not None:
            k, v = write_cache(cache, k, v, positions)
        return self.out_proj(attend(q, k, v, bias, D ** -0.5))


class OPTDecoderLayer(nn.Module):
    """Pre-LN layer with a ReLU MLP (``do_layer_norm_before``)."""

    def __init__(self, cfg: OPTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.self_attn_layer_norm = LayerNormFP32(h, 1e-5)
        self.self_attn = OPTAttention(cfg)
        self.final_layer_norm = LayerNormFP32(h, 1e-5)
        self.fc1 = Linear(h, cfg.ffn_dim, cfg.dtype)
        self.fc2 = Linear(cfg.ffn_dim, h, cfg.dtype)

    def forward(self, x: Tensor, bias: Tensor, positions: Optional[Tensor] = None,
                cache: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x), bias, positions, cache)
        return x + self.fc2(torch.relu(self.fc1(self.final_layer_norm(x))))


class OPTDecoder(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        # OPT's learned positions are offset by 2 (the padding_idx legacy)
        self.embed_positions = nn.Embedding(cfg.max_positions + 2, cfg.hidden_size)
        self.layers = nn.ModuleList(OPTDecoderLayer(cfg) for _ in range(cfg.num_layers))
        self.final_layer_norm = LayerNormFP32(cfg.hidden_size, 1e-5)


class OPTModel(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.decoder = OPTDecoder(cfg)


def _positions(mask: Tensor) -> Tensor:
    """OPT's positions from the attention mask: cumsum - 1 + 2, clamped at 0."""
    return (torch.cumsum(mask, dim=1) * mask - 1 + 2).clamp_min(0)


class OPTForCausalLM(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.cfg = cfg
        self.model = OPTModel(cfg)

    @property
    def decoder(self) -> OPTDecoder:
        return self.model.decoder

    def embed(self, input_ids: Tensor) -> Tensor:
        return self.decoder.embed_tokens(input_ids)

    def _inputs(self, inputs_embeds: Tensor, attention_mask: Tensor) -> Tensor:
        pos = self.decoder.embed_positions(_positions(attention_mask.long()))
        return inputs_embeds.to(self.cfg.dtype) + pos.to(self.cfg.dtype)

    @staticmethod
    def _allowed(attention_mask: Tensor) -> Tensor:
        """[B, P, P]: causal and the key not a pad."""
        P = attention_mask.shape[1]
        causal = torch.tril(torch.ones(P, P, dtype=torch.bool, device=attention_mask.device))
        return causal[None] & attention_mask.bool()[:, None, :]

    def hidden_states(self, inputs_embeds: Tensor,
                      attention_mask: Optional[Tensor] = None) -> Tensor:
        B, S, _ = inputs_embeds.shape
        if attention_mask is None:
            attention_mask = torch.ones(B, S, dtype=torch.long, device=inputs_embeds.device)
        x = self._inputs(inputs_embeds, attention_mask)
        bias = torch.where(self._allowed(attention_mask)[:, None], 0.0, NEG).float()
        for layer in self.decoder.layers:
            x = layer(x, bias)
        return self.decoder.final_layer_norm(x)

    def prefill(self, inputs_embeds: Tensor, attention_mask: Tensor,
                s_max: int) -> Tuple[Tensor, Cache]:
        """The whole prefix through every layer, filling a cache of
        ``s_max`` positions -> (hidden [B, P, h], cache). The bias is
        ``s_max`` wide: columns past the prefix are masked."""
        cfg = self.cfg
        B, P, _ = inputs_embeds.shape
        x = self._inputs(inputs_embeds, attention_mask)
        bias = torch.full((B, 1, P, s_max), NEG, dtype=torch.float32, device=x.device)
        bias[:, :, :, :P] = torch.where(self._allowed(attention_mask)[:, None], 0.0, NEG)
        kv_pos = torch.arange(P, device=x.device)
        cache: Cache = []
        for layer in self.decoder.layers:
            pair = tuple(torch.zeros(B, s_max, cfg.num_heads, cfg.head_dim, dtype=cfg.dtype,
                                     device=x.device) for _ in range(2))
            x = layer(x, bias, kv_pos, pair)
            cache.append(pair)
        return self.decoder.final_layer_norm(x), cache

    def decode_step(self, tok: Tensor, pos: Tensor, cache: Cache) -> Tuple[Tensor, Cache]:
        """One cached position: tok [B] at each row's buffer position ``pos``
        [B] -> (hidden [B, 1, h], cache). The learned position is pos + 2."""
        cfg = self.cfg
        s_max = cache[0][0].shape[1]
        x = (self.decoder.embed_tokens(tok)[:, None, :].to(cfg.dtype)
             + self.decoder.embed_positions(pos + 2)[:, None, :].to(cfg.dtype))
        valid = torch.arange(s_max, device=tok.device)[None, :] <= pos[:, None]
        bias = torch.where(valid[:, None, None, :], 0.0, NEG).float()
        for layer, pair in zip(self.decoder.layers, cache):
            x = layer(x, bias, pos[:, None], pair)
        return self.decoder.final_layer_norm(x), cache

    def decode_step_logits(self, tok: Tensor, pos: Tensor, cache: Cache) -> Tuple[Tensor, Cache]:
        hidden, cache = self.decode_step(tok, pos, cache)
        return self.logits(hidden)[:, 0, :], cache

    def logits(self, hidden: Tensor) -> Tensor:
        """The LM head, tied to the token embeddings, in fp32."""
        return torch.matmul(hidden.float(), self.decoder.embed_tokens.weight.float().t())

    def forward(self, input_ids: Tensor, attention_mask: Optional[Tensor] = None) -> Tensor:
        return self.logits(self.hidden_states(self.embed(input_ids), attention_mask))
