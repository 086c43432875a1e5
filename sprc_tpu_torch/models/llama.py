"""The LLaMA decoder of the InstructBLIP-style CIR models (counterpart of
``sprc_tpu/models/llama.py``; reference HF ``LlamaForCausalLM``).

Pre-norm layers with an fp32-statistics RMSNorm, rotary position
embeddings in HF's rotate-half layout (the two halves of each head, not
interleaved pairs), grouped-query-capable causal attention (the K/V heads
repeated head by head, ``repeat_interleave``), a SwiGLU MLP, a final
RMSNorm and an untied LM head. Attention adds an fp32 bias of 0 / -1e9 to
the scaled scores and takes its softmax in fp32, as the JAX module does.

Module names are HF's (``model.embed_tokens``,
``model.layers.{i}.self_attn.{q,k,v,o}_proj``,
``mlp.{gate,up,down}_proj``, ``input_layernorm``,
``post_attention_layernorm``, ``model.norm``, ``lm_head``), so a
``LlamaForCausalLM`` state dict loads with ``strict=True``.

The K/V cache (:meth:`LlamaForCausalLM.prefill`,
:meth:`~LlamaForCausalLM.decode_step`) is one preallocated ``(k, v)`` pair
[B, s_max, KV, D] a layer, written in place at each row's buffer position,
as the OPT decoder's. Prefill positions are ``arange(P)`` for every row,
pads included; a decode step takes each row's own position, and its bias
admits the columns up to it, so right-padded prompts decode into their pad
slots. Every product is ``torch.matmul``: the JAX decoder is plain einsum
and dense layers, no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from sprc_tpu_torch.models.opt import NEG, attend, write_cache
from sprc_tpu_torch.models.t5 import T5LayerNorm
from sprc_tpu_torch.ops.layers import Linear

Tensor = torch.Tensor
Cache = List[Tuple[Tensor, Tensor]]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32001
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None: as many as the query heads (MHA)
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


class RMSNorm(T5LayerNorm):
    """LLaMA's RMSNorm: fp32 statistics, the scale applied in fp32, the
    result cast back to the input's dtype (T5's norm, under LLaMA's name)."""


def rotary_embed(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """RoPE on [B, S, H, D] at integer ``positions`` [S] (every row) or
    [B, S] (per row), in fp32, cast back to ``x``'s dtype."""
    D = x.shape[-1]
    if positions.dim() == 1:
        positions = positions[None]
    inv_freq = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D))
    angles = positions.float()[..., None] * inv_freq  # [B?, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    cos, sin = torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        h, D = cfg.hidden_size, cfg.head_dim
        self.q_proj = Linear(h, cfg.num_heads * D, cfg.dtype, bias=False)
        self.k_proj = Linear(h, cfg.kv_heads * D, cfg.dtype, bias=False)
        self.v_proj = Linear(h, cfg.kv_heads * D, cfg.dtype, bias=False)
        self.o_proj = Linear(cfg.num_heads * D, h, cfg.dtype, bias=False)

    def forward(self, x: Tensor, bias: Tensor, positions: Optional[Tensor] = None,
                cache: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        H, KV, D = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = rotary_embed(self.q_proj(x).view(B, S, H, D), positions, cfg.rope_theta)
        k = rotary_embed(self.k_proj(x).view(B, S, KV, D), positions, cfg.rope_theta)
        v = self.v_proj(x).view(B, S, KV, D)
        if cache is not None:
            k, v = write_cache(cache, k, v, positions)
        if KV != H:  # grouped-query heads: each K/V head serves H / KV query heads in a row
            k = k.repeat_interleave(H // KV, dim=2)
            v = v.repeat_interleave(H // KV, dim=2)
        return self.o_proj(attend(q, k, v, bias, D ** -0.5))


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Linear(h, m, cfg.dtype, bias=False)
        self.up_proj = Linear(h, m, cfg.dtype, bias=False)
        self.down_proj = Linear(m, h, cfg.dtype, bias=False)

    def forward(self, x: Tensor) -> Tensor:
        return self.down_proj(torch.nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x: Tensor, bias: Tensor, positions: Optional[Tensor] = None,
                cache: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
        x = x + self.self_attn(self.input_layernorm(x), bias, positions, cache)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaLayer(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps)


def _allowed(attention_mask: Tensor) -> Tensor:
    """[B, P, P]: causal and the key not a pad."""
    P = attention_mask.shape[1]
    causal = torch.tril(torch.ones(P, P, dtype=torch.bool, device=attention_mask.device))
    return causal[None] & attention_mask.bool()[:, None, :]


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, cfg.dtype, bias=False)

    def embed(self, input_ids: Tensor) -> Tensor:
        return self.model.embed_tokens(input_ids)

    def hidden_states(self, inputs_embeds: Tensor,
                      attention_mask: Optional[Tensor] = None) -> Tensor:
        """The trunk over input embeddings (the instruct models prepend the
        projected query rows) -> the final-norm hidden states [B, S, h]."""
        B, S, _ = inputs_embeds.shape
        if attention_mask is None:
            attention_mask = torch.ones(B, S, dtype=torch.long, device=inputs_embeds.device)
        bias = torch.where(_allowed(attention_mask)[:, None], 0.0, NEG).float()
        x = inputs_embeds.to(self.cfg.dtype)
        for layer in self.model.layers:
            x = layer(x, bias)
        return self.model.norm(x)

    def prefill(self, inputs_embeds: Tensor, attention_mask: Optional[Tensor],
                s_max: int) -> Tuple[Tensor, Cache]:
        """The whole prefix through every layer, filling a cache of
        ``s_max`` positions -> (hidden [B, P, h], cache). The bias is
        ``s_max`` wide: columns past the prefix are masked."""
        cfg = self.cfg
        B, P, _ = inputs_embeds.shape
        device = inputs_embeds.device
        if attention_mask is None:
            attention_mask = torch.ones(B, P, dtype=torch.long, device=device)
        bias = torch.full((B, 1, P, s_max), NEG, dtype=torch.float32, device=device)
        bias[:, :, :, :P] = torch.where(_allowed(attention_mask)[:, None], 0.0, NEG)
        positions = torch.arange(P, device=device)
        x = inputs_embeds.to(cfg.dtype)
        cache: Cache = []
        for layer in self.model.layers:
            pair = tuple(torch.zeros(B, s_max, cfg.kv_heads, cfg.head_dim, dtype=cfg.dtype,
                                     device=device) for _ in range(2))
            x = layer(x, bias, positions, pair)
            cache.append(pair)
        return self.model.norm(x), cache

    def decode_step(self, embed_t: Tensor, pos: Tensor, cache: Cache) -> Tuple[Tensor, Cache]:
        """One cached position: ``embed_t`` [B, 1, h] at each row's buffer
        position ``pos`` [B] (its K/V goes to slot pos; it attends the
        columns <= pos) -> (hidden [B, 1, h], cache)."""
        s_max = cache[0][0].shape[1]
        valid = torch.arange(s_max, device=pos.device)[None, :] <= pos[:, None]
        bias = torch.where(valid[:, None, None, :], 0.0, NEG).float()
        x = embed_t.to(self.cfg.dtype)
        for layer, pair in zip(self.model.layers, cache):
            x = layer(x, bias, pos[:, None], pair)
        return self.model.norm(x), cache

    def decode_step_logits(self, tok: Tensor, pos: Tensor, cache: Cache) -> Tuple[Tensor, Cache]:
        """tok [B] -> (the next token's logits [B, V], cache)."""
        hidden, cache = self.decode_step(self.embed(tok)[:, None, :], pos, cache)
        return self.logits(hidden)[:, 0, :], cache

    def logits(self, hidden: Tensor) -> Tensor:
        return self.lm_head(hidden)

    def forward(self, input_ids: Tensor, attention_mask: Optional[Tensor] = None) -> Tensor:
        return self.logits(self.hidden_states(self.embed(input_ids), attention_mask))
