"""The GPT-2 video-dialogue model (counterpart of
``sprc_tpu/models/gpt_dialogue.py``; reference
src/lavis/models/gpt_models/gpt_dialogue.py:18-110), registered as
``gpt_dialogue``.

GPT-2 over ``[projected video features | token embeddings]`` with token-type
embeddings, trained with the shifted cross-entropy of the text (labels -1
ignored) plus a shifted MSE that reconstructs the video features. The trunk
keeps HF's module names and its ``Conv1D`` layout (weights ``[in, out]``,
``y = x W + b``), so an HF ``GPT2LMHeadModel`` file loads into
``model.transformer`` by name (:func:`gpt2_state_from_hf`).

What the JAX function does and the port follows:

- the LM head is tied to ``wte``: the logits are ``hidden @ wte.weight^T``
  through the one parameter, whose gradient gathers the head's, the token
  embedding's and the token-type embedding's parts (token types are
  embedded through ``wte``, as HF's GPT-2 embeds them);
- ``gelu_new`` (tanh), pre-LN blocks, and the causal mask combined with the
  padding mask as a -1e9 fp32 bias;
- no dropout: the JAX model has none and applies deterministically;
- the text loss sums the valid positions' NLL and divides by
  ``max(valid, 1)``; the video loss is the mean square over the whole
  padded prefix, pad frames (1.0) included;
- ``video_ff`` is ``nn.Linear(len_video_ft, n_embd)`` (JAX infers the input
  width from the data; here a feature width that is not ``len_video_ft``
  raises and names both), and a sequence longer than ``n_positions``
  raises (JAX's gather clamps the positions).

Everything is fp32, and every product computes in its input's dtype, so the
model moved to float64 is its own float64 reference. The attention is the
plain ``matmul`` / ``softmax`` the JAX function runs (no Pallas kernel
there, so none here).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sprc_tpu_torch.registry import registry

Tensor = torch.Tensor
MASK_BIAS = -1e9


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_positions: int = 1024
    layer_norm_eps: float = 1e-5


class Conv1D(nn.Module):
    """HF's ``Conv1D``: ``weight [in, out]``, ``y = x W + b``."""

    def __init__(self, nx: int, nf: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(nx, nf))
        self.bias = nn.Parameter(torch.empty(nf))

    def forward(self, x: Tensor) -> Tensor:
        y = torch.addmm(self.bias, x.reshape(-1, x.shape[-1]), self.weight)
        return y.view(*x.shape[:-1], self.weight.shape[1])


class GPT2Attention(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.n_head = cfg.n_head
        self.c_attn = Conv1D(cfg.n_embd, 3 * cfg.n_embd)
        self.c_proj = Conv1D(cfg.n_embd, cfg.n_embd)

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        B, S, C = x.shape
        H, D = self.n_head, C // self.n_head
        q, k, v = (t.view(B, S, H, D).transpose(1, 2) for t in self.c_attn(x).split(C, dim=-1))
        scores = torch.matmul(q, k.transpose(-1, -2)) * D ** -0.5 + bias.to(x.dtype)
        ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
        return self.c_proj(ctx.transpose(1, 2).reshape(B, S, C))


class GPT2MLP(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.c_fc = Conv1D(cfg.n_embd, 4 * cfg.n_embd)
        self.c_proj = Conv1D(4 * cfg.n_embd, cfg.n_embd)

    def forward(self, x: Tensor) -> Tensor:
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class GPT2Block(nn.Module):
    """Pre-LN: ``x + attn(ln_1(x))``, then ``x + mlp(ln_2(x))``."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_eps)
        self.attn = GPT2Attention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_eps)
        self.mlp = GPT2MLP(cfg)

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        x = x + self.attn(self.ln_1(x), bias)
        return x + self.mlp(self.ln_2(x))


class GPT2Model(nn.Module):
    """The trunk over ``inputs_embeds`` (HF's ``GPT2Model`` names)."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd)
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd)
        self.wpe.init_std = 0.01  # the JAX init's
        self.h = nn.ModuleList(GPT2Block(cfg) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_eps)

    def forward(self, inputs_embeds: Tensor, attention_mask: Optional[Tensor] = None,
                token_type_ids: Optional[Tensor] = None) -> Tensor:
        B, S, _ = inputs_embeds.shape
        if S > self.cfg.n_positions:
            raise ValueError(f"sequence of {S} positions: GPT-2 has {self.cfg.n_positions}")
        x = inputs_embeds + self.wpe.weight[:S].to(inputs_embeds.dtype)[None]
        if token_type_ids is not None:  # HF's GPT-2 embeds token types through wte
            x = x + self.wte(token_type_ids).to(x.dtype)
        allowed = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()[None]
        if attention_mask is not None:
            allowed = allowed & attention_mask.bool()[:, None, :]
        bias = torch.zeros(allowed.shape, device=x.device).masked_fill(~allowed, MASK_BIAS)[:, None]
        for block in self.h:
            x = block(x, bias)
        return self.ln_f(x)

    def logits(self, hidden: Tensor) -> Tensor:
        """The LM head, tied to ``wte``."""
        return torch.matmul(hidden, self.wte.weight.to(hidden.dtype).t())


@dataclasses.dataclass(frozen=True)
class GPTDialogueConfig:
    gpt: GPT2Config = GPT2Config()
    len_video_ft: int = 4224  # two 2048-wide I3D streams and the 128-wide VGGish


@registry.register_model("gpt_dialogue")
class GPTDialogue(nn.Module):
    """GPT-2 over ``[video prefix | dialogue tokens]`` (reference :36-103)."""

    CONFIG = GPTDialogueConfig

    def __init__(self, cfg: GPTDialogueConfig):
        super().__init__()
        self.cfg = cfg
        E = cfg.gpt.n_embd
        self.transformer = GPT2Model(cfg.gpt)
        self.video_ff = nn.Linear(cfg.len_video_ft, E)
        self.video_ff_out = nn.Linear(E, cfg.len_video_ft)

    def forward(self, input_ids: Tensor, video_fts: Tensor, attn_mask: Tensor,
                token_type_ids: Tensor, labels: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """input_ids [B, L], video_fts [B, T, len_video_ft], attn_mask and
        token_type_ids [B, T + L], labels [B, T + L] (-1: ignored) ->
        ``{"logits" [B, T + L, V], "loss"}``."""
        if video_fts.shape[-1] != self.cfg.len_video_ft:
            raise ValueError(f"video features {video_fts.shape[-1]} wide: the model's "
                             f"len_video_ft is {self.cfg.len_video_ft}")
        dtype = self.video_ff.weight.dtype
        embs = torch.cat([self.video_ff(video_fts.to(dtype)),
                          self.transformer.wte(input_ids).to(dtype)], dim=1)
        hidden = self.transformer(embs, attn_mask, token_type_ids)
        logits = self.transformer.logits(hidden)
        loss = torch.zeros((), dtype=dtype, device=logits.device)
        if labels is not None:
            shift = labels[:, 1:].long()
            valid = shift != -1
            logp = torch.log_softmax(logits[:, :-1], dim=-1)
            nll = -logp.gather(-1, torch.where(valid, shift, 0)[..., None])[..., 0]
            loss = loss + (nll * valid).sum() / valid.sum().clamp_min(1)
        T = video_fts.shape[1]
        video_logits = self.video_ff_out(hidden[:, :T])
        video_loss = (video_logits[:, :-1] - video_fts[:, 1:].to(dtype)).square().mean()
        return {"logits": logits, "loss": loss + video_loss}


def gpt2_state_from_hf(sd: Mapping[str, Tensor], prefix: str = "transformer.") -> Dict[str, Tensor]:
    """An HF ``GPT2LMHeadModel`` / ``GPT2Model`` state dict -> the state dict
    of :class:`GPT2Model` (``model.transformer``), for a strict load: the
    ``prefix`` taken off, the ``attn.bias`` / ``attn.masked_bias`` mask
    buffers and the tied ``lm_head.weight`` dropped. Conv1D weights are
    ``[in, out]`` in both, so nothing is transposed (the counterpart of
    ``gpt2_params_from_hf``)."""
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix) and not k.endswith((".attn.bias", ".attn.masked_bias"))}
