"""TimeSformer, divided space-time attention (counterpart of
``sprc_tpu/models/timesformer.py``; reference lavis/models/timesformer/
vit.py:134-258 ``Block``, :300-460 ``VisionTransformer``).

A ViT-B/16 trunk over ``[B, T, H, W, 3]`` NHWC frames whose every block runs

1. temporal attention over the T frames of each spatial location
   (``temporal_norm1``, ``temporal_attn``, then ``temporal_fc``, a residual);
2. spatial attention over each frame's ``1 + N`` tokens, the CLS replicated
   into every frame and its outputs averaged over the frames afterwards;
3. the MLP over ``[CLS; tokens]`` (``norm2``, ``mlp.fc1``, exact GELU,
   ``mlp.fc2``).

Tokens stay in the factored ``[B, T, N, C]`` layout with the CLS ``[B, 1,
C]`` beside them, as in the JAX module; ``forward_features`` returns ALPRO's
pooled ``[B, 1 + N, C]`` (the CLS and the frame-mean tokens, vit.py:595-609),
``forward_tokens`` the whole ``[B, 1 + N T, C]`` in the reference's ``(h w
t)`` order (for the tests). ``temporal_fc`` is zero-initialised in the
blocks after the first only (vit.py:373-383): ``loader.init_weights`` reads
its ``init_std`` of 0. The frames' ``time_embed`` rows are the first T of
the table (the QA YAMLs build 16 and sample 8).

The dense products are :class:`~sprc_tpu_torch.ops.layers.Linear` and the
LayerNorms :class:`~sprc_tpu_torch.ops.layers.LayerNormFP32` in plain
PyTorch, as the JAX module runs them outside any kernel (fp32, the JAX
default). Both attentions go through
:func:`sprc_tpu_torch.ops.attention.dot_product_attention` on BSHD views of
the packed qkv: the temporal one (T rows, under the 128-row floor) takes the
plain einsum path in both packages; the spatial one (``1 + N`` = 197 rows,
no bias) launches kernel K8 (``flash_attention``) on CUDA tensors, through
its ``FlashAttention`` Function where autograd records, as the JAX package
reaches its Pallas ``flash_attention`` on a TPU. Dropout (``dropout_rate``,
0 by default) is drawn from the caller's generator in training mode.

Module names are LAVIS's (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``time_embed``, ``blocks.{i}.temporal_norm1``,
``temporal_attn.{qkv,proj}``, ``temporal_fc``, ``norm1``,
``attn.{qkv,proj}``, ``norm2``, ``mlp.{fc1,fc2}``, ``norm``), so a released
trunk loads by name (the patch conv as LAVIS's OIHW).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from sprc_tpu_torch.models.qformer import training
from sprc_tpu_torch.ops import attention, primitives
from sprc_tpu_torch.ops.layers import LayerNormFP32, Linear, dropout

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TimeSformerConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_hidden: int = 3072
    num_frames: int = 8
    layer_norm_eps: float = 1e-6
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.float32

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads


class Attention(nn.Module):
    """timm's attention: packed ``qkv`` with its bias, ``proj``."""

    def __init__(self, cfg: TimeSformerConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = Linear(cfg.width, 3 * cfg.width, dtype=cfg.dtype)
        self.proj = Linear(cfg.width, cfg.width, dtype=cfg.dtype)

    def forward(self, x: Tensor, drop) -> Tensor:
        B, S, C = x.shape
        H, D = self.cfg.num_heads, self.cfg.head_dim
        qkv = self.qkv(x)
        q, k, v = (qkv[..., i * C:(i + 1) * C].view(B, S, H, D) for i in range(3))
        ctx = attention.dot_product_attention(q, k, v).reshape(B, S, C)
        return drop(self.proj(ctx))


class Mlp(nn.Module):
    def __init__(self, cfg: TimeSformerConfig):
        super().__init__()
        self.fc1 = Linear(cfg.width, cfg.mlp_hidden, dtype=cfg.dtype)
        self.fc2 = Linear(cfg.mlp_hidden, cfg.width, dtype=cfg.dtype)

    def forward(self, x: Tensor, drop) -> Tensor:
        return drop(self.fc2(drop(primitives.gelu(self.fc1(x)))))


class DividedBlock(nn.Module):
    """One divided space-time block over (tokens [B, T, N, C], CLS [B, 1, C])."""

    def __init__(self, cfg: TimeSformerConfig, zero_init_temporal_fc: bool):
        super().__init__()
        C, eps = cfg.width, cfg.layer_norm_eps
        self.temporal_norm1 = LayerNormFP32(C, eps)
        self.temporal_attn = Attention(cfg)
        self.temporal_fc = Linear(C, C, dtype=cfg.dtype)
        if zero_init_temporal_fc:
            self.temporal_fc.init_std = 0.0
        self.norm1 = LayerNormFP32(C, eps)
        self.attn = Attention(cfg)
        self.norm2 = LayerNormFP32(C, eps)
        self.mlp = Mlp(cfg)

    def forward(self, x: Tensor, cls: Tensor, drop) -> Tuple[Tensor, Tensor]:
        B, T, N, C = x.shape
        # temporal attention over the frames of each location (vit.py:210-224)
        h = self.temporal_norm1(x).transpose(1, 2).reshape(B * N, T, C)
        h = self.temporal_attn(h, drop).reshape(B, N, T, C).transpose(1, 2)
        xt = x + self.temporal_fc(h)
        # spatial attention per frame, the CLS replicated (:226-247)
        cls_rep = cls[:, None].to(x.dtype).expand(B, T, 1, C).reshape(B * T, 1, C)
        xs = torch.cat([cls_rep, xt.reshape(B * T, N, C)], dim=1)
        so = self.attn(self.norm1(xs), drop)
        cls_out = so[:, 0].reshape(B, T, C).mean(dim=1, keepdim=True)
        x_new = xt + so[:, 1:].reshape(B, T, N, C)
        cls_new = cls + cls_out
        # the MLP over [CLS; tokens] (:253-260), token-wise, so applied per part
        cls_new = cls_new + self.mlp(self.norm2(cls_new), drop)
        return x_new + self.mlp(self.norm2(x_new), drop), cls_new


class PatchEmbed(nn.Module):
    def __init__(self, cfg: TimeSformerConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.width, kernel_size=p, stride=p, bias=True, dtype=cfg.dtype)


class TimeSformer(nn.Module):
    """The divided space-time trunk; see the module docstring for layouts."""

    def __init__(self, cfg: TimeSformerConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.width
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.empty(1, 1, C))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches + 1, C))
        self.time_embed = nn.Parameter(torch.empty(1, cfg.num_frames, C))
        self.blocks = nn.ModuleList(DividedBlock(cfg, i > 0) for i in range(cfg.depth))
        self.norm = LayerNormFP32(C, cfg.layer_norm_eps)

    def trunk(self, video: Tensor, generator: Optional[torch.Generator] = None):
        """[B, T, H, W, 3] -> (tokens [B, T, N, C], CLS [B, 1, C]), normed."""
        cfg = self.cfg
        B, T, H, W, _ = video.shape
        conv = self.patch_embed.proj
        x = conv(video.reshape(B * T, H, W, 3).to(conv.weight.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2).reshape(B, T, -1, cfg.width)
        # spatial positions per frame, the frame's time row (vit.py:415-450);
        # the CLS takes pos_embed[0]
        x = x + self.pos_embed[:, 1:][:, None].to(x.dtype)
        x = x + self.time_embed[:, :T, None, :].to(x.dtype)
        cls = (self.cls_token + self.pos_embed[:, :1]).to(x.dtype).expand(B, 1, cfg.width)
        rate = cfg.dropout_rate if training(self) else 0.0

        def drop(h):
            return dropout(h, rate, generator)

        for block in self.blocks:
            x, cls = block(x, cls, drop)
        return self.norm(x), self.norm(cls)

    def forward(self, video: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        return self.forward_features(video, generator)

    def forward_features(self, video: Tensor,
                         generator: Optional[torch.Generator] = None) -> Tensor:
        """ALPRO's pooled features [B, 1 + N, C] fp32: the CLS and the
        frame-mean tokens."""
        x, cls = self.trunk(video, generator)
        return torch.cat([cls, x.mean(dim=1)], dim=1).float()

    def forward_tokens(self, video: Tensor,
                       generator: Optional[torch.Generator] = None) -> Tensor:
        """The whole sequence [B, 1 + N T, C] fp32 in the reference's (h w t)
        order (the frame index fastest)."""
        x, cls = self.trunk(video, generator)
        B, T, N, C = x.shape
        return torch.cat([cls, x.transpose(1, 2).reshape(B, N * T, C)], dim=1).float()
