"""CLIP, the contrastive image-text model (counterpart of
``sprc_tpu/models/clip.py``; registry ``clip``, ``clip_feature_extractor``;
reference lavis/models/clip_models/model.py, after OpenCLIP).

- The visual tower: the port's :class:`~sprc_tpu_torch.models.vit.ClipViT`
  with ``use_ln_pre``, QuickGELU, ``final_norm`` (OpenAI's ``ln_post``), no
  patch bias, fp32 (``configs/models/clip/*.yaml``): its blocks run kernel
  K2 on the card. Its CLS row times ``visual.proj`` is the image feature.
  The RN50 row (``vision_resnet``) holds
  :class:`~sprc_tpu_torch.models.resnet_clip.ClipResNet` instead, whose
  attention pool projects already.
- The text tower: a causal transformer (pre-LN, packed qkv, QuickGELU),
  ``ln_final``, the row at each text's end-of-text position times
  ``text_projection``. Its attention is plain PyTorch, as the JAX tower
  calls ``dot_product_attention(..., use_pallas=False)`` (``clip.py:77-79``).
- ``logit_scale``: the learned log temperature.

Module names are OpenAI's (``visual.conv1``,
``visual.transformer.resblocks.{i}.attn.in_proj_weight``, ``visual.ln_post``,
``visual.proj``, ``transformer.resblocks.{i}.mlp.c_fc``,
``token_embedding``, ``positional_embedding``, ``ln_final``,
``text_projection``, ``logit_scale``), the layout of the released ViT and
RN50 checkpoints, which load by name; :func:`clip_state_from_hf` reads an
HF ``CLIPModel`` state dict into them (the JAX ``clip_params_from_hf``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from sprc_tpu_torch.models.resnet_clip import ClipResNet, ResNetConfig
from sprc_tpu_torch.models.vit import ClipViT, ViTConfig
from sprc_tpu_torch.ops import primitives
from sprc_tpu_torch.ops.layers import LayerNormFP32, Linear, l2_normalize
from sprc_tpu_torch.registry import registry

Tensor = torch.Tensor
NEG_INF = -1e9  # the JAX text tower's causal bias
LOGIT_SCALE_INIT = math.log(1 / 0.07)


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8
    context_length: int = 77
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    embed_dim: int = 512
    image_size: int = 224
    vision: Optional[ViTConfig] = None
    vision_resnet: Optional[ResNetConfig] = None  # RN50: no visual projection
    text: ClipTextConfig = ClipTextConfig()

    def vision_config(self) -> ViTConfig:
        """``vision``, else the ViT-B/16 the JAX config defaults to."""
        return self.vision or ViTConfig(
            image_size=self.image_size, patch_size=16, width=768, depth=12, num_heads=12,
            mlp_hidden=3072, layer_norm_eps=1e-5, use_ln_pre=True, quick_gelu=True,
            final_norm=True, patch_bias=False, dtype=torch.float32)


class ClipVisual(ClipViT):
    """The CLIP ViT with its projection ``proj`` [W, E] (``x @ proj``)."""

    def __init__(self, cfg: ViTConfig, embed_dim: int):
        super().__init__(cfg)
        self.proj = nn.Parameter(torch.empty(cfg.width, embed_dim))


class ClipTextAttention(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        C = cfg.width
        self.in_proj_weight = nn.Parameter(torch.empty(3 * C, C, dtype=cfg.dtype))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * C))
        self.out_proj = Linear(C, C, dtype=cfg.dtype)


class ClipMlp(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.c_fc = Linear(cfg.width, 4 * cfg.width, dtype=cfg.dtype)
        self.c_proj = Linear(4 * cfg.width, cfg.width, dtype=cfg.dtype)


class ClipTextBlock(nn.Module):
    """``x + proj(attn(ln_1(x)))``, then ``x + c_proj(quick_gelu(c_fc(ln_2(x))))``."""

    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.cfg = cfg
        self.ln_1 = LayerNormFP32(cfg.width, cfg.layer_norm_eps)
        self.attn = ClipTextAttention(cfg)
        self.ln_2 = LayerNormFP32(cfg.width, cfg.layer_norm_eps)
        self.mlp = ClipMlp(cfg)

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        B, S, C = x.shape
        H = self.cfg.heads
        h = self.ln_1(x).to(self.cfg.dtype)
        qkv = primitives.gemm_plain(h, self.attn.in_proj_weight, self.attn.in_proj_bias)
        q, k, v = (t.reshape(B, S, H, C // H) for t in qkv.split(C, dim=-1))
        ctx = primitives.einsum_attention(q, k, v, bias, (C // H) ** -0.5).reshape(B, S, C)
        x = x + self.attn.out_proj(ctx)
        h = self.mlp.c_fc(self.ln_2(x).to(self.cfg.dtype))
        h = h * torch.sigmoid(1.702 * h)  # QuickGELU
        return x + self.mlp.c_proj(h)


class ClipTextTransformer(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(ClipTextBlock(cfg) for _ in range(cfg.layers))


@registry.register_model("clip")
@registry.register_model("clip_feature_extractor")
class Clip(nn.Module):
    """The two towers, their projections and ``logit_scale``."""

    CONFIG = ClipConfig

    def __init__(self, cfg: ClipConfig):
        super().__init__()
        self.cfg = cfg
        t = cfg.text
        if cfg.vision_resnet is not None:
            self.visual = ClipResNet(cfg.vision_resnet)
        else:
            self.visual = ClipVisual(cfg.vision_config(), cfg.embed_dim)
        self.transformer = ClipTextTransformer(t)
        self.token_embedding = nn.Embedding(t.vocab_size, t.width)
        self.positional_embedding = nn.Parameter(torch.empty(t.context_length, t.width))
        self.ln_final = LayerNormFP32(t.width, t.layer_norm_eps)
        self.text_projection = nn.Parameter(torch.empty(t.width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.empty(()))

    def encode_image(self, images: Tensor) -> Tensor:
        """NHWC images -> the image features [B, E] (not normalised)."""
        if self.cfg.vision_resnet is not None:
            return self.visual(images)  # the attention pool's c_proj projects
        return self.visual(images)[:, 0, :].float() @ self.visual.proj

    def encode_text(self, input_ids: Tensor, eot_positions: Tensor) -> Tensor:
        """[B, S] ids and each row's end-of-text position -> [B, E] (not normalised)."""
        S = input_ids.shape[1]
        x = self.token_embedding(input_ids) + self.positional_embedding[:S]
        causal = torch.tril(torch.ones((S, S), dtype=torch.bool, device=x.device))
        bias = torch.where(causal, 0.0, NEG_INF)[None, None]
        for block in self.transformer.resblocks:
            x = block(x, bias)
        x = self.ln_final(x)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot_positions.long()]
        return pooled.float() @ self.text_projection

    def forward(self, images: Tensor, input_ids: Tensor,
                eot_positions: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """(logits_per_image [B_i, B_t], image features, text features), the
        features L2-normalised."""
        img = l2_normalize(self.encode_image(images))
        txt = l2_normalize(self.encode_text(input_ids, eot_positions))
        return self.logit_scale.exp() * img @ txt.T, img, txt


def clip_state_from_hf(sd: Mapping[str, Tensor], cfg: ClipConfig) -> dict:
    """An HF ``CLIPModel`` state dict -> the port's (OpenAI's) names
    (``sprc_tpu/models/clip.py:163 clip_params_from_hf``): q / k / v packed
    into ``in_proj_weight`` / ``in_proj_bias``, the projections
    transposed to ``x @ proj``."""
    out = {}

    def ln(dst: str, src: str) -> None:
        out[f"{dst}.weight"] = sd[f"{src}.weight"]
        out[f"{dst}.bias"] = sd[f"{src}.bias"]

    def blocks(dst: str, src: str, depth: int) -> None:
        for i in range(depth):
            d, s = f"{dst}.{i}.", f"{src}.{i}."
            ln(f"{d}ln_1", f"{s}layer_norm1")
            out[f"{d}attn.in_proj_weight"] = torch.cat(
                [sd[f"{s}self_attn.{p}_proj.weight"] for p in "qkv"])
            out[f"{d}attn.in_proj_bias"] = torch.cat(
                [sd[f"{s}self_attn.{p}_proj.bias"] for p in "qkv"])
            ln(f"{d}attn.out_proj", f"{s}self_attn.out_proj")
            ln(f"{d}ln_2", f"{s}layer_norm2")
            ln(f"{d}mlp.c_fc", f"{s}mlp.fc1")
            ln(f"{d}mlp.c_proj", f"{s}mlp.fc2")

    vp, tp = "vision_model.", "text_model."
    out["visual.class_embedding"] = sd[f"{vp}embeddings.class_embedding"]
    out["visual.positional_embedding"] = sd[f"{vp}embeddings.position_embedding.weight"]
    out["visual.conv1.weight"] = sd[f"{vp}embeddings.patch_embedding.weight"]
    ln("visual.ln_pre", f"{vp}pre_layrnorm")
    ln("visual.ln_post", f"{vp}post_layernorm")
    blocks("visual.transformer.resblocks", f"{vp}encoder.layers", cfg.vision_config().depth)
    out["visual.proj"] = sd["visual_projection.weight"].T.contiguous()
    out["token_embedding.weight"] = sd[f"{tp}embeddings.token_embedding.weight"]
    out["positional_embedding"] = sd[f"{tp}embeddings.position_embedding.weight"]
    ln("ln_final", f"{tp}final_layer_norm")
    blocks("transformer.resblocks", f"{tp}encoder.layers", cfg.text.layers)
    out["text_projection"] = sd["text_projection.weight"].T.contiguous()
    out["logit_scale"] = sd["logit_scale"].reshape(())
    return out

