"""CLIP's ModifiedResNet vision tower, RN50 (counterpart of
``sprc_tpu/models/resnet_clip.py``; reference
lavis/models/clip_models/model.py:50-244, after openai/CLIP).

A 3-conv stem with an average pool, bottleneck stages whose strided
convolutions are anti-aliased (the average pool first, the convolution at
stride 1), and a QKV attention pool in place of global average pooling,
whose ``c_proj`` is the projection into the contrastive space (an RN50 CLIP
has no separate visual projection). BatchNorm is a frozen affine over its
running statistics (:class:`FrozenBatchNorm2d`), as the JAX tower holds it:
the reference runs this tower for zero-shot and retrieval evaluation only.

The convolutions are ``torch.nn.functional.conv2d`` and the attention pool
plain PyTorch: the JAX tower computes them outside any Pallas kernel, so
no kernel of the port is on this path. Images enter NHWC, as in the JAX
package, and are transposed to NCHW once. Module names are OpenAI's
(``conv1``, ``bn1``, ``layer1.0.downsample.0``, ``attnpool.q_proj``,
``running_mean``), so a released ``visual.*`` state dict loads by name;
its ``num_batches_tracked`` buffers are not held.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from sprc_tpu_torch.ops.layers import Linear

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    layers: Tuple[int, ...] = (3, 4, 6, 3)  # RN50
    width: int = 64
    heads: int = 32  # the attention pool's heads (2048 / 64)
    output_dim: int = 1024
    image_size: int = 224
    eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "layers", tuple(self.layers))  # YAML gives a list

    @property
    def embed_dim(self) -> int:
        return self.width * 32


class FrozenBatchNorm2d(nn.Module):
    """Eval-mode BatchNorm2d: ``x * w / sqrt(var + eps) + (b - mean * w /
    sqrt(var + eps))`` in fp32 over NCHW."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.empty(features))
        self.register_buffer("running_var", torch.empty(features))

    def forward(self, x: Tensor) -> Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return (x.float() * inv[:, None, None] + shift[:, None, None]).to(x.dtype)


def _conv(cin: int, cout: int, kernel: int, dtype, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False,
                     dtype=dtype)


class Bottleneck(nn.Module):
    """conv1x1 -> conv3x3 -> (anti-aliased) avgpool -> conv1x1 x4
    (reference model.py:50-106)."""

    def __init__(self, inplanes: int, planes: int, stride: int, eps: float, dtype):
        super().__init__()
        out = planes * 4
        self.stride = stride
        self.conv1 = _conv(inplanes, planes, 1, dtype)
        self.bn1 = FrozenBatchNorm2d(planes, eps)
        self.conv2 = _conv(planes, planes, 3, dtype)
        self.bn2 = FrozenBatchNorm2d(planes, eps)
        self.conv3 = _conv(planes, out, 1, dtype)
        self.bn3 = FrozenBatchNorm2d(out, eps)
        if stride > 1 or inplanes != out:
            self.downsample = nn.ModuleDict({"0": _conv(inplanes, out, 1, dtype),
                                             "1": FrozenBatchNorm2d(out, eps)})

    def forward(self, x: Tensor) -> Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        if self.stride > 1:
            h = F.avg_pool2d(h, self.stride)
        h = self.bn3(self.conv3(h))
        identity = x
        if hasattr(self, "downsample"):
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample["1"](self.downsample["0"](identity))
        return F.relu(h + identity)


class AttentionPool2d(nn.Module):
    """The mean token's QKV attention over the feature map (reference
    model.py:109-154): only that token's output is read, so its query alone
    is computed, as in the JAX tower."""

    def __init__(self, spatial: int, dim: int, heads: int, output_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.empty(spatial * spatial + 1, dim))
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.c_proj = Linear(dim, output_dim)

    def forward(self, x: Tensor) -> Tensor:
        B, C = x.shape[:2]
        tokens = x.float().flatten(2).transpose(1, 2)  # [B, HW, C], row-major
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding[None]
        nh, hd = self.heads, C // self.heads
        q = self.q_proj(tokens[:, :1]).reshape(B, 1, nh, hd).transpose(1, 2)
        k = self.k_proj(tokens).reshape(B, -1, nh, hd).transpose(1, 2)
        v = self.v_proj(tokens).reshape(B, -1, nh, hd).transpose(1, 2)
        attn = torch.softmax((q @ k.transpose(-1, -2)) / hd ** 0.5, dim=-1)
        pooled = (attn @ v).transpose(1, 2).reshape(B, C)
        return self.c_proj(pooled)


class ClipResNet(nn.Module):
    """ModifiedResNet trunk + attention pool: NHWC images -> [B, output_dim]."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        w2, dt, eps = cfg.width // 2, cfg.dtype, cfg.eps
        self.conv1 = _conv(3, w2, 3, dt, stride=2)
        self.bn1 = FrozenBatchNorm2d(w2, eps)
        self.conv2 = _conv(w2, w2, 3, dt)
        self.bn2 = FrozenBatchNorm2d(w2, eps)
        self.conv3 = _conv(w2, cfg.width, 3, dt)
        self.bn3 = FrozenBatchNorm2d(cfg.width, eps)
        inplanes = cfg.width
        for stage, blocks in enumerate(cfg.layers):
            planes = cfg.width * 2 ** stage
            layer = nn.ModuleList()
            for b in range(blocks):
                layer.append(Bottleneck(inplanes, planes, 2 if stage > 0 and b == 0 else 1,
                                        eps, dt))
                inplanes = planes * 4
            self.add_module(f"layer{stage + 1}", layer)
        self.attnpool = AttentionPool2d(cfg.image_size // 32, cfg.embed_dim, cfg.heads,
                                        cfg.output_dim)

    def forward(self, images: Tensor) -> Tensor:
        x = images.to(self.cfg.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x, 2)
        for stage in range(len(self.cfg.layers)):
            for block in getattr(self, f"layer{stage + 1}"):
                x = block(x)
        return self.attnpool(x)
