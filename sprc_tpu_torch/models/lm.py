"""The Q-Former's language-model head (counterpart of
``sprc_tpu/models/lm.py:28-39``; reference Qformer.py ``BertLMPredictionHead``).

dense -> exact GELU -> fp32 LayerNorm -> decoder to the vocabulary (30,523
rows with ``[DEC]``). Module names are the reference's
(``Qformer.cls.predictions.transform.dense``, ``.transform.LayerNorm``,
``.decoder``), so a released stage-1 checkpoint's head loads by name. The
decoding loops (``greedy_generate`` and the KV cache) come with the
captioning models.
"""

from __future__ import annotations

import torch
from torch import nn

from sprc_tpu_torch.models.qformer import QFormerConfig
from sprc_tpu_torch.ops import primitives
from sprc_tpu_torch.ops.layers import LayerNormFP32, Linear


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

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        p = self.predictions
        h = primitives.gelu(p.transform.dense(hidden))
        return p.decoder(p.transform.LayerNorm(h))
