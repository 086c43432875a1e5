"""The Q-Former of the BLIP-2 family (counterpart of ``sprc_tpu/models/qformer.py``).

A BERT-base encoder whose first ``Q`` positions are learned query
embeddings, with cross-attention into the frozen image embeddings on every
``cross_attention_freq``-th layer and a separate FFN for query positions
(reference src/lavis/models/blip2_models/Qformer.py). Behaviour on the
serving path, as in the JAX package:

- embeddings: text tokens get word + position embeddings for positions
  ``0..L-1``; query embeds are prepended without positions; an fp32
  LayerNorm over the whole sequence (queries only: just the LayerNorm);
- padding masks become an additive ``(1 - m) * -10000`` column bias added to
  the already-scaled scores (:func:`make_additive_mask`);
- with image embeds, query rows get cross-attention (on cross layers) and
  the query FFN, text rows the text FFN; without them every row takes the
  text FFN and there is no cross-attention (``qformer.py:372-392``).

Module names follow the reference (``Qformer.bert.encoder.layer.{i}.
crossattention.self.query``, ``...intermediate_query.dense``), so the
state-dict keys are the ones ``sprc_tpu/interop/torch_export.py`` emits.
Each layer calls kernel K3's wrapper
(:func:`sprc_tpu_torch.ops.fused_qformer.fused_qformer_layer`), which launches
the kernel on CUDA tensors and is inference-only; only inside
:func:`sprc_tpu_torch.ops.primitives.plain_reference` does a layer run its
plain PyTorch version. With ``QFormerConfig.int8`` (the explicit form of the
JAX package's ``SPRC_QF_INT8=1``; the port reads no environment variable)
every layer runs kernel K4, the same wrapper with ``int8=True``: the ten
dense projections as int8 products over codes derived at load time; the
image embeds are quantised once a pass (``quantize_rows``, by the same
choice of kernel or plain version as the layers) and every cross layer
takes their codes and row scales.

In training mode (``module.train()``, with autograd recording:
:func:`training`) every layer runs instead the unfused
composition of the JAX package's ``QFormerAttention`` / ``QFormerFFN``
(``sprc_tpu/models/qformer.py:160-229``), which the JAX package also runs
when not ``deterministic``: the dense products through :class:`Linear`
(``torch.matmul``), attention through :func:`dot_product_attention` (its
einsum path: every Q-Former call is masked or shorter than 128 rows), exact
GELU, post-LN residuals, and hidden dropout at the JAX package's three
places (the embeddings, after each attention's output projection, after
each FFN's second product; ``attention_dropout_rate`` is never read there,
and the port has no such field). Inside
:func:`sprc_tpu_torch.ops.layers.recomputing` the softmax attention, the
GELUs and the post-LN LayerNorms keep only their inputs for the backward and
run again there (:func:`~sprc_tpu_torch.ops.layers.recompute`: the same
gradients bit for bit, about 40 % fewer activations); the variants' largest
passes (the hard-negative ITM's 384 items) run so, to fit on one card at
batch 128. The masks come from the ``generator``
the caller passes down (:func:`sprc_tpu_torch.ops.layers.dropout`). The
``no_img`` text pass (SPRC's prompt pass) splices the query embeds after
the CLS token, with positions over the whole spliced sequence.
``output_attentions`` (``blip2_cir_slt``'s token selection) returns the last
layer's self-attention probabilities; that one layer runs the unfused
composition in any mode, without dropout outside training, as the JAX
package sends it past its fused kernel.

``QFormerConfig.remat`` (the JAX ``nn.remat`` of ``qformer.py:463-471``;
the finetune CLI's ``--remat``) keeps only each training layer's input for
the backward and runs the layer again there, all but the layer that returns
attention probabilities. Its dropout masks are drawn again from the state
the ``generator`` had at the forward call
(:func:`~sprc_tpu_torch.ops.layers.recompute`), so the step equals the step
without it bit for bit.

``is_decoder`` (the LM pass of ``blip2``, :mod:`.blip2_stage1`) builds the
UniLM mask of :func:`make_unilm_mask` (queries see the queries; text row i
sees every query and the text up to i; both times the padding mask), a full
``[B, 1, S, S]`` bias. As in the JAX gate (``qformer.py:306-320``), a pass
with a bias that is not a column bias runs the unfused composition in any
mode: a decoder pass never reaches K3. The JAX ``image_mask`` (only
``vqa.py`` sets it) waits for the VQA family.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from sprc_tpu_torch.ops import primitives
from sprc_tpu_torch.ops.attention import dot_product_attention
from sprc_tpu_torch.ops.fused_qformer import fused_qformer_layer, fused_qformer_layer_plain
from sprc_tpu_torch.ops.layers import LayerNormFP32, Linear, dropout, recompute

NEG_INF = -10000.0  # the reference's additive mask constant


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    vocab_size: int = 30523  # bert-base-uncased + [DEC]
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    encoder_width: int = 1024  # frozen ViT feature dim (CLIP ViT-L)
    cross_attention_freq: int = 2
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    query_length: int = 32
    dropout_rate: float = 0.1  # hidden dropout in training mode
    dtype: torch.dtype = torch.float32
    int8: bool = False  # int8 dense projections in every layer (serving only)
    remat: bool = False  # training: keep only each layer's input for the backward

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def training(module: nn.Module) -> bool:
    """The training branch runs where a module is in training mode and
    autograd records (the JAX package's ``deterministic=False``); otherwise,
    as under ``torch.no_grad()`` or ``inference_mode()``, the serving path."""
    return module.training and torch.is_grad_enabled()


def make_additive_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] {0, 1} -> [B, S] fp32 column bias, -10000 at masked slots (the
    JAX function's [B, 1, 1, S] bias without its broadcast axes)."""
    return (1.0 - attention_mask.float()) * NEG_INF


def make_unilm_mask(attention_mask: torch.Tensor, query_length: int) -> torch.Tensor:
    """UniLM decoder mask (``sprc_tpu/models/qformer.py:80-99``; reference
    Qformer.py:749-789): layout ``[queries (Q) | text (L)]``; query rows see
    the query columns, text row i the query columns and text columns <= i;
    times the padding mask. [B, S] {0, 1} -> additive [B, 1, S, S] fp32."""
    S = attention_mask.shape[1]
    rows = torch.arange(S, device=attention_mask.device)[:, None]
    cols = torch.arange(S, device=attention_mask.device)[None, :]
    is_query_col = cols < query_length
    query_rows = is_query_col & (rows < query_length)
    text_causal = (cols - query_length) <= (rows - query_length)
    text_rows = (rows >= query_length) & (is_query_col | ((cols >= query_length) & text_causal))
    structural = (query_rows | text_rows).float()
    combined = structural[None] * attention_mask.float()[:, None, :]
    return ((1.0 - combined) * NEG_INF)[:, None, :, :]


class QFormerEmbeddings(nn.Module):
    def __init__(self, cfg: QFormerConfig, text: bool = True):
        super().__init__()
        self.cfg = cfg
        self.LayerNorm = LayerNormFP32(cfg.hidden_size, cfg.layer_norm_eps)
        if text:
            self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
            self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                    cfg.hidden_size)
            self.register_buffer(
                "position_ids", torch.arange(cfg.max_position_embeddings)[None],
                persistent=True)

    def forward(self, input_ids: Optional[torch.Tensor], query_embeds: Optional[torch.Tensor],
                no_img: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if input_ids is not None:
            text = self.word_embeddings(input_ids)
            if no_img and query_embeds is not None:
                # queries after CLS, positions over the whole spliced sequence
                x = torch.cat([text[:, :1], query_embeds.to(text.dtype), text[:, 1:]], dim=1)
                x = x + self.position_embeddings(self.position_ids[:, :x.shape[1]])
            else:
                x = text + self.position_embeddings(self.position_ids[:, :text.shape[1]])
                if query_embeds is not None:
                    x = torch.cat([query_embeds.to(x.dtype), x], dim=1)
        else:
            x = query_embeds
        x = self.LayerNorm(x)
        if training(self):
            x = dropout(x, self.cfg.dropout_rate, generator)
        return x.to(self.cfg.dtype)


class SelfProjections(nn.Module):
    def __init__(self, hidden: int, kv_width: int, int8: bool):
        super().__init__()
        self.query = Linear(hidden, hidden, int8=int8)
        self.key = Linear(kv_width, hidden, int8=int8)
        self.value = Linear(kv_width, hidden, int8=int8)


class DenseLN(nn.Module):
    """``dense`` followed by the post-LN residual ``LayerNorm``."""

    def __init__(self, in_features: int, hidden: int, eps: float, int8: bool):
        super().__init__()
        self.dense = Linear(in_features, hidden, int8=int8)
        self.LayerNorm = LayerNormFP32(hidden, eps)


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int, int8: bool):
        super().__init__()
        self.dense = Linear(in_features, out_features, int8=int8)


def _dense_params(linear: Linear, int8: bool) -> tuple:
    """``(weight, bias)``, or K4's ``(codes, scale, bias)``."""
    return linear.int8_params() if int8 else (linear.weight, linear.bias)


class QFormerAttention(nn.Module):
    def __init__(self, cfg: QFormerConfig, kv_width: int):
        super().__init__()
        self.int8 = cfg.int8
        self.self = SelfProjections(cfg.hidden_size, kv_width, cfg.int8)
        self.output = DenseLN(cfg.hidden_size, cfg.hidden_size, cfg.layer_norm_eps, cfg.int8)

    def train_forward(self, hidden: torch.Tensor, kv: torch.Tensor,
                      bias: Optional[torch.Tensor], cfg: QFormerConfig,
                      generator: Optional[torch.Generator], return_probs: bool = False):
        """The unfused block: q/k/v, attention, ``out``, dropout,
        ``LN(out + hidden)``. ``bias``: [B, 1, 1, Sk] additive or None.
        ``return_probs``: also the softmax probabilities [B, H, S, Sk], from
        the JAX package's explicit path (fp32 scores, the bias after the
        scale)."""
        B, S, W = hidden.shape
        H, D = cfg.num_heads, cfg.head_dim
        q = self.self.query(hidden).view(B, S, H, D)
        k = self.self.key(kv).view(B, kv.shape[1], H, D)
        v = self.self.value(kv).view(B, kv.shape[1], H, D)
        probs = None
        if return_probs:
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
            if bias is not None:
                scores = scores + bias.to(scores.dtype)
            probs = torch.softmax(scores, dim=-1)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v).reshape(B, S, W)
        else:
            ctx = recompute(dot_product_attention, q, k, v, bias).reshape(B, S, W)
        out = dropout(self.output.dense(ctx), cfg.dropout_rate, generator)
        out = recompute(self.output.LayerNorm, out + hidden)
        return (out, probs) if return_probs else out

    def kernel_params(self) -> dict:
        s, o = self.self, self.output
        return {"query": _dense_params(s.query, self.int8),
                "key": _dense_params(s.key, self.int8),
                "value": _dense_params(s.value, self.int8),
                "out": _dense_params(o.dense, self.int8),
                "ln": (o.LayerNorm.weight, o.LayerNorm.bias)}


def _ffn_train(intermediate: Dense, output: DenseLN, x: torch.Tensor, cfg: QFormerConfig,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """The unfused FFN: fc1, exact GELU, fc2, dropout, ``LN(h + x)``."""
    h = output.dense(recompute(primitives.gelu, intermediate.dense(x)))
    return recompute(output.LayerNorm, dropout(h, cfg.dropout_rate, generator) + x)


def _ffn_params(intermediate: Dense, output: DenseLN, int8: bool) -> dict:
    return {"fc1": _dense_params(intermediate.dense, int8),
            "fc2": _dense_params(output.dense, int8),
            "ln": (output.LayerNorm.weight, output.LayerNorm.bias)}


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross_attention: bool, text: bool = True):
        super().__init__()
        H, M, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.cfg = cfg
        self.has_cross_attention = has_cross_attention
        self.attention = QFormerAttention(cfg, H)
        if has_cross_attention:
            self.crossattention = QFormerAttention(cfg, cfg.encoder_width)
        if text:  # the text FFN
            self.intermediate = Dense(H, M, cfg.int8)
            self.output = DenseLN(M, H, eps, cfg.int8)
        self.intermediate_query = Dense(H, M, cfg.int8)
        self.output_query = DenseLN(M, H, eps, cfg.int8)

    @property
    def text(self) -> bool:
        return hasattr(self, "intermediate")

    def forward(self, hidden: torch.Tensor, col_bias: Optional[torch.Tensor],
                image_embeds, query_length: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """image_embeds: [B, Si, Wi], None, or with int8 the pair (codes,
        scales) of :meth:`QFormer.forward`'s one quantisation a pass.
        ``col_bias``: [B, S] column bias, or a full [B, 1, S, S] bias (the
        decoder's), which takes the unfused composition."""
        cfg = self.cfg
        cross = self.has_cross_attention and image_embeds is not None
        full_bias = col_bias is not None and col_bias.dim() == 4
        if training(self) or full_bias:
            return self.train_forward(hidden, col_bias, image_embeds, query_length, generator)
        fn = primitives.kernel_or_reference(fused_qformer_layer, fused_qformer_layer_plain)
        return fn(
            hidden, col_bias, self.attention.kernel_params(),
            image_embeds if cross else None,
            self.crossattention.kernel_params() if cross else None,
            _ffn_params(self.intermediate_query, self.output_query, cfg.int8),
            _ffn_params(self.intermediate, self.output, cfg.int8) if self.text else None,
            heads=cfg.num_heads, eps=cfg.layer_norm_eps, Q=query_length,
            text_ffn_all=image_embeds is None, int8=cfg.int8,
        )


    def train_forward(self, hidden: torch.Tensor, col_bias: Optional[torch.Tensor],
                      image_embeds: Optional[torch.Tensor], query_length: int,
                      generator: Optional[torch.Generator], return_probs: bool = False):
        """The JAX package's unfused layer (``qformer.py:363-392``): query
        rows take cross-attention (on cross layers) and the query FFN, text
        rows the text FFN; without an image every row takes the text FFN.
        ``return_probs``: ``(out, the self-attention's probabilities)``;
        outside training (:func:`training`) with no dropout, as the JAX
        package runs its last layer for ``output_attentions``."""
        cfg = self.cfg if training(self) else dataclasses.replace(self.cfg, dropout_rate=0.0)
        bias = col_bias if col_bias is None or col_bias.dim() == 4 else col_bias[:, None, None, :]
        x = self.attention.train_forward(hidden, hidden, bias, cfg, generator, return_probs)
        x, probs = x if return_probs else (x, None)
        if image_embeds is None:
            out = _ffn_train(self.intermediate, self.output, x, cfg, generator)
        else:
            q = x[:, :query_length]
            if self.has_cross_attention:
                q = self.crossattention.train_forward(q, image_embeds, None, cfg, generator)
            out = _ffn_train(self.intermediate_query, self.output_query, q, cfg, generator)
            if x.shape[1] > query_length:
                t = _ffn_train(self.intermediate, self.output, x[:, query_length:], cfg,
                               generator)
                out = torch.cat([out, t], dim=1)
        return (out, probs) if return_probs else out


class Encoder(nn.Module):
    def __init__(self, cfg: QFormerConfig, text: bool = True):
        super().__init__()
        self.layer = nn.ModuleList(
            QFormerLayer(cfg, has_cross_attention=(i % cfg.cross_attention_freq == 0),
                         text=text)
            for i in range(cfg.num_layers))


class QFormer(nn.Module):
    """The Q-Former trunk (BertModel analogue; no LM head). ``text=False``
    builds it without its text side (word and position embeddings, the text
    FFN): the queries-only trunk of the LLM caption heads, whose JAX init
    holds only what the queries pass reaches."""

    def __init__(self, cfg: QFormerConfig, text: bool = True):
        super().__init__()
        self.cfg = cfg
        self.text = text
        self.embeddings = QFormerEmbeddings(cfg, text)
        self.encoder = Encoder(cfg, text)

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                query_embeds: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                image_embeds: Optional[torch.Tensor] = None, *, no_img: bool = False,
                is_decoder: bool = False, generator: Optional[torch.Generator] = None,
                output_attentions: bool = False):
        """``no_img``: the text pass with the query embeds spliced after CLS
        (the layers see no image). ``is_decoder``: the UniLM mask
        (:func:`make_unilm_mask`; no ``attention_mask``: all ones), run
        through the unfused layers. ``generator``: the dropout masks' source
        in training mode (None: the device's default generator).
        ``output_attentions``: ``(hidden, the last layer's self-attention
        probabilities [B, H, S, S])``; that layer runs the unfused
        composition (the JAX gate ``not return_self_probs``), the others as
        without it."""
        if input_ids is None and query_embeds is None:
            raise ValueError("need input_ids and/or query_embeds")
        if not self.text and (input_ids is not None or image_embeds is None or no_img):
            raise ValueError("this Q-Former has no text side: it runs the queries-only pass "
                             "over an image")
        if self.cfg.int8 and training(self):
            raise ValueError("the int8 Q-Former serves only; train the fp32 configuration")
        Q = query_embeds.shape[1] if query_embeds is not None else 0
        hidden = self.embeddings(input_ids, query_embeds, no_img, generator)
        if no_img:
            image_embeds = None
        B, S = hidden.shape[:2]
        if attention_mask is None and is_decoder:
            attention_mask = torch.ones((B, S), dtype=torch.int32, device=hidden.device)
        col_bias = None
        if attention_mask is not None:
            if attention_mask.shape[1] != S:
                raise ValueError(f"attention_mask length {attention_mask.shape[1]} != "
                                 f"sequence {S}")
            col_bias = (make_unilm_mask(attention_mask, Q) if is_decoder
                        else make_additive_mask(attention_mask))
        if self.cfg.int8 and is_decoder:
            raise ValueError("the int8 Q-Former serves the column-bias passes only "
                             "(no decoder mask)")
        layers = list(self.encoder.layer)
        last = layers.pop() if output_attentions else None
        image = None
        if image_embeds is not None:
            image = image_embeds = image_embeds.to(self.cfg.dtype).contiguous()
            if self.cfg.int8 and layers:  # the same rows in every cross layer: quantised once
                image_embeds = primitives.ops_for(image_embeds).quantize_rows(image_embeds)
        for layer in layers:
            if self.cfg.remat and training(layer):
                hidden = recompute(layer, hidden, col_bias, image_embeds, Q, generator,
                                   always=True, generator=generator)
            else:
                hidden = layer(hidden, col_bias, image_embeds, Q, generator)
        if last is None:
            return hidden
        return last.train_forward(hidden, col_bias, image, Q, generator, return_probs=True)
