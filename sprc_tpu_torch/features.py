"""One feature-extraction entry over the image families (counterpart of
``sprc_tpu/features.py``; the reference's ``model.extract_features(samples,
mode)`` and its ``BlipOutputFeatures``)::

    from sprc_tpu_torch.features import extract_features
    feats = extract_features(model, {"image": imgs, "text_input": ["a cat"]},
                             mode="multimodal", tokenizer=tok)
    feats.image_embeds_proj  # [B, ...] L2-normalised projections

``samples`` holds raw ``text_input`` strings (tokenized with ``tokenizer``)
or ``input_ids`` / ``attention_mask`` arrays, and ``image``, preprocessed
[B, H, W, 3] arrays. Modes ``image``, ``text`` and ``multimodal``, family by
family as in the JAX function:

- BLIP-2 stage 1 (``blip2``, ``blip2_feature_extractor``): the query
  features and hidden rows; the CLS text feature and hidden rows; the fused
  queries of ``fuse_reference`` (the Q-Former's fusion pass: K2 and K3);
- BLIP-1 / ALBEF retrieval (``blip_retrieval``, ``blip_pretrain``,
  ``albef_retrieval``, ``albef_feature_extractor``): every token's
  projection, normalised; the multimodal rows (BLIP over ``[ENC]`` ids,
  ALBEF through its fusion layers);
- BLIP-1's CIR extractor (``blip_cir_base``, ``blip_feature_extractor``):
  the CLS projection; the prompt-conditioned text feature (``prompts``
  [B, P, H] from ``samples``, else zeros); no multimodal mode;
- CLIP (``clip``, ``clip_feature_extractor``): the projected features of
  the towers, not normalised (the JAX function's), the end-of-text position
  from ``eot_positions`` or each row's last token.

The arrays come back as numpy on the host; the models run on their own
device under ``torch.inference_mode``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sprc_tpu_torch.ops.layers import l2_normalize


@dataclasses.dataclass
class OutputFeatures:
    """The reference's BlipOutputFeatures: the raw last-layer rows and the
    L2-normalised contrastive projections."""

    image_embeds: Optional[np.ndarray] = None
    image_embeds_proj: Optional[np.ndarray] = None
    text_embeds: Optional[np.ndarray] = None
    text_embeds_proj: Optional[np.ndarray] = None
    multimodal_embeds: Optional[np.ndarray] = None


def _np(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


def extract_features(model, samples: dict, mode: str = "multimodal", *, tokenizer=None,
                     max_txt_len: Optional[int] = None) -> OutputFeatures:
    if mode not in ("image", "text", "multimodal"):
        raise ValueError(f"mode {mode!r}: expected image, text or multimodal")
    from sprc_tpu_torch.models.albef import AlbefRetrieval
    from sprc_tpu_torch.models.blip1 import BlipCirBase, BlipRetrieval
    from sprc_tpu_torch.models.blip2_stage1 import Blip2Stage1
    from sprc_tpu_torch.models.clip import Clip

    device = next(model.parameters()).device
    L = max_txt_len or int(getattr(model.cfg, "max_txt_len", 35))

    def tensor(a, dtype=None) -> torch.Tensor:
        a = np.asarray(a)
        if dtype is None:
            dtype = torch.long if a.dtype.kind in "iub" else torch.float32
        return torch.as_tensor(a, dtype=dtype, device=device)

    def tokens(**kw):
        if "input_ids" in samples:
            return tensor(samples["input_ids"]), tensor(samples["attention_mask"])
        if tokenizer is None:
            raise ValueError("text modes need input_ids / attention_mask in samples or a "
                             "tokenizer")
        tok = tokenizer(list(samples["text_input"]), max_length=L, **kw)
        return tensor(tok["input_ids"]), tensor(tok["attention_mask"])

    def image() -> torch.Tensor:
        return tensor(samples["image"], torch.float32)

    out = OutputFeatures()
    with torch.inference_mode():
        if isinstance(model, Blip2Stage1):  # reference blip2_qformer.py:387-467
            if mode == "image":
                proj, hidden = model.extract_image_features(image())
                out.image_embeds, out.image_embeds_proj = _np(hidden), _np(proj)
            elif mode == "text":
                proj, hidden = model.extract_text_features(*tokens())
                out.text_embeds, out.text_embeds_proj = _np(hidden), _np(proj)
            else:
                ids, mask = tokens()
                fused, _ = model.fuse_reference(model.encode_image(image()), ids, mask)
                out.multimodal_embeds = _np(fused)  # [B, Q, hidden]
            return out

        if isinstance(model, (AlbefRetrieval, BlipRetrieval)):
            # reference {albef,blip}_feature_extractor.py: every token projected
            if mode == "image":
                embeds = model.encode_image(image())
                out.image_embeds = _np(embeds)
                out.image_embeds_proj = _np(l2_normalize(model.vision_proj(embeds)))
            elif mode == "text":
                ids, mask = tokens()
                embeds = model.med(input_ids=ids, attention_mask=mask, mode="text")
                out.text_embeds = _np(embeds)
                out.text_embeds_proj = _np(l2_normalize(model.text_proj(embeds)))
            elif isinstance(model, AlbefRetrieval):
                ids, mask = tokens()
                text = model.med(input_ids=ids, attention_mask=mask, mode="text")
                out.multimodal_embeds = _np(model.med(
                    inputs_embeds=text, attention_mask=mask,
                    image_embeds=model.encode_image(image()), mode="fusion"))
            else:
                # BLIP's fusion was trained on [ENC]-prefixed ids
                # (reference blip_feature_extractor.py:170)
                if "input_ids" not in samples and tokenizer is not None:
                    ids, mask = tokens(enc_token=True)
                else:
                    ids, mask = tokens()
                    enc_id = None if tokenizer is None else tokenizer.vocab.get("[ENC]")
                    if enc_id is not None:
                        ids = ids.clone()
                        ids[:, 0] = enc_id
                out.multimodal_embeds = _np(model.med(
                    input_ids=ids, attention_mask=mask,
                    image_embeds=model.encode_image(image()), mode="multimodal"))
            return out

        if isinstance(model, BlipCirBase):
            if mode == "image":
                out.image_embeds_proj = _np(model.extract_target_features(image()))
            elif mode == "text":
                ids, mask = tokens()
                prompts = samples.get("prompts")
                if prompts is None:
                    prompts = np.zeros((ids.shape[0], model.cfg.num_prompts,
                                        model.cfg.text_config().hidden_size), np.float32)
                out.text_embeds_proj = _np(model.extract_cir_txt_feats(
                    ids, mask, tensor(prompts, torch.float32)))
            else:
                raise ValueError("blip_cir_base has no multimodal mode (the prompt-conditioned "
                                 "CIR features only; reference blip_cir.py)")
            return out

        if isinstance(model, Clip):  # reference clip extract_features: projections only
            if mode in ("image", "multimodal"):
                out.image_embeds_proj = _np(model.encode_image(image()))
            if mode in ("text", "multimodal"):
                if "eot_positions" in samples:
                    ids, eot = tensor(samples["input_ids"]), tensor(samples["eot_positions"])
                else:
                    ids, mask = tokens()
                    eot = mask.sum(dim=1) - 1
                out.text_embeds_proj = _np(model.encode_text(ids, eot))
            return out

    raise TypeError(f"extract_features: unsupported model type {type(model).__name__} "
                    "(supported: blip2 / blip2_feature_extractor, albef_feature_extractor, "
                    "blip_retrieval, blip_feature_extractor / blip_cir_base, clip)")
