"""GradCAM over BLIP-1's ITM cross-attention (counterpart of
``sprc_tpu/utils/gradcam.py``; reference blip_image_text_matching.py
compute_gradcam :151-199 and common/gradcam.py).

gradcam = attention probabilities * relu(d match logit / d probabilities),
masked to the text's tokens and averaged over heads. The reference reads
the gradient through backward hooks on its attention module; the JAX
package and this port take it with respect to a zero-valued probe added to
the probabilities of one cross-attention layer (``torch.autograd.grad``).
The tower runs without a graph (on the card its blocks are kernel K2's
wrapper, which refuses autograd); only the med-BERT is differentiated.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def compute_gradcam(model, images: Optional[torch.Tensor], enc_input_ids: torch.Tensor,
                    text_mask: torch.Tensor, *, block_num: int = 7,
                    image_embeds: Optional[torch.Tensor] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (avg [B, num_patches]: the token-averaged map PNP-VQA samples
    patches from; full [B, L + 1, num_patches]: [the first token's map, the
    token average, the maps of tokens 1 to L - 1], the reference's layout),
    float32 numpy. ``model`` is a
    :class:`~sprc_tpu_torch.models.blip1.BlipITM`; the inputs lie on its
    device; ``image_embeds``: its tower's rows of ``images``, where the
    caller has them. Autograd runs here whatever the caller's mode."""
    B, L = enc_input_ids.shape
    heads = model.cfg.text_config().num_heads
    rows = model.cfg.vit_config().seq_len
    with torch.inference_mode(False), torch.enable_grad():
        probe = torch.zeros((B, heads, L, rows), dtype=torch.float32,
                            device=enc_input_ids.device, requires_grad=True)
        score, probs = model.itm_gradcam(
            None if images is None else images.clone(), enc_input_ids.clone(),
            text_mask.clone(), probe, block_num,
            image_embeds=None if image_embeds is None else image_embeds.clone())
        if probs is None:
            raise ValueError(f"block_num={block_num} has no cross-attention in this encoder "
                             "(fewer layers, or cross-attention starts later)")
        grads, = torch.autograd.grad(score, probe)
    with torch.no_grad():
        mask = text_mask.float()[:, None, :, None]  # [B, 1, L, 1]
        cams = probs.detach()[:, :, :, 1:] * mask  # the image CLS column dropped
        grd = grads[:, :, :, 1:].clamp_min(0.0) * mask
        gradcam = (cams * grd).mean(dim=1).cpu().numpy().astype(np.float32)  # [B, L, P]
    toks = text_mask.sum(dim=-1).cpu().numpy() - 2  # [CLS]/[ENC] and [SEP] dropped (:165)
    full = []
    for b in range(B):
        n = int(toks[b])
        avg_row = gradcam[b, 1:n + 1].sum(axis=0, keepdims=True) / max(n, 1)
        full.append(np.concatenate([gradcam[b, :1], avg_row, gradcam[b, 1:]], axis=0))
    full = np.stack(full)
    return full[:, 1], full


def get_att_map(img: np.ndarray, att_map: np.ndarray, *, blur: bool = True,
                overlap: bool = True) -> np.ndarray:
    """Overlay a patch-level attention map on an image (reference
    common/gradcam.py getAttMap), with PIL's resampling as the JAX package's
    copy uses: the map normalised to [0, 1], resized bicubic to the image
    (with ``blur``, a bilinear cycle through an eighth of its size instead),
    a jet-like colour map, blended by ``map ** 0.7`` where ``overlap``."""
    from PIL import Image

    att_map = att_map - att_map.min()
    if att_map.max() > 0:
        att_map = att_map / att_map.max()
    h, w = img.shape[:2]
    pil = Image.fromarray((att_map * 255).astype(np.uint8))
    att_map = np.asarray(pil.resize((w, h), Image.BICUBIC), np.float32) / 255.0
    if blur:
        small = pil.resize((max(w // 8, 1), max(h // 8, 1)), Image.BILINEAR)
        att_map = np.asarray(small.resize((w, h), Image.BILINEAR), np.float32) / 255.0
        att_map = att_map - att_map.min()
        if att_map.max() > 0:
            att_map = att_map / att_map.max()

    def _jet(x):
        r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
        g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
        b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
        return np.stack([r, g, b], axis=-1)

    att_v = _jet(att_map)
    if overlap:
        w_ = (att_map ** 0.7)[..., None]
        return (1 - w_) * img + w_ * att_v
    return att_v
