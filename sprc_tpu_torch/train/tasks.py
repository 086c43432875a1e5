"""Tasks for the runners (counterpart of ``sprc_tpu/train/tasks.py``):
:class:`ImageTextRetrievalTask`, the image <-> text retrieval evaluation of
the BLIP-2 family (reference tasks/retrieval.py:19-120), over
``extract_target_features`` and ``encode_text_cls``.

The JAX module's ITC-only, CLIP and video evaluations and its
``CirTask`` come with their families (ROADMAP A8).
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from sprc_tpu_torch.registry import registry
from sprc_tpu_torch.train.runner import BaseTask


def _image_batches(images, batch: int) -> Iterable[np.ndarray]:
    """[b, ...] chunks of an array, or a pre-batched iterable as it comes
    (the CLI streams gallery pixels instead of holding the split)."""
    if hasattr(images, "shape"):
        for s in range(0, images.shape[0], batch):
            yield images[s: s + batch]
    else:
        yield from images


@registry.register("task", "retrieval")
class ImageTextRetrievalTask(BaseTask):
    """Evaluation-only i2t / t2i retrieval."""

    def __init__(self, tokenizer, *, k_test: int = 128, max_txt_len: int = 35):
        self.tokenizer = tokenizer
        self.k_test = k_test
        self.max_txt_len = max_txt_len

    def evaluate_pairs(self, model, images, texts: Sequence[str],
                       img2txt: Dict[int, Sequence[int]], txt2img: Dict[int, int], *,
                       stats: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        """``images``: [N, H, W, 3] fp32 or an iterable of such batches; the
        gallery encode runs 64 images a call (their frozen rows come back to
        the host), the captions 256 a call, then the two stages of
        :func:`~sprc_tpu_torch.retrieval.sim_matrix.compute_sim_matrix`.
        ``stats`` receives the seconds by stage (``image_encode_s``,
        ``text_encode_s`` and compute_sim_matrix's)."""
        from sprc_tpu_torch.retrieval.sim_matrix import compute_sim_matrix, retrieval_recalls

        stats = {} if stats is None else stats
        device = next(model.parameters()).device
        feats_l, frozen_l = [], []
        t0 = time.perf_counter()
        with torch.inference_mode():
            for chunk in _image_batches(images, 64):
                f, fr = model.extract_target_features(
                    torch.from_numpy(np.ascontiguousarray(chunk, np.float32)).to(device))
                feats_l.append(f)
                frozen_l.append(fr.float().cpu().numpy())
        feats, frozen = torch.cat(feats_l), np.concatenate(frozen_l)
        stats["image_encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tok = self.tokenizer(list(texts), max_length=self.max_txt_len)
        ids, mask = tok["input_ids"], tok["attention_mask"]
        with torch.inference_mode():
            text_feats = torch.cat([
                model.encode_text_cls(torch.from_numpy(ids[s: s + 256]).to(device),
                                      torch.from_numpy(mask[s: s + 256]).to(device))
                for s in range(0, len(texts), 256)])
        stats["text_encode_s"] = time.perf_counter() - t0
        s_i2t, s_t2i = compute_sim_matrix(model, frozen, feats, ids, mask, text_feats,
                                          k_test=min(self.k_test, len(texts)), stats=stats)
        return retrieval_recalls(s_i2t, s_t2i, img2txt, txt2img)
