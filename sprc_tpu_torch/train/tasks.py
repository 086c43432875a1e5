"""Tasks for the runners (counterpart of ``sprc_tpu/train/tasks.py``):
:class:`ImageTextRetrievalTask`, the image <-> text retrieval evaluation of
the BLIP-2 family (reference tasks/retrieval.py:19-120), over
``extract_target_features`` and ``encode_text_cls``, and of the BLIP-1 /
ALBEF families (``evaluate_pairs_itc``: CLS-projection cosines rank every
pair, the ITM head rescores each query's top ``k_test``) and of CLIP
(``evaluate_pairs_clip``: the cosines of the two towers' features, no
rescoring), and of ALPRO (``evaluate_pairs_video``: VTC cosines, each
query's top ``k_test`` rescored by the VTM logit, through the same
:func:`rescore_topk`).

And :class:`CirTask` (``composed_retrieval``): CIRR / FashionIQ
composed-retrieval fine-tuning over the port's threaded
:class:`~sprc_tpu_torch.data.loader.DataLoader` (shuffled, the last partial
batch dropped), its captions through the caption processor and, for
FashionIQ's caption pairs, ``randomize_fiq_captions`` drawn from one
``RandomState(seed)`` over the run, as the JAX task draws them.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from sprc_tpu_torch.registry import registry
from sprc_tpu_torch.train.runner import BaseTask


@registry.register("task", "composed_retrieval")
class CirTask(BaseTask):
    """A CIR model's fine-tuning over triplet batches {reference_image,
    target_image, caption | captions} (``sprc_tpu/train/tasks.py:21-85``).
    ``eval_fn(model)`` gives the epoch's validation metrics, and
    ``selection_key`` picks the one the runner keeps the best by
    (``arithmetic_mean``: the harmonic and geometric means report 0 while any
    recall is 0)."""

    def __init__(self, model, tokenizer, train_dataset, *, batch_size: int = 128,
                 workers: int = 4, seed: int = 42, caption_key: str = "caption", eval_fn=None,
                 selection_key: str = "arithmetic_mean", device="cuda"):
        from sprc_tpu_torch.data.loader import DataLoader
        from sprc_tpu_torch.text.processors import CaptionProcessor

        self.model = model
        self.tokenizer = tokenizer
        self.processor = CaptionProcessor()
        self.caption_key = caption_key
        self.eval_fn = eval_fn
        self.selection_key = selection_key
        self.device = torch.device(device)
        self._fiq_rng = np.random.RandomState(seed)
        self.loader = DataLoader(train_dataset, batch_size=batch_size, shuffle=True,
                                 drop_last=True, num_workers=workers, seed=seed)

    def train_loader(self, epoch: int) -> Iterable[dict]:
        self.loader.set_epoch(epoch)
        return self.loader

    def prepare_batch(self, batch: dict) -> Dict[str, torch.Tensor]:
        from sprc_tpu_torch.cli.finetune import to_device, tokenize_captions

        text = tokenize_captions({self.caption_key: batch[self.caption_key]}, self.tokenizer,
                                 self.processor, self.model.cfg.max_txt_len, self._fiq_rng)
        return to_device({"reference": np.asarray(batch["reference_image"], np.float32),
                          "target": np.asarray(batch["target_image"], np.float32), **text},
                         self.device)

    def evaluation(self, model) -> Dict[str, float]:
        return {} if self.eval_fn is None else self.eval_fn(model)

    def selection_metric(self, results: Dict[str, float]) -> Optional[float]:
        return results.get(self.selection_key)


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

    def evaluate_pairs_itc(self, model, images, texts: Sequence[str],
                           img2txt: Dict[int, Sequence[int]], txt2img: Dict[int, int], *,
                           batch: int = 16,
                           stats: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        """ITC sims and top-k ITM rescoring of the BLIP-1 / ALBEF retrieval
        models (``sprc_tpu/train/tasks.py:147-210``; reference
        {blip,albef}_retrieval compute_sim_matrix): the images ``batch`` a
        call through the tower (rows kept on the device), the captions 256 a
        call through the text pass; the CLS projections normalised and their
        cosines taken on the host, as JAX takes them; then the top
        ``k_test`` of each image and each caption rescored by the ITM logit
        ``[:, 1]`` (BLIP-1: ``itm_logits`` over ``[ENC]`` ids; ALBEF:
        ``itm_head(fusion_cls(...))`` over the text rows) plus the cosine.
        ``stats``: ``image_encode_s``, ``text_encode_s``, ``itc_s``,
        ``itm_s``."""
        from sprc_tpu_torch.retrieval.sim_matrix import retrieval_recalls

        stats = {} if stats is None else stats
        device = next(model.parameters()).device
        tok = self.tokenizer(list(texts), max_length=self.max_txt_len)
        enc_tok = self.tokenizer(list(texts), max_length=self.max_txt_len, enc_token=True)
        t0 = time.perf_counter()
        embeds, feats = [], []
        with torch.inference_mode():
            for chunk in _image_batches(images, batch):
                rows = model.encode_image(
                    torch.from_numpy(np.ascontiguousarray(chunk, np.float32)).to(device))
                embeds.append(rows)
                feats.append(model.vision_proj(rows[:, 0, :]).float().cpu().numpy())
        image_embeds, image_feat = torch.cat(embeds), _norm(np.concatenate(feats))
        stats["image_encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        te_l, tf_l = [], []
        with torch.inference_mode():
            for s in range(0, len(texts), 256):
                te, tf = model.text_features(
                    torch.from_numpy(tok["input_ids"][s: s + 256]).to(device),
                    torch.from_numpy(tok["attention_mask"][s: s + 256]).to(device))
                te_l.append(te)
                tf_l.append(tf.float().cpu().numpy())
        text_embeds, text_feat = torch.cat(te_l), _norm(np.concatenate(tf_l))
        stats["text_encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sims = image_feat @ text_feat.T
        stats["itc_s"] = time.perf_counter() - t0
        k_test = min(self.k_test, len(texts), image_embeds.shape[0])
        enc_ids = torch.from_numpy(enc_tok["input_ids"]).to(device)
        enc_mask = torch.from_numpy(enc_tok["attention_mask"]).to(device)

        def score(img_rows, ids, mask, txt_rows) -> np.ndarray:
            img_rows, ids, mask, txt_rows = (x.contiguous() for x in (img_rows, ids, mask,
                                                                      txt_rows))
            with torch.inference_mode():
                if hasattr(model, "itm_logits"):  # BLIP-1: multimodal over [ENC] ids
                    out = model.itm_logits(ids, mask, img_rows)[:, 1]
                else:  # ALBEF: the fusion layers over the text rows
                    out = model.itm_scores(txt_rows, mask, img_rows)
            return out.float().cpu().numpy()

        t0 = time.perf_counter()
        s_i2t, s_t2i = rescore_topk(sims, k_test, image_embeds, text_embeds, enc_ids, enc_mask,
                                    score)
        stats["itm_s"] = time.perf_counter() - t0
        return retrieval_recalls(s_i2t, s_t2i, img2txt, txt2img)

    def evaluate_pairs_clip(self, model, images, texts: Sequence[str],
                            img2txt: Dict[int, Sequence[int]], txt2img: Dict[int, int], *,
                            tokenize=None, batch: int = 64,
                            stats: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        """CLIP's retrieval evaluation (``sprc_tpu/train/tasks.py:229``):
        the L2-normalised image features (``batch`` images a tower call, or
        the batches of an iterable as they come) against the normalised text
        features (256 captions a call), ranked by the cosine alone.
        ``tokenize(texts) -> (ids, eot_positions)``; by default the task's
        tokenizer at ``min(context_length, max_txt_len)`` with each row's
        last position as its end of text. ``stats``: ``image_encode_s``,
        ``text_encode_s``, ``rank_s``."""
        from sprc_tpu_torch.retrieval.sim_matrix import retrieval_recalls
        from sprc_tpu_torch.text.llm_tokenizers import clip_tokenize

        stats = {} if stats is None else stats
        if tokenize is None:
            ctx = min(int(model.cfg.text.context_length), self.max_txt_len)
            tokenize = lambda t: clip_tokenize(self.tokenizer, t, ctx)  # noqa: E731
        device = next(model.parameters()).device
        t0 = time.perf_counter()
        with torch.inference_mode():
            feats = [model.encode_image(torch.from_numpy(
                np.ascontiguousarray(chunk, np.float32)).to(device)).float().cpu().numpy()
                for chunk in _image_batches(images, batch)]
            t1 = time.perf_counter()
            ids, eot = (np.asarray(a) for a in tokenize(list(texts)))
            text = [model.encode_text(
                torch.as_tensor(ids[s: s + 256], dtype=torch.long, device=device),
                torch.as_tensor(eot[s: s + 256], dtype=torch.long, device=device)
            ).float().cpu().numpy() for s in range(0, ids.shape[0], 256)]
        t2 = time.perf_counter()
        image_feat, text_feat = _norm(np.concatenate(feats)), _norm(np.concatenate(text))
        sims = image_feat @ text_feat.T
        metrics = retrieval_recalls(sims, sims.T, img2txt, txt2img)
        stats.update(image_encode_s=t1 - t0, text_encode_s=t2 - t1,
                     rank_s=time.perf_counter() - t2)
        return metrics


    def evaluate_pairs_video(self, model, videos, texts: Sequence[str],
                             img2txt: Dict[int, Sequence[int]], txt2img: Dict[int, int], *,
                             batch: int = 4,
                             stats: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        """ALPRO's video-text retrieval (``sprc_tpu/train/tasks.py:282-345``;
        reference alpro_retrieval.py compute_sim_matrix:250-340): the clips
        [N, T, H, W, 3] ``batch`` a call through ``video_feats`` (or the
        batches of an iterable as they come; the rows stay on the device),
        the captions 256 a call through ``text_feats``, the cosines of the
        model's normalised projections on the host, then the top
        ``min(k_test, texts, videos)`` of each clip and each caption rescored
        by ``vtm_score`` over the text rows plus the cosine: one call a clip
        and one a caption, as in JAX. ``stats``: ``video_encode_s``,
        ``text_encode_s``, ``vtc_s``, ``vtm_s``."""
        from sprc_tpu_torch.retrieval.sim_matrix import retrieval_recalls

        stats = {} if stats is None else stats
        device = next(model.parameters()).device
        tok = self.tokenizer(list(texts), max_length=self.max_txt_len)
        t0 = time.perf_counter()
        embeds, feats = [], []
        with torch.inference_mode():
            for chunk in _image_batches(videos, batch):
                rows, feat = model.video_feats(
                    torch.from_numpy(np.ascontiguousarray(chunk, np.float32)).to(device))
                embeds.append(rows)
                feats.append(feat.float().cpu().numpy())
        video_embeds, video_feat = torch.cat(embeds), np.concatenate(feats)
        stats["video_encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids = torch.from_numpy(tok["input_ids"]).to(device)
        mask = torch.from_numpy(tok["attention_mask"]).to(device)
        te_l, tf_l = [], []
        with torch.inference_mode():
            for s in range(0, len(texts), 256):
                te, tf = model.text_feats(ids[s: s + 256], mask[s: s + 256])
                te_l.append(te)
                tf_l.append(tf.float().cpu().numpy())
        text_embeds, text_feat = torch.cat(te_l), np.concatenate(tf_l)
        stats["text_encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sims = video_feat @ text_feat.T
        stats["vtc_s"] = time.perf_counter() - t0
        k_test = min(self.k_test, len(texts), video_embeds.shape[0])

        def score(vid_rows, _ids, rows_mask, txt_rows) -> np.ndarray:
            with torch.inference_mode():
                out = model.vtm_score(txt_rows.contiguous(), rows_mask.contiguous(),
                                      vid_rows.contiguous())
            return out.float().cpu().numpy()

        t0 = time.perf_counter()
        s_i2t, s_t2i = rescore_topk(sims, k_test, video_embeds, text_embeds, ids, mask, score)
        stats["vtm_s"] = time.perf_counter() - t0
        return retrieval_recalls(s_i2t, s_t2i, img2txt, txt2img)


def _norm(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def rescore_topk(sims: np.ndarray, k_test: int, image_embeds, text_embeds, enc_ids, enc_mask,
                 score):
    """(s_i2t, s_t2i), -100 outside each row's top ``k_test`` by ``sims``
    (a stable descending sort, ties to the lower index), inside it
    ``score(image rows, ids, mask, text rows)`` plus the cosine
    (``sprc_tpu/train/tasks.py:334-357``)."""
    s_i2t = np.full_like(sims, -100.0)
    for i in range(sims.shape[0]):
        topk = np.argsort(-sims[i], kind="stable")[:k_test]
        pick = torch.from_numpy(topk).to(text_embeds.device)
        s_i2t[i, topk] = score(image_embeds[i: i + 1].expand(len(topk), -1, -1), enc_ids[pick],
                               enc_mask[pick], text_embeds[pick]) + sims[i, topk]
    s_t2i = np.full_like(sims.T, -100.0)
    for t in range(sims.shape[1]):
        topk = np.argsort(-sims[:, t], kind="stable")[:k_test]
        pick = torch.from_numpy(topk).to(image_embeds.device)
        n = len(topk)
        s_t2i[t, topk] = score(image_embeds[pick], enc_ids[t: t + 1].expand(n, -1),
                               enc_mask[t: t + 1].expand(n, -1),
                               text_embeds[t: t + 1].expand(n, -1, -1)) + sims[topk, t]
    return s_i2t, s_t2i
