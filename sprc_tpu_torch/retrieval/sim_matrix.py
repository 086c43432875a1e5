"""Image <-> text retrieval evaluation, two stages (counterpart of
``sprc_tpu/retrieval/sim_matrix.py:21-107``; reference
src/lavis/models/blip2_models/blip2.py:202-315 ``compute_sim_matrix`` and
src/lavis/tasks/retrieval.py:19-120).

Stage 1 ranks every pair by the token-max similarity of each caption's CLS
feature and each image's query features: kernel K1, ``token_max_sim(text
feats [T, E], query feats [N, Q, E]) -> [T, N]``, on the card (the JAX
package computes it on the host in numpy; K1 gives the transpose of its
``sims``). Stage 2 rescores each query's top ``k_test`` (a stable argsort of
the row, ties to the lower index) with the ITM head (``compute_itm``: the
Q-Former layers, kernel K3), ``itm_batch`` candidates a call; a rescored
pair holds ITM logit + ITC score, every other pair -100. The frozen image
rows (post-``ln_vision``, [N, S, D] fp32: about 19 GB for COCO's test split
at 364 px) stay on the host, as in JAX, and go to the card one chunk at a
time. ``shard_index`` / ``num_shards`` take a contiguous slice of the rows,
as the JAX function does.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def compute_sim_matrix(model, image_embeds_frozen: np.ndarray, query_feats: torch.Tensor,
                       text_ids: np.ndarray, text_mask: np.ndarray, text_feats: torch.Tensor, *,
                       k_test: int = 8, itm_batch: int = 16, shard_index: int = 0,
                       num_shards: int = 1, stats: Optional[Dict[str, float]] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (score_i2t [N_img, N_txt], score_t2i [N_txt, N_img]) in numpy fp32.

    ``image_embeds_frozen``: [N_img, S, D] frozen embeds on the host (for
    the ITM); ``query_feats`` [N_img, Q, E] and ``text_feats`` [N_txt, E]:
    normalised features on the model's device. ``stats`` (a dict), if
    given, receives the seconds of stage 1 (``stage1_s``) and of the two
    rescoring loops (``itm_i2t_s``, ``itm_t2i_s``) and the ITM calls made
    (``itm_calls``)."""
    device = query_feats.device
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    with torch.inference_mode():
        sims_t2i = model.token_max_sim(text_feats, query_feats)
        sims = sims_t2i.t().contiguous().cpu().numpy()  # [N_img, N_txt], JAX's layout
    stats["stage1_s"] = time.perf_counter() - t0
    stats["itm_calls"] = 0

    def itm(img: np.ndarray, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        stats["itm_calls"] += 1
        with torch.inference_mode():
            out = model.compute_itm(torch.from_numpy(np.ascontiguousarray(img)).to(device),
                                    torch.from_numpy(ids).to(device),
                                    torch.from_numpy(mask).to(device))
            return out.float().cpu().numpy()

    def rescore(rows: range, sims_rows: np.ndarray, by_image: bool) -> np.ndarray:
        out = np.full_like(sims_rows, -100.0)
        for i in rows:
            row = sims_rows[i]
            topk = np.argsort(-row, kind="stable")[:k_test]
            scores = []
            for s in range(0, len(topk), itm_batch):
                chunk = topk[s: s + itm_batch]
                if by_image:  # one image, many texts
                    img = np.repeat(image_embeds_frozen[i: i + 1], len(chunk), 0)
                    ids, mask = text_ids[chunk], text_mask[chunk]
                else:  # one text, many images
                    img = image_embeds_frozen[chunk]
                    ids = np.repeat(text_ids[i: i + 1], len(chunk), 0)
                    mask = np.repeat(text_mask[i: i + 1], len(chunk), 0)
                scores.append(itm(img, ids, mask))
            out[i, topk] = np.concatenate(scores) + row[topk]
        return out

    def shard(n: int) -> range:
        step = n // num_shards + 1
        return range(shard_index * step, min(n, (shard_index + 1) * step))

    t0 = time.perf_counter()
    score_i2t = rescore(shard(sims.shape[0]), sims, by_image=True)
    stats["itm_i2t_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    score_t2i = rescore(shard(sims.shape[1]), np.ascontiguousarray(sims.T), by_image=False)
    stats["itm_t2i_s"] = time.perf_counter() - t0
    return score_i2t, score_t2i


def retrieval_recalls(score_i2t: np.ndarray, score_t2i: np.ndarray,
                      img2txt: Dict[int, Sequence[int]], txt2img: Dict[int, int]
                      ) -> Dict[str, float]:
    """i2t / t2i R@{1,5,10} and their mean (reference tasks/retrieval.py:77-120)."""
    ranks = np.zeros(score_i2t.shape[0])
    for i, row in enumerate(score_i2t):
        order = np.argsort(-row, kind="stable")
        ranks[i] = min(np.where(np.isin(order, list(img2txt[i])))[0])
    tr = {f"txt_r{k}": 100.0 * float((ranks < k).mean()) for k in (1, 5, 10)}
    ranks_t = np.zeros(score_t2i.shape[0])
    for i, row in enumerate(score_t2i):
        order = np.argsort(-row, kind="stable")
        ranks_t[i] = int(np.where(order == txt2img[i])[0][0])
    ir = {f"img_r{k}": 100.0 * float((ranks_t < k).mean()) for k in (1, 5, 10)}
    out = {**tr, **ir}
    out["r_mean"] = (sum(tr.values()) / 3 + sum(ir.values()) / 3) / 2
    return out
