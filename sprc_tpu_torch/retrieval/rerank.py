"""Two-stage retrieve -> rerank (counterpart of
``sprc_tpu/retrieval/rerank.py``).

After the stage-1 ranking, each query's top ``top`` candidates are scored
again by a model's ``inference_rerank`` and that prefix of its ranking is
rewritten by the new scores; ties and the rest of the ranking stay put
(reference src/validate_blip_rerank.py:197-221 for CIRR val,
src/cirr_test_submission.py:87-112 for the test submission).

:func:`rerank_rankings` is a copy of the JAX package's numpy loop (a test
pins the two equal). :class:`ItmRerankScorer` runs one tile of ``step``
queries times ``top`` candidates on the model's device: the candidates'
rows are gathered on the host per tile and uploaded, each query's reference
rows and text are repeated ``top`` times on the device, and
``inference_rerank`` scores the ``step x top`` pairs. Device memory stays
bounded by one tile whatever the gallery's size. The JAX scorer pads the
last tile to ``step`` queries for one compiled shape; this one runs the
short tile as it is (the scores are the same).

Under ``--mesh`` (the scorer's ``mesh``) every rank runs the same loop:
the tile's rows come from the ranks that hold them
(``GalleryIndex.reference_embeds``), each rank scores its contiguous share
of the tile's queries (all their candidates), and the scores are gathered
in query order, so every rank rewrites the same ranking.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch


def rerank_rankings(
    sorted_names: np.ndarray,
    reference_names: Sequence[str],
    captions: Sequence[str],
    score_fn: Callable[[np.ndarray, np.ndarray, Sequence[str]], np.ndarray],
    name_to_embed: Callable[[Sequence[str]], np.ndarray],
    *,
    top: int,
    step: int,
    cand_to_embed: Callable[[Sequence[str]], np.ndarray] | None = None,
) -> np.ndarray:
    """Rewrite the top-``top`` prefix of each row by rerank scores.

    Args:
      sorted_names: [B, M] array of gallery names, best-first (stage 1).
      score_fn: (ref_embeds [s, S, D], cand_embeds [s*top, S, D],
        captions) -> scores [s*top]; higher = better.
      name_to_embed: names -> frozen embeddings [n, S, D].
      cand_to_embed: candidate-side gather when the reranker consumes a
        different representation than the reference side (feature-space
        rerankers take projected feats [n, Q, E] — …cir_cat.py:337-396);
        defaults to ``name_to_embed``.
    """
    cand_to_embed = cand_to_embed or name_to_embed
    sorted_names = np.array(sorted_names, copy=True)
    n = len(sorted_names)
    i = 0
    while i < n:
        s = min(step, n - i)
        refs = name_to_embed(reference_names[i : i + s])
        cand_names = sorted_names[i : i + s, :top]
        cands = cand_to_embed(cand_names.reshape(-1))
        scores = np.asarray(score_fn(refs, cands, captions[i : i + s]))
        order = np.argsort(1.0 - scores.reshape(s, top), axis=-1, kind="stable")
        for j in range(s):
            sorted_names[i + j, :top] = cand_names[j][order[j]]
        i += s
    return sorted_names


class ItmRerankScorer:
    """The ``score_fn`` of :func:`rerank_rankings` over a model's
    ``inference_rerank``, on the model's device, under
    ``torch.inference_mode()``. ``seconds`` holds the host seconds of the
    tiles so far by stage: tokenising, the candidates' and references'
    upload (their gather is the caller's ``cand_to_embed``), the model
    (enqueue and the scores' readback, which waits for the device)."""

    def __init__(self, model, tokenizer, *, top: int, step: int, mesh=None):
        if not hasattr(model, "inference_rerank"):
            raise ValueError(f"{type(model).__name__} has no inference_rerank: rerank needs a "
                             "rerank-capable model (blip2_cir_rerank, blip2_cir_cat)")
        self.model = model
        self.tokenizer = tokenizer
        self.top = top
        self.step = step
        self.device = next(model.parameters()).device
        self.mesh = mesh
        self.seconds = {"tokenize": 0.0, "upload": 0.0, "model": 0.0}

    def __call__(self, refs, cands, captions) -> np.ndarray:
        """refs [s, S, D]; cands [s * top, ...] (frozen embeds or target
        feats, host or device) -> scores [s * top] (numpy fp32)."""
        if self.mesh is None:
            return self._score(refs, cands, captions)
        import torch.distributed as torch_dist

        s, top, world = len(captions), self.top, self.mesh.world
        per = -(-s // world)
        lo, hi = min(s, self.mesh.rank * per), min(s, (self.mesh.rank + 1) * per)
        mine = torch.zeros(per * top, dtype=torch.float32, device=self.mesh.device)
        if hi > lo:
            mine[: (hi - lo) * top] = torch.from_numpy(self._score(
                refs[lo:hi], cands[lo * top: hi * top], captions[lo:hi])).to(self.mesh.device)
        parts = [torch.empty_like(mine) for _ in range(world)]
        torch_dist.all_gather(parts, mine)
        return torch.cat(parts)[: s * top].cpu().numpy()

    def _score(self, refs, cands, captions) -> np.ndarray:
        """One device's share of a tile."""
        clock = time.perf_counter
        t0 = clock()
        tok = self.tokenizer(list(captions), max_length=self.model.cfg.max_txt_len)
        t1 = clock()
        with torch.inference_mode():
            refs = torch.as_tensor(refs).to(self.device, non_blocking=True)
            cands = torch.as_tensor(cands).to(self.device, non_blocking=True)
            ids = torch.as_tensor(np.asarray(tok["input_ids"]), device=self.device)
            mask = torch.as_tensor(np.asarray(tok["attention_mask"]), device=self.device)
            t2 = clock()
            # each query's reference and text once per candidate, on the device
            top = self.top
            scores = self.model.inference_rerank(
                refs.repeat_interleave(top, dim=0), cands, ids.repeat_interleave(top, dim=0),
                mask.repeat_interleave(top, dim=0))
            out = scores.float().cpu().numpy()
        t3 = clock()
        for stage, dt in (("tokenize", t1 - t0), ("upload", t2 - t1), ("model", t3 - t2)):
            self.seconds[stage] += dt
        return out
