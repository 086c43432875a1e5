"""Offline caption metrics: corpus BLEU and CIDEr-D (a copy of
``sprc_tpu/retrieval/caption_eval.py``, which imports nothing of JAX; a test
holds the two equal).

The reference scores captions with pycocoevalcap's COCOEvalCap
(tasks/captioning.py:78-117, tasks/dialogue.py:68-128), which shells out to
Java METEOR/SPICE and downloads ground-truth JSONs — unavailable in a
machine without network access. These are faithful numpy implementations of the two
metrics LAVIS actually aggregates (``CIDEr + Bleu_4``):

- BLEU follows the pycocoevalcap/Moses definition: per-n clipped precision,
  geometric mean, corpus-level brevity penalty with *shortest-reference*
  length matching (pycocoevalcap bleu_scorer.py uses closest; COCO eval
  calls it with the default "closest").
- CIDEr-D (Vedantam et al. 2015): tf-idf over 1..4-gram counts, document
  frequencies from the reference corpus, length gaussian (sigma 6), clipped
  candidate counts, x10 scale.

Tokenization is the PTB-less lowercase/split the reference applies upstream
(captions are pre-cleaned by blip_caption); punctuation handling therefore
stays with the caller.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(
    candidates: Sequence[str],
    references: Sequence[Sequence[str]],
    max_n: int = 4,
) -> List[float]:
    """-> [BLEU-1, ..., BLEU-max_n] corpus scores in [0, 1]."""
    assert len(candidates) == len(references)
    clipped = [0] * max_n
    totals = [0] * max_n
    cand_len = 0
    ref_len = 0
    for cand, refs in zip(candidates, references):
        ct = cand.split()
        rts = [r.split() for r in refs]
        cand_len += len(ct)
        # closest reference length (ties -> shorter), Moses/pycocoevalcap
        ref_len += min((abs(len(r) - len(ct)), len(r)) for r in rts)[1]
        for n in range(1, max_n + 1):
            cn = _ngrams(ct, n)
            if not cn:
                continue
            best = Counter()
            for rt in rts:
                rn = _ngrams(rt, n)
                for g, c in rn.items():
                    best[g] = max(best[g], c)
            totals[n - 1] += sum(cn.values())
            clipped[n - 1] += sum(min(c, best.get(g, 0)) for g, c in cn.items())
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    out = []
    logsum = 0.0
    for n in range(max_n):
        # tiny-epsilon smoothing like pycocoevalcap (avoids log 0)
        p = clipped[n] / totals[n] if totals[n] else 0.0
        logsum += math.log(max(p, 1e-16))
        out.append(bp * math.exp(logsum / (n + 1)))
    return out


def cider_d(
    candidates: Sequence[str],
    references: Sequence[Sequence[str]],
    max_n: int = 4,
    sigma: float = 6.0,
) -> float:
    """Corpus CIDEr-D in [0, ~10] (the COCO convention multiplies by 10)."""
    assert len(candidates) == len(references)
    # document frequencies over reference *images* (each image counts once)
    df: Dict[tuple, float] = defaultdict(float)
    ref_ngrams = []
    for refs in references:
        per_image = [
            {n: _ngrams(r.split(), n) for n in range(1, max_n + 1)} for r in refs
        ]
        ref_ngrams.append(per_image)
        seen = set()
        for grams in per_image:
            for n_counter in grams.values():
                seen.update(n_counter.keys())
        for g in seen:
            df[g] += 1.0
    log_total = math.log(max(float(len(references)), 1.0))

    def tfidf(counter: Counter, length: int):
        vec: Dict[tuple, float] = {}
        norm = 0.0
        for g, c in counter.items():
            idf = log_total - math.log(max(df.get(g, 0.0), 1.0))
            v = float(c) * idf
            vec[g] = v
            norm += v * v
        return vec, math.sqrt(norm)

    score = 0.0
    for cand, refs, per_image in zip(candidates, references, ref_ngrams):
        ct = cand.split()
        sims = [0.0] * max_n
        for n in range(1, max_n + 1):
            cvec, cnorm = tfidf(_ngrams(ct, n), len(ct))
            for grams, ref in zip(per_image, refs):
                rt = ref.split()
                rvec, rnorm = tfidf(grams[n], len(rt))
                num = sum(min(cvec[g], rvec.get(g, 0.0)) * rvec.get(g, 0.0)
                          for g in cvec)  # CIDEr-D clips candidate counts
                if cnorm and rnorm:
                    sim = num / (cnorm * rnorm)
                else:
                    sim = 0.0
                delta = len(ct) - len(rt)
                sim *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                sims[n - 1] += sim
        n_refs = max(len(refs), 1)
        score += 10.0 * sum(s / n_refs for s in sims) / max_n
    return score / max(len(candidates), 1)


def caption_metrics(
    candidates: Sequence[str], references: Sequence[Sequence[str]]
) -> Dict[str, float]:
    """The LAVIS aggregate: Bleu_1..4 + CIDEr, agg = CIDEr + Bleu_4
    (reference tasks/captioning.py:107-116)."""
    bleu = corpus_bleu(candidates, references)
    cider = cider_d(candidates, references)
    out = {f"Bleu_{i + 1}": b for i, b in enumerate(bleu)}
    out["CIDEr"] = cider
    out["agg_metrics"] = cider + bleu[3]
    return out
