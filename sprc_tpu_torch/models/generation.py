"""Autoregressive decoding over a model's prefill / decode-step surface
(counterpart of ``sprc_tpu/models/generation.py``).

Ported: :func:`cached_greedy_loop`, the KV-cached greedy decode of the
BLIP-2 LLM heads (``blip2_opt``, ``blip2_t5``) and of PNP-VQA's FiD reader,
and :func:`cached_beam_loop`, the KV-cached beam search of Img2Prompt's
question generator. The JAX loops fuse token selection with the next cached
step into one jitted dispatch a token; here each is a plain Python loop over
the step function, whose operations queue on the device without a host read
but for the early-exit check every ``READBACK_EVERY`` tokens.

:func:`sample_generate` (PNP-VQA's caption sampler: top-k, top-p,
temperature, repetition penalty, ``min_length``) and
:func:`greedy_generate_fn` decode over a ``logits_fn(ids[, memory]) -> [B,
L, V]`` that recomputes the whole fixed-width prefix every step, as the JAX
functions do, and read the device once a step for the early exit. The
draws come from an explicit ``torch.Generator`` (``torch.multinomial`` over
the filtered softmax); ``jax.random`` draws other numbers, so a sampled
sequence is not the JAX package's for the same seed.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

Tensor = torch.Tensor
READBACK_EVERY = 4  # tokens between the early-exit checks (a host read each)


@contextlib.contextmanager
def stage(stats: Optional[Dict[str, float]], key: str, device: torch.device) -> Iterator[None]:
    """Add the seconds of the block to ``stats[key]`` (nothing without
    ``stats``); on the card the device is synchronized at the block's end, so
    a stage's time holds its own kernels."""
    if stats is None:
        yield
        return
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats[key] = stats.get(key, 0.0) + time.perf_counter() - t0


def cached_greedy_loop(logits0: Tensor, cache, pos0: Tensor, step_fn: Callable, *,
                       eos_token_id: int, pad_token_id: int, max_new_tokens: int,
                       min_new_tokens: int = 0) -> Tensor:
    """Greedy decode -> generated ids [B, max_new_tokens] (int64).

    ``logits0`` [B, V]: the logits at each row's last prefix position;
    ``pos0`` [B]: the buffer position the next token takes; ``step_fn(tok
    [B], pos [B], cache) -> (logits [B, V], cache)``. Before
    ``min_new_tokens`` tokens the eos logit is set to -1e9; a finished row
    gets ``pad_token_id``; every ``READBACK_EVERY`` tokens the loop stops if
    every row has finished; the last position is selected without a cache
    step."""
    B = logits0.shape[0]
    device = logits0.device
    ids = torch.full((B, max_new_tokens), pad_token_id, dtype=torch.long, device=device)
    finished = torch.zeros(B, dtype=torch.bool, device=device)

    def select(logits: Tensor, finished: Tensor, t: int):
        logits = logits.float()
        if t < min_new_tokens:
            logits = logits.clone()
            logits[:, eos_token_id] = -1e9
        tok = torch.argmax(logits, dim=-1)
        tok = torch.where(finished, torch.full_like(tok, pad_token_id), tok)
        ids[:, t] = tok
        return tok, finished | (tok == eos_token_id)

    logits, pos = logits0, pos0
    for t in range(max_new_tokens):
        if t == max_new_tokens - 1:  # the last position: no wasted cache step
            select(logits, finished, t)
            break
        tok, finished = select(logits, finished, t)
        logits, cache = step_fn(tok, pos, cache)
        pos = pos + 1
        if t % READBACK_EVERY == READBACK_EVERY - 1 and bool(finished.all()):
            break
    return ids


def cached_beam_loop(logits0: Tensor, state0, pos0: Tensor, step_fn: Callable,
                     gather_fn: Callable, *, num_beams: int, eos_token_id: int,
                     pad_token_id: int, max_new_tokens: int, min_new_tokens: int = 0,
                     length_penalty: float = 1.0) -> Tensor:
    """Beam search over a prefill / cached-step surface -> each item's best
    sequence [B, max_new_tokens] (int64).

    The caller prefilled B * K rows, each item's prefix repeated once a beam
    (``repeat_interleave(K, dim=0)``): ``logits0`` [B * K, V], ``state0`` its
    step state, ``pos0`` [B * K] the position the next token takes;
    ``step_fn(tok, pos, state) -> (logits, state)`` and ``gather_fn(state,
    rows) -> state`` with the rows [B * K] reordered. A step: fp32 log-softmax
    (the eos logit -1e9 before ``min_new_tokens``), a finished beam's
    log-probabilities -1e9 but 0 for the pad, the top K of each item's K x V
    running sums (only the first beam alive at the start), then the ids,
    finished flags, state and positions follow the chosen rows. The top K is
    a stable descending sort, so ties go to the lower index, as
    ``jax.lax.top_k`` breaks them (``torch.topk`` promises no order). Every
    ``READBACK_EVERY`` tokens the loop stops if every beam has finished; the
    last position is selected without a step. The best beam of an item has
    the largest ``score / length ** length_penalty``, the length counting the
    non-pad ids and the implied start token (HF's), the first such beam on a
    tie."""
    BK, V = logits0.shape
    K = num_beams
    assert BK % K == 0
    B = BK // K
    device = logits0.device
    ids = torch.full((BK, max_new_tokens), pad_token_id, dtype=torch.long, device=device)
    scores = torch.zeros(B, K, dtype=torch.float32, device=device)
    scores[:, 1:] = -1e9  # the beams are the same row at the start: keep one
    finished = torch.zeros(BK, dtype=torch.bool, device=device)
    base = torch.arange(B, device=device)[:, None] * K

    def select(logits: Tensor, ids: Tensor, scores: Tensor, finished: Tensor, t: int):
        logits = logits.float()
        if t < min_new_tokens:
            logits = logits.clone()
            logits[:, eos_token_id] = -1e9
        logp = torch.log_softmax(logits, dim=-1)
        pad = torch.where(finished, 0.0, logp[:, pad_token_id])
        logp = torch.where(finished[:, None], -1e9, logp)
        logp[:, pad_token_id] = pad
        total = (scores.reshape(BK, 1) + logp).reshape(B, K * V)
        order = torch.sort(total, dim=-1, descending=True, stable=True).indices[:, :K]
        new_scores = torch.gather(total, 1, order)
        rows = (base + order // V).reshape(-1)
        tok = (order % V).reshape(-1)
        ids = ids[rows]
        ids[:, t] = tok
        return ids, new_scores, finished[rows] | (tok == eos_token_id), rows, tok

    logits, pos, state = logits0, pos0, state0
    for t in range(max_new_tokens):
        if t == max_new_tokens - 1:  # the last position: no wasted cache step
            ids, scores, finished, _, _ = select(logits, ids, scores, finished, t)
            break
        ids, scores, finished, rows, tok = select(logits, ids, scores, finished, t)
        state = gather_fn(state, rows)
        pos = pos[rows]
        logits, state = step_fn(tok, pos, state)
        pos = pos + 1
        if t % READBACK_EVERY == READBACK_EVERY - 1 and bool(finished.all()):
            break
    ids_np = ids.cpu().numpy()
    scores_np = scores.cpu().numpy().astype(np.float64)
    best = []
    for b in range(B):
        best_k, best_score = 0, -np.inf
        for k in range(K):
            length = int((ids_np[b * K + k] != pad_token_id).sum()) + 1  # + the start token
            score = scores_np[b, k] / (length ** length_penalty)
            if score > best_score:
                best_k, best_score = k, score
        best.append(b * K + best_k)
    return torch.from_numpy(ids_np[best]).to(device)


def _apply_repetition_penalty(logits: Tensor, ids: Tensor, step: int, penalty: float) -> Tensor:
    """HF semantics: the logits of the tokens in ``ids[:, :step]`` divided by
    ``penalty`` where positive, multiplied where negative."""
    if penalty == 1.0:
        return logits
    seen = torch.zeros_like(logits, dtype=torch.bool).scatter_(1, ids[:, :step], True)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def _filter_top_k(logits: Tensor, k: int) -> Tensor:
    """-inf below the k-th largest logit of each row (ties at it kept)."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < thresh, float("-inf"))


def _filter_top_p(logits: Tensor, p: float) -> Tensor:
    """Nucleus filter: keep the largest logits until their softmax mass
    before them exceeds ``p`` (the top one always kept)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff = torch.where(cum - probs > p, float("inf"), sorted_logits).amin(dim=-1,
                                                                            keepdim=True)
    return logits.masked_fill(logits < cutoff, float("-inf"))


def sample_generate(logits_fn: Callable, prompt_ids: Tensor, *, generator: torch.Generator,
                    eos_token_id: int, pad_token_id: int, max_length: int = 20,
                    min_length: int = 0, top_k: int = 50, top_p: float = 1.0,
                    temperature: float = 1.0, repetition_penalty: float = 1.0,
                    memory=None) -> Tensor:
    """Top-k / nucleus sampling -> ids [B, max_length] (int64), the prompt
    [B, P] first. ``logits_fn(ids)``, or ``logits_fn(ids, memory)`` where
    ``memory`` is given, takes the whole padded buffer; the step reads
    position ``step - 1``. Before ``min_length`` new tokens the eos logit is
    -inf; a finished row gets ``pad_token_id``; the loop stops when every row
    has finished."""
    B, P = prompt_ids.shape
    assert P < max_length
    device = prompt_ids.device
    ids = torch.full((B, max_length), pad_token_id, dtype=torch.long, device=device)
    ids[:, :P] = prompt_ids
    finished = torch.zeros(B, dtype=torch.bool, device=device)
    for step in range(P, max_length):
        raw = logits_fn(ids) if memory is None else logits_fn(ids, memory)
        logits = _apply_repetition_penalty(raw[:, step - 1, :].float(), ids, step,
                                           repetition_penalty)
        if step < min_length + P:
            logits[:, eos_token_id] = float("-inf")
        logits = _filter_top_p(_filter_top_k(logits / max(temperature, 1e-6), top_k), top_p)
        tok = torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[:, 0]
        tok = torch.where(finished, torch.full_like(tok, pad_token_id), tok)
        ids[:, step] = tok
        finished = finished | (tok == eos_token_id)
        if bool(finished.all()):
            break
    return ids


def greedy_generate_fn(logits_fn: Callable, prompt_ids: Tensor, *, eos_token_id: int,
                       pad_token_id: int, max_length: int = 20, min_length: int = 0,
                       memory=None) -> Tensor:
    """Greedy decode over a recomputing ``logits_fn`` (as
    :func:`sample_generate`'s) -> ids [B, max_length] (int64)."""
    B, P = prompt_ids.shape
    device = prompt_ids.device
    ids = torch.full((B, max_length), pad_token_id, dtype=torch.long, device=device)
    ids[:, :P] = prompt_ids
    finished = torch.zeros(B, dtype=torch.bool, device=device)
    for step in range(P, max_length):
        raw = logits_fn(ids) if memory is None else logits_fn(ids, memory)
        logits = raw[:, step - 1, :].float()
        if step < min_length + P:
            logits[:, eos_token_id] = float("-inf")
        tok = torch.argmax(logits, dim=-1)
        tok = torch.where(finished, torch.full_like(tok, pad_token_id), tok)
        ids[:, step] = tok
        finished = finished | (tok == eos_token_id)
        if bool(finished.all()):
            break
    return ids
