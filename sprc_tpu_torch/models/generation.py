"""Autoregressive decoding over a model's prefill / decode-step surface
(counterpart of ``sprc_tpu/models/generation.py``).

Ported: :func:`cached_greedy_loop`, the KV-cached greedy decode of the
BLIP-2 LLM heads (``blip2_opt``, ``blip2_t5``). The JAX loop fuses token
selection with the next cached step into one jitted dispatch a token; here
it is a plain Python loop over the step function, whose operations queue on
the device without a host read but for the early-exit check every
``READBACK_EVERY`` tokens. ``cached_beam_loop``, ``sample_generate`` and
``greedy_generate_fn`` come with ``pnp_vqa``, their only caller (ROADMAP A8).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, Optional

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
