"""Model -> evaluation-task glue for evaluate-only runs (counterpart of
``sprc_tpu/train/eval_glue.py``).

:func:`eval_loader` batches an evaluation split at a fixed batch size,
padding the last batch by repeating its final item (the caller drops the
padded rows' results); :func:`collate_eval` stacks the images and lists
everything else. :func:`make_caption_generate_fn` binds a model and a
tokenizer into the ``generate_fn`` that ``CaptionTask.valid_step`` calls,
and :func:`make_blip2_vqa_predict_fn` into the ``predict_fn`` of the VQA
tasks. Ported: the BLIP-2 LLM heads' branches (``blip2_opt``,
``blip2_t5``); the ``blip_caption`` branch and BLIP-1 / ALBEF's ranked VQA
come with BLIP-1 (ROADMAP A8.6), the classification glue with its family.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def eval_loader(dataset, batch_size: int):
    """Yield (indices, items) batches covering every sample; the last batch
    is padded by repeating its final item (results for padded rows are
    dropped by the caller via the indices' length)."""
    n = len(dataset)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        items = [dataset[i] for i in idx]
        while len(items) < batch_size:
            items.append(items[-1])
        yield idx, items


def _stack_images(items: List[dict], key: str = "image") -> np.ndarray:
    return np.stack([np.asarray(it[key], np.float32) for it in items])


def collate_eval(items: List[dict]) -> dict:
    """Batch evaluation items: stack image arrays, list everything else."""
    out: dict = {}
    for key in items[0]:
        if key.startswith("image") and not key.endswith("_id"):
            out[key] = _stack_images(items, key)
        else:
            out[key] = [it[key] for it in items]
    return out


def _require_llm_head(model) -> None:
    """Refuse a model that is not a BLIP-2 LLM head."""
    from sprc_tpu_torch.models.blip2_opt import Blip2OPT
    from sprc_tpu_torch.models.blip2_t5 import Blip2T5

    if not isinstance(model, (Blip2OPT, Blip2T5)):
        raise NotImplementedError(f"{type(model).__name__}: its glue is not ported (BLIP-1's "
                                  "blip_caption and ranked VQA: ROADMAP A8.6)")


def _generate(model, tokenizer, samples: dict, texts: List[str], max_text: int,
              max_new_tokens: int, stats: Optional[Dict[str, float]]) -> List[str]:
    """The head's greedy ids after ``texts`` (tokenized at ``max_text``),
    each row decoded by the tokenizer."""
    device = next(model.parameters()).device
    images = torch.from_numpy(np.ascontiguousarray(samples["image"], np.float32)).to(device)
    tok = tokenizer(texts, max_length=max_text)
    with torch.inference_mode():
        ids = model.generate_ids(images, torch.from_numpy(tok["input_ids"]).to(device),
                                 torch.from_numpy(tok["attention_mask"]).to(device),
                                 max_new_tokens=max_new_tokens, stats=stats)
    return [tokenizer.decode(row).strip() for row in ids.cpu().numpy()]


def make_caption_generate_fn(model, tokenizer, *, prompt: str = "a picture of ",
                             stats: Optional[Dict[str, float]] = None) -> Callable:
    """``generate_fn(samples, num_beams, max_length, min_length) -> [str]``
    for the BLIP-2 LLM heads: the prompt tokenized at ``max_length=16``, the
    greedy decode of ``max_length`` tokens with the head's own eos / pad
    defaults (OPT 2 / 1, T5 1 / 0, whatever the tokenizer), each row decoded
    by the tokenizer (reference blip2_{opt,t5}.generate). ``num_beams`` and
    ``min_length`` are not read, as in the JAX glue. ``stats`` collects the
    head's seconds by stage over every batch."""
    _require_llm_head(model)

    def generate_fn(samples: dict, *, num_beams: int = 3, max_length: int = 30,
                    min_length: int = 10) -> List[str]:
        n = len(samples["image"])
        return _generate(model, tokenizer, samples, [prompt or ""] * n, 16, max_length, stats)

    return generate_fn


def make_blip2_vqa_predict_fn(model, tokenizer, *,
                              stats: Optional[Dict[str, float]] = None) -> Callable:
    """Zero-shot VQA through the BLIP-2 LLM heads
    (``sprc_tpu/train/eval_glue.py:158-183``; reference
    blip2_t5.predict_answers): each question rendered through the task's
    ``prompt`` (``prompt.format(q)`` where it holds ``{}``, else ``prompt +
    q``), tokenized at ``max_length=35``, and ``max_len`` tokens decoded
    greedily. Inference is generative only: another ``inference_method``
    (ranked VQA, BLIP-1 / ALBEF's) refuses, naming ROADMAP A8.6;
    ``num_beams`` and ``min_len`` are not read, as in the JAX glue.
    ``stats`` as :func:`make_caption_generate_fn`'s."""
    _require_llm_head(model)

    def predict_fn(samples: dict, *, inference_method: str = "generate", num_beams: int = 1,
                   max_len: int = 10, min_len: int = 1, prompt: str = "") -> List[str]:
        if inference_method != "generate":
            raise NotImplementedError(f"inference_method {inference_method!r}: the BLIP-2 "
                                      "heads answer generatively (ranked VQA: ROADMAP A8.6)")
        questions = [prompt.format(q) if "{}" in prompt else (prompt + q if prompt else q)
                     for q in samples["text_input"]]
        return _generate(model, tokenizer, samples, questions, 35, max_len, stats)

    return predict_fn
