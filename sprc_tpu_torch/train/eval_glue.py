"""Model -> evaluation-task glue for evaluate-only runs (counterpart of
``sprc_tpu/train/eval_glue.py``).

:func:`eval_loader` batches an evaluation split at a fixed batch size,
padding the last batch by repeating its final item (the caller drops the
padded rows' results); :func:`collate_eval` stacks the images and lists
everything else. :func:`make_caption_generate_fn` binds a model and a
tokenizer into the ``generate_fn`` that ``CaptionTask.valid_step`` calls,
and :func:`make_blip2_vqa_predict_fn` into the ``predict_fn`` of the VQA
tasks: the BLIP-2 LLM heads' branches (``blip2_opt``, ``blip2_t5``).
:func:`make_vqa_predict_fn` is BLIP-1 / ALBEF's VQA glue (``blip_vqa``,
``albef_vqa``): ``rank`` over the run's answer list (tokenized once, at
``max_len``) or ``generate``; :func:`make_classification_predict_fn` the
classifiers', NLVR's and ALPRO QA's (over a batch of clips) logits beside
the targets. BLIP-1's captioner
(``blip_caption``) decodes greedily from the ``[DEC]``-prefixed prompt.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

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


def _is_llm_head(model) -> bool:
    from sprc_tpu_torch.models.blip2_opt import Blip2OPT
    from sprc_tpu_torch.models.blip2_t5 import Blip2T5

    return isinstance(model, (Blip2OPT, Blip2T5))


def _require_llm_head(model) -> None:
    """Refuse a model that is not a BLIP-2 LLM head."""
    if not _is_llm_head(model):
        raise NotImplementedError(f"{type(model).__name__}: this glue is the BLIP-2 LLM heads' "
                                  "(no VQA glue fits ALPRO's video QA, in either package: it "
                                  "is multimodal_classification over run.answer_list)")


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
    """``generate_fn(samples, num_beams, max_length, min_length) -> [str]``.

    The BLIP-2 LLM heads: the prompt tokenized at ``max_length=16``, the
    greedy decode of ``max_length`` tokens with the head's own eos / pad
    defaults (OPT 2 / 1, T5 1 / 0, whatever the tokenizer), each row decoded
    by the tokenizer and stripped (reference blip2_{opt,t5}.generate).
    BLIP-1's captioner (``sprc_tpu/train/eval_glue.py:66-85``): the prompt's
    ids with ``[DEC]`` (``[CLS]`` where the vocabulary has no ``[DEC]``)
    first and no trailing ``[SEP]`` (reference blip_caption.py:184), the
    greedy decode of ``max_length`` tokens ending at ``[SEP]``, each row
    decoded by the tokenizer. ``num_beams`` and ``min_length`` are not
    read, as in the JAX glue. ``stats`` collects the model's seconds by
    stage over every batch."""
    from sprc_tpu_torch.models.blip1 import BlipCaption

    if _is_llm_head(model):
        def generate_fn(samples: dict, *, num_beams: int = 3, max_length: int = 30,
                        min_length: int = 10) -> List[str]:
            n = len(samples["image"])
            return _generate(model, tokenizer, samples, [prompt or ""] * n, 16, max_length,
                             stats)

        return generate_fn
    if not isinstance(model, BlipCaption):
        raise NotImplementedError(f"{type(model).__name__}: no captioning glue fits it, in "
                                  "either package (the captioners: blip_caption, blip2_opt, "
                                  "blip2_t5)")
    prompt_row = np.asarray(tokenizer.caption_prompt_ids(prompt), np.int64)
    device = next(model.parameters()).device

    def generate_fn(samples: dict, *, num_beams: int = 3, max_length: int = 30,
                    min_length: int = 10) -> List[str]:
        images = torch.from_numpy(np.ascontiguousarray(samples["image"], np.float32)).to(device)
        prompt_ids = torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(prompt_row, (images.shape[0], prompt_row.shape[0])))).to(device)
        ids = model.generate_ids(images, prompt_ids, eos_token_id=tokenizer.sep_id,
                                 pad_token_id=tokenizer.pad_id, max_new_tokens=max_length,
                                 stats=stats)
        return [tokenizer.decode(row) for row in ids.cpu().numpy()]

    return generate_fn


def make_blip2_vqa_predict_fn(model, tokenizer, *,
                              stats: Optional[Dict[str, float]] = None) -> Callable:
    """Zero-shot VQA through the BLIP-2 LLM heads
    (``sprc_tpu/train/eval_glue.py:158-183``; reference
    blip2_t5.predict_answers): each question rendered through the task's
    ``prompt`` (``prompt.format(q)`` where it holds ``{}``, else ``prompt +
    q``), tokenized at ``max_length=35``, and ``max_len`` tokens decoded
    greedily. Inference is generative only: another ``inference_method``
    refuses (ranking an answer list is BLIP-1 / ALBEF's,
    :func:`make_vqa_predict_fn`);
    ``num_beams`` and ``min_len`` are not read, as in the JAX glue.
    ``stats`` as :func:`make_caption_generate_fn`'s."""
    _require_llm_head(model)

    def predict_fn(samples: dict, *, answer_list=None, inference_method: str = "generate",
                   num_beams: int = 1, max_len: int = 10, min_len: int = 1,
                   num_ans_candidates: int = 0, prompt: str = "") -> List[str]:
        if inference_method != "generate":
            raise NotImplementedError(f"inference_method {inference_method!r}: the BLIP-2 "
                                      "heads answer generatively (ranked VQA is blip_vqa / "
                                      "albef_vqa's)")
        questions = [prompt.format(q) if "{}" in prompt else (prompt + q if prompt else q)
                     for q in samples["text_input"]]
        return _generate(model, tokenizer, samples, questions, 35, max_len, stats)

    return predict_fn


def _tensor(a, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def make_vqa_predict_fn(model, tokenizer, *,
                        stats: Optional[Dict[str, float]] = None) -> Callable:
    """BLIP-1 / ALBEF's ``predict_fn(samples, answer_list, inference_method,
    ...) -> [str]`` (``sprc_tpu/train/eval_glue.py:88-128``; reference
    blip_vqa.py predict_answers): the questions (after ``prompt``) at
    ``max_length=35``; ``rank`` tokenizes ``answer_list`` once at
    ``max_len`` and returns ``answer_list[best]`` of
    :meth:`~sprc_tpu_torch.models.vqa.VQAModel.rank_answers`; ``generate``
    decodes ``max_len`` tokens greedily from the tokenizer's ``bos_id`` (or
    ``cls_id``) to ``sep_id``. ``num_beams`` and ``min_len`` are not read, as
    in the JAX glue. ``stats``: the model's seconds by stage, summed over
    the batches."""
    from sprc_tpu_torch.models.vqa import VQAModel

    if not isinstance(model, VQAModel):
        raise NotImplementedError(f"{type(model).__name__}: the ranked / generative VQA glue "
                                  "is blip_vqa / albef_vqa's")
    device = next(model.parameters()).device
    answer_cache: Dict[int, tuple] = {}

    def predict_fn(samples: dict, *, answer_list: Optional[Sequence[str]] = None,
                   inference_method: str = "rank", num_beams: int = 3, max_len: int = 10,
                   min_len: int = 1, num_ans_candidates: int = 128,
                   prompt: str = "") -> List[str]:
        images = _tensor(samples["image"], device, np.float32)
        questions = [prompt + q if prompt else q for q in samples["text_input"]]
        qtok = tokenizer(questions, max_length=35)
        q_ids, q_mask = (_tensor(qtok[k], device) for k in ("input_ids", "attention_mask"))
        with torch.inference_mode():
            if inference_method == "rank":
                if not answer_list:
                    raise ValueError("rank inference needs run.answer_list")
                if id(answer_list) not in answer_cache:
                    answer_cache.clear()
                    atok = tokenizer(list(answer_list), max_length=max_len)
                    answer_cache[id(answer_list)] = tuple(
                        _tensor(atok[k], device) for k in ("input_ids", "attention_mask"))
                a_ids, a_mask = answer_cache[id(answer_list)]
                best, _ = model.rank_answers(images, q_ids, q_mask, a_ids, a_mask,
                                             num_ans_candidates=num_ans_candidates,
                                             pad_token_id=tokenizer.pad_id, stats=stats)
                return [answer_list[i] for i in best.tolist()]
            ids = model.generate_answers(
                images, q_ids, q_mask, bos_token_id=tokenizer.bos_id or tokenizer.cls_id,
                eos_token_id=tokenizer.sep_id, pad_token_id=tokenizer.pad_id,
                max_new_tokens=max_len, stats=stats)
        return [tokenizer.decode(row) for row in ids.cpu().numpy()]

    return predict_fn


def make_classification_predict_fn(model, tokenizer, *, max_txt_len: int = 35,
                                   stats: Optional[Dict[str, float]] = None) -> Callable:
    """``predict_fn(samples) -> {"predictions", "targets"}``
    (``sprc_tpu/train/eval_glue.py:131-155``; reference
    {blip,albef}_classification predict, blip_nlvr.py:118-140,
    alpro_qa.py:54-105): the sentences at ``max_txt_len``, the logits of
    ``predict`` (an NLVR pair when the samples hold ``image0`` / ``image1``;
    ALPRO QA's ``image`` a batch of clips) beside the labels.
    ``stats``: the model's seconds by stage (``tower_s``, ``text_s``)."""
    device = next(model.parameters()).device

    def predict_fn(samples: dict) -> Dict[str, np.ndarray]:
        tok = tokenizer(list(samples["text_input"]), max_length=max_txt_len)
        ids, mask = (_tensor(tok[k], device) for k in ("input_ids", "attention_mask"))
        keys = ("image0", "image1") if "image0" in samples else ("image",)
        images = [_tensor(samples[k], device, np.float32) for k in keys]
        with torch.inference_mode():
            logits = model.predict(*images, ids, mask, stats=stats)
        return {"predictions": logits.float().cpu().numpy(),
                "targets": np.asarray(samples["label"])}

    return predict_fn
