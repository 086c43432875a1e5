"""PNP-VQA, the plug-and-play zero-shot VQA pipeline (counterpart of
``sprc_tpu/models/pnp_vqa.py``; reference
lavis/models/pnp_vqa_models/pnp_vqa.py:20-339, pnp_unifiedqav2_fid.py).

Three pretrained models, composed:

1. localisation: GradCAM over BLIP-1's ITM cross-attention at ``block_num``
   (:func:`~sprc_tpu_torch.utils.gradcam.compute_gradcam`) gives each image
   a weight per patch for its question;
2. captioning: BLIP-1's captioner samples ``num_captions`` captions an image,
   each from the rows of ``num_patches`` patches drawn without replacement
   by those weights (Gumbel top-k), through the recomputing
   :func:`~sprc_tpu_torch.models.generation.sample_generate` (top-k 50), in
   up to five rounds until every image has that many distinct captions;
3. answering: a UnifiedQA-v2 T5 reads ``question \\n captions`` contexts
   with Fusion-in-Decoder (:class:`FiDT5`: each context encoded alone, the
   decoder cross-attending their concatenation) and answers greedily through
   the KV-cached decode (``decode_prefill`` / ``decode_step_logits``,
   :func:`~sprc_tpu_torch.models.generation.cached_greedy_loop`), one
   question at a time.

Both BLIP towers are ViT-L/16 at 384 px in the ``pnp_vqa`` YAMLs: on the
card every block is kernel K2 (24 a tower call); the med-BERTs and the T5
are ``torch.matmul``, as the JAX package's are XLA. The random draws (patch
noise, token sampling) come from a ``torch.Generator`` seeded from
``predict_answers(seed=)``; they are not ``jax.random``'s, so the sampled
captions (and so the answers) are not the JAX package's for the same seed;
:func:`top_k_patches` takes given noise, so that the selection can be held
against the JAX package's on its own draw.

``img2prompt_vqa`` (:class:`Img2PromptVqaPipeline`; reference
img2prompt_models/img2prompt_vqa.py:30-587) builds a prompt for an external
LLM from the same localisation and captioning: the captions whose ITM match
probability, their image re-encoded through the ITM tower (K2 on the card,
one call an image), reaches ``itm_filter_threshold``; answer candidates
extracted from them (:mod:`sprc_tpu_torch.text.pos`, or an injected
``tagger``); a question for each from a plain T5 (``t5-large``, ``arch: t5``)
through the KV-cached beam search (:func:`qg_beam_search`, 3 beams,
batches of 10 contexts); then the exemplar and context prompts. Its
``predict_answers`` is PNP-VQA's over the filtered captions, read by that
T5 through :meth:`PnpVqaPipeline.forward_qa`, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sprc_tpu_torch.models.generation import (cached_beam_loop, cached_greedy_loop,
                                              greedy_generate_fn, sample_generate, stage)
from sprc_tpu_torch.models.t5 import T5ForConditionalGeneration
from sprc_tpu_torch.registry import registry
from sprc_tpu_torch.utils.gradcam import compute_gradcam

Tensor = torch.Tensor
SUB_MODELS = ("image_question_matching_model", "image_captioning_model",
              "question_answering_model")


def prepare_qa_input(questions: Sequence[str], captions: Sequence[Sequence[str]], *,
                     num_captions: int, num_captions_fid: int) -> List[List[str]]:
    """question + caption FiD contexts (reference pnp_vqa_models/__init__.py):
    ``num_captions_fid`` captions a context, the last one partial; the count
    is the captions actually kept, which may be fewer than ``num_captions``."""
    out = []
    for question, caps in zip(questions, captions):
        contexts, chunk = [], ""
        kept = list(caps)[:num_captions]
        for cap_id, cap in enumerate(kept):
            chunk += cap.strip() + ". "
            last = (cap_id + 1) == len(kept)
            if last or (cap_id + 1) % num_captions_fid == 0:
                contexts.append(question.lower().strip() + " \\n " + chunk.lower().strip())
                chunk = ""
            if last:
                break
        out.append(contexts)
    return out


def top_k_patches(weights: Tensor, gumbel: Tensor, num_patches: int) -> Tensor:
    """Gumbel top-k over given noise: weights [B, P] (nonnegative),
    gumbel [B, num_samples, P] -> the sorted indices [B, num_samples,
    num_patches] of the largest ``log(max(w, 1e-12)) + g``."""
    scores = torch.log(weights.clamp_min(1e-12))[:, None, :] + gumbel
    return torch.sort(torch.topk(scores, num_patches, dim=-1).indices, dim=-1).values


def sample_patches(generator: torch.Generator, weights: Tensor, num_patches: int,
                   num_samples: int) -> Tensor:
    """Sampling without replacement by ``weights`` [B, P] -> sorted patch
    indices [B, num_samples, num_patches] (0-based; the caller adds 1 to
    skip the CLS row, as the reference's ``patch_id + 1``)."""
    B, P = weights.shape
    u = torch.rand((B, num_samples, P), generator=generator, device=weights.device)
    tiny = torch.finfo(torch.float32).tiny
    return top_k_patches(weights, -torch.log(-torch.log(u.clamp_min(tiny))), num_patches)


class FiDT5(T5ForConditionalGeneration):
    """Fusion-in-Decoder T5 (reference pnp_unifiedqav2_fid.py:19-110, after
    facebookresearch/FiD): each of ``n_ctx`` contexts is encoded alone
    (relative positions per context), and the decoder cross-attends the
    concatenation of their rows. A T5 itself, under HF's names: a released
    UnifiedQA-v2 checkpoint loads by name."""

    def encode_contexts(self, input_ids: Tensor, attention_mask: Tensor):
        """[B, n_ctx, L] -> (rows [B, n_ctx * L, d], mask [B, n_ctx * L])."""
        B, n_ctx, L = input_ids.shape
        enc = self.encode_ids(input_ids.reshape(B * n_ctx, L),
                              attention_mask.reshape(B * n_ctx, L))
        return enc.reshape(B, n_ctx * L, enc.shape[-1]), attention_mask.reshape(B, n_ctx * L)

    def forward(self, input_ids: Tensor, attention_mask: Tensor, decoder_input_ids: Tensor,
                decoder_mask: Optional[Tensor] = None) -> Tensor:
        enc_out, enc_mask = self.encode_contexts(input_ids, attention_mask)
        return self.decode(decoder_input_ids, enc_out, enc_mask, decoder_mask)


registry.register_model("pnp_unifiedqav2_fid")(FiDT5)


def fid_generate(model: FiDT5, input_ids: Tensor, attention_mask: Tensor, *, pad_id: int,
                 eos_id: int, max_length: int = 20, min_length: int = 0,
                 use_cache: bool = True) -> Tensor:
    """Greedy FiD answers [B, max_length] (int64), the start token (pad)
    first. ``use_cache``: the KV-cached decode, the fused rows' cross K/V
    projected once at prefill; else every step runs the decoder over the
    whole prefix (:func:`greedy_generate_fn`). Both give the same ids."""
    with torch.no_grad():
        enc_out, enc_mask = model.encode_contexts(input_ids, attention_mask)
        B = input_ids.shape[0]
        bos = torch.full((B, 1), pad_id, dtype=torch.long, device=input_ids.device)
        if not use_cache:
            return greedy_generate_fn(
                lambda ids, mem: model.decode(ids, *mem), bos, memory=(enc_out, enc_mask),
                eos_token_id=eos_id, pad_token_id=pad_id, max_length=max_length,
                min_length=min_length)
        logits0, cache = model.decode_prefill(bos, enc_out, enc_mask, max_length)
        out = cached_greedy_loop(
            logits0, cache, torch.ones(B, dtype=torch.long, device=bos.device),
            lambda tok, pos, c: model.decode_step_logits(tok, pos[:1], c, enc_mask),
            eos_token_id=eos_id, pad_token_id=pad_id, max_new_tokens=max_length - 1,
            min_new_tokens=min_length)
        return torch.cat([bos, out], dim=1)


def plain_t5(sub: Dict, *, device, seed: int, path: Optional[str] = None
             ) -> T5ForConditionalGeneration:
    """The ``arch: t5`` sub-model (``sprc_tpu/models/pnp_vqa.py:173-183``): the
    preset of its ``t5_model`` (default ``t5-large``) with the other keys
    replacing T5Config fields; random weights from ``seed``, or the HF-layout
    state dict at ``path`` through :func:`~sprc_tpu_torch.loader.read_checkpoint`
    with ``strict=True``."""
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.models.llm_presets import t5_preset

    sub = dict(sub)
    cfg = dataclasses.replace(t5_preset(sub.pop("t5_model", "t5-large")),
                              **loader.coerce_overrides(sub))
    with torch.device("meta"):
        model = T5ForConditionalGeneration(cfg)
    model = model.to_empty(device=device)
    if path is None:
        loader.init_weights(model, seed)
    else:
        model.load_state_dict(loader.read_checkpoint(path, model), strict=True)
    return model.eval()


def qg_beam_search(model: T5ForConditionalGeneration, enc_out: Tensor, enc_mask: Tensor, *,
                   num_beams: int, pad_id: int, eos_id: int, max_length: int,
                   use_cache: bool = True, steps: Optional[List[int]] = None) -> Tensor:
    """Beam search from encoded contexts [Bq, L, d] -> the best ids [Bq,
    max_length - 1] (int64), the pad start token not among them. Each row is
    repeated once a beam; ``use_cache``: the decoder's prefill at ``s_max =
    max_length`` and one cached step a token, the self-attention caches
    following the chosen beams (the cross K/V and the mask are the same for
    every beam of an item, so they stay); else every step runs the decoder
    over the whole prefix, the prefixes following the beams. Both give the
    same ids. ``steps[0]`` counts the decoder steps."""
    K = num_beams
    enc_rep, mask_rep = enc_out.repeat_interleave(K, 0), enc_mask.repeat_interleave(K, 0)
    BK = enc_rep.shape[0]
    bos = torch.full((BK, 1), pad_id, dtype=torch.long, device=enc_out.device)
    steps = steps if steps is not None else [0]
    if use_cache:
        logits0, state = model.decode_prefill(bos, enc_rep, mask_rep, max_length)

        def step_fn(tok, pos, cache):
            steps[0] += 1
            return model.decode_step_logits(tok, pos[:1], cache, mask_rep)

        def gather_fn(cache, rows):
            return [dict(entry, k=entry["k"][rows], v=entry["v"][rows]) for entry in cache]
    else:
        logits0, state = model.decode(bos, enc_rep, mask_rep)[:, -1], bos

        def step_fn(tok, pos, prefix):
            steps[0] += 1
            prefix = torch.cat([prefix, tok[:, None]], dim=1)
            return model.decode(prefix, enc_rep, mask_rep)[:, -1], prefix

        def gather_fn(prefix, rows):
            return prefix[rows]

    return cached_beam_loop(logits0, state, torch.ones(BK, dtype=torch.long, device=bos.device),
                            step_fn, gather_fn, num_beams=K, eos_token_id=eos_id,
                            pad_token_id=pad_id, max_new_tokens=max_length - 1)


@dataclasses.dataclass
class PnpVqaPipeline:
    """PNP-VQA (reference pnp_vqa.py): the three models on one device and
    their tokenizers (BERT wordpiece for ITM and captions, the T5 one with
    ``encode`` / ``decode`` for the reader)."""

    itm_model: torch.nn.Module
    cap_model: torch.nn.Module
    qa_model: FiDT5
    tokenizer: object
    qa_tokenizer: object
    prompt: str = "a picture of "

    @classmethod
    def from_config(cls, mcfg: Dict, *, device="cuda", seed: int = 0, vocab_path=None,
                    qa_tokenizer=None, **kw) -> "PnpVqaPipeline":
        """The pipeline of a ``pnp_vqa`` model section (reference
        ``from_config`` over configs/models/pnp_vqa/*.yaml): each of the three
        sub-sections names its ``arch`` and ``model_type`` (extra keys
        override that model's configuration) and is built through
        :func:`sprc_tpu_torch.loader.build_model` (``arch: t5``:
        :func:`plain_t5`, its ``model_type`` ignored); its weights are random
        from ``seed + i`` (i = 0, 1, 2 in section order) unless it carries
        ``finetuned: <local path>``, read through
        :func:`~sprc_tpu_torch.loader.read_checkpoint` and loaded with
        ``strict=True``. The BERT tokenizer adds ``[DEC]``; the reader's
        tokenizer defaults to the word-level ``WhitespaceTokenizer``, as in
        the JAX package."""
        from sprc_tpu_torch import loader
        from sprc_tpu_torch.text.llm_tokenizers import WhitespaceTokenizer
        from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
        from sprc_tpu_torch.utils.artifacts import ensure_bert_vocab

        models = []
        for i, section in enumerate(SUB_MODELS):
            sub = dict(mcfg.get(section) or {})
            path = sub.pop("finetuned", None)
            arch, model_type = sub.pop("arch"), sub.pop("model_type", "pretrain")
            if arch == "t5":  # a plain T5 (Img2Prompt's question generator)
                models.append(plain_t5(sub, device=device, seed=seed + i, path=path))
            elif path is None:
                models.append(loader.load_model(arch, model_type, device=device, seed=seed + i,
                                                **sub))
            else:
                model = loader.build_model(arch, model_type, device=device, **sub)
                model.load_state_dict(loader.read_checkpoint(path, model), strict=True)
                models.append(model.eval())
        tokenizer = BertWordPieceTokenizer.from_vocab_file(ensure_bert_vocab(vocab_path),
                                                           extra_special_tokens=["[DEC]"])
        return cls(*models, tokenizer=tokenizer,
                   qa_tokenizer=qa_tokenizer or WhitespaceTokenizer(),
                   prompt=mcfg.get("prompt", "a picture of "), **kw)

    @property
    def device(self) -> torch.device:
        return next(self.itm_model.parameters()).device

    def _ids(self, enc: Dict[str, np.ndarray]):
        return tuple(torch.from_numpy(np.asarray(enc[k], np.int64)).to(self.device)
                     for k in ("input_ids", "attention_mask"))

    # -- stage 1: localisation -------------------------------------------
    def forward_itm(self, images: Tensor, questions: Sequence[str], *, block_num: int = 7,
                    stats: Optional[Dict[str, float]] = None) -> np.ndarray:
        """-> the token-averaged GradCAM maps [B, num_patches] (numpy)."""
        ids, mask = self._ids(self.tokenizer([q.strip("?") for q in questions], max_length=35,
                                             enc_token=True))
        with stage(stats, "tower_s", self.device):
            rows = self.itm_model.encode_image(images)
        with stage(stats, "gradcam_s", self.device):
            avg, _ = compute_gradcam(self.itm_model, None, ids, mask, block_num=block_num,
                                     image_embeds=rows)
        return avg

    # -- stage 2: stochastic captioning ---------------------------------
    @torch.no_grad()
    def forward_cap(self, generator: torch.Generator, images: Tensor, gradcams: np.ndarray, *,
                    num_captions: int = 100, num_patches: int = 20, cap_max_length: int = 20,
                    cap_min_length: int = 0, top_k: int = 50, top_p: float = 1.0,
                    repetition_penalty: float = 1.0, max_rounds: int = 5,
                    stats: Optional[Dict[str, float]] = None) -> List[List[str]]:
        """-> ``num_captions`` distinct captions an image at most (fewer where
        ``max_rounds`` rounds of sampling do not find them)."""
        model, device = self.cap_model, self.device
        with stage(stats, "tower_s", device):
            encoder_out = model.encode_image(images)
        B, _, D = encoder_out.shape
        weights = torch.as_tensor(np.asarray(gradcams, np.float32), device=device)
        prompt_ids = torch.tensor(self.tokenizer.caption_prompt_ids(self.prompt), device=device)
        captions: List[List[str]] = [[] for _ in range(B)]
        steps = [0]

        def logits_fn(ids, gathered):
            steps[0] += 1
            return model.decode_logits(ids, torch.ones_like(ids), gathered)

        for _ in range(max_rounds):
            if min(len(c) for c in captions) >= num_captions:
                break
            with stage(stats, "caption_sample_s", device):
                idx = sample_patches(generator, weights, num_patches, num_captions) + 1  # CLS
                gathered = torch.gather(
                    encoder_out[:, None].expand(B, num_captions, *encoder_out.shape[1:]), 2,
                    idx[..., None].expand(*idx.shape, D)).reshape(B * num_captions,
                                                                  num_patches, D)
                out = sample_generate(
                    logits_fn, prompt_ids[None].expand(B * num_captions, -1),
                    generator=generator, eos_token_id=self.tokenizer.sep_id,
                    pad_token_id=self.tokenizer.pad_id, max_length=cap_max_length,
                    min_length=cap_min_length, top_k=top_k, top_p=top_p,
                    repetition_penalty=repetition_penalty, memory=gathered).cpu().numpy()
            for counter, row in enumerate(out):
                text = self.tokenizer.decode(row)
                ind = counter // num_captions
                cap = text[len(self.prompt):] if text.startswith(self.prompt) else text
                if len(captions[ind]) < num_captions and cap:
                    if not any(cap in c for c in captions[ind]):
                        captions[ind].append(cap)
        if stats is not None:
            stats["caption_steps"] = stats.get("caption_steps", 0) + steps[0]
        return captions

    # -- stage 3: FiD question answering --------------------------------
    @torch.no_grad()
    def forward_qa(self, questions: Sequence[str], captions: Sequence[Sequence[str]], *,
                   num_captions: int = 100, num_captions_fid: int = 1, max_len: int = 20,
                   min_len: int = 0, ctx_max_length: int = 64,
                   stats: Optional[Dict[str, float]] = None) -> List[str]:
        """One greedy answer a question, from its contexts (the question
        alone where no caption survived: an empty FiD memory would softmax
        over no key)."""
        contexts = prepare_qa_input(questions, captions, num_captions=num_captions,
                                    num_captions_fid=num_captions_fid)
        model, tok, device = self.qa_model, self.qa_tokenizer, self.device
        answers = []
        steps = [0]

        def step_fn(t, pos, state):
            steps[0] += 1
            cache, enc_mask = state
            logits, cache = model.decode_step_logits(t, pos[:1], cache, enc_mask)
            return logits, (cache, enc_mask)

        for question, ctxs in zip(questions, contexts):
            ctxs = ctxs or [question.lower().strip() + " \\n "]
            ids, mask = self._ids(tok(ctxs, max_length=ctx_max_length))  # [n_ctx, L]
            with stage(stats, "fid_encode_s", device):
                enc_out = model.encode_ids(ids, mask)
                enc_flat = enc_out.reshape(1, -1, enc_out.shape[-1])
                mask_flat = mask.reshape(1, -1)
            with stage(stats, "fid_decode_s", device):
                bos = torch.full((1, 1), tok.pad_id, dtype=torch.long, device=device)
                logits0, cache = model.decode_prefill(bos, enc_flat, mask_flat, max_len)
                out = cached_greedy_loop(
                    logits0, (cache, mask_flat), torch.ones(1, dtype=torch.long, device=device),
                    step_fn, eos_token_id=tok.eos_id, pad_token_id=tok.pad_id,
                    max_new_tokens=max_len - 1, min_new_tokens=min_len)
                answers.append(tok.decode(out[0].cpu().numpy()))
        if stats is not None:
            stats["fid_steps"] = stats.get("fid_steps", 0) + steps[0]
        return answers

    # -- the pipeline ------------------------------------------------------
    def predict_answers(self, images, questions: Sequence[str], *, seed: int = 0,
                        num_captions: int = 50, num_captions_fid: int = 1,
                        num_patches: int = 50, block_num: int = 7,
                        stats: Optional[Dict[str, float]] = None, **kw):
        """-> (answers, captions, gradcams) (reference pnp_vqa.py:233-339).
        ``images``: NHWC pixels (numpy or a tensor); ``kw``: the caption
        keys (``cap_max_length``, ``cap_min_length``, ``top_k``, ``top_p``,
        ``repetition_penalty``) and the reader's (``max_len``, ``min_len``).
        ``stats`` receives seconds by stage (``tower_s``, ``gradcam_s``,
        ``caption_sample_s``, ``fid_encode_s``, ``fid_decode_s``) and the
        decode steps (``caption_steps``, ``fid_steps``), summed over calls."""
        if isinstance(questions, str):
            questions = [questions]
        images = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        assert len(questions) == images.shape[0]
        gradcams = self.forward_itm(images, questions, block_num=block_num, stats=stats)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        captions = self.forward_cap(
            generator, images, gradcams, num_captions=num_captions, num_patches=num_patches,
            stats=stats, **{k: v for k, v in kw.items() if k in (
                "cap_max_length", "cap_min_length", "top_k", "top_p", "repetition_penalty")})
        answers = self.forward_qa(
            questions, captions, num_captions=num_captions, num_captions_fid=num_captions_fid,
            stats=stats, **{k: v for k, v in kw.items() if k in ("max_len", "min_len")})
        return answers, captions, gradcams


registry.register_model("pnp_vqa")(PnpVqaPipeline)


@dataclasses.dataclass
class Img2PromptVqaPipeline(PnpVqaPipeline):
    """Img2Prompt-VQA (reference img2prompt_vqa.py): PNP-VQA's localisation
    and captioning with an ITM filter, then the prompt for an external LLM.
    ``qa_model`` is the question-generation T5. ``tagger``: the answer
    candidates of a caption (default :func:`sprc_tpu_torch.text.pos.
    answer_candidates`; the reference uses spaCy's tags, entities and noun
    chunks)."""

    tagger: Optional[Callable[[str], List[str]]] = None
    itm_filter_threshold: float = 0.5

    @torch.no_grad()
    def forward_cap(self, generator: torch.Generator, images: Tensor, gradcams: np.ndarray, *,
                    stats: Optional[Dict[str, float]] = None, **kw) -> List[List[str]]:
        """PNP-VQA's captions, kept where the ITM match probability of the
        caption and its image reaches ``itm_filter_threshold``
        (img2prompt_vqa.py:228-246); each image with captions re-encoded
        through the ITM tower alone."""
        caps = super().forward_cap(generator, images, gradcams, stats=stats, **kw)
        kept: List[List[str]] = []
        for b, group in enumerate(caps):
            if not group:
                kept.append(group)
                continue
            with stage(stats, "itm_filter_s", self.device):
                ids, mask = self._ids(self.tokenizer(group, max_length=35, enc_token=True))
                rows = self.itm_model.encode_image(images[b:b + 1])
                p_match = self.itm_model.itm_embeds(
                    ids, mask, rows.expand(len(group), *rows.shape[1:])).cpu().numpy()
            kept.append([c for c, p in zip(group, p_match) if p >= self.itm_filter_threshold])
        return kept

    def answer_extraction(self, captions: Sequence[str], *, num_question_generation: int = 30):
        """-> (the question generator's contexts, the answers with their ".",
        answer -> caption indices) (img2prompt_vqa.py:252-310): the
        candidates sorted by their count (stable), the first
        ``num_question_generation`` kept and ``"yes."`` last."""
        from sprc_tpu_torch.text.pos import answer_candidates

        extract = self.tagger or answer_candidates
        cap_use = ""
        answers: List[str] = []
        ans_to_cap: Dict[str, List[int]] = {}
        for cap_idx, cap in enumerate(captions):
            cap_use += cap
            for cand in extract(cap):
                key = cand.lower()
                ans_to_cap.setdefault(key, [])
                if cap_idx not in ans_to_cap[key]:
                    ans_to_cap[key].append(cap_idx)
                answers.append(cand)
        answers = sorted(answers, key=answers.count, reverse=True)
        real: List[str] = []
        for a in answers:
            a = a + "."
            if a not in real:
                real.append(a)
        contexts = ["answer: %s  context: %s." % (a, cap_use)
                    for a in real[:num_question_generation]]
        contexts.append("answer: %s  context: %s." % ("yes.", cap_use))
        return contexts, real[:num_question_generation] + ["yes."], ans_to_cap

    @torch.no_grad()
    def forward_qa_generation(self, captions: Sequence[str], *, max_length: int = 30,
                              ctx_max_length: int = 128, num_beams: int = 3,
                              stats: Optional[Dict[str, float]] = None) -> Dict:
        """A question for each extracted answer (img2prompt_vqa.py:312-348):
        contexts 10 at a time, encoded at ``ctx_max_length``, then
        :func:`qg_beam_search` (``num_beams``, ``max_length - 1`` new tokens).
        ``stats``: ``qg_encode_s``, ``qg_decode_s``, ``qg_steps``."""
        contexts, answers, ans_to_cap = self.answer_extraction(captions)
        model, tok, device = self.qa_model, self.qa_tokenizer, self.device
        steps = [0]
        questions: List[str] = []
        for i in range(0, len(contexts), 10):
            ids, mask = self._ids(tok(contexts[i:i + 10], max_length=ctx_max_length))
            with stage(stats, "qg_encode_s", device):
                enc_out = model.encode_ids(ids, mask)
            with stage(stats, "qg_decode_s", device):
                out = qg_beam_search(model, enc_out, mask, num_beams=num_beams,
                                     pad_id=tok.pad_id, eos_id=tok.eos_id,
                                     max_length=max_length, steps=steps).cpu().numpy()
            questions += [tok.decode(row) for row in out]
        if stats is not None:
            stats["qg_steps"] = stats.get("qg_steps", 0) + steps[0]
        return {"questions": questions, "answers": answers, "ans_to_cap_dict": ans_to_cap}

    # -- the prompt (string logic, img2prompt_vqa.py:349-463) -------------
    @staticmethod
    def create_context_prompt(sample: Dict, num_caps_per_img: int = 30) -> str:
        ans_to_cap = sample["ans_to_cap_dict"]
        caption = sample["captions"]
        answers = sample["answers"]
        out, used = "", []
        for idx in range(num_caps_per_img):
            key = answers[(len(answers) - 1 - idx) % len(answers)][:-1].lower()
            for cap_id in ans_to_cap.get(key, [0]):
                if cap_id not in used and cap_id < len(caption):
                    out += caption[cap_id]
                    used.append(cap_id)
                    break
        return out

    @staticmethod
    def create_task_prompt(sample: Dict, num_question_per_img: int = 30) -> str:
        """One yes / no exemplar pair (the reference's non-'rule' branch,
        :390-404; its 'rule' branch compares a string with 'rule' and never
        runs)."""
        questions = sample["questions"]
        out = ""
        for _ in range(min(num_question_per_img, 1)):
            out += "Question:" + questions[-1] + "\n" + "Answer:yes\n"
            out += "Question:Is this a toilet?\nAnswer:no\n"
        return out

    def prompts_construction(self, sample: Dict, *, num_caps_per_img: int = 30,
                             num_question_per_img: int = 30) -> str:
        head = ("Please reason the answer of the questions according to the "
                "given contexts.\n")
        ctx = self.create_context_prompt(sample, num_caps_per_img)
        task = self.create_task_prompt(sample, num_question_per_img)
        return (head + "Contexts:" + ctx + "\n" + task + "Question:" + sample["text_input"]
                + "\nAnswer:")

    def predict_prompts(self, images, questions: Sequence[str], *, seed: int = 0,
                        block_num: int = 7, stats: Optional[Dict[str, float]] = None,
                        **kw) -> List[str]:
        """-> one LLM prompt an image and question. ``kw``: the caption
        keys of :meth:`PnpVqaPipeline.forward_cap`; ``stats`` as
        :meth:`PnpVqaPipeline.predict_answers`' with ``itm_filter_s`` and
        the question generator's keys."""
        images = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        gradcams = self.forward_itm(images, questions, block_num=block_num, stats=stats)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        captions = self.forward_cap(generator, images, gradcams, stats=stats, **kw)
        prompts = []
        for b, question in enumerate(questions):
            qa = self.forward_qa_generation(captions[b], stats=stats)
            sample = {"captions": captions[b], "text_input": question, **qa}
            prompts.append(self.prompts_construction(sample))
        return prompts


registry.register_model("img2prompt_vqa")(Img2PromptVqaPipeline)
