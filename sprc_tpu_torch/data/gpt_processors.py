"""The GPT video-dialogue processors (counterpart of
``sprc_tpu/data/gpt_processors.py``; reference
src/lavis/processors/gpt_processors.py).

- ``gpt_dialogue`` (:class:`GPTDialogueProcessor`): one training sequence
  ``[caption summary] <eos> [q1] <eos> [a1] <eos> ... [question] <eos>
  [answer] <eos>`` from an AVSD annotation, with token-type ids (``<cap>``
  over the caption span, ``<speaker1>`` / ``<speaker2>`` alternating by
  turn) and LM labels that are -1 everywhere but the last answer's span;
  the last ``max_turns`` turns of the history are kept;
- ``gpt_video_ft`` (:class:`GPTVideoFeatureProcessor`): the ``.npy``
  feature streams of a video (``visual_ft`` then ``audio_ft``, each
  ``<root>/<stream>/<video>.npy`` [frames, width]), cut to the shortest
  stream and joined along the width; every frame typed ``<video>``.

The tokenizer is injected: any object with ``encode(text) -> ids`` and
``special_token_id(name)``. :class:`GPT2SpecialTokens` reads a local GPT-2
``tokenizer.json`` through the ``tokenizers`` package, imported only when
one is given (a missing file or package is an error that names it), and
appends the seven dialogue tokens after the base vocabulary in the order
HF's ``add_special_tokens`` gives them (:data:`SPECIAL_TOKEN_ADD_ORDER`).
:class:`SyntheticGPT2Tokens` is the word-hash stand-in of the synthetic
runs. It keeps the JAX package's ``hash(word) % base``: Python salts string
hashes per process, so its ids agree only within one process (or under one
``PYTHONHASHSEED``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from sprc_tpu_torch.registry import registry

# reference gpt_processors.py:22-36
SPECIAL_TOKENS = ["<bos>", "<eos>", "<speaker1>", "<speaker2>", "<cap>", "<video>", "<pad>"]
# the ids HF's add_special_tokens(SPECIAL_TOKENS_DICT) assigns: bos, eos, the
# additional tokens (speaker1, speaker2, video, cap), pad; so <video> is base + 4
# and <cap> base + 5, not the list order above
SPECIAL_TOKEN_ADD_ORDER = ["<bos>", "<eos>", "<speaker1>", "<speaker2>", "<video>", "<cap>",
                           "<pad>"]


class GPT2SpecialTokens:
    """GPT-2's BPE from a local ``tokenizer.json`` and the dialogue's special
    tokens at ``base .. base + 6``."""

    def __init__(self, tokenizer_json: str):
        if not os.path.exists(tokenizer_json):
            raise FileNotFoundError(
                f"{tokenizer_json} not found: export GPT-2's tokenizer.json once from a machine "
                "with network access (GPT2TokenizerFast.from_pretrained('gpt2')"
                ".save_pretrained(<dir>))")
        try:
            from tokenizers import Tokenizer
        except ImportError as e:
            raise ImportError(f"tokenizer_json {tokenizer_json!r} needs the 'tokenizers' "
                              "package, which this machine lacks") from e
        self._tok = Tokenizer.from_file(tokenizer_json)
        base = self._tok.get_vocab_size()
        self._special = {t: base + i for i, t in enumerate(SPECIAL_TOKEN_ADD_ORDER)}

    def encode(self, text: str) -> List[int]:
        return list(self._tok.encode(text, add_special_tokens=False).ids)

    def special_token_id(self, name: str) -> int:
        return self._special[name]


class SyntheticGPT2Tokens:
    """Word-hash ids below ``base_vocab`` and the special tokens after it."""

    def __init__(self, base_vocab: int = 1000):
        self.base = base_vocab
        self._special = {t: base_vocab + i for i, t in enumerate(SPECIAL_TOKEN_ADD_ORDER)}

    def encode(self, text: str) -> List[int]:
        return [hash(w) % self.base for w in str(text).split()]

    def special_token_id(self, name: str) -> int:
        return self._special[name]

    @property
    def vocab_size(self) -> int:
        return self.base + len(SPECIAL_TOKEN_ADD_ORDER)


def _resolve_gpt_tokenizer(tokenizer, tokenizer_json, synthetic_vocab):
    """The tokenizer from a YAML section's strings and ints (the builders
    make processors from them): an instance, a ``tokenizer_json`` path or a
    ``synthetic_vocab`` size."""
    if tokenizer is not None:
        return tokenizer
    if tokenizer_json:
        return GPT2SpecialTokens(tokenizer_json)
    if synthetic_vocab:
        return SyntheticGPT2Tokens(int(synthetic_vocab))
    raise ValueError("GPT processors need one of: tokenizer (instance), tokenizer_json (a "
                     "local GPT-2 tokenizer.json) or synthetic_vocab (int, the synthetic "
                     "tokenizer)")


class GPTDialogueProcessor:
    """An AVSD annotation -> {input_ids, token_type_ids, labels}, int32."""

    def __init__(self, tokenizer=None, max_turns: int = 3, use_caption: bool = True,
                 tokenizer_json: Optional[str] = None, synthetic_vocab: int = 0):
        self.tokenizer = _resolve_gpt_tokenizer(tokenizer, tokenizer_json, synthetic_vocab)
        self.max_turns = max_turns
        self.use_caption = use_caption

    def _sid(self, name: str) -> int:
        return self.tokenizer.special_token_id(name)

    def sample_sequence(self, caption: List[int], history: List[List[int]],
                        answer: List[int]) -> Dict[str, np.ndarray]:
        eos = self._sid("<eos>")
        speaker1, speaker2, cap = (self._sid("<speaker1>"), self._sid("<speaker2>"),
                                   self._sid("<cap>"))
        sequence = [s + [eos] for s in [caption] + history + [answer]]
        input_ids = [t for s in sequence for t in s]
        token_type_ids = [cap] * len(sequence[0]) + [
            speaker2 if i % 2 else speaker1 for i, s in enumerate(sequence[1:]) for _ in s]
        labels = [-1] * sum(len(s) for s in sequence[:-1]) + sequence[-1]
        return {"input_ids": np.asarray(input_ids, np.int32),
                "token_type_ids": np.asarray(token_type_ids, np.int32),
                "labels": np.asarray(labels, np.int32)}

    def padding(self, seqs: Sequence[np.ndarray], pad_token: int = -1) -> np.ndarray:
        if pad_token == -1:
            pad_token = self._sid("<pad>")
        out = np.full((len(seqs), max(len(s) for s in seqs)), pad_token, np.int32)
        for i, s in enumerate(seqs):
            out[i, :len(s)] = s
        return out

    def get_attention_mask(self, seq: np.ndarray, pad_token: int = -1) -> np.ndarray:
        if pad_token == -1:
            pad_token = self._sid("<pad>")
        return (seq != pad_token).astype(np.int32)

    def __call__(self, ann: dict) -> Dict[str, np.ndarray]:
        caption = (self.tokenizer.encode(" ".join([ann["caption"], ann["summary"]]))
                   if self.use_caption else [])
        history: List[str] = []
        for turn in ann["dialog"][-self.max_turns:]:
            history += [turn["question"], turn["answer"]]
        history.append(ann["question"])
        return self.sample_sequence(caption, [self.tokenizer.encode(t) for t in history],
                                    self.tokenizer.encode(ann["answer"]))


class GPTVideoFeatureProcessor:
    """(feature root, video name) -> {video_fts [T, D] fp32, token_type_ids [T]}."""

    def __init__(self, tokenizer=None, visual_ft: Optional[Sequence[str]] = None,
                 audio_ft: Optional[Sequence[str]] = None,
                 tokenizer_json: Optional[str] = None, synthetic_vocab: int = 0):
        self.tokenizer = _resolve_gpt_tokenizer(tokenizer, tokenizer_json, synthetic_vocab)
        self.visual_ft = list(visual_ft or ["i3d_rgb"])
        self.audio_ft = list(audio_ft or ["vggish"])

    def padding(self, seqs: Sequence[np.ndarray], pad_value: float = 1.0) -> np.ndarray:
        out = np.full((len(seqs), max(len(s) for s in seqs), seqs[0].shape[1]), pad_value,
                      np.float32)
        for i, s in enumerate(seqs):
            out[i, :len(s)] = s
        return out

    def get_attention_mask(self, seq: np.ndarray) -> np.ndarray:
        return (np.sum(seq != 1, axis=2) != 0).astype(np.int32)

    def __call__(self, ft_root: str, vname: str) -> Dict[str, np.ndarray]:
        streams = [np.load(os.path.join(ft_root, name, vname) + ".npy")
                   for name in self.visual_ft + self.audio_ft]
        frames = min(len(s) for s in streams)
        joined = np.concatenate([s[:frames] for s in streams], axis=1)
        return {"video_fts": joined.astype(np.float32),
                "token_type_ids": np.full((frames,), self.tokenizer.special_token_id("<video>"),
                                          np.int32)}


registry.register_processor("gpt_dialogue")(GPTDialogueProcessor)
registry.register_processor("gpt_video_ft")(GPTVideoFeatureProcessor)
