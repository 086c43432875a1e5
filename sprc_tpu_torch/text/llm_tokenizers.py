"""File-driven tokenizers of the LLM heads (counterpart of
``sprc_tpu/text/llm_tokenizers.py``).

The reference builds them with ``AutoTokenizer.from_pretrained`` (a hub
download). Here :class:`HFFileTokenizer` reads a local ``tokenizer.json``
through the ``tokenizers`` package, imported only when a run asks for it
(``run.tokenizer`` in cli/evaluate.py). A missing package or file is an
error that names what is missing: no run falls back to another tokenizer.

Every adapter has the interface the caption glue needs: ``__call__(texts,
max_length) -> {"input_ids", "attention_mask"}`` (numpy int32, right-padded,
eos last), ``decode(ids)`` and ``pad_id`` / ``eos_id`` / ``bos_id``.
:class:`WhitespaceTokenizer` is the synthetic word-level vocabulary of the
``--synthetic`` instruct runs and the tests, copied from the JAX package.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, Iterable, Optional, Sequence

import numpy as np


class HFFileTokenizer:
    """A local HF ``tokenizer.json`` through the ``tokenizers`` package."""

    def __init__(self, tokenizer_json: str, *, pad_id: int, eos_id: int,
                 bos_id: Optional[int] = None, add_bos: bool = False):
        if not os.path.exists(tokenizer_json):
            raise FileNotFoundError(
                f"{tokenizer_json} not found. Export it once from a machine with network "
                "access: AutoTokenizer.from_pretrained(<repo>).save_pretrained(<dir>) and "
                "point at <dir>/tokenizer.json.")
        try:
            from tokenizers import Tokenizer
        except ImportError as e:
            raise ImportError(f"run.tokenizer {tokenizer_json!r} needs the 'tokenizers' "
                              "package, which this machine lacks") from e
        self._tok = Tokenizer.from_file(tokenizer_json)
        self.pad_id, self.eos_id, self.bos_id = pad_id, eos_id, bos_id
        self.add_bos = add_bos

    def __call__(self, texts: Iterable[str] | str, max_length: int = 32) -> Dict[str, np.ndarray]:
        texts = [texts] if isinstance(texts, str) else list(texts)
        encs = self._tok.encode_batch(texts, add_special_tokens=False)
        ids = np.full((len(texts), max_length), self.pad_id, np.int32)
        mask = np.zeros_like(ids)
        for i, e in enumerate(encs):
            row = list(e.ids)
            if self.add_bos and self.bos_id is not None:
                row = [self.bos_id] + row
            row = row[: max_length - 1] + [self.eos_id]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode([int(i) for i in ids if int(i) not in (self.pad_id, self.eos_id)])


def llama_tokenizer(path: str) -> HFFileTokenizer:
    """LLaMA / Vicuna: pad 0, eos 2, bos 1 first (HF's convention)."""
    return HFFileTokenizer(path, pad_id=0, eos_id=2, bos_id=1, add_bos=True)


def opt_tokenizer(path: str) -> HFFileTokenizer:
    """OPT (GPT2 BPE): pad 1, bos / eos 2 (facebook/opt-*)."""
    return HFFileTokenizer(path, pad_id=1, eos_id=2, bos_id=2, add_bos=True)


def t5_tokenizer(path: str) -> HFFileTokenizer:
    """T5: pad 0 (also the decoder start), eos 1."""
    return HFFileTokenizer(path, pad_id=0, eos_id=1)


class WhitespaceTokenizer:
    """Synthetic word-level tokenizer (the ``--synthetic`` runs, the tests)."""

    def __init__(self, vocab_size: int = 512, *, pad_id: int = 0, eos_id: int = 1,
                 bos_id: int = 2):
        self.vocab_size = vocab_size
        self.pad_id, self.eos_id, self.bos_id = pad_id, eos_id, bos_id
        self._vocab: Dict[str, int] = {}
        self._inv: Dict[int, str] = {}

    def _id(self, word: str) -> int:
        if word not in self._vocab:
            # a hash that is the same in every process (crc32), then linear
            # probing: distinct words take distinct slots while any is free
            n = self.vocab_size - 3
            slot = 3 + (zlib.crc32(word.encode("utf-8")) % n)
            for _ in range(n):
                if slot not in self._inv or self._inv[slot] == word:
                    break
                slot = 3 + ((slot - 3 + 1) % n)
            self._vocab[word] = slot
            self._inv.setdefault(slot, word)
        return self._vocab[word]

    def __call__(self, texts, max_length: int = 32) -> Dict[str, np.ndarray]:
        texts = [texts] if isinstance(texts, str) else list(texts)
        ids = np.full((len(texts), max_length), self.pad_id, np.int32)
        mask = np.zeros_like(ids)
        for i, t in enumerate(texts):
            row = [self.bos_id] + [self._id(w) for w in t.split()]
            row = row[: max_length - 1] + [self.eos_id]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids: Sequence[int]) -> str:
        return " ".join(self._inv.get(int(i), "?") for i in ids
                        if int(i) not in (self.pad_id, self.eos_id, self.bos_id))
