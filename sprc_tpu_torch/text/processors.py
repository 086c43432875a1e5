"""Host-side caption text processing.

Replicates the reference's ``blip_caption`` processor semantics
(reference: src/lavis/processors/blip_processors.py:28-68): lowercase,
strip a fixed punctuation class, collapse whitespace, truncate to
``max_words`` words, with an optional prompt prefix.

The port's own copy of what validation uses from
``sprc_tpu/text/processors.py`` (it imports nothing of ``sprc_tpu``);
tests/test_torch_inputs.py pins the two equal (the train-time caption
randomisation: tests/test_torch_train_data.py; the VQA question processor:
tests/test_torch_vqa.py).
"""

from __future__ import annotations

import re
from typing import List


class CaptionProcessor:
    def __init__(self, prompt: str = "", max_words: int = 50):
        self.prompt = prompt
        self.max_words = max_words

    def __call__(self, caption: str) -> str:
        return self.prompt + self.pre_caption(caption)

    def pre_caption(self, caption: str) -> str:
        caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
        caption = re.sub(r"\s{2,}", " ", caption)
        caption = caption.rstrip("\n").strip(" ")
        words = caption.split(" ")
        if len(words) > self.max_words:
            caption = " ".join(words[: self.max_words])
        return caption


def combine_fiq_captions(flattened_captions: List[str]) -> List[str]:
    """Deterministic eval-time FashionIQ caption pairing: "Cap1 and cap2"
    (reference: src/validate_blip.py:180-183)."""
    out = []
    for i in range(0, len(flattened_captions), 2):
        a = flattened_captions[i].strip(".?, ").capitalize()
        b = flattened_captions[i + 1].strip(".?, ")
        out.append(f"{a} and {b}")
    return out


def randomize_fiq_captions(flattened_captions: List[str], rng) -> List[str]:
    """Train-time 4-way caption randomization (reference src/utils.py:117-138):
    (a) cap1 and cap2, (b) cap2 and cap1, (c) cap1, (d) cap2; ``rng`` a
    ``np.random.RandomState``."""
    out = []
    for i in range(0, len(flattened_captions), 2):
        a = flattened_captions[i].strip(".?, ")
        b = flattened_captions[i + 1].strip(".?, ")
        r = rng.random()
        if r < 0.25:
            out.append(f"{a.capitalize()} and {b}")
        elif r < 0.5:
            out.append(f"{b.capitalize()} and {a}")
        elif r < 0.75:
            out.append(a.capitalize())
        else:
            out.append(b.capitalize())
    return out


class QuestionProcessor:
    """VQA question cleanup (reference blip_processors.py:71-101): strip
    punctuation (removed, not space-replaced, unlike captions), lowercase,
    truncate to max_words."""

    def __init__(self, max_words: int = 50):
        self.max_words = max_words

    def __call__(self, question: str) -> str:
        return self.pre_question(question)

    def pre_question(self, question: str) -> str:
        question = re.sub(r"([.!\"()*#:;~])", "", question.lower())
        question = question.rstrip(" ")
        words = question.split(" ")
        if len(words) > self.max_words:
            question = " ".join(words[: self.max_words])
        return question
