"""Dependency-free English POS tagging and noun chunking (the port's own
copy of ``sprc_tpu/text/pos.py``; tests/test_torch_img2prompt.py pins its
outputs equal to the original's on a corpus of captions).

Img2Prompt's answer extraction needs three things from spaCy (reference
img2prompt_vqa.py:25,252-310): open-class tokens (NOUN/VERB/ADJ/ADV/NUM)
as answer candidates, noun chunks shorter than 4 words, and (in a dead
config branch) the POS of an answer's last word. This is a compact
closed-class-lexicon + suffix-rule tagger: every function word is tagged by
lookup, numbers by shape, and the remaining open-class words by suffix
heuristics with NOUN as the default. :func:`entities` stands in for spaCy's
entity spans (img2prompt_vqa.py:273-281) with a capitalized-span +
gazetteer heuristic (months/days/countries/cities); inject a spaCy
``tagger`` into the pipeline for exact parity where spaCy is installed.

Tags follow the spaCy/UD coarse set used by the reference: NOUN VERB ADJ
ADV NUM plus closed classes DET PRON ADP CONJ AUX PART PUNCT.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

OPEN_POS = ("NOUN", "VERB", "ADJ", "ADV", "NUM")

_LEX = {}
for _tag, _words in {
    "DET": """a an the this that these those each every either neither some
        any no all both another such""",
    "PRON": """i you he she it we they me him her us them mine yours hers
        ours theirs myself yourself himself herself itself ourselves
        themselves who whom whose which what something anything nothing
        everything someone anyone everyone somebody anybody everybody""",
    "ADP": """of in on at to for with from by about into over under between
        through during against among across behind beyond near off above
        below around along inside outside onto upon within without toward
        towards beside underneath atop""",
    "CONJ": """and or but nor yet so if because while although though when
        where since as than whether unless until once after before""",
    "AUX": """is are was were be been being am do does did done have has had
        having will would can could shall should may might must won't can't
        isn't aren't wasn't weren't don't doesn't didn't haven't hasn't
        hadn't wouldn't couldn't shouldn't""",
    "PART": "not to 's n't",
    "ADV": """very too also just only even still here there now then always
        never often sometimes usually really quite rather almost already
        again soon maybe perhaps together away back down up out well""",
    "NUM": """zero one two three four five six seven eight nine ten eleven
        twelve thirteen fourteen fifteen sixteen seventeen eighteen nineteen
        twenty thirty forty fifty sixty seventy eighty ninety hundred
        thousand million billion first second third several many few""",
    # frequent caption adjectives the suffix rules cannot catch
    "ADJ": """red blue green yellow black white brown pink purple orange
        gray grey golden silver big small large little long short tall wide
        narrow old new young high low good bad hot cold warm cool dark
        light bright open closed empty full wet dry clean dirty left right
        round square flat sharp soft hard heavy thin thick fresh wooden
        metal plastic glass striped plaid floral sleeveless other same
        different male female top bottom front middle""",
    # frequent caption verbs (incl. 3rd-person forms: a bare -s suffix is
    # ambiguous with plural nouns, so inflections are enumerated)
    "VERB": """chase chases run runs walk walks sit sits stand stands hold
        holds wear wears ride rides look looks play plays eat eats jump
        jumps fly flies swim swims go goes make makes take takes get gets
        see sees come comes use uses find finds give gives keep keeps show
        shows talk talks turn turns start starts hang hangs lie lies lay
        lays watch watches drink drinks sleep sleeps throw throws catch
        catches pull pulls push pushes carry carries climb climbs drive
        drives march marches""",
    # -able/-ible nouns the adjective suffix rule would misfile
    "NOUN": "table cable bible marble pebble vegetable label",
}.items():
    for _w in _words.split():
        _LEX.setdefault(_w, _tag)

_NUM_RE = re.compile(r"^[0-9]+([.,:][0-9]+)*(st|nd|rd|th)?$")
_PUNCT_RE = re.compile(r"^\W+$")
_TOKEN_RE = re.compile(r"[A-Za-z0-9]+(?:['\-][A-Za-z0-9]+)*|[^\sA-Za-z0-9]")

# -ed nouns/adjectives that the verb suffix rule would misfile
_ED_NOT_VERB = frozenset("bed sled shed seed speed breed bleed feed".split())
_ING_NOUNS = frozenset(
    "building painting ceiling clothing evening morning king ring wing "
    "thing string spring swing".split())
_ADJ_SUFFIXES = ("ous", "ful", "ive", "able", "ible", "ish", "less",
                 "iest", "ier")
_VERB_SUFFIXES = ("ize", "ise", "ify")


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text)


def tag(words: Sequence[str]) -> List[Tuple[str, str]]:
    """[(word, coarse POS)] for pre-tokenized words."""
    out: List[Tuple[str, str]] = []
    for w in words:
        lw = w.lower()
        if _PUNCT_RE.match(w):
            out.append((w, "PUNCT"))
        elif lw in _LEX:
            out.append((w, _LEX[lw]))
        elif _NUM_RE.match(lw):
            out.append((w, "NUM"))
        elif lw.endswith("ly") and len(lw) > 3:
            out.append((w, "ADV"))
        elif lw.endswith(_ADJ_SUFFIXES) and len(lw) > 4:
            out.append((w, "ADJ"))
        elif lw.endswith("s") and _LEX.get(lw[:-1]) == "VERB":
            out.append((w, "VERB"))
        elif (lw.endswith("ing") and len(lw) > 4 and lw not in _ING_NOUNS):
            out.append((w, "VERB"))
        elif (lw.endswith("ed") and len(lw) > 4 and lw not in _ED_NOT_VERB):
            out.append((w, "VERB"))
        elif lw.endswith(_VERB_SUFFIXES) and len(lw) > 4:
            out.append((w, "VERB"))
        else:
            out.append((w, "NOUN"))
    return out


def tag_text(text: str) -> List[Tuple[str, str]]:
    return tag(tokenize(text))


def noun_chunks(tagged: Sequence[Tuple[str, str]]) -> List[str]:
    """Maximal ``DET? (ADJ|NUM)* NOUN+`` spans, spaCy-style (determiner
    included in the chunk text, as the reference's <4-word filter sees)."""
    chunks: List[str] = []
    i, n = 0, len(tagged)
    while i < n:
        start = i
        if tagged[i][1] == "DET":
            i += 1
        while i < n and tagged[i][1] in ("ADJ", "NUM"):
            i += 1
        head = i
        while i < n and tagged[i][1] == "NOUN":
            i += 1
        if i > head:  # at least one noun
            chunks.append(" ".join(w for w, _ in tagged[start:i]))
        else:
            i = max(i, start + 1)
    return chunks


# entity gazetteer: single-word names that qualify even sentence-initially
# (a lone capitalized first word is otherwise just ordinary casing)
_GAZETTEER = frozenset(w.lower() for w in """
    january february march april may june july august september october
    november december monday tuesday wednesday thursday friday saturday
    sunday christmas easter halloween thanksgiving
    america england france germany italy spain china japan india russia
    canada mexico brazil australia egypt kenya greece ireland scotland
    wales europe asia africa antarctica
    paris london tokyo moscow rome berlin madrid beijing seattle chicago
    boston houston dallas miami denver atlanta vegas hollywood brooklyn
    manhattan california texas florida hawaii alaska arizona oregon
    obama trump biden lincoln washington einstein shakespeare jesus
    google apple microsoft amazon facebook nike adidas toyota honda ford
    disney nintendo sony samsung pepsi cocacola starbucks mcdonalds
""".split())

# closed-class tags whose capitalized forms never START an entity span
_ENT_EXCLUDE = frozenset(("DET", "PRON", "ADP", "CONJ", "AUX", "PART",
                          "PUNCT"))


def entities(words: Sequence[str]) -> List[str]:
    """Heuristic named-entity spans — the bundled analogue of spaCy's
    ``doc.ents`` in reference answer_extraction (img2prompt_vqa.py:273-281).

    A span is a maximal run of capitalized tokens (``Title`` case or
    ``ALLCAPS`` acronyms) whose first word is not a closed-class function
    word. A sentence-initial capitalized word — ordinary casing, not an
    entity signal — only qualifies when it is a gazetteer hit or the span
    continues into a second capitalized word ("New York began...").
    Caption generators emit lowercase text, so any capitalization there is
    a strong entity signal. Number/date/money entity types are not
    reproduced; bare NUM tokens are already captured by the open-class
    candidate pass."""
    def cap(w: str) -> bool:
        return (w[:1].isupper()
                and (w[1:].islower() or (len(w) > 1 and w.isupper())))

    out: List[str] = []
    i, n = 0, len(words)
    sentence_initial = True
    while i < n:
        w = words[i]
        if _PUNCT_RE.match(w):
            sentence_initial = w in ".!?"
            i += 1
            continue
        lw = w.lower()
        starts = (
            cap(w)
            and _LEX.get(lw) not in _ENT_EXCLUDE
            and (not sentence_initial
                 or lw in _GAZETTEER
                 or (i + 1 < n and cap(words[i + 1])))
        )
        if not starts and lw in _GAZETTEER and lw not in _LEX:
            # lowercase gazetteer hit ("a trip to paris"): caption text is
            # lowercase, so casing alone cannot carry the signal; lexicon
            # words stay ambiguous ("may" AUX, "white" ADJ) and don't fire
            starts = True
        if starts:
            j = i + 1
            while j < n and cap(words[j]):
                j += 1
            out.append(" ".join(words[i:j]))
            i = j
        else:
            i += 1
        sentence_initial = False
    return out


def answer_candidates(caption: str) -> List[str]:
    """Open-class tokens + entity spans + noun chunks (<4 words) in caption
    order — the extraction shape of reference answer_extraction
    (img2prompt_vqa.py:252-295). Entity spans dedup against the tokens
    already collected, like the reference's ``if ent.text not in answers``
    guard (there the guard is global across captions; here per-caption —
    cross-caption entity repeats only affect the frequency sort)."""
    tagged = tag_text(caption.strip().strip("."))
    cands = [w for w, p in tagged if p in OPEN_POS]
    for ent in entities([w for w, _ in tagged]):
        if ent not in cands:
            cands.append(ent)
    # chunks append unconditionally like the reference (duplicates feed the
    # frequency sort in answer_extraction)
    cands += [c for c in noun_chunks(tagged) if len(c.split()) < 4]
    return cands


def pos_of_last_word(text: str) -> str:
    tagged = tag_text(text)
    words = [(w, p) for w, p in tagged if p != "PUNCT"]
    return words[-1][1] if words else "NOUN"
