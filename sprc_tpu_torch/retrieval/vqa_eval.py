"""VQA answer evaluation (the official VQA v2 protocol; a copy of
``sprc_tpu/retrieval/vqa_eval.py``, which imports nothing of JAX; a test holds
the two equal).

Re-implementation of the reference's vendored evaluator
(src/lavis/common/vqa_tools/vqa_eval.py:1-324 — itself the public VQA API
spec): answers are normalized (punctuation, digit words, articles,
contractions — these tables ARE the metric definition) and accuracy per
question is ``mean over gt annotators of min(#other annotators matching
the prediction / 3, 1)``, aggregated overall and per question/answer type.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

# normalization tables from the VQA evaluation spec
_CONTRACTION_PAIRS = [
    ("aint", "ain't"), ("arent", "aren't"), ("cant", "can't"),
    ("couldve", "could've"), ("couldnt", "couldn't"),
    ("couldn'tve", "couldn't've"), ("couldnt've", "couldn't've"),
    ("didnt", "didn't"), ("doesnt", "doesn't"), ("dont", "don't"),
    ("hadnt", "hadn't"), ("hadnt've", "hadn't've"), ("hadn'tve", "hadn't've"),
    ("hasnt", "hasn't"), ("havent", "haven't"), ("hed", "he'd"),
    ("hed've", "he'd've"), ("he'dve", "he'd've"), ("hes", "he's"),
    ("howd", "how'd"), ("howll", "how'll"), ("hows", "how's"),
    ("Id've", "I'd've"), ("I'dve", "I'd've"), ("Im", "I'm"), ("Ive", "I've"),
    ("isnt", "isn't"), ("itd", "it'd"), ("itd've", "it'd've"),
    ("it'dve", "it'd've"), ("itll", "it'll"), ("let's", "let's"),
    ("maam", "ma'am"), ("mightnt", "mightn't"), ("mightnt've", "mightn't've"),
    ("mightn'tve", "mightn't've"), ("mightve", "might've"),
    ("mustnt", "mustn't"), ("mustve", "must've"), ("neednt", "needn't"),
    ("notve", "not've"), ("oclock", "o'clock"), ("oughtnt", "oughtn't"),
    ("ow's'at", "'ow's'at"), ("'ows'at", "'ow's'at"), ("'ow'sat", "'ow's'at"),
    ("shant", "shan't"), ("shed've", "she'd've"), ("she'dve", "she'd've"),
    ("she's", "she's"), ("shouldve", "should've"), ("shouldnt", "shouldn't"),
    ("shouldnt've", "shouldn't've"), ("shouldn'tve", "shouldn't've"),
    ("somebody'd", "somebodyd"), ("somebodyd've", "somebody'd've"),
    ("somebody'dve", "somebody'd've"), ("somebodyll", "somebody'll"),
    ("somebodys", "somebody's"), ("someoned", "someone'd"),
    ("someoned've", "someone'd've"), ("someone'dve", "someone'd've"),
    ("someonell", "someone'll"), ("someones", "someone's"),
    ("somethingd", "something'd"), ("somethingd've", "something'd've"),
    ("something'dve", "something'd've"), ("somethingll", "something'll"),
    ("thats", "that's"), ("thered", "there'd"), ("thered've", "there'd've"),
    ("there'dve", "there'd've"), ("therere", "there're"),
    ("theres", "there's"), ("theyd", "they'd"), ("theyd've", "they'd've"),
    ("they'dve", "they'd've"), ("theyll", "they'll"), ("theyre", "they're"),
    ("theyve", "they've"), ("twas", "'twas"), ("wasnt", "wasn't"),
    ("wed've", "we'd've"), ("we'dve", "we'd've"), ("weve", "we've"),
    ("werent", "weren't"), ("whatll", "what'll"), ("whatre", "what're"),
    ("whats", "what's"), ("whatve", "what've"), ("whens", "when's"),
    ("whered", "where'd"), ("wheres", "where's"), ("whereve", "where've"),
    ("whod", "who'd"), ("whod've", "who'd've"), ("who'dve", "who'd've"),
    ("wholl", "who'll"), ("whos", "who's"), ("whove", "who've"),
    ("whyll", "why'll"), ("whyre", "why're"), ("whys", "why's"),
    ("wont", "won't"), ("wouldve", "would've"), ("wouldnt", "wouldn't"),
    ("wouldnt've", "wouldn't've"), ("wouldn'tve", "wouldn't've"),
    ("yall", "y'all"), ("yall'll", "y'all'll"), ("y'allll", "y'all'll"),
    ("yall'd've", "y'all'd've"), ("y'all'dve", "y'all'd've"),
    ("y'alld've", "y'all'd've"), ("youd", "you'd"), ("youd've", "you'd've"),
    ("you'dve", "you'd've"), ("youll", "you'll"), ("youre", "you're"),
    ("youve", "you've"),
]
CONTRACTIONS = dict(_CONTRACTION_PAIRS)
MANUAL_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
ARTICLES = ("a", "an", "the")
PUNCT = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]
_PERIOD = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA = re.compile(r"(\d)(,)(\d)")


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) or _COMMA.search(text):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD.sub("", out, re.UNICODE)


def process_digit_article(text: str) -> str:
    out: List[str] = []
    for word in text.lower().split():
        word = MANUAL_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in CONTRACTIONS:
            out[i] = CONTRACTIONS[word]
    return " ".join(out)


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(ans))


class VQAEval:
    """Accuracy over {question_id: predicted answer} against ground-truth
    annotations [{question_id, answers: [{answer}...], question_type,
    answer_type}] — reference vqa_eval.py:193-247."""

    def __init__(self, n: int = 2):
        self.n = n
        self.accuracy: Dict[str, object] = {}
        self.eval_qa: Dict[object, float] = {}

    def evaluate(
        self,
        results: Mapping[object, str],
        annotations: Iterable[Mapping],
        ques_ids: Optional[Sequence] = None,
    ) -> Dict[str, object]:
        gts = {a["question_id"]: a for a in annotations}
        if ques_ids is None:
            ques_ids = list(results.keys())
        acc_qa: List[float] = []
        acc_ques_type: Dict[str, List[float]] = {}
        acc_ans_type: Dict[str, List[float]] = {}
        for qid in ques_ids:
            gt = gts[qid]
            res_ans = normalize_answer(str(results[qid]))
            raw = [str(a["answer"]) for a in gt["answers"]]
            if len(set(raw)) > 1:
                raw = [normalize_answer(a) for a in raw]
            accs = []
            for i in range(len(raw)):
                others = raw[:i] + raw[i + 1:]
                matching = sum(1 for o in others if o == res_ans)
                accs.append(min(1.0, matching / 3.0))
            avg = sum(accs) / len(accs) if accs else 0.0
            acc_qa.append(avg)
            self.eval_qa[qid] = round(100 * avg, self.n)
            if "question_type" in gt:
                acc_ques_type.setdefault(gt["question_type"], []).append(avg)
            if "answer_type" in gt:
                acc_ans_type.setdefault(gt["answer_type"], []).append(avg)
        self.accuracy = {
            "overall": round(100 * sum(acc_qa) / max(len(acc_qa), 1), self.n),
            "perQuestionType": {
                k: round(100 * sum(v) / len(v), self.n)
                for k, v in acc_ques_type.items()
            },
            "perAnswerType": {
                k: round(100 * sum(v) / len(v), self.n)
                for k, v in acc_ans_type.items()
            },
        }
        return self.accuracy
