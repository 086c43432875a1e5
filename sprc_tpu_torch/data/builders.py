"""LAVIS-style dataset builders over image / text pairs (counterpart of
``sprc_tpu/data/builders.py:138-232``, ``:340-381``; reference
src/lavis/datasets/builders/*.py and datasets/*.py).

A builder resolves a config dict into ``{split: dataset}``::

    cfg = {
        "build_info": {"annotations": {"train": [".../ann.json"], "test": [...]},
                       "images": ".../images"},
        "vis_processor": {"train": {"name": "blip_image_train", "image_size": 224},
                          "eval": {"name": "blip_image_eval", "image_size": 364}},
        "text_processor": {"train": {"name": "blip_caption"}},
    }
    datasets = registry.get("dataset", "coco_retrieval")(cfg).build()

The annotation schemas are the reference's: caption and pair data
``{"image", "caption", "image_id"}``; retrieval evaluation ``{"image",
"caption": [...]}``; VQA ``{"image", "question", "answer": [...]}`` (with
``"weights"``, ``"question_id"``, ``"direct_answers"`` where the split has
them). Nothing is downloaded: annotations and images must be on disk.
Registered: the image builders of the JAX package (``coco_caption``,
``nocaps``, ``vg_caption``, ``sbu_caption``, ``conceptual_caption_3m`` /
``_12m``, ``laion2B_multi``, ``coco_retrieval``, ``flickr30k``, the VQA
builders ``coco_vqa``, ``ok_vqa``, ``aok_vqa``, ``gqa``, ``vg_vqa``, SNLI-VE's
``snli_ve`` (``{"image", "sentence", "label"}``) and NLVR2's ``nlvr``
(``{"images": [image0, image1], "sentence", "label"}``, the label
``True`` / ``False`` to 0 / 1 as the reference's class labels), and
``imagenet`` (CLIP's zero-shot classification: SNLI-VE's dataset,
``{"image", "label"}`` with an empty sentence where there is none); the
video and dialogue builders come with their families (ROADMAP A8.6.5,
A8.6.6).
The classes repeat the JAX ones line for line (a test builds both on the
same files).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

from sprc_tpu_torch.data import processors as _processors  # noqa: F401  (registers them)
from sprc_tpu_torch.registry import registry


def _identity(x):
    return x


def _load_annotations(paths: Sequence[str]) -> List[dict]:
    out: List[dict] = []
    for p in paths:
        with open(p) as f:
            data = json.load(f)
        if isinstance(data, dict):  # some LAVIS files wrap in {"annotations": []}
            data = data.get("annotations", list(data.values()))
        out.extend(data)
    return out


def _load_image(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


class AnnotationDataset:
    """Base: annotation list + image root + processors (reference
    datasets/base_dataset.py)."""

    MEDIA_KEY = "image"

    def __init__(self, vis_processor, text_processor, vis_root, ann_paths):
        self.vis_processor = vis_processor or _identity
        self.text_processor = text_processor or _identity
        self.vis_root = vis_root
        self.annotation = _load_annotations(ann_paths)
        for i, ann in enumerate(self.annotation):
            ann.setdefault("instance_id", str(i))

    def __len__(self) -> int:
        return len(self.annotation)

    def _media(self, ann: dict):
        return self.vis_processor(_load_image(os.path.join(self.vis_root, ann[self.MEDIA_KEY])))


class CaptionDataset(AnnotationDataset):
    """(image, caption) training pairs (caption_datasets.py:28-60)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.img_ids: Dict[str, int] = {}
        for ann in self.annotation:
            self.img_ids.setdefault(ann["image_id"], len(self.img_ids))

    def __getitem__(self, index):
        ann = self.annotation[index]
        return {
            "image": self._media(ann),
            "text_input": self.text_processor(ann["caption"]),
            "image_id": self.img_ids[ann["image_id"]],
        }


class CaptionEvalDataset(AnnotationDataset):
    def __getitem__(self, index):
        ann = self.annotation[index]
        return {"image": self._media(ann), "image_id": ann["image_id"],
                "instance_id": ann["instance_id"]}


class ImageTextPairDataset(CaptionDataset):
    """Pretraining pairs (image_text_pair_datasets.py)."""


class RetrievalDataset(CaptionDataset):
    """Adds instance ids (retrieval_datasets.py:29-61)."""

    def __getitem__(self, index):
        out = super().__getitem__(index)
        out["instance_id"] = self.annotation[index]["instance_id"]
        return out


class RetrievalEvalDataset(AnnotationDataset):
    """Gallery images + flattened texts with ``txt2img`` / ``img2txt`` maps
    (retrieval_datasets.py:64-105): what the retrieval evaluation reads."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.text: List[str] = []
        self.image: List[str] = []
        self.txt2img: Dict[int, int] = {}
        self.img2txt: Dict[int, List[int]] = {}
        txt_id = 0
        for img_id, ann in enumerate(self.annotation):
            self.image.append(ann[self.MEDIA_KEY])
            self.img2txt[img_id] = []
            caps = ann["caption"]
            if isinstance(caps, str):
                caps = [caps]
            for caption in caps:
                self.text.append(self.text_processor(caption))
                self.img2txt[img_id].append(txt_id)
                self.txt2img[txt_id] = img_id
                txt_id += 1

    def __getitem__(self, index):
        ann = self.annotation[index]
        return {"image": self._media(ann), "index": index}


class VQADataset(AnnotationDataset):
    """(image, question, weighted answers) (vqa_datasets.py:15-50)."""

    def __getitem__(self, index):
        ann = self.annotation[index]
        answers = ann.get("answer", ann.get("answers", []))
        if isinstance(answers, str):
            answers = [answers]
        weights = ann.get("weights")
        if weights is None:
            uniq: Dict[str, float] = {}
            for a in answers:
                uniq[a] = uniq.get(a, 0.0) + 1.0 / max(len(answers), 1)
            answers, weights = list(uniq), list(uniq.values())
        return {"image": self._media(ann), "text_input": self.text_processor(ann["question"]),
                "answers": answers, "weights": weights}


class VQAEvalDataset(AnnotationDataset):
    """(image, question, its id) and the ground truth where the split has
    it (None on leaderboard splits): GQA's exact-match target
    (gqa_datasets.py:60) and AOKVQA's direct answers (aokvqa_datasets.py:79)."""

    def __getitem__(self, index):
        ann = self.annotation[index]
        answer = ann.get("answer")
        return {"image": self._media(ann), "text_input": self.text_processor(ann["question"]),
                "question_id": ann.get("question_id", ann["instance_id"]),
                "answer": answer[0] if isinstance(answer, list) and answer else answer,
                "direct_answers": ann.get("direct_answers")}


class MultimodalClassificationDataset(AnnotationDataset):
    """snli_ve-style (image, sentence, label) (snli_ve_datasets.py)."""

    def __getitem__(self, index):
        ann = self.annotation[index]
        return {"image": self._media(ann),
                "text_input": self.text_processor(ann.get("sentence", ann.get("caption", ""))),
                "label": ann["label"]}


class NLVRPairDataset(AnnotationDataset):
    """NLVR2 (image0, image1, sentence, label) (reference
    datasets/nlvr_datasets.py:24-63; labels True / False -> 0 / 1, the
    reference's class labels)."""

    CLASS_LABELS = {"True": 0, "False": 1, True: 0, False: 1}

    def __getitem__(self, index):
        ann = self.annotation[index]
        images = ann["images"]
        label = self.CLASS_LABELS.get(ann["label"], ann["label"])
        return {"image0": self.vis_processor(_load_image(os.path.join(self.vis_root, images[0]))),
                "image1": self.vis_processor(_load_image(os.path.join(self.vis_root, images[1]))),
                "text_input": self.text_processor(ann.get("sentence", ann.get("text_input", ""))),
                "label": int(label)}


class DatasetBuilder:
    """Config -> {split: dataset} (base_dataset_builder.py:23-120, minus the
    download step)."""

    def __init__(self, train_cls, eval_cls, cfg: Optional[Dict[str, Any]] = None):
        self.train_cls = train_cls
        self.eval_cls = eval_cls
        self.cfg = cfg or {}

    def _processor(self, section: str, split: str):
        pc = (self.cfg.get(section) or {}).get("train" if split == "train" else "eval")
        if not pc:
            return None
        cls = registry.get("processor", pc["name"])
        kwargs = {k: v for k, v in pc.items() if k != "name"}
        try:
            return cls(**kwargs)
        except TypeError:
            return cls()

    def build(self) -> Dict[str, Any]:
        info = self.cfg.get("build_info", {})
        ann = info.get("annotations", {})
        vis_root = info.get("images", "")
        out: Dict[str, Any] = {}
        for split, paths in ann.items():
            if isinstance(paths, str):
                paths = [paths]
            cls = self.train_cls if split == "train" else self.eval_cls
            if cls is None:
                continue
            out[split] = cls(self._processor("vis_processor", split),
                             self._processor("text_processor", split), vis_root, paths)
        return out


def _register(name: str, train_cls, eval_cls) -> None:
    def factory(cfg=None, _t=train_cls, _e=eval_cls):
        return DatasetBuilder(_t, _e, cfg)

    factory.__name__ = f"builder_{name}"
    registry.register("dataset", name)(factory)


# the reference's image builders (builders/*.py), name for name
for _n in ("coco_caption", "nocaps", "vg_caption", "sbu_caption"):
    _register(_n, CaptionDataset, CaptionEvalDataset)
for _n in ("conceptual_caption_3m", "conceptual_caption_12m", "laion2B_multi"):
    _register(_n, ImageTextPairDataset, None)
for _n in ("coco_retrieval", "flickr30k"):
    _register(_n, RetrievalDataset, RetrievalEvalDataset)
for _n in ("coco_vqa", "ok_vqa", "aok_vqa", "gqa", "vg_vqa"):
    _register(_n, VQADataset, VQAEvalDataset)
for _n in ("snli_ve", "imagenet"):
    _register(_n, MultimodalClassificationDataset, MultimodalClassificationDataset)
_register("nlvr", NLVRPairDataset, NLVRPairDataset)
