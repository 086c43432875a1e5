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
``{"image", "label"}`` with an empty sentence where there is none), and the
video builders of ALPRO's runs, whose annotations name a ``"video"``
(``msrvtt_retrieval``, ``didemo_retrieval``, ``msrvtt_qa``, ``msvd_qa``;
``msrvtt_caption``, ``msvd_caption``, ``vatex_caption``): ``build_info``'s
``videos`` (or ``images``) is their root and ``n_frms`` (8) the frames each
clip is sampled to (:func:`_load_video`: a ``.npy`` / ``.npz`` tensor, a
directory of frame images, or a container decoded by OpenCV, which is
imported only there), and the GPT dialogue's ``avsd_dialogue``
(:class:`AVSDDialDataset`: the AVSD annotation through the ``gpt_dialogue``
processor, the video's feature streams under ``build_info``'s ``videos``
through ``gpt_video_ft``). The classes repeat the JAX ones line for line (a test builds both
on the same files).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

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


_VIDEO_EXTS = (".mp4", ".avi", ".mkv", ".mov", ".webm", ".mpg", ".mpeg", ".m4v", ".wmv")


def _decode_video_cv2(path: str, n_frms: int) -> np.ndarray:
    """A container -> [n_frms, H, W, 3] uint8 RGB through OpenCV (the decord
    of reference alpro_processors.load_video: uniform temporal sampling).
    Only the sampled frames are decoded where the container reports its
    frame count; otherwise, or where that count was wrong, every frame is
    read in order and the sample taken from them."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"{path}: OpenCV could not open the video")
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
    if total > 0:
        idx = np.linspace(0, total - 1, n_frms).round().astype(int)
        want = set(int(i) for i in idx)
        got = {}
        pos = 0
        while pos <= int(idx.max()):
            if pos in want:
                ok, frame = cap.read()
                if not ok:
                    break
                got[pos] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            elif not cap.grab():
                break
            pos += 1
        cap.release()
        if len(got) == len(want):
            return np.stack([got[int(i)] for i in idx])
        cap = cv2.VideoCapture(path)  # the frame-count metadata was wrong
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise ValueError(f"{path}: no decodable frames")
    arr = np.stack(frames)
    idx = np.linspace(0, arr.shape[0] - 1, n_frms).round().astype(int)
    return arr[idx]


def _load_video(path: str, n_frms: int) -> np.ndarray:
    """A video container (OpenCV), a frame directory (its images in sorted
    order) or a ``.npy`` / ``.npz`` [T, H, W, 3] tensor -> ``n_frms``
    uniformly sampled frames [n_frms, H, W, 3] float32 in [0, 1]."""
    if path.endswith((".npy", ".npz")):
        arr = np.load(path)
        if hasattr(arr, "files"):
            arr = arr[arr.files[0]]
        frames = np.asarray(arr)
    elif os.path.isdir(path):
        names = sorted(n for n in os.listdir(path)
                       if n.lower().endswith((".jpg", ".jpeg", ".png")))
        frames = np.stack([np.asarray(_load_image(os.path.join(path, n))) for n in names])
    elif path.lower().endswith(_VIDEO_EXTS) and os.path.isfile(path):
        frames = _decode_video_cv2(path, n_frms)
    else:
        raise ValueError(f"{path}: expected a video container ({', '.join(_VIDEO_EXTS)}), a "
                         "frame directory, or a .npy/.npz tensor")
    T = frames.shape[0]
    idx = np.linspace(0, T - 1, n_frms).round().astype(int)
    frames = frames[idx]
    if frames.dtype == np.uint8:
        frames = frames.astype(np.float32) / 255.0
    return frames.astype(np.float32)


class AnnotationDataset:
    """Base: annotation list + media root + processors (reference
    datasets/base_dataset.py); ``MEDIA_KEY`` ``"video"`` loads ``n_frms``
    frames of a clip."""

    MEDIA_KEY = "image"

    def __init__(self, vis_processor, text_processor, vis_root, ann_paths, n_frms: int = 8):
        self.vis_processor = vis_processor or _identity
        self.text_processor = text_processor or _identity
        self.vis_root = vis_root
        self.annotation = _load_annotations(ann_paths)
        self.n_frms = n_frms
        for i, ann in enumerate(self.annotation):
            ann.setdefault("instance_id", str(i))

    def __len__(self) -> int:
        return len(self.annotation)

    def _media(self, ann: dict):
        path = os.path.join(self.vis_root, ann[self.MEDIA_KEY])
        if self.MEDIA_KEY == "video":
            return self.vis_processor(_load_video(path, self.n_frms))
        return self.vis_processor(_load_image(path))


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


class AVSDDialDataset(AnnotationDataset):
    """AVSD dialogue turns and pre-extracted video features (reference
    datasets/avsd_dialogue_datasets.py): the GPT dialogue text processor
    takes the whole annotation (caption, summary, dialog, question,
    answer), the video processor loads the feature streams by video name."""

    def __getitem__(self, index):
        ann = self.annotation[index]
        item = dict(self.text_processor(ann))
        vis = self.vis_processor(self.vis_root, ann.get("image_id", ann.get("video_id", "")))
        item["video_fts"] = vis["video_fts"]
        item["video_token_type_ids"] = vis["token_type_ids"]
        return item


class VideoRetrievalDataset(RetrievalDataset):
    MEDIA_KEY = "video"


class VideoRetrievalEvalDataset(RetrievalEvalDataset):
    MEDIA_KEY = "video"


class VideoQADataset(VQADataset):
    MEDIA_KEY = "video"


class VideoCaptionDataset(CaptionDataset):
    MEDIA_KEY = "video"


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
        vis_root = info.get("images", info.get("videos", ""))
        n_frms = info.get("n_frms", 8)
        out: Dict[str, Any] = {}
        for split, paths in ann.items():
            if isinstance(paths, str):
                paths = [paths]
            cls = self.train_cls if split == "train" else self.eval_cls
            if cls is None:
                continue
            out[split] = cls(self._processor("vis_processor", split),
                             self._processor("text_processor", split), vis_root, paths,
                             n_frms=n_frms)
        return out


def _register(name: str, train_cls, eval_cls) -> None:
    def factory(cfg=None, _t=train_cls, _e=eval_cls):
        return DatasetBuilder(_t, _e, cfg)

    factory.__name__ = f"builder_{name}"
    registry.register("dataset", name)(factory)


# the reference's image and video builders (builders/*.py), name for name
for _n in ("coco_caption", "nocaps", "vg_caption", "sbu_caption"):
    _register(_n, CaptionDataset, CaptionEvalDataset)
for _n in ("msrvtt_caption", "msvd_caption", "vatex_caption"):
    _register(_n, VideoCaptionDataset, VideoCaptionDataset)
for _n in ("conceptual_caption_3m", "conceptual_caption_12m", "laion2B_multi"):
    _register(_n, ImageTextPairDataset, None)
for _n in ("coco_retrieval", "flickr30k"):
    _register(_n, RetrievalDataset, RetrievalEvalDataset)
for _n in ("msrvtt_retrieval", "didemo_retrieval"):
    _register(_n, VideoRetrievalDataset, VideoRetrievalEvalDataset)
for _n in ("coco_vqa", "ok_vqa", "aok_vqa", "gqa", "vg_vqa"):
    _register(_n, VQADataset, VQAEvalDataset)
for _n in ("msrvtt_qa", "msvd_qa"):
    _register(_n, VideoQADataset, VideoQADataset)
for _n in ("snli_ve", "imagenet"):
    _register(_n, MultimodalClassificationDataset, MultimodalClassificationDataset)
_register("nlvr", NLVRPairDataset, NLVRPairDataset)
_register("avsd_dialogue", AVSDDialDataset, AVSDDialDataset)
