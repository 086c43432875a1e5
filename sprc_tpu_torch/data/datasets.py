"""CIR datasets: CIRR, FashionIQ, CIRCO (counterpart of
``sprc_tpu/data/datasets.py``).

The reference's on-disk layouts and split semantics (reference
src/data_utils.py:108-426), framework-free: indexables returning
numpy-ready samples, consumed by :mod:`sprc_tpu_torch.data.loader`. Copied
so that the port imports nothing of ``sprc_tpu``; tests/test_torch_inputs.py
pins their items equal to the originals'. PIL is imported only when an image
is decoded: the relative modes of the val splits read JSON only.

Modes follow the reference contract:
- ``classic``: (image_name, image) — the gallery index stream.
- ``relative``: query triplets; per-split payloads mirror data_utils.py
  (train -> images; val -> names; test -> ids/names for submissions).

Decode errors raise, unless a training split is built with
``skip_errors=True`` (CIRR and FashionIQ): then a sample that fails to load
is logged with its traceback and comes back as ``None``, which the
:class:`~sprc_tpu_torch.data.loader.DataLoader` drops and counts (the
reference swallows them silently).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Union


log = logging.getLogger(__name__)


def _open_image(path):
    import PIL.Image

    return PIL.Image.open(path)


class _SkipErrors:
    """``__getitem__`` over ``_item``: with ``skip_errors`` a failing sample
    is logged and returned as ``None``."""

    def __getitem__(self, index: int):
        try:
            return self._item(index)
        except Exception:  # the skip mode's boundary: logged, counted by the loader
            if self.skip_errors:
                log.warning("skipping unreadable sample %d", index, exc_info=True)
                return None
            raise


class CIRRDataset(_SkipErrors):
    """CIRR (reference data_utils.py:203-286).

    relative mode items:
      train -> dict(reference_name, target_name, caption
                    [+ reference_image, target_image when a transform is set;
                     name-only otherwise, for cached-feature training])
      val   -> dict(reference_name, target_name, caption, group_members)
      test1 -> dict(pair_id, reference_name, caption, group_members)
    classic mode items: dict(image_name, image)
    """

    def __init__(
        self,
        data_path: Union[str, Path],
        split: str,
        mode: str,
        preprocess: Optional[Callable] = None,
        skip_errors: bool = False,
    ):
        if split not in ("test1", "train", "val"):
            raise ValueError("split should be in ['test1', 'train', 'val']")
        if mode not in ("relative", "classic"):
            raise ValueError("mode should be in ['relative', 'classic']")
        self.base = Path(data_path)
        self.split = split
        self.mode = mode
        self._has_preprocess = preprocess is not None
        self.preprocess = preprocess or (lambda x: x)
        self.skip_errors = skip_errors

        with open(self.base / "cirr" / "captions" / f"cap.rc2.{split}.json") as f:
            self.triplets = json.load(f)
        with open(self.base / "cirr" / "image_splits" / f"split.rc2.{split}.json") as f:
            self.name_to_relpath: Dict[str, str] = json.load(f)
        self._names = list(self.name_to_relpath.keys())

    def _img(self, name: str):
        return self.preprocess(_open_image(self.base / self.name_to_relpath[name]))

    def __len__(self) -> int:
        return len(self.triplets) if self.mode == "relative" else len(self._names)

    def _item(self, index: int):
        if self.mode == "classic":
            name = self._names[index]
            return {"image_name": name, "image": self._img(name)}
        t = self.triplets[index]
        members = t["img_set"]["members"]
        ref = t["reference"]
        caption = t["caption"]
        if self.split == "train":
            item = {
                "reference_name": ref,
                "target_name": t["target_hard"],
                "caption": caption,
            }
            # name-only stream when no transform is set (cached-feature
            # training, train/feature_cache.py)
            if self._has_preprocess:
                item["reference_image"] = self._img(ref)
                item["target_image"] = self._img(t["target_hard"])
            return item
        if self.split == "val":
            return {
                "reference_name": ref,
                "target_name": t["target_hard"],
                "caption": caption,
                "group_members": members,
            }
        return {
            "pair_id": t["pairid"],
            "reference_name": ref,
            "caption": caption,
            "group_members": members,
        }


class FashionIQDataset(_SkipErrors):
    """FashionIQ (reference data_utils.py:108-200).

    relative mode items:
      train -> dict(reference_name, target_name, captions
                    [+ reference_image, target_image when a transform is set])
      val   -> dict(reference_name, target_name, captions)
      test  -> dict(reference_name, reference_image, captions)
    classic mode items: dict(image_name, image)
    """

    DRESS_TYPES = ("dress", "shirt", "toptee")

    def __init__(
        self,
        data_path: Union[str, Path],
        split: str,
        dress_types: Sequence[str],
        mode: str,
        preprocess: Optional[Callable] = None,
        skip_errors: bool = False,
    ):
        if mode not in ("relative", "classic"):
            raise ValueError("mode should be in ['relative', 'classic']")
        if split not in ("test", "train", "val"):
            raise ValueError("split should be in ['test', 'train', 'val']")
        for dt in dress_types:
            if dt not in self.DRESS_TYPES:
                raise ValueError(f"dress_type should be in {self.DRESS_TYPES}")

        self.base = Path(data_path)
        self.split = split
        self.mode = mode
        self.dress_types = list(dress_types)
        self._has_preprocess = preprocess is not None
        self.preprocess = preprocess or (lambda x: x)
        self.skip_errors = skip_errors

        self.triplets: List[dict] = []
        for dt in dress_types:
            with open(self.base / "captions" / f"cap.{dt}.{split}.json") as f:
                self.triplets.extend(json.load(f))
        self.image_names: List[str] = []
        for dt in dress_types:
            with open(self.base / "image_splits" / f"split.{dt}.{split}.json") as f:
                self.image_names.extend(json.load(f))

    def _img(self, name: str):
        return self.preprocess(_open_image(self.base / "images" / f"{name}.png"))

    def __len__(self) -> int:
        return len(self.triplets) if self.mode == "relative" else len(self.image_names)

    def _item(self, index: int):
        if self.mode == "classic":
            name = self.image_names[index]
            return {"image_name": name, "image": self._img(name)}
        t = self.triplets[index]
        captions = t["captions"]
        ref = t["candidate"]
        if self.split == "train":
            item = {
                "reference_name": ref,
                "target_name": t["target"],
                "captions": captions,
            }
            if self._has_preprocess:
                item["reference_image"] = self._img(ref)
                item["target_image"] = self._img(t["target"])
            return item
        if self.split == "val":
            return {
                "reference_name": ref,
                "target_name": t["target"],
                "captions": captions,
            }
        return {
            "reference_name": ref,
            "reference_image": self._img(ref),
            "captions": captions,
        }


class CIRCODataset:
    """CIRCO (reference data_utils.py:289-426): COCO-unlabeled gallery with
    multi-ground-truth annotations (val) / query-only (test)."""

    MAX_NUM_GTS = 23

    def __init__(
        self,
        data_path: Union[str, Path],
        split: str,
        mode: str,
        preprocess: Optional[Callable] = None,
        load_images: bool = True,
    ):
        if mode not in ("relative", "classic"):
            raise ValueError("mode should be in ['relative', 'classic']")
        if split not in ("test", "val"):
            raise ValueError("split should be in ['test', 'val']")
        self.base = Path(data_path)
        self.split = split
        self.mode = mode
        self.preprocess = preprocess or (lambda x: x)
        # metadata-only relative iteration (query scoring reuses the gallery
        # index's frozen embeds, so decoding reference images is wasted work)
        self.load_images = load_images

        with open(
            self.base / "COCO2017_unlabeled" / "annotations" / "image_info_unlabeled2017.json"
        ) as f:
            imgs_info = json.load(f)
        self.img_paths = [
            self.base / "COCO2017_unlabeled" / "unlabeled2017" / info["file_name"]
            for info in imgs_info["images"]
        ]
        self.img_ids = [info["id"] for info in imgs_info["images"]]
        self.img_id_to_idx = {str(i): n for n, i in enumerate(self.img_ids)}

        with open(self.base / "annotations" / f"{split}.json") as f:
            self.annotations: List[dict] = json.load(f)

    def __len__(self) -> int:
        return len(self.annotations) if self.mode == "relative" else len(self.img_ids)

    def __getitem__(self, index: int):
        if self.mode == "classic":
            return {
                "img_id": str(self.img_ids[index]),
                "image": self.preprocess(_open_image(self.img_paths[index])),
            }
        ann = self.annotations[index]
        ref_id = str(ann["reference_img_id"])
        item = {
            "query_id": str(ann["id"]),
            "reference_img_id": ref_id,
            "relative_caption": ann["relative_caption"],
            "shared_concept": ann["shared_concept"],
        }
        if self.load_images:
            item["reference_image"] = self.preprocess(
                _open_image(self.img_paths[self.img_id_to_idx[ref_id]])
            )
        if self.split == "val":
            tgt_id = str(ann["target_img_id"])
            gt = [str(x) for x in ann["gt_img_ids"]]
            gt += [""] * (self.MAX_NUM_GTS - len(gt))
            item.update(target_img_id=tgt_id, gt_img_ids=gt)
            if self.load_images:
                item["target_image"] = self.preprocess(
                    _open_image(self.img_paths[self.img_id_to_idx[tgt_id]])
                )
        return item
