"""CLIP zero-shot classification (counterpart of
``sprc_tpu/models/clip_zero_shot.py``; reference
lavis/models/clip_models/model.py:692-744 and its
``openai_imagenet_template``).

Every class name is rendered through the 80 OpenAI ImageNet templates, the
text features are L2-normalised, averaged a class and normalised again, and
stacked into a [D, C] classifier; a prediction is ``100 * normalised image
features @ classifier``. The template strings are the published protocol
(they define the metric), copied from the JAX module; ``{c}`` is the class
name's slot.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from sprc_tpu_torch.ops.layers import l2_normalize

OPENAI_IMAGENET_TEMPLATES: List[str] = [
    "a bad photo of a {c}.", "a photo of many {c}.", "a sculpture of a {c}.",
    "a photo of the hard to see {c}.", "a low resolution photo of the {c}.",
    "a rendering of a {c}.", "graffiti of a {c}.", "a bad photo of the {c}.",
    "a cropped photo of the {c}.", "a tattoo of a {c}.",
    "the embroidered {c}.", "a photo of a hard to see {c}.",
    "a bright photo of a {c}.", "a photo of a clean {c}.",
    "a photo of a dirty {c}.", "a dark photo of the {c}.",
    "a drawing of a {c}.", "a photo of my {c}.", "the plastic {c}.",
    "a photo of the cool {c}.", "a close-up photo of a {c}.",
    "a black and white photo of the {c}.", "a painting of the {c}.",
    "a painting of a {c}.", "a pixelated photo of the {c}.",
    "a sculpture of the {c}.", "a bright photo of the {c}.",
    "a cropped photo of a {c}.", "a plastic {c}.",
    "a photo of the dirty {c}.", "a jpeg corrupted photo of a {c}.",
    "a blurry photo of the {c}.", "a photo of the {c}.",
    "a good photo of the {c}.", "a rendering of the {c}.",
    "a {c} in a video game.", "a photo of one {c}.", "a doodle of a {c}.",
    "a close-up photo of the {c}.", "a photo of a {c}.",
    "the origami {c}.", "the {c} in a video game.", "a sketch of a {c}.",
    "a doodle of the {c}.", "a origami {c}.",
    "a low resolution photo of a {c}.", "the toy {c}.",
    "a rendition of the {c}.", "a photo of the clean {c}.",
    "a photo of a large {c}.", "a rendition of a {c}.",
    "a photo of a nice {c}.", "a photo of a weird {c}.",
    "a blurry photo of a {c}.", "a cartoon {c}.", "art of a {c}.",
    "a sketch of the {c}.", "a embroidered {c}.",
    "a pixelated photo of a {c}.", "itap of the {c}.",
    "a jpeg corrupted photo of the {c}.", "a good photo of a {c}.",
    "a plushie {c}.", "a photo of the nice {c}.",
    "a photo of the small {c}.", "a photo of the weird {c}.",
    "the cartoon {c}.", "art of the {c}.", "a drawing of the {c}.",
    "a photo of the large {c}.", "a black and white photo of a {c}.",
    "the plushie {c}.", "a dark photo of a {c}.", "itap of a {c}.",
    "graffiti of the {c}.", "a toy {c}.", "itap of my {c}.",
    "a photo of a cool {c}.", "a photo of a small {c}.",
    "a tattoo of the {c}.",
]


def zero_shot_classifier(model, classnames: Sequence[str],
                         tokenize: Callable[[Sequence[str]], tuple], *,
                         templates: Sequence[str] = tuple(OPENAI_IMAGENET_TEMPLATES)
                         ) -> np.ndarray:
    """-> the [D, C] classifier (float32): ``tokenize(texts) -> (input_ids
    [N, L], eot_positions [N])``, the class's templates in one text-tower
    call, normalised in numpy as the JAX function does."""
    device = next(model.parameters()).device
    weights = []
    with torch.inference_mode():
        for classname in classnames:
            ids, eot = tokenize([t.format(c=classname) for t in templates])
            emb = model.encode_text(torch.as_tensor(np.asarray(ids), dtype=torch.long,
                                                    device=device),
                                    torch.as_tensor(np.asarray(eot), dtype=torch.long,
                                                    device=device)).cpu().numpy()
            emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
            mean = emb.mean(axis=0)
            weights.append(mean / np.linalg.norm(mean))
    return np.stack(weights, axis=1)


def make_zero_shot_predict_fn(model, classifier: np.ndarray,
                              stats: Dict[str, float] = None) -> Callable:
    """``predict_fn(samples) -> {"predictions", "targets"}`` for
    ``MultimodalClassificationTask`` (reference predict, model.py:692-701):
    the image tower's features normalised, times 100 and the classifier.
    ``stats["tower"]`` collects the seconds of the image tower."""
    from sprc_tpu_torch.models.generation import stage

    device = next(model.parameters()).device
    clf = torch.as_tensor(np.asarray(classifier, np.float32), device=device)

    def predict_fn(samples: dict) -> Dict[str, np.ndarray]:
        images = torch.from_numpy(np.ascontiguousarray(samples["image"], np.float32)).to(device)
        with torch.inference_mode(), stage(stats, "tower", device):
            logits = 100.0 * l2_normalize(model.encode_image(images).float()) @ clf
        return {"predictions": logits.cpu().numpy(), "targets": np.asarray(samples["label"])}

    return predict_fn
