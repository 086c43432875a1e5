"""The port's video data path against sprc_tpu's: ALPRO's processors
(``sprc_tpu_torch/data/video_processors.py``), the clip loader
(``data/builders.py::_load_video``, OpenCV decode included) and the video
dataset builders, on the same seeded clips and files. Everything is held
equal, array for array: both packages make the same PIL and numpy calls in
the same order, the train processor consuming its ``RandomState`` as the
JAX one does."""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
PIL = pytest.importorskip("PIL.Image")

from sprc_tpu.data import builders as jbuilders  # noqa: E402
from sprc_tpu.data import video_processors as jvideo  # noqa: E402
from sprc_tpu.registry import registry as jregistry  # noqa: E402

from sprc_tpu_torch.data import builders  # noqa: E402
from sprc_tpu_torch.data import video_processors as video  # noqa: E402
from sprc_tpu_torch.registry import registry  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

VIDEO_BUILDERS = ("msrvtt_retrieval", "didemo_retrieval", "msrvtt_qa", "msvd_qa",
                  "msrvtt_caption", "msvd_caption", "vatex_caption")


def _clips(seed=0, n=4, T=5, H=30, W=44):
    rng = np.random.RandomState(seed)
    return [(rng.rand(T, H + 3 * i, W - 2 * i, 3) * 255).astype(np.uint8) for i in range(n)]


def test_video_processors_equal_jax():
    """``alpro_video_train`` seeded alike gives JAX's clips over a sequence of
    clips (uint8, float in [0, 1], a list of PIL frames), so its draws come in
    JAX's order; ``alpro_video_eval`` equal; both registered by name."""
    for kind, kw in (("alpro_video_train", {"image_size": 24, "seed": 3}),
                     ("alpro_video_eval", {"image_size": 20})):
        mine = registry.get_processor_class(kind)(**kw)
        theirs = jregistry.get_processor_class(kind)(**kw)
        assert type(mine) is getattr(video, type(theirs).__name__)
        for i, clip in enumerate(_clips() * 3):
            arg = [PIL.fromarray(f) for f in clip] if i % 3 == 2 else (
                clip.astype(np.float32) / 255.0 if i % 3 == 1 else clip)
            got, want = mine(arg), theirs(arg)
            assert got.dtype == np.float32 and got.shape == (5, kw["image_size"],
                                                             kw["image_size"], 3)
            np.testing.assert_array_equal(got, want, err_msg=f"{kind} {i}")
    with pytest.raises(ValueError, match=r"\[T,H,W,3\]"):
        video.AlproVideoEvalProcessor()(np.zeros((4, 4, 3), np.uint8))


def test_load_video_npy_npz_frames_and_container(tmp_path):
    """``_load_video`` samples ``n_frms`` frames uniformly from a ``.npy``, a
    ``.npz`` and a directory of PNG frames, and from a container through
    OpenCV (an MJPG ``.avi``), as JAX's; a path of no such kind raises."""
    clip = _clips(seed=1, n=1, T=9)[0]
    np.save(tmp_path / "c.npy", clip)
    np.savez(tmp_path / "c.npz", frames=clip)
    os.makedirs(tmp_path / "frames")
    for t, frame in enumerate(clip):
        PIL.fromarray(frame).save(tmp_path / "frames" / f"{t:02d}.png")
    paths = [str(tmp_path / n) for n in ("c.npy", "c.npz", "frames")]
    cv2 = pytest.importorskip("cv2")
    writer = cv2.VideoWriter(str(tmp_path / "c.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (clip.shape[2], clip.shape[1]))
    for frame in clip:
        writer.write(np.ascontiguousarray(frame[..., ::-1]))
    writer.release()
    paths.append(str(tmp_path / "c.avi"))
    for path in paths:
        for n in (4, 9, 12):
            got, want = builders._load_video(path, n), jbuilders._load_video(path, n)
            assert got.dtype == np.float32 and got.shape == (n, *clip.shape[1:])
            np.testing.assert_array_equal(got, want, err_msg=f"{path} {n}")
    np.testing.assert_array_equal(builders._load_video(paths[0], 3),
                                  clip[[0, 4, 8]].astype(np.float32) / 255.0)
    with pytest.raises(ValueError, match="expected a video container"):
        builders._load_video(str(tmp_path / "c.txt"), 4)


def test_video_builders_equal_jax(tmp_path):
    """The video builders are registered as in JAX and, on the same
    annotation files and clips (``videos`` as the root, ``n_frms`` read),
    build the same splits and items: retrieval training and evaluation
    (text, img2txt / txt2img), QA and captions."""
    mine = set(registry.list("dataset"))
    assert set(VIDEO_BUILDERS) <= mine <= set(jregistry.list("dataset"))
    names = []
    for i, clip in enumerate(_clips(seed=2, n=3, T=6)):
        names.append(f"v{i}.npy")
        np.save(tmp_path / names[-1], clip)
    rows = {"ret": [{"video": n, "caption": f"a clip {i}!", "image_id": f"c{i % 2}"}
                    for i, n in enumerate(names)],
            "ret_eval": [{"video": n, "caption": [f"cap {i} a", f"cap {i} b"][: 1 + i % 2]}
                         for i, n in enumerate(names)],
            "qa": [{"video": n, "question": f"What is {i}?", "answer": ["x", "y", "x"][: 1 + i]}
                   for i, n in enumerate(names)]}
    for key, ann in rows.items():
        (tmp_path / f"{key}.json").write_text(json.dumps(ann))
    vis = {"train": {"name": "alpro_video_train", "image_size": 16, "seed": 4},
           "eval": {"name": "alpro_video_eval", "image_size": 16}}
    cases = {"msrvtt_retrieval": {"train": "ret.json", "test": "ret_eval.json"},
             "msrvtt_qa": {"train": "qa.json", "test": "qa.json"},
             "msvd_caption": {"train": "ret.json"}}
    for name, ann in cases.items():
        cfg = {"build_info": {"annotations": {s: [str(tmp_path / f)] for s, f in ann.items()},
                              "videos": str(tmp_path), "n_frms": 4},
               "vis_processor": vis,
               "text_processor": {"train": {"name": "blip_caption"},
                                  "eval": {"name": "blip_caption"}}}
        got = registry.get("dataset", name)(cfg).build()
        want = jregistry.get("dataset", name)(cfg).build()
        assert sorted(got) == sorted(want), name
        for split in want:
            g, w = got[split], want[split]
            assert type(g).__name__ == type(w).__name__ and len(g) == len(w) == 3
            assert g.MEDIA_KEY == "video" and g.n_frms == 4
            for attr in ("text", "img2txt", "txt2img", "image", "img_ids", "annotation"):
                assert getattr(g, attr, None) == getattr(w, attr, None), (name, split, attr)
            for i in range(len(w)):
                gi, wi = g[i], w[i]
                assert sorted(gi) == sorted(wi)
                assert np.asarray(gi["image"]).shape == (4, 16, 16, 3)
                for k in wi:
                    np.testing.assert_array_equal(np.asarray(gi[k]), np.asarray(wi[k]))
