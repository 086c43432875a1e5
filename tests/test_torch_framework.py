"""The port's framework layer against sprc_tpu's: the copied run-config and
preemption modules, the image processors and the dataset builders, on the
same files and seeds; and chip_smoke.py's config dicts against the YAML
files they stand for (the card machine may lack PyYAML)."""

import inspect
import json
import os
import re

import numpy as np
import pytest

pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
PIL = pytest.importorskip("PIL.Image")

from sprc_tpu import config as jconfig  # noqa: E402
from sprc_tpu.data import builders as _jbuilders  # noqa: E402,F401  (registers them)
from sprc_tpu.data import processors as jprocessors  # noqa: E402
from sprc_tpu.registry import registry as jregistry  # noqa: E402
from sprc_tpu.utils import preempt as jpreempt  # noqa: E402

from sprc_tpu_torch import config  # noqa: E402
from sprc_tpu_torch.data import builders as _builders  # noqa: E402,F401  (registers them)
from sprc_tpu_torch.data import processors  # noqa: E402
from sprc_tpu_torch.registry import registry  # noqa: E402
from sprc_tpu_torch.utils import preempt  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the run configs this slice reads
RUN_CONFIGS = ("pretrain_stage1.yaml", "cirr_finetune.yaml", "fiq_finetune.yaml",
               "eval/ret_coco_blip2_eval.yaml", "eval/ret_flickr_blip2_eval.yaml",
               "retrieval_coco_blip2_ft.yaml", "eval/caption_coco_opt2.7b_eval.yaml",
               "eval/caption_coco_flant5xl_eval.yaml", "didemo_ret_ft.yaml",
               "msrvtt_retrieval_ft.yaml", "msrvtt_qa_ft.yaml", "msvd_qa_ft.yaml",
               "eval/didemo_ret_eval.yaml", "eval/msrvtt_ret_eval.yaml",
               "eval/msrvtt_qa_eval.yaml", "eval/msvd_qa_eval.yaml")
OVERRIDES = ["run.learning_rate=2e-5", "run.k_test=16", "model.image_size=364",
             "datasets.x.build_info.images=/d", "run.flag=true", "run.name=none"]


def _body(obj) -> str:
    return inspect.getsource(obj)


def test_copied_modules_equal_the_originals():
    """config.py's functions and Config, and PreemptionGuard, are the JAX
    package's text (the modules' docstrings and logger names aside)."""
    for name in ("load_yaml", "deep_merge", "_parse_scalar", "apply_dotlist", "Config",
                 "model_config_path"):
        assert _body(getattr(config, name)) == _body(getattr(jconfig, name)), name
    assert os.path.normpath(config.CONFIG_ROOT) == os.path.normpath(jconfig.CONFIG_ROOT)
    strip = lambda s: re.sub(r"sprc_tpu(_torch)?\.preempt", "", s)  # noqa: E731
    assert strip(_body(preempt.PreemptionGuard)) == strip(_body(jpreempt.PreemptionGuard))
    for name in ("random_resized_crop", "_apply_aug", "rand_augment", "_normalize",
                 "BlipImageTrainProcessor", "BlipImageEvalProcessor"):
        assert _body(getattr(processors, name)) == _body(getattr(jprocessors, name)), name


def test_config_equals_jax_on_the_run_configs():
    for name in RUN_CONFIGS:
        path = os.path.join(ROOT, "configs", "runs", name)
        want = jconfig.Config(path, overrides=OVERRIDES)
        got = config.Config(path, overrides=OVERRIDES)
        assert got.to_dict() == want.to_dict(), name
        assert (got.run, got.model, got.datasets) == (want.run, want.model, want.datasets)
        assert got.get("run.k_test") == want.get("run.k_test") == 16
        assert config.Config(defaults=want.to_dict()).to_dict() == want.to_dict()


def test_chip_smoke_config_dicts_equal_their_yaml():
    """chip_smoke.py drives the CLIs with ``--cfg-path`` where PyYAML
    exists, else with ``Config(defaults=<dict>)``: each dict is its file."""
    import chip_smoke

    assert set(chip_smoke.RUN_CONFIGS) == {"eval/ret_coco_blip2_eval.yaml",
                                           "pretrain_stage1.yaml",
                                           "retrieval_coco_blip2_ft.yaml",
                                           "eval/caption_coco_opt2.7b_eval.yaml",
                                           "eval/caption_coco_opt6.7b_eval.yaml",
                                           "eval/caption_coco_flant5xl_eval.yaml",
                                           "caption_coco_blip2_ft.yaml", "pretrain_stage2.yaml",
                                           "eval/vqav2_zeroshot_opt_eval.yaml",
                                           "eval/gqa_zeroshot_flant5xl_eval.yaml",
                                           "eval/pnp_vqa_vqav2_eval.yaml",
                                           "retrieval_coco_ft.yaml",
                                           "retrieval_coco_albef_ft.yaml", "pretrain_14m.yaml",
                                           "pretrain_albef.yaml", "eval/ret_coco_eval.yaml",
                                           "eval/ret_coco_albef_eval.yaml", "vqav2_ft.yaml",
                                           "vqav2_albef_ft.yaml", "eval/vqav2_eval.yaml",
                                           "eval/gqa_eval.yaml", "snli_ve_ft.yaml",
                                           "nlvr_ft.yaml", "eval/snli_ve_eval.yaml",
                                           "eval/nlvr_eval.yaml", "eval/nlvr_albef_eval.yaml",
                                           "caption_coco_ft.yaml", "caption_coco_large_ft.yaml",
                                           "eval/caption_coco_eval.yaml",
                                           "eval/exp_coco_ret_eval.yaml",
                                           "eval/imnet_zs_eval.yaml",
                                           "msrvtt_retrieval_ft.yaml", "msrvtt_qa_ft.yaml",
                                           "eval/msrvtt_ret_eval.yaml",
                                           "eval/msvd_qa_eval.yaml", "dialogue_avsd_ft.yaml",
                                           "eval/dialogue_avsd_eval.yaml"}
    for name, mirror in chip_smoke.RUN_CONFIGS.items():
        assert mirror == config.load_yaml(os.path.join(ROOT, "configs", "runs", name)), name


def _images(root, n=5):
    rng = np.random.RandomState(3)
    names = []
    for i in range(n):
        name = f"im{i}.png"
        PIL.fromarray((rng.rand(30 + 9 * i, 45 - 4 * i, 3) * 255).astype(np.uint8)).save(
            os.path.join(root, name))
        names.append(name)
    return names


def test_processors_equal_jax(tmp_path):
    """The eval transform equal; the two train transforms equal under the
    same seed, over a sequence of images (the same draws in the same order)."""
    names = _images(tmp_path)
    imgs = [PIL.open(os.path.join(tmp_path, n)).convert("RGB") for n in names]
    for kind, kw in (("blip_image_eval", {"image_size": 36}),
                     ("blip_image_train", {"image_size": 24, "seed": 7}),
                     ("blip2_image_train", {"image_size": 24, "seed": 7})):
        mine = registry.get_processor_class(kind)(**kw)
        theirs = jregistry.get_processor_class(kind)(**kw)
        for img in imgs * 3:
            got, want = mine(img), theirs(img)
            assert got.dtype == np.float32 and got.shape == (kw["image_size"],) * 2 + (3,)
            np.testing.assert_array_equal(got, want, err_msg=kind)
    cap = registry.get_processor_class("blip_caption")()
    assert cap("A  Dog, (running)!") == jregistry.get_processor_class("blip_caption")()(
        "A  Dog, (running)!")


def test_builders_equal_jax(tmp_path):
    """Every registered image, video and dialogue builder of JAX's list is
    the port's (the VQA builders' items: test_torch_vqa.py; the video
    builders' items: test_torch_video_data.py; the dialogue's:
    test_torch_dialogue_cli.py; SNLI-VE's and NLVR2's here), and on the same
    annotation files both build the same splits and items."""
    mine = set(registry.list("dataset"))
    assert mine == {"coco_caption", "nocaps", "vg_caption", "sbu_caption",
                    "conceptual_caption_3m", "conceptual_caption_12m", "laion2B_multi",
                    "coco_retrieval", "flickr30k", "coco_vqa", "ok_vqa", "aok_vqa", "gqa",
                    "vg_vqa", "snli_ve", "nlvr", "imagenet", "msrvtt_retrieval",
                    "didemo_retrieval", "msrvtt_qa", "msvd_qa", "msrvtt_caption",
                    "msvd_caption", "vatex_caption", "avsd_dialogue"}
    assert mine <= set(jregistry.list("dataset"))
    names = _images(tmp_path)
    pairs = [{"image": n, "caption": f"A photo {i}!", "image_id": f"id{i % 3}"}
             for i, n in enumerate(names)]
    ret = [{"image": n, "caption": [f"cap {i} a", f"cap {i} b"][: 1 + i % 2], "image_id": i}
           for i, n in enumerate(names)]
    (tmp_path / "pairs.json").write_text(json.dumps(pairs))
    (tmp_path / "ve.json").write_text(json.dumps([
        {"image": n, "sentence": f"A dog {i}.", "label": i % 3} for i, n in enumerate(names)]))
    (tmp_path / "nlvr.json").write_text(json.dumps([
        {"images": [n, names[(i + 1) % len(names)]], "sentence": f"Two {i}!",
         "label": ["True", "False", True][i % 3]} for i, n in enumerate(names)]))
    (tmp_path / "ret.json").write_text(json.dumps({"annotations": ret}))
    vis = {"train": {"name": "blip2_image_train", "image_size": 20},
           "eval": {"name": "blip_image_eval", "image_size": 20}}
    cases = {"conceptual_caption_3m": {"train": [str(tmp_path / "pairs.json")]},
             "coco_retrieval": {"train": str(tmp_path / "pairs.json"),
                                "test": [str(tmp_path / "ret.json")]},
             "coco_caption": {"val": [str(tmp_path / "pairs.json")]},
             "snli_ve": {"train": [str(tmp_path / "ve.json")], "test": [str(tmp_path / "ve.json")]},
             "nlvr": {"train": [str(tmp_path / "nlvr.json")],
                      "test": [str(tmp_path / "nlvr.json")]}}
    for name, ann in cases.items():
        cfg = {"build_info": {"annotations": ann, "images": str(tmp_path)},
               "vis_processor": vis, "text_processor": {"train": {"name": "blip_caption"},
                                                        "eval": {"name": "blip_caption"}}}
        got = registry.get("dataset", name)(cfg).build()
        want = jregistry.get("dataset", name)(cfg).build()
        assert sorted(got) == sorted(want), name
        for split in want:
            g, w = got[split], want[split]
            assert type(g).__name__ == type(w).__name__ and len(g) == len(w)
            for attr in ("text", "img2txt", "txt2img", "image", "img_ids", "annotation"):
                assert getattr(g, attr, None) == getattr(w, attr, None), (name, split, attr)
            for i in range(len(w)):
                gi, wi = g[i], w[i]
                assert sorted(gi) == sorted(wi)
                for k in wi:
                    np.testing.assert_array_equal(np.asarray(gi[k]), np.asarray(wi[k]))
