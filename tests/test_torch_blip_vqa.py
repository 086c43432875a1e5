"""BLIP-1 / ALBEF VQA in the port (models/vqa.py, the VQA adapter's and the
classification adapter's collates, the loader rows, interop/jax_params.py's
``vqa_from_jax`` and the LAVIS reader of ``loader.read_checkpoint``)
against sprc_tpu's.

Tiny models (ViT width 64 / depth 2 at 32 px, patch 16; med-BERTs hidden
64, 3 layers, 2 heads, a 60-row vocabulary; ALBEF's fusion from layer 1),
the port's from ``init_weights`` with every bias and norm moved by seeded
noise (test_torch_blip1.py's ``port_model``), the JAX model's from those
weights through the JAX package's LAVIS importer, so no JAX init compiles.
The same seeded numpy inputs go through both, fp32, dropout off. Losses,
logits, question states and probe probabilities agree within 1e-5; ranked
and generated answers are equal. ``jax.lax.top_k`` and ``torch.topk`` may
order near-ties differently, so the rescoring is held on JAX's own top-k
ids, and the whole ranking where the probe's gap at the k-th candidate is
clear (1e-4).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch import loader  # noqa: E402
from sprc_tpu_torch.interop.jax_params import vqa_from_jax  # noqa: E402
from test_torch_blip1 import IMG, VIT, numpy_state, port_model, t  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

TOL = 1e-5
V = 60
TXT = dict(vocab_size=V, hidden_size=64, num_layers=3, num_heads=2, intermediate_size=128,
           encoder_width=64, dropout_rate=0.0)
FUSION = 1
NAMES = {"blip": ("blip_vqa", "vqav2"), "albef": ("albef_vqa", "vqav2")}
B, L, N, LA, A = 3, 7, 5, 5, 12


def overrides(flavor, **extra):
    kw = dict(vit_config_override=VIT, text_config_override=TXT, image_size=IMG, vocab_size=V,
              **extra)
    if flavor == "albef":
        kw["fusion_layer"] = FUSION
    return kw


def jax_vqa(flavor, **extra):
    from sprc_tpu.models.qformer import QFormerConfig
    from sprc_tpu.models.vit import ViTConfig
    from sprc_tpu.models.vqa import VQAConfig, VQAModel

    return VQAModel(VQAConfig(flavor=flavor, image_size=IMG, vocab_size=V, fusion_layer=FUSION,
                              vit_dtype=jnp.float32,
                              vit_config_override=ViTConfig(**{**VIT, "dtype": jnp.float32}),
                              text_config_override=QFormerConfig(**TXT), **extra))


def tiny_vqa(flavor, seed=0, **extra):
    """(the port's tiny model, the JAX model, its params from the port's weights)."""
    from sprc_tpu.interop.lavis_import import vqa_params_from_torch

    name, model_type = NAMES[flavor]
    model = port_model(name, model_type, seed, **overrides(flavor, **extra))
    jm = jax_vqa(flavor, **extra)
    return model, jm, vqa_params_from_torch(numpy_state(model), jm)


@pytest.fixture(scope="module")
def pairs():
    return {flavor: tiny_vqa(flavor, seed) for seed, flavor in enumerate(NAMES)}


def batch(seed=0):
    """Pixels, questions with a padded row, N answers (bos 2, a padded one)
    mapped to their questions, weights, and an answer list of A entries."""
    rs = np.random.RandomState(seed)
    q = rs.randint(5, V, (B, L)).astype(np.int32)
    q[:, 0] = 2
    qm = np.ones((B, L), np.int32)
    qm[1, L - 2:] = q[1, L - 2:] = 0
    a = rs.randint(5, V, (N, LA)).astype(np.int32)
    a[:, 0] = 2
    am = np.ones((N, LA), np.int32)
    am[2, 3:] = a[2, 3:] = 0
    al = rs.randint(5, V, (A, 4)).astype(np.int32)
    al[:, 0] = 2
    alm = np.ones((A, 4), np.int32)
    alm[::3, 3] = al[::3, 3] = 0
    return {"images": rs.rand(B, IMG, IMG, 3).astype(np.float32), "question_ids": q,
            "question_mask": qm, "answer_ids": a, "answer_mask": am,
            "ans_to_question": np.asarray([0, 0, 1, 2, 2], np.int32),
            "weights": rs.rand(N).astype(np.float32), "answer_list": al, "answer_list_mask": alm}


FORWARD = ("images", "question_ids", "question_mask", "answer_ids", "answer_mask",
           "ans_to_question", "weights")


@pytest.mark.parametrize("flavor", list(NAMES))
def test_vqa_loss_logits_and_states_equal_jax(pairs, flavor):
    """The question states, the weighted answer loss and its logits, and the
    same with momentum soft logits and alpha (the distilled mix)."""
    model, jm, params = pairs[flavor]
    b = batch(1)
    args = [b[k] for k in FORWARD]
    soft = np.random.RandomState(2).randn(N, LA, V).astype(np.float32)
    want_states = jm.apply({"params": params}, b["images"], b["question_ids"],
                           b["question_mask"], method=jm.encode_question)
    want = jm.apply({"params": params}, *args)
    want_d = jm.apply({"params": params}, *args, soft_logits=soft, alpha=0.3)
    with torch.no_grad():
        states = model.encode_question(t(b["images"]), t(b["question_ids"]),
                                       t(b["question_mask"]))
        got = model(*map(t, args))
        got_d = model(*map(t, args), soft_logits=t(soft), alpha=0.3)
    np.testing.assert_allclose(states.numpy(), np.asarray(want_states), atol=TOL, rtol=0)
    for g, w in ((got, want), (got_d, want_d)):
        assert abs(float(g["loss"]) - float(w["loss"])) <= TOL * max(1.0, abs(float(w["loss"])))
        np.testing.assert_allclose(g["logits"].numpy(), np.asarray(w["logits"]), atol=TOL,
                                   rtol=0)
    assert abs(float(got_d["loss"]) - float(got["loss"])) > 1e-3  # the mix moved it


def test_rank_answers_equal_jax(pairs):
    """The bos-only probe's probabilities, the rescoring of JAX's own top-k
    ids, and the whole ranking where the gap at the k-th candidate is clear."""
    k = 5
    for flavor, (model, jm, params) in pairs.items():
        b = batch(3)
        al, alm = jnp.asarray(b["answer_list"]), jnp.asarray(b["answer_list_mask"])
        jbest, jtop = jm.rank_answers(params, b["images"], b["question_ids"], b["question_mask"],
                                      al, alm, num_ans_candidates=k)
        states = jm.apply({"params": params}, b["images"], b["question_ids"],
                          b["question_mask"], method=jm.encode_question)
        bos = jnp.full((B, 1), b["answer_list"][0, 0], jnp.int32)
        first = jm.apply({"params": params}, bos, jnp.ones((B, 1), jnp.int32), states,
                         b["question_mask"], method=jm.decode_logits)[:, 0, :]
        want_probe = np.asarray(jax.nn.softmax(first, axis=-1))[:, b["answer_list"][:, 1]]
        with torch.no_grad():
            t_states = model.encode_question(t(b["images"]), t(b["question_ids"]),
                                             t(b["question_mask"]))
            probe = model.answer_probe(t_states, t(b["question_mask"]), t(b["answer_list"]))
            best_on_jax = model.rescore(t_states, t(b["question_mask"]), t(b["answer_list"]),
                                        t(b["answer_list_mask"]), t(np.asarray(jtop)))
            best, top = model.rank_answers(t(b["images"]), t(b["question_ids"]),
                                           t(b["question_mask"]), t(b["answer_list"]),
                                           t(b["answer_list_mask"]), num_ans_candidates=k)
        np.testing.assert_allclose(probe.numpy(), want_probe, atol=TOL, rtol=0)
        assert best_on_jax.tolist() == np.asarray(jbest).tolist(), flavor
        ordered = np.sort(want_probe, axis=1)[:, ::-1]
        clear = ordered[:, k - 1] - ordered[:, k] > 1e-4
        assert clear.any(), flavor
        assert (best.numpy()[clear] == np.asarray(jbest)[clear]).all(), flavor
        for row in np.flatnonzero(clear):
            assert set(top.numpy()[row]) == set(np.asarray(jtop)[row]), (flavor, row)


def test_generate_answers_equal_jax(pairs):
    """Greedy answers: with an eos no row draws, then with the eos that the
    first row draws second, so that rows finish at different lengths."""
    for flavor, (model, jm, params) in pairs.items():
        b = batch(4)
        args = (b["images"], b["question_ids"], b["question_mask"])
        eos = V - 1
        for _ in range(2):
            want = np.asarray(jm.generate_answers(params, *args, bos_token_id=2,
                                                  eos_token_id=eos, max_new_tokens=5))
            got = model.generate_answers(*map(t, args), bos_token_id=2, eos_token_id=eos,
                                         max_new_tokens=5)
            assert got.numpy().tolist() == want.tolist(), flavor
            eos = int(want[0, 1])


@pytest.mark.parametrize("flavor", list(NAMES))
def test_vqa_bridge_and_lavis_reader(pairs, flavor, tmp_path):
    """``vqa_from_jax`` loads with ``strict=True`` and gives the port's
    weights back; a LAVIS-layout file (momentum modules ``*_m``, ALBEF's
    question encoder wrapped as ``text_encoder.bert.``, the LM head's bias
    only as ``cls.predictions.bias``) loads through ``read_checkpoint`` to
    the same weights, and the JAX reader reads it to the same tree; a file
    without one weight raises."""
    from sprc_tpu.interop.lavis_import import vqa_params_from_torch

    model, jm, params = pairs[flavor]
    name, model_type = NAMES[flavor]
    fresh = loader.build_model(name, model_type, device="cpu", **overrides(flavor))
    fresh.load_state_dict(vqa_from_jax(params), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    sd = numpy_state(model)
    del sd["text_decoder.cls.predictions.decoder.bias"]
    for k in [k for k in sd if k.split(".")[0] in ("visual_encoder", "text_encoder",
                                                   "text_decoder")]:
        head, _, rest = k.partition(".")
        sd[f"{head}_m.{rest}"] = sd[k] + 1.0
    if flavor == "albef":
        sd = {(k.replace("text_encoder.", "text_encoder.bert.", 1)
               if k.startswith("text_encoder.") else k): v for k, v in sd.items()}
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}},
               tmp_path / "lavis.pth")
    read = loader.load_model(name, model_type, checkpoint_path=str(tmp_path / "lavis.pth"),
                             device="cpu", **overrides(flavor))
    for k, v in model.state_dict().items():
        assert torch.equal(read.state_dict()[k], v), k
    again = vqa_params_from_torch(sd, jm)
    for a, b_ in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))
    bad = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()
           if "text_decoder.bert.encoder.layer.1.crossattention.self.key.weight" not in k}
    torch.save({"model": bad}, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        loader.load_model(name, model_type, checkpoint_path=str(tmp_path / "bad.pth"),
                          device="cpu", **overrides(flavor))


def test_adapters_collate_equal_jax(tmp_path):
    """The VQA adapter's collate (questions, answers flattened with their
    weights and ``ans_to_question``) and ramp (one epoch), the
    classification adapter's for SNLI-VE items and NLVR pairs and its ramps
    (one epoch, two for NLVR), against the JAX adapters; and
    ``classifier_rampup_alpha`` / ``nlvr_rampup_alpha`` against JAX's."""
    from sprc_tpu.train import generic as jgeneric

    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.train import generic
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    tok = BertWordPieceTokenizer.from_vocab_file(write_synthetic_bert_vocab(
        str(tmp_path / "vocab.txt")))
    rs = np.random.RandomState(5)
    img = lambda: rs.rand(IMG, IMG, 3).astype(np.float32)  # noqa: E731
    vqa_items = [{"image": img(), "text_input": "what color is the car",
                  "answers": ["red", "dark red"], "weights": [0.75, 0.25]},
                 {"image": img(), "text_input": "how many cats", "answers": ["two"],
                  "weights": [1.0]}]
    cls_items = [{"image": img(), "text_input": "a dog on the grass", "label": 2},
                 {"image": img(), "text_input": "two cats", "label": 0}]
    pair_items = [{"image0": img(), "image1": img(), "text_input": "the left one", "label": 1},
                  {"image0": img(), "image1": img(), "text_input": "both", "label": 0}]
    cases = [(generic.VQAAdapter(tok, 35), jgeneric.VQAAdapter(tok, 35), vqa_items, 1),
             (generic.ClassificationAdapter(tok, 40), jgeneric.ClassificationAdapter(tok, 40),
              cls_items, 1),
             (generic.ClassificationAdapter(tok, 40), jgeneric.ClassificationAdapter(tok, 40),
              pair_items, 2)]
    for port, ref, items, epochs in cases:
        got, want = port.collate(items), ref.collate(items)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert got[key].dtype == want[key].dtype, key
        port._ramp_epochs = ref._ramp_epochs = epochs
        for e, i in ((0, 0), (0, 3), (1, 2), (2, 0)):
            assert port.step_extras(e, i, 4) == ref.step_extras(e, i, 4)
    from sprc_tpu.models import classification as jcls
    from sprc_tpu.models import nlvr as jnlvr

    from sprc_tpu_torch.models import classification, nlvr

    cfg = loader.family_config("albef_nlvr", "nlvr")
    for e, i in ((0, 0), (0, 3), (1, 2), (2, 0)):
        assert classification.classifier_rampup_alpha(cfg, e, i, 4) == \
            jcls.classifier_rampup_alpha(cfg, e, i, 4)
        assert nlvr.nlvr_rampup_alpha(cfg, e, i, 4) == jnlvr.nlvr_rampup_alpha(cfg, e, i, 4)


def test_registered_names_rows_processors_and_a_narrow_text_side():
    """The six names are registered, their rows build the classes the JAX
    loader builds, and the VQA rows take ``blip_question`` for train and
    eval (the others ``blip_caption``); a VQA model whose med-BERTs are
    narrower than its tower (hidden 32, the tower 64 wide) cross-attends
    the question states in its decoder at their width, as the JAX model
    does: its loss and logits equal JAX's."""
    from sprc_tpu.registry import registry as jregistry

    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.text.processors import CaptionProcessor, QuestionProcessor

    rows = {"blip_vqa": "vqav2", "albef_vqa": "vqav2", "blip_classification": "base",
            "albef_classification": "ve", "blip_nlvr": "nlvr", "albef_nlvr": "nlvr"}
    for name, model_type in rows.items():
        assert registry.get_model_class(name).__name__ == jregistry.get_model_class(
            name).__name__
        _, txt = loader.preprocessors(name, model_type)
        want = QuestionProcessor if name.endswith("vqa") else CaptionProcessor
        assert all(type(p) is want for p in txt.values()), name
    assert loader.family_config("blip_vqa", "vqav2").vit_config().seq_len == 901
    assert loader.family_config("albef_nlvr", "nlvr").vit_config().seq_len == 577
    assert set(loader.VQA_MODELS + loader.CLASSIFICATION_MODELS) == set(rows)

    from sprc_tpu.interop.lavis_import import vqa_params_from_torch
    from sprc_tpu.models.qformer import QFormerConfig
    from sprc_tpu.models.vit import ViTConfig
    from sprc_tpu.models.vqa import VQAConfig, VQAModel

    narrow = dict(TXT, hidden_size=32, intermediate_size=64)
    model = port_model("blip_vqa", "vqav2", 3, **dict(overrides("blip"),
                                                      text_config_override=narrow))
    layer = model.text_decoder.bert.encoder.layer[0].crossattention.self
    assert tuple(layer.key.weight.shape) == (32, 32)
    jm = VQAModel(VQAConfig(image_size=IMG, vocab_size=V, vit_dtype=jnp.float32,
                            vit_config_override=ViTConfig(**{**VIT, "dtype": jnp.float32}),
                            text_config_override=QFormerConfig(**narrow)))
    params = vqa_params_from_torch(numpy_state(model), jm)
    b = batch(6)
    args = [b[k] for k in FORWARD]
    want = jm.apply({"params": params}, *args)
    with torch.no_grad():
        got = model(*map(t, args))
    assert abs(float(got["loss"]) - float(want["loss"])) <= TOL * max(1.0, float(want["loss"]))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=TOL,
                               rtol=0)
