"""The rerank entry points of the port against sprc_tpu's on the same
weights: ``cli.validate_rerank`` (CIRR and FashionIQ) on the synthetic
trees of tests/test_data.py, and serve's rerank stage (``RetrievalService``
with a scorer, its 400s, its ``SystemExit``).

The CLIs read checkpoints of the released layout: the retrieval model of
test_torch_validate.py and a ``blip2_cir_rerank`` initialised in JAX (with
the projections only its eval side reads, and non-zero biases), exported by
``torch_export``; both CLIs run with the same ``--model-overrides`` (EVA-
and CLIP-style tiny towers), the port on the CPU. The rerank scores of the
two agree within 1e-4 absolute (fp32 sums in another order through 2 ViT
blocks and two Q-Former layers) and the printed metric JSON is equal as
text. The services run the tiny CLIP-style models of test_torch_rerank.py
(both rerank flavours: ITM over frozen embeds, feature space over target
feats): the served names equal, the scores (stage 1's) within 1e-4.
"""

import json
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import sprc_tpu.cli.serve as jserve  # noqa: E402
import sprc_tpu.cli.validate as jcli  # noqa: E402
import sprc_tpu.cli.validate_rerank as jrcli  # noqa: E402
import sprc_tpu.loader as jloader  # noqa: E402
import sprc_tpu.retrieval.rerank as jrerank  # noqa: E402
from sprc_tpu.retrieval.engine import RetrievalEngine as JRetrievalEngine  # noqa: E402
from sprc_tpu.text.tokenizer import BertWordPieceTokenizer as JTokenizer  # noqa: E402
from test_data import cirr_root, fiq_root  # noqa: E402,F401  (fixtures)
from test_golden_rehearsal import _wrap  # noqa: E402
from test_torch_validate import STYLES, checkpoints  # noqa: E402,F401  (fixture)

import sprc_tpu_torch.cli.serve as pserve  # noqa: E402
import sprc_tpu_torch.cli.validate_rerank as prcli  # noqa: E402
import sprc_tpu_torch.loader as ploader  # noqa: E402
import sprc_tpu_torch.retrieval.rerank as prerank  # noqa: E402
from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from sprc_tpu_torch.retrieval.engine import RetrievalEngine  # noqa: E402
from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer  # noqa: E402

from test_torch_model import IMG, inputs, jax_model, jax_params, port_model  # noqa: E402
from test_torch_rerank import jax_variant, jax_variant_params, port_variant  # noqa: E402
from test_torch_serve import TOKENS  # noqa: E402
from test_torch_serve_cli import _post  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ATOL = 1e-4
RERANK_FLAGS = ["--rerank-top", "3", "--rerank-step", "2"]


@pytest.fixture(scope="module")
def rerank_checkpoints(checkpoints, tmp_path_factory):  # noqa: F811
    """checkpoints[style] (the retrieval model) and rerank[style]: a
    blip2_cir_rerank of the released layout for each tower style."""
    from sprc_tpu.interop.torch_export import params_to_torch_state_dict

    root = tmp_path_factory.mktemp("rerank")
    out = {"rerank": {}, **checkpoints}
    for style, (model_type, overrides) in STYLES.items():
        model = jloader.build_model("blip2_cir_rerank", model_type,
                                    **jcli.parse_model_overrides(overrides))
        params = dict(jloader.init_params(model, rng=jax.random.PRNGKey(7)))
        emb, ids = jnp.zeros((1, 5, 32)), jnp.zeros((1, 8), jnp.int32)
        extra = model.init(jax.random.PRNGKey(8), emb, ids, jnp.ones_like(ids),
                           method=lambda m, e, i, o: (m.fusion_feature(e, i, o),
                                                      m.target_features(e)))["params"]
        params.update(vision_proj=extra["vision_proj"], text_proj=extra["text_proj"])
        rng = np.random.RandomState(9)
        params = jax.tree_util.tree_map(
            lambda a: a if np.ndim(a) == 0 else np.asarray(a) + (
                rng.standard_normal(np.shape(a)) * 0.02).astype(np.asarray(a).dtype), params)
        # an ITM head of unit scale: the tiny model's logits otherwise spread
        # the rerank scores over about 1e-3
        params["itm_head"] = dict(params["itm_head"], kernel=rng.standard_normal(
            np.shape(params["itm_head"]["kernel"])).astype(np.float32))
        path = root / f"rerank_{style}.pt"
        torch.save(_wrap(torch, "Blip2QformerCirRerank", params_to_torch_state_dict(params, model)),
                   path)
        out["rerank"][style] = str(path)
    return out


def _record(monkeypatch, cls, into):
    inner = cls.__call__

    def call(self, *a, **kw):
        out = inner(self, *a, **kw)
        into.append(np.asarray(out))
        return out

    monkeypatch.setattr(cls, "__call__", call)


@pytest.mark.parametrize("style", ["eva", "clip"])
@pytest.mark.parametrize("dataset", ["CIRR", "fashionIQ"])
def test_validate_rerank_matches_jax(dataset, style, rerank_checkpoints, cirr_root,  # noqa: F811
                                     fiq_root, monkeypatch, capsys):  # noqa: F811
    model_type, overrides = STYLES[style]
    data = {"CIRR": cirr_root, "fashionIQ": fiq_root}[dataset]
    argv = ["--dataset", dataset, "--data-path", str(data),
            "--model-path", rerank_checkpoints[style],
            "--rerank-model-path", rerank_checkpoints["rerank"][style],
            "--model-type", model_type, "--vocab-path", rerank_checkpoints["vocab"],
            "--encode-batch", "4", "--query-batch", "2", "--workers", "2", "--no-bf16",
            "--dress-types", "dress", *RERANK_FLAGS, "--model-overrides", *overrides]
    scores = {"jax": [], "port": []}
    _record(monkeypatch, jrerank.ItmRerankScorer, scores["jax"])
    _record(monkeypatch, prerank.ItmRerankScorer, scores["port"])
    jrcli.main(argv)
    jtext = capsys.readouterr().out
    prcli.main(argv + ["--device", "cpu"])
    ptext = capsys.readouterr().out
    assert len(scores["port"]) == len(scores["jax"]) == 2  # tiles of 2 queries, then 1 or 2
    for got, want in zip(scores["port"], scores["jax"]):
        np.testing.assert_allclose(got, want[: len(got)], atol=ATOL)
    assert np.ptp(np.concatenate(scores["jax"])) > 10 * ATOL  # the scores tell candidates apart
    assert ptext == jtext
    keys = list(json.loads(ptext))
    assert keys == (["group_recall_at1", "group_recall_at2", "group_recall_at3", "recall_at1",
                     "recall_at5", "recall_at10", "recall_at50"] if dataset == "CIRR" else
                    ["dress_recall_at10", "dress_recall_at50", "average_recall"])


def test_validate_rerank_flags_and_defaults_are_the_jax_clis():
    """The JAX CLI's flags and defaults (CIRR top 200 / step 15, else 40 /
    40), --mesh included, plus --device."""
    jflags = {a.dest: a.default for a in jrcli.make_parser()._actions}
    pflags = {a.dest: a.default for a in prcli.make_parser()._actions}
    assert set(jflags) - set(pflags) == set() and set(pflags) - set(jflags) == {"device"}
    assert all(pflags[k] == v for k, v in jflags.items())
    for dataset, want in (("CIRR", (200, 15)), ("fashionIQ", (40, 40)), ("CIRCO", (40, 40))):
        args = prcli.parse_args(["--dataset", dataset, "--data-path", "x"])
        assert (args.rerank_top, args.rerank_step) == want
        assert (args.rerank_model_name, args.device) == ("blip2_cir_rerank", "cuda")
    args = prcli.parse_args(["--dataset", "CIRR", "--data-path", "x", *RERANK_FLAGS])
    assert (args.rerank_top, args.rerank_step) == (3, 2)


GALLERY = [f"g{i}" for i in range(7)]
PAIRS = [("g0", "red dress"), ("g3", "long"), ("g5", "long red")]


def _services(name, jm, params, pm, top=4, step=2):
    """The JAX and the port's RetrievalService with a rerank scorer over the
    same 7-image gallery (encode batches of 4, query batches of 2)."""
    images = np.random.RandomState(4).rand(len(GALLERY), IMG, IMG, 3).astype(np.float32)
    batches = [(GALLERY[s: s + 4], images[s: s + 4]) for s in range(0, len(GALLERY), 4)]
    vocab = {t: i for i, t in enumerate(TOKENS)}
    jengine = JRetrievalEngine(jm, params, JTokenizer(vocab), encode_batch=4, query_batch=2)
    jsvc = jserve.RetrievalService(jengine, jengine.build_index(iter(batches)),
                                   jrerank.ItmRerankScorer(jm, params, jengine.tokenizer,
                                                           top=top, step=step))
    tok = BertWordPieceTokenizer(vocab)
    pengine = RetrievalEngine(pm, tok, device="cpu", encode_batch=4, query_batch=2)
    psvc = pserve.RetrievalService(pengine, pengine.build_index(iter(batches)),
                                   prerank.ItmRerankScorer(pm, tok, top=top, step=step))
    return jsvc, psvc


@pytest.mark.parametrize("name", ["blip2_cir_rerank", "blip2_cir_cat"])
def test_serve_rerank_answers_as_sprc_tpu(name, monkeypatch):
    """Three queries (tiles of 2, then a short one), top 4 reranked, k 5:
    the same names in the same order, stage 1's scores, the reference masked;
    the rerank prefix holds stage 1's top-4 candidates."""
    monkeypatch.setenv("SPRC_PALLAS_QF", "0")
    jm = jax_variant(name)
    params = jax_variant_params(jm, seed=5)
    pm = port_variant(name, state_dict_from_jax(params))
    jsvc, psvc = _services(name, jm, params, pm)
    assert psvc._cand_gather == (psvc.index.target_feat_rows if name == "blip2_cir_cat"
                                 else psvc.index.reference_embeds)
    want = jsvc.query(PAIRS, k=5, rerank=True)
    got = psvc.query(PAIRS, k=5, rerank=True)
    plain = psvc.query(PAIRS, k=5)
    for w, g, p, (ref, _) in zip(want, got, plain, PAIRS):
        assert [r["name"] for r in g] == [r["name"] for r in w]
        np.testing.assert_allclose([r["score"] for r in g], [r["score"] for r in w], atol=ATOL)
        assert ref not in [r["name"] for r in g]
        assert {r["name"] for r in g[:4]} == {r["name"] for r in p[:4]}
        stage1 = {r["name"]: r["score"] for r in p}
        assert all(stage1[r["name"]] == r["score"] for r in g if r["name"] in stage1)
    moved = [[r["name"] for r in g] != [r["name"] for r in p] for g, p in zip(got, plain)]
    # the ITM reranker reorders; CirCat's feature-space rerank fuses the query
    # again and takes the same max over the candidate's tokens as stage 1
    assert any(moved) if name == "blip2_cir_rerank" else not any(moved)


def test_serve_rerank_refusals_as_sprc_tpu(tmp_path, monkeypatch):
    """A gallery too small to rerank: ValueError from both services, and the
    same 400 from both servers; --rerank-top on a model without
    inference_rerank: the same SystemExit from both build_service."""
    monkeypatch.setenv("SPRC_PALLAS_QF", "0")
    jm = jax_variant("blip2_cir_rerank")
    params = jax_variant_params(jm, seed=5)
    pm = port_variant("blip2_cir_rerank", state_dict_from_jax(params))
    body = b'{"reference": "g1", "caption": "red", "rerank": true}'
    answers, errors = [], []
    for svc, mod in zip(_services("blip2_cir_rerank", jm, params, pm, top=7), (jserve, pserve)):
        with pytest.raises(ValueError) as err:
            svc.query([("g1", "red")], rerank=True)
        errors.append(str(err.value))
        server = mod.make_server(svc, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            answers.append(_post(server, body))
        finally:
            server.shutdown()
            thread.join(timeout=10)
            server.server_close()
    assert errors[0] == errors[1] == "gallery too small to rerank: 6 maskable candidates " \
                                     "< --rerank-top 7"
    assert answers[0] == answers[1] == (400, {"error": f"ValueError: {errors[0]}"})

    jflag = jax_model()
    jfp = jax_params(jflag)
    pflag = port_model(state_dict_from_jax(jfp))
    index = RetrievalEngine(pflag, device="cpu", encode_batch=4).build_index(
        iter([(["a", "b"], inputs(2, b=2)[0])]))
    index.save(str(tmp_path / "idx"))
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(TOKENS) + "\n")
    monkeypatch.setattr(jloader, "load_model", lambda *a, **kw: (jflag, jfp))
    monkeypatch.setattr(ploader, "load_model", lambda *a, **kw: pflag)
    argv = ["--index-path", str(tmp_path / "idx"), "--vocab-path", str(vocab), "--rerank-top", "5"]
    exits = []
    for mod, extra in ((jserve, []), (pserve, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as err:
            mod.build_service(mod.make_parser().parse_args(argv + extra))
        exits.append(str(err.value))
    assert exits[0] == exits[1] and "has no inference_rerank" in exits[1]
