"""The port's rerank models (blip2_cir_rerank, blip2_cir_cat), ``compute_itm``,
``ItmRerankScorer`` and ``rerank_rankings`` against sprc_tpu on shared
weights.

The tiny CLIP-style model of test_torch_model.py (ViT width 128 / depth 2 on
28 px images, so S = 5 image rows and a rerank memory of 10; Q-Former hidden
128 / 2 layers, Q = 4, text length 8, vocab 60) is initialised in JAX
through each variant's training forward, plus the modules only its eval
methods use, carried across by interop/jax_params.py and loaded with
strict=True. The rerank model's twin is drawn independently of the tower it
copies, so a method that reads the wrong one fails. The JAX side runs
unfused (``SPRC_PALLAS_QF=0``) and through the Pallas layer in interpret mode
(``SPRC_PALLAS_QF=force``), the port its plain path; fp32 throughout.
Tolerances: 1e-4 absolute on features, stage-1 scores, ITM logits and
rerank scores (test_torch_model's ATOL: fp32 sums in another order through
two Q-Former layers).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.models.cir_base import CirConfig as JCirConfig  # noqa: E402
from sprc_tpu.models.qformer import QFormerConfig as JQFormerConfig  # noqa: E402
from sprc_tpu.models.vit import ViTConfig as JViTConfig  # noqa: E402
from sprc_tpu.registry import registry as jregistry  # noqa: E402

from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from sprc_tpu_torch.loader import MODEL_CONFIGS, build_model, model_config  # noqa: E402
from sprc_tpu_torch.models.cir_variants import CirRerank  # noqa: E402
from sprc_tpu_torch.models.qformer import QFormerConfig  # noqa: E402
from sprc_tpu_torch.models.vit import ViTConfig  # noqa: E402
from sprc_tpu_torch.retrieval.rerank import ItmRerankScorer, rerank_rankings  # noqa: E402

from test_torch_model import EMBED, IMG, Q, TXT, VOCAB, inputs  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ATOL = 1e-4
FLAGS = ["0", "force"]


def jax_variant(name):
    vcfg = JViTConfig(image_size=IMG, patch_size=14, width=128, depth=2, num_heads=2,
                      mlp_hidden=256, layer_norm_eps=1e-5, use_ln_pre=True, quick_gelu=True,
                      patch_bias=False, dtype=jnp.float32)
    qcfg = JQFormerConfig(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=2,
                          intermediate_size=256, encoder_width=128, query_length=Q,
                          dropout_rate=0.0, attention_dropout_rate=0.0)
    cfg = JCirConfig(vit_model="clip_L", image_size=IMG, num_query_token=Q, max_txt_len=TXT,
                     vocab_size=VOCAB, embed_dim=EMBED, vit_dtype=jnp.float32,
                     vit_config_override=vcfg, qformer_config_override=qcfg)
    return jregistry.get_model_class(name)(cfg)


def jax_variant_params(model, seed=0):
    """The training forward's init (the twin and itm_head of CirRerank,
    CirCat's ITC modules), plus what only the eval side reads: the
    projections of stage 1 and the gallery (``fusion_feature``,
    ``target_features``) and ``itm_head`` (``compute_itm``); numpy leaves."""
    img = jnp.zeros((1, IMG, IMG, 3), jnp.float32)
    ids, ones = jnp.zeros((1, TXT), jnp.int32), jnp.ones((1, TXT), jnp.int32)
    emb = jnp.zeros((1, (IMG // 14) ** 2 + 1, 128))

    def eval_side(m, emb, ids, ones):
        return m.fusion_feature(emb, ids, ones), m.target_features(emb), m.compute_itm(
            emb, ids, ones)

    params = dict(jax.jit(lambda k: model.init(k, img, img, ids, ones))(
        jax.random.PRNGKey(seed))["params"])
    extra = jax.jit(lambda k: model.init(k, emb, ids, ones, method=eval_side))(
        jax.random.PRNGKey(seed + 1))["params"]
    for name in ("vision_proj", "text_proj", "itm_head"):
        params.setdefault(name, extra[name])
    return jax.tree_util.tree_map(np.asarray, params)


def port_variant(name, state, **overrides):
    vcfg = ViTConfig(image_size=IMG, patch_size=14, width=128, depth=2, num_heads=2,
                     mlp_hidden=256, layer_norm_eps=1e-5, use_ln_pre=True, quick_gelu=True,
                     patch_bias=False, dtype=torch.float32)
    qcfg = QFormerConfig(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=2,
                         intermediate_size=256, encoder_width=128, query_length=Q)
    model = build_model(name, "pretrain_vitL", image_size=IMG, num_query_token=Q,
                        max_txt_len=TXT, vocab_size=VOCAB, embed_dim=EMBED,
                        vit_dtype=torch.float32, vit_config_override=vcfg,
                        qformer_config_override=qcfg, device="cpu", **overrides)
    model.load_state_dict(state, strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def rerank():
    jm = jax_variant("blip2_cir_rerank")
    params = jax_variant_params(jm)
    return jm, params, port_variant("blip2_cir_rerank", state_dict_from_jax(params))


@pytest.fixture(scope="module")
def cat():
    jm = jax_variant("blip2_cir_cat")
    params = jax_variant_params(jm, seed=3)
    return jm, params, port_variant("blip2_cir_cat", state_dict_from_jax(params))


def _japply(model, params, method, flag, monkeypatch, *args):
    monkeypatch.setenv("SPRC_PALLAS_QF", flag)
    fn = jax.jit(lambda p, *a: model.apply({"params": p}, *a, method=method))
    return jax.tree_util.tree_map(np.asarray, fn(params, *args))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _pairs(seed, n_queries, top):
    """Reference rows [n, S, D], candidate rows [n * top, S, D], ids and mask."""
    rng = np.random.RandomState(seed)
    refs = rng.randn(n_queries, 5, 128).astype(np.float32)
    cands = rng.randn(n_queries * top, 5, 128).astype(np.float32)
    _, ids, mask = inputs(seed, b=n_queries)
    return refs, cands, ids, mask


@pytest.mark.parametrize("flag", FLAGS)
def test_rerank_model_encode_and_stage1_match_jax(rerank, flag, monkeypatch):
    """The gallery through the twin, the twin's text tower (``inference``)
    and the trainable tower's ``fusion_feature``, which the engine scores
    stage 1 with."""
    jm, params, pm = rerank
    images, ids, mask = inputs(1)
    want_feats, want_frozen = _japply(jm, params, jm.extract_target_features, flag, monkeypatch,
                                      images)
    want_inf = _japply(jm, params, jm.inference, flag, monkeypatch, want_frozen, want_feats, ids,
                       mask)
    want_fuse = _japply(jm, params, jm.fusion_feature, flag, monkeypatch, want_frozen, ids, mask)
    with torch.inference_mode():
        feats, frozen = pm.extract_target_features(torch.from_numpy(images))
        inf = pm.inference(*_t(want_frozen, want_feats, ids, mask))
        fuse = pm.fusion_feature(*_t(want_frozen, ids, mask))
    np.testing.assert_allclose(frozen.numpy(), want_frozen, atol=ATOL)
    np.testing.assert_allclose(feats.numpy(), want_feats, atol=ATOL)
    np.testing.assert_allclose(inf.numpy(), want_inf, atol=ATOL)
    np.testing.assert_allclose(fuse.numpy(), want_fuse, atol=ATOL)
    # the twin is its own weights: the trainable tower's gallery differs
    with torch.inference_mode():
        own = pm.target_features(frozen)
    assert (own - feats).abs().max().item() > 1e-2


@pytest.mark.parametrize("flag", FLAGS)
def test_inference_rerank_and_compute_itm_match_jax(rerank, flag, monkeypatch):
    """The 10-row memory [reference; candidate] with padded captions; and
    ``compute_itm``'s positive-class mean logit, which is not the rerank's
    softmax of the mean logits."""
    jm, params, pm = rerank
    refs, cands, ids, mask = _pairs(5, 3, 1)
    want = _japply(jm, params, jm.inference_rerank, flag, monkeypatch, refs, cands, ids, mask)
    want_itm = _japply(jm, params, jm.compute_itm, flag, monkeypatch, refs, ids, mask)
    with torch.inference_mode():
        got = pm.inference_rerank(*_t(refs, cands, ids, mask))
        itm = pm.compute_itm(*_t(refs, ids, mask))
    assert got.shape == (3,) and itm.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(itm.numpy(), want_itm, atol=ATOL)
    assert ((got > 0) & (got < 1)).all()
    assert np.abs(itm.numpy() - got.numpy()).max() > 1e-3


def test_cat_inference_rerank_matches_jax(cat, monkeypatch):
    """Feature space: the query fused again against its (repeated)
    reference, max over the candidate's target tokens (the JAX side on both
    of its Q-Former paths)."""
    jm, params, pm = cat
    refs, _, ids, mask = _pairs(6, 4, 1)
    feats = np.random.RandomState(7).randn(4, Q, EMBED).astype(np.float32)
    with torch.inference_mode():
        got = pm.inference_rerank(*_t(refs, feats, ids, mask))
    for flag in FLAGS:
        want = _japply(jm, params, jm.inference_rerank, flag, monkeypatch, refs, feats, ids, mask)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    with torch.inference_mode():
        frozen = pm.extract_target_features(torch.from_numpy(inputs(8)[0]), ref_only=True)
        only = pm.extract_target_features(torch.from_numpy(inputs(8)[0]), target_only=True)
        both = pm.extract_target_features(torch.from_numpy(inputs(8)[0]))
    assert torch.equal(frozen, both[1]) and torch.equal(only, both[0])


def test_itm_scorer_matches_jax_with_a_short_last_tile(rerank, monkeypatch):
    """Two tiles of step 2 x top 3 and a short last one of 1 query (the JAX
    scorer pads it to the compiled shape, the port runs it as it is); each
    query's reference and caption are repeated per candidate on the device."""
    from sprc_tpu.retrieval.rerank import ItmRerankScorer as JScorer

    from test_torch_serve import TOKENS
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer

    jm, params, pm = rerank
    tok = BertWordPieceTokenizer({t: i for i, t in enumerate(TOKENS)})
    monkeypatch.setenv("SPRC_PALLAS_QF", "0")
    jscorer = JScorer(jm, params, tok, top=3, step=2)
    scorer = ItmRerankScorer(pm, tok, top=3, step=2)
    refs, cands, _, _ = _pairs(9, 3, 3)
    caps = ["red dress", "long red", "a blue shirt with long sleeves"]
    for s in (slice(0, 2), slice(2, 3)):
        r, c = refs[s], cands[s.start * 3: s.stop * 3]
        want = jscorer(r, c, caps[s])
        got = scorer(torch.from_numpy(r), torch.from_numpy(c), caps[s])
        assert got.shape == (3 * (s.stop - s.start),) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL)
    with pytest.raises(ValueError, match="no inference_rerank"):
        ItmRerankScorer(torch.nn.Linear(2, 2), tok, top=3, step=2)


def test_rerank_rankings_equals_the_jax_function_ties_included():
    """The copy against the original on the same scores: a tail left as it
    was, ties in stage order (the stable sort of 1 - score), a short last
    tile, and a candidate gather of its own."""
    from sprc_tpu.retrieval.rerank import rerank_rankings as jrerank

    rng = np.random.RandomState(11)
    names = np.array([[f"g{j}" for j in rng.permutation(9)] for _ in range(7)])
    refs, caps = [f"r{i}" for i in range(7)], [f"c{i}" for i in range(7)]
    table = rng.randint(0, 3, size=(7, 9)).astype(np.float32) / 2.0  # many exact ties
    seen = []

    def score_fn(r, c, captions):
        i = int(captions[0][1:])
        rows = [table[i + j, :5] for j in range(len(captions))]
        seen.append((r.shape, c.shape, list(captions)))
        return np.concatenate(rows)

    def embed(ns):
        return np.zeros((len(ns), 2, 3), np.float32)

    def feats(ns):
        return np.ones((len(ns), 4), np.float32)

    for cand in (None, feats):
        want = jrerank(names, refs, caps, score_fn, embed, top=5, step=3, cand_to_embed=cand)
        got = rerank_rankings(names, refs, caps, score_fn, embed, top=5, step=3,
                              cand_to_embed=cand)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:, 5:], names[:, 5:])
    assert [s[2] for s in seen[:3]] == [caps[0:3], caps[3:6], caps[6:7]]
    assert seen[0][1] == (15, 2, 3) and seen[6][1] == (15, 4)  # each loop: jax, then port
    # a tie keeps stage order: row 0's equal scores stay in their order
    order = np.argsort(1.0 - table[0, :5], kind="stable")
    np.testing.assert_array_equal(got[0, :5], names[0, :5][order])


def test_variant_configs_and_sync_fformer_match_jax(rerank):
    """MODEL_CONFIGS' new rows equal what sprc_tpu.loader builds from the
    YAML; ``sync_fformer`` on the state dict equals the JAX one on the tree."""
    from sprc_tpu.loader import build_model as jbuild

    from test_torch_model import assert_config_equals_jax

    rows = sorted(key for key in MODEL_CONFIGS if key[0] in ("blip2_cir_cat", "blip2_cir_rerank"))
    assert rows == [(n, t) for n in ("blip2_cir_cat", "blip2_cir_rerank")
                    for t in ("pretrain", "pretrain_vitL")]
    for name, model_type in rows:
        assert_config_equals_jax(name, model_type)
        assert type(jbuild(name, model_type)).__name__ == type(
            build_model(name, model_type, device="meta")).__name__
        assert model_config(name, model_type) == model_config("blip2_cir_align_prompt",
                                                               model_type)
    jm, params, _ = rerank
    want = state_dict_from_jax(jm.sync_fformer(dict(params)))
    got = CirRerank.sync_fformer(state_dict_from_jax(params))
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    assert not torch.equal(state_dict_from_jax(params)["query_tokens_f"], got["query_tokens_f"])
