"""The int8 serving slice as a whole against sprc_tpu, on the tiny model of
test_torch_model.py with bridged weights, on the CPU.

Both packages calibrate the tower's static activation scales on the same
images, build the model with the int8 tower (``vit_quant="int8_static"``) and
the int8 Q-Former (JAX: SPRC_QF_INT8=1; port: ``qformer_int8=True``), encode
the same 7-image gallery through their engines and score the same composed
queries. The JAX side runs its Pallas int8 kernels in interpret mode
(SPRC_PALLAS_BLOCK=force, SPRC_PALLAS_QF=force, set before the first trace).

Tolerance. A flipped int8 code (see test_torch_vit_int8.py) moves a feature
by about 1e-3. Readings on these seeds: scales equal to 2.7e-7 relative; target
features max-abs 1.5e-7 and scores 6e-8 (no code flipped). The bounds leave
room for a few flips: 2e-3 on the unit-norm features and on the scores; the
int8 model's scores differ from the fp32 model's by more than that (the
third test bounds that difference at 0.05).
"""

import dataclasses
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.cli.serve import RetrievalService as JRetrievalService  # noqa: E402
from sprc_tpu.models.vit import calibrate_act_scales as jcalibrate  # noqa: E402
from sprc_tpu.registry import registry as jregistry  # noqa: E402
from sprc_tpu.retrieval.engine import RetrievalEngine as JRetrievalEngine  # noqa: E402
from sprc_tpu.text.tokenizer import BertWordPieceTokenizer as JTokenizer  # noqa: E402

from sprc_tpu_torch import loader  # noqa: E402
from sprc_tpu_torch.cli.serve import (  # noqa: E402
    RetrievalService, build_service, make_parser, make_server)
from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from sprc_tpu_torch.ops import primitives  # noqa: E402
from sprc_tpu_torch.ops.fused_block import fused_vit_block_i8  # noqa: E402
from sprc_tpu_torch.retrieval.engine import RetrievalEngine  # noqa: E402
from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer  # noqa: E402

from test_torch_model import IMG, jax_model, jax_params, port_model  # noqa: E402
from test_torch_serve import K, PAIRS, TOKENS, _batches  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ATOL = 2e-3


def _jax_int8_model(base, scales, quant):
    vcfg = dataclasses.replace(base.cfg.vit_config_override, act_scales=scales)
    jcfg = dataclasses.replace(base.cfg, vit_quant=quant, vit_config_override=vcfg)
    return jregistry.get_model_class("blip2_cir_align_prompt")(jcfg)


@pytest.fixture(scope="module")
def slice_(tmp_path_factory):
    base = jax_model()
    params = jax_params(base)
    rng = np.random.RandomState(21)
    calib_images = rng.rand(4, IMG, IMG, 3).astype(np.float32)
    gallery = rng.rand(7, IMG, IMG, 3).astype(np.float32)
    vocab = {t: i for i, t in enumerate(TOKENS)}
    with pytest.MonkeyPatch.context() as mp:  # read when the JAX functions trace
        mp.setenv("SPRC_PALLAS_BLOCK", "force")
        mp.setenv("SPRC_PALLAS_QF", "force")
        mp.setenv("SPRC_QF_INT8", "1")
        jcal = _jax_int8_model(base, None, "int8_calib")
        jscales = jcalibrate(jcal, params, jnp.asarray(calib_images),
                             method=jcal.extract_target_features)
        jm = _jax_int8_model(base, jscales, "int8_static")
        jengine = JRetrievalEngine(jm, params, JTokenizer(vocab), encode_batch=4, query_batch=2,
                                   frozen_host_dtype=jnp.bfloat16)
        jindex = jengine.build_index(_batches(gallery))
        jsvc = JRetrievalService(jengine, jindex)
        want = jsvc.query(PAIRS, k=K)
        want_feats = np.asarray(jindex.target_feats)[: jindex.n]

    state = state_dict_from_jax(params)
    ckpt = str(tmp_path_factory.mktemp("int8") / "model.pt")
    torch.save(state, ckpt)
    tiny = {k: v for k, v in port_model(state).cfg.__dict__.items()
            if k not in ("vit_quant", "vit_act_scales", "qformer_int8")}
    pmodel = loader.load_model("blip2_cir_align_prompt", checkpoint_path=ckpt, device="cpu",
                               **tiny, vit_quant="int8_calib", qformer_int8=True)
    scales = loader.calibrate_vit_act_scales(pmodel, calib_images, batch=3)  # then int8_static
    pengine = RetrievalEngine(pmodel, BertWordPieceTokenizer(vocab), device="cpu",
                              encode_batch=4, query_batch=2, frozen_host_dtype=torch.bfloat16)
    pindex = pengine.build_index(_batches(gallery))
    return dict(jscales=jscales, scales=scales, want=want, want_feats=want_feats,
                service=RetrievalService(pengine, pindex), model=pmodel, ckpt=ckpt, tiny=tiny)


def test_calibrated_scales_equal(slice_):
    got, want = slice_["scales"], slice_["jscales"]
    assert [k for k, _ in got] == [k for k, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5)
    tower = slice_["model"].visual_encoder  # calibrated in place, now serving with the scales
    assert (tower.cfg.quant, tower.cfg.act_scales) == ("int8_static", got)
    assert all(b.cfg is tower.cfg for b in tower.transformer.resblocks)


def test_int8_index_and_scores_match_sprc_tpu(slice_):
    cfg = slice_["model"].cfg
    assert cfg.vit_config().quant == "int8_static" and cfg.qformer_config().int8
    feats = slice_["service"].index.target_feats.numpy()
    np.testing.assert_allclose(feats, slice_["want_feats"], atol=ATOL)
    got, want = slice_["service"].query(PAIRS, k=K), slice_["want"]
    same_top1 = 0
    for g, w, (ref, _) in zip(got, want, PAIRS):
        by_name = {r["name"]: r["score"] for r in w}
        for r in g:
            if r["name"] in by_name:
                assert abs(r["score"] - by_name[r["name"]]) <= ATOL
        assert all(r["name"] != ref for r in g)
        same_top1 += g[0]["name"] == w[0]["name"]
    assert same_top1 >= len(PAIRS) - 1


def test_int8_moves_the_scores_a_little(slice_):
    """The int8 model is not the fp32 model in disguise: the same weights
    without int8 give scores that differ, by less than 0.05."""
    fp = loader.load_model("blip2_cir_align_prompt", checkpoint_path=slice_["ckpt"],
                           device="cpu", **slice_["tiny"])
    svc = slice_["service"]
    engine = RetrievalEngine(fp, svc.engine.tokenizer, device="cpu", encode_batch=4,
                             query_batch=2, frozen_host_dtype=torch.bfloat16)
    refs, caps = [p[0] for p in PAIRS], [p[1] for p in PAIRS]
    d = np.abs(engine.score_queries(svc.index, refs, caps)
               - svc.engine.score_queries(svc.index, refs, caps))
    assert 0 < d.max() < 0.05, d.max()


def test_cpu_run_launches_no_kernel(slice_):
    """On CPU tensors every wrapper runs its plain version: the launch
    counters stay where they were."""
    before = (fused_vit_block_i8.launches, primitives.gemm_i8_cuda.launches)
    slice_["service"].query(PAIRS[:1], k=1)
    assert (fused_vit_block_i8.launches, primitives.gemm_i8_cuda.launches) == before


def test_server_with_qformer_int8_flag_answers(slice_, monkeypatch, tmp_path):
    index_path = str(tmp_path / "int8_index")
    slice_["service"].index.save(index_path)
    seen = {}

    real = loader.load_model

    def tiny_load_model(name, model_type, **kw):  # the CLI asks for the full-size model
        seen.update(kw)
        return real(name, model_type, **{**slice_["tiny"], "checkpoint_path": slice_["ckpt"],
                                         "device": kw["device"],
                                         "qformer_int8": kw["qformer_int8"]})

    monkeypatch.setattr(loader, "load_model", tiny_load_model)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(TOKENS) + "\n")
    args = make_parser().parse_args(["--index-path", index_path, "--device", "cpu",
                                     "--qformer-int8", "--query-batch", "2",
                                     "--vocab-path", str(vocab)])
    assert args.qformer_int8 and not make_parser().parse_args([]).qformer_int8
    service = build_service(args)
    assert seen["qformer_int8"] is True
    assert service.engine.model.cfg.qformer_config().int8
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/query",
            data=json.dumps({"queries": [{"reference": r, "caption": c} for r, c in PAIRS],
                             "k": K}).encode(), headers={"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=60).read())
    finally:
        server.shutdown()
        thread.join(timeout=10)
        server.server_close()
    assert not thread.is_alive()
    # the server's tower is fp (no flag for it, as in the JAX server) and only
    # scores queries: the int8 index and the int8 Q-Former give the engine's answers
    assert [[r["name"] for r in res] for res in out["results"]] == [
        [r["name"] for r in res] for res in slice_["service"].query(PAIRS, k=K)]
