"""Retrieval under ``--mesh`` at world 2 (gloo, on the CPU) against the
unsharded port and JAX's mesh engine.

- The gallery of ``n = 2 W + 1 = 5`` images sharded over two ranks (3 rows
  each, one of them padding): the sims and the top-3 equal the unsharded
  port's (within 1e-6; a rank fuses its own queries, in batches of another
  make-up) and JAX's ``RetrievalEngine(mesh=make_mesh(2))`` on the same
  JAX weights (within 1e-4, the fp32 bound of ``test_torch_validate.py``),
  whose index is padded to 6 rows; the reference rows fetched from the
  ranks are the unsharded rows; the index saved from the ranks (rank 0
  writes) loads in JAX and, sharded again, gives the same sims.
- ``cli/validate.py --mesh`` prints, on rank 0 alone, the JSON the command
  prints without it (the CIRR fixture of ``test_data.py``, the checkpoint
  of ``test_torch_validate.py``).
- ``RetrievalService.query`` under the mesh (rank 0 asks, rank 1 follows
  the broadcasts) answers as the unsharded service.
- A rerank tile of 3 queries with 3 candidates each, split over the ranks,
  equals the tile on one device.
- The fine-tune CLI's validation with ``--cache-features``' val cache (the
  second epoch runs no tower call) gives the live validation's metrics,
  JAX's ``_validate_with_engine_cirr(..., val_caches)``, and at world 2
  (each rank caching its shard) the same.

One spawn runs every world-2 case (``dryrun.run_cases``).
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import sprc_tpu.cli.validate as jcli  # noqa: E402
from test_data import cirr_root  # noqa: E402,F401  (fixture)
from test_torch_train_losses import jax_model, jax_params  # noqa: E402
from test_torch_validate import STYLES, checkpoints  # noqa: E402,F401  (fixture)

import sprc_tpu_torch.cli.validate as pcli  # noqa: E402
from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from sprc_tpu_torch.parallel import dryrun  # noqa: E402
from sprc_tpu_torch.parallel.mesh import spawn  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

W, N, K = 2, 5, 3
RERANK = {"name": "blip2_cir_rerank", "overrides": dryrun.tiny_overrides(), "seed": 6}


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(21)
    names = [f"g{i}" for i in range(N)]
    words = ["red", "dress", "long", "sleeves", "blue", "shirt"]
    captions = [" ".join(rng.choice(words, 3)) for _ in range(N)]
    refs = [names[j] for j in (4, 0, 3, 3, 1)]
    jm = jax_model()
    params = jax_params(jm)
    return {"names": names, "images": rng.rand(N, 28, 28, 3).astype(np.float32),
            "refs": refs, "captions": captions, "jax": (jm, params),
            "spec": {"name": "blip2_cir_align_prompt", "overrides": dryrun.tiny_overrides(),
                     "state": state_dict_from_jax(params, vit="eva_clip_g")},
            "requests": [[(refs[0], captions[0])], [(refs[1], captions[1]), (refs[2], "blue")]],
            "candidates": [[names[j] for j in row] for row in ((1, 2, 3), (0, 4, 2), (3, 1, 0))]}


def _validate_argv(checkpoints, cirr_root):  # noqa: F811
    model_type, overrides = STYLES["eva"]
    return ["--dataset", "CIRR", "--data-path", str(cirr_root), "--model-path",
            checkpoints["eva"], "--model-type", model_type, "--vocab-path",
            checkpoints["vocab"], "--encode-batch", "4", "--query-batch", "2", "--workers", "2",
            "--no-bf16", "--model-overrides", *overrides]


def _validation_args(cirr_root):  # noqa: F811
    return {"dataset": "CIRR", "data_path": str(cirr_root), "target_ratio": 1.25,
            "encode_batch": 4, "query_batch": 2, "workers": 2, "dress_types": ["dress"]}


def _checkpoint_spec(checkpoints):  # noqa: F811
    model_type, overrides = STYLES["eva"]
    return {"name": "blip2_cir_align_prompt", "model_type": model_type,
            "overrides": pcli.parse_model_overrides(overrides),
            "checkpoint": checkpoints["eva"]}


@pytest.fixture(scope="module")
def ranks(data, checkpoints, cirr_root, tmp_path_factory):  # noqa: F811
    d = data
    index_path = str(tmp_path_factory.mktemp("mesh_retrieval") / "index")
    three = (d["refs"][:3], d["captions"][:3], d["candidates"])
    cases = [("gallery_case", (d["spec"], d["images"], d["names"], d["refs"], d["captions"]),
              {"k": K, "save_path": index_path}),
             ("cli_case", ("sprc_tpu_torch.cli.validate",
                           _validate_argv(checkpoints, cirr_root) + ["--mesh", "--device", "cpu"]),
              {}),
             ("service_case", (d["spec"], d["images"], d["names"], d["requests"]), {"k": K}),
             ("rerank_case", (RERANK, d["images"], d["names"], *three), {}),
             ("validation_case", (_validation_args(cirr_root), _checkpoint_spec(checkpoints),
                                  checkpoints["vocab"]), {})]
    return {"results": spawn(dryrun.run_cases, W, cases), "index_path": index_path}


def test_sharded_gallery_equals_unsharded_and_jax_mesh_engine(ranks, data):
    from sprc_tpu.parallel.mesh import make_mesh
    from sprc_tpu.retrieval.engine import RetrievalEngine as JRetrievalEngine

    d = data
    one = dryrun.gallery_case(None, d["spec"], d["images"], d["names"], d["refs"],
                              d["captions"], k=K)
    jm, params = d["jax"]
    jengine = JRetrievalEngine(jm, params, dryrun.WordTokenizer(), mesh=make_mesh(W),
                               encode_batch=2, query_batch=3)
    batches = [(d["names"][s:s + 2], d["images"][s:s + 2]) for s in range(0, N, 2)]
    jindex = jengine.build_index(iter(batches))
    assert jindex.target_feats.shape[0] == 6  # padded to the mesh
    jsims = np.asarray(jengine.score_queries(jindex, d["refs"], d["captions"]))
    _, jidx = jengine.topk(jindex, jsims, K)
    assert np.ptp(jsims) > 100 * 1e-4
    for got in (r[0] for r in ranks["results"]):
        assert (got["n"], got["rows"], got["names"]) == (N, 3, d["names"])
        np.testing.assert_allclose(got["sims"], one["sims"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["top_idx"], one["top_idx"])
        np.testing.assert_allclose(got["sims"], jsims, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got["top_idx"], jidx)
        np.testing.assert_array_equal(got["refs"], one["refs"])
        np.testing.assert_array_equal(got["loaded_sims"], got["sims"])
    # the file rank 0 wrote is the unsharded index's, and JAX reads it
    loaded = jengine.load_index(ranks["index_path"])
    assert loaded.names == d["names"] and loaded.n == N


def test_validate_cli_mesh_prints_the_json_without_it(ranks, checkpoints, cirr_root,  # noqa: F811
                                                      capsys):
    pcli.main(_validate_argv(checkpoints, cirr_root) + ["--device", "cpu"])
    want = capsys.readouterr().out
    assert json.loads(want)
    assert [r[1] for r in ranks["results"]] == [want, ""]


def test_service_query_under_the_mesh_equals_the_unsharded_service(ranks, data):
    d = data
    want = dryrun.service_case(None, d["spec"], d["images"], d["names"], d["requests"], k=K)
    got, follower = (r[2] for r in ranks["results"])
    assert follower is None and len(got) == len(want) == 2
    for g_req, w_req in zip(got, want):
        for g, w in zip(g_req, w_req):
            assert [a["name"] for a in g] == [b["name"] for b in w]
            np.testing.assert_allclose([a["score"] for a in g], [b["score"] for b in w],
                                       rtol=0, atol=1e-6)


def test_rerank_tile_split_over_the_ranks_equals_one_device(ranks, data):
    d = data
    want = dryrun.rerank_case(None, RERANK, d["images"], d["names"], d["refs"][:3],
                              d["captions"][:3], d["candidates"])
    assert want.shape == (9,) and np.ptp(want) > 0
    for r in ranks["results"]:
        np.testing.assert_allclose(r[3], want, rtol=0, atol=1e-6)


def test_validation_cache_equals_live_validation_and_jax(ranks, checkpoints,  # noqa: F811
                                                         cirr_root):  # noqa: F811
    from sprc_tpu.cli.finetune import _validate_with_engine_cirr

    one = dryrun.validation_case(None, _validation_args(cirr_root), _checkpoint_spec(checkpoints),
                                 checkpoints["vocab"])
    assert one["tower_calls"][0] > 0 and one["tower_calls"][1] == 0  # epoch 2: no tower
    assert one["cached_rows"] == {"cirr_val": 6}
    assert one["cached"][0] == one["cached"][1] == one["live"]
    jargs = jcli.make_parser().parse_args(_validate_argv(checkpoints, cirr_root))
    jmodel, jengine = jcli.build_engine(jargs)
    caches = {}
    for _ in range(2):
        assert _validate_with_engine_cirr(jargs, jmodel, jengine, caches) == pytest.approx(
            one["cached"][0], abs=1e-9)
    for r in ranks["results"]:
        got = r[4]
        assert got["cached"] == one["cached"] and got["live"] == one["live"]
        assert got["tower_calls"][1] == 0 and sum(got["cached_rows"].values()) == 3
