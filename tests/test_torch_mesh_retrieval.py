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
- ``cli/serve.py``'s HTTP front end under the mesh answers the requests
  the service refuses (a list reference, a caption that is not a string, an
  unknown reference, ``"rerank": true`` without a rerank stage) with the
  unsharded server's 400 bodies, without the other rank seeing them, and a
  valid request after them as the unsharded server does.
- ``cli/validate_rerank.py --mesh`` prints the JSON of the run without it,
  and ``cli/submission.py --rerank --mesh`` writes the files of the run
  without it, byte for byte (CIRR and CIRCO; the checkpoints of
  ``test_torch_rerank_cli.py``).

One spawn runs every world-2 case (``dryrun.run_cases``).
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import sprc_tpu.cli.validate as jcli  # noqa: E402
from test_data import cirr_root  # noqa: E402,F401  (fixture)
from test_data import circo_root  # noqa: E402,F401  (fixture)
from test_torch_rerank_cli import RERANK_FLAGS, rerank_checkpoints  # noqa: E402,F401  (fixture)
from test_torch_submission import _circo_test_split  # noqa: E402
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


# F7: the requests the service refuses, then one it answers
BODIES = [b'{"reference": ["g0"], "caption": "red"}', b'{"reference": "g0", "caption": 5}',
          b'{"reference": "zz", "caption": "red"}',
          b'{"reference": "g0", "caption": "red", "rerank": true}',
          b'{"queries": [{"reference": "g1", "caption": "blue"}, '
          b'{"reference": "g4", "caption": "long red"}], "k": 3}']


def _rerank_argv(rerank_checkpoints, data, *extra):  # noqa: F811
    """The argv both rerank CLIs share (the EVA-style tiny models), ``extra``
    before the model overrides."""
    model_type, overrides = STYLES["eva"]
    return ["--data-path", str(data), "--model-path", rerank_checkpoints["eva"],
            "--rerank-model-path", rerank_checkpoints["rerank"]["eva"], "--model-type",
            model_type, "--vocab-path", rerank_checkpoints["vocab"], "--encode-batch", "4",
            "--query-batch", "2", "--workers", "2", "--no-bf16", *RERANK_FLAGS, *extra,
            "--model-overrides", *overrides]


def _submission_argv(rerank_checkpoints, cirr_root, circo_root, out):  # noqa: F811
    """dataset -> the submission CLI's argv (``--rerank``) writing under
    ``out / dataset``."""
    circo = _circo_test_split(circo_root)
    return {ds: _rerank_argv(rerank_checkpoints, root, "--dataset", ds, "--rerank",
                             "--submission-name", "tiny", "--output-dir", str(out / ds))
            for ds, root in (("CIRR", cirr_root), ("CIRCO", circo))}


@pytest.fixture(scope="module")
def ranks(data, rerank_checkpoints, cirr_root, circo_root, tmp_path_factory):  # noqa: F811
    d = data
    checkpoints = rerank_checkpoints
    index_path = str(tmp_path_factory.mktemp("mesh_retrieval") / "index")
    submissions = tmp_path_factory.mktemp("mesh_submission")
    three = (d["refs"][:3], d["captions"][:3], d["candidates"])
    mesh_flags = ["--mesh", "--device", "cpu"]
    cases = [("gallery_case", (d["spec"], d["images"], d["names"], d["refs"], d["captions"]),
              {"k": K, "save_path": index_path}),
             ("cli_case", ("sprc_tpu_torch.cli.validate",
                           _validate_argv(checkpoints, cirr_root) + mesh_flags), {}),
             ("service_case", (d["spec"], d["images"], d["names"], d["requests"]), {"k": K}),
             ("rerank_case", (RERANK, d["images"], d["names"], *three), {}),
             ("validation_case", (_validation_args(cirr_root), _checkpoint_spec(checkpoints),
                                  checkpoints["vocab"]), {}),
             ("http_case", (d["spec"], d["images"], d["names"], BODIES), {}),
             ("cli_case", ("sprc_tpu_torch.cli.validate_rerank", _rerank_argv(
                 checkpoints, cirr_root, "--dataset", "CIRR") + mesh_flags), {})]
    for argv in _submission_argv(checkpoints, cirr_root, circo_root, submissions).values():
        cases.append(("cli_case", ("sprc_tpu_torch.cli.submission", argv + mesh_flags), {}))
    return {"results": spawn(dryrun.run_cases, W, cases), "index_path": index_path,
            "submissions": submissions}


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


def test_refused_requests_never_reach_the_other_rank(ranks, data):
    """F7: each request the service refuses gets, under the mesh, the 400
    body the unsharded server gives; the valid request after them is
    answered as the unsharded server answers it, so rank 1 is still there."""
    d = data
    want = dryrun.http_case(None, d["spec"], d["images"], d["names"], BODIES)
    got, follower = (r[5] for r in ranks["results"])
    assert follower is None and len(got) == len(want) == len(BODIES)
    errors = [body["error"] for _, body in want[:-1]]
    assert [errors[i].split(":")[0] for i in (0, 1, 3)] == ["TypeError"] * 2 + ["ValueError"]
    assert "unknown reference image(s)" in errors[2]  # a KeyError's text, as the JAX server's
    assert got[:-1] == want[:-1] and all(status == 400 for status, _ in got[:-1])
    (status, body), (want_status, want_body) = got[-1], want[-1]
    assert status == want_status == 200 and len(body["results"]) == 2
    for g, w in zip(body["results"], want_body["results"]):
        assert [a["name"] for a in g] == [b["name"] for b in w]
        np.testing.assert_allclose([a["score"] for a in g], [b["score"] for b in w],
                                   rtol=0, atol=1e-6)


def test_validate_rerank_cli_mesh_prints_the_json_without_it(  # noqa: F811
        ranks, rerank_checkpoints, cirr_root, capsys):  # noqa: F811
    import sprc_tpu_torch.cli.validate_rerank as prcli

    prcli.main(_rerank_argv(rerank_checkpoints, cirr_root, "--dataset", "CIRR")
               + ["--device", "cpu"])
    want = capsys.readouterr().out
    assert list(json.loads(want))[0] == "group_recall_at1"
    assert [r[6] for r in ranks["results"]] == [want, ""]


def test_submission_cli_mesh_writes_the_files_without_it(ranks, rerank_checkpoints,  # noqa: F811
                                                         cirr_root, circo_root,  # noqa: F811
                                                         tmp_path, capsys):
    import sprc_tpu_torch.cli.submission as pscli

    argvs = _submission_argv(rerank_checkpoints, cirr_root, circo_root, tmp_path)
    for i, (dataset, argv) in enumerate(argvs.items()):
        pscli.main(argv + ["--device", "cpu"])
        printed = capsys.readouterr().out
        names = sorted(p.name for p in (tmp_path / dataset).iterdir())
        assert names == (["circo_submission_tiny.json"] if dataset == "CIRCO" else
                         ["recall_submission_tiny.json", "recall_subset_submission_tiny.json"])
        for name in names:
            assert ((ranks["submissions"] / dataset / name).read_bytes()
                    == (tmp_path / dataset / name).read_bytes()), (dataset, name)
        mesh_printed = [r[7 + i] for r in ranks["results"]]
        assert mesh_printed[1] == "" and mesh_printed[0] == printed.replace(
            str(tmp_path), str(ranks["submissions"]))
