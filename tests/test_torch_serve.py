"""The port's serving path (engine + RetrievalService + HTTP) against
sprc_tpu's on the same tiny model and weights (see test_torch_model.py),
on the CPU, over real sockets.

The two services must return the same top-k names with scores within 1e-4
(fp32 on both sides), mask the reference image, and read each other's
index files (bf16 frozen embeds stored as uint16 views).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.cli.serve import RetrievalService as JRetrievalService  # noqa: E402
from sprc_tpu.retrieval.engine import RetrievalEngine as JRetrievalEngine  # noqa: E402
from sprc_tpu.text.tokenizer import BertWordPieceTokenizer as JTokenizer  # noqa: E402

from sprc_tpu_torch.cli.serve import RetrievalService, build_service, make_parser, make_server  # noqa: E402
from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from sprc_tpu_torch.retrieval.engine import RetrievalEngine  # noqa: E402
from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer  # noqa: E402

from test_torch_model import IMG, jax_model, jax_params, port_model  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "red", "dress", "long"]
NAMES = [f"g{i}" for i in range(7)]  # odd size: the last encode batch pads
PAIRS = [(NAMES[0], "red dress"), (NAMES[3], "long"), (NAMES[5], "long red")]
K = 3


def _batches(images):
    return iter([(NAMES[s: s + 4], images[s: s + 4]) for s in range(0, 7, 4)])


@pytest.fixture(scope="module")
def services():
    jm = jax_model()
    params = jax_params(jm)
    images = np.random.RandomState(5).rand(7, IMG, IMG, 3).astype(np.float32)
    vocab = {t: i for i, t in enumerate(TOKENS)}
    jengine = JRetrievalEngine(jm, params, JTokenizer(vocab), encode_batch=4, query_batch=2,
                               frozen_host_dtype=jnp.bfloat16)
    jindex = jengine.build_index(_batches(images))
    pmodel = port_model(state_dict_from_jax(params))
    pengine = RetrievalEngine(pmodel, BertWordPieceTokenizer(vocab), device="cpu",
                              encode_batch=4, query_batch=2, frozen_host_dtype=torch.bfloat16)
    pindex = pengine.build_index(_batches(images))
    return (JRetrievalService(jengine, jindex), RetrievalService(pengine, pindex))


def test_same_topk_as_sprc_tpu(services):
    jsvc, psvc = services
    want, got = jsvc.query(PAIRS, k=K), psvc.query(PAIRS, k=K)
    for w, g, (ref, _) in zip(want, got, PAIRS):
        assert [r["name"] for r in g] == [r["name"] for r in w]
        np.testing.assert_allclose([r["score"] for r in g], [r["score"] for r in w], atol=1e-4)
        assert all(r["name"] != ref for r in g)  # reference masked
        scores = [r["score"] for r in g]
        assert scores == sorted(scores, reverse=True)
    with pytest.raises(KeyError):
        psvc.query([("nope", "red")], k=1)


def test_index_files_cross_load(services, tmp_path):
    jsvc, psvc = services
    jpath, ppath = str(tmp_path / "jax_index"), str(tmp_path / "port_index")
    jsvc.index.save(jpath)
    psvc.index.save(ppath)
    from_jax = psvc.engine.load_index(jpath)
    from_port = jsvc.engine.load_index(ppath)
    assert from_jax.names == NAMES and from_port.names == NAMES
    assert from_jax.frozen_embeds.dtype == torch.bfloat16
    np.testing.assert_array_equal(from_jax.frozen_embeds.float().numpy(),
                                  np.asarray(jsvc.index.frozen_embeds, np.float32))
    np.testing.assert_array_equal(np.asarray(from_port.frozen_embeds, np.float32),
                                  psvc.index.frozen_embeds.float().numpy())
    np.testing.assert_array_equal(np.asarray(from_port.target_feats)[: from_port.n],
                                  psvc.index.target_feats.numpy())
    # the port serves a JAX-built index with the JAX service's answers
    got = RetrievalService(psvc.engine, from_jax).query(PAIRS, k=K)
    want = jsvc.query(PAIRS, k=K)
    assert [[r["name"] for r in g] for g in got] == [[r["name"] for r in w] for w in want]


def test_http_server_end_to_end(services):
    _, psvc = services
    psvc.warm()
    server = make_server(psvc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(payload):
        req = urllib.request.Request(f"{base}/query", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        return json.loads(urllib.request.urlopen(req, timeout=60).read())

    try:
        health = json.loads(urllib.request.urlopen(f"{base}/health", timeout=60).read())
        assert health == {"status": "ok", "gallery": 7}
        out = post({"reference": NAMES[1], "caption": "red dress", "k": 2})
        assert len(out["results"]) == 1 and len(out["results"][0]) == 2
        out = post({"queries": [{"reference": r, "caption": c} for r, c in PAIRS], "k": K})
        assert out["results"] == psvc.query(PAIRS, k=K)
        with pytest.raises(urllib.error.HTTPError) as err:
            post({"reference": "missing", "caption": "x"})
        assert err.value.code == 400
        assert "unknown reference" in json.loads(err.value.read())["error"]
    finally:
        server.shutdown()
        thread.join(timeout=10)
        server.server_close()
    assert not thread.is_alive()


def test_cuda_device_without_gpu_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = make_parser().parse_args(["--index-path", str(tmp_path / "x"), "--device", "cuda"])
    with pytest.raises(SystemExit) as err:
        build_service(args)
    assert "no CUDA device" in str(err.value)
