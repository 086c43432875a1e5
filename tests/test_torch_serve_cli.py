"""The port's serve CLI against ``sprc_tpu.cli.serve``: the HTTP handler's
answers to bad requests, the refusal of ``"rerank": true`` by a service
started without a rerank stage, the parser's
defaults, and a FashionIQ gallery built by ``build_service``.

The handler tests run both servers over one fake engine (scores from a
seeded table, no model), so that only the two handlers and services differ:
every request gets the same status and the same body from both. The
FashionIQ test builds both services from the synthetic FashionIQ tree of
``tests/test_data.py`` with the tiny model of ``test_torch_model.py`` in
place of the full-size one the CLI would load, and holds the served top-k
to the JAX service's (fp32 on both sides: names equal, scores within 1e-4).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import sprc_tpu.cli.serve as jserve  # noqa: E402
import sprc_tpu.loader as jloader  # noqa: E402
from test_data import fiq_root  # noqa: E402,F401  (fixture)

import sprc_tpu_torch.cli.serve as pserve  # noqa: E402
import sprc_tpu_torch.loader as ploader  # noqa: E402
from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402

from test_torch_model import jax_model, jax_params, port_model  # noqa: E402
from test_torch_serve import TOKENS  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

NAMES = [f"g{i}" for i in range(5)]


class _Index:
    names = NAMES
    n = len(NAMES)
    reference_embeds = target_feat_rows = None  # read by the JAX service's rerank only


class _Engine:
    """``score_queries`` from a seeded table (one row per reference name), or
    a ``RuntimeError`` as a failed device call would raise it."""

    model = object()

    def __init__(self, fail=False):
        self.fail = fail
        self.table = np.random.RandomState(3).rand(len(NAMES), len(NAMES)).astype(np.float32)

    def score_queries(self, index, refs, caps):
        if self.fail:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return np.stack([self.table[NAMES.index(r)] + len(c) for r, c in zip(refs, caps)])


def _post(server, body: bytes):
    """(status, parsed body) of one POST /query."""
    req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/query",
                                 data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _both(engine, bodies):
    """Each body posted to the JAX server and to the port's, over ``engine``."""
    out = {}
    for key, mod in (("jax", jserve), ("port", pserve)):
        server = mod.make_server(mod.RetrievalService(engine, _Index()), port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            out[key] = [_post(server, b) for b in bodies]
        finally:
            server.shutdown()
            thread.join(timeout=10)
            server.server_close()
    return out["jax"], out["port"]


BODIES = {
    "not an object": b"[]",
    "not json": b"{oops",
    "no caption": b'{"reference": "g1"}',
    "unknown reference": b'{"reference": "zz", "caption": "red"}',
    "k not a number": b'{"reference": "g1", "caption": "red", "k": "ten"}',
    "queries not a list": b'{"queries": 5}',
    "rerank": b'{"reference": "g1", "caption": "red", "rerank": true}',
    "one query": b'{"reference": "g1", "caption": "red", "k": 3}',
    "two queries": b'{"queries": [{"reference": "g0", "caption": "a"}, '
                   b'{"reference": "g4", "caption": "long"}], "k": 2}',
}


@pytest.mark.parametrize("case", sorted(BODIES))
def test_query_answers_as_the_jax_handler_does(case):
    (jstatus, jbody), (pstatus, pbody) = (r[0] for r in _both(_Engine(), [BODIES[case]]))
    assert pstatus == jstatus
    assert pbody == jbody
    if pstatus == 400:
        assert pbody["error"]
    else:
        assert pstatus == 200 and len(pbody["results"][0]) <= 3


def test_engine_error_is_a_400_with_a_body():
    (jr,), (pr,) = _both(_Engine(fail=True), [BODIES["one query"]])
    assert pr == jr
    assert pr == (400, {"error": "RuntimeError: CUDA error: an illegal memory access was "
                                 "encountered"})


def test_rerank_is_refused_by_the_service():
    """A direct caller is refused too, with the JAX service's message; the
    reference check comes first in both."""
    errors = []
    for mod in (jserve, pserve):
        svc = mod.RetrievalService(_Engine(), _Index())
        with pytest.raises(ValueError) as err:
            svc.query([("g1", "red")], k=2, rerank=True)
        errors.append(str(err.value))
        with pytest.raises(KeyError):
            svc.query([("zz", "red")], k=2, rerank=True)
    assert errors[0] == errors[1] and "--rerank-top" in errors[1]


# the flags both parsers have (--mesh among them; the port's --seed,
# --qformer-int8 and --device are its own)
SHARED = ["dataset", "data_path", "split", "index_path", "save_index", "model_name",
          "model_type", "model_path", "vocab_path", "target_ratio", "encode_batch",
          "query_batch", "workers", "rerank_top", "rerank_step", "dress_types", "bf16", "host",
          "port", "mesh"]


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_the_shared_flags_are_the_listed_ones():
    jax_only, port_only = set(_actions(jserve.make_parser())), set(_actions(pserve.make_parser()))
    assert sorted(jax_only & port_only) == sorted(SHARED)
    assert jax_only - port_only == set()


@pytest.mark.parametrize("dest", SHARED)
def test_shared_flag_defaults_equal(dest):
    ja, pa = _actions(jserve.make_parser())[dest], _actions(pserve.make_parser())[dest]
    assert pa.default == ja.default
    assert pa.choices == ja.choices and pa.nargs == ja.nargs and pa.type == ja.type
    assert pa.option_strings == ja.option_strings
    assert (getattr(pserve.make_parser().parse_args([]), dest)
            == getattr(jserve.make_parser().parse_args([]), dest))


def test_fashioniq_gallery_serves_as_sprc_tpu(fiq_root, tmp_path, monkeypatch):  # noqa: F811
    jm = jax_model()
    params = jax_params(jm)
    pm = port_model(state_dict_from_jax(params))
    seen = {}

    def jax_load(name, model_type, **kw):  # the CLI asks for the full-size model
        seen["jax"] = (name, model_type)
        return jm, params

    def port_load(name, model_type, **kw):
        seen["port"] = (name, model_type, str(kw["device"]))
        return pm

    monkeypatch.setattr(jloader, "load_model", jax_load)
    monkeypatch.setattr(ploader, "load_model", port_load)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(TOKENS) + "\n")
    argv = ["--dataset", "fashionIQ", "--data-path", str(fiq_root), "--dress-types", "dress",
            "--vocab-path", str(vocab), "--encode-batch", "3", "--query-batch", "2",
            "--workers", "1"]
    jsvc = jserve.build_service(jserve.make_parser().parse_args(argv))
    psvc = pserve.build_service(pserve.make_parser().parse_args(argv + ["--device", "cpu"]))
    assert seen == {"jax": ("blip2_cir_align_prompt", "pretrain"),
                    "port": ("blip2_cir_align_prompt", "pretrain", "cpu")}
    assert psvc.index.names == jsvc.index.names == [f"dress{i}" for i in range(4)]
    pairs = [("dress0", "red dress"), ("dress2", "long"), ("dress3", "long red")]
    want, got = jsvc.query(pairs, k=2), psvc.query(pairs, k=2)
    for w, g, (ref, _) in zip(want, got, pairs):
        assert [r["name"] for r in g] == [r["name"] for r in w]
        assert all(r["name"] != ref for r in g)
        np.testing.assert_allclose([r["score"] for r in g], [r["score"] for r in w], atol=1e-4)
    assert psvc.index.frozen_embeds.dtype == torch.bfloat16
