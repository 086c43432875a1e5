"""Serving CLI: composed-query retrieval over a persistent gallery index
(counterpart of ``sprc_tpu/cli/serve.py``).

Build or load a :class:`GalleryIndex` once, then answer composed queries
(reference image name + relative caption -> top-K gallery names) over a
small stdlib HTTP endpoint.

Usage:
  # build the index from a dataset split (CIRR, or fashionIQ with
  # --dress-types), persist it, and serve on the GPU
  python -m sprc_tpu_torch.cli.serve --dataset CIRR --data-path /data/cirr_dataset \\
      --model-path sprc_cirr.pt --save-index cirr_val_index --device cuda --port 8000

  # later processes skip the encode pass entirely
  python -m sprc_tpu_torch.cli.serve --index-path cirr_val_index --device cuda ...

  # the ITM second stage over the top 50 stage-1 candidates, 15 queries a tile
  python -m sprc_tpu_torch.cli.serve --index-path idx --model-name blip2_cir_rerank \
      --model-path rerank.pt --rerank-top 50 --rerank-step 15 --device cuda

API:
  GET  /health  -> {"status": "ok", "gallery": N}
  POST /query   -> body {"reference": name, "caption": str, "k": 10}
                   or {"queries": [{reference, caption}...], "k": 10}
                   -> {"results": [[{"name", "score"}...] per query]}
                   optional "rerank": true runs the ITM second stage over the
                   top --rerank-top candidates (a rerank-capable model:
                   blip2_cir_rerank or blip2_cir_cat; the two-stage flow of
                   cirr_test_submission.py:87-112); the scores returned stay
                   stage 1's. A request that cannot be answered (malformed
                   body, unknown reference, "rerank" without --rerank-top, a
                   gallery too small to rerank, an error inside the engine)
                   gets a 400 with {"error": "<Type>: <message>"}, as in the
                   JAX server.

``--qformer-int8`` runs the Q-Former's dense projections in int8 (the JAX
server's ``SPRC_QF_INT8=1``). The tower's int8 mode has no flag, as in the
JAX server: an int8 index is built through the engine
(``load_model(..., vit_quant="int8_static", vit_act_scales=...)``) and
served with ``--index-path``.

The flags the two CLIs share have the JAX CLI's defaults (``--model-type
pretrain``: EVA ViT-g). Without ``--model-path`` the weights are random,
drawn from ``--seed``. ``--device cuda`` with no GPU exits nonzero; nothing
moves to the CPU quietly. Device work is serialized behind a lock; the query
path (and, with ``--rerank-top``, the rerank path) is warmed at startup so
that first-request latency is execution only. ``--rerank-top`` with a model
that has no ``inference_rerank`` (the flagship ``blip2_cir_align_prompt``)
exits at start.

``--mesh`` (``parallel/mesh.py``; ``torchrun``'s group, or one process per
visible CUDA device started here) shards the index over the ranks
(``retrieval/engine.py``: each rank encodes or loads its shard, and
``--save-index`` writes the whole index from rank 0). The HTTP front end
runs on rank 0; each request is checked there on the host
(:meth:`RetrievalService._check`: a request the service refuses gets its 400
and never leaves rank 0), then reaches the other ranks by a broadcast
(:meth:`RetrievalService.query`, :meth:`RetrievalService.follow`), every
rank scores it against its shard, and the JSON is unchanged.
"""

from __future__ import annotations

import argparse
import collections
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


class RetrievalService:
    """Engine + index + the query path shared by HTTP and tests."""

    def __init__(self, engine, index, rerank_scorer=None):
        self.engine = engine
        self.index = index
        self.rerank_scorer = rerank_scorer
        self.mesh = getattr(engine, "mesh", None)
        self._lock = threading.Lock()
        self._order = threading.Lock()  # under a mesh: one request at a time, in one order
        self._name_count = collections.Counter(index.names)
        # the rerank stage's candidates, by the model's tag: an ITM reranker
        # reads their frozen embeds again, a feature-space one (blip2_cir_cat)
        # their target feats
        if getattr(engine.model, "RERANK_INPUT", "frozen") == "feats":
            self._cand_gather = index.target_feat_rows
        else:
            self._cand_gather = index.reference_embeds

    def warm(self) -> None:
        name = self.index.names[0]
        self.query([(name, "warm up")], k=1)
        if self.rerank_scorer is not None:
            self.query([(name, "warm up")], k=1, rerank=True)

    def query(self, pairs, k: int = 10, rerank: bool = False):
        """The answer to one request (:meth:`_query`), checked first on the
        host (:meth:`_check`). Under a mesh rank 0 calls it, so a request the
        service refuses never reaches the other ranks; one it takes reaches
        them in :meth:`follow`."""
        self._check(pairs, rerank)
        if self.mesh is None:
            return self._query(pairs, k, rerank)
        from sprc_tpu_torch.parallel.dist import broadcast_from_main

        with self._order:
            broadcast_from_main(("query", [tuple(p) for p in pairs], k, rerank))
            return self._query(pairs, k, rerank)

    def follow(self) -> None:
        """A rank other than 0: answer (and drop) every request rank 0
        broadcasts, until it sends the stop. Rank 0 broadcasts only requests
        that passed :meth:`_check`, so a failure here comes after a
        collective: a fault, which ends the rank (and the mesh with it)."""
        from sprc_tpu_torch.parallel.dist import broadcast_from_main

        while True:
            message = broadcast_from_main(None)
            if message[0] == "stop":
                return
            self._query(*message[1:])

    def stop(self) -> None:
        """Rank 0: end the other ranks' :meth:`follow`."""
        if self.mesh is not None:
            from sprc_tpu_torch.parallel.dist import broadcast_from_main

            with self._order:
                broadcast_from_main(("stop",))

    def _check(self, pairs, rerank: bool = False) -> None:
        """Everything :meth:`_query` refuses, decided on the host before any
        device work or collective: a reference not in the index (a ``KeyError``;
        one that cannot be looked up, a list, raises the lookup's
        ``TypeError``), ``rerank`` without a scorer (``ValueError``), a
        caption that is not a string (``TypeError``), no query
        (``ValueError``), and a rerank over a gallery with fewer maskable
        candidates than ``top`` (``ValueError``), in that order."""
        refs = [p[0] for p in pairs]
        missing = [r for r in refs if r not in self._name_count]
        if missing:
            raise KeyError(f"unknown reference image(s): {missing[:5]}")
        if rerank and self.rerank_scorer is None:
            raise ValueError(
                "rerank requested but the service was started without "
                "--rerank-top (or the model has no inference_rerank)")
        bad = [type(p[1]).__name__ for p in pairs if not isinstance(p[1], str)]
        if bad:
            raise TypeError(f"a caption must be a string, not {bad[0]}")
        if not pairs:
            raise ValueError("a request needs at least one query")
        if rerank:
            # a query's candidates: the gallery without its reference
            n, top = len(self.index.names), self.rerank_scorer.top
            m = min(n - self._name_count[r] for r in refs)
            if m < top:
                raise ValueError(f"gallery too small to rerank: {m} maskable candidates "
                                 f"< --rerank-top {top}")

    def _query(self, pairs, k: int = 10, rerank: bool = False):
        """pairs: [(reference_name, caption)] -> per query top-k
        [{'name', 'score'}] (exact ranking, stable on ties, the reference
        image masked out of its own results as in validate_blip.py:258-261).

        With ``rerank=True`` the top ``rerank_scorer.top`` stage-1 candidates
        are scored again by the model's ``inference_rerank`` and that prefix
        reordered (the two-stage flow of cirr_test_submission.py:87-112); the
        scores returned stay stage 1's. The request has passed
        :meth:`_check`."""
        refs = [p[0] for p in pairs]
        caps = [p[1] for p in pairs]
        with self._lock:
            sims = self.engine.score_queries(self.index, refs, caps)
        names = np.asarray(self.index.names)
        orders = []
        for row, ref in zip(sims, refs):
            order = np.argsort(-row, kind="stable")
            orders.append([j for j in order if names[j] != ref])
        if rerank:
            from sprc_tpu_torch.retrieval.rerank import rerank_rankings

            top = self.rerank_scorer.top
            m = min(len(o) for o in orders)
            with self._lock:
                sorted_names = rerank_rankings(
                    names[np.asarray([o[:m] for o in orders])], refs, caps,
                    self.rerank_scorer, self.index.reference_embeds, top=top,
                    step=self.rerank_scorer.step, cand_to_embed=self._cand_gather)
            pos = {str(n): j for j, n in enumerate(names)}
            orders = [[pos[str(n)] for n in row] for row in sorted_names]
        return [[{"name": str(names[j]), "score": float(row[j])} for j in order[:k]]
                for row, order in zip(sims, orders)]


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        service = self.server.service
        if self.path == "/health":
            self._send(200, {"status": "ok", "gallery": service.index.n})
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        service = self.server.service
        if self.path != "/query":
            self._send(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length) or b"{}")
            k = int(req.get("k", 10))
            if "queries" in req:
                pairs = [(q["reference"], q["caption"]) for q in req["queries"]]
            else:
                pairs = [(req["reference"], req["caption"])]
            results = service.query(pairs, k=k, rerank=bool(req.get("rerank", False)))
            self._send(200, {"results": results})
        except KeyError as e:
            self._send(400, {"error": str(e)})
        except Exception as e:  # any other failure -> 400, never a dropped connection
            self._send(400, {"error": f"{type(e).__name__}: {e}"})


def make_server(service: RetrievalService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), _Handler)
    server.service = service
    return server


def build_service(args) -> RetrievalService:
    import torch

    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.retrieval.engine import RetrievalEngine
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.utils.artifacts import ensure_bert_vocab

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    mesh = None
    if getattr(args, "mesh", False):
        from sprc_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(device=device)
        device = mesh.device
    model = load_model(
        args.model_name, args.model_type, checkpoint_path=args.model_path, device=device,
        seed=args.seed, vit_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        qformer_int8=args.qformer_int8,
    )
    tokenizer = BertWordPieceTokenizer.from_vocab_file(ensure_bert_vocab(args.vocab_path))
    engine = RetrievalEngine(
        model, tokenizer, device=device, encode_batch=args.encode_batch,
        query_batch=args.query_batch, frozen_host_dtype=torch.bfloat16, mesh=mesh,
    )
    scorer = None
    if args.rerank_top > 0:
        if not hasattr(model, "inference_rerank"):
            raise SystemExit(f"--rerank-top needs a rerank-capable model; {args.model_name} "
                             "has no inference_rerank")
        from sprc_tpu_torch.retrieval.rerank import ItmRerankScorer

        scorer = ItmRerankScorer(model, tokenizer, top=args.rerank_top, step=args.rerank_step,
                                 mesh=mesh)
    if args.index_path:
        return RetrievalService(engine, engine.load_index(args.index_path), rerank_scorer=scorer)
    from sprc_tpu_torch.cli.validate import index_batches
    from sprc_tpu_torch.data.datasets import CIRRDataset, FashionIQDataset
    from sprc_tpu_torch.data.transforms import targetpad_transform

    tfm = targetpad_transform(args.target_ratio, model.cfg.image_size)
    if args.dataset == "CIRR":
        classic = CIRRDataset(args.data_path, args.split, "classic", tfm)
    else:
        classic = FashionIQDataset(args.data_path, args.split, args.dress_types, "classic", tfm)
    index = engine.build_index(index_batches(classic, args.encode_batch, args.workers,
                                             mesh=mesh))
    if args.save_index:
        index.save(args.save_index)
        if mesh is None or mesh.is_main:
            print(f"index saved to {args.save_index}.npz ({index.n} images)")
    return RetrievalService(engine, index, rerank_scorer=scorer)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", choices=["CIRR", "fashionIQ"], default="CIRR")
    p.add_argument("--data-path", default=None)
    p.add_argument("--split", default="val")
    p.add_argument("--index-path", default=None,
                   help="load a persisted index instead of encoding")
    p.add_argument("--save-index", default=None,
                   help="persist the freshly built index here")
    p.add_argument("--model-name", default="blip2_cir_align_prompt")
    p.add_argument("--model-type", default="pretrain")
    p.add_argument("--model-path", default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights when --model-path is not given")
    p.add_argument("--vocab-path", default=None)
    p.add_argument("--target-ratio", type=float, default=1.25)
    p.add_argument("--encode-batch", type=int, default=64)
    p.add_argument("--query-batch", type=int, default=32)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--rerank-top", type=int, default=0,
                   help="enable the ITM second stage over this many stage-1 candidates per "
                        "query (0 = off); needs a model with inference_rerank "
                        "(blip2_cir_rerank, blip2_cir_cat)")
    p.add_argument("--rerank-step", type=int, default=15,
                   help="queries per rerank tile (the CIRR eval tile)")
    p.add_argument("--dress-types", nargs="+", default=["dress", "shirt", "toptee"])
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--qformer-int8", action="store_true",
                   help="int8 dense projections in the Q-Former (query fusion and encode)")
    p.add_argument("--mesh", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    return p


def main(argv: Optional[list] = None) -> None:
    from sprc_tpu_torch.cli.validate import join_mesh

    args = make_parser().parse_args(argv)
    if not args.index_path and not args.data_path:
        raise SystemExit("need --data-path (build index) or --index-path (load)")
    if not join_mesh(args, "sprc_tpu_torch.cli.serve", argv):
        build_service(args).follow()  # a rank other than 0
        return
    service = build_service(args)
    service.warm()
    server = make_server(service, args.host, args.port)
    print(f"serving {service.index.n}-image gallery on "
          f"http://{server.server_address[0]}:{server.server_address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        service.stop()


if __name__ == "__main__":
    main()
