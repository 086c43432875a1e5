"""Retrieval engine: gallery index build + composed-query scoring
(counterpart of ``sprc_tpu/retrieval/engine.py``).

- **Index build**: gallery images are encoded in batches padded to
  ``encode_batch`` (``extract_target_features``: tower -> ln_vision ->
  queries-only Q-Former -> vision_proj -> L2); the target features
  ``[N, Q, E]`` stay on the device, the frozen ViT embeddings ``[N, S, D]``
  (reused as reference embeddings by the protocol, validate_blip.py:377)
  go to the host, optionally cast down (``frozen_host_dtype``).
  :meth:`RetrievalEngine.build_index` takes float32 pixels,
  :meth:`RetrievalEngine.build_index_raw` decoded uint8 images with their
  true sizes and runs ``device_preprocess`` before the tower. Both go
  through the JAX engine's pipeline: a producer thread iterates the
  caller's batches (``_prefetch_iter``), batches are submitted while the
  readbacks of the batch ``DEPTH`` before complete (``_pipelined_encode``).
  A batch larger than ``encode_batch`` is encoded as consecutive slices of
  ``encode_batch`` (``_slices``), so either build gives the JAX engine's
  index for any batch size.
- **The feed on CUDA**: uploads go from a ring of ``DEPTH + 1`` pinned
  staging buffers (allocated once per shape and kept by the engine) over a
  side stream, with an event per slot that the compute stream waits on and
  one that the host waits on before refilling the slot; the frozen embeds
  come back over a second stream into one pinned buffer that doubles when
  full (no pinned allocation per batch, no host ``torch.cat`` of the
  gallery: the index's ``frozen_embeds`` is a view of that buffer). The
  host seconds of each stage of the last build are in
  :attr:`RetrievalEngine.feed_seconds`. On the CPU a batch is padded, encoded
  and kept, and the parts are concatenated at the end.
- **Scoring**: per query batch, the two-pass fusion gives the composed
  feature, then token-max similarity (kernel K1 on CUDA) against the whole
  gallery gives ``[B, N]``; query batches pad to ``query_batch`` with zero
  references, zero ids and an all-ones mask (never a fully masked row).
- **Index files**: :meth:`GalleryIndex.save` writes the JAX package's npz
  format (bf16 arrays as uint16 views, a JSON ``meta``), so either package
  reads what the other wrote.

- **Cached tower rows**: :meth:`RetrievalEngine.build_index_from_tower`
  takes ``encode_tower`` rows (the fine-tune CLI's validation cache) and
  runs only ``ln_vision``, the queries-only Q-Former pass and the
  projection (``encode_image`` takes a rank-3 input as tower rows, JAX's
  rank dispatch).
- **The mesh** (``mesh``, ``parallel/mesh.py``; JAX's ``mesh=``): each rank
  encodes its contiguous shard of the gallery (the caller streams that
  shard: ``cli/validate.py::index_batches``) and pads its target feats to
  ``ceil(n / W)`` rows as JAX's ``_assemble_index`` pads the gallery to the
  mesh; the index holds every name, its rank's rows and their offset, and
  no rank holds another's frozen rows. ``score_queries`` fuses each query on
  the rank that holds its reference's rows (in ``query_batch`` batches,
  zero-padded), gathers the composed features in query order, scores every
  query against each shard with K1 and gathers the ``[B, ceil(n / W)]``
  rows, cut to ``n``: the unsharded ``[B, n]`` matrix on every rank, so the
  stable ``topk`` and padding (never ranked) are as before.
  ``GalleryIndex.reference_embeds`` / ``target_feat_rows`` fetch rows from
  the ranks that hold them (every rank passes the same names);
  ``GalleryIndex.save`` streams every shard into rank 0's file and
  ``load_index`` maps the file and keeps the rank's shard. Every rank calls
  every method with the same arguments.

Everything runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import json
import time
import zipfile
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as torch_dist

from sprc_tpu_torch.ops.sim_kernels import token_max_sim
from sprc_tpu_torch.parallel import mesh as mesh_lib

# host seconds of one build, by stage (RetrievalEngine.feed_seconds): waiting
# for the producer thread, staging and enqueueing uploads, enqueueing the
# model, pinned allocations (the upload ring; the frozen buffer's growth,
# with its copy), enqueueing and waiting for downloads, the index's assembly
FEED_STAGES = ("producer", "h2d", "model", "pinned_alloc", "d2h", "assembly")
DEPTH = 2  # batches in flight in the encode pipeline (the JAX engine's)


def _prefetch_iter(iterable, depth: int = 2):
    """Producer-thread prefetch: the caller's batch preparation (decode,
    pad) overlaps the device's compute. The queue holds ``depth`` items and
    keeps their order; an exception in the producer is raised in the
    consumer; a consumer that stops early (an error downstream) stops the
    producer, which never blocks on a full queue for good."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def worker():
        try:
            for item in iterable:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # raised again in the consumer
            err.append(e)
        finally:
            while True:
                try:
                    q.put(end, timeout=0.1)
                    break
                except queue.Full:
                    if stop.is_set():
                        return

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            yield item
        t.join()
        if err:
            raise err[0]
    finally:
        stop.set()


def _slices(batches, size: int):
    """``(names, arrays)`` batches with every batch larger than ``size`` cut
    into consecutive slices of ``size`` (the last one shorter), in order: the
    JAX engine encodes such a batch whole, at a shape of its own; here it
    goes through the same ring and padding as any other."""
    for names, arrays in batches:
        b = arrays[0].shape[0]
        if b <= size:
            yield names, arrays
            continue
        for s in range(0, b, size):
            yield names[s: s + size], tuple(a[s: s + size] for a in arrays)


class _Slot:
    """One entry of the upload ring: pinned host buffers, their device
    twins, ``uploaded`` (recorded on the upload stream after the copies;
    the compute stream waits on it, and the host before refilling the
    pinned buffers) and ``consumed`` (recorded on the compute stream after
    the batch's encode is enqueued; the next upload into the device buffers
    waits on it)."""

    def __init__(self, specs, device):
        self.host = [torch.empty(shape, dtype=dtype, pin_memory=True) for shape, dtype in specs]
        self.dev = [torch.empty(shape, dtype=dtype, device=device) for shape, dtype in specs]
        self.uploaded = torch.cuda.Event()
        self.consumed = torch.cuda.Event()


class _PinnedRows:
    """The frozen embeds' host rows on CUDA: one pinned buffer, grown by
    doubling its bytes when a batch does not fit (a power of two, as the
    pinned allocator rounds), each batch copied in over the download
    stream. A growth waits for the downloads in flight and copies the rows
    so far into the new buffer."""

    def __init__(self, stream, stages, first_rows: int):
        self.stream, self.stages, self.first_rows = stream, stages, first_rows
        self.buf: Optional[torch.Tensor] = None
        self.n = 0

    def _grow(self, rows: int, like: torch.Tensor) -> None:
        t0 = time.perf_counter()
        row_bytes = like[0].numel() * like.element_size()
        nbytes = 1 << (max(rows, 2 * (0 if self.buf is None else len(self.buf))) * row_bytes
                       - 1).bit_length()
        buf = torch.empty((nbytes // row_bytes,) + like.shape[1:], dtype=like.dtype,
                          pin_memory=True)
        if self.buf is not None:
            self.stream.synchronize()
            buf[: self.n].copy_(self.buf[: self.n])
        self.buf = buf
        self.stages["pinned_alloc"] += time.perf_counter() - t0

    def append(self, frozen: torch.Tensor) -> torch.cuda.Event:
        """Enqueue the download of ``frozen`` (on the device, computed on the
        current stream) into the next rows; returns its completion event."""
        end = self.n + frozen.shape[0]
        if self.buf is None or end > len(self.buf):
            self._grow(max(end, self.first_rows), frozen)
        self.stream.wait_stream(torch.cuda.current_stream(frozen.device))
        done = torch.cuda.Event()
        with torch.cuda.stream(self.stream):
            self.buf[self.n: end].copy_(frozen, non_blocking=True)
            done.record(self.stream)
        self.n = end
        return done

    def rows(self) -> torch.Tensor:
        return self.buf[: self.n]


def _as_tensor(a) -> torch.Tensor:
    """A host batch (numpy array or CPU tensor) as a contiguous CPU tensor."""
    return a.contiguous() if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))


def _pack(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _unpack(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


@dataclasses.dataclass
class GalleryIndex:
    names: List[str]  # every name of the gallery
    target_feats: torch.Tensor  # [N, Q, E] fp32 on the engine's device (a mesh: the shard's)
    frozen_embeds: torch.Tensor  # [N, S, D] on the host (a mesh: the shard's rows)
    n: int  # the gallery's size
    mesh: Any = None
    offset: int = 0  # the global row of this rank's first row

    @property
    def rows(self) -> int:
        """This rank's real rows (the index's, without a mesh)."""
        return self.frozen_embeds.shape[0]

    @functools.cached_property
    def _pos(self) -> dict:
        return {name: i for i, name in enumerate(self.names)}

    def positions(self, names: Sequence[str]) -> List[int]:
        """Global rows of ``names`` (KeyError on a name not in the gallery)."""
        return [self._pos[n] for n in names]

    def reference_embeds(self, names: Sequence[str]) -> torch.Tensor:
        """Frozen embeds of reference images by name (the reference's
        name_to_feat dict, validate_blip.py:377); under a mesh fetched from
        the ranks that hold them (on the mesh's device)."""
        rows = self.positions(names)
        if self.mesh is None:
            return self.frozen_embeds[rows]
        return mesh_lib.gather_owned_rows(self.frozen_embeds, self.offset, rows, self.mesh,
                                          device=self.mesh.device)

    def target_feat_rows(self, names: Sequence[str]) -> torch.Tensor:
        """Projected target feats [n, Q, E] fp32 by name, on the engine's
        device: the candidates of a feature-space reranker (``RERANK_INPUT ==
        "feats"``, blip2_cir_cat)."""
        rows = self.positions(names)
        if self.mesh is None:
            idx = torch.as_tensor(rows, device=self.target_feats.device)
            return self.target_feats[idx].float()
        return mesh_lib.gather_owned_rows(self.target_feats[: self.rows], self.offset, rows,
                                          self.mesh).float()

    def save(self, path: str) -> None:
        """Persist to <path>.npz in the format both packages read (under a
        mesh every rank calls it and rank 0 writes every shard's rows)."""
        if self.mesh is not None:
            return _save_sharded(self, path)
        feats, feats_dtype = _pack(self.target_feats[: self.n])
        frozen, frozen_dtype = _pack(self.frozen_embeds)
        meta = {"names": self.names, "n": self.n, "feats_dtype": feats_dtype,
                "frozen_dtype": frozen_dtype}
        np.savez(path, target_feats=feats, frozen_embeds=frozen,
                 meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))


SAVE_CHUNK_ROWS = 256  # rows a message when a shard streams to rank 0


def _save_sharded(index: GalleryIndex, path: str) -> None:
    """:meth:`GalleryIndex.save` over a mesh: rank 0 writes the ``.npz``
    member by member (``np.savez``'s layout: stored, one ``.npy`` each) and
    every shard's rows reach it in order, ``SAVE_CHUNK_ROWS`` at a time, so
    no rank holds the whole gallery."""
    mesh = index.mesh
    counts = mesh_lib.all_gather_object(index.rows, mesh)
    parts = {"target_feats": index.target_feats[: index.rows], "frozen_embeds": index.frozen_embeds}
    dtypes = {k: _pack(v[:0])[1] for k, v in parts.items()}
    zf = None
    if mesh.is_main:
        path = path if path.endswith(".npz") else path + ".npz"
        zf = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True)
    try:
        for key, local in parts.items():
            member = None
            if zf is not None:
                member = zf.open(key + ".npy", "w", force_zip64=True)
                sample = _pack(local[:0])[0]
                np.lib.format.write_array_header_2_0(member, {
                    "descr": np.lib.format.dtype_to_descr(sample.dtype), "fortran_order": False,
                    "shape": (index.n,) + tuple(local.shape[1:])})
            for src, count in enumerate(counts):
                for s in range(0, count, SAVE_CHUNK_ROWS):
                    rows = min(SAVE_CHUNK_ROWS, count - s)
                    if src == mesh.rank:
                        chunk = local[s: s + rows]
                        if src != 0:
                            torch_dist.send(chunk.to(mesh.device).contiguous(), dst=0)
                    elif mesh.is_main:
                        chunk = torch.empty((rows,) + tuple(local.shape[1:]), dtype=local.dtype,
                                            device=mesh.device)
                        torch_dist.recv(chunk, src=src)
                    if member is not None:
                        member.write(_pack(chunk)[0].tobytes())
            if member is not None:
                member.close()
        if zf is not None:
            meta = {"names": index.names, "n": index.n, "feats_dtype": dtypes["target_feats"],
                    "frozen_dtype": dtypes["frozen_embeds"]}
            with zf.open("meta.npy", "w", force_zip64=True) as member:
                np.lib.format.write_array(member, np.frombuffer(json.dumps(meta).encode(),
                                                                dtype=np.uint8))
    finally:
        if zf is not None:
            zf.close()
    torch_dist.barrier()


class RetrievalEngine:
    def __init__(self, model, tokenizer=None, *, device, encode_batch: int = 64,
                 query_batch: int = 32, frozen_host_dtype: Optional[torch.dtype] = None,
                 mesh=None):
        self.model = model
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.mesh = mesh
        if mesh is not None and self.device != mesh.device:
            raise ValueError(f"device {self.device} is not the mesh's {mesh.device}")
        self.encode_batch = encode_batch
        self.query_batch = query_batch
        self.frozen_host_dtype = frozen_host_dtype
        self.feed_seconds = dict.fromkeys(FEED_STAGES, 0.0)
        self._rings: dict = {}  # (shape, dtype) of a batch's arrays -> its upload ring
        self._h2d = self._d2h = None  # the upload and download streams, made on first use
        self._preprocess: dict = {}  # (target_ratio, decode_size) -> device_preprocess

    # ------------------------------------------------------------- index build

    def build_index(self, batches: Iterable[Tuple[Sequence[str], np.ndarray]]) -> GalleryIndex:
        """batches yield (names, images [b, H, W, 3] float32, targetpadded);
        a short batch is padded to ``encode_batch`` with zero images."""
        return self._assemble_index(*self._pipelined_encode(
            ((names, (images,)) for names, images in batches), ((torch.float32, 0),),
            self.model.extract_target_features))

    def build_index_from_tower(self, batches: Iterable[Tuple[Sequence[str], Any]]
                               ) -> GalleryIndex:
        """batches yield (names, ``encode_tower`` rows [b, S, D], a tensor or
        array in the tower's dtype): the index the pixels would give, with
        only ``ln_vision``, the queries-only Q-Former pass and the projection
        run (``encode_image`` dispatches on the input's rank)."""
        it = iter(batches)
        first = next(it, None)
        spec = ((torch.float32, 0),) if first is None else ((torch.as_tensor(first[1]).dtype, 0),)
        stream = itertools.chain(() if first is None else (first,), it)
        return self._assemble_index(*self._pipelined_encode(
            ((names, (rows,)) for names, rows in stream), spec,
            self.model.extract_target_features))

    def build_index_raw(
        self,
        batches: Iterable[Tuple[Sequence[str], np.ndarray, np.ndarray]],
        *,
        decode_size: int = 256,
        target_ratio: float = 1.25,
    ) -> GalleryIndex:
        """Index build over RAW uint8 batches: ``(names, images_u8 [b, H, W,
        3], sizes [b, 2])``, images decoded but not resized (a uniform
        buffer, the true (h, w) in ``sizes``). The targetpad, bicubic and
        normalize preprocess (``device_preprocess``) runs on the device
        before the tower, so the host only decodes, and the upload is a
        quarter of float32 pixels' bytes. A short batch is padded with zero
        images of size (1, 1). ``decode_size`` keys the cached preprocess,
        as in the JAX engine."""
        from sprc_tpu_torch.data.transforms import device_preprocess

        key = (float(target_ratio), int(decode_size))
        pre = self._preprocess.get(key)
        if pre is None:
            pre = self._preprocess[key] = device_preprocess(
                dim=self.model.cfg.image_size, target_ratio=target_ratio)
        return self._assemble_index(*self._pipelined_encode(
            ((names, (raw, sizes)) for names, raw, sizes in batches),
            ((torch.uint8, 0), (torch.int32, 1)),
            lambda raw, sizes: self.model.extract_target_features(pre(raw, sizes))))

    def _upload(self, arrays, specs, b: int):
        """CUDA: stage one batch in the next slot of its ring (padding it to
        ``encode_batch`` there) and copy it over the upload stream; returns
        the slot, whose device buffers the compute stream may read."""
        clock = time.perf_counter
        key = tuple((a.shape[1:], dtype) for a, (dtype, _) in zip(arrays, specs))
        ring = self._rings.get(key)
        if ring is None:
            t0 = clock()
            ring = self._rings[key] = collections.deque(
                _Slot([((self.encode_batch,) + shape, dtype) for shape, dtype in key],
                      self.device) for _ in range(DEPTH + 1))
            self.feed_seconds["pinned_alloc"] += clock() - t0
        slot = ring[0]
        ring.rotate(-1)
        slot.uploaded.synchronize()  # its last copy out of the pinned buffers is done
        for host, a, (_, fill) in zip(slot.host, arrays, specs):
            host[:b].copy_(_as_tensor(a))
            if b < self.encode_batch:
                host[b:].fill_(fill)
        self._h2d.wait_event(slot.consumed)
        with torch.cuda.stream(self._h2d):
            for dev, host in zip(slot.dev, slot.host):
                dev.copy_(host, non_blocking=True)
            slot.uploaded.record(self._h2d)
        torch.cuda.current_stream(self.device).wait_event(slot.uploaded)
        return slot

    def _pipelined_encode(self, batches, specs, encode):
        """The JAX engine's pipeline: a producer thread iterates ``batches``
        (``(names, arrays)``), each batch is padded to ``encode_batch``
        (``specs``: each array's dtype and pad value), uploaded and encoded,
        and the readback of the batch ``DEPTH`` before is completed while it
        computes. Returns (names, device target feats per batch, host frozen
        embeds [N, S, D])."""
        cuda = self.device.type == "cuda"
        clock = time.perf_counter
        stages = self.feed_seconds = dict.fromkeys(FEED_STAGES, 0.0)
        if cuda and self._h2d is None:
            self._h2d, self._d2h = torch.cuda.Stream(self.device), torch.cuda.Stream(self.device)
        # the first pinned buffer holds 8 batches (512 images at the default encode_batch)
        pinned = _PinnedRows(self._d2h, stages, 8 * self.encode_batch) if cuda else None
        names: List[str] = []
        feats_parts: List[torch.Tensor] = []
        frozen_parts: List[torch.Tensor] = []
        inflight: collections.deque = collections.deque()

        def submit(batch):
            batch_names, arrays = batch
            b = arrays[0].shape[0]
            t0 = clock()
            if cuda:
                slot = self._upload(arrays, specs, b)
                tensors = slot.dev
            else:
                tensors = []
                for a, (dtype, fill) in zip(arrays, specs):
                    t = _as_tensor(a)
                    if b < self.encode_batch:
                        pad = torch.full((self.encode_batch - b,) + tuple(t.shape[1:]), fill,
                                         dtype=t.dtype)
                        t = torch.cat([t, pad])
                    tensors.append(t.to(dtype))
            t1 = clock()
            feats, frozen = encode(*tensors)
            if self.frozen_host_dtype is not None:
                frozen = frozen.to(self.frozen_host_dtype)
            t2 = clock()
            stages["h2d"] += t1 - t0
            stages["model"] += t2 - t1
            if not cuda:
                return batch_names, feats[:b], frozen[:b], None
            slot.consumed.record(torch.cuda.current_stream(self.device))
            done = pinned.append(frozen[:b])
            stages["d2h"] += clock() - t2
            return batch_names, feats[:b], frozen, done

        def drain():
            t0 = clock()
            batch_names, feats, frozen, done = inflight.popleft()
            if done is None:
                frozen_parts.append(frozen)
            else:
                done.synchronize()  # its rows are on the host; its device tensor may go
            feats_parts.append(feats)
            names.extend(batch_names)
            stages["d2h"] += clock() - t0

        it = _prefetch_iter(_slices(batches, self.encode_batch), depth=DEPTH)
        try:  # on an error here, close() stops the producer thread at once
            with torch.inference_mode():
                while True:
                    t0 = clock()
                    batch = next(it, None)
                    stages["producer"] += clock() - t0
                    if batch is None:
                        break
                    inflight.append(submit(batch))
                    if len(inflight) > DEPTH:
                        drain()
                while inflight:
                    drain()
        finally:
            it.close()
        if not names:
            if self.mesh is None:
                raise ValueError("the gallery is empty: no batch to encode")
            return names, feats_parts, None  # a shard with no rows: shaped by the others
        return names, feats_parts, pinned.rows() if cuda else torch.cat(frozen_parts)

    def _assemble_index(self, names, feats_parts, frozen) -> GalleryIndex:
        """The index over the device's target feats (concatenated on the
        device) and the host's frozen embeds; under a mesh over this rank's
        shard, padded to ``ceil(n / W)`` rows."""
        t0 = time.perf_counter()
        if self.mesh is not None:
            return self._assemble_shard(names, feats_parts, frozen, t0)
        feats = torch.cat([f.to(self.device, torch.float32) for f in feats_parts]).contiguous()
        index = GalleryIndex(names=list(names), target_feats=feats, frozen_embeds=frozen,
                             n=len(names))
        self.feed_seconds["assembly"] += time.perf_counter() - t0
        return index

    def _assemble_shard(self, names, feats_parts, frozen, t0) -> GalleryIndex:
        mesh = self.mesh
        shapes = None
        if frozen is not None:
            shapes = (tuple(frozen.shape[1:]), frozen.dtype,
                      tuple(feats_parts[0].shape[1:]))
        everyone = mesh_lib.all_gather_object((list(names), shapes), mesh)
        all_names = [name for part, _ in everyone for name in part]
        n = len(all_names)
        if not n:
            raise ValueError("the gallery is empty: no batch to encode")
        per = -(-n // mesh.world)
        for rank, (part, _) in enumerate(everyone):
            want = len(range(min(n, rank * per), min(n, (rank + 1) * per)))
            if len(part) != want:
                raise ValueError(f"rank {rank} encoded {len(part)} images; its contiguous "
                                 f"shard of {n} holds {want} (stream mesh.shard(n))")
        frozen_shape, frozen_dtype, feats_shape = next(s for _, s in everyone if s is not None)
        if frozen is None:
            frozen = torch.empty((0,) + frozen_shape, dtype=frozen_dtype)
        feats = torch.zeros((per,) + feats_shape, dtype=torch.float32, device=self.device)
        start = 0
        for f in feats_parts:
            feats[start: start + f.shape[0]] = f.to(self.device, torch.float32)
            start += f.shape[0]
        index = GalleryIndex(names=all_names, target_feats=feats, frozen_embeds=frozen, n=n,
                             mesh=mesh, offset=min(n, mesh.rank * per))
        self.feed_seconds["assembly"] += time.perf_counter() - t0
        return index

    def load_index(self, path: str) -> GalleryIndex:
        """Reload a :meth:`GalleryIndex.save` file (from either package);
        under a mesh each rank maps the file and keeps its shard."""
        from sprc_tpu_torch.train.feature_cache import npz_memmap

        path = path if path.endswith(".npz") else path + ".npz"
        npz = np.load(path)
        meta = json.loads(bytes(npz["meta"].tobytes()).decode())
        if self.mesh is None:
            feats = _unpack(npz["target_feats"], meta["feats_dtype"])
            frozen = _unpack(npz["frozen_embeds"], meta["frozen_dtype"])
        else:
            part = self.mesh.shard(meta["n"])
            feats, frozen = (_unpack(np.array(npz_memmap(path, key)[part.start: part.stop]),
                                     meta[dt])
                             for key, dt in (("target_feats", "feats_dtype"),
                                             ("frozen_embeds", "frozen_dtype")))
            if len(feats) != len(part) or len(frozen) != len(part):
                raise ValueError(f"{path}: index holds fewer rows than meta's {meta['n']}")
            return self._assemble_index(meta["names"][part.start: part.stop],
                                        [feats] if len(feats) else [], frozen if len(frozen)
                                        else None)
        if feats.shape[0] != meta["n"] or frozen.shape[0] != meta["n"]:
            raise ValueError(f"{path}: index holds {feats.shape[0]} rows, meta says {meta['n']}")
        return self._assemble_index(meta["names"], [feats], frozen)

    # --------------------------------------------------------------- scoring

    def _sims(self, index: GalleryIndex, feats: torch.Tensor) -> torch.Tensor:
        """Composed features [B, E] against the gallery: [B, n] on the
        device (under a mesh each shard's rows gathered and cut to n)."""
        sims = token_max_sim(feats.float().contiguous(), index.target_feats)
        if index.mesh is not None:
            parts = [torch.empty_like(sims) for _ in range(index.mesh.world)]
            torch_dist.all_gather(parts, sims.contiguous())
            sims = torch.cat(parts, dim=1)
        return sims[:, : index.n]

    def score_batch(self, index: GalleryIndex, reference_embeds: torch.Tensor,
                    input_ids: np.ndarray, text_mask: np.ndarray) -> np.ndarray:
        """One query batch -> [B, N] sims (host numpy); under a mesh every
        rank passes the same batch."""
        with torch.inference_mode():
            ref = reference_embeds.to(self.device)
            ids = torch.as_tensor(input_ids, device=self.device)
            mask = torch.as_tensor(text_mask, device=self.device)
            feats = self.model.fusion_feature(ref, ids, mask)
            return self._sims(index, feats).cpu().numpy()

    def _padded(self, refs: torch.Tensor, captions: Sequence[str]):
        """A query batch padded to ``query_batch``: zero references, zero ids
        and an all-ones mask (never a fully masked row)."""
        max_txt_len, qb = self.model.cfg.max_txt_len, self.query_batch
        tok = self.tokenizer(list(captions), max_length=max_txt_len)
        ids, mask = tok["input_ids"], tok["attention_mask"]
        b = len(captions)
        if b < qb:
            pad = qb - b
            refs = torch.cat([refs, refs.new_zeros((pad,) + refs.shape[1:])])
            ids = np.concatenate([ids, np.zeros((pad, max_txt_len), np.int32)])
            mask = np.concatenate([mask, np.ones((pad, max_txt_len), np.int32)])
        return refs, ids, mask

    def score_queries(self, index: GalleryIndex, reference_names: Sequence[str],
                      captions: Sequence[str]) -> np.ndarray:
        """Full query set -> [num_queries, N] sims. Tokenizes on the host."""
        if self.tokenizer is None:
            raise ValueError("score_queries needs a tokenizer")
        if index.mesh is not None:
            return self._score_sharded(index, reference_names, captions)
        out: List[np.ndarray] = []
        qb = self.query_batch
        for i in range(0, len(captions), qb):
            chunk_caps = list(captions[i: i + qb])
            refs = index.reference_embeds(reference_names[i: i + qb])
            refs, ids, mask = self._padded(refs, chunk_caps)
            out.append(self.score_batch(index, refs, ids, mask)[: len(chunk_caps)])
        return np.concatenate(out, axis=0)

    def _score_sharded(self, index: GalleryIndex, reference_names: Sequence[str],
                       captions: Sequence[str]) -> np.ndarray:
        """:meth:`score_queries` over a mesh: each query fused on the rank
        that holds its reference's frozen rows (in ``query_batch`` batches
        of those queries, zero-padded as unsharded), the composed features
        gathered in query order, and every ``query_batch`` of them scored
        against each shard (K1) and gathered (:meth:`_sims`)."""
        mesh, qb = index.mesh, self.query_batch
        rows = np.asarray(index.positions(reference_names), dtype=np.int64)
        per = index.target_feats.shape[0]
        owner = rows // per
        mine = np.flatnonzero(owner == mesh.rank)
        counts = np.bincount(owner, minlength=mesh.world)
        E = self.model.cfg.embed_dim
        with torch.inference_mode():
            local = torch.zeros((max(1, int(counts.max())), E), device=self.device)
            for s in range(0, len(mine), qb):
                q = mine[s: s + qb]
                refs = index.frozen_embeds[torch.as_tensor(rows[q] - index.offset)]
                refs, ids, mask = self._padded(refs, [captions[j] for j in q])
                feats = self.model.fusion_feature(
                    refs.to(self.device), torch.as_tensor(ids, device=self.device),
                    torch.as_tensor(mask, device=self.device))
                local[s: s + len(q)] = feats[: len(q)].float()
            parts = [torch.empty_like(local) for _ in range(mesh.world)]
            torch_dist.all_gather(parts, local)
            feats = torch.empty((len(rows), E), device=self.device)
            for rank, part in enumerate(parts):
                feats[torch.as_tensor(np.flatnonzero(owner == rank), device=self.device)] = \
                    part[: counts[rank]]
            out: List[np.ndarray] = []
            for i in range(0, len(rows), qb):
                chunk = feats[i: i + qb]
                b = chunk.shape[0]
                if b < qb:  # K1 at the unsharded batch's shape
                    chunk = torch.cat([chunk, chunk.new_zeros((qb - b, E))])
                out.append(self._sims(index, chunk)[:b].cpu().numpy())
        return np.concatenate(out, axis=0)

    # ----------------------------------------------------------------- top-K

    def topk(self, index: GalleryIndex, sims: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-K of [B, >=n] sims; ties keep gallery order (stable sort)."""
        vals, idx = torch.sort(sims[:, : index.n], dim=-1, descending=True, stable=True)
        return vals[:, :k].cpu().numpy(), idx[:, :k].cpu().numpy()
