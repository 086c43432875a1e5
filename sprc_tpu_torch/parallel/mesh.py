"""The process group and its collectives (counterpart of
``sprc_tpu/parallel/mesh.py``).

The JAX package's mesh is a 1-D ``data`` axis over the devices: a batch or
gallery sharded over it, the state replicated, and the SPMD partitioner
inserting the gradient all-reduce and computing the contrastive matrix over
the global batch. Here that axis is the ranks of a ``torch.distributed``
group, one process per device (the kernel library launches on the current
device's stream, ``ops/primitives.py``), and each collective is written out:

- :func:`make_mesh` joins the group the launcher describes (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as
  ``torchrun`` sets them), or takes the one already joined; NCCL on
  ``cuda``, gloo on ``cpu``, never gloo for CUDA tensors;
- :func:`data_sharding` / :func:`shard_batch`: each rank's rows of a global
  batch; :func:`replicate`: the parameters and buffers of rank 0 on every
  rank; :func:`pad_to_multiple` as in JAX;
- :func:`all_gather_with_grad` (LAVIS' ``GatherLayer``, base_model.py:
  199-217): the forward gathers, the backward all-reduces the gathered
  gradient and returns the rank's own slice, in the memory layout autograd
  handed it (the layout picks the products that read it next: a contiguous
  copy there moved a step over one rank off the step without a mesh by
  last-bit differences); :func:`concat_all_gather` without a gradient;
- :func:`active` makes a mesh the one the models' in-batch losses see
  (:func:`gather_batch`, :func:`batch_offset`): outside it they see the
  local batch, as at world 1;
- :func:`launch_or_join` starts one process per visible CUDA device for a
  CLI's ``--mesh`` where no launcher did, and :func:`spawn` runs a function
  on W ranks (the dry run, the tests). Either fails when one rank fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as torch_dist

Tensor = torch.Tensor

LAUNCH_ENV = ("RANK", "WORLD_SIZE")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the group: its rank, the world size and its
    device (``cuda:<local rank>`` over NCCL, ``cpu`` over gloo); the group is
    the default one, which every collective here uses."""

    rank: int
    world: int
    device: torch.device

    @property
    def group(self):
        return torch_dist.group.WORLD

    @property
    def backend(self) -> str:
        return torch_dist.get_backend(self.group)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def shard(self, n: int) -> range:
        """This rank's contiguous part of ``n`` items (``host_shard``)."""
        per = -(-n // self.world)
        return range(min(n, self.rank * per), min(n, (self.rank + 1) * per))


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh over the process group: joined from the launcher's
    environment, or the group this process already joined. ``n_devices``,
    where given, must be the world size. A CUDA mesh needs NCCL and a CPU
    mesh gloo; a group of the other backend is refused."""
    device = torch.device(device)
    backend = backend_for(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--mesh on {device}: no CUDA device is available")
    if not torch_dist.is_initialized():
        missing = [k for k in LAUNCH_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"no process group and no launcher environment ({missing} "
                               "unset): start under torchrun, or through a CLI's --mesh, "
                               "which starts one process per CUDA device")
        kw = {}
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
            torch.cuda.set_device(local)
            kw["device_id"] = torch.device("cuda", local)
        torch_dist.init_process_group(backend, init_method="env://",
                                      rank=int(os.environ["RANK"]),
                                      world_size=int(os.environ["WORLD_SIZE"]), **kw)
    elif torch_dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {torch_dist.get_backend()}; a {device.type} "
                           f"mesh needs {backend}")
    world = torch_dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the group has {world} ranks")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(rank=torch_dist.get_rank(), world=world, device=device)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def data_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n``; a batch the world does
    not divide is refused (JAX's sharding refuses it at the step)."""
    if n % mesh.world:
        raise ValueError(f"a batch of {n} does not divide over {mesh.world} ranks")
    b = n // mesh.world
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """Each leading axis (tensor, array or list) cut to this rank's rows."""
    out = {}
    for key, value in batch.items():
        out[key] = value[data_sharding(mesh, len(value))]
    return out


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (in place)."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            buf = t.detach().to(mesh.device)
            torch_dist.broadcast(buf, src=0)
            if buf is not t:
                t.copy_(buf)
    return module


# ------------------------------------------------------------ collectives


class _AllGatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, world: int, rank: int) -> Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world)]
        torch_dist.all_gather(parts, x)
        ctx.rank, ctx.rows = rank, x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad: Tensor):
        out = grad.clone()  # the layout autograd handed over (the next products read it)
        summed = out.contiguous()
        torch_dist.all_reduce(summed)
        if summed is not out:
            out.copy_(summed)
        return out[ctx.rank * ctx.rows: (ctx.rank + 1) * ctx.rows], None, None


def all_gather_with_grad(x: Tensor, mesh: Mesh) -> Tensor:
    """Every rank's ``x`` [b, ...] -> [W b, ...] in rank order; the gradient
    of the result is summed over the ranks and this rank's rows returned."""
    return _AllGatherWithGrad.apply(x, mesh.world, mesh.rank)


def concat_all_gather(x: Tensor, mesh: Mesh) -> Tensor:
    """:func:`all_gather_with_grad` without a gradient."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    torch_dist.all_gather(parts, x)
    return torch.cat(parts)


def all_reduce_mean_(tensors: Sequence[Tensor], mesh: Mesh) -> None:
    """Each tensor replaced, in place, by its mean over the ranks: one
    all-reduce of one flat buffer."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    torch_dist.all_reduce(flat)
    flat.div_(mesh.world)
    start = 0
    for t in tensors:
        t.copy_(flat[start: start + t.numel()].view_as(t))
        start += t.numel()


def all_gather_object(obj, mesh: Mesh) -> List[Any]:
    out = [None] * mesh.world
    torch_dist.all_gather_object(out, obj)
    return out


def gather_owned_rows(local: Tensor, offset: int, rows: Sequence[int], mesh: Mesh,
                      device=None) -> Tensor:
    """Rows of a tensor sharded by contiguous rows over the ranks (this
    rank holds global rows ``offset .. offset + len(local)``): every rank
    passes the same global ``rows`` and gets them all, in that order, on
    ``device`` (default ``local``'s). Each row comes from the rank that
    holds it: an all-reduce of buffers that hold only their owners' rows."""
    idx = torch.as_tensor(list(rows), dtype=torch.long)
    mine = (idx >= offset) & (idx < offset + local.shape[0])
    buf = torch.zeros((len(idx),) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=mesh.device)
    if bool(mine.any()):
        buf[mine.to(mesh.device)] = local[(idx[mine] - offset).to(local.device)].to(mesh.device)
    torch_dist.all_reduce(buf)
    return buf.to(device if device is not None else local.device)


# ------------------------------------------------- the models' view of it

_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def active(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """The in-batch losses inside see ``mesh``'s global batch (None: the
    local batch)."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = before


def current() -> Optional[Mesh]:
    return _ACTIVE


def gather_batch(x: Tensor, grad: bool = True) -> Tensor:
    """The global batch's rows of ``x`` under the active mesh (with its
    gradient unless ``grad`` is off), else ``x``."""
    if _ACTIVE is None:
        return x
    return all_gather_with_grad(x, _ACTIVE) if grad else concat_all_gather(x, _ACTIVE)


def batch_offset(b: int) -> int:
    """Where this rank's ``b`` rows start in the global batch."""
    return 0 if _ACTIVE is None else _ACTIVE.rank * b


# ---------------------------------------------------------------- launch


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def joined() -> bool:
    """This process is a rank: a launcher's environment, or a group joined."""
    return torch_dist.is_initialized() or all(k in os.environ for k in LAUNCH_ENV)


def _wait_all(procs: Sequence, poll: Callable, kill: Callable) -> int:
    """Wait for every process; at the first that fails, end the others and
    return its code (0 when all succeed)."""
    try:
        while True:
            codes = [poll(p) for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.1)
    finally:
        for p in procs:
            if poll(p) is None:
                kill(p)


def launch_or_join(module: str, argv: Sequence[str], device) -> None:
    """A CLI's ``--mesh``: in a rank, return (:func:`make_mesh` joins);
    else start ``python -m module argv`` once per visible CUDA device with
    the launcher's environment and exit with the first failing code (0 when
    every rank succeeds). A CPU mesh needs a launcher (``torchrun``)."""
    if joined():
        return
    if torch.device(device).type != "cuda":
        raise SystemExit("--mesh on the CPU: start the ranks with torchrun "
                         "(torchrun --nproc-per-node N -m ... --mesh --device cpu)")
    if not torch.cuda.is_available():
        raise SystemExit(f"--mesh on {device}: no CUDA device is available")
    world, port = torch.cuda.device_count(), free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-m", module, *argv], env=env))
    raise SystemExit(_wait_all(procs, lambda p: p.poll(), lambda p: p.kill()))


def _spawned(fn, rank: int, world: int, device: str, tmp: str, args) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank)
    kw = {"device_id": torch.device("cuda", rank)} if torch.device(device).type == "cuda" else {}
    torch_dist.init_process_group(backend_for(device), init_method=f"file://{tmp}/store",
                                  rank=rank, world_size=world, **kw)
    try:
        mesh = make_mesh(world, device)
        out = fn(mesh, *args)
        torch.save(out, os.path.join(tmp, f"result{rank}.pt"))
        torch_dist.barrier()
    finally:
        torch_dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, device: str = "cpu") -> List[Any]:
    """``fn(mesh, *args)`` on ``world`` new processes (a module-level
    function; on ``cuda`` rank r on card r), joined through a ``file://``
    store in a fresh temporary directory; returns each rank's result in
    rank order. Raises when a rank fails (the others are ended)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_spawned, args=(fn, r, world, device, tmp, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        code = _wait_all(procs, lambda p: p.exitcode, lambda p: p.kill())
        for p in procs:
            p.join()
        if code:
            raise RuntimeError(f"a rank of {world} failed (exit code {code})")
        return [torch.load(os.path.join(tmp, f"result{r}.pt"), weights_only=False)
                for r in range(world)]
