"""The port's data-parallel plumbing (``sprc_tpu_torch/parallel/``,
``data/loader.py``) at world 2 on gloo, on the CPU.

One module fixture spawns the two ranks once (``parallel/mesh.py::spawn``
over a ``file://`` store in a fresh temporary directory: no fixed port, so
xdist workers never collide) and runs every collective case there:

- the ``dist`` helpers: ranks, ``broadcast_from_main``, ``main_process``,
  ``barrier`` and ``main_process_first``'s order (rank 0's write is what
  rank 1 reads);
- ``all_gather_with_grad``: the gradient that reaches each rank's rows is
  the world-1 gradient of the sum of the ranks' losses over the gathered
  batch, within 1e-6 relative (a row's two parts, as a query and as a
  gathered key, reach it by two paths and are added in another order than
  one device's single product sums them: a last-bit difference), and
  ``concat_all_gather`` the rows in rank order, exactly.

Without a group the helpers behave as at world 1; ``pad_to_multiple`` and
``host_shard`` are JAX's; the loader's rank slices, put back together, are
the world-1 batches, and a batch the world does not divide is refused.
"""

import os

import numpy as np
import pytest
import torch

from sprc_tpu_torch.data.loader import DataLoader, host_shard
from sprc_tpu_torch.parallel import dist, mesh as mesh_lib
from test_torch_threads import one_torch_thread  # noqa: F401  (one thread a module)

GLOBAL = np.random.RandomState(0).standard_normal((4, 3)).astype(np.float32)


def _losses(x, gathered, offset):
    """Each row's cross-entropy against the gathered rows, its own as label."""
    logits = x @ gathered.t()
    labels = torch.arange(x.shape[0]) + offset
    return torch.nn.functional.cross_entropy(logits, labels, reduction="sum")


def ranks_case(mesh, path):
    """Every collective case of this file on one rank."""
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "main": dist.is_main_process(), "init": dist.is_dist_avail_and_initialized()}
    out["broadcast"] = dist.broadcast_from_main({"from": dist.get_rank()})
    out["only_main"] = dist.main_process(lambda: "ran")()
    dist.barrier()

    @dist.main_process_first
    def first():
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write(str(dist.get_rank()))
        with open(path) as f:
            return f.read()

    out["first"] = first()
    b = GLOBAL.shape[0] // mesh.world
    x = torch.from_numpy(GLOBAL[mesh.rank * b:(mesh.rank + 1) * b].copy()).requires_grad_()
    gathered = mesh_lib.all_gather_with_grad(x, mesh)
    _losses(x, gathered, mesh.rank * b).backward()
    out["grad"] = x.grad.numpy()
    out["gathered"] = mesh_lib.concat_all_gather(x, mesh).numpy()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("parallel") / "first.txt")
    return mesh_lib.spawn(ranks_case, 2, path)


def test_dist_helpers_at_world_2(ranks):
    assert [(r["rank"], r["world"], r["main"], r["init"]) for r in ranks] == [
        (0, 2, True, True), (1, 2, False, True)]
    assert [r["broadcast"] for r in ranks] == [{"from": 0}, {"from": 0}]
    assert [r["only_main"] for r in ranks] == ["ran", None]
    assert [r["first"] for r in ranks] == ["0", "0"]  # rank 0 ran first, rank 1 read its file


def test_dist_helpers_without_a_group_are_world_1():
    assert not dist.is_dist_avail_and_initialized()
    assert (dist.get_rank(), dist.get_world_size(), dist.is_main_process()) == (0, 1, True)
    dist.barrier()
    assert dist.broadcast_from_main({"a": 1}) == {"a": 1}
    assert dist.main_process(lambda: 3)() == 3 and dist.main_process_first(lambda: 4)() == 4
    x = torch.ones(2)
    assert mesh_lib.gather_batch(x) is x and mesh_lib.batch_offset(3) == 0


def test_all_gather_with_grad_gives_the_world_1_gradient(ranks):
    x = torch.from_numpy(GLOBAL.copy()).requires_grad_()
    _losses(x, x, 0).backward()  # the sum of both ranks' losses, on one device
    np.testing.assert_allclose(np.concatenate([r["grad"] for r in ranks]), x.grad.numpy(),
                               rtol=1e-6, atol=1e-7)
    for r in ranks:
        np.testing.assert_array_equal(r["gathered"], GLOBAL)


def test_pad_to_multiple_and_host_shard_equal_jax():
    from sprc_tpu.data.loader import host_shard as jhost_shard
    from sprc_tpu.parallel.mesh import pad_to_multiple as jpad

    for n in range(0, 12):
        for k in range(1, 5):
            assert mesh_lib.pad_to_multiple(n, k) == jpad(n, k)
            for i in range(k):
                assert host_shard(n, i, k) == jhost_shard(n, i, k)
                assert mesh_lib.Mesh(i, k, torch.device("cpu")).shard(n) == host_shard(n, i, k)


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full(2, i, np.int64), "name": f"s{i}"}


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_rank_slices_are_the_world_1_batches(drop_last):
    """JAX's order (``seed + epoch`` over the host's shard), cut into global
    batches and those into rank slices; the slices put back are world 1's."""
    from sprc_tpu.data.loader import DataLoader as JDataLoader

    data = _Items(22)
    for epoch in (0, 3):
        one = DataLoader(data, 4, num_workers=2, shuffle=True, drop_last=drop_last, seed=7)
        jax_one = JDataLoader(data, 4, shuffle=True, drop_last=drop_last, seed=7, num_workers=1)
        for loader in (one, jax_one):
            loader.set_epoch(epoch)
        want = [b["name"] for b in one]
        assert want == [b["name"] for b in jax_one]
        parts = []
        for rank in range(2):
            loader = DataLoader(data, 4, num_workers=2, shuffle=True, drop_last=drop_last,
                                seed=7, rank=rank, world=2)
            loader.set_epoch(epoch)
            assert len(loader) == len(one)
            parts.append([b["name"] for b in loader])
        assert [a + b for a, b in zip(*parts)] == want
    hosts = [DataLoader(data, 4, host_id=h, num_hosts=2, drop_last=drop_last)
             for h in range(2)]
    assert [n for h in hosts for b in h for n in b["name"]] == [f"s{i}" for i in range(22)
                                                                 if drop_last is False or
                                                                 i % 11 < 8]


def test_indivisible_batches_and_missing_launchers_are_refused(monkeypatch):
    with pytest.raises(ValueError, match="does not divide"):
        DataLoader(_Items(8), 3, world=2)
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.shard_batch(mesh_lib.Mesh(0, 2, torch.device("cpu")), {"x": np.zeros(3)})
    for key in mesh_lib.LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="launcher"):
        mesh_lib.make_mesh(device="cpu")
    with pytest.raises(SystemExit, match="torchrun"):
        mesh_lib.launch_or_join("sprc_tpu_torch.cli.validate", [], "cpu")


def _fails_on_rank_1(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    return mesh.rank


def test_a_failing_rank_fails_the_spawn():
    with pytest.raises(RuntimeError, match="a rank of 2 failed"):
        mesh_lib.spawn(_fails_on_rank_1, 2)
