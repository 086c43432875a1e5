"""The train step under ``--mesh`` at world 2 (gloo, on the CPU) against
JAX's mesh step and the port's one-device step.

The tiny fp32 flagship of ``test_torch_train_losses.py`` (JAX weights
through ``interop/jax_params.py``, dropout 0) takes one step on a global
batch of 4 over two ranks of 2 rows; JAX's ``make_train_step(...,
mesh=make_mesh(2))`` takes it on the same batch sharded over two virtual CPU
devices. The losses agree within 1e-5 relative and every updated trainable
tensor within ``PARAM_ATOL`` (2e-7, the single-device AdamW bound of
``test_torch_train_loop.py``): the first OneCycle update is 4e-7, so a
gradient's last-bit difference moves no tensor by more than a rounding. The
same holds for the cached step (``from_embeds``: the tower's rows from JAX's
``encode_tower``).

Each of the eight loss variants at world 2 (random weights from a seed,
argmax negatives, a global batch of 6, so that ``blip2_cir_cls`` finds 4
other captions) equals the port's world-1 step within the same bounds; a
non-finite gradient on one rank skips the step on both; ``grad_accum`` 2 at
world 2 equals it at world 1; a resume restores each rank its own dropout
generator; ``cli/finetune.py --mesh --cache-features`` at world 2 (the
train cache built on rank 0 and mapped, the val gallery cached by shard)
logs the epoch's losses and validation of the run without ``--mesh``, its
two updates' tensors part from that run's by at most two AdamW steps' worth
(``2 (lr0 + lr1)``: an element whose gradient is near 0 flips its normalised
step on a last-bit difference), and its ``last_state.pt`` holds both ranks'
generators. One spawn runs every
world-2 case (``dryrun.run_cases``).
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_data import cirr_root  # noqa: E402,F401  (fixture)
from test_golden_rehearsal import VOCAB  # noqa: E402
from test_torch_train_losses import B, jax_model, jax_params, make_batch  # noqa: E402

from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from sprc_tpu_torch.parallel import dryrun  # noqa: E402
from sprc_tpu_torch.parallel.mesh import spawn  # noqa: E402
from sprc_tpu_torch.train.schedules import onecycle_schedule  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

PARAM_ATOL, LOSS_RTOL = 2e-7, 1e-5
VARIANTS = ("blip2_cir_cat", "blip2_cir_rel", "blip2_cir_z_learn_pos_align", "blip2_cir_neg",
            "blip2_cir_neg_rel", "blip2_cir_full", "blip2_cir_rerank", "blip2_cir_cls")
SEEDED = {"name": "blip2_cir_align_prompt", "overrides": dryrun.tiny_overrides(), "seed": 4}


def _batches(n, b, seed=20):
    return [make_batch(seed=seed + i, b=b) for i in range(n)]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX weights and JAX's mesh steps (live and cached) on the batch."""
    from sprc_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from sprc_tpu.train.loop import TrainConfig as JTrainConfig
    from sprc_tpu.train.loop import create_train_state, make_train_step

    jm = jax_model()
    params = jax_params(jm)
    batch = make_batch()
    rows = jax.jit(lambda p, x: jm.apply({"params": p}, x, method=jm.encode_tower))
    cached = {"reference_embeds": np.asarray(rows(params, batch["reference"])),
              "target_embeds": np.asarray(rows(params, batch["target"])),
              "input_ids": batch["input_ids"], "text_mask": batch["text_mask"]}
    mesh = make_mesh(2)
    out = {"params": params, "batch": batch, "cached": cached}
    for key, from_embeds, b in (("live", False, batch), ("cached_step", True, cached)):
        cfg = JTrainConfig(total_steps=100)
        state, tx = create_train_state(params, cfg)
        step = make_train_step(jm, tx, cfg, mesh=mesh, donate=False, from_embeds=from_embeds)
        new, metrics = step(replicate(mesh, state), shard_batch(mesh, b))
        out[key] = {"metrics": {k: float(v) for k, v in metrics.items()},
                    "params": {k: v.numpy() for k, v in state_dict_from_jax(
                        jax.tree_util.tree_map(np.asarray, new.params),
                        vit="eva_clip_g").items()}}
    return out


def _finetune_argv(data, out, vocab, *extra):
    return ["--dataset", "CIRR", "--data-path", str(data), "--vocab-path", vocab,
            "--output-dir", str(out), "--device", "cpu", "--batch-size", "2", "--num-epochs",
            "1", "--encode-batch", "4", "--query-batch", "2", "--workers", "1", "--seed", "0",
            "--no-bf16", "--cache-features", *extra]


@pytest.fixture(scope="module")
def cli_tree(cirr_root, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("mesh_finetune")
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    return {"data": cirr_root, "vocab": str(root / "vocab.txt"), "root": root}


@pytest.fixture(scope="module")
def ranks(jax_side, cli_tree, tmp_path_factory):
    """Every world-2 case in one spawn: [rank 0's results, rank 1's]."""
    spec = {"name": "blip2_cir_align_prompt", "overrides": dryrun.tiny_overrides(),
            "state": state_dict_from_jax(jax_side["params"], vit="eva_clip_g")}
    dropout = dict(SEEDED, overrides=dryrun.tiny_overrides(dropout=0.1))
    path = str(tmp_path_factory.mktemp("mesh_train") / "last_state.pt")
    argv = _finetune_argv(cli_tree["data"], cli_tree["root"] / "mesh", cli_tree["vocab"],
                          "--mesh")
    cases = [("train_case", (spec, [jax_side["batch"]]), {}),
             ("train_case", (spec, [jax_side["cached"]]), {"from_embeds": True}),
             ("variants_case", (VARIANTS, dryrun.tiny_overrides(), make_batch(seed=11, b=6)),
              {}),
             ("train_case", (SEEDED, _batches(2, B)), {"skip_nonfinite": True,
                                                      "poison": (1, 1)}),
             ("train_case", (SEEDED, _batches(4, B)), {"grad_accum": 2}),
             ("resume_case", (dropout, make_batch(), path), {}),
             ("finetune_cli_case", (argv, dryrun.tiny_overrides()), {})]
    return spawn(dryrun.run_cases, 2, cases)


def _same_step(got, want_metrics, want_params):
    for key, want in want_metrics.items():
        if key.startswith("loss"):
            assert got["metrics"][-1][key] == pytest.approx(want, rel=LOSS_RTOL), key
    assert set(got["params"]) <= set(want_params)
    for name, value in got["params"].items():
        np.testing.assert_allclose(value, want_params[name], rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("case,key", [(0, "live"), (1, "cached_step")])
def test_flagship_step_at_world_2_equals_jax_mesh_step(ranks, jax_side, case, key):
    want = jax_side[key]
    for rank in ranks:
        _same_step(rank[case], want["metrics"], want["params"])
    assert ranks[0][case]["metrics"] == ranks[1][case]["metrics"]  # the global batch's losses


def test_every_loss_variant_at_world_2_equals_world_1(ranks):
    one = dryrun.variants_case(None, VARIANTS, dryrun.tiny_overrides(),
                               make_batch(seed=11, b=6))
    for name in VARIANTS:
        want = one[name]
        assert want["metrics"][0]["loss"] > 0 and want["updates"] == 1
        for rank in ranks:
            _same_step(rank[2][name], want["metrics"][0], want["params"])


def test_a_nonfinite_rank_skips_the_step_on_every_rank(ranks):
    """Rank 1's rows of the second batch are NaN: both ranks skip it, and
    both hold the world-1 state after the first batch alone."""
    one = dryrun.train_case(None, SEEDED, _batches(1, B), skip_nonfinite=True)
    for rank in ranks:
        got = rank[3]
        assert [m["skipped_nonfinite"] for m in got["metrics"]] == [0.0, 1.0]
        assert got["updates"] == 1
        _same_step({"metrics": got["metrics"][:1], "params": got["params"]},
                   one["metrics"][0], one["params"])


def test_grad_accum_2_at_world_2_equals_world_1(ranks):
    one = dryrun.train_case(None, SEEDED, _batches(4, B), grad_accum=2)
    assert one["updates"] == 2
    for rank in ranks:
        got = rank[4]
        assert got["updates"] == 2
        for g, w in zip(got["metrics"], one["metrics"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=LOSS_RTOL)
        _same_step(got, one["metrics"][-1], one["params"])


def test_resume_restores_each_rank_its_own_generator(ranks):
    got = [rank[5] for rank in ranks]
    for r in got:
        assert torch.equal(r["saved"], r["restored"])
        assert r["next"] == r["next_restored"]
    assert not torch.equal(got[0]["saved"], got[1]["saved"])  # (seed, rank) streams


def test_finetune_refuses_an_indivisible_batch_before_building(monkeypatch):
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.cli import finetune
    from sprc_tpu_torch.parallel import mesh as mesh_lib

    monkeypatch.setattr(mesh_lib, "make_mesh",
                        lambda device: mesh_lib.Mesh(0, 2, torch.device("cpu")))
    monkeypatch.setattr(loader, "load_model", lambda *a, **k: pytest.fail("model built"))
    args = finetune.make_parser().parse_args(["--dataset", "CIRR", "--data-path", "x",
                                              "--batch-size", "3", "--mesh", "--device", "cpu"])
    assert isinstance(args, argparse.Namespace)
    with pytest.raises(SystemExit, match="does not divide"):
        finetune.finetune(args)


def _log(out):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [{k: v for k, v in e.items() if k != "seconds"} for e in map(json.loads, f)]


def test_finetune_cli_mesh_logs_the_run_without_it(ranks, cli_tree):
    """Rank 0 alone prints and writes; the epoch's losses, its validation
    (from the val cache, each rank caching its shard) and the final tensors
    are the world-1 run's."""
    one = cli_tree["root"] / "one"
    dryrun.finetune_cli_case(None, _finetune_argv(cli_tree["data"], one, cli_tree["vocab"]),
                             dryrun.tiny_overrides())
    mesh = cli_tree["root"] / "mesh"
    assert ranks[0][6] and ranks[1][6] == ""  # rank 1 prints nothing
    got, want = _log(mesh), _log(one)
    assert [e["kind"] for e in got] == [e["kind"] for e in want] == ["train", "val"]
    for key, value in want[0].items():
        assert got[0][key] == pytest.approx(value, rel=LOSS_RTOL), key
    assert got[1] == want[1]
    states = [torch.load(d / "last_state.pt", weights_only=True) for d in (mesh, one)]
    assert len(states[0]["generators"]) == 2 and "generators" not in states[1]
    # two updates: AdamW moves an element by at most about lr a step, so an
    # element whose gradient is near 0 (where the two runs' last-bit
    # differences flip its normalised step) parts by at most 2 (lr0 + lr1)
    sched = onecycle_schedule(1e-5, 2 * 80, pct_start=1 / 50)
    bound = 2 * (sched(0) + sched(1))
    for name, value in states[1]["trainable"].items():
        np.testing.assert_allclose(states[0]["trainable"][name].numpy(), value.numpy(),
                                   rtol=0, atol=bound, err_msg=name)
