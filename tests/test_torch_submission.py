"""The port's submission writers and CLI against sprc_tpu's.

The writers: the same sims (seeded, with exact ties) through both packages'
``build_submission_dicts`` / ``write_submission_files`` and
``build_circo_submission`` / ``write_circo_submission``, with and without a
rerank step (CIRR reranks before the reference is dropped), give files equal
byte for byte: ``sort_keys=True``, ``"version": "rc2"``, CIRCO's ids as
strings.

The CLI: ``sprc_tpu_torch.cli.submission`` and ``sprc_tpu.cli.submission``
on the synthetic CIRR test1 tree of tests/test_data.py and a CIRCO test
split written beside its val split, with the checkpoints of
test_torch_rerank_cli.py (the EVA-style tiny retrieval model, and the
rerank model for ``--rerank``, top 3 / step 2): the files are equal byte for
byte (the rerank scores of the two agree within 1e-4, which the test of
validate_rerank holds).
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import sprc_tpu.cli.submission as jcli  # noqa: E402
import sprc_tpu.retrieval.submission as jsub  # noqa: E402
from test_data import circo_root, cirr_root  # noqa: E402,F401  (fixtures)
from test_torch_rerank_cli import RERANK_FLAGS, rerank_checkpoints  # noqa: E402,F401
from test_torch_validate import STYLES, checkpoints  # noqa: E402,F401  (fixture)

import sprc_tpu_torch.cli.submission as pcli  # noqa: E402
import sprc_tpu_torch.retrieval.submission as psub  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)


def _read(paths):
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append((os.path.basename(p), f.read()))
    return out


def _sims(n_query, n_gallery, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 4, (n_query, n_gallery)) / 4.0).astype(np.float32)  # exact ties


def _reverse_prefix(top):
    def rerank_fn(sorted_names):
        out = np.array(sorted_names, copy=True)
        out[:, :top] = out[:, :top][:, ::-1]
        return out

    return rerank_fn


@pytest.mark.parametrize("rerank", [False, True])
def test_cirr_files_equal_the_jax_writers(rerank, tmp_path):
    """60 gallery images, 5 queries with 7-member groups; the rerank (the
    top 6 reversed) runs before the reference is dropped, so a reference in
    the top 6 moves and is still dropped."""
    n_gallery, n_query = 60, 5
    names = [f"dev-{i}-0-img0" for i in range(n_gallery)]
    sims = _sims(n_query, n_gallery, 1)
    rng = np.random.RandomState(2)
    refs, groups, pair_ids = [], [], []
    for q in range(n_query):
        members = rng.choice(n_gallery, size=7, replace=False)
        refs.append(names[members[0]])
        groups.append([names[m] for m in members[1:]])
        pair_ids.append(q * 13)
    sims[0, names.index(refs[0])] = 2.0  # the reference ranks first
    fn = _reverse_prefix(6) if rerank else None
    files = []
    for mod, sub in ((jsub, "jax"), (psub, "port")):
        preds, group_preds = mod.build_submission_dicts(sims, names, refs, groups, pair_ids,
                                                        rerank_fn=fn)
        files.append(_read(mod.write_submission_files(str(tmp_path / sub), "run", preds,
                                                      group_preds)))
    assert files[0] == files[1]
    sub = json.loads(files[1][0][1])
    assert sub["version"] == "rc2" and sub["metric"] == "recall"
    assert all(refs[pair_ids.index(int(k))] not in v for k, v in sub.items()
               if k not in ("version", "metric"))


@pytest.mark.parametrize("rerank", [False, True])
def test_circo_file_equals_the_jax_writer(rerank, tmp_path):
    """Integer-like image and query ids, written as strings; the reference is
    not dropped; top_k 50 of a 70-image gallery."""
    ids = [str(1000 + i) for i in range(70)]
    queries = [str(q) for q in (3, 14, 7)]
    sims = _sims(3, 70, 3)
    fn = _reverse_prefix(5) if rerank else None
    files = []
    for mod, sub in ((jsub, "jax"), (psub, "port")):
        preds = mod.build_circo_submission(sims, ids, queries, rerank_fn=fn)
        files.append(_read([mod.write_circo_submission(str(tmp_path / sub), "run", preds)]))
    assert files[0] == files[1]
    loaded = json.loads(files[1][0][1])
    assert sorted(loaded) == sorted(queries) and all(len(v) == 50 for v in loaded.values())


def _circo_test_split(root):
    anns = [{"id": q, "reference_img_id": 1000 + q, "relative_caption": f"query {q}",
             "shared_concept": "thing"} for q in range(3)]
    (root / "annotations" / "test.json").write_text(json.dumps(anns))
    return root


@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("dataset", ["CIRR", "CIRCO"])
def test_submission_cli_matches_jax(dataset, rerank, rerank_checkpoints, cirr_root,  # noqa: F811
                                    circo_root, tmp_path, capsys):  # noqa: F811
    model_type, overrides = STYLES["eva"]
    data = cirr_root if dataset == "CIRR" else _circo_test_split(circo_root)
    argv = ["--dataset", dataset, "--data-path", str(data),
            "--model-path", rerank_checkpoints["eva"], "--model-type", model_type,
            "--vocab-path", rerank_checkpoints["vocab"], "--encode-batch", "4",
            "--query-batch", "2", "--workers", "2", "--no-bf16", "--submission-name", "tiny"]
    if rerank:
        argv += ["--rerank", "--rerank-model-path", rerank_checkpoints["rerank"]["eva"],
                 *RERANK_FLAGS]
    argv += ["--model-overrides", *overrides]
    files, printed = [], []
    for mod, sub, extra in ((jcli, "jax", []), (pcli, "port", ["--device", "cpu"])):
        mod.main(argv + ["--output-dir", str(tmp_path / sub)] + extra)
        printed.append(capsys.readouterr().out)
        files.append(_read(sorted(str(p) for p in (tmp_path / sub).iterdir())))
    assert files[0] == files[1]
    assert [line.rsplit("/", 1)[1] for line in printed[0].split()[1::2]] == [
        line.rsplit("/", 1)[1] for line in printed[1].split()[1::2]]
    want = ["circo_submission_tiny.json"] if dataset == "CIRCO" else [
        "recall_submission_tiny.json", "recall_subset_submission_tiny.json"]
    assert [name for name, _ in files[1]] == want
    defaults = pcli.make_parser().parse_args(["--dataset", dataset, "--data-path", "x",
                                              "--submission-name", "s"])
    assert (defaults.output_dir, defaults.rerank_top, defaults.rerank_step) == (
        "submission/CIRR", 50, 50)
