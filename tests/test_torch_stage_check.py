"""The verification aids of the port, on the CPU: the stage-by-stage check
(``primitives.stage_check`` with ``kernel_checks.StageRecorder``), switching
an int8 tower between its modes, and the parallel kernel build driven with a
stand-in compiler.
"""

import os
import stat
import types

import pytest
import torch

from sprc_tpu_torch import kernel_checks
from sprc_tpu_torch.models.vit import ClipViT, ViTConfig
from sprc_tpu_torch.ops import _ext, primitives
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)


def test_stage_recorder_units_and_bounds():
    """Int8 outputs are read in codes, the others relative to the largest
    plain value; a tuple is codes and scales; a kind without a bound fails."""
    rec = kernel_checks.StageRecorder()
    assert not rec.ok()  # nothing recorded is not a pass
    want = torch.tensor([[1, -5, 7, 100]], dtype=torch.int8)
    rec("layer_norm", want + torch.tensor([[0, 1, 0, 0]], dtype=torch.int8), want)
    f = torch.tensor([2.0, -4.0])
    rec("attention", f + torch.tensor([0.0, 2.0 ** -18]), f)
    rec("quantize_rows", (want, f), (want, f))
    rows = {r["kind"]: r for r in rec.rows()}
    assert rows["layer_norm -> s8"]["differ"] == 0.25 and rows["layer_norm -> s8"]["err"] == 1
    assert rows["attention -> f32"]["err"] == 2.0 ** -20  # 2^-18 over the largest value, 4
    assert rows["quantize_rows codes"]["ok"] and rows["quantize_rows scales"]["ok"]
    assert not rows["layer_norm -> s8"]["ok"]  # a quarter of the codes is past its bound
    rec2 = kernel_checks.StageRecorder()
    rec2("gemm_i8", torch.ones(2, dtype=torch.bfloat16), torch.ones(2, dtype=torch.bfloat16))
    assert rec2.ok()
    rec2("token_max_sim", f, f)
    assert not rec2.ok() and "FAIL" in rec2.describe()


def test_stage_check_runs_both_and_passes_the_kernel_result_on(monkeypatch):
    """Inside ``stage_check`` a primitive launches its kernel, runs the plain
    version on the same arguments, records both and returns the kernel's."""
    seen = []
    fake = types.SimpleNamespace(**{
        name: (lambda fn: lambda *a, **kw: fn(*a, **kw) + 1)(getattr(primitives.PLAIN, name))
        for name in ("gemm", "layer_norm")})
    monkeypatch.setattr(primitives, "CUDA", fake)
    ops = primitives._checked(lambda name, got, want: seen.append((name, got, want)))
    x, w = torch.ones(2, 4), torch.ones(3, 4)
    y = ops.gemm(x, w)
    assert torch.equal(y, torch.full((2, 3), 5.0))  # the "kernel" result
    assert seen[0][0] == "gemm" and torch.equal(seen[0][2], torch.full((2, 3), 4.0))
    # on CPU tensors the wrappers run the plain set, whatever the context
    with primitives.stage_check(lambda *a: seen.append(a)):
        assert primitives.for_device(x) is primitives.PLAIN
    assert primitives._STAGE_CHECK.get() is None


def test_set_quant_switches_int8_modes_only():
    cfg = ViTConfig(image_size=28, patch_size=14, width=32, depth=2, num_heads=2, mlp_hidden=64,
                    use_ln_pre=True, quick_gelu=True, patch_bias=False, dtype=torch.float32)
    scales = (("mlp_fc1", 0.1), ("mlp_fc2", 0.1), ("proj", 0.1), ("qkv", 0.1))
    with torch.device("meta"):
        fp = ClipViT(cfg)
        tower = ClipViT(ViTConfig(**{**cfg.__dict__, "quant": "int8_calib"}))
    with pytest.raises(ValueError, match="int8 mode"):
        fp.set_quant("int8_static", scales)
    with pytest.raises(ValueError, match="int8 mode"):
        tower.set_quant(None)
    with pytest.raises(ValueError, match="act_scales"):
        tower.set_quant("int8_static")
    assert tower.cfg.quant == "int8_calib"  # a refused switch changes nothing
    tower.set_quant("int8_static", scales)
    assert all(b.cfg.quant == "int8_static" and b.cfg.act_scales == scales
               for b in tower.transformer.resblocks)
    assert set(fp.state_dict()) == set(tower.state_dict())


def _fake_nvcc(tmp_path, fail_on=""):
    """A stand-in compiler: writes the file named after -o; exits 1 for a
    source whose name contains ``fail_on``."""
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    script = bindir / "nvcc"
    script.write_text(
        "#!/bin/sh\nout=\nfor a in \"$@\"; do\n"
        "  if [ \"$prev\" = \"-o\" ]; then out=$a; fi\n"
        f"  case \"$a\" in *{fail_on or 'no-such-source'}*.cu) echo boom; exit 1;; esac\n"
        "  prev=$a\ndone\necho built > \"$out\"\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(tmp_path / "cuda")


@pytest.mark.parametrize("jobs", [None, 1])
def test_build_compiles_every_source_links_and_caches(tmp_path, monkeypatch, jobs):
    monkeypatch.setattr(_ext, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_ext.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", _fake_nvcc(tmp_path))
    out = _ext.build(jobs=jobs)
    assert out == _ext.library_path() and out.read_text() == "built\n"
    log = (tmp_path / "_build" / "nvcc.log").read_text()
    for src in _ext.CSRC.glob("*.cu"):
        assert f"==> {src.name} (exit 0" in log
    assert "==> link (exit 0)" in log
    assert set(os.listdir(tmp_path / "_build")) == {out.name, "nvcc.log"}  # no leftovers
    stamp = out.stat().st_mtime_ns
    assert _ext.build(jobs=jobs) == out and out.stat().st_mtime_ns == stamp  # cached


def test_build_failure_names_the_source_and_leaves_no_library(tmp_path, monkeypatch):
    monkeypatch.setattr(_ext, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_ext.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", _fake_nvcc(tmp_path, fail_on="quantize"))
    with pytest.raises(RuntimeError, match=r"nvcc failed for \['quantize.cu'\]"):
        _ext.build()
    assert not _ext.library_path().exists()
    assert "boom" in (tmp_path / "_build" / "nvcc.log").read_text()
