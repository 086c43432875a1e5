"""The two activation quantisers of csrc/quantize.cu as they walk their data,
in plain PyTorch (sprc_tpu_torch/ops/schedules.py), against the port's plain
quantisers (ops/quant.py) and the JAX ``_mm_i8``; and the int8 Q-Former's one
quantisation of the image rows a pass (models/qformer.py).

What can be wrong outside the CUDA source: which instantiation a call takes
(16-byte loads of 8 bf16 or 4 fp32 values where the data allows, a main-path
width or the generic one), which values a thread or a lane loads (the grid
stride of ``quantize_static``, the warp-a-row chunks of ``quantize_rows``, the
masked tails), and the order of the arithmetic. Codes and scales are held
bit-equal: the |max| is exact in any order, and each value is rounded as the
plain version rounds it (IEEE division; ties to even, on rows built so that
x / sc lands exactly on k + 0.5).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.ops.pallas_qformer import _mm_i8  # noqa: E402

from sprc_tpu_torch import kernel_checks  # noqa: E402
from sprc_tpu_torch.loader import init_weights  # noqa: E402
from sprc_tpu_torch.models.qformer import QFormer, QFormerConfig, _ffn_params  # noqa: E402
from sprc_tpu_torch.ops import primitives, quant, schedules  # noqa: E402
from sprc_tpu_torch.ops.fused_qformer import (  # noqa: E402
    fused_qformer_layer, fused_qformer_layer_plain)
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

WIDTHS = (1, 7, 13, 768, 1000, 1024, 1408, 3072, 4096)
# a 12-layer int8 Q-Former, narrow: cross-attention on the six even layers
CFG8 = QFormerConfig(vocab_size=60, hidden_size=32, num_layers=12, num_heads=2,
                     intermediate_size=64, encoder_width=48, query_length=4, int8=True)
B, SI = 2, 5


def _x(seed, rows, W, dtype, std=2.0):
    x = np.random.default_rng(seed).standard_normal((rows, W), dtype=np.float32) * std
    return torch.from_numpy(x).to(dtype)


def test_plans_at_the_main_path_calls():
    """Every call of the main paths takes 16-byte loads; the Q-Former's rows
    take a width built as a template parameter; ragged and unaligned rows
    take the generic instantiation or one value a load; past 4096 refused."""
    for name, (kind, rows, W, dtype) in kernel_checks.QUANT_CALLS.items():
        elt = torch.tensor([], dtype=dtype).element_size()
        if kind == "static":
            plan = schedules.quantize_static_plan(rows * W, elt)
            assert plan["vec"] == 16 // elt and plan["blocks"] == 132 * 4, (name, plan)
        else:
            plan = schedules.quantize_rows_plan(W, elt, rows=rows)
            assert (plan["vec"], plan["width"]) == (4, W), (name, plan)
            assert plan["blocks"] == -(-rows // 4), (name, plan)
    vit_l = schedules.quantize_static_plan(16448 * 1024, 2)
    assert (vit_l["loads"], vit_l["threads"], vit_l["unroll"], vit_l["steps"]) == (
        2105344, 256, 4, 4)
    assert schedules.quantize_static_plan(7, 2)["vec"] == 1
    assert schedules.quantize_static_plan(16, 4, aligned=False)["vec"] == 1
    lanes = {W: schedules.quantize_rows_plan(W, 4) for W in (768, 1024, 1408, 3072)}
    assert {W: (p["loads"], p["registers"]) for W, p in lanes.items()} == {
        768: (6, 24), 1024: (8, 32), 1408: (11, 44), 3072: (24, 96)}
    p = schedules.quantize_rows_plan(1408, 2)  # 5.5 loads of 8 bf16: the last masked
    assert (p["vec"], p["width"], p["loads"], p["tail_lanes"]) == (8, 1408, 6, 16)
    assert schedules.quantize_rows_plan(1000, 4)["width"] == "generic"
    assert schedules.quantize_rows_plan(13, 4)["vec"] == 1
    assert schedules.quantize_rows_plan(1024, 4, aligned=False)["vec"] == 1
    with pytest.raises(ValueError, match="4096"):
        schedules.quantize_rows_plan(4097, 4)


def test_static_walk_takes_every_value_once():
    """The grid-stride walk over a small grid (2 SMs of one block, so that a
    thread takes several steps and the last is masked): every value once,
    and its codes bit-equal to the plain version's, clipped ones included."""
    for n in (1, 7, 13, 8 * 1024 * 3 + 8, 4096 * 3 + 5):
        for dtype in (torch.bfloat16, torch.float32):
            elt = torch.tensor([], dtype=dtype).element_size()
            idx = schedules.quantize_static_loads(n, elt, sms=2, blocks_per_sm=1)
            taken = idx[idx >= 0]
            assert torch.equal(taken.sort().values, torch.arange(n))
            x = _x(n, 1, n, dtype, std=8.0).reshape(-1)
            codes = torch.zeros(n, dtype=torch.int8)
            codes[taken] = torch.clamp(torch.round(x.float()[taken] * 20.0), -127,
                                       127).to(torch.int8)
            assert torch.equal(codes, quant.quantize_static(x, kernel_checks.QUANT_SCALE))


def test_rows_walk_bit_equal_to_plain():
    """Random rows, an all-zero row and rows of exact ties, at every width of
    the edge checks, in bf16 and fp32."""
    for dtype in (torch.bfloat16, torch.float32):
        for W in WIDTHS:
            x = _x(W, 9, W, dtype)
            x[4] = 0.0
            for rows in (x, kernel_checks._tie_rows(6, W, dtype)):
                got, want = schedules.quantize_rows_emulated(rows), quant.quantize_rows(rows)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), W
        x3 = _x(3, 12, 1024, dtype).reshape(3, 4, 1024)  # leading dims are rows
        codes, sc = schedules.quantize_rows_emulated(x3)
        assert codes.shape == x3.shape and sc.shape == (3, 4)


def test_rows_walk_matches_jax_mm_i8_on_ties():
    """The JAX kernel's ``_mm_i8`` through an identity weight returns
    ``codes * sc``: equal to the walk's, on rows whose quotients are exact
    half steps (a multiply by 1 / sc would round some to the other side)."""
    ties = kernel_checks._tie_rows(8, 768, torch.float32)
    x = torch.cat([ties, _x(9, 8, 768, torch.float32)])
    eye = jnp.eye(768, dtype=jnp.int8)
    want = np.asarray(_mm_i8(jnp.asarray(x.numpy()), eye, jnp.ones(768, jnp.float32),
                             jnp.zeros(768, jnp.float32)))
    codes, sc = schedules.quantize_rows_emulated(x)
    np.testing.assert_array_equal((codes.float() * sc[:, None]).numpy(), want)
    halves = (x / sc[:, None]).numpy()
    assert (np.abs(halves[:8] - np.round(halves[:8])) == 0.5).sum() > 8 * 700


@pytest.fixture(scope="module")
def trunk():
    model = QFormer(CFG8).eval()
    init_weights(model, seed=3)
    rng = np.random.default_rng(11)
    queries = torch.from_numpy(rng.standard_normal((B, 4, 32), dtype=np.float32) * 0.5)
    img = torch.from_numpy(rng.standard_normal((B, SI, 48), dtype=np.float32))
    return model, queries, img


def test_int8_trunk_quantises_the_image_rows_once(trunk, monkeypatch):
    """One forward of the 12-layer int8 trunk quantises the image rows once,
    not once per cross layer (six), and gives the per-layer form's output."""
    model, queries, img = trunk
    calls = []
    plain = primitives.PLAIN.quantize_rows

    def counted(x):
        calls.append(tuple(x.shape))
        return plain(x)

    monkeypatch.setattr(primitives.PLAIN, "quantize_rows", counted)
    with torch.inference_mode():
        got = model(query_embeds=queries, image_embeds=img)
        assert calls.count(tuple(img.shape)) == 1, calls
        calls.clear()
        hidden = model.embeddings(None, queries)  # the per-layer form: raw rows to each layer
        for layer in model.encoder.layer:
            hidden = layer(hidden, None, img, 4)
    assert calls.count(tuple(img.shape)) == 6, calls
    assert torch.equal(got, hidden)


def test_layer_takes_the_image_rows_quantised(trunk):
    """K4 handed (codes, scales) computes what it computes on the raw rows,
    kernel wrapper and plain version alike; the fp32 layer is unchanged."""
    model, queries, img = trunk
    layer = model.encoder.layer[0]
    args = (layer.attention.kernel_params(), layer.crossattention.kernel_params(),
            _ffn_params(layer.intermediate_query, layer.output_query, True), None)
    kw = dict(heads=2, eps=CFG8.layer_norm_eps, Q=4, text_ffn_all=False, int8=True)
    with torch.inference_mode():
        x = model.embeddings(None, queries)
        for fn in (fused_qformer_layer, fused_qformer_layer_plain):
            raw, pre = (fn(x, None, args[0], kv, *args[1:], **kw)
                        for kv in (img, quant.quantize_rows(img)))
            assert torch.equal(raw, pre)
        with pytest.raises(ValueError):
            fused_qformer_layer(x, None, args[0], quant.quantize_rows(img), *args[1:],
                                **{**kw, "int8": False})
