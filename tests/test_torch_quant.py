"""The port's int8 quantisers (sprc_tpu_torch/ops/quant.py and the plain int8
primitives of ops/primitives.py) against sprc_tpu's.

The same numpy-seeded arrays go through both. Codes (int8) and scales must
be bit-equal: both sides do the same fp32 operations in the same order
(divide where the JAX function divides, multiply by the reciprocal where it
multiplies) and round half to even. Rescaled fp32 outputs are held to 1e-6
relative (XLA may fuse a multiply and an add into one rounding). Weights are
[in, out] in JAX and [out, in] in the port.

The last test holds the codes of a bf16 tower bit-equal to
``quantize_weight`` of the fp32 parameters: they are derived from the fp32
source before it is cast, at load time and at seeded init.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.ops import quant as jquant  # noqa: E402
from sprc_tpu.ops.pallas_block import _ln_f32, _q8  # noqa: E402
from sprc_tpu.ops.pallas_qformer import _mm_i8  # noqa: E402

from sprc_tpu_torch.loader import load_model  # noqa: E402
from sprc_tpu_torch.models.qformer import QFormerConfig  # noqa: E402
from sprc_tpu_torch.models.vit import ClipViT, ViTConfig  # noqa: E402
from sprc_tpu_torch.ops import primitives, quant  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

R, K, N = 37, 128, 96  # ragged row count; K a multiple of 16 as the kernel wants
RTOL = 1e-6


def _data(seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(R, K) * 1.7).astype(np.float32)
    x[3] = 0.0  # an all-zero row: the 1e-8 floor of the scale
    w = (rng.randn(K, N) * 0.05).astype(np.float32)  # JAX layout [in, out]
    b = (rng.randn(N) * 0.1).astype(np.float32)
    return x, w, b


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_quantize_weight_bit_equal():
    _, w, _ = _data(0)
    w8, ws = jquant.quantize_weight(jnp.asarray(w))
    p8, ps = quant.quantize_weight(_t(w.T))
    np.testing.assert_array_equal(p8.numpy(), np.asarray(w8).T)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(ws))


def test_quantize_act_bit_equal():
    x, _, _ = _data(1)
    x8, xs = jquant.quantize_act(jnp.asarray(x))
    p8, ps = quant.quantize_act(_t(x))
    np.testing.assert_array_equal(p8.numpy(), np.asarray(x8))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(xs))


@pytest.mark.parametrize("fn", ["int8_matmul", "int8_dense_from_fp", "int8_dense_static"])
def test_int8_dense_matches_jax(fn):
    x, w, b = _data(2)
    if fn == "int8_matmul":
        w8, ws = jquant.quantize_weight(jnp.asarray(w))
        want = jquant.int8_matmul(jnp.asarray(x), w8, ws, jnp.asarray(b), out_dtype=jnp.float32)
        got = quant.int8_matmul(_t(x), *quant.quantize_weight(_t(w.T)), _t(b),
                                out_dtype=torch.float32)
    elif fn == "int8_dense_from_fp":
        want = jquant.int8_dense_from_fp(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                         out_dtype=jnp.float32)
        got = quant.int8_dense_from_fp(_t(x), _t(w.T), _t(b), out_dtype=torch.float32)
    else:
        want = jquant.int8_dense_static(jnp.asarray(x), jnp.asarray(w), 0.043, jnp.asarray(b),
                                        out_dtype=jnp.float32)
        got = quant.int8_dense_static(_t(x), _t(w.T), 0.043, _t(b), out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)


def test_q8_static_codes_bit_equal():
    """``_q8`` of the JAX block kernel: on a plain array, and on the fp32
    LayerNorm output (the port's ``layer_norm(..., out_scale)``; LN sums in
    another order, so a code in 1000 may differ there, by one)."""
    x, _, _ = _data(3)
    a = 0.0371
    np.testing.assert_array_equal(quant.quantize_static(_t(x), a).numpy(),
                                  np.asarray(_q8(jnp.asarray(x), 1.0 / a)))
    rng = np.random.RandomState(4)
    s, b = (1 + 0.1 * rng.randn(K)).astype(np.float32), (0.02 * rng.randn(K)).astype(np.float32)
    want = np.asarray(_q8(_ln_f32(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5), 1.0 / a))
    got = primitives.layer_norm_plain(_t(x), _t(s), _t(b), 1e-5, out_scale=a).numpy()
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.dtype == np.int8 and diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_mm_i8_matches_jax():
    """``_mm_i8`` of the JAX Q-Former kernel = quantize_rows + gemm_i8 with a
    row scale: codes and row scales bit-equal, the output to 1e-6."""
    x, w, b = _data(5)
    w8, ws = jquant.quantize_weight(jnp.asarray(w))
    want = np.asarray(_mm_i8(jnp.asarray(x), w8, ws, jnp.asarray(b)))
    x8, sc = quant.quantize_rows(_t(x))
    jsc = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x)), axis=-1), 1e-8) * (1.0 / 127.0)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    jx8 = jnp.clip(jnp.round(jnp.asarray(x) / jsc[:, None]), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(x8.numpy(), np.asarray(jx8))
    p8, ps = quant.quantize_weight(_t(w.T))
    got = primitives.gemm_i8_plain(x8, p8, ps, _t(b), row_scale=sc)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
    raw = primitives.gemm_i8_plain(x8, p8)  # the raw s32 product is exact
    assert raw.dtype == torch.int32
    np.testing.assert_array_equal(raw.numpy(), x8.numpy().astype(np.int64)
                                  @ p8.numpy().astype(np.int64).T)


def test_bf16_tower_codes_come_from_the_fp32_source():
    cfg = ViTConfig(image_size=28, patch_size=14, width=128, depth=2, num_heads=2,
                    mlp_hidden=256, use_ln_pre=True, quick_gelu=True, patch_bias=False,
                    dtype=torch.bfloat16, quant="int8")
    rng = np.random.RandomState(6)
    tower = ClipViT(cfg)
    state = {k: _t((rng.randn(*v.shape) * 0.05).astype(np.float32))
             for k, v in tower.state_dict().items()}
    tower.load_state_dict(state, strict=True)
    differ = 0
    for i, block in enumerate(tower.transformer.resblocks):
        pre = f"transformer.resblocks.{i}."
        for mod, name, key in ((block.attn, "in_proj", "attn.in_proj_weight"),
                               (block.attn.out_proj, "weight", "attn.out_proj.weight"),
                               (block.mlp.c_fc, "weight", "mlp.c_fc.weight"),
                               (block.mlp.c_proj, "weight", "mlp.c_proj.weight")):
            w = state[pre + key]
            j8, js = jquant.quantize_weight(jnp.asarray(w.numpy().T))
            p8, ps = quant.int8_weight(mod, name)
            np.testing.assert_array_equal(p8.numpy(), np.asarray(j8).T)
            np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
            differ += int((quant.quantize_weight(w.to(torch.bfloat16))[0] != p8).sum())
    assert differ > 0  # quantising the bf16 copy would have flipped codes
    # the seeded init derives them from the fp32 draw as well: the bf16 and
    # the fp32 model of one seed hold the same codes
    qcfg = QFormerConfig(vocab_size=60, hidden_size=128, num_layers=2, num_heads=2,
                         intermediate_size=256, encoder_width=128, query_length=4)
    kw = dict(device="cpu", seed=3, vit_config_override=cfg, vit_quant="int8", image_size=28,
              qformer_config_override=qcfg, num_query_token=4, vocab_size=60)
    bf = load_model("blip2_cir_align_prompt", **kw)
    fp = load_model("blip2_cir_align_prompt", **{
        **kw, "vit_config_override": ViTConfig(**{**cfg.__dict__, "dtype": torch.float32})})
    b0, f0 = (m.visual_encoder.transformer.resblocks[0].mlp.c_fc for m in (bf, fp))
    assert b0.weight.dtype == torch.bfloat16 and f0.weight.dtype == torch.float32
    np.testing.assert_array_equal(quant.int8_weight(b0, "weight")[0].numpy(),
                                  quant.quantize_weight(f0.weight)[0].numpy())
