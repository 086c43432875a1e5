"""BLIP-1's captioner and CIR feature extractor, and CLIP, on the card: K2
through ``FusedViTBlock`` at the large captioner's ViT-L/16 (B = 32, S =
577) with its bf16 attention and K3 at the CIR extractor's text pass
(``kernel_checks.run_blip_caption``); K2 in fp32 at CLIP ViT-L/14-336's
shapes and ViT-B/32's S = 50 with their fp32 attention
(``kernel_checks.run_clip``); and tiny models whose paths launch the
kernels: a CLIP ViT tower (K2 once a block at S = 50) and a
``blip_cir_base`` text pass (K3 once a layer), against all-plain.

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_caption_clip_cuda.py -m cuda
"""

import pytest
import torch

from sprc_tpu_torch import kernel_checks

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.mark.parametrize("run", ["run_blip_caption", "run_clip"])
def test_checks_at_the_slice_shapes(cuda, run):
    rows = getattr(kernel_checks, run)(cuda)
    assert rows
    bad = [r for r in rows if not r["ok"]]
    assert not bad, bad


def test_tiny_clip_and_cir_paths_launch_their_kernels(cuda):
    """A 2-block CLIP ViT-B-wide tower in fp32 at 64 px, patch 32 (S = 5)
    launches K2 twice and its features agree with all-plain within 1e-4 of
    their scale; a 2-layer ``blip_cir_base`` text pass launches K3 twice and
    agrees within 1e-4."""
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.ops.fused_block import fused_vit_block
    from sprc_tpu_torch.ops.fused_qformer import fused_qformer_layer

    gen = torch.Generator(device=cuda).manual_seed(5)
    clip = loader.load_model("clip", "vit_base32", device=cuda, seed=0, embed_dim=64,
                             image_size=64,
                             vision=dict(image_size=64, patch_size=32, width=768, depth=2,
                                         num_heads=12, mlp_hidden=3072, layer_norm_eps=1e-5,
                                         use_ln_pre=True, quick_gelu=True, final_norm=True,
                                         patch_bias=False, dtype="fp32"),
                             text=dict(vocab_size=64, width=64, layers=1, heads=2,
                                       context_length=8))
    images = torch.rand(3, 64, 64, 3, device=cuda, generator=gen)
    with torch.inference_mode():
        before = fused_vit_block.launches
        got = clip.encode_image(images)
        launched = fused_vit_block.launches - before
        with primitives.plain_reference():
            want = clip.encode_image(images)
    assert launched == 2
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    cir = loader.load_model("blip_cir_base", "base", device=cuda, seed=0, image_size=64,
                            num_prompts=4,
                            vit_config_override=dict(image_size=64, patch_size=16, width=64,
                                                     depth=1, num_heads=1, mlp_hidden=128,
                                                     final_norm=True, dtype="bf16"),
                            text_config_override=dict(vocab_size=64, hidden_size=768,
                                                      num_layers=2, num_heads=12,
                                                      intermediate_size=3072, encoder_width=64,
                                                      query_length=4, cross_attention_freq=1))
    ids = torch.randint(5, 64, (3, 9), device=cuda, generator=gen)
    mask = torch.ones(3, 9, dtype=torch.int32, device=cuda)
    mask[1, 6:] = 0
    prompts = 0.02 * torch.randn(3, 4, 768, device=cuda, generator=gen)
    with torch.inference_mode():
        before = fused_qformer_layer.launches
        got = cir.extract_cir_txt_feats(ids, mask, prompts)
        launched = fused_qformer_layer.launches - before
        with primitives.plain_reference():
            want = cir.extract_cir_txt_feats(ids, mask, prompts)
    assert launched == 2
    assert (got - want).abs().max() <= 1e-4
