"""Model modules of the port; importing this package registers them."""

from sprc_tpu_torch.models import (alpro, blip1, blip2_opt, blip2_stage1, blip2_t5,  # noqa: F401
                                   cir_align_prompt, cir_variants, classification, clip,
                                   gpt_dialogue, instruct_cir, nlvr, pnp_vqa, vqa)
