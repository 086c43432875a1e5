"""Model modules of the port; importing this package registers them."""

from sprc_tpu_torch.models import (blip2_opt, blip2_stage1, blip2_t5, cir_align_prompt,  # noqa: F401
                                   cir_variants, instruct_cir)
