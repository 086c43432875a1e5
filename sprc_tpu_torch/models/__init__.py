"""Model modules of the port; importing this package registers them."""

from sprc_tpu_torch.models import blip2_stage1, cir_align_prompt, cir_variants  # noqa: F401
