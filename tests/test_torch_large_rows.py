"""The largest BLIP-2 and InstructBLIP rows at full width: the port's model
has the JAX model's parameters, name for name and shape for shape.

Each row is built in the port on the meta device (no storage) and in JAX
through ``jax.eval_shape`` of its ``init`` (no storage either; the heads'
``__call__`` takes the LLM's ids as the existing LLM tests pass them). The
JAX tree is mapped to the port's names by
``interop/jax_params.state_dict_from_jax``, the key map that also moves
trained JAX weights into the port: its leaves here are zero-stride numpy
views of the abstract shapes, and its final copy into torch tensors is
skipped, so that Vicuna-13B's 52 GB are never allocated. The retrieval
model's JAX init runs no ``lm_head`` (its forward scores the LLaMA's hidden
states): the head's shape is grafted from ``LlamaForCausalLM``'s own
abstract init, as the JAX instruct test grafts its values.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROWS = [("blip2_opt", "caption_coco_opt6.7b"), ("blip2_opt", "pretrain_opt6.7b"),
        ("blip2_t5", "pretrain_flant5xxl"), ("blip2_t5", "pretrain_flant5xl_vitL"),
        ("blip2_t5_instruct", "flant5xl"), ("blip2_t5_instruct", "flant5xxl"),
        ("blip2_vicuna_instruct", "vicuna13b")]


def _views(tree):
    """An abstract tree's leaves as zero-stride numpy arrays of their shapes."""
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.dtype(s.dtype)), s.shape), tree)


def _jax_shapes(name, model_type):
    """{port name: shape} of the JAX row's init, and its parameter count."""
    from sprc_tpu.loader import build_model
    from sprc_tpu.models.llama import LlamaForCausalLM

    jm = build_model(name, model_type)
    size = jm.cfg.image_size
    img = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
    ids = jax.ShapeDtypeStruct((1, 4), jnp.int32)
    if name == "blip2_vicuna_instruct":  # reference, target, BERT ids and mask, LLaMA's
        args = (img, img, ids, ids, ids, ids)
    elif name == "blip2_opt":
        args = (img, ids, ids)
    else:  # Blip2T5: the prompt's ids and mask, the output's
        args = (img, ids, ids, ids, ids)
    params = dict(jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a), *args)["params"])
    if "llm" in params and "lm_head" not in params["llm"]:
        head = jax.eval_shape(lambda i: LlamaForCausalLM(jm.llama_config).init(
            jax.random.PRNGKey(1), i), ids)["params"]["lm_head"]
        params["llm"] = {**params["llm"], "lm_head": head}
    count = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(params))
    vit = "clip_L" if jm.cfg.vit_model == "clip_L" else "eva_clip_g"
    return params, count, vit


@pytest.mark.parametrize("name,model_type", ROWS)
def test_full_width_row_has_the_jax_parameters(name, model_type, monkeypatch):
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.interop import jax_params

    params, count, vit = _jax_shapes(name, model_type)
    monkeypatch.setattr(jax_params, "to_torch", dict)  # views, no copy
    want = {k: tuple(v.shape) for k, v in
            jax_params.state_dict_from_jax(_views(params), vit=vit).items()}
    model = loader.build_model(name, model_type, device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sorted(got) == sorted(want)
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == count
    assert count > 3e9  # the full widths, not a cut row

