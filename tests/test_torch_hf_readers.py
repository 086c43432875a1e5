"""The HF and LAVIS checkpoint layouts that the port reads
(``loader.read_checkpoint``; Img2Prompt's ``finetuned:`` through
``pnp_vqa.plain_t5``) against the JAX readers followed by the weight bridge.

Each layout is written from a tiny port model with seeded weights, in the
layout its publisher saves: an HF ``t5-large`` (v1.0: ``shared.weight``, the
``encoder.`` / ``decoder.embed_tokens.weight`` aliases, with and without the
tied ``lm_head.weight``), an HF FlanT5 (v1.1, its own ``lm_head``), an HF
OPT (the tied ``lm_head.weight``, ``embed_positions`` with its two offset
rows), a whole ``blip2_vicuna_instruct`` checkpoint with its HF LLaMA under
``llm_model.`` (with ``rotary_emb.inv_freq`` buffers), and LAVIS's stage-2 ``blip2_opt`` / ``blip2_t5`` checkpoints
(``opt_model.`` / ``t5_model.`` subtrees, ``opt_proj`` / ``t5_proj``, no
``temp``). The port loads each with ``strict=True`` into the tensors that the
JAX reader (``t5_params_from_hf``, ``opt_params_from_hf``,
``llama_params_from_hf``, ``blip2_llm_params_from_torch``) and the bridge
(``sprc_tpu_torch/interop/jax_params.py``) give, bit for bit; a checkpoint
without one of its weights raises in both.

The JAX stage-2 reader also needs the Q-Former's text side (word and
position embeddings, each layer's text FFN), which LAVIS's stage-2 model
sets to None and the port has no module for: the LAVIS files here carry it
for the JAX reader, and the port reads them with and without it.
"""

import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from sprc_tpu_torch import loader  # noqa: E402
from sprc_tpu_torch.interop import jax_params  # noqa: E402
from test_torch_caption_cli import _run_config  # noqa: E402
from test_torch_pnp_vqa import T5  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

LAYOUTS = ("t5-large", "flan-t5", "opt", "llama", "lavis blip2_opt", "lavis blip2_t5")
OPT = dict(vocab_size=90, hidden_size=32, ffn_dim=64, num_layers=2, num_heads=4,
           max_positions=64)
LLAMA = dict(vocab_size=80, hidden_size=48, intermediate_size=96, num_layers=2, num_heads=4,
             num_kv_heads=2)
TEXT_SIDE = re.compile(r"Qformer\.bert\.(embeddings\.(word_embeddings|position_embeddings|"
                       r"position_ids)|encoder\.layer\.\d+\.(intermediate|output)\.)")


def _noisy(model, seed):
    """``init_weights(seed)`` with every parameter moved by seeded noise (no
    two weights equal by their init, a bias or norm in the wrong place shows)."""
    loader.init_weights(model, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return model.eval()


def _t5(name, seed):
    from sprc_tpu_torch.models.pnp_vqa import plain_t5

    return _noisy(plain_t5({"t5_model": name, **T5}, device="cpu", seed=seed), seed)


def _lavis_head(arch):
    """A tiny stage-2 head of the port (test_torch_caption_cli.py's
    configuration) and the JAX model of the same configuration."""
    from sprc_tpu.loader import build_model as jbuild

    section = dict(_run_config(arch, None, None)["model"])
    name, model_type = section.pop("arch"), section.pop("model_type")
    model = _noisy(loader.build_model(name, model_type, device="cpu", **section), 3)
    return model, jbuild(name, model_type, **section)


def layout(name):
    """(the port's model, the checkpoint as its publisher saves it (numpy),
    what the port loads it with, the JAX reader + bridge -> torch tensors by
    the port's names)."""
    from sprc_tpu.interop.lavis_import import blip2_llm_params_from_torch
    from sprc_tpu.models.llama import llama_params_from_hf
    from sprc_tpu.models.opt import opt_params_from_hf
    from sprc_tpu.models.t5 import t5_params_from_hf

    def read(model):
        return lambda path: model.load_state_dict(loader.read_checkpoint(path, model),
                                                  strict=True)

    if name in ("t5-large", "flan-t5"):
        from sprc_tpu_torch.models.pnp_vqa import plain_t5

        hub = "t5-large" if name == "t5-large" else "google/flan-t5-large"
        model = _t5(hub, 1)
        cfg = model.cfg
        sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
        for side in ("encoder", "decoder"):
            sd[f"{side}.embed_tokens.weight"] = sd["shared.weight"]
        if cfg.tie_word_embeddings:
            sd["lm_head.weight"] = sd["shared.weight"]

        def load(path):  # Img2Prompt's ``finetuned:`` sub-model
            model.load_state_dict(plain_t5({"t5_model": hub, **T5}, device="cpu", seed=0,
                                           path=path).state_dict(), strict=True)

        return model, sd, load, lambda sd: jax_params.plain_t5_from_jax(t5_params_from_hf(
            sd, num_layers=cfg.num_layers, num_decoder_layers=cfg.num_decoder_layers,
            gated_act=cfg.gated_act, tie_word_embeddings=cfg.tie_word_embeddings))
    if name == "opt":
        from sprc_tpu_torch.models.opt import OPTConfig, OPTForCausalLM

        model = _noisy(OPTForCausalLM(OPTConfig(**OPT)), 2)
        sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
        sd["lm_head.weight"] = sd["model.decoder.embed_tokens.weight"]
        assert sd["model.decoder.embed_positions.weight"].shape[0] == OPT["max_positions"] + 2
        return model, sd, read(model), lambda sd: jax_params.to_torch(jax_params.opt_from_jax(
            opt_params_from_hf(sd, num_layers=OPT["num_layers"]), prefix=""))
    if name == "llama":  # the whole model's file; the bridge gives its llm_model tensors
        from test_torch_instruct_cir import SECTION

        section = {**SECTION, "llama_config": LLAMA}
        model = _noisy(loader.build_model("blip2_vicuna_instruct", "vicuna7b", device="cpu",
                                          **section), 4)
        sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
        for i in range(LLAMA["num_layers"]):
            sd[f"llm_model.model.layers.{i}.self_attn.rotary_emb.inv_freq"] = np.ones(
                6, np.float32)
        return model, sd, read(model), lambda sd: jax_params.to_torch(jax_params.llama_from_jax(
            llama_params_from_hf(sd, num_layers=LLAMA["num_layers"], prefix="llm_model.")))
    arch = name.split()[1]
    model, jm = _lavis_head(arch)
    llm = "opt_model" if arch == "blip2_opt" else "t5_model"
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items() if k != "temp"}
    if arch == "blip2_opt":
        sd[f"{llm}.lm_head.weight"] = sd[f"{llm}.model.decoder.embed_tokens.weight"]
    else:
        for side in ("encoder", "decoder"):
            sd[f"{llm}.{side}.embed_tokens.weight"] = sd[f"{llm}.shared.weight"]
    rs = np.random.RandomState(5)  # the Q-Former's text side, for the JAX reader
    qcfg = model.qformer.cfg
    text = {"embeddings.word_embeddings.weight": (qcfg.vocab_size, qcfg.hidden_size),
            "embeddings.position_embeddings.weight": (qcfg.max_position_embeddings,
                                                      qcfg.hidden_size)}
    for i in range(qcfg.num_layers):
        lp = f"encoder.layer.{i}."
        text.update({f"{lp}intermediate.dense.weight": (qcfg.intermediate_size,
                                                        qcfg.hidden_size),
                     f"{lp}intermediate.dense.bias": (qcfg.intermediate_size,),
                     f"{lp}output.dense.weight": (qcfg.hidden_size, qcfg.intermediate_size),
                     f"{lp}output.dense.bias": (qcfg.hidden_size,),
                     f"{lp}output.LayerNorm.weight": (qcfg.hidden_size,),
                     f"{lp}output.LayerNorm.bias": (qcfg.hidden_size,)})
    for key, shape in text.items():
        sd[f"Qformer.bert.{key}"] = rs.randn(*shape).astype(np.float32)
    return model, sd, read(model), lambda sd: jax_params.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, blip2_llm_params_from_torch(sd, jm)),
        vit="eva_clip_g")


def _save(sd, path, lavis):
    state = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    torch.save({"model": state} if lavis else state, path)
    return str(path)


@pytest.mark.parametrize("name", LAYOUTS)
def test_layout_loads_as_the_jax_reader_reads_it(name, tmp_path):
    """The checkpoint loads with ``strict=True`` (every weight of the model
    from the file) into the tensors of the JAX reader + bridge, bit for
    bit (the instruct model's ``llm_model`` tensors, the rest as saved); the
    aliases, tied heads and buffers are dropped; LAVIS's heads get
    ``temp`` 0.07 as the JAX reader gives it, and read without the Q-Former's
    text side too; a ``t5-large`` file reads without its tied
    ``lm_head.weight`` too."""
    model, sd, load, jax_read = layout(name)
    want = model.state_dict()
    want = {k: v.clone() for k, v in want.items()}
    lavis = name.startswith("lavis")
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    load(_save(sd, tmp_path / "ckpt.pth", lavis))
    got = model.state_dict()
    bridged = jax_read(sd)
    llm_only = name == "llama"
    assert not llm_only or set(bridged) == {k for k in got if k.startswith("llm_model.")}
    for k, v in got.items():
        if not llm_only or k.startswith("llm_model."):
            assert torch.equal(v, bridged[k]), k
        if k != "temp":
            assert torch.equal(v, want[k]), k
    unread = {k for k in sd if k not in got}
    assert unread and all(k.endswith(("embed_tokens.weight", "lm_head.weight", "inv_freq"))
                          or TEXT_SIDE.match(k) for k in unread), unread
    extra = set(bridged) - set(got)
    assert all(TEXT_SIDE.match(k) for k in extra), extra
    if lavis:
        assert float(got["temp"]) == pytest.approx(0.07) and "temp" not in sd and extra
        sd = {k: v for k, v in sd.items() if not TEXT_SIDE.match(k)}  # LAVIS's own model
    elif name == "t5-large":
        del sd["lm_head.weight"]  # a v1.0 file without the tied head
    else:
        assert not extra
        return
    for p in model.parameters():
        p.data.zero_()
    load(_save(sd, tmp_path / "again.pth", lavis))
    assert all(torch.equal(v, got[k]) for k, v in model.state_dict().items())


def test_a_missing_weight_raises():
    """Each layout without one of its weights (a decoder FF, an OPT layer's
    fc2 bias, a LLaMA layer's up projection, the stage-2 ``t5_proj``): the
    port's strict load raises naming it, and the JAX reader raises too."""
    import tempfile

    missing = {"t5-large": "decoder.block.1.layer.2.DenseReluDense.wo.weight",
               "flan-t5": "lm_head.weight", "opt": "model.decoder.layers.1.fc2.bias",
               "llama": "llm_model.model.layers.0.mlp.up_proj.weight",
               "lavis blip2_opt": "opt_model.model.decoder.final_layer_norm.weight",
               "lavis blip2_t5": "t5_proj.weight"}
    with tempfile.TemporaryDirectory() as tmp:
        for name, key in missing.items():
            model, sd, load, jax_read = layout(name)
            assert key in sd, name
            del sd[key]
            with pytest.raises(RuntimeError, match=key.replace(".", r"\.")):
                load(_save(sd, f"{tmp}/{name}.pth", name.startswith("lavis")))
            with pytest.raises(KeyError):
                jax_read(sd)
