"""JAX parameter tree -> the port's state dict.

``state_dict_from_jax(params_np, vit="clip_L" | "eva_clip_g")`` takes the flagship's JAX
parameter pytree (nested dicts of numpy arrays, e.g.
``jax.tree_util.tree_map(np.asarray, params)``) and returns reference-named
torch tensors, the same keys and layouts as
``sprc_tpu/interop/torch_export.py::params_to_torch_state_dict``. The
rerank model's frozen twin (``fformer``, ``query_tokens_f``,
``vision_proj_f``, ``text_proj_f``) goes to ``Fformer.bert.*`` and the
``*_f`` names, the variants' own leaves (``rel_tokens`` of
``blip2_cir_neg_rel``, ``temp2`` of ``blip2_cir_cls``) by their names, and
BLIP-2 stage 1's ``lm_head`` to ``Qformer.cls.predictions.*`` (the
reference's names), the stage-2 heads' ``opt`` / ``t5`` towers to HF's
names under ``opt_model.`` / ``t5_model.`` (:func:`opt_from_jax`,
:func:`t5_from_jax`) with ``opt_proj`` / ``t5_proj``, the instruct models'
``llm`` to HF's LLaMA names under ``llm_model.`` (:func:`llama_from_jax`)
with ``llm_proj`` / ``l2q_proj``, a Q-Former with or without its text side
(the caption heads' has none) as it is, ``itm_head`` wherever the tree holds
it (a JAX tree holds it only after a ``compute_itm`` / rerank init, or an init of a variant whose training
forward runs it: ``CirRerank``, ``CirNeg``, ``CirNegRel``, ``CirFull``). Dense
kernels ``[in, out]`` become weights ``[out, in]``, the HWIO patch conv
becomes OIHW, and the BERT ``position_ids`` buffer is emitted.

The ViT blocks come in two layouts. Unscanned trees hold
``trunk/block_{i}``; full-size configs use ``scan_blocks=True`` and hold ONE
``trunk/blocks/block`` subtree whose leaves carry a leading depth axis.
``torch_export`` iterates only ``block_{i}`` keys and so drops every block
of a scanned tree without a word; this bridge reads both layouts, and its
result is meant for ``load_state_dict(..., strict=True)``, which fails on a
missing block.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _linear(out: Dict[str, np.ndarray], name: str, p: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = _np(p["kernel"]).T
    if "bias" in p:
        out[f"{name}.bias"] = _np(p["bias"])


def _ln(out: Dict[str, np.ndarray], name: str, p: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = _np(p["scale"])
    out[f"{name}.bias"] = _np(p["bias"])


def _index_tree(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return _np(tree)[i]


def _vit_blocks(trunk: Mapping[str, Any]) -> Iterator[Tuple[int, Mapping[str, Any]]]:
    """(index, block params) for an unscanned or a scanned ViT trunk."""
    if "blocks" in trunk:
        stacked = trunk["blocks"]["block"]
        depth = _np(stacked["norm1"]["scale"]).shape[0]
        for i in range(depth):
            yield i, _index_tree(stacked, i)
        return
    for key, block in trunk.items():
        if key.startswith("block_"):
            yield int(key.split("_")[1]), block


def clip_vit_from_jax(params: Mapping[str, Any], prefix: str = "visual_encoder.") -> Dict[str, np.ndarray]:
    """ClipViT params (``{"trunk": ...}``) -> reference-named numpy arrays."""
    out: Dict[str, np.ndarray] = {}
    trunk = params["trunk"]
    out[f"{prefix}class_embedding"] = _np(trunk["cls_token"]).reshape(-1)
    out[f"{prefix}positional_embedding"] = _np(trunk["pos_embed"])[0]
    out[f"{prefix}conv1.weight"] = _np(trunk["patch_embed"]["proj"]["kernel"]).transpose(3, 2, 0, 1)
    _ln(out, f"{prefix}ln_pre", trunk["ln_pre"])
    for i, block in _vit_blocks(trunk):
        bp = f"{prefix}transformer.resblocks.{i}."
        _ln(out, f"{bp}ln_1", block["norm1"])
        out[f"{bp}attn.in_proj_weight"] = _np(block["attn"]["qkv"]["kernel"]).T
        out[f"{bp}attn.in_proj_bias"] = _np(block["attn"]["qkv"]["bias"])
        _linear(out, f"{bp}attn.out_proj", block["attn"]["proj"])
        _ln(out, f"{bp}ln_2", block["norm2"])
        _linear(out, f"{bp}mlp.c_fc", block["mlp_fc1"])
        _linear(out, f"{bp}mlp.c_proj", block["mlp_fc2"])
    return out


def eva_vit_from_jax(params: Mapping[str, Any], prefix: str = "visual_encoder.") -> Dict[str, np.ndarray]:
    """EvaViT params (``{"trunk": ...}``) -> reference-named numpy arrays, the
    keys of ``torch_export.eva_vit_to_torch`` (and every block of a scanned
    tree, which that function drops)."""
    out: Dict[str, np.ndarray] = {}
    trunk = params["trunk"]
    out[f"{prefix}cls_token"] = _np(trunk["cls_token"])
    out[f"{prefix}pos_embed"] = _np(trunk["pos_embed"])
    out[f"{prefix}patch_embed.proj.weight"] = _np(
        trunk["patch_embed"]["proj"]["kernel"]).transpose(3, 2, 0, 1)
    out[f"{prefix}patch_embed.proj.bias"] = _np(trunk["patch_embed"]["proj"]["bias"])
    for i, block in _vit_blocks(trunk):
        bp = f"{prefix}blocks.{i}."
        _ln(out, f"{bp}norm1", block["norm1"])
        out[f"{bp}attn.qkv.weight"] = _np(block["attn"]["qkv"]["kernel"]).T
        out[f"{bp}attn.q_bias"] = _np(block["attn"]["q_bias"])
        out[f"{bp}attn.v_bias"] = _np(block["attn"]["v_bias"])
        _linear(out, f"{bp}attn.proj", block["attn"]["proj"])
        _ln(out, f"{bp}norm2", block["norm2"])
        _linear(out, f"{bp}mlp.fc1", block["mlp_fc1"])
        _linear(out, f"{bp}mlp.fc2", block["mlp_fc2"])
    return out


def qformer_layer_from_jax(layer: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """One QFormerLayer's params -> reference-named numpy arrays."""
    out: Dict[str, np.ndarray] = {}
    branches = [("attention", layer["self_attn"])]
    if "cross_attn" in layer:
        branches.append(("crossattention", layer["cross_attn"]))
    for name, att in branches:
        for proj in ("query", "key", "value"):
            _linear(out, f"{prefix}{name}.self.{proj}", att[proj])
        _linear(out, f"{prefix}{name}.output.dense", att["out"])
        _ln(out, f"{prefix}{name}.output.LayerNorm", att["ln"])
    for suffix, key in (("", "ffn_text"), ("_query", "ffn_query")):
        if key not in layer:  # the LLM heads' trunk has no text FFN
            continue
        ffn = layer[key]
        _linear(out, f"{prefix}intermediate{suffix}.dense", ffn["fc1"])
        _linear(out, f"{prefix}output{suffix}.dense", ffn["fc2"])
        _ln(out, f"{prefix}output{suffix}.LayerNorm", ffn["ln"])
    return out


def qformer_from_jax(params: Mapping[str, Any], prefix: str = "Qformer.bert.") -> Dict[str, np.ndarray]:
    """QFormer params -> reference-named numpy arrays (with position_ids)."""
    out: Dict[str, np.ndarray] = {}
    emb = params["embeddings"]
    if "word_embeddings" in emb:  # the LLM heads' trunk has no text side
        out[f"{prefix}embeddings.word_embeddings.weight"] = _np(
            emb["word_embeddings"]["embedding"])
        pos = _np(emb["position_embeddings"]["embedding"])
        out[f"{prefix}embeddings.position_embeddings.weight"] = pos
        out[f"{prefix}embeddings.position_ids"] = np.arange(pos.shape[0], dtype=np.int64)[None]
    _ln(out, f"{prefix}embeddings.LayerNorm", emb["ln"])
    for key, layer in params.items():
        if not key.startswith("layer_"):
            continue
        out.update(qformer_layer_from_jax(layer, f"{prefix}encoder.layer.{int(key.split('_')[1])}."))
    return out


def opt_from_jax(params: Mapping[str, Any], prefix: str = "opt_model.") -> Dict[str, np.ndarray]:
    """``OPTForCausalLM`` params -> HF-named arrays (the LM head is tied: no key)."""
    out: Dict[str, np.ndarray] = {}
    dp = f"{prefix}model.decoder."
    out[f"{dp}embed_tokens.weight"] = _np(params["embed_tokens"]["embedding"])
    out[f"{dp}embed_positions.weight"] = _np(params["embed_positions"]["embedding"])
    _ln(out, f"{dp}final_layer_norm", params["final_ln"])
    for key, layer in params.items():
        if not key.startswith("layer_"):
            continue
        lp = f"{dp}layers.{int(key.split('_')[1])}."
        _ln(out, f"{lp}self_attn_layer_norm", layer["self_attn_ln"])
        _ln(out, f"{lp}final_layer_norm", layer["final_ln"])
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(out, f"{lp}self_attn.{proj}", layer["attn"][proj])
        _linear(out, f"{lp}fc1", layer["fc1"])
        _linear(out, f"{lp}fc2", layer["fc2"])
    return out


def _rms(out: Dict[str, np.ndarray], name: str, p: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = _np(p["scale"])


def t5_from_jax(params: Mapping[str, Any], prefix: str = "t5_model.") -> Dict[str, np.ndarray]:
    """``T5ForConditionalGeneration`` params -> HF-named arrays: each stack's
    ``rel_bias`` table goes to its first block's
    ``SelfAttention.relative_attention_bias``."""
    out: Dict[str, np.ndarray] = {}
    out[f"{prefix}shared.weight"] = _np(params["shared"]["embedding"])
    if "lm_head" in params:
        _linear(out, f"{prefix}lm_head", params["lm_head"])
    for side in ("encoder", "decoder"):
        stack, sp = params[side], f"{prefix}{side}."
        _rms(out, f"{sp}final_layer_norm", stack["final_ln"])
        out[f"{sp}block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = _np(
            stack["rel_bias"]["embedding"])
        for key, block in stack.items():
            if not key.startswith("block_"):
                continue
            bp = f"{sp}block.{int(key.split('_')[1])}.layer."
            parts = [("0", "self_ln", "SelfAttention", "self_attn")]
            if "cross_attn" in block:
                parts.append(("1", "cross_ln", "EncDecAttention", "cross_attn"))
            for idx, ln, name, att in parts:
                _rms(out, f"{bp}{idx}.layer_norm", block[ln])
                for proj in ("q", "k", "v", "o"):
                    _linear(out, f"{bp}{idx}.{name}.{proj}", block[att][proj])
            ff = str(len(parts))
            _rms(out, f"{bp}{ff}.layer_norm", block["ff_ln"])
            for proj, p in block["ff"].items():
                _linear(out, f"{bp}{ff}.DenseReluDense.{proj}", p)
    return out


def llama_from_jax(params: Mapping[str, Any], prefix: str = "llm_model.") -> Dict[str, np.ndarray]:
    """``LlamaForCausalLM`` params -> HF-named arrays; ``lm_head`` where the
    tree holds it (a JAX init through the retrieval forward makes none)."""
    out: Dict[str, np.ndarray] = {}
    mp = f"{prefix}model."
    out[f"{mp}embed_tokens.weight"] = _np(params["embed_tokens"]["embedding"])
    _rms(out, f"{mp}norm", params["model"]["norm"])
    for key, layer in params["model"].items():
        if not key.startswith("layer_"):
            continue
        lp = f"{mp}layers.{int(key.split('_')[1])}."
        _rms(out, f"{lp}input_layernorm", layer["input_ln"])
        _rms(out, f"{lp}post_attention_layernorm", layer["post_ln"])
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _linear(out, f"{lp}self_attn.{proj}", layer["attn"][proj])
        for proj in ("gate_proj", "up_proj", "down_proj"):
            _linear(out, f"{lp}mlp.{proj}", layer["mlp"][proj])
    if "lm_head" in params:
        _linear(out, f"{prefix}lm_head", params["lm_head"])
    return out


def to_torch(arrays: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in arrays.items()}


def state_dict_from_jax(params_np: Mapping[str, Any], *, vit: str = "clip_L") -> Dict[str, torch.Tensor]:
    """A CIR model's JAX params -> reference-named state dict of torch tensors."""
    if vit not in ("clip_L", "eva_clip_g"):
        raise ValueError(f"vit {vit!r}: expected 'clip_L' or 'eva_clip_g'")
    tower = clip_vit_from_jax if vit == "clip_L" else eva_vit_from_jax
    out = tower(params_np["visual_encoder"])
    _ln(out, "ln_vision", params_np["ln_vision"])
    out.update(qformer_from_jax(params_np["qformer"]))
    if "fformer" in params_np:  # the rerank model's frozen twin
        out.update(qformer_from_jax(params_np["fformer"], "Fformer.bert."))
    for name in ("query_tokens", "prompt_tokens", "query_tokens_f", "rel_tokens", "temp",
                 "temp2"):
        if name in params_np:
            out[name] = _np(params_np[name])
    if "opt" in params_np:  # the BLIP-2 LLM heads' towers
        out.update(opt_from_jax(params_np["opt"]))
    if "t5" in params_np:
        out.update(t5_from_jax(params_np["t5"]))
    if "llm" in params_np:  # the instruct models' LLaMA
        out.update(llama_from_jax(params_np["llm"]))
    for name in ("vision_proj", "text_proj", "itm_head", "vision_proj_f", "text_proj_f",
                 "opt_proj", "t5_proj", "llm_proj", "l2q_proj"):
        if name in params_np:
            _linear(out, name, params_np[name])
    if "lm_head" in params_np:  # BLIP-2 stage 1's QFormerLMHead
        head, prefix = params_np["lm_head"], "Qformer.cls.predictions."
        _linear(out, f"{prefix}transform.dense", head["transform"])
        _ln(out, f"{prefix}transform.LayerNorm", head["ln"])
        _linear(out, f"{prefix}decoder", head["decoder"])
    return to_torch(out)
