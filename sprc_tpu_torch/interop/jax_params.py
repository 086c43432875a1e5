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
forward runs it: ``CirRerank``, ``CirNeg``, ``CirNegRel``, ``CirFull``).
The momentum-queue families have :func:`albef_retrieval_from_jax`,
:func:`blip_retrieval_from_jax` (their pretraining heads included) and
:func:`momentum_state_from_jax` (JAX's ``params_m`` and queues); BLIP-1 /
ALBEF's VQA, classification and NLVR models have :func:`vqa_from_jax`,
:func:`classifier_from_jax`, :func:`nlvr_from_jax` (BLIP's twin
cross-attention and merge, ALBEF's tied cross key / value under both layers
of a pair) and :func:`momentum_copies_from_jax` (their ``params_m``).
BLIP-1's CIR feature extractor has :func:`blip_cir_base_from_jax`, CLIP
(ViT or RN50 tower) :func:`clip_from_jax`, ALPRO (its TimeSformer trunk,
:func:`timesformer_from_jax`; the med-BERT without cross-attention; the
retrieval heads or LAVIS's ``classifier.0`` / ``classifier.2``)
:func:`alpro_from_jax`. The GPT-2 video dialogue has
:func:`gpt_dialogue_from_jax` (HF's GPT-2 names under ``transformer.``, the
Conv1D kernels ``[in, out]`` as they are) and the Q-Former LM
:func:`qformer_lm_from_jax` (``bert.`` and ``cls.predictions.``).
PNP-VQA's three models have their own: :func:`blip_itm_from_jax`,
:func:`blip_caption_from_jax` (BLIP-1's timm tower and med-BERTs under
LAVIS's names), :func:`fid_t5_from_jax` and Img2Prompt's plain T5,
:func:`plain_t5_from_jax`. Dense
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
    tree, which that function drops). BLIP-1's timm tower (a ``ClipViT``
    tree with ``final_norm``: packed qkv with its bias, the final ``norm``)
    takes the same names, its qkv bias and ``norm`` for EVA's q / v biases."""
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
        _linear(out, f"{bp}attn.qkv", block["attn"]["qkv"])
        if "q_bias" in block["attn"]:
            out[f"{bp}attn.q_bias"] = _np(block["attn"]["q_bias"])
            out[f"{bp}attn.v_bias"] = _np(block["attn"]["v_bias"])
        _linear(out, f"{bp}attn.proj", block["attn"]["proj"])
        _ln(out, f"{bp}norm2", block["norm2"])
        _linear(out, f"{bp}mlp.fc1", block["mlp_fc1"])
        _linear(out, f"{bp}mlp.fc2", block["mlp_fc2"])
    if "norm" in trunk:
        _ln(out, f"{prefix}norm", trunk["norm"])
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


def med_from_jax(params: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """A ``MedEncoder`` tree (``word_embeddings``, ``embeddings_ln``,
    ``layer_{i}_self`` / ``_cross`` / ``_ffn``) -> med.py's names under
    ``prefix`` (with ``position_ids``)."""
    out: Dict[str, np.ndarray] = {}
    out[f"{prefix}embeddings.word_embeddings.weight"] = _np(params["word_embeddings"]["embedding"])
    pos = _np(params["position_embeddings"]["embedding"])
    out[f"{prefix}embeddings.position_embeddings.weight"] = pos
    out[f"{prefix}embeddings.position_ids"] = np.arange(pos.shape[0], dtype=np.int64)[None]
    _ln(out, f"{prefix}embeddings.LayerNorm", params["embeddings_ln"])
    layers = sorted({int(k.split("_")[1]) for k in params if k.startswith("layer_")})
    for i in layers:
        layer = {"self_attn": params[f"layer_{i}_self"], "ffn_text": params[f"layer_{i}_ffn"]}
        if f"layer_{i}_cross" in params:
            layer["cross_attn"] = params[f"layer_{i}_cross"]
        out.update(qformer_layer_from_jax(layer, f"{prefix}encoder.layer.{i}."))
    return out


def blip_itm_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``BlipITM`` tree -> the port's (LAVIS's) state dict."""
    out = eva_vit_from_jax(params["visual_encoder"])
    out.update(med_from_jax(params["text_encoder"], "text_encoder."))
    for name in ("vision_proj", "text_proj", "itm_head"):
        _linear(out, name, params[name])
    out["temp"] = _np(params["temp"]).reshape(())
    return to_torch(out)


def blip_caption_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``BlipCaption`` tree -> the port's state dict (the decoder under
    ``text_decoder.bert.``, its LM head under ``text_decoder.cls.predictions.``)."""
    out = eva_vit_from_jax(params["visual_encoder"])
    out.update(med_from_jax(params["text_decoder"], "text_decoder.bert."))
    head, prefix = params["lm_head"], "text_decoder.cls.predictions."
    _linear(out, f"{prefix}transform.dense", head["transform"])
    _ln(out, f"{prefix}transform.LayerNorm", head["ln"])
    _linear(out, f"{prefix}decoder", head["decoder"])
    return to_torch(out)


def blip_cir_base_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``BlipCirBase`` tree -> the port's (LAVIS's) state dict: the timm
    tower, the text-mode med-BERT under ``text_encoder.``, the projections
    and ``temp``."""
    out = eva_vit_from_jax(params["visual_encoder"])
    out.update(qformer_from_jax(params["text_encoder"], "text_encoder."))
    for name in ("vision_proj", "text_proj"):
        _linear(out, name, params[name])
    out["temp"] = _np(params["temp"]).reshape(())
    return to_torch(out)


def _conv(out: Dict[str, np.ndarray], name: str, p: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1)


def _bn(out: Dict[str, np.ndarray], name: str, p: Mapping[str, Any]) -> None:
    for key, jkey in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                      ("running_var", "var")):
        out[f"{name}.{key}"] = _np(p[jkey])


def clip_resnet_from_jax(params: Mapping[str, Any], prefix: str = "visual.") -> Dict[str, np.ndarray]:
    """A ``ClipResNet`` tree -> OpenAI's ``ModifiedResNet`` names under ``prefix``."""
    out: Dict[str, np.ndarray] = {}
    for i in (1, 2, 3):
        _conv(out, f"{prefix}conv{i}", params[f"conv{i}"])
        _bn(out, f"{prefix}bn{i}", params[f"bn{i}"])
    for key, block in params.items():
        if not key.startswith("layer"):
            continue
        stage, b = key[len("layer"):].split("_")
        bp = f"{prefix}layer{stage}.{b}."
        for i in (1, 2, 3):
            _conv(out, f"{bp}conv{i}", block[f"conv{i}"])
            _bn(out, f"{bp}bn{i}", block[f"bn{i}"])
        if "down_conv" in block:
            _conv(out, f"{bp}downsample.0", block["down_conv"])
            _bn(out, f"{bp}downsample.1", block["down_bn"])
    pool = params["attnpool"]
    out[f"{prefix}attnpool.positional_embedding"] = _np(pool["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _linear(out, f"{prefix}attnpool.{name}", pool[name])
    return out


def clip_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``Clip`` tree (ViT or RN50 tower) -> the port's (OpenAI's) state
    dict: packed qkv kernels transposed to ``in_proj_weight``, the two
    projections kept as ``x @ proj``."""
    visual = params["visual"]
    if "trunk" in visual:
        out = clip_vit_from_jax(visual, prefix="visual.")
        _ln(out, "visual.ln_post", visual["trunk"]["norm"])
        out["visual.proj"] = _np(params["visual_projection"]["kernel"])
    else:
        out = clip_resnet_from_jax(visual)
    text = params["text"]
    out["token_embedding.weight"] = _np(text["token_embedding"]["embedding"])
    out["positional_embedding"] = _np(text["positional_embedding"])
    _ln(out, "ln_final", text["ln_final"])
    for key, block in text.items():
        if not key.startswith("block_"):
            continue
        bp = f"transformer.resblocks.{int(key.split('_')[1])}."
        _ln(out, f"{bp}ln_1", block["norm1"])
        out[f"{bp}attn.in_proj_weight"] = _np(block["qkv"]["kernel"]).T
        out[f"{bp}attn.in_proj_bias"] = _np(block["qkv"]["bias"])
        _linear(out, f"{bp}attn.out_proj", block["proj"])
        _ln(out, f"{bp}ln_2", block["norm2"])
        _linear(out, f"{bp}mlp.c_fc", block["mlp_fc1"])
        _linear(out, f"{bp}mlp.c_proj", block["mlp_fc2"])
    out["text_projection"] = _np(params["text_projection"]["kernel"])
    out["logit_scale"] = _np(params["logit_scale"]).reshape(())
    return to_torch(out)


def _lm_head(out: Dict[str, np.ndarray], prefix: str, head: Mapping[str, Any]) -> None:
    _linear(out, f"{prefix}transform.dense", head["transform"])
    _ln(out, f"{prefix}transform.LayerNorm", head["ln"])
    _linear(out, f"{prefix}decoder", head["decoder"])


def _queue_model_arrays(params: Mapping[str, Any], text_prefix: str) -> Dict[str, np.ndarray]:
    """The subtrees of a BLIP-1 / ALBEF retrieval or pretraining tree that it
    holds -> LAVIS's names: the tower, the med-BERT under ``text_prefix``,
    the projections, ``itm_head``, ``temp``, ALBEF's MLM head
    (``text_encoder.cls.predictions.``) and BLIP-1's decoder with its LM
    head (``text_decoder.bert.``, ``text_decoder.cls.predictions.``)."""
    out: Dict[str, np.ndarray] = {}
    if "visual_encoder" in params:
        out.update(eva_vit_from_jax(params["visual_encoder"]))
    if "text_encoder" in params:
        out.update(med_from_jax(params["text_encoder"], text_prefix))
    for name in ("vision_proj", "text_proj", "itm_head"):
        if name in params:
            _linear(out, name, params[name])
    if "temp" in params:
        out["temp"] = _np(params["temp"]).reshape(())
    if "mlm_head" in params:
        _lm_head(out, "text_encoder.cls.predictions.", params["mlm_head"])
    if "text_decoder" in params:
        out.update(med_from_jax(params["text_decoder"], "text_decoder.bert."))
    if "lm_head" in params:
        _lm_head(out, "text_decoder.cls.predictions.", params["lm_head"])
    return out


def albef_retrieval_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An ``AlbefRetrieval`` or ``AlbefPretrain`` tree -> the port's state
    dict (the pretrainer's med-BERT under ``text_encoder.bert.``, its
    ``mlm_head`` under ``text_encoder.cls.predictions.``)."""
    prefix = "text_encoder.bert." if "mlm_head" in params else "text_encoder."
    return to_torch(_queue_model_arrays(params, prefix))


def blip_retrieval_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``BlipRetrieval`` or ``BlipPretrain`` tree (its ``text_decoder`` and
    ``lm_head``) -> the port's state dict."""
    return to_torch(_queue_model_arrays(params, "text_encoder."))


def momentum_state_from_jax(aux: Mapping[str, Any], model) -> Dict[str, Any]:
    """JAX's ``init_albef_state`` tree (``params_m``, the queues, ``ptr``)
    -> the port's aux state for ``model``: every name under the model's
    ``MOMENTUM_KEYS`` from ``params_m`` (a missing one raises), fp32; the
    queues fp32, ``idx_queue`` and ``ptr`` int64."""
    from sprc_tpu_torch.models.albef import momentum_names

    names = momentum_names(model)
    prefix = ("text_encoder.bert." if any(n.startswith("text_encoder.bert.") for n in names)
              else "text_encoder.")
    arrays = _queue_model_arrays(aux["params_m"], prefix)
    return {"params_m": {n: torch.from_numpy(np.array(arrays[n], np.float32)) for n in names},
            "image_queue": torch.from_numpy(np.array(aux["image_queue"], np.float32)),
            "text_queue": torch.from_numpy(np.array(aux["text_queue"], np.float32)),
            "idx_queue": torch.from_numpy(np.array(aux["idx_queue"], np.int64)),
            "ptr": torch.tensor(int(np.asarray(aux["ptr"])), dtype=torch.int64)}


def vqa_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``VQAModel`` tree (or the momentum copies' subtrees) -> the port's
    state dict: the question encoder under ``text_encoder.``, the answer
    decoder under ``text_decoder.bert.``, its LM head under
    ``text_decoder.cls.predictions.``."""
    out: Dict[str, np.ndarray] = {}
    if "visual_encoder" in params:
        out.update(eva_vit_from_jax(params["visual_encoder"]))
    if "text_encoder" in params:
        out.update(med_from_jax(params["text_encoder"], "text_encoder."))
    if "text_decoder" in params:
        out.update(med_from_jax(params["text_decoder"], "text_decoder.bert."))
    if "lm_head" in params:
        _lm_head(out, "text_decoder.cls.predictions.", params["lm_head"])
    return to_torch(out)


def _cls_head(out: Dict[str, np.ndarray], params: Mapping[str, Any]) -> None:
    if "cls_head" in params:  # LAVIS's nn.Sequential: Linear, ReLU, Linear
        _linear(out, "cls_head.0", params["cls_head"]["fc1"])
        _linear(out, "cls_head.2", params["cls_head"]["fc2"])


def classifier_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``MultimodalClassifier`` tree -> the port's state dict."""
    out: Dict[str, np.ndarray] = {}
    if "visual_encoder" in params:
        out.update(eva_vit_from_jax(params["visual_encoder"]))
    if "text_encoder" in params:
        out.update(med_from_jax(params["text_encoder"], "text_encoder."))
    _cls_head(out, params)
    return to_torch(out)


def _nlvr_text(text: Mapping[str, Any], prefix: str = "text_encoder.") -> Dict[str, np.ndarray]:
    """``AlbefNLVRMed`` / ``BlipNLVRMed`` trees -> LAVIS's names: the tied
    ALBEF ``cross_key_{p}`` / ``cross_value_{p}`` under both layers of pair
    p, BLIP's twin ``cross{t}_*`` under ``crossattention.self{t}`` and
    ``output.dense{t}``, its ``merge`` under ``output.merge_layer``."""
    out: Dict[str, np.ndarray] = {}
    emb = text["embeddings"]
    out[f"{prefix}embeddings.word_embeddings.weight"] = _np(emb["word_embeddings"]["embedding"])
    pos = _np(emb["position_embeddings"]["embedding"])
    out[f"{prefix}embeddings.position_embeddings.weight"] = pos
    out[f"{prefix}embeddings.position_ids"] = np.arange(pos.shape[0], dtype=np.int64)[None]
    _ln(out, f"{prefix}embeddings.LayerNorm", emb["ln"])
    layers = sorted({int(k.split("_")[1]) for k in text if k.startswith("layer_")})
    cross = [i for i in layers if f"layer_{i}_cross_query" in text]
    for i in layers:
        lp = f"{prefix}encoder.layer.{i}."
        out.update(qformer_layer_from_jax({"self_attn": text[f"layer_{i}_self"],
                                           "ffn_text": text[f"layer_{i}_ffn"]}, lp))
        cp = f"{lp}crossattention."
        if f"layer_{i}_cross0_query" in text:  # BLIP: twin cross-attention
            for t in (0, 1):
                for proj in ("query", "key", "value"):
                    _linear(out, f"{cp}self{t}.{proj}", text[f"layer_{i}_cross{t}_{proj}"])
                _linear(out, f"{cp}output.dense{t}", text[f"layer_{i}_cross_dense{t}"])
            if f"layer_{i}_merge" in text:
                _linear(out, f"{cp}output.merge_layer", text[f"layer_{i}_merge"])
            _ln(out, f"{cp}output.LayerNorm", text[f"layer_{i}_cross_ln"])
        elif i in cross:  # ALBEF: the pair's tied key / value
            pair = (i - cross[0]) // 2
            _linear(out, f"{cp}self.query", text[f"layer_{i}_cross_query"])
            _linear(out, f"{cp}self.key", text[f"cross_key_{pair}"])
            _linear(out, f"{cp}self.value", text[f"cross_value_{pair}"])
            _linear(out, f"{cp}output.dense", text[f"layer_{i}_cross_out"])
            _ln(out, f"{cp}output.LayerNorm", text[f"layer_{i}_cross_ln"])
    return out


def nlvr_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An ``NLVRClassifier`` tree (either flavour) -> the port's state dict."""
    out: Dict[str, np.ndarray] = {}
    if "visual_encoder" in params:
        out.update(eva_vit_from_jax(params["visual_encoder"]))
    if "text_encoder" in params:
        out.update(_nlvr_text(params["text_encoder"]))
    _cls_head(out, params)
    return to_torch(out)


def momentum_copies_from_jax(aux: Mapping[str, Any], model, bridge) -> Dict[str, Any]:
    """JAX's ``init_vqa_state`` / ``init_classifier_state`` /
    ``init_nlvr_state`` tree (``params_m``) -> the port's aux state for
    ``model``: every name under its ``MOMENTUM_KEYS`` from ``bridge``
    (``vqa_from_jax``, ``classifier_from_jax`` or ``nlvr_from_jax``) over
    the copies, fp32 (a missing one raises)."""
    from sprc_tpu_torch.models.albef import momentum_names

    arrays = bridge(aux["params_m"])
    return {"params_m": {n: arrays[n].float() for n in momentum_names(model)}}


def plain_t5_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``T5ForConditionalGeneration`` tree (Img2Prompt's question
    generator) -> the port's state dict, HF's T5 names without a prefix."""
    return to_torch(t5_from_jax(params, prefix=""))


def fid_t5_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``FiDT5`` tree (``{"t5": ...}``) -> the port's state dict, HF's T5
    names without a prefix."""
    return to_torch(t5_from_jax(params["t5"], prefix=""))


def timesformer_from_jax(params: Mapping[str, Any],
                         prefix: str = "visual_encoder.") -> Dict[str, np.ndarray]:
    """A ``TimeSformer`` tree (``patch_embed``, ``cls_token``, ``pos_embed``,
    ``time_embed``, ``block_{i}``, ``norm``) -> LAVIS's names under
    ``prefix``, the patch conv HWIO -> OIHW."""
    out: Dict[str, np.ndarray] = {}
    _conv(out, f"{prefix}patch_embed.proj", params["patch_embed"])
    out[f"{prefix}patch_embed.proj.bias"] = _np(params["patch_embed"]["bias"])
    for name in ("cls_token", "pos_embed", "time_embed"):
        out[f"{prefix}{name}"] = _np(params[name])
    _ln(out, f"{prefix}norm", params["norm"])
    blocks = sorted(int(k.split("_")[1]) for k in params if k.startswith("block_"))
    for i in blocks:
        block, bp = params[f"block_{i}"], f"{prefix}blocks.{i}."
        for ln in ("temporal_norm1", "norm1", "norm2"):
            _ln(out, f"{bp}{ln}", block[ln])
        for attn in ("temporal_attn", "attn"):
            for proj in ("qkv", "proj"):
                _linear(out, f"{bp}{attn}.{proj}", block[attn][proj])
        _linear(out, f"{bp}temporal_fc", block["temporal_fc"])
        for fc in ("fc1", "fc2"):
            _linear(out, f"{bp}mlp.{fc}", block["mlp"][fc])
    return out


def alpro_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An ``AlproRetrieval`` or ``AlproQA`` tree -> the port's state dict:
    the trunk under ``visual_encoder.``, the med-BERT (no cross-attention)
    under ``text_encoder.``, the retrieval heads and ``temp`` or the QA
    classifier as LAVIS's ``classifier.0`` / ``classifier.2``."""
    out = timesformer_from_jax(params["visual_encoder"])
    out.update(med_from_jax(params["text_encoder"], "text_encoder."))
    for name in ("vision_proj", "text_proj", "itm_head"):
        if name in params:
            _linear(out, name, params[name])
    if "temp" in params:
        out["temp"] = _np(params["temp"]).reshape(())
    if "classifier_fc1" in params:
        _linear(out, "classifier.0", params["classifier_fc1"])
        _linear(out, "classifier.2", params["classifier_fc2"])
    return to_torch(out)


def gpt_dialogue_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``GPTDialogue`` tree -> the port's state dict: the trunk under HF's
    names (``transformer.h.{i}.attn.c_attn``, ``.mlp.c_fc``; the Conv1D
    weights ``[in, out]``, the JAX kernels' own layout), ``video_ff`` and
    ``video_ff_out`` as ``nn.Linear`` weights ``[out, in]``."""
    trunk = params["transformer"]
    out = {"transformer.wte.weight": _np(trunk["wte"]["embedding"]),
           "transformer.wpe.weight": _np(trunk["wpe"]["embedding"])}
    _ln(out, "transformer.ln_f", trunk["ln_f"])
    conv = {"c_attn": "attn.c_attn", "c_proj": "attn.c_proj", "mlp_fc": "mlp.c_fc",
            "mlp_proj": "mlp.c_proj"}
    for key, block in trunk.items():
        if not key.startswith("h_"):
            continue
        bp = f"transformer.h.{int(key[2:])}."
        _ln(out, f"{bp}ln_1", block["ln_1"])
        _ln(out, f"{bp}ln_2", block["ln_2"])
        for jname, name in conv.items():
            out[f"{bp}{name}.weight"] = _np(block[jname]["kernel"])
            out[f"{bp}{name}.bias"] = _np(block[jname]["bias"])
    _linear(out, "video_ff", params["video_ff"])
    _linear(out, "video_ff_out", params["video_ff_out"])
    return to_torch(out)


def qformer_lm_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``QFormerLM`` tree ({"qformer", "lm_head"}) -> the port's
    ``QFormerLM`` state dict (``bert.*``, ``cls.predictions.*``)."""
    out = qformer_from_jax(params["qformer"], "bert.")
    _lm_head(out, "cls.predictions.", params["lm_head"])
    return to_torch(out)


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
