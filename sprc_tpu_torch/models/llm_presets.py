"""The LLM towers' dimensions by the reference's HF model names
(counterpart of ``sprc_tpu/models/llm_presets.py``).

The model YAMLs name their language tower by its hub name
(``opt_model: "facebook/opt-2.7b"``, ``t5_model: "google/flan-t5-xl"``);
without a download the architecture is what is needed, so the dimensions of
each published ``config.json`` are pinned here, table for table as in the
JAX package (a test holds them equal), and :mod:`sprc_tpu_torch.loader`
resolves the YAML keys through :data:`LLM_KEYS` (``llm_model``: LLaMA /
Vicuna, whose 32001-word vocabulary counts Vicuna's pad token). Every
tower is fp32, as the JAX presets leave each config's dtype at its default.
"""

from __future__ import annotations

import re

from sprc_tpu_torch.models.llama import LlamaConfig
from sprc_tpu_torch.models.opt import OPTConfig
from sprc_tpu_torch.models.t5 import T5Config


def t5_preset(name: str) -> T5Config:
    """flan-t5 dims (HF google/flan-t5-* config.json)."""
    short = name.split("/")[-1].lower()
    # unifiedqa-v2 checkpoints fine-tune the original T5 of the same size
    m = re.match(r"unifiedqa(?:-v2)?-(t5-[a-z0-9]+)", short)
    if m:
        short = m.group(1)
    table = {
        # d_model, d_kv, d_ff, heads, layers
        "flan-t5-small": (512, 64, 1024, 6, 8),
        "flan-t5-base": (768, 64, 2048, 12, 12),
        "flan-t5-large": (1024, 64, 2816, 16, 24),
        "flan-t5-xl": (2048, 64, 5120, 32, 24),
        "flan-t5-xxl": (4096, 64, 10240, 64, 24),
        # v1.0 (relu, tied embeddings): the PNP-VQA FiD reader bases
        "t5-base": (768, 64, 3072, 12, 12),
        "t5-large": (1024, 64, 4096, 16, 24),
        "t5-3b": (1024, 128, 16384, 32, 24),
    }
    if short not in table:
        raise KeyError(f"unknown t5_model {name!r}; known: {sorted(table)}")
    d_model, d_kv, d_ff, heads, layers = table[short]
    v1 = not short.startswith("flan")
    return T5Config(d_model=d_model, d_kv=d_kv, d_ff=d_ff, num_heads=heads, num_layers=layers,
                    num_decoder_layers=layers, gated_act=not v1, tie_word_embeddings=v1)


def opt_preset(name: str) -> OPTConfig:
    """OPT dims (HF facebook/opt-* config.json)."""
    short = name.split("/")[-1].lower()
    table = {
        # hidden, ffn, layers, heads
        "opt-125m": (768, 3072, 12, 12),
        "opt-1.3b": (2048, 8192, 24, 32),
        "opt-2.7b": (2560, 10240, 32, 32),
        "opt-6.7b": (4096, 16384, 32, 32),
    }
    if short not in table:
        raise KeyError(f"unknown opt_model {name!r}; known: {sorted(table)}")
    hidden, ffn, layers, heads = table[short]
    return OPTConfig(hidden_size=hidden, ffn_dim=ffn, num_layers=layers, num_heads=heads)


def llama_preset(name: str) -> LlamaConfig:
    """LLaMA / Vicuna dims (HF config.json; Vicuna adds a pad token: vocabulary
    32001, reference blip2_vicuna_instruct.py's tokenizer setup)."""
    short = name.split("/")[-1].lower()
    table = {
        # hidden, intermediate, layers, heads, vocab
        "vicuna-7b-v1.1": (4096, 11008, 32, 32, 32001),
        "vicuna-7b": (4096, 11008, 32, 32, 32001),
        "vicuna-13b-v1.1": (5120, 13824, 40, 40, 32001),
        "vicuna-13b": (5120, 13824, 40, 40, 32001),
        "llama-7b": (4096, 11008, 32, 32, 32000),
        "llama-13b": (5120, 13824, 40, 40, 32000),
    }
    if short not in table:
        raise KeyError(f"unknown llm_model {name!r}; known: {sorted(table)}")
    hidden, inter, layers, heads, vocab = table[short]
    return LlamaConfig(hidden_size=hidden, intermediate_size=inter, num_layers=layers,
                       num_heads=heads, vocab_size=vocab)


# YAML model-section key -> (the model's construction keyword, its resolver);
# the keys are the reference YAMLs'
LLM_KEYS = {
    "t5_model": ("t5_config", t5_preset),
    "opt_model": ("opt_config", opt_preset),
    "llm_model": ("llama_config", llama_preset),
}
