"""Retrieval and generation with the BLIP-2 LLM heads (counterpart of
``sprc_tpu/cli/instruct.py``).

  # tiny random model, whitespace tokenizers, on the card or the CPU
  python -m sprc_tpu_torch.cli.instruct --model-name blip2_opt --synthetic [--device cpu]
  python -m sprc_tpu_torch.cli.instruct --model-name blip2_vicuna_instruct --synthetic

Ported: ``--synthetic`` for every name: the JAX CLI's tiny configuration
(28 px EVA-style tower of depth 2, a 2-layer Q-Former with 4 queries over a
60-word vocabulary, a 2-layer OPT, T5 or LLaMA over 80 words: the LLaMA of
width 48, FFN 96, 4 heads) with the tower and the Q-Former 128 wide with 2
heads (the JAX CLI's are 32 wide: head dim 16, which the attention kernel is
not built for; 64 is its smallest), random weights from seed 0 and inputs
from a seeded generator. ``blip2_vicuna_instruct`` runs the retrieval
branch: ``--n-gallery`` gallery images through ``extract_target_features``
and two composed queries (the BERT and the LLaMA side through whitespace
tokenizers) through ``inference``, and prints ``task``, ``sims_shape``,
``finite`` and ``top1``. The others generate greedily (KV-cached) after
``--prompt`` for ``--batch`` images: ``blip2_instruct_cir`` through
``instruct_generate``, ``blip2_opt`` / ``blip2_t5`` through
``generate_ids``; one JSON line with the decoded outputs. Without
``--synthetic`` the command refuses, as the JAX CLI does (no weights or
tokenizer exports are shipped).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

RETRIEVAL_MODELS = ("blip2_vicuna_instruct",)
GENERATE_MODELS = ("blip2_instruct_cir", "blip2_t5", "blip2_opt")
IMG, VOCAB, TXT, Q, LLM_VOCAB = 28, 60, 6, 4, 80
WIDTH = 128  # the tower's and the Q-Former's (2 heads of 64)


def build_synthetic(name: str, device="cuda", seed: int = 0):
    """The tiny configuration of ``name`` with random weights -> (model, the
    LLM's whitespace tokenizer)."""
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.models.qformer import QFormerConfig
    from sprc_tpu_torch.models.vit import ViTConfig
    from sprc_tpu_torch.text.llm_tokenizers import WhitespaceTokenizer

    vcfg = ViTConfig(image_size=IMG, patch_size=14, width=WIDTH, depth=2, num_heads=2,
                     mlp_hidden=2 * WIDTH, qkv_fused_no_kbias=True, dtype=torch.float32)
    qcfg = QFormerConfig(vocab_size=VOCAB, hidden_size=WIDTH, num_layers=2, num_heads=2,
                         intermediate_size=2 * WIDTH, encoder_width=WIDTH, query_length=Q,
                         dropout_rate=0.0)
    if name == "blip2_t5":
        llm = {"t5_config": dict(vocab_size=LLM_VOCAB, d_model=32, d_kv=8, d_ff=64, num_heads=4,
                                 num_layers=2, num_decoder_layers=2)}
        model_type = "caption_coco_flant5xl"
    elif name in RETRIEVAL_MODELS + ("blip2_instruct_cir",):
        llm = {"llama_config": dict(vocab_size=LLM_VOCAB, hidden_size=48, intermediate_size=96,
                                    num_layers=2, num_heads=4)}
        model_type = "vicuna7b"
    else:
        llm = {"opt_config": dict(vocab_size=LLM_VOCAB, hidden_size=48, ffn_dim=96, num_layers=2,
                                  num_heads=4)}
        model_type = "caption_coco_opt2.7b"
    model = loader.load_model(name, model_type, device=device, seed=seed, image_size=IMG,
                              num_query_token=Q, max_txt_len=TXT, vocab_size=VOCAB, embed_dim=16,
                              vit_dtype=torch.float32, freeze_vit=True, vit_config_override=vcfg,
                              qformer_config_override=qcfg, **llm)
    return model, WhitespaceTokenizer(vocab_size=LLM_VOCAB - 4, pad_id=0, eos_id=1, bos_id=2)


def bert_tokenizer():
    """The synthetic BERT-side tokenizer of the instruct models' text."""
    from sprc_tpu_torch.text.llm_tokenizers import WhitespaceTokenizer

    return WhitespaceTokenizer(vocab_size=VOCAB - 4, pad_id=0, eos_id=1, bos_id=2)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-name", required=True, choices=RETRIEVAL_MODELS + GENERATE_MODELS)
    p.add_argument("--synthetic", action="store_true",
                   help="tiny random model + synthetic data (smoke run)")
    p.add_argument("--prompt", default="a photo of")
    p.add_argument("--n-gallery", type=int, default=8)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--max-new-tokens", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; exits nonzero without a GPU) or cpu")
    return p


def main(argv: Optional[list] = None) -> None:
    args = make_parser().parse_args(argv)
    if not args.synthetic:
        raise SystemExit("non-synthetic mode needs real weights + tokenizer exports; pass "
                         "--synthetic for the smoke run (weights are not shipped in this "
                         "environment)")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model, llm_tok = build_synthetic(args.model_name, device)
    rs = np.random.RandomState(0)
    out = {"model": args.model_name, "mode": "synthetic"}

    def pixels(n):
        return torch.from_numpy(rs.rand(n, IMG, IMG, 3).astype(np.float32)).to(device)

    def tokens(tok, texts):
        enc = tok(texts, max_length=TXT)
        return [torch.from_numpy(enc[k]).to(device) for k in ("input_ids", "attention_mask")]

    with torch.inference_mode():
        if args.model_name in RETRIEVAL_MODELS:
            feats, _ = model.extract_target_features(pixels(args.n_gallery))
            caps = ["make it red", "longer sleeves"][: args.batch]
            bert, llm = tokens(bert_tokenizer(), caps), tokens(llm_tok, caps)
            sims = model.inference(model.encode_image(pixels(len(caps))), feats, *bert,
                                   *llm).cpu().numpy()
            out.update(task="retrieval", sims_shape=list(sims.shape),
                       finite=bool(np.isfinite(sims).all()),
                       top1=np.argmax(sims, axis=1).tolist())
        else:
            images = pixels(args.batch)
            prompts = [args.prompt] * args.batch
            kw = dict(eos_token_id=llm_tok.eos_id, pad_token_id=llm_tok.pad_id,
                      max_new_tokens=args.max_new_tokens)
            if args.model_name == "blip2_instruct_cir":
                from sprc_tpu_torch.models.instruct_cir import instruct_generate

                ids = instruct_generate(model, images, *tokens(bert_tokenizer(), prompts),
                                        *tokens(llm_tok, prompts), **kw)
            else:
                ids = model.generate_ids(images, *tokens(llm_tok, prompts), **kw)
            texts = [llm_tok.decode(row) for row in ids.cpu().numpy()]
            out.update(task="generate", n_outputs=len(texts), outputs=texts)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
