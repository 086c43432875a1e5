"""Drive the PyTorch/CUDA port (sprc_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero before the last line):

1. device: a CUDA device is required; TF32 is turned off so that every
   plain fp32 reference is true fp32;
2. build: the Hopper kernels of sprc_tpu_torch/csrc are compiled (nvcc,
   sm_90a) into sprc_tpu_torch/_build/;
3. kernels: K1 (token-max sim), K2 (ViT block) and K3 (Q-Former layer in the
   serving shapes, the rerank's among them: phase 8d) against their plain
   PyTorch versions on the card, at the shapes the main path gives them (64
   images, 32 queries, 512 items);
   the Q-Former's fp32 GEMM at each of its products and its fp32 attention at
   each of its calls (beside F.linear and SDPA in fp32, with both sides'
   device times); the LayerNorm at each call of kernel_checks.LN_CALLS (the
   towers' bf16 and LN -> int8 calls, the Q-Former's fp32 post-LN, an fp32
   tower's; beside F.layer_norm in the model dtype); the bf16 GEMM at 4096^3; then
   the int8 kernels: the s8 GEMM's raw s32 product at 4096^3 and at every
   product of the main path (equal to plain), each with the epilogue the path
   runs on it, the quantisers (codes and scales equal to plain at every call
   of kernel_checks.QUANT_CALLS, with their device times), K5 (int8 ViT
   block) and K4 (int8 Q-Former layer); every chain of 23 blocks or 12
   layers stage by stage (each kernel launch against its plain version on
   the same inputs); then the validate
   path's kernels: K8 (flash_attention) at head dims 64 and 88, the attention
   kernel at head dim 88 in bf16 and fp32, K6 (attention half) and K7 (MLP
   half) at ViT-L's and EVA ViT-g's shapes, K2 and K5 at EVA's shapes, and
   the towers' bf16 dense products; then the kernels redesigned for Hopper at
   their tile edges: the bf16 and fp32 GEMMs over ragged (M, N, K) with every
   epilogue and both residual modes, the s8 GEMM over ragged (M, N, K) raw
   and with every output mode and epilogue, each GEMM refusing a K it cannot
   take before any launch, the bf16 and fp32 attention over ragged (Sq, Sk)
   at both head dims on strided packed views, BSHD tensors and with a column
   bias that masks a whole row, the LayerNorm over ragged widths and row
   counts in its three modes, both quantisers over ragged rows and widths,
   unaligned views, zero rows, clipped values and exact ties, K1 over ragged
   query batches, galleries, token counts and depths (within 1e-5, a copied
   item tied bit for bit, NaN and infinities where the plain version gives
   them, and one gallery of 262,145 items, past 2^31 elements); and the host
   side of one call of each GEMM (K1's line in the kernels JSON times the
   wrapper, as every other's);
4. main path: the full-width blip2_cir_align_prompt / pretrain_vitL model
   (random weights from seed 0, synthetic BERT vocab) encodes a 512-image
   synthetic gallery through RetrievalEngine.build_index (encode_batch 64),
   saves the index, and the port's HTTP server (sprc_tpu_torch.cli.serve,
   --index-path) answers GET /health and POST /query with 1 and 32 queries;
   the answers are checked; the first gallery batch is encoded again and
   the 32 queries are scored again, stage by stage: every kernel launch of
   every block and layer against its plain version on the activations the
   kernel run gave it, within kernel_checks.STAGE_BOUNDS; and once more
   through the all-plain path on the card (``primitives.plain_reference``),
   compared with the bounds below;
4b. the int8 main path, the same way: the model is loaded with
   qformer_int8=True and an int8 tower whose activation scales are
   calibrated on 16 seeded images (set-up, plain PyTorch) and which then
   serves in "int8_static"; it encodes the same 512 images, and the server
   runs with --qformer-int8. The stage-by-stage comparison is the gate; the
   free-running all-plain comparison and the int8 answers against phase 4's
   (random weights) are reports;
   its calibration pass launches flash_attention (23 blocks a batch); the
   quantisers' launches are held per batch, on the main path and in each
   stage-by-stage pass: 23 quantize_static and 61 quantize_rows an encode
   batch (the image rows once a pass), 133 quantize_rows a query batch;
4d. raw encode, on phase 4's model: the port's native data-plane is built
   with g++ (the versions of libjpeg and libpng it linked are printed; where
   the machine lacks their headers or libraries, the reason is printed and
   the decode checks are left out); PNG bytes from a pure-Python encoder
   (utils.artifacts.encode_png) over seeded pixels at several sizes decode
   bit for bit, and the JPEG fixtures of tests/fixtures/dataplane decode and
   preprocess within the JAX test's bound of Pillow's stored arrays;
   device_preprocess on the card against the same function on the CPU (TF32
   off) over 64 seeded uint8 images of mixed true sizes in one 320 x 320
   buffer (padded wide and tall, unpadded near-square, upsampled small ones),
   within 1e-5; build_index_raw over 500 such images (8 batches of 64, the
   last one short) against build_index over the pixels device_preprocess
   gave, within phase 4's TARGET_* bounds, its launches held as phase 4's (23
   K2 and 12 K3 a batch; these launches are not phase 4's main path: the
   counters are put back); its rate beside the model alone's;
4c. one encode batch of the int8 configuration of blip2_cir_align_prompt /
   pretrain (EVA ViT-g, full width, calibrated as in 4b): its launches (39
   int8 blocks and 39 quantize_static, 12 int8 Q-Former layers and 61
   quantize_rows), its output, and the batch stage by stage;
5. validate on blip2_cir_align_prompt / pretrain at full width (EVA ViT-g:
   39 blocks, W 1408, head dim 88; the Q-Former over 1408-wide embeds;
   random weights from seed 0): a synthetic CIRR val split (512 gallery
   images as the seeded pixel batches of phase 4, 64 queries with 6-member
   groups) is written to a temporary directory and the metric dict comes
   through the port's cli/validate (build_engine, cirr_queries,
   evaluate_cirr), once on each tower route: the whole block (K2); the
   attention half + MLP kernel (K6, K7); unfused with flash_attention (K8).
   Each route's JSON is printed with its encode rate, its launch counters
   are checked (39 launches per image batch of its own kernels, none of the
   other routes'), the first 64 images and 32 queries are held stage by
   stage and against the all-plain path, and the three routes' target
   features are held within a bf16 bound of each other;
6. counters: every kernel of each path launched on that path (the chains'
   own kernels too: the bf16 and fp32 attention, the LayerNorm and its int8
   output, the two quantisers), and no kernel of another configuration moved;
7. fine-tune on blip2_cir_align_prompt / pretrain at full width (EVA ViT-g,
   bf16 tower, fp32 Q-Former, random weights from seed 0), batch 128, over a
   synthetic CIRR train split (512 triplets over 256 seeded images, read by
   cli/finetune.train_triplets) and its val split (64 queries):
   (a) a live step's three losses and every trainable gradient through the
       kernels (on the first step the tower stage by stage, STAGE_BOUNDS)
       against the same step under primitives.plain_reference() from one
       generator seed (the same dropout masks), and against the all-plain
       step from the kernel tower's rows, for the first batch of 4 epochs,
       each from its own seed; the worst tensors are named and K1's argmax
       moves counted (TRAIN_BOUNDS);
   (b) K1 with a gradient (TokenMaxSim) at B = N = 128, Q = 32, E = 256,
       random and with exact ties, against autograd over the plain version;
   (c) one live epoch (4 steps) through cli/finetune.finetune_epochs, then its
       validation (evaluate_cirr): K1 twice a step, the tower's chain once a
       step (39 blocks: 156 bf16 GEMMs, 39 attentions, 78 LayerNorms), no
       Q-Former kernel inside the steps, K3 and K1 in the validation;
   (d) the feature cache built over the 256 images (one tower call), then 4
       cached steps from the same start state and seed: their losses equal
       the live ones within TRAIN_BOUNDS["cached"];
   (e) the cached run's state saved after step 2 (train/checkpoint.save_state)
       and restored into a fresh trainer: steps 3 and 4 equal the
       uninterrupted run's within TRAIN_BOUNDS["resume"].
   It prints the live and cached step times (median) and samples/s, the
   peak memory, and its launch counters.

8. rerank (the two-stage ITM rerank, random weights from seed 0):
   (a) serving on blip2_cir_rerank / pretrain_vitL at full width: the model
       is saved in the release layout that loader.read_checkpoint reads, the
       512-image gallery is indexed through its twin and saved, and
       cli/serve runs with --model-name blip2_cir_rerank --model-path
       --rerank-top 50 --rerank-step 15; POST /query with 1 and 32 queries
       and "rerank": true: each reranked top 50 holds stage 1's top 50 (a
       POST without rerank), the reference masked, the scores stage 1's, and
       some order moved; a second service whose rerank needs the whole
       gallery answers 400 ("gallery too small to rerank"); the medians are
       printed;
   (b) cli/validate_rerank --dataset CIRR at its defaults (top 200, step 15:
       tiles of 3000 candidates) on blip2_cir_align_prompt / pretrain (EVA
       ViT-g) over phase 5's synthetic val split, the rerank model
       (blip2_cir_rerank / pretrain) saved and read back through
       --rerank-model-path: the metric JSON, each tile's time with its host
       gather, the peak memory; the tile's cross key / value products are
       past 2^31 elements;
   (c) one tile stage by stage (every K3 launch against its plain version,
       STAGE_BOUNDS): the EVA CIRR tile of 3000, the ViT-L tile of 750, and
       the ViT-L tile through blip2_cir_rerank with qformer_int8=True (K4,
       its 85 quantize_rows held); beside each, the all-plain tile on the
       card as a report;
   (d) the kernel phase holds K3 and K4 at SERVING_SHAPES["rerank"] (750
       pairs, Si = 514), the fp32 GEMM at the memory's key / value products
       (EVA's at M = 1,542,000, K = 1408: past 2^31, one launch, beside
       F.linear) and the s8 GEMM at EVA's, and the fp32 attention at a CIRR
       tile's cross (32 x 514) and masked self (64 x 64) calls beside SDPA;
   (e) the launch counters of the serving path, the int8 tile and the
       validate_rerank path: their own kernels launched, no other's.

9. the variant zoo (models/cir_variants.py) on pretrain_vitL at full width
   (CLIP ViT-L bf16, the Q-Former fp32, random weights from seed 0), batch
   128, over a synthetic CIRR train split of 256 triplets over phase 7's
   images (2 steps an epoch):
   (a) for each of the eight variants whose forward returns losses, one live
       step through the kernels against the all-plain step
       (primitives.plain_reference) from the kernel tower's rows with the
       same dropout seed, the kernel run's hard negatives handed to the plain
       step (patched here; how many of its own picks differ is printed):
       losses and gradients within VARIANT_BOUNDS; the step's launches held
       (K2's chain once, K1 and K3 as VARIANT_STEP_LAUNCHES says: K3 inside
       the rerank twin's and blip2_cir_cls's no-grad passes, none elsewhere);
       then one timed step (its ms, samples/s, peak memory printed); the
       Q-Former of these steps runs 4 of its 12 layers, so that the script
       ends within half its limit;
   (b) cli/finetune.finetune on the split written as PNG files:
       blip2_cir_neg for one epoch with its validation, and blip2_cir_rerank
       live and with --cache-features, whose steps equal the live ones
       within TRAIN_BOUNDS["cached"];
   (c) blip2_cir_slt's and blip2_cir_prompt's eval forwards (and the
       prompt model's inference) at 32 queries, stage by stage, against the
       all-plain forwards as a report: K3 with 4 query rows and the
       Q-Former's output_attentions pass on the card.
   The kernel phase holds K3 at the variants' no-grad shapes
   (kernel_checks.VARIANT_SHAPES).

10. BLIP-2 stage 1 through the YAML run layer (random weights from seed 0,
   the synthetic vocab, full width; the two CLIs get configs/runs/<name> as
   --cfg-path and --options give it, or, without PyYAML, Config(defaults=)
   from RUN_CONFIGS, and the script prints which):
   (a) cli/evaluate.py on eval/ret_coco_blip2_eval.yaml (blip2 / coco: EVA
       ViT-g at 364 px, the fp32 tower; 677 image rows) over 64 seeded PNG
       images of mixed sizes, 2 captions each, run.k_test 16: the metric
       JSON, seconds by stage (image encode, text encode, stage 1 (K1), the
       ITM rescoring both ways), the launches (K1 once, the tower's 39 blocks,
       K3's 12 layers a Q-Former call), the peak; against the all-plain run:
       K1's scores on the kernel run's features within its bound, one ITM
       chunk a direction within the 12-layer chain's, its K3 launches stage
       by stage; the frozen rows, both features, the stage-1 and the rescored
       scores within STAGE1_RUN_BOUNDS; the top-16 sets equal but at a near
       tie, recalls equal but at a near tie (both ties fixed by those bounds);
   (b) cli/train.py on pretrain_stage1.yaml (blip2 / pretrain: EVA ViT-g 224
       px bf16, frozen) at the YAML's batch of 100 over 200 seeded PNG pairs
       (one epoch, 2 steps): ms a step, samples/s, the peak (under 80 GB),
       the launches a step (K1 once, the tower's chain once, no K3); then one
       step through the kernels against the all-plain step from the kernel
       tower's rows and from the pixels (STAGE1_BOUNDS; the kernel step's hard
       negatives handed over, how many the plain step would move printed);
       K1 with a gradient at B = N = 100.
   The kernel phase holds K1 at COCO's 25,000 x 5,000, K2 in fp32 at S = 677
   and in bf16 at B = 100, and K3 against 677 memory rows
   (kernel_checks.run_stage1).

11. the unfrozen ViT: cli/train.py on retrieval_coco_blip2_ft.yaml (blip2 /
   coco: EVA ViT-g at 364 px, S = 677, the fp32 tower with freeze_vit false,
   its depth cut to 13 of 39 blocks so that the script ends within half its
   limit; random weights from seed 0, the synthetic vocab) at the YAML's batch of
   32 over 96 seeded PNG pairs (one epoch, 3 steps): ms a step, samples/s,
   the peak (under 80 GB), the launches a step (K1 once, K2 once a block through
   FusedViTBlock, no K3), every tower block moved by the updates; then
   (a) one step through the kernels on each tower route (the whole block;
       the attention half and the MLP half, FusedAttnBlock and FusedMlpBlock;
       unfused, FlashAttention) against the all-plain step with vit_remat
       from the same pixels (UNFROZEN_BOUNDS; the kernel step's hard
       negatives handed over), each route's launches, the gradient norm of
       every tower block (each positive);
   (b) the tower alone, on each route: forward and backward ms through the
       kernels and all plain, and its gradients from one cotangent within
       UNFROZEN_BOUNDS["tower_grad"] of the plain blocks' (the step's
       gradients in (a) pass through the Q-Former's token-max picks and are
       held loosely; these hold each route's Functions tightly at the
       step's batch);
   (c) one block's backward at the step's batch, FusedViTBlock's against
       the plain block's under vit_remat's checkpoint, with and without its
       early stop (kernel_checks.profile_block_backward).
   The kernel phase holds the four Functions at the tower's shapes (fp32, S =
   677, a batch of 4) and K2's in bf16 at ViT-L's (kernel_checks.run_unfrozen),
   and the kernels line carries their launches in this phase.

12. BLIP-2 stage 2, the LLM caption heads (random weights from seed 0, the
   synthetic vocab, full width; the run configs as phase 10 gives them; the
   LLM runs 8 of its layers, 8 + 8 for a T5, so that the script ends within
   half its limit, here and in phases 13 and 14):
   (a) cli/evaluate.py on eval/caption_coco_opt2.7b_eval.yaml (blip2_opt /
       caption_coco_opt2.7b: EVA ViT-g at 364 px, the fp32 tower, 32
       queries, OPT-2.7b in fp32) over 40 seeded PNG images of mixed sizes,
       5 captions each (the coco_caption test layout): batches of 16, 16
       and 8 padded to 16, max_len 30, the BERT tokenizer. A clean run,
       nothing recorded, gives the metric JSON, seconds by stage (image
       encode, Q-Former + projection, prefill, decode), ms a decoded token,
       the peak (under 80 GB) and the launches (39 K2 blocks and 12 K3
       layers a batch, the fp32 chain's own kernels, nothing else). A
       second kernel run records each stage and every decode step's
       logits; from it one cached decode step at batch 16 is timed on the
       host's clock and on the device's, as one CUDA graph
       (kernel_checks.profile_decode_step: the device's busy share, the ATen
       operators and the launches a step). generate_ids(use_cache=False) on the kernel route over the
       first batch: every step's logits up to each row's first differing
       id within the head's logits bound and RECOMPUTE_SPREAD_FRACTION of
       the cached steps' logits spread. The all-plain run
       (primitives.plain_reference) on the same weights: the frozen rows,
       the query rows, the projected rows and the prefill logits within
       CAPTION_BOUNDS, the LLM's prefill on the kernel run's own projected
       rows equal to the kernel run's; the witness, the all-plain LLM on
       the all-plain projected rows plus seeded noise of the kernel run's
       measured difference, says how far the LLM moves for such an input
       difference; every decode step's logits of the kernel run, up to
       each row's first differing id, within CAPTION_WITNESS_FACTOR times
       the witness's (a row's ids may differ only at a step so held; each
       such row is printed with the top-2 gap and the difference there);
   (b) the same for eval/caption_coco_flant5xl_eval.yaml (blip2_t5 /
       caption_coco_flant5xl, FlanT5-XL in fp32);
   (c) cli/instruct.py --synthetic for blip2_opt and blip2_t5 on the card,
       one JSON line each.
   The kernel phase holds K2 in fp32 at S = 677 and B = 16, its fp32
   attention call and K3's queries-only pass into 677 rows at B = 16
   (kernel_checks.run_caption); the kernels line carries their launches in
   12a and 12b.

13. BLIP-2 stage 2 trains its caption heads and answers zero-shot VQA (random
   weights from seed 0, the synthetic vocab, full width; the run configs as
   phase 10 gives them; one model on the card at a time):
   (a) cli/train.py on caption_coco_blip2_ft.yaml (blip2_opt /
       caption_coco_opt2.7b: EVA ViT-g at 364 px, the fp32 tower, whose YAML
       sets freeze_vit false; OPT-2.7b in fp32) at the YAML's batch of 16 over
       48 seeded PNG images with a caption each (one epoch, 3 steps): ms a
       step, samples/s, the peak (under 80 GB), the launches a step (the
       frozen tower's chain once: K2 39 times, no K3: the Q-Former trains
       unfused, the LLM is torch.matmul); then every tower and LLM tensor
       against a fresh model of the same seed, bit for bit, and the steps again
       on that model through the kernels (the tower's rows recorded) against
       the all-plain steps (primitives.plain_reference) from those rows: each
       step's loss, the first step's gradients, every trainable tensor after
       the steps (STAGE2_BOUNDS), the frozen tensors unchanged; the kernel
       tower's rows against the plain tower's; the kernel run's first step
       against the all-plain step from the pixels (the loss and the
       gradients): OPT at phase 7's live bound; FlanT5 at
       CAPTION_WITNESS_FACTOR times its witnesses' gaps, the all-plain step
       from the plain tower's rows moved by a draw of the kernel rows'
       difference's size (STAGE2_WITNESS), against the same step;
   (b) the same for pretrain_stage2.yaml (blip2_t5 / pretrain_flant5xl: the
       bf16 tower at 224 px, FlanT5-XL in fp32) at its batch of 32 (96 images);
   (c) cli/evaluate.py on eval/vqav2_zeroshot_opt_eval.yaml (blip2_opt /
       pretrain_opt2.7b, task vqa) over 48 seeded questions on PNG images with
       ten synthetic answers each (3 batches of 16, max_len 10): the metric
       JSON, seconds by stage, ms a decoded token, the peak and the launches
       (39 K2 blocks and 12 K3 layers a batch, the chains' own kernels); a
       recorded kernel run, the all-plain Q-Former on its own rows (K3's
       chain) and the all-plain LLM on its projected rows; the free-running
       all-plain run and its witnesses (VQA_WITNESS), as phase 12 holds them
       (VQA_BOUNDS; the steps at CAPTION_WITNESS_FACTOR times the witnesses'
       median);
   (d) the same for eval/gqa_zeroshot_flant5xl_eval.yaml (blip2_t5 /
       pretrain_flant5xl, task gqa).
   The kernel phase holds K2 and its bf16 attention call at 224 px at batches
   32 and 16, and K3's queries-only pass into 257 rows at 16
   (kernel_checks.run_stage2); the kernels line carries their launches in 13a
   to 13d.

14. the LLaMA heads (models/instruct_cir.py over models/llama.py; random
   weights from seed 0, full width: the vicuna7b rows, EVA ViT-g bf16 at 224
   px, the BERT-base Q-Former with 32 queries, Vicuna-7B in fp32 with 8 of
   its 32 layers; one model on the card at a time):
   (a) blip2_vicuna_instruct / vicuna7b: a 64-image seeded gallery through
       extract_target_features in batches of 16, 32 composed queries in two
       batches through encode_image and inference (the BERT text at the row's
       max_txt_len of 128, the LLaMA ids 8 to 32 long from a whitespace
       tokenizer, right-padded): seconds by stage (image encode, Q-Former,
       LLaMA), the peak, the launches (39 K2 blocks and 12 K3 layers a batch,
       the chains' own kernels, nothing else); a gallery and a query batch
       stage by stage; the frozen rows and the gallery features against the
       all-plain run (INSTRUCT_BOUNDS), the all-plain Q-Former on the kernel
       run's rows and the all-plain LLaMA on its query rows, and the reference
       features and scores of the free-running all-plain run held by its
       witnesses (VQA_WITNESS); then 3 ITC steps at batch 8 through
       GenericTrainer with models.instruct_cir.InstructAdapter, held as
       phase 13 holds its steps (the bf16 tower's chain once a step, no K3;
       every frozen tensor bit for bit; the steps from the kernel tower's rows
       against all-plain at STAGE2_BOUNDS["rows"], from the pixels by the
       witnesses);
   (b) blip2_instruct_cir / vicuna7b: instruct_generate (KV-cached) over 32
       prompts in two batches of 16 (unequal lengths, max_new_tokens 15):
       seconds by stage, ms a decoded token, one cached step's host and
       device ms (kernel_checks.profile_decode_step), the peak, the launches;
       the recompute path on 4 rows and 8 tokens against the cached path;
       the all-plain Q-Former and LLaMA on the kernel run's rows, and every
       decode step of the free-running all-plain run held by the witnesses,
       as phase 13's VQA; then 3 LM-loss steps at batch 8 over [instruction |
       output] ids, held as in (a);
   (c) phase 12c runs cli/instruct.py --synthetic for both LLaMA names too.
   The kernel phase holds K3 at the two fusion shapes (kernel_checks.
   run_instruct); K2 and its attention at B = 16 are phase 13's checks.

15. PNP-VQA (models/pnp_vqa.py; random weights from seed 0, the synthetic
   vocab, full width: pnp_vqa / base, BLIP-1's ITM large and caption
   large_coco, each a ViT-L/16 at 384 px in bf16 (S = 577, 24 blocks through
   K2), 12-layer med-BERTs in fp32, the UnifiedQA-v2 t5-base FiD reader in
   fp32): cli/evaluate.py on eval/pnp_vqa_vqav2_eval.yaml over 8 seeded
   questions on PNG images (2 batches of 4; num_captions 50, num_patches
   20, block_num 7, max_len 10, min_len 1): the metric JSON, the result
   file, seconds by stage (the towers, GradCAM, caption sampling, FiD
   encode, FiD decode), ms a sampled token, the peak, the launches (48 K2
   blocks a batch, the bf16 chain's own kernels, no K1 or K3); then the
   first batch recorded through the kernels and held against the all-plain
   run: both towers' rows (PNP_BOUNDS), the all-plain GradCAM over the
   kernel run's rows, the GradCAM maps from the all-plain rows and the
   caption decoder's logits over the same sampled ids and gathered patches
   at CAPTION_WITNESS_FACTOR times their shuffled witnesses' median
   (PNP_WITNESS), the all-plain FiD's answers from the kernel run's
   captions equal to the kernel run's; the free-running all-plain batch is
   a report. The kernel phase holds K2 at BLIP's ViT-L/16 shapes (B = 4, S
   = 577), its bf16 attention call and the 24-block chain stage by stage
   (kernel_checks.run_pnp).

16. Img2Prompt-VQA (models/pnp_vqa.py's Img2PromptVqaPipeline; random weights
   from seed 0, the synthetic vocab, full width: img2prompt_vqa / base,
   phase 15's two BLIP towers and t5-large as the question generator, fp32):
   predict_prompts on 2 seeded images and questions (num_captions 50,
   num_patches 20, block_num 7; the filter's threshold 0.0, as the JAX test
   runs a random model): seconds by stage (the towers, GradCAM, caption
   sampling, the ITM filter, the question generator's encode and beam
   decode), ms a beam step, the steps, the peak, the launches (24 K2 blocks a
   tower call: the ITM's, the captioner's and the filter's once an image);
   against the all-plain run: both towers' rows (phase 15's bounds), the
   filter's match probabilities and its kept sets at 0.0 and 0.5
   (IMG2PROMPT_BOUNDS; captions within the bound of a threshold counted and
   printed), and the question generator's KV-cached beam over the first
   image's first 10 contexts against the uncached beam (equal ids; the best
   sequences' log-probabilities, cached against recomputed); then
   cli/evaluate.py on eval/pnp_vqa_vqav2_eval.yaml with the model
   img2prompt_vqa / base (threshold 0.5) over phase 15's 8 questions: the
   metric JSON, the result file, the launches. The kernel phase holds K2 and
   its bf16 attention at the filter's batch (B = 1;
   kernel_checks.run_img2prompt).
17. The momentum-queue families (models/albef.py, models/blip1.py; random
   weights from the run's seed, the synthetic vocab, full width: BLIP-1's
   ViT-B/16 in bf16 trained through K2's FusedViTBlock, the BERT-base
   med-BERT in fp32, the YAMLs' queues of 57,600 / 65,536). 17a:
   cli/train.py on retrieval_coco_ft.yaml (blip_retrieval) and
   retrieval_coco_albef_ft.yaml, 3 steps each at batch 32 and 384 px; 17b:
   pretrain_14m.yaml (blip_pretrain) and pretrain_albef.yaml, 2 steps each at
   batch 64 and 224 px (seeded PNG pairs): step ms, samples/s, peak, the
   launches a step (MOMENTUM_STEP_LAUNCHES: 12 K2 blocks through the
   Function in the live tower, 12 without a graph in the momentum tower);
   then the same steps all-plain from the same weights and batches, the
   kernel run's hard negatives replayed: each step's losses, the ITM logits,
   the queues, the momentum copies (MOMENTUM_BOUNDS), ptr and idx_queue
   equal. 17c: cli/evaluate.py on eval/ret_coco_eval.yaml and
   ret_coco_albef_eval.yaml over a synthetic split (MOMENTUM_EVAL_SPLIT: 32
   images x 5 captions, k_test 16): seconds by stage (image encode, text
   encode, ITC, ITM rescoring), K2's 12 launches a 16-image encode; the
   tower's rows against the plain tower's on the same pixels, and the
   all-plain evaluation from the kernel tower's rows: the same recalls and
   scores. The kernel phase holds K2
   without a graph and through FusedViTBlock (forward, forward + backward)
   at B = 32, S = 577 and B = 64, S = 197, at the evaluation's B = 16, its
   bf16 attention and a block's four bf16 products
   (kernel_checks.run_momentum).
18. BLIP-1 / ALBEF VQA (models/vqa.py; random weights from the run's seed,
   the synthetic vocab, full width: ViT-B/16 bf16 through K2, BERT-base
   question encoder and answer decoder fp32, seeded PNG images). 18a:
   cli/train.py on vqav2_ft.yaml (blip_vqa, 480 px: S = 901), 3 steps at
   batch 16; 18b: vqav2_albef_ft.yaml (albef_vqa, 384 px) with
   model.use_distill true (the YAML names no model type, so the dataclass
   defaults do not distill), 3 steps at batch 32: step ms, samples/s, peak,
   K2 a step (HEAD_STEP_LAUNCHES: 12 live through the Function, 12 in the
   momentum tower where the head distills); then the same steps all-plain
   from the same weights, batches and dropout masks: each step's loss and
   the momentum copies (HEAD_BOUNDS). 18c: cli/evaluate.py on
   eval/vqav2_eval.yaml (rank over a synthetic answer list of 3,129,
   num_ans_candidates 128: the rescoring at [B k] = 2,048 rows) and 18d on
   eval/gqa_eval.yaml (generate, max_len 10), 32 questions at batch 16:
   seconds by stage (tower, question encode, probe, rescore or decode), 12
   K2 a batch; the tower's rows against the plain tower's on the same
   pixels, and the all-plain evaluation from the kernel tower's rows: the
   same answers and metrics.
19. SNLI-VE and NLVR2 (models/classification.py, models/nlvr.py). 19a:
   cli/train.py on snli_ve_ft.yaml (albef_classification, batch 32) and
   nlvr_ft.yaml (albef_nlvr, 16 pairs: 32 images a tower call), both
   distilled, 2 steps each, held as 18a / 18b; 19b: cli/evaluate.py on
   eval/snli_ve_eval.yaml, eval/nlvr_eval.yaml (BLIP's twin
   cross-attention) and eval/nlvr_albef_eval.yaml over 32 items, held as 18c
   (the logits within HEAD_BOUNDS, the accuracy equal). The kernel phase
   holds K2 at S = 901 and B = 16 without a graph and through FusedViTBlock
   (forward, forward + backward), its bf16 attention and a block's four bf16
   products (kernel_checks.run_vqa); S = 577 is phase 17's.
20. BLIP-1 captioning and the CIR feature extractor (models/blip1.py;
   random weights from seed 0, the synthetic vocab, full width). 20a:
   cli/train.py on caption_coco_ft.yaml (ViT-B/16) and
   caption_coco_large_ft.yaml (ViT-L/16), both at 384 px and the YAMLs'
   batch of 32, 3 and 2 steps: step ms, samples/s, peak, K2 a step (12 / 24,
   the tower trained through FusedViTBlock); then the same steps all-plain
   from the same weights, batches and dropout masks, and one step's
   gradients with the tower's K2 launches stage by stage, within
   TRAIN_BOUNDS["live"]; no last_state.pt is written. 20b: cli/evaluate.py
   on eval/caption_coco_eval.yaml over 32 images at batch 16 (the greedy
   decode of 20 tokens after "[DEC] a picture of"): seconds by stage, ms a
   decoded token, 12 K2 a batch; the tower's rows against the plain tower's,
   and the all-plain decode from the kernel tower's rows: the same captions
   and metrics. 20c: extract_features of blip_feature_extractor / base on
   64 images and 64 captions with seeded prompts: K2 12 (ViT-B/16, 224 px)
   and K3 12 (the med-BERT's text pass) launches, both stage by stage
   within STAGE_BOUNDS.
21. CLIP (models/clip.py, models/resnet_clip.py): cli/evaluate.py on
   eval/exp_coco_ret_eval.yaml (vit_large14_336, fp32, over 32 images x 5
   captions) and eval/imnet_zs_eval.yaml (64 images at one batch, 50
   label-derived classes x the 80 templates; the BERT WordPiece fallback
   tokenizes, as in the JAX CLI): 24 K2 a tower call; the tower's features
   against the plain tower's within CLIP_FEATURE_REL, and from the kernel
   tower's features the all-plain recalls and predictions equal; then
   extract_features of vit_base32 (K2 at S = 50, stage by stage) and
   resnet50 (no kernel) on 64 images, and one 32-image ViT-L/14-336 batch
   stage by stage. The kernel phase holds K2 through FusedViTBlock at the
   ViT-L/16 captioner's B = 32, S = 577 with its bf16 attention, K3 at the
   CIR text pass (kernel_checks.run_blip_caption), and K2 in fp32 with its
   attention at CLIP ViT-L/14-336's B = 32 and 64 and ViT-B/32's S = 50
   (kernel_checks.run_clip).
22. The video families (models/alpro.py over models/timesformer.py; random
   weights from seed 0, the synthetic vocab, full width: the TimeSformer
   ViT-B/16 over 8 frames at 224 px and the BERT-base med-BERT, both fp32;
   seeded uint8 clips of 8 x 240 x 320, one a directory of PNG frames). 22a:
   cli/train.py on msrvtt_retrieval_ft.yaml (the YAML's batch of 16, 3
   steps; its train processor seeded); 22b: msrvtt_qa_ft.yaml the same way
   (1500 classes, the model YAML's 16 time rows, 8 sampled frames): step ms,
   samples/s, peak, K8 a step (12: the spatial attention of each block,
   through FlashAttention; nothing else launches); then one step's
   gradients through the kernels (every K8 launch stage by stage) against
   all-plain, and the same steps all-plain from the same weights, batches,
   dropout masks and (22a) hard negatives, within TRAIN_BOUNDS["live"]; no
   last_state.pt is written. 22c: cli/evaluate.py on
   eval/msrvtt_ret_eval.yaml over 32 clips x 2 captions at k_test 16 (4
   clips a tower call); 22d: eval/msvd_qa_eval.yaml over 32 questions (8 a
   batch) and 2423 synthetic answers: seconds by stage, 12 K8 a tower call;
   the tower's rows against the plain tower's on the same clips within
   VIDEO_ROW_REL, and from the kernel tower's rows the all-plain recalls and
   predictions equal. Cut: the evaluations read 32 clips, not a split. The
   kernel phase holds K8 at TimeSformer's call (fp32, D 64, S = 197, strided
   views of the packed qkv) through FlashAttention at B·T = 128 and without
   a graph at 32, beside SDPA fp32 (kernel_checks.run_video).
23. The GPT-2 video dialogue (models/gpt_dialogue.py) and the Q-Former LM's
   caption decode (models/lm.py; random weights from seed 0). 23a:
   cli/train.py on dialogue_avsd_ft.yaml as shipped (GPT-2 base, fp32,
   vocabulary 50,264, len_video_ft 4224, batch 16) with its streams named
   through --options (i3d_flow + i3d_rgb + vggish) and the synthetic GPT-2
   tokenizer, 3 steps over 48 synthetic dialogues of 3 turns (each stream
   40 to 80 frames): step ms, samples/s, peak; the first step's loss
   against the same batch through the same initial weights in float64
   within DIALOGUE_F64_REL, and its logits within DIALOGUE_F64_LOGITS; no
   launch (the trunk runs no Pallas kernel in JAX) and no last_state.pt.
   23b: cli/evaluate.py on eval/dialogue_avsd_eval.yaml over 44 dialogues
   at 8 (the last batch 4 real items) from 23a's model-only file, deleted
   after: the metric against the same batches' mean computed in process
   within DIALOGUE_EVAL_REL. 23c: lm.generate_captions on
   blip2_cir_align_prompt / pretrain (EVA ViT-g bf16 through K2, the
   BERT-base Q-Former, 32 queries, a seeded LM head) over 16 images, 3
   beams, max_length 30, min_length 10: seconds by stage, ms a decoded
   position, peak; K2 39 in the one tower call and its chain, nothing else;
   the tower stage by stage (the check that holds K2 here); from the kernel
   tower's rows the all-plain decode's captions equal (the decoder runs no
   kernel: this holds the decode's repeatability, not K2); the cached beam
   and greedy decodes equal the recomputing ones. Its kernel rows read
   phase 3's K2 and bf16 attention at EVA, B = 16
   (kernel_checks.run_stage2).
24. --mesh at world 1 over NCCL (sprc_tpu_torch/parallel/; this process joins
   a group of one as a launcher would describe it: RANK 0, WORLD_SIZE 1, a
   free port on 127.0.0.1), full width: blip2_cir_align_prompt /
   pretrain_vitL (CLIP ViT-L, bf16 tower; random weights from seed 0) on
   phase 7's synthetic CIRR (TRAIN_TRIPLETS at TRAIN_BATCH: 4 steps, one
   epoch, with its validation) written as MESH_PNG px PNG files. Each run
   goes through the CLI's entry point, with and without --mesh from the same
   seed: cli/finetune.py live and with --cache-features (the train cache
   built on rank 0 and mapped; the val gallery's tower rows cached at the
   first validation), held bit for bit (the losses of every step, the final
   trainable tensors, the validation's metrics; a run that is not is named
   by the tensor where the first step's gradients part, and held at
   TRAIN_BOUNDS["live"]: every step's losses, the first step's gradients);
   cli/validate.py (the
   printed JSON equal); cli/serve.py's service behind its HTTP front end
   answering MESH_QUERIES requests (the answers equal). The phase prints the
   group's backend, NCCL's version, the world size, the step times with and
   without --mesh, what the NCCL calls of a step cost at world 1 (the
   gradient all-reduce, the targets' all-gather; device times), the train
   cache's host memory in the process, and the K1 / K2 / K3 launches of the
   --mesh runs, which join the kernels line. One last_state.pt is written
   (the --mesh live run's, read back and deleted); the others and every
   best_<metric>.pt are kept in memory only. On the same split with a CIRR
   test1 split of MESH_TEST1_QUERIES queries and a seeded random
   blip2_cir_rerank saved in the release layout, each again with and
   without --mesh: cli/validate_rerank.py (--rerank-top RERANK_TOP
   --rerank-step RERANK_STEP; the printed JSON equal), cli/submission.py
   --dataset CIRR --rerank (the files equal byte for byte) and cli/serve.py
   --rerank-top RERANK_TOP over the reranker (MESH_QUERIES requests with
   "rerank": true and one with a list reference, which gets its 400; the
   answers equal), each run's seconds and K1 / K2 / K3 launches printed; the
   checkpoint and the submission files are deleted at the phase's end.
25. The largest BLIP-2 rows at full width, one model on the card at a time
   (random weights from seed 0, drawn on the card; the previous model freed
   first), each through its evaluation path's entry point: 25a,
   cli/evaluate.py on eval/caption_coco_opt6.7b_eval.yaml (EVA ViT-g fp32 at
   364 px, OPT-6.7b fp32) over LARGE_ITEMS images; 25b, cli/evaluate.py on
   eval/gqa_zeroshot_flant5xl_eval.yaml with model.model_type=
   pretrain_flant5xxl (EVA bf16, FlanT5-XXL fp32) over LARGE_ITEMS
   questions; 25c, phase 14a's retrieval path with blip2_vicuna_instruct /
   vicuna13b over a LARGE_GALLERY-image gallery and LARGE_ITEMS queries (no
   training step). Each is phase 12a's, 13d's or 14a's run and check with
   the row swapped (their bounds and launch counts unchanged), with what
   the LLM moves (the prefill's logits, every step's logits and ids, 25c's
   reference features and scores) held at CAPTION_WITNESS_FACTOR times the
   median of three witness draws; 25a and 25b also profile one cached
   decode step and hold the recompute loop against the cached decode on the
   first batch's LARGE_RECOMPUTE_TOKENS tokens, as phase 12 does (at
   RECOMPUTE_SPREAD_FRACTION of the cached logits' spread, and 25a at the
   OPT head's logits bound too).
   Each prints its seconds by stage, ms a decoded token, build seconds and
   peak GiB.

Phases 4, 4b and 5 print their encode rate beside the model alone's: the
same batches already on the card through extract_target_features (and the
frozen embeds' cast), one synchronize at the end.

Then it prints one JSON line with each kernel's numbers, the card's name and
power limit, and last {"ok": true, "device": {...}}.
"""

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
SEED = 0
GALLERY = 512
ENCODE_BATCH = 64
QUERY_BATCH = 32
K = 10
# main path against its all-plain version on the card (primitives.plain_reference).
# Readings on an H100: frozen embeds 0.125 / 9.96e-3 (max / mean abs), target
# feats 2.83e-4 / 4.91e-5, scores 2.5e-7. The encode bounds are 2-4x those: the
# bf16 tower compounds rounding over 23 blocks. The query side (fp32 Q-Former
# and scoring over the same stored embeds) stays near fp32: 1e-5.
FROZEN_MAX_ABS, FROZEN_MEAN_ABS = 0.25, 0.02
TARGET_MAX_ABS, TARGET_MEAN_ABS = 1e-3, 2e-4
SCORE_MAX_ABS = 1e-5
BOUNDS = {"frozen": (FROZEN_MAX_ABS, FROZEN_MEAN_ABS), "target": (TARGET_MAX_ABS, TARGET_MEAN_ABS),
          "score": SCORE_MAX_ABS, "top1": QUERY_BATCH - 1}
# The int8 main path is held stage by stage (kernel_checks.STAGE_BOUNDS); its
# free-running all-plain version is reported without a bound. The two quantise
# values that differ in the last bits, so codes flip and, over 23 blocks and
# 12 layers, the runs drift as far apart as int8 lies from bf16/fp32: a bound
# on that difference could not tell a wrong kernel from a right one.
CALIB_IMAGES = 16
# The validate phase (EVA ViT-g, 39 bf16 blocks) against its all-plain version:
# the same kinds of bound as BOUNDS, over a deeper and wider tower. Readings on
# an H100, worst of the three routes: frozen embeds 0.193 / 1.34e-2 (max / mean
# abs), target feats 4.71e-4 / 7.42e-5, scores 4.3e-7; the bounds are about 3x
# those.
EVA_BOUNDS = {"frozen": (0.5, 0.04), "target": (1.5e-3, 2.5e-4), "score": 1e-5,
              "top1": QUERY_BATCH - 1}
# The fine-tune phase (full-width pretrain, batch 128), over the first batch
# of LIVE_SEEDS epochs, each step from its own dropout seed; losses relative,
# gradients as kernel_checks.grad_gap (max |difference| over the tensor's max
# |plain gradient|, that max floored at 1e-4 of the step's largest). Readings
# on an H100 (worst of the 4 steps) beside each bound.
# "rows": the live step through the kernels against the all-plain step from
# the kernel tower's own rows: every kernel but the tower's (held stage by
# stage, STAGE_BOUNDS) and the whole fp32 Q-Former with its backward; bounds
# 2.7 and 5 times the readings.
# "live": the same step against the all-plain step from pixels. Its gap is
# the plain Q-Former's response to the tower's bf16 gap, read equal to the
# gap between the two all-plain steps; and the gradient of K1's max jumps
# where a score's argmax over the 32 query tokens moves, which the tower's
# gap does for about 50 of the 32768 scores a step. A move on a diagonal
# score (the label's, with the largest gradient) took the gradient gap from
# 3.1e-2 (no such move) to 0.31-0.38 (one), in attention and FFN weights and
# query_tokens, so three times the readings would check nothing; the bound
# 0.9 still fails a gradient that is missing or doubled (gap 1) or of the
# wrong sign (2), and the losses are held at 3 times their readings.
# "cached" / "resume": cached steps against the live ones, resumed steps
# against the uninterrupted ones (the same kernels on the same rows: equal
# in the readings).
LIVE_SEEDS = 4
TRAIN_TRIPLETS = 512
TRAIN_IMAGES = 256
TRAIN_BOUNDS = {"live": {"loss": 2e-4, "grad": 0.9},     # 6.5e-5, 3.8e-1
                "rows": {"loss": 5e-7, "grad": 1e-5},    # 9.8e-8, 3.7e-6
                "cached": 1e-6, "resume": 1e-6}          # 0, 0
# the three routes' target features against the whole-block route's (bf16
# towers that round at other places): max / mean abs; readings 5.21e-4 / 7.56e-5
ROUTE_TARGET_MAX_ABS, ROUTE_TARGET_MEAN_ABS = 1.5e-3, 2.5e-4
VALIDATE_QUERIES = 64
# phase 4d: the raw (uint8) gallery in a 320 x 320 buffer, 8 batches with the
# last one short; device_preprocess on the card against the CPU (TF32 off;
# the products' summation order: readings about 1e-6)
RAW_BUFFER = 320
RAW_IMAGES = GALLERY - 12
PREPROCESS_MAX_ABS = 1e-5
# the JAX test's preprocess bound (tests/test_native_dataplane.py): uint8
# resample rounding differs by at most 1 step / 0.26 std; a decoded value by
# at most the 2 levels that make that bound
DATAPLANE_PREPROCESS_BOUND = (2.0 / 255.0) / 0.26 + 1e-5
DATAPLANE_DECODE_LEVELS = 2
# phase 8, the ITM rerank: serve's flags (bench.py's tile, 15 x 50), and the
# validate_rerank CLI's CIRR defaults (15 x 200, 3000 candidates a tile, which
# on EVA ViT-g puts the cross key / value products past 2^31 elements)
RERANK_TOP, RERANK_STEP = 50, 15
RERANK_CIRR = (200, 15)
# tower route -> (the --model-overrides that select it, the kernels whose
# count must be 39 per image batch, the other routes' kernels: 0)
ROUTES = {
    "block": ([], ("fused_vit_block",)),
    "attn+mlp": (["vit_fused_block=attn", "vit_fused_mlp=true"],
                 ("fused_attn_block", "fused_mlp_block")),
    "unfused": (["vit_fused_block=none"], ("flash_attention",)),
}
ROUTE_KERNELS = ("fused_vit_block", "fused_attn_block", "fused_mlp_block", "flash_attention")
# phase 10's to 13's, 15's and 17's to 19's run configs as configs/runs/<name> gives them (the card machine
# may lack PyYAML: then the CLIs get Config(defaults=<dict>); a CPU test pins
# each dict equal to its file)
RUN_CONFIGS = {
    "eval/ret_coco_blip2_eval.yaml": {
        "run": {"task": "retrieval", "evaluate": True, "k_test": 128, "max_txt_len": 35,
                "test_splits": ["test"]},
        "model": {"arch": "blip2", "model_type": "coco"},
        "datasets": {"coco_retrieval": {
            "build_info": {"annotations": {"test": []}, "images": ""},
            "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": 364}},
            "text_processor": {"eval": {"name": "blip_caption"}}}}},
    "pretrain_stage1.yaml": {
        "run": {"task": "image_text_pretrain", "batch_size": 100, "max_epochs": 10,
                "learning_rate": "1e-4", "weight_decay": 0.05, "max_txt_len": 32, "seed": 42},
        "model": {"arch": "blip2", "image_size": 224, "num_query_token": 32},
        "datasets": {"conceptual_caption_3m": {
            "build_info": {"annotations": {"train": []}, "images": ""},
            "vis_processor": {"train": {"name": "blip_image_train", "image_size": 224}},
            "text_processor": {"train": {"name": "blip_caption"}}}}},
    "eval/caption_coco_opt2.7b_eval.yaml": {
        "run": {"task": "captioning", "evaluate": True, "batch_size_eval": 16, "num_beams": 1,
                "max_len": 30, "min_len": 8, "prompt": "a photo of", "test_splits": ["test"]},
        "model": {"arch": "blip2_opt", "model_type": "caption_coco_opt2.7b"},
        "datasets": {"coco_caption": {
            "build_info": {"annotations": {"test": []}, "images": ""},
            "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": 364}},
            "text_processor": {"eval": {"name": "blip_caption"}}}}},
    "eval/caption_coco_opt6.7b_eval.yaml": {
        "run": {"task": "captioning", "evaluate": True, "batch_size_eval": 16, "num_beams": 1,
                "max_len": 30, "min_len": 8, "prompt": "a photo of", "test_splits": ["test"]},
        "model": {"arch": "blip2_opt", "model_type": "caption_coco_opt6.7b"},
        "datasets": {"coco_caption": {
            "build_info": {"annotations": {"test": []}, "images": ""},
            "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": 364}},
            "text_processor": {"eval": {"name": "blip_caption"}}}}},
    "eval/caption_coco_flant5xl_eval.yaml": {
        "run": {"task": "captioning", "evaluate": True, "batch_size_eval": 16, "num_beams": 1,
                "max_len": 30, "min_len": 8, "prompt": "a photo of", "test_splits": ["test"]},
        "model": {"arch": "blip2_t5", "model_type": "caption_coco_flant5xl"},
        "datasets": {"coco_caption": {
            "build_info": {"annotations": {"test": []}, "images": ""},
            "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": 364}},
            "text_processor": {"eval": {"name": "blip_caption"}}}}},
    "caption_coco_blip2_ft.yaml": {
        "run": {"task": "captioning", "batch_size": 16, "max_epochs": 5, "learning_rate": "1e-5",
                "weight_decay": 0.05, "max_txt_len": 40, "seed": 42},
        "model": {"arch": "blip2_opt", "model_type": "caption_coco_opt2.7b"},
        "datasets": {"coco_caption": {
            "build_info": {"annotations": {"train": []}, "images": ""},
            "vis_processor": {"train": {"name": "blip_image_train", "image_size": 364}},
            "text_processor": {"train": {"name": "blip_caption"}}}}},
    "pretrain_stage2.yaml": {
        "run": {"task": "captioning", "batch_size": 32, "max_epochs": 1, "learning_rate": "1e-4",
                "weight_decay": 0.05, "max_txt_len": 32, "seed": 42},
        "model": {"arch": "blip2_t5", "model_type": "pretrain_flant5xl"},
        "datasets": {"coco_caption": {
            "build_info": {"annotations": {"train": []}, "images": ""},
            "vis_processor": {"train": {"name": "blip_image_train", "image_size": 224}},
            "text_processor": {"train": {"name": "blip_caption"}}}}},
    "eval/vqav2_zeroshot_opt_eval.yaml": {
        "run": {"task": "vqa", "evaluate": True, "batch_size_eval": 16,
                "inference_method": "generate", "prompt": "Question: {} Short answer:",
                "max_len": 10, "min_len": 1, "test_splits": ["val"]},
        "model": {"arch": "blip2_opt", "model_type": "pretrain_opt2.7b"},
        "datasets": {"coco_vqa": {
            "build_info": {"annotations": {"val": []}, "images": ""},
            "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": 224}},
            "text_processor": {"eval": {"name": "blip_question"}}}}},
    "eval/gqa_zeroshot_flant5xl_eval.yaml": {
        "run": {"task": "gqa", "evaluate": True, "batch_size_eval": 16,
                "inference_method": "generate", "prompt": "Question: {} Short answer:",
                "max_len": 10, "min_len": 1, "test_splits": ["val"]},
        "model": {"arch": "blip2_t5", "model_type": "pretrain_flant5xl"},
        "datasets": {"gqa": {
            "build_info": {"annotations": {"val": []}, "images": ""},
            "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": 224}},
            "text_processor": {"eval": {"name": "blip_question"}}}}},
    "eval/pnp_vqa_vqav2_eval.yaml": {
        "run": {"task": "vqa", "evaluate": True, "batch_size_eval": 4, "num_captions": 50,
                "num_captions_fid": 1, "num_patches": 20, "block_num": 7, "max_len": 10,
                "min_len": 1, "test_splits": ["val"]},
        "model": {"arch": "pnp_vqa", "model_type": "base"},
        "datasets": {"coco_vqa": {
            "build_info": {"annotations": {"val": []}, "images": ""},
            "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": 384}},
            "text_processor": {"eval": {"name": "blip_question"}}}}},
    "retrieval_coco_ft.yaml": {
        "run": {"task": "retrieval", "batch_size": 32, "max_epochs": 6, "learning_rate": "1e-5",
                "weight_decay": 0.05, "max_txt_len": 35, "seed": 42},
        "model": {"arch": "blip_retrieval", "image_size": 384, "embed_dim": 256,
                  "queue_size": 57600, "momentum": 0.995, "alpha": 0.4},
        "datasets": {"coco_retrieval": {
            "build_info": {"annotations": {"train": []}, "images": ""},
            "vis_processor": {"train": {"name": "blip_image_train", "image_size": 384},
                              "eval": {"name": "blip_image_eval", "image_size": 384}},
            "text_processor": {"train": {"name": "blip_caption"},
                               "eval": {"name": "blip_caption"}}}}},
    "retrieval_coco_albef_ft.yaml": {
        "run": {"task": "retrieval", "batch_size": 32, "max_epochs": 5, "learning_rate": "1e-5",
                "weight_decay": 0.05, "max_txt_len": 30, "seed": 42},
        "model": {"arch": "albef_retrieval", "image_size": 384, "embed_dim": 256,
                  "queue_size": 65536, "momentum": 0.995, "alpha": 0.4},
        "datasets": {"coco_retrieval": {
            "build_info": {"annotations": {"train": []}, "images": ""},
            "vis_processor": {"train": {"name": "blip_image_train", "image_size": 384},
                              "eval": {"name": "blip_image_eval", "image_size": 384}},
            "text_processor": {"train": {"name": "blip_caption"},
                               "eval": {"name": "blip_caption"}}}}},
    **{f"pretrain_{which}.yaml": {
        "run": {"task": "image_text_pretrain", "batch_size": 64, "max_epochs": 1,
                "learning_rate": "3e-4", "weight_decay": 0.05, "max_txt_len": 30, "seed": 42},
        "model": {"arch": arch, "model_type": "base"},
        "datasets": {"conceptual_caption_3m": {
            "build_info": {"annotations": {"train": []}, "images": ""},
            "vis_processor": {"train": {"name": "blip_image_train", "image_size": 224}},
            "text_processor": {"train": {"name": "blip_caption"}}}}}
       for which, arch in (("14m", "blip_pretrain"), ("albef", "albef_pretrain"))},
    **{f"eval/ret_coco{suffix}_eval.yaml": {
        "run": {"task": "retrieval", "evaluate": True, "k_test": 128, "max_txt_len": 35,
                "test_splits": ["test"]},
        "model": {"arch": arch, "model_type": "coco"},
        "datasets": {"coco_retrieval": {
            "build_info": {"annotations": {"test": []}, "images": ""},
            "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": 384}},
            "text_processor": {"eval": {"name": "blip_caption"}}}}}
       for suffix, arch in (("", "blip_retrieval"), ("_albef", "albef_retrieval"))},
    **{name: {
        "run": {"task": "vqa", "batch_size": batch, "max_epochs": epochs, "learning_rate": "2e-5",
                "weight_decay": 0.05, "max_txt_len": 35, "seed": 42},
        "model": {"arch": arch, "flavor": arch.split("_")[0], "image_size": size},
        "datasets": {"coco_vqa": {
            "build_info": {"annotations": {"train": []}, "images": ""},
            "vis_processor": {"train": {"name": "blip_image_train", "image_size": size},
                              "eval": {"name": "blip_image_eval", "image_size": size}},
            "text_processor": {"train": {"name": "blip_question"},
                               "eval": {"name": "blip_question"}}}}}
       for name, arch, batch, epochs, size in (
           ("vqav2_ft.yaml", "blip_vqa", 16, 10, 480),
           ("vqav2_albef_ft.yaml", "albef_vqa", 32, 8, 384))},
    **{f"eval/{name}_eval.yaml": {
        "run": {"task": task, "evaluate": True, "batch_size_eval": 16, "inference_method": method,
                "num_ans_candidates": 128, "max_len": 10, "test_splits": ["val"]},
        "model": {"arch": "blip_vqa", "model_type": "vqav2"},
        "datasets": {builder: {
            "build_info": {"annotations": {"val": []}, "images": ""},
            "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": 480}},
            "text_processor": {"eval": {"name": "blip_question"}}}}}
       for name, task, method, builder in (("vqav2", "vqa", "rank", "coco_vqa"),
                                           ("gqa", "gqa", "generate", "gqa"))},
    **{name: {
        "run": {"task": "multimodal_classification", "batch_size": batch, "max_epochs": 10,
                "learning_rate": "2e-5", "weight_decay": 0.05, "max_txt_len": 40, "seed": 42},
        "model": {"arch": arch, **model, "image_size": 384, "use_distill": True,
                  "momentum": 0.995, "alpha": 0.4},
        "datasets": {builder: {
            "build_info": {"annotations": {"train": []}, "images": ""},
            "vis_processor": {"train": {"name": "blip_image_train", "image_size": 384},
                              "eval": {"name": "blip_image_eval", "image_size": 384}},
            "text_processor": {"train": {"name": "blip_caption"},
                               "eval": {"name": "blip_caption"}}}}}
       for name, arch, batch, builder, model in (
           ("snli_ve_ft.yaml", "albef_classification", 32, "snli_ve", {"num_classes": 3}),
           ("nlvr_ft.yaml", "albef_nlvr", 16, "nlvr", {"flavor": "albef", "num_classes": 2}))},
    **{f"eval/{name}_eval.yaml": {
        "run": {"task": "multimodal_classification", "evaluate": True, "batch_size_eval": 16,
                "max_txt_len": 35, "test_splits": ["test"]},
        "model": {"arch": arch, "model_type": model_type},
        "datasets": {builder: {
            "build_info": {"annotations": {"test": []}, "images": ""},
            "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": 384}},
            "text_processor": {"eval": {"name": "blip_caption"}}}}}
       for name, arch, model_type, builder in (
           ("snli_ve", "albef_classification", "ve", "snli_ve"),
           ("nlvr", "blip_nlvr", "nlvr", "nlvr"), ("nlvr_albef", "albef_nlvr", "nlvr", "nlvr"))},
    **{name: {
        "run": {"task": "captioning", "batch_size": 32, "max_epochs": 5,
                "learning_rate": "1e-5", "weight_decay": 0.05, "max_txt_len": 40, "seed": 42},
        "model": {"arch": "blip_caption", **model},
        "datasets": {"coco_caption": {
            "build_info": {"annotations": {"train": []}, "images": ""},
            "vis_processor": {"train": {"name": "blip_image_train", "image_size": 384},
                              "eval": {"name": "blip_image_eval", "image_size": 384}},
            "text_processor": {"train": {"name": "blip_caption", "prompt": "a picture of "},
                               "eval": {"name": "blip_caption"}}}}}
       for name, model in (("caption_coco_ft.yaml", {"image_size": 384}),
                           ("caption_coco_large_ft.yaml", {"model_type": "large_coco"}))},
    "eval/caption_coco_eval.yaml": {
        "run": {"task": "captioning", "evaluate": True, "batch_size_eval": 16, "num_beams": 3,
                "max_len": 20, "min_len": 5, "prompt": "a picture of ", "test_splits": ["test"]},
        "model": {"arch": "blip_caption", "model_type": "base_coco"},
        "datasets": {"coco_caption": {
            "build_info": {"annotations": {"test": []}, "images": ""},
            "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": 384}},
            "text_processor": {"eval": {"name": "blip_caption"}}}}},
    "eval/exp_coco_ret_eval.yaml": {
        "run": {"task": "retrieval", "evaluate": True, "k_test": 128, "max_txt_len": 77,
                "test_splits": ["test"]},
        "model": {"arch": "clip", "model_type": "vit_large14_336"},
        "datasets": {"coco_retrieval": {
            "build_info": {"annotations": {"test": []}, "images": ""},
            "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": 336}},
            "text_processor": {"eval": {"name": "blip_caption"}}}}},
    "eval/imnet_zs_eval.yaml": {
        "run": {"task": "multimodal_classification", "evaluate": True, "batch_size_eval": 128,
                "test_splits": ["val"]},
        "model": {"arch": "clip", "model_type": "vit_large14_336"},
        "datasets": {"imagenet": {
            "build_info": {"annotations": {"val": []}, "images": ""},
            "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": 336}},
            "text_processor": {"eval": {"name": "blip_caption"}}}}},
    "retrieval_coco_blip2_ft.yaml": {
        "run": {"task": "image_text_pretrain", "batch_size": 32, "max_epochs": 5,
                "learning_rate": "1e-5", "weight_decay": 0.05, "max_txt_len": 32, "seed": 42},
        "model": {"arch": "blip2", "model_type": "coco"},
        "datasets": {"coco_retrieval": {
            "build_info": {"annotations": {"train": []}, "images": ""},
            "vis_processor": {"train": {"name": "blip2_image_train", "image_size": 364}},
            "text_processor": {"train": {"name": "blip_caption"}}}}},
    **{name: {
        "run": {"task": task, "batch_size": 16, "max_epochs": epochs, "learning_rate": "1e-5",
                "weight_decay": 0.001, "max_txt_len": 40, "seed": 42},
        "model": {"arch": arch, "model_type": "msrvtt"},
        "datasets": {builder: {
            "build_info": {"annotations": {"train": []}, "videos": "", "n_frms": 8},
            "vis_processor": {"train": {"name": "alpro_video_train", "image_size": 224}},
            "text_processor": {"train": {"name": text}}}}}
       for name, task, epochs, arch, builder, text in (
           ("msrvtt_retrieval_ft.yaml", "retrieval", 5, "alpro_retrieval", "msrvtt_retrieval",
            "blip_caption"),
           ("msrvtt_qa_ft.yaml", "multimodal_classification", 10, "alpro_qa", "msrvtt_qa",
            "blip_question"))},
    "eval/msrvtt_ret_eval.yaml": {
        "run": {"task": "retrieval", "evaluate": True, "k_test": 128, "max_txt_len": 35,
                "test_splits": ["test"]},
        "model": {"arch": "alpro_retrieval", "model_type": "msrvtt"},
        "datasets": {"msrvtt_retrieval": {
            "build_info": {"annotations": {"test": []}, "videos": "", "n_frms": 8},
            "vis_processor": {"eval": {"name": "alpro_video_eval", "image_size": 224}},
            "text_processor": {"eval": {"name": "blip_caption"}}}}},
    "eval/msvd_qa_eval.yaml": {
        "run": {"task": "multimodal_classification", "evaluate": True, "batch_size_eval": 8,
                "answer_list": [], "test_splits": ["test"]},
        "model": {"arch": "alpro_qa", "model_type": "msvd"},
        "datasets": {"msvd_qa": {
            "build_info": {"annotations": {"test": []}, "videos": "", "n_frms": 8},
            "vis_processor": {"eval": {"name": "alpro_video_eval", "image_size": 224}},
            "text_processor": {"eval": {"name": "blip_question"}}}}},
    "dialogue_avsd_ft.yaml": {
        "run": {"task": "dialogue", "batch_size": 16, "max_epochs": 20, "learning_rate": "5e-5",
                "weight_decay": 0.05, "seed": 42},
        "model": {"arch": "gpt_dialogue", "gpt": {"vocab_size": 50264}},
        "datasets": {"avsd_dialogue": {
            "build_info": {"annotations": {"train": []}, "videos": ""},
            "vis_processor": {"train": {"name": "gpt_video_ft", "tokenizer_json": ""}},
            "text_processor": {"train": {"name": "gpt_dialogue", "tokenizer_json": ""}}}}},
    "eval/dialogue_avsd_eval.yaml": {
        "run": {"task": "dialogue", "evaluate": True, "batch_size_eval": 8,
                "test_splits": ["val"]},
        "model": {"arch": "gpt_dialogue", "gpt": {"vocab_size": 50264}},
        "datasets": {"avsd_dialogue": {
            "build_info": {"annotations": {"val": []}, "videos": ""},
            "vis_processor": {"eval": {"name": "gpt_video_ft", "tokenizer_json": ""}},
            "text_processor": {"eval": {"name": "gpt_dialogue", "tokenizer_json": ""}}}}},
}


def log(msg):
    print(msg, flush=True)


def sync():
    torch.cuda.synchronize()


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}, count={torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    return name


def phase_build():
    from sprc_tpu_torch.ops import _ext

    t0 = time.perf_counter()
    path = _ext.build()
    _ext.library()
    log(f"[build] {path.relative_to(ROOT)} from {len(_ext.sources())} sources in "
        f"{time.perf_counter() - t0:.1f} s (nvcc log: {(_ext.BUILD_DIR / 'nvcc.log').relative_to(ROOT)})")


def phase_kernels(run=None):
    from sprc_tpu_torch import kernel_checks

    assert (kernel_checks.ENCODE_BATCH, kernel_checks.QUERY_BATCH, kernel_checks.GALLERY) == (
        ENCODE_BATCH, QUERY_BATCH, GALLERY), "the kernel checks run at the main path's shapes"
    rows = (run or kernel_checks.run_all)("cuda")
    sync()
    for row in rows:
        timing = (f" kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms"
                  if "ms" in row else "")
        if "tf32x3_ms" in row:
            timing += f", 3xTF32 bound {row['tf32x3_ms']:.4f} ms"
        log(f"[kernels] {row['check']} ({row['shape']}): max_abs {row['max_abs_err']:.3e} "
            f"mean_abs {row['mean_abs_err']:.3e}{timing} -> {'ok' if row['ok'] else 'FAIL'}")
    bad = [r["check"] for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")
    return rows


def _gallery_batches(n, batch, size, seed):
    """Seeded synthetic gallery: normalised (already targetpadded) pixels."""
    rng = np.random.default_rng(seed)
    for s in range(0, n, batch):
        b = min(batch, n - s)
        yield [f"img{i:04d}" for i in range(s, s + b)], rng.standard_normal(
            (b, size, size, 3), dtype=np.float32)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        body = json.loads(resp.read())
    return body, (time.perf_counter() - t0) * 1e3


def _check_answer(results, refs, names, reranked=False):
    """K answers a query, its reference masked, finite scores in descending
    order (stage 1's order; a reranked answer keeps stage 1's scores in the
    rerank's order)."""
    assert len(results) == len(refs), (len(results), len(refs))
    for res, ref in zip(results, refs):
        assert len(res) == K, len(res)
        assert all(r["name"] in names and r["name"] != ref for r in res), "reference not masked"
        scores = [r["score"] for r in res]
        assert all(np.isfinite(scores)), scores
        assert reranked or scores == sorted(scores, reverse=True), scores


def _counters():
    """name -> (object, attribute) of every wrapper's launch count."""
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.ops.attention import flash_attention
    from sprc_tpu_torch.ops.fused_block import (fused_attn_block, fused_mlp_block,
                                                fused_vit_block, fused_vit_block_i8)
    from sprc_tpu_torch.ops.fused_qformer import fused_qformer_layer
    from sprc_tpu_torch.ops.sim_kernels import token_max_sim

    return {"token_max_sim": (token_max_sim, "launches"),
            "fused_vit_block": (fused_vit_block, "launches"),
            "fused_attn_block": (fused_attn_block, "launches"),
            "fused_mlp_block": (fused_mlp_block, "launches"),
            "flash_attention": (flash_attention, "launches"),
            "fused_qformer_layer": (fused_qformer_layer, "launches"),
            "fused_vit_block_i8": (fused_vit_block_i8, "launches"),
            "fused_qformer_layer_int8": (fused_qformer_layer, "launches_int8"),
            "gemm_i8": (primitives.gemm_i8_cuda, "launches"),
            "gemm": (primitives.gemm_cuda, "launches_bf16"),
            "gemm_f32": (primitives.gemm_cuda, "launches_f32"),
            "attention_bf16": (primitives.attention_cuda, "launches_bf16"),
            "attention_f32": (primitives.attention_cuda, "launches_f32"),
            "layer_norm": (primitives.layer_norm_cuda, "launches"),
            "layer_norm_q8": (primitives.layer_norm_cuda, "launches_q8"),
            "quantize_static": (primitives.quantize_static_cuda, "launches"),
            "quantize_rows": (primitives.quantize_rows_cuda, "launches")}


# the kernels each configuration's main path must launch; the other
# configuration's must not move
PATH_KERNELS = {"bf16": ("token_max_sim", "fused_vit_block", "fused_qformer_layer", "gemm",
                         "gemm_f32", "attention_bf16", "attention_f32", "layer_norm"),
                "int8": ("token_max_sim", "fused_vit_block_i8", "fused_qformer_layer_int8",
                         "gemm_i8", "attention_bf16", "attention_f32", "layer_norm",
                         "layer_norm_q8", "quantize_static", "quantize_rows"),
                # phase 8: serving from a saved index (stage 1 and the rerank:
                # no tower), one int8 rerank tile (the scorer alone), and
                # validate_rerank on EVA ViT-g (the gallery encode too)
                "rerank": ("token_max_sim", "fused_qformer_layer", "gemm_f32", "attention_f32",
                           "layer_norm"),
                "rerank int8": ("fused_qformer_layer_int8", "gemm_i8", "attention_f32",
                                "layer_norm", "quantize_rows"),
                "rerank EVA": ("token_max_sim", "fused_vit_block", "fused_qformer_layer", "gemm",
                               "gemm_f32", "attention_bf16", "attention_f32", "layer_norm")}
# the int8 quantisers' launches per batch: an encode batch of either model
# (the ctx of every block; the Q-Former's rows, ctx and GELU outputs and the
# image rows once a pass) and a query batch (the fusion pass, with the image
# rows once, and the prompt pass)
INT8_QUANTIZE_PER_BATCH = {"encode": {"quantize_static": 23, "quantize_rows": 61},
                           "encode EVA": {"quantize_static": 39, "quantize_rows": 61},
                           "query": {"quantize_static": 0, "quantize_rows": 133},
                           # a rerank tile: the fusion pass's 85 (no prompt pass)
                           "rerank": {"quantize_static": 0, "quantize_rows": 85}}
QUANTIZERS = ("quantize_static", "quantize_rows")


def stage_pass(tag, what, counters, fn, quantize=None):
    """``fn()`` once more through the kernels, every stage against its plain
    version on the same inputs, with the quantisers' launches of that one
    batch (``quantize``: what they must be). The launches of this comparison
    are not the main path's: the counters are put back."""
    from sprc_tpu_torch import kernel_checks
    from sprc_tpu_torch.ops import primitives

    before = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    stages = kernel_checks.StageRecorder()
    with torch.inference_mode(), primitives.stage_check(stages):
        fn()
    sync()
    batch = {k: getattr(counters[k][0], counters[k][1]) - before[k] for k in QUANTIZERS}
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, before[k])
    log(f"[main {tag}] {what}, stage by stage: quantiser launches of the batch "
        + ", ".join(f"{k} {v}" for k, v in batch.items()))
    want = quantize or dict.fromkeys(QUANTIZERS, 0)
    if batch != want:
        raise RuntimeError(f"{tag} {what}: quantiser launches {batch}, expected {want}")
    for row in stages.rows():
        log(f"[main {tag}] {what}, stage by stage: {row['kind']}: {row['calls']} calls, worst "
            f"share that differs {row['differ']:.3e}, worst difference {row['err']:.3e} -> "
            f"{'ok' if row['ok'] else 'FAIL'}")
    if not stages.ok():
        raise RuntimeError(f"{tag} {what}: a stage disagrees with its plain version: "
                           f"{[r['kind'] for r in stages.rows() if not r['ok']]}")
    return stages.rows()


def model_alone_rate(model, batches, frozen_dtype, encode=None, fills=(0,)):
    """imgs/s of the model alone: the engine's device work on ``batches``
    already on the card (``profile_serving.model_alone``), one synchronize
    at the end, after one warm-up pass."""
    from sprc_tpu_torch.cli.profile_serving import model_alone

    run = model_alone(model, batches, frozen_dtype, encode or model.extract_target_features,
                      fills, DEVICE)
    with torch.inference_mode():
        run()
        sync()
        t0 = time.perf_counter()
        run()
        sync()
    return sum(len(names) for names, *_ in batches) / (time.perf_counter() - t0)


def check_dataplane():
    """4d's decode checks (phase 4d of the docstring), or the reason the
    machine cannot build the data-plane. A build that fails for another
    reason fails the run."""
    from sprc_tpu_torch.data import native
    from sprc_tpu_torch.data.dataplane_fixtures import TARGETPAD_DIM
    from sprc_tpu_torch.native import build as dataplane_build
    from sprc_tpu_torch.utils.artifacts import encode_png

    t0 = time.perf_counter()
    try:
        path = dataplane_build.build()
    except FileNotFoundError as e:  # no g++
        reason = str(e)
    except RuntimeError as e:
        missing = [line.strip() for line in str(e).splitlines()
                   if "No such file or directory" in line or "cannot find -l" in line]
        if not missing:
            raise
        reason = missing[0]
    else:
        reason = None
    if reason is not None:
        log(f"[4d] data-plane not built on this machine ({reason}): the decode checks are "
            f"left out (ROADMAP Queue C)")
        return {"built": False, "reason": reason}
    ldd = subprocess.run(["ldd", str(path)], capture_output=True, text=True, timeout=60).stdout
    linked = [line.strip() for line in ldd.splitlines() if "jpeg" in line or "png" in line]
    log(f"[4d] data-plane built with g++ in {time.perf_counter() - t0:.1f} s: "
        f"{path.relative_to(ROOT)}; linked {linked}")
    rng = np.random.default_rng(SEED + 201)
    for h, w in [(1, 1), (37, 53), (224, 224), (480, 640), (333, 97)]:
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if not np.array_equal(native.decode(encode_png(arr)), arr):
            raise RuntimeError(f"data-plane: a {h} x {w} PNG did not decode bit for bit")
    fixtures = os.path.join(ROOT, "tests", "fixtures", "dataplane")
    tfm = native.NativeTransform(dim=TARGETPAD_DIM)
    worst = {"decode_max_levels": 0, "decode_values_differing": 0, "preprocess_max_abs": 0.0}
    names = sorted(f[: -len(".jpg")] for f in os.listdir(fixtures) if f.endswith(".jpg"))
    for name in names:
        stem = os.path.join(fixtures, name)
        with open(stem + ".jpg", "rb") as f:
            decoded = native.decode(f.read()).astype(np.int16)
        diff = np.abs(decoded - np.load(stem + ".decode.npy"))
        worst["decode_max_levels"] = max(worst["decode_max_levels"], int(diff.max()))
        worst["decode_values_differing"] += int((diff != 0).sum())
        err = np.abs(tfm(stem + ".jpg") - np.load(stem + f".targetpad{TARGETPAD_DIM}.npy")).max()
        worst["preprocess_max_abs"] = max(worst["preprocess_max_abs"], float(err))
    log(f"[4d] data-plane: 5 PNGs decoded bit for bit; {len(names)} JPEG fixtures against "
        f"Pillow's arrays: decode max {worst['decode_max_levels']} levels, "
        f"{worst['decode_values_differing']} values differ; targetpad {TARGETPAD_DIM} max_abs "
        f"{worst['preprocess_max_abs']:.3e} (bound {DATAPLANE_PREPROCESS_BOUND:.4f})")
    if not (len(names) == 5 and worst["decode_max_levels"] <= DATAPLANE_DECODE_LEVELS
            and worst["preprocess_max_abs"] <= DATAPLANE_PREPROCESS_BOUND):
        raise RuntimeError(f"data-plane against the JPEG fixtures: {worst}")
    return {"built": True, "linked": linked, **worst}


def phase_raw_encode(model, engine, counters, bounds):
    """Phase 4d (the docstring) on phase 4's model and engine; the counters
    are put back, so phase 4's main path counts only its own launches."""
    from sprc_tpu_torch.data.transforms import device_preprocess
    from sprc_tpu_torch.utils.artifacts import synthetic_raw_batches

    saved = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    dataplane = check_dataplane()
    raw = list(synthetic_raw_batches(SEED + 200, RAW_IMAGES, ENCODE_BATCH, RAW_BUFFER))
    pre = device_preprocess(dim=model.cfg.image_size)
    _, images, sizes = raw[0]
    with torch.inference_mode():
        on_card = pre(torch.from_numpy(images).to(DEVICE), torch.from_numpy(sizes).to(DEVICE))
        on_cpu = pre(torch.from_numpy(images), torch.from_numpy(sizes))
        pre_err = (on_card.cpu() - on_cpu).abs().max().item()
    kinds = {"padded": int((sizes.max(1) / sizes.min(1) >= 1.25).sum()),
             "under 224": int((sizes.min(1) < 224).sum())}
    log(f"[4d] device_preprocess, card against CPU (TF32 off), {len(sizes)} images in a "
        f"{RAW_BUFFER} x {RAW_BUFFER} buffer ({kinds}): max_abs {pre_err:.3e} (bound "
        f"{PREPROCESS_MAX_ABS})")
    if not pre_err <= PREPROCESS_MAX_ABS:
        raise RuntimeError(f"device_preprocess: card against CPU {pre_err}")

    engine.build_index_raw(iter(raw[:1]))  # warm-up
    sync()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    t0 = time.perf_counter()
    index = engine.build_index_raw(iter(raw))
    sync()
    raw_s = time.perf_counter() - t0
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    depth = model.visual_encoder.cfg.depth
    want = {"fused_vit_block": depth * len(raw), "fused_qformer_layer": 12 * len(raw)}
    log(f"[4d] build_index_raw: {RAW_IMAGES} images in {len(raw)} batches in {raw_s:.3f} s; "
        f"launches {launches}")
    if {k: launches[k] for k in want} != want:
        raise RuntimeError(f"build_index_raw: launches {launches}, expected {want}")
    with torch.inference_mode():
        pixels = [(n, pre(torch.from_numpy(im).to(DEVICE), torch.from_numpy(sz).to(DEVICE))
                   .cpu().numpy()) for n, im, sz in raw]
    ref = engine.build_index(iter(pixels))
    assert index.names == ref.names and index.n == ref.n == RAW_IMAGES
    d = (index.target_feats - ref.target_feats).abs()
    f = (index.frozen_embeds.float() - ref.frozen_embeds.float()).abs()
    log(f"[4d] build_index_raw against build_index over device_preprocess's pixels: target "
        f"feats max_abs {d.max().item():.3e} mean_abs {d.mean().item():.3e}; frozen embeds "
        f"max_abs {f.max().item():.3e}")
    if not (d.max().item() <= bounds["target"][0] and d.mean().item() <= bounds["target"][1]
            and f.max().item() <= bounds["frozen"][0]):
        raise RuntimeError("build_index_raw disagrees with build_index over the same pixels")
    alone = model_alone_rate(model, raw, engine.frozen_host_dtype,
                             lambda im, sz: model.extract_target_features(pre(im, sz)), (0, 1))
    rate = RAW_IMAGES / raw_s
    log(f"[4d] raw encode: build_index_raw {rate:.2f} imgs/s, the model alone (with "
        f"device_preprocess) {alone:.2f} imgs/s: {rate / alone:.3f} of it")
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, saved[k])
    del index, ref, pixels, on_card
    return {"dataplane": dataplane, "preprocess_card_vs_cpu_max_abs": pre_err,
            "target_feats_max_abs": d.max().item(), "launches": launches,
            "encode_imgs_per_s": rate, "model_alone_imgs_per_s": alone}


def phase_main_path(work, tag, gallery, bounds, model_kwargs=(), serve_flags=(), calibrate=False,
                    raw_phase=False):
    """One configuration end to end. ``tag`` names it in the log ("bf16":
    bf16 tower and fp32 Q-Former; "int8": the int8 serving configuration).
    ``bounds`` None: the free-running all-plain comparison is a report. The
    quantisers' launches are held per encode batch and per query batch
    (:data:`INT8_QUANTIZE_PER_BATCH` on the int8 path, none on the other)."""
    per_batch = INT8_QUANTIZE_PER_BATCH if tag == "int8" else None
    from sprc_tpu_torch.cli.serve import build_service, make_parser, make_server
    from sprc_tpu_torch.loader import calibrate_vit_act_scales, load_model
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.retrieval.engine import RetrievalEngine
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.utils.artifacts import (synthetic_calibration_images,
                                                write_synthetic_bert_vocab)

    os.makedirs(work, exist_ok=True)
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    index_path = os.path.join(work, f"gallery_index_{tag}")
    counters = _counters()

    t0 = time.perf_counter()
    model = load_model("blip2_cir_align_prompt", "pretrain_vitL", device=DEVICE, seed=SEED,
                       **dict(model_kwargs))
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[main {tag}] model blip2_cir_align_prompt/pretrain_vitL on {DEVICE}: "
        f"{n_params / 1e6:.1f} M params, built in {time.perf_counter() - t0:.1f} s")
    calibration = {}  # launches of the calibration pass (set-up)
    if calibrate:  # the tower then serves in "int8_static"
        t0 = time.perf_counter()
        flash, attr = counters["flash_attention"]
        before = getattr(flash, attr)
        scales = calibrate_vit_act_scales(
            model, synthetic_calibration_images(SEED + 99, CALIB_IMAGES), batch=CALIB_IMAGES)
        sync()
        calib_flash = getattr(flash, attr) - before
        calibration = {"flash_attention": calib_flash}
        log(f"[main {tag}] calibrated on {CALIB_IMAGES} seeded images in "
            f"{time.perf_counter() - t0:.1f} s, {calib_flash} flash_attention launches: "
            + ", ".join(f"{k} {v:.5f}" for k, v in scales))
        depth = model.visual_encoder.cfg.depth
        assert calib_flash == depth, f"the calibration pass launched flash_attention {calib_flash}x"
        assert all(np.isfinite(v) and v > 0 for _, v in scales), scales
        assert model.visual_encoder.cfg.quant == "int8_static"
    cfg = model.cfg
    size, S, D = cfg.image_size, cfg.vit_config().seq_len, cfg.vit_config().width
    engine = RetrievalEngine(model, BertWordPieceTokenizer.from_vocab_file(vocab), device=DEVICE,
                             encode_batch=ENCODE_BATCH, query_batch=QUERY_BATCH,
                             frozen_host_dtype=torch.bfloat16)
    engine.build_index(_gallery_batches(ENCODE_BATCH, ENCODE_BATCH, size, SEED + 100))  # warm-up
    sync()
    alone = model_alone_rate(model, gallery, engine.frozen_host_dtype)

    for obj, attr in counters.values():  # count only the main path from here on
        setattr(obj, attr, 0)
    t0 = time.perf_counter()
    index = engine.build_index(iter(gallery))
    sync()
    encode_s = time.perf_counter() - t0
    encode_launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    tf = index.target_feats
    assert tf.shape == (GALLERY, cfg.num_query_token, cfg.embed_dim), tf.shape
    assert bool(torch.isfinite(tf).all())
    norms = tf.norm(dim=-1)
    assert bool(((norms - 1).abs() < 1e-3).all()), "target features are not unit norm"
    assert tuple(index.frozen_embeds.shape) == (GALLERY, S, D)
    log(f"[main {tag}] gallery encode: {GALLERY} images in {encode_s:.3f} s = "
        f"{GALLERY / encode_s:.2f} imgs/s (encode_batch {ENCODE_BATCH}); the model alone "
        f"{alone:.2f} imgs/s: {GALLERY / encode_s / alone:.3f} of it")
    index.save(index_path)

    # the first gallery batch again: stage by stage, then through the
    # all-plain path on the card (plain versions: no kernel launches)
    first = torch.from_numpy(gallery[0][1]).to(DEVICE)
    stage_pass(tag, f"gallery encode, {ENCODE_BATCH} images", counters,
               lambda: model.extract_target_features(first), per_batch and per_batch["encode"])
    with torch.inference_mode(), primitives.plain_reference():
        plain_tf, plain_frozen = model.extract_target_features(first)
    sync()
    b = ENCODE_BATCH
    err_frozen = (plain_frozen.to(index.frozen_embeds.dtype).float().cpu()
                  - index.frozen_embeds[:b].float()).abs()
    err_tf = (plain_tf.float() - tf[:b]).abs()
    log(f"[main {tag}] all-plain gallery encode on the card, {b} images: frozen embeds (bf16) "
        f"max_abs {err_frozen.max().item():.3e} mean_abs {err_frozen.mean().item():.3e}; "
        f"target feats max_abs {err_tf.max().item():.3e} mean_abs {err_tf.mean().item():.3e}")
    if bounds is not None:
        assert err_frozen.max().item() <= bounds["frozen"][0]
        assert err_frozen.mean().item() <= bounds["frozen"][1]
        assert err_tf.max().item() <= bounds["target"][0]
        assert err_tf.mean().item() <= bounds["target"][1]
    target_feats = tf.cpu()
    raw = phase_raw_encode(model, engine, counters, bounds) if raw_phase else None
    del engine, model, index, tf, first
    torch.cuda.empty_cache()

    args = make_parser().parse_args(["--index-path", index_path, "--device", DEVICE,
                                     "--model-type", "pretrain_vitL",
                                     "--vocab-path", vocab, "--seed", str(SEED),
                                     "--query-batch", str(QUERY_BATCH), "--port", "0",
                                     *serve_flags])
    service = build_service(args)
    service.warm()
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    names = set(service.index.names)
    rng = np.random.default_rng(SEED + 1)
    words = ["red", "dress", "with", "long", "sleeves", "and", "a", "blue", "shirt", "dog"]
    refs = [service.index.names[i] for i in rng.choice(GALLERY, QUERY_BATCH, replace=False)]
    caps = [" ".join(rng.choice(words, rng.integers(3, 9))) for _ in refs]
    try:
        with urllib.request.urlopen(f"{base}/health", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health == {"status": "ok", "gallery": GALLERY}, health
        single_ms, batch_ms = [], []
        for _ in range(5):
            out, ms = _post(f"{base}/query", {"reference": refs[0], "caption": caps[0], "k": K})
            _check_answer(out["results"], refs[:1], names)
            single_ms.append(ms)
        for _ in range(3):
            out, ms = _post(f"{base}/query", {"queries": [
                {"reference": r, "caption": c} for r, c in zip(refs, caps)], "k": K})
            _check_answer(out["results"], refs, names)
            batch_ms.append(ms)
        served = out["results"]
    finally:
        server.shutdown()
        thread.join(timeout=30)
        server.server_close()
    assert not thread.is_alive(), "server thread did not stop"
    sync()
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    log(f"[main {tag}] HTTP /health ok; POST /query 1 query: median {np.median(single_ms):.3f} ms "
        f"(5 runs); {len(refs)} queries: median {np.median(batch_ms):.3f} ms (3 runs)")
    # the quantisers per batch: GALLERY / ENCODE_BATCH encode batches, then one
    # query batch per request and one to warm the server (K1 launches once each)
    batches = {"encode": GALLERY // ENCODE_BATCH, "query": launches["token_max_sim"]}
    got = {"encode": {k: encode_launches[k] for k in QUANTIZERS},
           "query": {k: launches[k] - encode_launches[k] for k in QUANTIZERS}}
    want = {part: {k: (per_batch[part][k] if per_batch else 0) * n for k in QUANTIZERS}
            for part, n in batches.items()}
    log(f"[main {tag}] quantiser launches: {got['encode']} over {batches['encode']} encode "
        f"batches, {got['query']} over {batches['query']} query batches")
    if got != want:
        raise RuntimeError(f"{tag}: quantiser launches {got}, expected {want}")

    # the same 32 queries (the same stored reference embeds and target feats):
    # stage by stage, then through the all-plain path on the card
    engine, index = service.engine, service.index
    tok = engine.tokenizer(caps, max_length=engine.model.cfg.max_txt_len)
    query = (index.reference_embeds(refs).to(DEVICE), index.target_feats,
             torch.as_tensor(tok["input_ids"], device=DEVICE),
             torch.as_tensor(tok["attention_mask"], device=DEVICE))
    stage_pass(tag, f"{len(refs)} queries", counters, lambda: engine.model.inference(*query),
               per_batch and per_batch["query"])
    with torch.inference_mode(), primitives.plain_reference():
        plain = engine.model.inference(*query).cpu().numpy()
    name_idx = {n: i for i, n in enumerate(index.names)}
    diffs, top1_same = [], 0
    for row, res, ref in zip(plain, served, refs):
        diffs += [abs(row[name_idx[r["name"]]] - r["score"]) for r in res]
        order = [j for j in np.argsort(-row, kind="stable") if index.names[j] != ref]
        top1_same += index.names[order[0]] == res[0]["name"]
    log(f"[main {tag}] all-plain path on the card: max |score diff| {max(diffs):.3e} over the "
        f"served top-{K}; top-1 equal on {top1_same}/{len(refs)}")
    if bounds is not None:
        assert max(diffs) <= bounds["score"], max(diffs)
        assert top1_same >= bounds["top1"], top1_same
    del service, engine, index
    torch.cuda.empty_cache()
    return {"launches": launches, "calibration_launches": calibration,
            "encode_imgs_per_s": GALLERY / encode_s, "model_alone_imgs_per_s": alone, "raw": raw,
            "query_1_median_ms": float(np.median(single_ms)),
            "query_32_median_ms": float(np.median(batch_ms)),
            "target_feats": target_feats, "served": served}


def phase_eva_int8(gallery):
    """One encode batch of the int8 serving configuration of
    blip2_cir_align_prompt / pretrain (EVA ViT-g, full width; scales
    calibrated on the seeded images of phase 4b): the launches of that batch
    (39 int8 blocks, each quantising its ctx once; 12 int8 Q-Former layers and
    the image rows quantised once), its output, and the batch stage by
    stage."""
    from sprc_tpu_torch.loader import calibrate_vit_act_scales, load_model
    from sprc_tpu_torch.utils.artifacts import synthetic_calibration_images

    tag = "int8 EVA"
    counters = _counters()
    t0 = time.perf_counter()
    model = load_model("blip2_cir_align_prompt", "pretrain", device=DEVICE, seed=SEED,
                       vit_quant="int8_calib", qformer_int8=True)
    calibrate_vit_act_scales(model, synthetic_calibration_images(SEED + 99, CALIB_IMAGES),
                             batch=CALIB_IMAGES)
    sync()
    vcfg = model.cfg.vit_config()
    log(f"[main {tag}] model blip2_cir_align_prompt/pretrain on {DEVICE}, tower "
        f"{vcfg.quant!r}, W {vcfg.width}, depth {vcfg.depth}: built and calibrated in "
        f"{time.perf_counter() - t0:.1f} s")
    first = torch.from_numpy(gallery[0][1]).to(DEVICE)
    with torch.inference_mode():
        model.extract_target_features(first)  # warm-up
        sync()
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        tf, frozen = model.extract_target_features(first)
        sync()
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    log(f"[counters] launches of one {tag} encode batch: {launches}")
    want = {"fused_vit_block_i8": vcfg.depth, "fused_qformer_layer_int8": 12,
            **INT8_QUANTIZE_PER_BATCH["encode EVA"]}
    if {k: launches[k] for k in want} != want:
        raise RuntimeError(f"{tag}: launches {launches}, expected {want}")
    assert tf.shape == (ENCODE_BATCH, model.cfg.num_query_token, model.cfg.embed_dim), tf.shape
    assert bool(torch.isfinite(tf).all()) and bool(torch.isfinite(frozen.float()).all())
    assert bool(((tf.norm(dim=-1) - 1).abs() < 1e-3).all()), "target features are not unit norm"
    stage_pass(tag, f"gallery encode, {ENCODE_BATCH} images", counters,
               lambda: model.extract_target_features(first), INT8_QUANTIZE_PER_BATCH["encode EVA"])
    del model, tf, frozen, first
    torch.cuda.empty_cache()
    return launches


def _write_cirr_val(root, names, n_queries, seed, split="val"):
    """A synthetic CIRR val (or test1) split in the reference's on-disk
    layout (JSON only: the images are the seeded pixel batches, or the
    files under dev/ where a phase writes them)."""
    rng = np.random.default_rng(seed)
    words = ["red", "dress", "with", "long", "sleeves", "and", "a", "blue", "shirt", "dog"]
    triplets = []
    for i in range(n_queries):
        members = [names[j] for j in rng.choice(len(names), 6, replace=False)]
        triplets.append({"pairid": i, "reference": members[0], "target_hard": members[1],
                         "caption": " ".join(rng.choice(words, rng.integers(3, 9))),
                         "img_set": {"members": members}})
    for sub, name, payload in (("captions", f"cap.rc2.{split}.json", triplets),
                               ("image_splits", f"split.rc2.{split}.json",
                                {n: f"dev/{n}.png" for n in names})):
        os.makedirs(os.path.join(root, "cirr", sub), exist_ok=True)
        with open(os.path.join(root, "cirr", sub, name), "w") as f:
            json.dump(payload, f)
    return root


CIRR_KEYS = ["group_recall_at1", "group_recall_at2", "group_recall_at3", "recall_at1",
             "recall_at5", "recall_at10", "recall_at50", "mean(R@5+R_s@1)", "arithmetic_mean",
             "harmonic_mean", "geometric_mean"]


def phase_validate(work, route, gallery):
    """The port's validate path on blip2_cir_align_prompt / pretrain (EVA
    ViT-g, full width) with the tower on ``route``."""
    from sprc_tpu_torch.cli import validate
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    tag = f"validate {route}"
    overrides, own = ROUTES[route]
    os.makedirs(work, exist_ok=True)
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    names = [n for batch_names, _ in gallery for n in batch_names]
    data = _write_cirr_val(os.path.join(work, "cirr_val"), names, VALIDATE_QUERIES, SEED + 2)
    argv = ["--dataset", "CIRR", "--data-path", data, "--vocab-path", vocab,
            "--encode-batch", str(ENCODE_BATCH), "--query-batch", str(QUERY_BATCH)]
    args = validate.make_parser().parse_args(argv + (["--model-overrides", *overrides]
                                                    if overrides else []))
    assert (args.device, args.model_type, args.model_path) == ("cuda", "pretrain", None)
    counters = _counters()

    t0 = time.perf_counter()
    model, engine = validate.build_engine(args)
    sync()
    vcfg = model.cfg.vit_config()
    assert (vcfg.width, vcfg.depth, vcfg.head_dim, vcfg.mlp_hidden) == (1408, 39, 88, 6144)
    assert model.cfg.qformer_config().encoder_width == 1408
    log(f"[{tag}] model blip2_cir_align_prompt/pretrain on {DEVICE}: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, tower route "
        f"fused_block={vcfg.fused_block!r} fused_mlp={vcfg.fused_mlp}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    engine.build_index(iter(gallery[:1]))  # warm-up
    sync()
    alone = model_alone_rate(model, gallery, engine.frozen_host_dtype)

    timed = {}
    inner = engine.build_index

    def build_index(batches):  # the engine's own, with a clock around it
        t0 = time.perf_counter()
        timed["index"] = inner(batches)
        sync()
        timed["encode_s"] = time.perf_counter() - t0
        return timed["index"]

    engine.build_index = build_index
    queries = validate.cirr_queries(data)
    assert len(queries["refs"]) == VALIDATE_QUERIES and all(len(g) == 6 for g in queries["groups"])
    for obj, attr in counters.values():  # count only the main path from here on
        setattr(obj, attr, 0)
    t0 = time.perf_counter()
    results = validate.evaluate_cirr(engine, iter(gallery), queries)
    sync()
    total_s = time.perf_counter() - t0
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    engine.build_index = inner
    index = timed["index"]

    assert list(results) == CIRR_KEYS, list(results)
    assert all(np.isfinite(v) and 0.0 <= v <= 100.0 for v in results.values()), results
    assert results["recall_at50"] >= results["recall_at10"] >= results["recall_at1"]
    assert results["group_recall_at3"] >= results["group_recall_at2"] >= results["group_recall_at1"]
    tf = index.target_feats
    assert tf.shape == (GALLERY, model.cfg.num_query_token, model.cfg.embed_dim), tf.shape
    assert bool(torch.isfinite(tf).all())
    assert bool(((tf.norm(dim=-1) - 1).abs() < 1e-3).all()), "target features are not unit norm"
    assert tuple(index.frozen_embeds.shape) == (GALLERY, vcfg.seq_len, vcfg.width)
    imgs_per_s = GALLERY / timed["encode_s"]
    log(f"[{tag}] {GALLERY} images encoded in {timed['encode_s']:.3f} s = {imgs_per_s:.2f} "
        f"imgs/s (encode_batch {ENCODE_BATCH}; the model alone {alone:.2f} imgs/s: "
        f"{imgs_per_s / alone:.3f} of it); {VALIDATE_QUERIES} queries scored; "
        f"{total_s:.3f} s in all")
    log(f"[{tag}] " + json.dumps({"route": route, "encode_imgs_per_s": imgs_per_s,
                                  "metrics": results}))

    # counters: the route's own kernels 39 times per image batch, the other routes' never
    log(f"[counters] launches during the {tag} path: {launches}")
    batches = len(gallery)
    for name in ROUTE_KERNELS:
        want = vcfg.depth * batches if name in own else 0
        if launches[name] != want:
            raise RuntimeError(f"{tag}: {name} launched {launches[name]}x, expected {want}")
    missing = [k for k in ("fused_qformer_layer", "token_max_sim", "gemm", "gemm_f32",
                           "attention_bf16", "attention_f32", "layer_norm") if launches[k] <= 0]
    moved = [k for k in ("fused_vit_block_i8", "fused_qformer_layer_int8", "gemm_i8",
                         "layer_norm_q8", "quantize_static", "quantize_rows") if launches[k] != 0]
    if missing or moved:
        raise RuntimeError(f"{tag}: not launched {missing}; launched from the int8 path {moved}")

    # the first gallery batch and the first 32 queries again: stage by stage,
    # then through the all-plain path on the card
    first = torch.from_numpy(gallery[0][1]).to(DEVICE)
    stage_pass(tag, f"gallery encode, {ENCODE_BATCH} images", counters,
               lambda: model.extract_target_features(first))
    with torch.inference_mode(), primitives.plain_reference():
        plain_tf, plain_frozen = model.extract_target_features(first)
    sync()
    b = ENCODE_BATCH
    err_frozen = (plain_frozen.cpu() - index.frozen_embeds[:b].float()).abs()
    err_tf = (plain_tf.float() - tf[:b]).abs()
    log(f"[{tag}] all-plain gallery encode on the card, {b} images: frozen embeds max_abs "
        f"{err_frozen.max().item():.3e} mean_abs {err_frozen.mean().item():.3e}; target feats "
        f"max_abs {err_tf.max().item():.3e} mean_abs {err_tf.mean().item():.3e}")
    assert err_frozen.max().item() <= EVA_BOUNDS["frozen"][0]
    assert err_frozen.mean().item() <= EVA_BOUNDS["frozen"][1]
    assert err_tf.max().item() <= EVA_BOUNDS["target"][0]
    assert err_tf.mean().item() <= EVA_BOUNDS["target"][1]

    refs, caps = queries["refs"][:QUERY_BATCH], queries["captions"][:QUERY_BATCH]
    tok = engine.tokenizer(caps, max_length=model.cfg.max_txt_len)
    query = (index.reference_embeds(refs).to(DEVICE), index.target_feats,
             torch.as_tensor(tok["input_ids"], device=DEVICE),
             torch.as_tensor(tok["attention_mask"], device=DEVICE))
    stage_pass(tag, f"{len(refs)} queries", counters, lambda: model.inference(*query))
    with torch.inference_mode():
        got = model.inference(*query).cpu().numpy()
        with primitives.plain_reference():
            plain = model.inference(*query).cpu().numpy()
    for k, (obj, attr) in counters.items():  # that comparison is not the main path either
        setattr(obj, attr, launches[k])
    top1_same = int((got.argmax(-1) == plain.argmax(-1)).sum())
    log(f"[{tag}] all-plain path on the card: max |score diff| {np.abs(got - plain).max():.3e} "
        f"over {got.shape}; top-1 equal on {top1_same}/{len(refs)}")
    assert np.abs(got - plain).max() <= EVA_BOUNDS["score"]
    assert top1_same >= EVA_BOUNDS["top1"]
    target_feats = tf.cpu()
    del engine, model, index, tf, first, query
    torch.cuda.empty_cache()
    return {"route": route, "launches": launches, "encode_imgs_per_s": imgs_per_s,
            "model_alone_imgs_per_s": alone, "metrics": results, "target_feats": target_feats}


def _save_released(model, path):
    """The model's weights in the fine-tuned release layout that
    ``loader.read_checkpoint`` reads ({epoch, ClassName: state_dict})."""
    torch.save({"epoch": 0, type(model).__name__: model.state_dict()}, path)
    return path


def _tile_rows(index, refs, cands):
    """A rerank tile's reference and candidate rows, gathered from the
    index's host store as rerank_rankings gathers them."""
    return index.reference_embeds(refs), index.reference_embeds(list(np.asarray(cands).ravel()))


def _hold_tile(tag, counters, scorer, rows, caps, quantize=None):
    """One rerank tile through ``scorer``: stage by stage (every kernel launch
    against its plain version on the same inputs), then the all-plain tile on
    the card against the kernel tile (a report: max |score difference|, and
    how many queries keep their reranked order). The launches are put back."""
    from sprc_tpu_torch.ops import primitives

    n = scorer.step * scorer.top
    what = f"one tile, {len(caps)} x {scorer.top} = {n} candidates"
    stages = stage_pass(tag, what, counters, lambda: scorer(*rows, caps), quantize)
    kept = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    got = scorer(*rows, caps)
    with primitives.plain_reference():
        plain = scorer(*rows, caps)
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, kept[k])
    order = lambda v: np.argsort(1.0 - v.reshape(len(caps), -1), axis=-1, kind="stable")  # noqa: E731
    same = int((order(got) == order(plain)).all(-1).sum())
    err = float(np.abs(got - plain).max())
    log(f"[{tag}] {what}: all-plain tile on the card against the kernel tile: max |score "
        f"difference| {err:.3e} (scores {got.min():.4f} to {got.max():.4f}); reranked order "
        f"equal for {same}/{len(caps)} queries")
    assert np.isfinite(got).all() and ((got >= 0) & (got <= 1)).all()
    return {"stages": stages, "plain_max_abs": err, "order_equal": same}


def phase_rerank_serve(work, gallery):
    """Phase 8a and 8c on ViT-L (the docstring): serving with the ITM rerank,
    one tile stage by stage in fp32 and in int8."""
    from sprc_tpu_torch.cli.serve import RetrievalService, build_service, make_parser, make_server
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.retrieval.engine import RetrievalEngine
    from sprc_tpu_torch.retrieval.rerank import ItmRerankScorer
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    tag = "rerank"
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    counters = _counters()
    t0 = time.perf_counter()
    model = load_model("blip2_cir_rerank", "pretrain_vitL", device=DEVICE, seed=SEED)
    ckpt = _save_released(model, os.path.join(work, "rerank_vitl.pt"))
    engine = RetrievalEngine(model, device=DEVICE, encode_batch=ENCODE_BATCH,
                             frozen_host_dtype=torch.bfloat16)
    index_path = os.path.join(work, "gallery_index_rerank")
    engine.build_index(iter(gallery)).save(index_path)  # set-up: the served index
    sync()
    log(f"[{tag}] blip2_cir_rerank/pretrain_vitL: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}"
        f" M params (the twin included), saved to {os.path.relpath(ckpt, ROOT)}, "
        f"{GALLERY}-image index built through the twin, in {time.perf_counter() - t0:.1f} s")
    del model, engine
    torch.cuda.empty_cache()

    args = make_parser().parse_args([
        "--index-path", index_path, "--device", DEVICE, "--model-name", "blip2_cir_rerank",
        "--model-type", "pretrain_vitL", "--model-path", ckpt, "--vocab-path", vocab,
        "--query-batch", str(QUERY_BATCH), "--rerank-top", str(RERANK_TOP),
        "--rerank-step", str(RERANK_STEP), "--port", "0"])
    for obj, attr in counters.values():  # count only the rerank serving path from here on
        setattr(obj, attr, 0)
    service = build_service(args)
    service.warm()
    scorer = service.rerank_scorer
    servers = [make_server(service, "127.0.0.1", 0)]
    # a second service on the same engine, whose rerank needs the whole gallery
    small = RetrievalService(service.engine, service.index, rerank_scorer=ItmRerankScorer(
        service.engine.model, service.engine.tokenizer, top=GALLERY, step=RERANK_STEP))
    servers.append(make_server(small, "127.0.0.1", 0))
    threads = [threading.Thread(target=srv.serve_forever, daemon=True) for srv in servers]
    for t in threads:
        t.start()
    base, base_small = (f"http://127.0.0.1:{srv.server_address[1]}" for srv in servers)
    rng = np.random.default_rng(SEED + 7)
    words = ["red", "dress", "with", "long", "sleeves", "and", "a", "blue", "shirt", "dog"]
    names = service.index.names
    refs = [names[i] for i in rng.choice(GALLERY, QUERY_BATCH, replace=False)]
    caps = [" ".join(rng.choice(words, rng.integers(3, 9))) for _ in refs]
    batch = [{"reference": r, "caption": c} for r, c in zip(refs, caps)]
    times = {"single": [], "batch": [], "stage1_batch": []}
    try:
        for _ in range(3):
            single, ms = _post(f"{base}/query", {**batch[0], "k": RERANK_TOP, "rerank": True})
            times["single"].append(ms)
        for _ in range(2):
            reranked, ms = _post(f"{base}/query", {"queries": batch, "k": RERANK_TOP,
                                                    "rerank": True})
            times["batch"].append(ms)
        stage1, ms = _post(f"{base}/query", {"queries": batch, "k": RERANK_TOP})
        times["stage1_batch"].append(ms)
        try:
            _post(f"{base_small}/query", {**batch[0], "rerank": True})
            refused = None
        except urllib.error.HTTPError as err:
            refused = (err.code, json.loads(err.read()))
    finally:
        for srv, t in zip(servers, threads):
            srv.shutdown()
            t.join(timeout=30)
            srv.server_close()
    assert not any(t.is_alive() for t in threads), "server thread did not stop"
    sync()
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    # the answers: the reranked prefix is a permutation of stage 1's top 50,
    # the reference masked, the scores stage 1's; some order moved
    assert single["results"][0] == reranked["results"][0], "one query and a batch disagree"
    moved, worst = 0, 0.0
    for res, s1, ref in zip(reranked["results"], stage1["results"], refs):
        got = [r["name"] for r in res]
        assert len(got) == RERANK_TOP and ref not in got, "reference not masked"
        assert set(got) == {r["name"] for r in s1}, "the reranked prefix left stage 1's top 50"
        score = {r["name"]: r["score"] for r in s1}
        worst = max(worst, max(abs(r["score"] - score[r["name"]]) for r in res))
        moved += got != [r["name"] for r in s1]
    assert worst <= 1e-6, f"the reranked answers' scores are not stage 1's: {worst}"
    assert moved > 0, "the rerank moved no query's order"
    assert refused is not None and refused[0] == 400 and refused[1]["error"].startswith(
        "ValueError: gallery too small to rerank"), refused
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[{tag}] serve --model-name blip2_cir_rerank --rerank-top {RERANK_TOP} --rerank-step "
        f"{RERANK_STEP}: POST /query rerank, 1 query: median {med['single']:.3f} ms (3 runs); "
        f"{QUERY_BATCH} queries: median {med['batch']:.3f} ms (2 runs; stage 1 alone "
        f"{med['stage1_batch']:.3f} ms); reranked prefix = stage 1's top {RERANK_TOP} on every "
        f"query, order moved on {moved}/{QUERY_BATCH}, scores stage 1's (max diff {worst:.1e}), "
        f"reference masked; a gallery too small gets {refused[0]}: {refused[1]['error']!r}")
    check_counters(tag, launches)
    out = {"launches": launches, "query_1_median_ms": med["single"],
           "query_32_median_ms": med["batch"], "stage1_32_ms": med["stage1_batch"],
           "order_moved": moved, "scorer_seconds": dict(scorer.seconds)}

    # 8c: the first RERANK_STEP queries' tile (750 candidates), stage by stage
    index = service.index
    cands = [[r["name"] for r in s1] for s1 in stage1["results"][:RERANK_STEP]]
    rows = _tile_rows(index, refs[:RERANK_STEP], cands)
    out["tile_fp32"] = _hold_tile(f"{tag} ViT-L fp32", counters, scorer, rows,
                                  caps[:RERANK_STEP])
    tok = service.engine.tokenizer
    del service, small, scorer
    torch.cuda.empty_cache()

    model8 = load_model("blip2_cir_rerank", "pretrain_vitL", device=DEVICE, seed=SEED,
                        qformer_int8=True)
    scorer8 = ItmRerankScorer(model8, tok, top=RERANK_TOP, step=RERANK_STEP)
    scorer8(*rows, caps[:RERANK_STEP])  # warm-up
    sync()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    t0 = time.perf_counter()
    scores8 = scorer8(*rows, caps[:RERANK_STEP])
    tile8_s = time.perf_counter() - t0
    launches8 = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    log(f"[{tag} int8] one tile of {RERANK_STEP * RERANK_TOP} candidates through the int8 "
        f"Q-Former: {tile8_s * 1e3:.1f} ms; launches {launches8}")
    want = {"fused_qformer_layer_int8": 12, **INT8_QUANTIZE_PER_BATCH["rerank"]}
    if {k: launches8[k] for k in want} != want:
        raise RuntimeError(f"{tag} int8: launches {launches8}, expected {want}")
    check_counters(f"{tag} int8", launches8)
    assert np.isfinite(scores8).all()
    out["tile_int8"] = _hold_tile(f"{tag} ViT-L int8", counters, scorer8, rows,
                                  caps[:RERANK_STEP], INT8_QUANTIZE_PER_BATCH["rerank"])
    out.update(launches_int8=launches8, tile_int8_ms=tile8_s * 1e3)
    del model8, scorer8, rows
    torch.cuda.empty_cache()
    return out


def phase_rerank_validate(work, gallery):
    """Phase 8b and 8c on EVA ViT-g (the docstring): cli/validate_rerank at
    the CIRR defaults over phase 5's synthetic val split, then its first tile
    (3000 candidates) stage by stage."""
    from sprc_tpu_torch.cli import validate, validate_rerank
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.retrieval.metrics import drop_reference, sort_gallery
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    tag = "rerank EVA"
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    names = [n for batch_names, _ in gallery for n in batch_names]
    data = _write_cirr_val(os.path.join(work, "cirr_val"), names, VALIDATE_QUERIES, SEED + 2)
    counters = _counters()
    t0 = time.perf_counter()
    ckpt = _save_released(load_model("blip2_cir_rerank", "pretrain", device=DEVICE, seed=SEED),
                          os.path.join(work, "rerank_eva.pt"))
    torch.cuda.empty_cache()
    args = validate_rerank.parse_args([
        "--dataset", "CIRR", "--data-path", data, "--vocab-path", vocab,
        "--encode-batch", str(ENCODE_BATCH), "--query-batch", str(QUERY_BATCH),
        "--rerank-model-path", ckpt, "--device", DEVICE])
    assert ((args.rerank_top, args.rerank_step), args.model_type,
            args.rerank_model_name) == (RERANK_CIRR, "pretrain", "blip2_cir_rerank")
    model, engine = validate.build_engine(args)
    scorer = validate_rerank.make_scorer(args, engine)
    vcfg = scorer.model.cfg.vit_config()
    assert (vcfg.width, vcfg.depth, type(scorer.model).__name__) == (1408, 39, "CirRerank")
    sync()
    log(f"[{tag}] blip2_cir_align_prompt/pretrain (stage 1) and blip2_cir_rerank/pretrain "
        f"(saved and read back through --rerank-model-path) built in "
        f"{time.perf_counter() - t0:.1f} s")
    queries = validate.cirr_queries(data)

    # clocks around the index's host gathers and the scorer's tiles (the
    # engine's and the scorer's own, the rows unchanged)
    built, gathers, tiles = {}, [], []
    inner_build = engine.build_index

    def build_index(batches):
        index = built["index"] = inner_build(batches)
        inner_rows = index.reference_embeds

        def reference_embeds(names):
            t = time.perf_counter()
            rows = inner_rows(names)
            gathers.append((len(names), time.perf_counter() - t))
            return rows

        index.reference_embeds = reference_embeds
        return index

    class TimedScorer:
        top, step = scorer.top, scorer.step

        def __call__(self, refs, cands, caps):
            sync()
            t = time.perf_counter()
            got = scorer(refs, cands, caps)
            tiles.append({"candidates": len(cands), "s": time.perf_counter() - t})
            return got

    engine.build_index = build_index
    for obj, attr in counters.values():  # count only the validate_rerank path from here on
        setattr(obj, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = validate_rerank.evaluate_rerank_cirr(engine, iter(gallery), queries, TimedScorer())
    sync()
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    index = built.pop("index")
    del engine.build_index, index.reference_embeds  # the clocks off: the methods again
    cand_gathers = [dt for n, dt in gathers if n == tiles[0]["candidates"]]
    for tile, dt in zip(tiles, cand_gathers):
        tile["gather_s"] = dt
    keys = ["group_recall_at1", "group_recall_at2", "group_recall_at3", "recall_at1",
            "recall_at5", "recall_at10", "recall_at50"]
    assert list(results) == keys, list(results)
    assert all(np.isfinite(v) and 0.0 <= v <= 100.0 for v in results.values()), results
    assert results["recall_at50"] >= results["recall_at10"] >= results["recall_at1"]
    top, step = RERANK_CIRR
    full = [t for t in tiles if t["candidates"] == top * step]
    assert len(tiles) == -(-VALIDATE_QUERIES // step) and len(full) == VALIDATE_QUERIES // step
    assert all("gather_s" in t for t in full), (gathers, tiles)
    tile_s = float(np.median([t["s"] + t["gather_s"] for t in full]))
    gather_s = float(np.median([t["gather_s"] for t in full]))
    log(f"[{tag}] validate_rerank --dataset CIRR (top {top}, step {step}): {len(tiles)} tiles "
        f"({len(full)} of {top * step} candidates: median {tile_s:.3f} s = "
        f"{top * step / tile_s:.1f} candidates/s, of which the host gather of the candidates' "
        f"rows {gather_s:.3f} s = {gather_s / tile_s:.3f}; the scorer's upload, kernels and "
        f"readback the rest); {total_s:.3f} s in all with the {GALLERY}-image encode; peak "
        f"memory {peak:.2f} GiB")
    log(f"[{tag}] " + json.dumps({"dataset": "CIRR", "rerank_top": top, "rerank_step": step,
                                  "metrics": results}))
    check_counters(tag, launches)
    refs, caps = queries["refs"][:step], queries["captions"][:step]
    sims = engine.score_queries(index, refs, caps)
    cands = drop_reference(sort_gallery(sims, index.names), refs)[:, :top]
    rows = _tile_rows(index, refs, cands)
    hold = _hold_tile(tag, counters, scorer, rows, caps)
    log(f"[{tag}] one tile's candidate rows: {rows[1].dtype} {tuple(rows[1].shape)}, "
        f"{rows[1].numel() * rows[1].element_size() / 2 ** 30:.2f} GiB on the host")
    del engine, model, scorer, index, rows
    torch.cuda.empty_cache()
    return {"launches": launches, "metrics": results, "tile_s": tile_s,
            "candidates_per_s": top * step / tile_s, "host_gather_s": gather_s,
            "gather_share": gather_s / tile_s, "tiles": tiles, "peak_memory_gib": peak,
            "total_s": total_s, "tile": hold}


def _write_cirr_train(root, names, n_triplets, seed):
    """A synthetic CIRR train split in the reference's layout (JSON only)."""
    rng = np.random.default_rng(seed)
    words = ["red", "dress", "with", "long", "sleeves", "and", "a", "blue", "shirt", "dog"]
    triplets = []
    for i in range(n_triplets):
        ref, tgt = rng.choice(len(names), 2, replace=False)
        triplets.append({"pairid": i, "reference": names[ref], "target_hard": names[tgt],
                         "caption": " ".join(rng.choice(words, rng.integers(3, 9))),
                         "img_set": {"members": [names[ref], names[tgt]]}})
    for sub, name, payload in (("captions", "cap.rc2.train.json", triplets),
                               ("image_splits", "split.rc2.train.json",
                                {n: f"train/{n}.png" for n in names})):
        os.makedirs(os.path.join(root, "cirr", sub), exist_ok=True)
        with open(os.path.join(root, "cirr", sub, name), "w") as f:
            json.dump(payload, f)
    return root


def _loss_gap(got, want):
    return max(abs(got[k].item() - want[k].item()) / abs(want[k].item()) for k in want)


def phase_train(work):
    """The fine-tune path (phase 7 of the docstring)."""
    from sprc_tpu_torch import kernel_checks
    from sprc_tpu_torch.cli import finetune, validate
    from sprc_tpu_torch.data.loader import DataLoader
    from sprc_tpu_torch.kernel_checks import TRAIN_BATCH
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.retrieval.engine import RetrievalEngine
    from sprc_tpu_torch.text.processors import CaptionProcessor
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.train.checkpoint import restore_state, save_state
    from sprc_tpu_torch.train.feature_cache import build_feature_cache
    from sprc_tpu_torch.train.loop import TrainConfig, Trainer
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    tag = "train"
    os.makedirs(work, exist_ok=True)
    tokenizer = BertWordPieceTokenizer.from_vocab_file(
        write_synthetic_bert_vocab(os.path.join(work, "vocab.txt")))
    processor = CaptionProcessor()
    names = [f"trn{i:04d}" for i in range(TRAIN_IMAGES)]
    data = _write_cirr_train(os.path.join(work, "cirr_train"), names, TRAIN_TRIPLETS, SEED + 3)
    _write_cirr_val(data, names, VALIDATE_QUERIES, SEED + 4)
    triplets = finetune.train_triplets(data, "CIRR")
    assert len(triplets) == TRAIN_TRIPLETS
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)  # set-up: pixels on the card
    pixels = torch.randn((TRAIN_IMAGES, 224, 224, 3), generator=gen, device=DEVICE)
    pixels_host = pixels.cpu().numpy()
    row = {n: i for i, n in enumerate(names)}
    counters = _counters()

    t0 = time.perf_counter()
    model = load_model("blip2_cir_align_prompt", "pretrain", device=DEVICE, seed=SEED)
    sync()
    vcfg, qcfg = model.cfg.vit_config(), model.cfg.qformer_config()
    assert (vcfg.width, vcfg.depth, qcfg.dropout_rate) == (1408, 39, 0.1)
    n_params = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    log(f"[{tag}] model blip2_cir_align_prompt/pretrain on {DEVICE}: {n_params / 1e6:.1f} M "
        f"params, {n_train / 1e6:.1f} M trainable (the ViT frozen), built in "
        f"{time.perf_counter() - t0:.1f} s")
    loader = DataLoader(triplets, batch_size=TRAIN_BATCH, shuffle=True, drop_last=True,
                        seed=SEED, num_workers=1)
    steps = len(loader)
    tcfg = TrainConfig(total_steps=steps * 80)  # the CLI's: OneCycle over 80 epochs

    def epoch_batches(epoch, cache=None):
        loader.set_epoch(epoch)
        for batch in loader:
            out = finetune.to_device(finetune.tokenize_captions(
                batch, tokenizer, processor, model.cfg.max_txt_len), DEVICE)
            for side in ("reference", "target"):
                keys = batch[f"{side}_name"]
                if cache is None:
                    out[side] = pixels[torch.as_tensor([row[n] for n in keys], device=DEVICE)]
                else:
                    out[f"{side}_embeds"] = cache.gather(keys).to(DEVICE)
            yield out

    def reset_counters():
        for obj, attr in counters.values():
            setattr(obj, attr, 0)

    def read_counters():
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    # (a) a live step through the kernels (the tower stage by stage on the
    # first) against the same step under plain_reference, and against the
    # all-plain step from the kernel tower's rows, for the first batch of
    # LIVE_SEEDS epochs, each from its own dropout seed
    def k1_argmax(run):
        """``run()`` with each K1 call's argmax over the query tokens
        recorded ([B, N] indices, from its own inputs in plain fp32)."""
        calls = []

        def recording(feats, targets):
            with torch.no_grad():
                calls.append(torch.einsum("be,nqe->bnq", feats.float(),
                                          targets.float()).argmax(-1))
            return type(model).token_max_sim(feats, targets)

        model.token_max_sim = recording
        try:
            return run(), calls
        finally:
            del model.token_max_sim

    kept = read_counters()
    stages = kernel_checks.StageRecorder()
    param_names = [n for n, p in model.named_parameters() if p.requires_grad]
    live_checks = []
    t0 = time.perf_counter()
    for i in range(LIVE_SEEDS):
        batch, seed = next(iter(epoch_batches(i))), SEED + i
        with primitives.stage_check(stages) if i == 0 else contextlib.nullcontext():
            (_, k_losses, k_grads), k_idx = k1_argmax(
                lambda: Trainer(model, tcfg, seed=seed).loss_and_grads(batch))
        with primitives.plain_reference():
            (_, p_losses, p_grads), p_idx = k1_argmax(
                lambda: Trainer(model, tcfg, seed=seed).loss_and_grads(batch))
        with torch.no_grad():
            tower = model.encode_tower(torch.cat([batch["reference"], batch["target"]]))
        rows = dict(batch, reference_embeds=tower[:TRAIN_BATCH],
                    target_embeds=tower[TRAIN_BATCH:])
        with primitives.plain_reference():
            _, r_losses, r_grads = Trainer(model, tcfg, seed=seed,
                                           from_embeds=True).loss_and_grads(rows)
        check = {"seed": seed, "epoch": i, "k1_argmax_moved": 0, "k1_argmax_moved_diagonal": 0}
        for part, (got, got_g, want, want_g) in {
                "live": (k_losses, k_grads, p_losses, p_grads),
                "rows": (k_losses, k_grads, r_losses, r_grads),
                "inputs": (r_losses, r_grads, p_losses, p_grads)}.items():
            check[part] = {"loss": _loss_gap(got, want),
                           "grad": kernel_checks.grad_gap(got_g, want_g, param_names)}
        for a, b in zip(k_idx, p_idx):  # itc, then rtc
            check["k1_argmax_moved"] += int((a != b).sum())
            check["k1_argmax_moved_diagonal"] += int((a != b).diagonal().sum())
        live_checks.append(check)
        if i == 0:
            first, first_losses = batch, (k_losses, p_losses)
        del k_grads, p_grads, r_grads, tower, rows
    sync()
    checks_s = time.perf_counter() - t0
    k_losses, p_losses = first_losses
    for k, (obj, attr) in counters.items():  # these comparisons are not the main path
        setattr(obj, attr, kept[k])
    gaps = {part: {"loss": max(c[part]["loss"] for c in live_checks),
                   "grad": max(c[part]["grad"]["gap"] for c in live_checks)}
            for part in ("live", "rows")}
    for stage in stages.rows():
        log(f"[{tag}] first live step, the tower stage by stage: {stage['kind']}: "
            f"{stage['calls']} calls, worst share that differs {stage['differ']:.3e}, worst "
            f"difference {stage['err']:.3e} -> {'ok' if stage['ok'] else 'FAIL'}")
    log(f"[{tag}] first live step, kernels against plain_reference: losses "
        + ", ".join(f"{k} {k_losses[k].item():.6f} / {p_losses[k].item():.6f}" for k in k_losses)
        + f"; over {LIVE_SEEDS} steps ({checks_s:.1f} s), worst loss gap "
        f"{gaps['live']['loss']:.3e} (bound {TRAIN_BOUNDS['live']['loss']}), worst gradient gap "
        f"{gaps['live']['grad']:.3e} (bound {TRAIN_BOUNDS['live']['grad']}); against the "
        f"all-plain step from the kernel tower's rows {gaps['rows']['loss']:.3e} (bound "
        f"{TRAIN_BOUNDS['rows']['loss']}) / {gaps['rows']['grad']:.3e} (bound "
        f"{TRAIN_BOUNDS['rows']['grad']})")
    for c in live_checks:
        parts = []
        for part, what in (("live", "kernels against plain"),
                           ("rows", "kernels against plain from their tower rows"),
                           ("inputs", "plain from the kernel rows against plain")):
            g = c[part]["grad"]
            parts.append(
                f"{what}: loss {c[part]['loss']:.3e}, gradient {g['gap']:.3e} in {g['tensor']} "
                f"(max |difference| {g['err']:.3e}, scale {g['scale']:.3e}"
                f"{', the floor' if g['at_floor'] else ''}; next "
                + ", ".join(f"{n} {v:.3e}" for n, v, _ in g["worst"][1:]) + ")")
        log(f"[{tag}] live step, epoch {c['epoch']}'s first batch, seed {c['seed']}: "
            + "; ".join(parts) + f"; K1's argmax over the query tokens moved for "
            f"{c['k1_argmax_moved']} of {2 * TRAIN_BATCH ** 2} scores "
            f"({c['k1_argmax_moved_diagonal']} on the diagonals)")
    if not stages.ok():
        raise RuntimeError(f"{tag}: a tower stage disagrees with its plain version: "
                           f"{[r['kind'] for r in stages.rows() if not r['ok']]}")
    for part, bound in gaps.items():
        for what, value in bound.items():
            if not value <= TRAIN_BOUNDS[part][what]:
                raise RuntimeError(f"{tag}: {part} {what} gap {value} over "
                                   f"{TRAIN_BOUNDS[part][what]}")

    # (b) K1 with a gradient at the training shape
    kept = read_counters()
    k1 = kernel_checks.check_token_max_sim_grad(DEVICE)
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, kept[k])
    log(f"[{tag}] K1 TokenMaxSim ({k1['shape']}): forward max_abs {k1['max_abs_err']:.3e}, "
        f"gradients max_abs {k1['grad_max_abs_err']:.3e}, ties split evenly "
        f"{k1['tie_split_even']}, {k1['launches']} launches; forward (device) {k1['ms']:.4f} "
        f"ms, plain {k1['plain_ms']:.4f} ms; forward + backward {k1['fwd_bwd_ms']:.4f} ms, "
        f"plain {k1['plain_fwd_bwd_ms']:.4f} ms -> {'ok' if k1['ok'] else 'FAIL'}")
    if not k1["ok"]:
        raise RuntimeError(f"{tag}: TokenMaxSim disagrees with autograd over plain: {k1}")

    # (c) one live epoch through finetune_epochs, then its validation
    start = [p.detach().clone() for p in model.parameters() if p.requires_grad]
    trainer = Trainer(model, tcfg, seed=SEED, skip_nonfinite=True)
    live, live_ms, in_steps, peak, val = [], [], {}, {}, {}

    def timed(t, out, times):
        inner = t.train_step

        def train_step(batch):
            t0 = time.perf_counter()
            metrics = inner(batch)  # ends in a host read of the losses
            times.append((time.perf_counter() - t0) * 1e3)
            out.append(metrics)
            return metrics

        t.train_step = train_step

    def validate_fn():
        in_steps.update(read_counters())
        peak["bytes"] = torch.cuda.max_memory_allocated()
        engine = RetrievalEngine(model, tokenizer, device=DEVICE, encode_batch=ENCODE_BATCH,
                                 query_batch=QUERY_BATCH)
        batches = [(names[s:s + ENCODE_BATCH], pixels_host[s:s + ENCODE_BATCH])
                   for s in range(0, TRAIN_IMAGES, ENCODE_BATCH)]
        val["results"] = validate.evaluate_cirr(engine, iter(batches),
                                                validate.cirr_queries(data))
        return val["results"]

    timed(trainer, live, live_ms)
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    history = finetune.finetune_epochs(trainer, epoch_batches, num_epochs=1,
                                       validate=validate_fn, log=lambda m: None)
    sync()
    epoch_s = time.perf_counter() - t0
    launches = read_counters()
    in_val = {k: launches[k] - in_steps[k] for k in launches}
    results = val["results"]
    assert list(results) == CIRR_KEYS, list(results)
    assert all(np.isfinite(v) and 0.0 <= v <= 100.0 for v in results.values()), results
    log(f"[{tag}] live epoch: {steps} steps of {TRAIN_BATCH}, losses per step "
        + "; ".join(f"{m['loss']:.5f}" for m in live)
        + f"; step ms {', '.join(f'{t:.1f}' for t in live_ms)}; epoch and validation "
        f"{epoch_s:.1f} s; peak memory {peak['bytes'] / 2**30:.2f} GiB")
    log(f"[{tag}] validation after the epoch: " + json.dumps(results))
    log(f"[counters] launches during the {tag} steps: {in_steps}")
    log(f"[counters] launches during the {tag} validation: {in_val}")
    depth = vcfg.depth
    want = {"token_max_sim": 2 * steps, "fused_vit_block": depth * steps, "gemm": 4 * depth * steps,
            "attention_bf16": depth * steps, "layer_norm": 2 * depth * steps}
    bad = {k: in_steps[k] for k in in_steps if in_steps[k] != want.get(k, 0)}
    if bad:
        raise RuntimeError(f"{tag}: launches in the steps {bad}, expected {want} and 0 elsewhere")
    missing = [k for k in ("fused_qformer_layer", "token_max_sim", "fused_vit_block", "gemm_f32",
                           "attention_f32") if in_val[k] <= 0]
    if missing:
        raise RuntimeError(f"{tag}: not launched in the validation: {missing}")
    if not all(np.isfinite(m["loss"]) and m["skipped_nonfinite"] == 0.0 for m in live):
        raise RuntimeError(f"{tag}: a live step was not finite: {live}")

    # (d) the feature cache, then cached steps from the same start state and seed
    with torch.no_grad():
        for p, s0 in zip((p for p in model.parameters() if p.requires_grad), start):
            p.copy_(s0)
    del start
    kept = read_counters()
    t0 = time.perf_counter()
    cache = build_feature_cache(model, [(names, pixels)])
    sync()
    cache_s = time.perf_counter() - t0
    cache_launches = read_counters()["fused_vit_block"] - kept["fused_vit_block"]
    assert cache_launches == depth and len(cache) == TRAIN_IMAGES, (cache_launches, len(cache))
    cached_trainer = Trainer(model, tcfg, seed=SEED, from_embeds=True, skip_nonfinite=True)
    cached, cached_ms = [], []
    timed(cached_trainer, cached, cached_ms)
    state_path = os.path.join(work, "train_state.pt")
    batches = list(epoch_batches(0, cache))
    for i, batch in enumerate(batches):
        cached_trainer.train_step(batch)
        if i == 1:
            t0 = time.perf_counter()
            save_state(state_path, cached_trainer)
            save_s = time.perf_counter() - t0
    sync()
    keys = ("loss_itc", "loss_rtc", "loss_align", "loss")

    def rel(a, b):
        return max(abs(x[k] - y[k]) / abs(y[k]) for x, y in zip(a, b) for k in keys)

    cached_gap = rel(cached, live)
    # (e) resume after step 2
    resumed_trainer = Trainer(model, tcfg, seed=SEED + 1, from_embeds=True, skip_nonfinite=True)
    restore_state(state_path, resumed_trainer)
    os.remove(state_path)
    resumed = [resumed_trainer.train_step(b) for b in batches[2:]]
    resume_gap = rel(resumed, cached[2:])
    log(f"[{tag}] feature cache: {len(cache)} images in {cache_s:.3f} s ({cache_launches} block "
        f"launches); cached step ms {', '.join(f'{t:.1f}' for t in cached_ms)}; state saved in "
        f"{save_s:.1f} s")
    log(f"[{tag}] cached steps against live: worst relative loss gap {cached_gap:.3e} (bound "
        f"{TRAIN_BOUNDS['cached']}); resumed steps 3-4 against uninterrupted: {resume_gap:.3e} "
        f"(bound {TRAIN_BOUNDS['resume']}); step after resume {resumed_trainer.step}")
    if not (cached_gap <= TRAIN_BOUNDS["cached"] and resume_gap <= TRAIN_BOUNDS["resume"]
            and resumed_trainer.step == steps):
        raise RuntimeError(f"{tag}: cached {cached_gap} / resumed {resume_gap} disagree")
    live_med, cached_med = float(np.median(live_ms)), float(np.median(cached_ms))
    out = {"batch": TRAIN_BATCH, "steps": steps, "live_step_ms": live_ms,
           "live_step_median_ms": live_med, "live_samples_per_s": TRAIN_BATCH / live_med * 1e3,
           "cached_step_ms": cached_ms, "cached_step_median_ms": cached_med,
           "cached_samples_per_s": TRAIN_BATCH / cached_med * 1e3,
           "feature_cache_s": cache_s, "peak_memory_gib": peak["bytes"] / 2 ** 30,
           "gaps": gaps, "live_checks": live_checks, "cached_gap": cached_gap, "resume_gap": resume_gap,
           "losses": [{k: m[k] for k in keys} for m in live], "epoch": history[-1],
           "validation": results,
           "launches_steps": in_steps, "launches_validation": in_val, "k1_grad": k1}
    log(f"[{tag}] " + json.dumps({k: out[k] for k in (
        "live_step_median_ms", "live_samples_per_s", "cached_step_median_ms",
        "cached_samples_per_s", "peak_memory_gib")}))
    del model, trainer, cached_trainer, resumed_trainer, cache, batches, pixels, first
    torch.cuda.empty_cache()
    return out


# phase 9: the variant zoo's trainable models (models/cir_variants.py) on
# pretrain_vitL at batch 128, over a synthetic CIRR train split of
# VARIANT_TRIPLETS triplets (2 steps an epoch) over phase 7's images; the
# steps of (a) run 4 of the Q-Former's 12 layers (every width as the row's):
# the fp32 Q-Former took most of a step (the run's time limit forces the cut)
VARIANT_TRIPLETS = 256
VARIANT_QFORMER_LAYERS = 4
VARIANTS = ("blip2_cir_cat", "blip2_cir_rel", "blip2_cir_z_learn_pos_align", "blip2_cir_neg",
            "blip2_cir_neg_rel", "blip2_cir_full", "blip2_cir_rerank", "blip2_cir_cls")
# a step's launches of K1 and K3 by variant: K1 once an in-batch loss (ITC,
# RTC) or for the rerank twin's scores; K3 in each layer of two no-grad
# passes (the rerank twin's targets and text, blip2_cir_cls's text and
# candidates); every pass with a gradient runs the Q-Former unfused
VARIANT_STEP_LAUNCHES = {"blip2_cir_cat": (1, 0), "blip2_cir_rel": (2, 0),
                         "blip2_cir_z_learn_pos_align": (2, 0), "blip2_cir_neg": (1, 0),
                         "blip2_cir_neg_rel": (2, 0), "blip2_cir_full": (2, 0),
                         "blip2_cir_rerank": (1, 2 * VARIANT_QFORMER_LAYERS),
                         "blip2_cir_cls": (1, 2 * VARIANT_QFORMER_LAYERS)}
# The live step through the kernels against the all-plain step from the kernel
# tower's rows with the same dropout seed and the kernel run's hard negatives
# (injected): TRAIN_BOUNDS["rows"] (5e-7 / 1e-5), except where a loss reads
# K3's output: blip2_cir_cls's loss_p2p reads its candidate pass (gradient gap
# read 5.95e-6, in temp2; bound 3 times that). Readings on an H100, loss /
# gradient: cat 9.7e-8 / 5.8e-6, rel 9.7e-8 / 5.8e-6, z_learn_pos_align 0 /
# 2.7e-6, neg 9.7e-8 / 5.8e-6, neg_rel 0 / 2.2e-6, full 0 / 4.7e-6, rerank 0 /
# 0 (its mining reads K3 and K1, its loss neither: the picks are injected),
# cls 9.7e-8 / 5.95e-6; no hard negative moved.
VARIANT_BOUNDS = {name: TRAIN_BOUNDS["rows"] for name in VARIANTS}
VARIANT_BOUNDS["blip2_cir_cls"] = {"loss": 5e-7, "grad": 1.8e-5}
VARIANT_TIMED_STEPS = 1  # the run's time limit: one timed step a variant (3 until PR 19)
VARIANT_EVAL = ("blip2_cir_slt", "blip2_cir_prompt")


@contextlib.contextmanager
def hard_negatives(model, picks, inject):
    """Record each hard-negative pick of ``model`` (``_neg_indices``,
    ``blip2_cir_cls``'s ``_candidates``) in ``picks``; with ``inject``, hand
    back the recorded picks in order instead and count how many of the
    run's own differ (``moved`` of ``of``)."""
    attrs = [a for a in ("_neg_indices", "_candidates") if hasattr(model, a)]
    count, calls = {"moved": 0, "of": 0}, dict.fromkeys(attrs, 0)

    def wrap(attr):
        own_fn = getattr(model, attr)

        def fn(*args, **kw):
            own = own_fn(*args, **kw)
            if not inject:
                picks.setdefault(attr, []).append(own)
                return own
            kept = picks[attr][calls[attr]]
            calls[attr] += 1
            for a, b in zip(own, kept):
                count["moved"] += int((a != b).sum())
                count["of"] += a.numel()
            return kept

        setattr(model, attr, fn)

    for attr in attrs:
        wrap(attr)
    try:
        yield count
    finally:
        for attr in attrs:
            delattr(model, attr)


def _write_pngs(root, subdirs, names, size, seed):
    """Seeded uint8 images as PNG files (utils.artifacts.encode_png) under
    each of ``subdirs`` of ``root``, the same image under each."""
    from sprc_tpu_torch.utils.artifacts import encode_png

    rng = np.random.default_rng(seed)
    for sub in subdirs:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for name in names:
        data = encode_png(rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
        for sub in subdirs:
            with open(os.path.join(root, sub, f"{name}.png"), "wb") as f:
                f.write(data)


def phase_variants(work):
    """The variant zoo (phase 9 of the docstring)."""
    from sprc_tpu_torch import kernel_checks
    from sprc_tpu_torch.cli import finetune
    from sprc_tpu_torch.data.loader import DataLoader
    from sprc_tpu_torch.kernel_checks import TRAIN_BATCH
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.text.processors import CaptionProcessor
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.train import loop
    from sprc_tpu_torch.train.loop import TrainConfig, Trainer
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    tag = "variants"
    t_phase = time.perf_counter()
    os.makedirs(work, exist_ok=True)
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    tokenizer = BertWordPieceTokenizer.from_vocab_file(vocab)
    names = [f"trn{i:04d}" for i in range(TRAIN_IMAGES)]
    data = _write_cirr_train(os.path.join(work, "cirr_variants"), names, VARIANT_TRIPLETS,
                             SEED + 3)
    _write_cirr_val(data, names, VALIDATE_QUERIES, SEED + 4)
    triplets = finetune.train_triplets(data, "CIRR")
    loader = DataLoader(triplets, batch_size=TRAIN_BATCH, shuffle=True, drop_last=True,
                        seed=SEED, num_workers=1)
    batch = next(iter(loader))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)  # set-up: pixels on the card
    pixels = torch.randn((TRAIN_IMAGES, 224, 224, 3), generator=gen, device=DEVICE)
    row = {n: i for i, n in enumerate(names)}
    step_batch = finetune.to_device(finetune.tokenize_captions(
        batch, tokenizer, CaptionProcessor(), 32), DEVICE)
    for side in ("reference", "target"):
        step_batch[side] = pixels[torch.as_tensor([row[n] for n in batch[f"{side}_name"]],
                                                  device=DEVICE)]
    counters = _counters()
    tcfg = TrainConfig(total_steps=len(loader) * 80)

    def reset_counters():
        for obj, attr in counters.values():
            setattr(obj, attr, 0)

    def read_counters():
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    def restore(kept):
        for k, (obj, attr) in counters.items():
            setattr(obj, attr, kept[k])

    # (a) one live step per variant through the kernels, against the
    # all-plain step from the kernel tower's rows (same seed, the kernel
    # run's hard negatives injected); then timed steps
    results, steps_launches = {}, dict.fromkeys(counters, 0)
    for name in VARIANTS:
        t0 = time.perf_counter()
        model = load_model(name, "pretrain_vitL", device=DEVICE, seed=SEED, **_cut_depth(
            name, "pretrain_vitL", qformer_layers=VARIANT_QFORMER_LAYERS))
        sync()
        build_s = time.perf_counter() - t0
        depth = model.cfg.vit_config().depth
        param_names = [n for n, p in model.named_parameters() if p.requires_grad]
        picks = {}
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        with hard_negatives(model, picks, inject=False):
            _, k_losses, k_grads = Trainer(model, tcfg, seed=SEED).loss_and_grads(step_batch)
        sync()
        launches = read_counters()
        peak_check = torch.cuda.max_memory_allocated()
        with torch.no_grad():
            tower = model.encode_tower(torch.cat([step_batch["reference"],
                                                  step_batch["target"]]))
        rows_batch = dict(step_batch, reference_embeds=tower[:TRAIN_BATCH],
                          target_embeds=tower[TRAIN_BATCH:])
        with primitives.plain_reference(), hard_negatives(model, picks, inject=True) as moved:
            _, p_losses, p_grads = Trainer(model, tcfg, seed=SEED,
                                           from_embeds=True).loss_and_grads(rows_batch)
        sync()
        gap = {"loss": _loss_gap(k_losses, p_losses),
               "grad": kernel_checks.grad_gap(k_grads, p_grads, param_names)}
        del k_grads, p_grads, tower, rows_batch
        # timed steps (the optimizer's update included): the main path's launches
        trainer = Trainer(model, tcfg, seed=SEED, skip_nonfinite=True)
        kept = read_counters()
        times, metrics = [], []
        for _ in range(VARIANT_TIMED_STEPS):
            t0 = time.perf_counter()
            metrics.append(trainer.train_step(step_batch))  # ends in a host read
            times.append((time.perf_counter() - t0) * 1e3)
        timed = {k: v - kept[k] for k, v in read_counters().items()}
        peak = max(peak_check, torch.cuda.max_memory_allocated())
        for k in steps_launches:
            steps_launches[k] += timed[k]
        k1, k3 = VARIANT_STEP_LAUNCHES[name]
        want = {"token_max_sim": k1, "fused_qformer_layer": k3, "fused_vit_block": depth,
                "gemm": 4 * depth, "attention_bf16": depth}
        bad = {k: launches[k] for k in want if launches[k] != want[k]}
        bad.update({k: timed[k] for k in want if timed[k] != VARIANT_TIMED_STEPS * want[k]})
        chain = ("gemm_f32", "attention_f32")
        if k3:
            bad.update({k: launches[k] for k in chain if launches[k] <= 0})
            if launches["layer_norm"] <= 2 * depth:
                bad["layer_norm"] = launches["layer_norm"]
        else:
            bad.update({k: launches[k] for k in chain if launches[k] != 0})
            if launches["layer_norm"] != 2 * depth:
                bad["layer_norm"] = launches["layer_norm"]
        bad.update({k: v for k, v in launches.items()
                    if k not in want and k not in chain + ("layer_norm",) and v != 0})
        median = float(np.median(times))
        bound = VARIANT_BOUNDS[name]
        res = {"build_s": build_s, "losses": {k: v.item() for k, v in k_losses.items()},
               "plain_losses": {k: v.item() for k, v in p_losses.items()},
               "loss_gap": gap["loss"], "grad_gap": gap["grad"]["gap"],
               "grad_gap_tensor": gap["grad"]["tensor"], "bound": bound,
               "hard_negatives_moved": moved["moved"], "hard_negatives": moved["of"],
               "step_ms": times, "step_median_ms": median,
               "samples_per_s": TRAIN_BATCH / median * 1e3, "peak_memory_gib": peak / 2 ** 30,
               "launches_step": {k: v for k, v in launches.items() if v},
               "finite": all(np.isfinite(m["loss"]) and m["skipped_nonfinite"] == 0.0
                             for m in metrics)}
        results[name] = res
        log(f"[{tag}] {name}: built in {build_s:.1f} s; losses "
            + ", ".join(f"{k} {res['losses'][k]:.6f} / {res['plain_losses'][k]:.6f}"
                        for k in res["losses"])
            + f" (kernels / plain from the kernel tower's rows): loss gap {gap['loss']:.3e} "
            f"(bound {bound['loss']}), gradient gap {gap['grad']['gap']:.3e} in "
            f"{gap['grad']['tensor']} (bound {bound['grad']}); hard negatives the plain step "
            f"would have picked otherwise: {moved['moved']} of {moved['of']}; step ms "
            + ", ".join(f"{t:.1f}" for t in times)
            + f" (median {median:.1f}, {res['samples_per_s']:.1f} samples/s), peak "
            f"{res['peak_memory_gib']:.2f} GiB; launches a step: K1 {launches['token_max_sim']}, "
            f"K2 {launches['fused_vit_block']}, K3 {launches['fused_qformer_layer']}")
        del model, trainer
        torch.cuda.empty_cache()
        if bad:
            raise RuntimeError(f"{tag} {name}: launches {bad}; expected {want} a step (K3's "
                               "chain kernels only with K3, none of another configuration)")
        if not (gap["loss"] <= bound["loss"] and gap["grad"]["gap"] <= bound["grad"]):
            raise RuntimeError(f"{tag} {name}: the kernel step is off the plain step: {gap}")
        if not res["finite"]:
            raise RuntimeError(f"{tag} {name}: a timed step was not finite: {metrics}")
    log(f"[counters] launches during the {tag} timed steps: {steps_launches}")

    # (b) the entry point: blip2_cir_neg through cli/finetune.finetune for one
    # epoch with its validation; blip2_cir_rerank live and with --cache-features
    _write_pngs(os.path.join(data), ("train", "dev"), names, 96, SEED + 6)
    step_log = []
    inner_step = loop.Trainer.train_step

    def logged_step(self, b):
        out = inner_step(self, b)
        step_log.append(out)
        return out

    def cli(name, out_dir, *extra):
        args = finetune.make_parser().parse_args([
            "--dataset", "CIRR", "--data-path", data, "--vocab-path", vocab,
            "--output-dir", os.path.join(work, out_dir), "--model-name", name,
            "--model-type", "pretrain_vitL", "--batch-size", str(TRAIN_BATCH),
            "--num-epochs", "1", "--workers", "4", "--seed", str(SEED),
            "--encode-batch", str(ENCODE_BATCH), "--query-batch", str(QUERY_BATCH),
            "--device", DEVICE, *extra])
        step_log.clear()
        kept = read_counters()
        t0 = time.perf_counter()
        loop.Trainer.train_step = logged_step
        try:
            history = finetune.finetune(args)
        finally:
            loop.Trainer.train_step = inner_step
        sync()
        seconds = time.perf_counter() - t0
        launches = {k: v - kept[k] for k, v in read_counters().items()}
        gc.collect()
        torch.cuda.empty_cache()
        return history, list(step_log), launches, seconds

    history, neg_steps, neg_launches, neg_s = cli("blip2_cir_neg", "cli_neg")
    results_dir = os.path.join(work, "cli_neg")
    with open(os.path.join(results_dir, "log.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    val = [e for e in logs if e.get("kind") == "val"]
    log(f"[{tag}] cli/finetune --model-name blip2_cir_neg, one epoch of {len(neg_steps)} steps "
        f"and its validation in {neg_s:.1f} s: epoch {json.dumps(history[-1])}; validation "
        f"{json.dumps(val[-1] if val else None)}; launches {neg_launches}")
    if not (len(neg_steps) == VARIANT_TRIPLETS // TRAIN_BATCH and val
            and all(np.isfinite(m["loss"]) and m["skipped_nonfinite"] == 0.0 for m in neg_steps)
            and os.path.exists(os.path.join(results_dir, "best_arithmetic_mean.pt"))):
        raise RuntimeError(f"{tag}: the blip2_cir_neg CLI epoch failed: {history}, {val}")
    missing = [k for k in ("token_max_sim", "fused_vit_block", "fused_qformer_layer")
               if neg_launches[k] <= 0]
    if missing:
        raise RuntimeError(f"{tag}: the CLI epoch did not launch {missing}")
    _, live_steps, _, live_s = cli("blip2_cir_rerank", "cli_rerank_live", "--validate-every", "0")
    _, cached_steps, cached_launches, cached_s = cli(
        "blip2_cir_rerank", "cli_rerank_cached", "--validate-every", "0", "--cache-features")
    cached_gap = max(abs(c[k] - l[k]) / abs(l[k]) for c, l in zip(cached_steps, live_steps)
                     for k in ("loss_itm", "loss"))
    log(f"[{tag}] cli/finetune --model-name blip2_cir_rerank: live {len(live_steps)} steps in "
        f"{live_s:.1f} s, --cache-features {len(cached_steps)} steps in {cached_s:.1f} s (the "
        f"cache built in the run); losses live "
        + ", ".join(f"{m['loss']:.6f}" for m in live_steps) + "; cached "
        + ", ".join(f"{m['loss']:.6f}" for m in cached_steps)
        + f"; worst relative gap {cached_gap:.3e} (bound {TRAIN_BOUNDS['cached']}); the cached "
        f"run's launches {cached_launches}")
    if not (len(live_steps) == len(cached_steps) == VARIANT_TRIPLETS // TRAIN_BATCH
            and cached_gap <= TRAIN_BOUNDS["cached"]):
        raise RuntimeError(f"{tag}: the cached rerank steps are off the live ones: {cached_gap}")
    for sub in ("cli_neg", "cli_rerank_live", "cli_rerank_cached"):
        for f in os.listdir(os.path.join(work, sub)):
            if f.endswith((".pt", ".npz")):
                os.remove(os.path.join(work, sub, f))

    # (c) the eval forwards of blip2_cir_slt and blip2_cir_prompt: once through
    # the kernels (the main path's launches), once stage by stage, once all-plain
    eval_out = {}
    ids, mask = step_batch["input_ids"][:QUERY_BATCH], step_batch["text_mask"][:QUERY_BATCH]
    ref, tgt = step_batch["reference"][:QUERY_BATCH], step_batch["target"][:QUERY_BATCH]
    for name in VARIANT_EVAL:
        model = load_model(name, "pretrain_vitL", device=DEVICE, seed=SEED)
        runs = {"forward": lambda: model(ref, tgt, ids, mask)}
        if name == "blip2_cir_prompt":
            def infer():
                feats, _ = model.extract_target_features(tgt)
                return model.inference(model.encode_image(ref), feats, ids, mask)
            runs["inference"] = infer
        kept = read_counters()
        with torch.inference_mode():
            got = {k: fn() for k, fn in runs.items()}
        sync()
        launches = {k: v - kept[k] for k, v in read_counters().items()}
        kept = read_counters()
        stages = kernel_checks.StageRecorder()
        with torch.inference_mode(), primitives.stage_check(stages):
            for fn in runs.values():
                fn()
        sync()
        with torch.inference_mode(), primitives.plain_reference():
            plain = {k: fn() for k, fn in runs.items()}
        sync()
        restore(kept)
        diffs = {k: (got[k].float() - plain[k].float()).abs().max().item() for k in got}
        finite = all(bool(torch.isfinite(v).all()) for v in got.values())
        eval_out[name] = {"launches": {k: v for k, v in launches.items() if v},
                          "stages": stages.rows(), "plain_max_abs": diffs,
                          "shapes": {k: list(v.shape) for k, v in got.items()}}
        for stage in stages.rows():
            log(f"[{tag}] {name} eval forwards stage by stage: {stage['kind']}: "
                f"{stage['calls']} calls, worst share that differs {stage['differ']:.3e}, worst "
                f"difference {stage['err']:.3e} -> {'ok' if stage['ok'] else 'FAIL'}")
        log(f"[{tag}] {name} eval forwards {eval_out[name]['shapes']}: against the all-plain "
            f"forwards (a report) max_abs {diffs}; launches {eval_out[name]['launches']}")
        del model
        torch.cuda.empty_cache()
        if not (stages.ok() and finite and launches["fused_qformer_layer"] > 0):
            raise RuntimeError(f"{tag} {name}: the eval forwards failed: {eval_out[name]}")
    for k in steps_launches:
        steps_launches[k] += sum(e["launches"].get(k, 0) for e in eval_out.values())
    total_s = time.perf_counter() - t_phase
    log(f"[{tag}] phase 9 in {total_s:.1f} s")
    out = {"variants": results, "cli_neg": {"history": history, "validation": val[-1],
                                            "seconds": neg_s, "launches": neg_launches},
           "cli_rerank_cached_gap": cached_gap, "eval": eval_out, "launches": steps_launches,
           "seconds": total_s}
    log(f"[{tag}] " + json.dumps({n: {k: r[k] for k in ("step_median_ms", "samples_per_s",
                                                        "peak_memory_gib")}
                                  for n, r in results.items()}))
    del pixels, step_batch
    torch.cuda.empty_cache()
    return out


# phase 10, BLIP-2 stage 1 (models/blip2_stage1.py) through the YAML run layer:
# 10a cli/evaluate.py on ret_coco_blip2_eval.yaml (blip2 / coco: EVA ViT-g at
# 364 px, the fp32 tower) over STAGE1_IMAGES seeded images of mixed sizes
# written as PNG files, STAGE1_CAPTIONS captions each, run.k_test
# STAGE1_K_TEST; 10b cli/train.py on pretrain_stage1.yaml (blip2 / pretrain:
# EVA ViT-g 224 px, bf16, frozen) at the YAML's batch of 100 over STAGE1_PAIRS
# pairs (one epoch: 2 steps)
# (2 captions an image for the run's time limit; the ITM rescoring is a call a query)
STAGE1_IMAGES, STAGE1_CAPTIONS, STAGE1_K_TEST = 64, 2, 16
STAGE1_PAIRS = 200
# 10a against the all-plain run (primitives.plain_reference), stage by stage:
# K1's scores on the kernel run's features within K1's own bound (1e-4, as
# check_token_max_sim), the ITM scores of one chunk of each direction on the
# kernel run's frozen rows within the 12-layer chain's (5e-4, as
# check_qformer_trunk), every K3 launch of those chunks within STAGE_BOUNDS
STAGE1_SIM_MAX_ABS, STAGE1_ITM_MAX_ABS = 1e-4, 5e-4
# 10a's kernel run against the all-plain run end to end, at fixed bounds about
# 4 times the readings on an H100 80GB HBM3 at 700 W (the same in two runs):
# the fp32 tower's frozen rows (max / mean |difference|: 1.395e-5 / 1.847e-6),
# the images' query features and the captions' features (unit rows: 4.601e-7,
# 4.843e-7), the stage-1 scores (5.066e-7) and the rescored scores
# (1.043e-6). A top-k set may differ only where its k-th and (k+1)-th scores
# lie within twice the stage-1 bound, a recall only where the top-1 gap is
# within twice the rescored bound.
STAGE1_RUN_BOUNDS = {"frozen": (6e-5, 8e-6), "feats": 2e-6, "text_feats": 2e-6,
                     "scores": 2e-6, "rescored": 4e-6}
# 10b's kernel step against the all-plain step: from the kernel tower's rows
# within TRAIN_BOUNDS["rows"] (readings on an H100: losses 0, gradients
# 1.5e-6); from the pixels, the plain bf16 tower's rows feed the Q-Former, and
# the losses read 1.9e-4 (at phase 7's bound of 2e-4, set from the flagship's
# 6.5e-5), held at 3 times that reading; gradients as phase 7's (2.1e-2)
STAGE1_BOUNDS = {"rows": TRAIN_BOUNDS["rows"], "live": {"loss": 6e-4, "grad": 0.9}}
# 10b's launches a step: K1 once (the ITC, through TokenMaxSim), the tower's
# chain once (39 blocks: 4 bf16 GEMMs, one attention and 2 LayerNorms each),
# no Q-Former layer kernel (every pass of the step trains, unfused)
STAGE1_STEP_LAUNCHES = {"token_max_sim": 1, "fused_vit_block": 39, "gemm": 156,
                        "attention_bf16": 39, "layer_norm": 78}
STAGE1_WORDS = ("a", "the", "dog", "cat", "man", "woman", "red", "blue", "on", "in", "street",
                "table", "two", "small", "large", "sitting", "standing", "with", "near", "car")


def _run_config(name, overrides):
    """``(Config, how)``: configs/runs/<name> with ``overrides`` (a nested
    dict), read through the file and a dotlist, as ``--cfg-path`` and
    ``--options`` give it, where PyYAML exists; else ``Config(defaults=...)``
    from its mirror in RUN_CONFIGS."""
    from sprc_tpu_torch.config import Config, deep_merge

    want = deep_merge(RUN_CONFIGS[name], overrides)
    try:
        import yaml  # noqa: F401
    except ImportError:
        return Config(defaults=want), "Config(defaults=RUN_CONFIGS[...]) (no PyYAML here)"
    dotlist = []

    def walk(prefix, node):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(f"{prefix}{key}.", value)
            else:
                dotlist.append(f"{prefix}{key}={json.dumps(value)}")

    walk("", overrides)
    cfg = Config(os.path.join(ROOT, "configs", "runs", name), overrides=dotlist)
    assert cfg.to_dict() == want, (name, cfg.to_dict(), want)
    return cfg, f"--cfg-path configs/runs/{name} --options {' '.join(dotlist)}"


def _cut_depth(name, model_type, vit_depth=None, qformer_layers=None):
    """Model-section overrides that cut a row's depth (the run's time limit
    forces it): its tower with ``vit_depth`` blocks and its Q-Former with
    ``qformer_layers`` layers, every width as the row gives it; each
    configuration as a dict of the fields that differ from the dataclass's
    defaults, the form a run config's ``--options`` carries."""
    import dataclasses

    from sprc_tpu_torch import loader

    cfg = loader.model_config(name, model_type)
    names = {torch.float32: "fp32", torch.bfloat16: "bf16"}

    def fields(sub, **cut):
        sub = dataclasses.replace(sub, **cut)
        default = type(sub)()
        return {f.name: names.get(v, v) for f in dataclasses.fields(sub)
                if (v := getattr(sub, f.name)) != getattr(default, f.name)}

    out = {}
    if vit_depth is not None:
        out["vit_config_override"] = fields(cfg.vit_config(), depth=vit_depth)
    if qformer_layers is not None:
        out["qformer_config_override"] = fields(cfg.qformer_config(), num_layers=qformer_layers)
    return out


def _write_pairs(root, n, captions, seed, prefix):
    """``n`` seeded PNG images of mixed sizes under ``root`` and their
    annotations: ``captions`` a list each (retrieval) or one string (pairs)."""
    from sprc_tpu_torch.utils.artifacts import encode_png

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    ann = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(160, 480, 2))
        name = f"{prefix}{i:04d}.png"
        with open(os.path.join(root, name), "wb") as f:
            f.write(encode_png(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)))
        caps = [" ".join(rng.choice(STAGE1_WORDS, 8)) for _ in range(max(1, captions))]
        ann.append({"image": name, "caption": caps if captions else caps[0], "image_id": i,
                    "instance_id": str(i)})
    path = os.path.join(root, "annotations.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return path


def _near_ties(rows_a, rows_b, scores, bound):
    """Rows where the two runs' top sets (their non -100 entries) differ,
    and of those the ones whose k-th and (k+1)-th ``scores`` are further
    apart than ``bound`` (a difference no rounding explains)."""
    differ, far = 0, 0
    for a, b, s in zip(rows_a, rows_b, scores):
        if np.array_equal(a != -100.0, b != -100.0):
            continue
        differ += 1
        k = int((a != -100.0).sum())
        top = np.sort(s)[::-1]
        far += int(k < len(top) and top[k - 1] - top[k] > bound)
    return differ, far


def phase_stage1_eval(work):
    """10a: the retrieval evaluation of BLIP-2 stage 1 (phase 10 of the docstring)."""
    import argparse

    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.ops.sim_kernels import token_max_sim, token_max_sim_plain
    from sprc_tpu_torch.retrieval import sim_matrix
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    tag = "stage1 eval"
    t_phase = time.perf_counter()
    root = os.path.join(work, "coco_retrieval")
    ann = _write_pairs(root, STAGE1_IMAGES, STAGE1_CAPTIONS, SEED + 10, "coco")
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    cfg, how = _run_config("eval/ret_coco_blip2_eval.yaml", {
        "run": {"k_test": STAGE1_K_TEST, "seed": SEED},
        "datasets": {"coco_retrieval": {"build_info": {"annotations": {"test": [ann]},
                                                       "images": root}}}})
    log(f"[{tag}] cli/evaluate.py through {how}")
    args = argparse.Namespace(device=DEVICE, model_path=None, vocab_path=vocab, split=None,
                              output_dir=os.path.join(work, "stage1_eval"))
    counters = _counters()
    runs = []
    real = sim_matrix.compute_sim_matrix

    def recording(model, frozen, feats, ids, mask, text_feats, **kw):
        out = real(model, frozen, feats, ids, mask, text_feats, **kw)
        runs.append({"model": model, "frozen": frozen, "feats": feats, "ids": ids, "mask": mask,
                     "text_feats": text_feats, "out": out})
        return out

    sim_matrix.compute_sim_matrix = recording
    try:
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        t0 = time.perf_counter()
        metrics = evaluate.evaluate(cfg, args, stats)
        sync()
        total_s = time.perf_counter() - t0
        launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(json.dumps({k: v for k, v in metrics.items() if isinstance(v, (int, float, str))}))
        plain_stats = {}
        t0 = time.perf_counter()
        with primitives.plain_reference():
            plain_metrics = evaluate.evaluate(cfg, args, plain_stats)
        sync()
        plain_s = time.perf_counter() - t0
    finally:
        sim_matrix.compute_sim_matrix = real
    kern, plain = runs
    stages = ("image_encode_s", "text_encode_s", "stage1_s", "itm_i2t_s", "itm_t2i_s")
    log(f"[{tag}] seconds by stage, kernels: "
        + ", ".join(f"{k} {stats[k]:.3f}" for k in stages)
        + f"; {stats['itm_calls']} ITM calls; total {total_s:.2f} s; peak {peak:.2f} GiB")
    log(f"[{tag}] seconds by stage, all-plain: "
        + ", ".join(f"{k} {plain_stats[k]:.3f}" for k in stages) + f"; total {plain_s:.2f} s")
    n_txt = STAGE1_IMAGES * STAGE1_CAPTIONS
    depth, layers = 39, 12
    want = {"token_max_sim": 1, "fused_vit_block": depth,
            "fused_qformer_layer": layers * (1 + -(-n_txt // 256) + STAGE1_IMAGES + n_txt)}
    log(f"[{tag}] launches: {launches}")
    bad = {k: launches[k] for k in want if launches[k] != want[k]}
    bad.update({k: launches[k] for k in ("gemm_f32", "attention_f32", "layer_norm")
                if launches[k] <= 0})
    bad.update({k: v for k, v in launches.items()
                if k not in want and k not in ("gemm_f32", "attention_f32", "layer_norm")
                and v != 0})
    if bad:
        raise RuntimeError(f"{tag}: launches {bad}, expected {want} and the fp32 chain's")

    # stage by stage, on the kernel run's own inputs
    model = kern["model"]
    kept = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    with torch.inference_mode():
        sims_k = token_max_sim(kern["text_feats"], kern["feats"])
        sims_p = token_max_sim_plain(kern["text_feats"], kern["feats"])
        sim_err = (sims_k - sims_p).abs().max().item()
        device = kern["feats"].device
        # image 0's best captions (a column of the [captions, images] scores),
        # then caption 0's best images
        topk = torch.sort(-sims_k[:, 0], stable=True).indices[:STAGE1_K_TEST].cpu().numpy()
        img = torch.from_numpy(kern["frozen"][0:1]).to(device).expand(STAGE1_K_TEST, -1, -1)
        chunks = {"i2t": (img, kern["ids"][topk], kern["mask"][topk])}
        topk = torch.sort(-sims_k[0], stable=True).indices[:STAGE1_K_TEST].cpu().numpy()
        chunks["t2i"] = (torch.from_numpy(kern["frozen"][topk]).to(device),
                         np.repeat(kern["ids"][:1], len(topk), 0),
                         np.repeat(kern["mask"][:1], len(topk), 0))
        itm_err = {}
        for name, (im, ids, mask) in chunks.items():
            ids, mask = torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
            got = model.compute_itm(im, ids, mask)
            with primitives.plain_reference():
                ref = model.compute_itm(im, ids, mask)
            itm_err[name] = (got - ref).abs().max().item()
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, kept[k])
    stage_rows = stage_pass(tag, "one ITM chunk (t2i)", counters,
                            lambda: model.compute_itm(chunks["t2i"][0],
                                                      torch.from_numpy(chunks["t2i"][1]).to(device),
                                                      torch.from_numpy(chunks["t2i"][2]).to(device)))
    log(f"[{tag}] K1 scores ({n_txt} x {STAGE1_IMAGES}) against plain on the same features: "
        f"max_abs {sim_err:.3e} (bound {STAGE1_SIM_MAX_ABS:.0e}); ITM scores of one chunk a "
        f"direction against plain on the same frozen rows: "
        + ", ".join(f"{k} {v:.3e}" for k, v in itm_err.items())
        + f" (bound {STAGE1_ITM_MAX_ABS:.0e})")
    if sim_err > STAGE1_SIM_MAX_ABS or max(itm_err.values()) > STAGE1_ITM_MAX_ABS:
        raise RuntimeError(f"{tag}: K1 {sim_err}, ITM {itm_err} beyond their bounds")

    # the two runs side by side: frozen rows, features, scores, top sets, recalls
    frozen_d = np.abs(kern["frozen"] - plain["frozen"])
    feats_d = (kern["feats"] - plain["feats"]).abs().max().item()
    text_d = (kern["text_feats"] - plain["text_feats"]).abs().max().item()
    free = {}
    for i, name in enumerate(("i2t", "t2i")):
        a, b = kern["out"][i], plain["out"][i]
        both = (a != -100.0) & (b != -100.0)
        free[name] = float(np.abs(a - b)[both].max())
    sims_plain = token_max_sim_plain(plain["text_feats"], plain["feats"]).cpu().numpy()
    score_d = float(np.abs(sims_k.cpu().numpy() - sims_plain).max())
    tie = 2 * STAGE1_RUN_BOUNDS["scores"]
    ties = {"i2t": _near_ties(kern["out"][0], plain["out"][0], sims_plain.T, tie),
            "t2i": _near_ties(kern["out"][1], plain["out"][1], sims_plain, tie)}
    log(f"[{tag}] kernel run against the all-plain run: frozen rows max_abs "
        f"{frozen_d.max():.3e} mean_abs {frozen_d.mean():.3e}; query features max_abs "
        f"{feats_d:.3e}; caption features max_abs {text_d:.3e}; stage-1 scores max_abs "
        f"{score_d:.3e}; rescored scores max_abs " + ", ".join(f"{k} {v:.3e}" for k, v in
                                                              free.items())
        + f" (bounds {STAGE1_RUN_BOUNDS}); rows whose top-k sets differ (of them past a "
        "near tie): " + ", ".join(f"{k} {d} ({f})" for k, (d, f) in ties.items()))
    readings = {"frozen": (frozen_d.max(), frozen_d.mean()), "feats": feats_d,
                "text_feats": text_d, "scores": score_d, "rescored": max(free.values())}
    past = {k: v for k, v in readings.items()
            if np.any(np.asarray(v) > np.asarray(STAGE1_RUN_BOUNDS[k]))}
    if past:
        raise RuntimeError(f"{tag}: the kernel run against the all-plain run past "
                           f"{STAGE1_RUN_BOUNDS}: {past}")
    if any(f for _, f in ties.values()):
        raise RuntimeError(f"{tag}: top-{STAGE1_K_TEST} sets differ past a near tie: {ties}")
    recall_keys = [k for k in metrics if k != "agg_metrics"]
    if any(metrics[k] != plain_metrics[k] for k in recall_keys):
        # a recall may move only where the rescored scores nearly tie
        gaps = []
        for i, name in enumerate(("i2t", "t2i")):
            for a, b in zip(kern["out"][i], plain["out"][i]):
                if np.argmax(a) != np.argmax(b):
                    gaps.append(abs(b[np.argmax(a)] - b[np.argmax(b)]))
        log(f"[{tag}] recalls differ: {metrics} against {plain_metrics}; top-1 gaps "
            f"{sorted(gaps)[:8]}")
        if max(gaps, default=0.0) > 2 * STAGE1_RUN_BOUNDS["rescored"]:
            raise RuntimeError(f"{tag}: recalls differ past a near tie")
    else:
        log(f"[{tag}] recalls equal to the all-plain run's")
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    del runs, kern, plain, model
    return {"metrics": metrics, "plain_metrics": plain_metrics, "stage_seconds":
            {k: stats[k] for k in stages}, "plain_stage_seconds":
            {k: plain_stats[k] for k in stages}, "itm_calls": stats["itm_calls"],
            "total_s": total_s, "peak_memory_gib": peak, "launches": launches,
            "k1_max_abs": sim_err, "itm_max_abs": itm_err, "free_running": free,
            "frozen_max_abs": float(frozen_d.max()), "feats_max_abs": feats_d,
            "text_feats_max_abs": text_d, "top_sets_differ": ties,
            "stages": stage_rows, "seconds": seconds}


def phase_stage1_train(work):
    """10b: BLIP-2 stage-1 pretraining through cli/train.py (phase 10 of the docstring)."""
    import argparse

    from sprc_tpu_torch import kernel_checks
    from sprc_tpu_torch.cli import train as train_cli
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.train import generic
    from sprc_tpu_torch.train.loop import TrainConfig
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    tag = "stage1 train"
    t_phase = time.perf_counter()
    root = os.path.join(work, "cc3m")
    ann = _write_pairs(root, STAGE1_PAIRS, 0, SEED + 11, "cc")
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    out = os.path.join(work, "stage1_train")
    if os.path.isdir(out):
        import shutil

        shutil.rmtree(out)
    cfg, how = _run_config("pretrain_stage1.yaml", {
        "run": {"max_epochs": 1, "seed": SEED, "log_freq": 1},
        "datasets": {"conceptual_caption_3m": {"build_info": {"annotations": {"train": [ann]},
                                                              "images": root}}}})
    log(f"[{tag}] cli/train.py through {how}")
    args = argparse.Namespace(output_dir=out, vocab_path=vocab, model_path=None, resume=None,
                              device=DEVICE, data_path=None)
    counters = _counters()

    def read():
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    real_step = generic.GenericTrainer.train_step
    times, per_step = [], []

    def timed(self, batch):
        before = read()
        t0 = time.perf_counter()
        metrics = real_step(self, batch)  # ends in a host read of the losses
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: v - before[k] for k, v in read().items()})
        return metrics

    generic.GenericTrainer.train_step = timed
    try:
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_cli.train(cfg, args)
        sync()
        run_s = time.perf_counter() - t0
        launches = read()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        generic.GenericTrainer.train_step = real_step
    with open(os.path.join(out, "log.jsonl")) as f:
        steps = [r for r in map(json.loads, f) if r["kind"] == "step"]
    batch_size = cfg.run["batch_size"]
    log(f"[{tag}] {len(steps)} steps at batch {batch_size}: ms "
        + ", ".join(f"{t:.1f}" for t in times) + f"; samples/s (last step) "
        f"{batch_size / times[-1] * 1e3:.1f}; peak {peak:.2f} GiB; run {run_s:.1f} s; losses "
        + "; ".join(", ".join(f"{k} {r[k]:.4f}" for k in ("loss_itc", "loss_itm", "loss_lm"))
                    for r in steps))
    log(f"[{tag}] launches: {launches}; a step: {per_step}")
    if len(steps) != STAGE1_PAIRS // batch_size or any(r["skipped_nonfinite"] for r in steps):
        raise RuntimeError(f"{tag}: steps {steps}")
    if not all(np.isfinite(r[k]) for r in steps for k in ("loss_itc", "loss_itm", "loss_lm")):
        raise RuntimeError(f"{tag}: a loss is not finite: {steps}")
    for launch in per_step:
        bad = {k: v for k, v in launch.items() if v != STAGE1_STEP_LAUNCHES.get(k, 0)}
        if bad:
            raise RuntimeError(f"{tag}: a step's launches {bad}, expected {STAGE1_STEP_LAUNCHES}")
    if peak >= 80.0:
        raise RuntimeError(f"{tag}: peak {peak:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()

    # (a) one step through the kernels against the all-plain step: from the
    # kernel tower's rows (TRAIN_BOUNDS["rows"]) and from the pixels
    # (TRAIN_BOUNDS["live"]); the kernel step's hard negatives handed over
    model = load_model("blip2", "pretrain", device=DEVICE, seed=SEED)
    tokenizer = BertWordPieceTokenizer.from_vocab_file(vocab)
    datasets = registry.get("dataset", "conceptual_caption_3m")(
        dict(cfg.datasets["conceptual_caption_3m"])).build()
    task = generic.BuilderTask(datasets, generic.PretrainAdapter(
        tokenizer, max_txt_len=cfg.run["max_txt_len"]), batch_size=batch_size, seed=SEED,
        device=DEVICE)
    batch = task.prepare_batch(next(iter(task.train_loader(0))))
    tcfg = TrainConfig(learning_rate=float(cfg.run["learning_rate"]), total_steps=2)
    names = [n for n, p in model.named_parameters() if p.requires_grad]

    class RowsTrainer(generic.GenericTrainer):
        def forward(self, b):
            return self.model.forward_cached(b["tower"], b["input_ids"], b["text_mask"],
                                             generator=self.generator)

    kept = read()
    picks = {}
    with hard_negatives(model, picks, inject=False):
        _, k_losses, k_grads = generic.GenericTrainer(model, tcfg, seed=SEED).loss_and_grads(batch)
    with torch.no_grad():
        tower = model.encode_tower(batch["images"])
    gaps, moved = {}, {}
    for case, trainer_cls, step in (("rows", RowsTrainer, dict(batch, tower=tower)),
                                    ("live", generic.GenericTrainer, batch)):
        with primitives.plain_reference(), hard_negatives(model, picks, inject=True) as m:
            _, p_losses, p_grads = trainer_cls(model, tcfg, seed=SEED).loss_and_grads(step)
        sync()
        gaps[case] = {"loss": _loss_gap(k_losses, p_losses),
                      "grad": kernel_checks.grad_gap(k_grads, p_grads, names)}
        moved[case] = dict(m)
        del p_grads
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, kept[k])
    for case, gap in gaps.items():
        log(f"[{tag}] the kernel step against the all-plain step from the "
            f"{'tower rows' if case == 'rows' else 'pixels'}: losses {gap['loss']:.3e} "
            f"(bound {STAGE1_BOUNDS[case]['loss']:.0e}), gradients {gap['grad']['gap']:.3e} "
            f"(bound {STAGE1_BOUNDS[case]['grad']:.0e}; worst {gap['grad']['worst']}); hard "
            f"negatives the plain step would move: {moved[case]['moved']} of {moved[case]['of']}")
        if (gap["loss"] > STAGE1_BOUNDS[case]["loss"]
                or gap["grad"]["gap"] > STAGE1_BOUNDS[case]["grad"]):
            raise RuntimeError(f"{tag}: the {case} step beyond STAGE1_BOUNDS: {gap}")
    del model, k_grads, tower, batch
    gc.collect()
    torch.cuda.empty_cache()
    k1 = kernel_checks.check_token_max_sim_grad(DEVICE, B=batch_size, N=batch_size)
    log(f"[{tag}] K1 with a gradient at {k1['shape']}: max_abs {k1['max_abs_err']:.3e}, "
        f"gradients {k1['grad_max_abs_err']:.3e} -> {'ok' if k1['ok'] else 'FAIL'}")
    if not k1["ok"]:
        raise RuntimeError(f"{tag}: K1 with a gradient disagrees: {k1}")
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"step_ms": times, "samples_per_s": batch_size / times[-1] * 1e3,
            "peak_memory_gib": peak, "losses": steps, "launches": launches,
            "launches_step": per_step, "gaps": {c: {"loss": g["loss"], "grad": g["grad"]["gap"]}
                                                for c, g in gaps.items()},
            "hard_negatives_moved": {c: m["moved"] for c, m in moved.items()},
            "k1_grad": k1, "seconds": seconds}


# phase 11, the unfrozen ViT: cli/train.py on retrieval_coco_blip2_ft.yaml
# (blip2 / coco: EVA ViT-g at 364 px, S = 677, the fp32 tower, freeze_vit
# false: every tower tensor gets a gradient and AdamW moments) at the YAML's
# batch of 32 over UNFROZEN_PAIRS seeded PNG pairs (one epoch: 3 steps)
UNFROZEN_PAIRS = 96
# the tower trains 13 of EVA ViT-g's 39 blocks (every width as the row's): its
# forward and backward took most of the phase
UNFROZEN_DEPTH = 13
# a step's launches on the main path (the whole-block route): K1 once (ITC),
# the tower's chain once through FusedViTBlock (a block: 4 fp32 GEMMs, one
# fp32 attention, 2 LayerNorms); the backward recomputes the plain
# blocks (the library's products, no launch); no Q-Former layer kernel
UNFROZEN_STEP_LAUNCHES = {"token_max_sim": 1, "fused_vit_block": UNFROZEN_DEPTH,
                          "gemm_f32": 4 * UNFROZEN_DEPTH, "attention_f32": UNFROZEN_DEPTH,
                          "layer_norm": 2 * UNFROZEN_DEPTH}
# the tower's other routes, one step each (their Functions' kernels once a
# block; the unfused route twice: its blocks keep their intermediates, so
# vit_remat runs each again in the backward, flash_attention included)
UNFROZEN_ROUTES = {"attn+mlp": ({"fused_block": "attn", "fused_mlp": True},
                                {"fused_attn_block": UNFROZEN_DEPTH,
                                 "fused_mlp_block": UNFROZEN_DEPTH}),
                   "unfused": ({"fused_block": "none", "fused_mlp": False},
                               {"flash_attention": 2 * UNFROZEN_DEPTH})}
# Bounds, fixed before the first reading. A kernel step against the
# all-plain step (primitives.plain_reference, vit_remat on: without it the
# plain tower's intermediates do not fit) from the same pixels, the kernel
# step's hard negatives handed over. The fp32 tower's rows differ from the
# plain tower's by about 1.4e-5 (phase 10a's reading); the losses of the fp32
# Q-Former on them are held at 1e-5 relative; the gradients as phase 7's
# "live" (0.9: a token-max argmax that such a difference moves makes the
# gradient jump, up to 0.38 in phase 7; a missing, doubled or reversed
# gradient gives 1 or 2). "tower_grad": the tower alone from the same pixels
# and one seeded cotangent, each route's kernel Functions against the plain
# blocks: every tower gradient within 1e-3 of its tensor's largest (grad_gap;
# the block inputs differ by the fp32 chain's 1e-6 a block, through the
# blocks; a gradient scaled by 0.5 or lost gives 0.5 or 1)
UNFROZEN_BOUNDS = {"loss": 1e-5, "grad": 0.9, "tower_grad": 1e-3}


def _set_tower_route(model, **route):
    """Switch a built tower to another route over the same weights."""
    import dataclasses

    tower = model.visual_encoder
    tower.cfg = dataclasses.replace(tower.cfg, **route)
    for block in tower.vit_blocks():
        block.cfg = tower.cfg


def _block_grad_norms(model, names, grads):
    """The gradient norm of each tower block (over all its tensors)."""
    blocks = model.visual_encoder.vit_blocks()
    owner = {id(p): i for i, block in enumerate(blocks) for p in block.parameters()}
    params = dict(model.named_parameters())
    sums = [0.0] * len(blocks)
    for n, g in zip(names, grads):
        i = owner.get(id(params[n]))
        if i is not None:
            sums[i] += g.double().square().sum().item()
    return [v ** 0.5 for v in sums]


def phase_unfrozen_train(work):
    """11: BLIP-2 stage 1's COCO fine-tune through cli/train.py with the tower
    trained (phase 11 of the docstring)."""
    import argparse
    import shutil

    from sprc_tpu_torch import kernel_checks
    from sprc_tpu_torch.cli import train as train_cli
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.train import generic
    from sprc_tpu_torch.train.loop import TrainConfig
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    tag = "unfrozen"
    t_phase = time.perf_counter()
    root = os.path.join(work, "coco_train")
    ann = _write_pairs(root, UNFROZEN_PAIRS, 0, SEED + 12, "ct")
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    out = os.path.join(work, "unfrozen_train")
    shutil.rmtree(out, ignore_errors=True)
    cut = _cut_depth("blip2", "coco", vit_depth=UNFROZEN_DEPTH)
    cfg, how = _run_config("retrieval_coco_blip2_ft.yaml", {
        "run": {"max_epochs": 1, "seed": SEED, "log_freq": 1}, "model": cut,
        "datasets": {"coco_retrieval": {"build_info": {"annotations": {"train": [ann]},
                                                       "images": root}}}})
    log(f"[{tag}] cli/train.py through {how}")
    args = argparse.Namespace(output_dir=out, vocab_path=vocab, model_path=None, resume=None,
                              device=DEVICE, data_path=None)
    counters = _counters()

    def read():
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    def zero():
        for obj, attr in counters.values():
            setattr(obj, attr, 0)

    real_step = generic.GenericTrainer.train_step
    times, per_step, first = [], [], {}

    def timed(self, batch):
        if not first:  # two tensors of each block before the first update
            first["model"] = self.model
            first["blocks"] = [(b.norm1.weight.detach().clone(), b.mlp.fc2.bias.detach().clone())
                               for b in self.model.visual_encoder.vit_blocks()]
        before = read()
        t0 = time.perf_counter()
        metrics = real_step(self, batch)  # ends in a host read of the losses
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: v - before[k] for k, v in read().items()})
        return metrics

    generic.GenericTrainer.train_step = timed
    try:
        zero()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_cli.train(cfg, args)
        sync()
        run_s = time.perf_counter() - t0
        launches = read()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        generic.GenericTrainer.train_step = real_step
    trained = first.pop("model")
    moved = [max((b.norm1.weight - w).abs().max().item(), (b.mlp.fc2.bias - c).abs().max().item())
             for b, (w, c) in zip(trained.visual_encoder.vit_blocks(), first.pop("blocks"))]
    del trained
    with open(os.path.join(out, "log.jsonl")) as f:
        steps = [r for r in map(json.loads, f) if r["kind"] == "step"]
    batch_size = cfg.run["batch_size"]
    log(f"[{tag}] {len(steps)} steps at batch {batch_size}: ms "
        + ", ".join(f"{t:.1f}" for t in times) + f"; samples/s (last step) "
        f"{batch_size / times[-1] * 1e3:.2f}; peak {peak:.2f} GiB; run {run_s:.1f} s; losses "
        + "; ".join(", ".join(f"{k} {r[k]:.4f}" for k in ("loss_itc", "loss_itm", "loss_lm"))
                    for r in steps))
    log(f"[{tag}] launches: {launches}; a step: {per_step}")
    log(f"[{tag}] the tower's blocks moved by the {len(steps)} updates (max |change| of "
        "norm1.weight and "
        f"fc2.bias): min {min(moved):.3e}, max {max(moved):.3e}")
    if len(steps) != UNFROZEN_PAIRS // batch_size or any(r["skipped_nonfinite"] for r in steps):
        raise RuntimeError(f"{tag}: steps {steps}")
    if not all(np.isfinite(r[k]) for r in steps for k in ("loss_itc", "loss_itm", "loss_lm")):
        raise RuntimeError(f"{tag}: a loss is not finite: {steps}")
    for launch in per_step:
        bad = {k: v for k, v in launch.items() if v != UNFROZEN_STEP_LAUNCHES.get(k, 0)}
        if bad:
            raise RuntimeError(f"{tag}: a step's launches {bad}, expected {UNFROZEN_STEP_LAUNCHES}")
    if peak >= 80.0:
        raise RuntimeError(f"{tag}: peak {peak:.2f} GiB")
    if min(moved) <= 0.0:
        raise RuntimeError(f"{tag}: a tower block did not move: {moved}")
    gc.collect()
    torch.cuda.empty_cache()

    # (a) one step through the kernels on each tower route against the
    # all-plain step, from the same pixels, the kernel step's hard negatives
    # handed over (UNFROZEN_BOUNDS); the gradient norm of every tower block
    model = load_model("blip2", "coco", device=DEVICE, seed=SEED, vit_remat=True, **cut)
    tokenizer = BertWordPieceTokenizer.from_vocab_file(vocab)
    datasets = registry.get("dataset", "coco_retrieval")(
        dict(cfg.datasets["coco_retrieval"])).build()
    task = generic.BuilderTask(datasets, generic.PretrainAdapter(
        tokenizer, max_txt_len=cfg.run["max_txt_len"]), batch_size=batch_size, seed=SEED,
        device=DEVICE)
    batch = task.prepare_batch(next(iter(task.train_loader(0))))
    tcfg = TrainConfig(learning_rate=float(cfg.run["learning_rate"]), total_steps=2)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    tower_names = [n for n in names if n.startswith("visual_encoder.")]
    assert len(tower_names) == sum(1 for _ in model.visual_encoder.parameters())

    def step(**kw):
        return generic.GenericTrainer(model, tcfg, seed=SEED).loss_and_grads(batch)[1:]

    kept = read()
    picks = {}
    zero()
    with hard_negatives(model, picks, inject=False):
        k_losses, k_grads = step()
    sync()
    step_launches = {k: v for k, v in read().items() if v}
    norms = _block_grad_norms(model, names, k_grads)
    with primitives.plain_reference(), hard_negatives(model, picks, inject=True) as m:
        p_losses, p_grads = step()
    sync()
    gaps = {"block": {"loss": _loss_gap(k_losses, p_losses),
                      "grad": kernel_checks.grad_gap(k_grads, p_grads, names)}}
    moved_negs = {"block": dict(m)}
    route_launches = {}
    del k_grads
    for route, (fields, own) in UNFROZEN_ROUTES.items():
        _set_tower_route(model, **fields)
        zero()
        with hard_negatives(model, picks, inject=True) as m:
            r_losses, r_grads = step()
        sync()
        route_launches[route] = {k: v for k, v in read().items() if v}
        gaps[route] = {"loss": _loss_gap(r_losses, p_losses),
                       "grad": kernel_checks.grad_gap(r_grads, p_grads, names)}
        moved_negs[route] = dict(m)
        del r_grads
        bad = {k: route_launches[route].get(k, 0) for k in own
               if route_launches[route].get(k, 0) != own[k]}
        if bad:
            raise RuntimeError(f"{tag}: the {route} route's step launched {bad}, expected {own}")
    _set_tower_route(model, fused_block="block", fused_mlp=False)
    del p_grads
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the tower alone on each route: forward and backward ms, and its
    # gradients from one seeded cotangent against the plain blocks'
    images = batch["images"]
    tower_params = list(model.visual_encoder.parameters())
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    cot = None

    def tower_pass():
        nonlocal cot
        sync()
        t0 = time.perf_counter()
        rows = model.encode_tower(images)
        sync()
        t1 = time.perf_counter()
        if cot is None:
            cot = torch.randn(rows.shape, generator=gen, device=DEVICE)
        grads = torch.autograd.grad(rows, tower_params, cot)
        sync()
        return grads, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    tower_pass()  # warm-up
    zero()
    k_tower, fwd_ms, bwd_ms = tower_pass()
    tower_launches = read()["fused_vit_block"]
    with primitives.plain_reference():
        p_tower, plain_fwd_ms, plain_bwd_ms = tower_pass()
    gaps["tower"] = {"grad": kernel_checks.grad_gap(list(k_tower), list(p_tower), tower_names)}
    del k_tower
    route_towers = {}
    for route, (fields, own) in UNFROZEN_ROUTES.items():
        _set_tower_route(model, **fields)
        zero()
        r_tower, r_fwd_ms, r_bwd_ms = tower_pass()
        r_launches = {k: v for k, v in read().items() if v}
        gaps[f"tower {route}"] = {"grad": kernel_checks.grad_gap(list(r_tower), list(p_tower),
                                                                 tower_names)}
        route_towers[route] = {"forward_ms": r_fwd_ms, "backward_ms": r_bwd_ms,
                               "launches": r_launches}
        del r_tower
        bad = {k: r_launches.get(k, 0) for k in own if r_launches.get(k, 0) != own[k]}
        if bad:
            raise RuntimeError(f"{tag}: the {route} route's tower pass launched {bad}, "
                               f"expected {own}")
    del p_tower, model
    gc.collect()
    torch.cuda.empty_cache()

    # (c) one block's backward at the step's batch, three ways that keep only
    # the block's input (kernel_checks.profile_block_backward)
    block_bwd = kernel_checks.profile_block_backward(DEVICE, B=batch_size)
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, kept[k])

    log(f"[{tag}] a kernel step's launches (whole-block route): {step_launches}; K2 launches a "
        f"step {step_launches.get('fused_vit_block', 0)} ({UNFROZEN_DEPTH} blocks)")
    log(f"[{tag}] gradient norms of the {UNFROZEN_DEPTH} tower blocks (the kernel step): "
        + ", ".join(f"{v:.3e}" for v in norms))
    log(f"[{tag}] the tower at batch {batch_size}: forward {fwd_ms:.1f} ms, backward "
        f"{bwd_ms:.1f} ms (K2 launches {tower_launches}); all-plain with remat: forward "
        f"{plain_fwd_ms:.1f} ms, backward {plain_bwd_ms:.1f} ms")
    for route, t in route_towers.items():
        log(f"[{tag}] the tower on the {route} route: forward {t['forward_ms']:.1f} ms, backward "
            f"{t['backward_ms']:.1f} ms; launches {t['launches']}")
    for way, b in block_bwd.items():
        log(f"[{tag}] one block at batch {batch_size}, {way}: forward {b['forward_ms']:.2f} ms, "
            f"backward {b['backward_ms']:.2f} ms (device {b['backward_device_ms']:.2f} ms; "
            f"{b['backward_kernels']} kernels, {b['backward_gemms']} GEMMs in "
            f"{b['backward_gemm_ms']:.2f} ms; {b['backward_new_segments']} new segments; kernels "
            f"in each profile {b['profiles_kernels']})")
    for route, gap in gaps.items():
        if route.startswith("tower"):
            log(f"[{tag}] the tower's gradients from one cotangent, kernels against plain "
                f"({route}): {gap['grad']['gap']:.3e} (bound "
                f"{UNFROZEN_BOUNDS['tower_grad']:.0e}; worst {gap['grad']['worst']})")
            continue
        log(f"[{tag}] the {route} route's kernel step against the all-plain step: losses "
            f"{gap['loss']:.3e} (bound {UNFROZEN_BOUNDS['loss']:.0e}), gradients "
            f"{gap['grad']['gap']:.3e} (bound {UNFROZEN_BOUNDS['grad']:.0e}; worst "
            f"{gap['grad']['worst']}); launches {route_launches.get(route, step_launches)}; "
            f"hard negatives the step would move: {moved_negs[route]['moved']} of "
            f"{moved_negs[route]['of']}")
    failed = [r for r, g in gaps.items() if (
        g["grad"]["gap"] > UNFROZEN_BOUNDS["tower_grad"] if r.startswith("tower") else
        (g["loss"] > UNFROZEN_BOUNDS["loss"] or g["grad"]["gap"] > UNFROZEN_BOUNDS["grad"]))]
    if failed:
        raise RuntimeError(f"{tag}: beyond UNFROZEN_BOUNDS: {failed}")
    if step_launches.get("fused_vit_block") != UNFROZEN_DEPTH or tower_launches != UNFROZEN_DEPTH:
        raise RuntimeError(f"{tag}: K2 launched {step_launches} in a step, {tower_launches} in "
                           f"the tower's pass; expected {UNFROZEN_DEPTH}")
    if len(norms) != UNFROZEN_DEPTH or min(norms) <= 0.0 or not all(np.isfinite(norms)):
        raise RuntimeError(f"{tag}: a tower block's gradient norm is not positive: {norms}")
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"step_ms": times, "samples_per_s": batch_size / times[-1] * 1e3,
            "peak_memory_gib": peak, "losses": steps, "launches": launches,
            "launches_step": per_step, "tower_forward_ms": fwd_ms, "tower_backward_ms": bwd_ms,
            "tower_plain_forward_ms": plain_fwd_ms, "tower_plain_backward_ms": plain_bwd_ms,
            "tower_routes": route_towers, "block_backward": block_bwd,
            "block_grad_norms": norms, "blocks_moved": moved, "route_launches": route_launches,
            "gaps": {r: {k: (v["gap"] if isinstance(v, dict) else v) for k, v in g.items()}
                     for r, g in gaps.items()},
            "hard_negatives_moved": {r: m["moved"] for r, m in moved_negs.items()},
            "seconds": seconds}


def check_routes_agree(runs):
    base = runs["block"]["target_feats"]
    for route, run in runs.items():
        d = (run["target_feats"] - base).abs()
        log(f"[validate] route {route} against the whole-block route, target feats of "
            f"{GALLERY} images: max_abs {d.max().item():.3e} mean_abs {d.mean().item():.3e}")
        assert d.max().item() <= ROUTE_TARGET_MAX_ABS, (route, d.max().item())
        assert d.mean().item() <= ROUTE_TARGET_MEAN_ABS, (route, d.mean().item())


def report_int8_against_bf16(bf16, int8):
    """Not a gate: how far the int8 configuration's answers lie from the
    bf16/fp32 configuration's, on random weights (near-tied scores)."""
    d = (int8["target_feats"] - bf16["target_feats"]).abs()
    top1 = sum(a[0]["name"] == b[0]["name"] for a, b in zip(int8["served"], bf16["served"]))
    top10 = np.mean([len({r["name"] for r in a} & {r["name"] for r in b}) / K
                     for a, b in zip(int8["served"], bf16["served"])])
    log(f"[int8 vs bf16] random weights, {GALLERY} images, {QUERY_BATCH} queries: target feats "
        f"max_abs {d.max().item():.3e} mean_abs {d.mean().item():.3e}; top-1 equal on "
        f"{top1}/{QUERY_BATCH}; mean top-{K} overlap {top10:.3f}")
    return {"target_max_abs": d.max().item(), "target_mean_abs": d.mean().item(),
            "top1_equal": int(top1), "top10_overlap": float(top10)}


def check_counters(tag, launches):
    log(f"[counters] launches during the {tag} main path: {launches}")
    missing = [k for k in PATH_KERNELS[tag] if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched by the {tag} main path: {missing}")
    moved = [k for k, v in launches.items() if k not in PATH_KERNELS[tag] and v != 0]
    if moved:
        raise RuntimeError(f"the {tag} main path launched another configuration's kernels: {moved}")


# phase 12, BLIP-2 stage 2 (models/blip2_opt.py, models/blip2_t5.py): cli/evaluate.py
# on eval/caption_coco_{opt2.7b,flant5xl}_eval.yaml (EVA ViT-g at 364 px, the fp32
# tower, 32 queries; OPT-2.7b or FlanT5-XL in fp32) over CAPTION_IMAGES seeded PNG
# images of mixed sizes, CAPTION_REFS captions each (the coco_caption test layout):
# batches of 16, 16 and 8 padded to 16, max_len 30, the BERT tokenizer
CAPTION_IMAGES, CAPTION_REFS = 40, 5
CAPTION_HEADS = {"opt": ("eval/caption_coco_opt2.7b_eval.yaml", "blip2_opt"),
                 "t5": ("eval/caption_coco_flant5xl_eval.yaml", "blip2_t5")}
# the kernel run against the all-plain run (primitives.plain_reference) on the
# same weights, stage by stage over every batch: the frozen rows (max / mean
# |difference|: phase 10a's bound, the same tower and resolution), the Q-Former's
# query rows, the projected rows handed to the LLM and the prefill's logits
# (max |difference|), each about 4 times its reading on an H100 80GB HBM3 at
# 700 W: frozen 1.299e-5 / 1.844e-6 (OPT run), 1.317e-5 / 1.846e-6 (T5 run);
# queries 7.21e-6, 7.11e-6; projected 4.29e-6, 5.13e-6; logits OPT-2.7b
# 1.43e-5, FlanT5-XL 4.79e-3 (the FlanT5 bound is its own: the random
# FlanT5-XL moves its logits far more for the same input difference, which
# the witness below measures in every run: there, on the same card, noise of
# the kernel run's RMS difference moved FlanT5-XL's prefill logits by
# 5.93e-3 and its step logits by 4.30e-2, 13 of 48 rows taking another
# token, against the kernel run's 4.79e-3, 4.75e-2 and 8 rows; OPT-2.7b's
# 1.36e-5 and 1.43e-5, no row, against 1.43e-5, 1.43e-5, none); "llm": the
# prefill's logits on the kernel run's own projected rows through the
# all-plain model, which the LLM (no kernel) computes again to the bit; the
# recompute loop read 1.45e-5 (OPT) and 3.47e-4 (T5). Every decode step's logits of a
# row, up to its first differing id or its eos, are held too: the kernel
# run's against the all-plain run's at CAPTION_WITNESS_FACTOR times the
# witness's same reading (the all-plain LLM on the all-plain projected rows
# plus seeded normal noise of the RMS of the kernel run's difference there,
# batch by batch), and the recompute loop's against the cached decode's at
# the head's logits bound and at RECOMPUTE_SPREAD_FRACTION of the cached
# logits' spread. A row's ids may differ only at a step so held.
CAPTION_BOUNDS = {"frozen": STAGE1_RUN_BOUNDS["frozen"], "queries": 3e-5, "proj": 2e-5,
                  "logits": {"opt": 6e-5, "t5": 2e-2}, "llm": 1e-6}
CAPTION_WITNESS_FACTOR = 4
# The recompute loop (generate_ids(use_cache=False)) against the cached
# decode runs the same kernels on the same tower bits: only the K/V cache and
# the positions differ. A wrong cache slot or position hands a step another
# context, which moves its logits by about their spread over the vocabulary
# (their standard deviation about their mean; a random LLM head at width
# 4096 gives 0.02 x sqrt(4096) = 1.28), and their largest difference by more.
# So the loop is held at a tenth of the cached steps' spread, read in the same
# run, as well as at any bound of the row's own (phase 12's heads and the OPT
# head of phase 25a: CAPTION_BOUNDS["logits"]). Planted in a copy of
# models/opt.py and models/t5.py and run through phase 25 on the CPU (OPT at
# hidden 48; T5 at FlanT5's d_kv 64, d_model 512 and 1024), a cache written one
# slot off, a stale slot and positions one off each read 2 to 37 times this
# bound; an honest loop reads 3e-5 of it there, and 0.16 of it in FlanT5-XXL
# on an NVIDIA H100 80GB HBM3 at 700.00 W (2.102e-2 against 0.128).
RECOMPUTE_SPREAD_FRACTION = 0.1
# K2's blocks and K3's layers a batch on this path (the fp32 chain's own kernels,
# the fp32 GEMM, attention and LayerNorm, launch too; nothing else does)
CAPTION_BATCH_LAUNCHES = {"fused_vit_block": 39, "fused_qformer_layer": 12}
CAPTION_CHAIN = ("gemm_f32", "attention_f32", "layer_norm")


@contextlib.contextmanager
def _recording_caption(cls, rec):
    """Record, batch by batch, what a caption head computes on its way to the
    ids: the prompt's ids and mask, the tower's rows after ln_vision, the
    Q-Former's query rows, the projected rows, the prefill's logits, every
    decode step's logits [B, steps, V] and the ids; and the model, its first
    batch of images and the first batch's decode step with its cache."""
    from sprc_tpu_torch.models import blip2_opt, blip2_t5, generation

    real_encode, real_queries = cls.encode_image, cls.embed_image_queries
    real_generate = cls.generate_ids
    real_prefix, real_loop = blip2_opt.query_prefix, generation.cached_greedy_loop
    for key in ("prompts", "frozen", "queries", "proj", "logits0", "steps", "ids"):
        rec[key] = []

    def generate_ids(self, images, ids, mask, **kw):
        rec["prompts"].append((ids, mask))
        return real_generate(self, images, ids, mask, **kw)

    def encode_image(self, images):
        out = real_encode(self, images)
        rec.setdefault("model", self)
        rec.setdefault("images", images)
        rec["frozen"].append(out)
        return out

    def embed_image_queries(self, image_embeds, generator=None):
        out = real_queries(self, image_embeds, generator)
        rec["queries"].append(out)
        return out

    def query_prefix(model, proj, images, stats, generator=None):
        out = real_prefix(model, proj, images, stats, generator)
        rec["proj"].append(out)
        return out

    def loop(logits0, cache, pos0, step_fn, **kw):
        rec["logits0"].append(logits0.float())
        rec.setdefault("step", (step_fn, cache, pos0))
        steps = [logits0.float()]

        def step(tok, pos, c):
            logits, c = step_fn(tok, pos, c)
            steps.append(logits.float())
            return logits, c

        ids = real_loop(logits0, cache, pos0, step, **kw)
        rec["steps"].append(torch.stack(steps, dim=1))
        rec["ids"].append(ids)
        return ids

    cls.encode_image, cls.embed_image_queries = encode_image, embed_image_queries
    cls.generate_ids = generate_ids
    blip2_opt.query_prefix = blip2_t5.query_prefix = query_prefix
    generation.cached_greedy_loop = loop
    try:
        yield rec
    finally:
        del cls.encode_image, cls.embed_image_queries
        cls.generate_ids = real_generate
        blip2_opt.query_prefix = blip2_t5.query_prefix = real_prefix
        generation.cached_greedy_loop = real_loop


@contextlib.contextmanager
def _recording_recompute(model, steps):
    """Append to ``steps`` each token's logits [B, V] of a caption head's
    recompute loop (generate_ids(use_cache=False))."""
    if hasattr(model, "opt_model"):
        owner, name, pick = model.opt_model, "logits", lambda out: out
    else:  # T5 decodes the whole sequence a token: the token's logits are column len(steps)
        owner, name, pick = model.t5_model, "decode", lambda out: out[:, len(steps)]
    real = getattr(owner, name)

    def recorded(*args, **kw):
        out = real(*args, **kw)
        steps.append(pick(out).float())
        return out

    setattr(owner, name, recorded)
    try:
        yield steps
    finally:
        delattr(owner, name)


def _held_steps(got_ids, want_ids, got_steps, want_steps, eos):
    """Two greedy decodes of one batch held step by step -> (the largest
    |logit difference| over every row's steps up to its first differing id
    or its eos, [(row, that step, the reference's top-2 gap there, the
    largest |difference| there)] for each row whose ids differ). A flip
    that the steps cannot show, or whose gap exceeds twice the difference
    there, reads NaN."""
    n = min(got_steps.shape[1], want_steps.shape[1])
    diff = (got_steps[:, :n] - want_steps[:, :n]).abs().amax(dim=-1).cpu().numpy()
    top2 = torch.topk(want_steps[:, :n], 2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    worst, flips = 0.0, []
    for r, (a, b) in enumerate(zip(got_ids.cpu().numpy(), want_ids.cpu().numpy())):
        differ, ends = np.nonzero(a != b)[0], np.nonzero(b == eos)[0]
        end = min([n - 1] + [int(i[0]) for i in (differ, ends) if len(i)])
        worst = max(worst, float(diff[r, :end + 1].max()))
        if len(differ):
            t = int(differ[0])
            held = t < n and gap[r, t] <= 2 * diff[r, t]
            flips.append((r, t, float(gap[r, t]) if held else float("nan"),
                          float(diff[r, t]) if held else float("nan")))
    return worst, flips


def _step_weight_bytes(model):
    """The bytes of the LLM weights one cached decode step reads (OPT: all
    but the position table; T5, a stage-2 head's or a T5 itself: the decoder
    but its cross-attention k and v, projected once at prefill, and its bias
    tables, and the head, ``shared`` where it is tied)."""
    if hasattr(model, "opt_model"):
        named = [(n, p) for n, p in model.opt_model.named_parameters()
                 if "embed_positions" not in n]
    else:
        t5 = getattr(model, "t5_model", model)
        head = ("lm_head.", "shared.") if t5.cfg.tie_word_embeddings else ("lm_head.",)
        named = [(n, p) for n, p in t5.named_parameters()
                 if n.startswith(("decoder.",) + head)
                 and not any(k in n for k in ("EncDecAttention.k.", "EncDecAttention.v.",
                                              "relative_attention_bias"))]
    return sum(p.numel() * p.element_size() for _, p in named)


def _witness_rows(plain, kern, kind, gen):
    """The all-plain rows ``plain`` [B, ...] (fp32) moved by a draw of the
    size and kind of the kernel run's difference ``kern - plain``, from the
    generator ``gen``: "noise", normal noise of its RMS; "shuffled", the
    difference of another row of the batch (a seeded derangement of the
    rows: the same size and structure across tokens and features, from
    another image)."""
    diff = kern.float() - plain.float()
    if kind == "noise":
        return plain.float() + torch.randn(plain.shape, generator=gen, device=plain.device,
                                           dtype=torch.float32) * diff.pow(2).mean().sqrt()
    n = plain.shape[0]
    if kind != "shuffled" or n < 2:
        raise ValueError(f"witness {kind!r} over {n} rows")
    order = torch.randperm(n, generator=gen, device=plain.device)
    shift = int(torch.randint(1, n, (1,), generator=gen, device=plain.device).item())
    perm = torch.empty_like(order)
    perm[order] = order.roll(-shift)  # row order[j] takes row order[j + shift]'s difference
    return plain.float() + diff[perm]


def _all_plain_and_witness(cls, cfg, run_as, kern, eos, max_len, draws):
    """A head's evaluation again under ``primitives.plain_reference()`` on
    the same weights, recorded as the kernel run ``kern`` was, and the
    readings that hold one against the other: ``readings`` (max / mean
    |difference| of the frozen rows, the query rows, the projected rows and
    the prefill's logits), ``llm`` (the all-plain LLM on the kernel run's
    first projected rows against the kernel run's logits), ``steps`` /
    ``flips`` (every decode step's logits up to each row's first differing
    id, and the rows whose ids differ, by ``_held_steps``); and the
    witnesses, one for each (kind, seed) of ``draws``: the all-plain LLM on
    the all-plain projected rows moved by ``_witness_rows`` batch by batch
    (one generator a draw), read the same way; ``noise_rms``, the RMS of the
    kernel run's difference from them, batch by batch."""
    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.models import blip2_opt, blip2_t5
    from sprc_tpu_torch.ops import primitives

    plain, plain_stats = {}, {}
    t0 = time.perf_counter()
    with _recording_caption(cls, plain), primitives.plain_reference():
        plain_metrics = evaluate.evaluate(cfg, run_as("_plain"), plain_stats)
    sync()
    plain_s = time.perf_counter() - t0
    model, images = plain.pop("model"), plain.pop("images")
    plain.pop("step")
    real_prefix = blip2_opt.query_prefix

    def llm_on(rows):
        """The all-plain model's decode on the given projected rows of each
        batch (after that batch's prompt), recorded."""
        again = {}
        with _recording_caption(cls, again), torch.inference_mode():
            for r, prompt in zip(rows, kern["prompts"]):
                blip2_opt.query_prefix = blip2_t5.query_prefix = lambda *a, r=r: r
                model.generate_ids(images, *prompt, max_new_tokens=max_len)
        return again

    try:
        # the LLM alone on the kernel run's projected rows, batch 0
        again = llm_on(kern["proj"][:1])
        noise_rms = [(k - p).pow(2).mean().sqrt().item()
                     for k, p in zip(kern["proj"], plain["proj"])]
        witnesses = []
        for kind, seed in draws:
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            witnesses.append((kind, seed, llm_on([_witness_rows(p, k, kind, gen) for p, k in
                                                  zip(plain["proj"], kern["proj"])])))
    finally:
        blip2_opt.query_prefix = blip2_t5.query_prefix = real_prefix
    llm_d = (again["logits0"][0] - kern["logits0"][0]).abs().max().item()
    del model, images, again
    readings = {}
    for key in ("frozen", "queries", "proj", "logits0"):
        d = [(a - b).abs() for a, b in zip(kern[key], plain[key])]
        readings[key] = (max(x.max().item() for x in d),
                         float(np.mean([x.mean().item() for x in d])))

    def against_plain(run):
        held = [_held_steps(a, b, s, t, eos)
                for a, b, s, t in zip(run["ids"], plain["ids"], run["steps"], plain["steps"])]
        return (max(h[0] for h in held),
                [(b,) + f for b, h in enumerate(held) for f in h[1]],
                max((w - p).abs().max().item()
                    for w, p in zip(run["logits0"], plain["logits0"])))

    steps_d, flips, _ = against_plain(kern)
    read = []
    for kind, seed, run in witnesses:
        w_steps_d, w_flips, w_logits0 = against_plain(run)
        read.append({"kind": kind, "seed": seed, "logits0": w_logits0, "steps": w_steps_d,
                     "flips": w_flips})
    return {"metrics": plain_metrics, "stats": plain_stats, "seconds": plain_s, "llm": llm_d,
            "readings": readings, "steps": steps_d, "flips": flips, "noise_rms": noise_rms,
            "witnesses": read}


@contextlib.contextmanager
def _timed_builds():
    """The seconds of each ``loader.load_model`` call inside (the weights
    drawn on the card, synchronised), as a list."""
    from sprc_tpu_torch import loader

    inner, seconds = loader.load_model, []

    def load(*args, **kw):
        t0 = time.perf_counter()
        model = inner(*args, **kw)
        sync()
        seconds.append(time.perf_counter() - t0)
        return model

    loader.load_model = load
    try:
        yield seconds
    finally:
        loader.load_model = inner


def _recompute_against_cached(tag, model, images, prompt, kern, eos, tokens):
    """The recompute loop (``generate_ids(use_cache=False)``) on the kernel
    route against the recorded cached decode ``kern``, on the first batch
    (``images`` and ``prompt``, its ids and mask, every row: the tower and
    the Q-Former at the cached run's shapes) for ``tokens`` tokens: the
    largest step logit difference up to each row's first differing id or eos
    and the rows whose ids differ (``_held_steps``), read here and held by
    :func:`_hold_recompute`. -> (seconds, worst, flips, the cached steps'
    logits spread)."""
    rows = images.shape[0]
    t0 = time.perf_counter()
    with _recording_recompute(model, []) as re_steps, torch.inference_mode():
        recomputed = model.generate_ids(images, *prompt, max_new_tokens=tokens, use_cache=False)
    sync()
    seconds = time.perf_counter() - t0
    spread = kern["steps"][0].std(dim=-1).mean().item()
    worst, flips = _held_steps(recomputed, kern["ids"][0][:, :tokens],
                               torch.stack(re_steps, dim=1), kern["steps"][0], eos)
    del re_steps
    log(f"[{tag}] recompute loop (kernel route, batch 0, {rows} rows, {tokens} tokens): "
        f"{seconds:.2f} s; its step logits against the cached decode's, up to each row's first "
        f"differing id or eos: max_abs {worst:.3e} (the cached steps' logits spread {spread:.3e} "
        f"about their mean); rows whose ids differ (row, step, top-2 gap, |difference| there): "
        f"{flips}")
    return seconds, worst, flips, spread


def _hold_recompute(tag, recompute, own=math.inf):
    """The recompute loop's reading within RECOMPUTE_SPREAD_FRACTION of the
    cached logits' spread and within the row's ``own`` bound, and no row's
    ids differing where the steps do not show it."""
    _, worst, flips, spread = recompute
    bound = min(own, RECOMPUTE_SPREAD_FRACTION * spread)
    log(f"[{tag}] the recompute loop's max_abs {worst:.3e} against its bound {bound:.3e} "
        f"(the smaller of {RECOMPUTE_SPREAD_FRACTION} x the cached logits' spread "
        f"{spread:.3e} and the row's own {own:.3e})")
    if not worst <= bound or any(np.isnan(f[2]) for f in flips):
        raise RuntimeError(f"{tag}: the recompute loop against the cached decode: {worst} "
                           f"(bound {bound}), {flips}")


def _profile_decode(tag, model, kern, ms_token):
    """One cached decode step of the recorded first batch (its cache, the
    first token's position), host against device
    (``kernel_checks.profile_decode_step``), beside the LLM weights it reads."""
    from sprc_tpu_torch import kernel_checks

    step_fn, cache, pos0 = kern.pop("step")
    tok0 = kern["ids"][0][:, 0]
    with torch.inference_mode():
        decode = kernel_checks.profile_decode_step(lambda: step_fn(tok0, pos0, cache))
    del step_fn, cache
    weight_bytes = _step_weight_bytes(model)
    decode.update(weights_gb=weight_bytes / 1e9,
                  weights_ms=weight_bytes / kernel_checks.PEAK_BYTES * 1e3, loop_ms=ms_token)
    log(f"[{tag}] one cached decode step at batch {tok0.shape[0]} (the first token's "
        f"position): host {decode['host_ms']:.3f} ms, device {decode['device_ms']:.3f} ms, busy "
        f"share {decode['busy_share']:.3f} (the graph's output against the step's: max_abs "
        f"{decode['graph_max_abs']:.3e}); {decode['aten_ops']} ATen operators a step "
        f"({decode['aten_views']} views), {decode['kernels_profiled']} launches seen by one "
        f"profile, {decode['kernel_ms_profiled']:.3f} ms of kernels, the most in (name, "
        f"launches, ms) {decode['top_kernels']}; the weights it reads "
        f"{decode['weights_gb']:.2f} GB, {decode['weights_ms']:.3f} ms at the card's memory rate; "
        f"the clean run's loop {ms_token:.2f} ms a token")
    return decode


def phase_caption(work, head, large=False):
    """12a / 12b: the caption evaluation of one BLIP-2 stage-2 head (phase 12
    of the docstring); with ``large``, 25a: the row of LARGE_CAPTION over
    LARGE_ITEMS images, what the LLM moves held by the witnesses."""
    import argparse
    import inspect

    from sprc_tpu_torch import models as _models  # noqa: F401  (registers them)
    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    name, arch = CAPTION_HEADS[head]
    n_images, draws = CAPTION_IMAGES, [("noise", SEED + 120)]
    if large:
        name, n_images, draws = LARGE_CAPTION, LARGE_ITEMS, VQA_WITNESS
    cls = registry.get_model_class(arch)
    eos = inspect.signature(cls.generate_ids).parameters["eos_token_id"].default
    tag = f"caption {head}" + (" 25a" if large else "")
    t_phase = time.perf_counter()
    root = os.path.join(work, "coco_caption" + ("_large" if large else ""))
    ann = _write_pairs(root, n_images, CAPTION_REFS, SEED + 12, "cap")
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    cfg, how = _run_config(name, {
        "run": {"seed": SEED},
        "datasets": {"coco_caption": {"build_info": {"annotations": {"test": [ann]},
                                                     "images": root}}}})
    log(f"[{tag}] cli/evaluate.py through {how}")
    out_dir = os.path.join(work, f"caption_{head}" + ("_large" if large else ""))
    args = argparse.Namespace(device=DEVICE, model_path=None, vocab_path=vocab, split=None,
                              output_dir=out_dir)

    def run_as(suffix):
        return argparse.Namespace(**{**vars(args), "output_dir": out_dir + suffix})

    # the clean run: timed and counted, nothing recorded
    counters = _counters()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    with _timed_builds() as builds:
        metrics = evaluate.evaluate(cfg, args, stats)
    sync()
    total_s, build_s = time.perf_counter() - t0, sum(builds)
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(json.dumps({k: v for k, v in metrics.items() if isinstance(v, (int, float, str))}))
    with open(os.path.join(out_dir, "result", "test_epochx.json")) as f:
        result = json.load(f)
    batches = -(-n_images // cfg.run["batch_size_eval"])
    ms_token = stats["decode_s"] / stats["decode_steps"] * 1e3
    stages = ("image_encode_s", "qformer_s", "prefill_s", "decode_s")
    log(f"[{tag}] {batches} batches of {cfg.run['batch_size_eval']}: seconds by stage "
        + ", ".join(f"{k} {stats[k]:.3f}" for k in stages)
        + f"; {stats['decode_steps']} cached decode steps, {ms_token:.2f} ms a decoded token "
        f"({cfg.run['batch_size_eval']} rows); total {total_s:.2f} s (the model's build and "
        f"draw {build_s:.2f} s of it); peak {peak:.2f} GiB; "
        f"{len(result)} captions, e.g. {result[0]['caption'][:80]!r}")
    want = {k: v * batches for k, v in CAPTION_BATCH_LAUNCHES.items()}
    log(f"[{tag}] launches: {launches}")
    bad = {k: launches[k] for k in want if launches[k] != want[k]}
    bad.update({k: launches[k] for k in CAPTION_CHAIN if launches[k] <= 0})
    bad.update({k: v for k, v in launches.items()
                if k not in want and k not in CAPTION_CHAIN and v != 0})
    if bad:
        raise RuntimeError(f"{tag}: launches {bad}, expected {want} and the fp32 chain's")
    if len(result) != n_images or not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"{tag}: {len(result)} captions, metrics {metrics}")
    if peak >= 80.0:
        raise RuntimeError(f"{tag}: peak {peak:.2f} GiB")

    # the kernel route again, recorded; none of what follows is a main path's launch
    kept = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    kern = {}
    gc.collect()  # the clean run's model goes before the next is built
    torch.cuda.empty_cache()
    with _recording_caption(cls, kern):
        kern_metrics = evaluate.evaluate(cfg, run_as("_kern"), None)
    model, images = kern.pop("model"), kern.pop("images")
    decode = _profile_decode(tag, model, kern, ms_token)
    log(f"[{tag}] the recorded run's metrics "
        f"{'equal the clean run' if kern_metrics == metrics else kern_metrics}")

    # the recompute loop on the kernel route against the cached decode, first batch
    logits_bound = CAPTION_BOUNDS["logits"][head]
    recompute = _recompute_against_cached(
        tag, model, images, kern["prompts"][0], kern, eos,
        min(LARGE_RECOMPUTE_TOKENS, cfg.run["max_len"]) if large else cfg.run["max_len"])
    _hold_recompute(tag, recompute, logits_bound)
    recompute_s, re_worst, re_flips, _ = recompute
    del model, images
    gc.collect()
    torch.cuda.empty_cache()

    # the all-plain run on the same weights, stage by stage, and the witnesses
    plain_run = _all_plain_and_witness(cls, cfg, run_as, kern, eos, cfg.run["max_len"], draws)
    plain_metrics, plain_stats, plain_s, llm_d, readings, noise_rms = (
        plain_run[k] for k in ("metrics", "stats", "seconds", "llm", "readings", "noise_rms"))
    steps_d, flips = plain_run["steps"], plain_run["flips"]
    w_steps_d, w_logits0 = (float(np.median([w[k] for w in plain_run["witnesses"]]))
                            for k in ("steps", "logits0"))
    w_flips = [f for w in plain_run["witnesses"] for f in w["flips"]]
    steps_bound = CAPTION_WITNESS_FACTOR * w_steps_d
    if large:  # the prefill's logits by the witnesses too
        logits_bound = CAPTION_WITNESS_FACTOR * w_logits0
    rows = sum(len(i) for i in kern["ids"])
    each = [tuple(float(f"{w[k]:.3e}") for k in ("logits0", "steps"))
            for w in plain_run["witnesses"]]
    log(f"[{tag}] kernel run against the all-plain run: "
        + ", ".join(f"{k} max_abs {v[0]:.3e} mean_abs {v[1]:.3e}" for k, v in readings.items())
        + f"; the LLM on the kernel run's projected rows: logits max_abs {llm_d:.3e} (bounds "
        f"{CAPTION_BOUNDS}, logits {logits_bound}); the witnesses ({draws} on the all-plain "
        f"projected rows; the kernel run's difference has RMS "
        f"{[float(f'{s:.3e}') for s in noise_rms]}), their median: prefill logits max_abs "
        f"{w_logits0:.3e}, step logits max_abs {w_steps_d:.3e}; each draw's (prefill, steps) "
        f"{each}; "
        f"rows whose ids differ {len(w_flips)} in {len(draws)} x {rows} (batch, row, step, top-2 "
        f"gap, |difference| there) {w_flips}; the kernel run's step logits max_abs {steps_d:.3e} "
        f"(bound {CAPTION_WITNESS_FACTOR} x the witnesses', {steps_bound:.3e}), rows whose ids "
        f"differ {len(flips)} of {rows}: {flips}; all-plain (recorded) total {plain_s:.2f} s, "
        "seconds by stage " + ", ".join(f"{k} {plain_stats[k]:.3f}" for k in stages)
        + f"; metrics {'equal' if plain_metrics == metrics else plain_metrics}")
    checks = {"frozen": readings["frozen"], "queries": readings["queries"][0],
              "proj": readings["proj"][0], "logits": readings["logits0"][0], "llm": llm_d,
              "steps": steps_d}
    bounds = dict(CAPTION_BOUNDS, logits=logits_bound, steps=steps_bound)
    past = {k: v for k, v in checks.items() if not np.all(np.asarray(v) <= np.asarray(bounds[k]))}
    if past:
        raise RuntimeError(f"{tag}: the kernel run against the all-plain run past "
                           f"{bounds}: {past}")
    if any(np.isnan(f[3]) for f in flips):
        raise RuntimeError(f"{tag}: generated ids differ where the steps do not show it: {flips}")
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, kept[k])
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"metrics": metrics, "stage_seconds": {k: stats[k] for k in stages},
            "decode_steps": stats["decode_steps"], "ms_per_token": ms_token,
            "total_s": total_s, "peak_memory_gib": peak, "launches": launches,
            "decode_step": decode,
            "plain_stage_seconds": {k: plain_stats[k] for k in stages},
            "against_plain": {k: list(v) for k, v in readings.items()}, "llm_max_abs": llm_d,
            "step_logits_max_abs": steps_d, "ids_differ": flips,
            "witness": {"noise_rms": noise_rms, "logits0_max_abs": w_logits0,
                        "step_logits_max_abs": w_steps_d, "ids_differ": w_flips},
            "recompute_s": recompute_s, "recompute_step_logits_max_abs": re_worst,
            "recompute_ids_differ": re_flips, "build_s": build_s, "seconds": seconds}


def phase_instruct():
    """12c and 14c: cli/instruct.py --synthetic with every head on the card (the
    LLaMA names: blip2_vicuna_instruct retrieves over 8 gallery images,
    blip2_instruct_cir generates); the launches of these tiny runs are not a
    main path's (the counters are put back)."""
    import io

    from sprc_tpu_torch.cli import instruct

    counters = _counters()
    kept = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    out = {}
    for arch in ("blip2_opt", "blip2_t5", "blip2_vicuna_instruct", "blip2_instruct_cir"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            instruct.main(["--model-name", arch, "--synthetic"])
        line = buf.getvalue().strip().splitlines()[-1]
        log(f"[instruct] {line}")
        out[arch] = json.loads(line)
        if arch == "blip2_vicuna_instruct":
            ok = out[arch]["sims_shape"] == [2, 8] and out[arch]["finite"]
        else:
            ok = out[arch]["n_outputs"] == 2
        if not ok or out[arch]["model"] != arch:
            raise RuntimeError(f"instruct {arch}: {out[arch]}")
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, kept[k])
    return out


# phase 13, BLIP-2 stage 2 trains its caption heads (train/generic.py over
# models/blip2_{opt,t5}.py): cli/train.py on caption_coco_blip2_ft.yaml (blip2_opt /
# caption_coco_opt2.7b: EVA ViT-g fp32 at 364 px, its YAML's freeze_vit false,
# OPT-2.7b; batch 16) and pretrain_stage2.yaml (blip2_t5 / pretrain_flant5xl: the
# bf16 tower at 224 px, FlanT5-XL; batch 32), STAGE2_STEPS steps each over seeded
# PNG images; then zero-shot VQA through cli/evaluate.py
STAGE2_TRAIN = {"opt": ("caption_coco_blip2_ft.yaml", "blip2_opt"),
                "t5": ("pretrain_stage2.yaml", "blip2_t5")}
STAGE2_STEPS = 3
# a step's launches: the frozen tower's chain once, without a graph (39 blocks: 4
# GEMMs, one attention and 2 LayerNorms each; fp32 for the COCO row, bf16 for
# pretrain_flant5xl); the Q-Former trains unfused and the LLM is torch.matmul
STAGE2_STEP_LAUNCHES = {
    "opt": {"fused_vit_block": 39, "gemm_f32": 156, "attention_f32": 39, "layer_norm": 78},
    "t5": {"fused_vit_block": 39, "gemm": 156, "attention_bf16": 39, "layer_norm": 78}}
# Bounds, fixed before the first reading. "rows": the kernel run's steps against
# the all-plain run (primitives.plain_reference) from the kernel tower's rows of
# each batch, as 10b's "rows" case: everything after the tower (ln_vision, the
# Q-Former's training branch, the projection, the frozen LLM, AdamW) makes the
# same library calls in both, so each step's loss (relative), the first step's
# gradients (grad_gap) and every trainable tensor after the steps (max abs) are
# held at TRAIN_BOUNDS["rows"] and 1e-7; "frozen": the kernel tower's rows after
# ln_vision against the plain tower's on the first batch, phase 12's fp32 bound
# (the same tower at 364 px) and phase 5's bf16 one (EVA ViT-g at 224 px);
# "live": the kernel run's first step against the all-plain step from the
# pixels (the plain tower's own rows), the loss (relative) and the gradients
# (grad_gap): OPT's fp32 tower at phase 7's TRAIN_BOUNDS["live"]. The bf16
# tower's difference reaches a random FlanT5-XL, which phase 12's witness
# showed moves its logits about 1000 times its input's difference: a head
# without a "live" bound (t5) is held at CAPTION_WITNESS_FACTOR times the
# median of its witnesses' gaps, each the all-plain step from the plain
# tower's rows moved by _witness_rows (STAGE2_WITNESS: (kind, seed)) against
# the all-plain step from the pixels; shuffled draws, as VQA_WITNESS's (with
# white noise the route's loss gap came to 0.66 to 22 times a draw's: one
# signed scalar a draw).
STAGE2_BOUNDS = {"rows": dict(TRAIN_BOUNDS["rows"], params=1e-7),
                 "frozen": {"opt": CAPTION_BOUNDS["frozen"], "t5": EVA_BOUNDS["frozen"]},
                 "live": {"opt": TRAIN_BOUNDS["live"]}}
STAGE2_WITNESS = [("shuffled", SEED + 140 + j) for j in range(3)]


def _bits_digest(tensors):
    """Two int64 sums over each tensor's raw bits, plain and weighted by the
    position (mod 65521): a change of any one element changes them."""
    out = []
    for t in tensors:
        bits = t.detach().reshape(-1).view({4: torch.int32, 2: torch.int16}[t.element_size()])
        s1 = s2 = 0
        for c in range(0, bits.numel(), 1 << 24):
            chunk = bits[c:c + (1 << 24)].long()
            w = torch.arange(c, c + chunk.numel(), device=t.device) % 65521 + 1
            s1 += chunk.sum().item()
            s2 += (chunk * w).sum().item()
        out.append((s1, s2))
    return out


def phase_stage2_train(work, head):
    """13a / 13b: the caption training of one BLIP-2 stage-2 head (phase 13
    of the docstring)."""
    import argparse
    import shutil

    from sprc_tpu_torch import kernel_checks
    from sprc_tpu_torch.cli import train as train_cli
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.train import generic
    from sprc_tpu_torch.train.loop import TrainConfig
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    name, arch = STAGE2_TRAIN[head]
    tag = f"stage2 train {head}"
    t_phase = time.perf_counter()
    batch_size = RUN_CONFIGS[name]["run"]["batch_size"]
    root = os.path.join(work, f"stage2_{head}")
    ann = _write_pairs(root, STAGE2_STEPS * batch_size, 0, SEED + 13, "s2")
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    out = os.path.join(work, f"stage2_train_{head}")
    if os.path.isdir(out):
        shutil.rmtree(out)
    cfg, how = _run_config(name, {
        "run": {"max_epochs": 1, "seed": SEED, "log_freq": 1},
        "datasets": {"coco_caption": {"build_info": {"annotations": {"train": [ann]},
                                                     "images": root}}}})
    log(f"[{tag}] cli/train.py through {how}")
    args = argparse.Namespace(output_dir=out, vocab_path=vocab, model_path=None, resume=None,
                              device=DEVICE, data_path=None)
    counters = _counters()

    def read():
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    real_step = generic.GenericTrainer.train_step
    times, per_step, trainers = [], [], []

    def timed(self, batch):
        trainers[:] = [self]
        before = read()
        t0 = time.perf_counter()
        metrics = real_step(self, batch)  # ends in a host read of the losses
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: v - before[k] for k, v in read().items()})
        return metrics

    generic.GenericTrainer.train_step = timed
    try:
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_cli.train(cfg, args)
        sync()
        run_s = time.perf_counter() - t0
        launches = read()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        generic.GenericTrainer.train_step = real_step
    with open(os.path.join(out, "log.jsonl")) as f:
        steps = [r for r in map(json.loads, f) if r["kind"] == "step"]
    trained = trainers.pop().model
    step_ms = float(np.median(times))
    n_train = sum(p.numel() for p in trained.parameters() if p.requires_grad)
    log(f"[{tag}] {len(steps)} steps at batch {batch_size}: ms "
        + ", ".join(f"{t:.1f}" for t in times) + f"; samples/s (median step) "
        f"{batch_size / step_ms * 1e3:.1f}; peak {peak:.2f} GiB; run {run_s:.1f} s; losses "
        + ", ".join(f"{r['loss']:.4f}" for r in steps) + f"; {n_train / 1e6:.1f} M trainable "
        f"of {sum(p.numel() for p in trained.parameters()) / 1e6:.1f} M")
    log(f"[{tag}] launches: {({k: v for k, v in launches.items() if v})}; a step: "
        f"{[{k: v for k, v in d.items() if v} for d in per_step]}")
    if len(steps) != STAGE2_STEPS or any(r["skipped_nonfinite"] for r in steps):
        raise RuntimeError(f"{tag}: steps {steps}")
    if not all(np.isfinite(r["loss"]) for r in steps):
        raise RuntimeError(f"{tag}: a loss is not finite: {steps}")
    want_step = STAGE2_STEP_LAUNCHES[head]
    for launch in per_step:
        bad = {k: v for k, v in launch.items() if v != want_step.get(k, 0)}
        if bad:
            raise RuntimeError(f"{tag}: a step's launches {bad}, expected {want_step}")
    if peak >= 80.0:
        raise RuntimeError(f"{tag}: peak {peak:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()

    # the tower and the LLM after the CLI's steps against a fresh model of the
    # same seed, bit for bit; every trainable tensor moved
    kept = read()
    model = load_model(arch, cfg.model["model_type"], device=DEVICE, seed=SEED)
    fresh = dict(model.named_parameters())
    after = dict(trained.named_parameters())
    frozen = [n for n in fresh if n.startswith(model.FROZEN_PREFIXES)]
    changed = [n for n in frozen if not torch.equal(fresh[n], after[n])]
    names = [n for n in fresh if after[n].requires_grad]
    moved = sum(not torch.equal(fresh[n], after[n]) for n in names)
    trained_after = {n: after[n].detach().clone() for n in names}
    del trained, after
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] after the CLI's steps: {len(changed)} of {len(frozen)} frozen tensors (the "
        f"tower and the LLM, {sum(fresh[n].numel() for n in frozen) / 1e9:.3f} G values) "
        f"changed, {moved} of {len(names)} trainable tensors moved (freeze_vit "
        f"{model.cfg.freeze_vit}, the tower frozen by FROZEN_PREFIXES {model.FROZEN_PREFIXES})")
    if changed or moved == 0 or any(fresh[n].requires_grad for n in frozen):
        raise RuntimeError(f"{tag}: frozen tensors changed {changed[:5]}, trainable moved {moved}")
    digest = _bits_digest(fresh[n] for n in frozen)

    # the same steps again on the fresh model, through the kernels (the tower's
    # rows recorded) and all plain from those rows; one all-plain step from the
    # pixels beside them
    tokenizer = BertWordPieceTokenizer.from_vocab_file(vocab)
    datasets = registry.get("dataset", "coco_caption")(dict(cfg.datasets["coco_caption"])).build()
    adapter = generic.CaptionAdapter(tokenizer, max_txt_len=cfg.run["max_txt_len"]).specialize(
        model)
    task = generic.BuilderTask(datasets, adapter, batch_size=batch_size, seed=SEED, device=DEVICE)
    batches = [task.prepare_batch(b) for b in task.train_loader(0)]
    tcfg = TrainConfig(learning_rate=float(cfg.run["learning_rate"]),
                       weight_decay=float(cfg.run["weight_decay"]), total_steps=len(batches))
    start = {n: fresh[n].detach().clone() for n in names}

    def run(plain, rows=None, record=None, n_steps=len(batches)):
        with torch.no_grad():
            for n in names:
                fresh[n].copy_(start[n])
        trainer = generic.GenericTrainer(model, tcfg, seed=SEED, adapter=adapter)
        real_encode = model.encode_tower
        if rows is not None:
            feed = iter(rows)
            model.encode_tower = lambda images: next(feed)
        elif record is not None:
            model.encode_tower = lambda images: record.append(real_encode(images)) or record[-1]
        losses, first = [], None
        try:
            with primitives.plain_reference() if plain else contextlib.nullcontext():
                for b in batches[:n_steps]:
                    total, _, grads = trainer.loss_and_grads(b)
                    first = grads if first is None else first
                    trainer.apply_gradients(grads)
                    losses.append(total.item())
        finally:
            model.__dict__.pop("encode_tower", None)
        return losses, first, {n: p.detach().clone() for n, p in zip(trainer.names,
                                                                      trainer.params)}

    rows = []
    k_losses, k_grads, k_params = run(False, record=rows)
    r_losses, r_grads, r_params = run(True, rows=rows)
    l_losses, l_grads, _ = run(True, n_steps=1)
    with torch.no_grad(), primitives.plain_reference():
        plain_rows = model.encode_tower(batches[0]["images"])
        frozen_k, frozen_p = (model.ln_vision(r.float()) for r in (rows[0], plain_rows))
    frozen_d = (frozen_k - frozen_p).abs()
    frozen_gap = (frozen_d.max().item(), frozen_d.mean().item())
    rows_rms = (rows[0].float() - plain_rows.float()).pow(2).mean().sqrt().item()
    witnesses = []
    for kind, seed in STAGE2_WITNESS:
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        w_losses, w_grads, _ = run(True, rows=[_witness_rows(plain_rows, rows[0], kind, gen)],
                                   n_steps=1)
        witnesses.append({"kind": kind, "seed": seed,
                          "loss": abs(w_losses[0] - l_losses[0]) / abs(l_losses[0]),
                          "grad": kernel_checks.grad_gap(w_grads, l_grads, names)})
        del w_grads
    del rows, plain_rows, frozen_k, frozen_p, frozen_d
    gaps = {"rows": {"loss": max(abs(a - b) / abs(b) for a, b in zip(k_losses, r_losses)),
                     "grad": kernel_checks.grad_gap(k_grads, r_grads, names),
                     "params": max((k_params[n] - r_params[n]).abs().max().item() for n in names)},
            "live": {"loss": abs(k_losses[0] - l_losses[0]) / abs(l_losses[0]),
                     "grad": kernel_checks.grad_gap(k_grads, l_grads, names)}}
    rerun = {"loss": max(abs(a - r["loss"]) for a, r in zip(k_losses, steps)),
             "params": max((k_params[n] - trained_after[n]).abs().max().item() for n in names)}
    unchanged = _bits_digest(fresh[n] for n in frozen) == digest
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, kept[k])
    bounds = STAGE2_BOUNDS["rows"]
    live_bound = STAGE2_BOUNDS["live"].get(head) or {
        k: CAPTION_WITNESS_FACTOR * float(np.median([w[k] if k == "loss" else w[k]["gap"]
                                                     for w in witnesses]))
        for k in ("loss", "grad")}
    log(f"[{tag}] the kernel steps against the all-plain steps from the kernel tower's rows: "
        f"losses {gaps['rows']['loss']:.3e} (bound {bounds['loss']:.0e}), the first step's "
        f"gradients {gaps['rows']['grad']['gap']:.3e} (bound {bounds['grad']:.0e}; worst "
        f"{gaps['rows']['grad']['worst']}), the parameters after {len(batches)} steps "
        f"{gaps['rows']['params']:.3e} (bound {bounds['params']:.0e}); the kernel tower's rows "
        f"after ln_vision against the plain tower's (batch 0): max_abs {frozen_gap[0]:.3e} "
        f"mean_abs {frozen_gap[1]:.3e} (bound {STAGE2_BOUNDS['frozen'][head]}); the all-plain "
        f"step from the pixels: loss {gaps['live']['loss']:.3e}, gradients "
        f"{gaps['live']['grad']['gap']:.3e} (worst {gaps['live']['grad']['worst']}; bounds "
        f"{live_bound}{'' if head in STAGE2_BOUNDS['live'] else ', by the witnesses'}); the "
        f"tower rows' difference has RMS {rows_rms:.3e}; the witnesses against the all-plain "
        "step from the pixels: "
        + "; ".join(f"{w['kind']} (seed {w['seed']}): loss {w['loss']:.3e} (the kernel run's / "
                    f"this {gaps['live']['loss'] / max(w['loss'], 1e-30):.3f}), gradients "
                    f"{w['grad']['gap']:.3e} (the kernel run's / this "
                    f"{gaps['live']['grad']['gap'] / max(w['grad']['gap'], 1e-30):.3f}; worst "
                    f"{w['grad']['worst']})" for w in witnesses)
        + "; these "
        f"kernel steps against the CLI's: losses {rerun['loss']:.3e}, parameters "
        f"{rerun['params']:.3e}; the frozen tensors unchanged by these "
        f"{2 * len(batches) + 1 + len(witnesses)} "
        f"steps: {unchanged}")
    if (gaps["rows"]["loss"] > bounds["loss"] or gaps["rows"]["grad"]["gap"] > bounds["grad"]
            or gaps["rows"]["params"] > bounds["params"]):
        raise RuntimeError(f"{tag}: the kernel steps beyond STAGE2_BOUNDS['rows']: {gaps['rows']}")
    if not (gaps["live"]["loss"] <= live_bound["loss"]
            and gaps["live"]["grad"]["gap"] <= live_bound["grad"]):
        raise RuntimeError(f"{tag}: the kernel step against the all-plain step from the pixels: "
                           f"loss {gaps['live']['loss']}, gradients "
                           f"{gaps['live']['grad']['gap']}, bounds {live_bound}")
    fb = STAGE2_BOUNDS["frozen"][head]
    if not (frozen_gap[0] <= fb[0] and frozen_gap[1] <= fb[1]):
        raise RuntimeError(f"{tag}: the tower's rows against plain: {frozen_gap}, bound {fb}")
    if not unchanged:
        raise RuntimeError(f"{tag}: a frozen tensor changed in the comparison steps")
    del model, fresh, start, k_grads, r_grads, l_grads, k_params, r_params, trained_after, batches
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"step_ms": times, "samples_per_s": batch_size / step_ms * 1e3,
            "peak_memory_gib": peak, "losses": [r["loss"] for r in steps],
            "trainable_params": n_train, "launches": launches, "launches_step": per_step,
            "frozen_tensors": len(frozen), "frozen_changed": len(changed),
            "gaps": {"rows": {"loss": gaps["rows"]["loss"], "grad": gaps["rows"]["grad"]["gap"],
                              "params": gaps["rows"]["params"]},
                     "live": {"loss": gaps["live"]["loss"],
                              "grad": gaps["live"]["grad"]["gap"], "bounds": live_bound},
                     "frozen_rows": frozen_gap, "rows_rms": rows_rms,
                     "witnesses": [{"kind": w["kind"], "seed": w["seed"], "loss": w["loss"],
                                    "grad": w["grad"]["gap"]} for w in witnesses]},
            "rerun_against_cli": rerun, "seconds": seconds}


# 13c / 13d: cli/evaluate.py on eval/vqav2_zeroshot_opt_eval.yaml (blip2_opt /
# pretrain_opt2.7b) and eval/gqa_zeroshot_flant5xl_eval.yaml (blip2_t5 /
# pretrain_flant5xl): the bf16 EVA ViT-g at 224 px, the queries-only pass (K3),
# the fp32 LLM's greedy answer of max_len 10 after "Question: {} Short answer:",
# VQA_QUESTIONS seeded questions over as many PNG images (3 batches of 16), with
# synthetic answers (ten a question for vqa, one for gqa)
STAGE2_VQA = {"opt": ("eval/vqav2_zeroshot_opt_eval.yaml", "blip2_opt", "coco_vqa"),
              "t5": ("eval/gqa_zeroshot_flant5xl_eval.yaml", "blip2_t5", "gqa")}
VQA_QUESTIONS = 48
VQA_BATCH_LAUNCHES = {"fused_vit_block": 39, "fused_qformer_layer": 12}
# the chains' own kernels: the bf16 tower's and K3's fp32 ones
VQA_CHAIN = ("gemm", "attention_bf16", "gemm_f32", "attention_f32", "layer_norm")
# Bounds, fixed before the first reading: "frozen", the kernel run's rows after
# ln_vision against the all-plain run's (phase 5's bound for this bf16 tower);
# "queries" / "proj": the all-plain Q-Former (and projection) on the kernel run's
# own rows against the kernel run's (K3's 12-layer chain in fp32: phase 12's
# bounds); "llm": the all-plain LLM on the kernel run's projected rows (no
# kernel: to the bit). The free-running all-plain run's query rows, projected
# rows and logits are reported: its bf16 tower's rows differ from the kernel
# tower's at the bf16 level, which the LLMs move by as much as the witness
# shows; every decode step is held at CAPTION_WITNESS_FACTOR times the witness's
# reading, and a row's answer may differ only where the steps so held show it
VQA_BOUNDS = {"frozen": EVA_BOUNDS["frozen"], "queries": CAPTION_BOUNDS["queries"],
              "proj": CAPTION_BOUNDS["proj"], "llm": CAPTION_BOUNDS["llm"]}
# the witnesses' draws, (kind, seed) for _witness_rows; the steps are held at
# CAPTION_WITNESS_FACTOR times the median of their readings. Shuffled draws:
# white noise of the same RMS moves OPT-2.7b's step logits 3.6 to 3.9 times
# less than the route's own difference does (three draws each, PERF.md §6),
# another row's difference as much (1.03 to 1.06)
VQA_WITNESS = [("shuffled", SEED + 140 + j) for j in range(3)]


def _write_vqa(root, n, seed):
    """``n`` seeded PNG images of mixed sizes under ``root`` and a question
    each: ten answers with their types (VQAv2), and one (GQA)."""
    from sprc_tpu_torch.utils.artifacts import encode_png

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    ann = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(160, 480, 2))
        name = f"vqa{i:04d}.png"
        with open(os.path.join(root, name), "wb") as f:
            f.write(encode_png(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)))
        words = [str(x) for x in rng.choice(STAGE1_WORDS, 3)]
        ann.append({"image": name, "question": f"What is the {words[0]} {words[1]} near the "
                                               f"{words[2]}?", "question_id": 9000 + i,
                    "answers": [{"answer": str(rng.choice(words))} for _ in range(10)],
                    "answer": str(rng.choice(words)), "question_type": "what is the",
                    "answer_type": "other"})
    path = os.path.join(root, "annotations.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return path


def phase_vqa(work, head, large=False):
    """13c / 13d: the zero-shot VQA of one BLIP-2 stage-2 head (phase 13 of
    the docstring); with ``large``, 25b: the T5 head's config with the row
    LARGE_VQA_TYPE over LARGE_ITEMS questions, one cached decode step
    profiled, the recompute loop against the cached decode, the prefill's
    logits held by the witnesses too."""
    import argparse
    import inspect

    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    name, arch, ds_name = STAGE2_VQA[head]
    cls = registry.get_model_class(arch)
    eos = inspect.signature(cls.generate_ids).parameters["eos_token_id"].default
    tag = f"vqa {head}" + (" 25b" if large else "")
    t_phase = time.perf_counter()
    suffix = "_large" if large else ""
    n_questions = LARGE_ITEMS if large else VQA_QUESTIONS
    root = os.path.join(work, f"vqa_{head}{suffix}")
    ann = _write_vqa(root, n_questions, SEED + 130)
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    cfg, how = _run_config(name, {
        "run": {"seed": SEED},
        **({"model": {"model_type": LARGE_VQA_TYPE}} if large else {}),
        "datasets": {ds_name: {"build_info": {"annotations": {"val": [ann]}, "images": root}}}})
    log(f"[{tag}] cli/evaluate.py through {how}")
    out_dir = os.path.join(work, f"vqa_{head}{suffix}_out")
    args = argparse.Namespace(device=DEVICE, model_path=None, vocab_path=vocab, split=None,
                              output_dir=out_dir)

    def run_as(suffix):
        return argparse.Namespace(**{**vars(args), "output_dir": out_dir + suffix})

    # the clean run: timed and counted, nothing recorded
    counters = _counters()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    with _timed_builds() as builds:
        metrics = evaluate.evaluate(cfg, args, stats)
    sync()
    total_s, build_s = time.perf_counter() - t0, sum(builds)
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(json.dumps({k: v for k, v in metrics.items() if isinstance(v, (int, float, str))}))
    task = cfg.run["task"]
    with open(os.path.join(out_dir, "result", f"val_{task}_result.json")) as f:
        result = json.load(f)
    key = "answer" if task == "vqa" else "pred_ans"
    batch = cfg.run["batch_size_eval"]
    batches = -(-n_questions // batch)
    ms_token = stats["decode_s"] / max(stats["decode_steps"], 1) * 1e3
    stages = ("image_encode_s", "qformer_s", "prefill_s", "decode_s")
    log(f"[{tag}] {batches} batches of {batch}: seconds by stage "
        + ", ".join(f"{k} {stats[k]:.3f}" for k in stages)
        + f"; {stats['decode_steps']} cached decode steps, {ms_token:.2f} ms a decoded token "
        f"({batch} rows); total {total_s:.2f} s (the model's build and draw {build_s:.2f} s of "
        f"it); peak {peak:.2f} GiB; {len(result)} answers, "
        f"e.g. {[r[key][:30] for r in result[:3]]}")
    want = {k: v * batches for k, v in VQA_BATCH_LAUNCHES.items()}
    log(f"[{tag}] launches: {launches}")
    bad = {k: launches[k] for k in want if launches[k] != want[k]}
    bad.update({k: launches[k] for k in VQA_CHAIN if launches[k] <= 0})
    bad.update({k: v for k, v in launches.items()
                if k not in want and k not in VQA_CHAIN and v != 0})
    if bad:
        raise RuntimeError(f"{tag}: launches {bad}, expected {want} and the chains'")
    if (len(result) != n_questions or "agg_metrics" not in metrics
            or not all(np.isfinite(v) for v in metrics.values())):
        raise RuntimeError(f"{tag}: {len(result)} answers, metrics {metrics}")
    if peak >= 80.0:
        raise RuntimeError(f"{tag}: peak {peak:.2f} GiB")

    # the kernel route again, recorded; none of what follows is a main path's launch
    kept = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    kern = {}
    gc.collect()  # the clean run's model goes before the next is built
    torch.cuda.empty_cache()
    with _recording_caption(cls, kern):
        kern_metrics = evaluate.evaluate(cfg, run_as("_kern"), None)
    model, images = kern.pop("model"), kern.pop("images")
    decode, recompute = None, None
    if large:
        decode = _profile_decode(tag, model, kern, ms_token)
        recompute = _recompute_against_cached(
            tag, model, images, kern["prompts"][0], kern, eos,
            min(LARGE_RECOMPUTE_TOKENS, cfg.run["max_len"]))
        _hold_recompute(tag, recompute)
    kern.pop("step", None)
    proj = model.opt_proj if head == "opt" else model.t5_proj
    with torch.inference_mode(), primitives.plain_reference():
        again = [model.embed_image_queries(f) for f in kern["frozen"]]
        own = {"queries": max((a - q).abs().max().item() for a, q in zip(again, kern["queries"])),
               "proj": max((proj(a) - p).abs().max().item() for a, p in zip(again, kern["proj"]))}
    del model, images, again, proj
    gc.collect()
    torch.cuda.empty_cache()

    # the all-plain run on the same weights, stage by stage, and the witness
    plain = _all_plain_and_witness(cls, cfg, run_as, kern, eos, cfg.run["max_len"],
                                   VQA_WITNESS)
    readings, witnesses = plain["readings"], plain["witnesses"]
    witness_steps = float(np.median([w["steps"] for w in witnesses]))
    steps_bound = CAPTION_WITNESS_FACTOR * witness_steps
    logits_bound = CAPTION_WITNESS_FACTOR * float(np.median([w["logits0"] for w in witnesses]))
    rows = sum(len(i) for i in kern["ids"])
    log(f"[{tag}] the all-plain Q-Former on the kernel run's rows: queries max_abs "
        f"{own['queries']:.3e}, projected {own['proj']:.3e}; the all-plain LLM on the kernel "
        f"run's projected rows: logits max_abs {plain['llm']:.3e} (bounds {VQA_BOUNDS}); the "
        "free-running all-plain run: "
        + ", ".join(f"{k} max_abs {v[0]:.3e} mean_abs {v[1]:.3e}" for k, v in readings.items())
        + f"; the kernel run's projected rows' difference has RMS "
        f"{[float(f'{x:.3e}') for x in plain['noise_rms']]}; the witnesses: "
        + "; ".join(f"{w['kind']} (seed {w['seed']}): prefill logits max_abs "
                    f"{w['logits0']:.3e}, step logits max_abs {w['steps']:.3e} (the kernel "
                    f"run's / this {plain['steps'] / max(w['steps'], 1e-30):.3f}), rows whose ids differ "
                    f"{len(w['flips'])} of {rows} {w['flips']}" for w in witnesses)
        + f"; the kernel run's step logits max_abs {plain['steps']:.3e} (bound "
        f"{CAPTION_WITNESS_FACTOR} x the witnesses' median, {steps_bound:.3e}; the prefill "
        f"logits' {logits_bound:.3e}{', held' if large else ', reported'}), rows whose answers "
        f"differ {len(plain['flips'])} of {rows}: {plain['flips']}; all-plain (recorded) "
        f"total {plain['seconds']:.2f} s, seconds by stage "
        + ", ".join(f"{k} {plain['stats'][k]:.3f}" for k in stages)
        + f"; metrics {'equal' if plain['metrics'] == metrics else plain['metrics']}; the "
        f"recorded kernel run's {'equal the clean run' if kern_metrics == metrics else kern_metrics}")
    checks = {"frozen": readings["frozen"], "queries": own["queries"], "proj": own["proj"],
              "llm": plain["llm"], "steps": plain["steps"]}
    bounds = dict(VQA_BOUNDS, steps=steps_bound)
    if large:  # the prefill's logits by the witnesses too
        checks["logits"], bounds["logits"] = readings["logits0"][0], logits_bound
    past = {k: v for k, v in checks.items() if not np.all(np.asarray(v) <= np.asarray(bounds[k]))}
    if past:
        raise RuntimeError(f"{tag}: the kernel run against the all-plain run past {bounds}: "
                           f"{past}")
    if any(np.isnan(f[3]) for f in plain["flips"]):
        raise RuntimeError(f"{tag}: answers differ where the steps do not show it: "
                           f"{plain['flips']}")
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, kept[k])
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"metrics": metrics, "stage_seconds": {k: stats[k] for k in stages},
            "decode_steps": stats["decode_steps"], "ms_per_token": ms_token, "total_s": total_s,
            "peak_memory_gib": peak, "launches": launches,
            "plain_stage_seconds": {k: plain["stats"][k] for k in stages},
            "own_rows": own, "against_plain": {k: list(v) for k, v in readings.items()},
            "llm_max_abs": plain["llm"], "step_logits_max_abs": plain["steps"],
            "answers_differ": plain["flips"],
            "noise_rms": plain["noise_rms"],
            "witnesses": [{"kind": w["kind"], "seed": w["seed"], "logits0_max_abs": w["logits0"],
                           "step_logits_max_abs": w["steps"], "ids_differ": w["flips"]}
                          for w in witnesses],
            "decode_step": decode, "build_s": build_s,
            **({"recompute_s": recompute[0], "recompute_step_logits_max_abs": recompute[1],
                "recompute_ids_differ": recompute[2]} if recompute else {}),
            "seconds": seconds}


# phase 14, the LLaMA heads (models/instruct_cir.py over models/llama.py): one
# Vicuna-7B on the card at a time, random weights from seed 0 (the vicuna7b rows:
# EVA ViT-g bf16 at 224 px, the BERT-base Q-Former with 32 queries, Vicuna-7B in
# fp32: hidden 4096, 32 layers, 32 heads of 128, FFN 11008, vocabulary 32001).
# 14a, blip2_vicuna_instruct: a seeded gallery of INSTRUCT_GALLERY images encoded
# in batches of INSTRUCT_BATCH (extract_target_features), INSTRUCT_QUERIES
# composed queries in batches of INSTRUCT_BATCH through inference (the BERT text
# at the row's max_txt_len of 128, the LLaMA ids 8 to 32 long with bos and eos,
# right-padded, from a whitespace tokenizer), then INSTRUCT_STEPS ITC steps at
# INSTRUCT_TRAIN_BATCH; 14b, blip2_instruct_cir: instruct_generate over
# INSTRUCT_QUERIES prompts (max_new_tokens INSTRUCT_NEW_TOKENS, KV-cached), the
# recompute path on INSTRUCT_UNCACHED rows and tokens, then INSTRUCT_STEPS LM-loss
# steps at INSTRUCT_TRAIN_BATCH
INSTRUCT = {"retrieval": ("blip2_vicuna_instruct", "vicuna7b"),
            "generate": ("blip2_instruct_cir", "vicuna7b")}
INSTRUCT_GALLERY, INSTRUCT_BATCH, INSTRUCT_QUERIES = 64, 16, 32
INSTRUCT_LLM_LENGTHS = (8, 32)  # a LLaMA prompt's ids, bos and eos included; padded to 32
INSTRUCT_NEW_TOKENS = 15  # cut for the run's time limit
INSTRUCT_UNCACHED = (4, 8)
INSTRUCT_TRAIN_BATCH, INSTRUCT_STEPS = 8, 3
LLAMA_IDS = {"pad": 0, "eos": 2, "bos": 1}  # LLaMA's tokenizer convention
# an image batch: the tower's 39 blocks; a Q-Former pass: its 12 layers (the
# gallery's queries-only pass, a query batch's fusion pass); the chains' own
# kernels (the bf16 tower's, K3's fp32 ones) launch too, nothing else does. A
# training step: the frozen tower's bf16 chain once (a call of 2B images for the
# retrieval model), no K3 (the Q-Former trains unfused), the LLaMA torch.matmul
INSTRUCT_BATCH_LAUNCHES = {"fused_vit_block": 39, "fused_qformer_layer": 12}
INSTRUCT_STEP_LAUNCHES = STAGE2_STEP_LAUNCHES["t5"]
# Bounds, fixed before the first reading. "frozen": the kernel run's rows after
# ln_vision (gallery and references) against the all-plain run's, and "target":
# the gallery features (the mean query output, normalised), phase 5's bf16 EVA
# bounds (EVA_BOUNDS); "queries": the all-plain Q-Former on the kernel run's rows
# against the kernel run's query rows (K3's 12-layer fp32 chain: phase 12's
# bound, which also holds the fusion pass here; K3's chain is held stage by stage
# at STAGE_BOUNDS besides); "llm": the all-plain LLaMA on the kernel run's query
# rows against the kernel run's reference features / prefill logits (no kernel:
# to the bit). The reference features, the scores and every decode step's logits
# of the free-running all-plain run take the bf16 tower's difference through
# the Q-Former and a random 7B LLaMA, which may move it as far as FlanT5-XL
# moved its own (PERF.md §6, PR 16): they are held at CAPTION_WITNESS_FACTOR
# times the median of the witnesses (VQA_WITNESS: the all-plain run's query
# rows moved by another row's difference), as phase 13's VQA holds its steps;
# the witness's scores take the kernel run's gallery features, so they carry the
# kernel run's gallery difference too. The recompute loop against the cached
# decode (the same kernels, the same rows; a wrong cache slot or position moves
# a logit by about its own size, 1): INSTRUCT_RECOMPUTE_LOGITS. Training: the
# steps from the kernel tower's rows at STAGE2_BOUNDS["rows"]; from the pixels
# by the witnesses (STAGE2_WITNESS), as 13b holds FlanT5-XL: the same random
# LLM behind a bf16 tower.
INSTRUCT_BOUNDS = {"frozen": EVA_BOUNDS["frozen"], "target": EVA_BOUNDS["target"],
                   "queries": CAPTION_BOUNDS["queries"], "llm": CAPTION_BOUNDS["llm"]}
INSTRUCT_RECOMPUTE_LOGITS = 1e-3

# phase 25, the largest rows at full width, one model on the card at a time
# (random weights from seed 0; the rows of loader.py): 25a, cli/evaluate.py on
# eval/caption_coco_opt6.7b_eval.yaml (EVA ViT-g fp32 at 364 px, OPT-6.7b fp32)
# over LARGE_ITEMS images, one batch, max_len 30; 25b, cli/evaluate.py on
# eval/gqa_zeroshot_flant5xl_eval.yaml with model.model_type=pretrain_flant5xxl
# (EVA bf16 at 224 px, FlanT5-XXL fp32) over LARGE_ITEMS questions, one batch,
# max_len 10; 25c, phase 14a's retrieval path with blip2_vicuna_instruct /
# vicuna13b (Vicuna-13B fp32) over a LARGE_GALLERY-image gallery in batches of
# INSTRUCT_BATCH and LARGE_ITEMS composed queries, no training step. The tower
# and the Q-Former are phases 12a's, 13d's and 14a's modules at their widths, so
# their bounds and launch counts hold unchanged (CAPTION_*, VQA_*, INSTRUCT_*).
# What the LLM moves (the prefill's logits, every decode step's logits and ids,
# 25c's reference features and scores) is held at CAPTION_WITNESS_FACTOR times
# the median of VQA_WITNESS's three draws, read in the same run. The recompute
# loop runs on every row of the first batch, so that the tower and the Q-Former
# run at the cached run's shapes and hand the LLM the same bits (on 4 of the 16
# rows the bf16 tower's products took other tiles, and FlanT5-XXL moved its
# logits by up to 2.774 from the first token on: NVIDIA H100 80GB HBM3,
# 700.00 W), for its first LARGE_RECOMPUTE_TOKENS tokens (the time limit), and
# is held as phase 12 holds it: at RECOMPUTE_SPREAD_FRACTION of the cached
# logits' spread, and 25a at the OPT head's logits bound too. 25b has no
# logits bound of its own: phase 12's FlanT5 bound, 2e-2 (4 x FlanT5-XL's
# 3.47e-4 at 30 tokens), is FlanT5-XL's and not FlanT5-XXL's
LARGE_ITEMS, LARGE_GALLERY, LARGE_RECOMPUTE_TOKENS = 16, 32, 8
LARGE_CAPTION = "eval/caption_coco_opt6.7b_eval.yaml"
LARGE_VQA_TYPE = "pretrain_flant5xxl"
LARGE_INSTRUCT_TYPE = "vicuna13b"


def _instruct_texts(rng, n, lengths=INSTRUCT_LLM_LENGTHS):
    """``n`` instructions over STAGE1_WORDS whose LLaMA ids (a word each, bos
    and eos) run from ``lengths[0]`` to ``lengths[1]``."""
    return [" ".join(str(w) for w in rng.choice(STAGE1_WORDS, int(k)))
            for k in rng.integers(lengths[0] - 2, lengths[1] - 1, n)]


def _tokens(tok, texts, max_length):
    enc = tok(texts, max_length=max_length)
    return [torch.from_numpy(np.asarray(enc[k])).to(DEVICE) for k in ("input_ids",
                                                                        "attention_mask")]


def _instruct_tokenizers(work, model):
    """(the BERT tokenizer over the synthetic vocab, the whitespace LLaMA
    tokenizer over the model's vocabulary)."""
    from sprc_tpu_torch.text.llm_tokenizers import WhitespaceTokenizer
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    bert = BertWordPieceTokenizer.from_vocab_file(
        write_synthetic_bert_vocab(os.path.join(work, "vocab.txt")))
    llama = WhitespaceTokenizer(vocab_size=model.llama_config.vocab_size - 4,
                                pad_id=LLAMA_IDS["pad"], eos_id=LLAMA_IDS["eos"],
                                bos_id=LLAMA_IDS["bos"])
    return bert, llama


def _pixels(n, batch, seed):
    return [torch.from_numpy(x).to(DEVICE) for _, x in _gallery_batches(n, batch, 224, seed)]


def _check_launches(tag, launches, want, chain):
    bad = {k: launches[k] for k in want if launches[k] != want[k]}
    bad.update({k: launches[k] for k in chain if launches[k] <= 0})
    bad.update({k: v for k, v in launches.items() if k not in want and k not in chain and v != 0})
    if bad:
        raise RuntimeError(f"{tag}: launches {bad}, expected {want} and the chains' {chain}")


def _stage_rows(tag, what, fn):
    """``fn()`` once more through the kernels, every stage against its plain
    version on the same inputs (kernel_checks.STAGE_BOUNDS); the launches are
    not the main path's (the counters are put back)."""
    from sprc_tpu_torch import kernel_checks
    from sprc_tpu_torch.ops import primitives

    counters = _counters()
    kept = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    stages = kernel_checks.StageRecorder()
    with torch.inference_mode(), primitives.stage_check(stages):
        fn()
    sync()
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, kept[k])
    for row in stages.rows():
        log(f"[{tag}] {what}, stage by stage: {row['kind']}: {row['calls']} calls, worst share "
            f"that differs {row['differ']:.3e}, worst difference {row['err']:.3e} -> "
            f"{'ok' if row['ok'] else 'FAIL'}")
    if not stages.ok():
        raise RuntimeError(f"{tag} {what}: a stage disagrees with its plain version: "
                           f"{[r['kind'] for r in stages.rows() if not r['ok']]}")
    return stages.rows()


def _max_mean(got, want):
    d = [(a.float() - b.float()).abs() for a, b in zip(got, want)]
    return (max(x.max().item() for x in d), float(np.mean([x.mean().item() for x in d])))


def _instruct_train(tag, model, batches):
    """INSTRUCT_STEPS steps of ``model``'s training forward at
    INSTRUCT_TRAIN_BATCH through GenericTrainer and models.instruct_cir.
    InstructAdapter (the frozen partition by FROZEN_PREFIXES): ms a step,
    samples/s, the peak, the launches a step (INSTRUCT_STEP_LAUNCHES);
    every frozen tensor bit for bit unchanged after these and the comparison
    steps, the projections and the Q-Former moved; the steps again from the
    same start through the kernels (the tower's rows recorded) against the
    all-plain steps from those rows (STAGE2_BOUNDS["rows"]), and the kernel
    run's first step against the all-plain step from the pixels, held by the
    witnesses (STAGE2_WITNESS), as phase 13 holds its steps."""
    from sprc_tpu_torch import kernel_checks
    from sprc_tpu_torch.models.instruct_cir import InstructAdapter
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.train.generic import GenericTrainer
    from sprc_tpu_torch.train.loop import TrainConfig

    counters = _counters()

    def read():
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    params = dict(model.named_parameters())
    names = [n for n, p in params.items() if p.requires_grad]
    frozen = [n for n in params if n.startswith(model.FROZEN_PREFIXES)]
    start = {n: params[n].detach().clone() for n in names}
    digest = _bits_digest(params[n] for n in frozen)
    tcfg = TrainConfig(total_steps=len(batches))
    trainer = GenericTrainer(model, tcfg, seed=SEED, adapter=InstructAdapter())
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    times, per_step, steps = [], [], []
    for b in batches:
        before = read()
        t0 = time.perf_counter()
        steps.append(trainer.train_step(b))  # ends in a host read of the losses
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: v - before[k] for k, v in read().items()})
    launches = read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = float(np.median(times))
    B = INSTRUCT_TRAIN_BATCH
    moved = {p: sum(not torch.equal(params[n], start[n]) for n in names if n.startswith(p))
             for p in ("llm_proj.", "l2q_proj.", "Qformer.", "query_tokens")
             if any(n.startswith(p) for n in names)}
    after = {n: params[n].detach().clone() for n in names}
    log(f"[{tag}] {len(steps)} steps at batch {B}: ms " + ", ".join(f"{t:.1f}" for t in times)
        + f"; samples/s (median step) {B / step_ms * 1e3:.1f}; peak {peak:.2f} GiB; losses "
        + ", ".join(f"{s['loss']:.4f}" for s in steps) + f"; {sum(start[n].numel() for n in names)
        / 1e6:.1f} M trainable of {sum(p.numel() for p in params.values()) / 1e9:.3f} G; moved "
        f"tensors by prefix {moved}; launches {({k: v for k, v in launches.items() if v})}, a "
        f"step {[{k: v for k, v in d.items() if v} for d in per_step]}")
    if not all(np.isfinite(s["loss"]) for s in steps):
        raise RuntimeError(f"{tag}: a loss is not finite: {steps}")
    for launch in per_step:
        bad = {k: v for k, v in launch.items() if v != INSTRUCT_STEP_LAUNCHES.get(k, 0)}
        if bad:
            raise RuntimeError(f"{tag}: a step's launches {bad}, expected {INSTRUCT_STEP_LAUNCHES}")
    if peak >= 80.0 or not all(v > 0 for v in moved.values()):
        raise RuntimeError(f"{tag}: peak {peak:.2f} GiB, moved {moved}")
    kept = read()

    def run(plain, rows=None, record=None, n_steps=len(batches)):
        with torch.no_grad():
            for n in names:
                params[n].copy_(start[n])
        tr = GenericTrainer(model, tcfg, seed=SEED, adapter=InstructAdapter())
        real_encode = model.encode_tower
        if rows is not None:
            feed = iter(rows)
            model.encode_tower = lambda images: next(feed)
        elif record is not None:
            model.encode_tower = lambda images: record.append(real_encode(images)) or record[-1]
        losses, first = [], None
        try:
            with primitives.plain_reference() if plain else contextlib.nullcontext():
                for b in batches[:n_steps]:
                    total, _, grads = tr.loss_and_grads(b)
                    first = grads if first is None else first
                    tr.apply_gradients(grads)
                    losses.append(total.item())
        finally:
            model.__dict__.pop("encode_tower", None)
        return losses, first, {n: p.detach().clone() for n, p in zip(tr.names, tr.params)}

    rows = []
    k_losses, k_grads, k_params = run(False, record=rows)
    r_losses, r_grads, r_params = run(True, rows=rows)
    l_losses, l_grads, _ = run(True, n_steps=1)
    with torch.no_grad(), primitives.plain_reference():
        first = batches[0]
        pixels = torch.cat([first["reference"], first["target"]]) if "target" in first else \
            first["images"]
        plain_rows = model.encode_tower(pixels)
    frozen_gap = _max_mean([model.ln_vision(rows[0].float())],
                           [model.ln_vision(plain_rows.float())])
    rows_rms = (rows[0].float() - plain_rows.float()).pow(2).mean().sqrt().item()
    witnesses = []
    for kind, seed in STAGE2_WITNESS:
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        w_losses, w_grads, _ = run(True, rows=[_witness_rows(plain_rows, rows[0], kind, gen)],
                                   n_steps=1)
        witnesses.append({"kind": kind, "seed": seed,
                          "loss": abs(w_losses[0] - l_losses[0]) / abs(l_losses[0]),
                          "grad": kernel_checks.grad_gap(w_grads, l_grads, names)["gap"]})
        del w_grads
    del rows, plain_rows
    gaps = {"rows": {"loss": max(abs(a - b) / abs(b) for a, b in zip(k_losses, r_losses)),
                     "grad": kernel_checks.grad_gap(k_grads, r_grads, names),
                     "params": max((k_params[n] - r_params[n]).abs().max().item()
                                   for n in names)},
            "live": {"loss": abs(k_losses[0] - l_losses[0]) / abs(l_losses[0]),
                     "grad": kernel_checks.grad_gap(k_grads, l_grads, names)}}
    rerun = {"loss": max(abs(a - s["loss"]) for a, s in zip(k_losses, steps)),
             "params": max((k_params[n] - after[n]).abs().max().item() for n in names)}
    with torch.no_grad():
        for n in names:
            params[n].copy_(start[n])
    unchanged = _bits_digest(params[n] for n in frozen) == digest
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, kept[k])
    bounds = STAGE2_BOUNDS["rows"]
    live_bound = {k: CAPTION_WITNESS_FACTOR * float(np.median([w[k] for w in witnesses]))
                  for k in ("loss", "grad")}
    log(f"[{tag}] the kernel steps against the all-plain steps from the kernel tower's rows: "
        f"losses {gaps['rows']['loss']:.3e} (bound {bounds['loss']:.0e}), the first step's "
        f"gradients {gaps['rows']['grad']['gap']:.3e} (bound {bounds['grad']:.0e}; worst "
        f"{gaps['rows']['grad']['worst']}), the parameters after {len(batches)} steps "
        f"{gaps['rows']['params']:.3e} (bound {bounds['params']:.0e}); the kernel tower's rows "
        f"after ln_vision against the plain tower's (batch 0): max_abs {frozen_gap[0]:.3e} "
        f"mean_abs {frozen_gap[1]:.3e} (bound {INSTRUCT_BOUNDS['frozen']}), their RMS "
        f"difference {rows_rms:.3e}; the all-plain step from the pixels: loss "
        f"{gaps['live']['loss']:.3e}, gradients {gaps['live']['grad']['gap']:.3e} (worst "
        f"{gaps['live']['grad']['worst']}; bounds {live_bound}, {CAPTION_WITNESS_FACTOR} x the "
        f"witnesses' median; phase 7's live bounds {TRAIN_BOUNDS['live']}); the witnesses: "
        + "; ".join(f"{w['kind']} (seed {w['seed']}): loss {w['loss']:.3e} (the kernel run's / "
                    f"this {gaps['live']['loss'] / max(w['loss'], 1e-30):.3f}), gradients "
                    f"{w['grad']:.3e} (the kernel run's / this "
                    f"{gaps['live']['grad']['gap'] / max(w['grad'], 1e-30):.3f})"
                    for w in witnesses)
        + f"; these kernel steps against the main path's: losses {rerun['loss']:.3e}, "
        f"parameters {rerun['params']:.3e}; {len(frozen)} frozen tensors unchanged by "
        f"{3 * len(batches) + 1 + len(witnesses)} steps: {unchanged}")
    if (gaps["rows"]["loss"] > bounds["loss"] or gaps["rows"]["grad"]["gap"] > bounds["grad"]
            or gaps["rows"]["params"] > bounds["params"]):
        raise RuntimeError(f"{tag}: the kernel steps beyond STAGE2_BOUNDS['rows']: {gaps['rows']}")
    if not (gaps["live"]["loss"] <= live_bound["loss"]
            and gaps["live"]["grad"]["gap"] <= live_bound["grad"]):
        raise RuntimeError(f"{tag}: the kernel step against the all-plain step from the pixels: "
                           f"loss {gaps['live']['loss']}, gradients "
                           f"{gaps['live']['grad']['gap']}, bounds {live_bound}")
    fb = INSTRUCT_BOUNDS["frozen"]
    if not (frozen_gap[0] <= fb[0] and frozen_gap[1] <= fb[1]):
        raise RuntimeError(f"{tag}: the tower's rows against plain: {frozen_gap}, bound {fb}")
    if not unchanged:
        raise RuntimeError(f"{tag}: a frozen tensor changed in the training steps")
    del k_grads, r_grads, l_grads, k_params, r_params, start, after
    return {"step_ms": times, "samples_per_s": B / step_ms * 1e3, "peak_memory_gib": peak,
            "losses": [s["loss"] for s in steps], "launches": launches,
            "launches_step": per_step, "frozen_tensors": len(frozen), "moved": moved,
            "gaps": {"rows": {"loss": gaps["rows"]["loss"], "grad": gaps["rows"]["grad"]["gap"],
                              "params": gaps["rows"]["params"]},
                     "live": {"loss": gaps["live"]["loss"], "grad": gaps["live"]["grad"]["gap"],
                              "bounds": live_bound},
                     "frozen_rows": frozen_gap, "rows_rms": rows_rms, "witnesses": witnesses},
            "rerun_against_main": rerun}


def phase_instruct_retrieval(work, large=False):
    """14a: blip2_vicuna_instruct / vicuna7b retrieves and trains (phase 14 of
    the docstring); with ``large``, 25c: the row LARGE_INSTRUCT_TYPE retrieves
    over LARGE_GALLERY images with LARGE_ITEMS queries, and does not train."""
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.ops import primitives

    name, model_type = INSTRUCT["retrieval"]
    n_gallery, n_queries = INSTRUCT_GALLERY, INSTRUCT_QUERIES
    if large:
        model_type, n_gallery, n_queries = LARGE_INSTRUCT_TYPE, LARGE_GALLERY, LARGE_ITEMS
    tag = "instruct retrieval" + (" 25c" if large else "")
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    model = load_model(name, model_type, device=DEVICE, seed=SEED)
    sync()
    load_s = time.perf_counter() - t0
    bert, llama = _instruct_tokenizers(work, model)
    rng = np.random.default_rng(SEED + 141)
    gallery = _pixels(n_gallery, INSTRUCT_BATCH, SEED + 142)
    refs = _pixels(n_queries, INSTRUCT_BATCH, SEED + 143)
    texts = _instruct_texts(rng, n_queries)
    queries = [_tokens(bert, texts[s:s + INSTRUCT_BATCH], model.cfg.max_txt_len)
               + _tokens(llama, texts[s:s + INSTRUCT_BATCH], INSTRUCT_LLM_LENGTHS[1])
               for s in range(0, n_queries, INSTRUCT_BATCH)]
    lengths = torch.cat([q[3].sum(1) for q in queries]).tolist()
    log(f"[{tag}] {name} / {model_type}: built and drawn in {load_s:.1f} s; "
        f"{sum(p.numel() for p in model.llm_model.parameters()) / 1e9:.3f} G LLaMA values "
        f"({model.llama_config.dtype}), BERT text {queries[0][0].shape[1]} wide, LLaMA ids "
        f"{min(lengths)} to {max(lengths)} long")

    # the main path: the gallery, then the composed queries; timed and counted
    counters = _counters()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    with torch.inference_mode():
        feats = torch.cat([model.extract_target_features(g, stats)[0] for g in gallery])
        scores = torch.cat([model.inference(model.encode_image(r, stats), feats, *q, stats=stats)
                            for r, q in zip(refs, queries)])
    sync()
    total_s = time.perf_counter() - t0
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    batches = len(gallery) + len(refs)
    stages = ("image_encode_s", "qformer_s", "llm_s")
    top1 = scores.argmax(dim=1).tolist()
    log(f"[{tag}] {len(gallery)} gallery and {len(refs)} query batches of {INSTRUCT_BATCH}: "
        "seconds by stage " + ", ".join(f"{k} {stats[k]:.3f}" for k in stages)
        + f"; total {total_s:.2f} s; peak {peak:.2f} GiB; scores {list(scores.shape)}, top-1 "
        f"{top1[:8]}...")
    log(f"[{tag}] launches: {launches}")
    _check_launches(tag, launches, {k: v * batches for k, v in INSTRUCT_BATCH_LAUNCHES.items()},
                    VQA_CHAIN)
    if scores.shape != (n_queries, n_gallery) or not bool(
            torch.isfinite(scores).all()) or peak >= 80.0:
        raise RuntimeError(f"{tag}: scores {list(scores.shape)}, peak {peak:.2f} GiB")

    # K3's chain (and the tower's) stage by stage: a gallery and a query batch
    stage_rows = _stage_rows(tag, "a gallery and a query batch", lambda: model.inference(
        model.encode_image(refs[0]), model.extract_target_features(gallery[0])[0], *queries[0]))

    # recorded runs (none of these launches is the main path's): the kernel run,
    # the all-plain run, the all-plain query side on the kernel run's rows, and
    # the witnesses
    kept = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    def recorded(plain, query_rows=None, target=None):
        rec = {"frozen": [], "feats": [], "rows": [], "queries": [], "ref": []}
        with torch.inference_mode(), (primitives.plain_reference() if plain
                                      else contextlib.nullcontext()):
            if target is None:
                for g in gallery:
                    f, fr = model.extract_target_features(g)
                    rec["feats"].append(f)
                    rec["frozen"].append(fr)
                target = torch.cat(rec["feats"])
            for i, (r, q) in enumerate(zip(refs, queries)):
                if query_rows is None:
                    rec["rows"].append(model.encode_image(r))
                    rec["queries"].append(model._query_fusion(rec["rows"][-1], q[0], q[1]))
                rec["ref"].append(model._ref_feature(
                    rec["queries"][i] if query_rows is None else query_rows[i], q[2], q[3]))
            rec["scores"] = torch.cat(rec["ref"]).float() @ target.float().t()
        return rec

    kern = recorded(False)
    plain = recorded(True)
    with torch.inference_mode(), primitives.plain_reference():
        own_q = [model._query_fusion(rows, q[0], q[1]) for rows, q in zip(kern["rows"], queries)]
    own_llm = recorded(True, query_rows=kern["queries"], target=torch.cat(kern["feats"]))
    witnesses = []
    for kind, seed in VQA_WITNESS:
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        moved = [_witness_rows(p, k, kind, gen) for p, k in zip(plain["queries"],
                                                                 kern["queries"])]
        w = recorded(True, query_rows=moved, target=torch.cat(kern["feats"]))
        witnesses.append({"kind": kind, "seed": seed,
                          "ref": _max_mean(w["ref"], plain["ref"])[0],
                          "score": (w["scores"] - plain["scores"]).abs().max().item()})
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, kept[k])
    readings = {"frozen": _max_mean(kern["frozen"] + kern["rows"], plain["frozen"] + plain["rows"]),
                "target": _max_mean(kern["feats"], plain["feats"]),
                "queries": _max_mean(own_q, kern["queries"])[0],
                "llm": max(_max_mean(own_llm["ref"], kern["ref"])[0],
                           (own_llm["scores"] - kern["scores"]).abs().max().item()),
                "ref": _max_mean(kern["ref"], plain["ref"])[0],
                "score": (kern["scores"] - plain["scores"]).abs().max().item(),
                "clean": (kern["scores"] - scores.float()).abs().max().item()}
    bounds = dict(INSTRUCT_BOUNDS, **{k: CAPTION_WITNESS_FACTOR * float(np.median(
        [w[k] for w in witnesses])) for k in ("ref", "score")})
    same_top1 = sum(a == b for a, b in zip(top1, plain["scores"].argmax(dim=1).tolist()))
    noise_rms = [(k - p).pow(2).mean().sqrt().item() for k, p in zip(kern["queries"],
                                                                   plain["queries"])]
    log(f"[{tag}] the kernel run against the all-plain run: frozen rows max_abs "
        f"{readings['frozen'][0]:.3e} mean_abs {readings['frozen'][1]:.3e}, gallery features "
        f"{readings['target'][0]:.3e} / {readings['target'][1]:.3e}; the all-plain Q-Former on "
        f"the kernel run's rows: query rows {readings['queries']:.3e}; the all-plain LLaMA on the "
        f"kernel run's query rows: reference features and scores {readings['llm']:.3e}; the "
        f"free-running all-plain run: reference features {readings['ref']:.3e}, scores "
        f"{readings['score']:.3e} (its top-1 equal for {same_top1} of {len(top1)} queries); "
        f"the query rows' difference has RMS "
        f"{[float(f'{x:.3e}') for x in noise_rms]}; the witnesses: "
        + "; ".join(f"{w['kind']} (seed {w['seed']}): reference features {w['ref']:.3e} (the "
                    f"kernel run's / this {readings['ref'] / max(w['ref'], 1e-30):.3f}), scores "
                    f"{w['score']:.3e} ({readings['score'] / max(w['score'], 1e-30):.3f})"
                    for w in witnesses)
        + f"; bounds {bounds}; the recorded kernel run's scores against the clean run's "
        f"{readings['clean']:.3e}")
    past = {k: readings[k] for k in bounds
            if not np.all(np.asarray(readings[k]) <= np.asarray(bounds[k]))}
    if past:
        raise RuntimeError(f"{tag}: the kernel run against the all-plain run past {bounds}: "
                           f"{past}")
    del kern, plain, own_q, own_llm, feats, scores, gallery, refs
    gc.collect()
    torch.cuda.empty_cache()
    train = None
    if not large:  # 14a's training: INSTRUCT_STEPS ITC steps at INSTRUCT_TRAIN_BATCH
        train_texts = _instruct_texts(rng, INSTRUCT_STEPS * INSTRUCT_TRAIN_BATCH)
        pix = _pixels(2 * INSTRUCT_STEPS * INSTRUCT_TRAIN_BATCH, INSTRUCT_TRAIN_BATCH, SEED + 144)
        train_batches = []
        for s in range(INSTRUCT_STEPS):
            chunk = train_texts[s * INSTRUCT_TRAIN_BATCH:(s + 1) * INSTRUCT_TRAIN_BATCH]
            ids, mask = _tokens(bert, chunk, model.cfg.max_txt_len)
            llm_ids, llm_mask = _tokens(llama, chunk, INSTRUCT_LLM_LENGTHS[1])
            train_batches.append({"reference": pix[2 * s], "target": pix[2 * s + 1],
                                  "input_ids": ids, "text_mask": mask, "llm_input_ids": llm_ids,
                                  "llm_mask": llm_mask})
        train = _instruct_train(f"{tag} train", model, train_batches)
        del train_batches, pix
    del model
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"stage_seconds": {k: stats[k] for k in stages}, "total_s": total_s,
            "peak_memory_gib": peak, "launches": launches, "stages": stage_rows,
            "against_plain": readings, "bounds": bounds, "witnesses": witnesses,
            "train": train, "load_s": load_s, "seconds": seconds}


@contextlib.contextmanager
def _recording_instruct(model, rec, query_rows=None):
    """Record what instruct_generate computes on its way to the ids, batch by
    batch: the rows after ln_vision, the Q-Former's query rows (or hand it
    ``query_rows`` in their place), the prefill's logits, every decode step's
    logits [B, steps, V] and the ids; and the first batch's decode step with
    its cache."""
    from sprc_tpu_torch.models import generation

    real_encode, real_fusion = model.encode_image, model._query_fusion
    real_loop = generation.cached_greedy_loop
    feed = None if query_rows is None else iter(query_rows)
    for key in ("frozen", "queries", "logits0", "steps", "ids"):
        rec[key] = []

    def encode_image(images, stats=None):
        rec["frozen"].append(real_encode(images, stats))
        return rec["frozen"][-1]

    def query_fusion(image_embeds, input_ids, text_mask, generator=None, stats=None):
        out = real_fusion(image_embeds, input_ids, text_mask, generator, stats) if feed is None \
            else next(feed)
        rec["queries"].append(out)
        return out

    def loop(logits0, cache, pos0, step_fn, **kw):
        rec["logits0"].append(logits0.float())
        rec.setdefault("step", (step_fn, cache, pos0))
        steps = [logits0.float()]

        def step(tok, pos, c):
            logits, c = step_fn(tok, pos, c)
            steps.append(logits.float())
            return logits, c

        ids = real_loop(logits0, cache, pos0, step, **kw)
        rec["steps"].append(torch.stack(steps, dim=1))
        rec["ids"].append(ids)
        return ids

    model.encode_image, model._query_fusion = encode_image, query_fusion
    generation.cached_greedy_loop = loop
    try:
        yield rec
    finally:
        del model.encode_image, model._query_fusion
        generation.cached_greedy_loop = real_loop


def phase_instruct_generate(work):
    """14b: blip2_instruct_cir / vicuna7b generates and trains (phase 14 of
    the docstring)."""
    from sprc_tpu_torch import kernel_checks
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.models.instruct_cir import instruct_generate
    from sprc_tpu_torch.ops import primitives

    name, model_type = INSTRUCT["generate"]
    tag = "instruct generate"
    eos, pad = LLAMA_IDS["eos"], LLAMA_IDS["pad"]
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    model = load_model(name, model_type, device=DEVICE, seed=SEED)
    sync()
    load_s = time.perf_counter() - t0
    bert, llama = _instruct_tokenizers(work, model)
    rng = np.random.default_rng(SEED + 145)
    images = _pixels(INSTRUCT_QUERIES, INSTRUCT_BATCH, SEED + 146)
    texts = _instruct_texts(rng, INSTRUCT_QUERIES)
    prompts = [_tokens(bert, texts[s:s + INSTRUCT_BATCH], model.cfg.max_txt_len)
               + _tokens(llama, texts[s:s + INSTRUCT_BATCH], INSTRUCT_LLM_LENGTHS[1])
               for s in range(0, INSTRUCT_QUERIES, INSTRUCT_BATCH)]
    kw = dict(eos_token_id=eos, pad_token_id=pad, max_new_tokens=INSTRUCT_NEW_TOKENS)

    def generate(stats=None, **extra):
        return [instruct_generate(model, im, *p, stats=stats, **dict(kw, **extra))
                for im, p in zip(images, prompts)]

    # the main path: timed and counted, nothing recorded
    counters = _counters()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    with torch.inference_mode():
        ids = generate(stats)
    sync()
    total_s = time.perf_counter() - t0
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    stages = ("image_encode_s", "qformer_s", "prefill_s", "decode_s")
    ms_token = stats["decode_s"] / max(stats["decode_steps"], 1) * 1e3
    texts_out = [llama.decode(r) for r in torch.cat(ids).cpu().numpy()]
    log(f"[{tag}] {name} / {model_type}: built and drawn in {load_s:.1f} s; {len(images)} batches "
        f"of {INSTRUCT_BATCH}, BERT prompts {prompts[0][0].shape[1]} wide, LLaMA prompts "
        f"{min(int(p[3].sum(1).min()) for p in prompts)} to "
        f"{max(int(p[3].sum(1).max()) for p in prompts)} long: seconds by stage "
        + ", ".join(f"{k} {stats[k]:.3f}" for k in stages)
        + f"; {stats['decode_steps']} cached decode steps, {ms_token:.2f} ms a decoded token "
        f"({INSTRUCT_BATCH} rows); total {total_s:.2f} s; peak {peak:.2f} GiB; e.g. "
        f"{texts_out[0][:60]!r}")
    log(f"[{tag}] launches: {launches}")
    _check_launches(tag, launches, {k: v * len(images) for k, v in
                                    INSTRUCT_BATCH_LAUNCHES.items()}, VQA_CHAIN)
    if any(i.shape != (INSTRUCT_BATCH, INSTRUCT_NEW_TOKENS) for i in ids) or peak >= 80.0:
        raise RuntimeError(f"{tag}: ids {[list(i.shape) for i in ids]}, peak {peak:.2f} GiB")

    # the kernel route again, recorded; none of what follows is a main path's launch
    kept = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    stage_rows = _stage_rows(tag, "a generate batch's image encode and fusion pass",
                             lambda: model._query_fusion(model.encode_image(images[0]),
                                                         *prompts[0][:2]))
    kern = {}
    with _recording_instruct(model, kern), torch.inference_mode():
        generate()
    step_fn, cache, pos0 = kern.pop("step")
    tok0 = kern["ids"][0][:, 0]
    with torch.inference_mode():
        decode = kernel_checks.profile_decode_step(lambda: step_fn(tok0, pos0, cache))
    del step_fn, cache
    weight_bytes = sum(p.numel() * p.element_size() for n, p in
                       model.llm_model.named_parameters() if "embed_tokens" not in n)
    decode.update(weights_gb=weight_bytes / 1e9,
                  weights_ms=weight_bytes / kernel_checks.PEAK_BYTES * 1e3, loop_ms=ms_token)
    log(f"[{tag}] one cached decode step at batch {INSTRUCT_BATCH} (the first token's "
        f"position): host {decode['host_ms']:.3f} ms, device {decode['device_ms']:.3f} ms, busy "
        f"share {decode['busy_share']:.3f} (the graph's output against the step's: max_abs "
        f"{decode['graph_max_abs']:.3e}); {decode['aten_ops']} ATen operators a step "
        f"({decode['aten_views']} views), {decode['kernels_profiled']} launches seen by one "
        f"profile, {decode['kernel_ms_profiled']:.3f} ms of kernels, the most in (name, "
        f"launches, ms) {decode['top_kernels']}; the weights it reads "
        f"{decode['weights_gb']:.2f} GB, {decode['weights_ms']:.3f} ms at the card's memory "
        f"rate; the clean run's loop {ms_token:.2f} ms a token; the recorded run's ids "
        f"{'equal' if all(torch.equal(a, b) for a, b in zip(kern['ids'], ids)) else 'differ from'}"
        " the clean run's")

    # the recompute path against the cached one: INSTRUCT_UNCACHED rows and tokens
    rows_n, new_n = INSTRUCT_UNCACHED
    sub = [t[:rows_n] for t in prompts[0]]
    small = dict(kw, max_new_tokens=new_n)
    cached_steps, re_steps = {}, []
    real_logits = model.llm_model.logits

    def logged(hidden):
        out = real_logits(hidden)
        re_steps.append(out.reshape(out.shape[0], -1).float())
        return out

    t0 = time.perf_counter()
    with _recording_instruct(model, cached_steps), torch.inference_mode():
        cached = instruct_generate(model, images[0][:rows_n], *sub, **small)
    model.llm_model.logits = logged
    try:
        with torch.inference_mode():
            recomputed = instruct_generate(model, images[0][:rows_n], *sub, use_cache=False,
                                           **small)
    finally:
        del model.llm_model.logits
    sync()
    recompute_s = time.perf_counter() - t0
    re_worst, re_flips = _held_steps(recomputed, cached, torch.stack(re_steps, dim=1),
                                     cached_steps["steps"][0], eos)
    same = torch.equal(recomputed, cached)
    log(f"[{tag}] the recompute path on {rows_n} rows and {new_n} tokens (kernel route): "
        f"{recompute_s:.2f} s with its cached run; ids {'equal' if same else 'differ'}: "
        f"{recomputed.tolist()}; its step logits against the cached decode's, up to each row's "
        f"first differing id or eos: max_abs {re_worst:.3e} (bound "
        f"{INSTRUCT_RECOMPUTE_LOGITS}); rows whose ids differ (row, step, top-2 gap, "
        f"|difference| there): {re_flips}")
    if not re_worst <= INSTRUCT_RECOMPUTE_LOGITS or any(np.isnan(f[2]) for f in re_flips):
        raise RuntimeError(f"{tag}: the recompute path against the cached decode: {re_worst}, "
                           f"{re_flips}")
    del cached_steps, re_steps

    # the all-plain Q-Former and LLaMA on the kernel run's own rows; the
    # free-running all-plain run; the witnesses
    with torch.inference_mode(), primitives.plain_reference():
        own_q = [model._query_fusion(f, *p[:2]) for f, p in zip(kern["frozen"], prompts)]
    own = {}
    with _recording_instruct(model, own, query_rows=kern["queries"]), torch.inference_mode(), \
            primitives.plain_reference():
        generate()
    plain, plain_stats = {}, {}
    t0 = time.perf_counter()
    with _recording_instruct(model, plain), torch.inference_mode(), \
            primitives.plain_reference():
        generate(plain_stats)
    sync()
    plain_s = time.perf_counter() - t0
    plain.pop("step"), own.pop("step")

    def against_plain(run):
        held = [_held_steps(a, b, s, t, eos) for a, b, s, t in zip(
            run["ids"], plain["ids"], run["steps"], plain["steps"])]
        return (max(h[0] for h in held), [(b,) + f for b, h in enumerate(held) for f in h[1]],
                max((w - p).abs().max().item() for w, p in zip(run["logits0"],
                                                               plain["logits0"])))

    witnesses = []
    for kind, seed in VQA_WITNESS:
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        moved = [_witness_rows(p, k, kind, gen) for p, k in zip(plain["queries"],
                                                                 kern["queries"])]
        run = {}
        with _recording_instruct(model, run, query_rows=moved), torch.inference_mode(), \
                primitives.plain_reference():
            generate()
        run.pop("step")
        steps_d, flips, logits0_d = against_plain(run)
        witnesses.append({"kind": kind, "seed": seed, "logits0": logits0_d, "steps": steps_d,
                          "flips": flips})
        del run, moved
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, kept[k])
    steps_d, flips, logits0_d = against_plain(kern)
    readings = {"frozen": _max_mean(kern["frozen"], plain["frozen"]),
                "queries": _max_mean(own_q, kern["queries"])[0],
                "llm": _max_mean(own["logits0"], kern["logits0"])[0],
                "free queries": _max_mean(kern["queries"], plain["queries"]),
                "logits0": logits0_d, "steps": steps_d}
    witness_steps = float(np.median([w["steps"] for w in witnesses]))
    bounds = {"frozen": INSTRUCT_BOUNDS["frozen"], "queries": INSTRUCT_BOUNDS["queries"],
              "llm": INSTRUCT_BOUNDS["llm"], "steps": CAPTION_WITNESS_FACTOR * witness_steps}
    n_rows = sum(len(i) for i in kern["ids"])
    noise_rms = [(k - p).pow(2).mean().sqrt().item() for k, p in zip(kern["queries"],
                                                                   plain["queries"])]
    log(f"[{tag}] the kernel run against the all-plain run: frozen rows max_abs "
        f"{readings['frozen'][0]:.3e} mean_abs {readings['frozen'][1]:.3e}; the all-plain "
        f"Q-Former on the kernel run's rows: query rows {readings['queries']:.3e}; the all-plain "
        f"LLaMA on the kernel run's query rows: prefill logits {readings['llm']:.3e}; the "
        f"free-running all-plain run: query rows {readings['free queries'][0]:.3e}, prefill "
        f"logits {logits0_d:.3e}; the query rows' difference has RMS "
        f"{[float(f'{x:.3e}') for x in noise_rms]}; the witnesses: "
        + "; ".join(f"{w['kind']} (seed {w['seed']}): prefill logits {w['logits0']:.3e}, step "
                    f"logits {w['steps']:.3e} (the kernel run's / this "
                    f"{steps_d / max(w['steps'], 1e-30):.3f}), rows whose ids differ "
                    f"{len(w['flips'])} of {n_rows} {w['flips']}" for w in witnesses)
        + f"; the kernel run's step logits max_abs {steps_d:.3e} (bound "
        f"{CAPTION_WITNESS_FACTOR} x the witnesses' median, {bounds['steps']:.3e}), rows whose "
        f"ids differ {len(flips)} of {n_rows}: {flips}; all-plain (recorded) total "
        f"{plain_s:.2f} s, seconds by stage "
        + ", ".join(f"{k} {plain_stats[k]:.3f}" for k in stages))
    checks = {k: readings[k] for k in bounds}
    past = {k: v for k, v in checks.items() if not np.all(np.asarray(v) <= np.asarray(bounds[k]))}
    if past:
        raise RuntimeError(f"{tag}: the kernel run against the all-plain run past {bounds}: "
                           f"{past}")
    if any(np.isnan(f[3]) for f in flips):
        raise RuntimeError(f"{tag}: generated ids differ where the steps do not show it: {flips}")
    del kern, plain, own, own_q, ids
    gc.collect()
    torch.cuda.empty_cache()

    # 14b's training: INSTRUCT_STEPS LM-loss steps at INSTRUCT_TRAIN_BATCH over
    # [instruction | output] ids, the loss on the output span (and its eos)
    n = INSTRUCT_STEPS * INSTRUCT_TRAIN_BATCH
    instr = _instruct_texts(rng, n, (6, 18))
    outputs = _instruct_texts(rng, n, (4, 14))
    pix = _pixels(n, INSTRUCT_TRAIN_BATCH, SEED + 147)
    train_batches = []
    for s in range(INSTRUCT_STEPS):
        part = slice(s * INSTRUCT_TRAIN_BATCH, (s + 1) * INSTRUCT_TRAIN_BATCH)
        ids_, mask = _tokens(bert, instr[part], model.cfg.max_txt_len)
        full = [f"{a} {b}" for a, b in zip(instr[part], outputs[part])]
        llm_ids, llm_mask = _tokens(llama, full, INSTRUCT_LLM_LENGTHS[1])
        start = torch.tensor([1 + len(a.split()) for a in instr[part]], device=DEVICE)
        cols = torch.arange(llm_ids.shape[1], device=DEVICE)[None]
        target = ((cols >= start[:, None]) & llm_mask.bool()).long()
        train_batches.append({"images": pix[s], "input_ids": ids_, "text_mask": mask,
                              "llm_input_ids": llm_ids, "llm_mask": llm_mask,
                              "target_mask": target})
    train = _instruct_train(f"{tag} train", model, train_batches)
    del model, train_batches, pix
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"stage_seconds": {k: stats[k] for k in stages}, "decode_steps": stats["decode_steps"],
            "ms_per_token": ms_token, "total_s": total_s, "peak_memory_gib": peak,
            "launches": launches, "stages": stage_rows, "decode_step": decode,
            "plain_stage_seconds": {k: plain_stats[k] for k in stages},
            "against_plain": readings, "bounds": bounds, "ids_differ": flips,
            "noise_rms": noise_rms,
            "witnesses": [{"kind": w["kind"], "seed": w["seed"], "logits0_max_abs": w["logits0"],
                           "step_logits_max_abs": w["steps"], "ids_differ": w["flips"]}
                          for w in witnesses],
            "recompute_s": recompute_s, "recompute_ids_equal": same,
            "recompute_step_logits_max_abs": re_worst, "recompute_ids_differ": re_flips,
            "train": train, "load_s": load_s, "seconds": seconds}


# phase 15, PNP-VQA (models/pnp_vqa.py): cli/evaluate.py on eval/pnp_vqa_vqav2_eval.yaml
# (pnp_vqa / base: BLIP-1's ITM large and caption large_coco, each a ViT-L/16 at
# 384 px in bf16, S = 577, 24 blocks a call through K2; the 12-layer med-BERTs in
# fp32, unfused; the UnifiedQA-v2 t5-base FiD reader in fp32; random weights from
# run.seed, the synthetic BERT vocab, the reader's WhitespaceTokenizer) over
# PNP_QUESTIONS seeded questions on PNG images: 2 batches of 4, num_captions 50,
# num_patches 20, block_num 7, max_len 10, min_len 1, as the YAML says
PNP_RUN = "eval/pnp_vqa_vqav2_eval.yaml"
PNP_QUESTIONS = 8
# a batch: 24 K2 blocks in the ITM tower and 24 in the caption tower; the bf16
# chain's own kernels launch too; nothing else does (no K1, no K3: the med-BERTs
# and the T5 are torch.matmul, as the JAX package's are XLA)
PNP_BATCH_LAUNCHES = {"fused_vit_block": 48}
PNP_CHAIN = ("gemm", "attention_bf16", "layer_norm")
# Bounds, fixed before the first reading. "rows": each tower's rows (after BLIP's
# final LayerNorm) through the kernels against the all-plain tower's on the same
# pixels, max / mean |difference| (phase 5's bound for a bf16 tower of 39
# blocks; this one has 24 at S = 577). "own": the all-plain GradCAM over the
# kernel run's own ITM rows against the kernel run's maps, relative to their
# largest |value| (no kernel runs after the tower: equal but for the order of
# the library's sums). The GradCAM maps from the all-plain rows, and the caption
# decoder's logits over the same sampled ids and the same gathered patches of
# the all-plain caption rows, are held at CAPTION_WITNESS_FACTOR times the median
# of the witnesses' readings (the all-plain rows moved by another row's
# difference, PNP_WITNESS). The FiD answers from the kernel run's captions
# through the all-plain pipeline equal the kernel run's (the reader has no
# kernel). Sampled captions are not compared: they move with the tower's rounding.
PNP_BOUNDS = {"rows": EVA_BOUNDS["frozen"], "own": 1e-6}
PNP_WITNESS = [("shuffled", SEED + 150 + j) for j in range(3)]
PNP_STAGES = ("tower_s", "gradcam_s", "caption_sample_s", "fid_encode_s", "fid_decode_s")


@contextlib.contextmanager
def _recording_pnp(rec):
    """Record a pipeline's first batch (the first call of each): its pixels
    and questions, the ITM and caption towers' rows, the GradCAM maps (token
    average and full), the first round's patch indices and sampled ids, the
    captions and answers; and every call's (pipeline, pixels, questions,
    answers)."""
    from sprc_tpu_torch.models import blip1, pnp_vqa

    cls = pnp_vqa.PnpVqaPipeline
    real = {"predict": cls.predict_answers, "patches": pnp_vqa.sample_patches,
            "sample": pnp_vqa.sample_generate, "gradcam": pnp_vqa.compute_gradcam,
            "itm": blip1.BlipITM.encode_image, "cap": blip1.BlipCaption.encode_image}
    rec["calls"] = []

    def keep(key, value):
        rec.setdefault(key, value)
        return value

    def predict(self, images, questions, **kw):
        out = real["predict"](self, images, questions, **kw)
        rec["calls"].append((self, np.asarray(images), list(questions), out))
        return out

    inherited = "encode_image" not in vars(blip1.BlipITM)
    pnp_vqa.PnpVqaPipeline.predict_answers = predict
    pnp_vqa.sample_patches = lambda *a, **kw: keep("idx", real["patches"](*a, **kw))
    pnp_vqa.sample_generate = lambda *a, **kw: keep("ids", real["sample"](*a, **kw))
    pnp_vqa.compute_gradcam = lambda *a, **kw: keep("gradcam", real["gradcam"](*a, **kw))
    blip1.BlipITM.encode_image = lambda self, im: keep("itm_rows", real["itm"](self, im))
    blip1.BlipCaption.encode_image = lambda self, im: keep("cap_rows", real["cap"](self, im))
    try:
        yield rec
    finally:
        pnp_vqa.PnpVqaPipeline.predict_answers = real["predict"]
        pnp_vqa.sample_patches, pnp_vqa.sample_generate = real["patches"], real["sample"]
        pnp_vqa.compute_gradcam = real["gradcam"]
        blip1.BlipCaption.encode_image = real["cap"]
        if inherited:
            del blip1.BlipITM.encode_image
        else:
            blip1.BlipITM.encode_image = real["itm"]


def phase_pnp(work):
    """15: PNP-VQA answers through cli/evaluate.py (phase 15 of the docstring)."""
    import argparse

    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab
    from sprc_tpu_torch.utils.gradcam import compute_gradcam

    tag = "pnp_vqa"
    t_phase = time.perf_counter()
    root = os.path.join(work, "pnp_vqa")
    ann = _write_vqa(root, PNP_QUESTIONS, SEED + 150)
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    cfg, how = _run_config(PNP_RUN, {
        "run": {"seed": SEED},
        "datasets": {"coco_vqa": {"build_info": {"annotations": {"val": [ann]}, "images": root}}}})
    log(f"[{tag}] cli/evaluate.py through {how}")
    out_dir = os.path.join(work, "pnp_vqa_out")
    args = argparse.Namespace(device=DEVICE, model_path=None, vocab_path=vocab, split=None,
                              output_dir=out_dir)
    run = cfg.run
    settings = dict(num_captions=run["num_captions"], num_captions_fid=run["num_captions_fid"],
                    num_patches=run["num_patches"], block_num=run["block_num"],
                    max_len=run["max_len"], min_len=run["min_len"])

    # the clean run: timed and counted; only each batch's (pipeline, pixels,
    # questions, answers) is kept
    counters = _counters()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    stats, clean = {}, {}
    t0 = time.perf_counter()
    with _recording_pnp(clean):
        metrics = evaluate.evaluate(cfg, args, stats)
    sync()
    total_s = time.perf_counter() - t0
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(json.dumps({k: v for k, v in metrics.items() if isinstance(v, (int, float, str))}))
    with open(os.path.join(out_dir, "result", "val_vqa_result.json")) as f:
        result = json.load(f)
    batch = run["batch_size_eval"]
    batches = -(-PNP_QUESTIONS // batch)
    ms_token = stats["caption_sample_s"] / max(stats["caption_steps"], 1) * 1e3
    log(f"[{tag}] {batches} batches of {batch}: seconds by stage "
        + ", ".join(f"{k} {stats[k]:.3f}" for k in PNP_STAGES)
        + f"; {stats['caption_steps']} sampled steps of {batch * run['num_captions']} rows, "
        f"{ms_token:.2f} ms a sampled token; {stats['fid_steps']} FiD decode steps; total "
        f"{total_s:.2f} s; peak {peak:.2f} GiB; {len(result)} answers, e.g. "
        f"{[r['answer'][:30] for r in result[:3]]}")
    want = {k: v * batches for k, v in PNP_BATCH_LAUNCHES.items()}
    log(f"[{tag}] launches: {launches}")
    bad = {k: launches[k] for k in want if launches[k] != want[k]}
    bad.update({k: launches[k] for k in PNP_CHAIN if launches[k] <= 0})
    bad.update({k: v for k, v in launches.items()
                if k not in want and k not in PNP_CHAIN and v != 0})
    if bad:
        raise RuntimeError(f"{tag}: launches {bad}, expected {want} and the chain's")
    if (len(result) != PNP_QUESTIONS or "agg_metrics" not in metrics
            or not all(np.isfinite(v) for v in metrics.values())
            or len(clean["calls"]) != batches):
        raise RuntimeError(f"{tag}: {len(result)} answers, metrics {metrics}")
    if peak >= 80.0:
        raise RuntimeError(f"{tag}: peak {peak:.2f} GiB")

    # the first batch again through the kernels, recorded; none of what follows
    # is the main path's launches
    kept = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    pipe, images, questions, clean_out = clean["calls"][0]
    kern = {}
    with _recording_pnp(kern):
        answers, captions, _ = pipe.predict_answers(images, questions, **settings)
    device = pipe.device
    pixels = torch.as_tensor(images, device=device)
    ids, mask = pipe._ids(pipe.tokenizer([q.strip("?") for q in questions], max_length=35,
                                         enc_token=True))
    block = settings["block_num"]
    with torch.no_grad(), primitives.plain_reference():
        plain_itm = pipe.itm_model.encode_image(pixels)
        plain_cap = pipe.cap_model.encode_image(pixels)
    readings = {"itm_rows": _max_mean([kern["itm_rows"]], [plain_itm]),
                "cap_rows": _max_mean([kern["cap_rows"]], [plain_cap])}
    with primitives.plain_reference():
        _, own_full = compute_gradcam(pipe.itm_model, None, ids, mask, block_num=block,
                                      image_embeds=kern["itm_rows"])
        _, plain_full = compute_gradcam(pipe.itm_model, None, ids, mask, block_num=block,
                                        image_embeds=plain_itm)
    kern_full = kern["gradcam"][1]
    scale = float(np.abs(plain_full).max())
    own = float(np.abs(own_full - kern_full).max()) / max(scale, 1e-30)
    gradcam_d = float(np.abs(kern_full - plain_full).max())
    idx, sampled = kern["idx"] + 1, kern["ids"]  # the first round's patches (CLS skipped)
    B, n_cap, n_patch = idx.shape

    def caption_logits(rows):
        with torch.no_grad(), primitives.plain_reference():
            D = rows.shape[-1]
            gathered = torch.gather(rows[:, None].expand(B, n_cap, *rows.shape[1:]), 2,
                                    idx[..., None].expand(*idx.shape, D))
            return pipe.cap_model.decode_logits(sampled, torch.ones_like(sampled),
                                                gathered.reshape(B * n_cap, n_patch, D))

    plain_logits = caption_logits(plain_cap)
    logits_d = (caption_logits(kern["cap_rows"]) - plain_logits).abs().max().item()
    witnesses = []
    for kind, seed in PNP_WITNESS:
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        rows = _witness_rows(plain_itm, kern["itm_rows"], kind, gen)
        with primitives.plain_reference():
            _, w_full = compute_gradcam(pipe.itm_model, None, ids, mask, block_num=block,
                                        image_embeds=rows)
        w_logits = caption_logits(_witness_rows(plain_cap, kern["cap_rows"], kind, gen))
        witnesses.append({"kind": kind, "seed": seed,
                          "gradcam": float(np.abs(w_full - plain_full).max()),
                          "caption_logits": (w_logits - plain_logits).abs().max().item()})
        del w_logits
    median = {k: float(np.median([w[k] for w in witnesses]))
              for k in ("gradcam", "caption_logits")}
    t0 = time.perf_counter()
    with primitives.plain_reference():
        fid_answers = pipe.forward_qa(questions, captions, num_captions=settings["num_captions"],
                                      num_captions_fid=settings["num_captions_fid"],
                                      max_len=settings["max_len"], min_len=settings["min_len"])
        sync()
        fid_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain_answers, plain_captions, _ = pipe.predict_answers(images, questions, **settings)
        sync()
        plain_s = time.perf_counter() - t0
    del plain_logits
    log(f"[{tag}] the first batch against the all-plain run: tower rows (max / mean abs) "
        + ", ".join(f"{k} {v[0]:.3e} / {v[1]:.3e}" for k, v in readings.items())
        + f" (bound {PNP_BOUNDS['rows']}); GradCAM maps (largest |value| {scale:.3e}): the "
        f"all-plain over the kernel run's rows {own:.3e} of it (bound {PNP_BOUNDS['own']}), "
        f"from the all-plain rows max_abs {gradcam_d:.3e}; the caption decoder over the same "
        f"{B * n_cap} sampled ids and gathered patches: logits max_abs {logits_d:.3e}; the "
        f"witnesses: " + "; ".join(
            f"{w['kind']} (seed {w['seed']}): GradCAM {w['gradcam']:.3e} (the kernel run's / "
            f"this {gradcam_d / max(w['gradcam'], 1e-30):.3f}), caption logits "
            f"{w['caption_logits']:.3e} ({logits_d / max(w['caption_logits'], 1e-30):.3f})"
            for w in witnesses)
        + f" (bound {CAPTION_WITNESS_FACTOR} x the median); the all-plain FiD on the kernel "
        f"run's captions: answers {'equal' if fid_answers == answers else fid_answers} "
        f"({fid_s:.2f} s); the recorded kernel run's answers "
        f"{'equal the clean run' if answers == clean_out[0] else answers}; the free-running "
        f"all-plain batch ({plain_s:.2f} s): {sum(a == b for a, b in zip(plain_answers, answers))} "
        f"of {len(answers)} answers and {sum(len(set(a) & set(b)) for a, b in zip(plain_captions, captions))} "
        f"of {sum(len(c) for c in captions)} captions the same")
    checks = {"itm_rows": readings["itm_rows"], "cap_rows": readings["cap_rows"], "own": own,
              "gradcam": gradcam_d, "caption_logits": logits_d}
    bounds = {"itm_rows": PNP_BOUNDS["rows"], "cap_rows": PNP_BOUNDS["rows"],
              "own": PNP_BOUNDS["own"],
              **{k: CAPTION_WITNESS_FACTOR * v for k, v in median.items()}}
    past = {k: v for k, v in checks.items() if not np.all(np.asarray(v) <= np.asarray(bounds[k]))}
    if past or fid_answers != answers:
        raise RuntimeError(f"{tag}: the kernel run against the all-plain run past {bounds}: "
                           f"{past}; FiD answers {fid_answers} against {answers}")
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, kept[k])
    del clean, kern, pipe
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"metrics": metrics, "stage_seconds": {k: stats[k] for k in PNP_STAGES},
            "caption_steps": stats["caption_steps"], "fid_steps": stats["fid_steps"],
            "ms_per_sampled_token": ms_token, "total_s": total_s, "peak_memory_gib": peak,
            "launches": launches, "against_plain": {k: list(v) for k, v in readings.items()},
            "gradcam_own_rel": own, "gradcam_max_abs": gradcam_d, "gradcam_scale": scale,
            "caption_logits_max_abs": logits_d, "witnesses": witnesses,
            "fid_answers_equal": fid_answers == answers, "seconds": seconds}


# phase 16, Img2Prompt-VQA (models/pnp_vqa.py's Img2PromptVqaPipeline): img2prompt_vqa /
# base at full width (phase 15's BLIP-1 ITM large and caption large_coco, ViT-L/16 at
# 384 px in bf16 through K2; t5-large as the question generator: d_model 1024, 24 + 24
# layers, 16 heads of 64, ReLU FF 4096, the tied v1.0 head, vocabulary 32128, fp32;
# random weights from seed 0, the synthetic BERT vocab, the WhitespaceTokenizer):
# predict_prompts on IMG2PROMPT_IMAGES seeded images and questions with the pnp YAML's
# caption settings, then cli/evaluate.py on eval/pnp_vqa_vqav2_eval.yaml with the model
# img2prompt_vqa / base over phase 15's 8 questions (the YAML's filter threshold, 0.5).
# Random weights put P(match) near 0.5, so predict_prompts runs at threshold
# IMG2PROMPT_THRESHOLD and keeps every caption, as the JAX test does at 0.0
# (tests/test_pnp_vqa.py:158); its kept sets are also held at 0.5 and at the median
# of its P(match), and the CLI run's, which filters at 0.5, against all-plain.
IMG2PROMPT_IMAGES = 2
IMG2PROMPT_THRESHOLD = 0.0
IMG2PROMPT_SETTINGS = dict(num_captions=50, num_patches=20, block_num=7)
# K2 a call: 24 blocks in the ITM tower's (GradCAM) and the caption tower's, and
# 24 for each image that has captions (the ITM filter encodes it again, alone);
# each block launches 4 bf16 GEMMs, one bf16 attention and 2 LayerNorms; nothing
# else launches (the med-BERTs and the T5 are torch.matmul)
IMG2PROMPT_PER_BLOCK = {"fused_vit_block": 1, "gemm": 4, "attention_bf16": 1, "layer_norm": 2}
# Bounds, fixed before the first reading. "rows": the towers' rows of the GradCAM
# and caption calls against the all-plain towers' (phase 15's). "p_match": the
# filter's match probabilities, the kernel run's against the all-plain tower's
# rows and ITM over the same captions, max |difference| (the rows differ by
# about 0.1 / 0.01 max / mean in phase 15; a softmax over two logits of a
# random ITM head moves far less); the kept sets are equal but for captions
# whose probability lies within that bound of the threshold. "qg_logp": the
# question generator's best sequences over the first image's first 10 contexts,
# the KV-cached beam against the uncached one that runs the decoder over the
# whole prefix each step (equal ids); their summed log-probabilities under the
# cached and the recomputed decoder, max |difference| (fp32 with TF32 off: the
# same products in another order).
IMG2PROMPT_BOUNDS = {"rows": PNP_BOUNDS["rows"], "p_match": 1e-2, "qg_logp": 1e-3}
IMG2PROMPT_STAGES = ("tower_s", "gradcam_s", "caption_sample_s", "itm_filter_s", "qg_encode_s",
                     "qg_decode_s")


def _sequence_logp(model, enc, mask, ids, pad, eos, cached):
    """Each row's summed log-probability of ``ids`` [B, T] up to its first
    eos, under the cached decode (prefill, then one step a token) or one
    pass of the decoder over the whole prefix."""
    B, T = ids.shape
    bos = torch.full((B, 1), pad, dtype=torch.long, device=ids.device)
    with torch.no_grad():
        if cached:
            logits, cache = model.decode_prefill(bos, enc, mask, T + 1)
            steps = [logits]
            for t in range(T - 1):
                logits, cache = model.decode_step_logits(
                    ids[:, t], torch.tensor([t + 1], device=ids.device), cache, mask)
                steps.append(logits)
            logits = torch.stack(steps, 1)
        else:
            logits = model.decode(torch.cat([bos, ids[:, :-1]], 1), enc, mask)
        logp = torch.log_softmax(logits.float(), -1).gather(2, ids[..., None])[..., 0]
    ended = torch.cumsum((ids == eos).long(), 1) - (ids == eos).long()  # eos itself counts
    return (logp * (ended == 0)).sum(1)


def phase_img2prompt(work):
    """16: Img2Prompt-VQA's prompts and its CLI run (phase 16 of the docstring)."""
    import argparse

    from sprc_tpu_torch import kernel_checks, loader
    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.models import blip1, pnp_vqa
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    tag = "img2prompt"
    t_phase = time.perf_counter()
    os.makedirs(work, exist_ok=True)
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    counters = _counters()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)

    def read():
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    def expect(n_blocks):
        return {k: v * n_blocks for k, v in IMG2PROMPT_PER_BLOCK.items()}

    def hold_filter(cuts):
        """The recorded filter calls' P(match) against the all-plain tower's
        rows and ITM over the same captions (none of it a main path's
        launch): -> (kernel P, plain P a captioned image, max |difference|,
        the captions kept on one side only at a cut in ``cuts`` (None: the
        median of the kernel P) within the bound of it, and beyond it)."""
        groups, p_kern, p_plain = [], [], []
        with torch.no_grad(), primitives.plain_reference():
            for (pipe_, images_), calls in zip(seen["calls"], seen["base"]):
                for b, group in enumerate(calls):
                    if not group:
                        continue
                    ids, mask = pipe_._ids(pipe_.tokenizer(group, max_length=35,
                                                           enc_token=True))
                    rows = pipe_.itm_model.encode_image(images_[b:b + 1])
                    p_plain.append(real["p"](pipe_.itm_model, ids, mask,
                                             rows.expand(len(group), -1, -1)).cpu().numpy())
                    p_kern.append(seen["p_match"][len(p_kern)].cpu().numpy())
                    groups.append(group)
        # the kept sets are the kernel P's, cut at the pipeline's threshold
        kept = [k for calls, bases in zip(seen["kept"], seen["base"])
                for k, g in zip(calls, bases) if g]
        cut0 = seen["calls"][0][0].itm_filter_threshold
        if kept != [[c for c, p in zip(g, a) if p >= cut0] for g, a in zip(groups, p_kern)]:
            raise RuntimeError(f"{tag}: kept {kept} is not the captions of P >= {cut0}")
        cuts = [float(np.median(np.concatenate(p_kern))) if c is None else c for c in cuts]
        near, differ = [], []
        for cut in cuts:
            for g, a, b in zip(groups, p_kern, p_plain):
                for c, pa, pb in zip(g, a, b):
                    if (pa >= cut) != (pb >= cut):
                        close = min(abs(pa - cut), abs(pb - cut)) <= IMG2PROMPT_BOUNDS["p_match"]
                        (near if close else differ).append((cut, c, float(pa), float(pb)))
        p_diff = max(float(np.abs(a - b).max()) for a, b in zip(p_kern, p_plain))
        return p_kern, p_diff, cuts, near, differ

    # the base captions (before the filter), the filter's match probabilities
    # and its kept captions, of every call; the pipeline and images of each
    seen = {"base": [], "p_match": [], "kept": [], "calls": []}
    real = {"cap": pnp_vqa.PnpVqaPipeline.forward_cap,
            "filter": pnp_vqa.Img2PromptVqaPipeline.forward_cap,
            "p": blip1.BlipITM.itm_embeds}

    def base(self, *a, **kw):
        seen["base"].append(real["cap"](self, *a, **kw))
        return seen["base"][-1]

    def filtered(self, *a, **kw):
        seen["calls"].append((self, a[1]))
        seen["kept"].append(real["filter"](self, *a, **kw))
        return seen["kept"][-1]

    def p_match(self, *a):
        seen["p_match"].append(real["p"](self, *a))
        return seen["p_match"][-1]

    pnp_vqa.PnpVqaPipeline.forward_cap = base
    pnp_vqa.Img2PromptVqaPipeline.forward_cap = filtered
    blip1.BlipITM.itm_embeds = p_match
    try:
        t0 = time.perf_counter()
        pipe = loader.load_model("img2prompt_vqa", "base", device=DEVICE, seed=SEED,
                                 vocab_path=vocab)
        sync()
        load_s = time.perf_counter() - t0
        pipe.itm_filter_threshold = IMG2PROMPT_THRESHOLD
        qg = pipe.qa_model
        qcfg = qg.cfg
        ((_, images),) = _gallery_batches(IMG2PROMPT_IMAGES, IMG2PROMPT_IMAGES, 384, SEED + 160)
        rng = np.random.default_rng(SEED + 161)
        questions = [f"what is the {' '.join(rng.choice(STAGE1_WORDS, 2))}?"
                     for _ in range(IMG2PROMPT_IMAGES)]
        log(f"[{tag}] img2prompt_vqa / base built and drawn in {load_s:.1f} s: the question "
            f"generator d_model {qcfg.d_model}, {qcfg.num_layers} + {qcfg.num_decoder_layers} "
            f"layers, {qcfg.num_heads} heads of {qcfg.d_kv}, FF {qcfg.d_ff} "
            f"({'ReLU' if not qcfg.gated_act else 'gated'}, "
            f"{'tied' if qcfg.tie_word_embeddings else 'untied'} head), vocabulary "
            f"{qcfg.vocab_size}, {qcfg.dtype}; the filter's threshold "
            f"{pipe.itm_filter_threshold} (the YAML's 0.5 in the CLI run below)")

        # the timed run of predict_prompts, recorded (phase 15's recording keeps
        # only references to the first calls' tensors)
        torch.cuda.reset_peak_memory_stats()
        stats, rec = {}, {}
        t0 = time.perf_counter()
        with _recording_pnp(rec):
            prompts = pipe.predict_prompts(images, questions, stats=stats, **IMG2PROMPT_SETTINGS)
        sync()
        total_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = read()
        groups, kept = seen["base"][0], seen["kept"][0]
        n_filtered = sum(1 for g in groups if g)
        ms_step = stats["qg_decode_s"] / max(stats["qg_steps"], 1) * 1e3
        log(f"[{tag}] predict_prompts on {len(images)} images: seconds by stage "
            + ", ".join(f"{k} {stats[k]:.3f}" for k in IMG2PROMPT_STAGES)
            + f"; {stats['caption_steps']} sampled caption steps; {stats['qg_steps']} beam steps "
            f"(3 beams, batches of 10 contexts: up to 30 rows), {ms_step:.2f} ms a beam step; "
            f"total {total_s:.2f} s; peak {peak:.2f} GiB; captions a image "
            f"{[len(g) for g in groups]}, kept {[len(k) for k in kept]}")
        log(f"[{tag}] the first prompt: {prompts[0][:600]!r}")
        log(f"[{tag}] launches: {launches}")
        _check_launches(tag, launches, expect(24 * (2 + n_filtered)), ())
        if (len(prompts) != len(questions) or not all(
                p.startswith("Please reason the answer") and p.endswith(f"Question:{q}\nAnswer:")
                for p, q in zip(prompts, questions)) or kept != groups or not all(groups)):
            raise RuntimeError(f"{tag}: prompts {prompts}; captions {groups}, kept {kept}")
        if peak >= 80.0:
            raise RuntimeError(f"{tag}: peak {peak:.2f} GiB")
        main = dict(launches)

        # against the all-plain run (none of this is the main path's launches)
        pixels = torch.as_tensor(images, device=pipe.device)
        with torch.no_grad(), primitives.plain_reference():
            plain_itm = pipe.itm_model.encode_image(pixels)
            plain_cap = pipe.cap_model.encode_image(pixels)
        readings = {"itm_rows": _max_mean([rec["itm_rows"]], [plain_itm]),
                    "cap_rows": _max_mean([rec["cap_rows"]], [plain_cap])}
        del plain_itm, plain_cap
        p_kern, p_diff, cuts, near, differ = hold_filter([IMG2PROMPT_THRESHOLD, 0.5, None])
        kept_05 = sum(int((a >= 0.5).sum()) for a in p_kern)
        # the question generator: the first image's first 10 contexts, cached
        # against uncached beams, and the best sequences' log-probabilities
        contexts = pipe.answer_extraction(kept[0])[0][:10]
        tok = pipe.qa_tokenizer
        ids, mask = pipe._ids(tok(contexts, max_length=128))
        with torch.no_grad():
            enc = qg.encode_ids(ids, mask)
            beam = dict(num_beams=3, pad_id=tok.pad_id, eos_id=tok.eos_id, max_length=30)
            t0 = time.perf_counter()
            cached = pnp_vqa.qg_beam_search(qg, enc, mask, **beam)
            sync()
            cached_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            again = pnp_vqa.qg_beam_search(qg, enc, mask, use_cache=False, **beam)
            sync()
            uncached_s = time.perf_counter() - t0
        logp = {way: _sequence_logp(qg, enc, mask, cached, tok.pad_id, tok.eos_id, way == "cached")
                for way in ("cached", "recomputed")}
        logp_diff = (logp["cached"] - logp["recomputed"]).abs().max().item()
        same_ids = torch.equal(cached, again)
        # one cached step of the question generator's decoder at the beam's 30
        # rows (10 contexts x 3 beams, the first position), the host's pace
        # against the device's (kernel_checks.profile_decode_step, as phase 12)
        rows = len(contexts) * beam["num_beams"]
        enc_rep = enc.repeat_interleave(beam["num_beams"], 0)
        mask_rep = mask.repeat_interleave(beam["num_beams"], 0)
        bos = torch.full((rows, 1), tok.pad_id, dtype=torch.long, device=enc.device)
        pos0 = torch.ones(1, dtype=torch.long, device=enc.device)
        with torch.inference_mode():
            _, cache = qg.decode_prefill(bos, enc_rep, mask_rep, beam["max_length"])
            decode = kernel_checks.profile_decode_step(
                lambda: qg.decode_step_logits(bos[:, 0], pos0, cache, mask_rep))
        del cache, enc_rep, mask_rep
        weight_bytes = _step_weight_bytes(qg)
        decode.update(rows=rows, weights_gb=weight_bytes / 1e9,
                      weights_ms=weight_bytes / kernel_checks.PEAK_BYTES * 1e3, loop_ms=ms_step)
        log(f"[{tag}] one cached decoder step of the question generator at {rows} rows: host "
            f"{decode['host_ms']:.3f} ms, device {decode['device_ms']:.3f} ms (a CUDA graph), "
            f"busy share {decode['busy_share']:.3f} (the graph's output against the step's: "
            f"max_abs {decode['graph_max_abs']:.3e}); {decode['aten_ops']} ATen operators a step "
            f"({decode['aten_views']} views), {decode['kernels_profiled']} launches seen by one "
            f"profile, {decode['kernel_ms_profiled']:.3f} ms of kernels, the most in (name, "
            f"launches, ms) {decode['top_kernels']}; the weights it reads "
            f"{decode['weights_gb']:.3f} GB, {decode['weights_ms']:.3f} ms at the card's memory "
            f"rate; predict_prompts' beam loop {ms_step:.2f} ms a step (the step's decoder, the "
            f"top 3 of 3 x V, the caches' reorder)")
        if not decode["graph_max_abs"] <= IMG2PROMPT_BOUNDS["qg_logp"]:
            raise RuntimeError(f"{tag}: the decoder step's graph replay differs from the step "
                               f"by {decode['graph_max_abs']}")
        log(f"[{tag}] against the all-plain run: tower rows (max / mean abs) "
            + ", ".join(f"{k} {v[0]:.3e} / {v[1]:.3e}" for k, v in readings.items())
            + f" (bound {IMG2PROMPT_BOUNDS['rows']}); the filter's P(match) over "
            f"{sum(map(len, p_kern))} captions: max_abs {p_diff:.3e} (bound "
            f"{IMG2PROMPT_BOUNDS['p_match']}; P from {min(float(a.min()) for a in p_kern):.4f} to "
            f"{max(float(a.max()) for a in p_kern):.4f}, {kept_05} kept at 0.5); kept sets at "
            f"{[round(c, 4) for c in cuts]} (the last the median): {len(differ)} captions differ, {len(near)} within "
            f"the bound of the threshold {near[:5]}; the question generator over {len(contexts)} "
            f"contexts: the cached beam ({cached_s:.2f} s) against the uncached one "
            f"({uncached_s:.2f} s): ids {'equal' if same_ids else 'DIFFER'}; the best sequences' "
            f"log-probabilities {[round(v, 4) for v in logp['cached'].tolist()[:4]]}..., cached "
            f"against recomputed max_abs {logp_diff:.3e} (bound {IMG2PROMPT_BOUNDS['qg_logp']}); "
            f"questions e.g. {[tok.decode(r)[:40] for r in cached.cpu().numpy()[:2]]}")
        past = {k: v for k, v in readings.items()
                if not np.all(np.asarray(v) <= np.asarray(IMG2PROMPT_BOUNDS["rows"]))}
        if past or differ or not same_ids or p_diff > IMG2PROMPT_BOUNDS["p_match"] \
                or logp_diff > IMG2PROMPT_BOUNDS["qg_logp"]:
            raise RuntimeError(f"{tag}: against the all-plain run: rows {past}, kept sets "
                               f"{differ}, P {p_diff}, ids equal {same_ids}, logp {logp_diff}")
        for k, (obj, attr) in counters.items():
            setattr(obj, attr, main[k])
        for key in seen:
            seen[key].clear()
        del pipe, qg, rec, enc, pixels
        gc.collect()
        torch.cuda.empty_cache()

        # cli/evaluate.py on the pnp YAML with the model img2prompt_vqa / base
        root = os.path.join(work, "pnp_vqa")
        ann = _write_vqa(root, PNP_QUESTIONS, SEED + 150)
        cfg, how = _run_config(PNP_RUN, {
            "run": {"seed": SEED},
            "model": {"arch": "img2prompt_vqa"},
            "datasets": {"coco_vqa": {"build_info": {"annotations": {"val": [ann]},
                                                     "images": root}}}})
        log(f"[{tag}] cli/evaluate.py through {how}")
        out_dir = os.path.join(work, "img2prompt_out")
        args = argparse.Namespace(device=DEVICE, model_path=None, vocab_path=vocab, split=None,
                                  output_dir=out_dir)
        cli_stats = {}
        t0 = time.perf_counter()
        metrics = evaluate.evaluate(cfg, args, cli_stats)
        sync()
        cli_s = time.perf_counter() - t0
    finally:
        pnp_vqa.PnpVqaPipeline.forward_cap = real["cap"]
        pnp_vqa.Img2PromptVqaPipeline.forward_cap = real["filter"]
        blip1.BlipITM.itm_embeds = real["p"]
    cli_launches = {k: v - main[k] for k, v in read().items()}
    with open(os.path.join(out_dir, "result", "val_vqa_result.json")) as f:
        result = json.load(f)
    batches = len(seen["base"])
    n_filtered = sum(1 for calls in seen["base"] for g in calls if g)
    log(json.dumps({k: v for k, v in metrics.items() if isinstance(v, (int, float, str))}))
    log(f"[{tag}] the CLI run, {batches} batches of {cfg.run['batch_size_eval']}: seconds by "
        "stage " + ", ".join(f"{k} {cli_stats.get(k, 0.0):.3f}" for k in (
            "tower_s", "gradcam_s", "caption_sample_s", "itm_filter_s", "fid_encode_s",
            "fid_decode_s")) + f"; total {cli_s:.2f} s (the build included); captions kept at "
        f"0.5: {sum(len(k) for calls in seen['kept'] for k in calls)} of "
        f"{sum(len(g) for calls in seen['base'] for g in calls)}; {len(result)} answers, e.g. "
        f"{[r['answer'][:30] for r in result[:3]]}; launches {cli_launches}")
    _check_launches(f"{tag} CLI", cli_launches, expect(24 * (2 * batches + n_filtered)), ())
    # the CLI's filter, at the YAML's 0.5 (and the median of its P), against all-plain
    cli_p, cli_diff, cli_cuts, cli_near, cli_differ = hold_filter([0.5, None])
    log(f"[{tag}] the CLI run's filter against the all-plain run: P(match) over "
        f"{sum(map(len, cli_p))} captions of {len(cli_p)} images max_abs {cli_diff:.3e} (bound "
        f"{IMG2PROMPT_BOUNDS['p_match']}; P from {min(float(a.min()) for a in cli_p):.4f} to "
        f"{max(float(a.max()) for a in cli_p):.4f}); kept sets at "
        f"{[round(c, 4) for c in cli_cuts]} (the last the median): {len(cli_differ)} captions "
        f"differ, {len(cli_near)} within the bound of the threshold {cli_near[:5]}")
    for key in seen:
        seen[key].clear()
    gc.collect()
    torch.cuda.empty_cache()
    if cli_differ or cli_diff > IMG2PROMPT_BOUNDS["p_match"]:
        raise RuntimeError(f"{tag} CLI: against the all-plain run: kept sets {cli_differ}, "
                           f"P {cli_diff}")
    if (len(result) != PNP_QUESTIONS or "agg_metrics" not in metrics
            or not all(np.isfinite(v) for v in metrics.values() if isinstance(v, float))):
        raise RuntimeError(f"{tag}: {len(result)} answers, metrics {metrics}")
    launches = read()
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"stage_seconds": {k: stats[k] for k in IMG2PROMPT_STAGES},
            "caption_steps": stats["caption_steps"], "qg_steps": stats["qg_steps"],
            "ms_per_beam_step": ms_step, "beam_decoder_step": decode, "total_s": total_s, "peak_memory_gib": peak,
            "load_s": load_s, "launches": launches, "predict_prompts_launches": main,
            "cli_launches": cli_launches, "cli_metrics": metrics, "cli_s": cli_s,
            "against_plain": {k: list(v) for k, v in readings.items()},
            "p_match_max_abs": p_diff, "kept_near_threshold": len(near),
            "cli_p_match_max_abs": cli_diff, "cli_kept_near_threshold": len(cli_near),
            "qg_ids_equal": same_ids, "qg_logp_max_abs": logp_diff, "seconds": seconds}


# phase 17: the momentum-queue families (BLIP-1 / ALBEF retrieval fine-tunes and
# pretraining) through cli/train.py at full width (ViT-B/16 trained through K2's
# FusedViTBlock, BERT-base med, the YAMLs' queues of 57,600 / 65,536), and their
# evaluation through cli/evaluate.py. arch -> (run YAML, steps)
MOMENTUM_TRAIN = {"blip_retrieval": ("retrieval_coco_ft.yaml", 3),
                  "albef_retrieval": ("retrieval_coco_albef_ft.yaml", 3),
                  "blip_pretrain": ("pretrain_14m.yaml", 2),
                  "albef_pretrain": ("pretrain_albef.yaml", 2)}
MOMENTUM_EVAL = {"blip_retrieval": "eval/ret_coco_eval.yaml",
                 "albef_retrieval": "eval/ret_coco_albef_eval.yaml"}
MOMENTUM_EVAL_SPLIT = (32, 5, 16)  # images, captions an image, k_test
# K2 a step: the live tower's 12 blocks through FusedViTBlock and the momentum
# tower's 12 without a graph (a pretrainer's heads share the live tower's rows);
# an evaluation: 12 a 16-image encode
MOMENTUM_STEP_LAUNCHES = 24
MOMENTUM_EVAL_LAUNCHES = 12 * (MOMENTUM_EVAL_SPLIT[0] // 16)
# Bounds, fixed before the first reading. The kernel run against the all-plain
# run (primitives.plain_reference) of the same weights, batches and hard
# negatives (the kernel run's draws replayed): the bf16 tower's rows differ by
# bf16 rounding through 12 blocks, which the unit-norm features and the
# ITM / MLM / LM heads carry: each loss within 2e-2 of its value, each ITM
# logit within 0.1, each queue entry (the momentum features, unit-norm 256-d)
# within 3e-2; the momentum copies are updated from fp32 masters that the two
# runs move by Adam's steps (lr x steps at most, and 0.005 of that into a
# copy), within 1e-4; ``ptr`` and ``idx_queue`` equal. The evaluation: the
# tower's rows, kernel against plain on the same pixels, within phase 15's
# rows bound (max, mean |difference|); everything after the tower runs no
# kernel, so the all-plain evaluation from the kernel tower's rows gives the
# same cosines, rescored scores (within 1e-6) and recalls. (Taken whole from
# its own tower, the random model's cosines sit within 3e-3 of each other:
# 29 of 320 t2i top sets moved past a 1e-3 tie bound in the first reading.)
MOMENTUM_BOUNDS = {"loss": 2e-2, "itm": 0.1, "queue": 3e-2, "params_m": 1e-4,
                   "rows": PNP_BOUNDS["rows"], "scores": 1e-6}


def _tree_gap(got, want):
    """max |a - b| over the tensors of two dicts with the same keys."""
    return max((got[k].float() - want[k].float()).abs().max().item() for k in want)


def phase_momentum_train(work, arch):
    """17a / 17b: one momentum-queue YAML through cli/train.py (phase 17 of the
    docstring), then the same steps all-plain."""
    import argparse
    import shutil

    from sprc_tpu_torch.cli import train as train_cli
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.models import albef
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.train import generic
    from sprc_tpu_torch.train.loop import TrainConfig
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    name, steps = MOMENTUM_TRAIN[arch]
    tag = f"momentum {arch}"
    t_phase = time.perf_counter()
    batch_size = RUN_CONFIGS[name]["run"]["batch_size"]
    (builder,) = RUN_CONFIGS[name]["datasets"]
    root = os.path.join(work, f"momentum_{arch}")
    ann = _write_pairs(root, batch_size * steps, 0, SEED + 170, "mq")
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    out = os.path.join(work, f"momentum_{arch}_train")
    shutil.rmtree(out, ignore_errors=True)
    cfg, how = _run_config(name, {
        "run": {"max_epochs": 1, "seed": SEED, "log_freq": 1},
        "datasets": {builder: {"build_info": {"annotations": {"train": [ann]}, "images": root}}}})
    log(f"[{tag}] cli/train.py through {how}")
    args = argparse.Namespace(output_dir=out, vocab_path=vocab, model_path=None, resume=None,
                              device=DEVICE, data_path=None)
    counters = _counters()

    def read():
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    def zero():
        for obj, attr in counters.values():
            setattr(obj, attr, 0)

    real_step, real_sample = generic.GenericTrainer.train_step, albef.sample_negatives
    times, per_step, picks, itm, kept = [], [], [], [], {}

    def sample(weights, generator):
        drawn = real_sample(weights, generator)
        picks.append(drawn.clone())
        return drawn

    def timed_step(self, batch):
        kept["trainer"] = self
        hook = self.model.itm_head.register_forward_hook(
            lambda m, i, o: itm.append(o.detach().float()))
        before = read()
        t0 = time.perf_counter()
        metrics = real_step(self, batch)  # ends in a host read of the losses
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: v - before[k] for k, v in read().items() if v != before[k]})
        hook.remove()
        return metrics

    generic.GenericTrainer.train_step, albef.sample_negatives = timed_step, sample
    try:
        zero()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_cli.train(cfg, args)
        sync()
        run_s = time.perf_counter() - t0
        launches = read()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        generic.GenericTrainer.train_step, albef.sample_negatives = real_step, real_sample
    trainer = kept.pop("trainer")
    k_aux, k_itm = trainer.aux, itm[:]
    param_count = sum(p.numel() for p in trainer.model.parameters())
    del trainer
    with open(os.path.join(out, "log.jsonl")) as f:
        k_rows = [r for r in map(json.loads, f) if r["kind"] == "step"]
    loss_keys = [k for k in k_rows[0] if k.startswith("loss")]
    log(f"[{tag}] {len(k_rows)} steps at batch {batch_size} ({param_count / 1e6:.1f} M "
        f"parameters): ms " + ", ".join(f"{t:.1f}" for t in times)
        + f"; samples/s (last step) {batch_size / times[-1] * 1e3:.2f}; peak {peak:.2f} GiB; "
        f"run {run_s:.1f} s; losses " + "; ".join(
            ", ".join(f"{k} {r[k]:.4f}" for k in loss_keys) for r in k_rows))
    log(f"[{tag}] launches: {launches}; a step: {per_step}")
    if len(k_rows) != steps or any(r["skipped_nonfinite"] for r in k_rows):
        raise RuntimeError(f"{tag}: steps {k_rows}")
    if not all(np.isfinite(r[k]) for r in k_rows for k in loss_keys):
        raise RuntimeError(f"{tag}: a loss is not finite: {k_rows}")
    bad = [p for p in per_step if p.get("fused_vit_block") != MOMENTUM_STEP_LAUNCHES]
    if bad:
        raise RuntimeError(f"{tag}: K2 launches a step {per_step}, expected "
                           f"{MOMENTUM_STEP_LAUNCHES}")
    gc.collect()
    torch.cuda.empty_cache()

    # the all-plain run: the same weights (the run's seed), batches (the builder's
    # seeded transform and order) and hard negatives (the kernel run's, replayed)
    model_cfg = dict(cfg.model)
    model_cfg.pop("arch")
    model = load_model(arch, model_cfg.pop("model_type", "pretrain"), device=DEVICE, seed=SEED,
                       **model_cfg)
    tokenizer = BertWordPieceTokenizer.from_vocab_file(vocab)
    datasets = registry.get("dataset", builder)(dict(cfg.datasets[builder])).build()
    adapter = generic.TASK_ADAPTERS[cfg.run["task"]](
        tokenizer, max_txt_len=int(cfg.run["max_txt_len"])).specialize(model)
    task = generic.BuilderTask(datasets, adapter, batch_size=batch_size, seed=SEED,
                               device=DEVICE)
    tcfg = TrainConfig(learning_rate=float(cfg.run["learning_rate"]),
                       weight_decay=float(cfg.run["weight_decay"]), total_steps=steps)
    plain = generic.GenericTrainer(model, tcfg, seed=SEED, adapter=adapter, skip_nonfinite=True,
                                   decay_frozen=True)
    plain.aux = adapter.init_aux(model, plain.param_values())
    replay, p_itm = list(picks), []
    albef.sample_negatives = lambda weights, generator: replay.pop(0)
    hook = model.itm_head.register_forward_hook(lambda m, i, o: p_itm.append(o.detach().float()))
    try:
        with primitives.plain_reference():
            p_rows = [plain.train_step(task.prepare_batch(b)) for b in task.train_loader(0)]
        sync()
    finally:
        albef.sample_negatives = real_sample
        hook.remove()
    p_aux = plain.aux
    gaps = {"loss": max(abs(k[key] - p[key]) / max(abs(p[key]), 1e-6)
                        for k, p in zip(k_rows, p_rows) for key in loss_keys),
            "itm": max((a - b).abs().max().item() for a, b in zip(k_itm, p_itm)),
            "queue": max(_tree_gap({q: k_aux[q]}, {q: p_aux[q]})
                         for q in ("image_queue", "text_queue")),
            "params_m": _tree_gap(k_aux["params_m"], p_aux["params_m"])}
    same = (torch.equal(k_aux["idx_queue"], p_aux["idx_queue"])
            and int(k_aux["ptr"]) == int(p_aux["ptr"]) == (batch_size * steps)
            % k_aux["image_queue"].shape[1])
    del model, plain, p_aux, k_aux
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] the kernel run against the all-plain run (the same hard negatives, "
        f"{len(picks)} draws replayed, {len(replay)} left): losses {gaps['loss']:.3e} (bound "
        f"{MOMENTUM_BOUNDS['loss']:.0e}), ITM logits {gaps['itm']:.3e} (bound "
        f"{MOMENTUM_BOUNDS['itm']:.0e}), queues {gaps['queue']:.3e} (bound "
        f"{MOMENTUM_BOUNDS['queue']:.0e}), momentum copies {gaps['params_m']:.3e} (bound "
        f"{MOMENTUM_BOUNDS['params_m']:.0e}); ptr and idx_queue equal: {same}")
    failed = [k for k, v in gaps.items() if not v <= MOMENTUM_BOUNDS[k]]
    if failed or not same or replay or len(p_rows) != steps:
        raise RuntimeError(f"{tag}: against the all-plain run: beyond MOMENTUM_BOUNDS {failed}, "
                           f"ptr / idx_queue equal {same}, {len(replay)} draws left")
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"step_ms": times, "samples_per_s": batch_size / times[-1] * 1e3,
            "peak_memory_gib": peak, "losses": k_rows, "launches": launches,
            "launches_step": per_step, "k2_launches_per_step": per_step[-1].get("fused_vit_block"),
            "gaps": gaps, "seconds": seconds}


def phase_momentum_eval(work, arch):
    """17c: one momentum-queue eval YAML through cli/evaluate.py over a synthetic
    split (MOMENTUM_EVAL_SPLIT), then all-plain from the kernel tower's rows."""
    import argparse

    from sprc_tpu_torch.cli import evaluate as evaluate_cli
    from sprc_tpu_torch.models import albef
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.train import tasks
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    tag = f"momentum eval {arch}"
    t_phase = time.perf_counter()
    n_images, captions, k_test = MOMENTUM_EVAL_SPLIT
    root = os.path.join(work, "momentum_eval")
    ann = os.path.join(root, "annotations.json")
    if not os.path.exists(ann):
        _write_pairs(root, n_images, captions, SEED + 171, "me")
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    cfg, how = _run_config(MOMENTUM_EVAL[arch], {
        "run": {"k_test": k_test},
        "datasets": {"coco_retrieval": {"build_info": {"annotations": {"test": [ann]},
                                                       "images": root}}}})
    log(f"[{tag}] cli/evaluate.py through {how}: {n_images} images x {captions} captions, "
        f"k_test {k_test}")
    args = argparse.Namespace(model_path=None, vocab_path=vocab, output_dir=work, split=None,
                              device=DEVICE)
    counters = _counters()
    real_rescore, real_encode = tasks.rescore_topk, albef._QueueModel.encode_image
    rows, row_gaps, runs = [], [], {}

    def record(self, images):  # the kernel run: its tower rows kept
        out = real_encode(self, images)
        rows.append(out.clone())
        return out

    def replay(self, images):  # the plain run: the plain tower held against them
        with primitives.plain_reference():
            plain = real_encode(self, images)
        kept = rows[len(row_gaps)]
        row_gaps.append(((plain - kept).abs().max().item(), (plain - kept).abs().mean().item()))
        return kept

    for kind, encode in (("kernel", record), ("plain", replay)):
        seen = []

        def rescore(sims, *a, **kw):
            out = real_rescore(sims, *a, **kw)
            seen.append((sims, *out))
            return out

        tasks.rescore_topk, albef._QueueModel.encode_image = rescore, encode
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        stats = {}
        try:
            t0 = time.perf_counter()
            if kind == "plain":
                with primitives.plain_reference():
                    metrics = evaluate_cli.evaluate(cfg, args, stats=stats)
            else:
                metrics = evaluate_cli.evaluate(cfg, args, stats=stats)
            sync()
            seconds = time.perf_counter() - t0
        finally:
            tasks.rescore_topk, albef._QueueModel.encode_image = real_rescore, real_encode
        runs[kind] = {"metrics": {k: v for k, v in metrics.items()
                                  if isinstance(v, (int, float))},
                      "stats": stats, "seconds": seconds, "mats": seen[0],
                      "launches": {k: getattr(o, a) for k, (o, a) in counters.items()
                                   if getattr(o, a)}}
        gc.collect()
        torch.cuda.empty_cache()
    k, p = runs["kernel"], runs["plain"]
    score_gap = max(float(np.abs(a - b).max()) for a, b in zip(k.pop("mats"), p.pop("mats")))
    rows_max, rows_mean = (max(g[i] for g in row_gaps) for i in (0, 1))
    for kind, run in runs.items():
        log(f"[{tag}] {kind}: {run['seconds']:.2f} s; by stage "
            + ", ".join(f"{s} {v:.3f}" for s, v in run["stats"].items())
            + f"; launches {run['launches']}; recalls {run['metrics']}")
    log(f"[{tag}] the tower's rows, kernel against plain on the same pixels: max "
        f"{rows_max:.3e}, mean {rows_mean:.3e} (bound {MOMENTUM_BOUNDS['rows']}); from the "
        f"kernel tower's rows the all-plain cosines, rescored scores and recalls: "
        f"max difference {score_gap:.3e}, recalls equal {k['metrics'] == p['metrics']}")
    if k["launches"].get("fused_vit_block") != MOMENTUM_EVAL_LAUNCHES or p["launches"]:
        raise RuntimeError(f"{tag}: launches {k['launches']} (kernel), {p['launches']} (plain); "
                           f"expected {MOMENTUM_EVAL_LAUNCHES} K2 and none")
    if (k["metrics"] != p["metrics"] or score_gap > MOMENTUM_BOUNDS["scores"]
            or rows_max > MOMENTUM_BOUNDS["rows"][0] or rows_mean > MOMENTUM_BOUNDS["rows"][1]
            or len(row_gaps) != len(rows)):
        raise RuntimeError(f"{tag}: the kernel evaluation disagrees with the all-plain one")
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"metrics": k["metrics"], "stages_s": k["stats"], "seconds_kernel": k["seconds"],
            "seconds_plain": p["seconds"], "launches": k["launches"], "rows_gap": [rows_max,
                                                                                  rows_mean],
            "score_gap": score_gap, "seconds": seconds}


def momentum_kernels(rows, train, evals):
    """The kernel rows of the momentum-queue families: K2 through
    FusedViTBlock at the retrieval fine-tune's shape (B = 32, S = 577; its
    launches those of 17a / 17b, the momentum towers' and 17c's included), its
    bf16 attention and the block's four bf16 products at that shape."""
    from sprc_tpu_torch.kernel_checks import BLIP_B_PRODUCTS, bound_ms

    by_check = {r["check"]: r for r in rows}
    runs = list(train.values()) + list(evals.values())

    def launches(counter):
        return sum(run["launches"].get(counter, 0) for run in runs)

    fvb = by_check["FusedViTBlock blip_b bf16 S=577 B=32"]
    attn = by_check["attention D=64 bf16 blip_b S=577 B=32"]
    gemms = [by_check[f"gemm bf16 {n} S=577 B=32"] for n in BLIP_B_PRODUCTS]
    work = {"bytes": sum(r["bytes"] for r in gemms),
            "op_seconds": sum(r["op_seconds"] for r in gemms)}
    return [
        {"name": "fused_vit_block (FusedViTBlock, momentum-queue families)", "route": "cuda",
         "source": "sprc_tpu_torch/ops/fused_block.py",
         "replaces": "sprc_tpu/ops/pallas_block.py:609", "launches": launches("fused_vit_block"),
         "max_abs_err": fvb["max_abs_err"], "ms": fvb["ms"], "plain_ms": fvb["plain_ms"],
         **bound_ms(fvb), "library_ms": None, "fwd_bwd_ms": fvb["fwd_bwd_ms"],
         "plain_fwd_bwd_ms": fvb["plain_fwd_bwd_ms"]},
        {"name": "attention bf16 (momentum-queue families)", "route": "cuda",
         "source": "sprc_tpu_torch/csrc/attention.cu",
         "replaces": "sprc_tpu/ops/pallas_attention.py:428", "launches": launches("attention_bf16"),
         "max_abs_err": attn["max_abs_err"], "ms": attn["ms"], "plain_ms": attn["plain_ms"],
         **bound_ms(attn), "library_ms": attn["library_ms"]},
        {"name": "gemm bf16 (momentum-queue families, a block's four products)", "route": "cuda",
         "source": "sprc_tpu_torch/csrc/gemm.cu", "replaces": "scripts/ablate_int8.py:194",
         "launches": launches("gemm"), "max_abs_err": max(r["max_abs_err"] for r in gemms),
         "ms": sum(r["ms"] for r in gemms), "plain_ms": sum(r["plain_ms"] for r in gemms),
         **bound_ms(work), "library_ms": sum(r["library_ms"] for r in gemms)}]


def kernel_table(rows, launches):
    """One entry per ported TPU kernel, from this run's checks and counts.
    A chain has no single PyTorch call that computes it: library_ms null."""
    from sprc_tpu_torch.kernel_checks import RETRIEVAL_SHAPES, VARIANT_SHAPES, bound_ms

    by_check = {r["check"]: r for r in rows}

    def entry(name, source, replaces, checks, library_ms=None, count=None):
        rs = [by_check[c] for c in checks]
        work = {"bytes": sum(r["bytes"] for r in rs),
                "op_seconds": sum(r["op_seconds"] for r in rs)}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[count or name],
                "max_abs_err": max(r["max_abs_err"] for r in rs),
                "ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs),
                **bound_ms(work), "library_ms": library_ms,
                # K1's products run in 3xTF32 on the tensor cores: that rate's bound too
                **({"tf32x3_ms": sum(r["tf32x3_ms"] for r in rs)}
                   if all("tf32x3_ms" in r for r in rs) else {})}

    shapes = ("queries", "fusion", "prompt")  # K3 / K4: summed over the serving shapes
    qf_attention = [c for c in by_check if c.startswith("attention f32 qformer ")
                    and " rerank " not in c]
    rerank_attention = ["attention f32 qformer rerank cross", "attention f32 qformer rerank self"]
    return [
        entry("token_max_sim", "sprc_tpu_torch/csrc/token_max_sim.cu",
              "sprc_tpu/ops/pallas_sim.py:40", ["K1 token_max_sim"]),
        entry("fused_vit_block", "sprc_tpu_torch/ops/fused_block.py",
              "sprc_tpu/ops/pallas_block.py:609", ["K2 vit_block"]),
        entry("fused_qformer_layer", "sprc_tpu_torch/ops/fused_qformer.py",
              "sprc_tpu/ops/pallas_qformer.py:360", [f"K3 qformer_layer {s}" for s in shapes]),
        entry("fused_qformer_layer_int8", "sprc_tpu_torch/ops/fused_qformer.py",
              "sprc_tpu/ops/pallas_qformer.py:360",
              [f"K4 qformer_layer_int8 {s}" for s in shapes]),
        entry("fused_vit_block_i8", "sprc_tpu_torch/ops/fused_block.py",
              "sprc_tpu/ops/pallas_block.py:535", ["K5 vit_block_i8"]),
        # K6 to K8 at the shapes of the validate path (EVA ViT-g, 64 images)
        entry("fused_attn_block", "sprc_tpu_torch/ops/fused_block.py",
              "sprc_tpu/ops/pallas_block.py:640", ["K6 attn_block eva_g"]),
        entry("fused_mlp_block", "sprc_tpu_torch/ops/fused_block.py",
              "sprc_tpu/ops/pallas_mlp.py:129", ["K7 mlp_block eva_g"]),
        entry("flash_attention", "sprc_tpu_torch/csrc/attention.cu",
              "sprc_tpu/ops/pallas_attention.py:428", ["K8 flash_attention D=88"],
              library_ms=by_check["K8 flash_attention D=88"]["library_ms"]),
        # the same kernel at ViT-L's head dim: its launches are those of the int8
        # configuration's calibration pass (set-up of that main path)
        entry("flash_attention D=64", "sprc_tpu_torch/csrc/attention.cu",
              "sprc_tpu/ops/pallas_attention.py:428", ["K8 flash_attention D=64"],
              library_ms=by_check["K8 flash_attention D=64"]["library_ms"],
              count="flash_attention_calibration"),
        # the SPRC_ATTN_V variants (v4 to v11) are TPU schedules of the same
        # function: the one kernel above, its numbers again
        entry("flash_attention_variants", "sprc_tpu_torch/csrc/attention.cu",
              "sprc_tpu/ops/pallas_attention.py:84", ["K8 flash_attention D=88"],
              library_ms=by_check["K8 flash_attention D=88"]["library_ms"],
              count="flash_attention"),
        # the tiled matmul of scripts/ablate_int8.py, at its shape, in both its modes
        entry("gemm_i8", "sprc_tpu_torch/csrc/gemm_i8.cu", "scripts/ablate_int8.py:194",
              ["gemm_i8 ablate 4096^3"],
              library_ms=by_check["gemm_i8 ablate 4096^3"]["library_ms"]),
        entry("gemm", "sprc_tpu_torch/csrc/gemm.cu", "scripts/ablate_int8.py:194",
              ["gemm bf16 ablate 4096^3"],
              library_ms=by_check["gemm bf16 ablate 4096^3"]["library_ms"]),
        # the true-fp32 GEMM of K3's ten dense ops, at its largest product (the
        # image's key / value projection of the queries pass)
        entry("gemm_f32", "sprc_tpu_torch/csrc/gemm.cu", "sprc_tpu/ops/pallas_qformer.py:168",
              ["gemm f32 qformer cross kv, queries pass"],
              library_ms=by_check["gemm f32 qformer cross kv, queries pass"]["library_ms"]),
        # the chains' own kernels: the fp32 attention of K3 / K4 summed over the
        # Q-Former's five calls (beside SDPA in fp32), the LayerNorm at ViT-L's
        # encode batch in bf16 (beside F.layer_norm in bf16) and to int8
        entry("attention_f32", "sprc_tpu_torch/csrc/attention.cu",
              "sprc_tpu/ops/pallas_qformer.py:74", qf_attention,
              library_ms=sum(by_check[c]["library_ms"] for c in qf_attention)),
        entry("layer_norm", "sprc_tpu_torch/csrc/layernorm.cu", "sprc_tpu/ops/pallas_block.py:261",
              ["layer_norm vit_l bf16"], library_ms=by_check["layer_norm vit_l bf16"]["library_ms"]),
        entry("layer_norm_q8", "sprc_tpu_torch/csrc/layernorm.cu",
              "sprc_tpu/ops/pallas_block.py:417", ["layer_norm vit_l bf16 -> s8"]),
        # the quantisers at ViT-L's ctx and the image rows of an encode batch
        # (ms: the kernels' device time; no one PyTorch call computes either)
        entry("quantize_static", "sprc_tpu_torch/csrc/quantize.cu",
              "sprc_tpu/ops/pallas_block.py:417", ["quantize static vit_l ctx"]),
        entry("quantize_rows", "sprc_tpu_torch/csrc/quantize.cu",
              "sprc_tpu/ops/pallas_qformer.py:55", ["quantize rows image vit_l encode"]),
        # phase 8, the ITM rerank: K3 / K4 at bench.py's tile (750 pairs into the
        # 514-row memory, ViT-L's width; launches: the serving path's and the
        # int8 tile's), the fp32 GEMM at the memory's key / value products (ViT-L
        # at that tile; EVA ViT-g at a CIRR tile of 3000, past 2^31 elements,
        # launches: validate_rerank's), the s8 GEMM at EVA's (launches: the
        # int8 tile's, ViT-L), the fp32 attention at a CIRR tile's two calls
        entry("fused_qformer_layer (rerank)", "sprc_tpu_torch/ops/fused_qformer.py",
              "sprc_tpu/ops/pallas_qformer.py:360", ["K3 qformer_layer rerank"],
              count="fused_qformer_layer_rerank"),
        entry("fused_qformer_layer_int8 (rerank)", "sprc_tpu_torch/ops/fused_qformer.py",
              "sprc_tpu/ops/pallas_qformer.py:360", ["K4 qformer_layer_int8 rerank"],
              count="fused_qformer_layer_int8_rerank"),
        entry("gemm_f32 (rerank cross kv)", "sprc_tpu_torch/csrc/gemm.cu",
              "sprc_tpu/ops/pallas_qformer.py:168", ["gemm f32 qformer cross kv, rerank"],
              library_ms=by_check["gemm f32 qformer cross kv, rerank"]["library_ms"],
              count="gemm_f32_rerank"),
        entry("gemm_f32 (rerank cross kv, EVA)", "sprc_tpu_torch/csrc/gemm.cu",
              "sprc_tpu/ops/pallas_qformer.py:168", ["gemm f32 qformer cross kv, rerank, EVA"],
              library_ms=by_check["gemm f32 qformer cross kv, rerank, EVA"]["library_ms"],
              count="gemm_f32_rerank_eva"),
        entry("gemm_i8 (rerank cross kv, EVA)", "sprc_tpu_torch/csrc/gemm_i8.cu",
              "scripts/ablate_int8.py:194", ["gemm_i8 qformer cross kv, rerank, EVA"],
              library_ms=by_check["gemm_i8 qformer cross kv, rerank, EVA"]["library_ms"],
              count="gemm_i8_rerank"),
        entry("attention_f32 (rerank)", "sprc_tpu_torch/csrc/attention.cu",
              "sprc_tpu/ops/pallas_qformer.py:74", rerank_attention,
              library_ms=sum(by_check[c]["library_ms"] for c in rerank_attention),
              count="attention_f32_rerank"),
        # phase 9, the variant zoo: K3 at its no-grad passes' shapes (summed),
        # launches: the variants' timed steps and eval forwards
        entry("fused_qformer_layer (variant zoo)", "sprc_tpu_torch/ops/fused_qformer.py",
              "sprc_tpu/ops/pallas_qformer.py:360",
              [f"K3 qformer_layer {s}" for s in VARIANT_SHAPES],
              count="fused_qformer_layer_variants"),
        # phase 10, BLIP-2 stage 1: K1 at COCO's retrieval call (25,000 captions x
        # 5,000 images), K2 in fp32 at 364 px and K3 against 677 memory rows
        # (summed over the queries, text and ITM shapes), launches: 10a's; K2 in
        # bf16 at pretraining's batch of 100, launches: 10b's
        entry("token_max_sim (stage-1 retrieval)", "sprc_tpu_torch/csrc/token_max_sim.cu",
              "sprc_tpu/ops/pallas_sim.py:40", ["K1 token_max_sim coco"],
              count="token_max_sim_stage1_eval"),
        entry("fused_vit_block (fp32 tower, 364 px)", "sprc_tpu_torch/ops/fused_block.py",
              "sprc_tpu/ops/pallas_block.py:609", ["K2 vit_block eva_g fp32 S=677"],
              count="fused_vit_block_stage1_eval"),
        entry("fused_qformer_layer (stage-1 retrieval)", "sprc_tpu_torch/ops/fused_qformer.py",
              "sprc_tpu/ops/pallas_qformer.py:360",
              [f"K3 qformer_layer {s}" for s in RETRIEVAL_SHAPES],
              count="fused_qformer_layer_stage1_eval"),
        entry("fused_vit_block (stage-1 pretraining)", "sprc_tpu_torch/ops/fused_block.py",
              "sprc_tpu/ops/pallas_block.py:609", ["K2 vit_block eva_g B=100"],
              count="fused_vit_block_stage1_train"),
        # the fp32 attention at the fp32 tower's call (S = 677, D 88, beside
        # SDPA); launches: 10a's, the tower's 39 and the Q-Former's
        entry("attention_f32 (fp32 tower, 364 px)", "sprc_tpu_torch/csrc/attention.cu",
              "sprc_tpu/ops/pallas_attention.py:428", ["attention D=88 fp32 S=677"],
              library_ms=by_check["attention D=88 fp32 S=677"]["library_ms"],
              count="attention_f32_stage1_eval"),
    ] + [  # phase 11, a tower that trains: each kernel through its autograd Function
        dict(entry(f"{kernel} ({function}, unfrozen tower)", source, replaces,
                   [f"{function} eva_g fp32 S=677"], count=function,
                   library_ms=by_check[f"{function} eva_g fp32 S=677"]["library_ms"]),
             grad_rel=by_check[f"{function} eva_g fp32 S=677"]["grad_rel"],
             fwd_bwd_ms=by_check[f"{function} eva_g fp32 S=677"]["fwd_bwd_ms"],
             plain_fwd_bwd_ms=by_check[f"{function} eva_g fp32 S=677"]["plain_fwd_bwd_ms"])
        for kernel, function, source, replaces in (
            ("fused_vit_block", "FusedViTBlock", "sprc_tpu_torch/ops/fused_block.py",
             "sprc_tpu/ops/pallas_block.py:609"),
            ("fused_attn_block", "FusedAttnBlock", "sprc_tpu_torch/ops/fused_block.py",
             "sprc_tpu/ops/pallas_block.py:640"),
            ("fused_mlp_block", "FusedMlpBlock", "sprc_tpu_torch/ops/fused_block.py",
             "sprc_tpu/ops/pallas_mlp.py:129"),
            ("flash_attention", "FlashAttention", "sprc_tpu_torch/csrc/attention.cu",
             "sprc_tpu/ops/pallas_attention.py:428"))] + [
        # phase 12, BLIP-2 stage 2's caption evaluation at its batch of 16: K2 in
        # fp32 at 364 px, its fp32 attention call (launches: the tower's 39 and the
        # Q-Former's a batch) and K3's queries-only pass; launches: 12a's / 12b's
        entry(f"{kernel}_caption_{head}", source, replaces, [check],
              count=f"{kernel}_caption_{head}", library_ms=by_check[check].get("library_ms"))
        for head in ("opt", "t5")
        for kernel, source, replaces, check in (
            ("fused_vit_block", "sprc_tpu_torch/ops/fused_block.py",
             "sprc_tpu/ops/pallas_block.py:609", "K2 vit_block eva_g fp32 S=677 B=16"),
            ("attention_f32", "sprc_tpu_torch/csrc/attention.cu",
             "sprc_tpu/ops/pallas_attention.py:428", "attention D=88 fp32 S=677 B=16"),
            ("fused_qformer_layer", "sprc_tpu_torch/ops/fused_qformer.py",
             "sprc_tpu/ops/pallas_qformer.py:360", "K3 qformer_layer caption queries"))] + [
        # phase 13, BLIP-2 stage 2's training: the frozen tower without a graph, K2
        # in fp32 at 364 px and batch 16 (caption_coco_blip2_ft.yaml; the caption
        # path's checks) and in bf16 at 224 px and batch 32 (pretrain_stage2.yaml),
        # each with its attention call; launches: 13a's / 13b's
        entry(f"{kernel}_stage2_train_{head}", source, replaces, [check],
              count=f"{kernel}_stage2_train_{head}",
              library_ms=by_check[check].get("library_ms"))
        for head, attention, checks in (
            ("opt", "attention_f32", ("K2 vit_block eva_g fp32 S=677 B=16",
                                      "attention D=88 fp32 S=677 B=16")),
            ("t5", "attention_bf16", ("K2 vit_block eva_g B=32", "attention D=88 bf16 B=32")))
        for kernel, source, replaces, check in (
            ("fused_vit_block", "sprc_tpu_torch/ops/fused_block.py",
             "sprc_tpu/ops/pallas_block.py:609", checks[0]),
            (attention, "sprc_tpu_torch/csrc/attention.cu",
             "sprc_tpu/ops/pallas_attention.py:428", checks[1]))] + [
        # phase 13's zero-shot VQA at its batch of 16: K2 in bf16 at 224 px, its
        # attention call and K3's queries-only pass into 257 rows; launches: 13c's
        # / 13d's
        entry(f"{kernel}_vqa_{head}", source, replaces, [check], count=f"{kernel}_vqa_{head}",
              library_ms=by_check[check].get("library_ms"))
        for head in ("opt", "t5")
        for kernel, source, replaces, check in (
            ("fused_vit_block", "sprc_tpu_torch/ops/fused_block.py",
             "sprc_tpu/ops/pallas_block.py:609", "K2 vit_block eva_g B=16"),
            ("attention_bf16", "sprc_tpu_torch/csrc/attention.cu",
             "sprc_tpu/ops/pallas_attention.py:428", "attention D=88 bf16 B=16"),
            ("fused_qformer_layer", "sprc_tpu_torch/ops/fused_qformer.py",
             "sprc_tpu/ops/pallas_qformer.py:360", "K3 qformer_layer vqa queries"))] + [
        # phase 14, the LLaMA heads at their batch of 16: K2 in bf16 at 224 px
        # (training's tower calls: 2 x 8 images for the retrieval model, 8 for the
        # LM model), K3's queries-only pass and its fusion passes (queries and
        # 128 or 32 BERT tokens into 257 rows); launches: 14a's / 14b's, their
        # training steps' summed
        entry(f"fused_vit_block_instruct_{kind}", "sprc_tpu_torch/ops/fused_block.py",
              "sprc_tpu/ops/pallas_block.py:609", ["K2 vit_block eva_g B=16"],
              count=f"fused_vit_block_instruct_{kind}")
        for kind in ("retrieval", "generate", "train")] + [
        entry(f"fused_qformer_layer_instruct_{kind}", "sprc_tpu_torch/ops/fused_qformer.py",
              "sprc_tpu/ops/pallas_qformer.py:360", checks,
              count=f"fused_qformer_layer_instruct_{kind}")
        for kind, checks in (("retrieval", ["K3 qformer_layer vqa queries",
                                            "K3 qformer_layer instruct fusion L=128"]),
                             ("generate", ["K3 qformer_layer instruct fusion L=32"]))] + [
        # phase 15, PNP-VQA: K2 at BLIP's ViT-L/16 at 384 px (S = 577, D 64, exact
        # GELU, eps 1e-6, B = 4) and its bf16 attention call; launches: phase 15's
        # (48 blocks a batch: the ITM and the caption tower)
        entry(f"{kernel}_pnp", source, replaces, [check], count=f"{kernel}_pnp",
              library_ms=by_check[check].get("library_ms"))
        for kernel, source, replaces, check in (
            ("fused_vit_block", "sprc_tpu_torch/ops/fused_block.py",
             "sprc_tpu/ops/pallas_block.py:609", "K2 vit_block blip_l S=577 B=4"),
            ("attention_bf16", "sprc_tpu_torch/csrc/attention.cu",
             "sprc_tpu/ops/pallas_attention.py:428", "attention D=64 bf16 S=577 B=4"))] + [
        # phase 16, Img2Prompt-VQA: the same kernels at its two calls, the towers'
        # (B = 4) and the ITM filter's (B = 1), summed; launches: phase 16's
        # (predict_prompts and the CLI run)
        entry(f"{kernel}_img2prompt", source, replaces, [f"{check} B=4", f"{check} B=1"],
              count=f"{kernel}_img2prompt",
              library_ms=(None if by_check[f"{check} B=4"].get("library_ms") is None else
                          by_check[f"{check} B=4"]["library_ms"]
                          + by_check[f"{check} B=1"]["library_ms"]))
        for kernel, source, replaces, check in (
            ("fused_vit_block", "sprc_tpu_torch/ops/fused_block.py",
             "sprc_tpu/ops/pallas_block.py:609", "K2 vit_block blip_l S=577"),
            ("attention_bf16", "sprc_tpu_torch/csrc/attention.cu",
             "sprc_tpu/ops/pallas_attention.py:428", "attention D=64 bf16 S=577"))]


# phases 18 and 19: BLIP-1 / ALBEF's VQA (18) and the SNLI-VE / NLVR2 heads (19)
# through cli/train.py and cli/evaluate.py at full width (ViT-B/16 bf16 through
# K2, BERT-base med-BERTs fp32), random weights from the run's seed, the synthetic
# vocab, seeded PNG images. arch -> (run YAML, steps, model-section overrides):
# vqav2_albef_ft.yaml names no model type, so both packages build albef_vqa from
# the dataclass defaults, which do not distill; the override turns ALBEF's answer
# distillation on, the path this phase drives
HEAD_TRAIN = {"blip_vqa": ("vqav2_ft.yaml", 3, {}),
              "albef_vqa": ("vqav2_albef_ft.yaml", 3, {"use_distill": True}),
              "albef_classification": ("snli_ve_ft.yaml", 2, {}),
              "albef_nlvr": ("nlvr_ft.yaml", 2, {})}
HEAD_EVAL = {"rank": "eval/vqav2_eval.yaml", "generate": "eval/gqa_eval.yaml",
             "snli_ve": "eval/snli_ve_eval.yaml", "nlvr": "eval/nlvr_eval.yaml",
             "nlvr_albef": "eval/nlvr_albef_eval.yaml"}
HEAD_EVAL_ITEMS = 32  # questions, sentences or pairs an evaluation
VQA_ANSWER_LIST = 3129  # VQAv2's answer list's length (synthetic answers)
# K2 a step: the live tower's 12 blocks through FusedViTBlock, and the momentum
# tower's 12 without a graph where the head distills; an evaluation: 12 a batch
HEAD_STEP_LAUNCHES = {"blip_vqa": 12, "albef_vqa": 24, "albef_classification": 24,
                      "albef_nlvr": 24}
HEAD_BATCH_LAUNCHES = 12
# Bounds, fixed before the first reading. The steps against the all-plain steps
# of the same weights and batches (the same dropout masks: the trainer's
# generator, seeded alike; the med-BERTs run no kernel): the bf16 tower's rows
# differ by bf16 rounding through 12 blocks (phase 17's 2e-2 of a loss); the
# momentum copies move by 0.005 of two Adam steps (phase 17's 1e-4). The
# evaluations: the tower's rows, kernel against plain on the same pixels,
# within phase 15's rows bound; everything after the tower runs no kernel (the
# med-BERTs' attention is masked or under 128 rows), so the all-plain run from
# the kernel tower's rows gives the same answers, logits (within 1e-6) and
# metrics.
HEAD_BOUNDS = {"loss": 2e-2, "params_m": 1e-4, "rows": PNP_BOUNDS["rows"], "logits": 1e-6}


def _write_heads_data(root, kind, n, seed, split):
    """``n`` seeded items of ``kind`` (``vqa``: a question with weighted
    answers for training, ten typed answers for evaluation; ``snli_ve``: a
    sentence with a label of 3; ``nlvr``: a sentence over an image pair,
    True / False) over ``n`` PNG images of mixed sizes; the annotation path."""
    from sprc_tpu_torch.utils.artifacts import encode_png

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(160, 640, 2))
        names.append(f"{kind}{i:04d}.png")
        with open(os.path.join(root, names[-1]), "wb") as f:
            f.write(encode_png(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)))
    ann = []
    for i, name in enumerate(names):
        words = [str(x) for x in rng.choice(STAGE1_WORDS, 4, replace=False)]
        sentence = " ".join(str(x) for x in rng.choice(STAGE1_WORDS, 10))
        if kind == "vqa":
            item = {"image": name, "question": f"what is the {words[0]} near the {words[1]}",
                    "question_id": 18000 + i, "answer": words[1:]}
            if split != "train":
                item.update(answer=words[1], answers=[{"answer": words[1 + j % 3]}
                                                      for j in range(10)],
                            question_type="what is the", answer_type="other")
        elif kind == "snli_ve":
            item = {"image": name, "sentence": sentence, "label": int(rng.integers(3))}
        else:
            item = {"images": [name, names[(i + 1) % n]], "sentence": sentence,
                    "label": str(bool(rng.integers(2)))}
        ann.append(item)
    path = os.path.join(root, f"{split}.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return path


def _answer_list(seed):
    """VQA_ANSWER_LIST distinct synthetic answers of one to three words of the
    synthetic vocab (VQAv2's are mostly that short), the phase's words first."""
    rng = np.random.default_rng(seed)
    out, seen = list(STAGE1_WORDS), set(STAGE1_WORDS)
    while len(out) < VQA_ANSWER_LIST:
        answer = " ".join(f"tok{int(j)}" for j in rng.integers(0, 20000, int(rng.integers(1, 4))))
        if answer not in seen:
            seen.add(answer)
            out.append(answer)
    return out


def _cli_train_run(cfg, args):
    """cli/train.py on ``cfg`` with every step timed (each ends in a host
    read of its losses) and its launches counted, and the run's
    last_state.pt not written (4 to 6 GB of fp32 weights, AdamW moments and
    momentum copies: the card machine's disk takes 45 GiB of writes a call,
    and the earlier phases' checkpoints use most of them) -> a dict of the
    log's step rows, step ms, per-step launches, the run's launches, peak
    GiB, seconds, the skipped writes and the trainer."""
    from sprc_tpu_torch.cli import train as train_cli
    from sprc_tpu_torch.train import checkpoint, generic

    counters = _counters()

    def read():
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    real_step, real_save = generic.GenericTrainer.train_step, checkpoint.save_state
    out = {"times": [], "per_step": [], "skipped": []}

    def timed_step(self, batch):
        out["trainer"] = self
        before = read()
        t0 = time.perf_counter()
        metrics = real_step(self, batch)
        out["times"].append((time.perf_counter() - t0) * 1e3)
        out["per_step"].append({k: v - before[k] for k, v in read().items() if v != before[k]})
        return metrics

    generic.GenericTrainer.train_step = timed_step
    checkpoint.save_state = lambda path, trainer: out["skipped"].append(os.path.basename(path))
    try:
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_cli.train(cfg, args)
        sync()
        out["run_s"] = time.perf_counter() - t0
        out["launches"] = read()
        out["peak"] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        generic.GenericTrainer.train_step, checkpoint.save_state = real_step, real_save
    with open(os.path.join(args.output_dir, "log.jsonl")) as f:
        out["rows"] = [r for r in map(json.loads, f) if r["kind"] == "step"]
    return out


def phase_head_train(work, arch):
    """18a / 18b / 19a: one VQA or classification YAML through cli/train.py,
    then the same steps all-plain (phases 18 and 19 of the docstring)."""
    import argparse
    import shutil

    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.train import generic
    from sprc_tpu_torch.train.loop import TrainConfig
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    name, steps, model_over = HEAD_TRAIN[arch]
    tag = f"heads {arch}"
    t_phase = time.perf_counter()
    batch_size = RUN_CONFIGS[name]["run"]["batch_size"]
    (builder,) = RUN_CONFIGS[name]["datasets"]
    kind = {"coco_vqa": "vqa"}.get(builder, builder)
    root = os.path.join(work, f"heads_{arch}")
    ann = _write_heads_data(root, kind, batch_size * steps, SEED + 180, "train")
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    out = os.path.join(work, f"heads_{arch}_train")
    shutil.rmtree(out, ignore_errors=True)
    cfg, how = _run_config(name, {
        "run": {"max_epochs": 1, "seed": SEED, "log_freq": 1}, "model": model_over,
        "datasets": {builder: {"build_info": {"annotations": {"train": [ann]}, "images": root}}}})
    log(f"[{tag}] cli/train.py through {how}")
    args = argparse.Namespace(output_dir=out, vocab_path=vocab, model_path=None, resume=None,
                              device=DEVICE, data_path=None)
    run = _cli_train_run(cfg, args)
    k_rows, times, per_step, launches, peak, run_s, skipped = (run[k] for k in (
        "rows", "times", "per_step", "launches", "peak", "run_s", "skipped"))
    trainer = run.pop("trainer")
    k_aux = trainer.aux
    param_count = sum(p.numel() for p in trainer.model.parameters())
    del trainer, run
    log(f"[{tag}] {len(k_rows)} steps at batch {batch_size} ({param_count / 1e6:.1f} M "
        f"parameters): ms " + ", ".join(f"{t:.1f}" for t in times)
        + f"; samples/s (last step) {batch_size / times[-1] * 1e3:.2f}; peak {peak:.2f} GiB; "
        f"run {run_s:.1f} s; losses " + ", ".join(f"{r['loss']:.4f}" for r in k_rows))
    log(f"[{tag}] launches: {launches}; a step: {per_step}; state writes skipped: {skipped}")
    if len(k_rows) != steps or any(r["skipped_nonfinite"] for r in k_rows):
        raise RuntimeError(f"{tag}: steps {k_rows}")
    if not all(np.isfinite(r["loss"]) for r in k_rows):
        raise RuntimeError(f"{tag}: a loss is not finite: {k_rows}")
    if any(p.get("fused_vit_block") != HEAD_STEP_LAUNCHES[arch] for p in per_step):
        raise RuntimeError(f"{tag}: K2 launches a step {per_step}, expected "
                           f"{HEAD_STEP_LAUNCHES[arch]}")
    gc.collect()
    torch.cuda.empty_cache()

    # the all-plain run: the same weights (the run's seed), batches (the builder's
    # seeded transform and order) and dropout masks (the trainer's seeded generator)
    model_cfg = dict(cfg.model)
    model_cfg.pop("arch")
    model = load_model(arch, model_cfg.pop("model_type", "pretrain"), device=DEVICE, seed=SEED,
                       **model_cfg)
    tokenizer = BertWordPieceTokenizer.from_vocab_file(vocab)
    datasets = registry.get("dataset", builder)(dict(cfg.datasets[builder])).build()
    adapter = generic.TASK_ADAPTERS[cfg.run["task"]](
        tokenizer, max_txt_len=int(cfg.run["max_txt_len"])).specialize(model)
    task = generic.BuilderTask(datasets, adapter, batch_size=batch_size, seed=SEED, device=DEVICE)
    tcfg = TrainConfig(learning_rate=float(cfg.run["learning_rate"]),
                       weight_decay=float(cfg.run["weight_decay"]), total_steps=steps)
    plain = generic.GenericTrainer(model, tcfg, seed=SEED, adapter=adapter, skip_nonfinite=True,
                                   decay_frozen=True)
    if adapter.uses_aux:
        plain.aux = adapter.init_aux(model, plain.param_values())
    with primitives.plain_reference():
        p_rows = [plain.train_step(task.prepare_batch(b)) for b in task.train_loader(0)]
    sync()
    p_aux = plain.aux
    gaps = {"loss": max(abs(k["loss"] - p["loss"]) / max(abs(p["loss"]), 1e-6)
                        for k, p in zip(k_rows, p_rows)),
            "params_m": (_tree_gap(k_aux["params_m"], p_aux["params_m"]) if p_aux else 0.0)}
    momentum = len(p_aux["params_m"]) if p_aux else 0
    del model, plain, p_aux, k_aux
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] the kernel run against the all-plain run: losses {gaps['loss']:.3e} (bound "
        f"{HEAD_BOUNDS['loss']:.0e}), momentum copies ({momentum} tensors) "
        f"{gaps['params_m']:.3e} (bound {HEAD_BOUNDS['params_m']:.0e})")
    failed = [k for k, v in gaps.items() if not v <= HEAD_BOUNDS[k]]
    if failed or len(p_rows) != steps or (momentum == 0) != (HEAD_STEP_LAUNCHES[arch] == 12):
        raise RuntimeError(f"{tag}: against the all-plain run: beyond HEAD_BOUNDS {failed}, "
                           f"{len(p_rows)} steps, {momentum} momentum copies")
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"step_ms": times, "samples_per_s": batch_size / times[-1] * 1e3,
            "peak_memory_gib": peak, "losses": [r["loss"] for r in k_rows],
            "launches": launches, "launches_step": per_step,
            "k2_launches_per_step": per_step[-1].get("fused_vit_block"), "gaps": gaps,
            "seconds": seconds}


def phase_head_eval(work, which):
    """18c / 18d / 19b: one VQA or classification eval YAML through
    cli/evaluate.py over HEAD_EVAL_ITEMS seeded items, then all-plain from the
    kernel tower's rows."""
    import argparse

    from sprc_tpu_torch.cli import evaluate as evaluate_cli
    from sprc_tpu_torch.models.classification import MultimodalClassifier, _Deterministic
    from sprc_tpu_torch.models.nlvr import NLVRClassifier
    from sprc_tpu_torch.models.vqa import VQAModel
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    name = HEAD_EVAL[which]
    tag = f"heads eval {which}"
    t_phase = time.perf_counter()
    (builder,) = RUN_CONFIGS[name]["datasets"]
    kind = "vqa" if builder in ("coco_vqa", "gqa") else builder
    split = RUN_CONFIGS[name]["run"]["test_splits"][0]
    root = os.path.join(work, f"heads_eval_{kind}")
    ann = _write_heads_data(root, kind, HEAD_EVAL_ITEMS, SEED + 181, split)
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    over = {"run": {"seed": SEED},
            "datasets": {builder: {"build_info": {"annotations": {split: [ann]}, "images": root}}}}
    if kind == "vqa":
        over["run"]["answer_list"] = _answer_list(SEED + 182)
    cfg, how = _run_config(name, over)
    log(f"[{tag}] cli/evaluate.py through {how.split(' run.answer_list=')[0]}"
        + (f" run.answer_list=<{VQA_ANSWER_LIST} answers>" if kind == "vqa" else ""))
    counters = _counters()
    cls = VQAModel if kind == "vqa" else _Deterministic
    real_encode = cls.encode_image
    rows, row_gaps, runs = [], [], {}

    def record(self, images):  # the kernel run: its tower rows kept
        out = real_encode(self, images)
        rows.append(out.clone())
        return out

    def replay(self, images):  # the plain run: the plain tower held against them
        with primitives.plain_reference():
            plain = real_encode(self, images)
        kept = rows[len(row_gaps)]
        row_gaps.append(((plain - kept).abs().max().item(), (plain - kept).abs().mean().item()))
        return kept

    heads = [] if kind == "vqa" else [MultimodalClassifier, NLVRClassifier]
    for run_kind, encode in (("kernel", record), ("plain", replay)):
        logits = []
        real_predict = {c: c.predict for c in heads}

        def keep_logits(c):
            def predict(self, *a, **kw):
                out = real_predict[c](self, *a, **kw)
                logits.append(out.float().cpu())
                return out
            return predict

        cls.encode_image = encode
        for c in heads:
            c.predict = keep_logits(c)
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        stats = {}
        args = argparse.Namespace(model_path=None, vocab_path=vocab, split=None, device=DEVICE,
                                  output_dir=os.path.join(work, f"heads_eval_{which}_{run_kind}"))
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            if run_kind == "plain":
                with primitives.plain_reference():
                    metrics = evaluate_cli.evaluate(cfg, args, stats=stats)
            else:
                metrics = evaluate_cli.evaluate(cfg, args, stats=stats)
            sync()
            seconds = time.perf_counter() - t0
        finally:
            cls.encode_image = real_encode
            for c in heads:
                c.predict = real_predict[c]
        result_dir = os.path.join(args.output_dir, "result")
        (result,) = os.listdir(result_dir)
        with open(os.path.join(result_dir, result)) as f:
            answers = json.load(f)
        runs[run_kind] = {"metrics": metrics, "stats": stats, "seconds": seconds,
                          "answers": answers, "logits": logits,
                          "peak": torch.cuda.max_memory_allocated() / 2**30,
                          "launches": {k: getattr(o, a) for k, (o, a) in counters.items()
                                       if getattr(o, a)}}
        gc.collect()
        torch.cuda.empty_cache()
    k, p = runs["kernel"], runs["plain"]
    logit_gap = max([(a - b).abs().max().item() for a, b in zip(k["logits"], p["logits"])],
                    default=0.0)
    rows_max, rows_mean = (max(g[i] for g in row_gaps) for i in (0, 1))
    batches = -(-HEAD_EVAL_ITEMS // RUN_CONFIGS[name]["run"]["batch_size_eval"])
    for run_kind, run in runs.items():
        log(f"[{tag}] {run_kind}: {run['seconds']:.2f} s; by stage "
            + ", ".join(f"{s} {v:.3f}" for s, v in run["stats"].items())
            + f"; peak {run['peak']:.2f} GiB; launches {run['launches']}; metrics "
            f"{run['metrics']}; e.g. {[list(a.values())[1] for a in run['answers'][:3]]}")
    log(f"[{tag}] the tower's rows, kernel against plain on the same pixels: max "
        f"{rows_max:.3e}, mean {rows_mean:.3e} (bound {HEAD_BOUNDS['rows']}); from the kernel "
        f"tower's rows the all-plain answers {'equal' if k['answers'] == p['answers'] else 'DIFFER'}"
        f", logits max difference {logit_gap:.3e} (bound {HEAD_BOUNDS['logits']:.0e}), "
        f"metrics {'equal' if k['metrics'] == p['metrics'] else 'DIFFER'}; K2 "
        f"{HEAD_BATCH_LAUNCHES} a batch of {RUN_CONFIGS[name]['run']['batch_size_eval']}")
    want = HEAD_BATCH_LAUNCHES * batches
    if k["launches"].get("fused_vit_block") != want or p["launches"]:
        raise RuntimeError(f"{tag}: launches {k['launches']} (kernel), {p['launches']} (plain); "
                           f"expected {want} K2 and none")
    if (k["metrics"] != p["metrics"] or k["answers"] != p["answers"]
            or len(k["answers"]) != HEAD_EVAL_ITEMS or "agg_metrics" not in k["metrics"]
            or logit_gap > HEAD_BOUNDS["logits"] or rows_max > HEAD_BOUNDS["rows"][0]
            or rows_mean > HEAD_BOUNDS["rows"][1] or len(row_gaps) != len(rows)):
        raise RuntimeError(f"{tag}: the kernel evaluation disagrees with the all-plain one")
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"metrics": k["metrics"], "stages_s": k["stats"], "seconds_kernel": k["seconds"],
            "seconds_plain": p["seconds"], "peak_memory_gib": k["peak"],
            "launches": k["launches"], "rows_gap": [rows_max, rows_mean],
            "logits_gap": logit_gap, "seconds": seconds}


def heads_kernels(rows, train, evals):
    """The kernel rows of phases 18 and 19: K2 through FusedViTBlock at BLIP's
    VQA tower (B = 16, S = 901; its launches those of 18a and 18c / 18d), its
    bf16 attention and the block's four bf16 products at that shape; and K2
    at 384 px (S = 577, B = 32, the check phase 17 shares; launches: 18b and
    phase 19's)."""
    from sprc_tpu_torch.kernel_checks import VQA_PRODUCTS, VQA_SHAPE, bound_ms

    by_check = {r["check"]: r for r in rows}
    B, S = VQA_SHAPE
    at_901 = [train["blip_vqa"], evals["rank"], evals["generate"]]
    at_577 = [run for a, run in train.items() if a != "blip_vqa"] + [
        run for w, run in evals.items() if w not in ("rank", "generate")]

    def launches(runs, counter):
        return sum(run["launches"].get(counter, 0) for run in runs)

    def fvb_entry(label, check, runs):
        fvb = by_check[check]
        return {"name": f"fused_vit_block (FusedViTBlock, {label})", "route": "cuda",
                "source": "sprc_tpu_torch/ops/fused_block.py",
                "replaces": "sprc_tpu/ops/pallas_block.py:609",
                "launches": launches(runs, "fused_vit_block"),
                "max_abs_err": fvb["max_abs_err"], "ms": fvb["ms"], "plain_ms": fvb["plain_ms"],
                **bound_ms(fvb), "library_ms": None, "fwd_bwd_ms": fvb["fwd_bwd_ms"],
                "plain_fwd_bwd_ms": fvb["plain_fwd_bwd_ms"]}

    attn = by_check[f"attention D=64 bf16 blip_b S={S} B={B}"]
    gemms = [by_check[f"gemm bf16 {n} B={B}"] for n in VQA_PRODUCTS]
    work = {"bytes": sum(r["bytes"] for r in gemms),
            "op_seconds": sum(r["op_seconds"] for r in gemms)}
    return [
        fvb_entry("BLIP VQA, 480 px", f"FusedViTBlock blip_b bf16 S={S} B={B}", at_901),
        fvb_entry("ALBEF VQA, SNLI-VE, NLVR2, 384 px", "FusedViTBlock blip_b bf16 S=577 B=32",
                  at_577),
        {"name": "attention bf16 (BLIP VQA, 480 px)", "route": "cuda",
         "source": "sprc_tpu_torch/csrc/attention.cu",
         "replaces": "sprc_tpu/ops/pallas_attention.py:428",
         "launches": launches(at_901, "attention_bf16"), "max_abs_err": attn["max_abs_err"],
         "ms": attn["ms"], "plain_ms": attn["plain_ms"], **bound_ms(attn),
         "library_ms": attn["library_ms"]},
        {"name": "gemm bf16 (BLIP VQA, 480 px, a block's four products)", "route": "cuda",
         "source": "sprc_tpu_torch/csrc/gemm.cu", "replaces": "scripts/ablate_int8.py:194",
         "launches": launches(at_901, "gemm"),
         "max_abs_err": max(r["max_abs_err"] for r in gemms),
         "ms": sum(r["ms"] for r in gemms), "plain_ms": sum(r["plain_ms"] for r in gemms),
         **bound_ms(work), "library_ms": sum(r["library_ms"] for r in gemms)}]

# Phase 20, BLIP-1 captioning and the CIR feature extractor; phase 21, CLIP (both
# at full width, random weights from seed 0, the synthetic vocab, seeded PNG
# images). 20a: cli/train.py on caption_coco_ft.yaml (ViT-B/16) and
# caption_coco_large_ft.yaml (ViT-L/16), both at 384 px (S = 577) and the
# YAMLs' batch of 32, the tower trained through FusedViTBlock; 20b:
# cli/evaluate.py on eval/caption_coco_eval.yaml over CAPTION_EVAL_IMAGES;
# 20c: extract_features of blip_feature_extractor / base (ViT-B/16 at 224 px,
# the med-BERT's text pass through K3) on FEATURE_ITEMS images and captions.
CAPTION_TRAIN = {"base": ("caption_coco_ft.yaml", 3, 12),
                 "large": ("caption_coco_large_ft.yaml", 2, 24)}  # run, steps, K2 a step
CAPTION_EVAL = "eval/caption_coco_eval.yaml"
CAPTION_EVAL_IMAGES = 32
FEATURE_ITEMS = 64
# K2 a tower call: ViT-B 12 blocks, ViT-L 24; K3 a BlipCirBase text pass: 12 layers
TOWER_LAUNCHES = {"vit_b": 12, "vit_l": 24}
CIR_TEXT_LAUNCHES = 12
# 21: CLIP vit_large14_336 (fp32, S = 577) through cli/evaluate.py:
# exp_coco_ret_eval.yaml over CLIP_RET_SPLIT (images, captions an image) and
# imnet_zs_eval.yaml over CLIP_ZS_SPLIT (images, label-derived classes) at one
# batch of 64 (the YAML's 128 would pad the 64 images to 128); then
# extract_features of vit_base32 (S = 50) and resnet50 on CLIP_FEATURE_IMAGES
CLIP_RET = "eval/exp_coco_ret_eval.yaml"
CLIP_ZS = "eval/imnet_zs_eval.yaml"
CLIP_RET_SPLIT = (32, 5)
CLIP_ZS_SPLIT = (64, 50)
CLIP_FEATURE_IMAGES = 64
# Bounds, fixed before the first reading. 20a: the kernel run's losses against
# the all-plain run's on the same weights, batches and dropout masks, and one
# step's gradients (the tower's K2 launches stage by stage inside it), within
# TRAIN_BOUNDS["live"]; 20b, 21: the tower's rows (20b: bf16 ViT-B/16) or
# features (21: the fp32 tower, every product in 3xTF32 against true fp32:
# 24 blocks of VIT_F32_REL's 3e-6 at most, held at 1e-4 of the features'
# largest |value|) against the plain tower's on the same pixels; from the
# kernel tower's rows the all-plain run (the decoder, text tower and ranking
# run no kernel) gives the same captions, recalls and predictions.
CAPTION_ROW_BOUNDS = HEAD_BOUNDS["rows"]
CLIP_FEATURE_REL = 1e-4


def _write_labels(root, n, classes, seed):
    """``n`` seeded PNG images with labels 0..classes-1 (each class at least
    once: the labels are the zero-shot classes); the annotation path."""
    path = _write_pairs(root, n, 0, seed, "zs")
    with open(path) as f:
        ann = [{"image": a["image"], "label": i % classes} for i, a in enumerate(json.load(f))]
    with open(path, "w") as f:
        json.dump(ann, f)
    return path


def _images(n, size, seed):
    """``n`` seeded images [n, size, size, 3] float32 (the gallery's draws)."""
    return next(iter(_gallery_batches(n, n, size, seed)))[1]


# the layer-level kernels (each chain's primitives count apart)
LAYER_KERNELS = ("token_max_sim", "fused_vit_block", "fused_attn_block", "fused_mlp_block",
                 "flash_attention", "fused_qformer_layer", "fused_vit_block_i8",
                 "fused_qformer_layer_int8")


def _grads(model):
    named = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
    return [n for n, _ in named], [p.grad.detach().float().clone() for _, p in named]


def phase_caption_train(work, which):
    """20a: one BLIP-1 caption YAML through cli/train.py, then the same steps
    all-plain, and one step's gradients kernel against plain."""
    import argparse
    import shutil

    from sprc_tpu_torch import kernel_checks
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.train import generic
    from sprc_tpu_torch.train.loop import TrainConfig
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    name, steps, per_step_k2 = CAPTION_TRAIN[which]
    tag = f"caption train {which}"
    t_phase = time.perf_counter()
    batch_size = RUN_CONFIGS[name]["run"]["batch_size"]
    root = os.path.join(work, f"caption_{which}")
    ann = _write_pairs(root, batch_size * steps, 0, SEED + 200, "cap")
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    out = os.path.join(work, f"caption_{which}_train")
    shutil.rmtree(out, ignore_errors=True)
    cfg, how = _run_config(name, {
        "run": {"max_epochs": 1, "seed": SEED, "log_freq": 1},
        "datasets": {"coco_caption": {"build_info": {"annotations": {"train": [ann]},
                                                     "images": root}}}})
    log(f"[{tag}] cli/train.py through {how}")
    args = argparse.Namespace(output_dir=out, vocab_path=vocab, model_path=None, resume=None,
                              device=DEVICE, data_path=None)
    run = _cli_train_run(cfg, args)
    run.pop("trainer")
    k_rows, times, per_step, launches, peak, run_s, skipped = (run[k] for k in (
        "rows", "times", "per_step", "launches", "peak", "run_s", "skipped"))
    log(f"[{tag}] {len(k_rows)} steps at batch {batch_size}: ms "
        + ", ".join(f"{t:.1f}" for t in times)
        + f"; samples/s (last step) {batch_size / times[-1] * 1e3:.2f}; peak {peak:.2f} GiB; "
        f"run {run_s:.1f} s; losses " + ", ".join(f"{r['loss']:.4f}" for r in k_rows))
    log(f"[{tag}] launches: {launches}; a step: {per_step}; state writes skipped: {skipped}")
    if len(k_rows) != steps or any(r["skipped_nonfinite"] for r in k_rows) or not all(
            np.isfinite(r["loss"]) for r in k_rows):
        raise RuntimeError(f"{tag}: steps {k_rows}")
    if any(p.get("fused_vit_block") != per_step_k2 for p in per_step):
        raise RuntimeError(f"{tag}: K2 launches a step {per_step}, expected {per_step_k2} "
                           "(one FusedViTBlock a block)")
    gc.collect()
    torch.cuda.empty_cache()

    # the all-plain run: the same weights (the run's seed), batches and dropout masks
    model_cfg = dict(cfg.model)
    model_cfg.pop("arch")
    model_type = model_cfg.pop("model_type", "pretrain")
    model = load_model("blip_caption", model_type, device=DEVICE, seed=SEED, **model_cfg)
    tokenizer = BertWordPieceTokenizer.from_vocab_file(vocab)
    datasets = registry.get("dataset", "coco_caption")(dict(cfg.datasets["coco_caption"])).build()
    adapter = generic.TASK_ADAPTERS["captioning"](
        tokenizer, max_txt_len=int(cfg.run["max_txt_len"])).specialize(model)
    task = generic.BuilderTask(datasets, adapter, batch_size=batch_size, seed=SEED, device=DEVICE)
    first = task.prepare_batch(next(iter(task.train_loader(0))))
    # one step's gradients from the same weights, batch and dropout masks: the
    # kernel forward with its K2 launches stage by stage, then all-plain
    model.train()
    grads, stages = {}, kernel_checks.StageRecorder()
    for kind in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        with contextlib.ExitStack() as stack:
            stack.enter_context(primitives.stage_check(stages) if kind == "kernel"
                                else primitives.plain_reference())
            loss = adapter.forward(model, first, gen)["loss"]
            loss.backward()
        sync()
        grads[kind] = (loss.item(), *_grads(model))
    model.zero_grad(set_to_none=True)
    (k_loss, names, k_grads), (p_loss, _, p_grads) = grads["kernel"], grads["plain"]
    grad = kernel_checks.grad_gap(k_grads, p_grads, names)
    del grads, k_grads, p_grads
    # the all-plain steps, over batches drawn again (the train processor's
    # random crops and RandAugment draw from its own seeded state)
    datasets = registry.get("dataset", "coco_caption")(dict(cfg.datasets["coco_caption"])).build()
    task = generic.BuilderTask(datasets, adapter, batch_size=batch_size, seed=SEED, device=DEVICE)
    tcfg = TrainConfig(learning_rate=float(cfg.run["learning_rate"]),
                       weight_decay=float(cfg.run["weight_decay"]), total_steps=steps)
    plain = generic.GenericTrainer(model, tcfg, seed=SEED, adapter=adapter, skip_nonfinite=True,
                                   decay_frozen=True)
    with primitives.plain_reference():
        p_rows = [plain.train_step(task.prepare_batch(b)) for b in task.train_loader(0)]
    sync()
    del model, plain
    gc.collect()
    torch.cuda.empty_cache()
    bound = TRAIN_BOUNDS["live"]
    gaps = {"loss": max(abs(k["loss"] - p["loss"]) / max(abs(p["loss"]), 1e-6)
                        for k, p in zip(k_rows, p_rows)),
            "step_loss": abs(k_loss - p_loss) / max(abs(p_loss), 1e-6), "grad": grad["gap"]}
    for row in stages.rows():
        log(f"[{tag}] one step's tower, stage by stage: {row['kind']}: {row['calls']} calls, "
            f"worst share that differs {row['differ']:.3e}, worst difference {row['err']:.3e} -> "
            f"{'ok' if row['ok'] else 'FAIL'}")
    log(f"[{tag}] all-plain losses " + ", ".join(f"{r['loss']:.6f}" for r in p_rows)
        + "; the kernel run's " + ", ".join(f"{r['loss']:.6f}" for r in k_rows))
    log(f"[{tag}] the kernel run against the all-plain run: losses {gaps['loss']:.3e}, one "
        f"step's loss {gaps['step_loss']:.3e} (bound {bound['loss']:.0e}), its gradients "
        f"{grad['gap']:.3e} (bound {bound['grad']}; worst {grad['worst']})")
    if (not stages.ok() or max(gaps["loss"], gaps["step_loss"]) > bound["loss"]
            or grad["gap"] > bound["grad"] or len(p_rows) != steps):
        raise RuntimeError(f"{tag}: against the all-plain run {gaps}, stages ok "
                           f"{stages.ok()}, {len(p_rows)} steps")
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"step_ms": times, "samples_per_s": batch_size / times[-1] * 1e3,
            "peak_memory_gib": peak, "losses": [r["loss"] for r in k_rows],
            "launches": launches, "launches_step": per_step, "gaps": gaps,
            "stages": stages.rows(), "seconds": seconds}


@contextlib.contextmanager
def _record_replay(cls, method, rows, gaps):
    """``cls.method`` recorded (the kernel run: its outputs kept) while the
    context's ``mode[0]`` is "kernel", replayed (the plain run: the plain
    method's output held against the kept one, the kept one returned)
    otherwise."""
    from sprc_tpu_torch.ops import primitives

    real = getattr(cls, method)
    mode = ["kernel"]

    def wrapped(self, *a, **kw):
        if mode[0] == "kernel":
            out = real(self, *a, **kw)
            rows.append(out.clone())
            return out
        with primitives.plain_reference():
            plain = real(self, *a, **kw)
        kept = rows[len(gaps)]
        d = (plain.float() - kept.float()).abs()
        gaps.append((d.max().item(), d.mean().item(), kept.float().abs().max().item()))
        return kept

    setattr(cls, method, wrapped)
    try:
        yield mode
    finally:
        setattr(cls, method, real)


def _eval_twice(tag, cfg, work, name, vocab, cls, method, counters):
    """cli/evaluate.py on ``cfg`` with the kernels, then all-plain from the
    kernel run's ``cls.method`` outputs -> (runs, rows gaps)."""
    import argparse

    from sprc_tpu_torch.cli import evaluate as evaluate_cli
    from sprc_tpu_torch.ops import primitives

    rows, gaps, runs = [], [], {}
    with _record_replay(cls, method, rows, gaps) as mode:
        for kind in ("kernel", "plain"):
            mode[0] = kind
            for obj, attr in counters.values():
                setattr(obj, attr, 0)
            stats = {}
            args = argparse.Namespace(model_path=None, vocab_path=vocab, split=None,
                                      device=DEVICE,
                                      output_dir=os.path.join(work, f"{name}_{kind}"))
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                if kind == "plain":
                    stack.enter_context(primitives.plain_reference())
                metrics = evaluate_cli.evaluate(cfg, args, stats=stats)
            sync()
            seconds = time.perf_counter() - t0
            result_dir = os.path.join(args.output_dir, "result")
            results = []
            if os.path.isdir(result_dir):
                for fname in sorted(os.listdir(result_dir)):
                    with open(os.path.join(result_dir, fname)) as f:
                        results.append(json.load(f))
            runs[kind] = {"metrics": metrics, "stats": stats, "seconds": seconds,
                          "results": results, "peak": torch.cuda.max_memory_allocated() / 2**30,
                          "launches": {k: getattr(o, a) for k, (o, a) in counters.items()
                                       if getattr(o, a)}}
            log(f"[{tag}] {kind}: {seconds:.2f} s; by stage "
                + ", ".join(f"{s} {v:.3f}" for s, v in stats.items())
                + f"; peak {runs[kind]['peak']:.2f} GiB; launches {runs[kind]['launches']}; "
                f"metrics {metrics}")
            gc.collect()
            torch.cuda.empty_cache()
    if len(gaps) != len(rows) or not rows:
        raise RuntimeError(f"{tag}: {len(rows)} kernel tower calls, {len(gaps)} replayed")
    return runs, [max(g[i] for g in gaps) for i in range(3)]


def phase_caption_eval(work):
    """20b: cli/evaluate.py on eval/caption_coco_eval.yaml, then all-plain
    from the kernel tower's rows."""
    from sprc_tpu_torch.models.blip1 import BlipCaption
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    tag = "caption eval"
    t_phase = time.perf_counter()
    root = os.path.join(work, "caption_eval")
    ann = _write_pairs(root, CAPTION_EVAL_IMAGES, 5, SEED + 201, "ce")
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    cfg, how = _run_config(CAPTION_EVAL, {
        "run": {"seed": SEED},
        "datasets": {"coco_caption": {"build_info": {"annotations": {"test": [ann]},
                                                     "images": root}}}})
    log(f"[{tag}] cli/evaluate.py through {how}")
    counters = _counters()
    runs, (rows_max, rows_mean, _) = _eval_twice(tag, cfg, work, "caption_eval", vocab,
                                                 BlipCaption, "encode_image", counters)
    k, p = runs["kernel"], runs["plain"]
    batches = -(-CAPTION_EVAL_IMAGES // RUN_CONFIGS[CAPTION_EVAL]["run"]["batch_size_eval"])
    want = TOWER_LAUNCHES["vit_b"] * batches
    ms_token = 1e3 * k["stats"]["decode"] / max(k["stats"]["steps"], 1)
    captions = [r["caption"] for r in k["results"][0]] if k["results"] else []
    log(f"[{tag}] the tower's rows, kernel against plain on the same pixels: max "
        f"{rows_max:.3e}, mean {rows_mean:.3e} (bound {CAPTION_ROW_BOUNDS}); from the kernel "
        f"tower's rows the all-plain captions "
        f"{'equal' if k['results'] == p['results'] else 'DIFFER'}, metrics "
        f"{'equal' if k['metrics'] == p['metrics'] else 'DIFFER'}; decode {ms_token:.2f} ms a "
        f"token ({k['stats']['steps']} steps of 16 rows); K2 {want} expected; e.g. {captions[:2]}")
    if k["launches"].get("fused_vit_block") != want or p["launches"]:
        raise RuntimeError(f"{tag}: launches {k['launches']} (kernel), {p['launches']} (plain); "
                           f"expected {want} K2 and none")
    if (k["results"] != p["results"] or k["metrics"] != p["metrics"]
            or len(captions) != CAPTION_EVAL_IMAGES or "agg_metrics" not in k["metrics"]
            or rows_max > CAPTION_ROW_BOUNDS[0] or rows_mean > CAPTION_ROW_BOUNDS[1]):
        raise RuntimeError(f"{tag}: the kernel evaluation disagrees with the all-plain one")
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"metrics": k["metrics"], "stages_s": k["stats"], "ms_per_token": ms_token,
            "seconds_kernel": k["seconds"], "seconds_plain": p["seconds"],
            "peak_memory_gib": k["peak"], "launches": k["launches"],
            "rows_gap": [rows_max, rows_mean], "seconds": seconds}


def _features_pass(tag, model, samples, tokenizer, counters, modes, want):
    """``extract_features`` in ``modes`` with the kernels (the layer kernels'
    launches checked against ``want``), once more stage by stage and
    all-plain: -> (features, every counter that moved, stage rows, the
    free-running gaps, seconds)."""
    from sprc_tpu_torch import kernel_checks
    from sprc_tpu_torch.features import extract_features
    from sprc_tpu_torch.ops import primitives

    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    t0 = time.perf_counter()
    got = {m: extract_features(model, samples, m, tokenizer=tokenizer) for m in modes}
    sync()
    seconds = time.perf_counter() - t0
    launches = {k: getattr(o, a) for k, (o, a) in counters.items() if getattr(o, a)}
    layers = {k: v for k, v in launches.items() if k in LAYER_KERNELS}
    stages = kernel_checks.StageRecorder()
    with primitives.stage_check(stages):
        for m in modes:
            extract_features(model, samples, m, tokenizer=tokenizer)
    sync()
    with primitives.plain_reference():
        plain = {m: extract_features(model, samples, m, tokenizer=tokenizer) for m in modes}
    free = {}
    for m in modes:
        for field in ("image_embeds_proj", "text_embeds_proj"):
            a, b = getattr(got[m], field), getattr(plain[m], field)
            if a is not None:
                free[f"{m} {field}"] = float(np.abs(a - b).max())
    log(f"[{tag}] extract_features {modes}: {seconds:.2f} s; launches {launches} (layers: "
        f"{want} expected); the all-plain features, max |difference| {free}")
    for row in stages.rows():
        log(f"[{tag}] stage by stage: {row['kind']}: {row['calls']} calls, worst share that "
            f"differs {row['differ']:.3e}, worst difference {row['err']:.3e} -> "
            f"{'ok' if row['ok'] else 'FAIL'}")
    if layers != want or (want and not stages.ok()) or (not want and launches):
        raise RuntimeError(f"{tag}: launches {launches} (expected {want}), stages ok "
                           f"{stages.ok()}")
    return got, launches, stages.rows(), free, seconds


def phase_cir_features(work):
    """20c: extract_features of blip_feature_extractor / base."""
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    tag = "cir features"
    t_phase = time.perf_counter()
    model = load_model("blip_feature_extractor", "base", device=DEVICE, seed=SEED)
    tokenizer = BertWordPieceTokenizer.from_vocab_file(
        write_synthetic_bert_vocab(os.path.join(work, "vocab.txt")))
    rng = np.random.default_rng(SEED + 202)
    cfg = model.cfg
    samples = {"image": _images(FEATURE_ITEMS, 224, SEED + 203),
               "text_input": [" ".join(rng.choice(STAGE1_WORDS, int(rng.integers(4, 30))))
                              for _ in range(FEATURE_ITEMS)],
               "prompts": (0.02 * rng.standard_normal(
                   (FEATURE_ITEMS, cfg.num_prompts, cfg.text_config().hidden_size))).astype(
                       np.float32)}
    counters = _counters()
    want = {"fused_vit_block": TOWER_LAUNCHES["vit_b"], "fused_qformer_layer": CIR_TEXT_LAUNCHES}
    got, launches, stages, free, seconds = _features_pass(
        tag, model, samples, tokenizer, counters, ("image", "text"), want)
    feats = (got["image"].image_embeds_proj, got["text"].text_embeds_proj)
    ok = all(f.shape == (FEATURE_ITEMS, cfg.embed_dim) and np.isfinite(f).all()
             and np.allclose(np.linalg.norm(f, axis=1), 1.0, atol=1e-4) for f in feats)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise RuntimeError(f"{tag}: features not unit rows of [{FEATURE_ITEMS}, {cfg.embed_dim}]")
    total = time.perf_counter() - t_phase
    log(f"[{tag}] phase {total:.1f} s")
    return {"launches": launches, "stages": stages, "free_running": free,
            "extract_s": seconds, "seconds": total}


def phase_clip_eval(work, which):
    """21: CLIP's retrieval or zero-shot evaluation through cli/evaluate.py,
    then all-plain from the kernel tower's features; one batch stage by stage."""
    from sprc_tpu_torch.models.clip import Clip
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    name = CLIP_RET if which == "retrieval" else CLIP_ZS
    tag = f"clip {which}"
    t_phase = time.perf_counter()
    root = os.path.join(work, f"clip_{which}")
    if which == "retrieval":
        n, captions = CLIP_RET_SPLIT
        ann = _write_pairs(root, n, captions, SEED + 210, "cr")
        over = {"datasets": {"coco_retrieval": {"build_info": {
            "annotations": {"test": [ann]}, "images": root}}}}
    else:
        n, classes = CLIP_ZS_SPLIT
        ann = _write_labels(root, n, classes, SEED + 211)
        over = {"run": {"batch_size_eval": n}, "datasets": {"imagenet": {"build_info": {
            "annotations": {"val": [ann]}, "images": root}}}}
    over.setdefault("run", {})["seed"] = SEED
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    cfg, how = _run_config(name, over)
    log(f"[{tag}] cli/evaluate.py through {how}")
    counters = _counters()
    runs, (f_max, f_mean, f_top) = _eval_twice(tag, cfg, work, f"clip_{which}", vocab, Clip,
                                               "encode_image", counters)
    k, p = runs["kernel"], runs["plain"]
    want = TOWER_LAUNCHES["vit_l"] * (1 if which == "zero_shot" else -(-n // 64))
    log(f"[{tag}] the tower's features, kernel against plain on the same pixels: max "
        f"{f_max:.3e} of {f_top:.3e} ({f_max / f_top:.3e}; bound {CLIP_FEATURE_REL:.0e}), mean "
        f"{f_mean:.3e}; from the kernel tower's features the all-plain results "
        f"{'equal' if k['results'] == p['results'] else 'DIFFER'}, metrics "
        f"{'equal' if k['metrics'] == p['metrics'] else 'DIFFER'}; K2 {want} expected")
    if k["launches"].get("fused_vit_block") != want or p["launches"]:
        raise RuntimeError(f"{tag}: launches {k['launches']} (kernel), {p['launches']} (plain); "
                           f"expected {want} K2 and none")
    if (k["results"] != p["results"] or k["metrics"] != p["metrics"]
            or "agg_metrics" not in k["metrics"] or f_max > CLIP_FEATURE_REL * f_top):
        raise RuntimeError(f"{tag}: the kernel evaluation disagrees with the all-plain one")
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"metrics": k["metrics"], "stages_s": k["stats"], "seconds_kernel": k["seconds"],
            "seconds_plain": p["seconds"], "peak_memory_gib": k["peak"],
            "launches": k["launches"], "features_gap": [f_max, f_mean, f_top],
            "seconds": seconds}


def phase_clip_features(work):
    """21: extract_features of CLIP vit_base32 (K2 at S = 50) and resnet50 (no
    kernel) on CLIP_FEATURE_IMAGES images; the CLIP ViT-L/14-336 tower's one
    batch stage by stage."""
    from sprc_tpu_torch.loader import load_model

    tag = "clip features"
    t_phase = time.perf_counter()
    counters = _counters()
    out = {}
    for model_type, want in (("vit_base32", {"fused_vit_block": TOWER_LAUNCHES["vit_b"]}),
                             ("resnet50", {})):
        model = load_model("clip", model_type, device=DEVICE, seed=SEED)
        samples = {"image": _images(CLIP_FEATURE_IMAGES, 224, SEED + 212)}
        got, launches, stages, free, seconds = _features_pass(
            f"{tag} {model_type}", model, samples, None, counters, ("image",), want)
        feats = got["image"].image_embeds_proj
        if feats.shape != (CLIP_FEATURE_IMAGES, model.cfg.embed_dim) or not np.isfinite(
                feats).all():
            raise RuntimeError(f"{tag} {model_type}: features {feats.shape}")
        out[model_type] = {"launches": launches, "stages": stages, "free_running": free,
                           "extract_s": seconds}
        del model
        gc.collect()
        torch.cuda.empty_cache()
    # the ViT-L/14-336 tower of 21's evaluations, one 32-image batch stage by stage
    model = load_model("clip", "vit_large14_336", device=DEVICE, seed=SEED)
    images = torch.from_numpy(_images(CLIP_RET_SPLIT[0], 336, SEED + 213)).to(DEVICE)
    out["vit_large14_336_stages"] = stage_pass(tag, "a 32-image ViT-L/14-336 batch", counters,
                                               lambda: model.encode_image(images))
    del model, images
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[{tag}] phase {out['seconds']:.1f} s")
    return out


def caption_clip_kernels(rows, caption_train, caption_eval, cir, clip_eval, clip_feats):
    """The kernel rows of phases 20 and 21: K2 through FusedViTBlock at the
    captioners' towers (its launches 20a's), K2 without a graph at the
    caption evaluation's and the CIR extractor's shapes (20b, 20c), K3 at the
    extractor's text pass (20c), K2 in fp32 at CLIP ViT-L/14-336 and ViT-B/32
    and the fp32 attention of its chain (21), the ViT-L captioner's bf16
    attention (20a)."""
    from sprc_tpu_torch.kernel_checks import bound_ms

    by_check = {r["check"]: r for r in rows}

    def entry(name, check, launches, source, replaces, library=True):
        r = by_check[check]
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], **bound_ms(r),
               "library_ms": r.get("library_ms") if library else None}
        if "fwd_bwd_ms" in r:
            out.update(fwd_bwd_ms=r["fwd_bwd_ms"], plain_fwd_bwd_ms=r["plain_fwd_bwd_ms"])
        return out

    k2 = ("sprc_tpu_torch/ops/fused_block.py", "sprc_tpu/ops/pallas_block.py:609")
    k3 = ("sprc_tpu_torch/ops/fused_qformer.py", "sprc_tpu/ops/pallas_qformer.py:360")
    k8 = ("sprc_tpu_torch/csrc/attention.cu", "sprc_tpu/ops/pallas_attention.py:428")
    clip_l = sum(r["launches"].get("fused_vit_block", 0) for r in clip_eval.values())
    clip_attn = sum(r["launches"].get("attention_f32", 0) for r in clip_eval.values())
    return [
        entry("fused_vit_block (FusedViTBlock, BLIP-1 caption ViT-B/16, 384 px)",
              "FusedViTBlock blip_b bf16 S=577 B=32",
              caption_train["base"]["launches"]["fused_vit_block"], *k2, library=False),
        entry("fused_vit_block (FusedViTBlock, BLIP-1 caption ViT-L/16, 384 px)",
              "FusedViTBlock blip_l bf16 S=577 B=32",
              caption_train["large"]["launches"]["fused_vit_block"], *k2, library=False),
        entry("attention bf16 (BLIP-1 caption ViT-L/16, 384 px)",
              "attention D=64 bf16 blip_l S=577 B=32",
              caption_train["large"]["launches"]["attention_bf16"], *k8),
        entry("fused_vit_block (BLIP-1 caption evaluation, ViT-B/16, 384 px)",
              "K2 vit_block blip_b S=577 B=16", caption_eval["launches"]["fused_vit_block"], *k2,
              library=False),
        entry("fused_vit_block (BLIP-1 CIR feature extractor, ViT-B/16, 224 px)",
              "K2 vit_block blip_b S=197 B=64", cir["launches"]["fused_vit_block"], *k2,
              library=False),
        entry("fused_qformer_layer (BLIP-1 CIR feature extractor's text pass)",
              "K3 qformer_layer cir text", cir["launches"]["fused_qformer_layer"], *k3,
              library=False),
        entry("fused_vit_block (CLIP ViT-L/14-336, fp32)", "K2 vit_block vit_l fp32 S=577 B=32",
              clip_l, *k2, library=False),
        entry("attention f32 (CLIP ViT-L/14-336)", "attention D=64 fp32 S=577 B=32", clip_attn,
              *k8),
        entry("fused_vit_block (CLIP ViT-B/32, S = 50, fp32)", "K2 vit_block clip_b fp32 S=50 B=64",
              clip_feats["vit_base32"]["launches"]["fused_vit_block"], *k2, library=False),
        entry("attention f32 (CLIP ViT-B/32, S = 50)", "attention D=64 fp32 S=50 B=64",
              clip_feats["vit_base32"]["launches"]["attention_f32"], *k8)]


# Phase 22, the video families (ALPRO: the TimeSformer ViT-B/16 over 8 frames
# at 224 px and the BERT-base med-BERT, both fp32 as the YAMLs give them; random
# weights from seed 0, the synthetic vocab, seeded clips). 22a / 22b:
# cli/train.py on msrvtt_retrieval_ft.yaml and msrvtt_qa_ft.yaml (its model
# YAML's 1500 classes and 16 time rows, 8 frames sampled) at the YAMLs' batch of
# 16, VIDEO_STEPS steps; 22c / 22d: cli/evaluate.py on eval/msrvtt_ret_eval.yaml
# (VIDEO_EVAL_CLIPS clips x VIDEO_EVAL_CAPTIONS captions, k_test VIDEO_K_TEST)
# and eval/msvd_qa_eval.yaml (VIDEO_EVAL_CLIPS questions over 2423 synthetic
# answers). Cut for the run's time: the evaluations read 32 clips, not a split.
# The clips are seeded uint8 [8, 240, 320, 3] .npy files, one of each split a
# directory of PNG frames (read through PIL); the processors resize them.
VIDEO_TRAIN = {"retrieval": "msrvtt_retrieval_ft.yaml", "qa": "msrvtt_qa_ft.yaml"}
VIDEO_EVAL = {"retrieval": "eval/msrvtt_ret_eval.yaml", "qa": "eval/msvd_qa_eval.yaml"}
VIDEO_STEPS = 3
VIDEO_EVAL_CLIPS = 32
VIDEO_EVAL_CAPTIONS = 2
VIDEO_K_TEST = 16
VIDEO_SOURCE = (8, 240, 320)  # a synthetic clip's frames, height, width
VIDEO_ANSWERS = 2423  # MSVD-QA's answer vocabulary (synthetic answers)
# K8 a TimeSformer call: the spatial attention of each of its 12 blocks (the
# temporal one, 8 rows, stays under the kernel's 128-row floor); each launch also
# counts as an fp32 attention launch (attention_f32)
VIDEO_TOWER_K8 = 12
VIDEO_EVAL_BATCH = {"retrieval": 4, "qa": 8}  # clips a tower call
# Bounds, fixed before the first reading: the steps against the all-plain steps
# of the same weights, batches, dropout masks and hard negatives, and one step's
# gradients (every K8 launch stage by stage inside it), within
# TRAIN_BOUNDS["live"]; the evaluations' video rows (the fp32 tower, K8 in
# 3xTF32 against true fp32 in 12 blocks) within CLIP_FEATURE_REL of their
# largest |value|, and from the kernel tower's rows the all-plain recalls and
# predictions equal (the text pass, the fusion and the rescoring run no kernel).
VIDEO_ROW_REL = CLIP_FEATURE_REL


def _write_clips(root, n, seed, kind, split):
    """``n`` seeded clips under ``root`` (uint8 VIDEO_SOURCE .npy files, the
    first one a directory of PNG frames) with ``kind``'s annotations
    (``retrieval``: one caption a clip for training, VIDEO_EVAL_CAPTIONS for
    evaluation; ``qa``: a question and its answers); the annotation path."""
    from sprc_tpu_torch.utils.artifacts import encode_png

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    ann = []
    for i in range(n):
        clip = rng.integers(0, 256, (*VIDEO_SOURCE, 3), dtype=np.uint8)
        name = f"{kind}_{split}_{i:04d}"
        if i == 0:
            os.makedirs(os.path.join(root, name), exist_ok=True)
            for t, frame in enumerate(clip):
                with open(os.path.join(root, name, f"{t:03d}.png"), "wb") as f:
                    f.write(encode_png(frame))
        else:
            name += ".npy"
            np.save(os.path.join(root, name), clip)
        words = [str(x) for x in rng.choice(STAGE1_WORDS, 8)]
        if kind == "retrieval":
            caps = [" ".join(rng.choice(STAGE1_WORDS, int(rng.integers(5, 20))))
                    for _ in range(1 if split == "train" else VIDEO_EVAL_CAPTIONS)]
            ann.append({"video": name, "caption": caps[0] if split == "train" else caps,
                        "image_id": f"clip{i}"})
        else:
            answers = words[1:4] if split == "train" else words[1]
            ann.append({"video": name, "question": f"what is the {words[0]} doing", 
                        "answer": answers, "question_id": 22000 + i})
    path = os.path.join(root, f"{split}.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return path


@contextlib.contextmanager
def _negatives_tape(tape, moved=None):
    """ALPRO's hard negatives recorded (``moved`` None: each draw kept in
    ``tape``) or replayed (the generator draws as before, so that the dropout
    masks after it stay aligned, and the recorded picks are returned;
    ``moved`` counts the picks that the run's own draw would have changed)."""
    from sprc_tpu_torch.models import alpro

    real, calls = alpro.sample_negatives, [0]

    def record(weights, generator):
        picks = real(weights, generator)
        tape.append(picks.clone())
        return picks

    def replay(weights, generator):
        own, picks = real(weights, generator), tape[calls[0]]
        calls[0] += 1
        moved.append(int((own != picks).sum()))
        return picks

    alpro.sample_negatives = record if moved is None else replay
    try:
        yield
    finally:
        alpro.sample_negatives = real


def _video_launches(tag, launches, want, what):
    """``launches`` (counter -> launches) holds K8's ``want`` and as many
    fp32 attention launches (K8's own), and nothing else."""
    moved = {k: v for k, v in launches.items() if v}
    if moved != {"flash_attention": want, "attention_f32": want}:
        raise RuntimeError(f"{tag}: launches {moved} ({what}), expected K8 {want}")


def phase_video_train(work, kind):
    """22a / 22b: one ALPRO YAML through cli/train.py, one step's gradients
    kernel against plain (K8 stage by stage), then the same steps all-plain."""
    import argparse
    import shutil

    from sprc_tpu_torch import kernel_checks
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.train import generic
    from sprc_tpu_torch.train.loop import TrainConfig
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    name = VIDEO_TRAIN[kind]
    tag = f"video train {kind}"
    t_phase = time.perf_counter()
    batch_size = RUN_CONFIGS[name]["run"]["batch_size"]
    (builder,) = RUN_CONFIGS[name]["datasets"]
    root = os.path.join(work, f"video_{kind}")
    ann = _write_clips(root, batch_size * VIDEO_STEPS, SEED + 220, kind, "train")
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    out = os.path.join(work, f"video_{kind}_train")
    shutil.rmtree(out, ignore_errors=True)
    # the train processor seeded, so that the all-plain run sees the same crops
    cfg, how = _run_config(name, {
        "run": {"max_epochs": 1, "seed": SEED, "log_freq": 1},
        "datasets": {builder: {"build_info": {"annotations": {"train": [ann]}, "videos": root},
                               "vis_processor": {"train": {"seed": SEED + 221}}}}})
    log(f"[{tag}] cli/train.py through {how}")
    args = argparse.Namespace(output_dir=out, vocab_path=vocab, model_path=None, resume=None,
                              device=DEVICE, data_path=None)
    tape = []
    with _negatives_tape(tape):
        run = _cli_train_run(cfg, args)
    params = sum(p.numel() for p in run.pop("trainer").model.parameters())
    k_rows, times, per_step, launches, peak, run_s, skipped = (run[k] for k in (
        "rows", "times", "per_step", "launches", "peak", "run_s", "skipped"))
    log(f"[{tag}] {len(k_rows)} steps at batch {batch_size} ({params / 1e6:.1f} M parameters): "
        "ms " + ", ".join(f"{t:.1f}" for t in times)
        + f"; samples/s (last step) {batch_size / times[-1] * 1e3:.2f}; peak {peak:.2f} GiB; "
        f"run {run_s:.1f} s; losses " + ", ".join(f"{r['loss']:.4f}" for r in k_rows))
    log(f"[{tag}] launches: {launches}; a step: {per_step}; state writes skipped: {skipped}")
    if len(k_rows) != VIDEO_STEPS or any(r["skipped_nonfinite"] for r in k_rows) or not all(
            np.isfinite(r["loss"]) for r in k_rows):
        raise RuntimeError(f"{tag}: steps {k_rows}")
    for i, step in enumerate(per_step):
        _video_launches(tag, step, VIDEO_TOWER_K8, f"step {i}")
    _video_launches(tag, launches, VIDEO_TOWER_K8 * VIDEO_STEPS, "the run")
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # the all-plain run: the same weights (the run's seed), batches (the seeded
    # processor and order), dropout masks (the trainer's generator) and negatives
    model_cfg = dict(cfg.model)
    model_cfg.pop("arch")
    model = load_model(RUN_CONFIGS[name]["model"]["arch"], model_cfg.pop("model_type"),
                       device=DEVICE, seed=SEED, **model_cfg)
    tokenizer = BertWordPieceTokenizer.from_vocab_file(vocab)

    def task():
        datasets = registry.get("dataset", builder)(dict(cfg.datasets[builder])).build()
        adapter = generic.TASK_ADAPTERS[cfg.run["task"]](
            tokenizer, max_txt_len=int(cfg.run["max_txt_len"])).specialize(model)
        if hasattr(adapter, "attach"):
            adapter.attach(datasets["train"])
        return adapter, generic.BuilderTask(datasets, adapter, batch_size=batch_size, seed=SEED,
                                            device=DEVICE)

    adapter, first_task = task()
    first = first_task.prepare_batch(next(iter(first_task.train_loader(0))))
    # one step's gradients from the same weights, batch, dropout masks and
    # negatives: the kernel forward with its K8 launches stage by stage, then
    # all-plain
    model.train()
    grads, stages, first_tape, moved = {}, kernel_checks.StageRecorder(), [], []
    for run_kind in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        with contextlib.ExitStack() as stack:
            stack.enter_context(primitives.stage_check(stages) if run_kind == "kernel"
                                else primitives.plain_reference())
            stack.enter_context(_negatives_tape(first_tape, None if run_kind == "kernel"
                                                else moved))
            loss = adapter.forward(model, first, gen)["loss"]
            loss.backward()
        sync()
        grads[run_kind] = (loss.item(), *_grads(model))
    model.zero_grad(set_to_none=True)
    (k_loss, names, k_grads), (p_loss, _, p_grads) = grads["kernel"], grads["plain"]
    grad = kernel_checks.grad_gap(k_grads, p_grads, names)
    del grads, k_grads, p_grads, first
    # the all-plain steps over the batches drawn again, the run's negatives replayed
    adapter, plain_task = task()
    tcfg = TrainConfig(learning_rate=float(cfg.run["learning_rate"]),
                       weight_decay=float(cfg.run["weight_decay"]), total_steps=VIDEO_STEPS)
    plain = generic.GenericTrainer(model, tcfg, seed=SEED, adapter=adapter, skip_nonfinite=True,
                                   decay_frozen=True)
    run_moved = []
    with primitives.plain_reference(), _negatives_tape(tape, run_moved):
        p_rows = [plain.train_step(plain_task.prepare_batch(b))
                  for b in plain_task.train_loader(0)]
    sync()
    del model, plain
    gc.collect()
    torch.cuda.empty_cache()
    bound = TRAIN_BOUNDS["live"]
    gaps = {"loss": max(abs(k["loss"] - p["loss"]) / max(abs(p["loss"]), 1e-6)
                        for k, p in zip(k_rows, p_rows)),
            "step_loss": abs(k_loss - p_loss) / max(abs(p_loss), 1e-6), "grad": grad["gap"]}
    for row in stages.rows():
        log(f"[{tag}] one step's tower, stage by stage: {row['kind']}: {row['calls']} calls, "
            f"worst share that differs {row['differ']:.3e}, worst difference {row['err']:.3e} -> "
            f"{'ok' if row['ok'] else 'FAIL'}")
    log(f"[{tag}] all-plain losses " + ", ".join(f"{r['loss']:.6f}" for r in p_rows)
        + "; the kernel run's " + ", ".join(f"{r['loss']:.6f}" for r in k_rows)
        + (f"; hard negatives replayed, the plain draws would move {sum(run_moved)} of "
           f"{sum(t.numel() for t in tape)} (the gradient step: {sum(moved)})" if tape else ""))
    log(f"[{tag}] the kernel run against the all-plain run: losses {gaps['loss']:.3e}, one "
        f"step's loss {gaps['step_loss']:.3e} (bound {bound['loss']:.0e}), its gradients "
        f"{grad['gap']:.3e} (bound {bound['grad']}; worst {grad['worst']})")
    k8_calls = {r["kind"]: r["calls"] for r in stages.rows()}.get("flash_attention -> f32")
    if (not stages.ok() or max(gaps["loss"], gaps["step_loss"]) > bound["loss"]
            or grad["gap"] > bound["grad"] or len(p_rows) != VIDEO_STEPS
            or k8_calls != VIDEO_TOWER_K8):
        raise RuntimeError(f"{tag}: against the all-plain run {gaps}, stages ok "
                           f"{stages.ok()} ({k8_calls} K8 calls), {len(p_rows)} steps")
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"step_ms": times, "samples_per_s": batch_size / times[-1] * 1e3,
            "peak_memory_gib": peak, "parameters": params,
            "losses": [r["loss"] for r in k_rows], "launches": launches,
            "launches_step": per_step, "gaps": gaps, "stages": stages.rows(),
            "seconds": seconds}


def phase_video_eval(work, kind):
    """22c / 22d: one ALPRO eval YAML through cli/evaluate.py, then all-plain
    from the kernel tower's rows."""
    from sprc_tpu_torch.models.alpro import AlproQA, AlproRetrieval
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    name = VIDEO_EVAL[kind]
    tag = f"video eval {kind}"
    t_phase = time.perf_counter()
    (builder,) = RUN_CONFIGS[name]["datasets"]
    root = os.path.join(work, f"video_eval_{kind}")
    ann = _write_clips(root, VIDEO_EVAL_CLIPS, SEED + 223, kind, "test")
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    over = {"run": {"seed": SEED},
            "datasets": {builder: {"build_info": {"annotations": {"test": [ann]},
                                                  "videos": root}}}}
    if kind == "retrieval":
        over["run"]["k_test"] = VIDEO_K_TEST
    else:
        rng = np.random.default_rng(SEED + 224)
        answers = list(dict.fromkeys(STAGE1_WORDS))
        while len(answers) < VIDEO_ANSWERS:
            word = " ".join(f"tok{int(j)}" for j in rng.integers(0, 20000, 2))
            if word not in answers:
                answers.append(word)
        over["run"]["answer_list"] = answers
    cfg, how = _run_config(name, over)
    log(f"[{tag}] cli/evaluate.py through {how.split(' run.answer_list=')[0]}"
        + (f" run.answer_list=<{VIDEO_ANSWERS} answers>" if kind == "qa" else ""))
    counters = _counters()
    runs, (f_max, f_mean, f_top) = _eval_twice(tag, cfg, work, f"video_eval_{kind}", vocab,
                                               AlproRetrieval if kind == "retrieval" else AlproQA,
                                               "encode_video", counters)
    k, p = runs["kernel"], runs["plain"]
    want = VIDEO_TOWER_K8 * -(-VIDEO_EVAL_CLIPS // VIDEO_EVAL_BATCH[kind])
    log(f"[{tag}] the tower's rows, kernel against plain on the same clips: max {f_max:.3e} of "
        f"{f_top:.3e} ({f_max / f_top:.3e}; bound {VIDEO_ROW_REL:.0e}), mean {f_mean:.3e}; from "
        f"the kernel tower's rows the all-plain results "
        f"{'equal' if k['results'] == p['results'] else 'DIFFER'}, metrics "
        f"{'equal' if k['metrics'] == p['metrics'] else 'DIFFER'}; K8 {want} expected")
    if p["launches"]:
        raise RuntimeError(f"{tag}: the all-plain run launched {p['launches']}")
    _video_launches(tag, k["launches"], want, "the run")
    if (k["results"] != p["results"] or k["metrics"] != p["metrics"]
            or "agg_metrics" not in k["metrics"] or f_max > VIDEO_ROW_REL * f_top):
        raise RuntimeError(f"{tag}: the kernel evaluation disagrees with the all-plain one")
    if kind == "qa" and len(k["results"][0]) != VIDEO_EVAL_CLIPS:
        raise RuntimeError(f"{tag}: {len(k['results'][0])} predictions")
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"metrics": k["metrics"], "stages_s": k["stats"], "seconds_kernel": k["seconds"],
            "seconds_plain": p["seconds"], "peak_memory_gib": k["peak"],
            "launches": k["launches"], "rows_gap": [f_max, f_mean, f_top], "seconds": seconds}


def phase_video(work):
    """Phase 22, each model (and its plain twin) on the card alone."""
    train, evals = {}, {}
    for kind in VIDEO_TRAIN:  # 22a, 22b
        gc.collect()
        torch.cuda.empty_cache()
        train[kind] = timed(f"22{'ab'[kind == 'qa']} video train {kind}", phase_video_train,
                            work, kind)
    for kind in VIDEO_EVAL:  # 22c, 22d
        gc.collect()
        torch.cuda.empty_cache()
        evals[kind] = timed(f"22{'cd'[kind == 'qa']} video eval {kind}", phase_video_eval, work,
                            kind)
    log(f"[counters] phase 22: K8 {VIDEO_TOWER_K8} a TimeSformer call; read: train "
        + ", ".join(f"{w} {r['launches_step'][-1].get('flash_attention')} a step"
                    for w, r in train.items())
        + "; eval " + ", ".join(f"{w} {r['launches'].get('flash_attention')} in "
                                 f"{-(-VIDEO_EVAL_CLIPS // VIDEO_EVAL_BATCH[w])} calls"
                                 for w, r in evals.items()))
    return {"video_train": train, "video_eval": evals}


def video_kernels(rows, video):
    """The kernel rows of phase 22: K8 at TimeSformer's spatial call, through
    ``FlashAttention`` at the training batch (its launches 22a's and 22b's)
    and without a graph at the retrieval evaluation's (22c's and 22d's)."""
    from sprc_tpu_torch.kernel_checks import VIDEO_SHAPES, bound_ms

    by_check = {r["check"]: r for r in rows}
    out = []
    for kind, runs, label in (("train", video["video_train"], "FlashAttention, training"),
                              ("eval", video["video_eval"], "evaluation")):
        B, S = VIDEO_SHAPES[kind]
        r = by_check[f"K8 flash_attention timesformer fp32 S={S} B={B} {kind}"]
        row = {"name": f"flash_attention (TimeSformer spatial, fp32, {label})", "route": "cuda",
               "source": "sprc_tpu_torch/csrc/attention.cu",
               "replaces": "sprc_tpu/ops/pallas_attention.py:428",
               "launches": sum(run["launches"].get("flash_attention", 0)
                               for run in runs.values()),
               "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
               **bound_ms(r), "library_ms": r["library_ms"], "device_ms": r["device_ms"],
               "plain_device_ms": r["plain_device_ms"],
               "library_device_ms": r["library_device_ms"]}
        if "fwd_bwd_ms" in r:
            row.update(fwd_bwd_ms=r["fwd_bwd_ms"], plain_fwd_bwd_ms=r["plain_fwd_bwd_ms"])
        out.append(row)
    return out


# Phase 23, the GPT-2 video dialogue (models/gpt_dialogue.py; random weights from
# seed 0, the synthetic GPT-2 tokenizer over GPT-2's 50,257 ids with the seven
# dialogue tokens after them) and the Q-Former LM's caption decode
# (models/lm.py). 23a: cli/train.py on dialogue_avsd_ft.yaml as shipped (GPT-2
# base: 12 layers, 768 wide, 12 heads, 1024 positions; vocabulary 50,264;
# len_video_ft 4224; batch 16; fp32), its streams named through --options
# (i3d_flow + i3d_rgb + vggish: 2048 + 2048 + 128 = 4224; the YAML names none, and
# the processor's default i3d_rgb + vggish is 2176 wide), DIALOGUE_STEPS steps
# over DIALOGUE_TRAIN_ITEMS dialogues of DIALOGUE_TURNS turns whose three streams
# run 40 to 80 frames, each stream its own length: step ms, samples/s, peak; the
# first step's fp32 loss and logits against the same batch's through the same
# initial weights in float64, within DIALOGUE_F64_REL and DIALOGUE_F64_LOGITS; no launch (the GPT-2 trunk runs no
# Pallas kernel in JAX, so none here) and no last_state.pt. 23b: cli/evaluate.py
# on eval/dialogue_avsd_eval.yaml over DIALOGUE_EVAL_ITEMS dialogues at its batch
# of 8 (the last batch of 4 real items), from 23a's model-only file (deleted
# after): the metric against the mean of the same batches' losses computed here,
# in this process (the synthetic tokenizer hashes words with Python's salted
# hash), within DIALOGUE_EVAL_REL. 23c: lm.generate_captions on
# blip2_cir_align_prompt / pretrain (EVA ViT-g, 39 blocks at 224 px, bf16 tower
# through K2; the BERT-base Q-Former with 32 queries; a seeded QFormerLMHead)
# over CAPTION_DECODE["images"] seeded images, 3 beams, max_length 30, min_length
# 10: seconds by stage (tower, decode), ms a decoded position, peak, K2 39 a
# tower call and its chain (bf16 products, bf16 attention, LayerNorm), nothing
# else (the decoder Q-Former runs unfused in both packages); the tower once more
# stage by stage (STAGE_BOUNDS), which is the check that holds K2 here; from the
# kernel tower's rows the all-plain decode gives the same captions (the decoder
# launches no kernel, so this checks that the decode is repeatable, not K2); the
# cached beam search the recomputing one's ids, the cached greedy decode the
# recomputing one's.
DIALOGUE_TRAIN = "dialogue_avsd_ft.yaml"
DIALOGUE_EVAL = "eval/dialogue_avsd_eval.yaml"
DIALOGUE_STEPS, DIALOGUE_TURNS = 3, 3
DIALOGUE_TRAIN_ITEMS = 48  # the YAML's batch of 16, DIALOGUE_STEPS times
DIALOGUE_EVAL_ITEMS = 44  # 5 batches of 8 and one of 4
DIALOGUE_STREAMS = {"i3d_flow": 2048, "i3d_rgb": 2048, "vggish": 128}
DIALOGUE_FRAMES = (40, 80)
GPT2_BASE_VOCAB = 50257
# bounds, fixed before the first reading: fp32 against float64 over one GPT-2
# base forward (12 pre-LN blocks, a 50,264-way log-softmax); the CLI's metric
# against the same batches' losses in this process (the same program, so equal
# but for the order of the host mean). The loss at random init is mostly log V
# and the feature MSE, so a lower-precision product could pass its bound; the
# logits' bound (the largest gap over the largest magnitude) is one that TF32's
# 10-bit inputs (about 5e-4 a product) would fail
DIALOGUE_F64_REL = 1e-5
DIALOGUE_F64_LOGITS = 1e-4
DIALOGUE_EVAL_REL = 1e-6
CAPTION_DECODE = {"images": 16, "num_beams": 3, "max_length": 30, "min_length": 10}
CAPTION_DECODE_CHAIN = ("gemm", "attention_bf16", "layer_norm")


def _write_dialogues(root, n, seed, split):
    """``n`` AVSD-style dialogues under ``root`` (their three feature streams,
    each 40 to 80 frames, as ``<stream>/<video>.npy``) and the annotation
    path."""
    rng = np.random.default_rng(seed)

    def say(k):
        return " ".join(str(w) for w in rng.choice(STAGE1_WORDS, k))

    ann = []
    for v in range(n):
        name = f"{split}{v:03d}"
        for stream, width in DIALOGUE_STREAMS.items():
            os.makedirs(os.path.join(root, stream), exist_ok=True)
            frames = int(rng.integers(DIALOGUE_FRAMES[0], DIALOGUE_FRAMES[1] + 1))
            np.save(os.path.join(root, stream, name + ".npy"),
                    rng.standard_normal((frames, width), dtype=np.float32))
        ann.append({"image_id": name, "caption": say(8), "summary": say(12),
                    "dialog": [{"question": say(6), "answer": say(5)}
                               for _ in range(DIALOGUE_TURNS)],
                    "question": say(6), "answer": say(int(rng.integers(3, 9)))})
    path = os.path.join(root, f"{split}.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return path


def _dialogue_config(name, split, ann, root, run=None):
    """The YAML with the data, the streams that make 4224 and the synthetic
    tokenizer on both processors, as --options gives them."""
    section = "train" if split == "train" else "eval"
    return _run_config(name, {
        "run": run or {},
        "datasets": {"avsd_dialogue": {
            "build_info": {"annotations": {split: [ann]}, "videos": root},
            "vis_processor": {section: {"visual_ft": ["i3d_flow", "i3d_rgb"],
                                        "audio_ft": ["vggish"],
                                        "synthetic_vocab": GPT2_BASE_VOCAB}},
            "text_processor": {section: {"synthetic_vocab": GPT2_BASE_VOCAB}}}}})


def phase_dialogue_train(work):
    """23a: dialogue_avsd_ft.yaml through cli/train.py, then the first step's
    loss against float64 from the same initial weights."""
    import argparse
    import shutil

    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.train import generic

    tag = "dialogue train"
    t_phase = time.perf_counter()
    root = os.path.join(work, "avsd")
    ann = _write_dialogues(root, DIALOGUE_TRAIN_ITEMS, SEED + 230, "train")
    out = os.path.join(work, "dialogue_train")
    shutil.rmtree(out, ignore_errors=True)
    cfg, how = _dialogue_config(DIALOGUE_TRAIN, "train", ann, root,
                                {"max_epochs": 1, "seed": SEED, "log_freq": 1})
    log(f"[{tag}] cli/train.py through {how}")
    args = argparse.Namespace(output_dir=out, vocab_path=None, model_path=None, resume=None,
                              device=DEVICE, data_path=None)
    run = _cli_train_run(cfg, args)
    trainer = run.pop("trainer")
    params = sum(p.numel() for p in trainer.model.parameters())
    rows, times = run["rows"], run["times"]
    batch_size = cfg.run["batch_size"]
    weights = os.path.join(work, "dialogue_model.pth")  # model only: 23b reads it
    torch.save(trainer.model.state_dict(), weights)
    del trainer, run["per_step"]
    gc.collect()
    torch.cuda.empty_cache()
    moved = {k: v for k, v in run["launches"].items() if v}
    log(f"[{tag}] {len(rows)} steps at batch {batch_size} ({params / 1e6:.1f} M parameters): ms "
        + ", ".join(f"{t:.1f}" for t in times) + f"; samples/s (last step) "
        f"{batch_size / times[-1] * 1e3:.2f}; peak {run['peak']:.2f} GiB; run {run['run_s']:.1f} "
        "s; losses " + ", ".join(f"{r['loss']:.6f}" for r in rows)
        + f"; launches {moved or 'none'}; state writes skipped: {run['skipped']}")
    written = sorted(os.listdir(out))
    if (len(rows) != DIALOGUE_STEPS or any(r["skipped_nonfinite"] for r in rows)
            or not all(np.isfinite(r["loss"]) for r in rows)):
        raise RuntimeError(f"{tag}: steps {rows}")
    if moved or any(f.endswith(".pt") for f in written):
        raise RuntimeError(f"{tag}: launches {moved}, files {written}")

    # the first batch again, through the run's initial weights (the run's seed),
    # in fp32 and in float64
    model_cfg = dict(cfg.model)
    arch = model_cfg.pop("arch")
    model = load_model(arch, model_cfg.pop("model_type", "pretrain"), device=DEVICE, seed=SEED,
                       **model_cfg)
    datasets = registry.get("dataset", "avsd_dialogue")(dict(cfg.datasets["avsd_dialogue"])).build()
    adapter = generic.DialogueAdapter().specialize(model)
    adapter.attach(datasets["train"])
    task = generic.BuilderTask(datasets, adapter, batch_size=batch_size, seed=SEED, device=DEVICE)
    first = task.prepare_batch(next(iter(task.train_loader(0))))
    T, L = first["video_fts"].shape[1], first["input_ids"].shape[1]
    with torch.inference_mode():
        out32 = adapter.forward(model, first)
        f32, logits32 = out32["loss"].item(), out32["logits"]
        del out32
        model.double()
        out64 = adapter.forward(model, dict(first, video_fts=first["video_fts"].double()))
        f64 = out64["loss"].item()
        logits_gap = ((logits32.double() - out64["logits"]).abs().max()
                      / out64["logits"].abs().max()).item()
    del model, first, out64, logits32
    gc.collect()
    torch.cuda.empty_cache()
    gap = abs(rows[0]["loss"] - f64) / abs(f64)
    log(f"[{tag}] the first batch ({batch_size} x [{T} video | {L} text] positions): the run's "
        f"loss {rows[0]['loss']:.9f}, again in fp32 {f32:.9f}, in float64 {f64:.9f}: relative "
        f"{gap:.3e} (bound {DIALOGUE_F64_REL:.0e}); the logits, largest gap over largest "
        f"magnitude {logits_gap:.3e} (bound {DIALOGUE_F64_LOGITS:.0e})")
    if not gap <= DIALOGUE_F64_REL or not logits_gap <= DIALOGUE_F64_LOGITS or T + L > 1024:
        raise RuntimeError(f"{tag}: fp32 against float64 loss {gap}, logits {logits_gap}, "
                           f"{T} + {L} positions")
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"step_ms": times, "samples_per_s": batch_size / times[-1] * 1e3,
            "peak_memory_gib": run["peak"], "parameters": params,
            "losses": [r["loss"] for r in rows], "first_loss_f64": f64,
            "first_loss_f32": rows[0]["loss"], "f64_rel_gap": gap,
            "f64_logits_gap": logits_gap, "positions": [T, L],
            "launches": moved, "seconds": seconds}, weights


def phase_dialogue_eval(work, weights):
    """23b: eval/dialogue_avsd_eval.yaml through cli/evaluate.py from 23a's
    weights, against the same batches' losses computed here."""
    import argparse

    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.train import generic
    from sprc_tpu_torch.train.eval_glue import eval_loader

    tag = "dialogue eval"
    t_phase = time.perf_counter()
    root = os.path.join(work, "avsd")
    ann = _write_dialogues(root, DIALOGUE_EVAL_ITEMS, SEED + 231, "val")
    cfg, how = _dialogue_config(DIALOGUE_EVAL, "val", ann, root)
    log(f"[{tag}] cli/evaluate.py through {how} --model-path <23a's weights>")
    args = argparse.Namespace(device=DEVICE, model_path=weights, vocab_path=None, split=None,
                              output_dir=os.path.join(work, "dialogue_eval"))
    counters = _counters()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    metrics = evaluate.evaluate(cfg, args, stats)
    sync()
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()
             if getattr(obj, attr)}

    # the same batches here: real items only, the loss of each
    model = load_model("gpt_dialogue", checkpoint_path=weights, device=DEVICE,
                       **{k: v for k, v in cfg.model.items() if k != "arch"})
    builder = registry.get("dataset", "avsd_dialogue")(dict(cfg.datasets["avsd_dialogue"]))
    ds = builder.build()["val"]
    adapter = generic.DialogueAdapter().specialize(model)
    adapter.attach(ds)
    losses, sizes = [], []
    with torch.inference_mode():
        for idx, items in eval_loader(ds, cfg.run["batch_size_eval"]):
            batch = {k: torch.as_tensor(v).to(DEVICE)
                     for k, v in adapter.collate(items[:len(idx)]).items()}
            losses.append(adapter.forward(model, batch)["loss"].item())
            sizes.append(len(idx))
    del model
    os.remove(weights)
    gc.collect()
    torch.cuda.empty_cache()
    want = float(np.mean(losses))
    gap = abs(metrics["agg_metrics"] - want) / abs(want)
    log(f"[{tag}] {len(losses)} batches of {sizes}: metric {metrics['agg_metrics']:.9f}, the "
        f"batches' mean here {want:.9f}: relative {gap:.3e} (bound {DIALOGUE_EVAL_REL:.0e}); "
        f"total {total_s:.2f} s (the passes {stats.get('loss_s', 0.0):.2f} s); peak {peak:.2f} "
        f"GiB; launches {moved or 'none'}")
    if not gap <= DIALOGUE_EVAL_REL or sizes[-1] == sizes[0] or moved:
        raise RuntimeError(f"{tag}: metric {metrics} against {want}, batches {sizes}, "
                           f"launches {moved}")
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"metrics": metrics, "batch_losses": losses, "batch_items": sizes, "rel_gap": gap,
            "total_s": total_s, "passes_s": stats.get("loss_s"), "peak_memory_gib": peak,
            "seconds": seconds}


def phase_caption_decode(work):
    """23c: generate_captions on blip2_cir_align_prompt / pretrain, its K2
    launches held as the Kernels section of the phase says."""
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.models import lm
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    tag = "caption decode"
    t_phase = time.perf_counter()
    model = loader.load_model("blip2_cir_align_prompt", "pretrain", device=DEVICE, seed=SEED)
    head = lm.QFormerLMHead(model.qformer.cfg).to(DEVICE)
    loader.init_weights(head, SEED + 232)
    tok = BertWordPieceTokenizer.from_vocab_file(
        write_synthetic_bert_vocab(os.path.join(work, "vocab.txt")))
    (images,) = _pixels(CAPTION_DECODE["images"], CAPTION_DECODE["images"], SEED + 233)
    decode = {k: v for k, v in CAPTION_DECODE.items() if k != "images"}
    counters = _counters()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    captions = lm.generate_captions(model, head, images, tok, stats=stats, **decode)
    sync()
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    positions = decode["max_length"] - 1
    ms_position = stats["decode_s"] / positions * 1e3
    log(f"[{tag}] {len(captions)} images, {decode['num_beams']} beams: seconds by stage tower "
        f"{stats['tower_s']:.3f}, decode {stats['decode_s']:.3f} ({ms_position:.2f} ms a decoded "
        f"position of {len(captions) * decode['num_beams']} rows); total {total_s:.2f} s; peak "
        f"{peak:.2f} GiB; e.g. {[c[:40] for c in captions[:2]]}")
    log(f"[{tag}] launches: {launches}")
    bad = {k: v for k, v in launches.items()
           if (k == "fused_vit_block" and v != 39) or (k in CAPTION_DECODE_CHAIN and v <= 0)
           or (k not in CAPTION_DECODE_CHAIN + ("fused_vit_block",) and v)}
    if bad or len(captions) != CAPTION_DECODE["images"] or not all(captions):
        raise RuntimeError(f"{tag}: launches {bad} (K2 39 and its chain expected), "
                           f"{len(captions)} captions")

    # none of what follows is the main path's: the counters are put back after it
    kept = dict(launches)
    stages = stage_pass(tag, "the tower", counters, lambda: model.encode_image(images))
    with torch.inference_mode():
        rows_k = model.encode_image(images)
        with primitives.plain_reference():
            rows_p = model.encode_image(images)
            ids_plain = lm.decode_captions(model, head, rows_k, tok, **decode)
        rows_gap = ((rows_k - rows_p).abs().max().item(), (rows_k - rows_p).abs().mean().item())
        del rows_p
        plain_captions = [tok.decode(r) for r in ids_plain.cpu().numpy()]
        cached_beam = lm.decode_captions(model, head, rows_k, tok, **decode)
        lmod = lm.QFormerLM(model.qformer.cfg, bert=model.qformer, cls=head)
        queries = model.query_tokens.expand(rows_k.shape[0], -1, -1)
        ids = dict(bos_token_id=tok.bos_id, eos_token_id=tok.sep_id, pad_token_id=tok.pad_id,
                   max_length=decode["max_length"], min_length=decode["min_length"])
        beam = lm.beam_generate(lmod, queries, rows_k, num_beams=decode["num_beams"], **ids)
        greedy = lm.greedy_generate(lmod, queries, rows_k, **ids)
        cached_greedy = lm.cached_greedy_generate(lmod, queries, rows_k, **ids)
    sync()
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, kept[k])
    same = {"plain_captions": plain_captions == captions,
            "beam": torch.equal(cached_beam, beam), "greedy": torch.equal(cached_greedy, greedy)}
    beam_rows = (cached_beam != beam).any(dim=1).nonzero().flatten().tolist()
    greedy_rows = (cached_greedy != greedy).any(dim=1).nonzero().flatten().tolist()
    log(f"[{tag}] the tower's rows, kernel against all-plain: max_abs {rows_gap[0]:.3e}, "
        f"mean_abs {rows_gap[1]:.3e} (report; the gate is the stage check); from the kernel "
        f"tower's rows the all-plain decode's captions "
        f"{'equal' if same['plain_captions'] else 'DIFFER'}; the cached beam search against "
        f"the recomputing one: {'equal' if same['beam'] else f'rows {beam_rows} differ'}; the "
        f"cached greedy decode against the recomputing one: "
        f"{'equal' if same['greedy'] else f'rows {greedy_rows} differ'}")
    del model, head, lmod, rows_k
    gc.collect()
    torch.cuda.empty_cache()
    if not all(same.values()):
        raise RuntimeError(f"{tag}: {same}")
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] phase {seconds:.1f} s")
    return {"stage_seconds": {k: stats[k] for k in ("tower_s", "decode_s")},
            "ms_per_position": ms_position, "total_s": total_s, "peak_memory_gib": peak,
            "launches": {k: v for k, v in launches.items() if v}, "rows_gap": list(rows_gap),
            "stages": stages, "captions": captions[:4], "seconds": seconds}


def phase_dialogue_caption(work):
    """Phase 23, each model on the card alone."""
    gc.collect()
    torch.cuda.empty_cache()
    train, weights = timed("23a dialogue train", phase_dialogue_train, work)
    gc.collect()
    torch.cuda.empty_cache()
    evals = timed("23b dialogue eval", phase_dialogue_eval, work, weights)
    gc.collect()
    torch.cuda.empty_cache()
    caption = timed("23c caption decode", phase_caption_decode, work)
    log(f"[counters] phase 23: the dialogue none (train {train['launches'] or 'none'}); the "
        f"caption decode K2 {caption['launches'].get('fused_vit_block')} in one tower call")
    return {"dialogue_train": train, "dialogue_eval": evals, "caption_decode": caption}


def dialogue_caption_kernels(rows, phase):
    """The kernel rows of phase 23: K2 and its bf16 attention at the caption
    decode's tower call (EVA ViT-g, B = 16, S = 257), 23c's launches."""
    from sprc_tpu_torch.kernel_checks import bound_ms

    by_check = {r["check"]: r for r in rows}
    launches = phase["caption_decode"]["launches"]
    out = []
    for name, check, count, source, replaces in (
            ("fused_vit_block (EVA ViT-g, Q-Former LM caption decode)", "K2 vit_block eva_g B=16",
             "fused_vit_block", "sprc_tpu_torch/ops/fused_block.py",
             "sprc_tpu/ops/pallas_block.py:609"),
            ("attention bf16 (EVA ViT-g, Q-Former LM caption decode)", "attention D=88 bf16 B=16",
             "attention_bf16", "sprc_tpu_torch/csrc/attention.cu",
             "sprc_tpu/ops/pallas_attention.py:428")):
        r = by_check[check]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches.get(count, 0), "max_abs_err": r["max_abs_err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"], **bound_ms(r),
                    "library_ms": r.get("library_ms")})
    return out


MESH_PNG = 96  # the side of the synthetic split's PNG files (targetpad brings them to 224)
MESH_QUERIES = 4  # /query requests a server answers in phase 24 (the last one 8 queries)
MESH_KERNELS = ("token_max_sim", "fused_vit_block", "fused_qformer_layer")
MESH_TEST1_QUERIES = 64  # the CIRR test1 split's queries (the submission), as many as val's


def _rss_kib():
    """This process's resident KiB and the part of it that is shared (file
    pages), from /proc/self/statm."""
    with open("/proc/self/statm") as f:
        pages = [int(v) for v in f.read().split()]
    kib = os.sysconf("SC_PAGE_SIZE") // 1024
    return {"resident": pages[1] * kib, "shared": pages[2] * kib}


def phase_mesh(work):
    """Phase 24: --mesh at world 1 over NCCL (the docstring's item 24)."""
    import io

    import torch.distributed as torch_dist

    import shutil

    from sprc_tpu_torch.cli import finetune, serve, submission, validate, validate_rerank
    from sprc_tpu_torch.kernel_checks import TRAIN_BATCH
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.parallel import mesh as mesh_lib
    from sprc_tpu_torch.train import checkpoint, loop
    from sprc_tpu_torch.train.feature_cache import FeatureCache
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    tag = "mesh"
    root = os.path.join(work, "mesh")
    os.makedirs(root, exist_ok=True)
    vocab = write_synthetic_bert_vocab(os.path.join(root, "vocab.txt"))
    names = [f"trn{i:04d}" for i in range(TRAIN_IMAGES)]
    data = _write_cirr_train(os.path.join(root, "cirr"), names, TRAIN_TRIPLETS, SEED + 3)
    _write_cirr_val(data, names, VALIDATE_QUERIES, SEED + 4)
    _write_cirr_val(data, names, MESH_TEST1_QUERIES, SEED + 5, split="test1")
    _write_pngs(data, ("train", "dev"), names, MESH_PNG, SEED + 6)  # set-up
    # the reranker of the rerank runs: seeded random weights in the release layout
    reranker = load_model("blip2_cir_rerank", "pretrain_vitL", device=DEVICE, seed=SEED + 250)
    rerank_ckpt = _save_released(reranker, os.path.join(root, "rerank.pt"))
    del reranker
    rerank_flags = ["--rerank-top", str(RERANK_TOP), "--rerank-step", str(RERANK_STEP)]
    counters = _counters()
    common = ["--model-type", "pretrain_vitL", "--vocab-path", vocab, "--encode-batch",
              str(ENCODE_BATCH), "--query-batch", str(QUERY_BATCH), "--device", DEVICE]

    def reset():
        for obj, attr in counters.values():
            setattr(obj, attr, 0)

    def read():
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    # what a fine-tune run leaves: its steps (losses, host ms) and, in memory,
    # its last state; one run writes last_state.pt for real
    record = {}
    inner_step, inner_save = loop.Trainer.train_step, checkpoint.save_state
    inner_grads = loop.Trainer.loss_and_grads
    inner_export = checkpoint.export_torch_compatible

    def loss_and_grads(self, batch):
        out = inner_grads(self, batch)
        if "grads" not in record:  # the first step's, kept on the host
            record["grads"] = [g.detach().cpu().clone() for g in out[2]]
            record["names"] = list(self.names)
        return out

    def step(self, batch):
        t0 = time.perf_counter()
        out = inner_step(self, batch)  # ends in a host read of the losses
        record["ms"].append((time.perf_counter() - t0) * 1e3)
        record["losses"].append(out)
        return out

    def save(path, trainer):
        state = trainer.state_dict()
        record["trainable"] = {k: v.detach().cpu().clone() for k, v in state["trainable"].items()}
        if record["write"]:
            inner_save(path, trainer)
            record["written"] = path

    def finetune_run(mesh, cached, write=False):
        out_dir = os.path.join(root, f"finetune_{'mesh' if mesh else 'one'}_"
                                     f"{'cached' if cached else 'live'}")
        argv = ["--dataset", "CIRR", "--data-path", data, "--output-dir", out_dir,
                "--batch-size", str(TRAIN_BATCH), "--num-epochs", "1", "--workers", "4",
                "--seed", str(SEED), *common, *(["--cache-features"] if cached else []),
                *(["--mesh"] if mesh else [])]
        record.clear()
        record.update(ms=[], losses=[], write=write)
        gc.collect()
        torch.cuda.empty_cache()
        reset()
        t0 = time.perf_counter()
        finetune.main(argv)
        sync()
        seconds = time.perf_counter() - t0
        with open(os.path.join(out_dir, "log.jsonl")) as f:
            val = [e for e in map(json.loads, f) if e.get("kind") == "val"]
        return dict(record, seconds=seconds, launches=read(), validation=val,
                    cache=os.path.join(out_dir, "feature_cache"))

    def validate_run(mesh):
        out = io.StringIO()
        gc.collect()
        torch.cuda.empty_cache()
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            validate.main(["--dataset", "CIRR", "--data-path", data, *common,
                           *(["--mesh"] if mesh else [])])
        sync()
        return {"text": out.getvalue(), "seconds": time.perf_counter() - t0, "launches": read()}

    def serve_run(mesh, rerank=False):
        gc.collect()
        torch.cuda.empty_cache()
        reset()
        t0 = time.perf_counter()
        args = serve.make_parser().parse_args(
            ["--dataset", "CIRR", "--data-path", data, "--seed", str(SEED), "--port", "0", *common,
             *(["--model-name", "blip2_cir_rerank", "--model-path", rerank_ckpt, *rerank_flags]
               if rerank else []), *(["--mesh"] if mesh else [])])
        service = serve.build_service(args)
        service.warm()
        server = serve.make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        rng = np.random.default_rng(SEED + 240)
        words = ["red", "dress", "with", "long", "sleeves", "and", "a", "blue", "shirt", "dog"]
        refs = [names[i] for i in rng.choice(len(names), MESH_QUERIES + 7, replace=False)]
        caps = [" ".join(rng.choice(words, rng.integers(3, 9))) for _ in refs]
        more = {"k": K, **({"rerank": True} if rerank else {})}
        answers = []
        try:
            for i in range(MESH_QUERIES - 1):
                answers.append(_post(f"{base}/query", {"reference": refs[i], "caption": caps[i],
                                                       **more})[0]["results"])
                if rerank and i == 0:  # a request the service refuses: its 400, and serving goes on
                    try:
                        _post(f"{base}/query", {"reference": [refs[0]], "caption": caps[0], **more})
                        answers.append("no 400")
                    except urllib.error.HTTPError as err:
                        answers.append((err.code, json.loads(err.read())))
            answers.append(_post(f"{base}/query", {"queries": [
                {"reference": r, "caption": c} for r, c in zip(refs[-8:], caps[-8:])],
                **more})[0]["results"])
        finally:
            server.shutdown()
            thread.join(timeout=30)
            server.server_close()
            service.stop()
        assert not thread.is_alive(), "server thread did not stop"
        sync()
        for res, ref in zip(answers[-1], refs[-8:]):
            _check_answer([res], [ref], set(names), reranked=rerank)
        if rerank and answers[1] != (400, {"error": "TypeError: unhashable type: 'list'"}):
            raise RuntimeError(f"{tag}: a list reference was answered {answers[1]}")
        del service
        return {"answers": answers, "seconds": time.perf_counter() - t0, "launches": read()}

    def rerank_cli_run(module, mesh, extra, out_dir=None):
        """validate_rerank's or submission's main on the split, the reranker
        from rerank.pt; its printed text (and the files it wrote)."""
        out = io.StringIO()
        gc.collect()
        torch.cuda.empty_cache()
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            module.main(["--dataset", "CIRR", "--data-path", data, *common,
                         "--rerank-model-path", rerank_ckpt, *extra,
                         *(["--output-dir", out_dir] if out_dir else []),
                         *(["--mesh"] if mesh else [])])
        sync()
        files = {}
        if out_dir:
            for name in sorted(os.listdir(out_dir)):
                with open(os.path.join(out_dir, name), "rb") as f:
                    files[name] = f.read()
        return {"text": out.getvalue(), "files": files, "seconds": time.perf_counter() - t0,
                "launches": read()}

    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(mesh_lib.free_port())}
    before_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    loop.Trainer.train_step, checkpoint.save_state = step, save
    loop.Trainer.loss_and_grads = loss_and_grads
    checkpoint.export_torch_compatible = lambda path, model, epoch=0: None
    runs = {}
    try:
        for cached in (False, True):
            kind = "cached" if cached else "live"
            runs[f"one_{kind}"] = finetune_run(False, cached)
            runs[f"mesh_{kind}"] = finetune_run(True, cached, write=not cached)
        mesh = mesh_lib.make_mesh(device=DEVICE)  # the group the --mesh runs joined
        group = {"backend": mesh.backend, "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                 "world": mesh.world, "rank": mesh.rank, "device": str(mesh.device)}
        log(f"[{tag}] process group: backend {group['backend']}, NCCL {group['nccl']}, world "
            f"{group['world']} (rank {group['rank']} on {group['device']})")
        if group["backend"] != "nccl" or group["world"] != 1:
            raise RuntimeError(f"{tag}: the --mesh runs did not join a NCCL group of one: {group}")
        written = runs["mesh_live"]["written"]
        state = torch.load(written, map_location="cpu", weights_only=True)
        saved_ok = (len(state["generators"]) == 1 and all(
            torch.equal(state["trainable"][k], v)
            for k, v in runs["mesh_live"]["trainable"].items()))
        del state
        os.remove(written)
        validate_runs = {m: validate_run(m) for m in (False, True)}
        serve_runs = {m: serve_run(m) for m in (False, True)}
        rerank_runs = {
            "validate_rerank": {m: rerank_cli_run(validate_rerank, m, rerank_flags)
                                for m in (False, True)},
            "submission": {m: rerank_cli_run(
                submission, m, ["--rerank", "--rerank-top", str(RERANK_TOP),
                                "--submission-name", "mesh"],
                os.path.join(root, f"submission_{'mesh' if m else 'one'}")) for m in (False, True)},
            "serve_rerank": {m: serve_run(m, rerank=True) for m in (False, True)}}

        # what the NCCL calls of a step cost at world 1 (device time, CUDA events)
        shapes = [v.shape for v in runs["mesh_live"]["trainable"].values()]
        grads = [torch.randn(sh, device=mesh.device) for sh in shapes]
        targets = torch.randn((TRAIN_BATCH, 32, 256), device=mesh.device)

        def device_ms(fn, reps=5):
            fn()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            times = []
            for _ in range(reps):
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            return float(np.median(times))

        nccl = {"all_reduce_ms": device_ms(lambda: mesh_lib.all_reduce_mean_(grads, mesh)),
                "all_reduce_floats": sum(g.numel() for g in grads),
                "all_gather_ms": device_ms(lambda: mesh_lib.all_gather_with_grad(targets, mesh)),
                "all_gather_floats": targets.numel()}
        del grads, targets
    finally:
        loop.Trainer.train_step, checkpoint.save_state = inner_step, inner_save
        loop.Trainer.loss_and_grads = inner_grads
        checkpoint.export_torch_compatible = inner_export
        if torch_dist.is_initialized():
            torch_dist.destroy_process_group()
        for k, v in before_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # the train cache in a process: the file's rows, mapped (copy-on-write pages)
    rss0 = _rss_kib()
    cache = FeatureCache.load(runs["mesh_cached"]["cache"], mmap=True)
    rss1 = _rss_kib()
    touched = float(cache.rows[:, 0, 0].float().sum())  # reads a value of every row
    rss2 = _rss_kib()
    cache_host = {"rows": len(cache), "row_shape": list(cache.rows.shape[1:]),
                  "dtype": str(cache.rows.dtype),
                  "bytes": cache.rows.numel() * cache.rows.element_size(),
                  "resident_kib_after_load": rss1["resident"] - rss0["resident"],
                  "shared_kib_after_load": rss1["shared"] - rss0["shared"],
                  "resident_kib_after_a_read_of_every_row": rss2["resident"] - rss0["resident"],
                  "shared_kib_after_a_read_of_every_row": rss2["shared"] - rss0["shared"]}
    del cache, touched

    result = {"group": group, "nccl_world1": nccl, "train_cache_host": cache_host,
              "last_state_written_and_read": saved_ok, "finetune": {}, "launches": {}}
    from sprc_tpu_torch.kernel_checks import grad_gap

    for kind in ("live", "cached"):
        one, mesh_run = runs[f"one_{kind}"], runs[f"mesh_{kind}"]
        same_losses = one["losses"] == mesh_run["losses"]
        tensor_names = list(one["trainable"])
        same_tensors = tensor_names == list(mesh_run["trainable"]) and all(
            torch.equal(one["trainable"][k], v) for k, v in mesh_run["trainable"].items())
        same_val = ([{k: v for k, v in e.items() if k != "seconds"} for e in one["validation"]]
                    == [{k: v for k, v in e.items() if k != "seconds"}
                        for e in mesh_run["validation"]])
        loss_gap = max(abs(m[k] - o[k]) / abs(o[k]) for m, o in zip(mesh_run["losses"],
                                                                  one["losses"])
                       for k in o if k.startswith("loss"))
        first_grads = grad_gap(mesh_run["grads"], one["grads"], one["names"])
        tensor_diff = max(float((mesh_run["trainable"][n] - one["trainable"][n]).abs().max())
                          for n in tensor_names)
        bitwise = same_losses and same_tensors
        held = bitwise or (loss_gap <= TRAIN_BOUNDS["live"]["loss"]
                           and first_grads["gap"] <= TRAIN_BOUNDS["live"]["grad"])
        result["finetune"][kind] = {
            "steps": len(mesh_run["losses"]), "losses_bitwise_equal": same_losses,
            "first_step_losses_bitwise_equal": one["losses"][:1] == mesh_run["losses"][:1],
            "trainable_bitwise_equal": same_tensors, "validation_equal": same_val,
            "loss_gap": loss_gap, "first_step_grad_gap": first_grads["gap"],
            "first_step_grad_gap_tensor": first_grads["tensor"],
            "trainable_max_abs_diff": tensor_diff,

            "step_ms": mesh_run["ms"], "step_ms_without_mesh": one["ms"],
            "seconds": mesh_run["seconds"], "seconds_without_mesh": one["seconds"],
            "losses": [m["loss"] for m in mesh_run["losses"]],
            "validation": mesh_run["validation"][-1] if mesh_run["validation"] else None}
        log(f"[{tag}] cli/finetune {'--cache-features ' if kind == 'cached' else ''}--mesh: "
            f"{len(mesh_run['losses'])} steps of {TRAIN_BATCH}, losses "
            + ", ".join(f"{m['loss']:.6f}" for m in mesh_run["losses"])
            + f"; step ms {', '.join(f'{t:.1f}' for t in mesh_run['ms'])} (without --mesh "
            f"{', '.join(f'{t:.1f}' for t in one['ms'])}); run {mesh_run['seconds']:.1f} s "
            f"(without {one['seconds']:.1f} s); against the run without --mesh: losses bit for "
            f"bit {same_losses} (the first step's "
            f"{result['finetune'][kind]['first_step_losses_bitwise_equal']}), "
            f"{len(tensor_names)} trainable tensors bit for bit {same_tensors}, validation "
            f"metrics equal {same_val}"
            + ("" if bitwise else
               f"; NOT bit for bit (the first step's gradients part first at "
               f"{first_grads['tensor']}): held at TRAIN_BOUNDS['live']: "
               f"the losses' worst gap {loss_gap:.3e} (bound {TRAIN_BOUNDS['live']['loss']}), the "
               f"first step's gradient gap {first_grads['gap']:.3e} in {first_grads['tensor']} "
               f"(bound {TRAIN_BOUNDS['live']['grad']}); the final trainable tensors differ by at "
               f"most {tensor_diff:.3e}"))
        if not (held and len(mesh_run["losses"]) == TRAIN_TRIPLETS // TRAIN_BATCH
                and mesh_run["validation"]):
            raise RuntimeError(f"{tag}: the {kind} fine-tune under --mesh is not the run "
                               f"without it: {result['finetune'][kind]}")
    same_json = validate_runs[True]["text"] == validate_runs[False]["text"]
    metrics = json.loads(validate_runs[True]["text"])
    assert list(metrics) == CIRR_KEYS, list(metrics)
    same_answers = serve_runs[True]["answers"] == serve_runs[False]["answers"]
    result.update(validate={"json_equal": same_json, "metrics": metrics,
                            "seconds": validate_runs[True]["seconds"],
                            "seconds_without_mesh": validate_runs[False]["seconds"]},
                  serve={"answers_equal": same_answers, "requests": MESH_QUERIES,
                         "seconds": serve_runs[True]["seconds"],
                         "seconds_without_mesh": serve_runs[False]["seconds"]})
    log(f"[{tag}] cli/validate --mesh: JSON equal to the run without it {same_json} "
        f"({validate_runs[True]['seconds']:.1f} s, without {validate_runs[False]['seconds']:.1f} "
        f"s); cli/serve --mesh: {MESH_QUERIES} /query answers equal {same_answers} "
        f"({serve_runs[True]['seconds']:.1f} s with its build, without "
        f"{serve_runs[False]['seconds']:.1f} s)")
    log(f"[{tag}] NCCL at world 1: the gradient's all-reduce ({nccl['all_reduce_floats']} fp32) "
        f"{nccl['all_reduce_ms']:.4f} ms, the targets' all-gather ({nccl['all_gather_floats']} "
        f"fp32) {nccl['all_gather_ms']:.4f} ms (device, median of 5); the train cache: "
        f"{cache_host['rows']} rows of {cache_host['row_shape']} {cache_host['dtype']}, "
        f"{cache_host['bytes'] / 2 ** 20:.1f} MiB in the file; this process's resident / shared "
        f"memory +{cache_host['resident_kib_after_load']} / "
        f"+{cache_host['shared_kib_after_load']} KiB after the load (mapped), "
        f"+{cache_host['resident_kib_after_a_read_of_every_row']} / "
        f"+{cache_host['shared_kib_after_a_read_of_every_row']} KiB after a read of every row")
    # the rerank entry points (ViT-L, the reranker of rerank.pt, 50 candidates)
    same_rerank = {
        "validate_rerank": (rerank_runs["validate_rerank"][True]["text"]
                            == rerank_runs["validate_rerank"][False]["text"]),
        "submission": (rerank_runs["submission"][True]["files"]
                       == rerank_runs["submission"][False]["files"]),
        "serve_rerank": (rerank_runs["serve_rerank"][True]["answers"]
                         == rerank_runs["serve_rerank"][False]["answers"])}
    rerank_metrics = json.loads(rerank_runs["validate_rerank"][True]["text"])
    sub_files = rerank_runs["submission"][True]["files"]
    sub_pairs = {n: len(json.loads(v)) - 2 for n, v in sub_files.items()}  # less version, metric
    for name, run in rerank_runs.items():
        result[name] = {"equal": same_rerank[name], "seconds": run[True]["seconds"],
                        "seconds_without_mesh": run[False]["seconds"],
                        "launches": {k: run[True]["launches"][k] for k in MESH_KERNELS}}
    result["validate_rerank"]["metrics"] = rerank_metrics
    result["submission"]["queries_a_file"] = sub_pairs
    log(f"[{tag}] cli/validate_rerank --mesh (--rerank-top {RERANK_TOP} --rerank-step "
        f"{RERANK_STEP}, {VALIDATE_QUERIES} queries): JSON equal to the run without it "
        f"{same_rerank['validate_rerank']} ({list(rerank_metrics.values())[:4]}...); "
        f"cli/submission --dataset CIRR --rerank --mesh ({MESH_TEST1_QUERIES} test1 queries): "
        f"files {sorted(sub_files)} equal byte for byte {same_rerank['submission']} ({sub_pairs} "
        f"queries a file); cli/serve --mesh --rerank-top {RERANK_TOP}: {MESH_QUERIES} rerank "
        f"requests' answers and the list reference's 400 "
        f"{rerank_runs['serve_rerank'][True]['answers'][1]} equal {same_rerank['serve_rerank']}")
    for name, run in rerank_runs.items():
        log(f"[{tag}] {name}: {run[True]['seconds']:.1f} s with --mesh, "
            f"{run[False]['seconds']:.1f} s without; K1 / K2 / K3 launches with --mesh "
            + " / ".join(str(run[True]["launches"][k]) for k in MESH_KERNELS))
    if not (same_json and same_answers and saved_ok and all(same_rerank.values())
            and list(rerank_metrics) == CIRR_KEYS[:7]
            and all(v == MESH_TEST1_QUERIES for v in sub_pairs.values())):
        raise RuntimeError(f"{tag}: validate / serve / validate_rerank / submission under --mesh "
                           f"differ from the runs without it, or last_state.pt is not the run's: "
                           f"{result}")
    os.remove(rerank_ckpt)
    for m in (False, True):
        shutil.rmtree(os.path.join(root, f"submission_{'mesh' if m else 'one'}"))
    mesh_runs = [runs["mesh_live"], runs["mesh_cached"], validate_runs[True], serve_runs[True],
                 *(run[True] for run in rerank_runs.values())]
    result["launches"] = {k: sum(r["launches"][k] for r in mesh_runs) for k in MESH_KERNELS}
    result["launches_by_run"] = {name: {k: r["launches"][k] for k in MESH_KERNELS}
                                 for name, r in zip(("finetune_live", "finetune_cached",
                                                     "validate", "serve", *rerank_runs),
                                                    mesh_runs)}
    log(f"[counters] phase 24, the --mesh runs: K1 {result['launches']['token_max_sim']}, K2 "
        f"{result['launches']['fused_vit_block']}, K3 {result['launches']['fused_qformer_layer']}"
        f"; by run {json.dumps(result['launches_by_run'])}")
    missing = [k for k, v in result["launches"].items() if v <= 0]
    if missing:
        raise RuntimeError(f"{tag}: the --mesh runs launched no {missing}")
    return result


def mesh_kernels(rows, phase):
    """The kernel rows of phase 24: K1, K2 (ViT-L) and K3 at the main path's
    shapes (phase 3's checks), with the --mesh runs' launches."""
    from sprc_tpu_torch.kernel_checks import bound_ms

    by_check = {r["check"]: r for r in rows}
    out = []
    for name, checks, source, replaces in (
            ("token_max_sim (--mesh, NCCL world 1)", ["K1 token_max_sim"],
             "sprc_tpu_torch/csrc/token_max_sim.cu", "sprc_tpu/ops/pallas_sim.py:40"),
            ("fused_vit_block (--mesh, NCCL world 1)", ["K2 vit_block"],
             "sprc_tpu_torch/ops/fused_block.py", "sprc_tpu/ops/pallas_block.py:609"),
            ("fused_qformer_layer (--mesh, NCCL world 1)",
             [f"K3 qformer_layer {s}" for s in ("queries", "fusion", "prompt")],
             "sprc_tpu_torch/ops/fused_qformer.py", "sprc_tpu/ops/pallas_qformer.py:360")):
        rs = [by_check[c] for c in checks]
        work = {"bytes": sum(r["bytes"] for r in rs),
                "op_seconds": sum(r["op_seconds"] for r in rs)}
        count = name.split(" ")[0]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": phase["launches"][count],
                    "max_abs_err": max(r["max_abs_err"] for r in rs),
                    "ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs),
                    **bound_ms(work), "library_ms": None})
    return out


def phase_large_rows(work):
    """Phase 25: the three largest rows at full width, one model on the card
    at a time (the previous one freed first)."""
    out = {}
    for key, fn, arg in (("25a caption opt6.7b", phase_caption, "opt"),
                         ("25b vqa flant5xxl", phase_vqa, "t5"),
                         ("25c instruct vicuna13b", phase_instruct_retrieval, None)):
        gc.collect()
        torch.cuda.empty_cache()
        out[key] = timed(key, fn, work, *([arg] if arg else []), large=True)
    log("[counters] phase 25: "
        + "; ".join(f"{key}: K2 {r['launches']['fused_vit_block']}, K3 "
                    f"{r['launches']['fused_qformer_layer']}, peak {r['peak_memory_gib']:.2f} GiB"
                    for key, r in out.items()))
    return out


# phase 25's kernel rows: the checks of phase 3 at these modules' shapes
# (phases 12, 13 and 14's), with each row's launches
LARGE_KERNELS = {
    "25a caption opt6.7b": (("fused_vit_block", ["K2 vit_block eva_g fp32 S=677 B=16"]),
                            ("attention_f32", ["attention D=88 fp32 S=677 B=16"]),
                            ("fused_qformer_layer", ["K3 qformer_layer caption queries"])),
    "25b vqa flant5xxl": (("fused_vit_block", ["K2 vit_block eva_g B=16"]),
                          ("attention_bf16", ["attention D=88 bf16 B=16"]),
                          ("fused_qformer_layer", ["K3 qformer_layer vqa queries"])),
    "25c instruct vicuna13b": (("fused_vit_block", ["K2 vit_block eva_g B=16"]),
                               ("attention_bf16", ["attention D=88 bf16 B=16"]),
                               ("fused_qformer_layer", ["K3 qformer_layer vqa queries",
                                                        "K3 qformer_layer instruct fusion L=128"])),
}
KERNEL_SOURCES = {
    "fused_vit_block": ("sprc_tpu_torch/ops/fused_block.py", "sprc_tpu/ops/pallas_block.py:609"),
    "attention_f32": ("sprc_tpu_torch/csrc/attention.cu", "sprc_tpu/ops/pallas_attention.py:428"),
    "attention_bf16": ("sprc_tpu_torch/csrc/attention.cu", "sprc_tpu/ops/pallas_attention.py:428"),
    "fused_qformer_layer": ("sprc_tpu_torch/ops/fused_qformer.py",
                            "sprc_tpu/ops/pallas_qformer.py:360"),
}


def large_kernels(rows, phase):
    """The kernel rows of phase 25, with each sub-phase's launches."""
    from sprc_tpu_torch.kernel_checks import bound_ms

    by_check = {r["check"]: r for r in rows}
    out = []
    for key, kernels in LARGE_KERNELS.items():
        for kernel, checks in kernels:
            rs = [by_check[c] for c in checks]
            work = {"bytes": sum(r["bytes"] for r in rs),
                    "op_seconds": sum(r["op_seconds"] for r in rs)}
            library = [r.get("library_ms") for r in rs]
            source, replaces = KERNEL_SOURCES[kernel]
            out.append({"name": f"{kernel} ({key})", "route": "cuda", "source": source,
                        "replaces": replaces, "launches": phase[key]["launches"][kernel],
                        "max_abs_err": max(r["max_abs_err"] for r in rs),
                        "ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs),
                        **bound_ms(work),
                        "library_ms": None if None in library else sum(library)})
    return out


def timed(name, fn, *args, **kw):
    """``fn(*args, **kw)``, its seconds printed on a line of their own."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"[seconds] phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def phases_20_21(work):
    """Phases 20 and 21, each model (and its plain twin) on the card alone."""
    caption_train = {}
    for which in CAPTION_TRAIN:  # 20a
        gc.collect()
        torch.cuda.empty_cache()
        caption_train[which] = timed(f"20a caption train {which}", phase_caption_train, work,
                                     which)
    gc.collect()
    torch.cuda.empty_cache()
    caption_eval = timed("20b caption eval", phase_caption_eval, work)
    gc.collect()
    torch.cuda.empty_cache()
    cir = timed("20c cir features", phase_cir_features, work)
    clip_eval = {}
    for which in ("retrieval", "zero_shot"):
        gc.collect()
        torch.cuda.empty_cache()
        clip_eval[which] = timed(f"21 clip {which}", phase_clip_eval, work, which)
    gc.collect()
    torch.cuda.empty_cache()
    clip_feats = timed("21 clip features", phase_clip_features, work)
    log(f"[counters] phases 20 and 21: K2 a tower call {TOWER_LAUNCHES} (ViT-B, ViT-L), K3 "
        f"{CIR_TEXT_LAUNCHES} a CIR text pass; read: caption train "
        + ", ".join(f"{w} {r['launches_step'][-1].get('fused_vit_block')} a step"
                    for w, r in caption_train.items())
        + f"; caption eval {caption_eval['launches'].get('fused_vit_block')} in "
        f"{-(-CAPTION_EVAL_IMAGES // 16)} calls; CIR features {cir['launches']}; CLIP "
        + ", ".join(f"{w} {r['launches'].get('fused_vit_block')}" for w, r in clip_eval.items())
        + f"; ViT-B/32 {clip_feats['vit_base32']['launches']}; RN50 "
        f"{clip_feats['resnet50']['launches'] or 'none'}")
    return {"caption_train": caption_train, "caption_eval": caption_eval,
            "cir_features": cir, "clip_eval": clip_eval, "clip_features": clip_feats}


def main():
    t_start = time.perf_counter()
    timed("1 device", phase_device)
    timed("2 build", phase_build)
    rows = timed("3 kernels", phase_kernels)
    work = os.path.join(ROOT, "sprc_tpu_torch", "_build", "smoke")
    gallery = list(_gallery_batches(GALLERY, ENCODE_BATCH, 224, SEED))  # set-up, untimed
    bf16 = timed("4 main path bf16 (with 4d)", phase_main_path, work, "bf16", gallery, BOUNDS,
                 raw_phase=True)
    check_counters("bf16", bf16["launches"])
    int8 = timed(
        "4b main path int8", phase_main_path, work, "int8", gallery, None,
        model_kwargs={"vit_quant": "int8_calib", "qformer_int8": True},
        serve_flags=["--qformer-int8"], calibrate=True)
    check_counters("int8", int8["launches"])
    against = report_int8_against_bf16(bf16, int8)
    eva_int8 = timed("4c int8 EVA", phase_eva_int8, gallery)
    del bf16["target_feats"], int8["target_feats"]
    runs = {route: timed(f"5 validate {route}", phase_validate, work, route, gallery)
            for route in ROUTES}
    check_routes_agree(runs)
    rerank = timed("8 rerank serve", phase_rerank_serve, work, gallery)
    rerank_eva = timed("8 rerank validate", phase_rerank_validate, work, gallery)
    gc.collect()  # phase 8's servers and clocks leave reference cycles over its models
    torch.cuda.empty_cache()
    del gallery
    train = timed("7 fine-tune", phase_train, work)
    gc.collect()
    torch.cuda.empty_cache()
    variants = timed("9 variants", phase_variants, work)
    gc.collect()
    torch.cuda.empty_cache()
    stage1_eval = timed("10a stage-1 eval", phase_stage1_eval, work)
    gc.collect()
    torch.cuda.empty_cache()
    stage1_train = timed("10b stage-1 train", phase_stage1_train, work)
    gc.collect()
    torch.cuda.empty_cache()
    unfrozen = timed("11 unfrozen", phase_unfrozen_train, work)
    caption = {}
    for head in CAPTION_HEADS:  # one model on the card at a time
        gc.collect()
        torch.cuda.empty_cache()
        caption[head] = timed(f"12 caption {head}", phase_caption, work, head)
    instruct = timed("12c instruct", phase_instruct)
    stage2_train, vqa = {}, {}
    for head in STAGE2_TRAIN:  # phase 13, one model on the card at a time
        gc.collect()
        torch.cuda.empty_cache()
        stage2_train[head] = timed(f"13 stage-2 train {head}", phase_stage2_train, work, head)
    for head in STAGE2_VQA:
        gc.collect()
        torch.cuda.empty_cache()
        vqa[head] = timed(f"13 vqa {head}", phase_vqa, work, head)
    instruct_runs = {}
    for kind, phase in (("retrieval", phase_instruct_retrieval),
                        ("generate", phase_instruct_generate)):  # phase 14, one 7B at a time
        gc.collect()
        torch.cuda.empty_cache()
        instruct_runs[kind] = timed(f"14 instruct {kind}", phase, work)
    gc.collect()
    torch.cuda.empty_cache()
    pnp = timed("15 pnp_vqa", phase_pnp, work)
    gc.collect()
    torch.cuda.empty_cache()
    img2prompt = timed("16 img2prompt_vqa", phase_img2prompt, work)
    momentum, momentum_eval = {}, {}
    for arch in MOMENTUM_TRAIN:  # phase 17a / 17b, one model (and its plain twin) at a time
        gc.collect()
        torch.cuda.empty_cache()
        momentum[arch] = timed(f"17 momentum train {arch}", phase_momentum_train, work, arch)
    for arch in MOMENTUM_EVAL:  # 17c
        gc.collect()
        torch.cuda.empty_cache()
        momentum_eval[arch] = timed(f"17 momentum eval {arch}", phase_momentum_eval, work, arch)
    head_train, head_eval = {}, {}
    for arch in HEAD_TRAIN:  # 18a / 18b, 19a: one model (and its plain twin) at a time
        gc.collect()
        torch.cuda.empty_cache()
        phase = 18 if arch.endswith("vqa") else 19
        head_train[arch] = timed(f"{phase} heads train {arch}", phase_head_train, work, arch)
    for which in HEAD_EVAL:  # 18c / 18d, 19b
        gc.collect()
        torch.cuda.empty_cache()
        phase = 18 if which in ("rank", "generate") else 19
        head_eval[which] = timed(f"{phase} heads eval {which}", phase_head_eval, work, which)
    new = phases_20_21(work)
    video = phase_video(work)
    dialogue = phase_dialogue_caption(work)
    gc.collect()
    torch.cuda.empty_cache()
    mesh = timed("24 mesh", phase_mesh, work)
    large = phase_large_rows(work)
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")

    # each kernel's count comes from the path that is its own (K1: the first)
    launches = {**int8["launches"], **{k: bf16["launches"][k] for k in PATH_KERNELS["bf16"]},
                "flash_attention_calibration": int8["calibration_launches"]["flash_attention"]}
    for route, (_, own) in ROUTES.items():
        if route != "block":  # K2's count stays the pretrain_vitL path's
            launches.update({k: runs[route]["launches"][k] for k in own})
    launches.update({
        "fused_qformer_layer_rerank": rerank["launches"]["fused_qformer_layer"],
        "fused_qformer_layer_int8_rerank": rerank["launches_int8"]["fused_qformer_layer_int8"],
        "gemm_f32_rerank": rerank["launches"]["gemm_f32"],
        "gemm_f32_rerank_eva": rerank_eva["launches"]["gemm_f32"],
        "gemm_i8_rerank": rerank["launches_int8"]["gemm_i8"],
        "attention_f32_rerank": rerank["launches"]["attention_f32"],
        "fused_qformer_layer_variants": variants["launches"]["fused_qformer_layer"],
        "token_max_sim_stage1_eval": stage1_eval["launches"]["token_max_sim"],
        "fused_vit_block_stage1_eval": stage1_eval["launches"]["fused_vit_block"],
        "fused_qformer_layer_stage1_eval": stage1_eval["launches"]["fused_qformer_layer"],
        "fused_vit_block_stage1_train": stage1_train["launches"]["fused_vit_block"],
        "attention_f32_stage1_eval": stage1_eval["launches"]["attention_f32"],
        # phase 11: the Functions of a tower that trains (the CLI run's, and one
        # step on each other route)
        "FusedViTBlock": unfrozen["launches"]["fused_vit_block"],
        "FusedAttnBlock": unfrozen["route_launches"]["attn+mlp"]["fused_attn_block"],
        "FusedMlpBlock": unfrozen["route_launches"]["attn+mlp"]["fused_mlp_block"],
        "FlashAttention": unfrozen["route_launches"]["unfused"]["flash_attention"]})
    for head, run in caption.items():  # phase 12
        launches.update({f"{k}_caption_{head}": run["launches"][k]
                         for k in ("fused_vit_block", "fused_qformer_layer", "attention_f32")})
    for head, run in stage2_train.items():  # phase 13
        launches.update({f"{k}_stage2_train_{head}": run["launches"][k]
                         for k in ("fused_vit_block", "attention_f32", "attention_bf16")})
    for head, run in vqa.items():
        launches.update({f"{k}_vqa_{head}": run["launches"][k]
                         for k in ("fused_vit_block", "fused_qformer_layer", "attention_bf16")})
    for kind, run in instruct_runs.items():  # phase 14
        launches.update({f"{k}_instruct_{kind}": run["launches"][k]
                         for k in ("fused_vit_block", "fused_qformer_layer")})
    launches.update({f"{k}_pnp": pnp["launches"][k]  # phase 15
                     for k in ("fused_vit_block", "attention_bf16")})
    launches.update({f"{k}_img2prompt": img2prompt["launches"][k]  # phase 16
                     for k in ("fused_vit_block", "attention_bf16")})
    launches["fused_vit_block_instruct_train"] = sum(
        run["train"]["launches"]["fused_vit_block"] for run in instruct_runs.values())
    keep = ("encode_imgs_per_s", "model_alone_imgs_per_s", "query_1_median_ms",
            "query_32_median_ms")
    from sprc_tpu_torch.kernel_checks import bound_ms

    k1 = train.pop("k1_grad")
    # K1 with a gradient: its forward launches on the fine-tune path, its
    # numbers from the check at the training shape: ms / plain_ms the
    # forward's device time (the kernel, the plain version); forward and
    # backward through autograd beside them
    k1_train = {"name": "token_max_sim (TokenMaxSim, fine-tune)", "route": "cuda",
                "source": "sprc_tpu_torch/csrc/token_max_sim.cu",
                "replaces": "sprc_tpu/ops/pallas_sim.py:40",
                "launches": train["launches_steps"]["token_max_sim"],
                "max_abs_err": max(k1["max_abs_err"], k1["grad_max_abs_err"]),
                "ms": k1["ms"], "plain_ms": k1["plain_ms"], **bound_ms(k1), "library_ms": None,
                "fwd_bwd_ms": k1["fwd_bwd_ms"], "plain_fwd_bwd_ms": k1["plain_fwd_bwd_ms"]}
    # K1 without a gradient at the same shape: the rerank twin's scores, and
    # with one the variants' in-batch losses (phase 9's launches)
    k1_variants = dict(k1_train, name="token_max_sim (variant zoo, fine-tune)",
                       launches=variants["launches"]["token_max_sim"])
    # K1 with a gradient at stage-1 pretraining's in-batch shape (B = N = 100)
    k1 = stage1_train.pop("k1_grad")
    k1_stage1 = dict(k1_train, name="token_max_sim (TokenMaxSim, stage-1 pretraining)",
                     launches=stage1_train["launches"]["token_max_sim"],
                     max_abs_err=max(k1["max_abs_err"], k1["grad_max_abs_err"]), ms=k1["ms"],
                     plain_ms=k1["plain_ms"], **bound_ms(k1), fwd_bwd_ms=k1["fwd_bwd_ms"],
                     plain_fwd_bwd_ms=k1["plain_fwd_bwd_ms"])
    print(json.dumps({"kernels": kernel_table(rows, launches) + [k1_train, k1_variants,
                                                                 k1_stage1]
                      + momentum_kernels(rows, momentum, momentum_eval)
                      + heads_kernels(rows, head_train, head_eval)
                      + caption_clip_kernels(rows, *new.values())
                      + video_kernels(rows, video)
                      + dialogue_caption_kernels(rows, dialogue)
                      + mesh_kernels(rows, mesh)
                      + large_kernels(rows, large),
                      "gemm_launches": {"bf16": launches["gemm"], "fp32": launches["gemm_f32"]},
                      "bf16": {k: bf16[k] for k in keep}, "int8": {k: int8[k] for k in keep},
                      "raw_encode": bf16["raw"],
                      "int8_vs_bf16_random_weights": against,
                      "int8_eva_encode_batch_launches": eva_int8,
                      "validate_pretrain": {route: {k: run[k] for k in
                                                    ("encode_imgs_per_s", "model_alone_imgs_per_s",
                                                     "metrics", "launches")}
                                            for route, run in runs.items()},
                      "finetune_pretrain": train,
                      "rerank_vitl": {k: rerank[k] for k in (
                          "query_1_median_ms", "query_32_median_ms", "stage1_32_ms",
                          "order_moved", "tile_int8_ms", "launches", "launches_int8")},
                      "variants_vitl": {
                          "steps": {n: {k: r[k] for k in (
                              "step_median_ms", "samples_per_s", "peak_memory_gib", "loss_gap",
                              "grad_gap", "hard_negatives_moved", "launches_step")}
                              for n, r in variants["variants"].items()},
                          "cli_rerank_cached_gap": variants["cli_rerank_cached_gap"],
                          "launches": variants["launches"], "seconds": variants["seconds"]},
                      "stage1_eval_coco": {k: v for k, v in stage1_eval.items()
                                           if k != "stages"},
                      "stage1_train": stage1_train,
                      "unfrozen_train_coco": unfrozen,
                      "caption_coco": caption, "instruct_synthetic": instruct,
                      "stage2_train": stage2_train, "vqa_zeroshot": vqa,
                      "instruct_vicuna7b": instruct_runs, "pnp_vqa": pnp,
                      "img2prompt_vqa": img2prompt,
                      "momentum_train": momentum, "momentum_eval": momentum_eval,
                      "heads_train": head_train, "heads_eval": head_eval,
                      **new, **video, "dialogue_caption": dialogue, "mesh_world1": mesh,
                      "large_rows": large,
                      "rerank_eva_validate": {k: rerank_eva[k] for k in (
                          "metrics", "tile_s", "candidates_per_s", "host_gather_s",
                          "gather_share", "peak_memory_gib", "total_s", "launches")}}),
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
