"""End-to-end check of the PyTorch port (mllm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and exits non-zero):
  1. device: needs a CUDA card; prints its name and power limit as nvidia-smi
     reports them; TF32 off for matmuls and convolutions.
  2. build: compiles the CUDA kernels in mllm_tpu_torch/csrc with nvcc.
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     same inputs at the slice's shapes, and both times (CUDA events, after
     warm-up). Attention (bf16, H=12, H_kv=2, D=128, cache 2048): max
     |kernel - plain| <= 2e-2 (bf16 output rounding plus another summation
     order). Quantized products: max |kernel - plain| / max |plain| <= 2e-3
     (int8_matmul, int4_matmul: f32 sums in another order) and <= 1e-2
     (fused_int4_mlp: the kernel rounds the hidden activation to bf16, the
     plain version keeps f32); each row also prints the weight bytes read
     over the kernel time, against the H100's 3.35 TB/s. The two megakernels
     (28 layers, cache 2048, random int4 operand stacks; then b=16 and b=32
     at Qwen2-7B's widths, 4 layers, where blocks own several chunks of a
     column tile): max |kernel - plain|
     / max |plain| <= 1e-2 over y, k_new and v_new (bf16 rounding points
     that flip differently, f32 sums in another order; observed <= 6.6e-3).
     The quantized- and paged-cache attention kernels (int8 and int4 K/V
     quantized by the caches' quantizer; a shuffled pool of 128-row blocks,
     PAGED_ROWS: the engine's 8 slots, a retired -1 row, one 1531-key slot, a
     window, and a pool with NaN / inf in every row no slot sees and in its
     spare blocks): max |kernel - plain| <= 2e-2, as the bf16 ones; no
     PyTorch call takes their layouts (`library_ms` null), and
     `dense_sdpa_ms` times SDPA over the same keys in a dense bf16 cache, a
     different function kept for context; the paged rows also time the dense
     decode_attention kernel over the dense view of the same blocks
     (`dense_decode_ms`, the yardstick of the paged kernel).
     The fused MLP rows (FUSED_MLP_ROWS: Qwen2-VL-2B's MLP at m = 1, 4
     affine, 8, 16, 32, gelu_new, and TinyLlama's at m = 1) also time the
     unfused route through the port's kernels (`unfused_ms`: int4_matmul on
     gate and up, the activation, int4_matmul on down).
     The quantized decode rows (QUANT_DECODE_ROWS) include rows whose
     integers and scales outside [kv_start, kv_valid) hold 127 and NaN / inf
     (plain version on them zeroed), and time the bf16 decode_attention
     kernel over the same keys dequantized (`bf16_decode_ms`, the yardstick).
     The quantized prefill rows (QUANT_FLASH_ROWS: the 1536-token prompt, a
     batched admission, a chunk over a long cache, a left-padded batch, a
     sliding window, a poisoned batch, head_dim 64 with 8/8 heads) time the
     bf16 flash_attention kernel over the same keys dequantized
     (`bf16_flash_ms`, the yardstick).
     Every row carries its bound: the larger of its bytes over 3.35 TB/s and
     its FLOPs over 989 TFLOP/s (bf16); the attention main rows also time
     scaled_dot_product_attention on the same inputs (`library_ms`), every
     int8 row torch._weight_int8pack_mm and the int4 main rows
     torch._weight_int4pack_mm on the same weights, repacked outside the
     timed window (`library_ms`; the port never calls either), and the int8
     prefill rows torch.mm on the weight already in bf16 (`cublas_bf16_ms`,
     a yardstick of another function). The bf16
     attention rows (FLASH_ROWS, DECODE_ROWS) include the engine's batched
     admission and rows whose K/V hold NaN and inf outside [kv_start,
     kv_valid), as a slot may after an earlier request: the kernel's output
     must be finite and within the tolerance of the plain version run on the
     same tensors with those rows zeroed. `kernel_geometry` checks both
     kernels at head_dim 64 and 128 with 8/8, 40/2 and 4/1 heads.
     `kernel_check_device_scalars`: the three entries whose scalars may live
     on the card (a captured loop's write head) at B=1 over the 2048 cache:
     flash_attention (q_offset) and flash_attention_quant at int8 and int4
     (q_offset and kv_valid_len) at the speculative verify shape (Sq 9 at
     q_offset 1531) and a 256-row chunk at 1280, and fused_decode_step (pos
     1531), each launched with one-element int32 tensors directly and from a
     CUDA graph replayed with the scalars changed between replays: every
     output bit-equal to the host-int launch at the same values and within
     the tolerance of the plain version; the three kernels' main rows within
     3 % of the final smoke of the tree before the device-scalar entries
     (commit c967662; `kernel_check_main_row_vs_host_entry`).
  4. slice: a Qwen2-VL-2B-geometry LM (28 layers, random bf16 weights from a
     seeded generator) through generate, ragged_batched_generate and a
     sampled generate.
  5. slice_int8 / slice_int4: the same bf16 model after fuse_projections +
     quantize_model("int8" / "int4", on_device=True) on the card, through the
     same entry points (ragged batch of 8 for int8, 4 for int4).
  6. slice_kvq: the int8 model over int8 and int4 KV caches
     (init_cache(kv_dtype=...)) through the same entry points, ragged batch
     of 8; only the quantized attention kernels launch.
  7. slice_engine: ContinuousEngine(slots=8, max_len=2048, decode_window=32,
     pipeline=True) over the int8 model, once per slot cache (bf16 on the
     loop thread, int8, int4, and a paged pool 4 blocks short of what the
     first eight requests reserve, which must requeue): 12 requests of 17-300
     prompt tokens, 48 new tokens each, 2 sampled (top-k 50, top-p 0.9);
     every request returns 48 in-vocabulary tokens, 4 greedy ones lie within
     0.1 x max |logit| of the top of a teacher-forced prefill over a cache of
     the same type, and the launch counts are exact (28 prefill launches an
     admission, 28 decode launches a step, none of the other attention
     kernels). Each run prints tok/s over wall time, windows, decode steps,
     KV-cache bytes and peak memory.
  8. slice_mega: MegaDecodeLM.from_float of the bf16 model on the card, then
     generate at b=1 (prompts 100 and 1500) and batched_generate at b=8
     lockstep on the megakernel, and ragged_batched_generate through its int4
     base; exact launch counts (one megakernel and one head int4_matmul a
     step, no decode_attention or fused_int4_mlp), the last decode step and 8
     teacher-forced steps against the base model (<= 0.1 x max |logit|);
     then the slice_engine run on it over a bf16 slot cache, every decode
     step one fused_decode_step_batched launch.
  slice_compiled (in phases 4, 5, 6 and 8): generate_compiled, whose decode
     loop replays a CUDA graph of 32 steps a window (the host reads `done`
     once a window), on the bf16, int8, int4 and megakernel models and the
     int8 model over int8 KV: prompts of 100 and 1500 tokens, 256 new tokens,
     greedy tokens equal to the eager generate on the same model, a sampled
     bf16 run equal to the eager sampled run with the same seed, and exactly
     one graph replay a window; it prints tok/s of both, wall ms a token and
     device ms a step (CUDA events around one replay / 32).
  slice_sd (int8 model): bench.py's bench_sd prompts (a 16-token pattern x 8,
     max_draft 8; Zipf(1.3) over 8192 ids, max_draft 4), 128 new tokens each
     through speculative_generate_compiled (one graph of 8 verify steps a
     window), speculative_generate and speculative_generate_tree (max_draft
     6, 3 traces): every token within 0.1 x max |logit| of the top of a
     teacher-forced prefill; prints lossless (equal to generate_compiled),
     the first divergence, steps, drafted, accepted and tok/s against
     generate_compiled.
  slice_prefill (int8 model): chunked_prefill of a 1500-token prompt in
     chunks of 256 over bf16 and int8 KV against a one-shot prefill (last
     logits within 0.1 x max |logit|); prefill_with_prompt_cache of a second
     prompt sharing the first 1024 tokens (matched exactly 1024) and of the
     same prompt again (a full hit), within the same tolerance; prints ms.
  The engine runs replay a captured window graph for every window (one for
     greedy windows, one for sampled ones, captured at first use after a
     warm-up model call that changes no state), and slice_engine adds
     `engine_prefix`: prefix_cache=8 on the int8 model, bench_engine("prefix")
     traffic (a shared 128-token prefix and a distinct 128-token tail, 8
     requests x 48 new tokens): exactly 7 hits and 896 reused rows, the
     teacher-forced check of 4 greedy requests, tok/s beside the bf16 engine
     with eager windows (85.7, commit c967662's final smoke).
  9. head_dim_route: 2-layer qwen2-type models at head_dim 256, then 80 (8 /
     2 heads, random bf16 weights) through generate and generate_compiled:
     at 256 the bf16 flash and decode kernels serve attention (a quantized
     cache would take `sdpa`), at 80 only `sdpa` (no attention kernel
     launches); finite logits, the last decode step within 0.1 x max
     |logit| of a fresh prefill.
  10. slice_int8a8: int8_matmul_a8 (torch._int_mm) at (17, 1536, 2048),
     (1536, 1536, 8960) and (1536, 8960, 1536) within 2e-3 of the exact
     product of x quantized in f64 apart from the port, a8_quantize's int8 x
     and scales bit-equal to its CPU result, timed beside torch.mm on the
     bf16 weight, the int8 kernel and _int_mm alone on both weight layouts;
     the bf16 model through
     quantize_model("int8-a8", on_device=True): the 1500-token prefill
     against its int8 twin (same weights, weight-only), logits within 0.1 x
     max |logit|, and ragged_batched_generate at b=8 with A8 on the
     prefill's 4L projections only.
  11. slice_containers: the full-width LM as ggml blocks made from seeded
     random bytes (Q4_0 q/k/v/o, Q4_K gate/up, Q8_0 down, f16 tied
     embedding, f32 norms and biases) written as a `.mllm` model directory
     (with a synthetic 151936-entry tokenizer.json: byte-level BPE, or
     SentencePiece BPE where `regex` is absent) and as a GGUF file under
     build/smoke_containers/, loaded by auto_model and load_gguf_model: the
     two loads' prefill logits bit-equal, layer 0's repacked products
     within 2e-3 of the blocks' dequant (Q8_0, requantized to a scale a
     row: within that requantization's bound, and 2e-3 of its own
     operands), the last greedy step against a fresh prefill, tokenizer
     round trips on an ASCII and a CJK text, exact launches by int4 law.
  12. slice_serve: mllm_tpu_torch.serve on 127.0.0.1, port 0, over that
     model: --engine continuous (8 slots, int8 KV) takes 8 completions of
     17-300 prompt tokens, 2 chats and 1 streamed completion (48 new tokens
     each) concurrently through urllib; the stream equals the plain text,
     /metrics counts 11 requests and 11 first tokens, /healthz answers,
     greedy tokens within 0.1 x max |logit| of a teacher-forced prefill;
     then 2 requests each through --engine window and --engine sd. Prints
     tok/s over wall time, the windows' capture seconds apart, and each
     request's time to first token.
  13. slice_moe: the JAX bench's MoE geometry (hidden 1024, 16 layers, 16/8
     heads, 16 experts, top-4, expert ff 512, shared expert 2048, vocab
     32768; random weights at MoEMLP.init's scale) at full depth: one
     layer's dense and ragged branch times at t = 1 .. 1024 tokens (bf16 and
     int8 experts; the two branches within 3e-2 x max |y| of each other),
     then bf16, "int8" and "int4" (fuse_projections + quantize_model)
     through batched_generate at b=8 (128 prompt tokens, 128 new), the last
     decode step of a b=1 generate against a fresh prefill, slice_compiled
     (generate_compiled at b=1 equal to eager),
     exact launches of every kernel the mode runs, and the bf16 model
     through the engine as slice_engine runs it.
  14. slice_moe_wide: Qwen1.5-MoE-A2.7B's published width (hidden 2048, 24
     layers, 16/16 heads, 60 experts, top-4, expert ff 1408, shared expert
     5632 with its sigmoid gate, vocab 151936, untied; 14.3 G parameters, no
     depth cut): the branch times, then bf16 and "int8" through
     batched_generate at b=1 and b=8 (128 prompt tokens, 64 new), exact
     launches, peak memory.
  15. slice_families: gemma-2b, gemma2-2b, stablelm2-1.6b, phi3-mini,
     phonelm-1.5b (with int8 RoPE tables) and dclm-1b at full width, depth
     cut to 4 layers: generate (100-token prompt, 32 new) with the last
     decode step against a fresh prefill, generate_compiled equal to it, and
     exact attention launches (Gemma-2B at head_dim 256, StableLM, PhoneLM
     and DCLM: the bf16 kernels; Gemma2's softcap and Phi-3's head_dim 96:
     `sdpa`).
  16. slice_vl: Qwen2-VL-2B as bench.py's image-prefill row builds it (the
     default tower: depth 32, width 1280, 16 heads of 80, mlp 5120, merge 2,
     over the LM above with 4096 positions; random bf16 weights): one tower
     pass launches the head_dim-80 flash kernel 32 times and agrees with the
     same pass on the plain attention (<= 0.1 x max |embed|); the bench row's
     prefill (a seeded 1024 px frame resized to 532 px: grid (1, 38, 38),
     1444 patches, 361 vision tokens, 393 prompt tokens, a 1024-row cache)
     within 0.1 x max |logit| of the plain route, timed on the RGB and the
     I420 wire (end to end, device ms by CUDA events with the frame on the
     card, the host resize; medians of 9 after a warm-up); vl_generate and
     vl_generate_compiled (64 tokens, equal, within 0.1 x max |logit| of a
     teacher-forced prefill); vtp_prefill at keep 0.5, prune layer 2 (cache
     head 212, finite logits); then quantize_model("int8", on_device=True):
     the prefill timed again, 16 tokens over an int8 KV cache against a
     teacher-forced prefill over the same cache type, the engine (ENGINE_KW)
     serving 4 image requests at 448 px (256 vision tokens, patchified on the
     card) among 8 text requests of 17-300 tokens, 48 new each (every
     request against a teacher-forced prefill, 32 head_dim-80 launches an
     image, every window a replay), and, where PIL imports, one PNG chat
     request through mllm_tpu_torch.serve on 127.0.0.1.
  17. slice_vl25: Qwen2.5-VL-3B at its published config.json (full depth:
     the windowed tower on `sdpa` with the same-window bias, the 36-layer
     LM): one 532 px image prefill (device ms, median of 5) and 32 eager
     decode tokens against a teacher-forced prefill; no head_dim-80 flash
     launch (the reference runs these blocks on XLA sdpa).
  18. slice_clip: bench.py's clip-vitb-scoring row: CLIP ViT-B/32 at HF's
     default widths, bf16, one 224 px image against 8 texts of 77 tokens:
     logits_per_image [1, 8] within 5e-2 x max |logit| of the same weights in
     f32 on the host; score ms a median of 5.
  19. slice_kvq256: Gemma-2B (published widths and depth, 18 layers, random
     bf16 weights) over int8 and int4 KV caches, driven as slice_kvq (drive():
     generate, ragged_batched_generate at b=8, sampled), generate_compiled
     over int8 KV and the engine (ENGINE_KW) over an int8 SlotQuantKVCache:
     exactly 18 flash_attention_quant launches a prefill or admission and 18
     decode_attention_quant a decode step (head_dim 256), eager and captured,
     no bf16 attention kernel and no call of `nn.attention.sdpa`.
  20-22. slice_llava, slice_phi3v, slice_fuyu: LLaVA-1.5-7B (CLIP ViT-L/14 at
     336 px, 576 image tokens, the 32-layer LM), Phi-3-V (the same tower, 157
     image tokens, the Phi-3 LM with LongRope; head_dim 96 on `sdpa`) and
     Fuyu-8B (a 480 x 640 image as 336 patches of 30 px spliced at |SPEAKER|,
     the 36-layer Persimmon LM) at their published configs, random bf16
     weights: an image prefill and 32 greedy tokens through forward, the last
     decode step within 0.1 x max |logit| of a fresh prefill with the image,
     exact attention launches (2 x L flash_attention, 31 x L
     decode_attention; none for Phi-3-V).
  23. slice_imagebind: bench.py's imagebind-trimodal row (ImageBind-huge, 1
     video x 3 texts x 3 audio clips): both score matrices within 5e-2 x max
     of the same weights in f32 on the host; score ms a median of 5.
  24. slice_opt_bert: OPT-1.3B (a 100-token prefill, 32 greedy tokens through
     forward, as examples/demo_opt.py; decode vs prefill; exact flash /
     decode launches at head_dim 64), then BERT-base encoding 8 sentences of
     64 tokens into unit sentence embeddings within 5e-2 x max of f32 on the
     host.
  25. slice_openelm: OpenELM-1_1B (apple/OpenELM-1_1B's config: 28 layers of
     16-32 query / 4-8 KV heads of 64, FFN 1024-8192; random bf16 weights)
     through forward, a 1500-token prefill and 32 greedy tokens at b=1 and
     at b=4 lockstep (where the narrower layers' live KV heads are copied
     contiguous): exactly 28 flash_attention@64 launches a prefill and 28
     decode_attention@64 a step, no `sdpa` call, the last step within 0.1 x
     max |logit| of a fresh prefill; then the copy's ms beside the kernels'
     over the copied heads (`slice_openelm_contiguity`).
  26. slice_deepseek: MiniCPM3-4B (openbmb/MiniCPM3-4B's config, 62 layers,
     MLA K 96 / V 64) with a 1500-token prompt and DeepSeek-V3's widths at
     depth 2 (layer 0 dense, layer 1 the 256-expert MoE layer, group-limited
     routing over a random correction bias; ~28 GB) with a 512-token prompt,
     each through generate and generate_compiled (`gen_pair`: 32 tokens, the
     last step against a fresh prefill, compiled equal to eager up to
     near-ties, no attention kernel: MLA is the port's `sdpa`).
  27. slice_elastic: the Qwen2-VL-2B LM: elastic_model(1.0) bit-equal, then
     the full model, elastic_model(0.5, 0.5) (6 / 1 heads, FFN 4480),
     sparse_model(threshold 0) and, after quantize_model("int8"),
     elastic_model(0.5, 0.5) of it through `gen_pair` (1500-token prompt,
     32 tokens): exact flash / decode launches, and 7 int8_matmul a layer
     plus the head's a forward at the sliced shapes.
  28. slice_mbp: Qwen1.5-MoE-A2.7B's widths, 4 layers, through to_mbp (16
     and 4 device entries; experts in pinned host memory) and mbp_forward:
     128 prompt tokens and 32 greedy ones, every step within 0.1 x max
     |logit| of the resident model's forward and within 1e-2 x max |logit|
     of the resident model routed onto MBP's own experts (`RouteTap`; near
     ties flip experts between the unforced two); hit rate, bytes copied,
     ms a token.
  29. slice_persist: the main-geometry LM over a dense and an int8 cache:
     1500 prompt tokens and 8 greedy ones, save_cache / load_cache, 8 more,
     token-identical to 16 uninterrupted; a SlotKVCache round trip
     bit-equal; Profiler.report, torch_trace over 4 decode steps (CUDA
     kernels in the trace), cost_table of one eager decode step.
  30. slice_train: LoRA rank 8 on q/k/v/o of the main-geometry LM (bf16, 28
     layers), AdamW, 8 steps on one B=2 x S=512 batch: the loss falls, the
     base tensors stay bit-equal, no attention kernel launches in a loss that
     needs gradients (those calls take `sdpa`), remat gradients equal within
     1e-2 x max |grad|, the merged model within 0.1 x max |logit| of the
     adapted one and within 0.05 x their gap to the base (which the adapters
     at half their scale exceed), and
     save_safetensors_model -> auto_model reloads it with equal greedy
     tokens; ms a step and peak memory with and without remat.
  tp_int4_split_rows (in phase 3): int4_matmul and fused_int4_mlp at the
     rank shapes of Qwen2-VL-2B int4 at tp 2 and tp 4 (heads padded): the
     fused q||k||v, o_proj, the tied head's proj and the fused MLP (F / tp
     4480 / 2240 with block_f 896 / 448: the rank's MLP stays fused), m = 1
     and 8, cut from full-width weights by the port's pure cuts; every rank
     within QUANT_TOL of its plain version, the ranks' column outputs side by
     side and row / MLP partials summed in f32 within QUANT_TOL of the
     unsplit kernel (`whole_rel_err`); rank 0 timed beside its bound and
     torch._weight_int4pack_mm.
  31. slice_parallel: a world of 1 over NCCL: sharded_generate against
     generate_compiled (full width, tokens equal, decode tok/s sharded and
     plain), the TP engine against the plain one over bf16 and int8 slot
     caches (8 slots, window 32; tokens equal, tok/s), then over the model
     quantized to -q int4 (FusedInt4MLP, the int4 head) and -q int4-mixed
     (attention int8) on bf16 slots (tokens equal, every window a replay,
     fused_int4_mlp and int4_matmul launched on both sides, int8_matmul too
     under int4-mixed), and sharded_generate over the int4 model padded for
     tp 4 by pad_heads_for_tp (12 / 4 heads, the int4 projections re-laid;
     tokens equal to generate_compiled unpadded), sgd_train_step (the
     f32 update of each parameter within 1e-2 of its largest),
     pipeline_lm_loss, ring and Ulysses trunks (4 layers, full width) and
     moe_forward_ep (QWEN2_MOE_08B's widths, 2 layers) against their
     single-device counterparts, then `python -m
     mllm_tpu_torch.parallel.dryrun --device cuda`.
  32. slice_cli: the text entry points (`mllm_tpu_torch.examples`,
     `mllm_tpu_torch.tools`) through each CLI's `main`, in process: a
     full-width Qwen2-VL-2B LM directory (28 layers, bf16 safetensors with
     an untied head, synthetic tokenizer) through demo_llm greedy, -q int8,
     -q int4, --kv int8, --chunked 256 --turns 2, --batch 3 and demo_sd (host
     and --compiled), 32 tokens each: tokens in the vocabulary, no output one
     repeated token, each kernel of the
     path launched as often as the path needs, the greedy ids equal to
     `generate` called directly, turn 2 a full prefix-cache hit; then the
     convertor -> quantizer (Q4_0, Q8_0) -> demo_llm pipeline at full width
     and 2 layers (int4_matmul / int8_matmul launched, ids equal to a direct
     load), and as processes `python -m mllm_tpu_torch.examples.demo_qwen`
     (exit 0), the same without a visible card (non-zero, default_device's
     message) and `python -m mllm_tpu_torch.tools.ci` ("ok": true on cuda).
     Prints each run's prefill and decode tok/s beside the card's name and
     power limit.
  The kernel check also runs flash_attention and decode_attention at head_dim
  256 (Gemma-2B's 8 / 1 heads: FLASH_ROWS_256, DECODE_ROWS_256, poisoned rows
  included; the `@256` rows of the kernels line, whose launches are those at
  head_dim 256 in head_dim_route and slice_families; the flash kernel's key
  split also with a device q_offset, a 512-row chunk over 1536 keys launched
  directly and replayed from a CUDA graph at three offsets, each replay
  bit-equal to the direct launch: WIDE_SCALAR_ROW), flash_attention_quant
  and decode_attention_quant at 256, int8 and int4 (QUANT_FLASH_ROWS_256,
  QUANT_DECODE_ROWS at 8 / 1 heads, stale rows included; `route_sdpa_ms`
  times the port's `sdpa` over the same keys dequantized, which served these
  calls before; their launches are slice_kvq256's), and checks
  decode_attention_paged at 256 over PAGED_ROWS' pools; and flash_attention
  at head_dim 80 (FLASH80_ROWS: non-causal, 16 / 16 heads, S = 1444, 1024,
  4096, and 1444 with kv_valid 1300 and NaN / inf past it), the kernel (its
  own body: a 64-column and a 16-column box a row, a persistent grid)
  against its plain version (<= 2e-2) timed beside the padded design
  (`padded_ms`: q/k/v zero-padded to 128 in memory, the D = 128 kernel, the
  output cropped) and SDPA at D = 80 (`library_ms`): the `@80` row of the
  kernels line, whose launches are the towers' in slice_vl; int8_matmul adds
  the tower's (1444, 1280, 3840) and (1444, 5120, 1280).
  It checks flash_attention and decode_attention at head_dim 64 at
  OpenELM-1_1B's widest layer (32 / 8 heads: FLASH_ROWS_64 with the 1536-
  and 1500-token prefills, DECODE_ROWS_64 with the b=4 step at 1531 keys,
  poisoned rows, a window, B=1 and B=8 included; <= 2e-2 and <= 0.1 by
  `row_rel_err`, which a plain version short of 64 keys must exceed), beside
  their bounds and SDPA:
  the `@64` rows of the kernels line, whose launches are slice_openelm's;
  then flash_attention@64's persistent grid with a device q_offset
  (NARROW_SCALAR_ROWS: a 512-row chunk at q_offset 1024 and the 256-row
  chunk of `demo_llm --chunked 256` at 1280, over 1536 keys, launched
  directly and replayed from a CUDA graph at three offsets, each replay
  bit-equal to the direct launch, all within 2e-2 of the plain version) and at the bench's
  other head_dim 64 GQA ratios (FLASH64_GQA_GEOS: TinyLlama-1.1B's 32 / 4
  and Qwen MoE 0.8B's 16 / 8 heads, the 1536-token prompt) beside SDPA.
  The build line lists [kernel, registers, spill stores, spill loads] for
  every kernel; a bf16 flash kernel that spills fails the build phase.
  Every phase after the build prints its seconds (`<phase>_seconds`).
  Launch counts with graphs: a wrapper counts where it launches, so inside a
  capture once per recorded launch; the phases that replay graphs restate
  them as launches on the card (`graphs.device_launches`: the counters less
  the captures' recorded launches, plus each graph's launches times its
  replays), and steps of a window past the end of a loop count too.
  Every slice phase checks finite logits and tokens inside the vocabulary;
  phases 4-6 also ragged-vs-alone prefill logits, the last greedy decode
  step's logits against a fresh prefill of the same tokens (<= 0.1 x max
  |logit|), and that each kernel of the path launched at least as often as
  the path needs. The counters are set to 0 just before a phase drives its
  path and read just after.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or mllm_tpu.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

QWEN2VL_2B_LM = dict(  # the language model of Qwen2-VL-2B (bench.py's headline geometry)
    vocab_size=151936, hidden_size=1536, intermediate_size=8960, num_hidden_layers=28,
    num_attention_heads=12, num_key_value_heads=2, head_dim=128,
    max_position_embeddings=32768, eos_token_id=-2,  # -2: never stop early
)
H, HKV, D, S_CACHE = 12, 2, 128, 2048
TOL = 2e-2
QUANT_TOL = {"int8_matmul": 2e-3, "int4_matmul": 2e-3, "fused_int4_mlp": 1e-2}  # relative
RAGGED_TOL = 1e-1  # x max |logit|
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# the kernel-check rows whose times go into the {"kernels": ...} line: for
# attention the shapes of the 1500-token prompt (its prefill, its last decode
# step); for the products the headline shapes of their phases; for the
# megakernels the b=1 step at ctx 1531 and the b=8 step at unequal positions
MAIN_ROW = {"flash_attention": 5, "decode_attention": 1, "int8_matmul": 1, "int4_matmul": 4,
            "fused_int4_mlp": 0, "fused_decode_step": 2, "fused_decode_step_batched": 0,
            # int8 K/V: the 1536-token prefill; the engine's 8 slots at unequal lengths
            "flash_attention_quant": 0, "decode_attention_quant": 1, "decode_attention_paged": 0,
            # head_dim 256 (Gemma-2B's attention): the 1536-token prefill, its last decode step
            "flash_attention@256": 0, "decode_attention@256": 0,
            # head_dim 80 (the Qwen2-VL tower): a 532 px image's 1444 patches
            "flash_attention@80": 0,
            # head_dim 256 over int8 K/V (Gemma-2B): the 1536-token prefill; the engine's 8 slots
            "flash_attention_quant@256": 0, "decode_attention_quant@256": 1,
            # head_dim 64 (OpenELM-1_1B's widest layer): the 1536-token prefill; the b=4 step at 1531 keys
            "flash_attention@64": 0, "decode_attention@64": 0}
SOURCES = {
    "flash_attention": ("mllm_tpu_torch/csrc/flash_attention.cu",
                        "mllm_tpu/ops/flash_attention.py:230"),
    "decode_attention": ("mllm_tpu_torch/csrc/decode_attention.cu",
                         "mllm_tpu/ops/decode_attention.py:317"),
    "int8_matmul": ("mllm_tpu_torch/csrc/int8_matmul.cu", "mllm_tpu/ops/quant_matmul.py:89"),
    "int4_matmul": ("mllm_tpu_torch/csrc/int4_matmul.cu", "mllm_tpu/ops/quant_matmul.py:322"),
    "fused_int4_mlp": ("mllm_tpu_torch/csrc/fused_int4_mlp.cu", "mllm_tpu/ops/fused_mlp.py:169"),
    "fused_decode_step": ("mllm_tpu_torch/csrc/decode_step.cu", "mllm_tpu/ops/decode_step.py:300"),
    "fused_decode_step_batched": ("mllm_tpu_torch/csrc/decode_step.cu",
                                  "mllm_tpu/ops/decode_step.py:717"),
    "flash_attention_quant": ("mllm_tpu_torch/csrc/flash_attention_quant.cu",
                              "mllm_tpu/ops/flash_attention.py:309"),
    "decode_attention_quant": ("mllm_tpu_torch/csrc/decode_attention_quant.cu",
                               "mllm_tpu/ops/decode_attention.py:244"),
    "decode_attention_paged": ("mllm_tpu_torch/csrc/decode_attention_paged.cu",
                               "mllm_tpu/ops/decode_attention.py:461"),
    "flash_attention@256": ("mllm_tpu_torch/csrc/flash_attention.cu",
                            "mllm_tpu/ops/flash_attention.py:230"),
    "decode_attention@256": ("mllm_tpu_torch/csrc/decode_attention.cu",
                             "mllm_tpu/ops/decode_attention.py:317"),
    "flash_attention@80": ("mllm_tpu_torch/csrc/flash_attention.cu",
                           "mllm_tpu/ops/flash_attention.py:230"),
    "flash_attention_quant@256": ("mllm_tpu_torch/csrc/flash_attention_quant.cu",
                                  "mllm_tpu/ops/flash_attention.py:309"),
    "decode_attention_quant@256": ("mllm_tpu_torch/csrc/decode_attention_quant.cu",
                                   "mllm_tpu/ops/decode_attention.py:244"),
    "flash_attention@64": ("mllm_tpu_torch/csrc/flash_attention.cu",
                           "mllm_tpu/ops/flash_attention.py:230"),
    "decode_attention@64": ("mllm_tpu_torch/csrc/decode_attention.cu",
                            "mllm_tpu/ops/decode_attention.py:317"),
}
MEGA_TOL = 1e-2  # relative, on y and on k_new/v_new
BF16_FLOP_PER_S = 989e12  # H100 SXM, dense tensor cores


def emit(**kw):
    print(json.dumps(kw), flush=True)


def time_ms(fn, iters: int) -> float:
    """Device time per call of `fn`, launched back to back.

    The calls are queued behind a ~50 ms GPU spin, so the card finds them all
    waiting: the events then time the kernels, not the wrapper's host
    overhead (tens of microseconds a call, longer than the small kernels)."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # cycles: ~50 ms at the H100's 1.98 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the bf16 tensor-core rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def wrappers() -> dict:
    """Kernel name -> its wrapper (each counts its launches in `.launches`)."""
    from mllm_tpu_torch.ops.decode_attention import (decode_attention, decode_attention_paged,
                                                     decode_attention_quant)
    from mllm_tpu_torch.ops.decode_step import fused_decode_step, fused_decode_step_batched
    from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_quant
    from mllm_tpu_torch.ops.fused_mlp import fused_int4_mlp
    from mllm_tpu_torch.ops.quant_matmul import int4_matmul, int8_matmul

    return {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "int8_matmul": int8_matmul, "int4_matmul": int4_matmul,
            "fused_int4_mlp": fused_int4_mlp, "fused_decode_step": fused_decode_step,
            "fused_decode_step_batched": fused_decode_step_batched,
            "flash_attention_quant": flash_attention_quant,
            "decode_attention_quant": decode_attention_quant,
            "decode_attention_paged": decode_attention_paged}


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit(phase="device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return name


def phase_build():
    from mllm_tpu_torch.ops import _build

    path, log, seconds = _build.build()
    _build.library()
    ptxas = ptxas_summary(log)
    emit(phase="build", seconds=round(seconds, 3), library=path, ptxas=ptxas)
    # the bf16 flash kernels (csrc/flash_attention.cu), the quantized decode
    # kernel and the quantized flash kernel at head_dim 256 must not spill
    spilled = [k for k in ptxas if k[0].startswith(("flash_fwd_kernel", "flash_narrow_kernel", "decode_quant_kernel",
                                                    "flash_quant_wide_kernel")) and (k[2] or k[3])]
    if spilled:
        raise AssertionError(f"attention kernels spill registers (kernel, registers, stores, loads): {spilled}")


def ptxas_summary(log: str) -> list:
    """[kernel, registers, spill stores, spill loads] for each kernel that
    `nvcc -Xptxas -v` reports (the kernel named by its mangled source and
    function, shortened)."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            tail = re.split(r"_cu_[0-9a-f]{8}", m.group(1))[-1]
            cur = [re.sub(r"^\d+", "", tail)[:48], None, None, None]
            out.append(cur)
        elif cur is not None and "spill stores" in ln:
            nums = re.findall(r"(\d+) bytes spill", ln)
            cur[2], cur[3] = int(nums[0]), int(nums[1])
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur[1] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def attention_bound(shape: dict, key_bytes=None) -> dict:
    """Bytes and FLOPs an attention row needs: q and the output once, each K/V
    row that some query sees once (key_bytes a key and KV head, K and V
    together; bf16 by default), and QK plus PV for every visible pair."""
    b, h, d = shape["B"], shape["H"], shape["D"]
    sq = shape.get("Sq", 1)
    kvl = shape["kv_valid"] if isinstance(shape["kv_valid"], list) else [shape["kv_valid"]] * b
    starts = shape["kv_start"] or [0] * b
    window = shape["window"] or 0
    pairs = rows = 0
    for i in range(b):  # query positions: q_offset + t (flash), the last valid key (decode)
        qpos = [shape["q_offset"] + t for t in range(sq)] if "Sq" in shape else [kvl[i] - 1]
        lo = lambda p: max(starts[i], p - window + 1 if window else 0)  # noqa: E731
        hi = lambda p: min(p, kvl[i] - 1)  # noqa: E731
        pairs += sum(max(0, hi(p) - lo(p) + 1) for p in qpos)
        rows += max(0, hi(qpos[-1]) - lo(qpos[0]) + 1)
    key_bytes = d * 2 * 2 if key_bytes is None else key_bytes
    return bound(2 * b * sq * h * d * 2 + rows * shape["Hkv"] * key_bytes, 4 * pairs * h * d)


# flash: (B, Sq, q_offset, kv_valid (an int, or one per sequence), kv_start, window, poisoned)
FLASH_ROWS = [
    (1, 128, 0, 128, None, None, False),
    (1, 200, 0, 200, None, None, False),
    (1, 128, 256, 384, None, None, False),            # chunk of a chunked prefill
    (4, 200, 0, 200, [0, 17, 64, 150], None, False),  # left-padded ragged batch
    (1, 200, 0, 200, None, 64, False),                # sliding window
    (1, 1536, 0, 1536, None, None, False),            # the 1500-token prompt's bucket
    (8, 128, 0, [128, 17, 100, 64, 128, 90, 33, 120], None, None, False),  # the engine's batched admission
    (4, 256, 0, [256, 200, 131, 250], [0, 17, 64, 150], None, True),     # stale NaN / inf rows
]
# decode: (B, kv_valid per sequence, kv_start, window, poisoned)
DECODE_ROWS = [
    (1, [2048], None, None, False),
    (1, [1531], None, None, False),  # the 1500-token prompt's last decode step
    (4, [1, 511, 513, 2048], None, None, False),
    (4, [231, 231, 231, 231], [183, 136, 72, 0], None, False),  # the ragged batch's last step
    (8, [1, 511, 513, 2048, 100, 1000, 1531, 777], [0, 0, 5, 100, 0, 50, 0, 3], None, False),
    (4, [1, 511, 513, 2048], [0, 3, 7, 9], 256, False),
    (4, [0, 77, 2083, 1531], [0, 13, 100, 700], None, True),  # stale NaN / inf rows; a slot past the cache
]


def poison_outside(x, lo, hi):
    """K or V [B, H_kv, S, D] with the rows outside [lo[b], hi[b]) filled with
    NaN and inf (alternating), as an earlier request may leave them in a slot;
    returns (poisoned, the same with those rows zeroed)."""
    j = torch.arange(x.shape[2], device=x.device)
    lo_t, hi_t = (torch.tensor(xs, device=x.device)[:, None] for xs in (lo, hi))
    bad = ((j[None] < lo_t) | (j[None] >= hi_t))[:, None, :, None]
    fill = torch.where(j % 2 == 0, float("nan"), float("inf")).to(x.dtype)[None, None, :, None]
    return torch.where(bad, fill, x), torch.where(bad, torch.zeros_like(x), x)


def attention_inputs(kind: str, row: tuple, dev, g, geo=(H, HKV, D)):
    """Random bf16 inputs of one row of FLASH_ROWS / DECODE_ROWS (by default
    H=12, H_kv=2, D=128; `geo` = (H, H_kv, D) else; cache S_CACHE): (q, k, v,
    k_plain, v_plain, kwargs, shape). A poisoned row's kernel inputs hold NaN /
    inf outside [kv_start, kv_valid); k_plain / v_plain have those rows zeroed
    (else they are k, v)."""
    H, HKV, D = geo  # noqa: N806

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)

    def ivec(xs):
        return torch.tensor(xs, device=dev, dtype=torch.int32)

    if kind == "flash_attention":
        b, sq, qoff, kvl, start, window, poisoned = row
        q = rnd(b, sq, H, D)
        kw = dict(q_offset=qoff, kv_valid_len=ivec(kvl) if isinstance(kvl, list) else kvl,
                  kv_start=None if start is None else ivec(start), window=window)
        shape = dict(B=b, Sq=sq, H=H, Hkv=HKV, D=D, S=S_CACHE, q_offset=qoff, kv_valid=kvl,
                     kv_start=start, window=window)
    else:
        b, kvl, start, window, poisoned = row
        q = rnd(b, 1, H, D)
        kw = dict(kv_valid_len=ivec(kvl), kv_start=None if start is None else ivec(start), window=window)
        shape = dict(B=b, H=H, Hkv=HKV, D=D, S=S_CACHE, kv_valid=[min(n, S_CACHE) for n in kvl],
                     kv_start=start, window=window)
        if max(kvl) > S_CACHE:
            shape["kv_valid_given"] = kvl
    k, v = rnd(b, HKV, S_CACHE, D), rnd(b, HKV, S_CACHE, D)
    kp, vp = k, v
    if poisoned:
        hi = kvl if isinstance(kvl, list) else [kvl] * b
        lo = start or [0] * b
        (k, kp), (v, vp) = poison_outside(k, lo, hi), poison_outside(v, lo, hi)
        shape["poisoned"] = "NaN / inf outside [kv_start, kv_valid); plain version on the rows zeroed"
    return q, k, v, kp, vp, kw, shape


def phase_kernels(dev) -> dict:
    from mllm_tpu_torch.ops.decode_attention import decode_attention, decode_attention_ref
    from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(1234)
    rows = {}
    for kind, kernel, plain, row_list in (("flash_attention", flash_attention, flash_attention_ref, FLASH_ROWS),
                                          ("decode_attention", decode_attention, decode_attention_ref,
                                           DECODE_ROWS)):
        rows[kind] = attention_rows(kind, kind, kernel, plain, row_list, dev, g)
    attention_geometry_checks(dev, g)
    sdpa_route_checks(dev, g)
    rows.update(kv_kernel_rows(dev, g))
    rows.update(quant_kernel_rows(dev, g))
    rows.update(mega_kernel_rows(dev, g))
    device_scalar_rows(dev, g, rows)
    rows.update(wide_kernel_rows(dev, g))
    rows["flash_attention@80"] = flash80_rows(dev, g)
    rows.update(head_dim64_rows(dev, g))
    for name, split_rows in timed_phase("tp_split_rows", lambda: tp_split_rows(dev, g)).items():
        rows[name] += split_rows
    for name, split_rows in timed_phase("tp_int4_split_rows", lambda: tp_int4_split_rows(dev, g)).items():
        rows[name] += split_rows
    return rows


def row_rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest, over the output rows (one query of one head) whose plain
    version is not all zero, of max |kernel - plain| / mean |plain| in that
    row. An output row over n keys is ~n^-1/2 in size, so the absolute TOL
    alone would pass a kernel that drops a tile of keys from a long row."""
    d = ref.shape[-1]
    err = (out.float() - ref.float()).abs().reshape(-1, d).amax(-1)
    mean = ref.float().abs().reshape(-1, d).mean(-1)
    live = mean > 0
    return (err[live] / mean[live]).max().item() if bool(live.any()) else 0.0


def check_attention_row(name, kernel, plain, shape, library=None, rel_tol=None) -> dict:
    """One bf16 attention row: the kernel against its plain version (every
    row compared: both write zeros where a row sees no key), finite, within
    TOL and, given `rel_tol`, within it by row_rel_err; ms, plain ms, the
    library call's ms and the bound."""
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = row_rel_err(out, ref) if rel_tol is not None else None
    finite = bool(torch.isfinite(out.float()).all())
    del out, ref
    row = dict(phase="kernel_check", kernel=name, shape=shape, max_abs_err=err,
               finite=finite, ms=time_ms(kernel, 20), plain_ms=time_ms(plain, 5),
               library_ms=time_ms(library, 20) if library is not None else None,
               **attention_bound(shape))
    if rel_tol is not None:
        row.update(rel_err=rel, rel_tolerance=rel_tol)
    emit(**row)
    if not finite or not err <= TOL or (rel_tol is not None and not rel <= rel_tol):
        raise AssertionError(f"{name} {shape}: max |kernel - plain| {err} (tolerance {TOL}), "
                             f"by row / mean |plain| {rel} (tolerance {rel_tol}), finite={finite}")
    return row


def attention_rows(name, kind, kernel, plain, row_list, dev, g, geo=(H, HKV, D), rel_tol=None) -> list:
    """check_attention_row over FLASH_ROWS- or DECODE_ROWS-shaped rows; the
    main row (MAIN_ROW[name]) also times one SDPA over the valid keys (GQA)."""
    out = []
    for row in row_list:
        q, k, v, kp, vp, kw, shape = attention_inputs(kind, row, dev, g, geo)
        kvl = shape["kv_valid"] if kind == "flash_attention" else shape["kv_valid"][0]
        library = None
        if len(out) == MAIN_ROW[name]:
            library = (lambda q=q, k=k, v=v, kvl=kvl: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k[:, :, :kvl], v[:, :, :kvl], is_causal=kind == "flash_attention",
                enable_gqa=True))
        out.append(check_attention_row(name, lambda: kernel(q, k, v, **kw), lambda: plain(q, kp, vp, **kw),
                                       shape, library, rel_tol))
    return out


# The entries that take their scalars from device memory (a captured loop's
# write head): B=1 over a 2048-row cache, the speculative verify window (9
# queries at q_offset 1531) and a 256-row chunk at q_offset 1280, each with
# the q_offsets its replays are given; the megakernel at pos 1531 and its
# replay positions.
SCALAR_FLASH_ROWS = [(9, (1531, 100, 2039)), (256, (1280, 0, 1792))]
SCALAR_MEGA_POS = (1531, 7, 2047)
# The main-row ms of the three kernels whose entries take device scalars, in
# the final smoke of the tree before that change (commit c967662; NVIDIA H100
# 80GB HBM3, 700.00 W): their main rows (host ints, as before) must stay
# within 3 % of these
HOST_ENTRY_MAIN_MS = {"flash_attention": 0.02762, "flash_attention_quant": 0.03831, "fused_decode_step": 2.401}
MAIN_MS_SLACK = 1.03


def replay_outputs(launch, scalars, values):
    """`launch()` captured once in a CUDA graph whose scalars are the device
    tensors `scalars`; for each tuple in `values` the scalars are set in
    place and the graph replayed. Returns each replay's outputs (copies)."""
    launch()  # builds the library and the plans outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = launch()
    outs = []
    for vals in values:
        for t, v in zip(scalars, vals):
            t.fill_(v)
        graph.replay()
        outs.append(tuple(o.clone() for o in (out if isinstance(out, tuple) else (out,))))
    torch.cuda.synchronize()
    return outs


def device_scalar_rows(dev, g, rows) -> None:
    """The three device-scalar entries: flash_attention (q_offset),
    flash_attention_quant at int8 and int4 (q_offset and kv_valid_len) and
    fused_decode_step (pos), each launched with one-element int32 tensors on
    the card, directly and from a CUDA graph replayed with the scalars
    changed between replays. Every output must be bit-equal to the launch
    with host ints at the same values, and within the tolerance of the plain
    version; the kernels' main rows (host ints) stay within 3 % of
    HOST_ENTRY_MAIN_MS."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.nn.layers import RotaryEmbedding
    from mllm_tpu_torch.ops import decode_step as ds
    from mllm_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_quant,
                                                    flash_attention_quant_ref, flash_attention_ref)

    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=dev)

    def gate(name, shape, direct_equal, replays_equal, err, tol):
        emit(phase="kernel_check_device_scalars", kernel=name, shape=shape, direct_bit_equal=direct_equal,
             replays_bit_equal=replays_equal, max_abs_err_vs_plain=err, tolerance=tol)
        if not (direct_equal and all(replays_equal) and err <= tol):
            raise AssertionError(f"{name} {shape}: device scalars bit-equal {direct_equal} / {replays_equal}, "
                                 f"vs plain {err} (tolerance {tol})")

    for sq, offsets in SCALAR_FLASH_ROWS:
        q = torch.randn(1, sq, H, D, device=dev, generator=g).to(torch.bfloat16)
        k, v = (torch.randn(1, HKV, S_CACHE, D, device=dev, generator=g).to(torch.bfloat16) for _ in range(2))
        off = i32(offsets[0])
        host = flash_attention(q, k, v, q_offset=offsets[0], kv_valid_len=offsets[0] + sq)
        direct = flash_attention(q, k, v, q_offset=off, kv_valid_len=off + sq)
        reps = replay_outputs(lambda: flash_attention(q, k, v, q_offset=off, kv_valid_len=off + sq), [off],
                              [(o,) for o in offsets])
        same = [torch.equal(r[0], flash_attention(q, k, v, q_offset=o, kv_valid_len=o + sq))
                for r, o in zip(reps, offsets)]
        ref = flash_attention_ref(q, k, v, q_offset=offsets[0], kv_valid_len=offsets[0] + sq)
        gate("flash_attention", dict(B=1, Sq=sq, S=S_CACHE, q_offsets=list(offsets)), torch.equal(host, direct),
             same, (host.float() - ref.float()).abs().max().item(), TOL)
        for bits in (8, 4):
            (kq, ks, _), (vq, vs, _) = quant_kv(1, S_CACHE, bits, dev, g)
            ops = (kq, vq, ks, vs)
            off, kvl = i32(offsets[0]), i32(offsets[0] + sq)
            host = flash_attention_quant(q, *ops, q_offset=offsets[0], kv_valid_len=offsets[0] + sq)
            direct = flash_attention_quant(q, *ops, q_offset=off, kv_valid_len=kvl)
            reps = replay_outputs(lambda: flash_attention_quant(q, *ops, q_offset=off, kv_valid_len=kvl),
                                  [off, kvl], [(o, o + sq) for o in offsets])
            same = [torch.equal(r[0], flash_attention_quant(q, *ops, q_offset=o, kv_valid_len=o + sq))
                    for r, o in zip(reps, offsets)]
            ref = flash_attention_quant_ref(q, *ops, q_offset=offsets[0], kv_valid_len=offsets[0] + sq)
            gate("flash_attention_quant", dict(B=1, Sq=sq, S=S_CACHE, bits=bits, q_offsets=list(offsets)),
                 torch.equal(host, direct), same, (host.float() - ref.float()).abs().max().item(), TOL)

    cfg = TextConfig(**QWEN2VL_2B_LM)
    ops, _ = mega_operands(dev, g, cfg)
    rope = RotaryEmbedding.make(D, S_CACHE, cfg.rope_theta, device=dev)
    kv = mega_cache(cfg, 1, dev, g)
    x = torch.randn(1, cfg.hidden_size, device=dev, generator=g)
    kw = dict(act=cfg.hidden_act, eps=cfg.rms_norm_eps, **mega_kw(cfg))

    def rot(p):
        return ds.rope_rotation_matrix(rope.sin[p], rope.cos[p])

    pos = i32(SCALAR_MEGA_POS[0])
    rot_dev = rot(pos.long().reshape(1))
    host = ds.fused_decode_step(x, SCALAR_MEGA_POS[0], rot(SCALAR_MEGA_POS[0]), *ops, *kv, **kw)
    direct = ds.fused_decode_step(x, pos, rot_dev, *ops, *kv, **kw)

    def launch():
        rot_dev.copy_(rot(pos.long().reshape(1)))
        return ds.fused_decode_step(x, pos, rot_dev, *ops, *kv, **kw)

    reps = replay_outputs(launch, [pos], [(p,) for p in SCALAR_MEGA_POS])
    same = [all(torch.equal(a, b) for a, b in zip(r, ds.fused_decode_step(x, p, rot(p), *ops, *kv, **kw)))
            for r, p in zip(reps, SCALAR_MEGA_POS)]
    ref = ds.fused_decode_step_ref(x, SCALAR_MEGA_POS[0], rot(SCALAR_MEGA_POS[0]), *ops, *kv, **kw)
    err = max(((o.float() - r.float()).abs().max() / r.float().abs().max()).item() for o, r in zip(host, ref))
    gate("fused_decode_step", dict(b=1, L=cfg.num_hidden_layers, S=S_CACHE, pos=list(SCALAR_MEGA_POS)),
         all(torch.equal(a, b) for a, b in zip(host, direct)), same, err, MEGA_TOL)
    del kv

    for name, before in HOST_ENTRY_MAIN_MS.items():
        ms = rows[name][MAIN_ROW[name]]["ms"]
        emit(phase="kernel_check_main_row_vs_host_entry", kernel=name, ms=ms, host_entry_ms=before,
             ratio=ms / before, limit=MAIN_MS_SLACK)
        if ms > before * MAIN_MS_SLACK:
            raise AssertionError(f"{name}: main row {ms} ms > {MAIN_MS_SLACK} x {before} ms, its time "
                                 "before the device-scalar entries")


def attention_geometry_checks(dev, g) -> None:
    """The bf16 attention kernels away from the model's geometry, checked only
    (no timing): head_dim 64 and 128, MHA (8/8), GQA with 20 query heads a KV
    head (two head groups in decode) and MQA (4/1), over a 640-row cache:
    decode with a slot past the cache and a window, causal flash over a left
    pad, non-causal flash with per-sequence lengths. max |kernel - plain| <=
    TOL, finite."""
    from mllm_tpu_torch.ops.decode_attention import decode_attention, decode_attention_ref
    from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)

    def ivec(xs):
        return torch.tensor(xs, device=dev, dtype=torch.int32)

    s_cache, worst = 640, 0.0
    for d in (64, 128):
        for h, hkv in ((8, 8), (40, 2), (4, 1)):
            cases = [("decode", 3, 1, dict(kv_valid_len=ivec([640, 1, 333]))),
                     ("decode", 2, 1, dict(kv_valid_len=ivec([700, 129]), kv_start=ivec([5, 64]), window=100)),
                     ("flash", 2, 300, dict(kv_valid_len=300, kv_start=ivec([0, 40]))),
                     ("flash", 2, 100, dict(kv_valid_len=ivec([100, 37]), causal=False))]
            for kind, b, sq, kw in cases:
                q, k, v = rnd(b, sq, h, d), rnd(b, hkv, s_cache, d), rnd(b, hkv, s_cache, d)
                kernel, plain = ((decode_attention, decode_attention_ref) if kind == "decode"
                                 else (flash_attention, flash_attention_ref))
                out = kernel(q, k, v, **kw)
                err = (out.float() - plain(q, k, v, **kw).float()).abs().max().item()
                if not (err <= TOL and bool(torch.isfinite(out.float()).all())):
                    raise AssertionError(f"{kind}_attention D={d} H={h} H_kv={hkv} {kw}: max |kernel - plain| "
                                         f"{err} (tolerance {TOL}) or not finite")
                worst = max(worst, err)
    emit(phase="kernel_geometry", checks=24, head_dims=[64, 128], heads=[[8, 8], [40, 2], [4, 1]],
         max_abs_err=worst, tolerance=TOL)


def sdpa_route_checks(dev, g) -> None:
    """The attention calls the reference serves through XLA sdpa, run on the
    card through the port's routes against the same calls on the CPU: an
    additive bias, a logit softcap, and a prefill over an int8 cache with
    per-slot lengths. max |card - CPU| <= TOL, finite."""
    from mllm_tpu_torch.kv.cache import QuantKVCache
    from mllm_tpu_torch.nn.attention import attend, attend_from_cache, attention_route

    cpu = torch.device("cpu")
    b, sq, skv = 2, 48, 320
    q = torch.randn(b, sq, H, D, device=dev, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(b, HKV, skv, D, device=dev, generator=g).to(torch.bfloat16) for _ in range(2))
    bias = torch.randn(b, H, sq, skv, device=dev, generator=g)
    cache = QuantKVCache.init(1, b, skv, HKV, D, device=dev)
    cache.update_layer(0, *(torch.randn(b, skv, HKV, D, device=dev, generator=g) for _ in range(2)))
    kvl = torch.tensor([skv, 201], device=dev, dtype=torch.int32)
    calls = {
        "bias": lambda t: attend(t(q), t(k), t(v), q_offset=skv - sq, kv_valid_len=skv, bias=t(bias)),
        "softcap": lambda t: attend(t(q), t(k), t(v), q_offset=skv - sq, kv_valid_len=skv, logit_softcap=20.0),
        "quant_cache_per_slot_prefill": lambda t: attend_from_cache(
            t(q), QuantKVCache(*(t(x) for x in (cache.k, cache.v, cache.k_scale, cache.v_scale)), cache.pos), 0,
            q_offset=skv - sq, kv_valid_len=t(kvl)),
    }
    routes = {"bias": attention_route(sq, bias=bias), "softcap": attention_route(sq, logit_softcap=20.0),
              "quant_cache_per_slot_prefill": attention_route(sq, cache="quant", kv_valid_len=kvl)}
    for name, call in calls.items():
        out = call(lambda x: x)
        ref = call(lambda x: x.to(cpu))
        torch.cuda.synchronize()
        err = (out.float().cpu() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all())
        emit(phase="sdpa_route_check", call=name, route=routes[name], shape=dict(B=b, Sq=sq, Skv=skv, H=H, Hkv=HKV),
             max_abs_err=err, tolerance=TOL, finite=finite, device=str(out.device))
        if routes[name] != "sdpa" or out.device.type != "cuda" or not finite or not err <= TOL:
            raise AssertionError(f"{name}: route {routes[name]}, max |card - CPU| {err} (tolerance {TOL}), "
                                 f"finite={finite}")


# quantized decode: (B, kv_valid per slot, kv_start, window, poisoned); cache S_CACHE
QUANT_DECODE_ROWS = [
    (1, [1531], None, None, False),
    (8, [17, 100, 511, 513, 1000, 1531, 2000, 777], None, None, False),  # the engine's 8 slots
    (4, [1, 511, 513, 2048], [0, 3, 7, 9], 256, False),
    (4, [231, 231, 231, 231], [183, 136, 72, 0], None, False),          # a ragged batch's step
    (2, [2083, 900], None, None, False),                                  # an idle slot past the cache
    # stale rows: integers and scales outside [kv_start, kv_valid) hold 127 and NaN / inf
    (4, [0, 77, 2083, 1531], [0, 13, 100, 700], None, True),
    (8, [17, 100, 511, 513, 1000, 1531, 2000, 777], [0, 5, 100, 0, 50, 0, 3, 9], 300, True),
]


def quant_kv(b, s, bits, dev, g, hkv=HKV, d=D):
    """Random K and V [B, H_kv, s, D] quantized over D by the caches' own
    quantizer: [(integers, scales, dense bf16 dequantization)] for K and V."""
    from mllm_tpu_torch.kv.cache import quantize_kv

    out = []
    for _ in range(2):
        x = torch.randn(b, hkv, s, d, device=dev, generator=g)
        q, sc = quantize_kv(x, bits)
        vals = q.float() if bits == 8 else torch.cat([(q & 15).float(), (q >> 4).float()], -1) - 8
        out.append((q, sc, (vals * sc[..., None]).to(torch.bfloat16)))
    return out


def poison_quant(kq, vq, ks, vs, kd, vd, lo, hi):
    """Quantized K/V with the keys outside [lo[b], hi[b]) holding 127 and NaN /
    inf scales (alternating by key), as an earlier request may leave a slot:
    (kernel operands (k, v, k_scale, v_scale), plain operands with those
    integers and scales zeroed, dense K and V with those rows zeroed)."""
    dev = kq.device
    j = torch.arange(kq.shape[2], device=dev)
    lo_t, hi_t = (torch.tensor(xs, device=dev, dtype=torch.int32)[:, None] for xs in (lo, hi))
    bad = ((j[None] < lo_t) | (j[None] >= hi_t))[:, None, :]  # [B, 1, S]
    fill = torch.where(j % 2 == 0, float("nan"), float("inf"))[None, None, :]
    kernel_ops = tuple(torch.where(bad[..., None], torch.full_like(t, 127), t) for t in (kq, vq)) + tuple(
        torch.where(bad, fill, t) for t in (ks, vs))
    plain_ops = tuple(torch.where(bad[..., None], torch.zeros_like(t), t) for t in (kq, vq)) + tuple(
        torch.where(bad, torch.zeros_like(t), t) for t in (ks, vs))
    dense = tuple(torch.where(bad[..., None], torch.zeros_like(t), t) for t in (kd, vd))
    return kernel_ops, plain_ops, dense


# quantized flash: (B, Sq, Skv, q_offset, kv_valid, kv_start, window, poisoned, (H, H_kv, D))
QUANT_FLASH_ROWS = [
    (1, 1536, 1536, 0, 1536, None, None, False, (H, HKV, D)),           # the 1500-token prompt's prefill
    (8, 128, 128, 0, 128, None, None, False, (H, HKV, D)),              # a batched admission of 8 buckets
    (1, 128, 1536, 1408, 1536, None, None, False, (H, HKV, D)),         # the last chunk of a chunked prefill
    (4, 256, 256, 0, 256, [0, 17, 64, 150], None, False, (H, HKV, D)),  # a left-padded ragged batch
    (1, 512, 1536, 1024, 1536, None, 256, False, (H, HKV, D)),          # a sliding window over a chunk
    # stale rows: integers and scales outside [kv_start, kv_valid) hold 127 and NaN / inf
    (4, 256, 256, 0, 200, [0, 17, 64, 150], None, True, (H, HKV, D)),
    (2, 384, 384, 0, 384, [0, 40], None, False, (8, 8, 64)),            # head_dim 64, MHA
]


def quant_flash_inputs(row, bits, dev, g):
    """One QUANT_FLASH_ROWS row at `bits`: (q, kernel operands (k, v, k_scale,
    v_scale), plain operands, kwargs, shape, dense bf16 K and V of the plain
    operands). A poisoned row's kernel operands hold 127 and NaN / inf scales
    outside [kv_start, kv_valid); its plain operands have them zeroed (else
    they are the kernel's)."""
    b, sq, skv, qoff, kvl, start, window, poisoned, (h, hkv, d) = row
    q = torch.randn(b, sq, h, d, device=dev, generator=g).to(torch.bfloat16)
    (kq, ks, kd), (vq, vs, vd) = quant_kv(b, skv, bits, dev, g, hkv, d)
    kw = dict(q_offset=qoff, kv_valid_len=kvl, window=window,
              kv_start=None if start is None else torch.tensor(start, device=dev, dtype=torch.int32))
    shape = dict(B=b, Sq=sq, H=h, Hkv=hkv, D=d, S=skv, q_offset=qoff, kv_valid=kvl, kv_start=start,
                 window=window, bits=bits)
    kernel_ops = plain_ops = (kq, vq, ks, vs)
    if poisoned:
        kernel_ops, plain_ops, (kd, vd) = poison_quant(kq, vq, ks, vs, kd, vd, start or [0] * b, [kvl] * b)
        shape["poisoned"] = "127 and NaN / inf scales outside [kv_start, kv_valid); plain version on them zeroed"
    return q, kernel_ops, plain_ops, kw, shape, (kd, vd)


def quant_decode_inputs(row, bits, dev, g, geo=(H, HKV, D)):
    """One QUANT_DECODE_ROWS row at `bits` (heads, KV heads and head_dim
    `geo`): (q, kernel operands (k, v, k_scale, v_scale), plain operands,
    kwargs, shape, dense bf16 K and V of the plain operands). A poisoned row's
    kernel operands hold 127 and NaN / inf scales outside [kv_start,
    kv_valid); its plain operands have those integers and scales zeroed (else
    they are the kernel's)."""
    H, HKV, D = geo  # noqa: N806
    b, kvl, start, window, poisoned = row
    q = torch.randn(b, 1, H, D, device=dev, generator=g).to(torch.bfloat16)
    (kq, ks, kd), (vq, vs, vd) = quant_kv(b, S_CACHE, bits, dev, g, HKV, D)
    ivec = lambda xs: torch.tensor(xs, device=dev, dtype=torch.int32)  # noqa: E731
    kw = dict(kv_valid_len=ivec(kvl), kv_start=None if start is None else ivec(start), window=window)
    shape = dict(B=b, H=H, Hkv=HKV, D=D, S=S_CACHE, kv_valid=[min(n, S_CACHE) for n in kvl],
                 kv_valid_given=kvl, kv_start=start, window=window, bits=bits)
    kernel_ops = plain_ops = (kq, vq, ks, vs)
    if poisoned:
        kernel_ops, plain_ops, (kd, vd) = poison_quant(kq, vq, ks, vs, kd, vd, start or [0] * b, kvl)
        shape["poisoned"] = "127 and NaN / inf scales outside [kv_start, kv_valid); plain version on them zeroed"
    return q, kernel_ops, plain_ops, kw, shape, (kd, vd)


# paged: (kv_valid per slot, retired slot or None, window or None, poisoned),
# MAXB 16 over a shuffled pool holding the blocks the lengths need plus 8 spare
PAGED_ROWS = [
    ([17, 100, 511, 513, 1000, 1531, 2000, 777], None, None, False),  # the engine's 8 slots
    ([300, 1200, 64, 600], 3, None, False),                           # a retired slot: -1 row, kv_valid > 0
    ([1531], None, None, False),                                      # the 1500-token prompt's last step
    ([1, 511, 513, 2048], None, 256, False),
    # stale rows: NaN / inf in the pool rows outside each slot's visible keys and in the spare blocks
    ([17, 100, 511, 513, 1000, 1531, 2000, 777], None, 700, True),
]
PAGED_MAXB = 16


def paged_inputs(row, dev, g, geo=(H, HKV, D)):
    """One PAGED_ROWS row: (q, k_pool, v_pool, table, kwargs, shape, (plain
    k_pool, plain v_pool), (dense K, dense V)). A poisoned row's pools hold
    NaN and inf (alternating by row) in every row no slot sees and in the
    spare blocks; its plain pools have them zeroed (else they are the
    kernel's). The dense views are the plain pools through `gather_pages`
    (bf16 [B, H_kv, MAXB * 128, D]), made here, outside any timed window."""
    from mllm_tpu_torch.ops.decode_attention import PAGE, gather_pages

    H, HKV, D = geo  # noqa: N806
    kvl, retired, window, poisoned = row
    b = len(kvl)
    need = [-(-n // PAGE) for n in kvl]
    nb = sum(need) + 8
    perm = torch.randperm(nb, device=dev, generator=g).tolist()
    table = torch.full((b, PAGED_MAXB), -1, dtype=torch.int32)
    for i, n in enumerate(need):
        table[i, :n] = torch.tensor(perm[sum(need[:i]) : sum(need[: i + 1])])
    if retired is not None:
        table[retired] = -1  # a retired slot: -1 row, kv_valid > 0
    kp, vp = (torch.randn(nb, HKV, PAGE, D, device=dev, generator=g).to(torch.bfloat16) for _ in range(2))
    kpp, vpp = kp, vp
    shape = dict(B=b, H=H, Hkv=HKV, D=D, S=PAGED_MAXB * PAGE, kv_valid=kvl, kv_start=None, window=window,
                 pool_blocks=nb, retired_slot=retired)
    if poisoned:
        bad = torch.ones(nb, PAGE, dtype=torch.bool)  # [block, row]: seen by no slot
        for i, n in enumerate(kvl):
            lo = max(n - window, 0) if window else 0
            for j in range(lo, n):
                bad[table[i, j // PAGE], j % PAGE] = False
        bad = bad.to(dev)[:, None, :, None]
        fill = torch.where(torch.arange(PAGE, device=dev) % 2 == 0, float("nan"), float("inf"))
        fill = fill.to(torch.bfloat16)[None, None, :, None]
        kp, vp, kpp, vpp = (torch.where(bad, fill, kp), torch.where(bad, fill, vp),
                            torch.where(bad, torch.zeros_like(kp), kp), torch.where(bad, torch.zeros_like(vp), vp))
        shape["poisoned"] = "NaN / inf in every pool row no slot sees and in the spare blocks; plain version on them zeroed"
    table = table.to(dev)
    q = torch.randn(b, 1, H, D, device=dev, generator=g).to(torch.bfloat16)
    kw = dict(kv_valid_len=torch.tensor(kvl, device=dev, dtype=torch.int32), window=window)
    return q, kp, vp, table, kw, shape, (kpp, vpp), (gather_pages(kpp, table), gather_pages(vpp, table))


def check_kv_row(name, kernel, plain, shape, key_bytes, dense, extra=None) -> dict:
    """One quantized- or paged-cache attention row: the kernel against its
    plain version (finite, within TOL), timed beside its plain version, its
    bound (key_bytes a key and KV head), SDPA over the same keys in a dense
    bf16 cache (`dense_sdpa_ms`) and the `extra` calls, each timed under its
    name."""
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    finite = bool(torch.isfinite(out.float()).all())
    row = dict(phase="kernel_check", kernel=name, shape=shape, max_abs_err=err, finite=finite,
               ms=time_ms(kernel, 20), plain_ms=time_ms(plain, 5), library_ms=None,
               dense_sdpa_ms=time_ms(dense, 20), **{k: time_ms(f, 20) for k, f in (extra or {}).items()},
               **attention_bound(shape, key_bytes))
    emit(**row)
    if not finite or not err <= TOL:
        raise AssertionError(f"{name} {shape}: max |kernel - plain| {err} (tolerance {TOL}), "
                             f"finite={finite}")
    return row


def decode_mask(dev, kvl, s, start=None, window=None):
    """[B, 1, 1, S] bool: the keys one decode query sees (an SDPA mask)."""
    def ivec(xs):
        return torch.tensor(xs, device=dev, dtype=torch.int32)

    j = torch.arange(s, device=dev)
    kv = ivec(kvl)[:, None]
    ok = j[None] < kv
    if start is not None:
        ok &= j[None] >= ivec(start)[:, None]
    if window:
        ok &= j[None] > kv - 1 - window
    return ok[:, None, None, :]


def quant_attention_rows(dev, g, flash_rows, decode_rows, geo=(H, HKV, D), suffix: str = "",
                         route_sdpa: bool = False) -> dict:
    """flash_attention_quant (`flash_rows`, QUANT_FLASH_ROWS-shaped) and
    decode_attention_quant (`decode_rows` at heads / KV heads / head_dim
    `geo`) at int8 then int4 through `check_kv_row`, named with `suffix`:
    beside SDPA over the same keys dequantized (`dense_sdpa_ms`) and the bf16
    kernel over them (`bf16_flash_ms` / `bf16_decode_ms`); with route_sdpa
    also the port's `nn.attention.sdpa` over them (`route_sdpa_ms`: what
    served these calls while the route sent them to `sdpa`)."""
    from mllm_tpu_torch.nn.attention import sdpa as route
    from mllm_tpu_torch.ops.decode_attention import (decode_attention, decode_attention_quant,
                                                     decode_attention_quant_ref)
    from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_quant, flash_attention_quant_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    fname, dname = "flash_attention_quant" + suffix, "decode_attention_quant" + suffix
    rows = {fname: [], dname: []}
    for bits in (8, 4):
        for row in flash_rows:
            q, kops, pops, kw, shape, (kd, vd) = quant_flash_inputs(row, bits, dev, g)
            kvl, qoff, d = shape["kv_valid"], shape["q_offset"], shape["D"]
            extra = {"bf16_flash_ms": lambda: flash_attention(q, kd, vd, **kw)}
            if route_sdpa:
                extra["route_sdpa_ms"] = lambda: route(q, kd, vd, **kw)
            rows[fname].append(check_kv_row(
                fname, lambda: flash_attention_quant(q, *kops, **kw),
                lambda: flash_attention_quant_ref(q, *pops, **kw), shape, 2 * (d if bits == 8 else d // 2) + 8,
                lambda: sdpa(q.transpose(1, 2), kd[:, :, :kvl], vd[:, :, :kvl], is_causal=qoff == 0,
                             enable_gqa=True), extra))
        for row in decode_rows:
            q, kops, pops, kw, shape, (kd, vd) = quant_decode_inputs(row, bits, dev, g, geo)
            d = shape["D"]
            m = decode_mask(dev, shape["kv_valid"], S_CACHE, row[2], row[3])
            extra = {"bf16_decode_ms": lambda: decode_attention(q, kd, vd, **kw)}
            if route_sdpa:
                qpos = torch.tensor(row[1], device=dev) - 1  # the query sits at the last valid key
                extra["route_sdpa_ms"] = lambda: route(q, kd, vd, q_offset=qpos, **kw)
            rows[dname].append(check_kv_row(
                dname, lambda: decode_attention_quant(q, *kops, **kw),
                lambda: decode_attention_quant_ref(q, *pops, **kw), shape, 2 * (d if bits == 8 else d // 2) + 8,
                lambda: sdpa(q.transpose(1, 2), kd, vd, attn_mask=m, enable_gqa=True), extra))
    return rows


def kv_kernel_rows(dev, g) -> dict:
    """The kernels of the quantized and paged caches against their plain
    versions (H=12, H_kv=2, D=128, one quantized prefill row at D=64 with 8/8
    heads; max |kernel - plain| <= TOL): the int8 and
    int4 kernels on K/V quantized by the caches' own quantizer, the paged one
    over a shuffled pool. Bytes: q, the output, and each visible key's K/V
    bytes with its two f32 scales (paged: bf16 K/V). No single PyTorch call
    takes these layouts (library_ms null); `dense_sdpa_ms` times SDPA over the
    same keys in a dense bf16 cache, a different function kept for context,
    and on the quantized prefill (decode) rows `bf16_flash_ms`
    (`bf16_decode_ms`) the bf16 flash_attention (decode_attention) kernel over
    that dense cache (twice the bytes at int8), its yardstick; on
    the paged rows `dense_decode_ms` the same kernel over the dense view of the
    slots' blocks (the same bytes), the paged kernel's yardstick."""
    from mllm_tpu_torch.ops.decode_attention import decode_attention, decode_attention_paged, decode_attention_paged_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = quant_attention_rows(dev, g, QUANT_FLASH_ROWS, QUANT_DECODE_ROWS)
    rows["decode_attention_paged"] = []
    for row in PAGED_ROWS:
        q, kp, vp, table, kw, shape, (kpp, vpp), (kd, vd) = paged_inputs(row, dev, g)
        m = decode_mask(dev, kw["kv_valid_len"].tolist(), kd.shape[2], window=row[2])
        rows["decode_attention_paged"].append(check_kv_row(
            "decode_attention_paged", lambda: decode_attention_paged(q, kp, vp, table, **kw),
            lambda: decode_attention_paged_ref(q, kpp, vpp, table, **kw), shape, None,
            lambda: sdpa(q.transpose(1, 2), kd, vd, attn_mask=m, enable_gqa=True),
            {"dense_decode_ms": lambda: decode_attention(q, kd, vd, **kw)}))
    return rows


def int4pack_call(x, packed_e8, scales_p, k):
    """torch._weight_int4pack_mm on the same symmetric int4 weight (the
    library yardstick of int4_matmul; the port never calls it): the canonical
    operands repacked, outside the timed window, into its [N, K/2] nibble
    pairs (innerKTiles 2, the fastest of 2, 4 and 8 on the H100) and bf16
    (scale, zero = 0) pairs; it computes (q - 8) * scale, as the kernel."""
    from mllm_tpu_torch.ops import quant_matmul as qm

    kh, ng, ngh = k // 2, k // 2 // qm.GROUP, packed_e8.shape[0] // qm.GROUP
    q = torch.cat([packed_e8[:kh] & 15, packed_e8[:kh] >> 4], 0).t()  # [N, K], values 0..15
    packed = torch._convert_weight_to_int4pack(((q[:, ::2] << 4) | q[:, 1::2]).contiguous(), 2)
    sc = torch.cat([scales_p[:ng], scales_p[ngh:ngh + ng]], 0)  # [K/G, N]
    sz = torch.stack([sc, torch.zeros_like(sc)], -1).to(torch.bfloat16).contiguous()
    return lambda: torch._weight_int4pack_mm(x, packed, qm.GROUP, sz)


# int8_matmul: (m, K, N): the int8 path's qkv, gate||up (main row), down and
# head at decode (b = 1, 8), prefill (the wgmma kernel): 128 tokens of qkv
# and the 1536-token gate||up, then gate||up at m = 16 and 32 (the largest
# stream rows), the b=1 head, and the 1536-token down projection (K split
# over clusters that each take two tiles); then the Qwen2-VL tower's qkv and
# fc2 over a 532 px image's 1444 patches
INT8_ROWS = [(1, 1536, 2048), (8, 1536, 17920), (8, 8960, 1536), (8, 1536, 151936),
             (128, 1536, 2048), (1536, 1536, 17920), (16, 1536, 17920), (32, 1536, 17920),
             (1, 1536, 151936), (1536, 8960, 1536), (1444, 1280, 3840), (1444, 5120, 1280)]


def int8_library_calls(x, q, s):
    """(library, cublas) for an int8 row: ("torch._weight_int8pack_mm", call)
    on the same weight in its [N, K] layout (the same function; the port never
    calls it), and torch.mm of x against the weight already dequantized to
    bf16 [K, N] with f32 output (cuBLAS, a yardstick of another function:
    its weight bytes are twice as many). Both operands are made outside the
    timed window."""
    wq = q.t().contiguous()
    wb = (q.float() * s).to(torch.bfloat16)
    return (("torch._weight_int8pack_mm", lambda: torch._weight_int8pack_mm(x, wq, s)),
            lambda: torch.mm(x, wb, out_dtype=torch.float32))


# int4_matmul: (m, K, N, affine): the int4 path's qkv, o, gate||up and down at
# decode, the padded int4 lm_head at b = 1, 8, 32 and 16 (the head of the b=1,
# b=8, b=32 and b=16 megakernel steps), affine rows, and K/2 = 480 padded to 512
INT4_ROWS = [(1, 1536, 2048, False), (1, 1536, 1536, False), (8, 1536, 2048, False),
             (32, 8960, 1536, False), (1, 1536, 152064, False), (1, 1536, 2048, True),
             (4, 8960, 1536, True), (8, 960, 2048, False), (8, 1536, 152064, False),
             (32, 1536, 152064, False), (16, 1536, 152064, False)]


def int4_bytes(k, n, affine):
    """Weight bytes of an int4 product: the nibbles and the f32 scales (and zeros)."""
    return k // 2 * n + (2 if affine else 1) * (k // 32) * n * 4


def int4_operands(m, k, n, affine, dev, g):
    """(packed, scales, zeros or None, x) of one INT4_ROWS row: a random weight
    quantized on the card (symmetric), or random nibbles, scales and zeros
    (affine; the padded rows stay zero); x random bf16 [m, K]."""
    from mllm_tpu_torch.ops import quant_matmul as qm
    from mllm_tpu_torch.ops.quantize_model import _q4_device

    p, s, z = qm.prepare_int4(*_q4_device(torch.randn(n, k, device=dev, generator=g) * 0.02), qm.GROUP)
    if affine:
        live = s != 0
        p = torch.randint(0, 256, p.shape, device=dev, generator=g, dtype=torch.uint8)
        p[k // 2:] = 0
        s = torch.rand(s.shape, device=dev, generator=g) * 0.02 * live
        z = torch.randn(s.shape, device=dev, generator=g) * 0.05 * live
    else:
        z = None
    return p, s, z, torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)


def check_quant_row(name, kernel, plain, shape, weight_bytes, library=None, cublas=None, extra=None,
                    fields=None) -> dict:
    """One row of a quantized product: the kernel against its plain version
    (max |kernel - plain| / max |plain| <= QUANT_TOL, finite), timed beside
    the plain version, its bound and the library call `library` (name,
    call), with `cublas` and `extra` timings of other routes and `fields`
    printed with the row."""
    m, k, n = shape.get("m"), shape.get("K", shape.get("d")), shape.get("N", shape.get("d"))
    weights = k * n if name != "fused_int4_mlp" else 3 * shape["d"] * shape["ff"]
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    finite = bool(torch.isfinite(out).all())
    ms = time_ms(kernel, 20)
    lib = dict(library_ms=None)
    if library is not None:  # (name, call): one PyTorch call of the same product
        try:
            lib_out = library[1]().float()
            lib = dict(library=library[0], library_ms=time_ms(library[1], 20),
                       library_rel_err=((lib_out - ref.float()).abs().max()
                                        / ref.float().abs().max()).item())
        except RuntimeError as e:  # a yardstick only: the port never calls it
            lib = dict(library=library[0], library_ms=None, library_error=str(e)[:200])
    if cublas is not None:  # a yardstick of another function: bf16 weights already in memory
        lib["cublas_bf16_ms"] = time_ms(cublas, 20)
    for key, call in (extra or {}).items():  # the same function by another route of the port
        lib[key] = time_ms(call, 20)
    row = dict(phase="kernel_check", kernel=name, shape=shape, max_abs_err=err, rel_err=rel,
               tolerance=QUANT_TOL[name], finite=finite, ms=ms, plain_ms=time_ms(plain, 5),
               weight_bytes=weight_bytes, weight_tb_per_s=weight_bytes / ms / 1e9,
               hbm_tb_per_s=HBM_BYTES_PER_S / 1e12, **lib, **(fields or {}),
               **bound(weight_bytes + m * k * 2 + m * n * 4, 2 * m * weights))
    emit(**row)
    if not finite or not rel <= QUANT_TOL[name]:
        raise AssertionError(f"{name} {shape}: max |kernel - plain| / max |plain| {rel} "
                             f"(tolerance {QUANT_TOL[name]}), finite={finite}")
    return row


def quant_kernel_rows(dev, g) -> dict:
    """The quantized products against their plain versions, at the shapes of
    the int8 and int4 phases (Qwen2-VL-2B: qkv 1536->2048, o 1536->1536,
    gate||up 1536->17920, down 8960->1536, head 1536->151936 (int4: padded
    to 152064); m = decode batch, or prefill tokens for int8), and the fused
    int4 MLP at FUSED_MLP_ROWS."""
    from mllm_tpu_torch.ops import quant_matmul as qm
    from mllm_tpu_torch.ops.fused_mlp import pick_block_f
    from mllm_tpu_torch.ops.quantize_model import _q8_device

    def weight(n, k):
        return torch.randn(n, k, device=dev, generator=g) * 0.02

    def x_rows(m, k):
        return torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)

    rows = {"int8_matmul": [], "int4_matmul": [], "fused_int4_mlp": []}
    for m, k, n in INT8_ROWS:
        q, s = _q8_device(weight(n, k))
        x = x_rows(m, k)
        library, cublas = int8_library_calls(x, q, s)
        rows["int8_matmul"].append(check_quant_row(
            "int8_matmul", lambda: qm.int8_matmul(x, q, s), lambda: qm.int8_matmul_ref(x, q, s),
            dict(m=m, K=k, N=n), k * n + 4 * n, library,
            cublas if m > qm.INT8_STREAM_MAX_M else None))
        del q, s, library, cublas

    for m, k, n, affine in INT4_ROWS:
        p, s, z, x = int4_operands(m, k, n, affine, dev, g)
        library = None if affine else ("torch._weight_int4pack_mm", int4pack_call(x, p, s, k))
        rows["int4_matmul"].append(check_quant_row(
            "int4_matmul", lambda: qm.int4_matmul(x, p, s, qm.GROUP, z),
            lambda: qm.int4_matmul_ref(x, p, s, qm.GROUP, z),
            dict(m=m, K=k, N=n, affine=affine, khp=p.shape[0]), int4_bytes(k, n, affine), library))
        del p, s, z, library

    operands = {}
    for m, act, affine, (d, ff) in FUSED_MLP_ROWS:
        if (d, ff) not in operands:
            operands = {(d, ff): fused_mlp_operands(d, ff, dev, g)}  # one width's weights at a time
        block_f = pick_block_f(ff)
        x = x_rows(m, d)
        kernel, plain, unfused = fused_mlp_calls(x, operands[(d, ff)], act, affine, block_f)
        rows["fused_int4_mlp"].append(check_quant_row(
            "fused_int4_mlp", kernel, plain, dict(m=m, d=d, ff=ff, block_f=block_f, act=act, affine=affine),
            2 * int4_bytes(d, ff, affine) + int4_bytes(ff, d, affine), extra={"unfused_ms": unfused}))
    return rows


# fused_int4_mlp: (m, act, affine, (d, ff)): the int4 decode step's MLP at
# b = 1, 8, 32, an affine row, gelu_new, b = 16, and TinyLlama's widths (its
# own pick_block_f, 512: a second plan)
QWEN2VL_2B_MLP, TINYLLAMA_MLP = (1536, 8960), (2048, 5632)
FUSED_MLP_ROWS = [(1, "silu", False, QWEN2VL_2B_MLP), (8, "silu", False, QWEN2VL_2B_MLP),
                  (32, "silu", False, QWEN2VL_2B_MLP), (4, "silu", True, QWEN2VL_2B_MLP),
                  (1, "gelu_new", False, QWEN2VL_2B_MLP), (16, "silu", False, QWEN2VL_2B_MLP),
                  (1, "silu", False, TINYLLAMA_MLP)]


def fused_mlp_operands(d, ff, dev, g):
    """Random gate, up and down weights quantized on the card (symmetric,
    group 32): (gate, up, down, down_planar), each (packed, scales): gate and
    up canonical over K = d, down block-planar over K = ff (pick_block_f) and
    the same down canonical over K = ff, for the unfused route."""
    from mllm_tpu_torch.ops import quant_matmul as qm
    from mllm_tpu_torch.ops.fused_mlp import pick_block_f, prepare_int4_ff
    from mllm_tpu_torch.ops.quantize_model import _q4_device

    gate, up = (tuple(qm.prepare_int4(*_q4_device(torch.randn(ff, d, device=dev, generator=g) * 0.02),
                                      qm.GROUP)[:2]) for _ in range(2))
    planar = _q4_device(torch.randn(d, ff, device=dev, generator=g) * 0.02)
    return (gate, up, tuple(prepare_int4_ff(*planar, None, pick_block_f(ff))[:2]),
            tuple(qm.prepare_int4(*planar, qm.GROUP)[:2]))


def fused_mlp_calls(x, operands, act, affine, block_f):
    """(kernel, plain, unfused) no-argument calls of one fused MLP row; affine
    rows take the same weights with their zeros stored (-8 * scales). The
    unfused route is the same function through the port's own kernels:
    int4_matmul on gate and on up, the activation, h rounded to bf16,
    int4_matmul on down (canonical over K = ff)."""
    from mllm_tpu_torch.ops import quant_matmul as qm
    from mllm_tpu_torch.ops.fused_mlp import _ACT, fused_int4_mlp, fused_int4_mlp_ref

    gate, up, down, down_planar = ((*op, (-8.0 * op[1]) if affine else None) for op in operands)

    def unfused():
        h = _ACT[act](qm.int4_matmul(x, gate[0], gate[1], qm.GROUP, gate[2])) * qm.int4_matmul(
            x, up[0], up[1], qm.GROUP, up[2])
        return qm.int4_matmul(h.to(torch.bfloat16), down_planar[0], down_planar[1], qm.GROUP, down_planar[2])

    return (lambda: fused_int4_mlp(x, gate, up, down, act=act, block_f=block_f),
            lambda: fused_int4_mlp_ref(x, gate, up, down, act=act, block_f=block_f), unfused)


def mega_operands(dev, g, cfg):
    """Random operand stacks of the megakernel at cfg's geometry: uniform
    nibbles, bf16 scales, small qkv bias, norms near 1. Returns (ops tuple,
    bytes of the stacks). The scales keep the residual stream O(10) over 28
    layers: with scales 4x larger this random trunk grows |y| to ~6e3 and
    amplifies last-bit differences, so kernel and plain version, equal at
    layer 0, part by up to 115 % at layer 6 (`tools/mega_amplification.py`,
    PERF.md)."""
    L, d, ff = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    n_q = cfg.num_attention_heads * D
    n_qkv = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * D

    def weight(k, n, group):
        packed = torch.randint(0, 256, (L, k // 2, n), device=dev, dtype=torch.uint8, generator=g)
        scales = torch.rand(L, k // group, n, device=dev, generator=g) * (0.5 / (4.6 * k**0.5))
        return packed, scales.to(torch.bfloat16)

    def norm():
        return 1.0 + 0.1 * torch.randn(L, 1, d, device=dev, generator=g)

    ops = ((*weight(d, n_qkv, 128), 0.1 * torch.randn(L, 1, n_qkv, device=dev, generator=g)),
           weight(n_q, d, 128), weight(d, ff, 128), weight(d, ff, 128), weight(ff, d, 32),
           norm(), norm())
    nbytes = sum(t.numel() * t.element_size() for op in ops for t in (op if isinstance(op, tuple) else (op,)))
    return ops, nbytes


# the megakernel rows: (kernel, pos, kv_start); b=1 at pos 0 / 100 / 1531,
# b=8 at unequal positions (the engine's shape), b=32 lockstep at 200
# b=8 at unequal positions (the engine's shape), b=32 lockstep at 200, and
# b=16 at unequal positions (the kernel's 9..16-row instance)
MEGA_ROWS = [("fused_decode_step", 0, 0), ("fused_decode_step", 100, 0), ("fused_decode_step", 1531, 200),
             ("fused_decode_step_batched", [1, 17, 100, 511, 513, 1000, 1531, 2000], [0, 0, 5, 100, 0, 50, 0, 3]),
             ("fused_decode_step_batched", [200] * 32, None),
             ("fused_decode_step_batched", [40 + 125 * i for i in range(16)], [0, 7] * 8)]
MEGA_MAIN_ROWS = (2, 3)  # fused_decode_step's and fused_decode_step_batched's main rows
# The Qwen2-7B language model's widths (hidden 3584, ffn 18944, 28/4 heads),
# depth cut to 4 layers: at b=16 its gate+up product has 296 work items for
# 264 resident blocks, at b=32 518 for 132, so blocks own several chunks of
# one column tile and meet at its barrier once (csrc/decode_step.cu).
QWEN2_7B_LM_4L = dict(vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_hidden_layers=4,
                      num_attention_heads=28, num_key_value_heads=4, head_dim=128,
                      max_position_embeddings=32768, rope_theta=1e6)
MEGA_WIDE_ROWS = [("fused_decode_step_batched", [40 + 125 * i for i in range(16)], None),
                  ("fused_decode_step_batched", [300] * 32, None)]


def mega_kw(cfg) -> dict:
    """The megakernel's geometry arguments for cfg, as MegaDecodeLM.from_float lays it out."""
    from mllm_tpu_torch.models.megadecode import BLOCK_F_CAP
    from mllm_tpu_torch.ops.fused_mlp import pick_block_f

    return dict(n_heads=cfg.num_attention_heads, n_kv_heads=cfg.num_key_value_heads, head_dim=D, group_a=128,
                group_d=32, block_f=pick_block_f(cfg.intermediate_size, cap=BLOCK_F_CAP))


def mega_cache(cfg, b, dev, g):
    return [torch.randn(cfg.num_hidden_layers, b, cfg.num_key_value_heads, S_CACHE, D, device=dev,
                        generator=g).to(torch.bfloat16) for _ in range(2)]


def mega_keys(pos, start) -> int:
    """Cached keys the step's attention reads, over all slots (one layer)."""
    if isinstance(pos, list):
        return sum(pos) - (sum(start) if start else 0)
    return pos - start


def mega_call(name, x, pos, start, rope, ops, kv, cfg):
    """(kernel wrapper, plain version, args, kwargs) of one MEGA_ROWS row."""
    from mllm_tpu_torch.ops import decode_step as ds

    kw = dict(kv_start=start, act=cfg.hidden_act, eps=cfg.rms_norm_eps, **mega_kw(cfg))
    if name == "fused_decode_step":
        rot = ds.rope_rotation_matrix(rope.sin[pos], rope.cos[pos])
        return ds.fused_decode_step, ds.fused_decode_step_ref, (x, pos, rot, *ops, *kv), kw
    p = torch.tensor(pos, device=x.device)
    return (ds.fused_decode_step_batched, ds.fused_decode_step_batched_ref,
            (x, pos, rope.sin[p], rope.cos[p], *ops, *kv), kw)


def mega_bound(cfg, weight_bytes, b, keys) -> dict:
    """Bytes: the weight stacks, the visible KV rows, x, y and the new K/V;
    operations: 2 a weight and row of x, 4 a visible key, head dim and q head."""
    L, d, hkv = cfg.num_hidden_layers, cfg.hidden_size, cfg.num_key_value_heads
    n_weights = 2 * weight_bytes_int4(cfg)
    nbytes = weight_bytes + keys * L * hkv * D * 2 * 2 + b * d * 4 * 2 + 2 * L * b * hkv * D * 4
    return bound(nbytes, 2 * b * n_weights + 4 * keys * L * cfg.num_attention_heads * D)


def weight_bytes_int4(cfg) -> int:
    """Packed bytes of the megakernel's five weight stacks (two weights a byte)."""
    d, ff = cfg.hidden_size, cfg.intermediate_size
    n_q, n_qkv = cfg.num_attention_heads * D, (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * D
    return cfg.num_hidden_layers * (d * n_qkv + n_q * d + 3 * d * ff) // 2


def mega_kernel_rows(dev, g) -> dict:
    """Both megakernels against their plain versions at the full Qwen2-VL-2B
    geometry (28 layers, cache 2048), then the batched one at Qwen2-7B's
    widths (4 layers): error = max |kernel - plain| / max |plain| over y,
    k_new and v_new; the bound is mega_bound's."""
    rows = {"fused_decode_step": [], "fused_decode_step_batched": []}
    for lm, mrows in ((QWEN2VL_2B_LM, MEGA_ROWS), (QWEN2_7B_LM_4L, MEGA_WIDE_ROWS)):
        for name, row in mega_geometry_rows(dev, g, lm, mrows):
            rows[name].append(row)
    return rows


def mega_geometry_rows(dev, g, lm: dict, mrows):
    """(kernel name, checked row) for each of mrows at the geometry lm."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.nn.layers import RotaryEmbedding

    cfg = TextConfig(**lm)
    ops, weight_bytes = mega_operands(dev, g, cfg)
    rope = RotaryEmbedding.make(D, S_CACHE, cfg.rope_theta, device=dev)
    for name, pos, start in mrows:
        b = len(pos) if isinstance(pos, list) else 1
        kv = mega_cache(cfg, b, dev, g)
        x = torch.randn(b, cfg.hidden_size, device=dev, generator=g)
        kernel, plain, args, kw = mega_call(name, x, pos, start, rope, ops, kv, cfg)
        out, ref = kernel(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        err = max(((o.float() - r.float()).abs().max() / r.float().abs().max()).item()
                  for o, r in zip(out, ref))
        abs_err = max((o.float() - r.float()).abs().max().item() for o, r in zip(out, ref))
        finite = all(bool(torch.isfinite(o).all()) for o in out)
        ms = time_ms(lambda: kernel(*args, **kw), 20)
        bnd = mega_bound(cfg, weight_bytes, b, mega_keys(pos, start))
        row = dict(phase="kernel_check", kernel=name,
                   shape=dict(b=b, pos=pos, kv_start=start, L=cfg.num_hidden_layers, d=cfg.hidden_size,
                   ff=cfg.intermediate_size, S=S_CACHE),
                   max_abs_err=abs_err, rel_err=err, tolerance=MEGA_TOL, finite=finite, ms=ms,
                   plain_ms=time_ms(lambda: plain(*args, **kw), 3), library_ms=None,
                   tb_per_s=bnd["bytes"] / ms / 1e9, hbm_tb_per_s=HBM_BYTES_PER_S / 1e12, **bnd)
        emit(**row)
        if not finite or not err <= MEGA_TOL:
            raise AssertionError(f"{name} {row['shape']}: max |kernel - plain| / max |plain| {err} "
                                 f"(tolerance {MEGA_TOL}), finite={finite}")
        del kv, out, ref
        yield name, row


def last_step_vs_prefill(model, dev, prompt, tokens, last_logits, kv_dtype: str = "bf16") -> float:
    """max |last decode step's logits - a fresh prefill's| / max |prefill
    logits|, the prefill over prompt + tokens[:-1]."""
    from mllm_tpu_torch.generation.generate import pad_to_bucket, prefill

    ids = np.concatenate([np.asarray(prompt), np.asarray(tokens[:-1])])
    fresh, _ = prefill(model, model.init_cache(1, S_CACHE, kv_dtype=kv_dtype),
                       torch.as_tensor(pad_to_bucket(ids[None]), device=dev), len(ids))
    fresh = fresh.float()
    return ((last_logits.float() - fresh).abs().max() / fresh.abs().max()).item()


def logits_spy(model, dev):
    """Wrap model.logits for eager runs: every call's output is checked for
    finite values on the device (no host read) and the last one kept.
    Returns (state, restore): state["finite"] is a device bool, state["last"]
    the last call's logits."""
    plain = model.logits
    state = {"finite": torch.ones((), dtype=torch.bool, device=dev), "last": None}

    def spy(hidden):
        out = plain(hidden)
        state["finite"] = state["finite"] & torch.isfinite(out).all()
        state["last"] = out
        return out

    model.logits = spy
    # deleting the instance attribute leaves no model -> bound method -> model
    # cycle, which would keep a deleted model's memory until a collection
    return state, lambda: delattr(model, "logits")


def drive(model, cfg, dev, phase: str, ragged_lens, expected_per, kv_dtype: str = "bf16") -> dict:
    """Run the main path of one slice phase through the user entry points and
    check it, over caches of `kv_dtype`. expected_per(prefills, steps) ->
    {kernel: least launches}, where 0 means none at all."""
    from mllm_tpu_torch.generation.generate import (
        generate, left_pad, pad_to_bucket, prefill, ragged_batched_generate)
    from mllm_tpu_torch.generation.sampling import SamplingConfig

    kernels = wrappers()
    spy, restore = logits_spy(model, dev)  # every logits call of the run is checked for finite values
    rng = np.random.default_rng(0)
    greedy = SamplingConfig(max_new_tokens=64)
    torch.cuda.reset_peak_memory_stats()

    for fn in kernels.values():
        fn.launches = 0
    prefills, steps = 0, 0

    def init_cache(b):
        return model.init_cache(b, S_CACHE, kv_dtype=kv_dtype)

    def run_generate(prompt, scfg, seed=0):
        nonlocal prefills, steps
        res, _ = generate(model, prompt, init_cache(1), scfg, seed=seed)
        prefills += 1
        steps += len(res.tokens) - 1
        return res

    run_generate(rng.integers(0, cfg.vocab_size, 100), SamplingConfig(max_new_tokens=8))  # warm-up
    prompt100 = rng.integers(0, cfg.vocab_size, 100)
    res100 = run_generate(prompt100, greedy)
    last_step = spy["last"][:, -1]  # the last greedy decode step's logits
    res1500 = run_generate(rng.integers(0, cfg.vocab_size, 1500), SamplingConfig(max_new_tokens=32))

    # decode vs prefill: the last decode step against a fresh prefill of the same tokens
    decode_vs_prefill = last_step_vs_prefill(model, dev, prompt100, res100.tokens, last_step, kv_dtype)
    prefills += 1
    emit(phase=f"{phase}_decode_vs_prefill", max_abs_diff_over_max_logit=decode_vs_prefill,
         tolerance=RAGGED_TOL, tokens=len(prompt100) + len(res100.tokens) - 1)
    if not decode_vs_prefill <= RAGGED_TOL:
        raise AssertionError(f"{phase}: last decode step differs from a fresh prefill: "
                             f"{decode_vs_prefill} > {RAGGED_TOL}")

    def timed_prefill(n):
        ids = torch.as_tensor(pad_to_bucket(rng.integers(0, cfg.vocab_size, (1, n))), device=dev)
        cache = init_cache(1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill(model, cache, ids, n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    prefill_ms_100 = float(np.median([timed_prefill(100) for _ in range(3)]))
    prefill_ms_1500 = float(np.median([timed_prefill(1500) for _ in range(3)]))
    prefills += 6

    # ragged batch: prefill logits of each row against the prompt alone
    b = len(ragged_lens)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in ragged_lens]
    ids, pad = left_pad(prompts)
    width = ids.shape[1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    lg_ragged, _ = prefill(model, init_cache(b), torch.as_tensor(ids, device=dev),
                           width, torch.as_tensor(pad, device=dev))
    torch.cuda.synchronize()
    ragged_prefill_s = time.perf_counter() - t
    prefills += 1
    worst = 0.0
    for i, p in enumerate(prompts):
        ids1 = torch.as_tensor(pad_to_bucket(p[None]), device=dev)
        lg_alone, _ = prefill(model, init_cache(1), ids1, len(p))
        prefills += 1
        ratio = ((lg_ragged[i].float() - lg_alone[0].float()).abs().max()
                 / lg_alone[0].float().abs().max()).item()
        worst = max(worst, ratio)
    emit(phase=f"{phase}_ragged_vs_alone", max_abs_diff_over_max_logit=worst, tolerance=RAGGED_TOL)
    if not worst <= RAGGED_TOL:
        raise AssertionError(f"{phase}: ragged prefill logits differ from single-stream: "
                             f"{worst} > {RAGGED_TOL}")

    torch.cuda.synchronize()
    t = time.perf_counter()
    toks, _, _ = ragged_batched_generate(model, prompts, init_cache(b),
                                         SamplingConfig(max_new_tokens=32))
    torch.cuda.synchronize()
    ragged_s = time.perf_counter() - t
    prefills += 1
    steps += toks.shape[1] - 1
    if toks.shape != (b, 32):
        raise AssertionError(f"ragged_batched_generate returned {toks.shape}, expected ({b}, 32)")
    decode_tps_ragged = b * (toks.shape[1] - 1) / (ragged_s - ragged_prefill_s)

    sampled = run_generate(rng.integers(0, cfg.vocab_size, 100),
                           SamplingConfig(max_new_tokens=16, do_sample=True, top_k=50, top_p=0.9),
                           seed=7)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    expected = expected_per(prefills, steps)
    all_finite = bool(spy["finite"])
    restore()
    for name, res in (("greedy_100", res100), ("greedy_1500", res1500), ("sampled", sampled)):
        if not all(0 <= t < cfg.vocab_size for t in res.tokens):
            raise AssertionError(f"{phase} {name}: token out of vocabulary")
    if not ((0 <= toks) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{phase} ragged: token out of vocabulary")
    emit(phase=phase, prompt_tokens=[100, 1500, list(ragged_lens), 100],
         new_tokens=[len(res100.tokens), len(res1500.tokens), int(toks.shape[1]),
                     len(sampled.tokens)],
         prefill_ms_100_tokens=prefill_ms_100, prefill_ms_1500_tokens=prefill_ms_1500,
         ttft_ms_1500_tokens=res1500.ttft_s * 1e3,
         decode_tok_s_b1_ctx100=res100.decode_tps, decode_tok_s_b1_ctx1500=res1500.decode_tps,
         **{f"decode_tok_s_b{b}_ragged": decode_tps_ragged},
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         prefills=prefills, decode_steps=steps,
         launches=launches, launches_expected_at_least=expected, logits_finite=all_finite)
    if not all_finite:
        raise AssertionError(f"{phase}: non-finite logits on the main path")
    for name, want in expected.items():
        if launches[name] < want or (want == 0) != (launches[name] == 0):
            raise AssertionError(f"{phase} {name}: {launches[name]} launches, expected "
                                 f"{'none' if want == 0 else f'>= {want}'}")
    return {name: launches[name] for name in expected}


# slice_compiled: generate_compiled against the eager generate on the same
# model, prompts of 100 and 1500 tokens, 256 new tokens (eos never hit)
COMPILED_PROMPTS = (100, 1500)
COMPILED_NEW = 256


def first_divergence(a, b) -> int:
    """The first index where two token lists differ (-1: equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return -1 if len(a) == len(b) else min(len(a), len(b))


def timed(fn):
    """(fn(), wall seconds) with the card synchronised on both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def replay_ms(name: str) -> float:
    """Device ms of one replay of the StepGraph `name` replayed since the
    last reset_counts (CUDA events around it; a finished loop's replay runs
    the same launches as a live one, and writes nothing)."""
    from mllm_tpu_torch.generation import graphs

    (g,) = [x for x in graphs.all_graphs(name) if x.replays > 0]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    g.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def compiled_run(model, dev, name: str, kv_dtype: str = "bf16", sampled: bool = False, expected_per=None) -> dict:
    """slice_compiled on one model: generate_compiled (prompts of 100 and
    1500 tokens, 256 new, eos never hit) against the eager generate on the
    same model and cache type, and with sampled=True a sampled run (top-k
    50, top-p 0.9, seed 7) against the eager sampled run. Gates: equal
    tokens (the kernels and their arguments are the same, so a difference is
    a capture bug) and one graph replay a window of COMPILED_WINDOW steps
    (after a warm-up call that ran the loop's eager step and its capture).
    Prints tok/s of both over wall time, wall ms a token, device ms a step
    (CUDA events around one replay / COMPILED_WINDOW) and the card's busy
    share (device ms a step / graph wall ms a token). Returns the launches on
    the card (graphs.device_launches); with expected_per(prefills, decode
    steps) -> {kernel: launches} they must be exactly those (a prefill for
    each generate_compiled and eager generate; a window's replay is W steps,
    an eager generate's steps its tokens less one)."""
    from mllm_tpu_torch.generation import graphs
    from mllm_tpu_torch.generation.generate import COMPILED_WINDOW, generate, generate_compiled, pad_to_bucket
    from mllm_tpu_torch.generation.sampling import SamplingConfig

    V, W = model.cfg.vocab_size, COMPILED_WINDOW
    rng = np.random.default_rng(17)
    greedy = SamplingConfig(max_new_tokens=COMPILED_NEW)
    sample = SamplingConfig(max_new_tokens=64, do_sample=True, top_k=50, top_p=0.9)

    def cache():
        return model.init_cache(1, S_CACHE, kv_dtype=kv_dtype)

    def compiled(prompt, scfg, n_new, seed=0):
        ids = pad_to_bucket(np.asarray(prompt)[None])
        (toks, n), t = timed(lambda: generate_compiled(model, ids, cache(), len(prompt), n_new, scfg, seed=seed))
        return toks.cpu().numpy()[: int(n)].tolist(), t

    for scfg in (greedy, sample) if sampled else (greedy,):  # the loops' eager steps and captures
        compiled(rng.integers(0, V, 100), scfg, 2 * W)
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    graphs.reset_counts()
    runs, ok = [], True
    prefills = steps = 0
    for n_prompt in COMPILED_PROMPTS:
        prompt = rng.integers(0, V, n_prompt)
        before = graphs.replays("generate_compiled")
        toks, t_graph = compiled(prompt, greedy, COMPILED_NEW)
        reps = graphs.replays("generate_compiled") - before
        (res, _), t_eager = timed(lambda: generate(model, prompt, cache(), greedy))
        prefills += 2
        steps += reps * W + len(res.tokens) - 1
        want_reps = -(-(COMPILED_NEW - 1) // W)
        runs.append(dict(prompt_tokens=n_prompt, new_tokens=len(toks), equal=toks == res.tokens,
                         first_divergence=first_divergence(toks, res.tokens), graph_replays=reps,
                         expected_replays=want_reps, graph_tok_s=len(toks) / t_graph,
                         eager_tok_s=len(res.tokens) / t_eager, graph_wall_ms_per_token=t_graph / len(toks) * 1e3,
                         eager_wall_ms_per_token=t_eager / len(res.tokens) * 1e3,
                         eager_decode_tok_s=res.decode_tps))
        ok &= toks == res.tokens and len(toks) == COMPILED_NEW and reps == want_reps
    step_ms = replay_ms("generate_compiled") / W
    sampled_run = None
    if sampled:
        prompt = rng.integers(0, V, 100)
        before = graphs.replays("generate_compiled")
        toks, _ = compiled(prompt, sample, 64, seed=7)
        res, _ = generate(model, prompt, cache(), sample, seed=7)
        prefills += 2
        steps += (graphs.replays("generate_compiled") - before) * W + len(res.tokens) - 1
        sampled_run = dict(prompt_tokens=100, new_tokens=len(toks), equal=toks == res.tokens,
                           first_divergence=first_divergence(toks, res.tokens))
        ok &= toks == res.tokens and len(toks) == 64
    counted = {k: fn.launches for k, fn in kernels.items()}
    launches = graphs.device_launches(counted)
    emit(phase="slice_compiled", model=name, kv_dtype=kv_dtype, window=W, runs=runs, sampled=sampled_run,
         device_ms_per_step=step_ms, busy_share=step_ms / runs[0]["graph_wall_ms_per_token"],
         launches=launches, launches_counted=counted,
         launch_note="launches on the card: the counters less each capture's recorded launches, plus each "
                     "graph's launches times its replays (steps past the end of a loop run too)")
    if not ok:
        raise AssertionError(f"slice_compiled {name}: generate_compiled differs from eager generate, or "
                             f"not one replay a window: {runs} {sampled_run}")
    if expected_per is not None:
        want = expected_per(prefills, steps)
        if any(launches[k] != n for k, n in want.items()):
            raise AssertionError(f"slice_compiled {name}: launches {launches}, expected {want}")
    return launches


def init_model(cfg, dev):
    from mllm_tpu_torch.models.transformer import CausalLM

    return CausalLM.init(cfg, device=dev, dtype=torch.bfloat16,
                         generator=torch.Generator(device=dev).manual_seed(0))


def state_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())


def phase_slice(dev) -> dict:
    from mllm_tpu_torch.core.config import TextConfig

    cfg = TextConfig(**QWEN2VL_2B_LM)
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = init_model(cfg, dev)
    torch.cuda.synchronize()
    emit(phase="slice_init", seconds=time.perf_counter() - t0,
         params=sum(p.numel() for p in model.parameters()), weight_bytes=state_bytes(model))
    launches = drive(model, cfg, dev, "slice", (17, 64, 128, 200),
                     lambda prefills, steps: {"flash_attention": L * prefills,
                                              "decode_attention": L * steps})
    return add_launches(launches, compiled_run(model, dev, "bf16", sampled=True))


def add_launches(total: dict, more: dict) -> dict:
    for k, n in more.items():
        total[k] = total.get(k, 0) + n
    return total


def phase_slice_quant(dev, mode: str, keep: bool = False):
    """fuse_projections + quantize_model(mode, on_device=True) of the bf16
    model on the card, then the main path through the quantized model.
    Returns the launches, and with keep=True the model too."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.generation.generate import pad_to_bucket, prefill
    from mllm_tpu_torch.ops.quantize_model import fuse_projections, quantize_model

    cfg = TextConfig(**QWEN2VL_2B_LM)
    L = cfg.num_hidden_layers
    model = init_model(cfg, dev)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 100))
    ids = torch.as_tensor(pad_to_bucket(prompt), device=dev)
    lg_bf16, _ = prefill(model, model.init_cache(1, S_CACHE), ids, 100)
    bf16_bytes = state_bytes(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_model(fuse_projections(model), mode, on_device=True)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    lg_q, _ = prefill(model, model.init_cache(1, S_CACHE), ids, 100)
    vs_bf16 = ((lg_q.float() - lg_bf16.float()).abs().max() / lg_bf16.float().abs().max()).item()
    layers = {type(m).__name__ for m in model.modules()}
    emit(phase=f"slice_{mode}_quantize", seconds=quant_s, bf16_weight_bytes=bf16_bytes,
         weight_bytes=state_bytes(model), logits_vs_bf16_max_abs_diff_over_max_logit=vs_bf16,
         layers=sorted(layers))
    want = ({"QuantLinear", "QuantEmbedHead"} if mode == "int8"
            else {"Int4Linear", "FusedInt4MLP", "Int4EmbedHead"})
    if not want <= layers or "Linear" in layers:
        raise AssertionError(f"slice_{mode}: quantize_model left {sorted(layers)}")

    if mode == "int8":  # 4 products a layer (qkv, o, gate||up, down) and the head, per forward
        def expected(prefills, steps):
            return {"flash_attention": L * prefills, "decode_attention": L * steps,
                    "int8_matmul": (4 * L + 1) * (prefills + steps)}
        lens = (17, 40, 64, 90, 128, 150, 180, 200)
    else:  # decode: qkv and o a layer and the head; prefill: the head (m = batch)
        def expected(prefills, steps):
            return {"flash_attention": L * prefills, "decode_attention": L * steps,
                    "int4_matmul": (2 * L + 1) * steps + prefills,
                    "fused_int4_mlp": L * steps}
        lens = (17, 64, 128, 200)
    launches = add_launches(drive(model, cfg, dev, f"slice_{mode}", lens, expected),
                            compiled_run(model, dev, mode))
    if keep:
        return launches, model
    del model
    torch.cuda.empty_cache()
    return launches


def phase_slice_kvq(dev, model) -> dict:
    """The int8-weight model over int8 and int4 KV caches
    (`init_cache(kv_dtype=...)`): generate at b=1 (prompts 100 and 1500),
    ragged_batched_generate at b=8 (left padding: kv_start reaches both
    quantized kernels) and a sampled generate, with drive()'s checks. Every
    prefill is 28 flash_attention_quant launches and every decode step 28
    decode_attention_quant; the bf16 attention kernels never launch."""
    L = model.cfg.num_hidden_layers
    lens = (17, 40, 64, 90, 128, 150, 180, 200)

    def expected(prefills, steps):
        return {"flash_attention_quant": L * prefills, "decode_attention_quant": L * steps,
                "int8_matmul": (4 * L + 1) * (prefills + steps), "flash_attention": 0,
                "decode_attention": 0}

    launches = {}
    for kv in ("int8", "int4"):
        add_launches(launches, drive(model, model.cfg, dev, f"slice_kvq_{kv}", lens, expected, kv))
    return add_launches(launches, compiled_run(model, dev, "int8_kv_int8", kv_dtype="int8"))


# slice_sd: bench.py's bench_sd prompts (numpy default_rng(0)), 128 new tokens
SD_NEW = 128


def phase_slice_sd(dev, model) -> dict:
    """The int8 model through the three speculative decoders on bench_sd's
    two prompts: a 16-token pattern x 8 (max_draft 8) and Zipf(1.3) over 8192
    ids, 128 tokens (max_draft 4); speculative_generate_compiled and
    speculative_generate at that max_draft, speculative_generate_tree at
    max_draft 6 and 3 traces. Gate: every token within RAGGED_TOL x max
    |logit| of the top of a teacher-forced prefill (the verify runs flash
    attention and greedy decode runs decode attention, so near-ties may
    differ). Prints whether each equals generate_compiled's greedy tokens
    (`lossless`), the first divergence, steps, drafted, accepted and tok/s
    against generate_compiled on the same prompt."""
    from mllm_tpu_torch.generation import graphs
    from mllm_tpu_torch.generation.generate import COMPILED_WINDOW, generate_compiled
    from mllm_tpu_torch.generation.sampling import SamplingConfig
    from mllm_tpu_torch.generation.speculative import (speculative_generate, speculative_generate_compiled,
                                                       speculative_generate_tree)

    V = model.cfg.vocab_size
    pattern = np.tile(np.random.default_rng(0).integers(0, V, 16), 8)
    zipf = np.minimum(np.random.default_rng(0).zipf(1.3, size=128), 8192) - 1
    greedy = SamplingConfig(max_new_tokens=SD_NEW)

    def cache():
        return model.init_cache(1, S_CACHE)

    generate_compiled(model, pattern[None], cache(), 128, 2 * COMPILED_WINDOW, greedy)  # warm-ups
    for md in (8, 4):
        speculative_generate_compiled(model, pattern[None], cache(), 128, 24, max_draft=md)
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    graphs.reset_counts()
    worst = 0.0
    for name, prompt, md in (("pattern", pattern, 8), ("zipf", zipf, 4)):
        ids = prompt[None]
        (ref, n_ref), t_ref = timed(lambda: generate_compiled(model, ids, cache(), 128, SD_NEW, greedy,
                                                              eos_token_id=-7))
        ref = ref.cpu().numpy()[: int(n_ref)].tolist()
        (toks, n, steps, drafted, accepted), t_c = timed(lambda: speculative_generate_compiled(
            model, ids, cache(), 128, SD_NEW, eos_token_id=-7, max_draft=md, ngram=3))
        compiled_out = toks.cpu().numpy()[: int(n)].tolist()
        (host_out, _, hs), t_h = timed(lambda: speculative_generate(model, ids, cache(), SD_NEW, eos_token_id={-7},
                                                                    max_draft=md))
        (tree_out, _, ts), t_t = timed(lambda: speculative_generate_tree(model, ids, cache(), SD_NEW,
                                                                         eos_token_id={-7}, max_draft=6,
                                                                         max_traces=3))
        decoders = [("compiled", compiled_out, (int(steps), int(drafted), int(accepted)), t_c, md),
                    ("host", host_out, (hs.steps, hs.drafted, hs.accepted), t_h, md),
                    ("tree", tree_out, (ts.steps, ts.drafted, ts.accepted), t_t, 6)]
        for dec, out, (st, dr, ac), t, draft in decoders:
            gap = teacher_forced_gap(model, dev, prompt, out)
            worst = max(worst, gap)
            emit(phase="slice_sd", prompt=name, decoder=dec, max_draft=draft, new_tokens=len(out),
                 lossless=out == ref, first_divergence=first_divergence(out, ref), steps=st, drafted=dr,
                 accepted=ac, acceptance=ac / dr if dr else 0.0, tok_s=len(out) / t,
                 generate_compiled_tok_s=len(ref) / t_ref, speedup=t_ref / t * len(out) / len(ref),
                 teacher_forced_gap_over_max_logit=gap, tolerance=RAGGED_TOL)
            if len(out) != SD_NEW or not all(0 <= x < V for x in out) or not gap <= RAGGED_TOL:
                raise AssertionError(f"slice_sd {name} {dec}: {len(out)} tokens, teacher-forced gap {gap}")
    return graphs.device_launches({k: fn.launches for k, fn in kernels.items()})


def phase_slice_prefill(dev, model) -> dict:
    """chunked_prefill of a 1500-token prompt in chunks of 256 over bf16 and
    int8 KV caches against a one-shot prefill (last logits within RAGGED_TOL x
    max |logit|); then prefill_with_prompt_cache of a second prompt sharing
    the first 1024 tokens with a stored prefix (matched exactly 1024, logits
    within the same tolerance of a one-shot prefill of it), and the same
    prompt again (a full hit: matched 1500). Prints each prefill's ms."""
    from mllm_tpu_torch.generation.generate import pad_to_bucket, prefill
    from mllm_tpu_torch.generation.prefill import PromptCache, chunked_prefill, prefill_with_prompt_cache

    V = model.cfg.vocab_size
    rng = np.random.default_rng(9)
    a = rng.integers(0, V, 1500)
    b = np.concatenate([a[:1024], rng.integers(0, V, 476)])
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0

    def ratio(x, ref):
        return ((x.float() - ref.float()).abs().max() / ref.float().abs().max()).item()

    for kv in ("bf16", "int8"):
        def cache():
            return model.init_cache(1, S_CACHE, kv_dtype=kv)

        def one_shot(p):
            return prefill(model, cache(), torch.as_tensor(pad_to_bucket(p[None]), device=dev), len(p))[0]

        one_shot(a)  # warm-up
        chunked_prefill(model, cache(), a[None], 1500, chunk=256)
        ref_a, t_one = timed(lambda: one_shot(a))
        (lg_a, _), t_chunked = timed(lambda: chunked_prefill(model, cache(), a[None], 1500, chunk=256))
        pc = PromptCache(4)
        _, t_store = timed(lambda: prefill_with_prompt_cache(model, cache(), a[None, :1024], 1024, pc, chunk=256))
        (lg_b, _, matched), t_hit = timed(lambda: prefill_with_prompt_cache(model, cache(), b[None], 1500, pc,
                                                                             chunk=256))
        (lg_full, _, matched_full), t_full = timed(lambda: prefill_with_prompt_cache(model, cache(), b[None], 1500,
                                                                                      pc, chunk=256))
        ref_b = one_shot(b)
        gaps = dict(chunked=ratio(lg_a, ref_a), prefix_hit=ratio(lg_b, ref_b), full_hit=ratio(lg_full, ref_b))
        emit(phase="slice_prefill", kv_dtype=kv, prompt_tokens=1500, chunk=256, one_shot_ms=t_one * 1e3,
             chunked_ms=t_chunked * 1e3, store_prefix_1024_ms=t_store * 1e3, prefix_hit_ms=t_hit * 1e3,
             full_hit_ms=t_full * 1e3, matched=matched, matched_full=matched_full,
             logits_gap_over_max_logit=gaps, tolerance=RAGGED_TOL)
        if matched != 1024 or matched_full != 1500 or not max(gaps.values()) <= RAGGED_TOL:
            raise AssertionError(f"slice_prefill {kv}: matched {matched} / {matched_full}, gaps {gaps}")
    return {k: fn.launches for k, fn in kernels.items()}


# the engine runs: 12 requests for 8 slots (slots are reused), prompts of
# 17-300 tokens (those over one 128-token bucket are admitted one by one),
# 48 new tokens each, requests 10 and 11 sampled
ENGINE_LENS = (17, 40, 64, 100, 128, 150, 200, 256, 300, 90, 33, 180)
ENGINE_NEW = 48
ENGINE_KW = dict(slots=8, max_len=S_CACHE, prompt_bucket=128, decode_window=32, pipeline=True,
                 eos_token_id=-2)


def paged_blocks_short_of(lens, short: int, new: int = ENGINE_NEW) -> int:
    """A pool `short` blocks smaller than the first eight requests (of `new`
    tokens each) reserve together, counted as ContinuousEngine._paged_reserve
    counts them."""
    need = [max(-(-(n + new) // 128), -(-n // 128)) for n in lens[:8]]
    return sum(need) - short


def serve(model, dev, name: str, engine_kw: dict, expected_per, start_thread=False) -> dict:
    """One engine run of ENGINE_LENS through submit / step (or the loop thread)
    / collect, checked: every request returns ENGINE_NEW in-vocabulary
    tokens; 4 greedy requests' tokens lie within RAGGED_TOL x max |logit| of
    the top logit of a teacher-forced single-stream prefill of prompt +
    tokens over a cache of the same type; the launch counts are
    expected_per(admissions, decode steps), 0 meaning none."""
    from mllm_tpu_torch.generation.engine import ContinuousEngine, collect
    from mllm_tpu_torch.generation.sampling import SamplingConfig

    V = model.cfg.vocab_size
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, V, n) for n in ENGINE_LENS]
    sampled = SamplingConfig(max_new_tokens=ENGINE_NEW, do_sample=True, top_k=50, top_p=0.9)
    from mllm_tpu_torch.generation import graphs

    kernels = wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousEngine(model, start_thread=start_thread, **ENGINE_KW, **engine_kw)
    cache_bytes = sum(t.numel() * t.element_size() for t in vars(eng.cache).values()
                      if isinstance(t, torch.Tensor) and t.dim() >= 4)
    for fn in kernels.values():
        fn.launches = 0
    graphs.reset_counts()
    t0 = time.perf_counter()
    qs = [eng.submit(p, ENGINE_NEW, sampled if i >= 10 else None) for i, p in enumerate(prompts)]
    if start_thread:
        outs = [collect(q, timeout=600) for q in qs]
        eng.stop()
    else:
        while any(r is not None for r in eng.req) or not eng.pending.empty() or eng._inflight is not None:
            eng.step()
        outs = [collect(q, timeout=5) for q in qs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = {k: fn.launches for k, fn in kernels.items()}
    launches = graphs.device_launches(counted)
    # decode steps: every window's, and each window graph's warm-up model call
    steps = eng.steps * eng.window + len(eng._windows)
    expected = expected_per(eng.admissions, steps)
    peak = torch.cuda.max_memory_allocated()
    if not all(len(o) == ENGINE_NEW and all(0 <= t < V for t in o) for o in outs):
        raise AssertionError(f"{name}: lengths {[len(o) for o in outs]} (expected {ENGINE_NEW} each) "
                             "or a token out of the vocabulary")
    kv_dtype = engine_kw.get("kv_dtype", "bf16") if "paged" not in engine_kw else "bf16"
    gap = max(teacher_forced_gap(model, dev, prompts[i], outs[i], kv_dtype)
              for i in (0, 3, 7, 8))  # greedy; prompts of 17, 100, 256 and 300 tokens
    replays = sum(g.replays for g in eng._windows.values())
    capture_s = sum(g.capture_s for g in eng._windows.values())
    emit(phase="slice_engine", run=name, requests=len(prompts), new_tokens=ENGINE_NEW,
         prompt_tokens=list(ENGINE_LENS), wall_s=wall, tok_s=len(prompts) * ENGINE_NEW / wall,
         capture_s=capture_s, tok_s_less_capture=len(prompts) * ENGINE_NEW / (wall - capture_s),
         windows=eng.steps, graph_replays=replays,
         decode_steps=steps, admissions=eng.admissions, requeued=eng.requeued,
         kv_cache_bytes=cache_bytes, max_memory_allocated_bytes=peak,
         teacher_forced_gap_over_max_logit=gap, tolerance=RAGGED_TOL, launches=launches,
         launches_counted=counted, launches_expected=expected, loop_thread=start_thread,
         launch_note="launches on the card: the counters (one per launch made eagerly or recorded "
                     "in a capture) less each capture's recorded launches, plus each graph's "
                     "launches times its replays")
    if replays != eng.steps:
        raise AssertionError(f"{name}: {eng.steps - replays} of {eng.steps} windows ran eagerly; every "
                             "window is a graph replay")
    if not gap <= RAGGED_TOL:
        raise AssertionError(f"{name}: an emitted greedy token sits {gap} x max |logit| below the "
                             f"top of a teacher-forced prefill (tolerance {RAGGED_TOL})")
    for k, want in expected.items():
        if launches[k] != want:
            raise AssertionError(f"{name} {k}: {launches[k]} launches, expected {want}")
    if "paged" in engine_kw and eng.requeued == 0:
        raise AssertionError(f"{name}: no request waited for pool blocks while a slot was free")
    del eng
    torch.cuda.empty_cache()
    return {k: launches[k] for k in expected}


def teacher_forced_gap(model, dev, prompt, toks, kv_dtype: str = "bf16") -> float:
    """How far below the top of a teacher-forced prefill of prompt + toks[:-1]
    the emitted tokens sit: max over positions of (max logit - logit of the
    token) / max |logit|, over a cache of `kv_dtype`."""
    ids = np.concatenate([np.asarray(prompt), np.asarray(toks[:-1])])
    logits, _ = model(torch.as_tensor(ids[None], device=dev),
                      model.init_cache(1, S_CACHE, kv_dtype=kv_dtype), last_only=False)
    lg = logits[0, len(prompt) - 1 :].float()
    chosen = lg.gather(1, torch.as_tensor(np.asarray(toks), device=dev)[:, None])[:, 0]
    return ((lg.max(-1).values - chosen) / lg.abs().max(-1).values).max().item()


# the prefix-cache engine run (bench.py's bench_engine("prefix")): a shared
# 128-token prefix and a distinct 128-token tail, 8 requests x 48 new tokens;
# the first admission stores its prompt, the other seven reuse the prefix
PREFIX_REQUESTS, PREFIX_NEW = 8, 48
# the bf16 engine with eager windows: commit c967662's final smoke, engine_bf16
# (NVIDIA H100 80GB HBM3, 700.00 W)
EAGER_ENGINE_BF16_TOK_S = 85.7


def serve_prefix(model, dev) -> dict:
    """ContinuousEngine(prefix_cache=8) over a bf16 slot cache on `model`:
    exact prefix_hits (7) and prefix_tokens_reused (7 x 128), 48
    in-vocabulary tokens a request, 4 greedy requests within RAGGED_TOL x
    max |logit| of a teacher-forced prefill, exact launch counts (one
    flash_attention prefill a layer and admission: whole prompts and
    suffixes alike)."""
    from mllm_tpu_torch.generation import graphs
    from mllm_tpu_torch.generation.engine import ContinuousEngine, collect

    L, V = model.cfg.num_hidden_layers, model.cfg.vocab_size
    rng = np.random.default_rng(0)
    shared = rng.integers(0, V, 128)
    prompts = [np.concatenate([shared, rng.integers(0, V, 128)]) for _ in range(PREFIX_REQUESTS)]
    kernels = wrappers()
    torch.cuda.synchronize()
    eng = ContinuousEngine(model, start_thread=False, prefix_cache=8, **ENGINE_KW)
    for fn in kernels.values():
        fn.launches = 0
    graphs.reset_counts()
    t0 = time.perf_counter()
    qs = [eng.submit(p, PREFIX_NEW) for p in prompts]
    while any(r is not None for r in eng.req) or not eng.pending.empty() or eng._inflight is not None:
        eng.step()
    outs = [collect(q, timeout=5) for q in qs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = graphs.device_launches({k: fn.launches for k, fn in kernels.items()})
    steps = eng.steps * eng.window + len(eng._windows)  # and each window graph's warm-up call
    expected = {"flash_attention": L * eng.admissions, "decode_attention": L * steps,
                **{k: 0 for k in ("flash_attention_quant", "decode_attention_quant", "decode_attention_paged")}}
    gap = max(teacher_forced_gap(model, dev, prompts[i], outs[i]) for i in (0, 1, 4, 7))
    want_hits, want_reused = PREFIX_REQUESTS - 1, (PREFIX_REQUESTS - 1) * 128
    replays = sum(g.replays for g in eng._windows.values())
    capture_s = sum(g.capture_s for g in eng._windows.values())
    emit(phase="slice_engine", run="engine_prefix", requests=PREFIX_REQUESTS, new_tokens=PREFIX_NEW,
         prompt_tokens="128 shared + 128 distinct", wall_s=wall, tok_s=PREFIX_REQUESTS * PREFIX_NEW / wall,
         capture_s=capture_s, tok_s_less_capture=PREFIX_REQUESTS * PREFIX_NEW / (wall - capture_s),
         eager_windows_engine_bf16_tok_s=EAGER_ENGINE_BF16_TOK_S, windows=eng.steps, graph_replays=replays,
         admissions=eng.admissions,
         prefix_hits=eng.prefix_hits, prefix_tokens_reused=eng.prefix_tokens_reused,
         expected_hits=want_hits, expected_reused=want_reused, teacher_forced_gap_over_max_logit=gap,
         tolerance=RAGGED_TOL, launches=launches, launches_expected=expected)
    if not all(len(o) == PREFIX_NEW and all(0 <= t < V for t in o) for o in outs):
        raise AssertionError(f"engine_prefix: lengths {[len(o) for o in outs]} or a token out of the vocabulary")
    if replays != eng.steps:
        raise AssertionError(f"engine_prefix: {eng.steps - replays} of {eng.steps} windows ran eagerly")
    if (eng.prefix_hits, eng.prefix_tokens_reused) != (want_hits, want_reused):
        raise AssertionError(f"engine_prefix: hits {eng.prefix_hits}, reused {eng.prefix_tokens_reused}; "
                             f"expected {want_hits}, {want_reused}")
    if not gap <= RAGGED_TOL:
        raise AssertionError(f"engine_prefix: teacher-forced gap {gap} > {RAGGED_TOL}")
    for k, want in expected.items():
        if launches[k] != want:
            raise AssertionError(f"engine_prefix {k}: {launches[k]} launches, expected {want}")
    del eng
    torch.cuda.empty_cache()
    return {k: launches[k] for k in expected}


def phase_slice_engine(dev, model) -> dict:
    """ContinuousEngine over the int8-weight model, once per slot cache: bf16
    SlotKVCache (on the loop thread), int8 and int4 SlotQuantKVCache, and a
    PagedKVCache whose pool is 4 blocks short of what the first eight
    requests reserve (admission has to requeue)."""
    L = model.cfg.num_hidden_layers
    runs = [
        ("bf16", {}, ("flash_attention", "decode_attention"), True),
        ("int8", {"kv_dtype": "int8"}, ("flash_attention_quant", "decode_attention_quant"), False),
        ("int4", {"kv_dtype": "int4"}, ("flash_attention_quant", "decode_attention_quant"), False),
        ("paged", {"paged": paged_blocks_short_of(ENGINE_LENS, 4)},
         ("flash_attention", "decode_attention_paged"), False),
    ]
    launches = {}
    for name, kw, (prefill_k, decode_k), thread in runs:
        others = {"flash_attention", "decode_attention", "flash_attention_quant",
                  "decode_attention_quant", "decode_attention_paged"} - {prefill_k, decode_k}

        def expected(admissions, steps, prefill_k=prefill_k, decode_k=decode_k, others=others):
            return {prefill_k: L * admissions, decode_k: L * steps, **{k: 0 for k in others}}

        for k, n in serve(model, dev, f"engine_{name}", kw, expected, start_thread=thread).items():
            launches[k] = launches.get(k, 0) + n
    for k, n in serve_prefix(model, dev).items():
        launches[k] = launches.get(k, 0) + n
    return launches


def unique_bytes(module) -> int:
    """Bytes of the distinct storages behind a module's tensors (views count once)."""
    storages = {}
    for t in module.state_dict().values():
        st = t.untyped_storage()
        storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values())


def phase_slice_mega(dev) -> dict:
    """MegaDecodeLM.from_float of the full-width random bf16 model on the card,
    then the main path: generate at b=1 (prompts 100 and 1500) and
    batched_generate at b=8 lockstep, every decode step one megakernel launch
    and the int4 head; then ragged_batched_generate, which goes through the
    int4 base model. Checks finite logits, tokens in the vocabulary, the last
    b=1 decode step against a fresh base prefill, 8 teacher-forced steps of
    mega against base (b=1, and 3 at b=8), and the exact launch counts."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.generation.generate import (batched_generate, generate, pad_to_bucket,
                                                    prefill, ragged_batched_generate)
    from mllm_tpu_torch.generation.sampling import SamplingConfig
    from mllm_tpu_torch.models.megadecode import MegaDecodeLM

    cfg = TextConfig(**QWEN2VL_2B_LM)
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    model = init_model(cfg, dev)
    bf16_bytes = state_bytes(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mega = MegaDecodeLM.from_float(model)
    torch.cuda.synchronize()
    from_float_s = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    stack_bytes = sum(t.numel() * t.element_size() for k, t in mega.state_dict().items()
                      if not k.startswith("base."))
    emit(phase="slice_mega_from_float", seconds=from_float_s, bf16_weight_bytes=bf16_bytes,
         kernel_stack_bytes=stack_bytes, weight_bytes=unique_bytes(mega))

    base = mega.base
    finite = torch.ones((), dtype=torch.bool, device=dev)
    last = {}
    plain_logits = base.logits

    def checked_logits(hidden):
        nonlocal finite
        out = plain_logits(hidden)
        finite = finite & torch.isfinite(out).all()
        last["logits"] = out
        return out

    base.logits = checked_logits
    kernels = wrappers()
    rng = np.random.default_rng(3)

    def ratio(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    def timed_prefill(b, n):
        ids = torch.as_tensor(pad_to_bucket(rng.integers(0, V, (b, n))), device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill(mega, mega.init_cache(b, S_CACHE), ids, n)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    generate(mega, rng.integers(0, V, 100), mega.init_cache(1, S_CACHE), SamplingConfig(max_new_tokens=4))
    prefill_b8_s = float(np.median([timed_prefill(8, 100) for _ in range(3)]))
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts set to 0 just before, read just after
    for fn in kernels.values():
        fn.launches = 0
    prompt100 = rng.integers(0, V, 100)
    res100, _ = generate(mega, prompt100, mega.init_cache(1, S_CACHE), SamplingConfig(max_new_tokens=64))
    last_step = last["logits"][:, -1].float()
    res1500, _ = generate(mega, rng.integers(0, V, 1500), mega.init_cache(1, S_CACHE),
                          SamplingConfig(max_new_tokens=32))
    ids8 = rng.integers(0, V, (8, 100))
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks8, _ = batched_generate(mega, ids8, np.full(8, 100), mega.init_cache(8, S_CACHE),
                                SamplingConfig(max_new_tokens=32))
    torch.cuda.synchronize()
    b8_s = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    steps_b1 = len(res100.tokens) - 1 + len(res1500.tokens) - 1
    steps_b8 = toks8.shape[1] - 1
    prefills = 3
    none = {k: 0 for k in ("flash_attention_quant", "decode_attention_quant", "decode_attention_paged")}
    expected = {"flash_attention": L * prefills, "decode_attention": 0, "int8_matmul": 0,
                "int4_matmul": steps_b1 + steps_b8 + prefills, "fused_int4_mlp": 0,
                "fused_decode_step": steps_b1, "fused_decode_step_batched": steps_b8, **none}

    # ragged batch: left padding goes through the int4 base model
    for fn in kernels.values():
        fn.launches = 0
    prompts = [rng.integers(0, V, n) for n in (17, 64, 128, 200)]
    toks_r, _, _ = ragged_batched_generate(mega, prompts, mega.init_cache(4, S_CACHE),
                                           SamplingConfig(max_new_tokens=16))
    launches_r = {name: fn.launches for name, fn in kernels.items()}
    steps_r = toks_r.shape[1] - 1
    expected_r = {"flash_attention": L, "decode_attention": L * steps_r, "int8_matmul": 0,
                  "int4_matmul": (2 * L + 1) * steps_r + 1, "fused_int4_mlp": L * steps_r,
                  "fused_decode_step": 0, "fused_decode_step_batched": 0, **none}

    # the last b=1 decode step against a fresh base prefill of the same tokens
    ids = np.concatenate([prompt100, res100.tokens[:-1]])
    lg_fresh, _ = prefill(base, base.init_cache(1, S_CACHE),
                          torch.as_tensor(pad_to_bucket(ids[None]), device=dev), len(ids))
    vs_prefill = ratio(last_step, lg_fresh)
    # teacher-forced: the same tokens through mega and base, step by step
    teacher = 0.0
    for b, toks, n_steps in ((1, np.array([res100.tokens]), 8), (8, toks8, 3)):
        ids = torch.as_tensor(pad_to_bucket(np.asarray(prompt100 if b == 1 else ids8).reshape(b, -1)),
                              device=dev)
        _, cm = prefill(base, base.init_cache(b, S_CACHE), ids, 100)
        _, cb = prefill(base, base.init_cache(b, S_CACHE), ids, 100)
        for i in range(n_steps):
            tok = torch.as_tensor(toks[:, i : i + 1], device=dev)
            lm, cm = mega(tok, cm)
            lb, cb = base(tok, cb)
            teacher = max(teacher, ratio(lm, lb))
    torch.cuda.synchronize()
    base.logits = plain_logits
    all_finite = bool(finite)
    emit(phase="slice_mega", prompt_tokens=[100, 1500, "8 x 100", [17, 64, 128, 200]],
         new_tokens=[len(res100.tokens), len(res1500.tokens), int(toks8.shape[1]), int(toks_r.shape[1])],
         decode_tok_s_b1_ctx100=res100.decode_tps, decode_tok_s_b1_ctx1500=res1500.decode_tps,
         decode_tok_s_b8_lockstep=8 * steps_b8 / (b8_s - prefill_b8_s),
         ttft_ms_1500_tokens=res1500.ttft_s * 1e3,
         max_memory_allocated_bytes=peak, last_decode_vs_prefill=vs_prefill,
         teacher_forced_mega_vs_base=teacher, tolerance=RAGGED_TOL, logits_finite=all_finite,
         launches=launches, launches_expected=expected, ragged_launches=launches_r,
         ragged_launches_expected=expected_r)
    if not all_finite:
        raise AssertionError("slice_mega: non-finite logits")
    outs = [np.array(res100.tokens), np.array(res1500.tokens), toks8, toks_r]
    if not all(((0 <= o) & (o < V)).all() for o in outs):
        raise AssertionError("slice_mega: token out of vocabulary")
    if not (vs_prefill <= RAGGED_TOL and teacher <= RAGGED_TOL):
        raise AssertionError(f"slice_mega: mega vs base {vs_prefill}, {teacher} > {RAGGED_TOL}")
    if launches != expected or launches_r != expected_r:
        raise AssertionError(f"slice_mega: launches {launches} / {launches_r}, expected {expected} / "
                             f"{expected_r}")
    # serving on the batched megakernel: admissions through the int4 base,
    # every decode step one launch with the slots at their own positions
    launches_e = serve(mega, dev, "engine_int4mega", {}, lambda admissions, steps: {
        "flash_attention": L * admissions, "fused_decode_step_batched": steps,
        "fused_decode_step": 0, "decode_attention": 0})
    launches_c = compiled_run(mega, dev, "mega")  # b=1: every step one fused_decode_step, device pos
    if launches_c["fused_decode_step"] == 0 or launches_c["decode_attention"] != 0:
        raise AssertionError(f"slice_compiled mega: launches {launches_c}")
    del mega, base
    torch.cuda.empty_cache()
    return {name: launches[name] + launches_r[name] + launches_e.get(name, 0) + launches_c.get(name, 0)
            for name in launches}


# ---------------------------------------------------------------------------
# The way in: head_dim route, containers, W8A8, the server
# ---------------------------------------------------------------------------

ATTENTION_KERNELS = ("flash_attention", "decode_attention", "flash_attention_quant",
                     "decode_attention_quant", "decode_attention_paged")
# (head_dim, heads, kv heads): 256 reaches the kernels of every cache (the
# dense runs here the bf16 ones), 80 no attention kernel
HEAD_DIM_ROUTE = ((256, 8, 2), (80, 8, 2))
HEAD_DIM_ROUTES = {256: ["decode", "decode_paged", "decode_quant", "flash", "flash_quant"], 80: ["sdpa"]}


def phase_head_dim_route(dev) -> dict:
    """A 2-layer qwen2-type model at head_dim 256, then 80 (8 / 2 heads,
    random bf16 weights) through generate and generate_compiled on the card:
    no raise; at 256 the dense cache's calls take flash_attention and
    decode_attention (and a quantized cache the quantized kernels), at 80 only
    `sdpa` serves attention (every attention kernel's counter stays 0);
    finite logits, and the last decode step within RAGGED_TOL x max |logit|
    of a fresh prefill. The launches at 256 count as the @256 rows'."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.generation import graphs
    from mllm_tpu_torch.generation.generate import generate, generate_compiled, pad_to_bucket
    from mllm_tpu_torch.generation.sampling import SamplingConfig
    from mllm_tpu_torch.nn.attention import attention_route

    kernels = wrappers()
    launches = {}
    for d, h, hkv in HEAD_DIM_ROUTE:
        t0 = time.perf_counter()
        cfg = TextConfig(**{**QWEN2VL_2B_LM, "num_hidden_layers": 2, "num_attention_heads": h,
                            "num_key_value_heads": hkv, "head_dim": d})
        model = init_model(cfg, dev)
        rng = np.random.default_rng(d)
        prompt = rng.integers(0, cfg.vocab_size, 100)
        for fn in kernels.values():
            fn.launches = 0
        graphs.reset_counts()
        spy, restore = logits_spy(model, dev)
        res, _ = generate(model, prompt, model.init_cache(1, S_CACHE), SamplingConfig(max_new_tokens=24))
        restore()  # eager runs only
        finite = bool(spy["finite"])
        gap = last_step_vs_prefill(model, dev, prompt, res.tokens, spy["last"][:, -1])
        toks, n = generate_compiled(model, pad_to_bucket(prompt[None]), model.init_cache(1, S_CACHE), 100, 40,
                                    SamplingConfig(max_new_tokens=40))
        compiled = toks.cpu().numpy()[: int(n)].tolist()
        torch.cuda.synchronize()
        counted = {k: fn.launches for k, fn in kernels.items()}
        on_card = graphs.device_launches(counted)
        routes = sorted({attention_route(sq, cache=c, head_dim=d) for sq in (1, 100)
                         for c in ("dense", "paged", "quant")})
        emit(phase="head_dim_route", head_dim=d, heads=h, kv_heads=hkv, layers=2, routes=routes,
             seconds=time.perf_counter() - t0, new_tokens=[len(res.tokens), len(compiled)],
             compiled_equals_eager=compiled[: len(res.tokens)] == res.tokens[: len(compiled)],
             compiled_in_vocab=all(0 <= t < cfg.vocab_size for t in compiled),
             last_decode_vs_prefill=gap, tolerance=RAGGED_TOL, logits_finite=finite,
             attention_launches={k: on_card[k] for k in ATTENTION_KERNELS})
        kernel_route = d == 256
        if routes != HEAD_DIM_ROUTES[d] or any(on_card[k] for k in ATTENTION_KERNELS[2:]) or \
                any(bool(on_card[k]) != kernel_route for k in ATTENTION_KERNELS[:2]):
            raise AssertionError(f"head_dim_route {d}: routes {routes}, launches {on_card}")
        if not finite or not gap <= RAGGED_TOL or not all(0 <= t < cfg.vocab_size for t in compiled):
            raise AssertionError(f"head_dim_route {d}: finite {finite}, decode vs prefill {gap}, "
                                 f"compiled tokens {compiled}")
        add_launches(launches, {k + ("@256" if kernel_route else ""): on_card[k] for k in ATTENTION_KERNELS[:2]})
        del model
        torch.cuda.empty_cache()
    return launches


# slice_containers: the ggml block kinds of the served model's projections
CONTAINER_KINDS = {"self_attn.q_proj": "Q4_0", "self_attn.k_proj": "Q4_0", "self_attn.v_proj": "Q4_0",
                   "self_attn.o_proj": "Q4_0", "mlp.gate_proj": "Q4_K", "mlp.up_proj": "Q4_K",
                   "mlp.down_proj": "Q8_0"}
GGML_TYPES = {"F32": 0, "F16": 1, "Q4_0": 2, "Q8_0": 8, "Q4_K": 12, "Q6_K": 14}  # ggml type ids
GGML_BLOCKS = {"Q4_0": (32, 18, (0,)), "Q8_0": (32, 34, (0,)), "Q4_K": (256, 144, (0, 2)),
               "Q6_K": (256, 210, (208,))}  # elements, bytes, f16 scale offsets of a block
TOKENIZER_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")
# Qwen2-VL's vision tokens (the VL processor's pads and brackets), after TOKENIZER_SPECIALS
VL_SPECIALS = ("<|vision_start|>", "<|vision_end|>", "<|image_pad|>", "<|video_pad|>")


def random_blocks(kind: str, n: int, k: int, std: float, rng) -> np.ndarray:
    """The ggml blocks of an [n, k] weight made straight from seeded random
    bytes: every byte random but the f16 block scales (d, and dmin = 7.5 d
    for Q4_K, so the groups' offsets centre the weights), one value for the
    whole tensor chosen so that the decoded weights' std is `std`."""
    from mllm_tpu_torch.core import dtypes as dt

    elems, nbytes, offsets = GGML_BLOCKS[kind]
    raw = rng.integers(0, 256, (n * k // elems, nbytes), dtype=np.uint8)

    def set_scales(d):
        for off, mult in zip(offsets, (1.0, 7.5)):
            raw[:, off : off + 2] = np.full((len(raw), 1), d * mult, np.float16).view(np.uint8)

    set_scales(1.0)
    probe = min(len(raw), 4096)
    unit = float(dt.decode(raw[:probe].reshape(-1), getattr(dt.DataType, kind), probe * elems).std())
    set_scales(std / unit)
    return raw.reshape(-1)


def synthetic_tokenizer(vocab_size: int, seed: int, byte_level: bool = True,
                        specials: tuple = TOKENIZER_SPECIALS) -> dict:
    """A tokenizer.json of `vocab_size` entries with merges, made from a seed:
    byte-level BPE over the GPT-2 byte alphabet with Qwen2's split pattern
    (byte_level=True, needs `regex`), or SentencePiece BPE with byte fallback
    (the llama kind). Merges join two earlier tokens drawn at random from the
    first 4096; the last ids are `specials`, in order."""
    from mllm_tpu_torch.tokenizers.base import BYTE_TO_UNICODE
    from mllm_tpu_torch.tokenizers.bpe import QWEN2_PATTERN

    rng = np.random.default_rng(seed)
    if byte_level:
        base = [BYTE_TO_UNICODE[b] for b in range(256)]
        first = base
    else:
        base = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
        first = ["▁"] + [chr(c) for c in range(ord("a"), ord("z") + 1)] + [chr(c) for c in range(ord("A"), ord("Z") + 1)]
        base = base + first
    toks, merges = list(base), []
    vocab = {t: i for i, t in enumerate(toks)}
    n_plain = vocab_size - len(specials)
    pool = list(first)
    while len(toks) < n_plain:
        for a, b in rng.integers(0, 4096, (4096, 2)):
            a, b = pool[a % len(pool)], pool[b % len(pool)]
            if a + b in vocab or len(toks) >= n_plain:
                continue
            vocab[a + b] = len(toks)
            toks.append(a + b)
            merges.append(f"{a} {b}")
            if len(pool) < 4096:
                pool.append(a + b)
    added = [{"id": n_plain + i, "content": t, "special": True} for i, t in enumerate(specials)]
    model = {"type": "BPE", "vocab": vocab, "merges": merges, "byte_fallback": not byte_level}
    if byte_level:
        pre = {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_PATTERN}, "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False, "use_regex": False}]}
        return {"version": "1.0", "added_tokens": added, "pre_tokenizer": pre, "model": model,
                "decoder": {"type": "ByteLevel"}}
    return {"version": "1.0", "added_tokens": added, "pre_tokenizer": None, "model": model}


def qwen2_layout(cfg, untied: bool = False) -> dict:
    """HF name -> (shape, init, projection) of a random qwen2-type checkpoint
    of `cfg`, in the order the builders draw them. init: "embed" for the
    embedding (normal, each builder's std), "ones" for the norms, else the fan-in k of a
    Linear's U(-1/sqrt(k), 1/sqrt(k)) (projections, their q/k/v biases and,
    with untied=True, the lm_head). projection: the key of a layer's weight
    ("self_attn.q_proj", ...), else None."""
    d, ff, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    q, kv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
    shapes = {"self_attn.q_proj": (q, d), "self_attn.k_proj": (kv, d), "self_attn.v_proj": (kv, d),
              "self_attn.o_proj": (d, q), "mlp.gate_proj": (ff, d), "mlp.up_proj": (ff, d),
              "mlp.down_proj": (d, ff)}
    out = {"model.embed_tokens.weight": ((cfg.vocab_size, d), "embed", None),
           "model.norm.weight": ((d,), "ones", None)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        for proj, (n, k) in shapes.items():
            out[p + proj + ".weight"] = ((n, k), k, proj)
            if proj in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"):
                out[p + proj + ".bias"] = ((n,), k, None)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out[p + norm + ".weight"] = ((d,), "ones", None)
    if untied:
        out["lm_head.weight"] = ((cfg.vocab_size, d), d, None)
    return out


def container_tensors(cfg, seed: int, kinds: dict = CONTAINER_KINDS, overrides: dict = None) -> dict:
    """HF name -> (ggml kind, shape, array) of a random qwen2-type checkpoint
    of `cfg` (`qwen2_layout`, tied): the projections as ggml blocks (kinds by
    projection, overrides by full name), each at the std of its uniform
    (1/sqrt(3k)); f16 embedding N(0, 0.02); f32 norms and qkv biases."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, init, proj) in qwen2_layout(cfg).items():
        if init == "embed":
            out[name] = ("F16", shape, (rng.standard_normal(shape, np.float32) * 0.02).astype(np.float16))
        elif init == "ones":
            out[name] = ("F32", shape, np.ones(shape, np.float32))
        elif proj is None:  # a bias
            s = 1.0 / np.sqrt(init)
            out[name] = ("F32", shape, rng.uniform(-s, s, shape).astype(np.float32))
        else:
            kind = (overrides or {}).get(name, kinds[proj])
            out[name] = (kind, shape, random_blocks(kind, *shape, 1.0 / np.sqrt(3.0 * init), rng))
    return out


def hf_config(cfg) -> dict:
    """The config.json of a qwen2-type `cfg` (tied embeddings)."""
    return {"model_type": "qwen2", "architectures": ["Qwen2ForCausalLM"], "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_hidden_layers, "num_attention_heads": cfg.num_attention_heads,
            "num_key_value_heads": cfg.num_key_value_heads, "max_position_embeddings": cfg.max_position_embeddings,
            "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta, "tie_word_embeddings": True,
            "bos_token_id": cfg.bos_token_id, "eos_token_id": cfg.eos_token_id, "hidden_act": "silu"}


def write_mllm_model(path: str, cfg, tensors: dict, tokenizer: dict) -> None:
    """A model directory: config.json, model.mllm (MllmWriter) and tokenizer.json."""
    import os

    from mllm_tpu_torch.core.dtypes import DataType
    from mllm_tpu_torch.core.param_loader import MllmWriter

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(tokenizer, f, ensure_ascii=False)
    w = MllmWriter(os.path.join(path, "model.mllm"))
    for name, (kind, _, arr) in tensors.items():
        w.add(name, arr, getattr(DataType, kind))
    w.write()


def write_gguf_model(path: str, cfg, tensors: dict, tokenizer: dict) -> None:
    """The same tensors as a GGUF file (llama.cpp names, arch qwen2), the
    tokenizer's tokens and merges in its metadata."""
    from mllm_tpu_torch.core import gguf

    arch = "qwen2"
    w = gguf.GGUFWriter(path, arch)
    for key, vt, v in (("embedding_length", gguf._T_U32, cfg.hidden_size),
                       ("block_count", gguf._T_U32, cfg.num_hidden_layers),
                       ("feed_forward_length", gguf._T_U32, cfg.intermediate_size),
                       ("attention.head_count", gguf._T_U32, cfg.num_attention_heads),
                       ("attention.head_count_kv", gguf._T_U32, cfg.num_key_value_heads),
                       ("context_length", gguf._T_U32, cfg.max_position_embeddings),
                       ("attention.layer_norm_rms_epsilon", gguf._T_F32, cfg.rms_norm_eps),
                       ("rope.freq_base", gguf._T_F32, cfg.rope_theta)):
        w.add_kv(f"{arch}.{key}", vt, v)
    model = tokenizer["model"]
    toks = [""] * (max(model["vocab"].values()) + 1 + len(tokenizer["added_tokens"]))
    for t, i in model["vocab"].items():
        toks[i] = t
    for a in tokenizer["added_tokens"]:
        toks[a["id"]] = a["content"]
    w.add_kv("tokenizer.ggml.model", gguf._T_STR, "llama" if model["byte_fallback"] else "gpt2")
    w.add_kv("tokenizer.ggml.tokens", gguf._T_ARR, (gguf._T_STR, toks))
    w.add_kv("tokenizer.ggml.merges", gguf._T_ARR, (gguf._T_STR, model["merges"]))
    w.add_kv("tokenizer.ggml.bos_token_id", gguf._T_I32, cfg.bos_token_id)
    w.add_kv("tokenizer.ggml.eos_token_id", gguf._T_I32, cfg.eos_token_id)
    for name, (kind, shape, arr) in tensors.items():
        w.add_tensor(gguf._map_name(name), np.ascontiguousarray(arr).tobytes(), shape, GGML_TYPES[kind])
    w.write()


def law_counts():
    """Count int4_matmul's kernel launches by law (symmetric: no zeros;
    affine: zeros) around Int4Linear.forward, from the wrapper's own
    counter. Returns (counts, restore)."""
    from mllm_tpu_torch.nn.layers import Int4Linear
    from mllm_tpu_torch.ops import quant_matmul as qm

    plain = Int4Linear.forward
    counts = {"symmetric": 0, "affine": 0}

    def counted(self, x):
        before = qm.int4_matmul.launches
        y = plain(self, x)
        counts["affine" if self.zeros_t is not None else "symmetric"] += qm.int4_matmul.launches - before
        return y

    Int4Linear.forward = counted
    return counts, lambda: setattr(Int4Linear, "forward", plain)


CONTAINER_PROMPTS = ("The quick brown fox jumps over the lazy dog; 1234 + 5678 = 6912.",
                     "多语言的模型服务：你好，世界！東京の天気は晴れです。")


def phase_slice_containers(dev):
    """The served checkpoint, written and loaded back: at the full Qwen2-VL-2B
    LM geometry, ggml blocks made straight from seeded random bytes (Q4_0
    q/k/v/o, Q4_K gate/up, Q8_0 down; f16 tied embedding, f32 norms and
    biases) go into a `.mllm` model directory (config.json, model.mllm,
    a synthetic tokenizer.json of 151936 entries) and into a GGUF file with
    the same tokenizer; `auto_model` and `load_gguf_model` load them on the
    card. Checks: the two loads' prefill logits of one 100-token prompt
    bit-equal; layer 0's repacked projections against x @ decode(blocks).T
    (Q4_0, Q4_K within QUANT_TOL; Q8_0, requantized to a scale a row, within
    the requantization's own bound, and its int8 operands' plain product
    within QUANT_TOL); the last greedy step within RAGGED_TOL x max |logit|
    of a fresh prefill; decode(encode(text)) == text on an ASCII and a CJK
    prompt with both tokenizers; exact launch counts, int4_matmul of both
    laws and int8_matmul. Returns (launches, model, tokenizer, directory)."""
    import os
    import shutil

    from mllm_tpu_torch.core import dtypes as dt
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.core.gguf import load_gguf_model
    from mllm_tpu_torch.generation.generate import generate, pad_to_bucket, prefill
    from mllm_tpu_torch.generation.sampling import SamplingConfig
    from mllm_tpu_torch.models.registry import auto_model
    from mllm_tpu_torch.ops import quant_matmul as qm

    try:
        import regex  # noqa: F401
        byte_level = True
    except ImportError:
        byte_level = False
    emit(phase="slice_containers_regex", regex_present=byte_level,
         tokenizer="byte-level BPE" if byte_level else "SentencePiece BPE (regex is absent)")
    cfg = TextConfig(**QWEN2VL_2B_LM)
    L = cfg.num_hidden_layers
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_containers")
    shutil.rmtree(root, ignore_errors=True)
    mdir, gpath = os.path.join(root, "qwen2-mllm"), os.path.join(root, "qwen2.gguf")
    t0 = time.perf_counter()
    tensors = container_tensors(cfg, seed=11)
    tok_spec = synthetic_tokenizer(cfg.vocab_size, seed=11, byte_level=byte_level)
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_mllm_model(mdir, cfg, tensors, tok_spec)
    mllm_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_gguf_model(gpath, cfg, tensors, tok_spec)
    gguf_write_s = time.perf_counter() - t0
    file_bytes = {"mllm": os.path.getsize(os.path.join(mdir, "model.mllm")), "gguf": os.path.getsize(gpath)}

    def timed_load(fn):
        repack = {"s": 0.0}
        plain = (qm.repack_q4_0, qm.repack_q4_k, qm.repack_q8_0)

        def clocked(f):
            def run(*a):
                t = time.perf_counter()
                out = f(*a)
                repack["s"] += time.perf_counter() - t
                return out
            return run

        qm.repack_q4_0, qm.repack_q4_k, qm.repack_q8_0 = map(clocked, plain)
        try:
            out, s = timed(fn)
        finally:
            qm.repack_q4_0, qm.repack_q4_k, qm.repack_q8_0 = plain
        return out, s, repack["s"]

    (model, tok, _), mllm_load_s, mllm_repack_s = timed_load(lambda: auto_model(mdir, device=dev))
    (gmodel, gtok, gcfg), gguf_load_s, gguf_repack_s = timed_load(lambda: load_gguf_model(gpath, device=dev))
    layers = sorted({type(m).__name__ for m in model.modules()})
    emit(phase="slice_containers_load", make_s=make_s, mllm_write_s=mllm_write_s, gguf_write_s=gguf_write_s,
         file_bytes=file_bytes, mllm_load_s=mllm_load_s, mllm_repack_s=mllm_repack_s, gguf_load_s=gguf_load_s,
         gguf_repack_s=gguf_repack_s, weight_bytes=state_bytes(model), gguf_weight_bytes=state_bytes(gmodel),
         layers=layers, gguf_config_diff={k: [v, getattr(model.cfg, k)] for k, v in vars(gcfg).items()
                                          if v != getattr(model.cfg, k)})

    # the two loads: bit-equal prefill logits of one 100-token prompt
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 100)
    ids = torch.as_tensor(pad_to_bucket(prompt[None]), device=dev)
    lg_m, _ = prefill(model, model.init_cache(1, S_CACHE), ids, 100)
    lg_g, _ = prefill(gmodel, gmodel.init_cache(1, S_CACHE), ids, 100)
    bit_equal = torch.equal(lg_m, lg_g)

    # layer 0's repacked projections against the plain dequant of their blocks
    g = torch.Generator(device=dev).manual_seed(5)
    blk = model.blocks[0]
    proj_rows = []
    for name, lin in (("self_attn.q_proj", blk.attn.q_proj), ("mlp.gate_proj", blk.mlp.gate_proj),
                      ("mlp.down_proj", blk.mlp.down_proj)):
        kind, (n, k), raw = tensors[f"model.layers.0.{name}.weight"]
        w = torch.from_numpy(dt.decode(raw, getattr(dt.DataType, kind), n * k).reshape(n, k)).to(dev)
        for m in (1, 8):
            x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
            plain = x.float() @ w.t()
            if kind == "Q8_0":
                y = qm.int8_matmul(x, lin.qweight_t, lin.scales)
                operands = qm.int8_matmul_ref(x, lin.qweight_t, lin.scales)
                # requantized to one scale a row: each weight moves by at most half its row's step
                req_bound = (0.5 * lin.scales[None, :] * x.float().abs().sum(-1, keepdim=True))
                row = dict(vs_operands=((y - operands).abs().max() / operands.abs().max()).item(),
                           within_requant_bound=bool(((y - plain).abs() <= req_bound * 1.001
                                                      + QUANT_TOL["int8_matmul"] * plain.abs().max()).all()))
            else:
                y = qm.int4_matmul(x, lin.packed_t, lin.scales_t, lin.group, lin.zeros_t)
                row = {}
            rel = ((y - plain).abs().max() / plain.abs().max()).item()
            proj_rows.append(dict(projection=name, kind=kind, m=m, vs_blocks=rel, **row))
    ok_proj = all((r["vs_blocks"] <= QUANT_TOL["int4_matmul"]) if r["kind"] != "Q8_0" else
                  (r["vs_operands"] <= QUANT_TOL["int8_matmul"] and r["within_requant_bound"])
                  for r in proj_rows)

    # the main path on the .mllm load: a greedy generate, launches counted by law
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    laws, restore_laws = law_counts()
    spy, restore = logits_spy(model, dev)
    res, _ = generate(model, prompt, model.init_cache(1, S_CACHE), SamplingConfig(max_new_tokens=24))
    gap = last_step_vs_prefill(model, dev, prompt, res.tokens, spy["last"][:, -1])
    torch.cuda.synchronize()
    restore()
    restore_laws()
    finite = bool(spy["finite"])
    prefills, steps = 2, len(res.tokens) - 1  # the generate's prefill and the fresh one
    launches = {k: fn.launches for k, fn in kernels.items()}
    expected = {"flash_attention": L * prefills, "decode_attention": L * steps,
                "int8_matmul": L * (prefills + steps), "int4_matmul": 6 * L * steps}
    expected_laws = {"symmetric": 4 * L * steps, "affine": 2 * L * steps}
    round_trip = {which: [t.decode(t.encode(s)) == s for s in CONTAINER_PROMPTS]
                  for which, t in (("mllm", tok), ("gguf", gtok))}
    emit(phase="slice_containers", prefill_logits_bit_equal=bit_equal, projections=proj_rows,
         tolerance=QUANT_TOL["int4_matmul"], last_decode_vs_prefill=gap, ragged_tol=RAGGED_TOL,
         logits_finite=finite, tokens_in_vocab=all(0 <= t < cfg.vocab_size for t in res.tokens),
         tokenizer_round_trip=round_trip, prompt_tokens=[len(tok.encode(s)) for s in CONTAINER_PROMPTS],
         launches=launches, launches_expected=expected, int4_laws=laws, int4_laws_expected=expected_laws)
    if not bit_equal:
        raise AssertionError("slice_containers: .mllm and GGUF loads give different prefill logits")
    if not ok_proj:
        raise AssertionError(f"slice_containers: a repacked projection differs from its blocks: {proj_rows}")
    if not (finite and gap <= RAGGED_TOL):
        raise AssertionError(f"slice_containers: finite {finite}, decode vs prefill {gap}")
    if not all(all(v) for v in round_trip.values()):
        raise AssertionError(f"slice_containers: tokenizer round trip failed: {round_trip}")
    if any(launches[k] != v for k, v in expected.items()) or laws != expected_laws:
        raise AssertionError(f"slice_containers: launches {launches} {laws}, expected {expected} {expected_laws}")
    del gmodel
    torch.cuda.empty_cache()
    return expected, model, tok, root


A8_ROWS = [(17, 1536, 2048), (1536, 1536, 8960), (1536, 8960, 1536)]
INT8_OP_PER_S = 1979e12  # H100 SXM, dense int8 tensor cores


def a8_bound(m: int, k: int, n: int) -> dict:
    """int8_matmul_a8's least time: x (bf16) and the int8 weight read once,
    the f32 output written once, against the HBM rate; the s8 x s8 product's
    operations against the int8 tensor-core rate."""
    nbytes, ops = 2 * m * k + k * n + 4 * (m * n + n), 2 * m * k * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OP_PER_S
    return dict(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


A8_OWN_TOL = 1e-6  # the A8 product against its own int8 operands: f32 rounding of acc and two products
A8_LENS = (17, 40, 64, 90, 128, 150, 180, 200)  # the JAX bench row's ragged batch of 8


def phase_slice_int8a8(dev) -> dict:
    """W8A8: int8_matmul_a8 (torch._int_mm on the card) at A8_ROWS within
    QUANT_TOL of the product of x quantized in f64 apart from the port (amax
    / 127, round half to even, clip; that int8 x within 1 of the port's),
    within A8_OWN_TOL of the exact product of its own int8 operands, and
    a8_quantize on the card bit-equal to its CPU result; timed beside torch.mm on the bf16 weight (a yardstick),
    the weight-only int8_matmul kernel and _int_mm alone on both weight
    layouts; then the
    bf16 model through quantize_model("int8-a8", on_device=True): a
    1500-token prefill's ms against the same prefill on its int8 twin (the
    same int8 weights as QuantLinear), logits within RAGGED_TOL x max
    |logit|; ragged_batched_generate at b=8 (A8_LENS): tokens in vocabulary,
    A8 on the prefill's 4L projections only, every decode step int8_matmul."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.generation.generate import pad_to_bucket, prefill, ragged_batched_generate
    from mllm_tpu_torch.generation.sampling import SamplingConfig
    from mllm_tpu_torch.nn.layers import QuantLinear, QuantLinearA8
    from mllm_tpu_torch.ops import quant_matmul as qm
    from mllm_tpu_torch.ops.quantize_model import _q8_device, fuse_projections, quantize_model

    g = torch.Generator(device=dev).manual_seed(8)
    rows = []
    for m, k, n in A8_ROWS:
        x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
        w = ((torch.rand(n, k, device=dev, generator=g) * 2 - 1) / k ** 0.5).to(torch.bfloat16)
        qv, sc = _q8_device(w)
        nk = qv.t().contiguous()
        y = qm.int8_matmul_a8(x, nk, sc)
        xq, xs = qm.a8_quantize(x, k)
        xq_cpu, xs_cpu = qm.a8_quantize(x.cpu(), k)
        mismatches = int((xq.cpu() != xq_cpu).sum()) + int((xs.cpu() != xs_cpu).sum())
        x64 = x.double()  # x quantized apart from the port: f64 amax / 127, round half to even, clip
        s64 = x64.abs().amax(-1, keepdim=True) / 127
        s64 = torch.where(s64 > 0, s64, torch.ones_like(s64))
        q64 = torch.round(x64 / s64).clamp(-127, 127)
        plain = (q64 @ qv.double()) * s64 * sc.double()[None, :]
        rel = ((y.double() - plain).abs().max() / plain.abs().max()).item()
        own = (xq.double() @ qv.double()) * xs.double() * sc.double()[None, :]  # the port's own operands
        own_rel = ((y.double() - own).abs().max() / own.abs().max()).item()
        xq_pad = torch.cat([xq, xq.new_zeros(max(0, qm.A8_MIN_ROWS - m), k)])
        rows.append(dict(m=m, k=k, n=n, rel_err=rel, own_operands_rel_err=own_rel,
                         quantize_vs_cpu_mismatches=mismatches,
                         xq_vs_f64_max=(xq.double() - q64).abs().max().item(),
                         ms=time_ms(lambda: qm.int8_matmul_a8(x, nk, sc), 20),
                         int_mm_nk_ms=time_ms(lambda: torch._int_mm(xq_pad, nk.t()), 20),
                         int_mm_kn_ms=time_ms(lambda: torch._int_mm(xq_pad, qv), 20),
                         int8_matmul_ms=time_ms(lambda: qm.int8_matmul(x, qv, sc), 20),
                         bf16_mm_ms=time_ms(lambda: torch.mm(x, w.t()), 20),
                         **a8_bound(m, k, n)))
    emit(phase="slice_int8a8_products", rows=rows, tolerance=QUANT_TOL["int8_matmul"],
         note="rel_err: against the product of x quantized in f64 apart from the port (xq_vs_f64_max: "
              "its largest difference from the port's int8 x, at most 1 where a quotient lies at a "
              "rounding boundary); own_operands_rel_err: against the exact product of the port's int8 x "
              "and scales, within A8_OWN_TOL (f32 rounding); "
              "quantize_vs_cpu_mismatches: a8_quantize's int8 x and scales on the card against its CPU "
              "result, element by element; ms: int8_matmul_a8 (quantizing x included); int_mm_nk_ms / "
              "int_mm_kn_ms: torch._int_mm alone on the [N, K] copy / the [K, N] weight; bf16_mm_ms: "
              "torch.mm on the weight in bf16, another function")
    if not all(r["rel_err"] <= QUANT_TOL["int8_matmul"] and r["own_operands_rel_err"] <= A8_OWN_TOL
               and r["xq_vs_f64_max"] <= 1 and r["quantize_vs_cpu_mismatches"] == 0 for r in rows):
        raise AssertionError(f"slice_int8a8: A8 product differs from the exact product: {rows}")

    cfg = TextConfig(**QWEN2VL_2B_LM)
    L = cfg.num_hidden_layers
    model = init_model(cfg, dev)
    t0 = time.perf_counter()
    quantize_model(fuse_projections(model), "int8-a8", on_device=True)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    twin_layers = {}
    for path, mod in model.named_modules():
        if isinstance(mod, QuantLinearA8):
            twin_layers[path] = mod
    layers = sorted({type(m).__name__ for m in model.modules()})

    def swap(to_a8: bool):
        for path, a8 in twin_layers.items():
            parent, _, name = path.rpartition(".")
            setattr(model.get_submodule(parent), name,
                    a8 if to_a8 else QuantLinear(a8.qweight_t, a8.scales, a8.bias))

    rng = np.random.default_rng(15)
    prompt = rng.integers(0, cfg.vocab_size, (1, 1500))
    ids = torch.as_tensor(pad_to_bucket(prompt), device=dev)

    def prefill_ms():
        times, lg = [], None
        for _ in range(4):
            (lg, _), s = timed(lambda: prefill(model, model.init_cache(1, S_CACHE), ids, 1500))
            times.append(s * 1e3)
        return float(np.median(times[1:])), lg

    a8_calls = {"n": 0}
    plain_a8 = qm.int8_matmul_a8

    def counted_a8(*a):
        a8_calls["n"] += 1
        return plain_a8(*a)

    swap(False)
    int8_ms, lg_int8 = prefill_ms()
    swap(True)
    a8_ms, lg_a8 = prefill_ms()
    vs_int8 = ((lg_a8.float() - lg_int8.float()).abs().max() / lg_int8.float().abs().max()).item()

    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    qm.int8_matmul_a8 = counted_a8
    try:
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in A8_LENS]
        (toks, _, _), ragged_s = timed(lambda: ragged_batched_generate(model, prompts, model.init_cache(8, S_CACHE),
                                                                      SamplingConfig(max_new_tokens=32)))
    finally:
        qm.int8_matmul_a8 = plain_a8
    steps = toks.shape[1] - 1
    launches = {k: fn.launches for k, fn in kernels.items()}
    expected = {"int8_matmul": (4 * L + 1) * steps + 1, "flash_attention": L, "decode_attention": L * steps}
    emit(phase="slice_int8a8", quantize_s=quant_s, weight_bytes=state_bytes(model),
         nk_copy_bytes=sum(m.qweight_nk.numel() for m in twin_layers.values()),
         layers=layers,
         prefill_ms_1500_a8=a8_ms, prefill_ms_1500_int8=int8_ms, a8_over_int8=a8_ms / int8_ms,
         logits_vs_int8=vs_int8, tolerance=RAGGED_TOL, ragged_lens=list(A8_LENS), ragged_new=int(toks.shape[1]),
         ragged_s=ragged_s, a8_calls=a8_calls["n"], a8_calls_expected=4 * L, launches=launches,
         launches_expected=expected)
    if "QuantLinearA8" not in layers or "Linear" in layers:
        raise AssertionError(f"slice_int8a8: quantize_model left {layers}")
    if not vs_int8 <= RAGGED_TOL:
        raise AssertionError(f"slice_int8a8: A8 prefill logits {vs_int8} x max |logit| from the int8 model's")
    if not ((0 <= toks) & (toks < cfg.vocab_size)).all() or toks.shape != (8, 32):
        raise AssertionError(f"slice_int8a8: ragged tokens {toks.shape} or out of the vocabulary")
    if a8_calls["n"] != 4 * L or any(launches[k] != v for k, v in expected.items()):
        raise AssertionError(f"slice_int8a8: A8 calls {a8_calls['n']} (expected {4 * L}), launches {launches}, "
                             f"expected {expected}")
    del model, twin_layers
    torch.cuda.empty_cache()
    return expected


SERVE_LENS = (17, 40, 64, 100, 150, 200, 256, 300)  # prompt tokens of the 8 completions
SERVE_NEW = 48


def prompt_texts(tok, lens, seed: int) -> list:
    """Texts of random lowercase words that encode (bos included) to at
    least each of `lens` tokens, stopping at the first word that gets there."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    out = []
    for n in lens:
        text = ""
        while len(tok.encode(text, bos=True)) < n:
            text += (" " if text else "") + "".join(rng.choice(letters, rng.integers(2, 9)))
        out.append(text)
    return out


def start_server(frontend):
    """A ThreadingHTTPServer on 127.0.0.1, port 0, over `frontend`, serving
    on a thread. Returns (server, port)."""
    import threading
    from http.server import ThreadingHTTPServer

    from mllm_tpu_torch.serve import make_handler

    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(frontend))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def http(port: int, path: str, body=None, timeout: float = 300.0):
    """(status, body bytes) of a GET (body None) or a JSON POST to the server."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def sse_text(raw: bytes) -> str:
    """The text of an SSE completion stream, its chunks reassembled."""
    text = ""
    for line in raw.decode().split("\n"):
        if line.startswith("data: ") and line != "data: [DONE]":
            text += json.loads(line[len("data: "):])["choices"][0]["text"]
    return text


def recording(frontend) -> list:
    """Wrap frontend.submit so that each finished request's (prompt ids,
    tokens) is kept, in the order they finish. Returns that list."""
    import queue
    import threading

    records, plain = [], frontend.submit

    def submit(ids, max_tokens, sampling=None):
        done, relay = plain(ids, max_tokens, sampling=sampling), queue.Queue()

        def keep():
            out = done.get()
            records.append((np.asarray(ids), out))
            relay.put(out)

        threading.Thread(target=keep, daemon=True).start()
        return relay

    frontend.submit = submit
    return records


def phase_slice_serve(dev, model, tok) -> dict:
    """The port's server (`mllm_tpu_torch.serve`) in a thread on 127.0.0.1,
    port 0, over the `.mllm` model of slice_containers: --engine continuous
    (8 slots, int8 KV cache, decode windows of 32 as graphs, pipelined on the
    engine's loop thread) takes, concurrently through urllib, 8 completions
    of 17-300 prompt tokens x 48 new, 2 chat completions and 1 streamed
    completion (reassembled, equal to the same request's non-streamed text);
    then /metrics (mllm_requests_total equals the requests, a TTFT count as
    large) and /healthz. The greedy completions' tokens, kept by the frontend
    in process, lie within RAGGED_TOL x max |logit| of a teacher-forced
    prefill over an int8 cache. Then 2 requests through --engine window and 2
    through --engine sd, each checked the same way over a bf16 cache."""
    from concurrent.futures import ThreadPoolExecutor

    from mllm_tpu_torch.generation import graphs
    from mllm_tpu_torch.serve import ContinuousFrontend, make_frontend
    from mllm_tpu_torch.utils.metrics import Metrics

    cfg, L = model.cfg, model.cfg.num_hidden_layers
    texts = prompt_texts(tok, SERVE_LENS, seed=21)
    completions = [{"prompt": t, "max_tokens": SERVE_NEW} for t in texts]
    chats = [{"messages": [{"role": "system", "content": "Answer briefly."}, {"role": "user", "content": t}],
              "max_tokens": SERVE_NEW} for t in texts[1:3]]
    stream = {**completions[0], "stream": True}

    def post(body):
        path = "/v1/chat/completions" if "messages" in body else "/v1/completions"
        return http(port, path, body)

    kernels = wrappers()
    metrics = Metrics()
    fe = ContinuousFrontend(model, tok, cfg, max_len=S_CACHE, max_batch=8, kv_dtype="int8", metrics=metrics)
    records = recording(fe)
    srv, port = start_server(fe)
    for fn in kernels.values():
        fn.launches = 0
    graphs.reset_counts()
    laws, restore_laws = law_counts()
    try:
        bodies = completions + chats + [stream]
        with ThreadPoolExecutor(len(bodies)) as pool:
            replies, wall = timed(lambda: list(pool.map(post, bodies)))
        _, scrape = http(port, "/metrics")
        health = http(port, "/healthz")
    finally:
        restore_laws()
        fe.stop()
        srv.shutdown()
        srv.server_close()
    launches = graphs.device_launches({k: fn.launches for k, fn in kernels.items()})
    scrape = scrape.decode()
    answers = [json.loads(r[1]) for r in replies[:-1]]
    streamed = sse_text(replies[-1][1])
    new_tokens = [a["usage"]["completion_tokens"] for a in answers]
    gap = max(teacher_forced_gap(model, dev, ids, out, "int8") for ids, out in records)
    ttft = list(metrics._hists["mllm_ttft_seconds"])
    capture_s = sum(g.capture_s for g in fe.engine._windows.values())
    n_req = len(bodies)
    want_metrics = (f"mllm_requests_total {float(n_req)}", f"mllm_ttft_seconds_count {n_req}")
    emit(phase="slice_serve", engine="continuous", kv_dtype="int8", requests=n_req,
         prompt_tokens=[a["usage"]["prompt_tokens"] for a in answers], new_tokens=new_tokens, wall_s=wall,
         tok_s=sum(new_tokens + [SERVE_NEW]) / wall, capture_s=capture_s,
         tok_s_less_capture=sum(new_tokens + [SERVE_NEW]) / (wall - capture_s),
         ttft_ms=sorted(t * 1e3 for t in ttft), windows=fe.engine.steps, admissions=fe.engine.admissions,
         stream_equals_plain=streamed == answers[0]["choices"][0]["text"], statuses=[r[0] for r in replies],
         metrics_lines=[w in scrape for w in want_metrics], healthz=[health[0], health[1].decode()],
         teacher_forced_gap_over_max_logit=gap,
         tolerance=RAGGED_TOL, launches=launches, int4_laws_counted=laws,
         launch_note="launches on the card (graphs.device_launches); int4_laws_counted are the wrapper's "
                     "counts, captures counted once")
    if any(r[0] != 200 for r in replies) or new_tokens != [SERVE_NEW] * len(answers):
        raise AssertionError(f"slice_serve: statuses {[r[0] for r in replies]}, new tokens {new_tokens}")
    if streamed != answers[0]["choices"][0]["text"]:
        raise AssertionError("slice_serve: the streamed text differs from the same request's plain text")
    if not all(w in scrape for w in want_metrics) or health != (200, b"ok"):
        raise AssertionError(f"slice_serve: /metrics {scrape!r} or /healthz {health}")
    if len(records) != len(answers) or not gap <= RAGGED_TOL:
        raise AssertionError(f"slice_serve: {len(records)} records, teacher-forced gap {gap}")
    if not (launches["flash_attention_quant"] and launches["decode_attention_quant"] and launches["int8_matmul"]
            and laws["symmetric"] and laws["affine"]) or launches["flash_attention"] or launches["decode_attention"]:
        raise AssertionError(f"slice_serve: launches {launches} {laws}")
    out = {k: launches[k] for k in ("flash_attention_quant", "decode_attention_quant", "int8_matmul", "int4_matmul")}

    for kind in ("window", "sd"):
        for fn in kernels.values():
            fn.launches = 0
        fe = make_frontend(kind, model, tok, cfg, max_len=S_CACHE, metrics=Metrics())
        records = recording(fe)
        srv, port = start_server(fe)
        try:
            with ThreadPoolExecutor(2) as pool:
                replies, wall = timed(lambda: list(pool.map(post, completions[:2])))
        finally:
            srv.shutdown()
            srv.server_close()
        counted = {k: fn.launches for k, fn in kernels.items()}
        answers = [json.loads(r[1]) for r in replies]
        new_tokens = [a["usage"]["completion_tokens"] for a in answers]
        gap = max(teacher_forced_gap(model, dev, ids, o) for ids, o in records)
        emit(phase="slice_serve", engine=kind, requests=2, new_tokens=new_tokens, wall_s=wall,
             tok_s=sum(new_tokens) / wall, teacher_forced_gap_over_max_logit=gap, tolerance=RAGGED_TOL,
             sd_acceptance=fe.metrics.snapshot()["gauges"].get("mllm_sd_acceptance"), launches=counted)
        if (new_tokens != [SERVE_NEW] * 2 or not gap <= RAGGED_TOL
                or not (counted["flash_attention"] and (kind == "sd" or counted["decode_attention"]))):
            raise AssertionError(f"slice_serve {kind}: new tokens {new_tokens}, gap {gap}, launches {counted}")
        add_launches(out, {k: counted[k] for k in ("flash_attention", "decode_attention", "int8_matmul",
                                                   "int4_matmul")})
    return out


# ---------------------------------------------------------------------------
# head_dim 256: the bf16 flash and decode kernels at Gemma-2B's attention
# (8 query heads, 1 KV head, head_dim 256), and the paged body at 256
# ---------------------------------------------------------------------------

WIDE_GEO = (8, 1, 256)
FLASH_ROWS_256 = [
    (1, 1536, 0, 1536, None, None, False),                                # a 1500-token prompt's bucket
    (1, 128, 1408, 1536, None, None, False),                              # a 128-row chunk over 1536 keys
    (8, 128, 0, [128, 17, 100, 64, 128, 90, 33, 120], None, None, False),  # B=8, per-sequence lengths
    (4, 256, 0, [256, 200, 131, 250], [0, 17, 64, 150], None, True),     # kv_start, stale NaN / inf rows
    (1, 300, 0, 300, None, 64, False),                                    # sliding window
    (1, 512, 1024, 1536, None, None, False),                              # a 512-row chunk at 1024
    (1, 128, 0, 128, None, None, False),                                  # a 128-row prompt
]
DECODE_ROWS_256 = [
    (1, [1531], None, None, False),                                       # a 1500-token prompt's last step
    (8, [1, 511, 513, 2048, 100, 1000, 1531, 777], [0, 0, 5, 100, 0, 50, 0, 3], None, False),
    (4, [1, 511, 513, 2048], [0, 3, 7, 9], 256, False),                   # window
    (4, [0, 77, 2083, 1531], [0, 13, 100, 700], None, True),             # stale rows; a slot past the cache
]
# the quantized prefill at head_dim 256 (QUANT_FLASH_ROWS' fields, Gemma-2B's 8 / 1 heads)
QUANT_FLASH_ROWS_256 = [
    (1, 1536, 1536, 0, 1536, None, None, False, WIDE_GEO),           # a 1500-token prompt's bucket
    (8, 128, 128, 0, 128, None, None, False, WIDE_GEO),              # a batched admission (B = 8)
    (1, 128, 1536, 1408, 1536, None, None, False, WIDE_GEO),         # the last chunk of a chunked prefill
    (4, 256, 256, 0, 256, [0, 17, 64, 150], None, False, WIDE_GEO),  # a left-padded ragged batch
    (1, 512, 1536, 1024, 1536, None, 256, False, WIDE_GEO),          # a sliding window over a chunk
    # stale rows: integers and scales outside [kv_start, kv_valid) hold 127 and NaN / inf
    (4, 256, 256, 0, 200, [0, 17, 64, 150], None, True, WIDE_GEO),
]


def wide_kernel_rows(dev, g) -> dict:
    """flash_attention and decode_attention at head_dim 256 against their
    plain versions (FLASH_ROWS_256, DECODE_ROWS_256 at WIDE_GEO: causal,
    windowed, kv_start, q_offset, B = 1 and 8, poisoned rows), timed beside
    their bounds, the main rows beside SDPA; flash_attention_quant and
    decode_attention_quant at 256, int8 and int4 (QUANT_FLASH_ROWS_256,
    QUANT_DECODE_ROWS at WIDE_GEO: the same cases, stale integers and NaN /
    inf scales), each beside its bound, the bf16 kernel at 256 over the same
    keys dequantized, SDPA over them and the port's `sdpa` that served these
    calls before the kernels took 256 (`route_sdpa_ms`); then decode_attention_paged at
    256 over PAGED_ROWS' pools, checked only (no path of this smoke pages a
    head_dim 256 cache)."""
    from mllm_tpu_torch.ops.decode_attention import (decode_attention, decode_attention_paged,
                                                     decode_attention_paged_ref, decode_attention_ref)
    from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    rows = {"flash_attention@256": attention_rows("flash_attention@256", "flash_attention", flash_attention,
                                                  flash_attention_ref, FLASH_ROWS_256, dev, g, WIDE_GEO),
            "decode_attention@256": attention_rows("decode_attention@256", "decode_attention", decode_attention,
                                                   decode_attention_ref, DECODE_ROWS_256, dev, g, WIDE_GEO)}
    device_scalar_row(dev, g, WIDE_GEO, WIDE_SCALAR_ROW)
    quant_device_scalar_row(dev, g, WIDE_GEO, WIDE_SCALAR_ROW)
    rows.update(quant_attention_rows(dev, g, QUANT_FLASH_ROWS_256, QUANT_DECODE_ROWS, WIDE_GEO, "@256",
                                     route_sdpa=True))
    worst = 0.0
    for row in PAGED_ROWS:
        q, kp, vp, table, kw, shape, (kpp, vpp), _ = paged_inputs(row, dev, g, WIDE_GEO)
        out = decode_attention_paged(q, kp, vp, table, **kw)
        err = (out.float() - decode_attention_paged_ref(q, kpp, vpp, table, **kw).float()).abs().max().item()
        if not (err <= TOL and bool(torch.isfinite(out.float()).all())):
            raise AssertionError(f"decode_attention_paged D=256 {shape}: max |kernel - plain| {err} "
                                 f"(tolerance {TOL}) or not finite")
        worst = max(worst, err)
    emit(phase="kernel_check_paged_256", rows=len(PAGED_ROWS), geometry=list(WIDE_GEO), max_abs_err=worst,
         tolerance=TOL)
    return rows


# the split flash kernel at head_dim 256 with a device q_offset: a 512-row
# chunk over 1536 keys of the 2048-row cache, and the q_offsets its launches
# and replays are given (with a device q_offset the cluster size depends on
# the shapes only, each rank's run on the device value)
WIDE_SCALAR_ROW = (512, 1536, (1024, 0, 512))


def device_scalar_row(dev, g, geo, scalar_row) -> None:
    """flash_attention at `geo` with q_offset a one-element int32 tensor on
    the card, launched directly at each offset of `scalar_row` and from a
    CUDA graph replayed with the offset changed between replays: each replay
    bit-equal to the direct launch at the same value, and the direct
    launches and those with the host int within TOL of the plain version.
    At WIDE_GEO (head_dim 256) it reaches the cluster key split, each rank's
    run worked out from the device value (the host int enters
    `flash_splits`, so its cluster size may differ); at GEO64 the persistent
    grid, each CTA reading the device value for every unit (cluster size 1
    either way)."""
    from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref, flash_launch_splits

    sq, kvl, offsets = scalar_row
    h, hkv, d = geo
    q = torch.randn(1, sq, h, d, device=dev, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(1, hkv, S_CACHE, d, device=dev, generator=g).to(torch.bfloat16) for _ in range(2))
    off = torch.full((), offsets[0], dtype=torch.int32, device=dev)
    host = [flash_attention(q, k, v, q_offset=o, kv_valid_len=kvl) for o in offsets]
    direct = []
    for o in offsets:
        off.fill_(o)
        direct.append(flash_attention(q, k, v, q_offset=off, kv_valid_len=kvl))
    reps = replay_outputs(lambda: flash_attention(q, k, v, q_offset=off, kv_valid_len=kvl), [off],
                          [(o,) for o in offsets])
    same = [torch.equal(r[0], x) for r, x in zip(reps, direct)]
    err = max((x.float() - flash_attention_ref(q, k, v, q_offset=o, kv_valid_len=kvl).float()).abs().max().item()
              for xs in (host, direct) for x, o in zip(xs, offsets))
    finite = all(bool(torch.isfinite(x.float()).all()) for x in host + direct)
    idx = dev.index or 0
    emit(phase="kernel_check_device_scalars", kernel=f"flash_attention@{d}",
         shape=dict(B=1, Sq=sq, H=h, Hkv=hkv, D=d, S=S_CACHE, kv_valid=kvl, q_offsets=list(offsets)),
         splits_device=flash_launch_splits(1, sq, S_CACHE, h, d, True, None, idx, None, None),
         splits_host=[flash_launch_splits(1, sq, S_CACHE, h, d, True, None, idx, o, kvl) for o in offsets],
         replays_bit_equal=same, max_abs_err_vs_plain=err, tolerance=TOL, finite=finite)
    if not (all(same) and err <= TOL and finite):
        raise AssertionError(f"flash_attention@{d} device q_offset: replays bit-equal {same}, "
                             f"vs plain {err} (tolerance {TOL}), finite={finite}")


def quant_device_scalar_row(dev, g, geo, scalar_row, bits: int = 8) -> None:
    """flash_attention_quant at `geo` (head_dim 256) over `bits`-bit K/V with
    q_offset a one-element int32 tensor on the card, as `device_scalar_row`:
    launched directly at each offset of `scalar_row` and from a CUDA graph
    replayed with the offset changed between replays; each replay bit-equal
    to the direct launch at the same value, every launch (and those with the
    host int) within TOL of flash_attention_quant_ref, and the device
    launches at a split cluster size (`flash_quant_launch_splits` from the
    shapes alone: each rank's run worked out on the card from the value)."""
    from mllm_tpu_torch.ops.flash_attention import (flash_attention_quant, flash_attention_quant_ref,
                                                    flash_quant_launch_splits)

    sq, kvl, offsets = scalar_row
    h, hkv, d = geo
    q = torch.randn(1, sq, h, d, device=dev, generator=g).to(torch.bfloat16)
    (kq, ks, _), (vq, vs, _) = quant_kv(1, S_CACHE, bits, dev, g, hkv, d)
    ops = (kq, vq, ks, vs)
    off = torch.full((), offsets[0], dtype=torch.int32, device=dev)
    host = [flash_attention_quant(q, *ops, q_offset=o, kv_valid_len=kvl) for o in offsets]
    direct = []
    for o in offsets:
        off.fill_(o)
        direct.append(flash_attention_quant(q, *ops, q_offset=off, kv_valid_len=kvl))
    reps = replay_outputs(lambda: flash_attention_quant(q, *ops, q_offset=off, kv_valid_len=kvl), [off],
                          [(o,) for o in offsets])
    same = [torch.equal(r[0], x) for r, x in zip(reps, direct)]
    err = max((x.float() - flash_attention_quant_ref(q, *ops, q_offset=o, kv_valid_len=kvl).float())
              .abs().max().item() for xs in (host, direct) for x, o in zip(xs, offsets))
    finite = all(bool(torch.isfinite(x.float()).all()) for x in host + direct)
    idx = dev.index or 0
    split = flash_quant_launch_splits(1, sq, S_CACHE, h, d, bits, True, None, idx, None, kvl)
    emit(phase="kernel_check_device_scalars", kernel=f"flash_attention_quant@{d}",
         shape=dict(B=1, Sq=sq, H=h, Hkv=hkv, D=d, S=S_CACHE, kv_valid=kvl, bits=bits, q_offsets=list(offsets)),
         splits_device=split,
         splits_host=[flash_quant_launch_splits(1, sq, S_CACHE, h, d, bits, True, None, idx, o, kvl)
                      for o in offsets],
         replays_bit_equal=same, max_abs_err_vs_plain=err, tolerance=TOL, finite=finite)
    if not (split > 1 and all(same) and err <= TOL and finite):
        raise AssertionError(f"flash_attention_quant@{d} device q_offset: cluster size {split} (must split), "
                             f"replays bit-equal {same}, vs plain {err} (tolerance {TOL}), finite={finite}")


# head_dim 80: the Qwen2-VL vision tower's attention (non-causal, 16 / 16 heads
# of 80, one image's patches as queries and keys): (B, S, kv_valid, poisoned),
# Sq = Skv = S; images of 532 x 532, 448 x 448 and 896 x 896 px, and the 532
# image with kv_valid short of S and the K/V rows past it NaN / inf
FLASH80_GEO = (16, 16, 80)
FLASH80_ROWS = [(1, 1444, 1444, False), (1, 1024, 1024, False), (1, 4096, 4096, False),
                (1, 1444, 1300, True)]
# max |kernel - plain| / mean |plain|, each design: unit-variance q/k/v give
# outputs of typical size sqrt(e / S) (0.021 at S = 4096), so TOL (absolute)
# alone would pass a wrong kernel there; the readings are in PERF.md
FLASH80_REL_TOL = 0.25


def flash80_padded(q, k, v, **kw):
    """The other design of head_dim 80 (the reference's `attend_padded_head`):
    q/k/v zero-padded to 128 columns in memory, the D = 128 kernel, the
    output cropped to 80 columns (a copy, as the model's reshape makes)."""
    from mllm_tpu_torch.ops.flash_attention import flash_attention

    d = q.shape[-1]
    pad = lambda t: torch.nn.functional.pad(t, (0, 128 - d))  # noqa: E731
    return flash_attention(pad(q), pad(k), pad(v), scale=d**-0.5, **kw)[..., :d].contiguous()


def flash80_rows(dev, g) -> list:
    """flash_attention at head_dim 80, non-causal (FLASH80_ROWS): the kernel
    (rows of 80 columns: a 64-column and a 16-column box) and the padded
    design against the plain version (max abs error <= TOL and <=
    FLASH80_REL_TOL x mean |plain|, finite, the poisoned row's plain version on
    the rows zeroed), timed beside the padded design (`padded_ms`), SDPA at D = 80 over
    the valid keys (`library_ms`) and the bound: q and the output once, each
    valid K/V row once, 4 Sq kv_valid H 80 FLOPs."""
    from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    h, hkv, d = FLASH80_GEO
    rows = []
    for b, s, kvl, poisoned in FLASH80_ROWS:
        q = torch.randn(b, s, h, d, device=dev, generator=g).to(torch.bfloat16)
        k, v = (torch.randn(b, hkv, s, d, device=dev, generator=g).to(torch.bfloat16) for _ in range(2))
        kp, vp = k, v
        shape = dict(B=b, Sq=s, Skv=s, H=h, Hkv=hkv, D=d, kv_valid=kvl, causal=False)
        if poisoned:
            (k, kp), (v, vp) = poison_outside(k, [0] * b, [kvl] * b), poison_outside(v, [0] * b, [kvl] * b)
            shape["poisoned"] = "NaN / inf past kv_valid; plain version on the rows zeroed"
        kw = dict(kv_valid_len=kvl, causal=False)
        kernel = lambda: flash_attention(q, k, v, **kw)  # noqa: E731
        plain = lambda: flash_attention_ref(q, kp, vp, **kw)  # noqa: E731
        padded = lambda: flash80_padded(q, k, v, **kw)  # noqa: E731
        library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q.transpose(1, 2), k[:, :, :kvl], v[:, :, :kvl])
        out, ref, out_pad = kernel(), plain(), padded()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        err_pad = (out_pad.float() - ref.float()).abs().max().item()
        mean_ref = ref.float().abs().mean().item()
        rel, rel_pad = err / mean_ref, err_pad / mean_ref
        finite = bool(torch.isfinite(out.float()).all())
        if not bool(torch.isfinite(ref.float()).all()):  # ROADMAP Queue 3's open fault: keep its inputs
            import os

            os.makedirs("build", exist_ok=True)
            torch.save(dict(q=q.cpu(), k=kp.cpu(), v=vp.cpu(), kw=kw), f"build/flash80_plain_nan_{s}.pt")
        del ref, out, out_pad
        row = dict(phase="kernel_check", kernel="flash_attention@80", shape=shape, max_abs_err=err,
                   padded_max_abs_err=err_pad, mean_abs_plain=mean_ref, rel_err=rel, padded_rel_err=rel_pad,
                   rel_tolerance=FLASH80_REL_TOL, finite=finite, ms=time_ms(kernel, 20), padded_ms=time_ms(padded, 20),
                   plain_ms=time_ms(plain, 3), library_ms=time_ms(library, 20),
                   **bound(2 * b * s * h * d * 2 + kvl * hkv * d * 2 * 2, 4 * b * s * kvl * h * d))
        emit(**row)
        if not finite or not max(err, err_pad) <= TOL or not max(rel, rel_pad) <= FLASH80_REL_TOL:
            raise AssertionError(f"flash_attention@80 {shape}: max |kernel - plain| {err}, padded {err_pad} "
                                 f"(tolerance {TOL}); / mean |plain| {rel}, padded {rel_pad} (tolerance "
                                 f"{FLASH80_REL_TOL}), finite={finite}")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# MoE: the JAX bench's routed geometry and Qwen1.5-MoE-A2.7B's published width
# ---------------------------------------------------------------------------

QWEN2_MOE_08B = dict(  # bench.py QWEN2_MOE_08B (qwen2 attention, tied head)
    vocab_size=32768, hidden_size=1024, intermediate_size=512, num_hidden_layers=16,
    num_attention_heads=16, num_key_value_heads=8, max_position_embeddings=8192, eos_token_id=-2,
    num_experts=16, num_experts_per_tok=4, moe_shared_expert_size=2048)
QWEN15_MOE_A27B = dict(  # Qwen1.5-MoE-A2.7B config.json (model_type qwen2_moe)
    model_type="qwen2_moe", vocab_size=151936, hidden_size=2048, intermediate_size=1408,
    num_hidden_layers=24, num_attention_heads=16, num_key_value_heads=16, max_position_embeddings=8192,
    rope_theta=1000000.0, tie_word_embeddings=False, eos_token_id=-2, num_experts=60,
    num_experts_per_tok=4, moe_norm_topk_prob=False, moe_shared_expert_size=5632)
MOE_T = (1, 2, 4, 8, 16, 32, 128, 1024)  # tokens a call: decode batches, then prefills
MOE_BRANCH_TOL = 3e-2  # x max |y|: the ragged branch rounds products and combine to bf16, the dense keeps f32
MOE_BATCH, MOE_PROMPT, MOE_NEW = 8, 128, 128  # the qwen2moe-0.8b-*-b8 rows' traffic


def graph_ms(fn, calls: int = 10):
    """Device ms of one call of `fn` replayed from a CUDA graph of `calls`
    calls (warm-up on a side stream first); None when fn cannot be captured."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    try:
        torch.cuda.set_sync_debug_mode("error")
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * calls)


def wall_ms(fn, calls: int = 20) -> float:
    """Host wall ms of one eager call, `calls` back to back, synchronised at
    both ends (what an eager decode step pays: launches and host reads)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / calls * 1e3


def moe_layer(cfg, dev, seed: int, shared_gate: bool = False):
    """One MoEMLP of cfg with MoEMLP.init's random weights, bf16 on the card."""
    from mllm_tpu_torch.models.moe import MoEMLP
    from mllm_tpu_torch.nn.layers import Linear

    gen = torch.Generator(device=dev).manual_seed(seed)
    moe = MoEMLP(cfg, device=dev, dtype=torch.bfloat16, shared_gate=shared_gate)
    moe.reset_parameters(gen)
    for m in moe.modules():
        if isinstance(m, Linear):
            m.reset_parameters(gen)
    return moe


def moe_branch_rows(dev, name: str, cfg_kw: dict) -> list:
    """The dense and ragged branches of one layer of `cfg_kw` at t in MOE_T
    tokens, bf16 experts and int8 (QuantMoEMLP.from_moe): ms a layer as one
    call replayed from a CUDA graph (None for the int8 ragged branch, which
    reads its group sizes on the host and cannot be captured) and as host
    wall time of an eager call; the two branches within MOE_BRANCH_TOL x
    max |y| of each other on the same x. Also, at t <= 32, the int8 dense
    branch's two ways to its expert products: gate||up through one
    int8_matmul launch against the side-by-side layout (the port's) or a
    bf16 copy of the int8 stacks made in the call; down through a bf16 copy
    (the port's) or one int8_matmul launch an expert."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.models.moe import QuantMoEMLP, bmm_f32, dense_branch, route
    from mllm_tpu_torch.ops.quant_matmul import int8_matmul

    cfg = TextConfig(**cfg_kw)
    e, k, d = cfg.num_experts, cfg.num_experts_per_tok, cfg.hidden_size
    moe = moe_layer(cfg, dev, 5)
    qmoe = QuantMoEMLP.from_moe(moe)
    g = torch.Generator(device=dev).manual_seed(6)
    out = []
    for t in MOE_T:
        calls = 10 if t <= 32 else 2  # a prefill's intermediates are large: fewer calls a graph
        x = (torch.randn(t, d, device=dev, generator=g) * 0.5).to(torch.bfloat16)
        for label, m in (("bf16", moe), ("int8", qmoe)):
            top_p, top_i = route(x, m.router_weight, k, m.norm_topk_prob)
            ragged = lambda m=m, top_p=top_p, top_i=top_i: m._ragged(x, top_p, top_i)  # noqa: E731
            dense = lambda m=m, top_p=top_p, top_i=top_i: m._dense_all_experts(x, top_p, top_i)  # noqa: E731
            yr, yd = ragged().float(), dense().float()
            gap = ((yr - yd).abs().max() / yd.abs().max()).item()
            row = dict(phase="moe_branch", geometry=name, experts=e, top_k=k, hidden=d,
                       expert_ff=cfg.intermediate_size, t=t, weights=label,
                       dense_graph_ms=graph_ms(dense, calls), dense_wall_ms=wall_ms(dense, calls),
                       ragged_graph_ms=graph_ms(ragged, calls) if label == "bf16" else None,
                       ragged_wall_ms=wall_ms(ragged, calls), branches_gap_over_max=gap, tolerance=MOE_BRANCH_TOL,
                       rule_takes="dense" if dense_branch(t, e, k, d, cfg.intermediate_size, label == "int8")
                       else "ragged")
            if label == "int8" and t <= 32:
                xb = x.to(torch.bfloat16)
                ff = qmoe.w_gate.shape[-1]
                h = torch.randn(e, t, ff, device=dev, generator=g).to(torch.bfloat16)
                row.update(
                    gateup_int8_matmul_ms=graph_ms(lambda: int8_matmul(xb, qmoe.w_gateup_t, qmoe.s_gateup)),
                    gateup_bf16_copy_ms=graph_ms(lambda: bmm_f32(
                        xb[None].expand(2 * e, t, d), torch.cat([qmoe.w_gate, qmoe.w_up]).to(torch.bfloat16))),
                    down_bf16_copy_ms=graph_ms(lambda: bmm_f32(h, qmoe.w_down.to(torch.bfloat16))),
                    down_int8_matmul_per_expert_ms=graph_ms(lambda: [
                        int8_matmul(h[i], qmoe.w_down[i], qmoe.s_down[i]) for i in range(e)]))
            emit(**row)
            if not gap <= MOE_BRANCH_TOL:
                raise AssertionError(f"moe_branch {name} {label} t={t}: branches differ by {gap} x max |y|")
            out.append(row)
    del moe, qmoe
    torch.cuda.empty_cache()
    return out


def moe_expected(cfg, mode: str, forwards: list) -> dict:
    """The exact launches of the MoE model of `cfg` in `mode` ("bf16",
    "int8", "int4", after fuse_projections + quantize_model) over `forwards`,
    a list of (tokens in the call, is_prefill, rows of the head). Attention:
    one flash_attention a layer a prefill, one decode_attention a layer a
    step. int8: qkv, o and the shared expert's gate||up and down a layer,
    the head once; the experts one gate||up launch a layer on the dense
    branch, three an expert on the ragged one (every expert holds tokens at
    these lengths). int4: qkv, o and the head on the int4 kernel at <= 32
    rows, the shared expert's fused MLP at <= 32 rows, the experts as int8."""
    from mllm_tpu_torch.models.moe import dense_branch
    from mllm_tpu_torch.ops.quant_matmul import INT4_KERNEL_MAX_M

    L, e, k, d, ff = (cfg.num_hidden_layers, cfg.num_experts, cfg.num_experts_per_tok, cfg.hidden_size,
                      cfg.intermediate_size)
    n = {"flash_attention": 0, "decode_attention": 0, "int8_matmul": 0, "int4_matmul": 0, "fused_int4_mlp": 0}
    for t, is_prefill, head_rows in forwards:
        n["flash_attention" if is_prefill else "decode_attention"] += L
        if mode == "bf16":
            continue
        experts = L if dense_branch(t, e, k, d, ff, True) else 3 * e * L
        if mode == "int8":
            n["int8_matmul"] += 4 * L + 1 + experts
        else:
            n["int8_matmul"] += experts
            n["int4_matmul"] += (2 * L if t <= INT4_KERNEL_MAX_M else 0) + (head_rows <= INT4_KERNEL_MAX_M)
            n["fused_int4_mlp"] += L if t <= INT4_KERNEL_MAX_M else 0
    return n


def moe_model(cfg_kw: dict, dev, mode: str, shared_gate: bool = False):
    """CausalLM.init of cfg_kw (MoE blocks: MoEMLP.init's scale), bf16 on the
    card, then fuse_projections + quantize_model(mode, on_device=True)
    unless mode is "bf16"; shared_gate adds a random [1, d] sigmoid gate to
    each shared expert (qwen2_moe's)."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.ops.quantize_model import fuse_projections, quantize_model

    cfg = TextConfig(**cfg_kw)
    model = init_model(cfg, dev)
    if shared_gate:
        gen = torch.Generator(device=dev).manual_seed(9)
        for blk in model.blocks:
            blk.mlp.shared_gate = torch.nn.Parameter(
                torch.randn(1, cfg.hidden_size, device=dev, generator=gen).to(torch.bfloat16) * 0.02,
                requires_grad=False)
    if mode != "bf16":
        quantize_model(fuse_projections(model), mode, on_device=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cfg, model


def moe_drive(model, cfg, dev, name: str, mode: str, batches=(MOE_BATCH,), prompt=MOE_PROMPT,
              new=MOE_NEW) -> dict:
    """The MoE main path, eagerly: batched_generate at each b in `batches`
    (b prompts of `prompt` tokens, `new` new tokens; prefill ms and decode
    tok/s), and a b=1 generate of a 100-token prompt whose last decode step
    is held against a fresh prefill; exact launch counts (moe_expected).
    Returns the launches."""
    from mllm_tpu_torch.generation.generate import batched_generate, generate, prefill
    from mllm_tpu_torch.generation.sampling import SamplingConfig

    kernels = wrappers()
    rng = np.random.default_rng(21)
    V = cfg.vocab_size
    batched_generate(model, rng.integers(0, V, (1, prompt)), np.array([prompt]),  # warm-up
                     model.init_cache(1, S_CACHE), SamplingConfig(max_new_tokens=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    forwards, runs = [], []
    for b in batches:
        ids = rng.integers(0, V, (b, prompt))
        cache = model.init_cache(b, S_CACHE)
        (lg, cache), t_pre = timed(lambda: prefill(model, cache, torch.as_tensor(ids, device=dev), prompt))
        (toks, _), t_all = timed(lambda: batched_generate(model, ids, np.full(b, prompt), model.init_cache(b, S_CACHE),
                                                          SamplingConfig(max_new_tokens=new)))
        if toks.shape != (b, new) or not ((toks >= 0) & (toks < V)).all() or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{name} b={b}: tokens {toks.shape}, or out of the vocabulary, or non-finite logits")
        forwards += [(b * prompt, True, b)] * 2 + [(b, False, b)] * (new - 1)
        runs.append(dict(batch=b, prompt_tokens=prompt, new_tokens=new, prefill_ms=t_pre * 1e3,
                         decode_tok_s=b * (new - 1) / max(t_all - t_pre, 1e-9)))
    spy, restore = logits_spy(model, dev)
    p100 = rng.integers(0, V, 100)
    res, _ = generate(model, p100, model.init_cache(1, S_CACHE), SamplingConfig(max_new_tokens=32))
    restore()
    gap = last_step_vs_prefill(model, dev, p100, res.tokens, spy["last"][:, -1])
    forwards += [(100, True, 1)] + [(1, False, 1)] * (len(res.tokens) - 1) + [(130, True, 1)]
    if not bool(spy["finite"]) or not gap <= RAGGED_TOL:
        raise AssertionError(f"{name}: finite {bool(spy['finite'])}, last decode step vs prefill {gap}")
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    expected = moe_expected(cfg, mode, forwards)
    emit(phase=name, mode=mode, runs=runs, last_decode_vs_prefill=gap, tolerance=RAGGED_TOL,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(), launches=launches,
         launches_expected=expected)
    for k, want in expected.items():
        if launches[k] != want:
            raise AssertionError(f"{name} {k}: {launches[k]} launches, expected {want}")
    return {k: launches[k] for k in expected}


def phase_slice_moe(dev) -> dict:
    """The JAX bench's MoE geometry (QWEN2_MOE_08B: 16 layers, 16 experts,
    top-4, shared expert 2048) at full depth, random weights at MoEMLP.init's
    scale: the branch times of one layer at t in MOE_T; bf16, "int8" and
    "int4" through batched_generate at b=8 (128 prompt tokens, 128 new, the
    qwen2moe-0.8b-*-b8 rows' traffic), the decode-vs-prefill check,
    slice_compiled at b=1 (generate_compiled against generate, prompts of
    100 and 1500 tokens); then the engine over the bf16 model
    (slice_engine's 12 requests) with exact launches."""
    launches = {}
    moe_branch_rows(dev, "qwen2moe-0.8b", QWEN2_MOE_08B)
    for mode in ("bf16", "int8", "int4"):
        t0 = time.perf_counter()
        cfg, model = moe_model(QWEN2_MOE_08B, dev, mode)
        emit(phase="slice_moe_model", mode=mode, seconds=time.perf_counter() - t0, weight_bytes=state_bytes(model),
             layers=sorted({type(m).__name__ for m in model.modules()}))
        add_launches(launches, moe_drive(model, cfg, dev, f"slice_moe_{mode}", mode))
        add_launches(launches, compiled_run(model, dev, f"moe_{mode}"))
        if mode == "bf16":
            L = cfg.num_hidden_layers

            def expected(admissions, steps):
                return {"flash_attention": L * admissions, "decode_attention": L * steps,
                        **{k: 0 for k in ("flash_attention_quant", "decode_attention_quant",
                                          "decode_attention_paged", "int8_matmul")}}

            add_launches(launches, serve(model, dev, "moe_engine_bf16", {}, expected))
        del model
        torch.cuda.empty_cache()
    return launches


def phase_slice_moe_wide(dev) -> dict:
    """Qwen1.5-MoE-A2.7B's published width (QWEN15_MOE_A27B: 24 layers, 60
    experts, top-4, expert ff 1408, shared expert 5632 with its sigmoid
    gate, vocab 151936, untied; 14.3 G parameters, no depth cut), random
    weights: the branch times of one layer at t in MOE_T, then bf16 and
    "int8" through batched_generate at b=1 and b=8 (128 prompt tokens, 64
    new) with exact launches and peak memory."""
    launches = {}
    moe_branch_rows(dev, "qwen1.5-moe-a2.7b", QWEN15_MOE_A27B)
    for mode in ("bf16", "int8"):
        t0 = time.perf_counter()
        cfg, model = moe_model(QWEN15_MOE_A27B, dev, mode, shared_gate=True)
        emit(phase="slice_moe_wide_model", mode=mode, seconds=time.perf_counter() - t0,
             params=sum(t.numel() for t in model.state_dict().values()), weight_bytes=state_bytes(model),
             memory_allocated_bytes=torch.cuda.memory_allocated())
        add_launches(launches, moe_drive(model, cfg, dev, f"slice_moe_wide_{mode}", mode, batches=(1, MOE_BATCH),
                                         new=64))
        del model
        torch.cuda.empty_cache()
    return launches


# slice_families: each preset at full width, depth cut to FAMILY_LAYERS
FAMILIES = ("gemma-2b", "gemma2-2b", "stablelm2-1.6b", "phi3-mini", "phonelm-1.5b", "dclm-1b")
FAMILY_LAYERS = 4
# the presets whose attention reaches the bf16 kernels (Gemma2's softcap and
# Phi-3's head_dim 96 take sdpa, as the reference sends them to XLA)
FAMILY_KERNELS = {"gemma-2b": True, "gemma2-2b": False, "stablelm2-1.6b": True, "phi3-mini": False,
                  "phonelm-1.5b": True, "dclm-1b": True}


def phase_slice_families(dev) -> dict:
    """Each preset of FAMILIES at full width (what the kernels see), depth cut
    to 4 layers, random bf16 weights (PhoneLM with its int8 RoPE tables):
    generate (a 100-token prompt, 32 new) with the last decode step against
    a fresh prefill, generate_compiled equal to it, and the attention
    kernels' launches exact: FAMILY_KERNELS' presets one flash_attention a
    layer a prefill and one decode_attention a layer a step, the others
    none. Gemma-2B's (head_dim 256) are returned as the @256 rows'."""
    from mllm_tpu_torch.generation import graphs
    from mllm_tpu_torch.generation.generate import generate, generate_compiled, pad_to_bucket
    from mllm_tpu_torch.generation.sampling import SamplingConfig
    from mllm_tpu_torch.models.families import PRESETS

    kernels = wrappers()
    launches = {}
    for name in FAMILIES:
        t0 = time.perf_counter()
        cfg = PRESETS[name].replace(num_hidden_layers=FAMILY_LAYERS, eos_token_id=-2,
                                    rope_int8=name.startswith("phonelm"))
        model = init_model(cfg, dev)
        prompt = np.random.default_rng(31).integers(0, cfg.vocab_size, 100)
        for fn in kernels.values():
            fn.launches = 0
        graphs.reset_counts()
        spy, restore = logits_spy(model, dev)
        res, _ = generate(model, prompt, model.init_cache(1, S_CACHE), SamplingConfig(max_new_tokens=32))
        restore()
        finite = bool(spy["finite"])
        gap = last_step_vs_prefill(model, dev, prompt, res.tokens, spy["last"][:, -1])
        eager = {k: fn.launches for k, fn in kernels.items()}
        toks, n = generate_compiled(model, pad_to_bucket(prompt[None]), model.init_cache(1, S_CACHE), 100, 32,
                                    SamplingConfig(max_new_tokens=32))
        compiled = toks.cpu().numpy()[: int(n)].tolist()
        torch.cuda.synchronize()
        on_card = graphs.device_launches({k: fn.launches for k, fn in kernels.items()})
        L, steps = FAMILY_LAYERS, len(res.tokens) - 1
        want = ({"flash_attention": 2 * L, "decode_attention": L * steps} if FAMILY_KERNELS[name]
                else {"flash_attention": 0, "decode_attention": 0})
        emit(phase="slice_families", preset=name, layers=L, hidden=cfg.hidden_size, head_dim=cfg.head_dim_,
             heads=[cfg.num_attention_heads, cfg.num_key_value_heads], vocab=cfg.vocab_size,
             seconds=time.perf_counter() - t0, new_tokens=[len(res.tokens), len(compiled)],
             compiled_equals_eager=compiled == res.tokens, last_decode_vs_prefill=gap, tolerance=RAGGED_TOL,
             logits_finite=finite, eager_launches={k: eager[k] for k in ATTENTION_KERNELS},
             eager_launches_expected=want, launches_on_card={k: on_card[k] for k in ATTENTION_KERNELS},
             depth_cut=f"{PRESETS[name].num_hidden_layers} -> {L} layers; widths as published")
        if not finite or not gap <= RAGGED_TOL or compiled != res.tokens:
            raise AssertionError(f"slice_families {name}: finite {finite}, decode vs prefill {gap}, "
                                 f"compiled equal {compiled == res.tokens}")
        others = set(ATTENTION_KERNELS) - set(want)
        if any(eager[k] != v for k, v in want.items()) or any(on_card[k] for k in others) or \
                (FAMILY_KERNELS[name] and not on_card["decode_attention"]):
            raise AssertionError(f"slice_families {name}: launches {eager} (expected {want}), on the card {on_card}")
        suffix = "@256" if cfg.head_dim_ == 256 else ""
        add_launches(launches, {k + suffix: on_card[k] for k in ("flash_attention", "decode_attention")})
        del model
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Vision-language: Qwen2-VL-2B (bench.py's image-prefill row), Qwen2.5-VL-3B,
# CLIP ViT-B/32
# ---------------------------------------------------------------------------

VL_IMAGE_PX, VL_RAW_PX, VL_CACHE = 532, 1024, 1024  # the bench row: a 1024 px frame resized to 532 px
VL_TEXT = (20, 10)  # random text ids before and after the image
VL_RUNS = 9  # timed runs (medians), after one warm-up
VL_NEW = 64  # decode tokens of vl_generate / vl_generate_compiled
VL_ENGINE_PX, VL_ENGINE_IMAGES, VL_ENGINE_TEXT_LENS = 448, 4, (17, 40, 64, 100, 150, 200, 256, 300)
VL25_NEW = 32
QWEN25VL_3B_LM = dict(  # Qwen/Qwen2.5-VL-3B-Instruct config.json (the language model)
    vocab_size=151936, hidden_size=2048, intermediate_size=11008, num_hidden_layers=36, num_attention_heads=16,
    num_key_value_heads=2, max_position_embeddings=4096, rope_theta=1000000.0, tie_word_embeddings=True,
    eos_token_id=-2)
QWEN2VL_VISION: dict = {}  # Qwen2VLVisionConfig's fields: {} = its defaults, Qwen2-VL-2B's tower
QWEN25VL_VISION: dict = {}  # Qwen25VLVisionConfig's: {} = Qwen2.5-VL-3B's published vision_config
CLIP_CONFIG: dict = {}  # CLIPConfig's: {} = HF's defaults, CLIP ViT-B/32
CLIP_TEXTS, CLIP_RUNS = 8, 5
CLIP_TOL = 5e-2  # x max |logit|: bf16 on the card against f32 on the host


def vl_config(lm: dict):
    """Qwen2VLConfig over the LM dict `lm` (max_position_embeddings 4096, the
    bench's) and the Qwen2-VL tower of QWEN2VL_VISION."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.models.qwen2_vl import Qwen2VLConfig, Qwen2VLVisionConfig

    text = TextConfig(**dict(lm, max_position_embeddings=4096))
    return Qwen2VLConfig(text=text, vision=Qwen2VLVisionConfig(**dict(dict(hidden_size=text.hidden_size),
                                                                      **QWEN2VL_VISION)))


def vl_prompt(cfg, grid, rng, text=VL_TEXT):
    """ids [1, S] (random text, vision start, the image pads, vision end,
    random text), positions [3, 1, S] and the mrope delta."""
    from mllm_tpu_torch.models.qwen2_vl import get_rope_index

    n_img = grid[0] * grid[1] * grid[2] // 4
    ids = np.concatenate([rng.integers(0, 151000, text[0]), [cfg.vision_start_token_id],
                          np.full(n_img, cfg.image_token_id), [cfg.vision_start_token_id + 1],
                          rng.integers(0, 151000, text[1])]).astype(np.int64)
    pos, delta = get_rope_index(ids, [grid], cfg.image_token_id, cfg.video_token_id, 2)
    return ids[None], pos[:, None, :], delta


def event_ms(fn) -> float:
    """Device ms of one call of fn (CUDA events; the host waits at the end)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median(xs) -> float:
    return float(np.median(np.asarray(xs, np.float64)))


class plain_attention:
    """Within the block, the attention of `nn.attention` runs the kernels'
    plain versions on the card (the reference route of a whole-model check)."""

    def __enter__(self):
        from mllm_tpu_torch.nn import attention as A
        from mllm_tpu_torch.ops.decode_attention import decode_attention_ref
        from mllm_tpu_torch.ops.flash_attention import flash_attention_ref

        self.saved = (A.flash_attention, A.decode_attention)
        A.flash_attention, A.decode_attention = flash_attention_ref, decode_attention_ref
        return self

    def __exit__(self, *exc):
        from mllm_tpu_torch.nn import attention as A

        A.flash_attention, A.decode_attention = self.saved


def vl_counts() -> dict:
    """The launch counters, with flash_attention split by head_dim: "@80"
    (the vision tower) apart from the rest."""
    counts = {k: fn.launches for k, fn in wrappers().items()}
    at80 = wrappers()["flash_attention"].launches_at.get(80, 0)
    counts["flash_attention"] -= at80
    counts["flash_attention@80"] = at80
    return counts


def vl_reset() -> None:
    from mllm_tpu_torch.generation import graphs

    for fn in wrappers().values():
        fn.launches = 0
    wrappers()["flash_attention"].launches_at.clear()
    graphs.reset_counts()


def vl_gap(model, dev, ids, patches, grid, toks, kv_dtype: str = "bf16") -> float:
    """How far below the top of a teacher-forced prefill of the prompt (with
    its image) + toks[:-1] the generated tokens sit: max over positions of
    (max logit - logit of the token) / max |logit|."""
    from mllm_tpu_torch.models.qwen2_vl import get_rope_index

    full = np.concatenate([ids[0], np.asarray(toks[:-1], np.int64)])
    pos, _ = get_rope_index(full, [grid], model.cfg.image_token_id, model.cfg.video_token_id, 2)
    with torch.no_grad():
        logits, _ = model(torch.as_tensor(full[None], device=dev), model.init_cache(1, S_CACHE, kv_dtype=kv_dtype),
                          patches=patches, grid_thw=grid, positions=torch.as_tensor(pos[:, None], device=dev),
                          last_only=False)
    lg = logits[0, ids.shape[1] - 1:].float()
    chosen = lg.gather(1, torch.as_tensor(np.asarray(toks), device=dev)[:, None])[:, 0]
    return ((lg.max(-1).values - chosen) / lg.abs().max(-1).values).max().item()


def vl_prefill_timings(model, dev, src, ids, pos, grid, name: str) -> dict:
    """The bench row's image prefill to the first greedy token, both wires:
    end to end (host resize of the 1024 px frame, I420 conversion for the
    YUV wire, the upload, the prefill, the token read back), device ms (CUDA
    events, the frame already on the card) and the host resize alone;
    medians of VL_RUNS after one warm-up. Returns the row (and checks the two
    wires' first tokens agree or sit within RAGGED_TOL of each other)."""
    from mllm_tpu_torch.models.qwen2_vl import vl_image_prefill, vl_image_prefill_yuv
    from mllm_tpu_torch.processor import image as im

    tl = ids.shape[1]
    ids_d, pos_d = torch.as_tensor(ids, device=dev), torch.as_tensor(pos, device=dev)
    cache = model.init_cache(1, VL_CACHE)
    have_pil = True
    try:
        im.resize(src[:8, :8], 4, 4)
    except RuntimeError:
        have_pil = False
    vc = torch.as_tensor(im.bicubic_coeff_matrix(VL_RAW_PX, VL_IMAGE_PX), device=dev)

    def host_resize():
        if have_pil:
            return im.resize(src, VL_IMAGE_PX, VL_IMAGE_PX)
        return im.device_resize_bicubic(torch.as_tensor(src, device=dev), vc, vc).cpu().numpy()

    def rgb(frame):
        with torch.no_grad():
            last, _ = vl_image_prefill(model, cache.with_pos(0), ids_d, frame, pos_d, tl, grid)
        return torch.argmax(last, dim=-1)

    def yuv(planes):
        with torch.no_grad():
            last, _ = vl_image_prefill_yuv(model, cache.with_pos(0), ids_d, *planes, pos_d, tl, grid)
        return torch.argmax(last, dim=-1)

    frame = host_resize()
    planes_h = im.rgb_to_yuv420(frame)
    frame_d = torch.tensor(frame[None], device=dev)
    planes_d = [torch.as_tensor(p[None], device=dev) for p in planes_h]
    tok_rgb, tok_yuv = int(rgb(frame_d)), int(yuv(planes_d))  # warm-up
    e2e = {"rgb": [], "yuv": []}
    for _ in range(VL_RUNS):
        t0 = time.perf_counter()
        int(rgb(torch.tensor(host_resize()[None], device=dev)))
        e2e["rgb"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        int(yuv([torch.as_tensor(p[None], device=dev) for p in im.rgb_to_yuv420(host_resize())]))
        e2e["yuv"].append((time.perf_counter() - t0) * 1e3)
    dev_ms = {"rgb": median([event_ms(lambda: rgb(frame_d)) for _ in range(VL_RUNS)]),
              "yuv": median([event_ms(lambda: yuv(planes_d)) for _ in range(VL_RUNS)])}
    resize_ms = []
    for _ in range(VL_RUNS):
        t0 = time.perf_counter()
        host_resize()
        resize_ms.append((time.perf_counter() - t0) * 1e3)
    dev_resize_ms = median([event_ms(lambda: im.device_resize_bicubic(torch.as_tensor(src, device=dev), vc, vc))
                            for _ in range(VL_RUNS)])
    row = dict(phase="slice_vl_image_prefill", model=name, frame=[VL_RAW_PX, VL_RAW_PX, 3],
               image=[VL_IMAGE_PX, VL_IMAGE_PX], grid=list(grid), prompt_tokens=tl,
               e2e_ms_rgb=median(e2e["rgb"]), e2e_ms_yuv=median(e2e["yuv"]), device_ms_rgb=dev_ms["rgb"],
               device_ms_yuv=dev_ms["yuv"], host_resize_ms=median(resize_ms),
               host_resize_by="PIL" if have_pil else "the card (device_resize_bicubic; no PIL)",
               device_resize_ms=dev_resize_ms, first_token_rgb=tok_rgb, first_token_yuv=tok_yuv,
               runs=VL_RUNS, note="medians; e2e: host resize (+ I420) + upload + prefill + token read back")
    emit(**row)
    return row


def engine_image(cfg, dev, rng):
    """One image request of the engine runs: a random VL_ENGINE_PX px frame
    patchified on the card, between 10 + 10 random text ids
    (Qwen2VLProcessorOutput)."""
    from mllm_tpu_torch.models.qwen2_vl import device_patchify
    from mllm_tpu_torch.processor.image import CLIP_MEAN, CLIP_STD
    from mllm_tpu_torch.processor.qwen2_vl import Qwen2VLProcessorOutput

    g = VL_ENGINE_PX // 14
    ids, pos, delta = vl_prompt(cfg, (1, g, g), rng, (10, 10))
    frame = torch.as_tensor(rng.integers(0, 256, (1, VL_ENGINE_PX, VL_ENGINE_PX, 3), np.uint8), device=dev)
    return Qwen2VLProcessorOutput(ids, device_patchify(torch.cat([frame, frame]), CLIP_MEAN, CLIP_STD), (1, g, g),
                                  pos, delta)


def vl_engine_run(model, dev, rng) -> dict:
    """ContinuousEngine(slots=8, max_len=2048, decode_window=32, pipeline=True)
    serving VL_ENGINE_IMAGES image requests at VL_ENGINE_PX px (patchified on
    the card) mixed with 8 text requests of 17-300 tokens, 48 new each: every
    request returns 48 in-vocabulary tokens, and every request's tokens sit
    within RAGGED_TOL x max |logit| of a teacher-forced prefill. Returns the
    launches on the card."""
    from mllm_tpu_torch.generation import graphs
    from mllm_tpu_torch.generation.engine import ContinuousEngine, collect

    cfg = model.cfg
    images = [engine_image(cfg, dev, rng) for _ in range(VL_ENGINE_IMAGES)]
    grid = images[0].grid_thw
    texts = [rng.integers(0, 151000, n) for n in VL_ENGINE_TEXT_LENS]
    torch.cuda.synchronize()
    eng = ContinuousEngine(model, start_thread=False, **ENGINE_KW)
    vl_reset()
    t0 = time.perf_counter()
    qs = {}
    for i, txt in enumerate(texts):  # an image request before every other text request
        if i % 2 == 0 and i // 2 < len(images):
            qs[("image", i // 2)] = eng.submit_vl(images[i // 2], ENGINE_NEW)
        qs[("text", i)] = eng.submit(txt, ENGINE_NEW)
    while any(r is not None for r in eng.req) or not eng.pending.empty() or eng._inflight is not None:
        eng.step()
    got = {key: collect(q, timeout=5) for key, q in qs.items()}
    outs = list(got.values())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = graphs.device_launches(vl_counts())
    capture_s = sum(gr.capture_s for gr in eng._windows.values())
    V = cfg.text.vocab_size
    if not all(len(o) == ENGINE_NEW and all(0 <= t < V for t in o) for o in outs):
        raise AssertionError(f"slice_vl engine: lengths {[len(o) for o in outs]} or a token out of the vocabulary")
    gaps = [vl_gap(model, dev, im.input_ids, im.patches, grid, got[("image", i)]) for i, im in enumerate(images)]
    gaps += [teacher_forced_gap(model, dev, t, got[("text", i)]) for i, t in enumerate(texts)]
    replays = sum(gr.replays for gr in eng._windows.values())
    emit(phase="slice_vl_engine", requests=len(outs), image_requests=len(images), image_px=VL_ENGINE_PX,
         image_prompt_tokens=int(images[0].input_ids.shape[1]), text_prompt_tokens=list(VL_ENGINE_TEXT_LENS),
         new_tokens=ENGINE_NEW, wall_s=wall, tok_s=len(outs) * ENGINE_NEW / wall, capture_s=capture_s,
         tok_s_less_capture=len(outs) * ENGINE_NEW / (wall - capture_s), windows=eng.steps, graph_replays=replays,
         admissions=eng.admissions, teacher_forced_gap_over_max_logit=max(gaps), tolerance=RAGGED_TOL,
         launches=launches)
    if replays != eng.steps or not max(gaps) <= RAGGED_TOL:
        raise AssertionError(f"slice_vl engine: {replays} replays of {eng.steps} windows, teacher-forced gap "
                             f"{max(gaps)} (tolerance {RAGGED_TOL})")
    if launches["flash_attention@80"] != 32 * len(images):
        raise AssertionError(f"slice_vl engine: {launches['flash_attention@80']} head_dim-80 flash launches, "
                             f"expected {32 * len(images)} (32 a tower pass)")
    del eng
    torch.cuda.empty_cache()
    return launches


def vl_serve_png(model, dev) -> None:
    """One chat request with a PNG image through mllm_tpu_torch.serve on
    127.0.0.1 (the continuous engine, a synthetic tokenizer whose vision
    tokens are the model's): 200 and in-vocabulary tokens. Needs PIL; where
    it is missing a line says so and nothing is checked."""
    import base64
    import dataclasses
    import io
    import os
    import tempfile

    from mllm_tpu_torch import serve
    from mllm_tpu_torch.tokenizers.hf_json import from_tokenizer_json

    try:
        from PIL import Image
    except ImportError:
        emit(phase="slice_vl_serve", skipped="PIL is not installed on this machine: the HTTP image request "
             "is held by the CPU tests alone (tests/test_torch_serve.py)")
        return
    specials = TOKENIZER_SPECIALS + VL_SPECIALS
    V = model.cfg.text.vocab_size
    ids = {t: V - len(specials) + i for i, t in enumerate(specials)}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tokenizer.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(synthetic_tokenizer(V, 3, specials=specials), f)
        tok = from_tokenizer_json(path)
    saved = model.cfg
    model.cfg = dataclasses.replace(saved, image_token_id=ids["<|image_pad|>"], video_token_id=ids["<|video_pad|>"],
                                    vision_start_token_id=ids["<|vision_start|>"])
    frontend = serve.ContinuousFrontend(model, tok, model.cfg, max_len=S_CACHE, max_batch=2, image_size=448)
    server, port = start_server(frontend)
    try:
        img = np.random.default_rng(5).integers(0, 256, (600, 800, 3), np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        url = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
        body = {"messages": [{"role": "user", "content": [{"type": "text", "text": "What is in the picture?"},
                                                          {"type": "image_url", "image_url": {"url": url}}]}],
                "max_tokens": 16}
        t0 = time.perf_counter()
        status, reply = http(port, "/v1/chat/completions", body)
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        frontend.stop()
        model.cfg = saved
    out = json.loads(reply)
    emit(phase="slice_vl_serve", status=status, completion_tokens=out.get("usage", {}).get("completion_tokens"),
         prompt_tokens=out.get("usage", {}).get("prompt_tokens"), wall_s=wall, image=[600, 800], image_size=448)
    if status != 200 or not 1 <= out["usage"]["completion_tokens"] <= 16:
        raise AssertionError(f"slice_vl_serve: status {status}, reply {out}")


def phase_slice_vl(dev) -> dict:
    """Qwen2-VL-2B as bench.py builds it (the tower at Qwen2VLVisionConfig's
    defaults over QWEN2VL_2B_LM with 4096 positions, random bf16 weights):
    one tower pass launches the head_dim-80 flash kernel 32 times; the bench
    row's image prefill (a 1024 px frame resized to 532 px: grid (1, 38, 38),
    361 vision tokens, 393 prompt tokens, a 1024-row cache) within RAGGED_TOL
    x max |logit| of the same prefill with the attention on its plain
    versions, timed on both wires; vl_generate and vl_generate_compiled
    (VL_NEW tokens, equal, the last steps against a teacher-forced prefill);
    vtp_prefill at keep 0.5, prune layer 2 (head at 212, finite logits); then
    quantize_model("int8", on_device=True): the image prefill timed again,
    over an int8 KV cache (the first 16 tokens against a teacher-forced
    prefill over the same cache type), the engine with image and text
    requests, and a PNG chat request through the server. Returns every
    launch the phase made on the card (the plain-route checks launch none)."""
    from mllm_tpu_torch.generation import graphs
    from mllm_tpu_torch.models.qwen2_vl import (Qwen2VLForConditionalGeneration, device_patchify, vl_generate,
                                                vl_generate_compiled, vtp_prefill)
    from mllm_tpu_torch.ops.quantize_model import quantize_model
    from mllm_tpu_torch.processor.image import CLIP_MEAN, CLIP_STD
    from mllm_tpu_torch.processor.qwen2_vl import Qwen2VLProcessorOutput

    t0 = time.perf_counter()
    cfg = vl_config(QWEN2VL_2B_LM)
    model = Qwen2VLForConditionalGeneration.init(cfg, device=dev, dtype=torch.bfloat16,
                                                 generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    vparams = sum(p.numel() for p in model.visual.parameters())
    emit(phase="slice_vl_init", seconds=time.perf_counter() - t0, vision_params=vparams,
         lm_params=sum(p.numel() for p in model.lm.parameters()), weight_bytes=state_bytes(model))
    rng = np.random.default_rng(21)
    src = rng.integers(0, 256, (VL_RAW_PX, VL_RAW_PX, 3), np.uint8)
    grid = (1, VL_IMAGE_PX // 14, VL_IMAGE_PX // 14)
    ids, pos, delta = vl_prompt(cfg, grid, rng)
    launches = {}

    def take():  # the launches on the card since the last reset (captures and replays counted), then reset
        add_launches(launches, graphs.device_launches(vl_counts()))
        vl_reset()

    # one tower pass: 32 launches of the head_dim-80 kernel, its output against the plain route
    frame = torch.as_tensor(np.ascontiguousarray(src[:VL_IMAGE_PX, :VL_IMAGE_PX])[None], device=dev)
    patches = device_patchify(torch.cat([frame, frame]), CLIP_MEAN, CLIP_STD)
    vl_reset()
    with torch.no_grad():
        emb = model.visual(patches, grid)
        torch.cuda.synchronize()
        tower = vl_counts()
        with plain_attention():
            emb_ref = model.visual(patches, grid)
    tower_err = ((emb.float() - emb_ref.float()).abs().max() / emb_ref.float().abs().max()).item()
    take()
    emit(phase="slice_vl_tower", grid=list(grid), patches=int(patches.shape[0]), embeds=list(emb.shape),
         flash80_launches=tower["flash_attention@80"], rel_err_vs_plain=tower_err, tolerance=RAGGED_TOL,
         finite=bool(torch.isfinite(emb.float()).all()))
    if tower["flash_attention@80"] != cfg.vision.depth or tower["flash_attention"] or not tower_err <= RAGGED_TOL:
        raise AssertionError(f"slice_vl tower: launches {tower}, rel err vs plain {tower_err}")

    # the image prefill: kernels against the plain route, then the bench row's timings
    ids_d, pos_d = torch.as_tensor(ids, device=dev), torch.as_tensor(pos, device=dev)
    with torch.no_grad():
        last, cache = model(ids_d, model.init_cache(1, VL_CACHE), patches=patches, grid_thw=grid, positions=pos_d,
                            last_pos=ids.shape[1] - 1)
        with plain_attention():
            last_ref, _ = model(ids_d, model.init_cache(1, VL_CACHE), patches=patches, grid_thw=grid,
                                positions=pos_d, last_pos=ids.shape[1] - 1)
    err = ((last.float() - last_ref.float()).abs().max() / last_ref.float().abs().max()).item()
    finite = bool(torch.isfinite(last.float()).all())
    emit(phase="slice_vl_prefill_check", prompt_tokens=ids.shape[1], logits=list(last.shape), finite=finite,
         rel_err_vs_plain_attention=err, tolerance=RAGGED_TOL)
    if not finite or not err <= RAGGED_TOL:
        raise AssertionError(f"slice_vl prefill: finite {finite}, vs plain attention {err}")
    vl_prefill_timings(model, dev, src, ids, pos, grid, "bf16")
    take()

    # generation: eager against compiled, the last steps against a teacher-forced prefill
    proc = Qwen2VLProcessorOutput(ids, patches, grid, pos, delta)
    t1 = time.perf_counter()
    eager, _ = vl_generate(model, proc, model.init_cache(1, S_CACHE), max_new_tokens=VL_NEW)
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t1
    take()
    compiled_args = (model, ids, patches, grid, pos_d)
    vl_generate_compiled(*compiled_args, model.init_cache(1, S_CACHE), ids.shape[1], VL_NEW, mrope_delta=delta)
    torch.cuda.synchronize()
    t1 = time.perf_counter()  # the second call replays the captured loop
    toks, n = vl_generate_compiled(*compiled_args, model.init_cache(1, S_CACHE), ids.shape[1], VL_NEW,
                                   mrope_delta=delta)
    compiled = toks.cpu().numpy()[: int(n)].tolist()
    t_comp = time.perf_counter() - t1
    replays = graphs.replays("generate_compiled")
    take()
    gap = vl_gap(model, dev, ids, patches, grid, eager)
    emit(phase="slice_vl_generate", new_tokens=VL_NEW, eager_tok_s=VL_NEW / t_eager, compiled_tok_s=VL_NEW / t_comp,
         compiled_equals_eager=compiled == eager, teacher_forced_gap_over_max_logit=gap, tolerance=RAGGED_TOL,
         replays=replays, note="tok/s over wall time, the prefill (vision encode "
         "included) and the first token in it; compiled: the second call (captured loop replayed)")
    if compiled != eager or not gap <= RAGGED_TOL:
        raise AssertionError(f"slice_vl generate: compiled equal {compiled == eager}, gap {gap}")

    # VTP: keep half of the vision tokens from layer 2 on
    with torch.no_grad():
        lg, vcache = vtp_prefill(model, ids, model.init_cache(1, VL_CACHE), patches, grid, pos_d, keep_ratio=0.5,
                                 prune_layer=2)
    head = int(vcache.pos)
    want_head = ids.shape[1] - (grid[1] * grid[2] // 4) + int(grid[1] * grid[2] // 4 * 0.5)
    emit(phase="slice_vl_vtp", keep_ratio=0.5, prune_layer=2, cache_head=head, expected_head=want_head,
         finite=bool(torch.isfinite(lg.float()).all()))
    if head != want_head or not bool(torch.isfinite(lg.float()).all()):
        raise AssertionError(f"slice_vl vtp: head {head} (expected {want_head}) or non-finite logits")

    # the int8 model (the bench row's): timings, an int8 KV cache, the engine, the server
    t1 = time.perf_counter()
    quantize_model(model, "int8", on_device=True)
    torch.cuda.synchronize()
    emit(phase="slice_vl_quantize", mode="int8", seconds=time.perf_counter() - t1, weight_bytes=state_bytes(model))
    vl_prefill_timings(model, dev, src, ids, pos, grid, "int8")
    out8, _ = vl_generate(model, proc, model.init_cache(1, S_CACHE, kv_dtype="int8"), max_new_tokens=16)
    gap8 = vl_gap(model, dev, ids, patches, grid, out8, kv_dtype="int8")
    emit(phase="slice_vl_int8_kv", new_tokens=16, teacher_forced_gap_over_max_logit=gap8, tolerance=RAGGED_TOL)
    if not gap8 <= RAGGED_TOL:
        raise AssertionError(f"slice_vl int8 KV: gap {gap8}")
    take()
    add_launches(launches, vl_engine_run(model, dev, rng))  # it counts from its own reset
    vl_reset()
    vl_serve_png(model, dev)
    take()
    del model
    torch.cuda.empty_cache()
    return launches


def phase_slice_vl25(dev) -> dict:
    """Qwen2.5-VL-3B at its published config.json (Qwen/Qwen2.5-VL-3B-
    Instruct; full depth, random bf16 weights, the cache at 4096 positions):
    one 532 px image prefill (windowed tower: the plain `sdpa` with the
    same-window bias, as the reference) and VL25_NEW eager decode tokens, the
    last steps against a teacher-forced prefill; the image prefill's device
    ms."""
    from mllm_tpu_torch.models.qwen2_5_vl import Qwen25VLVisionConfig, qwen2_5_vl_model
    from mllm_tpu_torch.models.qwen2_vl import device_patchify, vl_generate
    from mllm_tpu_torch.processor.image import CLIP_MEAN, CLIP_STD
    from mllm_tpu_torch.processor.qwen2_vl import Qwen2VLProcessorOutput

    t0 = time.perf_counter()
    vcfg = Qwen25VLVisionConfig(**QWEN25VL_VISION)  # the published vision_config (depth 32, 1280 wide, 3420, out 2048)
    cfg = vl_config(QWEN25VL_3B_LM)
    model = qwen2_5_vl_model(cfg, vcfg, device=dev, dtype=torch.bfloat16,
                             generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    emit(phase="slice_vl25_init", seconds=time.perf_counter() - t0,
         params=sum(p.numel() for p in model.parameters()), weight_bytes=state_bytes(model))
    rng = np.random.default_rng(25)
    grid = (1, VL_IMAGE_PX // 14, VL_IMAGE_PX // 14)
    ids, pos, delta = vl_prompt(cfg, grid, rng)
    frame = torch.as_tensor(rng.integers(0, 256, (1, VL_IMAGE_PX, VL_IMAGE_PX, 3), np.uint8), device=dev)
    patches = device_patchify(torch.cat([frame, frame]), CLIP_MEAN, CLIP_STD)
    ids_d, pos_d = torch.as_tensor(ids, device=dev), torch.as_tensor(pos, device=dev)

    def prefill():
        with torch.no_grad():
            return model(ids_d, model.init_cache(1, VL_CACHE), patches=patches, grid_thw=grid, positions=pos_d,
                         last_pos=ids.shape[1] - 1)[0]

    prefill()
    dev_ms = median([event_ms(prefill) for _ in range(5)])
    vl_reset()
    toks, _ = vl_generate(model, Qwen2VLProcessorOutput(ids, patches, grid, pos, delta),
                          model.init_cache(1, S_CACHE), max_new_tokens=VL25_NEW)
    launches = vl_counts()
    gap = vl_gap(model, dev, ids, patches, grid, toks)
    emit(phase="slice_vl25", layers=cfg.text.num_hidden_layers, vision_depth=vcfg.depth, grid=list(grid),
         prompt_tokens=ids.shape[1], image_prefill_device_ms=dev_ms, new_tokens=len(toks),
         teacher_forced_gap_over_max_logit=gap, tolerance=RAGGED_TOL, launches=launches,
         depth_cut="none: published widths and depths")
    if len(toks) != VL25_NEW or not gap <= RAGGED_TOL or launches["flash_attention@80"]:
        raise AssertionError(f"slice_vl25: {len(toks)} tokens, gap {gap}, launches {launches}")
    del model
    torch.cuda.empty_cache()
    return launches


def phase_slice_clip(dev) -> dict:
    """bench.py's clip-vitb-scoring row: CLIP ViT-B/32 at HF's default widths
    (CLIPConfig()), random bf16 weights (CLIPModel.init), one 224 px image
    against CLIP_TEXTS texts of 77 tokens: logits_per_image [1, 8], finite,
    within CLIP_TOL x max |logit| of the same weights in f32 on the host;
    score ms a median of CLIP_RUNS (CUDA events)."""
    import copy

    from mllm_tpu_torch.models.clip import CLIPConfig, CLIPModel

    cfg = CLIPConfig(**CLIP_CONFIG)
    model = CLIPModel.init(cfg, device=dev, dtype=torch.bfloat16, generator=torch.Generator(device=dev).manual_seed(2))
    rng = np.random.default_rng(27)
    ids = rng.integers(0, cfg.text.vocab_size - 1, (CLIP_TEXTS, cfg.text.max_position_embeddings))
    ids[np.arange(CLIP_TEXTS), rng.integers(5, 77, CLIP_TEXTS)] = cfg.text.eos_token_id
    pixel = rng.standard_normal((1, 3, 224, 224)).astype(np.float32)
    ids_d, px_d = torch.as_tensor(ids, device=dev), torch.as_tensor(pixel, device=dev)
    with torch.no_grad():
        logits = model(ids_d, px_d)
        ms = median([event_ms(lambda: model(ids_d, px_d)) for _ in range(CLIP_RUNS)])
        host = copy.deepcopy(model).float().cpu()
        ref = host(torch.as_tensor(ids), torch.as_tensor(pixel))
    err = ((logits.float().cpu() - ref).abs().max() / ref.abs().max()).item()
    finite = bool(torch.isfinite(logits).all())
    emit(phase="slice_clip", logits=list(logits.shape), score_ms=ms, runs=CLIP_RUNS, rel_err_vs_f32_host=err,
         tolerance=CLIP_TOL, finite=finite, texts=CLIP_TEXTS, text_tokens=cfg.text.max_position_embeddings,
         params=sum(p.numel() for p in model.parameters()))
    if list(logits.shape) != [1, CLIP_TEXTS] or not finite or not err <= CLIP_TOL:
        raise AssertionError(f"slice_clip: logits {list(logits.shape)}, finite {finite}, vs f32 host {err}")
    del model, host
    torch.cuda.empty_cache()
    return {}


# ---------------------------------------------------------------------------
# Gemma-2B over int8 / int4 KV: the quantized kernels at head_dim 256
# ---------------------------------------------------------------------------


class counting:
    """Within the block, the calls of `module.name` are counted in `.calls`."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.saved = getattr(self.module, self.name)

        def counted(*args, **kw):
            self.calls += 1
            return self.saved(*args, **kw)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def phase_slice_kvq256(dev) -> dict:
    """Gemma-2B (families.PRESETS["gemma-2b"]: published widths and depth, 18
    layers, random bf16 weights) over int8 and int4 KV caches, driven as
    phase_slice_kvq drives the Qwen2-VL LM (drive(): generate at b=1 with
    prompts of 100 and 1500 tokens, ragged_batched_generate at b=8, a sampled
    generate), then generate_compiled over int8 KV (the kernels under
    capture) and the engine over an int8 SlotQuantKVCache (ENGINE_KW): every
    prefill and admission 18 flash_attention_quant launches and every decode
    step 18 decode_attention_quant, exactly, eager and captured; no bf16
    attention kernel and not one call of `nn.attention.sdpa`. Returned under
    the @256 names."""
    from mllm_tpu_torch.models.families import PRESETS
    from mllm_tpu_torch.nn import attention as A

    cfg = PRESETS["gemma-2b"].replace(eos_token_id=-2)
    L = cfg.num_hidden_layers
    model = init_model(cfg, dev)
    others = {"flash_attention": 0, "decode_attention": 0, "decode_attention_paged": 0}

    def expected(prefills, steps):
        return {"flash_attention_quant": L * prefills, "decode_attention_quant": L * steps, **others}

    launches, sdpa_calls = {}, {}
    for kv in ("int8", "int4"):
        want = {}

        def recorded(prefills, steps, want=want):
            want.update(expected(prefills, steps))
            return want

        with counting(A, "sdpa") as sd:
            got = drive(model, cfg, dev, f"slice_kvq256_{kv}", (17, 40, 64, 90, 128, 150, 180, 200), recorded, kv)
        sdpa_calls[f"drive_{kv}"] = sd.calls
        if any(got[k] != n for k, n in want.items()):
            raise AssertionError(f"slice_kvq256 {kv}: launches {got}, expected exactly {want}")
        add_launches(launches, got)
    with counting(A, "sdpa") as sd:
        add_launches(launches, compiled_run(model, dev, "gemma-2b_kv_int8", kv_dtype="int8", expected_per=expected))
    sdpa_calls["compiled_int8"] = sd.calls
    with counting(A, "sdpa") as sd:
        add_launches(launches, serve(model, dev, "engine_gemma-2b_int8", {"kv_dtype": "int8"}, expected))
    sdpa_calls["engine_int8"] = sd.calls
    emit(phase="slice_kvq256", layers=L, head_dim=cfg.head_dim_, heads=[cfg.num_attention_heads,
         cfg.num_key_value_heads], launches={k: launches[k] for k in ("flash_attention_quant", "decode_attention_quant")},
         sdpa_calls=sdpa_calls)
    if any(sdpa_calls.values()):
        raise AssertionError(f"slice_kvq256: `sdpa` served attention on a kernel path: {sdpa_calls}")
    del model
    torch.cuda.empty_cache()
    return {f"{k}@256": launches[k] for k in ("flash_attention_quant", "decode_attention_quant")}


# ---------------------------------------------------------------------------
# The rest of auto_model_any: LLaVA, Phi-3-V, Fuyu, ImageBind, OPT, BERT
# ---------------------------------------------------------------------------

LLAVA15_7B = dict(  # llava-hf/llava-1.5-7b-hf config.json
    model_type="llava", image_token_index=32000, vision_feature_layer=-2,
    text_config=dict(model_type="llama", vocab_size=32064, hidden_size=4096, intermediate_size=11008,
                     num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
                     max_position_embeddings=4096, rms_norm_eps=1e-5, rope_theta=10000.0),
    vision_config=dict(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24, num_attention_heads=16,
                       image_size=336, patch_size=14, hidden_act="quick_gelu"))
PHI3V_128K = dict(  # microsoft/Phi-3-vision-128k-instruct config.json; the LongRope factors are synthetic
    model_type="phi3_v", vocab_size=32064, hidden_size=3072, intermediate_size=8192, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=32, max_position_embeddings=131072,
    original_max_position_embeddings=4096, rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
    rope_scaling=dict(type="longrope", short_factor=[1.0 + 0.01 * i for i in range(48)],
                      long_factor=[1.0 + 0.5 * i for i in range(48)]),
    img_processor=dict(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24, num_attention_heads=16,
                       image_size=336, patch_size=14))
FUYU_8B = dict(  # adept/fuyu-8b config.json
    model_type="fuyu", patch_size=30, num_channels=3, image_token_id=71011,
    text_config=dict(model_type="persimmon", vocab_size=262144, hidden_size=4096, intermediate_size=16384,
                     num_hidden_layers=36, num_attention_heads=64, max_position_embeddings=16384,
                     rope_theta=25000.0, partial_rotary_factor=0.5, qk_layernorm=True, hidden_act="relu2",
                     layer_norm_eps=1e-5, tie_word_embeddings=False))
OPT_13B = dict(vocab_size=50272, hidden_size=2048, ffn_dim=8192, num_hidden_layers=24,  # facebook/opt-1.3b
               num_attention_heads=32, max_position_embeddings=2048, do_layer_norm_before=True)
FUYU_IMAGE_HW = (480, 640)  # 16 x 21 patches of 30 px
VL_DECODE_NEW, VL_DECODE_CACHE, VL_DECODE_TEXT = 32, 1024, (20, 10)
OPT_PROMPT = 100
IMAGEBIND_RUNS = 5
ENCODER_TOL = 5e-2  # x max |value|: bf16 on the card against f32 on the host
BERT_SENTENCES, BERT_TOKENS = 8, 64


def decode_run(name: str, model, dev, ids, image_kw: dict, L: int, kernels_expected: bool) -> dict:
    """The reference's decode of a model whose forward is (ids, cache, ...):
    a prefill (with the image in `image_kw`), then VL_DECODE_NEW greedy tokens
    through forward without it, one a call (the token stays on the card); the
    last decode step against a fresh prefill of the prompt and the first
    VL_DECODE_NEW - 1 tokens with the image (<= RAGGED_TOL x max |logit|),
    finite logits, and exact attention launches: with kernels_expected L
    flash_attention a prefill (2) and L decode_attention a step, else none."""
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    ids_d = torch.as_tensor(ids, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        torch.cuda.synchronize()
        start.record()
        logits, cache = model(ids_d, model.init_cache(1, VL_DECODE_CACHE), last_only=True, **image_kw)
        end.record()
        finite = torch.isfinite(logits).all()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        toks = [tok]
        t0 = time.perf_counter()
        for _ in range(VL_DECODE_NEW - 1):
            logits, cache = model(tok, cache, last_only=True)
            finite &= torch.isfinite(logits).all()
            tok = logits[:, -1].argmax(-1, keepdim=True)
            toks.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        toks = torch.cat(toks, 1)[0].tolist()
        full = np.concatenate([np.asarray(ids)[0], np.asarray(toks[:-1])])[None]
        fresh, _ = model(torch.as_tensor(full, device=dev), model.init_cache(1, VL_DECODE_CACHE), last_only=True,
                         **image_kw)
        fresh = fresh[:, -1].float()
        gap = ((logits[:, -1].float() - fresh).abs().max() / fresh.abs().max()).item()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    want = ({"flash_attention": 2 * L, "decode_attention": L * (VL_DECODE_NEW - 1)} if kernels_expected
            else {"flash_attention": 0, "decode_attention": 0})
    want.update({k: 0 for k in ATTENTION_KERNELS if k not in want})
    finite = bool(finite)
    emit(phase=name, prompt_tokens=int(np.asarray(ids).shape[1]), new_tokens=len(toks),
         prefill_ms=start.elapsed_time(end), decode_tok_s=(VL_DECODE_NEW - 1) / decode_s,
         last_decode_vs_prefill=gap, tolerance=RAGGED_TOL, logits_finite=finite,
         launches={k: launches[k] for k in ATTENTION_KERNELS}, launches_expected=want,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(), params=sum(p.numel() for p in model.parameters()))
    if not finite or not gap <= RAGGED_TOL or not all(0 <= t < model_vocab(model) for t in toks):
        raise AssertionError(f"{name}: finite {finite}, decode vs prefill {gap}, tokens {toks}")
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    return {k: launches[k] for k in ("flash_attention", "decode_attention")}


def model_vocab(model) -> int:
    cfg = model.cfg
    return cfg.text.vocab_size if hasattr(cfg, "text") else cfg.vocab_size


def vl_text(rng, vocab: int, image: list) -> np.ndarray:
    """[1, S] ids: VL_DECODE_TEXT random ids around the image positions."""
    a, b = VL_DECODE_TEXT
    return np.concatenate([rng.integers(3, vocab - 100, a), image, rng.integers(3, vocab - 100, b)])[None]


def phase_slice_llava(dev) -> dict:
    """LLaVA-1.5-7B at its published config (LLAVA15_7B: the 32-layer LM of
    4096, 32 / 32 heads of 128; CLIP ViT-L/14 at 336 px, 24 blocks of 1024;
    576 image tokens), random bf16 weights: one 336 px image prefill and 32
    greedy tokens (`decode_run`: the LM's attention on the bf16 kernels)."""
    from mllm_tpu_torch.models.llava import LlavaForConditionalGeneration, llava_config_from_hf

    cfg = llava_config_from_hf(LLAVA15_7B)
    torch.cuda.reset_peak_memory_stats()
    model = LlavaForConditionalGeneration.init(cfg, device=dev, dtype=torch.bfloat16,
                                               generator=torch.Generator(device=dev).manual_seed(41))
    rng = np.random.default_rng(41)
    n_img = (cfg.vision.image_size // cfg.vision.patch_size) ** 2
    ids = vl_text(rng, cfg.text.vocab_size, [cfg.image_token_id] * n_img)
    pixel = torch.as_tensor(rng.standard_normal((1, 3, 336, 336)), dtype=torch.float32, device=dev)
    out = decode_run("slice_llava", model, dev, ids, {"pixel_values": pixel}, cfg.text.num_hidden_layers, True)
    del model
    torch.cuda.empty_cache()
    return out


def phase_slice_phi3v(dev) -> dict:
    """Phi-3-V at microsoft/Phi-3-vision-128k-instruct's widths (PHI3V_128K:
    the Phi-3 LM of 3072, 32 layers, 32 heads of 96, LongRope over 128k
    positions; the same CLIP tower; 157 image tokens after the HD transform),
    random bf16 weights: one 336 px image prefill and 32 greedy tokens. Its
    head_dim 96 takes `sdpa` (no attention kernel), as in the reference."""
    from mllm_tpu_torch.models.phi3v import Phi3VForCausalLM, phi3v_config_from_hf

    cfg = phi3v_config_from_hf(PHI3V_128K)
    torch.cuda.reset_peak_memory_stats()
    model = Phi3VForCausalLM.init(cfg, device=dev, dtype=torch.bfloat16,
                                  generator=torch.Generator(device=dev).manual_seed(42))
    rng = np.random.default_rng(42)
    ids = vl_text(rng, cfg.text.vocab_size, [-1] * model.num_image_tokens)
    pixel = torch.as_tensor(rng.standard_normal((1, 3, 336, 336)), dtype=torch.float32, device=dev)
    out = decode_run("slice_phi3v", model, dev, ids, {"pixel_values": pixel}, cfg.text.num_hidden_layers, False)
    del model
    torch.cuda.empty_cache()
    return out


def phase_slice_fuyu(dev) -> dict:
    """Fuyu-8B at its published config (FUYU_8B: the Persimmon LM of 4096, 36
    layers, 64 heads of 64, ffn 16384, vocab 262144, partial rotary 0.5, q/k
    LayerNorms, relu^2; 30 px patches), random bf16 weights: one 480 x 640
    image (336 patches, patchified on the host) spliced at |SPEAKER| and 32
    greedy tokens, on the bf16 attention kernels."""
    from mllm_tpu_torch.models.fuyu import FuyuForCausalLM, fuyu_config_from_hf, patchify_image

    cfg = fuyu_config_from_hf(FUYU_8B)
    torch.cuda.reset_peak_memory_stats()
    model = FuyuForCausalLM.init(cfg, device=dev, dtype=torch.bfloat16,
                                 generator=torch.Generator(device=dev).manual_seed(43))
    rng = np.random.default_rng(43)
    patches = patchify_image(rng.standard_normal((3, *FUYU_IMAGE_HW)).astype(np.float32), cfg.patch_size)
    ids = vl_text(rng, cfg.text.vocab_size, [cfg.image_token_id] * patches.shape[0])
    out = decode_run("slice_fuyu", model, dev, ids, {"image_patches": torch.as_tensor(patches, device=dev)},
                     cfg.text.num_hidden_layers, True)
    del model
    torch.cuda.empty_cache()
    return out


def host_f32(model):
    """The same weights in f32 on the host (the reference of an encoder's check)."""
    import copy

    return copy.deepcopy(model).float().cpu()


def phase_slice_imagebind(dev) -> dict:
    """bench.py's imagebind-trimodal row: ImageBind-huge (ImageBindConfig()
    defaults: vision 1280 x 32 blocks, text 1024 x 24, audio 768 x 12),
    random bf16 weights (ImageBindModel.init), 1 video x 3 texts (77 tokens,
    12 random, EOT at 12) x 3 audio clips of 128 x 204 fbank bins: both score
    matrices, finite, within ENCODER_TOL x max of the same weights in f32 on
    the host; score ms a median of IMAGEBIND_RUNS CUDA-event-timed calls."""
    from mllm_tpu_torch.models.imagebind import ImageBindConfig, ImageBindModel

    cfg = ImageBindConfig()
    model = ImageBindModel.init(cfg, device=dev, dtype=torch.bfloat16,
                                generator=torch.Generator(device=dev).manual_seed(44))
    rng = np.random.default_rng(0)
    ids = np.zeros((3, cfg.max_positions), np.int64)
    ids[:, :12] = rng.integers(1, cfg.vocab_size - 2, (3, 12))
    eot = np.full((3,), 12, np.int64)
    patches = (rng.standard_normal((1, cfg.vision_seq - 1, 3 * cfg.patch_time * cfg.patch ** 2)) * 0.1).astype(np.float32)
    fbanks = (rng.standard_normal((cfg.audio_clips, 1, cfg.audio_h, cfg.audio_w)) * 0.1).astype(np.float32)
    args = [torch.as_tensor(a) for a in (ids, eot, patches, fbanks)]
    dargs = [a.to(dev) for a in args[:2]] + [a.to(dev, torch.bfloat16) for a in args[2:]]
    with torch.no_grad():
        vt, va = model(*dargs)
        ms = median([event_ms(lambda: model(*dargs)) for _ in range(IMAGEBIND_RUNS)])
        host = host_f32(model)
        rvt, rva = host(*args)
    errs = [((a.float().cpu() - b).abs().max() / b.abs().max()).item() for a, b in ((vt, rvt), (va, rva))]
    finite = bool(torch.isfinite(vt).all() and torch.isfinite(va).all())
    emit(phase="slice_imagebind", vision_x_text=list(vt.shape), vision_x_audio=list(va.shape), score_ms=ms,
         runs=IMAGEBIND_RUNS, rel_err_vs_f32_host=errs, tolerance=ENCODER_TOL, finite=finite,
         params=sum(p.numel() for p in model.parameters()), batch="1 video x 3 texts x 3 audio clips")
    if list(vt.shape) != [1, 3] or list(va.shape) != [1, 1] or not finite or not max(errs) <= ENCODER_TOL:
        raise AssertionError(f"slice_imagebind: shapes {list(vt.shape)} {list(va.shape)}, finite {finite}, "
                             f"vs f32 host {errs}")
    del host
    del model
    torch.cuda.empty_cache()
    return {}


def phase_slice_opt_bert(dev) -> dict:
    """OPT-1.3B (OPT_13B, random bf16 weights) as examples/demo_opt.py drives
    it: a 100-token prefill (bos first) and 32 greedy tokens through forward
    (`decode_run`: head_dim 64 on the bf16 flash and decode kernels, exact
    launches); then BERT-base (BertConfig(): bert-base-uncased's widths)
    encoding BERT_SENTENCES sentences of BERT_TOKENS tokens (valid lengths
    32-64) into sentence embeddings, finite, unit norm, within ENCODER_TOL x
    max of the same weights in f32 on the host; encode ms a median of 5."""
    from mllm_tpu_torch.models.bert import BertConfig, BertModel
    from mllm_tpu_torch.models.opt import OPTForCausalLM, opt_config_from_hf

    cfg = opt_config_from_hf(OPT_13B)
    torch.cuda.reset_peak_memory_stats()
    model = OPTForCausalLM.init(cfg, device=dev, dtype=torch.bfloat16,
                                generator=torch.Generator(device=dev).manual_seed(45))
    rng = np.random.default_rng(45)
    ids = np.concatenate([[cfg.bos_token_id], rng.integers(3, cfg.vocab_size, OPT_PROMPT - 1)])[None]
    out = decode_run("slice_opt", model, dev, ids, {}, cfg.num_hidden_layers, True)
    del model
    torch.cuda.empty_cache()

    bcfg = BertConfig()
    bert = BertModel.init(bcfg, device=dev, dtype=torch.bfloat16, generator=torch.Generator(device=dev).manual_seed(46))
    ids = torch.as_tensor(rng.integers(1000, bcfg.vocab_size, (BERT_SENTENCES, BERT_TOKENS)))
    lens = torch.as_tensor(rng.integers(32, BERT_TOKENS + 1, BERT_SENTENCES))
    mask = (torch.arange(BERT_TOKENS)[None] < lens[:, None]).to(torch.int64)
    with torch.no_grad():
        emb = bert.sentence_embedding(ids.to(dev), mask.to(dev))
        ms = median([event_ms(lambda: bert.sentence_embedding(ids.to(dev), mask.to(dev))) for _ in range(5)])
        ref = host_f32(bert).sentence_embedding(ids, mask)
    err = ((emb.float().cpu() - ref).abs().max() / ref.abs().max()).item()
    norms = torch.linalg.norm(emb.float(), dim=-1)
    finite = bool(torch.isfinite(emb).all())
    emit(phase="slice_bert", sentences=BERT_SENTENCES, tokens=BERT_TOKENS, valid_lengths=lens.tolist(), encode_ms=ms,
         rel_err_vs_f32_host=err, tolerance=ENCODER_TOL, finite=finite, norm_range=[norms.min().item(),
         norms.max().item()], params=sum(p.numel() for p in bert.parameters()))
    if list(emb.shape) != [BERT_SENTENCES, bcfg.hidden_size] or not finite or not err <= ENCODER_TOL or \
            not bool(((norms - 1).abs() < 1e-2).all()):
        raise AssertionError(f"slice_bert: shape {list(emb.shape)}, finite {finite}, vs f32 host {err}, norms {norms}")
    del bert
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The last single-device modules: OpenELM (head_dim 64), MLA (MiniCPM3,
# DeepSeek-V3), elastic and predictor-sparse models, MBP, cache snapshots
# ---------------------------------------------------------------------------

# head_dim 64 at OpenELM-1_1B's widest layer (32 / 8 heads): (B, Sq, q_offset,
# kv_valid, kv_start, window, poisoned) and (B, kv_valid, kv_start, window,
# poisoned) as FLASH_ROWS / DECODE_ROWS, over the 2048-row cache
GEO64 = (32, 8, 64)
FLASH_ROWS_64 = [
    (1, 1536, 0, 1536, None, None, False),                               # a 1500-token prompt's bucket
    (1, 1500, 0, 1500, None, None, False),                               # OpenELM's unpadded 1500-token prefill
    (4, 256, 0, [256, 200, 131, 250], [0, 17, 64, 150], None, True),    # kv_start, stale NaN / inf rows
]
DECODE_ROWS_64 = [
    (4, [1531, 1531, 1531, 1531], None, None, False),                    # the b=4 lockstep decode at 1531 keys
    (4, [1531, 1200, 700, 77], None, None, False),                       # unequal lengths
    (4, [0, 77, 2083, 1531], [0, 13, 100, 700], None, True),            # stale rows; a slot past the cache
    (4, [1, 511, 513, 2048], [0, 3, 7, 9], 256, False),                  # window
    (1, [1531], None, None, False),                                      # B=1: the cluster rule's largest split
    (8, [1, 511, 513, 2048, 100, 1000, 1531, 777], [0, 0, 5, 100, 0, 50, 0, 3], None, False),  # B=8
]


# row_rel_err of the @64 rows: sound kernels read 0.025-0.039, the plain
# version with its last 64 keys dropped 2.35-3.04 (NVIDIA H100 80GB HBM3,
# 700.00 W; head64_gate_power checks the latter each run)
HEAD64_REL_TOL = 0.1


def head_dim64_rows(dev, g) -> dict:
    """flash_attention and decode_attention at head_dim 64 (GEO64: OpenELM-1_1B's
    widest layer) against their plain versions (<= TOL, and <= HEAD64_REL_TOL
    by row_rel_err), timed beside their
    bounds and, on the main rows, SDPA: the `@64` rows of the kernels line,
    whose launches are slice_openelm's."""
    from mllm_tpu_torch.ops.decode_attention import decode_attention, decode_attention_ref
    from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    rows = {"flash_attention@64": attention_rows("flash_attention@64", "flash_attention", flash_attention,
                                                 flash_attention_ref, FLASH_ROWS_64, dev, g, GEO64, HEAD64_REL_TOL),
            "decode_attention@64": attention_rows("decode_attention@64", "decode_attention", decode_attention,
                                                  decode_attention_ref, DECODE_ROWS_64, dev, g, GEO64,
                                                  HEAD64_REL_TOL)}
    head64_gate_power(dev, g)
    for row in NARROW_SCALAR_ROWS:
        device_scalar_row(dev, g, GEO64, row)
    head_dim64_gqa_rows(dev, g)
    return rows


# the head_dim 64 body's persistent grid with a device q_offset (GEO64): a
# 512-row chunk at q_offset 1024 over 1536 keys of the 2048-row cache (128
# units), and the 256-row chunk that `demo_llm --chunked 256` sends at
# q_offset 1280 (64 units, so 64 CTAs), each with the q_offsets its launches
# and replays are given
NARROW_SCALAR_ROWS = [(512, 1536, (1024, 0, 512)), (256, 1536, (1280, 0, 768))]
# flash_attention@64 at the bench's other head_dim 64 models (bench.py):
# TinyLlama-1.1B (32 / 4 heads) and Qwen MoE 0.8B (16 / 8), the 1536-token
# prompt's bucket (FLASH_ROWS_64[0]), each beside SDPA
FLASH64_GQA_GEOS = {"tinyllama-1.1b": (32, 4, 64), "qwen2moe-0.8b": (16, 8, 64)}


def head_dim64_gqa_rows(dev, g) -> list:
    """flash_attention@64 at FLASH64_GQA_GEOS' GQA ratios: the kernel against
    its plain version (<= TOL, <= HEAD64_REL_TOL by row_rel_err), timed beside
    SDPA and the bound."""
    from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    out = []
    row = FLASH_ROWS_64[MAIN_ROW["flash_attention@64"]]
    for model, geo in FLASH64_GQA_GEOS.items():
        q, k, v, kp, vp, kw, shape = attention_inputs("flash_attention", row, dev, g, geo)
        shape["model"] = model
        kvl = shape["kv_valid"]
        library = (lambda q=q, k=k, v=v, kvl=kvl: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :, :kvl], v[:, :, :kvl], is_causal=True, enable_gqa=True))
        out.append(check_attention_row("flash_attention@64", lambda: flash_attention(q, k, v, **kw),
                                       lambda: flash_attention_ref(q, kp, vp, **kw), shape, library,
                                       HEAD64_REL_TOL))
    return out


def head64_gate_power(dev, g) -> None:
    """The @64 gate sees a dropped tile: on each main row, the kernel against
    the plain version over its last 64 valid keys dropped must read more than
    HEAD64_REL_TOL by row_rel_err."""
    from mllm_tpu_torch.ops.decode_attention import decode_attention, decode_attention_ref
    from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    for kind, kernel, plain, row in (("decode_attention", decode_attention, decode_attention_ref, DECODE_ROWS_64[0]),
                                     ("flash_attention", flash_attention, flash_attention_ref, FLASH_ROWS_64[0])):
        q, k, v, kp, vp, kw, shape = attention_inputs(kind, row, dev, g, GEO64)
        short = dict(kw, kv_valid_len=kw["kv_valid_len"] - 64)
        rel = row_rel_err(kernel(q, k, v, **kw), plain(q, kp, vp, **short))
        emit(phase="kernel_check_gate_power", kernel=f"{kind}@64", shape=shape, keys_dropped=64,
             rel_err=rel, rel_tolerance=HEAD64_REL_TOL)
        if not rel > HEAD64_REL_TOL:
            raise AssertionError(f"{kind}@64 {shape}: 64 keys dropped read {rel} by row, within the "
                                 f"tolerance {HEAD64_REL_TOL}: the gate cannot see a dropped tile")


def openelm_1_1b() -> dict:
    """apple/OpenELM-1_1B's config.json fields (model_dim 2048, 28 layers,
    head_dim 64, num_gqa_groups 4, qkv_multipliers [0.5, 1.0],
    ffn_multipliers [0.5, 4.0], ffn_dim_divisor 256, vocab 32000, context
    2048, rope_freq_constant 10000), with the per-layer lists its
    configuration_openelm.py derives: multipliers linspace(lo, hi, 28) rounded
    to 2 places, query heads make_divisible(2048 m, 64 x 4) / 64 (16 to 32),
    KV heads a quarter of them."""
    from mllm_tpu_torch.models.openelm import _make_divisible

    n, dim, hd, groups = 28, 2048, 64, 4
    qkv = [round(float(v), 2) for v in np.linspace(0.5, 1.0, n)]
    q_heads = [_make_divisible(dim * m, hd * groups) // hd for m in qkv]
    return dict(num_transformer_layers=n, model_dim=dim, head_dim=hd, num_query_heads=q_heads,
                num_kv_heads=[q // groups for q in q_heads],
                ffn_multipliers=[round(float(v), 2) for v in np.linspace(0.5, 4.0, n)], ffn_dim_divisor=256,
                vocab_size=32000, max_context_length=2048, rope_freq_constant=10000)


OPENELM_PROMPT, OPENELM_NEW = 1500, 32


def flash64_launches() -> int:
    from mllm_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention.launches_at.get(64, 0)


def openelm_run(model, dev, b: int, rng) -> dict:
    """b prompts of OPENELM_PROMPT tokens through forward (one prefill), then
    OPENELM_NEW - 1 greedy steps one a call, lockstep: exactly L flash @64
    launches the prefill and L decode launches a step, no `sdpa` call; the
    last step within RAGGED_TOL x max |logit| of a fresh prefill of each row's
    prompt and tokens; finite logits, tokens in the vocabulary."""
    from mllm_tpu_torch.nn import attention as A

    kernels = wrappers()
    L, V = model.cfg.num_layers, model.cfg.vocab_size
    ids = torch.as_tensor(rng.integers(3, V, (b, OPENELM_PROMPT)), device=dev)
    with torch.no_grad():  # a warm-up prefill of the same shape (cuBLAS picks its kernels once)
        model(ids, model.init_cache(b, S_CACHE))
    for fn in kernels.values():
        fn.launches = 0
    kernels["flash_attention"].launches_at.clear()
    with counting(A, "sdpa") as sd, torch.no_grad():
        cache = model.init_cache(b, S_CACHE)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = model(ids, cache)
        end.record()
        after_prefill = (flash64_launches(), kernels["decode_attention"].launches)
        finite = torch.isfinite(logits).all()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        toks = [tok]
        t0 = time.perf_counter()
        for _ in range(OPENELM_NEW - 1):
            logits, cache = model(tok, cache)
            finite &= torch.isfinite(logits).all()
            tok = logits[:, -1].argmax(-1, keepdim=True)
            toks.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        steps = (flash64_launches(), kernels["decode_attention"].launches)
        toks = torch.cat(toks, 1)
        full = torch.cat([ids, toks[:, :-1]], 1)
        fresh, _ = model(full, model.init_cache(b, S_CACHE))
        fresh = fresh[:, -1].float()
        gap = ((logits[:, -1].float() - fresh).abs().amax(-1) / fresh.abs().amax(-1)).max().item()
    torch.cuda.synchronize()
    out = dict(phase="slice_openelm", batch=b, prompt_tokens=OPENELM_PROMPT, new_tokens=toks.shape[1],
               prefill_ms=start.elapsed_time(end), decode_tok_s=b * (OPENELM_NEW - 1) / decode_s,
               last_decode_vs_prefill=gap, tolerance=RAGGED_TOL, logits_finite=bool(finite),
               flash64_after_prefill=after_prefill[0], decode_after_prefill=after_prefill[1],
               flash64_after_steps=steps[0], decode_after_steps=steps[1], sdpa_calls=sd.calls,
               expected=dict(flash64_per_prefill=L, decode_per_step=L))
    emit(**out)
    in_vocab = bool(((toks >= 0) & (toks < V)).all())
    if not out["logits_finite"] or not gap <= RAGGED_TOL or not in_vocab:
        raise AssertionError(f"slice_openelm b={b}: finite {finite}, decode vs prefill {gap}, in vocab {in_vocab}")
    if after_prefill != (L, 0) or steps != (L, L * (OPENELM_NEW - 1)) or sd.calls:
        raise AssertionError(f"slice_openelm b={b}: launches after the prefill {after_prefill}, after the steps "
                             f"{steps} (expected ({L}, 0), ({L}, {L * (OPENELM_NEW - 1)})), sdpa calls {sd.calls}")
    return {"flash_attention@64": flash64_launches(), "decode_attention@64": kernels["decode_attention"].launches}


def openelm_contiguity(model, dev) -> dict:
    """The live KV heads of a padded layer at b=4 (layer 0: 4 of 8 heads, a
    strided view) are copied contiguous before the kernels; a batch stride
    in the kernels would read the same bytes in place. Times, at the b=4
    decode step over 1531 keys and the b=4 prefill of 1500 tokens: the two
    copies (K and V), and each kernel over the copied heads, which is what a
    strided kernel would cost at best."""
    from mllm_tpu_torch.ops.decode_attention import decode_attention
    from mllm_tpu_torch.ops.flash_attention import flash_attention

    g = torch.Generator(device=dev).manual_seed(64)
    n_kv, n_q, hd = model.cfg.num_kv_heads[0], model.cfg.num_query_heads[0], model.cfg.head_dim
    k_layer = torch.randn(4, model.n_kv_max, S_CACHE, hd, device=dev, generator=g).to(torch.bfloat16)
    v_layer = torch.randn(4, model.n_kv_max, S_CACHE, hd, device=dev, generator=g).to(torch.bfloat16)
    kc, vc = k_layer[:, :n_kv].contiguous(), v_layer[:, :n_kv].contiguous()
    q1 = torch.randn(4, 1, n_q, hd, device=dev, generator=g).to(torch.bfloat16)
    qp = torch.randn(4, OPENELM_PROMPT, n_q, hd, device=dev, generator=g).to(torch.bfloat16)
    kvl = torch.full((4,), 1531, dtype=torch.int32, device=dev)
    copy_ms = time_ms(lambda: (k_layer[:, :n_kv].contiguous(), v_layer[:, :n_kv].contiguous()), 20)
    decode_ms = time_ms(lambda: decode_attention(q1, kc, vc, kv_valid_len=kvl), 20)
    flash_ms = time_ms(lambda: flash_attention(qp, kc, vc, kv_valid_len=OPENELM_PROMPT), 10)
    padded = sum(1 for n in model.cfg.num_kv_heads if n < model.n_kv_max)
    out = dict(phase="slice_openelm_contiguity", batch=4, layer_heads=[n_q, n_kv], n_kv_max=model.n_kv_max,
               cache_rows=S_CACHE, copy_ms=copy_ms, decode_kernel_ms=decode_ms, flash_kernel_ms=flash_ms,
               padded_layers=padded, copies_ms_per_step=copy_ms * padded,
               note="copy: the live heads of a padded layer copied contiguous (the port's choice); a batch-strided "
                    "kernel would cost at least the kernel over the copy")
    emit(**out)
    return out


def phase_slice_openelm(dev) -> dict:
    """OpenELM-1_1B (`openelm_1_1b`: full width and depth, random bf16 weights)
    at b=1 and at b=4 lockstep (`openelm_run`: where the narrower layers'
    live KV heads are copied contiguous), then the copy's cost beside the
    kernels' (`openelm_contiguity`). Returns the @64 rows' launches."""
    from mllm_tpu_torch.models.openelm import OpenELMConfig, OpenELMForCausalLM

    cfg = OpenELMConfig.from_hf(openelm_1_1b())
    model = OpenELMForCausalLM.init(cfg, device=dev, dtype=torch.bfloat16,
                                    generator=torch.Generator(device=dev).manual_seed(47))
    emit(phase="slice_openelm_model", layers=cfg.num_layers, query_heads=list(cfg.num_query_heads),
         kv_heads=list(cfg.num_kv_heads), ffn_dims=list(cfg.ffn_dims), params=sum(p.numel() for p in model.parameters()),
         weight_bytes=state_bytes(model))
    rng = np.random.default_rng(47)
    launches = {}
    for b in (1, 4):
        add_launches(launches, openelm_run(model, dev, b, rng))
    openelm_contiguity(model, dev)
    del model
    torch.cuda.empty_cache()
    return launches


MINICPM3_4B = dict(  # openbmb/MiniCPM3-4B config.json (its LongRope scaling is not read)
    model_type="minicpm3", vocab_size=73448, hidden_size=2560, intermediate_size=6400, num_hidden_layers=62,
    num_attention_heads=40, num_key_value_heads=40, max_position_embeddings=32768, rope_theta=10000.0,
    q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64,
    scale_emb=12, scale_depth=1.4, dim_model_base=256, hidden_act="silu", rms_norm_eps=1e-5,
    tie_word_embeddings=False, eos_token_id=-2)
DEEPSEEK_V3_2L = dict(  # deepseek-ai/DeepSeek-V3 config.json; depth 61 -> 2, first_k_dense_replace 3 -> 1
    model_type="deepseek_v3", vocab_size=129280, hidden_size=7168, intermediate_size=18432,
    moe_intermediate_size=2048, num_hidden_layers=2, num_attention_heads=128, num_key_value_heads=128,
    n_shared_experts=1, n_routed_experts=256, routed_scaling_factor=2.5, kv_lora_rank=512, q_lora_rank=1536,
    qk_rope_head_dim=64, v_head_dim=128, qk_nope_head_dim=128, n_group=8, topk_group=4, num_experts_per_tok=8,
    first_k_dense_replace=1, norm_topk_prob=True, hidden_act="silu", max_position_embeddings=163840,
    rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=False, eos_token_id=-2)
GEN_NEW = 32
MINICPM3_PROMPT, V3_PROMPT = 1500, 512


def tf_gap(model, dev, prompt, toks, cache_fn) -> float:
    """teacher_forced_gap over a cache from cache_fn()."""
    ids = np.concatenate([np.asarray(prompt), np.asarray(toks[:-1])])
    with torch.no_grad():
        logits, _ = model(torch.as_tensor(ids[None], device=dev), cache_fn(), last_only=False)
    lg = logits[0, len(prompt) - 1 :].float()
    chosen = lg.gather(1, torch.as_tensor(np.asarray(toks), device=dev)[:, None])[:, 0]
    return ((lg.max(-1).values - chosen) / lg.abs().max(-1).values).max().item()


def gen_pair(name: str, model, dev, prompt, cache_fn, expected_eager=None, **fields) -> dict:
    """generate (eager) and generate_compiled (GEN_NEW greedy tokens, timed on
    its second call, after the first's eager step and capture) on one model:
    finite logits, the last eager step within RAGGED_TOL x max |logit| of a
    fresh prefill, compiled tokens equal to the eager ones up to near-ties
    (a divergence must sit within RAGGED_TOL of the top of a teacher-forced
    prefill), every token in the vocabulary; the eager generate's launches
    exactly `expected_eager(prefills=1, steps)` where given. Prints tok/s of
    both over wall time (the prefill included), the compiled loop's device
    ms a step (CUDA events around one replay / COMPILED_WINDOW), the time to
    first token (after a warm-up generate at the prompt's shape) and peak
    memory; returns the launches of the phase on the card."""
    from mllm_tpu_torch.generation import graphs
    from mllm_tpu_torch.generation.generate import (COMPILED_WINDOW, generate, generate_compiled, pad_to_bucket,
                                                    prefill)
    from mllm_tpu_torch.generation.sampling import SamplingConfig

    scfg = SamplingConfig(max_new_tokens=GEN_NEW)
    V = model.cfg.vocab_size
    generate(model, prompt, cache_fn(), SamplingConfig(max_new_tokens=2))  # warm-up at the prompt's shape
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    graphs.reset_counts()
    spy, restore = logits_spy(model, dev)
    (res, _), t_eager = timed(lambda: generate(model, prompt, cache_fn(), scfg))
    restore()
    eager = {k: fn.launches for k, fn in kernels.items()}
    finite = bool(spy["finite"])
    ids = np.concatenate([prompt, res.tokens[:-1]])
    with torch.no_grad():
        fresh, _ = prefill(model, cache_fn(), torch.as_tensor(pad_to_bucket(ids[None]), device=dev), len(ids))
    fresh = fresh.float()
    gap = ((spy["last"][:, -1].float() - fresh).abs().max() / fresh.abs().max()).item()

    def compiled():
        toks, n = generate_compiled(model, pad_to_bucket(prompt[None]), cache_fn(), len(prompt), GEN_NEW, scfg)
        return toks.cpu().numpy()[: int(n)].tolist()

    compiled()
    toks, t_graph = timed(compiled)
    torch.cuda.synchronize()
    on_card = graphs.device_launches({k: fn.launches for k, fn in kernels.items()})
    step_ms = replay_ms("generate_compiled") / COMPILED_WINDOW
    div = first_divergence(toks, res.tokens)
    gap_tf = None if div < 0 else tf_gap(model, dev, prompt, toks, cache_fn)
    want = expected_eager(1, len(res.tokens) - 1) if expected_eager else None
    out = dict(phase=name, prompt_tokens=len(prompt), new_tokens=[len(res.tokens), len(toks)],
               prefill_ms=res.ttft_s * 1e3, eager_decode_tok_s=res.decode_tps, compiled_tok_s=len(toks) / t_graph,
               compiled_device_ms_per_step=step_ms,
               compiled_equals_eager=div < 0, first_divergence=div, compiled_teacher_forced_gap=gap_tf,
               last_decode_vs_prefill=gap, tolerance=RAGGED_TOL, logits_finite=finite,
               eager_launches={k: n for k, n in eager.items() if n}, eager_launches_expected=want,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(), **fields)
    emit(**out)
    in_vocab = all(0 <= t < V for t in res.tokens + toks)
    if not finite or not gap <= RAGGED_TOL or not in_vocab or len(toks) != GEN_NEW or \
            (div >= 0 and not gap_tf <= RAGGED_TOL):
        raise AssertionError(f"{name}: finite {finite}, decode vs prefill {gap}, in vocab {in_vocab}, "
                             f"compiled {toks} vs eager {res.tokens} (teacher-forced gap {gap_tf})")
    if want is not None and any(eager.get(k, 0) != n for k, n in want.items()):
        raise AssertionError(f"{name}: eager launches {eager}, expected {want}")
    # the fresh prefill's launches are on the card too
    return add_launches(dict(on_card), {k: n for k, n in eager.items()})


def phase_slice_deepseek(dev) -> dict:
    """MLA on the card: MiniCPM3-4B (MINICPM3_4B, full width and depth) with a
    1500-token prompt, then DeepSeek-V3's widths at depth 2 (DEEPSEEK_V3_2L:
    layer 0 dense, layer 1 the 256-expert MoE layer with the shared expert and
    group-limited routing over a random non-zero correction bias) with a
    512-token prompt, each through generate and generate_compiled
    (`gen_pair`), random bf16 weights. Attention is the port's `sdpa` (K 96 /
    V 64 and K 192 / V 128: no kernel), so no attention kernel launches.
    Prints weight bytes and peak memory; frees each model before the next."""
    from mllm_tpu_torch.models.deepseek import DeepseekForCausalLM, deepseek_config_from_hf, minicpm3_config_from_hf

    launches = {}
    rng = np.random.default_rng(48)
    for name, raw, reader, n_prompt, cut in (
            ("slice_deepseek_minicpm3_4b", MINICPM3_4B, minicpm3_config_from_hf, MINICPM3_PROMPT,
             "none; LongRope not read"),
            ("slice_deepseek_v3_2l", DEEPSEEK_V3_2L, deepseek_config_from_hf, V3_PROMPT,
             "depth 61 -> 2, first_k_dense_replace 3 -> 1")):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        text, mla, moe_cfg = reader(raw)
        model = DeepseekForCausalLM.init(text, mla, moe_cfg, device=dev, dtype=torch.bfloat16,
                                         generator=torch.Generator(device=dev).manual_seed(48))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        got = gen_pair(name, model, dev, rng.integers(0, text.vocab_size, n_prompt),
                       lambda: model.init_cache(1, S_CACHE),
                       lambda prefills, steps: {k: 0 for k in ATTENTION_KERNELS},
                       layers=text.num_hidden_layers, head_dims=[mla.qk_head_dim, mla.v_head_dim],
                       weight_bytes=state_bytes(model), init_seconds=init_s, cut=cut)
        add_launches(launches, got)
        del model
        torch.cuda.empty_cache()
    return launches


ELASTIC_PROMPT = 1500


def phase_slice_elastic(dev) -> dict:
    """The Qwen2-VL-2B LM (QWEN2VL_2B_LM, full depth, random bf16 weights):
    elastic_model(1.0, 1.0) gives prefill logits bit-equal to the model's;
    the full model, elastic_model(0.5, 0.5) (6 / 1 heads, FFN 4480) and
    sparse_model(threshold 0.0, make_predictors rank 128) in bf16, then
    quantize_model("int8", on_device=True) on the model (projections not
    fused) and elastic_model(0.5, 0.5) of it, each through `gen_pair` (a
    1500-token prompt, 32 tokens): exact flash / decode launches a prefill
    and a step, and for the int8 elastic model exactly 7 int8_matmul
    launches a layer and one for the head a forward, its int8 weights at the
    sliced shapes only."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.models.elastic import elastic_model, make_predictors, sparse_model
    from mllm_tpu_torch.ops.quantize_model import quantize_model

    cfg = TextConfig(**QWEN2VL_2B_LM)
    L = cfg.num_hidden_layers
    model = init_model(cfg, dev)
    rng = np.random.default_rng(49)
    prompt = rng.integers(0, cfg.vocab_size, ELASTIC_PROMPT)
    ids = torch.as_tensor(prompt[None, :128], device=dev)
    with torch.no_grad():
        same = torch.equal(elastic_model(model, 1.0, 1.0)(ids, model.init_cache(1, S_CACHE), last_only=False)[0],
                           model(ids, model.init_cache(1, S_CACHE), last_only=False)[0])
    emit(phase="slice_elastic_ratio1", bit_equal=same)
    if not same:
        raise AssertionError("slice_elastic: elastic_model(1.0, 1.0) logits differ from the model's")

    def attention(prefills, steps):
        return {"flash_attention": L * prefills, "decode_attention": L * steps}

    launches = {}
    runs = (("full", lambda m: m), ("elastic_0.5", lambda m: elastic_model(m, 0.5, 0.5)),
            ("sparse_0.0", lambda m: sparse_model(m, make_predictors(
                m, 128, torch.Generator(device=dev).manual_seed(50)), 0.0)))
    for tag, make in runs:
        m = make(model)
        add_launches(launches, gen_pair(f"slice_elastic_{tag}", m, dev, prompt, lambda m=m: m.init_cache(1, S_CACHE),
                                        attention, heads=[m.cfg.num_attention_heads, m.cfg.num_key_value_heads],
                                        ffn=m.blocks[0].mlp.gate_proj.weight.shape[0]))
        del m
    quantize_model(model, "int8", on_device=True)
    el8 = elastic_model(model, 0.5, 0.5)
    def int8(prefills, steps):
        return {**attention(prefills, steps), "int8_matmul": (7 * L + 1) * (prefills + steps)}

    got = gen_pair("slice_elastic_int8_0.5", el8, dev, prompt, lambda: el8.init_cache(1, S_CACHE), int8,
                   heads=[el8.cfg.num_attention_heads, el8.cfg.num_key_value_heads],
                   ffn=el8.blocks[0].mlp.gate_proj.qweight_t.shape[1])
    shapes = {tuple(m.qweight_t.shape) for m in el8.modules() if hasattr(m, "qweight_t")}
    d, hd, ffn = cfg.hidden_size, cfg.head_dim_, el8.blocks[0].mlp.gate_proj.qweight_t.shape[1]
    q, kv = el8.cfg.num_attention_heads * hd, el8.cfg.num_key_value_heads * hd
    want = {(d, q), (d, kv), (q, d), (d, ffn), (ffn, d), (d, cfg.vocab_size)}
    emit(phase="slice_elastic_int8_shapes", weight_shapes=sorted(shapes), expected=sorted(want))
    if shapes != want:
        raise AssertionError(f"slice_elastic int8: int8 weight shapes {sorted(shapes)}, expected {sorted(want)}")
    add_launches(launches, got)
    del el8, model
    torch.cuda.empty_cache()
    return launches


MBP_LAYERS, MBP_PROMPT, MBP_NEW = 4, 128, 32
# each step's logits against the resident model routed onto MBP's experts, x
# max |logit|: sound runs read 0.0055-0.0065, while a step with 3 experts
# flipped reads 0.0796 against the unforced resident model (NVIDIA H100 80GB
# HBM3, 700.00 W)
MBP_FORCED_TOL = 1e-2


class RouteTap:
    """Patches `models.moe.route` (the resident MoEMLP's and MBP's router)
    while entered: records each call's (top_p, top_i) in `calls`, or, given
    `replay` (such a list), keeps the call's own softmax but takes the
    experts of the replayed call in the same order, their probabilities
    renormalised as the router does."""

    def __init__(self, replay=None):
        self.calls, self.replay = [], replay

    def __enter__(self):
        from mllm_tpu_torch.models import moe
        from mllm_tpu_torch.nn.layers import matmul_f32

        self.moe, self.route = moe, moe.route

        def tapped(xf, router_weight, top_k, norm_topk_prob):
            if self.replay is None:
                top_p, top_i = self.route(xf, router_weight, top_k, norm_topk_prob)
            else:
                top_i = self.replay[len(self.calls)][1]
                top_p = torch.softmax(matmul_f32(xf, router_weight), dim=-1).gather(1, top_i)
                if norm_topk_prob:
                    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
            self.calls.append((top_p, top_i))
            return top_p, top_i

        moe.route = tapped
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def route_flips(a: list, b: list) -> int:
    """Tokens, over all layers of one step, whose routed expert sets differ."""
    return sum(int((x[1].sort(-1).values != y[1].sort(-1).values).any(-1).sum()) for x, y in zip(a, b))


def phase_slice_mbp(dev) -> dict:
    """Qwen1.5-MoE-A2.7B's widths (QWEN15_MOE_A27B, depth 24 -> 4: 60 experts
    of 2048 x 1408, top-4, the shared expert 5632 with its sigmoid gate;
    random bf16 weights) through to_mbp with 16 and with 4 device entries
    (the experts in pinned host memory, ~4.2 GB): a 128-token prompt and 32
    greedy tokens through mbp_forward. Every step's logits within RAGGED_TOL
    x max |logit| of the resident model's forward on the same tokens, and
    within MBP_FORCED_TOL of the resident model routed onto MBP's experts
    (RouteTap): the two differ by rounding alone there (MBP sums the experts
    in f32, the resident model in bf16), which in the free run also flips
    near-tied top-k choices (`route_flips` per step). Prints the hit rate,
    the bytes copied to the card and ms a token. Host-driven by design: no
    speed is claimed."""
    from mllm_tpu_torch.models.moe import mbp_forward, to_mbp

    def step_err(lg, ref):
        ref = ref[:, -1].float()
        return ((lg[:, -1].float() - ref).abs().max() / ref.abs().max()).item()

    cfg, model = moe_model({**QWEN15_MOE_A27B, "num_hidden_layers": MBP_LAYERS}, dev, "bf16", shared_gate=True)
    ids = torch.as_tensor(np.random.default_rng(51).integers(0, cfg.vocab_size, (1, MBP_PROMPT)), device=dev)
    launches = {}
    for entries in (16, 4):
        t0 = time.perf_counter()
        mb, store = to_mbp(model, max_device_entries=entries)
        setup_s = time.perf_counter() - t0
        kernels = wrappers()
        for fn in kernels.values():
            fn.launches = 0
        free, forced, flips, finite, toks = [], [], [], True, []
        with torch.no_grad():
            cache, ref_cache, forced_cache = (m.init_cache(1, S_CACHE) for m in (mb, model, model))
            x, t_mbp = ids, 0.0
            for step in range(MBP_NEW):
                with RouteTap() as tap:
                    (lg, cache), dt = timed(lambda x=x, cache=cache: mbp_forward(mb, x, cache))
                t_mbp += dt if step else 0.0
                with RouteTap() as free_tap:
                    ref, ref_cache = model(x, ref_cache)
                with RouteTap(replay=tap.calls):
                    ref_forced, forced_cache = model(x, forced_cache)
                free.append(step_err(lg, ref))
                forced.append(step_err(lg, ref_forced))
                flips.append(route_flips(tap.calls, free_tap.calls))
                finite &= bool(torch.isfinite(lg).all())
                x = lg[:, -1].argmax(-1, keepdim=True)
                toks.append(int(x))
        store.wait()
        out = dict(phase="slice_mbp", max_device_entries=entries, layers=MBP_LAYERS, experts=cfg.num_experts,
                   host_expert_bytes=sum(t.numel() * t.element_size() for ts in store.host.values() for t in ts),
                   setup_seconds=setup_s, prompt_tokens=MBP_PROMPT, new_tokens=len(toks), hits=store.hits,
                   misses=store.misses, hit_rate=store.hit_rate, bytes_copied=store.bytes_copied,
                   decode_ms_per_token=t_mbp / (MBP_NEW - 1) * 1e3, max_step_vs_resident=max(free),
                   tolerance=RAGGED_TOL, max_step_vs_forced_routing=max(forced), forced_tolerance=MBP_FORCED_TOL,
                   step_vs_resident=free, step_vs_forced_routing=forced, route_flips_per_step=flips,
                   max_step_vs_resident_without_flips=max([e for e, f in zip(free, flips) if not f], default=None),
                   logits_finite=finite, depth_cut=f"{QWEN15_MOE_A27B['num_hidden_layers']} -> "
                   f"{MBP_LAYERS} layers; widths as published", launches={k: f.launches for k, f in kernels.items() if f.launches})
        emit(**out)
        if (not finite or not max(free) <= RAGGED_TOL or not max(forced) <= MBP_FORCED_TOL
                or not all(0 <= t < cfg.vocab_size for t in toks)):
            raise AssertionError(f"slice_mbp entries={entries}: finite {finite}, vs resident {max(free)}, "
                                 f"vs forced routing {max(forced)}, tokens {toks}")
        add_launches(launches, {k: f.launches for k, f in kernels.items()})
        del mb, store
    del model
    torch.cuda.empty_cache()
    return launches


PERSIST_PROMPT, PERSIST_HALF = 1500, 8
PERSIST_DIR = "build/smoke_persist"


def phase_slice_persist(dev) -> dict:
    """The main-geometry LM (QWEN2VL_2B_LM, bf16) over a dense cache and over
    an int8 cache (flash_attention_quant / decode_attention_quant): a
    1500-token prompt and 8 greedy tokens, save_cache with the tokens in
    `extra`, load_cache onto the card, 8 more tokens; token-identical to an
    uninterrupted 16-token run. A SlotKVCache round trip bit-equal.
    Profiler.report of the uninterrupted bf16 run's figures; torch_trace
    over 4 decode steps writes a non-empty trace with CUDA kernels in it;
    cost_table of one eager decode step's aten part (the attention kernel
    is a CUDA extension it does not see) against the H100's peaks."""
    import os

    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.generation.generate import decode_step, generate
    from mllm_tpu_torch.generation.sampling import SamplingConfig
    from mllm_tpu_torch.kv.cache import SlotKVCache
    from mllm_tpu_torch.kv.persist import load_cache, save_cache
    from mllm_tpu_torch.utils.metrics import cost_table
    from mllm_tpu_torch.utils.profiling import Profiler, torch_trace

    os.makedirs(PERSIST_DIR, exist_ok=True)
    cfg = TextConfig(**QWEN2VL_2B_LM)
    t0 = time.perf_counter()
    model = init_model(cfg, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prompt = np.random.default_rng(52).integers(0, cfg.vocab_size, PERSIST_PROMPT)
    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    results = {}
    with torch.no_grad():
        for kv in ("bf16", "int8"):
            whole, _ = generate(model, prompt, model.init_cache(1, S_CACHE, kv_dtype=kv),
                                SamplingConfig(max_new_tokens=2 * PERSIST_HALF))
            first, cache = generate(model, prompt, model.init_cache(1, S_CACHE, kv_dtype=kv),
                                    SamplingConfig(max_new_tokens=PERSIST_HALF))
            path = os.path.join(PERSIST_DIR, f"state_{kv}.npz")
            (_, save_s) = timed(lambda: save_cache(path, cache, extra={"tokens": np.asarray(first.tokens)}))
            (restored, extras), load_cache_s = timed(lambda: load_cache(path, extra_keys=("tokens",), device=dev))
            toks = [int(t) for t in extras["tokens"]]
            for _ in range(PERSIST_HALF):
                logits, restored = decode_step(model, restored, torch.tensor([toks[-1]], device=dev))
                toks.append(int(logits[0].argmax()))
            results[kv] = dict(cache=type(restored).__name__, equal=toks == whole.tokens,
                               first_divergence=first_divergence(toks, whole.tokens), file_bytes=os.path.getsize(path),
                               save_s=save_s, load_s=load_cache_s, head_on=str(restored.pos.device))
            if kv == "bf16":
                prof = Profiler(load_s=load_s, prefill_tps=whole.prefill_tps, ttft_s=whole.ttft_s,
                                decode_tps=whole.decode_tps)
        g = torch.Generator(device=dev).manual_seed(53)
        slot = SlotKVCache(torch.randn(2, 4, 2, 256, 128, device=dev, generator=g).to(torch.bfloat16),
                           torch.randn(2, 4, 2, 256, 128, device=dev, generator=g).to(torch.bfloat16),
                           torch.tensor([3, 250, 0, 17], dtype=torch.int32, device=dev))
        save_cache(os.path.join(PERSIST_DIR, "slot.npz"), slot)
        back, _ = load_cache(os.path.join(PERSIST_DIR, "slot.npz"), device=dev)
        slot_equal = all(torch.equal(getattr(back, n), getattr(slot, n)) and getattr(back, n).dtype ==
                         getattr(slot, n).dtype for n in ("k", "v", "pos"))
        launches = {k: f.launches for k, f in kernels.items()}
        prof.report(f"slice_persist: the uninterrupted bf16 run ({torch.cuda.get_device_name(dev)}, random weights)")
        _, cache = generate(model, prompt, model.init_cache(1, S_CACHE), SamplingConfig(max_new_tokens=2))
        tok = torch.tensor([1], device=dev)
        with torch_trace(os.path.join(PERSIST_DIR, "trace")) as trace_path:
            for _ in range(4):
                _, cache = decode_step(model, cache, tok)
        with open(trace_path) as f:
            events = json.load(f).get("traceEvents", [])
        gpu_kernels = sum(1 for e in events if e.get("cat") == "kernel")
        costs = cost_table(lambda: decode_step(model, cache, tok))
    emit(phase="slice_persist", prompt_tokens=PERSIST_PROMPT, runs=results, slot_round_trip_bit_equal=slot_equal,
         trace_bytes=os.path.getsize(trace_path), trace_events=len(events), trace_gpu_kernels=gpu_kernels,
         cost_table_one_step=costs, launches={k: n for k, n in launches.items() if n})
    shutil.rmtree(PERSIST_DIR, ignore_errors=True)
    if not all(r["equal"] for r in results.values()) or not slot_equal:
        raise AssertionError(f"slice_persist: resumed runs {results}, slot round trip {slot_equal}")
    if not events or not gpu_kernels or not costs["flops"] > 0:
        raise AssertionError(f"slice_persist: trace events {len(events)}, GPU kernels {gpu_kernels}, costs {costs}")
    if not launches["flash_attention_quant"] or not launches["decode_attention_quant"]:
        raise AssertionError(f"slice_persist: the int8 cache did not reach its kernels: {launches}")
    del model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Training and the parallel axes
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 2, 512, 8, 2e-3
TRAIN_DIR = "build/smoke_train"
TRAIN_NEW = 16
REMAT_TOL = 1e-2  # x max |grad|: the two backwards round the recomputed activations alike, not bitwise
MERGE_TOL = 0.1  # x max |logit|
MERGE_GAP_TOL = 0.05  # x the adapted-vs-base gap: the merge read 0.0037, the adapters at half scale 0.255
PAR_LAYERS = 4  # depth of the parallel phase's train / pipeline / sequence models (full width)
PAR_TOL = 2e-2  # x max |.|: bf16 through f32 attention against the flash kernel, or one bf16 rounding apart
SGD_LR = 1.0  # the f32 SGD comparison's rate: every update far above an ulp of its weight
SGD_TOL = 1e-2  # x max |update| of each parameter (floored at SGD_FLOOR x the largest): a zero or doubled gradient reads 1
SGD_FLOOR = 1e-4  # parameters updated less (k_proj.bias: no gradient in exact arithmetic) are held to that floor
ENGINE_TP_LENS = (17, 40, 64, 100, 128, 150, 200, 256)
ENGINE_TP_NEW = 32
PAR_PAGED_SHORT = 4  # the TP paged run's pool: this many blocks short of what the 8 requests reserve together
PAR_VL_IMAGES = 2  # image requests of the TP VL run (VL_ENGINE_PX px, 278 prompt tokens each) ...
PAR_VL_TEXT_LENS = (17, 100, 200, 64)  # ... before the 1st and 3rd of these text requests
# the head splits of tensor-parallel serving at head_dim 128: Qwen2-VL-2B's 12 / 2 heads at tp 2 (6 / 1 a
# rank) and, padded to 12 / 4 by pad_heads_for_tp, at tp 4 (3 / 1 a rank); the kernel check's rows of
# the 1536-token prefill and the engine's batched admission (flash), the 1531-key step and 8 slots at
# unequal lengths (decode), the engine's 8 slots (paged)
TP_SPLIT_GEOS = {"qwen2vl-2b tp2": (6, 1, 128), "qwen2vl-2b padded tp4": (3, 1, 128)}
TP_SPLIT_ROWS = {"flash_attention": (5, 6), "decode_attention": (1, 4), "decode_attention_paged": (0,)}


def tp_split_rows(dev, g) -> dict:
    """flash_attention, decode_attention and decode_attention_paged at the
    TP_SPLIT_GEOS head counts against their plain versions (<= TOL), timed
    beside their bounds and SDPA (on each kernel's main row) or the dense
    kernel over the same keys (paged). The rows go after each kernel's own,
    so its main row stays."""
    from mllm_tpu_torch.ops.decode_attention import (decode_attention, decode_attention_paged,
                                                     decode_attention_paged_ref, decode_attention_ref)
    from mllm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {name: [] for name in TP_SPLIT_ROWS}
    for split, geo in TP_SPLIT_GEOS.items():
        for name, kernel, plain, table in (("flash_attention", flash_attention, flash_attention_ref, FLASH_ROWS),
                                           ("decode_attention", decode_attention, decode_attention_ref,
                                            DECODE_ROWS)):
            for i in TP_SPLIT_ROWS[name]:
                q, k, v, kp, vp, kw, shape = attention_inputs(name, table[i], dev, g, geo)
                shape["tp_split"] = split
                library = None
                if i == MAIN_ROW[name]:
                    kvl = shape["kv_valid"] if name == "flash_attention" else shape["kv_valid"][0]
                    library = (lambda q=q, k=k, v=v, kvl=kvl, causal=name == "flash_attention": sdpa(
                        q.transpose(1, 2), k[:, :, :kvl], v[:, :, :kvl], is_causal=causal, enable_gqa=True))
                rows[name].append(check_attention_row(name, lambda: kernel(q, k, v, **kw),
                                                      lambda: plain(q, kp, vp, **kw), shape, library))
        for i in TP_SPLIT_ROWS["decode_attention_paged"]:
            q, kp, vp, table, kw, shape, (kpp, vpp), (kd, vd) = paged_inputs(PAGED_ROWS[i], dev, g, geo)
            shape["tp_split"] = split
            m = decode_mask(dev, kw["kv_valid_len"].tolist(), kd.shape[2], window=PAGED_ROWS[i][2])
            rows["decode_attention_paged"].append(check_kv_row(
                "decode_attention_paged", lambda: decode_attention_paged(q, kp, vp, table, **kw),
                lambda: decode_attention_paged_ref(q, kpp, vpp, table, **kw), shape, None,
                lambda: sdpa(q.transpose(1, 2), kd, vd, attn_mask=m, enable_gqa=True),
                {"dense_decode_ms": lambda: decode_attention(q, kd, vd, **kw)}))
    return rows


# the int4 cuts of tensor-parallel serving at the same splits (Qwen2-VL-2B int4, heads padded as above):
# per rank the fused q||k||v (column cut, N (6 + 2) x 128 = 1024 at tp 2, (3 + 2) x 128 = 640 at tp 4),
# o_proj (row cut, K 768 / 384), the tied head's proj (column cut of the 512-padded vocab 152064, N 76032
# / 38016) and the fused MLP (F 4480 / 2240, block_f 896 / 448), at the engine's decode m = 1 and 8
TP_INT4_SPLITS = {"qwen2vl-2b tp2": (2, 12, 2), "qwen2vl-2b padded tp4": (4, 12, 4)}  # tp, q heads, kv heads
TP_INT4_M = (1, 8)
VOCAB_PADDED = 152064  # 151936 padded to a multiple of 512 (Int4EmbedHead)


def split_rel_err(parts, whole) -> float:
    """max |assembled ranks - whole| / max |whole| (f32)."""
    return float((parts.float() - whole.float()).abs().max() / whole.float().abs().max())


def tp_int4_split_rows(dev, g) -> dict:
    """int4_matmul and fused_int4_mlp at the TP_INT4_SPLITS rank shapes, the
    ranks' operands cut from full-width weights by the port's pure cuts
    (`column_shard`, `row_shard`, `fused_mlp_shard`): every rank against its
    plain version (QUANT_TOL), and the ranks together against the unsplit
    kernel on the same x (the column outputs side by side, the row and MLP
    partials summed in f32; `whole_rel_err` <= QUANT_TOL). Rank 0's row is
    timed beside its bound and torch._weight_int4pack_mm on its operands."""
    from mllm_tpu_torch.nn.layers import Int4Linear
    from mllm_tpu_torch.ops import quant_matmul as qm
    from mllm_tpu_torch.ops.fused_mlp import fused_int4_mlp, fused_int4_mlp_ref, pick_block_f
    from mllm_tpu_torch.ops.quantize_model import FusedInt4MLP, Int4Operands, fused_mlp_shard
    from mllm_tpu_torch.parallel.sharding import column_shard, row_shard

    d, ff = QWEN2VL_2B_MLP
    gate, up, down, _ = fused_mlp_operands(d, ff, dev, g)
    mlp = FusedInt4MLP(Int4Operands(*gate), Int4Operands(*up), Int4Operands(*down), "silu", pick_block_f(ff))

    def linear(n, k):
        p, s, _, _ = int4_operands(1, k, n, False, dev, g)
        return Int4Linear(p, s, qm.GROUP)

    head, o_whole = linear(VOCAB_PADDED, d), linear(d, H * D)
    rows = {"int4_matmul": [], "fused_int4_mlp": []}
    bad = []
    for split, (tp, h, hkv) in TP_INT4_SPLITS.items():
        qkv = linear((h + 2 * hkv) * D, d)
        hl, kl = h // tp * D, hkv // tp * D
        k0, v0 = h * D, (h + hkv) * D
        cuts = {
            "qkv": (qkv, [column_shard(qkv, [(r * hl, (r + 1) * hl), (k0 + r * kl, k0 + (r + 1) * kl),
                                             (v0 + r * kl, v0 + (r + 1) * kl)]) for r in range(tp)], "column"),
            "o_proj": (o_whole, [row_shard(o_whole, H * D, r, tp) for r in range(tp)], "row"),
            "head": (head, [column_shard(head, [(r * VOCAB_PADDED // tp, (r + 1) * VOCAB_PADDED // tp)])
                            for r in range(tp)], "column"),
        }
        ranks_mlp = [fused_mlp_shard(mlp, r, tp) for r in range(tp)]
        for m in TP_INT4_M:
            for what, (whole, ranks, kind) in cuts.items():
                k = (H * D) // (tp if kind == "row" else 1) if what == "o_proj" else d
                xw = torch.randn(m, H * D if what == "o_proj" else d, device=dev, generator=g).to(torch.bfloat16)
                xs = [t.contiguous() for t in xw.split(k, 1)] if kind == "row" else [xw] * tp
                call = lambda lin, x: qm.int4_matmul(x, lin.packed_t, lin.scales_t, qm.GROUP, lin.zeros_t)  # noqa: E731
                outs = [call(lin, x) for lin, x in zip(ranks, xs)]
                for lin, x, y in zip(ranks[1:], xs[1:], outs[1:]):  # ranks 1.. against their plain versions
                    rel = split_rel_err(y, qm.int4_matmul_ref(x, lin.packed_t, lin.scales_t, qm.GROUP))
                    if not rel <= QUANT_TOL["int4_matmul"]:
                        bad.append(f"int4_matmul {split} {what} m={m}: a rank at {rel}")
                parts = torch.stack(outs).sum(0) if kind == "row" else torch.cat([o.reshape(m, -1) for o in outs], 1)
                if what == "qkv":  # ranks hold [q_r, k_r, v_r]: back to the whole's q || k || v order
                    parts = torch.cat([parts.reshape(m, tp, -1)[:, :, a:b].reshape(m, -1)
                                       for a, b in ((0, hl), (hl, hl + kl), (hl + kl, hl + 2 * kl))], 1)
                whole_err = split_rel_err(parts, call(whole, xw))
                if not whole_err <= QUANT_TOL["int4_matmul"]:
                    bad.append(f"int4_matmul {split} {what} m={m}: ranks against the whole at {whole_err}")
                lin0, x0 = ranks[0], xs[0]
                n0 = lin0.packed_t.shape[1]
                rows["int4_matmul"].append(check_quant_row(
                    "int4_matmul", lambda: call(lin0, x0),
                    lambda: qm.int4_matmul_ref(x0, lin0.packed_t, lin0.scales_t, qm.GROUP),
                    dict(m=m, K=k, N=n0, affine=False, khp=lin0.packed_t.shape[0], tp_split=split, cut=what),
                    int4_bytes(k, n0, False), ("torch._weight_int4pack_mm", int4pack_call(x0, lin0.packed_t,
                                                                                         lin0.scales_t, k)),
                    fields=dict(whole_rel_err=whole_err, ranks=tp)))
            x = torch.randn(m, d, device=dev, generator=g).to(torch.bfloat16)
            ops = lambda part: (part.gate_ops.astuple(), part.up_ops.astuple(), part.down_ops.astuple())  # noqa: E731
            outs = [fused_int4_mlp(x, *ops(part), act="silu", block_f=part.block_f) for part in ranks_mlp]
            for part, y in zip(ranks_mlp[1:], outs[1:]):
                rel = split_rel_err(y, fused_int4_mlp_ref(x, *ops(part), act="silu", block_f=part.block_f))
                if not rel <= QUANT_TOL["fused_int4_mlp"]:
                    bad.append(f"fused_int4_mlp {split} m={m}: a rank at {rel}")
            whole_err = split_rel_err(torch.stack(outs).sum(0), fused_int4_mlp(x, *ops(mlp), act="silu",
                                                                                 block_f=mlp.block_f))
            if not whole_err <= QUANT_TOL["fused_int4_mlp"]:
                bad.append(f"fused_int4_mlp {split} m={m}: ranks against the whole at {whole_err}")
            p0 = ranks_mlp[0]
            rows["fused_int4_mlp"].append(check_quant_row(
                "fused_int4_mlp", lambda: fused_int4_mlp(x, *ops(p0), act="silu", block_f=p0.block_f),
                lambda: fused_int4_mlp_ref(x, *ops(p0), act="silu", block_f=p0.block_f),
                dict(m=m, d=d, ff=ff // tp, block_f=p0.block_f, act="silu", affine=False, tp_split=split),
                2 * int4_bytes(d, ff // tp, False) + int4_bytes(ff // tp, d, False),
                fields=dict(whole_rel_err=whole_err, ranks=tp)))
    if bad:
        raise AssertionError(f"tp_int4_split_rows: {bad}")
    return rows


def attention_launches(kernels: dict) -> int:
    return sum(kernels[k].launches for k in ATTENTION_KERNELS)


def train_steps(state, step, ids, tgt, n: int, kernels: dict):
    """n optimizer steps: (losses, ms a step, peak bytes, attention-kernel
    launches during the steps)."""
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(n):
        state, loss = step(state, ids, tgt)
        losses.append(loss)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    return [float(x) for x in losses], ms, torch.cuda.max_memory_allocated(), attention_launches(kernels)


def phase_slice_train(dev) -> dict:
    """LoRA fine-tuning of the main-geometry LM (QWEN2VL_2B_LM, bf16, random
    weights, 28 layers): rank 8 on q/k/v/o, AdamW, TRAIN_STEPS steps on one
    batch of B=2 x S=512. Checks: the loss falls; the base tensors are
    bit-equal afterwards; no attention kernel launches during a loss that
    needs gradients; the gradients with remat equal those without within
    REMAT_TOL x max |grad|; the merged model's logits lie within MERGE_TOL x
    max |logit| of the adapted forward's and within MERGE_GAP_TOL x the
    adapted-vs-base gap, which the adapted forward at half the adapters'
    scale (what a merge with the wrong scale gives) must exceed;
    save_safetensors_model of the merged model reloads through
    auto_model with greedy tokens equal to the merged model's. Prints ms a
    step and peak memory with and without remat."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.core.param_loader import save_safetensors_model
    from mllm_tpu_torch.generation.generate import generate
    from mllm_tpu_torch.generation.sampling import SamplingConfig
    from mllm_tpu_torch.models.registry import auto_model
    from mllm_tpu_torch.training import (LoRALinear, TrainState, add_lora, lora_params_filter, make_train_step,
                                         merge_lora)
    from mllm_tpu_torch.training.train import partition

    cfg = TextConfig(**QWEN2VL_2B_LM)
    model = init_model(cfg, dev)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(61)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)), device=dev)
    tgt = torch.roll(ids, -1, dims=1)
    probe = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 64)), device=dev)
    kernels = wrappers()
    with torch.no_grad():
        base_logits = model(probe, None, last_only=False)[0]
    add_lora(model, torch.Generator(device=dev).manual_seed(7), rank=8)
    factory = lambda ps: torch.optim.AdamW(ps, lr=TRAIN_LR, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)  # noqa: E731
    state = TrainState.create(model, factory, trainable=lora_params_filter)
    n_adapter = sum(p.numel() for p in model.parameters() if p.requires_grad)
    step = make_train_step(trainable=lora_params_filter)
    step_remat = make_train_step(loss_fn=lambda m, i, t: m.loss(i, t, remat=True), trainable=lora_params_filter)
    state, _ = step(state, ids, tgt)  # warm-up (allocator, cuBLAS plans)
    losses, ms, peak, att = train_steps(state, step, ids, tgt, TRAIN_STEPS, kernels)
    _, ms_remat, peak_remat, att_remat = train_steps(state, step_remat, ids, tgt, 2, kernels)
    params = partition(model, lora_params_filter)
    g0 = torch.autograd.grad(model.loss(ids, tgt), params)
    g1 = torch.autograd.grad(model.loss(ids, tgt, remat=True), params)
    remat_err = max(float((a - b).abs().max()) for a, b in zip(g0, g1)) / max(float(g.abs().max()) for g in g0)
    adapter_grad_min = min(float(g.abs().max()) for g in g0)
    partition(model, lambda name: False)
    base_equal = all(torch.equal(model.state_dict()[k], v) for k, v in base.items())
    del base, g0, g1
    with torch.no_grad():
        adapted = model(probe, None, last_only=False)[0]
        loras = [m for m in model.modules() if isinstance(m, LoRALinear)]
        for m in loras:
            m.scale *= 0.5
        half = model(probe, None, last_only=False)[0]
        for m in loras:
            m.scale *= 2.0
        merge_lora(model)
        merged = model(probe, None, last_only=False)[0]
    scale = float(adapted.abs().max())
    merge_gap = float((merged - adapted).abs().max())
    adapt_gap = float((adapted - base_logits).abs().max())
    half_scale_gap = float((half - adapted).abs().max())
    del half
    os.makedirs(TRAIN_DIR, exist_ok=True)
    with open(os.path.join(TRAIN_DIR, "config.json"), "w") as f:
        json.dump({**hf_config(cfg), "tie_word_embeddings": cfg.tie_word_embeddings}, f)
    (_, save_s) = timed(lambda: save_safetensors_model(os.path.join(TRAIN_DIR, "out"), model, TRAIN_DIR))
    (reloaded, _, _), load_s = timed(lambda: auto_model(os.path.join(TRAIN_DIR, "out"), dtype=torch.bfloat16,
                                                        with_tokenizer=False, device=dev))
    file_bytes = os.path.getsize(os.path.join(TRAIN_DIR, "out", "model.safetensors"))
    for fn in kernels.values():
        fn.launches = 0
    prompt = rng.integers(0, cfg.vocab_size, 100)
    with torch.no_grad():
        want, _ = generate(model, prompt, model.init_cache(1, S_CACHE), SamplingConfig(max_new_tokens=TRAIN_NEW))
        got, _ = generate(reloaded, prompt, reloaded.init_cache(1, S_CACHE), SamplingConfig(max_new_tokens=TRAIN_NEW))
    launches = {k: f.launches for k, f in kernels.items()}
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    emit(phase="slice_train", device=torch.cuda.get_device_name(dev), batch=TRAIN_B, seq=TRAIN_S,
         lora_rank=8, adapter_params=n_adapter, steps=TRAIN_STEPS, losses=losses, step_ms=ms,
         peak_bytes=peak, step_ms_remat=ms_remat, peak_bytes_remat=peak_remat,
         attention_launches_in_loss=att + att_remat, remat_grad_err=remat_err, adapter_grad_min_max=adapter_grad_min,
         base_bit_equal=base_equal, merge_gap=merge_gap, adapt_gap=adapt_gap, half_scale_gap=half_scale_gap,
         max_logit=scale,
         safetensors_bytes=file_bytes, save_s=save_s, load_s=load_s, reload_tokens_equal=got.tokens == want.tokens,
         launches={k: n for k, n in launches.items() if n})
    if not losses[-1] < losses[0] or not base_equal or att + att_remat:
        raise AssertionError(f"slice_train: losses {losses}, base bit-equal {base_equal}, "
                             f"attention launches in the loss {att + att_remat}")
    if not remat_err <= REMAT_TOL or not adapter_grad_min > 0:
        raise AssertionError(f"slice_train: remat gradient error {remat_err}, adapter grads {adapter_grad_min}")
    if (not merge_gap <= MERGE_TOL * scale or not merge_gap <= MERGE_GAP_TOL * adapt_gap
            or not half_scale_gap > MERGE_GAP_TOL * adapt_gap):
        raise AssertionError(f"slice_train: merged vs adapted {merge_gap}, adapted vs base {adapt_gap}, "
                             f"half scale vs adapted {half_scale_gap}, max {scale}")
    if got.tokens != want.tokens or not launches["flash_attention"] or not launches["decode_attention"]:
        raise AssertionError(f"slice_train: reloaded tokens {got.tokens} vs {want.tokens}, launches {launches}")
    del model, reloaded, state
    torch.cuda.empty_cache()
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def rel_gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)


def engine_tokens(model, dev, requests, kv: str, mesh=None) -> dict:
    """Greedy tokens of `requests` (token ids, or a Qwen2VLProcessorOutput:
    an image request) through a ContinuousEngine (8 slots, window 32; `kv`
    "bf16", "int8" or "paged": bf16 blocks, PAR_PAGED_SHORT blocks short of
    the first eight requests, so some wait), ENGINE_TP_NEW each. Returns the
    tokens, tok/s over wall time (first submit to last token, the windows'
    capture inside) and without the capture seconds, each image request's
    time to first token (its submit to its first token at the host),
    requeues, windows and graph replays, and the launches on the card
    (`graphs.device_launches`, from vl_reset). Under a mesh the first image
    request is broadcast alone before the rest are submitted: `broadcast_ms`
    is that `_sync_requests` (ids, positions, the patches), `empty_sync_ms`
    one with nothing queued."""
    from mllm_tpu_torch.generation import graphs
    from mllm_tpu_torch.generation.engine import ContinuousEngine, collect

    kw = dict(kv_dtype=kv)
    if kv == "paged":
        kw = dict(kv_dtype="bf16", paged=paged_blocks_short_of(ENGINE_TP_LENS, PAR_PAGED_SHORT, ENGINE_TP_NEW))
    eng = ContinuousEngine(model, slots=8, max_len=S_CACHE, prompt_bucket=128, decode_window=32, eos_token_id=-2,
                           start_thread=False, mesh=mesh, **kw)
    is_image = [not isinstance(r, np.ndarray) for r in requests]
    submit = lambda r: eng.submit_vl(r, ENGINE_TP_NEW) if not isinstance(r, np.ndarray) else eng.submit(  # noqa: E731
        r, ENGINE_TP_NEW)
    torch.cuda.synchronize()
    vl_reset()
    out = {}
    t0 = time.perf_counter()
    qs = []
    if mesh is not None and is_image[0]:
        qs.append(submit(requests[0]))
        for key in ("broadcast_ms", "empty_sync_ms"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng._sync_requests()
            torch.cuda.synchronize()
            out[key] = (time.perf_counter() - t1) * 1e3
    qs += [submit(r) for r in requests[len(qs):]]
    ttft = {}
    while (any(r is not None for r in eng.req) or not eng.pending.empty() or not eng._mirror.empty()
           or eng._inflight is not None):
        eng.step()
        for i, q in enumerate(qs):
            if is_image[i] and i not in ttft and q.qsize():
                ttft[i] = (time.perf_counter() - t0) * 1e3
    outs = [collect(q, timeout=60) for q in qs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    capture_s = sum(gr.capture_s for gr in eng._windows.values())
    n = sum(len(o) for o in outs)
    out.update(toks=outs, tok_s=n / wall, capture_s=capture_s, tok_s_less_capture=n / (wall - capture_s),
               ttft_ms=[ttft.get(i) for i in range(len(qs)) if is_image[i]], requeued=eng.requeued,
               windows=eng.steps, graph_replays=sum(gr.replays for gr in eng._windows.values()),
               launches=graphs.device_launches(vl_counts()))
    vl_reset()
    del eng
    torch.cuda.empty_cache()
    return out


def sgd_update_err(cfg, dev, mesh, ids, tgt):
    """One f32 sgd_train_step at SGD_LR over the model sharded on `mesh`
    and over the plain model, from the same weights: (the largest over the
    parameters of max |update_tp - update| / max(max |update|, SGD_FLOOR x
    the largest update), the largest update, (tp loss, plain loss)). The
    updates are held in f32, where lr x grad is far above an ulp of the
    weight; in bf16 most of them round away."""
    from mllm_tpu_torch.models.transformer import CausalLM
    from mllm_tpu_torch.parallel.sharding import sgd_train_step, shard_model

    f32 = lambda: CausalLM.init(cfg, device=dev, dtype=torch.float32,  # noqa: E731
                                generator=torch.Generator(device=dev).manual_seed(0))
    before = f32().state_dict()
    plain, plain_loss = sgd_train_step(f32(), ids, tgt, lr=SGD_LR)
    tp_model, tp_loss = sgd_train_step(shard_model(f32(), mesh), ids, tgt, lr=SGD_LR)
    tp_state = {k.replace(".inner.", "."): v for k, v in tp_model.state_dict().items()}
    upd = {k: (v - before[k], tp_state[k] - before[k]) for k, v in plain.state_dict().items()}
    top = max(float(d.abs().max()) for d, _ in upd.values())
    err = max(float((t - d).abs().max()) / max(float(d.abs().max()), SGD_FLOOR * top) for d, t in upd.values())
    del before, plain, tp_model, tp_state, upd
    torch.cuda.empty_cache()
    return err, top, (float(tp_loss), float(plain_loss))


def tp_vl_requests(cfg, dev, rng) -> list:
    """PAR_VL_IMAGES image requests of slice_vl_engine's kind (`engine_image`)
    before every other text request of PAR_VL_TEXT_LENS random ids."""
    reqs = []
    for i, n in enumerate(PAR_VL_TEXT_LENS):
        if i % 2 == 0 and i // 2 < PAR_VL_IMAGES:
            reqs.append(engine_image(cfg, dev, rng))
        reqs.append(rng.integers(0, 151000, n))
    return reqs


def tp_engine_pair(name: str, model, sharded, dev, requests, kv: str, mesh) -> dict:
    """The plain engine over `model`, then the TP engine over `sharded`
    (`engine_tokens`), with each run's seconds printed: a `slice_parallel_
    engine` line with both runs' rates, capture seconds, image TTFTs and
    launches. Returns that line."""
    t0 = time.perf_counter()
    plain = engine_tokens(model, dev, requests, kv)
    t1 = time.perf_counter()
    tp = engine_tokens(sharded, dev, requests, kv, mesh=mesh)
    t2 = time.perf_counter()
    row = dict(phase="slice_parallel_engine", run=name, requests=len(requests), new_tokens=ENGINE_TP_NEW,
               equal=tp["toks"] == plain["toks"], plain_s=t1 - t0, tp_s=t2 - t1,
               **{k: v for k, v in tp.items() if k != "toks"},
               **{f"plain_{k}": v for k, v in plain.items() if k != "toks"})
    emit(**row)
    return row


def tp_int4_engines(model, dev, prompts, mesh, prompt, engines: dict) -> dict:
    """The TP engine pairs over the int4 weights at full width: `model`
    (bf16) quantized on the card to `-q int4` (q/k/v, o and the head's proj
    Int4Linear, one FusedInt4MLP a block) and, in place last, to
    `-q int4-mixed` (attention int8); each sharded at world 1, where every
    cut is the identity, through `tp_engine_pair` over bf16 slot caches
    (added to `engines` as "int4" and "int4_mixed"). Then sharded_generate
    over `pad_heads_for_tp(int4 model, 4)` (12 / 2 heads to 12 / 4: the int4
    q/k/v/o re-laid), whose greedy tokens must equal generate_compiled on the
    unpadded model. Returns that check."""
    import copy

    from mllm_tpu_torch.generation.generate import generate_compiled
    from mllm_tpu_torch.ops.quantize_model import quantize_model
    from mllm_tpu_torch.parallel.heads import pad_heads_for_tp
    from mllm_tpu_torch.parallel.sharding import shard_model, sharded_generate

    t0 = time.perf_counter()
    int4 = quantize_model(copy.deepcopy(model), "int4", on_device=True)
    torch.cuda.synchronize()
    emit(phase="slice_parallel_quantize", mode="int4", seconds=time.perf_counter() - t0)
    engines["int4"] = tp_engine_pair("int4", int4, shard_model(int4, mesh), dev, prompts, "bf16", mesh)
    t0 = time.perf_counter()
    want, _ = generate_compiled(int4, torch.as_tensor(prompt, device=dev), int4.init_cache(1, S_CACHE),
                                prompt.shape[1], 64)
    t1 = time.perf_counter()
    padded = pad_heads_for_tp(int4, 4)
    got = sharded_generate(padded, prompt, mesh, 64, S_CACHE, cache_dtype=torch.bfloat16)
    out = dict(int4_padded_tp4=dict(equal=[int(t) for t in got[0]] == [int(t) for t in want],
                                    heads=(padded.cfg.num_attention_heads, padded.cfg.num_key_value_heads),
                                    seconds=time.perf_counter() - t1, reference_seconds=t1 - t0))
    del int4, padded
    t0 = time.perf_counter()
    mixed = quantize_model(model, "int4", on_device=True, attn_quant="int8")
    torch.cuda.synchronize()
    emit(phase="slice_parallel_quantize", mode="int4-mixed", seconds=time.perf_counter() - t0)
    engines["int4_mixed"] = tp_engine_pair("int4_mixed", mixed, shard_model(mixed, mesh), dev, prompts, "bf16",
                                           mesh)
    torch.cuda.empty_cache()
    return out


def phase_slice_parallel(dev) -> dict:
    """The parallel axes at world 1 over NCCL on the card (tp = dp = pp = ep
    = sp = 1; every collective runs, on one rank): sharded_generate against
    generate_compiled at full width (greedy tokens equal; decode tok/s of
    generate_compiled over the sharded and the plain model); the TP engine
    against the plain engine over bf16 and int8 slot caches and a paged pool
    that requeues (tokens equal, tok/s), then over the full-width Qwen2-VL-2B
    (its `.lm` sharded, the tower whole) with image and text requests
    (tokens equal, image TTFT, one image request's broadcast ms); one
    sgd_train_step in f32 against the plain step (`sgd_update_err`),
    pipeline_lm_loss against model.loss, ring and Ulysses attention in the
    trunk against the plain trunk (PAR_LAYERS layers, full width);
    moe_forward_ep against the MoE layer at QWEN2_MOE_08B's widths (2
    layers); then `python -m mllm_tpu_torch.parallel.dryrun --device cuda`
    in a process of its own. Launches on the card are counted through
    `graphs.device_launches` (window replays included)."""
    import torch.distributed as dist

    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.generation import graphs
    from mllm_tpu_torch.generation.generate import generate_compiled
    from mllm_tpu_torch.models.qwen2_vl import Qwen2VLForConditionalGeneration
    from mllm_tpu_torch.parallel.comm import make_axis_mesh
    from mllm_tpu_torch.parallel.expert import moe_forward_ep
    from mllm_tpu_torch.parallel.heads import pad_heads_for_tp
    from mllm_tpu_torch.parallel.pipeline import pipeline_lm_loss
    from mllm_tpu_torch.parallel.sharding import make_mesh, shard_model, sharded_generate

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    launches = {}

    def take():  # the launches on the card since the last reset, then reset
        add_launches(launches, graphs.device_launches(vl_counts()))
        vl_reset()

    vl_reset()
    out = {}
    try:
        mesh = make_mesh(1, 1)
        cfg = TextConfig(**QWEN2VL_2B_LM)
        model = init_model(cfg, dev)
        rng = np.random.default_rng(71)
        prompt = rng.integers(0, cfg.vocab_size, (1, 100))
        with torch.no_grad():
            (toks_tp, gen_s) = timed(lambda: sharded_generate(model, prompt, mesh, 64, S_CACHE,
                                                              cache_dtype=torch.bfloat16))
            toks_tp = [int(t) for t in toks_tp[0]]
            sharded = shard_model(pad_heads_for_tp(model, 1), mesh)
            rates = {}
            for name, m in (("plain", model), ("sharded", sharded), ("plain_again", model)):
                ids = torch.as_tensor(prompt, device=dev)
                toks, _ = generate_compiled(m, ids, m.init_cache(1, S_CACHE), 100, 64)  # capture
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks, _ = generate_compiled(m, ids, m.init_cache(1, S_CACHE), 100, 64)
                torch.cuda.synchronize()
                rates[name] = 64 / (time.perf_counter() - t0)
                if name == "plain":
                    want = [int(t) for t in toks]
            prompts = [rng.integers(0, cfg.vocab_size, n) for n in ENGINE_TP_LENS]
            engines = {}
            take()
            for kv in ("bf16", "int8", "paged"):
                engines[kv] = tp_engine_pair(kv, model, sharded, dev, prompts, kv, mesh)
            del sharded
            out.update(tp_int4_engines(model, dev, prompts, mesh, prompt, engines))
        out.update(sharded_generate_equal=toks_tp == want, sharded_generate_s=gen_s,
                   decode_tok_s=rates)
        del model
        torch.cuda.empty_cache()

        # image requests: Qwen2-VL-2B, its LM sharded over tp, the tower whole
        t0 = time.perf_counter()
        vl = Qwen2VLForConditionalGeneration.init(vl_config(QWEN2VL_2B_LM), device=dev, dtype=torch.bfloat16,
                                                  generator=torch.Generator(device=dev).manual_seed(0))
        with torch.no_grad():
            reqs = tp_vl_requests(vl.cfg, dev, rng)
            torch.cuda.synchronize()
            emit(phase="slice_parallel_vl_init", seconds=time.perf_counter() - t0)
            engines["vl"] = tp_engine_pair("vl", vl, shard_model(vl, mesh), dev, reqs, "bf16", mesh)
        for e in engines.values():
            add_launches(add_launches(launches, e["launches"]), e["plain_launches"])
        out.update(engine={k: {f: e[f] for f in ("equal", "tok_s", "plain_tok_s", "requeued", "tp_s", "plain_s")}
                           for k, e in engines.items()})
        tower_launches = vl.cfg.vision.depth * PAR_VL_IMAGES  # one head_dim-80 flash launch a tower block
        del vl, reqs
        torch.cuda.empty_cache()

        small = TextConfig(**{**QWEN2VL_2B_LM, "num_hidden_layers": PAR_LAYERS})
        ids = torch.as_tensor(rng.integers(0, small.vocab_size, (4, 256)), device=dev)
        tgt = torch.roll(ids, -1, dims=1)
        sgd_err, sgd_top, sgd_loss = sgd_update_err(small, dev, mesh, ids, tgt)
        out.update(sgd_loss=sgd_loss, sgd_update_err=sgd_err, sgd_max_update=sgd_top)
        plain = init_model(small, dev)
        pp = make_axis_mesh("pp", 1)
        sp = make_axis_mesh("sp", 1)
        with torch.no_grad():
            want_loss = float(plain.loss(ids, tgt))
            pp_loss = float(pipeline_lm_loss(plain, ids, tgt, pp, n_microbatches=2))
            hid, _ = plain.hidden_states(ids[:1], None)
            seq = {}
            for mode in ((), ("ulysses",)):
                h, _ = plain.hidden_states(ids[:1], None, ring=(sp, "sp", *mode))
                seq["_".join(mode) or "ring"] = dict(hidden_err=rel_gap(h, hid),
                                                     loss=float(plain.loss(ids, tgt, ring=(sp, "sp", *mode))))
        out.update(pipeline_loss=(pp_loss, want_loss), sequence=seq)
        del plain
        torch.cuda.empty_cache()

        _, moe_model_ = moe_model(dict(QWEN2_MOE_08B, num_hidden_layers=2), dev, "bf16")
        ep = make_axis_mesh("ep", 1)
        x = torch.randn(MOE_BATCH, MOE_PROMPT, QWEN2_MOE_08B["hidden_size"], device=dev,
                        generator=torch.Generator(device=dev).manual_seed(72)).to(torch.bfloat16)
        ep_rows = []
        with torch.no_grad():
            for blk in moe_model_.blocks:
                y_ep, y = moe_forward_ep(blk.mlp, x, ep), blk.mlp(x)
                ep_rows.append(dict(err=rel_gap(y_ep, y), ep_ms=time_ms(lambda: moe_forward_ep(blk.mlp, x, ep), 5),
                                    module_ms=time_ms(lambda: blk.mlp(x), 5)))
        out.update(moe_ep=ep_rows)
        del moe_model_
        torch.cuda.empty_cache()
        take()
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mllm_tpu_torch.parallel.dryrun", "--device", "cuda"],
                          capture_output=True, text=True, timeout=300)
    out.update(dryrun_rc=proc.returncode, dryrun_s=time.perf_counter() - t0,
               dryrun_last=(proc.stdout.strip().splitlines() or [""])[-1])
    emit(phase="slice_parallel", device=torch.cuda.get_device_name(dev), **out,
         launches={k: n for k, n in launches.items() if n})
    bad = []
    if not out["sharded_generate_equal"]:
        bad.append("sharded_generate tokens")
    bad += [f"engine {kv} tokens" for kv, e in out["engine"].items() if not e["equal"]]
    if engines["paged"]["requeued"] == 0:
        bad.append("engine paged: no request waited for pool blocks")
    for kv, e in engines.items():
        if e["graph_replays"] != e["windows"]:
            bad.append(f"engine {kv}: {e['windows'] - e['graph_replays']} of {e['windows']} windows ran eagerly")
    if not engines["paged"]["launches"].get("decode_attention_paged"):
        bad.append(f"engine paged launches {engines['paged']['launches']}")
    for name, kernels in (("int4", ("fused_int4_mlp", "int4_matmul")),
                          ("int4_mixed", ("fused_int4_mlp", "int4_matmul", "int8_matmul"))):
        for side in ("launches", "plain_launches"):
            if not all(engines[name][side].get(k) for k in kernels):
                bad.append(f"engine {name} {side} {engines[name][side]} (expected {kernels})")
    if not out["int4_padded_tp4"]["equal"] or out["int4_padded_tp4"]["heads"] != (12, 4):
        bad.append(f"sharded_generate over the int4 model padded for tp 4: {out['int4_padded_tp4']}")
    vl_l = engines["vl"]["launches"]
    if vl_l.get("flash_attention@80") != tower_launches or not vl_l.get("decode_attention"):
        bad.append(f"engine vl launches {vl_l} (expected {tower_launches} head_dim-80 flash launches)")
    loss, plain_loss = out["sgd_loss"]
    if abs(loss - plain_loss) > 1e-3 * abs(plain_loss) or not out["sgd_update_err"] <= SGD_TOL:
        bad.append(f"sgd step {out['sgd_loss']} {out['sgd_update_err']}")
    if abs(pp_loss - want_loss) > 1e-3 * abs(want_loss):
        bad.append(f"pipeline loss {pp_loss} vs {want_loss}")
    for mode, r in seq.items():
        if r["hidden_err"] > PAR_TOL or abs(r["loss"] - want_loss) > 1e-2 * abs(want_loss):
            bad.append(f"{mode} {r}")
    bad += [f"moe_forward_ep {r}" for r in ep_rows if r["err"] > MOE_BRANCH_TOL]
    if proc.returncode != 0:
        bad.append(f"dryrun rc {proc.returncode}: {proc.stderr[-2000:]}")
    if not launches["flash_attention"] or not launches["decode_attention"] or not launches["decode_attention_quant"]:
        bad.append(f"launches {launches}")
    if bad:
        raise AssertionError(f"slice_parallel: {bad}")
    return launches


CLI_NEW = 32  # new tokens of each CLI run
CLI_PIPELINE_LAYERS = 2  # depth of the convertor -> quantizer -> demo_llm model (full width)
CLI_PROMPT = "Give me a short introduction to large language models."  # demo_llm's default prompt


def cli_tensors(cfg, dev, seed: int) -> dict:
    """HF name -> bf16 tensor on the card of a random qwen2-type checkpoint of
    `cfg` (`qwen2_layout`), drawn from a seeded generator, whose greedy
    output is not one repeated token: an untied head (a tied random head
    echoes its input) and an N(0, 1) embedding (at N(0, 0.02) 28 random
    layers wash the token out of the residual stream, and every position
    decodes to the same token)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, (shape, init, _) in qwen2_layout(cfg, untied=True).items():
        if init == "embed":
            t = torch.randn(shape, generator=g, device=dev)
        elif init == "ones":
            t = torch.ones(shape, device=dev)
        else:
            t = (torch.rand(shape, generator=g, device=dev) * 2 - 1) / init ** 0.5
        out[name] = t.to(torch.bfloat16)
    return out


def write_bf16_checkpoint(path: str, cfg, tensors: dict, tokenizer: dict) -> int:
    """An HF model directory: config.json (tied unless `tensors` has an
    lm_head), tokenizer.json and one safetensors file of the bf16 `tensors`
    (`write_safetensors`). Returns the file's bytes."""
    from mllm_tpu_torch.core.param_loader import write_safetensors

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(hf_config(cfg), tie_word_embeddings="lm_head.weight" not in tensors), f)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(tokenizer, f, ensure_ascii=False)
    fpath = os.path.join(path, "model.safetensors")
    write_safetensors(fpath, tensors)
    return os.path.getsize(fpath)


def cli_call(fn, argv: list):
    """fn(argv) (a CLI's `main`), its standard output captured, with every
    wrapper's counter and the graphs' replays set to 0 just before and the
    launches on the card read just after. Returns (result, launches, seconds,
    stdout lines)."""
    import contextlib
    import gc
    import io

    from mllm_tpu_torch.generation import graphs

    gc.collect()
    torch.cuda.empty_cache()
    kernels = wrappers()
    for k in kernels.values():
        k.launches = 0
    graphs.reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = graphs.device_launches({k: f.launches for k, f in kernels.items()})
    return out, launches, seconds, len(buf.getvalue().splitlines())


def direct_greedy(loaded: tuple) -> tuple:
    """The port's API on a loaded model directory, without the CLI: the
    (model, tokenizer, cfg) that `auto_model` returned to the CLI's run
    (`keep_loaded`), the chat template, generate (greedy, CLI_NEW tokens).
    Returns (ids, prompt ids)."""
    import gc

    from mllm_tpu_torch.generation.generate import generate
    from mllm_tpu_torch.generation.sampling import SamplingConfig
    from mllm_tpu_torch.tokenizers.chat_templates import render

    model, tok, cfg = loaded
    ids = np.asarray(tok.encode(render(cfg.model_type, CLI_PROMPT), bos=True), np.int64)[None]
    res, _ = generate(model, ids, model.init_cache(1, S_CACHE), SamplingConfig(max_new_tokens=CLI_NEW),
                      eos_token_id=tok.eos_token_id)
    del model, loaded
    gc.collect()
    torch.cuda.empty_cache()
    return res.tokens, ids[0].tolist()


def start_processes(repo: str, runs: list) -> list:
    """`python -m <argv>` for each (argv, extra environment) of `runs`, all at
    once from the repo's root, their output piped: the typed entry points,
    started as soon as their files exist so that their start-up (an
    interpreter, torch, the card) runs beside the phase's work; collect them
    with `finish_processes`."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    return [subprocess.Popen([sys.executable, "-m", *argv], cwd=repo, env=dict(env, **over),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for argv, over in runs]


def stop_processes(procs: list) -> None:
    """Kill each process that still runs, and reap it."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_processes(procs: list) -> list:
    """Each process's CompletedProcess (600 s at most; a process still
    running then, or on an error here, is killed)."""
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        stop_processes(procs)
    return [subprocess.CompletedProcess(p.args, p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def phase_slice_cli(dev) -> dict:
    """The text entry points as a user runs them (`mllm_tpu_torch.examples`,
    `mllm_tpu_torch.tools`), in process through each CLI's `main`:
      1. a full-width Qwen2-VL-2B LM directory (QWEN2VL_2B_LM, 28 layers,
         bf16 random weights from a seeded generator, an untied head, a
         synthetic tokenizer of 151936 entries): demo_llm greedy; then on the
         same widths at CLI_PIPELINE_LAYERS layers (the runs that repeat the
         greedy one with a flag) `-q int8`, `-q int4`, `--kv int8`,
         `--chunked 256 --turns 2`, `--batch 3`, and demo_sd host and
         `--compiled`, CLI_NEW tokens each. Gates: tokens
         inside the vocabulary and no output one repeated token (an echo
         would hide a cache or position fault from the equality gates);
         each kernel of the run's path launched at
         least as often as the path needs (none of the bf16 attention kernels
         over the int8 cache); the greedy ids equal to `generate` called
         directly on the same directory; turn 2 of `--chunked` a full
         prefix-cache hit.
      2. the file pipeline at full width and CLI_PIPELINE_LAYERS layers: the
         bf16 safetensors directory -> tools.convertor (f32 `.mllm`) ->
         tools.quantizer Q4_0 and Q8_0 (timed on the card's host) ->
         demo_llm on each quantized directory: int4_matmul (Q4_0) /
         int8_matmul (Q8_0) launched, greedy ids equal to a direct load of
         the same file.
      3. the typed entry points, as processes: `python -m
         mllm_tpu_torch.examples.demo_qwen -m <dir> --max-new 16` on the
         pipeline's bf16 directory exits 0;
         the same with CUDA_VISIBLE_DEVICES="" exits non-zero with
         default_device's message (no CPU fallback); `python -m
         mllm_tpu_torch.tools.ci` prints a report with "ok": true on the
         platform cuda. The three start together as soon as that directory
         is written, beside the in-process runs, and are collected last.
    The direct calls run on the model the CLI's run loaded (`keep_loaded` on
    `auto_model`), so each directory is loaded once. Prints each CLI run's
    prefill and decode tok/s beside the card's name and power limit. The
    files live in a temporary directory the phase deletes. Returns the
    launches of the runs."""
    import tempfile

    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.examples import demo_llm, demo_sd
    from mllm_tpu_torch.models import registry
    from mllm_tpu_torch.tools import convertor, quantizer

    cfg = TextConfig(**QWEN2VL_2B_LM)
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    repo = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(repo, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_cli_", dir=os.path.join(repo, "build"))
    total = {name: 0 for name in SOURCES}
    rates, bad, procs = [], [], []
    try:
        mdir = os.path.join(root, "qwen2-bf16")
        tok_spec = synthetic_tokenizer(V, seed=31)
        nbytes, write_s = timed(lambda: write_bf16_checkpoint(mdir, cfg, cli_tensors(cfg, dev, 31), tok_spec))
        emit(phase="slice_cli_checkpoint", file_bytes=nbytes, write_s=write_s)

        def run(name, fn, argv, need, none=()):
            """One CLI call, gated on its tokens and its launches: need(result)
            -> {kernel: least launches}; `none`: kernels that must not launch."""
            out, launches, seconds, lines = cli_call(fn, argv)
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
            rows = [t["ids"] for t in out["turns"]] if "turns" in out else out["ids"]
            rows = rows if rows and isinstance(rows[0], list) else [rows]  # a turn or a batch row each
            flat = [t for row in rows for t in row]
            want = need(out)
            short = {k: (launches.get(k, 0), n) for k, n in want.items() if launches.get(k, 0) < n}
            wrong = {k: launches[k] for k in none if launches.get(k, 0)}
            emit(phase="slice_cli_run", run=name, argv=argv, seconds=seconds, stdout_lines=lines,
                 new_tokens=len(flat), first_ids=[row[:8] for row in rows],
                 launches={k: v for k, v in launches.items() if v},
                 launches_expected_at_least=want,
                 result={k: v for k, v in out.items() if k not in ("ids", "turns")},
                 turns=[{k: v for k, v in t.items() if k != "ids"} for t in out.get("turns", [])])
            if not flat or not all(0 <= t < V for t in flat):
                bad.append(f"{name}: tokens {flat[:8]} outside the vocabulary or none")
            if any(len(set(row)) < 2 for row in rows):
                bad.append(f"{name}: an output is one repeated token: {[row[:8] for row in rows]}")
            if short or wrong:
                bad.append(f"{name}: launches short {short}, unexpected {wrong}")
            return out

        def dense(o, L=L, **more):  # the bf16 attention of one prefill and its decode steps
            return {"flash_attention": L, "decode_attention": L * (len(o["ids"]) - 1), **more}

        quant_kv = ("flash_attention_quant", "decode_attention_quant")
        with keep_loaded(registry, "auto_model") as kept:  # the model the CLI loaded, for the direct call
            greedy = run("greedy", demo_llm.main, ["-m", mdir, "--max-new", str(CLI_NEW)], dense, quant_kv)
        direct, prompt = direct_greedy(kept.models.pop())
        del kept
        # the flagged runs at the same widths, CLI_PIPELINE_LAYERS layers (also the pipeline's source)
        P = CLI_PIPELINE_LAYERS
        pcfg = cfg.replace(num_hidden_layers=P)
        pdir = os.path.join(root, "pipeline-bf16")
        write_bf16_checkpoint(pdir, pcfg, cli_tensors(pcfg, dev, 32), tok_spec)
        # 3. the typed entry points, as processes: two on the card, one that must find none
        t_procs = time.perf_counter()
        procs = start_processes(repo, [(["mllm_tpu_torch.examples.demo_qwen", "-m", pdir, "--max-new", "16"], {}),
                                       (["mllm_tpu_torch.examples.demo_qwen", "-m", pdir, "--max-new", "16"],
                                        {"CUDA_VISIBLE_DEVICES": ""}),
                                       (["mllm_tpu_torch.tools.ci"], {})])
        llm = ["-m", pdir, "--max-new", str(CLI_NEW)]
        q8 = run("int8", demo_llm.main, llm + ["-q", "int8"],
                 lambda o: dense(o, P, int8_matmul=7 * P * len(o["ids"])), quant_kv)
        q4 = run("int4", demo_llm.main, llm + ["-q", "int4"],  # prefill (m > 32): dequant + torch.mm
                 lambda o: dense(o, P, int4_matmul=7 * P * (len(o["ids"]) - 1)), quant_kv)
        kv8 = run("kv_int8", demo_llm.main, llm + ["--kv", "int8"],
                  lambda o: {"flash_attention_quant": P, "decode_attention_quant": P * (len(o["ids"]) - 1)},
                  ("flash_attention", "decode_attention"))
        # turn 2 is a full hit: its last prompt token again is one decode step
        chunked = run("chunked_turns", demo_llm.main, llm + ["--chunked", "256", "--turns", "2"],
                      lambda o: {"flash_attention": P,
                                 "decode_attention": P * (sum(len(t["ids"]) for t in o["turns"]) - 1)}, quant_kv)
        batch = run("batch3", demo_llm.main, llm + ["--batch", "3"],
                    lambda o: {"flash_attention": P, "decode_attention": P * (max(map(len, o["ids"])) - 1)},
                    quant_kv)
        sd = llm

        def verify(o):  # the prefill and every verify forward (prefill-shaped) on flash attention
            return {"flash_attention": P * (1 + o["steps"])}

        sd_host = run("sd_host", demo_sd.main, sd, verify, ("decode_attention",) + quant_kv)
        sd_compiled = run("sd_compiled", demo_sd.main, sd + ["--compiled"], verify, ("decode_attention",) + quant_kv)
        turn2 = chunked["turns"][1]
        emit(phase="slice_cli_main", greedy_equals_direct=greedy["ids"] == direct,
             first_divergence=first_divergence(greedy["ids"], direct), prompt_tokens=len(prompt),
             chunked_turn2_matched=turn2["matched"], batch_prompt_lens=batch["prompt_lens"])
        if greedy["ids"] != direct:
            bad.append(f"greedy CLI ids differ from generate's at {first_divergence(greedy['ids'], direct)}")
        if turn2["matched"] != chunked["prompt_len"]:
            bad.append(f"chunked turn 2 matched {turn2['matched']} of {chunked['prompt_len']}")
        for name, out in (("greedy", greedy), ("int8", q8), ("int4", q4), ("kv_int8", kv8)):
            rates.append(dict(run=name, prefill_tok_s=out["prefill_tps"], decode_tok_s=out["decode_tps"]))
        rates += [dict(run=f"chunked turn {i}", prefill_tok_s=t["prefill_tps"], decode_tok_s=t["decode_tps"])
                  for i, t in enumerate(chunked["turns"])]
        rates += [dict(run="batch3", aggregate_tok_s=batch["tok_s"]),
                  dict(run="sd_host", tok_s=sd_host["tok_s"]), dict(run="sd_compiled", tok_s=sd_compiled["tok_s"])]

        # 2. convertor -> quantizer -> demo_llm at CLI_PIPELINE_LAYERS layers (the bf16 directory above)
        f32 = os.path.join(root, "model-f32.mllm")
        n_tensors, convert_s = timed(lambda: convertor.main(["--input", pdir, "--output", f32]))
        pipeline = dict(tensors=n_tensors, convert_s=convert_s, f32_bytes=os.path.getsize(f32))
        for kind, kernel in (("Q4_0", "int4_matmul"), ("Q8_0", "int8_matmul")):
            qdir = os.path.join(root, f"pipeline-{kind}")
            os.makedirs(qdir)
            for f in ("config.json", "tokenizer.json"):
                shutil.copy(os.path.join(pdir, f), qdir)
            (nq, nf), quant_s = timed(lambda: quantizer.main([f32, os.path.join(qdir, "model.mllm"), kind]))
            # Q4_0 repacks to symmetric int4 (decode steps only), Q8_0 to int8 (every forward)
            per = (lambda o: len(o["ids"]) - 1) if kernel == "int4_matmul" else (lambda o: len(o["ids"]))
            with keep_loaded(registry, "auto_model") as kept:
                out = run(f"pipeline_{kind}", demo_llm.main, ["-m", qdir, "--max-new", str(CLI_NEW)],
                          lambda o: {kernel: 7 * CLI_PIPELINE_LAYERS * per(o)})
            direct_q, _ = direct_greedy(kept.models.pop())
            del kept
            pipeline[kind] = dict(quantized=nq, kept=nf, quantize_s=quant_s,
                                  file_bytes=os.path.getsize(os.path.join(qdir, "model.mllm")),
                                  equals_direct=out["ids"] == direct_q)
            rates.append(dict(run=f"pipeline_{kind}", prefill_tok_s=out["prefill_tps"],
                              decode_tok_s=out["decode_tps"]))
            if out["ids"] != direct_q or nq != 7 * CLI_PIPELINE_LAYERS + 1:  # the projections and lm_head
                bad.append(f"pipeline {kind}: ids equal {out['ids'] == direct_q}, {nq} tensors quantized")
        emit(phase="slice_cli_pipeline", quantizer_host="the card's host (numpy)", **pipeline)

        # 3. the typed entry points' processes, started beside parts 1 and 2
        typed, nocard, ci = finish_processes(procs)
        procs_s = time.perf_counter() - t_procs
        try:
            report = json.loads(ci.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            report = {}
        refused = nocard.returncode != 0 and "runs on a CUDA card and found none" in nocard.stderr
        emit(phase="slice_cli_entry_points", seconds_from_start=procs_s, demo_qwen_rc=typed.returncode,
             demo_qwen_report=[l for l in typed.stdout.splitlines() if "speed" in l or "Time to" in l],
             no_card_rc=nocard.returncode, no_card_refused=refused,
             no_card_error=nocard.stderr.strip().splitlines()[-1:] if nocard.stderr.strip() else [],
             ci_rc=ci.returncode, ci_ok=report.get("ok"), ci_platform=report.get("platform"),
             ci_stages={k: v.get("ok") for k, v in report.get("stages", {}).items()})
        if typed.returncode != 0:
            bad.append(f"python -m demo_qwen exited {typed.returncode}: {typed.stderr[-1000:]}")
        if not refused:
            bad.append(f"no-card run: rc {nocard.returncode}, stderr {nocard.stderr[-500:]}")
        if ci.returncode != 0 or report.get("ok") is not True or report.get("platform") != "cuda":
            bad.append(f"tools.ci: rc {ci.returncode}, report {report or ci.stdout[-500:]}, {ci.stderr[-500:]}")
        emit(phase="slice_cli_rates", nvidia_smi=smi, runs=rates)
    finally:
        stop_processes(procs)
        shutil.rmtree(root, ignore_errors=True)
    if bad:
        raise AssertionError(f"slice_cli: {bad}")
    return {k: v for k, v in total.items() if k in SOURCES}


# ---------------------------------------------------------------------------
# The last entry points (slice_entry): reference parity against the C++
# engine's goldens in f32, the vision-language and encoder demos, train_lora
# ---------------------------------------------------------------------------

ENTRY_NEW = 32  # new tokens of each generating demo run
ENTRY_LAYERS = 2  # depth of the other demos' models (LM and tower; published widths)
ENTRY_CACHE = 2048  # the demos' -l default
ENTRY_SCORE_TOL = 1e-5  # x max |score|: a demo against the same model called directly (same kernels, same inputs)
ENTRY_DISTINCT = 8  # least distinct ids among a generating run's ENTRY_NEW (an echo or a fixed point fails)
VL_EMBED_STD = 8.0  # the VL directories' embedding std: see qwen_vl_entry_dir
OPT_FC2_GAIN = 300.0  # OPT's fc2 drawn this much wider than U(+-1/sqrt(ffn)): see phase_slice_entry's OPT
LORA_LAYERS = 2  # depth of train_lora's model (QWEN2VL_2B_LM's widths; 4 cut to 2 for the smoke's time)
LORA_ALPHA = "0.25"  # train_lora --alpha: adapter scale 1/32. At the default 16 (scale 2), and still at 1, four
# steps at lr 1e-2 teach the model the text's commonest token (its space), which the merged model then decodes 32 times
LORA_TEXT = "The quick brown fox jumps over the lazy dog. It barks twice, then sleeps. " * 300
GOLDENS = {"qwen05b": "tests/goldens/reference_qwen05b.json", "tinyllama": "tests/goldens/reference_tinyllama.json"}
QWEN2VL_SPECIALS = TOKENIZER_SPECIALS + VL_SPECIALS  # the vision tokens are the last four ids
PHI3_SPECIALS = ("<|endoftext|>", "<|user|>", "<|end|>", "<|assistant|>")
CLIP_B32 = dict(  # openai/clip-vit-base-patch32 config.json
    model_type="clip", projection_dim=512,
    text_config=dict(vocab_size=49408, hidden_size=512, intermediate_size=2048, num_hidden_layers=12,
                     num_attention_heads=8, max_position_embeddings=77, hidden_act="quick_gelu", eos_token_id=49407),
    vision_config=dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12, num_attention_heads=12,
                       image_size=224, patch_size=32, hidden_act="quick_gelu"))
VIT_B16 = dict(  # google/vit-base-patch16-224 config.json (its 1000 ImageNet labels as label_<i>)
    model_type="vit", hidden_size=768, intermediate_size=3072, num_hidden_layers=12, num_attention_heads=12,
    image_size=224, patch_size=16, num_channels=3, hidden_act="gelu", layer_norm_eps=1e-12,
    id2label={str(i): f"label_{i}" for i in range(1000)})
BERT_BASE = dict(  # bert-base-uncased config.json
    model_type="bert", vocab_size=30522, hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
    num_attention_heads=12, max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12,
    hidden_act="gelu")


class RecordingLoader:
    """A checkpoint loader that hands out zeros and records the name and
    shape of every tensor a model's loader reads; `absent(name)` names the
    optional tensors it does not hold. Running a port loader over it on the
    meta device gives the names of a checkpoint that loader reads back."""

    def __init__(self, absent=lambda name: False):
        self.shapes, self.absent = {}, absent

    def __contains__(self, name) -> bool:
        return not self.absent(name)

    def load(self, name, shape=None, dtype_=np.float32):
        self.shapes[name] = tuple(shape)
        return np.broadcast_to(np.zeros((), np.float32), shape)


def recorded_tensors(build, dev, seed: int, absent=lambda name: False, gains: dict = None) -> dict:
    """name -> random bf16 tensor on the card of every tensor `build(loader,
    device)` reads: a 1-D `.weight` ones (norms), other 1-D tensors and
    biases N(0, 0.02^2), embeddings N(0, 1), scalars ln(100) (CLIP's logit
    scale), other weights U(+-1/sqrt(fan_in)); `gains` (name suffix ->
    factor) scales the tensors whose names end so."""
    rec = RecordingLoader(absent)
    build(rec, torch.device("meta"))
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, shape in sorted(rec.shapes.items()):
        if len(shape) == 0:
            t = torch.full(shape, float(np.log(100.0)), device=dev)
        elif len(shape) == 1:
            t = (torch.ones(shape, device=dev) if name.endswith("weight") and "embed" not in name
                 else torch.randn(shape, generator=g, device=dev) * 0.02)
        elif "embed" in name and "patch" not in name and "proj" not in name:
            t = torch.randn(shape, generator=g, device=dev)
        else:
            fan_in = int(np.prod(shape[1:]))
            t = (torch.rand(shape, generator=g, device=dev) * 2 - 1) / fan_in ** 0.5
        for suffix, gain in (gains or {}).items():
            if name.endswith(suffix):
                t = t * gain
        out[name] = t.to(torch.bfloat16)
    return out


def write_entry_dir(path: str, config: dict, tensors: dict, tokenizer: dict = None) -> int:
    """A model directory: config.json, model.safetensors (`write_safetensors`)
    and, when given, tokenizer.json. Returns the file's bytes."""
    from mllm_tpu_torch.core.param_loader import write_safetensors

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    if tokenizer is not None:
        with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
            json.dump(tokenizer, f, ensure_ascii=False)
    write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    return os.path.getsize(os.path.join(path, "model.safetensors"))


def qwen_vl_entry_dir(path: str, dev, lm: dict, vision: dict, seed: int, tok: dict, v25: bool = False) -> int:
    """An HF Qwen2-VL (or, v25, Qwen2.5-VL) directory: the LM as `cli_tensors`
    (untied head) but with an N(0, VL_EMBED_STD^2) embedding, the tower from
    its `init` under its HF names (`tower_names`), the vision tokens the
    tokenizer's last four. A random tower's deep residual stream loses its
    patches (most of its output's rms is one vector common to every image
    token: `common_share`), so the prompt's mean over its image tokens is one vector in
    every layer; against it an N(0, 1) token fades, and a 28-layer model
    decodes one id over and over. At VL_EMBED_STD each step's token leads."""
    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.models.qwen2_5_vl import Qwen25VLVisionConfig, Qwen25VLVisionTower
    from mllm_tpu_torch.models.qwen2_vl import Qwen2VLVisionConfig, Qwen2VLVisionTower, tower_names

    text = TextConfig(**dict(lm, max_position_embeddings=4096))
    if v25:
        vcfg = Qwen25VLVisionConfig(**dict(dict(out_hidden_size=text.hidden_size), **vision))
        tower = Qwen25VLVisionTower.init(vcfg, device=dev, dtype=torch.bfloat16,
                                         generator=torch.Generator(device=dev).manual_seed(seed))
    else:
        vcfg = Qwen2VLVisionConfig(**dict(dict(hidden_size=text.hidden_size), **vision))
        tower = Qwen2VLVisionTower.init(vcfg, device=dev, dtype=torch.bfloat16,
                                        generator=torch.Generator(device=dev).manual_seed(seed))
    tensors = cli_tensors(text, dev, seed)
    tensors["model.embed_tokens.weight"] = (tensors["model.embed_tokens.weight"].float() * VL_EMBED_STD).to(torch.bfloat16)
    sd = tower.state_dict()
    tensors.update({ck: sd[key].to(torch.bfloat16) for key, ck in tower_names(tower).items()})
    del tower
    ids = {name: text.vocab_size - len(QWEN2VL_SPECIALS) + i for i, name in enumerate(QWEN2VL_SPECIALS)}
    vc = {k: (list(v) if isinstance(v, tuple) else v) for k, v in vcfg.__dict__.items()}
    config = dict(hf_config(text), model_type="qwen2_5_vl" if v25 else "qwen2_vl", tie_word_embeddings=False,
                  vision_config=vc, rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]},
                  image_token_id=ids["<|image_pad|>"], video_token_id=ids["<|video_pad|>"],
                  vision_start_token_id=ids["<|vision_start|>"], vision_end_token_id=ids["<|vision_end|>"])
    return write_entry_dir(path, config, tensors, tok)


def entry_png(path: str, seed: int) -> str:
    """A PNG written by PIL: a seeded VL_RAW_PX-square frame resized to
    VL_IMAGE_PX (bicubic, as slice_vl resizes the bench row's frame)."""
    from PIL import Image

    raw, px = VL_RAW_PX, VL_IMAGE_PX
    frame = np.random.default_rng(seed).integers(0, 256, (raw, raw, 3), np.uint8)
    Image.fromarray(frame).resize((px, px), Image.BICUBIC).save(path)
    return path


def entry_wav(path: str, seed: int, sr: int = 16000, seconds: int = 5) -> str:
    """A mono 16-bit WAV of seeded noise, written with numpy and `wave`."""
    import wave

    data = (np.random.default_rng(seed).standard_normal(sr * seconds) * 6000).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data.tobytes())
    return path


def entry_call(fn, argv: list):
    """`cli_call` with flash_attention's launches at head_dim 80 (the vision
    towers) apart, as "flash_attention@80"."""
    flash = wrappers()["flash_attention"]
    flash.launches_at.clear()
    out, launches, seconds, lines = cli_call(fn, argv)
    at80 = flash.launches_at.get(80, 0)
    launches = dict(launches, **{"flash_attention": launches.get("flash_attention", 0) - at80,
                                 "flash_attention@80": at80})
    return out, launches, seconds, lines


class keep_loaded:
    """With this, module.<name> (a loader) also appends what it returns to
    `.models`: the model a demo built, for the direct call."""

    def __init__(self, module, name: str):
        self.module, self.name, self.models = module, name, []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def wrapped(*a, **k):
            out = self.real(*a, **k)
            self.models.append(out)
            return out
        setattr(self.module, self.name, staticmethod(wrapped) if isinstance(self.module, type) else wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, staticmethod(self.real) if isinstance(self.module, type) else self.real)


@torch.no_grad()
def greedy_forward(model, logits, cache, n: int) -> list:
    """The greedy ids `vl_decode_loop` streams (no eos: the synthetic
    tokenizers have none), each step one forward without the image."""
    dev = logits.device
    out = [int(torch.argmax(logits[0, -1]))]
    for _ in range(n - 1):
        logits, cache = model(torch.tensor([[out[-1]]], device=dev), cache)
        out.append(int(torch.argmax(logits[0, -1])))
    return out


def rel_diff(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def common_share(x) -> float:
    """rms of the rows' mean over the rms of the rows of x [n, d]: 1 when
    every row is one vector, about 1/sqrt(n) for independent rows."""
    x = x.float()
    return float(x.mean(0).pow(2).mean().sqrt() / x.pow(2).mean().sqrt())


def entry_parity(dev, root: str, bad: list, background) -> None:
    """Item 1: the checkpoints at the full reference geometries
    (`gen_checkpoint`, `gen_checkpoint_tinyllama`) written under root by the
    `background` executor's threads (numpy draws and file writes leave the
    interpreter free, so the second is written while the first family runs),
    then for each family `greedy_ids` in f32 on the card from the golden's
    recorded input ids: all 32 output ids equal, no attention kernel
    launched (f32 takes `sdpa`); then the checkpoint is deleted."""
    from mllm_tpu_torch.tools import reference_parity as rp

    repo = os.path.dirname(os.path.abspath(__file__))
    families = (("qwen05b", rp.gen_checkpoint), ("tinyllama", rp.gen_checkpoint_tinyllama))
    t0 = time.perf_counter()

    def gen_timed(gen, path):
        gen(path)
        return time.perf_counter() - t0

    written = [background.submit(gen_timed, gen, os.path.join(root, f"parity_{family}")) for family, gen in families]
    for (family, _), done in zip(families, written):
        with open(os.path.join(repo, GOLDENS[family])) as f:
            golden = json.load(f)
        path = os.path.join(root, f"parity_{family}")
        gen_s = done.result()  # seconds from the phase's first draw until this checkpoint was on disk
        stats = {}
        got, launches, seconds, _ = cli_call(
            lambda a: rp.greedy_ids(path, golden["input_ids"], len(golden["output_ids"]), device=dev,
                                    stats=stats), [])
        gaps = stats["top2_gaps"]
        emit(phase="slice_entry_parity", family=family, input_ids=len(golden["input_ids"]),
             equal=got == golden["output_ids"], first_divergence=first_divergence(got, golden["output_ids"]),
             ids=got, golden=golden["output_ids"], distinct=len(set(got)), top2_gaps=gaps, min_top2_gap=min(gaps),
             checkpoint_bytes=os.path.getsize(os.path.join(path, "model.safetensors")), written_after_s=gen_s,
             generation_s=seconds, load_s=stats["load_s"], decode_s=stats["decode_s"],
             tf32=torch.backends.cuda.matmul.allow_tf32, launches={k: v for k, v in launches.items() if v})
        shutil.rmtree(path, ignore_errors=True)
        if got != golden["output_ids"]:
            bad.append(f"parity {family}: ids leave the golden at {first_divergence(got, golden['output_ids'])}")
        if any(launches.values()):
            bad.append(f"parity {family}: kernels launched in f32 {launches}")


def phase_slice_entry(dev) -> dict:
    """The last entry points as a user runs them, in process through each
    `main` on the card:
      1. reference parity (`tools.reference_parity`) at the full Qwen "0.5B"
         and TinyLlama-1.1B geometries in f32: the C++ engine's 32 golden
         ids each, no attention kernel (`entry_parity`, one family after
         the other);
      2. `demo_qwen2_vl` on a full Qwen2-VL-2B directory (the tower at
         QWEN2VL_VISION's defaults, QWEN2VL_2B_LM, bf16, HF names, a
         synthetic tokenizer with the vision specials) with a 532 px PNG
         (grid (1, 38, 38)), greedy ENTRY_NEW tokens in bf16 and `-q int8`:
         ids equal to `vl_generate` called directly on the model the demo
         loaded from the directory and the same inputs, at least 32
         head_dim-80 flash launches and 28 LM flash launches a prefill, 28
         decode launches a step, int8_matmul in the int8 run;
      3. the other demos at published widths and ENTRY_LAYERS layers:
         demo_showui (Qwen2-VL-2B), demo_qwen2_5_vl -q int4 (Qwen2.5-VL-3B),
         demo_phi3v, demo_fuyu, demo_opt, demo_clip, demo_vit, demo_bert,
         demo_imagebind (ImageBind-huge, random, with a WAV) and
         demo_imagebind_1mod: each demo's ids or scores equal to the model it
         built called directly on the same inputs (ids exactly, scores within
         ENTRY_SCORE_TOL x max), finite;
      4. train_lora on QWEN2VL_2B_LM's widths at LORA_LAYERS layers (f32):
         4 steps (seq 256, batch 2, lr 1e-2, --alpha LORA_ALPHA) with --ckpt
         and --out, then
         --resume for 2 more: finite losses, step 4's below step 1's, the
         resume from step 4 to 6, no attention kernel in the steps;
         demo_llm on the merged directory (bf16) equal to `generate` on it;
      5. `python -m mllm_tpu_torch.examples.demo_qwen2_vl ... --max-new 8`
         on the 2-layer Qwen2-VL directory exits 0, and with
         CUDA_VISIBLE_DEVICES="" exits non-zero with default_device's
         message (the two at once, started when the phase has written that
         directory, before item 1, and collected last).
    Every generating run's ENTRY_NEW ids hold at least ENTRY_DISTINCT
    distinct ids (an echo or a fixed point would make the equalities above
    compare one repeated id). Prints each run's seconds, prefill and decode
    tok/s or score ms beside the card's name and power limit. Files live in
    a temporary directory under <repo>/build (as slice_cli's) that the phase
    deletes. Returns the launches of the runs."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from mllm_tpu_torch.core.config import TextConfig
    from mllm_tpu_torch.examples import (demo_bert, demo_clip, demo_fuyu, demo_imagebind, demo_imagebind_1mod,
                                         demo_llm, demo_opt, demo_phi3v, demo_qwen2_5_vl, demo_qwen2_vl,
                                         demo_showui, demo_vit, train_lora)
    from mllm_tpu_torch.models import bert as mbert
    from mllm_tpu_torch.models import clip as mclip
    from mllm_tpu_torch.models import fuyu as mfuyu
    from mllm_tpu_torch.models import imagebind as mib
    from mllm_tpu_torch.models import opt as mopt
    from mllm_tpu_torch.models import phi3v as mphi3v
    from mllm_tpu_torch.models import qwen2_5_vl as mvl25
    from mllm_tpu_torch.models import qwen2_vl as mvl
    from mllm_tpu_torch.models import registry
    from mllm_tpu_torch.models import vit as mvit
    from mllm_tpu_torch.processor.image import ClipImageProcessor, load_image, rescale_normalize, resize
    from mllm_tpu_torch.processor.qwen2_vl import Qwen2VLProcessor
    from mllm_tpu_torch.tokenizers.hf_json import auto_tokenizer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    repo = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(repo, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_entry_", dir=os.path.join(repo, "build"))
    total = {name: 0 for name in SOURCES}
    runs, bad, procs = [], [], []
    L = QWEN2VL_2B_LM["num_hidden_layers"]

    def run(name, fn, argv, need=None, none=()):
        """One entry point's call: its launches added up and gated (need(out)
        -> {kernel: least launches}; `none`: kernels that must not launch)."""
        out, launches, seconds, lines = entry_call(fn, argv)
        for k, n in launches.items():
            key = "flash_attention" if k == "flash_attention@80" else k
            total[key] = total.get(key, 0) + n
        want = need(out) if need else {}
        short = {k: (launches.get(k, 0), n) for k, n in want.items() if launches.get(k, 0) < n}
        wrong = {k: launches[k] for k in none if launches.get(k, 0)}
        row = dict(run=name, seconds=seconds, stdout_lines=lines, launches={k: v for k, v in launches.items() if v},
                   launches_expected_at_least=want)
        if out.get("ids") and isinstance(out["ids"][0], int):  # a generating run (the encoders' are token rows)
            n = len(out["ids"])
            if len(set(out["ids"])) < ENTRY_DISTINCT:
                bad.append(f"{name}: {len(set(out['ids']))} distinct ids of {n} (an echo or a fixed point): "
                           f"{out['ids']}")
            row.update(new_tokens=n, first_ids=out["ids"][:8], distinct=len(set(out["ids"])),
                       prefill_tok_s=out.get("prefill_tps") or out["prompt_len"] / out["ttft_s"],
                       decode_tok_s=out.get("decode_tps") if "seconds" not in out
                       else (n - 1) / (out["seconds"] - out["ttft_s"]))
        if "score_s" in out:
            row["score_ms"] = out["score_s"] * 1e3
        if "losses" in out:
            row.update(losses=out["losses"], steps=[out["start_step"], out["end_step"]],
                       s_per_step=out["seconds"] / max(len(out["losses"]), 1))
        emit(phase="slice_entry_run", nvidia_smi=smi, **row)
        runs.append(row)
        if short or wrong:
            bad.append(f"{name}: launches short {short}, unexpected {wrong}")
        return out

    def same_ids(name, got, want):
        if got != want:
            bad.append(f"{name}: demo ids leave the direct call's at {first_divergence(got, want)}")

    def same_scores(name, got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        err = rel_diff(got, want)
        if not (np.isfinite(got).all() and err <= ENTRY_SCORE_TOL):
            bad.append(f"{name}: scores {got.ravel()[:6]} against the direct call's {want.ravel()[:6]} ({err})")
        return err

    def vl_direct(model, path, image, prompt):
        cfg = model.cfg
        proc = Qwen2VLProcessor(auto_tokenizer(path), image_token_id=cfg.image_token_id,
                                video_token_id=cfg.video_token_id)
        po = proc(proc.chat_text(prompt), images=image)
        toks, _ = mvl.vl_generate(model, po, model.init_cache(1, ENTRY_CACHE), ENTRY_NEW)
        return toks

    background = ThreadPoolExecutor(2)  # the parity checkpoints' writes
    marks = [("start", time.perf_counter())]
    try:
        # 5. the typed entry point's processes (on the 2-layer Qwen2-VL directory), started first
        tok_vl = synthetic_tokenizer(QWEN2VL_2B_LM["vocab_size"], 51, specials=QWEN2VL_SPECIALS)
        png = entry_png(os.path.join(root, "frame.png"), 52)
        lm2 = dict(QWEN2VL_2B_LM, num_hidden_layers=ENTRY_LAYERS)
        ui_dir = os.path.join(root, "showui")
        qwen_vl_entry_dir(ui_dir, dev, lm2, dict(QWEN2VL_VISION, depth=ENTRY_LAYERS), 53, tok_vl)
        t_procs = time.perf_counter()
        argv5 = ["mllm_tpu_torch.examples.demo_qwen2_vl", "-m", ui_dir, "-i", png, "--max-new", "8"]
        procs = start_processes(repo, [(argv5, {}), (argv5, {"CUDA_VISIBLE_DEVICES": ""})])
        marks.append(("processes_started", time.perf_counter()))

        # 1. reference parity in f32
        entry_parity(dev, root, bad, background)
        marks.append(("parity", time.perf_counter()))

        # 2. demo_qwen2_vl at full Qwen2-VL-2B
        vl_dir = os.path.join(root, "qwen2-vl-2b")
        nbytes, write_s = timed(lambda: qwen_vl_entry_dir(vl_dir, dev, QWEN2VL_2B_LM, QWEN2VL_VISION, 51, tok_vl))
        emit(phase="slice_entry_qwen2_vl_dir", file_bytes=nbytes, write_s=write_s)
        vl_args = ["-m", vl_dir, "-i", png, "--max-new", str(ENTRY_NEW)]
        depth = mvl.Qwen2VLVisionConfig(**QWEN2VL_VISION).depth

        def vl_need(o, **more):  # the tower, the LM prefill, a decode launch a layer a step
            return {"flash_attention@80": depth, "flash_attention": L,
                    "decode_attention": L * (len(o["ids"]) - 1), **more}

        for quant, kw in ((None, {}), ("int8", {"int8_matmul": 1})):
            with keep_loaded(mvl, "load_qwen2_vl") as kept:  # the model the demo loaded, for the direct call
                out = run(f"demo_qwen2_vl{'_' + quant if quant else ''}", demo_qwen2_vl.main,
                          vl_args + (["-q", quant] if quant else []), lambda o, _kw=kw: vl_need(o, **_kw))
            model = kept.models[0]
            direct = vl_direct(model, vl_dir, png, "Describe this image.")
            if quant is None:  # how far the random tower's image tokens are one vector (qwen_vl_entry_dir)
                proc = Qwen2VLProcessor(auto_tokenizer(vl_dir), image_token_id=model.cfg.image_token_id,
                                        video_token_id=model.cfg.video_token_id)
                po = proc(proc.chat_text("Describe this image."), images=png)
                with torch.no_grad():
                    img = model.visual(torch.as_tensor(po.patches, device=dev, dtype=torch.bfloat16), po.grid_thw)
                emit(phase="slice_entry_qwen2_vl_tower", image_tokens=int(img.shape[0]),
                     common_share=common_share(img), embed_std=VL_EMBED_STD)
            del kept, model
            same_ids(f"demo_qwen2_vl {quant or 'bf16'}", out["ids"], direct)
            if out["grid_thw"] != (1, VL_IMAGE_PX // 14, VL_IMAGE_PX // 14):
                bad.append(f"demo_qwen2_vl {quant}: grid {out['grid_thw']}")
        shutil.rmtree(vl_dir, ignore_errors=True)
        torch.cuda.empty_cache()
        marks.append(("qwen2_vl_2b", time.perf_counter()))

        # 3. the other demos at published widths, ENTRY_LAYERS layers (showui on the directory of item 5)
        with keep_loaded(mvl, "load_qwen2_vl") as kept:
            out = run("demo_showui", demo_showui.main, ["-m", ui_dir, "-i", png, "--max-new", str(ENTRY_NEW)],
                      lambda o: {"flash_attention@80": ENTRY_LAYERS, "flash_attention": ENTRY_LAYERS})
        same_ids("demo_showui", out["ids"], vl_direct(kept.models[0], ui_dir, png, demo_showui.GROUNDING))
        del kept

        v25_dir = os.path.join(root, "qwen2.5-vl-3b")
        v25_lm = dict(QWEN25VL_3B_LM, num_hidden_layers=ENTRY_LAYERS)
        qwen_vl_entry_dir(v25_dir, dev, v25_lm, dict(QWEN25VL_VISION, depth=ENTRY_LAYERS, fullatt_block_indexes=[1]),
                          54, synthetic_tokenizer(v25_lm["vocab_size"], 54, specials=QWEN2VL_SPECIALS), v25=True)
        with keep_loaded(mvl25, "load_qwen2_5_vl") as kept:  # int4 at load: no FusedInt4MLP (as the JAX loader)
            out = run("demo_qwen2_5_vl_int4", demo_qwen2_5_vl.main,
                      ["-m", v25_dir, "-i", png, "--max-new", str(ENTRY_NEW), "-q", "int4"],
                      lambda o: {"int4_matmul": 7 * ENTRY_LAYERS * (len(o["ids"]) - 1)}, ("fused_int4_mlp",))
        same_ids("demo_qwen2_5_vl", out["ids"], vl_direct(kept.models[0], v25_dir, png, "Describe this image."))
        del kept
        shutil.rmtree(v25_dir, ignore_errors=True)

        phi_cfg = dict(PHI3V_128K, num_hidden_layers=ENTRY_LAYERS,
                       img_processor=dict(PHI3V_128K["img_processor"], num_hidden_layers=ENTRY_LAYERS))
        phi_dir = os.path.join(root, "phi3v")
        phi = mphi3v.phi3v_config_from_hf(phi_cfg)
        write_entry_dir(phi_dir, phi_cfg, recorded_tensors(
            lambda ld, d: mphi3v.load_phi3v(ld, phi, device=d, dtype=torch.bfloat16), dev, 55,
            absent=lambda n: n.startswith("model.layers.") and n.endswith(".bias")),  # fused qkv, gate_up; no bias
            synthetic_tokenizer(phi_cfg["vocab_size"], 55, specials=PHI3_SPECIALS))
        with keep_loaded(mphi3v, "load_phi3v") as kept:
            out = run("demo_phi3v", demo_phi3v.main, ["-m", phi_dir, "-i", png, "--max-new", str(ENTRY_NEW)])
        model = kept.models[0]
        tok = auto_tokenizer(phi_dir)
        pixel = ClipImageProcessor(size=phi.vision.image_size, crop=phi.vision.image_size)(png)
        ids = [-1] * model.num_image_tokens + tok.encode("<|user|>\nWhat's in this image?<|end|>\n<|assistant|>\n")
        with torch.no_grad():
            lg, c = model(torch.tensor([ids], device=dev), model.init_cache(1, ENTRY_CACHE),
                          pixel_values=torch.as_tensor(pixel, device=dev))
        same_ids("demo_phi3v", out["ids"], greedy_forward(model, lg, c, ENTRY_NEW))
        del kept, model
        shutil.rmtree(phi_dir, ignore_errors=True)

        fuyu_cfg = dict(FUYU_8B, text_config=dict(FUYU_8B["text_config"], num_hidden_layers=ENTRY_LAYERS))
        fuyu_dir = os.path.join(root, "fuyu")
        fu = mfuyu.fuyu_config_from_hf(fuyu_cfg)
        write_entry_dir(fuyu_dir, fuyu_cfg, recorded_tensors(
            lambda ld, d: mfuyu.load_fuyu(ld, fu, device=d, dtype=torch.bfloat16), dev, 56,
            absent=lambda n: n.endswith((".__none__.weight", ".mlp.gate_up_proj.weight"))),  # relu^2, no up
            synthetic_tokenizer(fuyu_cfg["text_config"]["vocab_size"], 56))
        fuyu_png = os.path.join(root, "fuyu.png")
        from PIL import Image

        Image.fromarray(np.random.default_rng(56).integers(0, 256, (*FUYU_IMAGE_HW, 3), np.uint8)).save(fuyu_png)
        with keep_loaded(mfuyu, "load_fuyu") as kept:
            out = run("demo_fuyu", demo_fuyu.main, ["-m", fuyu_dir, "-i", fuyu_png, "--max-new", str(ENTRY_NEW)],
                      lambda o: {"flash_attention": ENTRY_LAYERS,
                                 "decode_attention": ENTRY_LAYERS * (len(o["ids"]) - 1)})
        model = kept.models[0]
        chw = load_image(fuyu_png).transpose(2, 0, 1).astype(np.float32) / 255.0 * 2 - 1
        patches = mfuyu.patchify_image(chw, fu.patch_size)
        ids = [fu.image_token_id] * patches.shape[0] + auto_tokenizer(fuyu_dir).encode("Generate a coco-style caption.\n")
        with torch.no_grad():
            lg, c = model(torch.tensor([ids], device=dev), model.init_cache(1, ENTRY_CACHE),
                          image_patches=torch.as_tensor(patches, device=dev))
        same_ids("demo_fuyu", out["ids"], greedy_forward(model, lg, c, ENTRY_NEW))
        del kept, model
        shutil.rmtree(fuyu_dir, ignore_errors=True)

        opt_cfg = dict(OPT_13B, model_type="opt", num_hidden_layers=ENTRY_LAYERS, word_embed_proj_dim=2048)
        opt_dir = os.path.join(root, "opt")
        oc = mopt.opt_config_from_hf(opt_cfg)
        # OPT ties its head to the embedding: with the N(0, 1) embedding leading the residual the model
        # echoes its input, and scaled down (to 0.02) the context's mean leads and one id repeats. An fc2
        # OPT_FC2_GAIN x wider makes each token's MLP features lead the final norm.
        write_entry_dir(opt_dir, opt_cfg, recorded_tensors(
            lambda ld, d: mopt.load_opt(ld, oc, device=d, dtype=torch.bfloat16), dev, 57,
            gains={"fc2.weight": OPT_FC2_GAIN}), synthetic_tokenizer(opt_cfg["vocab_size"], 57))
        with keep_loaded(mopt, "load_opt") as kept:
            out = run("demo_opt", demo_opt.main, ["-m", opt_dir, "--max-new", str(ENTRY_NEW)],
                      lambda o: {"flash_attention": ENTRY_LAYERS,
                                 "decode_attention": ENTRY_LAYERS * (len(o["ids"]) - 1)})
        model = kept.models[0]
        ids = [oc.bos_token_id] + auto_tokenizer(opt_dir).encode("Hello, who are you?")
        with torch.no_grad():
            lg, c = model(torch.tensor([ids], device=dev), model.init_cache(1, ENTRY_CACHE))
        same_ids("demo_opt", out["ids"], greedy_forward(model, lg, c, ENTRY_NEW))
        del kept, model
        shutil.rmtree(opt_dir, ignore_errors=True)

        clip_cfg = dict(CLIP_B32, text_config=dict(CLIP_B32["text_config"], num_hidden_layers=ENTRY_LAYERS),
                        vision_config=dict(CLIP_B32["vision_config"], num_hidden_layers=ENTRY_LAYERS))
        clip_dir = os.path.join(root, "clip")
        cc = mclip.clip_config_from_hf(clip_cfg)
        write_entry_dir(clip_dir, clip_cfg, recorded_tensors(
            lambda ld, d: mclip.load_clip(ld, cc, device=d, dtype=torch.float32), dev, 58),
            synthetic_tokenizer(cc.text.vocab_size, 58, specials=("<|startoftext|>", "<|endoftext|>")))
        texts = ["a photo of a cat", "a photo of a dog", "a diagram", "two birds on a wire"]
        with keep_loaded(mclip, "load_clip") as kept:
            out = run("demo_clip", demo_clip.main, ["-m", clip_dir, "-i", png, "--texts", *texts])
        pixel = ClipImageProcessor(size=cc.vision.image_size, crop=cc.vision.image_size)(png)
        with torch.no_grad():
            want = torch.softmax(kept.models[0](torch.tensor(out["ids"], device=dev),
                                                torch.as_tensor(pixel, device=dev)), dim=-1)[0].cpu()
        same_scores("demo_clip", out["probs"], want)
        del kept
        shutil.rmtree(clip_dir, ignore_errors=True)

        vit_cfg = dict(VIT_B16, num_hidden_layers=ENTRY_LAYERS)
        vit_dir = os.path.join(root, "vit")
        vc, n_labels, id2label = mvit.vit_config_from_hf(vit_cfg)
        write_entry_dir(vit_dir, vit_cfg, recorded_tensors(
            lambda ld, d: mvit.load_vit_classifier(ld, vc, n_labels, device=d, dtype=torch.float32,
                                                   id2label=id2label), dev, 59))
        with keep_loaded(mvit, "load_vit_classifier") as kept:
            out = run("demo_vit", demo_vit.main, ["-m", vit_dir, "-i", png, fuyu_png, "--top-k", "3"])
        px = np.concatenate([rescale_normalize(resize(load_image(p), vc.image_size, vc.image_size, "bilinear"),
                                               (0.5,) * 3, (0.5,) * 3).transpose(2, 0, 1)[None] for p in (png, fuyu_png)])
        want = kept.models[0].classify(torch.as_tensor(px, device=dev), 3)
        if [[lbl for lbl, _ in r] for r in out["preds"]] != [[lbl for lbl, _ in r] for r in want]:
            bad.append(f"demo_vit: labels {out['preds']} against {want}")
        same_scores("demo_vit", [[p for _, p in r] for r in out["preds"]], [[p for _, p in r] for r in want])
        del kept
        shutil.rmtree(vit_dir, ignore_errors=True)

        bert_cfg = dict(BERT_BASE, num_hidden_layers=ENTRY_LAYERS)
        bert_dir = os.path.join(root, "bert")
        bc = mbert.bert_config_from_hf(bert_cfg)
        write_entry_dir(bert_dir, bert_cfg, recorded_tensors(
            lambda ld, d: mbert.load_bert(ld, bc, device=d, dtype=torch.float32), dev, 60,
            absent=lambda n: n.startswith("bert.")),
            synthetic_tokenizer(bc.vocab_size, 60, specials=("[PAD]", "[UNK]", "[CLS]", "[SEP]")))
        with keep_loaded(mbert, "load_bert") as kept:
            out = run("demo_bert", demo_bert.main, ["-m", bert_dir])
        with torch.no_grad():
            emb = kept.models[0].sentence_embedding(torch.tensor(out["ids"], device=dev),
                                                    torch.tensor(out["mask"], device=dev)).float().cpu().numpy()
        same_scores("demo_bert", out["cosine"], emb @ emb.T)
        del kept
        shutil.rmtree(bert_dir, ignore_errors=True)

        wav = entry_wav(os.path.join(root, "clip.wav"), 61)
        ib_args = ["-i", png, "--audio", wav]
        with keep_loaded(mib.ImageBindModel, "init") as kept:
            out = run("demo_imagebind", demo_imagebind.main, ib_args)
            one = run("demo_imagebind_1mod", demo_imagebind_1mod.main, ib_args)
        cfg = mib.ImageBindConfig()
        pix = ClipImageProcessor(size=cfg.img_hw, crop=cfg.img_hw)(png)
        patches = mib.patchify_video(np.repeat(pix[:, :, None], cfg.time_frames, axis=2), cfg.patch, cfg.patch_time)
        from mllm_tpu_torch.processor.audio import ImageBindAudioProcessor

        ids, eot = demo_imagebind.text_ids(["a dog.", "a car", "a bird"], cfg)
        with torch.no_grad():
            vt, va = kept.models[0](*(torch.as_tensor(a, device=dev) for a in
                                      (ids, eot, patches, ImageBindAudioProcessor()(wav))))
        for name, res in (("demo_imagebind", out), ("demo_imagebind_1mod", one)):
            same_scores(name, res["vision_text"] + res["vision_audio"], torch.cat([vt[0], va[0]]).cpu())
        del kept
        torch.cuda.empty_cache()
        marks.append(("other_demos", time.perf_counter()))

        # 4. train_lora at the main LM's widths, LORA_LAYERS layers, f32
        lcfg = TextConfig(**dict(QWEN2VL_2B_LM, num_hidden_layers=LORA_LAYERS))
        base_dir, out_dir = os.path.join(root, "lora-base"), os.path.join(root, "lora-merged")
        ckpt, data = os.path.join(root, "lora.ckpt"), os.path.join(root, "data.txt")
        write_bf16_checkpoint(base_dir, lcfg, cli_tensors(lcfg, dev, 62), tok_vl)
        with open(data, "w") as f:
            f.write(LORA_TEXT)
        lora = ["-m", base_dir, "-d", data, "--seq", "256", "--batch", "2", "--lr", "1e-2", "--alpha", LORA_ALPHA,
                "--ckpt", ckpt]
        quiet = tuple(ATTENTION_KERNELS)
        first = run("train_lora", train_lora.main, lora + ["--steps", "4", "--out", out_dir], none=quiet)
        again = run("train_lora_resume", train_lora.main, lora + ["--steps", "2", "--resume"], none=quiet)
        losses = first["losses"] + again["losses"]
        if not (np.isfinite(losses).all() and len(first["losses"]) == 4 and first["losses"][3] < first["losses"][0]):
            bad.append(f"train_lora: losses {first['losses']} (finite, step 4 below step 1)")
        if (again["start_step"], again["end_step"]) != (4, 6):
            bad.append(f"train_lora --resume: steps {again['start_step']} -> {again['end_step']}, not 4 -> 6")
        with keep_loaded(registry, "auto_model") as kept:  # the model demo_llm loaded, for the direct call
            merged = run("demo_llm_merged", demo_llm.main, ["-m", out_dir, "--max-new", str(CLI_NEW)],
                         lambda o: {"flash_attention": LORA_LAYERS,
                                    "decode_attention": LORA_LAYERS * (len(o["ids"]) - 1)})
        direct, _ = direct_greedy(kept.models.pop())
        del kept
        same_ids("demo_llm on the merged model", merged["ids"], direct)
        shutil.rmtree(base_dir, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)
        marks.append(("train_lora", time.perf_counter()))

        # 5. the typed entry point's processes, started first
        typed, nocard = finish_processes(procs)
        refused = nocard.returncode != 0 and "runs on a CUDA card and found none" in nocard.stderr
        emit(phase="slice_entry_processes", seconds_from_start=time.perf_counter() - t_procs, rc=typed.returncode,
             report=[l for l in typed.stdout.splitlines() if "speed" in l or "prompt tokens" in l],
             no_card_rc=nocard.returncode, no_card_refused=refused,
             no_card_error=nocard.stderr.strip().splitlines()[-1:] if nocard.stderr.strip() else [])
        if typed.returncode != 0:
            bad.append(f"python -m demo_qwen2_vl exited {typed.returncode}: {typed.stderr[-1000:]}")
        if not refused:
            bad.append(f"no-card demo_qwen2_vl: rc {nocard.returncode}, stderr {nocard.stderr[-500:]}")
        marks.append(("processes", time.perf_counter()))
        emit(phase="slice_entry_items", seconds={b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])})
        emit(phase="slice_entry_rates", nvidia_smi=smi, runs=[
            {k: r[k] for k in ("run", "seconds", "prefill_tok_s", "decode_tok_s", "score_ms", "s_per_step")
             if k in r} for r in runs])
    finally:
        stop_processes(procs)
        background.shutdown(wait=True)
        shutil.rmtree(root, ignore_errors=True)
    if bad:
        raise AssertionError(f"slice_entry: {bad}")
    return {k: v for k, v in total.items() if k in SOURCES}


def timed_phase(name: str, fn):
    """fn(), its wall seconds printed as `<name>_seconds`."""
    t0 = time.perf_counter()
    out = fn()
    emit(phase=f"{name}_seconds", seconds=time.perf_counter() - t0)
    return out


def main():
    kind = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    rows = timed_phase("kernel_check", lambda: phase_kernels(dev))
    launches = {name: 0 for name in SOURCES}
    results = [timed_phase("slice", lambda: phase_slice(dev))]
    int8_launches, model8 = timed_phase("slice_int8", lambda: phase_slice_quant(dev, "int8", keep=True))
    results += [int8_launches, timed_phase("slice_kvq", lambda: phase_slice_kvq(dev, model8)),
                timed_phase("slice_sd", lambda: phase_slice_sd(dev, model8)),
                timed_phase("slice_prefill", lambda: phase_slice_prefill(dev, model8)),
                timed_phase("slice_engine", lambda: phase_slice_engine(dev, model8))]
    del model8
    torch.cuda.empty_cache()
    results += [timed_phase("slice_int4", lambda: phase_slice_quant(dev, "int4")),
                timed_phase("slice_mega", lambda: phase_slice_mega(dev)),
                timed_phase("head_dim_route", lambda: phase_head_dim_route(dev)),
                timed_phase("slice_int8a8", lambda: phase_slice_int8a8(dev))]
    container_launches, model, tok, root = timed_phase("slice_containers", lambda: phase_slice_containers(dev))
    results += [container_launches, timed_phase("slice_serve", lambda: phase_slice_serve(dev, model, tok))]
    del model
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    results += [timed_phase("slice_moe", lambda: phase_slice_moe(dev)),
                timed_phase("slice_moe_wide", lambda: phase_slice_moe_wide(dev)),
                timed_phase("slice_families", lambda: phase_slice_families(dev)),
                timed_phase("slice_vl", lambda: phase_slice_vl(dev)),
                timed_phase("slice_vl25", lambda: phase_slice_vl25(dev)),
                timed_phase("slice_clip", lambda: phase_slice_clip(dev)),
                timed_phase("slice_kvq256", lambda: phase_slice_kvq256(dev)),
                timed_phase("slice_llava", lambda: phase_slice_llava(dev)),
                timed_phase("slice_phi3v", lambda: phase_slice_phi3v(dev)),
                timed_phase("slice_fuyu", lambda: phase_slice_fuyu(dev)),
                timed_phase("slice_imagebind", lambda: phase_slice_imagebind(dev)),
                timed_phase("slice_opt_bert", lambda: phase_slice_opt_bert(dev)),
                timed_phase("slice_openelm", lambda: phase_slice_openelm(dev)),
                timed_phase("slice_deepseek", lambda: phase_slice_deepseek(dev)),
                timed_phase("slice_elastic", lambda: phase_slice_elastic(dev)),
                timed_phase("slice_mbp", lambda: phase_slice_mbp(dev)),
                timed_phase("slice_persist", lambda: phase_slice_persist(dev)),
                timed_phase("slice_train", lambda: phase_slice_train(dev)),
                timed_phase("slice_parallel", lambda: phase_slice_parallel(dev)),
                timed_phase("slice_cli", lambda: phase_slice_cli(dev)),
                timed_phase("slice_entry", lambda: phase_slice_entry(dev))]
    for phase_launches in results:
        for name, n in phase_launches.items():
            launches[name] += n
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        main_row = rows[name][MAIN_ROW[name]]
        kernel = dict(name=name, route="cuda", source=src, replaces=replaces,
                      launches=launches[name],
                      max_abs_err=max(r["max_abs_err"] for r in rows[name]),
                      ms=main_row["ms"], plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
                      bound_by=main_row["bound_by"], library_ms=main_row["library_ms"])
        if "rel_err" in main_row:
            kernel["max_rel_err"] = max(r["rel_err"] for r in rows[name])
        for extra in ("dense_sdpa_ms", "bf16_flash_ms", "bf16_decode_ms", "dense_decode_ms", "unfused_ms",
                      "padded_ms", "route_sdpa_ms"):
            if extra in main_row:
                kernel[extra] = main_row[extra]
        kernels.append(kernel)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
