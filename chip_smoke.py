#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit code):
  1. device   — name, count, ``nvidia-smi`` name and power limit;
  2. build    — every kernel from ``src/repro_torch/kernels/csrc`` with
                 ``nvcc``, one process per source, with the ``-Xptxas -v``
                 report (registers, shared memory, spills);
  3. kernels  — each kernel against its plain PyTorch version at qwen-7b's
                 shapes, with the tolerance stated (the sparse ones at the
                 layouts strategy1-3 give wo and the FFN, bf16 at T=4, 256
                 and 1024, and kernel 5's ungated gelu branch with biases
                 at starcoder2-7b's strategy2 FFN, T=4 and 256, each beside
                 sparse_dequantize + ``torch.matmul`` and ``torch.matmul``
                 on weights dequantized once, rows 100-103 bitwise across
                 the bf16 tile configurations (kernel 4 with and without
                 its bias, both branches of kernel 5), ragged T=37 and 300,
                 and weights and x off a 16-byte boundary bitwise equal to
                 aligned ones; the attention
                 kernel's slot-int8, paged and paged-int8 variants on a
                 scrambled page table of 16-token pages, paged bitwise
                 equal to slot at block_kv = 16, NaN in the null and
                 unleased blocks changing nothing); kernel, plain and
                 library-call times (CUDA events, L2 flushed before each
                 launch) beside the bound the card could reach; T=4 rows
                 bitwise equal inside T=256; the W4A16 kernel also at
                 T=1024 x 4096^2 and at qwen-7b's down (11008 -> 4096, T=4
                 and 1024), with dequantize + ``torch.matmul`` and
                 ``torch.matmul`` alone on a weight dequantized once, and
                 rows 100-103 alone bitwise inside T=17, 64, 256, 300 and
                 1024, and inside T=100, (every bf16 tile configuration)
                 with and without its f32 bias; kernel 2's gate/up stage
                 at qwen-7b's FFN (T=4, 256, 1024) with two
                 ``torch.matmul`` on weights dequantized once (and silu *
                 up) beside it, and its rows 100-103 bitwise across its
                 tile configurations, gated and (at starcoder2-7b's
                 widths) gelu with its f32 bias; kernel 3 at qwen-7b's
                 decode shape (hkv 4) and chatglm-6b's (hkv 2, rep 16);
                 the full-sequence flash
                 attention at the prefill shapes against its plain version
                 and the dense oracle, with ``scaled_dot_product_attention``
                 timed beside it and the kernel / SDPA factor, a row of B=3
                 and the last 64 queries of a call bitwise equal alone
                 (bf16 at d=128 and 64, f32), the last 300 of 1024 queries
                 bitwise equal alone (bf16); kernel 8 (the sLSTM scan) at
                 xlstm-1.3b's 4 heads of 512 with bf16 R over B=2 x L=512,
                 a ragged L=300 and a B=4 decode step from a state, on its
                 cluster kernel in each (16 CTAs a head, R in shared
                 memory), the 512 steps bitwise equal to 512 one-step calls
                 with the state carried, the chain floor timed beside it,
                 and the mLSTM decode cell at B=4, 4 heads of 1024, each
                 against its plain version (the scan also against
                 ``_slstm_step``'s loop), a row bitwise equal alone, an
                 inactive row's state kept, each with its ``-Xptxas -v``
                 lines; the 16-bit path: ``dense_matmul`` at T=4, 256 and
                 1024 x 4096^2 and at qwen-7b's 16-bit lm_head and wk/wv
                 (T=4), kernel 6 (the fused FFN with 16-bit weights) gated
                 at qwen-7b's widths (T=4, 256, 1024) and ungated gelu
                 with biases at starcoder2-7b's, kernel 2's gelu variant at
                 starcoder2-7b's widths and ``layernorm`` at 4 x 4608, each
                 with its library call (``torch.matmul``, the unfused
                 chain, ``F.layer_norm``) and the kernel / library factor;
                 rows 100-103 alone bitwise equal inside calls of 17, 64,
                 100, 256, 300 and 1024 tokens (every bf16 tile configuration;
                 row 299 in a ragged last tile) for ``dense_matmul`` with
                 and without its bias and for kernel 6 gated and gelu;
                 whether ``torch.matmul``'s rows are bitwise the same at
                 T=1, 4 and 256 as at T=64 is recorded; kernel 1 and kernel
                 2's whole FFN with their library chains (kernel 2 gelu:
                 the chain on weights dequantized once too); the KV write
                 (``kv_write``) bitwise equal to its plain version at
                 qwen-7b's per-layer K/V shape, slot and paged, bf16 and
                 int8, decode (a masked row, a rolling window's index) and
                 a 64-wide chunk (a dead row), the null block and dead
                 rows untouched, timed beside its byte bound and
                 ``index_put_`` on gathered rows; ``add_rmsnorm`` (the
                 residual add fused into the norm) bitwise equal to ``x +
                 h`` then the rmsnorm kernel, both outputs, bf16 and f32,
                 at 4, 64, 256 and 300 rows x 4096 and n alone, and its
                 wrapper refusing a row too wide to stage and a misaligned
                 operand; ``add_layernorm`` likewise against ``x + h``
                 then the layernorm kernel at 4, 64, 256 and 300 rows x
                 4608 (f32 stages 55 KB, past the 48 KB a block takes
                 without an opt-in), timed beside ``x + h`` then
                 ``F.layer_norm``, both layernorm wrappers refusing a row
                 past 64 KB, a width off 16 bytes and a misaligned
                 operand; the q/k/v epilogue
                 (``qkv_rope_write``: bias, RoPE, int8 quantizing, the
                 cache write and q's layout in one launch) bitwise equal to
                 the chain it replaced (bias adds, ``apply_rope``,
                 ``quantize_kv``, ``kv_write``), q at every live position
                 and every leaf, slot and paged, bf16 and int8, decode (a
                 masked row, a row at the span's last position) and a
                 64-wide chunk (a dead row), at
                 qwen-7b's, chatglm-6b's and starcoder2-7b's heads, the
                 null block and dead rows untouched; each timed beside its
                 byte bound and the chain; the MoE kernels
                 (``check_moe_kernels``) at granite-moe-3b-a800m's widths
                 (d 1536, d_ff 512, 40 experts, top-8, 32-row groups: a
                 decode tick T=4 and a 4 x 64 chunk at the dropless
                 capacity and at the published factor's, which drops) and
                 mixtral-8x22b's (d 6144, d_ff 16384, 8 experts, top-2,
                 128-row groups, T=4): ``moe_route`` with the router's
                 product inside it, its logits bitwise ``dense_matmul``'s
                 and its route bitwise the same kernel's on those logits
                 (the chain it replaced), and on given logits bitwise the
                 plain version (weights within 2 ulp), the grouped gate/up
                 and down within the W4A16 tolerance (the two on their
                 persistent ring, printed beside the grid-per-expert
                 kernels' times, ``MOE_GRID_MS``), ``moe_combine`` bitwise,
                 ``combine_add_rmsnorm`` bitwise ``moe_combine`` then
                 ``add_rmsnorm``, each beside its bound, plain version and
                 yardstick (the fused two beside the chains they
                 replaced, ``chain_ms``); a token's layer
                 output alone bitwise inside the chunk; kernels 1 and 2
                 at 32- and 64-row groups with their tile invariance (the
                 library call also on weights dequantized once); the
                 tied LM head (the 49155 x 1536 embedding read in place)
                 against its plain version and the copied weight; the
                 dense family's rest: kernel 3's four variants at
                 gemma-2b's heads (8 over one KV head of 256, bf16: B=4,
                 MAX 512, C=1 and 64, the scrambled table, paged bitwise
                 slot at block_kv 16, NaN in unleased blocks harmless),
                 kernel 7 at d=256 (gemma-2b causal S=2048, ragged
                 S=300, bf16 and f32; a row of B=3 and the last 64 and
                 300 queries bitwise alone in bf16), the epilogue with
                 qwen3-8b's per-head q/k RMSNorm (32/8 heads of 128)
                 bitwise the chain through the rmsnorm kernel, and at
                 gemma-2b's heads; kernel 2's geglu gate/up and whole FFN
                 at gemma-2b's widths (2048 -> 2 x 16384, T=4 and 256)
                 beside dequantize + the chain, its rows 100-103 bitwise
                 across the tile configurations; whisper-small's
                 (``check_whisper_kernels``, bf16): kernel 1 at 768 ->
                 768 and the down 3072 -> 768 with its f32 bias, kernel
                 2g's up 768 -> 3072 with its bias, each at T=4 and at
                 the encoder's 1500 rows, and ``dense_matmul`` on the
                 tied 51865 x 768 head read in place (T=4), each beside
                 its library call (kernels 1 and 2g: also on weights
                 dequantized once) and bound; the position table built
                 on the card against the CPU's (1500 x 768, row p within
                 1e-6 + 2 p 2^-23); kernel 3's slot and paged fp variants
                 at whisper's heads (12 over 12 of 64, bf16, B=4, C=1 and
                 64, the scrambled table) in ``ATTENTION_SHAPES``; kernel
                 7 without a mask at the encoder's Sq = Skv = 1500 and the
                 cross-attention's decode shape (B=4, Sq=1, Skv=1500), and
                 causal at the decoder's prefill (B=2, S=256), d 64, in
                 ``FLASH_CASES``; zamba2-7b's (``check_hybrid_kernels``,
                 bf16): kernel 1 at in_proj (3584 -> 14576, a ragged last
                 column block) and out_proj (7168 -> 3584) at T=4 and 256
                 (the library call also on the weight dequantized once),
                 the Mamba2 cell (``mamba_cell``: conv, state update,
                 readout; B=4, 112 heads of 64 x 64) against its plain
                 version with an inactive row's window and state kept and
                 row 2 alone bitwise row 2 of B=4, the gated norm
                 (``rmsnorm_gated``, 4 x 7168, z a strided view of the
                 in_proj row) bitwise its chain, the fused step the
                 served path takes (``mamba_cell_gated``: both in one
                 launch, B=4) bitwise the two kernels it replaced (the
                 gated row, window and state; an inactive row, row 2
                 alone), each beside its bound, plain version and library
                 call or yardstick (the fused step's: the pair); kernel 3's
                 slot and paged fp variants at 32 over 32 heads of 112
                 (rows staged 128 wide) in ``ATTENTION_SHAPES``; kernel 7
                 at head dim 112 (causal S=2048, ragged S=300; float32
                 refused) in ``FLASH_CASES``; qwen2-vl-7b's
                 (``check_vlm_kernels``, bf16, T=4 and 64): kernel 1 at
                 wq/wo (3584^2), wk/wv (3584 -> 512), the down (18944 ->
                 3584) and the lm_head (3584 -> 152064), kernel 2's
                 gate/up (3584 -> 2 x 18944) with the whole FFN timed,
                 each (the whole FFN too) beside its library call (also
                 on weights dequantized once) and bound; the epilogue as
                 an M-RoPE
                 config's steps call it bitwise the ``apply_mrope`` chain
                 at equal ids (``check_mrope_epilogue``: 28 over 4 heads,
                 slot and paged, bf16 and int8, C=1 and 64), and at
                 those heads in ``EPILOGUE_HEADS``; kernel 3's slot bf16
                 and paged int8 variants at rep 7 in ``ATTENTION_SHAPES``;
                 kernel 7 over an image and text (B=2, S=556, rep 7) in
                 ``FLASH_CASES``;
  4. model    — qwen2-vl-7b (the vlm family: 28 layers, d 3584, 28 over 4
                 heads of 128, M-RoPE, "dense") at full width and depth
                 on the slot cache and a 20-block pool of 16-token pages
                 in int8 (``qwen2-vl-dense``, ``qwen2-vl-dense-paged-
                 int8``), text only as the reference serves it, through
                 (a)-(c) and phase 5 as every transformer path, graph
                 replay vs eager, traced, prefilled;
                 zamba2-7b (the hybrid family: d 3584, shared-block
                 sites of 32 heads of 112, "dense"; 27 of its 81 Mamba2
                 layers, 4 of its 13 sites and the tail,
                 ``ZAMBA2_SERVED_LAYERS``) on the slot cache and a
                 20-block pool of 16-token pages (``zamba2-dense``,
                 ``zamba2-dense-paged``), through
                 (a)-(c) and phase 5 as every transformer path (every
                 conv window, SSM state and K/V leaf held bitwise; (c)
                 with ``mamba_cell_gated`` against its chain, the cell
                 kernel then ``rmsnorm_gated``'s), graph replay
                 vs eager, traced (each hybrid kernel's in-graph ms,
                 ``hybrid_trace``), prefilled;
                 whisper-small (the audio family: 12 encoder and 12
                 decoder layers, d 768, 1500 frames, "dense") on the slot
                 cache and a 20-block pool of 16-token pages
                 (``whisper-dense``, ``whisper-dense-paged``), its caches
                 holding seeded frames' cross K/V (``fresh_cache``),
                 through (a)-(c) and phase 5 as every transformer path
                 (the cross leaves held bitwise too; no rolling window),
                 an admission (encoder, cross K/V, insert) without a host
                 read, graph replay vs eager with the ``("admit", 1500)``
                 key held against its eager function (and timed); traced,
                 no copy of 64 MiB or more in a captured step or
                 admission (``LARGE_COPY_BYTES``); prefilled;
                 qwen1.5-4b (MHA 20 x 128, d 2560, d_ff 6912),
                 qwen3-8b (the q/k norm inside the epilogue) and
                 gemma-2b (head dim 256, MQA, GeGLU, the scaled and tied
                 embedding; also from a 20-block pool of 16-token pages
                 in int8, ``gemma-2b-dense-paged-int8``), each "dense" at
                 full width and depth, through (a)-(c) and phase 5 as
                 every transformer path (qwen3-8b and gemma-2b also
                 graph replay vs eager; gemma-2b traced and prefilled);
                 granite-moe-3b-a800m at full width and depth
                 (``granite-moe-dense``) and mixtral-8x22b at full width,
                 4 of its 56 layers (``mixtral-dense``), both "dense" at
                 the dropless capacity factor (``MODEL_OVERRIDES``),
                 through (a)-(c) and phase 5 as every transformer path;
                 qwen-7b at full width and depth, random weights from a
                 seeded generator, quantized "dense" (W4A16), "strategy2"
                 (16 of its 32 layers, ``STRATEGY2_SERVED_LAYERS``) and
                 "strategy3" (log-scale sparse), chatglm-6b (the
                 paper's ChatGLM2-6B, "dense"), xlstm-1.3b ("dense", 16
                 of its 48 blocks, ``XLSTM_SERVED_BLOCKS``, the path
                 ``xlstm-dense``), qwen-7b with 16-bit
                 weights (``none``) and starcoder2-7b (LayerNorm, the
                 ungated gelu FFN with biases; ``starcoder2-none``,
                 ``starcoder2-dense`` and ``starcoder2-strategy2``, whose
                 FFN runs kernel 5's gelu branch and kernel 4 with the
                 down bias), one model at a time:
                 mixed_step over a 13-token prompt in 8-token chunks is
                 bitwise equal to 13 sequential decode steps (logits and
                 every cache leaf of all layers, or every state leaf of
                 all blocks); strategy2 also with int8 K/V, a paged pool
                 and a paged int8 pool; (b) on every transformer path,
                 four rows at lengths 0, 5, 13 and 29 through
                 ``mixed_step(all_logits=True)`` at W = 4 and then 8
                 (ragged q_lens, a dead row; paged: a scrambled page
                 table): every live position's logits and every cache
                 leaf bitwise equal to sequential decode_steps (the
                 speculating engine's verify surface: the lm_head at
                 T = 16 and 32 rows, kernel 3 and ``kv_write`` at C = 4
                 and 8); (c) on every transformer path a mixed step (W =
                 64) and a decode step through ``add_rmsnorm`` (or
                 ``add_layernorm``) and ``qkv_rope_write`` bitwise equal,
                 logits and every cache leaf, to the same steps with the
                 ops' plain chains,
                 and 20 decode steps through a 16-token span under a
                 16-token window (a rolling buffer, positions past the
                 span) likewise; on every path a mixed step, a decode step, a
                 verify tick (transformers) and a copy-on-write of a pool
                 block (paged) under ``torch.cuda.set_sync_debug_mode(
                 "error")`` (no host read); (d) on granite-moe-dense at
                 the published capacity factor 1.25, a W = 64 mixed step
                 through the MoE kernels and their plain versions: the
                 assignments each layer drops recorded, one layer's the
                 same in both and > 0; after phase 5 on dense,
                 dense-spec, strategy2-paged-int8, xlstm-dense,
                 starcoder2-dense and granite-moe-dense, every
                 captured key's graph replayed once against its function
                 run eagerly on a copy of the cache, logits and every
                 leaf bitwise equal;
  5. serving  — with each of the seventeen weight sets, the engine serves 9
                 requests twice (whisper's with seeded frames each,
                 ``audio_frames``, the oracle ``reference_decode`` with
                 them; launches ``expected_launches_audio``: per-step
                 counts x token columns plus each admission's), every tick one replay of a CUDA graph
                 captured per compile key: misses within
                 ``compile_budget``, the second run capturing nothing and
                 giving the first run's streams; capture seconds per key,
                 tokens/s, TTFT, ITL and peak memory of each run; on
                 dense, strategy2-paged, xlstm-dense, starcoder2-dense and
                 granite-moe-dense a ``torch.profiler`` trace of one
                 decode and one mixed tick, eager and replayed (host ms,
                 device-busy ms, device operations, and none of RoPE's
                 cos, sin or cat, no bf16 add and no copy of 64 MiB or
                 more in a replayed transformer tick; on granite each
                 MoE kernel's in-graph ms, ``moe_kernel_ms``); every token
                 stream equals ``reference_decode``
                 and the kernel launch counts (reset before each run,
                 read just after it; a replay adds its capture's counts)
                 equal layers x calls x ticks as
                 the weights' types and the cache route them (the xLSTM:
                 per-step counts x the token columns the ticks dispatched,
                 since a mixed tick steps its chunk width).  Strategy2
                 is served again from int8 K/V, from a 20-block pool of
                 16-token pages (the 200-token request needs 14, so
                 admissions stall) and from the same pool in int8, with
                 ``audit()`` on every tick and the pool whole after the
                 drain.  Three engines more, twice each: ``dense-spec``
                 (dense weights, ``spec_k=4``, 8 prompts of a 2-5 token
                 pattern tiled 3 times and the 200-token prompt; drafts
                 scored) and ``strategy2-paged-prefix`` /
                 ``strategy2-paged-int8-prefix`` (the 20-block pool,
                 ``prefix_cache=True`` and ``spec_k=4``, 8 prompts of one
                 40-token system prompt, one of them repeated whole, and
                 the 200-token prompt; every run hits the cache and
                 copies on write, run 1 hits what run 0 left, only cache
                 references are live after run 0 and the pool is whole
                 after ``drop_prefix_cache()``), with acceptance rate,
                 accepted tokens per verify dispatch, prefix hit tokens
                 and evictions recorded; every key's graph of every path
                 replayed on dead inputs under ``set_sync_debug_mode(
                 "error")``.  Two lifecycle engines on strategy2 (each
                 tick still one replay, run 1 of the engine capturing
                 nothing): ``strategy2-paged-lifecycle`` (the 20-block
                 pool, ``prefix_cache``, ``max_preemptions=2``, a clock one
                 unit a tick, driven one ``run(max_steps=1)`` at a time:
                 a shortfall preempts the 200-token request, a priority-2
                 request preempts its way into a full batch, a deadline
                 expires mid-decode, a cancel lands between two runs, and
                 a prompt holding a token whose ``embed`` row is NaN on
                 the card is quarantined alone by the finiteness that
                 comes back with the ids, its slot and blocks reused by
                 later requests; every done stream equals
                 ``reference_decode``, every cut one is a prefix of it)
                 and ``strategy2-paged-int8-chaos`` (the int8 pool,
                 sharing, ``spec_k=4`` and the reference soak's chaos
                 rates at seed 1: every request terminal, done streams
                 bitwise the oracle's, faulted ones a prefix of it, no
                 block leaked), and ``strategy2-paged-int8-restart``
                 (that engine without faults, ``snapshot_dir`` in a fresh
                 temporary directory, a snapshot every 6 ticks and the
                 journal: life 0 killed at the top of its tick 7, life 1,
                 restored, at its 5th tick, life 2 restored and drained;
                 the durable streams equal ``strategy2-paged-int8-
                 prefix``'s, each rid terminal once, each life's misses
                 within the budget and none after a restore's captures,
                 the audit green every tick, the pool whole after
                 ``drop_prefix_cache()``, life 2's peak memory within 5 %
                 of life 0's (the dead engines freed), the restored
                 engine's replays free of host reads; snapshot bytes and
                 seconds, restore seconds by phase and the journal's fsync
                 seconds recorded); the traced replayed ticks make one
                 device-to-host copy with the engine's fetch, and a dense
                 decode tick at most ``DENSE_DECODE_OPS`` operations;
  6. prefill  — on qwen-7b, chatglm-6b and gemma-2b "dense" (gemma-2b:
                 kernel 7 at head dim 256 inside the model): forward's
                 last position
                 bitwise equal to prefill's logits, launch counts exact
                 (the path ``<model>-prefill``: every residual add in the
                 launch of the norm after it, ``add_rmsnorm`` 2L times a
                 call); the slot prefill against
                 the one-mixed_step route; greedy prefill + decode against
                 the engine's stream; qwen-7b: 8192 tokens in two chunks
                 against one shot.  On strategy2: the int8 slot prefill
                 and the paged prefill (kernel 3's paged variant, never the
                 flash kernel) against their engines, with their seconds
                 (kernels 4 and 5 at T=200).  On xlstm-1.3b:
                 forward's launches exact (kernel 8 once per sLSTM block,
                 the path ``xlstm-dense-prefill``) and prefill's (512
                 recurrent steps); in float32, forward's last position
                 within ``XLSTM_PREFILL_TOL`` of prefill's (bf16's gap
                 recorded); greedy prefill + decode equal to the engine's
                 stream.  On zamba2-7b (``check_hybrid_prefill``):
                 forward at B=2 x S=256 (the chunked SSD and kernel 7 at
                 head dim 112) with exact launches (the path
                 ``zamba2-dense-prefill``) against prefill (256 recurrent
                 steps): the same top token, the bf16 gap recorded;
                 greedy prefill + decode equal to the engine's stream.
                 On qwen2-vl-7b (``check_vlm_prefill``): the dense
                 family's checks on text, then ``forward`` with 256
                 seeded patch embeddings of a 16 x 16 image before 300
                 tokens (B=2, S=556) at the image's distinct M-RoPE ids,
                 each layer's kernel 7 call held against its plain
                 version (rep 7), launches exact (the path
                 ``qwen2-vl-dense-vision``), the ids moving the logits;
                 and embedding rows as vision embeddings bitwise the same
                 tokens looked up.  On whisper-small (``check_audio_prefill``):
                 forward and the slot prefill at B=2, S=256 over seeded
                 frames, the last position bitwise, launch counts exact
                 (the encoder and the cross K/V once a call), greedy
                 prefill + decode of the 200-token request equal to the
                 engine's stream;
  7. training — after every served model is freed (``check_training``):
                 (a) kernel 7's backward (``flash_attention_bwd.cu``:
                 wgmma, TMA rings, two launches) against its plain version
                 on the o and lse of kernel 7's training forward, whose
                 output is bitwise the serving forward's, at qwen3-8b's
                 training shape (B=8, 32 / 8 heads of 128, S=256), S=2048
                 rep 4, window 256, ragged S=300, d=64, non-causal 448 x
                 1500, d=32, rows that see no key, chatglm-6b's rep 16
                 (32 / 2 heads, S=2048), qwen1.5-4b's rep 1 (20 / 20
                 heads, B=8, S=256) and ragged S=200 (past the dQ block's
                 128 rows); bitwise repeatable and a row of B=3 bitwise
                 alone; the RMSNorm backward (``rmsnorm_bwd.cu``) at 2048 x
                 4096, the q and k heads' rows, ragged rows and 8192 wide;
                 kernel, plain and autograd-through-SDPA / ``F.rms_norm``
                 times beside the bound, the training forward's time
                 beside the serving forward's, and at the timed shapes the
                 first designs (``flash_attention_bwd_sync.cu``,
                 ``rmsnorm_bwd_serial.cu``, on no path) held to the same
                 plain versions and timed between two timings of the
                 kernel (kernel / yardstick); (b) one step of qwen3-8b at
                 full width, 4 of its
                 36 layers (2.02 B parameters, f32 masters), through the
                 kernels against the same step through every op's plain
                 version: loss, gradient norm and each leaf's gradient
                 within ``TRAIN_*_TOL``, the step's launches exactly
                 ``expected_train_launches`` (the path ``qwen3-8b-train``);
                 (c) ten AdamW steps twice from one seed: losses finite,
                 step 0 near ln V + 1/2, the two runs bitwise equal, the
                 median step, tokens/s, peak memory and 6 N tokens / step
                 time against the bf16 peak; one more step traced
                 (``trace_train_step``): device-busy ms and the device ms
                 of kernel 7 and its backward, the RMSNorm pair, cuBLAS's
                 products, AdamW's passes and the loss; (d)
                 ``run_resumable`` at qwen3-8b-smoke in bf16, preempted
                 after step 3 and resumed to 6, bitwise an uninterrupted
                 run;
  then the ``kernels`` JSON line, the card's name and power limit, and the
     final ``{"ok": true, ...}`` line.  A kernel's ``launches`` is the
     count of one path's own run (``launches_path``: the path of the slice
     that ported it); ``launches_by_path`` gives every path's count.

The script imports nothing of JAX.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
L2_FLUSH_BYTES = 64 << 20          # larger than the 50 MB L2
SPIN_CYCLES = 1_000_000            # ~0.5 ms of GPU clock before each timing
DEVICE = "cuda"


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


# -- timing and bounds --------------------------------------------------------

class Timer:
    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def ms(self, fn, iters: int) -> float:
        """Mean device time of ``fn`` over ``iters`` launches, each after an
        L2 flush (weights are cold on the serving path), warmed up first.
        A spin kernel after the flush keeps the card busy while the host
        enqueues ``fn``, so the host's launch cost stays outside the events
        (for a call of many launches, gaps between them still count)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_errs(got, want) -> tuple[float, float]:
    d = (got.float() - want.float()).abs()
    scale = want.float().abs().max().clamp_min(1e-30)
    return float(d.max()), float(d.max() / scale)


# -- phase 3: kernels against their plain versions ---------------------------

def check_kernels(torch, timer, results: dict) -> dict:
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_flash import kv_block_size
    from repro_torch.kernels.ffn_fused import (
        ffn_gate_up_cuda, ffn_gate_up_torch)
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_torch
    from repro_torch.kernels.w4a16_matmul import w4a16_matmul_cuda
    from repro_torch.core.quant import dequantize

    g = torch.Generator(device="cuda").manual_seed(1234)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    rows = []
    line = {}
    # Tolerances, relative to the largest |reference| value: bf16 outputs
    # differ by the rounding of the last bit after f32 sums taken in another
    # order (bf16 keeps 8 bits: 2^-7 ~ 7.8e-3), f32 by accumulation order.
    tol = {"bfloat16": 1e-2, "float32": 1e-4}

    # -- w4a16_matmul: T x (in -> out): 4096 -> 512 / 4096 / 151936 (wk/wv,
    # wq/wo, the lm_head) and qwen-7b's down, 11008 -> 4096
    shapes = ((4096, 512), (4096, 4096), (4096, 151936), (11008, 4096))
    weights = {s: quantize(randn(*s, dtype=torch.float32) * 0.02)
               for s in shapes}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        cases = ([(t, s) for t in (1, 4, 256) for s in shapes[:3]]
                 + [(1024, shapes[1]), (4, shapes[3]), (1024, shapes[3])]
                 if dtype == torch.bfloat16
                 else [(4, shapes[1]), (4, shapes[2])])
        for t, (d_in, o) in cases:
            qt = weights[(d_in, o)]
            x = randn(t, d_in, dtype=dtype)
            got = ops.w4a16_matmul(x, qt)
            want = ops.w4a16_matmul(x, qt, impl="torch")
            err, rel = max_errs(got, want)
            need(rel <= tol[dname], f"w4a16 T={t} {d_in}->{o} {dname}: "
                 f"rel err {rel:.3g} > {tol[dname]}")
            row = {"kernel": "w4a16_matmul", "dtype": dname, "T": t,
                   "in": d_in, "out": o, "max_abs_err": err, "max_rel_err": rel,
                   "tol_rel": tol[dname]}
            if dtype == torch.bfloat16:
                row["ms"] = timer.ms(lambda: ops.w4a16_matmul(x, qt), 20)
                row["plain_ms"] = timer.ms(
                    lambda: ops.w4a16_matmul(x, qt, impl="torch"), 3)
                # dequantize + torch.matmul on every call, and torch.matmul
                # alone on a weight dequantized once outside the timed call
                row["library_ms"] = timer.ms(
                    lambda: x @ dequantize(qt, torch.bfloat16), 5)
                w16 = dequantize(qt, torch.bfloat16)
                row["library_bf16_ms"] = timer.ms(lambda: x @ w16, 10)
                del w16
                row["library_factor"] = row["ms"] / row["library_ms"]
                row["library_bf16_factor"] = (row["ms"]
                                              / row["library_bf16_ms"])
                nbytes = (x.numel() * 2 + qt.nbytes_model + t * o * 2)
                row["bound_ms"], row["bound_by"] = bound(
                    nbytes, 2 * t * d_in * o, dname)
            rows.append(row)
            log(f"  w4a16 {dname} T={t:4d} {d_in:5d}->{o:6d}: max_abs "
                f"{err:.3g} rel {rel:.3g} (tol {tol[dname]})"
                + (f"  kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f}"
                   f" ms library {row['library_ms']:.4f} ms (kernel / "
                   f"library {row['library_factor']:.2f}), bf16 matmul "
                   f"{row['library_bf16_ms']:.4f} ms (kernel / matmul "
                   f"{row['library_bf16_factor']:.2f}) bound "
                   f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
                   if "ms" in row else ""))
            if (t, d_in, o, dname) == (4, 4096, 4096, "bfloat16"):
                line["w4a16_matmul"] = row
    # batch invariance: the first 4 rows alone equal those rows inside 256
    qt = weights[(4096, 4096)]
    x = randn(256, 4096)
    need(torch.equal(ops.w4a16_matmul(x[:4], qt),
                     ops.w4a16_matmul(x, qt)[:4]),
         "w4a16: rows differ between T=4 and T=256 (batch invariance)")
    log("  w4a16: T=4 rows bitwise equal inside T=256")
    # ... and across every bf16 tile configuration, with and without the
    # f32 bias epilogue
    bias = randn(4096, dtype=torch.float32) * 0.1
    xi = randn(INVARIANCE_ROWS, 4096)
    for b, what in ((None, ""), (bias, " with the f32 bias")):
        check_tile_invariance(
            torch, lambda v, b=b: w4a16_matmul_cuda(v, qt, b), xi,
            f"w4a16_matmul 4096x4096{what}")
    del weights, qt, x, bias, xi
    torch.cuda.empty_cache()

    # -- ffn: d = 4096, f = 11008
    d, f = 4096, 11008
    gate = quantize(randn(d, f, dtype=torch.float32) * 0.02)
    up = quantize(randn(d, f, dtype=torch.float32) * 0.02)
    down = quantize(randn(f, d, dtype=torch.float32) * 0.02)
    for dtype, tokens in ((torch.bfloat16, (4, 256, 1024)),
                          (torch.float32, (4,))):
        dname = str(dtype).split(".")[1]
        for t in tokens:
            x = randn(t, d, dtype=dtype)
            h_got = ffn_gate_up_cuda(x, gate, up, "swiglu")
            h_want = ffn_gate_up_torch(x, gate, up, "swiglu")
            herr, hrel = max_errs(h_got, h_want)
            got = ops.ffn_w4a16(x, gate, up, down)
            want = ops.ffn_w4a16(x, gate, up, down, impl="torch")
            err, rel = max_errs(got, want)
            need(hrel <= tol[dname] and rel <= tol[dname],
                 f"ffn T={t} {dname}: hidden rel {hrel:.3g}, out rel "
                 f"{rel:.3g} > {tol[dname]}")
            row = {"kernel": "ffn_fused_w4a16", "dtype": dname, "T": t,
                   "d": d, "f": f, "max_abs_err": herr, "max_rel_err": hrel,
                   "ffn_max_abs_err": err, "ffn_max_rel_err": rel,
                   "tol_rel": tol[dname]}
            if dtype == torch.bfloat16:
                row["ms"] = timer.ms(
                    lambda: ffn_gate_up_cuda(x, gate, up, "swiglu"), 20)
                row["plain_ms"] = timer.ms(
                    lambda: ffn_gate_up_torch(x, gate, up, "swiglu"), 3)

                def lib():
                    gg = x @ dequantize(gate, torch.bfloat16)
                    uu = x @ dequantize(up, torch.bfloat16)
                    return torch.nn.functional.silu(gg) * uu
                row["library_ms"] = timer.ms(lib, 5)
                # two torch.matmul on weights dequantized once, silu * up
                g16, u16 = (dequantize(w, torch.bfloat16) for w in (gate, up))
                row["library_bf16_ms"] = timer.ms(
                    lambda: torch.nn.functional.silu(x @ g16) * (x @ u16), 10)
                del g16, u16
                row["library_factor"] = row["ms"] / row["library_ms"]
                row["library_bf16_factor"] = (row["ms"]
                                              / row["library_bf16_ms"])
                row["ffn_ms"] = timer.ms(
                    lambda: ops.ffn_w4a16(x, gate, up, down), 20)
                row["ffn_plain_ms"] = timer.ms(
                    lambda: ops.ffn_w4a16(x, gate, up, down, impl="torch"), 3)
                # the whole FFN as library calls: dequantize + the chain on
                # every call, and the chain on weights dequantized once
                row["ffn_library_ms"] = timer.ms(lambda: ffn_chain(
                    torch, x, *(dequantize(w, torch.bfloat16)
                                for w in (gate, up, down)), "swiglu", None,
                    None), 5)
                w16 = [dequantize(w, torch.bfloat16) for w in (gate, up, down)]
                row["ffn_library_bf16_ms"] = timer.ms(lambda: ffn_chain(
                    torch, x, *w16, "swiglu", None, None), 10)
                del w16
                nbytes = (x.numel() * 2 + gate.nbytes_model + up.nbytes_model
                          + t * f * 2)
                row["bound_ms"], row["bound_by"] = bound(
                    nbytes, 2 * 2 * t * d * f, dname)
                ffn_bytes = nbytes + down.nbytes_model + t * d * 2 - t * f * 2
                row["ffn_bound_ms"], _ = bound(ffn_bytes, 3 * 2 * t * d * f,
                                               dname)
            rows.append(row)
            log(f"  ffn {dname} T={t:3d}: hidden max_abs {herr:.3g} rel "
                f"{hrel:.3g}; ffn max_abs {err:.3g} rel {rel:.3g} (tol "
                f"{tol[dname]})"
                + (f"  gate/up kernel {row['ms']:.4f} ms plain "
                   f"{row['plain_ms']:.4f} ms library {row['library_ms']:.4f}"
                   f" ms (kernel / library {row['library_factor']:.2f}), "
                   f"bf16 matmuls {row['library_bf16_ms']:.4f} ms (kernel / "
                   f"matmuls {row['library_bf16_factor']:.2f}) bound "
                   f"{row['bound_ms']:.4f} ms; whole ffn {row['ffn_ms']:.4f}"
                   f" ms (bound {row['ffn_bound_ms']:.4f}; library "
                   f"{row['ffn_library_ms']:.4f} ms, on weights dequantized "
                   f"once {row['ffn_library_bf16_ms']:.4f} ms)"
                   if "ms" in row else ""))
            if (t, dname) == (4, "bfloat16"):
                line["ffn_fused_w4a16"] = row
    # rows 100-103 of the bf16 gate/up stage across its tile configurations
    xi = randn(INVARIANCE_ROWS, d)
    check_tile_invariance(
        torch, lambda v: ffn_gate_up_cuda(v, gate, up, "swiglu"), xi,
        "ffn_fused_w4a16 swiglu gate/up")
    del gate, up, down, xi
    torch.cuda.empty_cache()

    check_geglu_ffn(torch, timer, randn, tol, rows)
    line.update(check_sparse_kernels(torch, timer, randn, tol, rows))
    for shape in ATTENTION_SHAPES:
        line.update(check_attention_variants(torch, timer, randn, tol, rows,
                                             **shape))
    line.update(check_flash_attention(torch, timer, randn, tol, rows))
    line.update(check_xlstm_kernels(torch, timer, randn, tol, rows,
                                    results.get("ptxas", {})))
    line.update(check_dense_kernels(torch, timer, randn, tol, rows, results))
    line.update(check_moe_kernels(torch, timer, randn, tol, rows))
    check_whisper_kernels(torch, timer, randn, tol, rows)
    line.update(check_hybrid_kernels(torch, timer, randn, tol, rows))
    check_vlm_kernels(torch, timer, randn, tol, rows)

    # -- attention: B=4, hq=32, d=128, MAX=512; hkv=4 (qwen-7b) and, bf16
    # only, hkv=2 (chatglm-6b's rep 16)
    b, hq, hd, max_len = 4, 32, 128, 512
    lengths = torch.tensor([300, 64, 512, 40], dtype=torch.int32,
                           device="cuda")
    for dtype, hkv in ((torch.bfloat16, 4), (torch.float32, 4),
                       (torch.bfloat16, 2)):
        dname = str(dtype).split(".")[1]
        kc = randn(b, hkv, max_len, hd, dtype=dtype)
        vc = randn(b, hkv, max_len, hd, dtype=dtype)
        q64 = randn(b, hq, 64, hd, dtype=dtype)
        for window in (None, 128):
            outs = {}
            for c, q_lens in ((1, [1, 1, 1, 1]), (64, [64, 1, 17, 0])):
                ql = torch.tensor(q_lens, dtype=torch.int32, device="cuda")
                q = q64[:, :, :c].contiguous()
                got = ops.mixed_attention(q, kc, vc, lengths, ql,
                                          window=window)
                want = ops.mixed_attention(q, kc, vc, lengths, ql,
                                           window=window, impl="torch")
                err, rel = max_errs(got, want)
                need(rel <= tol[dname], f"attention C={c} window={window} "
                     f"{dname}: rel err {rel:.3g} > {tol[dname]}")
                outs[c] = got
                row = {"kernel": "mixed_flash_attention", "dtype": dname,
                       "B": b, "hq": hq, "hkv": hkv, "d": hd,
                       "max_len": max_len, "C": c, "window": window,
                       "lengths": lengths.tolist(), "q_lens": q_lens,
                       "kv_block": kv_block_size(max_len), "max_abs_err": err,
                       "max_rel_err": rel, "tol_rel": tol[dname]}
                if dtype == torch.bfloat16 and window is None:
                    row["ms"] = timer.ms(lambda: ops.mixed_attention(
                        q, kc, vc, lengths, ql), 20)
                    row["plain_ms"] = timer.ms(lambda: ops.mixed_attention(
                        q, kc, vc, lengths, ql, impl="torch"), 3)
                    row["library_ms"] = timer.ms(
                        lambda: sdpa_yardstick(torch, q, kc, vc, lengths, ql),
                        5)
                    nbytes, flops = attention_work(lengths.tolist(), q_lens,
                                                   hq, hkv, hd, c)
                    row["bound_ms"], row["bound_by"] = bound(nbytes, flops,
                                                             dname)
                rows.append(row)
                log(f"  attention {dname} hkv={hkv} C={c:2d} window={window}:"
                    f" max_abs "
                    f"{err:.3g} rel {rel:.3g} (tol {tol[dname]})"
                    + (f"  kernel {row['ms']:.4f} ms plain "
                       f"{row['plain_ms']:.4f} ms library "
                       f"{row['library_ms']:.4f} ms bound "
                       f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
                       if "ms" in row else ""))
                if (c, dname, window, hkv) == (1, "bfloat16", None, 4):
                    line["mixed_flash_attention"] = row
            # dead queries are exact zeros; q_lens = 1 in C = 64 == C = 1
            need(bool((outs[64][3] == 0).all()) and
                 bool((outs[64][1, :, 1:] == 0).all()) and
                 bool((outs[64][2, :, 17:] == 0).all()),
                 f"attention {dname} window={window}: dead queries not zero")
            need(torch.equal(outs[64][1, :, 0], outs[1][1, :, 0]),
                 f"attention {dname} hkv={hkv} window={window}: q_lens=1 in "
                 "C=64 is not bitwise the C=1 result")
        log(f"  attention {dname} hkv={hkv}: dead queries exact zeros; "
            "q_lens=1 inside C=64 bitwise equal to C=1")

    # -- rmsnorm: rows x 4096
    gamma = (1 + 0.1 * randn(4096, dtype=torch.float32)).to(torch.bfloat16)
    for t in (4, 256):
        x = randn(t, 4096)
        got = rmsnorm_cuda(x, gamma)
        want = rmsnorm_torch(x, gamma)
        err, rel = max_errs(got, want)
        need(rel <= tol["bfloat16"], f"rmsnorm rows={t}: rel {rel:.3g}")
        row = {"kernel": "rmsnorm", "dtype": "bfloat16", "rows": t, "d": 4096,
               "max_abs_err": err, "max_rel_err": rel,
               "tol_rel": tol["bfloat16"],
               "ms": timer.ms(lambda: rmsnorm_cuda(x, gamma), 20),
               "plain_ms": timer.ms(lambda: rmsnorm_torch(x, gamma), 5)}
        lib = getattr(torch.nn.functional, "rms_norm", None)
        row["library_ms"] = (timer.ms(lambda: lib(x, (4096,), gamma, 1e-6), 5)
                             if lib is not None else None)
        row["bound_ms"], row["bound_by"] = bound(
            2 * x.numel() * 2 + 4096 * 2, 4 * x.numel(), "bfloat16")
        rows.append(row)
        log(f"  rmsnorm rows={t:3d}: max_abs {err:.3g} rel {rel:.3g}  kernel "
            f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms bound "
            f"{row['bound_ms']:.4f} ms")
        if t == 4:
            line["rmsnorm"] = row
    x = randn(256, 4096)
    need(torch.equal(rmsnorm_cuda(x[:4], gamma), rmsnorm_cuda(x, gamma)[:4]),
         "rmsnorm: rows differ between 4 and 256 rows (batch invariance)")
    log("  rmsnorm: 4 rows bitwise equal inside 256")
    line.update(check_add_rmsnorm(torch, timer, rows))
    line.update(check_add_layernorm(torch, timer, rows))
    line.update(check_kv_write(torch, timer, rows))
    line.update(check_qkv_epilogue(torch, timer, rows))
    results["kernel_checks"] = rows
    return line


# gemma-2b's FFN: d_model 2048, d_ff 16384, GeGLU
GEMMA_D, GEMMA_F = 2048, 16384


def check_geglu_ffn(torch, timer, randn, tol, rows) -> None:
    """Kernel 2's geglu variant (``gelu_tanh(x @ gate) * (x @ up)``, the
    epilogue no served path launched before gemma-2b) at gemma-2b's widths,
    2048 -> 2 x 16384, T = 4 and 256: the gate/up stage and the whole FFN
    (the stage, then kernel 1 on down) against their plain versions, each
    timed beside its bound and its library chain (dequantize + matmuls +
    the activation on every call, and the chain on weights dequantized
    once); rows 100-103 bitwise across the stage's tile configurations."""
    from repro_torch.core.quant import dequantize, quantize
    from repro_torch.kernels import ops
    from repro_torch.kernels.ffn_fused import (
        ffn_gate_up_cuda, ffn_gate_up_torch)
    d, f, act = GEMMA_D, GEMMA_F, "geglu"
    gate = quantize(randn(d, f, dtype=torch.float32) * 0.02)
    up = quantize(randn(d, f, dtype=torch.float32) * 0.02)
    down = quantize(randn(f, d, dtype=torch.float32) * 0.02)
    dname = "bfloat16"
    for t in (4, 256):
        x = randn(t, d)
        herr, hrel = max_errs(ffn_gate_up_cuda(x, gate, up, act),
                              ffn_gate_up_torch(x, gate, up, act))
        err, rel = max_errs(ops.ffn_w4a16(x, gate, up, down, activation=act),
                            ops.ffn_w4a16(x, gate, up, down, activation=act,
                                          impl="torch"))
        need(hrel <= tol[dname] and rel <= tol[dname],
             f"ffn geglu T={t}: hidden rel {hrel:.3g}, out rel {rel:.3g} > "
             f"{tol[dname]}")
        row = {"kernel": "ffn_fused_w4a16", "activation": act,
               "model": "gemma-2b", "dtype": dname, "T": t, "d": d, "f": f,
               "max_abs_err": herr, "max_rel_err": hrel,
               "ffn_max_abs_err": err, "ffn_max_rel_err": rel,
               "tol_rel": tol[dname]}
        row["ms"] = timer.ms(lambda: ffn_gate_up_cuda(x, gate, up, act), 20)
        row["plain_ms"] = timer.ms(
            lambda: ffn_gate_up_torch(x, gate, up, act), 3)
        row["library_ms"] = timer.ms(lambda: ffn_chain(
            torch, x, dequantize(gate, torch.bfloat16),
            dequantize(up, torch.bfloat16), None, act, None, None,
            stage=True), 5)
        w16 = [dequantize(w, torch.bfloat16) for w in (gate, up, down)]
        row["library_bf16_ms"] = timer.ms(lambda: ffn_chain(
            torch, x, w16[0], w16[1], None, act, None, None, stage=True), 10)
        row["ffn_ms"] = timer.ms(
            lambda: ops.ffn_w4a16(x, gate, up, down, activation=act), 20)
        row["ffn_plain_ms"] = timer.ms(lambda: ops.ffn_w4a16(
            x, gate, up, down, activation=act, impl="torch"), 3)
        row["ffn_library_ms"] = timer.ms(lambda: ffn_chain(
            torch, x, *(dequantize(w, torch.bfloat16)
                        for w in (gate, up, down)), act, None, None), 5)
        row["ffn_library_bf16_ms"] = timer.ms(
            lambda: ffn_chain(torch, x, *w16, act, None, None), 10)
        del w16
        nbytes = (x.numel() * 2 + gate.nbytes_model + up.nbytes_model
                  + t * f * 2)
        row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * 2 * t * d * f,
                                                 dname)
        ffn_bytes = nbytes + down.nbytes_model + t * d * 2 - t * f * 2
        row["ffn_bound_ms"], _ = bound(ffn_bytes, 3 * 2 * t * d * f, dname)
        rows.append(row)
        log(f"  ffn geglu (gemma-2b) T={t:3d}: hidden max_abs {herr:.3g} rel "
            f"{hrel:.3g}; ffn max_abs {err:.3g} rel {rel:.3g} (tol "
            f"{tol[dname]})  gate/up kernel {row['ms']:.4f} ms plain "
            f"{row['plain_ms']:.4f} ms library {row['library_ms']:.4f} ms, "
            f"bf16 matmuls {row['library_bf16_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); whole ffn "
            f"{row['ffn_ms']:.4f} ms (bound {row['ffn_bound_ms']:.4f}; "
            f"plain {row['ffn_plain_ms']:.4f} ms; library "
            f"{row['ffn_library_ms']:.4f} ms, on weights dequantized once "
            f"{row['ffn_library_bf16_ms']:.4f} ms)")
    check_tile_invariance(
        torch, lambda v: ffn_gate_up_cuda(v, gate, up, act),
        randn(INVARIANCE_ROWS, d), "ffn_fused_w4a16 geglu gate/up (gemma-2b)")
    del gate, up, down
    torch.cuda.empty_cache()


def bitwise(torch, a, b) -> bool:
    """Same shape and the same bits (so -0.0 differs from 0.0, and a NaN
    equals itself)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


# (rows, d, keep_sum, what): a decode tick's 4 rows, prefill chunks (300 a
# ragged count) and the last layer's add into ln_f (s not kept)
ADD_RMSNORM_CASES = ((4, 4096, True, "qwen-7b / chatglm-6b decode"),
                     (64, 4096, True, "64 rows"), (256, 4096, True, "256"),
                     (300, 4096, True, "300, ragged"),
                     (4, 4096, False, "ln_f: n alone"))


def check_add_rmsnorm(torch, timer, rows) -> dict:
    """``add_rmsnorm`` (the residual add fused into the norm) against its
    plain version, ``x + h`` then the rmsnorm kernel: s and n bitwise, bf16
    and f32, at every case of ``ADD_RMSNORM_CASES``; n also within the
    tolerance of ``rmsnorm_torch``.  Kernel and plain times beside the
    byte bound, and ``x + h`` then ``F.rms_norm`` as a yardstick (no single
    PyTorch call adds and norms)."""
    from repro_torch.kernels.rmsnorm import (
        add_rmsnorm_cuda, add_rmsnorm_torch, rmsnorm_torch)
    g = torch.Generator(device="cuda").manual_seed(24)
    tol = {"bfloat16": 2e-2, "float32": 1e-5}
    lib = getattr(torch.nn.functional, "rms_norm", None)
    line = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        elt = torch.finfo(dtype).bits // 8
        for t, d, keep, what in ADD_RMSNORM_CASES:
            gamma = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")
                     ).to(dtype)
            x = torch.randn(t, d, generator=g, device="cuda").to(dtype)
            h = torch.randn(t, d, generator=g, device="cuda").to(dtype)
            s, n = add_rmsnorm_cuda(x, h, gamma, keep_sum=keep)
            ps, pn = add_rmsnorm_torch(x, h, gamma)
            torch.cuda.synchronize()
            case = f"add_rmsnorm {dname} {t}x{d} ({what})"
            need(bitwise(torch, n, pn), f"{case}: n is not bitwise the "
                 "plain version's")
            need((s is None) != keep and (s is None or bitwise(torch, s, ps)),
                 f"{case}: s is not bitwise x + h (or written unasked)")
            err, rel = max_errs(n, rmsnorm_torch(x + h, gamma))
            need(rel <= tol[dname], f"{case}: rel {rel:.3g} against "
                 "rmsnorm_torch")
            row = {"kernel": "add_rmsnorm", "dtype": dname, "rows": t,
                   "d": d, "keep_sum": keep, "case": what, "bitwise": True,
                   "max_abs_err": 0.0, "rmsnorm_torch_rel": rel,
                   "library_ms": None}
            if what in ("qwen-7b / chatglm-6b decode", "256"):
                row["ms"] = timer.ms(lambda: add_rmsnorm_cuda(x, h, gamma),
                                     20)
                row["plain_ms"] = timer.ms(
                    lambda: add_rmsnorm_torch(x, h, gamma), 10)
                row["yardstick_ms"] = (timer.ms(
                    lambda: lib(x + h, (d,), gamma, 1e-6), 10)
                    if lib is not None else None)
                row["bound_ms"], row["bound_by"] = bound(
                    4 * t * d * elt + d * elt, 5 * t * d, dname)
                log(f"  {case}: s, n bitwise = plain; rel {rel:.3g} vs "
                    f"rmsnorm_torch; kernel {row['ms']:.4f} ms plain "
                    f"{row['plain_ms']:.4f} ms x + h, F.rms_norm "
                    f"{row['yardstick_ms']} ms bound {row['bound_ms']:.5f}"
                    f" ms ({row['bound_by']})")
            else:
                log(f"  {case}: s, n bitwise = plain; rel {rel:.3g} vs "
                    "rmsnorm_torch")
            rows.append(row)
            if dtype == torch.bfloat16 and what.startswith("qwen"):
                line["add_rmsnorm"] = row
    # the one staged body takes rows of at most 23.5 KB on 16-byte aligned
    # operands; the wrapper refuses the rest before any launch
    x = torch.randn(4, 6144, generator=g, device="cuda")
    odd = torch.randn(4 * 4096 + 1, device="cuda")[1:]
    for what, args in (("an f32 row of 6144", (x, x, x[0])),
                       ("h off a 16-byte boundary",
                        (x[:, :4096].contiguous(), odd.view(4, 4096),
                         x[0, :4096].contiguous()))):
        try:
            add_rmsnorm_cuda(*args)
        except ValueError as e:
            log(f"  add_rmsnorm refuses {what}: {e}")
        else:
            need(False, f"add_rmsnorm took {what}")
    return line


# (rows, d, keep_sum, what) at starcoder2-7b's width, as ADD_RMSNORM_CASES
ADD_LAYERNORM_CASES = ((4, 4608, True, "starcoder2-7b decode"),
                       (64, 4608, True, "64 rows"), (256, 4608, True, "256"),
                       (300, 4608, True, "300, ragged"),
                       (4, 4608, False, "ln_f: n alone"))


def check_add_layernorm(torch, timer, rows) -> dict:
    """``add_layernorm`` (the residual add fused into the LayerNorm)
    against its plain version, ``x + h`` then the layernorm kernel: s and n
    bitwise, bf16 and f32, at every case of ``ADD_LAYERNORM_CASES`` (f32 at
    4608 stages 55 KB, past the 48 KB a block takes without an opt-in); n
    also within the tolerance of ``layernorm_torch``.  Kernel and plain
    times beside the byte bound, and ``x + h`` then ``F.layer_norm`` as a
    yardstick (no single PyTorch call adds and norms).  The wrappers refuse
    a row too wide to stage, a width off 16 bytes and a misaligned operand
    before any launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.layernorm import (
        add_layernorm_cuda, add_layernorm_torch, layernorm_cuda,
        layernorm_torch)
    g = torch.Generator(device="cuda").manual_seed(25)
    tol = {"bfloat16": 2e-2, "float32": 1e-4}
    F = torch.nn.functional
    line = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        elt = torch.finfo(dtype).bits // 8
        for t, d, keep, what in ADD_LAYERNORM_CASES:
            gamma = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")
                     ).to(dtype)
            beta = (0.1 * torch.randn(d, generator=g, device="cuda")
                    ).to(dtype)
            x = (3 * torch.randn(t, d, generator=g, device="cuda") + 1
                 ).to(dtype)
            h = torch.randn(t, d, generator=g, device="cuda").to(dtype)
            s, n = add_layernorm_cuda(x, h, gamma, beta, keep_sum=keep)
            ps, pn = add_layernorm_torch(x, h, gamma, beta)
            torch.cuda.synchronize()
            case = f"add_layernorm {dname} {t}x{d} ({what})"
            need(bitwise(torch, n, pn), f"{case}: n is not bitwise the "
                 "plain version's")
            need((s is None) != keep and (s is None or bitwise(torch, s, ps)),
                 f"{case}: s is not bitwise x + h (or written unasked)")
            err, rel = max_errs(n, layernorm_torch(x + h, gamma, beta))
            need(rel <= tol[dname], f"{case}: rel {rel:.3g} against "
                 "layernorm_torch")
            row = {"kernel": "add_layernorm", "dtype": dname, "rows": t,
                   "d": d, "keep_sum": keep, "case": what, "bitwise": True,
                   "max_abs_err": 0.0, "layernorm_torch_rel": rel,
                   "library_ms": None}
            if what in ("starcoder2-7b decode", "256"):
                row["ms"] = timer.ms(
                    lambda: add_layernorm_cuda(x, h, gamma, beta), 20)
                row["plain_ms"] = timer.ms(
                    lambda: add_layernorm_torch(x, h, gamma, beta), 10)
                row["yardstick_ms"] = timer.ms(
                    lambda: F.layer_norm(x + h, (d,), gamma, beta, 1e-5), 10)
                row["bound_ms"], row["bound_by"] = bound(
                    4 * t * d * elt + 2 * d * elt, 9 * t * d, dname)
                log(f"  {case}: s, n bitwise = plain; rel {rel:.3g} vs "
                    f"layernorm_torch; kernel {row['ms']:.4f} ms plain "
                    f"{row['plain_ms']:.4f} ms x + h, F.layer_norm "
                    f"{row['yardstick_ms']:.4f} ms bound "
                    f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
            else:
                log(f"  {case}: s, n bitwise = plain; rel {rel:.3g} vs "
                    "layernorm_torch")
            rows.append(row)
            if dtype == torch.bfloat16 and what.startswith("starcoder2"):
                line["add_layernorm"] = row
    # one staged body takes rows of at most 64 KB, a multiple of 16 bytes,
    # on 16-byte aligned operands; the wrappers refuse the rest unlaunched
    before = dict(_build.launches)
    x = torch.randn(2, 16400, generator=g, device="cuda")
    y = torch.randn(2, 100, generator=g, device="cuda").to(torch.bfloat16)
    a = torch.randn(2, 4608, generator=g, device="cuda")
    odd = torch.randn(2 * 4608 + 1, device="cuda")[1:].view(2, 4608)
    for what, args in (("an f32 row of 16400 (65,600 bytes)",
                        (x, x, x[0], x[0])),
                       ("a bf16 row of 100 (200 bytes)", (y, y, y[0], y[0])),
                       ("h off a 16-byte boundary",
                        (a, odd, a[0].contiguous(), a[1].contiguous()))):
        # layernorm alone takes h as its x
        for name, fn, fargs in (("add_layernorm", add_layernorm_cuda, args),
                                ("layernorm", layernorm_cuda, args[1:])):
            try:
                fn(*fargs)
            except ValueError as e:
                log(f"  {name} refuses {what}: {e}")
            else:
                need(False, f"{name} took {what}")
    need(dict(_build.launches) == before, "a refused norm launched")
    return line


def kv_write_case(torch, g, layout, kind, chunk, b=4, hkv=4, hd=128,
                  span=512, bs=16):
    """Operands of one ``kv_write`` call at qwen-7b's per-layer K/V shape:
    the cache (slot (B, hkv, 512, 128), or a pool of 16-token pages under a
    scrambled table), this step's rows (k contiguous, v a transposed view
    as the model makes them), ``starts`` and ``q_lens`` with a dead row.
    ``chunk`` 1 is a decode write: ``q_lens`` the write mask, ``starts``
    the write index, a rolling window's when ``kind`` ends in "-roll"."""
    import numpy as np
    rng = np.random.default_rng(chunk)
    quant = kind.startswith("int8")

    def rand(*shape, dtype):
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=g,
                                 device="cuda", dtype=torch.int8)
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def leaves(*lead):
        if quant:
            return {"k": rand(*lead, hd, dtype=torch.int8),
                    "v": rand(*lead, hd, dtype=torch.int8),
                    "k_scale": rand(*lead, 1, dtype=torch.float32),
                    "v_scale": rand(*lead, 1, dtype=torch.float32)}
        return {"k": rand(*lead, hd, dtype=torch.bfloat16),
                "v": rand(*lead, hd, dtype=torch.bfloat16)}
    if chunk == 1:
        lengths = rng.integers(1, (2 if kind.endswith("-roll") else 1) * span
                               + 1, b)
        starts = (lengths - 1) % span
        q_lens = np.array([1, 1, 0, 1])
    else:
        q_lens = np.array([chunk, 0, 1, chunk * 3 // 5])
        starts = np.array([rng.integers(0, span - q + 1) for q in q_lens])
    table = None
    if layout == "paged":
        n_pages = span // bs
        perm = rng.permutation(b * n_pages + 5)[:b * n_pages]
        table = torch.tensor(perm.reshape(b, n_pages), dtype=torch.int32,
                             device="cuda")
        cache = leaves(b * n_pages + 6, hkv, bs)
    else:
        cache = leaves(b, hkv, span)
    rows = leaves(b, chunk, hkv)
    new = {n: t.transpose(1, 2) if n.startswith("v") else
           t.transpose(1, 2).contiguous() for n, t in rows.items()}
    return (cache, new, torch.tensor(starts, dtype=torch.int32,
                                     device="cuda"),
            torch.tensor(q_lens, dtype=torch.int32, device="cuda"), table)


def check_kv_write(torch, timer, rows) -> dict:
    """The KV write kernel bitwise against its plain version (slot and
    paged, fp and int8, decode with a masked row and a rolling window's
    index, a 64-wide chunk with a dead row and ragged rows), the null
    block and dead rows untouched; kernel and plain times beside the byte
    bound, and ``index_put_`` per leaf on indices and rows gathered
    beforehand as a yardstick (no single PyTorch call takes ``q_lens``)."""
    from repro_torch.kernels.kv_write import kv_write_cuda, kv_write_torch
    g = torch.Generator(device="cuda").manual_seed(22)
    line = {}
    for layout in ("slot", "paged"):
        for kind in ("bf16", "bf16-roll", "int8"):
            for chunk in ((1,) if kind.endswith("-roll") else (1, 64)):
                cache, new, starts, q_lens, table = kv_write_case(
                    torch, g, layout, kind, chunk)
                orig = {n: t.clone() for n, t in cache.items()}
                want = {n: t.clone() for n, t in cache.items()}
                kv_write_torch(want, new, starts, q_lens, table)
                kv_write_cuda(cache, new, starts, q_lens, table)
                torch.cuda.synchronize()
                what = f"kv_write {layout} {kind} C={chunk}"
                for n in cache:
                    need(torch.equal(cache[n].view(torch.uint8),
                                     want[n].view(torch.uint8)),
                         f"{what}: leaf {n} is not bitwise the plain "
                         "version's")
                    untouched = (cache[n][-1], orig[n][-1]) if table is not \
                        None else (cache[n][2 if chunk == 1 else 1],
                                   orig[n][2 if chunk == 1 else 1])
                    need(torch.equal(*untouched),
                         f"{what}: the null block or a dead row changed")
                live = int(q_lens.sum())
                width = sum(t.shape[-1] * t.element_size()
                            for t in cache.values())
                nbytes = (2 * live * cache["k"].shape[1] * width
                          + 2 * 4 * q_lens.numel()
                          + (live * 4 if table is not None else 0))
                row = {"kernel": "kv_write", "layout": layout, "kind": kind,
                       "C": chunk, "live_positions": live, "max_abs_err": 0.0,
                       "bitwise": True,
                       "ms": timer.ms(lambda: kv_write_cuda(
                           cache, new, starts, q_lens, table), 20),
                       "plain_ms": timer.ms(lambda: kv_write_torch(
                           cache, new, starts, q_lens, table), 3),
                       "library_ms": None}
                row["bound_ms"], row["bound_by"] = bound(nbytes, 0,
                                                         "bfloat16")
                # the yardstick: index_put_ of the gathered live rows
                j = torch.arange(chunk, device="cuda")
                r, c = (j[None, :] < q_lens[:, None]).nonzero(as_tuple=True)
                pos = starts.long()[r] + c
                if table is not None:
                    bsz = cache["k"].shape[2]
                    idx = (table.long()[r, pos // bsz], slice(None),
                           pos % bsz)
                else:
                    idx = (r, slice(None), pos)
                vals = {n: t[r, :, c] for n, t in new.items()}
                row["index_put_ms"] = timer.ms(
                    lambda: [cache[n].__setitem__(idx, vals[n])
                             for n in cache], 10)
                rows.append(row)
                log(f"  {what}: bitwise = plain, dead rows and null block "
                    f"untouched; kernel {row['ms']:.4f} ms plain "
                    f"{row['plain_ms']:.4f} ms index_put_ "
                    f"{row['index_put_ms']:.4f} ms bound "
                    f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
                if (layout, kind, chunk) == ("slot", "bf16", 1):
                    line["kv_write"] = row
    return line


# (model, hq, hkv, head dim, RoPE theta, q/k norm) of the epilogue's cases:
# q/k/v biases where the model has them (all but qwen3-8b and gemma-2b),
# qwen3-8b's per-head q/k RMSNorm, gemma-2b's MQA at head dim 256; the
# models whose cases are timed
EPILOGUE_HEADS = (("qwen-7b", 32, 4, 128, 1e4, False),
                  ("chatglm-6b", 32, 2, 128, 1e4, False),
                  ("starcoder2-7b", 36, 4, 128, 1e5, False),
                  ("qwen3-8b", 32, 8, 128, 1e6, True),
                  ("gemma-2b", 8, 1, 256, 1e4, False),
                  ("qwen2-vl-7b", 28, 4, 128, 1e6, False))
EPILOGUE_TIMED = ("qwen-7b", "qwen3-8b", "gemma-2b", "qwen2-vl-7b")


def epilogue_case(torch, g, layout, quant, chunk, hq, hkv, hd=128, b=4,
                  span=512, bs=16):
    """Operands of one layer's q/k/v epilogue at a model's head counts:
    the raw projections and biases (bf16), the cache (random, so a stray
    write shows: slot (B, hkv, 512, 128), or a pool of 16-token pages under
    a scrambled table with spare blocks and the null block last), and the
    step's index tensors.  ``chunk`` 1 is a decode step: positions
    ``lengths - 1``, one masked row, one row at the span's last position
    (the RoPE table's last row); 64 a mixed step with a dead row and ragged
    rows.  Returns (cache, q, k, v, bias, rope_base, starts, q_lens,
    page_table)."""
    import numpy as np
    rng = np.random.default_rng(chunk + hq + hkv)

    def rand(*shape, dtype=torch.bfloat16):
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=g,
                                 device="cuda", dtype=torch.int8)
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def leaves(*lead):
        kv = torch.int8 if quant else torch.bfloat16
        out = {"k": rand(*lead, hd, dtype=kv), "v": rand(*lead, hd, dtype=kv)}
        if quant:
            out.update(k_scale=rand(*lead, 1, dtype=torch.float32),
                       v_scale=rand(*lead, 1, dtype=torch.float32))
        return out
    if chunk == 1:
        pos = np.array([rng.integers(0, span), span - 1, 7, 300])
        rope_base, starts = pos, pos
        q_lens = np.array([1, 1, 0, 1])
    else:
        q_lens = np.array([chunk, 0, 1, chunk * 3 // 5])
        starts = np.array([rng.integers(0, span - q + 1) for q in q_lens])
        rope_base = starts
    table = None
    if layout == "paged":
        n_pages = span // bs
        perm = rng.permutation(b * n_pages + 5)[:b * n_pages]
        table = torch.tensor(perm.reshape(b, n_pages), dtype=torch.int32,
                             device="cuda")
        cache = leaves(b * n_pages + 6, hkv, bs)
    else:
        cache = leaves(b, hkv, span)
    q = rand(b, chunk, hq * hd)
    k, v = rand(b, chunk, hkv * hd), rand(b, chunk, hkv * hd)
    bias = (rand(hq * hd), rand(hkv * hd), rand(hkv * hd))
    ints = (torch.tensor(a, dtype=torch.int32, device="cuda")
            for a in (rope_base, starts, q_lens))
    return (cache, q, k, v, bias, *ints, table)


def check_qkv_epilogue(torch, timer, rows) -> dict:
    """The q/k/v epilogue (``qkv_rope_write``: bias, a ``qk_norm`` config's
    per-head q/k RMSNorm, RoPE, int8 quantizing, the cache write and q's
    layout in one launch) bitwise against its plain version, the chain the
    serving steps ran before (bias adds, the rmsnorm kernel on q and k,
    ``apply_rope``, ``quantize_kv``, the ``kv_write`` kernel,
    ``q.contiguous()``): every cache leaf and q at every live position (a
    dead one's is free: the attention kernel zeroes dead rows); the null
    block and dead or masked rows untouched.  Slot and paged, bf16
    and int8, decode and a 64-wide chunk, at the heads of
    ``EPILOGUE_HEADS`` (qwen3-8b's with its q/k norm, gemma-2b's at head
    dim 256).  Kernel and chain times (``EPILOGUE_TIMED``) beside the byte
    bound; the chain (the plain time) is also the yardstick: no PyTorch
    call takes ``q_lens``."""
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(24)
    line = {}
    for model, hq, hkv, hd, theta, qk_norm in EPILOGUE_HEADS:
        for layout in ("slot", "paged"):
            for quant in (False, True):
                for chunk in (1, 64):
                    (cache, q, k, v, bias, rope_base, starts, q_lens,
                     table) = epilogue_case(torch, g, layout, quant, chunk,
                                            hq, hkv, hd=hd)
                    norms = {}
                    if qk_norm:
                        bias = (None, None, None)
                        norms = {n: (1 + 0.2 * torch.randn(
                            hd, generator=g, device="cuda")).to(
                                torch.bfloat16)
                            for n in ("q_norm", "k_norm")}
                    want = {n: t.clone() for n, t in cache.items()}
                    orig = {n: t.clone() for n, t in cache.items()}

                    def call(c, impl):
                        return ops.qkv_rope_write(
                            c, q, k, v, bias, n_heads=hq, theta=theta,
                            rope_base=rope_base,
                            starts=starts, q_lens=q_lens, page_table=table,
                            impl=impl, **norms)
                    got_q = call(cache, "cuda")
                    want_q = call(want, "torch")
                    torch.cuda.synchronize()
                    what = (f"qkv_rope_write {model} {layout} "
                            f"{'int8' if quant else 'bf16'} C={chunk}"
                            + (" qk_norm" if qk_norm else ""))
                    need(all(bitwise(torch, got_q[r, :, :n], want_q[r, :, :n])
                             for r, n in enumerate(q_lens.tolist())),
                         f"{what}: q is not bitwise the chain's")
                    for n in cache:
                        need(bitwise(torch, cache[n], want[n]),
                             f"{what}: leaf {n} is not bitwise the chain's")
                        dead = -1 if table is not None else (
                            2 if chunk == 1 else 1)
                        need(torch.equal(cache[n][dead], orig[n][dead]),
                             f"{what}: the null block or a dead row changed")
                    row = {"kernel": "qkv_rope_write", "model": model,
                           "layout": layout, "kind": "int8" if quant
                           else "bf16", "C": chunk, "hd": hd,
                           "qk_norm": qk_norm, "bitwise": True,
                           "max_abs_err": 0.0, "library_ms": None}
                    if model in EPILOGUE_TIMED:
                        b = q.shape[0]
                        live = int(q_lens.sum())
                        per_kv = 2 * hd * (1 if quant else 2) + (
                            8 if quant else 0)
                        nbytes = (2 * q.numel() * 2 + 2 * k.numel() * 2
                                  + sum(t.numel() * 2 for t in bias
                                        if t is not None)
                                  + sum(t.numel() * 2
                                        for t in norms.values())
                                  + b * chunk * hd * 4     # cos, sin rows
                                  + live * hkv * per_kv + 3 * 4 * b
                                  + (live * 4 if table is not None else 0))
                        # bias adds, RoPE, q/v layout; the norm's square,
                        # sum and two products an element of q and k
                        flops = b * chunk * ((hq + hkv) * hd * 3
                                             + (hq + 2 * hkv) * hd
                                             + (4 * (hq + hkv) * hd
                                                if qk_norm else 0))
                        row["ms"] = timer.ms(lambda: call(cache, "cuda"), 20)
                        row["plain_ms"] = timer.ms(
                            lambda: call(want, "torch"), 10)
                        row["bound_ms"], row["bound_by"] = bound(
                            nbytes, flops, "bfloat16")
                        log(f"  {what}: q and every leaf bitwise = chain, "
                            f"null block and dead rows untouched; kernel "
                            f"{row['ms']:.4f} ms chain {row['plain_ms']:.4f}"
                            f" ms bound {row['bound_ms']:.5f} ms "
                            f"({row['bound_by']})")
                    else:
                        log(f"  {what}: q and every leaf bitwise = chain, "
                            "null block and dead rows untouched")
                    rows.append(row)
                    if (model, layout, quant, chunk) == (
                            "qwen-7b", "slot", False, 1):
                        line["qkv_rope_write"] = row
    return line


def check_sparse_kernels(torch, timer, randn, tol, rows) -> dict:
    """Kernels 4 and 5 at the layouts the compiler gives qwen-7b: ``wo``
    (4096 -> 4096) at density 0.5, and the FFN (4096 -> 11008 -> 4096) of
    strategy1-3, whose ``down`` is tile_uniform sparse (1, 2) or
    dense-quantized (3); and kernel 5's ungated gelu branch with biases at
    starcoder2-7b's (4608 -> 18432 -> 4608, strategy2: up at 0.25, down
    tile_uniform at 0.5, kernel 4 with the down bias).  bf16 at T=4, 256
    and 1024 (gelu: 4, 256), f32 at T=4; beside each, sparse_dequantize +
    ``torch.matmul`` and ``torch.matmul`` on the weights dequantized once
    (all blocks, dense), with the kernel / library factors.  Rows 100-103
    bitwise across the bf16 tile configurations (kernel 4 with and without
    its bias, both branches of kernel 5); ragged T (37, 300) against the
    plain versions; operands off a 16-byte boundary bitwise equal to
    aligned ones."""
    from repro_torch.core.compiler import quantize_model
    from repro_torch.core.quant import dequantize
    from repro_torch.core.sparsity import (
        SparseQuantizedTensor, sparse_dequantize)
    from repro_torch.kernels import ops
    from repro_torch.kernels.ffn_fused import (
        ffn_gate_up_sparse_cuda, ffn_gate_up_sparse_torch, kept_f_tiles,
        tile_subset)
    from repro_torch.kernels.sparse_w4a16 import (
        sparse_w4a16_matmul_cuda, sparse_w4a16_matmul_torch)

    line = {}
    d, f = QWEN_D, QWEN_F
    bf16, f32 = torch.bfloat16, torch.float32
    F = torch.nn.functional

    def dense_of(w):
        return (sparse_dequantize(w, bf16)
                if isinstance(w, SparseQuantizedTensor) else
                dequantize(w, bf16))

    def library(row, per_call, once, prefix=""):
        """``per_call``: the library chain dequantizing on every call;
        ``once``: the same on weights dequantized once, outside the call."""
        row[prefix + "library_ms"] = timer.ms(per_call, 5)
        row[prefix + "library_bf16_ms"] = timer.ms(once, 10)
        for k in ("library", "library_bf16"):
            row[f"{prefix}{k}_factor"] = (row[prefix + "ms"]
                                          / row[f"{prefix}{k}_ms"])

    def times(row, prefix=""):
        return (f"  kernel {row[prefix + 'ms']:.4f} ms plain "
                f"{row[prefix + 'plain_ms']:.4f} ms library "
                f"{row[prefix + 'library_ms']:.4f} ms (kernel / library "
                f"{row[prefix + 'library_factor']:.2f}), on weights "
                f"dequantized once {row[prefix + 'library_bf16_ms']:.4f} ms "
                f"(kernel / that {row[prefix + 'library_bf16_factor']:.2f}) "
                f"bound {row[prefix + 'bound_ms']:.4f} ms"
                if prefix + "ms" in row else "")

    def columns(tiles, width):
        """The hidden columns a stage writes: the kept f-tiles' (all when
        ``tiles`` is None)."""
        if tiles is None:
            return torch.arange(width, device=DEVICE)
        return (tiles.long()[:, None] * 128
                + torch.arange(128, device=DEVICE)).reshape(-1)

    # -- sparse_w4a16_matmul: wo, S = 16 of 32 blocks per output tile
    wo = quantize_model({"wo": randn(d, d, dtype=f32) * 0.02},
                        "strategy2")["wo"]
    need(isinstance(wo, SparseQuantizedTensor)
         and wo.kept_blocks == d // 128 // 2,
         "wo at density 0.5 does not keep half its blocks")
    wo16 = dense_of(wo)
    for dtype, tokens in ((bf16, (4, 256, 1024)), (f32, (4,))):
        dname = str(dtype).split(".")[1]
        for t in tokens:
            x = randn(t, d, dtype=dtype)
            got = ops.sparse_w4a16_matmul(x, wo)
            want = ops.sparse_w4a16_matmul(x, wo, impl="torch")
            err, rel = max_errs(got, want)
            need(rel <= tol[dname], f"sparse_w4a16 T={t} {dname}: rel err "
                 f"{rel:.3g} > {tol[dname]}")
            row = {"kernel": "sparse_w4a16_matmul", "dtype": dname, "T": t,
                   "in": d, "out": d, "kept_blocks": wo.kept_blocks,
                   "max_abs_err": err, "max_rel_err": rel,
                   "tol_rel": tol[dname]}
            if dtype == bf16:
                row["ms"] = timer.ms(lambda: ops.sparse_w4a16_matmul(x, wo),
                                     20)
                row["plain_ms"] = timer.ms(
                    lambda: ops.sparse_w4a16_matmul(x, wo, impl="torch"), 3)
                library(row, lambda: x @ dense_of(wo), lambda: x @ wo16)
                nbytes = x.numel() * 2 + wo.nbytes_model + t * d * 2
                row["bound_ms"], row["bound_by"] = bound(
                    nbytes, 2 * t * wo.kept_blocks * 128 * d, dname)
            rows.append(row)
            log(f"  sparse_w4a16 (wo) {dname} T={t:4d}: max_abs {err:.3g} "
                f"rel {rel:.3g} (tol {tol[dname]})" + times(row))
            if (t, dname) == (4, "bfloat16"):
                line["sparse_w4a16_matmul"] = row
    del wo16
    x = randn(256, d)
    need(torch.equal(ops.sparse_w4a16_matmul(x[:4], wo),
                     ops.sparse_w4a16_matmul(x, wo)[:4]),
         "sparse_w4a16: rows differ between T=4 and T=256")
    log("  sparse_w4a16: T=4 rows bitwise equal inside T=256")
    bias = randn(d, dtype=f32) * 0.1
    xi = randn(INVARIANCE_ROWS, d)
    for b, what in ((None, ""), (bias, " with the f32 bias")):
        check_tile_invariance(
            torch, lambda v, b=b: sparse_w4a16_matmul_cuda(v, wo, b), xi,
            f"sparse_w4a16_matmul (wo){what}")
        for t in (37, 300):
            err, rel = max_errs(sparse_w4a16_matmul_cuda(xi[:t], wo, b),
                                sparse_w4a16_matmul_torch(xi[:t], wo, b))
            need(rel <= tol["bfloat16"], f"sparse_w4a16 T={t}{what}: rel "
                 f"err {rel:.3g}")
    log("  sparse_w4a16: ragged T=37, 300 (with and without the bias) "
        "within tolerance of the plain version")
    check_unaligned(torch, lambda xx, ww: sparse_w4a16_matmul_cuda(
        xx, ww, bias), xi[:40], wo, "sparse_w4a16_matmul (wo)")
    del wo, xi, bias

    # -- ffn_fused_sparse (+ the down projection): the FFN of strategy1-3
    for strategy in ("strategy1", "strategy2", "strategy3"):
        w = quantize_model(
            {"gate": randn(d, f, dtype=f32) * 0.02,
             "up": randn(d, f, dtype=f32) * 0.02,
             "down": randn(f, d, dtype=f32) * 0.02}, strategy)
        gate, up, down = w["gate"], w["up"], w["down"]
        tiles = kept_f_tiles(down)
        n_f = f // 128 if tiles is None else tiles.numel()
        cols = columns(tiles, f)
        gate_k, up_k = ((gate, up) if tiles is None else
                        (tile_subset(gate, tiles), tile_subset(up, tiles)))
        g16, u16, d16 = dense_of(gate), dense_of(up), dense_of(down)
        gk16, uk16 = g16[:, cols], u16[:, cols]
        layout = (f"gate/up S={gate.kept_blocks}, down "
                  + (f"sparse S={down.kept_blocks} (f-tiles kept {n_f} of "
                     f"{f // 128})" if tiles is not None else "dense"))
        for dtype, tokens in ((bf16, (4, 256, 1024)), (f32, (4,))):
            dname = str(dtype).split(".")[1]
            for t in tokens:
                x = randn(t, d, dtype=dtype)
                h_got = ffn_gate_up_sparse_cuda(x, gate, up, "swiglu",
                                                tiles)[:, cols]
                h_want = ffn_gate_up_sparse_torch(x, gate, up, "swiglu",
                                                  tiles)
                herr, hrel = max_errs(h_got, h_want)
                got = ops.ffn_w4a16(x, gate, up, down)
                want = ops.ffn_w4a16(x, gate, up, down, impl="torch")
                err, rel = max_errs(got, want)
                need(hrel <= tol[dname] and rel <= tol[dname],
                     f"sparse ffn {strategy} T={t} {dname}: hidden rel "
                     f"{hrel:.3g}, out rel {rel:.3g} > {tol[dname]}")
                row = {"kernel": "ffn_fused_sparse", "strategy": strategy,
                       "dtype": dname, "T": t, "d": d, "f": f,
                       "gate_up_kept_blocks": gate.kept_blocks,
                       "f_tiles": n_f,
                       "down": ("sparse" if tiles is not None else "dense"),
                       "max_abs_err": herr, "max_rel_err": hrel,
                       "ffn_max_abs_err": err, "ffn_max_rel_err": rel,
                       "tol_rel": tol[dname]}
                if dtype == bf16:
                    row["ms"] = timer.ms(lambda: ffn_gate_up_sparse_cuda(
                        x, gate, up, "swiglu", tiles), 20)
                    row["plain_ms"] = timer.ms(
                        lambda: ffn_gate_up_sparse_torch(
                            x, gate, up, "swiglu", tiles), 3)
                    library(row, lambda: F.silu(x @ dense_of(gate_k))
                            * (x @ dense_of(up_k)),
                            lambda: F.silu(x @ gk16) * (x @ uk16))
                    row["ffn_ms"] = timer.ms(
                        lambda: ops.ffn_w4a16(x, gate, up, down), 20)
                    row["ffn_plain_ms"] = timer.ms(
                        lambda: ops.ffn_w4a16(x, gate, up, down,
                                              impl="torch"), 3)
                    library(row, lambda: ffn_chain(
                        torch, x, dense_of(gate), dense_of(up),
                        dense_of(down), "swiglu", None, None),
                        lambda: ffn_chain(torch, x, g16, u16, d16, "swiglu",
                                          None, None), prefix="ffn_")
                    # what this data needs: the kept f-tiles' gate/up
                    # blocks, down as stored, x in, hidden or out written
                    gu_bytes = gate_k.nbytes_model + up_k.nbytes_model
                    gu_flops = 2 * 2 * t * gate.kept_blocks * 128 * n_f * 128
                    row["bound_ms"], row["bound_by"] = bound(
                        x.numel() * 2 + gu_bytes + t * n_f * 128 * 2,
                        gu_flops, dname)
                    down_rows = (down.kept_blocks * 128 if tiles is not None
                                 else f)
                    row["ffn_bytes"] = (x.numel() * 2 + gu_bytes
                                        + down.nbytes_model + t * d * 2)
                    row["ffn_bound_ms"], row["ffn_bound_by"] = bound(
                        row["ffn_bytes"], gu_flops + 2 * t * down_rows * d,
                        dname)
                rows.append(row)
                log(f"  sparse ffn {strategy} ({layout}) {dname} T={t:4d}: "
                    f"hidden max_abs {herr:.3g} rel {hrel:.3g}; ffn max_abs "
                    f"{err:.3g} rel {rel:.3g} (tol {tol[dname]})"
                    + times(row) + ("; whole ffn" + times(row, "ffn_")
                                    if "ms" in row else ""))
                if (strategy, t, dname) == ("strategy2", 4, "bfloat16"):
                    line["ffn_fused_sparse"] = row
        del g16, u16, d16, gk16, uk16
        x = randn(256, d)
        need(torch.equal(ops.ffn_w4a16(x[:4], gate, up, down),
                         ops.ffn_w4a16(x, gate, up, down)[:4]),
             f"sparse ffn {strategy}: rows differ between T=4 and T=256")
        log(f"  sparse ffn {strategy}: T=4 rows bitwise equal inside T=256")
        if strategy == "strategy2":
            xi = randn(INVARIANCE_ROWS, d)
            check_tile_invariance(
                torch, lambda v: ffn_gate_up_sparse_cuda(
                    v, gate, up, "swiglu", tiles)[:, cols], xi,
                "ffn_fused_sparse swiglu gate/up (strategy2)")
            check_tile_invariance(
                torch, lambda v: ops.ffn_w4a16(v, gate, up, down), xi,
                "sparse ffn (strategy2)")
            for t in (37, 300):
                herr, hrel = max_errs(
                    ffn_gate_up_sparse_cuda(xi[:t], gate, up, "swiglu",
                                            tiles)[:, cols],
                    ffn_gate_up_sparse_torch(xi[:t], gate, up, "swiglu",
                                             tiles))
                need(hrel <= tol["bfloat16"], f"sparse ffn T={t}: hidden "
                     f"rel err {hrel:.3g}")
            log("  ffn_fused_sparse swiglu: ragged T=37, 300 within "
                "tolerance of the plain version")
            check_unaligned(
                torch, lambda xx, ww: ffn_gate_up_sparse_cuda(
                    xx, ww, up, "swiglu", tiles)[:, cols], xi[:40], gate,
                "ffn_fused_sparse swiglu (gate)")
            check_unaligned(
                torch, lambda xx, ww: ffn_gate_up_sparse_cuda(
                    xx, gate, ww, "swiglu", tiles)[:, cols], xi[:40], up,
                "ffn_fused_sparse swiglu (up)")
            del xi
        del w, gate, up, down, gate_k, up_k
        torch.cuda.empty_cache()
    line.update(check_sparse_gelu(torch, timer, randn, tol, rows, dense_of,
                                  library, times, columns))
    return line


def check_sparse_gelu(torch, timer, randn, tol, rows, dense_of, library,
                      times, columns) -> dict:
    """Kernel 5's ungated gelu branch at starcoder2-7b's FFN under
    strategy2 (up 4608 -> 18432 at density 0.25, down tile_uniform at 0.5),
    with up and down biases: the up stage (``ffn_fused_sparse_gelu``) and
    the whole FFN (kernel 4 with the down bias for down)."""
    from repro_torch.core.compiler import quantize_model
    from repro_torch.kernels import ops
    from repro_torch.kernels.ffn_fused import (
        ffn_gate_up_sparse_cuda, ffn_gate_up_sparse_torch, kept_f_tiles,
        tile_subset)
    F = torch.nn.functional
    bf16, f32 = torch.bfloat16, torch.float32
    d, f = STARCODER_D, STARCODER_F
    w = quantize_model({"up": randn(d, f, dtype=f32) * 0.02,
                        "down": randn(f, d, dtype=f32) * 0.02}, "strategy2")
    up, down = w["up"], w["down"]
    tiles = kept_f_tiles(down)
    need(tiles is not None and up.kept_blocks == d // 128 // 4,
         f"starcoder2-7b strategy2: up keeps {up.kept_blocks} blocks, down "
         f"is {type(down).__name__}")
    n_f, cols = tiles.numel(), columns(tiles, f)
    up_k = tile_subset(up, tiles)
    u16, d16 = dense_of(up), dense_of(down)
    uk16 = u16[:, cols]
    b16 = (randn(f) * 0.1, randn(d) * 0.1)
    line = {}
    for dtype, tokens in ((bf16, (4, 256)), (f32, (4,))):
        dname = str(dtype).split(".")[1]
        ub, db = (b.to(dtype) for b in b16)
        kw = dict(activation="gelu", up_bias=ub, down_bias=db)
        for t in tokens:
            x = randn(t, d, dtype=dtype)
            herr, hrel = max_errs(
                ffn_gate_up_sparse_cuda(x, None, up, "gelu", tiles,
                                        ub)[:, cols],
                ffn_gate_up_sparse_torch(x, None, up, "gelu", tiles, ub))
            err, rel = max_errs(ops.ffn_w4a16(x, None, up, down, **kw),
                                ops.ffn_w4a16(x, None, up, down,
                                              impl="torch", **kw))
            need(hrel <= tol[dname] and rel <= tol[dname],
                 f"ffn_fused_sparse_gelu T={t} {dname}: hidden rel "
                 f"{hrel:.3g}, out rel {rel:.3g} > {tol[dname]}")
            row = {"kernel": "ffn_fused_sparse_gelu", "strategy": "strategy2",
                   "dtype": dname, "T": t, "d": d, "f": f,
                   "up_kept_blocks": up.kept_blocks, "f_tiles": n_f,
                   "down_kept_blocks": down.kept_blocks,
                   "max_abs_err": herr, "max_rel_err": hrel,
                   "ffn_max_abs_err": err, "ffn_max_rel_err": rel,
                   "tol_rel": tol[dname]}
            if dtype == bf16:
                ubk = ub[cols]
                row["ms"] = timer.ms(lambda: ffn_gate_up_sparse_cuda(
                    x, None, up, "gelu", tiles, ub), 20)
                row["plain_ms"] = timer.ms(lambda: ffn_gate_up_sparse_torch(
                    x, None, up, "gelu", tiles, ub), 3)
                library(row, lambda: F.gelu(x @ dense_of(up_k) + ubk,
                                            approximate="tanh"),
                        lambda: F.gelu(x @ uk16 + ubk, approximate="tanh"))
                row["ffn_ms"] = timer.ms(
                    lambda: ops.ffn_w4a16(x, None, up, down, **kw), 20)
                row["ffn_plain_ms"] = timer.ms(lambda: ops.ffn_w4a16(
                    x, None, up, down, impl="torch", **kw), 3)
                library(row, lambda: ffn_chain(
                    torch, x, None, dense_of(up), dense_of(down), "gelu",
                    ub, db),
                    lambda: ffn_chain(torch, x, None, u16, d16, "gelu", ub,
                                      db), prefix="ffn_")
                # the kept f-tiles' up blocks and up bias, x in, the
                # hidden written; the whole FFN adds down and its bias
                u_flops = 2 * t * up.kept_blocks * 128 * n_f * 128
                row["bound_ms"], row["bound_by"] = bound(
                    x.numel() * 2 + up_k.nbytes_model + n_f * 128 * 2
                    + t * n_f * 128 * 2, u_flops, dname)
                row["ffn_bytes"] = (x.numel() * 2 + up_k.nbytes_model
                                    + down.nbytes_model
                                    + (n_f * 128 + d) * 2 + t * d * 2)
                row["ffn_bound_ms"], row["ffn_bound_by"] = bound(
                    row["ffn_bytes"],
                    u_flops + 2 * t * down.kept_blocks * 128 * d, dname)
            rows.append(row)
            log(f"  sparse gelu ffn (starcoder2-7b strategy2: up S="
                f"{up.kept_blocks}, down S={down.kept_blocks}, f-tiles kept "
                f"{n_f} of {f // 128}) {dname} T={t:3d}: hidden max_abs "
                f"{herr:.3g} rel {hrel:.3g}; ffn max_abs {err:.3g} rel "
                f"{rel:.3g} (tol {tol[dname]})" + times(row)
                + ("; whole ffn" + times(row, "ffn_") if "ms" in row else ""))
            if (t, dname) == (4, "bfloat16"):
                line["ffn_fused_sparse_gelu"] = row
    del u16, d16, uk16
    ub, db = b16
    kw = dict(activation="gelu", up_bias=ub, down_bias=db)
    xi = randn(INVARIANCE_ROWS, d)
    need(torch.equal(ops.ffn_w4a16(xi[:4], None, up, down, **kw),
                     ops.ffn_w4a16(xi[:256], None, up, down, **kw)[:4]),
         "ffn_fused_sparse_gelu: rows differ between T=4 and T=256")
    log("  ffn_fused_sparse_gelu: T=4 rows bitwise equal inside T=256")
    check_tile_invariance(
        torch, lambda v: ffn_gate_up_sparse_cuda(v, None, up, "gelu", tiles,
                                                 ub)[:, cols], xi,
        "ffn_fused_sparse_gelu up (gelu with the f32 bias)")
    check_tile_invariance(
        torch, lambda v: ops.ffn_w4a16(v, None, up, down, **kw), xi,
        "sparse gelu ffn (kernel 4 with the down bias)")
    for t in (37, 300):
        herr, hrel = max_errs(
            ffn_gate_up_sparse_cuda(xi[:t], None, up, "gelu", tiles,
                                    ub)[:, cols],
            ffn_gate_up_sparse_torch(xi[:t], None, up, "gelu", tiles, ub))
        err, rel = max_errs(
            ops.ffn_w4a16(xi[:t], None, up, down, **kw),
            ops.ffn_w4a16(xi[:t], None, up, down, impl="torch", **kw))
        need(max(hrel, rel) <= tol["bfloat16"], f"sparse gelu ffn T={t}: "
             f"hidden rel {hrel:.3g}, out rel {rel:.3g}")
    log("  ffn_fused_sparse_gelu: ragged T=37, 300 (stage and whole FFN) "
        "within tolerance of the plain versions")
    check_unaligned(
        torch, lambda xx, ww: ffn_gate_up_sparse_cuda(
            xx, None, ww, "gelu", tiles, ub)[:, cols], xi[:40], up,
        "ffn_fused_sparse_gelu (up)")
    del w, up, down, up_k, xi
    torch.cuda.empty_cache()
    return line


def check_unaligned(torch, fn, x, st, what) -> None:
    """``fn(x, st)`` with the sparse weight's packed blocks 4 bytes and its
    scales 8 bytes past a 16-byte boundary (the tile's narrow copies), and
    with x 2 bytes past one (copied to an aligned buffer by the wrapper),
    bitwise equal to the aligned call."""
    want = fn(x, st)
    pk = torch.empty(st.packed.numel() + 4, dtype=torch.uint8,
                     device=DEVICE)[4:].view(st.packed.shape)
    pk.copy_(st.packed)
    sc = torch.empty(st.scales.numel() + 4, dtype=torch.bfloat16,
                     device=DEVICE)[4:].view(st.scales.shape)
    sc.copy_(st.scales)
    odd = dataclasses.replace(st, packed=pk, scales=sc)
    xs = torch.empty(x.numel() + 1, dtype=x.dtype, device=DEVICE)
    x_odd = xs[1:].view(x.shape)
    x_odd.copy_(x)
    need(pk.data_ptr() % 16 != 0 and sc.data_ptr() % 16 != 0
         and x_odd.data_ptr() % 16 != 0, f"{what}: operands not misaligned")
    need(torch.equal(fn(x, odd), want) and torch.equal(fn(x_odd, st), want),
         f"{what}: misaligned operands change the result")
    log(f"  {what}: weights 4/8 bytes and x 2 bytes off a 16-byte boundary "
        "bitwise equal to aligned")


def attention_work(lengths, q_lens, hq, hkv, d, c, elt=2, kv_elt=None,
                   scale_bytes=0):
    """Bytes and operations the attention call needs on these inputs: q,
    the live K/V rows (``kv_elt`` bytes a value, plus ``scale_bytes`` per
    token and head for int8), out; 4*d operations per (query head, visible
    key).  The kernel reads no key at or past a row's length, so a paged
    row's partly filled last page counts its live keys only."""
    kv_elt = elt if kv_elt is None else kv_elt
    nbytes = 2 * (len(lengths) * hq * c * d * elt)
    flops = 0
    for length, ql in zip(lengths, q_lens):
        nbytes += 2 * length * hkv * (d * kv_elt + scale_bytes)
        for j in range(ql):
            flops += 4 * d * hq * (length - ql + j + 1)
    return nbytes, flops


def sdpa_yardstick(torch, q, kc, vc, lengths, q_lens):
    """One library call per row over its live cache (timed, never used)."""
    import torch.nn.functional as F
    outs = []
    rep = q.shape[1] // kc.shape[1]
    for i, (length, ql) in enumerate(zip(lengths.tolist(), q_lens.tolist())):
        if ql == 0:
            continue
        k = kc[i:i + 1, :, :length].repeat_interleave(rep, dim=1)
        v = vc[i:i + 1, :, :length].repeat_interleave(rep, dim=1)
        qq = q[i:i + 1, :, :ql]
        mask = (torch.arange(length, device=q.device)[None, :]
                <= (length - ql + torch.arange(ql, device=q.device))[:, None])
        outs.append(F.scaled_dot_product_attention(qq, k, v, attn_mask=mask))
    return outs


def cache_yardstick(torch, q, cache, lengths, q_lens, page_table):
    """The library yardstick of a paged or int8 call: gather the pool
    contiguous, dequantize, then ``sdpa_yardstick`` (timed, never used)."""
    from repro_torch.kernels.ops import _materialize_ref_cache
    k, v = _materialize_ref_cache(q, cache["k"], cache["v"],
                                  cache.get("k_scale"), cache.get("v_scale"),
                                  page_table)
    return sdpa_yardstick(torch, q, k, v, lengths, q_lens)


# the attention kernel's variants checked at a model's shapes: heads, head
# dim, the (paged, int8) variants and dtypes; ``slot_yardstick``: the slot
# fp kernel is timed beside them on the same data (qwen-7b's is phase 3's
# main attention case, so not a variant here); ``in_line``: the decode
# rows go into the kernels line
ATTENTION_SHAPES = (
    dict(model="qwen-7b", hq=32, hkv=4, hd=128,
         variants=((False, True), (True, False), (True, True)),
         dtypes=("bfloat16", "float32"), slot_yardstick=True, in_line=True),
    dict(model="gemma-2b", hq=8, hkv=1, hd=256,
         variants=((False, False), (False, True), (True, False),
                   (True, True)),
         dtypes=("bfloat16",), slot_yardstick=False, in_line=False),
    dict(model="whisper-small", hq=12, hkv=12, hd=64,
         variants=((False, False), (True, False)),
         dtypes=("bfloat16",), slot_yardstick=False, in_line=False),
    dict(model="zamba2-7b", hq=32, hkv=32, hd=112,
         variants=((False, False), (True, False)),
         dtypes=("bfloat16",), slot_yardstick=False, in_line=False),
    dict(model="qwen2-vl-7b", hq=28, hkv=4, hd=128,
         variants=((False, False), (True, True)),
         dtypes=("bfloat16",), slot_yardstick=False, in_line=False))


def check_attention_variants(torch, timer, randn, tol, rows, *, model, hq,
                             hkv, hd, variants, dtypes, slot_yardstick,
                             in_line) -> dict:
    """The attention kernel's ``variants`` (paged, int8 K/V) at one of
    ``ATTENTION_SHAPES``: B=4, pages of 16 tokens, MAX 512, decode (C=1)
    and a 64-wide chunk, on a scrambled page table (4 spare blocks, the
    null block last)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_flash import VARIANTS
    from repro_torch.models.attention import quantize_kv

    line = {}
    b, max_len, bs = 4, 512, 16
    n_pages = max_len // bs
    lengths = torch.tensor([37, 200, 5, 511], dtype=torch.int32,
                           device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(77)
    perm = torch.randperm(b * n_pages + 4, generator=gen, device="cuda")
    table = perm[:b * n_pages].reshape(b, n_pages).to(torch.int32)
    null = b * n_pages + 4

    def to_pool(t):
        pool = torch.zeros((null + 1, hkv, bs, t.shape[-1]), dtype=t.dtype,
                           device="cuda")
        pool[table.long()] = t.reshape(b, hkv, n_pages, bs, -1).transpose(1, 2)
        return pool

    def attend(q, cache, ql, impl="auto", **kw):
        return ops.mixed_attention(
            q, cache["k"], cache["v"], lengths, ql, k_scale=cache.get(
                "k_scale"), v_scale=cache.get("v_scale"), impl=impl, **kw)

    for dtype in (getattr(torch, n) for n in dtypes):
        dname = str(dtype).split(".")[1]
        k = randn(b, hkv, max_len, hd, dtype=torch.float32)
        v = randn(b, hkv, max_len, hd, dtype=torch.float32)
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        slot = {False: {"k": k.to(dtype), "v": v.to(dtype)},
                True: {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}}
        paged = {qnt: {n: to_pool(t) for n, t in c.items()}
                 for qnt, c in slot.items()}
        q64 = randn(b, hq, 64, hd, dtype=dtype)
        for c, q_lens in ((1, [1, 1, 1, 1]), (64, [1, 64, 5, 17])):
            ql = torch.tensor(q_lens, dtype=torch.int32, device="cuda")
            q = q64[:, :, :c].contiguous()
            if dtype == torch.bfloat16 and slot_yardstick:
                # the slot fp kernel on the same data: the yardstick of
                # what int8 and 16-key pages cost (not a variant of its own)
                ms = timer.ms(lambda: attend(q, slot[False], ql), 20)
                rows.append({"kernel": VARIANTS[(False, False)],
                             "inputs": "variants'", "dtype": dname, "C": c,
                             "lengths": lengths.tolist(), "q_lens": q_lens,
                             "ms": ms})
                log(f"  {VARIANTS[(False, False)]} (slot fp, same inputs) "
                    f"{dname} C={c:2d}: kernel {ms:.4f} ms")
            for is_paged, quant in variants:
                name = VARIANTS[(is_paged, quant)]
                cache = (paged if is_paged else slot)[quant]
                kw = {"page_table": table} if is_paged else {}
                got = attend(q, cache, ql, **kw)
                want = attend(q, cache, ql, impl="torch", **kw)
                err, rel = max_errs(got, want)
                need(rel <= tol[dname], f"{name} C={c} {dname}: rel err "
                     f"{rel:.3g} > {tol[dname]}")
                row = {"kernel": name, "model": model, "dtype": dname,
                       "B": b, "hq": hq,
                       "hkv": hkv, "d": hd, "max_len": max_len, "C": c,
                       "page": bs if is_paged else None,
                       "lengths": lengths.tolist(), "q_lens": q_lens,
                       "max_abs_err": err, "max_rel_err": rel,
                       "tol_rel": tol[dname]}
                if is_paged:
                    # paging is a layout change: the slot kernel walking
                    # 16-key tiles reduces in the same order
                    same = torch.equal(got, attend(q, slot[quant], ql,
                                                   block_kv=bs))
                    row["bitwise_equal_slot_block_kv_16"] = same
                    need(same, f"{name} C={c} {dname}: paged is not bitwise "
                         "the slot kernel at block_kv = 16")
                if dtype == torch.bfloat16:
                    row["ms"] = timer.ms(lambda: attend(q, cache, ql, **kw),
                                         20)
                    row["plain_ms"] = timer.ms(
                        lambda: attend(q, cache, ql, impl="torch", **kw), 3)
                    row["library_ms"] = timer.ms(
                        lambda: cache_yardstick(torch, q, cache, lengths, ql,
                                                kw.get("page_table")), 5)
                    nbytes, flops = attention_work(
                        lengths.tolist(), q_lens, hq, hkv, hd, c,
                        kv_elt=1 if quant else 2,
                        scale_bytes=4 if quant else 0)
                    row["bound_ms"], row["bound_by"] = bound(nbytes, flops,
                                                             dname)
                rows.append(row)
                log(f"  {name} {model} d={hd} {dname} C={c:2d}: max_abs "
                    f"{err:.3g} rel {rel:.3g} (tol {tol[dname]})"
                    + ("; bitwise = slot at block_kv 16" if is_paged else "")
                    + (f"  kernel {row['ms']:.4f} ms plain "
                       f"{row['plain_ms']:.4f} ms library "
                       f"{row['library_ms']:.4f} ms bound "
                       f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
                       if "ms" in row else ""))
                if in_line and (c, dname) == (1, "bfloat16"):
                    line[name] = row
        # the null block and every unleased block never reach a sum
        ql = torch.tensor([1, 64, 5, 17], dtype=torch.int32, device="cuda")
        live = (lengths.long() + bs - 1) // bs
        short = table.clone()
        short[torch.arange(n_pages, device="cuda")[None, :]
              >= live[:, None]] = null
        leased = torch.zeros(null + 1, dtype=torch.bool, device="cuda")
        leased[short[short != null].long()] = True
        for quant in (False, True):
            clean = attend(q64, paged[quant], ql, page_table=short)
            for t in paged[quant].values():
                if t.dtype != torch.int8:
                    t[~leased] = float("nan")
            poisoned = attend(q64, paged[quant], ql, page_table=short)
            need(bool(torch.isfinite(poisoned).all())
                 and torch.equal(poisoned, clean),
                 f"{VARIANTS[(True, quant)]} {dname}: NaN in the null or "
                 "an unleased block reached the output")
        log(f"  paged {model} d={hd} {dname}: NaN in the null and "
            "unleased blocks changes nothing (fp and int8)")
        del slot, paged
    return line


def visible_pairs(sq, skv, causal, window):
    """(query, key) pairs the masks leave visible, per batch row and head:
    the work this call's data needs (skipped and masked pairs excluded)."""
    import numpy as np
    q_pos = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(q_pos + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(q_pos - window + 1, 0) if window else np.zeros(sq, int)
    return int(np.clip(hi - lo, 0, None).sum())


def sdpa_full(torch, q, k, v, causal, window):
    """One ``scaled_dot_product_attention`` call on the same inputs, the
    q block ending the context (timed, never used by the port)."""
    import torch.nn.functional as F
    sq, skv = q.shape[2], k.shape[2]
    mask = None
    if causal or window:
        q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        k_pos = torch.arange(skv, device=q.device)[None, :]
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos >= k_pos
        if window:
            mask &= q_pos - k_pos < window
    if causal and not window and sq == skv:
        mask = None
    return F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=mask is None and causal,
        enable_gqa=q.shape[1] != k.shape[1])


# name: (B, hq, hkv, Sq, Skv, d, causal, window)
FLASH_CASES = {
    "qwen-7b causal S=2048": (1, 32, 4, 2048, 2048, 128, True, None),
    "chunked Sq=4096 Skv=8192": (1, 32, 4, 4096, 8192, 128, True, None),
    "ragged S=300": (1, 32, 4, 300, 300, 128, True, None),
    "chatglm-6b rep 16 S=1024": (1, 32, 2, 1024, 1024, 128, True, None),
    "window 256 S=1024": (1, 32, 4, 1024, 1024, 128, True, 256),
    "non-causal Sq=448 Skv=1500 d=64": (1, 12, 12, 448, 1500, 64, False,
                                        None),
    "whisper encoder Sq=Skv=1500 d=64": (1, 12, 12, 1500, 1500, 64, False,
                                         None),
    "whisper cross decode B=4 Sq=1 Skv=1500 d=64": (4, 12, 12, 1, 1500, 64,
                                                    False, None),
    "whisper decoder causal B=2 S=256 d=64": (2, 12, 12, 256, 256, 64, True,
                                              None),
    "gemma-2b causal S=2048 d=256": (1, 8, 1, 2048, 2048, 256, True, None),
    "gemma-2b ragged S=300 d=256": (1, 8, 1, 300, 300, 256, True, None),
    "zamba2-7b causal S=2048 d=112": (1, 32, 32, 2048, 2048, 112, True,
                                      None),
    "zamba2-7b ragged S=300 d=112": (1, 32, 32, 300, 300, 112, True, None),
    # a 16 x 16 image's patches before 300 text tokens, rep 7
    "qwen2-vl-7b image+text B=2 S=556 rep 7": (2, 28, 4, 556, 556, 128, True,
                                               None),
}


def check_flash_attention(torch, timer, randn, tol, rows) -> dict:
    """Kernel 7 against its plain version (at the kernel's tiles and at the
    TPU kernel's, which ``impl="torch"`` runs) and the dense oracle, bf16
    and f32, at the shapes the prefill and forward paths give it; kernel,
    plain and ``scaled_dot_product_attention`` times beside the bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        BLOCK_KV, BLOCK_Q, HEAD_DIMS, flash_attention_torch)
    line = {}
    for name, (b, hq, hkv, sq, skv, d, causal, window) in FLASH_CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            q = randn(b, hq, sq, d, dtype=dtype)
            k = randn(b, hkv, skv, d, dtype=dtype)
            v = randn(b, hkv, skv, d, dtype=dtype)
            kw = dict(causal=causal, window=window)
            if d not in HEAD_DIMS[dtype]:
                # refused before the device (float32 at 112)
                try:
                    ops.attention(q, k, v, **kw)
                    refused = False
                except ValueError:
                    refused = True
                need(refused, f"flash_attention {name} {dname}: a head dim "
                     "the kernel is not instantiated at was not refused")
                log(f"  flash_attention {name} {dname}: refused before the "
                    "device, as its wrapper says")
                del q, k, v
                continue
            got = ops.attention(q, k, v, **kw)
            errs = {}
            for what, want in (
                    ("plain_kernel_tiles", lambda: flash_attention_torch(
                        q, k, v, block_q=BLOCK_Q, block_kv=BLOCK_KV, **kw)),
                    ("plain", lambda: ops.attention(q, k, v, impl="torch",
                                                    **kw)),
                    ("ref", lambda: ops.attention(q, k, v, impl="ref",
                                                  **kw))):
                errs[what] = max_errs(got, want())
                torch.cuda.empty_cache()
            bad = {w: e for w, e in errs.items() if not e[1] <= tol[dname]}
            need(not bad and bool(torch.isfinite(got).all()),
                 f"flash_attention {name} {dname}: rel err {bad} > "
                 f"{tol[dname]}")
            row = {"kernel": "flash_attention", "case": name, "dtype": dname,
                   "B": b, "hq": hq, "hkv": hkv, "Sq": sq, "Skv": skv, "d": d,
                   "causal": causal, "window": window,
                   "max_abs_err": errs["plain"][0],
                   "max_rel_err": errs["plain"][1],
                   "errs": {w: {"max_abs": e[0], "max_rel": e[1]}
                            for w, e in errs.items()},
                   "tol_rel": tol[dname]}
            if dtype == torch.bfloat16:
                big = sq * skv >= 4096 * 8192
                row["ms"] = timer.ms(lambda: ops.attention(q, k, v, **kw),
                                     5 if big else 10)
                row["plain_ms"] = timer.ms(
                    lambda: ops.attention(q, k, v, impl="torch", **kw), 1)
                row["library_ms"] = timer.ms(
                    lambda: sdpa_full(torch, q, k, v, causal, window), 5)
                row["library_factor"] = row["ms"] / row["library_ms"]
                pairs = visible_pairs(sq, skv, causal, window)
                nbytes = 2 * (2 * b * hq * sq * d + 2 * b * hkv * skv * d)
                row["visible_pairs"] = pairs
                row["bound_ms"], row["bound_by"] = bound(
                    nbytes, 4 * d * b * hq * pairs, dname)
            rows.append(row)
            log(f"  flash_attention {name} {dname}: max_abs "
                f"{errs['plain'][0]:.3g} rel {errs['plain'][1]:.3g} (vs "
                f"kernel tiles {errs['plain_kernel_tiles'][1]:.3g}, oracle "
                f"{errs['ref'][1]:.3g}; tol {tol[dname]})"
                + (f"  kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f}"
                   f" ms sdpa {row['library_ms']:.4f} ms (kernel / sdpa "
                   f"{row['library_factor']:.2f}) bound "
                   f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
                   if "ms" in row else ""))
            if (name, dname) == ("qwen-7b causal S=2048", "bfloat16"):
                line["flash_attention"] = row
            del q, k, v, got
            torch.cuda.empty_cache()
    # batch and query invariance: a row of B=3 is the row alone, and the
    # last 64 queries are those queries alone (bf16 also at d = 64); the
    # last 300 queries of a 1024-query call (a ragged query tiling) are
    # those queries alone (bf16, d = 128 and 64)
    for dtype, d in ((torch.bfloat16, 128), (torch.float32, 128),
                     (torch.bfloat16, 64), (torch.bfloat16, 256),
                     (torch.bfloat16, 112)):
        q = randn(3, 32, 512, d, dtype=dtype)
        k = randn(3, 4, 512, d, dtype=dtype)
        v = randn(3, 4, 512, d, dtype=dtype)
        full = ops.attention(q, k, v)
        need(torch.equal(full[1:2], ops.attention(q[1:2], k[1:2], v[1:2])),
             f"flash_attention {dtype} d={d}: row 1 of B=3 differs from B=1")
        need(torch.equal(full[:, :, -64:], ops.attention(q[:, :, -64:], k,
                                                         v)),
             f"flash_attention {dtype} d={d}: the last 64 queries differ "
             "alone")
    for d in (128, 64, 256, 112):
        q = randn(1, 32, 1024, d)
        k = randn(1, 4, 1024, d)
        v = randn(1, 4, 1024, d)
        need(torch.equal(ops.attention(q, k, v)[:, :, -300:],
                         ops.attention(q[:, :, -300:], k, v)),
             f"flash_attention bf16 d={d}: the last 300 of 1024 queries "
             "differ alone")
    log("  flash_attention: a row of B=3 bitwise equal to B=1; the last 64 "
        "queries bitwise equal alone (bf16 d=128, 64, 256 and 112, f32 "
        "d=128); the last 300 of 1024 queries bitwise equal alone (bf16 "
        "d=128, 64, 256 and 112)")
    return line


# kernel 8 against its plain version and the `_slstm_step` oracle: the
# reference's own tolerance (rtol = atol = 2e-4, tests/test_kernels.py:272),
# all three in f32 over bf16 R widened exactly
SCAN_TOL = 2e-4
XLSTM_H, XLSTM_SLSTM_DH, XLSTM_MLSTM_DH = 4, 512, 1024   # xlstm-1.3b


def ptxas_lines(report: str) -> list:
    """The ``-Xptxas -v`` lines of one kernel library: entries, registers,
    shared memory, spills."""
    return [ln.strip() for ln in report.splitlines()
            if any(w in ln for w in ("Compiling entry", "registers", "spill",
                                     "smem"))]


def check_xlstm_kernels(torch, timer, randn, tol, rows, ptxas) -> dict:
    """Kernel 8 (``slstm_scan``) and the mLSTM decode cell at xlstm-1.3b's
    widths: the scan over a forward's B=2 x L=512 and a ragged L=300, and
    one decode step of B=4 from a lived-in state (an inactive row keeps
    its state); the cell at B=4, 4 heads of 1024.  Each against its plain
    version, rows bitwise equal alone; the scan on its cluster kernel
    (``scan_plan``) in every case, L steps bitwise equal to L one-step
    calls with the state carried, and the chain floor (one dh-long fmaf
    chain and one cluster barrier a step) timed beside it; times after an
    L2 flush.  No single PyTorch call computes either, so neither has a
    library time."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import slstm_scan as scan
    from repro_torch.kernels.slstm_scan import slstm_scan_torch
    from repro_torch.kernels.mlstm_cell import cell_plan, mlstm_cell_torch

    line = {}
    h, dh = XLSTM_H, XLSTM_SLSTM_DH
    r = (randn(h, dh, 4 * dh, dtype=torch.float32) * 0.02).to(torch.bfloat16)
    bias = randn(h, 4 * dh, dtype=torch.float32) * 0.1
    plan = scan.scan_plan(h, dh, r.dtype)
    need(plan.kernel == "cluster", f"slstm_scan: scan_plan({h}, {dh}, "
         f"bfloat16) chose {plan.kernel}, not the cluster kernel")
    capacity = scan.cluster_capacity(dh)
    need(capacity >= h, f"slstm_scan: the card holds {capacity} clusters of "
         f"{plan.cluster} CTAs at once, xlstm-1.3b's {h} heads need {h}")
    log(f"  slstm_scan plan: {plan}; {capacity} clusters fit at once")

    def state(b):
        c, hid, m = (randn(b, h, dh, dtype=torch.float32) for _ in range(3))
        return c, randn(b, h, dh, dtype=torch.float32).abs() + 0.5, hid, m

    for b, L, what in ((2, 512, "forward"), (2, 300, "ragged"),
                       (4, 1, "decode")):
        gx = randn(b, L, h, 4 * dh, dtype=torch.float32)
        st0 = state(b) if what == "decode" else None
        active = (torch.tensor([True, True, False, True], device=DEVICE)
                  if what == "decode" else None)

        def copy():
            return None if st0 is None else tuple(t.clone() for t in st0)
        kst, pst = copy(), copy()
        before = scan.routes["cluster"]
        got = ops.slstm_scan(gx, r, bias, kst, active=active)
        need(scan.routes["cluster"] == before + 1,
             f"slstm_scan {what}: the cluster kernel did not run")
        want = slstm_scan_torch(gx, r, bias, pst, active)
        oracle = ops.slstm_scan(gx, r, bias, copy(), impl="ref")
        err, rel = max_errs(got, want)
        ok = (torch.allclose(got, want, rtol=SCAN_TOL, atol=SCAN_TOL)
              and torch.allclose(got, oracle, rtol=SCAN_TOL, atol=SCAN_TOL))
        if st0 is not None:
            ok = ok and all(torch.allclose(k, p, rtol=SCAN_TOL, atol=SCAN_TOL)
                            for k, p in zip(kst, pst))
            need(all(torch.equal(k[2], s[2]) for k, s in zip(kst, st0)),
                 "slstm_scan decode: the inactive row's state changed")
        need(ok, f"slstm_scan {what} B={b} L={L}: max_abs {err:.3g} beyond "
             f"rtol = atol = {SCAN_TOL} of the plain scan or the oracle")
        # a row alone is bitwise the same row in the batch (and state)
        one = copy()
        alone = ops.slstm_scan(gx[1:2].contiguous(), r, bias,
                               None if one is None else
                               tuple(t[1:2].clone() for t in one))
        need(torch.equal(alone[0], got[1]),
             f"slstm_scan {what}: row 1 alone differs from row 1 of B={b}")
        row = {"kernel": "slstm_scan", "case": what, "B": b, "L": L, "h": h,
               "dh": dh, "r_dtype": "bfloat16", "route": plan.kernel,
               "cluster": plan.cluster, "max_abs_err": err,
               "max_rel_err": rel, "tol_abs_rel": SCAN_TOL}
        if what == "forward":
            # L steps in one call are L one-step calls, state carried
            carried = scan.fresh_state(b, h, dh, DEVICE)
            steps = torch.cat([ops.slstm_scan(gx[:, t:t + 1].contiguous(), r,
                                              bias, carried)
                               for t in range(L)], dim=1)
            need(torch.equal(steps, got), f"slstm_scan {what}: {L} one-step "
                 "calls with the state carried differ from one call")
            row["chain_floor_ms"] = timer.ms(
                lambda: scan.chain_floor_cuda(L, dh, DEVICE), 10)
        if what != "ragged":
            scratch = copy()      # the timed calls advance it in place
            row["ms"] = timer.ms(lambda: ops.slstm_scan(
                gx, r, bias, scratch, active=active), 10)
            row["plain_ms"] = timer.ms(lambda: slstm_scan_torch(
                gx, r, bias, scratch, active), 2)
            row["library_ms"] = None
            nbytes = (gx.numel() * 4 + b * L * h * dh * 4 + r.numel() * 2
                      + bias.numel() * 4
                      + (8 * b * h * dh * 4 if st0 is not None else 0))
            row["bound_ms"], row["bound_by"] = bound(
                nbytes, 2 * b * L * h * dh * 4 * dh, "float32")
        rows.append(row)
        log(f"  slstm_scan {what} B={b} L={L} h={h} dh={dh}: {plan.kernel} "
            f"kernel; max_abs {err:.3g} rel {rel:.3g} (rtol = atol = "
            f"{SCAN_TOL}, plain and oracle); row 1 alone bitwise"
            + ("; L one-step calls bitwise" if what == "forward" else "")
            + (f"  kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
               f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; a chain "
               f"of {L} dependent steps); library: none"
               if "ms" in row else "")
            + (f"; chain floor {row['chain_floor_ms']:.4f} ms ({L} steps of "
               f"a {dh}-long fmaf chain + a cluster barrier)"
               if "chain_floor_ms" in row else ""))
        if what == "decode":
            row["ptxas"] = ptxas_lines(ptxas.get("slstm_scan", ""))
            line["slstm_scan"] = row

    # -- the mLSTM decode cell: B=4, 4 heads of 1024, bf16 activations
    b, dh = 4, XLSTM_MLSTM_DH
    di = h * dh
    xp = randn(b, di)
    q, k, v = (randn(b, h, dh) for _ in range(3))
    w_i, w_f = ((randn(di, h, dtype=torch.float32) * 0.01).to(torch.bfloat16)
                for _ in range(2))
    b_i = randn(h, dtype=torch.float32) * 0.1
    b_f = 3.0 + randn(h, dtype=torch.float32) * 0.1
    C0 = randn(b, h, dh, dh, dtype=torch.float32) * 0.1
    n0 = randn(b, h, dh, dtype=torch.float32).abs() + 0.5
    m0 = randn(b, h, dtype=torch.float32)
    active = torch.tensor([True, False, True, True], device=DEVICE)
    args = (xp, q, k, v, w_i, w_f, b_i, b_f)
    Ck, Cp = C0.clone(), C0.clone()
    got = ops.mlstm_cell(*args, Ck, n0, m0, active=active)
    want = mlstm_cell_torch(*args, Cp, n0, m0, active)
    errs = [max_errs(g, w) for g, w in zip(got + (Ck,), want + (Cp,))]
    err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    # bf16 activations: a gate that rounds one bf16 step apart moves the
    # exponentials by 2^-8 (the state itself is f32)
    need(rel <= tol["bfloat16"], f"mlstm_cell: rel err {rel:.3g} > "
         f"{tol['bfloat16']} (y, n', m', C')")
    need(torch.equal(Ck[1], C0[1]) and torch.equal(got[1][1], n0[1])
         and torch.equal(got[2][1], m0[1]),
         "mlstm_cell: the inactive row's state changed")
    Cr = C0[2:3].clone()
    yr, nr, mr = ops.mlstm_cell(*(t[2:3].contiguous() for t in args[:4]),
                                *args[4:], Cr, n0[2:3].contiguous(),
                                m0[2:3].contiguous())
    need(torch.equal(yr[0], got[0][2]) and torch.equal(Cr[0], Ck[2])
         and torch.equal(nr[0], got[1][2]) and torch.equal(mr[0], got[2][2]),
         "mlstm_cell: row 2 alone differs from row 2 of B=4")
    row = {"kernel": "mlstm_cell", "B": b, "h": h, "dh": dh,
           "dtype": "bfloat16", "plan": dataclasses.asdict(
               cell_plan(h, dh, torch.bfloat16)),
           "max_abs_err": err, "max_rel_err": rel,
           "tol_rel": tol["bfloat16"],
           "ptxas": ptxas_lines(ptxas.get("mlstm_cell", "")),
           "ms": timer.ms(lambda: ops.mlstm_cell(*args, Ck, n0, m0), 10),
           "plain_ms": timer.ms(lambda: mlstm_cell_torch(*args, Cp, n0, m0),
                                3),
           "library_ms": None,
           # yardstick, not the cell: PyTorch's in-place elementwise pass
           # reads and writes the same C once
           "stream_ms": timer.ms(lambda: Cp.mul_(0.5), 10)}
    nbytes = (2 * C0.numel() * 4 + 2 * (n0.numel() + m0.numel()) * 4
              + sum(t.numel() * 2 for t in args[:6]) + b * h * dh * 4)
    row["bound_ms"], row["bound_by"] = bound(nbytes, 5 * C0.numel()
                                             + 4 * b * di * h, "float32")
    rows.append(row)
    log(f"  mlstm_cell B={b} h={h} dh={dh}: max_abs {err:.3g} rel {rel:.3g} "
        f"(tol {tol['bfloat16']}); inactive row kept; row 2 alone bitwise"
        f"  kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}); library: none; "
        f"C.mul_ over the same C {row['stream_ms']:.4f} ms")
    line["mlstm_cell"] = row
    return line


# -- the MoE family: routing, the grouped experts, the combine ---------------

# the grid-per-expert kernels' times before the persistent ring (NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md's kernel table), printed beside this
# run's
MOE_GRID_MS = {
    ("moe_gate_up_w4a16", "granite decode T=4"): 0.0307,
    ("moe_gate_up_w4a16", "granite chunk 4x64"): 0.0649,
    ("moe_gate_up_w4a16", "granite chunk 4x64 factor 1.25"): 0.0630,
    ("moe_gate_up_w4a16", "mixtral decode T=4"): 0.3187,
    ("moe_down_w4a16", "granite decode T=4"): 0.0183,
    ("moe_down_w4a16", "granite chunk 4x64"): 0.0415,
    ("moe_down_w4a16", "granite chunk 4x64 factor 1.25"): 0.0397,
    ("moe_down_w4a16", "mixtral decode T=4"): 0.2110}
# (name, d, f, experts, top_k, group) of the served MoE configurations
MOE_SHAPES = {"granite": (1536, 512, 40, 8, 32),
              "mixtral": (6144, 16384, 8, 2, 128)}
GRANITE_VOCAB = 49155


def ulps(torch, got, want) -> float:
    """The largest distance between two f32 tensors in units of the last
    place of ``want``."""
    inf = torch.full_like(want, float("inf"))
    step = (torch.nextafter(want, inf) - want).abs()
    return float(((got - want).abs() / step).max())


def moe_weights(torch, randn, d, f, e, group):
    """Random experts quantized by ``quantize`` at ``group`` rows: gate and
    up (E, d, f), down (E, f, d), and an f32 router (d, E)."""
    from repro_torch.core.quant import quantize
    gate, up = (quantize(randn(e, d, f, dtype=torch.float32) * 0.03,
                         group_size=group) for _ in range(2))
    down = quantize(randn(e, f, d, dtype=torch.float32) * 0.03,
                    group_size=group)
    return randn(d, e, dtype=torch.float32) * 0.05, gate, up, down


def moe_layer(torch, x, router, gate, up, down, k, cap, group_len,
              impl="auto"):
    """One MoE layer on (T, d) rows in groups of ``group_len``: the router
    product with the route, the experts and the combine, each through
    ``impl``."""
    from repro_torch.kernels import ops
    _, r = ops.moe_router_route(x, router.to(x.dtype), group=group_len,
                                top_k=k, capacity=cap, impl=impl)
    y = ops.moe_ffn_w4a16(x, r, gate, up, down, impl=impl)
    return ops.moe_combine(y, r.slot, r.topw, impl=impl), r


ROUTE_FIELDS = ("topw", "topi", "slot", "counts", "offsets")


def same_route(torch, got, want) -> bool:
    """Every field of two ``Route``s bitwise (rows up to the kept ones)."""
    kept = int(want.counts.sum())
    return (all(torch.equal(getattr(got, f), getattr(want, f))
                for f in ROUTE_FIELDS)
            and torch.equal(got.rows[:kept], want.rows[:kept])
            and got.max_rows == want.max_rows)


def check_moe_kernels(torch, timer, randn, tol, rows) -> dict:
    """The MoE kernels against their plain versions at the served widths:
    granite-moe-3b-a800m (d 1536, d_ff 512, 40 experts, top-8, 32-row
    groups) at a decode tick (T = 4, four groups of one) and a 4 x 64
    chunk (at the dropless capacity 64 and the published factor's 16,
    which drops), and mixtral-8x22b (d 6144, d_ff 16384, 8 experts,
    top-2, 128-row groups) at T = 4.  ``moe_route`` with the router's
    product inside it (``moe_router_route_cuda``): logits bitwise
    ``dense_matmul``'s and every ``Route`` field bitwise the route kernel's
    on them (the chain it replaced, timed beside it); on given logits:
    indices, slots, counts, offsets and rows bitwise the plain version,
    weights within 2 ulp; the grouped gate/up and down: the W4A16
    tolerance on every kept row; ``moe_combine`` bitwise;
    ``combine_add_rmsnorm`` bitwise ``moe_combine`` then ``add_rmsnorm``
    (timed beside that chain) and its plain version.  Each timed beside
    its bound, its plain version and a yardstick (``torch.topk`` +
    ``scatter_add_`` for the route, after ``x @ router`` for the fused
    one; per-expert dequantize + ``torch.matmul`` chains for the
    experts).  A token's layer
    output is bitwise the same alone (T = 4) and inside the 64-wide
    chunk.  Kernels 1 and 2 alone at 32- and 64-row groups (granite's
    widths, T = 4 and 256) against their plain versions, and rows 100-103
    bitwise across their tile configurations.  The tied LM head
    (``dense_matmul`` reading the (49155, 1536) embedding in place) against
    its plain version, bitwise against the same weight copied, and row
    invariant."""
    from repro_torch.core.quant import dequantize, quantize
    from repro_torch.kernels import moe_experts as mx
    from repro_torch.kernels import ops
    from repro_torch.kernels.ffn_fused import (
        ffn_gate_up_cuda, ffn_gate_up_torch)
    from repro_torch.kernels.moe_route import (
        moe_combine_cuda, moe_combine_torch, moe_route_cuda, moe_route_torch,
        moe_router_route_cuda, moe_router_route_torch)
    from repro_torch.kernels.rmsnorm import (
        add_rmsnorm_cuda, combine_add_rmsnorm_cuda, combine_add_rmsnorm_torch)
    from repro_torch.kernels.w4a16_matmul import (
        w4a16_matmul_cuda, w4a16_matmul_torch)
    bf16 = torch.bfloat16
    line = {}

    def record(row, kernel, plain, library, nbytes, flops, iters=20,
               chain=None, library_once=None):
        row["ms"] = timer.ms(kernel, iters)
        if chain is not None:
            row["chain_ms"] = timer.ms(chain, iters)
        row["plain_ms"] = timer.ms(plain, 2)
        row["library_ms"] = (timer.ms(library, 3) if library is not None
                             else None)
        if library_once is not None:
            row["library_once_ms"] = timer.ms(library_once, 10)
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, "bfloat16")
        before = MOE_GRID_MS.get((row["kernel"], row["case"]))
        if before is not None:
            row["grid_per_expert_ms"] = before
        rows.append(row)
        log(f"  {row['kernel']} {row['case']}: max_abs "
            f"{row['max_abs_err']:.3g}  kernel {row['ms']:.4f} ms "
            + (f"[grid per expert: {before:.4f} ms] " if before is not None
               else "")
            + (f"[the chain it replaced: {row['chain_ms']:.4f} ms] "
               if chain is not None else "")
            + "plain "
            f"{row['plain_ms']:.4f} ms library "
            + (f"{row['library_ms']:.4f} ms" if library is not None else
               "none")
            + (f" (on weights dequantized once {row['library_once_ms']:.4f}"
               " ms)" if library_once is not None else "")
            + f" bound {row['bound_ms']:.4f} ms ({row['bound_by']})")

    cases = (("granite", "decode T=4", 4, 1, None),
             ("granite", "chunk 4x64", 4, 64, None),
             ("granite", "chunk 4x64 factor 1.25", 4, 64, 16),
             ("mixtral", "decode T=4", 4, 1, None))
    weights = {}
    for model, case, b, s, cap in cases:
        d, f, e, k, group = MOE_SHAPES[model]
        if model not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            weights[model] = moe_weights(torch, randn, d, f, e, group)
        router, gate, up, down = weights[model]
        cap = s if cap is None else cap          # dropless: the group's length
        cap = max(k, min(cap, s))
        t = b * s
        x = randn(t, d)
        router_b = router.to(bf16)
        logits = ops.dense_matmul(x, router_b)
        what = f"{model} {case}"

        # -- the route with the router's product inside it, against the
        # chain it replaced: the dense_matmul kernel, then the route kernel
        # on its logits (bitwise), and against its plain version
        f_logits, f_route = moe_router_route_cuda(x, router_b, s, k, cap)
        chain_route = moe_route_cuda(logits, s, k, cap)
        torch.cuda.synchronize()
        need(torch.equal(f_logits, logits),
             f"moe_route {what}: the fused product's logits are not bitwise "
             "dense_matmul's")
        need(same_route(torch, f_route, chain_route),
             f"moe_route {what}: the fused route is not bitwise the route "
             "kernel's on dense_matmul's logits")
        p_logits, p_route = moe_router_route_torch(x, router_b, s, k, cap)
        fu = ulps(torch, f_route.topw, p_route.topw)
        row = {"kernel": "moe_route", "case": f"{what} with the product",
               "T": t, "group": s, "experts": e, "top_k": k, "capacity": cap,
               "d": d, "logits_bitwise_dense_matmul": True,
               "route_bitwise_chain": True,
               "logits_max_abs_err_plain": float(
                   (f_logits.float() - p_logits.float()).abs().max()),
               "topi_equal_plain": bool(torch.equal(f_route.topi,
                                                    p_route.topi)),
               "max_ulps_plain": fu,
               "max_abs_err": float((f_route.topw - chain_route.topw).abs()
                                    .max())}

        def topk_matmul():
            w, i = torch.topk(torch.softmax((x @ router_b).float(), -1), k)
            c = torch.zeros(e, dtype=torch.int64, device=x.device)
            return w / w.sum(-1, keepdim=True), c.scatter_add_(
                0, i.reshape(-1), torch.ones_like(i.reshape(-1)))
        ints = t * k * 4 * 4 + e * 8 + b * e * 4
        record(row, lambda: moe_router_route_cuda(x, router_b, s, k, cap),
               lambda: moe_router_route_torch(x, router_b, s, k, cap),
               topk_matmul, x.numel() * 2 + router_b.numel() * 2
               + t * e * 2 + ints, 2 * t * d * e,
               chain=lambda: moe_route_cuda(ops.dense_matmul(x, router_b),
                                            s, k, cap))
        log(f"    logits bitwise dense_matmul's; route bitwise the chain's; "
            f"plain: logits max_abs {row['logits_max_abs_err_plain']:.3g}, "
            f"indices equal {row['topi_equal_plain']}, weights {fu:.1f} ulp")
        if (model, case) == ("granite", "decode T=4"):
            line["moe_route"] = row

        # -- the route
        got = moe_route_cuda(logits, s, k, cap)
        want = moe_route_torch(logits, s, k, cap)
        torch.cuda.synchronize()
        kept = int(got.counts.sum())
        for name in ("topi", "slot", "counts", "offsets"):
            need(torch.equal(getattr(got, name), getattr(want, name)),
                 f"moe_route {what}: {name} differs from the plain version")
        need(torch.equal(got.rows[:kept], want.rows[:kept]),
             f"moe_route {what}: rows differ from the plain version")
        u = ulps(torch, got.topw, want.topw)
        need(u <= 2, f"moe_route {what}: weights {u:.1f} ulp from plain")
        dropped = t * k - kept
        active = int((got.counts > 0).sum())
        row = {"kernel": "moe_route", "case": what, "T": t, "group": s,
               "experts": e, "top_k": k, "capacity": cap,
               "max_abs_err": float((got.topw - want.topw).abs().max()),
               "max_ulps": u, "dropped": dropped, "active_experts": active,
               "kept": kept}

        def topk_scatter():
            w, i = torch.topk(torch.softmax(logits.float(), -1), k)
            c = torch.zeros(e, dtype=torch.int64, device=logits.device)
            return w / w.sum(-1, keepdim=True), c.scatter_add_(
                0, i.reshape(-1), torch.ones_like(i.reshape(-1)))
        record(row, lambda: moe_route_cuda(logits, s, k, cap),
               lambda: moe_route_torch(logits, s, k, cap), topk_scatter,
               logits.numel() * 2 + ints, 0)
        log(f"    indices, slots, counts, offsets, rows bitwise; weights "
            f"within {u:.1f} ulp; {kept} kept, {dropped} dropped, {active} "
            f"of {e} experts with rows")
        r = got

        # -- the grouped experts, on the kernel's route
        h_got = mx.moe_gate_up_cuda(x, r, gate, up, "swiglu")
        h_want = mx.moe_gate_up_torch(x, r, gate, up, "swiglu")
        herr, hrel = max_errs(h_got[:kept], h_want[:kept])
        need(hrel <= tol["bfloat16"], f"moe_gate_up {what}: rel {hrel:.3g}")
        w_bytes = active * (gate.nbytes_model + up.nbytes_model) / e
        counts = r.counts.tolist()

        def library_gate_up():
            for ex, (o, n) in enumerate(zip(r.offsets.tolist(), counts)):
                if n:
                    xe = x[r.rows[o:o + n].long()]
                    torch.nn.functional.silu(
                        xe @ dequantize(gate[ex], bf16)) * (
                        xe @ dequantize(up[ex], bf16))
        row = {"kernel": "moe_gate_up_w4a16", "case": what, "T": t,
               "kept": kept, "active_experts": active, "group": group,
               "max_abs_err": herr, "max_rel_err": hrel,
               "tol_rel": tol["bfloat16"]}
        record(row, lambda: mx.moe_gate_up_cuda(x, r, gate, up, "swiglu"),
               lambda: mx.moe_gate_up_torch(x, r, gate, up, "swiglu"),
               library_gate_up,
               x.numel() * 2 + w_bytes + kept * f * 2 + kept * 4,
               2 * 2 * kept * d * f)
        if (model, case) == ("granite", "decode T=4"):
            line["moe_gate_up_w4a16"] = row
        y_got = mx.moe_down_cuda(h_got, r, down)
        y_want = mx.moe_down_torch(h_got, r, down)
        yerr, yrel = max_errs(y_got[:kept], y_want[:kept])
        need(yrel <= tol["bfloat16"], f"moe_down {what}: rel {yrel:.3g}")

        def library_down():
            for ex, (o, n) in enumerate(zip(r.offsets.tolist(), counts)):
                if n:
                    h_got[o:o + n] @ dequantize(down[ex], bf16)
        row = {"kernel": "moe_down_w4a16", "case": what, "T": t,
               "kept": kept, "active_experts": active, "group": group,
               "max_abs_err": yerr, "max_rel_err": yrel,
               "tol_rel": tol["bfloat16"]}
        record(row, lambda: mx.moe_down_cuda(h_got, r, down),
               lambda: mx.moe_down_torch(h_got, r, down), library_down,
               kept * f * 2 + active * down.nbytes_model / e + kept * d * 2,
               2 * kept * f * d)
        if (model, case) == ("granite", "decode T=4"):
            line["moe_down_w4a16"] = row

        # -- the combine, on the kernel's y
        c_got = moe_combine_cuda(y_got, r.slot, r.topw)
        c_want = moe_combine_torch(y_got, r.slot, r.topw)
        need(torch.equal(c_got, c_want),
             f"moe_combine {what}: not bitwise the plain version")
        row = {"kernel": "moe_combine", "case": what, "T": t, "kept": kept,
               "max_abs_err": float((c_got.float() - c_want.float()).abs()
                                    .max())}
        record(row, lambda: moe_combine_cuda(y_got, r.slot, r.topw),
               lambda: moe_combine_torch(y_got, r.slot, r.topw), None,
               kept * d * 2 + t * k * 8 + t * d * 2, 2 * kept * d)
        if (model, case) == ("granite", "decode T=4"):
            line["moe_combine"] = row

        # -- the combine inside the next norm, against the chain it
        # replaced (the combine kernel, then add_rmsnorm's) and its plain
        # version, with and without the sum kept
        xr = randn(t, d)
        gamma = randn(d) * 0.1 + 1.0
        got_s, got_n = combine_add_rmsnorm_cuda(xr, y_got, r.slot, r.topw,
                                                gamma)
        want_s, want_n = add_rmsnorm_cuda(
            xr, moe_combine_cuda(y_got, r.slot, r.topw), gamma)
        none_s, none_n = combine_add_rmsnorm_cuda(xr, y_got, r.slot, r.topw,
                                                  gamma, keep_sum=False)
        p_s, p_n = combine_add_rmsnorm_torch(xr, y_got, r.slot, r.topw,
                                             gamma)
        torch.cuda.synchronize()
        need(torch.equal(got_s, want_s) and torch.equal(got_n, want_n)
             and none_s is None and torch.equal(none_n, want_n),
             f"combine_add_rmsnorm {what}: not bitwise moe_combine then "
             "add_rmsnorm")
        need(torch.equal(got_s, p_s) and torch.equal(got_n, p_n),
             f"combine_add_rmsnorm {what}: not bitwise its plain version")
        row = {"kernel": "combine_add_rmsnorm", "case": what, "T": t,
               "kept": kept, "d": d, "bitwise_chain": True,
               "bitwise_plain": True,
               "max_abs_err": float((got_n.float() - p_n.float()).abs()
                                    .max())}
        record(row, lambda: combine_add_rmsnorm_cuda(xr, y_got, r.slot,
                                                     r.topw, gamma),
               lambda: combine_add_rmsnorm_torch(xr, y_got, r.slot, r.topw,
                                                 gamma), None,
               kept * d * 2 + t * k * 8 + t * d * 2 * 3 + d * 2, 0,
               chain=lambda: add_rmsnorm_cuda(
                   xr, moe_combine_cuda(y_got, r.slot, r.topw), gamma))
        log("    bitwise moe_combine then add_rmsnorm (sum kept and not) "
            "and its plain version")
        if (model, case) == ("granite", "decode T=4"):
            line["combine_add_rmsnorm"] = row
        del h_got, h_want, y_got, y_want

        # -- a token's output alone and inside the chunk
        if case == "chunk 4x64":
            out, _ = moe_layer(torch, x, router, gate, up, down, k, cap, s)
            xd = x.reshape(b, s, d)[:, 5].contiguous()
            alone, _ = moe_layer(torch, xd, router, gate, up, down, k, k, 1)
            need(torch.equal(alone, out.reshape(b, s, d)[:, 5]),
                 f"moe {what}: a token's output alone (T=4) differs from "
                 "the same token inside the 4 x 64 chunk")
            log("    a token's layer output alone (T=4, four groups of one) "
                "bitwise equal inside the 4 x 64 chunk")
    weights.clear()
    torch.cuda.empty_cache()

    # -- kernels 1 and 2 alone at 32- and 64-row groups, granite's widths
    d, f = MOE_SHAPES["granite"][:2]
    for group in (32, 64):
        w1 = quantize(randn(f, d, dtype=torch.float32) * 0.03,
                      group_size=group)
        g2, u2 = (quantize(randn(d, f, dtype=torch.float32) * 0.03,
                           group_size=group) for _ in range(2))
        w16, g16, u16 = (dequantize(w, bf16) for w in (w1, g2, u2))
        for t in (4, 256):
            x1, x2 = randn(t, f), randn(t, d)
            got, want = w4a16_matmul_cuda(x1, w1), w4a16_matmul_torch(x1, w1)
            err, rel = max_errs(got, want)
            need(rel <= tol["bfloat16"], f"w4a16 g={group} T={t}: rel {rel}")
            row = {"kernel": "w4a16_matmul", "case": f"g={group} T={t} "
                   f"{f}->{d}", "T": t, "group": group, "max_abs_err": err,
                   "max_rel_err": rel}
            record(row, lambda: w4a16_matmul_cuda(x1, w1),
                   lambda: w4a16_matmul_torch(x1, w1),
                   lambda: x1 @ dequantize(w1, bf16),
                   x1.numel() * 2 + w1.nbytes_model + t * d * 2,
                   2 * t * f * d, library_once=lambda: x1 @ w16)
            got = ffn_gate_up_cuda(x2, g2, u2, "swiglu")
            want = ffn_gate_up_torch(x2, g2, u2, "swiglu")
            err, rel = max_errs(got, want)
            need(rel <= tol["bfloat16"], f"ffn g={group} T={t}: rel {rel}")
            row = {"kernel": "ffn_fused_w4a16", "case": f"g={group} T={t} "
                   f"{d}->2x{f}", "T": t, "group": group, "max_abs_err": err,
                   "max_rel_err": rel}
            record(row, lambda: ffn_gate_up_cuda(x2, g2, u2, "swiglu"),
                   lambda: ffn_gate_up_torch(x2, g2, u2, "swiglu"),
                   lambda: torch.nn.functional.silu(
                       x2 @ dequantize(g2, bf16)) * (x2 @ dequantize(u2,
                                                                     bf16)),
                   x2.numel() * 2 + g2.nbytes_model + u2.nbytes_model
                   + t * f * 2, 2 * 2 * t * d * f,
                   library_once=lambda: torch.nn.functional.silu(
                       x2 @ g16) * (x2 @ u16))
        check_tile_invariance(torch, lambda v: w4a16_matmul_cuda(v, w1),
                              randn(INVARIANCE_ROWS, f),
                              f"w4a16_matmul g={group} {f}x{d}")
        check_tile_invariance(
            torch, lambda v: ffn_gate_up_cuda(v, g2, u2, "swiglu"),
            randn(INVARIANCE_ROWS, d), f"ffn_fused_w4a16 g={group} gate/up")
        del w1, g2, u2, w16, g16, u16

    # -- the tied LM head: the (V, d) embedding read in place
    emb = randn(GRANITE_VOCAB, d) * 0.02
    for t in (4, 256):
        x = randn(t, d)
        got = ops.dense_matmul(x, emb.T)
        want = ops.dense_matmul(x, emb.T, impl="torch")
        err, rel = max_errs(got, want)
        need(rel <= tol["bfloat16"], f"tied head T={t}: rel {rel:.3g}")
        row = {"kernel": "dense_matmul", "case": f"tied head T={t} "
               f"{d}->{GRANITE_VOCAB}", "T": t, "max_abs_err": err,
               "max_rel_err": rel}
        record(row, lambda: ops.dense_matmul(x, emb.T),
               lambda: ops.dense_matmul(x, emb.T, impl="torch"),
               lambda: x @ emb.T, emb.numel() * 2 + x.numel() * 2
               + t * GRANITE_VOCAB * 2, 2 * t * d * GRANITE_VOCAB)
    # the same sums as the weight copied (in, out), at a width the copy
    # takes (out % 4 == 0), and rows alone inside every tile configuration
    w = emb[:GRANITE_VOCAB - 3]
    x = randn(64, d)
    need(torch.equal(ops.dense_matmul(x, w.T),
                     ops.dense_matmul(x, w.T.contiguous())),
         "tied head: the in-place read differs from the copied weight")
    check_tile_invariance(torch, lambda v: ops.dense_matmul(v, emb.T),
                          randn(INVARIANCE_ROWS, d), "tied head 1536x49155")
    del emb
    torch.cuda.empty_cache()
    return line


# -- the 16-bit path: dense_matmul, kernel 6, layernorm; kernel 2's gelu ------

def ffn_chain(torch, x, gate, up, down, activation, ub, db, stage=False):
    """The unfused chain of library calls on 16-bit weights: matmuls, the
    activation, the bias adds (timed, never used by the port); ``stage``
    stops at the hidden."""
    F = torch.nn.functional
    if activation == "gelu":
        h = F.gelu(torch.matmul(x, up) + ub, approximate="tanh")
    else:
        g = torch.matmul(x, gate)
        a = F.silu(g) if activation == "swiglu" else F.gelu(
            g, approximate="tanh")
        h = a * torch.matmul(x, up)
    if stage:
        return h
    out = torch.matmul(h, down)
    return out if db is None else out + db


# qwen-7b's d_model, d_ff, vocabulary and wk/wv width; starcoder2-7b's
# d_model and d_ff
QWEN_D, QWEN_F, QWEN_VOCAB, QWEN_KV = 4096, 11008, 151936, 512
STARCODER_D, STARCODER_F = 4608, 18432

# Cross-configuration invariance of the bf16 tensor-core tiles (the 16-bit
# ones and W4A16's): the launcher picks the tile by the token count, so
# rows 100-103 run alone (T=4) must be bitwise the same rows inside calls
# of each of these (start, T) windows; row 299 alone must be the last row
# of the T=300 call (a ragged last token tile) and row 299 of the T=1024
# call.
INVARIANCE_ROWS = 1024
INVARIANCE_WINDOWS = ((100, 17), (64, 64), (50, 100), (0, 256), (0, 300),
                      (0, 1024))


def check_tile_invariance(torch, fn, x, what) -> None:
    want = fn(x[100:104])
    for start, t in INVARIANCE_WINDOWS:
        got = fn(x[start:start + t])[100 - start:104 - start]
        need(torch.equal(got, want), f"{what}: rows 100-103 inside T={t} "
             f"(from row {start}) differ from the rows alone (T=4)")
    last = fn(x[299:300])
    for t in (300, 1024):
        need(torch.equal(fn(x[:t])[299:300], last),
             f"{what}: row 299 inside T={t} differs from the row alone")
    log(f"  {what}: rows 100-103 alone bitwise equal inside T=17, 64, 100, "
        "256, 300, 1024; row 299 (ragged last tile of T=300) alone equal too")


def check_dense_kernels(torch, timer, randn, tol, rows, results) -> dict:
    """The 16-bit serving path's kernels against their plain versions:
    ``dense_matmul`` at T=4, 256 and 1024 x 4096^2 and at qwen-7b's 16-bit
    lm_head and 512-wide wk/wv (T=4); kernel 6 gated at qwen-7b's FFN (4096 -> 11008 -> 4096; T=4,
    256, 1024) and ungated gelu with biases at starcoder2-7b's (4608 ->
    18432 -> 4608; T=4, 256); kernel 2's gelu variant at starcoder2-7b's
    widths; ``layernorm`` at 4 and 256 x 4608.  Each with its library call
    (``torch.matmul``, the unfused chain, ``F.layer_norm``) and the kernel
    / library factor, T=4 rows bitwise inside T=256, and for
    ``dense_matmul`` (4096^2, with and without the f32 bias) and kernel 6
    (hidden and whole FFN) the rows of ``check_tile_invariance`` bitwise
    across the token counts that pick each bf16 tile configuration.
    Recorded, not held: whether ``torch.matmul`` gives a row bitwise the
    same at T=1, 4 and 256 as at T=64 (the fault the fixed-order kernels
    rule out by construction)."""
    from repro_torch.core.quant import dequantize, quantize
    from repro_torch.kernels import ops
    from repro_torch.kernels.ffn_fused import (
        ffn_dense_gate_up_cuda, ffn_fused_dense_torch, ffn_gate_up_cuda,
        ffn_gate_up_torch)
    F = torch.nn.functional
    bf16, f32 = torch.bfloat16, torch.float32
    line = {}

    def timed(row, kernel, plain, library, nbytes, flops, dname, prefix=""):
        row[prefix + "ms"] = timer.ms(kernel, 20)
        row[prefix + "plain_ms"] = timer.ms(plain, 3)
        row[prefix + "library_ms"] = timer.ms(library, 10)
        b, by = bound(nbytes, flops, dname)
        row[prefix + "bound_ms"] = b
        row[prefix + "library_factor"] = (row[prefix + "ms"]
                                          / row[prefix + "library_ms"])
        if not prefix:
            row["bound_by"] = by

    def times(row, prefix=""):
        return (f"  kernel {row[prefix + 'ms']:.4f} ms plain "
                f"{row[prefix + 'plain_ms']:.4f} ms library "
                f"{row[prefix + 'library_ms']:.4f} ms bound "
                f"{row[prefix + 'bound_ms']:.4f} ms; kernel / library "
                f"{row[prefix + 'library_factor']:.2f}"
                if prefix + "ms" in row else "")

    # -- dense_matmul: T x 4096 -> 4096, the 4096 -> 151936 lm_head and the
    # 4096 -> 512 wk/wv
    d_in = QWEN_D
    for o, cases in ((QWEN_D, ((bf16, 4), (bf16, 256), (bf16, 1024),
                               (f32, 4))),
                     (QWEN_VOCAB, ((bf16, 4), (f32, 4))),
                     (QWEN_KV, ((bf16, 4),))):
        w32 = randn(d_in, o, dtype=f32) * 0.02
        ws = {bf16: w32.to(bf16), f32: w32}
        del w32
        for dtype, t in cases:
            dname = str(dtype).split(".")[1]
            w = ws[dtype]
            x = randn(t, d_in, dtype=dtype)
            got = ops.dense_matmul(x, w)
            err, rel = max_errs(got, ops.dense_matmul(x, w, impl="torch"))
            need(rel <= tol[dname], f"dense_matmul T={t} out={o} {dname}: "
                 f"rel err {rel:.3g} > {tol[dname]}")
            row = {"kernel": "dense_matmul", "dtype": dname, "T": t,
                   "in": d_in, "out": o, "max_abs_err": err,
                   "max_rel_err": rel, "tol_rel": tol[dname]}
            if dtype == bf16:
                timed(row, lambda: ops.dense_matmul(x, w),
                      lambda: ops.dense_matmul(x, w, impl="torch"),
                      lambda: torch.matmul(x, w),
                      (x.numel() + w.numel() + t * o) * 2,
                      2 * t * d_in * o, dname)
            rows.append(row)
            log(f"  dense_matmul {dname} T={t:3d} out={o:6d}: max_abs "
                f"{err:.3g} rel {rel:.3g} (tol {tol[dname]})" + times(row))
            if (t, o, dname) == (4, QWEN_D, "bfloat16"):
                line["dense_matmul"] = row
        w = ws[bf16]
        x = randn(256, d_in)
        need(torch.equal(ops.dense_matmul(x[:4], w),
                         ops.dense_matmul(x, w)[:4]),
             f"dense_matmul out={o}: rows differ between T=4 and T=256")
        if o == QWEN_D:
            bias = randn(o, dtype=f32) * 0.1
            xi = randn(INVARIANCE_ROWS, d_in)
            for b, what in ((None, ""), (bias, " with the f32 bias")):
                check_tile_invariance(
                    torch, lambda v, b=b: ops.dense_matmul(v, w, b), xi,
                    f"dense_matmul {d_in}x{o}{what}")
            del bias, xi
        # recorded: the library call's rows at T=1, 4 and 256 against T=64
        ref64 = torch.matmul(x[:64], w)
        lib = {}
        for n in (1, 4, 256):
            rows_n = torch.matmul(x[:n], w)[:64]
            k = min(n, 64)
            lib[f"T={n}"] = torch.equal(rows_n, ref64[:k])
            lib[f"T={n} max_abs_diff"] = float(
                (rows_n.float() - ref64[:k].float()).abs().max())
        results.setdefault("torch_matmul_rows_equal_at_T64", {})[
            f"bf16 {d_in}x{o}"] = lib
        log(f"  dense_matmul out={o}: T=4 rows bitwise equal inside T=256; "
            f"torch.matmul rows bitwise equal to T=64's (recorded): {lib}")
        del ws, w, x
        torch.cuda.empty_cache()

    # -- kernel 6 (16-bit weights): qwen-7b's gated FFN, starcoder2-7b's
    # ungated gelu with biases
    for case, (d, f, act) in (
            ("qwen-7b swiglu", (QWEN_D, QWEN_F, "swiglu")),
            ("starcoder2-7b gelu", (STARCODER_D, STARCODER_F, "gelu"))):
        gated = act != "gelu"
        w16 = {"gate": (randn(d, f) * 0.02) if gated else None,
               "up": randn(d, f) * 0.02, "down": randn(f, d) * 0.02,
               "ub": None if gated else randn(f) * 0.1,
               "db": None if gated else randn(d) * 0.1}
        for dtype, tokens in ((bf16, (4, 256, 1024) if gated else (4, 256)),
                              (f32, (4,))):
            dname = str(dtype).split(".")[1]
            wt = {k: None if v is None else v.to(dtype)
                  for k, v in w16.items()}
            gate, up, down, ub, db = (wt[k] for k in
                                      ("gate", "up", "down", "ub", "db"))
            kw = dict(activation=act, up_bias=ub, down_bias=db)
            for t in tokens:
                x = randn(t, d, dtype=dtype)
                herr, hrel = max_errs(
                    ffn_dense_gate_up_cuda(x, gate, up, act, ub),
                    ffn_gate_up_torch(x, gate, up, act, ub))
                err, rel = max_errs(
                    ops.ffn_w4a16(x, gate, up, down, **kw),
                    ffn_fused_dense_torch(x, gate, up, down, **kw))
                need(hrel <= tol[dname] and rel <= tol[dname],
                     f"ffn_fused_dense {case} T={t} {dname}: hidden rel "
                     f"{hrel:.3g}, out rel {rel:.3g} > {tol[dname]}")
                row = {"kernel": "ffn_fused_dense", "case": case,
                       "dtype": dname, "T": t, "d": d, "f": f,
                       "activation": act, "max_abs_err": herr,
                       "max_rel_err": hrel, "ffn_max_abs_err": err,
                       "ffn_max_rel_err": rel, "tol_rel": tol[dname]}
                if dtype == bf16:
                    nw = 2 if gated else 1
                    stage_bytes = (x.numel() + nw * d * f + t * f
                                   + (0 if gated else f)) * 2
                    timed(row,
                          lambda: ffn_dense_gate_up_cuda(x, gate, up, act,
                                                         ub),
                          lambda: ffn_gate_up_torch(x, gate, up, act, ub),
                          lambda: ffn_chain(torch, x, gate, up, down, act,
                                            ub, db, stage=True),
                          stage_bytes, 2 * nw * t * d * f, dname)
                    row["ffn_bytes"] = (x.numel() + (nw + 1) * d * f
                                        + t * d + (0 if gated else f + d)) * 2
                    timed(row, lambda: ops.ffn_w4a16(x, gate, up, down, **kw),
                          lambda: ffn_fused_dense_torch(x, gate, up, down,
                                                        **kw),
                          lambda: ffn_chain(torch, x, gate, up, down, act,
                                            ub, db),
                          row["ffn_bytes"], 2 * (nw + 1) * t * d * f, dname,
                          prefix="ffn_")
                rows.append(row)
                log(f"  ffn_fused_dense {case} {dname} T={t:3d}: hidden "
                    f"max_abs {herr:.3g} rel {hrel:.3g}; ffn max_abs "
                    f"{err:.3g} rel {rel:.3g} (tol {tol[dname]})"
                    + times(row) + ("; whole ffn" + times(row, "ffn_")
                                    if "ms" in row else ""))
                if (case, t, dname) == ("qwen-7b swiglu", 4, "bfloat16"):
                    line["ffn_fused_dense"] = row
            del wt, gate, up, down, ub, db
        x = randn(256, d)
        kw = dict(activation=act, up_bias=w16["ub"], down_bias=w16["db"])
        args = (w16["gate"], w16["up"], w16["down"])
        need(torch.equal(ops.ffn_w4a16(x[:4], *args, **kw),
                         ops.ffn_w4a16(x, *args, **kw)[:4]),
             f"ffn_fused_dense {case}: rows differ between T=4 and T=256")
        log(f"  ffn_fused_dense {case}: T=4 rows bitwise equal inside T=256")
        xi = randn(INVARIANCE_ROWS, d)
        check_tile_invariance(
            torch, lambda v: ffn_dense_gate_up_cuda(
                v, w16["gate"], w16["up"], act, w16["ub"]), xi,
            f"ffn_fused_dense {case} hidden")
        check_tile_invariance(torch, lambda v: ops.ffn_w4a16(v, *args, **kw),
                              xi, f"ffn_fused_dense {case} ffn")
        del w16, args, kw, xi
        torch.cuda.empty_cache()

    # -- kernel 2's gelu variant: starcoder2-7b's FFN, W4A16, with biases
    d, f = STARCODER_D, STARCODER_F
    up = quantize(randn(d, f, dtype=f32) * 0.02)
    down = quantize(randn(f, d, dtype=f32) * 0.02)
    b16 = (randn(f) * 0.1, randn(d) * 0.1)
    for dtype, tokens in ((bf16, (4, 256)), (f32, (4,))):
        dname = str(dtype).split(".")[1]
        ub, db = (b.to(dtype) for b in b16)
        kw = dict(activation="gelu", up_bias=ub, down_bias=db)
        for t in tokens:
            x = randn(t, d, dtype=dtype)
            herr, hrel = max_errs(ffn_gate_up_cuda(x, None, up, "gelu", ub),
                                  ffn_gate_up_torch(x, None, up, "gelu", ub))
            err, rel = max_errs(ops.ffn_w4a16(x, None, up, down, **kw),
                                ops.ffn_w4a16(x, None, up, down,
                                              impl="torch", **kw))
            need(hrel <= tol[dname] and rel <= tol[dname],
                 f"ffn_fused_w4a16_gelu T={t} {dname}: hidden rel "
                 f"{hrel:.3g}, out rel {rel:.3g} > {tol[dname]}")
            row = {"kernel": "ffn_fused_w4a16_gelu", "dtype": dname, "T": t,
                   "d": d, "f": f, "max_abs_err": herr, "max_rel_err": hrel,
                   "ffn_max_abs_err": err, "ffn_max_rel_err": rel,
                   "tol_rel": tol[dname]}
            if dtype == bf16:
                def lib(stage):
                    return lambda: ffn_chain(
                        torch, x, None, dequantize(up, bf16),
                        None if stage else dequantize(down, bf16), "gelu",
                        ub, db, stage=stage)
                timed(row, lambda: ffn_gate_up_cuda(x, None, up, "gelu", ub),
                      lambda: ffn_gate_up_torch(x, None, up, "gelu", ub),
                      lib(True),
                      x.numel() * 2 + up.nbytes_model + (t * f + f) * 2,
                      2 * t * d * f, dname)
                u16 = dequantize(up, bf16)
                row["library_bf16_ms"] = timer.ms(lambda: ffn_chain(
                    torch, x, None, u16, None, "gelu", ub, db, stage=True),
                    10)
                del u16
                row["ffn_bytes"] = (x.numel() * 2 + up.nbytes_model
                                    + down.nbytes_model + (t * d + f + d) * 2)
                timed(row, lambda: ops.ffn_w4a16(x, None, up, down, **kw),
                      lambda: ops.ffn_w4a16(x, None, up, down, impl="torch",
                                            **kw),
                      lib(False), row["ffn_bytes"], 2 * 2 * t * d * f, dname,
                      prefix="ffn_")
                u16, d16 = (dequantize(w, bf16) for w in (up, down))
                row["ffn_library_bf16_ms"] = timer.ms(lambda: ffn_chain(
                    torch, x, None, u16, d16, "gelu", ub, db), 10)
                del u16, d16
                log(f"  ffn_fused_w4a16_gelu T={t}: whole-FFN chain on "
                    f"weights dequantized once "
                    f"{row['ffn_library_bf16_ms']:.4f} ms")
            rows.append(row)
            log(f"  ffn_fused_w4a16_gelu {dname} T={t:3d}: hidden max_abs "
                f"{herr:.3g} rel {hrel:.3g}; ffn max_abs {err:.3g} rel "
                f"{rel:.3g} (tol {tol[dname]})" + times(row)
                + ("; whole ffn" + times(row, "ffn_") if "ms" in row else ""))
            if (t, dname) == (4, "bfloat16"):
                line["ffn_fused_w4a16_gelu"] = row
    x = randn(256, d)
    kw = dict(activation="gelu", up_bias=b16[0], down_bias=b16[1])
    need(torch.equal(ops.ffn_w4a16(x[:4], None, up, down, **kw),
                     ops.ffn_w4a16(x, None, up, down, **kw)[:4]),
         "ffn_fused_w4a16_gelu: rows differ between T=4 and T=256")
    log("  ffn_fused_w4a16_gelu: T=4 rows bitwise equal inside T=256")
    xi = randn(INVARIANCE_ROWS, d)
    check_tile_invariance(
        torch, lambda v: ffn_gate_up_cuda(v, None, up, "gelu", b16[0]), xi,
        "ffn_fused_w4a16_gelu up (gelu with the f32 bias)")
    del xi
    del up, down, b16
    torch.cuda.empty_cache()

    # -- layernorm: rows x 4608
    d = STARCODER_D
    gamma = 1 + 0.1 * randn(d, dtype=f32)
    beta = 0.1 * randn(d, dtype=f32)
    for dtype, tokens in ((bf16, (4, 256)), (f32, (4,))):
        dname = str(dtype).split(".")[1]
        g, b = gamma.to(dtype), beta.to(dtype)
        for t in tokens:
            x = randn(t, d, dtype=dtype) * 3 + 1
            err, rel = max_errs(ops.layernorm(x, g, b),
                                ops.layernorm(x, g, b, impl="torch"))
            need(rel <= tol[dname], f"layernorm rows={t} {dname}: rel "
                 f"{rel:.3g} > {tol[dname]}")
            row = {"kernel": "layernorm", "dtype": dname, "rows": t, "d": d,
                   "max_abs_err": err, "max_rel_err": rel,
                   "tol_rel": tol[dname]}
            if dtype == bf16:
                timed(row, lambda: ops.layernorm(x, g, b),
                      lambda: ops.layernorm(x, g, b, impl="torch"),
                      lambda: F.layer_norm(x, (d,), g, b, 1e-5),
                      (2 * x.numel() + 2 * d) * 2, 8 * x.numel(), dname)
            rows.append(row)
            log(f"  layernorm {dname} rows={t:3d}: max_abs {err:.3g} rel "
                f"{rel:.3g} (tol {tol[dname]})" + times(row))
            if (t, dname) == (4, "bfloat16"):
                line["layernorm"] = row
    x = randn(256, d)
    g, b = gamma.to(bf16), beta.to(bf16)
    need(torch.equal(ops.layernorm(x[:4], g, b), ops.layernorm(x, g, b)[:4]),
         "layernorm: rows differ between 4 and 256 rows")
    log("  layernorm: 4 rows bitwise equal inside 256")
    return line


# whisper-small's widths: d_model 768, d_ff 3072, vocab 51865; an audio
# request's 1500 frames
WHISPER_D, WHISPER_F, WHISPER_VOCAB, WHISPER_FRAMES = 768, 3072, 51865, 1500


def check_sinusoid_table(torch, rows) -> None:
    """whisper's position table built on the card (CUDA's ``exp``, ``sin``
    and ``cos``) against the same table built on the CPU, at the
    encoder's 1500 rows: row ``p`` within ``1e-6 + 2 p 2^-23`` (what a few
    ulps of a frequency make of ``p`` times it; the CPU tests hold the CPU
    table to the reference's by the same bound)."""
    import numpy as np
    from repro_torch.models.whisper import sinusoid_table
    n, d = WHISPER_FRAMES, WHISPER_D
    card = sinusoid_table(n, d, DEVICE).cpu().double()
    host = sinusoid_table(n, d, "cpu").double()
    err = (card - host).abs()
    limit = 1e-6 + 2 * torch.arange(n, dtype=torch.float64)[:, None] \
        * 2.0 ** -23
    worst = err.amax(1)
    row = {"kernel": "sinusoid_table", "model": "whisper-small",
           "rows": n, "d": d, "max_abs_err": float(err.max()),
           "worst_row": int(worst.argmax()),
           "bitwise_equal_share": float((err == 0).double().mean()),
           "rows_over_1e-6": int((worst > 1e-6).sum()),
           "tol": "1e-6 + 2 p 2^-23"}
    rows.append(row)
    log(f"  whisper sinusoid table {n} x {d}, card vs CPU: max_abs "
        f"{row['max_abs_err']:.3g} (row {row['worst_row']}), rows over 1e-6 "
        f"{row['rows_over_1e-6']}, bitwise equal "
        f"{row['bitwise_equal_share']:.4f} of entries (tol 1e-6 + 2 p "
        "2^-23)")
    need(bool((err <= limit).all()) and bool(np.isfinite(
        row["max_abs_err"])), "whisper sinusoid table: the card's table is "
         f"{row['max_abs_err']:.3g} from the CPU's, over 1e-6 + 2 p 2^-23")


def timed_row(timer, rows, tol, label, row, kernel, plain, library, nbytes,
              flops, what, library_once=None):
    """Time a bf16 kernel check's ``row``: the kernel, its plain version,
    its library call and, where given, ``library_once``, the library chain
    on weights dequantized once beforehand (no dequantization in the timed
    call); the bound of ``nbytes`` and ``flops``; append and log it."""
    row["ms"] = timer.ms(kernel, 20)
    row["plain_ms"] = timer.ms(plain, 3)
    row["library_ms"] = timer.ms(library, 10)
    if library_once is not None:
        row["library_once_ms"] = timer.ms(library_once, 10)
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, "bfloat16")
    rows.append(row)
    log(f"  {label} {what}: max_abs {row['max_abs_err']:.3g} rel "
        f"{row['max_rel_err']:.3g} (tol {tol['bfloat16']})  kernel "
        f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms library "
        f"{row['library_ms']:.4f} ms"
        + (f" (on weights dequantized once {row['library_once_ms']:.4f}"
           " ms)" if library_once is not None else "")
        + f" bound {row['bound_ms']:.4f} ms ({row['bound_by']})")


def check_w4a16_widths(torch, randn, tol, record, model, cases,
                       tokens) -> None:
    """Kernel 1 (bf16) against its plain version at ``model``'s widths,
    ``cases`` of (in, out, with an f32 bias), at each row count of
    ``tokens``; each timed by ``record`` beside ``F.linear`` on the weight
    dequantized in the call and on it dequantized once, and its bound."""
    from repro_torch.core.quant import dequantize, quantize
    from repro_torch.kernels.w4a16_matmul import (
        w4a16_matmul_cuda, w4a16_matmul_torch)
    F = torch.nn.functional
    bf16, f32 = torch.bfloat16, torch.float32
    for d_in, o, biased in cases:
        w = quantize(randn(d_in, o, dtype=f32) * 0.02)
        b = randn(o, dtype=f32) * 0.1 if biased else None
        w16, b16 = dequantize(w, bf16).T, None if b is None else b.to(bf16)
        for t in tokens:
            x = randn(t, d_in)
            err, rel = max_errs(w4a16_matmul_cuda(x, w, b),
                                w4a16_matmul_torch(x, w, b))
            need(rel <= tol["bfloat16"], f"{model} w4a16 T={t} {d_in}->{o}: "
                 f"rel err {rel:.3g}")
            row = {"kernel": "w4a16_matmul", "model": model,
                   "dtype": "bfloat16", "T": t, "in": d_in, "out": o,
                   "bias": biased, "max_abs_err": err, "max_rel_err": rel}
            record(row, lambda: w4a16_matmul_cuda(x, w, b),
                   lambda: w4a16_matmul_torch(x, w, b),
                   lambda: F.linear(x, dequantize(w, bf16).T,
                                    None if b is None else b.to(bf16)),
                   x.numel() * 2 + w.nbytes_model + t * o * 2
                   + (o * 4 if biased else 0), 2 * t * d_in * o,
                   f"w4a16_matmul T={t} {d_in}->{o}"
                   + (" with its bias" if biased else ""),
                   lambda: F.linear(x, w16, b16))
        del w, w16
        torch.cuda.empty_cache()


def check_whisper_kernels(torch, timer, randn, tol, rows) -> None:
    """The audio path's GEMM kernels at whisper-small's widths, bf16,
    against their plain versions, each timed beside its library call and
    its bound: kernel 1 at 768 -> 768 (q/k/v/o, self and cross; the cross
    K/V at the encoder's 1500 rows) and the down 3072 -> 768 with its f32
    bias, kernel 2g (768 -> 3072, gelu with the up bias) at T = 4 and
    1500, and ``dense_matmul`` on the tied head read in place (``embed.T``,
    768 -> 51865) at T = 4."""
    import functools
    from repro_torch.core.quant import dequantize, quantize
    from repro_torch.kernels import ops
    from repro_torch.kernels.ffn_fused import (
        ffn_gate_up_cuda, ffn_gate_up_torch)
    F = torch.nn.functional
    bf16, f32 = torch.bfloat16, torch.float32
    d, f, v = WHISPER_D, WHISPER_F, WHISPER_VOCAB
    record = functools.partial(timed_row, timer, rows, tol, "whisper")

    check_sinusoid_table(torch, rows)

    check_w4a16_widths(torch, randn, tol, record, "whisper-small",
                       ((d, d, False), (f, d, True)), (4, WHISPER_FRAMES))
    up = quantize(randn(d, f, dtype=f32) * 0.02)
    ub = (randn(f, dtype=f32) * 0.1).to(bf16)
    up16 = dequantize(up, bf16).T
    for t in (4, WHISPER_FRAMES):
        x = randn(t, d)
        err, rel = max_errs(ffn_gate_up_cuda(x, None, up, "gelu", ub),
                            ffn_gate_up_torch(x, None, up, "gelu", ub))
        need(rel <= tol["bfloat16"], f"whisper ffn_fused_w4a16_gelu T={t}: "
             f"rel err {rel:.3g}")
        row = {"kernel": "ffn_fused_w4a16_gelu", "model": "whisper-small",
               "dtype": "bfloat16", "T": t, "d": d, "f": f,
               "max_abs_err": err, "max_rel_err": rel}
        record(row, lambda: ffn_gate_up_cuda(x, None, up, "gelu", ub),
               lambda: ffn_gate_up_torch(x, None, up, "gelu", ub),
               lambda: F.gelu(F.linear(x, dequantize(up, bf16).T, ub),
                              approximate="tanh"),
               x.numel() * 2 + up.nbytes_model + (t * f + f) * 2,
               2 * t * d * f, f"ffn_fused_w4a16_gelu (up stage) T={t} "
               f"{d}->{f}",
               lambda: F.gelu(F.linear(x, up16, ub), approximate="tanh"))
    del up, up16
    embed = (randn(v, d, dtype=f32) * 0.02).to(bf16)
    x = randn(4, d)
    head = embed.T
    err, rel = max_errs(ops.dense_matmul(x, head),
                        ops.dense_matmul(x, head, impl="torch"))
    need(rel <= tol["bfloat16"], f"whisper tied head: rel err {rel:.3g}")
    row = {"kernel": "dense_matmul", "model": "whisper-small",
           "dtype": "bfloat16", "T": 4, "in": d, "out": v,
           "transposed_view": True, "max_abs_err": err, "max_rel_err": rel}
    record(row, lambda: ops.dense_matmul(x, head),
           lambda: ops.dense_matmul(x, head, impl="torch"),
           lambda: torch.matmul(x, head),
           x.numel() * 2 + embed.numel() * 2 + 4 * v * 2, 2 * 4 * d * v,
           f"dense_matmul tied head T=4 {d}->{v} (embed.T in place)")
    del embed, head
    torch.cuda.empty_cache()


# qwen2-vl-7b's widths: d_model, d_ff, vocab, query and KV heads of 128,
# M-RoPE theta and sections
QWEN2VL_D, QWEN2VL_F, QWEN2VL_VOCAB = 3584, 18944, 152064
QWEN2VL_HQ, QWEN2VL_HKV, QWEN2VL_THETA = 28, 4, 1e6
QWEN2VL_SECTIONS = (16, 24, 24)


def check_vlm_kernels(torch, timer, randn, tol, rows) -> None:
    """The vlm path's GEMM kernels at qwen2-vl-7b's widths, bf16, against
    their plain versions, each timed beside its library call (also on
    weights dequantized once) and its bound, at T = 4 (a decode tick) and
    64 (a mixed chunk): kernel 1 at wq / wo (3584 -> 3584), wk / wv (3584
    -> 512), the down (18944 -> 3584, 148 groups) and the lm_head (3584
    -> 152064), kernel 2's gate/up stage (3584 -> 2 x 18944, swiglu) with
    the whole FFN timed beside it; then the q/k/v epilogue on an M-RoPE
    config against the ``apply_mrope`` chain (``check_mrope_epilogue``)."""
    import functools
    from repro_torch.core.quant import dequantize, quantize
    from repro_torch.kernels import ops
    from repro_torch.kernels.ffn_fused import (
        ffn_gate_up_cuda, ffn_gate_up_torch)
    F = torch.nn.functional
    bf16, f32 = torch.bfloat16, torch.float32
    d, f, v = QWEN2VL_D, QWEN2VL_F, QWEN2VL_VOCAB
    kv = QWEN2VL_HKV * 128
    record = functools.partial(timed_row, timer, rows, tol, "qwen2-vl-7b")
    check_w4a16_widths(torch, randn, tol, record, "qwen2-vl-7b",
                       ((d, d, False), (d, kv, False), (f, d, False),
                        (d, v, False)), (4, 64))
    gate, up = (quantize(randn(d, f, dtype=f32) * 0.02) for _ in range(2))
    down = quantize(randn(f, d, dtype=f32) * 0.02)
    g16, u16, d16 = (dequantize(w, bf16).T for w in (gate, up, down))
    for t in (4, 64):
        x = randn(t, d)
        err, rel = max_errs(ffn_gate_up_cuda(x, gate, up, "swiglu"),
                            ffn_gate_up_torch(x, gate, up, "swiglu"))
        ferr, frel = max_errs(ops.ffn_w4a16(x, gate, up, down),
                              ops.ffn_w4a16(x, gate, up, down, impl="torch"))
        need(rel <= tol["bfloat16"] and frel <= tol["bfloat16"],
             f"qwen2-vl-7b ffn T={t}: hidden rel {rel:.3g}, out rel "
             f"{frel:.3g}")
        row = {"kernel": "ffn_fused_w4a16", "model": "qwen2-vl-7b",
               "dtype": "bfloat16", "T": t, "d": d, "f": f,
               "max_abs_err": err, "max_rel_err": rel,
               "ffn_max_abs_err": ferr, "ffn_max_rel_err": frel}
        record(row, lambda: ffn_gate_up_cuda(x, gate, up, "swiglu"),
               lambda: ffn_gate_up_torch(x, gate, up, "swiglu"),
               lambda: F.silu(F.linear(x, dequantize(gate, bf16).T))
               * F.linear(x, dequantize(up, bf16).T),
               x.numel() * 2 + gate.nbytes_model + up.nbytes_model
               + t * f * 2, 2 * 2 * t * d * f,
               f"ffn_fused_w4a16 (gate/up stage) T={t} {d}->2x{f}",
               lambda: F.silu(F.linear(x, g16)) * F.linear(x, u16))
        row["ffn_ms"] = timer.ms(lambda: ops.ffn_w4a16(x, gate, up, down), 20)
        row["ffn_bound_ms"], _ = bound(
            x.numel() * 4 + sum(w.nbytes_model for w in (gate, up, down)),
            3 * 2 * t * d * f, "bfloat16")
        row["ffn_library_ms"] = timer.ms(lambda: F.linear(
            F.silu(F.linear(x, dequantize(gate, bf16).T))
            * F.linear(x, dequantize(up, bf16).T),
            dequantize(down, bf16).T), 10)
        row["ffn_library_once_ms"] = timer.ms(lambda: F.linear(
            F.silu(F.linear(x, g16)) * F.linear(x, u16), d16), 10)
        log(f"    whole FFN (kernel 2, then kernel 1 for down) "
            f"{row['ffn_ms']:.4f} ms, bound {row['ffn_bound_ms']:.4f} ms, "
            f"library (dequantize + 3 F.linear + silu * up) "
            f"{row['ffn_library_ms']:.4f} ms, on weights dequantized once "
            f"{row['ffn_library_once_ms']:.4f} ms")
    del gate, up, down, g16, u16, d16
    torch.cuda.empty_cache()
    check_mrope_epilogue(torch, rows)


def check_mrope_epilogue(torch, rows) -> None:
    """The q/k/v epilogue as an M-RoPE config's served steps call it (the
    config's theta: a serving step's three id streams are equal, so the
    rotation is the standard one) bitwise against the chain the unfused
    route runs: the bias adds, ``apply_mrope`` at the step's (3, B, C)
    ids, ``quantize_kv`` and the ``kv_write`` kernel; q at every live
    position and every leaf, at qwen2-vl-7b's heads (28 over 4 of 128),
    slot and paged, bf16 and int8, decode and a 64-wide chunk."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.kv_write import quantize_kv
    from repro_torch.kernels.rope import apply_mrope
    g = torch.Generator(device="cuda").manual_seed(35)
    hq, hkv, hd = QWEN2VL_HQ, QWEN2VL_HKV, 128
    for layout in ("slot", "paged"):
        for quant in (False, True):
            for chunk in (1, 64):
                (cache, q, k, v, bias, rope_base, starts, q_lens,
                 table) = epilogue_case(torch, g, layout, quant, chunk, hq,
                                        hkv, hd=hd)
                want = {n: t.clone() for n, t in cache.items()}
                got_q = ops.qkv_rope_write(
                    cache, q, k, v, bias, n_heads=hq, theta=QWEN2VL_THETA,
                    rope_base=rope_base, starts=starts, q_lens=q_lens,
                    page_table=table)
                b = q.shape[0]
                pos = rope_base[:, None] + torch.arange(
                    chunk, dtype=torch.int32, device="cuda")[None]
                ids = pos[None].expand(3, b, chunk)

                def heads(t, bt, h):          # linear's bias add, split
                    return (t + bt).reshape(b, chunk, h, hd).transpose(1, 2)
                want_q = apply_mrope(heads(q, bias[0], hq), ids,
                                     QWEN2VL_THETA, QWEN2VL_SECTIONS)
                kk = apply_mrope(heads(k, bias[1], hkv), ids, QWEN2VL_THETA,
                                 QWEN2VL_SECTIONS)
                vv = heads(v, bias[2], hkv)
                new = {"k": kk, "v": vv}
                if quant:
                    (kq, ks), (vq, vs) = quantize_kv(kk), quantize_kv(vv)
                    new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
                ops.kv_write(want, new, starts, q_lens, page_table=table)
                torch.cuda.synchronize()
                what = (f"qkv_rope_write qwen2-vl-7b M-RoPE {layout} "
                        f"{'int8' if quant else 'bf16'} C={chunk}")
                need(all(bitwise(torch, got_q[r, :, :n], want_q[r, :, :n])
                         for r, n in enumerate(q_lens.tolist())),
                     f"{what}: q is not bitwise the apply_mrope chain's")
                for n in cache:
                    need(bitwise(torch, cache[n], want[n]),
                         f"{what}: leaf {n} is not bitwise the apply_mrope "
                         "chain's")
                rows.append({"kernel": "qkv_rope_write", "model":
                             "qwen2-vl-7b", "rope": "mrope", "layout": layout,
                             "kind": "int8" if quant else "bf16", "C": chunk,
                             "bitwise_apply_mrope_chain": True})
                log(f"  {what}: q and every leaf bitwise = the apply_mrope "
                    "chain at equal ids")


# zamba2-7b's widths: d_model, d_inner, SSM heads of P with state N, conv
# taps, in_proj's columns (z | xBC | dt)
ZAMBA_D, ZAMBA_DI, ZAMBA_H, ZAMBA_P, ZAMBA_N, ZAMBA_K = (3584, 7168, 112, 64,
                                                         64, 4)
ZAMBA_PROJ = 2 * ZAMBA_DI + 2 * ZAMBA_N + ZAMBA_H


def mamba_inputs(torch, randn, b):
    """A decode step's operands of the Mamba2 cell at zamba2-7b's widths:
    the in_proj row, a lived-in window and state, random A_log, D,
    dt_bias and conv taps."""
    f32 = torch.float32
    conv_dim = ZAMBA_DI + 2 * ZAMBA_N
    return dict(proj=randn(b, ZAMBA_PROJ),
                window=randn(b, ZAMBA_K - 1, conv_dim),
                conv_w=(randn(ZAMBA_K, conv_dim, dtype=f32) * 0.3).to(
                    torch.bfloat16),
                conv_b=(randn(conv_dim, dtype=f32) * 0.1).to(torch.bfloat16),
                A_log=randn(ZAMBA_H, dtype=f32) * 0.5,
                D=randn(ZAMBA_H, dtype=f32) * 0.3 + 1,
                dt_bias=randn(ZAMBA_H, dtype=f32) * 0.5,
                state=randn(b, ZAMBA_H, ZAMBA_N, ZAMBA_P, dtype=f32) * 0.5)


def mamba_call(ops, inp, impl="auto", active=None, copy=True):
    """The cell on ``inp`` (copied first unless ``copy`` is False): (y,
    window, state)."""
    t = {k: v.clone() for k, v in inp.items()} if copy else inp
    y = ops.mamba_cell(t["proj"], t["window"], t["conv_w"], t["conv_b"],
                       t["A_log"], t["D"], t["dt_bias"], t["state"],
                       n_state=ZAMBA_N, head_dim=ZAMBA_P, active=active,
                       impl=impl)
    return y, t["window"], t["state"]


def check_hybrid_kernels(torch, timer, randn, tol, rows) -> dict:
    """The hybrid path's kernels at zamba2-7b's widths, bf16, against their
    plain versions, each beside its bound, plain version and library call
    (or yardstick): kernel 1 at in_proj (3584 -> 14576: 113 whole 128-column
    blocks and a ragged one of 112) and out_proj (7168 -> 3584), T = 4 and
    256; the Mamba2 cell at B = 4 (y and the state within the bf16
    tolerance, the shifted window bitwise; an inactive row's window and
    state untouched; row 2 alone bitwise row 2 of the batch; no PyTorch
    call computes the step, so its yardstick is the plain chain); the gated
    norm at 4 x 7168 bitwise the chain (the rmsnorm kernel, ``F.silu``, the
    product), timed beside ``F.rms_norm`` then ``F.silu`` and the
    product."""
    from repro_torch.core.quant import dequantize, quantize
    from repro_torch.kernels import ops
    from repro_torch.kernels.w4a16_matmul import (
        w4a16_matmul_cuda, w4a16_matmul_torch)
    F = torch.nn.functional
    bf16, f32 = torch.bfloat16, torch.float32
    line = {}

    def record(row, kernel, plain, library, nbytes, flops, what,
               library_once=None):
        row["ms"] = timer.ms(kernel, 20)
        row["plain_ms"] = timer.ms(plain, 3)
        row["library_ms"] = (timer.ms(library, 10) if library is not None
                             else None)
        if library_once is not None:
            row["library_once_ms"] = timer.ms(library_once, 10)
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops, "bfloat16")
        rows.append(row)
        log(f"  zamba2 {what}: max_abs {row['max_abs_err']:.3g} rel "
            f"{row['max_rel_err']:.3g}  kernel {row['ms']:.4f} ms plain "
            f"{row['plain_ms']:.4f} ms "
            + (f"library {row['library_ms']:.4f} ms "
               if row["library_ms"] is not None else "(yardstick: plain) ")
            + (f"(on the weight dequantized once "
               f"{row['library_once_ms']:.4f} ms) "
               if library_once is not None else "")
            + f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")

    for d_in, o, name in ((ZAMBA_D, ZAMBA_PROJ, "in_proj"),
                          (ZAMBA_DI, ZAMBA_D, "out_proj")):
        w = quantize(randn(d_in, o, dtype=f32) * 0.02)
        w16 = dequantize(w, bf16)
        for t in (4, 256):
            x = randn(t, d_in)
            err, rel = max_errs(w4a16_matmul_cuda(x, w),
                                w4a16_matmul_torch(x, w))
            need(rel <= tol["bfloat16"], f"zamba2 w4a16 {name} T={t}: rel "
                 f"err {rel:.3g}")
            row = {"kernel": "w4a16_matmul", "model": "zamba2-7b",
                   "weight": name, "dtype": "bfloat16", "T": t, "in": d_in,
                   "out": o, "max_abs_err": err, "max_rel_err": rel}
            record(row, lambda: w4a16_matmul_cuda(x, w),
                   lambda: w4a16_matmul_torch(x, w),
                   lambda: x @ dequantize(w, bf16),
                   x.numel() * 2 + w.nbytes_model + t * o * 2,
                   2 * t * d_in * o, f"w4a16_matmul {name} T={t} "
                   f"{d_in}->{o}", lambda: x @ w16)
        need(torch.equal(w4a16_matmul_cuda(x[:4], w),
                         w4a16_matmul_cuda(x, w)[:4]),
             f"zamba2 w4a16 {name}: rows differ between 4 and 256 rows")
        del w, w16
    # the Mamba2 cell
    b = 4
    inp = mamba_inputs(torch, randn, b)
    active = torch.tensor([True, True, True, False], device="cuda")
    y, win, st = mamba_call(ops, inp, active=active)
    yw, winw, stw = mamba_call(ops, inp, impl="torch", active=active)
    err, rel = max_errs(y, yw)
    s_err, s_rel = max_errs(st, stw)
    need(rel <= tol["bfloat16"] and s_rel <= tol["bfloat16"],
         f"mamba_cell: y rel {rel:.3g}, state rel {s_rel:.3g} > "
         f"{tol['bfloat16']}")
    need(torch.equal(win, winw), "mamba_cell: the shifted window is not "
         "bitwise its plain version's")
    need(torch.equal(win[3], inp["window"][3])
         and torch.equal(st[3], inp["state"][3]),
         "mamba_cell: an inactive row's window or state changed")
    one = {k: (v[2:3].contiguous() if k in ("proj", "window", "state")
               else v) for k, v in inp.items()}
    y2, win2, st2 = mamba_call(ops, one)
    need(torch.equal(y2[0], y[2]) and torch.equal(st2[0], st[2])
         and torch.equal(win2[0], win[2]),
         "mamba_cell: row 2 alone differs from row 2 of B = 4")
    conv_dim = ZAMBA_DI + 2 * ZAMBA_N
    state_bytes = b * ZAMBA_H * ZAMBA_N * ZAMBA_P * 4
    nbytes = (2 * state_bytes + b * (conv_dim + ZAMBA_H) * 2
              + 2 * b * (ZAMBA_K - 1) * conv_dim * 2
              + (ZAMBA_K + 1) * conv_dim * 2 + 3 * ZAMBA_H * 4
              + b * ZAMBA_DI * 2)
    # per (row, head, n, p): the update's 2 products and add, C's product
    # and add; the conv's K products and adds a channel
    flops = b * ZAMBA_H * ZAMBA_N * ZAMBA_P * 5 + b * conv_dim * 2 * ZAMBA_K
    row = {"kernel": "mamba_cell", "model": "zamba2-7b", "dtype": "bfloat16",
           "B": b, "heads": ZAMBA_H, "P": ZAMBA_P, "N": ZAMBA_N,
           "max_abs_err": err, "max_rel_err": rel, "state_max_abs_err": s_err,
           "state_max_rel_err": s_rel, "tol_rel": tol["bfloat16"],
           "inactive_row_untouched": True, "row_alone_bitwise": True}
    work = {k: v.clone() for k, v in inp.items()}
    record(row, lambda: mamba_call(ops, work, copy=False),
           lambda: mamba_call(ops, work, impl="torch", copy=False), None,
           nbytes, flops, f"mamba_cell B={b} {ZAMBA_H} heads of "
           f"{ZAMBA_N} x {ZAMBA_P}")
    line["mamba_cell"] = row
    del inp, work, one
    # the gated norm: z is the in_proj row's first d_inner columns
    proj = randn(b, ZAMBA_PROJ) * 2
    z = proj[:, :ZAMBA_DI]
    yv = randn(b, ZAMBA_DI)
    gamma = (1 + 0.1 * randn(ZAMBA_DI, dtype=f32)).to(bf16)
    got = ops.rmsnorm_gated(yv, gamma, z)
    want = ops.rmsnorm_gated(yv, gamma, z, impl="torch")
    err, rel = max_errs(got, want)
    need(bitwise(torch, got, want), "rmsnorm_gated is not bitwise the "
         "rmsnorm kernel, F.silu and the product")
    need(torch.equal(ops.rmsnorm_gated(yv[2:3], gamma, z[2:3]), got[2:3]),
         "rmsnorm_gated: row 2 alone differs from row 2 of B = 4")
    row = {"kernel": "rmsnorm_gated", "model": "zamba2-7b",
           "dtype": "bfloat16", "rows": b, "d": ZAMBA_DI,
           "max_abs_err": err, "max_rel_err": rel, "bitwise_chain": True}
    lib = getattr(F, "rms_norm", None)
    record(row, lambda: ops.rmsnorm_gated(yv, gamma, z),
           lambda: ops.rmsnorm_gated(yv, gamma, z, impl="torch"),
           (lambda: lib(yv, (ZAMBA_DI,), gamma, 1e-6) * F.silu(z))
           if lib is not None else None,
           3 * b * ZAMBA_DI * 2 + ZAMBA_DI * 2, 8 * b * ZAMBA_DI,
           f"rmsnorm_gated {b} x {ZAMBA_DI}")
    line["rmsnorm_gated"] = row
    del proj, z, yv
    line["mamba_cell_gated"] = check_mamba_cell_gated(torch, timer, randn,
                                                      tol, record)
    torch.cuda.empty_cache()
    return line


def gated_call(ops, inp, gamma, impl="auto", active=None, copy=True,
               chain=False):
    """The fused step on ``inp`` (copied first unless ``copy`` is False),
    or (``chain``) the two kernels it replaced, ``mamba_cell`` then
    ``rmsnorm_gated``: (gated row, window, state)."""
    t = {k: v.clone() for k, v in inp.items()} if copy else inp
    args = (t["proj"], t["window"], t["conv_w"], t["conv_b"], t["A_log"],
            t["D"], t["dt_bias"], t["state"], gamma)
    kw = dict(n_state=ZAMBA_N, head_dim=ZAMBA_P, active=active)
    out = (chain_mamba_cell_gated(*args, **kw) if chain else
           ops.mamba_cell_gated(*args, impl=impl, **kw))
    return out, t["window"], t["state"]


def check_mamba_cell_gated(torch, timer, randn, tol, record) -> dict:
    """The served Mamba2 step (``mamba_cell_gated``: the cell and the gated
    norm in one launch) at zamba2-7b's widths, B = 4, bf16, with an
    inactive row (its window and state untouched) and without: against its
    plain version on the same inputs (the cell's plain chain, then the
    rmsnorm kernel, ``F.silu`` and the product), the gated row and the
    state within the bf16 tolerance, the shifted window bitwise; and
    bitwise the two kernels it replaced (the gated row, the window, the
    state); row 2 alone bitwise row 2 of the batch; one launch a call.
    Timed beside that plain version and the pair it replaced (``pair_ms``,
    the yardstick; no PyTorch call computes the step)."""
    from repro_torch.kernels import _build, ops
    bf16, f32 = torch.bfloat16, torch.float32
    b = 4
    inp = mamba_inputs(torch, randn, b)
    gamma = (1 + 0.1 * randn(ZAMBA_DI, dtype=f32)).to(bf16)
    err = rel = s_err = s_rel = 0.0
    for active in (torch.tensor([True, True, True, False], device="cuda"),
                   None):
        n0 = _build.launches["mamba_cell_gated"]
        got, win, st = gated_call(ops, inp, gamma, active=active)
        need(_build.launches["mamba_cell_gated"] == n0 + 1,
             "mamba_cell_gated: not one launch a call")
        plain, winp, stp = gated_call(ops, inp, gamma, impl="torch",
                                      active=active)
        e, r = max_errs(got, plain)
        se, sr = max_errs(st, stp)
        need(r <= tol["bfloat16"] and sr <= tol["bfloat16"],
             f"mamba_cell_gated: gated row rel {r:.3g}, state rel {sr:.3g} "
             f"> {tol['bfloat16']} against its plain version (active "
             f"{active is not None})")
        need(torch.equal(win, winp), "mamba_cell_gated: the shifted window "
             "is not bitwise its plain version's")
        err, rel = max(err, e), max(rel, r)
        s_err, s_rel = max(s_err, se), max(s_rel, sr)
        want, winw, stw = gated_call(ops, inp, gamma, active=active,
                                     chain=True)
        need(bitwise(torch, got, want) and bitwise(torch, win, winw)
             and bitwise(torch, st, stw),
             "mamba_cell_gated is not bitwise mamba_cell then rmsnorm_gated "
             f"(active {active is not None})")
        need(active is None or (torch.equal(win[3], inp["window"][3])
                                and torch.equal(st[3], inp["state"][3])),
             "mamba_cell_gated: an inactive row's window or state changed")
    one = {k: (v[2:3].contiguous() if k in ("proj", "window", "state")
               else v) for k, v in inp.items()}
    got2, win2, st2 = gated_call(ops, one, gamma)
    need(torch.equal(got2[0], got[2]) and torch.equal(st2[0], st[2])
         and torch.equal(win2[0], win[2]),
         "mamba_cell_gated: row 2 alone differs from row 2 of B = 4")
    conv_dim = ZAMBA_DI + 2 * ZAMBA_N
    state_bytes = b * ZAMBA_H * ZAMBA_N * ZAMBA_P * 4
    # the state read and written, the in_proj row (z, xBC, dt) read, the
    # window read and written, the weights (conv taps and bias, A_log, D,
    # dt_bias, gamma) read, the gated row written
    nbytes = (2 * state_bytes + b * ZAMBA_PROJ * 2
              + 2 * b * (ZAMBA_K - 1) * conv_dim * 2
              + (ZAMBA_K + 1) * conv_dim * 2 + 3 * ZAMBA_H * 4
              + ZAMBA_DI * 2 + b * ZAMBA_DI * 2)
    flops = (b * ZAMBA_H * ZAMBA_N * ZAMBA_P * 5
             + b * conv_dim * 2 * ZAMBA_K + 8 * b * ZAMBA_DI)
    row = {"kernel": "mamba_cell_gated", "model": "zamba2-7b",
           "dtype": "bfloat16", "B": b, "heads": ZAMBA_H, "P": ZAMBA_P,
           "N": ZAMBA_N, "d": ZAMBA_DI, "max_abs_err": err,
           "max_rel_err": rel, "state_max_abs_err": s_err,
           "state_max_rel_err": s_rel, "tol_rel": tol["bfloat16"],
           "window_bitwise_plain": True, "bitwise_pair": True,
           "inactive_row_untouched": True, "row_alone_bitwise": True}
    work = {k: v.clone() for k, v in inp.items()}
    row["pair_ms"] = timer.ms(
        lambda: gated_call(ops, work, gamma, copy=False, chain=True), 20)
    record(row, lambda: gated_call(ops, work, gamma, copy=False),
           lambda: gated_call(ops, work, gamma, impl="torch", copy=False),
           None, nbytes, flops, f"mamba_cell_gated B={b} {ZAMBA_H} heads "
           f"of {ZAMBA_N} x {ZAMBA_P}, one launch")
    log(f"    the pair it replaced (mamba_cell, rmsnorm_gated): "
        f"{row['pair_ms']:.4f} ms")
    return row


# -- phase 4 and 5: the model and the engine --------------------------------

def build_model(torch, arch, strategy, **overrides):
    from repro_torch.configs import get_config
    from repro_torch.core.compiler import quantize_model, quantized_bytes
    from repro_torch.models import api
    cfg = get_config(arch, **overrides)
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = quantize_model(api.init_params(cfg, gen), strategy)
    torch.cuda.synchronize()
    if cfg.family == "ssm":
        kinds = {f"{g}.{k}": type(v).__name__ for g in ("mlstm_main", "slstm")
                 for k, v in params[g].items()
                 if k in ("up_x", "wq", "w_i", "down", "w_gates", "r_gates")}
        shape = f"sLSTM every {cfg.slstm_every}"
    elif cfg.family == "hybrid":
        mam, sh = params["mamba_main"]["mamba"], params["shared"]
        kinds = {f"{g}.{k}": type(v).__name__ for g, grp in (
            ("mamba", mam), ("attn", sh["attn"]), ("mlp", sh["mlp"]))
            for k, v in grp.items()
            if k in ("in_proj", "out_proj", "conv_w", "wq", "wo", "gate",
                     "down")}
        shape = (f"d_inner={cfg.d_inner} ({cfg.ssm_heads} SSM heads of "
                 f"{cfg.ssm_head_dim}, state {cfg.ssm_state}), a shared "
                 f"block every {cfg.shared_attn_every} layers (of "
                 f"{cfg.n_shared_blocks}), head dim {cfg.head_dim}, "
                 f"d_ff={cfg.d_ff}")
    elif cfg.family == "audio":
        dec = params["dec_blocks"]
        kinds = {f"{g}.{k}": type(v).__name__ for g in ("self_attn",
                                                        "cross_attn", "mlp")
                 for k, v in dec[g].items() if k in ("wq", "wk", "wo", "up",
                                                     "down")}
        kinds["embed"] = type(params["embed"]).__name__
        shape = (f"d_ff={cfg.d_ff}, encoder {cfg.n_encoder_layers} layers "
                 f"over {cfg.encoder_frames} frames")
    else:
        ffn = params["blocks"]["moe" if cfg.is_moe else "mlp"]
        kinds = {k: type(v).__name__ + (f"(g={v.group_size})"
                                        if hasattr(v, "group_size") else "")
                 for k, v in {**params["blocks"]["attn"], **ffn}.items()
                 if k in ("wq", "wo", "gate", "up", "down", "router")}
        shape = f"d_ff={cfg.d_ff}" + (
            f" experts={cfg.n_experts} top-{cfg.top_k} capacity factor "
            f"{cfg.moe_capacity_factor}" if cfg.is_moe else "")
    log(f"  {arch} {strategy}: {cfg.n_layers} layers d={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} {shape} "
        f"vocab={cfg.vocab_size}; {kinds}; packed params "
        f"{quantized_bytes(params) / 1e9:.3f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


def audio_frames(cfg, n, seed=0):
    """``n`` requests' audio frames, (F, d) float32 each, drawn in turn
    from ``default_rng(seed)``'s normal."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(cfg.encoder_frames, cfg.d_model)).astype(
        np.float32) for _ in range(n)]


def fresh_cache(torch, cfg, params, b, max_len):
    """``api.init_cache``; on an audio config its rows then hold the cross
    K/V of seeded frames (``api.admit_into``), as admitted requests'
    do."""
    import numpy as np
    from repro_torch.models import api
    cache = api.init_cache(cfg, b, max_len, DEVICE)
    if cfg.family == "audio":
        frames = torch.from_numpy(np.stack(audio_frames(cfg, b, seed=7)))
        api.admit_into(cfg, params, cache, {"frames": frames.to(DEVICE)})
    return cache


def start_cache(torch, cfg, params, max_len, frames=None):
    """The batch-1 cache a request's sequential decode starts from:
    ``api.request_cache`` of its audio ``frames`` (F, d), else a pristine
    ``api.init_cache``."""
    from repro_torch.models import api
    if frames is None:
        return api.init_cache(cfg, 1, max_len, DEVICE)
    return api.request_cache(
        cfg, params, {"frames": torch.from_numpy(frames[None]).to(DEVICE)},
        max_len, DEVICE)


def scrambled_table(torch, cfg, rng, b, max_len):
    """A (B, pages) page table of distinct pool blocks in ``rng``'s
    order, for a paged cache of ``max_len`` a row."""
    from repro_torch.models import api
    leaves = api.init_cache(cfg, b, max_len, DEVICE)
    pool = leaves.get("self", leaves.get("kv", leaves))["k"].shape[1] - 1
    del leaves
    pages = -(-max_len // cfg.kv_block_size)
    return torch.tensor(rng.permutation(pool)[:b * pages].reshape(b, pages),
                        dtype=torch.int32, device=DEVICE)


def cache_leaves(cache, prefix=""):
    """(name, tensor) of every cache leaf, nested groups joined by '/'."""
    for k in sorted(cache):
        if isinstance(cache[k], dict):
            yield from cache_leaves(cache[k], f"{prefix}{k}/")
        else:
            yield prefix + k, cache[k]


def differing_slices(torch, a, b):
    """Names of the leading-axis slices (layers, segments) where two caches
    differ, e.g. ``k[3]`` or ``mlstm_main/C[2]``."""
    out = []
    for (name, x), (_, y) in zip(cache_leaves(a), cache_leaves(b)):
        out += [f"{name}[{i}]" for i in range(x.shape[0])
                if not torch.equal(x[i], y[i])]
    return out


def check_mixed_equals_sequential(torch, cfg, params, results, path):
    import numpy as np
    from repro_torch.models import api
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 13)
    dev = DEVICE
    seq = fresh_cache(torch, cfg, params, 1, 32)
    logits_seq = None
    for t, tok in enumerate(prompt.tolist()):
        logits_seq, seq = api.decode_step(
            cfg, params, seq, torch.tensor([[tok]], device=dev), [t + 1])
    mix = fresh_cache(torch, cfg, params, 1, 32)
    length = 0
    while length < len(prompt):
        ql = min(8, len(prompt) - length)
        chunk = np.zeros(8, np.int64)
        chunk[:ql] = prompt[length:length + ql]
        logits_mix, mix = api.mixed_step(
            cfg, params, mix, torch.tensor(chunk[None], device=dev),
            [length], [ql])
        length += ql
    same_logits = torch.equal(logits_seq, logits_mix)
    diff = differing_slices(torch, seq, mix)
    results.setdefault("mixed_vs_sequential", {})[path] = {
        "logits_equal": same_logits, "cache_slices_differing": diff,
        "logits_max_abs_diff": float((logits_seq.float()
                                      - logits_mix.float()).abs().max())}
    log(f"  mixed_step (C=8) vs 13 decode_steps: logits bitwise equal "
        f"{same_logits}; cache slices differing {diff} (leaves "
        f"{[n for n, _ in cache_leaves(seq)]})")
    need(same_logits and not diff,
         f"{path}: mixed_step is not bitwise equal to sequential "
         f"decode_step (first differing cache slice: {diff[:1]})")


def check_all_logits(torch, cfg, params, results, path):
    """(b) The verify surface: B = 4 rows at lengths 0, 5, 13 and 29
    (paged: a scrambled page table) take ``mixed_step(all_logits=True)``
    at W = 4 and then W = 8 with ragged ``q_lens`` and a dead row; every
    live position's logits are bitwise those of the sequential
    ``decode_step`` at that position (rows advancing under a write mask),
    and every cache leaf of all layers is bitwise the sequential cache's.
    This holds kernel 1 (lm_head at T = B·W = 16 and 32 rows and the
    projections), the FFN kernels and kernel 3 / ``kv_write`` at C = 4
    and 8 to a row's fixed reduction order."""
    import numpy as np
    from repro_torch.models import api
    b, max_len = 4, 64
    rng = np.random.default_rng(5)
    lens = np.asarray([0, 5, 13, 29], np.int32)
    kw = {}
    if api.has_paged_kv(cfg):
        kw["page_table"] = scrambled_table(torch, cfg, rng, b, max_len)
    mix = fresh_cache(torch, cfg, params, b, max_len)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (b, 32)),
                        device=DEVICE)
    api.mixed_step(cfg, params, mix, toks, [0] * b, lens, **kw)
    seq = clone_tree(mix)
    out = {}
    for w, q_lens in ((4, [4, 0, 3, 4]), (8, [8, 5, 0, 8])):
        q_lens = np.asarray(q_lens, np.int32)
        toks = torch.tensor(rng.integers(0, cfg.vocab_size, (b, w)),
                            device=DEVICE)
        logits, _ = api.mixed_step(cfg, params, mix, toks, lens, q_lens,
                                   all_logits=True, **kw)
        differ = []
        for j in range(w):
            step, _ = api.decode_step(
                cfg, params, seq, toks[:, j:j + 1],
                lens + np.minimum(j, q_lens - 1) + 1,
                write_mask=torch.tensor(j < q_lens, device=DEVICE), **kw)
            differ += [(int(r), j) for r in np.flatnonzero(j < q_lens)
                       if not torch.equal(logits[r, j], step[r])]
        diff = differing_slices(torch, seq, mix)
        out[f"W={w}"] = {"positions_differing": differ,
                         "cache_slices_differing": diff}
        log(f"  (b) all_logits W={w} (T={b * w} lm_head rows), q_lens "
            f"{q_lens.tolist()} at lengths {lens.tolist()}: positions "
            f"differing from sequential decode {differ}; cache slices "
            f"differing {diff}")
        need(not differ and not diff,
             f"{path}: mixed_step(all_logits=True) at W={w} is not bitwise "
             f"sequential decode (positions {differ[:3]}, cache {diff[:1]})")
        lens = lens + q_lens
    results.setdefault("all_logits_vs_sequential", {})[path] = out


FUSED_OPS = ("add_rmsnorm", "add_layernorm", "qkv_rope_write",
             "moe_router_route", "combine_add_rmsnorm", "rmsnorm_gated",
             "mamba_cell_gated")


def chain_router_route(x, router, group, top_k, capacity, q_lens=None):
    """The chain the fused route replaced, on the card: the
    ``dense_matmul`` kernel, then the route kernel on its logits."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_route import moe_route_cuda
    logits = ops.dense_matmul(x, router)
    return logits, moe_route_cuda(logits, group, top_k, capacity, q_lens)


def chain_mamba_cell_gated(proj, window, conv_w, conv_b, A_log, D, dt_bias,
                           state, gamma, *, n_state, head_dim, active=None,
                           eps=1e-6):
    """The chain ``mamba_cell_gated`` replaced, on the card: the cell
    kernel, then ``ops.rmsnorm_gated`` (its kernel; inside ``plain_glue``
    its chain: the rmsnorm kernel, ``F.silu``, the product)."""
    from repro_torch.kernels import ops
    y = ops.mamba_cell(proj, window, conv_w, conv_b, A_log, D, dt_bias,
                       state, n_state=n_state, head_dim=head_dim,
                       active=active)
    return ops.rmsnorm_gated(y, gamma, proj[:, :y.shape[1]], eps)


def chain_combine_add_rmsnorm(x, y, slot, topw, gamma, eps=1e-6,
                              keep_sum=True):
    """The chain ``combine_add_rmsnorm`` replaced, on the card: the
    combine kernel, then ``x + m`` and the rmsnorm kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rmsnorm import add_rmsnorm_torch
    k = slot.shape[-1]
    m = ops.moe_combine(y, slot.reshape(-1, k), topw.reshape(-1, k))
    return add_rmsnorm_torch(x, m.reshape(x.shape), gamma, eps, keep_sum)


@contextlib.contextmanager
def plain_glue():
    """Inside the block the fused ops (``FUSED_OPS``) run their plain
    chains on the card, the chains the serving steps ran before them (whose
    norm and write are the rmsnorm, layernorm and ``kv_write`` kernels, a
    ``qk_norm`` config's q/k norms the rmsnorm kernel too; an
    MoE layer's router ``dense_matmul`` and route, and its combine, are
    their kernels; the gated norm is the rmsnorm kernel, ``F.silu`` and
    the product; the fused Mamba2 step is the cell kernel and that gated
    chain); every other op keeps its kernel."""
    import functools
    from repro_torch.kernels import kv_write as kvw
    from repro_torch.kernels import layernorm as ln
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms
    saved = (ops.add_rmsnorm_cuda, ops.add_layernorm_cuda,
             ops.qkv_rope_write_cuda, ops.moe_router_route_cuda,
             ops.combine_add_rmsnorm_cuda, ops.rmsnorm_gated_cuda,
             ops.mamba_cell_gated_cuda)
    ops.add_rmsnorm_cuda = rms.add_rmsnorm_torch
    ops.rmsnorm_gated_cuda = rms.rmsnorm_gated_torch
    ops.mamba_cell_gated_cuda = chain_mamba_cell_gated
    ops.add_layernorm_cuda = ln.add_layernorm_torch
    ops.qkv_rope_write_cuda = functools.partial(kvw.qkv_rope_write_torch,
                                                write=ops.kv_write,
                                                norm=rms.rmsnorm)
    ops.moe_router_route_cuda = chain_router_route
    ops.combine_add_rmsnorm_cuda = chain_combine_add_rmsnorm
    try:
        yield
    finally:
        (ops.add_rmsnorm_cuda, ops.add_layernorm_cuda,
         ops.qkv_rope_write_cuda, ops.moe_router_route_cuda,
         ops.combine_add_rmsnorm_cuda, ops.rmsnorm_gated_cuda,
         ops.mamba_cell_gated_cuda) = saved


def check_fused_equals_plain(torch, cfg, params, results, path):
    """One mixed step (W = 64: a 64-token chunk, a dead row, a decode row,
    a ragged row; paged: a scrambled page table) and then one decode step
    (a masked row) through the fused kernels (``FUSED_OPS``) against the
    same steps through those ops' plain chains (``plain_glue``), from
    the same cache: logits and every cache leaf of all layers bitwise
    equal.  Then 20 decode steps of one row through a 16-token span under
    a window as long (a rolling buffer: positions run past the span, and
    past the epilogue's RoPE table, so the step keeps the unfused chain
    for q/k/v), logits at every step and every leaf bitwise equal."""
    import numpy as np
    from repro_torch.models import api
    b, w, max_len = 4, 64, 80           # paged: 5 pages a row, 20 blocks
    rng = np.random.default_rng(24)
    lengths = np.asarray([0, 3, 40, 60], np.int32)
    q_lens = np.asarray([64, 0, 17, 1], np.int32)
    kw = {}
    if api.has_paged_kv(cfg):
        kw["page_table"] = scrambled_table(torch, cfg, rng, b, max_len)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (b, w)),
                        device=DEVICE)
    fused = fresh_cache(torch, cfg, params, b, max_len)
    plain = clone_tree(fused)
    mask = torch.tensor([True, False, True, True], device=DEVICE)
    out = {}
    for name, step in (
            ("mixed-64", lambda c: api.mixed_step(
                cfg, params, c, toks, lengths, q_lens, **kw)[0]),
            ("decode", lambda c: api.decode_step(
                cfg, params, c, toks[:, :1], lengths + q_lens + 1,
                write_mask=mask, **kw)[0])):
        got = step(fused)
        with plain_glue():
            want = step(plain)
        torch.cuda.synchronize()
        same = bitwise(torch, got, want)
        diff = differing_slices(torch, fused, plain)
        out[name] = {"logits_bitwise": same, "cache_slices_differing": diff}
        log(f"  fused {'/'.join(FUSED_OPS)} vs their plain chains, {name}: "
            f"logits bitwise {same}; cache slices differing {diff}")
        need(same and not diff, f"{path} {name}: the fused step is not "
             f"bitwise the step through the plain chains (cache {diff[:1]})")
    if cfg.family == "audio":
        log("  (no rolling window in the audio family)")
        results.setdefault("fused_vs_plain", {})[path] = out
        return
    span = 16
    rolling = dataclasses.replace(cfg, window=span, kv_pool_blocks=0)
    fused = api.init_cache(rolling, 1, span, DEVICE)
    plain = clone_tree(fused)
    steps = []
    for n in range(1, 21):
        tok = toks[:1, n - 1:n]
        got, _ = api.decode_step(rolling, params, fused, tok, [n])
        with plain_glue():
            want, _ = api.decode_step(rolling, params, plain, tok, [n])
        if not bitwise(torch, got, want):
            steps.append(n)
    diff = differing_slices(torch, fused, plain)
    out["rolling-20"] = {"steps_differing": steps,
                         "cache_slices_differing": diff}
    log(f"  rolling window, 20 decode steps through a {span}-token span: "
        f"steps differing {steps}; cache slices differing {diff}")
    need(not steps and not diff, f"{path}: a rolling window's decode is not "
         f"bitwise the plain chains' (steps {steps[:3]}, cache {diff[:1]})")
    results.setdefault("fused_vs_plain", {})[path] = out


@contextlib.contextmanager
def recorded_drops(dropped):
    """Inside the block every ``ops.moe_router_route`` call appends the
    count of live assignments it dropped to the list ``dropped`` (a device
    tensor: no host read)."""
    from repro_torch.kernels import ops
    route = ops.moe_router_route

    def recording(x, router, *, group, top_k, capacity, q_lens=None, **kw):
        logits, r = route(x, router, group=group, top_k=top_k,
                          capacity=capacity, q_lens=q_lens, **kw)
        live = x.shape[0] if q_lens is None else q_lens.sum()
        dropped.append(live * top_k - r.counts.sum())
        return logits, r
    ops.moe_router_route = recording
    try:
        yield
    finally:
        ops.moe_router_route = route


def plain_router_route(x, router, group, top_k, capacity, q_lens=None):
    """The fused route's plain half on the card: the router's product on
    its ``dense_matmul`` kernel (the logits the kernels see), then the
    plain route."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_route import moe_route_torch
    logits = ops.dense_matmul(x, router)
    return logits, moe_route_torch(logits, group, top_k, capacity, q_lens)


@contextlib.contextmanager
def plain_moe():
    """Inside the block the MoE ops (route, experts, the combine in the
    norm) run their plain versions on the card; the router's product, the
    norm and every other op keep their kernels."""
    from repro_torch.kernels import moe_experts as mx
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms
    saved = (ops.moe_router_route_cuda, ops.moe_ffn_cuda,
             ops.combine_add_rmsnorm_cuda)
    ops.moe_router_route_cuda = plain_router_route
    ops.moe_ffn_cuda = mx.moe_ffn_torch
    ops.combine_add_rmsnorm_cuda = rms.combine_add_rmsnorm_torch
    try:
        yield
    finally:
        (ops.moe_router_route_cuda, ops.moe_ffn_cuda,
         ops.combine_add_rmsnorm_cuda) = saved


def check_moe_drops(torch, cfg, params, results, path):
    """(d) The published capacity factor 1.25, which the served paths lift:
    one W = 64 mixed step (rows of 64, 1, 40 and 64 live tokens) through
    the MoE kernels and through their plain versions (``plain_moe``), from
    fresh caches.  The assignments each layer drops
    (``recorded_drops``) are recorded for both; on one layer (the first
    layer's weights alone) the two see the same router logits, so they
    must drop the same assignments, at least one, and give logits within
    the W4A16 tolerance.  Through every layer the logits' difference is
    recorded (a near-tie in a later layer's router can send a token
    elsewhere)."""
    import numpy as np
    from repro_torch.models import api
    pcfg = dataclasses.replace(cfg, moe_capacity_factor=1.25)
    b, w, max_len = 4, 64, 80
    rng = np.random.default_rng(28)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (b, w)),
                        device=DEVICE)
    lengths = np.asarray([0, 3, 10, 0], np.int32)
    q_lens = np.asarray([64, 1, 40, 64], np.int32)
    out = {}
    for depth in (1, cfg.n_layers):
        dcfg = dataclasses.replace(pcfg, n_layers=depth)
        got = {}
        for mode in ("kernels", "plain"):
            cache = api.init_cache(dcfg, b, max_len, DEVICE)
            dropped = []
            with recorded_drops(dropped), (
                    plain_moe() if mode == "plain" else
                    contextlib.nullcontext()):
                logits, _ = api.mixed_step(dcfg, params, cache, toks,
                                           lengths, q_lens)
            torch.cuda.synchronize()
            got[mode] = (logits, [int(d) for d in dropped])
        err, rel = max_errs(got["kernels"][0], got["plain"][0])
        drops = {m: got[m][1] for m in got}
        out[f"layers={depth}"] = {"drops": drops, "max_abs_err": err,
                                  "max_rel_err": rel}
        log(f"  (d) factor 1.25, W=64 mixed step, {depth} layer(s): "
            f"assignments dropped a layer, kernels {drops['kernels']} "
            f"plain {drops['plain']}; logits max_abs {err:.3g} rel "
            f"{rel:.3g}")
        if depth == 1:
            need(drops["kernels"] == drops["plain"]
                 and drops["kernels"][0] > 0,
                 f"{path}: at factor 1.25 the kernels drop "
                 f"{drops['kernels']}, the plain versions {drops['plain']} "
                 "(need the same, > 0)")
            need(rel <= 1e-2, f"{path}: one layer at factor 1.25: logits "
                 f"rel {rel:.3g} from the plain versions > 1e-2")
    results.setdefault("moe_drops", {})[path] = out


def first_divergence(torch, cfg, params, prompt, got, max_len, frames=None):
    """Step where the engine left the oracle, and the oracle's top-2 logit
    margin there."""
    from repro_torch.models import api
    dev = DEVICE
    cache = start_cache(torch, cfg, params, max_len, frames)
    n = 0
    for tok in prompt.tolist():
        n += 1
        logits, cache = api.decode_step(
            cfg, params, cache, torch.tensor([[tok]], device=dev), [n])
    for step in range(len(got)):
        top = torch.topk(logits[0].float(), 2)
        ref_tok = int(top.indices[0])
        if ref_tok != got[step]:
            return step, float(top.values[0] - top.values[1])
        n += 1
        logits, cache = api.decode_step(
            cfg, params, cache, torch.tensor([[ref_tok]], device=dev), [n])
    return None, None


def matmul_kernel(w, name):
    """The kernel a projection's leaf type routes it to: W4A16, sparse
    W4A16 or, for a 16-bit tensor, ``dense_matmul``."""
    import torch
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.core.sparsity import SparseQuantizedTensor
    if isinstance(w, QuantizedTensor):
        return "w4a16_matmul"
    if isinstance(w, SparseQuantizedTensor):
        return "sparse_w4a16_matmul"
    need(isinstance(w, torch.Tensor) and w.is_floating_point(),
         f"{name} is a {type(w).__name__}: no kernel serves it")
    return "dense_matmul"


# the gate/up stage of each CUDA FFN path (ffn_fused.fused_variant)
FFN_KERNELS = {("quant", True): "ffn_fused_w4a16",
               ("quant", False): "ffn_fused_w4a16_gelu",
               ("sparse", True): "ffn_fused_sparse",
               ("sparse", False): "ffn_fused_sparse_gelu",
               ("fp", True): "ffn_fused_dense",
               ("fp", False): "ffn_fused_dense"}


def expected_launches(cfg, params, ticks, decode_ticks=0, span=None):
    """Launches per kernel for ``ticks`` engine ticks: layers x calls x
    ticks, read from the weights' leaf types.  Each projection goes to the
    W4A16, the sparse or the 16-bit kernel by its type; the FFN's gate/up
    to the kernel ``fused_variant`` picks, its down to the kernel of down's
    type (an MoE layer: ``moe_route`` with the router's product inside
    it, the grouped gate/up and down, and the next norm combining their
    rows, ``combine_add_rmsnorm``; a tied head ``dense_matmul``); the
    norms by the config: the first layer's ``ln_attn`` alone (``rmsnorm``
    or ``layernorm``) and every other norm with the residual add before it
    (``add_rmsnorm`` or ``add_layernorm``; on an MoE config the L norms
    after the experts are ``combine_add_rmsnorm``); the q/k/v
    epilogue (``qkv_rope_write``) once a layer, except on the
    ``decode_ticks`` of a window no shorter than the cache's ``span`` (a
    rolling buffer: the unfused chain, whose write is ``kv_write``)."""
    from repro_torch.kernels.decode_flash import VARIANTS
    from repro_torch.kernels.ffn_fused import GATED_ACTIVATIONS, fused_variant
    from repro_torch.models.transformer import layer_params
    L = cfg.n_layers
    attention = VARIANTS[(cfg.kv_layout == "paged", cfg.kv_quant == "int8")]
    per_tick = {attention: L, "qkv_rope_write": L}
    rolling = (decode_ticks if cfg.window is not None and span is not None
               and span <= cfg.window else 0)
    if cfg.norm == "layernorm":
        per_tick.update(layernorm=1, add_layernorm=2 * L)
    else:
        per_tick.update(rmsnorm=1, add_rmsnorm=2 * L)

    def add(kernel, n):
        per_tick[kernel] = per_tick.get(kernel, 0) + n
    attn = params["blocks"]["attn"]
    for name in ("wq", "wk", "wv", "wo"):
        add(matmul_kernel(attn[name], name), L)
    head = params.get("lm_head")
    add("dense_matmul" if head is None else matmul_kernel(head, "lm_head"), 1)
    if cfg.is_moe:
        # the route with the router's product, the two grouped expert
        # kernels and the combine inside the next norm (ln_attn of the
        # next layer, ln_f after the last), once a layer each; the add of
        # the attention's output stays add_rmsnorm (W4A16 experts only:
        # others have no CUDA path)
        moe = params["blocks"]["moe"]
        for name in ("gate", "up", "down"):
            need(matmul_kernel(moe[name], name) == "w4a16_matmul",
                 f"the experts' {name} is not W4A16: no CUDA path")
        need(cfg.norm != "layernorm", "an MoE config with a LayerNorm has "
             "no fused combine")
        for kernel in ("moe_route", "moe_gate_up_w4a16", "moe_down_w4a16",
                       "combine_add_rmsnorm"):
            add(kernel, L)
        add("add_rmsnorm", -L)
        return rolling_writes(per_tick, ticks, rolling, L)
    mlp = params["blocks"]["mlp"]
    gated = cfg.activation in GATED_ACTIVATIONS
    one = layer_params(mlp, 0)             # one layer's leaves, as served
    variant = fused_variant(one.get("gate"), one["up"], one["down"],
                            cfg.activation)
    need((variant, gated) in FFN_KERNELS,
         f"the FFN weights take no CUDA path ({variant}, {cfg.activation})")
    add(FFN_KERNELS[(variant, gated)], L)
    add(matmul_kernel(mlp["down"], "down"), L)
    return rolling_writes(per_tick, ticks, rolling, L)


def expected_launches_audio(cfg, params, steps, admits, full_sequence=False):
    """Launches per kernel of the audio family for ``steps`` decode steps
    (a mixed tick steps its whole chunk width: the engine's
    ``dispatched_columns``) and ``admits`` admissions, read from the
    weights' leaf types.  A step: per decoder layer the self-attention's
    q/k/v/o, the epilogue (``qkv_rope_write``) and kernel 3, the
    cross-attention's q and o and kernel 7 over the request's K/V, the
    gelu FFN (kernel 2g, its down by type) and three norms, each with the
    add before it (``add_layernorm``: the first takes the embeddings'
    sinusoids), then the add into ``ln_f`` and the tied head
    (``dense_matmul``).  An admission: per encoder layer q/k/v/o, kernel 7
    without a mask, the FFN and two fused norms, then ``enc_ln_f``; per
    decoder layer the cross K and V.  ``full_sequence``: a ``forward`` or
    slot ``prefill`` call instead of a step (``admits`` of them): kernel 7
    causal in place of kernel 3 and no epilogue."""
    from repro_torch.kernels.decode_flash import VARIANTS
    from repro_torch.kernels.ffn_fused import GATED_ACTIVATIONS, fused_variant
    from repro_torch.models.transformer import layer_params
    L, Le = cfg.n_layers, cfg.n_encoder_layers
    dec, enc = params["dec_blocks"], params["enc_blocks"]
    step, admit = {}, {}

    def add(d, kernel, n):
        d[kernel] = d.get(kernel, 0) + n

    def ffn(d, mlp, n):
        one = layer_params(mlp, 0)
        variant = fused_variant(one.get("gate"), one["up"], one["down"],
                                cfg.activation)
        key = (variant, cfg.activation in GATED_ACTIVATIONS)
        need(key in FFN_KERNELS, f"the FFN weights take no CUDA path {key}")
        add(d, FFN_KERNELS[key], n)
        add(d, matmul_kernel(mlp["down"], "down"), n)
    if full_sequence:
        add(step, "flash_attention", L)
    else:
        add(step, VARIANTS[(cfg.kv_layout == "paged",
                            cfg.kv_quant == "int8")], L)
        add(step, "qkv_rope_write", L)
    add(step, "flash_attention", L)
    add(step, "add_layernorm", 3 * L + 1)
    for name in ("wq", "wk", "wv", "wo"):
        add(step, matmul_kernel(dec["self_attn"][name], name), L)
    for name in ("wq", "wo"):
        add(step, matmul_kernel(dec["cross_attn"][name], name), L)
    ffn(step, dec["mlp"], L)
    add(step, matmul_kernel(params["embed"], "embed"), 1)   # the tied head
    add(admit, "flash_attention", Le)
    add(admit, "add_layernorm", 2 * Le + 1)
    for name in ("wq", "wk", "wv", "wo"):
        add(admit, matmul_kernel(enc["attn"][name], name), Le)
    ffn(admit, enc["mlp"], Le)
    for name in ("wk", "wv"):
        add(admit, matmul_kernel(dec["cross_attn"][name], name), L)
    out = {k: steps * n for k, n in step.items()}
    for k, n in admit.items():
        out[k] = out.get(k, 0) + admits * n
    return out


def rolling_writes(per_tick, ticks, rolling, layers):
    """``per_tick`` times ``ticks``, with ``rolling`` of them writing
    through ``kv_write`` instead of ``qkv_rope_write``."""
    out = {k: ticks * n for k, n in per_tick.items()}
    if rolling:
        out["qkv_rope_write"] -= rolling * layers
        out["kv_write"] = rolling * layers
    return {k: n for k, n in out.items() if n}


def expected_launches_ssm(cfg, params, steps, full_sequence=False):
    """Launches per kernel for ``steps`` decode steps of the xLSTM stack
    (a mixed tick steps its whole chunk width, so the engine's
    ``dispatched_columns``), read from the weights' leaf types: per mLSTM
    block two rmsnorms, up_x, up_z, wq, wk, wv and down by their type and
    one ``mlstm_cell`` (which takes the 16-bit w_i/w_f); per sLSTM block two
    rmsnorms, w_gates and down, one ``slstm_scan``; then ln_f and the
    lm_head.  ``full_sequence``: one ``forward`` call instead, where the
    mLSTM runs its parallel form (no cell kernel; its 16-bit w_i/w_f go
    through ``dense_matmul``) and the scan runs once over the sequence."""
    from repro_torch.core.quant import QuantizedTensor

    def matmul(w, name):
        need(isinstance(w, QuantizedTensor),
             f"{name} is a {type(w).__name__}: no kernel serves it")
        return "w4a16_matmul"
    per = {}

    def add(kernel, n):
        per[kernel] = per.get(kernel, 0) + n
    groups = [(g, params[g]) for g in ("mlstm_main", "mlstm_tail", "slstm")
              if g in params]
    for g, p in groups:
        lead = p["norm"].shape[:-1]             # (seg, blk) or (n,)
        n = 1
        for dim in lead:
            n *= dim
        names = (("w_gates", "down") if g == "slstm" else
                 ("up_x", "up_z", "wq", "wk", "wv", "down"))
        for name in names:
            add(matmul(p[name], name), n)
        add("rmsnorm", 2 * n)
        if g == "slstm":
            add("slstm_scan", n)
        else:
            need(not any(isinstance(p[w], QuantizedTensor)
                         for w in ("w_i", "w_f")),
                 "w_i/w_f are packed: the cell kernel takes 16-bit gates")
            if full_sequence:
                for w in ("w_i", "w_f"):
                    add(matmul_kernel(p[w], w), n)
            else:
                add("mlstm_cell", n)
    add("rmsnorm", 1)
    add(matmul(params["lm_head"], "lm_head"), 1)
    return {k: steps * n for k, n in per.items()}


def expected_launches_hybrid(cfg, params, steps, full_sequence=False):
    """Launches per kernel for ``steps`` decode steps of the hybrid
    backbone (a mixed tick steps its whole chunk width: the engine's
    ``dispatched_columns``), read from the weights' leaf types.  A step:
    per Mamba2 layer in_proj and out_proj by type and
    ``mamba_cell_gated`` (the cell and the gated norm); per shared-block
    site q/k/v/o by type, the q/k/v epilogue (``qkv_rope_write``), kernel
    3 of the cache's variant, the fused FFN and its down; the norms: the
    first layer's ``ln`` alone (``rmsnorm``) and every later one with the
    residual add before it (``add_rmsnorm``, the last add into ``ln_f``);
    the lm_head.
    ``full_sequence``: one ``forward`` call instead, where a Mamba2 layer
    runs the chunked SSD as torch ops and the gated norm
    (``rmsnorm_gated``), and a site kernel 7 with no epilogue."""
    from repro_torch.kernels.decode_flash import VARIANTS
    from repro_torch.kernels.ffn_fused import GATED_ACTIVATIONS, fused_variant
    from repro_torch.models.transformer import layer_params
    sites = cfg.n_layers // cfg.shared_attn_every
    L = cfg.n_layers
    per = {}

    def add(kernel, n):
        per[kernel] = per.get(kernel, 0) + n
    mam = params["mamba_main"]["mamba"]
    for name in ("in_proj", "out_proj"):
        add(matmul_kernel(mam[name], name), L)
    attn, mlp = params["shared"]["attn"], params["shared"]["mlp"]
    for name in ("wq", "wk", "wv", "wo"):
        add(matmul_kernel(attn[name], name), sites)
    one = layer_params(mlp, 0)
    variant = fused_variant(one.get("gate"), one["up"], one["down"],
                            cfg.activation)
    key = (variant, cfg.activation in GATED_ACTIVATIONS)
    need(key in FFN_KERNELS, f"the FFN weights take no CUDA path {key}")
    add(FFN_KERNELS[key], sites)
    add(matmul_kernel(mlp["down"], "down"), sites)
    add("rmsnorm", 1)
    add("add_rmsnorm", L + 2 * sites)
    add(matmul_kernel(params["lm_head"], "lm_head"), 1)
    if full_sequence:
        add("rmsnorm_gated", L)
        add("flash_attention", sites)
        return {k: steps * n for k, n in per.items()}
    add("mamba_cell_gated", L)
    add("qkv_rope_write", sites)
    add(VARIANTS[(cfg.kv_layout == "paged", cfg.kv_quant == "int8")], sites)
    return {k: steps * n for k, n in per.items()}


SERVE_MAX_LEN, SERVE_NEW_TOKENS = 512, 16


def workload(cfg, engine_kw=None):
    """Phase 5's prompts: 8 of 4-31 tokens and one of 200.  A speculating
    engine's: 8 patterns of 2-5 tokens tiled 3 times (the shape of
    ``tests/test_spec.py``'s ``_rep_reqs``), so prompt lookup drafts from
    the first decode tick.  A prefix-sharing engine's: 8 prompts of one
    40-token system prompt (two whole 16-token pages and half of a third,
    so a hit copies the third on write) and a 4-31 token suffix, the
    first of them (48 tokens, three whole pages) repeated whole as the
    9th (the prompt cached whole: its last page is copied on write).
    Both end with the 200-token prompt."""
    import numpy as np
    engine_kw = engine_kw or {}
    rng = np.random.default_rng(0)
    v = cfg.vocab_size
    long_prompt = workload(cfg)[-1] if engine_kw else None
    if engine_kw.get("prefix_cache"):
        system = rng.integers(0, v, 40)
        prompts = [np.concatenate([system, rng.integers(
            0, v, 8 if i == 0 else int(rng.integers(4, 32)))])
            for i in range(8)]
        return prompts + [prompts[0], long_prompt]
    if engine_kw.get("spec_k"):
        return [np.tile(rng.integers(0, v, int(rng.integers(2, 6))), 3)
                for _ in range(8)] + [long_prompt]
    prompts = [rng.integers(0, v, int(rng.integers(4, 32)))
               for _ in range(8)]
    prompts.append(rng.integers(0, v, 200))
    return prompts


def serve(torch, cfg, params, results, path, slot_streams=None,
          engine_kw=None):
    """Serve the workload twice on one engine (``engine_kw``: speculation
    and prefix sharing); returns (the first run's launch counts, its
    streams).  Every tick replays a captured CUDA graph: misses stay within
    ``compile_budget`` and the second run makes none, with the first run's
    streams (on a prefix-sharing engine, although it hits the cache the
    first run left).  Every engine audits every tick; a paged one without
    sharing must stall admissions and end with its pool whole, a sharing
    one must hit its cache and copy on write, hold only cache references
    after run 0 and be whole after ``drop_prefix_cache()``; a speculating
    one must score drafts.  Every key's graph is replayed on its dead
    inputs under ``set_sync_debug_mode("error")``.  ``slot_streams`` (the
    slot run's) are compared as information only (tiles of 16 against 128
    keys can flip bf16 ties).  On the paths of ``REPLAY_PATHS`` and
    ``TRACE_PATHS`` the engine's graphs are then held against eager steps
    and traced."""
    import numpy as np
    from repro_torch.kernels._build import launches
    from repro_torch.serving.engine import Engine, Request, reference_decode
    max_len, max_new = SERVE_MAX_LEN, SERVE_NEW_TOKENS
    engine_kw = engine_kw or {}
    prompts = workload(cfg, engine_kw)
    engine = Engine(cfg, params, batch_size=4, max_len=max_len,
                    chunk_size=64, audit_every=1, device=DEVICE, **engine_kw)
    audio = cfg.family == "audio"
    frames = (audio_frames(cfg, len(prompts)) if audio
              else [None] * len(prompts))
    runs, first = [], None
    for run in range(2):
        reqs = [Request(rid=100 * run + i, prompt=p.astype(np.int32),
                        max_new_tokens=max_new, frames=frames[i])
                for i, p in enumerate(prompts)]
        # a paged run submits the 200-token request first: its 14-block
        # reservation then holds the pool while the short ones queue
        # behind it (in rid order the short ones leave in two whole waves
        # and the long one runs alone, and the pool never stalls)
        for r in (reqs[-1:] + reqs[:-1] if engine.paged else reqs):
            engine.submit(r)
        ticks0, cols0 = engine.steps, engine.dispatched_columns
        mixed0, stalls0 = engine.mixed_ticks, engine.admission_stalls
        misses0 = engine.cache_compiles.misses
        spec0, prefix0 = engine.spec_stats(), engine.prefix_stats()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        launches.clear()
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
        peak = torch.cuda.max_memory_allocated()  # the engine's alone
        need(done.drained and len(done) == len(reqs)
             and all(r.done for r in reqs),
             f"{path} run {run}: engine did not finish every request "
             f"({len(done)}/{len(reqs)})")
        summary = Engine.summarize(done)
        n_tok = sum(len(r.output) for r in reqs)
        ticks = engine.steps - ticks0
        cols = engine.dispatched_columns - cols0
        stalls = engine.admission_stalls - stalls0
        span = (engine.n_pages * engine.block_size if engine.paged
                else max_len)
        expect = (expected_launches_ssm(cfg, params, cols)
                  if cfg.family == "ssm" else
                  expected_launches_hybrid(cfg, params, cols)
                  if cfg.family == "hybrid" else
                  expected_launches_audio(cfg, params, cols, len(reqs))
                  if audio else
                  expected_launches(cfg, params, ticks,
                                    ticks - (engine.mixed_ticks - mixed0),
                                    span))
        new_misses = engine.cache_compiles.misses - misses0
        log(f"  run {run}: {ticks} ticks ({engine.mixed_ticks - mixed0} "
            f"mixed, {cols} token columns), {n_tok} tokens in {wall:.2f} s "
            f"= {n_tok / wall:.1f} tokens/s, TTFT p50 "
            f"{summary.get('ttft_p50_s', float('nan')) * 1e3:.1f} ms, ITL "
            f"p50 {summary.get('itl_p50_s', float('nan')) * 1e3:.1f} ms, "
            f"peak memory {peak / 2**30:.2f} GiB, {new_misses} new misses, "
            f"{engine.audits} audits, peak resident "
            f"{engine.peak_resident_tokens} tokens")
        spec = {k: v - spec0[k] for k, v in engine.spec_stats().items()
                if k in ("spec_ticks", "verify_rows", "draft_tokens",
                         "accepted_tokens", "rewinds")}
        spec["acceptance_rate"] = (spec["accepted_tokens"] /
                                   max(spec["draft_tokens"], 1))
        spec["accepted_per_dispatch"] = (spec["accepted_tokens"] /
                                         max(spec["spec_ticks"], 1))
        prefix = {k: v - prefix0[k] for k, v in engine.prefix_stats().items()
                  if k in ("hits", "hit_tokens", "cow_copies", "evictions")}
        if engine.spec_k:
            log(f"  speculation: {spec}")
            need(spec["draft_tokens"] > 0,
                 f"{path} run {run}: no draft was scored")
        pool = None
        if engine.paged:
            pool = engine.pool_stats()
            log(f"  paged KV: {engine.pool_blocks} blocks x "
                f"{engine.block_size} tokens, {stalls} admission stalls, "
                f"pool {pool}")
            if engine.prefix_sharing:
                log(f"  prefix cache: {prefix}")
                need(prefix["hits"] > 0 and prefix["cow_copies"] > 0,
                     f"{path} run {run}: no prefix hit or no copy-on-write "
                     f"({prefix})")
                need(pool["leased"] == pool["cached_blocks"]
                     and not pool["reserved_outstanding"],
                     f"{path} run {run}: blocks other than the cache's are "
                     f"live after the drain: {pool}")
                if run == 1:
                    dropped = engine.drop_prefix_cache()
                    pool = engine.pool_stats()
                    log(f"  drop_prefix_cache(): {dropped} nodes; pool "
                        f"{pool}")
            else:
                need(stalls > 0, f"{path} run {run}: the pool never stalled "
                     "an admission")
            if run == 1 or not engine.prefix_sharing:
                need(pool["free"] == pool["total"] and not pool["leased"],
                     f"{path} run {run}: the pool is not whole after the "
                     f"drain: {pool}")
        log(f"  launches: {counts}  expected: {expect}")
        need(counts == expect, f"{path} run {run}: kernel launch counts do "
             "not match layers x calls x ticks: the serving path did not run"
             " through every kernel")
        streams = [r.output for r in reqs]
        runs.append({
            "requests": len(reqs), "ticks": ticks,
            "mixed_ticks": engine.mixed_ticks - mixed0,
            "dispatched_columns": cols, "tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall,
            "ttft_p50_s": summary.get("ttft_p50_s"),
            "itl_p50_s": summary.get("itl_p50_s"),
            "max_memory_allocated": peak, "new_misses": new_misses,
            "admission_stalls": stalls, "pool": pool, "launches": counts,
            "expected_launches": expect,
            "speculation": spec if engine.spec_k else None,
            "prefix": prefix if engine.prefix_sharing else None})
        if run == 0:
            first = streams
            mismatches = []
            for r in reqs:
                ref = reference_decode(cfg, params, r.prompt,
                                       r.max_new_tokens, max_len=max_len,
                                       frames=r.frames, device=DEVICE)
                if r.output != ref:
                    step, margin = first_divergence(
                        torch, cfg, params, r.prompt, r.output, max_len,
                        r.frames)
                    mismatches.append({"rid": r.rid, "step": step,
                                       "oracle_top2_margin": margin})
            log(f"  token streams equal to reference_decode: "
                f"{len(reqs) - len(mismatches)}/{len(reqs)} "
                f"{mismatches or ''}")
            runs[-1]["mismatches"] = mismatches
            need(not mismatches, f"{path}: engine token streams differ from "
                 "reference_decode")
        else:
            log(f"  run 1 streams equal to run 0's (so to "
                f"reference_decode): {streams == first}")
            need(new_misses == 0, f"{path}: the second run captured "
                 f"{new_misses} more graphs")
            need(streams == first, f"{path}: the second run's streams "
                 "differ from the first's")
    cc = engine.cache_compiles
    graphs = {f"{k[0]}-{k[1]}": t for k, t in engine.capture_seconds.items()}
    ticked = [k for k in cc.keys() if k[0] != "insert"]
    if audio:
        need(("admit", cfg.encoder_frames) in ticked,
             f"{path}: no ('admit', {cfg.encoder_frames}) graph")
    log(f"  compile cache: {sorted(cc.keys())} ({cc.hits} hits, misses by "
        f"kind {cc.misses_by_name}); budget {engine.compile_budget}; "
        f"graphs captured {len(graphs)}, capture s {graphs}")
    need(cc.misses <= engine.compile_budget,
         f"{path}: {cc.misses} misses > compile_budget "
         f"{engine.compile_budget}")
    need(sorted(engine.capture_seconds) == sorted(ticked),
         f"{path}: the mixed, decode, cow and admit keys {ticked} are not "
         f"each one captured graph ({sorted(engine.capture_seconds)})")
    same_as_slot = (None if slot_streams is None else
                    sum(a == b for a, b in zip(first, slot_streams)))
    if same_as_slot is not None:
        log(f"  streams equal to the slot fp run's (information only): "
            f"{same_as_slot}/{len(prompts)}")
    results.setdefault("serving", {})[path] = {
        "runs": runs, "compile_keys": [list(k) for k in sorted(cc.keys())],
        "misses_by_name": cc.misses_by_name, "hits": cc.hits,
        "compile_budget": engine.compile_budget, "capture_s": graphs,
        "audits": engine.audits,
        "peak_resident_tokens": engine.peak_resident_tokens,
        "streams_equal_slot_run": same_as_slot, "engine_kw": engine_kw}
    replay_without_sync(torch, engine, path)
    if path in REPLAY_PATHS:
        log(f"phase 4 [{path}]: graph replay vs eager, every key")
        check_graph_replay(torch, engine, params, results, path)
    if path in TRACE_PATHS:
        log(f"phase 5 [{path}]: profiler traces of one tick, eager and "
            "replayed")
        trace_ticks(torch, engine, params, results, path)
    return runs[0]["launches"], first


def replay_without_sync(torch, engine, path):
    """Every captured key replayed once on its dead inputs (no live row;
    ``cow``: the null block onto itself), staging copies included, under
    ``torch.cuda.set_sync_debug_mode("error")``: a tick and a
    copy-on-write read nothing back to the host.  Then each mixed and
    decode key's replay with the engine's fetch, as a tick is served, asks
    for exactly one copy to the host (``host_copies``)."""
    import numpy as np
    keys = sorted(k for k in engine.cache_compiles.keys()
                  if k[0] != "insert")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name, bucket in keys:
            tick = engine.cache_compiles.get(name, bucket, None)
            if name == "cow":
                null = np.array([engine._null_block], np.int64)
                tick(engine.params, engine.cache, src=null, dst=null)
            elif name == "admit":
                tick(engine.params, engine._admit_row,
                     frames=np.zeros((1, bucket, engine.cfg.d_model),
                                     np.float32))
            else:
                tick(engine.params, engine.cache, **engine._dead_inputs(
                    None if name == "decode" else bucket))
    except RuntimeError as e:
        raise SmokeFailure(f"{path}: a graph replay synchronised with the "
                           f"host: {e}") from None
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"  replays of {[f'{n}-{b}' for n, b in keys]} on dead inputs under "
        "set_sync_debug_mode(\"error\"): no host synchronisation")
    copies = {}
    for name, bucket in keys:
        if name in ("cow", "admit"):
            continue
        tick = engine.cache_compiles.get(name, bucket, None)
        dead = engine._dead_inputs(None if name == "decode" else bucket)
        copies[f"{name}-{bucket}"] = host_copies(torch, lambda: engine._fetch(
            *tick(engine.params, engine.cache, **dead), False))
    log(f"  copies to the host a served tick asks for (replay + fetch): "
        f"{copies}")
    need(all(n == 1 for n in copies.values()), f"{path}: a served tick asks "
         f"for other than one copy to the host: {copies}")


class StepClock:
    """An engine clock that ``tick_by_tick`` advances by one unit a tick."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# roles of phase 5's prompts on the lifecycle path (indices of
# ``workload(cfg)``): 8 is the 200-token prompt, at priority 0, 7 is at
# priority 2, the others at 1
LONG, DEADLINE, POISONED, CANCELLED, PRIORITY2 = 8, 1, 3, 5, 7
WAVE_A, WAVE_B = (0, 2, POISONED), (DEADLINE, 4, CANCELLED, 6)
DEADLINE_TICKS, CANCEL_AFTER = 6, 3


def tick_by_tick(engine, clock, events, max_ticks=400):
    """Drive ``engine`` one ``run(max_steps=1)`` at a time, the clock one
    unit ahead after each.  ``events`` is a list of (condition, action):
    before each tick, each event whose condition holds runs its action,
    once.  Returns the requests that reached a terminal state, for each
    tick the slot and the blocks of every running rid (after the tick's
    consume), each quarantine as (tick, rid, slot, blocks), each
    preemption as (tick, victim rid, queue head rid, whether every slot
    was busy), and the tick at which each event fired."""
    import warnings
    done, seen, faults, preempts = [], [], [], []
    fired: dict = {}
    fault, preempt = engine._fault_row, engine._preempt

    def spy_fault(idx, msg, completed):
        faults.append((engine.steps - 1, engine._slots[idx].req.rid, idx,
                       list(engine._slot_blocks[idx])))
        fault(idx, msg, completed)

    def spy_preempt(idx, **kw):
        preempts.append((engine.steps, engine._slots[idx].req.rid,
                         engine._queue[0].rid if engine._queue else None,
                         all(s.req is not None for s in engine._slots)))
        preempt(idx, **kw)

    engine._fault_row, engine._preempt = spy_fault, spy_preempt
    try:
        for t in range(max_ticks):
            for k, (when, action) in enumerate(events):
                if k not in fired and when():
                    fired[k] = t
                    action()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                res = engine.run(max_steps=1)
            done.extend(res)
            seen.append({s.req.rid: (i, list(engine._slot_blocks[i]))
                         for i, s in enumerate(engine._slots)
                         if s.req is not None})
            clock.t += 1.0
            if res.drained and len(fired) == len(events):
                break
    finally:
        del engine._fault_row, engine._preempt
    return done, seen, faults, preempts, fired


def serve_lifecycle(torch, cfg, params, results, path, oracle):
    """The request lifecycle on captured graphs (the paged pool of
    ``strategy2-paged``, ``prefix_cache=True``, ``max_preemptions=2``,
    ``audit_every=1``, a clock one unit a tick): phase 5's prompts with
    roles, driven one tick at a time — the 200-token one first at
    priority 0, then three short ones at priority 1 (``WAVE_A``: a
    shortfall preempts the long one after its first token, its blocks
    donated), one of them holding a token whose ``embed`` row is NaN on
    the card (in place, restored after; an id no other prompt and no
    oracle stream holds), so the device flag must quarantine exactly that
    row, whose slot and blocks later requests take; once the long one is
    done four more (``WAVE_B``), one with a deadline that expires
    mid-decode and one cancelled between two ``run`` calls; when they
    fill the batch, one at priority 2, which preempts its way in.  ``oracle``: the
    streams of ``strategy2-paged`` (equal to ``reference_decode``).
    Then the unpoisoned prompts again on the same engine: no capture,
    the oracle's streams.  Returns (the first run's launch counts, its
    streams)."""
    import numpy as np
    from repro_torch.kernels._build import launches
    from repro_torch.serving.engine import Engine, Request
    prompts = workload(cfg)
    used = {int(x) for i, p in enumerate(prompts) if i != POISONED
            for x in p}
    used.update(int(x) for i, s in enumerate(oracle) if i != POISONED
                for x in s)
    poison = next(x for x in range(cfg.vocab_size) if x not in used)
    bad = prompts[POISONED].copy()
    bad[len(bad) // 2] = poison
    clock = StepClock()
    engine = Engine(cfg, params, batch_size=4, max_len=SERVE_MAX_LEN,
                    chunk_size=64, prefix_cache=True, max_preemptions=2,
                    audit_every=1, clock=clock, device=DEVICE)
    reqs = [Request(rid=i, prompt=(bad if i == POISONED else p).astype(
        np.int32), max_new_tokens=SERVE_NEW_TOKENS,
        priority=0 if i == LONG else 2 if i == PRIORITY2 else 1,
        deadline_s=DEADLINE_TICKS if i == DEADLINE else None)
        for i, p in enumerate(prompts)]

    def submit(*rids):
        return lambda: [engine.submit(reqs[i]) for i in rids]

    slots = engine._slots
    events = [
        # the long request first; three short ones once it has emitted
        # a token: the third one's reservation preempts it
        (lambda: True, submit(LONG)),
        (lambda: len(reqs[LONG].output) >= 1, submit(*WAVE_A)),
        # four more once it is done; the priority-2 one when they fill
        # the batch and the queue is empty
        (lambda: reqs[LONG].done, submit(*WAVE_B)),
        (lambda: all(s.req is not None for s in slots) and not
         engine._queue and reqs[WAVE_B[-1]].status == "running",
         submit(PRIORITY2)),
        (lambda: len(reqs[CANCELLED].output) >= CANCEL_AFTER,
         lambda: need(engine.cancel(CANCELLED),
                      f"{path}: cancel found no request"))]
    embed = params["embed"]
    saved = embed[poison].clone()
    embed[poison] = float("nan")
    torch.cuda.synchronize()
    launches.clear()
    t0 = time.perf_counter()
    try:
        done, seen, faults, preempts, fired = tick_by_tick(
            engine, clock, events)
    finally:
        embed[poison] = saved
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches)
    ticks = engine.steps
    stats = engine.resilience_stats()
    expect = {"done": [i for i in range(len(reqs))
                       if i not in (DEADLINE, POISONED, CANCELLED)],
              "deadline_missed": [DEADLINE], "error": [POISONED],
              "cancelled": [CANCELLED]}
    status = {r.rid: r.status for r in reqs}
    log(f"  {ticks} ticks in {wall:.2f} s, poisoned token {poison}; "
        f"statuses {status}; preemptions by rid "
        f"{ {r.rid: r.preemptions for r in reqs} }; {stats}")
    for want, rids in expect.items():
        need(all(status[i] == want for i in rids),
             f"{path}: statuses {status}, expected {expect}")
    need(stats["preemptions"] >= 1 and stats["row_faults"] == 1
         and stats["deadline_misses"] == 1 and stats["cancels"] == 1,
         f"{path}: resilience counters {stats}")
    log(f"  events fired before ticks {sorted(fired.values())}; "
        f"preemptions (tick, victim, queue head, batch full): {preempts}")
    need(any(h == PRIORITY2 and full for _, _, h, full in preempts)
         and any(h != PRIORITY2 and v == LONG for _, v, h, _ in preempts),
         f"{path}: no shortfall preempted the long request, or the "
         "priority-2 request did not preempt its way into a full batch")
    need(0 < len(reqs[DEADLINE].output) < SERVE_NEW_TOKENS,
         f"{path}: the deadline did not expire mid-decode "
         f"({len(reqs[DEADLINE].output)} tokens)")
    need(reqs[POISONED].error == "non-finite logits",
         f"{path}: the poisoned row ended {reqs[POISONED].error!r}")
    for r in reqs:
        ref = oracle[r.rid]
        if r.status == "done":
            need(r.output == ref, f"{path}: rid {r.rid} (preempted "
                 f"{r.preemptions}x) differs from reference_decode")
        elif r.rid != POISONED:
            need(r.output == ref[:len(r.output)],
                 f"{path}: rid {r.rid}'s partial stream is not a prefix of "
                 "its oracle's")
    # who took the quarantined row's slot or blocks after it
    (f_tick, f_rid, f_slot, f_blocks), = faults
    heirs = {}
    for live in seen[f_tick + 1:]:
        for rid, (slot, blocks) in live.items():
            if rid != f_rid and (slot == f_slot or set(blocks) & set(f_blocks)):
                heirs.setdefault(rid, set()).update(
                    (["slot"] if slot == f_slot else []) +
                    (["blocks"] if set(blocks) & set(f_blocks) else []))
    log(f"  quarantined rid {f_rid} at tick {f_tick} in slot {f_slot} with "
        f"blocks {f_blocks}; later holders of its slot or blocks "
        f"{ {k: sorted(v) for k, v in heirs.items()} }")
    need(any("slot" in v for v in heirs.values())
         and any("blocks" in v for v in heirs.values())
         and all(status[r] in ("done", "cancelled", "deadline_missed")
                 for r in heirs),
         f"{path}: no later request reused the quarantined row's slot and "
         "blocks, or one of them faulted")
    expect_launches = expected_launches(cfg, params, ticks)
    need(counts == expect_launches, f"{path}: kernel launch counts do not "
         "match layers x calls x ticks")
    # again, unpoisoned: every key captured already, the oracle's streams
    misses0 = engine.cache_compiles.misses
    again = [Request(rid=100 + i, prompt=p.astype(np.int32),
                     max_new_tokens=SERVE_NEW_TOKENS)
             for i, p in enumerate(prompts) if i != POISONED]
    for r in again:
        engine.submit(r)
    res = engine.run()
    need(res.drained and all(
        r.output == oracle[r.rid - 100] for r in again),
        f"{path}: the second run's streams differ from reference_decode")
    cc = engine.cache_compiles
    new_misses = cc.misses - misses0
    dropped = engine.drop_prefix_cache()
    pool = engine.pool_stats()
    log(f"  second run: {engine.steps - ticks} ticks, {new_misses} new "
        f"misses; compile cache "
        f"{sorted(cc.keys())} ({cc.misses} misses, budget "
        f"{engine.compile_budget}); drop_prefix_cache(): {dropped} nodes; "
        f"pool {pool}; {engine.audits} audits")
    need(cc.misses <= engine.compile_budget and not new_misses,
         f"{path}: {cc.misses} misses (budget {engine.compile_budget})")
    need(pool["free"] == pool["total"] and not pool["leased"],
         f"{path}: the pool is not whole: {pool}")
    need(engine.audits == engine.steps, f"{path}: not one audit a tick")
    results.setdefault("serving", {})[path] = {
        "ticks": ticks, "wall_s": wall, "poisoned_token": poison,
        "statuses": status, "resilience": stats,
        "preemptions_by_rid": {r.rid: r.preemptions for r in reqs},
        "quarantine": {"tick": f_tick, "rid": f_rid, "slot": f_slot,
                       "blocks": f_blocks},
        "heirs": {k: sorted(v) for k, v in heirs.items()},
        "launches": counts, "compile_keys": [list(k) for k in cc.keys()],
        "misses": cc.misses, "compile_budget": engine.compile_budget,
        "pool_after_drop": pool}
    replay_without_sync(torch, engine, path)
    return counts, [r.output for r in reqs]


def serve_chaos(torch, cfg, params, results, path, oracle):
    """The chaos soak on captured graphs: the int8 paged pool of
    ``strategy2-paged-int8``, ``prefix_cache=True``, ``spec_k=4``,
    ``max_preemptions=2``, ``audit_every=1`` and the reference soak's
    ``ChaosMonkey`` rates at seed 1, serving phase 5's prefix workload.
    ``oracle``: the streams of ``strategy2-paged-int8-prefix`` (equal to
    ``reference_decode``).  Holds the soak's contract (``check_soak``):
    every request terminal, every done stream bitwise its oracle, every
    faulted one a prefix of it, the audit green every tick, no leaked
    block; misses within the budget."""
    import numpy as np
    from repro_torch.kernels._build import launches
    from repro_torch.serving.chaos import ChaosConfig, ChaosMonkey, check_soak
    from repro_torch.serving.engine import Engine, Request
    prompts = workload(cfg, {"prefix_cache": True})
    engine = Engine(cfg, params, batch_size=4, max_len=SERVE_MAX_LEN,
                    chunk_size=64, prefix_cache=True, spec_k=4,
                    max_preemptions=2, audit_every=1, device=DEVICE,
                    chaos=ChaosMonkey(ChaosConfig(
                        seed=1, deny_rate=0.10, preempt_rate=0.15,
                        nan_rate=0.02, garbage_draft_rate=0.5)))
    reqs = [Request(rid=i, prompt=p.astype(np.int32),
                    max_new_tokens=SERVE_NEW_TOKENS)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    launches.clear()
    t0 = time.perf_counter()
    done = engine.run(max_steps=4000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches)
    need(engine.audits == engine.steps, f"{path}: not one audit a tick")
    try:
        outcomes = check_soak(path, reqs, dict(enumerate(oracle)), engine,
                              done)
    except AssertionError as e:
        raise SmokeFailure(str(e)) from None
    stats = engine.resilience_stats()
    cc = engine.cache_compiles
    log(f"  {engine.steps} ticks in {wall:.2f} s; outcomes {outcomes}; "
        f"preemptions by rid { {r.rid: r.preemptions for r in reqs} }; "
        f"resilience {stats}; speculation {engine.spec_stats()}; prefix "
        f"{engine.prefix_stats()}; compile cache {sorted(cc.keys())} "
        f"({cc.misses} misses, budget {engine.compile_budget})")
    need(cc.misses <= engine.compile_budget,
         f"{path}: {cc.misses} misses > budget {engine.compile_budget}")
    need(counts == expected_launches(cfg, params, engine.steps),
         f"{path}: kernel launch counts do not match layers x calls x ticks")
    results.setdefault("serving", {})[path] = {
        "ticks": engine.steps, "wall_s": wall, "outcomes": outcomes,
        "resilience": stats, "speculation": engine.spec_stats(),
        "prefix": engine.prefix_stats(), "launches": counts,
        "misses": cc.misses, "compile_budget": engine.compile_budget}
    replay_without_sync(torch, engine, path)
    return counts, [r.output for r in reqs]

RESTART_KILLS = (7, 5)      # life 0 dies at its tick 7, life 1 at its 5th
RESTART_SNAPSHOT_EVERY = 6
MEMORY_SPREAD = 0.05        # life 2's peak memory against life 0's


def serve_restart(torch, cfg, params, results, path, oracle):
    """Durable serving on captured graphs: ``serve_chaos``'s engine (the
    int8 paged pool, sharing, ``spec_k=4``, ``audit_every=1``) without
    faults but kills, with ``snapshot_dir`` in a fresh temporary directory
    and a snapshot every ``RESTART_SNAPSHOT_EVERY`` ticks, serving phase
    5's prefix workload.  Life 0 is killed at the top of its tick 7, one
    tick past its first periodic snapshot; life 1 is ``Engine.restore``
    (which captures the saved keys and the rest of the engine's key set,
    then loads the snapshot in place) and is killed at its 5th tick; life
    2 is restored again and drains.  A dead engine is dropped and freed
    before the next restore.  ``oracle``: the streams of
    ``strategy2-paged-int8-prefix`` (equal to ``reference_decode``).
    Holds: the durable streams (every journal epoch) equal the oracle's,
    every rid terminal once, two kills and three lives, each life's
    misses within the budget and none on any tick after a restore, the
    audit every tick, the pool whole after ``drop_prefix_cache()``, life
    2's peak memory within ``MEMORY_SPREAD`` of life 0's, each dead
    engine's release freeing at least its cache's bytes, the launch
    counts of all ticks of all lives, and the restored engine's replays
    free of host reads.  Records snapshot bytes and seconds, restore
    seconds by phase, the journal's fsync seconds a tick, and life 2's
    tokens/s and ITL p50."""
    import shutil
    import tempfile
    import warnings
    import numpy as np
    from repro_torch.kernels._build import launches
    from repro_torch.serving import snapshot as snaplib
    from repro_torch.serving.chaos import (
        ChaosMonkey, EngineKilled, check_durable, release)
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.train.checkpoint import tree_paths
    prompts = workload(cfg, {"prefix_cache": True})
    kw = dict(batch_size=4, max_len=SERVE_MAX_LEN, chunk_size=64,
              prefix_cache=True, spec_k=4, audit_every=1, device=DEVICE)
    root = tempfile.mkdtemp(prefix="chip_smoke_restart_")
    lives, engine, ticks = [], None, 0
    torch.cuda.synchronize()
    launches.clear()
    try:
        for life in range(3):
            chaos = (ChaosMonkey(kill_after=RESTART_KILLS[life])
                     if life < len(RESTART_KILLS) else None)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if life == 0:
                engine = Engine(cfg, params, snapshot_dir=root,
                                snapshot_every=RESTART_SNAPSHOT_EVERY,
                                chaos=chaos, **kw)
                for i, p in enumerate(prompts):
                    engine.submit(Request(rid=i, prompt=p.astype(np.int32),
                                          max_new_tokens=SERVE_NEW_TOKENS))
            else:
                engine = Engine.restore(root, params, chaos=chaos,
                                        device=DEVICE)
            torch.cuda.synchronize()
            t_ready = time.perf_counter()
            cc = engine.cache_compiles
            steps0, audits0, misses0 = (engine.steps, engine.audits,
                                        cc.misses)
            had = {r.rid: len(r.output) for r in
                   [s.req for s in engine._slots if s.req is not None]
                   + list(engine._queue)}
            killed, first, done = False, None, []
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    done = list(engine.run(max_steps=1))
                first = cc.misses - misses0
                done += engine.run()
            except EngineKilled:
                killed = True
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_ready
            ticks += engine.steps - steps0
            d = engine.durability_stats()
            emitted = sum(len(r.output) - had.get(r.rid, 0) for r in done)
            itl = [dt for r in done for dt in
                   np.diff(r.token_times[had.get(r.rid, 0):]).tolist()]
            rec = {
                "life": life, "killed": killed,
                "ticks": engine.steps - steps0, "steps": engine.steps,
                "setup_s": t_ready - t0, "wall_s": wall,
                "misses": cc.misses, "misses_after_setup":
                    cc.misses - misses0, "first_tick_misses": first,
                "compile_keys": [list(k) for k in cc.keys()],
                "compile_budget": engine.compile_budget,
                "audits": engine.audits - audits0,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "memory_allocated": torch.cuda.memory_allocated(),
                "snapshots": d["snapshot_log"],
                "journal_commits": d["journal_commits"],
                "journal_fsync_s": d["journal_fsync_s"],
                "restore_s": d["restore_seconds"],
                "restored_terminal": d["restored_terminal"],
                "finished": len(done), "tokens_emitted": emitted,
                "tokens_per_s": emitted / wall if wall else None,
                "itl_p50_s": (float(np.percentile(itl, 50)) if itl
                              else None)}
            lives.append(rec)
            snaps = [(x["step"], x["bytes"], round(x["export_s"] * 1e3, 2),
                      round(x["write_s"] * 1e3, 2))
                     for x in rec["snapshots"]]
            log(f"  life {life}: {rec['ticks']} ticks to step "
                f"{engine.steps} in {wall:.2f} s "
                f"({'killed' if killed else 'drained'}), set-up "
                f"{rec['setup_s']:.2f} s (restore phases s "
                f"{rec['restore_s']}), misses {cc.misses} (first tick "
                f"{first}, after set-up {rec['misses_after_setup']}), keys "
                f"{sorted(cc.keys())}, peak memory "
                f"{rec['max_memory_allocated']:,} B; snapshots (step, B, "
                f"export ms, write ms) {snaps}; journal "
                f"{rec['journal_commits']} fsyncs in "
                f"{rec['journal_fsync_s'] * 1e3:.2f} ms")
            need(cc.misses <= engine.compile_budget,
                 f"{path} life {life}: {cc.misses} misses > budget "
                 f"{engine.compile_budget}")
            need(rec["audits"] == rec["ticks"],
                 f"{path} life {life}: not one audit a tick")
            if life:
                need(first == 0 and not rec["misses_after_setup"],
                     f"{path} life {life}: a tick after the restore "
                     f"captured ({first} on the first, "
                     f"{rec['misses_after_setup']} in all)")
            if not killed:
                break
            # the dead engine is abandoned whole: its graphs, graph pool
            # and pinned buffers go before the next restore
            cache_bytes = sum(t.numel() * t.element_size()
                              for _, t in tree_paths(engine.cache))
            held = torch.cuda.memory_allocated()
            # (``cc`` too: its graphs hold the dead engine's cache)
            engine = chaos = done = cc = None
            release(DEVICE)
            rec["freed"] = held - torch.cuda.memory_allocated()
            log(f"  released: {rec['freed']:,} B freed (its cache "
                f"{cache_bytes:,} B)")
            need(rec["freed"] >= cache_bytes,
                 f"{path} life {life}: the dead engine's release freed "
                 f"{rec['freed']} B, less than its cache's {cache_bytes}")
        need([r["killed"] for r in lives] == [True, True, False],
             f"{path}: lives {[r['killed'] for r in lives]}, expected two "
             "kills and a drain")
        try:
            outcomes = check_durable(path, root, dict(enumerate(oracle)),
                                     len(prompts))
        except AssertionError as e:
            raise SmokeFailure(str(e)) from None
        need(outcomes == {"done": len(prompts)},
             f"{path}: durable outcomes {outcomes}, expected all done")
        streams, _ = snaplib.journaled_streams(root)
        counts = dict(launches)
        need(counts == expected_launches(cfg, params, ticks),
             f"{path}: kernel launch counts do not match layers x calls x "
             "ticks over the lives")
        spread = (lives[-1]["max_memory_allocated"] /
                  lives[0]["max_memory_allocated"] - 1)
        need(abs(spread) <= MEMORY_SPREAD,
             f"{path}: life 2's peak memory is {spread:+.1%} of life 0's")
        dropped = engine.drop_prefix_cache()
        pool = engine.pool_stats()
        need(pool["free"] == pool["total"] and not pool["leased"],
             f"{path}: the pool is not whole: {pool}")
        ref = results["serving"]["strategy2-paged-int8-prefix"]["runs"][1]
        last = lives[-1]
        log(f"  durable outcomes {outcomes}, every stream the oracle's, "
            f"each rid terminal once; {ticks} ticks over 3 "
            f"lives; drop_prefix_cache() {dropped} nodes, pool {pool}; "
            f"peak memory life 2 / life 0 {spread:+.2%}; life 2 "
            f"{last['tokens_per_s']:.1f} tokens/s, ITL p50 "
            f"{last['itl_p50_s'] * 1e3:.2f} ms (prefix run 1: "
            f"{ref['tokens_per_s']:.1f} tokens/s, "
            f"{ref['itl_p50_s'] * 1e3:.2f} ms)")
        results.setdefault("serving", {})[path] = {
            "lives": lives, "ticks": ticks, "launches": counts,
            "memory_spread": spread,
            "pool_after_drop": pool,
            "prefix_run1": {"tokens_per_s": ref["tokens_per_s"],
                            "itl_p50_s": ref["itl_p50_s"]}}
        replay_without_sync(torch, engine, path)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts, [streams[i] for i in range(len(prompts))]


# the paths whose graphs are held against eager steps, and traced
REPLAY_PATHS = ("dense", "dense-spec", "strategy2-paged-int8", "xlstm-dense",
                "starcoder2-dense", "granite-moe-dense", "qwen3-8b-dense",
                "gemma-2b-dense", "whisper-dense", "zamba2-dense",
                "qwen2-vl-dense")
TRACE_PATHS = ("dense", "strategy2-paged", "xlstm-dense", "starcoder2-dense",
               "granite-moe-dense", "gemma-2b-dense", "whisper-dense",
               "zamba2-dense", "qwen2-vl-dense")
# no served transformer tick or admission copies a tensor this large (a
# tied LM head read through a transposed copy would: 151 MB a tick on
# granite, 79.7 MB on whisper)
LARGE_COPY_BYTES = 64 << 20


def live_inputs(engine, name, width, rng):
    """Host inputs of a tick with live rows: a dead row, a decode row and
    prompt chunks (mixed), or a masked row (decode); paged rows take
    distinct pool blocks in a scrambled order (the pool is whole after a
    drain)."""
    import numpy as np
    b = engine.batch
    per_row = (engine.pool_blocks // b * engine.block_size if engine.paged
               else engine.max_len)
    if name == "mixed":
        q_lens = rng.integers(1, width + 1, b).astype(np.int32)
        q_lens[0], q_lens[1] = 0, 1
        lengths = rng.integers(0, per_row - width + 1, b).astype(np.int32)
        host = {"tokens": rng.integers(0, engine.cfg.vocab_size,
                                       (b, width)).astype(np.int64),
                "lengths": lengths, "q_lens": q_lens}
        reach = lengths + q_lens
    else:
        mask = np.ones(b, bool)
        mask[0] = False
        lengths = rng.integers(1, per_row + 1, b).astype(np.int32)
        host = {"tokens": rng.integers(0, engine.cfg.vocab_size,
                                       (b, 1)).astype(np.int64),
                "lengths": lengths, "write_mask": mask}
        reach = lengths
    if engine.paged:
        table = np.full((b, engine.n_pages), engine._null_block, np.int32)
        free = rng.permutation(engine.pool_blocks)
        k = 0
        for i in range(b):
            n = -(-int(reach[i]) // engine.block_size)
            table[i, :n] = free[k:k + n]
            k += n
        host["page_table"] = table
    return host


def check_admit_replay(torch, engine, params, frames_n, path):
    """The ``("admit", F)`` graph replayed on the engine's static row
    against its function run eagerly on a copy, from the same seeded
    frames: every leaf of the row bitwise equal; no copy of
    ``LARGE_COPY_BYTES`` or more in the captured function; the replay's
    device ms (CUDA events, median of 5) and host ms."""
    import numpy as np
    tick = engine.cache_compiles.get("admit", frames_n, None)
    row = engine._admit_row
    frames = audio_frames(engine.cfg, 1, seed=9)[0][None]
    dev = torch.from_numpy(frames).to(DEVICE)
    copy = clone_tree(row)
    big = large_copies(torch, lambda: tick.fn(params, copy, frames=dev))
    tick(params, row, frames=frames)
    torch.cuda.synchronize()
    diff = differing_slices(torch, copy, row)
    ms, host = [], []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.record()
        tick(params, row, frames=frames)
        e.record()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    out = {"cache_slices_differing": diff, "large_copies": big,
           "replay_ms": float(np.median(ms)), "host_ms": float(np.median(host))}
    log(f"  admit-{frames_n}: replay vs eager, row slices differing {diff}; "
        f"copies of >= {LARGE_COPY_BYTES >> 20} MiB {big or 'none'}; replay "
        f"{out['replay_ms']:.3f} ms on the device, {out['host_ms']:.3f} ms "
        "on the host (median of 5)")
    need(not diff, f"{path} admit-{frames_n}: the graph replay is not "
         "bitwise the eager admission")
    need(not big, f"{path} admit-{frames_n}: the admission copies {big}")
    del copy
    return out


def clone_tree(tree):
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def tick_keys(engine):
    """The (name, width) of every mixed and decode key, width None for
    decode."""
    return [(n, None if n == "decode" else b)
            for n, b in sorted(engine.cache_compiles.keys())
            if n in ("mixed", "decode")]


def check_graph_replay(torch, engine, params, results, path):
    """Each key's graph replayed once on the engine's cache against its
    function run eagerly on a copy, from the same live inputs: logits,
    tokens and every cache or state leaf bitwise equal."""
    import numpy as np
    rng = np.random.default_rng(9)
    out = {}
    for name, width in tick_keys(engine):
        tick = engine._executable(name, width)
        host = live_inputs(engine, name, width or engine.batch, rng)
        copy = clone_tree(engine.cache)
        tok_e, logits_e = tick.fn(params, copy, **{
            k: torch.from_numpy(a).to(DEVICE) for k, a in host.items()})
        tok_g, logits_g = tick(params, engine.cache, **host)
        torch.cuda.synchronize()
        diff = differing_slices(torch, copy, engine.cache)
        same = torch.equal(logits_e, logits_g) and torch.equal(tok_e, tok_g)
        key = f"{name}-{width or engine.batch}"
        out[key] = {"logits_equal": same, "cache_slices_differing": diff}
        log(f"  {key}: replay vs eager logits bitwise {same}; cache slices "
            f"differing {diff}")
        need(same and not diff, f"{path} {key}: the graph replay is not "
             "bitwise the eager step")
        del copy
    for name, bucket in sorted(engine.cache_compiles.keys()):
        if name == "admit":
            out[f"admit-{bucket}"] = check_admit_replay(torch, engine,
                                                        params, bucket, path)
    results.setdefault("graph_replay", {})[path] = out


def device_activity(torch, prof):
    """(device-busy ms, device operations, the hand kernels' share of the
    device time, the 8 longest operations by name as (name, ms, count)) of
    a profiled window: the union of the card's kernel, copy and set
    intervals and their count; a hand kernel is one of the ``repro``
    namespace.  (None, 0, None, []) when the profiler saw no device
    activity."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                           n + 1)
    total = sum(ms for ms, _ in by_name.values())
    hand = sum(ms for name, (ms, _) in by_name.items() if "repro" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return ((busy / 1e3 if spans else None), len(spans),
            (hand / total if total else None),
            [(name[:90], ms, n) for name, (ms, n) in top])


# the MoE kernels by a pattern of their traced names: the grouped experts
# by their template's tail (EPI 1 and GATHER: gate/up; EPI 0: down), so the
# grid-per-expert kernels of a parent tree are named as the ring's; the
# combine in the norm by rmsnorm.cu's template code 2.  A tick launches
# each once a layer (every layer of an MoE config is one): a kernel the
# names miss, or a trace that lost launches, shows as fewer
# (``moe_trace``)
MOE_KERNELS = (("moe_route", r"moe_route_kernel"),
               ("moe_gate_up_w4a16", r"moe_.*, 1, true>"),
               ("moe_down_w4a16", r"moe_.*, 0, false>"),
               ("combine_add_rmsnorm", r"add_rmsnorm_kernel<[^>]*, 2>\("))
# the chain those replaced, as a parent tree's trace names it
# (``tools/moe_ab.py``): the routers' ``dense_matmul`` (the tied head reads
# its weight transposed: ``true``), the combine, and the norm with a
# residual add (2L a tick there, L here: the attention's adds)
MOE_CHAIN_KERNELS = (
    ("router dense_matmul", r"dense_mma_kernel<.*, false>\("),
    ("moe_combine", r"moe_combine_kernel"),
    ("add_rmsnorm", r"add_rmsnorm_kernel<[^>]*, (true|1)>\("))


def moe_kernel_ms(torch, prof) -> dict:
    """Device ms and launches of each MoE kernel (``MOE_KERNELS``) and of
    the chain they replaced (``MOE_CHAIN_KERNELS``) in a profiled
    window."""
    import re
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for kernel, pattern in MOE_KERNELS + MOE_CHAIN_KERNELS:
            if re.search(pattern, e.name):
                ms, n = out.get(kernel, (0.0, 0))
                out[kernel] = (ms + (e.time_range.end - e.time_range.start)
                               / 1e3, n + 1)
                break
    return out


def moe_trace(torch, prof, cfg):
    """None for a config without experts; else the MoE kernels' (ms,
    launches) in the window (``moe_kernel_ms``), the launches a tick makes
    of each (one a layer) and whether the window saw all of them."""
    if not cfg.is_moe:
        return None
    ms = moe_kernel_ms(torch, prof)
    return {"ms": ms, "expected": cfg.n_layers,
            "complete": all(ms.get(kernel, (0.0, 0))[1] == cfg.n_layers
                            for kernel, _ in MOE_KERNELS)}


# the hybrid path's kernels as a trace names them: the fused Mamba2 step
# (the cell and the gated norm), kernel 3 at head dim 112 (its split
# kernel) and the W4A16 tile of kernels 1 and 2 (in_proj and out_proj; q,
# k, v, o, the FFN's gate/up and down); (name, pattern, launches a step per
# Mamba2 layer, per site)
HYBRID_KERNELS = (("mamba_cell_gated", r"mamba_cell_gated_kernel", 1, 0),
                  ("mixed_flash_attention d=112",
                   r"mixed_flash_mma_kernel<112", 0, 1),
                  ("w4a16_mma", r"w4a16_mma_kernel", 2, 6))


def hybrid_trace(torch, prof, cfg, columns):
    """None outside the hybrid family; else each hybrid kernel's device ms
    and launches in a profiled window of a tick of ``columns`` decode
    steps, the launches the tick makes of each and whether the window saw
    them all (``complete``: the in-graph ms of a window that lost events
    is an undercount)."""
    import re
    if cfg.family != "hybrid":
        return None
    sites = cfg.n_layers // cfg.shared_attn_every
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for kernel, pattern, _, _ in HYBRID_KERNELS:
            if re.search(pattern, e.name):
                ms, n = out.get(kernel, (0.0, 0))
                out[kernel] = (ms + (e.time_range.end - e.time_range.start)
                               / 1e3, n + 1)
                break
    expected = {k: columns * (a * cfg.n_layers + b * sites)
                for k, _, a, b in HYBRID_KERNELS}
    expected["w4a16_mma"] += columns       # the lm_head
    return {"ms": out, "expected": expected,
            "complete": all(out.get(k, (0.0, 0))[1] >= n
                            for k, n in expected.items())}


# device operations of the glue the fused kernels replaced, by a piece of
# their kernel names: RoPE's cos, sin and cat, and bf16 adds (the q/k/v
# bias and residual adds)
GLUE_OPS = {"cos": "cos_kernel", "sin": "sin_kernel",
            "cat": "CatArrayBatchedCopy",
            "bf16_add": "CUDAFunctor_add<c10::BFloat16>"}


def glue_census(torch, prof) -> dict:
    """How many device operations of a profiled window are ``GLUE_OPS``."""
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return {k: sum(pat in n for n in names) for k, pat in GLUE_OPS.items()}


def host_copies(torch, fn) -> int:
    """How many copies from the card to the host ``fn`` asks for, counted
    at PyTorch's dispatcher (``_to_copy`` / ``copy_`` from a card tensor
    into a host one).  Deterministic where the profiler is not: its
    records of one unchanged xlstm-dense replay vary by tens to thousands
    of device operations and can lose the tick's copy back
    (``tools/trace_repeat.py`` profiles one tick many times)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    found = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            if name in ("_to_copy", "copy_"):
                src, dst = ((args[1], args[0]) if name == "copy_"
                            else (args[0], out))
                if src.device.type != "cpu" and dst.device.type == "cpu":
                    found.append(name)
            return out

    with Count():
        fn()
    return len(found)


def large_copies(torch, fn, min_bytes=LARGE_COPY_BYTES) -> list:
    """(op, bytes) of every copy ``fn`` asks for (``copy_``, ``_to_copy``,
    ``clone``, counted at PyTorch's dispatcher) whose output holds at least
    ``min_bytes``: what a captured graph of ``fn`` would copy every
    replay."""
    from torch.utils._python_dispatch import TorchDispatchMode
    found = []

    class Big(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in ("copy_", "_to_copy", "clone"):
                t = out if name != "copy_" else args[0]
                n = t.numel() * t.element_size()
                if n >= min_bytes:
                    found.append((name, n))
            return out

    with Big():
        fn()
    return found


# device operations of a replayed dense decode-4 tick: 365 without the
# finiteness reduction, and its two (``torch.aminmax``)
DENSE_DECODE_OPS = 367


def trace_ticks(torch, engine, params, results, path, strict=True):
    """One decode tick and one mixed tick (the widest captured) run eagerly
    on a copy of the cache and replayed, from the same live inputs: host
    ms (the call's return, so the host's own time), wall ms (to the end of
    the device's work; medians of 3, no profiler), and under
    ``torch.profiler`` the device-busy ms and the device operations (for a
    replay: the graph's kernel, copy and set nodes).  ``strict``: a
    replayed transformer tick must run none of ``GLUE_OPS`` (off: recorded
    only, to trace a tree that still runs them)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(10)
    keys = tick_keys(engine)
    mixed = [k for k in keys if k[0] == "mixed"]
    out = {}
    for name, width in [k for k in keys if k[0] == "decode"] + mixed[-1:]:
        tick = engine._executable(name, width)
        host = live_inputs(engine, name, width or engine.batch, rng)
        dev = {k: torch.from_numpy(a).to(DEVICE) for k, a in host.items()}
        copy = clone_tree(engine.cache)
        calls = {"eager": lambda: tick.fn(params, copy, **dev),
                 "replay": lambda: tick(params, engine.cache, **host)}
        key = f"{name}-{width or engine.batch}"
        # the function a graph captures, at the dispatcher: its large
        # copies would be nodes of every replay
        big = large_copies(torch, calls["eager"])
        out[f"{key}-large-copies"] = big
        log(f"  {key}: copies of >= {LARGE_COPY_BYTES >> 20} MiB in the "
            f"captured step: {big or 'none'}")
        need(not strict or engine.cfg.family == "ssm" or not big,
             f"{path} {key}: the step copies {big} (a graph would copy it "
             "every tick)")
        for mode, call in calls.items():
            host_ms, wall_ms = [], []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                host_ms.append((t1 - t0) * 1e3)
                wall_ms.append((t2 - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            busy, n_ops, hand, top = device_activity(torch, prof)
            # the profiler can lose a replay's events: an in-graph ms
            # summed over fewer launches than the tick made is marked
            moe = moe_trace(torch, prof, engine.cfg)
            hyb = hybrid_trace(torch, prof, engine.cfg, width or 1)
            glue = glue_census(torch, prof)
            row = {"host_ms": float(np.median(host_ms)),
                   "wall_ms": float(np.median(wall_ms)),
                   "device_busy_ms": busy, "device_ops": n_ops,
                   "hand_kernel_share": hand, "glue_ops": glue, "top": top}
            if moe is not None:
                row["moe_ms"] = moe["ms"]
                row["moe_expected"] = moe["expected"]
                row["moe_complete"] = moe["complete"]
                # a kernel the names do not find at all is a renamed one
                need(not strict or all(
                    kernel in moe["ms"] for kernel, _ in MOE_KERNELS),
                    f"{path} {key} {mode}: the trace names no launch of "
                    f"{[k for k, _ in MOE_KERNELS if k not in moe['ms']]}")
            if hyb is not None:
                row["hybrid_ms"] = hyb["ms"]
                row["hybrid_expected"] = hyb["expected"]
                row["hybrid_complete"] = hyb["complete"]
            out[f"{key}-{mode}"] = row
            log(f"  {key} {mode}: host {row['host_ms']:.3f} ms, wall "
                f"{row['wall_ms']:.3f} ms, device busy "
                + (f"{busy:.3f} ms" if busy is not None else "not seen by "
                   "the profiler") + f", {n_ops} device operations"
                + (f", hand kernels {hand:.1%} of the device time"
                   if hand is not None else ""))
            if mode == "replay" and hasattr(engine, "_fetch"):
                # the tick as the engine serves it: the replay and its
                # one copy back (ids and finiteness); a parent tree
                # without ``_fetch`` is traced without it.  The copies it
                # asks for are counted at the dispatcher on every path;
                # the profiler's count is held on the dense decode tick,
                # where its records are stable (``host_copies``)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    engine._fetch(*call(), False)
                    torch.cuda.synchronize()
                row["dtoh_copies"] = sum(
                    "DtoH" in e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
                row["dtoh_requested"] = host_copies(
                    torch, lambda: engine._fetch(*call(), False))
                log(f"    with the engine's fetch: "
                    f"{row['dtoh_copies']} device-to-host copies traced, "
                    f"{row['dtoh_requested']} asked for")
                need(not strict or row["dtoh_requested"] == 1,
                     f"{path} {key}: a served tick asks for "
                     f"{row['dtoh_requested']} device-to-host copies, not "
                     "one")
                need(not strict or path != "dense" or name != "decode"
                     or row["dtoh_copies"] == 1,
                     f"{path} {key}: a served tick makes "
                     f"{row['dtoh_copies']} device-to-host copies, not one")
            if mode == "replay":
                need(not strict or path != "dense" or name != "decode"
                     or n_ops <= DENSE_DECODE_OPS, f"{path} {key}: "
                     f"{n_ops} device operations > {DENSE_DECODE_OPS}")
                for name, ms, n in top:
                    log(f"    {ms:8.3f} ms {n:6d}x {name}")
                for kernel, (ms, n) in row.get("hybrid_ms", {}).items():
                    want = row["hybrid_expected"][kernel]
                    log(f"    in the graph: {kernel} {ms:.4f} ms over {n} "
                        f"launches (a tick makes {want})"
                        + ("" if n >= want else
                           " (the trace lost some: an undercount)"))
                for kernel, (ms, n) in row.get("moe_ms", {}).items():
                    log(f"    in the graph: {kernel} {ms:.4f} ms over {n} "
                        f"launches ({row['moe_expected']} layers)"
                        + ("" if n >= row["moe_expected"] else
                           " (the trace lost some: an undercount)"))
                log(f"    glue operations {glue}")
                need(not strict or engine.cfg.family == "ssm"
                     or not any(glue.values()),
                     f"{path} {key}: the replayed tick still runs RoPE, "
                     f"cat or bf16 add operations {glue}")
        del copy
    results.setdefault("traces", {})[path] = out


def check_no_sync(torch, cfg, params, results, path):
    """A mixed step (ragged q_lens, a dead row), a decode step (a masked
    row), a speculating engine's verify tick (``all_logits``, the greedy
    tokens and the last live logits) and, where the config shares blocks,
    a copy-on-write of one pool block, on device inputs under
    ``torch.cuda.set_sync_debug_mode("error")``: any host read raises, so
    none happens and each step can be captured."""
    from repro_torch.kernels import _build
    from repro_torch.models import api
    from repro_torch.serving.engine import _mixed_executable_spec
    b, c = 4, 16
    cache = fresh_cache(torch, cfg, params, b, 64)
    audio = cfg.family == "audio"
    if audio:
        row = api.init_cache(cfg, 1, 64, DEVICE)
        frames = torch.from_numpy(audio_frames(cfg, 1, seed=3)[0][None]).to(
            DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (b, c), generator=g,
                           device=DEVICE)
    lengths = torch.tensor([3, 0, 9, 20], dtype=torch.int32, device=DEVICE)
    q_lens = torch.tensor([5, 0, 16, 1], dtype=torch.int32, device=DEVICE)
    kw = {}
    if api.has_paged_kv(cfg):
        kw["page_table"] = torch.arange(b * 4, dtype=torch.int32,
                                        device=DEVICE).reshape(b, 4)
    write_mask = q_lens > 0
    decode_lengths = lengths + q_lens + 1
    verify = _mixed_executable_spec(cfg)
    share = api.supports_prefix_cache(cfg)
    blocks = torch.tensor([[2], [5]], device=DEVICE)
    _build.prepare()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        api.mixed_step(cfg, params, cache, tokens, lengths, q_lens, **kw)
        api.decode_step(cfg, params, cache, tokens[:, :1], decode_lengths,
                        write_mask=write_mask, **kw)
        if api.supports_speculation(cfg):
            verify(params, cache, tokens[:, :8], lengths,
                   q_lens.clamp(max=8), **kw)
        if share:
            api.copy_pool_block(cfg, cache, blocks[0], blocks[1])
        if audio:
            api.admit_into(cfg, params, row, {"frames": frames})
            api.insert_request(cfg, cache, row, 2)
    except RuntimeError as e:
        raise SmokeFailure(f"{path}: a step synchronised with the host: "
                           f"{e}") from None
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    results.setdefault("no_sync", {})[path] = True
    log("  a mixed step, a decode step"
        + (", a verify tick" if api.supports_speculation(cfg) else "")
        + (" and a copy-on-write" if share else "")
        + (" and an admission (encoder, cross K/V, insert)" if audio else "")
        + " under set_sync_debug_mode(\"error\"): no host synchronisation")


# -- phase 6: whole-prompt prefill and full-sequence forward ---------------

# bf16 logits of two routes through 28-32 layers of random weights, relative
# to the largest |logit|: a few bf16 roundings (2^-8) per layer that
# attention tiles in another order, carried by the residual stream
PREFILL_TOL = 5e-2


def expected_full_launches(cfg, params, calls, prefills=0):
    """Launches of ``calls`` forward or slot-prefill calls, ``prefills`` of
    them prefills: a serving tick's projection and FFN kernels per layer
    and the lm_head once, and its norms: every residual add in the launch
    of the norm after it (``add_rmsnorm`` or ``add_layernorm`` 2L times,
    the last layer's into ``ln_f``) and layer 0's ``ln_attn`` alone; kernel
    7 in place of the mixed attention kernel; no epilogue (these routes
    keep the q/k/v bias and RoPE apart) and, in a prefill, ``kv_write``
    once a layer (the whole prompt's K/V into the slot cache)."""
    from repro_torch.kernels.decode_flash import VARIANTS
    L = cfg.n_layers
    per = expected_launches(cfg, params, 1)
    per.pop(VARIANTS[(cfg.kv_layout == "paged", cfg.kv_quant == "int8")])
    per.pop("qkv_rope_write")
    per["flash_attention"] = L
    out = {k: calls * n for k, n in per.items()}
    if prefills:
        out["kv_write"] = prefills * L
    return out


def greedy_after_prefill(torch, cfg, params, prompt, n_new, max_len,
                         frames=None):
    """Prefill one prompt (and its audio ``frames``), then decode greedily:
    the first ``n_new`` tokens."""
    from repro_torch.models import api
    batch = {"tokens": torch.tensor(prompt[None], device=DEVICE)}
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames[None]).to(DEVICE)
    logits, cache = api.prefill(cfg, params, batch, max_len)
    out, n = [], len(prompt)
    while True:
        out.append(int(logits[0].argmax()))
        if len(out) == n_new:
            return out
        n += 1
        logits, cache = api.decode_step(
            cfg, params, cache, torch.tensor([[out[-1]]], device=DEVICE), [n])


def oracle_margin(torch, cfg, params, prompt, stream, step, frames=None):
    """Top-2 logit margin of the sequential oracle where it picks
    ``stream[step]``: the prompt and ``stream[:step]`` fed one token at a
    time through ``decode_step``."""
    from repro_torch.models import api
    cache = start_cache(torch, cfg, params, SERVE_MAX_LEN, frames)
    for n, tok in enumerate(list(prompt) + list(stream[:step]), start=1):
        logits, cache = api.decode_step(
            cfg, params, cache, torch.tensor([[int(tok)]], device=DEVICE),
            [n])
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def check_stream(torch, cfg, params, prompt, got, want, bound, what,
                 frames=None):
    """``got`` equals the engine's ``want`` (which phase 5 held equal to
    the oracle); or, where it leaves it, the oracle's top-2 margin is below
    ``bound`` (a near tie that two routes' bf16 roundings may flip)."""
    if got == want:
        return {"equal": True}
    step = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    margin = oracle_margin(torch, cfg, params, prompt, want, step, frames)
    log(f"  {what}: first divergence at step {step}, oracle top-2 margin "
        f"{margin} (bound {bound:.4g})")
    need(margin < bound, f"{what}: diverges from the engine at step {step} "
         f"with a top-2 margin {margin} >= {bound:.4g}")
    return {"equal": False, "step": step, "oracle_top2_margin": margin}


def check_prefill_forward(torch, cfg, params, results, path, counts,
                          engine_stream):
    """Phase 6 on one model's dense weights: (a) forward ≡ prefill at the
    last position, launch counts; (b) slot prefill vs the mixed-step route;
    (c) greedy prefill + decode vs the engine; (d) qwen-7b only: 8192
    tokens chunked vs one shot."""
    import numpy as np
    from repro_torch.kernels._build import launches
    from repro_torch.models import api
    res = results.setdefault("prefill", {}).setdefault(path, {})
    rng = np.random.default_rng(6)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 512)),
                        device=DEVICE)
    # (a) forward and prefill: the counts of this run are the path's own
    torch.cuda.synchronize()
    launches.clear()
    t0 = time.perf_counter()
    logits, aux = api.forward(cfg, params, {"tokens": toks})
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    t0 = time.perf_counter()
    last, cache = api.prefill(cfg, params, {"tokens": toks}, 528)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    got = dict(launches)
    counts[f"{path}-prefill"] = got
    expect = expected_full_launches(cfg, params, 2, prefills=1)
    same = torch.equal(logits[:, -1], last)
    log(f"  (a) forward B=2 S=512 {t_fwd * 1e3:.1f} ms, prefill "
        f"{t_pre * 1e3:.1f} ms; logits {tuple(logits.shape)} finite "
        f"{bool(torch.isfinite(logits).all())}; last position bitwise = "
        f"prefill {same}; launches {got} expected {expect}")
    res["a"] = {"forward_s": t_fwd, "prefill_s": t_pre, "bitwise": same,
                "launches": got, "expected_launches": expect}
    need(logits.shape == (2, 512, cfg.vocab_size)
         and bool(torch.isfinite(logits).all()) and float(aux) == 0.0,
         f"{path}: forward logits are not finite of shape (2, 512, V)")
    need(same, f"{path}: forward's last position is not bitwise prefill's")
    need(got == expect, f"{path}: forward + prefill launches {got} != "
         f"{expect}")
    del logits
    # (b) the slot prefill against the mixed-step route on the same prompts
    bl, bcache = api._bulk_prefill(cfg, params, toks, 528)
    diff = max_errs(last, bl)
    layers = [max_errs(cache["k"][i], bcache["k"][i])[1]
              for i in range(cfg.n_layers)]
    l0 = all(torch.equal(cache[n][0], bcache[n][0]) for n in cache)
    log(f"  (b) prefill vs mixed_step route: layer-0 K/V bitwise {l0}; "
        f"logits max_abs {diff[0]:.4g} rel {diff[1]:.4g} (tol "
        f"{PREFILL_TOL}); K rel diff by layer max {max(layers):.4g}")
    res["b"] = {"layer0_bitwise": l0, "logits_max_abs": diff[0],
                "logits_rel": diff[1], "k_rel_by_layer": layers}
    need(l0, f"{path}: layer-0 K/V differ between the two prefill routes")
    need(diff[1] <= PREFILL_TOL and max(layers) <= PREFILL_TOL,
         f"{path}: the prefill routes differ by {diff[1]:.4g} (logits), "
         f"{max(layers):.4g} (K) > {PREFILL_TOL}")
    del cache, bcache
    # (c) greedy prefill + decode against the engine's stream
    prompt = workload(cfg)[-1]
    stream = greedy_after_prefill(torch, cfg, params, prompt,
                                  SERVE_NEW_TOKENS, SERVE_MAX_LEN)
    res["c"] = check_stream(torch, cfg, params, prompt, stream,
                            engine_stream, diff[0], f"{path} (c)")
    log(f"  (c) greedy prefill + {SERVE_NEW_TOKENS - 1} decode steps vs the "
        f"engine's stream (200-token prompt): {res['c']}")
    if cfg.name == "qwen-7b":
        res["d"] = check_chunked_prefill(torch, cfg, params)
    torch.cuda.empty_cache()


VLM_IMAGE_SIDE, VLM_TEXT = 16, 300     # a 16 x 16 patch grid, then text


def vlm_grid_ids(torch, b, side, n_text):
    """M-RoPE ids (3, B, side^2 + n_text) of a ``side`` x ``side`` image's
    patches followed by text, as Qwen2-VL lays them out: the image's
    temporal id 0, its height and width ids the patch's row and column;
    the text continues all three streams from ``side``."""
    r = torch.arange(side * side, dtype=torch.int32,
                     device=DEVICE) // side
    c = torch.arange(side * side, dtype=torch.int32, device=DEVICE) % side
    img = torch.stack([torch.zeros_like(r), r, c])
    text = torch.arange(n_text, dtype=torch.int32, device=DEVICE) + side
    ids = torch.cat([img, text[None].expand(3, n_text)], dim=1)
    return ids[:, None].expand(3, b, ids.shape[1]).contiguous()


@contextlib.contextmanager
def flash_held_against_plain(errs):
    """Inside the block every ``ops.attention`` call on the card is also
    run through kernel 7's plain version on the same inputs (which
    launches nothing), and its relative error appended to ``errs``."""
    from repro_torch.kernels import ops
    saved = ops.attention

    def held(q, k, v, **kw):
        got = saved(q, k, v, **kw)
        errs.append(max_errs(got, saved(q, k, v, impl="torch", **kw))[1])
        return got
    ops.attention = held
    try:
        yield
    finally:
        ops.attention = saved


def check_vlm_prefill(torch, cfg, params, results, path, counts,
                      engine_stream):
    """Phase 6 on the vlm family: the text-only checks of every dense
    model (``check_prefill_forward``: forward's last position bitwise
    prefill's, launches, the two prefill routes, greedy prefill + decode
    against the engine); then ``forward`` with the stubbed frontend's
    output: (v) B = 2, 256 seeded patch embeddings of a 16 x 16 image
    before 300 text tokens (S = 556, ragged against kernel 7's tiles) at
    the image's distinct M-RoPE ids, every layer's kernel 7 call held
    against its plain version on the same rotated q/k (rep 7), launches
    exact (the path ``<model>-vision``), logits finite, and the ids
    reaching the rotation (the canonical equal ids give other logits);
    (w) embeddings that are the embedding table's rows of 256 tokens, at
    the canonical ids, give bitwise ``forward`` of those tokens before
    the text."""
    import numpy as np
    from repro_torch.kernels._build import launches
    from repro_torch.models import api, transformer
    check_prefill_forward(torch, cfg, params, results, path, counts,
                          engine_stream)
    res = results["prefill"][path]
    rng = np.random.default_rng(35)
    b, n = 2, VLM_IMAGE_SIDE ** 2
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (b, VLM_TEXT)),
                        device=DEVICE)
    vis = torch.from_numpy(
        (rng.standard_normal((b, n, cfg.d_model)) * 0.02).astype(
            np.float32)).to(DEVICE)
    ids = vlm_grid_ids(torch, b, VLM_IMAGE_SIDE, VLM_TEXT)
    errs = []
    torch.cuda.synchronize()
    launches.clear()
    t0 = time.perf_counter()
    with flash_held_against_plain(errs):
        logits, _ = transformer.forward(cfg, params, toks, positions=ids,
                                        vision_embeds=vis)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    got = dict(launches)
    counts[f"{path}-vision"] = got
    expect = expected_full_launches(cfg, params, 1)
    canon, _ = api.forward(cfg, params, {"tokens": toks,
                                         "vision_embeds": vis})
    moved = not torch.equal(canon[:, -1], logits[:, -1])
    s = n + VLM_TEXT
    log(f"  (v) forward B={b} with {n} patch embeddings + {VLM_TEXT} tokens "
        f"(S={s}) at the image's M-RoPE ids {t_fwd * 1e3:.1f} ms (kernel 7 "
        f"held per call); logits {tuple(logits.shape)} finite "
        f"{bool(torch.isfinite(logits).all())}; kernel 7 vs its plain "
        f"version over {len(errs)} calls: max rel {max(errs):.3g} (tol "
        f"1e-2); equal ids give other logits {moved}; launches {got} "
        f"expected {expect}")
    res["v"] = {"forward_s": t_fwd, "S": s, "flash_calls": len(errs),
                "flash_max_rel_err": max(errs), "ids_move_logits": moved,
                "launches": got, "expected_launches": expect}
    need(logits.shape == (b, s, cfg.vocab_size)
         and bool(torch.isfinite(logits).all()),
         f"{path}: the vision forward's logits are not finite of shape "
         f"({b}, {s}, V)")
    need(len(errs) == cfg.n_layers and max(errs) <= 1e-2,
         f"{path}: kernel 7 over the image and text differs from its plain "
         f"version by {max(errs):.3g} (> 1e-2) in {len(errs)} calls")
    need(got == expect, f"{path}: the vision forward's launches {got} != "
         f"{expect}")
    need(moved, f"{path}: the image's M-RoPE ids do not reach the logits")
    del logits, canon
    img = torch.tensor(rng.integers(0, cfg.vocab_size, (b, n)),
                       device=DEVICE)
    as_vis, _ = api.forward(cfg, params, {
        "tokens": toks, "vision_embeds": params["embed"][img]})
    as_text, _ = api.forward(cfg, params, {
        "tokens": torch.cat([img, toks], dim=1)})
    same = torch.equal(as_vis, as_text)
    log(f"  (w) the embedding rows of 256 tokens as vision embeddings "
        f"bitwise forward of those tokens before the text: {same}")
    res["w"] = {"bitwise": same}
    need(same, f"{path}: embeddings put before the tokens differ from the "
         "same rows looked up")
    torch.cuda.empty_cache()


def check_audio_prefill(torch, cfg, params, results, path, counts,
                        engine_stream):
    """Phase 6 on the audio family: (a) ``forward`` and the slot
    ``prefill`` at B=2, S=256 over seeded frames: the last position's
    logits bitwise equal, launch counts exact (the encoder, each decoder
    layer's cross K/V, kernel 7 causal and over the audio; the prefill's
    ``kv_write`` a layer); (c) greedy prefill + decode of phase 5's
    200-token request (with its frames) against the engine's stream."""
    import numpy as np
    from repro_torch.kernels._build import launches
    from repro_torch.models import api
    res = results.setdefault("prefill", {}).setdefault(path, {})
    rng = np.random.default_rng(6)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 256)),
                        device=DEVICE)
    batch = {"tokens": toks, "frames": torch.from_numpy(np.stack(
        audio_frames(cfg, 2, seed=6))).to(DEVICE)}
    torch.cuda.synchronize()
    launches.clear()
    t0 = time.perf_counter()
    logits, aux = api.forward(cfg, params, batch)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    t0 = time.perf_counter()
    last, cache = api.prefill(cfg, params, batch, SERVE_MAX_LEN)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    got = dict(launches)
    counts[f"{path}-prefill"] = got
    expect = expected_launches_audio(cfg, params, 2, 2, full_sequence=True)
    expect["kv_write"] = cfg.n_layers
    same = torch.equal(logits[:, -1], last)
    log(f"  (a) forward B=2 S=256 over {cfg.encoder_frames} frames "
        f"{t_fwd * 1e3:.1f} ms, prefill {t_pre * 1e3:.1f} ms; logits "
        f"{tuple(logits.shape)} finite {bool(torch.isfinite(logits).all())};"
        f" last position bitwise = prefill {same}; launches {got} expected "
        f"{expect}")
    res["a"] = {"forward_s": t_fwd, "prefill_s": t_pre, "bitwise": same,
                "launches": got, "expected_launches": expect}
    need(logits.shape == (2, 256, cfg.vocab_size)
         and bool(torch.isfinite(logits).all()) and float(aux) == 0.0,
         f"{path}: forward logits are not finite of shape (2, 256, V)")
    need(same, f"{path}: forward's last position is not bitwise prefill's")
    need(got == expect, f"{path}: forward + prefill launches {got} != "
         f"{expect}")
    del logits, cache
    prompts = workload(cfg)
    frames = audio_frames(cfg, len(prompts))[-1]
    stream = greedy_after_prefill(torch, cfg, params, prompts[-1],
                                  SERVE_NEW_TOKENS, SERVE_MAX_LEN, frames)
    res["c"] = check_stream(torch, cfg, params, prompts[-1], stream,
                            engine_stream, PREFILL_TOL, f"{path} (c)",
                            frames)
    log(f"  (c) greedy prefill + {SERVE_NEW_TOKENS - 1} decode steps vs the "
        f"engine's stream (200-token prompt and its frames): {res['c']}")
    torch.cuda.empty_cache()


# forward (the mLSTM's parallel and chunked forms, kernel 8 over the
# sequence) against prefill (512 recurrent steps): two forms of one function
# through the path's blocks, relative to the largest |logit|, held in
# float32 (the bound was set through all 48).  The
# gap grows with depth: the mLSTM readout divides by max(|q . n|, e^-m),
# which random weights bring near zero, so a rounding apart in one block is
# amplified by the next.  In bf16 (the served dtype) the two forms part
# after a few blocks, so that gap is recorded, not held.
XLSTM_PREFILL_TOL = 1e-2


def check_xlstm_prefill(torch, cfg, params, results, path, counts,
                        engine_stream):
    """Phase 6 on the xLSTM: (a) ``forward`` at B=2 x S=512, launches
    exact (kernel 8 once per sLSTM block), and ``prefill`` (512 decode
    steps) with its own launches; their last positions compared (bf16:
    recorded); (b) the same model in float32 (W4A16 weights from the same
    seed, f32 activations): forward's last position within
    ``XLSTM_PREFILL_TOL`` of prefill's; (c) greedy prefill + decode of phase
    5's 200-token prompt equal to the engine's stream (both are the same
    row-invariant recurrent steps, so bitwise)."""
    import numpy as np
    from repro_torch.core.compiler import quantize_model
    from repro_torch.kernels._build import launches
    from repro_torch.models import api
    res = results.setdefault("prefill", {}).setdefault(path, {})
    rng = np.random.default_rng(6)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 512)),
                        device=DEVICE)

    def both(c, p):
        """forward, then prefill: (logits, last, seconds, launches)."""
        torch.cuda.synchronize()
        launches.clear()
        t0 = time.perf_counter()
        logits, aux = api.forward(c, p, {"tokens": toks})
        torch.cuda.synchronize()
        t_fwd, got_fwd = time.perf_counter() - t0, dict(launches)
        need(logits.shape == (2, 512, c.vocab_size)
             and bool(torch.isfinite(logits).all()) and float(aux) == 0.0,
             f"{path}: forward logits are not finite of shape (2, 512, V)")
        launches.clear()
        t0 = time.perf_counter()
        last, _ = api.prefill(c, p, {"tokens": toks}, SERVE_MAX_LEN)
        torch.cuda.synchronize()
        t_pre, got_pre = time.perf_counter() - t0, dict(launches)
        return logits[:, -1], last, (t_fwd, t_pre), (got_fwd, got_pre)

    fwd_last, last, secs, (got_fwd, got_pre) = both(cfg, params)
    counts[f"{path}-prefill"] = got_fwd
    want_fwd = expected_launches_ssm(cfg, params, 1, full_sequence=True)
    want_pre = expected_launches_ssm(cfg, params, toks.shape[1])
    err, rel = max_errs(fwd_last, last)
    log(f"  (a) forward B=2 S=512 {secs[0] * 1e3:.1f} ms, launches "
        f"{got_fwd} expected {want_fwd}; prefill (512 recurrent steps) "
        f"{secs[1] * 1e3:.1f} ms, launches {got_pre} expected {want_pre}; "
        f"{str(cfg.dtype).split('.')[1]}: last position vs prefill max_abs "
        f"{err:.4g} rel {rel:.4g} (recorded: the forms part in bf16)")
    res["a"] = {"forward_s": secs[0], "prefill_s": secs[1],
                "bf16_max_abs": err, "bf16_rel": rel,
                "forward_launches": got_fwd,
                "expected_forward_launches": want_fwd,
                "prefill_launches": got_pre,
                "expected_prefill_launches": want_pre}
    need(got_fwd == want_fwd, f"{path}: forward launches {got_fwd} != "
         f"{want_fwd}")
    need(got_pre == want_pre, f"{path}: prefill launches {got_pre} != "
         f"{want_pre}")
    # (b) float32: the same weights' seed, f32 activations and state
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    p32 = quantize_model(api.init_params(cfg32, gen), "dense")
    fwd_last, last, secs, _ = both(cfg32, p32)
    del p32
    err, rel = max_errs(fwd_last, last)
    log(f"  (b) float32: forward {secs[0] * 1e3:.1f} ms, prefill "
        f"{secs[1] * 1e3:.1f} ms; last position vs prefill max_abs "
        f"{err:.4g} rel {rel:.4g} (tol {XLSTM_PREFILL_TOL})")
    res["b"] = {"forward_s": secs[0], "prefill_s": secs[1], "max_abs": err,
                "rel": rel, "tol_rel": XLSTM_PREFILL_TOL}
    need(rel <= XLSTM_PREFILL_TOL, f"{path} (b): float32 forward's last "
         f"position is {rel:.4g} from prefill's > {XLSTM_PREFILL_TOL}")
    torch.cuda.empty_cache()
    prompt = workload(cfg)[-1]
    stream = greedy_after_prefill(torch, cfg, params, prompt,
                                  SERVE_NEW_TOKENS, SERVE_MAX_LEN)
    res["c"] = {"equal": stream == engine_stream}
    log(f"  (c) greedy prefill + {SERVE_NEW_TOKENS - 1} decode steps vs the "
        f"engine's stream (200-token prompt): {res['c']}")
    need(stream == engine_stream, f"{path} (c): greedy prefill + decode "
         f"{stream} != the engine's {engine_stream}")
    torch.cuda.empty_cache()


HYBRID_PREFILL_LEN = 256     # two of the chunked SSD's 128-token chunks


def check_hybrid_prefill(torch, cfg, params, results, path, counts,
                         engine_stream):
    """Phase 6 on the hybrid: (a) ``forward`` at B=2 x S=256 (the chunked
    SSD as torch ops over two 128-token chunks, the gated norm kernel,
    kernel 7 at head dim 112 in the sites), launches exact, and
    ``prefill`` (256 recurrent steps) with its own launches; forward's
    last position against prefill's logits in bf16: the same top token
    for each row, the gap recorded (the two forms round in other places
    -- taps summed one at a time in bf16 against in f32, the state by
    chunks against step by step -- and part with depth in bf16 in the
    reference as in the port, while in float32 they agree to 1e-5:
    ``tests/test_torch_hybrid.py::test_forms_part_with_depth_in_bf16_in_
    both_packages``; float32 cannot run here, kernels 3 and 7 refuse it
    at head dim 112 and the gated norm's 7168-wide f32 row is past its
    stage); (b) greedy prefill + decode of phase 5's 200-token prompt
    equal to the engine's stream (the same row-invariant recurrent steps,
    so bitwise)."""
    import numpy as np
    from repro_torch.kernels._build import launches
    from repro_torch.models import api
    res = results.setdefault("prefill", {}).setdefault(path, {})
    rng = np.random.default_rng(6)
    s = HYBRID_PREFILL_LEN
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, s)),
                        device=DEVICE)
    torch.cuda.synchronize()
    launches.clear()
    t0 = time.perf_counter()
    logits, aux = api.forward(cfg, params, {"tokens": toks})
    torch.cuda.synchronize()
    t_fwd, got_fwd = time.perf_counter() - t0, dict(launches)
    need(logits.shape == (2, s, cfg.vocab_size)
         and bool(torch.isfinite(logits).all()) and float(aux) == 0.0,
         f"{path}: forward logits are not finite of shape (2, {s}, V)")
    launches.clear()
    t0 = time.perf_counter()
    last, _ = api.prefill(cfg, params, {"tokens": toks}, SERVE_MAX_LEN)
    torch.cuda.synchronize()
    t_pre, got_pre = time.perf_counter() - t0, dict(launches)
    counts[f"{path}-prefill"] = got_fwd
    want_fwd = expected_launches_hybrid(cfg, params, 1, full_sequence=True)
    want_pre = expected_launches_hybrid(cfg, params, toks.shape[1])
    err, rel = max_errs(logits[:, -1], last)
    same_top = bool(torch.equal(logits[:, -1].argmax(-1), last.argmax(-1)))
    log(f"  (a) forward B=2 S={s} {t_fwd * 1e3:.1f} ms, launches {got_fwd} "
        f"expected {want_fwd}; prefill ({s} recurrent steps) "
        f"{t_pre * 1e3:.1f} ms, launches {got_pre} expected {want_pre}; "
        f"bf16 last position vs prefill max_abs {err:.4g} rel {rel:.4g} "
        f"(recorded: the forms part in bf16), same top token {same_top}")
    res["a"] = {"forward_s": t_fwd, "prefill_s": t_pre, "bf16_max_abs": err,
                "bf16_rel": rel, "same_argmax": same_top,
                "forward_launches": got_fwd,
                "expected_forward_launches": want_fwd,
                "prefill_launches": got_pre,
                "expected_prefill_launches": want_pre}
    need(got_fwd == want_fwd, f"{path}: forward launches {got_fwd} != "
         f"{want_fwd}")
    need(got_pre == want_pre, f"{path}: prefill launches {got_pre} != "
         f"{want_pre}")
    need(same_top, f"{path} (a): forward's last position picks another "
         f"token than prefill's (rel gap {rel:.4g})")
    del logits, last
    torch.cuda.empty_cache()
    prompt = workload(cfg)[-1]
    stream = greedy_after_prefill(torch, cfg, params, prompt,
                                  SERVE_NEW_TOKENS, SERVE_MAX_LEN)
    res["b"] = {"equal": stream == engine_stream}
    log(f"  (b) greedy prefill + {SERVE_NEW_TOKENS - 1} decode steps vs the "
        f"engine's stream (200-token prompt): {res['b']}")
    need(stream == engine_stream, f"{path} (b): greedy prefill + decode "
         f"{stream} != the engine's {engine_stream}")
    torch.cuda.empty_cache()


def check_chunked_prefill(torch, cfg, params):
    """(d) An 8192-token prompt in two 4096-token chunks against one shot
    with ``PREFILL_CHUNK`` raised, then 4 decode steps from each cache."""
    import numpy as np
    from repro_torch.kernels._build import launches
    from repro_torch.models import api, transformer
    s = 2 * transformer.PREFILL_CHUNK
    max_len = s + 128
    toks = torch.tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, s)), device=DEVICE)
    out = {}
    for mode in ("chunked", "one-shot"):
        old = transformer.PREFILL_CHUNK
        if mode == "one-shot":
            transformer.PREFILL_CHUNK = s
        try:
            torch.cuda.synchronize()
            launches.clear()
            t0 = time.perf_counter()
            logits, cache = api.prefill(cfg, params, {"tokens": toks},
                                        max_len)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            transformer.PREFILL_CHUNK = old
        n_flash = launches["flash_attention"]
        want = cfg.n_layers * (2 if mode == "chunked" else 1)
        log(f"  (d) {mode} prefill of {s} tokens: {wall:.2f} s, "
            f"flash_attention launches {n_flash} (expected {want})")
        need(n_flash == want, f"(d) {mode}: {n_flash} flash launches != "
             f"{want}")
        out[mode] = (logits, cache, wall)
    (lc, cc, wc), (lo, co, wo) = out["chunked"], out["one-shot"]
    diff = max_errs(lc, lo)
    steps = []
    n = s
    for _ in range(4):
        tok = torch.tensor([[int(lc[0].argmax())]], device=DEVICE)
        n += 1
        lc, cc = api.decode_step(cfg, params, cc, tok, [n])
        lo, co = api.decode_step(cfg, params, co, tok, [n])
        steps.append(max_errs(lc, lo)[1])
    log(f"  (d) chunked vs one-shot: last logits rel {diff[1]:.4g}, 4 decode "
        f"steps rel {[f'{x:.4g}' for x in steps]} (tol {PREFILL_TOL})")
    need(diff[1] <= PREFILL_TOL and max(steps) <= PREFILL_TOL,
         f"(d) chunked and one-shot prefill differ: {diff[1]:.4g}, {steps}")
    return {"seconds": {"chunked": wc, "one-shot": wo},
            "logits_rel": diff[1], "decode_rel": steps}


def check_prefill_caches(torch, cfg, params, results, streams):
    """(e) On strategy2 weights: the int8 slot cache through
    ``attn_prefill``'s int8 branch, then decode, against the int8 engine;
    the paged config through ``api.prefill``: kernel 3's paged variant,
    never kernel 7, then decode against the paged engine."""
    from repro_torch.kernels._build import launches
    from repro_torch.models import api
    res = results.setdefault("prefill", {}).setdefault("strategy2", {})
    prompt = workload(cfg)[-1]
    toks = torch.tensor(prompt[None], device=DEVICE)
    for kv, over in KV_PATHS["strategy2"]:
        if kv not in ("int8", "paged"):
            continue
        pcfg = dataclasses.replace(cfg, **{**over, "kv_pool_blocks": 0})
        launches.clear()
        t0 = time.perf_counter()
        logits, _ = api.prefill(pcfg, params, {"tokens": toks},
                                SERVE_MAX_LEN)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = dict(launches)
        flash, paged, kvw, epi = (got.get(k, 0) for k in (
            "flash_attention", "mixed_flash_attention_paged", "kv_write",
            "qkv_rope_write"))
        # the int8 slot prefill: kernel 7 and kv_write a layer; the paged
        # prefill is one mixed step: kernel 3 and the epilogue a layer
        L = cfg.n_layers
        want = (L, 0, L, 0) if kv == "int8" else (0, L, 0, L)
        bl, _ = api._bulk_prefill(pcfg, params, toks, SERVE_MAX_LEN)
        diff = max_errs(logits, bl)
        stream = greedy_after_prefill(torch, pcfg, params, prompt,
                                      SERVE_NEW_TOKENS, SERVE_MAX_LEN)
        log(f"  (e) strategy2-{kv} prefill of {len(prompt)} tokens: "
            f"{seconds:.4f} s; launches flash_attention {flash},"
            f" mixed_flash_attention_paged {paged}, kv_write {kvw}, "
            f"qkv_rope_write {epi} (expected {want}); vs the mixed-step "
            f"route: logits max_abs {diff[0]:.4g}")
        need((flash, paged, kvw, epi) == want, f"(e) strategy2-{kv}: "
             f"launches {(flash, paged, kvw, epi)} != {want}")
        res[f"e-{kv}"] = {"launches": got, "seconds": seconds,
                          "bulk_logits_max_abs": diff[0],
                          "stream": check_stream(
                              torch, pcfg, params, prompt, stream,
                              streams[f"strategy2-{kv}"][-1], max(diff[0],
                                                                  1e-6),
                              f"strategy2-{kv} (e)")}
        log(f"  (e) greedy prefill + decode vs the strategy2-{kv} engine: "
            f"{res[f'e-{kv}']['stream']}")


# -- main -------------------------------------------------------------------

# kernel: (source, TPU kernel it replaces, the served path whose own run
# gives its "launches": the path of the slice that ported it)
# -- phase 7: training -------------------------------------------------------

# qwen3-8b at full width and 4 of its 36 layers: f32 masters, m and v and
# the bf16 params and grads of all 36 (8.2 B parameters) need ~164 GB; the
# 4 layers and the head are 2.02 B parameters, ~33 GB of state.  The
# launcher's default batch, 8 x 256 tokens.
TRAIN_ARCH, TRAIN_LAYERS = "qwen3-8b", 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 10
TRAIN_PATH = "qwen3-8b-train"
# the step through the kernels against the same step through their plain
# versions (same masters, same batch): bf16 activations rounded at other
# places compound over 4 layers and the 151,936-way softmax
TRAIN_LOSS_TOL = 2e-2              # absolute, on a loss of ~12.4
TRAIN_GNORM_TOL = 0.02             # relative
TRAIN_LEAF_TOL = 3e-2              # relative L2, each leaf's gradient
# kernel 7's backward against its plain version on the same o and lse: P
# and dS rounded to bf16 before their products in both, from scores summed
# in another order (one bf16 rounding, 2^-8, may fall the other way), then
# one more rounding of the output
FA_BWD_TOL = 2e-2
# name: (B, hq, hkv, Sq, Skv, d, causal, window)
FA_BWD_CASES = {
    "qwen3-8b training B=8 S=256": (8, 32, 8, 256, 256, 128, True, None),
    "causal S=2048 rep 4": (1, 32, 8, 2048, 2048, 128, True, None),
    "window 256 S=1024": (1, 32, 8, 1024, 1024, 128, True, 256),
    "ragged S=300": (1, 32, 8, 300, 300, 128, True, None),
    "d=64 B=2 S=512": (2, 16, 4, 512, 512, 64, True, None),
    "non-causal Sq=448 Skv=1500 d=64": (1, 12, 12, 448, 1500, 64, False,
                                        None),
    "qwen3-8b-smoke d=32": (2, 4, 2, 64, 64, 32, True, None),
    "rows with no key Sq=96 Skv=64": (1, 8, 2, 96, 64, 64, True, None),
    # chatglm-6b's 32 over 2 heads and qwen1.5-4b's 20 over 20; a ragged
    # length past the dQ block's 128 rows and the 64-key tile (128 + 72)
    "chatglm-6b rep 16 S=2048": (1, 32, 2, 2048, 2048, 128, True, None),
    "qwen1.5-4b rep 1 B=8 S=256": (8, 20, 20, 256, 256, 128, True, None),
    "ragged S=200": (1, 32, 8, 200, 200, 128, True, None),
}
FA_BWD_TIMED = ("qwen3-8b training B=8 S=256", "causal S=2048 rep 4",
                "chatglm-6b rep 16 S=2048", "qwen1.5-4b rep 1 B=8 S=256")
# (rows, d, what): the training step's norms at qwen3-8b's widths, ragged
# rows, and the smoke config's q/k heads
RMS_BWD_CASES = ((2048, 4096, "ln_attn / ln_mlp / ln_f rows"),
                 (2048 * 32, 128, "q heads"), (2048 * 8, 128, "k heads"),
                 (300, 4096, "ragged 300 rows"), (2 * 16 * 4, 32,
                                                  "qwen3-8b-smoke q heads"),
                 (300, 8192, "8192 wide: 8 warps a row, 4 chunks a thread"))
RMS_BWD_TIMED = ("ln_attn / ln_mlp / ln_f rows", "q heads")
# dx is rounded to bf16 (2^-8); dgamma is an f32 sum over the rows in
# another order
RMS_BWD_TOL = {"dx": 1e-2, "dgamma": 1e-4}


def backward_ms(torch, timer, fn, inputs):
    """Device time of the backward alone of ``fn(*inputs)`` (inputs that
    require grad): the forward once, ``torch.autograd.grad`` timed with
    ``retain_graph``."""
    out = fn(*inputs)
    dout = torch.randn_like(out)
    ms = timer.ms(lambda: torch.autograd.grad(out, inputs, dout,
                                              retain_graph=True), 10)
    del out
    return ms


def check_attention_backward(torch, timer, randn, rows) -> dict:
    """Kernel 7's backward against its plain version at ``FA_BWD_CASES``,
    on the o and lse of kernel 7's training forward, whose output is held
    bitwise to the serving forward's and whose lse to the plain version's;
    bitwise repeatable; a row of B=3 bitwise the row alone.  Kernel, plain
    and SDPA-backward times beside the bound at ``FA_BWD_TIMED``, with the
    training forward's time beside the serving forward's."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        BLOCK_KV, BLOCK_Q, flash_attention_cuda, flash_attention_torch)
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_cuda, flash_attention_bwd_sync_cuda,
        flash_attention_bwd_torch)
    line = {}
    for name, (b, hq, hkv, sq, skv, d, causal, window) in \
            FA_BWD_CASES.items():
        q, do = randn(b, hq, sq, d), randn(b, hq, sq, d)
        k, v = randn(b, hkv, skv, d), randn(b, hkv, skv, d)
        kw = dict(causal=causal, window=window)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        need(torch.equal(o, flash_attention_cuda(q, k, v, **kw)),
             f"flash_attention {name}: the training forward's output is "
             "not bitwise the serving forward's")
        _, plse = flash_attention_torch(q, k, v, block_q=BLOCK_Q,
                                        block_kv=BLOCK_KV, return_lse=True,
                                        **kw)
        dead = torch.isinf(lse)
        need(torch.equal(dead, torch.isinf(plse)) and bool(
            (lse[dead] > 0).all()), f"flash_attention {name}: lse's +inf "
             "rows differ from the plain version's")
        lse_err = float((lse[~dead] - plse[~dead]).abs().max()) \
            if bool((~dead).any()) else 0.0
        need(lse_err <= 1e-3, f"flash_attention {name}: lse differs from "
             f"the plain version's by {lse_err:.3g}")
        got = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
        want = flash_attention_bwd_torch(q, k, v, o, do, lse, **kw)
        torch.cuda.synchronize()
        errs = {w: max_errs(g, p) for w, g, p in zip(("dq", "dk", "dv"),
                                                     got, want)}
        need(all(e[1] <= FA_BWD_TOL for e in errs.values())
             and all(bool(torch.isfinite(g).all()) for g in got),
             f"flash_attention_bwd {name}: rel err "
             f"{ {w: e[1] for w, e in errs.items()} } > {FA_BWD_TOL}")
        again = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
        need(all(torch.equal(a, g) for a, g in zip(again, got)),
             f"flash_attention_bwd {name}: two calls differ")
        if bool(dead.any()):
            need(bool((got[0][dead] == 0).all()), f"flash_attention_bwd "
                 f"{name}: a row that sees no key has a nonzero dq")
        row = {"kernel": "flash_attention_bwd", "case": name, "B": b,
               "hq": hq, "hkv": hkv, "Sq": sq, "Skv": skv, "d": d,
               "causal": causal, "window": window,
               "max_abs_err": max(e[0] for e in errs.values()),
               "max_rel_err": max(e[1] for e in errs.values()),
               "errs": {w: {"max_abs": e[0], "max_rel": e[1]}
                        for w, e in errs.items()},
               "lse_max_abs_err": lse_err, "tol_rel": FA_BWD_TOL,
               "bitwise_repeat": True}
        msg = ""
        if name in FA_BWD_TIMED:
            row["ms"] = timer.ms(lambda: flash_attention_bwd_cuda(
                q, k, v, o, do, lse, **kw), 10)
            row["plain_ms"] = timer.ms(lambda: flash_attention_bwd_torch(
                q, k, v, o, do, lse, **kw), 1)
            qkv = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            row["library_ms"] = backward_ms(
                torch, timer, lambda q_, k_, v_: sdpa_full(
                    torch, q_, k_, v_, causal, window), qkv)
            del qkv
            pairs = visible_pairs(sq, skv, causal, window)
            row["visible_pairs"] = pairs
            row["bound_ms"], row["bound_by"] = bound(
                2 * (4 * b * hq * sq * d + 4 * b * hkv * skv * d)
                + 4 * b * hq * sq, 10 * d * b * hq * pairs, "bfloat16")
            row["forward_lse_ms"] = timer.ms(lambda: flash_attention_cuda(
                q, k, v, return_lse=True, **kw), 10)
            row["forward_ms"] = timer.ms(lambda: flash_attention_cuda(
                q, k, v, **kw), 10)
            row["forward_lse_plain_ms"] = timer.ms(
                lambda: flash_attention_torch(q, k, v, return_lse=True,
                                              **kw), 1)
            row["forward_library_ms"] = timer.ms(
                lambda: sdpa_full(torch, q, k, v, causal, window), 10)
            row["forward_bound_ms"], row["forward_bound_by"] = bound(
                2 * (2 * b * hq * sq * d + 2 * b * hkv * skv * d)
                + 4 * b * hq * sq, 4 * d * b * hq * pairs, "bfloat16")
            msg = (f"  kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f}"
                   f" ms sdpa backward {row['library_ms']:.4f} ms bound "
                   f"{row['bound_ms']:.4f} ms ({row['bound_by']}); forward "
                   f"with lse {row['forward_lse_ms']:.4f} ms (serving "
                   f"forward {row['forward_ms']:.4f}, plain "
                   f"{row['forward_lse_plain_ms']:.4f}, sdpa "
                   f"{row['forward_library_ms']:.4f}, bound "
                   f"{row['forward_bound_ms']:.4f} ms "
                   f"({row['forward_bound_by']}))")
            # the mma.sync yardstick on the same inputs, in this call
            sync = flash_attention_bwd_sync_cuda(q, k, v, o, do, lse, **kw)
            torch.cuda.synchronize()
            serrs = [max_errs(g, p) for g, p in zip(sync, want)]
            need(all(e[1] <= FA_BWD_TOL for e in serrs),
                 f"flash_attention_bwd_sync {name}: rel err "
                 f"{[e[1] for e in serrs]} > {FA_BWD_TOL}")
            row["yardstick_ms"] = timer.ms(
                lambda: flash_attention_bwd_sync_cuda(q, k, v, o, do, lse,
                                                      **kw), 10)
            row["ms_after_yardstick"] = timer.ms(
                lambda: flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw),
                10)
            row["over_yardstick"] = (row["ms"] + row["ms_after_yardstick"]
                                     ) / 2 / row["yardstick_ms"]
            row["over_library"] = row["ms"] / row["library_ms"]
            msg += (f"; the mma.sync yardstick {row['yardstick_ms']:.4f} ms"
                    f" (kernel / yardstick {row['over_yardstick']:.3f}, "
                    f"kernel / sdpa backward {row['over_library']:.3f})")
            if name == FA_BWD_TIMED[0]:
                line["flash_attention_bwd"] = row
                line["flash_attention_bwd_sync"] = {
                    "max_abs_err": max(e[0] for e in serrs),
                    "ms": row["yardstick_ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"]}
            del sync
        rows.append(row)
        log(f"  flash_attention_bwd {name}: rel dq {errs['dq'][1]:.3g} dk "
            f"{errs['dk'][1]:.3g} dv {errs['dv'][1]:.3g} (tol {FA_BWD_TOL})"
            f"; lse {lse_err:.3g}; forward with lse bitwise the serving "
            "one; two calls bitwise" + msg)
        del q, k, v, do, o, lse, plse, got, want, again
        torch.cuda.empty_cache()
    # batch invariance: a row of B=3 is the row alone
    for d in (128, 64, 32):
        q, do = randn(3, 32, 256, d), randn(3, 32, 256, d)
        k, v = randn(3, 8, 256, d), randn(3, 8, 256, d)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True)
        full = flash_attention_bwd_cuda(q, k, v, o, do, lse)
        one = flash_attention_bwd_cuda(q[1:2], k[1:2], v[1:2], o[1:2],
                                       do[1:2], lse[1:2])
        need(all(torch.equal(f[1:2], g) for f, g in zip(full, one)),
             f"flash_attention_bwd d={d}: row 1 of B=3 differs alone")
    log("  flash_attention_bwd: a row of B=3 bitwise the row alone (d=128, "
        "64, 32)")
    return line


def check_rmsnorm_backward(torch, timer, rows) -> dict:
    """The RMSNorm backward kernel against its plain version at
    ``RMS_BWD_CASES``, bitwise repeatable, a row's dx bitwise the row
    alone; kernel, plain and ``F.rms_norm``-backward times beside the byte
    bound at ``RMS_BWD_TIMED``."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm_bwd import (
        rmsnorm_bwd_cuda, rmsnorm_bwd_serial_cuda, rmsnorm_bwd_torch)
    g = torch.Generator(device="cuda").manual_seed(36)
    lib = getattr(F, "rms_norm", None)
    line = {}
    for n, d, what in RMS_BWD_CASES:
        x = torch.randn(n, d, generator=g, device="cuda").bfloat16()
        dy = torch.randn(n, d, generator=g, device="cuda").bfloat16()
        gamma = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")
                 ).bfloat16()
        dx, dg = rmsnorm_bwd_cuda(x, gamma, dy)
        pdx, pdg = rmsnorm_bwd_torch(x, gamma, dy)
        torch.cuda.synchronize()
        ex, eg = max_errs(dx, pdx), max_errs(dg, pdg)
        case = f"rmsnorm_bwd {n}x{d} ({what})"
        need(ex[1] <= RMS_BWD_TOL["dx"] and eg[1] <= RMS_BWD_TOL["dgamma"]
             and bool(torch.isfinite(dx).all()), f"{case}: rel dx "
             f"{ex[1]:.3g} dgamma {eg[1]:.3g} > {RMS_BWD_TOL}")
        dx2, dg2 = rmsnorm_bwd_cuda(x, gamma, dy)
        need(torch.equal(dx, dx2) and torch.equal(dg, dg2),
             f"{case}: two calls differ")
        r = min(5, n - 1)
        need(torch.equal(rmsnorm_bwd_cuda(x[r:r + 1], gamma, dy[r:r + 1])[0],
                         dx[r:r + 1]), f"{case}: row {r}'s dx differs alone")
        row = {"kernel": "rmsnorm_bwd", "dtype": "bfloat16", "rows": n,
               "d": d, "case": what, "max_abs_err": max(ex[0], eg[0]),
               "max_rel_err": max(ex[1], eg[1]),
               "errs": {"dx": ex, "dgamma": eg}, "tol_rel": RMS_BWD_TOL,
               "bitwise_repeat": True, "library_ms": None}
        msg = ""
        if what in RMS_BWD_TIMED:
            row["ms"] = timer.ms(lambda: rmsnorm_bwd_cuda(x, gamma, dy), 20)
            row["plain_ms"] = timer.ms(lambda: rmsnorm_bwd_torch(
                x, gamma, dy), 5)
            if lib is not None:
                xg = [x.clone().requires_grad_(True),
                      gamma.clone().requires_grad_(True)]
                row["library_ms"] = backward_ms(
                    torch, timer, lambda x_, g_: lib(x_, (d,), g_, 1e-6), xg)
                del xg
            row["bound_ms"], row["bound_by"] = bound(
                3 * n * d * 2 + d * 2 + d * 4, 10 * n * d, "bfloat16")
            # the one-row-in-flight yardstick on the same inputs
            sdx, sdg = rmsnorm_bwd_serial_cuda(x, gamma, dy)
            torch.cuda.synchronize()
            sx, sg = max_errs(sdx, pdx), max_errs(sdg, pdg)
            need(sx[1] <= RMS_BWD_TOL["dx"] and sg[1] <= RMS_BWD_TOL[
                "dgamma"], f"{case}: the yardstick's rel dx {sx[1]:.3g} "
                 f"dgamma {sg[1]:.3g} > {RMS_BWD_TOL}")
            row["yardstick_ms"] = timer.ms(
                lambda: rmsnorm_bwd_serial_cuda(x, gamma, dy), 20)
            row["ms_after_yardstick"] = timer.ms(
                lambda: rmsnorm_bwd_cuda(x, gamma, dy), 20)
            row["over_yardstick"] = (row["ms"] + row["ms_after_yardstick"]
                                     ) / 2 / row["yardstick_ms"]
            row["over_bound"] = row["ms"] / row["bound_ms"]
            msg = (f"  kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f}"
                   f" ms F.rms_norm backward {row['library_ms']} ms bound "
                   f"{row['bound_ms']:.4f} ms ({row['bound_by']}, kernel / "
                   f"bound {row['over_bound']:.3f}); the one-row yardstick "
                   f"{row['yardstick_ms']:.4f} ms (kernel / yardstick "
                   f"{row['over_yardstick']:.3f})")
            if what == RMS_BWD_TIMED[0]:
                line["rmsnorm_bwd"] = row
                line["rmsnorm_bwd_serial"] = {
                    "max_abs_err": max(sx[0], sg[0]),
                    "ms": row["yardstick_ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"]}
        rows.append(row)
        log(f"  {case}: rel dx {ex[1]:.3g} dgamma {eg[1]:.3g}; two calls "
            f"bitwise; row {r} alone bitwise" + msg)
    return line


def expected_train_launches(cfg) -> dict:
    """One training step's launches from the config: each layer's forward
    twice under remat "block" (the forward, then its recompute in the
    backward) with kernel 7 and the rmsnorm kernel at ln_attn, ln_mlp and
    (qk_norm) the q and k heads; ln_f once; each backward once.  No other
    kernel (the 16-bit products are cuBLAS's, the MLP unfused)."""
    fwd = 2 if cfg.remat == "block" else 1
    norms = 2 + (2 if cfg.qk_norm else 0)
    return {"flash_attention": fwd * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers,
            "rmsnorm": fwd * norms * cfg.n_layers + 1,
            "rmsnorm_bwd": norms * cfg.n_layers + 1}


def train_config(torch):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    cfg = get_config(TRAIN_ARCH, n_layers=TRAIN_LAYERS)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_SEQ,
                                      TRAIN_BATCH))

    def batch(i):
        return {k: torch.from_numpy(v).to(DEVICE)
                for k, v in data.batch(i).items()}
    return cfg, batch


def flat_norm(torch, grads: dict) -> float:
    return float(torch.sqrt(sum(torch.sum(g.float() ** 2)
                                for g in grads.values())))


def check_train_step(torch, results, counts) -> None:
    """(b): one step's loss and gradients through the kernels against the
    same step through every op's plain version on the card (``ops._resolve``
    answering "torch"), from the same f32 masters and batch; the step's
    launches exactly ``expected_train_launches``; the plain step launches
    nothing."""
    from repro_torch.kernels import _build, ops
    from repro_torch.optim.adamw import AdamW, tree_leaves
    from repro_torch.train.trainer import (
        compute_params, init_train_state, loss_and_grads)
    cfg, batch = train_config(torch)
    params, _ = init_train_state(cfg, AdamW(), torch.Generator(
        device=DEVICE).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    compute = compute_params(params, cfg.dtype)
    del params
    torch.cuda.empty_cache()
    b0 = batch(0)
    _build.launches.clear()
    loss, _, grads = loss_and_grads(cfg, compute, b0)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.launches.items() if v}
    counts[TRAIN_PATH] = dict(launches)
    want = expected_train_launches(cfg)
    need(launches == want, f"training step launches {launches}, expected "
         f"{want}")
    real = ops._resolve
    ops._resolve = lambda impl, x: "torch" if impl == "auto" else real(
        impl, x)
    try:
        _build.launches.clear()
        ploss, _, pgrads = loss_and_grads(cfg, compute, b0)
        torch.cuda.synchronize()
        need(not any(_build.launches.values()), "the plain-version step "
             f"launched {dict(_build.launches)}")
    finally:
        ops._resolve = real
    dloss = abs(float(loss) - float(ploss))
    gn, pgn = flat_norm(torch, grads), flat_norm(torch, pgrads)
    leaf_err = {p: float(torch.linalg.vector_norm((g.float() - pgrads[p]
                                                   .float()))
                         / torch.linalg.vector_norm(pgrads[p].float())
                         .clamp_min(1e-30)) for p, g in grads.items()}
    worst = max(leaf_err, key=leaf_err.get)
    results["train_step"] = {
        "arch": TRAIN_ARCH, "layers": TRAIN_LAYERS, "params": n_params,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "loss": float(loss),
        "plain_loss": float(ploss), "grad_norm": gn, "plain_grad_norm": pgn,
        "leaf_rel_l2": leaf_err, "launches": launches,
        "tol": {"loss": TRAIN_LOSS_TOL, "grad_norm": TRAIN_GNORM_TOL,
                "leaf": TRAIN_LEAF_TOL}}
    log(f"  step at {TRAIN_ARCH} width, {TRAIN_LAYERS} layers ({n_params:,} "
        f"parameters), B={TRAIN_BATCH} S={TRAIN_SEQ}: loss {float(loss):.5f}"
        f" (plain {float(ploss):.5f}), grad norm {gn:.5g} (plain {pgn:.5g})"
        f", worst leaf rel L2 {leaf_err[worst]:.3g} ({worst}); launches "
        f"{launches} as expected")
    need(dloss <= TRAIN_LOSS_TOL, f"training step: loss {float(loss)} vs "
         f"plain {float(ploss)}")
    need(abs(gn - pgn) <= TRAIN_GNORM_TOL * pgn, f"training step: grad norm "
         f"{gn} vs plain {pgn}")
    need(leaf_err[worst] <= TRAIN_LEAF_TOL, f"training step: {worst}'s "
         f"gradient rel L2 {leaf_err[worst]:.3g} > {TRAIN_LEAF_TOL}")
    need(all(bool(torch.isfinite(g).all()) for g in grads.values()),
         "training step: a gradient is not finite")


# a traced training step's kernel groups by the names the profiler gives
# them, case aside (the rest is "other": casts, among them the logits' to
# f32 for the loss, residual adds, the MLP's silu and product, fills, the
# embedding and its gradient); AdamW's passes are the kernels inside the
# "adamw" range on the card's timeline (optim/adamw.py)
TRAIN_TRACE_GROUPS = (
    ("kernel 7 and its backward", r"flash_attention|fb_dq_kernel|"
                                  r"fb_dkv_kernel"),
    ("the RMSNorm pair", r"rmsnorm"),
    ("cuBLAS products", r"gemm|nvjet|xmma|cutlass"),
    ("the 151,936-way loss's log-softmax and gather, both ways",
     r"softmax|gather|scatter"))


def trace_train_step(torch, step, params, state, batch, i) -> dict:
    """One step under ``torch.profiler``: device-busy ms (the union of the
    card's kernel and copy intervals), operations, and the device ms of
    each ``TRAIN_TRACE_GROUPS`` group and of AdamW's passes (kernels that
    start inside the ``adamw`` range's span on the card; "not measured"
    when the profiler records no such span)."""
    import re
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, state, batch, i)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [e for e in dev if getattr(e, "is_user_annotation", False)]
    kernels = [e for e in dev if not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    adamw = [(e.time_range.start, e.time_range.end) for e in marks
             if e.name == "adamw"]
    groups = {name: 0.0 for name, _ in TRAIN_TRACE_GROUPS}
    adamw_ms, other = 0.0, {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        if any(a <= e.time_range.start < b for a, b in adamw):
            adamw_ms += ms
            continue
        for name, pattern in TRAIN_TRACE_GROUPS:
            if re.search(pattern, e.name, re.IGNORECASE):
                groups[name] += ms
                break
        else:
            other[e.name] = other.get(e.name, 0.0) + ms
    out = {"busy_ms": busy / 1e3, "device_ops": len(kernels),
           "groups_ms": groups,
           "adamw_ms": adamw_ms if adamw else None,
           "other_ms": sum(other.values()),
           "other_top": sorted(((n[:90], ms) for n, ms in other.items()),
                               key=lambda kv: -kv[1])[:8]}
    need(kernels, "training trace: the profiler saw no device activity")
    return out


def check_train_run(torch, results) -> None:
    """(c): ``TRAIN_STEPS`` AdamW steps (cosine schedule, peak 3e-4, 20
    warmup steps), twice from the same seed: every loss finite, step 0
    near the loss of this init (ln V + 1/2: the logits of a unit-RMS
    final row against N(0, 1/d) head weights have variance ~1), the two
    runs' losses bitwise equal; the median step time, tokens/s, peak
    memory and 6 N tokens / step time against the card's bf16 peak."""
    import math
    import statistics
    from repro_torch.optim.adamw import AdamW, cosine_schedule, tree_leaves
    from repro_torch.train.trainer import init_train_state, make_train_step
    cfg, batch = train_config(torch)
    opt = AdamW(lr=cosine_schedule(3e-4, 20, TRAIN_STEPS))
    runs = []
    for run in range(2):
        params, state = init_train_state(cfg, opt, torch.Generator(
            device=DEVICE).manual_seed(0))
        n_params = sum(p.numel() for p in tree_leaves(params))
        step = make_train_step(cfg, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, secs = [], []
        for i in range(TRAIN_STEPS):
            b = batch(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, b, i)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
            log(f"  run {run} step {i}: loss {losses[-1]:.6f} "
                f"({secs[-1] * 1e3:.1f} ms)")
        peak = torch.cuda.max_memory_allocated()
        runs.append((losses, secs, peak))
        if run == 1:
            # one more step, traced: where a step's device time goes
            trace = trace_train_step(torch, step, params, state,
                                     batch(TRAIN_STEPS), TRAIN_STEPS)
            results["train_trace"] = trace
            log(f"  a traced step: device busy {trace['busy_ms']:.2f} ms over "
                f"{trace['device_ops']} operations; "
                + ", ".join(f"{k} {v:.2f}" for k, v in
                            trace["groups_ms"].items())
                + ", AdamW's passes "
                + (f"{trace['adamw_ms']:.2f}" if trace["adamw_ms"] is not None
                   else "not measured")
                + f", other {trace['other_ms']:.2f} ms (top: "
                + "; ".join(f"{n} {ms:.2f}" for n, ms in trace["other_top"])
                + ")")
        del params, state, step, m
        torch.cuda.empty_cache()
    (l0, s0, p0), (l1, s1, _) = runs
    need(all(math.isfinite(x) for x in l0 + l1), "training run: a loss is "
         "not finite")
    expect = math.log(cfg.vocab_size) + 0.5
    need(abs(l0[0] - expect) <= 0.5, f"training run: step 0's loss {l0[0]} "
         f"is not within 0.5 of ln V + 1/2 = {expect:.4f}")
    need(l0 == l1, f"training run: two runs from one seed differ: {l0} vs "
         f"{l1}")
    med = statistics.median(s0[1:] + s1[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    share = 6 * n_params * tokens / med / PEAK_FLOPS["bfloat16"]
    results["train_run"] = {
        "losses": l0, "losses_run2": l1, "step_s": s0, "step_s_run2": s1,
        "median_step_ms": med * 1e3, "tokens_per_s": tokens / med,
        "peak_memory_bytes": p0, "model_flops_share": share,
        "params": n_params, "ln_vocab": math.log(cfg.vocab_size)}
    log(f"  {TRAIN_STEPS} steps twice: losses bitwise equal across runs, "
        f"step 0 {l0[0]:.4f} (ln V {math.log(cfg.vocab_size):.4f}), last "
        f"{l0[-1]:.4f}; median step {med * 1e3:.2f} ms (steps 1-9 of both "
        f"runs), {tokens / med:,.0f} tokens/s, peak memory "
        f"{p0 / 2**30:.2f} GiB, 6 N tokens / step time {share:.4f} of the "
        "bf16 peak")


def check_resumable(torch, results) -> None:
    """(d): ``run_resumable`` at qwen3-8b-smoke in bf16 on the card,
    preempted through ``PreemptionGuard.request()`` after step 3 and
    resumed to step 6: params and optimizer state bitwise an uninterrupted
    6-step run's."""
    import shutil
    import tempfile
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import PreemptionGuard, run_resumable
    from repro_torch.train.trainer import init_train_state, make_train_step
    cfg = get_smoke_config(TRAIN_ARCH, dtype=torch.bfloat16)
    opt = AdamW(lr=cosine_schedule(3e-4, 2, 6))
    step = make_train_step(cfg, opt)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 4))

    def init():
        p, s = init_train_state(cfg, opt, torch.Generator(
            device=DEVICE).manual_seed(0))
        return {"params": p, "opt": s}

    def step_fn(state, i):
        b = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in data.batch(i).items()}
        p, s, m = step(state["params"], state["opt"], b, i)
        return {"params": p, "opt": s}, m

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        whole, last, done = run_resumable(
            ckpt_dir=os.path.join(root, "whole"), total_steps=6,
            init_state=init, step_fn=step_fn, ckpt_every=100)
        need(done and last == 6, "resumable: the whole run did not finish")
        guard = PreemptionGuard(signals=())

        def preempting(state, i):
            if i == 2:
                guard.request()
            return step_fn(state, i)
        _, last, done = run_resumable(
            ckpt_dir=os.path.join(root, "cut"), total_steps=6,
            init_state=init, step_fn=preempting, ckpt_every=100,
            guard=guard)
        need(not done and last == 3, f"resumable: preemption stopped at "
             f"{last} (done {done}), expected 3")
        resumed, last, done = run_resumable(
            ckpt_dir=os.path.join(root, "cut"), total_steps=6,
            init_state=init, step_fn=step_fn, ckpt_every=100)
        need(done and last == 6, "resumable: the resumed run did not finish")
        want = dict(ckpt.tree_paths(whole))
        got = dict(ckpt.tree_paths(resumed))
        need(set(got) == set(want) and all(torch.equal(got[p], want[p])
                                           for p in want),
             "resumable: the resumed state is not bitwise the whole run's")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    results["train_resumable"] = {"arch": cfg.name, "leaves": len(want),
                                  "bitwise": True}
    log(f"  run_resumable at {cfg.name} bf16: preempted after step 3, "
        f"resumed to 6; all {len(want)} leaves of params and optimizer "
        "state bitwise the uninterrupted run's")


def check_training(torch, results, counts) -> dict:
    """Phase 7 (a)-(d); returns the backward kernels' rows for the
    ``kernels`` line."""
    timer = Timer(torch)
    g = torch.Generator(device=DEVICE).manual_seed(3600)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=DEVICE).to(dtype)
    rows: list = []
    results["training_kernels"] = rows
    line = check_attention_backward(torch, timer, randn, rows)
    line.update(check_rmsnorm_backward(torch, timer, rows))
    del timer
    torch.cuda.empty_cache()
    check_train_step(torch, results, counts)
    torch.cuda.empty_cache()
    check_train_run(torch, results)
    check_resumable(torch, results)
    return line


KERNEL_META = {
    "w4a16_matmul": ("src/repro_torch/kernels/csrc/w4a16_matmul.cu",
                     "src/repro/kernels/w4a16_matmul.py:78", "dense"),
    "ffn_fused_w4a16": ("src/repro_torch/kernels/csrc/ffn_fused.cu",
                        "src/repro/kernels/ffn_fused.py:215", "dense"),
    "mixed_flash_attention": ("src/repro_torch/kernels/csrc/decode_flash.cu",
                              "src/repro/kernels/decode_flash.py:181",
                              "dense"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/models/layers.py:65 (XLA in the reference, no "
                "Pallas kernel)", "dense"),
    "add_rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/models/layers.py:65 and the residual adds of "
                    "src/repro/models/transformer.py:66 (XLA in the "
                    "reference, no Pallas kernel)", "dense"),
    "qkv_rope_write": ("src/repro_torch/kernels/csrc/kv_write.cu",
                       "src/repro/models/attention.py:38-55, :215-220, "
                       ":139, :153, :269 and src/repro/models/layers.py:"
                       "99-111 (XLA in the reference, no Pallas kernel)",
                       "dense"),
    "sparse_w4a16_matmul": ("src/repro_torch/kernels/csrc/sparse_w4a16.cu",
                            "src/repro/kernels/sparse_w4a16.py:74",
                            "strategy2"),
    "ffn_fused_sparse": ("src/repro_torch/kernels/csrc/ffn_fused_sparse.cu",
                         "src/repro/kernels/ffn_fused.py:455", "strategy2"),
    "mixed_flash_attention_int8": (
        "src/repro_torch/kernels/csrc/decode_flash.cu",
        "src/repro/kernels/decode_flash.py:181 (int8 K/V: :103-107, "
        ":136-140, :160-162, :271-281)", "strategy2-int8"),
    "mixed_flash_attention_paged": (
        "src/repro_torch/kernels/csrc/decode_flash.cu",
        "src/repro/kernels/decode_flash.py:181 (paged: :206-212, :218-226, "
        ":253-257, :287-289)", "strategy2-paged"),
    "mixed_flash_attention_paged_int8": (
        "src/repro_torch/kernels/csrc/decode_flash.cu",
        "src/repro/kernels/decode_flash.py:181 (paged and int8 K/V)",
        "strategy2-paged-int8"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:101",
                        "dense-prefill"),
    "slstm_scan": ("src/repro_torch/kernels/csrc/slstm_scan.cu",
                   "src/repro/kernels/slstm_scan.py:79", "xlstm-dense"),
    "mlstm_cell": ("src/repro_torch/kernels/csrc/mlstm_cell.cu",
                   "src/repro/models/xlstm.py:205-217 (XLA in the "
                   "reference, no Pallas kernel)", "xlstm-dense"),
    "ffn_fused_dense": ("src/repro_torch/kernels/csrc/ffn_fused_dense.cu",
                        "src/repro/kernels/ffn_fused.py:300", "none"),
    "dense_matmul": ("src/repro_torch/kernels/csrc/dense_matmul.cu",
                     "src/repro/models/layers.py:43 (XLA in the reference, "
                     "no Pallas kernel)", "none"),
    "layernorm": ("src/repro_torch/kernels/csrc/layernorm.cu",
                  "src/repro/models/layers.py:72 (XLA in the reference, no "
                  "Pallas kernel)", "starcoder2-none"),
    "add_layernorm": ("src/repro_torch/kernels/csrc/layernorm.cu",
                      "src/repro/models/layers.py:72 and the residual adds "
                      "of src/repro/models/transformer.py:62-71 (XLA in the "
                      "reference, no Pallas kernel)", "starcoder2-dense"),
    "ffn_fused_w4a16_gelu": ("src/repro_torch/kernels/csrc/ffn_fused.cu",
                             "src/repro/kernels/ffn_fused.py:215 (the "
                             "ungated gelu variant with biases)",
                             "starcoder2-dense"),
    "ffn_fused_sparse_gelu": ("src/repro_torch/kernels/csrc/"
                              "ffn_fused_sparse.cu",
                              "src/repro/kernels/ffn_fused.py:455 (the "
                              "ungated gelu variant with biases)",
                              "starcoder2-strategy2"),
    "kv_write": ("src/repro_torch/kernels/csrc/kv_write.cu",
                 "src/repro/models/attention.py:139, :153, :269 (XLA in the "
                 "reference, no Pallas kernel)", "dense-prefill"),
    "moe_route": ("src/repro_torch/kernels/csrc/moe_route.cu",
                  "src/repro/models/moe.py:64-81 (the router's product at "
                  ":74) and :88-101 (XLA in the reference, no Pallas "
                  "kernel)", "granite-moe-dense"),
    "moe_gate_up_w4a16": ("src/repro_torch/kernels/csrc/moe_experts.cu",
                          "src/repro/kernels/ffn_fused.py:215 (under "
                          "src/repro/models/moe.py:129-145's vmap over "
                          "experts)", "granite-moe-dense"),
    "moe_down_w4a16": ("src/repro_torch/kernels/csrc/moe_experts.cu",
                       "src/repro/kernels/w4a16_matmul.py:78 (the down of "
                       "src/repro/models/moe.py:129-145's experts)",
                       "granite-moe-dense"),
    "moe_combine": ("src/repro_torch/kernels/csrc/moe_route.cu",
                    "src/repro/models/moe.py:103-118 (XLA in the reference, "
                    "no Pallas kernel)", None),
    "combine_add_rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                            "src/repro/models/moe.py:103-118, the residual "
                            "add of src/repro/models/transformer.py:66 and "
                            "src/repro/models/layers.py:65 rmsnorm (XLA in "
                            "the reference, no Pallas kernel)",
                            "granite-moe-dense"),
    "mamba_cell": ("src/repro_torch/kernels/csrc/mamba_cell.cu",
                   "src/repro/models/ssm.py:152-176 (XLA in the reference, "
                   "no Pallas kernel)", None),
    "rmsnorm_gated": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                      "src/repro/models/ssm.py:79, :177 and "
                      "src/repro/models/layers.py:65 (XLA in the reference, "
                      "no Pallas kernel)", "zamba2-dense-prefill"),
    "mamba_cell_gated": ("src/repro_torch/kernels/csrc/mamba_cell.cu",
                         "src/repro/models/ssm.py:152-177 and "
                         "src/repro/models/layers.py:65 (XLA in the "
                         "reference, no Pallas kernel)", "zamba2-dense"),
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/"
                            "flash_attention_bwd.cu",
                            "the backward of src/repro/kernels/"
                            "flash_attention.py:101, which has no VJP (the "
                            "reference's training differentiates "
                            "src/repro/kernels/xla_attention.py:333 in XLA)",
                            TRAIN_PATH),
    "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                    "the backward of src/repro/models/layers.py:65 (XLA in "
                    "the reference, no Pallas kernel)", TRAIN_PATH),
    "flash_attention_bwd_sync": ("src/repro_torch/kernels/csrc/"
                                 "flash_attention_bwd_sync.cu",
                                 "the backward of src/repro/kernels/"
                                 "flash_attention.py:101 (no VJP; the mma."
                                 "sync design, phase 7's yardstick)", None),
    "rmsnorm_bwd_serial": ("src/repro_torch/kernels/csrc/"
                           "rmsnorm_bwd_serial.cu",
                           "the backward of src/repro/models/layers.py:65 "
                           "(XLA in the reference; the one-row design, "
                           "phase 7's yardstick)", None),
}
# each model is built, checked (phase 4), served (phase 5), prefilled
# (phase 6, where listed) and freed in turn: (path, arch, strategy)
MODELS = (("dense", "qwen-7b", "dense"), ("strategy2", "qwen-7b", "strategy2"),
          ("strategy3", "qwen-7b", "strategy3"),
          ("chatglm-dense", "chatglm-6b", "dense"),
          ("xlstm-dense", "xlstm-1.3b", "dense"),
          ("none", "qwen-7b", "none"),
          ("starcoder2-none", "starcoder2-7b", "none"),
          ("starcoder2-dense", "starcoder2-7b", "dense"),
          ("starcoder2-strategy2", "starcoder2-7b", "strategy2"),
          ("granite-moe-dense", "granite-moe-3b-a800m", "dense"),
          ("mixtral-dense", "mixtral-8x22b", "dense"),
          ("qwen1.5-4b-dense", "qwen1.5-4b", "dense"),
          ("qwen3-8b-dense", "qwen3-8b", "dense"),
          ("gemma-2b-dense", "gemma-2b", "dense"),
          ("whisper-dense", "whisper-small", "dense"),
          ("zamba2-dense", "zamba2-7b", "dense"),
          ("qwen2-vl-dense", "qwen2-vl-7b", "dense"))
# the depth of three earlier weight sets, cut so the hybrid and vlm paths
# fit the script's time (phase 3 still holds their kernels at full width):
# xlstm-1.3b's blocks, 16 of 48 (2 segments of 7 mLSTM and 1 sLSTM),
# qwen-7b's strategy2 layers, 16 of 32, which its nine engine paths serve,
# and zamba2-7b's Mamba2 layers, 27 of 81 (4 shared-block sites, both
# blocks in turn, and the 3-layer tail, as the 81 have 13 sites and the
# tail): the host-bound hybrid paths took 241 s of 1,044 at full depth
XLSTM_SERVED_BLOCKS = 16
STRATEGY2_SERVED_LAYERS = 16
ZAMBA2_SERVED_LAYERS = 27
# config overrides of a model's paths: the MoE paths serve at the dropless
# capacity factor n_experts / top_k (a chunk then drops nothing, so mixed
# and sequential steps agree; the published 1.25 stays in the configs and
# is held in phase 4 (d)), and mixtral-8x22b runs 4 of its 56 layers (its
# 141 B parameters are ~70.5 GB at int4 before scales, KV and workspace)
MODEL_OVERRIDES = {
    "granite-moe-dense": dict(moe_capacity_factor=40 / 8),
    "mixtral-dense": dict(n_layers=4, moe_capacity_factor=8 / 2),
    "xlstm-dense": dict(n_layers=XLSTM_SERVED_BLOCKS),
    "strategy2": dict(n_layers=STRATEGY2_SERVED_LAYERS),
    "zamba2-dense": dict(n_layers=ZAMBA2_SERVED_LAYERS)}
# the paths whose MoE drops at the published factor phase 4 (d) records
MOE_DROP_PATHS = ("granite-moe-dense",)
PREFILL_PATHS = ("dense", "chatglm-dense", "xlstm-dense", "gemma-2b-dense",
                 "whisper-dense", "zamba2-dense", "qwen2-vl-dense")
# cache configurations served with a model's weights besides the slot fp
# cache: (path suffix, config overrides)
KV_PATHS = {"strategy2": (
    ("int8", dict(kv_quant="int8")),
    ("paged", dict(kv_layout="paged", kv_block_size=16, kv_pool_blocks=20)),
    ("paged-int8", dict(kv_layout="paged", kv_block_size=16,
                        kv_pool_blocks=20, kv_quant="int8"))),
    # kernel 3's int8 paged variant at head dim 256 on a served path
    "gemma-2b-dense": (
    ("paged-int8", dict(kv_layout="paged", kv_block_size=16,
                        kv_pool_blocks=20, kv_quant="int8")),),
    # the audio family's decoder self-attention on the paged pool
    "whisper-dense": (
    ("paged", dict(kv_layout="paged", kv_block_size=16, kv_pool_blocks=20)),),
    # the hybrid family's shared-block sites on the paged pool
    "zamba2-dense": (
    ("paged", dict(kv_layout="paged", kv_block_size=16, kv_pool_blocks=20)),),
    # kernel 3's int8 paged variant at rep 7 (28 over 4 heads) on a served
    # path
    "qwen2-vl-dense": (
    ("paged-int8", dict(kv_layout="paged", kv_block_size=16,
                        kv_pool_blocks=20, kv_quant="int8")),)}
# engines served with a model's weights after its cache paths, with their
# own workload: (path suffix, config overrides, engine arguments)
ENGINE_PATHS = {
    "dense": (("spec", {}, dict(spec_k=4)),),
    "strategy2": tuple(
        (f"{kv}-prefix", over, dict(prefix_cache=True, spec_k=4))
        for kv, over in KV_PATHS["strategy2"] if kv.startswith("paged"))}
# the lifecycle's engines, served after a model's engine paths: (path
# suffix, the cache path whose config they take, the path whose streams
# are their oracle, the function that serves them, what it serves)
LIFECYCLE_PATHS = {"strategy2": (
    ("paged-lifecycle", "paged", "strategy2-paged", serve_lifecycle,
     "lifecycle, preemption, quarantine"),
    ("paged-int8-chaos", "paged-int8", "strategy2-paged-int8-prefix",
     serve_chaos, "lifecycle, preemption, quarantine under chaos"),
    ("paged-int8-restart", "paged-int8", "strategy2-paged-int8-prefix",
     serve_restart, "snapshots, kills and restores"))}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        log(f"FAIL: torch is not importable: {e}")
        return 1
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; this script needs "
            "the card")
        return 1
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        log(f"FAIL: the port is not importable from {ROOT}/src: {e}")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: dict = {}
    t_start = time.perf_counter()
    try:
        log("phase 1: device")
        name = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = nvidia_smi("name,power.limit")
        log(f"  {name} x{count}; nvidia-smi: {smi}; torch "
            f"{torch.__version__} cuda {torch.version.cuda}")
        results["device"] = {"name": name, "count": count, "nvidia_smi": smi}

        log("phase 2: build")
        t0 = time.perf_counter()
        reports = _build.build()
        for k, rep in reports.items():
            log(f"  {k}:")
            for ln in ptxas_lines(rep):
                log(f"    {ln}")
        log(f"  built in {time.perf_counter() - t0:.1f} s")
        results["ptxas"] = reports

        log("phase 3: kernels against their plain versions")
        timer = Timer(torch)
        line = check_kernels(torch, timer, results)
        del timer
        torch.cuda.empty_cache()

        counts: dict = {}       # path -> that path's own launch counts
        for model, arch, strategy in MODELS:
            cfg, params = build_model(torch, arch, strategy,
                                      **MODEL_OVERRIDES.get(model, {}))
            paths = [(model, cfg)] + [
                (f"{model}-{kv}", dataclasses.replace(cfg, **over))
                for kv, over in KV_PATHS.get(model, ())]
            for path, pcfg in paths:
                log(f"phase 4 [{path}]: {arch}, mixed_step vs sequential "
                    "decode_step")
                check_mixed_equals_sequential(torch, pcfg, params, results,
                                              path)
                if pcfg.family != "ssm":
                    check_all_logits(torch, pcfg, params, results, path)
                    check_fused_equals_plain(torch, pcfg, params, results,
                                             path)
                if path in MOE_DROP_PATHS:
                    check_moe_drops(torch, pcfg, params, results, path)
                check_no_sync(torch, pcfg, params, results, path)
            streams: dict = {}
            for path, pcfg in paths:
                log(f"phase 5 [{path}]: serving")
                counts[path], streams[path] = serve(
                    torch, pcfg, params, results, path, streams.get(model))
            for suffix, over, engine_kw in ENGINE_PATHS.get(model, ()):
                path = f"{model}-{suffix}"
                log(f"phase 5 [{path}]: serving with {engine_kw}")
                counts[path], streams[path] = serve(
                    torch, dataclasses.replace(cfg, **over), params, results,
                    path, engine_kw=engine_kw)
            for suffix, kv, oracle, fn, what in LIFECYCLE_PATHS.get(model,
                                                                    ()):
                path = f"{model}-{suffix}"
                log(f"phase 5 [{path}]: {what}")
                over = dict(KV_PATHS[model])[kv]
                counts[path], _ = fn(
                    torch, dataclasses.replace(cfg, **over), params, results,
                    path, streams[oracle])
            if model in PREFILL_PATHS:
                log(f"phase 6 [{model}]: {arch}, prefill and forward")
                check = (check_xlstm_prefill if cfg.family == "ssm" else
                         check_hybrid_prefill if cfg.family == "hybrid" else
                         check_audio_prefill if cfg.family == "audio" else
                         check_vlm_prefill if cfg.family == "vlm" else
                         check_prefill_forward)
                check(torch, cfg, params, results, model, counts,
                      streams[model][-1])
            if model == "strategy2":
                log(f"phase 6 [{model}]: prefill into int8 and paged caches")
                check_prefill_caches(torch, cfg, params, results, streams)
            del params
            torch.cuda.empty_cache()
            log(f"  ({time.perf_counter() - t_start:.0f} s so far)")

        log(f"phase 7: training ({TRAIN_ARCH} at full width, "
            f"{TRAIN_LAYERS} layers)")
        line.update(check_training(torch, results, counts))
        log(f"  ({time.perf_counter() - t_start:.0f} s so far)")
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        write_details(results)
        return 1
    results["seconds"] = time.perf_counter() - t_start
    log(f"all phases passed in {results['seconds']:.1f} s (the build "
        "included)")
    write_details(results)

    kernels = []
    for kname, (source, replaces, path) in KERNEL_META.items():
        # path None: a yardstick (phase 3's or 7's), on no served path
        r = line[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": counts[path].get(kname, 0) if path else 0,
            "launches_path": path,
            "launches_by_path": {p: c.get(kname, 0)
                                 for p, c in counts.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


def write_details(results: dict) -> None:
    out = os.path.join(ROOT, "chiprun_out")
    try:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "chip_smoke.json"), "w") as f:
            json.dump(results, f, indent=1, default=str)
    except OSError as e:
        log(f"  (details not written: {e})")


if __name__ == "__main__":
    sys.exit(main())
