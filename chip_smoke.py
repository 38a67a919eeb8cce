#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels flash_bwd,msda_bwd   # checks alone
    python3 chip_smoke.py --phase flagship               # one model phase
    python3 chip_smoke.py --phase eval                   # the eval path
    python3 chip_smoke.py --phase train                  # the det step
    python3 chip_smoke.py --phase trainer                # Trainer.train
    python3 chip_smoke.py --phase tooltrain              # five tool groups
    python3 chip_smoke.py --phase loratrain              # LLaMA-7B LoRA

Phases, each printing one JSON line:

1. device  - requires a CUDA card (exits 2 without one) and prints
             `nvidia-smi --query-gpu=name,power.limit` for it;
2. build   - builds every CUDA kernel of the det and chat paths from
             `visionllm_tpu_torch/csrc/` (one nvcc per source, in
             parallel) and the host libraries of `csrc/host/` (g++: the
             resizer, the RLE codec, the JPEG decoder), and reports the
             seconds;
3. kernel  - holds each kernel against its plain PyTorch version at the
             main-path shapes, on the card, with the tolerance below, and
             times the kernel, the plain version and one PyTorch library
             call computing the same function (yardstick only; the port
             never calls it); a backward kernel is held against autograd
             of the plain forward, output by output. The flash forward
             also runs the chat prefill (B4 L640), a causal L2048 and a
             slot service's B1 L640 prefill with left-pad segments; the
             int4 GEMM adds the slots phase's M 8 (a tick) and M 256 (a
             chunk window), and InternLM2-20B's five widths at M 4 (K up
             to 16384, N up to 92576) and gate/up at M 2560.
             Every case prints `device_ms` (and `library_device_ms` where
             a library call computes the same function): device time per
             call from torch.profiler's kernel events, one profiler
             context per check, beside `ms` (CUDA events around
             back-to-back calls, which for a short kernel include the
             wrapper's host time); the phase fails unless a flash-forward
             or int4 call is one kernel and a flash backward call
             `FLASH_BWD_KERNELS`. The flash forward adds the LLaMA
             prefills of the perception phase's detect and pose prompts.
             The MSDA cases add inputs of the model's own sampling,
             captured from a warm det request, a detect request's encoder
             and a pose request's post-expansion decoder at the 800 px
             test scale, and a train step (`captured_*`; each capture
             builds its model), and DCNv3's sampling in the four stages of
             InternImage-H at the det26b image (`dcnv3_stage*`: one
             level, 9 points, 10-80 groups of 32 channels), and time the
             grid_sample composition (`composite_*`) where no single
             library call computes MSDA. The flash forward also runs the
             26B det path's InternViT (B7 L1025, 25 heads, bidirectional)
             and InternLM2 prefill (L1868, 48 heads over 8), the whole
             26B model's InternViT on one tile (B1 L1025) and its chat
             prefill (B4 L640, 48 heads over 8), the gen
             phase's [EDIT] prefill (L614), and the eval phase's B8 batch:
             the 80-class det prompt's prefill (`eval_prefill_b8`) and
             CLIP at B8; the MSDA forward adds that batch's encoder at the
             800x1088 bucket (`eval_b8_encoder`, B8, S = Q = 18071).
             The MSDA forward and backward add UniPose's training
             decoder at the tooltrain phase's B2 640 px batch with box
             references (`msda_box_inputs`): Q = num_queries + dn (1100)
             and groups x (1 + body points) + dn (3650).
             The lane gather adds seeded random indices (out-of-range
             ones too) at [8, 57344], [8, 57343] and a two-CTA extent,
             each case with the cluster size it launched;
4. slice   - the det path: builds `VisionLLMWithTools` at full width
             (CLIP-L/336 24 layers, LLaMA-7B 32 layers, Grounding-DINO
             with Swin-T at 512 px) in bf16 with seeded random weights,
             answers 3 det requests through `infer_det`, checks shapes,
             finiteness and the launch counters (flash 56 and MSDA 12 per
             request), holds the text queries and the top-900 selection
             against the same model run with the plain versions, and
             times a request and its stages;
5. profile - one more det request under torch.profiler: device kernel
             time, the device's idle share, the kernels that take the
             most and each kernel of the port's own (as in the other
             `*_profile` phases);
6. perception - the perception front door, after the det model is
             freed: `vllm_7b_perception_config()` (the det path's model
             plus UniPose with Swin-T, 68 body points, 50 groups) at full
             width in bf16, one `Predictor` and a `ChatService` sharing
             its core behind `make_server(..., predictor=...)`. Three
             uint8 images (480x640, 640x480, 500x500: the 800x1088,
             1088x800 and 800x800 buckets of the 800 px test scale) each
             answer detect, ground and pose (`PERCEPTION_REQUESTS`)
             directly and over HTTP on 127.0.0.1: the replies must be
             identical, finite and of the expected shapes, and every
             request must launch flash 56 and MSDA 12 times. Each direct
             call's raw tool outputs (before the post-processing's
             top-k, recorded by `predictor_call`) are held against the
             plain versions on the kernel run's proposal and group
             choices; then the warm request
             times and the phase's peak memory;
7. perception_profile - one detect and one pose request under
             torch.profiler;
8. serve   - the chat path, after the perception model is freed:
             `build_core` of the 7B chat config with `quant="int4"` at
             full width, `ChatService(max_batch=4, max_prompt=640,
             max_new_tokens=32)` with the port's `SimpleTokenizer`; 4
             image requests from threads (one generate call), the first
             of them again alone, a text-only request with a history,
             and the first again over HTTP. Checks the answers, the
             launch counters (int4 225 per forward, flash 56 per generate
             call), holds the prefill and every decode step's logits
             against a plain run teacher-forced on the kernel run's
             tokens, and times TTFT, a decode step and tok/s;
9. serve_profile - one decode step under torch.profiler;
10. slots  - continuous batching on the serve phase's int4 core (no second
             7B model), with the port's `RoundTripTokenizer` (generated
             ids survive the text round trip, so a session's history can
             match its cached prefix). Service A is `ChatService(slots=8,
             prefill_chunk=256, decode_span=4, sessions=2, max_prompt=640,
             max_new_tokens=32)` (prompts round up to 768, slot_max_len
             1288): 12 requests from threads in 3 waves 150 ms apart
             (admissions land mid-decode, the backlog fills), one more
             over HTTP with "stream": true, and a two-turn session with an
             image. Service B is `ChatService(slots=4, sampling=True,
             max_prompt=640, max_new_tokens=32)`: 4 concurrent requests,
             two seeded at temperature 0.7 and top_p 0.9, one at
             temperature 0, one at top_p 1e-6. Checks: each request's
             tokens equal the same request decoded alone; every request's
             prefill and decode logits, teacher-forced through the slot
             engine on the service's tokens, within LOGIT_REL_TOL of the
             plain versions; a chunked admission's first-token logits and
             the session extension's within LOGIT_REL_TOL of a B1 prefill
             (of the whole conversation for the session, which must report
             `session_reused`); the SSE deltas joined equal the blocking
             answer; greedy rows equal their greedy answers alone, a seed
             alone twice and in the batch gives the same tokens, sampled
             tokens lie in the nucleus of the kernel run's logits and of
             the plain run's up to NUCLEUS_SLACK; the launches are int4
             225 per LLM forward (span forwards a tick) and flash 24 per
             chunked and 56 per B1 admission; after close() with live
             slots every waiting call raises within CLOSE_WAIT_S. Then
             service A's engine on a fresh state: ms a tick with 8 live
             slots at span 1 and 4 (aggregate tok/s), the longest gap
             between ticks while a slot is refilled by a chunked or a B1
             admission; the TTFT of requests admitted mid-decode; slot
             occupancy and peak memory;
11. slots_profile - one span-1 tick with 8 live slots under
             torch.profiler (printed before the slots line, which
             carries service B's results);
12. spec   - speculative decoding on the serve phase's int4 core:
             `ChatService(spec_k=7, max_batch=1, max_prompt=640,
             max_new_tokens=32)` against a plain greedy
             `ChatService(max_batch=1)` on an image request, a text-only
             request with a history and an image request over HTTP. Checks
             the launches (flash 56 per image request, 32 per text-only
             one, which skips the vision encoder; int4 225 per forward:
             the prefill and each window; a request after the auto-disable
             runs the plain loop), `metrics()`, and the token rule: tokens
             equal the plain loop's, or differ first where the plain run's
             top-2 logit gap is within NEAR_TIE_ULPS bf16 ulps, and the
             windowed decode's logits teacher-forced on the plain tokens
             lie within LOGIT_REL_TOL of the step loop's. Then
             `build_speculative_generate_fn` directly with the [GEN]
             countdown forced (first_token, 72 new tokens) against
             `build_generate_fn`: the token rule, the 64 forced rows in
             ceil(64 / 8) = 8 windows, tokens per window and ms per
             emitted token against the plain B1 loop, forced and free;
13. quant  - the int8 serving modes, after the int4 core is freed: the
             bf16 7B chat core from seed 0 answers the 4 image requests in
             one [4, 640] generate call (the reference tokens and
             teacher-forced logits), is quantized in place
             (`quantize_llm_int8`; layer 0's q_proj and down_proj equal
             the CPU's quantization bit for bit) and serves the 4 requests
             from threads through `ChatService(max_batch=4)` in int8 and
             in w8a8 (one tree): flash 56 per call, logits against the
             bf16 core's within QUANT_COS_MIN and QUANT_AGREE_MIN, TTFT,
             decode ms a step, tok/s, peak memory. The README's chunked
             int8-KV command must raise JAX's ValueError; then
             `ChatService(slots=8, max_ctx=1288)` with int8 weights and
             `kv_quant="int8"` at span 1: 6 requests in 2 waves, each
             equal to its tokens alone in the same service, flash 56 per
             B1 admission, the slot state's bytes, ms a tick with 8 live
             slots and one profiled tick. Its kernel lines
             (`"kernel": "int8_products"`) give per-call device time of
             `Int8Linear`, `Int8ActLinear`, the bf16 `F.linear` and the
             int4 kernel at M 4, 8, 2560 for 4096x11008 and 4096x32096
             (the w8a8 int32 product exact against float64), and of
             `int8_kv_attention` against the bf16 einsum decode at 8 slots
             x 1288, each beside its bound;
14. train  - the det training step, after the chat model is freed: the
             stage-1 frozen `vllm_7b_det_config()` at full width and
             depth (LLaMA 32 layers, CLIP 24, Grounding-DINO with Swin-T
             at 640 px, CDN with dn_number 100, 12544 mask points) in
             bf16 with fp32 masters, bs 1 as `bench_train.py` builds its
             batch. One step with the kernels against the plain versions
             (same weights, batch, draws and discrete choices): the loss
             terms against the all-plain step, the trainable gradient
             against the step with the plain backwards (see run_train);
             then 5 AdamW steps: finite losses, trainable masters moved,
             frozen parameters bit-identical, and per step flash fwd 56,
             flash bwd 32, MSDA fwd 12, MSDA bwd 12 launches; step ms,
             peak memory, the loss trace;
             Then the one step (same batch, draws and choices) with
             `GDinoConfig.remat` "full" and then "dots": each loss term and
             the gradient within TRAIN_REL_TOL of the step without remat
             (no bitwise claim: the MSDA backward adds with atomics), MSDA
             fwd 24 a step (each layer once more in the backward), flash
             56 / 32 and MSDA bwd 12 as without, each mode's peak;
15. train_profile - one more step under torch.profiler;
15b. trainer - `Trainer.train` from files, after the train model is
             freed: the committed JPEG fixtures (`tests/data/jpeg/`, 7
             files at COCO sizes in every layout the decoder reads), each
             listed 3 times in a COCO-style annotation file with its drawn
             objects as boxes and polygons (3 categories, 3-6 objects an
             image), the stage-1 frozen `vllm_7b_det_config()` in bf16 at
             the 640 px bucket, batch TRAINER_BATCH, TRAINER_WORKERS
             loader threads, TRAINER_STEPS steps, a checkpoint every
             TRAINER_SAVE_EVERY. Checks, each failing the run: (1) every
             fixture decodes on this host to the sha256 of Pillow's
             pixels in the manifest; (2) the native resizer (CLIP and det
             sizes), normalize/pad (3e-7) and RLE codec equal their numpy
             versions on a fixture and its masks; (3) the Trainer's loader
             at TRAINER_WORKERS threads gives the synchronous loop's
             batches byte for byte; (4) finite losses and, per step,
             flash fwd 56, flash bwd 32, MSDA fwd 12, MSDA bwd 12
             launches; (5) the first batch's loss and gradient norm with
             the kernels within TRAIN_REL_TOL of the plain versions;
             (6) fresh Trainers on fresh models resume from the step-3
             checkpoint: one with the synchronous loop on to step
             TRAINER_RESUME_STEPS, TRAINER_REPEATS more with the main
             run's loader to step TRAINER_STEPS. Each one's live state
             equals the checkpoint bit for bit (step, sampler position,
             generator, fp32 masters, AdamW moments, the parameters their
             masters rounded), and its step 4 repeats the straight run's
             loss terms bit for bit (the forward reads the restored
             weights, generator and sampler position). After that the
             runs are not bitwise (the MSDA backward adds with fp32
             atomics, and random weights carry that into the next steps'
             losses and matchings), so the resumed runs' own spread sets
             the gate: each one's distance from the straight run, in the
             metrics of steps 4-6 and in the masters and moments after
             steps 4 and 6, within RESUME_SPREAD_K_LOSS and
             RESUME_SPREAD_K_STATE times the largest distance between two
             resumed runs. A fault of the resume itself (the optimizer's
             step or schedule) moves every resumed run alike, away from
             the straight run. Prints decode ms and MB/s per fixture, native and
             numpy resize ms, data ms a batch at 0 and TRAINER_WORKERS
             workers, the step intervals and data waits of both runs
             (the median of those without a save, snapshot or profiler),
             checkpoint save, load and resume seconds, and peak memory;
15c. trainer_profile - the last step of each run under torch.profiler,
             from the end of the step before (the loop's wait for the
             batch included): device ms and idle share with the prefetch
             loader (step 6) and with the synchronous loop (step 8);
15d. tooltrain - `Trainer.train` of the whole 7B flagship over the five
             tool groups, after the trainer phase's model is freed:
             `build_model(vllm_7b_config())` in bf16 (both Swin-T patch
             biases drawn from a seed, as in the trainer phase), stage 1
             (the vision encoder, the LLM, the [GEN] UNet and both VAEs
             frozen; 1.06 B trainable, most of it the [EDIT] UNet), from
             the JPEG fixtures with annotation files the phase writes:
             COCO det (boxes, polygons), COCO keypoints (17 an object in
             its box, visibilities drawn from KEYPOINT_SEED), captions
             (text2img), consecutive fixture pairs (ip2p) and two-turn
             llava conversations (chat, `llava_rows`); det and pose at the
             640 px bucket, [GEN] / [EDIT] at TOOL_GEN_SIZE px, chat's
             CLIP image padded to a square; TOOL_BATCH, TOOL_WORKERS
             loader threads, TOOL_STEPS steps whose sampler (seed
             TOOL_SEED) gives each group once in steps 1-5 and once in
             6-10, a checkpoint at TOOL_SAVE_EVERY. Checks, each failing
             the run: (a) for the first pose, [GEN], [EDIT] and chat
             batch, one step's metrics and gradient norm with the
             kernels within TRAIN_REL_TOL of the plain versions (same
             draws and choices); (b) TOOL_REPEATS fresh Trainers on the
             same model resume from the step-5 checkpoint (the first
             one's live state equal to it bit for bit) to TOOL_STEPS: step
             6's loss terms bit for bit, then each run's distance from
             the straight run in the metrics of steps 6-10 and the final
             masters and moments
             within RESUME_SPREAD_K_LOSS / _STATE times the largest
             distance between two resumed runs (the states compared by
             `state_sketch`); (c) launches per step and group (flash fwd
             / bwd, MSDA fwd / bwd: det and pose 56 / 32 / 12 / 12, [GEN]
             32 / 32 / 0 / 0, [EDIT] and chat 56 / 32 / 0 / 0), the frozen
             parameters
             bit-identical after all runs (64-bit digests), 90 % of the
             trainable masters moved; (d) `evaluate_pose` on the pose
             fixtures in test mode at B8 and B1 gives the same metrics,
             and the gt fed back as detections scores OKS mAP 1.0. Prints
             per group the step intervals (median), launches and peak,
             the checkpoint's bytes, save, load and restore seconds;
15e. tooltrain_profile - each of steps 6-10 of the first resumed run (one
             a group) in a synced range of one profiler context: device
             ms, idle share and the port's kernels;
15f. loratrain - LLaMA-7B's LoRA adapters, with nothing else resident:
             `build_model(vllm_7b_chat_config(llm=LLMConfig(vocab_size=
             32096, lora_r=32, lora_alpha=64.0)))` in bf16 (CLIP-ViT-L/336,
             `mlp2x_gelu`, LLaMA-7B with `LoraLinear` q/k/v/o and
             gate/up/down), the vision encoder and the LLM frozen (the
             LoRA factors, the bridge and the [EMB] tables train), from
             four-turn llava conversations over the JPEG fixtures (each
             listed LORA_COPIES times) that pad every batch of LORA_BATCH
             to L LORA_SEQ, LORA_WORKERS loader threads, the CLIP image
             padded to a square. Checks, each failing the run: (a) the
             first batch's chat step with the plain versions within
             TRAIN_REL_TOL of the kernels' in loss and gradient norm
             (both under remat "full"); (b) the same step under
             `LLMConfig.remat` "", "full" and "dots" on the one model: the
             loss bit for bit across the modes, every trainable gradient
             within LORA_GRAD_REL_TOL of the no-remat run's, flash fwd 56
             a step without remat and 88 with it, bwd 32; (c) the main
             path: `Trainer.train` with
             `grad_accum_steps` LORA_ACCUM under remat "full" for
             LORA_MICRO_STEPS micro-steps: each micro-step that applies no
             update leaves the masters and the parameters bit-identical
             (held against copies on the card), the others move them,
             LORA_MICRO_STEPS /
             LORA_ACCUM applied steps at the end, flash 88 / 32 a
             micro-step; a fresh Trainer resumes from the one checkpoint,
             taken at micro-step LORA_SAVE_AT (mid-accumulation: its live
             state equal to it bit for bit, the running mean included)
             and finishes within LORA_RESUME_REL_TOL of the straight run
             in masters, moments and metrics (bitwise reported); (d)
             `merge_lora_params` into a `lora_r=0` model (assigned on the
             meta device, no second draw) gives the LoRA model's logits
             within TRAIN_REL_TOL (the base model's distance reported).
             Prints each remat mode's peak and device ms (a synced range
             of one profiler context), the main run's step intervals,
             each resumed micro-step's device ms and idle share, the
             checkpoint's bytes and save / load seconds;
16. probes - the gather probes' entry point
             (`visionllm_tpu_torch/tools/msda_kernel_attempts.py`);
17. gen     - the [GEN] and [EDIT] tools, after the train model is
             freed: `build_model(vllm_7b_gen_config())` (CLIP-L/336,
             LLaMA-7B, the SD-1.5 and InstructPix2Pix heads at 512 px) in
             bf16 with the mappers and GroupNorms in fp32. A [GEN] request
             (the JAX gen dataset's question template, vicuna_v1, text
             only: its prefill takes the einsum branch) and an [EDIT]
             request (a uint8 512x512 image, to CLIP at 336 px and to the
             VAE at 512 px in [-1, 1]) each make their image GEN_WALL_RUNS
             times as a user does: greedy `build_generate_fn` with the
             first token forced, the 64 [EMB] rows, the head's `generate`
             (GEN_STEPS DDIM steps, guidance 7.5, image guidance 1.5) from
             generator seed GEN_SEED. Checks: the forced tokens, flash 0
             and 56 (24 CLIP + 32 LLaMA) launches a generate call, images
             [1, 512, 512, 3] finite and bit-identical across the runs, the
             rows and the logits after the last forced row against the
             plain flash run within GEN_REL_TOL (and the distance between
             the images of the two runs' rows). Then the generate call,
             mapper, UNet step (B 2 and B 3, with its FLOP bound and the
             fp32 score bytes of the 64² attentions), GEN_STEPS loop, VAE
             encode and decode and whole image ms, the weights' and the
             peak memory;
18. gen_profile - one [EDIT] image under torch.profiler;
19. flagship - the whole 7B flagship, after the gen model is freed:
             `build_model(vllm_7b_config())` (CLIP-L/336, LLaMA-7B,
             Grounding-DINO and UniPose on Swin-T, both SD heads and the
             region encoder) in bf16, the mappers, norms and the region
             encoder's LayerNorms in fp32. From that one model, once each:
             `infer_det` on the det prompt and on the det prompt with a
             <region> (flash 56, MSDA 12); `Predictor` detect and pose on
             an 800x1088 uint8 image; a [GEN] and an [EDIT] image
             (FLAGSHIP_GEN_STEPS DDIM steps; flash 0 and 56). Then region
             prompts on a uint8 480x640 image with max_regions 8
             (`RoundTripTokenizer`, FLAGSHIP_NEW tokens, prompts
             left-padded to 640):
             `ChatService(max_batch=1)` answers one box, the mask of that
             box, three regions (two boxes and a blob) directly and over
             HTTP /v1/generate with an RLE mask, and the first prompt
             with another box; `ChatService(spec_k=7)` and a
             B1-admission `ChatService(slots=2)` the box request;
             `ChatService(slots=4, prefill_chunk=256, sessions=2)` the box
             request admitted while a text request decodes, then a
             session: a follow-up with the same regions must report
             `session_reused`, one with a changed region must not. Flash
             56 per B1 dispatch, speculative or B1-admission request, 24
             per chunked admission (the region encoder reads the ViT
             pass's levels: no second pass); `ChatService(max_batch=4)`
             must refuse regions in JAX's words. Checks against the plain
             versions on the same weights within LOGIT_REL_TOL: both det
             requests (text queries, logits, boxes), detect and pose (raw
             outputs), the gen rows and logits, the box request's region
             rows [1, 4096], first-step and teacher-forced logits; every
             other mode's tokens by the near-tie rule against the B1
             run's. What the region path gave each call, recorded as it
             ran (`RegionTrace`): the mask and its box, and HTTP and the
             direct call, the same masks and bit-identical <region> rows;
             spec and both slot modes the B1 request's masks, rows and
             first-step logits within LOGIT_REL_TOL; the reused session
             turn no second region assembly, the changed one its B1
             reference's masks, rows and logits; another box's rows
             REGION_SEPARATION times farther off than any of those errors
             or the kernel-vs-plain one. Then TTFT with and without the
             regions (median of FLAGSHIP_TIMED),
             the slot refill gap of a region admission (chunked and B1),
             the region encoder's FLOP and byte bound at R = 8, weights
             and peak memory;
20. flagship_profile - the three-region request's generate call under
             torch.profiler, its region encoder in a synced range: the
             encoder's device ms and kernels beside its bound;
20a. convert - the flagship model written out as the released checkpoint
             would hold it (`tests/torch_ref_layout.py`): every tensor
             under the reference's key name as a copy on the card, with
             the shared heads' tied aliases, the index buffers, CLIP's
             post_layernorm and the SD text encoders' keys; converted
             back by `utils.torch_convert.convert_composite` into a second
             `build_model(cfg, state_dict=...)` (laid out on the meta
             device, each tensor assigned): no key unread outside the
             JAX package's allowlist (`ReadRecorder`), no parameter
             unfilled, every tensor bit-equal to the original's and its
             `infer_det` bit-equal to the original's on the det request
             (flash 56 and MSDA 12, counted around it alone); then the
             region encoder, both mappers and Grounding-DINO written as
             .safetensors and as .bin, read back by
             `load_state_dict_files` bit for bit and converted to their
             modules' state. Prints the seconds to write out, convert,
             load and compare, the checkpoint's GB, the peak card memory
             and the host's peak RSS while converting;
20b. profiling - on the flagship model: one `infer_det` under
             `utils.profiling.trace`, whose Chrome trace must hold 56
             flash and 12 MSDA kernel events; one under
             `profiling.debug_nans` (forward hooks on every module), which
             must not raise; flash 112 and MSDA 24 launches around the
             two. Then `fit_device_time` of the flash forward at the
             kernel table's main case (LLaMA B1 L586 32x128 causal),
             finite and positive, beside the kernel phase's `device_ms`
             of that case (in a whole run);
20c. evalx - the rest of the eval layer on the flagship model, on sets
             written without Pillow (`write_evalx_set`: the eval phase's
             COCO set, 4 RGB PNGs at ADE20K sizes with gray label PNGs
             over the 150 classes, a region-caption file): with the
             launch counts taken around them alone, `evaluate_semseg`
             (the 150 class names, 32 prompted: a prompt of about 900
             tokens), `evaluate_interactive` (4 images, up to 8 regions
             an image from `ShapeSampler`), `run_region_eval` for
             region-caption and region-recognition (4 rows each,
             EVALX_REGION_NEW tokens) and `evaluate_det` over `sod_det`
             with masks and `odinw_det` (4 images each, one B4 forward,
             top EVAL_TOPK); flash 56 and MSDA 12 an `infer_det` call,
             flash 56 and MSDA 0 a region generate call. Gates on each
             eval's first sample against the plain versions on the
             kernel run's proposals (`det_vs_plain`,
             `interactive_vs_plain`: the logits, boxes and mask logits,
             the kernel run's top-k or picks by (query, label), within
             EVAL_REL_TOL; `region_vs_plain`: the answer teacher-forced,
             within LOGIT_REL_TOL, tokens by the near-tie rule). Then,
             the model freed, `python3 -m visionllm_tpu_torch.cli
             eval-interactive --limit 2` in a subprocess on the card (it
             builds `vllm_7b_config()` itself): exit 0, one JSON line with
             `region_acc@0.5`, its build and eval seconds;
21. det26b - the whole 26B flagship, with nothing else resident:
             `build_model(vllm_26b_config())` once, at full width and
             depth (InternViT-6B/448 48 layers, pixel shuffle and
             `internvl_mlp`, InternLM2-20B 48 layers at 48 heads over 8 KV
             heads, Grounding-DINO and UniPose each on its own
             InternImage-H, the SD-1.5 and InstructPix2Pix heads with their
             6144 -> 768 mappers, the region encoder 3200 -> 6144) in bf16
             on the card, the fp32 parts as at 7B; its parameters and GB
             beside the host-only count `model_size` (they must agree).
             Then, on that one model, in sections, each with its launch
             counts set to 0 before its main path and read after it, and
             each failing at a peak of DET26B_PEAK_LIMIT bytes or more:
             convert26 - InternViT-6B's and InternLM2-20B's 48 layers
             each, one at a time, written out under the reference's key
             names (InternLM2's q / k / v packed into `wqkv` at 48 heads
             over 8) and converted back by `convert_intern_vit_layer` /
             `convert_internlm2_layer` bit for bit, every key read; then
             the embeddings, InternLM2's norm and `output` head, the
             `internvl_mlp` bridge and the region encoder; the
             Grounding-DINO and UniPose converters must raise naming
             `intern_image_h` (no reference converter reads InternImage;
             `ROADMAP.md` §C.2). Launches no kernel;
             det - an 800x1088 uint8 image answers a det request as a
             7-tile stack (`dynamic_preprocess`: 7 x 256 image tokens, L
             1868) and as one tile (L 332), each once and DET26B_REPEATS
             warm repeats more through `infer_det`: shapes, finite values,
             flash 96 (48 InternViT + 48 InternLM2) and MSDA 62 (50 DCNv3
             + 12 Grounding-DINO) launches a request. Each request's text
             queries and the raw tool outputs of its last `infer_det`
             call are held against the plain versions on the same
             weights (the kernel run's proposal choice) within
             DET26B_REL_TOL, and an fp32 run witnesses the gate
             (`fp32_witness`: the core widened to fp32 a layer at a time,
             Grounding-DINO widened to fp32, plain versions): the kernel
             run may sit at most DET26B_WITNESS_RATIO times as far from
             it as the bf16 plain run, for the text queries, the tool
             alone, the whole path and each InternImage stage map;
             DET26B_DECODE greedy tokens at B1 from the 7-tile prompt
             (`build_generate_fn` on the same core) against the plain
             run's by the near-tie token rule; request,
             vision, prefill and Grounding-DINO ms, the decode ms a step
             (the `det26b` line; then `det26b_profile`);
             predictor - `Predictor` on the same image (the 800x1088
             bucket of the 800 px test scale) answers detect (3 classes,
             top 20, masks), ground and pose, and pose again over HTTP
             (`make_server(None, predictor=...)`: the reply identical):
             flash 96 and MSDA 62 (50 DCNv3 + 12 UniPose for pose) a
             request, the replies' shapes; each request against the plain
             versions on the kernel run's choices, stage by stage: the
             text queries (flash through InternViT and InternLM2) and the
             raw tool outputs on the kernel run's text queries (MSDA
             through the backbone and the tool) within
             PERCEPTION_REL_TOL each; end to end (both stages plain)
             reported and held only by `fp32_witness` (the tool's fp32
             copy, Grounding-DINO then UniPose, freed after) at
             DET26B_WITNESS_RATIO; warm request ms;
             gen - a [GEN] and an [EDIT] image at 512 px, DET26B_GEN_STEPS
             DDIM steps,
             each made DET26B_GEN_RUNS times from one seed (bit-identical),
             flash 0 and 96 a generate call; the forced rows, the logits
             after the last forced row and each mapper's output on the
             rows against the plain run within GEN_REL_TOL, and the rows
             `VisionLLM.extract_gen_embs` takes from one prefill of the
             prompt and the emitted tokens against the decode's;
             regions - on a uint8 480x640 image under `internlm2_chat`, a
             box request and a mask request (the same region) through B1
             dispatch (`ChatService(max_batch=1)`, flash 96) and through
             `ChatService(slots=2, prefill_chunk=256)` (flash 48, the
             vision encoder: the chunk windows take the einsum branch),
             and another box through B1 dispatch; what the region path
             gave each call (`RegionTrace`) held as in the flagship
             phase: the box and the mask the same masks and bit-identical
             rows, the slot service the B1 box request's masks and its
             rows and first-step logits within LOGIT_REL_TOL, the B1 box
             request's rows, first-step and teacher-forced logits and a
             chunked admission's first step within LOGIT_REL_TOL of the
             plain versions, another box's rows REGION_SEPARATION times
             farther off, the slot tokens by the near-tie rule;
             chat_bf16, chat_int4 - `ChatService(max_batch=4,
             max_prompt=640, max_new_tokens=DET26B_CHAT_NEW,
             conv_version="internlm2_chat")` answers the serve phase's 4
             image requests from threads in one generate call, in bf16,
             then again after the core's LLM is quantized to int4 in
             place (`quantize_serving_params`; 337 `Int4Linear`s): flash
             96 a generate call, int4 337 a forward, the kernel run
             against the plain run teacher-forced on its tokens within
             LOGIT_REL_TOL, TTFT, ms a decode step and tok/s. The
             `det26b_whole` line gives the build, every section's peak
             and seconds and the launch totals;
22. det26b_profile - each det request once under torch.profiler;
23. eval    - the det and grounding evaluation path, with nothing else
             resident: `build_model(vllm_7b_det_config())` in bf16 and a
             synthetic COCO set written to a temporary directory without
             Pillow (`write_eval_set`: 12 PNGs at COCO sizes, 8 in the
             800x1088 bucket, 3 in 1088x800, 1 in 800x1344, read back
             through the port's PNG reader; 3-6 objects each as polygons,
             uncompressed and compressed RLE, a crowd object, a box under
             1 px; the 80 COCO categories; a RefCOCO-style file, a POPE
             jsonl and an MMBench tsv with base64 PNGs). Checks, each
             failing the run: (1) the gt fed back as detections scores
             bbox and segm mAP 1.0; (2) `evaluate_det(with_mask=True,
             topk=EVAL_TOPK, batch_size=8)` and `evaluate_det(batch_size=1)`
             finish with finite metrics; (3) each image's top-k of the
             two runs agree within EVAL_REL_TOL, matched by (query,
             label), an entry in one run only lying within EVAL_REL_TOL of
             the other's 100th score (orders part at ties); (4) the first
             B8 batch's text queries, logits and boxes with the kernels
             within EVAL_REL_TOL of the plain versions (on the kernel
             run's proposals); (5) flash 56 and MSDA 12 launches a forward
             (B8 or B1); (6) `evaluate_grd(with_mask=True)` gives finite
             Prec@0.5 and cIoU; (7) `run_benchmark("pope")` and
             ("mmbench") through `build_generate_fn` at `batch_size` 1 and
             4: each question's first-step logits within EVAL_REL_TOL, and
             its tokens equal up to the first step whose top-2 logit gap
             (B1, teacher-forced) is under EVAL_MARGIN; (8)
             `measure_latency` gives TTFT and decode tok/s. Prints
             images/s at B8 (with masks) and B1, each run's wall split
             into data, device, gt, masks and evaluator seconds, the
             phase's seconds and peak memory;
24. eval_profile - the first B8 batch's forward and top-k under
             torch.profiler.

Then it prints the `{"kernels": [...]}` line (each kernel's
`launches_by_path` counts every path that launched it, `convert` and
`profiling` among them), the card's name and power limit, and as its last
line `{"ok": true, "device": {...}}`. Any failed
check raises, so the script exits nonzero and prints no ok line.
"""

from __future__ import annotations

import argparse
import base64
import copy
import dataclasses
import functools
import gc
import glob
import hashlib
import importlib.util
import itertools
import json
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
import zlib
import urllib.request
from contextlib import ExitStack, contextmanager
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from visionllm_tpu_torch import constants as C
from visionllm_tpu_torch.config import (LLMConfig, OptimizerConfig,
                                        vllm_7b_chat_config, vllm_7b_config,
                                        vllm_7b_det_config,
                                        vllm_7b_gen_config,
                                        vllm_7b_perception_config,
                                        vllm_26b_config)
from visionllm_tpu_torch.data.coco import (decode_segmentation,
                                           rasterize_polygons)
from visionllm_tpu_torch.data.conversation import get_conv_template
from visionllm_tpu_torch.data.det_dataset import CocoDetDataset
from visionllm_tpu_torch.data.det_variants import (OdinwDetDataset,
                                                   SodDetDataset)
from visionllm_tpu_torch.data.grd_dataset import RefCocoGrdDataset
from visionllm_tpu_torch.data.interactive_dataset import \
    CocoInteractiveDataset
from visionllm_tpu_torch.data.semseg_dataset import SemSegDataset
from visionllm_tpu_torch.data import native_image
from visionllm_tpu_torch.data.build import (TaskGroupedBatchSampler,
                                            build_multi_datasets,
                                            group_of_task)
from visionllm_tpu_torch.data.image_io import (PNG_MAGIC, decode_image_bytes,
                                               load_image, load_label)
from visionllm_tpu_torch.data.mm_utils import (CLIP_MEAN, IMAGENET_MEAN,
                                               IMAGENET_STD, clip_preprocess,
                                               dynamic_preprocess,
                                               expand2square,
                                               expand_image_tokens,
                                               resize_image_np,
                                               tokenizer_image_token)
from visionllm_tpu_torch.data.pose_dataset import CocoPoseDataset
from visionllm_tpu_torch.data.preprocess import (preprocess,
                                                 preprocess_multimodal)
from visionllm_tpu_torch.data.templates import (DET_QUESTIONS, DET_YES,
                                                det_answer_tokens)
from visionllm_tpu_torch.data.transforms import (DEFAULT_BUCKETS,
                                                 TEST_SCALE,
                                                 det_test_transform,
                                                 keep_ratio_size)
from visionllm_tpu_torch.eval import eval_det as E
from visionllm_tpu_torch.eval.coco_eval import CocoMAPEvaluator
from visionllm_tpu_torch.eval.eval_det import evaluate_det, model_inputs
from visionllm_tpu_torch.eval import region_eval as RE
from visionllm_tpu_torch.eval.eval_grd import evaluate_grd
from visionllm_tpu_torch.eval.eval_interactive import evaluate_interactive
from visionllm_tpu_torch.eval.eval_semseg import evaluate_semseg
from visionllm_tpu_torch.eval.eval_pose import OksMAPEvaluator, evaluate_pose
from visionllm_tpu_torch.eval.latency import measure_latency
from visionllm_tpu_torch.eval.postprocess import post_process_det, to_host
from visionllm_tpu_torch.eval.runners import (load_mmbench, load_pope,
                                              run_benchmark)
from visionllm_tpu_torch.generation import (
    _tool_kind, advance_tool_state, build_generate_fn,
    build_speculative_generate_fn, extract_tool_queries_from_generation,
    nucleus_filter)
from visionllm_tpu_torch.infer import (COCO_KEYPOINT_NAMES, Predictor,
                                       det_prompt, grd_prompt, pose_prompt,
                                       prompt_ids)
from visionllm_tpu_torch.kernels import build, host_build
from visionllm_tpu_torch.models.composite import (_meta_model, build_core,
                                                  build_model, model_size)
from visionllm_tpu_torch.models.llama import KVCache
from visionllm_tpu_torch.models.lora import merge_lora_params
from visionllm_tpu_torch.models.stable_diffusion import unet as SDU
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.ops import attention as A
from visionllm_tpu_torch.ops.box_ops import box_cxcywh_to_xyxy
from visionllm_tpu_torch.ops import gather as G
from visionllm_tpu_torch.ops import ms_deform_attn as M
from visionllm_tpu_torch.ops import quant as Q8
from visionllm_tpu_torch.ops import quant4 as Q
from visionllm_tpu_torch.ops.dcnv3 import dcnv3_msda_args
from visionllm_tpu_torch.ops import rle as R
from visionllm_tpu_torch.ops.rle import rle_encode
from visionllm_tpu_torch.serve import (ChatService, _Request, make_server,
                                       perception_json)
from visionllm_tpu_torch.slots import build_slot_fns
from visionllm_tpu_torch.tools import msda_kernel_attempts as probes
from visionllm_tpu_torch.train.cdn import cdn_groups
from visionllm_tpu_torch.train.runner import (TrainConfig, Trainer,
                                              frozen_predicate, to_device)
from visionllm_tpu_torch.train.train_step import (TrainState, build_optimizer,
                                                  chat_loss, det_loss,
                                                  draw_gen_noise,
                                                  draw_pose_noise,
                                                  draw_step_noise, gen_loss,
                                                  make_det_train_step,
                                                  pose_loss, split_frozen)
from visionllm_tpu_torch.utils import profiling
from visionllm_tpu_torch.utils.checkpoint import restore_checkpoint
from visionllm_tpu_torch.utils.convert_gdino import convert_gdino
from visionllm_tpu_torch.utils.convert_unipose import convert_unipose
from visionllm_tpu_torch.utils.torch_convert import (
    ReadRecorder, convert_composite, convert_intern_vit,
    convert_intern_vit_layer, convert_internlm2, convert_internlm2_layer,
    convert_llm2sd_mapper, convert_region_encoder, convert_vl_bridge,
    load_state_dict_files)
from visionllm_tpu_torch.utils.simple_tokenizer import (HashedWordTokenizer,
                                                        RoundTripTokenizer,
                                                        SimpleTokenizer)

# the reference-layout writer lives with the tests (the package has no
# exporter); it is loaded by its path, since a machine may have another
# package named `tests` installed
_RL_SPEC = importlib.util.spec_from_file_location(
    "torch_ref_layout", os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests", "torch_ref_layout.py"))
RL = importlib.util.module_from_spec(_RL_SPEC)
_RL_SPEC.loader.exec_module(RL)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_TENSOR_FLOPS = 989e12    # H100 SXM dense bf16 tensor cores
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
INT8_TENSOR_OPS = 1979e12     # H100 SXM dense int8 tensor cores
QUANT_COPIES = 3              # weight sets rotated in the int8 products
DET_SIZE = 512
N_REQUESTS = 3
N_TIMED = 2
# kernel vs plain on the card, bf16 outputs: max |kernel - plain| must
# stay within ATOL + RTOL * max |plain| (a few bf16 ulps of the outputs,
# which both round from fp32 sums taken in another order)
ATOL, RTOL = 2e-2, 1e-2
# text queries after 32 bf16 LLaMA layers, kernel run vs plain run:
# relative Frobenius error
TQ_REL_TOL = 5e-2
# chat serving: the batch shape ChatService compiles to, and the logits
# of the kernel run vs the plain run teacher-forced on its tokens
# (relative Frobenius error per step, live rows)
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 640, 32
# the 4 threaded requests resize their images on the host before they
# queue; the window lets the slowest still join the first one's call
# (200 ms missed it once on a slow host)
BATCH_WINDOW_MS = 500.0
LOGIT_REL_TOL = 5e-2
L2_BYTES = 50 * 2 ** 20       # H100 L2: decode weights are timed cold
# the det train step (bench_train.py's batch): det image, targets per
# image, AdamW steps on the main path; kernel run vs plain run of one
# step: each loss term and the concatenated trainable gradient, relative
TRAIN_DET = 640
TRAIN_TARGETS = 20
TRAIN_STEPS = 5
TRAIN_REL_TOL = 5e-2
# kernels one `flash_attention_bwd` call launches: Di = rowsum(dO * O),
# then one grid of the dQ and dK/dV blocks
FLASH_BWD_KERNELS = 2
# the trainer phase: Trainer.train on the committed JPEG fixtures
JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "data", "jpeg")
TRAINER_STEPS = 6
TRAINER_SAVE_EVERY = 3
TRAINER_WORKERS = 4
TRAINER_BATCH = 2
TRAINER_COPIES = 3            # each fixture listed 3 times: 21 images, 10 batches
TRAINER_RESUME_STEPS = 9      # the synchronous resumed run goes on to step 9
TRAINER_REPEATS = 2           # more resumed runs, to step TRAINER_STEPS
# the resumed runs' distances from the straight run against their own
# spread: metrics are scalars (a heavy-tailed ratio), the state millions
# of values (distances between runs nearly equal)
RESUME_SPREAD_K_LOSS = 10.0
RESUME_SPREAD_K_STATE = 3.0
# steps after which each run's masters and moments are kept
SNAP_STEPS = (TRAINER_SAVE_EVERY + 1, TRAINER_STEPS)
# the tooltrain phase: the whole 7B flagship over the five tool groups
TOOL_STEPS = 10
TOOL_SAVE_EVERY = 5
TOOL_REPEATS = 3              # resumed runs from the step-5 checkpoint
TOOL_BATCH = 2
TOOL_WORKERS = 4
TOOL_SEED = 26                # its sampler: one batch of each group in steps
                              # 1-5 and again in steps 6-10
TOOL_GROUPS = ("gdino", "unipose", "sd", "ip2p", "vlm")
TOOL_GEN_SIZE = 512
TOOL_BIASES = ("gdino.backbone.patch_embed.bias",
               "unipose.backbone.patch_embed.bias")
TOOL_EVAL_TOPK = 20
TOOL_GAP_S = 0.02             # a profiled step's synced range to other work
# llava conversations over the JPEG fixtures: answers of words drawn from
# CHAT_WORDS (numpy seed CHAT_SEED)
CHAT_WORDS = ("the", "a", "picture", "shows", "red", "blue", "green",
              "grey", "square", "round", "near", "left", "right", "above",
              "below", "object", "bright", "dark", "small", "large", "and",
              "with", "one", "two", "edge", "corner", "middle", "shape")
CHAT_SEED = 5
# the loratrain phase: LoRA r 32, alpha 64 on LLaMA-7B (the reference's
# wrap_llm_lora), the vision encoder and the LLM frozen; llava
# conversations of 4 turns (a 576-token image and about 1000 words: 1025
# to 2048 tokens, so every batch pads to L 2048), each fixture listed 3
# times (21 rows, 10 batches of 2); 8 micro-steps at k = 2 under remat
# "full", one save at micro-step 3 (mid-accumulation); lr 2e-4 (LLaVA's
# LoRA recipe)
LORA_R, LORA_ALPHA = 32, 64.0
LORA_BATCH, LORA_WORKERS, LORA_SEQ = 2, 4, 2048
LORA_TURNS, LORA_ANSWER_WORDS, LORA_COPIES = 4, 240, 3
LORA_MICRO_STEPS, LORA_ACCUM, LORA_SAVE_AT = 8, 2, 3
LORA_LR = 2e-4
LORA_SEED = 0
# remat against no remat: the LoRA gradients, relative L2 a tensor; the
# resumed run against the straight one: masters, moments, metrics
LORA_GRAD_REL_TOL = 1e-3
LORA_RESUME_REL_TOL = 1e-5
SKETCH_BUCKETS = 1 << 22      # buckets of a state's sketch (4 Mi doubles)
KEYPOINT_SEED = 23
TRAINER_BIAS = "gdino.backbone.patch_embed.bias"
TRAINER_BIAS_SEED = 19
# the perception phase: uint8 images that the det test transform resizes
# to (800, 1333) keep-ratio and pads to the 800x1088, 1088x800 and 800x800
# buckets; each answers detect (3 classes, masks), ground (one
# expression, mask) and pose (the 17 COCO keypoints), every top-k result
# kept (threshold 0). Raw tool outputs of the kernel run vs the plain run
# on the kernel run's top-k choices: relative Frobenius error
PERCEPTION_IMAGES = ((480, 640, 3), (640, 480, 3), (500, 500, 3))
PERCEPTION_REQUESTS = {
    "detect": ("/v1/detect", dict(classes=["person", "dog", "bicycle"],
                                  threshold=0.0, topk=20, with_mask=True)),
    "ground": ("/v1/ground", dict(expression="the person on the left",
                                  with_mask=True)),
    "pose": ("/v1/pose", dict(threshold=0.0, topk=20)),
}
PERCEPTION_REL_TOL = 5e-2
# the det26b phase: an 800x1088 uint8 image as a 3x2 + thumbnail tile
# stack (7 x 256 image tokens) and as one tile; warm repeats of each
# request, greedy tokens at B1 (the KV cache's length), and the kernel run
# vs the plain run's text queries and tool outputs, relative
DET26B_IMAGE = (800, 1088, 3)
DET26B_TILES = {"tiles7": 7, "tile1": 1}
DET26B_CLASSES = ["person", "dog", "bicycle"]
DET26B_REPEATS = 2            # few: the script's 1200 s limit
DET26B_DECODE = 8
DET26B_MAX_LEN = 1920
DET26B_REL_TOL = 5e-2
# the fp32 witness: the kernel run may sit at most this many times as far
# from the fp32 run as the bf16 plain run does (or as bf16's unit
# roundoff, 2^-8, where that is larger)
DET26B_WITNESS_RATIO = 2.0
# the whole 26B model on one card: the peak of each section must stay
# under this many bytes; the Predictor section's request that also goes
# over HTTP; the gen section's images from one seed
DET26B_PEAK_LIMIT = 80e9
DET26B_HTTP_TASK = "pose"
DET26B_GEN_RUNS = 2
DET26B_CHAT_NEW = 8           # tokens a chat reply (the serve phase's 32 / 4)
DET26B_GEN_STEPS = 4          # DDIM steps an image (the gen phase's 10)
# the gen phase: the first question templates of the JAX gen datasets
# (`visionllm_tpu/data/gen_dataset.py:23-40`) with a caption and an
# instruction, vicuna_v1; DDIM steps and guidance at the JAX `generate`
# defaults; every image from generator seed GEN_SEED (the main path makes
# each GEN_WALL_RUNS times, and they must be identical); the image
# [EDIT] edits; kernel run vs plain run of the rows and of the logits
# after the last forced row, relative
GEN_QUESTION = ("Can you generate an image of a red bicycle leaning on a "
                "stone wall?")
EDIT_QUESTION = "Please edit the image: make it snow."
GEN_IMAGE = (512, 512, 3)
GEN_STEPS, GEN_GUIDANCE, GEN_IMAGE_GUIDANCE = 10, 7.5, 1.5
GEN_SEED = 0
GEN_WALL_RUNS = 2
GEN_TIMED = 3
GEN_MAX_LEN = 768
GEN_REL_TOL = 5e-2
# DCNv3 in InternImage-H at that image's 800x1088 bucket: each stage's
# (map H, W, groups); one level of the zero-padded map, 9 points, 32
# channels a group
DCNV3_STAGES = ((200, 272, 10), (100, 136, 20), (50, 68, 40), (25, 34, 80))


# the script's start on the host clock: each phase line carries its
# seconds since (`t_s`)
START = time.perf_counter()


def emit(obj):
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, n=20, warmup=3):
    """Mean device ms of fn over n back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fns, n=20, warmup=3, gap_s=0.05):
    """Device time per call of each fn of `fns` (label -> fn), from one
    torch.profiler context (the profiler has lost a context's device
    events once a process had opened a dozen): each fn's n back-to-back
    calls, ended by a synchronize, run inside a `record_function` range
    of its label, `gap_s` apart; each CUDA kernel counts for the range
    nearest to its start if it starts within gap_s / 2 of it. The
    device's clock may sit off the host's, by over 1.25 ms in one context
    (64 kernels of a 5 ms gap's ranges fell outside them): with ranges 50
    ms apart any offset under 25 ms still finds each kernel its range. A
    range of one warm-up kernel comes first: the profiler once dropped
    the first kernel of a context.
    Returns per label the summed device ms over n, the kernels counted per
    call and each kernel name's device ms per call, and the number of
    kernels that fell in no range. Unlike `cuda_ms` it leaves out the
    host's time between launches."""
    warm = "device_ms:warm-up"
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(warm):
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
        for label, fn in fns.items():
            time.sleep(gap_s)
            with record_function(label):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
    events = prof.events()
    labels = [warm, *fns]
    windows = {e.name: e.time_range for e in events
               if e.name in labels and e.device_type == DeviceType.CPU}
    us, count, stray = dict.fromkeys(labels, 0.0), dict.fromkeys(labels, 0), 0
    names = {label: {} for label in labels}     # kernel name -> device us
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in labels:
            continue                        # the ranges' own annotations
        t = e.time_range.start
        dist, label = min((max(w.start - t, t - w.end, 0), label)
                          for label, w in windows.items())
        if dist > gap_s * 1e6 / 2:
            stray += 1
            continue
        us[label] += e.device_time_total
        count[label] += 1
        names[label][e.name] = names[label].get(e.name, 0.0) + \
            e.device_time_total
    return {label: {"ms": us[label] / 1e3 / n,
                    "kernels_per_call": count[label] / n,
                    "ms_by_kernel": {k: t / 1e3 / n for k, t in
                                     sorted(names[label].items())}}
            for label in fns}, stray


def device_ms_update(cases, timed):
    """`device_ms` (and, where `timed` has a ":library" or ":composite"
    label for the case, `library_device_ms` or `composite_device_ms`) of
    every case from one profiler context, with the kernels a call launches
    on each side and their names."""
    dev, stray = device_ms(timed)
    for case in cases:
        kern = dev[case["case"] + ":kernel"]
        case.update(device_ms=kern["ms"],
                    kernels_per_call=kern["kernels_per_call"],
                    kernel_names=[k[:90] for k in kern["ms_by_kernel"]],
                    profiler_stray_kernels=stray)
        if len(kern["ms_by_kernel"]) > 1:
            case["device_ms_by_kernel"] = {
                k[:90]: t for k, t in kern["ms_by_kernel"].items()}
        comp = dev.get(case["case"] + ":composite")
        if comp is not None:
            case.update(composite_device_ms=comp["ms"],
                        composite_kernels_per_call=comp["kernels_per_call"])
        libd = dev.get(case["case"] + ":library")
        if libd is not None:
            case.update(library_device_ms=libd["ms"],
                        library_kernels_per_call=libd["kernels_per_call"],
                        library_kernel_names=[k[:90] for k in
                                              libd["ms_by_kernel"]])


def host_ms(fn, n=N_TIMED):
    """Median wall ms of fn, each call ended by a device sync."""
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ts)


def bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = ATOL + RTOL * scale
    if not (err <= tol):
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at main-path shapes
# ---------------------------------------------------------------------------

def attention_cases(g, more=False):
    """The flash cases at main-path shapes; `more` adds the chat prefill
    inside `ChatService` (B4 L640) and a long causal L2048, where the
    tensor-core rate, not the wave count, sets the pace."""
    dev = "cuda"

    def rnd(*s):
        return torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)

    seg = torch.ones(2, 586, dtype=torch.int32, device=dev)
    seg[1, :200] = 0           # a left-padded prompt beside a full one
    # a slot service's B1 prefill: a 600-token prompt left-padded to 640
    slot_seg = torch.ones(1, SERVE_PROMPT, dtype=torch.int32, device=dev)
    slot_seg[0, :SERVE_PROMPT - 600] = 0
    # (name, B, L, H, H_kv, D, causal, segment_ids)
    specs = [("clip_l", 1, 577, 16, 16, 64, False, None),
             ("llama7b_prefill", 1, 586, 32, 32, 128, True, None),
             ("gqa_h32_kv8", 1, 586, 32, 8, 128, True, None),
             ("segments", 2, 586, 32, 32, 128, True, seg),
             # the loratrain phase's LLaMA layers: B2 at L 2048
             ("lora_train_b2_l2048", LORA_BATCH, LORA_SEQ, 32, 32, 128, True,
              None)]
    if more:
        specs += [("chat_prefill_b4", SERVE_BATCH, SERVE_PROMPT, 32, 32, 128,
                   True, None),
                  ("long_l2048", 1, 2048, 32, 32, 128, True, None),
                  ("slot_prefill_b1_l640_leftpad", 1, SERVE_PROMPT, 32, 32,
                   128, True, slot_seg)]
        specs += [(f"{task}_prefill", 1, L, 32, 32, 128, True, None)
                  for task, L in perception_prompt_lengths().items()]
        # the 26B det path: InternViT-6B over the 7-tile stack (1025
        # tokens, bidirectional) and InternLM2-20B's 7-tile prefill at 48
        # heads over 8 KV heads
        specs += [("internvit_b7_l1025", 7, 1025, 25, 25, 128, False, None),
                  ("internlm2_gqa_6to1_prefill", 1,
                   det26b_prompt_lengths()["tiles7"], 48, 8, 128, True,
                   None)]
        # the whole 26B model: InternViT on one 448 px tile (a Predictor,
        # gen or chat request) and InternLM2-20B's chat prefill inside
        # `ChatService(max_batch=4, max_prompt=640)`
        specs += [("internvit_b1_l1025", 1, 1025, 25, 25, 128, False, None),
                  ("internlm2_chat_b4_l640_gqa", SERVE_BATCH, SERVE_PROMPT,
                   48, 8, 128, True, None)]
        # the [EDIT] request's LLaMA prefill (its CLIP is clip_l)
        specs += [("gen_edit_prefill", 1, gen_prompt_lengths()["edit"], 32,
                   32, 128, True, None)]
        # the eval phase's B8 prefill of the 80-class det prompt (its CLIP
        # runs clip_l's shape at B8)
        specs += [("eval_prefill_b8", EVAL_BATCH, eval_prompt_length(), 32,
                   32, 128, True, None),
                  ("eval_clip_b8", EVAL_BATCH, 577, 16, 16, 64, False, None)]
    for name, B, L, H, Hkv, D, causal, sg in specs:
        yield name, rnd(B, L, H, D), rnd(B, L, Hkv, D), rnd(B, L, Hkv, D), \
            causal, sg


def attention_pairs(B, L, causal, seg):
    """Attending (query, key) pairs per batch row that this input needs."""
    if seg is None:
        per = L * (L + 1) // 2 if causal else L * L
        return [per] * B
    allowed = seg[:, :, None] == seg[:, None, :]
    if causal:
        allowed = allowed & torch.ones(L, L, dtype=torch.bool,
                                       device=seg.device).tril()
    return allowed.sum(dim=(1, 2)).tolist()


def sdpa(qh, kh, vh, causal, mask):
    """`scaled_dot_product_attention` on [B, H, L, D] inputs: the library
    yardstick of the flash forward (never called by the port)."""
    if mask is None:
        return F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal,
            enable_gqa=kh.shape[1] != qh.shape[1])
    return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)


def check_attention(g):
    cases, timed = [], {}
    for name, q, k, v, causal, seg in attention_cases(g, more=True):
        B, L, H, D = q.shape
        Hkv = k.shape[2]
        got = A.flash_attention(q, k, v, causal=causal, segment_ids=seg)
        want = A.flash_attention_plain(q, k, v, causal=causal,
                                       segment_ids=seg)
        torch.cuda.synchronize()
        err = check_close(f"flash_attention[{name}]", got, want)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if seg is not None:
            mask = (seg[:, None, :, None] == seg[:, None, None, :]) & \
                torch.ones(L, L, dtype=torch.bool, device=q.device).tril()

        lib = functools.partial(sdpa, qh, kh, vh, causal, mask)
        lib_out = lib().transpose(1, 2)
        torch.cuda.synchronize()
        check_close(f"sdpa[{name}]", lib_out, want)
        pairs = sum(attention_pairs(B, L, causal, seg)) * H
        flops = 4 * pairs * D
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel()) + \
            (0 if seg is None else seg.numel() * 4)
        b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
        kernel = functools.partial(A.flash_attention, q, k, v, causal=causal,
                                   segment_ids=seg)
        case = {
            "case": name, "shape": [B, L, H, Hkv, D], "causal": causal,
            "segment_ids": seg is not None, "max_abs_err": err,
            "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(lambda: A.flash_attention_plain(
                q, k, v, causal=causal, segment_ids=seg)),
            "library_ms": cuda_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
            "flops": flops, "bytes": nbytes}
        timed[name + ":kernel"], timed[name + ":library"] = kernel, lib
        cases.append(case)
    device_ms_update(cases, timed)
    for case in cases:
        # every wrapper call launches one kernel: each must be counted
        if case["kernels_per_call"] != 1:
            raise AssertionError(f"device_ms[{case['case']}]: "
                                 f"{case['kernels_per_call']} kernels a call")
        emit({"phase": "kernel", "kernel": "flash_attn_fwd", **case})
    return cases


def msda_inputs(g, Q=None, det=DET_SIZE):
    """Inputs at the det shapes of a `det` px image; Q=None gives the
    encoder's Q = S."""
    shapes = tuple((det // s, det // s) for s in (8, 16, 32, 64))
    S = sum(h * w for h, w in shapes)
    Q = S if Q is None else Q
    value = torch.randn(1, S, 8, 32, generator=g, device="cuda").to(
        torch.bfloat16)
    # locations partly outside [0, 1] to exercise the zero padding
    loc = torch.rand(1, Q, 8, 4, 4, 2, generator=g, device="cuda") * 1.4 - 0.2
    attw = torch.softmax(torch.randn(1, Q, 8, 16, generator=g, device="cuda"),
                         -1).reshape(1, Q, 8, 4, 4)
    return value, shapes, loc, attw


def msda_box_inputs(g, Q, det=TRAIN_DET, B=TOOL_BATCH):
    """Decoder inputs at the det shapes of a `det` px image with box
    references, as UniPose's decoder samples: each query's 16 points at
    ref_xy + offset / P * ref_wh / 2, offsets N(0, 2), boxes of 2-30 %
    of the image anywhere in it."""
    shapes = tuple((det // s, det // s) for s in (8, 16, 32, 64))
    S = sum(h * w for h, w in shapes)
    value = torch.randn(B, S, 8, 32, generator=g, device="cuda").to(
        torch.bfloat16)
    xy = torch.rand(B, Q, 1, 1, 1, 2, generator=g, device="cuda")
    wh = 0.02 + 0.28 * torch.rand(B, Q, 1, 1, 1, 2, generator=g,
                                  device="cuda")
    off = 2.0 * torch.randn(B, Q, 8, 4, 4, 2, generator=g, device="cuda")
    loc = xy + off / 4 * wh * 0.5
    attw = torch.softmax(torch.randn(B, Q, 8, 16, generator=g,
                                     device="cuda"), -1).reshape(B, Q, 8, 4,
                                                                 4)
    return value, shapes, loc, attw


def pose_train_queries():
    """UniPose's training decoder query counts at the tooltrain phase's
    targets: the box layers' num_queries + dn and the pose layers'
    groups x (1 + body points) + dn, dn = cdn_groups(dn_number,
    TRAIN_TARGETS) x 2 x TRAIN_TARGETS."""
    ucfg = vllm_7b_config().unipose
    n_dn = cdn_groups(ucfg.dn_number, TRAIN_TARGETS) * 2 * TRAIN_TARGETS
    return (ucfg.num_queries + n_dn,
            ucfg.num_groups * (ucfg.num_body_points + 1) + n_dn)


def msda_uniform_cases(g, bwd):
    """(name, value, shapes, loc, attw[, grad_out]) at the main-path
    shapes, locations spread uniformly over (and past) every map: the
    512 px det request's encoder and decoder (forward only) and the 640 px
    train step's; then UniPose's training decoder at the tooltrain
    phase's B2 640 px batch, with box references (`msda_box_inputs`): the
    box layers and the pose layers."""
    specs = [("train_encoder", None, TRAIN_DET),
             ("train_decoder", 1100, TRAIN_DET)]
    if not bwd:
        specs = [("encoder", None, DET_SIZE),
                 ("decoder", 900, DET_SIZE)] + specs
    q_box, q_pose = pose_train_queries()
    specs += [("pose_train_box_decoder", q_box, "box"),
              ("pose_train_pose_decoder", q_pose, "box")]
    for name, Q, det in specs:
        value, shapes, loc, attw = (msda_box_inputs(g, Q) if det == "box"
                                    else msda_inputs(g, Q, det))
        if bwd:
            gout = torch.randn(loc.shape[0], loc.shape[1], 256, generator=g,
                               device="cuda").to(torch.bfloat16)
            yield name, value, shapes, loc, attw, gout
        else:
            yield name, value, shapes, loc, attw


def dcnv3_cases(g):
    """(name, value, shapes, loc, attw) of DCNv3's sampling in each
    InternImage-H stage at the det26b image, built by `dcnv3_msda_args`
    as `dcnv3_core` builds them: the 3x3 taps around each pixel plus
    offsets of a few pixels, the mask softmaxed over the 9 points and
    rounded to bf16."""
    for s, (H, W, G) in enumerate(DCNV3_STAGES):
        x = torch.randn(1, H, W, 32 * G, generator=g, device="cuda").to(
            torch.bfloat16)
        off = 2.0 * torch.randn(1, H, W, G * 18, generator=g, device="cuda")
        mask = torch.softmax(torch.randn(1, H, W, G, 9, generator=g,
                                         device="cuda"), -1)
        args, _ = dcnv3_msda_args(x, off, mask.reshape(1, H, W, G * 9).to(
            torch.bfloat16), group=G)
        yield (f"dcnv3_stage{s}", *args)


def encoder_or_decoder(value, loc):
    return "encoder" if loc.shape[1] == value.shape[1] else "decoder"


class MSDARecorder:
    """Wraps an MSDA wrapper (forward or backward) and keeps a copy of the
    arguments of its first call of each kind that `kinds(value, loc)`
    names (by default its first encoder call, Q == S, and its first
    decoder call; None skips a call), then calls it. Its `launches` is
    the wrapped wrapper's, which the kernel path counts through the name
    this object replaces."""

    def __init__(self, fn, prefix, kinds=encoder_or_decoder):
        self.fn, self.prefix, self.kinds, self.calls = fn, prefix, kinds, {}

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, value, shapes, loc, attw, *rest):
        kind = self.kinds(value, loc)
        if kind is not None and self.prefix + kind not in self.calls:
            self.calls[self.prefix + kind] = tuple(
                t.detach().clone() if torch.is_tensor(t) else t
                for t in (value, shapes, loc, attw, *rest))
        return self.fn(value, shapes, loc, attw, *rest)


def captured_msda_fwd():
    """The MSDA inputs of the model's own sampling, recorded around
    `M.ms_deform_attn`: the first encoder and decoder call of a warm det
    request (the slice phase's requests, 512 px), the encoder call of a
    detect request at the 800 px test scale and the first post-expansion
    decoder call of a pose request (Q = groups x (1 + body points), box
    references), both through the Predictor on the perception phase's
    first image. One model serves all three: the perception config with
    seed 0, whose core and Grounding-DINO draw the det config's weights
    (`init_weights` draws the tools in order, UniPose last)."""
    cfg = vllm_7b_perception_config()
    tid = SpecialTokenIds.synthetic()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    ids, images, aug = make_requests(
        cfg, tid, torch.Generator(device="cuda").manual_seed(1))[0]
    pred = Predictor(cfg, model, SimpleTokenizer(), device="cuda")
    img = perception_images()[0]
    path, body = PERCEPTION_REQUESTS["detect"]
    n_pose = cfg.unipose.num_groups * (cfg.unipose.num_body_points + 1)
    recs = [MSDARecorder(M.ms_deform_attn, "captured_det_"),
            MSDARecorder(M.ms_deform_attn, "captured_perception_",
                         lambda v, loc: "encoder" if loc.shape[1] == v.shape[1]
                         else None),
            MSDARecorder(M.ms_deform_attn, "captured_pose_",
                         lambda v, loc: "decoder" if loc.shape[1] == n_pose
                         else None)]
    runs = [lambda: model.infer_det(ids, images, aug, tid),
            lambda: perception_call(pred, "detect", img),
            lambda: perception_call(pred, "pose", img)]
    with torch.no_grad():
        for rec, run in zip(recs, runs):
            run()                                         # warm
            with mock.patch.object(M, "ms_deform_attn", rec):
                run()
    del model, pred
    gc.collect()
    torch.cuda.empty_cache()
    return [(name, *args) for rec in recs
            for name, args in sorted(rec.calls.items())]


def captured_msda_bwd():
    """The MSDA backward's inputs in the model's own train step (the train
    phase's model, batch and first step): the first encoder and decoder
    call of the backward, with the grad_out that reaches it, recorded
    around `M.ms_deform_attn_bwd`."""
    cfg, tid, model, state, step = build_train()
    g = torch.Generator(device="cuda").manual_seed(2)
    batch = train_batch(cfg, tid, g)
    rec = MSDARecorder(M.ms_deform_attn_bwd, "captured_train_")
    with mock.patch.object(M, "ms_deform_attn_bwd", rec):
        step(state, batch, generator=g)
    del model, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return [(name, *args) for name, args in sorted(rec.calls.items())]


def msda_composite(value, shapes, loc, attw):
    """MSDA composed of PyTorch calls as Deformable DETR's
    `ms_deform_attn_core_pytorch` does it: one `F.grid_sample(bilinear,
    zeros, align_corners=False)` per level on [B H, D, h, w] maps and an
    attention-weighted sum, in fp32 -> [B, Q, H D] fp32. A yardstick
    only: the port never calls it."""
    B, S, H, D = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    grids = 2 * loc - 1
    sampled, pos = [], 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, pos:pos + h * w].float().permute(0, 2, 3, 1).reshape(
            B * H, D, h, w)
        pos += h * w
        grid = grids[:, :, :, lvl].transpose(1, 2).reshape(B * H, Q, P, 2)
        sampled.append(F.grid_sample(v, grid, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))  # [BH, D, Q, P]
    a = attw.transpose(1, 2).reshape(B * H, 1, Q, L * P)
    out = (torch.stack(sampled, -2).flatten(-2) * a).sum(-1)
    return out.reshape(B, H * D, Q).transpose(1, 2)


def msda_valid_corners(shapes, loc):
    """Corner samples inside the map: what this input's gathers need."""
    n = 0
    for lvl, (h, w) in enumerate(shapes):
        x = loc[:, :, :, lvl, :, 0] * w - 0.5
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        for dy in (0, 1):
            for dx in (0, 1):
                ok = ((x0 + dx >= 0) & (x0 + dx <= w - 1)
                      & (y0 + dy >= 0) & (y0 + dy <= h - 1))
                n += int(ok.sum().item())
    return n


def msda_shape(value, loc):
    B, S, H, D = value.shape
    return {"B": B, "S": S, "Q": loc.shape[1], "H": H, "D": D,
            "L": loc.shape[3], "P": loc.shape[4]}


def check_msda_calls(cases, kernel_name, want_kernels):
    """Each MSDA case's call launches only the design's kernels:
    `want_kernels` kernels a call at most (fewer only where the profiler
    dropped an event), all of them the port's or memsets."""
    for case in cases:
        names = case["kernel_names"]
        if not (0 < case["kernels_per_call"] <= want_kernels and all(
                kernel_name in n or "cast_bf16_kernel" in n
                or "Memset" in n for n in names)):
            raise AssertionError(f"device_ms[{case['case']}]: "
                                 f"{case['kernels_per_call']} kernels a call: "
                                 f"{names}")


def check_msda(g):
    """The MSDA forward kernel against the plain version at the main-path
    shapes, on uniform locations and on the inputs captured from a det
    request and from perception requests at 800 px; each output also
    bit-identical across two calls. The grid_sample composition is the
    yardstick (`composite_*`)."""
    cases, timed = [], {}
    inputs = (list(msda_uniform_cases(g, bwd=False)) + list(dcnv3_cases(g))
              + captured_msda_fwd()
              + [("eval_b8_encoder", *eval_msda_inputs(g))])
    for name, value, shapes, loc, attw in inputs:
        got = M.ms_deform_attn(value, shapes, loc, attw)
        again = M.ms_deform_attn(value, shapes, loc, attw)
        want = M.ms_deform_attn_plain(value, shapes, loc, attw)
        comp = functools.partial(msda_composite, value, shapes, loc, attw)
        torch.cuda.synchronize()
        err = check_close(f"ms_deform_attn[{name}]", got, want)
        if not torch.equal(got, again):
            raise AssertionError(f"ms_deform_attn[{name}]: two calls differ")
        comp_err = check_close(f"msda_composite[{name}]", comp(), want)
        D = value.shape[3]
        n_loc = attw.numel()
        flops = 2 * D * msda_valid_corners(shapes, loc) + 20 * n_loc
        nbytes = (2 * value.numel() + 4 * loc.numel() + 4 * attw.numel()
                  + 2 * got.numel())
        b_ms, b_by = bound(nbytes, flops, FP32_FLOPS)
        kernel = functools.partial(M.ms_deform_attn, value, shapes, loc,
                                   attw)
        case = {
            "case": name, "shape": msda_shape(value, loc),
            "max_abs_err": err, "repeat_bit_identical": True,
            "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(lambda: M.ms_deform_attn_plain(
                value, shapes, loc, attw), n=5),
            "library_ms": None, "composite_ms": cuda_ms(comp),
            "composite_max_abs_err": comp_err,
            "composite": "F.grid_sample per level + weighted sum",
            "bound_ms": b_ms, "bound_by": b_by,
            "flops": flops, "bytes": nbytes}
        timed[name + ":kernel"], timed[name + ":composite"] = kernel, comp
        cases.append(case)
    device_ms_update(cases, timed)
    del timed, inputs
    for case in cases:
        emit({"phase": "kernel", "kernel": "ms_deform_attn_fwd", **case})
    check_msda_calls(cases, "msda_fwd", 1)
    return cases


def check_attention_bwd(g):
    """The flash backward kernel against autograd of the plain forward,
    at the forward's cases; the library yardstick is the backward of
    `scaled_dot_product_attention` through `torch.autograd.grad`. Every
    case's device time comes from one profiler context, which also counts
    the kernels a call launches on each side."""
    cases, timed = [], {}
    for name, q, k, v, causal, seg in attention_cases(g):
        B, L, H, D = q.shape
        Hkv = k.shape[2]
        dout = torch.randn(q.shape, generator=g, device="cuda").to(
            torch.bfloat16)
        lse = torch.empty(B, H, L, dtype=torch.float32, device="cuda")
        out = A._launch_fwd(q, k, v, causal, seg, lse)
        got = A.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                    segment_ids=seg)
        want = A.flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                           segment_ids=seg)
        torch.cuda.synchronize()
        errs = {n: check_close(f"flash_attention_bwd[{name}].{n}", a, b)
                for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        mask = None
        if seg is not None:
            mask = (seg[:, None, :, None] == seg[:, None, None, :]) & \
                torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        if mask is None:
            lib_out = F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal, enable_gqa=Hkv != H)
        else:
            lib_out = F.scaled_dot_product_attention(qh, kh, vh,
                                                     attn_mask=mask)
        lib = functools.partial(torch.autograd.grad, lib_out, (qh, kh, vh),
                                dout.transpose(1, 2), retain_graph=True)
        for n, a, b in zip(("dq", "dk", "dv"), lib(), want):
            check_close(f"sdpa_bwd[{name}].{n}", a.transpose(1, 2), b)
        pairs = sum(attention_pairs(B, L, causal, seg)) * H
        flops = 10 * pairs * D     # S again, dP, dV, dQ, dK
        nbytes = 2 * 4 * (q.numel() + k.numel()) + 4 * lse.numel() + \
            (0 if seg is None else seg.numel() * 4)
        b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
        kernel = functools.partial(A.flash_attention_bwd, q, k, v, out, dout,
                                   lse, causal=causal, segment_ids=seg)
        case = {
            "case": name, "shape": [B, L, H, Hkv, D], "causal": causal,
            "segment_ids": seg is not None, "max_abs_err": max(errs.values()),
            "max_abs_err_by_output": errs,
            "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(lambda: A.flash_attention_bwd_plain(
                q, k, v, dout, causal=causal, segment_ids=seg), n=5),
            "library_ms": cuda_ms(lib),
            "library": "scaled_dot_product_attention backward",
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "bytes": nbytes}
        timed[name + ":kernel"], timed[name + ":library"] = kernel, lib
        cases.append(case)
    device_ms_update(cases, timed)
    del timed                     # and with it the SDPA graphs
    for case in cases:
        # every wrapper call launches the design's kernels, and only them
        if case["kernels_per_call"] != FLASH_BWD_KERNELS or not all(
                "flash_bwd" in n for n in case["kernel_names"]):
            raise AssertionError(f"device_ms[{case['case']}]: "
                                 f"{case['kernels_per_call']} kernels a call "
                                 f"({case['kernel_names']}), not "
                                 f"{FLASH_BWD_KERNELS}")
        emit({"phase": "kernel", "kernel": "flash_attn_bwd", **case})
    return cases


def check_msda_bwd(g):
    """The MSDA backward kernel against autograd of the plain forward at
    the 640 px train shapes, on uniform locations and on the inputs (and
    grad_out) captured from a train step; grad_loc and grad_attw
    bit-identical across two calls, grad_value's spread across them
    reported (fp32 atomics). The yardstick is autograd of the grid_sample
    composition (`composite_*`)."""
    cases, timed = [], {}
    inputs = list(msda_uniform_cases(g, bwd=True)) + captured_msda_bwd()
    names = ("grad_value", "grad_loc", "grad_attw")
    for name, value, shapes, loc, attw, gout in inputs:
        got = M.ms_deform_attn_bwd(value, shapes, loc, attw, gout)
        again = M.ms_deform_attn_bwd(value, shapes, loc, attw, gout)
        want = M.ms_deform_attn_bwd_plain(value, shapes, loc, attw, gout)
        torch.cuda.synchronize()
        errs = {n: check_close(f"ms_deform_attn_bwd[{name}].{n}", a, b)
                for n, a, b in zip(names, got, want)}
        for n, a, b in zip(names[1:], got[1:], again[1:]):
            if not torch.equal(a, b):
                raise AssertionError(f"ms_deform_attn_bwd[{name}].{n}: two "
                                     "calls differ")
        spread = (got[0].float() - again[0].float()).abs()
        ins = [value.float().requires_grad_(), loc.clone().requires_grad_(),
               attw.clone().requires_grad_()]
        comp_out = msda_composite(ins[0], shapes, ins[1], ins[2])
        comp = functools.partial(torch.autograd.grad, comp_out, ins,
                                 gout.float(), retain_graph=True)
        # grad_loc jumps where a location crosses a cell edge, and
        # grid_sample's pixel ((2 t - 1 + 1) W - 1) / 2 rounds otherwise
        # than t W - 0.5 there: its grad_loc error is reported, not held
        comp_got = comp()
        comp_errs = {n: (a.float() - b.float()).abs().max().item()
                     for n, a, b in zip(names, comp_got, want)}
        for i in (0, 2):
            check_close(f"msda_composite_bwd[{name}].{names[i]}",
                        comp_got[i], want[i])
        del comp_got
        D = value.shape[3]
        valid = msda_valid_corners(shapes, loc)
        # per valid corner and channel: the value-gradient product and
        # its add, and the FMAs of the weight and two location sums
        flops = 8 * D * valid + 30 * attw.numel()
        nbytes = (2 * 2 * value.numel() + 2 * 4 * loc.numel()
                  + 2 * 4 * attw.numel() + 2 * gout.numel())
        b_ms, b_by = bound(nbytes, flops, FP32_FLOPS)
        kernel = functools.partial(M.ms_deform_attn_bwd, value, shapes, loc,
                                   attw, gout)
        case = {
            "case": name, "shape": msda_shape(value, loc),
            "max_abs_err": max(errs.values()),
            "max_abs_err_by_output": errs,
            "grad_value_repeat_max_abs_diff": spread.max().item(),
            "grad_value_repeat_elements_differing":
                int((spread > 0).sum().item()),
            "valid_corners": valid, "vector_reductions": valid * D // 4,
            "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(lambda: M.ms_deform_attn_bwd_plain(
                value, shapes, loc, attw, gout), n=3, warmup=1),
            "library_ms": None, "composite_ms": cuda_ms(comp),
            "composite_max_abs_err_by_output": comp_errs,
            "composite": "autograd of F.grid_sample per level + weighted sum",
            "bound_ms": b_ms, "bound_by": b_by,
            "flops": flops, "bytes": nbytes}
        timed[name + ":kernel"], timed[name + ":composite"] = kernel, comp
        cases.append(case)
    device_ms_update(cases, timed)
    del timed, inputs
    for case in cases:
        emit({"phase": "kernel", "kernel": "ms_deform_attn_bwd", **case})
    # the memset of the fp32 scratch, the kernel, the cast to bf16
    check_msda_calls(cases, "msda_bwd", 3)
    return cases


# lane-gather cases beside the probe's (reversed indices): seeded random
# indices in [-2, E + 2) at the probe's largest extent, at an odd one, and
# just past one CTA a row (a two-CTA cluster with a ragged second slice)
LANE_RANDOM = (57344, 57343, 1028)


def lane_random_inputs(E, R=8):
    rng = np.random.default_rng(E)
    v = torch.from_numpy(rng.standard_normal((R, E)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-2, E + 2, (R, E)).astype(np.int32))
    return v.cuda(), idx.cuda()


def check_gathers():
    """The two gather probes' kernels against their plain versions at the
    probe's shapes (exact), with `torch.gather` / `torch.index_select` as
    the library yardsticks; device times of both probes from one profiler
    context. Each lane case records the cluster it launched."""
    lane, row, timed = [], [], {}
    inputs = [(f"extent_{E}", probes.lane_inputs(E, "cuda"))
              for E in probes.LANE_EXTENTS]
    inputs += [(f"random_{E}", lane_random_inputs(E)) for E in LANE_RANDOM]
    for name, (v, idx) in inputs:
        E = v.shape[1]
        idx64 = idx.clamp(0, E - 1).long()
        got = G.lane_gather(v, idx)
        want = G.lane_gather_plain(v, idx)
        torch.cuda.synchronize()
        err = check_close(f"lane_gather[{name}]", got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"lane_gather[{name}] differs from plain")
        nbytes = 3 * 4 * v.numel()
        b_ms, b_by = bound(nbytes, 0, FP32_FLOPS)
        kernel = functools.partial(G.lane_gather, v, idx)
        lib = functools.partial(torch.gather, v, 1, idx64)
        plan = G.lane_gather_plan(E)
        case = {"case": name, "shape": list(v.shape),
                "cluster": plan["cluster"], "chunk": plan["chunk"],
                "active_clusters": plan["active"],
                "max_abs_err": err,
                "ms": cuda_ms(kernel),
                "plain_ms": cuda_ms(lambda: G.lane_gather_plain(v, idx)),
                "library_ms": cuda_ms(lib),
                "library": "torch.gather", "bound_ms": b_ms,
                "bound_us": b_ms * 1e3, "bound_by": b_by, "bytes": nbytes}
        timed[case["case"] + ":kernel"] = kernel
        timed[case["case"] + ":library"] = lib
        lane.append(case)
    for n in (8192, probes.N):
        table, idx = probes.row_inputs(n, "cuda")
        for rpb in (8, 64):
            got = G.row_gather(table, idx, rpb)
            want = G.row_gather_plain(table, idx)
            torch.cuda.synchronize()
            err = check_close(f"row_gather[{n}, {rpb}]", got, want)
            if not torch.equal(got, want):
                raise AssertionError(f"row_gather[{n}, {rpb}] differs")
            # the table, the indices and the rows out, each once (the
            # 4 MB table sits in L2 for the repeated row reads)
            nbytes = 2 * table.numel() + 4 * n + 2 * got.numel()
            b_ms, b_by = bound(nbytes, 0, BF16_TENSOR_FLOPS)
            kernel = functools.partial(G.row_gather, table, idx, rpb)
            lib = functools.partial(torch.index_select, table, 0, idx)
            ms = cuda_ms(kernel)
            lib_ms = cuda_ms(lib)
            case = {"case": f"n{n}_rpb{rpb}", "shape": [n, *table.shape],
                    "max_abs_err": err, "ms": ms,
                    "plain_ms": cuda_ms(lambda: G.row_gather_plain(table,
                                                                   idx)),
                    "library_ms": lib_ms, "library": "torch.index_select",
                    "rows_per_s": n / (ms * 1e-3),
                    "library_rows_per_s": n / (lib_ms * 1e-3),
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
            timed[case["case"] + ":kernel"] = kernel
            timed[case["case"] + ":library"] = lib
            row.append(case)
    device_ms_update(lane + row, timed)
    for case in lane:
        emit({"phase": "kernel", "kernel": "lane_gather", **case})
    for case in row:
        emit({"phase": "kernel", "kernel": "row_gather", **case})
    return lane, row


def rotating_ms(fn, sets, n=20):
    """Mean device ms of fn over rotating argument sets: with more bytes
    in the sets than the L2 holds, each call reads its weights cold, as
    the decode loop does."""
    return cuda_ms(rotating(fn, sets), n=n)


def rotating(fn, sets):
    """fn over the argument sets in turn, one set a call."""
    it = itertools.count()
    return lambda: fn(*sets[next(it) % len(sets)])


def int4_dequant(wp, scale):
    """bf16 [K, N] weights of a packed tree (the library yardstick's
    input; computed outside any timed region)."""
    G = 2 * wp.shape[0] // scale.shape[0]
    wi = wp.to(torch.int32)
    w = torch.cat([((wi & 0xF) ^ 8) - 8, wi >> 4], 0).float()
    return (w * scale.float().repeat_interleave(G, 0)).to(torch.bfloat16)


def check_int4(g):
    cases, timed = [], {}
    # M 1 and 4: dispatch-loop decode; M 8: a tick of the slots phase's
    # 8 slots; M 256: one of its chunk windows; M 2560: the chat prefill
    specs = [(f"decode_m{m}_{k}x{n}", m, k, n)
             for m in (1, 4, 8) for k, n in ((4096, 4096), (4096, 11008),
                                              (11008, 4096), (4096, 32096))]
    specs.append(("chunk_m256_4096x11008", 256, 4096, 11008))
    specs.append(("prefill_m2560_4096x11008", 2560, 4096, 11008))
    # InternLM2-20B's widths (the 26B int4 chat): q and o, k and v, gate
    # and up, down, lm_head at a B4 decode step; gate and up at the B4
    # L640 prefill
    specs += [(f"internlm2_m4_{k}x{n}", 4, k, n)
              for k, n in ((6144, 6144), (6144, 1024), (6144, 16384),
                           (16384, 6144), (6144, 92576))]
    specs.append(("internlm2_prefill_m2560_6144x16384", 2560, 6144, 16384))
    for name, M_, K, N in specs:
        wbytes = K * N // 2 + 2 * (K // 128) * N
        copies = max(1, math.ceil(2 * L2_BYTES / wbytes)) \
            if M_ <= 8 else 1
        packed = [Q.pack_int4(torch.randn(K, N, generator=g, device="cuda")
                              * K ** -0.5) for _ in range(copies)]
        x = torch.randn(M_, K, generator=g, device="cuda").to(torch.bfloat16)
        wp, scale = packed[0]
        got = Q.int4_matmul(x, wp, scale)
        want = Q.int4_matmul_plain(x, wp, scale)
        torch.cuda.synchronize()
        err = check_close(f"int4_matmul[{name}]", got, want)
        lib_copies = max(1, math.ceil(copies * wbytes / (2 * K * N)))
        deq = [int4_dequant(*packed[i % copies]) for i in range(lib_copies)]
        torch.cuda.synchronize()
        check_close(f"matmul[{name}]", torch.matmul(x, deq[0]), want)
        sets = [(x, wp_, s_) for wp_, s_ in packed]
        lib_sets = [(x, d) for d in deq]
        nbytes = 2 * M_ * K + wbytes + 2 * M_ * N
        b_ms, b_by = bound(nbytes, 2 * M_ * K * N, BF16_TENSOR_FLOPS)
        case = {
            "case": name, "shape": [M_, K, N], "max_abs_err": err,
            "ms": rotating_ms(Q.int4_matmul, sets),
            "plain_ms": rotating_ms(Q.int4_matmul_plain, sets, n=5),
            "library_ms": rotating_ms(torch.matmul, lib_sets),
            "library": "torch.matmul(x, dequantized bf16 W)",
            "bound_ms": b_ms, "bound_by": b_by,
            "flops": 2 * M_ * K * N, "bytes": nbytes,
            "weight_copies_rotated": copies}
        timed[name + ":kernel"] = rotating(Q.int4_matmul, sets)
        timed[name + ":library"] = rotating(torch.matmul, lib_sets)
        cases.append(case)
    # device time per call, all cases in one profiler session (the
    # rotated copies stay alive until it ends)
    device_ms_update(cases, timed)
    for case in cases:
        emit({"phase": "kernel", "kernel": "int4_matmul", **case})
    for case in cases:
        # one kernel a call: no split-K partials, no second pass. Every
        # kernel in a case's range is the int4 kernel, at most one a call
        # (fewer only where the profiler dropped an event)
        names = case["kernel_names"]
        if not (0 < case["kernels_per_call"] <= 1 and names
                and all("int4_mma_kernel" in k for k in names)):
            raise AssertionError(f"device_ms[{case['case']}]: "
                                 f"{case['kernels_per_call']} kernels a call: "
                                 f"{names}")
    del timed
    torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# phase 4: the det slice at full width
# ---------------------------------------------------------------------------

def make_requests(cfg, tid, g):
    img_len = cfg.vis_encoder.num_patches
    size = cfg.vis_encoder.image_size
    embs = [tid.emb + i for i in range(cfg.num_embs)]
    reqs = []
    for r in range(N_REQUESTS):
        ids = [1, 10, 11] + [tid.imp] * img_len + [12] + [tid.det] + embs
        if r == N_REQUESTS - 1:          # two [DET][EMB x4] groups
            ids += [13, tid.det] + embs
        ids += [2]
        reqs.append((
            torch.tensor([ids], dtype=torch.long, device="cuda"),
            (0.3 * torch.randn(1, size, size, 3, generator=g,
                               device="cuda")).to(torch.bfloat16),
            (0.3 * torch.randn(1, DET_SIZE, DET_SIZE, 3, generator=g,
                               device="cuda")).to(torch.bfloat16)))
    return reqs


def text_queries(model, ids, images, tid):
    out = model.core(ids, images, tid, compute_logits=False)
    return model.core.extract_text_query(out["hidden"], ids, tid)


def run_slice():
    cfg = vllm_7b_det_config()
    tid = SpecialTokenIds.synthetic()
    t = time.perf_counter()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device="cuda").manual_seed(1)
    reqs = make_requests(cfg, tid, g)
    per_req_flash = cfg.vis_encoder.num_layers + cfg.llm.num_layers
    per_req_msda = cfg.gdino.encoder_layers + cfg.gdino.decoder_layers
    Q, T = cfg.gdino.num_queries, cfg.gdino.max_text_len
    side = DET_SIZE // 4

    # the main path, with the launch counts taken around it alone
    A.flash_attention.launches = 0
    M.ms_deform_attn.launches = 0
    outs, per_request = [], []
    with torch.no_grad():
        for ids, images, aug in reqs:
            f0, m0 = A.flash_attention.launches, M.ms_deform_attn.launches
            outs.append(model.infer_det(ids, images, aug, tid))
            per_request.append((A.flash_attention.launches - f0,
                                M.ms_deform_attn.launches - m0))
    torch.cuda.synchronize()
    launches = {"flash_attn_fwd": A.flash_attention.launches,
                "ms_deform_attn_fwd": M.ms_deform_attn.launches}
    for n_f, n_m in per_request:
        if (n_f, n_m) != (per_req_flash, per_req_msda):
            raise AssertionError(f"launches per request {(n_f, n_m)} != "
                                 f"{(per_req_flash, per_req_msda)}")
    for out in outs:
        for key, shape in (("logits", (1, Q, T)), ("pred_boxes", (1, Q, 4)),
                           ("pred_masks", (1, Q, side, side))):
            x = out[key]
            if tuple(x.shape) != shape or not torch.isfinite(x).all():
                raise AssertionError(f"{key}: shape {tuple(x.shape)} vs "
                                     f"{shape}, finite "
                                     f"{bool(torch.isfinite(x).all())}")
        if not ((out["pred_boxes"] >= 0) & (out["pred_boxes"] <= 1)).all():
            raise AssertionError("pred_boxes outside [0, 1]")

    # the same requests with the plain versions in place of both kernels
    tq_errs, agree, box_errs = [], [], []
    with torch.no_grad():
        for (ids, images, aug), out in zip(reqs, outs):
            tq_k, mask_k = text_queries(model, ids, images, tid)
            with mock.patch.object(A, "flash_attention",
                                   A.flash_attention_plain), \
                    mock.patch.object(M, "ms_deform_attn",
                                      M.ms_deform_attn_plain):
                tq_p, mask_p = text_queries(model, ids, images, tid)
                out_p = model.gdino(aug, tq_p, mask_p)
            if not torch.equal(mask_k, mask_p):
                raise AssertionError("text-query masks differ")
            rel = ((tq_k.float() - tq_p.float()).norm()
                   / tq_p.float().norm()).item()
            if not rel <= TQ_REL_TOL:
                raise AssertionError(f"text queries: rel err {rel} > "
                                     f"{TQ_REL_TOL}")
            tq_errs.append(rel)
            ik, ip = out["topk_idx"][0], out_p["topk_idx"][0]
            agree.append(len(set(ik.tolist()) & set(ip.tolist())) / Q)
            # boxes of the query slots that selected the same proposal
            same = ik == ip
            box_errs.append((out["pred_boxes"][0, same]
                             - out_p["pred_boxes"][0, same])
                            .abs().median().item())

    # warm timings: a request and its stages (host clock, synced)
    ids, images, aug = reqs[0]
    with torch.no_grad():
        req_ms = host_ms(lambda: model.infer_det(ids, images, aug, tid))
        vision_ms = host_ms(lambda: model.core.encode_images(images))
        embeds, _ = model.core.build_prompt_embeds(ids, images, tid)
        pos = torch.arange(ids.shape[1], device="cuda")[None]
        prefill_ms = host_ms(lambda: model.core.llm(
            embeds, pos, compute_logits=False))
        tq, tq_mask = text_queries(model, ids, images, tid)
        gdino_ms = host_ms(lambda: model.gdino(aug, tq, tq_mask))
    emit({"phase": "slice", "requests": N_REQUESTS,
          "prompt_tokens": [int(r[0].shape[1]) for r in reqs],
          "params": n_params, "build_model_s": build_s,
          "launches_per_request": per_request, "launches": launches,
          "text_query_rel_err": tq_errs, "text_query_rel_tol": TQ_REL_TOL,
          "topk_agreement": agree,
          "pred_boxes_same_slot_median_abs_diff": box_errs,
          "request_ms_median": req_ms, "vision_ms": vision_ms,
          "prefill_ms": prefill_ms, "gdino_ms": gdino_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    profile_request(model, reqs[0], tid)
    return launches


def profile_request(model, req, tid):
    """One warm det request under torch.profiler."""
    ids, images, aug = req
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.infer_det(ids, images, aug, tid)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    summary = device_summary(prof, wall_ms)
    emit({"phase": "profile", **summary,
          "public_reading": public_device_busy(prof, summary)})


def public_device_busy(prof, summary):
    """`device_summary`'s busy ms and kernel count read again through the
    profiler's public `prof.events()`, beside the raw kineto reading
    (`prof.profiler.kineto_results`, a private API of the installed
    torch), so that one profile shows whether the two agree."""
    busy, n = 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy += e.device_time_total / 1e3
            n += 1
    return {"device_busy_ms": busy, "device_kernels": n,
            "busy_ms_diff": busy - summary["device_busy_ms"],
            "kernels_diff": n - summary["device_kernels"],
            "torch": torch.__version__}


# the port's own kernels (csrc/*.cu, each in an anonymous namespace), as
# the profiler names them: "(anonymous namespace)::<name>[<args>](...)",
# where the template arguments are integers, bools or int4's tile
# "(anonymous namespace)::Cfg<integers>" (PyTorch's anonymous-namespace
# kernels take types)
PORT_KERNEL = re.compile(
    r"(?:^|\s)\(anonymous namespace\)::(\w+(?:<(?:[\d ,]|true|false|"
    r"\(anonymous namespace\)::\w+<[\d ,]+>)+>)?)\(")


def device_summary(prof, wall_ms):
    """Summed device kernel time (one stream, so their union), the
    device's idle share of the wall, the kernels that take the most, and
    every kernel of the port's own. Read from the profiler's raw kineto
    events (`prof.profiler.kineto_results`, a private API, written
    against torch 2.11: `public_device_busy` holds it against the public
    `prof.events()` in the det profile), since building the Python
    events took about two minutes for the 218k kernels of one gen image."""
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            kernel_total(by_name, e)
    return kernel_summary(by_name, wall_ms)


def kernel_total(by_name, e):
    tot, n = by_name.get(e.name(), (0.0, 0))
    by_name[e.name()] = (tot + e.duration_ns() / 1e6, n + 1)


def kernel_summary(by_name, wall_ms):
    """`device_summary` of kernel name -> (ms, count)."""
    busy_ms = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    port = {}
    for k, (t, n) in by_name.items():
        m = PORT_KERNEL.search(k)
        if m:
            name = m.group(1).replace("(anonymous namespace)::", "")
            pt, pn = port.get(name, (0.0, 0))
            port[name] = (pt + t, pn + n)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_kernels": sum(n for _, n in by_name.values()),
            "top_kernels": [{"name": k[:90], "ms": t, "count": n}
                            for k, (t, n) in top],
            "port_kernels": [{"name": k, "ms": t, "count": n}
                             for k, (t, n) in sorted(port.items())]}


# ---------------------------------------------------------------------------
# phases 6-7: the perception front door at full width, 800 px
# ---------------------------------------------------------------------------

def perception_images():
    """The perception phase's uint8 images (numpy seed 3)."""
    rng = np.random.RandomState(3)
    return [rng.randint(0, 256, sh, np.uint8) for sh in PERCEPTION_IMAGES]


def perception_call(pred, task, img):
    """The direct Predictor call of a perception request."""
    body = PERCEPTION_REQUESTS[task][1]
    if task == "detect":
        return pred.detect(img, body["classes"], threshold=body["threshold"],
                           topk=body["topk"], with_mask=body["with_mask"])
    if task == "ground":
        return pred.ground(img, body["expression"],
                           with_mask=body["with_mask"])
    return pred.pose(img, threshold=body["threshold"], topk=body["topk"])


def perception_prompt(task, num_embs=4):
    body = PERCEPTION_REQUESTS[task][1]
    if task == "detect":
        return det_prompt(body["classes"], num_embs)
    if task == "ground":
        return grd_prompt(body["expression"], num_embs)
    return pose_prompt(COCO_KEYPOINT_NAMES, "person", num_embs)


def perception_prompt_lengths():
    """Tokens of the detect and pose prompts (right-padded to 32) that the
    LLaMA prefill of a perception request attends over."""
    return {task: len(prompt_ids(SimpleTokenizer(),
                                 *perception_prompt(task)))
            for task in ("detect", "pose")}


def check_perception_reply(task, reply, hw):
    """Shapes and finiteness of one reply (JSON lists) to an image of
    height and width `hw`."""
    topk = PERCEPTION_REQUESTS[task][1].get("topk")
    if task == "ground":
        vals = [*reply["box"], reply["score"]]
        ok = len(reply["box"]) == 4 and 0.0 <= reply["score"] <= 1.0 and \
            reply["mask"]["size"] == list(hw)
    elif task == "detect":
        vals = [*reply["scores"], *np.ravel(reply["boxes"])]
        ok = (len(reply["scores"]) == len(reply["masks"]) == topk
              and all(m["size"] == list(hw) for m in reply["masks"])
              and np.shape(reply["boxes"]) == (topk, 4))
    else:
        vals = [*reply["scores"], *np.ravel(reply["keypoints"])]
        ok = np.shape(reply["keypoints"]) == (topk, 17, 3) and \
            reply["keypoint_names"] == COCO_KEYPOINT_NAMES
    if not (ok and np.isfinite(vals).all()):
        raise AssertionError(f"{task}: bad reply {str(reply)[:300]}")


def rel_err(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


TOOL_OUTPUTS = {"gdino": ("logits", "pred_boxes", "pred_masks"),
                "unipose": ("pred_logits", "pred_boxes", "pred_keypoints")}


def run_tool(tool, name, aug, pm, tq, mask, choices):
    """Tool `name` ("gdino" or "unipose"; the module `tool`) on the text
    queries `tq` [B, P, C]: UniPose takes the first as its object query
    and the rest as its keypoint queries, as `Predictor.pose` does."""
    if name == "unipose":
        return tool(aug, tq[:, :1], mask[:, :1], tq[:, 1:], mask[:, 1:],
                    pixel_mask=pm, **choices)
    return tool(aug, tq, mask, pixel_mask=pm, **choices)


def predictor_call(pred, task, img):
    """`perception_call` with what its tool returned: (reply, (ids,
    images, aug, pixel_mask) as the model got them, the raw outputs),
    recorded around the model's `infer_det` and `infer_pose`."""
    model, seen = pred.model, []

    def recording(fn):
        def call(ids, images, aug, *args, pixel_mask=None, **kwargs):
            out = fn(ids, images, aug, *args, pixel_mask=pixel_mask,
                     **kwargs)
            seen.append(((ids, images, aug, pixel_mask), out))
            return out
        return call

    for name in ("infer_det", "infer_pose"):
        setattr(model, name, recording(getattr(model, name)))
    try:
        reply = perception_call(pred, task, img)
    finally:
        for name in ("infer_det", "infer_pose"):
            delattr(model, name)
    (req, out), = seen
    return reply, req, out


def perception_tool(task):
    return "unipose" if task == "pose" else "gdino"


def tool_vs_plain(model, tid, name, req, out_k):
    """One request's raw outputs of tool `name` from its main-path call
    (`out_k`, before any top-k of the post-processing) against the plain
    versions on the kernel run's proposal (and, for pose, group) choices.
    `req` is (ids, images, aug, pixel_mask) as that call got them.
    Returns (errs, runs): errs = {"text_queries": the LLM's
    kernel-vs-plain error (flash), "tool": the plain tool on the kernel
    run's text queries against `out_k` (MSDA), "end_to_end": both stages
    plain against `out_k`}, relative Frobenius errors with logits over
    their valid text columns; runs = what `fp32_witness` reuses."""
    ids, images, aug, pm = req
    tool = getattr(model, name)
    tq_k, mask = text_queries(model, ids, images, tid)
    choices = {k: out_k[k] for k in ("topk_idx", "group_idx") if k in out_k}
    with plain_versions():
        tq_p, _ = text_queries(model, ids, images, tid)
        out_p = run_tool(tool, name, aug, pm, tq_p, mask, choices)
        out_g = run_tool(tool, name, aug, pm, tq_k, mask, choices)
    runs = {"req": req, "mask": mask, "choices": choices, "tq_k": tq_k,
            "tq_p": tq_p, "out_k": out_k, "out_p": out_p, "out_g": out_g,
            "cols": mask[0, :1] if name == "unipose" else mask[0]}
    errs = {"text_queries": rel_err(tq_k, tq_p), "tool": {},
            "end_to_end": {}}
    for key in TOOL_OUTPUTS[name]:
        k, p, g = (valid_columns(runs, key, o[key])
                   for o in (out_k, out_p, out_g))
        errs["tool"][key], errs["end_to_end"][key] = rel_err(k, g), \
            rel_err(k, p)
    return errs, runs


def valid_columns(runs, key, x):
    """Logits `x` over the request's valid text columns; other outputs
    whole."""
    if key in ("logits", "pred_logits"):
        cols = runs["cols"]
        return x[..., :cols.shape[0]][..., cols]
    return x


def perception_errs(model, tid, task, req, out_k):
    """The perception gate's errors of one request: its text queries and
    its tool's outputs end to end, kernels against plain versions."""
    e, _ = tool_vs_plain(model, tid, perception_tool(task), req, out_k)
    return {"text_queries": e["text_queries"], **e["end_to_end"]}


def run_perception():
    """The perception phase: see the module docstring."""
    torch.cuda.reset_peak_memory_stats()
    cfg = vllm_7b_perception_config()
    t = time.perf_counter()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    tok = SimpleTokenizer()
    pred = Predictor(cfg, model, tok, device="cuda")
    # the chat service shares the core: one copy of the 7B weights
    svc = ChatService(cfg, model.core, tok,
                      image_size=cfg.vis_encoder.image_size, device="cuda")
    srv = make_server(svc, host="127.0.0.1", port=0, predictor=pred)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    images = perception_images()
    per_req = {"flash_attn_fwd": cfg.vis_encoder.num_layers
               + cfg.llm.num_layers,
               "ms_deform_attn_fwd": cfg.gdino.encoder_layers
               + cfg.gdino.decoder_layers}
    per_req_pose = dict(per_req, ms_deform_attn_fwd=cfg.unipose.encoder_layers
                        + cfg.unipose.decoder_layers)

    # the main path, with the launch counts taken around it alone
    A.flash_attention.launches = 0
    M.ms_deform_attn.launches = 0
    calls, replies, raw = [], {}, {}
    with torch.no_grad():
        for i, img in enumerate(images):
            for task, (path, body) in PERCEPTION_REQUESTS.items():
                for via in ("direct", "http"):
                    f0, m0 = A.flash_attention.launches, \
                        M.ms_deform_attn.launches
                    t0 = time.perf_counter()
                    if via == "direct":
                        reply, *raw[i, task] = predictor_call(pred, task,
                                                              img)
                        reply = json.loads(json.dumps(perception_json(
                            reply)))
                    else:
                        reply = post_json(url + path, {
                            "image_b64": base64.b64encode(
                                img.tobytes()).decode(),
                            "image_shape": list(img.shape), **body})
                    calls.append({
                        "image": i, "task": task, "via": via,
                        "wall_ms": (time.perf_counter() - t0) * 1e3,
                        "flash_attn_fwd": A.flash_attention.launches - f0,
                        "ms_deform_attn_fwd": M.ms_deform_attn.launches - m0})
                    replies[i, task, via] = reply
    torch.cuda.synchronize()
    launches = {"flash_attn_fwd": A.flash_attention.launches,
                "ms_deform_attn_fwd": M.ms_deform_attn.launches}
    for c in calls:
        want = per_req_pose if c["task"] == "pose" else per_req
        if any(c[k] != want[k] for k in want):
            raise AssertionError(f"launches of {c} != {want}")
    for (i, task, via), reply in replies.items():
        if via == "http" and reply != replies[i, task, "direct"]:
            raise AssertionError(f"image {i} {task}: the HTTP reply differs "
                                 "from the direct call's")
        check_perception_reply(task, reply, images[i].shape[:2])

    # the main path's raw tool outputs against the plain versions
    errs = {}
    with torch.no_grad():
        for (i, task), (req, out_k) in raw.items():
            errs[f"{i}:{task}"] = e = perception_errs(model, pred.tid, task,
                                                      req, out_k)
            if not max(e.values()) <= PERCEPTION_REL_TOL:
                raise AssertionError(f"image {i} {task} kernel vs plain "
                                     f"{e} > {PERCEPTION_REL_TOL}")

    # warm request times (direct calls, host clock, synced)
    with torch.no_grad():
        req_ms = {task: host_ms(lambda: perception_call(pred, task,
                                                        images[0]))
                  for task in PERCEPTION_REQUESTS}
    prompts = {task: len(prompt_ids(tok, *perception_prompt(task)))
               for task in PERCEPTION_REQUESTS}
    buckets = [list(pred._prepare(img, "<image>\nq", "a")["image_aug"]
                    .shape[1:3]) for img in images]
    emit({"phase": "perception", "config": "vllm_7b_perception_config()",
          "images": [list(sh) for sh in PERCEPTION_IMAGES],
          "buckets": buckets, "requests": PERCEPTION_REQUESTS,
          "prompt_tokens": prompts, "build_model_s": build_s,
          "params": sum(p.numel() for p in model.parameters()),
          "calls": calls, "launches": launches,
          "launches_per_request": {"detect/ground": per_req,
                                   "pose": per_req_pose},
          "http_equals_direct": True,
          "plain_rel_err": errs, "plain_rel_tol": PERCEPTION_REL_TOL,
          "request_ms_median": req_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    for task in ("detect", "pose"):
        profile_perception(pred, task, images[0])
    srv.shutdown()
    srv.server_close()
    svc.close()
    return launches


def profile_perception(pred, task, img):
    """One warm perception request (the direct call) under torch.profiler."""
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        perception_call(pred, task, img)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    emit({"phase": "perception_profile", "task": task,
          **device_summary(prof, wall_ms)})


# ---------------------------------------------------------------------------
# phases 14-15: the det training step at full width and depth
# ---------------------------------------------------------------------------

def train_batch(cfg, tid, g):
    """bench_train.py's det batch at bs 1: the 586-token prompt, CLIP and
    640 px det pixels, 20 targets (boxes from numpy seed 0, full masks)."""
    img_len = cfg.vis_encoder.num_patches
    ids = ([1, 10, 11] + [tid.imp] * img_len + [12] + [tid.det]
           + [tid.emb + i for i in range(cfg.num_embs)] + [2])
    input_ids = torch.tensor([ids], dtype=torch.long, device="cuda")
    rng = np.random.default_rng(0)
    cxcy = rng.uniform(0.3, 0.7, (1, TRAIN_TARGETS, 2))
    wh = rng.uniform(0.05, 0.25, (1, TRAIN_TARGETS, 2))
    size = cfg.vis_encoder.image_size
    return {
        "input_ids": input_ids,
        "labels": torch.where(input_ids >= 10, input_ids,
                              torch.full_like(input_ids, -100)),
        "attn_mask": torch.ones_like(input_ids),
        "images": (0.5 * torch.randn(1, size, size, 3, generator=g,
                                     device="cuda")).to(torch.bfloat16),
        "images_aug": (0.5 * torch.randn(1, TRAIN_DET, TRAIN_DET, 3,
                                         generator=g, device="cuda")
                       ).to(torch.bfloat16),
        "targets": {
            "labels": torch.zeros(1, TRAIN_TARGETS, dtype=torch.long,
                                  device="cuda"),
            "boxes": torch.tensor(np.concatenate([cxcy, wh], -1),
                                  dtype=torch.float32, device="cuda"),
            "valid": torch.ones(1, TRAIN_TARGETS, dtype=torch.bool,
                                device="cuda"),
            "masks": torch.ones(1, TRAIN_TARGETS, TRAIN_DET // 4,
                                TRAIN_DET // 4, device="cuda"),
        },
    }


TRAIN_KERNELS = (("flash_attn_fwd", A.flash_attention),
                 ("flash_attn_bwd", A.flash_attention_bwd),
                 ("ms_deform_attn_fwd", M.ms_deform_attn),
                 ("ms_deform_attn_bwd", M.ms_deform_attn_bwd))


def train_counts():
    return tuple(fn.launches for _, fn in TRAIN_KERNELS)


def train_launches_per_step(cfg):
    """TRAIN_KERNELS' launches in one det train step: flash forward in
    every CLIP and LLaMA layer, backward in the LLaMA layers (the frozen
    CLIP takes no backward), MSDA forward and backward in every
    Grounding-DINO encoder and decoder layer."""
    msda = cfg.gdino.encoder_layers + cfg.gdino.decoder_layers
    return (cfg.vis_encoder.num_layers + cfg.llm.num_layers,
            cfg.llm.num_layers, msda, msda)


def loss_and_grad(model, batch, tid, noise, trainable, choices=None):
    """One det step's loss terms and fp32 trainable gradients by name (no
    optimizer step), and the discrete choices it made (or repeated)."""
    for p in trainable.values():
        p.grad = None
    loss, metrics, choices = det_loss(model, batch, tid, noise, choices)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None
                 else torch.zeros_like(p)).float()
             for n, p in trainable.items()}
    for p in trainable.values():
        p.grad = None
    return {k: v.item() for k, v in metrics.items()}, grads, choices


def grad_groups(gk, gp):
    """Relative L2 error of the gradients `gk` against `gp` and the norm
    of `gp`, by module (the first two parts of the parameter path), and
    the relative L2 error of the whole concatenated gradient."""
    acc = {}
    for n in gp:
        key = ".".join(n.split(".")[:2])
        d, w = acc.get(key, (0.0, 0.0))
        acc[key] = (d + (gk[n] - gp[n]).square().sum().item(),
                    w + gp[n].square().sum().item())
    total = math.sqrt(sum(d for d, _ in acc.values())
                      / sum(w for _, w in acc.values()))
    return {k: {"rel": math.sqrt(d / w) if w else 0.0, "norm": math.sqrt(w)}
            for k, (d, w) in sorted(acc.items())}, total


def plain_backwards():
    """The kernels' forwards with the plain versions' backwards: the two
    backward wrappers the autograd functions call become autograd of the
    plain forwards at the same inputs."""
    stack = ExitStack()
    stack.enter_context(mock.patch.object(
        A, "flash_attention_bwd",
        lambda q, k, v, out, dout, lse, causal=False, segment_ids=None:
        A.flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                    segment_ids=segment_ids)))
    stack.enter_context(mock.patch.object(M, "ms_deform_attn_bwd",
                                          M.ms_deform_attn_bwd_plain))
    return stack


def build_train():
    """The train phase's model (seed 0), optimizer, state and step: the
    stage-1 frozen `vllm_7b_det_config()`."""
    cfg = vllm_7b_det_config()
    tid = SpecialTokenIds.synthetic()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    # reference stage 1: vision encoder and LLM frozen
    frozen = frozen_predicate(TrainConfig(freeze_llm=True), cfg)
    tx = build_optimizer(OptimizerConfig(total_steps=1000), model, frozen)
    state = TrainState.create(model, tx, frozen)
    step = make_det_train_step(model, tx, tid, frozen)
    return cfg, tid, model, state, step


def run_train():
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    cfg, tid, model, state, step = build_train()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in model.parameters())
    n_train = sum(w.numel() for w in state.masters.values())
    g = torch.Generator(device="cuda").manual_seed(2)
    batch = train_batch(cfg, tid, g)
    per_step = train_launches_per_step(cfg)

    # one step's losses and gradient, kernels against plain versions, from
    # the same weights, batch and draws, and on the kernel run's discrete
    # choices (top-k proposals, matchings, mask points), which bf16
    # near-ties could otherwise flip between the runs. The loss terms are
    # held against the all-plain step. The gradient is held against the
    # step whose forward is the kernels' and whose backward is the plain
    # versions' (autograd of the plain forwards at the same inputs): with
    # random weights the gradient is chaotic in the forward's last-bit
    # rounding (the all-plain step's, reported, moves it by ~13 % while
    # its text queries move by 1.5 %), which says nothing of a backward
    # kernel.
    trainable = {n: p for n, p in model.named_parameters()
                 if n in state.masters}
    noise = draw_step_noise(g, cfg.gdino, batch["targets"])
    torch.cuda.reset_peak_memory_stats()
    mk, gk, choices = loss_and_grad(model, batch, tid, noise, trainable)
    peak_no_remat = torch.cuda.max_memory_allocated() / 1e9
    with plain_versions():
        mp, gp, _ = loss_and_grad(model, batch, tid, noise, trainable,
                                  choices)
    with plain_backwards():
        _, gb, _ = loss_and_grad(model, batch, tid, noise, trainable,
                                 choices)
    loss_rel = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in mp}
    groups, grad_rel = grad_groups(gk, gb)
    _, grad_rel_all_plain = grad_groups(gk, gp)
    emit({"phase": "train_compare", "loss_terms_kernel": mk,
          "loss_terms_plain": mp, "loss_rel_err": loss_rel,
          "grad_rel_err_plain_backward": grad_rel,
          "grad_rel_err_all_plain": grad_rel_all_plain,
          "grad_by_module": groups})
    if not (max(loss_rel.values()) <= TRAIN_REL_TOL
            and grad_rel <= TRAIN_REL_TOL):
        raise AssertionError(f"train step kernel vs plain: loss terms "
                             f"{loss_rel}, gradient {grad_rel} (tol "
                             f"{TRAIN_REL_TOL})")
    if not all(math.isfinite(v) for v in mk.values()):
        raise AssertionError(f"non-finite loss terms {mk}")
    del gp, gb
    remat = train_remat_steps(model, cfg, batch, tid, noise, trainable,
                              choices, mk, gk, peak_no_remat)
    del gk

    frozen_before = {n: p.detach().clone() for n, p in model.named_parameters()
                     if n not in state.masters}
    masters_before = {n: w.clone() for n, w in state.masters.items()}
    train_before = {n: p.detach().clone() for n, p in trainable.items()}

    # the main path: TRAIN_STEPS AdamW steps, counts taken around them
    for _, fn in TRAIN_KERNELS:
        fn.launches = 0
    step_ms, counts, losses = [], [], []
    for _ in range(TRAIN_STEPS):
        c0 = train_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, batch, generator=g)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        counts.append(tuple(b - a for a, b in zip(c0, train_counts())))
        losses.append({k: v.item() for k, v in metrics.items()})
    launches = {name: fn.launches for name, fn in TRAIN_KERNELS}
    if any(c != per_step for c in counts):
        raise AssertionError(f"launches per step {counts} != {per_step}")
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"non-finite losses {losses}")
    # the fp32 masters move every step; a bf16 parameter moves once its
    # master has crossed half a bf16 step (norm weights at 1.0 need more
    # than these few lr-2e-5 steps)
    moved = sum(not torch.equal(w, masters_before[n])
                for n, w in state.masters.items())
    moved_bf16 = sum(not torch.equal(p.detach(), train_before[n])
                     for n, p in trainable.items())
    if moved < 0.9 * len(trainable):
        raise AssertionError(f"only {moved} of {len(trainable)} trainable "
                             "masters moved")
    params = dict(model.named_parameters())
    changed = [n for n, w in frozen_before.items()
               if not torch.equal(params[n].detach(), w)]
    if changed:
        raise AssertionError(f"frozen parameters changed: {changed[:5]}")
    del frozen_before, train_before, masters_before
    emit({"phase": "train", "config": "vllm_7b_det_config() stage 1",
          "llm_layers": cfg.llm.num_layers, "det_size": TRAIN_DET,
          "prompt_tokens": int(batch["input_ids"].shape[1]),
          "targets": TRAIN_TARGETS, "dn_number": cfg.gdino.dn_number,
          "mask_points": cfg.gdino.num_mask_points,
          "params": n_params, "trainable": n_train,
          "trainable_tensors": len(trainable), "moved_masters": moved,
          "moved_bf16_params": moved_bf16,
          "build_s": build_s,
          "plain_loss_rel_err": loss_rel,
          "plain_backward_grad_rel_err": grad_rel,
          "all_plain_grad_rel_err": grad_rel_all_plain,
          "rel_tol": TRAIN_REL_TOL,
          "launches_per_step": dict(zip([n for n, _ in TRAIN_KERNELS],
                                        counts[0])),
          "launches": launches, "step_ms": step_ms,
          "step_ms_median_2_to_5": statistics.median(step_ms[1:]),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "loss_trace": [m["loss"] for m in losses], "last_step": losses[-1],
          "kernel_step_terms": mk, "gdino_remat": remat})
    profile_train_step(step, state, batch, g)
    return launches


def train_remat_steps(model, cfg, batch, tid, noise, trainable, choices, mk,
                      gk, peak_no_remat):
    """The det step with `GDinoConfig.remat` "full" and then "dots" (the
    built model's Grounding-DINO switched), on the batch, draws and
    discrete choices of the kernel step without remat (`mk`, `gk`): each
    loss term and the trainable gradient within TRAIN_REL_TOL of it (the
    MSDA backward adds with atomics: no bitwise claim), the launches a
    step (the MSDA forward once more in every recomputed layer), and each
    mode's peak memory beside the step without remat."""
    per_step = train_launches_per_step(cfg)
    msda = cfg.gdino.encoder_layers + cfg.gdino.decoder_layers
    out = {"none": {"peak_gb": peak_no_remat}}
    try:
        for mode in ("full", "dots"):
            model.gdino.cfg = dataclasses.replace(cfg.gdino, remat=mode)
            c0 = train_counts()
            torch.cuda.reset_peak_memory_stats()
            m, gr, _ = loss_and_grad(model, batch, tid, noise, trainable,
                                     choices)
            peak = torch.cuda.max_memory_allocated() / 1e9
            launches = tuple(b - a for a, b in zip(c0, train_counts()))
            loss_rel = {k: abs(m[k] - mk[k]) / max(abs(mk[k]), 1e-12)
                        for k in mk}
            _, grad_rel = grad_groups(gr, gk)
            want = (per_step[0], per_step[1], per_step[2] + msda,
                    per_step[3])
            out[mode] = {"peak_gb": peak, "loss_rel_err": max(
                loss_rel.values()), "grad_rel_err": grad_rel,
                "loss_terms_equal": m == mk,
                "launches": dict(zip([n for n, _ in TRAIN_KERNELS],
                                     launches))}
            del gr
            if not (launches == want
                    and out[mode]["loss_rel_err"] <= TRAIN_REL_TOL
                    and grad_rel <= TRAIN_REL_TOL):
                raise AssertionError(f"det step with remat {mode!r}: "
                                     f"{out[mode]}, launches want {want} "
                                     f"(tol {TRAIN_REL_TOL})")
    finally:
        model.gdino.cfg = cfg.gdino
    return out


def profile_train_step(step, state, batch, g):
    """One more train step under torch.profiler."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, batch, generator=g)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    emit({"phase": "train_profile", **device_summary(prof, wall_ms)})


# ---------------------------------------------------------------------------
# phase: the trainer - Trainer.train on COCO-style JPEGs
# ---------------------------------------------------------------------------

def fixture_manifest():
    with open(os.path.join(JPEG_FIXTURES, "manifest.json")) as f:
        return json.load(f)


def check_jpeg_fixtures(manifest):
    """Check 1: every committed JPEG decodes on this host to the sha256
    Pillow gave its pixels (the manifest); decode ms (median of
    N_TIMED) and MB/s of the file and of the RGB pixels."""
    out = {}
    for name, entry in sorted(manifest["files"].items()):
        path = os.path.join(JPEG_FIXTURES, name)
        with open(path, "rb") as f:
            data = f.read()
        img = load_image(path)
        digest = hashlib.sha256(img.tobytes()).hexdigest()
        if list(img.shape) != entry["shape"] or digest != entry["sha256"]:
            raise AssertionError(
                f"{name}: decoded {img.shape} {digest}, the manifest says "
                f"{entry['shape']} {entry['sha256']}")
        ms = host_ms(lambda: decode_image_bytes(data, name))
        out[name] = {"options": entry["options"], "bytes": len(data),
                     "ms": ms, "file_MB_s": len(data) / 1e3 / ms,
                     "pixels_MB_s": img.nbytes / 1e3 / ms}
    return out


def check_host_native(manifest):
    """Check 2: the native resizer, normalize/pad and RLE codec equal
    their numpy plain versions on a 480x640 fixture and its objects'
    masks; resize ms native against numpy at the CLIP size (the padded
    square to 336, bicubic) and the det test size (bilinear)."""
    img = load_image(os.path.join(JPEG_FIXTURES, "coco_420_q75.jpg"))
    h, w = img.shape[:2]
    square = expand2square(img, (CLIP_MEAN * 255).astype(np.uint8))
    cases = {"clip_336_bicubic": (square, (336, 336), "bicubic"),
             "det_800_bilinear": (img, keep_ratio_size(h, w, TEST_SCALE),
                                  "bilinear"),
             "mask_800_nearest": (img[:, :, 0], keep_ratio_size(
                 h, w, TEST_SCALE), "nearest")}
    resize = {}
    for name, (x, size, method) in cases.items():
        got = native_image.resize_u8(x, size, method)
        want = resize_image_np(x, size, method)
        if not np.array_equal(got, want):
            raise AssertionError(f"native resize {name} differs from numpy")
        resize[name] = {
            "src": list(x.shape), "dst": list(size),
            "native_ms": host_ms(lambda: native_image.resize_u8(x, size,
                                                                method)),
            "numpy_ms": host_ms(lambda: resize_image_np(x, size, method),
                                n=2)}
    out_hw = (max(h, w), max(h, w))
    got = native_image.normalize_pad(img, IMAGENET_MEAN, IMAGENET_STD,
                                     out_hw)
    want = native_image.normalize_pad_np(img, IMAGENET_MEAN, IMAGENET_STD,
                                         out_hw)
    norm_err = float(np.abs(got - want).max())
    if norm_err > 3e-7:
        raise AssertionError(f"normalize_pad {norm_err} from numpy")
    objects = manifest["files"]["coco_420_q75.jpg"]["objects"]
    for obj in objects:
        mask = decode_segmentation([obj["polygon"]], h, w)
        rle = rle_encode(mask)
        if (rle != R.rle_encode_np(mask)
                or not np.array_equal(R.rle_decode(rle["counts"], h, w),
                                      R.rle_decode_np(rle["counts"], h, w))
                or R.rle_area(rle) != R.rle_area_np(rle)
                or R.rle_area(rle) != int(mask.sum())):
            raise AssertionError(f"native RLE differs from numpy on a "
                                 f"{obj['category']}")
    return {"resize": resize, "normalize_pad_max_abs_err": norm_err,
            "rle_masks": len(objects)}


def write_trainer_annotations(manifest, root, copies=TRAINER_COPIES):
    """A COCO-style annotation file over the fixtures, each listed
    `copies` times, with their drawn objects (3-6 each) as boxes and
    polygons in 3 categories."""
    cats = {"rect": 1, "ellipse": 2, "triangle": 3}
    images, anns = [], []
    for copy_i in range(copies):
        for k, (name, entry) in enumerate(sorted(manifest["files"].items())):
            image_id = copy_i * 100 + k
            images.append({"id": image_id, "file_name": name,
                           "height": entry["shape"][0],
                           "width": entry["shape"][1]})
            for obj in entry["objects"]:
                x, y, bw, bh = obj["bbox"]
                anns.append({"id": len(anns) + 1, "image_id": image_id,
                             "category_id": cats[obj["category"]],
                             "bbox": obj["bbox"], "area": bw * bh,
                             "iscrowd": 0, "segmentation": [obj["polygon"]]})
    path = os.path.join(root, "trainer_ann.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": i, "name": n}
                                  for n, i in cats.items()]}, f)
    return path, len(images), len(anns)


def trainer_model(cfg):
    """The phase's model, set on each Trainer before it trains:
    `build_model` (seed 0) with the det backbone's patch-embedding bias
    drawn from TRAINER_BIAS_SEED (N(0, 0.02)). `build_model`'s zero
    biases make every padded patch of a bucket the zero vector, so the
    Swin blocks' LayerNorms see constant inputs on the padding and each
    multiplies those tokens' gradient by 1 / sqrt(eps): the JAX package's
    Trainer and the port's both reach a gradient norm of 7.9e10 at the
    tiny config on the CPU (`tests/test_torch_trainer.py`), and here the
    fp32 norm overflowed, which `Trainer.train` refuses. A trained bias
    is not zero. The train phase's batch has no padding."""
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    bias = dict(model.named_parameters())[TRAINER_BIAS]
    g = torch.Generator(device=bias.device).manual_seed(TRAINER_BIAS_SEED)
    with torch.no_grad():
        bias.copy_(0.02 * torch.randn(bias.shape, generator=g,
                                      device=bias.device))
    return model


def trainer_config(out, workers, save_every=TRAINER_SAVE_EVERY):
    """The phase's TrainConfig: stage 1 (vision encoder and LLM frozen),
    the train phase's optimizer."""
    return TrainConfig(output_dir=out, batch_size=TRAINER_BATCH,
                       total_steps=TRAINER_STEPS, log_every=1,
                       save_every=save_every, seed=0,
                       num_workers=workers, freeze_llm=True,
                       optimizer=OptimizerConfig(total_steps=1000))


def check_loader_workers(trainer, concat, batches):
    """Check 3: the Trainer's loader at TRAINER_WORKERS threads gives the
    synchronous loop's batches byte for byte; ms a batch for each (one
    pass each, no consumer)."""
    runs, ms = {}, {}
    for workers in (0, TRAINER_WORKERS):
        trainer.tc.num_workers = workers
        t = time.perf_counter()
        runs[workers] = list(trainer.loader(concat, batches))
        ms[workers] = (time.perf_counter() - t) * 1e3 / len(batches)
    trainer.tc.num_workers = TRAINER_WORKERS

    def arrays(b):
        idx, batch = b
        flat = [("idx", np.asarray(idx))]
        for k, v in sorted(batch.items()):
            flat += ([(f"{k}.{kk}", vv) for kk, vv in sorted(v.items())]
                     if isinstance(v, dict) else [(k, v)])
        return flat

    for p, (a, b) in enumerate(zip(runs[0], runs[TRAINER_WORKERS])):
        for (ka, va), (kb, vb) in zip(arrays(a), arrays(b)):
            if ka != kb or va.dtype != vb.dtype or va.shape != vb.shape \
                    or va.tobytes() != vb.tobytes():
                raise AssertionError(f"loader batch {p} {ka}: "
                                     f"{TRAINER_WORKERS} workers differ "
                                     "from the synchronous loop")
    if len(runs[0]) != len(runs[TRAINER_WORKERS]) or not runs[0]:
        raise AssertionError("loader batch counts differ")
    first = runs[0][0][1]
    return ms, first, {k: list(v.shape) for k, v in first.items()
                       if isinstance(v, np.ndarray)}


def check_first_step(model, trainer, first, tid):
    """Check 5: the first batch's loss and trainable gradient norm with
    the kernels against the plain versions (same weights, batch, draws
    and discrete choices), within TRAIN_REL_TOL."""
    batch = to_device(first, trainer.device, trainer.dtype)
    trainable = split_frozen(model, trainer.frozen)
    g = torch.Generator(device=trainer.device).manual_seed(2)
    noise = draw_step_noise(g, model.cfg.gdino, batch["targets"])
    mk, gk, choices = loss_and_grad(model, batch, tid, noise, trainable)
    nk = math.sqrt(sum(v.square().sum().item() for v in gk.values()))
    del gk
    with plain_versions():
        mp, gp, _ = loss_and_grad(model, batch, tid, noise, trainable,
                                  choices)
    np_ = math.sqrt(sum(v.square().sum().item() for v in gp.values()))
    del gp
    errs = {"loss": abs(mk["loss"] - mp["loss"]) / abs(mp["loss"]),
            "grad_norm": abs(nk - np_) / np_}
    if not (all(math.isfinite(v) for v in mk.values())
            and max(errs.values()) <= TRAIN_REL_TOL):
        raise AssertionError(f"trainer first step kernel vs plain: {errs} "
                             f"(tol {TRAIN_REL_TOL}), losses {mk}")
    return {"kernel": {"loss": mk["loss"], "grad_norm": nk},
            "plain": {"loss": mp["loss"], "grad_norm": np_},
            "rel_err": errs}


def instrument_trainer(trainer, counts, prof, snap, last):
    """Wrap the Trainer's step: launches per step (`counts`);
    torch.profiler from the end of step `last - 1` to the end of step
    `last` (the loop's own wait for the batch, moving it and the step;
    its wall in `prof`, unless that is None); and the fp32 masters and
    moments after each
    step of SNAP_STEPS, copied to the host (`snap[step]`)."""
    step_fn_for = trainer.step_fn_for

    def wrapped_for(group):
        fn = step_fn_for(group)

        def step(state, batch, **kw):
            k = state.step + 1
            c0 = train_counts()
            out = fn(state, batch, **kw)
            counts.append(tuple(b - a for a, b in zip(c0, train_counts())))
            if prof is not None and k == last - 1:
                torch.cuda.synchronize()
                prof["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA])
                prof["prof"].start()
                prof["t0"] = time.perf_counter()
            if prof is not None and k == last:
                torch.cuda.synchronize()
                prof["wall_ms"] = (time.perf_counter() - prof["t0"]) * 1e3
                prof["prof"].stop()
            if k in SNAP_STEPS:
                snap[k] = {part: {n: t.detach().to("cpu", copy=True)
                                  for n, t in
                                  getattr(out[0], part).items()}
                           for part in ("masters", "mu", "nu")}
            return out
        return step

    trainer.step_fn_for = wrapped_for


def timed_saves(trainer, seconds):
    save = trainer.save

    def timed(state):
        t = time.perf_counter()
        path = save(state)
        seconds.append(time.perf_counter() - t)
        return path
    trainer.save = timed


def check_restored(trainer, state, ck):
    """The resumed Trainer's live state is the checkpoint's, bit for bit:
    step, the accumulation's micro-step and applied steps, sampler
    position, generator, fp32 masters, both moments and the running mean
    on the card, and each trainable parameter its master rounded."""
    params = dict(trainer.model.named_parameters())
    bad = [f"{part}.{n}" for part in ("masters", "mu", "nu", "acc")
           for n, t in getattr(state, part).items()
           if not torch.equal(t.cpu(), ck[part][n])]
    bad += [n for n, w in state.masters.items()
            if not torch.equal(params[n].detach(), w.to(params[n].dtype))]
    if (bad or state.step != ck["step"] or trainer.position != ck["position"]
            or (state.mini_step, state.gradient_step)
            != (ck["mini_step"], ck["gradient_step"])
            or not torch.equal(trainer.generator.get_state(),
                               ck["generator"])):
        raise AssertionError(f"restored state differs from the checkpoint: "
                             f"{bad[:5]}, step {state.step}, position "
                             f"{trainer.position}")


def state_rel_err(a, b):
    """Relative L2 distance of two snapshots, per part (all tensors of a
    part as one vector)."""
    out = {}
    for part in ("masters", "mu", "nu"):
        d = sum((a[part][n] - b[part][n]).double().square().sum().item()
                for n in b[part])
        w = sum(t.double().square().sum().item() for t in b[part].values())
        out[part] = math.sqrt(d / w) if w else math.sqrt(d)
    return out


def resume_from(cfg, tid, tok, ds_cfgs, ckpt, ck, out, workers, steps,
                save_every):
    """A fresh Trainer on a fresh model in `out`, resumed from the
    checkpoint directory `ckpt` (its live state held to `ck` by
    `check_restored`) and trained to `steps` with `workers` loader
    threads. Returns its metrics rows, launches per step, snapshots
    (SNAP_STEPS), restore seconds, step intervals and, for the
    synchronous run, the profile of its last step."""
    shutil.copytree(ckpt, os.path.join(out, "checkpoints",
                                       os.path.basename(ckpt)))
    trainer = Trainer(cfg, trainer_config(out, workers, save_every), tid)
    trainer.model = trainer_model(cfg)
    counts, snap, init_s = [], {}, []
    prof = {} if workers == 0 else None
    instrument_trainer(trainer, counts, prof, snap, steps)
    init_state = trainer.init_state

    def timed_init():
        t0 = time.perf_counter()
        state = init_state()
        init_s.append(time.perf_counter() - t0)
        check_restored(trainer, state, ck)
        return state
    trainer.init_state = timed_init
    state = trainer.train(ds_cfgs, tok, max_steps=steps)
    if state.step != steps:
        raise AssertionError(f"resumed trainer stopped at {state.step}")
    intervals, waits, step_ms = step_intervals(trainer,
                                               TRAINER_SAVE_EVERY + 1)
    run = {"rows": read_metrics(out), "counts": counts, "snap": snap,
           "init_s": init_s[0], "prof": prof, "intervals": intervals,
           "waits": waits, "step_ms": step_ms}
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return run


def resume_gate(rows, snap, runs, per_step):
    """Check 6 on the resumed `runs` against the straight run (`rows`,
    `snap`): launches per step, finite metrics and step 4's loss terms
    bit for bit; then each run's largest distance from the straight run
    (`gap`) against the largest between two resumed runs (`spread`), in
    the metrics of steps 4 to TRAINER_STEPS (relative to the straight
    run's, step 4's gradient norm included) and in the masters and
    moments after each of SNAP_STEPS (`state_rel_err`). Returns the
    readings."""
    at = TRAINER_SAVE_EVERY        # row index of step 4
    keys = [(s, k) for s in range(at, TRAINER_STEPS) for k in rows[s]
            if k not in ("time", "step")]
    want = np.array([rows[s][k] for s, k in keys])
    got = [np.array([r["rows"][s - at][k] for s, k in keys]) for r in runs]
    for i, r in enumerate(runs):
        terms = {k: v for k, v in r["rows"][0].items()
                 if k not in ("time", "grad_norm")}
        want_terms = {k: v for k, v in rows[at].items()
                      if k not in ("time", "grad_norm")}
        if (terms != want_terms or any(c != per_step for c in r["counts"])
                or not all(math.isfinite(v) for row in r["rows"]
                           for v in row.values())):
            raise AssertionError(
                f"resumed run {i}: step {at + 1} {terms} against "
                f"{want_terms}, launches {r['counts']}")

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(want),
                                                       1e-30)))
    pairs = list(itertools.combinations(range(len(runs)), 2))
    out = {"metric": {"gap": max(rel(g, want) for g in got),
                      "spread": max(rel(got[i], got[j]) for i, j in pairs),
                      "k": RESUME_SPREAD_K_LOSS},
           "state": {}, "k_state": RESUME_SPREAD_K_STATE,
           "losses": [[row["loss"] for row in r["rows"]] for r in runs]}
    bad = out["metric"]["gap"] > RESUME_SPREAD_K_LOSS * out["metric"][
        "spread"]
    for s in SNAP_STEPS:
        gaps = [state_rel_err(r["snap"][s], snap[s]) for r in runs]
        spreads = [state_rel_err(runs[i]["snap"][s], runs[j]["snap"][s])
                   for i, j in pairs]
        out["state"][str(s)] = {
            part: {"gap": max(g[part] for g in gaps),
                   "spread": max(d[part] for d in spreads)}
            for part in ("masters", "mu", "nu")}
        bad |= any(v["gap"] > RESUME_SPREAD_K_STATE * v["spread"]
                   for v in out["state"][str(s)].values())
    if bad:
        raise AssertionError(f"resumed runs drift from the straight run "
                             f"beyond their own spread: {out}")
    return out


def step_intervals(trainer, first):
    """Per step after `first` (the run's first step): ms from the end of
    the step before to its own end (the wait for its batch, moving it,
    the step), and the data wait of each step; and the median interval of
    the steps whose interval holds no checkpoint save, state snapshot or
    profiler start or stop (SNAP_STEPS and the last two; None if no step
    is left)."""
    h = trainer.history
    last = first + len(h) - 1
    steps = range(first + 1, last + 1)
    ms = [(b["t_end"] - a["t_end"]) * 1e3 for a, b in zip(h, h[1:])]
    clean = [t for k, t in zip(steps, ms)
             if k not in SNAP_STEPS + (last - 1, last)]
    return ({str(k): t for k, t in zip(steps, ms)},
            [r["data_wait_s"] * 1e3 for r in h],
            statistics.median(clean) if clean else None)


def read_metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_trainer():
    """The `trainer` phase: `Trainer.train` of the stage-1 det model on
    COCO-style JPEGs; returns the main run's launches."""
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    manifest = fixture_manifest()
    decode = check_jpeg_fixtures(manifest)
    native = check_host_native(manifest)
    cfg = vllm_7b_det_config()
    tid = SpecialTokenIds.synthetic()
    tok = HashedWordTokenizer()
    per_step = train_launches_per_step(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        ann, n_images, n_anns = write_trainer_annotations(manifest, tmp)
        ds_cfgs = [{"type": "coco_det", "ann_file": ann,
                    "img_prefix": JPEG_FIXTURES, "with_mask": True,
                    "image_size": cfg.vis_encoder.image_size,
                    "max_gt_per_img": TRAIN_TARGETS,
                    "train_scales": [(480, TRAIN_DET)],
                    "buckets": ((TRAIN_DET, TRAIN_DET),)}]
        main_dir = os.path.join(tmp, "main")
        t = time.perf_counter()
        main = Trainer(cfg, trainer_config(main_dir, TRAINER_WORKERS), tid)
        main.model = model = trainer_model(cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        concat = build_multi_datasets(
            [{"image_token_len": cfg.image_token_len, **c} for c in ds_cfgs],
            tok)
        batches = list(TaskGroupedBatchSampler(concat, TRAINER_BATCH,
                                               seed=0))
        data_ms, first, shapes = check_loader_workers(main, concat, batches)
        first_step = check_first_step(model, main, first, tid)
        del first

        # the main path: TRAINER_STEPS steps at TRAINER_WORKERS workers
        counts, prof, saves, snap = [], {}, [], {}
        instrument_trainer(main, counts, prof, snap, TRAINER_STEPS)
        timed_saves(main, saves)
        for _, fn in TRAIN_KERNELS:
            fn.launches = 0
        t = time.perf_counter()
        state = main.train(ds_cfgs, tok)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in TRAIN_KERNELS}
        rows = read_metrics(main_dir)
        if state.step != TRAINER_STEPS or len(rows) != TRAINER_STEPS:
            raise AssertionError(f"trainer ran {state.step} steps, logged "
                                 f"{len(rows)}")
        if not all(math.isfinite(v) for r in rows for v in r.values()):
            raise AssertionError(f"non-finite trainer metrics {rows}")
        if any(c != per_step for c in counts):
            raise AssertionError(f"trainer launches per step {counts} != "
                                 f"{per_step}")
        prefetch_summary = device_summary(prof["prof"], prof["wall_ms"])
        intervals, waits, step_ms = step_intervals(main, 1)
        ckpts = sorted(os.listdir(main.ckpt_dir))
        del state, main, model, prof
        gc.collect()
        torch.cuda.empty_cache()

        # fresh Trainers resume from step 3: the synchronous loop to
        # TRAINER_RESUME_STEPS, then TRAINER_REPEATS with the main loader
        # (each saves at its end only, so no save falls between steps)
        ckpt = os.path.join(main_dir, "checkpoints", str(TRAINER_SAVE_EVERY))
        t = time.perf_counter()
        ck = restore_checkpoint(os.path.dirname(ckpt), TRAINER_SAVE_EVERY)
        load_s = time.perf_counter() - t
        resumed = [resume_from(cfg, tid, tok, ds_cfgs, ckpt, ck,
                               os.path.join(tmp, f"resume{i}"), *run)
                   for i, run in enumerate(
                       [(0, TRAINER_RESUME_STEPS, TRAINER_RESUME_STEPS)]
                       + [(TRAINER_WORKERS, TRAINER_STEPS, TRAINER_STEPS)]
                       * TRAINER_REPEATS)]
        del ck
        resume = resume_gate(rows, snap, resumed, per_step)
        sync = resumed[0]
        sync_summary = device_summary(sync["prof"]["prof"],
                                      sync["prof"]["wall_ms"])
        resume_init_s = [r["init_s"] for r in resumed]
        del snap, resumed
        gc.collect()
    summary = {k: v for k, v in prefetch_summary.items()
               if k not in ("top_kernels",)}
    emit({"phase": "trainer_profile",
          "steps": {"prefetch": TRAINER_STEPS, "sync": TRAINER_RESUME_STEPS},
          "prefetch": prefetch_summary, "sync": sync_summary})
    emit({"phase": "trainer", "config": "vllm_7b_det_config() stage 1",
          "fixtures": len(manifest["files"]), "images": n_images,
          "annotations": n_anns, "batch_size": TRAINER_BATCH,
          "batches_in_pass": len(batches), "batch_shapes": shapes,
          "num_workers": TRAINER_WORKERS, "steps": TRAINER_STEPS,
          "jpeg_decode": decode, "host_native": native,
          "data_ms_a_batch": {"workers_0": data_ms[0],
                              f"workers_{TRAINER_WORKERS}":
                              data_ms[TRAINER_WORKERS]},
          "first_step_vs_plain": first_step, "rel_tol": TRAIN_REL_TOL,
          "launches_per_step": dict(zip([n for n, _ in TRAIN_KERNELS],
                                        counts[0])),
          "launches": launches,
          "losses": [r["loss"] for r in rows], "resume": resume,
          "step_ms_prefetch": intervals, "data_wait_ms_prefetch": waits,
          "step_ms_sync": sync["intervals"],
          "data_wait_ms_sync": sync["waits"],
          "step_ms_median_prefetch": step_ms,
          "step_ms_median_sync": sync["step_ms"],
          "profiled_prefetch": {k: summary[k] for k in (
              "wall_ms", "device_busy_ms", "device_idle_share")},
          "profiled_sync": {k: sync_summary[k] for k in (
              "wall_ms", "device_busy_ms", "device_idle_share")},
          # the profiled step's device time over the median unprofiled
          # step (the profiler's own host cost differs between sessions)
          "idle_share_of_median_step": {
              "prefetch": 1 - summary["device_busy_ms"] / step_ms,
              "sync": 1 - sync_summary["device_busy_ms"] / sync["step_ms"]},
          "checkpoints_kept": ckpts, "save_s": saves, "load_s": load_s,
          "resume_init_s": resume_init_s,
          "model_build_s": build_s,
          "train_s": train_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "phase_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# phase: tooltrain - Trainer.train over the five tool groups of the whole
# 7B flagship
# ---------------------------------------------------------------------------

def tool_launches_per_step(cfg):
    """TRAIN_KERNELS' launches in one step of each tool group: flash
    forward in every CLIP layer of an image batch and every LLaMA layer,
    backward in the LLaMA layers (the trainable [EMB] rows and bridge lie
    upstream of them; the frozen CLIP takes none), MSDA forward and
    backward in every encoder and decoder layer of the group's tool."""
    clip, llm = cfg.vis_encoder.num_layers, cfg.llm.num_layers
    det = cfg.gdino.encoder_layers + cfg.gdino.decoder_layers
    pose = cfg.unipose.encoder_layers + cfg.unipose.decoder_layers
    return {"gdino": (clip + llm, llm, det, det),
            "unipose": (clip + llm, llm, pose, pose),
            "sd": (llm, llm, 0, 0),         # text-only prompts: no CLIP
            "ip2p": (clip + llm, llm, 0, 0),
            "vlm": (clip + llm, llm, 0, 0)}


def write_tool_annotations(manifest, root):
    """The phase's five annotation files over the JPEG fixtures, each
    fixture once: COCO detection (the drawn objects as boxes and
    polygons), COCO keypoints (17 an object, placed in its box, each
    visibility 0, 1 or 2 drawn from KEYPOINT_SEED, the first joint
    visible, an invisible joint at (0, 0)), captions for text-to-image,
    source -> target pairs of consecutive fixtures with an instruction
    for editing, and llava conversations (`llava_rows`, two turns)."""
    det, _, _ = write_trainer_annotations(manifest, root, copies=1)
    rng = np.random.default_rng(KEYPOINT_SEED)
    names = sorted(manifest["files"])
    images, anns, t2i, ip2p = [], [], [], []
    for k, name in enumerate(names):
        entry = manifest["files"][name]
        images.append({"id": k, "file_name": name,
                       "height": entry["shape"][0],
                       "width": entry["shape"][1]})
        cats = [o["category"] for o in entry["objects"]]
        for obj in entry["objects"]:
            x, y, w, h = obj["bbox"]
            v = rng.integers(0, 3, 17)
            v[0] = 2
            xy = np.stack([rng.uniform(x, x + w, 17),
                           rng.uniform(y, y + h, 17)], 1)
            xy[v == 0] = 0.0
            anns.append({"id": len(anns) + 1, "image_id": k,
                         "category_id": 1, "bbox": obj["bbox"],
                         "area": w * h, "iscrowd": 0,
                         "num_keypoints": int((v > 0).sum()),
                         "keypoints": np.concatenate(
                             [xy, v[:, None]], 1).ravel().tolist()})
        t2i.append({"image": name,
                    "caption": "a picture of a " + " and a ".join(cats)})
        nxt = names[(k + 1) % len(names)]
        ip2p.append({"input_image": name, "output_image": nxt,
                     "instruction": f"turn the {cats[0]} into a "
                     f"{manifest['files'][nxt]['objects'][0]['category']}"})
    paths = {"det": det}
    for key, obj in (("pose", {"images": images, "annotations": anns,
                               "categories": [{"id": 1, "name": "person",
                                               "keypoints":
                                               COCO_KEYPOINT_NAMES}]}),
                     ("t2i", t2i), ("ip2p", ip2p),
                     ("chat", llava_rows(manifest, turns=2))):
        paths[key] = os.path.join(root, f"tool_{key}.json")
        with open(paths[key], "w") as f:
            json.dump(obj, f)
    return paths, len(anns)


def tool_dataset_cfgs(cfg, paths):
    """Det and pose at the 640 px bucket (targets padded to
    TRAIN_TARGETS), [GEN] and [EDIT] images at TOOL_GEN_SIZE, chat with
    the CLIP image padded to a square."""
    det_size = {"image_size": cfg.vis_encoder.image_size,
                "img_prefix": JPEG_FIXTURES, "max_gt_per_img": TRAIN_TARGETS,
                "train_scales": [(480, TRAIN_DET)],
                "buckets": ((TRAIN_DET, TRAIN_DET),)}
    gen = {"img_prefix": JPEG_FIXTURES, "output_size": TOOL_GEN_SIZE,
           "num_embs_gen": cfg.num_embs_gen}
    return [{"type": "coco_det", "ann_file": paths["det"], "with_mask": True,
             **det_size},
            {"type": "coco_pose", "ann_file": paths["pose"],
             "num_body_points": cfg.unipose.num_body_points, **det_size},
            {"type": "text2img", "ann_file": paths["t2i"], **gen},
            {"type": "ip2p", "ann_file": paths["ip2p"],
             "image_size": cfg.vis_encoder.image_size, **gen},
            {"type": "llava", "ann_file": paths["chat"],
             "image_folder": JPEG_FIXTURES,
             "image_size": cfg.vis_encoder.image_size,
             "image_aspect_ratio": "pad"}]


def tool_model(cfg):
    """`build_model` (seed 0) with both Swin-T backbones' patch-embedding
    biases drawn (N(0, 0.02), seeds TRAINER_BIAS_SEED and the next): as in
    `trainer_model`, a zero bias makes a bucket's padded patches blow the
    gradient up by 1 / sqrt(eps)."""
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    draw_biases(model)
    return model


def draw_biases(model):
    params = dict(model.named_parameters())
    with torch.no_grad():
        for i, name in enumerate(TOOL_BIASES):
            p = params[name]
            g = torch.Generator(device=p.device).manual_seed(
                TRAINER_BIAS_SEED + i)
            p.copy_(0.02 * torch.randn(p.shape, generator=g,
                                       device=p.device))


def tool_config(out):
    return TrainConfig(output_dir=out, batch_size=TOOL_BATCH,
                       total_steps=TOOL_STEPS, log_every=1,
                       save_every=TOOL_SAVE_EVERY, seed=TOOL_SEED,
                       num_workers=TOOL_WORKERS, num_obj_patches=1,
                       freeze_llm=True,
                       optimizer=OptimizerConfig(total_steps=1000))


def tool_loss(model, group, batch, tid, noise, choices=None):
    if group == "unipose":
        return pose_loss(model, batch, tid, 1, noise, choices)
    if group == "vlm":
        return chat_loss(model, batch, tid)
    return gen_loss(model, batch, tid, noise, edit=group == "ip2p")


def tool_noise(model, group, batch, g):
    if group == "unipose":
        return draw_pose_noise(g, model.cfg.unipose, batch["targets"])
    if group == "vlm":
        return {}
    return draw_gen_noise(g, model, batch, edit=group == "ip2p")


def tool_loss_and_norm(model, group, batch, tid, noise, trainable,
                       choices=None):
    """One step's metrics and trainable gradient norm (no update), and the
    discrete choices it made or repeated."""
    for p in trainable.values():
        p.grad = None
    loss, metrics, choices = tool_loss(model, group, batch, tid, noise,
                                       choices)
    loss.backward()
    sq = sum(p.grad.float().square().sum() for p in trainable.values()
             if p.grad is not None)
    for p in trainable.values():
        p.grad = None
    return ({k: v.item() for k, v in metrics.items()}, math.sqrt(sq.item()),
            choices)


def tool_first_steps(model, trainer, concat, batches, tid):
    """Check (a): for the first batch of each new group, the metrics and
    trainable gradient norm of one step with the kernels against the
    plain versions, on the same weights, batch, draws and discrete choices
    (the top-k proposals and groups, the matchings), within
    TRAIN_REL_TOL."""
    trainable = split_frozen(model, trainer.frozen)
    out = {}
    for group in ("unipose", "sd", "ip2p", "vlm"):
        p = next(i for i, b in enumerate(batches)
                 if group_of_task(concat.task_of(b[0])) == group)
        workers, trainer.tc.num_workers = trainer.tc.num_workers, 0
        it = iter(trainer.loader(concat, batches, p))
        _, host = next(it)
        it.close()
        trainer.tc.num_workers = workers
        batch = to_device(host, trainer.device, trainer.dtype)
        noise = tool_noise(model, group, batch, torch.Generator(
            device=trainer.device).manual_seed(2))
        mk, nk, choices = tool_loss_and_norm(model, group, batch, tid, noise,
                                             trainable)
        with plain_versions():
            mp, np_, _ = tool_loss_and_norm(model, group, batch, tid, noise,
                                            trainable, choices)
        errs = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in mp}
        errs["grad_norm"] = abs(nk - np_) / np_
        out[group] = {"kernel": dict(mk, grad_norm=nk),
                      "plain": dict(mp, grad_norm=np_), "rel_err": errs,
                      "max_rel_err": max(errs.values())}
        if not (all(math.isfinite(v) for v in (*mk.values(), nk))
                and max(errs.values()) <= TRAIN_REL_TOL):
            raise AssertionError(f"tooltrain {group} kernel vs plain: {errs}"
                                 f" (tol {TRAIN_REL_TOL})")
        del batch, noise, choices
    return out


def tensor_digest(t):
    """A 64-bit digest of a tensor's bits (a position-weighted sum of its
    16- or 32-bit words, wrapping in int64): equal tensors give equal
    digests, and a change of any word changes it but by a chance of about
    2^-63."""
    x = t.detach().contiguous().view(-1)
    x = x.view(torch.int16 if x.element_size() == 2 else torch.int32).long()
    w = (torch.arange(1, x.numel() + 1, device=x.device) * 2654435761
         % 4294967291)
    return int((x * w).sum())


def tool_instrument(trainer, rec, profiled=False, prefix="tooltrain"):
    """Wrap the Trainer's step: launches of TRAIN_KERNELS and peak memory
    per step with its group; with `profiled`, each step in a synced
    `record_function` range "<prefix>:<step>:<group>", TOOL_GAP_S apart
    from the loop's other work."""
    step_fn_for = trainer.step_fn_for

    def wrapped_for(group):
        fn = step_fn_for(group)

        def step(state, batch, **kw):
            k = state.step + 1
            c0 = train_counts()
            torch.cuda.reset_peak_memory_stats()
            if profiled:
                torch.cuda.synchronize()
                time.sleep(TOOL_GAP_S)
                with record_function(f"{prefix}:{k}:{group}"):
                    t = time.perf_counter()
                    out = fn(state, batch, **kw)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t) * 1e3
                time.sleep(TOOL_GAP_S)
            else:
                out = fn(state, batch, **kw)
                wall = None
            torch.cuda.synchronize()
            rec.append({"step": k, "group": group, "wall_ms": wall,
                        "launches": tuple(b - a for a, b in
                                          zip(c0, train_counts())),
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
            return out
        return step

    trainer.step_fn_for = wrapped_for


def range_summaries(prof, walls, slack_ms):
    """`kernel_summary` of the kernels that start in each
    `record_function` range of `walls` (label -> its synced wall ms, the
    summary's wall), within `slack_ms` of its ends; two passes over the
    raw kineto events."""
    events = list(prof.profiler.kineto_results.events())
    ranges = {}
    for e in events:
        if e.name() in walls and e.device_type() == DeviceType.CPU:
            ranges.setdefault(e.name(), []).append(
                (e.start_ns() - slack_ms * 1e6,
                 e.start_ns() + e.duration_ns() + slack_ms * 1e6))
    if sorted(ranges) != sorted(walls) or any(len(r) != 1
                                              for r in ranges.values()):
        raise AssertionError(f"profile ranges {ranges} for {sorted(walls)}")
    by_label = {label: {} for label in walls}
    for e in events:
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            t = e.start_ns()
            for label, ((lo, hi),) in ranges.items():
                if lo <= t <= hi:
                    kernel_total(by_label[label], e)
                    break
    return {label: kernel_summary(by_label[label], wall)
            for label, wall in walls.items()}


def state_sketch(state):
    """A linear sketch of the fp32 masters and of each moment (each part's
    tensors as one vector): every value goes, times a random sign, into
    one of SKETCH_BUCKETS fp64 buckets (both drawn per tensor from a
    fixed seed), on the card, kept on the host. The distance of two
    sketches is the two states' L2 distance within about
    sqrt(2 / SKETCH_BUCKETS) relative (a CountSketch), without a host
    copy of the 12.7 GB states."""
    out = {}
    for part in ("masters", "mu", "nu"):
        tensors = getattr(state, part)
        acc = None
        for i, n in enumerate(sorted(tensors)):
            x = tensors[n].detach().reshape(-1).double()
            if acc is None:
                acc = torch.zeros(SKETCH_BUCKETS, dtype=torch.float64,
                                  device=x.device)
            g = torch.Generator(device=x.device).manual_seed(i)
            idx = torch.randint(0, SKETCH_BUCKETS, x.shape, generator=g,
                                device=x.device)
            sign = torch.randint(0, 2, x.shape, generator=g,
                                 device=x.device) * 2 - 1
            acc.index_add_(0, idx, x * sign)
        out[part] = acc.cpu()
    return out


def sketch_rel_err(a, b):
    """`state_rel_err` of two `state_sketch`es: |a - b| / |b| a part."""
    return {part: float((a[part] - b[part]).norm() / b[part].norm())
            for part in a}


def tool_resume(cfg, tid, tok, ds_cfgs, model, ckpt_dir, ck, out,
                profiled):
    """A fresh Trainer on `model` in `out`, resumed from the checkpoint
    directory `ckpt_dir` (with `ck`, its live state held to it by
    `check_restored`; the model's trainable parameters take the restored
    masters, its frozen ones are unchanged) and trained to TOOL_STEPS, its
    save skipped. Returns its metrics rows, the instrumented steps, the
    sketch of its final state (`state_sketch`), the restore seconds, its
    step intervals and, with `profiled`, the profile of its steps."""
    trainer = Trainer(cfg, tool_config(out), tid)
    trainer.model = model
    trainer.ckpt_dir = ckpt_dir
    rec, init_s = [], []
    tool_instrument(trainer, rec, profiled)
    trainer.save = lambda state: None
    init_state = trainer.init_state

    def timed_init():
        t0 = time.perf_counter()
        state = init_state()
        init_s.append(time.perf_counter() - t0)
        if ck is not None:
            check_restored(trainer, state, ck)
        return state
    trainer.init_state = timed_init
    prof = None
    if profiled:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    state = trainer.train(ds_cfgs, tok)
    if prof is not None:
        prof.stop()
    if state.step != TOOL_STEPS:
        raise AssertionError(f"resumed trainer stopped at {state.step}")
    run = {"rows": read_metrics(out), "rec": rec,
           "sketch": state_sketch(state), "init_s": init_s[0],
           "intervals": tool_intervals(trainer), "prof": prof}
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return run


def tool_intervals(trainer, minus=None):
    """(group, ms) of each step after a run's first: from the end of the
    step before to its own end (the wait for its batch, moving it, the
    step), less `minus[k]` seconds (a save that fell in step k's
    interval)."""
    h, minus = trainer.history, minus or {}
    return [(b["group"], (b["t_end"] - a["t_end"]) * 1e3
             - 1e3 * minus.get(b["position"] + 1, 0.0))
            for a, b in zip(h, h[1:])]


def tool_resume_gate(rows, sketch, runs):
    """Check (b)'s gate: each resumed run's step TOOL_SAVE_EVERY + 1 loss
    terms bit for bit, then its distance from the straight run (`gap`)
    against the largest distance between two resumed runs (`spread`), in
    the
    metrics of steps TOOL_SAVE_EVERY + 1 to TOOL_STEPS (relative to the
    straight run's) within RESUME_SPREAD_K_LOSS and in the final masters
    and moments (`sketch_rel_err` of the `state_sketch`es) within
    RESUME_SPREAD_K_STATE, as the trainer phase's check 6."""
    at = TOOL_SAVE_EVERY
    keys = [(s, k) for s in range(at, TOOL_STEPS) for k in rows[s]
            if k not in ("time", "step")]
    want = np.array([rows[s][k] for s, k in keys])
    got = [np.array([r["rows"][s - at][k] for s, k in keys]) for r in runs]
    for i, r in enumerate(runs):
        terms = {k: v for k, v in r["rows"][0].items()
                 if k not in ("time", "grad_norm")}
        want_terms = {k: v for k, v in rows[at].items()
                      if k not in ("time", "grad_norm")}
        if terms != want_terms:
            raise AssertionError(f"resumed run {i}: step {at + 1} {terms} "
                                 f"against {want_terms}")

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(want),
                                                       1e-30)))
    pairs = list(itertools.combinations(range(len(runs)), 2))
    out = {"metric": {"gap": max(rel(g, want) for g in got),
                      "spread": max(rel(got[j], got[i]) for i, j in pairs),
                      "k": RESUME_SPREAD_K_LOSS},
           "k_state": RESUME_SPREAD_K_STATE,
           "losses": [[row["loss"] for row in r["rows"]] for r in runs],
           "state": {}}
    gaps = [sketch_rel_err(r["sketch"], sketch) for r in runs]
    spreads = [sketch_rel_err(runs[j]["sketch"], runs[i]["sketch"])
               for i, j in pairs]
    for part in ("masters", "mu", "nu"):
        out["state"][part] = {"gap": max(g[part] for g in gaps),
                              "spread": max(d[part] for d in spreads)}
    if (out["metric"]["gap"] > RESUME_SPREAD_K_LOSS * out["metric"]["spread"]
            or any(v["gap"] > RESUME_SPREAD_K_STATE * v["spread"]
                   for v in out["state"].values())):
        raise AssertionError(f"resumed runs drift from the straight run "
                             f"beyond their own spread: {out}")
    return out


def tool_eval_pose(model, tid, tok, paths, cfg):
    """Check (d): `evaluate_pose` of the trained model on the pose
    fixtures in test mode (the 800 px test scale) at batch size 8 and 1:
    the metrics equal within 1e-6, every image evaluated; and the gt fed
    back as detections scores OKS mAP 1.0. Each image's sorted scores of
    the two runs are compared and reported, not held: a B1 forward rounds
    otherwise than a B8 one, and random weights leave near-ties in the
    top-k proposals and groups that the two runs may break apart."""
    ds = CocoPoseDataset(paths["pose"], JPEG_FIXTURES, tok,
                         image_token_len=cfg.image_token_len, test_mode=True,
                         image_size=cfg.vis_encoder.image_size,
                         num_body_points=cfg.unipose.num_body_points)
    seen = {}
    update = OksMAPEvaluator.update
    res, wall = {}, {}
    for bs in (8, 1):
        seen[bs] = []

        def rec(self, det, gt, _bs=bs):
            seen[_bs].append(det)
            return update(self, det, gt)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with mock.patch.object(OksMAPEvaluator, "update", rec):
            res[bs] = evaluate_pose(model, ds, tid, topk=TOOL_EVAL_TOPK,
                                    batch_size=bs)
        wall[bs] = time.perf_counter() - t
    # scores are probabilities: their largest absolute difference
    errs = [float(np.abs(np.sort(a["scores"]) - np.sort(b["scores"])).max())
            for a, b in zip(seen[8], seen[1])]
    metric_diff = max(abs(res[8][k] - res[1][k]) for k in res[8]
                      if not (math.isnan(res[8][k])
                              and math.isnan(res[1][k])))
    ev = OksMAPEvaluator(num_keypoints=len(ds.kpt_names))
    for i in range(len(ds)):
        kpts, _ = ds._keypoints(i)
        ev.update({"scores": np.ones(len(kpts)), "keypoints": kpts},
                  {"keypoints": kpts})
    gt_map = ev.summarize()
    if (len(seen[8]) != len(seen[1]) != len(ds) or metric_diff > 1e-6
            or gt_map["AP"] != 1.0):
        raise AssertionError(f"evaluate_pose: B8 {res[8]}, B1 {res[1]}, "
                             f"score errs {errs}, gt as dets {gt_map}")
    return {"images": len(ds), "b8": res[8], "b1": res[1],
            "b1_vs_b8_sorted_score_max_abs_diff": max(errs),
            "gt_as_detections": gt_map,
            "wall_s": wall}


def run_tooltrain():
    """The `tooltrain` phase: `Trainer.train` of the whole 7B flagship over
    the det, pose, [GEN] and [EDIT] groups from the JPEG fixtures; returns
    the main run's launches."""
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    manifest = fixture_manifest()
    cfg = vllm_7b_config()
    tid = SpecialTokenIds.synthetic()
    tok = HashedWordTokenizer()
    per_step = tool_launches_per_step(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        paths, n_people = write_tool_annotations(manifest, tmp)
        ds_cfgs = tool_dataset_cfgs(cfg, paths)
        t = time.perf_counter()
        model = tool_model(cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        n_params = sum(p.numel() for p in model.parameters())
        main_dir = os.path.join(tmp, "main")
        main = Trainer(cfg, tool_config(main_dir), tid)
        main.model = model
        concat = build_multi_datasets(
            [{"image_token_len": cfg.image_token_len, **c} for c in ds_cfgs],
            tok)
        batches = list(TaskGroupedBatchSampler(concat, TOOL_BATCH,
                                               seed=TOOL_SEED))
        order = [group_of_task(concat.task_of(b[0])) for b in batches]
        half = TOOL_SAVE_EVERY
        if not (sorted(order[:half]) == sorted(order[half:TOOL_STEPS])
                == sorted(TOOL_GROUPS)):
            raise AssertionError(f"the sampler's first {TOOL_STEPS} batches "
                                 f"are {order[:TOOL_STEPS]}")
        sections = {"setup": time.perf_counter() - t_phase}
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        first = tool_first_steps(model, main, concat, batches, tid)
        sections["first_steps"] = time.perf_counter() - t
        peaks = {"first_steps": torch.cuda.max_memory_allocated() / 1e9}
        frozen = [n for n, _ in model.named_parameters() if main.frozen(n)]
        params = dict(model.named_parameters())
        frozen_digest = {n: tensor_digest(params[n]) for n in frozen}
        trained_digest = {n: tensor_digest(p.float())
                          for n, p in params.items() if not main.frozen(n)}
        n_trainable = sum(params[n].numel() for n in trained_digest)

        # the main path: TOOL_STEPS steps, a checkpoint at TOOL_SAVE_EVERY
        rec, saves = [], []
        tool_instrument(main, rec)
        save = main.save

        def save_once(state):
            # the resumed runs need the step-4 checkpoint only
            if state.step == TOOL_SAVE_EVERY:
                t0 = time.perf_counter()
                save(state)
                saves.append(time.perf_counter() - t0)
        main.save = save_once
        for _, fn in TRAIN_KERNELS:
            fn.launches = 0
        t = time.perf_counter()
        state = main.train(ds_cfgs, tok)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in TRAIN_KERNELS}
        rows = read_metrics(main_dir)
        groups = [r["group"] for r in rec]
        if (state.step != TOOL_STEPS or len(rows) != TOOL_STEPS
                or groups != order[:TOOL_STEPS]):
            raise AssertionError(f"tooltrain ran {state.step} steps, "
                                 f"logged {len(rows)}, groups {groups}")
        if not all(math.isfinite(v) for r in rows for v in r.values()):
            raise AssertionError(f"non-finite tooltrain metrics {rows}")
        bad = [(r["group"], r["launches"]) for r in rec
               if r["launches"] != per_step[r["group"]]]
        if bad:
            raise AssertionError(f"tooltrain launches per step {bad}, want "
                                 f"{per_step}")
        t = time.perf_counter()
        sketch = state_sketch(state)
        sections["sketch"] = time.perf_counter() - t
        peaks["main"] = max(r["peak_gb"] for r in rec)
        moved = sum(tensor_digest(w) != trained_digest[n]
                    for n, w in state.masters.items())
        intervals = tool_intervals(main, {TOOL_SAVE_EVERY + 1: saves[0]})
        ckpt_file = os.path.join(main.ckpt_dir, str(TOOL_SAVE_EVERY),
                                 "state.pt")
        ckpt_bytes = os.path.getsize(ckpt_file)
        del state, main
        gc.collect()
        torch.cuda.empty_cache()

        # fresh Trainers on the same model resume from the step-4
        # checkpoint to TOOL_STEPS; the first profiles its steps
        ckpt_root = os.path.join(main_dir, "checkpoints")
        t = time.perf_counter()
        ck = restore_checkpoint(ckpt_root, TOOL_SAVE_EVERY)
        load_s = time.perf_counter() - t
        # the first resumed run holds its restored state to the checkpoint
        # bit for bit (the restore is the same code for each)
        t = time.perf_counter()
        resumed = [tool_resume(cfg, tid, tok, ds_cfgs, model, ckpt_root,
                               ck if i == 0 else None,
                               os.path.join(tmp, f"resume{i}"),
                               profiled=i == 0)
                   for i in range(TOOL_REPEATS)]
        sections["resumed_runs"] = time.perf_counter() - t
        del ck
        resume = tool_resume_gate(rows, sketch, resumed)
        bad = [(r["group"], r["launches"]) for run in resumed
               for r in run["rec"] if r["launches"] != per_step[r["group"]]]
        if bad:
            raise AssertionError(f"resumed launches per step {bad}")
        prof = resumed[0]["prof"]
        t = time.perf_counter()
        labels = {f"tooltrain:{r['step']}:{r['group']}": r
                  for r in resumed[0]["rec"]}
        summaries = range_summaries(
            prof, {k: r["wall_ms"] for k, r in labels.items()},
            TOOL_GAP_S * 1e3 / 2)
        profiled = {r["group"]: summaries[k] for k, r in labels.items()}
        sections["profile_read"] = time.perf_counter() - t
        resume_init_s = [r["init_s"] for r in resumed]
        all_intervals = intervals + [iv for r in resumed[1:]
                                     for iv in r["intervals"]]
        peaks["resumed"] = max(r["peak_gb"] for run in resumed
                               for r in run["rec"])
        del resumed, prof
        gc.collect()

        # check (c): frozen parameters bit-identical after every run
        params = dict(model.named_parameters())
        changed = [n for n in frozen
                   if tensor_digest(params[n]) != frozen_digest[n]]
        if changed or moved < 0.9 * len(trained_digest):
            raise AssertionError(f"frozen parameters changed {changed[:5]}; "
                                 f"{moved} of {len(trained_digest)} "
                                 "trainable masters moved")
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        evaluation = tool_eval_pose(model, tid, tok, paths, cfg)
        sections["evaluate_pose"] = time.perf_counter() - t
        peaks["evaluate_pose"] = torch.cuda.max_memory_allocated() / 1e9
        del model
        gc.collect()
        torch.cuda.empty_cache()

    by_group = {}
    for g in TOOL_GROUPS:
        steps = [r for r in rec if r["group"] == g]
        iv = [ms for gg, ms in all_intervals if gg == g]
        prof_g = profiled.get(g)
        by_group[g] = {
            "launches_per_step": dict(zip([n for n, _ in TRAIN_KERNELS],
                                          per_step[g])),
            "steps": [r["step"] for r in steps],
            "step_interval_ms": iv,
            "step_interval_ms_median": statistics.median(iv) if iv else None,
            "peak_gb": max(r["peak_gb"] for r in steps),
            "profiled_step": prof_g}
    emit({"phase": "tooltrain_profile",
          "steps": {g: p["wall_ms"] for g, p in profiled.items()},
          **{g: p for g, p in profiled.items()}})
    emit({"phase": "tooltrain", "config": "vllm_7b_config() stage 1",
          "params": n_params, "trainable": n_trainable,
          "trainable_tensors": len(trained_digest),
          "frozen_tensors": len(frozen), "moved_masters": moved,
          "fixtures": len(manifest["files"]), "pose_instances": n_people,
          "batch_size": TOOL_BATCH, "num_workers": TOOL_WORKERS,
          "steps": TOOL_STEPS, "groups_in_order": order[:TOOL_STEPS],
          "first_step_vs_plain": first, "rel_tol": TRAIN_REL_TOL,
          "by_group": by_group, "launches": launches,
          "losses": [r["loss"] for r in rows], "metrics": rows,
          "resume": resume,
          "checkpoint_bytes": ckpt_bytes, "save_s": saves, "load_s": load_s,
          "resume_init_s": resume_init_s, "evaluate_pose": evaluation,
          "model_build_s": build_s, "train_s": train_s,
          "sections_s": sections,
          "peak_mem_gb": peaks, "phase_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# phase: loratrain - LLaMA-7B's LoRA adapters at L2048 through Trainer.train
# ---------------------------------------------------------------------------

def llava_rows(manifest, turns, answer_words=8, copies=1, seed=CHAT_SEED):
    """llava conversations over the JPEG fixtures, each fixture listed
    `copies` times: `turns` question / answer pairs, the first question
    with the <image>, each answer `answer_words` words drawn from
    CHAT_WORDS (numpy seed `seed`)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(copies):
        for name in sorted(manifest["files"]):
            cats = [o["category"] for o in manifest["files"][name]["objects"]]
            conv = []
            for t in range(turns):
                q = (f"what does part {t} of the picture show about the "
                     f"{cats[t % len(cats)]}?")
                conv += [{"from": "human",
                          "value": ("<image>\n" if t == 0 else "") + q},
                         {"from": "gpt", "value": " ".join(
                             rng.choice(CHAT_WORDS, answer_words))}]
            rows.append({"image": name, "conversations": conv})
    return rows


def lora_config():
    """`vllm_7b_chat_config` with LoRA r 32, alpha 64 on LLaMA-7B."""
    return vllm_7b_chat_config(llm=LLMConfig(vocab_size=32096, lora_r=LORA_R,
                                             lora_alpha=LORA_ALPHA))


def lora_train_config(out):
    return TrainConfig(output_dir=out, batch_size=LORA_BATCH,
                       total_steps=LORA_MICRO_STEPS, log_every=1,
                       save_every=LORA_SAVE_AT, seed=LORA_SEED,
                       num_workers=LORA_WORKERS, freeze_llm=True,
                       freeze_vis_encoder=True,
                       optimizer=OptimizerConfig(
                           learning_rate=LORA_LR, total_steps=1000,
                           grad_accum_steps=LORA_ACCUM))


def set_llm_remat(model, mode):
    """Switch the built LLM's rematerialization (its forward reads it)."""
    llm = model.core.llm
    llm.cfg = dataclasses.replace(llm.cfg, remat=mode)


def lora_launches_per_step(cfg, remat):
    """(flash fwd, flash bwd) of one chat step: CLIP and LLaMA forward,
    the LLaMA layers again in the backward under remat, the LLaMA
    backward."""
    llm = cfg.llm.num_layers
    return (cfg.vis_encoder.num_layers + llm * (2 if remat else 1), llm)


def chat_loss_and_grads(model, batch, tid, trainable):
    """One chat step's loss and the trainable gradients in fp32 (no
    update)."""
    for p in trainable.values():
        p.grad = None
    loss, _, _ = chat_loss(model, batch, tid)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None
                 else torch.zeros_like(p)).float()
             for n, p in trainable.items()}
    for p in trainable.values():
        p.grad = None
    return loss.detach(), grads


def grads_norm(grads):
    return math.sqrt(sum(g.double().square().sum().item()
                         for g in grads.values()))


def lora_remat_modes(model, cfg, batch, tid, trainable):
    """Check (b): the batch's chat step under remat "", "full" and "dots"
    on the one model: the loss bit for bit across the modes, every
    trainable gradient within LORA_GRAD_REL_TOL (relative L2 a tensor) of
    the no-remat run (bitwise equality reported), the flash launches of
    `lora_launches_per_step`; each mode's peak memory and device ms (its
    step in a synced range of one profiler context)."""
    out, losses, grads = {}, {}, {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        walls = {}
        for mode in ("", "full", "dots"):
            set_llm_remat(model, mode)
            label = f"loratrain:remat:{mode or 'none'}"
            A.flash_attention.launches = 0
            A.flash_attention_bwd.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            time.sleep(TOOL_GAP_S)
            with record_function(label):
                t = time.perf_counter()
                losses[mode], grads[mode] = chat_loss_and_grads(
                    model, batch, tid, trainable)
                torch.cuda.synchronize()
                walls[label] = (time.perf_counter() - t) * 1e3
            time.sleep(TOOL_GAP_S)
            launches = (A.flash_attention.launches,
                        A.flash_attention_bwd.launches)
            if launches != lora_launches_per_step(cfg, mode):
                raise AssertionError(
                    f"loratrain remat {mode!r}: flash launches {launches}, "
                    f"want {lora_launches_per_step(cfg, mode)}")
            out[mode or "none"] = {
                "loss": losses[mode].item(), "wall_ms": walls[label],
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "flash_fwd": launches[0], "flash_bwd": launches[1]}
    summaries = range_summaries(prof, walls, TOOL_GAP_S * 1e3 / 2)
    for mode in ("", "full", "dots"):
        key = mode or "none"
        summ = summaries[f"loratrain:remat:{key}"]
        out[key]["device_ms"] = summ["device_busy_ms"]
        out[key]["device_idle_share"] = summ["device_idle_share"]
        if mode:
            rel = {n: rel_err(g, grads[""][n]) if grads[""][n].any()
                   else float(g.abs().max())
                   for n, g in grads[mode].items()}
            out[key]["grad_rel_err_max"] = max(rel.values())
            out[key]["grads_bitwise"] = all(
                torch.equal(g, grads[""][n]) for n, g in grads[mode].items())
            out[key]["loss_bitwise"] = torch.equal(losses[mode], losses[""])
            if not (out[key]["loss_bitwise"]
                    and out[key]["grad_rel_err_max"] <= LORA_GRAD_REL_TOL):
                raise AssertionError(f"loratrain remat {mode!r} against "
                                     f"none: {out[key]}")
    del grads, prof
    return out


def lora_watch(trainer, rec):
    """Wrap the (instrumented) step: copies of each micro-step's masters
    and trainable parameters before it, compared after it on the card
    (one sync), so check (c) can hold the ones that apply no update to
    bit-identical."""
    step_fn_for = trainer.step_fn_for

    def changed(now, before):
        return bool(torch.stack([(a != b).any()
                                 for a, b in zip(now, before)]).any())

    def wrapped_for(group):
        fn = step_fn_for(group)

        def step(state, batch, **kw):
            params = dict(trainer.model.named_parameters())
            names = list(state.masters)
            masters = [state.masters[n].clone() for n in names]
            weights = [params[n].detach().clone() for n in names]
            out = fn(state, batch, **kw)
            rec.append({"step": state.step,
                        "gradient_step": state.gradient_step,
                        "masters_same": not changed(
                            [state.masters[n] for n in names], masters),
                        "params_same": not changed(
                            [params[n].detach() for n in names], weights)})
            return out
        return step

    trainer.step_fn_for = wrapped_for


def run_loratrain():
    """The `loratrain` phase, with nothing else resident: LLaMA-7B's LoRA
    adapters (and the bridge) trained through `Trainer.train` at L 2048;
    returns the main run's flash launches."""
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    manifest = fixture_manifest()
    cfg = lora_config()
    tid = SpecialTokenIds.synthetic()
    tok = HashedWordTokenizer()
    sections = {}
    with tempfile.TemporaryDirectory() as tmp:
        ann = os.path.join(tmp, "lora_chat.json")
        with open(ann, "w") as f:
            json.dump(llava_rows(manifest, LORA_TURNS, LORA_ANSWER_WORDS,
                                 copies=LORA_COPIES), f)
        ds_cfgs = [{"type": "llava", "ann_file": ann,
                    "image_folder": JPEG_FIXTURES,
                    "image_size": cfg.vis_encoder.image_size,
                    "image_aspect_ratio": "pad"}]
        t = time.perf_counter()
        model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        weights_gb = torch.cuda.memory_allocated() / 1e9
        n_params = sum(p.numel() for p in model.parameters())
        main_dir = os.path.join(tmp, "main")
        main = Trainer(cfg, lora_train_config(main_dir), tid)
        main.model = model
        concat = build_multi_datasets(
            [{"image_token_len": cfg.image_token_len, **c} for c in ds_cfgs],
            tok)
        batches = list(TaskGroupedBatchSampler(concat, LORA_BATCH,
                                               seed=LORA_SEED))
        workers, main.tc.num_workers = main.tc.num_workers, 0
        it = iter(main.loader(concat, batches, 0))
        _, host = next(it)
        it.close()
        main.tc.num_workers = workers
        batch = to_device(host, "cuda", torch.bfloat16)
        lengths = [len(concat[i]["input_ids"]) for i in range(len(concat))]
        if tuple(batch["input_ids"].shape) != (LORA_BATCH, LORA_SEQ):
            raise AssertionError(f"loratrain batch {batch['input_ids'].shape}"
                                 f", sample lengths {sorted(set(lengths))}")
        trainable = split_frozen(model, main.frozen)
        n_lora = sum(p.numel() for n, p in trainable.items()
                     if "lora_" in n)
        n_train = sum(p.numel() for p in trainable.values())
        # stage 2's freezing: the LoRA factors, the bridge and the [EMB]
        # embeddings train (no chat batch reads the latter)
        kinds = {k: sum(1 for n in trainable if k in n)
                 for k in ("lora_", "core.vl_bridge.",
                           "core.emb_embeddings")}
        if sum(kinds.values()) != len(trainable):
            raise AssertionError(f"loratrain trains {sorted(trainable)}")
        sections["setup"] = time.perf_counter() - t_phase

        # check (a): the first batch's step with the kernels and with the
        # plain versions, under "full" (the plain attention's fp32 scores
        # of 32 layers would not fit without remat); the first step also
        # warms the card up for (b)'s timings
        t = time.perf_counter()
        set_llm_remat(model, "full")
        loss_k, grads_k = chat_loss_and_grads(model, batch, tid, trainable)
        with plain_versions():
            loss_p, grads_p = chat_loss_and_grads(model, batch, tid,
                                                  trainable)
        norm_k, norm_p = grads_norm(grads_k), grads_norm(grads_p)
        first = {"kernel": {"loss": loss_k.item(), "grad_norm": norm_k},
                 "plain": {"loss": loss_p.item(), "grad_norm": norm_p}}
        first["rel_err"] = {
            "loss": abs(first["kernel"]["loss"] - first["plain"]["loss"])
            / abs(first["plain"]["loss"]),
            "grad_norm": abs(norm_k - norm_p) / norm_p}
        if not (math.isfinite(norm_k)
                and max(first["rel_err"].values()) <= TRAIN_REL_TOL):
            raise AssertionError(f"loratrain kernel vs plain: {first} "
                                 f"(tol {TRAIN_REL_TOL})")
        del grads_k, grads_p
        sections["first_step_plain"] = time.perf_counter() - t

        # check (b): the batch under each remat mode
        t = time.perf_counter()
        remat = lora_remat_modes(model, cfg, batch, tid, trainable)
        sections["remat_modes"] = time.perf_counter() - t

        # check (c), the main path: LORA_MICRO_STEPS micro-steps at k =
        # LORA_ACCUM under remat "full", one save at micro-step
        # LORA_SAVE_AT, then a fresh Trainer resumes from it
        set_llm_remat(model, "full")
        rec, watch, saves = [], [], []
        tool_instrument(main, rec, prefix="loratrain")
        lora_watch(main, watch)
        save = main.save

        def save_once(state):
            if state.step == LORA_SAVE_AT:
                t0 = time.perf_counter()
                save(state)
                saves.append(time.perf_counter() - t0)
        main.save = save_once
        for _, fn in TRAIN_KERNELS:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        state = main.train(ds_cfgs, tok)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in TRAIN_KERNELS[:2]}
        peak_main = torch.cuda.max_memory_allocated() / 1e9
        rows = read_metrics(main_dir)
        per_step = lora_launches_per_step(cfg, "full")
        bad = [r for r in rec if r["launches"] != (*per_step, 0, 0)]
        odd = [w for w in watch if w["step"] % LORA_ACCUM]
        if (state.step != LORA_MICRO_STEPS or len(rows) != LORA_MICRO_STEPS
                or state.gradient_step != LORA_MICRO_STEPS // LORA_ACCUM
                or bad or not all(math.isfinite(v) for r in rows
                                  for v in r.values())
                or not all(w["masters_same"] and w["params_same"]
                           for w in odd)
                or any(w["masters_same"] for w in watch
                       if not w["step"] % LORA_ACCUM)):
            raise AssertionError(f"loratrain main run: {state.step} "
                                 f"micro-steps, {state.gradient_step} "
                                 f"applied, launches {bad[:2]}, watch "
                                 f"{watch}, rows {rows}")
        intervals = tool_intervals(main, {LORA_SAVE_AT + 1: saves[0]})
        final = {part: {n: t.clone() for n, t in getattr(state, part).items()}
                 for part in ("masters", "mu", "nu")}
        del state
        t = time.perf_counter()
        ck = restore_checkpoint(os.path.join(main_dir, "checkpoints"),
                                LORA_SAVE_AT)
        load_s = time.perf_counter() - t
        ckpt_bytes = os.path.getsize(os.path.join(
            main_dir, "checkpoints", str(LORA_SAVE_AT), "state.pt"))
        if (ck["mini_step"], ck["gradient_step"]) != (
                LORA_SAVE_AT % LORA_ACCUM, LORA_SAVE_AT // LORA_ACCUM):
            raise AssertionError(f"loratrain checkpoint at micro-step "
                                 f"{ck['step']}: mini_step "
                                 f"{ck['mini_step']}, gradient_step "
                                 f"{ck['gradient_step']}")

        # the resumed run, its steps profiled
        resumed = Trainer(cfg, lora_train_config(os.path.join(tmp, "res")),
                          tid)
        resumed.model = model
        resumed.ckpt_dir = main.ckpt_dir
        resumed.save = lambda state: None
        rrec = []
        tool_instrument(resumed, rrec, profiled=True, prefix="loratrain")
        init_state = resumed.init_state

        def checked_init():
            st = init_state()
            check_restored(resumed, st, ck)
            return st
        resumed.init_state = checked_init
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            rstate = resumed.train(ds_cfgs, tok)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t
        del ck
        rrows = read_metrics(os.path.join(tmp, "res"))
        labels = {f"loratrain:{r['step']}:{r['group']}": r for r in rrec}
        summaries = range_summaries(
            prof, {k: r["wall_ms"] for k, r in labels.items()},
            TOOL_GAP_S * 1e3 / 2)
        del prof
        resume_err = state_rel_err(
            {part: getattr(rstate, part) for part in final}, final)
        resume_bitwise = all(torch.equal(getattr(rstate, part)[n], t)
                             for part in final
                             for n, t in final[part].items())
        metric_err = max(
            abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
            for a, b in zip(rrows, rows[LORA_SAVE_AT:]) for k in b
            if k not in ("time", "step"))
        if (rstate.step != LORA_MICRO_STEPS
                or rstate.gradient_step != LORA_MICRO_STEPS // LORA_ACCUM
                or max(resume_err.values()) > LORA_RESUME_REL_TOL
                or metric_err > LORA_RESUME_REL_TOL):
            raise AssertionError(f"loratrain resume: {rstate.step} micro-"
                                 f"steps, state err {resume_err}, metric "
                                 f"err {metric_err}")
        del final, rstate
        sections["train_and_resume"] = time.perf_counter() - t_phase - sum(
            sections.values())

        # check (d): the adapters merged into a lora_r=0 model
        t = time.perf_counter()
        set_llm_remat(model, "")
        state_dict = model.state_dict()
        cfg0 = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                                lora_r=0))
        merged = _meta_model(cfg0, torch.bfloat16)
        merged.load_state_dict(merge_lora_params(state_dict,
                                                 cfg.llm.lora_alpha),
                               assign=True)
        base = _meta_model(cfg0, torch.bfloat16)
        base.load_state_dict({n: v for n, v in state_dict.items()
                              if "lora_" not in n}, assign=True)
        with torch.no_grad():
            lora_logits = model.forward_chat(batch, tid)["logits"]
            merged_logits = merged.eval().forward_chat(batch, tid)["logits"]
            merged_err = rel_err(merged_logits, lora_logits)
            del merged_logits
            base_err = rel_err(base.eval().forward_chat(batch, tid)["logits"],
                               lora_logits)
        del merged, base, state_dict, lora_logits
        if not merged_err <= TRAIN_REL_TOL:
            raise AssertionError(f"merged LoRA logits {merged_err} from the "
                                 f"LoRA model's (tol {TRAIN_REL_TOL})")
        sections["merge"] = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 1e9
        del model, main, resumed, batch
        gc.collect()
        torch.cuda.empty_cache()

    # the main run's step intervals (the resumed run's steps are profiled
    # and spaced by TOOL_GAP_S)
    all_iv = [ms for _, ms in intervals]
    prof_steps = {k: {"wall_ms": v["wall_ms"],
                      "device_busy_ms": v["device_busy_ms"],
                      "device_idle_share": v["device_idle_share"]}
                  for k, v in summaries.items()}
    emit({"phase": "loratrain",
          "config": "vllm_7b_chat_config(llm=LLMConfig(vocab_size=32096, "
                    f"lora_r={LORA_R}, lora_alpha={LORA_ALPHA}))",
          "params": n_params, "weights_gb": weights_gb,
          "trainable": n_train, "lora_values": n_lora,
          "trainable_tensors": len(trainable), "trainable_kinds": kinds,
          "batch_size": LORA_BATCH,
          "seq_len": LORA_SEQ, "num_workers": LORA_WORKERS,
          "sample_lengths": [min(lengths), max(lengths)],
          "first_step_vs_plain": first, "rel_tol": TRAIN_REL_TOL,
          "remat_modes": remat, "grad_rel_tol": LORA_GRAD_REL_TOL,
          "micro_steps": LORA_MICRO_STEPS, "grad_accum_steps": LORA_ACCUM,
          "launches_per_step": dict(zip(("flash_attn_fwd", "flash_attn_bwd"),
                                        per_step)),
          "launches": launches,
          "odd_micro_steps_unchanged": len(odd),
          "losses": [r["loss"] for r in rows],
          "step_interval_ms": all_iv,
          "step_interval_ms_median": statistics.median(all_iv),
          "profiled_steps": prof_steps,
          "device_idle_share_median": statistics.median(
              v["device_idle_share"] for v in prof_steps.values()),
          "resume": {"state_rel_err": resume_err, "bitwise": resume_bitwise,
                     "metric_rel_err": metric_err,
                     "tol": LORA_RESUME_REL_TOL},
          "checkpoint_bytes": ckpt_bytes, "save_s": saves, "load_s": load_s,
          "merge_vs_lora_logits_rel_err": merged_err,
          "base_vs_lora_logits_rel_err": base_err,
          "model_build_s": build_s, "train_s": train_s,
          "resume_s": resume_s, "sections_s": sections,
          "peak_mem_gb": {"main": peak_main, "phase": peak},
          "phase_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# phase 16: the gather probes' entry point
# ---------------------------------------------------------------------------

def run_probes():
    G.lane_gather.launches = 0
    G.row_gather.launches = 0
    res = probes.main("cuda")
    launches = {"lane_gather": G.lane_gather.launches,
                "row_gather": G.row_gather.launches}
    bad = [r for r in res["A"] + res["B"] if not r["correct"]]
    if bad:
        raise AssertionError(f"probes gave wrong results: {bad}")
    emit({"phase": "probes", "launches": launches, **res})
    return launches


# ---------------------------------------------------------------------------
# phases 17-18: the [GEN] and [EDIT] tools at full width, 512 px
# ---------------------------------------------------------------------------

def gen_prompt_ids(tok, question, image_tokens):
    """The vicuna_v1 chat prompt of `question` up to the assistant's turn
    (as `ChatService` renders it), with `image_tokens` <im_patch> ids for
    an <image> question."""
    conv = get_conv_template("vicuna_v1")
    if image_tokens:
        question = "<image>\n" + question
    conv.append_message(conv.roles[0], question)
    conv.append_message(conv.roles[1], None)
    ids = tokenizer_image_token(conv.get_prompt(), tok)
    if image_tokens:
        ids = expand_image_tokens(
            ids, image_tokens, tok.convert_tokens_to_ids(C.DEFAULT_TOKENS[
                "imp"]))
    return np.asarray(ids, np.int64)


def gen_prompt_lengths():
    """Prompt lengths of the [GEN] and [EDIT] requests (host only; the
    kernel phase runs flash at the [EDIT] one)."""
    cfg, tok = vllm_7b_gen_config(), SimpleTokenizer()
    return {"gen": len(gen_prompt_ids(tok, GEN_QUESTION, 0)),
            "edit": len(gen_prompt_ids(tok, EDIT_QUESTION,
                                       cfg.image_token_len))}


def gen_requests(cfg, tok):
    """The phase's two requests on the card, as {tool: (ids [1, L], CLIP
    pixels or None, the image to edit or None)}: [GEN] text only; [EDIT]
    with a uint8 512x512 image (numpy seed 5) given to the vision encoder
    at its size (`clip_preprocess`: 336 px for CLIP, one 448 px tile for
    InternViT; `cfg.image_token_len` <im_patch> ids) and to the VAE at
    512 px in [-1, 1]."""
    img = np.random.RandomState(5).randint(0, 256, GEN_IMAGE, np.uint8)
    size = cfg.vis_encoder.image_size
    clip = torch.from_numpy(clip_preprocess(img, size)[None]).to(
        "cuda", torch.bfloat16)
    src = torch.from_numpy(img[None].astype(np.float32) / 127.5 - 1.0).to(
        "cuda")
    ids = {tool: torch.from_numpy(gen_prompt_ids(tok, q, n))[None].to("cuda")
           for tool, q, n in (("gen", GEN_QUESTION, 0),
                              ("edit", EDIT_QUESTION,
                               cfg.image_token_len))}
    return {"gen": (ids["gen"], None, None), "edit": (ids["edit"], clip, src)}


def gen_rows(model, gen, tid, tool, req):
    """The generate call with the first token forced to [GEN] / [EDIT],
    and its num_embs_gen rows -> (rows [1, n, C], generate output)."""
    ids, clip, _ = req
    first = torch.tensor([getattr(tid, tool)], dtype=torch.int32,
                         device="cuda")
    out = gen(ids, clip, first_token=first)
    rows, mask = extract_tool_queries_from_generation(
        model.cfg, tid, out["out_tokens"], out["out_hidden"])[tool]
    if not (bool(mask[0, 0]) and not bool(mask[0, 1:].any())):
        raise AssertionError(f"gen {tool}: row mask {mask[0, :4].tolist()}")
    return rows[:, 0], out


def gen_image(model, tool, rows, src, seed=GEN_SEED, steps=GEN_STEPS):
    """The head's `generate` on `rows` from a seeded card generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if tool == "gen":
        return model.sd.generate(rows, g, steps, GEN_GUIDANCE)
    return model.ip2p.generate(rows, src, g, steps, GEN_GUIDANCE,
                               GEN_IMAGE_GUIDANCE)


def gen_whole_image(model, gen, tid, tool, req, steps=GEN_STEPS):
    """One image as a user makes it: the generate call, its rows, the
    head's generate (`steps` DDIM steps). Returns (image, rows, generate
    output, flash launches, {generate_ms, head_ms, wall_ms} on the host
    clock, each stage ended by a device sync)."""
    torch.cuda.synchronize()
    f0, t0 = A.flash_attention.launches, time.perf_counter()
    rows, out = gen_rows(model, gen, tid, tool, req)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    image = gen_image(model, tool, rows, req[2], steps=steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return image, rows, out, A.flash_attention.launches - f0, {
        "generate_ms": (t1 - t0) * 1e3, "head_ms": (t2 - t1) * 1e3,
        "wall_ms": (t2 - t0) * 1e3}


def last_forced_logits(core, out):
    """The logits after the last forced [EMB] row (the last step that
    both runs feed the same tokens): the LM head on that row's hidden
    state."""
    h = out["out_hidden"][:, core.cfg.num_embs_gen]
    return core.llm.lm_head(h.to(core.llm.lm_head.weight.dtype)).float()


def unet_cost(unet, B, in_channels, ctx_len, ctx_dim):
    """FLOPs of one UNet pass at batch B from this run's shapes (every conv
    and dense product, and each attention's QK^T and PV), the bytes of its
    weights, and the fp32 score bytes of its attentions at the largest
    token count (the 64^2 level), counted by forward hooks on a pass."""
    S = unet.cfg.sample_size
    cost = {"flops": 0, "score_bytes_top": 0, "top_attn_calls": 0}

    def conv(mod, inp, out):
        cost["flops"] += 2 * out.numel() * mod.weight[0].numel()

    def dense(mod, inp, out):
        cost["flops"] += 2 * out.numel() * mod.in_features

    def attn(mod, inp, out):
        x = inp[0]
        ctx = inp[1] if len(inp) > 1 and inp[1] is not None else x
        Bq, L, inner = x.shape
        cost["flops"] += 4 * Bq * L * ctx.shape[1] * inner
        if L == S * S and ctx is x:
            cost["score_bytes_top"] += Bq * mod.heads * L * L * 4
            cost["top_attn_calls"] += 1

    hooks = []
    for mod in unet.modules():
        if isinstance(mod, torch.nn.Conv2d):
            hooks.append(mod.register_forward_hook(conv))
        elif isinstance(mod, torch.nn.Linear):
            hooks.append(mod.register_forward_hook(dense))
        elif isinstance(mod, SDU.CrossAttention):
            hooks.append(mod.register_forward_hook(attn))
    try:
        with torch.no_grad():
            unet(torch.zeros(B, S, S, in_channels, device="cuda"),
                 torch.zeros(B, dtype=torch.int32, device="cuda"),
                 torch.zeros(B, ctx_len, ctx_dim, device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    cost["weight_bytes"] = sum(p.numel() * p.element_size()
                               for p in unet.parameters())
    return cost


def unet_step_ms(head, B):
    """Median wall ms of one UNet pass at batch B (one DDIM step's UNet
    call)."""
    cfg = head.unet.cfg
    S, ctx = cfg.sample_size, head.cfg.num_queries
    x = torch.randn(B, S, S, cfg.in_channels, device="cuda")
    t = torch.full((B,), 501, dtype=torch.int32, device="cuda")
    c = torch.randn(B, ctx, cfg.cross_attention_dim, device="cuda")
    with torch.no_grad():
        return host_ms(lambda: head.unet(x.to(head.dtype), t, c),
                       n=GEN_TIMED)


def gen_timings(model, tid, reqs, rows, walls):
    """Each stage's ms (host clock, synced; medians), the 50-step loops,
    the UNet step at B 2 ([GEN]) and B 3 ([EDIT]) with its FLOP bound,
    and the whole image's wall (median of the main path's GEN_WALL_RUNS
    runs)."""
    res = {}
    with torch.no_grad():
        for tool, head in (("gen", model.sd), ("edit", model.ip2p)):
            src = reqs[tool][2]
            cond = head.map_embeddings(rows[tool])
            lat = torch.randn(1, head.cfg.sample_size, head.cfg.sample_size,
                              4, device="cuda")
            B = 2 if tool == "gen" else 3
            r = {"generate_ms_median": statistics.median(
                     w["generate_ms"] for w in walls[tool]),
                 "head_generate_ms_median": statistics.median(
                     w["head_ms"] for w in walls[tool]),
                 "wall_ms_median": statistics.median(
                     w["wall_ms"] for w in walls[tool]),
                 "wall_ms_runs": [w["wall_ms"] for w in walls[tool]],
                 "mapper_ms": host_ms(lambda: head.map_embeddings(
                     rows[tool]), n=GEN_TIMED),
                 "unet_batch": B,
                 "unet_step_ms": unet_step_ms(head, B),
                 "vae_decode_ms": host_ms(lambda: head.vae.decode(
                     lat.to(head.dtype)), n=3)}
            if tool == "gen":
                r["loop_ms"] = host_ms(lambda: head.denoise(
                    cond, lat, GEN_STEPS, GEN_GUIDANCE), n=1)
            else:
                img_cond = head.image_latents(src)
                r["vae_encode_ms"] = host_ms(lambda: head.image_latents(src),
                                             n=3)
                r["loop_ms"] = host_ms(lambda: head.denoise(
                    cond, img_cond, lat, GEN_STEPS, GEN_GUIDANCE,
                    GEN_IMAGE_GUIDANCE), n=1)
            cost = unet_cost(head.unet, B, head.unet.cfg.in_channels,
                             head.cfg.num_queries,
                             head.unet.cfg.cross_attention_dim)
            r["unet_step_cost"] = {
                **cost, "flop_bound_ms": cost["flops"] / BF16_TENSOR_FLOPS
                * 1e3, "weight_bytes_bound_ms": cost["weight_bytes"]
                / HBM_BYTES_PER_S * 1e3}
            res[tool] = r
    return res


def run_gen():
    """The gen phase: see the module docstring."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    cfg = vllm_7b_gen_config()
    tid, tok = SpecialTokenIds.synthetic(), SimpleTokenizer()
    n_gen = cfg.num_embs_gen
    t = time.perf_counter()
    model = build_model(cfg, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    fp32 = {id(p) for m in model.fp32_modules() for p in m.parameters()}
    for name, p in model.named_parameters():
        want = torch.float32 if id(p) in fp32 else torch.bfloat16
        if p.dtype != want or not p.is_cuda:
            raise AssertionError(f"gen: {name} is {p.dtype} on {p.device}, "
                                 f"want {want} on the card")
    weights_gb = torch.cuda.memory_allocated() / 1e9
    reqs = gen_requests(cfg, tok)
    gen = build_generate_fn(model.core, tid, max_new_tokens=n_gen + 3,
                            max_len=GEN_MAX_LEN)
    want_flash = {"gen": 0, "edit": cfg.vis_encoder.num_layers
                  + cfg.llm.num_layers}

    # the main path, with the launch count taken around it alone
    A.flash_attention.launches = 0
    images, rows, outs, walls, calls = {}, {}, {}, {}, []
    with torch.no_grad():
        for tool, req in reqs.items():
            runs = [gen_whole_image(model, gen, tid, tool, req)
                    for _ in range(GEN_WALL_RUNS)]
            images[tool], rows[tool], outs[tool] = runs[0][:3]
            walls[tool] = [r[4] for r in runs]
            calls += [{"tool": tool, "flash_attn_fwd": r[3]} for r in runs]
            for r in runs[1:]:
                if not (torch.equal(r[0], runs[0][0])
                        and torch.equal(r[1], runs[0][1])):
                    raise AssertionError(f"gen {tool}: the same seed gave "
                                         "another image or other rows")
    torch.cuda.synchronize()
    launches = {"flash_attn_fwd": A.flash_attention.launches}
    for c in calls:
        if c["flash_attn_fwd"] != want_flash[c["tool"]]:
            raise AssertionError(f"gen launches {c}, want {want_flash}")
    for tool in reqs:
        toks = outs[tool]["out_tokens"][0].tolist()
        if toks[0] != getattr(tid, tool) or toks[1:1 + n_gen] != \
                [tid.emb] * n_gen:
            raise AssertionError(f"gen {tool}: tokens {toks[:4]}...")
        img = images[tool]
        if tuple(img.shape) != (1,) + GEN_IMAGE or not torch.isfinite(
                img).all():
            raise AssertionError(f"gen {tool}: image {tuple(img.shape)}, "
                                 f"finite {bool(torch.isfinite(img).all())}")

    # the plain flash version on the same weights: rows, the logits after
    # the last forced row, and the image from the plain run's rows
    plain = {}
    with torch.no_grad():
        for tool, req in reqs.items():
            with plain_versions():
                rows_p, out_p = gen_rows(model, gen, tid, tool, req)
            e = {"rows": rel_err(rows[tool], rows_p),
                 "last_forced_logits": rel_err(
                     last_forced_logits(model.core, outs[tool]),
                     last_forced_logits(model.core, out_p)),
                 "rows_identical": bool(torch.equal(rows[tool], rows_p))}
            if not max(e["rows"], e["last_forced_logits"]) <= GEN_REL_TOL:
                raise AssertionError(f"gen {tool} kernel vs plain {e} > "
                                     f"{GEN_REL_TOL}")
            e["image_from_plain_rows"] = 0.0 if e["rows_identical"] else \
                rel_err(images[tool], gen_image(model, tool, rows_p, req[2]))
            e["plain_tokens_equal"] = outs[tool]["out_tokens"].equal(
                out_p["out_tokens"])
            plain[tool] = e
        timings = gen_timings(model, tid, reqs, rows, walls)
    emit({"phase": "gen", "config": "vllm_7b_gen_config()",
          "image": list(GEN_IMAGE), "steps": GEN_STEPS,
          "guidance": GEN_GUIDANCE, "image_guidance": GEN_IMAGE_GUIDANCE,
          "memory_format": str(SDU.MAP_FORMAT),
          "prompt_tokens": {k: int(r[0].shape[1]) for k, r in reqs.items()},
          "params": sum(p.numel() for p in model.parameters()),
          "head_params": {k: sum(p.numel() for p in getattr(
              model, k).parameters()) for k in ("sd", "ip2p")},
          "weights_gb": weights_gb, "resident_before_gb": resident_gb,
          "build_model_s": build_s, "calls": calls, "launches": launches,
          "flash_per_generate": want_flash, "plain_rel_err": plain,
          "plain_rel_tol": GEN_REL_TOL, "timings": timings,
          "image_stats": {k: {"mean": v.float().mean().item(),
                              "std": v.float().std().item()}
                          for k, v in images.items()},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t_phase})

    # gen_profile: one [EDIT] image under torch.profiler
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        _, _, _, _, w = gen_whole_image(model, gen, tid, "edit",
                                        reqs["edit"])
    emit({"phase": "gen_profile", "request": "edit", **w,
          **device_summary(prof, w["wall_ms"])})
    del model, reqs, gen, images, rows, outs, prof
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 19-20: the whole 7B flagship with region prompts, at full width
# ---------------------------------------------------------------------------

# the region requests: a uint8 image (numpy seed 9) with boxes and masks
# in its own geometry; each service answers FLAGSHIP_NEW greedy tokens
# from prompts left-padded to FLAGSHIP_PROMPT (768 with 256-token chunks)
FLAGSHIP_IMAGE = (480, 640, 3)
FLAGSHIP_BOXES = ([120.0, 80.0, 360.0, 300.0], [400.0, 200.0, 610.0, 460.0])
FLAGSHIP_OTHER_BOX = [20.0, 300.0, 200.0, 470.0]
FLAGSHIP_NEW = 16
FLAGSHIP_PROMPT = 640
FLAGSHIP_CHUNK = 256
FLAGSHIP_MAX_REGIONS = 8
FLAGSHIP_TIMED = 3
FLAGSHIP_GEN_STEPS = 4        # DDIM steps an image (the gen phase's 10)
# another box's region rows must lie this many times farther from the
# box's than rounding puts them (kernel vs plain, mode vs B1)
REGION_SEPARATION = 10
# the det and pose tools' image: 800x1088, its own bucket at the 800 px
# test scale
FLAGSHIP_DET_IMAGE = (800, 1088, 3)
MICRO_BATCH_REFUSAL = (
    "region prompts are not supported with request micro-batching — "
    "serve with --max-batch 1 or --slots")


def flagship_regions():
    """The image and its regions: {name: (prompt, regions)}. "box" and
    "mask" are the same region (a box and the mask it covers); "three"
    holds two boxes and an RLE-sent blob mask; "other_box" is the first
    prompt with another box."""
    img = np.random.RandomState(9).randint(0, 256, FLAGSHIP_IMAGE, np.uint8)
    h, w = FLAGSHIP_IMAGE[:2]
    x0, y0, x1, y1 = map(int, FLAGSHIP_BOXES[0])
    box_mask = np.zeros((h, w), np.float32)
    box_mask[y0:y1, x0:x1] = 1
    yy, xx = np.mgrid[:h, :w]
    blob = (((yy - 360) / 90.0) ** 2 + ((xx - 480) / 130.0) ** 2
            <= 1).astype(np.float32)
    reqs = {"box": ("What is <regions>?", [FLAGSHIP_BOXES[0]]),
            "mask": ("What is <regions>?", [box_mask]),
            "three": ("Compare <regions>.", [*FLAGSHIP_BOXES, blob]),
            "other_box": ("What is <regions>?", [FLAGSHIP_OTHER_BOX])}
    return img, reqs


def region_packed(svc, img, prompt, regions, history=None):
    """A region request as `svc` runs it at B1: left-padded ids, [1, 1,
    S, S, 3] pixels, mask, and the [1, max_regions, S, S] region masks."""
    regs = svc._check_regions(regions, img)
    ids, pix, _ = svc._encode(prompt, img, history,
                              num_regions=len(regions))
    req = _Request(ids, pix, regions=regs)
    ids, imgs, mask, _ = svc._pack([req])
    return ids, imgs, mask, svc._regions_arg([req])


def region_rows(core, tid, packed):
    """The rows a request's <region> tokens receive, fp32 [n, C]."""
    ids, imgs, _, regs = packed
    emb, _ = core.build_prompt_embeds(ids, imgs, tid, regions=regs)
    return emb[ids == tid.reg].float()


class RegionTrace:
    """Records, reading only, what the region path gave each call while
    it is open: for every prompt assembly that carries regions, its
    region masks and the fp32 rows its <region> tokens receive; for every
    admission, the fp32 logits [V] that chose its first token (the last
    position of a B1 prefill through `core.forward`, or the last window
    of a chunked admission or a session extension). `call(fn)` returns
    fn's result and what that call recorded."""

    def __init__(self, core, tid, svcs):
        self.embeds, self.firsts = [], []
        self._stack = ExitStack()
        embed, forward = core.build_prompt_embeds, core.forward

        def embed_w(input_ids, images, tid_, regions=None, **kw):
            out = embed(input_ids, images, tid_, regions=regions, **kw)
            if regions is not None:
                self.embeds.append((regions.clone(),
                                    out[0][input_ids == tid.reg].float()))
            return out

        def forward_w(*a, **kw):
            out = forward(*a, **kw)
            if out["logits"] is not None:
                self.firsts.append(out["logits"][0, -1].float().clone())
            return out

        def finish_w(fn):
            def finish(last):
                self.firsts.append(last[0].float().clone())
                return fn(last)
            return finish

        self._stack.enter_context(mock.patch.object(
            core, "build_prompt_embeds", embed_w))
        self._stack.enter_context(mock.patch.object(core, "forward",
                                                    forward_w))
        for svc in svcs:
            for name in ("_chunk_finish", "_sess_finish"):
                if hasattr(svc, name):
                    self._stack.enter_context(mock.patch.object(
                        svc, name, finish_w(getattr(svc, name))))

    def call(self, fn):
        """(fn(), {"masks", "rows"}: the call's first prompt assembly with
        regions, None where it assembled none; "first": its first
        admission's logits)."""
        e0, f0 = len(self.embeds), len(self.firsts)
        out = fn()
        embeds, firsts = self.embeds[e0:], self.firsts[f0:]
        if not firsts:
            raise AssertionError("flagship: a call admitted nothing")
        masks, rows = embeds[0] if embeds else (None, None)
        return out, {"masks": masks, "rows": rows, "first": firsts[0]}

    def close(self):
        self._stack.close()


def b1_reference(svc, img, prompt, regions, history=None):
    """The B1 dispatch service's answer to a region request and its
    teacher-forced fp32 logits [n, V] (prefill and decode steps on its
    tokens): what every other mode is held to."""
    out = svc.generate(prompt, image=img, regions=regions, history=history)
    ids, imgs, mask, regs = region_packed(svc, img, prompt, regions,
                                          history)
    toks = torch.tensor([out["ids"]], dtype=torch.int32, device=ids.device)
    logits = teacher_forced(svc, ids, imgs, mask, toks, len(out["ids"]),
                            regions=regs)[:, 0]
    return out["ids"], logits


def chunked_first_logits(svc, img, prompt, regions):
    """The fp32 last-position logits [V] of a region request's chunked
    admission (the embedding assembly, then the cached extend windows)
    in `svc`'s slot engine."""
    regs = svc._check_regions(regions, img)
    ids, pix, _ = svc._encode(prompt, img, num_regions=len(regions))
    req = _Request(ids, pix, regions=regs)
    ids, im, _, vrow = slot_row(svc, req)
    W = svc.prefill_chunk
    emb = svc._chunk_embed(ids, im, regions=svc._regions_arg([req]))
    row = svc._chunk_row()
    for k in range(svc.max_prompt // W):
        row, last = svc._chunk_run(emb[:, k * W:(k + 1) * W], row, vrow)
    return last[0].float()


def flagship_launches(cfg):
    """Kernel launches of one call of each kind: (flash, MSDA)."""
    clip, llm = cfg.vis_encoder.num_layers, cfg.llm.num_layers
    det = cfg.gdino.encoder_layers + cfg.gdino.decoder_layers
    pose = cfg.unipose.encoder_layers + cfg.unipose.decoder_layers
    return {"infer_det": (clip + llm, det), "detect": (clip + llm, det),
            "pose": (clip + llm, pose), "gen": (0, 0),
            "edit": (clip + llm, 0), "region_b1": (clip + llm, 0),
            "region_chunked": (clip, 0)}


def flagship_det_ids(tid, cfg, regions=0):
    """The det prompt (`bench.py:255-258`), with `regions` <region>
    tokens after the image when given."""
    ids = [1, 10, 11] + [tid.imp] * cfg.image_token_len + [12]
    for i in range(regions):
        ids += [tid.reg, 13 + i]
    return ids + [tid.det] + [tid.emb + i for i in range(cfg.num_embs)] \
        + [2]


def det_plain_errs(model, tid, ids, images, aug, regions=None):
    """One det request with the kernels against the same request with the
    plain versions on the kernel run's proposal choice: relative error of
    the text queries, the logits over the valid text columns and the
    boxes."""
    def run(choices=None):
        out = model.core(ids, images, tid, compute_logits=False,
                         regions=regions)
        tq, mask = model.core.extract_text_query(out["hidden"], ids, tid)
        return tq, mask, model.gdino(aug, tq, mask, **(choices or {}))

    tq_k, mask, out_k = run()
    with plain_versions():
        tq_p, _, out_p = run({"topk_idx": out_k["topk_idx"]})
    n = mask.shape[1]
    cols = mask[0]
    return {"text_queries": rel_err(tq_k, tq_p),
            "logits": rel_err(out_k["logits"][..., :n][..., cols],
                              out_p["logits"][..., :n][..., cols]),
            "pred_boxes": rel_err(out_k["pred_boxes"], out_p["pred_boxes"])}


def region_encoder_cost(enc, R, size, feat_dim, patches):
    """FLOPs and bytes of the region encoder on R regions of one image at
    `size` px from this run's shapes: every conv and dense product
    (forward hooks), the pooling weights (two products a region) and the
    three pooled levels; bytes as each distinct input is read once (the
    fp32 image, R fp32 masks, the three bf16 ViT levels of that image,
    the weights: the call's per-region copies of the image and levels
    are its own) and the output written once."""
    dev = enc.up_dim.weight.device
    flops = {"n": 0}

    def hook(mod, inp, out):
        k = mod.weight[0].numel() if isinstance(mod, torch.nn.Conv2d) \
            else mod.in_features
        flops["n"] += 2 * out.numel() * k

    hooks = [m.register_forward_hook(hook) for m in enc.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    feats = [torch.zeros(R, patches, feat_dim, device=dev,
                         dtype=enc.up_dim.weight.dtype)] * 3
    try:
        with torch.no_grad():
            out = enc(torch.zeros(R, size, size, 3, device=dev),
                      torch.zeros(R, size, size, device=dev), feats)
    finally:
        for h in hooks:
            h.remove()
    side = int(patches ** 0.5)
    pool = 2 * R * (side * size * size + side * size * side) \
        + 3 * 2 * R * patches * enc.cfg.embed_dim
    nbytes = (size * size * 3 * 4 + R * size * size * 4
              + 3 * patches * feat_dim * feats[0].element_size()
              + sum(p.numel() * p.element_size() for p in enc.parameters())
              + out.numel() * out.element_size())
    t, by = bound(nbytes, flops["n"] + pool, BF16_TENSOR_FLOPS)
    return {"regions": R, "flops": flops["n"] + pool, "bytes": nbytes,
            "bound_ms": t, "bound_by": by}


def range_device_ms(prof, label, slack_ms):
    """Device ms and kernel count of the kernels that start inside the
    `record_function` range `label` (within `slack_ms` of its ends: the
    range is synced and kept `2 * slack_ms` from any other work), read
    from the raw kineto events as `device_summary` reads them."""
    events = list(prof.profiler.kineto_results.events())
    rng = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
           if e.name() == label and e.device_type() == DeviceType.CPU]
    if len(rng) != 1:
        raise AssertionError(f"{label}: {len(rng)} ranges in the profile")
    lo, hi = rng[0][0] - slack_ms * 1e6, rng[0][1] + slack_ms * 1e6
    ns, n = 0, 0
    for e in events:
        if (e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
                and lo <= e.start_ns() <= hi):
            ns += e.duration_ns()
            n += 1
    return ns / 1e6, n


def profile_region_request(svc, packed, gap_s=0.02):
    """One region request's generate call under torch.profiler, its region
    encoder call in a synced `record_function` range `gap_s` away from
    the rest: the request's device summary and the encoder's device ms
    and kernel count."""
    ids, imgs, mask, regs = packed
    enc = svc.core.region_encoder
    forward = enc.forward
    label = "flagship:region_encoder"

    def ranged(*a, **kw):
        torch.cuda.synchronize()
        time.sleep(gap_s)
        with record_function(label):
            out = forward(*a, **kw)
            torch.cuda.synchronize()
        time.sleep(gap_s)
        return out

    live = torch.ones(1, dtype=torch.bool, device=ids.device)
    with torch.no_grad(), mock.patch.object(enc, "forward", ranged), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        svc.generate_fn(ids, imgs, attn_mask=mask, live=live, regions=regs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    enc_ms, enc_n = range_device_ms(prof, label, gap_s * 1e3 / 2)
    return {**device_summary(prof, wall_ms),
            "sleep_in_wall_ms": 2 * gap_s * 1e3,
            "region_encoder_device_ms": enc_ms,
            "region_encoder_kernels": enc_n}


def ttft_ms(svc, packed, regions):
    """Median ms of a B1 prefill to its first token (host clock, synced),
    with or without the request's regions."""
    ids, imgs, mask, regs = packed
    core = svc.core

    def first():
        cache = core.new_cache(1, svc.max_prompt + svc.max_new_tokens + 8)
        out = core(ids, imgs, svc.tid, attn_mask=mask, cache=cache,
                   regions=regs if regions else None)
        return out["logits"][:, -1].argmax(-1).item()

    with torch.no_grad():
        first()
        return host_ms(first, n=FLAGSHIP_TIMED)


def region_refill_gap(svc, img, prompt, regions, filler):
    """The chunked slot service's engine on a fresh state with every slot
    but one live (`filler` requests): the longest gap between the ticks
    those slots see while the last slot is refilled with a region
    request, by chunk windows and by a B1 prefill (ms, host clock)."""
    state, valid = svc._slot_init()
    regs = svc._check_regions(regions, img)
    ids_r, pix, _ = svc._encode(prompt, img, num_regions=len(regions))
    req = _Request(ids_r, pix, regions=regs)
    with torch.no_grad():
        for s in range(svc.slots - 1):
            ids, im, mask, _ = slot_row(svc, filler)
            pre = svc._slot_prefill(ids, im, mask)
            svc._slot_insert(state, s, pre["first"], pre["embed"],
                             pre["cache"], pre["valid"], valid)

        def tick():
            svc._slot_step(state, valid)["token"].cpu()
            return time.perf_counter()

        def gap(chunked):
            slot = svc.slots - 1
            state.live[slot] = False
            ids, im, mask, vrow = slot_row(svc, req)
            r = svc._regions_arg([req])
            times = [tick()]
            if chunked:
                W = svc.prefill_chunk
                emb = svc._chunk_embed(ids, im, regions=r)
                row = svc._chunk_row()
                for k in range(svc.max_prompt // W):
                    row, last = svc._chunk_run(emb[:, k * W:(k + 1) * W],
                                               row, vrow)
                    times.append(tick())
                first, embed, _ = svc._chunk_finish(last)
                svc._slot_insert(state, slot, first[0], embed, row, vrow,
                                 valid)
            else:
                pre = svc._slot_prefill(ids, im, mask, regions=r)
                svc._slot_insert(state, slot, pre["first"], pre["embed"],
                                 pre["cache"], pre["valid"], valid)
            times.append(tick())
            return max(b - a for a, b in zip(times, times[1:])) * 1e3

        tick()
        gap(True)                                   # warm
        return {"live_slots": svc.slots - 1, "chunked": gap(True),
                "monolithic": gap(False)}


def check_region_path(seen, refs, first_b1, rows_plain_err):
    """Holds what the region path gave each call (`RegionTrace`) rather
    than the tokens it emitted, which random weights make alike: the box
    and its mask, and the HTTP request and the direct call, give the same
    masks and bit-identical <region> rows; the speculative and both slot
    modes the B1 box request's masks, and rows and first-step logits
    within LOGIT_REL_TOL of it (`first_b1`, its teacher-forced first
    step); a session turn that reuses its prefix assembles no regions
    again, one with a changed region those of its B1 reference
    (`refs`); and another box's rows lie REGION_SEPARATION times farther
    from the box's than the kernel-vs-plain rows error
    (`rows_plain_err`) and any mode's. Returns the errors."""
    for a, b in ((("b1", "mask"), ("b1", "box")),
                 (("http", "three"), ("b1", "three"))):
        for key in ("masks", "rows"):
            if not torch.equal(seen[a][key], seen[b][key]):
                raise AssertionError(f"flagship: {a}'s region {key} differ "
                                     f"from {b}'s")
    pairs = {f"{m}:box": (seen[m, "box"], seen["b1", "box"])
             for m in ("spec", "slots_b1", "slots")}
    pairs["session:changed"] = (seen["session", "changed"], refs["changed"])
    rows, first = {}, {}
    for name, (got, want) in pairs.items():
        if not torch.equal(got["masks"], want["masks"]):
            raise AssertionError(f"flagship {name}: region masks differ "
                                 "from the B1 request's")
        rows[name] = rel_err(got["rows"], want["rows"])
    if seen["session", "same"]["rows"] is not None:
        raise AssertionError("flagship: the reused session turn assembled "
                             "its regions again")
    for name, (got, want) in {**pairs, "session:same": (
            seen["session", "same"], refs["same"])}.items():
        first[name] = rel_err(got["first"], want["first"] if name.startswith(
            "session") else first_b1)
    for m in ("box", "mask"):
        first["b1:" + m] = rel_err(seen["b1", m]["first"], first_b1)
    first["http:three"] = rel_err(seen["http", "three"]["first"],
                                  seen["b1", "three"]["first"])
    for k, e in {**rows, **first}.items():
        if not e <= LOGIT_REL_TOL:
            raise AssertionError(f"flagship {k}: {e} from the B1 request's "
                                 f"> {LOGIT_REL_TOL} (rows {rows}, first-step "
                                 f"logits {first})")
    other = rel_err(seen["b1", "other_box"]["rows"], seen["b1", "box"]["rows"])
    noise = max(rows_plain_err, *rows.values())
    if not other >= REGION_SEPARATION * noise:
        raise AssertionError(f"flagship: another box's rows differ by {other}, "
                             f"under {REGION_SEPARATION} x {noise}")
    return {"rows_rel_err": rows, "first_step_rel_err": first,
            "other_box_rows_rel_diff": other,
            "separation": REGION_SEPARATION}


def run_flagship(flash_device_ms=None):
    """Phases `flagship` and `flagship_profile`, and the `convert`,
    `profiling` and `evalx` checks on the same model: see the module
    docstring (`flash_device_ms`: the kernel phase's device ms of the
    flash case `FIT_FLASH_CASE`, where it ran). Returns the launch
    counts of the phase's main path and of the evalx, convert and
    profiling paths."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = vllm_7b_config()
    tid = SpecialTokenIds.synthetic()
    tok, gen_tok = RoundTripTokenizer(), SimpleTokenizer()
    want = flagship_launches(cfg)
    t = time.perf_counter()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    fp32 = check_param_dtypes(model, "flagship")
    if not any(n.startswith("core.region_encoder.stem_norm") for n, p in
               model.named_parameters() if id(p) in fp32):
        raise AssertionError("flagship: the region encoder's norms are "
                             "not among the fp32 parts")
    weights_gb = torch.cuda.memory_allocated() / 1e9
    core = model.core
    size = cfg.vis_encoder.image_size
    g = torch.Generator(device="cuda").manual_seed(1)
    det_ids = torch.tensor([flagship_det_ids(tid, cfg)], device="cuda")
    det_reg_ids = torch.tensor([flagship_det_ids(tid, cfg, 1)],
                               device="cuda")
    det_img = (0.3 * torch.randn(1, size, size, 3, generator=g,
                                 device="cuda")).to(torch.bfloat16)
    det_aug = (0.3 * torch.randn(1, DET_SIZE, DET_SIZE, 3, generator=g,
                                 device="cuda")).to(torch.bfloat16)
    det_region = torch.zeros(1, 1, size, size, device="cuda")
    det_region[0, 0, size // 4:size // 2, size // 5:size * 3 // 5] = 1
    perc_img = np.random.RandomState(4).randint(0, 256, FLAGSHIP_DET_IMAGE,
                                                np.uint8)
    pred = Predictor(cfg, model, gen_tok)
    gen_reqs = gen_requests(cfg, gen_tok)
    gen = build_generate_fn(core, tid, max_new_tokens=cfg.num_embs_gen + 3,
                            max_len=GEN_MAX_LEN)
    img, regions = flagship_regions()
    common = dict(max_new_tokens=FLAGSHIP_NEW, max_prompt=FLAGSHIP_PROMPT,
                  max_regions=FLAGSHIP_MAX_REGIONS)
    svcs = {"b1": ChatService(cfg, core, tok, **common),
            "spec": ChatService(cfg, core, tok, spec_k=SPEC_K, **common),
            "slots": ChatService(cfg, core, tok, slots=4,
                                 prefill_chunk=FLAGSHIP_CHUNK, sessions=2,
                                 **common),
            "slots_b1": ChatService(cfg, core, tok, slots=2, **common)}
    rec = SlotRecorder(svcs["slots"], 1)
    srv = make_server(svcs["b1"], host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/v1/generate"
    calls = []

    def counted(what, kind, fn):
        f0, m0 = A.flash_attention.launches, M.ms_deform_attn.launches
        out = fn()
        got = (A.flash_attention.launches - f0,
               M.ms_deform_attn.launches - m0)
        calls.append({"call": what, "flash_attn_fwd": got[0],
                      "ms_deform_attn_fwd": got[1]})
        if kind is not None and got != want[kind]:
            raise AssertionError(f"flagship {what}: launches {got}, want "
                                 f"{want[kind]} ({kind})")
        return out

    def ask(name, mode):
        prompt, regs = regions[name]
        answers[mode, name], seen[mode, name] = trace.call(
            lambda: counted(mode, "region_b1", lambda: svcs[mode].generate(
                prompt, image=img, regions=regs)))

    # the main path, with the launch counts taken around it alone; the
    # trace keeps each region call's masks, rows and first-step logits
    trace = RegionTrace(core, tid, svcs.values())
    A.flash_attention.launches = 0
    M.ms_deform_attn.launches = 0
    answers, seen = {}, {}
    with torch.no_grad():
        det_out = counted("infer_det", "infer_det", lambda: model.infer_det(
            det_ids, det_img, det_aug, tid))
        det_reg_out = counted("infer_det:region", "infer_det",
                              lambda: model.infer_det(
                                  det_reg_ids, det_img, det_aug, tid,
                                  regions=det_region))
        perc, perc_raw = {}, {}
        for task in ("detect", "pose"):
            reply, *perc_raw[task] = counted(
                f"predictor:{task}", task,
                lambda task=task: predictor_call(pred, task, perc_img))
            perc[task] = perception_json(reply)
        images, rows, outs = {}, {}, {}
        for tool, req in gen_reqs.items():
            images[tool], rows[tool], outs[tool] = counted(
                f"gen:{tool}", tool,
                lambda tool=tool, req=req: gen_whole_image(
                    model, gen, tid, tool, req, FLAGSHIP_GEN_STEPS))[:3]
        for name in ("box", "mask", "three", "other_box"):
            ask(name, "b1")
        prompt, regs = regions["three"]
        blob = regs[2].astype(np.uint8)
        answers["http", "three"], seen["http", "three"] = trace.call(
            lambda: counted("b1:http", "region_b1", lambda: post_json(url, {
                "prompt": prompt, "image_b64": base64.b64encode(
                    img.tobytes()).decode(), "image_shape": list(img.shape),
                "region_boxes": [list(b) for b in FLAGSHIP_BOXES],
                "region_masks": [rle_encode(blob)]})))
        ask("box", "spec")
        ask("box", "slots_b1")
        # slots: a region request admitted while a text request decodes
        f0 = A.flash_attention.launches
        filler = dict(prompt="tell me a long story about the sea",
                      max_new_tokens=FLAGSHIP_NEW)
        box = {}
        th = threading.Thread(target=lambda: box.update(
            out=svcs["slots"].generate(**filler)), daemon=True)
        th.start()
        while not rec.first_token and th.is_alive():
            time.sleep(0.005)
        answers["slots", "box"], seen["slots", "box"] = trace.call(
            lambda: svcs["slots"].generate(regions["box"][0], image=img,
                                           regions=regions["box"][1]))
        th.join(600)
        filler_out = box["out"]
        # two sessions: each parks a first turn, and its follow-up
        # extends that prefix, with the same regions or a changed one
        prompt, regs = regions["box"]
        follow_ups = {"same": regs, "changed": [FLAGSHIP_OTHER_BOX]}
        turn1, hists = {}, {}
        for name, rg in follow_ups.items():
            turn1[name] = svcs["slots"].generate(prompt, image=img,
                                                 regions=regs, session=name)
            hists[name] = [prompt, turn1[name]["text"]]
            answers["session", name], seen["session", name] = trace.call(
                lambda rg=rg, name=name: svcs["slots"].generate(
                    "tell me more", image=img, regions=rg,
                    history=hists[name], session=name))
        fresh = sum(not a.get("session_reused", False)
                    for a in (filler_out, answers["slots", "box"],
                              *turn1.values(), answers["session", "same"],
                              answers["session", "changed"]))
        got = A.flash_attention.launches - f0
        calls.append({"call": "slots", "flash_attn_fwd": got,
                      "fresh_admissions": fresh})
        if got != fresh * want["region_chunked"][0]:
            raise AssertionError(f"flagship slots: flash {got}, want "
                                 f"{want['region_chunked'][0]} x {fresh}")
    torch.cuda.synchronize()
    launches = {"flash_attn_fwd": A.flash_attention.launches,
                "ms_deform_attn_fwd": M.ms_deform_attn.launches}

    # the main path's outputs
    Q, T = cfg.gdino.num_queries, cfg.gdino.max_text_len
    for out in (det_out, det_reg_out):
        for key, shape in (("logits", (1, Q, T)), ("pred_boxes", (1, Q, 4))):
            x = out[key]
            if tuple(x.shape) != shape or not torch.isfinite(x).all():
                raise AssertionError(f"flagship infer_det {key}: "
                                     f"{tuple(x.shape)}")
    for task, reply in perc.items():
        check_perception_reply(task, reply, FLAGSHIP_DET_IMAGE[:2])
    for tool in gen_reqs:
        toks = outs[tool]["out_tokens"][0].tolist()
        n_gen = cfg.num_embs_gen
        if toks[0] != getattr(tid, tool) or toks[1:1 + n_gen] != \
                [tid.emb] * n_gen:
            raise AssertionError(f"flagship {tool}: tokens {toks[:4]}")
        if tuple(images[tool].shape) != (1,) + GEN_IMAGE or \
                not torch.isfinite(images[tool]).all():
            raise AssertionError(f"flagship {tool}: image")
    if answers["b1", "mask"]["ids"] != answers["b1", "box"]["ids"]:
        raise AssertionError("flagship: the mask region's tokens differ "
                             "from its box's")
    if answers["http", "three"]["ids"] != answers["b1", "three"]["ids"]:
        raise AssertionError("flagship: the HTTP answer differs from the "
                             "direct call's")
    if not answers["session", "same"]["session_reused"] or \
            answers["session", "changed"]["session_reused"]:
        raise AssertionError("flagship: session reuse "
                             f"{answers['session', 'same']} / "
                             f"{answers['session', 'changed']}")
    if rec.live_at_admission and max(
            n for r, n in rec.live_at_admission.items()
            if r.regions is not None and r.session is None) < 1:
        raise AssertionError("flagship: the region request was not "
                             "admitted while another slot decoded")
    refused = None
    batched = ChatService(cfg, core, tok, max_batch=4, **common)
    try:
        batched.generate(regions["box"][0], image=img,
                         regions=regions["box"][1])
    except ValueError as e:
        refused = str(e)
    finally:
        batched.close()
    if refused != MICRO_BATCH_REFUSAL:
        raise AssertionError(f"flagship: micro-batching said {refused!r}")

    # against the plain versions and the B1 reference
    errs, rules = {}, {}
    with torch.no_grad():
        errs["infer_det"] = det_plain_errs(model, tid, det_ids, det_img,
                                           det_aug)
        errs["infer_det:region"] = det_plain_errs(
            model, tid, det_reg_ids, det_img, det_aug, det_region)
        for task in ("detect", "pose"):
            errs[task] = perception_errs(model, tid, task, *perc_raw[task])
        for tool, req in gen_reqs.items():
            with plain_versions():
                rows_p, out_p = gen_rows(model, gen, tid, tool, req)
            errs[tool] = {"rows": rel_err(rows[tool], rows_p),
                          "last_forced_logits": rel_err(
                              last_forced_logits(core, outs[tool]),
                              last_forced_logits(core, out_p))}
        b1 = svcs["b1"]
        packed = region_packed(b1, img, *regions["box"])
        toks = torch.tensor([answers["b1", "box"]["ids"]], dtype=torch.int32,
                            device="cuda")
        n_tok = toks.shape[1]
        rows_k = region_rows(core, tid, packed)
        lk = teacher_forced(b1, *packed[:3], toks, n_tok,
                            regions=packed[3])[:, 0]
        with plain_versions():
            rows_p = region_rows(core, tid, packed)
            lp = teacher_forced(b1, *packed[:3], toks, n_tok,
                                regions=packed[3])[:, 0]
        if tuple(rows_k.shape) != (1, cfg.llm.hidden_size):
            raise AssertionError(f"flagship region rows {rows_k.shape}")
        errs["region"] = {
            "rows": rel_err(rows_k, rows_p),
            "first_step_logits": rel_err(lk[0], lp[0]),
            "teacher_forced_logits_max": max(rel_errs(lk, lp)),
            "chunked_first_step_vs_b1": rel_err(chunked_first_logits(
                svcs["slots"], img, *regions["box"]), lk[0])}
        other = region_packed(b1, img, *regions["other_box"])
        other_diff = rel_err(teacher_forced(b1, *other[:3], toks[:, :1], 1,
                                            regions=other[3])[0, 0], lk[0])
        for mode in ("spec", "slots_b1", "slots"):
            rules[mode] = near_tie_rule(f"flagship {mode}",
                                        answers[mode, "box"]["ids"],
                                        answers["b1", "box"]["ids"], lk)
        refs = {}
        for name, rg in follow_ups.items():
            (ref_ids, ref_logits), refs[name] = trace.call(
                lambda rg=rg, name=name: b1_reference(
                    b1, img, "tell me more", rg, history=hists[name]))
            refs[name]["first"] = ref_logits[0]
            rules["session:" + name] = near_tie_rule(
                f"flagship session {name}", answers["session", name]["ids"],
                ref_ids, ref_logits)
    trace.close()
    for k, e in errs.items():
        if not max(e.values()) <= LOGIT_REL_TOL:
            raise AssertionError(f"flagship {k} kernel vs plain {e} > "
                                 f"{LOGIT_REL_TOL}")
    # deterministic kernels: equal logits would mean the box went nowhere
    if not other_diff > 0:
        raise AssertionError("flagship: another box gave the same "
                             "first-step logits")
    region_path = check_region_path(seen, refs, lk[0], errs["region"]["rows"])

    # times
    timings = {"ttft_ms_regions": ttft_ms(b1, packed, True),
               "ttft_ms_no_regions": ttft_ms(b1, packed, False)}
    three = region_packed(b1, img, *regions["three"])
    prof = profile_region_request(b1, three)
    timings["region_encoder_cost"] = region_encoder_cost(
        core.region_encoder, FLAGSHIP_MAX_REGIONS, size,
        cfg.vis_encoder.hidden_size, cfg.vis_encoder.num_patches)
    timings["refill_gap_ms"] = region_refill_gap(
        svcs["slots"], img, *regions["box"], _Request(*svcs["slots"]._encode(
            filler["prompt"], None)[:2]))
    srv.shutdown()
    srv.server_close()
    for s in svcs.values():
        s.close()
    emit({"phase": "flagship", "config": "vllm_7b_config()",
          "nvidia_smi": nvidia_smi(),
          "params": sum(p.numel() for p in model.parameters()),
          "region_encoder_params": sum(
              p.numel() for p in core.region_encoder.parameters()),
          "build_model_s": build_s, "weights_gb": weights_gb,
          "image": list(FLAGSHIP_IMAGE), "max_regions": FLAGSHIP_MAX_REGIONS,
          "region_prompt_tokens": int(packed[0].shape[1]),
          "calls": calls, "launches": launches,
          "launches_per_call": {k: list(v) for k, v in want.items()},
          "answers": {f"{m}:{n}": a["ids"] for (m, n), a in answers.items()},
          "token_rules": rules, "plain_rel_err": errs,
          "other_box_first_step_rel_diff": other_diff,
          "region_path": region_path,
          "plain_rel_tol": LOGIT_REL_TOL, "micro_batching_refused": refused,
          "timings": timings,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t_phase})
    emit({"phase": "flagship_profile", "request": "three regions, B1",
          "bound_ms": timings["region_encoder_cost"]["bound_ms"], **prof})
    det = (det_ids, det_img, det_aug)
    convert = flagship_convert(model, cfg, tid, det, want)
    profiled = flagship_profiling(model, tid, det, want, flash_device_ms)
    with tempfile.TemporaryDirectory() as root:
        files = write_evalx_set(root)
        evalx = run_evalx(model, cfg, root, files)
        del model, core, pred, gen, svcs, rec, prof
        gc.collect()
        torch.cuda.empty_cache()
        evalx["cli"] = run_cli_eval(root, files)
    emit({**evalx, "nvidia_smi": nvidia_smi()})
    return launches, evalx["launches"], convert, profiled


# ---------------------------------------------------------------------------
# phase 20c: the semseg, interactive, region and det-variant evals of the
# flagship model, then the command line
# ---------------------------------------------------------------------------

# ADE20K-150's classes, in mmseg's `ADE20KDataset` order
ADE20K_CLASSES = (
    "wall", "building", "sky", "floor", "tree", "ceiling", "road", "bed",
    "windowpane", "grass", "cabinet", "sidewalk", "person", "earth", "door",
    "table", "mountain", "plant", "curtain", "chair", "car", "water",
    "painting", "sofa", "shelf", "house", "sea", "mirror", "rug", "field",
    "armchair", "seat", "fence", "desk", "rock", "wardrobe", "lamp",
    "bathtub", "railing", "cushion", "base", "box", "column", "signboard",
    "chest of drawers", "counter", "sand", "sink", "skyscraper",
    "fireplace", "refrigerator", "grandstand", "path", "stairs", "runway",
    "case", "pool table", "pillow", "screen door", "stairway", "river",
    "bridge", "bookcase", "blind", "coffee table", "toilet", "flower",
    "book", "hill", "bench", "countertop", "stove", "palm",
    "kitchen island", "computer", "swivel chair", "boat", "bar",
    "arcade machine", "hovel", "bus", "towel", "light", "truck", "tower",
    "chandelier", "awning", "streetlight", "booth", "television receiver",
    "airplane", "dirt track", "apparel", "pole", "land", "bannister",
    "escalator", "ottoman", "bottle", "buffet", "poster", "stage", "van",
    "ship", "fountain", "conveyer belt", "canopy", "washer", "plaything",
    "swimming pool", "stool", "barrel", "basket", "waterfall", "tent",
    "bag", "minibike", "cradle", "oven", "ball", "food", "step", "tank",
    "trade name", "microwave", "pot", "animal", "bicycle", "lake",
    "dishwasher", "screen", "blanket", "sculpture", "hood", "sconce",
    "vase", "traffic light", "tray", "ashcan", "fan", "pier", "crt screen",
    "plate", "monitor", "bulletin board", "shower", "radiator", "glass",
    "clock", "flag")
# (h, w) of the semseg images: ADE20K's validation sizes, 512 px short
EVALX_SEMSEG_SIZES = ((512, 683), (683, 512), (512, 683), (683, 512))
EVALX_IMAGES = 4              # images (or region rows) an eval
EVALX_REGION_NEW = 8          # tokens a region answer (--max-new-tokens)
EVALX_CLI_LIMIT = 2
EVALX_CLI_TIMEOUT_S = 600
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def gray_png_bytes(plane):
    """uint8 [H, W] as an 8-bit gray PNG (filter None on every row)."""
    h, w = plane.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), plane], axis=1)
    return (PNG_MAGIC
            + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0,
                                             0))
            + png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + png_chunk(b"IEND", b""))


def write_evalx_set(root):
    """`write_eval_set`'s COCO set, plus the semseg set (numpy seed 29,
    written without Pillow): `EVALX_SEMSEG_SIZES` RGB PNGs with gray label
    PNGs of ADE20K-150 ids (255 ignore; half the blocks in the 32
    prompted classes), read back through `load_label`; and a COCO-caption
    file of region captions over the COCO set's first objects."""
    files, _ = write_eval_set(root)
    rng = np.random.default_rng(29)
    rows = []
    for i, (h, w) in enumerate(EVALX_SEMSEG_SIZES):
        with open(os.path.join(root, f"ade_{i}.png"), "wb") as f:
            f.write(png_bytes(eval_image(rng, h, w)))
        label = np.full((h, w), 255, np.uint8)
        for k in range(16):
            y0, x0 = int(rng.integers(0, h - 64)), int(rng.integers(0, w - 64))
            label[y0:y0 + int(rng.integers(48, h // 2)),
                  x0:x0 + int(rng.integers(48, w // 2))] = rng.integers(
                0, 32 if k % 2 else len(ADE20K_CLASSES))
        path = os.path.join(root, f"ade_{i}_label.png")
        with open(path, "wb") as f:
            f.write(gray_png_bytes(label))
        if not np.array_equal(load_label(path), label):
            raise AssertionError(f"label PNG {i} does not read back")
        rows.append({"image": f"ade_{i}.png", "label": f"ade_{i}_label.png"})
    files["semseg"] = os.path.join(root, "ade20k_val.json")
    with open(files["semseg"], "w") as f:
        json.dump(rows, f)
    with open(files["instances"]) as f:
        raw = json.load(f)
    caps = [{"image_id": a["image_id"], "bbox": a["bbox"],
             "caption": f"a {COCO_CATEGORIES[k][1]} on the left"}
            for k, a in enumerate(a for a in raw["annotations"]
                                  if not a["iscrowd"]
                                  and min(a["bbox"][2:]) > 1)]
    files["region_caption"] = os.path.join(root, "region_captions.json")
    with open(files["region_caption"], "w") as f:
        json.dump({"images": raw["images"],
                   "annotations": caps[:EVALX_IMAGES]}, f)
    return files


def sample_inputs(sample, keys, device):
    """One dataset sample's `keys` arrays as B1 tensors on `device`."""
    return model_inputs({k: np.asarray(sample[k])[None] for k in keys},
                        device, keys)


def scaled_err(got, want, scale):
    """max |got - want| over max |scale|: the kernel phase's relative
    measure, for entries whose own norm is no scale."""
    return ((got.float() - want.float()).abs().max()
            / scale.float().abs().max()).item()


def det_vs_plain(model, tid, sample, num_classes, topk, device):
    """One det sample's forward with the kernels against the plain
    versions on the kernel run's proposals: the text queries, every logit
    of the valid text columns and the boxes, relative (Frobenius); then
    the kernel run's top-k detections by (query, label) in the two runs:
    their logits, as the largest difference over the largest plain logit
    of the valid columns (`scaled_err`: random weights put the top-k
    logits near 0, so their own norm is no scale), their boxes and mask
    logits relative. How far the plain run's own top-k shares those
    entries, and their largest score difference, are reported."""
    ids, images, aug, pm = sample_inputs(sample, E.MODEL_KEYS, device)
    with torch.no_grad():
        tq_k, mask_k = text_queries(model, ids, images, tid)
        out_k = model.gdino(aug, tq_k, mask_k, pixel_mask=pm)
        with plain_versions():
            tq_p, mask_p = text_queries(model, ids, images, tid)
            out_p = model.gdino(aug, tq_p, mask_p, pixel_mask=pm,
                                topk_idx=out_k["topk_idx"])
    if not torch.equal(mask_k, mask_p):
        raise AssertionError("text-query masks differ")
    n, cols = mask_k.shape[1], mask_k[0]
    post_k, post_p = (post_process_det(o["logits"], o["pred_boxes"],
                                       num_classes, topk)
                      for o in (out_k, out_p))
    q, lab = post_k["query_idx"][0], post_k["labels"][0]
    errs = {"text_queries": rel_err(tq_k, tq_p),
            "logits": rel_err(out_k["logits"][..., :n][..., cols],
                              out_p["logits"][..., :n][..., cols]),
            "pred_boxes": rel_err(out_k["pred_boxes"], out_p["pred_boxes"]),
            "topk_logits": scaled_err(
                out_k["logits"][0, q, lab], out_p["logits"][0, q, lab],
                out_p["logits"][..., :n][..., cols]),
            "topk_boxes": rel_err(out_k["pred_boxes"][0, q],
                                  out_p["pred_boxes"][0, q]),
            "topk_mask_logits": rel_err(out_k["pred_masks"][0, q],
                                        out_p["pred_masks"][0, q])}
    if not max(errs.values()) <= EVAL_REL_TOL:
        raise AssertionError(f"evalx kernel vs plain {errs}")
    keys = [set(zip(p["query_idx"][0].tolist(), p["labels"][0].tolist()))
            for p in (post_k, post_p)]
    score_err = (torch.sigmoid(out_k["logits"][0, q, lab].float())
                 - torch.sigmoid(out_p["logits"][0, q, lab].float())
                 ).abs().max().item()
    return {**errs, "topk": len(keys[0]),
            "topk_shared_with_plain": len(keys[0] & keys[1]),
            "topk_score_err": score_err}


def interactive_vs_plain(model, tid, sample, device):
    """One interactive sample with the kernels against the plain versions
    on the kernel run's proposals: the region slots' logits over every
    query and the boxes, relative; then each slot's pick (the query of
    its largest logit) in the kernel run: the picked logits in the two
    runs by `scaled_err` against the slots' largest plain logit, the
    picked boxes relative. How many slots the plain run picks alike, and
    the picked scores' largest difference, are reported."""
    ids, images, aug, pm, regions = sample_inputs(
        sample, ("input_ids", "image", "image_aug", "pixel_mask",
                 "regions"), device)
    R = sample["num_regions"]

    def run(choices=None):
        out = model.core(ids, images, tid, compute_logits=False,
                         regions=regions)
        tq, mask = model.core.extract_text_query(out["hidden"], ids, tid)
        return model.gdino(aug, tq, mask, pixel_mask=pm, **(choices or {}))

    with torch.no_grad():
        out_k = run()
        with plain_versions():
            out_p = run({"topk_idx": out_k["topk_idx"]})
    lk, lp = (o["logits"][0, :, :R].float() for o in (out_k, out_p))
    bk, bp = (box_cxcywh_to_xyxy(o["pred_boxes"][0].float())
              for o in (out_k, out_p))
    pick = lk.argmax(0)
    slots = torch.arange(R, device=lk.device)
    errs = {"logits": rel_err(lk, lp), "pred_boxes": rel_err(bk, bp),
            "picked_logits": scaled_err(lk[pick, slots], lp[pick, slots],
                                        lp),
            "picked_boxes": rel_err(bk[pick], bp[pick])}
    if not max(errs.values()) <= EVAL_REL_TOL:
        raise AssertionError(f"evalx interactive kernel vs plain {errs}")
    return {**errs, "regions": R,
            "same_picks": int((pick == lp.argmax(0)).sum()),
            "picked_score_err": (torch.sigmoid(lk[pick, slots])
                                 - torch.sigmoid(lp[pick, slots])
                                 ).abs().max().item()}


def region_vs_plain(core, tid, call):
    """The first region-eval answer: the generate call's tokens
    teacher-forced through the kernels and through the plain versions
    (`teacher_forced`: prefill with the regions, then decode steps), the
    per-step logits within LOGIT_REL_TOL, and the tokens by the near-tie
    rule against the plain run's argmax."""
    ids, images, regions, toks = call
    n = len(toks)
    svc = types.SimpleNamespace(core=core, tid=tid, max_prompt=ids.shape[1],
                                max_new_tokens=n)
    mask = torch.ones_like(ids, dtype=torch.bool)
    tokens = torch.tensor([toks], dtype=torch.int32, device=ids.device)
    with torch.no_grad():
        lk = teacher_forced(svc, ids, images, mask, tokens, n,
                            regions=regions)[:, 0]
        with plain_versions():
            lp = teacher_forced(svc, ids, images, mask, tokens, n,
                                regions=regions)[:, 0]
    rel = ((lk - lp).norm(dim=-1) / lp.norm(dim=-1)).tolist()
    if not max(rel) <= LOGIT_REL_TOL:
        raise AssertionError(f"evalx region logits: rel err {rel}")
    if int(lk[0].argmax()) != toks[0]:
        raise AssertionError("evalx region: the teacher-forced kernel run "
                             "disagrees with the generate call's first "
                             "token")
    return {"prompt_tokens": int(ids.shape[1]), "steps": n,
            "teacher_forced_rel_err": rel,
            "token_rule": near_tie_rule("evalx region", toks,
                                        lp.argmax(-1).tolist(), lp)}


def run_evalx(model, cfg, root, files):
    """The `evalx` phase's main path on the flagship model, with the
    launch counts taken around it alone, then its kernel-vs-plain gates
    on each eval's first sample. Returns the phase's line without the
    command line's part."""
    tok = SimpleTokenizer()
    tid = SpecialTokenIds.from_tokenizer(tok)
    device = next(model.parameters()).device
    size, itl = cfg.vis_encoder.image_size, cfg.image_token_len
    want = flagship_launches(cfg)
    calls, stage, first_region = [], ["semseg"], []
    real_infer = model.infer_det

    def infer_det(*a, **k):
        f0, m0 = A.flash_attention.launches, M.ms_deform_attn.launches
        out = real_infer(*a, **k)
        got = (A.flash_attention.launches - f0,
               M.ms_deform_attn.launches - m0)
        calls.append({"eval": stage[0], "B": int(a[0].shape[0]),
                      "flash_attn_fwd": got[0],
                      "ms_deform_attn_fwd": got[1]})
        if got != want["infer_det"]:
            raise AssertionError(f"evalx {stage[0]}: infer_det launches "
                                 f"{got}, want {want['infer_det']}")
        return out

    gen = build_generate_fn(model.core, tid, max_new_tokens=EVALX_REGION_NEW,
                            eos_id=tok.eos_token_id, max_len=EVAL_VQA_MAX_LEN)

    def region_gen(ids, images, **kw):
        f0, m0 = A.flash_attention.launches, M.ms_deform_attn.launches
        out = gen(ids, images, **kw)
        got = (A.flash_attention.launches - f0,
               M.ms_deform_attn.launches - m0)
        calls.append({"eval": stage[0], "B": int(ids.shape[0]),
                      "flash_attn_fwd": got[0],
                      "ms_deform_attn_fwd": got[1]})
        if got != want["region_b1"]:
            raise AssertionError(f"evalx {stage[0]}: generate launches "
                                 f"{got}, want {want['region_b1']}")
        if not first_region:
            first_region.append((ids, images, kw["regions"], out[
                "out_tokens"][0, :int(out["num_generated"])].tolist()))
        return out

    common = dict(image_token_len=itl, image_size=size, test_mode=True)
    sem = SemSegDataset(files["semseg"], root, tok,
                        class_names=list(ADE20K_CLASSES), **common)
    inter = CocoInteractiveDataset(files["instances"], root, tok, **common)
    sod = SodDetDataset(files["instances"], root, tok, **common)
    odinw = OdinwDetDataset(files["instances"], root, tok, **common)
    metrics, seconds = {}, {}
    model.infer_det = infer_det
    A.flash_attention.launches = 0
    M.ms_deform_attn.launches = 0
    try:
        t = time.perf_counter()
        metrics["semseg"] = evaluate_semseg(model, sem, tid)
        seconds["semseg"] = time.perf_counter() - t
        stage[0] = "interactive"
        t = time.perf_counter()
        metrics["interactive"] = evaluate_interactive(model, inter, tid,
                                                      limit=EVALX_IMAGES)
        seconds["interactive"] = time.perf_counter() - t
        for task, ann in (("region-caption", files["region_caption"]),
                          ("region-recognition", files["instances"])):
            stage[0] = task
            t = time.perf_counter()
            rows = RE.TASKS[task][0](ann, root, limit=EVALX_IMAGES)
            metrics[task] = RE.run_region_eval(task, region_gen, cfg, tok,
                                               rows, device=device)
            metrics[task].pop("predictions", None)
            seconds[task] = time.perf_counter() - t
        for name, ds, with_mask in (("sod_det", sod, True),
                                    ("odinw_det", odinw, False)):
            stage[0] = name
            t = time.perf_counter()
            metrics[name] = evaluate_det(
                model, ds, tid, with_mask=with_mask, topk=EVAL_TOPK,
                limit=EVALX_IMAGES, batch_size=EVALX_IMAGES, progress=False)
            seconds[name] = time.perf_counter() - t
        torch.cuda.synchronize()
    finally:
        del model.infer_det
    launches = {"flash_attn_fwd": A.flash_attention.launches,
                "ms_deform_attn_fwd": M.ms_deform_attn.launches}
    for name, res in metrics.items():
        # COCO's area ranges without a ground truth read NaN
        if not res or not all(np.isfinite(v) for k, v in res.items()
                              if not k.endswith(("_s", "_m", "_l"))):
            raise AssertionError(f"evalx {name}: {res}")
    by_eval = {}
    for c in calls:
        by_eval.setdefault(c["eval"], []).append(c["B"])
    if [len(by_eval.get(k, ())) for k in metrics] != \
            [EVALX_IMAGES] * 2 + [EVALX_IMAGES] * 2 + [1, 1]:
        raise AssertionError(f"evalx calls {by_eval}")

    t = time.perf_counter()
    gates = {"semseg": det_vs_plain(model, tid, sem[0],
                                    len(ADE20K_CLASSES),
                                    min(100, 4 * len(ADE20K_CLASSES)),
                                    device),
             "interactive": interactive_vs_plain(model, tid, inter[0],
                                                 device),
             "region": region_vs_plain(model.core, tid, first_region[0]),
             "sod_det": det_vs_plain(model, tid, sod[0], 1, EVAL_TOPK,
                                     device),
             "odinw_det": det_vs_plain(model, tid, odinw[0],
                                       len(odinw.class_names), EVAL_TOPK,
                                       device)}
    seconds["gates"] = time.perf_counter() - t
    return {"phase": "evalx", "config": "vllm_7b_config()",
            "images": EVALX_IMAGES,
            "semseg_sizes": [list(s) for s in EVALX_SEMSEG_SIZES],
            "semseg_classes": len(ADE20K_CLASSES),
            "semseg_prompted": len(sem[0]["img_metas"]["class_ids"]),
            "semseg_prompt_tokens": len(sem[0]["input_ids"]),
            "interactive_regions": [inter[i]["num_regions"]
                                    for i in range(EVALX_IMAGES)],
            "metrics": metrics, "seconds": seconds,
            "calls_by_eval": by_eval, "launches": launches,
            "launches_per_call": {"infer_det": list(want["infer_det"]),
                                  "region_generate": list(
                                      want["region_b1"])},
            "plain_rel_err": gates, "rel_tol": EVAL_REL_TOL,
            "logit_rel_tol": LOGIT_REL_TOL}


def run_cli_eval(root, files):
    """`python3 -m visionllm_tpu_torch.cli eval-interactive` in a process
    of its own, on the card by default: it builds `vllm_7b_config()`
    itself, must exit 0 and print one JSON line with `region_acc@0.5`;
    its stderr's timings line gives its build and eval seconds."""
    argv = ["-m", "visionllm_tpu_torch.cli", "eval-interactive", "--ann",
            files["instances"], "--imgs", root, "--limit",
            str(EVALX_CLI_LIMIT)]
    t = time.perf_counter()
    res = subprocess.run([sys.executable, *argv], cwd=REPO_ROOT,
                         capture_output=True, text=True,
                         timeout=EVALX_CLI_TIMEOUT_S)
    wall = time.perf_counter() - t
    if res.returncode != 0:
        raise AssertionError(f"the CLI exited {res.returncode}: "
                             f"{res.stderr[-3000:]}")
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    out = json.loads(lines[-1])
    if set(out) != {"region_acc@0.5"} or \
            not 0.0 <= out["region_acc@0.5"] <= 1.0:
        raise AssertionError(f"the CLI printed {lines[-1]!r}")
    timings = next(json.loads(ln)["timings"] for ln in reversed(
        res.stderr.splitlines()) if ln.startswith('{"timings"'))
    return {"argv": argv, "exit": res.returncode, "json": out,
            "wall_s": wall, **timings}


# ---------------------------------------------------------------------------
# phases 20a-20b: the flagship written out as a reference checkpoint and
# converted back (`convert`), and the profiling harness (`profiling`)
# ---------------------------------------------------------------------------

# the part of the written checkpoint that also goes through files: the
# region encoder, both mappers and Grounding-DINO
CONVERT_FILE_PREFIXES = ("region_encoder.", "gdino.", "sd.emb_proj.",
                         "sd.llm2sd_mapper", "ip2p.emb_proj.",
                         "ip2p.llm2sd_mapper")
# fit_device_time's flash case: LLaMA-7B's prefill (the kernel phase's
# `llama7b_prefill`), B1 L586, 32 heads of 128, causal
FIT_FLASH_CASE = (1, 586, 32, 128)
# the port's kernel names in a trace's kernel events, by launch counter
TRACE_KERNELS = {"flash_attn_fwd": "flash_fwd_kernel",
                 "ms_deform_attn_fwd": "msda_fwd_kernel"}


class HostRssPeak:
    """The largest resident set of this process while the block runs,
    read from /proc/self/statm by a thread every `period_s`."""

    def __init__(self, period_s=0.005):
        self.period_s = period_s
        self.peak = self.start = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)

    @staticmethod
    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _watch(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, self.rss())
            time.sleep(self.period_s)

    def __enter__(self):
        self.peak = self.start = self.rss()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(10)
        self.peak = max(self.peak, self.rss())


def same_tensors(what, got, want):
    """Raise unless `got` and `want` hold the same keys and each tensor
    the same dtype, shape and values, bit for bit (compared on `got`'s
    device). Returns the number of tensors."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: keys differ: "
                             f"{sorted(set(got) ^ set(want))[:10]}")
    bad = [k for k, w in want.items() if got[k].dtype != w.dtype
           or got[k].shape != w.shape
           or not torch.equal(got[k], w.to(got[k].device))]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} of {len(want)} tensors "
                             f"differ: {bad[:10]}")
    return len(want)


def flagship_convert(model, cfg, tid, det, want):
    """The flagship phase's `convert` check (see the module docstring):
    the model written out under the reference's key names as copies on
    the card, converted back into a second model laid out on the meta
    device, every tensor and an `infer_det` bit for bit; then the region
    encoder, the mappers and Grounding-DINO through .safetensors and .bin
    files. Returns the converted model's `infer_det` launches."""
    t_check = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    with torch.no_grad():
        ref_out = model.infer_det(*det, tid)
    state = model.state_dict()
    secs = {}
    with HostRssPeak() as rss:
        t = time.perf_counter()
        ckpt = RL.write_composite(state, cfg)
        torch.cuda.synchronize()
        secs["write_out"] = time.perf_counter() - t
        t = time.perf_counter()
        rec = ReadRecorder(ckpt)
        conv = convert_composite(rec, cfg)
        secs["convert"] = time.perf_counter() - t
        t = time.perf_counter()
        loaded = build_model(cfg, dtype=torch.bfloat16, state_dict=conv)
        torch.cuda.synchronize()
        secs["load"] = time.perf_counter() - t
    unread = rec.unread()
    if unread:
        raise AssertionError(f"convert: {len(unread)} keys unread: "
                             f"{unread[:10]}")
    allowlisted = rec.unread(lambda k: False)
    check_param_dtypes(loaded, "convert")
    t = time.perf_counter()
    n_equal = same_tensors("convert: the converted model",
                           loaded.state_dict(), state)
    secs["compare"] = time.perf_counter() - t
    A.flash_attention.launches = 0
    M.ms_deform_attn.launches = 0
    with torch.no_grad():
        out = loaded.infer_det(*det, tid)
    torch.cuda.synchronize()
    launches = {"flash_attn_fwd": A.flash_attention.launches,
                "ms_deform_attn_fwd": M.ms_deform_attn.launches}
    if tuple(launches.values()) != want["infer_det"]:
        raise AssertionError(f"convert: infer_det launches {launches}, "
                             f"want {want['infer_det']}")
    outs = {k: v for k, v in ref_out.items() if isinstance(v, torch.Tensor)}
    same_tensors("convert: infer_det on the converted model",
                 {k: out[k] for k in outs}, outs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ckpt_bytes = sum(v.untyped_storage().nbytes() for v in ckpt.values())

    # part of the checkpoint through files, read by load_state_dict_files
    host = {k: v.cpu() for k, v in ckpt.items()
            if k.startswith(CONVERT_FILE_PREFIXES)}
    checks = {"gdino.": (lambda sd: convert_gdino(sd, cfg.gdino, "gdino."),
                         model.gdino),
              "region_encoder.": (convert_region_encoder,
                                  model.core.region_encoder),
              "sd.": (lambda sd: convert_llm2sd_mapper(sd, "sd."),
                      model.sd.mapper),
              "ip2p.": (lambda sd: convert_llm2sd_mapper(sd, "ip2p."),
                        model.ip2p.mapper)}
    files = {}
    with tempfile.TemporaryDirectory() as root:
        for name, write in (("part.safetensors", RL.save_safetensors),
                            ("part.bin", torch.save)):
            path = os.path.join(root, name)
            t = time.perf_counter()
            write(host, path)
            write_s = time.perf_counter() - t
            t = time.perf_counter()
            back = load_state_dict_files(path)
            same_tensors(f"convert: {name} read back", back, host)
            for what, (fn, module) in checks.items():
                same_tensors(f"convert: {what} from {name}", fn(back),
                             module.state_dict())
            files[name] = {"bytes": os.path.getsize(path),
                           "write_s": write_s,
                           "read_convert_compare_s": time.perf_counter() - t}
    result = {
        "phase": "convert", "config": "vllm_7b_config()",
        "nvidia_smi": nvidia_smi(),
        "params": sum(p.numel() for p in loaded.parameters()),
        "checkpoint_keys": len(ckpt), "checkpoint_gb": ckpt_bytes / 1e9,
        "allowlisted_unread": len(allowlisted), "unread": unread,
        "tensors_equal": n_equal,
        "infer_det_equal": sorted(outs), "launches": launches,
        "seconds": secs, "files": {**files, "keys": len(host)},
        "resident_before_gb": resident_gb, "peak_mem_gb": peak_gb,
        "host_rss_gb": {"before": rss.start / 1e9, "peak": rss.peak / 1e9},
        "check_s": time.perf_counter() - t_check}
    del loaded, conv, rec, ckpt, state, host, out, ref_out
    gc.collect()
    torch.cuda.empty_cache()
    emit(result)
    return launches


def trace_kernel_counts(log_dir):
    """Kernel events of the one Chrome trace under `log_dir` that name
    each of `TRACE_KERNELS`, and the trace's size."""
    paths = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    if len(paths) != 1:
        raise AssertionError(f"profiling: {len(paths)} traces written")
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events
               if e.get("cat") == "kernel"]
    return ({k: sum(name in e for e in kernels)
             for k, name in TRACE_KERNELS.items()},
            {"bytes": os.path.getsize(paths[0]), "events": len(events),
             "kernel_events": len(kernels)})


def flagship_profiling(model, tid, det, want, kernel_device_ms):
    """The flagship phase's `profiling` check (see the module docstring):
    one `infer_det` under `profiling.trace`, one under
    `profiling.debug_nans`, and `fit_device_time` of the flash forward,
    printed beside the kernel phase's `device_ms` of the same case
    (`kernel_device_ms`, None when the kernel phase did not run: a
    profiler context this late in the process has lost its device events
    before). Returns the launches of the two requests."""
    t_check = time.perf_counter()
    A.flash_attention.launches = 0
    M.ms_deform_attn.launches = 0
    with tempfile.TemporaryDirectory() as log_dir:
        t = time.perf_counter()
        with torch.no_grad(), profiling.trace(log_dir):
            model.infer_det(*det, tid)
            torch.cuda.synchronize()
        trace_s = time.perf_counter() - t
        in_trace, trace_file = trace_kernel_counts(log_dir)
    if tuple(in_trace.values()) != want["infer_det"]:
        raise AssertionError(f"profiling: the trace names {in_trace}, want "
                             f"{want['infer_det']}")
    t = time.perf_counter()
    with torch.no_grad(), profiling.debug_nans(model):
        out = model.infer_det(*det, tid)
        torch.cuda.synchronize()
    debug_nans_s = time.perf_counter() - t
    launches = {"flash_attn_fwd": A.flash_attention.launches,
                "ms_deform_attn_fwd": M.ms_deform_attn.launches}
    if tuple(launches.values()) != tuple(2 * n for n in want["infer_det"]):
        raise AssertionError(f"profiling: launches {launches}, want 2 x "
                             f"{want['infer_det']}")
    if not all(torch.isfinite(v).all() for k, v in out.items()
               if k in ("logits", "pred_boxes")):
        raise AssertionError("profiling: infer_det under debug_nans")

    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(*FIT_FLASH_CASE, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(3))

    def chained(q, k, v, carry):
        return A.flash_attention(q, k, v, causal=True)[0, 0] + carry

    fit_ms = profiling.fit_device_time(chained, q, k, v) * 1e3
    if not (math.isfinite(fit_ms) and fit_ms > 0):
        raise AssertionError(f"profiling: fit_device_time {fit_ms} ms")
    emit({"phase": "profiling", "nvidia_smi": nvidia_smi(),
          "trace_kernel_events": in_trace, "trace_file": trace_file,
          "trace_request_s": trace_s, "debug_nans_request_s": debug_nans_s,
          "launches": launches,
          "fit_device_time": {"case": list(FIT_FLASH_CASE), "causal": True,
                              "ms": fit_ms,
                              "kernel_phase_device_ms": kernel_device_ms},
          "check_s": time.perf_counter() - t_check})
    return launches


# ---------------------------------------------------------------------------
# phases 21-22: the 26B flagship's det path at full width and depth
# ---------------------------------------------------------------------------

def det26b_prompt_ids(tok, image_tokens, cfg):
    """The det prompt (`DET26B_CLASSES`, one [DET][EMB x4] block each)
    with `image_tokens` <im_patch> ids, as the training dataset counts
    them: 256 a 448 px tile after pixel shuffle."""
    q, a = det_prompt(DET26B_CLASSES, cfg.num_embs)
    tok_out = preprocess(
        preprocess_multimodal([[{"from": "human", "value": q},
                                {"from": "gpt", "value": a}]]), tok,
        version="v1", has_image=True, image_token_len=image_tokens,
        model_max_length=4096)
    return np.asarray(tok_out["input_ids"][0], np.int64)


def det26b_prompt_lengths():
    """Prompt lengths of the two det26b requests (host only)."""
    cfg, tok = vllm_26b_config(), SimpleTokenizer()
    per = cfg.image_token_len                   # after pixel shuffle
    return {name: len(det26b_prompt_ids(tok, n * per, cfg))
            for name, n in DET26B_TILES.items()}


def det26b_requests(cfg, tok):
    """The det26b phase's requests on the card: an 800x1088 uint8 image
    (numpy seed 4) as a `dynamic_preprocess` tile stack [1, 7, 448, 448,
    3] (each tile through `clip_preprocess(..., mode="resize")`, as the
    dataset's anyres branch does) and as one padded 448 px tile [1, 448,
    448, 3]; the det image `det_test_transform` gives (the 800x1088
    bucket). Returns {name: (ids [1, L], images, aug, pixel_mask)}."""
    img = np.random.RandomState(4).randint(0, 256, DET26B_IMAGE, np.uint8)
    size = cfg.vis_encoder.image_size
    tiles = dynamic_preprocess(img, image_size=size, max_num=6)
    pix = {"tiles7": np.stack([clip_preprocess(t, size, mode="resize")
                               for t in tiles])[None],
           "tile1": clip_preprocess(img, size)[None]}
    sample = det_test_transform(
        {"image": img.astype(np.float32),
         "boxes": np.zeros((0, 4), np.float32),
         "labels": np.zeros((0,), np.int32)}, TEST_SCALE, DEFAULT_BUCKETS)
    aug = torch.from_numpy(sample["image"][None]).to("cuda", torch.bfloat16)
    pm = torch.from_numpy(sample["pixel_mask"][None]).to("cuda")
    per = cfg.image_token_len                   # after pixel shuffle
    reqs = {}
    for name, n in DET26B_TILES.items():
        if n != (pix[name].shape[1] if pix[name].ndim == 5 else 1):
            raise AssertionError(f"{name}: {pix[name].shape} is not {n} "
                                 "tiles")
        ids = torch.from_numpy(det26b_prompt_ids(tok, n * per, cfg))[None]
        reqs[name] = (ids.to("cuda"), torch.from_numpy(pix[name]).to(
            "cuda", torch.bfloat16), aug, pm)
    return reqs


def near_tie_rule(what, ids, plain_ids, plain_logits):
    """The card's token rule: greedy tokens `ids` against the plain run's
    `plain_ids`, chosen by `plain_logits` [n, V]: equal, or differing
    first where the plain run's top-2 logit gap is within NEAR_TIE_ULPS
    bf16 ulps of its top logit."""
    res = {"identical": ids == plain_ids}
    if not res["identical"]:
        p = next((i for i, (a, b) in enumerate(zip(ids, plain_ids))
                  if a != b), min(len(ids), len(plain_ids)))
        top2 = plain_logits[min(p, len(plain_logits) - 1)].topk(2).values \
            .tolist()
        gap, ulps = top2[0] - top2[1], NEAR_TIE_ULPS * bf16_ulp(top2[0])
        res.update(first_difference=p, plain_top2_gap=gap, near_tie=ulps)
        if not (p < len(plain_logits) and gap <= ulps):
            raise AssertionError(f"{what} tokens differ from the plain "
                                 f"loop's at {p} with no near-tie: {res}")
    return res


def decode_step_ms(core, ids, images, max_len, n=DET26B_DECODE):
    """Median wall ms of one B1 greedy decode step (`llm_step`) after a
    prefill of `ids`, each step synced; then one more step under
    torch.profiler (printed as the `det26b_decode_profile` phase)."""
    cache = core.new_cache(1, max_len)
    tid = SpecialTokenIds.synthetic()
    out = core(ids, images, tid, cache=cache)
    tok = out["logits"][:, -1].argmax(-1)
    ts = []
    for _ in range(n):
        e = core.embed_tokens(tok[:, None])
        pos = torch.full((1, 1), cache.index, dtype=torch.long,
                         device=ids.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        tok = core.llm_step(e, pos, cache)["logits"][:, -1].argmax(-1)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    e = core.embed_tokens(tok[:, None])
    pos = torch.full((1, 1), cache.index, dtype=torch.long, device=ids.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        core.llm_step(e, pos, cache)["logits"][:, -1].argmax(-1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    emit({"phase": "det26b_decode_profile", "cache_len": cache.index,
          **device_summary(prof, wall_ms)})
    return statistics.median(ts)


def check_param_dtypes(model, what):
    """Every parameter on the card, bf16 but for `fp32_modules`; returns
    the fp32 parameters' ids."""
    fp32 = {id(p) for m in model.fp32_modules() for p in m.parameters()}
    for name, p in model.named_parameters():
        dt = torch.float32 if id(p) in fp32 else torch.bfloat16
        if p.dtype != dt or p.device.type != "cuda":
            raise AssertionError(f"{what}: {name} is {p.dtype} on "
                                 f"{p.device}, want {dt} on the card")
    return fp32


def run_det26b():
    """The det26b phase and its sections: see the module docstring.
    Nothing else is resident: the earlier phases' models are freed
    before it. Returns the launches of every section's main path."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    cfg = vllm_26b_config()
    predicted = model_size(cfg)
    tid = SpecialTokenIds.synthetic()
    t = time.perf_counter()
    model = build_model(cfg, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    check_param_dtypes(model, "det26b")
    build = {"config": "vllm_26b_config()",
             "params": sum(p.numel() for p in model.parameters()),
             "predicted_params": predicted["params"],
             "weights_gb": torch.cuda.memory_allocated() / 1e9,
             "predicted_weights_gb": predicted["bytes"] / 1e9,
             "param_dtypes": sorted({str(p.dtype) for p in
                                     model.parameters()}),
             "build_model_s": time.perf_counter() - t,
             "resident_before_gb": resident_gb}
    if build["params"] != predicted["params"]:
        raise AssertionError(f"det26b: {build['params']} parameters, the "
                             f"host count says {predicted['params']}")
    peaks = {"build": torch.cuda.max_memory_allocated() / 1e9}
    seconds, totals = {}, {}

    def section(name, fn):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for k, v in fn().items():
            totals[k] = totals.get(k, 0) + v
        seconds[name] = time.perf_counter() - t0
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        gc.collect()
        torch.cuda.empty_cache()
        if peaks[name] * 1e9 >= DET26B_PEAK_LIMIT:
            raise AssertionError(f"det26b {name}: peak {peaks[name]} GB, "
                                 f"at or past {DET26B_PEAK_LIMIT / 1e9} GB")

    if peaks["build"] * 1e9 >= DET26B_PEAK_LIMIT:
        raise AssertionError(f"det26b: the build peaked at {peaks['build']} "
                             "GB")
    section("convert26", lambda: det26b_convert(model, cfg))
    section("det", lambda: det26b_det(model, cfg, tid, build))
    section("predictor", lambda: det26b_predictor(model, cfg))
    section("gen", lambda: det26b_gen(model, cfg, tid))
    section("regions", lambda: det26b_regions(model, cfg, tid))
    section("chat_bf16", lambda: det26b_chat(model, cfg, "bf16"))
    section("chat_int4", lambda: det26b_chat(model, cfg, "int4"))
    emit({"phase": "det26b_whole", "nvidia_smi": nvidia_smi(), **build,
          "launches": totals, "peak_mem_gb": peaks,
          "peak_limit_gb": DET26B_PEAK_LIMIT / 1e9,
          "section_seconds": seconds,
          "seconds": time.perf_counter() - t_phase})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def det26b_convert(model, cfg):
    """The det26b phase's `convert26` section (see the module docstring):
    each of InternViT-6B's and InternLM2-20B's layers written out under
    the reference's key names (InternLM2's q / k / v packed into `wqkv`
    at 48 heads over 8) and converted back bit for bit, one layer at a
    time; then the embeddings, the final norm and the head, the
    `internvl_mlp` bridge and the region encoder; and the InternImage
    tools' named error. Launches no kernel."""
    t_section = time.perf_counter()
    core = model.core
    secs, layers = {}, {}
    with HostRssPeak() as rss:
        for name, stack, write, convert, c, prefix in (
                ("intern_vit", core.vis_encoder.layers,
                 RL.write_intern_vit_layer, convert_intern_vit_layer,
                 cfg.vis_encoder, "vis_encoder."),
                ("internlm2", core.llm.layers, RL.write_internlm2_layer,
                 convert_internlm2_layer, cfg.llm, "llm.model.")):
            t = time.perf_counter()
            for i, layer in enumerate(stack):
                state = layer.state_dict()
                rec = ReadRecorder(write(state, c, i, prefix))
                same_tensors(f"convert26: {name} layer {i}",
                             convert(rec, c, i, prefix), state)
                if rec.unread(lambda k: False):
                    raise AssertionError(f"convert26: {name} layer {i} left "
                                         f"{rec.unread(lambda k: False)}")
                del rec
            torch.cuda.synchronize()
            secs[name + "_layers"] = time.perf_counter() - t
            layers[name] = len(stack)
        t = time.perf_counter()
        vis = {k: v for k, v in core.vis_encoder.state_dict().items()
               if not k.startswith("layers.")}
        top = dataclasses.replace(cfg.vis_encoder, num_layers=0)
        ref = RL.write_intern_vit(vis, top, "vis_encoder.")
        same_tensors("convert26: InternViT's embeddings",
                     convert_intern_vit(ref, top, "vis_encoder."), vis)
        llm = {k: v for k, v in core.llm.state_dict().items()
               if not k.startswith("layers.")}
        top = dataclasses.replace(cfg.llm, num_layers=0)
        ref = RL.write_internlm2(llm, top, "llm.model.")
        same_tensors("convert26: InternLM2's embeddings, norm and output",
                     convert_internlm2(ref, top, "llm.model."), llm)
        del ref
        for what, module, write, convert in (
                ("internvl_mlp", core.vl_bridge, RL.write_vl_bridge,
                 convert_vl_bridge),
                ("region encoder", core.region_encoder,
                 RL.write_region_encoder, convert_region_encoder)):
            state = module.state_dict()
            same_tensors(f"convert26: {what}", convert(write(state)), state)
        torch.cuda.synchronize()
        secs["top"] = time.perf_counter() - t
    refused = {}
    for tool, fn in (("gdino", lambda: convert_gdino({}, cfg.gdino,
                                                     "gdino.")),
                     ("unipose", lambda: convert_unipose({}, cfg.unipose,
                                                         "unipose."))):
        try:
            fn()
        except ValueError as e:
            refused[tool] = str(e)
        backbone = getattr(cfg, tool).backbone
        if backbone not in refused.get(tool, ""):
            raise AssertionError(f"convert26: {tool} on {backbone} gave "
                                 f"{refused.get(tool)!r}")
    emit({"phase": "convert26", "config": "vllm_26b_config()",
          "layers": layers, "heads": [cfg.llm.num_heads,
                                      cfg.llm.num_kv_heads],
          "hidden": cfg.llm.hidden_size, "seconds": secs,
          "host_rss_gb": {"before": rss.start / 1e9, "peak": rss.peak / 1e9},
          "refused": refused, "nvidia_smi": nvidia_smi(),
          "section_s": time.perf_counter() - t_section})
    return {}


def det26b_det(model, cfg, tid, build):
    """The det section: the det requests through `infer_det`, the plain
    run and the fp32 witness, the decode, the timings (the `det26b` line)
    and the profiles. Returns its main path's launches."""
    tok = SimpleTokenizer()
    reqs = det26b_requests(cfg, tok)
    backbone = model.gdino.backbone.cfg
    per_req = {"flash_attn_fwd": cfg.vis_encoder.num_layers
               + cfg.llm.num_layers,
               "ms_deform_attn_fwd": sum(backbone.depths)
               + cfg.gdino.encoder_layers + cfg.gdino.decoder_layers}
    Q, T = cfg.gdino.num_queries, cfg.gdino.max_text_len
    side = tuple(s // 4 for s in DET26B_IMAGE[:2])

    # the main path, with the launch counts taken around it alone
    A.flash_attention.launches = 0
    M.ms_deform_attn.launches = 0
    outs, calls = {}, []
    with torch.no_grad():
        for name, (ids, images, aug, pm) in reqs.items():
            for _ in range(1 + DET26B_REPEATS):
                f0, m0 = A.flash_attention.launches, M.ms_deform_attn.launches
                outs[name] = model.infer_det(ids, images, aug, tid,
                                             pixel_mask=pm)
                calls.append({"request": name,
                              "flash_attn_fwd": A.flash_attention.launches
                              - f0, "ms_deform_attn_fwd":
                              M.ms_deform_attn.launches - m0})
        gen = build_generate_fn(model.core, tid,
                                max_new_tokens=DET26B_DECODE,
                                max_len=DET26B_MAX_LEN)
        ids7, images7 = reqs["tiles7"][:2]
        chat_ids = ids7[:, :int((ids7[0] == tid.det).nonzero()[0])]
        f0 = A.flash_attention.launches
        gen_k = gen(chat_ids, images7)
        gen_flash = A.flash_attention.launches - f0
    torch.cuda.synchronize()
    launches = {"flash_attn_fwd": A.flash_attention.launches,
                "ms_deform_attn_fwd": M.ms_deform_attn.launches}
    for c in calls:
        if any(c[k] != per_req[k] for k in per_req):
            raise AssertionError(f"det26b launches {c} != {per_req}")
    if gen_flash != per_req["flash_attn_fwd"]:
        raise AssertionError(f"det26b generate: {gen_flash} flash launches")
    for name, out in outs.items():
        for key, shape in (("logits", (1, Q, T)), ("pred_boxes", (1, Q, 4)),
                           ("pred_masks", (1, Q) + side)):
            x = out[key]
            if tuple(x.shape) != shape or not torch.isfinite(x).all():
                raise AssertionError(f"det26b {name} {key}: shape "
                                     f"{tuple(x.shape)} vs {shape}, finite "
                                     f"{bool(torch.isfinite(x).all())}")
        if not ((out["pred_boxes"] >= 0) & (out["pred_boxes"] <= 1)).all():
            raise AssertionError(f"det26b {name}: boxes outside [0, 1]")

    # the main path's outputs against the plain versions on the same
    # weights: text queries, tool outputs; the core and Grounding-DINO in
    # fp32 as their witness
    errs, gdino_alone, runs = {}, {}, {}
    with torch.no_grad():
        for name, req in reqs.items():
            r, runs[name] = tool_vs_plain(model, tid, "gdino", req,
                                          outs[name])
            fp32_text_queries(model, tid, runs[name])
            errs[name] = e = {"text_queries": r["text_queries"],
                              **r["end_to_end"]}
            gdino_alone[name] = r["tool"]
            if not max(e.values()) <= DET26B_REL_TOL:
                raise AssertionError(f"det26b {name} kernel vs plain {e} > "
                                     f"{DET26B_REL_TOL}")
        g32 = copy.deepcopy(model.gdino).float()
        witness = {name: fp32_witness(model, "gdino", runs.pop(name), g32)
                   for name in reqs}
        kernel_ids = gen_k["out_tokens"][0].tolist()
        with plain_versions():
            plain_ids = gen(chat_ids, images7)["out_tokens"][0].tolist()
            plain_logits = window_teacher_forced(
                model.core, tid, chat_ids, images7,
                torch.ones_like(chat_ids, dtype=torch.bool), plain_ids, 1,
                DET26B_MAX_LEN)
    del g32
    gc.collect()
    torch.cuda.empty_cache()
    decode_rule = near_tie_rule("det26b decode", kernel_ids, plain_ids,
                                plain_logits)

    # warm timings: each request and its stages (host clock, synced)
    timings = {}
    with torch.no_grad():
        for name, (ids, images, aug, pm) in reqs.items():
            embeds, _ = model.core.build_prompt_embeds(ids, images, tid)
            pos = torch.arange(ids.shape[1], device=ids.device)[None]
            tq, tq_mask = text_queries(model, ids, images, tid)
            timings[name] = {
                "request_ms_median": host_ms(lambda: model.infer_det(
                    ids, images, aug, tid, pixel_mask=pm),
                    n=DET26B_REPEATS),
                "vision_ms": host_ms(lambda: model.core.encode_images(
                    images), n=DET26B_REPEATS),
                "prefill_ms": host_ms(lambda: model.core.llm(
                    embeds, pos, compute_logits=False), n=DET26B_REPEATS),
                "gdino_ms": host_ms(lambda: model.gdino(
                    aug, tq, tq_mask, pixel_mask=pm), n=DET26B_REPEATS),
                "prompt_tokens": int(ids.shape[1])}
        step_ms = decode_step_ms(model.core, chat_ids, images7,
                                 DET26B_MAX_LEN)
    emit({"phase": "det26b", "config": build["config"],
          "image": list(DET26B_IMAGE), "tiles": DET26B_TILES,
          "params": build["params"], "param_dtypes": build["param_dtypes"],
          "weights_gb": build["weights_gb"],
          "resident_before_gb": build["resident_before_gb"],
          "build_model_s": build["build_model_s"],
          "calls": calls, "launches": launches,
          "launches_per_request": per_req, "timings": timings,
          "plain_rel_err": errs, "plain_rel_tol": DET26B_REL_TOL,
          "plain_msda_on_kernel_queries_rel_err": gdino_alone,
          "fp32_witness_rel_err": witness,
          "fp32_witness_ratio": DET26B_WITNESS_RATIO,
          "decode": {"prompt_tokens": int(chat_ids.shape[1]),
                     "new_tokens": DET26B_DECODE, "kernel_ids": kernel_ids,
                     "plain_ids": plain_ids, **decode_rule,
                     "flash_per_generate": gen_flash,
                     "step_ms_median": step_ms},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    for name in DET26B_TILES:
        with torch.no_grad(), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            ids, images, aug, pm = reqs[name]
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.infer_det(ids, images, aug, tid, pixel_mask=pm)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        emit({"phase": "det26b_profile", "request": name,
              **device_summary(prof, wall_ms)})
    return launches


@contextmanager
def fp32_core(core):
    """`core` in fp32 while the context is open: each block of its
    ModuleLists (the ViT's and the LLM's layers) widened only while it
    runs, the rest at once, so that the weights never stand in fp32 all
    together; each tensor gets its dtype back after (bf16 -> fp32 -> bf16
    is exact)."""
    def widen(mod):
        saved = [(t, t.dtype) for t in (*mod.parameters(), *mod.buffers())
                 if t.is_floating_point() and t.dtype != torch.float32]
        for t, _ in saved:
            t.data = t.data.float()
        return saved

    def narrow(saved):
        for t, dt in saved:
            t.data = t.data.to(dt)

    blocks = [b for m in core.modules() if isinstance(m, torch.nn.ModuleList)
              for b in m]
    in_blocks = {id(t) for b in blocks for t in (*b.parameters(),
                                                 *b.buffers())}
    widened = {}
    hooks = [h for b in blocks for h in (
        b.register_forward_pre_hook(
            lambda m, args: widened.__setitem__(m, widen(m))),
        b.register_forward_hook(lambda m, args, out: narrow(widened.pop(m))))]
    saved = [(t, t.dtype) for t in (*core.parameters(), *core.buffers())
             if id(t) not in in_blocks and t.is_floating_point()
             and t.dtype != torch.float32]
    try:
        for t, _ in saved:
            t.data = t.data.float()
        yield core
    finally:
        for h in hooks:
            h.remove()
        for m in list(widened):
            narrow(widened.pop(m))
        narrow(saved)


def fp32_text_queries(model, tid, runs):
    """Adds to `runs` (of `tool_vs_plain`) the request's text queries
    from the core in fp32 a layer at a time (`fp32_core`), plain
    versions: the first half of `fp32_witness`, run before the tool's
    fp32 copy is made so that the two never stand together."""
    ids, images = runs["req"][:2]
    with plain_versions(), fp32_core(model.core):
        runs["tq_32"], _ = text_queries(model, ids, images, tid)
    return runs


def fp32_witness(model, name, runs, t32):
    """The fp32 witness of `tool_vs_plain`'s gate: `t32` (tool `name`
    widened to fp32) on the fp32 text queries (`fp32_text_queries`) for
    the whole path and on the kernel run's text queries for the tool
    alone, all with the plain versions on the kernel run's choices.
    Returns each bf16 run's relative error from
    its fp32 counterpart ("kernel", "plain"): "text_queries", the tool's
    outputs alone (by name), the whole path ("end_to_end:" + name) and
    each backbone stage map ("stage<i>"), with the maps' kernel-vs-plain
    error. Raises where the kernel run sits more than
    DET26B_WITNESS_RATIO times as far from fp32 as the plain run does (or
    as 2^-8, where that is larger)."""
    aug, pm = runs["req"][2:]
    tool = getattr(model, name)
    mask, choices, tq_32 = runs["mask"], runs["choices"], runs["tq_32"]
    with plain_versions():
        whole_32 = run_tool(t32, name, aug.float(), pm, tq_32, mask, choices)
        alone_32 = run_tool(t32, name, aug.float(), pm, runs["tq_k"].float(),
                            mask, choices)
        maps_p = tool.backbone(aug)
        maps_32 = t32.backbone(aug.float())
    maps_k = tool.backbone(aug)
    res = {"kernel": {"text_queries": rel_err(runs["tq_k"], tq_32)},
           "plain": {"text_queries": rel_err(runs["tq_p"], tq_32)},
           "kernel_vs_plain": {}}
    for key in TOOL_OUTPUTS[name]:
        k, p, g, w, a = (valid_columns(runs, key, o[key]) for o in (
            runs["out_k"], runs["out_p"], runs["out_g"], whole_32, alone_32))
        res["kernel"][key], res["plain"][key] = rel_err(k, a), rel_err(g, a)
        res["kernel"]["end_to_end:" + key] = rel_err(k, w)
        res["plain"]["end_to_end:" + key] = rel_err(p, w)
    first = 1 if name == "unipose" else 0
    for s, (k, p, w) in enumerate(zip(maps_k, maps_p, maps_32), first):
        res["kernel"][f"stage{s}"] = rel_err(k, w)
        res["plain"][f"stage{s}"] = rel_err(p, w)
        res["kernel_vs_plain"][f"stage{s}"] = rel_err(k, p)
    for key, e in res["kernel"].items():
        if not e <= DET26B_WITNESS_RATIO * max(res["plain"][key], 2.0 ** -8):
            raise AssertionError(f"det26b {name} {key}: the kernel run is "
                                 f"{e} from fp32, the plain run "
                                 f"{res['plain'][key]}")
    return res


def det26b_predictor(model, cfg):
    """The Predictor section: one uint8 image (the det section's, numpy
    seed 4) answers detect, ground and pose (`PERCEPTION_REQUESTS`) and
    the pose request again over HTTP; each request's launches, its
    reply's shapes, the raw tool outputs behind each direct call against
    the plain versions (`tool_vs_plain`: the text queries and the tool
    alone within PERCEPTION_REL_TOL each) and against fp32 stage by stage
    and end to end (`fp32_witness`), the warm request times (the
    `det26b_predictor` line). Returns its main path's launches."""
    tok = SimpleTokenizer()
    pred = Predictor(cfg, model, tok, device="cuda")
    img = np.random.RandomState(4).randint(0, 256, DET26B_IMAGE, np.uint8)
    srv = make_server(None, host="127.0.0.1", port=0, predictor=pred)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    flash = cfg.vis_encoder.num_layers + cfg.llm.num_layers
    per_req = {
        "detect": (flash, sum(model.gdino.backbone.cfg.depths)
                   + cfg.gdino.encoder_layers + cfg.gdino.decoder_layers),
        "pose": (flash, sum(model.unipose.backbone.cfg.depths)
                 + cfg.unipose.encoder_layers + cfg.unipose.decoder_layers)}
    per_req["ground"] = per_req["detect"]
    path, body = PERCEPTION_REQUESTS[DET26B_HTTP_TASK]
    http_body = {"image_b64": base64.b64encode(img.tobytes()).decode(),
                 "image_shape": list(img.shape), **body}

    # the main path, with the launch counts taken around it alone
    A.flash_attention.launches = 0
    M.ms_deform_attn.launches = 0
    calls, replies, raw = [], {}, {}
    with torch.no_grad():
        for task, via in [(t, "direct") for t in PERCEPTION_REQUESTS] + [
                (DET26B_HTTP_TASK, "http")]:
            f0, m0 = A.flash_attention.launches, M.ms_deform_attn.launches
            t0 = time.perf_counter()
            if via == "direct":
                reply, *raw[task] = predictor_call(pred, task, img)
                replies[task, via] = json.loads(json.dumps(
                    perception_json(reply)))
            else:
                replies[task, via] = post_json(url + path, http_body)
            calls.append({"task": task, "via": via,
                          "wall_ms": (time.perf_counter() - t0) * 1e3,
                          "flash_attn_fwd": A.flash_attention.launches - f0,
                          "ms_deform_attn_fwd": M.ms_deform_attn.launches
                          - m0})
    torch.cuda.synchronize()
    launches = {"flash_attn_fwd": A.flash_attention.launches,
                "ms_deform_attn_fwd": M.ms_deform_attn.launches}
    srv.shutdown()
    srv.server_close()
    for c in calls:
        if (c["flash_attn_fwd"], c["ms_deform_attn_fwd"]) != per_req[
                c["task"]]:
            raise AssertionError(f"det26b predictor launches {c} != "
                                 f"{per_req[c['task']]}")
    for (task, via), reply in replies.items():
        check_perception_reply(task, reply, img.shape[:2])
    if replies[DET26B_HTTP_TASK, "http"] != replies[DET26B_HTTP_TASK,
                                                    "direct"]:
        raise AssertionError(f"det26b {DET26B_HTTP_TASK}: the HTTP reply "
                             "differs from the direct call's")

    # the main path's raw tool outputs against the plain versions, stage
    # by stage; the core and each tool in fp32 as the witness of each
    # stage and of the whole path (each tool's copy freed after)
    errs = {}
    with torch.no_grad():
        for task, (req, out_k) in raw.items():
            errs[task], raw[task] = tool_vs_plain(
                model, pred.tid, perception_tool(task), req, out_k)
            fp32_text_queries(model, pred.tid, raw[task])
            staged = [errs[task]["text_queries"],
                      *errs[task]["tool"].values()]
            if not max(staged) <= PERCEPTION_REL_TOL:
                raise AssertionError(f"det26b {task} kernel vs plain "
                                     f"{errs[task]} > {PERCEPTION_REL_TOL}")
        for name, tasks in (("gdino", ("detect", "ground")),
                            ("unipose", ("pose",))):
            t32 = copy.deepcopy(getattr(model, name)).float()
            for task in tasks:
                errs[task]["fp32_witness"] = fp32_witness(
                    model, name, raw.pop(task), t32)
            del t32
            gc.collect()
            torch.cuda.empty_cache()
        req_ms = {task: host_ms(lambda: perception_call(pred, task, img),
                                n=DET26B_REPEATS)
                  for task in PERCEPTION_REQUESTS}
    emit({"phase": "det26b_predictor", "image": list(DET26B_IMAGE),
          "bucket": list(pred._prepare(img, "<image>\nq", "a")[
              "image_aug"].shape[1:3]),
          "requests": PERCEPTION_REQUESTS, "http_task": DET26B_HTTP_TASK,
          "calls": calls, "launches": launches,
          "launches_per_request": {k: list(v) for k, v in per_req.items()},
          "http_equals_direct": True, "plain_rel_err": errs,
          "plain_rel_tol": PERCEPTION_REL_TOL,
          "fp32_witness_ratio": DET26B_WITNESS_RATIO,
          "request_ms_median": req_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def det26b_gen(model, cfg, tid):
    """The [GEN] and [EDIT] section: each image made DET26B_GEN_RUNS times
    from generator seed GEN_SEED (bit-identical), the forced tokens and
    launches, the rows, the logits after the last forced row and each
    head's mapper output on the rows against the plain run; the rows
    `VisionLLM.extract_gen_embs` takes from one prefill of the prompt
    and the generated tokens against the decode's (the `det26b_gen`
    line). Returns its main path's launches."""
    tok = SimpleTokenizer()
    reqs = gen_requests(cfg, tok)
    core = model.core
    gen = build_generate_fn(core, tid, max_new_tokens=cfg.num_embs_gen + 3,
                            max_len=GEN_MAX_LEN)
    want = {tool: (0 if req[1] is None and req[0].shape[1]
                   < A.FLASH_MIN_LEN else cfg.llm.num_layers)
            + (cfg.vis_encoder.num_layers if req[1] is not None else 0)
            for tool, req in reqs.items()}

    # the main path, with the launch count taken around it alone
    A.flash_attention.launches = 0
    images, rows, outs, walls, calls = {}, {}, {}, {}, []
    with torch.no_grad():
        for tool, req in reqs.items():
            runs = [gen_whole_image(model, gen, tid, tool, req,
                                    DET26B_GEN_STEPS)
                    for _ in range(DET26B_GEN_RUNS)]
            images[tool], rows[tool], outs[tool] = runs[0][:3]
            walls[tool] = [r[4] for r in runs]
            calls += [{"tool": tool, "flash_attn_fwd": r[3]} for r in runs]
            if not all(torch.equal(r[0], runs[0][0]) for r in runs[1:]):
                raise AssertionError(f"det26b {tool}: the images of one "
                                     "seed differ")
    torch.cuda.synchronize()
    launches = {"flash_attn_fwd": A.flash_attention.launches}
    for c in calls:
        if c["flash_attn_fwd"] != want[c["tool"]]:
            raise AssertionError(f"det26b gen launches {c}, want "
                                 f"{want[c['tool']]}")
    n_gen = cfg.num_embs_gen
    for tool in reqs:
        toks = outs[tool]["out_tokens"][0].tolist()
        if toks[0] != getattr(tid, tool) or toks[1:1 + n_gen] != \
                [tid.emb] * n_gen:
            raise AssertionError(f"det26b {tool}: tokens {toks[:4]}")
        if tuple(images[tool].shape) != (1,) + GEN_IMAGE or \
                not torch.isfinite(images[tool]).all():
            raise AssertionError(f"det26b {tool}: image "
                                 f"{tuple(images[tool].shape)}")

    errs = {}
    with torch.no_grad():
        for tool, req in reqs.items():
            head = getattr(model, "sd" if tool == "gen" else "ip2p")
            with plain_versions():
                rows_p, out_p = gen_rows(model, gen, tid, tool, req)
            mapped = head.map_embeddings(rows[tool])
            if tuple(mapped.shape) != (1, head.cfg.num_queries,
                                       head.cfg.sd_hidden_size):
                raise AssertionError(f"det26b {tool}: mapper output "
                                     f"{tuple(mapped.shape)}")
            errs[tool] = {
                "rows": rel_err(rows[tool], rows_p),
                "last_forced_logits": rel_err(
                    last_forced_logits(core, outs[tool]),
                    last_forced_logits(core, out_p)),
                "mapper": rel_err(mapped, head.map_embeddings(rows_p)),
                "extract_gen_embs_vs_decode": rel_err(
                    prefill_gen_embs(core, tid, tool, req, outs[tool]),
                    rows[tool])}
            if not max(errs[tool].values()) <= GEN_REL_TOL:
                raise AssertionError(f"det26b {tool} kernel vs plain "
                                     f"{errs[tool]} > {GEN_REL_TOL}")
    emit({"phase": "det26b_gen", "image": list(GEN_IMAGE),
          "steps": DET26B_GEN_STEPS, "guidance": GEN_GUIDANCE,
          "image_guidance": GEN_IMAGE_GUIDANCE, "seed": GEN_SEED,
          "runs": DET26B_GEN_RUNS, "bit_identical": True,
          "prompt_tokens": {t: int(r[0].shape[1]) for t, r in reqs.items()},
          "calls": calls, "launches": launches,
          "flash_per_generate": want, "plain_rel_err": errs,
          "plain_rel_tol": GEN_REL_TOL, "walls_ms": walls,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def prefill_gen_embs(core, tid, tool, req, out):
    """The [GEN] / [EDIT] rows `VisionLLM.extract_gen_embs` takes from one
    prefill of the prompt and the tokens the generate call emitted (the
    training forward's reading) [1, num_embs_gen, C]."""
    ids, clip, _ = req
    n = 1 + core.cfg.num_embs_gen
    full = torch.cat([ids, out["out_tokens"][:, :n].to(ids.dtype)], 1)
    hid = core(full, clip, tid, compute_logits=False)["hidden"]
    code = C.TOOL_GEN if tool == "gen" else C.TOOL_EDIT
    return core.extract_gen_embs(hid, full, tid, code)


def det26b_regions(model, cfg, tid):
    """The regions section: a box request and a mask request (the same
    region) through `ChatService(max_batch=1)` (B1 dispatch) and through
    `ChatService(slots=2, prefill_chunk=FLAGSHIP_CHUNK)`, and another box
    through B1 dispatch, all under `internlm2_chat`. What the region path
    gave each call (`RegionTrace`) is held as the flagship phase holds
    it: the box and its mask give the same masks and bit-identical rows;
    the slot service the B1 box request's masks, and rows and first-step
    logits within LOGIT_REL_TOL; the B1 box request's rows, first-step
    and teacher-forced logits and a chunked admission's first step
    against the plain versions; another box's rows REGION_SEPARATION
    times farther off (the `det26b_regions` line). Returns its main
    path's launches."""
    core = model.core
    tok = RoundTripTokenizer()
    img, regions = flagship_regions()
    common = dict(max_new_tokens=FLAGSHIP_NEW, max_prompt=FLAGSHIP_PROMPT,
                  max_regions=FLAGSHIP_MAX_REGIONS,
                  conv_version="internlm2_chat",
                  device="cuda")
    svcs = {"b1": ChatService(cfg, core, tok, **common),
            "slots": ChatService(cfg, core, tok, slots=2,
                                 prefill_chunk=FLAGSHIP_CHUNK, **common)}
    want = {"b1": cfg.vis_encoder.num_layers + cfg.llm.num_layers,
            "slots": cfg.vis_encoder.num_layers}
    order = [("b1", n) for n in ("box", "mask", "other_box")] + [
        ("slots", n) for n in ("box", "mask")]
    trace = RegionTrace(core, tid, svcs.values())

    # the main path, with the launch count taken around it alone
    A.flash_attention.launches = 0
    answers, seen, calls = {}, {}, []
    with torch.no_grad():
        for mode, name in order:
            prompt, regs = regions[name]
            f0 = A.flash_attention.launches
            answers[mode, name], seen[mode, name] = trace.call(
                lambda: svcs[mode].generate(prompt, image=img, regions=regs))
            calls.append({"call": f"{mode}:{name}",
                          "flash_attn_fwd": A.flash_attention.launches - f0})
    torch.cuda.synchronize()
    launches = {"flash_attn_fwd": A.flash_attention.launches}
    trace.close()
    for c in calls:
        if c["flash_attn_fwd"] != want[c["call"].split(":")[0]]:
            raise AssertionError(f"det26b regions launches {c}, want {want}")
    for (mode, name), a in answers.items():
        if a["num_tokens"] < 1 or not all(0 <= t < cfg.llm.vocab_size
                                          for t in a["ids"]):
            raise AssertionError(f"det26b {mode}:{name}: answer {a}")
    for key in ("masks", "rows"):
        if not torch.equal(seen["b1", "mask"][key], seen["b1", "box"][key]):
            raise AssertionError(f"det26b: the mask region's {key} differ "
                                 "from its box's")

    with torch.no_grad():
        b1 = svcs["b1"]
        packed = region_packed(b1, img, *regions["box"])
        toks = torch.tensor([answers["b1", "box"]["ids"]], dtype=torch.int32,
                            device="cuda")
        n_tok = toks.shape[1]
        rows_k = region_rows(core, tid, packed)
        lk = teacher_forced(b1, *packed[:3], toks, n_tok,
                            regions=packed[3])[:, 0]
        with plain_versions():
            rows_p = region_rows(core, tid, packed)
            lp = teacher_forced(b1, *packed[:3], toks, n_tok,
                                regions=packed[3])[:, 0]
        chunked = chunked_first_logits(svcs["slots"], img, *regions["box"])
    for s in svcs.values():
        s.close()
    if tuple(rows_k.shape) != (1, cfg.llm.hidden_size):
        raise AssertionError(f"det26b region rows {tuple(rows_k.shape)}")
    errs = {"rows": rel_err(rows_k, rows_p),
            "first_step_logits": rel_err(lk[0], lp[0]),
            "teacher_forced_logits_max": max(rel_errs(lk, lp)),
            "chunked_first_step_vs_b1": rel_err(chunked, lk[0])}
    modes = {}
    for name in ("box", "mask"):
        got, ref = seen["slots", name], seen["b1", "box"]
        if not torch.equal(got["masks"], ref["masks"]):
            raise AssertionError(f"det26b slots:{name}: region masks differ "
                                 "from the B1 request's")
        modes[f"slots:{name}"] = {"rows": rel_err(got["rows"], ref["rows"]),
                                  "first_step": rel_err(got["first"], lk[0])}
    modes["b1:box"] = {"first_step": rel_err(seen["b1", "box"]["first"],
                                             lk[0])}
    for k, e in [*errs.items()] + [(f"{m}:{n}", v) for m, d in modes.items()
                                   for n, v in d.items()]:
        if not e <= LOGIT_REL_TOL:
            raise AssertionError(f"det26b regions {k}: {e} > "
                                 f"{LOGIT_REL_TOL} ({errs}, {modes})")
    other = rel_err(seen["b1", "other_box"]["rows"], seen["b1", "box"]["rows"])
    noise = max(errs["rows"], *(d["rows"] for m, d in modes.items()
                                if "rows" in d))
    if not other >= REGION_SEPARATION * noise:
        raise AssertionError(f"det26b: another box's rows differ by {other}, "
                             f"under {REGION_SEPARATION} x {noise}")
    rules = {f"slots:{n}": near_tie_rule(f"det26b slots:{n}",
                                         answers["slots", n]["ids"],
                                         answers["b1", "box"]["ids"], lk)
             for n in ("box", "mask")}
    emit({"phase": "det26b_regions", "image": list(FLAGSHIP_IMAGE),
          "max_regions": FLAGSHIP_MAX_REGIONS,
          "conv_version": "internlm2_chat",
          "region_prompt_tokens": int(packed[0].shape[1]),
          "calls": calls, "launches": launches, "launches_per_call": want,
          "answers": {f"{m}:{n}": a["ids"] for (m, n), a in answers.items()},
          "plain_rel_err": errs, "mode_vs_b1_rel_err": modes,
          "other_box_rows_rel_diff": other,
          "separation": REGION_SEPARATION, "token_rules": rules,
          "plain_rel_tol": LOGIT_REL_TOL,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def det26b_chat(model, cfg, mode):
    """The chat section in `mode` "bf16", or "int4" after the core's LLM
    is quantized in place (`quantize_serving_params`, as `build_core`
    quantizes): `ChatService(max_batch=4, max_prompt=640,
    max_new_tokens=DET26B_CHAT_NEW, conv_version="internlm2_chat")`
    answers the serve
    phase's 4 image requests from threads in one generate call; the
    launches, the kernel run against the plain run teacher-forced on its
    tokens (`compare_plain`), TTFT, ms a decode step and tok/s (the
    `det26b_chat` line). Returns its main path's launches."""
    core = model.core
    quant = {}
    if mode == "int4":
        t = time.perf_counter()
        Q8.quantize_serving_params(core, bits=4)
        torch.cuda.synchronize()
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, quant="int4"))
        core.cfg, core.llm.cfg = cfg, cfg.llm
        gc.collect()
        torch.cuda.empty_cache()
        quant = {"quantize_s": time.perf_counter() - t,
                 "int4_linear_modules": sum(isinstance(m, Q.Int4Linear)
                                            for m in core.modules()),
                 "weights_gb": torch.cuda.memory_allocated() / 1e9}
    per_fwd_int4 = 7 * cfg.llm.num_layers + 1 if mode == "int4" else 0
    if quant and quant["int4_linear_modules"] != per_fwd_int4:
        raise AssertionError(f"det26b: {quant['int4_linear_modules']} "
                             f"Int4Linear modules, want {per_fwd_int4}")
    per_call_flash = cfg.vis_encoder.num_layers + cfg.llm.num_layers
    svc = ChatService(cfg, core, SimpleTokenizer(),
                      conv_version="internlm2_chat", max_batch=SERVE_BATCH,
                      max_prompt=SERVE_PROMPT,
                      max_new_tokens=DET26B_CHAT_NEW,
                      batch_window_ms=BATCH_WINDOW_MS,
                      device="cuda")
    image_reqs, _ = serve_requests()
    enc = [_Request(*svc._encode(r["prompt"], r.get("image"))[:2])
           for r in image_reqs]
    if max(len(r.ids) for r in enc) >= SERVE_PROMPT:
        raise AssertionError("det26b chat: a prompt would be cut")
    res = [None] * len(image_reqs)

    def fire(i):
        res[i] = svc.generate(**image_reqs[i])

    # the main path, with the launch counts taken around it alone
    A.flash_attention.launches = 0
    Q.int4_matmul.launches = 0
    b0, s0 = svc.stats["batches_total"], svc.stats["steps_total"]
    with torch.no_grad():
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(image_reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
    torch.cuda.synchronize()
    launches = {"flash_attn_fwd": A.flash_attention.launches}
    if mode == "int4":
        launches["int4_matmul"] = Q.int4_matmul.launches
    calls = svc.stats["batches_total"] - b0
    steps = svc.stats["steps_total"] - s0
    for a in res:
        if a is None or a["num_tokens"] < 1 or \
                not all(0 <= t < cfg.llm.vocab_size for t in a["ids"]):
            raise AssertionError(f"det26b chat {mode}: bad answer {a}")
    if calls != 1:
        raise AssertionError(f"det26b chat {mode}: 4 threaded requests took "
                             f"{calls} generate calls")
    got = (A.flash_attention.launches, Q.int4_matmul.launches)
    if got != (per_call_flash * calls, per_fwd_int4 * steps):
        raise AssertionError(f"det26b chat {mode}: launches (flash, int4) "
                             f"{got}, want {per_call_flash} a call and "
                             f"{per_fwd_int4} a forward over {steps}")
    with torch.no_grad():
        cmp, packed = compare_plain(svc, enc)
        timings = serve_timings(svc, packed)
    svc.close()
    emit({"phase": "det26b_chat", "mode": mode,
          "conv_version": "internlm2_chat", **quant,
          "max_batch": SERVE_BATCH, "max_prompt": SERVE_PROMPT,
          "max_new_tokens": DET26B_CHAT_NEW,
          "prompt_tokens": [len(r.ids) for r in enc],
          "generate_calls": calls, "forwards": steps, "launches": launches,
          "launches_per_call": {"flash_attn_fwd": per_call_flash,
                                "int4_matmul_per_forward": per_fwd_int4},
          "answers": [a["num_tokens"] for a in res],
          "plain": {k: v for k, v in cmp.items() if k != "tokens"},
          "logit_rel_tol": LOGIT_REL_TOL, **timings,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


# ---------------------------------------------------------------------------
# phases 8-9: int4 chat serving at full width
# ---------------------------------------------------------------------------

def serve_requests():
    """The serve phase's requests: 4 image requests, a text-only request
    with a history (uint8 images from a numpy seed)."""
    rng = np.random.RandomState(0)
    shapes = ((480, 640, 3), (336, 336, 3), (600, 400, 3), (224, 300, 3))
    prompts = ("describe the image", "what color is the car",
               "how many people are there", "where was this photo taken")
    images = [dict(prompt=p, image=rng.randint(0, 255, sh, np.uint8))
              for p, sh in zip(prompts, shapes)]
    text = dict(prompt="and what should I bring",
                history=["I plan a trip to the mountains",
                         "that sounds great, when do you leave",
                         "next week", "pack warm clothes"])
    return images, text


def post_json(url, obj):
    req = urllib.request.Request(url, json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def teacher_forced(svc, ids, imgs, mask, tokens, n_gen, step_ms=None,
                   regions=None):
    """Prefill (with `regions` [B, R, S, S] when given) + (n_gen - 1)
    decode steps of `svc`'s core, fed the tokens `tokens` [B, >= n_gen]
    emitted by a generate call (through the same emb-countdown state
    machine), returning each step's last-position fp32 logits
    [n_gen, B, V]. Appends each decode step's synced wall ms to `step_ms`
    when given."""
    core, tid, cfg = svc.core, svc.tid, svc.core.cfg
    B, L = ids.shape
    max_len = svc.max_prompt + svc.max_new_tokens + 8
    cache = core.new_cache(B, max_len)
    out = core(ids, imgs, tid, attn_mask=mask, cache=cache, regions=regions)
    logits = [out["logits"][:, -1].float()]
    first = tokens[:, 0]
    kind = _tool_kind(first, tid)
    total = torch.where(kind >= C.TOOL_GEN,
                        torch.full_like(kind, cfg.num_embs_gen),
                        torch.full_like(kind, cfg.num_embs))
    countdown = torch.where(kind > 0, total, torch.zeros_like(kind))
    embed = core.embed_tokens(first[:, None].long())
    dmask = torch.cat([mask, torch.ones(B, max_len - L, dtype=torch.bool,
                                        device=ids.device)], 1)
    for step in range(1, n_gen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pos = torch.full((B, 1), cache.index, dtype=torch.long,
                         device=ids.device)
        res = core.llm_step(embed, pos, cache, dmask)
        _, embed, countdown, kind = advance_tool_state(
            core, tid, cfg.num_embs, cfg.num_embs_gen, tokens[:, step],
            countdown, kind)
        torch.cuda.synchronize()
        if step_ms is not None:
            step_ms.append((time.perf_counter() - t) * 1e3)
        logits.append(res["logits"][:, -1].float())
    return torch.stack(logits)


def plain_versions():
    stack = ExitStack()
    stack.enter_context(mock.patch.object(A, "flash_attention",
                                          A.flash_attention_plain))
    stack.enter_context(mock.patch.object(M, "ms_deform_attn",
                                          M.ms_deform_attn_plain))
    stack.enter_context(mock.patch.object(Q, "int4_matmul",
                                          Q.int4_matmul_plain))
    return stack


def compare_plain(svc, reqs):
    """One generate call of `reqs` with the kernels, then the kernel run
    and the plain run teacher-forced on its tokens: per-step relative
    error of the logits (live rows) and top-1 agreement."""
    ids, imgs, mask, live = svc._pack(reqs)
    out = svc.generate_fn(ids, imgs, attn_mask=mask, live=live)
    n_gen = int(out["num_generated"])
    toks = out["out_tokens"]
    lk = teacher_forced(svc, ids, imgs, mask, toks, n_gen)
    with plain_versions():
        lp = teacher_forced(svc, ids, imgs, mask, toks, n_gen)
    rows = live.nonzero()[:, 0]
    lk, lp = lk[:, rows], lp[:, rows]
    rel = ((lk - lp).flatten(1).norm(dim=1)
           / lp.flatten(1).norm(dim=1)).tolist()
    if not max(rel) <= LOGIT_REL_TOL:
        raise AssertionError(f"teacher-forced logits: rel err {max(rel)} > "
                             f"{LOGIT_REL_TOL}")
    # the kernel run's own teacher-forced argmax reproduces its tokens
    if not torch.equal(lk[0].argmax(-1).int(), toks[rows, 0]):
        raise AssertionError("teacher-forced kernel run disagrees with "
                             "the generate call's first token")
    top1 = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    return {"rows": len(rows), "steps": n_gen, "prefill_rel_err": rel[0],
            "decode_rel_err_max": max(rel[1:], default=0.0),
            "top1_agreement": top1,
            "tokens": toks[rows, :n_gen].tolist()}, (ids, imgs, mask, live)


def run_serve():
    torch.cuda.reset_peak_memory_stats()
    cfg = vllm_7b_chat_config(llm=LLMConfig(vocab_size=32096, quant="int4"))
    t = time.perf_counter()
    core = build_core(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    n_int4 = sum(isinstance(m, Q.Int4Linear) for m in core.modules())
    per_fwd_int4 = 7 * cfg.llm.num_layers + 1
    if n_int4 != per_fwd_int4:
        raise AssertionError(f"{n_int4} Int4Linear modules, want "
                             f"{per_fwd_int4}")
    per_call_flash = cfg.vis_encoder.num_layers + cfg.llm.num_layers
    svc = ChatService(cfg, core, SimpleTokenizer(),
                      image_size=cfg.vis_encoder.image_size,
                      max_batch=SERVE_BATCH, max_prompt=SERVE_PROMPT,
                      max_new_tokens=SERVE_NEW,
                      batch_window_ms=BATCH_WINDOW_MS, device="cuda")
    image_reqs, text_req = serve_requests()
    for r in image_reqs + [text_req]:
        n = len(svc._encode(r["prompt"], r.get("image"), r.get("history"))[0])
        if n >= SERVE_PROMPT:
            raise AssertionError(f"prompt of {n} tokens would be cut")
    srv = make_server(svc, host="127.0.0.1", port=0)
    http = threading.Thread(target=srv.serve_forever, daemon=True)
    http.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    calls = []

    def call(label, fn):
        f0, q0 = A.flash_attention.launches, Q.int4_matmul.launches
        b0, s0 = svc.stats["batches_total"], svc.stats["steps_total"]
        t0 = time.perf_counter()
        res = fn()
        calls.append({"call": label,
                      "wall_ms": (time.perf_counter() - t0) * 1e3,
                      "generate_calls": svc.stats["batches_total"] - b0,
                      "num_generated": svc.stats["steps_total"] - s0,
                      "flash": A.flash_attention.launches - f0,
                      "int4": Q.int4_matmul.launches - q0})
        return res

    def concurrent():
        res = [None] * len(image_reqs)

        def fire(i):
            res[i] = svc.generate(**image_reqs[i])
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(image_reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        return res

    img0 = image_reqs[0]
    body = {"prompt": img0["prompt"],
            "image_b64": base64.b64encode(img0["image"].tobytes()).decode(),
            "image_shape": list(img0["image"].shape)}
    # the main path, with the launch counts taken around it alone
    A.flash_attention.launches = 0
    Q.int4_matmul.launches = 0
    with torch.no_grad():
        batched = call("4 image requests from threads", concurrent)
        alone = call("image request 0 alone", lambda: svc.generate(**img0))
        text = call("text-only with history",
                    lambda: svc.generate(**text_req))
        over_http = call("image request 0 over HTTP",
                         lambda: post_json(url + "/v1/generate", body))
    torch.cuda.synchronize()
    launches = {"flash_attn_fwd": A.flash_attention.launches,
                "int4_matmul": Q.int4_matmul.launches}
    srv.shutdown()
    srv.server_close()

    answers = batched + [alone, text, over_http]
    vocab = cfg.llm.vocab_size
    for a in answers:
        if a is None or a["num_tokens"] < 1 or \
                not all(0 <= t < vocab for t in a["ids"]):
            raise AssertionError(f"bad answer {a}")
    if alone["ids"] != over_http["ids"]:
        raise AssertionError("the same request twice gave other ids")
    if calls[0]["generate_calls"] != 1:
        raise AssertionError(f"4 threaded requests took "
                             f"{calls[0]['generate_calls']} generate calls")
    for c in calls:
        want = (per_call_flash * c["generate_calls"],
                per_fwd_int4 * c["num_generated"])
        if (c["flash"], c["int4"]) != want or c["generate_calls"] < 1:
            raise AssertionError(f"launches {c} != (flash, int4) {want}")

    with torch.no_grad():
        enc = [_Request(*svc._encode(r["prompt"], r.get("image"),
                                     r.get("history"))[:2])
               for r in image_reqs]
        cmp_images, packed = compare_plain(svc, enc)
        tr = _Request(*svc._encode(text_req["prompt"], None,
                                   text_req["history"])[:2])
        cmp_text, _ = compare_plain(svc, [tr])
        direct_equals_alone = \
            cmp_images["tokens"][0][:alone["num_tokens"]] == alone["ids"]
        timings = serve_timings(svc, packed)
    emit({"phase": "serve", "config": "vllm_7b_chat_config quant=int4",
          "int4_linear_modules": n_int4, "build_core_s": build_s,
          "max_batch": SERVE_BATCH, "max_prompt": SERVE_PROMPT,
          "max_new_tokens": SERVE_NEW, "calls": calls, "launches": launches,
          "answers": [{"num_tokens": a["num_tokens"], "text": a["text"][:60]}
                      for a in answers],
          "batched_equals_alone": batched[0]["ids"] == alone["ids"],
          "direct_call_equals_alone": direct_equals_alone,
          "plain_images": {k: v for k, v in cmp_images.items()
                           if k != "tokens"},
          "plain_text": {k: v for k, v in cmp_text.items() if k != "tokens"},
          "logit_rel_tol": LOGIT_REL_TOL, **timings,
          "metrics": svc.metrics(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    profile_decode_step(svc, packed)
    svc.close()
    return launches, core, cfg


def serve_timings(svc, packed, n_generate=3, step_ms=None):
    """A micro-batching service's TTFT (median of 3 prefills of the packed
    batch), aggregate tok/s (median of `n_generate` generate calls) and
    decode ms a step: the median of `step_ms` when given (a teacher-forced
    run's step times), else over a teacher-forced run of the generate
    call's tokens."""
    ids, imgs, mask, live = packed
    B = ids.shape[0]
    max_len = svc.max_prompt + svc.max_new_tokens + 8
    ttft = host_ms(lambda: svc.core(ids, imgs, svc.tid, attn_mask=mask,
                                    cache=svc.core.new_cache(B, max_len)),
                   n=3)
    last = {}

    def generate():
        last["out"] = svc.generate_fn(ids, imgs, attn_mask=mask, live=live)

    gen_ms = host_ms(generate, n=n_generate)
    out = last.pop("out")
    n_gen = int(out["num_generated"])
    if step_ms is None:
        step_ms = []
        teacher_forced(svc, ids, imgs, mask, out["out_tokens"], n_gen,
                       step_ms)
    return {"ttft_ms": ttft,
            "decode_step_ms_median": statistics.median(step_ms),
            "decode_steps_timed": len(step_ms), "generate_ms": gen_ms,
            "generate_tokens": B * n_gen,
            "tok_per_s": B * n_gen / (gen_ms / 1e3)}


def profile_decode_step(svc, packed):
    """One warm decode step (llm_step + the tool state machine) of the
    packed batch under torch.profiler."""
    ids, imgs, mask, live = packed
    cfg, core, tid = svc.cfg, svc.core, svc.tid
    B, L = ids.shape
    max_len = SERVE_PROMPT + SERVE_NEW + 8
    with torch.no_grad():
        cache = core.new_cache(B, max_len)
        out = core(ids, imgs, tid, attn_mask=mask, cache=cache)
        tok = out["logits"][:, -1].argmax(-1).int()
        embed = core.embed_tokens(tok[:, None].long())
        dmask = torch.cat([mask, torch.ones(B, max_len - L, dtype=torch.bool,
                                            device="cuda")], 1)
        zero = torch.zeros_like(tok)

        def step():
            pos = torch.full((B, 1), cache.index, dtype=torch.long,
                             device="cuda")
            res = core.llm_step(embed, pos, cache, dmask)
            sampled = res["logits"][:, -1].argmax(-1).int()
            advance_tool_state(core, tid, cfg.num_embs, cfg.num_embs_gen,
                               sampled, zero, zero)
            return bool((sampled == svc.eos_id).all())

        step()                                  # warm
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    emit({"phase": "serve_profile", **device_summary(prof, wall_ms)})


# ---------------------------------------------------------------------------
# phases 10-11: continuous-batching slots on the chat core
# ---------------------------------------------------------------------------

# service A: greedy continuous batching with chunked prefill, decode spans
# and sessions (the README's serving mode without its int8 flags);
# service B: sampling, apart because sampling forbids chunked prefill and
# sessions. Under chunking prompts round up to 768: slot_max_len 1288
SLOTS_A = dict(slots=8, prefill_chunk=256, decode_span=4, sessions=2,
               max_prompt=SERVE_PROMPT, max_new_tokens=SERVE_NEW)
SLOTS_A_SHAPE = (768, 1288)           # (rounded max_prompt, slot_max_len)
SLOTS_B = dict(slots=4, sampling=True, max_prompt=SERVE_PROMPT,
               max_new_tokens=SERVE_NEW)
SLOT_WAVES, SLOT_WAVE_GAP_S = 3, 0.15
# a sampled token lies in the nucleus of the kernel run's logits exactly,
# and in the plain run's up to this much probability mass before it: the
# two runs' logits differ within LOGIT_REL_TOL, which moves the edge
NUCLEUS_SLACK = 0.02
CLOSE_WAIT_S = 10.0


def slot_requests():
    """Service A's 12 requests: the serve phase's 4 image requests and
    text-only prompts with and without a history, with max_new_tokens
    from 8 to 32 (which cuts the reply, not the decode)."""
    images, text = serve_requests()
    texts = [dict(prompt="tell me a short story about a lighthouse"),
             dict(prompt="what is the capital of france"),
             text,
             dict(prompt="list three uses of copper"),
             dict(prompt="and why is that",
                  history=["is the sky blue", "yes, on a clear day"]),
             dict(prompt="how do trains work"),
             dict(prompt="what should I cook tonight",
                  history=["I have rice and eggs", "fried rice is quick",
                           "anything else", "an omelette"]),
             dict(prompt="explain the rules of chess")]
    reqs = images + texts
    for i, r in enumerate(reqs):
        r["max_new_tokens"] = 8 + (24 * i) // (len(reqs) - 1)
    return reqs


class SlotRecorder:
    """Wraps a slot service's engine functions, reading only: counts the
    LLM forwards they run (decode ticks x span, chunk and extend windows,
    monolithic prefills) and the chunked admissions, and records each
    request's submit and first-token times, the live slots at its
    admission, and each session extension's last logits."""

    def __init__(self, svc, span):
        self.svc, self.span = svc, span
        self.counts = dict.fromkeys(
            ("ticks", "windows", "extends", "prefills", "chunked"), 0)
        # keyed by the request objects, which the dicts keep alive (an
        # id() could be reused by a later request)
        self.submitted, self.first_token, self.live_at_admission = {}, {}, {}
        self.extend_last = []
        for name, key in (("_slot_step", "ticks"), ("_chunk_run", "windows"),
                          ("_sess_extend", "extends"),
                          ("_slot_prefill", "prefills"),
                          ("_chunk_embed", "chunked")):
            if hasattr(svc, name):
                self._count(name, key)
        submit, finish = svc._submit, svc._finish_admission

        def submit_w(r):
            self.submitted[r] = time.perf_counter()
            return submit(r)

        def finish_w(r, slot, pre, active, state, fill0):
            self.live_at_admission[r] = len(active)
            out = finish(r, slot, pre, active, state, fill0)
            self.first_token[r] = time.perf_counter()
            return out

        svc._submit, svc._finish_admission = submit_w, finish_w
        if hasattr(svc, "_sess_finish"):
            sess_finish = svc._sess_finish

            def sess_finish_w(last):
                self.extend_last.append(last[0].float().clone())
                return sess_finish(last)

            svc._sess_finish = sess_finish_w

    def _count(self, name, key):
        fn = getattr(self.svc, name)

        def counted(*a, **kw):
            self.counts[key] += 1
            return fn(*a, **kw)

        setattr(self.svc, name, counted)

    def expected_launches(self, cfg):
        """(flash, int4) launches of the counted work: 225 int4 per LLM
        forward; CLIP's 24 flash per fresh admission (a text-only one
        carries a zero image), LLaMA's 32 only in a monolithic prefill
        (chunk and extend windows carry a mask: the einsum branch)."""
        c = self.counts
        forwards = c["ticks"] * self.span + c["windows"] + c["extends"] \
            + c["prefills"]
        flash = cfg.vis_encoder.num_layers * (c["chunked"] + c["prefills"]) \
            + cfg.llm.num_layers * c["prefills"]
        return flash, (7 * cfg.llm.num_layers + 1) * forwards

    def check_launches(self, label, cfg, launches):
        got = (launches["flash_attn_fwd"], launches["int4_matmul"])
        if got != self.expected_launches(cfg):
            raise AssertionError(
                f"{label}: launches (flash, int4) {got}, want "
                f"{self.expected_launches(cfg)} for {self.counts}")


def slot_row(svc, r):
    """A request's left-padded ids, pixels, mask and buffer-valid row as
    the slot service packs an admission."""
    ids, img, mask, _ = svc._pack([r])
    valid = torch.ones(svc.slot_max_len, dtype=torch.bool, device=svc.device)
    valid[:svc.max_prompt] = mask[0]
    return ids, img, mask, valid


def monolithic_last_logits(svc, r):
    """The last-position fp32 logits [V] of a B1 prefill of `r`."""
    ids, img, mask, _ = slot_row(svc, r)
    row = KVCache.create(svc.cfg.llm, 1, svc.slot_max_len,
                         svc.core.llm.norm.weight.dtype, svc.device)
    return svc.core(ids, img, svc.tid, attn_mask=mask, cache=row)[
        "logits"][0, -1].float()


def slot_teacher_forced(svc, reqs, tokens, chunked):
    """Each request of `reqs` (at most the slot count) admitted into its
    own slot of a fresh state of `svc`'s engine (chunk windows or a B1
    prefill) and decoded with per-row fill levels, fed the tokens
    `tokens[i]` a service run emitted (through the emb-countdown state
    machine). Returns per request its fp32 logits [len(tokens[i]), V]:
    the prefill's last position, then each decode step's."""
    core, tid, cfg, dev = svc.core, svc.tid, svc.cfg, svc.device
    state, slot_valid = svc._slot_init()
    first_logits = []
    for s, (r, toks) in enumerate(zip(reqs, tokens)):
        ids, img, mask, valid = slot_row(svc, r)
        row = KVCache.create(cfg.llm, 1, svc.slot_max_len,
                             core.llm.norm.weight.dtype, dev)
        if chunked:
            W = svc.prefill_chunk
            emb = core.build_prompt_embeds(ids, img, tid)[0]
            for k in range(svc.max_prompt // W):
                pos = (row.index + torch.arange(W, device=dev))[None]
                last = core.llm_window(emb[:, k * W:(k + 1) * W], pos, row,
                                       valid[None])["logits"][:, -1]
        else:
            last = core(ids, img, tid, attn_mask=mask, cache=row)[
                "logits"][:, -1]
        first_logits.append(last[0].float())
        first = torch.tensor(toks[0], dtype=torch.int32, device=dev)
        svc._slot_insert(state, s, first,
                         core.embed_tokens(first[None, None].long()), row,
                         valid, slot_valid)
    n_max = max(len(t) for t in tokens)
    forced = torch.zeros(len(slot_valid), n_max, dtype=torch.int32,
                         device=dev)
    for s, toks in enumerate(tokens):
        forced[s, :len(toks)] = torch.tensor(toks, dtype=torch.int32)
    embed, c = state.cur_embed, state.cache
    countdown, kind = state.emb_countdown, state.emb_kind
    steps = []
    for t in range(1, n_max):
        res = core.llm_step(embed, c.index[:, None], c, slot_valid)
        steps.append(res["logits"][:, -1].float())     # advanced c.index
        _, embed, countdown, kind = advance_tool_state(
            core, tid, cfg.num_embs, cfg.num_embs_gen, forced[:, t],
            countdown, kind)
    return [torch.stack([first_logits[s]] + [x[s] for x in steps])[
        :len(tokens[s])] for s in range(len(reqs))]


def rel_errs(got, want):
    """Relative Frobenius error of each row of [n, V]."""
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).reshape(
        -1).tolist()


def compare_slot_plain(svc, reqs, tokens, chunked):
    """The kernel and the plain run of `slot_teacher_forced` on the same
    tokens, per request: the prefill's and the worst decode step's
    relative error, whether the kernel run's argmax reproduces the
    service's tokens, and both runs' logits."""
    out = []
    for i in range(0, len(reqs), svc.slots):
        part, toks = reqs[i:i + svc.slots], tokens[i:i + svc.slots]
        kern = slot_teacher_forced(svc, part, toks, chunked)
        with plain_versions():
            plain = slot_teacher_forced(svc, part, toks, chunked)
        for k, p, tk in zip(kern, plain, toks):
            rel = rel_errs(k, p)
            out.append({"prefill_rel_err": rel[0],
                        "decode_rel_err_max": max(rel[1:], default=0.0),
                        "kernel_argmax_equals_tokens":
                            k.argmax(-1).tolist() == tk,
                        "logits": (k, p)})
    worst = max(max(o["prefill_rel_err"], o["decode_rel_err_max"])
                for o in out)
    if not worst <= LOGIT_REL_TOL:
        raise AssertionError(f"teacher-forced slot logits: rel err {worst} "
                             f"> {LOGIT_REL_TOL}")
    return out


def public(rows):
    return [{k: v for k, v in o.items() if k != "logits"} for o in rows]


def preceding_mass(logits, token, temperature):
    """Probability mass at `temperature` of the tokens before `token` in
    a stable descending sort: `token` is in the top-p nucleus iff this
    is below top_p."""
    s = logits / max(temperature, 1e-6)
    order = torch.argsort(-s, stable=True)
    probs = torch.softmax(s[order], 0)
    return float((torch.cumsum(probs, 0) - probs)[order == token][0])


def call_threads(fns, timeout):
    """Run each fn in its own thread; returns (results, exceptions), each
    thread joined within `timeout` (raises otherwise)."""
    res, errs = [None] * len(fns), [None] * len(fns)

    def run(i):
        try:
            res[i] = fns[i]()
        except Exception as e:          # noqa: BLE001 - handed back
            errs[i] = e

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(fns))]
    for th in threads:
        th.start()
    deadline = time.perf_counter() + timeout
    for th in threads:
        th.join(max(0.0, deadline - time.perf_counter()))
    if any(th.is_alive() for th in threads):
        raise AssertionError(f"a call still waits after {timeout} s")
    return res, errs


def sse_deltas(url, body):
    """The text deltas of a streamed /v1/generate answer."""
    req = urllib.request.Request(
        url + "/v1/generate", json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    deltas = []
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.headers["Content-Type"] != "text/event-stream":
            raise AssertionError(f"a stream answered {r.headers}")
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                return deltas
            frame = json.loads(payload)
            if "error" in frame:
                raise AssertionError(f"stream error frame {frame}")
            deltas.append(frame["delta"])
    raise AssertionError("the stream ended without [DONE]")


def run_slots(core, cfg):
    """Phase `slots` (service A, then `run_slots_sampling`'s service B) and
    phase `slots_profile`: see the module docstring. Returns the launch
    counts of both services' main-path requests."""
    torch.cuda.reset_peak_memory_stats()
    tok = RoundTripTokenizer()
    svc = ChatService(cfg, core, tok, image_size=cfg.vis_encoder.image_size,
                      device=core.llm.norm.weight.device, **SLOTS_A)
    if (svc.max_prompt, svc.slot_max_len) != SLOTS_A_SHAPE:
        raise AssertionError(f"service A: (max_prompt, slot_max_len) "
                             f"{(svc.max_prompt, svc.slot_max_len)}")
    reqs = slot_requests()
    for r in reqs:
        n = len(svc._encode(r["prompt"], r.get("image"), r.get("history"))[0])
        if n >= SERVE_PROMPT:
            raise AssertionError(f"prompt of {n} tokens would be cut")
    srv = make_server(svc, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    rec = SlotRecorder(svc, SLOTS_A["decode_span"])
    streamed_req = dict(prompt="what is the capital of france")
    img0 = reqs[0]
    turn1_req = dict(prompt=img0["prompt"], image=img0["image"],
                     session="chat")
    per_wave = len(reqs) // SLOT_WAVES

    def wave_call(i):
        def call():
            time.sleep(SLOT_WAVE_GAP_S * (i // per_wave))
            return svc.generate(**reqs[i])
        return call

    # the main path, with the launch counts taken around it alone
    A.flash_attention.launches = 0
    Q.int4_matmul.launches = 0
    t0 = time.perf_counter()
    answers, errs = call_threads([wave_call(i) for i in range(len(reqs))],
                                 timeout=900)
    waves_s = time.perf_counter() - t0
    if any(errs):
        raise AssertionError(f"service A failed requests: {errs}")
    # time to first token of the requests admitted while slots decoded
    ttft = sorted((rec.first_token[r] - rec.submitted[r]) * 1e3
                  for r in rec.first_token if rec.live_at_admission[r] > 0)
    if not ttft:
        raise AssertionError("no request was admitted mid-decode")
    streamed = "".join(sse_deltas(url, streamed_req))
    turn1 = svc.generate(**turn1_req)
    history = [turn1_req["prompt"], turn1["text"]]
    turn2_req = dict(prompt="and what else is in it", image=img0["image"],
                     history=history, session="chat")
    turn2 = svc.generate(**turn2_req)
    torch.cuda.synchronize()
    launches_a = {"flash_attn_fwd": A.flash_attention.launches,
                  "int4_matmul": Q.int4_matmul.launches}
    rec.check_launches("service A", cfg, launches_a)
    counts_a = dict(rec.counts)
    metrics_a = svc.metrics()
    srv.shutdown()
    srv.server_close()

    secs = {"waves": waves_s, "main_path": time.perf_counter() - t0}
    t = time.perf_counter()
    # each request alone (every other slot dead), its full 32 tokens
    alone = [svc.generate(**{**r, "max_new_tokens": None}) for r in reqs]
    for i, (a, b) in enumerate(zip(answers, alone)):
        if a["ids"] != b["ids"][:len(a["ids"])]:
            raise AssertionError(f"request {i}: {a['ids']} with traffic, "
                                 f"{b['ids']} alone")
    blocking = svc.generate(**streamed_req)
    if streamed.strip() != blocking["text"]:
        raise AssertionError(f"SSE {streamed!r} != blocking "
                             f"{blocking['text']!r}")
    if (turn1["session_reused"], turn2["session_reused"]) != (False, True):
        raise AssertionError(f"session turns reused "
                             f"{turn1['session_reused']}, "
                             f"{turn2['session_reused']}")
    vocab = cfg.llm.vocab_size
    for a in answers + alone + [turn1, turn2, blocking]:
        if a["num_tokens"] < 1 or not all(0 <= t < vocab for t in a["ids"]):
            raise AssertionError(f"bad answer {a}")

    secs["alone_and_sse"] = time.perf_counter() - t
    t = time.perf_counter()
    with torch.no_grad():
        enc = [_Request(*svc._encode(r["prompt"], r.get("image"),
                                     r.get("history"))[:2]) for r in reqs]
        cmp_a = compare_slot_plain(svc, enc, [a["ids"] for a in alone],
                                   chunked=True)
        # a chunked admission's first-token logits vs a B1 prefill
        chunk_vs_mono = [rel_errs(o["logits"][0][0],
                                  monolithic_last_logits(svc, r))[0]
                         for o, r in zip(cmp_a, enc)]
        # the session turn's extension vs a fresh prefill of the whole
        # conversation
        conv = _Request(*svc._encode(turn2_req["prompt"], img0["image"],
                                     history)[:2])
        session_rel = rel_errs(rec.extend_last[-1],
                               monolithic_last_logits(svc, conv))[0]
    if not max(chunk_vs_mono + [session_rel]) <= LOGIT_REL_TOL:
        raise AssertionError(f"chunked vs B1 prefill {chunk_vs_mono}, "
                             f"session vs fresh prefill {session_rel}")
    plain_a = public(cmp_a)
    del cmp_a
    secs["plain_comparisons"] = time.perf_counter() - t
    t = time.perf_counter()
    engine = slot_engine_timings(svc, enc)
    svc.close()
    gc.collect()
    torch.cuda.empty_cache()
    secs["engine_and_profile"] = time.perf_counter() - t
    t = time.perf_counter()
    launches_b, summary_b = run_slots_sampling(core, cfg, tok)
    secs["service_b"] = time.perf_counter() - t
    emit({"phase": "slots", "nvidia_smi": nvidia_smi(),
          "config": "vllm_7b_chat_config quant=int4",
          "service_a": {**SLOTS_A, "max_prompt_rounded": svc.max_prompt,
                        "slot_max_len": svc.slot_max_len},
          "requests": len(reqs), "waves": SLOT_WAVES,
          "wave_gap_s": SLOT_WAVE_GAP_S, "waves_wall_s": waves_s,
          "waves_tok_per_s": sum(a["num_tokens"] for a in alone) / waves_s,
          "launches_a": launches_a, "work_a": counts_a,
          "answers": [{"num_tokens": a["num_tokens"], "text": a["text"][:40]}
                      for a in answers],
          "session_reused": [turn1["session_reused"],
                             turn2["session_reused"]],
          "session_vs_fresh_prefill_rel_err": session_rel,
          "chunked_vs_b1_prefill_rel_err_max": max(chunk_vs_mono),
          "plain_a": plain_a,
          "logit_rel_tol": LOGIT_REL_TOL,
          "ttft_mid_decode_ms": {"n": len(ttft), "min": ttft[0],
                                 "median": statistics.median(ttft),
                                 "max": ttft[-1], "all": ttft},
          "metrics_a": metrics_a, "seconds": secs,
          **engine, "service_b": summary_b,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {k: launches_a[k] + launches_b[k] for k in launches_a}


def slot_engine_timings(svc, enc):
    """Service A's engine driven directly on a fresh state: ms a tick
    with every slot live at span 1 and at span 4 (each tick ended by the
    service's one host read), the aggregate tok/s that gives, the longest
    gap between the ticks the live slots see while one slot is refilled
    by a chunked admission against a B1 prefill, and (phase
    `slots_profile`) one span-1 tick under torch.profiler."""
    core, S = svc.core, svc.slots
    step4 = svc._slot_step
    step1 = build_slot_fns(core, svc.tid, n_slots=S,
                           max_len=svc.slot_max_len, eos_id=svc.eos_id)[3]
    state, valid = svc._slot_init()
    with torch.no_grad():
        for s in range(S):
            ids, img, mask, _ = slot_row(svc, enc[s % len(enc)])
            pre = svc._slot_prefill(ids, img, mask)
            svc._slot_insert(state, s, pre["first"], pre["embed"],
                             pre["cache"], pre["valid"], valid)

        def tick(step):
            step(state, valid)["token"].cpu()
            return time.perf_counter()

        tick(step1)
        tick(step4)
        live = int(state.live.sum())
        ms = {}
        for span, step, n in ((1, step1, 8), (4, step4, 3)):
            t = time.perf_counter()
            for _ in range(n):
                tick(step)
            ms[span] = (time.perf_counter() - t) * 1e3 / n

        def admission_gap(chunked):
            slot = S - 1
            state.live[slot] = False            # the slot to refill
            r = enc[0]
            ids, img, mask, vrow = slot_row(svc, r)
            times = [tick(step4)]
            if chunked:
                W = svc.prefill_chunk
                emb = svc._chunk_embed(ids, img)
                row = svc._chunk_row()
                for k in range(svc.max_prompt // W):
                    row, last = svc._chunk_run(emb[:, k * W:(k + 1) * W],
                                               row, vrow)
                    times.append(tick(step4))
                first, embed, _ = svc._chunk_finish(last)
                svc._slot_insert(state, slot, first[0], embed, row, vrow,
                                 valid)
            else:
                pre = svc._slot_prefill(ids, img, mask)
                svc._slot_insert(state, slot, pre["first"], pre["embed"],
                                 pre["cache"], pre["valid"], valid)
            times.append(tick(step4))
            return max(b - a for a, b in zip(times, times[1:])) * 1e3

        admission_gap(True)                     # warm
        gaps = {"chunked": admission_gap(True),
                "monolithic": admission_gap(False)}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            tick(step1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    emit({"phase": "slots_profile", "live_slots": int(state.live.sum()),
          "nvidia_smi": nvidia_smi(), **device_summary(prof, wall_ms)})
    return {"live_slots_timed": live, "tick_ms_span1": ms[1],
            "tick_ms_span4": ms[4],
            "tok_per_s_span1": live * 1e3 / ms[1],
            "tok_per_s_span4": live * 4e3 / ms[4],
            "admission_max_tick_gap_ms": gaps}


def run_slots_sampling(core, cfg, tok):
    """Service B: 4 concurrent requests (two seeded at temperature 0.7 and
    top_p 0.9, one at temperature 0, one at top_p 1e-6); greedy ones
    equal their greedy answers alone, a seed alone twice and within the
    batch gives the same tokens, every sampled token lies in the
    nucleus of the kernel run's teacher-forced logits and of the plain
    run's (up to NUCLEUS_SLACK); then close() with live slots fails every
    waiting call within CLOSE_WAIT_S. Returns (launches, summary)."""
    svc = ChatService(cfg, core, tok, image_size=cfg.vis_encoder.image_size,
                      device=core.llm.norm.weight.device, **SLOTS_B)
    rec = SlotRecorder(svc, 1)
    images, _ = serve_requests()
    reqs = [dict(images[1], temperature=0.7, top_p=0.9, seed=11),
            dict(images[2], temperature=0.7, top_p=0.9, seed=12),
            dict(prompt="what is the capital of france", temperature=0.0),
            dict(images[3], temperature=0.7, top_p=1e-6, seed=13)]
    A.flash_attention.launches = 0
    Q.int4_matmul.launches = 0
    answers, errs = call_threads(
        [functools.partial(svc.generate, **r) for r in reqs], timeout=900)
    if any(errs):
        raise AssertionError(f"service B failed requests: {errs}")
    torch.cuda.synchronize()
    launches = {"flash_attn_fwd": A.flash_attention.launches,
                "int4_matmul": Q.int4_matmul.launches}
    rec.check_launches("service B", cfg, launches)
    counts = dict(rec.counts)

    greedy = [svc.generate(**{**r, "temperature": 0.0}) for r in reqs[2:]]
    for a, g in zip(answers[2:], greedy):
        if a["ids"] != g["ids"]:
            raise AssertionError(f"greedy row {a['ids']} != {g['ids']}")
    again = [svc.generate(**reqs[0]) for _ in range(2)]
    if not again[0]["ids"] == again[1]["ids"] == answers[0]["ids"]:
        raise AssertionError("a seed alone twice and in the batch gave "
                             f"{again[0]['ids']}, {again[1]['ids']}, "
                             f"{answers[0]['ids']}")
    with torch.no_grad():
        hot = reqs[:2]
        enc = [_Request(*svc._encode(r["prompt"], r["image"])[:2])
               for r in hot]
        cmp_b = compare_slot_plain(svc, enc, [a["ids"] for a in answers[:2]],
                                   chunked=False)
        kernel_in, plain_mass = True, 0.0
        for r, a, o in zip(hot, answers, cmp_b):
            k, p = o["logits"]
            T, top_p = r["temperature"], r["top_p"]
            kept = torch.isfinite(nucleus_filter(
                k / T, torch.full((len(k),), top_p, device=k.device)))
            ids = torch.tensor(a["ids"], device=k.device)
            kernel_in &= bool(kept[torch.arange(len(ids)), ids].all())
            plain_mass = max(plain_mass, *(preceding_mass(p[t], a["ids"][t], T)
                                           for t in range(len(ids))))
    if not kernel_in or not plain_mass < reqs[0]["top_p"] + NUCLEUS_SLACK:
        raise AssertionError(f"sampled tokens outside the nucleus: kernel "
                             f"{kernel_in}, plain preceding mass "
                             f"{plain_mass}")
    plain_b = public(cmp_b)
    del cmp_b

    # close() while every slot decodes: no call may be left waiting
    n0 = len(rec.first_token)
    closing = [functools.partial(svc.generate, **r) for r in reqs]
    box = {}
    th = threading.Thread(target=lambda: box.update(
        out=call_threads(closing, CLOSE_WAIT_S + 30)), daemon=True)
    th.start()
    deadline = time.perf_counter() + 60
    while len(rec.first_token) < n0 + len(reqs):
        if time.perf_counter() > deadline:
            raise AssertionError("service B admitted no closing request")
        time.sleep(0.005)
    t = time.perf_counter()
    svc.close()
    th.join(CLOSE_WAIT_S)
    close_s = time.perf_counter() - t
    if th.is_alive() or close_s > CLOSE_WAIT_S:
        raise AssertionError(f"calls still wait {close_s} s after close()")
    res, errs = box["out"]
    if not all(isinstance(e, RuntimeError) for e in errs):
        raise AssertionError(f"after close(): results {res}, errors {errs}")
    return launches, {
        **SLOTS_B, "work": counts, "launches": launches,
        "answers": [{"temperature": r["temperature"],
                     "top_p": r.get("top_p", 1.0), "ids": a["ids"][:8]}
                    for r, a in zip(reqs, answers)],
        "greedy_rows_equal_alone": True, "seed_repeats": True,
        "in_kernel_nucleus": kernel_in,
        "plain_preceding_mass_max": plain_mass,
        "nucleus_slack": NUCLEUS_SLACK, "plain": plain_b,
        "close_s": close_s, "closed_calls_failed": len(errs)}


# ---------------------------------------------------------------------------
# phase 12: speculative decoding on the chat core
# ---------------------------------------------------------------------------

SPEC_K = 7
# the direct call: [GEN] forces 64 [EMB] rows, ceil(64 / (k + 1)) = 8
# windows, then 7 drafted tokens
SPEC_FORCED_NEW = 72
# a speculative token may differ from the plain loop's only at a near-tie
# of the plain run: its top-2 logit gap within this many bf16 ulps of the
# top logit (the window and the step reduce in other orders)
NEAR_TIE_ULPS = 4


def spec_flash_per_request(cfg, has_image):
    """Flash launches of one speculative request: CLIP's and LLaMA's
    prefill, or LLaMA's alone for a text-only request (no vision encode)."""
    return cfg.llm.num_layers + cfg.vis_encoder.num_layers * has_image


def bf16_ulp(x):
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def decode_inputs(core, tid, tokens):
    """The decode inputs [1, n - 1, C] the step loop feeds after emitting
    `tokens` [n] (vocab embeddings, or [EMB] table rows while a countdown
    runs)."""
    cfg = core.cfg
    t = torch.tensor([tokens], dtype=torch.int32,
                     device=core.llm.norm.weight.device)
    kind = _tool_kind(t[:, 0], tid)
    total = torch.where(kind >= C.TOOL_GEN,
                        torch.full_like(kind, cfg.num_embs_gen),
                        torch.full_like(kind, cfg.num_embs))
    countdown = torch.where(kind > 0, total, torch.zeros_like(kind))
    embeds = [core.embed_tokens(t[:, :1].long())]
    for i in range(1, len(tokens) - 1):
        _, e, countdown, kind = advance_tool_state(
            core, tid, cfg.num_embs, cfg.num_embs_gen, t[:, i], countdown,
            kind)
        embeds.append(e)
    return torch.cat(embeds, 1)


def window_teacher_forced(core, tid, ids, imgs, mask, tokens, width,
                          max_len):
    """fp32 logits [len(tokens), V] of a B1 prefill and of the decode fed
    `tokens`, `width` inputs a forward: decode steps (`llm_step`) at width
    1, verify windows (`llm_window`) above."""
    B, L = ids.shape
    cache = core.new_cache(B, max_len)
    out = core(ids, imgs, tid, attn_mask=mask, cache=cache)
    dmask = torch.cat([mask, torch.ones(B, max_len - L, dtype=torch.bool,
                                        device=ids.device)], 1)
    inputs = decode_inputs(core, tid, tokens)
    logits = [out["logits"][0, -1].float()]
    for s in range(0, inputs.shape[1], width):
        e = inputs[:, s:s + width]
        pos = (cache.index + torch.arange(e.shape[1], device=ids.device))[
            None]
        fwd = core.llm_step if width == 1 else core.llm_window
        logits.extend(fwd(e, pos, cache, dmask)["logits"][0].float())
    return torch.stack(logits)


def spec_token_rule(core, tid, packed, spec_ids, plain_ids, width,
                    max_len):
    """The card's token rule for a speculative answer against the plain
    greedy loop's: equal, or differing first where the plain run's top-2
    gap is a near-tie; and the windowed decode's logits, teacher-forced
    on the plain tokens, within LOGIT_REL_TOL of the step loop's."""
    ids, imgs, mask = packed
    step = window_teacher_forced(core, tid, ids, imgs, mask, plain_ids, 1,
                                 max_len)
    win = window_teacher_forced(core, tid, ids, imgs, mask, plain_ids,
                                width, max_len)
    rel = max(rel_errs(win, step))
    res = near_tie_rule("speculative", spec_ids, plain_ids, step)
    res["window_vs_step_rel_err"] = rel
    if not rel <= LOGIT_REL_TOL:
        raise AssertionError(f"window vs step logits: rel err {rel}")
    return res


def spec_packed(svc, r):
    """A request's B1 ids, pixels (None when text-only) and mask as the
    speculative service runs it."""
    req = _Request(*svc._encode(r["prompt"], r.get("image"),
                                r.get("history"))[:2])
    ids, imgs, mask, _ = svc._pack([req])
    return ids, (None if r.get("image") is None else imgs), mask


def run_spec(core, cfg):
    """Phase `spec`: see the module docstring. Returns the launch counts of
    the speculative service's requests."""
    t_phase = time.perf_counter()
    tok, dev = SimpleTokenizer(), core.llm.norm.weight.device
    kw = dict(image_size=cfg.vis_encoder.image_size, max_batch=1,
              max_prompt=SERVE_PROMPT, max_new_tokens=SERVE_NEW, device=dev)
    spec = ChatService(cfg, core, tok, spec_k=SPEC_K, **kw)
    plain = ChatService(cfg, core, tok, **kw)
    images, text = serve_requests()
    reqs = [images[0], text, images[2]]
    srv = make_server(spec, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/v1/generate"
    last = reqs[-1]
    body = {"prompt": last["prompt"],
            "image_b64": base64.b64encode(last["image"].tobytes()).decode(),
            "image_shape": list(last["image"].shape)}
    calls, answers = [], []
    # the main path, with the launch counts taken around it alone
    A.flash_attention.launches = 0
    Q.int4_matmul.launches = 0
    with torch.no_grad():
        for i, r in enumerate(reqs):
            f0, q0 = A.flash_attention.launches, Q.int4_matmul.launches
            w0, s0 = spec._spec_windows, spec.stats["steps_total"]
            speculative = not spec._spec_disabled
            t0 = time.perf_counter()
            answers.append(post_json(url, body) if r is last
                           else spec.generate(**r))
            calls.append({"request": i, "over_http": r is last,
                          "image": r.get("image") is not None,
                          "speculative": speculative,
                          "wall_ms": (time.perf_counter() - t0) * 1e3,
                          "num_tokens": answers[-1]["num_tokens"],
                          "num_generated": spec.stats["steps_total"] - s0,
                          "windows": spec._spec_windows - w0,
                          "flash": A.flash_attention.launches - f0,
                          "int4": Q.int4_matmul.launches - q0})
    torch.cuda.synchronize()
    launches = {"flash_attn_fwd": A.flash_attention.launches,
                "int4_matmul": Q.int4_matmul.launches}
    srv.shutdown()
    srv.server_close()
    per_fwd_int4 = 7 * cfg.llm.num_layers + 1
    for c in calls:
        # a window is one forward; once the auto-disable fired, a request
        # runs the plain loop (its zero image through CLIP, one forward a
        # token)
        if c["speculative"]:
            want = (spec_flash_per_request(cfg, c["image"]),
                    per_fwd_int4 * (1 + c["windows"]))
        else:
            want = (spec_flash_per_request(cfg, True),
                    per_fwd_int4 * c["num_generated"])
        if (c["flash"], c["int4"]) != want or \
                c["speculative"] != (c["windows"] > 0):
            raise AssertionError(f"spec launches {c} != (flash, int4) "
                                 f"{want}")
    if not calls[0]["speculative"]:
        raise AssertionError("no request ran speculative windows")
    metrics = spec.metrics()
    fired = metrics["spec_disabled"]
    if metrics["mode"] != ("batch1" if fired else "speculative") or \
            metrics["spec_windows_total"] != sum(c["windows"] for c in calls):
        raise AssertionError(f"spec metrics {metrics}")
    vocab = cfg.llm.vocab_size
    with torch.no_grad():
        plain_answers = [plain.generate(**r) for r in reqs]
        rules = []
        for r, a, p in zip(reqs, answers, plain_answers):
            for x in (a, p):
                if x["num_tokens"] < 1 or \
                        not all(0 <= t < vocab for t in x["ids"]):
                    raise AssertionError(f"bad answer {x}")
            rules.append(spec_token_rule(
                core, spec.tid, spec_packed(spec, r), a["ids"], p["ids"],
                SPEC_K + 1, SERVE_PROMPT + SERVE_NEW + 8))
        direct = spec_direct(core, spec, reqs[0])
    spec.close()
    plain.close()
    emit({"phase": "spec", "nvidia_smi": nvidia_smi(),
          "config": "vllm_7b_chat_config quant=int4", "spec_k": SPEC_K,
          "max_prompt": SERVE_PROMPT, "max_new_tokens": SERVE_NEW,
          "calls": calls, "launches": launches, "metrics": metrics,
          "spec_tokens_per_window": metrics["spec_tokens_per_window"],
          "auto_disable_fired": metrics["spec_disabled"],
          "token_rule": rules, "near_tie_ulps": NEAR_TIE_ULPS,
          "identical_requests": sum(r["identical"] for r in rules),
          "requests": len(rules), "logit_rel_tol": LOGIT_REL_TOL,
          "answers": [a["text"][:40] for a in answers], **direct,
          "seconds": time.perf_counter() - t_phase})
    return launches


def spec_direct(core, svc, r):
    """`build_speculative_generate_fn` called directly on request `r` with
    the [GEN] countdown forced (first_token), against `build_generate_fn`:
    the token rule, the 8 windows of the 64 forced rows, and ms per
    emitted token of both on `r` as the model answers it and forced (one
    timed call each, the functions warm from the service's requests)."""
    tid, eos = svc.tid, svc.eos_id
    ids, imgs, mask = spec_packed(svc, r)
    n_gen = core.cfg.num_embs_gen
    max_len = SERVE_PROMPT + SPEC_FORCED_NEW + 8

    def fns(max_new):
        return (build_speculative_generate_fn(
                    core, tid, max_new_tokens=max_new, eos_id=eos,
                    max_len=max_len, k_draft=SPEC_K),
                build_generate_fn(core, tid, max_new_tokens=max_new,
                                  eos_id=eos, max_len=max_len))

    def timed(fn, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(ids, imgs, attn_mask=mask, **kw)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    sgen, pgen = fns(SPEC_FORCED_NEW)
    first = torch.tensor([tid.gen], dtype=torch.int32, device=ids.device)
    so, so_ms = timed(sgen, first_token=first)
    po, po_ms = timed(pgen, first_token=first)
    s_ids = so["out_tokens"][0, :so["num_generated"]].tolist()
    p_ids = po["out_tokens"][0, :po["num_generated"]].tolist()
    if s_ids[1:1 + n_gen] != [tid.emb] * n_gen:
        raise AssertionError(f"forced [EMB] rows: {s_ids[:n_gen + 1]}")
    rule = spec_token_rule(core, tid, (ids, imgs, mask), s_ids, p_ids,
                           SPEC_K + 1, max_len)
    # the forced rows alone: [GEN] + 64 [EMB] in ceil(64 / 8) windows
    s65 = fns(1 + n_gen)[0](ids, imgs, first_token=first, attn_mask=mask)
    want_w = -(-n_gen // (SPEC_K + 1))
    if s65["num_windows"] != want_w:
        raise AssertionError(f"{n_gen} forced rows took "
                             f"{s65['num_windows']} windows, want {want_w}")
    sgen32, pgen32 = fns(SERVE_NEW)
    free, free_ms = timed(sgen32)
    pfree, pfree_ms = timed(pgen32)
    ms = {}
    for name, s_ms, p_ms, n, pn in (
            ("forced", so_ms, po_ms, so["num_generated"],
             po["num_generated"]),
            ("free", free_ms, pfree_ms, free["num_generated"],
             pfree["num_generated"])):
        ms[name] = {"tokens": n, "spec_ms_per_token": s_ms / n,
                    "plain_b1_ms_per_token": p_ms / pn,
                    "spec_over_plain": (s_ms / n) / (p_ms / pn)}
    return {"direct_forced": {
                "max_new_tokens": SPEC_FORCED_NEW,
                "num_generated": so["num_generated"],
                "windows": so["num_windows"],
                "tokens_per_window": (so["num_generated"] - 1)
                / so["num_windows"],
                "forced_rows_windows": s65["num_windows"], **rule},
            "direct_free": {"num_generated": free["num_generated"],
                            "windows": free["num_windows"],
                            "tokens_per_window": (free["num_generated"] - 1)
                            / max(free["num_windows"], 1)},
            "ms_per_token": ms}


# ---------------------------------------------------------------------------
# phase 13: the int8 serving modes on the bf16 chat core
# ---------------------------------------------------------------------------

# int8 and w8a8 logits against the bf16 core's, teacher-forced on the bf16
# run's tokens over 32 layers of random weights: cosine and argmax
# agreement bounds (measured on the card: cosine 0.99943 int8, 0.99896
# w8a8; agreement 0.945, 0.930)
QUANT_COS_MIN = {"int8": 0.998, "w8a8": 0.997}
QUANT_AGREE_MIN = 0.85
# the int8-KV slot service: 6 requests, 2 waves, the slot buffer of the
# slots phase's service A (1288 positions)
KV_SLOTS = dict(slots=8, max_prompt=SERVE_PROMPT, max_new_tokens=SERVE_NEW,
                max_ctx=SLOTS_A_SHAPE[1])
KV_WAVES = 2
# the int8 products' shapes: (K, N) of an MLP projection and lm_head, rows
# of a decode step, a slot tick and a [4, 640] prefill; the int8-KV decode
# attention of one layer at 8 slots x 1288 (slots, T, heads, head dim)
INT8_PRODUCT_SHAPES = ((4096, 11008), (4096, 32096))
INT8_PRODUCT_ROWS = (4, 8, 2560)
KV_DECODE_SHAPE = (8, 1288, 32, 128)
# the JAX service's refusal of the README's chunked int8-KV command
CHUNKED_INT8_KV = ("chunked prefill with an int8 KV cache is not exact: "
                   "monolithic prefill attends the fresh bf16 window while "
                   "chunk windows read back the quantized cache — run "
                   "--prefill-chunk without --kv-quant")


def set_modes(core, quant, kv_quant=""):
    """Serve `core`'s int8 tree in mode `quant` ("int8" or "w8a8", the same
    buffers) with `kv_quant`; returns the config the core now carries."""
    Q8.quantize_llm_int8(core.llm, act=quant == "w8a8")
    cfg = core.cfg
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, quant=quant, kv_quant=kv_quant))
    core.cfg, core.llm.cfg = cfg, cfg.llm
    return cfg


def logit_agreement(got, want):
    """Cosine of the flattened logits and top-1 agreement of [n, B, V]."""
    cos = F.cosine_similarity(got.flatten(), want.flatten(), dim=0).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    return cos, agree


def run_quant(cfg=None, device="cuda"):
    """Phase `quant`: see the module docstring. Returns the flash launches
    of its main-path requests."""
    t_phase = time.perf_counter()
    secs = {}
    torch.cuda.reset_peak_memory_stats()
    cfg = cfg or vllm_7b_chat_config()
    core = build_core(cfg, device=device, dtype=torch.bfloat16, seed=0)
    tok = SimpleTokenizer()
    images, _ = serve_requests()
    kw = dict(image_size=cfg.vis_encoder.image_size, max_batch=SERVE_BATCH,
              max_prompt=SERVE_PROMPT, max_new_tokens=SERVE_NEW,
              batch_window_ms=BATCH_WINDOW_MS, device=device)
    with torch.no_grad():
        svc = ChatService(cfg, core, tok, **kw)
        enc = [_Request(*svc._encode(r["prompt"], r["image"])[:2])
               for r in images]
        packed = svc._pack(enc)
        ids, imgs, mask, live = packed
        out = svc.generate_fn(ids, imgs, attn_mask=mask, live=live)
        n_gen, toks = int(out["num_generated"]), out["out_tokens"]
        ref = teacher_forced(svc, ids, imgs, mask, toks, n_gen)
        svc.close()
        layer0 = {n: getattr(core.llm.layers[0], n).weight.cpu()
                  for n in ("q_proj", "down_proj")}
        torch.cuda.synchronize()
        t = time.perf_counter()
        Q8.quantize_llm_int8(core.llm)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t
        secs["bf16_reference_and_quantize"] = t - t_phase + quantize_s
        for name, w in layer0.items():
            mod = getattr(core.llm.layers[0], name)
            wq, s = Q8.quantize_int8(w, dim=-1)
            if not (torch.equal(mod.kernel_q.cpu(), wq)
                    and torch.equal(mod.scale.cpu(), s)):
                raise AssertionError(f"layer 0 {name}: the card's int8 "
                                     "quantization differs from the CPU's")
        del layer0
    n_int8 = sum(isinstance(m, Q8.Int8Linear) for m in core.modules())
    if n_int8 != 7 * cfg.llm.num_layers + 1:
        raise AssertionError(f"{n_int8} int8 modules")
    weight_bytes = sum(m.kernel_q.numel() + 2 * m.scale.numel()
                       for m in core.modules()
                       if isinstance(m, Q8.Int8Linear))
    launches = {"flash_attn_fwd": 0}
    modes = {}
    for mode in ("int8", "w8a8"):
        t = time.perf_counter()
        mcfg = set_modes(core, mode)
        svc = ChatService(mcfg, core, tok, **kw)
        torch.cuda.reset_peak_memory_stats()
        # the main path, with the launch counts taken around it alone
        A.flash_attention.launches = 0
        with torch.no_grad():
            b0 = svc.stats["batches_total"]
            answers, errs = call_threads(
                [functools.partial(svc.generate, **r) for r in images],
                timeout=900)
            torch.cuda.synchronize()
        flash = A.flash_attention.launches
        launches["flash_attn_fwd"] += flash
        calls = svc.stats["batches_total"] - b0
        if any(errs) or calls != 1 or flash != quant_flash_per_call(cfg):
            raise AssertionError(f"{mode}: errors {errs}, {calls} generate "
                                 f"calls, flash {flash}")
        for a in answers:
            if a["num_tokens"] < 1 or not all(
                    0 <= t < cfg.llm.vocab_size for t in a["ids"]):
                raise AssertionError(f"{mode}: bad answer {a}")
        with torch.no_grad():
            step_ms = []
            got = teacher_forced(svc, ids, imgs, mask, toks, n_gen, step_ms)
            cos, agree = logit_agreement(got, ref)
            if not (cos >= QUANT_COS_MIN[mode] and agree >= QUANT_AGREE_MIN):
                raise AssertionError(f"{mode} vs bf16 logits: cos {cos}, "
                                     f"top-1 agreement {agree}")
            timings = serve_timings(svc, packed, n_generate=2,
                                    step_ms=step_ms)
        modes[mode] = {"cos_vs_bf16": cos, "top1_agreement_vs_bf16": agree,
                       "cos_min": QUANT_COS_MIN[mode],
                       "agree_min": QUANT_AGREE_MIN, "flash": flash,
                       "answers": [a["num_tokens"] for a in answers],
                       **timings,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        svc.close()
        secs[mode] = time.perf_counter() - t
    kv_cfg = set_modes(core, "int8", "int8")
    try:
        ChatService(kv_cfg, core, tok, prefill_chunk=256, device=device,
                    image_size=cfg.vis_encoder.image_size, **KV_SLOTS)
        raise AssertionError("the chunked int8-KV command was accepted")
    except ValueError as e:
        if str(e) != CHUNKED_INT8_KV:
            raise AssertionError(f"chunked int8-KV refusal: {e}") from e
    t = time.perf_counter()
    kv, kv_flash = run_int8_kv_slots(core, kv_cfg, tok, device)
    launches["flash_attn_fwd"] += kv_flash
    secs["int8_kv_slots"] = time.perf_counter() - t
    t = time.perf_counter()
    products = check_int8_products(torch.Generator(device=device)
                                   .manual_seed(0), device)
    secs["products"] = time.perf_counter() - t
    del core
    gc.collect()
    emit({"phase": "quant", "nvidia_smi": nvidia_smi(),
          "config": "vllm_7b_chat_config, bf16 then int8 in place",
          "quantize_s": quantize_s, "int8_modules": n_int8,
          "int8_weight_gb": weight_bytes / 1e9,
          "max_batch": SERVE_BATCH, "max_prompt": SERVE_PROMPT,
          "max_new_tokens": SERVE_NEW, "teacher_forced_steps": n_gen,
          "modes": modes, "int8_kv_slots": kv,
          "chunked_int8_kv_refused": True,
          "products": [p["case"] for p in products], "launches": launches,
          "seconds": time.perf_counter() - t_phase, "seconds_by_part": secs})
    return launches


def quant_flash_per_call(cfg):
    """Flash launches of a micro-batching generate call: CLIP's and
    LLaMA's prefill."""
    return cfg.vis_encoder.num_layers + cfg.llm.num_layers


def run_int8_kv_slots(core, cfg, tok, device):
    """The int8-KV slot service (`ChatService(slots=8)`, span 1, no chunks
    or sessions): 6 requests in 2 waves, each equal to its tokens alone in
    the same service; the slot state's bytes; ms a tick with 8 live slots
    and one profiled tick. Returns (summary, flash launches)."""
    svc = ChatService(cfg, core, tok, image_size=cfg.vis_encoder.image_size,
                      device=device, **KV_SLOTS)
    rec = SlotRecorder(svc, 1)
    reqs = slot_requests()[:6]
    per_wave = len(reqs) // KV_WAVES

    def wave_call(i):
        def call():
            time.sleep(SLOT_WAVE_GAP_S * (i // per_wave))
            return svc.generate(**reqs[i])
        return call

    A.flash_attention.launches = 0
    t0 = time.perf_counter()
    answers, errs = call_threads([wave_call(i) for i in range(len(reqs))],
                                 timeout=900)
    waves_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    flash = A.flash_attention.launches
    if any(errs):
        raise AssertionError(f"int8-KV slot service failed: {errs}")
    if flash != rec.expected_launches(cfg)[0] or rec.counts["prefills"] != 6:
        raise AssertionError(f"int8-KV slots: flash {flash} for "
                             f"{rec.counts}")
    alone = [svc.generate(**{**r, "max_new_tokens": None}) for r in reqs]
    for i, (a, b) in enumerate(zip(answers, alone)):
        if a["ids"] != b["ids"][:len(a["ids"])]:
            raise AssertionError(f"int8-KV request {i}: {a['ids']} with "
                                 f"traffic, {b['ids']} alone")
    state, valid = svc._slot_init()
    c = state.cache
    if c.k.dtype != torch.int8:
        raise AssertionError(f"slot cache dtype {c.k.dtype}")
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in (c.k, c.v, c.k_scale, c.v_scale))
    scale_bytes = sum(t.numel() * t.element_size()
                      for t in (c.k_scale, c.v_scale))
    enc = [_Request(*svc._encode(r["prompt"], r.get("image"),
                                 r.get("history"))[:2]) for r in reqs]
    with torch.no_grad():
        for s in range(svc.slots):
            ids, img, mask, _ = slot_row(svc, enc[s % len(enc)])
            pre = svc._slot_prefill(ids, img, mask)
            svc._slot_insert(state, s, pre["first"], pre["embed"],
                             pre["cache"], pre["valid"], valid)

        def tick():
            svc._slot_step(state, valid)["token"].cpu()

        tick()
        t = time.perf_counter()
        for _ in range(8):
            tick()
        tick_ms = (time.perf_counter() - t) * 1e3 / 8
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            tick()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    live = int(state.live.sum())
    del state, c
    svc.close()
    return {"service": KV_SLOTS, "slot_max_len": svc.slot_max_len,
            "requests": len(reqs), "waves": KV_WAVES,
            "waves_wall_s": waves_s, "work": dict(rec.counts),
            "flash": flash, "equal_alone": True,
            "slot_state_kv_gb": kv_bytes / 1e9,
            "slot_state_scales_mb": scale_bytes / 1e6,
            "live_slots_timed": live, "tick_ms_span1": tick_ms,
            "tok_per_s_span1": live * 1e3 / tick_ms,
            "profiled_tick": device_summary(prof, wall_ms)}, flash


def check_int8_products(g, device):
    """Per-call device time of the int8 products at the chat path's shapes,
    beside the bf16 `F.linear` and the int4 kernel on the same shapes:
    `Int8Linear` and `Int8ActLinear` at M 4, 8 (decode, a slot tick) and
    2560 (a [4, 640] prefill) for 4096x11008 and 4096x32096; and
    `int8_kv_attention` against the bf16 einsum decode at 8 slots x 1288.
    The w8a8 int32 product (`torch._int_mm`, rows padded to 17) must equal
    the exact float64 product."""
    cases, timed = [], {}
    for K, N in INT8_PRODUCT_SHAPES:
        # QUANT_COPIES weight sets rotated, so decode reads them cold
        sets = []
        for _ in range(QUANT_COPIES):
            w = torch.randn(N, K, generator=g, device=device) * K ** -0.5
            lin = torch.nn.Linear(K, N, bias=False, device=device,
                                  dtype=torch.bfloat16)
            lin.weight.data.copy_(w)
            w8 = Q8.Int8Linear.from_linear(lin)
            sets.append((lin, w8, Q8.Int8ActLinear.sharing(w8),
                         *Q.pack_int4(w.t().contiguous())))
            del w
        lin, w8, a8, _, _ = sets[0]
        deq = (w8.kernel_q.float() * w8.scale.float()[:, None])
        for M_ in INT8_PRODUCT_ROWS:
            name = f"m{M_}_{K}x{N}"
            x = torch.randn(M_, K, generator=g, device=device).to(
                torch.bfloat16)
            xq = torch.randint(-127, 128, (M_, K), generator=g,
                               device=device, dtype=torch.int8)
            exact = (xq.double() @ w8.kernel_q.double().t()).to(torch.int32)
            if not torch.equal(Q8.int8_matmul(xq, w8.kernel_q), exact):
                raise AssertionError(f"int8_matmul[{name}] is not exact")
            want = x.float() @ deq.t()
            err = check_close(f"Int8Linear[{name}]", w8(x), want)
            err_a8 = check_close(f"Int8ActLinear[{name}]", a8(x), want)
            del exact, want
            fns = {"int8": lambda s, x: s[1](x), "w8a8": lambda s, x: s[2](x),
                   "bf16": lambda s, x: F.linear(x, s[0].weight),
                   "int4": lambda s, x: Q.int4_matmul(x, s[3], s[4])}
            for k, fn in fns.items():
                timed[f"{name}:{k}"] = rotating(fn, [(st, x) for st in sets])
            io = 2 * M_ * K + 2 * M_ * N
            ops = 2 * M_ * K * N
            cases.append({
                "case": name, "shape": [M_, K, N],
                "max_abs_err_int8": err, "max_abs_err_w8a8": err_a8,
                "int_mm_exact": True, "weight_copies_rotated": QUANT_COPIES,
                "bound_ms_int8": bound(io + N * K + 2 * N, ops,
                                       BF16_TENSOR_FLOPS)[0],
                "bound_ms_w8a8": bound(io + N * K + 2 * N, ops,
                                       INT8_TENSOR_OPS)[0],
                "bound_ms_bf16": bound(io + 2 * N * K, ops,
                                       BF16_TENSOR_FLOPS)[0],
                "bound_ms_int4": bound(io + N * K // 2 + 2 * (K // 128) * N,
                                       ops, BF16_TENSOR_FLOPS)[0]})
        del deq
    # int8 KV decode attention, one layer at 8 slots x 1288
    S, T, H, D = KV_DECODE_SHAPE
    q = torch.randn(S, 1, H, D, generator=g, device=device).to(
        torch.bfloat16)
    kv = [torch.randn(S, T, H, D, generator=g, device=device).to(
        torch.bfloat16) for _ in range(2)]
    (kq, ks), (vq, vs) = (Q8.quantize_kv(t) for t in kv)
    mask = torch.ones(S, 1, 1, T, dtype=torch.bool, device=device)
    mask[:, :, :, T // 2:] = False
    got = Q8.int8_kv_attention(q, kq, ks, vq, vs, mask)
    deq = [(t.float() * s.float()[..., None]) for t, s in ((kq, ks),
                                                           (vq, vs))]
    ref = A._einsum_attention(q.float(), deq[0], deq[1], mask, D ** -0.5)
    err_kv = check_close("int8_kv_attention", got, ref)
    del deq, ref
    timed["kv_decode:int8"] = lambda: Q8.int8_kv_attention(q, kq, ks, vq,
                                                           vs, mask)
    timed["kv_decode:bf16"] = lambda: A._einsum_attention(
        q, kv[0], kv[1], mask, D ** -0.5)
    dev, stray = device_ms(timed, n=10)
    for case in cases:
        for k in ("int8", "w8a8", "bf16", "int4"):
            d = dev[f"{case['case']}:{k}"]
            case[f"{k}_device_ms"] = d["ms"]
            case[f"{k}_kernels_per_call"] = d["kernels_per_call"]
    kv_case = {"case": f"kv_decode_s{S}_t{T}_h{H}_d{D}",
               "max_abs_err": err_kv,
               "int8_device_ms": dev["kv_decode:int8"]["ms"],
               "int8_kernels_per_call":
                   dev["kv_decode:int8"]["kernels_per_call"],
               "bf16_einsum_device_ms": dev["kv_decode:bf16"]["ms"],
               "bound_ms_int8": bound(2 * S * T * H * (D + 2) + 4 * S * H * D,
                                      4 * S * H * T * D,
                                      BF16_TENSOR_FLOPS)[0],
               "bound_ms_bf16": bound(4 * S * T * H * D + 4 * S * H * D,
                                      4 * S * H * T * D,
                                      BF16_TENSOR_FLOPS)[0]}
    for case in cases + [kv_case]:
        emit({"phase": "kernel", "kernel": "int8_products",
              "profiler_stray_kernels": stray, **case})
    del timed
    torch.cuda.empty_cache()
    return cases + [kv_case]


# ---------------------------------------------------------------------------
# phases 23-24: the det and grounding evaluation path at full width
# ---------------------------------------------------------------------------

# COCO 2017's 80 categories (id, name)
COCO_CATEGORIES = tuple(enumerate((
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", None, "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", None, "backpack", "umbrella",
    None, None, "handbag", "tie", "suitcase", "frisbee", "skis",
    "snowboard", "sports ball", "kite", "baseball bat", "baseball glove",
    "skateboard", "surfboard", "tennis racket", "bottle", None,
    "wine glass", "cup", "fork", "knife", "spoon", "bowl", "banana",
    "apple", "sandwich", "orange", "broccoli", "carrot", "hot dog", "pizza",
    "donut", "cake", "chair", "couch", "potted plant", "bed", None,
    "dining table", None, None, "toilet", None, "tv", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "microwave", "oven", "toaster",
    "sink", "refrigerator", None, "book", "clock", "vase", "scissors",
    "teddy bear", "hair drier", "toothbrush"), start=1))
COCO_CATEGORIES = tuple((i, n) for i, n in COCO_CATEGORIES if n)
# (h, w): 8 in the 800x1088 bucket (one full B8 batch), 3 in 1088x800 (a
# padded tail), 1 in 800x1344 (a tail of one)
EVAL_SIZES = ((480, 640),) * 8 + ((640, 480),) * 3 + ((427, 640),)
# detections kept an image: 10, not COCO's 100, so the B8 run finishes 120
# masks on the host, not 1200 (each about 50 ms)
EVAL_BATCH, EVAL_TOPK, EVAL_REL_TOL = 8, 10, 5e-2
EVAL_REFS = 8                   # RefCOCO expressions
EVAL_POPE, EVAL_MMBENCH = 4, 2  # benchmark rows
EVAL_VQA_BATCH, EVAL_VQA_NEW, EVAL_VQA_MAX_LEN = 4, 8, 768
EVAL_MARGIN = 5e-2              # the B1/B4 token rule's top-2 logit gap


def png_bytes(img):
    """uint8 [H, W, 3] as an 8-bit RGB PNG, row r filtered with PNG filter
    r % 5 (None, Sub, Up, Average, Paeth), so the port's reader undoes each
    on the card's machine, which has no Pillow."""
    h, w, _ = img.shape
    x = img.astype(np.int16)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    kinds = np.arange(h) % 5
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])[
        kinds, np.arange(h)]
    rows = np.concatenate([kinds[:, None].astype(np.uint8),
                           ((x - pred) & 0xFF).astype(np.uint8)
                           .reshape(h, -1)], axis=1)

    return (PNG_MAGIC
            + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                             0))
            + png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + png_chunk(b"IEND", b""))


def png_chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def eval_image(rng, h, w):
    """A smooth seeded picture: gradients and blobs under mild noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // w, yy * 255 // h,
                    (xx + yy) * 255 // (h + w)], -1).astype(np.int32)
    img += rng.integers(-12, 13, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def eval_blob(rng, h, w, r_min=12.0):
    """A smooth closed contour sampled every 2-8 px (fractional vertices),
    as an annotator's polygon."""
    side = min(h, w)
    R = rng.uniform(min(r_min, side / 8), side / 4)
    cx, cy = rng.uniform(R, w - R), rng.uniform(R, h - R)
    n = max(3, int(2 * np.pi * R / rng.uniform(2, 8)))
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    rad = R * (1 + 0.2 * np.sin(3 * ang + rng.uniform(0, 6.3)))
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)],
                    1).ravel().tolist()


def uncompressed_rle(mask):
    col = mask.T.reshape(-1)
    change = np.nonzero(np.diff(col))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [col.size]])).tolist()
    return {"size": list(mask.shape),
            "counts": [0] + runs if col[0] == 1 else runs}


def write_eval_set(root):
    """The synthetic COCO set under `root` (numpy seed 17, written without
    Pillow): `EVAL_SIZES` PNG images with 3-6 objects each (polygon lists,
    uncompressed and compressed RLE masks; one crowd object and one box
    under 1 px), over the 80 COCO categories; a RefCOCO-style file of
    `EVAL_REFS` expressions, a POPE jsonl and an MMBench tsv with base64
    PNGs. Returns the files' paths and the images."""
    rng = np.random.default_rng(17)
    images, anns, pictures = [], [], []
    for i, (h, w) in enumerate(EVAL_SIZES):
        img = eval_image(rng, h, w)
        pictures.append(img)
        name = f"{i:012d}.png"
        with open(os.path.join(root, name), "wb") as f:
            f.write(png_bytes(img))
        images.append({"id": 100 + i, "file_name": name, "height": h,
                       "width": w})
        for j in range(int(rng.integers(3, 7))):
            polys = [eval_blob(rng, h, w)
                     for _ in range(1 + (j % 4 == 3))]
            mask = rasterize_polygons(polys, h, w)
            seg = (polys, uncompressed_rle(mask), rle_encode(mask))[j % 3]
            ys, xs = np.nonzero(mask)
            x0, y0 = float(xs.min()), float(ys.min())
            anns.append({
                "id": len(anns) + 1, "image_id": 100 + i,
                "category_id": COCO_CATEGORIES[int(rng.integers(0, 80))][0],
                "bbox": [x0, y0, float(xs.max()) + 1 - x0,
                         float(ys.max()) + 1 - y0],
                "area": float(mask.sum()), "iscrowd": 0,
                "segmentation": seg})
    anns[0].update(iscrowd=1, segmentation=rle_encode(decode_segmentation(
        anns[0]["segmentation"], *EVAL_SIZES[0])))
    # a one-pixel column whose box is 0.6 px wide
    h, w = EVAL_SIZES[1]
    column = np.zeros((h, w), np.uint8)
    column[h // 4:h // 2, w // 2] = 1
    anns.append({"id": len(anns) + 1, "image_id": 101, "category_id": 1,
                 "bbox": [float(w // 2), float(h // 4), 0.6,
                          float(h // 2 - h // 4)],
                 "area": float(column.sum()), "iscrowd": 0,
                 "segmentation": rle_encode(column)})
    files = {"instances": os.path.join(root, "instances.json"),
             "refcoco": os.path.join(root, "refcoco.json"),
             "pope": os.path.join(root, "pope.jsonl"),
             "mmbench": os.path.join(root, "mmbench.tsv")}
    with open(files["instances"], "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": i, "name": n}
                                  for i, n in COCO_CATEGORIES]}, f)
    words = ["left", "right", "big", "small", "striped", "front", "the"]
    refs = [dict(a, expressions=[" ".join(rng.choice(words, 4).tolist())])
            for a in anns if not a["iscrowd"] and min(a["bbox"][2:]) > 1]
    with open(files["refcoco"], "w") as f:
        json.dump({"images": images, "annotations": refs[:EVAL_REFS]}, f)
    names = [n for _, n in COCO_CATEGORIES]
    with open(files["pope"], "w") as f:
        for k in range(EVAL_POPE):
            f.write(json.dumps({
                "image": images[k]["file_name"],
                "text": f"Is there a {names[7 * k % 80]} in the image?",
                "label": ("yes", "no")[k % 2]}) + "\n")
    lines = ["index\tquestion\thint\tA\tB\tC\tD\tanswer\timage"]
    for k in range(EVAL_MMBENCH):
        # past csv's default field limit of 131072 characters, which the
        # JAX loader keeps and the port's lifts
        b64 = base64.b64encode(png_bytes(eval_image(rng, 240, 320))).decode()
        lines.append(f"{k}\tWhat is in the picture?\t\t{names[k]}\t"
                     f"{names[k + 10]}\t{names[k + 20]}\t{names[k + 30]}\t"
                     f"{'ABCD'[k]}\t{b64}")
    with open(files["mmbench"], "w") as f:
        f.write("\n".join(lines) + "\n")
    return files, pictures


def eval_prompt_ids(tok, cfg):
    """The test-mode det prompt `CocoDetDataset` builds for the 80 COCO
    classes (question and answer templates at index 0, one
    "[DET][EMB]..[EMB4]" block a class, `cfg.image_token_len` <im_patch>
    ids), unpadded."""
    names = [n for _, n in COCO_CATEGORIES]
    blk = det_answer_tokens(cfg.num_embs)
    conv = [{"from": "human", "value": "<image>\n" + DET_QUESTIONS[0]
             .replace("<class>", ", ".join(names))},
            {"from": "gpt", "value": DET_YES[0].replace(
                "<class>", (blk + ", ").join(names) + blk)}]
    return preprocess(preprocess_multimodal([conv]), tok,
                      version="vicuna_v1", has_image=True,
                      image_token_len=cfg.image_token_len)["input_ids"][0]


def eval_prompt_length():
    return len(eval_prompt_ids(SimpleTokenizer(), vllm_7b_det_config()))


def eval_msda_inputs(g):
    """MSDA inputs of a B8 batch in the 800x1088 bucket (S = Q = 18071),
    locations spread uniformly over (and past) every map."""
    shapes = ((100, 136), (50, 68), (25, 34), (13, 17))
    S = sum(h * w for h, w in shapes)
    value = torch.randn(EVAL_BATCH, S, 8, 32, generator=g,
                        device="cuda").to(torch.bfloat16)
    loc = torch.rand(EVAL_BATCH, S, 8, 4, 4, 2, generator=g,
                     device="cuda") * 1.4 - 0.2
    attw = torch.softmax(torch.randn(EVAL_BATCH, S, 8, 16, generator=g,
                                     device="cuda"), -1).reshape(
        EVAL_BATCH, S, 8, 4, 4)
    return value, shapes, loc, attw


class TimedDataset:
    """A dataset whose items count as "data" and whose `coco.load_anns`
    as "gt" in an `EvalRecorder`'s split."""

    def __init__(self, ds, rec):
        self.ds, self.rec = ds, rec
        self.coco = copy.copy(ds.coco)
        self.coco.load_anns = rec.timed("gt", ds.coco.load_anns)

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.rec.timed("data", self.ds.__getitem__)(i)

    def __getattr__(self, name):
        return getattr(self.ds, name)


class EvalRecorder:
    """Patches the pieces `evaluate_det` calls (names in `eval_det`) to
    record what each device call returned and to split the wall: "data"
    (the dataset's items: PNG decode, transforms, prompt, CLIP image),
    "device" (each batch's forward, top-k and copy to the host, synced),
    "gt" (`load_anns`, the gt masks decoded), "masks" (mask finishing and
    RLE encoding), "evaluator" (`update`, `summarize`). Also the launches
    of each forward and each batch's arrays."""

    PATCHED = ("batched_samples", "make_det_infer_fn", "CocoMAPEvaluator",
               "post_process_masks_np", "rle_encode")

    def __init__(self, dataset):
        self.dataset = dataset
        self.seconds = dict.fromkeys(("data", "device", "gt", "masks",
                                      "evaluator"), 0.0)
        self.calls, self.batches, self.outputs, self.arrays = [], [], [], []
        self.real = {name: getattr(E, name) for name in self.PATCHED}

    def timed(self, stage, fn):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.seconds[stage] += time.perf_counter() - t
        return call

    def batched_samples(self, *a, **k):
        for idxs, samples, arrays, n_valid in self.real["batched_samples"](
                *a, **k):
            self.batches.append((idxs, n_valid))
            self.arrays.append(arrays)
            yield idxs, samples, arrays, n_valid

    def make_infer(self, *a, **k):
        fn = self.real["make_det_infer_fn"](*a, **k)

        def call(*inputs):
            f0, m0 = A.flash_attention.launches, M.ms_deform_attn.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*inputs)
            host = to_host(out)
            self.seconds["device"] += time.perf_counter() - t
            self.calls.append({
                "B": int(inputs[0].shape[0]), "L": int(inputs[0].shape[1]),
                "bucket": list(inputs[2].shape[1:3]),
                "flash_attn_fwd": A.flash_attention.launches - f0,
                "ms_deform_attn_fwd": M.ms_deform_attn.launches - m0})
            self.outputs.append({k: host[k] for k in
                                 ("scores", "labels", "boxes", "query_idx")})
            return out
        return call

    def evaluator(self, *a, **k):
        ev = self.real["CocoMAPEvaluator"](*a, **k)
        ev.update = self.timed("evaluator", ev.update)
        ev.summarize = self.timed("evaluator", ev.summarize)
        return ev

    def run(self, model, tid, **kw):
        """`evaluate_det(model, <timed dataset>, tid, **kw)` with the
        pieces patched; returns (metrics, wall s)."""
        ds = TimedDataset(self.dataset, self)
        with ExitStack() as stack:
            for name, new in zip(self.PATCHED, (
                    self.batched_samples, self.make_infer, self.evaluator,
                    self.timed("masks", self.real["post_process_masks_np"]),
                    self.timed("masks", self.real["rle_encode"]))):
                stack.enter_context(mock.patch.object(E, name, new))
            t = time.perf_counter()
            res = evaluate_det(model, ds, tid, progress=False, **kw)
            wall = time.perf_counter() - t
        return res, wall

    def per_image(self):
        """Each image's top-k (scores, labels, boxes, query_idx) by dataset
        index."""
        out = {}
        for (idxs, n_valid), rec in zip(self.batches, self.outputs):
            for bi in range(n_valid):
                out[idxs[bi]] = {key: v[bi] for key, v in rec.items()}
        return out


def compare_topk(a, b, tol=EVAL_REL_TOL):
    """One image's top-k of two runs (B8 against B1): entries matched by
    (query, label); each entry in both must agree in score and box within
    `tol`, and one in only one run must lie within `tol` of the other
    run's k-th score (the orders part at a tie at the cut)."""
    key_a = {(int(q), int(l)): i for i, (q, l) in
             enumerate(zip(a["query_idx"], a["labels"]))}
    key_b = {(int(q), int(l)): i for i, (q, l) in
             enumerate(zip(b["query_idx"], b["labels"]))}
    both = sorted(set(key_a) & set(key_b))
    score_err = max((abs(float(a["scores"][key_a[k]])
                         - float(b["scores"][key_b[k]])) for k in both),
                    default=0.0)
    box_err = max((float(np.abs(a["boxes"][key_a[k]]
                                - b["boxes"][key_b[k]]).max())
                   for k in both), default=0.0)
    only = [(k, a, b["scores"][-1]) for k in set(key_a) - set(key_b)] + \
        [(k, b, a["scores"][-1]) for k in set(key_b) - set(key_a)]
    tie_gap = max((float(run["scores"][(key_a if run is a else key_b)[k]])
                   - float(cut) for k, run, cut in only), default=0.0)
    same_order = bool((a["query_idx"] == b["query_idx"]).all()
                      and (a["labels"] == b["labels"]).all())
    res = {"same_order": same_order, "matched": len(both),
           "only_one_run": len(only), "score_err": score_err,
           "box_err": box_err, "tie_gap": tie_gap}
    if not (score_err <= tol and box_err <= tol and tie_gap <= tol):
        raise AssertionError(f"B8 and B1 top-k differ: {res}")
    return res


def same_proposals_b1(model, tid, rec8, device, num_classes):
    """Check 3's second half: each B8 batch of `rec8` again, and each of
    its images alone (B1) on the B8 forward's proposal choice; the two
    top-`EVAL_TOPK` compared by `compare_topk`."""
    out = {}
    with torch.no_grad():
        for (idxs, n_valid), arrays in zip(rec8.batches, rec8.arrays):
            ids, images, aug, pm = model_inputs(arrays, device)
            o8 = model.infer_det(ids, images, aug, tid, pixel_mask=pm)
            p8 = to_host(post_process_det(o8["logits"], o8["pred_boxes"],
                                          num_classes, EVAL_TOPK))
            for bi in range(n_valid):
                tq, mask = text_queries(model, ids[bi:bi + 1],
                                        images[bi:bi + 1], tid)
                o1 = model.gdino(aug[bi:bi + 1], tq, mask,
                                 pixel_mask=pm[bi:bi + 1],
                                 topk_idx=o8["topk_idx"][bi:bi + 1])
                p1 = to_host(post_process_det(o1["logits"], o1["pred_boxes"],
                                              num_classes, EVAL_TOPK))
                out[idxs[bi]] = compare_topk(
                    {k: v[bi] for k, v in p8.items()},
                    {k: v[0] for k, v in p1.items()})
    return out


def gt_as_detections(dataset):
    """Check 1: every image's gt (crowd objects marked, boxes under 1 px
    kept) fed back as detections of score 1; bbox and segm mAP."""
    coco = dataset.coco
    evs = {t: CocoMAPEvaluator(len(dataset.class_names), t)
           for t in ("bbox", "segm")}
    for idx in range(len(coco)):
        info = coco.image_info(idx)
        h, w = info["height"], info["width"]
        anns = coco.anns_by_image[coco.img_ids[idx]]
        gt = {"labels": np.asarray([coco.cat2label[a["category_id"]]
                                    for a in anns]),
              "boxes": np.asarray([[a["bbox"][0], a["bbox"][1],
                                    a["bbox"][0] + a["bbox"][2],
                                    a["bbox"][1] + a["bbox"][3]]
                                   for a in anns], np.float32),
              "iscrowd": np.asarray([a["iscrowd"] for a in anns]),
              "masks": [rle_encode(decode_segmentation(a["segmentation"],
                                                       h, w)) for a in anns]}
        keep = gt["iscrowd"] == 0
        det = {"scores": np.ones(int(keep.sum()), np.float32),
               "labels": gt["labels"][keep], "boxes": gt["boxes"][keep],
               "masks": [m for m, k in zip(gt["masks"], keep) if k]}
        for ev in evs.values():
            ev.update(det, gt)
    res = {t: ev.summarize() for t, ev in evs.items()}
    if not all(r["mAP"] == 1.0 for r in res.values()):
        raise AssertionError(f"gt as detections: mAP {res} != 1.0")
    return res


class VQARecorder:
    """Wraps a generate closure: each call's inputs and its tokens."""

    def __init__(self, gen):
        self.gen, self.calls = gen, []

    def __call__(self, ids, images, attn_mask=None, live=None):
        out = self.gen(ids, images, attn_mask=attn_mask, live=live)
        self.calls.append({"ids": ids, "images": images, "mask": attn_mask,
                           "live": live, "tokens": out["out_tokens"][
                               :, :out["num_generated"]].cpu()})
        return out


def vqa_rows(core, tid, calls):
    """Per question, in order: (its prompt ids, image, the first-step
    logits of a fresh prefill, the generated tokens up to the first eos)
    from the recorded calls (B1 calls, or batched calls' live rows, prompt
    pads stripped)."""
    rows = []
    with torch.no_grad():
        for c in calls:
            logits = core(c["ids"], c["images"], tid,
                          attn_mask=c["mask"])["logits"][:, -1].float()
            for j in range(c["ids"].shape[0]):
                if c["live"] is not None and not bool(c["live"][j]):
                    continue
                keep = c["mask"][j] if c["mask"] is not None else \
                    torch.ones_like(c["ids"][j], dtype=torch.bool)
                toks = c["tokens"][j].tolist()
                if 2 in toks:
                    toks = toks[:toks.index(2) + 1]
                img = c["images"][j] if c["images"].ndim == 5 else \
                    c["images"][j:j + 1]
                rows.append((c["ids"][j][keep], img.reshape(
                    1, *img.shape[-3:]), logits[j], toks))
    return rows


def vqa_token_rule(core, tid, b1, b4):
    """The B1 and B4 runs of one benchmark, question by question: the
    first-step logits within EVAL_REL_TOL (relative Frobenius), and the
    tokens equal up to the first step whose top-2 logit gap (B1's prompt
    and tokens, teacher-forced) is under EVAL_MARGIN."""
    out = []
    for (ids, img, lg1, t1), (ids4, _, lg4, t4) in zip(b1, b4):
        if not torch.equal(ids, ids4):
            raise AssertionError("B1 and B4 prompts differ")
        err = ((lg4 - lg1).norm() / lg1.norm()).item()
        with torch.no_grad():
            full = torch.cat([ids, torch.tensor(t1[:-1], dtype=ids.dtype,
                                                device=ids.device)])[None]
            lg = core(full, img, tid)["logits"][0, len(ids) - 1:].float()
        top2 = lg.topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        tie = next((s for s, gp in enumerate(gaps) if gp < EVAL_MARGIN),
                   len(gaps))
        diff = next((s for s, (x, y) in enumerate(zip(t1, t4)) if x != y),
                    None)
        res = {"first_step_rel_err": err, "tokens": len(t1),
               "first_difference": diff, "first_near_tie": tie,
               "min_gap": min(gaps)}
        if not err <= EVAL_REL_TOL or (diff is not None and diff < tie):
            raise AssertionError(f"B1 and B4 answers part: {res}")
        out.append(res)
    return out


def run_eval():
    """The eval phase: see the module docstring."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = vllm_7b_det_config()
    tok = SimpleTokenizer()
    tid = SpecialTokenIds.from_tokenizer(tok)
    t = time.perf_counter()
    model = build_model(cfg, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    device = next(model.parameters()).device
    per_fwd = {"flash_attn_fwd": cfg.vis_encoder.num_layers
               + cfg.llm.num_layers,
               "ms_deform_attn_fwd": cfg.gdino.encoder_layers
               + cfg.gdino.decoder_layers}
    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        files, pictures = write_eval_set(root)
        for i, img in enumerate(pictures):
            if not np.array_equal(load_image(os.path.join(
                    root, f"{i:012d}.png")), img):
                raise AssertionError(f"PNG {i} does not read back")
        write_s = time.perf_counter() - t
        ds = CocoDetDataset(files["instances"], root, tok, test_mode=True,
                            with_mask=True,
                            image_token_len=cfg.image_token_len,
                            image_size=cfg.vis_encoder.image_size)
        L = len(ds[0]["input_ids"])
        if L != len(eval_prompt_ids(SimpleTokenizer(), cfg)):
            raise AssertionError(f"prompt of {L} tokens, not the kernel "
                                 "phase's eval prefill")

        # 1. the gt as detections
        gt_map = gt_as_detections(ds)

        # 2, 5. the main path: B8 with masks, then B1, launches counted
        A.flash_attention.launches = 0
        M.ms_deform_attn.launches = 0
        rec8, rec1 = EvalRecorder(ds), EvalRecorder(ds)
        res8, wall8 = rec8.run(model, tid, with_mask=True, topk=EVAL_TOPK,
                               batch_size=EVAL_BATCH)
        res1, wall1 = rec1.run(model, tid, topk=EVAL_TOPK, batch_size=1)
        torch.cuda.synchronize()
        launches = {"flash_attn_fwd": A.flash_attention.launches,
                    "ms_deform_attn_fwd": M.ms_deform_attn.launches}
        for res in (res8, res1):
            if not all(np.isfinite(v) for k, v in res.items()
                       if k.endswith(("mAP", "mAP_50", "mAP_75"))):
                raise AssertionError(f"evaluate_det: {res}")
        for c in rec8.calls + rec1.calls:
            if any(c[k] != v for k, v in per_fwd.items()):
                raise AssertionError(f"launches of a forward {c} != "
                                     f"{per_fwd}")
        if [c["B"] for c in rec8.calls] != [EVAL_BATCH] * 3 or \
                len(rec1.calls) != len(EVAL_SIZES):
            raise AssertionError(f"batches {rec8.batches}, {rec1.batches}")

        # 3. per image, B8 against B1: the sorted top-k scores of the two
        # runs, then the top-k of each image alone on the B8 run's
        # proposals (random weights saturate the class logits: the
        # proposals and the top-k tie at 1.0, and each run breaks the
        # ties its own way)
        top8, top1 = rec8.per_image(), rec1.per_image()
        ranked = {i: float(np.abs(np.sort(top8[i]["scores"])
                                  - np.sort(top1[i]["scores"])).max())
                  for i in top1}
        if not max(ranked.values()) <= EVAL_REL_TOL:
            raise AssertionError(f"B8 and B1 ranked scores {ranked}")
        overlap = {i: len({(int(q), int(lb)) for q, lb in zip(
            top8[i]["query_idx"], top8[i]["labels"])} & {
            (int(q), int(lb)) for q, lb in zip(top1[i]["query_idx"],
                                               top1[i]["labels"])})
            for i in top1}
        topk_cmp = same_proposals_b1(model, tid, rec8, device,
                                     len(ds.class_names))

        # 4. the first B8 batch with the kernels against the plain versions
        with torch.no_grad():
            ids, images, aug, pm = model_inputs(rec8.arrays[0], device)
            tq_k, mask_k = text_queries(model, ids, images, tid)
            out_k = model.gdino(aug, tq_k, mask_k, pixel_mask=pm)
            with plain_versions():
                tq_p, mask_p = text_queries(model, ids, images, tid)
                out_p = model.gdino(aug, tq_p, mask_p, pixel_mask=pm,
                                    topk_idx=out_k["topk_idx"])
        if not torch.equal(mask_k, mask_p):
            raise AssertionError("text-query masks differ")
        n = mask_k.shape[1]
        plain_err = {
            "text_queries": rel_err(tq_k, tq_p),
            "logits": rel_err(out_k["logits"][..., :n][..., mask_k[0]],
                              out_p["logits"][..., :n][..., mask_k[0]]),
            "pred_boxes": rel_err(out_k["pred_boxes"], out_p["pred_boxes"])}
        if not max(plain_err.values()) <= EVAL_REL_TOL:
            raise AssertionError(f"B8 kernel vs plain {plain_err}")
        del out_p, tq_p

        # 6. grounding, with masks
        grd = RefCocoGrdDataset(files["refcoco"], root, tok, test_mode=True,
                                with_mask=True,
                                image_token_len=cfg.image_token_len,
                                image_size=cfg.vis_encoder.image_size)
        t = time.perf_counter()
        res_grd = evaluate_grd(model, grd, tid, with_mask=True)
        grd_s = time.perf_counter() - t
        if len(grd) != EVAL_REFS or not all(
                np.isfinite(v) for v in res_grd.values()):
            raise AssertionError(f"evaluate_grd: {len(grd)} {res_grd}")

        # 7. POPE and MMBench at B1 and B4 through build_generate_fn
        gen = build_generate_fn(model.core, tid, max_new_tokens=EVAL_VQA_NEW,
                                max_len=EVAL_VQA_MAX_LEN)
        bench, vqa_cmp = {}, {}
        for name, rows in (("pope", load_pope(files["pope"], root)),
                           ("mmbench", load_mmbench(files["mmbench"]))):
            recs = {}
            for bs in (1, EVAL_VQA_BATCH):
                recs[bs] = VQARecorder(gen)
                t = time.perf_counter()
                bench[f"{name}_b{bs}"] = run_benchmark(
                    name, recs[bs], tok, rows,
                    image_token_len=cfg.image_token_len,
                    image_size=cfg.vis_encoder.image_size, batch_size=bs,
                    device=device)
                bench[f"{name}_b{bs}_s"] = time.perf_counter() - t
            vqa_cmp[name] = vqa_token_rule(
                model.core, tid, vqa_rows(model.core, tid, recs[1].calls),
                vqa_rows(model.core, tid, recs[EVAL_VQA_BATCH].calls))

    # 8. latency
    latency = measure_latency(model.core, tid)
    if not all(np.isfinite(v) and v > 0 for v in latency.values()):
        raise AssertionError(f"measure_latency: {latency}")

    def split(rec, wall):
        s = dict(rec.seconds)
        s["other"] = wall - sum(s.values())
        return s

    emit({"phase": "eval", "config": "vllm_7b_det_config()",
          "images": [list(s) for s in EVAL_SIZES], "classes": 80,
          "prompt_tokens": L, "build_model_s": build_s,
          "write_set_s": write_s, "gt_as_detections": gt_map,
          "b8": {"metrics": res8, "wall_s": wall8,
                 "images_per_s": len(EVAL_SIZES) / wall8,
                 "split_s": split(rec8, wall8), "forwards": rec8.calls,
                 "with_mask": True},
          "b1": {"metrics": res1, "wall_s": wall1,
                 "images_per_s": len(EVAL_SIZES) / wall1,
                 "split_s": split(rec1, wall1), "forwards": len(rec1.calls),
                 "with_mask": False},
          "launches": launches, "launches_per_forward": per_fwd,
          "b8_vs_b1_ranked_score_err": ranked,
          "b8_vs_b1_evaluate_det_shared_entries": overlap,
          "b8_vs_b1_same_proposals": topk_cmp, "b8_plain_rel_err": plain_err,
          "rel_tol": EVAL_REL_TOL, "grd": res_grd, "grd_s": grd_s,
          "benchmarks": bench, "vqa_b1_vs_b4": vqa_cmp,
          "latency": latency,
          "phase_s": time.perf_counter() - t_phase,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    profile_eval_batch(model, tid, model_inputs(rec8.arrays[0], device))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def profile_eval_batch(model, tid, inputs):
    """The first B8 batch's forward and top-k under torch.profiler."""
    infer = E.make_det_infer_fn(model, tid, len(COCO_CATEGORIES),
                                EVAL_TOPK)
    infer(*inputs)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        to_host(infer(*inputs))
        wall_ms = (time.perf_counter() - t) * 1e3
    emit({"phase": "eval_profile", "batch": EVAL_BATCH,
          **device_summary(prof, wall_ms)})


def kernel_entry(name, source, replaces, launches, cases, main_case):
    main = next(c for c in cases if c["case"] == main_case)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "main_case": main_case,
            **{k: main[k] for k in ("device_ms", "kernels_per_call",
                                    "library_device_ms",
                                    "library_kernels_per_call",
                                    "composite_ms", "composite_device_ms")
               if k in main},
            "cases": cases}


# the kernel phase's checks by name, for `--kernels`
KERNEL_CHECKS = {"flash_fwd": check_attention,
                 "flash_bwd": check_attention_bwd,
                 "msda_fwd": check_msda, "msda_bwd": check_msda_bwd,
                 "int4": check_int4, "gathers": lambda g: check_gathers()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--kernels", help="comma-separated kernel checks to run alone, of "
        f"{', '.join(KERNEL_CHECKS)}: the device and build phases, those "
        "checks, the nvidia-smi line, and no model phase and no ok line")
    parser.add_argument(
        "--phase", choices=["train", "gen", "flagship", "det26b", "eval",
                            "trainer", "tooltrain", "loratrain"],
        help="run this model phase "
        "alone with its profile "
        "(with the device and build phases and the nvidia-smi line; no "
        "kernel phase and no ok line)")
    args = parser.parse_args(argv)
    only = args.kernels.split(",") if args.kernels else []
    unknown = set(only) - set(KERNEL_CHECKS)
    if unknown:
        parser.error(f"unknown kernel checks {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t = time.perf_counter()
    build.build_all()
    cuda_s = time.perf_counter() - t
    host_build.build_host_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "cuda_seconds": cuda_s, "kernels": list(build.KERNELS),
          "host_libraries": list(host_build.HOST_LIBS),
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Function properties" in ln]
                    for k, v in build.build_log.items()}})

    g = torch.Generator(device="cuda").manual_seed(0)
    if only or args.phase:
        for name in only:
            KERNEL_CHECKS[name](g)
        if args.phase == "train":
            run_train()
        if args.phase == "gen":
            run_gen()
        if args.phase == "flagship":
            run_flagship()
        if args.phase == "det26b":
            run_det26b()
        if args.phase == "eval":
            run_eval()
        if args.phase == "trainer":
            run_trainer()
        if args.phase == "tooltrain":
            run_tooltrain()
        if args.phase == "loratrain":
            run_loratrain()
        print(smi, flush=True)
        return 0
    attn_cases = check_attention(g)
    attn_bwd_cases = check_attention_bwd(g)
    msda_cases = check_msda(g)
    msda_bwd_cases = check_msda_bwd(g)
    int4_cases = check_int4(g)
    lane_cases, row_cases = check_gathers()
    det = run_slice()
    gc.collect()
    torch.cuda.empty_cache()
    perception = run_perception()
    gc.collect()
    torch.cuda.empty_cache()
    chat, core, chat_cfg = run_serve()
    slots = run_slots(core, chat_cfg)
    spec = run_spec(core, chat_cfg)
    del core
    gc.collect()
    torch.cuda.empty_cache()
    quant = run_quant()
    gc.collect()
    torch.cuda.empty_cache()
    train = run_train()
    gc.collect()
    torch.cuda.empty_cache()
    trainer = run_trainer()
    gc.collect()
    torch.cuda.empty_cache()
    tooltrain = run_tooltrain()
    gc.collect()
    torch.cuda.empty_cache()
    loratrain = run_loratrain()
    gc.collect()
    torch.cuda.empty_cache()
    probe = run_probes()
    gen = run_gen()
    flagship, evalx, convert, profiled = run_flagship(next(
        c["device_ms"] for c in attn_cases if c["case"] == "llama7b_prefill"))
    det26b = run_det26b()
    evaluation = run_eval()
    # each path's counts were read around that path's run alone
    by_path = {"det": det, "perception": perception, "train": train,
               "trainer": trainer, "tooltrain": tooltrain,
               "loratrain": loratrain,
               "probes": probe, "chat": chat, "slots": slots, "spec": spec,
               "quant": quant, "gen": gen, "flagship": flagship,
               "evalx": evalx, "convert": convert, "profiling": profiled,
               "det26b": det26b, "eval": evaluation}

    def launches(name):
        per = {p: c[name] for p, c in by_path.items() if name in c}
        if not all(per.values()):
            raise AssertionError(f"{name}: no launch on a path: {per}")
        return sum(per.values()), per

    entries = []
    for name, src, replaces, cases, main_case in (
            ("flash_attn_fwd", "visionllm_tpu_torch/csrc/flash_attn_fwd.cu",
             "visionllm_tpu/ops/attention.py:72", attn_cases,
             "llama7b_prefill"),
            ("ms_deform_attn_fwd",
             "visionllm_tpu_torch/csrc/ms_deform_attn_fwd.cu",
             "visionllm_tpu/ops/ms_deform_attn.py:212", msda_cases,
             "captured_det_encoder"),
            ("int4_matmul", "visionllm_tpu_torch/csrc/int4_matmul.cu",
             "visionllm_tpu/ops/quant4.py:112", int4_cases,
             "decode_m4_4096x11008"),
            ("flash_attn_bwd", "visionllm_tpu_torch/csrc/flash_attn_bwd.cu",
             "jax/experimental/pallas/ops/tpu/flash_attention.py:1121 "
             "(_flash_attention_bwd_dkv) and :1456 (_flash_attention_bwd_dq), "
             "reached from visionllm_tpu/ops/attention.py:125",
             attn_bwd_cases, "llama7b_prefill"),
            ("ms_deform_attn_bwd",
             "visionllm_tpu_torch/csrc/ms_deform_attn_bwd.cu",
             "visionllm_tpu/ops/ms_deform_attn.py:212 (the gradient of "
             "_msda_kernel's op, autodiff of :99 and :314)", msda_bwd_cases,
             "captured_train_encoder"),
            ("lane_gather", "visionllm_tpu_torch/csrc/gather_probes.cu",
             "tools/msda_kernel_attempts.py:34", lane_cases, "extent_256"),
            ("row_gather", "visionllm_tpu_torch/csrc/gather_probes.cu",
             "tools/msda_kernel_attempts.py:59", row_cases,
             "n131072_rpb64")):
        total, per = launches(name)
        entry = kernel_entry(name, src, replaces, total, cases, main_case)
        entry["launches_by_path"] = per
        entries.append(entry)
    emit({"kernels": entries})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
