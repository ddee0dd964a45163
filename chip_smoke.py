#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (dynamo_tpu_torch) on one GPU.

    python3 chip_smoke.py                    # every phase (what CI runs)
    python3 chip_smoke.py --phases kernels   # build + kernel checks only

Phases, in order; any failure raises and the exit code is not 0:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; builds every kernel of dynamo_tpu_torch/csrc from source.
2. kernels: each CUDA kernel against its plain PyTorch version at
   Llama-3-8B attention shapes (32 q heads, 8 kv heads, head_dim 128, block
   16) on ragged rows, the attention kernels on a bf16 and on an int8 cache,
   and the unified kernel at Gemma shapes (8 q heads, 4 kv heads, head_dim
   256) with per-row sliding windows, a softcap and sinks;
   times kernel, plain version, a PyTorch library call doing the same work
   (scaled_dot_product_attention over the gathered, dequantized KV; the
   port never calls it) and the card's bound; the unified kernel's
   split-K merge kernel against its plain version on partials shaped like
   a Gemma decode batch (and against a mutant that counts the sink once
   per split, which must fail), and one Gemma case whose short rows end in
   a split that some of their tokens never reach, with sinks on; each
   Gemma case reads the split counts the kernel wrote and holds them to
   the plain split plan. The build's SASS must hold
   tensor-core instructions (HGMMA or HMMA, cuobjdump) in the
   decode, flash-extend and unified kernels. The decode kernel runs the check
   batch, 8 rows at llama serving's 4096-key limit and one such row alone,
   each against its plain version (and the plain split form), with the
   split counts the kernel wrote held to the plain split plan, at least
   one working block per SM on the first two, a plain merge that drops
   each row's last split failing the compare, and SDPA and the unified
   kernel (as q_len = 1 rows) timed on the same rows. The page-copy
   kernel (gather, scatter, copy, the int8 pair in one launch, and the
   layer-batched gather_layers / scatter_layers over 32 Llama-3-8B layer
   caches in one launch) must be bit-exact on bf16 pages and on the int8
   pair, against index_select / index_copy_ as the library yardstick.
3. model: a 2-layer model at full Llama-3-8B width runs a prefill, decode
   steps and a ragged 2-token step through the model's attend hook, once
   with the kernels and once with the plain ops, on bf16 and on int8
   caches; the logits must agree, and three deliberately wrong attentions
   must not, on each of 3 seeds. The same for gemma2-2b (2 layers) and
   gemma3-4b (6 layers) at full width through the unified kernel, with
   the window dropped, one page too wide, or the softcap dropped as the
   wrong attentions.
4. serving (each engine with its defaults: the auto-tuned decode horizon,
   each horizon one CUDA-graph replay, and launches counted through the
   replays): TorchEngine on the llama3-8b preset at full depth (32 layers,
   random bf16 weights from a seed) serves staggered concurrent requests;
   every request must finish with its token count, and the decode,
   flash-extend and unified kernels and the fused mixed step must all have
   run during it. Two greedy prompts of 4600 and 6100 tokens (three
   prefill chunks each) at once, on a fresh engine with DTPU_ASYNC_PREP=1
   and on one with 0, must stream the same tokens, the first taking
   prebuilt chunks (engine/prep.py; prints prep_build_s and prep_wait_s).
   Then the same engine with the int8 KV cache and a KVBM
   host tier serves three waves (first, churn, repeat): the repeats
   onboard their evicted prefixes from the host tier; the int8 attention
   kernels and the layer-batched gather and scatter must all have run,
   one gather launch per offload batch and one scatter launch per
   onboard, and an onboarded block must re-encode bit-exactly to its
   stored bytes. Then
   gemma2-2b at full depth (26 layers, max_context 8192) serves 8
   staggered prompts of up to 8000 tokens on a bf16 cache and 3 (64
   tokens each) on an int8 cache: every request finishes, the unified kernel served windowed
   launches, split rows (by the kernel's own count, logged in these
   runs) and neither the decode nor the flash-extend kernel ran.
5. horizon: the decode horizon. For llama3-8b on a bf16 and an int8 cache
   and gemma2-2b on bf16, one horizon of 8 steps from a random state run
   eagerly on cloned caches and its captured graph replayed on the
   originals must agree bit for bit (packed tokens and logprobs, carry,
   output counts, every K/V page but scratch block 0). Then llama3-8b on its
   first 8 of 32 layers (HZ_TRAFFIC_LAYERS: phase 9's plain run serves the
   same prompts on (d)'s schedule at all 32) serves 8 prompts of 128
   tokens queued at once, 256 output tokens
   each (one seeded sampled request), four times on one set of weights:
   (a) one eager decode step per tick, (b) eager horizons of 8, (c)
   graphed horizons of 8 with two in flight, (d) the auto-tuned schedule
   with graphs; (b)-(d) carry a stop token that one greedy request's (a)
   stream samples mid-horizon, and must stream exactly (a)'s tokens, cut at
   the stop. Prints each run's ITL, TTFT, tok/s and wall, captures,
   capture seconds, pool bytes, replays and launches through replays; and
   the device time per step, inside a graph, of the Gumbel draw and the KV
   writes.
6. gptoss: gpt-oss-20b (64 q heads over 8 kv heads, head_dim 64, window
   128 on even layers, per-head sinks, 32 experts, top 4). (a) the unified
   kernel at d = 64, bf16 and int8, against its plain version: a decode
   batch of 8 rows of 1-8000 keys through a sliding layer (window 128) and
   through a full one, sinks on in both, the last 2048-token chunk of a
   6000-token prompt through a sliding layer, and a mixed step, keys
   planted at each windowed decode row's window edge, each case timed
   with its bound and compiled flex_attention with the sink and window as
   its library yardstick; the merge kernel at d = 64 against its plain
   version and its sink-per-split mutant. (b) the grouped expert FFN
   (``models/gptoss.experts_grouped``, torch._grouped_mm over the pairs
   sorted by expert) against the plain expert loop at full width, 8 and
   2048 tokens, timed against its byte and FLOP bounds, and captured into
   a CUDA graph whose replay equals its eager run bit for bit (the form
   the decode horizon captures). (c) the model check at full width and 2
   layers (sliding, full) with the grouped experts on the kernel path and
   the plain loop on the plain path: a sink-dropped mutant and a window
   one key too wide must fail it. (d) gpt-oss-20b at all 24 layers (random
   bf16 weights from seed 0, 41.8 GB) on its defaults: graph replay =
   eager horizon bit for bit on a bf16 and an int8 cache; on its first
   12 layers (HZ_TRAFFIC_LAYERS) decode-heavy traffic (8 x 128-token
   prompts, 64 tokens each) streaming the same tokens one step per tick
   and on the auto-tuned graphed schedule; a
   serving run of 8 prompts of 100-6000 tokens, 32 tokens each (one seeded
   sampled; the kernel's split rows logged), and a short int8 run: TTFT,
   ITL, tok/s, graphs, capture seconds, pool bytes, launches through
   replays and peak device memory; the graphed decode-heavy run's
   horizon graphs must have captured its grouped expert GEMMs
   (``torch._grouped_mm`` calls during the captures) and replayed them.
7. moe_mla: the MoE and MLA families. (a) the latent kernel
   (csrc/mla_attention.cu: one kv head of 576 lanes, the values its first
   512) against its plain version (the op over the cache as keys and
   values, cut to 512 lanes) and its plain split form, in both forms:
   per form its ptxas registers (no spill), blocks per SM (the narrow
   form >= 2) and HGMMA / HMMA count (HGMMA in the wide form); a decode
   batch of 8 rows of 1-8000 keys at 16 query heads (DeepSeek-V2-Lite,
   narrow form) and at 128 (V2 / V3), each with
   >= 132 working blocks, the last 2048-token chunk of a 6000-token
   prompt, a 512-token chunk of 4096 at 128 heads, a mixed step (a chunk
   row and 8 decode rows), short rows of 1-4 tokens whose last split some
   tokens never reach, short rows of 1-3 tokens in the narrow form, the
   split counts the kernel wrote held to the plain split plan, and a
   plain merge that drops each row's last split failing the compare;
   each case timed with its bound (each live key read once at 576 lanes;
   also the bound with a 512-lane V read) and SDPA over the gathered
   latent (heads folded into the query axis, values the keys' first 512
   lanes) as its library yardstick. (b) the routed experts of
   Qwen3-30B-A3B (128, top 8) and of DeepSeek-V2-Lite (64, top 6, 2 shared)
   at full width, 8 and 2048 tokens, against the float32 expert loop per
   token row, timed against byte and FLOP bounds, and captured into a
   CUDA graph whose replay equals its eager run. (c) model checks at full
   width, 2 layers, routing pinned: DeepSeek-V2-Lite (one dense, one MoE
   layer) through the latent kernel, with the query pre-scale dropped and
   k_pe zeroed in the cache as the mutants; Qwen3-30B-A3B through kernels
   1-3 with the llama mutants. (d) DeepSeek-V2-Lite at all 27 layers
   (random bf16 weights, 31.4 GB, max_context 8192): graph replay = eager
   horizon bit for bit; 8 prompts of 100-6000 tokens 0.25 s apart, 32
   tokens each (one seeded sampled; the kernel's split rows logged); on its
   first 8 layers (HZ_TRAFFIC_LAYERS) decode-heavy
   traffic (8 x 128-token prompts, 64 tokens each) one step per tick and
   on the auto-tuned graphed schedule (streaming the same tokens): the
   latent kernel launched through graph replays,
   both its forms in the serving run, and no other attention kernel ran. (e) Qwen3-30B-A3B at 12 of its 48 layers
   (full width; 61 GB at full depth leaves too little of the card) serves
   the same 8 prompts, 64 tokens each, through kernels 1-3 and the grouped
   experts. No ERROR log record in (d) or (e).
8. vision: (a) the vision tower (default VisionConfig: 224 px, 256
   patches, 6 layers of width 256, projecting to 4096) in bf16 on the card
   against the same weights in float32 on the CPU (relative L2 <= 3e-2),
   and its ms per image; (b) llama3-8b at 32 layers (random bf16 weights)
   with the tower serves 8 staggered requests of 300-2000 text tokens with
   1-2 images each (256 placeholders an image), 32 greedy tokens each: the
   flash-extend and decode kernels ran, the decode kernel through horizon
   replays, no fused mixed step; request 0 again hits the encoder cache
   and reports 0 cached tokens; a black and a white image give different
   streams; a text-only prompt streams the same tokens, bit for bit, as a
   text engine on the same weights and schedule. TTFT, ITL, tok/s. (c)
   image input through the frontend, on the same engine in the same
   event loop: the committed PNG and JPEG (tests/data/) decoded by the
   port's own decoders (llm/image_codecs.py) to the arrays the
   reference's PIL path made of them at 224 px, exactly (JPEG tolerance
   VIS_JPEG_TOL = 0 levels), the host's decode time per image printed;
   the host's decode + resize time at users' sizes (VIS_SYNTH_SIZES: 1024
   x 768 and 4032 x 3024, seeded images encoded here as a PNG with every
   filter type and a 4:2:0 JPEG: the PNG decodes to its source exactly,
   the JPEG within VIS_SYNTH_JPEG_MAE levels on average); then a chat
   request with each fixture as a data: URL, first in-process (the
   frontend's preprocessor and the Backend on the engine), then through
   ``register_llm`` and the port's frontend, one at a time, streamed and
   whole: the greedy text (streamed and whole) and token count must equal
   the in-process run's, and the decode and flash-extend kernels must
   launch there.
9. spec: speculative decoding on llama3-8b at 32 layers (spec_k 4). (a)
   kernel 3 on verify rows (``cuda_unified.verify_attention``: 8 rows of
   q_len 5 over 128-4096 keys, bf16 and int8) against its plain versions,
   the kernel's split counts against the plain split plan, a plain merge
   without each row's last split failing the compare, timed against its
   bound and SDPA over the gathered context with each row's causal-tail
   mask. (b) one spec horizon from a random state, eager on cloned caches
   against its graph replay: packed results, carry, main and draft pages
   bit-identical, on a bf16 and an int8 main cache (a 1-layer draft). (c)
   the decode-heavy traffic (8 x 128-token prompts at once, 128 greedy
   tokens each): plain on the auto-tuned graphed schedule with top-2
   logprobs; the perfect draft (the main weights, its own shadow cache:
   acceptance >= 0.9); a 1-layer llama3-8b-width draft from seed 2; the
   perfect draft on an int8 main cache (64 tokens); one round of the
   perfect draft's engine, its draft steps and verify timed inside graphs.
   Each spec run: every spec horizon one graph replay, the decode and
   unified kernels launched through replays, and (bf16) its streams held
   to the plain run's by the tie rule: equal up to a first difference,
   where the spec token is among the plain top logprobs within 4 bf16
   spacings of the plain token's. (d) a 1500-token prompt arriving during
   a perfect-draft run rides a mixed step, the draft prefills it, it
   finishes. Also the verify's KV writes of a round inside a graph, bf16
   and int8.
10. checkpoint: HF checkpoints through the port's own loader. (a)
   Qwen3-0.6B as published (its config.json: 28 layers, 16 heads over 8,
   head_dim 128, tied embeddings; random bf16 weights from a seed), written
   here as a 2-shard HF checkpoint under a temporary directory, loaded by
   ``load_params`` onto the card bit-equal to the source in dtype, shape
   and contiguity (seconds, GB/s, peak device bytes), and again through the
   warm cache (a miss, then a warm load); 8 prompts of 100-3000 tokens,
   each submitted once the one before has streamed its first token, 32
   greedy tokens each on the default graphed schedule: the streams equal
   those of an engine on the source parameters, and the decode,
   flash-extend and unified kernels launched; embeddings of 100 and 3000
   tokens (the second chunked over temporary pages) against the plain ops
   on the same engine (relative L2 within MODEL_REL_TOL), the pages given
   back; ``python -m dynamo_tpu_torch.run out=<dir>`` exits 0 (run beside
   (b)); the tiny-moe
   preset (head_dim 16, which no kernel form takes) is refused at
   construction. A weight owner (``python -m
   dynamo_tpu_torch.engine.weight_service --preload``, started once the
   checkpoint is written, parsing it beside the rest) publishes its
   tensors in shared files; an import in this process onto the card is
   bit-equal to the source and timed against the cold parse and the warm
   load, a client process that imported (started with the owner) and is
   SIGKILLed gives its
   reference back (the owner's ``stat``), and the owner shuts down over
   its socket with code 0. (b) gpt-oss-20b at
   full width, 2 of 24 layers, its experts in the released MXFP4 layout
   (random codes, scale bytes 118-130, one expert a layer sweeping 0-255
   and never routed; routing pinned to 4 others by GPTOSS_ROUTER_MARGIN):
   the experts dequantized on the card bit-equal to a
   numpy dequant on the host (the sweep expert and two others a layer),
   and one greedy stream and a 500-token embedding equal to an engine's
   on the host-dequantized parameters; each unified launch of that
   embedding held to the plain op on its inputs (the saturating expert
   FFN of random MXFP4 weights turns bf16 rounding into a ~10% change of
   the whole vector, so the vector is not held to the plain path).
11. features: per-request features on llama3-8b at 32 layers (random bf16
   weights from seed 0), one engine with lora_max_adapters 2 at rank 16 on
   the reference's four default targets (wq, wk, wv, wo), guided caps 1024
   states / 320 classes over a synthetic byte vocabulary from a seed (ids
   0-255 single bytes, the rest 2-8-byte printable-ASCII pieces, EOS
   128001; not a trained BPE's classes) and two processors, ban_tokens
   (every even id) and repetition_window (3.0); and a plain engine on the
   same parameters and schedule. Two adapters (seeds 5 and 9) load after
   the graphs are captured: no table moves, the graph count stays. (a) 8
   prompts of 100-2000 tokens queued at once, 64 tokens each: two JSON
   schemas, a regex and a choice (finite languages), four plain rows (two
   sampled): each guided output matches its grammar's DFA and ends at EOS,
   the plain rows bit-equal to the plain engine's on the same traffic with
   the grammars taken out; the compile seconds per grammar at the full
   vocabulary, cold and cached. (b) a ban_tokens row emits no even id; the
   repetition_window row follows the penalty over the plain run's top-20
   logprobs; the rows without opt-in bit-equal. (c) base, adapter-a and
   adapter-b rows queued at once: the base row bit-equal; each adapter
   row's first-token logits within MODEL_REL_TOL (relative L2) of a plain
   forward on merged weights W + s A B; an adapter request after a base
   request on the same 40-token prompt caches nothing and streams what it
   streams after a base request on another prompt. The decode-heavy ITL
   without and with adapter rows, the grammar mask's and the LoRA deltas'
   device ms inside a graph against their byte bounds, graphs and capture
   seconds with and without features, and the kernel launches.
12. shapes: the Qwen2.5 and Llama-3.2 attention shapes and spec decoding
   and vision beyond the llama family. (a) decode, flash-extend and
   unified against their plain versions at G 3, 5, 6 and 7 (d 128) and at
   d 64 with G 4 and 7, bf16 and int8 (a decode row split and merged in
   the launch, a 77-token flash-extend chunk whose last tile is ragged at
   G 7, a unified row split over its keys and merged per query head);
   the three kernels timed at Qwen2.5-7B's (28 query heads over 4, d 128)
   and Llama-3.2-1B's (32 over 8, d 64) shapes on the check batch, a
   2048-token first chunk and a mixed step, each with its bound and SDPA.
   (b) Qwen2.5-7B (28 layers) and Llama-3.2-1B (16 layers) from their
   published config.json through config_from_hf, random bf16 weights
   from seed 0, serve the 8-prompt traffic (100-6000 tokens 0.25 s apart,
   one seeded sampled; Qwen2.5-7B 32 tokens each, Llama-3.2-1B 128) on
   their defaults, and again on an int8 cache (16 and 128 tokens): every
   request finishes, the decode,
   flash-extend and unified kernels of the cache's dtype and the mixed
   step ran, decode launches came from graph replays. (c) spec decoding
   at full width and reduced depth, 4 decode-heavy prompts, 64 greedy
   tokens: llama3-8b (4 layers) with a Llama-3.2-1B-shaped draft (d 64,
   2 layers), gemma2-2b (4 layers) with its own weights as a perfect draft
   (acceptance >= 0.85; each spec graph's windowed unified launches are
   the k draft steps' and the verify's), gpt-oss-20b and deepseek-v2-lite
   (2 layers, routing pinned) with a Llama-3.2-1B-shaped draft of their
   vocabulary (the latent kernel serves DeepSeek's verify rows), and
   qwen3-30b-a3b (4 layers) with a 2-layer qwen3-0.6b draft: each spec
   stream equals the plain greedy one under the tie rule; one spec
   horizon of gemma2-2b and of deepseek-v2-lite, graph replay = eager bit
   for bit. (d) vision on gemma2-2b (4 layers), gpt-oss-20b and
   deepseek-v2-lite (2 layers), the default tower at out_hidden_size =
   hidden: the first-token logits of a 512-token prompt ending in its
   image, kernels vs plain ops, within MODEL_REL_TOL (Gemma's image embeddings left
   unscaled must fail it), then 4 image prompts served to the end through
   the family's prefill kernel, no mixed step.
13. frontend: the serving plane as a user starts it, three processes
   through ``python -m``: the netstore, a worker (``dynamo_tpu_torch.engine
   --preset llama3-8b``, 32 layers, random bf16 weights from seed 0,
   max_context 8192, every other flag at its default: the auto-tuned
   horizon, each horizon a CUDA-graph replay, guided decoding on) and the
   OpenAI frontend; ready once each printed its readiness line and
   /v1/models lists the model. Through the frontend, on the standard
   library's asyncio streams: the 8-prompt traffic (100-6000 tokens 0.25 s
   apart, 32 tokens each, one seeded sampled), FE_RUNS times, as streamed
   chat and completions in turn, every stream ending in [DONE] with a
   finish_reason and usage counting its 32 tokens; a decode probe (8
   prompts of 64 tokens at once, 256 greedy tokens each); three greedy prompts
   one at a time with top-2 logprobs; an n = 2 request with a seed; a
   guided answer through response_format (it must parse and obey its
   schema); an embedding; a client that disconnects mid-stream (the
   in-flight gauge back to 0, a 499 counted, the next request served);
   just before that client, as the worker's card names the hermes tool
   parser and the qwen3 reasoning parser: a chat request with ``tools`` and a named ``tool_choice`` (the
   soft grammar on the card holds the reply to the tool's schema) must
   come back with finish_reason tool_calls and one call whose arguments
   obey the schema, and the same request streamed must give the same call
   from its joined deltas (both after a warm-up of the prompt, so that
   both find the same blocks cached); a hermes call and a <think> answer
   forced with guided_regex must come back as tool_calls and as
   reasoning_content plus content; one aggregated and one streamed
   /v1/responses request (after a one-token warm-up of their message) must
   give the text of the greedy chat request with the same message, the
   stream its Responses events in order (response.created, the deltas,
   response.completed) with the deltas joining to that text.
   The worker stopped by SIGTERM must exit 0 with no busy slot or pinned
   block, its decode, flash-extend and unified kernels launched (decode
   through graph replays); no process may log an ERROR record. Then the
   control, a process of its own as the worker is (``--fe-control``): an
   in-process engine on the same flags and the worker's decode schedule
   (one 16 GB model on the card at a time) serves the same traffic,
   probe, greedy prompts and embedding: the greedy streams must equal the
   worker's under the tie rule (token ids read from the logprobs), the
   embedding bit for bit. Prints TTFT, ITL and tok/s on the client clock
   for both, each run and the probe, and the frontend's TTFT and ITL
   histograms scraped after the traffic.
   Health and observability on the same run: the worker runs with
   ``--system-port 0`` (its status server), both processes with
   ``DTPU_TRACE_JSONL`` (one file each) and a ``DTPU_SLA_CLASSES`` class
   that the probe's requests name. The worker's /live answers 200 and
   /health 200 with the canary's endpoint healthy and its RTT;
   /debug/requests?id= one served request gives its timeline in order
   (queued, admitted, first_token, finish) and an unknown id 404; its
   /debug/slo and the frontend's count the class's requests, as many as
   were sent; /debug/worker holds its telemetry, SLO, attribution and
   health sections; the frontend's /debug/fleet merges the one worker
   with no error; the step counts by phase in the worker's /metrics equal
   its exit line's (decode: eager steps and consumed horizons); and that
   request's spans in the two files (http.generate, router.schedule,
   worker.generate and engine.queue / prefill / decode) share one trace,
   each parented as the reference parents them. Prints the drift
   detector's measured / predicted step ratio (median by phase) and any
   health event. The frontend also serves KServe gRPC (``--grpc-port 0``,
   the port's own HTTP/2 and protobuf): before the observability checks,
   each greedy prompt, warmed with one token, goes through a streamed HTTP
   completion, ModelStreamInfer and ModelInfer (the port's gRPC client),
   whose texts must be equal, with TTFT printed for both streams; the four
   introspection RPCs answer and an unknown model is NOT_FOUND. A second
   frontend on the same store serves HTTPS with the committed localhost
   pair: one greedy completion through it, streamed and whole, must equal
   its plain twin's. An earlier line prints whether grpcio and protobuf
   import on this machine.
14. kv_router: KV-aware routing across processes. The netstore, two
   llama3-8b workers (32 layers, random bf16 weights from seed 0, 512 KV
   blocks each, ``--event-plane zmq``: the port's own broker), a
   ``--router-mode kv --event-plane zmq`` frontend (it founds the broker)
   the standalone router service (``python -m dynamo_tpu_torch.router
   --record-events``, started before the workers) and a round-robin
   frontend on the same workers. Through the kv
   frontend, streamed greedy chat of 32 tokens: 8 documents of 1000-3000
   tokens 0.25 s apart, then each document plus 64 new tokens in a seeded
   shuffled order, one at a time, 0.25 s after the one before ended
   (each must report at least (document blocks - 1) x 16 cached tokens:
   it reached its document's worker; each is first put to the service's
   route op, whose worker and cached tokens must equal the kv frontend's
   decision, read from the recording, and its cached-token counter step);
   new documents and their follow-ups
   0.25 s apart without waiting for each other (observed, not gated: a
   follow-up arriving while its document's worker is busy may rightly go
   to the idle one; the router's predicted cached tokens are printed
   beside the workers' reported ones), KV_CHURN distinct
   3000-token prompts (both pools evict) and the decode probe; then new
   documents and follow-ups through the round-robin frontend (the
   control: its hit share and follow-up TTFT median beside the kv
   mode's, observations, not gates). Then the fault drill
   (runtime/faults.py, runtime/resilience.py) on the same two workers,
   which run with ``--migration-limit 2``: (a) a round-robin frontend
   armed with DRILL_SPEC (seeded drops of the request plane's sends) and
   a ``--request-template`` naming the model serves 16 greedy chat
   requests that omit the model, 4 at a time, 32-62 new tokens each: each
   must come back 200 (a dropped send migrates to the other worker) with
   the tokens of the same request through the clean round-robin frontend
   (equal, or within the tie rule: a divergence is checked after the
   workers stop, in a process of its own, ``--tie-control``), its
   /debug/fleet must list both workers' breakers, and the fired-fault log
   its exit line prints must equal ``FaultRegistry.plan`` of DRILL_SPEC
   for the sends it counted; (b) a second round-robin frontend armed to
   drop exactly the first DRILL_TRIP_SENDS sends (two a request: the
   third attempt finds both workers excluded and fails without a send),
   with ``DTPU_CB_FRONTEND=reset=1``: the first 5 requests get 503, the
   sixth 503 with Retry-After and no send, and after the reset a probe is
   served and closes the circuit: /metrics counts one transition each to
   open, half_open and closed under ``policy="frontend.<model>"`` and the
   state gauge is back at 0. Once idle, the service stops first
   and prints its view, which must equal each worker's prefix cache, as
   must the view of its recording replayed into a fresh KvRouter here;
   then the kv frontend prints its router's view of each worker; each worker's exit
   line must show the same blocks and digest for its prefix cache, stored
   and removed events, the router must have applied every event the
   workers published, and the decode, flash-extend and unified kernels
   launched in each worker with no busy slot or pinned block; no process
   may log an ERROR record. The second worker serves on the HTTP request
   plane (``DTPU_REQUEST_PLANE=http``; no gate of the phase compares the
   workers' latencies); after the drill the same 1-token request goes
   straight to each idle worker KV_PLANE_ROUNDS times in turns, and a
   ping through each worker's request server (the plane alone), the
   seconds by plane printed (observed, not gated). Then ``POST /clear_kv_blocks
   {"levels": ["g1"]}`` through the kv frontend must empty both prefix
   caches and, through their CLEARED events, the router service's view,
   and a follow-up of a served document must then report 0 cached tokens,
   0 predicted by the kv frontend's router.
15. disagg: disaggregated prefill/decode on one card (engine/transfer.py,
   llm/prefill_router.py). First in process, at llama3-8b's width and 4
   layers, bf16 and int8: a 3000-token prompt prefilled on one engine, its
   blocks gathered in the transfer wire's layer-major order by
   ``gather_layers_wire`` (one page-copy launch) equal
   ``gather_layers_wire_ref`` bit for bit, scattered into permuted pages of
   a second engine by ``scatter_layers_wire``, whose whole pool equals
   ``scatter_layers_wire_ref``'s on clones taken before the kernel, and
   the in-process mover leaves a third
   engine's pages equal to the source's; the native arena's packed gather
   (``gather_layers_packed``) equals its plain version, and a
   ``native_ok: false`` fetch (the inline wire) and a native one through
   the source's transfer server each import bit-exactly; both wire copies
   and the packed gather timed at 32 layers on 188 pages against their
   byte bound and their plain versions, and the native agent over loopback
   (64 2 MiB blocks, whole and in 8-block windows) against the crc32s of
   the same bytes. Then the netstore, a ``--disagg
   prefill`` and a ``--disagg decode`` llama3-8b worker (32 layers, random
   bf16 weights from seed 0, the prefill worker advertising
   ``DTPU_KV_WIRE=device``), a ``--router-mode kv`` frontend (streamed
   disaggregation) and a round-robin one with ``DTPU_STREAM_KV=0``
   (sequential), both with ``DTPU_DEFLECT_MAX_TOKENS=64`` and no load-skew
   deflection. The 8-prompt lengths as greedy streamed chat of 32 tokens
   with top-5 logprobs, one request at a time (each decodes alone, so runs
   that import the same bytes compute the same logits): (a) streamed
   through the device path (CUDA IPC between the two processes), (b)
   sequential through it, (c) streamed with the decode worker restarted
   under ``DTPU_DEVICE_TRANSFER=0`` (the native wire: the C++ agent), (d)
   the prefill worker stopped, the decode worker alone (the aggregated
   control); both workers' prefix caches emptied before each run. The
   device decode worker runs with ``DTPU_CKPT_DIR``: after (b) it serves
   one more 2000-token prompt and is drained (``POST /drain``): it must
   quiesce, say ``draining`` in discovery, checkpoint exactly the sealed
   blocks its ``/debug/worker`` reported (the evacuated-blocks counter
   too) and exit 0; (c)'s worker restores that checkpoint at its start
   (``mode=warm``, the same blocks, one scatter launch a 64-block window)
   and after (c) serves the checkpointed prompt with its full blocks
   cached, streaming the first run's tokens or within the tie rule. Gates:
   every request of
   (a)-(c) pulls all its prompt's full blocks (one pull each, over the
   run's wire), no device-to-wire fallback and no recompute (the decode
   workers' transfer counters), no pull in (d); (a), (b) and (c) stream
   the same tokens, (a) and (c) with the same logprobs; (d) equals (a) or is within the
   tie rule (phase 14's tie control); in (a) the prefill worker sent the
   first window of a 4000+-token prompt after waiting for a chunk's commit
   and while blocks of the prompt were still uncommitted (before its
   prefill ended); a 50-token prompt sent while a 3000-token one decodes
   deflects (the frontend's ``dtpu_prefill_deflected_total``, one pull:
   the other's), and prefills beside its decode rows (a fused mixed step);
   the 8-prompt traffic with new prompts 0.25 s apart (several pulls in
   flight) imports every prompt whole over the device path;
   the KV frontend's view of the last decode worker equals its prefix
   cache; the decode workers' exit lines as phase 13's, the prefill
   worker's chunks through flash-extend and its pages through the page
   copy's gather, the decode workers' imports through its scatter; no
   ERROR record. Prints TTFT and ITL medians of (a)-(d), bytes and GB/s of
   each pull, the decode workers' bandwidth EWMA per wire, and each side's
   page-copy launches, which the report adds to the gather_layers /
   scatter_layers rows.
16. global_kv: fleet-wide KV reuse on one card (kvbm/remote.py,
   kvbm/distributed.py, kvbm/directory.py, the tier stream of
   engine/transfer.py, llm/prefill_router.GlobalKvFetchPlanner). The
   netstore, two G4 block stores (``python -m dynamo_tpu_torch.kvbm
   --store``, members of the sharded fleet), llama3-8b worker A (32
   layers, random bf16 weights from seed 0, an 8 GiB G2 and
   ``--kvbm-remote`` on the first store) and worker B (the same weights as
   model ``llama3-8b-b``, an 8 GiB G2, no G4), two frontends; every process
   with ``DTPU_GLOBAL_KV=1``, one frontend at the port's default priors
   and one with ``DTPU_GLOBAL_KV_FETCH_MARGIN`` raised so that every plan
   fetches. The 8-prompt lengths as greedy streamed chat of 32 tokens, one
   request at a time (prompts of one byte a letter, ``gk_prompt``). A
   serves them first: each written through to G2 and the first store
   (which then holds every block A offloaded) and advertised. (b) peer
   tier: the same prompts sent to B through the default-prior frontend
   (the plans, each naming A: their verdicts and priced seconds; a
   recompute run doubles as the cold measurement, else one more run
   through a frontend whose plans all recompute), B's caches cleared, and
   sent again through the fetching frontend: each request one whole tier
   pull from A's transfer address (``_pull_tier``), ``cached_tokens`` the
   fetched prefix, no fetch lease open, no transfer fallback; per prompt
   fetch and recompute seconds, GB/s and windows. (a) G4: A's G1 and G2
   cleared (``POST /clear_kv_blocks``), the prompts again: every full-block
   prefix comes back from G4 (``cached_tokens``); TTFT first and repeat.
   (c) dead holder: A stopped, its advertisements put back at its gone
   address, two of the prompts sent to B (cleared again) through the
   fetching frontend: each plan ends in a recompute (a zero-token tier
   pull at A's address, the recompute counter), the lease aborted. Every
   stream of (a)-(c) equals A's first run's or, where one side restored
   its prefix from a tier and computed only the suffix, is within the tie
   rule (phase 14's tie control, run once the workers stopped, while (d)
   runs). (e) evacuation, after (a): a 1500-token chat of 128 greedy
   tokens served by A cleanly, then again through the port's Migration over both workers'
   endpoints; once A's first tokens stream, A's ``engine.step`` is armed
   (``POST /debug/faults``, ``DTPU_FAULTS_ADMIN=1``), its loop dies
   mid-decode, the error frame's evacuation plan becomes the retry's
   ``kv_transfer`` on B, which pulls A's host tier from A's address (one
   tier pull, ``evacuated=True`` in the migration's flight event) and
   finishes the request: A's clean stream, or within the tie rule; A
   exits 0 once its transfer endpoint is idle, and its crash's own ERROR
   records are the only ones allowed. (d) the sharded fleet: from this process a
   ``DistributedBlockPool`` stores 256 2 MiB blocks: each on the member
   the port's ring names, both members holding some (the split printed),
   every get bit-exact; the second store killed, once its lease expires
   its shard misses and the first's hits bit for bit. Gates too: worker
   A's scatter launches equal its 8 G4 onboards and B's its tier windows
   ((b)'s and (e)'s)
   (one page-copy launch a window), both workers gathered their offloads,
   no ERROR record but A's crash's. Prints the priors measured on the card (recompute
   seconds a block from A's cold first run, and from B's cold run, whose
   plans looked up every block: the planner's lookup cost; the tier
   stream's G2 read; the tier wire's GB/s) and, per prompt, the planner's
   verdict under the port's defaults, the reference's priors and the
   measured ones beside the measured fetch and recompute; the report adds
   the phase's page-copy launches to the gather_layers / scatter_layers
   rows.
17. tp: tensor parallelism on the one card. (a) the decode, flash-extend
   and unified kernels against their plain versions at one rank's heads
   of llama3-8b at tp = 2 (16 query heads over 4 kv heads, d 128; the
   ``_tp2`` rows of the report). (b) a ``--tp 2`` worker's group (the
   worker's own ``join_tp_group`` and ``build_worker_engine``: this
   process leads, one follower process of ``python -m
   dynamo_tpu_torch.engine`` replays), llama3-8b at full width on 8 of
   its 32 layers (random bf16 weights from seed 0), both ranks on cuda:0:
   NCCL refuses two ranks on one device, so the collectives are gloo on
   CUDA tensors (copied through the host, the backend printed) and the
   horizons run eagerly; 4 greedy prompts (one past the 2048-token chunk)
   and one seeded sampled prompt of 32 tokens, all queued at once, top-5
   logprobs. Then a tp = 1 engine on the same weights and depth, eager too,
   serves the same traffic. Gates: the greedy tp = 2 streams equal the
   tp = 1 ones or leave them at a bf16 near-tie (phase 9's tie rule); the
   follower sampled exactly the leader's tokens (each rank's digest of
   every op's samples); the three kernels launched on each rank (the
   follower's exit report) as often as on the leader, at its 16 / 4 heads;
   the run went through chunked prefill, fused mixed steps and horizons;
   the all-reduces per forward pass equal 2 x layers on each rank.
   Observations, with the card's name and power limit: TTFT and ITL at
   tp = 2 and tp = 1 (one shared card: the ranks' kernels time-slice and
   their collectives cross the host, so these are not TP's numbers), and
   the seconds of one [8, 4096] bf16 all-reduce and of one logits gather.
18. report: one JSON line with every kernel's numbers, the nvidia-smi line,
   and last the device line ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when no CUDA device is present or
when the dynamo_tpu_torch package is not beside this script.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import functools
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# dense bf16 tensor-core flop/s
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
# kernel vs plain version, both bf16 out: bf16 keeps ~3 significant digits
# and the two sum in different orders and round at different points. Every
# element within KERNEL_ATOL + KERNEL_RTOL * |plain| (the worst error
# measured is 2.0e-3, on flash-extend rows of magnitude ~1), and every
# output row (one token, one head) within KERNEL_ROW_REL in relative L2
# norm: on rows of 1-2k keys, whose elements are ~0.03, the elementwise
# limit alone would pass a small systematic error such as a bad rescale.
KERNEL_ATOL, KERNEL_RTOL = 4e-3, 2e-2
KERNEL_ROW_REL = 2e-2
# model check: the last position's logits of the kernel path against the
# plain path, as ||kernels - plain|| / ||plain|| (a max elementwise diff of
# bf16-rounded logits sits a few rounding steps from any fixed limit). The
# same reading is taken for deliberately wrong attentions (MODEL_MUTANTS);
# the limit lies between the kernel path's readings and theirs (PERF.md).
MODEL_REL_TOL = 3e-2
MODEL_SEEDS = (1, 2, 3)
# Llama-3-8B attention shapes
H, KVH, D, BS = 32, 8, 128, 16


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, prefixed with the seconds since start (the
    phases' budget is read from these)."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
class Timer:
    """Median over repeats of one call, timed with CUDA events. Before each
    repeat the 50 MB L2 cache is flushed (the serving path finds each
    layer's cache cold) and the GPU is kept busy for ~0.1 ms, so the host's
    work to launch the call overlaps that wait instead of landing between
    the two events."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 15, warmup: int = 2, busy: int = 200_000) -> float:
        """``busy``: GPU cycles to wait before the call; raise it for a call
        whose host work before its launch outlasts the default."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(busy)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = flops / BF16_FLOPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, got, want, name: str) -> float:
    """Max abs error of a kernel's output against its plain version's;
    raises past the elementwise or the per-row limit."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    limit = KERNEL_ATOL + KERNEL_RTOL * want.abs()
    norm = want.norm(dim=-1)
    row_rel = ((got - want).norm(dim=-1) / norm.clamp_min(1e-30))[norm > 0]
    worst_row = row_rel.max().item() if row_rel.numel() else 0.0
    if bool((err > limit).any()) or worst_row > KERNEL_ROW_REL:
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max abs err "
            f"{err.max().item():.4g} (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}), "
            f"worst row relative L2 {worst_row:.4g} (limit {KERNEL_ROW_REL})"
        )
    return err.max().item()


def ptxas_summary(build_log: str) -> list:
    """Each kernel of a `nvcc -Xptxas -v` log: its entry name (mangled,
    cut to 60 characters), registers, and spill stores and loads."""
    import re

    out, name = [], "?"
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)[:60]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers, {spill}")
    return out


def unified_occupancy(_build) -> list:
    """(d, int8, blocks per SM, dynamic shared bytes) of the unified kernel
    at each head_dim it takes, from the occupancy calculator
    (dtt_unified_occupancy)."""
    import ctypes

    fn = _build.load("unified_attention.cu").dtt_unified_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = []
    for d in (64, 128, 256):
        for i8 in (0, 1):
            blocks, smem = ctypes.c_int(), ctypes.c_int()
            err = fn(d, i8, ctypes.byref(blocks), ctypes.byref(smem))
            if err:
                raise AssertionError(f"occupancy of the unified kernel at d={d}: CUDA error {err}")
            out.append((d, bool(i8), blocks.value, smem.value))
    return out


# the libraries whose SASS must hold tensor-core instructions
TENSOR_CORE_LIBS = ("libdecode_attention.so", "libflash_extend.so", "libunified_attention.so",
                    "libmla_attention.so")


def cuobjdump_tool():
    """The toolkit's cuobjdump, or None."""
    import shutil

    tool = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    return tool if os.path.exists(tool) else shutil.which("cuobjdump")


def sass_of(tool: str, path: str) -> str:
    return subprocess.run([tool, "-sass", path], capture_output=True, text=True, timeout=300,
                          check=True).stdout


def tensor_core_instructions(out_dir: str) -> dict:
    """Counts HGMMA (wgmma) and HMMA (mma.sync) instructions in the SASS of
    the decode, flash-extend, unified and latent libraries (cuobjdump
    -sass) and fails if a library has none. Where the toolkit has no cuobjdump it says so."""
    tool = cuobjdump_tool()
    if tool is None:
        log("SASS check: no cuobjdump in this CUDA toolkit; tensor-core instructions not counted")
        return {}
    counts = {}
    # one cuobjdump per library, all at once
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(TENSOR_CORE_LIBS)) as pool:
        dumps = dict(zip(TENSOR_CORE_LIBS, pool.map(
            lambda lib: sass_of(tool, os.path.join(out_dir, lib)), TENSOR_CORE_LIBS)))
    for lib in TENSOR_CORE_LIBS:
        sass = dumps[lib]
        counts[lib] = {op: sum(1 for l in sass.splitlines() if op + "." in l or op + " " in l)
                       for op in ("HGMMA", "HMMA")}
        log(f"SASS {lib}: {counts[lib]['HGMMA']} HGMMA, {counts[lib]['HMMA']} HMMA")
        if not sum(counts[lib].values()):
            raise AssertionError(f"{lib}: no tensor-core instruction in its SASS")
        if lib == "libunified_attention.so":
            # the head_dim 64 forms (gpt-oss) on their own
            per = {}
            for part in sass.split("Function : ")[1:]:
                name = part.split()[0]
                if "unified_kernelILi64E" in name:
                    per[name[:40]] = sum(1 for l in part.splitlines() if "HGMMA." in l)
            log(f"SASS {lib}, the d = 64 forms: {per}")
            if len(per) != 2 or not all(per.values()):
                raise AssertionError(f"{lib}: the d = 64 forms hold no HGMMA: {per}")
    return counts


# ------------------------------------------------------------- phase 2
def quantized(torch, cache):
    """A bf16 paged cache [nb, BS, kvh, D] quantized to the int8 format
    (ops/quant.quantize_blocks: int8 pages + f32 [nb, kvh] scales)."""
    from dynamo_tpu_torch.ops.quant import QuantizedKV, quantize_blocks

    return QuantizedKV(*quantize_blocks(cache))


def paged_case(torch, gen, lens, num_blocks, kvh=KVH, int8=False, d=D):
    """Random bf16 paged cache with each row on scrambled distinct pages
    (table padding -> scratch block 0); ``int8`` quantizes it."""
    dev = "cuda"
    kc = torch.randn(num_blocks, BS, kvh, d, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(num_blocks, BS, kvh, d, generator=gen, device=dev).to(torch.bfloat16)
    mb = max(-(-n // BS) for n in lens) + 4
    tables = np.zeros((len(lens), mb), np.int32)
    free = list(np.random.default_rng(0).permutation(np.arange(1, num_blocks)))
    for r, n in enumerate(lens):
        for j in range(-(-n // BS)):
            tables[r, j] = free.pop()
    if int8:
        kc, vc = quantized(torch, kc), quantized(torch, vc)
    return kc, vc, torch.as_tensor(tables, device=dev)


def kv_bytes(n_keys, kvh, int8, d=D):
    """Bytes of n_keys K and V rows of kvh heads: bf16 rows, or int8 rows
    plus the scale rows of their ceil(n / BS) pages (f32 per kv head)."""
    if int8:
        return 2 * (n_keys * kvh * d + 4 * -(-n_keys // BS) * kvh)
    return 2 * 2 * n_keys * kvh * d


def expand_kv(torch, kc, vc, table, T, h=H):
    """Gathered [T, h, d] K/V of one row with kv heads repeated to q heads
    (the library yardstick's input)."""
    from dynamo_tpu_torch.ops import attention as att

    k, v = att.gather_kv(kc, vc, table)   # an int8 cache dequantizes (f32)
    g = h // k.shape[1]
    return (k[:T].to(torch.bfloat16).repeat_interleave(g, dim=1).transpose(0, 1),
            v[:T].to(torch.bfloat16).repeat_interleave(g, dim=1).transpose(0, 1))


# decode kernel cases: the check batch (the lens of every earlier timing), rows at
# llama serving's 4096-key limit, and one such row alone
DECODE_CASES = {
    "check batch": [1, 17, 250, 999, 2100, 513, 77, 1500],
    "long rows": [3000, 4096, 3500, 3900, 3100, 4000, 3300, 3700],
    "one long row": [4096],
}
# the cases whose split-K must reach the SM count in working blocks
DECODE_FILL = ("check batch", "long rows")


def decode_case(torch, gen, timer, lens, int8, sms, shape=(H, KVH, D)):
    """One decode case: the kernel against its plain version (and the plain
    split form), the split counts the kernel wrote against att.split_plan,
    the drop-last-split mutant of the plain merge (must fail the compare),
    and the times of the kernel, the plain version, SDPA and the unified
    kernel on the same rows as q_len = 1 rows. ``shape``: (query heads, kv
    heads, head_dim)."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_attention, cuda_unified

    h, kvh, d = shape
    pages = sum(-(-n // BS) for n in lens)
    kc, vc, tables = paged_case(torch, gen, lens, num_blocks=pages + 64, kvh=kvh, int8=int8,
                                d=d)
    B = len(lens)
    q = torch.randn(B, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    i32 = dict(dtype=torch.int32, device="cuda")
    seq_lens = torch.tensor(lens, **i32)
    args = (q, kc, vc, tables, seq_lens)
    bound_kw = dict(max_seq_len=max(lens))
    tag = f"decode{' int8' if int8 else ''} {lens if B < 9 else B} h={h} kvh={kvh} d={d}"
    cuda_attention.split_log = []
    try:
        got = cuda_attention.paged_decode_attention(*args, **bound_kw)
        (grid, n_dev), = cuda_attention.split_log
    finally:
        cuda_attention.split_log = None
    err = compare(torch, got, att.paged_decode_attention(*args), tag)
    S = cuda_attention.split_extent(max(lens))
    compare(torch, got, att.split_paged_decode_attention(
        *args, split_keys=cuda_attention.DEC_SPLIT_KEYS, max_splits=S), tag + " (plain split)")
    n_kernel = n_dev.tolist()
    n_plain = [att.split_plan(1, n, 0, cuda_attention.DEC_SPLIT_KEYS, BS, S)[2] if S > 1
               else 0 for n in lens]
    if n_kernel != n_plain:
        raise AssertionError(f"{tag}: the kernel split its rows {n_kernel}, the plain split "
                             f"plan {n_plain}")
    blocks = kvh * sum(max(n, 1) for n in n_kernel)
    # the mutant: the plain merge without each split row's last split
    starts = torch.arange(B, dtype=torch.int32)
    ones = torch.ones(B, dtype=torch.int32)
    acc, m, l, n = att.attention_partials(
        q, kc, vc, tables, starts, ones, seq_lens.cpu(),
        split_keys=cuda_attention.DEC_SPLIT_KEYS, align=BS, max_splits=S)
    for r, c in enumerate(n.tolist()):
        if c >= 2:
            l[r, c - 1] = 0.0
    if not any(c >= 2 for c in n.tolist()):
        raise AssertionError(f"{tag}: no row is split")
    wrong = att.merge_attention_partials(acc, m, l, n, starts, ones, got.clone())
    try:
        compare(torch, got, wrong, tag + " against its drop-last-split mutant")
    except AssertionError:
        pass
    else:
        raise AssertionError(f"{tag}: a merge without the last split passes the compare")
    del acc, m, l, wrong
    T = max(lens)
    ks, vs = zip(*(expand_kv(torch, kc, vc, tables[r], T, h) for r in range(B)))
    kl, vl = torch.stack(ks), torch.stack(vs)                  # [B, h, T, d]
    del ks, vs
    mask = (torch.arange(T, device="cuda")[None, :] < seq_lens[:, None])[:, None, None, :]
    ql = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    uargs = (q, kc, vc, tables, torch.arange(B, **i32), torch.ones(B, **i32), seq_lens)
    n_keys = sum(lens)
    b, by = bound(
        2 * 2 * B * h * d                       # q in, out
        + sum(kv_bytes(n, kvh, int8, d) for n in lens)   # K and V rows needed
        + 4 * (B + sum(-(-n // BS) for n in lens)),
        4 * n_keys * h * d,
    )
    ms = timer(lambda: cuda_attention.paged_decode_attention(*args, **bound_kw))
    out = {
        "lens": lens, "max_abs_err": err, "grid": grid, "splits_per_row": n_kernel,
        "working_blocks": blocks, "drop_last_split_mutant_fails": True,
        "ms": ms,
        "plain_ms": timer(lambda: att.paged_decode_attention(*args), reps=5),
        "library_ms": timer(lambda: sdpa(ql, kl, vl, attn_mask=mask)),
        "unified_ms": timer(lambda: cuda_unified.ragged_paged_attention(
            *uargs, max_q_len=1, **bound_kw)),
        "bound_ms": b, "bound_by": by, "achieved_tb_s": b / ms * HBM_BYTES_S / 1e12,
    }
    log(f"  {tag}: max abs err {err:.3g}; {ms:.4f} ms kernel, {out['plain_ms']:.4f} ms "
        f"plain, {out['library_ms']:.4f} ms SDPA, {out['unified_ms']:.4f} ms unified "
        f"(q_len 1 rows), bound {b:.4f} ms ({by}), {out['achieved_tb_s']:.2f} TB/s; grid "
        f"{grid}, splits per row {n_kernel} (the kernel's count), {blocks} working blocks "
        f"on {sms} SMs")
    return out


def check_decode(torch, gen, timer, int8=False, shape=(H, KVH, D), tag="",
                 case_names=tuple(DECODE_CASES), fill=DECODE_FILL):
    """The decode kernel on each DECODE_CASES case named; the top-level
    numbers are the check batch's (the shapes every earlier run timed).
    ``shape``: (query heads, kv heads, head_dim); ``tag``: the report
    name's model suffix; ``fill``: the cases whose split-K must reach
    the SM count in working blocks."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = {name: decode_case(torch, gen, timer, DECODE_CASES[name], int8, sms, shape)
             for name in case_names}
    for name in fill:
        if cases[name]["working_blocks"] < sms:
            raise AssertionError(f"decode {name}: {cases[name]['working_blocks']} working "
                                 f"blocks on {sms} SMs")
    main = cases["check batch"]
    return {
        "name": "paged_decode_attention" + tag + ("_int8" if int8 else ""), "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas_attention.py:36",
        "shape": f"B={len(main['lens'])} lens={main['lens']} h={shape[0]} kvh={shape[1]} "
                 f"d={shape[2]} bs={BS} "
                 + ("int8 cache + f32 scales" if int8 else "bf16")
                 + "; top-level numbers: the check batch; every case under 'cases' "
                   "(library: SDPA over the gathered KV; unified_ms: the unified kernel "
                   "on the same rows as q_len = 1 rows)",
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "unified_ms",
                                "bound_ms", "bound_by")},
        "cases": cases,
    }


def int8_context(torch, k):
    """A bf16 context [T, KVH, D] quantized per BS-row block, in the form
    ops.attention.gather_kv_quant hands the flash-extend kernel: int8 rows
    and f32 per-position scales [T, KVH]."""
    from dynamo_tpu_torch.ops.quant import quantize_blocks

    T = k.shape[0]
    q, s = quantize_blocks(k.reshape(T // BS, BS, *k.shape[1:]))
    return q.reshape(k.shape), s[:, None, :].expand(T // BS, BS, k.shape[1]).reshape(T, -1)


def check_flash(torch, gen, timer, int8=False, shape=(H, KVH, D), tag=""):
    """Flash-extend against its plain version on a ragged continuation
    chunk, then the first 2048-token chunk, timed. ``shape``: (query heads,
    kv heads, head_dim); ``tag``: the report name's model suffix."""
    from dynamo_tpu_torch.ops import cuda_prefill

    H, KVH, D = shape   # this shape's, not Llama-3-8B's

    def case(S, start, total):
        T = -(-total // BS) * BS
        q = torch.randn(S, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn(T, KVH, D, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(T, KVH, D, generator=gen, device="cuda").to(torch.bfloat16)
        if not int8:
            return (q, k, v, start, total), {}
        (kq, ks), (vq, vs) = int8_context(torch, k), int8_context(torch, v)
        return (q, kq, vq, start, total), {"k_scales": ks, "v_scales": vs}

    def run(c, kernel):
        fn = (cuda_prefill.flash_extend_attention if kernel
              else cuda_prefill.flash_extend_reference)
        return fn(*c[0], **c[1])

    # a ragged continuation chunk (952 real rows in a 1024 bucket over a
    # 2048-token prefix), checked only, then the full first chunk, timed
    cont = case(1024, 2048, 3000)
    label = f"{tag}{' int8' if int8 else ''} h={H} kvh={KVH} d={D}"
    err = compare(torch, run(cont, True), run(cont, False), "flash_extend continuation" + label)
    S = 2048
    first = case(S, 0, S)
    err = max(err, compare(torch, run(first, True), run(first, False), "flash_extend" + label))
    q, k, v, _, _ = first[0]
    if int8:   # the library call takes the dequantized context
        k = (k.float() * first[1]["k_scales"][..., None]).to(torch.bfloat16)
        v = (v.float() * first[1]["v_scales"][..., None]).to(torch.bfloat16)
    g = H // KVH
    ql = q.transpose(0, 1)[None].contiguous()
    kl = k.repeat_interleave(g, dim=1).transpose(0, 1)[None].contiguous()
    vl = v.repeat_interleave(g, dim=1).transpose(0, 1)[None].contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = S * (S + 1) // 2
    ctx_bytes = 2 * S * KVH * (D + 4) if int8 else 2 * 2 * S * KVH * D
    b, by = bound(2 * 2 * S * H * D + ctx_bytes, 4 * pairs * H * D)
    return {
        "name": "flash_extend_attention" + tag + ("_int8" if int8 else ""), "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/flash_extend.cu",
        "replaces": "dynamo_tpu/ops/pallas_prefill.py:44",
        "shape": f"S={S} start=0 total={S} h={H} kvh={KVH} d={D} "
                 + ("int8 context + f32 per-position scales " if int8 else "bf16 ")
                 + "(also checked: S=1024 start=2048 total=3000)",
        "max_abs_err": err,
        "ms": timer(lambda: run(first, True)),
        "plain_ms": timer(lambda: run(first, False), reps=5),
        "library_ms": timer(lambda: sdpa(ql, kl, vl, is_causal=True)),
        "bound_ms": b, "bound_by": by,
    }


def check_unified(torch, gen, timer, int8=False, shape=(H, KVH, D), tag=""):
    """The unified kernel against its plain version on a llama mixed step
    (a prefill segment, decode rows, an empty row), timed. ``shape``:
    (query heads, kv heads, head_dim); ``tag``: the report name's model
    suffix."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_unified

    H, KVH, D = shape   # this shape's, not Llama-3-8B's

    # (q_len, seq_len): a 437-token prefill segment over a 1200-token
    # prefix, decode rows (one past 2,000 tokens), an empty row; 5-token
    # gaps between segments
    rows = [(437, 1637), (1, 2100), (1, 17), (0, 300), (1, 999), (1, 250), (1, 1)]
    kc, vc, tables = paged_case(torch, gen, [sl for _, sl in rows], num_blocks=512,
                                kvh=KVH, int8=int8, d=D)
    starts, pos = [], 0
    for ql, _ in rows:
        starts.append(pos)
        pos += ql + 5
    Tq = pos
    q = torch.randn(Tq, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    i32 = dict(dtype=torch.int32, device="cuda")
    q_starts = torch.tensor(starts, **i32)
    q_lens = torch.tensor([ql for ql, _ in rows], **i32)
    seq_lens = torch.tensor([sl for _, sl in rows], **i32)
    args = (q, kc, vc, tables, q_starts, q_lens, seq_lens)
    max_q = max(ql for ql, _ in rows)
    bounds = dict(max_q_len=max_q, max_seq_len=max(sl for _, sl in rows))
    err = compare(torch, cuda_unified.ragged_paged_attention(*args, **bounds),
                  att.ragged_paged_attention(*args),
                  f"unified{tag}{' int8' if int8 else ''} h={H} kvh={KVH} d={D}")
    # library yardstick: one masked SDPA over the rows padded to a batch
    R, T = len(rows), max(sl for _, sl in rows)
    qp = torch.zeros(R, H, max_q, D, dtype=torch.bfloat16, device="cuda")
    mask = torch.zeros(R, 1, max_q, T, dtype=torch.bool, device="cuda")
    kp = torch.zeros(R, H, T, D, dtype=torch.bfloat16, device="cuda")
    vp = torch.zeros_like(kp)
    for r, (ql, sl) in enumerate(rows):
        k_r, v_r = expand_kv(torch, kc, vc, tables[r], sl, H)
        kp[r, :, :sl], vp[r, :, :sl] = k_r, v_r
        qp[r, :, :ql] = q[starts[r]:starts[r] + ql].transpose(0, 1)
        qpos = torch.arange(sl - ql, sl, device="cuda")
        mask[r, 0, :ql] = torch.arange(T, device="cuda")[None, :] <= qpos[:, None]
        mask[r, 0, ql:, 0] = True   # padding rows: one visible key, no NaN
    sdpa = torch.nn.functional.scaled_dot_product_attention
    live = [(ql, sl) for ql, sl in rows if ql > 0 and sl > 0]
    pairs = sum(sum(sl - ql + i + 1 for i in range(ql)) for ql, sl in live)
    b, by = bound(
        2 * (sum(ql for ql, _ in live) * H * D          # member queries in
             + Tq * H * D)                              # packed output
        + sum(kv_bytes(sl, KVH, int8, D) for _, sl in live)   # K and V rows needed
        + 4 * (3 * R + sum(-(-sl // BS) for _, sl in live)),
        4 * pairs * H * D,
    )
    return {
        "name": "ragged_paged_attention" + tag + ("_int8" if int8 else ""), "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/unified_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas_unified.py:93",
        "shape": f"rows(q_len,seq_len)={rows} Tq={Tq} h={H} kvh={KVH} d={D} bs={BS} "
                 + ("int8 cache + f32 scales" if int8 else "bf16"),
        "max_abs_err": err,
        "ms": timer(lambda: cuda_unified.ragged_paged_attention(*args, **bounds)),
        "plain_ms": timer(lambda: att.ragged_paged_attention(*args), reps=5),
        "library_ms": timer(lambda: sdpa(qp, kp, vp, attn_mask=mask)),
        "bound_ms": b, "bound_by": by,
    }


# Gemma attention shapes (gemma2-2b and gemma3-4b): 8 query heads over 4 kv
# heads, head_dim 256, block 16
GH, GKVH, GD = 8, 4, 256
# gemma3's sliding window; contexts up to ~5 windows long, so windowed rows
# skip pages
GEMMA_WINDOW = 1024
# (q_len, seq_len, window): windowed prefill segments over long prefixes,
# windowed decode rows several windows long and exactly w, w + 1 and w + bs
# long, full rows (window 0) and an empty row in one launch
GEMMA_ROWS = [(700, 3100, 1024), (1, 5000, 1024), (1, 1024, 1024), (1, 1025, 1024),
              (1, 1040, 1024), (0, 300, 1024), (1, 17, 1024), (1, 4100, 0),
              (300, 1200, 0), (1, 3000, 1024)]
GEMMA_SOFTCAP = 50.0
# the Gemma serving run's prompt lengths (serve_gemma)
GEMMA_PROMPTS = (300, 1500, 2600, 4100, 5200, 6000, 7000, 8000)
# a decode-only batch: those 8 rows at their 16th output token, through a
# gemma2 sliding layer (window 4096, softcap): each row fills G = 2 of the
# tile's 64 query rows
GEMMA_DECODE_ROWS = [(1, n + 16, 4096) for n in GEMMA_PROMPTS]
# short rows at the kernel's own split size (SPLIT_KEYS = 512): the two
# 32-token rows, one windowed and one full, end in a split of 7 and of 10
# keys that starts after the positions of their first 25 and 22 tokens
# (those see no key there: l = 0, which the merge must weigh 0); a
# windowed decode row with planted window edges in 3 splits, a 5-token
# full row in 2, and a windowed segment that fits one split; sinks on, so
# a sink counted once per split would show. No 512-key split of a row of
# at most 64 / G = 32 tokens can lie wholly below a token's window: every
# token's window starts inside the row's first split.
GEMMA_SPLIT_ROWS = [(32, 3015, 1000), (32, 1034, 0), (20, 2000, 100), (1, 2500, 1024),
                    (5, 700, 0)]
# each case one launch over its rows (default GEMMA_ROWS): which attributes
# it carries
GEMMA_CASES = {
    "window": dict(window=True),
    "full": dict(),
    "softcap": dict(softcap=True),
    "sinks": dict(sinks=True),
    "window+softcap+sinks": dict(window=True, softcap=True, sinks=True),
    "decode batch, window+softcap": dict(window=True, softcap=True, rows=GEMMA_DECODE_ROWS),
    "short rows, splits some tokens never reach, window+sinks": dict(
        window=True, sinks=True, rows=GEMMA_SPLIT_ROWS),
}


def visible_pairs(ql, sl, w):
    """(query, key) pairs a row's segment scores: token p = sl - ql + i sees
    keys max(p - w + 1, 0) .. p (w <= 0: from 0)."""
    n = 0
    for p in range(sl - ql, sl):
        n += p + 1 - (max(p - w + 1, 0) if w > 0 else 0)
    return n


def live_pages(ql, sl, w):
    """Pages of a row the kernel must read: from the first page the row's
    earliest query sees (ops/costs.py unified_attention_bytes) to
    ceil(seq_len / BS)."""
    first = max(sl - ql - w + 1, 0) // BS if w > 0 else 0
    return -(-sl // BS) - first


# planted keys at each windowed decode row's window edge (plant_window_edges)
EDGE_SCORE = 38.0
EDGE_V = (6.0, -3.0)


def plant_window_edges(torch, kc, vc, tables, q, starts, rows):
    """At each windowed decode row's window edge, whose query sits at
    p = seq_len - 1: a key at p - w (the last one the window drops) and
    one at p - w + 1 (the first it keeps), each the least-norm key whose
    scaled score is EDGE_SCORE for every one of its kv head's G queries
    (38 against ~16 at most for the random keys, and still the largest
    after a softcap of 50; the same for every head, so at G = 8 no head's
    query misses it), with values EDGE_V. Taking or dropping either moves
    every head's output by O(1), so a window bound one key off fails the
    kernel's compare. In place on a bf16 cache [nb, BS, kvh, d]. Returns
    (query token, whether key p - w exists) per planted row."""
    kvh, d = kc.shape[2], kc.shape[3]
    edges = []
    for r, (ql, sl, w) in enumerate(rows):
        if ql != 1 or w <= 0 or sl < w:   # no key at the window's edge
            continue
        tok = starts[r]
        qg = q[tok].float().reshape(kvh, -1, d)                      # [kvh, G, d]
        want = torch.full(qg.shape[:2] + (1,), EDGE_SCORE * d ** 0.5, device=q.device)
        k = (qg.transpose(1, 2) @ torch.linalg.solve(qg @ qg.transpose(1, 2), want))[..., 0]
        for j, val in zip((sl - 1 - w, sl - w), EDGE_V):
            if j >= 0:
                page, off = int(tables[r, j // BS]), j % BS
                kc[page, off] = k.to(kc.dtype)
                vc[page, off] = val
        edges.append((tok, sl - 1 - w >= 0))
    return edges


def edge_gap(torch, args, kw, want, edges) -> float:
    """Least relative L2 distance, over the planted tokens' (token, head)
    rows, between ``want`` (the plain output at the rows' windows) and the
    plain output at windows one key narrower, and one key wider where a
    key below the bound exists: what a one-key error at the edge costs."""
    from dynamo_tpu_torch.ops import attention as att

    gaps = []
    for step in (-1, 1):
        other = att.ragged_paged_attention(
            *args, **dict(kw, windows=kw["windows"] + step)).float()
        for tok, below in edges:
            if step > 0 and not below:
                continue
            a = want[tok].float()
            gaps.append(((a - other[tok]).norm(dim=-1) / a.norm(dim=-1)).min().item())
    return min(gaps)


def attrs_library_call(torch, q, kc, vc, tables, starts, rows, windowed, softcap, sinks,
                       flex):
    """One PyTorch call computing the same function as an attribute case
    (check_unified_attrs), on the same KV gathered (an int8 cache
    dequantized) into a padded batch [R, h, Tp, d] whose key T (one past
    the longest row) is zero and whose length Tp is a multiple of 16 (an
    unaligned mask would be copied on every call); padding query rows see
    key 0.
    Without ``flex``: scaled_dot_product_attention with the boolean causal
    (and window) mask; with sinks, the same call with a float mask whose
    entry at the zero key is the head's sink logit, so the sink enters the
    denominator only. With ``flex`` (compiled flex_attention; the softcap
    cases, and gpt-oss's sink cases): a score_mod taking cap * tanh(s /
    cap) where a softcap is on and returning the sink at the zero key,
    under a block mask of the same visibility. Returns (call, packed output
    of a call's result)."""
    from torch.nn.attention.flex_attention import create_block_mask

    dev = q.device
    R, T = len(rows), max(sl for _, sl, _ in rows)
    max_q = max(ql for ql, _, _ in rows)
    h, d = q.shape[1], q.shape[2]
    Tp = -(-(T + 1) // 16) * 16
    qp = torch.zeros(R, h, max_q, d, dtype=torch.bfloat16, device=dev)
    kp = torch.zeros(R, h, Tp, d, dtype=torch.bfloat16, device=dev)
    vp = torch.zeros_like(kp)
    for r, (ql, sl, _) in enumerate(rows):
        kp[r, :, :sl], vp[r, :, :sl] = expand_kv(torch, kc, vc, tables[r], sl, h=h)
        qp[r, :, :ql] = q[starts[r]:starts[r] + ql].transpose(0, 1)
    i64 = dict(dtype=torch.long, device=dev)
    q_len = torch.tensor([ql for ql, _, _ in rows], **i64)
    q_off = torch.tensor([sl - ql for ql, sl, _ in rows], **i64)
    # no window: a bound past every key
    lo = torch.tensor([w if windowed and w > 0 else Tp for _, _, w in rows], **i64)

    def visible(b, q_idx, kv_idx):
        p = q_off[b] + q_idx
        vis = (kv_idx <= p) & (kv_idx > p - lo[b])
        return torch.where(q_idx >= q_len[b], kv_idx == 0, vis)

    def unpack(out):
        packed = torch.zeros_like(q)
        for r, (ql, _, _) in enumerate(rows):
            packed[starts[r]:starts[r] + ql] = out[r, :, :ql].transpose(0, 1)
        return packed

    sdpa = torch.nn.functional.scaled_dot_product_attention
    if flex is None:
        b, qi, ki = (torch.arange(n, device=dev) for n in (R, max_q, Tp))
        vis = visible(b[:, None, None], qi[None, :, None], ki[None, None, :])[:, None]
        if sinks is None:
            return (lambda: sdpa(qp, kp, vp, attn_mask=vis)), unpack
        mask = torch.zeros(R, h, max_q, Tp, dtype=torch.bfloat16, device=dev)
        mask.masked_fill_(~vis, float("-inf"))
        mask[..., T] = sinks[None, :, None].to(torch.bfloat16)
        return (lambda: sdpa(qp, kp, vp, attn_mask=mask)), unpack

    def mask_mod(b, hh, q_idx, kv_idx):
        vis = visible(b, q_idx, kv_idx)
        return vis | (kv_idx == T) if sinks is not None else vis

    def score_mod(score, b, hh, q_idx, kv_idx):
        capped = softcap * torch.tanh(score / softcap) if softcap else score
        return capped if sinks is None else torch.where(kv_idx == T, sinks[hh], capped)

    block_mask = create_block_mask(mask_mod, R, None, max_q, Tp, device=dev)
    return (lambda: flex(qp, kp, vp, score_mod=score_mod, block_mask=block_mask)), unpack


# gpt-oss-20b attention shapes: 64 query heads over 8 kv heads (G = 8, so a
# q tile holds 8 tokens), head_dim 64, block 16, window 128 on even layers
# and per-head sinks on all
OH, OKVH, OD = 64, 8, 64
GPTOSS_WINDOW = 128
# the gpt-oss serving run's prompt lengths (serve_windowed)
GPTOSS_PROMPTS = (100, 700, 1500, 2600, 3300, 4100, 5000, 6000)
GPTOSS_INT8_PROMPTS = (4100, 1500, 300)
# a decode batch of 8 rows of 1 to 8000 keys, through a sliding layer
# (window 128) and through a full one (window 0), sinks on in both
GPTOSS_DECODE_LENS = (1, 130, 700, 1500, 3000, 4500, 6000, 8000)
GPTOSS_DECODE_ROWS = [(1, n, GPTOSS_WINDOW) for n in GPTOSS_DECODE_LENS]
# the last 2048-token chunk of a 6000-token prompt through a sliding layer
GPTOSS_PREFILL_ROWS = [(2048, 6000, GPTOSS_WINDOW)]
# a mixed step: windowed and full prefill segments, decode rows at and
# past the window, an empty row
GPTOSS_MIXED_ROWS = [(300, 1200, GPTOSS_WINDOW), (1, 3000, GPTOSS_WINDOW),
                     (1, 129, GPTOSS_WINDOW), (0, 50, GPTOSS_WINDOW), (1, 4100, 0),
                     (40, 2000, 0), (1, 17, GPTOSS_WINDOW)]
GPTOSS_CASES = {
    "decode batch, window 128 + sinks": dict(window=True, sinks=True, rows=GPTOSS_DECODE_ROWS),
    "decode batch, full + sinks": dict(sinks=True, rows=GPTOSS_DECODE_ROWS),
    "prefill 2048 of 6000, window 128 + sinks": dict(window=True, sinks=True,
                                                     rows=GPTOSS_PREFILL_ROWS),
    "mixed rows, windows + sinks": dict(window=True, sinks=True),
}


@dataclasses.dataclass(frozen=True)
class AttrFamily:
    """One model family's shapes and cases for the unified kernel's
    attribute checks (check_unified_attrs, check_merge)."""
    name: str          # report names end in _<name>
    h: int
    kvh: int
    d: int
    rows: list         # a case's rows (q_len, seq_len, window) unless it names its own
    cases: dict        # case -> its attributes (window, softcap, sinks, rows)
    main: str          # the case of the top-level numbers
    decode: str        # the decode batch: at least one working block per SM
    merge_rows: list   # the decode rows whose partial states check the merge
    merge_name: str
    softcap: float = 0.0
    split_rows: list = None   # rows whose splits some tokens never reach
    flex_for_sinks: bool = False   # library: flex_attention for sinks too
    # queries N(0, q_scale^2), sinks N(sink_mean, sink_std^2)
    q_scale: float = 4.0
    sink_mean: float = 10.0
    sink_std: float = 2.0


GEMMA = AttrFamily("gemma", GH, GKVH, GD, GEMMA_ROWS, GEMMA_CASES, "window",
                   "decode batch, window+softcap", GEMMA_DECODE_ROWS,
                   "merge_attention_partials", softcap=GEMMA_SOFTCAP,
                   split_rows=GEMMA_SPLIT_ROWS)
# (a window-128 decode row reads at most 128 keys and is never split: the
# full layer's decode batch fills the card and feeds the merge). No
# softcap, so the queries keep the model's score scale (N(0, 1) at d 64),
# and the sinks N(5, 1) weigh like a window's 128 keys (~e^5.3 of mass)
GPTOSS = AttrFamily("gptoss", OH, OKVH, OD, GPTOSS_MIXED_ROWS, GPTOSS_CASES,
                    "decode batch, window 128 + sinks", "decode batch, full + sinks",
                    [(1, n, 0) for n in GPTOSS_DECODE_LENS], "merge_attention_partials_gptoss",
                    flex_for_sinks=True, q_scale=1.0, sink_mean=5.0, sink_std=1.0)


def check_unified_attrs(torch, gen, timer, fam: AttrFamily, int8=False, flex=None):
    """The unified kernel with its row attributes at ``fam``'s shapes, one
    launch per case over its rows, each against its plain version, timed
    with its bound and its library yardstick (attrs_library_call; ``flex``:
    the compiled flex_attention it uses).
    Queries are N(0, fam.q_scale^2): Gemma's x4 brings scores to a
    softcap's range (~N(0, 16)), gpt-oss keeps N(0, 1); sinks are
    N(fam.sink_mean, fam.sink_std^2) logits, so their mass counts against
    rows' largest scores. Each windowed decode row carries planted keys at
    its window's edge (plant_window_edges); each windowed case asserts that
    a one-key error there costs at least 10 x KERNEL_ROW_REL."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_unified

    i32 = dict(dtype=torch.int32, device="cuda")
    h, kvh, d = fam.h, fam.kvh, fam.d
    sinks = fam.sink_mean + fam.sink_std * torch.randn(h, generator=gen, device="cuda")
    made = {}

    def inputs(rows):
        """Random paged K/V with planted window edges and packed queries
        for ``rows`` (segments 5 padding tokens apart), made once per row
        set."""
        key = id(rows)
        if key not in made:
            pages = sum(-(-sl // BS) for _, sl, _ in rows)
            kc, vc, tables = paged_case(torch, gen, [sl for _, sl, _ in rows],
                                        num_blocks=pages + 64, kvh=kvh, d=d)
            starts, pos = [], 0
            for ql, _, _ in rows:
                starts.append(pos)
                pos += ql + 5
            q = (fam.q_scale * torch.randn(pos, h, d, generator=gen,
                                           device="cuda")).to(torch.bfloat16)
            edges = plant_window_edges(torch, kc, vc, tables, q, starts, rows)
            if int8:
                kc, vc = quantized(torch, kc), quantized(torch, vc)
            made[key] = (starts, pos, edges, (
                q, kc, vc, tables, torch.tensor(starts, **i32),
                torch.tensor([ql for ql, _, _ in rows], **i32),
                torch.tensor([sl for _, sl, _ in rows], **i32)),
                torch.tensor([w for _, _, w in rows], **i32))
        return made[key]

    tag = f" {fam.name}" + (" int8" if int8 else "")
    cases, worst = {}, 0.0
    for name, attrs in fam.cases.items():
        rows = attrs.get("rows", fam.rows)
        starts, Tq, edges, args, windows = inputs(rows)
        q, kc, vc, tables = args[:4]
        max_q = max(ql for ql, _, _ in rows)
        R = len(rows)
        live = [(ql, sl, w) for ql, sl, w in rows if ql > 0 and sl > 0]
        kw = {}
        if attrs.get("window"):
            kw["windows"] = windows
        if attrs.get("softcap"):
            kw["softcap"] = fam.softcap
        if attrs.get("sinks"):
            kw["sinks"] = sinks
        plain = att.ragged_paged_attention(*args, **kw)
        bounds = dict(max_q_len=max_q, max_seq_len=max(sl for _, sl, _ in rows))
        # the launch logs its grid and the split count per row that the
        # kernel itself wrote; those must follow the plain split plan
        cuda_unified.split_log = []
        try:
            got = cuda_unified.ragged_paged_attention(*args, **bounds, **kw)
            (grid, n_dev), = cuda_unified.split_log
        finally:
            cuda_unified.split_log = None
        err = compare(torch, got, plain, f"unified{tag} {name}")
        worst = max(worst, err)
        n_kernel = n_dev.tolist() if n_dev is not None else [0] * R
        S, QS = cuda_unified.split_shape(h, kvh, max_q, bounds["max_seq_len"])
        n_plain = [att.split_plan(ql, sl, w if "windows" in kw else 0,
                                  cuda_unified.SPLIT_KEYS, cuda_unified.KEY_STEP, S)[2]
                   if S > 1 and 0 < ql <= QS and sl > 0 else 0 for ql, sl, w in rows]
        if n_kernel != n_plain:
            raise AssertionError(f"unified{tag} {name}: the kernel split its rows "
                                 f"{n_kernel}, the plain split plan {n_plain}")
        tq = att.TILE_ROWS // (h // kvh)
        blocks = kvh * sum(n if n >= 2 else -(-ql // tq) for (ql, sl, _), n
                           in zip(rows, n_kernel) if ql > 0 and sl > 0)
        unreached = None
        if rows is fam.split_rows:
            # (row, split, token) triples where the token sees none of the
            # split's keys (l = 0 for every head), from the plain partials
            _, _, l, n = att.attention_partials(
                *args, split_keys=cuda_unified.SPLIT_KEYS, align=cuda_unified.KEY_STEP,
                windows=kw.get("windows"), max_splits=S)
            unreached = sum(int((l[r, :c, :ql] == 0).all(-1).sum())
                            for r, (c, (ql, _, _)) in enumerate(zip(n.tolist(), rows)) if c)
            if not unreached:
                raise AssertionError(f"unified{tag} {name}: no token misses a whole split")
            log(f"  unified{tag} {name}: {unreached} (row, split, token) triples "
                "whose split holds no key the token sees")
        gap = None
        if "windows" in kw and edges:
            gap = edge_gap(torch, args, kw, plain, edges)
            if gap < 10 * KERNEL_ROW_REL:
                raise AssertionError(f"unified{tag} {name}: a one-key window error moves "
                                     f"the planted rows by only {gap:.3g}")
        wins = [w if attrs.get("window") else 0 for _, _, w in live]
        pairs = sum(visible_pairs(ql, sl, w) for (ql, sl, _), w in zip(live, wins))
        pages = sum(live_pages(ql, sl, w) for (ql, sl, _), w in zip(live, wins))
        kv_moved = (2 * pages * BS * kvh * d * (1 if int8 else 2)
                    + (2 * 4 * pages * kvh if int8 else 0))
        b, by = bound(
            2 * (sum(ql for ql, _, _ in live) * h * d + Tq * h * d)   # queries in, out
            + kv_moved + 4 * (4 * R + pages) + (4 * h if "sinks" in kw else 0),
            4 * pairs * h * d,
        )
        use_flex = bool(kw.get("softcap")) or (fam.flex_for_sinks and "sinks" in kw)
        cases[name] = {
            "rows": rows, "max_abs_err": err, "window_edge_gap": gap,
            "grid": grid, "splits_per_row": n_kernel, "working_blocks": blocks,
            "tokens_missing_a_split": unreached,
            "ms": timer(lambda: cuda_unified.ragged_paged_attention(*args, **bounds, **kw)),
            "plain_ms": timer(lambda: att.ragged_paged_attention(*args, **kw), reps=5),
            "library_ms": None, "library": None, "bound_ms": b, "bound_by": by,
        }
        # the library yardstick: SDPA on every case; the compiled
        # flex_attention (a compile of ~5-15 s a case) on the top-level
        # case only
        lib = ""
        if not use_flex or name == fam.main:
            library, unpack = attrs_library_call(
                torch, q, kc, vc, tables, starts, rows, "windows" in kw, kw.get("softcap"),
                kw.get("sinks"), flex if use_flex else None)
            lib_err = (unpack(library()).float() - plain.float()).abs().max().item()
            cases[name].update(
                library_ms=timer(library), library_max_abs_err=lib_err,
                library="flex_attention (compiled)" if use_flex
                else "scaled_dot_product_attention")
            del library, unpack
            lib = (f"{cases[name]['library_ms']:.4f} ms library ({cases[name]['library']}, "
                   f"max abs err {lib_err:.3g}), ")
        log(f"  unified{tag} {name}: max abs err {err:.3g}"
            + (f", window-edge gap {gap:.3g}" if gap is not None else "")
            + f"; {cases[name]['ms']:.4f} ms kernel, {cases[name]['plain_ms']:.4f} ms plain, "
            f"{lib}bound {b:.4f} ms ({by}); grid {grid}, splits per row "
            f"{n_kernel} (the kernel's count), {blocks} working blocks")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    decode = cases[fam.decode]
    if decode["working_blocks"] < sms:
        raise AssertionError(f"the {fam.name} decode batch runs {decode['working_blocks']} "
                             f"working blocks on {sms} SMs")
    main = cases[fam.main]
    return {
        "name": f"ragged_paged_attention_{fam.name}" + ("_int8" if int8 else ""),
        "route": "cuda", "source": "dynamo_tpu_torch/csrc/unified_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas_unified.py:93",
        "shape": f"rows(q_len,seq_len,window)={main['rows']} h={h} kvh={kvh} d={d} "
                 f"bs={BS} " + ("int8 cache + f32 scales" if int8 else "bf16")
                 + f"; top-level numbers: the {fam.main!r} case; every case under "
                   "'cases' (library: SDPA with the window mask, with the sinks as a "
                   "float mask over a zero key; compiled flex_attention where a "
                   "softcap is on" + (" or sinks are" if fam.flex_for_sinks else "") + ")",
        "max_abs_err": worst, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "library_ms": main["library_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "cases": cases,
    }


def check_merge(torch, gen, timer, fam: AttrFamily):
    """The split-K merge kernel against its plain version on partial states
    shaped as ``fam``'s decode batch leaves them (its merge_rows through
    the split plan; the Gemma batch: 8 rows, up to 16 splits of one token,
    8 heads, d 256). Each head's split maxima m lie near one level
    (c_h + N(0, 1)), each split's sum l in [1, 9] (at least 1: the split's
    own largest key), every split row's second split is empty (l = 0,
    m = NEG_INF), and the sinks sit near the rows' largest m
    (c_h + 1.5 + N(0, 1)) so that their mass counts: the plain merge with
    the sink counted once per split (a mutant) must fail the compare
    against the kernel."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_unified

    rows, h, d = fam.merge_rows, fam.h, fam.d
    R, dev = len(rows), "cuda"
    S, QS = cuda_unified.split_shape(h, fam.kvh, 1, max(sl for _, sl, _ in rows))
    n = [att.split_plan(ql, sl, w, cuda_unified.SPLIT_KEYS, cuda_unified.KEY_STEP, S)[2]
         for ql, sl, w in rows]
    level = 4 * torch.randn(h, generator=gen, device=dev)
    m = level + torch.randn(R, S, QS, h, generator=gen, device=dev)
    l = 1 + 8 * torch.rand(R, S, QS, h, generator=gen, device=dev)
    acc = torch.randn(R, S, QS, h, d, generator=gen, device=dev) * l[..., None]
    l[:, 1], m[:, 1], acc[:, 1] = 0.0, att.NEG_INF, 0.0
    i32 = dict(dtype=torch.int32, device=dev)
    meta = (torch.tensor(n, **i32), torch.arange(R, **i32), torch.ones(R, **i32))
    args = (acc, m, l, *meta)
    sinks = level + 1.5 + torch.randn(h, generator=gen, device=dev)
    out = torch.zeros(R, h, d, dtype=torch.bfloat16, device=dev)
    got = cuda_unified.merge_attention_partials(*args, out.clone(), sinks)
    err = compare(torch, got, att.merge_attention_partials(*args, out.clone(), sinks),
                  fam.merge_name)
    # the mutant: every live split seeded with the sink (l_s + exp(sink - m_s))
    per_split = torch.where(l > 0, l + torch.exp(sinks - m), l)
    wrong = att.merge_attention_partials(acc, m, per_split, *meta, out.clone())
    split = [r for r, c in enumerate(n) if c >= 2]
    moved = ((wrong[split].float() - got[split].float()).norm(dim=-1)
             / got[split].float().norm(dim=-1))
    gap = [moved.min().item(), moved.max().item()]
    try:
        compare(torch, got, wrong, f"{fam.merge_name} against its sink-per-split mutant")
    except AssertionError:
        pass
    else:
        raise AssertionError(f"{fam.merge_name}: a sink counted once per split passes the "
                             "compare")
    # bytes: m and l of every split of a split row, the accumulator of the
    # splits that saw a key (the kernel skips the rest), the output rows,
    # the row metadata and the sinks
    live = sum(int((l[r, :n[r]] > 0).sum()) for r in split)
    b, by = bound(sum(n[r] for r in split) * QS * h * 8 + live * d * 4
                  + len(split) * QS * h * d * 2 + 4 * 3 * R + 4 * h, 0)
    return {
        "name": fam.merge_name, "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/unified_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas_unified.py:93",
        "serves": "split-K of the unified kernel (kernel 3): merges its partial states",
        "shape": f"partials of the {fam.name} decode rows {rows}: R={R} S={S} QS={QS} h={h} "
                 f"d={d}, splits per row {n}, sinks on, one empty split per split row",
        "max_abs_err": err, "sink_per_split_row_gap": gap,
        "ms": timer(lambda: cuda_unified.merge_attention_partials(*args, out, sinks)),
        "plain_ms": timer(lambda: att.merge_attention_partials(*args, out, sinks), reps=5),
        "library_ms": None, "bound_ms": b, "bound_by": by,
    }


# (G, head_dim, int8) forms check_group_sizes holds to their plain versions:
# the llama kernels' other group sizes (qwen3-0.6b's 2, llama3-70b's 8)
GROUP_FORMS = tuple((g, D, i8) for i8 in (False, True) for g in (1, 2, 8))
# Qwen2.5's group sizes at d 128, and d 64 at Llama-3.2-1B's G 4 and
# Qwen2.5-0.5B's G 7 (phase shapes)
SHAPE_FORMS = tuple((g, d, i8) for i8 in (False, True)
                    for g, d in ((3, 128), (5, 128), (6, 128), (7, 128), (4, 64), (7, 64)))


def check_group_sizes(torch, gen, forms=GROUP_FORMS) -> dict:
    """Each kernel against its plain version at each (G, head_dim, int8)
    form on small ragged cases; untimed. Decode rows of 1-1333 keys (the
    long one split, its splits merged in the launch), a 77-token
    flash-extend chunk (at G 7 the tiles hold 9 tokens, the last 5: a
    ragged last tile whose padded rows must stay out of the output) and
    unified rows of 1-5 tokens (the 5-token row over 1333 keys split, its
    partials merged per query head). Returns the max abs error by form."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_attention, cuda_prefill, cuda_unified

    kvh, out = 2, {}
    i32 = dict(dtype=torch.int32, device="cuda")
    for g, d, int8 in forms:
        h = kvh * g
        lens = [1, 40, 1333]
        kc, vc, tables = paged_case(torch, gen, lens, num_blocks=128, kvh=kvh, int8=int8, d=d)
        tag = f"G={g} d={d}" + (" int8" if int8 else "")
        q = torch.randn(len(lens), h, d, generator=gen, device="cuda").to(torch.bfloat16)
        args = (q, kc, vc, tables, torch.tensor(lens, **i32))
        worst = compare(torch, cuda_attention.paged_decode_attention(*args),
                        att.paged_decode_attention(*args), f"decode {tag}")
        qf = torch.randn(77, h, d, generator=gen, device="cuda").to(torch.bfloat16)
        kf = torch.randn(160, kvh, d, generator=gen, device="cuda").to(torch.bfloat16)
        vf = torch.randn(160, kvh, d, generator=gen, device="cuda").to(torch.bfloat16)
        scales = {}
        if int8:
            (kf, ks), (vf, vs) = int8_context(torch, kf), int8_context(torch, vf)
            scales = {"k_scales": ks, "v_scales": vs}
        fargs = (qf, kf, vf, 70, 147)
        worst = max(worst, compare(torch, cuda_prefill.flash_extend_attention(*fargs, **scales),
                                   cuda_prefill.flash_extend_reference(*fargs, **scales),
                                   f"flash_extend {tag}"))
        qu = torch.randn(50, h, d, generator=gen, device="cuda").to(torch.bfloat16)
        uargs = (qu, kc, vc, tables, torch.tensor([0, 40, 45], **i32),
                 torch.tensor([1, 3, 5], **i32), torch.tensor(lens, **i32))
        worst = max(worst, compare(torch, cuda_unified.ragged_paged_attention(*uargs),
                                   att.ragged_paged_attention(*uargs), f"unified {tag}"))
        out[tag] = worst
    return out


# block-copy checks: a Llama-3-8B layer cache of this many pages, moved M
# pages at a time for each M (random distinct ids); the last M is timed
COPY_PAGES = 2048
COPY_MS = (1, 37, 256)


def check_block_copy(torch, gen, timer):
    """gather / scatter / copy against their plain versions, BIT-exact, on
    a [2048, 16, 8, 128] bf16 layer cache and on its int8 pair (payload +
    [2048, 8] f32 scales, each alone and as the pair wrappers move them) at
    M = 1, 37 and 256. Times (M = 256) are taken on the int8 pair, which
    the pair wrappers move in ONE launch (asserted); the bf16 page times
    ride along under ``bf16_ms``."""
    from dynamo_tpu_torch.ops import block_copy as bc
    from dynamo_tpu_torch.ops.quant import QuantizedKV

    dev = "cuda"
    bf16 = torch.randn(COPY_PAGES, BS, KVH, D, generator=gen, device=dev).to(torch.bfloat16)
    pair = quantized(torch, bf16)
    rng = np.random.default_rng(5)

    def ids(*arrays, device=dev):
        return [torch.as_tensor(a.astype(np.int32), device=device) for a in arrays]

    def exact(got, want, name):
        if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel result is not bit-equal to its plain version")

    def parts(cache):
        return [cache] if isinstance(cache, torch.Tensor) else [cache.data, cache.scale]

    for M in COPY_MS:
        perm = rng.permutation(COPY_PAGES)
        # copy_blocks checks src/dst disjointness on the host: CPU ids
        (take,), (src, dst) = ids(perm[:M]), ids(perm[M:2 * M], perm[2 * M:3 * M], device="cpu")
        for label, cache in (("bf16", bf16), ("int8 payload+scales", pair)):
            for c in parts(cache):
                tag = f"M={M} {label} {tuple(c.shape)}"
                exact(bc.gather_blocks(c, take), bc.gather_blocks_ref(c, take), "gather " + tag)
                blocks = torch.randn(M, *c.shape[1:], generator=gen, device=dev).to(c.dtype)
                exact(bc.scatter_blocks(c.clone(), take, blocks),
                      bc.scatter_blocks_ref(c.clone(), take, blocks), "scatter " + tag)
                exact(bc.copy_blocks(c.clone(), src, dst),
                      bc.copy_blocks_ref(c.clone(), src, dst), "copy " + tag)
        tag = f"M={M} int8 pair"
        got = bc.gather_blocks_quant(pair, take)
        exact(got.data, bc.gather_blocks_ref(pair.data, take), "gather_blocks_quant " + tag)
        exact(got.scale, bc.gather_blocks_ref(pair.scale, take), "gather_blocks_quant " + tag)
        blocks = QuantizedKV(torch.randint(-127, 128, got.data.shape, generator=gen, device=dev,
                                           dtype=torch.int8),
                             torch.rand(got.scale.shape, generator=gen, device=dev))
        work = QuantizedKV(pair.data.clone(), pair.scale.clone())
        bc.scatter_blocks_quant(work, take, blocks)
        exact(work.data, bc.scatter_blocks_ref(pair.data.clone(), take, blocks.data),
              "scatter_blocks_quant " + tag)
        exact(work.scale, bc.scatter_blocks_ref(pair.scale.clone(), take, blocks.scale),
              "scatter_blocks_quant " + tag)
    M = COPY_MS[-1]
    perm = rng.permutation(COPY_PAGES)
    (take,), (src, dst) = ids(perm[:M]), ids(perm[M:2 * M], perm[2 * M:3 * M], device="cpu")
    before = (bc.GATHER.launches, bc.SCATTER.launches)
    pages = bc.gather_blocks_quant(pair, take)
    bc.scatter_blocks_quant(QuantizedKV(pair.data.clone(), pair.scale.clone()), take, pages)
    if (bc.GATHER.launches - before[0], bc.SCATTER.launches - before[1]) != (1, 1):
        raise AssertionError("the int8 pair's gather and scatter must be one launch each")
    bf16_pages = bc.gather_blocks(bf16, take)
    # each page read once and written once (int8 pages + their scale rows),
    # the int32 ids read once per array (copy reads two id lists)
    moved = 2 * M * (BS * KVH * D + 4 * KVH)
    b, by = bound(moved + 2 * 4 * M, 0)
    b_copy, _ = bound(moved + 2 * 2 * 4 * M, 0)
    common = {"route": "cuda", "source": "dynamo_tpu_torch/csrc/block_copy.cu",
              "bound_ms": b, "bound_by": by, "max_abs_err": 0.0,
              "shape": f"M={M} of {COPY_PAGES} pages: int8 [{BS},{KVH},{D}] + f32 [{KVH}] "
                       f"(payload and scales in one launch); also bit-checked at "
                       f"M={list(COPY_MS)} on bf16 pages and on the int8 pair"}

    # copy_blocks checks src/dst disjointness on the host and uploads the
    # ids before it launches: keep the GPU busy long enough to cover that
    slow_host = 2_000_000

    def copy_pair(c):
        bc.copy_blocks(c.data, src, dst)
        bc.copy_blocks(c.scale, src, dst)

    def copy_ref(c):
        bc.copy_blocks_ref(c.data, src, dst)
        bc.copy_blocks_ref(c.scale, src, dst)

    work = QuantizedKV(pair.data.clone(), pair.scale.clone())
    # PyTorch's index ops take int64 ids
    take_l, src_l, dst_l = take.long(), src.to(dev).long(), dst.to(dev).long()
    return [
        dict(common, name="gather_blocks", replaces="dynamo_tpu/ops/block_copy.py:30",
             ms=timer(lambda: bc.gather_blocks_quant(pair, take)),
             plain_ms=timer(lambda: (bc.gather_blocks_ref(pair.data, take),
                                     bc.gather_blocks_ref(pair.scale, take))),
             library_ms=timer(lambda: (torch.index_select(pair.data, 0, take_l),
                                       torch.index_select(pair.scale, 0, take_l))),
             library="torch.index_select (payload, scales)",
             bf16_ms=timer(lambda: bc.gather_blocks(bf16, take))),
        dict(common, name="scatter_blocks", replaces="dynamo_tpu/ops/block_copy.py:65",
             ms=timer(lambda: bc.scatter_blocks_quant(work, take, pages)),
             plain_ms=timer(lambda: (bc.scatter_blocks_ref(work.data, take, pages.data),
                                     bc.scatter_blocks_ref(work.scale, take, pages.scale))),
             library_ms=timer(lambda: (work.data.index_copy_(0, take_l, pages.data),
                                       work.scale.index_copy_(0, take_l, pages.scale))),
             library="Tensor.index_copy_ (payload, scales)",
             bf16_ms=timer(lambda: bc.scatter_blocks(bf16, take, bf16_pages))),
        dict(common, name="copy_blocks", replaces="dynamo_tpu/ops/block_copy.py:110",
             bound_ms=b_copy,
             ms=timer(lambda: copy_pair(work), busy=slow_host),
             plain_ms=timer(lambda: copy_ref(work), busy=slow_host),
             library_ms=timer(lambda: (
                 work.data.index_copy_(0, dst_l, work.data.index_select(0, src_l)),
                 work.scale.index_copy_(0, dst_l, work.scale.index_select(0, src_l)))),
             library="Tensor.index_copy_ of index_select (payload, scales)",
             bf16_ms=timer(lambda: bc.copy_blocks(bf16, src, dst), busy=slow_host)),
    ]


# layer-batched page moves: 32 Llama-3-8B layer caches of the int8 + KVBM
# serving run's device pool, moved LAYER_MS pages at a time
LAYER_PAGES = 512
LAYER_MS = (8, 256)


def check_layer_moves(torch, gen, timer):
    """gather_layers / scatter_layers (every layer's K and V pages, and the
    int8 scale rows, in ONE launch, in the [n, L, 2, ...] host layout)
    against their plain versions, BIT-exact, on 32 Llama-3-8B layer caches
    of LAYER_PAGES pages, bf16 and the int8 pair, at each LAYER_MS;
    timed at each M with their byte bound. One launch per call is
    asserted. No single PyTorch call does the same move: library_ms null."""
    from dynamo_tpu_torch.ops import block_copy as bc
    from dynamo_tpu_torch.ops.quant import QuantizedKV

    dev, L = "cuda", 32
    rng = np.random.default_rng(9)
    bf16 = [[torch.randn(LAYER_PAGES, BS, KVH, D, generator=gen, device=dev).to(torch.bfloat16)
             for _ in range(L)] for _ in range(2)]
    int8 = [[quantized(torch, c) for c in kv] for kv in bf16]

    def exact(got, want, name):
        for g, w in (zip([got.data, got.scale], [want.data, want.scale])
                     if isinstance(got, QuantizedKV) else [(got, want)]):
            if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"{name}: kernel result is not bit-equal to its plain "
                                     "version")

    def clone(caches):
        return [c.clone() if isinstance(c, torch.Tensor)
                else QuantizedKV(c.data.clone(), c.scale.clone()) for c in caches]

    out = {}
    for label, (kcs, vcs) in (("bf16", bf16), ("int8 pair", int8)):
        for M in LAYER_MS:
            ids = torch.as_tensor(rng.permutation(LAYER_PAGES)[:M].astype(np.int32), device=dev)
            tag = f"M={M} {label}, {L} layers"
            launches = (bc.GATHER.launches, bc.SCATTER.launches)
            got = bc.gather_layers(kcs, vcs, ids)
            exact(got, bc.gather_layers_ref(kcs, vcs, ids), "gather_layers " + tag)
            # scatter pages other than the gathered ones' own, into clones
            pages = bc.gather_layers_ref(kcs, vcs, ids.flip(0))
            k2, v2, k3, v3 = clone(kcs), clone(vcs), clone(kcs), clone(vcs)
            bc.scatter_layers(k2, v2, ids, pages)
            bc.scatter_layers_ref(k3, v3, ids, pages)
            for a, b in zip(k2 + v2, k3 + v3):
                exact(a, b, "scatter_layers " + tag)
            del k2, v2, k3, v3
            if (bc.GATHER.launches - launches[0],
                    bc.SCATTER.launches - launches[1]) != (1, 1):
                raise AssertionError(f"{tag}: gather_layers / scatter_layers must be one "
                                     "launch each")
            page = BS * KVH * D * (1 if label == "int8 pair" else 2)
            page += 4 * KVH if label == "int8 pair" else 0
            b, by = bound(2 * M * L * 2 * page + 4 * M, 0)
            for name, fn, ref in (
                    ("gather_layers", lambda: bc.gather_layers(kcs, vcs, ids),
                     lambda: bc.gather_layers_ref(kcs, vcs, ids)),
                    ("scatter_layers", lambda: bc.scatter_layers(kcs, vcs, ids, got),
                     lambda: bc.scatter_layers_ref(kcs, vcs, ids, got))):
                r = out.setdefault((name, label), {"cases": {}})
                # (the busy wait covers the host's work before the launch)
                r["cases"][M] = {"ms": timer(fn, busy=2_000_000),
                                 "plain_ms": timer(ref, reps=5, busy=2_000_000),
                                 "bound_ms": b, "bound_by": by}
                c = r["cases"][M]
                log(f"  {name} {tag}: bit-exact, one launch; {c['ms']:.4f} ms kernel, "
                    f"{c['plain_ms']:.4f} ms plain, bound {b:.4f} ms ({by}), "
                    f"{b / c['ms'] * HBM_BYTES_S / 1e12:.2f} TB/s")
    results = []
    for name, line in (("gather_layers", 30), ("scatter_layers", 65)):
        main = out[(name, "int8 pair")]["cases"][LAYER_MS[-1]]
        results.append({
            "name": name, "route": "cuda", "source": "dynamo_tpu_torch/csrc/block_copy.cu",
            "replaces": f"dynamo_tpu/ops/block_copy.py:{line}",
            "shape": f"{L} layers x K/V of [{LAYER_PAGES}, {BS}, {KVH}, {D}]; top-level: the "
                     f"int8 pair (payload + f32 [{KVH}] scales) at M={LAYER_MS[-1]}, one "
                     "launch; every (form, M) under 'cases'",
            "max_abs_err": 0.0, "library_ms": None,
            "library": "none (no single PyTorch call moves every layer's pages)",
            **main,
            "cases": {f"{label} M={M}": c for (n, label), r in out.items() if n == name
                      for M, c in r["cases"].items()},
        })
    return results


def time_kv_writes(torch, gen, timer) -> dict:
    """One layer's decode KV write (ops.attention.write_decode_kv, plain
    PyTorch, no kernel of its own) for a batch of 8 rows on a Llama-3-8B
    layer cache, bf16 against int8 (the int8 write re-quantizes each row's
    whole block): a layer cost the int8 decode step pays 32 times."""
    from dynamo_tpu_torch.ops import attention as att

    B, nb = 8, 512
    kc, vc, _ = paged_case(torch, gen, [1], num_blocks=nb)
    qk, qv = quantized(torch, kc), quantized(torch, vc)
    k = torch.randn(B, KVH, D, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, KVH, D, generator=gen, device="cuda").to(torch.bfloat16)
    blocks = torch.arange(1, B + 1, device="cuda") * 7
    offs = torch.arange(B, device="cuda") % BS + 1
    return {"bf16_ms": timer(lambda: att.write_decode_kv(kc, vc, k, v, blocks, offs)),
            "int8_ms": timer(lambda: att.write_decode_kv(qk, qv, k, v, blocks, offs))}


# ------------------------------------------------------------- phase 3
def attention_paths(torch, table, int8=False):
    """The model check's attention paths by name, each a (prefill, decode,
    ragged) triple of ``(q, k_cache, v_cache, total_len) -> out`` on one
    sequence whose pages are ``table``: the kernels, the plain versions,
    and the deliberately wrong attentions the check must tell apart. With
    ``int8`` the caches are ``QuantizedKV`` and the kernels are the int8
    forms (the plain versions read the dequantized cache)."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_attention, cuda_prefill, cuda_unified
    from dynamo_tpu_torch.ops.quant import QuantizedKV

    i32 = dict(dtype=torch.int32, device=table.device)

    def one(n):
        return torch.tensor([n], **i32)

    def ctx(kc, vc, total):
        return att.gather_kv(kc, vc, table[: -(-total // BS)])

    def ragged_args(q, kc, vc, total):
        return q, kc, vc, table[None], one(0), one(q.shape[0]), one(total)

    def plain_prefill(q, kc, vc, total, start=0):
        return cuda_prefill.flash_extend_reference(q, *ctx(kc, vc, total), start, total)

    def plain_decode(q, kc, vc, total):
        return att.paged_decode_attention(
            q.reshape(1, H, D), kc, vc, table[None], one(total)).reshape(q.shape)

    def plain_ragged(q, kc, vc, total):
        return att.ragged_paged_attention(*ragged_args(q, kc, vc, total))

    def kernel_prefill(q, kc, vc, total):
        if not int8:
            return cuda_prefill.flash_extend_attention(q, *ctx(kc, vc, total), 0, total)
        kq, vq, ks, vs = att.gather_kv_quant(kc, vc, table[: -(-total // BS)])
        return cuda_prefill.flash_extend_attention(q, kq, vq, 0, total,
                                                   k_scales=ks, v_scales=vs)

    def roll(c):
        if int8:
            return QuantizedKV(c.data.roll(1, dims=2), c.scale.roll(1, dims=1))
        return c.roll(1, dims=2)

    def rotated(fn):
        # query-head group i reads kv head i+1: a wrong GQA map
        return lambda q, kc, vc, total: fn(q, roll(kc), roll(vc), total)

    def no_mask(q, kc, vc, total):
        # every query sees all `total` keys
        return plain_prefill(q, kc, vc, total, start=total - 1)

    return {
        "kernels": (
            kernel_prefill,
            lambda q, kc, vc, total: cuda_attention.paged_decode_attention(
                q.reshape(1, H, D), kc, vc, table[None], one(total),
                max_seq_len=total).reshape(q.shape),
            lambda q, kc, vc, total: cuda_unified.ragged_paged_attention(
                *ragged_args(q, kc, vc, total), max_q_len=q.shape[0]),
        ),
        "plain": (plain_prefill, plain_decode, plain_ragged),
        "mutant: no causal mask": (no_mask, plain_decode, no_mask),
        "mutant: each query's own key dropped": (
            lambda q, kc, vc, total: plain_prefill(q, kc, vc, total, start=-1),
            lambda q, kc, vc, total: plain_decode(q, kc, vc, total - 1),
            lambda q, kc, vc, total: plain_ragged(q, kc, vc, total - 1),
        ),
        "mutant: kv heads rotated": tuple(
            rotated(f) for f in (plain_prefill, plain_decode, plain_ragged)),
    }


# the wrong attentions the model check must catch: each one's reading must
# exceed MODEL_REL_TOL on every seed
MODEL_MUTANTS = ("mutant: no causal mask", "mutant: each query's own key dropped",
                 "mutant: kv heads rotated")


def model_logits(torch, cfg, params, paths, prompt, extra, int8=False):
    """Last-position logits [1, V] (f32) of a prefill, 3 decode steps and a
    2-token ragged step, through each path's attention, per path; the
    model's layers hand their attention attributes (gemma: window,
    softcap; gpt-oss: window, sinks) to the path. The plain paths of an
    expert family run its plain expert loop. With ``int8`` the caches are int8 and written as
    the engine writes them: the prefill quantizes whole blocks (pad rows
    zero), later tokens requantize their block one row at a time."""
    from dynamo_tpu_torch.models import registry
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops.quant import QuantizedKV

    forward, lm_logits = registry.forward_fn(cfg), registry.lm_logits_fn(cfg)
    if registry.is_gptoss(cfg):
        from dynamo_tpu_torch.models import gptoss

        # the kernel path runs the engine's grouped expert products, the
        # plain paths the plain expert loop
        plain_forward = functools.partial(forward, expert_fn=gptoss.experts_plain)
    elif registry.is_moe(cfg) or registry.is_mla(cfg):
        from dynamo_tpu_torch.models import moe

        plain_forward = functools.partial(forward, expert_fn=moe.experts_plain)
    else:
        plain_forward = forward
    dev = params["embed"].device
    pages = -(-(len(prompt) + len(extra)) // BS) + 1
    nb = pages + 3
    table = torch.arange(3, 3 + pages, dtype=torch.int32, device=dev)
    n = len(prompt)
    logits = {}
    for name, (prefill, decode, ragged) in paths(table).items():
        fwd = forward if name == "kernels" else plain_forward
        shape = (nb, BS, cfg.num_kv_heads, cfg.head_dim)

        def cache():
            if int8:
                return QuantizedKV(torch.zeros(shape, dtype=torch.int8, device=dev),
                                   torch.zeros(shape[0], shape[2], device=dev))
            return torch.zeros(shape, dtype=cfg.dtype, device=dev)

        kcs = [cache() for _ in range(cfg.num_layers)]
        vcs = [cache() for _ in range(cfg.num_layers)]

        def run(tokens, start, attn):
            pos = torch.arange(start, start + len(tokens), device=dev)
            blocks, offs = table[pos // BS], pos % BS

            def write_int8(kc, vc, k, v):
                if start == 0:
                    pad = -len(tokens) % BS
                    k, v = (torch.cat([x, x.new_zeros(pad, *x.shape[1:])]) for x in (k, v))
                    att.write_prefill_kv(kc, vc, k, v, table[: k.shape[0] // BS])
                    return
                for j in range(len(tokens)):
                    att.write_decode_kv(kc, vc, k[j:j + 1], v[j:j + 1],
                                        blocks[j:j + 1], offs[j:j + 1])

            def attend(q, k, v, i, **attrs):
                k, v = k.reshape(-1, *k.shape[-2:]), v.reshape(-1, *v.shape[-2:])
                if int8:
                    write_int8(kcs[i], vcs[i], k, v)
                else:
                    att.write_decode_kv(kcs[i], vcs[i], k, v, blocks, offs)
                return attn(q, kcs[i], vcs[i], start + len(tokens), **attrs)

            hidden = fwd(params, cfg, torch.as_tensor(tokens, device=dev), pos, attend)
            return lm_logits(params, cfg, hidden.reshape(-1, cfg.hidden_size)[-1:]).float()

        with torch.inference_mode():
            out = [run(prompt, 0, prefill)]
            out += [run(extra[j:j + 1], n + j, decode) for j in range(3)]
            out.append(run(extra[3:5], n + 3, ragged))
        logits[name] = out
    return logits


def model_check(torch, tag, cfg, prompt_len, seed_base, weight_sets, paths, int8=False):
    """``cfg`` at full width and its configured depth, per seed in
    MODEL_SEEDS: the kernel path's logits against the plain path's at every
    step, and the same reading for each mutant. ``weight_sets``: (adjust,
    the mutants read on those weights) pairs, ``adjust(cfg, params, rng)``
    changing the seed's random weights in place (None: as drawn); the
    kernel path is read on every set. ``paths(table, mutants)`` gives the
    attention paths; ``int8`` runs on int8 caches. Every mutant's reading
    must exceed MODEL_REL_TOL on every seed. Returns (worst kernel reading,
    least reading of each mutant over the seeds, max |logit|)."""
    from dynamo_tpu_torch.models import registry

    dev = torch.device("cuda")
    readings: dict = {}
    spread = 0.0
    for seed in MODEL_SEEDS:
        rng = np.random.default_rng(seed_base + seed)
        prompt = rng.integers(0, cfg.vocab_size, size=prompt_len)
        extra = rng.integers(0, cfg.vocab_size, size=5)   # 3 decode tokens + a 2-token step
        for adjust, mutants in weight_sets:
            params = registry.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
            if adjust is not None:
                adjust(cfg, params, rng)
            logits = model_logits(torch, cfg, params, lambda t: paths(t, mutants),
                                  prompt, extra, int8)
            plain = logits.pop("plain")
            spread = max(spread, max(b.abs().max().item() for b in plain))
            for name, got in logits.items():
                if name == "kernels" and not all(torch.isfinite(a).all() for a in got):
                    raise AssertionError(f"{tag} seed {seed}: kernel logits not finite")
                rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(got, plain))
                readings.setdefault(name, []).append(rel)
            del params, logits, plain
            torch.cuda.empty_cache()
    for name, rels in readings.items():
        log(f"{tag}: {name}: relative L2 of last-position logits vs plain, worst step per "
            f"seed {MODEL_SEEDS}" + (" and weight set" if len(weight_sets) > 1 else "")
            + ": " + ", ".join(f"{r:.4g}" for r in rels))
    worst = max(readings["kernels"])
    if worst > MODEL_REL_TOL:
        raise AssertionError(f"{tag}: kernel logits differ from plain by {worst:.4g} "
                             f"relative L2 (limit {MODEL_REL_TOL})")
    for name in readings:
        if name != "kernels" and min(readings[name]) <= MODEL_REL_TOL:
            raise AssertionError(f"{tag}: the check cannot tell {name} from the plain "
                                 f"path ({min(readings[name]):.4g} <= {MODEL_REL_TOL})")
    return worst, {n: min(r) for n, r in readings.items() if n != "kernels"}, spread


def unified_attention_paths(torch, table, mutants):
    """The Gemma and gpt-oss model checks' attention paths: every step
    (prefill, decode, ragged) is one row of the unified kernel, as the
    engine serves such a layer, or of its plain version, with the layer's
    attributes (window, softcap, sinks); ``mutants`` names the wrong
    attentions to add (ATTR_MUTANTS)."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_unified

    i32 = dict(dtype=torch.int32, device=table.device)

    def row(q, kc, vc, total):
        one = [torch.tensor([n], **i32) for n in (0, q.shape[0], total)]
        return (q, kc, vc, table[None], *one)

    def kernel(q, kc, vc, total, window=None, **attrs):
        if window:   # the kernel's form: an [R] windows array
            attrs["windows"] = torch.tensor([window], **i32)
        return cuda_unified.ragged_paged_attention(*row(q, kc, vc, total),
                                                   max_q_len=q.shape[0], **attrs)

    def plain(q, kc, vc, total, **attrs):
        return att.ragged_paged_attention(*row(q, kc, vc, total), **attrs)

    def wrong(change):
        fn = lambda q, kc, vc, total, **attrs: plain(q, kc, vc, total, **change(attrs))
        return (fn, fn, fn)

    paths = {"kernels": (kernel,) * 3, "plain": (plain,) * 3}
    for name in mutants:
        paths[name] = wrong(ATTR_MUTANTS[name])
    return paths


def _drop(key):
    return lambda attrs: dict(attrs, **{key: None})


def _window_plus(n):
    def change(attrs):
        w = attrs.get("window")
        return dict(attrs, window=None if w is None else w + n)
    return change


# the wrong attentions the Gemma and gpt-oss model checks must catch
ATTR_MUTANTS = {
    "mutant: window dropped": _drop("window"),
    "mutant: window one page too wide": _window_plus(BS),
    "mutant: softcap dropped": _drop("softcap"),
    "mutant: sinks dropped": _drop("sinks"),
    "mutant: window one key too wide": _window_plus(1),
}
# (preset, layers, prompt tokens): gemma2-2b's first two layers (sliding,
# full) over a prompt 1.5 windows long; gemma3-4b's first six (five sliding,
# one full) over a prompt ~2 windows long
GEMMA_MODEL_CHECKS = (("gemma2_2b", 2, 6000), ("gemma3_4b", 6, 2000))
# q/k projection scale of the softcap mutant's weights: at the published
# init the attention logits are ~N(0, 1), where a cap of 50 changes nothing
# measurable; x2 on both makes them ~N(0, 16), where it bends the largest
GEMMA_SHARP_QK = 2.0


def gemma_model_check(torch, preset, num_layers, prompt_len):
    """model_check for ``preset`` cut to ``num_layers``. Weights at the
    published init scale (attention broad: a window edge moves the output
    most) carry the window mutants; with a softcap, the same weights with
    q/k projections x GEMMA_SHARP_QK carry the softcap mutant."""
    from dynamo_tpu_torch.models import gemma

    cfg = dataclasses.replace(getattr(gemma.GemmaConfig, preset)(), num_layers=num_layers)
    sets = [(None, ("mutant: window dropped", "mutant: window one page too wide"))]
    if cfg.attn_logit_softcap:
        sets.append((sharpen_qk(GEMMA_SHARP_QK), ("mutant: softcap dropped",)))
    return model_check(torch, f"model {preset} x{num_layers} layers", cfg, prompt_len, 200,
                       sets, lambda t, mutants: unified_attention_paths(torch, t, mutants))


def sharpen_qk(factor):
    """A model check's weight adjustment: q/k projections times
    ``factor`` (with per-head q/k norms, gemma's, the norms' 1 + w)."""
    def adjust(cfg, params, rng):
        for lp in params["layers"]:
            if cfg.qk_norm:
                lp["q_norm"] += factor - 1.0
                lp["k_norm"] += factor - 1.0
            else:
                lp["wq"] *= factor
                lp["wk"] *= factor
    return adjust


# gpt-oss-20b cut to its first two layers (sliding, full) over a prompt of
# 1500 tokens, ~12 windows
GPTOSS_MODEL_CHECK = (2, 1500)
# the router bias that pins each layer's top 4 (GPTOSS_ROUTER_MARGIN above
# the others' init logits, ~N(0, 1)): a token whose 4th and 5th router
# logits lie closer than the two paths' bf16 rounding would take other
# experts on each path, a jump of the function that is no kernel's error
GPTOSS_ROUTER_MARGIN = 12.0
# sinks of the sink mutant's weights: at the init scale a window's 128 keys
# hold a softmax mass of ~128 * e^1.6 ~ e^6.5, so a sink near 6 takes a
# large share of a sliding layer's attention
GPTOSS_SINK_MEAN = 6.0
# the window mutant's weights: on sliding layers q and k are their biases
# alone, one rotary pair at the frequency w nearest pi / (2 * window), so
# that score(p, j) = -c^2 f^2 cos(w (p - j)) / sqrt(d) rises with the key's
# age across the window, by GPTOSS_EDGE_STEP between its two oldest keys
# (f: the YaRN attention factor): each query attends mostly to the oldest
# keys it sees, and one key more moves it to another token's value
GPTOSS_EDGE_STEP = 3.0


def gptoss_pin_router(cfg, params, rng):
    for lp in params["layers"]:
        chosen = rng.permutation(cfg.num_experts)[:cfg.num_experts_per_tok]
        lp["b_router"][chosen.tolist()] += GPTOSS_ROUTER_MARGIN


def gptoss_sink_weights(cfg, params, rng):
    """The sink mutant's weights: pinned routers, sinks N(GPTOSS_SINK_MEAN, 1)."""
    import torch

    gptoss_pin_router(cfg, params, rng)
    for lp in params["layers"]:
        lp["sinks"].copy_(torch.as_tensor(
            GPTOSS_SINK_MEAN + rng.standard_normal(cfg.num_heads), dtype=torch.float32))


def gptoss_edge_weights(cfg, params, rng):
    """The window mutant's weights (GPTOSS_EDGE_STEP): pinned routers; on
    sliding layers q = R(p) bq, k = R(j) bk with bq = -c e_i, bk = c e_i on
    one rotary pair i, and sinks at -30 (out of the way)."""
    import math

    import torch
    from dynamo_tpu_torch.models import gptoss

    gptoss_pin_router(cfg, params, rng)
    w = cfg.sliding_window
    inv_freq, factor = gptoss.yarn_inv_freq(cfg)
    i = int((inv_freq - math.pi / (2 * w)).abs().argmin())
    omega = float(inv_freq[i])
    if not 0 < omega * w < math.pi:
        raise AssertionError(f"model gpt-oss: no rotary pair rises across the window ({omega})")
    c = math.sqrt(GPTOSS_EDGE_STEP * math.sqrt(cfg.head_dim)
                  / (factor ** 2 * omega * math.sin(omega * w)))
    for li, lp in enumerate(params["layers"]):
        if cfg.window_for_layer(li) is None:
            continue
        lp["wq"].zero_()
        lp["wk"].zero_()
        bq = lp["bq"].view(cfg.num_heads, cfg.head_dim)
        bk = lp["bk"].view(cfg.num_kv_heads, cfg.head_dim)
        bq.zero_()
        bk.zero_()
        bq[:, i] = -c
        bk[:, i] = c
        lp["sinks"].fill_(-30.0)


def gptoss_model_check(torch):
    """model_check for gpt-oss-20b cut to GPTOSS_MODEL_CHECK's layers: the
    kernel path (the unified kernel at d = 64, the grouped expert products)
    against the plain path (plain attention, the plain expert loop). The
    sink mutant reads on weights whose sinks carry mass, the one-key window
    mutant on weights whose sliding layers attend to a window's oldest keys
    (GPTOSS_EDGE_STEP); both sets pin the routers (GPTOSS_ROUTER_MARGIN)."""
    from dynamo_tpu_torch.models import gptoss

    layers, prompt_len = GPTOSS_MODEL_CHECK
    cfg = dataclasses.replace(gptoss.GptOssConfig.gpt_oss_20b(), num_layers=layers)
    sets = [(gptoss_sink_weights, ("mutant: sinks dropped",)),
            (gptoss_edge_weights, ("mutant: window one key too wide",))]
    return model_check(torch, f"model gpt-oss-20b x{layers} layers", cfg, prompt_len, 300,
                       sets, lambda t, mutants: unified_attention_paths(torch, t, mutants))


# ------------------------------------------------------------- phase 4
def kernel_counters() -> dict:
    """Every kernel wrapper's launch counter, by the report's short name."""
    from dynamo_tpu_torch.ops import block_copy as bc
    from dynamo_tpu_torch.ops import cuda_attention, cuda_mla, cuda_prefill, cuda_unified

    return {
        "latent_narrow": cuda_mla.NARROW, "latent_wide": cuda_mla.WIDE,
        "decode": cuda_attention.KERNEL, "flash_extend": cuda_prefill.KERNEL,
        "unified": cuda_unified.KERNEL, "decode_int8": cuda_attention.KERNEL_INT8,
        "flash_extend_int8": cuda_prefill.KERNEL_INT8,
        "unified_int8": cuda_unified.KERNEL_INT8, "gather": bc.GATHER,
        "scatter": bc.SCATTER, "copy": bc.COPY, "merge": cuda_unified.MERGE,
    }


def launch_counters() -> dict:
    """kernel_counters, and the unified kernel's windowed launches."""
    from dynamo_tpu_torch.ops import cuda_unified

    return {**kernel_counters(), "unified_windowed": cuda_unified.WINDOWED}


def reset_launches() -> None:
    for k in launch_counters().values():
        k.launches = k.replayed = 0


def read_launches() -> dict:
    """Launches by kernel since reset_launches, CUDA-graph replays
    included (each replay counts the launches its capture recorded), and
    under "replayed" the share of them that replays made."""
    counters = launch_counters()
    out = {name: k.launches for name, k in counters.items()}
    out["replayed"] = {name: k.replayed for name, k in counters.items()}
    return out


def device_time_by_kind(prof, n_top: int = 10) -> dict:
    """Summed device time (ms) of a CUDA-activity profile's device events
    (kernels, copies, fills), by kind, and the ``n_top`` names by time.
    Reads the profiler's raw events: ``key_averages`` builds a Python
    object for each event first, ~0.1 ms apiece."""
    from torch.autograd import DeviceType

    # (torch's own CUTLASS kernels serve torch._grouped_mm: gpt-oss's experts)
    kinds = {"decode_kernel": "paged_decode_kernel", "flash_kernel": "flash_extend_kernel",
             "unified_kernel": "unified_kernel", "merge_kernel": "merge_kernel",
             "latent_narrow": "latent_narrow", "latent_wide": "latent_wide",
             "grouped_gemm": "enable_3x_kernel_for_sm9x"}
    gemm_tags = ("gemm", "nvjet", "xmma", "cutlass", "cublas")
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            t, c = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (t + e.duration_ns() / 1e6, c + 1)
    out = dict.fromkeys(list(kinds) + ["gemm", "other"], 0.0)
    n, top = 0, []
    for name, (t, count) in by_name.items():
        if t <= 0:
            continue
        n += count
        top.append((t, count, name[:80]))
        kind = next((k for k, tag in kinds.items() if tag in name), None)
        if kind is None:
            kind = "gemm" if any(g in name.lower() for g in gemm_tags) else "other"
        out[kind] += t
    out["kernels"] = n
    out["top"] = [[name, round(t, 3), c] for t, c, name in sorted(top, reverse=True)[:n_top]]
    return out


async def serve(torch):
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.runtime import Context

    mcfg = LlamaConfig.llama3_8b()
    cfg = TorchEngineConfig(model=mcfg, num_blocks=2048, block_size=BS,
                            max_batch_size=8, max_context=4096, seed=0)
    t0 = time.perf_counter()
    engine = TorchEngine(cfg)
    torch.cuda.synchronize()
    log(f"serving: llama3-8b preset, {mcfg.num_layers} layers, random bf16 weights "
        f"(seed 0) ready in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    tok = ByteTokenizer()
    rng = np.random.default_rng(3)
    words = [bytes(rng.integers(97, 123, size=rng.integers(2, 9))).decode()
             for _ in range(4000)]
    lens = [120, 2600, 400, 1100, 3000, 180, 750, 1600, 2000, 900]
    prompts = []
    for n in lens:
        text = " ".join(words[int(i)] for i in rng.integers(0, len(words), size=n))
        prompts.append(tok.encode(text)[:n])
    max_tokens = 32
    sampled = 3   # one seeded sampled request; the rest are greedy
    # ITL is the mean gap between a request's tokens: (last arrival - first)
    # over tokens - 1, since one output carries a whole horizon's tokens
    stats = []

    async def one(i, prompt):
        await asyncio.sleep(0.25 * i)   # staggered arrivals
        samp = (SamplingOptions(temperature=0.8, top_p=0.95, seed=7) if i == sampled
                else SamplingOptions(temperature=0.0))
        req = PreprocessedRequest(request_id=f"r{i}", model="llama3-8b",
                                  token_ids=prompt, sampling=samp,
                                  stop=StopConditions(max_tokens=max_tokens))
        t_sub = time.perf_counter()
        stamps, toks, finish = [], [], None
        async for out in engine.generate(req, Context()):
            if out.token_ids:
                stamps.append(time.perf_counter())
                toks.extend(out.token_ids)
            finish = out.finish_reason or finish
        stats.append({"i": i, "prompt": len(prompt), "tokens": toks, "finish": finish,
                      "ttft_s": stamps[0] - t_sub if stamps else None,
                      "itl_s": ((stamps[-1] - stamps[0]) / (len(toks) - 1)
                                if len(stamps) > 1 else None)})

    reset_launches()
    t0 = time.perf_counter()
    try:
        await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
    finally:
        engine.stop()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for s in sorted(stats, key=lambda s: s["i"]):
        if len(s["tokens"]) != max_tokens or s["finish"] != "length":
            raise AssertionError(f"request {s['i']}: {len(s['tokens'])} tokens, "
                                 f"finish {s['finish']!r}; expected {max_tokens}, 'length'")
        if not all(0 <= t < mcfg.vocab_size for t in s["tokens"]):
            raise AssertionError(f"request {s['i']}: token id outside the vocab")
    for name in ("decode", "flash_extend", "unified"):
        if launches[name] <= 0:
            raise AssertionError(f"the {name} kernel never launched while serving")
    if engine.step_counts["mixed"] <= 0:
        raise AssertionError(f"no fused mixed step ran: {engine.step_counts}")
    ttft = sorted(s["ttft_s"] for s in stats)
    itl = sorted(s["itl_s"] for s in stats)
    n_out = sum(len(s["tokens"]) for s in stats)
    return {
        "requests": len(stats), "prompt_tokens": lens, "max_tokens": max_tokens,
        "wall_s": wall, "output_tok_s": n_out / wall,
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": ttft[-1],
        "itl_s_median": statistics.median(itl), "itl_s_max": itl[-1],
        "steps": dict(engine.step_counts), **horizon_report(engine),
        "launches": launches,
    }


# async chunk prep (engine/prep.py): two greedy prompts of several prefill
# chunks each, sent at once, on an engine with DTPU_ASYNC_PREP on and on one
# with it off
PREP_PROMPTS = (4600, 6100)
PREP_TOKENS = 16


async def serve_prep(torch, prep: bool) -> dict:
    """PREP_PROMPTS on a fresh llama3-8b engine (32 layers, the serve
    phase's weights) with async chunk prep on or off: the token streams and
    the prebuilds' StepStats (hits, build and wait seconds)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.runtime import Context

    os.environ["DTPU_ASYNC_PREP"] = "1" if prep else "0"
    try:
        engine = TorchEngine(TorchEngineConfig(
            model=LlamaConfig.llama3_8b(), num_blocks=2048, block_size=BS,
            max_batch_size=8, max_context=8192, seed=0))
    finally:
        del os.environ["DTPU_ASYNC_PREP"]
    if (engine._prep is not None) != prep:
        raise AssertionError(f"DTPU_ASYNC_PREP={int(prep)} gave prep {engine._prep}")
    steps = []
    engine.stats_hook = steps.append
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 128000, size=n).tolist() for n in PREP_PROMPTS]

    async def one(i, prompt):
        req = PreprocessedRequest(request_id=f"prep{i}", model="llama3-8b", token_ids=prompt,
                                  sampling=SamplingOptions(temperature=0.0),
                                  stop=StopConditions(max_tokens=PREP_TOKENS))
        toks = []
        async for out in engine.generate(req, Context()):
            toks.extend(out.token_ids)
        return toks

    try:
        streams = await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
    finally:
        engine.stop()
        torch.cuda.synchronize()
    chunked = [st for st in steps if st.phase in ("prefill", "mixed")]
    hits = [st for st in chunked if st.prep_hit]
    return {"streams": streams, "chunk_steps": len(chunked), "hits": len(hits),
            "misses": sum(1 for st in chunked if st.prep_hit is False),
            "build_s": [st.prep_build_s for st in hits],
            "wait_s": [st.prep_wait_s for st in hits]}


def prep_check(torch, smi: str) -> dict:
    """The serve phase's async-prep check: equal streams, prep hits > 0."""
    on = asyncio.run(serve_prep(torch, True))
    gc.collect()
    torch.cuda.empty_cache()
    off = asyncio.run(serve_prep(torch, False))
    gc.collect()
    torch.cuda.empty_cache()
    if on["streams"] != off["streams"]:
        raise AssertionError(f"async prep changed the token streams: {on['streams']} "
                             f"vs {off['streams']}")
    if any(len(t) != PREP_TOKENS for t in on["streams"]):
        raise AssertionError(f"prep streams of {[len(t) for t in on['streams']]} tokens")
    if on["hits"] <= 0 or off["hits"]:
        raise AssertionError(f"prep hits on {on['hits']}, off {off['hits']}")
    log(f"async chunk prep on {smi}: prompts {PREP_PROMPTS} (chunks of 2048) at once, "
        f"{PREP_TOKENS} greedy tokens each, streams equal with DTPU_ASYNC_PREP 1 and 0; "
        f"{on['hits']} of {on['chunk_steps']} chunk steps took a prebuild ({on['misses']} "
        f"misses); prep_build_s {sum(on['build_s']):.6f} in all (max "
        f"{max(on['build_s']):.6f}), prep_wait_s {sum(on['wait_s']):.6f} in all (max "
        f"{max(on['wait_s']):.6f})")
    return {k: v for k, v in on.items() if k != "streams"}


# int8 + KVBM serving: a device pool small enough that the churn wave evicts
# the first wave's prompt blocks, a G2 host tier large enough to hold every
# block both waves offload, and a third wave repeating three first-wave
# prompts, which then onboard from G2
KVBM_DEVICE_BLOCKS = 512
KVBM_HOST_BLOCKS = 2048
KVBM_FIRST = (2600, 1100, 3000)
KVBM_CHURN = (1600,) * 6


class ErrorLog:
    """Counts ERROR records of the port's loggers (an onboard or offload
    failure is logged, and any such record fails the run)."""

    def __init__(self):
        import logging

        self.records = []
        handler = logging.Handler(level=logging.ERROR)
        handler.emit = self.records.append
        self.logger = logging.getLogger("dynamo_tpu_torch")
        self.logger.addHandler(handler)
        self.handler = handler

    def close(self):
        self.logger.removeHandler(self.handler)


async def serve_kvbm(torch):
    """TorchEngine(kv_dtype="int8", kvbm=KvbmTiers(...)) on the llama3-8b
    preset at 32 layers: first wave, churn wave, repeat wave. Hard checks:
    token counts and finish reasons, every int8 attention kernel and the
    gather and scatter kernels launched, blocks onboarded and cached tokens
    on every repeat, an onboarded device block re-encoding bit-exactly to
    its stored G2 bytes, and no onboard or offload error."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.kvbm.layout import QuantizedBlockCodec, block_shape_for
    from dynamo_tpu_torch.kvbm.pool import KvbmTiers
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.runtime import Context
    from dynamo_tpu_torch.tokens import compute_sequence_hashes

    mcfg = LlamaConfig.llama3_8b()
    cfg = TorchEngineConfig(model=mcfg, num_blocks=KVBM_DEVICE_BLOCKS, block_size=BS,
                            max_batch_size=8, max_context=4096, seed=0, kv_dtype="int8")
    codec = QuantizedBlockCodec(block_shape_for(mcfg, BS, "int8"))
    kvbm = KvbmTiers(codec.nbytes, host_capacity_bytes=KVBM_HOST_BLOCKS * codec.nbytes)
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, kvbm=kvbm)
    torch.cuda.synchronize()
    log(f"serving int8+kvbm: llama3-8b preset, {mcfg.num_layers} layers, int8 KV "
        f"({KVBM_DEVICE_BLOCKS} device blocks), G2 host tier of {KVBM_HOST_BLOCKS} "
        f"blocks x {codec.nbytes} B, ready in {time.perf_counter() - t0:.1f} s")
    tok = ByteTokenizer()
    rng = np.random.default_rng(4)
    words = [bytes(rng.integers(97, 123, size=rng.integers(2, 9))).decode()
             for _ in range(4000)]

    def prompt(n):
        text = " ".join(words[int(i)] for i in rng.integers(0, len(words), size=n))
        return tok.encode(text)[:n]

    first = [prompt(n) for n in KVBM_FIRST]
    churn = [prompt(n) for n in KVBM_CHURN]
    max_tokens = 32
    stats = []

    async def one(tag, i, toks):
        await asyncio.sleep(0.25 * i)
        req = PreprocessedRequest(request_id=f"{tag}{i}", model="llama3-8b", token_ids=toks,
                                  sampling=SamplingOptions(temperature=0.0),
                                  stop=StopConditions(max_tokens=max_tokens))
        t_sub = time.perf_counter()
        stamps, out_toks, finish, cached = [], [], None, None
        async for out in engine.generate(req, Context()):
            if out.token_ids:
                stamps.append(time.perf_counter())
                out_toks.extend(out.token_ids)
            if "cached_tokens" in (out.annotations or {}):
                cached = out.annotations["cached_tokens"]
            finish = out.finish_reason or finish
        stats.append({"wave": tag, "i": i, "prompt": len(toks), "tokens": out_toks,
                      "finish": finish, "cached": cached,
                      "ttft_s": stamps[0] - t_sub if stamps else None,
                      "itl_s": ((stamps[-1] - stamps[0]) / (len(out_toks) - 1)
                                if len(stamps) > 1 else None)})

    async def wave(tag, prompts):
        await asyncio.gather(*(one(tag, i, p) for i, p in enumerate(prompts)))
        await engine.flush_offload()

    # offload batches and onboard calls, counted around the engine's own
    # methods: each must be one launch of the page-copy kernel
    calls = {"offload_batches": 0, "onboards": 0}

    def counted(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    engine._enqueue_offload_gather = counted("offload_batches", engine._enqueue_offload_gather)
    engine._scatter_blocks = counted("onboards", engine._scatter_blocks)
    errors = ErrorLog()
    reset_launches()
    t0 = time.perf_counter()
    try:
        await wave("first", first)
        await wave("churn", churn)
        hashes = [compute_sequence_hashes(p, BS)[: (len(p) - 1) // BS] for p in first]
        resident = [len(engine.allocator.match_prefix(h)) for h in hashes]
        await wave("repeat", first)
    finally:
        engine.stop()
        torch.cuda.synchronize()
        errors.close()
    wall = time.perf_counter() - t0
    launches = read_launches()
    kstats = kvbm.stats()
    by = {(s["wave"], s["i"]): s for s in stats}
    for s in stats:
        if len(s["tokens"]) != max_tokens or s["finish"] != "length":
            raise AssertionError(f"int8+kvbm {s['wave']} {s['i']}: {len(s['tokens'])} "
                                 f"tokens, finish {s['finish']!r}")
    for name in ("decode_int8", "flash_extend_int8", "unified_int8", "gather", "scatter"):
        if launches[name] <= 0:
            raise AssertionError(f"int8+kvbm: the {name} kernel never launched: {launches}")
    if (launches["gather"], launches["scatter"]) != (calls["offload_batches"], calls["onboards"]):
        raise AssertionError(f"int8+kvbm: {launches['gather']} gather launches for "
                             f"{calls['offload_batches']} offload batches, "
                             f"{launches['scatter']} scatter launches for "
                             f"{calls['onboards']} onboards")
    if errors.records or engine.offload_errors or kstats["errors"]:
        raise AssertionError(
            f"int8+kvbm: {len(errors.records)} error records, {engine.offload_errors} offload "
            f"errors, {kstats['errors']} tier errors: "
            + "; ".join(r.getMessage() for r in errors.records[:3]))
    if kstats["onboarded"] <= 0:
        raise AssertionError(f"int8+kvbm: no block onboarded from the tiers: {kstats}")
    for i in range(len(first)):
        if not by[("repeat", i)]["cached"]:
            raise AssertionError(f"int8+kvbm: repeat {i} reused no cached tokens")
    # an onboarded block (the first that was not on the device before the
    # repeat wave) re-encodes bit-exactly to its stored G2 bytes
    h = hashes[0][resident[0]]
    stored = kvbm.host.get(h)
    (bid,) = engine.allocator.match_prefix([h])
    pay = np.empty(codec.payload_shape, np.int8)
    scl = np.empty(codec.scales_shape, np.float32)
    for li, (kc, vc) in enumerate(zip(engine.k_caches, engine.v_caches)):
        pay[li, 0], pay[li, 1] = kc.data[bid].cpu().numpy(), vc.data[bid].cpu().numpy()
        scl[li, 0], scl[li, 1] = kc.scale[bid].cpu().numpy(), vc.scale[bid].cpu().numpy()
    if stored is None or not np.array_equal(codec.encode(pay, scl), stored):
        raise AssertionError("int8+kvbm: an onboarded block differs from its stored G2 bytes")
    same = sum(by[("repeat", i)]["tokens"] == by[("first", i)]["tokens"]
               for i in range(len(first)))
    ttft = sorted(s["ttft_s"] for s in stats)
    itl = sorted(s["itl_s"] for s in stats)
    return {
        "requests": len(stats), "waves": {"first": list(KVBM_FIRST),
                                          "churn": list(KVBM_CHURN), "repeat": list(KVBM_FIRST)},
        "max_tokens": max_tokens, "wall_s": wall,
        "output_tok_s": sum(len(s["tokens"]) for s in stats) / wall,
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": ttft[-1],
        "itl_s_median": statistics.median(itl), "itl_s_max": itl[-1],
        "repeat_ttft_s": [by[("repeat", i)]["ttft_s"] for i in range(len(first))],
        "first_ttft_s": [by[("first", i)]["ttft_s"] for i in range(len(first))],
        "repeat_cached_tokens": [by[("repeat", i)]["cached"] for i in range(len(first))],
        "resident_blocks_before_repeat": resident,
        "repeats_streaming_the_same_greedy_tokens": f"{same} of {len(first)}",
        "kvbm": kstats, "steps": dict(engine.step_counts), **horizon_report(engine), "launches": launches,
        **calls, "onboarded_block_bit_exact": True,
    }


# Gemma serving: gemma2-2b at full depth and max_context 8192, prompts up to
# ~2 windows long; the int8 run is shorter (its kernel's path check)
GEMMA_INT8_PROMPTS = (4100, 1500, 300)
# their tokens each: enough that each request still decodes when the next
# arrives 0.25 s later, so that its chunks run as fused mixed steps (16
# left 0-2 mixed steps, and none on a fast host)
GEMMA_INT8_TOKENS = 64
GEMMA_BLOCKS = 4096


async def serve_gemma(torch, int8=False, split_rows=False):
    """serve_windowed on the gemma2-2b preset (26 layers, random bf16
    weights from seed 0, max_context 8192): GEMMA_PROMPTS with 32 tokens
    each, or with ``int8`` GEMMA_INT8_PROMPTS with GEMMA_INT8_TOKENS."""
    from dynamo_tpu_torch.models.gemma import GemmaConfig

    return await serve_windowed(
        torch, GemmaConfig.gemma2_2b(), "gemma", GEMMA_INT8_PROMPTS if int8 else GEMMA_PROMPTS,
        GEMMA_INT8_TOKENS if int8 else 32, int8=int8, prompt_seed=6,
        sample_seed=11, split_rows=split_rows)


async def serve_windowed(torch, mcfg, tag, lens, max_tokens, int8=False, params=None,
                         prompt_seed=6, sample_seed=11, expect=None, forbid=None,
                         split_module=None, split_rows=False):
    """TorchEngine on ``mcfg``, a family whose every layer goes through the
    unified kernel (gemma, gpt-oss), on its defaults (GEMMA_BLOCKS device
    blocks, max_context 8192, batch 8; random bf16 weights from seed 0, or
    ``params``): prompts of ``lens`` tokens arriving 0.25 s apart,
    ``max_tokens`` each, request 2 seeded sampled and the rest greedy.
    Hard checks: token counts and finish reasons, fused mixed steps ran,
    the unified kernel (the int8 form with ``int8``) served windowed
    launches, and neither the decode nor the flash-extend kernel launched.
    Another family names the counters that must have launched
    (``expect``), those that must not (``forbid``) and the wrapper module
    whose split log ``split_rows`` reads (``split_module``).
    Reports TTFT, ITL, tok/s, steps, the horizon's graphs, launches by
    kernel (replays counted) and the peak of allocated device memory.
    ``split_rows``: also the rows the kernel split by its own count (it
    must split some: decode rows of thousands of keys); logging them costs
    host time in the run."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.ops import cuda_unified
    from dynamo_tpu_torch.runtime import Context

    unified = "unified_int8" if int8 else "unified"
    expect = expect or (unified, "unified_windowed")
    if forbid is None:
        forbid = ("decode", "flash_extend", "decode_int8", "flash_extend_int8")
    split_module = split_module or cuda_unified
    cfg = TorchEngineConfig(model=mcfg, num_blocks=GEMMA_BLOCKS, block_size=BS,
                            max_batch_size=8, max_context=8192, seed=0,
                            kv_dtype="int8" if int8 else "model")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, params=params)
    torch.cuda.synchronize()
    if int8:
        tag += " int8"
    log(f"serving {tag}: {mcfg.num_layers} layers, random bf16 weights (seed 0), "
        f"{GEMMA_BLOCKS} device blocks, ready in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    tok = ByteTokenizer()
    rng = np.random.default_rng(prompt_seed)
    words = [bytes(rng.integers(97, 123, size=rng.integers(2, 9))).decode()
             for _ in range(4000)]
    prompts = []
    for n in lens:
        text = " ".join(words[int(i)] for i in rng.integers(0, len(words), size=n))
        prompts.append(tok.encode(text)[:n])
    sampled = 2   # one seeded sampled request; the rest are greedy
    stats = []

    async def one(i, prompt):
        await asyncio.sleep(0.25 * i)
        samp = (SamplingOptions(temperature=0.8, top_p=0.95, seed=sample_seed) if i == sampled
                else SamplingOptions(temperature=0.0))
        req = PreprocessedRequest(request_id=f"g{i}", model=tag, token_ids=prompt,
                                  sampling=samp, stop=StopConditions(max_tokens=max_tokens))
        t_sub = time.perf_counter()
        stamps, toks, finish = [], [], None
        async for out in engine.generate(req, Context()):
            if out.token_ids:
                stamps.append(time.perf_counter())
                toks.extend(out.token_ids)
            finish = out.finish_reason or finish
        stats.append({"i": i, "tokens": toks, "finish": finish,
                      "ttft_s": stamps[0] - t_sub if stamps else None,
                      "itl_s": ((stamps[-1] - stamps[0]) / (len(toks) - 1)
                                if len(stamps) > 1 else None)})

    reset_launches()
    # the kernel's own split counts of every launch (logging them costs
    # host time)
    split_module.split_log = [] if split_rows else None
    t0 = time.perf_counter()
    try:
        await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
    finally:
        engine.stop()
        torch.cuda.synchronize()
        split_log, split_module.split_log = split_module.split_log, None
    wall = time.perf_counter() - t0
    launches = read_launches()
    for s in stats:
        if len(s["tokens"]) != max_tokens or s["finish"] != "length":
            raise AssertionError(f"{tag} request {s['i']}: {len(s['tokens'])} tokens, "
                                 f"finish {s['finish']!r}; expected {max_tokens}, 'length'")
        if not all(0 <= t < mcfg.vocab_size for t in s["tokens"]):
            raise AssertionError(f"{tag} request {s['i']}: token id outside the vocab")
    missing = [n for n in expect if launches[n] <= 0]
    if missing:
        raise AssertionError(f"{tag}: {missing} never launched: {launches}")
    n_split = split_launches = None
    if split_log is not None:
        counts = [(n >= 2).sum() for _, n in split_log if n is not None]
        per_launch = torch.stack(counts).tolist() if counts else []
        n_split, split_launches = sum(per_launch), sum(1 for c in per_launch if c)
        if not n_split:
            raise AssertionError(f"{tag}: the kernel split no row (decode rows of up to "
                                 f"{max(lens)} keys) in {len(split_log)} launches")
    split = [n for n in forbid if launches[n]]
    if split:
        raise AssertionError(f"{tag}: layers went through {split}: {launches}")
    if engine.step_counts["mixed"] <= 0:
        raise AssertionError(f"{tag}: no fused mixed step ran: {engine.step_counts}")
    peak = torch.cuda.max_memory_allocated()
    ttft = sorted(s["ttft_s"] for s in stats)
    itl = sorted(s["itl_s"] for s in stats)
    n_out = sum(len(s["tokens"]) for s in stats)
    return {
        "requests": len(stats), "prompt_tokens": list(lens), "max_tokens": max_tokens,
        "wall_s": wall, "output_tok_s": n_out / wall,
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": ttft[-1],
        "itl_s_median": statistics.median(itl), "itl_s_max": itl[-1],
        "steps": dict(engine.step_counts), **horizon_report(engine), "launches": launches,
        "peak_allocated_bytes": peak, "split_rows": n_split,
        "launches_with_split_rows": split_launches,
    }


# ------------------------------------------------------------- phase 5
def horizon_report(engine) -> dict:
    """An engine's decode schedule (and the measurements behind an
    auto-tuned one) and its horizon graphs: count, capture seconds, pool
    bytes, replays."""
    c = engine.cfg
    return {"schedule": {"decode_steps": c.decode_steps, "decode_pipeline": c.decode_pipeline,
                         "cuda_graphs": c.cuda_graphs, **engine.schedule},
            "horizon": engine.horizon_stats()}


# decode-heavy traffic: 8 prompts of 128 tokens queued before the first
# tick, 256 output tokens each, on llama3-8b at 32 layers (full width and
# depth, random bf16 weights from seed 0), max_context 4096, 2048 blocks
HZ_PROMPTS, HZ_PROMPT_LEN, HZ_TOKENS = 8, 128, 256
HZ_SAMPLED = 3     # T 0.8, top-p 0.95, seed 7; the rest greedy
HZ_STEPS = 8
# the graph = eager checks on engines of their own (llama int8, gemma2-2b,
# gpt-oss-20b, the spec rounds) compare every cache page bit for bit, which
# the depth does not change: they run on the first GRAPH_CHECK_LAYERS layers
# at full width, to keep the command inside its time limit
GRAPH_CHECK_LAYERS = 8


def first_layers(cfg, params=None, n: int = GRAPH_CHECK_LAYERS):
    """(cfg, params) cut to the first ``n`` layers."""
    cut = dataclasses.replace(cfg, num_layers=n)
    if params is None:
        return cut, None
    return cut, {**params, "layers": params["layers"][:n]}


# decode-heavy traffic served on its first layers, at full width, to keep
# the command inside its time limit on a slow host (PR 19: 1245.0 s at
# full depth on one whose unchanged phases ran ~28% over PR 18's): the
# horizon phase's llama3-8b runs (a)-(d) on 8 of 32 layers -- their gates
# compare streams, and phase 9's plain run serves the same prompts on
# (d)'s schedule at all 32 -- and DeepSeek-V2-Lite's (a) and (d) on 8 of
# 27, and gpt-oss-20b's on 12 of 24 (their ITL and busy share are not
# comparable with runs at other depths; PERF.md says which). The graph =
# eager checks and the staggered serving runs keep their depth (the
# latter's fused-mixed-step gate hangs on the forward's length).
HZ_TRAFFIC_LAYERS = {"llama3-8b": 8, "deepseek-v2-lite": 8, "gpt-oss-20b": 12}


def horizon_prompts():
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    rng = np.random.default_rng(8)
    words = [bytes(rng.integers(97, 123, size=rng.integers(2, 9))).decode()
             for _ in range(4000)]
    out = []
    for _ in range(HZ_PROMPTS):
        text = " ".join(words[int(i)] for i in rng.integers(0, len(words), size=HZ_PROMPT_LEN))
        out.append(tok.encode(text)[:HZ_PROMPT_LEN])
    return out


async def serve_decode_heavy(torch, params, prompts, stop=None, mcfg=None,
                             tokens=HZ_TOKENS, max_context=4096, sampled=HZ_SAMPLED,
                             logprobs=0, draft_params=None, **knobs):
    """Serve the decode-heavy traffic once on a fresh engine over
    ``params`` (of ``mcfg``, default llama3-8b), ``tokens`` output tokens
    a request; ``stop``: pick_stop's (request, index, token); ``sampled``:
    the one seeded sampled request (None: all greedy); ``logprobs``: top
    logprobs each request asks for. ``knobs``: the engine's decode_steps /
    decode_pipeline / cuda_graphs / kv_dtype / spec_draft / spec_k
    (``draft_params``: the draft's weights). Returns each request's tokens,
    top logprobs, finish and the sizes of its output chunks (one per
    horizon), TTFT / ITL / tok/s / wall, the tokens each request had when
    the last prompt's prefill ended (``pre``: horizons start there), and
    the engine's steps, horizon report, spec stats and launches (replays
    counted)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.runtime import Context

    mcfg = mcfg or LlamaConfig.llama3_8b()
    cfg = TorchEngineConfig(model=mcfg, num_blocks=2048, block_size=BS, max_batch_size=8,
                            max_context=max_context, seed=0, **knobs)
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, params=params, draft_params=draft_params)
    torch.cuda.synchronize()
    ready_s = time.perf_counter() - t0
    pre = {}
    accept = engine._accept_tokens

    def accept_and_mark(st, *a, **k):
        accept(st, *a, **k)
        live = [x for x in engine._slots if x is not None]
        if not pre and len(live) == HZ_PROMPTS and all(x.prefilled for x in live):
            pre.update({x.req.request_id: x.produced for x in live})

    engine._accept_tokens = accept_and_mark
    stats = []

    async def one(i, prompt):
        samp = (SamplingOptions(temperature=0.8, top_p=0.95, seed=7, logprobs=logprobs)
                if i == sampled else SamplingOptions(temperature=0.0, logprobs=logprobs))
        ids = [stop[2]] if stop is not None and stop[0] == i else []
        req = PreprocessedRequest(request_id=f"h{i}", model="decode-heavy", token_ids=prompt,
                                  sampling=samp, stop=StopConditions(max_tokens=tokens,
                                                                     stop_token_ids=ids))
        t_sub = time.perf_counter()
        stamps, toks, top, chunks, finish = [], [], [], [], None
        async for out in engine.generate(req, Context()):
            if out.token_ids:
                stamps.append(time.perf_counter())
                toks.extend(out.token_ids)
            top.extend(out.top_logprobs or [])
            chunks.append(len(out.token_ids))
            finish = out.finish_reason or finish
        stats.append({"i": i, "tokens": toks, "top": top, "finish": finish, "chunks": chunks,
                      "ttft_s": stamps[0] - t_sub if stamps else None,
                      "itl_s": ((stamps[-1] - stamps[0]) / (len(toks) - 1)
                                if len(toks) > 1 else None)})

    reset_launches()
    t0 = time.perf_counter()
    try:
        await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
    finally:
        engine.stop()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats.sort(key=lambda x: x["i"])
    ttft = sorted(x["ttft_s"] for x in stats)
    itl = sorted(x["itl_s"] for x in stats)
    out = {"ready_s": ready_s, "wall_s": wall,
           "output_tok_s": sum(len(x["tokens"]) for x in stats) / wall,
           "ttft_s_median": statistics.median(ttft), "ttft_s_max": ttft[-1],
           "itl_s_median": statistics.median(itl), "itl_s_max": itl[-1],
           "pre": [pre.get(f"h{i}") for i in range(HZ_PROMPTS)],
           "steps": dict(engine.step_counts), **horizon_report(engine),
           "spec": dict(engine.spec_stats, acceptance=engine.spec_acceptance()),
           "launches": read_launches(), "requests": stats}
    return out, engine


def pick_stop(free: dict):
    """(request, index, token): a greedy request's token whose first
    appearance in the free run falls mid-horizon (neither first nor last
    of its horizon of HZ_STEPS), after at least one whole horizon."""
    for r in free["requests"]:
        if r["i"] == HZ_SAMPLED:
            continue
        toks, pre = r["tokens"], free["pre"][r["i"]]
        for j in range(pre + HZ_STEPS, len(toks) - 1):
            if 0 < (j - pre) % HZ_STEPS < HZ_STEPS - 1 and toks[j] not in toks[:j]:
                return r["i"], j, toks[j]
    raise AssertionError("horizon: no greedy request samples a new token mid-horizon")


def check_same_streams(tag: str, run: dict, free: dict, stop) -> None:
    """``run`` streams the free run's tokens: every request all of them,
    the stopped one (``stop``: pick_stop's, or None) its tokens before the
    stop token, finishing "stop" with the stop inside a horizon."""
    i_stop, j, _ = stop if stop is not None else (None, None, None)
    pre = free["pre"]
    if run["pre"] != pre:
        raise AssertionError(f"{tag}: prefill phase ended at {run['pre']}, free run at {pre}")
    for r, f in zip(run["requests"], free["requests"]):
        want, finish = (f["tokens"][:j], "stop") if r["i"] == i_stop else (f["tokens"], "length")
        if r["tokens"] != want or r["finish"] != finish:
            first = next((n for n, (a, b) in enumerate(zip(r["tokens"], want)) if a != b),
                         min(len(r["tokens"]), len(want)))
            raise AssertionError(
                f"{tag}: request {r['i']} streamed {len(r['tokens'])} tokens ({r['finish']}), "
                f"expected {len(want)} ({finish}) of the one-step eager run; first "
                f"difference at token {first}")
    if stop is None:
        return
    last = [c for c in run["requests"][i_stop]["chunks"] if c][-1]
    if run["steps"]["horizon"] and not 0 < last < HZ_STEPS - 1:
        raise AssertionError(f"{tag}: the stop did not fall inside a horizon ({last} "
                             f"tokens in the last chunk)")


def random_horizon_state(torch, engine, lens, seed):
    """Random caches (every page), random output counts and prompt masks,
    and a horizon state over ``lens`` (0: an inactive row) with distinct
    pages per row, row 2 sampled with top-p and row 5 penalized."""
    hz, c = engine._horizon, engine.cfg
    hs = hz.state
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for cache in engine.k_caches + engine.v_caches:
        if hasattr(cache, "scale"):
            cache.data.copy_(torch.randint(-127, 128, cache.data.shape, generator=gen,
                                           device="cuda", dtype=torch.int8))
            cache.scale.copy_(torch.rand(cache.scale.shape, generator=gen, device="cuda") / 50)
        else:
            cache.normal_(generator=gen)
    B = c.max_batch_size
    n = c.decode_steps
    tables = torch.zeros(B, c.max_blocks_per_seq, dtype=torch.int32)
    nxt = 1
    for r, L in enumerate(lens):
        if L:
            k = -(-(L + n) // c.block_size)
            tables[r, :k] = torch.arange(nxt, nxt + k, dtype=torch.int32)
            nxt += k
    lens_t = torch.tensor(lens, dtype=torch.int32)
    active = lens_t > 0
    vals = {"tokens": torch.randint(0, engine.mcfg.vocab_size, (B,)), "seq_lens": lens_t,
            "steps": torch.arange(B) * 3, "tables": tables, "active": active,
            "count_rows": active, "sample_rows": active & (torch.arange(B) == 2),
            "seeds": torch.arange(B) + 11,
            "temps": torch.where(torch.arange(B) == 2, 0.8, 0.0),
            "top_ks": torch.zeros(B, dtype=torch.int64),
            "top_ps": torch.where(torch.arange(B) == 2, 0.95, 1.0),
            "min_ps": torch.zeros(B), "freqs": torch.zeros(B),
            "pres": torch.where(torch.arange(B) == 5, 0.5, 0.0),
            "reps": torch.where(torch.arange(B) == 5, 1.2, 1.0)}
    for name, v in vals.items():
        getattr(hs, name).copy_(v)
    engine.output_counts.copy_(torch.randint(0, 3, engine.output_counts.shape, generator=gen,
                                             device="cuda", dtype=torch.int32))
    engine.prompt_masks.copy_(torch.randint(0, 2, engine.prompt_masks.shape, generator=gen,
                                            device="cuda", dtype=torch.int8))
    return hz.key(max(lens) + n - 1, True)


def cache_arrays(caches):
    return [t for c in caches for t in ((c.data, c.scale) if hasattr(c, "scale") else (c,))]


def graph_equals_eager(torch, engine, tag: str, lens) -> dict:
    """From one random state: the horizon body run eagerly on cloned
    caches and output counts, then the captured graph replayed on the
    originals. The packed results, the carry, the output counts and every
    K/V page but scratch block 0 (which every inactive row writes, in an
    order that decides its contents) must be bit-identical."""
    hz = engine._horizon
    hs = hz.state
    key = random_horizon_state(torch, engine, lens, seed=9)
    carry0 = hs.carry.dev.clone()
    orig = (engine.k_caches, engine.v_caches, engine.output_counts)

    def clone(c):
        return type(c)(c.data.clone(), c.scale.clone()) if hasattr(c, "scale") else c.clone()

    engine.k_caches = [clone(c) for c in orig[0]]
    engine.v_caches = [clone(c) for c in orig[1]]
    engine.output_counts = orig[2].clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine._decode_multi(hs, *key)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager = (hs.packed.clone(), hs.carry.dev.clone(), engine.output_counts,
             cache_arrays(engine.k_caches + engine.v_caches))
    engine.k_caches, engine.v_caches, engine.output_counts = orig
    hs.carry.dev.copy_(carry0)
    graph, _ = hz.graphs[key]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    graphed = (hs.packed, hs.carry.dev, engine.output_counts,
               cache_arrays(engine.k_caches + engine.v_caches))
    for name, a, b in (("packed tokens and logprobs", eager[0], graphed[0]),
                       ("carry", eager[1], graphed[1]), ("output counts", eager[2], graphed[2])):
        if not torch.equal(a, b):
            raise AssertionError(f"horizon {tag}: graph replay's {name} differ from the "
                                 "eager horizon's")
    pages = 0
    for a, b in zip(eager[3], graphed[3]):
        if not torch.equal(a[1:], b[1:]):
            raise AssertionError(f"horizon {tag}: a K/V page differs between the graph "
                                 "replay and the eager horizon")
        pages += a.shape[0] - 1
    if not torch.isfinite(hs.packed[:, :, 1][:, hs.active]).all():
        raise AssertionError(f"horizon {tag}: logprobs not finite")
    return {"key": list(key), "lens": list(lens), "steps": hs.packed.shape[0],
            "eager_s": eager_s, "replay_s": replay_s, "pages_compared": pages,
            "cache_arrays": len(eager[3]), "bit_identical": True}


def graph_ms(torch, fn, reps: int = 50) -> float:
    """Milliseconds per replay of ``fn`` captured as a CUDA graph (the
    device time of that work inside a graph), CUDA events over ``reps``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def time_step_parts(torch, mcfg) -> dict:
    """Device ms per decode step inside a graph, at the decode-heavy
    traffic's batch of 8: the Gumbel draw over [8, vocab] (every sampled
    step), and every layer's K and V decode write (the plain-PyTorch
    write, no kernel of its own) on bf16 and on int8 caches."""
    from dynamo_tpu_torch.engine.sampling import gumbel_noise_tensor
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops.quant import QuantizedKV

    B, L, nb = 8, mcfg.num_layers, 64
    gen = torch.Generator(device="cuda").manual_seed(4)
    seeds = torch.arange(B, device="cuda") + 7
    steps = torch.arange(B, device="cuda") * 5
    rows = torch.ones(B, dtype=torch.bool, device="cuda")
    shape = (nb, BS, mcfg.num_kv_heads, mcfg.head_dim)
    bf16 = [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2 * L)]
    int8 = [QuantizedKV(torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                      dtype=torch.int8),
                        torch.rand(shape[0], shape[2], generator=gen, device="cuda") / 50)
            for _ in range(2 * L)]
    k = torch.randn(B, mcfg.num_kv_heads, mcfg.head_dim, generator=gen,
                    device="cuda").to(torch.bfloat16)
    blocks = torch.arange(1, B + 1, device="cuda") * 5
    offs = torch.arange(B, device="cuda") % BS + 1

    def writes(caches):
        for li in range(L):
            att.write_decode_kv(caches[2 * li], caches[2 * li + 1], k, k, blocks, offs)

    return {"gumbel_ms": graph_ms(torch, lambda: gumbel_noise_tensor(
                seeds, steps, mcfg.vocab_size, rows=rows)),
            "kv_write_bf16_ms": graph_ms(torch, lambda: writes(bf16)),
            "kv_write_int8_ms": graph_ms(torch, lambda: writes(int8)),
            "layers": L, "batch": B}


def horizon_phase(torch, smi: str) -> dict:
    """The decode horizon on the card: graph equals eager bit for bit
    (llama bf16, llama int8, gemma2-2b), the decode-heavy traffic served
    four ways on one set of weights -- (a) one eager step per tick, (b) an
    eager horizon of 8, (c) graphed horizons of 8 two in flight, (d) the
    auto-tuned schedule with graphs -- (b)-(d) streaming exactly (a)'s
    tokens, and the per-step device time of the Gumbel draw and the KV
    writes inside a graph. (No decode-heavy run is profiled since the
    gpt-oss (d) profile was cut.)"""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.models import registry
    from dynamo_tpu_torch.models.gemma import GemmaConfig
    from dynamo_tpu_torch.models.llama import LlamaConfig

    out = {}
    mcfg = LlamaConfig.llama3_8b()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = registry.init_params(mcfg, gen, "cuda")
    hz_cfg, hz_params = first_layers(mcfg, params, HZ_TRAFFIC_LAYERS["llama3-8b"])
    prompts = horizon_prompts()
    runs = {}
    free, eng = asyncio.run(serve_decode_heavy(torch, hz_params, prompts, mcfg=hz_cfg,
                                               decode_steps=1, decode_pipeline=1))
    del eng
    stop = pick_stop(free)
    out["stop"] = {"request": stop[0], "index": stop[1], "token": stop[2],
                   "horizon_offset": (stop[1] - free["pre"][stop[0]]) % HZ_STEPS}
    for s in free["requests"]:
        if len(s["tokens"]) != HZ_TOKENS or s["finish"] != "length":
            raise AssertionError(f"horizon (a): request {s['i']}: {len(s['tokens'])} tokens, "
                                 f"{s['finish']!r}")
    runs["a"] = free
    plans = (("b", dict(decode_steps=HZ_STEPS, decode_pipeline=1, cuda_graphs=False)),
             ("c", dict(decode_steps=HZ_STEPS, decode_pipeline=2)),
             ("d", {}))
    for tag, knobs in plans:
        gc.collect()
        torch.cuda.empty_cache()
        run, eng = asyncio.run(serve_decode_heavy(torch, hz_params, prompts, stop=stop,
                                                  mcfg=hz_cfg, **knobs))
        del eng
        check_same_streams(f"horizon ({tag})", run, free, stop)
        if run["steps"]["horizon"] <= 0:
            raise AssertionError(f"horizon ({tag}): no horizon ran: {run['steps']}")
        for name in ("decode", "unified", "flash_extend"):
            if run["launches"][name] <= 0:
                raise AssertionError(f"horizon ({tag}): the {name} kernel never launched")
        if knobs.get("cuda_graphs", True):
            if run["horizon"]["replays"] != run["steps"]["horizon"]:
                raise AssertionError(f"horizon ({tag}): {run['horizon']} replays for "
                                     f"{run['steps']['horizon']} horizons")
            if run["launches"]["replayed"]["decode"] <= 0:
                raise AssertionError(f"horizon ({tag}): no decode launch came from a replay")
        runs[tag] = run
        if tag == "c":
            # graph = eager on (c)'s schedule at all 32 layers
            gc.collect()
            torch.cuda.empty_cache()
            eng = TorchEngine(TorchEngineConfig(
                model=mcfg, num_blocks=2048, block_size=BS, max_batch_size=8, max_context=4096,
                seed=0, **knobs), params=params)
            out["graph_equals_eager"] = {"llama3-8b bf16": graph_equals_eager(
                torch, eng, "llama bf16", [300, 1000, 2500, 4096 - HZ_STEPS, 64, 0, 1800, 17])}
            eng.stop()
            del eng
    for tag, run in runs.items():
        log(f"horizon ({tag}) on {smi}: schedule {run['schedule']}; "
            f"{run['output_tok_s']:.1f} tok/s, wall {run['wall_s']:.2f} s, TTFT median "
            f"{run['ttft_s_median'] * 1e3:.0f} ms (max {run['ttft_s_max'] * 1e3:.0f}), ITL "
            f"median {run['itl_s_median'] * 1e3:.2f} ms (max {run['itl_s_max'] * 1e3:.2f}); "
            f"steps {run['steps']}; graphs {run['horizon']}; launches {run['launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    out["runs"] = {tag: {k: v for k, v in run.items() if k != "requests"}
                   for tag, run in runs.items()}
    # graph against eager on the other caches and family
    gc.collect()
    torch.cuda.empty_cache()
    cut, cut_params = first_layers(mcfg, params)
    for tag, mk in (
            ("llama3-8b int8", lambda: TorchEngine(TorchEngineConfig(
                model=cut, num_blocks=2048, block_size=BS, max_batch_size=8, max_context=4096,
                kv_dtype="int8", decode_steps=HZ_STEPS, decode_pipeline=1), params=cut_params)),
            ("gemma2-2b bf16", lambda: TorchEngine(TorchEngineConfig(
                model=first_layers(GemmaConfig.gemma2_2b())[0], num_blocks=2048, block_size=BS,
                max_batch_size=8, max_context=8192, decode_steps=HZ_STEPS,
                decode_pipeline=1)))):
        eng = mk()
        lens = ([300, 1000, 2500, 4096 - HZ_STEPS, 64, 0, 1800, 17] if "llama" in tag
                else [300, 5000, 2500, 8192 - HZ_STEPS, 64, 0, 4500, 17])
        out["graph_equals_eager"][tag] = {**graph_equals_eager(torch, eng, tag, lens),
                                          **horizon_report(eng)}
        eng.stop()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del cut_params
    for tag, r in out["graph_equals_eager"].items():
        log(f"horizon graph = eager, {tag}: bit-identical over {r['steps']} steps at key "
            f"{r['key']} ({r['pages_compared']} pages x {r['cache_arrays']} cache arrays); "
            f"eager {r['eager_s'] * 1e3:.1f} ms, replay {r['replay_s'] * 1e3:.1f} ms")
    del params, hz_params
    gc.collect()
    torch.cuda.empty_cache()
    out["step_parts"] = time_step_parts(torch, mcfg)
    p = out["step_parts"]
    log(f"horizon step parts inside a graph on {smi}, batch 8: Gumbel draw over "
        f"{mcfg.vocab_size} {p['gumbel_ms']:.4f} ms; K and V decode writes of "
        f"{p['layers']} layers {p['kv_write_bf16_ms']:.4f} ms bf16, "
        f"{p['kv_write_int8_ms']:.4f} ms int8")
    return out


# ------------------------------------------------------------- phase 6
# the expert FFN's check: token counts of a decode batch and of a prefill
# chunk at gpt-oss-20b width (H 2880, I 2880, E 32, K 4)
EXPERT_TOKENS = (8, 2048)
GPTOSS_BLOCKS = 4096
GPTOSS_HZ_TOKENS = 64


def expert_bound(cfg, topi, T) -> tuple:
    """(bound ms, bound_by, experts hit) of the expert FFN on T tokens
    routed to ``topi``: the bytes of the experts it hits (gate/up and down
    weights and biases, bf16), the tokens in and out and the routing, over
    the FLOPs of the T * K rows' two products."""
    H, I, K = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts_per_tok
    hit = len(set(topi.flatten().tolist()))
    per_expert = 2 * (H * 2 * I + I * H + 2 * I + H)
    b, by = bound(hit * per_expert + 2 * 2 * T * H + T * K * (4 + 8),
                  2 * T * K * (H * 2 * I + I * H))
    return b, by, hit


def check_experts(torch, gen, timer) -> dict:
    """gpt-oss-20b's expert FFN at full width: ``experts_grouped`` (what
    the engine runs) against ``experts_plain`` (the expert loop in float32)
    at EXPERT_TOKENS tokens, routed by a random router, with non-zero
    biases; timed against its byte and FLOP bounds (no single PyTorch call
    computes it; the wait before each timed call covers its host work, some
    15 launches). Then the decode batch's form captured into a CUDA graph
    and replayed must equal its eager run bit for bit: the form the decode
    horizon captures (gptoss_phase counts the grouped GEMMs its horizon
    graphs capture)."""
    from dynamo_tpu_torch.models import gptoss

    if not hasattr(torch, "_grouped_mm"):
        raise AssertionError(f"torch {torch.__version__} has no torch._grouped_mm: the "
                             "grouped expert path cannot run")
    cfg = gptoss.GptOssConfig.gpt_oss_20b()
    p = gptoss.init_layer_params(cfg, gen, "cuda")
    for name in ("b_router", "b_gateup", "b_edown"):
        p[name].normal_(0.0, 0.1, generator=gen)
    out = {}
    for T in EXPERT_TOKENS:
        x = torch.randn(T, cfg.hidden_size, generator=gen, device="cuda").to(torch.bfloat16)
        routed = gptoss.route(p, cfg, x)
        got = gptoss.experts_grouped(p, cfg, x, routed)
        want = gptoss.experts_plain(p, cfg, x, routed).float()
        # per token: the grouped products round the gate/up and the down
        # outputs to bf16 where the plain loop keeps float32, a relative
        # error of a few 2^-9 on a row (no elementwise bound holds near 0);
        # a wrong expert, bias, lane or permutation moves a row by O(1)
        row_rel = ((got.float() - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
        if not torch.isfinite(got).all() or row_rel > KERNEL_ROW_REL:
            raise AssertionError(f"experts_grouped T={T}: rows differ from the plain loop by "
                                 f"{row_rel:.4g} relative L2 (limit {KERNEL_ROW_REL})")
        err = (got.float() - want).abs().max().item()
        b, by, hit = expert_bound(cfg, routed[1], T)
        ms = timer(lambda: gptoss.experts_grouped(p, cfg, x, routed), busy=2_000_000)
        out[T] = {"max_abs_err": err, "worst_row_rel": row_rel, "experts_hit": hit, "ms": ms,
                  "plain_ms": timer(lambda: gptoss.experts_plain(p, cfg, x, routed), reps=3),
                  "library_ms": None, "bound_ms": b, "bound_by": by}
        log(f"  experts_grouped T={T}: worst row relative L2 {row_rel:.3g} (limit "
            f"{KERNEL_ROW_REL}), max abs err {err:.3g} against the plain loop; "
            f"{ms:.4f} ms, {out[T]['plain_ms']:.4f} ms plain, bound {b:.4f} ms ({by}, "
            f"{hit} of {cfg.num_experts} experts hit)")
    # the decode batch's form inside a CUDA graph
    x = torch.randn(EXPERT_TOKENS[0], cfg.hidden_size, generator=gen,
                    device="cuda").to(torch.bfloat16)
    routed = gptoss.route(p, cfg, x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = gptoss.experts_grouped(p, cfg, x, routed)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        y = gptoss.experts_grouped(p, cfg, x, routed)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(y, eager):
        raise AssertionError("experts_grouped: its graph replay differs from its eager run")
    log(f"  experts_grouped T={EXPERT_TOKENS[0]} captured into a CUDA graph: replay equals "
        "eager bit for bit")
    return out


def gptoss_phase(torch, gen, smi: str, flex) -> tuple:
    """gpt-oss-20b on the card (module docstring, phase 6). Returns (the
    kernel results by report name, the phase's report)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig, param_bytes
    from dynamo_tpu_torch.models import registry
    from dynamo_tpu_torch.models.gptoss import GptOssConfig

    results, out = {}, {}
    timer = Timer(torch)
    # (a) the unified kernel at d = 64, bf16 and int8, and its merge
    for int8 in (False, True):
        t0 = time.perf_counter()
        r = check_unified_attrs(torch, gen, timer, GPTOSS, int8=int8, flex=flex)
        results[r["name"]] = r
        log(f"kernel {r['name']}: max abs err {r['max_abs_err']:.3g} over "
            f"{len(r['cases'])} cases (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}, row "
            f"{KERNEL_ROW_REL}) [{time.perf_counter() - t0:.1f} s]")
    r = check_merge(torch, gen, timer, GPTOSS)
    results[r["name"]] = r
    log(f"kernel {r['name']}: max abs err {r['max_abs_err']:.3g}; {r['ms']:.4f} ms kernel, "
        f"{r['plain_ms']:.4f} ms plain, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); the "
        f"sink counted once per split moves the split rows by "
        f"{r['sink_per_split_row_gap'][0]:.3g}-{r['sink_per_split_row_gap'][1]:.3g}")
    # (b) the expert FFN
    t0 = time.perf_counter()
    out["experts"] = check_experts(torch, gen, timer)
    log(f"experts on {smi}: " + json.dumps(out["experts"]) +
        f" [{time.perf_counter() - t0:.1f} s]")
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    # (c) the model check at full width, two layers
    t0 = time.perf_counter()
    worst, mutants, spread = gptoss_model_check(torch)
    out["model"] = {"worst": worst, "mutants": mutants, "max_logit": spread}
    log(f"model gpt-oss-20b: {GPTOSS_MODEL_CHECK[0]} layers at full width, prefill "
        f"{GPTOSS_MODEL_CHECK[1]} + 3 decode + a 2-token ragged step, {len(MODEL_SEEDS)} "
        f"seeds: kernels vs plain logits relative L2 {worst:.4g} at worst (limit "
        f"{MODEL_REL_TOL}); mutants at least "
        + ", ".join(f"{n[8:]} {r:.4g}" for n, r in mutants.items())
        + f"; max |logit| {spread:.3g} [{time.perf_counter() - t0:.1f} s]")
    gc.collect()
    torch.cuda.empty_cache()
    # (d) gpt-oss-20b at all 24 layers on its defaults
    mcfg = GptOssConfig.gpt_oss_20b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = registry.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    out["load"] = {"s": time.perf_counter() - t0, "param_bytes": param_bytes(params),
                   "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    log(f"gpt-oss-20b: {mcfg.num_layers} layers, random bf16 weights (seed 0), "
        f"{out['load']['param_bytes'] / 1e9:.2f} GB, loaded in {out['load']['s']:.1f} s; "
        f"peak allocated {out['load']['peak_allocated_bytes'] / 2**30:.2f} GiB")
    out["graph_equals_eager"] = {}
    cut, cut_params = first_layers(mcfg, params)
    for kv in ("model", "int8"):
        eng = TorchEngine(TorchEngineConfig(
            model=cut, num_blocks=GPTOSS_BLOCKS, block_size=BS, max_batch_size=8,
            max_context=8192, kv_dtype=kv, decode_steps=HZ_STEPS, decode_pipeline=1),
            params=cut_params)
        tag = f"gpt-oss-20b {'int8' if kv == 'int8' else 'bf16'}"
        r = {**graph_equals_eager(torch, eng, tag, [300, 5000, 2500, 8192 - HZ_STEPS, 64, 0,
                                                    4500, 17]), **horizon_report(eng)}
        out["graph_equals_eager"][tag] = r
        log(f"horizon graph = eager, {tag}: bit-identical over {r['steps']} steps at key "
            f"{r['key']} ({r['pages_compared']} pages x {r['cache_arrays']} cache arrays); "
            f"eager {r['eager_s'] * 1e3:.1f} ms, replay {r['replay_s'] * 1e3:.1f} ms; graphs "
            f"{r['horizon']}")
        eng.stop()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del cut_params
    # the horizon schedules stream one-step decode's tokens, on
    # HZ_TRAFFIC_LAYERS
    prompts = horizon_prompts()
    runs = {}
    hz_cfg, hz_params = first_layers(mcfg, params, HZ_TRAFFIC_LAYERS["gpt-oss-20b"])
    # the grouped expert GEMMs the horizon graphs of (d) capture: calls to
    # torch._grouped_mm made while a CUDA graph is being captured
    grouped_mm, captured = torch._grouped_mm, []

    def counted_grouped_mm(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            captured.append(1)
        return grouped_mm(*a, **k)

    for tag, knobs in (("a", dict(decode_steps=1, decode_pipeline=1)), ("d", {})):
        torch._grouped_mm = counted_grouped_mm if tag == "d" else grouped_mm
        try:
            run, eng = asyncio.run(serve_decode_heavy(
                torch, hz_params, prompts, mcfg=hz_cfg, tokens=GPTOSS_HZ_TOKENS,
                max_context=8192, **knobs))
        finally:
            torch._grouped_mm = grouped_mm
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        runs[tag] = run
        log(f"gpt-oss decode-heavy ({tag}) on {smi}: schedule {run['schedule']}; "
            f"{run['output_tok_s']:.1f} tok/s, ITL median {run['itl_s_median'] * 1e3:.2f} ms, "
            f"TTFT median {run['ttft_s_median'] * 1e3:.0f} ms; steps {run['steps']}; graphs "
            f"{run['horizon']}")
    for r in runs["a"]["requests"]:
        if len(r["tokens"]) != GPTOSS_HZ_TOKENS or r["finish"] != "length":
            raise AssertionError(f"gpt-oss decode-heavy (a): request {r['i']}: "
                                 f"{len(r['tokens'])} tokens, {r['finish']!r}")
    check_same_streams("gpt-oss decode-heavy (d)", runs["d"], runs["a"], None)
    if runs["d"]["horizon"]["replays"] <= 0:
        raise AssertionError(f"gpt-oss decode-heavy (d): no graph replay: {runs['d']}")
    # the form the horizon's graphs captured, and so replayed: the grouped
    # GEMMs (the profiled twin of (d) that showed their kernels is cut)
    if not captured:
        raise AssertionError("gpt-oss decode-heavy (d): its horizon graphs captured no "
                             "grouped GEMM (torch._grouped_mm)")
    out["experts"]["captured"] = (f"grouped (torch._grouped_mm): {len(captured)} calls "
                                  f"captured, {runs['d']['horizon']['replays']} replays")
    log(f"gpt-oss decode-heavy (d) on {smi}: {out['experts']['captured']}")
    del hz_params
    gc.collect()
    torch.cuda.empty_cache()
    out["schedules"] = {t: {k: v for k, v in r.items() if k != "requests"}
                        for t, r in runs.items()}
    # the serving runs: bf16 (the kernel's split rows logged), then a short
    # int8 run
    serving = {}
    for key, int8 in (("bf16", False), ("int8", True)):
        run = asyncio.run(serve_windowed(
            torch, mcfg, "gpt-oss-20b", GPTOSS_INT8_PROMPTS if int8 else GPTOSS_PROMPTS,
            16 if int8 else 32, int8=int8, params=params, prompt_seed=12,
            sample_seed=13, split_rows=not int8))
        serving[key] = run
        log(f"serving gpt-oss-20b {key}: " + json.dumps(run))
        gc.collect()
        torch.cuda.empty_cache()
    run = serving["bf16"]
    log(f"serving gpt-oss-20b on {smi}: {run['requests']} requests of {GPTOSS_PROMPTS} "
        f"tokens, {run['output_tok_s']:.1f} output tok/s, TTFT median "
        f"{run['ttft_s_median'] * 1e3:.0f} ms (max {run['ttft_s_max'] * 1e3:.0f}), ITL median "
        f"{run['itl_s_median'] * 1e3:.2f} ms (max {run['itl_s_max'] * 1e3:.2f}); "
        f"{run['launches_with_split_rows']} launches split rows ({run['split_rows']} rows); "
        f"graphs "
        f"{run['horizon']}; launches {run['launches']}; peak allocated "
        f"{run['peak_allocated_bytes'] / 2**30:.2f} GiB; int8: "
        f"{serving['int8']['output_tok_s']:.1f} tok/s, ITL median "
        f"{serving['int8']['itl_s_median'] * 1e3:.2f} ms")
    out["serving"] = serving
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return results, out


# ------------------------------------------------------------- phase 7
# DeepSeek-V2-Lite's latent attention: 16 query heads over one kv head of
# 576 lanes (kv_lora_rank 512 + qk_rope_head_dim 64), 512 value lanes;
# V2 / V3 have 128 query heads
LD, LV = 576, 512
LATENT_DECODE_LENS = (1, 2000, 3000, 4000, 5000, 6000, 7000, 8000)
# case -> (query heads, rows [(q_len, seq_len)])
# (the form each case takes: tile_shape by h * the longest q_len; rows of
# at most max(1, 64 / h) tokens are split in either form)
LATENT_CASES = {
    # narrow form
    "decode G=16": (16, [(1, n) for n in LATENT_DECODE_LENS]),
    # rows of 1-2 tokens (narrow form) whose last 256-key split holds keys
    # their first token never sees
    "short rows": (16, [(2, 513), (2, 1025), (1, 700), (2, 3000), (2, 257), (1, 1),
                        (2, 2049)]),
    # wide form from here on
    "decode G=128": (128, [(1, n) for n in LATENT_DECODE_LENS]),
    # the last 2048-token chunk of a 6000-token prompt
    "prefill chunk": (16, [(2048, 6000)]),
    # one chunk row and 8 decode rows in one launch
    "mixed": (16, [(1024, 2500)] + [(1, n) for n in (130, 700, 1500, 3000, 4500, 6000,
                                                      7000, 8000)]),
    # the same in the wide form: rows of 1-4 tokens (one 64-row tile at G
    # = 16)
    "wide short rows": (16, [(2, 513), (4, 1500), (1, 700), (3, 3000), (2, 257), (1, 1),
                             (4, 2049)]),
    # V2 / V3's 128 heads on a prefill-shaped row: a 512-token chunk of a
    # 4096-token prompt (half a token a block)
    "chunk G=128": (128, [(512, 4096)]),
}
# the cases whose split-K must reach the SM count in working blocks
LATENT_FILL = ("decode G=16", "decode G=128")
LATENT_SPLIT_ROWS = ("short rows", "wide short rows")
LATENT_MUTANT_CASE = "decode G=16"


def latent_library_call(torch, q, kv, tables, starts, rows):
    """One PyTorch call computing the same function as a latent case:
    scaled_dot_product_attention over the gathered latent, each row's h
    heads folded into the query axis (one kv head serves them all, so
    nothing is expanded), the values the keys' first 512 lanes, keys
    padded to a multiple of 16 with a boolean causal mask; PyTorch picks
    the backend that takes d = 576 (padding query rows see key 0). Returns
    (call, packed [Tq, h, 512] output of a call's result)."""
    from dynamo_tpu_torch.ops import attention as att

    dev = q.device
    R, h = len(rows), q.shape[1]
    T, max_q = max(sl for _, sl in rows), max(ql for ql, _ in rows)
    Tp = -(-T // 16) * 16
    qp = torch.zeros(R, 1, max_q * h, LD, dtype=torch.bfloat16, device=dev)
    kp = torch.zeros(R, 1, Tp, LD, dtype=torch.bfloat16, device=dev)
    for r, (ql, sl) in enumerate(rows):
        k, _ = att.gather_kv(kv, kv, tables[r])
        kp[r, 0, :sl] = k[:sl, 0]
        qp[r, 0, :ql * h] = q[starts[r]:starts[r] + ql].reshape(ql * h, LD)
    vp = kp[..., :LV]
    i64 = dict(dtype=torch.long, device=dev)
    q_len = torch.tensor([ql for ql, _ in rows], **i64)[:, None, None]
    q_off = torch.tensor([sl - ql for ql, sl in rows], **i64)[:, None, None]
    tok = (torch.arange(max_q * h, device=dev) // h)[None, :, None]
    key = torch.arange(Tp, device=dev)[None, None, :]
    mask = torch.where(tok < q_len, key <= q_off + tok, key == 0)[:, None]

    def unpack(out):
        packed = torch.zeros(q.shape[0], h, LV, dtype=torch.bfloat16, device=dev)
        for r, (ql, _) in enumerate(rows):
            packed[starts[r]:starts[r] + ql] = out[r, 0, :ql * h].reshape(ql, h, LV)
        return packed

    sdpa = torch.nn.functional.scaled_dot_product_attention
    return (lambda: sdpa(qp, kp, vp, attn_mask=mask)), unpack


def latent_inputs(torch, gen, h, rows):
    """A latent case's inputs: random bf16 queries of h heads packed with
    gaps, a one-kv-head 576-lane paged cache; returns the kernel's
    positional arguments, its host bounds and the rows' starts."""
    i32 = dict(dtype=torch.int32, device="cuda")
    lens = [sl for _, sl in rows]
    kc, _, tables = paged_case(torch, gen, lens, num_blocks=sum(-(-n // BS) for n in lens)
                               + 64, kvh=1, d=LD)
    starts, pos = [], 0
    for ql, _ in rows:
        starts.append(pos)
        pos += ql + 5
    q = torch.randn(pos, h, LD, generator=gen, device="cuda").to(torch.bfloat16)
    args = (q, kc, tables, torch.tensor(starts, **i32),
            torch.tensor([ql for ql, _ in rows], **i32), torch.tensor(lens, **i32))
    return args, dict(max_q_len=max(ql for ql, _ in rows), max_seq_len=max(lens)), starts


def latent_case(torch, gen, timer, name, h, rows):
    """One latent kernel case: against its plain version (the values the
    keys' first 512 lanes) and its plain split form, the split counts the
    kernel wrote held to att.split_plan, timed with its bound and its
    library yardstick."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_mla

    args, bounds, starts = latent_inputs(torch, gen, h, rows)
    q, kc, tables = args[:3]
    plain_args = (q, kc, kc) + args[2:]
    max_q, max_s = bounds["max_q_len"], bounds["max_seq_len"]
    tag = f"latent {name}"
    cuda_mla.split_log = []
    try:
        got = cuda_mla.latent_paged_attention(*args, **bounds)
        (grid, n_dev), = cuda_mla.split_log
    finally:
        cuda_mla.split_log = None
    plain = att.ragged_paged_attention(*plain_args)[..., :LV]
    err = compare(torch, got, plain, tag)
    compare(torch, got, cuda_mla.split_latent_attention(*args, **bounds), tag + " (plain split)")
    form, tile_rows, qs, _ = cuda_mla.tile_shape(h, max_q)
    S = cuda_mla.split_extent(max_s)
    n_kernel = n_dev.tolist()
    n_plain = [att.split_plan(ql, sl, 0, cuda_mla.SPLIT_KEYS, BS, S)[2]
               if S > 1 and 0 < ql <= qs else 0 for ql, sl in rows]
    if n_kernel != n_plain:
        raise AssertionError(f"{tag}: the kernel split its rows {n_kernel}, the plain split "
                             f"plan {n_plain}")
    blocks = sum(max(n, 1) * -(-ql * h // tile_rows) for (ql, _), n in zip(rows, n_kernel))
    out = {"h": h, "rows": rows, "form": form, "max_abs_err": err, "grid": grid,
           "splits_per_row": n_kernel, "working_blocks": blocks}
    if name in LATENT_SPLIT_ROWS:
        _, _, l, n = att.attention_partials(
            *plain_args, split_keys=cuda_mla.SPLIT_KEYS, align=BS, max_splits=S,
            tile_tokens=qs)
        out["tokens_missing_a_split"] = sum(
            int((l[r, :c, :ql] == 0).all(-1).sum())
            for r, (c, (ql, _)) in enumerate(zip(n.tolist(), rows)) if c)
        if not out["tokens_missing_a_split"]:
            raise AssertionError(f"{tag}: no token misses a whole split")
    if name == LATENT_MUTANT_CASE:
        wrong = cuda_mla.split_latent_attention(*args, **bounds, drop_last_split=True)
        try:
            compare(torch, got, wrong, tag + " against its drop-last-split mutant")
        except AssertionError:
            out["drop_last_split_mutant_fails"] = True
        else:
            raise AssertionError(f"{tag}: a merge without each row's last split passes")
        del wrong
    live = [(ql, sl) for ql, sl in rows if ql > 0 and sl > 0]
    pages = sum(-(-sl // BS) for _, sl in live)
    tokens = sum(ql for ql, _ in live)
    # the work the function does: each live key read once at 576 lanes
    # (the values are its first 512), queries in, outputs out
    flops = 2 * sum(visible_pairs(ql, sl, 0) for ql, sl in live) * h * (LD + LV)
    io = 2 * tokens * h * (LD + LV) + 4 * (3 * len(rows) + pages)
    b, by = bound(io + pages * BS * 2 * LD, flops)
    b_v, _ = bound(io + pages * BS * 2 * (LD + LV), flops)  # with a V page read too (the first form's)
    library, unpack = latent_library_call(torch, q, kc, tables, starts, rows)
    lib_err = (unpack(library()).float() - plain.float()).abs().max().item()
    ms = timer(lambda: cuda_mla.latent_paged_attention(*args, **bounds))
    out.update(
        ms=ms, plain_ms=timer(lambda: att.ragged_paged_attention(*plain_args), reps=3),
        library_ms=timer(library), library="scaled_dot_product_attention (heads folded "
        "into the query axis, values the keys' first 512 lanes; PyTorch's backend choice at "
        "d 576)", library_max_abs_err=lib_err,
        bound_ms=b, bound_by=by, bound_with_v_read_ms=b_v, achieved_of_bound=b / ms)
    del library, unpack
    log(f"  {tag} ({form} form): max abs err {err:.3g}; {ms:.4f} ms kernel, "
        f"{out['plain_ms']:.4f} ms plain, "
        f"{out['library_ms']:.4f} ms library (max abs err {lib_err:.3g}), bound {b:.4f} ms "
        f"({by}, {b / ms:.1%} of it reached; {b_v:.4f} ms with a V read); grid {grid}, "
        f"splits per row {n_kernel} (the "
        f"kernel's count), {blocks} working blocks"
        + (f"; {out['tokens_missing_a_split']} (row, split, token) triples whose split holds "
           "no key the token sees" if "tokens_missing_a_split" in out else "")
        + ("; the plain merge without each row's last split fails the compare"
           if name == LATENT_MUTANT_CASE else ""))
    return out


# the latent kernel's forms: (name, entry-name tag, rows, the least blocks
# per SM it is designed for)
LATENT_FORMS = (("narrow", "latent_narrow", 16, 2), ("wide", "latent_wide", 64, 1))


def latent_build_report(_build) -> dict:
    """The latent kernel's build, per form: registers and spills (fails on
    a spill), blocks per SM with their dynamic shared memory
    (dtt_latent_occupancy; fails below the form's design), and its HGMMA
    and HMMA instructions (cuobjdump; fails if the wide form has no HGMMA
    or the narrow one no HMMA)."""
    import ctypes
    import re

    out_dir = _build.build_dir()
    with open(os.path.join(out_dir, "libmla_attention.so.log")) as f:
        lines = ptxas_summary(f.read())
    spills = [l for l in lines if re.search(r"[1-9]\d* bytes spill", l)]
    if not lines or spills:
        raise AssertionError(f"latent kernel: spills or no ptxas report: {lines}")
    fn = _build.load("mla_attention.cu").dtt_latent_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tool = cuobjdump_tool()
    sass = sass_of(tool, os.path.join(out_dir, "libmla_attention.so")) if tool else None
    forms = {}
    for name, tag, rows, least in LATENT_FORMS:
        blocks, smem = ctypes.c_int(), ctypes.c_int()
        err = fn(rows, ctypes.byref(blocks), ctypes.byref(smem))
        if err or blocks.value < least:
            raise AssertionError(f"latent kernel, {name} form: {blocks.value} blocks per SM "
                                 f"(designed for {least}), error {err}")
        form = {"ptxas": [l for l in lines if tag in l], "blocks_per_sm": blocks.value,
                "smem_bytes": smem.value}
        if sass is not None:
            part = "".join(p for p in sass.split("Function : ")[1:] if tag in p.split()[0])
            form.update({op: sum(1 for l in part.splitlines() if op + "." in l or op + " " in l)
                         for op in ("HGMMA", "HMMA")})
            if not form["HGMMA" if rows == 64 else "HMMA"]:
                raise AssertionError(f"latent kernel, {name} form: no "
                                     f"{'HGMMA' if rows == 64 else 'HMMA'} in its SASS: {form}")
        forms[name] = form
    log("latent kernel build: " + json.dumps(forms))
    return forms


# each form's report entry: (name, the case of its top-level numbers)
LATENT_REPORTS = (("latent_paged_attention", "narrow", "decode G=16"),
                  ("latent_paged_attention_wide", "wide", "prefill chunk"))


def check_latent(torch, gen, timer, _build) -> list:
    """The latent kernel's build report and every case; one report entry
    per form (LATENT_REPORTS), the cases and the build under the first."""
    build = latent_build_report(_build)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = {name: latent_case(torch, gen, timer, name, h, rows)
             for name, (h, rows) in LATENT_CASES.items()}
    for name in LATENT_FILL:
        if cases[name]["working_blocks"] < sms:
            raise AssertionError(f"latent {name}: {cases[name]['working_blocks']} working "
                                 f"blocks on {sms} SMs")
    out = []
    for name, form, case in LATENT_REPORTS:
        main = cases[case]
        if main["form"] != form:
            raise AssertionError(f"latent {case}: took the {main['form']} form, not {form}")
        out.append({
            "name": name, "route": "cuda", "source": "dynamo_tpu_torch/csrc/mla_attention.cu",
            "replaces": "dynamo_tpu/ops/pallas_unified.py:93",
            "shape": f"kvh=1 d_qk={LD} d_v={LV} bs={BS} bf16, the {form} form; top-level "
                     f"numbers: the '{case}' case, G = {main['h']}, rows (q_len, seq_len) "
                     f"{main['rows']}; every case under 'cases' of latent_paged_attention",
            **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                    "bound_by")}})
    out[0].update(build=build, cases=cases)
    return out


def shared_f32(p, x):
    """DeepSeek's shared experts in float32 (the plain version's)."""
    import torch.nn.functional as F

    xf = x.float()
    gate = F.silu(xf @ p["w_shared_gate"].float())
    return (gate * (xf @ p["w_shared_up"].float())) @ p["w_shared_down"].float()


def check_moe_experts(torch, gen, timer) -> dict:
    """The routed-expert FFN of Qwen3-30B-A3B (128 experts, top 8) and of a
    DeepSeek-V2-Lite MoE layer (64, top 6, 2 shared experts) at full
    width, as the engine runs it (routing, grouped products, slot sum; and
    DeepSeek's shared experts), against the float32 expert loop per token
    row at EXPERT_TOKENS tokens, timed against its byte and FLOP bounds
    (no single PyTorch call computes it); then its decode-batch form
    captured into a CUDA graph must replay its eager run bit for bit."""
    from dynamo_tpu_torch.models import mla, moe

    qwen = moe.MoeConfig.qwen3_30b_a3b()
    lite = mla.MlaConfig.deepseek_v2_lite()
    pq = moe.init_layer_params(qwen, gen, "cuda")
    pl = mla.init_layer_params(lite, gen, "cuda", lite.first_dense_layers)
    el = mla.expert_params(pl)
    forms = {
        "qwen3-30b-a3b": (
            qwen, lambda x: moe.experts_grouped(pq, qwen, x, moe.route(pq, qwen, x)),
            lambda x: moe.experts_plain(pq, qwen, x, moe.route(pq, qwen, x)).float(),
            lambda x: moe.route(pq, qwen, x)[1], 0),
        "deepseek-v2-lite": (
            lite, lambda x: mla.moe_ffn(pl, lite, x),
            lambda x: moe.experts_plain(el, lite, x, mla.route(pl, lite, x)).float()
            + shared_f32(pl, x),
            lambda x: mla.route(pl, lite, x)[1],
            lite.moe_intermediate_size * lite.num_shared_experts),
    }
    out = {}
    for tag, (cfg, fn, plain_fn, ids_fn, shared) in forms.items():
        H, I, K, E = (cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts_per_tok,
                      cfg.num_experts)
        out[tag] = {}
        for T in EXPERT_TOKENS:
            x = torch.randn(T, H, generator=gen, device="cuda").to(torch.bfloat16)
            got, want = fn(x), plain_fn(x)
            row_rel = ((got.float() - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
            if not torch.isfinite(got).all() or row_rel > KERNEL_ROW_REL:
                raise AssertionError(f"{tag} experts T={T}: rows differ from the float32 "
                                     f"loop by {row_rel:.4g} relative L2 (limit "
                                     f"{KERNEL_ROW_REL})")
            hit = len(set(ids_fn(x).flatten().tolist()))
            b, by = bound(2 * (hit * 3 * H * I + 3 * H * shared + H * E) + 2 * 2 * T * H,
                          2 * T * (K * 3 * H * I + 3 * H * shared + H * E))
            ms = timer(lambda: fn(x), busy=2_000_000)
            out[tag][T] = {"max_abs_err": (got.float() - want).abs().max().item(),
                           "worst_row_rel": row_rel, "experts_hit": hit, "ms": ms,
                           "plain_ms": timer(lambda: plain_fn(x), reps=3),
                           "library_ms": None, "bound_ms": b, "bound_by": by}
            log(f"  {tag} experts T={T}: worst row relative L2 {row_rel:.3g} (limit "
                f"{KERNEL_ROW_REL}) against the float32 loop; {ms:.4f} ms, "
                f"{out[tag][T]['plain_ms']:.4f} ms plain, bound {b:.4f} ms ({by}, {hit} of {E} "
                f"experts hit)")
        x = torch.randn(EXPERT_TOKENS[0], H, generator=gen, device="cuda").to(torch.bfloat16)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            eager = fn(x)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            y = fn(x)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(y, eager):
            raise AssertionError(f"{tag} experts: the graph replay differs from the eager run")
        out[tag]["graph_equals_eager"] = True
        del graph
    return out


def latent_attention_paths(torch, table, mutants, qk_head_dim):
    """The latent model check's attention paths (as attention_paths): the
    latent kernel for the prefill chunk, the decode steps and the ragged
    step (each one ragged row), the plain op cut to 512 lanes, and two
    wrong attentions: the query's MLA pre-scale dropped (logits 1 /
    sqrt(576 / ``qk_head_dim``) too small) and k_pe zeroed in the cache."""
    import math

    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_mla

    i32 = dict(dtype=torch.int32, device=table.device)

    def one(n):
        return torch.tensor([n], **i32)

    def rows(q, total):
        return table[None], one(0), one(q.shape[0]), one(total)

    def kernel(q, kc, vc, total):  # the values from the keys (V' = [c, 0] equals K' there)
        return cuda_mla.latent_paged_attention(q, kc, *rows(q, total),
                                               max_q_len=q.shape[0], max_seq_len=total)

    def plain(q, kc, vc, total):
        return att.ragged_paged_attention(q, kc, vc, *rows(q, total))[..., :LV]

    def no_prescale(q, kc, vc, total):
        return plain((q.float() / math.sqrt(LD / qk_head_dim)).to(q.dtype), kc, vc, total)

    def no_k_pe(q, kc, vc, total):
        kz = kc.clone()
        kz[..., LV:] = 0
        return plain(q, kz, vc, total)

    paths = {"kernels": (kernel,) * 3, "plain": (plain,) * 3,
             "mutant: query pre-scale dropped": (no_prescale,) * 3,
             "mutant: k_pe zeroed in the cache": (no_k_pe,) * 3}
    return {k: v for k, v in paths.items() if not k.startswith("mutant") or k in mutants}


LATENT_MUTANTS = ("mutant: query pre-scale dropped", "mutant: k_pe zeroed in the cache")
# (layers, prompt tokens) of each model check: DeepSeek-V2-Lite over a
# long prompt; Qwen3-30B-A3B over the llama check's 300 tokens, the length
# its mutants read at (one key dropped of 1500 moves the logits by ~0.02)
MOE_MODEL_CHECKS = {"deepseek-v2-lite": (2, 1500), "qwen3-30b-a3b": (2, 300)}
# the router bias that pins each MoE layer's top k in the DeepSeek check:
# softmax scores lie in [0, 1], so a bias of 2 on k experts fixes the
# selection (a token whose k-th and (k+1)-th scores lie within the paths'
# bf16 rounding would take other experts on each path, a jump of the
# function that is no kernel's error); the combine weights stay the
# unbiased scores
LATENT_ROUTER_PIN = 2.0


def pin_latent_router(cfg, params, rng):
    import torch

    for lp in params["layers"]:
        if "w_router" in lp:
            bias = torch.zeros(cfg.num_experts, dtype=torch.float32,
                               device=lp["w_router"].device)
            bias[rng.permutation(cfg.num_experts)[:cfg.num_experts_per_tok].tolist()] = (
                LATENT_ROUTER_PIN)
            lp["router_bias"] = bias


def pin_moe_router(cfg, params, rng):
    """Qwen3-MoE's router has no bias: a zero router gives every token
    equal scores, and the tie rule (lowest ids) the same experts on both
    paths."""
    for lp in params["layers"]:
        lp["w_router"].zero_()


def moe_mla_model_checks(torch) -> dict:
    """model_check for DeepSeek-V2-Lite and Qwen3-30B-A3B at full width, cut
    to MOE_MODEL_CHECKS' layers (V2-Lite: one dense layer, one MoE layer),
    routing pinned; the kernel path (latent kernel, or kernels 1-3; the
    grouped experts) against the plain path (plain attention, the float32
    expert loop), with the latent mutants and the llama mutants."""
    from dynamo_tpu_torch.models import mla, moe

    out = {}
    lite = mla.MlaConfig.deepseek_v2_lite()
    for tag, base, weight_sets, paths in (
            ("deepseek-v2-lite", lite, [(pin_latent_router, LATENT_MUTANTS)],
             lambda t, m: latent_attention_paths(torch, t, m, lite.qk_head_dim)),
            ("qwen3-30b-a3b", moe.MoeConfig.qwen3_30b_a3b(), [(pin_moe_router, MODEL_MUTANTS)],
             lambda t, m: attention_paths(torch, t))):
        layers, prompt_len = MOE_MODEL_CHECKS[tag]
        cfg = dataclasses.replace(base, num_layers=layers)
        t0 = time.perf_counter()
        worst, mutants, spread = model_check(torch, f"model {tag} x{layers} layers", cfg,
                                             prompt_len, 400, weight_sets, paths)
        out[tag] = {"worst": worst, "mutants": mutants, "max_logit": spread}
        log(f"model {tag}: {layers} layers at full width, prefill {prompt_len} + 3 decode + a "
            f"2-token ragged step, {len(MODEL_SEEDS)} seeds: kernels vs plain logits relative "
            f"L2 {worst:.4g} at worst (limit {MODEL_REL_TOL}); mutants at least "
            + ", ".join(f"{n[8:]} {r:.4g}" for n, r in mutants.items())
            + f"; max |logit| {spread:.3g} [{time.perf_counter() - t0:.1f} s]")
        gc.collect()
        torch.cuda.empty_cache()
    return out


LATENT_PROMPTS = (100, 700, 1500, 2600, 3300, 4100, 5000, 6000)
# Qwen3-30B-A3B (61 GB at 48 layers) is served at 12 layers, full width:
# its attention path is kernels 1-3 at llama's shape, served at full depth
# on llama3-8b, and its expert path is checked alone at full width. 64
# tokens a request: at 12 layers a request decodes 32 tokens in less than
# the 0.25 s to the next arrival, and kernel 3 (the mixed step) would run
# only when the arrivals happen to overlap
QWEN_SERVE_LAYERS = 12
QWEN_SERVE_TOKENS = 64
LATENT_FORBID = ("decode", "flash_extend", "unified", "decode_int8", "flash_extend_int8",
                 "unified_int8")


def moe_mla_phase(torch, gen, smi: str, _build) -> tuple:
    """DeepSeek-V2-Lite and Qwen3-30B-A3B on the card (module docstring,
    phase 7). Returns (the kernel results by report name, the phase's
    report)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig, param_bytes
    from dynamo_tpu_torch.models import mla, moe, registry
    from dynamo_tpu_torch.ops import cuda_mla

    results, out = {}, {}
    timer = Timer(torch)
    t0 = time.perf_counter()
    latent = check_latent(torch, gen, timer, _build)
    results.update((r["name"], r) for r in latent)
    worst = max(c["max_abs_err"] for c in latent[0]["cases"].values())
    log(f"kernel latent_paged_attention (both forms): max abs err {worst:.3g} over "
        f"{len(latent[0]['cases'])} cases (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}, row "
        f"{KERNEL_ROW_REL}) [{time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    out["experts"] = check_moe_experts(torch, gen, timer)
    log(f"experts on {smi}: " + json.dumps(out["experts"]) +
        f" [{time.perf_counter() - t0:.1f} s]")
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    out["model"] = moe_mla_model_checks(torch)

    errors = ErrorLog()
    # DeepSeek-V2-Lite at all 27 layers on its defaults
    mcfg = mla.MlaConfig.deepseek_v2_lite()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = registry.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    out["load"] = {"s": time.perf_counter() - t0, "param_bytes": param_bytes(params)}
    log(f"deepseek-v2-lite: {mcfg.num_layers} layers, random bf16 weights (seed 0), "
        f"{out['load']['param_bytes'] / 1e9:.2f} GB, loaded in {out['load']['s']:.1f} s")
    eng = TorchEngine(TorchEngineConfig(
        model=mcfg, num_blocks=GPTOSS_BLOCKS, block_size=BS, max_batch_size=8,
        max_context=8192, decode_steps=HZ_STEPS, decode_pipeline=1), params=params)
    r = {**graph_equals_eager(torch, eng, "deepseek-v2-lite", [300, 5000, 2500,
                                                               8192 - HZ_STEPS, 64, 0, 4500,
                                                               17]), **horizon_report(eng)}
    out["graph_equals_eager"] = r
    log(f"horizon graph = eager, deepseek-v2-lite bf16: bit-identical over {r['steps']} steps "
        f"at key {r['key']} ({r['pages_compared']} pages x {r['cache_arrays']} cache arrays); "
        f"eager {r['eager_s'] * 1e3:.1f} ms, replay {r['replay_s'] * 1e3:.1f} ms; graphs "
        f"{r['horizon']}")
    eng.stop()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # the serving run (the kernel's split rows logged)
    serving = {}
    for key in ("bf16",):
        run = asyncio.run(serve_windowed(
            torch, mcfg, "deepseek-v2-lite", LATENT_PROMPTS, 32, split_rows=True,
            params=params, prompt_seed=14, sample_seed=15,
            expect=("latent_narrow", "latent_wide"),
            forbid=LATENT_FORBID, split_module=cuda_mla))
        serving[key] = run
        log(f"serving deepseek-v2-lite {key}: " + json.dumps(run))
        gc.collect()
        torch.cuda.empty_cache()
    run = serving["bf16"]
    if run["launches"]["replayed"]["latent_narrow"] + run["launches"]["replayed"][
            "latent_wide"] <= 0:
        raise AssertionError(f"deepseek-v2-lite: no latent launch through a graph replay: "
                             f"{run['launches']}")
    log(f"serving deepseek-v2-lite on {smi}: {run['requests']} requests of {LATENT_PROMPTS} "
        f"tokens, {run['output_tok_s']:.1f} output tok/s, TTFT median "
        f"{run['ttft_s_median'] * 1e3:.0f} ms (max {run['ttft_s_max'] * 1e3:.0f}), ITL median "
        f"{run['itl_s_median'] * 1e3:.2f} ms (max {run['itl_s_max'] * 1e3:.2f}); "
        f"{run['launches_with_split_rows']} launches split rows ({run['split_rows']} rows); "
        f"graphs {run['horizon']}; launches {run['launches']}; "
        f"peak allocated {run['peak_allocated_bytes'] / 2**30:.2f} GiB")
    out["serving"] = serving
    # decode-heavy traffic: one eager step per tick, and the auto-tuned
    # graphed schedule, on HZ_TRAFFIC_LAYERS
    prompts = horizon_prompts()
    runs = {}
    hz_cfg, hz_params = first_layers(mcfg, params, HZ_TRAFFIC_LAYERS["deepseek-v2-lite"])
    for tag, knobs in (("a", dict(decode_steps=1, decode_pipeline=1)), ("d", {})):
        run, eng = asyncio.run(serve_decode_heavy(
            torch, hz_params, prompts, mcfg=hz_cfg, tokens=GPTOSS_HZ_TOKENS,
            max_context=8192, **knobs))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        runs[tag] = run
        log(f"deepseek-v2-lite decode-heavy ({tag}) on {smi}: schedule {run['schedule']}; "
            f"{run['output_tok_s']:.1f} tok/s, ITL median {run['itl_s_median'] * 1e3:.2f} ms, "
            f"TTFT median {run['ttft_s_median'] * 1e3:.0f} ms; steps {run['steps']}; graphs "
            f"{run['horizon']}; launches {run['launches']}")
    for rq in runs["a"]["requests"]:
        if len(rq["tokens"]) != GPTOSS_HZ_TOKENS or rq["finish"] != "length":
            raise AssertionError(f"deepseek-v2-lite decode-heavy (a): request {rq['i']}: "
                                 f"{len(rq['tokens'])} tokens, {rq['finish']!r}")
    check_same_streams("deepseek-v2-lite decode-heavy (d)", runs["d"], runs["a"], None)
    if runs["d"]["launches"]["replayed"]["latent_narrow"] <= 0:
        raise AssertionError(f"deepseek-v2-lite decode-heavy (d): no latent launch through a "
                             f"graph replay: {runs['d']['launches']}")
    out["schedules"] = {t: {k: v for k, v in r.items() if k != "requests"}
                        for t, r in runs.items()}
    del params, hz_params
    gc.collect()
    torch.cuda.empty_cache()

    # Qwen3-30B-A3B at QWEN_SERVE_LAYERS layers: kernels 1-3 and the experts
    qcfg = dataclasses.replace(moe.MoeConfig.qwen3_30b_a3b(), num_layers=QWEN_SERVE_LAYERS)
    run = asyncio.run(serve_windowed(
        torch, qcfg, "qwen3-30b-a3b", LATENT_PROMPTS, QWEN_SERVE_TOKENS, prompt_seed=16,
        sample_seed=17, expect=("decode", "flash_extend", "unified"),
        forbid=("latent_narrow", "latent_wide")))
    log(f"serving qwen3-30b-a3b x{QWEN_SERVE_LAYERS} layers on {smi}: " + json.dumps(run))
    log(f"serving qwen3-30b-a3b ({QWEN_SERVE_LAYERS} of its 48 layers, full width) on {smi}: "
        f"{run['output_tok_s']:.1f} output tok/s, TTFT median "
        f"{run['ttft_s_median'] * 1e3:.0f} ms, ITL median {run['itl_s_median'] * 1e3:.2f} ms; "
        f"schedule {run['schedule']}; peak allocated "
        f"{run['peak_allocated_bytes'] / 2**30:.2f} GiB")
    out["qwen_serving"] = run
    errors.close()
    if errors.records:
        raise AssertionError(f"ERROR log records: {[r.getMessage() for r in errors.records]}")
    gc.collect()
    torch.cuda.empty_cache()
    return results, out


# ------------------------------------------------------------- phase 8
# vision: the default tower (224 px, 14-px patches: 256 patches, 6 layers
# of width 256) projecting to Llama-3-8B's 4096; 8 staggered requests of
# VIS_TEXT text tokens with VIS_IMAGES images each (256 placeholders an
# image), 32 greedy tokens each
VIS_TEXT = (300, 2000, 700, 1200, 450, 1600, 900, 1800)
VIS_IMAGES = (1, 2, 1, 2, 1, 1, 2, 1)
VIS_TOKENS = 32
# phase 8's frontend part: the committed fixtures (tests/data/) and the
# arrays the reference's decode_image (PIL) made of them at 224 px, stored
# as uint8 levels (the float32 array is levels / 255 exactly); the port's
# decoders must give them exactly (a JPEG tolerance of 0 levels)
VIS_FIXTURES = (("png", "image/png"), ("jpg", "image/jpeg"))
VIS_JPEG_TOL = 0
VIS_FE_TEXT = 400       # text tokens around each fixture image
# phase 8 also times the host's decode at the sizes users send: PNG
# screenshots (1024 x 768, 1920 x 1080) and JPEG photos (1024 x 768, and a
# 12-megapixel phone photo, 4032 x 3024), made from a seed here (smooth
# colour fields + noise of sigma 6 levels) and encoded by synth_png (every
# filter type, a row each in turn) and synth_jpeg (4:2:0, quality 90); a
# PNG must decode to its source exactly, a JPEG to within
# VIS_SYNTH_JPEG_MAE levels on average
VIS_SYNTH_SIZES = (("png", 1024, 768), ("png", 1920, 1080), ("jpg", 1024, 768),
                   ("jpg", 4032, 3024))
VIS_SYNTH_JPEG_MAE = 6.0
# the bf16 tower against the same tower in float32 (CPU): relative L2 of
# the projected features
TOWER_REL_TOL = 3e-2


def to_device(torch, tree, dtype):
    """A parameter tree (dicts, lists, tensors) on the card in ``dtype``."""
    if isinstance(tree, dict):
        return {k: to_device(torch, v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(torch, v, dtype) for v in tree]
    return tree.to("cuda", dtype)


def check_tower(torch, timer) -> dict:
    """The vision tower (plain PyTorch, as the reference's XLA einsums) in
    bf16 on the card against the same weights in float32 on the CPU, and
    its time per image."""
    from dynamo_tpu_torch.models import vision as vis

    cfg32 = vis.VisionConfig(out_hidden_size=4096, dtype=torch.float32)
    cfg = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    p32 = vis.init_params(cfg32, torch.Generator().manual_seed(11), "cpu")
    p = to_device(torch, p32, torch.bfloat16)
    rng = np.random.default_rng(12)
    worst = 0.0
    for _ in range(2):
        img = rng.random((cfg.image_size, cfg.image_size, 3)).astype(np.float32)
        want = vis.encode(p32, cfg32, torch.from_numpy(img))
        x = torch.from_numpy(img).cuda()
        got = vis.encode(p, cfg, x).float().cpu()
        if got.shape != (cfg.num_patches, 4096) or not torch.isfinite(got).all():
            raise AssertionError(f"vision tower: output {tuple(got.shape)} or not finite")
        worst = max(worst, ((got - want).norm() / want.norm()).item())
    if worst > TOWER_REL_TOL:
        raise AssertionError(f"vision tower: bf16 on the card against float32 on the CPU, "
                             f"relative L2 {worst:.4g} (limit {TOWER_REL_TOL})")
    return {"patches": cfg.num_patches, "layers": cfg.num_layers, "width": cfg.hidden_size,
            "rel_l2": worst, "ms_per_image": timer(lambda: vis.encode(p, cfg, x))}


def words_text(tok, rng, n):
    words = [bytes(rng.integers(97, 123, size=rng.integers(2, 9))).decode()
             for _ in range(4000)]
    return tok.encode(" ".join(words[int(i)] for i in rng.integers(0, len(words), size=n)))[:n]


def preq(rid, tokens, n, images=(), logprobs=0, **samp):
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )

    ann = {"images": [{"data": im.tobytes(), "shape": list(im.shape)} for im in images]}
    return PreprocessedRequest(
        request_id=rid, model="smoke", token_ids=list(tokens),
        sampling=SamplingOptions(temperature=samp.pop("temperature", 0.0), logprobs=logprobs,
                                 **samp),
        stop=StopConditions(max_tokens=n), annotations=ann if images else {})


async def run_requests(engine, reqs, delays=None, first=None):
    """Serve ``reqs`` (request i after ``delays[i]`` s); ``first`` is set at
    the first token. Returns each request's tokens, top logprobs, finish,
    cached tokens, TTFT and ITL (the mean gap between its tokens), and the
    wall."""
    from dynamo_tpu_torch.runtime import Context

    stats = [None] * len(reqs)

    async def one(i, req):
        if delays:
            await asyncio.sleep(delays[i])
        t_sub = time.perf_counter()
        stamps, toks, top, cached, finish = [], [], [], None, None
        async for out in engine.generate(req, Context()):
            if out.token_ids:
                stamps.append(time.perf_counter())
                toks.extend(out.token_ids)
                if first is not None:
                    first.set()
            top.extend(out.top_logprobs or [])
            if "cached_tokens" in (out.annotations or {}):
                cached = out.annotations["cached_tokens"]
            finish = out.finish_reason or finish
        stats[i] = {"i": i, "tokens": toks, "top": top, "finish": finish, "cached": cached,
                    "ttft_s": stamps[0] - t_sub if stamps else None,
                    "itl_s": ((stamps[-1] - stamps[0]) / (len(toks) - 1)
                              if len(toks) > 1 else None)}

    t0 = time.perf_counter()
    await asyncio.gather(*(one(i, r) for i, r in enumerate(reqs)))
    return stats, time.perf_counter() - t0


def latency_summary(stats, wall) -> dict:
    ttft = sorted(s["ttft_s"] for s in stats)
    itl = sorted(s["itl_s"] for s in stats if s["itl_s"] is not None)
    return {"wall_s": wall, "output_tok_s": sum(len(s["tokens"]) for s in stats) / wall,
            "ttft_s_median": statistics.median(ttft), "ttft_s_max": ttft[-1],
            "itl_s_median": statistics.median(itl), "itl_s_max": itl[-1]}


def vision_phase(torch, smi: str, timer) -> dict:
    """Vision prompts on the card (module docstring, phase 8)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.models import registry
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.models.vision import IMAGE_TOKEN_ID, VisionConfig

    out = {"tower": check_tower(torch, timer)}
    t = out["tower"]
    log(f"vision tower on {smi}: {t['patches']} patches, {t['layers']} layers of width "
        f"{t['width']} -> 4096: bf16 vs float32 relative L2 {t['rel_l2']:.4g} (limit "
        f"{TOWER_REL_TOL}); {t['ms_per_image']:.4f} ms per image")
    mcfg = LlamaConfig.llama3_8b()
    params = registry.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    vcfg = VisionConfig(out_hidden_size=mcfg.hidden_size)
    P = vcfg.num_patches
    tok = ByteTokenizer()
    rng = np.random.default_rng(21)
    reqs, images = [], []
    for i, (n, k) in enumerate(zip(VIS_TEXT, VIS_IMAGES)):
        text = words_text(tok, rng, n)
        imgs = [rng.random((vcfg.image_size, vcfg.image_size, 3)).astype(np.float32)
                for _ in range(k)]
        cuts = [n // 4, n // 2][:k]
        toks, prev = [], 0
        for c in cuts:
            toks += text[prev:c] + [IMAGE_TOKEN_ID] * P
            prev = c
        reqs.append(preq(f"v{i}", toks + text[prev:], VIS_TOKENS, imgs))
        images.append(imgs)
    t0 = time.perf_counter()
    engine = TorchEngine(TorchEngineConfig(model=mcfg, num_blocks=2048, block_size=BS,
                                           max_batch_size=8, max_context=4096, seed=0,
                                           vision=vcfg), params=params)
    torch.cuda.synchronize()
    ready_s = time.perf_counter() - t0
    short = words_text(tok, rng, 120)
    black, white = (np.full((vcfg.image_size, vcfg.image_size, 3), v, np.float32)
                    for v in (0.0, 1.0))
    contrast_reqs = [preq(f"c{v}", short[:60] + [IMAGE_TOKEN_ID] * P + short[60:], VIS_TOKENS,
                          [im]) for v, im in enumerate((black, white))]
    plain = preq("text", words_text(tok, rng, 500), VIS_TOKENS)

    async def serve_all():
        """The 8 staggered requests, request 0 again, the contrasting
        images and the text-only prompt, each after the last (one event
        loop: the engine's loop task lives in it)."""
        reset_launches()
        stats, wall = await run_requests(engine, reqs, [0.25 * i for i in range(8)])
        launches = read_launches()
        cache = engine.encoder_cache.stats()
        hits = engine.encoder_cache.hits
        (again,), _ = await run_requests(engine, [reqs[0]])
        again["encoder_hits"] = engine.encoder_cache.hits - hits
        contrast, _ = await run_requests(engine, contrast_reqs)
        (on_vision,), _ = await run_requests(engine, [plain])
        fe = await vision_frontend(engine, vcfg)
        return stats, wall, launches, cache, again, contrast, on_vision, fe

    try:
        (stats, wall, launches, cache, again, contrast, on_vision,
         out["frontend"]) = asyncio.run(serve_all())
        run = {"ready_s": ready_s, "prompt_tokens": [len(r.token_ids) for r in reqs],
               "images": list(VIS_IMAGES), **latency_summary(stats, wall),
               "steps": dict(engine.step_counts), **horizon_report(engine),
               "encoder_cache": cache, "launches": launches}
        for s in stats:
            if len(s["tokens"]) != VIS_TOKENS or s["finish"] != "length" or s["cached"] != 0:
                raise AssertionError(f"vision request {s['i']}: {len(s['tokens'])} tokens, "
                                     f"finish {s['finish']!r}, cached {s['cached']}")
        for name in ("flash_extend", "decode"):
            if launches[name] <= 0:
                raise AssertionError(f"vision: the {name} kernel never launched")
        if launches["replayed"]["decode"] <= 0 or run["horizon"]["replays"] <= 0:
            raise AssertionError("vision: no decode launch came from a horizon replay")
        if engine.step_counts["mixed"]:
            raise AssertionError(f"vision: a mixed step ran: {engine.step_counts}")
        if run["encoder_cache"]["misses"] != sum(VIS_IMAGES):
            raise AssertionError(f"vision: encoder cache {run['encoder_cache']}")
        # request 0 again: its image from the encoder cache, no prefix hit
        if again["encoder_hits"] != len(images[0]) or again["cached"] != 0:
            raise AssertionError(f"vision repeat: {again['encoder_hits']} encoder cache "
                                 f"hits, cached tokens {again['cached']}")
        run["repeat"] = {"cached_tokens": again["cached"], "encoder_hits": again["encoder_hits"],
                         "same_tokens_as_in_the_batch": again["tokens"] == stats[0]["tokens"]}
        # contrasting images change the stream
        if contrast[0]["tokens"] == contrast[1]["tokens"]:
            raise AssertionError("vision: a black and a white image give the same stream")
        # a text-only prompt: the text engine's stream, bit for bit
        schedule = dict(decode_steps=engine.cfg.decode_steps,
                        decode_pipeline=engine.cfg.decode_pipeline)
    finally:
        engine.stop()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    text_engine = TorchEngine(TorchEngineConfig(model=mcfg, num_blocks=2048, block_size=BS,
                                                max_batch_size=8, max_context=4096, seed=0,
                                                **schedule), params=params)
    try:
        (on_text,), _ = asyncio.run(run_requests(text_engine, [plain]))
    finally:
        text_engine.stop()
    if on_vision["tokens"] != on_text["tokens"] or len(on_text["tokens"]) != VIS_TOKENS:
        raise AssertionError("vision: a text-only prompt streams other tokens on the vision "
                             "engine than on a text engine with the same weights")
    run["text_only_bit_equal"] = True
    out["serving"] = run
    log(f"vision serving on {smi}: {len(reqs)} requests of {run['prompt_tokens']} tokens "
        f"({sum(VIS_IMAGES)} images), {run['output_tok_s']:.1f} output tok/s, TTFT median "
        f"{run['ttft_s_median'] * 1e3:.0f} ms (max {run['ttft_s_max'] * 1e3:.0f}), ITL "
        f"median {run['itl_s_median'] * 1e3:.2f} ms (max {run['itl_s_max'] * 1e3:.2f}); "
        f"steps {run['steps']}; encoder cache {run['encoder_cache']}; graphs "
        f"{run['horizon']}; launches {run['launches']}; repeat {run['repeat']}; "
        "contrasting images differ; text-only stream equals the text engine's")
    fe = out["frontend"]
    log(f"vision through the frontend on {smi}: the committed PNG and JPEG decoded by the "
        f"port's own decoders to the reference's (PIL) arrays, max level difference "
        + ", ".join(f"{k} {v['max_level_diff']}" for k, v in fe["fixtures"].items())
        + f" (JPEG tolerance {VIS_JPEG_TOL}); host decode + resize to 224 px "
        + ", ".join(f"{k} {v['decode_ms']:.2f} ms ({v['bytes']} B, {v['size']})"
                    for k, v in fe["fixtures"].items())
        + "; at users' sizes (seeded, encoded here) decode + resize "
        + ", ".join(f"{k} {v['decode_s'] * 1e3:.1f} + {v['resize_s'] * 1e3:.1f} ms "
                    f"({v['bytes']} B, mean level error {v['mean_level_err']:.3f})"
                    for k, v in fe["synth"].items())
        + f"; {len(fe['streams'])} chat requests with a data: URL image each through "
        f"register_llm + the port's frontend stream the in-process greedy text "
        f"({fe['tokens']} tokens each); frontend TTFT "
        + ", ".join(f"{t * 1e3:.0f} ms" for t in fe["ttft_s"])
        + f"; kernels in the frontend run {fe['launches']}; {fe['seconds']:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def synth_image(width: int, height: int, seed: int = 0) -> np.ndarray:
    """A seeded uint8 RGB image: smooth colour fields plus noise of sigma 6
    levels (a photo's texture, as far as an encoder's work goes)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(x / 97 + c) * np.cos(y / 131 - c) for c in range(3)], -1)
    img += rng.normal(0, 6, (height, width, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    import struct
    import zlib

    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def synth_png(img: np.ndarray) -> bytes:
    """uint8 RGB -> an 8-bit RGB PNG whose rows take the five filter types
    in turn (row y filter y % 5), so that the decoder's Average and Paeth
    paths carry a fifth of the rows each."""
    import struct
    import zlib

    h, w, ch = img.shape
    x = img.reshape(h, w * ch).astype(np.int16)
    a = np.zeros_like(x)
    a[:, ch:] = x[:, :-ch]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, ch:] = x[:-1, :-ch]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    ft = (np.arange(h) % 5)[:, None]
    pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4], [a, b, (a + b) >> 1, paeth], 0)
    rows = np.concatenate([ft.astype(np.uint8), ((x - pred) & 0xFF).astype(np.uint8)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _png_chunk(b"IEND", b""))


_JPEG_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_JPEG_CHROMA_Q = np.full(64, 99)
_JPEG_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]


def synth_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """uint8 RGB -> a baseline JFIF JPEG, 4:2:0, the standard quantisation
    tables at ``quality`` (libjpeg's scaling). Its Huffman tables give every
    DC size a 4-bit code and every AC symbol an 8-bit one: a valid file a
    little larger than an optimised one, with the same symbols to decode.
    Vectorised over blocks and codes (no Python loop per block)."""
    import struct

    from dynamo_tpu_torch.llm.image_codecs import _ZIGZAG

    h, w, _ = img.shape
    H, W = -(-h // 16) * 16, -(-w // 16) * 16
    x = np.pad(img, ((0, H - h), (0, W - w), (0, 0)), mode="edge").astype(np.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    planes[1:] = [p.reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3)) for p in planes[1:]]
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qts = [np.clip((q * scale + 50) // 100, 1, 255) for q in (_JPEG_LUMA_Q, _JPEG_CHROMA_Q)]
    n = np.arange(8)
    dct = (np.sqrt(np.where(n == 0, 1 / 8, 2 / 8))[:, None] * np.cos(
        (2 * n[None, :] + 1) * n[:, None] * np.pi / 16)).astype(np.float32)
    coefs = []
    for i, p in enumerate(planes):
        ph, pw = p.shape
        blk = (p - 128).reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
        # dct @ block @ dct.T for every block: one product with kron(dct, dct)
        f = blk @ np.kron(dct, dct).T                       # [block, u * 8 + v]
        q = np.rint(f.reshape(ph // 8, pw // 8, 64) / qts[min(i, 1)]).astype(np.int64)
        coefs.append(q[..., _ZIGZAG])                      # zigzag order
    # scan order: per 16 x 16 MCU, the four luma blocks, then Cb, then Cr
    my, mx = H // 16, W // 16
    y4 = coefs[0].reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
    z = np.concatenate([y4, coefs[1][:, :, None], coefs[2][:, :, None]], axis=2)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    z = z.reshape(-1, 64)
    nb = len(z)
    dc = z[:, 0].copy()
    for k in range(3):
        sel = np.nonzero(comp == k)[0]
        dc[sel] = np.diff(z[sel, 0], prepend=0)

    def size_and_bits(v):
        mag = np.abs(v)
        s = np.zeros_like(mag)
        for bit in range(16):
            s += mag >= (1 << bit)
        return s, np.where(v >= 0, v, v + (1 << s) - 1)

    # events: (order key, code and extra bits, bit length)
    keys, vals, lens = [], [], []
    s, extra = size_and_bits(dc)
    keys.append(np.arange(nb) * 256)
    vals.append((s << s) | extra)                          # DC code = size, 4 bits
    lens.append(4 + s)
    blk_i, k = np.nonzero(z[:, 1:])
    k = k + 1
    first = np.ones(len(k), bool)
    first[1:] = blk_i[1:] != blk_i[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    zrl = run // 16
    zi = np.repeat(np.arange(len(k)), zrl)
    keys.append(blk_i[zi] * 256 + 2 * k[zi] - 1)
    vals.append(np.full(len(zi), 161))                     # AC code = symbol index
    lens.append(np.full(len(zi), 8))
    s, extra = size_and_bits(z[blk_i, k])
    # AC symbol index: EOB 0, (r, s) r * 10 + s, ZRL 161
    idx = (run % 16) * 10 + s
    keys.append(blk_i * 256 + 2 * k)
    vals.append((idx << s) | extra)
    lens.append(8 + s)
    last = np.zeros(nb, np.int64)
    ends = np.nonzero(np.append(blk_i[1:] != blk_i[:-1], True))[0]   # blk_i ascends
    last[blk_i[ends]] = k[ends]
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 256 + 255)
    vals.append(np.zeros(len(eob), np.int64))
    lens.append(np.full(len(eob), 8))
    order = np.argsort(np.concatenate(keys), kind="stable")
    vals = np.concatenate(vals)[order].astype(np.int64)
    lens = np.concatenate(lens)[order].astype(np.int64)
    # each event's bits left-aligned in a 32-bit word, its first lens kept
    words = (vals << (32 - lens)).astype(">u4")
    bits = np.unpackbits(words.view(np.uint8).reshape(-1, 4), axis=1)
    bits = bits[np.arange(32) < lens[:, None]]
    data = np.packbits(np.concatenate([bits, np.ones(-len(bits) % 8, np.uint8)]))
    data = np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0).astype(np.uint8)

    def seg(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    ac_syms = bytes([0x00] + [(r << 4) | s for r in range(16) for s in range(1, 11)] + [0xF0])
    out = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t, q in enumerate(qts):
        out += seg(0xDB, bytes([t]) + bytes(q[_ZIGZAG].astype(np.uint8)))
    out += seg(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    out += seg(0xC4, bytes([0x00] + [0, 0, 0, 12] + [0] * 12) + bytes(range(12)))
    out += seg(0xC4, bytes([0x10] + [0] * 7 + [len(ac_syms)] + [0] * 8) + ac_syms)
    out += seg(0xDA, bytes([3, 1, 0x00, 2, 0x00, 3, 0x00, 0, 63, 0]))
    return out + data.tobytes() + b"\xff\xd9"


async def vision_frontend(engine, vcfg) -> dict:
    """Phase 8's frontend part, in the engine's own event loop: the
    committed PNG and JPEG fixtures through the port's decoders (held to
    the reference's arrays, timed on this host), seeded images at users'
    sizes (VIS_SYNTH_SIZES) encoded here and decoded and resized by the
    port (timed apart), then the fixtures as data: URLs in chat
    requests, first in-process (the frontend's preprocessor, then the
    Backend over the engine) and then through ``register_llm`` and the
    port's frontend (runtime, model watcher, HTTP service): the greedy
    streams must be equal."""
    import base64

    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
    from dynamo_tpu_torch.llm.http.service import HttpService
    from dynamo_tpu_torch.llm.image_codecs import decode_rgb, resize_bilinear
    from dynamo_tpu_torch.llm.media import decode_image
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols import openai
    from dynamo_tpu_torch.llm.serve import register_llm
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.runtime import Context, DistributedRuntime, MemKVStore, RuntimeConfig

    t_phase = time.perf_counter()
    data = os.path.join(HERE, "tests", "data")
    out = {"fixtures": {}}
    urls = []
    for name, mime in VIS_FIXTURES:
        with open(os.path.join(data, f"vision_fixture.{name}"), "rb") as f:
            raw = f.read()
        url = f"data:{mime};base64,{base64.b64encode(raw).decode()}"
        decode_image(url, vcfg.image_size)          # warm
        t0 = time.perf_counter()
        got = decode_image(url, vcfg.image_size)
        decode_ms = (time.perf_counter() - t0) * 1e3
        want = np.load(os.path.join(data, f"vision_fixture_{name}_{vcfg.image_size}.npy"))
        diff = int(np.abs(np.rint(got * 255).astype(int) - want.astype(int)).max())
        exact = np.array_equal(got, want.astype(np.float32) / 255.0)
        tol = 0 if name == "png" else VIS_JPEG_TOL
        if diff > tol or (name == "png" and not exact):
            raise AssertionError(f"vision: the port decodes the committed {name} to levels "
                                 f"{diff} from the reference's (tolerance {tol})")
        out["fixtures"][name] = {"max_level_diff": diff, "exact": exact,
                                 "decode_ms": decode_ms, "bytes": len(raw),
                                 "size": f"{vcfg.image_size} px"}
        urls.append(url)
    # users' sizes: decode (decode_image's decode_rgb) and resize timed apart
    out["synth"] = {}
    for name, w, h in VIS_SYNTH_SIZES:
        img = synth_image(w, h, seed=w)
        enc = synth_png if name == "png" else synth_jpeg
        t0 = time.perf_counter()
        raw = enc(img)
        encode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rgb = decode_rgb(raw)
        decode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resize_bilinear(rgb, vcfg.image_size, vcfg.image_size)
        resize_s = time.perf_counter() - t0
        mae = float(np.abs(rgb.astype(np.int16) - img).mean()) if rgb.shape == img.shape \
            else float("inf")
        if (name == "png" and not np.array_equal(rgb, img)) or mae > VIS_SYNTH_JPEG_MAE:
            raise AssertionError(f"vision: the port decodes a {w} x {h} {name} to "
                                 f"{rgb.shape}, mean level error {mae:.3f}")
        out["synth"][f"{name} {w}x{h}"] = {
            "bytes": len(raw), "decode_s": decode_s, "resize_s": resize_s,
            "encode_s": encode_s, "mean_level_err": mae}
        del img, rgb
    tok = ByteTokenizer()
    rng = np.random.default_rng(31)
    card = ModelDeploymentCard(name="vision", tokenizer="byte", context_length=4096,
                               image_tokens=vcfg.num_patches, image_size=vcfg.image_size,
                               image_token_id=engine.cfg.image_token_id)
    bodies = []
    for url in urls:
        text = tok.decode(words_text(tok, rng, VIS_FE_TEXT))
        bodies.append(dict(model=card.name, max_tokens=VIS_TOKENS, temperature=0.0,
                           ignore_eos=True, messages=[{"role": "user", "content": [
                               {"type": "text", "text": text[:VIS_FE_TEXT // 2]},
                               {"type": "image_url", "image_url": {"url": url}},
                               {"type": "text", "text": text[VIS_FE_TEXT // 2:]}]}]))
    # in-process: the frontend's preprocessing, then the Backend on the engine
    pre = OpenAIPreprocessor(card, tok)
    backend = Backend(engine, tok)
    want_streams = []
    for body in bodies:
        req = pre.preprocess_chat(openai.ChatCompletionRequest.from_obj(body))
        items = [o async for o in backend.generate(req, Context())]
        want_streams.append(("".join(o.get("text") or "" for o in items),
                             sum(len(o.get("token_ids") or []) for o in items)))
    # through register_llm and the port's frontend
    store = MemKVStore()
    cfg = RuntimeConfig(store="mem", event_plane="inproc", lease_ttl_s=10.0)
    rts = [await DistributedRuntime(cfg, store=store).start() for _ in range(2)]
    served = await register_llm(rts[0], engine, card, tokenizer=tok)
    manager = ModelManager()
    watcher = await ModelWatcher(rts[1], manager).start()
    service = HttpService(manager, host="127.0.0.1", port=0)
    await service.start()
    try:
        for _ in range(200):
            pipe = manager.get(card.name)
            if pipe is not None and pipe.client.instances:
                break
            await asyncio.sleep(0.05)
        # one at a time, as in-process (another batch mix could flip a bf16
        # near-tie)
        reset_launches()
        stats, streamed = [], []
        for b in bodies:
            t_sub = time.perf_counter()
            status, events = await http_call(service.port, "POST", "/v1/chat/completions",
                                             dict(b, stream=True,
                                                  stream_options={"include_usage": True}))
            if status != 200:
                raise AssertionError(f"vision through the frontend: HTTP {status}: {events}")
            stats.append(fe_stream_stats(t_sub, events, True))
            streamed.append("".join((e["choices"][0].get("delta") or {}).get("content") or ""
                                    for _, e in events if e != "[DONE]" and e["choices"]))
        out["launches"] = read_launches()
        texts = []
        for body in bodies:
            status, reply = await http_call(service.port, "POST", "/v1/chat/completions",
                                            body)
            if status != 200:
                raise AssertionError(f"vision through the frontend: HTTP {status}: {reply}")
            texts.append(reply["choices"][0]["message"]["content"])
    finally:
        await service.stop()
        await watcher.stop()
        await served.stop()
        for rt in rts:
            await rt.shutdown()
    for k, ((want_text, want_n), got_text, got_stream, st) in enumerate(
            zip(want_streams, texts, streamed, stats)):
        if (got_text != want_text or got_stream != want_text or st["tokens"] != want_n
                or want_n != VIS_TOKENS):
            raise AssertionError(f"vision request {k} through the frontend: {st['tokens']} "
                                 f"tokens streamed, text {got_stream[:60]!r} streamed and "
                                 f"{got_text[:60]!r} whole; in-process {want_n} tokens, "
                                 f"{want_text[:60]!r}")
    for name in ("flash_extend", "decode"):
        if out["launches"][name] <= 0:
            raise AssertionError(f"vision through the frontend: the {name} kernel never "
                                 "launched")
    out["streams"] = [t[:40] for t, _ in want_streams]
    out["tokens"] = VIS_TOKENS
    out["ttft_s"] = [st["ttft_s"] for st in stats]
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------- phase 9
# kernel 3 on verify rows: 8 rows of q_len = spec_k + 1 = 5 at llama
# shapes over 128-4096 keys
VERIFY_LENS = (128, 700, 1500, 2100, 2800, 3300, 3900, 4096)
VERIFY_Q = 5
SPEC_K = 4
SPEC_TOKENS = 128
# the tie rule: a spec stream may leave the plain one only where its token
# is among the plain run's top logprobs within this many bf16 spacings
TIE_SPACINGS = 4
LATE_PROMPT = 1500


def check_verify(torch, gen, timer, int8=False) -> dict:
    """Kernel 3 on verify rows (``cuda_unified.verify_attention``, as the
    spec body calls it) against its plain versions, the split counts the
    kernel wrote against the plain split plan, a plain merge without each
    row's last split (must fail), and its time against its bound and SDPA
    over the gathered context with each row's causal-tail mask."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_unified

    lens, n, B = list(VERIFY_LENS), VERIFY_Q, len(VERIFY_LENS)
    pages = sum(-(-sl // BS) for sl in lens)
    kc, vc, tables = paged_case(torch, gen, lens, num_blocks=pages + 64, int8=int8)
    q = torch.randn(B, n, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    i32 = dict(dtype=torch.int32, device="cuda")
    total = torch.tensor(lens, **i32)
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    bound_kw = dict(max_seq_len=max(lens))
    tag = "verify rows" + (" int8" if int8 else "")
    cuda_unified.split_log = []
    try:
        got = cuda_unified.verify_attention(q, kc, vc, tables, total, active, **bound_kw)
        (grid, n_dev), = cuda_unified.split_log
    finally:
        cuda_unified.split_log = None
    starts = torch.arange(B, **i32) * n
    qlens = torch.full((B,), n, **i32)
    flat = (q.reshape(B * n, H, D), kc, vc, tables, starts, qlens, total)
    err = compare(torch, got.reshape(B * n, H, D), att.ragged_paged_attention(*flat), tag)
    err = max(err, compare(torch, got, att.paged_extend_attention(
        q, kc, vc, tables, total - n, total), tag + " (batched plain form)"))
    S, _ = cuda_unified.split_shape(H, KVH, n, max(lens))
    n_kernel = n_dev.tolist() if n_dev is not None else [0] * B
    n_plain = [att.split_plan(n, sl, 0, cuda_unified.SPLIT_KEYS, cuda_unified.KEY_STEP, S)[2]
               for sl in lens]
    if n_kernel != n_plain:
        raise AssertionError(f"{tag}: the kernel split its rows {n_kernel}, the plain split "
                             f"plan {n_plain}")
    acc, m, l, ns = att.attention_partials(*flat, split_keys=cuda_unified.SPLIT_KEYS,
                                           align=cuda_unified.KEY_STEP, max_splits=S)
    for r, c in enumerate(ns.tolist()):
        if c >= 2:
            l[r, c - 1] = 0.0
    wrong = att.merge_attention_partials(acc, m, l, ns, starts, qlens,
                                         got.reshape(B * n, H, D).clone())
    try:
        compare(torch, got.reshape(B * n, H, D), wrong, tag + " against its drop-last-split "
                "mutant")
    except AssertionError:
        pass
    else:
        raise AssertionError(f"{tag}: a merge without the last split passes the compare")
    del acc, m, l, wrong
    T = max(lens)
    kp = torch.zeros(B, H, T, D, dtype=torch.bfloat16, device="cuda")
    vp = torch.zeros_like(kp)
    mask = torch.zeros(B, 1, n, T, dtype=torch.bool, device="cuda")
    for r, sl in enumerate(lens):
        kp[r, :, :sl], vp[r, :, :sl] = expand_kv(torch, kc, vc, tables[r], sl)
        qpos = torch.arange(sl - n, sl, device="cuda")
        mask[r, 0] = torch.arange(T, device="cuda")[None, :] <= qpos[:, None]
    ql = q.transpose(1, 2).contiguous()                         # [B, H, n, D]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = sum(sl - n + i + 1 for sl in lens for i in range(n))
    b, by = bound(2 * 2 * B * n * H * D + sum(kv_bytes(sl, KVH, int8) for sl in lens)
                  + 4 * (3 * B + pages), 4 * pairs * H * D)
    # the wrapper's host work (row arrays, two launches) outlasts the
    # default wait: at it, this call read 0.097-0.198 ms between calls
    ms = timer(lambda: cuda_unified.verify_attention(q, kc, vc, tables, total, active,
                                                     **bound_kw), busy=2_000_000)
    out = {
        "name": "ragged_paged_attention_verify" + ("_int8" if int8 else ""),
        "route": "cuda", "source": "dynamo_tpu_torch/csrc/unified_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas_unified.py:93",
        "shape": f"verify rows: B={B} q_len={n} seq_lens={lens} h={H} kvh={KVH} d={D} "
                 f"bs={BS} " + ("int8 cache + f32 scales" if int8 else "bf16")
                 + " (cuda_unified.verify_attention: the kernel and its split-K merge; "
                   "library: SDPA over the gathered context, causal-tail mask per row)",
        "max_abs_err": err, "grid": grid, "splits_per_row": n_kernel,
        "drop_last_split_mutant_fails": True, "ms": ms,
        "plain_ms": timer(lambda: att.ragged_paged_attention(*flat), reps=5),
        "library_ms": timer(lambda: sdpa(ql, kp, vp, attn_mask=mask)),
        "bound_ms": b, "bound_by": by,
    }
    out["achieved"] = (f"{b / ms * HBM_BYTES_S / 1e12:.2f} TB/s" if by == "bytes"
                       else f"{b / ms * BF16_FLOPS_S / 1e12:.0f} TFLOP/s")
    log(f"kernel {out['name']}: max abs err {err:.3g}; {ms:.4f} ms kernel, "
        f"{out['plain_ms']:.4f} ms plain, {out['library_ms']:.4f} ms SDPA, bound {b:.4f} ms "
        f"({by}), {out['achieved']}; grid {grid}, splits per row {n_kernel} (the kernel's "
        "count); the drop-last-split merge fails the compare")
    return out


def random_spec_state(torch, engine, lens, seed):
    """Random main and draft caches (every page) and a spec state over
    ``lens`` (0: an inactive row) on distinct pages, all rows greedy."""
    hz, c = engine._horizon, engine.cfg
    hs = hz.state
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for cache in engine.k_caches + engine.v_caches + engine.draft_k_caches \
            + engine.draft_v_caches:
        if hasattr(cache, "scale"):
            cache.data.copy_(torch.randint(-127, 128, cache.data.shape, generator=gen,
                                           device="cuda", dtype=torch.int8))
            cache.scale.copy_(torch.rand(cache.scale.shape, generator=gen, device="cuda") / 50)
        else:
            cache.normal_(generator=gen)
    B, adv = c.max_batch_size, engine._spec_rounds * c.spec_k
    tables = torch.zeros(B, c.max_blocks_per_seq, dtype=torch.int32)
    nxt = 1
    for r, L in enumerate(lens):
        if L:
            k = -(-(L + adv) // c.block_size)
            tables[r, :k] = torch.arange(nxt, nxt + k, dtype=torch.int32)
            nxt += k
    lens_t = torch.tensor(lens, dtype=torch.int32)
    hs.tokens.copy_(torch.randint(0, engine.mcfg.vocab_size, (B,)))
    hs.seq_lens.copy_(lens_t)
    hs.steps.copy_(torch.arange(B) * 3)
    hs.tables.copy_(tables)
    hs.active.copy_(lens_t > 0)
    return hz.key(max(lens) + adv, False)[0]


def spec_graph_equals_eager(torch, engine, tag: str, lens) -> dict:
    """One spec horizon from a random state, eager on cloned main and
    draft caches, then its graph replayed on the originals: packed
    results, carry and every main and draft page but scratch block 0 must
    be bit-identical."""
    hz = engine._horizon
    hs = hz.state
    key = random_spec_state(torch, engine, lens, seed=9)
    carry0 = hs.carry.dev.clone()
    names = ("k_caches", "v_caches", "draft_k_caches", "draft_v_caches")
    orig = {n: getattr(engine, n) for n in names}

    def clone(c):
        return type(c)(c.data.clone(), c.scale.clone()) if hasattr(c, "scale") else c.clone()

    for n in names:
        setattr(engine, n, [clone(c) for c in orig[n]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine._spec_multi(hs, key)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager = (hs.spec_packed.clone(), hs.carry.dev.clone(),
             cache_arrays(sum((getattr(engine, n) for n in names), [])))
    for n in names:
        setattr(engine, n, orig[n])
    hs.carry.dev.copy_(carry0)
    graph, _ = hz.spec_graphs[key]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    graphed = (hs.spec_packed, hs.carry.dev,
               cache_arrays(sum((getattr(engine, n) for n in names), [])))
    for name, a, b in (("packed results", eager[0], graphed[0]), ("carry", eager[1], graphed[1])):
        if not torch.equal(a, b):
            raise AssertionError(f"spec {tag}: graph replay's {name} differ from the eager "
                                 "spec horizon's")
    pages = 0
    for a, b in zip(eager[2], graphed[2]):
        if not torch.equal(a[1:], b[1:]):
            raise AssertionError(f"spec {tag}: a main or draft page differs between the "
                                 "graph replay and the eager spec horizon")
        pages += a.shape[0] - 1
    adv = hs.spec_packed[:, :, 0][:, hs.active]
    if not ((adv >= 1) & (adv <= engine.cfg.spec_k)).all():
        raise AssertionError(f"spec {tag}: advances outside [1, k]: {adv.tolist()}")
    return {"key": key, "lens": list(lens), "rounds": hs.spec_packed.shape[0],
            "advances": adv.sum(0).tolist(), "eager_s": eager_s, "replay_s": replay_s,
            "pages_compared": pages, "cache_arrays": len(eager[2]), "bit_identical": True}


def bf16_spacing(x: float) -> float:
    """The gap between neighbouring bf16 numbers at ``x`` (8 significant bits)."""
    import math

    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def plain_logits(torch, params, mcfg, ids):
    """The last position's float32 logits of ``ids`` through any family's
    model with plain causal attention (a check, outside the served path)."""
    from dynamo_tpu_torch.models import registry
    from dynamo_tpu_torch.ops import attention as att

    with torch.inference_mode():
        t = torch.tensor(ids, device="cuda")
        hidden = registry.forward_fn(mcfg)(
            params, mcfg, t, torch.arange(len(ids), device="cuda"),
            lambda q, k, v, i, **kw: att.causal_attention(q, k, v, **kw))
        return registry.lm_logits_fn(mcfg)(params, mcfg, hidden[-1:])[0]


def tie_rule(torch, tag, run, plain, prompts, params, mcfg) -> list:
    """Each spec stream equals the plain one up to its first difference;
    there the spec token must be among the plain run's top logprobs, its
    logprob within TIE_SPACINGS bf16 spacings (at the larger of the two
    logits, from plain_logits) of the plain token's. Returns the gaps
    found."""
    gaps = []
    for r, p, prompt in zip(run["requests"], plain["requests"], prompts):
        a, b = r["tokens"], p["tokens"]
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            if len(a) != len(b):
                raise AssertionError(f"{tag}: request {r['i']} streamed {len(a)} tokens, the "
                                     f"plain run {len(b)}")
            continue
        top = p["top"][j]
        logits = plain_logits(torch, params, mcfg, list(prompt) + b[:j])
        larger = max(float(logits[a[j]]), float(logits[b[j]]))
        if a[j] not in top:
            raise AssertionError(
                f"{tag}: request {r['i']} token {j}: {a[j]} is not among the plain run's top "
                f"logprobs {top}; its plain logit is {float(logits[b[j]] - logits[a[j]]):.4g} "
                f"below the plain token's ({TIE_SPACINGS} bf16 spacings at logit {larger:.4g}: "
                f"{TIE_SPACINGS * bf16_spacing(larger):.4g})")
        gap = top[b[j]] - top[a[j]]
        limit = TIE_SPACINGS * bf16_spacing(larger)
        gaps.append({"request": r["i"], "index": j, "gap": gap, "limit": limit,
                     "larger_logit": larger})
        log(f"  {tag}: request {r['i']} leaves the plain stream at token {j}: logprob gap "
            f"{gap:.4g} (limit {TIE_SPACINGS} bf16 spacings at logit {larger:.4g}: "
            f"{limit:.4g})")
        if gap > limit:
            raise AssertionError(f"{tag}: request {r['i']} token {j}: gap {gap:.4g} beyond "
                                 f"{limit:.4g}")
    return gaps


def verify_write_ms(torch, mcfg) -> dict:
    """Device ms of one verify's KV writes inside a graph (k + 1 plain
    decode writes of K and V per layer, every layer, 8 rows) on bf16 and
    on int8 caches."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops.quant import QuantizedKV

    B, L, nb = 8, mcfg.num_layers, 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    shape = (nb, BS, mcfg.num_kv_heads, mcfg.head_dim)
    bf16 = [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2 * L)]
    int8 = [QuantizedKV(torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                      dtype=torch.int8),
                        torch.rand(shape[0], shape[2], generator=gen, device="cuda") / 50)
            for _ in range(2 * L)]
    k = torch.randn(B, SPEC_K + 1, mcfg.num_kv_heads, mcfg.head_dim, generator=gen,
                    device="cuda").to(torch.bfloat16)
    blocks = torch.arange(1, B + 1, device="cuda") * 5
    offs = torch.arange(B, device="cuda") % 8

    def writes(caches):
        for li in range(L):
            for s in range(SPEC_K + 1):
                att.write_decode_kv(caches[2 * li], caches[2 * li + 1], k[:, s], k[:, s],
                                    blocks, offs + s)

    return {"bf16_ms": graph_ms(torch, lambda: writes(bf16)),
            "int8_ms": graph_ms(torch, lambda: writes(int8)), "layers": L,
            "writes_per_layer": SPEC_K + 1}


def spec_parts_ms(torch, engine, lens) -> dict:
    """Device ms inside a graph of one round's parts on ``engine``'s spec
    state (random caches): the k draft steps and the verify (KV writes,
    main forward over the k + 1 candidates, accept)."""
    hs = engine._horizon.state
    key = random_spec_state(torch, engine, lens, seed=10)
    drafts = engine._spec_draft(hs, hs.tokens, hs.seq_lens, key)
    return {"draft_ms": graph_ms(torch, lambda: engine._spec_draft(
                hs, hs.tokens, hs.seq_lens, key), reps=20),
            "verify_ms": graph_ms(torch, lambda: engine._spec_verify(
                hs, hs.tokens, hs.seq_lens, drafts, key, 0), reps=20)}


async def serve_late_arrival(torch, params, prompts, late, mcfg):
    """Perfect-draft spec serving of ``prompts`` (queued at once,
    SPEC_TOKENS each) and ``late`` (32 tokens) arriving at the first token:
    the late prompt must go through a mixed step with the draft's prefill
    catch-up, and finish."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig

    engine = TorchEngine(TorchEngineConfig(model=mcfg, num_blocks=2048, block_size=BS,
                                           max_batch_size=8, max_context=4096, seed=0,
                                           spec_draft=mcfg, spec_k=SPEC_K),
                         params=params, draft_params=params)
    caught = {}
    advance = engine._advance_draft_prefill
    mixed = engine._run_mixed_step

    def spy_advance(st):
        advance(st)
        if st.req.request_id == "late":
            caught["draft_prefill_pos"] = st.draft_prefill_pos

    def spy_mixed(st, seqs):
        caught.setdefault("mixed_for", set()).add(st.req.request_id)
        return mixed(st, seqs)

    engine._advance_draft_prefill = spy_advance
    engine._run_mixed_step = spy_mixed
    first = asyncio.Event()
    reset_launches()
    try:
        lead = asyncio.ensure_future(run_requests(
            engine, [preq(f"d{i}", p, SPEC_TOKENS) for i, p in enumerate(prompts)],
            first=first))
        await first.wait()
        (late_run,), _ = await run_requests(engine, [preq("late", late, 32)])
        stats, wall = await lead
    finally:
        engine.stop()
        torch.cuda.synchronize()
    if "late" not in caught.get("mixed_for", ()):
        raise AssertionError(f"spec (d): the late prompt never rode a mixed step "
                             f"({engine.step_counts})")
    if caught.get("draft_prefill_pos") != len(late):
        raise AssertionError(f"spec (d): the draft covered {caught.get('draft_prefill_pos')} "
                             f"of the late prompt's {len(late)} tokens")
    if len(late_run["tokens"]) != 32 or late_run["finish"] != "length":
        raise AssertionError(f"spec (d): the late request streamed {len(late_run['tokens'])} "
                             f"tokens ({late_run['finish']})")
    if any(len(s["tokens"]) != SPEC_TOKENS for s in stats):
        raise AssertionError("spec (d): a queued request did not finish")
    return {"late_ttft_s": late_run["ttft_s"], "late_itl_s": late_run["itl_s"],
            **latency_summary(stats, wall), "steps": dict(engine.step_counts),
            "spec": dict(engine.spec_stats, acceptance=engine.spec_acceptance()),
            "draft_prefill_pos": caught["draft_prefill_pos"], **horizon_report(engine)}


def spec_phase(torch, gen, smi: str, timer) -> tuple:
    """Speculative decoding on the card (module docstring, phase 9).
    Returns (the verify kernel's results by report name, the phase's
    report)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.models import registry
    from dynamo_tpu_torch.models.llama import LlamaConfig

    results = {}
    for int8 in (False, True):
        r = check_verify(torch, gen, timer, int8=int8)
        results[r["name"]] = r
    out = {}
    mcfg = LlamaConfig.llama3_8b()
    params = registry.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    small = dataclasses.replace(mcfg, num_layers=1)   # the draft from seed 2 (seed + 2)
    # (b) graph against eager, on a bf16 and an int8 main cache
    out["graph_equals_eager"] = {}
    lens = [300, 1000, 2500, 4096 - 2 * HZ_STEPS, 64, 0, 1800, 17]
    cut, cut_params = first_layers(mcfg, params)
    for kv in ("model", "int8"):
        eng = TorchEngine(TorchEngineConfig(
            model=cut, num_blocks=2048, block_size=BS, max_batch_size=8, max_context=4096,
            kv_dtype=kv, decode_steps=HZ_STEPS, decode_pipeline=1, spec_draft=small,
            spec_k=SPEC_K), params=cut_params)
        tag = f"llama3-8b {'int8' if kv == 'int8' else 'bf16'}"
        out["graph_equals_eager"][tag] = {**spec_graph_equals_eager(torch, eng, tag, lens),
                                          **horizon_report(eng)}
        eng.stop()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del cut_params
    for tag, r in out["graph_equals_eager"].items():
        log(f"spec graph = eager, {tag}: bit-identical over {r['rounds']} rounds at key "
            f"{r['key']} ({r['pages_compared']} pages x {r['cache_arrays']} cache arrays, "
            f"advances {r['advances']}); eager {r['eager_s'] * 1e3:.1f} ms, replay "
            f"{r['replay_s'] * 1e3:.1f} ms")
    # (c) decode-heavy traffic
    prompts = horizon_prompts()
    common = dict(tokens=SPEC_TOKENS, sampled=None)
    plain, eng = asyncio.run(serve_decode_heavy(torch, params, prompts, logprobs=2, **common))
    del eng
    for s in plain["requests"]:
        if len(s["tokens"]) != SPEC_TOKENS or s["finish"] != "length":
            raise AssertionError(f"spec (c) plain: request {s['i']}: {len(s['tokens'])} tokens")
    runs = {"plain": plain}
    plans = (("perfect", dict(spec_draft=mcfg, draft_params=params)),
             ("one-layer", dict(spec_draft=small)),
             ("perfect int8", dict(spec_draft=mcfg, draft_params=params, kv_dtype="int8",
                                   tokens=64)))
    for tag, knobs in plans:
        gc.collect()
        torch.cuda.empty_cache()
        run, eng = asyncio.run(serve_decode_heavy(
            torch, params, prompts, spec_k=SPEC_K, **{**common, **knobs}))
        if tag == "perfect":
            out["parts"] = spec_parts_ms(torch, eng, lens)
        del eng
        want = knobs.get("tokens", SPEC_TOKENS)
        if any(len(s["tokens"]) != want for s in run["requests"]):
            raise AssertionError(f"spec ({tag}): a request did not finish")
        if run["steps"]["spec"] <= 0:
            raise AssertionError(f"spec ({tag}): no spec horizon ran: {run['steps']}")
        hz = run["horizon"]
        if hz["spec_replays"] != run["steps"]["spec"] or (
                hz["replays"] != run["steps"]["spec"] + run["steps"]["horizon"]):
            raise AssertionError(f"spec ({tag}): replays {hz} for steps {run['steps']}")
        unified = "unified_int8" if "int8" in tag else "unified"
        for name in (unified, "decode"):
            if run["launches"]["replayed"][name] <= 0:
                raise AssertionError(f"spec ({tag}): no {name} launch came from a replay")
        if "int8" not in tag:
            run["tie_rule_gaps"] = tie_rule(torch, f"spec ({tag})", run, plain, prompts,
                                            params, mcfg)
        # (on an int8 main cache the main weights are no perfect draft: the
        # draft reads its bf16 shadow cache, the verify the int8 one)
        if tag == "perfect" and run["spec"]["acceptance"] < 0.9:
            raise AssertionError(f"spec ({tag}): the perfect draft's acceptance "
                                 f"{run['spec']['acceptance']:.3f} < 0.9")
        runs[tag] = run
    for tag, run in runs.items():
        log(f"spec ({tag}) on {smi}: schedule {run['schedule']}; {run['output_tok_s']:.1f} "
            f"tok/s, wall {run['wall_s']:.2f} s, TTFT median {run['ttft_s_median'] * 1e3:.0f} "
            f"ms, ITL median {run['itl_s_median'] * 1e3:.2f} ms (max "
            f"{run['itl_s_max'] * 1e3:.2f}); steps {run['steps']}; spec {run['spec']}; "
            f"graphs {run['horizon']}; launches {run['launches']}")
    p = out["parts"]
    log(f"spec (perfect) on {smi}: one round inside a graph: {SPEC_K} draft steps "
        f"{p['draft_ms']:.3f} ms, verify {p['verify_ms']:.3f} ms")
    out["runs"] = {tag: {k: v for k, v in run.items() if k != "requests"}
                   for tag, run in runs.items()}
    gc.collect()
    torch.cuda.empty_cache()
    # (d) a late arrival through a mixed step, draft prefill catch-up
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    late = words_text(ByteTokenizer(), np.random.default_rng(31), LATE_PROMPT)
    out["late"] = asyncio.run(serve_late_arrival(torch, params, prompts[:7], late, mcfg))
    d = out["late"]
    log(f"spec (d) on {smi}: a {len(late)}-token prompt arriving at the first token rode "
        f"a mixed step (steps {d['steps']}), the draft prefilled "
        f"{d['draft_prefill_pos']} tokens; late TTFT {d['late_ttft_s'] * 1e3:.0f} ms, ITL "
        f"{d['late_itl_s'] * 1e3:.2f} ms; acceptance {d['spec']['acceptance']:.3f}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["verify_writes"] = verify_write_ms(torch, mcfg)
    w = out["verify_writes"]
    log(f"spec verify KV writes inside a graph on {smi}: {w['writes_per_layer']} writes of K "
        f"and V per layer over {w['layers']} layers, 8 rows: {w['bf16_ms']:.4f} ms bf16, "
        f"{w['int8_ms']:.4f} ms int8")
    for name, run in (("ragged_paged_attention_verify", runs["perfect"]),
                      ("ragged_paged_attention_verify_int8", runs["perfect int8"])):
        results[name]["launches"] = run["launches"]["unified_int8" if "int8" in name
                                                    else "unified"]
    return results, out


# ------------------------------------------------------------- phase 10
# HF checkpoints on the card. (a) Qwen3-0.6B as published
# (huggingface.co/Qwen/Qwen3-0.6B config.json) at full width and depth,
# random bf16 weights from a seed; (b) gpt-oss-20b at full width, 2 of 24
# layers, its experts in the released MXFP4 format
QWEN3_HF = {
    "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3", "vocab_size": 151936,
    "hidden_size": 1024, "num_hidden_layers": 28, "num_attention_heads": 16,
    "num_key_value_heads": 8, "head_dim": 128, "intermediate_size": 3072,
    "rope_theta": 1000000, "rms_norm_eps": 1e-06, "tie_word_embeddings": True,
    "max_position_embeddings": 40960, "attention_bias": False, "torch_dtype": "bfloat16",
}
GPTOSS_LAYERS = 2
GPTOSS_HF = {
    "architectures": ["GptOssForCausalLM"], "model_type": "gpt_oss", "vocab_size": 201088,
    "hidden_size": 2880, "num_hidden_layers": GPTOSS_LAYERS, "num_attention_heads": 64,
    "num_key_value_heads": 8, "head_dim": 64, "intermediate_size": 2880,
    "num_local_experts": 32, "num_experts_per_tok": 4, "experts_per_token": 4,
    "sliding_window": 128, "attention_bias": True, "tie_word_embeddings": False,
    "layer_types": ["sliding_attention", "full_attention"], "rope_theta": 150000,
    "rms_norm_eps": 1e-05, "max_position_embeddings": 131072, "swiglu_limit": 7.0,
    "rope_scaling": {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                     "beta_slow": 1.0, "truncate": False,
                     "original_max_position_embeddings": 4096},
    "quantization_config": {"quant_method": "mxfp4"},
}
CKPT_PROMPTS = (100, 2300, 400, 1200, 3000, 700, 1800, 250)
CKPT_TOKENS = 32
CKPT_EMBED = (100, 3000)
# its scale bytes sweep 0-255 (inf weights): no token is routed to it
GPTOSS_SWEEP_EXPERT = 5
ST_NAMES = {"torch.bfloat16": "BF16", "torch.float32": "F32", "torch.uint8": "U8"}


def write_safetensors(torch, path: str, tensors: dict) -> int:
    """A safetensors shard of CPU tensors (name -> tensor); its bytes."""
    import struct

    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_NAMES[str(t.dtype)], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.contiguous().reshape(-1).view(torch.uint8).numpy())
    return 8 + len(blob) + off


def write_checkpoint(torch, path: str, config: dict, shards: list) -> int:
    """config.json and one shard per dict of HF-named CPU tensors; the
    bytes written."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return sum(write_safetensors(torch, os.path.join(
        path, f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"), s)
        for i, s in enumerate(shards))


def hf_llama_tensors(params, layers) -> dict:
    """The HF names and [out, in] layout of a llama-family parameter set's
    ``layers`` (top-level tensors with the first), on the host."""
    out = {}
    if 0 in layers:
        out["model.embed_tokens.weight"] = params["embed"].cpu()
        out["model.norm.weight"] = params["final_norm"].cpu()
    names = {"attn_norm": "input_layernorm.weight",
             "mlp_norm": "post_attention_layernorm.weight",
             "wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
             "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
             "q_norm": "self_attn.q_norm.weight", "k_norm": "self_attn.k_norm.weight",
             "w_gate": "mlp.gate_proj.weight", "w_up": "mlp.up_proj.weight",
             "w_down": "mlp.down_proj.weight"}
    for i in layers:
        for key, t in params["layers"][i].items():
            out[f"model.layers.{i}.{names[key]}"] = (t.t() if t.dim() == 2 else t).cpu()
    return out


def same_bits(torch, got, want) -> bool:
    return (got.dtype == want.dtype and got.shape == want.shape and got.is_contiguous()
            and want.is_contiguous()
            and torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8)))


def check_params_bit_equal(torch, got, want, tag: str) -> int:
    """Every tensor of ``got`` bit-equal to ``want``'s, in dtype, shape and
    contiguity; the count of tensors."""
    n = 0
    for key in want:
        if key == "layers":
            for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
                if set(g) != set(w):
                    raise AssertionError(f"{tag}: layer {i} keys {sorted(set(g) ^ set(w))}")
                for k in w:
                    if not same_bits(torch, g[k], w[k]):
                        raise AssertionError(f"{tag}: layer {i} {k} differs")
                    n += 1
        elif not same_bits(torch, got[key], want[key]):
            raise AssertionError(f"{tag}: {key} differs")
        else:
            n += 1
    if set(got) != set(want) or len(got["layers"]) != len(want["layers"]):
        raise AssertionError(f"{tag}: parameter sets differ")
    return n


def mxfp4_host(blocks: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """The plain MXFP4 dequant on the host, in numpy: FP4 e2m1 values (low
    nibble first) times 2 ** (scale - 127) in float64, rounded once to
    float32. [out, G, 16] uint8, [out, G] uint8 -> [in, out] float32."""
    lut = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
                    -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0], np.float32)
    vals = np.empty((*blocks.shape[:-1], blocks.shape[-1] * 2), np.float32)
    vals[..., 0::2] = lut[blocks & 0x0F]
    vals[..., 1::2] = lut[blocks >> 4]
    with np.errstate(over="ignore"):
        vals = (vals * np.exp2(scales.astype(np.int64) - 127)[..., None]).astype(np.float32)
    return np.ascontiguousarray(vals.reshape(blocks.shape[0], -1).T)


async def embed_vectors(engine, inputs) -> list:
    from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime import Context

    out = []
    for i, toks in enumerate(inputs):
        req = PreprocessedRequest(request_id=f"e{i}", model="smoke", token_ids=list(toks),
                                  annotations={"op": "embed"})
        items = [o async for o in engine.generate(req, Context())]
        if len(items) != 1 or items[0].finish_reason != "stop":
            raise AssertionError(f"embedding {i}: {len(items)} outputs")
        out.append(np.asarray(items[0].annotations["embedding"], np.float64))
    return out


def held_unified(torch, worst: list):
    """Wrap the unified kernel's wrapper so that each launch's rows in use
    are held to the plain op on the same inputs (``compare``), the worst
    max abs error appended to ``worst``; returns the undo."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_unified

    real = cuda_unified.ragged_paged_attention

    def held(q, kc, vc, tables, qs, ql, sl, *, windows=None, sinks=None, softcap=None,
             **bounds):
        out = real(q, kc, vc, tables, qs, ql, sl, windows=windows, sinks=sinks,
                   softcap=softcap, **bounds)
        want = att.ragged_paged_attention(q, kc, vc, tables, qs, ql, sl, windows=windows,
                                          sinks=sinks, softcap=float(softcap) if softcap
                                          else None)
        n = int((qs + ql).max())
        worst.append(compare(torch, out[:n], want[:n], "unified kernel on embedding rows"))
        return out

    cuda_unified.ragged_paged_attention = held
    return lambda: setattr(cuda_unified, "ragged_paged_attention", real)


async def check_embeddings(torch, engine, inputs, tag: str, hold: str = "vector") -> dict:
    """Embed ``inputs`` through the kernels, unit vectors, the pages the
    chunked one took given back. ``hold="vector"``: then through the plain
    flash-extend op on the same engine (a family whose attention reaches
    no other kernel: none may launch), each vector within MODEL_REL_TOL
    (relative L2). ``hold="attention"`` (a model whose saturating expert FFN turns
    bf16 rounding into large output changes): each unified launch held to
    its plain op on the same inputs (``compare``)."""
    free, cached = engine.allocator.free_blocks, engine.allocator.cached_blocks
    worst = []
    undo = held_unified(torch, worst) if hold == "attention" else (lambda: None)
    reset_launches()
    t0 = time.perf_counter()
    try:
        got = await embed_vectors(engine, inputs)
        torch.cuda.synchronize()
    finally:
        undo()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    out = {"tokens": [len(t) for t in inputs], "seconds": seconds, "dim": len(got[0]),
           "launches": launches, "vectors": got}
    if hold == "attention":
        if not worst:
            raise AssertionError(f"{tag} embeddings: no unified launch was held")
        out["attention_max_abs_err"] = max(worst)
    else:
        from dynamo_tpu_torch.ops import cuda_prefill

        kernel = cuda_prefill.flash_extend_attention
        cuda_prefill.flash_extend_attention = cuda_prefill.flash_extend_reference
        reset_launches()
        try:
            want = await embed_vectors(engine, inputs)
        finally:
            cuda_prefill.flash_extend_attention = kernel
        plain_launches = read_launches()
        if any(n for k, n in plain_launches.items() if k != "replayed"):
            raise AssertionError(f"{tag} embeddings: the plain path launched kernels: "
                                 f"{plain_launches}")
        out["rel_l2"] = [float(np.linalg.norm(g - w) / np.linalg.norm(w))
                         for g, w in zip(got, want)]
        if max(out["rel_l2"]) > MODEL_REL_TOL:
            raise AssertionError(f"{tag} embeddings: kernels vs plain relative L2 "
                                 f"{out['rel_l2']} (limit {MODEL_REL_TOL})")
    if not all(np.isfinite(g).all() for g in got):
        raise AssertionError(f"{tag} embeddings: not finite")
    if any(abs(np.linalg.norm(g) - 1) > 1e-3 for g in got):
        raise AssertionError(f"{tag} embeddings: not unit vectors")
    if (engine.allocator.free_blocks, engine.allocator.cached_blocks) != (free, cached):
        raise AssertionError(f"{tag} embeddings: free blocks {free} -> "
                             f"{engine.allocator.free_blocks}, cached blocks {cached} -> "
                             f"{engine.allocator.cached_blocks}")
    return out


async def staggered(engine, reqs):
    """Serve ``reqs``, each submitted once the one before it has streamed
    its first token (arrivals tied to the engine's progress, not to the
    host's clock, so that two engines see the same batches)."""
    from dynamo_tpu_torch.runtime import Context

    stats = [None] * len(reqs)
    firsts = [asyncio.Event() for _ in reqs]

    async def one(i, req):
        if i:
            await firsts[i - 1].wait()
        t_sub = time.perf_counter()
        stamps, toks, finish = [], [], None
        async for out in engine.generate(req, Context()):
            if out.token_ids:
                stamps.append(time.perf_counter())
                toks.extend(out.token_ids)
                firsts[i].set()
            finish = out.finish_reason or finish
        firsts[i].set()
        stats[i] = {"i": i, "tokens": toks, "finish": finish,
                    "ttft_s": stamps[0] - t_sub if stamps else None,
                    "itl_s": ((stamps[-1] - stamps[0]) / (len(toks) - 1)
                              if len(toks) > 1 else None)}

    t0 = time.perf_counter()
    await asyncio.gather(*(one(i, r) for i, r in enumerate(reqs)))
    return stats, time.perf_counter() - t0


def checkpoint_qwen3(torch, smi: str, root: str, procs: list) -> tuple:
    """(a): Qwen3-0.6B from its HF checkpoint (module docstring, phase 10);
    the processes it starts go to ``procs``. Returns (its report, the
    ``run.py`` CLI process, still running: checkpoint_phase collects it)."""
    from dynamo_tpu_torch.engine import warm, weights
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.models import registry
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.models.registry import PRESETS

    out = {}
    src_cfg = LlamaConfig.qwen3_0_6b()
    src = registry.init_params(src_cfg, torch.Generator(device="cuda").manual_seed(41), "cuda")
    path = os.path.join(root, "Qwen3-0.6B")
    half = src_cfg.num_layers // 2
    t0 = time.perf_counter()
    nbytes = write_checkpoint(torch, path, QWEN3_HF, [
        hf_llama_tensors(src, range(half)),
        hf_llama_tensors(src, range(half, src_cfg.num_layers))])
    out["write_s"], out["bytes"] = time.perf_counter() - t0, nbytes
    # the weight owner parses the checkpoint in a process of its own while
    # this one loads and serves it
    sock = os.path.join(root, "weights.sock")
    owner = Proc("weight owner", "dynamo_tpu_torch.engine.weight_service", "--sock", sock,
                 "--root", os.path.join(root, "weight_shm"), "--preload", path)
    procs.append(owner)
    # a client process that imports from the owner once it answers (the
    # owner holds the import until its preload is resident); it is
    # SIGKILLed in weight_owner_checks
    code = (f"import os, sys, time\nsys.path.insert(0, {HERE!r})\n"
            "from dynamo_tpu_torch.engine.weight_service import WeightServiceClient\n"
            f"while not os.path.exists({sock!r}):\n    time.sleep(0.05)\n"
            f"c = WeightServiceClient({sock!r})\n"
            f"params, info = c.import_params({path!r}, None, 'cpu')\n"
            "print('IMPORTED', info['refs'], flush=True)\ntime.sleep(600)\n")
    importer = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    procs.append(importer)
    cfg = weights.config_from_hf(path)
    if dataclasses.replace(cfg, max_position=src_cfg.max_position) != src_cfg:
        raise AssertionError(f"checkpoint: config_from_hf gave {cfg}")
    # cold load: seconds, rate, peak device bytes above what was allocated
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = weights.load_params(path, device="cuda")
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["load_gb_s"] = nbytes / out["load_s"] / 1e9
    out["peak_load_bytes"] = torch.cuda.max_memory_allocated() - base
    out["model_bytes"] = sum(t.numel() * t.element_size() for t in [
        params["embed"], params["final_norm"]] + [t for lp in params["layers"]
                                                 for t in lp.values()])
    out["tensors"] = check_params_bit_equal(torch, params, src, "checkpoint qwen3")
    # the warm cache: a miss (load + save), then a warm load, bit-equal
    cache = warm.WarmWeightCache(os.path.join(root, "warm"))
    t0 = time.perf_counter()
    warm.load_params_warm(path, cfg, cache, device="cuda")
    torch.cuda.synchronize()
    out["warm_miss_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm_params = warm.load_params_warm(path, cfg, cache, device="cuda")
    torch.cuda.synchronize()
    out["warm_load_s"] = time.perf_counter() - t0
    check_params_bit_equal(torch, warm_params, src, "checkpoint qwen3 warm")
    del warm_params
    log(f"checkpoint qwen3 on {smi}: {nbytes / 1e9:.3f} GB in 2 shards written in "
        f"{out['write_s']:.2f} s; load_params {out['load_s']:.3f} s = "
        f"{out['load_gb_s']:.2f} GB/s, peak device bytes during the load "
        f"{out['peak_load_bytes'] / 1e9:.3f} GB for a {out['model_bytes'] / 1e9:.3f} GB "
        f"model, {out['tensors']} tensors bit-equal to the source; warm cache miss "
        f"(load + save) {out['warm_miss_s']:.3f} s, warm load {out['warm_load_s']:.3f} s")
    # serving: 8 staggered prompts, 32 greedy tokens each, default schedule,
    # on the loaded parameters and then on the source's
    tok = ByteTokenizer()
    rng = np.random.default_rng(43)
    prompts = [words_text(tok, rng, n) for n in CKPT_PROMPTS]
    reqs = [preq(f"q{i}", p, CKPT_TOKENS) for i, p in enumerate(prompts)]
    engine_kw = dict(model=cfg, num_blocks=2048, block_size=BS, max_batch_size=8,
                     max_context=4096, seed=0)
    runs = {}
    schedule = {}
    for tag, p in (("loaded", params), ("source", src)):
        t0 = time.perf_counter()
        engine = TorchEngine(TorchEngineConfig(**engine_kw, **schedule), params=p)
        torch.cuda.synchronize()
        ready_s = time.perf_counter() - t0
        schedule = dict(decode_steps=engine.cfg.decode_steps,
                        decode_pipeline=engine.cfg.decode_pipeline)

        async def serve_and_embed():
            """The traffic, then (loaded parameters) the embeddings: one
            event loop, the engine's loop task lives in it."""
            reset_launches()
            stats, wall = await staggered(engine, reqs)
            launches = read_launches()
            emb = None
            if tag == "loaded":
                emb = await check_embeddings(torch, engine, [
                    words_text(tok, rng, n) for n in CKPT_EMBED], "checkpoint qwen3")
            return stats, wall, launches, emb

        try:
            stats, wall, launches, emb = asyncio.run(serve_and_embed())
            runs[tag] = {"ready_s": ready_s, **latency_summary(stats, wall),
                         "steps": dict(engine.step_counts), **horizon_report(engine),
                         "launches": launches, "streams": [s["tokens"] for s in stats]}
            for s in stats:
                if len(s["tokens"]) != CKPT_TOKENS or s["finish"] != "length":
                    raise AssertionError(f"checkpoint qwen3 ({tag}) request {s['i']}: "
                                         f"{len(s['tokens'])} tokens, {s['finish']!r}")
            if tag == "loaded":
                for name in ("decode", "flash_extend", "unified"):
                    if launches[name] <= 0:
                        raise AssertionError(f"checkpoint qwen3: the {name} kernel never "
                                             "launched while serving")
                emb.pop("vectors")
                out["embed"] = emb
                if out["embed"]["launches"]["flash_extend"] <= 0:
                    raise AssertionError("checkpoint qwen3: embeddings launched no "
                                         "flash-extend kernel")
        finally:
            engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    if runs["loaded"]["streams"] != runs["source"]["streams"]:
        bad = [i for i, (a, b) in enumerate(zip(runs["loaded"]["streams"],
                                                runs["source"]["streams"])) if a != b]
        raise AssertionError(f"checkpoint qwen3: requests {bad} stream other tokens on the "
                             "loaded parameters than on the source's")
    out["serving"] = {k: v for k, v in runs["loaded"].items() if k != "streams"}
    out["source_serving"] = {k: runs["source"][k] for k in ("output_tok_s", "ttft_s_median",
                                                            "itl_s_median", "steps")}
    r, e = out["serving"], out["embed"]
    log(f"checkpoint qwen3 serving on {smi}: {len(reqs)} requests of {list(CKPT_PROMPTS)} "
        f"tokens, each after the last one's first token, {CKPT_TOKENS} greedy tokens each: "
        f"streams equal the source parameters' engine's; ready {r['ready_s']:.2f} s, "
        f"{r['output_tok_s']:.1f} tok/s, TTFT median {r['ttft_s_median'] * 1e3:.0f} ms, "
        f"ITL median {r['itl_s_median'] * 1e3:.2f} ms; steps {r['steps']}; graphs "
        f"{r['horizon']}; launches {r['launches']}")
    log(f"checkpoint qwen3 embeddings on {smi}: {e['tokens']} tokens -> {e['dim']} lanes "
        f"in {e['seconds']:.3f} s, kernels vs plain relative L2 {e['rel_l2']} (limit "
        f"{MODEL_REL_TOL}); launches {e['launches']}")
    out["weight_owner"] = weight_owner_checks(torch, owner, importer, sock, path, cfg, src)
    w = out["weight_owner"]
    log(f"checkpoint qwen3 weight owner on {smi}: /dev/shm free {w['dev_shm_free_gb']:.1f} GB "
        f"(the owner's files: {w['shm_line']}); the owner parsed the checkpoint in "
        f"{w['owner_load_s']:.3f} s ({w['bytes'] / 1e9:.3f} GB of tensor files); an import "
        f"onto the card {w['import_s']:.3f} s, {w['tensors']} tensors bit-equal to the "
        f"source, against the cold parse {out['load_s']:.3f} s and the warm load "
        f"{out['warm_load_s']:.3f} s; a SIGKILLed importer's reference came back "
        f"(refs {w['refs_with_killed']} -> {w['refs_after_kill']}) "
        f"[{w['seconds']:.1f} s]")
    del params, src
    gc.collect()
    torch.cuda.empty_cache()
    try:
        TorchEngine(TorchEngineConfig(model=PRESETS["tiny-moe"]()))
    except ValueError as err:
        out["tiny_refused"] = str(err)
    else:
        raise AssertionError("checkpoint: the tiny-moe preset (head_dim 16) was not refused "
                             "on the card")
    log(f"checkpoint: the tiny-moe preset is refused on the card: {out['tiny_refused']}")
    # the CLI on the checkpoint directory, through a fresh warm cache, in a
    # process of its own beside the gpt-oss part
    env = {**os.environ, "PYTHONPATH": HERE, "DTPU_WARM_CACHE": os.path.join(root, "cli_warm"),
           "DTPU_HUB_OFFLINE": "1"}
    cli = subprocess.Popen([sys.executable, "-m", "dynamo_tpu_torch.run", "in=text:hello",
                            f"out={path}", "--tokenizer", "byte", "--max-tokens", "8"],
                           cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    procs.append(cli)
    return out, cli


def collect_cli(cli, t0: float, out: dict) -> None:
    """checkpoint_qwen3's ``run.py`` process: it must exit 0 (its seconds
    from its start, beside the gpt-oss part)."""
    stdout, stderr = cli.communicate(timeout=300)
    out["cli_s"] = time.perf_counter() - t0
    if cli.returncode != 0:
        raise AssertionError(f"checkpoint qwen3: run.py out=<dir> exited {cli.returncode}: "
                             f"{stderr[-2000:]}")
    log(f"checkpoint qwen3: python -m dynamo_tpu_torch.run {' '.join(cli.args[3:])} exited 0 "
        f"in {out['cli_s']:.1f} s (beside the gpt-oss part): {stdout.strip()[:120]!r}")


def weight_owner_checks(torch, owner, importer, sock: str, path: str, cfg, src) -> dict:
    """Phase 10's weight owner (engine/weight_service.py), started on the
    checkpoint at ``path`` with ``--preload``: an import in this process
    onto the card, bit-equal to ``src`` and timed; ``importer``, a client
    process that imported (to the host), SIGKILLed, whose reference the
    owner's ``stat`` gives back; the owner shut down over its socket."""
    from dynamo_tpu_torch.engine.weight_service import READY, WeightServiceClient

    t_all = time.perf_counter()
    out = {"shm_line": owner.wait_line("WEIGHT_OWNER_SHM", 60).split(" ", 1)[1],
           "dev_shm_free_gb": shutil.disk_usage("/dev/shm").free / 1e9
           if os.path.isdir("/dev/shm") else float("nan")}
    loaded = owner.wait_line("WEIGHT_OWNER_LOADED", 300)
    out["owner_load_s"] = float(loaded.rsplit("load_s=", 1)[1])
    out["bytes"] = int(loaded.split("bytes=", 1)[1].split()[0])
    owner.wait_line(READY, 60)
    client = WeightServiceClient(sock)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, info = client.import_params(path, cfg, "cuda")
    torch.cuda.synchronize()
    out["import_s"] = time.perf_counter() - t0
    out["tensors"] = check_params_bit_equal(torch, params, src, "weight owner import")
    del params
    try:
        line = importer.stdout.readline()
        if not line.startswith("IMPORTED"):
            raise AssertionError(f"the weight owner's client process: {line!r}")
        out["refs_with_killed"] = client.stat()[0]["refs"]
    finally:
        importer.kill()
        importer.wait()
    for _ in range(200):
        out["refs_after_kill"] = client.stat()[0]["refs"]
        if out["refs_after_kill"] == out["refs_with_killed"] - 1:
            break
        time.sleep(0.05)
    if (out["refs_with_killed"], out["refs_after_kill"]) != (2, 1):
        raise AssertionError(f"the weight owner's references: {out}")
    client.shutdown_owner()
    client.close()
    if owner.join(30) != 0:
        raise AssertionError(f"the weight owner exited {owner.proc.returncode}")
    errors = owner.errors()
    if errors:
        raise AssertionError(f"ERROR records in the weight owner's log: {errors[:5]}")
    out["seconds"] = time.perf_counter() - t_all
    return out


def checkpoint_gptoss(torch, smi: str, root: str) -> dict:
    """(b): gpt-oss-20b at 2 layers from an MXFP4 checkpoint."""
    from dynamo_tpu_torch.engine import weights
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.models import gptoss

    out = {}
    base = dataclasses.replace(gptoss.GptOssConfig.gpt_oss_20b(), num_layers=GPTOSS_LAYERS)
    p = gptoss.init_params(base, torch.Generator(device="cuda").manual_seed(51), "cuda")
    rng = np.random.default_rng(52)
    E, H, inter = base.num_experts, base.hidden_size, base.intermediate_size
    shards, raw = [], {}
    for i, lp in enumerate(p["layers"]):
        pre = f"model.layers.{i}."
        # routing pinned (GPTOSS_ROUTER_MARGIN) to 4 experts other than the
        # sweep expert, which no token reaches
        chosen = [e for e in rng.permutation(E).tolist() if e != GPTOSS_SWEEP_EXPERT]
        lp["b_router"][chosen[:base.num_experts_per_tok]] += GPTOSS_ROUTER_MARGIN
        lp["b_router"][GPTOSS_SWEEP_EXPERT] = -30000.0
        t = {pre + "input_layernorm.weight": lp["attn_norm"].cpu(),
             pre + "post_attention_layernorm.weight": lp["mlp_norm"].cpu(),
             pre + "self_attn.sinks": lp["sinks"].to(torch.bfloat16).cpu(),
             pre + "mlp.router.weight": lp["w_router"].t().cpu(),
             pre + "mlp.router.bias": lp["b_router"].cpu(),
             pre + "mlp.experts.gate_up_proj_bias": lp["b_gateup"].cpu(),
             pre + "mlp.experts.down_proj_bias": lp["b_edown"].cpu()}
        for proj in "qkvo":
            t[pre + f"self_attn.{proj}_proj.weight"] = lp[f"w{proj}"].t().cpu()
            t[pre + f"self_attn.{proj}_proj.bias"] = lp[f"b{proj}"].cpu()
        for name, n_out, n_in in (("gate_up_proj", 2 * inter, H), ("down_proj", H, inter)):
            blocks = rng.integers(0, 256, size=(E, n_out, n_in // 32, 16), dtype=np.uint8)
            scales = rng.integers(118, 131, size=(E, n_out, n_in // 32), dtype=np.uint8)
            scales[GPTOSS_SWEEP_EXPERT] = (np.arange(n_out * (n_in // 32)) % 256).reshape(
                n_out, n_in // 32)
            raw[(i, name)] = (blocks, scales)
            t[pre + f"mlp.experts.{name}_blocks"] = torch.from_numpy(blocks)
            t[pre + f"mlp.experts.{name}_scales"] = torch.from_numpy(scales)
        shards.append(t)
    shards[0].update({"model.embed_tokens.weight": p["embed"].cpu(),
                      "model.norm.weight": p["final_norm"].cpu(),
                      "lm_head.weight": p["lm_head"].t().cpu()})
    del p
    gc.collect()
    torch.cuda.empty_cache()
    path = os.path.join(root, "gpt-oss-20b-x2")
    t0 = time.perf_counter()
    nbytes = write_checkpoint(torch, path, GPTOSS_HF, shards)
    out["write_s"], out["bytes"] = time.perf_counter() - t0, nbytes
    del shards
    cfg = weights.config_from_hf(path)
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = weights.load_params(path, device="cuda")
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["load_gb_s"] = nbytes / out["load_s"] / 1e9
    out["peak_load_bytes"] = torch.cuda.max_memory_allocated() - mem0
    # experts dequantized on the card = the plain dequant on the host
    checked = []
    for (i, name), (blocks, scales) in raw.items():
        key = {"gate_up_proj": "w_gateup", "down_proj": "w_edown"}[name]
        for e in (GPTOSS_SWEEP_EXPERT, 0, E - 1):
            want = torch.from_numpy(mxfp4_host(blocks[e], scales[e])).to(cfg.dtype)
            if not same_bits(torch, params["layers"][i][key][e].cpu(), want):
                raise AssertionError(f"checkpoint gpt-oss: layer {i} {name} expert {e} "
                                     "differs from the host dequant")
            checked.append((i, name, e))
    sweep = params["layers"][0]["w_gateup"][GPTOSS_SWEEP_EXPERT].float()
    out["sweep_expert"] = {"inf": int(torch.isinf(sweep).sum()),
                           "nan": int(torch.isnan(sweep).sum()),
                           "max_finite": float(sweep[torch.isfinite(sweep)].abs().max())}
    log(f"checkpoint gpt-oss on {smi}: {GPTOSS_LAYERS} of 24 layers, MXFP4 experts, "
        f"{nbytes / 1e9:.3f} GB written in {out['write_s']:.2f} s; load_params "
        f"{out['load_s']:.3f} s = {out['load_gb_s']:.2f} GB/s (dequant on the card), peak "
        f"device bytes during the load {out['peak_load_bytes'] / 1e9:.3f} GB; "
        f"{len(checked)} expert tensors bit-equal to the host dequant, the sweep expert "
        f"(scale bytes 0-255) {out['sweep_expert']}")
    # the engine on the card-dequantized params and on the host-dequantized
    host = {k: v for k, v in params.items() if k != "layers"}
    host["layers"] = []
    for i, lp in enumerate(params["layers"]):
        hl = dict(lp)
        for name, key in (("gate_up_proj", "w_gateup"), ("down_proj", "w_edown")):
            blocks, scales = raw[(i, name)]
            hl[key] = weights.dequant_mxfp4(torch.from_numpy(blocks),
                                            torch.from_numpy(scales)).to(cfg.dtype).cuda()
        host["layers"].append(hl)
    del raw
    tok = ByteTokenizer()
    prompt = words_text(tok, np.random.default_rng(53), 700)
    streams, vectors, schedule = {}, {}, {}
    for tag, pp in (("card", params), ("host", host)):
        engine = TorchEngine(TorchEngineConfig(model=cfg, num_blocks=1024, block_size=BS,
                                               max_batch_size=8, max_context=4096, seed=0,
                                               **schedule), params=pp)
        schedule = dict(decode_steps=engine.cfg.decode_steps,
                        decode_pipeline=engine.cfg.decode_pipeline)

        async def serve_and_embed():
            (s,), _ = await run_requests(engine, [preq(f"g{tag}", prompt, CKPT_TOKENS)])
            emb = await check_embeddings(torch, engine, [prompt[:500]], "checkpoint gpt-oss",
                                         hold="attention")
            return s, emb

        try:
            s, emb = asyncio.run(serve_and_embed())
            streams[tag] = s["tokens"]
            vectors[tag] = emb.pop("vectors")[0]
            if tag == "card":
                out["embed"] = emb
                if out["embed"]["launches"]["unified"] <= 0:
                    raise AssertionError("checkpoint gpt-oss: embeddings launched no "
                                         "unified kernel")
        finally:
            engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    if streams["card"] != streams["host"] or len(streams["card"]) != CKPT_TOKENS:
        raise AssertionError("checkpoint gpt-oss: the card-dequantized parameters stream "
                             "other tokens than the host-dequantized ones")
    if not np.array_equal(vectors["card"], vectors["host"]):
        raise AssertionError("checkpoint gpt-oss: the card- and host-dequantized parameters "
                             "give other embeddings")
    e = out["embed"]
    log(f"checkpoint gpt-oss on {smi}: one greedy stream of {CKPT_TOKENS} tokens and a "
        f"{e['tokens']}-token embedding equal on the card- and host-dequantized "
        f"parameters; the embedding's unified launches against the plain op: max abs err "
        f"{e['attention_max_abs_err']:.3g} (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}, row "
        f"{KERNEL_ROW_REL}); launches {e['launches']}")
    del params, host
    gc.collect()
    torch.cuda.empty_cache()
    return out


def checkpoint_phase(torch, smi: str) -> dict:
    """HF checkpoints on the card (module docstring, phase 10): written
    under a temporary directory, removed after."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="dtpu_ckpt_")
    log(f"checkpoint: writing under {root}, {shutil.disk_usage(root).free / 1e9:.1f} GB "
        "free")
    out = {}
    procs = []
    try:
        t0 = time.perf_counter()
        out["qwen3"], cli = checkpoint_qwen3(torch, smi, root, procs)
        out["qwen3"]["seconds"] = time.perf_counter() - t0
        t_cli = time.perf_counter()
        gptoss_root = os.path.join(root, "gptoss")
        os.makedirs(gptoss_root)
        out["gptoss"] = checkpoint_gptoss(torch, smi, gptoss_root)
        out["gptoss"]["seconds"] = time.perf_counter() - t_cli
        collect_cli(cli, t_cli, out["qwen3"])
    finally:
        for p in procs:
            if isinstance(p, Proc):
                p.stop()
            elif p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)
    return out


# ------------------------------------------------------------------ main
# ------------------------------------------------------------- phase 11
# per-request features on llama3-8b at 32 layers (random bf16 weights from
# seed 0): logits processors, guided decoding over a synthetic byte
# vocabulary (the repository has no Llama-3 tokenizer), and multi-LoRA on
# the reference's four default targets
FEAT_EOS = 128001              # the synthetic vocabulary's EOS (Llama-3's id)
FEAT_GUIDED_CAPS = (1024, 320)   # guided_max_states / classes (the reference CLI's)
FEAT_LORA = (2, 16)            # lora_max_adapters, lora_rank
FEAT_TARGETS = ("wq", "wk", "wv", "wo")
FEAT_TOKENS = 64
# (a): 8 prompts queued at once; grammars of finite languages whose longest
# member fits the 64 tokens (bounded whitespace), so each ends at EOS
FEAT_PROMPTS = (100, 2000, 700, 1500, 300, 1200, 450, 900)
FEAT_GRAMMARS = (
    ("json", {"type": "object", "properties": {"ok": {"type": "boolean"}},
              "required": ["ok"]}),
    ("json", {"type": "object", "properties": {"mood": {"enum": ["happy", "sad"]}},
              "required": ["mood"]}),
    ("regex", r"[0-9]{3}-[0-9]{4}"),
    ("choice", ["alpha", "beta", "gamma"]),
)
FEAT_SAMPLED = {5: 11, 7: 13}  # row: seed (temperature 0.8)
# (b): ban every even id; a repetition window of 3.0 (20 top logprobs to check it)
FEAT_REP_PENALTY = 3.0
FEAT_B_PROMPTS = (300, 800, 500, 600)
# (c): base, adapter-a, adapter-b; adapters of seeds 5 and 9 whose delta is
# about half the base projection's output
FEAT_C_PROMPTS = (400, 300, 500)
FEAT_LORA_B_STD = 0.5
FEAT_SALT_PROMPT = 40


def synthetic_vocab(V: int, seed: int = 0) -> list:
    """Byte forms of a synthetic vocabulary (no trained tokenizer is in the
    repository): ids 0-255 single bytes, the rest 2-8-byte printable-ASCII
    pieces from ``seed``, and FEAT_EOS with no byte form."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 9, size=V - 256)
    chars = rng.integers(32, 127, size=int(lens.sum()), dtype=np.uint8).tobytes()
    ends = np.cumsum(lens)
    out = [bytes([i]) for i in range(256)] + [chars[e - n:e] for e, n in zip(ends, lens)]
    out[FEAT_EOS] = None
    return out


def feature_adapter(mcfg, seed: int) -> dict:
    """A random adapter for FEAT_TARGETS at rank FEAT_LORA[1]: A ~ N(0,
    1/in), B ~ N(0, FEAT_LORA_B_STD^2 / r), loaded with alpha = r (scale 1)."""
    rng = np.random.default_rng(seed)
    r, L = FEAT_LORA[1], mcfg.num_layers
    sizes = {"wq": (mcfg.hidden_size, mcfg.q_size), "wk": (mcfg.hidden_size, mcfg.kv_size),
             "wv": (mcfg.hidden_size, mcfg.kv_size), "wo": (mcfg.q_size, mcfg.hidden_size)}
    w = {}
    for t in FEAT_TARGETS:
        inp, out = sizes[t]
        w[f"{t}.A"] = (rng.standard_normal((L, inp, r), np.float32) / np.sqrt(inp))
        w[f"{t}.B"] = (rng.standard_normal((L, r, out), np.float32)
                       * (FEAT_LORA_B_STD / np.sqrt(r)))
    return w


def merged_params(torch, params, table, slot: int) -> dict:
    """``params`` with each target weight merged: W + s * A @ B (float32,
    rounded to the model dtype), from the adapter table's slot."""
    s = float(table.scales[slot])
    layers = []
    for i, p in enumerate(params["layers"]):
        q = dict(p)
        for t in table.targets:
            delta = table.A[t][slot, i].float() @ table.B[t][slot, i].float()
            q[t] = (p[t].float() + s * delta).to(p[t].dtype)
        layers.append(q)
    return {**params, "layers": layers}


def freq(rid, tokens, n, stop=(), ann=None, logprobs=0, **samp):
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )

    return PreprocessedRequest(
        request_id=rid, model="smoke", token_ids=list(tokens),
        sampling=SamplingOptions(temperature=samp.pop("temperature", 0.0), logprobs=logprobs,
                                 **samp),
        stop=StopConditions(max_tokens=n, stop_token_ids=list(stop)),
        annotations=dict(ann or {}))


def guided_graph_ms(torch, engine) -> dict:
    """Device ms of one step's grammar mask and FSM step over the decode
    batch at the full vocabulary inside a graph, against its byte bound
    (the logits read and written, each row's class map and its transition
    row read once)."""
    from dynamo_tpu_torch.engine.sampling import guided_mask, guided_step

    B, V = engine.g_class.shape
    S, C = engine.g_trans.shape[1:]
    gen = torch.Generator(device="cuda").manual_seed(3)
    logits = torch.randn(B, V, generator=gen, device="cuda")
    state = torch.randint(0, S, (B,), generator=gen, device="cuda", dtype=torch.int32)
    toks = torch.randint(0, V, (B,), generator=gen, device="cuda")
    active = torch.ones(B, dtype=torch.bool, device="cuda")

    def step():
        guided_mask(logits, active, state, engine.g_class, engine.g_trans)
        guided_step(state, toks, active, engine.g_class, engine.g_trans)

    nbytes = 2 * B * V * 4 + B * V * 4 + B * C * 4
    return {"ms": graph_ms(torch, step), "bound_ms": bound(nbytes, 0)[0], "bytes": nbytes}


def lora_graph_ms(torch, engine, ids) -> dict:
    """Device ms of one decode pass's LoRA deltas (every layer and target,
    one adapter per row of ``ids``) inside a graph, its kernel launches
    (torch.profiler over one eager pass) and its byte bound: the tables of
    the distinct adapters the rows use, each read once."""
    from dynamo_tpu_torch.lora import make_lora_fn

    m, table = engine.mcfg, engine.lora
    ids_t = torch.tensor(ids, device="cuda")
    ins = {"wq": m.hidden_size, "wk": m.hidden_size, "wv": m.hidden_size, "wo": m.q_size}
    xs = {t: torch.randn(len(ids), 1, ins[t], device="cuda", dtype=m.dtype)
          for t in table.targets}

    def one_pass():
        lora = make_lora_fn(table.tables(), ids_t)
        for layer in range(m.num_layers):
            for t in table.targets:
                lora(t, layer, xs[t])

    per_slot = sum(table.A[t][0].numel() + table.B[t][0].numel() for t in table.targets) * 2
    nbytes = len(set(ids)) * per_slot
    one_pass()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        one_pass()
        torch.cuda.synchronize()
    return {"ms": graph_ms(torch, one_pass), "bound_ms": bound(nbytes, 0)[0], "bytes": nbytes,
            "launches_per_pass": device_time_by_kind(prof)["kernels"]}


def out_bytes(vocab, toks) -> bytes:
    return b"".join(vocab[t] for t in toks)


def features_phase(torch, smi: str) -> dict:
    """Logits processors, guided decoding and multi-LoRA on the card
    (module docstring, phase 11)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.guided import compile_regex, guided_regex_pattern
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.logits_processing import (
        ban_tokens_processor, repetition_window_processor,
    )
    from dynamo_tpu_torch.models import registry
    from dynamo_tpu_torch.models.llama import LlamaConfig

    mcfg = LlamaConfig.llama3_8b()
    V = mcfg.vocab_size
    params = registry.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    vocab = synthetic_vocab(V)
    tok, rng = ByteTokenizer(), np.random.default_rng(41)
    specs = [{"kind": k, "value": v} for k, v in FEAT_GRAMMARS]
    a_prompts = [words_text(tok, rng, n) for n in FEAT_PROMPTS]
    b_prompts = [words_text(tok, rng, n) for n in FEAT_B_PROMPTS]
    c_prompts = [words_text(tok, rng, n) for n in FEAT_C_PROMPTS]
    salt_x, salt_y = (words_text(tok, rng, FEAT_SALT_PROMPT) for _ in range(2))
    itl_prompts = [words_text(tok, rng, HZ_PROMPT_LEN) for _ in range(HZ_PROMPTS)]

    def a_reqs(guided: bool, lens=None):
        out = []
        for i, p in enumerate(a_prompts):
            samp = dict(temperature=0.8, seed=FEAT_SAMPLED[i]) if i in FEAT_SAMPLED else {}
            if guided and i < len(specs):
                samp["guided"] = specs[i]
            n = lens[i] if lens is not None else FEAT_TOKENS
            out.append(freq(f"a{i}", p, n, stop=[FEAT_EOS], **samp))
        return out

    def b_reqs(procs: bool):
        ann = [{"logits_processors": ["ban_tokens"]},
               {"logits_processors": ["repetition_window"]}, {}, {}]
        return [freq(f"b{i}", p, FEAT_TOKENS, ann=ann[i] if procs else None,
                     logprobs=20 if i == 1 else 0,
                     **(dict(temperature=0.8, seed=17) if i == 3 else {}))
                for i, p in enumerate(b_prompts)]

    def c_reqs(lora: bool):
        names = (None, "a", "b")
        return [freq(f"c{i}", p, 32, ann={"lora": names[i]} if lora and names[i] else None)
                for i, p in enumerate(c_prompts)]

    procs = (("ban_tokens", ban_tokens_processor(range(0, V, 2))),
             ("repetition_window", repetition_window_processor(FEAT_REP_PENALTY)))
    t0 = time.perf_counter()
    engine = TorchEngine(TorchEngineConfig(
        model=mcfg, num_blocks=2048, block_size=BS, max_batch_size=8, max_context=4096,
        seed=0, lora_max_adapters=FEAT_LORA[0], lora_rank=FEAT_LORA[1],
        lora_targets=FEAT_TARGETS, guided_max_states=FEAT_GUIDED_CAPS[0],
        guided_max_classes=FEAT_GUIDED_CAPS[1], logits_processors=procs),
        params=params, guided_vocab=(vocab, FEAT_EOS))
    torch.cuda.synchronize()
    out = {"ready_s": time.perf_counter() - t0, "feature_engine": horizon_report(engine)}
    graphs0 = engine.horizon_stats()["graphs"]
    ptrs = [t.data_ptr() for t in engine.lora.tables().values()]
    t0 = time.perf_counter()
    for name, seed in (("a", 5), ("b", 9)):
        engine.lora.load(name, feature_adapter(mcfg, seed))
    torch.cuda.synchronize()
    out["lora_load_s"] = time.perf_counter() - t0
    if (engine.horizon_stats()["graphs"] != graphs0
            or [t.data_ptr() for t in engine.lora.tables().values()] != ptrs):
        raise AssertionError("features: loading the adapters after capture moved a table "
                             "or changed the graph count")
    first_logits = {}
    first_token = engine._first_token

    def spy(hidden, first):
        # the op's first-token arguments name the slot; the sequence is
        # resident there while its last chunk runs
        st = engine._slots[int(first[0])]
        if st is not None and st.req.request_id in ("c1", "c2"):
            first_logits[st.req.request_id] = engine._lm_logits(
                engine.params, mcfg, hidden)[0].float()
        return first_token(hidden, first)

    async def serve_features():
        res = {"compile_s": []}
        for spec in specs:
            t = time.perf_counter()
            tables = await engine._compile_guided(spec)
            cold = time.perf_counter() - t
            t = time.perf_counter()
            await engine._compile_guided(spec)
            res["compile_s"].append({"kind": spec["kind"], "cold": cold,
                                     "cached": time.perf_counter() - t,
                                     "states": tables.num_states,
                                     "classes": tables.num_classes})
        reset_launches()
        t = time.perf_counter()
        res["a"] = await run_requests(engine, a_reqs(True))
        res["b"] = await run_requests(engine, b_reqs(True))
        engine._first_token = spy
        res["c"] = await run_requests(engine, c_reqs(True))
        engine._first_token = first_token
        res["launches"] = read_launches()
        res["traffic_s"] = time.perf_counter() - t
        # the salt: adapter-a on x after a base request on y, then (the
        # prefix cache dropped in between) after a base request on x
        salt = []
        for before in (salt_y, salt_x):
            engine.allocator.clear()
            await run_requests(engine, [freq("base", before, 8)])
            (s,), _ = await run_requests(engine, [freq("lora", salt_x, 16, ann={"lora": "a"})])
            salt.append(s)
        (again,), _ = await run_requests(engine, [freq("lora", salt_x, 16, ann={"lora": "a"})])
        res["salt"] = (salt, again)
        # decode-heavy ITL: every row base, then rows on adapters a, b, base in turn
        for tag, names in (("base", [None] * HZ_PROMPTS), ("lora", ["a", "b", None] * 3)):
            res[f"itl_{tag}"] = await run_requests(engine, [
                freq(f"i{i}", p, HZ_TOKENS // 2, ann={"lora": names[i]} if names[i] else None)
                for i, p in enumerate(itl_prompts)])
        return res

    try:
        f = asyncio.run(serve_features())
        out["mask"] = guided_graph_ms(torch, engine)
        out["lora_delta"] = lora_graph_ms(torch, engine, [0, 1, 2, 1, 2, 0, 1, 2])
        out["lora_delta_base_rows"] = lora_graph_ms(torch, engine, [0] * 8)
        out["feature_engine"] = horizon_report(engine)
        schedule = dict(decode_steps=engine.cfg.decode_steps,
                        decode_pipeline=engine.cfg.decode_pipeline)
        merged = {}
        for rid, slot in (("c1", 1), ("c2", 2)):
            ids = c_prompts[int(rid[1])]
            merged[rid] = plain_logits(torch, merged_params(torch, params, engine.lora, slot),
                                       mcfg, ids)
    finally:
        engine.stop()
    out["lora_logits_rel_l2"] = {
        rid: float((first_logits[rid] - merged[rid]).norm() / merged[rid].norm())
        for rid in merged}
    del engine, merged
    gc.collect()
    torch.cuda.empty_cache()

    # the plain engine on the same weights and schedule: the same traffic
    # with the features taken out (a guided row's length cut to what it
    # produced, so that the batch empties in the same steps)
    a_stats = f["a"][0]
    a_lens = [len(s["tokens"]) + (s["finish"] == "stop") for s in a_stats]
    plain = TorchEngine(TorchEngineConfig(model=mcfg, num_blocks=2048, block_size=BS,
                                          max_batch_size=8, max_context=4096, seed=0,
                                          **schedule), params=params)
    out["plain_engine"] = horizon_report(plain)

    async def serve_plain():
        return {"a": await run_requests(plain, a_reqs(False, a_lens)),
                "b": await run_requests(plain, b_reqs(False)),
                "c": await run_requests(plain, c_reqs(False))}

    try:
        p = asyncio.run(serve_plain())
    finally:
        plain.stop()
    del plain, params
    gc.collect()
    torch.cuda.empty_cache()

    # (a) guided rows in their grammars, ending at EOS; plain rows bit-equal
    for i, (kind, value) in enumerate(FEAT_GRAMMARS):
        s = a_stats[i]
        dfa = compile_regex(guided_regex_pattern(kind, value))
        text = out_bytes(vocab, s["tokens"])
        if s["finish"] != "stop" or not dfa.matches(text):
            raise AssertionError(f"features (a): guided row {i} ({kind}) gave {text!r}, "
                                 f"finish {s['finish']!r}")
    for i in range(len(FEAT_GRAMMARS), len(a_prompts)):
        if a_stats[i]["tokens"] != p["a"][0][i]["tokens"]:
            raise AssertionError(f"features (a): plain row {i} differs from the plain engine's")
    # (b) no banned id; the repetition row follows the penalty; plain rows equal
    fb, pb = f["b"][0], p["b"][0]
    if any(t % 2 == 0 for t in fb[0]["tokens"]):
        raise AssertionError("features (b): the ban_tokens row emitted a banned id")
    for i in (2, 3):
        if fb[i]["tokens"] != pb[i]["tokens"]:
            raise AssertionError(f"features (b): row {i} differs from the plain engine's")
    rep = repetition_check(fb[1], pb[1])
    # (c) the base row bit-equal; the adapter rows near the merged weights
    fc, pc = f["c"][0], p["c"][0]
    if fc[0]["tokens"] != pc[0]["tokens"]:
        raise AssertionError("features (c): the base row differs from the plain engine's")
    for rid, r in out["lora_logits_rel_l2"].items():
        if not r <= MODEL_REL_TOL:
            raise AssertionError(f"features (c): {rid}'s first-token logits vs merged weights: "
                                 f"relative L2 {r:.4g} (limit {MODEL_REL_TOL})")
    (after_y, after_x), again = f["salt"]
    if after_x["cached"] != 0 or after_y["cached"] != 0 or again["cached"] == 0 \
            or after_x["tokens"] != after_y["tokens"]:
        raise AssertionError(f"features (c): salt: cached {after_y['cached']}, "
                             f"{after_x['cached']}, again {again['cached']}; streams equal: "
                             f"{after_x['tokens'] == after_y['tokens']}")
    launches = f["launches"]
    for name in ("decode", "flash_extend", "unified"):
        if launches[name] <= 0:
            raise AssertionError(f"features: the {name} kernel never launched")
    if launches["replayed"]["decode"] <= 0:
        raise AssertionError("features: no decode launch came from a horizon replay")
    out.update({
        "compile_s": f["compile_s"], "traffic_s": f["traffic_s"], "launches": launches,
        "guided_rows": [{"kind": k, "tokens": len(a_stats[i]["tokens"]),
                         "text": out_bytes(vocab, a_stats[i]["tokens"]).decode("latin-1")}
                        for i, (k, _) in enumerate(FEAT_GRAMMARS)],
        "a": latency_summary(*f["a"]), "a_plain": latency_summary(*p["a"]),
        "ban_row_differs_from_plain": fb[0]["tokens"] != pb[0]["tokens"],
        "repetition": rep,
        "adapter_rows_differ_from_base": [fc[i]["tokens"] != pc[i]["tokens"] for i in (1, 2)],
        "salt": {"cached": [after_y["cached"], after_x["cached"], again["cached"]],
                 "bit_equal": True},
        "itl_base": latency_summary(*f["itl_base"]), "itl_lora": latency_summary(*f["itl_lora"]),
    })
    return out


def features_summary(f: dict, smi: str) -> str:
    fe, pe = f["feature_engine"]["horizon"], f["plain_engine"]["horizon"]
    lc = f["launches"]
    return (
        f"features on {smi}: graphs {fe['graphs']} captured in {fe['capture_s']:.2f} s, pool "
        f"{fe['pool_bytes'] / 2**20:.1f} MiB (plain engine: {pe['graphs']} in "
        f"{pe['capture_s']:.2f} s, {pe['pool_bytes'] / 2**20:.1f} MiB); grammar compile at "
        f"the full vocabulary (cold / cached s): "
        + ", ".join(f"{c['kind']} {c['cold']:.3f} / {c['cached']:.6f} ({c['states']} states, "
                    f"{c['classes']} classes)" for c in f["compile_s"])
        + f"; guided rows {[g['text'] for g in f['guided_rows']]}; grammar mask + FSM step "
        f"{f['mask']['ms']:.4f} ms a step in a graph (bound {f['mask']['bound_ms']:.4f}); "
        f"LoRA deltas of a decode pass {f['lora_delta']['ms']:.4f} ms in a graph (bound "
        f"{f['lora_delta']['bound_ms']:.4f}, {f['lora_delta']['launches_per_pass']} launches; "
        f"all base rows {f['lora_delta_base_rows']['ms']:.4f} ms); adapter first-token logits "
        f"vs merged weights {f['lora_logits_rel_l2']}; decode-heavy ITL median "
        f"{f['itl_base']['itl_s_median'] * 1e3:.2f} ms base rows, "
        f"{f['itl_lora']['itl_s_median'] * 1e3:.2f} ms with adapter rows; repetition "
        f"{f['repetition']}; salt cached {f['salt']['cached']}; launches decode "
        f"{lc['decode']} [{lc['replayed']['decode']}], flash-extend {lc['flash_extend']} "
        f"[{lc['replayed']['flash_extend']}], unified {lc['unified']} "
        f"[{lc['replayed']['unified']}]; traffic {f['traffic_s']:.1f} s")


def repetition_check(feat: dict, plain: dict) -> dict:
    """The repetition_window row against the same prompt without it (both
    with 20 top logprobs of the raw logits, which agree while the streams
    do): at every step the feature row's token is the best of the plain
    step's top logprobs once the tokens already generated are lowered by
    the penalty. Returns the first step where that moved the token."""
    ft, pt = feat["tokens"], plain["tokens"]
    for j, tok in enumerate(pt):
        seen = set(pt[:j])
        want = tok
        if tok in seen:
            top = {int(k): v for k, v in plain["top"][j].items()}
            scored = {k: v - FEAT_REP_PENALTY * (k in seen) for k, v in top.items()}
            want = max(scored, key=scored.get)
        if j >= len(ft) or ft[j] != want:
            raise AssertionError(f"features (b): repetition row at step {j}: plain token "
                                 f"{tok}, expected {want}, got {ft[j:j + 1]}")
        if want != tok:
            return {"first_divergent_step": j, "plain_token": tok, "token": want,
                    "raw_logprob_gap": top[tok] - top[want]}
    return {"first_divergent_step": None}


# ------------------------------------------------------------- phase 12
# The Qwen2.5 and Llama-3.2 shapes (published config.json values,
# huggingface.co/<name>), read through config_from_hf: Qwen2.5-7B (28
# query heads over 4, G 7, d 128, the qwen2 layout's q/k/v bias, rope
# theta 1e6, untied) and Llama-3.2-1B (32 over 8, d 64, tied, theta 5e5,
# plain RoPE as in both packages)
QWEN25_7B_HF = {
    "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2", "vocab_size": 152064,
    "hidden_size": 3584, "num_hidden_layers": 28, "num_attention_heads": 28,
    "num_key_value_heads": 4, "intermediate_size": 18944, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-06, "tie_word_embeddings": False,
    "max_position_embeddings": 131072, "torch_dtype": "bfloat16",
}
LLAMA32_1B_HF = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 128256,
    "hidden_size": 2048, "num_hidden_layers": 16, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 64, "intermediate_size": 8192,
    "rope_theta": 500000.0, "rms_norm_eps": 1e-05, "tie_word_embeddings": True,
    "max_position_embeddings": 131072, "attention_bias": False, "torch_dtype": "bfloat16",
}
# (model, published config, report-name suffix, output tokens a request
# on bf16 and on int8): Llama-3.2-1B's requests take 128 tokens, or each
# ends before the next arrives and no mixed step runs
SHAPE_MODELS = (("qwen2.5-7b", QWEN25_7B_HF, "_qwen2.5_7b", (32, 16)),
                ("llama3.2-1b", LLAMA32_1B_HF, "_llama3.2_1b", (128, 128)))
# the 8-prompt traffic (PERF.md section 4): 100-6000 tokens 0.25 s apart
SHAPES_PROMPTS = GPTOSS_PROMPTS
# spec decoding at full width and reduced depth: (main, main layers,
# draft, draft layers or None for the main's own weights, router pin).
# Drafts of another family share the main's vocabulary.
SHAPES_SPEC_PROMPTS, SHAPES_SPEC_TOKENS = 4, 64
SHAPES_SPEC = (
    ("llama3-8b", 4, "llama3.2-1b", 2),
    ("gemma2-2b", 4, "gemma2-2b", None),
    ("gpt-oss-20b", 2, "llama3.2-1b", 2),
    ("deepseek-v2-lite", 2, "llama3.2-1b", 2),
    ("qwen3-30b-a3b", 4, "qwen3-0.6b", 2),
)
SHAPES_SPEC_GRAPH_CHECK = ("gemma2-2b", "deepseek-v2-lite")
# the perfect Gemma draft's acceptance must reach this (bf16: the draft
# and the verify round differently, so a near-tie may part them)
SHAPES_PERFECT_ACCEPT = 0.85
# vision at full width and reduced depth: the default tower at
# out_hidden_size = hidden; 4 image prompts of one image and 100-700
# text tokens, 32 greedy tokens; the logits check's prompt is 512 tokens,
# its image last
SHAPES_VISION = (("gemma2-2b", 4), ("gpt-oss-20b", 2), ("deepseek-v2-lite", 2))
SHAPES_VIS_TEXT = (100, 700, 300, 500)
SHAPES_VIS_TOKENS = 32


def hf_model_config(fields: dict):
    """The port's config of a published config.json, through config_from_hf."""
    import tempfile

    from dynamo_tpu_torch.engine.weights import config_from_hf

    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(fields, f)
        return config_from_hf(d)


def shape_config(name: str):
    """A model of the shapes phase by name: the two published configs,
    else the port's preset."""
    from dynamo_tpu_torch.models import registry

    for model, fields, _, _ in SHAPE_MODELS:
        if model == name:
            return hf_model_config(fields)
    return registry.PRESETS[name]()


def pin_router(cfg, params, rng):
    """Pin a MoE model's routing (gpt-oss, DeepSeek, Qwen3-MoE), so that
    bf16 near-ties between two paths do not send a token to other experts."""
    from dynamo_tpu_torch.models import registry

    if registry.is_gptoss(cfg):
        gptoss_pin_router(cfg, params, rng)
    elif registry.is_mla(cfg):
        pin_latent_router(cfg, params, rng)
    elif registry.is_moe(cfg):
        pin_moe_router(cfg, params, rng)


def shapes_kernels(torch, gen, timer) -> tuple:
    """(a): every new form against its plain version (check_group_sizes
    over SHAPE_FORMS), then decode, flash-extend and unified timed at
    Qwen2.5-7B's and Llama-3.2-1B's attention shapes, bf16 and int8."""
    forms = check_group_sizes(torch, gen, SHAPE_FORMS)
    for tag, err in forms.items():
        log(f"shapes: {tag}: decode, flash-extend (a ragged last tile), unified (a split "
            f"row): max abs err {err:.3g} (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}, row "
            f"{KERNEL_ROW_REL})")
    results = {}
    for model, fields, tag, _ in SHAPE_MODELS:
        cfg = hf_model_config(fields)
        shape = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        for int8 in (False, True):
            for r in (check_decode(torch, gen, timer, int8, shape, tag, ("check batch",), ()),
                      check_flash(torch, gen, timer, int8, shape, tag),
                      check_unified(torch, gen, timer, int8, shape, tag)):
                results[r["name"]] = r
                log(f"kernel {r['name']} ({model}: h {shape[0]}, kvh {shape[1]}, d "
                    f"{shape[2]}): max abs err {r['max_abs_err']:.3g}; {r['ms']:.4f} ms "
                    f"kernel, {r['plain_ms']:.4f} ms plain, {r['library_ms']:.4f} ms SDPA, "
                    f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), kernel / SDPA "
                    f"{r['ms'] / r['library_ms']:.2f}")
    return forms, results


def shapes_serving(torch, smi: str) -> dict:
    """(b): Qwen2.5-7B (bf16 and int8) and Llama-3.2-1B (bf16 and int8) at
    full depth, random bf16 weights from seed 0, serving the 8-prompt
    traffic on their defaults (auto-tuned horizon, CUDA graphs): the
    decode, flash-extend and unified kernels of the cache's dtype and the
    mixed step must run, decode launches through replays."""
    from dynamo_tpu_torch.models import registry

    runs = {}
    for model, fields, _, tokens in SHAPE_MODELS:
        cfg = hf_model_config(fields)
        params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                      "cuda")
        for int8 in (False, True):
            sfx = "_int8" if int8 else ""
            kernels = tuple(k + sfx for k in ("decode", "flash_extend", "unified"))
            other = tuple(k + ("" if int8 else "_int8")
                          for k in ("decode", "flash_extend", "unified"))
            run = asyncio.run(serve_windowed(
                torch, cfg, model, SHAPES_PROMPTS, tokens[int8], int8=int8, params=params,
                expect=kernels, forbid=other + ("unified_windowed",)))
            if run["launches"]["replayed"]["decode" + sfx] <= 0:
                raise AssertionError(f"shapes {model}{sfx}: no decode launch came from a "
                                     f"graph replay: {run['launches']}")
            runs[model + sfx] = run
            log(f"shapes serving {model}{' int8' if int8 else ''} on {smi}: {cfg.num_layers} "
                f"layers, {run['requests']} requests, {run['output_tok_s']:.1f} output tok/s, "
                f"TTFT median {run['ttft_s_median'] * 1e3:.0f} ms (max "
                f"{run['ttft_s_max'] * 1e3:.0f}), ITL median {run['itl_s_median'] * 1e3:.2f} "
                f"ms (max {run['itl_s_max'] * 1e3:.2f}); steps {run['steps']}; graphs "
                f"{run['horizon']}; launches {run['launches']}")
            gc.collect()
            torch.cuda.empty_cache()
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def recorded_in_spec_graphs(engine, counter) -> int:
    """The launches of ``counter`` one replay of a spec graph makes (the
    same in every ``max_seq_len`` bucket's graph; raises otherwise)."""
    counts = {rec.get(counter, 0) for _, rec in engine._horizon.spec_graphs.values()}
    if len(counts) != 1:
        raise AssertionError(f"spec graphs record {sorted(counts)} launches of one kernel")
    return counts.pop()


def shapes_spec(torch, smi: str) -> dict:
    """(c): spec decoding with a main of each family at full width and
    reduced depth (SHAPES_SPEC), decode-heavy prompts, greedy: the plain
    run (top logprobs) then the spec run; streams held to the plain ones by
    the tie rule, the perfect Gemma draft's acceptance, the verify rows'
    kernel in the spec graphs (the unified kernel with windows on Gemma,
    the latent kernel on DeepSeek), one spec horizon's graph against its
    eager run for two mains."""
    from dynamo_tpu_torch.models import registry
    from dynamo_tpu_torch.ops import cuda_mla, cuda_unified

    prompts = horizon_prompts()[:SHAPES_SPEC_PROMPTS]
    out = {}
    for main, layers, draft, draft_layers in SHAPES_SPEC:
        t0 = time.perf_counter()
        mcfg = dataclasses.replace(shape_config(main), num_layers=layers)
        params = registry.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0),
                                      "cuda")
        pin_router(mcfg, params, np.random.default_rng(5))
        if draft_layers is None:
            dcfg, dparams = mcfg, params
        else:
            dcfg = dataclasses.replace(shape_config(draft), num_layers=draft_layers,
                                       vocab_size=mcfg.vocab_size)
            dparams = registry.init_params(
                dcfg, torch.Generator(device="cuda").manual_seed(2), "cuda")
        common = dict(mcfg=mcfg, tokens=SHAPES_SPEC_TOKENS, sampled=None,
                      decode_steps=HZ_STEPS, decode_pipeline=1)
        plain, eng = asyncio.run(serve_decode_heavy(torch, params, prompts, logprobs=2,
                                                    **common))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        run, eng = asyncio.run(serve_decode_heavy(
            torch, params, prompts, spec_draft=dcfg, spec_k=SPEC_K, draft_params=dparams,
            **common))
        tag = f"spec {main} ({layers} layers) + {draft}" + (
            f" ({draft_layers} layers)" if draft_layers else " (its own weights)")
        for r in run["requests"] + plain["requests"]:
            if len(r["tokens"]) != SHAPES_SPEC_TOKENS or r["finish"] != "length":
                raise AssertionError(f"{tag}: request {r['i']}: {len(r['tokens'])} tokens")
        if run["steps"]["spec"] <= 0 or run["horizon"]["spec_replays"] <= 0:
            raise AssertionError(f"{tag}: no spec horizon replayed: {run['steps']}")
        run["tie_rule_gaps"] = tie_rule(torch, tag, run, plain, prompts, params, mcfg)
        verify = {"unified": recorded_in_spec_graphs(eng, cuda_unified.KERNEL),
                  "unified_windowed": recorded_in_spec_graphs(eng, cuda_unified.WINDOWED),
                  "latent": recorded_in_spec_graphs(eng, cuda_mla.KERNEL)}
        run["verify_launches_per_spec_graph"] = verify
        if registry.is_mla(mcfg):
            if verify["latent"] <= 0 or run["launches"]["replayed"]["latent_wide"] <= 0:
                raise AssertionError(f"{tag}: the latent kernel served no verify row: {verify}")
        elif verify["unified"] <= 0:
            raise AssertionError(f"{tag}: the unified kernel served no verify row: {verify}")
        if registry.is_gemma(mcfg):
            # every round: k draft steps and the verify through each
            # windowed layer (the draft is the main's config)
            n_w = sum(1 for i in range(layers) if mcfg.window_for_layer(i))
            want = eng._spec_rounds * (SPEC_K + 1) * n_w
            if verify["unified_windowed"] != want:
                raise AssertionError(f"{tag}: {verify['unified_windowed']} windowed launches "
                                     f"a spec graph, not {want}: verify rows without windows")
        if draft_layers is None and run["spec"]["acceptance"] < SHAPES_PERFECT_ACCEPT:
            raise AssertionError(f"{tag}: the perfect draft's acceptance "
                                 f"{run['spec']['acceptance']:.3f} < {SHAPES_PERFECT_ACCEPT}")
        if main in SHAPES_SPEC_GRAPH_CHECK:
            lens = [300, 1000, 2500, 4096 - 2 * HZ_STEPS, 64, 0, 1800, 17]
            run["graph_equals_eager"] = spec_graph_equals_eager(torch, eng, tag, lens)
        run["seconds"] = time.perf_counter() - t0
        out[main] = {"plain": {k: v for k, v in plain.items() if k != "requests"},
                     **{k: v for k, v in run.items() if k != "requests"}}
        log(f"shapes {tag} on {smi}: acceptance {run['spec']['acceptance']:.3f}; ITL median "
            f"{run['itl_s_median'] * 1e3:.2f} ms against plain "
            f"{plain['itl_s_median'] * 1e3:.2f}; {run['output_tok_s']:.1f} tok/s; streams "
            f"equal the plain ones but for {len(run['tie_rule_gaps'])} tie-rule gaps; verify "
            f"launches per spec graph {verify}"
            + ("; graph = eager bit for bit" if "graph_equals_eager" in run else "")
            + f" [{run['seconds']:.1f} s]")
        del eng, params, dparams
        gc.collect()
        torch.cuda.empty_cache()
    return out


def image_prompt_logits(torch, engine, req, unscaled: bool = False):
    """First-token logits [V] float32 of an image prompt (a block-size
    multiple of tokens) on two sides. Kernels: the engine's own splice
    (``_chunk_inputs``) as the forward's ``inputs_embeds``, through the
    engine's prefill attend (the family's kernel, into the engine's pages
    1 ..). Plain: no splice and no ``inputs_embeds`` at all: the soft
    tokens appended to the embedding table as rows V.., the image
    positions' ids pointing at them, so the forward's token path embeds
    (and, for Gemma, scales) them; plain causal attention. A splice at the
    wrong rows, or an ``inputs_embeds`` branch that skips Gemma's
    sqrt(hidden) factor, parts the two. ``unscaled``: the kernel side's
    image rows divided by that factor (Gemma's image embeddings left
    unscaled): a mutant the check must catch."""
    from types import SimpleNamespace

    from dynamo_tpu_torch.models import gemma
    from dynamo_tpu_torch.ops import attention as att

    cfg, bs, V = engine.mcfg, engine.cfg.block_size, engine.mcfg.vocab_size
    S = len(req.token_ids)
    mm, mask = engine._encode_images(req)
    tokens = np.asarray(req.token_ids, np.int64)
    pos = torch.arange(S, device="cuda")
    with torch.inference_mode():
        ids, embeds = engine._chunk_inputs(SimpleNamespace(mm_embeds=mm, mm_mask=mask),
                                           torch.as_tensor(tokens, device="cuda"), 0, S)
        if unscaled:
            norm = gemma._rounded(cfg.hidden_size ** 0.5, embeds.dtype)
            mask_t = torch.as_tensor(mask, device="cuda")[:, None]
            embeds = torch.where(mask_t, embeds / norm, embeds)
        rows = np.flatnonzero(mask)
        table = torch.cat([engine.params["embed"],
                           torch.as_tensor(mm[rows], device="cuda").to(cfg.dtype)])
        plain_ids = tokens.copy()
        plain_ids[rows] = V + np.arange(len(rows))
        pages = torch.arange(1, S // bs + 1, device="cuda")
        attend = engine._chunk_attend(pages.to(torch.int32), 0, S, S, pages)
        sides = ((engine.params, ids, attend, dict(inputs_embeds=embeds)),
                 ({**engine.params, "embed": table}, torch.as_tensor(plain_ids, device="cuda"),
                  lambda q, k, v, i, **kw: att.causal_attention(q, k, v, **kw), {}))
        logits = []
        for params, x, att_fn, kw in sides:
            hidden = engine._forward(params, cfg, x, pos, att_fn, **kw)
            logits.append(engine._lm_logits(engine.params, cfg, hidden[-1:])[0].float())
        del table
    return logits


def shapes_vision(torch, smi: str) -> dict:
    """(d): vision prompts on Gemma, gpt-oss and DeepSeek mains at full
    width and reduced depth (SHAPES_VISION), the default tower at
    out_hidden_size = hidden: the first-token logits of an image prompt,
    kernels against plain ops, within MODEL_REL_TOL (Gemma's image
    embeddings left unscaled must fail it); then 4 image prompts served to
    the end through the family's prefill kernel, no mixed step."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.models import registry
    from dynamo_tpu_torch.models.vision import IMAGE_TOKEN_ID, VisionConfig

    tok = ByteTokenizer()
    out = {}
    for main, layers in SHAPES_VISION:
        t0 = time.perf_counter()
        mcfg = dataclasses.replace(shape_config(main), num_layers=layers)
        params = registry.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0),
                                      "cuda")
        pin_router(mcfg, params, np.random.default_rng(5))
        vcfg = VisionConfig(out_hidden_size=mcfg.hidden_size)
        P = vcfg.num_patches
        rng = np.random.default_rng(23)
        engine = TorchEngine(TorchEngineConfig(
            model=mcfg, num_blocks=2048, block_size=BS, max_batch_size=8, max_context=4096,
            seed=0, vision=vcfg, decode_steps=HZ_STEPS, decode_pipeline=1), params=params)
        # the prompt ends with its image, so that the first token's logits
        # read an image position's own embedding
        text = words_text(tok, rng, 512 - P)
        img = rng.random((vcfg.image_size, vcfg.image_size, 3)).astype(np.float32)
        check_req = preq("logits", text + [IMAGE_TOKEN_ID] * P, 1, [img])
        got, want = image_prompt_logits(torch, engine, check_req)
        rel = ((got - want).norm() / want.norm()).item()
        if not torch.isfinite(got).all() or rel > MODEL_REL_TOL:
            raise AssertionError(f"shapes vision {main}: image prompt logits, kernels vs "
                                 f"plain, relative L2 {rel:.4g} (limit {MODEL_REL_TOL})")
        run = {"logits_rel_l2": rel}
        if registry.is_gemma(mcfg):
            bad, _ = image_prompt_logits(torch, engine, check_req, unscaled=True)
            run["unscaled_mutant_rel_l2"] = ((bad - want).norm() / want.norm()).item()
            if run["unscaled_mutant_rel_l2"] <= MODEL_REL_TOL:
                raise AssertionError(f"shapes vision {main}: image embeddings left unscaled "
                                     f"pass the check ({run['unscaled_mutant_rel_l2']:.4g})")
        reqs = []
        for i, n in enumerate(SHAPES_VIS_TEXT):
            t = words_text(tok, rng, n)
            im = rng.random((vcfg.image_size, vcfg.image_size, 3)).astype(np.float32)
            reqs.append(preq(f"v{i}", t[:n // 2] + [IMAGE_TOKEN_ID] * P + t[n // 2:],
                             SHAPES_VIS_TOKENS, [im]))

        async def serve_all():
            reset_launches()
            stats, wall = await run_requests(engine, reqs, [0.25 * i for i in range(len(reqs))])
            return stats, wall, read_launches()

        try:
            stats, wall, launches = asyncio.run(serve_all())
        finally:
            engine.stop()
        for s in stats:
            if len(s["tokens"]) != SHAPES_VIS_TOKENS or s["finish"] != "length":
                raise AssertionError(f"shapes vision {main}: request {s['i']}: "
                                     f"{len(s['tokens'])} tokens, finish {s['finish']!r}")
        prefill = "latent_wide" if registry.is_mla(mcfg) else "unified_windowed"
        if launches[prefill] <= 0 or launches["flash_extend"] or launches["decode"]:
            raise AssertionError(f"shapes vision {main}: image prefill chunks went elsewhere "
                                 f"than the family's kernel: {launches}")
        if engine.step_counts["mixed"]:
            raise AssertionError(f"shapes vision {main}: a mixed step ran")
        run.update(latency_summary(stats, wall), steps=dict(engine.step_counts),
                   launches=launches, encoder_cache=engine.encoder_cache.stats(),
                   seconds=time.perf_counter() - t0)
        out[main] = run
        log(f"shapes vision {main} ({layers} layers) on {smi}: first-token logits of a "
            f"{len(check_req.token_ids)}-token image prompt, kernels vs plain, relative L2 "
            f"{rel:.4g} (limit {MODEL_REL_TOL})"
            + (f"; unscaled image embeddings {run['unscaled_mutant_rel_l2']:.4g}"
               if "unscaled_mutant_rel_l2" in run else "")
            + f"; {len(reqs)} image prompts served, TTFT median "
            f"{run['ttft_s_median'] * 1e3:.0f} ms, ITL median {run['itl_s_median'] * 1e3:.2f} "
            f"ms; steps {run['steps']}; launches {launches} [{run['seconds']:.1f} s]")
        del engine, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def shapes_phase(torch, gen, smi: str, timer) -> tuple:
    """Phase 12 (module docstring). Returns (the timed kernel rows by
    report name, the phase's report)."""
    out = {}
    t0 = time.perf_counter()
    out["forms"], results = shapes_kernels(torch, gen, timer)
    out["kernels_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    for part, fn in (("serving", shapes_serving), ("spec", shapes_spec),
                     ("vision", shapes_vision)):
        t0 = time.perf_counter()
        out[part] = fn(torch, smi)
        out[part + "_s"] = time.perf_counter() - t0
        log(f"shapes {part} [{out[part + '_s']:.1f} s]")
    # each timed row's launches: the serving run of its model and cache
    for model, _, tag, _ in SHAPE_MODELS:
        for int8 in (False, True):
            run = out["serving"][model + ("_int8" if int8 else "")]
            for kernel, key in (("paged_decode_attention", "decode"),
                                ("flash_extend_attention", "flash_extend"),
                                ("ragged_paged_attention", "unified")):
                sfx = "_int8" if int8 else ""
                results[kernel + tag + sfx]["launches"] = run["launches"][key + sfx]
    return results, out


# ------------------------------------------------------------- phase 13
# the serving plane: three processes as a user starts them (README, "the
# port's quick start"), the 8-prompt traffic through the OpenAI frontend
FE_MODEL = "llama3-8b"
FE_PROMPTS = (100, 700, 1500, 2600, 3300, 4100, 5000, 6000)
FE_TOKENS = 32
# the traffic once on each side (a second run with new prompts repeated
# the same gates; cut to keep the command inside its time limit)
FE_RUNS = 1
FE_SAMPLED = 2          # one seeded sampled request; the rest greedy
FE_GREEDY = (200, 1000, 3000)
# phase 13's HTTPS frontend: the committed localhost pair, and its prompt
FE_TLS = (os.path.join(HERE, "tests", "data", "tls_localhost.crt"),
          os.path.join(HERE, "tests", "data", "tls_localhost.key"))
FE_HTTPS_PROMPT = 600
KSERVE = "/inference.GRPCInferenceService/"
FE_WORKER = ("--preset", FE_MODEL, "--model", FE_MODEL, "--max-context", "8192",
             "--seed", "0", "--tool-parser", "hermes", "--reasoning-parser", "qwen3")
FE_HIDDEN = 4096        # llama3-8b's embedding width
FE_SCHEMA = {"type": "object",
             "properties": {"ok": {"type": "boolean"}, "mood": {"enum": ["happy", "sad"]}},
             "required": ["ok", "mood"]}
FE_READY_S = 300.0
# the parser requests: a tool whose arguments a finite grammar can hold
FE_TOOL_PARAMS = {"type": "object",
                  "properties": {"city": {"enum": ["Paris", "Tokyo", "Lima"]},
                                 "unit": {"enum": ["c", "f"]}},
                  "required": ["city", "unit"]}
FE_TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "the weather in a city",
    "parameters": FE_TOOL_PARAMS}}]
FE_HERMES = (r'<tool_call>\{"name": "get_weather", "arguments": \{"city": '
             r'"(Paris|Tokyo|Lima)", "unit": "(c|f)"\}\}</tool_call>')
FE_THINK = r"<think>[a-z ]{4,24}</think>[A-Za-z ]{4,24}"
FE_STEADY = 8           # the decode probe: requests sent at once,
FE_STEADY_PROMPT = 64   # prompt tokens each,
FE_STEADY_TOKENS = 256  # greedy tokens each
# the decode probe's SLA class, on both processes (its targets are loose:
# the class's ledger is checked, not its attainment)
FE_SLA_CLASS = "probe"
FE_SLA_CLASSES = f"{FE_SLA_CLASS}:ttft=30,itl=1"
# the request spans of one traced request: name -> the name of its parent
FE_SPAN_PARENTS = {"http.generate": None, "router.schedule": "http.generate",
                   "worker.generate": "router.schedule", "engine.queue": "router.schedule",
                   "engine.prefill": "router.schedule", "engine.decode": "router.schedule"}
FE_TIMELINE = ("queued", "admitted", "first_token", "finish")


class Proc:
    """A child process whose merged output a thread collects line by line."""

    def __init__(self, name: str, *args: str, env=None):
        import threading

        self.name = name
        self.lines: list = []
        self.proc = subprocess.Popen([sys.executable, "-m", *args], cwd=HERE,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True,
                                     env={**os.environ, "PYTHONPATH": HERE, **(env or {})})
        self._cond = threading.Condition()
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            with self._cond:
                self.lines.append(line.rstrip("\n"))
                self._cond.notify_all()
        with self._cond:
            self._cond.notify_all()

    def wait_line(self, prefix: str, timeout: float = FE_READY_S) -> str:
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                hit = next((ln for ln in self.lines if ln.startswith(prefix)), None)
                if hit is not None:
                    return hit
                if self.proc.poll() is not None and not self._thread.is_alive():
                    raise AssertionError(f"{self.name} exited ({self.proc.returncode}) before "
                                         f"{prefix!r}:\n" + "\n".join(self.lines[-40:]))
                left = deadline - time.monotonic()
                if left <= 0:
                    raise AssertionError(f"{self.name}: no {prefix!r} in {timeout:.0f} s:\n"
                                         + "\n".join(self.lines[-40:]))
                self._cond.wait(min(left, 1.0))

    def errors(self) -> list:
        return [ln for ln in self.lines if " ERROR " in ln or ln.startswith("Traceback")]

    def join(self, timeout: float = 60.0) -> int:
        """Wait for the process to end on its own; stop it past ``timeout``."""
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            pass
        return self.stop()

    def stop(self, timeout: float = 60.0) -> int:
        import signal as _signal

        if self.proc.poll() is None:
            self.proc.send_signal(_signal.SIGTERM)
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._thread.join(5.0)
        return self.proc.returncode


async def http_call(port: int, method: str, path: str, body=None, close_after=None,
                    headers=None, tls=None):
    """One HTTP/1.1 request over asyncio streams: (status, JSON body) or, for
    a server-sent event stream, (status, [(arrival s, payload)...]) (an
    event's ``event:`` line, as the Responses stream sends, is dropped: its
    payload names its type). ``close_after`` events, the client closes the
    connection (a disconnect). ``headers`` (a dict) receives the
    response's headers, names in lower case. ``tls``: an
    ``ssl.SSLContext`` for an HTTPS frontend (the name checked: localhost)."""
    if tls is None:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
    else:
        reader, writer = await asyncio.open_connection("127.0.0.1", port, ssl=tls,
                                                       server_hostname="localhost")
    data = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: "
                 f"application/json\r\nContent-Length: {len(data)}\r\nConnection: close"
                 "\r\n\r\n".encode() + data)
    await writer.drain()
    try:
        head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1").split("\r\n")
        status = int(head[0].split(" ")[1])
        got = {k.strip().lower(): v.strip() for k, _, v in
               (h.partition(":") for h in head[1:] if h)}
        if headers is not None:
            headers.update(got)
        if "chunked" not in got.get("transfer-encoding", ""):
            raw = await reader.readexactly(int(got.get("content-length", "0")))
            return status, json.loads(raw) if raw else None
        out, buf = [], b""
        while True:
            size = int((await reader.readuntil(b"\r\n")).strip(), 16)
            if size == 0:
                break
            buf += await reader.readexactly(size)
            await reader.readexactly(2)
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                if event.startswith(b"event: "):
                    event = event.partition(b"\n")[2]
                if event.startswith(b"data: "):
                    payload = event[6:].decode()
                    out.append((time.perf_counter(),
                                payload if payload == "[DONE]" else json.loads(payload)))
                    if close_after is not None and len(out) >= close_after:
                        return status, out
        return status, out
    finally:
        writer.close()


def fe_prompt(n: int, seed: int) -> str:
    """A prompt of ``n`` bytes (n byte-tokenizer tokens) of random words."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, size=rng.integers(2, 9))).decode()
             for _ in range(4000)]
    return " ".join(words[int(i)] for i in rng.integers(0, len(words), size=n))[:n]


def fe_bodies(run: int) -> list:
    """The 8-prompt traffic as OpenAI bodies: chat and completions in turn,
    streamed, FE_TOKENS each (EOS ignored, so each streams them all); each
    run its own prompts (no run finds another's prefix cached)."""
    bodies = []
    for i, n in enumerate(FE_PROMPTS):
        text = fe_prompt(n, 100 + 10 * run + i)
        samp = (dict(temperature=0.8, top_p=0.95, seed=11) if i == FE_SAMPLED
                else dict(temperature=0.0))
        common = dict(model=FE_MODEL, max_tokens=FE_TOKENS, stream=True, ignore_eos=True,
                      stream_options={"include_usage": True}, **samp)
        if i % 2 == 0:
            bodies.append(("/v1/chat/completions",
                           dict(messages=[{"role": "user", "content": text}], **common)))
        else:
            bodies.append(("/v1/completions", dict(prompt=text, **common)))
    return bodies


def fe_stream_stats(t_sub: float, events: list, chat: bool) -> dict:
    """TTFT, ITL (the mean gap between a request's tokens: last content
    event minus first over tokens - 1), tokens (from usage), finish."""
    if not events or events[-1][1] != "[DONE]":
        raise AssertionError(f"stream did not end in [DONE]: {events[-2:]}")
    chunks = [(t, e) for t, e in events if e != "[DONE]"]
    content = [t for t, e in chunks if e["choices"] and (
        (e["choices"][0].get("delta") or {}).get("content") if chat
        else e["choices"][0].get("text"))]
    finish = [e["choices"][0]["finish_reason"] for _, e in chunks
              if e["choices"] and e["choices"][0].get("finish_reason")]
    usage = [e["usage"] for _, e in chunks if e.get("usage")]
    if not finish or not usage:
        raise AssertionError(f"stream without finish_reason or usage: {chunks[-3:]}")
    n = usage[-1]["completion_tokens"]
    return {"tokens": n, "finish": finish[-1], "usage": usage[-1], "events": len(chunks),
            "ttft_s": content[0] - t_sub,
            "itl_s": (content[-1] - content[0]) / (n - 1) if n > 1 else None}


def scrape_histograms(text: str) -> dict:
    """sum and count of the frontend's TTFT and ITL histograms (/metrics)."""
    out = {}
    for name in ("dtpu_time_to_first_token_seconds", "dtpu_inter_token_latency_seconds"):
        vals = {}
        for line in text.splitlines():
            for part in ("_sum", "_count"):
                if line.startswith(name + part + "{"):
                    vals[part[1:]] = vals.get(part[1:], 0.0) + float(line.rsplit(" ", 1)[1])
        out[name] = {**vals, "mean_s": vals.get("sum", 0.0) / max(vals.get("count", 0.0), 1.0)}
    return out


def frontend_token_ids(logprobs: dict, top: list) -> list:
    """Token ids of a greedy completion through the frontend, from its
    logprobs block (``tokens``, ``token_logprobs``). A string that one id
    decodes to gives that id. One that several ids decode to (the byte
    tokenizer decodes a lone byte 128-255 as U+FFFD) gives the id among the
    in-process run's top logprobs at that index (``top``, id -> logprob)
    that decodes to it with the frontend's logprob, within 1e-3; None
    (a mismatch) where not exactly one does."""
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    special = {v: k for k, v in ByteTokenizer._SPECIAL.items()}
    out = []
    for k, (s, lp) in enumerate(zip(logprobs["tokens"], logprobs["token_logprobs"])):
        if s.startswith("<unk:") and s.endswith(">"):
            out.append(int(s[5:-1]))
        elif s in special:
            out.append(special[s])
        elif len(s) == 1 and ord(s) < 128:
            out.append(ord(s))
        else:
            alts = top[k] if k < len(top) else {}
            hits = [t for t, v in alts.items()
                    if tok.decode([t], skip_special_tokens=False) == s and abs(v - lp) <= 1e-3]
            out.append(hits[0] if len(hits) == 1 else None)
    return out


async def fe_traffic(port: int, bodies: list, gap: float = 0.25) -> tuple:
    """Requests through the frontend, request i ``gap`` s after request i-1."""
    stats = [None] * len(bodies)

    async def one(i, path, body):
        await asyncio.sleep(gap * i)
        t_sub = time.perf_counter()
        status, events = await http_call(port, "POST", path, body)
        if status != 200:
            raise AssertionError(f"frontend request {i}: HTTP {status}: {events}")
        stats[i] = fe_stream_stats(t_sub, events, path.endswith("chat/completions"))

    t0 = time.perf_counter()
    await asyncio.gather(*(one(i, p, b) for i, (p, b) in enumerate(bodies)))
    return stats, time.perf_counter() - t0


def fe_summary(stats: list, wall: float) -> dict:
    ttft = sorted(s["ttft_s"] for s in stats)
    itl = sorted(s["itl_s"] for s in stats if s["itl_s"] is not None)
    return {"requests": len(stats), "wall_s": wall,
            "output_tok_s": sum(s["tokens"] for s in stats) / wall,
            "ttft_s_median": statistics.median(ttft), "ttft_s_max": ttft[-1],
            "ttft_s_mean": statistics.mean(ttft),
            "itl_s_median": statistics.median(itl), "itl_s_max": itl[-1]}


def fe_steady_bodies(sla=None) -> list:
    """The decode probe: FE_STEADY requests of FE_STEADY_PROMPT tokens sent
    at once, FE_STEADY_TOKENS greedy tokens each, so that after one prefill
    the batch only decodes: its ITL is the horizon's time a token plus what
    the path adds to each output, with no prefill chunk in the gaps.
    ``sla`` names the requests' SLA class (phase 13's)."""
    return [("/v1/completions", dict(
        model=FE_MODEL, prompt=fe_prompt(FE_STEADY_PROMPT, 600 + i),
        max_tokens=FE_STEADY_TOKENS, temperature=0.0, ignore_eos=True, stream=True,
        stream_options={"include_usage": True}, **({"sla": sla} if sla else {})))
        for i in range(FE_STEADY)]


def check_fe_stats(tag: str, stats: list, tokens: int) -> None:
    for i, s in enumerate(stats):
        if s["tokens"] != tokens or s["finish"] != "length":
            raise AssertionError(f"{tag} request {i}: {s['tokens']} tokens, finish "
                                 f"{s['finish']!r}; expected {tokens}, 'length'")
        if "usage" in s and s["usage"]["total_tokens"] != s["usage"]["prompt_tokens"] + tokens:
            raise AssertionError(f"{tag} request {i}: usage {s['usage']}")


def fe_weather_args(arguments: str) -> dict:
    """A get_weather call's arguments: JSON that obeys FE_TOOL_PARAMS."""
    args = json.loads(arguments)
    props = FE_TOOL_PARAMS["properties"]
    if set(args) != set(props) or any(args[k] not in props[k]["enum"] for k in props):
        raise AssertionError(f"get_weather arguments outside the tool's schema: {args}")
    return args


def fe_joined_calls(events: list) -> list:
    """A stream's tool-call deltas joined by index: [(name, arguments)]."""
    calls = {}
    for _, e in events:
        if e == "[DONE]" or not e["choices"]:
            continue
        for tc in e["choices"][0].get("delta", {}).get("tool_calls") or []:
            name, args = calls.get(tc["index"], ("", ""))
            fn = tc.get("function") or {}
            calls[tc["index"]] = (name + (fn.get("name") or ""),
                                  args + (fn.get("arguments") or ""))
    return [calls[i] for i in sorted(calls)]


def fe_stream_field(events: list, field: str) -> str:
    return "".join(e["choices"][0].get("delta", {}).get(field) or "" for _, e in events
                   if e != "[DONE]" and e["choices"])


def fe_stream_finish(events: list) -> str:
    return [e["choices"][0]["finish_reason"] for _, e in events
            if e != "[DONE]" and e["choices"] and e["choices"][0].get("finish_reason")][-1]


async def fe_parsers(port: int) -> dict:
    """The worker's card names the hermes tool parser and the qwen3
    reasoning parser. A named tool_choice (the soft grammar on the card
    holds the model to the tool's schema, even with random weights), whole
    and streamed after a warm-up of the same prompt (both then find the
    same blocks cached, so that greedy decoding gives both one call); a
    hermes call and a <think> answer, each forced with guided_regex."""
    chat = dict(model=FE_MODEL, temperature=0.0, tools=FE_TOOLS,
                messages=[{"role": "user", "content": "Weather in Paris? Use the tool."}])
    named = dict(chat, max_tokens=256,   # the grammar bounds the reply to ~210 tokens
                 tool_choice={"type": "function", "function": {"name": "get_weather"}})
    out = {}
    status, body = await http_call(port, "POST", "/v1/chat/completions",
                                   dict(named, max_tokens=1))
    if status != 200:
        raise AssertionError(f"named tool_choice warm-up: HTTP {status}: {body}")
    status, body = await http_call(port, "POST", "/v1/chat/completions", named)
    choice = body["choices"][0] if status == 200 else {}
    calls = (choice.get("message") or {}).get("tool_calls") or []
    if choice.get("finish_reason") != "tool_calls" or len(calls) != 1 or \
            calls[0]["function"]["name"] != "get_weather":
        raise AssertionError(f"named tool_choice: HTTP {status}: {body}")
    call = (calls[0]["function"]["name"], calls[0]["function"]["arguments"])
    out["named_call"] = fe_weather_args(call[1])
    status, events = await http_call(port, "POST", "/v1/chat/completions",
                                     dict(named, stream=True))
    if status != 200 or events[-1][1] != "[DONE]":
        raise AssertionError(f"named tool_choice, streamed: HTTP {status}: {events[-3:]}")
    streamed = fe_joined_calls(events)
    if streamed != [call] or fe_stream_finish(events) != "tool_calls":
        raise AssertionError(f"named tool_choice: the streamed calls {streamed} "
                             f"({fe_stream_finish(events)}) are not the whole reply's {call}")
    status, body = await http_call(port, "POST", "/v1/chat/completions", dict(
        chat, max_tokens=160, guided_regex=FE_HERMES))
    choice = body["choices"][0] if status == 200 else {}
    calls = (choice.get("message") or {}).get("tool_calls") or []
    if choice.get("finish_reason") != "tool_calls" or len(calls) != 1 or \
            calls[0]["function"]["name"] != "get_weather" or \
            choice["message"].get("content"):
        raise AssertionError(f"hermes call: HTTP {status}: {body}")
    out["hermes_call"] = fe_weather_args(calls[0]["function"]["arguments"])
    status, events = await http_call(port, "POST", "/v1/chat/completions", dict(
        model=FE_MODEL, temperature=0.0, max_tokens=80, guided_regex=FE_THINK, stream=True,
        messages=[{"role": "user", "content": "Think, then answer."}]))
    reasoning = fe_stream_field(events, "reasoning_content") if status == 200 else ""
    content = fe_stream_field(events, "content") if status == 200 else ""
    if not (re.fullmatch(r"[a-z ]{4,24}", reasoning) and re.fullmatch(r"[A-Za-z ]{4,24}",
                                                                      content)):
        raise AssertionError(f"<think> answer, streamed: HTTP {status}: reasoning "
                             f"{reasoning!r}, content {content!r}")
    out["think"] = {"reasoning": reasoning, "content": content}
    return out


async def fe_responses(port: int) -> dict:
    """/v1/responses, aggregated and streamed, held to the greedy chat
    request with the same message: the same text, the same token count,
    the stream's events in order with its deltas joining to that text.
    A one-token warm-up of the message first, so that all three find the
    same blocks cached."""
    text = fe_prompt(300, 350)
    chat = dict(model=FE_MODEL, messages=[{"role": "user", "content": text}],
                temperature=0.0)
    status, body = await http_call(port, "POST", "/v1/chat/completions",
                                   dict(chat, max_tokens=1))
    if status != 200:
        raise AssertionError(f"responses warm-up: HTTP {status}: {body}")
    status, body = await http_call(port, "POST", "/v1/chat/completions",
                                   dict(chat, max_tokens=FE_TOKENS))
    if status != 200:
        raise AssertionError(f"responses' chat twin: HTTP {status}: {body}")
    want = body["choices"][0]["message"]["content"] or ""
    want_tokens = body["usage"]["completion_tokens"]
    resp = dict(model=FE_MODEL, input=text, max_output_tokens=FE_TOKENS, temperature=0.0)
    status, whole = await http_call(port, "POST", "/v1/responses", resp)
    ok = (status == 200 and whole.get("object") == "response"
          and whole.get("status") == "completed" and whole["id"].startswith("resp_"))
    got = whole["output"][0]["content"][0]["text"] if ok else None
    if not ok or got != want or whole["usage"]["output_tokens"] != want_tokens:
        raise AssertionError(f"/v1/responses: HTTP {status}: {str(whole)[:400]}; the chat "
                             f"text {want[:200]!r} ({want_tokens} tokens)")
    status, events = await http_call(port, "POST", "/v1/responses", dict(resp, stream=True))
    kinds = [e["type"] for _, e in events] if status == 200 else []
    deltas = "".join(e["delta"] for _, e in events if e["type"] == "response.output_text.delta")
    final = events[-1][1]["response"] if kinds and kinds[-1] == "response.completed" else {}
    if (status != 200 or kinds[0] != "response.created" or deltas != want
            or set(kinds[1:-1]) - {"response.output_text.delta"}
            or final.get("output", [{}])[0].get("content", [{}])[0].get("text") != want):
        raise AssertionError(f"/v1/responses streamed: HTTP {status}: events {kinds[:8]}..., "
                             f"deltas {deltas[:200]!r}; the chat text {want[:200]!r}")
    return {"tokens": want_tokens, "deltas": len(kinds) - 2, "text": want[:40]}


async def fe_through_frontend(port: int) -> dict:
    """Everything the phase sends through the frontend, in order."""
    out = {"traffic": []}
    for run in range(FE_RUNS):
        stats, wall = await fe_traffic(port, fe_bodies(run))
        check_fe_stats("frontend", stats, FE_TOKENS)
        out["traffic"].append(fe_summary(stats, wall))
    # the frontend's own histograms over exactly the traffic's requests
    _, text = await http_text(port, "/metrics")
    out["metrics"] = scrape_histograms(text)
    stats, wall = await fe_traffic(port, fe_steady_bodies(FE_SLA_CLASS), gap=0.0)
    check_fe_stats("frontend decode probe", stats, FE_STEADY_TOKENS)
    out["steady"] = fe_summary(stats, wall)
    # one request whose timeline and spans the observability checks read
    status, body = await http_call(port, "POST", "/v1/completions", dict(
        model=FE_MODEL, prompt=fe_prompt(700, 700), max_tokens=FE_TOKENS, temperature=0.0,
        ignore_eos=True))
    if status != 200:
        raise AssertionError(f"the traced request: HTTP {status}: {body}")
    out["traced_id"] = body["id"]
    # greedy prompts one at a time, with logprobs for the tie rule
    out["greedy"] = []
    for j, n in enumerate(FE_GREEDY):
        status, body = await http_call(port, "POST", "/v1/completions", dict(
            model=FE_MODEL, prompt=fe_prompt(n, 200 + j), max_tokens=FE_TOKENS,
            temperature=0.0, logprobs=2, ignore_eos=True))
        if status != 200:
            raise AssertionError(f"greedy request {j}: HTTP {status}: {body}")
        out["greedy"].append(body["choices"][0]["logprobs"])
    # n = 2 with a seed: two choices of FE_TOKENS // 2 tokens each, different
    status, body = await http_call(port, "POST", "/v1/completions", dict(
        model=FE_MODEL, prompt=fe_prompt(300, 300), max_tokens=FE_TOKENS // 2, n=2, seed=3,
        temperature=0.9, ignore_eos=True))
    choices = body["choices"] if status == 200 else []
    if (len(choices) != 2 or [c["index"] for c in choices] != [0, 1]
            or body["usage"]["completion_tokens"] != FE_TOKENS
            or any(c["finish_reason"] != "length" for c in choices)
            or choices[0]["text"] == choices[1]["text"]):
        raise AssertionError(f"n = 2: HTTP {status}: {body}")
    out["n2_texts"] = [c["text"][:40] for c in choices]
    # guided decoding through response_format: the answer parses and obeys
    status, body = await http_call(port, "POST", "/v1/chat/completions", dict(
        model=FE_MODEL, messages=[{"role": "user", "content": "Answer in JSON."}],
        max_tokens=200, temperature=0.0,
        response_format={"type": "json_schema", "json_schema": {"schema": FE_SCHEMA}}))
    try:
        answer = json.loads(body["choices"][0]["message"]["content"])
        ok = (body["choices"][0]["finish_reason"] == "stop" and set(answer) == {"ok", "mood"}
              and isinstance(answer["ok"], bool) and answer["mood"] in ("happy", "sad"))
    except (KeyError, TypeError, ValueError):
        ok = False
    if status != 200 or not ok:
        raise AssertionError(f"guided response_format: HTTP {status}: {body}")
    out["guided_answer"] = answer
    # an embedding
    emb_text = fe_prompt(400, 400)
    status, body = await http_call(port, "POST", "/v1/embeddings",
                                   dict(model=FE_MODEL, input=emb_text))
    vec = np.asarray(body["data"][0]["embedding"], np.float64) if status == 200 else None
    if (vec is None or vec.shape != (FE_HIDDEN,) or not np.isfinite(vec).all()
            or abs(np.linalg.norm(vec) - 1.0) > 1e-3
            or body["usage"]["prompt_tokens"] != len(emb_text.encode())):
        raise AssertionError(f"embedding: HTTP {status}: {str(body)[:300]}")
    out["embedding"] = vec.tolist()
    out["responses"] = await fe_responses(port)
    # tool calls and reasoning; before the disconnect, so that the last
    # request is one the engine ends itself (a grammar's forced EOS is
    # seen by the Backend, which stops the engine's request a tick later)
    t0 = time.perf_counter()
    out["parsers"] = await fe_parsers(port)
    out["parsers"]["seconds"] = time.perf_counter() - t0
    # a client that disconnects mid-stream, then the next request
    status, events = await http_call(port, "POST", "/v1/completions", dict(
        model=FE_MODEL, prompt=fe_prompt(500, 500), max_tokens=2000, stream=True,
        ignore_eos=True), close_after=2)
    if status != 200 or not events:
        raise AssertionError(f"disconnect: HTTP {status}: {events}")
    inflight = None
    for _ in range(200):
        await asyncio.sleep(0.05)
        _, text = await http_text(port, "/metrics")
        inflight = [ln for ln in text.splitlines() if ln.startswith("dtpu_inflight_requests")]
        if inflight and inflight[0].endswith(" 0.0") and 'status="499"' in text:
            break
    counted = 'status="499"' in text
    if not inflight or not inflight[0].endswith(" 0.0") or not counted:
        raise AssertionError(f"after a disconnect: {inflight}, a 499 counted: {counted}")
    status, body = await http_call(port, "POST", "/v1/completions", dict(
        model=FE_MODEL, prompt="after the disconnect", max_tokens=8, ignore_eos=True))
    if status != 200 or body["usage"]["completion_tokens"] != 8:
        raise AssertionError(f"the request after a disconnect: HTTP {status}: {body}")
    return out


async def http_text(port: int, path: str) -> tuple:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\n\r\n"
                 .encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), body.decode()


async def fe_observability(port: int, status_port: int, traced_id: str) -> dict:
    """The worker's status server and the frontend's debug routes, once
    the traffic is done and the engine idle: the phase's gates on them
    (module docstring); returns the step counts by phase in the worker's
    /metrics, the drift ratios and the health events."""
    obs = {}
    for _ in range(200):
        status, doc = await http_call(status_port, "GET", "/debug/worker")
        if status == 200 and doc["engine"]["running"] == 0 and doc["engine"]["waiting"] == 0:
            break
        await asyncio.sleep(0.05)
    else:
        raise AssertionError(f"the engine never went idle: {doc.get('engine')}")
    missing = [k for k in ("telemetry", "slo", "attribution", "health") if k not in doc]
    if missing:
        raise AssertionError(f"/debug/worker lacks {missing}: {sorted(doc)}")
    obs["drift"], obs["health_events"] = doc.get("drift", {}), doc["health"]["recent"]
    status, live = await http_call(status_port, "GET", "/live")
    if status != 200 or live.get("status") != "live":
        raise AssertionError(f"/live: HTTP {status}: {live}")
    status, health = await http_call(status_port, "GET", "/health")
    canary = health["subsystems"].get("backend/generate", {}) if health else {}
    if (status != 200 or health["status"] != "healthy" or not canary.get("healthy")
            or not canary.get("detail", "").startswith("rtt=")):
        raise AssertionError(f"/health: HTTP {status}: {health}")
    obs["canary"] = canary["detail"]
    status, flight = await http_call(status_port, "GET", f"/debug/requests?id={traced_id}")
    kinds = [e["event"]["kind"] for e in flight.get("events", [])] if flight else []
    if status != 200 or [k for k in kinds if k in FE_TIMELINE] != list(FE_TIMELINE):
        raise AssertionError(f"/debug/requests?id={traced_id}: HTTP {status}: {kinds}")
    status, _ = await http_call(status_port, "GET", "/debug/requests?id=never-served")
    if status != 404:
        raise AssertionError(f"/debug/requests of an unknown id: HTTP {status}, not 404")
    for name, p in (("worker", status_port), ("frontend", port)):
        status, slo = await http_call(p, "GET", "/debug/slo")
        got = (slo or {}).get("models", {}).get(FE_MODEL, {}).get(FE_SLA_CLASS, {})
        n = got.get("windows", {}).get("total", {}).get("requests")
        if status != 200 or n != FE_STEADY:
            raise AssertionError(f"the {name}'s /debug/slo counts {n} {FE_SLA_CLASS!r} "
                                 f"requests, {FE_STEADY} were sent: {slo}")
    status, fleet = await http_call(port, "GET", "/debug/fleet")
    workers = fleet.get("workers", []) if fleet else []
    if (status != 200 or len(workers) != 1 or workers[0]["stale"]
            or "error" in workers[0] or fleet["fleet"]["workers_live"] != 1):
        raise AssertionError(f"/debug/fleet: HTTP {status}: {str(fleet)[:600]}")
    _, text = await http_text(status_port, "/metrics")
    steps = {}
    for ln in text.splitlines():
        m = re.match(r'dtpu_engine_step_duration_seconds_count\{.*phase="(\w+)".*\} (\S+)',
                     ln)
        if m:
            steps[m.group(1)] = int(float(m.group(2)))
    obs["metric_steps"] = steps
    return obs


def check_metric_steps(metric: dict, steps: dict) -> None:
    """The step histogram's counts by phase against the engine's step
    counts: a consumed horizon (normal or spec) and an eager step are
    each one ``decode`` step of the telemetry."""
    want = {"prefill": steps["prefill"], "mixed": steps["mixed"],
            "decode": steps["decode"] + steps["horizon"] + steps["spec"]}
    got = {k: metric.get(k, 0) for k in want}
    if got != want or set(metric) - set(want):
        raise AssertionError(f"/metrics step counts {metric} != the engine's {want}")


def check_trace(paths: dict, request_id: str) -> dict:
    """One request's spans in the frontend's and the worker's JSONL files:
    every span of FE_SPAN_PARENTS once, one trace id, each parented on its
    parent's span id. Returns {name: duration ms}."""
    spans = {}
    for proc, path in paths.items():
        with open(path) as f:
            for line in f:
                sp = json.loads(line)
                attrs = {a["key"]: next(iter(a["value"].values())) for a in sp["attributes"]}
                if attrs.get("request_id") == request_id:
                    if sp["name"] in spans:
                        raise AssertionError(f"span {sp['name']} twice for {request_id}")
                    spans[sp["name"]] = sp
    if set(spans) != set(FE_SPAN_PARENTS):
        raise AssertionError(f"spans of {request_id}: {sorted(spans)}, want "
                             f"{sorted(FE_SPAN_PARENTS)}")
    traces = {sp["traceId"] for sp in spans.values()}
    if len(traces) != 1:
        raise AssertionError(f"{request_id}'s spans are in {len(traces)} traces")
    for name, parent in FE_SPAN_PARENTS.items():
        want = spans[parent]["spanId"] if parent else None
        if spans[name].get("parentSpanId") != want:
            raise AssertionError(f"{name}'s parent is {spans[name].get('parentSpanId')}, "
                                 f"not {parent} ({want})")
    return {name: (int(sp["endTimeUnixNano"]) - int(sp["startTimeUnixNano"])) / 1e6
            for name, sp in spans.items()}


async def fe_in_process(engine, emb_text: str) -> dict:
    """The same traffic, decode probe, greedy prompts and embedding on an
    in-process engine (no frontend, no request plane): tokens, top
    logprobs, TTFT, ITL, tok/s on the client clock, as serve() measures
    them."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols import openai

    pre = OpenAIPreprocessor(ModelDeploymentCard(name=FE_MODEL, tokenizer="byte",
                                                 context_length=8192))

    def preprocess(tag, bodies):
        reqs = []
        for i, (path, body) in enumerate(bodies):
            if path.endswith("chat/completions"):
                r = pre.preprocess_chat(openai.ChatCompletionRequest.from_obj(body))
            else:
                r = pre.preprocess_completion(openai.CompletionRequest.from_obj(body),
                                              body["prompt"])
            r.request_id = f"{tag}-{i}"
            reqs.append(r)
        return reqs

    def summary(stats, wall):
        return fe_summary([dict(s, tokens=len(s["tokens"])) for s in stats], wall)

    out = {"traffic": []}
    for run in range(FE_RUNS):
        reqs = preprocess(f"fe{run}", fe_bodies(run))
        stats, wall = await run_requests(engine, reqs,
                                         delays=[0.25 * i for i in range(len(reqs))])
        check_fe_stats("in-process", [dict(s, tokens=len(s["tokens"])) for s in stats],
                       FE_TOKENS)
        out["traffic"].append(summary(stats, wall))
    stats, wall = await run_requests(engine, preprocess("steady", fe_steady_bodies()))
    check_fe_stats("in-process decode probe",
                   [dict(s, tokens=len(s["tokens"])) for s in stats], FE_STEADY_TOKENS)
    out["steady"] = summary(stats, wall)
    greedy = []
    for j, n in enumerate(FE_GREEDY):
        r = pre.preprocess_completion(openai.CompletionRequest.from_obj(dict(
            model=FE_MODEL, prompt=fe_prompt(n, 200 + j), max_tokens=FE_TOKENS,
            temperature=0.0, logprobs=2, ignore_eos=True)), fe_prompt(n, 200 + j))
        r.request_id = f"g{j}"
        (s,), _ = await run_requests(engine, [r])
        greedy.append({"i": j, "tokens": s["tokens"], "top": s["top"],
                       "prompt": list(r.token_ids)})
    out["greedy"] = greedy
    out["embedding"] = (await embed_vectors(engine, [list(emb_text.encode())]))[0]
    return out


def check_worker_exit(report: dict) -> None:
    """The worker's exit line: no slot or KV block still held (the
    disconnected request's included), and kernels 1-3 launched in it, the
    decode kernel through graph replays."""
    if report["busy_slots"] or report["active_blocks"]:
        raise AssertionError(f"the worker ended with busy slots or pinned blocks: {report}")
    for name in ("decode", "flash_extend", "unified"):
        if report["launches"][name] <= 0:
            raise AssertionError(f"the {name} kernel never launched in the worker: "
                                 f"{report['launches']}")
    if report["launches"]["replayed"]["decode"] <= 0:
        raise AssertionError(f"no decode launch in the worker came from a graph replay: "
                             f"{report['launches']}")


def fe_control(path: str) -> int:
    """The frontend phase's control (``chip_smoke.py --fe-control FILE``), in
    a process of its own as the worker is: an engine built from the
    worker's flags and decode schedule serves the same traffic, decode
    probe, greedy prompts and embedding in-process. It holds the
    frontend's greedy streams and embedding (from FILE) to its own: the
    streams equal under the tie rule, the embedding bit for bit. Prints
    one ``FE_CONTROL {json}`` line."""
    import torch

    from dynamo_tpu_torch.engine.__main__ import build_worker_engine, parse_args

    with open(path) as f:
        fe = json.load(f)
    args = parse_args([*FE_WORKER, "--decode-steps", fe["steps"],
                       "--decode-pipeline", fe["pipeline"]])
    engine, _ = build_worker_engine(args)
    emb_text = fe_prompt(400, 400)
    try:
        got = asyncio.run(fe_in_process(engine, emb_text))
    finally:
        engine.stop()
    run = {"requests": []}
    for j, (lp, want) in enumerate(zip(fe["greedy"], got["greedy"])):
        ids = frontend_token_ids(lp, want["top"])
        k = next((k for k, (a, b) in enumerate(zip(ids, want["tokens"])) if a != b), None)
        if k is not None and ids[k] is None:
            raise AssertionError(
                f"frontend greedy request {j}, token {k}: {lp['tokens'][k]!r} (logprob "
                f"{lp['token_logprobs'][k]:.6g}) is no token among the in-process run's top "
                f"logprobs there, {want['top'][k]}")
        run["requests"].append({"i": j, "tokens": ids})
    gaps = tie_rule(torch, "frontend greedy", run, {"requests": got["greedy"]},
                    [g["prompt"] for g in got["greedy"]], engine.params, engine.mcfg)
    a, b = np.asarray(fe["embedding"]), np.asarray(got["embedding"], np.float64)
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    if rel > 1e-5:
        raise AssertionError(f"the frontend's embedding differs from the in-process "
                             f"engine's: relative L2 {rel:.3g}")
    print("FE_CONTROL " + json.dumps({
        "traffic": got["traffic"], "steady": got["steady"], "greedy_tie_gaps": gaps,
        "greedy_equal": sum(r["tokens"] == g["tokens"]
                            for r, g in zip(run["requests"], got["greedy"])),
        "embedding_rel_l2": rel}), flush=True)
    return 0


def stream_text(events: list) -> str:
    """A streamed completion's text, its events' ``text`` joined."""
    return "".join(e["choices"][0].get("text") or "" for _, e in events
                   if e != "[DONE]" and e["choices"])


def kserve_request(kp, text: str, max_tokens: int):
    """A KServe text request (the port's codec): greedy, EOS ignored."""
    req = kp.ModelInferRequest(model_name=FE_MODEL, id="kserve")
    t = req.inputs.add(name="text_input", datatype="BYTES")
    t.shape.append(1)
    t.contents.bytes_contents.append(text.encode())
    req.parameters["max_tokens"].int64_param = max_tokens
    req.parameters["temperature"].double_param = 0.0
    req.parameters["ignore_eos"].bool_param = True
    return req


async def fe_grpc(port: int, grpc_port: int) -> dict:
    """Phase 13's gRPC part: the greedy prompts through ModelInfer and
    ModelStreamInfer (the port's HTTP/2 client), held to the streamed HTTP
    completion of the same prompt; each prompt first warmed with one token,
    so that all three find the same blocks cached. Also the four
    introspection RPCs and a NOT_FOUND."""
    from dynamo_tpu_torch.llm.grpc import kserve as kp
    from dynamo_tpu_torch.runtime import http2

    chan = http2.GrpcChannel(f"127.0.0.1:{grpc_port}")
    infer = chan.unary_unary(KSERVE + "ModelInfer", kp.ModelInferRequest.SerializeToString,
                             kp.ModelInferResponse.FromString)
    stream = chan.unary_stream(KSERVE + "ModelStreamInfer",
                               kp.ModelInferRequest.SerializeToString,
                               kp.ModelStreamInferResponse.FromString)
    out = {"http_ttft_s": [], "grpc_ttft_s": [], "unary_s": [], "http_whole_s": []}
    try:
        for name, req_cls, resp_cls, arg in (
                ("ServerLive", kp.ServerLiveRequest, kp.ServerLiveResponse, {}),
                ("ServerReady", kp.ServerReadyRequest, kp.ServerReadyResponse, {}),
                ("ModelReady", kp.ModelReadyRequest, kp.ModelReadyResponse,
                 {"name": FE_MODEL})):
            call = chan.unary_unary(KSERVE + name, req_cls.SerializeToString, resp_cls.FromString)
            reply = await call(req_cls(**arg))
            if not (reply.live if name == "ServerLive" else reply.ready):
                raise AssertionError(f"gRPC {name}: {reply}")
        meta = await chan.unary_unary(
            KSERVE + "ModelMetadata", kp.ModelMetadataRequest.SerializeToString,
            kp.ModelMetadataResponse.FromString)(kp.ModelMetadataRequest(name=FE_MODEL))
        if meta.name != FE_MODEL or meta.inputs[0].name != "text_input":
            raise AssertionError(f"gRPC ModelMetadata: {meta}")
        try:
            await infer(kp.ModelInferRequest(model_name="nope"))
            raise AssertionError("gRPC ModelInfer of an unknown model answered")
        except http2.GrpcError as e:
            if e.code() != http2.StatusCode.NOT_FOUND:
                raise AssertionError(f"gRPC ModelInfer of an unknown model: {e}") from None
        for j, n in enumerate(FE_GREEDY):
            text = fe_prompt(n, 200 + j)
            body = dict(model=FE_MODEL, prompt=text, max_tokens=FE_TOKENS, temperature=0.0,
                        ignore_eos=True)
            status, _ = await http_call(port, "POST", "/v1/completions",
                                        dict(body, max_tokens=1))
            if status != 200:
                raise AssertionError(f"gRPC warm-up {j}: HTTP {status}")
            t0 = time.perf_counter()
            status, events = await http_call(port, "POST", "/v1/completions", dict(
                body, stream=True, stream_options={"include_usage": True}))
            if status != 200:
                raise AssertionError(f"gRPC twin {j}: HTTP {status}: {events}")
            st = fe_stream_stats(t0, events, chat=False)
            out["http_ttft_s"].append(st["ttft_s"])
            want = stream_text(events)
            t0 = time.perf_counter()
            got, first = [], None
            async for item in stream(kserve_request(kp, text, FE_TOKENS)):
                if item.error_message:
                    raise AssertionError(f"ModelStreamInfer {j}: {item.error_message}")
                part = item.infer_response.outputs[0].contents.bytes_contents[0].decode()
                if part and first is None:
                    first = time.perf_counter() - t0
                got.append(part)
            out["grpc_ttft_s"].append(first)
            t0 = time.perf_counter()
            reply = await infer(kserve_request(kp, text, FE_TOKENS))
            out["unary_s"].append(time.perf_counter() - t0)
            unary = reply.outputs[0].contents.bytes_contents[0].decode()
            finish = reply.parameters["finish_reason"].string_param
            t0 = time.perf_counter()
            status, whole = await http_call(port, "POST", "/v1/completions", body)
            out["http_whole_s"].append(time.perf_counter() - t0)
            if ("".join(got) != want or unary != want or finish != "length"
                    or status != 200 or whole["choices"][0]["text"] != want):
                raise AssertionError(
                    f"gRPC greedy prompt {j} ({n} tokens): ModelStreamInfer "
                    f"{''.join(got)[:60]!r}, ModelInfer {unary[:60]!r} (finish {finish!r}), "
                    f"HTTP {want[:60]!r}")
    finally:
        await chan.close()
    return out


async def fe_https(port: int, tls_port: int) -> dict:
    """Phase 13's HTTPS part: one greedy completion through the TLS
    frontend and its plain twin through the first (each streamed, then
    whole; a 1-token warm-up first, so both find the same blocks cached)."""
    import ssl

    ctx = ssl.create_default_context(cafile=FE_TLS[0])
    body = dict(model=FE_MODEL, prompt=fe_prompt(FE_HTTPS_PROMPT, 250), max_tokens=FE_TOKENS,
                temperature=0.0, ignore_eos=True)
    for _ in range(600):
        status, models = await http_call(tls_port, "GET", "/v1/models", tls=ctx)
        if status == 200 and [m["id"] for m in models["data"]] == [FE_MODEL]:
            break
        await asyncio.sleep(0.05)
    else:
        raise AssertionError(f"the HTTPS frontend never listed {FE_MODEL}")
    await http_call(port, "POST", "/v1/completions", dict(body, max_tokens=1))
    out, texts = {}, {}
    for name, p, tls in (("plain", port, None), ("https", tls_port, ctx)):
        t0 = time.perf_counter()
        status, events = await http_call(p, "POST", "/v1/completions", dict(
            body, stream=True, stream_options={"include_usage": True}), tls=tls)
        if status != 200:
            raise AssertionError(f"{name} completion: HTTP {status}: {events}")
        out[f"{name}_ttft_s"] = fe_stream_stats(t0, events, chat=False)["ttft_s"]
        t0 = time.perf_counter()
        status, whole = await http_call(p, "POST", "/v1/completions", body, tls=tls)
        out[f"{name}_s"] = time.perf_counter() - t0
        texts[name] = (stream_text(events), whole["choices"][0]["text"] if status == 200 else None)
    if texts["https"] != texts["plain"] or texts["plain"][0] != texts["plain"][1]:
        raise AssertionError(f"HTTPS against plain: {texts}")
    return out


def card_grpc_modules() -> str:
    """Whether grpcio and protobuf import on this machine, and their
    distributions' versions, read without importing them (nothing depends
    on it: the port serves gRPC on its own code)."""
    import importlib.metadata
    import importlib.util

    def has(name):
        try:
            return importlib.util.find_spec(name) is not None
        except (ImportError, ValueError):
            return False

    def version(dist):
        try:
            return importlib.metadata.version(dist)
        except importlib.metadata.PackageNotFoundError:
            return None

    return (f"grpc importable: {has('grpc')} (grpcio {version('grpcio')}); google.protobuf "
            f"importable: {has('google.protobuf')} (protobuf {version('protobuf')})")


def frontend_phase(torch, smi: str, serving) -> dict:
    """Phase 13 (module docstring): the netstore, a llama3-8b worker and the
    frontend as three processes; the traffic, decode probe, greedy
    prompts, n = 2, a guided request, an embedding and a disconnect
    through the frontend; then the worker stopped and the same work on an
    in-process engine of the same configuration and decode schedule, in a
    process of its own (fe_control)."""
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    log(f"this machine's python: {card_grpc_modules()}")
    out = {}
    procs = []
    traces_dir = tempfile.TemporaryDirectory()
    traces = {name: os.path.join(traces_dir.name, f"{name}.jsonl")
              for name in ("frontend", "worker")}
    try:
        t0 = time.perf_counter()
        store = Proc("netstore", "dynamo_tpu_torch.runtime.discovery.netstore",
                     "--host", "127.0.0.1", "--port", "0")
        procs.append(store)
        addr = store.wait_line("KVSTORE_READY", 30).split()[1]
        common = ("--store", "tcp", "--store-path", addr)
        worker = Proc("worker", "dynamo_tpu_torch.engine", *common, *FE_WORKER,
                      "--system-port", "0",
                      env={"DTPU_TRACE_JSONL": traces["worker"],
                           "DTPU_SLA_CLASSES": FE_SLA_CLASSES})
        procs.append(worker)
        front = Proc("frontend", "dynamo_tpu_torch.frontend", *common, "--host",
                     "127.0.0.1", "--port", "0", "--grpc-port", "0",
                     env={"DTPU_TRACE_JSONL": traces["frontend"],
                          "DTPU_SLA_CLASSES": FE_SLA_CLASSES})
        procs.append(front)
        # a second frontend on the same store, serving HTTPS with the
        # committed localhost pair
        tls_front = Proc("tls frontend", "dynamo_tpu_torch.frontend", *common, "--host",
                         "127.0.0.1", "--port", "0", "--tls-cert-path", FE_TLS[0],
                         "--tls-key-path", FE_TLS[1])
        procs.append(tls_front)
        port = int(front.wait_line("TORCH_FRONTEND_READY", 60).rsplit(":", 1)[1])
        grpc_port = int(front.wait_line("KSERVE_GRPC_READY", 60).split()[1])
        tls_port = int(tls_front.wait_line("TORCH_FRONTEND_READY", 60).rsplit(":", 1)[1])
        worker.wait_line("TORCH_ENGINE_READY")
        status_port = int(worker.wait_line("TORCH_STATUS_ADDRESS", 10).rsplit(":", 1)[1])
        out["ready_s"] = time.perf_counter() - t0
        schedule = next((ln for ln in worker.lines if "decode schedule" in ln), "")
        steps = re.search(r"steps=(\d+) pipeline=(\d+)", schedule)
        if steps is None:
            raise AssertionError(f"no auto-tuned decode schedule in the worker's log: "
                                 f"{worker.lines[-20:]}")
        out["schedule"] = schedule.split(": ", 1)[-1]

        async def models():
            for _ in range(600):
                status, body = await http_call(port, "GET", "/v1/models")
                if status == 200 and [m["id"] for m in body["data"]] == [FE_MODEL]:
                    return
                await asyncio.sleep(0.05)
            raise AssertionError(f"/v1/models never listed {FE_MODEL}")

        async def through():
            await models()
            fe = await fe_through_frontend(port)
            # gRPC and HTTPS before the observability gates, whose step
            # counts must be the worker's last
            t1 = time.perf_counter()
            fe["grpc"] = await fe_grpc(port, grpc_port)
            fe["grpc"]["seconds"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            fe["https"] = await fe_https(port, tls_port)
            fe["https"]["seconds"] = time.perf_counter() - t1
            fe["observability"] = await fe_observability(port, status_port, fe["traced_id"])
            return fe

        t0 = time.perf_counter()
        fe = asyncio.run(through())
        out["requests_s"] = time.perf_counter() - t0
        rc = worker.stop()
        exit_line = worker.wait_line("TORCH_ENGINE_EXIT", 10)
        report = json.loads(exit_line.split(" ", 1)[1])
        if rc != 0:
            raise AssertionError(f"the worker exited {rc}")
        check_worker_exit(report)
        for p in (front, tls_front, store):
            if p.stop() != 0:
                raise AssertionError(f"the {p.name} exited {p.proc.returncode}")
        out["worker_exit"] = report
        check_metric_steps(fe["observability"]["metric_steps"], report["steps"])
        # both processes flushed their spans at exit
        out["trace_ms"] = check_trace(traces, fe["traced_id"])
        # the control, built only now: one 16 GB model on the card at a time
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "frontend.json")
            with open(path, "w") as f:
                json.dump({"steps": steps.group(1), "pipeline": steps.group(2),
                           "greedy": fe["greedy"], "embedding": fe["embedding"]}, f)
            control = Proc("control", "chip_smoke", "--fe-control", path)
            procs.append(control)
            inproc = json.loads(control.wait_line("FE_CONTROL").split(" ", 1)[1])
            if control.join() != 0:
                raise AssertionError(f"the control exited {control.proc.returncode}")
        out["in_process_s"] = time.perf_counter() - t0
        errors = [f"{p.name}: {ln}" for p in procs for ln in p.errors()]
        if errors:
            raise AssertionError("ERROR records in the serving plane's logs:\n"
                                 + "\n".join(errors[:20]))
    finally:
        for p in procs:
            p.stop()
        traces_dir.cleanup()
    out["observability"] = fe["observability"]
    out["frontend"], out["in_process"] = fe["traffic"], inproc["traffic"]
    out["steady"] = {"frontend": fe["steady"], "in_process": inproc["steady"]}
    out["metrics"] = fe["metrics"]
    out["n2_texts"], out["guided_answer"] = fe["n2_texts"], fe["guided_answer"]
    out["parsers"] = fe["parsers"]
    out["responses"] = fe["responses"]
    out["grpc"], out["https"] = fe["grpc"], fe["https"]
    for k in ("greedy_equal", "greedy_tie_gaps", "embedding_rel_l2"):
        out[k] = inproc[k]

    def line(f, p):
        return (f"{f['output_tok_s']:.1f} output tok/s, TTFT median "
                f"{f['ttft_s_median'] * 1e3:.0f} ms (mean {f['ttft_s_mean'] * 1e3:.0f}, max "
                f"{f['ttft_s_max'] * 1e3:.0f}), ITL median {f['itl_s_median'] * 1e3:.2f} ms "
                f"(max {f['itl_s_max'] * 1e3:.2f}), client clock; in-process, the same "
                f"requests, flags and schedule: {p['output_tok_s']:.1f} output tok/s, TTFT "
                f"median {p['ttft_s_median'] * 1e3:.0f} ms (mean {p['ttft_s_mean'] * 1e3:.0f}, "
                f"max {p['ttft_s_max'] * 1e3:.0f}), ITL median {p['itl_s_median'] * 1e3:.2f} "
                f"ms (max {p['itl_s_max'] * 1e3:.2f}); frontend / in-process: ITL median "
                f"{f['itl_s_median'] / p['itl_s_median']:.3f}, tok/s "
                f"{f['output_tok_s'] / p['output_tok_s']:.3f}")

    for run, (f, p) in enumerate(zip(out["frontend"], out["in_process"])):
        log(f"frontend on {smi}, run {run + 1} of {FE_RUNS}: {FE_MODEL} at 32 layers, "
            f"{f['requests']} streamed requests (chat and completions in turn) through "
            f"netstore + worker + frontend: " + line(f, p))
    log(f"frontend decode probe on {smi}: {FE_STEADY} requests of {FE_STEADY_PROMPT} "
        f"tokens at once, {FE_STEADY_TOKENS} greedy tokens each, through the frontend: "
        + line(out["steady"]["frontend"], out["steady"]["in_process"]))
    m = out["metrics"]
    log(f"frontend /metrics on {smi}, the {FE_RUNS} traffic runs: "
        f"dtpu_time_to_first_token_seconds mean "
        f"{m['dtpu_time_to_first_token_seconds']['mean_s'] * 1e3:.1f} ms over "
        f"{m['dtpu_time_to_first_token_seconds'].get('count', 0):.0f} requests, "
        f"dtpu_inter_token_latency_seconds mean "
        f"{m['dtpu_inter_token_latency_seconds']['mean_s'] * 1e3:.2f} ms over "
        f"{m['dtpu_inter_token_latency_seconds'].get('count', 0):.0f} gaps (one sample an "
        f"output: a horizon's tokens); schedule {out['schedule']}")
    if serving is not None:
        log(f"serve phase (10 prompts of 120-3000 tokens, in-process) on {smi}: "
            f"{serving['output_tok_s']:.1f} output tok/s, ITL median "
            f"{serving['itl_s_median'] * 1e3:.2f} ms")
    pr = out["parsers"]
    log(f"frontend parsers (--tool-parser hermes --reasoning-parser qwen3) on {smi}: a named "
        f"tool_choice gave get_weather({pr['named_call']}), whole and streamed alike; a "
        f"hermes call gave get_weather({pr['hermes_call']}); a <think> answer gave "
        f"reasoning {pr['think']['reasoning']!r} and content {pr['think']['content']!r}; "
        f"{pr['seconds']:.1f} s for the five requests")
    g = out["grpc"]
    log(f"frontend KServe gRPC (--grpc-port, the port's own HTTP/2 and protobuf) on {smi}: "
        f"ModelInfer and ModelStreamInfer for the {len(FE_GREEDY)} greedy prompts "
        f"({', '.join(map(str, FE_GREEDY))} tokens, {FE_TOKENS} tokens each, after a 1-token "
        f"warm-up) gave the streamed HTTP completion's text; TTFT gRPC stream / HTTP stream "
        + ", ".join(f"{a * 1e3:.1f} / {b * 1e3:.1f} ms" for a, b in zip(
            g["grpc_ttft_s"], g["http_ttft_s"]))
        + f"; unary ModelInfer {', '.join(f'{t * 1e3:.1f}' for t in g['unary_s'])} ms against "
        f"non-streamed HTTP {', '.join(f'{t * 1e3:.1f}' for t in g['http_whole_s'])} ms; "
        f"ServerLive, ServerReady, ModelReady, ModelMetadata and a NOT_FOUND answered; "
        f"{g['seconds']:.1f} s")
    h = out["https"]
    log(f"frontend HTTPS (--tls-cert-path / --tls-key-path, a second frontend) on {smi}: "
        f"the greedy completion ({FE_HTTPS_PROMPT} tokens, {FE_TOKENS} out) equal to its "
        f"plain twin; TTFT HTTPS {h['https_ttft_s'] * 1e3:.1f} ms against plain "
        f"{h['plain_ttft_s'] * 1e3:.1f} ms, whole request {h['https_s'] * 1e3:.1f} against "
        f"{h['plain_s'] * 1e3:.1f} ms; {h['seconds']:.1f} s")
    rs = out["responses"]
    log(f"frontend /v1/responses on {smi}: aggregated and streamed ({rs['deltas']} "
        f"output_text deltas) gave the greedy chat request's text, {rs['tokens']} tokens")
    ob = out["observability"]
    log(f"frontend observability on {smi}: status server, canary {ob['canary']}, the "
        f"request timeline, /debug/slo ({FE_STEADY} {FE_SLA_CLASS!r} requests on both "
        f"sides), /debug/worker, /debug/fleet and the step counts by phase "
        f"{ob['metric_steps']} (= the exit line's) checked; one request's spans "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in out["trace_ms"].items())
        + "; drift measured / predicted, median by phase: "
        + (", ".join(f"{k} {v['median_ratio']:.3f} over {v['steps']} steps"
                     for k, v in ob["drift"].items()) or "none")
        + f"; health events: {ob['health_events'] or 'none'}; the probe (traced) ITL "
        f"median {out['steady']['frontend']['itl_s_median'] * 1e3:.2f} ms")
    log(f"frontend: greedy streams equal to the in-process engine's {out['greedy_equal']} of "
        f"{len(FE_GREEDY)} (the rest within the tie rule: {out['greedy_tie_gaps']}); "
        f"embedding relative L2 {out['embedding_rel_l2']:.3g}; worker kernels "
        f"{out['worker_exit']['launches']}")
    return out


# ------------------------------------------------------------- phase 14
# KV-aware routing: two workers behind a --router-mode kv frontend over the
# cross-process event plane (the port's own broker), and a round-robin
# frontend on the same workers as the control. KV_DOCS: the documents of
# steps 1, 2b and 5, in prompt tokens each; sent 0.25 s apart they alternate workers (each goes to the
# idle one), so the 3000-token one at an odd place balances the pools
KV_DOCS = (1000, 3000, 1500, 1000, 1300, 1100, 1200, 1000)
KV_NEW = 64             # a follow-up: its document plus this many new tokens
# distinct prompts of KV_CHURN_TOKENS, so both 512-block pools evict (12
# hold 2256 blocks)
KV_CHURN = 12
KV_CHURN_TOKENS = 3000
KV_BLOCKS = 512         # each worker's KV pool (blocks of 16 tokens)
# --migration-limit 2: the fault drill's dropped sends migrate
KV_WORKER = (*FE_WORKER, "--num-blocks", str(KV_BLOCKS), "--event-plane", "zmq",
             "--migration-limit", "2")
KV_BLOCK = 16
KV_HIT_METRIC = "dtpu_kv_cached_tokens_total"
KV_GAP = 0.25           # s between one follow-up's end and the next one's start


def kv_chat(text: str) -> tuple:
    """A streamed greedy chat request of FE_TOKENS tokens."""
    return ("/v1/chat/completions", dict(
        model=FE_MODEL, messages=[{"role": "user", "content": text}], max_tokens=FE_TOKENS,
        temperature=0.0, ignore_eos=True, stream=True,
        stream_options={"include_usage": True}))


def kv_documents(seed: int) -> list:
    return [fe_prompt(n, seed + i) for i, n in enumerate(KV_DOCS)]


def kv_followups(docs: list, seed: int) -> tuple:
    """Each document plus KV_NEW new tokens, in a seeded shuffled order:
    (order, texts in that order)."""
    order = [int(i) for i in np.random.default_rng(seed).permutation(len(docs))]
    return order, [docs[i] + " " + fe_prompt(KV_NEW - 1, seed + 50 + i) for i in order]


def kv_hits(doc_stats: list, order: list, fu_stats: list) -> list:
    """Per follow-up (in document order): (cached tokens, the least a hit
    reports: (document blocks - 1) x 16)."""
    out = [None] * len(order)
    for k, i in enumerate(order):
        cached = fu_stats[k]["usage"].get("cached_tokens")
        doc_blocks = doc_stats[i]["usage"]["prompt_tokens"] // KV_BLOCK
        out[i] = (cached or 0, (doc_blocks - 1) * KV_BLOCK)
    return out


async def kv_counter(port: int) -> float:
    """The frontend's dtpu_kv_cached_tokens_total: the tokens its KV router
    predicted the chosen workers hold, summed over its decisions."""
    _, text = await http_text(port, "/metrics")
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith(KV_HIT_METRIC + "{") or ln.startswith(KV_HIT_METRIC + " "))


async def kv_models(port: int) -> None:
    for _ in range(600):
        status, body = await http_call(port, "GET", "/v1/models")
        if status == 200 and [m["id"] for m in body["data"]] == [FE_MODEL]:
            return
        await asyncio.sleep(0.05)
    raise AssertionError(f"/v1/models on :{port} never listed {FE_MODEL}")


async def kv_one_at_a_time(port: int, bodies: list, kv: bool, ask=None) -> tuple:
    """Each request KV_GAP s after the one before ended: (stats, the tokens
    the kv router predicted each request's worker holds: the change of its
    dtpu_kv_cached_tokens_total, or None through a round-robin frontend,
    and the router service's answers: ``ask`` of each request's body just
    before it is sent, when given). The router's cost is prefill blocks plus
    load, and a worker's load report still carrying its last request could
    rightly send a follow-up elsewhere; alone, a follow-up must go where
    its prefix is."""
    stats, predicted, answers = [], [], []
    for body in bodies:
        await asyncio.sleep(KV_GAP)
        before = await kv_counter(port) if kv else None
        if ask is not None:
            t0 = time.perf_counter()
            answers.append(dict(await ask(body[1]), ask_s=time.perf_counter() - t0))
        got, _ = await fe_traffic(port, [body])
        stats += got
        predicted.append(await kv_counter(port) - before if kv else None)
    return stats, predicted, answers


async def kv_service_asker(addr: str) -> tuple:
    """(runtime, ask): ``ask(body)`` puts a chat body's tokens (as the
    frontend's preprocessor makes them) to the router service's ``route``
    op, frees the route, and returns the answer with the prompt's last
    full block hash (the block only the worker that serves it stores)."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols import openai
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
    from dynamo_tpu_torch.tokens import compute_sequence_hashes

    rt = await DistributedRuntime(RuntimeConfig(store="tcp", store_path=addr,
                                                event_plane="inproc")).start()
    client = await rt.namespace("dynamo").component("backend-router").endpoint(
        "route").client()
    await client.wait_for_instances(1)
    pre = OpenAIPreprocessor(ModelDeploymentCard(name=FE_MODEL, tokenizer="byte",
                                                 context_length=8192))
    asked = [0]

    async def ask(body):
        toks = pre.preprocess_chat(openai.ChatCompletionRequest.from_obj(body)).token_ids
        rid = f"svc-{asked[0]}"
        asked[0] += 1
        (answer,) = [x async for x in await client.generate(
            {"op": "route", "request_id": rid, "token_ids": toks})]
        [x async for x in await client.generate({"op": "free", "request_id": rid})]
        if "worker_id" not in answer:
            raise AssertionError(f"the router service's route op: {answer}")
        return dict(answer, last_hash=compute_sequence_hashes(toks, KV_BLOCK)[-1])

    return rt, ask


async def kv_documents_and_followups(port: int, seed: int, kv: bool, ask=None) -> dict:
    """Steps 1-2 of phase 14 through the frontend on ``port``: the
    documents 0.25 s apart, then the follow-ups one at a time (each first
    put to the router service, with ``ask``)."""
    docs = kv_documents(seed)
    before = await kv_counter(port) if kv else 0.0
    doc_stats, _ = await fe_traffic(port, [kv_chat(d) for d in docs])
    doc_pred = (await kv_counter(port) - before) if kv else 0.0
    check_fe_stats("document", doc_stats, FE_TOKENS)
    order, texts = kv_followups(docs, seed)
    fu_stats, fu_pred, service = await kv_one_at_a_time(port, [kv_chat(t) for t in texts],
                                                        kv, ask)
    check_fe_stats("follow-up", fu_stats, FE_TOKENS)
    hits = kv_hits(doc_stats, order, fu_stats)
    predicted = [None] * len(order)
    for k, i in enumerate(order):
        predicted[i] = fu_pred[k]
    return {"hits": hits, "predicted": predicted,
            "hit_share": sum(c >= want for c, want in hits) / len(hits),
            "followup_ttft_s": [s["ttft_s"] for s in fu_stats],
            "followup_ttft_s_median": statistics.median(s["ttft_s"] for s in fu_stats),
            "followup_ttft_s_mean": statistics.mean(s["ttft_s"] for s in fu_stats),
            "document_ttft_s_median": statistics.median(s["ttft_s"] for s in doc_stats),
            "cached_tokens": sum((s["usage"].get("cached_tokens") or 0)
                                 for s in doc_stats + fu_stats),
            "predicted_tokens": doc_pred + sum(p or 0 for p in fu_pred),
            "service": [dict(a, frontend_predicted=p) for a, p in zip(service, fu_pred)]}


async def kv_overlapping_followups(port: int, seed: int) -> dict:
    """Step 2b of phase 14: new documents 0.25 s apart, then their
    follow-ups 0.25 s apart without waiting for each other. Observed, not
    gated: the router prices load as well as prefix. Predicted against
    reported cached tokens tells a follow-up sent to the idle worker by
    choice (the two sums equal) from one the router credited with blocks
    its worker no longer held (predicted above reported)."""
    docs = kv_documents(seed)
    doc_stats, _ = await fe_traffic(port, [kv_chat(d) for d in docs])
    check_fe_stats("overlapping document", doc_stats, FE_TOKENS)
    order, texts = kv_followups(docs, seed)
    before = await kv_counter(port)
    fu_stats, _ = await fe_traffic(port, [kv_chat(t) for t in texts], gap=KV_GAP)
    predicted = await kv_counter(port) - before
    check_fe_stats("overlapping follow-up", fu_stats, FE_TOKENS)
    hits = kv_hits(doc_stats, order, fu_stats)
    return {"hits": hits, "hit_share": sum(c >= want for c, want in hits) / len(hits),
            "predicted_tokens": predicted, "cached_tokens": sum(c for c, _ in hits),
            "followup_ttft_s_median": statistics.median(s["ttft_s"] for s in fu_stats)}


async def kv_traffic(kv_port: int, rr_port: int, addr: str) -> dict:
    """Everything phase 14 sends: the documents and follow-ups (kv; each
    follow-up first put to the router service), the overlapping follow-ups
    (kv), the churn (kv), the decode probe (kv), then the documents and
    follow-ups again with new documents through the round-robin
    frontend."""
    await kv_models(kv_port)
    await kv_models(rr_port)
    rt, ask = await kv_service_asker(addr)
    try:
        out = {"kv": await kv_documents_and_followups(kv_port, 700, kv=True, ask=ask)}
    finally:
        await rt.shutdown()
    bad = [(i, c, want, p) for i, ((c, want), p) in enumerate(
        zip(out["kv"]["hits"], out["kv"]["predicted"])) if c < want]
    if bad:
        raise AssertionError(f"kv routing: follow-ups that did not reach their document's "
                             f"worker (document, cached tokens, at least, router-predicted "
                             f"tokens): {bad}")
    ov = out["overlapping"] = await kv_overlapping_followups(kv_port, 1300)
    log(f"kv_router, follow-ups 0.25 s apart without waiting (observed): at their "
        f"document's worker {ov['hit_share'] * len(KV_DOCS):.0f} of {len(KV_DOCS)}, (cached "
        f"tokens, at least) in document order {ov['hits']}; router-predicted cached tokens "
        f"{ov['predicted_tokens']:.0f} against {ov['cached_tokens']} the workers reported; "
        f"TTFT median {ov['followup_ttft_s_median'] * 1e3:.1f} ms")
    churn = [kv_chat(fe_prompt(KV_CHURN_TOKENS, 900 + j)) for j in range(KV_CHURN)]
    stats, wall = await fe_traffic(kv_port, churn, gap=0.1)
    check_fe_stats("churn", stats, FE_TOKENS)
    out["churn"] = fe_summary(stats, wall)
    stats, wall = await fe_traffic(kv_port, fe_steady_bodies(), gap=0.0)
    check_fe_stats("kv decode probe", stats, FE_STEADY_TOKENS)
    out["steady"] = fe_summary(stats, wall)
    out["round_robin"] = await kv_documents_and_followups(rr_port, 1100, kv=False)
    return out


KV_PLANE_ROUNDS = 8     # requests to each worker, in turns, for the plane reading


async def kv_planes(addr: str) -> dict:
    """The HTTP request plane against TCP: the same 1-token greedy request
    (a 256-token prompt, cached after its first run on each worker) sent
    straight to each of phase 14's idle workers (one per plane) through
    the runtime's client, KV_PLANE_ROUNDS times in turns; the seconds to
    the first and the last item, by plane (the workers' engines differ, so
    this reads more than the plane), and a ping through each worker's
    request server (the plane alone). An observation, not a gate."""
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.runtime import Context, DistributedRuntime, RuntimeConfig

    rt = await DistributedRuntime(RuntimeConfig(store="tcp", store_path=addr,
                                                event_plane="inproc")).start()
    try:
        client = await rt.namespace("dynamo").component("backend").endpoint(
            "generate").client()
        await client.wait_for_instances(2)
        planes = {("http" if i.address.startswith("http") else "tcp"): iid
                  for iid, i in client.instances.items()}
        if sorted(planes) != ["http", "tcp"]:
            raise AssertionError(f"phase 14's workers: {client.instances}")
        prompt = ByteTokenizer().encode(fe_prompt(256, 1700))
        out = {p: {"first_s": [], "total_s": [], "ping_s": []} for p in planes}
        # the plane alone: a ping through each worker's request server
        for r in range(4 * KV_PLANE_ROUNDS):
            for plane in (("tcp", "http") if r % 2 == 0 else ("http", "tcp")):
                address = client.instances[planes[plane]].address
                out[plane]["ping_s"].append(await rt.plane_client(address).ping(address))
        for r in range(KV_PLANE_ROUNDS):
            for plane in (("tcp", "http") if r % 2 == 0 else ("http", "tcp")):
                req = PreprocessedRequest(
                    request_id=f"plane-{plane}-{r}", model=FE_MODEL, token_ids=prompt,
                    sampling=SamplingOptions(temperature=0.0),
                    stop=StopConditions(max_tokens=1, ignore_eos=True))
                t0 = time.perf_counter()
                first = None
                items = 0
                async for _ in await client.generate(req.to_obj(), Context(),
                                                     instance_id=planes[plane]):
                    items += 1
                    if first is None:
                        first = time.perf_counter() - t0
                if not items:
                    raise AssertionError(f"the {plane} plane's worker answered nothing")
                out[plane]["first_s"].append(first)
                out[plane]["total_s"].append(time.perf_counter() - t0)
    finally:
        await rt.shutdown()
    return {p: {**v, "first_s_median": statistics.median(v["first_s"]),
                "total_s_median": statistics.median(v["total_s"]),
                "ping_s_median": statistics.median(v["ping_s"])} for p, v in out.items()}


async def kv_clear(kv_port: int, addr: str) -> dict:
    """After phase 14's routing checks: ``POST /clear_kv_blocks {"levels":
    ["g1"]}`` through the kv frontend empties both workers' prefix caches
    and, through their CLEARED events, the router service's view; a
    follow-up of a served document then reports 0 cached tokens, and the
    kv frontend's router predicted 0 for it."""
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    status, body = await http_call(kv_port, "POST", "/clear_kv_blocks", {"levels": ["g1"]})
    workers = (body or {}).get("cleared", {}).get(FE_MODEL, {})
    if (status != 200 or len(workers) != 2
            or any("error" in w or w["snapshot"]["cached_blocks"] != 0 for w in workers.values())):
        raise AssertionError(f"POST /clear_kv_blocks: HTTP {status}: {str(body)[:600]}")
    out = {"dropped": {k: w["g1"] for k, w in workers.items()}}
    rt = await DistributedRuntime(RuntimeConfig(store="tcp", store_path=addr,
                                                event_plane="inproc")).start()
    try:
        client = await rt.namespace("dynamo").component("backend-router").endpoint(
            "route").client()
        await client.wait_for_instances(1)
        for _ in range(100):
            (state,) = [x async for x in await client.generate({"op": "state"})]
            if state["tree_blocks"] == 0:
                break
            await asyncio.sleep(0.05)
        else:
            raise AssertionError(f"the router service's view after the clear: {state}")
    finally:
        await rt.shutdown()
    docs = kv_documents(700)
    _, texts = kv_followups(docs, 700)
    before = await kv_counter(kv_port)
    (st,), _ = await fe_traffic(kv_port, [kv_chat(texts[0])])
    out["predicted"] = await kv_counter(kv_port) - before
    out["cached_tokens"] = st["usage"].get("cached_tokens") or 0
    if out["cached_tokens"] != 0 or out["predicted"] != 0:
        raise AssertionError(f"a follow-up after the clear: cached tokens "
                             f"{out['cached_tokens']}, router-predicted {out['predicted']}")
    return out


def kv_service_checks(view: dict, reports: list, answers: list, recording: str) -> list:
    """The router service's decisions, its view and its recording, held to
    the kv frontend's decisions and the workers' prefix caches: problems."""
    from dynamo_tpu_torch.kv_router import KvEventKind, KvRouter, RouterEvent
    from dynamo_tpu_torch.runtime import InProcEventPlane
    from dynamo_tpu_torch.runtime.recorder import Recorder

    problems = []
    events = [RouterEvent.from_obj(ev["event"]) for _, ev in Recorder.load(recording)]
    stored_by = {}
    for ev in events:
        if ev.event.kind == KvEventKind.STORED:
            for h in ev.event.block_hashes:
                stored_by.setdefault(h, ev.worker.worker_id)
    for k, a in enumerate(answers):
        served = stored_by.get(a["last_hash"])
        if a["worker_id"] != served or a["cached_tokens"] != a["frontend_predicted"]:
            problems.append(
                f"follow-up {k}: the router service chose worker {a['worker_id']:016x} with "
                f"{a['cached_tokens']} cached tokens; the kv frontend's worker "
                f"{served if served is None else f'{served:016x}'} with "
                f"{a['frontend_predicted']:.0f} predicted")
    published = sum(sum(r["kv_events"].values()) for r in reports)
    if not view["events_applied"] == view["recorded"] == len(events) == published:
        problems.append(f"the router service applied {view['events_applied']} events, "
                        f"recorded {view['recorded']} ({len(events)} in the file); the "
                        f"workers published {published}")
    for r in reports:
        have = set(view["workers"].get(r["worker_id"], {"hashes": []})["hashes"])
        if have != set(r["prefix_cache"]["hashes"]):
            problems.append(f"the router service's view of worker {r['worker_id']}: "
                            f"{len(have)} blocks; its prefix cache "
                            f"{r['prefix_cache']['blocks']}")
    replayed = KvRouter(InProcEventPlane(), "dynamo", "backend", block_size=KV_BLOCK)
    for ev in events:
        replayed.indexer.apply(ev)
    if replayed.view()["workers"] != view["workers"]:
        problems.append("the recording replayed into a fresh KvRouter gives another view "
                        "than the router service's")
    return problems


# the fault drill of phase 14. DRILL_SPEC's seeded schedule drops calls 1, 10
# and 16 of the first 22: the first 16 sends are each request's first, and
# no two drops lie within DRILL_BATCH + 1 calls of each other, so no request
# can lose both its attempts (with two workers the third attempt finds both
# excluded: a 503). A denser schedule, p=0.3@seed=11, drops calls 11 and
# 13, 21 and 22, which one request's two attempts can meet
DRILL_REQUESTS = 16
DRILL_BATCH = 4
DRILL_SPEC = "request_plane.send:drop@p=0.2@seed=319"
DRILL_TOP = 5
# (b): the frontend breaker's threshold of worker-loss 503s, two sends each
DRILL_TRIPS = 5
DRILL_TRIP_SENDS = 2 * DRILL_TRIPS
DRILL_TRIP_SPEC = ";".join(f"request_plane.send:drop@{i}"
                           for i in range(1, DRILL_TRIP_SENDS + 1))
DRILL_RESET_S = 1.0
DRILL_POLICY = f'policy="frontend.{FE_MODEL}"'


def drill_bodies(model=None) -> list:
    """The drill's greedy chat requests, with DRILL_TOP top logprobs;
    ``model`` None leaves it to the frontend's request template."""
    out = []
    for i in range(DRILL_REQUESTS):
        body = dict(messages=[{"role": "user", "content": fe_prompt(64 + 16 * i, 1500 + i)}],
                    max_tokens=32 + 2 * i, temperature=0.0, ignore_eos=True, logprobs=True,
                    top_logprobs=DRILL_TOP)
        if model is not None:
            body["model"] = model
        out.append(body)
    return out


async def drill_send(port: int, bodies: list) -> list:
    """Each chat body through the frontend, DRILL_BATCH at a time:
    [(status, body)]."""
    out = []
    for k in range(0, len(bodies), DRILL_BATCH):
        out += await asyncio.gather(*(http_call(port, "POST", "/v1/chat/completions", b)
                                      for b in bodies[k:k + DRILL_BATCH]))
    return out


def drill_tokens(tag: str, i: int, body: dict, want: int) -> list:
    """A drill answer's tokens as (string, logprob, {top string: logprob});
    it must be served whole, FE_MODEL's, ``want`` tokens."""
    ch = body["choices"][0]
    content = (ch.get("logprobs") or {}).get("content") or []
    if (body["model"] != FE_MODEL or ch["finish_reason"] != "length"
            or body["usage"]["completion_tokens"] != want or len(content) != want):
        raise AssertionError(f"{tag} request {i}: model {body['model']!r}, finish "
                             f"{ch['finish_reason']!r}, {body['usage']}, {len(content)} "
                             f"logprob entries; expected {want} tokens")
    return [(e["token"], e["logprob"], {t["token"]: t["logprob"] for t in e["top_logprobs"]})
            for e in content]


def drill_divergences(drill: list, clean: list, bodies: list) -> list:
    """Each drill request against its clean twin: where their tokens first
    differ (none, most often), the request, the clean run's tokens before
    it, and both tokens there, for the tie control."""
    out = []
    for i, ((sd, bd), (sc, bc), body) in enumerate(zip(drill, clean, bodies)):
        if sd != 200 or sc != 200:
            raise AssertionError(f"drill request {i}: HTTP {sd} through the armed frontend, "
                                 f"{sc} through the clean one: {str(bd)[:200]} / "
                                 f"{str(bc)[:200]}")
        a = drill_tokens("drill", i, bd, body["max_tokens"])
        b = drill_tokens("clean", i, bc, body["max_tokens"])
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x[0] != y[0]), None)
        if j is not None:
            out.append({"request": i, "index": j, "body": dict(body, model=FE_MODEL),
                        "prefix": [t for t, _, _ in b[:j]], "drill": a[j], "clean": b[j]})
    return out


def token_candidates(s: str) -> list:
    """The byte tokenizer's ids that decode, alone, to ``s``."""
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    special = {v: k for k, v in ByteTokenizer._SPECIAL.items()}
    if s.startswith("<unk:") and s.endswith(">"):
        return [int(s[5:-1])]
    if s in special:
        return [special[s]]
    if len(s) == 1 and ord(s) < 128:
        return [ord(s)]
    if s == "\ufffd":
        return list(range(128, 256))
    return []


def tie_control(path: str) -> int:
    """``chip_smoke.py --tie-control FILE``, run by phase 14 after its
    workers stopped, in a process of its own: the fault drill's
    divergences (FILE) held to the tie rule on the workers' weights. At
    each, the drill's token must be among the clean run's top logprobs,
    within TIE_SPACINGS bf16 spacings (at the larger of the two plain
    logits after the clean prefix) of the clean token's logprob. A token
    string several ids decode to is the one of those ids with the largest
    plain logit (both runs were greedy). Prints ``TIE_CONTROL {json}``."""
    import torch

    from dynamo_tpu_torch.engine.__main__ import build_worker_engine, parse_args
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols import openai

    with open(path) as f:
        divergences = json.load(f)
    engine, _ = build_worker_engine(parse_args([*FE_WORKER, "--decode-steps", "1",
                                                "--num-blocks", "64"]))
    pre = OpenAIPreprocessor(ModelDeploymentCard(name=FE_MODEL, tokenizer="byte",
                                                 context_length=8192))
    gaps = []
    try:
        for d in divergences:
            ids = list(pre.preprocess_chat(
                openai.ChatCompletionRequest.from_obj(d["body"])).token_ids)

            def pick(s, logits=None):
                cands = token_candidates(s)
                if not cands:
                    raise AssertionError(f"drill request {d['request']}: token {s!r} is no "
                                         "byte-tokenizer token")
                if len(cands) == 1:
                    return cands[0]
                if logits is None:
                    logits = plain_logits(torch, engine.params, engine.mcfg, ids)
                return max(cands, key=lambda t: float(logits[t]))

            for s in d["prefix"]:
                ids.append(pick(s))
            logits = plain_logits(torch, engine.params, engine.mcfg, ids)
            (sa, _, _), (sb, lpb, top) = d["drill"], d["clean"]
            a, b = pick(sa, logits), pick(sb, logits)
            larger = max(float(logits[a]), float(logits[b]))
            limit = TIE_SPACINGS * bf16_spacing(larger)
            if sa not in top:
                raise AssertionError(
                    f"drill request {d['request']} token {d['index']}: {sa!r} is not among "
                    f"the clean run's top logprobs {top}; its plain logit is "
                    f"{float(logits[b] - logits[a]):.4g} below the clean token's (limit "
                    f"{limit:.4g})")
            gap = lpb - top[sa]
            gaps.append({"request": d["request"], "index": d["index"], "gap": gap,
                         "limit": limit, "larger_logit": larger})
            if gap > limit:
                raise AssertionError(f"drill request {d['request']} token {d['index']}: gap "
                                     f"{gap:.4g} beyond {limit:.4g}")
    finally:
        engine.stop()
    print("TIE_CONTROL " + json.dumps(gaps), flush=True)
    return 0


def circuit_transitions(text: str) -> tuple:
    """The frontend breaker's transitions by state and its state gauge, from
    a /metrics text."""
    moved, state = {}, None
    for ln in text.splitlines():
        if DRILL_POLICY not in ln:
            continue
        if ln.startswith("dtpu_circuit_transitions_total{"):
            moved[re.search(r'state="(\w+)"', ln).group(1)] = float(ln.rsplit(" ", 1)[1])
        elif ln.startswith("dtpu_circuit_state{"):
            state = float(ln.rsplit(" ", 1)[1])
    return moved, state


async def fault_drill(drill_port: int, trip_port: int, rr_port: int) -> dict:
    """Phase 14's fault drill, (a) then (b) (module docstring): what each
    request got, and the times."""
    out = {}
    await kv_models(drill_port)
    await kv_models(trip_port)
    t0 = time.perf_counter()
    drill = await drill_send(drill_port, drill_bodies())
    out["a_s"] = time.perf_counter() - t0
    bodies = drill_bodies(FE_MODEL)
    clean = await drill_send(rr_port, bodies)
    out["divergences"] = drill_divergences(drill, clean, bodies)
    # each dropped send's retry is a "migration" event on its request's
    # timeline in the drill frontend's flight recorder
    status, flights = await http_call(drill_port, "GET",
                                      f"/debug/requests?limit={2 * DRILL_REQUESTS}")
    out["migrations"] = sum(1 for f in flights["requests"] for e in f["events"]
                            if e["event"]["kind"] == "migration") if status == 200 else None
    status, fleet = await http_call(drill_port, "GET", "/debug/fleet")
    out["worker_breakers"] = fleet["models"][FE_MODEL]["worker_breakers"] if status == 200 else {}
    out["model_breakers"] = fleet["frontend"]["model_breakers"] if status == 200 else {}
    if len(out["worker_breakers"]) != 2 or out["model_breakers"] != {FE_MODEL: "closed"}:
        raise AssertionError(f"the drill frontend's /debug/fleet: HTTP {status}: worker "
                             f"breakers {out['worker_breakers']}, model breakers "
                             f"{out['model_breakers']}")
    # (b): the first DRILL_TRIPS requests lose both attempts; the model's
    # circuit opens at the last of them
    t0 = time.perf_counter()
    trips = [await http_call(trip_port, "POST", "/v1/chat/completions",
                             dict(b, max_tokens=32, logprobs=False, top_logprobs=None))
             for b in bodies[:DRILL_TRIPS]]
    t_open = time.perf_counter()
    bad = [(s, b) for s, b in trips if s != 503 or "circuit open" in b["error"]["message"]
           or b["error"]["type"] != "service_unavailable"]
    if bad:
        raise AssertionError(f"drill (b): the tripping requests must get the worker-loss "
                             f"503: {bad}")
    headers = {}
    status, shed = await http_call(trip_port, "POST", "/v1/chat/completions",
                                   dict(bodies[DRILL_TRIPS], max_tokens=32, logprobs=False,
                                        top_logprobs=None), headers=headers)
    out["retry_after"] = headers.get("retry-after")
    if (status != 503 or "circuit open" not in shed["error"]["message"]
            or out["retry_after"] != str(int(DRILL_RESET_S))):
        raise AssertionError(f"drill (b): the request after the trip got HTTP {status}, "
                             f"Retry-After {out['retry_after']}: {shed}")
    await asyncio.sleep(DRILL_RESET_S + 0.1)
    status, probe = await http_call(trip_port, "POST", "/v1/chat/completions",
                                    dict(bodies[DRILL_TRIPS + 1], max_tokens=32,
                                         logprobs=False, top_logprobs=None))
    out["close_s"] = time.perf_counter() - t_open
    if status != 200 or probe["usage"]["completion_tokens"] != 32:
        raise AssertionError(f"drill (b): the probe after the reset: HTTP {status}: {probe}")
    _, text = await http_text(trip_port, "/metrics")
    out["transitions"], out["state"] = circuit_transitions(text)
    if out["transitions"] != {"open": 1.0, "half_open": 1.0, "closed": 1.0} or out["state"] != 0.0:
        raise AssertionError(f"drill (b): {DRILL_POLICY} transitions {out['transitions']}, "
                             f"state {out['state']}")
    out["b_s"] = time.perf_counter() - t0
    return out


def drill_fault_checks(drill: dict, drill_exit: dict, trip_exit: dict) -> dict:
    """The drill frontends' fired-fault logs, from their exit lines: (a)'s
    equal to FaultRegistry.plan of DRILL_SPEC for the sends it counted,
    at least two, one migration each; (b)'s exactly the first
    DRILL_TRIP_SENDS sends, and one send more, the probe's (the shed
    request made none)."""
    from dynamo_tpu_torch.runtime.faults import FaultRegistry

    point = "request_plane.send"
    calls = drill_exit["faults"]["calls"].get(point, 0)
    fired = [tuple(f) for f in drill_exit["faults"]["fired"]]
    reg = FaultRegistry()
    reg.arm(DRILL_SPEC)
    plan = reg.plan(point, calls)
    if ([(i, a) for _, a, i in fired] != plan or len(fired) < 2
            or drill["migrations"] != len(fired)):
        raise AssertionError(f"drill (a): fired {fired} over {calls} sends, "
                             f"{drill['migrations']} migrations; the plan of "
                             f"{DRILL_SPEC!r}: {plan}")
    trip_calls = trip_exit["faults"]["calls"].get(point, 0)
    trip_fired = [tuple(f) for f in trip_exit["faults"]["fired"]]
    if (trip_fired != [(point, "drop", i) for i in range(1, DRILL_TRIP_SENDS + 1)]
            or trip_calls != DRILL_TRIP_SENDS + 1):
        raise AssertionError(f"drill (b): fired {trip_fired} over {trip_calls} sends; "
                             f"expected the first {DRILL_TRIP_SENDS} and the probe's")
    return {"sends": calls, "drops": len(fired), "fired": fired, "trip_sends": trip_calls}


def kv_router_phase(torch, smi: str, fe) -> dict:
    """Phase 14 (module docstring): the netstore, two llama3-8b workers on
    the port's event plane, a --router-mode kv frontend, the standalone
    router service and a round-robin frontend; the KV router's and the
    service's views of each worker held to the worker's prefix cache once
    both are idle, the service's decisions to the frontend's."""
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    procs = []
    tmp = tempfile.TemporaryDirectory()
    recording = os.path.join(tmp.name, "kv_events.jsonl")
    try:
        t0 = time.perf_counter()
        store = Proc("netstore", "dynamo_tpu_torch.runtime.discovery.netstore",
                     "--host", "127.0.0.1", "--port", "0")
        procs.append(store)
        addr = store.wait_line("KVSTORE_READY", 30).split()[1]
        common = ("--store", "tcp", "--store-path", addr)
        # the kv frontend first: its runtime founds the event broker
        kvf = Proc("kv frontend", "dynamo_tpu_torch.frontend", *common, "--event-plane", "zmq",
                   "--router-mode", "kv", "--host", "127.0.0.1", "--port", "0")
        procs.append(kvf)
        kv_port = int(kvf.wait_line("TORCH_FRONTEND_READY", 60).rsplit(":", 1)[1])
        svc = Proc("router service", "dynamo_tpu_torch.router", *common, "--event-plane",
                   "zmq", "--block-size", str(KV_BLOCK), "--record-events", recording)
        procs.append(svc)
        t1 = time.perf_counter()
        svc.wait_line("ROUTER_READY", 60)
        out["service_ready_s"] = time.perf_counter() - t1
        # the second worker serves on the HTTP request plane: one frontend
        # routes to workers on both planes (no gate of this phase compares
        # the two workers' latencies)
        workers = [Proc(f"worker {i}", "dynamo_tpu_torch.engine", *common, *KV_WORKER,
                        env={"DTPU_REQUEST_PLANE": "http"} if i == 1 else None)
                   for i in range(2)]
        procs += workers
        rrf = Proc("round-robin frontend", "dynamo_tpu_torch.frontend", *common,
                   "--host", "127.0.0.1", "--port", "0")
        procs.append(rrf)
        # the fault drill's two round-robin frontends, armed through the
        # environment: (a) seeded drops and a request template naming the
        # model, (b) the first sends dropped and a 1 s breaker reset
        template = os.path.join(tmp.name, "template.json")
        with open(template, "w") as f:
            json.dump({"model": FE_MODEL}, f)
        drf = Proc("drill frontend", "dynamo_tpu_torch.frontend", *common, "--host",
                   "127.0.0.1", "--port", "0", "--request-template", template,
                   env={"DTPU_FAULTS": DRILL_SPEC})
        trf = Proc("trip frontend", "dynamo_tpu_torch.frontend", *common, "--host",
                   "127.0.0.1", "--port", "0",
                   env={"DTPU_FAULTS": DRILL_TRIP_SPEC,
                        "DTPU_CB_FRONTEND": f"reset={DRILL_RESET_S}"})
        procs += [drf, trf]
        rr_port = int(rrf.wait_line("TORCH_FRONTEND_READY", 60).rsplit(":", 1)[1])
        drill_port = int(drf.wait_line("TORCH_FRONTEND_READY", 60).rsplit(":", 1)[1])
        trip_port = int(trf.wait_line("TORCH_FRONTEND_READY", 60).rsplit(":", 1)[1])
        for w in workers:
            w.wait_line("TORCH_ENGINE_READY")
        out["ready_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out.update(asyncio.run(kv_traffic(kv_port, rr_port, addr)))
        out["requests_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        drill = asyncio.run(fault_drill(drill_port, trip_port, rr_port))
        exits = []
        for p in (drf, trf):
            if p.stop() != 0:
                raise AssertionError(f"the {p.name} exited {p.proc.returncode}")
            exits.append(json.loads(p.wait_line("TORCH_FRONTEND_EXIT", 10).split(" ", 1)[1]))
        drill.update(drill_fault_checks(drill, *exits))
        drill["seconds"] = time.perf_counter() - t0
        planes = ["http" if any(" at http://" in ln for ln in w.lines) else "tcp"
                  for w in workers]
        if planes != ["tcp", "http"]:
            raise AssertionError(f"phase 14's workers serve on the {planes} request planes")
        out["planes"] = planes
        t0 = time.perf_counter()
        out["plane_times"] = asyncio.run(kv_planes(addr))
        out["plane_times"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["clear"] = asyncio.run(kv_clear(kv_port, addr))
        out["clear"]["seconds"] = time.perf_counter() - t0
        # idle: the last events reach the routers; the service stops first,
        # then the kv frontend (the broker's founder), each printing its view
        time.sleep(1.0)
        if svc.stop() != 0:
            raise AssertionError(f"the router service exited {svc.proc.returncode}")
        svc_view = json.loads(svc.wait_line("ROUTER_EXIT", 10).split(" ", 1)[1])
        for p in (kvf, rrf):
            if p.stop() != 0:
                raise AssertionError(f"the {p.name} exited {p.proc.returncode}")
        view = json.loads(kvf.wait_line("TORCH_FRONTEND_EXIT", 10).split(" ", 1)[1])
        view = view["router"][FE_MODEL]
        reports = []
        for w in workers:
            if w.stop() != 0:
                raise AssertionError(f"the {w.name} exited {w.proc.returncode}")
            reports.append(json.loads(w.wait_line("TORCH_ENGINE_EXIT", 10).split(" ", 1)[1]))
        if store.stop() != 0:
            raise AssertionError(f"the netstore exited {store.proc.returncode}")
        problems = kv_service_checks(svc_view, reports, out["kv"]["service"], recording)
        # the drill's divergences from its clean twins, held to the tie
        # rule on the workers' weights now that the card is free
        drill["tie_gaps"] = []
        if drill["divergences"]:
            t1 = time.perf_counter()
            path = os.path.join(tmp.name, "divergences.json")
            with open(path, "w") as f:
                json.dump(drill["divergences"], f)
            control = Proc("tie control", "chip_smoke", "--tie-control", path)
            procs.append(control)
            drill["tie_gaps"] = json.loads(control.wait_line("TIE_CONTROL").split(" ", 1)[1])
            if control.join() != 0:
                raise AssertionError(f"the tie control exited {control.proc.returncode}")
            drill["tie_control_s"] = time.perf_counter() - t1
    finally:
        for p in procs:
            p.stop()
        tmp.cleanup()
    published = sum(sum(r["kv_events"].values()) for r in reports)
    if view["events_applied"] != published:
        problems.append(f"the kv router applied {view['events_applied']} events (dropped "
                        f"{view['events_dropped']}); the workers published {published}")
    for r in reports:
        seen = view["workers"].get(r["worker_id"], {"hashes": []})
        have, want = set(seen["hashes"]), set(r["prefix_cache"]["hashes"])
        if have != want:
            problems.append(f"the kv router's view of worker {r['worker_id']}: "
                            f"{len(have)} blocks, {len(want - have)} of its prefix cache's "
                            f"{len(want)} missing, {len(have - want)} it does not hold")
        ev = r["kv_events"]
        if ev["stored"] <= 0 or ev["removed"] <= 0:
            problems.append(f"worker {r['worker_id']} published {ev}: the traffic must "
                            "store and evict blocks on both workers")
    if problems:
        notes = [f"{p.name}: {ln}" for p in procs for ln in p.lines
                 if "WARNING" in ln or " ERROR " in ln or "Traceback" in ln]
        raise AssertionError("; ".join(problems) + "\n" + "\n".join(notes[-40:]))
    # a worker whose cache the clear emptied and no later request filled
    # has no entry in the view
    for part in [view["workers"][r["worker_id"]] for r in reports
                 if r["worker_id"] in view["workers"]] + [
            r["prefix_cache"] for r in reports] + list(svc_view["workers"].values()):
        part.pop("hashes")
    for r in reports:
        check_worker_exit(r)
    errors = [f"{p.name}: {ln}" for p in procs for ln in p.errors()]
    if errors:
        raise AssertionError("ERROR records in the serving plane's logs:\n"
                             + "\n".join(errors[:20]))
    out["router_view"], out["worker_exits"] = view, reports
    out["service_view"] = svc_view
    drill.pop("divergences")
    out["drill"] = drill
    kv, rr = out["kv"], out["round_robin"]
    log(f"kv_router on {smi}: {FE_MODEL} at 32 layers, two workers of {KV_BLOCKS} blocks "
        f"behind --router-mode kv over the event plane; {len(KV_DOCS)} documents of "
        f"{min(KV_DOCS)}-{max(KV_DOCS)} tokens, then a follow-up each (+{KV_NEW} tokens): "
        f"follow-ups at their document's worker {kv['hit_share'] * len(KV_DOCS):.0f} of "
        f"{len(KV_DOCS)} (round-robin control: {rr['hit_share'] * len(KV_DOCS):.0f}); "
        f"follow-up TTFT median {kv['followup_ttft_s_median'] * 1e3:.1f} ms, mean "
        f"{kv['followup_ttft_s_mean'] * 1e3:.1f} (round-robin "
        f"{rr['followup_ttft_s_median'] * 1e3:.1f} ms, mean "
        f"{rr['followup_ttft_s_mean'] * 1e3:.1f}); router-predicted cached tokens "
        f"{kv['predicted_tokens']:.0f} against {kv['cached_tokens']} the workers reported")
    log(f"kv_router events: " + ", ".join(
        f"worker {r['worker_id']} stored {r['kv_events']['stored']} removed "
        f"{r['kv_events']['removed']}, prefix cache {r['prefix_cache']['blocks']} blocks "
        f"({r['prefix_cache']['digest']})" for r in reports)
        + f"; router applied {view['events_applied']} (dropped {view['events_dropped']}), "
        f"its view equal to each prefix cache; kernels " + "; ".join(
            f"worker {r['worker_id']}: decode {r['launches']['decode']}, flash_extend "
            f"{r['launches']['flash_extend']}, unified {r['launches']['unified']}"
            for r in reports))
    log(f"kv_router service (python -m dynamo_tpu_torch.router --record-events) on {smi}: "
        f"{len(kv['service'])} of {len(kv['service'])} follow-ups put to its route op "
        f"first got the kv frontend's worker and predicted cached tokens "
        f"({sum(a['cached_tokens'] for a in kv['service'])} in all); its view equal to each "
        f"worker's prefix cache, {svc_view['events_applied']} events applied and "
        f"{svc_view['recorded']} recorded, the recording replayed into a fresh KvRouter to "
        f"the same view; the service ready in {out['service_ready_s']:.1f} s, its route ops "
        f"{sum(a['ask_s'] for a in kv['service']):.2f} s in all")
    log(f"fault drill on {smi}: (a) {DRILL_REQUESTS} greedy chat requests without a model "
        f"({DRILL_BATCH} at a time, 32-62 tokens) through a round-robin frontend armed with "
        f"{DRILL_SPEC!r}: {drill['drops']} of {drill['sends']} sends dropped (calls "
        f"{[i for _, _, i in drill['fired']]}, = FaultRegistry.plan), "
        f"{drill['migrations']} migrations, all {DRILL_REQUESTS} served 200 with the clean frontend's tokens "
        f"({len(drill['tie_gaps'])} within the tie rule: {drill['tie_gaps']}), "
        f"{drill['a_s']:.2f} s; worker breakers {drill['worker_breakers']}. (b) "
        f"{DRILL_TRIP_SENDS} sends dropped: {DRILL_TRIPS} worker-loss 503s opened "
        f"frontend.{FE_MODEL}, 1 request shed with 503 and Retry-After "
        f"{drill['retry_after']} s and no send, the probe after the {DRILL_RESET_S:.0f} s "
        f"reset served and closed it {drill['close_s']:.2f} s after it opened; transitions "
        f"{drill['transitions']}, state {drill['state']:.0f}; (b) {drill['b_s']:.2f} s; "
        f"the drill {drill['seconds']:.1f} s in all")
    pt = out["plane_times"]
    log(f"kv_router request planes on {smi}: the same 1-token request ({KV_PLANE_ROUNDS} "
        f"each, in turns, the prompt cached) straight to each idle worker: first item "
        f"median HTTP {pt['http']['first_s_median'] * 1e3:.2f} ms against TCP "
        f"{pt['tcp']['first_s_median'] * 1e3:.2f} ms, whole request "
        f"{pt['http']['total_s_median'] * 1e3:.2f} against "
        f"{pt['tcp']['total_s_median'] * 1e3:.2f} ms (the two workers' engines differ); "
        f"the plane alone, a ping through each worker's request server "
        f"({4 * KV_PLANE_ROUNDS} each, in turns): median HTTP "
        f"{pt['http']['ping_s_median'] * 1e3:.3f} ms against TCP "
        f"{pt['tcp']['ping_s_median'] * 1e3:.3f} ms; {pt['seconds']:.1f} s")
    cl = out["clear"]
    log(f"kv_router clear on {smi}: worker 1 on the HTTP request plane, worker 0 on TCP "
        f"({out['planes']}); POST /clear_kv_blocks {{\"levels\": [\"g1\"]}} dropped "
        + ", ".join(f"{v} blocks on {k}" for k, v in cl["dropped"].items())
        + f", the router service's view emptied through the CLEARED events, a follow-up "
        f"after it {cl['cached_tokens']} cached tokens ({cl['predicted']:.0f} predicted); "
        f"{cl['seconds']:.1f} s")
    probe = f"kv decode probe on {smi}: ITL median {out['steady']['itl_s_median'] * 1e3:.2f} ms"
    if fe is not None:
        probe += (f"; phase 13's (one worker, in-process event plane): "
                  f"{fe['steady']['frontend']['itl_s_median'] * 1e3:.2f} ms through the "
                  f"frontend, {fe['steady']['in_process']['itl_s_median'] * 1e3:.2f} ms "
                  "in-process")
    log(probe)
    return out


DG_PROMPTS = FE_PROMPTS  # the 8-prompt traffic, 100-6000 tokens, 0.25 s apart
DG_TOKENS = FE_TOKENS    # greedy tokens each
DG_SHORT = 50            # a prompt this short deflects (DTPU_DEFLECT_MAX_TOKENS 64)
DG_LONG = 4000           # some prompt this long must get a window before its prefill ends
DG_TOP = 5               # top logprobs a token, for the tie rule
DG_WORKER = (*FE_WORKER, "--event-plane", "zmq", "--system-port", "0")
# the frontends: the short-prompt bound below the traffic's shortest
# prompt, and no load-skew deflection (the gates need every traffic
# request to take the hop)
DG_FRONT_ENV = {"DTPU_DEFLECT_MAX_TOKENS": "64", "DTPU_DEFLECT_MARGIN": "1000"}
DG_PAGE_LAYERS = 4       # the in-process page-copy checks: llama3-8b width, 4 layers
DG_PAGE_PROMPT = 3000    # tokens of their prompt (187 full blocks)
DG_TIME_BLOCKS = 188     # a 3000-token prompt's blocks, for the wire copies' times
DG_TIME_POOL = 400       # pages per layer of the timed caches
DG_NATIVE_SLOTS = 64     # 2 MiB blocks of the native wire's timing (128 MiB)
STREAM_WINDOW = 8        # the streamed protocol's window (DTPU_STREAM_WINDOW's default)
DG_CKPT_PROMPT = 2000    # tokens of the prompt the drained worker checkpoints


def dg_body(n: int, seed: int) -> tuple:
    """An ``n``-token prompt as streamed greedy chat, DG_TOKENS tokens with
    DG_TOP top logprobs (the tie rule reads them)."""
    return ("/v1/chat/completions", dict(
        model=FE_MODEL, messages=[{"role": "user", "content": fe_prompt(n, seed)}],
        max_tokens=DG_TOKENS, temperature=0.0, ignore_eos=True, stream=True,
        logprobs=True, top_logprobs=DG_TOP, stream_options={"include_usage": True}))


def dg_bodies(seed: int = 1700) -> list:
    """The disagg traffic: the 8-prompt lengths (``dg_body``), the same
    bodies in every run."""
    return [dg_body(n, seed + i) for i, n in enumerate(DG_PROMPTS)]


async def drain_watched(addr: str, status_port: int, deadline_s: float = 30.0) -> tuple:
    """``POST /drain`` to a worker's status port while watching the
    discovery records: (the drain's summary, every ``state`` a record was
    published with meanwhile)."""
    from dynamo_tpu_torch.runtime import codec
    from dynamo_tpu_torch.runtime.discovery.store import make_store

    store = make_store("tcp", addr)
    watcher = await store.watch("v1/instances/")
    states = []

    async def collect():
        async for ev in watcher:
            if ev.value is not None:
                states.append(codec.unpackb(ev.value).get("metadata", {}).get("state"))

    task = asyncio.ensure_future(collect())
    try:
        status, summary = await http_call(status_port, "POST", "/drain",
                                          {"deadline_s": deadline_s})
        if status != 200:
            raise AssertionError(f"POST /drain: HTTP {status}: {summary}")
        await asyncio.sleep(0.5)
    finally:
        watcher.cancel()
        await task
        await store.close()
    return summary, states


def restore_line(line: str) -> dict:
    """A worker's ``CHECKPOINT_RESTORE mode=... blocks=...`` line's fields."""
    fields = dict(kv.split("=", 1) for kv in line.split()[1:])
    return {k: (v if k == "mode" else float(v) if "." in v else int(v))
            for k, v in fields.items()}


def dg_stream_tokens(events: list) -> list:
    """A streamed chat's tokens as (string, logprob, {top string: logprob})."""
    out = []
    for _, e in events:
        if e == "[DONE]" or not e["choices"]:
            continue
        for ent in ((e["choices"][0].get("logprobs") or {}).get("content") or []):
            out.append((ent["token"], ent["logprob"],
                        {t["token"]: t["logprob"] for t in ent["top_logprobs"]}))
    return out


async def dg_run(port: int, bodies: list) -> dict:
    """One run of the traffic through the frontend on ``port``, one request
    at a time (each decodes alone, so two runs that import the same bytes
    compute the same logits: bf16 ties flip with the batch mix): per
    request its stats and tokens, and the run's TTFT / ITL medians."""
    stats = []
    t0 = time.perf_counter()
    for i, (path, body) in enumerate(bodies):
        t_sub = time.perf_counter()
        status, events = await http_call(port, "POST", path, body)
        if status != 200:
            raise AssertionError(f"disagg request {i}: HTTP {status}: {str(events)[:300]}")
        st = fe_stream_stats(t_sub, events, True)
        st["tokens_lp"] = dg_stream_tokens(events)
        if st["tokens"] != DG_TOKENS or len(st["tokens_lp"]) != DG_TOKENS:
            raise AssertionError(f"disagg request {i}: {st['tokens']} tokens, "
                                 f"{len(st['tokens_lp'])} logprob entries")
        stats.append(st)
    return {"stats": stats, "summary": fe_summary(stats, time.perf_counter() - t0)}


async def dg_overlap(port: int, seed: int) -> list:
    """A 3000-token prompt (64 tokens) and, 0.5 s later while it decodes,
    a DG_SHORT-token completion: the short prompt prefills on the decode
    worker beside the other's decode rows (a fused mixed step: the
    unified kernel). Returns both requests' stats."""
    long = ("/v1/completions", dict(
        model=FE_MODEL, prompt=fe_prompt(3000, seed), max_tokens=64, temperature=0.0,
        ignore_eos=True, stream=True, stream_options={"include_usage": True}))
    short = ("/v1/completions", dict(long[1], prompt=fe_prompt(DG_SHORT, seed + 1),
                                     max_tokens=DG_TOKENS))
    stats, _ = await fe_traffic(port, [long, short], gap=0.5)
    return stats


async def dg_worker_doc(status_port: int) -> dict:
    status, doc = await http_call(status_port, "GET", "/debug/worker")
    if status != 200:
        raise AssertionError(f"the decode worker's /debug/worker: HTTP {status}")
    return doc


async def dg_clear(port: int, addr: str, prefill: bool) -> None:
    """Empty the decode workers' prefix caches (``POST /clear_kv_blocks``
    through the frontend) and, with ``prefill``, the prefill pool's
    (its ``clear_kv_blocks`` endpoint, straight: the frontend fans out to
    the decode pool only, as the reference's); then a beat for the
    CLEARED events to reach the KV router."""
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    status, body = await http_call(port, "POST", "/clear_kv_blocks", {"levels": ["g1"]})
    if status != 200:
        raise AssertionError(f"POST /clear_kv_blocks: HTTP {status}: {str(body)[:300]}")
    if prefill:
        rt = await DistributedRuntime(RuntimeConfig(store="tcp", store_path=addr,
                                                    event_plane="inproc")).start()
        try:
            client = await rt.namespace("dynamo").component("backend_prefill").endpoint(
                "clear_kv_blocks").client()
            await client.wait_for_instances(1)
            (got,) = [x async for x in await client.generate({"levels": ["g1"]})]
            if got["snapshot"]["cached_blocks"] != 0:
                raise AssertionError(f"the prefill worker's clear: {got}")
        finally:
            await rt.shutdown()
    await asyncio.sleep(1.0)


def dg_new_pulls(before: dict, after: dict) -> list:
    got = after["transfer"].get("client", {}).get("pulls", [])
    return got[len(before["transfer"].get("client", {}).get("pulls", [])):]


def dg_check_pulls(tag: str, pulls: list, wire: str) -> None:
    """Every request of a run imported all its full blocks over ``wire``."""
    if len(pulls) != len(DG_PROMPTS):
        raise AssertionError(f"disagg run {tag}: {len(pulls)} pulls for {len(DG_PROMPTS)} "
                             f"requests: {pulls}")
    for p in pulls:
        if p["tokens"] != p["want_tokens"] or p["wire"] != wire:
            raise AssertionError(f"disagg run {tag}: a pull imported {p['tokens']} of "
                                 f"{p['want_tokens']} tokens over {p['wire']!r} (want all, "
                                 f"over {wire!r}): {p}")


def dg_divergences(tag: str, run: list, ref: list, bodies: list) -> tuple:
    """(streams equal to the reference run's, divergences in the drill's
    form for the tie control)."""
    equal, out = 0, []
    for i, (a, b, (_, body)) in enumerate(zip(run, ref, bodies)):
        ta, tb = a["tokens_lp"], b["tokens_lp"]
        j = next((j for j, (x, y) in enumerate(zip(ta, tb)) if x[0] != y[0]), None)
        if j is None:
            equal += 1
            continue
        out.append({"request": f"{tag}{i}", "index": j,
                    "body": {k: v for k, v in body.items() if k not in (
                        "stream", "stream_options", "logprobs", "top_logprobs")},
                    "prefix": [t for t, _, _ in tb[:j]], "drill": ta[j], "clean": tb[j]})
    return equal, out


def dg_page_checks(torch, timer) -> dict:
    """In process, on the card: the wire-order page copies at llama3-8b's
    width and DG_PAGE_LAYERS layers, bf16 and int8. A prompt prefilled on
    a source engine; its blocks gathered by gather_layers_wire (one
    launch) must equal gather_layers_wire_ref bit for bit, scattered by
    scatter_layers_wire into permuted pages of a second engine, its whole
    pool must equal scatter_layers_wire_ref's on clones taken before the
    kernel; the in-process mover (LocalKvMover) must
    leave the destination's pages equal to the source's. The native
    arena's packed gather (gather_layers_packed, one launch: the blocks'
    storage format, the int8 codec's bytes for int8) must equal its plain
    version bit for bit, and two fetches through the source's transfer
    server must import bit-exactly: one that says ``native_ok: false``
    (the inline wire) and one over the native agent. Then the wire
    copies timed at 32 layers on DG_TIME_BLOCKS pages (a 3000-token
    prompt), against their byte bound and plain versions, and the native
    wire at llama3-8b's 2 MiB blocks (native_wire_checks)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.engine.transfer import LocalKvMover, wire_pages_from_item
    from dynamo_tpu_torch.llm.protocols.common import (PreprocessedRequest,
                                                       SamplingOptions, StopConditions)
    from dynamo_tpu_torch.models import registry
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.ops import block_copy as bc
    from dynamo_tpu_torch.ops.quant import QuantizedKV
    from dynamo_tpu_torch.runtime import Context
    from dynamo_tpu_torch.tokens import compute_sequence_hashes

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=DG_PAGE_LAYERS)
    params = registry.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompt = [int(t) for t in np.random.default_rng(5).integers(0, 128000, DG_PAGE_PROMPT)]
    hashes = [int(h) for h in compute_sequence_hashes(prompt, 16)]

    def parts(p):
        return [p.data, p.scale] if isinstance(p, QuantizedKV) else [p]

    def same(a, b) -> bool:
        return all(torch.equal(x.view(torch.uint8) if x.dtype != torch.float32 else x,
                               y.view(torch.uint8) if y.dtype != torch.float32 else y)
                   for x, y in zip(parts(a), parts(b)))

    out = {}
    for kv in ("model", "int8"):
        def engine():
            return TorchEngine(TorchEngineConfig(
                model=cfg, device="cuda", kv_dtype=kv, num_blocks=512, max_batch_size=2,
                max_context=4096, decode_steps=1, decode_pipeline=1), params=params)

        async def main():
            src, dst, moved, inline, native = (engine() for _ in range(5))
            try:
                req = PreprocessedRequest(request_id="pages", model="m", token_ids=prompt,
                                          stop=StopConditions(max_tokens=1),
                                          sampling=SamplingOptions(temperature=0.0))
                async for _ in src.generate(req, Context()):
                    pass
                ids = torch.tensor(src.allocator.match_prefix(hashes), dtype=torch.int32,
                                   device="cuda")
                n = ids.shape[0]
                got = bc.gather_layers_wire(src.k_caches, src.v_caches, ids)
                want = bc.gather_layers_wire_ref(src.k_caches, src.v_caches, ids)
                gather_ok = same(got, want)
                # permuted, scattered destination pages; the plain version
                # writes the same pages into clones taken before the kernel,
                # so a stray write anywhere in the pool shows
                dst_ids = torch.as_tensor(
                    1 + np.random.default_rng(9).permutation(511)[:n].astype(np.int32),
                    device="cuda")
                ref_k = [QuantizedKV(c.data.clone(), c.scale.clone())
                         if isinstance(c, QuantizedKV) else c.clone() for c in dst.k_caches]
                ref_v = [QuantizedKV(c.data.clone(), c.scale.clone())
                         if isinstance(c, QuantizedKV) else c.clone() for c in dst.v_caches]
                bc.scatter_layers_wire(dst.k_caches, dst.v_caches, dst_ids, got)
                bc.scatter_layers_wire_ref(ref_k, ref_v, dst_ids, got)
                torch.cuda.synchronize()
                scatter_ok = all(same(a, b) for a, b in zip(dst.k_caches + dst.v_caches,
                                                            ref_k + ref_v))
                got_n = await LocalKvMover(src, moved).move(hashes[:n])
                m_ids = torch.tensor(moved.allocator.match_prefix(hashes[:n]),
                                     dtype=torch.int32, device="cuda")
                torch.cuda.synchronize()
                mover_ok = got_n == n and m_ids.shape[0] == n and same(
                    bc.gather_layers_wire_ref(moved.k_caches, moved.v_caches, m_ids), want)
                packed = bc.gather_layers_packed(src.k_caches, src.v_caches, ids)
                packed_ok = torch.equal(
                    packed, bc.gather_layers_packed_ref(src.k_caches, src.v_caches, ids))
                # the transfer server's inline frame (native_ok: false) and
                # a native pull, each imported into an engine of its own
                addr = await src.serve_transfer()
                (item,) = [it async for it in src._kv_transfer_srv.handle(
                    {"hashes": hashes[:n], "native_ok": False}, None)]
                pages, scales = wire_pages_from_item(item)
                got_in = await inline.import_blocks(
                    hashes[:n], pages if scales is None else (pages, scales), wire=True)
                saved = {k: os.environ.get(k) for k in ("DTPU_DEVICE_TRANSFER",
                                                        "DTPU_ICI_TRANSFER")}
                os.environ.update(DTPU_DEVICE_TRANSFER="0", DTPU_ICI_TRANSFER="0")
                try:
                    client = native._get_transfer_client()
                    got_nat = await client.fetch_and_import(addr, hashes[:n])
                finally:
                    for k, v in saved.items():
                        if v is None:
                            os.environ.pop(k, None)
                        else:
                            os.environ[k] = v
                torch.cuda.synchronize()

                def imported(e):
                    e_ids = torch.tensor(e.allocator.match_prefix(hashes[:n]),
                                         dtype=torch.int32, device="cuda")
                    return e_ids.shape[0] == n and same(
                        bc.gather_layers_wire_ref(e.k_caches, e.v_caches, e_ids), want)

                return {"blocks": n, "gather_bit_exact": gather_ok,
                        "scatter_bit_exact": scatter_ok, "mover_bit_exact": mover_ok,
                        "packed_gather_bit_exact": packed_ok,
                        "inline_fetch_bit_exact": "data" in item and got_in == n
                        and imported(inline),
                        "native_fetch_bit_exact": client.pulls[-1]["wire"] == "native"
                        and got_nat == n * 16 and imported(native)}
            finally:
                for e in (src, dst, moved, inline, native):
                    e.stop()

        out[kv] = asyncio.run(main())
        if not all(v for k, v in out[kv].items() if k.endswith("exact")):
            raise AssertionError(f"the wire-order page copies and fetches ({kv} cache): "
                                 f"{out[kv]}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # the copies' times at full depth: 32 layers' K and V, DG_TIME_BLOCKS pages
    full = LlamaConfig.llama3_8b()
    shape = (DG_TIME_POOL, 16, full.num_kv_heads, full.head_dim)
    gen = torch.Generator(device="cuda").manual_seed(3)
    ks = [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(full.num_layers)]
    vs = [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(full.num_layers)]
    ids = torch.randperm(DG_TIME_POOL, generator=gen, device="cuda")[:DG_TIME_BLOCKS].to(
        torch.int32)
    pages = bc.gather_layers_wire(ks, vs, ids)
    nbytes = pages.numel() * pages.element_size()
    t = {"gather_ms": timer(lambda: bc.gather_layers_wire(ks, vs, ids, out=pages), reps=5),
         "scatter_ms": timer(lambda: bc.scatter_layers_wire(ks, vs, ids, pages), reps=5),
         "gather_plain_ms": timer(lambda: bc.gather_layers_wire_ref(ks, vs, ids), reps=3),
         "scatter_plain_ms": timer(lambda: bc.scatter_layers_wire_ref(ks, vs, ids, pages),
                                   reps=3),
         "bytes": nbytes, "bound_ms": bound(2 * nbytes, 0)[0]}
    packed = bc.gather_layers_packed(ks, vs, ids)
    t["packed_ms"] = timer(lambda: bc.gather_layers_packed(ks, vs, ids, out=packed), reps=5)
    t["packed_plain_ms"] = timer(lambda: bc.gather_layers_packed_ref(ks, vs, ids), reps=3)
    out["timed"] = t
    del ks, vs, pages, packed
    torch.cuda.empty_cache()
    out["native_wire"] = native_wire_checks(torch)
    return out


def native_wire_checks(torch) -> dict:
    """The native wire on the card's host, apart from the engines: an agent
    of this process serving a pinned arena of DG_NATIVE_SLOTS llama3-8b
    bf16 blocks (2 MiB) of random bytes over loopback. Seconds (median of
    5) of one fetch of every slot and of 8-block windows into a pinned
    buffer, each read bit-exact, and of the crc32s of the same bytes (the
    check both sides of a native pull make), warm."""
    import zlib

    from dynamo_tpu_torch.transfer import NativeAgent, native_fetch

    block = int(np.prod(GK_BLOCK_SHAPE)) * 2
    n = DG_NATIVE_SLOTS
    arena = torch.empty(n * block, dtype=torch.uint8, pin_memory=True)
    arena.copy_(torch.randint(0, 256, (n * block,), dtype=torch.uint8,
                              generator=torch.Generator().manual_seed(8)))
    buf = torch.empty(n * block, dtype=torch.uint8, pin_memory=True)
    agent = NativeAgent(host="127.0.0.1")
    try:
        agent.register(1, arena, block)
        ids = list(range(n))

        def whole():
            native_fetch("127.0.0.1", agent.port, 1, ids, block, buf)

        def windows():
            for lo in range(0, n, STREAM_WINDOW):
                native_fetch("127.0.0.1", agent.port, 1, ids[lo:lo + STREAM_WINDOW], block,
                             buf[lo * block:(lo + STREAM_WINDOW) * block])

        host = buf.view(n, block).numpy()

        def crcs():
            return [zlib.crc32(host[i]) for i in range(n)]

        out = {"blocks": n, "block_bytes": block}
        for key, fn in (("whole_s", whole), ("windows_s", windows), ("crc_s", crcs)):
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            out[key] = statistics.median(times)
            if key != "crc_s" and not torch.equal(buf, arena):
                raise AssertionError(f"the native wire ({key}) read other bytes than served")
    finally:
        agent.close()
    nbytes = n * block
    out.update(whole_gb_s=nbytes / out["whole_s"] / 1e9,
               windows_gb_s=nbytes / out["windows_s"] / 1e9,
               crc_gb_s=nbytes / out["crc_s"] / 1e9)
    return out


def dg_check_exits(exits: dict) -> None:
    """The workers' exit lines: each decode worker as phase 13's, the
    prefill worker's chunks through flash-extend and its pages through
    the page-copy gather, the decode workers' through its scatter, and the
    drained worker's checkpoint through its gather."""
    for key in ("decode_device", "decode_inline"):
        check_worker_exit(exits[key])
    for key, name in (("prefill", "flash_extend"), ("prefill", "gather"),
                      ("decode_device", "scatter"), ("decode_device", "gather"),
                      ("decode_inline", "scatter")):
        if exits[key]["launches"][name] <= 0:
            raise AssertionError(f"the {key} worker never launched {name}: "
                                 f"{exits[key]['launches']}")


def disagg_phase(torch, smi: str) -> dict:
    """Phase 15 (module docstring): disaggregated prefill/decode on one
    card. The in-process page-copy checks, then the netstore, a
    ``--disagg prefill`` and a ``--disagg decode`` llama3-8b worker, a KV
    frontend (streamed) and a round-robin one (sequential): runs (a)-(d)
    with their gates; returns the phase's numbers and each worker's
    page-copy launches."""
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"pages": dg_page_checks(torch, Timer(torch))}
    out["pages_s"] = time.perf_counter() - t0
    bodies = dg_bodies()
    # the prompt the device decode worker holds when it drains
    ckpt_body = dg_body(DG_CKPT_PROMPT, 1950)
    procs = []
    tmp = tempfile.TemporaryDirectory()
    ckpt_dir = os.path.join(tmp.name, "ckpt")
    t0 = time.perf_counter()
    try:
        store = Proc("netstore", "dynamo_tpu_torch.runtime.discovery.netstore",
                     "--host", "127.0.0.1", "--port", "0")
        procs.append(store)
        addr = store.wait_line("KVSTORE_READY", 30).split()[1]
        common = ("--store", "tcp", "--store-path", addr)
        kvf = Proc("disagg kv frontend", "dynamo_tpu_torch.frontend", *common, "--event-plane",
                   "zmq", "--router-mode", "kv", "--host", "127.0.0.1", "--port", "0",
                   env=DG_FRONT_ENV)
        procs.append(kvf)
        kv_port = int(kvf.wait_line("TORCH_FRONTEND_READY", 60).rsplit(":", 1)[1])
        seqf = Proc("disagg sequential frontend", "dynamo_tpu_torch.frontend", *common,
                    "--host", "127.0.0.1", "--port", "0",
                    env={**DG_FRONT_ENV, "DTPU_STREAM_KV": "0"})
        procs.append(seqf)
        prefill = Proc("prefill worker", "dynamo_tpu_torch.engine", *common, *DG_WORKER,
                       "--disagg", "prefill", env={"DTPU_KV_WIRE": "device"})
        decode = Proc("decode worker", "dynamo_tpu_torch.engine", *common, *DG_WORKER,
                      "--disagg", "decode", env={"DTPU_CKPT_DIR": ckpt_dir})
        procs += [prefill, decode]
        seq_port = int(seqf.wait_line("TORCH_FRONTEND_READY", 60).rsplit(":", 1)[1])
        for w in (prefill, decode):
            w.wait_line("TORCH_ENGINE_READY")
        status_port = int(decode.wait_line("TORCH_STATUS_ADDRESS").rsplit(":", 1)[1])
        prefill_status = int(prefill.wait_line("TORCH_STATUS_ADDRESS").rsplit(":", 1)[1])
        asyncio.run(kv_models(kv_port))
        asyncio.run(kv_models(seq_port))
        out["ready_s"] = time.perf_counter() - t0

        async def run(port, tag, wire, status):
            before = await dg_worker_doc(status)
            got = await dg_run(port, bodies)
            after = await dg_worker_doc(status)
            pulls = dg_new_pulls(before, after)
            if wire is not None:
                dg_check_pulls(tag, pulls, wire)
            elif pulls:
                raise AssertionError(f"disagg run {tag} (aggregated) pulled pages: {pulls}")
            got["pulls"] = pulls
            got["bandwidth"] = after["bandwidth"]
            return got

        async def runs_ab():
            before = await dg_worker_doc(prefill_status)
            res = {"a": await run(kv_port, "a", "device", status_port)}
            after = await dg_worker_doc(prefill_status)
            served = after["transfer"]["server"]["streams"]
            res["a"]["streams"] = served[len(before["transfer"]["server"]["streams"]):]
            # the deflected prompt, while the prefill pool is there and a
            # disaggregated request decodes: one pull, the long prompt's
            doc = await dg_worker_doc(status_port)
            st = await dg_overlap(kv_port, 1650)
            doc2 = await dg_worker_doc(status_port)
            _, metrics = await http_text(kv_port, "/metrics")
            deflected = sum(float(ln.rsplit(" ", 1)[1]) for ln in metrics.splitlines()
                            if ln.startswith("dtpu_prefill_deflected_total{")
                            and 'reason="short_prompt"' in ln)
            pulls = dg_new_pulls(doc, doc2)
            if len(pulls) != 1 or pulls[0]["tokens"] != pulls[0]["want_tokens"] or (
                    deflected != 1):
                raise AssertionError(f"the {DG_SHORT}-token prompt beside a 3000-token one: "
                                     f"deflected {deflected}, pulls {pulls}")
            res["short"] = {"prompt_tokens": st[1]["usage"]["prompt_tokens"],
                            "deflected": deflected}
            # the 8-prompt traffic as it is sent elsewhere, 0.25 s apart (new
            # prompts): several pulls in flight through the device path
            doc = await dg_worker_doc(status_port)
            stats, wall = await fe_traffic(kv_port, dg_bodies(seed=1800))
            check_fe_stats("disagg staggered", stats, DG_TOKENS)
            pulls = dg_new_pulls(doc, await dg_worker_doc(status_port))
            dg_check_pulls("a, staggered", pulls, "device")
            res["staggered"] = {"summary": fe_summary(stats, wall), "pulls": pulls}
            await dg_clear(kv_port, addr, prefill=True)
            res["b"] = await run(seq_port, "b", "device", status_port)
            await dg_clear(kv_port, addr, prefill=True)
            # one more prompt, whose blocks are then all the decode worker's
            # cache holds: the drain's checkpoint
            res["ckpt_first"] = (await dg_run(kv_port, [ckpt_body]))["stats"]
            return res

        res = asyncio.run(runs_ab())
        # the device decode worker drains (POST /drain) into a checkpoint
        # and exits on its own
        t1 = time.perf_counter()
        sealed = asyncio.run(dg_worker_doc(status_port))["engine"]["cached_blocks"]
        summary, states = asyncio.run(drain_watched(addr, status_port))
        if decode.join(60) != 0:
            raise AssertionError(f"the drained decode worker exited {decode.proc.returncode}")
        exits = {"decode_device": json.loads(decode.wait_line("TORCH_ENGINE_EXIT", 10)
                                             .split(" ", 1)[1])}
        evacuated = exits["decode_device"]["drain_metrics"].get(
            "dtpu_drain_evacuated_blocks_total")
        if not (summary["quiesced"] and 0 < sealed == summary["checkpoint_blocks"]
                == exits["decode_device"]["drain"]["checkpoint_blocks"] == evacuated
                and "draining" in states):
            raise AssertionError(f"the drain: {sealed} sealed blocks, summary {summary}, "
                                 f"evacuated counter {evacuated}, discovery states {states}")
        out["drain"] = dict(summary, sealed=sealed, states=sorted(set(map(str, states))),
                            exit_s=time.perf_counter() - t1)
        log("disagg drain: " + json.dumps(out["drain"]))
        # (c): the decode worker again, with the device path off: it
        # restores the checkpoint, and its pulls take the native wire
        t1 = time.perf_counter()
        decode2 = Proc("decode worker (inline)", "dynamo_tpu_torch.engine", *common,
                       *DG_WORKER, "--disagg", "decode",
                       env={"DTPU_DEVICE_TRANSFER": "0", "DTPU_CKPT_DIR": ckpt_dir})
        procs.append(decode2)
        restored = restore_line(decode2.wait_line("CHECKPOINT_RESTORE"))
        windows = -(-sealed // 64)
        if (restored["mode"], restored["blocks"], restored["windows"],
                restored["scatter"]) != ("warm", sealed, windows, windows):
            raise AssertionError(f"the restore: {restored}; want warm, {sealed} blocks in "
                                 f"{windows} windows, one scatter launch each")
        out["restore"] = restored
        log("disagg restore: " + json.dumps(restored))
        status2 = int(decode2.wait_line("TORCH_STATUS_ADDRESS").rsplit(":", 1)[1])
        decode2.wait_line("TORCH_ENGINE_READY")

        async def runs_cd():
            for _ in range(400):   # the new decode worker behind the router again
                st, body = await http_call(kv_port, "GET", "/v1/models")
                if st == 200 and body["data"]:
                    break
                await asyncio.sleep(0.05)
            await asyncio.sleep(1.0)
            res["c"] = await run(kv_port, "c", "native", status2)
            # the checkpointed prompt again: its restored blocks cached
            res["ckpt_again"] = (await dg_run(kv_port, [ckpt_body]))["stats"]
            return res

        res = asyncio.run(runs_cd())
        out["restart_s"] = time.perf_counter() - t1
        # (d): the prefill pool gone, the same prompts on the decode worker alone
        if prefill.stop() != 0:
            raise AssertionError(f"the prefill worker exited {prefill.proc.returncode}")
        exits["prefill"] = json.loads(prefill.wait_line("TORCH_ENGINE_EXIT", 10)
                                      .split(" ", 1)[1])

        async def run_d():
            await dg_clear(kv_port, addr, prefill=False)
            res["d"] = await run(kv_port, "d", None, status2)
            # and a fused mixed step on this decode worker too
            await dg_overlap(kv_port, 1660)

        asyncio.run(run_d())
        time.sleep(1.0)
        for p in (kvf, seqf):
            if p.stop() != 0:
                raise AssertionError(f"the {p.name} exited {p.proc.returncode}")
        view = json.loads(kvf.wait_line("TORCH_FRONTEND_EXIT", 10).split(" ", 1)[1])
        view = view["router"][FE_MODEL]
        if decode2.stop() != 0:
            raise AssertionError(f"the {decode2.name} exited {decode2.proc.returncode}")
        exits["decode_inline"] = json.loads(decode2.wait_line("TORCH_ENGINE_EXIT", 10)
                                            .split(" ", 1)[1])
        if store.stop() != 0:
            raise AssertionError(f"the netstore exited {store.proc.returncode}")
        out["runs_s"] = time.perf_counter() - t0 - out["ready_s"]
        # the gates: no fallback in either decode worker's life (the device
        # one served (a), its overlap and staggered requests and (b); the
        # inline one (c) and (d))
        for key in ("decode_device", "decode_inline"):
            fb = exits[key]["transfer"]["fallbacks"]
            if any(fb["counts"].values()):
                raise AssertionError(f"the disagg phase's {key} worker: transfer fallbacks "
                                     f"{fb}")
        # the restored prompt: every full block of its prompt cached (but
        # the last token's), and the first run's tokens or within the tie
        # rule
        again = res["ckpt_again"][0]
        reusable = (again["usage"]["prompt_tokens"] - 1) // 16 * 16
        if again["usage"].get("cached_tokens") != reusable:
            raise AssertionError(f"the checkpointed prompt after the restore: usage "
                                 f"{again['usage']}, want {reusable} cached tokens")
        eq_ckpt, div_ckpt = dg_divergences("ckpt", res["ckpt_again"], res["ckpt_first"],
                                           [ckpt_body])
        out["restore"].update(cached_tokens=reusable, equal=eq_ckpt,
                              seconds_to_ready=time.perf_counter() - t1)
        # (a), (b) and (c) import the same bytes: the same tokens; (a) and
        # (c) compute the same logits too (the same logprobs), where (b)'s
        # first token is the prefill worker's
        a = res["a"]["stats"]
        for tag, key in (("b", lambda st: [t for t, _, _ in st["tokens_lp"]]),
                         ("c", lambda st: st["tokens_lp"])):
            same = [key(x) == key(y) for x, y in zip(a, res[tag]["stats"])]
            if not all(same):
                raise AssertionError(f"disagg runs (a) and ({tag}): streams {same} equal")
        # the prefill side's record of each streamed fetch: a first window
        # that waited for a chunk's commit and went out while blocks of the
        # prompt were still uncommitted went out before the prefill ended
        early = [st for st in res["a"]["streams"] if st["blocks"] >= DG_LONG // 16
                 and st["waits"] and st["waits"][0] > 0
                 and st["committed_at_first_window"] < st["blocks"]]
        if not early:
            raise AssertionError(f"disagg run (a): no prompt of {DG_LONG}+ tokens got a "
                                 f"window before its prefill ended: {res['a']['streams']}")
        rep = exits["decode_inline"]
        have = set(view["workers"].get(rep["worker_id"], {"hashes": []})["hashes"])
        want = set(rep["prefix_cache"]["hashes"])
        if have != want or not want:
            raise AssertionError(f"the kv router's view of the decode worker: {len(have)} "
                                 f"blocks against its cache's {len(want)}")
        # (d), the aggregated control, against (a): equal, or within the
        # tie rule
        eq = {"b": len(a), "c": len(a)}
        eq["d"], div = dg_divergences("d", res["d"]["stats"], a, bodies)
        div += div_ckpt
        gaps = []
        if div:
            path = os.path.join(tmp.name, "divergences.json")
            with open(path, "w") as f:
                json.dump(div, f)
            control = Proc("tie control", "chip_smoke", "--tie-control", path)
            procs.append(control)
            gaps = json.loads(control.wait_line("TIE_CONTROL").split(" ", 1)[1])
            if control.join() != 0:
                raise AssertionError(f"the tie control exited {control.proc.returncode}")
    finally:
        for p in procs:
            p.stop()
        tmp.cleanup()
    errors = [f"{p.name}: {ln}" for p in procs for ln in p.errors()]
    if errors:
        raise AssertionError("ERROR records in the disagg phase's logs:\n"
                             + "\n".join(errors[:20]))
    dg_check_exits(exits)
    out.update(runs={k: {"summary": v["summary"], "pulls": v["pulls"],
                         "bandwidth": v["bandwidth"]} for k, v in res.items()
                     if k in ("a", "b", "c", "d")},
               short=res["short"], staggered=res["staggered"], equal_to_a=eq, tie_gaps=gaps,
               launches={"gather": exits["prefill"]["launches"]["gather"]
                         + exits["decode_device"]["launches"]["gather"],
                         "scatter": sum(exits[k]["launches"]["scatter"]
                                        for k in ("decode_device", "decode_inline")),
                         "prefill_worker": exits["prefill"]["launches"],
                         "decode_workers": [exits[k]["launches"]
                                            for k in ("decode_device", "decode_inline")]},
               long_pull=early[0])
    return out


def disagg_summary(dg: dict, smi: str) -> list:
    lines = []
    pg = dg["pages"]
    t = pg["timed"]
    lines.append(
        f"disagg page copies on {smi}: wire-order gather / scatter at llama3-8b width, "
        f"{DG_PAGE_LAYERS} layers, bit-exact to their plain versions "
        + ", ".join(f"{k}: {v['blocks']} blocks" for k, v in pg.items() if k != "timed")
        + f", the in-process mover's pages equal the source's (bf16 and int8); at 32 layers "
        f"on {DG_TIME_BLOCKS} pages ({t['bytes'] / 2**20:.0f} MiB): gather "
        f"{t['gather_ms']:.4f} ms, scatter {t['scatter_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms (bytes), plain gather {t['gather_plain_ms']:.4f} ms, plain "
        f"scatter {t['scatter_plain_ms']:.4f} ms")
    nw = pg["native_wire"]
    lines.append(
        f"disagg native wire on {smi}: the packed arena gather (gather_layers_packed, 32 "
        f"layers, {DG_TIME_BLOCKS} pages) {t['packed_ms']:.4f} ms against "
        f"{t['packed_plain_ms']:.4f} ms plain, bit-exact with the inline and native fetches "
        f"in process (bf16 and int8); the agent over loopback, {nw['blocks']} blocks of "
        f"{nw['block_bytes'] / 2**20:.0f} MiB from a pinned arena into a pinned buffer: "
        f"one fetch {nw['whole_s'] * 1e3:.2f} ms = {nw['whole_gb_s']:.2f} GB/s, in 8-block "
        f"windows {nw['windows_s'] * 1e3:.2f} ms = {nw['windows_gb_s']:.2f} GB/s; the crc32s "
        f"of the same bytes {nw['crc_s'] * 1e3:.2f} ms = {nw['crc_gb_s']:.2f} GB/s (warm)")
    dr, rs = dg["drain"], dg["restore"]
    lines.append(
        f"disagg drain and restore on {smi}: POST /drain on the device decode worker holding "
        f"{dr['sealed']} sealed blocks: quiesced {dr['quiesced']}, discovery states seen "
        f"{dr['states']}, {dr['checkpoint_blocks']} blocks checkpointed in "
        f"{dr['checkpoint_s']:.3f} s, the drain {dr['seconds']:.3f} s, margin "
        f"{dr['deadline_margin_s']:.2f} s, exited 0 {dr['exit_s']:.1f} s after the notice; "
        f"its successor restored mode={rs['mode']} {rs['blocks']} blocks in "
        f"{rs['windows']} windows ({rs['scatter']} scatter launches) in "
        f"{rs['seconds']:.3f} s, and served the checkpointed prompt with "
        f"{rs['cached_tokens']} tokens cached, stream equal: {rs['equal']} (else the tie "
        f"rule)")
    for tag, name in (("a", "streamed, device (IPC)"), ("b", "sequential, device (IPC)"),
                      ("c", "streamed, native wire"), ("d", "aggregated control")):
        r = dg["runs"][tag]
        s = r["summary"]
        pulls = r["pulls"]
        wire = ", ".join(f"{p['bytes'] / 2**20:.1f} MiB {p['bytes'] / p['seconds'] / 1e9:.2f} "
                         "GB/s" for p in pulls) or "no pull"
        lines.append(f"disagg ({tag}) {name} on {smi}: TTFT median "
                     f"{s['ttft_s_median'] * 1e3:.1f} ms, ITL median "
                     f"{s['itl_s_median'] * 1e3:.2f} ms; pulls: {wire}")
    st = dg["staggered"]["summary"]
    lines.append(f"disagg (a) staggered (the 8-prompt traffic 0.25 s apart, new prompts) on "
                 f"{smi}: TTFT median {st['ttft_s_median'] * 1e3:.1f} ms, ITL median "
                 f"{st['itl_s_median'] * 1e3:.2f} ms, {st['output_tok_s']:.1f} output tok/s; "
                 f"{len(dg['staggered']['pulls'])} device pulls, each whole")
    bw = dg["runs"]["c"]["bandwidth"]
    crc = sum(p["crc_s"] for p in dg["runs"]["c"]["pulls"])
    wire_s = sum(p["seconds"] for p in dg["runs"]["c"]["pulls"])
    lines.append(
        "disagg bandwidth EWMA (decode workers' estimators): device "
        f"{dg['runs']['b']['bandwidth']['device']['bandwidth_bytes_s'] / 1e9:.2f} GB/s, native "
        f"{bw['native']['bandwidth_bytes_s'] / 1e9:.3f} GB/s (the client's crc32s "
        f"{crc:.3f} s of (c)'s {wire_s:.3f} wire seconds); streams (a) = (b) = (c) "
        f"{len(DG_PROMPTS)} of {len(DG_PROMPTS)} ((a) = (c) with their logprobs); (d) equal "
        f"to (a) "
        f"{dg['equal_to_a']['d']}, the rest within the tie rule {dg['tie_gaps']}; the "
        f"{DG_SHORT}-token prompt deflected; a "
        f"{dg['long_pull']['blocks']}-block prompt's first window went out after "
        f"{dg['long_pull']['waits'][0] * 1e3:.1f} ms with "
        f"{dg['long_pull']['committed_at_first_window']} blocks committed; page-copy "
        f"launches: gather {dg['launches']['gather']} (the prefill worker's, and the drained "
        f"worker's checkpoint), scatter {dg['launches']['scatter']} (the decode workers', the "
        f"restore's windows among them); ready {dg['ready_s']:.1f} s, decode "
        f"restart {dg['restart_s']:.1f} s, runs {dg['runs_s']:.1f} s, pages "
        f"{dg['pages_s']:.1f} s")
    return lines


GK_PROMPTS = FE_PROMPTS  # the 8-prompt lengths, 100-6000 tokens
GK_TOKENS = 32           # greedy tokens each
GK_B = "llama3-8b-b"     # worker B's model name: the same weights, its own pipeline
# every process of the phase: the directory on, entries that outlive the phase
GK_ENV = {"DTPU_GLOBAL_KV": "1", "DTPU_GLOBAL_KV_TTL_S": "3600"}
GK_STORE_ENV = {"DTPU_LEASE_TTL_S": "3"}   # a killed G4 store leaves the ring in ~3 s
GK_HOST_GB = "8"         # each worker's G2 (A's holds two prompt sets twice over)
GK_DEAD = (2, 7)         # the prompts of (c), by index
GK_FLEET_BLOCKS = 256    # (d): real 2 MiB llama3-8b bf16 blocks
GK_BLOCK_SHAPE = (32, 2, 16, 8, 128)   # [L, 2, bs, kvh, d]
GK_READ_BLOCKS = 256     # blocks of the G2 read timing
GK_EVAC_PROMPT = 1500    # (e): the evacuated request's prompt (93 full blocks)
GK_EVAC_TOKENS = 128     # its greedy tokens: A's crash lands mid-decode
# the crash's own records in worker A's log, which the phase's ERROR gate
# exempts (any other ERROR record of A still fails it)
GK_CRASH_RECORDS = ("engine loop crashed", "engine unhealthy: deregistering", "Traceback")


def gk_prompt(n: int, seed: int) -> str:
    """``n`` characters of random lowercase words: one byte a letter (the
    other phases' ``fe_prompt`` spells each letter with seven NUL bytes, so
    two of its prompts share a first block one time in a few hundred,
    which the directory's single-holder runs would trip on)."""
    rng = np.random.default_rng(seed)
    text = rng.integers(97, 123, size=n).astype(np.uint8)
    text[rng.integers(2, 9, size=n).cumsum()[:n // 2].clip(max=n - 1)] = 32   # spaces
    return text.tobytes().decode()


def gk_bodies(model: str, seed: int) -> list:
    """The 8-prompt lengths as streamed greedy chat of GK_TOKENS tokens for
    ``model``, with DG_TOP top logprobs a token (the tie rule reads them)."""
    return [("/v1/chat/completions", dict(
        model=model, messages=[{"role": "user", "content": gk_prompt(n, seed + i)}],
        max_tokens=GK_TOKENS, temperature=0.0, ignore_eos=True, stream=True,
        logprobs=True, top_logprobs=DG_TOP, stream_options={"include_usage": True}))
        for i, n in enumerate(GK_PROMPTS)]


def gk_compare(tag: str, run: list, ref: list, bodies: list, divergences: list) -> int:
    """Streams of ``run`` equal to ``ref``'s; the rest go to ``divergences``
    for the tie control (in the drill's form, the body as the workers'
    model's). A stream that restored its prefix from a tier computes only
    its suffix, and one computed whole may differ from it where bf16
    logits tie."""
    equal, div = dg_divergences(tag, run, ref, [(p, dict(b, model=FE_MODEL))
                                                for p, b in bodies])
    divergences.extend(div)
    return equal


async def gk_run(port: int, bodies: list, settle=None) -> list:
    """The bodies through the frontend on ``port``, one at a time: per
    request its stats (TTFT, usage) and tokens. ``settle``: a worker's
    status port whose offloads must reach its tiers before the next
    request (the offload queue sheds what it cannot hold)."""
    out = []
    for i, (path, body) in enumerate(bodies):
        if settle is not None and i:
            await gk_settle(settle)
        t_sub = time.perf_counter()
        status, events = await asyncio.wait_for(http_call(port, "POST", path, body), 120)
        if status != 200:
            raise AssertionError(f"global_kv request {i}: HTTP {status}: {str(events)[:300]}")
        st = fe_stream_stats(t_sub, events, True)
        st["tokens_lp"] = dg_stream_tokens(events)
        if st["tokens"] != GK_TOKENS or len(st["tokens_lp"]) != GK_TOKENS:
            raise AssertionError(f"global_kv request {i}: {st['tokens']} tokens")
        out.append(st)
    return out


def gk_reusable(st: dict) -> int:
    """The tokens a request can take from a cache: its full blocks strictly
    before its last prompt token (what admission reuses)."""
    return (st["usage"]["prompt_tokens"] - 1) // 16 * 16


async def gk_settle(status_port: int) -> dict:
    """A worker's /debug/worker once its offloads have all reached the tiers
    and its directory upkeep has caught up: the offload queue empty and the
    offloaded and published counts unchanged over 0.25 s (the parked
    loop's upkeep runs every 0.5 s: the published count is read twice)."""
    prev = prev2 = None
    for _ in range(480):
        doc = await dg_worker_doc(status_port)
        kv = doc["engine"]["kvbm"]
        cur = (kv["offloaded"], doc.get("global_kv", {}).get("published"))
        if kv["queue_depth"] == 0 and cur == prev and cur == prev2:
            if kv["queue_shed"] or kv["errors"]:
                raise AssertionError(f"a worker's KVBM shed or failed offloads: {kv}")
            return doc
        prev2, prev = prev, cur
        await asyncio.sleep(0.25)
    raise AssertionError(f"a worker's offloads never settled: {doc['engine']['kvbm']}")


async def gk_clear(port: int, model: str, status_port: int) -> None:
    """Empty one model's worker's G1 and G2 (``POST /clear_kv_blocks``) and
    wait until its directory upkeep withdrew every advertisement."""
    status, body = await http_call(port, "POST", "/clear_kv_blocks",
                                   {"model": model, "levels": ["g1", "g2"]})
    if status != 200 or not body["cleared"].get(model):
        raise AssertionError(f"POST /clear_kv_blocks {model}: HTTP {status}: {body}")
    for _ in range(100):
        doc = await dg_worker_doc(status_port)
        if (doc["global_kv"]["published"] == 0 and doc["engine"]["cached_blocks"] == 0
                and doc["engine"]["kvbm"]["host_blocks"] == 0):
            return
        await asyncio.sleep(0.1)
    raise AssertionError(f"{model}'s advertisements outlived its clear: {doc['global_kv']}")


async def gk_plans(port: int, n: int) -> list:
    """The global_kv_plan flight event of each of the frontend's last ``n``
    requests, oldest first (None: no plan event)."""
    status, doc = await http_call(port, "GET", f"/debug/requests?limit={n}")
    if status != 200:
        raise AssertionError(f"/debug/requests: HTTP {status}")
    return [next((e["event"] for e in r["events"] if e["event"]["kind"] == "global_kv_plan"),
                 None) for r in reversed(doc["requests"])]


def gk_g2_read() -> dict:
    """The tier stream's server-side read, timed on this host: per window
    of 8 llama3-8b bf16 blocks, 8 ``get_block`` calls on a G2 host tier,
    the window's ``np.stack``, its bytes and a crc32 a block (what
    ``_handle_tier_stream`` does before the frame goes out). Warm: the
    blocks were just written."""
    import zlib

    from dynamo_tpu_torch.kvbm.pool import KvbmTiers

    rng = np.random.default_rng(11)
    nbytes = int(np.prod(GK_BLOCK_SHAPE)) * 2
    tiers = KvbmTiers(nbytes, host_capacity_bytes=(GK_READ_BLOCKS + 8) * nbytes)
    for h in range(GK_READ_BLOCKS):
        tiers.store(h + 1, rng.integers(0, 1 << 16, GK_BLOCK_SHAPE, dtype=np.uint16))
    t0 = time.perf_counter()
    for w in range(0, GK_READ_BLOCKS, 8):
        blocks = [tiers.get_block(h + 1)[0] for h in range(w, w + 8)]
        arr = np.stack(blocks)
        arr.tobytes()
        [zlib.crc32(np.ascontiguousarray(b).view(np.uint8)) for b in blocks]
    s = (time.perf_counter() - t0) / GK_READ_BLOCKS
    tiers.close()
    return {"s_per_block": s, "blocks": GK_READ_BLOCKS, "block_bytes": nbytes}


def gk_slope(xs: list, ys: list) -> float:
    """The least-squares slope of ys over xs."""
    mx, my = statistics.mean(xs), statistics.mean(ys)
    return (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
            / sum((x - mx) ** 2 for x in xs))


async def gk_fleet(store_addr: str, members: list, s2: "Proc") -> dict:
    """(d): a DistributedBlockPool in this process on the netstore shards
    GK_FLEET_BLOCKS real-size blocks over the two registered G4 stores;
    then the second store is killed and its lease expires."""
    from dynamo_tpu_torch.kvbm.distributed import DistributedBlockPool, HashRing
    from dynamo_tpu_torch.kvbm.remote import RemoteBlockPool
    from dynamo_tpu_torch.runtime.discovery.store import make_store

    store = make_store("tcp", store_addr)
    pool = await DistributedBlockPool(store, "dynamo").start()
    loop = asyncio.get_running_loop()

    def off(fn, *a):
        return loop.run_in_executor(None, fn, *a)

    out = {}
    try:
        for _ in range(200):
            if pool.members() == sorted(members):
                break
            await asyncio.sleep(0.05)
        if pool.members() != sorted(members):
            raise AssertionError(f"the G4 fleet: members {pool.members()}, want {members}")
        ring = HashRing()
        for a in members:
            ring.add(a)
        rng = np.random.default_rng(13)
        hashes = [int(h) for h in rng.integers(1, 2**63, GK_FLEET_BLOCKS, dtype=np.int64)]
        blocks = {h: rng.integers(0, 1 << 16, GK_BLOCK_SHAPE, dtype=np.uint16) for h in hashes}
        t0 = time.perf_counter()
        for h in hashes:
            await off(pool.store, h, blocks[h])
        out["store_s"] = time.perf_counter() - t0
        owners = {h: ring.owner(h) for h in hashes}
        split = {}
        for a in members:
            probe = RemoteBlockPool(a)
            have = await off(probe.contains_many, hashes)
            probe.close()
            mine = [h for h, ok in zip(hashes, have) if ok]
            if sorted(mine) != sorted(h for h in hashes if owners[h] == a):
                raise AssertionError(f"G4 member {a} holds blocks the ring does not name, "
                                     "or lacks some it names")
            split[a] = len(mine)
        if min(split.values()) == 0:
            raise AssertionError(f"a G4 member holds no block: {split}")
        out["split"] = [split[a] for a in members]
        t0 = time.perf_counter()
        got = [await off(pool.get, h) for h in hashes]
        out["get_s"] = time.perf_counter() - t0
        bad = [h for h, g in zip(hashes, got) if g is None or not np.array_equal(g, blocks[h])]
        if bad:
            raise AssertionError(f"{len(bad)} G4 fleet gets not bit-exact")
        # the second member dies: at its lease's expiry its shard misses
        # and the first's still hits, bit for bit
        s2.proc.kill()
        s2.proc.wait()
        t0 = time.perf_counter()
        for _ in range(300):
            if pool.members() == [members[0]]:
                break
            await asyncio.sleep(0.05)
        if pool.members() != [members[0]]:
            raise AssertionError(f"the killed store never left the ring: {pool.members()}")
        out["expiry_s"] = time.perf_counter() - t0
        got = [await off(pool.get, h) for h in hashes]
        lost = [h for h in hashes if owners[h] == members[1]]
        if any(got[i] is not None for i, h in enumerate(hashes) if owners[h] == members[1]):
            raise AssertionError("a dead member's block came back")
        if any(got[i] is None or not np.array_equal(got[i], blocks[h])
               for i, h in enumerate(hashes) if owners[h] == members[0]):
            raise AssertionError("the surviving member's shard did not hit bit for bit")
        out.update(missed=len(lost), hit=len(hashes) - len(lost))
    finally:
        await pool.stop()
        await store.close()
    return out


def entries_tokens(outs: list) -> list:
    """Backend frames' logprob entries as (string, logprob, {top string:
    logprob}), as ``dg_stream_tokens`` reads a stream."""
    return [(e["token"], e["logprob"], {t["token"]: t["logprob"] for t in e["top_logprobs"]})
            for o in outs for e in (o.get("logprob_entries") or [])]


async def gk_evacuation(addr: str, a_status: int, b_status: int) -> dict:
    """(e) evacuation: a GK_EVAC_PROMPT-token chat on worker A cleanly, then
    again through the port's Migration (llm/migration.py) over both
    workers' endpoints, A first; once A's first tokens stream, A's
    ``engine.step`` is armed (``POST /debug/faults``) and its loop dies
    mid-decode. The error frame's evacuation plan becomes the retry's
    ``kv_transfer`` on B, which pulls A's host tier (A serves its transfer
    endpoint until it has been idle) and finishes the request. Returns
    the streams, B's pull and the migration's flight event."""
    from dynamo_tpu_torch.llm.migration import Migration
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.protocols import openai
    from dynamo_tpu_torch.runtime import Context, DistributedRuntime, RuntimeConfig
    from dynamo_tpu_torch.runtime.flight_recorder import get_flight_recorder

    body = dict(model=FE_MODEL, messages=[{"role": "user",
                                           "content": gk_prompt(GK_EVAC_PROMPT, 2300)}],
                max_tokens=GK_EVAC_TOKENS, temperature=0.0, ignore_eos=True, logprobs=True,
                top_logprobs=DG_TOP)
    req = OpenAIPreprocessor(ModelDeploymentCard(name=FE_MODEL, tokenizer="byte",
                                                 context_length=8192)).preprocess_chat(
        openai.ChatCompletionRequest.from_obj(body))
    rt = await DistributedRuntime(RuntimeConfig(store="tcp", store_path=addr,
                                                event_plane="inproc")).start()
    try:
        ns = rt.namespace("dynamo")
        ca = await ns.component("backend").endpoint("generate").client()
        cb = await ns.component("backend_b").endpoint("generate").client()
        await ca.wait_for_instances(1)
        await cb.wait_for_instances(1)
        a_id = int((await dg_worker_doc(a_status))["instance_id"], 16)
        t0 = time.perf_counter()
        clean = [it async for it in await ca.generate(req.to_obj(), Context(), a_id)]
        clean_s = time.perf_counter() - t0
        await gk_settle(a_status)   # the prompt's blocks in A's G2
        doc0 = await dg_worker_doc(b_status)
        armed = []

        class Arming:
            """A's stream as it passes; A's engine.step armed after its
            first tokens."""

            def __init__(self, stream):
                self.stream, self.instance_id = stream, stream.instance_id

            def __aiter__(self):
                return self._items()

            async def _items(self):
                async for item in self.stream:
                    yield item
                    if not armed and item.get("token_ids"):
                        status, _ = await http_call(a_status, "POST", "/debug/faults",
                                                    {"spec": "engine.step:fail@1"})
                        armed.append(status)

        async def send(r, ctx, excluded):
            if a_id not in excluded:
                return Arming(await ca.generate(r.to_obj(), ctx, a_id))
            return await cb.generate(r.to_obj(), ctx)

        req.request_id = "evacuated-" + req.request_id
        t0 = time.perf_counter()
        drill = [o.to_obj() async for o in Migration(send, migration_limit=1).generate(
            req, Context())]
        drill_s = time.perf_counter() - t0
        doc1 = await gk_settle(b_status)
    finally:
        await rt.shutdown()
    if armed != [200]:
        raise AssertionError(f"(e): arming A's engine.step answered {armed}")
    events = [e["event"] for e in get_flight_recorder().timeline(req.request_id)["events"]]
    migration = [e for e in events if e["kind"] == "migration"]
    return {"body": body, "clean": entries_tokens(clean), "drill": entries_tokens(drill),
            "migration": migration, "pulls": dg_new_pulls(doc0, doc1),
            "fallbacks": doc1["transfer"]["fallbacks"]["counts"],
            "clean_s": clean_s, "drill_s": drill_s}


def global_kv_phase(torch, smi: str) -> dict:
    """Phase 16 (module docstring): fleet-wide KV reuse on one card. The
    netstore, two G4 stores of the fleet, worker A (G2 + G4 write-through)
    and worker B (G2), two frontends with the directory on: runs (a)-(d)
    with their gates; returns the phase's numbers and each worker's
    page-copy launches."""
    import tempfile

    procs = []
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    try:
        store = Proc("netstore", "dynamo_tpu_torch.runtime.discovery.netstore",
                     "--host", "127.0.0.1", "--port", "0")
        procs.append(store)
        addr = store.wait_line("KVSTORE_READY", 30).split()[1]
        common = ("--store", "tcp", "--store-path", addr)
        s1 = Proc("G4 store 1", "dynamo_tpu_torch.kvbm", "--host", "127.0.0.1", "--port", "0",
                  "--capacity-gb", "8", *common, env=GK_STORE_ENV)
        s2 = Proc("G4 store 2", "dynamo_tpu_torch.kvbm", "--host", "127.0.0.1", "--port", "0",
                  "--capacity-gb", "1", *common, env=GK_STORE_ENV)
        procs += [s1, s2]
        g4 = [s.wait_line("KVBM_REMOTE_READY", 60).split()[1] for s in (s1, s2)]
        for s, a in zip((s1, s2), g4):
            if s.wait_line("KVBM_FLEET_MEMBER", 5).split()[1] != a:
                raise AssertionError(f"{s.name} registered another address than it serves")
        wa = Proc("worker A", "dynamo_tpu_torch.engine", *common, *FE_WORKER, "--system-port",
                  "0", "--kvbm-host-gb", GK_HOST_GB, "--kvbm-remote", g4[0],
                  env={**GK_ENV, "DTPU_FAULTS_ADMIN": "1"})
        wb = Proc("worker B", "dynamo_tpu_torch.engine", *common, *FE_WORKER, "--model", GK_B,
                  "--component", "backend_b", "--system-port", "0", "--kvbm-host-gb",
                  GK_HOST_GB, env=GK_ENV)
        fd = Proc("global kv frontend", "dynamo_tpu_torch.frontend", *common, "--host",
                  "127.0.0.1", "--port", "0", env=GK_ENV)
        ff = Proc("global kv frontend (fetch)", "dynamo_tpu_torch.frontend", *common, "--host",
                  "127.0.0.1", "--port", "0",
                  env={**GK_ENV, "DTPU_GLOBAL_KV_FETCH_MARGIN": "1e9"})
        procs += [wa, wb, fd, ff]
        # host work while the workers build
        out = {"g2_read": gk_g2_read()}
        port = int(fd.wait_line("TORCH_FRONTEND_READY", 60).rsplit(":", 1)[1])
        fport = int(ff.wait_line("TORCH_FRONTEND_READY", 60).rsplit(":", 1)[1])
        for w in (wa, wb):
            w.wait_line("TORCH_ENGINE_READY")
        a_status = int(wa.wait_line("TORCH_STATUS_ADDRESS").rsplit(":", 1)[1])
        b_status = int(wb.wait_line("TORCH_STATUS_ADDRESS").rsplit(":", 1)[1])
        a_transfer = wa.wait_line("KV_TRANSFER at").split()[-1]
        wb.wait_line("KV_TRANSFER at")

        async def models():
            for p in (port, fport):
                for _ in range(600):
                    status, body = await http_call(p, "GET", "/v1/models")
                    if status == 200 and sorted(m["id"] for m in body["data"]) == sorted(
                            [FE_MODEL, GK_B]):
                        break
                    await asyncio.sleep(0.05)
                else:
                    raise AssertionError(f"/v1/models on :{p} never listed both workers")

        asyncio.run(models())
        divergences, equal = [], {}
        a_holder = f"worker/{int(asyncio.run(dg_worker_doc(a_status))['instance_id'], 16)}"
        out["ready_s"] = time.perf_counter() - t0
        res = {}
        bodies_a = gk_bodies(FE_MODEL, 2100)
        bodies_b = gk_bodies(GK_B, 2100)   # the same prompts, to worker B

        async def run_a1():
            # (a) G4, first half: A serves the prompts, each written through
            # to G2 and G4 and advertised in the directory
            t1 = time.perf_counter()
            first = await gk_run(port, bodies_a, settle=a_status)
            doc = await gk_settle(a_status)
            loop = asyncio.get_running_loop()
            from dynamo_tpu_torch.kvbm.remote import RemoteBlockPool
            from dynamo_tpu_torch.runtime.discovery.store import make_store

            probe = RemoteBlockPool(g4[0])
            st = await loop.run_in_executor(None, probe.stats)
            probe.close()
            kv0 = doc["engine"]["kvbm"]
            if st.get("blocks") != kv0["offloaded"]:
                raise AssertionError(f"G4 holds {st.get('blocks')} blocks, A offloaded "
                                     f"{kv0['offloaded']}")
            # A's advertisements, for (c)
            store_c = make_store("tcp", addr)
            try:
                raw = await store_c.list_prefix("kvdir/")
            finally:
                await store_c.close()
            res["a"] = {"first": first, "kv0": kv0, "g4_blocks": st["blocks"],
                        "published": doc["global_kv"]["published"],
                        "seconds": time.perf_counter() - t1}
            res["entries"] = {k: v for k, v in raw.items() if k.endswith("/" + a_holder)}

        async def run_b():
            # (b) peer tier: the prompts A served, sent to B
            t1 = time.perf_counter()
            on_a = res["a"]["first"]
            doc0 = await dg_worker_doc(b_status)
            dflt = await gk_run(port, bodies_b)
            plans = await gk_plans(port, len(bodies_b))
            doc1 = await gk_settle(b_status)
            pulls_dflt = dg_new_pulls(doc0, doc1)
            if None in plans or any(p["holder"] != a_holder for p in plans):
                raise AssertionError(f"(b): the plans do not all name A: {plans}")
            fetched = [p["fetch_wins"] for p in plans]
            if len(pulls_dflt) != sum(fetched):
                raise AssertionError(f"(b) default priors: {sum(fetched)} fetch verdicts, "
                                     f"{len(pulls_dflt)} pulls")
            cold = dflt
            if any(fetched):
                # the recompute needs a run of its own: B cold, every plan
                # priced to recompute
                fc = Proc("global kv frontend (recompute)", "dynamo_tpu_torch.frontend",
                          *common, "--host", "127.0.0.1", "--port", "0",
                          env={**GK_ENV, "DTPU_GLOBAL_KV_FETCH_MARGIN": "0"})
                procs.append(fc)
                cport = int(fc.wait_line("TORCH_FRONTEND_READY", 60).rsplit(":", 1)[1])
                await gk_clear(port, GK_B, b_status)
                cold = await gk_run(cport, bodies_b)
                await gk_settle(b_status)
            await gk_clear(port, GK_B, b_status)
            doc2 = await dg_worker_doc(b_status)
            fetch = await gk_run(fport, bodies_b)
            doc3 = await gk_settle(b_status)
            pulls = dg_new_pulls(doc2, doc3)
            if len(pulls) != len(bodies_b):
                raise AssertionError(f"(b) fetch: {len(pulls)} pulls for {len(bodies_b)}")
            for i, (p, st) in enumerate(zip(pulls, fetch)):
                if not p["tier"] or p["wire"] != "tier" or p["tokens"] != p["want_tokens"]:
                    raise AssertionError(f"(b) fetch {i}: not a whole tier pull: {p}")
                if p["address"] != a_transfer:
                    raise AssertionError(f"(b) fetch {i}: pulled from {p['address']}, not A")
                if p["want_tokens"] != st["usage"]["prompt_tokens"] // 16 * 16:
                    raise AssertionError(f"(b) fetch {i}: the plan missed full blocks: {p}")
                if st["usage"].get("cached_tokens") != min(p["tokens"], gk_reusable(st)):
                    raise AssertionError(f"(b) fetch {i}: cached {st['usage']}, pulled {p}")
            equal["b_fetch"] = gk_compare("b_fetch", fetch, on_a, bodies_b, divergences)
            equal["b_default"] = gk_compare("b_default", dflt, on_a, bodies_b, divergences)
            if doc3["global_kv"]["inflight_fetches"]:
                raise AssertionError(f"(b): fetch leases open: {doc3['global_kv']}")
            fb = doc3["transfer"]["fallbacks"]["counts"]
            if any(fb.values()):
                raise AssertionError(f"(b): transfer fallbacks {fb}")
            res["b"] = {
                "plans": plans, "prompt_tokens": [st["usage"]["prompt_tokens"] for st in fetch],
                "fetch_ttft_s": [st["ttft_s"] for st in fetch],
                "recompute_ttft_s": [st["ttft_s"] for st in cold],
                "default_ttft_s": [st["ttft_s"] for st in dflt],
                "pulls": pulls, "default_pulls": pulls_dflt,
                "bandwidth": doc3["bandwidth"], "seconds": time.perf_counter() - t1}

        async def run_a2():
            # (a) G4, second half: A's G1 and G2 cleared, the prompts again
            t1 = time.perf_counter()
            first = res["a"]["first"]
            await gk_clear(port, FE_MODEL, a_status)
            again = await gk_run(port, bodies_a)
            doc = await gk_settle(a_status)
            for i, y in enumerate(again):
                if y["usage"].get("cached_tokens") != gk_reusable(y):
                    raise AssertionError(f"(a) repeat {i}: cached {y['usage']}, want "
                                         f"{gk_reusable(y)} from G4")
            equal["a"] = gk_compare("a", again, first, bodies_a, divergences)
            res["a"].update(
                first_ttft_s=[x["ttft_s"] for x in first],
                repeat_ttft_s=[y["ttft_s"] for y in again],
                cached_tokens=[y["usage"]["cached_tokens"] for y in again],
                prompt_tokens=[y["usage"]["prompt_tokens"] for y in again],
                onboarded_blocks=doc["engine"]["kvbm"]["onboarded"]
                - res["a"]["kv0"]["onboarded"],
                onboards=len(again), seconds=res["a"]["seconds"] + time.perf_counter() - t1)

        async def run_c(entries):
            # (c) dead holder: A's advertisements again, at A's gone address
            from dynamo_tpu_torch.runtime.discovery.store import make_store

            t1 = time.perf_counter()
            st = make_store("tcp", addr)
            lease = await st.create_lease(3600.0)
            for k, v in entries.items():
                await st.put(k, v, lease.id)
            await gk_clear(port, GK_B, b_status)
            doc0 = await dg_worker_doc(b_status)
            got = await gk_run(fport, [bodies_b[i] for i in GK_DEAD])
            doc1 = await gk_settle(b_status)
            await st.revoke_lease(lease.id)
            await st.close()
            pulls = dg_new_pulls(doc0, doc1)
            if len(pulls) != len(GK_DEAD) or any(
                    not p["tier"] or p["tokens"] != 0 or p["address"] != a_transfer
                    for p in pulls):
                raise AssertionError(f"(c): the pulls of the dead holder's plans: {pulls}")
            if doc1["global_kv"]["inflight_fetches"]:
                raise AssertionError(f"(c): fetch leases open: {doc1['global_kv']}")
            rc = (doc1["transfer"]["fallbacks"]["counts"]["recompute"]
                  - doc0["transfer"]["fallbacks"]["counts"]["recompute"])
            if rc != len(GK_DEAD):
                raise AssertionError(f"(c): {rc} recomputes counted for {len(GK_DEAD)}")
            equal["c"] = gk_compare("c", got, [res["a"]["first"][i] for i in GK_DEAD],
                                    [bodies_b[i] for i in GK_DEAD], divergences)
            res["c"] = {"ttft_s": [x["ttft_s"] for x in got], "entries": len(entries),
                        "seconds": time.perf_counter() - t1}

        asyncio.run(run_a1())
        if not res["entries"]:
            raise AssertionError("(c): worker A advertised nothing")
        asyncio.run(run_b())
        b = res["b"]
        log(f"global_kv (b) peer tier on {smi}: per prompt (tokens: fetch s / recompute s, "
            "GB/s, windows; default-prior verdict fetch_s/recompute_s priced): " + "; ".join(
                f"{n}: {f:.4f}/{r:.4f} s, {p['bytes'] / p['seconds'] / 1e9:.3f} GB/s, "
                f"{p['windows']} w; {'fetch' if v['fetch_wins'] else 'recompute'} "
                f"{v['fetch_s']:.4f}/{v['recompute_s']:.4f}"
                for n, f, r, p, v in zip(b["prompt_tokens"], b["fetch_ttft_s"],
                                         b["recompute_ttft_s"], b["pulls"], b["plans"]))
            + f"; streams equal to A's: fetched {equal['b_fetch']}, default "
            f"{equal['b_default']} [{b['seconds']:.1f} s]")
        asyncio.run(run_a2())
        log(f"global_kv (a) G4 on {smi}: {len(GK_PROMPTS)} prompts served, A's G1 and G2 "
            f"cleared, served again: every full-block prefix from G4 "
            f"({res['a']['onboarded_blocks']} blocks, {res['a']['g4_blocks']} in the store), "
            f"streams equal to the first run's: {equal['a']} of {len(GK_PROMPTS)} (the rest "
            f"to the tie rule); TTFT first / repeat (ms): " + ", ".join(
                f"{x * 1e3:.1f}/{y * 1e3:.1f}" for x, y in zip(
                    res["a"]["first_ttft_s"], res["a"]["repeat_ttft_s"]))
            + f" [{res['a']['seconds']:.1f} s]")
        # (e) evacuation: A dies mid-decode, its request finishes on B
        # through a tier pull from A's address
        t1 = time.perf_counter()
        n_err = len(wa.errors())
        ev = asyncio.run(gk_evacuation(addr, a_status, b_status))
        if wa.join(60) != 0:
            raise AssertionError(f"worker A exited {wa.proc.returncode} after its crash")
        crash = wa.errors()[n_err:]
        if not crash or not all(any(m in ln for m in GK_CRASH_RECORDS) for ln in crash):
            raise AssertionError(f"(e): worker A's records after the armed fault: {crash}")
        (pull,) = ev["pulls"] or [None]
        if (not ev["migration"] or ev["migration"][0]["evacuated"] is not True
                or pull is None or not pull["tier"] or pull["address"] != a_transfer
                or pull["tokens"] <= 0 or any(ev["fallbacks"].values())):
            raise AssertionError(f"(e): migration {ev['migration']}, B's pulls {ev['pulls']}, "
                                 f"B's fallbacks {ev['fallbacks']}")
        produced = ev["migration"][0]["tokens_so_far"]
        if not 0 < produced < GK_EVAC_TOKENS or len(ev["drill"]) != GK_EVAC_TOKENS:
            raise AssertionError(f"(e): A produced {produced} tokens before its crash, the "
                                 f"stream {len(ev['drill'])} of {GK_EVAC_TOKENS}")
        eq_e, div_e = dg_divergences("evac", [{"tokens_lp": ev["drill"]}],
                                     [{"tokens_lp": ev["clean"]}],
                                     [("/v1/chat/completions", ev["body"])])
        divergences.extend(div_e)
        equal["e"] = eq_e
        res["e"] = {"a_tokens": produced, "pull": pull, "clean_s": ev["clean_s"],
                    "drill_s": ev["drill_s"], "seconds": time.perf_counter() - t1}
        log(f"global_kv (e) evacuation on {smi}: worker A's loop died after {produced} of "
            f"{GK_EVAC_TOKENS} tokens; the Migration's retry pulled "
            f"{pull['tokens'] // 16} blocks of A's host tier on B "
            f"({pull['bytes'] / pull['seconds'] / 1e9:.3f} GB/s, {pull['windows']} windows) "
            f"and finished the request ({ev['drill_s']:.2f} s against {ev['clean_s']:.2f} s "
            f"for A's clean run), stream equal to A's clean one: {eq_e} (else the tie rule) "
            f"[{res['e']['seconds']:.1f} s]")
        exits = {"a": json.loads(wa.wait_line("TORCH_ENGINE_EXIT", 10).split(" ", 1)[1])}
        asyncio.run(run_c(res.pop("entries")))
        log(f"global_kv (c) dead holder on {smi}: {len(GK_DEAD)} plans naming A at its "
            f"gone address ({res['c']['entries']} re-advertised entries) recomputed, leases "
            f"aborted; streams equal to A's: {equal['c']}; TTFT (ms) " + ", ".join(
                f"{x * 1e3:.1f}" for x in res["c"]["ttft_s"])
            + f" [{res['c']['seconds']:.1f} s]")
        for p in (fd, ff) + tuple(p for p in procs if p.name.endswith("(recompute)")):
            if p.stop() != 0:
                raise AssertionError(f"the {p.name} exited {p.proc.returncode}")
        if wb.stop() != 0:
            raise AssertionError(f"worker B exited {wb.proc.returncode}")
        exits["b"] = json.loads(wb.wait_line("TORCH_ENGINE_EXIT", 10).split(" ", 1)[1])
        control = None
        if divergences:
            # the streams that differ, held to the tie rule on the workers'
            # weights (phase 14's tie control) with the card free, while (d)
            # runs on the host
            path = os.path.join(tmp.name, "divergences.json")
            with open(path, "w") as f:
                json.dump(divergences, f)
            control = Proc("tie control", "chip_smoke", "--tie-control", path)
            procs.append(control)
        t1 = time.perf_counter()
        res["d"] = asyncio.run(gk_fleet(addr, g4, s2))
        res["d"]["seconds"] = time.perf_counter() - t1
        d = res["d"]
        log(f"global_kv (d) sharded G4 fleet on {smi}: {GK_FLEET_BLOCKS} blocks of "
            f"{int(np.prod(GK_BLOCK_SHAPE)) * 2 / 2**20:.0f} MiB, split {d['split']} as the "
            f"port's ring names, stored in {d['store_s']:.3f} s, got back bit-exact in "
            f"{d['get_s']:.3f} s; store 2 killed, gone from the ring after "
            f"{d['expiry_s']:.1f} s: {d['missed']} misses, {d['hit']} hits bit-exact "
            f"[{d['seconds']:.1f} s]")
        for p in (s1, store):
            if p.stop() != 0:
                raise AssertionError(f"the {p.name} exited {p.proc.returncode}")
        gaps = []
        if control is not None:
            gaps = json.loads(control.wait_line("TIE_CONTROL").split(" ", 1)[1])
            if control.join() != 0:
                raise AssertionError(f"the tie control exited {control.proc.returncode}")
    finally:
        for p in procs:
            p.stop()
        tmp.cleanup()
    errors = [f"{p.name}: {ln}" for p in procs
              for ln in (p.errors()[:n_err] + p.errors()[n_err + len(crash):] if p is wa
                         else p.errors())]
    if errors:
        raise AssertionError("ERROR records in the global_kv phase's logs:\n"
                             + "\n".join(errors[:20]))
    # the page copies: A's onboards from G4 one scatter each, B's tier
    # windows one scatter each (B onboards nothing from its own tiers)
    ea, eb = exits["a"]["launches"], exits["b"]["launches"]
    if ea["scatter"] != res["a"]["onboards"]:
        raise AssertionError(f"worker A: {ea['scatter']} scatter launches for "
                             f"{res['a']['onboards']} onboards")
    windows = sum(p["windows"] for p in res["b"]["pulls"] + res["b"]["default_pulls"]
                  + [res["e"]["pull"]])
    if eb["scatter"] != windows:
        raise AssertionError(f"worker B: {eb['scatter']} scatter launches for {windows} "
                             "tier windows")
    if ea["gather"] <= 0 or eb["gather"] <= 0:
        raise AssertionError(f"a worker never gathered an offload: {ea} {eb}")
    b = res["b"]
    blocks = [n // 16 for n in b["prompt_tokens"]]
    for k in ("first", "kv0"):
        res["a"].pop(k)
    out.update(res, equal=equal, tie_gaps=gaps)
    prefill = gk_slope([n // 16 for n in res["a"]["prompt_tokens"]], res["a"]["first_ttft_s"])
    planned = gk_slope(blocks, b["recompute_ttft_s"])
    out["priors"] = {
        # the recompute: the TTFT slope over the prompts' blocks of A's cold
        # first run (each plan's lookup ends at the first block: nobody
        # holds it); B's cold run pays the planner's lookups of every block
        # A holds on top
        "prefill_s_per_block": prefill,
        "planned_recompute_s_per_block": planned,
        "lookup_s_per_block": planned - prefill,
        "g2_read_s_per_block": out["g2_read"]["s_per_block"],
        "tier_bytes_s": sum(p["bytes"] for p in b["pulls"])
        / sum(p["seconds"] for p in b["pulls"]),
    }
    out["launches"] = {"gather": ea["gather"] + eb["gather"],
                       "scatter": ea["scatter"] + eb["scatter"], "a": ea, "b": eb}
    out["seconds"] = time.perf_counter() - t0
    return out


def global_kv_summary(gk: dict, smi: str) -> list:
    """The priors measured on the card, and per prompt the planner's verdict
    under the reference's priors and under the measured ones beside what
    the card measured (fetch TTFT against the cold recompute TTFT)."""
    from dynamo_tpu_torch.ops.costs import fetch_vs_recompute

    pr, b = gk["priors"], gk["b"]
    nbytes = gk["g2_read"]["block_bytes"]

    def verdict(n, bw, block_s, read_s):
        return fetch_vs_recompute(n, block_size=16, kv_bytes_per_block=nbytes,
                                  bandwidth_bytes_s=bw, prefill_base_s=0.0,
                                  prefill_per_token_s=block_s / 16, tier="g2",
                                  tier_read_s_per_block=read_s)["fetch_wins"]

    def word(wins):
        return "fetch" if wins else "recompute"

    rows = []
    for p, f, r, v in zip(b["pulls"], b["fetch_ttft_s"], b["recompute_ttft_s"], b["plans"]):
        n = p["tokens"] // 16
        rows.append(f"{n} blocks: fetch {f:.4f} s vs recompute {r:.4f} s "
                    f"({'fetch' if f <= r else 'recompute'} faster); the port's defaults "
                    f"{word(v['fetch_wins'])}, the reference's priors "
                    f"{word(verdict(n, 5e8, 0.010, 2e-4))}, this run's "
                    f"{word(verdict(n, pr['tier_bytes_s'], pr['prefill_s_per_block'], pr['g2_read_s_per_block']))}")
    return [
        f"global_kv priors on {smi}: recompute {pr['prefill_s_per_block'] * 1e3:.4f} ms a "
        f"16-token block (worker A's cold TTFT slope over the 8 prompts' blocks, 2048-token "
        f"chunks; B's cold run, whose plans looked up every block, "
        f"{pr['planned_recompute_s_per_block'] * 1e3:.4f} ms: the lookups "
        f"{pr['lookup_s_per_block'] * 1e3:.4f} ms a block), G2 read "
        f"{pr['g2_read_s_per_block'] * 1e3:.4f} ms a block (get_block, stack, bytes and "
        f"crc32 of 8-block windows of {nbytes / 2**20:.0f} MiB, warm), tier wire "
        f"{pr['tier_bytes_s'] / 1e9:.4f} GB/s ((b)'s pulls)",
        "global_kv verdicts on " + smi + ": " + "; ".join(rows),
        f"global_kv phase on {smi}: ready {gk['ready_s']:.1f} s, (a) {gk['a']['seconds']:.1f} "
        f"s, (b) {b['seconds']:.1f} s, (c) {gk['c']['seconds']:.1f} s, (d) "
        f"{gk['d']['seconds']:.1f} s; streams equal to their reference run's "
        f"{gk['equal']} (each of 8, (c) of {len(GK_DEAD)}), the rest within the tie rule "
        f"{gk['tie_gaps']}; page-copy launches: gather {gk['launches']['gather']}, "
        f"scatter {gk['launches']['scatter']} (A: {gk['launches']['a']['scatter']} G4 "
        f"onboards, B: {gk['launches']['b']['scatter']} tier windows)",
    ]


# ---------------------------------------------------------------- phase 17
TP_MODEL = "llama3-8b"
TP_LAYERS = 8                    # of llama3-8b's 32: the phase's time budget
TP_SHAPE = (16, 4, 128)          # one rank's heads at tp = 2 (32 / 2 over 8 / 2)
TP_PROMPTS = (300, 2600, 700, 1200)   # greedy; 2600 past the 2048-token chunk
TP_SAMPLED = (500, dict(temperature=0.8, top_p=0.95, seed=7))
TP_TOKENS = 32
TP_WORKER = ("--preset", TP_MODEL, "--num-layers", str(TP_LAYERS), "--tp", "2",
             "--max-context", "4096", "--num-blocks", "1024", "--max-batch-size", "8",
             "--decode-steps", "8", "--decode-pipeline", "1", "--seed", "0",
             "--kv-dtype", "model")
TP_KERNELS = ("decode", "flash_extend", "unified")


def tp_requests(tag: str) -> tuple:
    """The phase's greedy and sampled requests (top-5 logprobs each) and
    their prompts."""
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 128000, size=n).tolist() for n in TP_PROMPTS]
    n, samp = TP_SAMPLED
    prompts.append(rng.integers(0, 128000, size=n).tolist())
    reqs = [preq(f"{tag}{i}", p, TP_TOKENS, logprobs=5) for i, p in enumerate(prompts[:-1])]
    reqs.append(preq(f"{tag}s", prompts[-1], TP_TOKENS, logprobs=5, **dict(samp)))
    return reqs, prompts


def tp_serve(engine, tag: str) -> dict:
    reqs, prompts = tp_requests(tag)
    stats, wall = asyncio.run(run_requests(engine, reqs))
    for s in stats:
        if s["finish"] != "length" or len(s["tokens"]) != TP_TOKENS:
            raise AssertionError(f"tp {tag}: request {s['i']} ended {s['finish']} after "
                                 f"{len(s['tokens'])} tokens")
    return {"requests": stats, "prompts": prompts, **latency_summary(stats, wall)}


def tp_phase(torch, gen, smi: str, timer) -> tuple:
    """Tensor parallelism at tp = 2 on one card (module docstring, phase 17)."""
    from dynamo_tpu_torch.engine.__main__ import (FOLLOWER_EXIT, build_worker_engine,
                                                  join_tp_group, parse_args)
    from dynamo_tpu_torch.run import build_engine
    from dynamo_tpu_torch.runtime.multihost import reap

    results = {}
    for check in (check_decode, check_flash, check_unified):
        kw = dict(case_names=("check batch",), fill=()) if check is check_decode else {}
        r = check(torch, gen, timer, shape=TP_SHAPE, tag="_tp2", **kw)
        results[r["name"]] = r
        log(f"kernel {r['name']} at one rank's heads {TP_SHAPE}: max abs err "
            f"{r['max_abs_err']:.3g}; {r['ms']:.4f} ms kernel, {r['plain_ms']:.4f} ms plain, "
            f"{r['library_ms']:.4f} ms library, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    gc.collect()
    torch.cuda.empty_cache()
    out: dict = {"card": smi, "layers": TP_LAYERS}
    t0 = time.perf_counter()
    argv = list(TP_WORKER)
    args = parse_args(argv)
    # the follower's output (its exit report) to a file of its own
    with tempfile.NamedTemporaryFile("w", prefix="tp_follower_", suffix=".log",
                                     delete=False) as flog:
        log_path = flog.name
        mh, followers = join_tp_group(args, argv, stdout=flog)
    try:
        out["backend"] = mh.comm.backend
        log(f"tp group: backend {mh.comm.backend} on {args.device} (host-staged "
            f"{mh.comm.host_staged}), follower pid {followers[0].pid} "
            f"[{time.perf_counter() - t0:.1f} s]")
        if mh.comm.backend != "gloo" or (args.device.startswith("cuda")
                                         and not mh.comm.host_staged):
            raise AssertionError(f"tp: two ranks on one card must share it through gloo on "
                                 f"CUDA tensors, got {mh.comm.backend}")
        engine, _ = build_worker_engine(args, mh)
        if (engine.mcfg.num_heads, engine.mcfg.num_kv_heads, engine.mcfg.head_dim) != TP_SHAPE:
            raise AssertionError(f"tp: a rank's heads are {engine.mcfg}, not {TP_SHAPE}")
        if engine._horizon.capture:
            raise AssertionError("tp: the shared card's horizons must run eagerly")
        log(f"tp engine built [{time.perf_counter() - t0:.1f} s]")
        reset_launches()
        mh.comm.reset_counts()
        run = tp_serve(engine, "tp2-")
        launches = read_launches()
        counts = dict(mh.comm.counts)
        steps = dict(engine.step_counts)
        out["collectives"] = counts
        out["steps"] = steps
        out["launches"] = {k: launches[k] for k in TP_KERNELS}
        out["probe"] = engine.probe_collectives()
        engine.stop()
        codes = reap(followers, 60.0)
        digest = engine.sampled_digest()
    finally:
        for p in followers:
            if p.poll() is None:
                p.kill()
        mh.close()
        mh.shutdown()
    with open(log_path) as f:
        exits = [json.loads(line.split(" ", 1)[1]) for line in f
                 if line.startswith(FOLLOWER_EXIT)]
    if codes != [0] or len(exits) != 1:
        raise AssertionError(f"tp: the follower exited {codes} with {len(exits)} exit reports "
                             f"(its log: {log_path})")
    os.remove(log_path)
    follower = exits[0]
    out["follower"] = {"launches": {k: follower["launches"][k] for k in TP_KERNELS},
                       "steps": follower["steps"], "collectives": follower["collectives"]}
    if follower["sampled"] != digest:
        raise AssertionError(f"tp: the follower sampled {follower['sampled']}, the leader "
                             f"{digest}")
    out["sampled_digest"] = digest
    for k in TP_KERNELS:
        if not launches[k] or follower["launches"][k] != launches[k]:
            raise AssertionError(f"tp: kernel {k} launched {launches[k]} times on the leader "
                                 f"and {follower['launches'][k]} on the follower")
    if not (steps["prefill"] and steps["mixed"] and steps["horizon"]):
        raise AssertionError(f"tp: the run missed a step kind: {steps}")
    if follower["steps"] != steps:
        raise AssertionError(f"tp: the follower ran {follower['steps']}, the leader {steps}")
    per_pass = 2 * TP_LAYERS * counts["forwards"]
    if counts["all_reduce"] != per_pass or counts["forwards"] == 0:
        raise AssertionError(f"tp: {counts['all_reduce']} all-reduces over "
                             f"{counts['forwards']} forward passes, not 2 x {TP_LAYERS} each")
    if follower["collectives"]["forwards"] != counts["forwards"]:
        raise AssertionError(f"tp: the follower ran {follower['collectives']} collectives, "
                             f"the leader {counts}")
    gc.collect()
    torch.cuda.empty_cache()
    # the twin: tp = 1 on the same weights and depth (the seed's draws of
    # the same model), eager horizons too
    twin = build_engine(TP_MODEL, args.device, args.max_context, args.seed, kv_dtype="model",
                        decode_steps=8, decode_pipeline=1, num_blocks=args.num_blocks,
                        max_batch_size=args.max_batch_size, num_layers=TP_LAYERS,
                        prefill_chunk=args.prefill_chunk, cuda_graphs=False)
    plain = tp_serve(twin, "tp1-")
    greedy = len(TP_PROMPTS)
    cut = lambda r: {**r, "requests": r["requests"][:greedy]}  # noqa: E731
    out["tie_gaps"] = tie_rule(torch, "tp2 vs tp1", cut(run), cut(plain),
                               plain["prompts"][:greedy], twin.params, twin.mcfg)
    out["equal_streams"] = sum(a["tokens"] == b["tokens"]
                               for a, b in zip(run["requests"], plain["requests"]))
    twin.stop()
    for tag, r in (("tp2", run), ("tp1", plain)):
        out[tag] = {k: r[k] for k in ("wall_s", "output_tok_s", "ttft_s_median", "ttft_s_max",
                                      "itl_s_median", "itl_s_max")}
    out["seconds"] = time.perf_counter() - t0
    log(f"tp on {smi}: backend gloo on CUDA tensors (two ranks on one card); tp=2 TTFT median "
        f"{run['ttft_s_median'] * 1e3:.0f} ms, ITL median {run['itl_s_median'] * 1e3:.1f} ms; "
        f"tp=1 TTFT median {plain['ttft_s_median'] * 1e3:.0f} ms, ITL median "
        f"{plain['itl_s_median'] * 1e3:.1f} ms (the shared card's, not TP's); one [8, 4096] "
        f"bf16 all-reduce {out['probe']['all_reduce_s'] * 1e3:.3f} ms, one logits gather "
        f"{out['probe']['logits_gather_s'] * 1e3:.3f} ms; {counts['all_reduce']} all-reduces "
        f"over {counts['forwards']} forward passes; launches per rank {out['launches']}; "
        f"streams equal to tp=1: {out['equal_streams']} of {len(TP_PROMPTS) + 1}, the rest "
        f"within the tie rule {out['tie_gaps']}")
    return results, out


PHASES = ("kernels", "model", "serve", "horizon", "gptoss", "moe_mla", "vision", "spec",
          "checkpoint", "features", "shapes", "frontend", "kv_router", "disagg", "global_kv",
          "tp")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of " + ",".join(PHASES) + " (environment and build "
                         "always run; the report needs them all)")
    ap.add_argument("--fe-control", metavar="FILE",
                    help="the frontend phase's in-process control, run by that phase "
                         "in a process of its own")
    ap.add_argument("--tie-control", metavar="FILE",
                    help="the kv_router phase's tie-rule check of its fault drill's "
                         "divergences, run by that phase in a process of its own")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from dynamo_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the dynamo_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    if args.fe_control:
        return fe_control(args.fe_control)
    if args.tie_control:
        return tie_control(args.tie_control)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment + build
    smi = nvidia_smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    out_dir = _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s -> {out_dir}")
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".log"):
            with open(os.path.join(out_dir, name)) as f:
                log(f"  {name[:-4]}: " + " | ".join(ptxas_summary(f.read())))
    tensor_core_instructions(out_dir)
    log("unified kernel, blocks per SM by the occupancy calculator (dynamic shared memory): "
        + ", ".join(f"d={d} {'int8' if i8 else 'bf16'} {b} ({smem} B)"
                    for d, i8, b, smem in unified_occupancy(_build)))

    results = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(torch)
    flex = None
    if phases & {"kernels", "gptoss"}:
        from torch.nn.attention.flex_attention import flex_attention

        # the yardstick of the softcap and gpt-oss sink cases: one compile
        # per case and form
        torch._dynamo.config.recompile_limit = 64
        flex = torch.compile(flex_attention, fullgraph=True)
    t_start = time.perf_counter()
    if "kernels" in phases:
        for check, int8 in ((check_decode, False), (check_flash, False),
                            (check_unified, False), (check_decode, True),
                            (check_flash, True), (check_unified, True)):
            t0 = time.perf_counter()
            r = check(torch, gen, timer, int8=int8)
            results[r["name"]] = r
            log(f"kernel {r['name']}: max abs err {r['max_abs_err']:.3g} "
                f"(atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}, row {KERNEL_ROW_REL}); "
                f"{r['ms']:.4f} ms kernel, "
                f"{r['plain_ms']:.4f} ms plain, {r['library_ms']:.4f} ms library, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
                f"[{time.perf_counter() - t0:.1f} s]")
        for int8 in (False, True):
            t0 = time.perf_counter()
            r = check_unified_attrs(torch, gen, timer, GEMMA, int8=int8, flex=flex)
            results[r["name"]] = r
            log(f"kernel {r['name']}: max abs err {r['max_abs_err']:.3g} over "
                f"{len(r['cases'])} cases (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}, row "
                f"{KERNEL_ROW_REL}) [{time.perf_counter() - t0:.1f} s]")
        r = check_merge(torch, gen, timer, GEMMA)
        results[r["name"]] = r
        log(f"kernel {r['name']}: max abs err {r['max_abs_err']:.3g} (atol {KERNEL_ATOL}, "
            f"rtol {KERNEL_RTOL}, row {KERNEL_ROW_REL}); {r['ms']:.4f} ms kernel, "
            f"{r['plain_ms']:.4f} ms plain, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
            "the sink counted once per split moves the split rows by "
            f"{r['sink_per_split_row_gap'][0]:.3g}-{r['sink_per_split_row_gap'][1]:.3g} "
            "(relative L2) and fails the compare")
        worst = max(check_group_sizes(torch, gen).values())
        log(f"kernels at 1, 2 and 8 query heads per kv head, bf16 and int8: max abs "
            f"err {worst:.3g} (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}, row {KERNEL_ROW_REL})")
        t0 = time.perf_counter()
        for r in check_block_copy(torch, gen, timer):
            results[r["name"]] = r
            log(f"kernel {r['name']}: bit-exact at M={list(COPY_MS)}; {r['ms']:.4f} ms "
                f"kernel, {r['plain_ms']:.4f} ms plain, {r['library_ms']:.4f} ms library "
                f"({r['library']}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"bf16 pages {r['bf16_ms']:.4f} ms")
        for r in check_layer_moves(torch, gen, timer):
            results[r["name"]] = r
        log(f"block copy checks [{time.perf_counter() - t0:.1f} s]")
        writes = time_kv_writes(torch, gen, timer)
        log(f"decode KV write of one layer, 8 rows (plain PyTorch): "
            f"{writes['bf16_ms']:.4f} ms bf16, {writes['int8_ms']:.4f} ms int8")
    del timer
    torch.cuda.empty_cache()
    log(f"kernels phase [{time.perf_counter() - t_start:.1f} s]")
    t_phase = time.perf_counter()
    if "model" in phases:
        from dynamo_tpu_torch.models.llama import LlamaConfig

        for int8 in (False, True):
            t0 = time.perf_counter()
            cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=2)
            worst, mutants, spread = model_check(
                torch, "model int8" if int8 else "model", cfg, 300, 100,
                [(None, MODEL_MUTANTS)], lambda t, _: attention_paths(torch, t, int8), int8)
            log(f"model{' int8' if int8 else ''}: 2-layer llama3-8b width, prefill 300 + "
                f"3 decode + a 2-token ragged step, {len(MODEL_SEEDS)} seeds: kernels vs "
                f"plain logits relative L2 {worst:.4g} at worst (limit {MODEL_REL_TOL}); "
                "mutants at least "
                + ", ".join(f"{n[8:]} {r:.4g}" for n, r in mutants.items())
                + f"; max |logit| {spread:.3g} [{time.perf_counter() - t0:.1f} s]")
        for preset, layers, prompt_len in GEMMA_MODEL_CHECKS:
            t0 = time.perf_counter()
            worst, mutants, spread = gemma_model_check(torch, preset, layers, prompt_len)
            log(f"model {preset}: {layers} layers at full width, prefill {prompt_len} + 3 "
                f"decode + a 2-token ragged step, {len(MODEL_SEEDS)} seeds: kernels vs plain "
                f"logits relative L2 {worst:.4g} at worst (limit {MODEL_REL_TOL}); mutants "
                "at least " + ", ".join(f"{n[8:]} {r:.4g}" for n, r in mutants.items())
                + f"; max |logit| {spread:.3g} [{time.perf_counter() - t0:.1f} s]")
            gc.collect()
            torch.cuda.empty_cache()
    log(f"model phase [{time.perf_counter() - t_phase:.1f} s]")
    t_phase = time.perf_counter()
    serving = None
    if "serve" in phases:
        serving = asyncio.run(serve(torch))
        log("serving: " + json.dumps(serving))
        log(f"serving on {smi}: {serving['requests']} requests, "
            f"{serving['output_tok_s']:.1f} output tok/s, TTFT median "
            f"{serving['ttft_s_median'] * 1e3:.0f} ms, ITL median "
            f"{serving['itl_s_median'] * 1e3:.1f} ms")
        gc.collect()
        torch.cuda.empty_cache()
        prep_check(torch, smi)
        gc.collect()
        torch.cuda.empty_cache()
        # the int8 KV cache with KVBM offload and onboard
        kvbm_run = asyncio.run(serve_kvbm(torch))
        log("serving int8+kvbm: " + json.dumps(kvbm_run))
        log(f"serving int8+kvbm on {smi}: {kvbm_run['requests']} requests, "
            f"{kvbm_run['output_tok_s']:.1f} output tok/s, TTFT median "
            f"{kvbm_run['ttft_s_median'] * 1e3:.0f} ms, ITL median "
            f"{kvbm_run['itl_s_median'] * 1e3:.1f} ms; {kvbm_run['kvbm']['offloaded']} "
            f"blocks offloaded, {kvbm_run['kvbm']['onboarded']} onboarded; repeats "
            f"streaming their first run's greedy tokens: "
            f"{kvbm_run['repeats_streaming_the_same_greedy_tokens']} (a finding, not "
            f"a gate); float run: {serving['output_tok_s']:.1f} tok/s, TTFT median "
            f"{serving['ttft_s_median'] * 1e3:.0f} ms, ITL median "
            f"{serving['itl_s_median'] * 1e3:.1f} ms")
        gc.collect()
        torch.cuda.empty_cache()
        # Gemma: every attention call through the unified kernel, windows
        # and softcap per layer; bf16, then a short int8 run
        gemma_runs = {}
        for int8 in (False, True):
            run = asyncio.run(serve_gemma(torch, int8=int8, split_rows=True))
            gemma_runs["int8" if int8 else "bf16"] = run
            tag = "gemma int8" if int8 else "gemma"
            log(f"serving {tag}: " + json.dumps(run))
            log(f"serving {tag} on {smi}: {run['requests']} requests, "
                f"{run['output_tok_s']:.1f} output tok/s, TTFT median "
                f"{run['ttft_s_median'] * 1e3:.0f} ms (max {run['ttft_s_max'] * 1e3:.0f}), "
                f"ITL median {run['itl_s_median'] * 1e3:.1f} ms; unified launches "
                f"{run['launches']['unified_int8' if int8 else 'unified']}, windowed "
                f"{run['launches']['unified_windowed']}, {run['launches_with_split_rows']} of "
                f"them split rows ({run['split_rows']} rows split, by the kernel's count); "
                f"steps {run['steps']}")
            gc.collect()
            torch.cuda.empty_cache()
    log(f"serve phase [{time.perf_counter() - t_phase:.1f} s]")
    if "horizon" in phases:
        t0 = time.perf_counter()
        hz = horizon_phase(torch, smi)
        log("horizon: " + json.dumps(hz))
        log(f"horizon phase [{time.perf_counter() - t0:.1f} s]")
        gc.collect()
        torch.cuda.empty_cache()
    if "gptoss" in phases:
        t0 = time.perf_counter()
        gptoss_results, gpt = gptoss_phase(torch, gen, smi, flex)
        results.update(gptoss_results)
        log("gptoss: " + json.dumps({k: v for k, v in gpt.items() if k != "serving"}))
        log(f"gptoss phase [{time.perf_counter() - t0:.1f} s]")
        gc.collect()
        torch.cuda.empty_cache()
    if "moe_mla" in phases:
        t0 = time.perf_counter()
        latent_results, lat = moe_mla_phase(torch, gen, smi, _build)
        results.update(latent_results)
        log("moe_mla: " + json.dumps({k: v for k, v in lat.items()
                                      if k not in ("serving", "qwen_serving")}))
        log(f"moe_mla phase [{time.perf_counter() - t0:.1f} s]")
        gc.collect()
        torch.cuda.empty_cache()
    if "vision" in phases:
        t0 = time.perf_counter()
        vis = vision_phase(torch, smi, Timer(torch))
        log("vision: " + json.dumps(vis))
        log(f"vision phase [{time.perf_counter() - t0:.1f} s]")
        gc.collect()
        torch.cuda.empty_cache()
    if "spec" in phases:
        t0 = time.perf_counter()
        spec_results, spec = spec_phase(torch, gen, smi, Timer(torch))
        results.update(spec_results)
        log("spec: " + json.dumps(spec))
        log(f"spec phase [{time.perf_counter() - t0:.1f} s]")
        gc.collect()
        torch.cuda.empty_cache()
    if "checkpoint" in phases:
        t0 = time.perf_counter()
        ckpt = checkpoint_phase(torch, smi)
        log("checkpoint: " + json.dumps(ckpt))
        log(f"checkpoint phase [{time.perf_counter() - t0:.1f} s] (qwen3 "
            f"{ckpt['qwen3']['seconds']:.1f} s, gpt-oss {ckpt['gptoss']['seconds']:.1f} s)")
        gc.collect()
        torch.cuda.empty_cache()
    if "features" in phases:
        t0 = time.perf_counter()
        feat = features_phase(torch, smi)
        log("features: " + json.dumps(feat))
        log(features_summary(feat, smi))
        log(f"features phase [{time.perf_counter() - t0:.1f} s]")
        gc.collect()
        torch.cuda.empty_cache()
    if "shapes" in phases:
        t0 = time.perf_counter()
        shape_results, shp = shapes_phase(torch, gen, smi, Timer(torch))
        results.update(shape_results)
        log("shapes: " + json.dumps(shp))
        log(f"shapes phase [{time.perf_counter() - t0:.1f} s]")
        gc.collect()
        torch.cuda.empty_cache()
    fe = None
    if "frontend" in phases:
        t0 = time.perf_counter()
        fe = frontend_phase(torch, smi, serving)
        log("frontend: " + json.dumps({k: v for k, v in fe.items()}))
        log(f"frontend phase [{time.perf_counter() - t0:.1f} s]")
    if "kv_router" in phases:
        t0 = time.perf_counter()
        kvr = kv_router_phase(torch, smi, fe)
        log("kv_router: " + json.dumps(kvr))
        log(f"kv_router phase [{time.perf_counter() - t0:.1f} s]")
    dg = None
    if "disagg" in phases:
        t0 = time.perf_counter()
        dg = disagg_phase(torch, smi)
        log("disagg: " + json.dumps(dg))
        for line in disagg_summary(dg, smi):
            log(line)
        log(f"disagg phase [{time.perf_counter() - t0:.1f} s]")
    gk = None
    if "global_kv" in phases:
        t0 = time.perf_counter()
        gk = global_kv_phase(torch, smi)
        log("global_kv: " + json.dumps(gk))
        for line in global_kv_summary(gk, smi):
            log(line)
        log(f"global_kv phase [{time.perf_counter() - t0:.1f} s]")
    tp = None
    if "tp" in phases:
        t0 = time.perf_counter()
        tp_results, tp = tp_phase(torch, gen, smi, Timer(torch))
        results.update(tp_results)
        log("tp: " + json.dumps(tp))
        log(f"tp phase [{time.perf_counter() - t0:.1f} s]")
        gc.collect()
        torch.cuda.empty_cache()
    log(f"all phases [{time.perf_counter() - t_start:.1f} s]")
    if phases != set(PHASES):
        log("partial run (--phases): no report")
        return 1
    # launches: each kernel's count from the serving run of its path (the
    # float run for the float kernels, the int8 + KVBM run for the rest,
    # the Gemma run for the merge; the gpt-oss runs for the d = 64 forms,
    # which share the unified kernel's and the merge's counters with the
    # other head dims: each run counts only its own; the DeepSeek-V2-Lite
    # serving run for the latent kernel; the verify rows' launches, set by
    # spec_phase, are the unified kernel's in the perfect-draft spec runs,
    # bf16 and int8). The page-copy kernel counts its
    # launches by move: while serving, every gather and scatter is the
    # engine's layer-batched one (gather_layers / scatter_layers), so the
    # gather rows (gather_blocks, gather_layers) show the same count, and
    # the scatter rows too; no engine path copies pages, as in the reference
    kernels = []
    # the disagg phase's page copies are the same kernel's layer-batched
    # moves: its prefill worker's gathers and its decode workers' scatters
    # are added to the gather_layers / scatter_layers rows,
    # and so are the global_kv phase's: its workers' offload gathers, worker
    # A's G4 onboards and worker B's tier windows
    extra = {"gather_layers": dg["launches"]["gather"] + gk["launches"]["gather"],
             "scatter_layers": dg["launches"]["scatter"] + gk["launches"]["scatter"]}
    for name, key, run in (
            ("paged_decode_attention", "decode", serving),
            ("flash_extend_attention", "flash_extend", serving),
            ("ragged_paged_attention", "unified", serving),
            ("paged_decode_attention_int8", "decode_int8", kvbm_run),
            ("flash_extend_attention_int8", "flash_extend_int8", kvbm_run),
            ("ragged_paged_attention_int8", "unified_int8", kvbm_run),
            ("gather_blocks", "gather", kvbm_run),
            ("scatter_blocks", "scatter", kvbm_run),
            ("copy_blocks", "copy", kvbm_run),
            ("gather_layers", "gather", kvbm_run),
            ("scatter_layers", "scatter", kvbm_run),
            ("ragged_paged_attention_gemma", "unified", gemma_runs["bf16"]),
            ("ragged_paged_attention_gemma_int8", "unified_int8", gemma_runs["int8"]),
            ("merge_attention_partials", "merge", gemma_runs["bf16"]),
            ("ragged_paged_attention_gptoss", "unified", gpt["serving"]["bf16"]),
            ("ragged_paged_attention_gptoss_int8", "unified_int8", gpt["serving"]["int8"]),
            ("merge_attention_partials_gptoss", "merge", gpt["serving"]["bf16"]),
            ("latent_paged_attention", "latent_narrow", lat["serving"]["bf16"]),
            ("latent_paged_attention_wide", "latent_wide", lat["serving"]["bf16"])):
        r = dict(results[name], launches=run["launches"][key] + extra.get(name, 0))
        r["max_err"], r["kernel_ms"] = r["max_abs_err"], r["ms"]
        kernels.append(r)
    # the verify rows (launches set by spec_phase) and the Qwen2.5-7B and
    # Llama-3.2-1B rows (launches set by shapes_phase from their serving runs)
    shape_rows = [k + tag + sfx for _, _, tag, _ in SHAPE_MODELS for sfx in ("", "_int8")
                  for k in ("paged_decode_attention", "flash_extend_attention",
                            "ragged_paged_attention")]
    for name in ["ragged_paged_attention_verify", "ragged_paged_attention_verify_int8",
                 *shape_rows]:
        r = dict(results[name])
        r["max_err"], r["kernel_ms"] = r["max_abs_err"], r["ms"]
        kernels.append(r)
    # the tp = 2 rows: one rank's heads; launches are the leader's in the
    # phase's run (the follower's equal them, a gate of the phase)
    for name, key in (("paged_decode_attention_tp2", "decode"),
                      ("flash_extend_attention_tp2", "flash_extend"),
                      ("ragged_paged_attention_tp2", "unified")):
        r = dict(results[name], launches=tp["launches"][key])
        r["max_err"], r["kernel_ms"] = r["max_abs_err"], r["ms"]
        kernels.append(r)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
