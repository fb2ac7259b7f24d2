#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA,
     and whether pyarrow and pandas import (the reference's Data rests on
     pyarrow; printed, not gated).
  2. build: compiles the CUDA kernels from ray_tpu_torch/ops/csrc (one nvcc
     per source, in parallel) into ray_tpu_torch/ops/_build_out, every
     template instance (K1, K3 and K2 at head dims 64, 128 and 256; K4 per
     group) in the same build, and prints each instance's ptxas registers
     and spill bytes (a source already built by an earlier run of the same
     checkout is not compiled again and has no report).
  3. K1 (flash forward) against its plain version, mha_reference in fp32
     on the same bf16 inputs, at B in {1, 8}, S in {512, 1000, 2048}, H 16,
     KV 4, D 64, causal and not, with a pad segment, plus MQA (H 8, KV 1),
     three packed segments per row, S 64 and S 33: max |o - o_ref| <= 2e-2
     (bf16 output, ulp 2^-8 relative) and max |lse - lse_ref| <= 1e-3; two
     launches on the same inputs must be bitwise equal. Timed at the
     engine's prefill shape (one group of 8 prompts of 512 tokens) and at
     the training shape (B 16, S 2048, causal), with TFLOP/s and the time
     over its bound, and held against its plain version at both, on the
     timed inputs, with the same bounds. Every kernel's `ms` (and SDPA's forward) is its device
     time from a CUDA graph of back-to-back calls (device_ms); `eager_ms`
     (K1 at the prefill shape, K4) is the eager back-to-back time, which at
     those shapes is the wrapper's host time.
  4. K4 (paged decode) against paged_attention_reference in fp32 on the same
     bf16 inputs: B 32, ragged lengths in 1..2048 plus one length-0 row,
     ps 128, 16 pages per sequence; then page sizes 16, 64 and 128 x groups
     1, 2, 4 and 8 x B 1 (one sequence over most of a 2048-token table: the
     split's case) and B 32 (lengths 0, 1, two pages exactly, the full
     table, the rest random): max |o - o_ref| <= 2e-2, length-0 rows zero.
     Two launches must be bitwise equal, and a call at another batch size
     in between must agree with its plain version (the ticket counters were
     reset). Timed at the engine's decode shape (32 sequences of 513..576
     tokens).
  5. K3 (backward dQ) and K2 (backward dK, dV) against flash_bwd_reference
     in fp32 on the same bf16 inputs (O and LSE from K1), at B in {1, 4},
     S in {512, 1000, 2048}, H 16, KV 4, D 64, causal and not, with a pad
     segment: max |g - g_ref| <= 2e-2 * max |g_ref| + 2e-2 for each of dq,
     dk, dv (bf16 outputs; P and dS are rounded to bf16 before their
     products, as in the TPU kernels, and each output sums up to S * group
     such terms). The same check at MQA (B 2, S 1000, H 8, KV 1), with
     three packed segments per row (B 2, S 2048), at S 64 (one tile) and
     S 33 (H 8, KV 2), then two launches of each kernel on the same inputs
     must be bitwise equal (no atomics). Each timed alone at the training
     shape (TFLOP/s reached, times its bound), beside the plain backward
     and, as the library yardstick for K2 + K3 together, the backward of
     scaled_dot_product_attention (one call: dq, dk and dv).
  5b. K5, splash onto K1-K3: K1, K3 and K2 on splash's inputs (q folded
     with the softmax scale in fp32, scale 1.0) against the plain versions
     on the same inputs (B 2, S 2048, packed segments; the tolerances of
     phases 3 and 5), then timed at the training shape beside the plain
     forward + backward and SDPA's forward + backward.
  6. the engine end to end: the 250M-parameter GQA model (vocab 32000,
     d_model 1024, 12 layers, 16 heads, 4 KV heads, d_ff 4096, max_seq 2048)
     with seeded random weights, paged KV (page 128, 32 slots); warmup, then
     32 greedy requests of 512 prompt tokens and 64 new tokens. Both kernel
     launch counts are read across this run and must be > 0. The engine's
     prefill logits for all 32 prompts are held against the plain forward on
     the card (attention_impl="reference": einsum attention, no kernel):
     max |diff| <= 0.25 and mean |diff| <= 0.02 (bf16 logits of magnitude up
     to ~6, ulp 0.03, after 12 layers), and every request's first token must
     be within that tolerance of the plain top-1 logit. Then a short
     dense-layout run (4 requests), which runs K1 and not K4.
  6b. the prefix cache and chunked prefill on phase 6's model (full width
     and depth, page 128, 32 slots, prefix_cache on, chunked_prefill 512,
     warmup first). (a) A shared system prompt: one seed request of a
     1024-token system prompt plus a 96-token tail (a chunked miss: chunks
     of 512, 512 and 96 over three steps), then 32 requests of the same
     system prompt plus their own 64-192-token tails at once (partial hits:
     each prefills only its tail over the cached pages), then 8 of those 32
     prompts again (exact hits: no prefill). (b) 8 requests of 512 tokens
     start decoding, then 2 prompts of 1536 tokens arrive (three chunks
     each). Gates: every request finishes with its 64 tokens inside the
     vocabulary; prefix_cache_stats after (a) are 1 miss, 32 partial hits, 8
     hits; pages are conserved (free + cached + held = the pool); in (b) the
     short requests emit tokens in at least 2 steps that begin with a long
     prompt mid-prefill; K1 is launched 0 times in (a) and exactly 12 times
     per prefill group in (b), K4 in both. The tail prefill's logits (each
     partial hit, each chunked prompt's last chunk, over the cached pages)
     against the plain forward over the whole prompt: max |diff| <= 0.25,
     mean <= 0.02; every first token, exact hits included, within 0.25 of
     the plain top-1 logit (token equality with a cold run is not a gate:
     cold prefill runs K1 in bf16, the tail plain einsum, so near-ties may
     differ); one page copy bitwise equal in every layer. TTFT of the seed,
     the partial and the exact hits and decode tokens/s during the steps
     that begin mid-prefill are printed, not gated.
  3-5 at D 128 and D 256: phases 3, 4 and 5 again at head dim 128 and
     Mistral-7B's heads (H 32, KV 8), then at head dim 256 and Gemma-2B's
     (H 8, KV 1), after every D-64 phase (3, 4, 5, 5b) has run on the
     random streams of earlier versions of this script. K1: B in {1, 8} at
     D 128, {1, 4} at D 256, S in {512, 1000, 4096}, causal and not, with a
     pad segment, plus MQA or GQA (H 8, KV 1 or 2), packed segments (B 2 x
     S 4096), S 64 and S 33; K3/K2 the same set at B in {1, 2} (D 128) or
     {1, 4} (D 256); the plain versions run one batch row at a time (a
     row's fp32 scores are 2.1 GB at 32 heads). The same tolerances and
     two-launch checks. K1 timed at the large engine's prefill shape (one
     group of 8 prompts: 8 x 1024 at D 128, 8 x 2048 at D 256) and the
     training shape (B 8 x S 4096), K3/K2 at the training shape, each beside
     SDPA's forward or backward; the timed inputs of K1 (at both shapes)
     and of K3/K2 are also held against the plain versions, so the timed
     shapes themselves are checked (at D 64 too). K4: the large engine's decode shape (32 sequences of
     1025..1152 tokens at group 4, or of 2049..2176 at group 8, page 128, a
     table of max_seq / 128 pages), one sequence split over most of its
     table, the two-launch check, then timed at the decode shape.
  6c. serve-mistral7b-paged: Mistral-7B-v0.3's shape (vocab 32768, d_model
     4096, 32 layers, 32 heads, 8 KV heads, head_dim 128, d_ff 14336,
     max_seq 4096, rope_theta 1e6; 7.25B parameters, 14.5 GB in bf16) with
     seeded random weights through the paged engine (page 128, 32 slots:
     1025 pages, 17.2 GB of KV); warmup, then 32 greedy requests of 1024
     prompt tokens and 128 new tokens at once. Gates: every request
     finishes with its 128 tokens inside the vocabulary; K1 launches =
     32 x the prefill groups and K4 = 32 x the decode steps, both counted
     from the engine's calls and both > 0; the prefill logits of all 32
     prompts against the plain forward (4 prompts at a time, its last
     position only) within phase 6's 0.25 / 0.02, every first token within
     0.25 of the plain top-1.
  6d. serve-gemma2b-paged: Gemma-2B's shape (vocab 256000, d_model 2048, 18
     layers, 8 heads, 1 KV head, head_dim 256, d_ff 16384, max_seq 8192;
     3.03B parameters, 6.1 GB in bf16), not cut, through the same engine
     (page 128, 32 slots: 2049 pages, 4.8 GB of KV): 32 greedy requests of
     2048 prompt tokens and 128 new tokens at once. The gates of 6c, K1 and
     K4 at D 256.
  6e. serve-openai-250M: phase 6's model (full width and depth, seeded bf16
     weights, paged KV, page 128, 32 slots) served as text through
     OpenAIServer over LLMServer, whose stepping thread launches K1 and K4;
     warmup at every prefill bucket. A byte-level BPE tokenizer trained on
     seeded text (200 merges), saved and read back with load_tokenizer; the
     ChatML jinja template (the legacy format where jinja2 is missing). 32
     client threads released together, each one request of 480-512 encoded
     prompt tokens x 64 new tokens (ignore_eos): 8 streamed /v1/completions
     greedy, 8 streamed sampled (temperature 0.8, top_p 0.95, top_k 40), 8
     /v1/chat/completions greedy, 8 token-id dicts through LLMServer's
     __call__; every request carries a 60 s deadline. Then a token-level
     stream closed after 2 frames, a chat stream read to its end and a chat
     request with a 50 ms deadline. Gates: each of the 32 ends with 64
     tokens inside the vocabulary and finish_reason "length" (usage for
     chat, the last chunk for streams); every SSE frame parses and every
     stream ends with [DONE]; the chat stream's first chunk carries the
     assistant role; the deadline raises DeadlineExceeded; within 2 s of the
     early close and of the deadline the engine holds no request and every
     page is back; the stepping thread stays alive; serve.ttft_s observes
     each of the 32 once; K1 = 12 x the prefill groups and K4 = 12 x the
     decode steps (both > 0); the token-level requests' first tokens and
     prefill logits against the plain forward (phase 6's tolerances).
     Printed: client TTFT (call to first SSE frame, streams), the engine's
     TTFT, decode and overall tokens/s, beside phase 6's engine-only
     numbers and their ratio (the serving surface's overhead). Then the
     device window: the 8 token-level prompts again, sent together while
     tracing.profile_tpu (torch.profiler through the port's device_capture)
     runs in the main thread, from their release until the stepping thread
     has ended the first step that prefilled and two more steps (one
     admission step, two decode blocks).
  6f. serve-runtime-250M: phase 6's model, weights and prompts through the
     port's runtime (ray_tpu_torch.core): rt.init(num_cpus=4, resources
     {"GPU": 1}, a 2 GiB object store in /dev/shm; the phase fails, naming
     /dev/shm, if it cannot hold that). (a) CUDA tensors of 64 KiB (inlined),
     4 MiB and 256 MiB in bf16 and fp32 through rt.put / rt.get: each must
     come back on the card with the same bits; put and get GB/s printed
     beside a bare .cpu() / .cuda() round trip of the same tensor. (b) A
     num_gpus=1 task takes refs of q, k, v at phase 6's prefill shape (8 x
     512, H 16, KV 4, D 64, bf16), runs K1 in its worker and returns o,
     which must be bitwise equal to the driver's own K1 call on the same
     tensors (K1 is bitwise repeatable). (c) A num_gpus=1 actor takes the
     whole bf16 parameter tree (phase 6's seed-0 weights) as one ObjectRef,
     builds phase 6's engine (paged, page 128, 32 slots), warms up and
     serves phase 6's 32 x 512-token prompts x 64 greedy tokens through one
     actor method: every request finishes, its tokens must equal phase 6's,
     and it returns its K1 / K4 launch counts (both > 0; the path
     serve_runtime counts the task's K1 and the actor's). Printed, not
     gated: TTFT p50/p99, decode tok/s and wall time beside phase 6's, the
     ref -> engine time (get, build, warmup) and the actor's peak memory.
     Then the device window: inside the actor, its serve of the first 8 of
     phase 6's prompts under tracing.profile_tpu. rt.shutdown() ends the
     worker processes.
  6g. serve-app-250M: phase 6's model through serve on the runtime:
     rt.init(num_cpus=8, resources {"GPU": 1}, the 2 GiB store), then
     serve.start() (controller and HTTP proxy). (a) build_llm_app with
     params=rt.put(phase 6's seed-0 bf16 tree), two replicas of
     ray_actor_options {"num_gpus": 0.5} (two replicas share the card),
     warmup at every bucket, serve.run(http=False); phase 6's 32 x
     512-token prompts x 64 greedy tokens sent at once through the handle.
     Gates: every request finishes with 64 tokens inside the vocabulary,
     its tokens equal phase 6's, each replica served at least one request,
     and K1 > 0 and K4 > 0 counted in each replica's own process (the
     deployment class is the builder's LLMServer wrapped by _counted, which
     only observes); then serve.delete frees the GPU share. (b)
     build_openai_app at route "/", one replica of num_gpus 1, phase 6e's
     seeded tokenizer and ChatML template; 32 client threads released
     together POST to the proxy: 8 streamed and 8 unstreamed greedy
     /v1/completions on the same prompts, 4 streamed and 4 unstreamed
     sampled, 4 streamed and 4 unstreamed greedy /v1/chat/completions
     (480-512 prompt tokens x 64, ignore_eos). Gates: every response is
     200, every SSE line parses and each stream ends with [DONE], each
     completion ends by "length" (64 tokens) or "stop", the greedy streamed
     text equals the unstreamed text of its prompt, the replica took the 32
     and launched K1 and K4, and a request with x-request-timeout-s 0.0001
     gets 504 (the typed deadline, end to end). Printed, not gated:
     serve.run -> healthy for (a) and (b), engine TTFT, client TTFT over
     HTTP beside 6e's in-process client TTFT, decode and overall tok/s, each
     replica's peak memory and K1 / K4 launches. A deployment that does not
     become healthy within 600 s fails the phase, naming its status. After
     (a)'s gates, the device window: one replica starts the port's
     profile_server listener (a method of _counted's class), one HTTP
     request there runs a 15 s capture in that replica's process, and
     phase 6's prompts go through the handle again inside it.
     Device windows (6e, 6f, 6g): the trace must exist and parse, hold K4,
     and hold K1 where a prefill fell in the window; in 6f and 6g as many
     launches of each as the wrappers counted in the window (6e: at least
     as many; its counts cover part of the window). Printed: device time
     (the union of the trace's kernels, memcpys and memsets; CUPTI records
     every thread of the process), wall time and the busy share (device
     over wall; 6f and 6g also over the span the requests ran).
  6h. dag-250M: a compiled DAG (ray_tpu_torch.dag) of two num_gpus=0.5
     actors in 6f's session (GPU 1, the 2 GiB store). Stage A makes q, k, v
     on the card from the execution's seed (phase 6's prefill shape: q
     [8, 512, 16, 64], k and v [8, 512, 4, 64], bf16, 12 MiB, so the edge is
     the shared-memory channel); stage B runs K1 (flash_attention) and
     returns o. One warmup execution, then 10 pipelined executions. Gates:
     each o within phase 3's tolerance (max |o - o_ref| <= 2e-2, finite) of
     the plain version in fp32 on the same seeded inputs; stage B's process
     counts exactly 10 K1 launches; the dag_shm_edges counter ticks. Then a
     one-edge DAG carries bf16 CUDA tensors of 64 KiB to 256 MiB from stage
     A to stage B, which checks their bits by an integer checksum; p50
     execute latency of 5 and GB/s printed beside 6f's bf16 put / get.
  6i. data-batch-250M: Data on the runtime (ray_tpu_torch.data; 6f's session:
     GPU 1, the 2 GiB store). (a) phase 6's 32 prompts of 512 token ids as
     rows {"prompt", "i"} in 4 blocks (rd.from_items, parallelism 4) through
     batch_generate (phase 6's model and engine config, paged, page 128, 32
     slots, seed 0; 64 greedy tokens) on a pool of two actors of
     ray_remote_args {"num_gpus": 0.5}; each actor's engine draws phase 6's
     seed-0 weights on the card. Gates: every row's tokens equal phase 6's
     (up to and with the first eos, token 2, which batch_generate's engines
     stop on and phase 6's does not), both actors took blocks, and K1 and K4
     launched in each actor's own process and never in the driver (the
     stage's UDF is _EngineUDF wrapped by _data_udf, which only observes).
     Printed, not gated: rows/s and output tok/s beside phase 6's engine
     tok/s, the time from the start of the consumption to the first block,
     each actor's engine construction time, calls and peak memory. (b) 3
     seeded token batches at the training cell's shape (B 16 x 2049, int32)
     through rd.from_numpy -> iter_torch_batches -> prefetch_to_device (side
     stream, pinned staging) into make_train_step (phase 7's configuration,
     fresh state of seed 0), then the same steps from a fresh state on the
     same arrays moved by a plain .cuda(). Gates: the batches equal, the
     losses bitwise equal, launches K1 24 / K3 12 / K2 12 per step. Printed:
     the infeed's H2D GB/s beside a bare .cuda() of the same batches, over
     one stream of 30 training batches (262 KB each) and of 3 of 64 MiB.
  6j. serve-tp-250M: tensor-parallel serving of phase 6's engine config
     (paged, page 128, 32 slots, seed weights) over slots of cuda:0
     (RAY_TPU_TORCH_DEVICE_SLOTS=4, set for this phase only): TP 1 (phase
     6's engine, rebuilt for its prefill logits), then tensor_parallel=2 on
     phase 6's 32 prompts x 64 tokens and 4 on the first 8. Gates: each TP
     engine's prefill logits within phase 6's bounds (max <= 0.25, mean <=
     0.02) of the TP-1 engine's; on TP 1's greedy streams of the first 8
     prompts, forced into each TP engine (its sampler returns TP 1's
     tokens), every decode step's logits of the occupied slots within the
     same bounds of TP 1's; K4 through paged_attention's mesh branch at the
     degree's per-slot shape (16/tp heads, 4/tp KV heads, 32 sequences)
     against paged_attention_reference on each slot's q and pool shards
     (2e-2, as phase 1's K4); two TP-2 runs (tokens and prefill logits)
     bitwise equal; K1 launched exactly tp x 12 per prefill group and K4 tp
     x 12 per decode step; each slot's wq holds 16/tp heads, its w_gate
     4096/tp columns and its pool 4/tp KV heads, each shard contiguous; a
     TP-2 tree through rt.put / rt.get ships one buffer per unique shard,
     its bytes the unique shards' bytes, and an engine built on it gives
     the same tokens. Printed: how many of the greedy streams match TP 1
     exactly and the first divergence, TTFT, decode tok/s and peak memory
     per degree. Slots of one card check the sharded path; they are not a
     speed-up.
  6k. operator-250M: the operator surface. (a) `python -m ray_tpu_torch
     start --head --port 0` (a state dir of its own): the head must
     advertise GPU 1 and the card's name (autodetected), `status` and
     `list nodes` must print the GPU; this process joins by address. (b)
     A num_gpus=1 task with runtime_env working_dir + py_modules +
     env_vars imports the shipped module and runs K1 (ops.attention
     .flash_fwd, causal) on seeded q, k, v at phase 3's shape (B 1, S 1000,
     H 16, KV 4, D 64, a pad segment): the env var seen, the cwd the
     materialized working_dir, K1 launched in the worker, o and LSE within
     phase 3's 2e-2 / 1e-3 of mha_reference; then a task in a pip venv
     (the same module as a local package, --no-index, --system-site-packages)
     runs on the venv's interpreter with the same K1 gates. Whether podman
     or docker exists is printed. (c) `job submit --wait` of a script that
     builds phase 6's engine on cuda and drives 8 of phase 6's prompts x
     32 greedy tokens: SUCCEEDED, K1 and K4 launched in the job, its
     prefill logits (saved with torch.save) and first tokens within phase
     6's bounds of the plain forward, its tokens equal to this process's
     drive of the same prompts. (d) The dashboard: /api/jobs lists the job
     SUCCEEDED with its entrypoint, /api/cluster GPU 1, /metrics answers
     Prometheus text. (f) A GPU replica (LLMServer, 16 requests at once)
     at /day maps a body of n bytes to min(n, 512) seeded prompt tokens
     and 16 new tokens (SSE when x-stream: 1); the quick seed-0 day (636
     requests over 16 s) replayed open-loop at warp 2, summarized into a
     run ledger, rendered, and `report diff L L` must exit 0. Gates: every
     request has an outcome, each failure a QoS shed (429) or deadline
     (504), interactive goodput > 0, every 200 stream a TTFT, K1 and K4
     launched in the replica. Printed: per class p50/p99, TTFT p95 and
     goodput. Then `stop` (no recorded pid left alive) and (e), in this
     process: a 1-CPU, 0-GPU head, a pending num_gpus=1 K1 task (as in
     (b)) makes the autoscaler launch one {"CPU": 4, "GPU": 1} node
     labelled with the card; the task's K1 holds (b)'s gates; later
     updates arm, drain and terminate the idle node.
  6l. chaos-day-250M: (a) `python -m ray_tpu_torch lint --json --no-cache`
     over the port (exit 0, total 0), `chaos list`, and `chaos run
     tpu_preempt_drain --quick --seed 0` in its own process (report ok).
     (b) The quick seed-0 day under day_in_the_life's chaos timeline
     (ray_tpu/chaos/scenarios.py:1372-1388: a 0.04 s slow-replica window
     over the storm, a calm client flap, a preemption notice of slice-a /
     worker 1 with a 0.3 s grace in recovery, a 0.05 s delay of the
     ckpt.publish.swap site, publish_weights at recovery + 0.3 s), compiled
     at seed 0, warp 2, heartbeat 0.25 s, lead 1.0 s, replayed against one
     replica of 6k(f)'s DayLLM (deployment "DayApp", num_gpus 1, num_cpus
     2, 16 requests at once, subscribed to the timeline's channel) on an
     in-process cluster: a head with the card and 8 CPUs, and a 1-CPU
     victim host with the slice labels; the publish action commits a 250M
     tree drawn from seed 1 through the port's ckpt and publishes it.
     Gates: the victim drains and goes DEAD; each of the timeline's sites
     is in the driver's or the replica's injection log; the replica
     reports the published ckpt_id; 8 of phase 6's prompts x 64 tokens
     through the handle equal an in-process engine built on the published
     tree; K1 and K4 launched in the replica before and after the swap;
     chaos.invariants.check_all ok; every request a 200, 429 or 504, and
     interactive goodput > 0. Printed, not gated: the run ledger and its
     gates (their floors are the reference's 4 ms toy app's), per class
     p50/p99, TTFT p95 and goodput, the swap blip, publish -> swap, the
     preemption notice -> DEAD, the day's wall time.
  7. training: (a) the model cut to 2 layers, B 2 x S 2048, bf16: the
     gradients of one cross_entropy_loss through the kernels
     (attention_impl="flash": K1, K3, K2) against the plain path
     ("reference") on the same weights and batch, per leaf
     |g - g_ref| / |g_ref| <= 5e-2 (L2 norms; bf16 activations, the two
     paths round P and dS at different places); (b) the same model through
     the kernels with remat off, "full" and "dots": per leaf relative
     difference <= 5e-3 (the kernels are deterministic and the recompute
     repeats the same ops; only reduction order may differ); (c) the same
     model with attention_impl="splash" (K5: K1, K3, K2 on the folded q)
     against "flash": loss within 5e-2 and per-leaf relative difference
     <= 5e-2 (splash rounds q * scale to bf16 before the kernel, flash
     scales in fp32 inside it), each of K1, K3, K2 launched; (d) the
     bench.py:57-77 configuration at full width and depth (12 layers,
     remat "dots", AdamW) at B 16 x S 2048 on one seeded batch: a warmup
     step, then 10 timed steps through make_train_step. The loss must be
     finite and fall, and each step must launch K1 24 times (12 forward +
     12 recompute), K3 12 and K2 12. Prints step time, tokens/s, MFU
     (bench.py's formula, 6 N T + 12 L d S T, against 989 TFLOP/s) and peak
     memory.
  7e. train-mistral7b-4L: at Mistral-7B's widths, first the gradient check
     of 7(a) (2 layers, B 1 x S 2048, K1-K3 at D 128 against the plain
     path, per leaf relative L2 <= 5e-2, one launch of each per layer), then
     make_train_step at the same widths cut to 4 layers (1.141B parameters;
     the whole model's AdamW state alone is 116 GB), remat "dots", AdamW,
     B 8 x S 4096 on one seeded batch: a warmup step, then 10 timed steps.
     The loss must be finite and fall; each step launches K1 8 times, K3 4
     and K2 4. Prints step time, tokens/s, MFU and peak memory.
  7f. train-gemma2b-4L: 7e at Gemma-2B's widths (K1-K3 at D 256), cut to 4
     of 18 layers (1.489B parameters; the whole model's AdamW state is
     ~48 GB), with the loss over sequence chunks of 1024 (ce_chunk: the
     [8, 4096, 256000] logits never exist; a fallback to them is an error).
  7g. train-plane-250M: the train plane (ray_tpu_torch.train, collective,
     ckpt) on the port's runtime (rt.init GPU 1, the 2 GiB store), at 7(d)'s
     configuration, seed-0 state and batch. First four in-process
     train_step calls in the driver (the reference losses). (a)
     DataParallelTrainer, ScalingConfig(num_workers=1, use_gpu=True),
     FailureConfig(max_failures=1): the worker trains steps 1-4, saves
     through the checkpoint plane (train.save_pytree_async of the
     parameters, AdamW's tensors and the step; its param_groups and the
     step count in the manifest's meta) after steps 2 and 4, and on its
     first attempt raises after step 3; the restarted gang restores the
     step-2 checkpoint and runs steps 3-4. Gates: the losses of steps 1-4
     bitwise equal the driver's, step 3's loss after the restore bitwise
     equals it before, every restored leaf's sha256 equals the saved
     leaf's, K1 24 / K3 12 / K2 12 per step counted in the worker. (b)
     ScalingConfig(num_workers=2, use_gpu=True, resources_per_worker
     {"GPU": 0.5}): rank r takes rows 8r..8r+7; each step the loss and its
     backward on its half, train.grad_sync().allreduce of the gradients
     (mean, fp32, 4 MiB buckets) copied into each .grad, AdamW; 3 steps.
     Gates: each step's mean of the two ranks' losses within 2e-3 of (a)'s,
     both ranks' parameters bitwise equal after step 3 (sha256 per leaf),
     K1 24 / K3 12 / K2 12 per step in each rank, torch.distributed at world
     size 2 in each rank. (c) an in-process LLMServer (phase 6's model and
     engine config, weights_channel "train-250M", seed weights); (a)'s
     step-4 checkpoint published on that channel. Gates: weights_version()
     is its id within 30 s; greedy tokens of phase 6's first 8 prompts (64
     new tokens) equal those of an LLMEngine built from the manifest through
     ckpt.restore_tree; K1 and K4 launched after the swap. Printed: step
     times, the save's time on the step path and to commit, bytes written,
     restore GB/s, peak memory per worker, (b)'s grad-sync share of the step
     and ring GB/s, publish -> swap latency. The storage is removed at exit.
  7h. tune-sweep-250M: Tune (ray_tpu_torch.tune) on the port's runtime
     (rt.init GPU 1, the 2 GiB store) at 7g's configuration, seed-0 state
     and batch, each trial on rows 0-7 (B 8 x S 2048). First the driver's
     reference: 3 in-process train_step calls at each learning rate of
     grid_search([1e-4, 3e-4, 1e-3, 3e-3]) (AdamW's lr set before the first
     step; step 1's loss is the same at every rate). (a) A FIFO sweep of
     that grid, resources_per_trial {"GPU": 0.5}, max_concurrent_trials 2,
     each trial reporting its loss after each of 3 steps. Gates: every
     trial's losses bitwise equal the driver's at its rate;
     get_best_result("loss", "min") is the driver's best rate; K1 24 / K3
     12 / K2 12 a step counted in each trial's process; two trials' step
     windows overlap on the card. (b) The grid under ASHAScheduler(max_t 3,
     grace 2, reduction factor 2) over the iteration. Gates: a trial was
     stopped before step 3; every trial's losses are a bitwise prefix of the
     driver's (the decisions the driver's losses predict for the order in
     which the trials reached the rung are printed). (c) One trial at 3e-4,
     max_failures_per_trial 1: its first attempt saves the parameters,
     AdamW's state and the step after step 2 (train.checkpoint.save_pytree,
     reported with the step), then raises; the retry restores through
     tune.get_checkpoint() and runs step 3. Gate: the losses of steps 1-3
     bitwise equal the driver's. Printed: each trial's start latency (actor
     requested -> first report), step times and peak memory, each sweep's
     wall time, the checkpoint's bytes and save and restore times.
  7i. rl-learners: (a) PPOLearner (CartPole's sizes: obs 4, 2 actions,
     minibatch 256, lr 2.5e-4), MultiAgentPPO's per-policy PPOLearner
     (CueMatch: 4 cues, minibatch 512, lr 3e-3), IMPALALearner (a 64 x 8
     rollout), DQNLearner (batch 64, a target sync after update 2),
     SACLearner (Pendulum: obs 3, one action, batch 128), BCLearner
     (discrete, batch 256; continuous, batch 256) and CQLLearner (batch 256,
     8 action samples), each built from the same seed-0 numpy parameters on
     the card and on the CPU, 3 updates each on one seeded numpy minibatch,
     SAC and CQL on the same seeded draws. Gates: per-leaf relative L2 (the
     parameters, target networks and temperature) <= 1e-4 after the 3
     updates and each update's losses within 1e-4 relative (fp32, TF32
     off); the card learner's parameters are CUDA tensors. (b)
     MultiAgentPPO on CueMatchEnv(n_agents 2, n_cues 4, ep_len 16), 2
     runners x 8 envs, rollout 64, lr 3e-3, seed 0, its learner on the
     card, the runners numpy on CPU actors (rt.init). Gate:
     episode_return_mean > 26 within 12 iterations (max 32). Printed: each
     iteration's time split into learning (the learner's updates, each
     synchronized) and sampling with the host work around it, and learner
     updates/s.
  7j. parallel-train-250M: 7's configuration (remat "dots") on rows 0-7 of
     its batch (B 8 x S 2048), seed-0 state, 3 steps of each over slots of
     cuda:0 (RAY_TPU_TORCH_DEVICE_SLOTS=4, this phase only): (a) dp 2 x tp
     2, (b) fsdp 4, (c) attention_impl "ulysses" at seq 4 (4 heads and 1 KV
     head per slot), (d) "ring" at seq 4, (e) make_pipeline_train_step at
     stage 4 x n_micro 4 (3 layers a stage). Gates: every step's loss within
     1e-3 relative and grad_norm within 1e-2 of the single-slot step on the
     same weights and batch; after step 1 every leaf's gradient (gathered
     from its master shards) within 5e-2 relative L2 of the single-slot
     step's, and the updated wq within 5e-3; losses fall; every leaf's per-slot shard shape
     follows the strategy's spec; K1 / K3 / K2 launches exact in (a) and
     (c) (4 slots x 12 layers, K1 twice under remat) and (e) (4 microbatches
     x 12 layers). Printed: step times, peak memory, and the leaf with the
     largest step-1 gradient error and that error.
  8. JSON lines {"engine": ...}, {"engine_prefix": ...},
     {"engine_mistral7b": ...}, {"engine_gemma2b": ...}, {"engine_openai": ...},
     {"engine_runtime": ...}, {"engine_serve_app": ...}, {"dag": ...}, {"data": ...}, {"train": ...},
     {"train_mistral7b": ...}, {"train_gemma2b": ...}, {"train_plane": ...},
     {"tune": ...}, {"rl": ...}, {"engine_tp": ...}, {"operator": ...}, {"chaos_day": ...},
     {"train_parallel": ...}, {"kernels": [...]}
     (each kernel's D-64 numbers, its "d128" and "d256" numbers with their
     launches by path and ptxas report, its launches by path, ptxas's
     registers and spills per instance, null where this run did not
     compile it) and, last, {"ok": true, "device": ...}. 6e, 6f and 6g's
     device windows are under "device_window" in their phases' lines.

``--profile DIR`` also traces the paged engine with torch.profiler (the
admission step with its prefills, then two decode steps), the admission
step of 32 more partial hits in phase 6b (with the device time under the
tail attention's einsums and softmax, the GEMMs and the page copies), the
7B engine's admission step and two decode steps (6c), and one training
step of each training cell, prints each window's device time by kind of
kernel, and writes the kernel tables and traces to DIR (the 2B engine's
and training step too); the device windows' traces go to DIR/windows.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
H, KV, D = 16, 4, 64
MODEL = dict(vocab_size=32_000, d_model=1024, n_layers=12, n_heads=H, n_kv_heads=KV,
             d_ff=4096, max_seq_len=2048)
# Mistral-7B-v0.3's published shape (huggingface.co/mistralai/Mistral-7B-v0.3,
# config.json: hidden_size 4096, 32 layers, 32 heads, 8 KV heads, head_dim
# 128, intermediate_size 14336, vocab 32768, rope_theta 1e6, no sliding
# window, untied embeddings). One departure: RMSNorm eps is 1e-6 here, as in
# both packages' rms_norm, where Mistral publishes 1e-5.
H7, KV7, D7 = 32, 8, 128
MISTRAL = dict(vocab_size=32_768, d_model=4096, n_layers=32, n_heads=H7, n_kv_heads=KV7, d_ff=14_336,
               max_seq_len=4096, rope_theta=1e6)
# Gemma-2B's published shape (huggingface.co/google/gemma-2b, config.json:
# hidden_size 2048, 18 layers, 8 heads, 1 KV head, head_dim 256,
# intermediate_size 16384, vocab 256000, max_position_embeddings 8192,
# rope_theta 10000, rms_norm_eps 1e-6). Departures, both packages' model
# code: SwiGLU where Gemma gates with GELU, an untied head, no sqrt(hidden)
# scaling of the embeddings and RMSNorm weights w where Gemma has 1 + w.
H2, KV2, D2 = 8, 1, 256
GEMMA = dict(vocab_size=256_000, d_model=2048, n_layers=18, n_heads=H2, n_kv_heads=KV2, d_ff=16_384,
             max_seq_len=8192, rope_theta=10_000.0)
# The large-model cells: 6c/7e at Mistral-7B's shape (D 128), 6d/7f at
# Gemma-2B's (D 256). serve: requests x prompt tokens x new tokens at once,
# engine slots, prompts per plain forward in the logits gate; train: the
# widths cut to `layers` layers at B x S (ce_chunk: the loss over sequence
# chunks of that size, 0 = whole logits); parity: the 2-layer gradient
# check before it.
BIG = {
    "mistral7b": dict(model=MISTRAL, serve=dict(req=32, prompt=1024, tokens=128, slots=32, check_chunk=4),
                      train=dict(layers=4, b=8, s=4096, ce_chunk=0), parity=dict(layers=2, b=1, s=2048, seed=2)),
    "gemma2b": dict(model=GEMMA, serve=dict(req=32, prompt=2048, tokens=128, slots=32, check_chunk=4),
                    train=dict(layers=4, b=8, s=4096, ce_chunk=1024), parity=dict(layers=2, b=1, s=2048, seed=3)),
}
M_PROMPT, M_TOKENS = BIG["mistral7b"]["serve"]["prompt"], BIG["mistral7b"]["serve"]["tokens"]
G_PROMPT, G_TOKENS = BIG["gemma2b"]["serve"]["prompt"], BIG["gemma2b"]["serve"]["tokens"]
N_REQ, PROMPT_LEN, MAX_TOKENS, SLOTS, PAGE = 32, 512, 64, 32, 128
K1_CHECK = ((1, 512), (1, 1000), (1, 2048), (8, 512), (8, 1000), (8, 2048))  # (B, S)
K4_B, K4_PPSEQ = 32, 16  # sequences; pages per sequence (max length 2048)
K4_PAGES, K4_GROUPS = (16, 64, 128), (1, 2, 4, 8)  # K4's sweep: page sizes, q heads per kv head
K23_CHECK = ((1, 512), (1, 1000), (1, 2048), (4, 512), (4, 1000), (4, 2048))  # (B, S)
# (B, S, H, KV, segments): MQA, three packed segments per row, one tile, under one tile.
K23_EXTRA = ((2, 1000, 8, 1, "pad"), (2, 2048, H, KV, "packed"), (2, 64, H, KV, "pad"), (3, 33, 8, 2, "pad"))
# Phase 6b: a shared system prompt (a seed request with a 96-token tail, then
# partial hits with tails of 64-192 tokens, then exact hits), chunks of 512;
# then short prompts decoding while long prompts prefill chunk by chunk.
SYS_LEN, SEED_TAIL, HIT_TAIL, N_HIT, N_EXACT, CHUNK = 1024, 96, (64, 192), 32, 8, 512
N_SHORT, N_LONG, LONG_LEN = 8, 2, 1536
# Phase 6e: the serving surface (OpenAIServer over LLMServer) on phase 6's
# model. A tokenizer trained on seeded text (a word list, then sentences of
# its words; few merges, so it trains in seconds); OAI_PER_KIND requests of
# each kind released together, prompts of OAI_PROMPT encoded tokens,
# MAX_TOKENS new tokens, every wait bounded by OAI_TIMEOUT_S; then a
# token-level stream closed after 2 frames, a chat stream read to its end
# and a chat request with a 50 ms deadline.
OAI_KINDS = ("completions_stream_greedy", "completions_stream_sampled", "chat_greedy", "tokens_greedy")
OAI_PER_KIND, OAI_PROMPT, OAI_TIMEOUT_S, OAI_DEADLINE_S = 8, (480, 512), 60.0, 0.05
OAI_SAMPLED = dict(temperature=0.8, top_p=0.95, top_k=40)
OAI_WORDS, OAI_SENTENCES, OAI_MERGES = 400, 300, 200
# The ChatML template (the format Qwen-family checkpoints are tuned on).
CHATML = ("{% for message in messages %}<|im_start|>{{ message.role }}\n{{ message.content }}<|im_end|>\n"
          "{% endfor %}{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")
# Ops whose device time the profile of 6b's admission step reports (the
# tail attention's einsums, softmax and mask; the projections' GEMMs; the
# page copies, pool writes and context gathers).
PREFIX_OPS = ("aten::einsum", "aten::_softmax", "aten::masked_fill", "aten::mm", "aten::index_select",
              "aten::index_copy_", "aten::cat")
TRAIN_B, TRAIN_S, TRAIN_STEPS = 16, 2048, 10  # bench.py's batch and sequence
# Device windows of 6e, 6f and 6g: torch.profiler traces taken through the
# port's own tracing.profile_tpu / profile_server, written under WINDOW_DIR
# (a directory under --profile DIR when given, else a temporary directory
# removed at exit). 6f's window serves the first WINDOW_6F_N of phase 6's
# prompts; 6g's capture runs WINDOW_6G_S seconds in one replica. A trace's
# kernels are told apart by these names.
WINDOW_DIR = None
WINDOW_6F_N, WINDOW_6G_S = 8, 15.0
K1_NAME, K4_NAME = "flash_fwd_kernel", "paged_decode_kernel"
# Phase 6h: a compiled DAG of two num_gpus=0.5 actors. Stage A makes q, k, v
# at phase 6's prefill shape from a seed, stage B runs K1 on them; DAG_EXECS
# pipelined executions. Then a one-edge DAG carries bf16 CUDA tensors of
# DAG_SIZES bytes, DAG_REPS timed executions each after one warmup.
DAG_EXECS, DAG_REPS = 10, 5
DAG_SIZES = (64 << 10, 1 << 20, 4 << 20, 16 << 20, 64 << 20, 256 << 20)
PARITY_LAYERS, PARITY_B = 2, 2
# The kernel phases' shapes for each head dim: D 64 at the 250M model's
# heads, D 128 at Mistral-7B's (H 32, KV 8), D 256 at Gemma-2B's (H 8, KV
# 1) with GQA cases (H 8, KV 2). k1/k23: (B, S) swept with a
# pad segment, causal and not; extra: (B, S, H, KV, segments); det: the
# two-launch check's (B, S); prefill/train: the timed shapes (one group of 8
# prompts of the serving cell's prompt length; the training cell's batch).
# rows: the plain versions run one batch row at a time (a row's fp32 scores
# at 32 heads x 4096^2 are 2.1 GB).
SHAPES = {
    64: dict(h=H, kv=KV, d=D, k1=K1_CHECK, k23=K23_CHECK, extra=K23_EXTRA, det=(2, TRAIN_S),
             prefill=(8, PROMPT_LEN), train=(TRAIN_B, TRAIN_S), rows=False),
    128: dict(h=H7, kv=KV7, d=D7, k1=((1, 512), (1, 1000), (1, 4096), (8, 512), (8, 1000), (8, 4096)),
              k23=((1, 512), (1, 1000), (1, 4096), (2, 512), (2, 1000), (2, 4096)),
              extra=((2, 1000, 8, 1, "pad"), (2, 4096, H7, KV7, "packed"), (2, 64, H7, KV7, "pad"),
                     (3, 33, 8, 2, "pad")),
              det=(2, 4096), prefill=(8, M_PROMPT), train=(8, 4096), rows=True),
    256: dict(h=H2, kv=KV2, d=D2, k1=((1, 512), (1, 1000), (1, 4096), (4, 512), (4, 1000), (4, 4096)),
              k23=((1, 512), (1, 1000), (1, 4096), (4, 512), (4, 1000), (4, 4096)),
              extra=((2, 1000, 8, 2, "pad"), (2, 4096, H2, KV2, "packed"), (2, 4096, 8, 2, "packed"),
                     (2, 64, H2, KV2, "pad"), (3, 33, 8, 2, "pad")),
              det=(2, 4096), prefill=(8, G_PROMPT), train=(8, 4096), rows=True),
}
# K4's decode shapes at D 128 and 256: the 7B and 2B engines' (32
# sequences, page 128, tables of max_seq / 128 pages).
K4_BIG = {128: dict(h=H7, kv=KV7, lengths=(M_PROMPT + 1, M_PROMPT + M_TOKENS), ppseq=4096 // 128),
          256: dict(h=H2, kv=KV2, lengths=(G_PROMPT + 1, G_PROMPT + G_TOKENS), ppseq=8192 // 128)}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean time of one call from CUDA events around `iters` eager calls.
    Where a call's host work (the Python wrapper, the launch) takes longer
    than its kernels, this is the host's time: the card waits between
    calls. Used for the plain versions and for SDPA's backward."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, replays=3):
    """Mean device time of one call: `iters` calls captured in one CUDA graph
    (after warmup calls on a side stream), replayed `replays` times between
    CUDA events, so no host work stands between the kernels. The kernels'
    `ms` and SDPA's forward are timed so."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}  "
        f"torch {torch.__version__}  cuda {torch.version.cuda}  python {sys.version.split()[0]}")
    # Data's seam (ROADMAP Queue 1 item 8): a block of the reference's Data
    # is a pyarrow Table. Recorded, not needed by any phase.
    found = []
    for mod in ("pyarrow", "pandas"):
        try:
            found.append(f"{mod} {__import__(mod).__version__}")
        except Exception as e:  # noqa: BLE001  (what is missing is the finding)
            found.append(f"{mod} not importable ({type(e).__name__}: {e})")
    log(f"data packages: {'; '.join(found)}")
    return card


def phase_build():
    """Builds every kernel; prints ptxas's registers and spills for each
    instance this run compiled and returns them: {kernel: {head dim or "-":
    {registers, spill_stores, spill_loads}}}. A source whose library was
    already built is not compiled and has no report (its kernels' "ptxas"
    is null in the kernels line)."""
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    compiled = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    report, cur = {}, None
    for name in _build.SOURCES:
        if name not in compiled:
            log(f"  {name}: already built, not compiled in this run: no ptxas report")
            continue
        for line in _build.log_path(name).read_text().splitlines():
            kernel = re.search(r"([a-z_]+_kernel)(?:ILi(\d+)E)?", line) if "entry function" in line else None
            if kernel:
                cur = report.setdefault(kernel.group(1), {}).setdefault(kernel.group(2) or "-", {})
                log(f"  {name}: {kernel.group(1)}" + (f"<{kernel.group(2)}>" if kernel.group(2) else ""))
            elif "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
                if cur is not None:
                    for key, pat in (("registers", r"Used (\d+) registers"),
                                     ("spill_stores", r"(\d+) bytes spill stores"),
                                     ("spill_loads", r"(\d+) bytes spill loads")):
                        m = re.search(pat, line)
                        if m:
                            cur[key] = int(m.group(1))
    return report


def _seg(B, S, rng, kind="pad"):
    """"pad": prompt padding as the engine builds it (pads are their own
    segment); "packed": three packed examples per row, cut at random places."""
    pos = np.arange(S)[None, :]
    if kind == "packed":
        cuts = np.sort(rng.integers(1, S, (B, 2)), axis=1)
        return ((pos >= cuts[:, :1]).astype(np.int32) + (pos >= cuts[:, 1:]).astype(np.int32))
    lens = rng.integers(S // 2, S + 1, B)
    return (pos >= lens[:, None]).astype(np.int32)


def causal_pairs(seg):
    """Valid (query, key) pairs per head under the causal and segment masks
    (segments contiguous, as the engine's pads and packed batches are)."""
    pairs = 0
    for row in seg:
        for s_id in np.unique(row):
            n = int((row == s_id).sum())
            pairs += n * (n + 1) // 2
    return pairs


def k1_cost(seg, nbytes_io, h=H, d=D):
    """FLOPs this input needs (valid causal same-segment pairs only) and bytes."""
    return 4 * d * h * causal_pairs(seg), nbytes_io


def _mha_rows(q, k, v, causal=True, seg=None, scale=None):
    """mha_reference one batch row at a time, in the inputs' dtype: (o,
    lse [B * H, S])."""
    import torch

    from ray_tpu_torch.ops import attention as att

    outs, lses = [], []
    for b in range(q.shape[0]):
        o, lse = att.mha_reference(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=causal, scale=scale,
                                   segment_ids=None if seg is None else seg[b:b + 1], return_lse=True)
        outs.append(o)
        lses.append(lse.reshape(-1, q.shape[1]))
    return torch.cat(outs), torch.cat(lses)


def _bwd_rows(q, k, v, o, lse, do, seg=None, causal=True, scale=None):
    """flash_bwd_reference one batch row at a time: (dq, dk, dv)."""
    import torch

    from ray_tpu_torch.ops import attention as att

    h = q.shape[2]
    parts = [att.flash_bwd_reference(q[b:b + 1], k[b:b + 1], v[b:b + 1], o[b:b + 1], lse[b * h:(b + 1) * h],
                                     do[b:b + 1], segment_ids=None if seg is None else seg[b:b + 1],
                                     causal=causal, scale=scale)
             for b in range(q.shape[0])]
    return tuple(torch.cat(t) for t in zip(*parts))


def _hold_k1(q, k, v, seg, causal, desc):
    """K1 on these bf16 inputs against mha_reference in fp32 on the same
    inputs: max |o - o_ref| <= 2e-2 and max |lse - lse_ref| <= 1e-3, or it
    raises; returns max |o - o_ref|."""
    import torch

    from ray_tpu_torch.ops import attention as att

    o, lse = att.flash_fwd(q, k, v, segment_ids=seg, causal=causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = _mha_rows(q.float(), k.float(), v.float(), causal, seg)
    err = (o.float() - o_ref).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    finite = bool(torch.isfinite(o).all())
    log(f"K1 {desc}: max|o-ref| {err:.3e}  max|lse-ref| {lse_err:.3e}  finite {finite}")
    if not (finite and err <= 2e-2 and lse_err <= 1e-3):
        raise AssertionError(f"K1 disagrees with its plain version at {desc}")
    return err


def _check_k1(dev, B, S, seg, causal, h=H, kv=KV, label="pad", d=D):
    """K1 against its plain version on random bf16 inputs of this shape."""
    import torch

    q = torch.randn(B, S, h, d, device=dev).bfloat16()
    k = torch.randn(B, S, kv, d, device=dev).bfloat16()
    v = torch.randn(B, S, kv, d, device=dev).bfloat16()
    return _hold_k1(q, k, v, seg, causal, f"D={d} B={B} S={S} H={h} KV={kv} {label} causal={causal}")


def phase_k1(dev, rng, shp):
    """Phase 3 at one head dim (an entry of SHAPES)."""
    import torch

    from ray_tpu_torch.ops import attention as att

    h, kv, d = shp["h"], shp["kv"], shp["d"]

    def plain(q, k, v, seg=None):
        if shp["rows"]:
            return _mha_rows(q, k, v, True, seg)
        return att.mha_reference(q, k, v, causal=True, segment_ids=seg)

    worst = 0.0
    for B, S in shp["k1"]:
        seg = torch.from_numpy(_seg(B, S, rng)).to(dev)
        for causal in (True, False):
            worst = max(worst, _check_k1(dev, B, S, seg, causal, h, kv, d=d))
    for B, S, hh, kk, kind in shp["extra"]:
        seg = torch.from_numpy(_seg(B, S, rng, kind)).to(dev)
        for causal in (True, False):
            worst = max(worst, _check_k1(dev, B, S, seg, causal, hh, kk, kind, d=d))
    torch.cuda.empty_cache()
    # Determinism: no atomics; two launches on the same inputs give the same bits.
    B, S = shp["det"]
    seg = torch.from_numpy(_seg(B, S, rng, "packed")).to(dev)
    q = torch.randn(B, S, h, d, device=dev).bfloat16()
    k, v = (torch.randn(B, S, kv, d, device=dev).bfloat16() for _ in range(2))
    runs = [att.flash_fwd(q, k, v, segment_ids=seg, causal=True) for _ in range(2)]
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    log(f"K1 D={d} determinism (B={B} S={S} packed, two launches): o {same[0]}  lse {same[1]} bitwise equal")
    if not all(same):
        raise AssertionError(f"K1 at D={d} is not deterministic: two launches on the same inputs differ")
    del q, k, v, runs
    # Timing at the engine's prefill shape: one group of 8 prompts in their
    # bucket (no padding, so one segment per row).
    B, S = shp["prefill"]
    q = torch.randn(B, S, h, d, device=dev).bfloat16()
    k = torch.randn(B, S, kv, d, device=dev).bfloat16()
    v = torch.randn(B, S, kv, d, device=dev).bfloat16()
    seg_np = np.zeros((B, S), np.int32)
    seg = torch.from_numpy(seg_np).to(dev)
    worst = max(worst, _hold_k1(q, k, v, seg, True, f"D={d} B={B} S={S} H={h} KV={kv} engine shape causal=True"))
    ms = device_ms(lambda: att.flash_fwd(q, k, v, segment_ids=seg, causal=True))
    eager_ms = time_ms(lambda: att.flash_fwd(q, k, v, segment_ids=seg, causal=True))
    plain_ms = time_ms(lambda: plain(q, k, v, seg))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    mask = (causal[None] & (seg[:, :, None] == seg[:, None, :]))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = device_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * h * S + 4 * B * S
    bound_ms, bound_by = bound(*k1_cost(seg_np, nbytes, h, d))
    flops = k1_cost(seg_np, nbytes, h, d)[0]
    log(f"K1 D={d} at engine shape B={B} S={S}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
        f"{ms / bound_ms:.2f}x bound; eager {eager_ms:.4f} ms)  plain {plain_ms:.4f} ms  "
        f"sdpa {library_ms:.4f} ms ({ms / library_ms:.2f}x)  bound {bound_ms:.4f} ms ({bound_by})")
    del q, k, v, qt, kt, vt, mask
    # The training shape: one causal sequence per row.
    B, S = shp["train"]
    q = torch.randn(B, S, h, d, device=dev).bfloat16()
    k = torch.randn(B, S, kv, d, device=dev).bfloat16()
    v = torch.randn(B, S, kv, d, device=dev).bfloat16()
    worst = max(worst, _hold_k1(q, k, v, None, True, f"D={d} B={B} S={S} H={h} KV={kv} training shape causal=True"))
    t_ms = device_ms(lambda: att.flash_fwd(q, k, v, causal=True), iters=10)
    t_plain = time_ms(lambda: plain(q, k, v), iters=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    t_lib = device_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), iters=10)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * h * S
    t_flops = 4 * d * h * causal_pairs(np.zeros((B, S), np.int32))
    t_bound, t_by = bound(t_flops, nbytes)
    log(f"K1 D={d} at training shape B={B} S={S}: kernel {t_ms:.4f} ms ({t_flops / t_ms / 1e9:.1f} TFLOP/s, "
        f"{t_ms / t_bound:.2f}x bound)  plain {t_plain:.4f} ms  sdpa {t_lib:.4f} ms ({t_ms / t_lib:.2f}x)  "
        f"bound {t_bound:.4f} ms ({t_by})")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                train_shape=dict(ms=t_ms, plain_ms=t_plain, library_ms=t_lib, bound_ms=t_bound, bound_by=t_by))


def _paged_case(dev, rng, lengths, ps=PAGE, ppseq=K4_PPSEQ, h=H, kv=KV, d=D):
    import torch

    B = len(lengths)
    P_total = B * ppseq + 1
    kp = torch.randn(kv, P_total, ps, d, device=dev).bfloat16()
    vp = torch.randn(kv, P_total, ps, d, device=dev).bfloat16()
    q = torch.randn(B, h, d, device=dev).bfloat16()
    table = np.zeros((B, ppseq), np.int32)
    for b in range(B):
        n = math.ceil(lengths[b] / ps)
        table[b, :n] = rng.permutation(np.arange(1, P_total))[:n]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, lens, torch.from_numpy(table).to(dev)


def _check_k4(dev, rng, lengths, ps=PAGE, ppseq=K4_PPSEQ, h=H, kv=KV, case=None, d=D):
    """K4 against paged_attention_reference in fp32 on the same bf16 inputs.
    Returns (max |o - o_ref|, o, inputs)."""
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    case = case or _paged_case(dev, rng, lengths, ps, ppseq, h, kv, d)
    o = pa.paged_decode(*case)
    torch.cuda.synchronize()
    q, kp, vp, lens, table = case
    o_ref = pa.paged_attention_reference(q.float(), kp.float(), vp.float(), lens, table)
    err = (o.float() - o_ref).abs().max().item()
    zero_rows = all(not o[b].any().item() for b, n in enumerate(lengths) if n == 0)
    log(f"K4 D={d} B={len(lengths)} ps={ps} pages/seq={ppseq} H={h} KV={kv} lengths {min(lengths)}..{max(lengths)}: "
        f"max|o-ref| {err:.3e}  length-0 rows zero {zero_rows}")
    if not (err <= 2e-2 and zero_rows and bool(torch.isfinite(o).all())):
        raise AssertionError(f"K4 disagrees with its plain version at D={d} B={len(lengths)} ps={ps} H={h} KV={kv}")
    return err, o, case


def _k4_lengths(rng, B, ps, ppseq):
    """B 1: one sequence over most of its table; else 0, 1, two pages
    exactly, the full table and random lengths."""
    if B == 1:
        return [ppseq * ps - 3]
    lengths = rng.integers(1, ppseq * ps + 1, B)
    lengths[:4] = [0, 1, 2 * ps, ppseq * ps]
    return [int(n) for n in lengths]


def _time_k4(dev, rng, lengths, ppseq, h, kv, d):
    """K4 timed at a decode shape; 8 pool copies rotate so each launch reads
    its pages from device memory, as the engine's do (a layer apart)."""
    from ray_tpu_torch.ops import paged_attention as pa

    cases = [_paged_case(dev, rng, lengths, PAGE, ppseq, h, kv, d) for _ in range(8)]
    it = iter(range(1 << 30))

    def run(fn):
        return lambda: fn(*cases[next(it) % len(cases)])

    ms = device_ms(run(pa.paged_decode), iters=40)
    eager_ms = time_ms(run(pa.paged_decode), iters=40)
    plain_ms = time_ms(run(pa.paged_attention_reference), iters=40)
    B, tokens = len(lengths), int(sum(lengths))
    pages = int(sum(math.ceil(n / PAGE) for n in lengths))
    nbytes = 2 * tokens * kv * d * 2 + 2 * B * h * d * 2 + 4 * B + 4 * pages
    bound_ms, bound_by = bound(4 * h * d * tokens, nbytes)
    log(f"K4 D={d} at engine shape B={B} lengths {min(lengths)}..{max(lengths)}: kernel {ms:.4f} ms "
        f"({nbytes / ms / 1e6:.1f} GB/s, {ms / bound_ms:.2f}x bound; eager {eager_ms:.4f} ms)  "
        f"plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})")
    return dict(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by)


def _k4_determinism(dev, rng, lengths, ppseq, h, kv, d):
    """Two launches on the same inputs give the same bits, with a call at
    another batch size between them, and the ticket counters are back at 0."""
    import torch

    from ray_tpu_torch.ops import paged_attention as pa

    _, o1, case = _check_k4(dev, rng, lengths, PAGE, ppseq, h, kv, d=d)
    _check_k4(dev, rng, _k4_lengths(rng, 5, PAGE, ppseq), PAGE, ppseq, h, kv, d=d)
    o2 = pa.paged_decode(*case)
    torch.cuda.synchronize()
    same, reset = torch.equal(o1, o2), not pa._COUNTERS[o1.device].any().item()
    log(f"K4 D={d} determinism (B={len(lengths)}, two launches around a B=5 call): bitwise equal {same}  "
        f"counters at 0 {reset}")
    if not (same and reset):
        raise AssertionError(f"K4 at D={d} is not deterministic or left a ticket counter set")


def phase_k4(dev, rng):
    max_len = PAGE * K4_PPSEQ
    lengths = rng.integers(1, max_len + 1, K4_B)
    lengths[[0, 1, K4_B - 1]] = [0, 1, max_len]
    err, _, _ = _check_k4(dev, rng, [int(n) for n in lengths])
    for ps in K4_PAGES:
        for group in K4_GROUPS:
            for B in (1, K4_B):
                ppseq = max_len // ps if B == 1 else 8
                e, _, _ = _check_k4(dev, rng, _k4_lengths(rng, B, ps, ppseq), ps, ppseq, KV * group, KV)
                err = max(err, e)
    _k4_determinism(dev, rng, _k4_lengths(rng, K4_B, PAGE, K4_PPSEQ), K4_PPSEQ, H, KV, D)
    lengths = rng.integers(PROMPT_LEN + 1, PROMPT_LEN + MAX_TOKENS + 1, N_REQ)
    return dict(max_abs_err=err, **_time_k4(dev, rng, [int(n) for n in lengths], K4_PPSEQ, H, KV, D))


def phase_k4_big(dev, rng, d):
    """K4 at a large model's decode shape (K4_BIG[d]: D 128 at Mistral-7B's
    heads, group 4, 32 sequences of 1025..1152 tokens; D 256 at Gemma-2B's,
    group 8, 32 sequences of 2049..2176), page 128, and one sequence split
    over most of its table, the two-launch check, then the time at the
    decode shape."""
    import torch

    shp = K4_BIG[d]
    h, kv, ppseq = shp["h"], shp["kv"], shp["ppseq"]
    lo, hi = shp["lengths"]
    lengths = [int(n) for n in rng.integers(lo, hi + 1, 32)]
    err = max(_check_k4(dev, rng, lengths, PAGE, ppseq, h, kv, d=d)[0],
              _check_k4(dev, rng, _k4_lengths(rng, 1, PAGE, ppseq), PAGE, ppseq, h, kv, d=d)[0])
    _k4_determinism(dev, rng, lengths, ppseq, h, kv, d)
    out = dict(max_abs_err=err, **_time_k4(dev, rng, lengths, ppseq, h, kv, d))
    torch.cuda.empty_cache()
    return out


def _bwd_case(dev, B, S, seg=None, causal=True, h=H, kv=KV, d=D):
    import torch

    from ray_tpu_torch.ops import attention as att

    q = torch.randn(B, S, h, d, device=dev).bfloat16()
    k = torch.randn(B, S, kv, d, device=dev).bfloat16()
    v = torch.randn(B, S, kv, d, device=dev).bfloat16()
    do = torch.randn(B, S, h, d, device=dev).bfloat16()
    o, lse = att.flash_fwd(q, k, v, segment_ids=seg, causal=causal)
    return q, k, v, o, lse, do


def _check_k23(dev, B, S, seg, causal, worst, h=H, kv=KV, label="", d=D):
    """K3 and K2 (through flash_bwd) against flash_bwd_reference in fp32 on
    the same bf16 inputs."""
    q, k, v, o, lse, do = _bwd_case(dev, B, S, seg, causal, h, kv, d)
    _hold_k23(q, k, v, o, lse, do, seg, causal, worst, f"D={d} B={B} S={S} H={h} KV={kv} {label} causal={causal}")


def _hold_k23(q, k, v, o, lse, do, seg, causal, worst, desc):
    """One launch of K3 and K2 (through flash_bwd) on these inputs against
    flash_bwd_reference in fp32, one batch row at a time."""
    import torch

    from ray_tpu_torch.ops import attention as att

    got = att.flash_bwd(q, k, v, o, lse, do, segment_ids=seg, causal=causal)
    torch.cuda.synchronize()
    want = _bwd_rows(q.float(), k.float(), v.float(), o.float(), lse, do.float(), seg, causal)
    parts = []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g.float() - w).abs().max().item()
        top = w.abs().max().item()
        finite = bool(torch.isfinite(g).all())
        parts.append(f"{name} {err:.3e} (max|ref| {top:.2f})")
        if not (finite and err <= 2e-2 * top + 2e-2):
            raise AssertionError(f"K2/K3 {name} disagrees with its plain version at {desc}: {err} (max|ref| {top})")
        worst[name] = max(worst[name], err)
    log(f"K3/K2 {desc}: max|g-ref| " + "  ".join(parts))


def phase_k23(dev, rng, shp):
    """Phase 5 at one head dim (an entry of SHAPES)."""
    import torch

    from ray_tpu_torch.ops import attention as att

    h, kv, d = shp["h"], shp["kv"], shp["d"]
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for B, S in shp["k23"]:
        seg = torch.from_numpy(_seg(B, S, rng)).to(dev)
        for causal in (True, False):
            _check_k23(dev, B, S, seg, causal, worst, h, kv, "pad", d)
    for B, S, hh, kk, kind in shp["extra"]:
        seg = torch.from_numpy(_seg(B, S, rng, kind)).to(dev)
        for causal in (True, False):
            _check_k23(dev, B, S, seg, causal, worst, hh, kk, kind, d)
    torch.cuda.empty_cache()

    # Determinism: no atomics, a fixed summation order; two launches of each
    # kernel on the same inputs give the same bits.
    B, S = shp["det"]
    seg = torch.from_numpy(_seg(B, S, rng, "packed")).to(dev)
    q, k, v, o, lse, do = _bwd_case(dev, B, S, seg, True, h, kv, d)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous().view(B * h, S)
    runs = [(att.flash_bwd_dq(q, k, v, do, lse, delta, seg), *att.flash_bwd_dkv(q, k, v, do, lse, delta, seg))
            for _ in range(2)]
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    log(f"K3/K2 D={d} determinism (B={B} S={S} packed, two launches): dq {same[0]}  dk {same[1]}  dv {same[2]} "
        f"bitwise equal")
    if not all(same):
        raise AssertionError(f"K3/K2 at D={d} are not deterministic: two launches on the same inputs differ")
    del q, k, v, o, lse, do, delta, runs
    torch.cuda.empty_cache()

    # Timing at the training shape (causal, one sequence per row, as the
    # train phase runs them).
    B, S = shp["train"]
    q, k, v, o, lse, do = _bwd_case(dev, B, S, h=h, kv=kv, d=d)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous().view(B * h, S)
    dq_ms = device_ms(lambda: att.flash_bwd_dq(q, k, v, do, lse, delta), iters=10)
    dkv_ms = device_ms(lambda: att.flash_bwd_dkv(q, k, v, do, lse, delta), iters=10)
    plain = _bwd_rows if shp["rows"] else att.flash_bwd_reference
    plain_ms = time_ms(lambda: plain(q, k, v, o, lse, do), iters=3, warmup=1)
    torch.cuda.empty_cache()
    # The timed shape itself, held like the sweep (no new random draws).
    _hold_k23(q, k, v, o, lse, do, None, True, worst, f"D={d} B={B} S={S} H={h} KV={kv} train causal=True")
    torch.cuda.empty_cache()
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), iters=10)
    pairs = B * h * S * (S + 1) // 2
    io = 2 * (q.numel() + k.numel() + v.numel() + do.numel()) + 2 * 4 * B * h * S  # q k v dO, LSE delta
    dq_bound = bound(6 * d * pairs, io + 2 * q.numel())
    dkv_bound = bound(8 * d * pairs, io + 2 * (k.numel() + v.numel()))
    for name, ms, flops, (b_ms, b_by) in (("K3 (dQ)", dq_ms, 6 * d * pairs, dq_bound),
                                          ("K2 (dK,dV)", dkv_ms, 8 * d * pairs, dkv_bound)):
        log(f"{name} D={d} at training shape B={B} S={S}: kernel {ms:.4f} ms  {flops / ms / 1e9:.1f} TFLOP/s  "
            f"bound {b_ms:.4f} ms ({b_by})  {ms / b_ms:.2f}x bound")
    log(f"  K3 + K2 {dq_ms + dkv_ms:.4f} ms = {(dq_ms + dkv_ms) / library_ms:.2f}x sdpa backward (dq, dk, dv) "
        f"{library_ms:.4f} ms;  plain backward (dq, dk, dv) {plain_ms:.4f} ms")
    del q, k, v, o, lse, do, delta, qt, kt, vt, out, dot
    torch.cuda.empty_cache()
    common = dict(plain_ms=plain_ms, library_ms=library_ms,
                  plain_covers="flash_bwd_reference: dq, dk and dv in one call"
                               + (", one batch row at a time" if shp["rows"] else ""),
                  library_covers="scaled_dot_product_attention backward: dq, dk and dv in one call; "
                                 "compare with K3 + K2 together")
    return (dict(max_abs_err=worst["dq"], ms=dq_ms, bound_ms=dq_bound[0], bound_by=dq_bound[1], **common),
            dict(max_abs_err=max(worst["dk"], worst["dv"]), ms=dkv_ms, bound_ms=dkv_bound[0],
                 bound_by=dkv_bound[1], **common))


def phase_splash(dev, rng, k1_train, k3, k2):
    """K5, splash onto K1-K3: the kernels on splash's inputs (q folded with
    the softmax scale in fp32, scale 1.0), held against the plain version on
    the same inputs at B 2 x S 2048 with packed segments, then timed at the
    training shape beside the plain forward + backward and SDPA's."""
    import torch

    from ray_tpu_torch.ops import attention as att

    def inputs(B, S):
        """q folded as the splash wrapper folds it, k, v, dO."""
        q = (torch.randn(B, S, H, D, device=dev) * (1.0 / math.sqrt(D))).bfloat16()
        return q, *(torch.randn(B, S, n, D, device=dev).bfloat16() for n in (KV, KV, H))

    B, S = 2, TRAIN_S
    seg = torch.from_numpy(_seg(B, S, rng, "packed")).to(dev)
    qs, k, v, do = inputs(B, S)
    o, lse = att.flash_fwd(qs, k, v, segment_ids=seg, causal=True, scale=1.0)
    got = (o, *att.flash_bwd(qs, k, v, o, lse, do, segment_ids=seg, causal=True, scale=1.0))
    torch.cuda.synchronize()
    o_ref = att.mha_reference(qs.float(), k.float(), v.float(), causal=True, scale=1.0, segment_ids=seg)
    want = (o_ref, *att.flash_bwd_reference(qs.float(), k.float(), v.float(), o.float(), lse, do.float(),
                                            segment_ids=seg, causal=True, scale=1.0))
    errs = {}
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        errs[name] = (g.float() - w).abs().max().item()
        top = w.abs().max().item()
        if not (bool(torch.isfinite(g).all()) and errs[name] <= 2e-2 * top + 2e-2):
            raise AssertionError(f"splash {name} disagrees with its plain version: {errs[name]} (max|ref| {top})")
    log(f"splash (K1, K3, K2 on q * scale, scale 1.0) B={B} S={S} packed: max|g-ref| "
        + "  ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    del k, v, o, lse, do, qs, got, want, o_ref
    torch.cuda.empty_cache()

    B, S = TRAIN_B, TRAIN_S
    qs, k, v, do = inputs(B, S)
    o, lse = att.flash_fwd(qs, k, v, causal=True, scale=1.0)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous().view(B * H, S)
    t_fwd = device_ms(lambda: att.flash_fwd(qs, k, v, causal=True, scale=1.0), iters=10)
    t_dq = device_ms(lambda: att.flash_bwd_dq(qs, k, v, do, lse, delta, scale=1.0), iters=10)
    t_dkv = device_ms(lambda: att.flash_bwd_dkv(qs, k, v, do, lse, delta, scale=1.0), iters=10)
    plain_ms = time_ms(lambda: (att.mha_reference(qs, k, v, causal=True, scale=1.0),
                                att.flash_bwd_reference(qs, k, v, o, lse, do, scale=1.0)), iters=3, warmup=1)
    torch.cuda.empty_cache()
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (qs, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        out = sdpa(qt, kt, vt, is_causal=True, scale=1.0, enable_gqa=True)
        return torch.autograd.grad(out, (qt, kt, vt), dot)

    library_ms = time_ms(library, iters=10)
    ms = t_fwd + t_dq + t_dkv
    bound_ms = k1_train["bound_ms"] + k3["bound_ms"] + k2["bound_ms"]
    log(f"splash at training shape B={B} S={S}: K1 {t_fwd:.4f} + K3 {t_dq:.4f} + K2 {t_dkv:.4f} = {ms:.4f} ms  "
        f"plain forward + backward {plain_ms:.4f} ms  sdpa forward + backward {library_ms:.4f} ms  "
        f"bound {bound_ms:.4f} ms (operations)")
    del k, v, o, lse, do, qs, delta, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(errs.values()), ms=ms, ms_by_kernel={"K1": t_fwd, "K3": t_dq, "K2": t_dkv},
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by="operations",
                plain_covers="mha_reference + flash_bwd_reference on the folded q",
                library_covers="scaled_dot_product_attention forward + backward (scale 1.0) in one call each")


def _finished(done, n, vocab, max_tokens=None):
    """n requests finished at their token budget (default MAX_TOKENS), every
    token inside the vocabulary."""
    max_tokens = max_tokens or MAX_TOKENS
    return len(done) == n and all(len(ev["tokens"]) == max_tokens and ev["finish_reason"] == "length"
                                  and all(0 <= t < vocab for t in ev["tokens"]) for ev in done.values())


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, math.ceil(q * len(xs)) - 1)]


def drive(eng, prompts, max_tokens, prefix="r"):
    """Queues every prompt (ids prefix0, prefix1, ...), steps until all
    finish. Returns per-request results and the wall times of the run."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.add_request(f"{prefix}{i}", p, max_tokens)
    done, ttft = {}, {}
    while eng.has_work():
        for rid, ev in eng.step().items():
            if ev.get("ttft_s") is not None and rid not in ttft:
                ttft[rid] = ev["ttft_s"]
            if ev.get("finished"):
                done[rid] = ev
    torch.cuda.synchronize()
    return done, ttft, t0, time.perf_counter()


def serve_stats(done, ttft, t0, t1):
    """TTFT p50/p99, decode and overall tokens/s, wall time and peak device
    memory of one drive() of requests that all arrived at t0."""
    import torch

    n_tok = sum(len(ev["tokens"]) for ev in done.values())
    tt = sorted(ttft.values())
    # Every request arrives at t0 and the last first token lands at t0 + max
    # TTFT; from then on the engine only decodes.
    decode_s = t1 - t0 - max(tt)
    return dict(
        ttft_p50_ms=1e3 * statistics.median(tt),
        ttft_p99_ms=1e3 * _pct(tt, 0.99),
        decode_tok_s=(n_tok - len(done)) / decode_s,
        tok_s=n_tok / (t1 - t0),
        wall_s=t1 - t0,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )


def served_logits(eng, part):
    """The engine's own prefill logits at the last position of each prompt of
    `part` [m, P] (written to the dead page / idle slots)."""
    m, P = part.shape
    third = (np.zeros((m, P // eng.ec.page_size), np.int32) if eng.paged
             else np.arange(m, dtype=np.int64))
    return eng._prefill_logits(part, np.full(m, P, np.int32), third)


def check_first_tokens(cfg, eng, prompts, done, dev, tol_max=0.25, tol_mean=0.02, chunk=None, served=None):
    """The engine's prefill logits against the plain forward, and each
    request's first token against the plain logits' top-1; `chunk` prompts
    at a time (default all: the plain forward's fp32 scores grow with it).
    `served`: the prefill logits [n, V] another process's engine on the same
    weights computed (default: `eng`'s own)."""
    import torch

    from ray_tpu_torch.models.transformer import forward_hidden, linear

    n = len(prompts)
    chunk = chunk or n
    plain_cfg = dataclasses.replace(cfg, attention_impl="reference")
    plain, mine = [], []
    with torch.no_grad():
        for i in range(0, n, chunk):
            part = np.stack(prompts[i:i + chunk])
            toks = torch.tensor(part, dtype=torch.long, device=dev)
            # The plain forward's last position only: the [m, S, V] logits
            # at a 256000-entry vocabulary are 1 GB a 2048-token prompt in bf16.
            hidden = forward_hidden(eng.params, toks, plain_cfg)[0][:, -1]
            plain.append(linear(hidden, eng.params["lm_head"]).float())  # [m, V]
            if served is None:
                mine.append(served_logits(eng, part))
    plain = torch.cat(plain)
    served = torch.cat(mine) if served is None else served.to(dev).float()
    diff = (served - plain).abs()
    first = torch.tensor([done[f"r{i}"]["tokens"][0] for i in range(n)], device=dev)
    gap = plain.max(dim=-1).values - plain.gather(1, first[:, None])[:, 0]
    top1 = int((first == plain.argmax(dim=-1)).sum())
    log(f"  oracle: forward with attention_impl={plain_cfg.attention_impl!r} (einsum attention, no kernel)")
    log(f"  prefill logits vs plain forward: max|diff| {diff.max().item():.4f}  "
        f"mean|diff| {diff.mean().item():.5f}  first token top-1 {top1}/{n}  "
        f"worst top-1 gap {gap.max().item():.4f}")
    if not (bool(torch.isfinite(served).all()) and diff.max() <= tol_max and diff.mean() <= tol_mean
            and gap.max() <= tol_max):
        raise AssertionError("engine prefill disagrees with the plain forward")
    return dict(logits_max_diff=diff.max().item(), logits_mean_diff=diff.mean().item(), first_token_top1=top1,
                first_token_worst_gap=gap.max().item())


def phase_engine(dev, rng, profile_dir=None):
    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.ops import attention, paged_attention

    cfg = TransformerConfig(**MODEL)
    eng = LLMEngine(cfg, engine_config=EngineConfig(
        max_slots=SLOTS, max_seq=2048, kv_layout="paged", page_size=PAGE, seed=0))
    n_params = sum(t.numel() for t in [eng.params["embed"], eng.params["lm_head"],
                                       eng.params["final_norm"], *eng.params["layers"].values()])
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    log(f"engine: {n_params / 1e6:.1f}M params, paged KV, warmup {time.perf_counter() - t0:.2f} s")
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT_LEN).astype(np.int32) for _ in range(N_REQ)]
    torch.cuda.reset_peak_memory_stats()
    attention.LAUNCHES = paged_attention.LAUNCHES = 0
    done, ttft, t0, t1 = drive(eng, prompts, MAX_TOKENS)
    launches = {"flash_fwd": attention.LAUNCHES, "paged_decode": paged_attention.LAUNCHES}
    stats = serve_stats(done, ttft, t0, t1)
    log(f"engine paged: {len(done)} requests x {MAX_TOKENS} tokens, wall {stats['wall_s']:.3f} s, "
        f"TTFT p50 {stats['ttft_p50_ms']:.2f} ms p99 {stats['ttft_p99_ms']:.2f} ms, "
        f"decode {stats['decode_tok_s']:.1f} tok/s, overall {stats['tok_s']:.1f} tok/s, "
        f"peak mem {stats['peak_mem_gb']:.2f} GB")
    log(f"  launches on the main path: K1 {launches['flash_fwd']}  K4 {launches['paged_decode']}")
    if not _finished(done, N_REQ, cfg.vocab_size):
        raise AssertionError("paged engine run did not finish every request with max_tokens valid tokens")
    if not (launches["flash_fwd"] > 0 and launches["paged_decode"] > 0):
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")
    check_first_tokens(cfg, eng, prompts, done, dev)
    if profile_dir:
        profile_engine(eng, prompts, profile_dir)
    del eng
    torch.cuda.empty_cache()

    # Dense layout (the engine's default): prefill runs K1, decode is plain.
    dense = LLMEngine(cfg, engine_config=EngineConfig(max_slots=4, max_seq=2048, seed=0))
    dense.warmup(buckets=(PROMPT_LEN,))
    attention.LAUNCHES = paged_attention.LAUNCHES = 0
    d_done, d_ttft, d0, d1 = drive(dense, prompts[:4], 16)
    d_launch = (attention.LAUNCHES, paged_attention.LAUNCHES)
    log(f"engine dense: 4 requests x 16 tokens, wall {d1 - d0:.3f} s, "
        f"TTFT p50 {1e3 * statistics.median(d_ttft.values()):.2f} ms, launches K1 {d_launch[0]} K4 {d_launch[1]}")
    if not _finished(d_done, 4, cfg.vocab_size, max_tokens=16):
        raise AssertionError("dense engine run did not finish")
    if d_launch[0] == 0 or d_launch[1] != 0:
        raise AssertionError(f"dense run launches {d_launch}: expected K1 > 0 and K4 == 0")
    check_first_tokens(cfg, dense, prompts[:4], d_done, dev)
    tokens = {rid: list(ev["tokens"]) for rid, ev in done.items()}
    return stats, launches, (prompts, tokens)


def _cached_tail_logits(eng, prompt, start):
    """The engine's tail prefill of prompt[start:] over the cached pages of
    prompt[:start], as admission runs it; the tail's own K/V go to the dead
    page."""
    j = start // eng.ec.page_size
    row = np.zeros(eng.ppseq, np.int32)
    row[:j] = eng._prefix_cache[eng._prefix_digests(prompt[:start])[-1][1]]["pages"][:j]
    padded, ctx, tail_pages = eng._tail_args(row, prompt, start, len(prompt) - start)
    return eng._tail_prefill_logits(padded, start, len(prompt), ctx, tail_pages)


def phase_prefix(dev, rng, profile_dir=None):
    """Phase 6b: the prefix cache and chunked prefill on phase 6's model."""
    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models import TransformerConfig, forward
    from ray_tpu_torch.ops import attention, paged_attention

    cfg = TransformerConfig(**MODEL)
    V = cfg.vocab_size
    eng = LLMEngine(cfg, engine_config=EngineConfig(
        max_slots=SLOTS, max_seq=2048, kv_layout="paged", page_size=PAGE, seed=0,
        prefix_cache=True, chunked_prefill=CHUNK))
    eng.warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    # (a) shared system prompt: a chunked cold seed, partial hits, exact hits.
    sys_prompt = rng.integers(0, V, SYS_LEN).astype(np.int32)

    def with_tail(n):
        return np.concatenate([sys_prompt, rng.integers(0, V, n).astype(np.int32)])

    seed = with_tail(SEED_TAIL)
    hits = [with_tail(int(rng.integers(HIT_TAIL[0], HIT_TAIL[1] + 1))) for _ in range(N_HIT)]
    attention.LAUNCHES = paged_attention.LAUNCHES = 0
    d_seed, tt_seed, _, _ = drive(eng, [seed], MAX_TOKENS, "seed")
    d_hit, tt_hit, _, _ = drive(eng, hits, MAX_TOKENS, "hit")
    d_exact, tt_exact, _, _ = drive(eng, hits[:N_EXACT], MAX_TOKENS, "exact")
    launch_a = {"flash_fwd": attention.LAUNCHES, "paged_decode": paged_attention.LAUNCHES}
    stats_a = eng.prefix_cache_stats
    hit_ms, exact_ms = [1e3 * t for t in tt_hit.values()], [1e3 * t for t in tt_exact.values()]
    log(f"engine prefix (a): seed {SYS_LEN}+{SEED_TAIL} tokens (chunks of {CHUNK}) TTFT "
        f"{1e3 * tt_seed['seed0']:.2f} ms; {N_HIT} partial hits (tails {HIT_TAIL[0]}-{HIT_TAIL[1]}) TTFT "
        f"p50 {statistics.median(hit_ms):.2f} ms p99 {_pct(hit_ms, 0.99):.2f} ms; {N_EXACT} exact hits TTFT "
        f"p50 {statistics.median(exact_ms):.2f} ms p99 {_pct(exact_ms, 0.99):.2f} ms")
    log(f"  prefix_cache_stats {stats_a}  launches K1 {launch_a['flash_fwd']}  K4 {launch_a['paged_decode']}")
    if not (_finished(d_seed, 1, V) and _finished(d_hit, N_HIT, V) and _finished(d_exact, N_EXACT, V)):
        raise AssertionError("prefix run (a) did not finish every request with max_tokens valid tokens")
    want = {"misses": 1, "partial_hits": N_HIT, "hits": N_EXACT}
    if {k: stats_a[k] for k in want} != want:
        raise AssertionError(f"prefix_cache_stats {stats_a} after (a), expected {want}")
    if launch_a["flash_fwd"] != 0 or launch_a["paged_decode"] == 0:
        raise AssertionError(f"launches in (a) {launch_a}: expected K1 0 (tail prefills only) and K4 > 0")

    # (b) short prompts decoding while long prompts prefill chunk by chunk.
    shorts = [rng.integers(0, V, PROMPT_LEN).astype(np.int32) for _ in range(N_SHORT)]
    longs = [rng.integers(0, V, LONG_LEN).astype(np.int32) for _ in range(N_LONG)]
    groups = []  # prefill groups (each one K1 launch per layer)
    prefill = eng._prefill_batch_impl

    def counted(tokens, *a):
        groups.append(tokens.shape)
        return prefill(tokens, *a)

    eng._prefill_batch_impl = counted
    attention.LAUNCHES = paged_attention.LAUNCHES = 0
    for i, p in enumerate(shorts):
        eng.add_request(f"short{i}", p, MAX_TOKENS)
    done_b, steps, mid_steps, interleaved, mid_tokens, mid_s = {}, 0, 0, 0, 0, 0.0
    while eng.has_work():
        mid = bool(eng._prefilling)
        s0 = time.perf_counter()
        events = eng.step()
        dt = time.perf_counter() - s0
        steps += 1
        n_short = sum(len(ev.get("new_tokens", ())) for r, ev in events.items() if r.startswith("short"))
        if mid:
            mid_steps, mid_s, mid_tokens = mid_steps + 1, mid_s + dt, mid_tokens + n_short
            interleaved += n_short > 0
        done_b.update((r, ev) for r, ev in events.items() if ev.get("finished"))
        if steps == 1:  # the short requests decode now; the long prompts arrive
            for i, p in enumerate(longs):
                eng.add_request(f"long{i}", p, MAX_TOKENS)
    del eng._prefill_batch_impl  # back to the class's method
    launch_b = {"flash_fwd": attention.LAUNCHES, "paged_decode": paged_attention.LAUNCHES}
    decode_mid = mid_tokens / mid_s if mid_s else 0.0
    log(f"engine prefix (b): {N_SHORT} x {PROMPT_LEN}-token requests decoding, {N_LONG} x {LONG_LEN}-token "
        f"prompts chunked: {mid_steps} steps began mid-prefill, {interleaved} of them emitted short tokens; "
        f"decode {decode_mid:.1f} tok/s during those steps; prefill groups {len(groups)}; launches K1 "
        f"{launch_b['flash_fwd']}  K4 {launch_b['paged_decode']}")
    if not _finished(done_b, N_SHORT + N_LONG, V):
        raise AssertionError("prefix run (b) did not finish every request with max_tokens valid tokens")
    if interleaved < 2:
        raise AssertionError(f"decode emitted tokens in only {interleaved} steps that began mid-prefill")
    if launch_b["flash_fwd"] != cfg.n_layers * len(groups) or launch_b["paged_decode"] == 0:
        raise AssertionError(f"launches in (b) {launch_b}: expected K1 {cfg.n_layers} x {len(groups)} "
                             f"prefill groups and K4 > 0")
    wall_s = time.perf_counter() - t_phase
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # Logits against the plain forward over the whole prompt: the tail
    # prefill of every partial hit and of each chunked prompt's last chunk,
    # and every request's first token (exact hits: out of the decode block).
    plain_cfg = dataclasses.replace(cfg, attention_impl="reference")
    with torch.no_grad():
        def plain(p):
            return forward(eng.params, torch.tensor(p[None], dtype=torch.long, device=dev), plain_cfg)[0][:, -1].float()

        last_chunk = [(p, (len(p) - 1) // CHUNK * CHUNK) for p in [seed] + longs]
        tails = [(p, SYS_LEN) for p in hits] + last_chunk
        diff = torch.cat([(_cached_tail_logits(eng, p, s) - plain(p)).abs() for p, s in tails])
        prompts = {"seed0": seed, **{f"hit{i}": p for i, p in enumerate(hits)},
                   **{f"exact{i}": hits[i] for i in range(N_EXACT)},
                   **{f"short{i}": p for i, p in enumerate(shorts)}, **{f"long{i}": p for i, p in enumerate(longs)}}
        firsts = {**d_seed, **d_hit, **d_exact, **done_b}
        gaps = []
        for rid, p in prompts.items():
            lg = plain(p)[0]
            gaps.append((lg.max() - lg[firsts[rid]["tokens"][0]]).item())
    log(f"  tail prefill logits vs plain forward ({len(tails)} prompts: {N_HIT} partial hits, {len(last_chunk)} "
        f"last chunks): max|diff| {diff.max().item():.4f}  mean|diff| {diff.mean().item():.5f}; first tokens of "
        f"{len(gaps)} requests: worst top-1 gap {max(gaps):.4f}")
    if not (bool(torch.isfinite(diff).all()) and diff.max() <= 0.25 and diff.mean() <= 0.02 and max(gaps) <= 0.25):
        raise AssertionError("the prefix/chunked engine's logits disagree with the plain forward")

    # The page copy moves bytes unchanged, in every layer.
    src, dst = sorted(eng._page_refs)[:8], list(eng.free_pages)[:8]
    eng._copy_pages(src, dst)
    same = all(torch.equal(pool[:, :, eng._pool_rows(dst)], pool[:, :, eng._pool_rows(src)])
               for pool in (eng.k_pages, eng.v_pages))
    held = sum(len(sl.pages) for sl in eng.slots if sl is not None)
    conserved = len(eng.free_pages) + len(eng._page_refs) + held == eng.ec.total_pages - 1
    log(f"  page copy of {len(src)} pages bitwise equal {same}; pages conserved {conserved} "
        f"(free {len(eng.free_pages)}, cached {len(eng._page_refs)}, pool {eng.ec.total_pages - 1}); "
        f"phase wall {wall_s:.3f} s, peak mem {peak_gb:.2f} GB")
    if not (same and conserved):
        raise AssertionError("page copy not bitwise or pages not conserved")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        for i in range(N_HIT):
            eng.add_request(f"p{i}", with_tail(int(rng.integers(HIT_TAIL[0], HIT_TAIL[1] + 1))), MAX_TOKENS)
        _profile_window("prefix_admit_step", eng.step, profile_dir, ops=PREFIX_OPS)
        while eng.has_work():
            eng.step()
    del eng
    torch.cuda.empty_cache()
    stats = dict(
        ttft_seed_ms=1e3 * tt_seed["seed0"],
        ttft_partial_hit_p50_ms=statistics.median(hit_ms), ttft_partial_hit_p99_ms=_pct(hit_ms, 0.99),
        ttft_exact_hit_p50_ms=statistics.median(exact_ms), ttft_exact_hit_p99_ms=_pct(exact_ms, 0.99),
        decode_tok_s_mid_prefill=decode_mid, mid_prefill_steps=mid_steps, interleaved_steps=interleaved,
        prefix_cache_stats=stats_a, tail_logits_max_diff=diff.max().item(),
        tail_logits_mean_diff=diff.mean().item(), first_token_worst_gap=max(gaps),
        wall_s=wall_s, peak_mem_gb=peak_gb, launches_a=launch_a, launches_b=launch_b, prefill_groups_b=len(groups),
    )
    launches = {k: launch_a[k] + launch_b[k] for k in launch_a}
    return stats, launches


def _loss_grads(params, batch, cfg):
    import torch

    from ray_tpu_torch.models import cross_entropy_loss
    from ray_tpu_torch.models.transformer import leaves

    ps = leaves(params)
    loss = cross_entropy_loss(params, batch, cfg)
    return loss.item(), [g.float() for g in torch.autograd.grad(loss, ps)]


def _rel_errs(got, want):
    return [((g - w).norm() / w.norm().clamp(min=1e-30)).item() for g, w in zip(got, want)]


def phase_train(dev, card, profile_dir=None):
    import torch

    from ray_tpu_torch.models import TransformerConfig, make_train_step
    from ray_tpu_torch.models.transformer import init_params, leaves
    from ray_tpu_torch.ops import attention

    # (a) gradient parity at full width, depth cut to 2 layers.
    cfg = TransformerConfig(**{**MODEL, "n_layers": PARITY_LAYERS})
    g = torch.Generator(device=dev).manual_seed(1)
    params = init_params(cfg, g, device=dev)
    for t in leaves(params):
        t.requires_grad_(True)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (PARITY_B, TRAIN_S + 1), generator=g, device=dev)}
    loss_f, g_flash = _loss_grads(params, batch, dataclasses.replace(cfg, attention_impl="flash"))
    plain_cfg = dataclasses.replace(cfg, attention_impl="reference")
    loss_r, g_ref = _loss_grads(params, batch, plain_cfg)
    rel = _rel_errs(g_flash, g_ref)
    log(f"train parity ({PARITY_LAYERS} layers, B {PARITY_B} x S {TRAIN_S}, bf16): oracle attention_impl="
        f"{plain_cfg.attention_impl!r}; loss flash {loss_f:.5f} reference {loss_r:.5f}; "
        f"per-leaf |g-g_ref|/|g_ref| max {max(rel):.3e} mean {statistics.mean(rel):.3e}")
    if not (math.isfinite(loss_f) and abs(loss_f - loss_r) <= 1e-2 and max(rel) <= 5e-2):
        raise AssertionError(f"flash training gradients disagree with the plain path: {rel}")

    # (b) remat off / full / dots through the kernels.
    flash_cfg = dataclasses.replace(cfg, attention_impl="flash")
    remat = {}
    for policy in ("full", "dots"):
        _, g_r = _loss_grads(params, batch, dataclasses.replace(flash_cfg, remat=True, remat_policy=policy))
        remat[policy] = max(_rel_errs(g_r, g_flash))
    log(f"train remat parity (through K1-K3): max per-leaf relative difference vs remat off: "
        f"full {remat['full']:.3e}  dots {remat['dots']:.3e}")
    if max(remat.values()) > 5e-3:
        raise AssertionError(f"remat changes the gradients: {remat}")

    # (c) splash (K5) onto K1-K3: the same model and batch with
    # attention_impl="splash" against "flash".
    attention.LAUNCHES = attention.BWD_DQ_LAUNCHES = attention.BWD_DKV_LAUNCHES = 0
    loss_s, g_splash = _loss_grads(params, batch, dataclasses.replace(cfg, attention_impl="splash"))
    torch.cuda.synchronize()
    splash_launches = {"flash_fwd": attention.LAUNCHES, "flash_bwd_dq": attention.BWD_DQ_LAUNCHES,
                       "flash_bwd_dkv": attention.BWD_DKV_LAUNCHES}
    rel_s = _rel_errs(g_splash, g_flash)
    log(f"train splash parity ({PARITY_LAYERS} layers): loss splash {loss_s:.5f} flash {loss_f:.5f}; per-leaf "
        f"|g-g_flash|/|g_flash| max {max(rel_s):.3e}; launches in one loss + gradient: K1 "
        f"{splash_launches['flash_fwd']}  K3 {splash_launches['flash_bwd_dq']}  K2 {splash_launches['flash_bwd_dkv']}")
    if not (math.isfinite(loss_s) and abs(loss_s - loss_f) <= 5e-2 and max(rel_s) <= 5e-2):
        raise AssertionError(f"splash training gradients disagree with flash: loss {loss_s} vs {loss_f}, {rel_s}")
    if min(splash_launches.values()) == 0:
        raise AssertionError(f"splash did not run through K1-K3: {splash_launches}")
    del params, g_flash, g_ref, g_splash, batch
    torch.cuda.empty_cache()

    # (d) the bench.py:57-77 configuration, full width and depth.
    cfg = TransformerConfig(**MODEL, remat=True, remat_policy="dots")
    init_state, train_step = make_train_step(cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    state = init_state(g, device=dev)
    n_params = sum(t.numel() for t in leaves(state["params"]))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1), generator=g, device=dev)}
    t0 = time.perf_counter()
    first = train_step(state, batch)
    torch.cuda.synchronize()
    log(f"train: {n_params / 1e6:.1f}M params, remat {cfg.remat_policy!r}, B {TRAIN_B} x S {TRAIN_S}, "
        f"warmup step {time.perf_counter() - t0:.2f} s, loss {first['loss'].item():.4f}")
    torch.cuda.reset_peak_memory_stats()
    attention.LAUNCHES = attention.BWD_DQ_LAUNCHES = attention.BWD_DKV_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [train_step(state, batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = {"flash_fwd": attention.LAUNCHES, "flash_bwd_dq": attention.BWD_DQ_LAUNCHES,
                "flash_bwd_dkv": attention.BWD_DKV_LAUNCHES}
    losses = [m["loss"].item() for m in metrics]
    gnorms = [m["grad_norm"].item() for m in metrics]
    tokens = TRAIN_B * TRAIN_S
    flops = 6.0 * n_params * tokens + 12.0 * cfg.n_layers * cfg.d_model * TRAIN_S * tokens
    stats = dict(step_ms=dt * 1e3, tokens_per_s=tokens / dt, mfu=flops / dt / PEAK_BF16_FLOPS,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, loss_first=losses[0],
                 loss_last=losses[-1], card=card)
    log(f"train: {TRAIN_STEPS} steps, step {stats['step_ms']:.2f} ms, {stats['tokens_per_s']:.1f} tokens/s, "
        f"MFU {stats['mfu']:.4f} (6NT + 12LdST against 989 TFLOP/s), peak mem {stats['peak_mem_gb']:.2f} GB  "
        f"[{card}]")
    log(f"  loss {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"  grad_norm {' '.join(f'{x:.3f}' for x in gnorms)}")
    log(f"  launches in {TRAIN_STEPS} steps: K1 {launches['flash_fwd']}  K3 {launches['flash_bwd_dq']}  "
        f"K2 {launches['flash_bwd_dkv']}")
    if not all(math.isfinite(x) for x in losses + gnorms) or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss is not finite and falling: {losses}")
    want = {"flash_fwd": 2 * cfg.n_layers * TRAIN_STEPS, "flash_bwd_dq": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dkv": cfg.n_layers * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"kernel launches in {TRAIN_STEPS} training steps {launches} != {want}")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        _profile_window("train_step", lambda: train_step(state, batch), profile_dir)
    del state, batch
    torch.cuda.empty_cache()
    return stats, launches, splash_launches


def _count_calls(eng):
    """Counts the engine's prefill groups and decode steps from here on
    (each prefill group is one K1 launch per layer, each decode step one K4
    launch per layer). Returns (groups, steps, undo)."""
    groups, steps = [], []
    prefill, decode = eng._prefill_batch_impl, eng._decode

    def counted_prefill(tokens, *a):
        groups.append(tokens.shape)
        return prefill(tokens, *a)

    def counted_decode(n, gen):
        steps.append(n)
        return decode(n, gen)

    eng._prefill_batch_impl, eng._decode = counted_prefill, counted_decode

    def undo():
        del eng._prefill_batch_impl, eng._decode  # back to the class's methods

    return groups, steps, undo


def phase_big_serve(dev, rng, name, profile_dir=None):
    """Phase 6c (serve-mistral7b-paged) or 6d (serve-gemma2b-paged): the
    published shape of BIG[name] at full width and depth with seeded random
    weights through the paged engine (page 128), its requests all at once.
    K1 prefills and K4 decodes at the model's head dim."""
    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.models.transformer import leaves
    from ray_tpu_torch.ops import attention, paged_attention

    spec = BIG[name]["serve"]
    cfg = TransformerConfig(**BIG[name]["model"])
    t0 = time.perf_counter()
    eng = LLMEngine(cfg, engine_config=EngineConfig(
        max_slots=spec["slots"], max_seq=cfg.max_seq_len, kv_layout="paged", page_size=PAGE, seed=0))
    n_params = sum(t.numel() for t in leaves(eng.params))
    pool_gb = 2 * eng.k_pages.numel() * eng.k_pages.element_size() / 1e9
    eng.warmup(buckets=(spec["prompt"],))
    torch.cuda.synchronize()
    log(f"engine {name}: {n_params / 1e9:.3f}B params (bf16 {2 * n_params / 1e9:.1f} GB), head_dim {cfg.head_dim}, "
        f"paged KV {eng.ec.total_pages} pages x {PAGE} tokens ({pool_gb:.1f} GB), built and warmed up in "
        f"{time.perf_counter() - t0:.2f} s, memory {torch.cuda.memory_allocated() / 1e9:.1f} GB")
    n_req, n_tokens = spec["req"], spec["tokens"]
    prompts = [rng.integers(0, cfg.vocab_size, spec["prompt"]).astype(np.int32) for _ in range(n_req)]
    groups, steps, undo = _count_calls(eng)
    torch.cuda.reset_peak_memory_stats()
    attention.LAUNCHES = paged_attention.LAUNCHES = 0
    done, ttft, t0, t1 = drive(eng, prompts, n_tokens)
    launches = {"flash_fwd": attention.LAUNCHES, "paged_decode": paged_attention.LAUNCHES}
    undo()
    n_tok = sum(len(ev["tokens"]) for ev in done.values())
    tt = sorted(ttft.values())
    decode_s = t1 - t0 - max(tt)  # every request arrives at t0; after the last first token, decode only
    stats = dict(
        ttft_p50_ms=1e3 * statistics.median(tt),
        ttft_p99_ms=1e3 * _pct(tt, 0.99),
        decode_tok_s=(n_tok - n_req) / decode_s,
        tok_s=n_tok / (t1 - t0),
        wall_s=t1 - t0,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        n_params=n_params, head_dim=cfg.head_dim, prefill_groups=len(groups), decode_steps=sum(steps),
    )
    log(f"engine {name} paged: {len(done)} requests x {spec['prompt']} prompt x {n_tokens} tokens, wall "
        f"{stats['wall_s']:.3f} s, TTFT p50 {stats['ttft_p50_ms']:.2f} ms p99 {stats['ttft_p99_ms']:.2f} ms, "
        f"decode {stats['decode_tok_s']:.1f} tok/s, overall {stats['tok_s']:.1f} tok/s, "
        f"peak mem {stats['peak_mem_gb']:.2f} GB")
    want = {"flash_fwd": cfg.n_layers * len(groups), "paged_decode": cfg.n_layers * sum(steps)}
    log(f"  launches on the main path: K1 {launches['flash_fwd']}  K4 {launches['paged_decode']} "
        f"({len(groups)} prefill groups {groups[:1]}..., {sum(steps)} decode steps; expected {want})")
    if not _finished(done, n_req, cfg.vocab_size, max_tokens=n_tokens):
        raise AssertionError(f"{name} engine run did not finish every request with max_tokens valid tokens")
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"{name} launches {launches} != {want} (or a kernel never launched)")
    stats.update(check_first_tokens(cfg, eng, prompts, done, dev, chunk=spec["check_chunk"]))
    if profile_dir:
        profile_engine(eng, prompts, profile_dir, n_tokens, prefix=f"{name}_")
    del eng
    torch.cuda.empty_cache()
    return stats, launches


def _oai_text(rng, words, fits):
    """Seeded words appended one at a time until `fits(text)` says the
    encoded prompt is long enough (True), must stop (None) or is short
    (False)."""
    text = str(rng.choice(words))
    while True:
        ok = fits(text)
        if ok:
            return text
        if ok is None:
            raise AssertionError("a prompt passed the top of its token range")
        text += " " + str(rng.choice(words))


def _oai_idle(srv, what):
    """The engine holds no request and every page is back, within 2 s."""
    eng = srv._llm.engine
    t_end = time.perf_counter() + 2.0
    while True:
        s = srv.stats()
        pages = len(eng.free_pages)
        if s["active_slots"] == 0 and s["waiting"] == 0 and pages == eng.ec.total_pages - 1:
            return
        if time.perf_counter() > t_end:
            raise AssertionError(f"after {what}: {s}, free pages {pages} of {eng.ec.total_pages - 1}")
        time.sleep(0.01)


def _oai_frames(frames, t_call):
    """Reads an SSE stream to its end: every frame parses, the last is
    [DONE]. Returns (chunks, seconds from the call to the first frame)."""
    chunks, first = [], None
    for f in frames:
        if first is None:
            first = time.perf_counter() - t_call
        if not (f.startswith("data: ") and f.endswith("\n\n")):
            raise AssertionError(f"not an SSE frame: {f!r}")
        chunks.append(f[len("data: "):-2])
    if chunks[-1] != "[DONE]":
        raise AssertionError(f"stream did not end with [DONE]: {chunks[-1]!r}")
    return [json.loads(c) for c in chunks[:-1]], first


def _oai_corpus():
    """Phase 6e's seeded word list and tokenizer training text, and the
    random stream after them (6e draws its prompts from it)."""
    rng = np.random.default_rng(6)  # its own stream: the earlier phases keep theirs
    letters = list("abcdefghijklmnopqrstuvwxyz")
    words = ["".join(rng.choice(letters, int(rng.integers(2, 9)))) for _ in range(OAI_WORDS)]
    corpus = [" ".join(rng.choice(words, 12)) for _ in range(OAI_SENTENCES)]
    return rng, words, corpus


def phase_serve_openai(dev, engine_only):
    """Phase 6e (serve-openai-250M): phase 6's model at full width and depth
    served as text through OpenAIServer (tokenizer, chat template, SSE) over
    LLMServer's stepping thread, which launches K1 and K4. `engine_only`:
    phase 6's numbers on the same model, printed beside these."""
    import threading

    import torch

    from ray_tpu_torch import qos
    from ray_tpu_torch.llm import EngineConfig, OpenAIServer, Tokenizer, load_tokenizer
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.ops import attention, paged_attention

    rng, words, corpus = _oai_corpus()
    try:
        import jinja2  # noqa: F401  (OpenAIServer renders a jinja template with it)
        template = CHATML
    except ImportError:
        template = None  # the legacy "role: content" format
    cfg = TransformerConfig(**MODEL)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokenizer.json")
        Tokenizer.train(corpus, vocab_size=3 + 256 + OAI_MERGES).save(path)
        tok = load_tokenizer(path)
        t_tok = time.perf_counter() - t0
        t0 = time.perf_counter()
        srv = OpenAIServer(MODEL, dict(max_slots=SLOTS, max_seq=2048, kv_layout="paged", page_size=PAGE, seed=0),
                           tokenizer=path, model_name="serve-openai-250M",
                           warmup_buckets=EngineConfig().prefill_buckets, chat_template=template)
    torch.cuda.synchronize()
    llm, eng = srv._llm, srv._llm.engine
    log(f"serve-openai: tokenizer {tok.vocab_size} ids ({len(tok.merges)} merges, trained in {t_tok:.2f} s), "
        f"chat template {'ChatML (jinja2)' if template else 'legacy (no jinja2)'}, server built and warmed up "
        f"in {time.perf_counter() - t0:.2f} s")
    lo, hi = OAI_PROMPT

    def n_completion(text):
        n = len(tok.encode(text, add_bos=True))
        return True if lo <= n <= hi else (None if n > hi else False)

    def chat(text):
        return [{"role": "system", "content": "You answer in words."}, {"role": "user", "content": text}]

    def n_chat(text):
        prompt, templated = srv._chat_prompt(chat(text))
        n = len(tok.encode(prompt, add_bos=not templated))
        return True if lo <= n <= hi else (None if n > hi else False)

    bodies = {}  # (kind, i) -> what the client sends
    base = dict(max_tokens=MAX_TOKENS, ignore_eos=True, timeout_s=OAI_TIMEOUT_S)
    for i in range(OAI_PER_KIND):
        bodies["completions_stream_greedy", i] = dict(base, prompt=_oai_text(rng, words, n_completion),
                                                      stream=True, temperature=0.0)
        bodies["completions_stream_sampled", i] = dict(base, prompt=_oai_text(rng, words, n_completion),
                                                       stream=True, **OAI_SAMPLED)
        bodies["chat_greedy", i] = dict(base, messages=chat(_oai_text(rng, words, n_chat)), temperature=0.0)
        ids = tok.encode(_oai_text(rng, words, lambda t: len(tok.encode(t, add_bos=True)) >= hi), add_bos=True)
        bodies["tokens_greedy", i] = dict(tokens=ids[:hi], max_tokens=MAX_TOKENS, ignore_eos=True)
    n_prompt = [len(tok.encode(b["prompt"], add_bos=True)) for k, b in bodies.items() if "prompt" in b]
    n_prompt += [len(b["tokens"]) for b in bodies.values() if "tokens" in b]

    # Observe without changing: each request's arrival and the engine's TTFT
    # for it, each step's span, and the final event of every generate /
    # generate_stream call, by client thread.
    groups, steps, undo = _count_calls(eng)
    finals, engine_ttft, arrivals, timeline = {}, {}, {}, []
    step, add_request, generate, generate_stream = eng.step, eng.add_request, llm.generate, llm.generate_stream

    def observed_add(rid, *a, **kw):
        arrivals[rid] = time.perf_counter()
        return add_request(rid, *a, **kw)

    def observed_step():
        t, n_wait, g0, s0 = time.perf_counter(), len(eng.waiting), len(groups), sum(steps)
        events = step()
        timeline.append((t, time.perf_counter(), n_wait, [g[0] for g in groups[g0:]], sum(steps) - s0))
        for rid, ev in events.items():
            if ev.get("ttft_s") is not None:
                engine_ttft.setdefault(rid, ev["ttft_s"])
        return events

    def observed_generate(*a, **kw):
        out = generate(*a, **kw)
        finals[threading.current_thread().name] = out
        return out

    def observed_stream(*a, **kw):
        it = generate_stream(*a, **kw)
        try:
            for ev in it:
                if ev["finished"]:
                    finals[threading.current_thread().name] = ev
                yield ev
        finally:
            it.close()

    eng.step, eng.add_request = observed_step, observed_add
    llm.generate, llm.generate_stream = observed_generate, observed_stream
    if not srv.check_health():
        raise AssertionError("the stepping thread is not running")
    results, errors = {}, []
    barrier = threading.Barrier(len(bodies))

    def client(key):
        kind, _ = key
        body = bodies[key]
        try:
            barrier.wait(timeout=OAI_TIMEOUT_S)
            t_call = time.perf_counter()
            if kind == "tokens_greedy":
                with qos.request_context(timeout_s=OAI_TIMEOUT_S):
                    results[key] = dict(out=srv._llm(body), wall_s=time.perf_counter() - t_call)
            elif body.get("stream"):
                chunks, first = _oai_frames(srv(body), t_call)
                results[key] = dict(chunks=chunks, client_ttft_s=first, wall_s=time.perf_counter() - t_call)
            else:
                results[key] = dict(out=srv(body), wall_s=time.perf_counter() - t_call)
        except Exception as e:  # noqa: BLE001  (raised in the main thread below)
            errors.append((key, e))

    threads = [threading.Thread(target=client, args=(key,), name=f"{key[0]}-{key[1]}") for key in bodies]
    torch.cuda.reset_peak_memory_stats()
    attention.LAUNCHES = paged_attention.LAUNCHES = 0
    ttft_before = _ttft_count()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * OAI_TIMEOUT_S)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve-openai clients failed: {errors[:4]}")
    main_ttft, main_steps = dict(engine_ttft), list(timeline)
    ttft_observed = _ttft_count() - ttft_before
    if not srv.check_health():
        raise AssertionError("the stepping thread died during the traffic")

    # Gates on the 32: 64 tokens inside the vocabulary, finish "length".
    for key, r in results.items():
        kind, _ = key
        final = finals.get(f"{kind}-{key[1]}")
        if final is None or len(final["tokens"]) != MAX_TOKENS or final["finish_reason"] != "length" or \
                not all(0 <= t < cfg.vocab_size for t in final["tokens"]):
            raise AssertionError(f"{key}: engine result {final}")
        if kind == "tokens_greedy":
            out = r["out"]
            ok = out["tokens"] == final["tokens"] and out["finish_reason"] == "length"
        elif kind == "chat_greedy":
            out = r["out"]
            ok = (out["usage"]["completion_tokens"] == MAX_TOKENS and out["choices"][0]["finish_reason"] == "length"
                  and out["object"] == "chat.completion" and out["choices"][0]["message"]["role"] == "assistant")
        else:
            ch = r["chunks"]
            ok = (ch[-1]["choices"][0]["finish_reason"] == "length" and all(c["object"] == "text_completion"
                                                                           for c in ch)
                  and all(c["choices"][0]["finish_reason"] is None for c in ch[:-1]))
        if not ok:
            raise AssertionError(f"{key}: response {r}")
    n_req = len(results)
    tt = sorted(main_ttft.values())
    client_tt = sorted(r["client_ttft_s"] for r in results.values() if "client_ttft_s" in r)
    n_tok = n_req * MAX_TOKENS
    decode_s = t1 - t0 - max(tt)  # all released at t0; after the last first token, decode only
    peak = torch.cuda.max_memory_allocated() / 1e9

    # A token-level stream whose client leaves after 2 frames: aborted.
    frames = srv._llm(dict(bodies["tokens_greedy", 0], stream=True))
    two = [json.loads(next(frames)[len("data: "):]) for _ in range(2)]
    frames.close()
    if any(f["finished"] for f in two):
        raise AssertionError(f"the stream finished within 2 frames: {two}")
    _oai_idle(srv, "a stream closed after 2 frames")
    # A chat stream read to its end: the first chunk carries the role.
    chunks, _ = _oai_frames(srv(dict(bodies["chat_greedy", 0], stream=True)), time.perf_counter())
    if chunks[0]["choices"][0]["delta"].get("role") != "assistant" or \
            chunks[-1]["choices"][0]["finish_reason"] != "length":
        raise AssertionError(f"chat stream: first {chunks[0]}, last {chunks[-1]}")
    # A chat request whose deadline passes mid-decode: DeadlineExceeded, slot freed.
    try:
        srv(dict(bodies["chat_greedy", 1], timeout_s=OAI_DEADLINE_S))
    except qos.DeadlineExceeded:
        pass
    else:
        raise AssertionError(f"a {OAI_DEADLINE_S} s deadline did not raise DeadlineExceeded")
    _oai_idle(srv, f"a {OAI_DEADLINE_S} s deadline")
    if not srv.check_health():
        raise AssertionError("the stepping thread died")
    launches = {"flash_fwd": attention.LAUNCHES, "paged_decode": paged_attention.LAUNCHES}
    undo()
    del eng.step, eng.add_request, llm.generate, llm.generate_stream  # back to the class's methods
    want = {"flash_fwd": cfg.n_layers * len(groups), "paged_decode": cfg.n_layers * sum(steps)}
    log(f"  launches on the main path: K1 {launches['flash_fwd']}  K4 {launches['paged_decode']} "
        f"({len(groups)} prefill groups {sorted(g[0] for g in groups)}, {sum(steps)} decode steps; "
        f"expected {want})")
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"serve-openai launches {launches} != {want} (or a kernel never launched)")
    stats = dict(
        requests=n_req, prompt_tokens=[min(n_prompt), max(n_prompt)], max_tokens=MAX_TOKENS,
        client_ttft_p50_ms=1e3 * statistics.median(client_tt), client_ttft_p99_ms=1e3 * _pct(client_tt, 0.99),
        ttft_p50_ms=1e3 * statistics.median(tt), ttft_p99_ms=1e3 * _pct(tt, 0.99),
        decode_tok_s=(n_tok - n_req) / decode_s, tok_s=n_tok / (t1 - t0), wall_s=t1 - t0, peak_mem_gb=peak,
        serve_ttft_s_observed=ttft_observed, prefill_groups=len(groups), decode_steps=sum(steps),
        tokenizer_vocab=tok.vocab_size, chat_template="chatml-jinja" if template else "legacy",
    )
    log(f"serve-openai: {n_req} requests ({OAI_PER_KIND} each of {', '.join(OAI_KINDS)}), prompts "
        f"{min(n_prompt)}-{max(n_prompt)} tokens x {MAX_TOKENS}, wall {stats['wall_s']:.3f} s, client TTFT "
        f"(streams) p50 {stats['client_ttft_p50_ms']:.2f} ms p99 {stats['client_ttft_p99_ms']:.2f} ms, engine "
        f"TTFT p50 {stats['ttft_p50_ms']:.2f} ms p99 {stats['ttft_p99_ms']:.2f} ms, decode "
        f"{stats['decode_tok_s']:.1f} tok/s, overall {stats['tok_s']:.1f} tok/s, peak mem {peak:.2f} GB")
    arr = sorted(1e3 * (t - t0) for rid, t in arrivals.items() if rid in main_ttft)
    stats["arrival_ms"] = [arr[0], statistics.median(arr), arr[-1]]
    stats["steps"] = [dict(start_ms=1e3 * (a - t0), ms=1e3 * (b - a), waiting=w, prefill_k=k, decode=n)
                      for a, b, w, k, n in main_steps]
    log(f"  requests reach the engine {arr[0]:.2f} / {statistics.median(arr):.2f} / {arr[-1]:.2f} ms after "
        f"the release (first / median / last); steps (start ms, ms, waiting, prefill groups, decode steps): "
        + " ".join(f"({1e3 * (a - t0):.1f}, {1e3 * (b - a):.1f}, {w}, {k}, {n})" for a, b, w, k, n in main_steps[:8])
        + f" ... {len(main_steps)} steps")
    over = {k: stats[k] / engine_only[k] for k in ("ttft_p50_ms", "wall_s")}
    over.update({k: engine_only[k] / stats[k] for k in ("decode_tok_s", "tok_s")})
    log(f"  phase 6 (engine alone, same model and traffic shape): TTFT p50 {engine_only['ttft_p50_ms']:.2f} ms, "
        f"decode {engine_only['decode_tok_s']:.1f} tok/s, overall {engine_only['tok_s']:.1f} tok/s, wall "
        f"{engine_only['wall_s']:.3f} s; the serving surface's overhead (x): "
        + ", ".join(f"{k} {v:.3f}" for k, v in over.items()))
    stats["engine_only"] = {k: engine_only[k] for k in ("ttft_p50_ms", "ttft_p99_ms", "decode_tok_s", "tok_s",
                                                         "wall_s")}
    stats["overhead_x"] = over
    if ttft_observed != n_req:
        raise AssertionError(f"serve.ttft_s observed {ttft_observed} first tokens of {n_req} requests")
    # The token-level requests' first tokens against the plain forward.
    keys = [("tokens_greedy", i) for i in range(OAI_PER_KIND)]
    prompts = [np.asarray(bodies[k]["tokens"], np.int32) for k in keys]
    done = {f"r{i}": results[k]["out"] for i, k in enumerate(keys)}
    stats.update(check_first_tokens(cfg, eng, prompts, done, dev))
    stats["device_window"] = _oai_window(srv, eng, [bodies[k] for k in keys])
    srv.__raytpu_exit__()
    del srv, llm, eng
    torch.cuda.empty_cache()
    return stats, launches


def _oai_window(srv, eng, bodies):
    """6e's device window, after the timed run: `bodies` (token-level
    requests) sent together through LLMServer while tracing.profile_tpu
    runs in this thread, from their release until the stepping thread has
    ended the first step that prefilled and two more steps (one admission
    step and two decode blocks). The stepping thread's kernels are in the
    trace: CUPTI's device records cover the whole process, where
    torch.profiler's host ops cover only the thread that entered it."""
    import threading

    from ray_tpu_torch import qos
    from ray_tpu_torch.ops import attention, paged_attention
    from ray_tpu_torch.util import tracing

    step, steps, cond = eng.step, [], threading.Condition()

    def observed_step():
        k1 = attention.LAUNCHES
        events = step()
        with cond:
            steps.append(attention.LAUNCHES - k1)
            cond.notify_all()
        return events

    def admitted_and_two():
        first = next((i for i, n in enumerate(steps) if n), None)
        return first is not None and len(steps) >= first + 3

    outs, errors = [], []

    def client(body):
        try:
            with qos.request_context(timeout_s=OAI_TIMEOUT_S):
                outs.append(srv._llm(dict(body)))
        except Exception as e:  # noqa: BLE001  (raised below)
            errors.append(e)

    threads = [threading.Thread(target=client, args=(b,)) for b in bodies]
    eng.step = observed_step
    try:
        with tracing.profile_tpu(_window_dir("serve_openai")) as tr:
            c0 = (attention.LAUNCHES, paged_attention.LAUNCHES)
            for t in threads:
                t.start()
            with cond:
                if not cond.wait_for(admitted_and_two, timeout=OAI_TIMEOUT_S):
                    raise AssertionError(f"6e window: no admission and two more steps within {OAI_TIMEOUT_S} s "
                                         f"(steps' K1 launches {steps})")
                n_steps = len(steps)
            launched = {"flash_fwd": attention.LAUNCHES - c0[0], "paged_decode": paged_attention.LAUNCHES - c0[1]}
    finally:
        for t in threads:
            t.join(timeout=2 * OAI_TIMEOUT_S)
        del eng.step  # back to the class's method
    if errors or len(outs) != len(bodies):
        raise AssertionError(f"6e window requests failed: {errors[:4]}")
    row = _hold_window("6e (in process, one admission step and two decode blocks)", tr.path, tr.summary(),
                       launched, exact=False)
    row["steps"] = n_steps
    return row


# Phase 6f: the port's runtime. Transport sizes in bytes (64 KiB is inlined
# in the RPC reply, the others go through the shared-memory store), the
# store's capacity, and the resources of the session.
RT_SIZES = (64 << 10, 4 << 20, 256 << 20)
RT_STORE_BYTES = 2 << 30
RT_CPUS = 4
RT_TIMEOUT_S = 600.0


def _rt_transport(rt, dev):
    """6f(a): put and get CUDA tensors of each size in bf16 and fp32; each
    must come back on the card with the same bits. Times the put (D2H copy,
    serialization, write into shared memory) and the get (read, H2D copy)
    beside a bare .cpu() / .cuda() round trip of the same tensor; each the
    median of 3."""
    import torch

    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for nbytes in RT_SIZES:
            n = nbytes // torch.tensor([], dtype=dtype).element_size()
            x = torch.randn(n, device=dev).to(dtype)
            put_s, get_s, d2h_s, h2d_s = [], [], [], []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = rt.put(x)
                t1 = time.perf_counter()
                y = rt.get(ref, timeout=RT_TIMEOUT_S)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                if not (y.device.type == "cuda" and y.dtype == dtype and y.shape == x.shape
                        and torch.equal(y.view(torch.uint8), x.view(torch.uint8))):
                    raise AssertionError(f"transport of {nbytes} B {dtype} is not bitwise equal on the card "
                                         f"(got {y.device}, {y.dtype})")
                del ref, y
                t3 = time.perf_counter()
                h = x.cpu()
                t4 = time.perf_counter()
                z = h.cuda()
                torch.cuda.synchronize()
                t5 = time.perf_counter()
                del h, z
                put_s.append(t1 - t0)
                get_s.append(t2 - t1)
                d2h_s.append(t4 - t3)
                h2d_s.append(t5 - t4)
            row = dict(dtype=str(dtype).removeprefix("torch."), bytes=nbytes,
                       put_gb_s=nbytes / statistics.median(put_s) / 1e9,
                       get_gb_s=nbytes / statistics.median(get_s) / 1e9,
                       bare_d2h_gb_s=nbytes / statistics.median(d2h_s) / 1e9,
                       bare_h2d_gb_s=nbytes / statistics.median(h2d_s) / 1e9)
            rows.append(row)
            log(f"  transport {row['dtype']:>8} {nbytes / 2**20:8.3f} MiB: put {row['put_gb_s']:.3f} GB/s  "
                f"get {row['get_gb_s']:.3f} GB/s  (bare .cpu() {row['bare_d2h_gb_s']:.3f} GB/s, "
                f".cuda() {row['bare_h2d_gb_s']:.3f} GB/s), bitwise equal on the card")
            del x
    return rows


def _rt_k1_task(rt, dev, rng):
    """6f(b): a num_gpus=1 task runs K1 in its worker on refs of q, k, v at
    phase 6's prefill shape; its o must be bitwise equal to the driver's own
    K1 call on the same tensors. Returns the task worker's K1 launches."""
    import torch

    from ray_tpu_torch.ops import attention

    @rt.remote(num_gpus=1)
    def k1_task(q, k, v):
        import torch

        from ray_tpu_torch.ops import attention

        attention.LAUNCHES = 0
        o = attention.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        return o, attention.LAUNCHES, os.getpid()

    B, S = 8, PROMPT_LEN
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, D)).astype(np.float32)).to(dev, torch.bfloat16)
               for h in (H, KV, KV))
    refs = [rt.put(t) for t in (q, k, v)]
    o, launches, pid = rt.get(k1_task.remote(*refs), timeout=RT_TIMEOUT_S)
    mine = attention.flash_attention(q, k, v, causal=True)  # the comparison launch, off the path
    torch.cuda.synchronize()
    same = o.device.type == "cuda" and torch.equal(o.view(torch.int16), mine.view(torch.int16))
    log(f"  K1 in a num_gpus=1 task (worker pid {pid}, {launches} launch) on refs of q, k, v "
        f"[{B}, {S}, {H}/{KV}, {D}]: bitwise equal to the driver's K1: {same}")
    if pid == os.getpid() or launches != 1 or not same:
        raise AssertionError(f"K1 through a task: pid {pid}, launches {launches}, bitwise equal {same}")
    return launches


def phase_serve_runtime(dev, engine_only, phase6):
    """Phase 6f (serve-runtime-250M): phase 6's model, weights and prompts
    through the port's runtime: rt.init with a GPU resource, (a) CUDA tensor
    transport, (b) K1 in a num_gpus=1 task, (c) a num_gpus=1 actor that takes
    the whole parameter tree as one ObjectRef, builds phase 6's engine and
    serves phase 6's 32 prompts; its tokens must equal phase 6's.
    `engine_only`: phase 6's numbers, printed beside the actor's."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api as rt_api
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.models.transformer import cast_params, init_params
    from ray_tpu_torch.ops import attention, paged_attention

    prompts, want = phase6
    shm = "/dev/shm"
    if os.path.isdir(shm) and shutil.disk_usage(shm).free < RT_STORE_BYTES:
        raise RuntimeError(f"{shm} has {shutil.disk_usage(shm).free} bytes free: the object store of "
                           f"phase 6f needs {RT_STORE_BYTES} (the 250M model's weights are 496 MB in bf16)")
    rng = np.random.default_rng(7)  # its own stream: the earlier phases keep theirs
    t0 = time.perf_counter()
    rt.init(num_cpus=RT_CPUS, resources={"GPU": 1}, object_store_memory=RT_STORE_BYTES)
    try:
        log(f"runtime: rt.init {time.perf_counter() - t0:.2f} s, resources {rt.cluster_resources()}")
        transport = _rt_transport(rt, dev)
        attention.LAUNCHES = paged_attention.LAUNCHES = 0
        task_k1 = _rt_k1_task(rt, dev, rng)

        cfg = TransformerConfig(**MODEL)
        gen = torch.Generator(device=dev).manual_seed(0)  # phase 6's engine draws its weights so
        params = cast_params(init_params(cfg, gen, dev), cfg.dtype, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params_ref = rt.put(params)
        put_s = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()

        @rt.remote(num_gpus=1)
        class EngineActor:
            """Phase 6's engine inside a GPU actor."""

            def load(self, refs, cfg_kw, ec_kw):
                import torch

                import ray_tpu_torch as rt
                from ray_tpu_torch.llm import EngineConfig, LLMEngine
                from ray_tpu_torch.models import TransformerConfig

                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                params = rt.get(refs[0], timeout=RT_TIMEOUT_S)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                self.eng = LLMEngine(TransformerConfig(**cfg_kw), params=params,
                                     engine_config=EngineConfig(**ec_kw))
                del params
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                self.eng.warmup()
                torch.cuda.synchronize()
                return dict(get_s=t1 - t0, build_s=t2 - t1, warmup_s=time.perf_counter() - t2,
                            load_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                            pid=os.getpid(), device=torch.cuda.get_device_name(0))

            def serve(self, prompts, max_tokens):
                import torch

                from ray_tpu_torch.ops import attention, paged_attention

                torch.cuda.reset_peak_memory_stats()  # as phase 6 does before its drive
                attention.LAUNCHES = paged_attention.LAUNCHES = 0
                done, ttft, t0, t1 = drive(self.eng, prompts, max_tokens)
                launches = {"flash_fwd": attention.LAUNCHES, "paged_decode": paged_attention.LAUNCHES}
                tokens = {rid: list(ev["tokens"]) for rid, ev in done.items()}
                return tokens, serve_stats(done, ttft, t0, t1), launches, _finished(done, len(prompts),
                                                                                    MODEL["vocab_size"])

            def serve_traced(self, prompts, max_tokens, logdir):
                """serve() of an extra batch inside one tracing.profile_tpu
                window of this process; returns the trace's path and summary
                and the launches counted in the window."""
                from ray_tpu_torch.ops import attention, paged_attention
                from ray_tpu_torch.util import tracing

                attention.LAUNCHES = paged_attention.LAUNCHES = 0
                with tracing.profile_tpu(logdir) as tr:
                    done, _, t0, t1 = drive(self.eng, prompts, max_tokens, prefix="w")
                launches = {"flash_fwd": attention.LAUNCHES, "paged_decode": paged_attention.LAUNCHES}
                return (tr.path, tr.summary(), launches, t1 - t0,
                        _finished(done, len(prompts), MODEL["vocab_size"], max_tokens=max_tokens))

        actor = EngineActor.remote()
        ec_kw = dict(max_slots=SLOTS, max_seq=2048, kv_layout="paged", page_size=PAGE, seed=0)
        t0 = time.perf_counter()
        loaded = rt.get(actor.load.remote([params_ref], MODEL, ec_kw), timeout=RT_TIMEOUT_S)
        ref_to_engine_s = time.perf_counter() - t0
        log(f"  actor (pid {loaded['pid']}, {loaded['device']}): weights put {put_s:.3f} s; ref -> engine "
            f"{ref_to_engine_s:.3f} s (get {loaded['get_s']:.3f} s, build {loaded['build_s']:.3f} s, "
            f"warmup {loaded['warmup_s']:.3f} s, actor start included); peak mem while loading "
            f"{loaded['load_peak_mem_gb']:.2f} GB")
        tokens, stats, actor_launches, finished = rt.get(actor.serve.remote(prompts, MAX_TOKENS),
                                                         timeout=RT_TIMEOUT_S)
        driver_launches = (attention.LAUNCHES, paged_attention.LAUNCHES)
        launches = {"flash_fwd": task_k1 + actor_launches["flash_fwd"],
                    "paged_decode": actor_launches["paged_decode"]}
        equal = tokens == want
        log(f"  actor serving: {len(tokens)} requests x {MAX_TOKENS} tokens, wall {stats['wall_s']:.3f} s "
            f"(phase 6: {engine_only['wall_s']:.3f} s), TTFT p50 {stats['ttft_p50_ms']:.2f} ms p99 "
            f"{stats['ttft_p99_ms']:.2f} ms (phase 6: {engine_only['ttft_p50_ms']:.2f} / "
            f"{engine_only['ttft_p99_ms']:.2f}), decode {stats['decode_tok_s']:.1f} tok/s (phase 6: "
            f"{engine_only['decode_tok_s']:.1f}), actor peak mem {stats['peak_mem_gb']:.2f} GB")
        log(f"  launches on the path: K1 {launches['flash_fwd']} (task {task_k1}, actor "
            f"{actor_launches['flash_fwd']})  K4 {launches['paged_decode']}; in the driver K1 "
            f"{driver_launches[0]} (the comparison call) K4 {driver_launches[1]}")
        log(f"  greedy tokens equal to phase 6's on the same weights and prompts: {equal}")
        if not finished:
            raise AssertionError("the actor did not finish every request with max_tokens valid tokens")
        if not equal:
            bad = [rid for rid in want if tokens.get(rid) != want[rid]]
            raise AssertionError(f"the actor's tokens differ from phase 6's in {len(bad)} requests: {bad[:4]}")
        if not (actor_launches["flash_fwd"] > 0 and actor_launches["paged_decode"] > 0):
            raise AssertionError(f"a kernel of the actor's path was never launched: {actor_launches}")
        path, summary, w_launches, span_s, w_finished = rt.get(actor.serve_traced.remote(
            prompts[:WINDOW_6F_N], MAX_TOKENS, _window_dir("serve_runtime")), timeout=RT_TIMEOUT_S)
        if not w_finished:
            raise AssertionError("6f window: the actor did not finish the window's requests")
        window = _hold_window(f"6f (in the GPU actor, around its serve of {WINDOW_6F_N} prompts)", path, summary,
                              w_launches, exact=True, span_s=span_s)
        rt.kill(actor)
        del params_ref
        out = dict(stats, ref_to_engine_s=ref_to_engine_s, weights_put_s=put_s, **{
            f"actor_{k}": loaded[k] for k in ("get_s", "build_s", "warmup_s", "load_peak_mem_gb")},
            transport=transport, device_window=window,
            phase6=engine_only)
    finally:
        rt.shutdown()
    if rt_api._global_worker is not None or rt_api._LIVE_CLUSTERS:
        raise AssertionError("rt.shutdown() left the runtime up")
    return out, launches


# Phase 6g: serve on the runtime. The session's CPUs; how long a deployment
# may take to become healthy (its replicas start one after another, each
# fetching the weights, building its engine and warming up every prefill
# bucket); (a)'s replicas and their share of the card; (b)'s HTTP clients
# (APP_HTTP kinds, how many of each) and the deadline header of the 504.
APP_CPUS, APP_READY_S, APP_REPLICAS, APP_GPU_SHARE = 8, 600.0, 2, 0.5
APP_HTTP = (("completions_stream_greedy", 8), ("completions_greedy", 8), ("completions_stream_sampled", 4),
            ("completions_sampled", 4), ("chat_stream_greedy", 4), ("chat_greedy", 4))
APP_DEADLINE_HEADER = "0.0001"


def _counted(base):
    """A deployment class around `base` (LLMServer or OpenAIServer) whose
    replica reports the K1 / K4 launches of its own process, the requests
    its __call__ took and the engine's TTFT of each (observed on the
    engine's step events, as phase 6e observes, never changes), and can set
    them back to 0; also the wall-clock span of its server's construction
    (weights, engine, warmup). It can start the port's device-profiler
    listener in its process (tracing.profile_server) and report how many
    device capture sessions are open there."""

    class Counted(base):
        def __init__(self, *args, **kwargs):
            t0 = time.time()
            super().__init__(*args, **kwargs)
            self._init_wall = (t0, time.time())
            eng = self.engine if hasattr(self, "engine") else self._llm.engine
            step, self._ttft, self._served = eng.step, {}, 0

            def observed_step():
                events = step()
                for rid, ev in events.items():
                    if ev.get("ttft_s") is not None:
                        self._ttft.setdefault(rid, ev["ttft_s"])
                return events

            eng.step = observed_step

        def __call__(self, request):
            self._served += 1
            return super().__call__(request)

        def kernel_counts(self, reset=False):
            import torch

            from ray_tpu_torch.ops import attention, paged_attention

            out = dict(flash_fwd=attention.LAUNCHES, paged_decode=paged_attention.LAUNCHES,
                       served=self._served, pid=os.getpid(),
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, ttft_s=list(self._ttft.values()),
                       init_wall=self._init_wall)
            if reset:
                attention.LAUNCHES = paged_attention.LAUNCHES = 0
                self._served = 0
                self._ttft = {}
                torch.cuda.reset_peak_memory_stats()
            return out

        def start_profile_server(self):
            from ray_tpu_torch.util import tracing

            if getattr(self, "_profile_server", None) is None:
                self._profile_server = tracing.profile_server(0)  # a free port
            return self._profile_server.port

        def device_sessions(self):
            from ray_tpu_torch.obs import profiler

            return sum(1 for x in profiler.status()["sessions"] if x["kind"] == "device")

    Counted.__name__ = Counted.__qualname__ = f"Counted{base.__name__}"
    return Counted


def _app_run(rt, serve, app, counted, name, **kw):
    """serve.run of `app` with its class swapped for `counted` (the options
    and arguments its builder gave stay), bounded by APP_READY_S; a
    deployment that does not become healthy fails the phase, naming its
    status. Returns (handle, seconds to ready, the replica actors, the
    wall-clock time serve.run began)."""
    app.deployment = dataclasses.replace(app.deployment, func_or_class=counted)
    t_wall = time.time()
    t0 = time.perf_counter()
    try:
        handle = serve.run(app, name=name, timeout_s=APP_READY_S, **kw)
    except TimeoutError as e:
        raise AssertionError(f"serve app {name!r}: a replica did not become healthy within "
                             f"{APP_READY_S} s ({e})") from e
    ready_s = time.perf_counter() - t0
    info = rt.get(serve.api._get_controller().get_routing_info.remote(name, app.deployment.name), timeout=60)
    replicas = [rt.get_actor(n, namespace="serve") for n in info["replica_names"]]
    return handle, ready_s, replicas, t_wall


def _app_counts(rt, replicas, reset=False, since=None):
    """Each replica's kernel_counts; with `since` (the wall-clock start of
    serve.run), its construction span as seconds after it (init_s)."""
    counts = [rt.get(r.handle_request.remote("kernel_counts", (), {"reset": reset}), timeout=60) for r in replicas]
    for c in counts:
        a, b = c.pop("init_wall")
        if since is not None:
            c["init_s"] = [a - since, b - since]
    return counts


def _app_window(rt, handle, replica, prompts):
    """6g's device window, after (a)'s timed run: one replica starts the
    port's profile_server listener; one GET /capture runs a WINDOW_6G_S
    device capture in that replica's process; once its session is open,
    phase 6's prompts go through the handle again, and they must all finish
    before the capture ends. The replica's counts, set to 0 after the
    capture opened and read after the batch, are its launches in the
    window."""
    import threading
    import urllib.parse
    import urllib.request

    port = rt.get(replica.handle_request.remote("start_profile_server", (), {}), timeout=60)
    url = (f"http://127.0.0.1:{port}/capture?seconds={WINDOW_6G_S}&logdir="
           + urllib.parse.quote(_window_dir("serve_app")))
    reply = {}

    def capture():
        try:
            with urllib.request.urlopen(url, timeout=WINDOW_6G_S + RT_TIMEOUT_S) as r:
                reply.update(json.loads(r.read()))
        except Exception as e:  # noqa: BLE001  (raised below)
            reply["error"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=capture)
    t.start()
    t_end = time.perf_counter() + 60
    while rt.get(replica.handle_request.remote("device_sessions", (), {}), timeout=60) < 1:
        if time.perf_counter() > t_end or not t.is_alive():
            t.join()
            raise AssertionError(f"6g window: the replica's capture did not open: {reply}")
        time.sleep(0.05)
    _app_counts(rt, [replica], reset=True)
    t0 = time.perf_counter()
    outs = [r.result(timeout=RT_TIMEOUT_S) for r in
            [handle.remote({"tokens": p.tolist(), "max_tokens": MAX_TOKENS}) for p in prompts]]
    span_s = time.perf_counter() - t0
    counts = _app_counts(rt, [replica])[0]
    still_open = rt.get(replica.handle_request.remote("device_sessions", (), {}), timeout=60) >= 1
    t.join()
    if "error" in reply:
        raise AssertionError(f"6g window: the capture failed: {reply['error']}")
    if not still_open:
        raise AssertionError("6g window: the batch outlasted the capture; raise WINDOW_6G_S")
    if len(outs) != len(prompts) or counts["served"] < 1:
        raise AssertionError(f"6g window: {len(outs)} responses, the traced replica served {counts['served']}")
    summary = {k: reply[k] for k in ("device_ms", "wall_ms", "busy", "kernels", "device_events")}
    launched = {k: counts[k] for k in ("flash_fwd", "paged_decode")}
    row = _hold_window(f"6g (replica pid {counts['pid']} of (a), through profile_server, {WINDOW_6G_S} s "
                       f"capture; it served {counts['served']} of {len(prompts)})", reply["path"], summary,
                       launched, exact=True, span_s=span_s)
    row.update(served=counts["served"], capture_s=WINDOW_6G_S, route="profile_server in one replica of (a)")
    return row


def _app_post(port, path, body, headers=None):
    """One POST to the proxy. A stream is read line by line as it arrives:
    returns (status, payloads of its data lines, seconds to the first data
    line); otherwise (status, the JSON body, None)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=RT_TIMEOUT_S)
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, json.dumps(body), {"content-type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        if not body.get("stream") or resp.status != 200:
            return resp.status, json.loads(resp.read() or b"null"), None
        frames, first = [], None
        for line in iter(resp.readline, b""):
            if line.startswith(b"data: "):
                first = first if first is not None else time.perf_counter() - t0
                frames.append(line[len(b"data: "):].strip().decode())
            elif line.strip():
                raise AssertionError(f"not an SSE line: {line!r}")
        return resp.status, frames, first
    finally:
        conn.close()


def _app_text(kind, payload):
    """(text, finish_reason, completion tokens or None) of one response."""
    if "stream" in kind:
        if not payload or payload[-1] != "[DONE]":
            raise AssertionError(f"{kind}: stream did not end with [DONE]: {payload[-1:]}")
        chunks = [json.loads(f) for f in payload[:-1]]
        key = "delta" if kind.startswith("chat") else None
        text = "".join(c["choices"][0][key].get("content", "") if key else c["choices"][0]["text"]
                       for c in chunks)
        return text, chunks[-1]["choices"][0]["finish_reason"], None
    choice = payload["choices"][0]
    text = choice["message"]["content"] if kind.startswith("chat") else choice["text"]
    return text, choice["finish_reason"], payload["usage"]["completion_tokens"]


def phase_serve_app(dev, engine_only, phase6, oai):
    """Phase 6g (serve-app-250M): phase 6's model served through serve on the
    runtime: (a) build_llm_app from one weights ObjectRef, two replicas of
    half the card each, phase 6's 32 prompts through the handle (tokens must
    equal phase 6's); (b) build_openai_app behind the HTTP proxy, 32 client
    threads over HTTP, and a 504 for an expired request. `engine_only`,
    `oai`: phases 6 and 6e's numbers, printed beside these."""
    import threading

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core import api as rt_api
    from ray_tpu_torch.llm import EngineConfig, LLMServer, OpenAIServer, Tokenizer, load_tokenizer
    from ray_tpu_torch.llm import build_llm_app, build_openai_app
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.models.transformer import cast_params, init_params

    prompts, want = phase6
    rng = np.random.default_rng(8)  # its own stream: the earlier phases keep theirs
    cfg = TransformerConfig(**MODEL)
    ec = dict(max_slots=SLOTS, max_seq=2048, kv_layout="paged", page_size=PAGE, seed=0)
    buckets = EngineConfig().prefill_buckets
    t0 = time.perf_counter()
    rt.init(num_cpus=APP_CPUS, resources={"GPU": 1}, object_store_memory=RT_STORE_BYTES)
    try:
        serve.start()
        log(f"serve-app: rt.init + serve.start (controller, HTTP proxy on port {serve.http_port()}) "
            f"{time.perf_counter() - t0:.2f} s")
        # (a) build_llm_app from a weights ObjectRef: two replicas share the card.
        gen = torch.Generator(device=dev).manual_seed(0)  # phase 6's engine draws its weights so
        params_ref = rt.put(cast_params(init_params(cfg, gen, dev), cfg.dtype, dev))
        torch.cuda.empty_cache()
        app = build_llm_app(MODEL, ec, num_replicas=APP_REPLICAS, warmup_buckets=buckets,
                            ray_actor_options={"num_gpus": APP_GPU_SHARE}, params=params_ref)
        handle, ready_a, replicas, t_run = _app_run(rt, serve, app, _counted(LLMServer), "serve_app_llm",
                                                    http=False)
        if len(replicas) != APP_REPLICAS:
            raise AssertionError(f"(a) has {len(replicas)} replicas, not {APP_REPLICAS}")
        init_a = [c["init_s"] for c in _app_counts(rt, replicas, reset=True, since=t_run)]
        log(f"  (a) build_llm_app, {len(replicas)} replicas x num_gpus {APP_GPU_SHARE}, weights by ObjectRef: "
            f"serve.run -> healthy {ready_a:.2f} s; each replica's LLMServer (get, engine, warmup) built from "
            + ", ".join(f"+{a:.2f} to +{b:.2f} s" for a, b in init_a))
        t0 = time.perf_counter()
        resps = [handle.remote({"tokens": p.tolist(), "max_tokens": MAX_TOKENS}) for p in prompts]
        outs = [r.result(timeout=RT_TIMEOUT_S) for r in resps]
        t1 = time.perf_counter()
        counts_a = _app_counts(rt, replicas)
        for c in counts_a:
            del c["ttft_s"]  # (a)'s engine TTFTs come with the responses
        done = {f"r{i}": o for i, o in enumerate(outs)}
        tokens = {rid: list(o["tokens"]) for rid, o in done.items()}
        tt = sorted(o["ttft_s"] for o in outs)
        n_tok = sum(len(t) for t in tokens.values())
        stats_a = dict(ready_s=ready_a, replica_init_s=init_a, ttft_p50_ms=1e3 * statistics.median(tt), ttft_p99_ms=1e3 * _pct(tt, 0.99),
                       decode_tok_s=(n_tok - len(outs)) / (t1 - t0 - tt[-1]), tok_s=n_tok / (t1 - t0),
                       wall_s=t1 - t0, replicas=counts_a)
        bad = [rid for rid in want if tokens.get(rid) != want[rid]]
        log(f"  (a) {len(outs)} requests x {MAX_TOKENS} tokens through the handle, wall {stats_a['wall_s']:.3f} s "
            f"(phase 6: {engine_only['wall_s']:.3f} s), engine TTFT p50 {stats_a['ttft_p50_ms']:.2f} ms p99 "
            f"{stats_a['ttft_p99_ms']:.2f} ms, decode {stats_a['decode_tok_s']:.1f} tok/s (phase 6: "
            f"{engine_only['decode_tok_s']:.1f}); tokens equal to phase 6's in {len(want) - len(bad)}/{len(want)}")
        for c in counts_a:
            log(f"    replica pid {c['pid']}: served {c['served']}, K1 {c['flash_fwd']}, K4 {c['paged_decode']}, "
                f"peak mem {c['peak_mem_gb']:.2f} GB")
        if not _finished(done, N_REQ, cfg.vocab_size):
            raise AssertionError("(a) did not finish every request with max_tokens valid tokens")
        if bad:
            raise AssertionError(f"(a) tokens differ from phase 6's in {len(bad)} requests: {bad[:4]}")
        for c in counts_a:
            if c["served"] < 1 or c["flash_fwd"] == 0 or c["paged_decode"] == 0:
                raise AssertionError(f"(a) replica pid {c['pid']} served {c['served']} requests with K1 "
                                     f"{c['flash_fwd']} K4 {c['paged_decode']}: every replica must serve and "
                                     "launch both kernels")
        stats_a["device_window"] = _app_window(rt, handle, replicas[0], prompts)
        serve.delete("serve_app_llm")
        del params_ref, handle, replicas
        t_end = time.perf_counter() + 120
        while rt.available_resources().get("GPU", 0.0) < 1.0:
            if time.perf_counter() > t_end:
                raise AssertionError(f"serve.delete left the GPU share taken: {rt.available_resources()}")
            time.sleep(0.1)

        # (b) build_openai_app behind the HTTP proxy: one replica, the whole card.
        _, words, corpus = _oai_corpus()
        try:
            import jinja2  # noqa: F401  (the replica's OpenAIServer renders the template with it)
            template = CHATML
        except ImportError:
            template = None  # the legacy "role: content" format
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "tokenizer.json")
            Tokenizer.train(corpus, vocab_size=3 + 256 + OAI_MERGES).save(path)
            tok = load_tokenizer(path)
            app = build_openai_app(MODEL, ec, tokenizer=path, model_name="serve-app-250M", warmup_buckets=buckets,
                                   ray_actor_options={"num_gpus": 1}, chat_template=template)
            _, ready_b, replicas, t_run = _app_run(rt, serve, app, _counted(OpenAIServer), "serve_app_openai",
                                                   route_prefix="/")
            port = serve.http_port()
            init_b = [c["init_s"] for c in _app_counts(rt, replicas, reset=True, since=t_run)]
            log(f"  (b) build_openai_app, 1 replica x num_gpus 1 behind the proxy (port {port}): serve.run -> "
                f"healthy {ready_b:.2f} s; its OpenAIServer built from "
                + ", ".join(f"+{a:.2f} to +{b:.2f} s" for a, b in init_b))
            lo, hi = OAI_PROMPT

            def fits(text):
                n = len(tok.encode(text, add_bos=True))
                return True if lo <= n <= hi else (None if n > hi else False)

            base = dict(max_tokens=MAX_TOKENS, ignore_eos=True)
            greedy = [_oai_text(rng, words, fits) for _ in range(dict(APP_HTTP)["completions_greedy"])]
            bodies = {}
            for kind, n in APP_HTTP:
                for i in range(n):
                    sampling = dict(OAI_SAMPLED) if "sampled" in kind else dict(temperature=0.0)
                    if kind.startswith("chat"):
                        body = dict(base, messages=[{"role": "user", "content": _oai_text(rng, words, fits)}])
                    else:  # the greedy streamed and unstreamed completions share their prompts
                        prompt = greedy[i] if "greedy" in kind else _oai_text(rng, words, fits)
                        body = dict(base, prompt=prompt)
                    bodies[kind, i] = dict(body, stream="stream" in kind, **sampling)
            results, errors = {}, []
            barrier = threading.Barrier(len(bodies))

            def client(key):
                try:
                    barrier.wait(timeout=RT_TIMEOUT_S)
                    t_call = time.perf_counter()
                    route = "/v1/chat/completions" if key[0].startswith("chat") else "/v1/completions"
                    status, payload, first = _app_post(port, route, bodies[key])
                    results[key] = dict(status=status, payload=payload, first_s=first,
                                        wall_s=time.perf_counter() - t_call)
                except Exception as e:  # noqa: BLE001  (raised in the main thread below)
                    errors.append((key, e))

            threads = [threading.Thread(target=client, args=(key,)) for key in bodies]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=2 * RT_TIMEOUT_S)
            t1 = time.perf_counter()
            counts_b = _app_counts(rt, replicas)
            if errors or any(t.is_alive() for t in threads):
                raise AssertionError(f"(b) HTTP clients failed: {errors[:4]}")
            texts = {}
            for key, r in results.items():
                if r["status"] != 200:
                    raise AssertionError(f"(b) {key}: HTTP {r['status']}: {r['payload']}")
                text, finish, n_out = _app_text(key[0], r["payload"])
                if finish not in ("length", "stop") or (n_out is not None and finish == "length"
                                                         and n_out != MAX_TOKENS):
                    raise AssertionError(f"(b) {key}: finish {finish!r}, {n_out} completion tokens")
                texts[key] = text
            differ = [i for i in range(len(greedy))
                      if texts["completions_stream_greedy", i] != texts["completions_greedy", i]]
            client_tt = sorted(r["first_s"] for r in results.values() if r["first_s"] is not None)
            n_req = len(results)
            tt = sorted(t for c in counts_b for t in c.pop("ttft_s"))
            # All released at t0; after the last first token, decode only (phase 6e's measure).
            decode_b = n_req * (MAX_TOKENS - 1) / (t1 - t0 - tt[-1])
            # A request that has expired on arrival: the proxy maps the typed
            # DeadlineExceeded to 504.
            status, payload, _ = _app_post(port, "/v1/completions", dict(base, prompt=greedy[0]),
                                           headers={"x-request-timeout-s": APP_DEADLINE_HEADER})
            log(f"  (b) {n_req} HTTP requests ({', '.join(f'{n} {k}' for k, n in APP_HTTP)}), wall "
                f"{t1 - t0:.3f} s, client TTFT over HTTP (streams) p50 {1e3 * statistics.median(client_tt):.2f} ms "
                f"p99 {1e3 * _pct(client_tt, 0.99):.2f} ms (6e in process: {oai['client_ttft_p50_ms']:.2f} / "
                f"{oai['client_ttft_p99_ms']:.2f} ms), engine TTFT p50 {1e3 * statistics.median(tt):.2f} ms p99 "
                f"{1e3 * _pct(tt, 0.99):.2f} ms, decode {decode_b:.1f} tok/s (6e: {oai['decode_tok_s']:.1f}), "
                f"overall {n_req * MAX_TOKENS / (t1 - t0):.1f} tok/s; greedy streamed text == unstreamed in "
                f"{len(greedy) - len(differ)}/{len(greedy)}; "
                f"x-request-timeout-s {APP_DEADLINE_HEADER}: HTTP {status} {payload}")
            for c in counts_b:
                log(f"    replica pid {c['pid']}: served {c['served']}, K1 {c['flash_fwd']}, K4 "
                    f"{c['paged_decode']}, peak mem {c['peak_mem_gb']:.2f} GB")
            if differ:
                raise AssertionError(f"(b) greedy streamed text differs from the unstreamed text for prompts {differ}")
            if status != 504:
                raise AssertionError(f"(b) an expired request got HTTP {status}, not 504: {payload}")
            if any(c["flash_fwd"] == 0 or c["paged_decode"] == 0 or c["served"] != n_req for c in counts_b):
                raise AssertionError(f"(b) replica counts {counts_b}: K1 and K4 must run, and the replica must "
                                     f"take the {n_req} requests")
            stats_b = dict(ready_s=ready_b, replica_init_s=init_b, requests=n_req, wall_s=t1 - t0,
                           client_ttft_p50_ms=1e3 * statistics.median(client_tt),
                           client_ttft_p99_ms=1e3 * _pct(client_tt, 0.99),
                           ttft_p50_ms=1e3 * statistics.median(tt), ttft_p99_ms=1e3 * _pct(tt, 0.99),
                           decode_tok_s=decode_b, tok_s=n_req * MAX_TOKENS / (t1 - t0),
                           deadline_status=status, replicas=counts_b,
                           chat_template="chatml-jinja" if template else "legacy")
            serve.delete("serve_app_openai")
        serve.shutdown()
    finally:
        rt.shutdown()
    if rt_api._global_worker is not None or rt_api._LIVE_CLUSTERS:
        raise AssertionError("rt.shutdown() left the runtime up")
    launches = {k: sum(c[k] for c in counts_a + counts_b) for k in ("flash_fwd", "paged_decode")}
    out = dict(llm_app=stats_a, openai_app=stats_b,
               phase6={k: engine_only[k] for k in ("ttft_p50_ms", "ttft_p99_ms", "decode_tok_s", "wall_s")},
               phase6e={k: oai[k] for k in ("client_ttft_p50_ms", "client_ttft_p99_ms", "ttft_p50_ms",
                                            "decode_tok_s", "tok_s")})
    return out, launches


def _dag_qkv(seed):
    """Phase 6h's q, k, v on the current CUDA device from `seed`: phase 6's
    prefill shape (8 x 512, H 16, KV 4, D 64), bf16. The same seed gives the
    same bits in any process on the card (a CUDA generator)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    B, S = 8, PROMPT_LEN
    return tuple(torch.randn(B, S, h, D, device="cuda", generator=g).bfloat16() for h in (H, KV, KV))


def _dag_edges(rt):
    """The dag_shm_edges counter as the controller's metrics report it (the
    stage processes ship it on the reporter's tick)."""
    from ray_tpu_torch.core import api as rt_api

    core = rt_api._require_worker()
    m = core._run(core.controller.call("get_metrics", {}))
    return sum(x.get("value", 0) for x in (m if isinstance(m, list) else [])
               if isinstance(x, dict) and x.get("name") == "dag_shm_edges")


def phase_dag(dev, transport):
    """Phase 6h (dag-250M): a compiled DAG of two num_gpus=0.5 actors on the
    card (the session of 6f: GPU 1, the 2 GiB store in /dev/shm). Stage A
    makes q, k, v on the card from the execution's seed (phase 6's prefill
    shape, 12 MiB: above the inline cap, so the edge is the shared-memory
    channel); stage B runs K1 (flash_attention) on them and returns o.
    DAG_EXECS pipelined executions: each o within phase 3's K1 tolerance of
    the plain version on the same seeded inputs, stage B's process counts
    one K1 launch per execution, and dag_shm_edges ticks. Then a one-edge
    DAG carries bf16 CUDA tensors of DAG_SIZES (stage B checks their bits
    by an integer checksum): p50 execute latency and GB/s, printed beside
    6f's rt.put / rt.get (`transport`). Returns (stats, stage B's K1
    launches)."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api as rt_api
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.ops import attention as att

    @rt.remote(num_gpus=0.5)
    class Make:
        def qkv(self, seed):
            return _dag_qkv(seed)

        def tensor(self, nbytes):
            import torch

            g = torch.Generator(device="cuda").manual_seed(nbytes)
            return torch.randn(nbytes // 2, device="cuda", generator=g).bfloat16()

    @rt.remote(num_gpus=0.5)
    class Attend:
        def reset(self):
            from ray_tpu_torch.ops import attention

            attention.LAUNCHES = 0
            return os.getpid()

        def launches(self):
            from ray_tpu_torch.ops import attention

            return attention.LAUNCHES

        def run(self, qkv):
            from ray_tpu_torch.ops import attention

            return attention.flash_attention(*qkv, causal=True)

        def checksum(self, x):
            import torch

            return x.device.type, str(x.dtype), x.numel(), int(x.view(torch.int16).to(torch.int64).sum())

    t0 = time.perf_counter()
    rt.init(num_cpus=RT_CPUS, resources={"GPU": 1}, object_store_memory=RT_STORE_BYTES)
    try:
        make, attend = Make.remote(), Attend.remote()
        pid = rt.get(attend.reset.remote(), timeout=RT_TIMEOUT_S)
        log(f"dag: rt.init and two num_gpus=0.5 actors {time.perf_counter() - t0:.2f} s, resources "
            f"{rt.cluster_resources()}")
        with InputNode() as inp:
            out = attend.run.bind(make.qkv.bind(inp))
        dag = out.experimental_compile()
        edges0 = _dag_edges(rt)
        try:
            # Warm both stages (CUDA context, the kernel's load) off the count.
            dag.execute(DAG_EXECS).result(timeout=RT_TIMEOUT_S)
            rt.get(attend.reset.remote(), timeout=60)
            t0 = time.perf_counter()
            refs = [dag.execute(i) for i in range(DAG_EXECS)]
            outs = [r.result(timeout=RT_TIMEOUT_S) for r in refs]
            wall = time.perf_counter() - t0
            launches = rt.get(attend.launches.remote(), timeout=60)
        finally:
            dag.teardown()
        worst = 0.0
        for i, o in enumerate(outs):
            q, k, v = _dag_qkv(i)
            ref = att.mha_reference(q.float(), k.float(), v.float(), causal=True)
            err = (o.float() - ref).abs().max().item()
            if not (o.is_cuda and o.dtype == torch.bfloat16 and o.shape == q.shape and bool(torch.isfinite(o).all())
                    and err <= 2e-2):
                raise AssertionError(f"6h execution {i}: o on {o.device} {o.dtype} {tuple(o.shape)}, "
                                     f"max |o - ref| {err:.3e} (> 2e-2 or not finite)")
            worst = max(worst, err)
        del outs
        t_end = time.perf_counter() + 30
        edges = _dag_edges(rt) - edges0
        while edges < DAG_EXECS and time.perf_counter() < t_end:
            time.sleep(0.5)
            edges = _dag_edges(rt) - edges0
        log(f"  {DAG_EXECS} pipelined executions in {wall:.3f} s: o within 2e-2 of the plain version in all "
            f"(max |o - ref| {worst:.3e}); stage B (pid {pid}) launched K1 {launches} times; dag_shm_edges "
            f"+{edges:g}")
        if launches != DAG_EXECS:
            raise AssertionError(f"6h: stage B launched K1 {launches} times in {DAG_EXECS} executions")
        if edges < 1:
            raise AssertionError("6h: dag_shm_edges never ticked: the edge did not ride the shared-memory channel")

        # The one-edge DAG: bytes from stage A to stage B on the card.
        with InputNode() as inp:
            out = attend.checksum.bind(make.tensor.bind(inp))
        dag = out.experimental_compile()
        sweep = []
        by_size = {r["bytes"]: r for r in transport if r["dtype"] == "bfloat16"}
        try:
            for nbytes in DAG_SIZES:
                g = torch.Generator(device=dev).manual_seed(nbytes)
                x = torch.randn(nbytes // 2, device=dev, generator=g).bfloat16()
                want = ("cuda", "torch.bfloat16", nbytes // 2, int(x.view(torch.int16).to(torch.int64).sum()))
                del x
                lat = []
                for rep in range(DAG_REPS + 1):
                    t0 = time.perf_counter()
                    got = dag.execute(nbytes).result(timeout=RT_TIMEOUT_S)
                    if rep:
                        lat.append(time.perf_counter() - t0)
                    if tuple(got) != want:
                        raise AssertionError(f"6h edge of {nbytes} B: stage B saw {got}, want {want}")
                p50 = statistics.median(lat)
                row = dict(bytes=nbytes, p50_ms=1e3 * p50, gb_s=nbytes / p50 / 1e9)
                ref = by_size.get(nbytes)
                if ref is not None:
                    row.update(put_gb_s=ref["put_gb_s"], get_gb_s=ref["get_gb_s"])
                sweep.append(row)
                beside = (f" (6f bf16: put {ref['put_gb_s']:.3f} GB/s, get {ref['get_gb_s']:.3f} GB/s)"
                          if ref is not None else "")
                log(f"  one-edge DAG, bf16 CUDA tensor of {nbytes / 2**20:8.3f} MiB: execute p50 "
                    f"{row['p50_ms']:.3f} ms, {row['gb_s']:.3f} GB/s{beside}")
        finally:
            dag.teardown()
        rt.kill(make)
        rt.kill(attend)
    finally:
        rt.shutdown()
    if rt_api._global_worker is not None or rt_api._LIVE_CLUSTERS:
        raise AssertionError("rt.shutdown() left the runtime up")
    stats = dict(executions=DAG_EXECS, wall_s=wall, max_abs_err=worst, k1_launches_stage_b=launches,
                 shm_edges=edges, edge_sweep=sweep)
    return stats, {"flash_fwd": launches}


# Phase 6i: Data on the runtime. (a) batch_generate over phase 6's prompts as
# DATA_BLOCKS blocks on a pool of DATA_POOL actors, each a DATA_GPU_SHARE of
# the card; (b) INGEST_STEPS training steps fed by Data through
# prefetch_to_device, against the same batches moved by a plain .cuda().
DATA_BLOCKS, DATA_POOL, DATA_GPU_SHARE, INGEST_STEPS, INGEST_REPS = 4, 2, 0.5, 3, 5
INGEST_STREAM = 10  # the H2D rate at the training batch: its 3 batches, 10 times over
EOS = 2  # the default tokenizer's eos id, which batch_generate's engines stop on


def _data_udf(base):
    """A pool UDF around `base` (batch_generate's _EngineUDF) that only
    observes: each output row also carries its actor's pid, the call's number
    on that actor, the K1 / K4 launches of that call in the actor's own
    process, the actor's engine construction time and its peak memory."""

    class CountedUDF(base):
        def __init__(self, *args, **kwargs):
            import torch

            t0 = time.perf_counter()
            super().__init__(*args, **kwargs)
            torch.cuda.synchronize()
            self._init_s, self._calls = time.perf_counter() - t0, 0

        def __call__(self, rows):
            import torch

            from ray_tpu_torch.ops import attention, paged_attention

            k1, k4 = attention.LAUNCHES, paged_attention.LAUNCHES
            t0 = time.perf_counter()
            out = super().__call__(rows)
            torch.cuda.synchronize()
            self._calls += 1
            info = dict(_pid=os.getpid(), _call=self._calls, _k1=attention.LAUNCHES - k1,
                        _k4=paged_attention.LAUNCHES - k4, _call_s=time.perf_counter() - t0,
                        _init_s=self._init_s, _peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            return [dict(r, **info) for r in out]

    CountedUDF.__name__ = CountedUDF.__qualname__ = f"Counted{base.__name__}"
    return CountedUDF


def _data_batch(rt, rd, engine_only, phase6):
    """6i(a): batch_generate of phase 6's prompts on a pool of two GPU
    actors; returns (stats, launches by kernel)."""
    from ray_tpu_torch.llm import batch_generate
    from ray_tpu_torch.llm.batch import _EngineUDF
    from ray_tpu_torch.ops import attention, paged_attention

    prompts, want = phase6
    ds = rd.from_items([{"prompt": [int(t) for t in p], "i": i} for i, p in enumerate(prompts)],
                       parallelism=DATA_BLOCKS)
    out = batch_generate(ds, MODEL, dict(max_slots=SLOTS, max_seq=2048, kv_layout="paged", page_size=PAGE, seed=0),
                         {"max_tokens": MAX_TOKENS}, concurrency=DATA_POOL,
                         ray_remote_args={"num_gpus": DATA_GPU_SHARE})
    out._leaf.fn = _data_udf(_EngineUDF)  # the stage's options and arguments stay
    attention.LAUNCHES = paged_attention.LAUNCHES = 0
    rows, first_s = [], None
    t0 = time.perf_counter()
    for blk in out.iter_blocks():  # what take_all() does, with the first block's arrival
        if first_s is None:
            first_s = time.perf_counter() - t0
        rows.extend(blk.to_pylist())
    wall = time.perf_counter() - t0
    driver = (attention.LAUNCHES, paged_attention.LAUNCHES)
    rows.sort(key=lambda r: r["i"])
    calls = {(r["_pid"], r["_call"]): r for r in rows}
    actors = {}
    for (pid, _), r in sorted(calls.items()):
        a = actors.setdefault(pid, dict(blocks=0, rows=0, k1=0, k4=0, call_s=[], init_s=r["_init_s"]))
        a["blocks"] += 1
        a["k1"] += r["_k1"]
        a["k4"] += r["_k4"]
        a["call_s"].append(r["_call_s"])
        a["peak_mem_gb"] = max(a.get("peak_mem_gb", 0.0), r["_peak_mem_gb"])
    for r in rows:
        actors[r["_pid"]]["rows"] += 1
    # Phase 6's engine stops on no token; batch_generate's on the tokenizer's
    # eos: its tokens are phase 6's up to and with the first eos.
    expect = {}
    for i in range(len(prompts)):
        toks = want[f"r{i}"]
        expect[i] = toks[:toks.index(EOS) + 1] if EOS in toks else toks
    bad = [r["i"] for r in rows if r["generated_text_tokens"] != expect[r["i"]]]
    n_tok = sum(len(r["generated_text_tokens"]) for r in rows)
    stats = dict(rows=len(rows), blocks=len(calls), wall_s=wall, rows_per_s=len(rows) / wall,
                 tok_s=n_tok / wall, first_block_s=first_s, eos_cut=sum(EOS in want[f"r{i}"] for i in expect),
                 phase6_tok_s=engine_only["tok_s"],
                 actors=[dict(a, pid=pid) for pid, a in sorted(actors.items())])
    log(f"data (a): batch_generate of {len(rows)} rows in {len(calls)} blocks on {len(actors)} pool actors "
        f"(num_gpus {DATA_GPU_SHARE} each): wall {wall:.3f} s, {stats['rows_per_s']:.3f} rows/s, "
        f"{stats['tok_s']:.1f} output tok/s (phase 6's engine: {engine_only['tok_s']:.1f} tok/s), "
        f"take_all -> first block {first_s:.3f} s")
    for pid, a in sorted(actors.items()):
        log(f"  actor pid {pid}: {a['blocks']} blocks, {a['rows']} rows, engine construction {a['init_s']:.3f} s, "
            f"calls {' '.join(f'{x:.3f}' for x in a['call_s'])} s, K1 {a['k1']} K4 {a['k4']}, "
            f"peak mem {a['peak_mem_gb']:.2f} GB")
    log(f"  tokens equal to phase 6's (cut at eos in {stats['eos_cut']}): {not bad}; launches in the driver: "
        f"K1 {driver[0]} K4 {driver[1]}")
    if len(rows) != len(prompts) or sorted(r["i"] for r in rows) != list(range(len(prompts))):
        raise AssertionError(f"6i: batch_generate returned {len(rows)} rows for {len(prompts)} prompts")
    if bad:
        raise AssertionError(f"6i: {len(bad)} rows' tokens differ from phase 6's: rows {bad[:4]}")
    if len(actors) != DATA_POOL or min(a["blocks"] for a in actors.values()) < 1:
        raise AssertionError(f"6i: blocks by actor {[a['blocks'] for a in actors.values()]}: "
                             f"both pool actors must take blocks")
    if not all(a["k1"] > 0 and a["k4"] > 0 for a in actors.values()) or driver != (0, 0):
        raise AssertionError(f"6i: K1/K4 by actor {[(a['k1'], a['k4']) for a in actors.values()]}, "
                             f"in the driver {driver}: both must launch in every pool actor, none in the driver")
    launches = {"flash_fwd": sum(a["k1"] for a in actors.values()),
                "paged_decode": sum(a["k4"] for a in actors.values())}
    return stats, launches


def _data_ingest(rd, dev, card):
    """6i(b): INGEST_STEPS training steps at the training cell's shape fed
    from rd.from_numpy through iter_torch_batches and prefetch_to_device,
    then the same steps from a fresh state on the same batches moved by a
    plain .cuda(): the losses must be bitwise equal. Returns (stats, the
    infeed run's launches)."""
    import torch

    from ray_tpu_torch.data import prefetch_to_device
    from ray_tpu_torch.models import TransformerConfig, make_train_step
    from ray_tpu_torch.ops import attention

    cfg = TransformerConfig(**MODEL, remat=True, remat_policy="dots")
    rng = np.random.default_rng(12)
    arrays = [rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1), dtype=np.int32) for _ in range(INGEST_STEPS)]
    ds = rd.from_numpy(arrays)
    plain = [{"tokens": torch.from_numpy(a).to(torch.int64).cuda()} for a in arrays]

    def run(batches):
        init_state, train_step = make_train_step(cfg)
        state = init_state(torch.Generator(device=dev).manual_seed(0), device=dev)
        losses, seen = [], []
        for b in batches:
            seen.append(b["tokens"])
            losses.append(train_step(state, b)["loss"].detach())
        torch.cuda.synchronize()
        del state
        return torch.stack(losses), seen

    attention.LAUNCHES = attention.BWD_DQ_LAUNCHES = attention.BWD_DKV_LAUNCHES = 0
    fed = prefetch_to_device(ds.iter_torch_batches(batch_size=TRAIN_B), device=dev,
                             transform=lambda b: {"tokens": b["data"]})
    l_fed, seen = run(fed)
    launches = {"flash_fwd": attention.LAUNCHES, "flash_bwd_dq": attention.BWD_DQ_LAUNCHES,
                "flash_bwd_dkv": attention.BWD_DKV_LAUNCHES}
    torch.cuda.empty_cache()
    l_plain, _ = run(plain)
    torch.cuda.empty_cache()
    same_tokens = len(seen) == INGEST_STEPS and all(
        x.is_cuda and x.dtype == y["tokens"].dtype and torch.equal(x, y["tokens"]) for x, y in zip(seen, plain))
    same_loss = torch.equal(l_fed, l_plain)

    # H2D rates: the infeed beside a bare .cuda() of the same batches, each
    # over one stream of many batches (steady state, as a training loop
    # sees it), at the training batch and at 64 MiB a batch.
    host = [{"data": np.array(b["data"])} for b in ds.iter_batches(batch_size=TRAIN_B)]  # writable
    h2d = {"train_batch": _h2d_rates(dev, host * INGEST_STREAM),
           "64MiB": _h2d_rates(dev, [{"data": np.full(16 << 20, i, np.float32)} for i in range(3)])}
    want = {"flash_fwd": 2 * cfg.n_layers * INGEST_STEPS, "flash_bwd_dq": cfg.n_layers * INGEST_STEPS,
            "flash_bwd_dkv": cfg.n_layers * INGEST_STEPS}
    stats = dict(steps=INGEST_STEPS, batch=[TRAIN_B, TRAIN_S + 1], losses_fed=l_fed.tolist(),
                 losses_plain=l_plain.tolist(), bitwise_equal=same_loss, h2d=h2d, card=card)
    log(f"data (b): {INGEST_STEPS} training steps (B {TRAIN_B} x S {TRAIN_S}) fed by rd.from_numpy -> "
        f"iter_torch_batches -> prefetch_to_device: losses {' '.join(f'{x:.6f}' for x in stats['losses_fed'])}; "
        f"plain .cuda(): {' '.join(f'{x:.6f}' for x in stats['losses_plain'])}; bitwise equal {same_loss}; "
        f"tokens equal {same_tokens}")
    for name, r in h2d.items():
        log(f"  H2D {name}: {r['batches']} batches of {r['batch_bytes']} B in one stream: infeed "
            f"{r['infeed_gb_s']:.3f} GB/s, bare .cuda() {r['bare_cuda_gb_s']:.3f} GB/s (median of {INGEST_REPS})  "
            f"[{card}]")
    log(f"  launches K1 {launches['flash_fwd']} K3 {launches['flash_bwd_dq']} K2 {launches['flash_bwd_dkv']}")
    if not same_tokens:
        raise AssertionError("6i(b): the infeed's token batches differ from the seeded arrays")
    if not (same_loss and bool(torch.isfinite(l_fed).all())):
        raise AssertionError(f"6i(b): losses through the infeed {l_fed.tolist()} are not bitwise equal to the "
                             f"plain feed's {l_plain.tolist()}")
    if launches != want:
        raise AssertionError(f"6i(b): launches in {INGEST_STEPS} steps {launches} != {want}")
    return stats, launches


def _h2d_rates(dev, batches):
    """GB/s of prefetch_to_device over `batches` (one generator) beside a
    bare .cuda() of each, the median of INGEST_REPS; the two copies must
    be equal."""
    import torch

    from ray_tpu_torch.data import prefetch_to_device

    nbytes = sum(b["data"].nbytes for b in batches)
    fed_s, bare_s = [], []
    for _ in range(INGEST_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = list(prefetch_to_device(iter(batches), device=dev))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = [torch.from_numpy(b["data"]).cuda() for b in batches]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fed_s.append(t1 - t0)
        bare_s.append(t2 - t1)
        if not all(torch.equal(g["data"], r) for g, r in zip(got, ref)):
            raise AssertionError("6i(b): the infeed's batch differs from the bare .cuda() copy")
        del got, ref
    return dict(batches=len(batches), batch_bytes=nbytes // len(batches),
                infeed_gb_s=nbytes / statistics.median(fed_s) / 1e9,
                bare_cuda_gb_s=nbytes / statistics.median(bare_s) / 1e9)


def phase_data(dev, card, engine_only, phase6):
    """Phase 6i (data-batch-250M): Data on the port's runtime, rt.init(GPU 1,
    the 2 GiB store). (a) batch_generate over phase 6's 32 prompts on a pool
    of two num_gpus=0.5 actors (gates: every row's tokens equal phase 6's,
    both actors took blocks, K1 and K4 launched in each actor's process and
    none in the driver); (b) the training step fed through the infeed
    (gate: losses bitwise equal to a plain .cuda() feed). Returns (stats,
    (a)'s launches, (b)'s launches)."""
    import ray_tpu_torch as rt
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.core import api as rt_api

    t0 = time.perf_counter()
    rt.init(num_cpus=RT_CPUS, resources={"GPU": 1}, object_store_memory=RT_STORE_BYTES)
    try:
        log(f"data: rt.init {time.perf_counter() - t0:.2f} s, resources {rt.cluster_resources()}")
        batch, b_launches = _data_batch(rt, rd, engine_only, phase6)
        ingest, i_launches = _data_ingest(rd, dev, card)
    finally:
        rt.shutdown()
    if rt_api._global_worker is not None or rt_api._LIVE_CLUSTERS:
        raise AssertionError("rt.shutdown() left the runtime up")
    return dict(batch=batch, ingest=ingest), b_launches, i_launches


def _ttft_count():
    """Observations in this process's serve.ttft_s histogram."""
    from ray_tpu_torch.util import metrics

    return sum(s.get("n", 0) for s in metrics.snapshot() if s["name"] == "serve.ttft_s")


def phase_big_train(dev, card, name, profile_dir=None):
    """Phase 7e (train-mistral7b-4L) or 7f (train-gemma2b-4L): the gradient
    check at BIG[name]'s widths (2 layers, B 1 x S 2048, K1-K3 at the
    model's head dim against the plain path), then make_train_step on the
    same widths cut to a few layers (remat "dots", AdamW, one seeded batch):
    a warmup step and TRAIN_STEPS timed steps."""
    import warnings

    import torch

    from ray_tpu_torch.models import TransformerConfig, make_train_step
    from ray_tpu_torch.models.transformer import init_params, leaves
    from ray_tpu_torch.ops import attention

    model, par, tr = BIG[name]["model"], BIG[name]["parity"], BIG[name]["train"]
    cfg = TransformerConfig(**{**model, "n_layers": par["layers"]})
    g = torch.Generator(device=dev).manual_seed(par["seed"])
    params = init_params(cfg, g, device=dev)
    for t in leaves(params):
        t.requires_grad_(True)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (par["b"], par["s"] + 1), generator=g, device=dev)}
    attention.LAUNCHES = attention.BWD_DQ_LAUNCHES = attention.BWD_DKV_LAUNCHES = 0
    loss_f, g_flash = _loss_grads(params, batch, dataclasses.replace(cfg, attention_impl="flash"))
    parity_launches = (attention.LAUNCHES, attention.BWD_DQ_LAUNCHES, attention.BWD_DKV_LAUNCHES)
    plain_cfg = dataclasses.replace(cfg, attention_impl="reference")
    loss_r, g_ref = _loss_grads(params, batch, plain_cfg)
    rel = _rel_errs(g_flash, g_ref)
    log(f"train {name} parity ({par['layers']} layers, B {par['b']} x S {par['s']}, bf16, D {cfg.head_dim}): "
        f"oracle attention_impl={plain_cfg.attention_impl!r}; loss flash {loss_f:.5f} reference {loss_r:.5f}; "
        f"per-leaf |g-g_ref|/|g_ref| max {max(rel):.3e} mean {statistics.mean(rel):.3e}; launches K1/K3/K2 "
        f"{parity_launches}")
    if not (math.isfinite(loss_f) and abs(loss_f - loss_r) <= 1e-2 and max(rel) <= 5e-2):
        raise AssertionError(f"{name} flash training gradients disagree with the plain path: {rel}")
    if parity_launches != (par["layers"],) * 3:
        raise AssertionError(f"the parity step did not run K1, K3, K2 once per layer: {parity_launches}")
    del params, g_flash, g_ref, batch
    torch.cuda.empty_cache()

    B, S = tr["b"], tr["s"]
    if tr["ce_chunk"] and S % tr["ce_chunk"]:
        raise AssertionError(f"ce_chunk {tr['ce_chunk']} does not divide S {S}: the loss would materialise logits")
    cfg = TransformerConfig(**{**model, "n_layers": tr["layers"]}, remat=True, remat_policy="dots",
                            ce_chunk=tr["ce_chunk"])
    init_state, train_step = make_train_step(cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    state = init_state(g, device=dev)
    n_params = sum(t.numel() for t in leaves(state["params"]))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g, device=dev)}
    with warnings.catch_warnings():
        # The chunked loss's fallback to whole logits warns: make it an error here.
        warnings.filterwarnings("error", message=".*ce_chunk.*")
        t0 = time.perf_counter()
        first = train_step(state, batch)
        torch.cuda.synchronize()
        log(f"train {name}: {n_params / 1e9:.3f}B params ({tr['layers']} of {model['n_layers']} layers), remat "
            f"{cfg.remat_policy!r}, ce_chunk {cfg.ce_chunk}, B {B} x S {S}, warmup step "
            f"{time.perf_counter() - t0:.2f} s, loss {first['loss'].item():.4f}")
        torch.cuda.reset_peak_memory_stats()
        attention.LAUNCHES = attention.BWD_DQ_LAUNCHES = attention.BWD_DKV_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = [train_step(state, batch) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = {"flash_fwd": attention.LAUNCHES, "flash_bwd_dq": attention.BWD_DQ_LAUNCHES,
                "flash_bwd_dkv": attention.BWD_DKV_LAUNCHES}
    losses = [m["loss"].item() for m in metrics]
    gnorms = [m["grad_norm"].item() for m in metrics]
    tokens = B * S
    flops = 6.0 * n_params * tokens + 12.0 * cfg.n_layers * cfg.d_model * S * tokens
    stats = dict(step_ms=dt * 1e3, tokens_per_s=tokens / dt, mfu=flops / dt / PEAK_BF16_FLOPS,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, loss_first=losses[0],
                 loss_last=losses[-1], n_params=n_params, head_dim=cfg.head_dim, ce_chunk=cfg.ce_chunk,
                 parity_max_rel=max(rel), card=card)
    log(f"train {name}: {TRAIN_STEPS} steps, step {stats['step_ms']:.2f} ms, {stats['tokens_per_s']:.1f} "
        f"tokens/s, MFU {stats['mfu']:.4f} (6NT + 12LdST against 989 TFLOP/s), peak mem "
        f"{stats['peak_mem_gb']:.2f} GB  [{card}]")
    log(f"  loss {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"  grad_norm {' '.join(f'{x:.3f}' for x in gnorms)}")
    log(f"  launches in {TRAIN_STEPS} steps: K1 {launches['flash_fwd']}  K3 {launches['flash_bwd_dq']}  "
        f"K2 {launches['flash_bwd_dkv']}")
    if not all(math.isfinite(x) for x in losses + gnorms) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name} training loss is not finite and falling: {losses}")
    want = {"flash_fwd": 2 * cfg.n_layers * TRAIN_STEPS, "flash_bwd_dq": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dkv": cfg.n_layers * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"{name} kernel launches in {TRAIN_STEPS} training steps {launches} != {want}")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        _profile_window(f"{name}_train_step", lambda: train_step(state, batch), profile_dir)
    del state, batch
    torch.cuda.empty_cache()
    return stats, launches


# Device time by kind in a profile: (kind, substrings of the device
# kernel's name); the first match wins, the rest is "other".
TRAIN_PLANE_STEPS = 4  # (a): steps 1-4, saves after 2 and 4, one raise after 3 on the first attempt
TRAIN_PLANE_SAVES = (2, 4)
TRAIN_PLANE_FAIL_AT = 3
TRAIN_PLANE_SYNC_STEPS = 3  # (b)
TRAIN_PLANE_LOSS_TOL = 2e-3  # (b)'s mean loss of two halves against (a)'s whole-batch loss
TRAIN_PLANE_CHANNEL = "train-250M"
TRAIN_PLANE_SERVE_N = 8  # (c): phase 6's first prompts
TRAIN_PLANE_SWAP_S = 30.0


def _leaf_sha(leaf) -> str:
    """sha256 of a leaf's bytes (a CUDA tensor is copied to the host)."""
    import hashlib

    from ray_tpu_torch.util import dtypes

    return hashlib.sha256(dtypes.byte_view(dtypes.host_array(leaf))).hexdigest()


def _plane_setup(dev):
    """Phase 7(d)'s configuration, seed-0 state and seeded batch, drawn the
    same way in every process that calls it."""
    import torch

    from ray_tpu_torch.models import TransformerConfig, make_train_step

    cfg = TransformerConfig(**MODEL, remat=True, remat_policy="dots")
    init_state, train_step = make_train_step(cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    state = init_state(g, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1), generator=g, device=dev)}
    return cfg, state, train_step, batch


def _plane_tree(state):
    """(tree, meta) of a train state for the checkpoint plane. The tree has
    the parameters at its top level (a server's set_params reads it as it
    is), the optimizer's tensors under "opt" (per parameter, in leaves()
    order) and the step; meta has the optimizer's non-tensor entries (its
    param_groups) and the step count, for the manifest's meta."""
    import torch

    sd = state["opt"].state_dict()
    opt = {str(i): {k: v for k, v in st.items() if torch.is_tensor(v)} for i, st in sd["state"].items()}
    other = {str(i): {k: v for k, v in st.items() if not torch.is_tensor(v)} for i, st in sd["state"].items()}
    meta = {"param_groups": json.loads(json.dumps(sd["param_groups"])), "opt_other": other,
            "train_step": int(state["step"])}
    return {**state["params"], "opt": opt, "step": np.int64(state["step"])}, meta


def _plane_restore(state, checkpoint):
    """Loads the checkpoint-plane manifest a train Checkpoint names into
    ``state`` (parameters by path, the optimizer through load_state_dict).
    Returns (seconds, bytes, {path: sha256 of the restored leaf})."""
    import torch

    from ray_tpu_torch import ckpt
    from ray_tpu_torch.ckpt.saver import _flatten

    ref = json.load(open(os.path.join(checkpoint.path, "manifest_ref.json")))
    t0 = time.perf_counter()
    m = ckpt.load_manifest(ref["storage"], ref["ckpt_id"])
    tree = ckpt.restore_tree(m, ckpt.ChunkStore(ref["storage"]))
    flat = _flatten(tree)
    with torch.no_grad():
        for path, t in _flatten(state["params"]).items():
            t.copy_(torch.from_numpy(np.asarray(flat[path])))
    groups = m["meta"]["param_groups"]
    for gr in groups:
        gr["betas"] = tuple(gr["betas"])
    opt_state = {}
    for i, entry in enumerate(tree["opt"]):
        opt_state[i] = {k: torch.from_numpy(np.asarray(v)) for k, v in entry.items()}
        opt_state[i].update(m["meta"]["opt_other"].get(str(i), {}))
    state["opt"].load_state_dict({"state": opt_state, "param_groups": groups})
    state["step"] = int(m["meta"]["train_step"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    nbytes = sum(np.asarray(a).nbytes for a in flat.values())
    return seconds, nbytes, {p: _leaf_sha(a) for p, a in flat.items()}


def _counts():
    from ray_tpu_torch.ops import attention

    return [attention.LAUNCHES, attention.BWD_DQ_LAUNCHES, attention.BWD_DKV_LAUNCHES]


def _zero_counts():
    from ray_tpu_torch.ops import attention

    attention.LAUNCHES = attention.BWD_DQ_LAUNCHES = attention.BWD_DKV_LAUNCHES = 0


def _train_plane_fn(config):
    """7g(a)'s train fn, one GPU worker: the seed-0 state (or the checkpoint
    the controller hands a restarted gang), steps to TRAIN_PLANE_STEPS, a
    checkpoint-plane save after each of TRAIN_PLANE_SAVES, and on the first
    attempt a raise after step TRAIN_PLANE_FAIL_AT. Reports every step's
    loss and K1 / K3 / K2 launches (counted in this process), the saved and
    the restored leaves' digests, the saves' times and the peak memory."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.ckpt.saver import _flatten

    dev = torch.device("cuda", 0)
    cfg, state, train_step, batch = _plane_setup(dev)
    checkpoint = train.get_checkpoint()
    attempt = 1 if checkpoint is None else 2
    if checkpoint is not None:
        seconds, nbytes, shas = _plane_restore(state, checkpoint)
        train.report({"kind": "restored", "attempt": attempt, "step": state["step"], "seconds": seconds,
                      "bytes": nbytes, "sha": shas})
    torch.cuda.reset_peak_memory_stats()
    futs = []
    while state["step"] < TRAIN_PLANE_STEPS:
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(state, batch)
        loss = out["loss"].item()
        step_s = time.perf_counter() - t0
        metrics = {"kind": "step", "attempt": attempt, "step": out["step"], "loss": loss,
                   "launches": _counts(), "step_s": step_s}
        if out["step"] in TRAIN_PLANE_SAVES:
            tree, meta = _plane_tree(state)
            done = []
            t0 = time.perf_counter()
            fut = train.save_pytree_async(tree, {**metrics, **meta})
            stall_s = time.perf_counter() - t0
            fut.add_done_callback(lambda f, d=done: d.append(time.perf_counter()))
            futs.append((out["step"], fut, t0, stall_s, done))
            if attempt == 1:
                # The snapshot holds these values; step 3 has not run yet.
                train.report({"kind": "saved", "step": out["step"],
                              "sha": {p: _leaf_sha(a) for p, a in _flatten(tree).items()}})
        else:
            train.report(metrics)
        if attempt == 1 and out["step"] == TRAIN_PLANE_FAIL_AT:
            _report_saves(train, futs)
            raise RuntimeError(f"injected failure after step {TRAIN_PLANE_FAIL_AT} (first attempt)")
    _report_saves(train, futs)
    train.report({"kind": "end", "attempt": attempt, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})


def _report_saves(train, futs):
    """Waits for each save's commit; reports its step-path stall, its time
    to commit and the bytes it wrote."""
    for step, fut, t0, stall_s, done in futs:
        m = fut.result(timeout=600)
        train.report({"kind": "save", "step": step, "stall_s": stall_s, "commit_s": done[0] - t0,
                      "bytes": m["bytes_total"], "ckpt_id": m["ckpt_id"]})
    futs.clear()


def _train_plane_sync_fn(config):
    """7g(b)'s train fn: rank r of 2 takes rows [8r, 8r + 8) of the batch;
    each step the loss and its backward on the half, train.grad_sync()'s
    allreduce (mean, fp32, buckets of Config.collective_bucket_bytes) into
    each .grad, then AdamW. Rank 0 reports every rank's loss, launches,
    torch.distributed world size and times, gathered over the ring."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import collective as col
    from ray_tpu_torch import train
    from ray_tpu_torch.models.transformer import cross_entropy_loss, leaves

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    dev = torch.device("cuda", 0)
    cfg, state, _, batch = _plane_setup(dev)
    half = TRAIN_B // world
    mine = {"tokens": batch["tokens"][rank * half:(rank + 1) * half]}
    del batch
    sync = train.grad_sync()
    ps, opt = leaves(state["params"]), state["opt"]
    nbytes = sum(t.numel() * t.element_size() for t in ps)
    dist_world = dist.get_world_size() if dist.is_initialized() else 0
    torch.cuda.reset_peak_memory_stats()
    for step in range(1, TRAIN_PLANE_SYNC_STEPS + 1):
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(state["params"], mine, cfg)
        loss.backward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = sync.allreduce([t.grad for t in ps])
        with torch.no_grad():
            for t, g in zip(ps, grads):
                t.grad.copy_(g)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        mine_stats = np.array([loss.item(), *_counts(), dist_world, t3 - t0, t2 - t1], np.float64)
        every = col.allgather(mine_stats, group_name=sync.group_name)
        train.report({"kind": "sync_step", "step": step, "ranks": [e.tolist() for e in every],
                      "bytes": nbytes})
    shas = np.frombuffer(b"".join(bytes.fromhex(_leaf_sha(t)) for t in ps), np.uint8)
    every_sha = col.allgather(shas, group_name=sync.group_name)
    peaks = col.allgather(np.array([torch.cuda.max_memory_allocated() / 1e9]), group_name=sync.group_name)
    train.report({"kind": "sync_end", "params_equal": all(np.array_equal(every_sha[0], e) for e in every_sha),
                  "peak_mem_gb": [float(p[0]) for p in peaks], "n_leaves": len(ps)})


def _plane_history(result, kind):
    return [m for m in result.metrics_history if m.get("kind") == kind]


def phase_train_plane(dev, card, phase6):
    """Phase 7g (train-plane-250M): the train plane on the port's runtime
    (rt.init GPU 1). (a) DataParallelTrainer, one GPU worker, phase 7(d)'s
    configuration: 4 steps, checkpoint-plane saves after 2 and 4, a raise
    after 3 on the first attempt and the gang restart from the step-2
    checkpoint; (b) two ranks on half the batch each (GPU 0.5), gradients
    averaged over the port's host ring; (c) the step-4 checkpoint published
    on a channel that an in-process LLMServer hot-swaps, then decodes phase
    6's first prompts through K1 and K4. Returns (stats, the workers' K1 /
    K3 / K2 launches, (c)'s K1 / K4 launches)."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import ckpt
    from ray_tpu_torch.core import api as rt_api
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, LLMServer
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.ops import attention, paged_attention
    from ray_tpu_torch.train import DataParallelTrainer, FailureConfig, RunConfig, ScalingConfig

    want = {"flash_fwd": 2 * MODEL["n_layers"], "flash_bwd_dq": MODEL["n_layers"],
            "flash_bwd_dkv": MODEL["n_layers"]}
    want_l = [want["flash_fwd"], want["flash_bwd_dq"], want["flash_bwd_dkv"]]
    # The in-process reference: four train_step calls on the same seed and batch.
    _zero_counts()
    cfg, state, train_step, batch = _plane_setup(dev)
    ref_losses = [train_step(state, batch)["loss"].item() for _ in range(TRAIN_PLANE_STEPS)]
    driver_launches = _counts()
    del state, batch
    torch.cuda.empty_cache()
    log(f"train plane: in-process reference losses {ref_losses}, driver launches K1/K3/K2 {driver_launches}")
    if driver_launches != [n * TRAIN_PLANE_STEPS for n in want_l]:
        raise AssertionError(f"reference steps launched {driver_launches}, expected {want_l} per step")

    storage = tempfile.mkdtemp(prefix="chip_smoke_train_plane_")
    stats = {"card": card}
    t_init = time.perf_counter()
    rt.init(num_cpus=RT_CPUS, resources={"GPU": 1}, object_store_memory=RT_STORE_BYTES)
    try:
        log(f"train plane: rt.init {time.perf_counter() - t_init:.2f} s, resources {rt.cluster_resources()}")
        # (a) one worker, two saves, one gang restart.
        t0 = time.perf_counter()
        res = DataParallelTrainer(
            _train_plane_fn,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="plane-a", storage_path=storage,
                                 failure_config=FailureConfig(max_failures=1))).fit()
        fit_a = time.perf_counter() - t0
        if res.error is not None:
            raise AssertionError(f"7g(a) failed: {res.error}")
        steps = _plane_history(res, "step")
        first = {m["step"]: m for m in steps if m["attempt"] == 1}
        second = {m["step"]: m for m in steps if m["attempt"] == 2}
        losses = [first[s]["loss"] for s in (1, 2)] + [second[s]["loss"] for s in (3, 4)]
        log(f"train plane (a): fit {fit_a:.2f} s; losses attempt 1 {[first[s]['loss'] for s in sorted(first)]}, "
            f"attempt 2 {[second[s]['loss'] for s in sorted(second)]}")
        if sorted(first) != [1, 2, 3] or sorted(second) != [3, 4]:
            raise AssertionError(f"7g(a) steps: attempt 1 {sorted(first)}, attempt 2 {sorted(second)}")
        if losses != ref_losses:
            raise AssertionError(f"7g(a) losses {losses} are not bitwise the in-process steps' {ref_losses}")
        if second[3]["loss"] != first[3]["loss"]:
            raise AssertionError(f"step 3 after the restore {second[3]['loss']} != before {first[3]['loss']}")
        bad = {(m["attempt"], m["step"]): m["launches"] for m in steps if m["launches"] != want_l}
        if bad:
            raise AssertionError(f"7g(a) worker launches per step {bad}, expected K1/K3/K2 {want_l}")
        saved = _plane_history(res, "saved")
        restored = _plane_history(res, "restored")
        if len(saved) != 1 or len(restored) != 1 or saved[0]["step"] != 2 or restored[0]["step"] != 2:
            raise AssertionError(f"7g(a): saved {[m['step'] for m in saved]}, restored {[m['step'] for m in restored]}")
        if saved[0]["sha"] != restored[0]["sha"]:
            diff = sorted(p for p in saved[0]["sha"] if saved[0]["sha"][p] != restored[0]["sha"].get(p))
            raise AssertionError(f"7g(a): restored leaves differ from the saved ones: {diff}")
        saves = {m["step"]: m for m in _plane_history(res, "save")}
        ends = _plane_history(res, "end")
        restore = restored[0]
        a_launches = [sum(m["launches"][i] for m in steps) for i in range(3)]
        stats["a"] = dict(
            losses=losses, fit_s=fit_a, step_s=[m["step_s"] for m in steps],
            save_stall_s={s: m["stall_s"] for s, m in saves.items()},
            save_commit_s={s: m["commit_s"] for s, m in saves.items()},
            save_bytes={s: m["bytes"] for s, m in saves.items()},
            restore_s=restore["seconds"], restore_bytes=restore["bytes"],
            restore_gb_s=restore["bytes"] / restore["seconds"] / 1e9,
            peak_mem_gb=[m["peak_mem_gb"] for m in ends], leaves_checked=len(saved[0]["sha"]),
            launches=a_launches)
        log(f"train plane (a): step s {[round(x, 4) for x in stats['a']['step_s']]}, save on the step path "
            f"{stats['a']['save_stall_s']} s, to commit {stats['a']['save_commit_s']} s, bytes written "
            f"{stats['a']['save_bytes']}, restore {restore['bytes'] / 1e9:.3f} GB in {restore['seconds']:.3f} s "
            f"({stats['a']['restore_gb_s']:.3f} GB/s), {len(saved[0]['sha'])} leaves bitwise, peak mem "
            f"{stats['a']['peak_mem_gb']} GB, worker launches K1/K3/K2 {a_launches}  [{card}]")
        manifest_ref = json.load(open(os.path.join(res.checkpoint.path, "manifest_ref.json")))
        if manifest_ref["ckpt_id"] != saves[4]["ckpt_id"]:
            raise AssertionError(f"7g(a) latest checkpoint {manifest_ref} is not the step-4 save")

        # (b) two ranks on one card, gradients averaged over the host ring.
        t0 = time.perf_counter()
        res_b = DataParallelTrainer(
            _train_plane_sync_fn,
            scaling_config=ScalingConfig(num_workers=2, use_gpu=True, resources_per_worker={"GPU": 0.5}),
            run_config=RunConfig(name="plane-b", storage_path=storage)).fit()
        fit_b = time.perf_counter() - t0
        if res_b.error is not None:
            raise AssertionError(f"7g(b) failed: {res_b.error}")
        sync_steps = _plane_history(res_b, "sync_step")
        end_b = _plane_history(res_b, "sync_end")
        if [m["step"] for m in sync_steps] != list(range(1, TRAIN_PLANE_SYNC_STEPS + 1)) or len(end_b) != 1:
            raise AssertionError(f"7g(b) reports {[m.get('kind') for m in res_b.metrics_history]}")
        gaps, b_launches, step_s, sync_s = [], [0, 0, 0], [], []
        for m in sync_steps:
            ranks = m["ranks"]
            mean = sum(r[0] for r in ranks) / len(ranks)
            gaps.append(abs(mean - ref_losses[m["step"] - 1]))
            for r in ranks:
                if [int(x) for x in r[1:4]] != want_l:
                    raise AssertionError(f"7g(b) step {m['step']} launches {r[1:4]}, expected {want_l}")
                if int(r[4]) != 2:
                    raise AssertionError(f"7g(b): torch.distributed world size {r[4]} in a rank, expected 2")
                b_launches = [b + int(x) for b, x in zip(b_launches, r[1:4])]
            step_s.append(max(r[5] for r in ranks))
            sync_s.append(max(r[6] for r in ranks))
        grad_bytes = sync_steps[0]["bytes"]
        stats["b"] = dict(mean_losses=[sum(r[0] for r in m["ranks"]) / len(m["ranks"]) for m in sync_steps],
                          max_gap=max(gaps), fit_s=fit_b, step_s=step_s, sync_s=sync_s,
                          sync_share=[y / x for x, y in zip(step_s, sync_s)], grad_bytes=grad_bytes,
                          ring_gb_s=[grad_bytes / y / 1e9 for y in sync_s], peak_mem_gb=end_b[0]["peak_mem_gb"],
                          params_equal=end_b[0]["params_equal"], launches=b_launches)
        log(f"train plane (b): fit {fit_b:.2f} s, mean losses {stats['b']['mean_losses']}, largest gap to (a) "
            f"{stats['b']['max_gap']:.3e} (limit {TRAIN_PLANE_LOSS_TOL}), step s {[round(x, 4) for x in step_s]}, "
            f"grad sync s {[round(x, 4) for x in sync_s]} (share {[round(x, 3) for x in stats['b']['sync_share']]}), "
            f"{grad_bytes / 1e9:.3f} GB reduced per step, ring {[round(x, 3) for x in stats['b']['ring_gb_s']]} GB/s, "
            f"peak mem per rank {stats['b']['peak_mem_gb']} GB, launches K1/K3/K2 {b_launches}  [{card}]")
        if not max(gaps) <= TRAIN_PLANE_LOSS_TOL:
            raise AssertionError(f"7g(b) mean losses {gaps} away from (a)'s, limit {TRAIN_PLANE_LOSS_TOL}")
        if not end_b[0]["params_equal"]:
            raise AssertionError("7g(b): the two ranks' parameters differ after the last step")

        # (c) train -> serve: the step-4 checkpoint hot-swapped into a server.
        engine_kw = dict(max_slots=SLOTS, max_seq=2048, kv_layout="paged", page_size=PAGE, seed=0)
        srv = LLMServer(MODEL, engine_kw, weights_channel=TRAIN_PLANE_CHANNEL)
        try:
            m4 = ckpt.load_manifest(manifest_ref["storage"], manifest_ref["ckpt_id"])
            t_pub = time.perf_counter()
            if not ckpt.publish_checkpoint(m4, TRAIN_PLANE_CHANNEL):
                raise AssertionError("7g(c): publish_checkpoint found no session")
            while srv.weights_version() != m4["ckpt_id"]:
                if time.perf_counter() - t_pub > TRAIN_PLANE_SWAP_S:
                    raise AssertionError(f"7g(c): the server did not swap to {m4['ckpt_id']} within "
                                         f"{TRAIN_PLANE_SWAP_S} s (at {srv.weights_version()})")
                time.sleep(0.01)
            swap_s = time.perf_counter() - t_pub
            prompts = phase6[0][:TRAIN_PLANE_SERVE_N]
            attention.LAUNCHES = paged_attention.LAUNCHES = 0
            got = [list(srv.generate(p, max_tokens=MAX_TOKENS)["tokens"]) for p in prompts]
            c_launches = {"flash_fwd": attention.LAUNCHES, "paged_decode": paged_attention.LAUNCHES}
        finally:
            srv.__raytpu_exit__()
        del srv
        tree = ckpt.restore_tree(m4, ckpt.ChunkStore(manifest_ref["storage"]))
        params = {k: (torch.from_numpy(v) if k != "layers" else {n: torch.from_numpy(t) for n, t in v.items()})
                  for k, v in tree.items() if k in ("embed", "layers", "final_norm", "lm_head")}
        eng = LLMEngine(TransformerConfig(**MODEL), params=params, engine_config=EngineConfig(**engine_kw))
        want_tokens = [list(eng.generate(p, max_tokens=MAX_TOKENS)["tokens"]) for p in prompts]
        del eng, tree, params
        torch.cuda.empty_cache()
        stats["c"] = dict(swap_s=swap_s, requests=len(prompts), launches=c_launches,
                          tokens_equal=got == want_tokens)
        log(f"train plane (c): publish -> swap {swap_s:.3f} s, {len(prompts)} x {MAX_TOKENS} greedy tokens "
            f"{'equal' if got == want_tokens else 'DIFFER from'} the restored manifest's engine, launches after "
            f"the swap K1 {c_launches['flash_fwd']} K4 {c_launches['paged_decode']}  [{card}]")
        if got != want_tokens:
            bad = [i for i, (a, b) in enumerate(zip(got, want_tokens)) if a != b]
            raise AssertionError(f"7g(c): the hot-swapped server's tokens differ for prompts {bad}")
        if not (c_launches["flash_fwd"] > 0 and c_launches["paged_decode"] > 0):
            raise AssertionError(f"7g(c): a kernel was not launched after the swap: {c_launches}")
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    if rt_api._global_worker is not None or rt_api._LIVE_CLUSTERS:
        raise AssertionError("rt.shutdown() left the runtime up")
    w_launches = {k: a + b for k, a, b in zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                                             stats["a"]["launches"], stats["b"]["launches"])}
    stats["total_s"] = time.perf_counter() - t_init
    return stats, w_launches, c_launches


# Phase 7h (tune-sweep-250M): 7(d)'s configuration in half-card Tune
# trials, each on rows 0-7 of the seed-0 batch, TUNE_STEPS steps at each
# learning rate of the grid; (b) ASHA over the iteration (grace 2: step 1's
# loss is the same at every rate); (c) one trial at TUNE_RESUME_LR that
# saves after step TUNE_FAIL_AT and raises on its first attempt.
TUNE_LRS = (1e-4, 3e-4, 1e-3, 3e-3)
TUNE_STEPS, TUNE_ROWS = 3, 8
TUNE_ASHA = dict(max_t=3, grace_period=2, reduction_factor=2)
TUNE_RESUME_LR, TUNE_FAIL_AT = 3e-4, 2


def _tune_setup(dev, lr):
    """7g's seed-0 state and batch (the same draws), AdamW at ``lr``, rows
    0..TUNE_ROWS-1 of the batch."""
    cfg, state, train_step, batch = _plane_setup(dev)
    for group in state["opt"].param_groups:
        group["lr"] = lr
    return cfg, state, train_step, {"tokens": batch["tokens"][:TUNE_ROWS].clone()}


def _tune_tree(state):
    """The trial's checkpoint tree: parameters, AdamW's state (its tensors
    per parameter index, "step" included) and the step."""
    sd = state["opt"].state_dict()
    return {"params": state["params"], "opt": {str(i): dict(st) for i, st in sd["state"].items()},
            "step": np.int64(state["step"])}


def _tune_restore(state, checkpoint):
    """Loads a _tune_tree checkpoint (train.checkpoint.load_pytree) into
    ``state``: parameters in place, AdamW through load_state_dict."""
    import torch

    from ray_tpu_torch.ckpt.saver import _flatten
    from ray_tpu_torch.train.checkpoint import load_pytree

    tree = load_pytree(checkpoint.path)
    flat = _flatten(tree["params"])
    with torch.no_grad():
        for path, t in _flatten(state["params"]).items():
            t.copy_(flat[path])
    opt = state["opt"]
    # The tree's per-parameter entries, keyed "0".."n-1", come back a list.
    opt.load_state_dict({"state": dict(enumerate(tree["opt"])),
                         "param_groups": opt.state_dict()["param_groups"]})
    state["step"] = int(tree["step"])


def _tune_trainable(config):
    """7h's trainable, in a trial actor given {"GPU": 0.5}: TUNE_STEPS
    steps at config["lr"], one report a step (loss, K1 / K3 / K2 launches
    counted in this process, the step's window on the host clock, peak
    memory). With config["fail_at"], the first attempt saves the state
    after that step (train.checkpoint.save_pytree, reported with the step)
    and raises; a retry restores it through tune.get_checkpoint()."""
    t_fn = time.time()  # before `import torch`: setup includes it
    import torch

    from ray_tpu_torch import tune
    from ray_tpu_torch.train import Checkpoint
    from ray_tpu_torch.train.checkpoint import save_pytree

    dev = torch.device("cuda", 0)
    _, state, train_step, batch = _tune_setup(dev, config["lr"])
    checkpoint = tune.get_checkpoint()
    attempt = 1
    restore_s = None
    if checkpoint is not None:
        attempt = 2
        t0 = time.perf_counter()
        _tune_restore(state, checkpoint)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    while state["step"] < TUNE_STEPS:
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        out = train_step(state, batch)
        loss = out["loss"].item()
        t1 = time.time()
        metrics = {"loss": loss, "step": out["step"], "attempt": attempt, "launches": _counts(),
                   "t0": t0, "t1": t1, "t_fn": t_fn, "restore_s": restore_s,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if attempt == 1 and out["step"] == config.get("fail_at"):
            path = tempfile.mkdtemp(prefix="chip_smoke_tune_ckpt_")
            t0 = time.perf_counter()
            save_pytree(_tune_tree(state), path)
            metrics["save_s"] = time.perf_counter() - t0
            metrics["ckpt_bytes"] = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
            t0 = time.perf_counter()
            tune.report(metrics, checkpoint=Checkpoint.from_directory(path))
            metrics["report_s"] = time.perf_counter() - t0
            shutil.rmtree(path, ignore_errors=True)
            tune.report({"kind": "saved", "save_s": metrics["save_s"], "report_s": metrics["report_s"],
                         "ckpt_bytes": metrics["ckpt_bytes"]})
            raise RuntimeError(f"injected failure after step {TUNE_FAIL_AT} (first attempt)")
        tune.report(metrics)


def _tune_steps(result):
    return [m for m in result.metrics_history if "loss" in m]


def _asha_predict(ref, order):
    """The decisions ASHAScheduler(**TUNE_ASHA, mode "min") makes when the
    trials cross its rung (iteration 2) in ``order`` (learning rates), from
    the driver's losses: {lr: stopped at the rung}."""
    seen, stopped = [], {}
    for lr in order:
        seen.append(ref[lr][TUNE_ASHA["grace_period"] - 1])
        values = sorted(seen)
        k = max(1, -(-len(values) // TUNE_ASHA["reduction_factor"]))
        stopped[lr] = len(values) >= TUNE_ASHA["reduction_factor"] and values[k - 1] < seen[-1]
    return stopped


def phase_tune(dev, card):
    """Phase 7h (tune-sweep-250M): ray_tpu_torch.tune over the port's
    runtime (rt.init GPU 1, the 2 GiB store). First the driver's reference,
    TUNE_STEPS in-process train_step calls at each rate of TUNE_LRS; then
    (a) a FIFO sweep of grid_search(TUNE_LRS) in {"GPU": 0.5} trials, two
    at a time, (b) the same grid under ASHA, (c) one trial that fails after
    a checkpoint and resumes. Returns (stats, the trials' K1 / K3 / K2
    launches)."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.core import api as rt_api
    from ray_tpu_torch.train import RunConfig
    from ray_tpu_torch.tune import tuner as tuner_mod

    want_l = [2 * MODEL["n_layers"], MODEL["n_layers"], MODEL["n_layers"]]
    ref = {}
    for lr in TUNE_LRS:
        _zero_counts()
        _, state, train_step, batch = _tune_setup(dev, lr)
        ref[lr] = [train_step(state, batch)["loss"].item() for _ in range(TUNE_STEPS)]
        if _counts() != [n * TUNE_STEPS for n in want_l]:
            raise AssertionError(f"7h reference at lr {lr} launched {_counts()}, expected {want_l} per step")
        del state, batch
        torch.cuda.empty_cache()
    best_lr = min(TUNE_LRS, key=lambda lr: ref[lr][-1])
    log(f"tune: the driver's losses {ref}, best lr {best_lr}")
    if len({ref[lr][0] for lr in TUNE_LRS}) != 1:
        raise AssertionError(f"7h: step 1's loss differs between learning rates: {ref}")

    # Observe (never change) when the controller requests each trial's actor.
    requested = {}
    try_start = tuner_mod.TuneController._try_start

    def timed_start(self, trial):
        t = time.time()
        ok = try_start(self, trial)
        if ok:
            requested.setdefault(trial.trial_id, []).append(t)
        return ok

    storage = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    stats = {"card": card, "ref_losses": {str(lr): v for lr, v in ref.items()}, "best_lr": best_lr}
    launches = [0, 0, 0]
    t_init = time.perf_counter()
    rt.init(num_cpus=RT_CPUS, resources={"GPU": 1}, object_store_memory=RT_STORE_BYTES)
    tuner_mod.TuneController._try_start = timed_start
    try:
        def sweep(name, space, **kw):
            requested.clear()
            t0 = time.perf_counter()
            grid = tune.Tuner(
                _tune_trainable, param_space=space,
                tune_config=tune.TuneConfig(metric="loss", mode="min", resources_per_trial={"GPU": 0.5},
                                            max_concurrent_trials=2, **kw),
                run_config=RunConfig(name=name, storage_path=storage)).fit()
            wall = time.perf_counter() - t0
            if grid.errors:
                raise AssertionError(f"7h {name}: trial errors {grid.errors}")
            rows = []
            for r in grid:
                steps = _tune_steps(r)
                for m in steps:
                    if m["launches"] != want_l:
                        raise AssertionError(f"7h {name}: lr {r.config['lr']} step {m['step']} launched "
                                             f"{m['launches']}, expected K1/K3/K2 {want_l}")
                    for i in range(3):
                        launches[i] += m["launches"][i]
                firsts = [next(m for m in steps if m["attempt"] == a) for a in sorted({m["attempt"] for m in steps})]
                rows.append(dict(lr=r.config["lr"], losses=[m["loss"] for m in steps],
                                 attempts=[m["attempt"] for m in steps],
                                 start_s=[m["t1"] - t for t, m in zip(requested[r.trial_id], firsts)],
                                 spawn_s=[m["t_fn"] - t for t, m in zip(requested[r.trial_id], firsts)],
                                 setup_s=[m["t0"] - m["t_fn"] for m in firsts],
                                 step_s=[m["t1"] - m["t0"] for m in steps],
                                 step_t1=[m["t1"] for m in steps],
                                 window=(steps[0]["t0"], steps[-1]["t1"]),
                                 peak_mem_gb=max(m["peak_mem_gb"] for m in steps)))
            log(f"tune ({name}): {len(grid)} trials in {wall:.2f} s")
            for row in rows:
                log(f"  lr {row['lr']}: losses {row['losses']}, start latency (actor requested -> first report) "
                    f"{[round(x, 3) for x in row['start_s']]} s (to the trainable's start "
                    f"{[round(x, 3) for x in row['spawn_s']]}, its setup {[round(x, 3) for x in row['setup_s']]}), "
                    f"step s {[round(x, 4) for x in row['step_s']]}, "
                    f"peak mem {row['peak_mem_gb']:.2f} GB  [{card}]")
            return grid, rows, wall

        # (a) FIFO.
        grid, rows, wall = sweep("tune-fifo", {"lr": tune.grid_search(list(TUNE_LRS))})
        for row in rows:
            if row["losses"] != ref[row["lr"]]:
                raise AssertionError(f"7h(a) lr {row['lr']}: losses {row['losses']} are not bitwise the "
                                     f"driver's {ref[row['lr']]}")
        got_best = grid.get_best_result("loss", "min").config["lr"]
        if got_best != best_lr:
            raise AssertionError(f"7h(a): get_best_result picked lr {got_best}, the driver's best is {best_lr}")
        windows = sorted(row["window"] for row in rows)
        overlap = max(min(a[1], b[1]) - max(a[0], b[0]) for i, a in enumerate(windows) for b in windows[i + 1:])
        if overlap <= 0:
            raise AssertionError(f"7h(a): no two trials' step windows overlapped on the card: {windows}")
        stats["a"] = dict(wall_s=wall, best_lr=got_best, overlap_s=overlap, trials=rows)
        log(f"tune (a): every trial's losses bitwise the driver's, best lr {got_best}, two trials' step "
            f"windows overlap {overlap:.3f} s  [{card}]")

        # (b) ASHA.
        grid, rows, wall = sweep("tune-asha", {"lr": tune.grid_search(list(TUNE_LRS))},
                                 scheduler=tune.ASHAScheduler(metric="loss", mode="min", **TUNE_ASHA))
        for row in rows:
            if row["losses"] != ref[row["lr"]][:len(row["losses"])]:
                raise AssertionError(f"7h(b) lr {row['lr']}: losses {row['losses']} are not a bitwise prefix "
                                     f"of the driver's {ref[row['lr']]}")
        stopped = [row["lr"] for row in rows if len(row["losses"]) < TUNE_STEPS]
        # The order in which the trials reported the rung's iteration.
        rung = TUNE_ASHA["grace_period"]
        crossed = [row["lr"] for row in sorted(rows, key=lambda r: r["step_t1"][rung - 1])]
        stats["b"] = dict(wall_s=wall, stopped=stopped, trials=rows)
        log(f"tune (b): stopped before step {TUNE_STEPS}: {stopped}; the driver's losses would stop "
            f"{[lr for lr, s in _asha_predict(ref, crossed).items() if s]} for rung crossings in the "
            f"order {crossed}  [{card}]")
        if not stopped:
            raise AssertionError(f"7h(b): ASHA stopped no trial before step {TUNE_STEPS}: {rows}")

        # (c) failure and resume.
        grid, rows, wall = sweep("tune-resume", {"lr": tune.grid_search([TUNE_RESUME_LR]),
                                                 "fail_at": TUNE_FAIL_AT}, max_failures_per_trial=1)
        steps = _tune_steps(grid[0])
        saved = [m for m in grid[0].metrics_history if m.get("kind") == "saved"]
        got = [(m["attempt"], m["step"]) for m in steps]
        want = [(1, s) for s in range(1, TUNE_FAIL_AT + 1)] + [(2, s) for s in range(TUNE_FAIL_AT + 1,
                                                                                     TUNE_STEPS + 1)]
        if got != want or len(saved) != 1:
            raise AssertionError(f"7h(c): (attempt, step) reports {got}, expected {want}; saves {saved}")
        if [m["loss"] for m in steps] != ref[TUNE_RESUME_LR]:
            raise AssertionError(f"7h(c): losses {[m['loss'] for m in steps]} are not bitwise the driver's "
                                 f"{ref[TUNE_RESUME_LR]}")
        resumed = steps[TUNE_FAIL_AT]
        stats["c"] = dict(wall_s=wall, losses=[m["loss"] for m in steps], ckpt_bytes=saved[0]["ckpt_bytes"],
                          save_s=saved[0]["save_s"], report_s=saved[0]["report_s"],
                          restore_s=resumed["restore_s"], trial=rows[0])
        log(f"tune (c): step {TUNE_FAIL_AT + 1} after the resume {resumed['loss']} bitwise the driver's; "
            f"checkpoint {saved[0]['ckpt_bytes'] / 1e9:.3f} GB saved in {saved[0]['save_s']:.3f} s "
            f"(report with it {saved[0]['report_s']:.3f} s), restored in {resumed['restore_s']:.3f} s  [{card}]")
    finally:
        tuner_mod.TuneController._try_start = try_start
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    if rt_api._global_worker is not None or rt_api._LIVE_CLUSTERS:
        raise AssertionError("rt.shutdown() left the runtime up")
    stats["total_s"] = time.perf_counter() - t_init
    stats["launches"] = launches
    return stats, dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), launches))


# Phase 7i (rl-learners): every RL learner at the sizes of the reference's
# tests, built from seed-0 numpy parameters, RL_UPDATES updates on one
# seeded numpy minibatch on the card and on the CPU; then MultiAgentPPO on
# CueMatchEnv at tests/test_rl_multiagent.py:80-97's configuration.
RL_UPDATES = 3
RL_TOL = 1e-4  # per-leaf relative L2 and each update's relative loss, card against CPU (fp32)
RL_LEARNERS = ("ppo", "multi_agent_ppo", "impala", "dqn", "sac", "bc_discrete", "bc_continuous", "cql")
RL_MA = dict(num_env_runners=2, num_envs_per_runner=8, rollout_len=64, lr=3e-3, seed=0)
RL_MA_ENV = dict(n_agents=2, n_cues=4, ep_len=16)
RL_MA_ITERS, RL_MA_BAR = 12, 26.0  # max 32, random about 1.4


def rl_case(name):
    """One learner's parity case: {"params", "batch", "config", "noise"}
    (numpy; seed 0). Sizes: CartPole (obs 4, 2 actions; PPO's minibatch 256
    at lr 2.5e-4, IMPALA's 64 x 8 rollout, DQN's batch 64, BC's 256),
    CueMatch (4 cues, minibatch 512, lr 3e-3) and Pendulum (obs 3, one
    action in [-2, 2]; SAC's batch 128, CQL's 256 with 8 action samples).
    SAC and CQL carry their RL_UPDATES updates' standard-normal (and CQL's
    uniform) draws under "noise"."""
    from ray_tpu_torch.rl import dqn, impala, module, offline, sac

    rng = np.random.default_rng(0)
    f32 = np.float32
    case = {"noise": None}
    if name in ("ppo", "multi_agent_ppo"):
        obs_dim, n_act, B = (4, 2, 256) if name == "ppo" else (4, 4, 512)
        params = module.init_params(rng, obs_dim, n_act, (64, 64))
        obs = (rng.standard_normal((B, obs_dim)).astype(f32) if name == "ppo"
               else np.eye(obs_dim, dtype=f32)[rng.integers(0, obs_dim, B)])
        actions, logp, _ = module.np_sample(params, obs, rng)
        adv = rng.standard_normal(B).astype(f32)
        case.update(params=params, config={"lr": 2.5e-4 if name == "ppo" else 3e-3},
                    batch={"obs": obs, "actions": actions, "logp_old": logp,
                           "advantages": (adv - adv.mean()) / (adv.std() + 1e-8),
                           "returns": rng.standard_normal(B).astype(f32)})
    elif name == "impala":
        T, N = 64, 8
        params = module.init_params(rng, 4, 2, (64, 64))
        obs = rng.standard_normal((T, N, 4)).astype(f32)
        actions, logp, _ = module.np_sample(params, obs.reshape(T * N, 4), rng)
        dones = (rng.random((T, N)) < 0.05).astype(f32)
        case.update(params=params, config=impala.IMPALAConfig(),
                    batch={"obs": obs, "actions": actions.reshape(T, N),
                           "behavior_logp": (logp + 0.1 * rng.standard_normal(T * N)).astype(f32).reshape(T, N),
                           "rewards": np.ones((T, N), f32), "dones": dones,
                           "terms": dones * (rng.random((T, N)) < 0.5).astype(f32),
                           "valids": (rng.random((T, N)) > 0.05).astype(f32),
                           "last_obs": rng.standard_normal((N, 4)).astype(f32)})
    elif name == "dqn":
        B = 64
        case.update(params=module.init_params(rng, 4, 2, (64, 64)),
                    config=dqn.DQNConfig(target_update_every=2),  # a target sync inside the 3 updates
                    batch={"obs": rng.standard_normal((B, 4)).astype(f32), "actions": rng.integers(0, 2, B),
                           "rewards": np.ones(B, f32), "next_obs": rng.standard_normal((B, 4)).astype(f32),
                           "terms": (rng.random(B) < 0.1).astype(f32),
                           "weights": rng.uniform(0.2, 1.0, B).astype(f32)})
    elif name in ("sac", "cql"):
        B = 128 if name == "sac" else 256
        cfg = sac.SACConfig() if name == "sac" else offline.CQLConfig()
        case.update(params=sac.sac_init_params(rng, 3, 1, cfg.hidden), config=cfg,
                    batch={"obs": rng.standard_normal((B, 3)).astype(f32),
                           "actions": rng.uniform(-2, 2, (B, 1)).astype(f32),
                           "rewards": -rng.uniform(0, 16, B).astype(f32),
                           "next_obs": rng.standard_normal((B, 3)).astype(f32),
                           "terms": (rng.random(B) < 0.05).astype(f32)})
        n = getattr(cfg, "n_action_samples", 0)
        noise = []
        for _ in range(RL_UPDATES):
            draw = {"next": rng.standard_normal((B, 1)).astype(f32), "cur": rng.standard_normal((B, 1)).astype(f32)}
            if name == "cql":
                draw.update(rand=rng.uniform(-1, 1, (B, n, 1)).astype(f32),
                            pol=rng.standard_normal((B * n, 1)).astype(f32),
                            nxt=rng.standard_normal((B * n, 1)).astype(f32))
            noise.append(draw)
        case["noise"] = noise
    elif name == "bc_discrete":
        full = module.init_params(rng, 4, 2, (64, 64))
        B = 256
        case.update(params={k: v for k, v in full.items() if k.startswith(("pw", "pb", "wpi", "bpi"))},
                    config={"lr": 1e-3, "act_scale": None},
                    batch={"obs": rng.standard_normal((B, 4)).astype(f32), "actions": rng.integers(0, 2, B)})
    elif name == "bc_continuous":
        full = sac.sac_init_params(rng, 3, 1, (64, 64))
        B = 256
        case.update(params={k: v for k, v in full.items() if k.startswith(("pw", "pb", "wmu", "bmu"))},
                    config={"lr": 1e-3, "act_scale": np.array([2.0], f32)},
                    batch={"obs": rng.standard_normal((B, 3)).astype(f32),
                           "actions": rng.uniform(-2, 2, (B, 1)).astype(f32)})
    else:
        raise ValueError(name)
    return case


def rl_learner(name, case, device):
    """The port's learner of ``name`` built from the case's parameters."""
    from ray_tpu_torch.rl.dqn import DQNLearner
    from ray_tpu_torch.rl.impala import IMPALALearner
    from ray_tpu_torch.rl.learner import PPOLearner
    from ray_tpu_torch.rl.offline import BCLearner, CQLLearner
    from ray_tpu_torch.rl.sac import SACLearner

    p, cfg = case["params"], case["config"]
    if name in ("ppo", "multi_agent_ppo"):
        return PPOLearner(p, lr=cfg["lr"], device=device)
    if name.startswith("bc"):
        return BCLearner(p, cfg["lr"], cfg["act_scale"], device=device)
    if name in ("sac", "cql"):
        return (SACLearner if name == "sac" else CQLLearner)(p, np.array([2.0], np.float32), cfg, device=device)
    return {"impala": IMPALALearner, "dqn": DQNLearner}[name](p, cfg, device=device)


def rl_update(name, learner, case, i):
    """Update ``i`` of the case on the learner; returns its losses as floats
    (SAC and CQL take the case's draws through ``_update``)."""
    import torch

    from ray_tpu_torch.rl.module import batch_tensors

    batch = case["batch"]
    if name in ("ppo", "multi_agent_ppo"):
        aux = learner.update_minibatch(batch)
        return {"loss": float(aux["loss"])}
    if name == "impala":
        return {"loss": float(learner.update_batch(batch)["loss"])}
    if name == "dqn":
        return {"loss": learner.update_batch(batch)[0]}
    if name.startswith("bc"):
        return {"loss": float(learner.update(batch))}
    noise = {k: torch.as_tensor(v, device=learner.device) for k, v in case["noise"][i].items()}
    aux = learner._update(batch_tensors(batch, learner.device), noise)
    keys = ("q_loss", "pi_loss") if name == "sac" else ("bellman_loss", "cql_loss")
    return {k: float(aux[k]) for k in keys}


def rl_leaves(name, learner):
    """Every tensor the learner updates, as host numpy: the parameters, and
    the target networks and temperature where it has them."""
    from ray_tpu_torch.rl.module import to_numpy

    out = dict(learner.get_weights())
    if name == "dqn":
        out.update({f"target/{k}": v for k, v in to_numpy(learner.target_params).items()})
    if name in ("sac", "cql"):
        out.update({f"target/{k}": v for k, v in to_numpy(learner.target).items()})
        out["log_alpha"] = learner.log_alpha.detach().cpu().numpy()
    return out


def rl_rel_l2(got, want):
    """Per-leaf relative L2 of ``got`` against ``want``, the largest."""
    return max(float(np.linalg.norm(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64))
                     / max(np.linalg.norm(np.asarray(want[k], np.float64)), 1e-30)) for k in want)


def _ma_env():
    from ray_tpu_torch.rl.multi_agent import CueMatchEnv

    return CueMatchEnv(**RL_MA_ENV)


def phase_rl(dev, card):
    """Phase 7i (rl-learners): (a) each learner of RL_LEARNERS built twice
    from the same seed-0 parameters, on the card and on the CPU, and
    RL_UPDATES updates of each on the case's minibatch (SAC and CQL on the
    same draws); (b) MultiAgentPPO on CueMatchEnv with its learner on the
    card. Returns stats."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api as rt_api
    from ray_tpu_torch.rl import MultiAgentPPOConfig

    stats = {"card": card, "a": {}}
    t_start = time.perf_counter()
    for name in RL_LEARNERS:
        case = rl_case(name)
        gpu, cpu = rl_learner(name, case, dev), rl_learner(name, case, "cpu")
        if not all(t.device == dev for t in gpu.params.values()):
            raise AssertionError(f"7i(a) {name}: the card learner's parameters are not on {dev}")
        losses_cpu = [rl_update(name, cpu, case, i) for i in range(RL_UPDATES)]
        losses_gpu, update_ms = [], []
        for i in range(RL_UPDATES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses_gpu.append(rl_update(name, gpu, case, i))
            update_ms.append(1e3 * (time.perf_counter() - t0))
        leaf_err = rl_rel_l2(rl_leaves(name, gpu), rl_leaves(name, cpu))
        loss_err = max(abs(g[k] - c[k]) / max(abs(c[k]), 1e-30)
                       for g, c in zip(losses_gpu, losses_cpu) for k in c)
        stats["a"][name] = dict(leaf_rel_l2=leaf_err, loss_rel=loss_err, losses=losses_gpu, update_ms=update_ms)
        log(f"rl (a) {name}: per-leaf relative L2 {leaf_err:.3e}, loss {loss_err:.3e} (limit {RL_TOL}); "
            f"losses {[{k: round(v, 6) for k, v in d.items()} for d in losses_gpu]}; update ms on the card "
            f"{[round(x, 3) for x in update_ms]}  [{card}]")
        if not (leaf_err <= RL_TOL and loss_err <= RL_TOL):
            raise AssertionError(f"7i(a) {name}: card against CPU: leaves {leaf_err:.3e}, losses {loss_err:.3e}, "
                                 f"limit {RL_TOL}")
        del gpu, cpu

    t_init = time.perf_counter()
    rt.init(num_cpus=RT_CPUS, object_store_memory=RT_STORE_BYTES)
    algo = None
    try:
        algo = MultiAgentPPOConfig(env_ctor=_ma_env, device=str(dev), **RL_MA).build()
        learner = algo.learners["shared"]
        if not all(t.device == dev for t in learner.params.values()):
            raise AssertionError(f"7i(b): MultiAgentPPO's learner is not on {dev}")
        learn = {"s": 0.0, "n": 0}
        update = learner.update_minibatch

        def timed_update(batch):
            t0 = time.perf_counter()
            aux = update(batch)
            torch.cuda.synchronize()
            learn["s"] += time.perf_counter() - t0
            learn["n"] += 1
            return aux

        learner.update_minibatch = timed_update
        iters = []
        result = {}
        for _ in range(RL_MA_ITERS):
            learn.update(s=0.0, n=0)
            result = algo.train()
            iters.append(dict(ret=result["episode_return_mean"], iter_s=result["time_this_iter_s"],
                              learn_s=learn["s"], sample_s=result["time_this_iter_s"] - learn["s"],
                              updates=learn["n"]))
            if result["episode_return_mean"] > RL_MA_BAR:
                break
        n_upd = sum(it["updates"] for it in iters)
        learn_s = sum(it["learn_s"] for it in iters)
        stats["b"] = dict(iterations=len(iters), episode_return_mean=result["episode_return_mean"],
                          iters=iters, updates_per_s=n_upd / learn_s, setup_s=time.perf_counter() - t_init)
        log(f"rl (b): MultiAgentPPO on CueMatchEnv {RL_MA_ENV}: episode_return_mean "
            f"{result['episode_return_mean']:.3f} after {len(iters)} iterations (bar {RL_MA_BAR}); per iteration "
            f"s {[round(it['iter_s'], 3) for it in iters]}, of which learning "
            f"{[round(it['learn_s'], 3) for it in iters]} and sampling (with the host work around it) "
            f"{[round(it['sample_s'], 3) for it in iters]}; {n_upd / learn_s:.1f} learner updates/s  [{card}]")
        if not result["episode_return_mean"] > RL_MA_BAR:
            raise AssertionError(f"7i(b): episode_return_mean {result['episode_return_mean']} <= {RL_MA_BAR} "
                                 f"after {RL_MA_ITERS} iterations")
    finally:
        if algo is not None:
            algo.stop()
        rt.shutdown()
    if rt_api._global_worker is not None or rt_api._LIVE_CLUSTERS:
        raise AssertionError("rt.shutdown() left the runtime up")
    stats["total_s"] = time.perf_counter() - t_start
    return stats


KERNEL_KINDS = (
    ("K1 flash_fwd", ("flash_fwd_kernel",)),
    ("K3 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("K2 flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("K4 paged_decode", ("paged_decode_kernel",)),
    ("GEMM", ("nvjet", "gemm", "cutlass", "xmma")),
    ("optimizer", ("multi_tensor_apply",)),
    ("reduction", ("reduce_kernel",)),
    ("copy", ("Memcpy", "Memset")),
    ("elementwise", ("elementwise_kernel", "CatArrayBatchedCopy")),
)


def _by_kind(device_events):
    """[(kind, device us, kernels)] over the profile's device events, largest first."""
    acc = {}
    for e in device_events:
        kind = next((k for k, subs in KERNEL_KINDS if any(s in e.name for s in subs)), "other")
        us, n = acc.get(kind, (0.0, 0))
        acc[kind] = (us + e.time_range.elapsed_us(), n + 1)
    return sorted(((k, us, n) for k, (us, n) in acc.items()), key=lambda r: -r[1])


def _window_dir(name):
    path = os.path.join(WINDOW_DIR, name)
    os.makedirs(path, exist_ok=True)
    return path


def _hold_window(name, trace_path, summary, launched, exact, span_s=None):
    """Gate and report of one device window. `summary` is
    obs.profiler.trace_summary of the window's trace (so the file exists and
    parses); `launched`: the K1 / K4 launches the wrappers counted in the
    window. Every kernel the window is known to launch must be in the
    trace: exactly as many launches when `exact` (the counts cover the whole
    window), at least as many otherwise (they cover part of it), and K4
    always (each window decodes). Prints the device time (the union of the
    trace's kernels, memcpys and memsets), the wall time and the busy share
    (device over wall; with `span_s`, also over the span the work ran in).
    Returns the row for the JSON line."""
    in_trace = {"flash_fwd": sum(n for k, n in summary["kernels"].items() if K1_NAME in k),
                "paged_decode": sum(n for k, n in summary["kernels"].items() if K4_NAME in k)}
    row = dict(device_ms=summary["device_ms"], wall_ms=summary["wall_ms"], busy=summary["busy"],
               device_events=summary["device_events"], launched=launched, in_trace=in_trace,
               trace_bytes=os.path.getsize(trace_path))
    extra = ""
    if span_s is not None:
        row.update(span_ms=1e3 * span_s, busy_in_span=summary["device_ms"] / (1e3 * span_s))
        extra = f"; busy over the {row['span_ms']:.2f} ms the work ran: {row['busy_in_span']:.4f}"
    log(f"  device window {name}: device {row['device_ms']:.3f} ms in {row['wall_ms']:.3f} ms wall, busy "
        f"share {row['busy']:.4f}{extra}; {row['device_events']} device events; K1 {in_trace['flash_fwd']} / "
        f"K4 {in_trace['paged_decode']} in the trace, {launched['flash_fwd']} / {launched['paged_decode']} "
        f"counted ({'the whole window' if exact else 'part of the window'}); trace {row['trace_bytes']} B")
    if launched["paged_decode"] == 0:
        raise AssertionError(f"device window {name}: no K4 launch counted (the window must decode)")
    for k, n in launched.items():
        if n and (in_trace[k] != n if exact else in_trace[k] < n):
            raise AssertionError(f"device window {name}: {k} launched {n} times, {in_trace[k]} in the trace "
                                 f"{trace_path}")
    return row


def _profile_window(name, fn, out_dir, ops=()):
    """torch.profiler over fn(); writes the kernel table and the trace to
    out_dir and prints the wall time, device kernel time, device time by
    kind, the device time under each of ``ops`` (ops may nest) and top rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernels, copies and memsets; a user annotation's device span (the
    # optimizer's step) covers kernels already counted.
    device_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)]
    dev_us = sum(e.time_range.elapsed_us() for e in device_events)
    ka = prof.key_averages()
    key = "self_device_time_total" if ka and hasattr(ka[0], "self_device_time_total") else "self_cuda_time_total"
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write(ka.table(sort_by=key, row_limit=60))
    prof.export_chrome_trace(os.path.join(out_dir, f"profile_{name}.json"))
    log(f"profile {name}: wall {wall * 1e3:.2f} ms, device kernel time {dev_us / 1e3:.2f} ms "
        f"(busy share {dev_us / 1e6 / wall:.3f}), {len(device_events)} device events")
    for kind, us, n in _by_kind(device_events):
        log(f"  {kind}: {us / 1e3:.2f} ms ({100 * us / max(dev_us, 1e-9):.1f} %, {n} events)")
    total = "device_time_total" if ka and hasattr(ka[0], "device_time_total") else "cuda_time_total"
    for row in (r for r in ka if r.key in ops):
        us = getattr(row, total)
        log(f"  under {row.key}: {us / 1e3:.2f} ms ({100 * us / max(dev_us, 1e-9):.1f} %, {row.count} calls)")
    log(ka.table(sort_by=key, row_limit=12))


def profile_engine(eng, prompts, out_dir, max_tokens=MAX_TOKENS, prefix=""):
    """The paged engine under torch.profiler: the admission step (32
    prefills and the first decode block), then two decode-only steps."""
    os.makedirs(out_dir, exist_ok=True)
    for i, p in enumerate(prompts):
        eng.add_request(f"p{i}", p, max_tokens)
    _profile_window(f"{prefix}admit_step", eng.step, out_dir)
    _profile_window(f"{prefix}decode_2_steps", lambda: (eng.step(), eng.step()), out_dir)
    while eng.has_work():
        eng.step()


# Phase 6j (serve-tp-250M) and 7j (parallel-train-250M): the tensor-parallel
# engine and the sharded training steps over SLOTS_TP slots of cuda:0
# (RAY_TPU_TORCH_DEVICE_SLOTS, set for these phases only). TP_FULL runs
# phase 6's 32 prompts, the other degrees the first TP_SHORT.
SLOTS_TP = 4
TP_DEGREES, TP_FULL, TP_SHORT = (2, 4), 2, 8
PAR_B, PAR_STEPS = 8, 3  # 7j: rows 0-7 of the training batch, steps per case
PAR_LOSS_RTOL, PAR_GNORM_RTOL = 1e-3, 1e-2
# After step 1, against the single-slot step: every leaf's gradient
# (relative L2) and the updated wq (relative L2; AdamW's first update is
# lr x sign(g), so only signs that bf16 noise flips move it).
PAR_GRAD_RTOL, PAR_WQ_RTOL = 5e-2, 5e-3
# (name, mesh axes, strategy, attention_impl, pipeline microbatches)
PAR_CASES = (("dp2_tp2", dict(data=2, tensor=2), "dp+tp", "auto", 0),
             ("fsdp4", dict(fsdp=4), "fsdp", "auto", 0),
             ("ulysses_seq4", dict(seq=4), "dp+sp", "ulysses", 0),
             ("ring_seq4", dict(seq=4), "dp+sp", "ring", 0),
             ("pipeline_stage4", dict(stage=4), "dp+pp", "auto", 4))


class _slots:
    """RAY_TPU_TORCH_DEVICE_SLOTS=n for a with-block; the earlier value (or
    its absence) is restored after it."""

    def __init__(self, n):
        self.n = n

    def __enter__(self):
        from ray_tpu_torch.parallel.mesh import SLOTS_ENV

        self.old = os.environ.get(SLOTS_ENV)
        os.environ[SLOTS_ENV] = str(self.n)

    def __exit__(self, *exc):
        from ray_tpu_torch.parallel.mesh import SLOTS_ENV

        if self.old is None:
            os.environ.pop(SLOTS_ENV, None)
        else:
            os.environ[SLOTS_ENV] = self.old


def _tp_logits(eng, prompts):
    """The engine's prefill logits [n, V] for whole prompts, groups of 8
    against the dead page (as check_first_tokens)."""
    import torch

    out = []
    with torch.no_grad():
        for i in range(0, len(prompts), 8):
            part = np.stack(prompts[i:i + 8])
            m, P = part.shape
            out.append(eng._prefill_logits(part, np.full(m, P, np.int32),
                                           np.zeros((m, P // eng.ec.page_size), np.int32)))
    return torch.cat(out)


def _shard_checks(eng, tp):
    """Each slot's wq heads, w_gate columns and pool KV heads, every shard
    its own contiguous, 16-byte aligned tensor."""
    shapes = dict(wq=[s.data.shape[2] for s in eng.params["layers"]["wq"].addressable_shards],
                  w_gate=[s.data.shape[2] for s in eng.params["layers"]["w_gate"].addressable_shards],
                  k_pool=[s.data.shape[1] for s in eng.k_pages.addressable_shards])
    want = dict(wq=[H // tp] * tp, w_gate=[MODEL["d_ff"] // tp] * tp, k_pool=[KV // tp] * tp)
    leaves = [eng.params["embed"], eng.params["final_norm"], eng.params["lm_head"], eng.k_pages, eng.v_pages,
              *eng.params["layers"].values()]
    bad = [s.data.shape for t in leaves for s in t.addressable_shards
           if not s.data.is_contiguous() or s.data.data_ptr() % 16]
    if shapes != want or bad:
        raise AssertionError(f"TP-{tp} shards: {shapes} != {want}, or not contiguous/aligned: {bad}")
    return shapes


def _forced_streams(eng, prompts, forced=None):
    """Drives ``prompts`` with ``eng._sample`` wrapped: every call's fp32
    logits are recorded beside whether it is a decode step and which slots
    hold a request then. With ``forced`` (an earlier recording on the same
    prompts) the wrapper returns that run's tokens instead of sampling, so
    this engine decodes the same streams on its own KV cache and every call
    lines up with the recorded one. Returns the recording; with ``forced``
    also the max and mean |logits - forced logits| over the decode steps'
    occupied rows."""
    import torch

    calls, in_decode = [], [False]
    sample, decode = eng._sample, eng._decode

    def recorded(logits, *a):
        i = len(calls)
        toks = sample(logits, *a) if forced is None else forced[i][3]
        rows = [j for j, s in enumerate(eng.slots) if s is not None] if in_decode[0] else None
        calls.append((logits.float(), in_decode[0], rows, toks))
        return toks

    def flagged(n, gen):
        in_decode[0] = True
        try:
            return decode(n, gen)
        finally:
            in_decode[0] = False

    eng._sample, eng._decode = recorded, flagged
    try:
        drive(eng, prompts, MAX_TOKENS, prefix="f")
    finally:
        del eng._sample, eng._decode  # back to the class's methods
    if forced is None:
        return calls
    if len(calls) != len(forced):
        raise AssertionError(f"the forced run made {len(calls)} sampling calls, the recorded one {len(forced)}")
    worst, total, count = 0.0, 0.0, 0
    for (got, dec, rows, _), (want, dec_w, rows_w, _) in zip(calls, forced):
        if dec != dec_w or rows != rows_w:
            raise AssertionError("the forced run's schedule differs from the recorded one")
        if dec:
            diff = (got[rows] - want[rows]).abs()
            if not bool(torch.isfinite(got[rows]).all()):
                raise AssertionError("non-finite decode logits")
            worst = max(worst, diff.max().item())
            total += diff.sum().item()
            count += diff.numel()
    return calls, worst, total / count


def _k4_shards(dev, eng, tp):
    """K4 through paged_attention's mesh branch at the TP engine's decode
    shape (32 sequences, 16/tp heads and 4/tp KV heads per slot, page 128,
    16 pages a sequence): each slot's output against
    paged_attention_reference on the same q and pool shards, at the K4
    phase's tolerance (2e-2), and the gathered output against the
    reference on the whole tensors. Returns the worst |o - o_ref|."""
    import torch

    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.parallel.sharding import NamedSharding
    from ray_tpu_torch.parallel.sharding import PartitionSpec as P
    from ray_tpu_torch.parallel.sharding import device_put

    rng = np.random.default_rng(15)
    ppseq = eng.ppseq
    lengths = [int(n) for n in rng.integers(PROMPT_LEN + 1, PROMPT_LEN + MAX_TOKENS + 1, SLOTS)]
    lengths[:3] = [0, 1, ppseq * PAGE]
    q, kp, vp, lens, table = _paged_case(dev, rng, lengths, PAGE, ppseq, H, KV, D)
    pool = NamedSharding(eng.mesh, P("tensor", None, None, None))
    qs = device_put(q, NamedSharding(eng.mesh, P(None, "tensor", None)))
    kps, vps = device_put(kp, pool), device_put(vp, pool)
    o = pa.paged_attention(qs, kps, vps, lens, table, mesh=eng.mesh)
    torch.cuda.synchronize()
    err = 0.0
    for so, sq, sk, sv in zip(o.addressable_shards, qs.addressable_shards, kps.addressable_shards,
                              vps.addressable_shards):
        if so.data.shape != (SLOTS, H // tp, D) or sk.data.shape[0] != KV // tp:
            raise AssertionError(f"K4 TP-{tp} shard shapes q {tuple(so.data.shape)} pool {tuple(sk.data.shape)}")
        want = pa.paged_attention_reference(sq.data.float(), sk.data.float(), sv.data.float(), lens, table)
        err = max(err, (so.data.float() - want).abs().max().item())
    whole = (o.full().float() - pa.paged_attention_reference(q.float(), kp.float(), vp.float(), lens, table)).abs()
    err = max(err, whole.max().item())
    log(f"K4 per slot at TP {tp} (H {H // tp} KV {KV // tp} a slot, B {SLOTS}, lengths {min(lengths)}..{max(lengths)}): "
        f"max|o-ref| {err:.3e}")
    if not (err <= 2e-2 and bool(torch.isfinite(o.full()).all())):
        raise AssertionError(f"K4 per slot at TP {tp} disagrees with paged_attention_reference: {err}")
    return err


def _tp_handoff(dev, eng, cfg, prompts, tokens):
    """The TP-2 tree through the object store: one buffer per unique shard,
    bytes equal to the unique shards' bytes; an engine on the fetched tree
    gives the same greedy tokens."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core import serialization as S
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models.transformer import leaves

    uniq = [m for leaf in leaves(eng.params) for m in leaf.masters()]
    want_bytes = sum(t.numel() * t.element_size() for t in uniq)
    parts, _refs, _total = S.serialize_parts(eng.params)
    payloads = parts[2:-1:2]
    shipped = sum(memoryview(p).nbytes for p in payloads)
    if len(payloads) != len(uniq) or shipped != want_bytes:
        raise AssertionError(f"TP-2 tree ships {len(payloads)} buffers / {shipped} bytes, "
                             f"want {len(uniq)} / {want_bytes}")
    t0 = time.perf_counter()
    rt.init(num_cpus=2, object_store_memory=RT_STORE_BYTES)
    try:
        ref = rt.put(eng.params)
        fetched = rt.get(ref, timeout=RT_TIMEOUT_S)
    finally:
        rt.shutdown()
    hop_s = time.perf_counter() - t0
    wq = fetched["layers"]["wq"]
    if len(wq.masters()) != 2 or not all(s.data.device.type == dev.type for s in wq.addressable_shards):
        raise AssertionError(f"the fetched TP-2 tree lost its shards: {wq}")
    served = LLMEngine(cfg, params=fetched, engine_config=EngineConfig(
        max_slots=SLOTS, max_seq=2048, kv_layout="paged", page_size=PAGE, seed=0, tensor_parallel=2))
    del fetched
    done, _ttft, _t0, _t1 = drive(served, prompts, MAX_TOKENS)
    got = [done[f"r{i}"]["tokens"] for i in range(len(prompts))]
    if got != tokens:
        raise AssertionError("an engine on the TP-2 tree fetched through the object store gives other tokens")
    del served
    torch.cuda.empty_cache()
    return dict(buffers=len(payloads), bytes=shipped, rt_hop_s=hop_s, tokens_equal=True)


def phase_serve_tp(dev, card, phase6):
    """Phase 6j (serve-tp-250M). Returns (stats, launches summed over the
    TP runs' drives)."""
    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.ops import attention, paged_attention

    prompts, tokens6 = phase6
    cfg = TransformerConfig(**MODEL)
    ec = dict(max_slots=SLOTS, max_seq=2048, kv_layout="paged", page_size=PAGE, seed=0)
    out = dict(card=card, slots=SLOTS_TP, degrees={})
    launches = {"flash_fwd": 0, "paged_decode": 0}
    with _slots(SLOTS_TP):
        one = LLMEngine(cfg, engine_config=EngineConfig(**ec))
        ref_logits = _tp_logits(one, prompts)
        # TP 1's greedy streams of the first TP_SHORT prompts and the logits
        # of every decode step, which each TP engine is then held to on the
        # same streams.
        forced = _forced_streams(one, prompts[:TP_SHORT])
        del one
        torch.cuda.empty_cache()
        for tp in TP_DEGREES:
            n = len(prompts) if tp == TP_FULL else TP_SHORT
            t0 = time.perf_counter()
            eng = LLMEngine(cfg, engine_config=EngineConfig(**ec, tensor_parallel=tp))
            built_s = time.perf_counter() - t0
            shapes = _shard_checks(eng, tp)
            eng.warmup()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            groups, steps, undo = _count_calls(eng)
            attention.LAUNCHES = paged_attention.LAUNCHES = 0
            done, ttft, t0, t1 = drive(eng, prompts[:n], MAX_TOKENS)
            got = {"flash_fwd": attention.LAUNCHES, "paged_decode": paged_attention.LAUNCHES}
            undo()
            want = {"flash_fwd": tp * cfg.n_layers * len(groups), "paged_decode": tp * cfg.n_layers * sum(steps)}
            stats = serve_stats(done, ttft, t0, t1)
            if not _finished(done, n, cfg.vocab_size):
                raise AssertionError(f"TP-{tp} run did not finish every request with {MAX_TOKENS} valid tokens")
            if got != want:
                raise AssertionError(f"TP-{tp} launches {got} != {want} (tp x layers per prefill group / decode step)")
            for k in launches:
                launches[k] += got[k]
            logits = _tp_logits(eng, prompts[:n])
            diff = (logits - ref_logits[:n]).abs()
            if not (bool(torch.isfinite(logits).all()) and diff.max() <= 0.25 and diff.mean() <= 0.02):
                raise AssertionError(f"TP-{tp} prefill logits vs TP 1: max {diff.max().item()} mean {diff.mean().item()}")
            # Decode on the card at this degree's shapes: K4 per slot against
            # its plain version, and the decode-step logits on TP 1's forced
            # streams within phase 6's bounds of TP 1's.
            k4_err = _k4_shards(dev, eng, tp)
            _, dec_max, dec_mean = _forced_streams(eng, prompts[:TP_SHORT], forced)
            if not (dec_max <= 0.25 and dec_mean <= 0.02):
                raise AssertionError(f"TP-{tp} decode logits on TP 1's streams: max {dec_max} mean {dec_mean}")
            toks = [done[f"r{i}"]["tokens"] for i in range(n)]
            same = sum(t == tokens6[f"r{i}"] for i, t in enumerate(toks))
            first_div = min((next(j for j, (a, b) in enumerate(zip(t, tokens6[f"r{i}"])) if a != b), i)
                            for i, t in enumerate(toks) if t != tokens6[f"r{i}"]) if same < n else None
            row = dict(requests=n, built_s=built_s, shard_dims=shapes, launches=got, prefill_groups=len(groups),
                       decode_steps=sum(steps), logits_max_diff=diff.max().item(),
                       logits_mean_diff=diff.mean().item(), k4_per_slot_max_abs_err=k4_err,
                       decode_logits_max_diff=dec_max, decode_logits_mean_diff=dec_mean,
                       greedy_streams_equal_tp1=same,
                       first_divergence=None if first_div is None else dict(token=first_div[0], request=first_div[1]),
                       **stats)
            log(f"serve tp {tp}: {n} requests x {MAX_TOKENS} tokens over {tp} slots of {dev}, TTFT p50 "
                f"{stats['ttft_p50_ms']:.2f} ms p99 {stats['ttft_p99_ms']:.2f} ms, decode {stats['decode_tok_s']:.1f} "
                f"tok/s, peak mem {stats['peak_mem_gb']:.2f} GB  [{card}]")
            log(f"  launches K1 {got['flash_fwd']} ({len(groups)} groups) K4 {got['paged_decode']} ({sum(steps)} steps); "
                f"prefill logits vs TP 1: max {diff.max().item():.4f} mean {diff.mean().item():.5f}; greedy streams "
                f"equal to TP 1: {same}/{n}, first divergence {row['first_divergence']}")
            log(f"  decode on TP 1's streams ({TP_SHORT} prompts, {len(forced)} sampling calls): logits vs TP 1 max "
                f"{dec_max:.4f} mean {dec_mean:.5f}; K4 per slot max|o-ref| {k4_err:.3e}")
            if tp == 2:
                # Two TP-2 runs bitwise equal (tokens and prefill logits).
                done2, _, _, _ = drive(eng, prompts[:TP_SHORT], MAX_TOKENS, prefix="s")
                again = [done2[f"s{i}"]["tokens"] for i in range(TP_SHORT)]
                if again != toks[:TP_SHORT] or not torch.equal(_tp_logits(eng, prompts[:TP_SHORT]),
                                                               logits[:TP_SHORT]):
                    raise AssertionError("two TP-2 runs are not bitwise equal")
                row["rerun_bitwise_equal"] = True
                row["handoff"] = _tp_handoff(dev, eng, cfg, prompts[:TP_SHORT], toks[:TP_SHORT])
                log(f"  rerun bitwise equal; rt.put/rt.get of the TP-2 tree: {row['handoff']['buffers']} buffers, "
                    f"{row['handoff']['bytes']} bytes (the unique shards'), {row['handoff']['rt_hop_s']:.2f} s, "
                    f"tokens equal")
            out["degrees"][str(tp)] = row
            del eng
            torch.cuda.empty_cache()
    return out, launches


def _expected_shard(shape, spec, mesh):
    from ray_tpu_torch.parallel.sharding import entry_axes

    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // math.prod(mesh.shape[a] for a in entry_axes(e)) for n, e in zip(shape, spec))


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _leaf_names(params) -> list:
    """Names of models.transformer.leaves(params), in its order."""
    return ["embed", *(f"layers/{k}" for k in params["layers"]), "final_norm", "lm_head"]


def _sharded_grad(leaf):
    """A ShardedTensor parameter's gradient as one tensor: its master
    shards' grads, assembled under its spec."""
    from ray_tpu_torch.parallel.sharding import ShardedTensor

    grads = [leaf.locals[leaf.master_of(s)].grad for s in range(leaf.mesh.size)]
    return ShardedTensor(grads, leaf.sharding, leaf.shape).full()


def phase_parallel_train(dev, card):
    """Phase 7j (parallel-train-250M). Returns (stats, launches summed over
    the cases' timed steps)."""
    import torch

    from ray_tpu_torch.models import TransformerConfig, make_pipeline_train_step, make_train_step, state_logical_axes
    from ray_tpu_torch.models.transformer import leaves
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel import MeshSpec, ShardingStrategy, device_put, devices, shard_pytree, use_strategy

    base = TransformerConfig(**MODEL, remat=True, remat_policy="dots")
    L = base.n_layers

    def fresh(cfg):
        init_state, step = make_train_step(cfg)
        g = torch.Generator(device=dev).manual_seed(0)
        state = init_state(g, device=dev)
        toks = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1), generator=g, device=dev)[:PAR_B]
        return state, step, toks

    def k123():
        return {"flash_fwd": attention.LAUNCHES, "flash_bwd_dq": attention.BWD_DQ_LAUNCHES,
                "flash_bwd_dkv": attention.BWD_DKV_LAUNCHES}

    state, step, toks = fresh(base)
    torch.cuda.reset_peak_memory_stats()
    ref, ref_ms = [], []
    for i in range(PAR_STEPS):
        t0 = time.perf_counter()
        ref.append(step(state, {"tokens": toks}))
        torch.cuda.synchronize()
        ref_ms.append(1e3 * (time.perf_counter() - t0))
        if i == 0:  # step 1's gradients and updated wq, which every case is held to
            ref_grads = [t.grad.detach().clone() for t in leaves(state["params"])]
            ref_wq = state["params"]["layers"]["wq"].detach().clone()
    ref_loss = [m["loss"].item() for m in ref]
    ref_norm = [m["grad_norm"].item() for m in ref]
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    del state
    torch.cuda.empty_cache()
    log(f"train parallel: single-slot reference B {PAR_B} x S {TRAIN_S}: loss {' '.join(f'{x:.4f}' for x in ref_loss)}"
        f"  grad_norm {' '.join(f'{x:.3f}' for x in ref_norm)}, step ms {' '.join(f'{x:.1f}' for x in ref_ms)}, "
        f"peak mem {ref_peak:.2f} GB  [{card}]")
    out = dict(card=card, slots=SLOTS_TP, batch=[PAR_B, TRAIN_S], reference_loss=ref_loss,
               reference_grad_norm=ref_norm, reference_step_ms=ref_ms, reference_peak_mem_gb=ref_peak, cases={})
    launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    with _slots(SLOTS_TP):
        for name, axes, strat_name, impl, n_micro in PAR_CASES:
            cfg = dataclasses.replace(base, attention_impl=impl)
            state, step, toks = fresh(cfg)
            mesh = MeshSpec(**axes).build(devices())
            strat = ShardingStrategy.named(strat_name)
            if n_micro:
                _, step = make_pipeline_train_step(cfg, mesh, n_micro=n_micro)
            with use_strategy(strat), mesh:
                st = shard_pytree(state, state_logical_axes(state, cfg), mesh, strat)
                del state
                bad = [(s.data.shape, _expected_shard(leaf.shape, leaf.spec, mesh)) for leaf in leaves(st["params"])
                       for s in leaf.addressable_shards
                       if tuple(s.data.shape) != _expected_shard(leaf.shape, leaf.spec, mesh)]
                if bad:
                    raise AssertionError(f"7j {name}: shards off their spec: {bad[:4]}")
                batch = {"tokens": device_put(toks, strat.sharding(mesh, ("batch", None)))}
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                attention.LAUNCHES = attention.BWD_DQ_LAUNCHES = attention.BWD_DKV_LAUNCHES = 0
                times, ms = [], []
                for i in range(PAR_STEPS):
                    t0 = time.perf_counter()
                    ms.append(step(st, batch))
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    if i == 0:  # gathers only: no kernel launches
                        with torch.no_grad():
                            errs = {n: _rel_l2(_sharded_grad(leaf), g) for n, leaf, g
                                    in zip(_leaf_names(st["params"]), leaves(st["params"]), ref_grads)}
                            worst = max(errs, key=errs.get)
                            grad_err = errs[worst]
                            wq_err = _rel_l2(st["params"]["layers"]["wq"].full(), ref_wq)
                got = k123()
            loss = [m["loss"].item() for m in ms]
            norm = [m["grad_norm"].item() for m in ms]
            rel_l = [abs(a - b) / abs(b) for a, b in zip(loss, ref_loss)]
            rel_n = [abs(a - b) / abs(b) for a, b in zip(norm, ref_norm)]
            row = dict(mesh=axes, strategy=strat_name, attention_impl=impl, n_micro=n_micro, loss=loss,
                       grad_norm=norm, loss_rel_err=max(rel_l), grad_norm_rel_err=max(rel_n),
                       step1_grad_rel_l2_max=grad_err, step1_grad_worst_leaf=worst, step1_wq_rel_l2=wq_err,
                       step_ms=[1e3 * t for t in times], peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                       launches=got)
            log(f"train parallel {name} ({strat_name}, {impl}{f', n_micro {n_micro}' if n_micro else ''}): loss "
                f"{' '.join(f'{x:.4f}' for x in loss)} (rel {max(rel_l):.2e}), grad_norm "
                f"{' '.join(f'{x:.3f}' for x in norm)} (rel {max(rel_n):.2e}), step 1's grads rel L2 <= "
                f"{grad_err:.2e} (worst leaf {worst}), wq {wq_err:.2e}, step ms "
                f"{' '.join(f'{1e3 * t:.1f}' for t in times)}, peak mem {row['peak_mem_gb']:.2f} GB, launches K1 "
                f"{got['flash_fwd']} K3 {got['flash_bwd_dq']} K2 {got['flash_bwd_dkv']}  [{card}]")
            if not (all(math.isfinite(x) for x in loss + norm) and max(rel_l) <= PAR_LOSS_RTOL
                    and max(rel_n) <= PAR_GNORM_RTOL and loss[-1] < loss[0]
                    and grad_err <= PAR_GRAD_RTOL and wq_err <= PAR_WQ_RTOL):
                raise AssertionError(f"7j {name}: loss {loss} / grad_norm {norm} vs the single-slot step "
                                     f"{ref_loss} / {ref_norm}; step 1's grads rel L2 {grad_err}, wq {wq_err}")
            # Exact launches: one flash call per slot (or microbatch) per layer,
            # K1 twice under remat "dots".
            calls = {"dp2_tp2": SLOTS_TP, "ulysses_seq4": SLOTS_TP, "pipeline_stage4": n_micro}.get(name)
            if calls is not None:
                want = {"flash_fwd": 2 * calls * L * PAR_STEPS, "flash_bwd_dq": calls * L * PAR_STEPS,
                        "flash_bwd_dkv": calls * L * PAR_STEPS}
                if got != want:
                    raise AssertionError(f"7j {name}: launches {got} != {want}")
            for k in launches:
                launches[k] += got[k]
            out["cases"][name] = row
            del st, batch
            torch.cuda.empty_cache()
    return out, launches


# Phase 6k: the operator surface. A cluster started and stopped through the
# port's CLI (OPS_CPUS CPUs and the card on its head); (b) K1 in num_gpus=1
# runtime_env tasks at phase 3's shape (B, S of OPS_K1; H, KV, D; causal; a
# pad segment), with the seed of its inputs; (c) a job serving OPS_JOB_N of
# phase 6's prompts x OPS_JOB_TOKENS greedy tokens on phase 6's engine;
# (f) the quick seed-0 day replayed at OPS_DAY_WARP by OPS_DAY_SENDERS
# client threads (enough for the storm's arrivals at the deadlines' ~1 s)
# against one GPU replica admitting OPS_DAY_ONGOING requests at once (the
# rest wait in the handle's fair queue, where the proxy's admission control
# sees them) and answering prompts of at most OPS_DAY_PROMPT seeded tokens
# with OPS_DAY_TOKENS new tokens. Every wait is bounded by OPS_TIMEOUT_S.
OPS_CPUS, OPS_TIMEOUT_S = 8, 300.0
OPS_K1, OPS_K1_SEED = (1, 1000), 6
OPS_JOB_N, OPS_JOB_TOKENS = 8, 32
OPS_ENGINE = dict(max_slots=SLOTS, max_seq=2048, kv_layout="paged", page_size=PAGE, seed=0)
OPS_DAY_PROMPT, OPS_DAY_TOKENS, OPS_DAY_WARP, OPS_DAY_SENDERS, OPS_DAY_ONGOING = 512, 16, 2.0, 192, 16
# The module (b) ships in py_modules, installs as a local package into a pip venv,
# and (e)'s task imports: seeded K1 inputs at phase 3's shape and one K1
# launch on them in the importing worker.
OPS_PROBE_SRC = f'''"""K1 on seeded inputs in the importing process (chip_smoke.py phase 6k)."""
import os
import sys

import numpy as np

B, S, H, KV, D = {OPS_K1[0]}, {OPS_K1[1]}, {H}, {KV}, {D}


def inputs(seed, dev):
    """q, k, v [B, S, *, D] bf16 and a pad segment [B, S] int32 from `seed`."""
    import torch

    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, D), dtype=np.float32)).to(dev, torch.bfloat16)
               for h in (H, KV, KV))
    lens = rng.integers(S // 2, S + 1, B)
    seg = torch.from_numpy((np.arange(S)[None, :] >= lens[:, None]).astype(np.int32)).to(dev)
    return q, k, v, seg


def run(seed, env_key=""):
    """K1 (ops.attention.flash_fwd, causal) on inputs(seed) on the card."""
    import torch

    from ray_tpu_torch.ops import attention

    if not torch.cuda.is_available():
        raise RuntimeError("a num_gpus=1 worker sees no CUDA device")
    q, k, v, seg = inputs(seed, "cuda")
    attention.LAUNCHES = 0
    o, lse = attention.flash_fwd(q, k, v, segment_ids=seg, causal=True)
    torch.cuda.synchronize()
    return dict(o=o.cpu(), lse=lse.cpu(), launches=attention.LAUNCHES, pid=os.getpid(), cwd=os.getcwd(),
                exe=sys.executable, env=os.environ.get(env_key), module=__file__,
                device=torch.cuda.get_device_name(0))
'''
# The job's entrypoint (c): phase 6's engine built on the card in the job's
# own process, a drive of the prompts in OPS_JOB_PROMPTS, one JSON line of
# its tokens and launches; its prefill logits go to OPS_JOB_LOGITS.
OPS_JOB_SRC = '''"""Phase 6k(c)'s job: phase 6's engine on cuda serving the prompts in
$OPS_JOB_PROMPTS (chip_smoke.py phase 6k)."""
import json
import os
import time

import numpy as np
import torch

import chip_smoke as cs
from ray_tpu_torch.llm import EngineConfig, LLMEngine
from ray_tpu_torch.models import TransformerConfig
from ray_tpu_torch.ops import attention, paged_attention

t0 = time.perf_counter()
prompts = list(np.load(os.environ["OPS_JOB_PROMPTS"]))
eng = LLMEngine(TransformerConfig(**cs.MODEL), engine_config=EngineConfig(**cs.OPS_ENGINE), device="cuda")
eng.warmup(buckets=(cs.PROMPT_LEN,))
attention.LAUNCHES = paged_attention.LAUNCHES = 0
done, ttft, d0, d1 = cs.drive(eng, prompts, cs.OPS_JOB_TOKENS)
launches = {"flash_fwd": attention.LAUNCHES, "paged_decode": paged_attention.LAUNCHES}
with torch.no_grad():
    torch.save(cs.served_logits(eng, np.stack(prompts)).cpu(), os.environ["OPS_JOB_LOGITS"])
print(json.dumps({"tokens": {rid: [int(t) for t in ev["tokens"]] for rid, ev in done.items()},
                  "launches": launches, "drive_s": d1 - d0, "job_s": time.perf_counter() - t0,
                  "device": torch.cuda.get_device_name(0),
                  "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}), flush=True)
'''


def _ops_cli(env, *args, timeout=OPS_TIMEOUT_S, check=True):
    """`python -m ray_tpu_torch ARGS` from the repo root; (rc, stdout, seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args], env=env, capture_output=True,
                         text=True, timeout=timeout, cwd=os.path.dirname(os.path.abspath(__file__)))
    if check and out.returncode != 0:
        raise AssertionError(f"`python -m ray_tpu_torch {' '.join(args)}` exited {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return out.returncode, out.stdout, time.perf_counter() - t0


def _ops_probe(path):
    """The probe module (OPS_PROBE_SRC) loaded from its file in this process."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("k1probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ops_hold_k1(dev, probe, out, desc):
    """A probe's K1 result against mha_reference in fp32 on the same seeded
    inputs: phase 3's bounds (2e-2 on o, 1e-3 on LSE) and launches > 0."""
    import torch

    q, k, v, seg = probe.inputs(OPS_K1_SEED, dev)
    o_ref, lse_ref = _mha_rows(q.float(), k.float(), v.float(), True, seg)
    o, lse = out["o"].to(dev), out["lse"].to(dev)
    err = (o.float() - o_ref).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    finite = bool(torch.isfinite(o).all())
    log(f"  {desc}: K1 launches {out['launches']} in pid {out['pid']} ({out['device']}), "
        f"max|o-ref| {err:.3e} max|lse-ref| {lse_err:.3e} finite {finite}")
    if not (out["launches"] > 0 and finite and err <= 2e-2 and lse_err <= 1e-3):
        raise AssertionError(f"6k {desc}: K1 in the task disagrees with its plain version or never launched")
    return dict(launches=out["launches"], max_abs_err=err, lse_err=lse_err)


def _ops_package(dirpath, name, src):
    """A local package directory `name` (its __init__ is `src`) that pip
    installs with --no-index --no-build-isolation (setuptools from the base
    environment). Returns its path."""
    root = os.path.join(dirpath, name)
    os.makedirs(os.path.join(root, name))
    with open(os.path.join(root, "pyproject.toml"), "w") as f:
        f.write(f"[build-system]\nrequires = []\nbuild-backend = 'setuptools.build_meta'\n"
                f"[project]\nname = '{name}'\nversion = '0.1'\n")
    with open(os.path.join(root, name, "__init__.py"), "w") as f:
        f.write(src)
    return root


def _ops_runtime_env(rt, dev, work):
    """6k(b): K1 in num_gpus=1 tasks given a runtime_env: working_dir +
    py_modules + env_vars, then a pip venv with a local package."""
    wd, mods, pkgs = (os.path.join(work, d) for d in ("wd", "mods", "pkgs"))
    for d in (wd, os.path.join(mods, "k1probe"), pkgs):
        os.makedirs(d)
    marker = f"working dir of 6k {os.getpid()}"
    with open(os.path.join(wd, "marker.txt"), "w") as f:
        f.write(marker)
    with open(os.path.join(mods, "k1probe", "__init__.py"), "w") as f:
        f.write(OPS_PROBE_SRC)
    probe = _ops_probe(os.path.join(mods, "k1probe", "__init__.py"))
    renv = {"working_dir": wd, "py_modules": [mods], "env_vars": {"OPS_6K": marker}}

    @rt.remote(num_gpus=1, runtime_env=renv)
    def shipped(seed):
        import k1probe

        out = k1probe.run(seed, "OPS_6K")
        with open("marker.txt") as f:
            out["marker"] = f.read()
        return out

    t0 = time.perf_counter()
    out = rt.get(shipped.remote(OPS_K1_SEED), timeout=OPS_TIMEOUT_S)
    task_s = time.perf_counter() - t0
    ok_env = out["env"] == marker and out["marker"] == marker
    in_wd = "runtime_envs" in out["cwd"] and os.path.realpath(out["cwd"]) != os.path.realpath(wd)
    log(f"  working_dir + py_modules + env_vars task: {task_s:.2f} s, env var seen {out['env'] == marker}, "
        f"cwd {out['cwd']} (the materialized working_dir: {in_wd}), module {out['module']}")
    if not (ok_env and in_wd and "runtime_envs" in out["module"] and out["pid"] != os.getpid()):
        raise AssertionError(f"6k(b): the task did not run in its runtime_env: {({k: out[k] for k in ('env', 'cwd', 'module', 'marker')})}")
    held = _ops_hold_k1(dev, probe, out, "runtime_env task")

    pkg = _ops_package(pkgs, "k1probe_pkg", OPS_PROBE_SRC)

    @rt.remote(num_gpus=1, runtime_env={"pip": [pkg], "pip_install_options": ["--no-index", "--no-build-isolation"]})
    def in_venv(seed):
        import k1probe_pkg

        return k1probe_pkg.run(seed)

    t0 = time.perf_counter()
    vout = rt.get(in_venv.remote(OPS_K1_SEED), timeout=OPS_TIMEOUT_S)
    venv_s = time.perf_counter() - t0
    in_venv_exe = "/runtime_envs/venvs/" in vout["exe"]
    log(f"  pip venv task (a local package, --no-index, --system-site-packages): {venv_s:.2f} s with the "
        f"venv's build, sys.executable {vout['exe']} (the venv's: {in_venv_exe})")
    if not in_venv_exe:
        raise AssertionError(f"6k(b): the pip task ran on {vout['exe']}, not its venv's interpreter")
    vheld = _ops_hold_k1(dev, probe, vout, "pip venv task")
    engines = {e: shutil.which(e) for e in ("podman", "docker")}
    log(f"  container engines on this machine (the container path is not run here): {engines}")
    return dict(task_s=task_s, venv_s=venv_s, task=held, venv=vheld, container_engines=engines,
                launches=held["launches"] + vheld["launches"]), probe


def _ops_job(rt, dev, env, addr, work, prompts):
    """6k(c): `job submit --wait` of OPS_JOB_SRC; its tokens against this
    process's own drive, its prefill logits against the plain forward."""
    import torch

    from ray_tpu_torch.job import JobSubmissionClient
    from ray_tpu_torch.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.ops import attention, paged_attention

    script = os.path.join(work, "serve_job.py")
    with open(script, "w") as f:
        f.write(OPS_JOB_SRC)
    np.save(os.path.join(work, "job_prompts.npy"), np.stack(prompts))
    logits_path = os.path.join(work, "job_logits.pt")
    entry = (f"cd {work} && OPS_JOB_PROMPTS={work}/job_prompts.npy OPS_JOB_LOGITS={logits_path} "
             f"{sys.executable} serve_job.py")
    rc, out, submit_s = _ops_cli(env, "--address", addr, "job", "submit", "--wait", entry)
    job_id, status = out.split()[-2:]
    client = JobSubmissionClient()
    logs = client.get_job_logs(job_id)
    log(f"  job {job_id}: submit -> {status} in {submit_s:.2f} s (the CLI's whole run)")
    if status != "SUCCEEDED":
        raise AssertionError(f"6k(c): job {job_id} ended {status}; its log:\n{logs[-4000:]}")
    res = json.loads([ln for ln in logs.splitlines() if ln.startswith("{")][-1])
    log(f"  job's engine on {res['device']} (CUDA_VISIBLE_DEVICES {res['cuda_visible_devices']!r}): "
        f"{len(res['tokens'])} requests x {OPS_JOB_TOKENS} tokens, drive {res['drive_s']:.3f} s, "
        f"script {res['job_s']:.2f} s, launches K1 {res['launches']['flash_fwd']} K4 "
        f"{res['launches']['paged_decode']}")
    if not (res["launches"]["flash_fwd"] > 0 and res["launches"]["paged_decode"] > 0):
        raise AssertionError(f"6k(c): a kernel of the job's path was never launched: {res['launches']}")
    cfg = TransformerConfig(**MODEL)
    eng = LLMEngine(cfg, engine_config=EngineConfig(**OPS_ENGINE))
    eng.warmup(buckets=(PROMPT_LEN,))
    attention.LAUNCHES = paged_attention.LAUNCHES = 0
    done, _, _, _ = drive(eng, prompts, OPS_JOB_TOKENS)
    mine = {rid: [int(t) for t in ev["tokens"]] for rid, ev in done.items()}
    equal = mine == res["tokens"]
    job_done = {rid: {"tokens": toks} for rid, toks in res["tokens"].items()}
    held = check_first_tokens(cfg, eng, prompts, job_done, dev, served=torch.load(logits_path))
    log(f"  the job's tokens equal this process's drive of the same prompts on the same weights: {equal}")
    if not equal:
        bad = [rid for rid in mine if mine[rid] != res["tokens"].get(rid)]
        raise AssertionError(f"6k(c): the job's tokens differ from this process's in {bad}")
    del eng
    torch.cuda.empty_cache()
    listed = {j["job_id"]: j for j in client.list_jobs()}
    return dict(job_id=job_id, submit_to_succeeded_s=submit_s, drive_s=res["drive_s"], job_script_s=res["job_s"],
                first_tokens=held, tokens_equal=equal, entrypoint=listed[job_id]["entrypoint"],
                launches=res["launches"])


def _ops_dashboard(job):
    """6k(d): the dashboard on (a)'s cluster: /api/jobs, /api/cluster, /metrics."""
    import urllib.request

    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    def get(port, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()

    port = start_dashboard(port=0)
    try:
        _, _, body = get(port, "/api/jobs")
        jobs = {j["job_id"]: j for j in json.loads(body)}
        _, _, body = get(port, "/api/cluster")
        gpus = sum(n["resources_total"].get("GPU", 0) for n in json.loads(body)["nodes"].values()
                   if n["state"] == "ALIVE")
        status, ctype, body = get(port, "/metrics")
        prom = body.decode()
    finally:
        stop_dashboard()
    rec = jobs.get(job["job_id"], {})
    log(f"  dashboard: /api/jobs {rec.get('status')} {rec.get('entrypoint', '')[:60]!r}..., /api/cluster GPU {gpus:g}, "
        f"/metrics {status} {ctype} ({prom.count('# TYPE')} metric families)")
    if not (rec.get("status") == "SUCCEEDED" and rec.get("entrypoint") == job["entrypoint"]):
        raise AssertionError(f"6k(d): /api/jobs does not list the job as SUCCEEDED: {rec}")
    if gpus != 1 or status != 200 or "text/plain" not in ctype or "# TYPE raytpu_" not in prom:
        raise AssertionError(f"6k(d): /api/cluster GPU {gpus}, /metrics {status} {ctype}")
    return dict(jobs=len(jobs), cluster_gpus=gpus, metric_families=prom.count("# TYPE"))


def _day_server():
    """The day's deployment: LLMServer (counted as in 6g) mapping a request's
    body size n to a prompt of min(n, OPS_DAY_PROMPT) tokens drawn from
    seed n, OPS_DAY_TOKENS greedy new tokens, SSE when `x-stream: 1`. A
    stream whose deadline passes after its first frame ends with an error
    frame (its status is already 200) and is counted."""
    from ray_tpu_torch.llm.deployment import LLMServer

    base = _counted(LLMServer)

    class DayLLM(base):
        _cut = 0

        def __call__(self, request):
            self._served += 1
            n = max(1, min(len(request.body or b""), OPS_DAY_PROMPT))
            tokens = np.random.default_rng(n).integers(0, MODEL["vocab_size"], n).tolist()
            if request.headers.get("x-stream") == "1":
                return self._day_stream(tokens)
            return self.generate(tokens, OPS_DAY_TOKENS)

        def _day_stream(self, tokens):
            from ray_tpu_torch import qos

            started = False
            try:
                for frame in self._sse_stream(tokens, OPS_DAY_TOKENS):
                    started = True
                    yield frame
            except qos.DeadlineExceeded as e:
                if not started:
                    raise
                self._cut += 1
                yield f"data: {json.dumps({'error': str(e)})}\n\n"

        def cut_streams(self):
            return self._cut

    DayLLM.__name__ = DayLLM.__qualname__ = "DayLLM"
    return DayLLM


def _ops_replay(rt, env, work):
    """6k(f): the quick seed-0 day replayed open-loop against a GPU replica
    behind the proxy, folded into a run ledger; `report diff L L` exits 0."""
    from ray_tpu_torch import replay, serve
    from ray_tpu_torch.llm.deployment import build_llm_app
    from ray_tpu_torch.llm.engine import EngineConfig
    from ray_tpu_torch.obs import ledger

    serve.start()
    try:
        buckets = tuple(b for b in EngineConfig().prefill_buckets if b <= OPS_DAY_PROMPT)
        app = build_llm_app(MODEL, OPS_ENGINE, max_ongoing_requests=OPS_DAY_ONGOING, warmup_buckets=buckets,
                            ray_actor_options={"num_gpus": 1})
        _, ready_s, replicas, _ = _app_run(rt, serve, app, _day_server(), "day", route_prefix="/day")
        _app_counts(rt, replicas, reset=True)
        params = replay.default_params(quick=True)
        header, records = replay.synthesize(0, **params)
        spans = replay.phase_spans(params)
        t0 = time.perf_counter()
        outcomes = replay.Replayer(serve.http_port(), time_warp=OPS_DAY_WARP,
                                   max_workers=OPS_DAY_SENDERS).run(header, records)
        replay_s = time.perf_counter() - t0
        counts = _app_counts(rt, replicas)[0]
        cut = rt.get(replicas[0].handle_request.remote("cut_streams", (), {}), timeout=60)
    finally:
        serve.shutdown()
    summary = replay.summarize(outcomes, spans)
    sha = hashlib.sha256(replay.dumps_trace(header, records)).hexdigest()
    led = ledger.build(meta={"scenario": "day_in_the_life_gpu", "seed": 0, "quick": True,
                             "time_warp": OPS_DAY_WARP, "requests": header["requests"], "trace_sha256": sha},
                       spans=spans, load=summary,
                       counters={"k1.launches": float(counts["flash_fwd"]),
                                 "k4.launches": float(counts["paged_decode"]),
                                 "serve.stream.cut_total": float(cut)})
    path = os.path.join(work, "day_ledger.json")
    ledger.save(path, led)
    log("\n".join("    " + ln for ln in ledger.render(led).splitlines()))
    rc, out, _ = _ops_cli(env, "report", "diff", path, path, check=False)
    codes = {}
    for o in outcomes:
        codes[o["code"]] = codes.get(o["code"], 0) + 1
    streams = [o for o in outcomes if o["code"] == 200 and o["stream"]]
    classes = {}
    for cls, c in summary["classes"].items():
        t = c["_total"]
        classes[cls] = {k: t[k] for k in ("n", "ok", "goodput", "shed", "expired", "p50_s", "p99_s", "ttft_p95_s")}
        log(f"  {cls:>11}: n {t['n']} ok {t['ok']} goodput {t['goodput']} shed {t['shed']} expired "
            f"{t['expired']}  p50 {t['p50_s']} s  p99 {t['p99_s']} s  TTFT p95 {t['ttft_p95_s']} s")
    log(f"  replay: {len(records)} requests in {replay_s:.2f} s at warp {OPS_DAY_WARP} (replica ready in "
        f"{ready_s:.2f} s), status codes {codes}, {len(streams)} streams answered, {cut} cut by their "
        f"deadline after the first frame; replica launches K1 {counts['flash_fwd']} K4 "
        f"{counts['paged_decode']} over {counts['served']} calls; `report diff L L` exit {rc}")
    if rc != 0:
        raise AssertionError(f"6k(f): `report diff` of a ledger against itself exited {rc}:\n{out}")
    if any(o is None for o in outcomes) or set(codes) - {200, 429, 504}:
        raise AssertionError(f"6k(f): a request failed other than by a QoS shed (429) or its deadline (504): {codes}")
    if not summary["classes"].get("interactive", {}).get("_total", {}).get("goodput"):
        raise AssertionError("6k(f): no interactive request was answered")
    if any(o["ttft_s"] is None for o in streams):
        raise AssertionError("6k(f): a stream answered 200 without a first chunk")
    if not (counts["flash_fwd"] > 0 and counts["paged_decode"] > 0):
        raise AssertionError(f"6k(f): a kernel of the replica's path was never launched: {counts}")
    return dict(requests=len(records), replay_s=replay_s, ready_s=ready_s, codes=codes, classes=classes,
                total=summary["total"], streams_cut=cut, trace_sha256=sha,
                launches={"flash_fwd": counts["flash_fwd"], "paged_decode": counts["paged_decode"]})


def _ops_autoscale(dev, card_name, probe_dir, probe):
    """6k(e): an in-process 1-CPU, 0-GPU head; a pending num_gpus=1 K1 task
    makes the autoscaler launch one GPU node, then drain and terminate it."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import Autoscaler, LocalNodeProvider, NodeType
    from ray_tpu_torch.core.api import Cluster, init, shutdown
    from ray_tpu_torch.core.config import Config

    cfg = Config().apply_env()
    cfg.infeasible_as_pending = True
    cluster = Cluster(initialize_head=False, config=cfg)
    cluster.add_node(num_cpus=1)
    init(address=cluster.address, config=cfg)
    try:
        provider = LocalNodeProvider(cluster)
        auto = Autoscaler([NodeType("h100", {"CPU": 4.0, "GPU": 1.0},
                                    labels={"accelerator_type": card_name}, max_workers=1)],
                          provider, idle_timeout_s=1.0)

        @rt.remote(num_gpus=1, runtime_env={"py_modules": [probe_dir]})
        def pending(seed):
            import k1probe

            out = k1probe.run(seed)
            out["node_id"] = rt.get_runtime_context().node_id
            return out

        ref = pending.remote(OPS_K1_SEED)
        t0 = time.perf_counter()
        launched = {}
        while not launched:
            if time.perf_counter() - t0 > 60:
                raise AssertionError("6k(e): the pending GPU task never made the autoscaler launch a node")
            time.sleep(0.2)
            launched = auto.update()["launched"]
        t_launch = time.perf_counter()
        (pid,) = provider.non_terminated_nodes()
        nid = provider.controller_node_id(pid)
        out = rt.get(ref, timeout=OPS_TIMEOUT_S)
        task_s = time.perf_counter() - t_launch
        held = _ops_hold_k1(dev, probe, out, "autoscaled node's task")
        if out["node_id"] != nid:
            raise AssertionError(f"6k(e): the task ran on {out['node_id']}, not the launched node {nid}")
        t1 = time.perf_counter()
        res, steps = {}, []
        while not res.get("draining"):
            if time.perf_counter() - t1 > 60:
                raise AssertionError(f"6k(e): the idle GPU node was never drained: {res}")
            time.sleep(0.5)
            res = auto.update()
            steps.append("arm" if not res.get("draining") else "drain")
        res = auto.update()
        down_s = time.perf_counter() - t1
        log(f"  autoscaler: launched {launched} {t_launch - t0:.2f} s after the first update; the task ran "
            f"there in {task_s:.2f} s (node start, worker, K1 included); scale-down {len(steps)} updates "
            f"(timer armed, drained) + terminate in {down_s:.2f} s: {res}")
        if res["terminated"] != [pid] or provider.non_terminated_nodes():
            raise AssertionError(f"6k(e): the drained node was not terminated: {res}")
        return dict(launched=launched, launch_to_task_s=task_s, scale_down_s=down_s, k1=held,
                    launches=held["launches"])
    finally:
        shutdown()
        cluster.shutdown()


def phase_operator(dev, card, phase6):
    """Phase 6k (operator-250M): the port's operator surface on the card.
    (a) `python -m ray_tpu_torch start --head` (the card autodetected),
    `status` and `list nodes`; (b) K1 in runtime_env tasks; (c) phase 6's
    engine in a job through `job submit --wait`; (d) the dashboard; (f) the
    quick seed-0 day replayed against a GPU replica and its run ledger; then
    `stop` (no recorded pid left alive) and (e) an autoscaled GPU node on an
    in-process cluster. Returns (stats, {path: launches})."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.accel.gpu import GPU_NAME_LABEL
    from ray_tpu_torch.core import api as rt_api

    prompts = phase6[0][:OPS_JOB_N]
    card_name = torch.cuda.get_device_name(0)
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_6k_")
    state_dir = os.path.join(work, "state")
    env = dict(os.environ, RAYTPU_TORCH_STATE_DIR=state_dir)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (os.path.dirname(os.path.abspath(__file__)),
                                                    env.get("PYTHONPATH", "")) if p)
    out, walls = dict(card=card), {}
    t_phase = time.perf_counter()
    pids = []
    try:
        t0 = time.perf_counter()
        addr_file = os.path.join(work, "head_addr")
        _ops_cli(env, "start", "--head", "--port", "0", "--num-cpus", str(OPS_CPUS), "--address-file", addr_file)
        addr = open(addr_file).read().strip()
        pids = [json.load(open(os.path.join(state_dir, f)))["pid"] for f in os.listdir(state_dir)
                if f.startswith("proc-")]
        rt.init(address=addr)
        try:
            nodes = [n for n in rt_api._cluster_state()["nodes"].values() if n["state"] == "ALIVE"]
            _, status_out, _ = _ops_cli(env, "--address", addr, "status")
            _, list_out, _ = _ops_cli(env, "--address", addr, "list", "nodes")
            walls["a_start_s"] = time.perf_counter() - t0
            gpu_line = [ln.strip() for ln in status_out.splitlines() if ln.strip().startswith("GPU")]
            log(f"  (a) head pid {pids} at {addr}: {len(nodes)} node, resources {nodes[0]['resources_total']}, "
                f"card label {nodes[0]['labels'].get(GPU_NAME_LABEL)!r}; `status`: {gpu_line}; `list nodes` "
                f"shows GPU: {'GPU:' in list_out} ({walls['a_start_s']:.2f} s)")
            if not (len(nodes) == 1 and nodes[0]["resources_total"].get("GPU") == 1
                    and nodes[0]["labels"].get(GPU_NAME_LABEL) == card_name):
                raise AssertionError(f"6k(a): the CLI head does not advertise GPU 1 and {card_name!r}: {nodes}")
            if not (gpu_line and "GPU:" in list_out and len(pids) == 1):
                raise AssertionError(f"6k(a): `status` / `list nodes` print no GPU:\n{status_out}\n{list_out}")
            t0 = time.perf_counter()
            out["runtime_env"], probe = _ops_runtime_env(rt, dev, work)
            walls["b_runtime_env_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["job"] = _ops_job(rt, dev, env, addr, work, prompts)
            walls["c_job_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["dashboard"] = _ops_dashboard(out["job"])
            walls["d_dashboard_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["replay"] = _ops_replay(rt, env, work)
            walls["f_replay_s"] = time.perf_counter() - t0
        finally:
            rt.shutdown()
        t0 = time.perf_counter()
        _, stop_out, _ = _ops_cli(env, "stop")
        deadline = time.perf_counter() + 30
        alive = pids
        while alive and time.perf_counter() < deadline:
            time.sleep(0.1)
            alive = [p for p in pids if _pid_alive(p)]
        walls["a_stop_s"] = time.perf_counter() - t0
        log(f"  (a) `stop`: {stop_out.strip().splitlines()[-1]}; recorded pids alive after it: {alive} "
            f"({walls['a_stop_s']:.2f} s)")
        if alive:
            raise AssertionError(f"6k(a): `stop` left recorded pids alive: {alive}")
        pids = []
        t0 = time.perf_counter()
        out["autoscaler"] = _ops_autoscale(dev, card_name, os.path.join(work, "mods"), probe)
        walls["e_autoscaler_s"] = time.perf_counter() - t0
    finally:
        if pids:
            _ops_cli(env, "stop", check=False)
        shutil.rmtree(work, ignore_errors=True)
    if rt_api._global_worker is not None or rt_api._LIVE_CLUSTERS:
        raise AssertionError("6k left the runtime up")
    walls["total_s"] = time.perf_counter() - t_phase
    out["walls"] = walls
    log(f"  6k walls: {json.dumps({k: round(v, 2) for k, v in walls.items()})}")
    launches = {"runtime_env": {"flash_fwd": out["runtime_env"]["launches"]},
                "job": dict(out["job"]["launches"]),
                "autoscaler": {"flash_fwd": out["autoscaler"]["launches"]},
                "replay": dict(out["replay"]["launches"])}
    return out, launches


# Phase 6l (chaos-day-250M): the quick seed-0 day under day_in_the_life's
# chaos timeline (ray_tpu/chaos/scenarios.py:1372-1388, verbatim) against
# one GPU replica of 6k(f)'s DayLLM, on an in-process cluster: a head with
# the card and CHAOS_CPUS CPUs, and a 1-CPU victim host carrying the slice
# labels the timeline's preemption notice names (it joins once serve is
# placed). The replica (num_gpus 1, num_cpus 2: it can never land on the
# victim) subscribes to the timeline's channel; the publish_weights action
# commits the 250M tree drawn from CHAOS_PUBLISH_SEED through the port's
# ckpt and publishes it. After the day CHAOS_CHECK_N of phase 6's prompts go
# through the handle. The replica's QoS knobs are the defaults 6k(f) ran
# with (the reference's are tuned for its 4 ms toy app). Every wait is
# bounded by OPS_TIMEOUT_S.
CHAOS_CPUS, CHAOS_PUBLISH_SEED, CHAOS_CHECK_N = 8, 1, 8
CHAOS_WARP, CHAOS_HEARTBEAT_S, CHAOS_LEAD_S = 2.0, 0.25, 1.0
CHAOS_TIMELINE = [
    {"action": "slow_replica_window", "phase": "storm", "delay_s": 0.04, "deployment": "DayApp"},
    {"action": "client_flap", "phase": "calm", "offset_s": 1.0, "kind": "delay", "delay_s": 0.03, "every": 9},
    {"action": "tpu_preempt", "phase": "recovery", "offset_s": 0.6, "worker_id": "1", "slice": "slice-a",
     "grace_s": 0.3},
    {"action": "chaos_rule", "rule": {"site": "ckpt.publish.swap", "kind": "delay", "nth": 1, "delay_s": 0.05}},
    {"action": "publish_weights", "phase": "recovery", "offset_s": 0.3, "channel": "day-weights", "step": 1},
]


def _chaos_day_server():
    """6k(f)'s DayLLM that also records, as a published tree swaps in, its
    K1 / K4 launches so far and the wall-clock time, and reports its own
    process's chaos injection log."""
    base = _day_server()

    class ChaosDayLLM(base):
        _at_swap = None

        def _swap_weights(self, tree, summary):
            super()._swap_weights(tree, summary)
            from ray_tpu_torch.ops import attention, paged_attention

            self._at_swap = dict(flash_fwd=attention.LAUNCHES, paged_decode=paged_attention.LAUNCHES,
                                 wall=time.time(), ckpt_id=(summary or {}).get("ckpt_id"))

        def swap_record(self):
            return self._at_swap

        def injections(self):
            from ray_tpu_torch.chaos import plan

            return plan.injection_log(normalize=True)

    ChaosDayLLM.__name__ = ChaosDayLLM.__qualname__ = "ChaosDayLLM"
    return ChaosDayLLM


def _chaos_cli(env):
    """6l(a): the port's analyzer over the port, `chaos list`, and one
    scenario run in its own process."""
    rc, out, lint_s = _ops_cli(env, "lint", "--json", "--no-cache", check=False)
    report = json.loads(out) if rc == 0 else {}
    if rc != 0 or report.get("total") != 0:
        raise AssertionError(f"6l(a): `lint --json` exited {rc} with total {report.get('total')}:\n{out[-4000:]}")
    _, listed, _ = _ops_cli(env, "chaos", "list")
    if "tpu_preempt_drain" not in listed or "tpu.preempt" not in listed:
        raise AssertionError(f"6l(a): `chaos list` names no tpu_preempt_drain / tpu.preempt:\n{listed}")
    rc, out, run_s = _ops_cli(env, "chaos", "run", "tpu_preempt_drain", "--quick", "--seed", "0", check=False)
    scn = json.loads(out.strip().splitlines()[-1]) if out.strip() else {}
    log(f"  (a) `lint --json`: {report['files']} files, total {report['total']}, {lint_s:.2f} s; `chaos list`: "
        f"{listed.count(chr(10))} lines; `chaos run tpu_preempt_drain --quick --seed 0`: ok {scn.get('ok')}, "
        f"injections {scn.get('injections')}, {run_s:.2f} s")
    if rc != 0 or not scn.get("ok"):
        raise AssertionError(f"6l(a): `chaos run tpu_preempt_drain` exited {rc}:\n{out[-4000:]}")
    return dict(lint_files=report["files"], lint_total=report["total"], lint_s=lint_s,
                scenario_ok=scn["ok"], scenario_s=run_s, scenario_injections=scn["injections"])


def _cpu_tree(tree):
    return {k: _cpu_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.cpu()


def _swap_blip(outcomes, t_day, swap_wall, window_s=1.0):
    """Requests sent in the window_s before and after the swap: count, 200s,
    transport errors, the p50 of the 200s."""
    def side(lo, hi):
        rows = [o for o in outcomes if lo <= t_day + o["t"] / CHAOS_WARP + o["late_s"] < hi]
        lat = sorted(o["latency_s"] for o in rows if o["code"] == 200)
        return dict(n=len(rows), ok=len(lat), errors=sum(o["code"] in (-1, 500) for o in rows),
                    p50_s=lat[len(lat) // 2] if lat else None)

    return dict(window_s=window_s, before=side(swap_wall - window_s, swap_wall),
                after=side(swap_wall, swap_wall + window_s))


def phase_chaos_day(dev, card, phase6):
    """Phase 6l (chaos-day-250M). (a) `lint --json` over the port, `chaos
    list`, `chaos run tpu_preempt_drain --quick --seed 0`; (b) the quick
    seed-0 day under day_in_the_life's timeline against a GPU replica that
    hot-swaps a published 250M tree mid-day. Returns (stats, launches in
    the replica)."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import ckpt, obs, replay, serve
    from ray_tpu_torch.accel.gpu import TPU_SLICE_NAME_LABEL, TPU_WORKER_ID_LABEL
    from ray_tpu_torch.chaos import invariants, plan, scenarios
    from ray_tpu_torch.core import api as rt_api
    from ray_tpu_torch.core.api import Cluster, init
    from ray_tpu_torch.llm import EngineConfig, LLMEngine, build_llm_app
    from ray_tpu_torch.llm.deployment import _tensor_tree
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.models.transformer import cast_params, init_params
    from ray_tpu_torch.obs import ledger
    from ray_tpu_torch.serve.handle import _reset_registry

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_6l_")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (os.path.dirname(os.path.abspath(__file__)),
                                                    env.get("PYTHONPATH", "")) if p)
    cli = _chaos_cli(env)
    cfg_model = TransformerConfig(**MODEL)
    gen = torch.Generator(device=dev).manual_seed(CHAOS_PUBLISH_SEED)
    published_tree = _cpu_tree(cast_params(init_params(cfg_model, gen, dev), cfg_model.dtype, dev))
    torch.cuda.empty_cache()

    params = replay.default_params(quick=True)
    header, records = replay.synthesize(0, **params)
    trace_sha = hashlib.sha256(replay.dumps_trace(header, records)).hexdigest()
    spans = replay.phase_spans(params)
    compiled = replay.Timeline(spans, CHAOS_TIMELINE).compile(0, records, time_warp=CHAOS_WARP,
                                                              heartbeat_s=CHAOS_HEARTBEAT_S, lead_s=CHAOS_LEAD_S)
    channel = next(a["channel"] for a in CHAOS_TIMELINE if a["action"] == "publish_weights")
    cfg = scenarios._fresh_config()
    cfg.heartbeat_interval_s = CHAOS_HEARTBEAT_S
    cfg.slo_eval_interval_s = 0.25
    cfg.chaos_spec = json.dumps(compiled.spec)
    plan.install_from_json(cfg.chaos_spec)
    cluster = Cluster(initialize_head=False, config=cfg)
    try:
        cluster.add_node(num_cpus=CHAOS_CPUS, resources={"GPU": 1.0})
        init(address=cluster.address, config=cfg)
        serve.start()
        buckets = tuple(b for b in EngineConfig().prefill_buckets if b <= OPS_DAY_PROMPT)
        app = build_llm_app(MODEL, OPS_ENGINE, max_ongoing_requests=OPS_DAY_ONGOING, warmup_buckets=buckets,
                            ray_actor_options={"num_gpus": 1, "num_cpus": 2}, weights_channel=channel)
        app.deployment = app.deployment.options(name="DayApp")
        handle, ready_s, replicas, _ = _app_run(rt, serve, app, _chaos_day_server(), "day", route_prefix="/day")
        for spec in ({"name": "day-availability", "metric": "availability", "app": "day", "deployment": "DayApp",
                      "fast_window_s": 1.0, "slow_window_s": 3.0, "burn_threshold": 2.0},
                     {"name": "day-latency", "metric": "latency", "target": 0.5, "quantile": 0.95, "app": "day",
                      "deployment": "DayApp", "fast_window_s": 1.0, "slow_window_s": 3.0, "burn_threshold": 2.0}):
            serve.register_slo(spec)
        storage = os.path.join(work, "ckpt")
        store = ckpt.ChunkStore(storage)
        manifests = ckpt.ManifestStore(storage, num_to_keep=2, chunk_store=store)
        pub = {}

        def publish(action):
            step = int(action.get("step", 1))
            t0 = time.perf_counter()
            part = ckpt.write_part(store, ckpt.snapshot_tree(published_tree), rank=0, step=step)
            m = ckpt.commit_parts(manifests, ckpt.new_ckpt_id(step), step, [part], 1,
                                  channel=action["channel"], meta={"step": step})
            ckpt.publish_checkpoint(m, action["channel"])
            pub.update(manifest=m, wall=time.time(), seconds=time.perf_counter() - t0, bytes=part["bytes_total"])
            return {"ckpt_id": m["ckpt_id"]}

        core = rt_api._require_worker()
        base = scenarios._baseline_counters(core)
        _app_counts(rt, replicas, reset=True)
        victim = cluster.add_node(num_cpus=1, labels={TPU_SLICE_NAME_LABEL: "slice-a", TPU_WORKER_ID_LABEL: "1"})
        t_day = time.time()
        t0 = time.perf_counter()
        driver = replay.TimelineDriver(compiled.control, {"publish_weights": publish},
                                       time_warp=CHAOS_WARP).start()
        outcomes = replay.Replayer(serve.http_port(), time_warp=CHAOS_WARP,
                                   max_workers=OPS_DAY_SENDERS).run(header, records)
        day_s = time.perf_counter() - t0
        t_after = time.perf_counter()
        tl_log = driver.join(timeout=OPS_TIMEOUT_S)

        t0 = time.perf_counter()
        state = {}
        while state.get("state") != "DEAD":
            if time.perf_counter() - t0 > OPS_TIMEOUT_S:
                raise AssertionError(f"6l: the preempted victim host never went DEAD: {state}")
            state = core._run(core.controller.call("get_cluster_state", {}))["nodes"].get(victim.node_id, {})
            time.sleep(0.2)
        events = core._run(core.controller.call("get_events", {"limit": 4000}))
        ts = {e["kind"]: e["ts"] for e in events if e.get("node_id") == victim.node_id
              and e["kind"] in ("node_draining", "node_dead")}
        published = next((e["detail"]["ckpt_id"] for e in tl_log if e["action"] == "publish_weights" and e.get("ok")),
                         None)
        if published is None:
            raise AssertionError(f"6l: the timeline's weight publication failed: {tl_log}")
        t0 = time.perf_counter()
        version = handle.options(method_name="weights_version").remote().result(timeout=60)
        while version != published and time.perf_counter() - t0 < OPS_TIMEOUT_S:
            time.sleep(0.1)
            version = handle.options(method_name="weights_version").remote().result(timeout=60)
        swap = rt.get(replicas[0].handle_request.remote("swap_record", (), {}), timeout=60)
        prompts = phase6[0][:CHAOS_CHECK_N]
        got = [list(handle.options(method_name="generate").remote(p.tolist(), MAX_TOKENS).result(timeout=OPS_TIMEOUT_S)
                    ["tokens"]) for p in prompts]
        counts = _app_counts(rt, replicas)[0]
        cut = rt.get(replicas[0].handle_request.remote("cut_streams", (), {}), timeout=60)
        replica_log = rt.get(replicas[0].handle_request.remote("injections", (), {}), timeout=60)

        tree = _tensor_tree(ckpt.restore_tree(pub["manifest"], store))
        eng = LLMEngine(cfg_model, params=tree, engine_config=EngineConfig(**OPS_ENGINE))
        want = [list(eng.generate(p, max_tokens=MAX_TOKENS)["tokens"]) for p in prompts]
        del eng, tree
        torch.cuda.empty_cache()

        deltas = {}
        t0 = time.perf_counter()
        while deltas.get("ckpt.publish.swaps_total", 0) < 1 and time.perf_counter() - t0 < 10:
            deltas = scenarios._counter_deltas(core, base)
            time.sleep(0.4)
        summary = replay.summarize(outcomes, phases=spans)
        driver_log = plan.injection_log(normalize=True)
        led = ledger.build(
            meta={"scenario": "day_in_the_life_gpu", "seed": 0, "quick": True, "time_warp": CHAOS_WARP,
                  "requests": header["requests"], "trace_sha256": trace_sha},
            spans=spans, load=summary, slo={"status": serve.slo_status(), "history": obs.slo_history()},
            counters={**deltas, "k1.launches": float(counts["flash_fwd"]),
                      "k4.launches": float(counts["paged_decode"]), "serve.stream.cut_total": float(cut)},
            autopsy=obs.autopsy_summary(),
            chaos={"injections": driver_log, "count": int(deltas.get("chaos.injected_total", 0))},
            timeline=tl_log)
        ledger.save(os.path.join(work, "ledger.json"), led)
        gate = ledger.gate(led)
        _reset_registry()  # park router threads before the invariant battery
        inv = invariants.check_all(core, cluster, min_injections=2, min_metric_injections=3)
        after_day_s = time.perf_counter() - t_after
    finally:
        try:
            serve.shutdown()
        finally:
            rt_api.shutdown()
            cluster.shutdown()
            plan.uninstall()
            shutil.rmtree(work, ignore_errors=True)
    if rt_api._global_worker is not None or rt_api._LIVE_CLUSTERS:
        raise AssertionError("6l left the runtime up")

    log("\n".join("    " + ln for ln in ledger.render(led).splitlines()))
    codes = {}
    for o in outcomes:
        code = None if o is None else o["code"]
        codes[code] = codes.get(code, 0) + 1
    classes = {}
    for cls, c in summary["classes"].items():
        t = c["_total"]
        classes[cls] = {k: t[k] for k in ("n", "ok", "goodput", "shed", "expired", "p50_s", "p99_s", "ttft_p95_s")}
        log(f"  {cls:>11}: n {t['n']} ok {t['ok']} goodput {t['goodput']} shed {t['shed']} expired "
            f"{t['expired']}  p50 {t['p50_s']} s  p99 {t['p99_s']} s  TTFT p95 {t['ttft_p95_s']} s")
    before = {"flash_fwd": swap["flash_fwd"], "paged_decode": swap["paged_decode"]} if swap else None
    after = None if swap is None else {k: counts[k] - swap[k] for k in before}
    blip = _swap_blip([o for o in outcomes if o is not None], t_day, swap["wall"]) if swap else None
    blip_ledger = sum(c["phases"]["recovery"]["errors"] for c in summary["classes"].values())
    sites = {r["site"] for r in compiled.spec["rules"]}
    logged = {e["site"] for e in driver_log} | {e["site"] for e in replica_log}
    notice_to_dead = ts["node_dead"] - ts["node_draining"] if len(ts) == 2 else None
    stats = dict(cli=cli, requests=len(records), day_s=day_s, after_day_s=after_day_s, ready_s=ready_s,
                 codes=codes,
                 classes=classes, total=summary["total"], streams_cut=cut, trace_sha256=trace_sha,
                 published=published, version=version, publish_s=pub.get("seconds"), publish_bytes=pub.get("bytes"),
                 publish_to_swap_s=None if swap is None else swap["wall"] - pub["wall"],
                 swap_after_day_start_s=None if swap is None else swap["wall"] - t_day,
                 swap_blip=blip, recovery_errors=blip_ledger, notice_to_dead_s=notice_to_dead,
                 launches_before_swap=before, launches_after_swap=after, tokens_equal=got == want,
                 sites=sorted(sites), driver_log=driver_log, replica_log=replica_log, timeline=tl_log,
                 ledger_gate=gate, invariants={k: v["ok"] for k, v in inv.items() if isinstance(v, dict)},
                 launches={"flash_fwd": counts["flash_fwd"], "paged_decode": counts["paged_decode"]})
    log(f"  (b) replica healthy in {ready_s:.2f} s; {len(records)} requests in {day_s:.2f} s at warp {CHAOS_WARP}, "
        f"status codes {codes}, {cut} streams cut after their first frame; published {published} "
        f"({pub.get('bytes', 0) / 1e9:.3f} GB written in {pub.get('seconds', 0):.2f} s), publish -> swap "
        f"{stats['publish_to_swap_s']} s ({stats['swap_after_day_start_s']} s after the day began), replica "
        f"version {version}; swap blip {blip} (recovery-phase errors {blip_ledger}); preempt notice -> DEAD "
        f"{notice_to_dead} s; sites {sorted(sites)} logged {sorted(logged)}; K1/K4 before the swap {before}, "
        f"after it {after}; {CHAOS_CHECK_N} x {MAX_TOKENS} tokens after the day "
        f"{'equal' if got == want else 'DIFFER from'} an engine on the published tree; invariants "
        f"{stats['invariants']}; ledger gates (printed, not gated) {[(c['name'], c['ok']) for c in gate['checks']]}"
        f"  [{card}]")
    if sites - logged:
        raise AssertionError(f"6l: the timeline's sites {sorted(sites - logged)} never fired")
    if version != published:
        raise AssertionError(f"6l: the replica reports {version}, not the published {published}")
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"6l: tokens after the day differ from the published tree's engine for prompts {bad}")
    if swap is None or swap["ckpt_id"] != published or min(before.values()) <= 0 or min(after.values()) <= 0:
        raise AssertionError(f"6l: K1/K4 must launch in the replica before and after the swap: {swap}, {counts}")
    if not inv["ok"]:
        raise AssertionError(f"6l: chaos.invariants.check_all failed: {inv}")
    if any(o is None for o in outcomes) or set(codes) - {200, 429, 504}:
        raise AssertionError(f"6l: a request failed other than by a QoS shed (429) or its deadline (504): {codes}")
    if not summary["classes"].get("interactive", {}).get("_total", {}).get("goodput"):
        raise AssertionError("6l: no interactive request was answered")
    stats["total_s"] = time.perf_counter() - t_phase
    log(f"  6l {stats['total_s']:.2f} s (after the day: DEAD, swap, check prompts, engine, ledger, battery "
        f"{after_day_s:.2f} s)")
    return stats, stats["launches"]


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"  # a zombie has exited
    except OSError:
        return False


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", help="also trace the paged engine's steps and a training step into DIR")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; the port's kernels run only on the GPU",
              file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    global WINDOW_DIR
    WINDOW_DIR = os.path.join(args.profile, "windows") if args.profile else tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return _run(args, dev, rng)
    finally:
        if not args.profile:
            shutil.rmtree(WINDOW_DIR, ignore_errors=True)


def _run(args, dev, rng):
    import torch

    t_start = time.perf_counter()
    card = phase_device()
    ptxas = phase_build()
    # Every D-64 phase first, in the order and on the random streams of
    # earlier versions of this script; then the D-128 and D-256 kernel phases.
    timed = {}
    for d in SHAPES:
        if d == 64:
            k1 = phase_k1(dev, rng, SHAPES[64])
            k4 = phase_k4(dev, rng)
            k3, k2 = phase_k23(dev, rng, SHAPES[64])
            splash = phase_splash(dev, rng, k1["train_shape"], k3, k2)
            timed[64] = dict(flash_fwd=k1, paged_decode=k4, flash_bwd_dq=k3, flash_bwd_dkv=k2)
        else:
            k1_d = phase_k1(dev, rng, SHAPES[d])
            k4_d = phase_k4_big(dev, rng, d)
            k3_d, k2_d = phase_k23(dev, rng, SHAPES[d])
            timed[d] = dict(flash_fwd=k1_d, paged_decode=k4_d, flash_bwd_dq=k3_d, flash_bwd_dkv=k2_d)
    stats, launches, phase6 = phase_engine(dev, rng, args.profile)
    prefix, p_launches = phase_prefix(dev, rng, args.profile)
    m_serve, m_launches = phase_big_serve(dev, rng, "mistral7b", args.profile)
    g_serve, g_launches = phase_big_serve(dev, rng, "gemma2b", args.profile)
    oai, o_launches = phase_serve_openai(dev, stats)
    rt_serve, r_launches = phase_serve_runtime(dev, stats, phase6)
    app_serve, a_launches = phase_serve_app(dev, stats, phase6, oai)
    dag, d_launches = phase_dag(dev, rt_serve["transport"])
    data, db_launches, di_launches = phase_data(dev, card, stats, phase6)
    serve_tp, tp_serve_launches = phase_serve_tp(dev, card, phase6)
    ops, ops_launches = phase_operator(dev, card, phase6)
    chaos_day, cd_launches = phase_chaos_day(dev, card, phase6)
    train, t_launches, s_launches = phase_train(dev, card, args.profile)
    m_train, mt_launches = phase_big_train(dev, card, "mistral7b", args.profile)
    g_train, gt_launches = phase_big_train(dev, card, "gemma2b", args.profile)
    plane, tp_launches, tps_launches = phase_train_plane(dev, card, phase6)
    tune_stats, tn_launches = phase_tune(dev, card)
    rl = phase_rl(dev, card)
    train_par, tpar_launches = phase_parallel_train(dev, card)
    # Launches by path: serve, serve_prefix, serve_openai, serve_runtime,
    # serve_app, dag, data_batch, data_ingest, train, train_plane (K1-K3 in
    # the train workers' processes), train_plane_serve, tune (K1-K3 in the
    # trials' processes), tp_serve (6j: K1/K4 per head shard) and
    # parallel_train (7j: K1-K3 per slot or microbatch), and 6k's
    # runtime_env (K1 in the runtime_env tasks' workers), job (K1/K4 in the
    # job's entrypoint), autoscaler (K1 on the autoscaled node's worker) and
    # replay (K1/K4 in the day's replica), and 6l's chaos_day (K1/K4 in the
    # chaos day's replica, across its weight swap) are the 250M cells (D 64);
    # serve_mistral7b and train_mistral7b the 7B cells (D 128);
    # serve_gemma2b and train_gemma2b the 2B cells (D 256).
    paths = {"serve": launches, "serve_prefix": p_launches, "serve_openai": o_launches,
             "serve_runtime": r_launches, "serve_app": a_launches, "dag": d_launches, "data_batch": db_launches,
             "data_ingest": di_launches, "train": t_launches, "train_plane": tp_launches,
             "train_plane_serve": tps_launches, "tune": tn_launches, "tp_serve": tp_serve_launches,
             "parallel_train": tpar_launches, **ops_launches, "chaos_day": cd_launches,
             "serve_mistral7b": m_launches, "train_mistral7b": mt_launches, "serve_gemma2b": g_launches,
             "train_gemma2b": gt_launches}
    big_paths = {128: "mistral7b", 256: "gemma2b"}

    def entry(name, source, replaces, **extra):
        counts = {p: n[name] for p, n in paths.items() if name in n}
        kind = {"paged_decode": "paged_decode_kernel"}.get(name, f"{name}_kernel")
        reports = ptxas.get(kind)
        big = {}
        for d, model in big_paths.items():
            # K4's instances are per group (4 at Mistral-7B's heads, 8 at
            # Gemma-2B's), the flash kernels' per head dim.
            key = str(SHAPES[d]["h"] // SHAPES[d]["kv"]) if name == "paged_decode" else str(d)
            big[f"d{d}"] = dict(timed[d][name], launches_by_path={p: n for p, n in counts.items() if p.endswith(model)},
                                ptxas=None if reports is None else reports.get(key))
        return dict(name=name, route="cuda", source=source, replaces=replaces, launches=sum(counts.values()),
                    launches_by_path=counts, ptxas=reports, **timed[64][name], **big, **extra)

    bwd_src = "ray_tpu_torch/ops/csrc/flash_bwd.cu"
    kernels = [
        entry("flash_fwd", "ray_tpu_torch/ops/csrc/flash_fwd.cu", "ray_tpu/ops/attention.py:92"),
        entry("flash_bwd_dq", bwd_src, "ray_tpu/ops/attention.py:277"),
        entry("flash_bwd_dkv", bwd_src, "ray_tpu/ops/attention.py:210"),
        entry("paged_decode", "ray_tpu_torch/ops/csrc/paged_decode.cu", "ray_tpu/ops/paged_attention.py:67"),
        dict(name="splash", route="onto K1-K3", source="ray_tpu_torch/ops/splash.py",
             replaces="ray_tpu/ops/splash.py:33", launches=sum(s_launches.values()),
             launches_by_kernel=s_launches, **splash),
    ]
    log(json.dumps({"engine": stats}))
    log(json.dumps({"engine_prefix": prefix}))
    log(json.dumps({"engine_mistral7b": m_serve}))
    log(json.dumps({"engine_gemma2b": g_serve}))
    log(json.dumps({"engine_openai": oai}))
    log(json.dumps({"engine_runtime": rt_serve}))
    log(json.dumps({"engine_serve_app": app_serve}))
    log(json.dumps({"dag": dag}))
    log(json.dumps({"data": data}))
    log(json.dumps({"train": train}))
    log(json.dumps({"train_mistral7b": m_train}))
    log(json.dumps({"train_gemma2b": g_train}))
    log(json.dumps({"train_plane": plane}))
    log(json.dumps({"tune": tune_stats}))
    log(json.dumps({"rl": rl}))
    log(json.dumps({"engine_tp": serve_tp}))
    log(json.dumps({"operator": ops}))
    log(json.dumps({"chaos_day": chaos_day}))
    log(json.dumps({"train_parallel": train_par}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
