"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. device: require CUDA, print the card's name and power limit;
2. build: compile the port's CUDA kernels from ``src/python/tpuserver_torch/
   csrc`` (into ``build/tpuserver_torch``), print the build seconds;
3. kernels: each kernel against its plain PyTorch version on the card at
   Llama-3-8B shapes (flash at every prefill length phases 4, 4b and 4c
   give it; the lengths of 4c's and 4f's re-admissions that depend on
   when a fault hit are checked right after 4f), with the stated tolerances (decode
   also against the
   plain model of its split-K), and timed beside its bound, its plain
   version and one PyTorch library call (for single-row decode also SDPA
   over the live prefix alone); then, untimed, every route the main path
   does not run (``phase_route_checks``: flash's and decode's bf16
   tensor-core routes at head dims other than 64 and 128, their float32
   "simt" routes, decode past 8 query heads a kv head on both routes, the
   W8A16 product's float32 route; a bf16 case on "simt" or a float32 one
   on a tensor-core route fails) against its plain
   version at small shapes with a planted fault, the route each launched
   on counted;
4. serve: ``tpuserver_torch``'s server and HTTP front end serving
   ``llama3_8b`` (full width and depth, random weights from a seed,
   ``max_seq`` 4096) three ``/generate_stream`` requests over a socket,
   with the kernels' launch counts read around them;
4b. serve_batched: the same weights behind ``LlamaGenerateModel(
   max_slots=8)`` (continuous batching over a paged KV pool): 12
   concurrent ``/generate_stream`` requests over 8 slots, then the same 12
   in reverse arrival order, which must stream the same tokens per prompt;
   the ``id:`` lines' ``seq`` gap-free; the kernels' launch counts read
   around both rounds; one batched paged step's logits for a 512-token
   prompt in slot 3 against the single-stream decode step; peak device
   memory;
4c. on the same weights, ``max_slots=8``: (a) one speculative verify
   (``spec_step``, K 4) against five plain steps from phase 6's state,
   bitwise, with full, partial and zero acceptance; (b) phase 4b's 12
   prompts and 4 repetitive ones through ``spec_tokens=0`` and ``4``,
   identical tokens per prompt; (c) self-healing: after an undisturbed
   round of 8 streams, one round where a step raises once and one where
   it stalls on the host for 3 x ``step_timeout_s``, then on a
   ``spec_tokens=4`` model one where the speculative verify stalls, each
   ending in exactly one restart, gap-free ``seq``s and the undisturbed
   tokens up to the fault (the watchdog set at construction, as
   ``serve.py --step-timeout-s`` sets it); (d) an SSE client that drops and reconnects with
   ``Last-Event-ID``, a completed tail replayed twice, an unknown id
   answered 404; launch counts read around (b) and around (c) and (d);
4e. the shared-memory data plane, ``max_slots=8`` on the same weights:
   (a) one CUDA region (``tpuserver_torch.cuda_shared_memory``,
   registered over HTTP by its raw handle) holds 4b's 12 prompts, which
   12 concurrent requests take by reference, delivering their tokens into
   a ring each in the same region: the rings must hold 4b's tokens; (b) a
   child process makes a region and writes the 512-token prompt; 64
   tokens stream into a seq-guarded ring in it, which the child reads
   from device memory (every slot committed, 4b's tokens), and
   unregistering it answers 409 during the stream and 200 after; (c)
   phase 4c (c)'s 8 prompts with ``kv_park``, each client dropping after
   5 events and resuming by ``Last-Event-ID``: 8 attach admissions and
   no flash launch during the resumes, the continuation tokens' agreement
   with the undisturbed run reported; (d) a second server process
   (``--child-server``, the same seed and so the same weights) decodes
   a prefill leg's export from this one over CUDA IPC: no flash launch
   on it, the fused run's tokens, then a 409 on a second descriptor
   fetch and a 404 after the release;
4f. serve_grpc: the gRPC front end (``tpuserver_torch.grpc_server``) on
   ``max_slots=8`` models over the same weights, driven through a raw
   ``grpc`` channel over the port's own pb2 copies (the script's first
   line prints the grpcio and protobuf versions the machine has): (a)
   4b's 12 prompts, 50 ms apart, on one bidi stream: 4b's tokens per
   prompt, gap-free ``seq``s, flash >= 32 x tileable admissions and decode
   >= 32 x batched steps; (b) 4c (c)'s 8 prompts with ``kv_park`` on one
   stream, which the ``grpc.stream_infer`` fault point (``skip=5``, this
   server's scope) drops after 5 responses; each generation resumes by
   ``resume_generation_id``/``resume_from_seq``: 8 attach admissions, no
   flash launch, the undisturbed run's continuation tokens; (c)
   ``scheduler.step`` raises once mid-round: one restart, every stream
   complete, ``tpu_scheduler_restarts_total`` up by 1; (d) CoDel on a
   second model (``target_queue_ms=50``, ``shed_interval_ms=100``), 24
   requests 50 ms apart over 8 slots: at least one shed, in-band as
   ``RESOURCE_EXHAUSTED`` with ``retry-after`` 1, as many as
   ``tpu_scheduler_codel_sheds_total`` counts; (e) ``ServerMetrics`` and
   ``GET /metrics`` agree on every ``tpu_*`` counter, whose admissions,
   tokens and prefix counts equal ``scheduler_stats()`` and whose step
   histogram counts the batched steps; ``nv_gpu_memory_used_bytes``
   beside ``torch.cuda.mem_get_info``; NOT_FOUND for an unknown model and
   an answer to a repository verb (no verb is UNIMPLEMENTED);
5. model check: the 512-token prompt's last-position prefill logits
   through the kernels against the same model through the plain
   attention versions, and the greedy tokens of both;
6. profile: one prefill, one decode chunk, one batched paged step (8
   live rows near length 600), four in the scheduler's pipeline, and one
   speculative verify (K 4) beside the five plain steps it stands for,
   under ``torch.profiler``: device time by kernel class (the page gather
   apart) beside the wall time;
4g. fleet, last, once this process has released its models: two replica
   processes, each the port's ``serve.py`` run through this script's
   ``--child-serve`` mode (``llama3_8b``, ``max_seq`` 4096, ``max_slots``
   8, this script's seed, so 4b's weights; a ``--role prefill`` replica P
   and a ``--role decode`` replica D; ``reset`` and ``counts`` of the
   kernel launches on stdin), behind the port's router run as a process
   (``python -m tpuserver_torch.router_cli --probe-interval 0.2``, reached
   over HTTP only; its first log line is printed, and its exit fails the
   phase):
   (a) 4b's 12 prompts 50 ms apart through the router, phase-split: 4b's
   tokens, gap-free ``seq``s, 12 splits and 12 transfers, on P flash = 32
   x the tileable admissions and decode >= 32 x its steps, on D no flash,
   12 attach admissions and decode >= 32 x its steps, each replica's peak
   memory; (b) the round again, D SIGTERMed once every stream has 5
   events: D's snapshot reads ``draining`` within one probe interval,
   every stream finishes with 4b's tokens, 4 prompts sent while it drains
   complete (their path and agreement reported), D exits 0, and the same
   4 once the router's decode pool is empty go fused to P with 4b's
   tokens; (c) D respawned on its port with a new ``--spawn-nonce``
   (echoed, re-partitioned), 4c (c)'s 8 prompts undisturbed and then
   with D SIGKILLed once every stream has 5 events: every stream handed
   off to P and complete, gap-free, the continuation tokens' agreement
   reported, P's flash launches = 32 x (tileable prefill legs + tileable
   re-prefills), and flash held against its plain version at those
   re-prefill lengths; (d) P SIGTERMed exits 0; (e) a supervised fleet:
   ``python -m tpuserver_torch.fleet_cli`` under a manifest, one prefill
   and one decode replica (``python -m tpuserver_torch.serve``, the same
   config and seed) and a ``router_cli`` process as its children: 4b's
   12 prompts phase-split (4b's tokens, gap-free, 12 splits and 12
   transfers); the round again with the decode replica SIGKILLed once
   every stream has 5 events (one restart, every stream complete and
   gap-free, the continuation's agreement reported); a SIGTERM hands
   the fleet over with every child serving; a second supervisor on the
   manifest adopts both replicas and the router (the same pids, no
   spawn) and serves 4 prompts with 4b's tokens; SIGINT drains every
   replica and leaves no child; ``python3 chip_smoke.py --fleet-only``
   runs phases 1, 2, 4, 4b and 4g alone and prints no result line;
7. int8, last: (a) the W8A16 kernel (``csrc/int8_matmul.cu``) against its
   plain version at the five distinct Llama-3-8B weight shapes and 1, 8
   and 40 rows (row-relative ``INT8_TOL``, a planted fault, each row bit
   for bit the same row computed alone), timed beside its bound (and its
   bandwidth share, ``perf.mbu``), the bf16 ``torch.matmul`` of the
   unquantized weight, the plain version and the library's W8A16 call,
   and summed to one decode step's products at each of the three row
   counts; (b) ``llama3_8b`` with int8 weights
   (``LlamaGenerateModel(quantize=True)``, drawn and quantized on the
   card): phase 4's three requests, then 4b's 12 prompts (budgets capped
   at 32 tokens) and 4 repetitive ones (24 tokens) over ``max_slots=8``
   forward and reversed and with
   ``spec_tokens=4`` (identical tokens per prompt), the flash, decode and
   W8A16 launches of each path, TTFT, rates, the decode bandwidth share
   (``perf.mbu`` with 1-byte weights), peak memory and the tree's bytes,
   the kernel path's logits against the plain path's, the greedy tokens
   shared with bf16's (reported), and phase 6's profile of the int8 model
   beside the bf16 one;
8. vision, last, on a fresh core: ResNet-50 v1.5 and DenseNet-121 (full
   width and depth, bf16, weights from the seed), the image preprocess
   model, the image ensemble and the fixture models behind HTTP and gRPC,
   every batch bucket (1 to 32) warmed first: (a) the served bf16 logits
   (the ``logits`` hook) against a float32 forward of the same weights
   (TF32 off) at batch 1 and 32 within ``VISION_TOL``, a planted fault
   (the last block's last convolution skipped) caught, and
   ``image_ensemble`` within it of ``resnet50`` on ``RAW_IMAGE / 255``
   (whether bitwise, and whether ``resnet50`` repeats bitwise, printed); (b) 32 concurrent batch-1 requests over gRPC, then the same 32
   reversed: each within ``VISION_TOL`` of the image served alone, fewer
   executions than inferences, the mean batch printed; (c) the image in
   a CUDA region and the output into a second one, registered over gRPC
   by raw handle: the model's input lies inside the region, and
   ``torch.profiler`` over the request records no host<->device copy of
   either (every transfer is listed); (d) ``simple`` as JSON and binary,
   ``simple_string``, ``identity_bf16`` (bits unchanged),
   ``sequence_accumulate`` and ``repeat_int32``, exact; (e) ResNet-50
   infer/s and p50/p99 over gRPC at concurrency 1 and 16 for in-band,
   system-shm and CUDA-shm inputs and outputs, from a client process of
   its own (``python3 chip_smoke.py --child-load <url>``, whose CUDA
   regions the server maps over CUDA IPC), and each model's forward
   at batch 1 and 32: device time by CUDA events against its bound (the
   FLOPs of its convolutions and fc, 2 * H_out * W_out * k^2 * C_in *
   C_out each, at the bf16 tensor-core peak), device time by kernel class
   and the busy share.  No kernel of the port runs on this path (their
   launches are read and must be 0);
9. bert, last, on a fresh core: BERT-base (BASELINE config #4: 12
   layers, d_model 768, 12 heads, d_ff 3072, vocab 30522, 128 tokens;
   bf16, weights from the seed), the tokenizer, the ensemble and the
   fixture models behind HTTP and gRPC, the encoder warmed at batch 1 and
   8: (a) the served bf16 pooler logits (before the tanh: most of
   ``POOLED`` saturates) against a float32 forward of the same weights
   (TF32 off) at batch 1 and 8 within ``BERT_TOL``, ``POOLED``'s error
   printed, and two planted faults (the last layer's MLP skipped; the
   mask ignored, on the padded row) each beyond ten times it on the
   batch of 8 (the skipped MLP beyond it on the lone row); (b)
   ``bert_ensemble`` over one ``ModelStreamInfer`` stream against
   ``bert_encoder`` on ``bert_tokenizer``'s output, then pipelined
   streams of 100 distinct texts from a client process of its own
   (``python3 chip_smoke.py --child-bert <url>``), each answer against
   the same text's unary answer (whether bitwise printed); (c) config
   #4's infer/s and p50/p99 on the stream at 1 and 16 in flight, and the
   encoder's forward at batch 1 and 8: device time by CUDA events
   against its bound, device time by class and the busy share; (d) ids
   -1, 30522 and 10**6 answer 200, equal to the request with them
   clamped as JAX clamps them, and the next request succeeds; (e) the
   CUDA-region example clients as processes: ``simple_grpc_cudashm_
   client.py`` on the fixtures, ``llama_streaming_cudashm_client.py`` in
   ring and KV-park mode on a ``llama3_8b`` registered with the same
   core; and ``serve.py --models bert`` as a process on the card,
   answering as this phase's server.  The three kernels' launches over
   (a)-(d) must be 0; (e)'s llama launches make the ``cudashm_client``
   rows.
12. perf_inprocess, after 9: the port's perf analyzer (``python -m
   tpuserver_torch.perf_analyzer``'s ``main``, handed a server of the
   script's) with no transport.  (a) ``llama3_8b`` at full width and
   depth on phase 9 (e)'s weights, bf16, ``max_seq`` 4096,
   ``max_slots=8``: ``--generation --prompt-len 512 --max-tokens 32
   --concurrency-range 1:8:7 --measurement-interval 3000 --max-trials
   4``; per level TTFT and ITL p50/p99, tokens/s, streams and errors,
   the stability verdict, the launches of the three kernels around the
   run and the peak memory; no error, every stream 32 tokens, flash and
   decode launched, none of the W8A16 kernel, the rows' keys the pinned
   ones (``tpuserver_torch.perfanalyzer.report``); an unstable level is
   reported, not failed.  (b) ResNet-50 (phase 8's model, batch-1
   requests through the dynamic batcher) at concurrency 1 and 16 in
   band, then over system and over CUDA regions (input and output):
   infer/s, p50/p99, the server's queue and compute a request, the mean
   batch (in band once more at the end, the order's control); no error,
   one zero-copy read a request over CUDA regions, one request on each
   plane within ``VISION_TOL`` of the in-band answer, and no region
   left.  (c) every row printed; (a)'s launches make the
   ``perf_inprocess_generation`` rows.  ``python3 chip_smoke.py
   --perf-only`` runs phases 1-4b and 12 alone (12 on phase 4's
   weights) and prints no result line.
13. bench, after 12: the BASELINE benchmark over the port's sockets
   (``python -m tpuserver_torch.bench_full``'s ``main``, handed a server of
   the script's and phase 12's weights): the fixture models, ResNet-50 and
   DenseNet-121 uncut in bf16, the BERT ensemble and ``llama3_8b`` (bf16,
   ``max_seq`` 512, ``max_slots=8``) on one core.  First the in-process
   floor under the socket rows on that core (the port's perf analyzer, no
   transport: ``simple`` and ResNet-50 at 1, the BERT ensemble at 8, the
   llama streams' work at 8 streams), then the benchmark, its HTTP
   and gRPC front ends in this process; ``--window-s 0.5 --windows 2
   --llama-slots 8``: config 1 over HTTP (its answers a+b before any
   timing), 2 and 3 over gRPC (in band, a system region, CUDA regions in
   and out at batch 1 and 4, each window value-fenced and sampled against
   its in-band answers, the async sweeps), 4 over one pipelined bidi
   stream, 5's direct rows at JAX's shapes (prefill 2048, chunks of 32 from
   context 512, ``max_seq`` 3072) and its streams (one at a time with the
   KV cache parked in a 64 MiB CUDA region, then 1, 4 and 8 at once).
   Every row printed; no error line, every row the JAX bench's keys
   (``bench_full.ROW_KEYS``) and every kind of row there, flash and decode
   launched, one zero-copy read a CUDA-region request, no region left
   registered or allocated.  Its launches make the ``bench`` rows
   (config 5's direct rows) and the ``bench_served`` rows (its streams).
   ``python3 chip_smoke.py --bench-only`` runs phases 1-3 and 13 alone (13
   on weights drawn from the seed) and prints no result line.
14. chaos, after 13: the chaos soak's in-process modes
   (``tpuserver_torch.chaos_smoke``'s ``main``) on phase 13's weights
   upcast to float32 in place (``llama3_8b`` at full width and depth, TF32
   off for the phase and restored after; a restart re-prefills ``prompt +
   history`` in one pass, and only float32 keeps its tokens identical to
   the uninterrupted decode): the default rounds with the overload
   phase, ``--kill-loop`` and ``--shm`` over a CUDA region, ``max_seq``
   128 (at the soak's default 64 the decode kernel's blocks do not tile
   and the model attends densely, as JAX's does), two slots, 6 tokens, 4
   rounds each (one whole fault cycle).  Every mode exits 0 (every
   stream token-identical to the fault-free reference after every
   restart); each one's OK line, seconds, restarts, ring lanes read and
   launches are printed; ``decode_attention`` launches and
   ``flash_attention`` launches 0 times (prompts of 3-24 tokens and
   re-prefills of at most 30 run dense).  The one-pass prefill of each
   prompt and its reference tokens is held against the decode's tokens,
   with the smallest top-2 logit gap on the way.  Phase 3 holds the decode
   kernel at this path's shape (B 2, lengths 30 and 24, ``max_seq`` 128,
   float32).  Its launches make the ``chaos`` rows.  ``python3
   chip_smoke.py --chaos-only`` runs phases 1-3 and 14 alone (on weights
   drawn from the seed) and prints no result line.

10. tp, last: tensor-parallel serving of ``llama3_8b`` (full width,
   ``max_seq`` 4096, the seed's weights, each rank drawing every leaf and
   keeping its slice; ``python3 chip_smoke.py --tp-only`` runs phases
   1-4b and 10 alone and prints no result line).  The card is one: (a)
   tp=1 over NCCL at full depth, ``LlamaGenerateModel(mesh=)``
   single-stream and ``max_slots=8``: phase 4's and 4b's tokens bitwise;
   then the reference logits at depth 4 (the 512-token prompt's prefill
   and 16 teacher-forced steps); (b)-(d) run at depth 4, every tp=4
   collective passing through gloo on the host; (b) tp=4, four ranks
   sharing the card over gloo (collectives through host memory; this
   process the driver, three spawned followers): those logits within
   ``TP_LOGITS_TOL`` row-relative, a planted fault (layer 0's wo
   all-reduce dropped) ten times beyond it, the prompt served for 32
   tokens and again for 16 (the same), a
   prefill's and an 8-token chunk's wall time and rank 0's device time by
   class (the collectives' host copies apart), 4b's 12 requests (8 tokens
   each) at
   ``max_slots=8`` both ways (same tokens per prompt), each rank's
   memory; (c) int8 at tp=4 (each full leaf quantized, then sharded): 16
   tokens twice, the same, the W8A16 kernel on every rank; (d) a tp=4 generation parked in a CUDA
   region (the full layout) resumed at tp=4, bitwise the unparked
   continuation, and attached at tp=1 within the tolerance of tp=4's
   logits.  Each rank's launches of the three kernels make the
   ``tp1_*`` and ``tp4_*`` rows (summed, and by rank); phase 3 holds the
   kernels at one rank's shapes (flash and decode at H 8, Hkv 2; W8A16 at
   the shard shapes, one row, summed over 4 layers' step).
11. train, last: SPMD training (``llama.make_train_step``), each run in
   processes of its own (``--child-train``; ``python3 chip_smoke.py
   --train-only`` runs phases 1, 2 and 11 alone and prints no result
   line).  (a) ``llama3_8b`` at full width and depth, tp=1 (world 1 over
   NCCL), bf16, three steps on one repeated batch (B 1, T 512, seed 0,
   targets the tokens rolled by one, lr 3e-4): step 0's loss within
   ``TRAIN_LOSS_TOL`` of the unsharded ``forward``'s on the same params,
   finite and falling losses; each step's wall time, one more step
   profiled (device time by class: matmul, the attention fold forward
   and backward, optimizer, collectives, other), the busy share, the peak
   memory and the step's share of the bf16 peak (6 N tokens over its
   time).  (b) the (dp 1, sp 2, tp 2) mesh as four processes sharing the
   card over gloo, full width at depth 4, B 2, T 1024: a world-1 run of
   the same model, batch and seed first (its step 0 gradients saved),
   then the mesh with ring attention and with Ulysses, two steps each:
   the losses within ``TRAIN_MESH_LOSS_TOL`` of world 1's and rank 0's
   gradient of every leaf within ``TRAIN_GRAD_TOL`` (relative norm) of
   the matching slice, ring within ``TRAIN_SP_TOL`` of Ulysses, and the
   planted fault (layer 0's ``copy_to_tp`` without its backward sum)
   ten times beyond the gradient limit; each rank's peak memory, step
   time and collectives.  The training steps launch none of the port's
   kernels (their count is printed); the reference forward's flash
   launches make the ``train_reference_forward`` row.

15. tools, in ``python3 chip_smoke.py --tools-only`` alone, which runs
   phases 1-3 and 15 on ``llama3_8b`` weights drawn from the seed (bf16,
   full width and depth) and prints the tools' ``{"kernels": [...]}``
   line and no result line.  The full script does not run it: the phase
   takes about 310-340 s on the card, and the script's other phases
   leave less than that of its 1200 s.  The three model-path tuning
   tools run through their ``main``s: (1) ``python -m
   tpuserver_torch.bench_kernels``' whole sweep (flash at T 2048, 8192
   and 32768 with H = Hkv = 16, decode over caches of 2048 to 32768 keys
   at a quarter and full, H 16, Hkv 8; each time a CUDA graph of a chain
   of calls at two lengths, differenced, warm in L2): every
   ``cuda_flash`` and ``cuda_decode`` row present, finite and positive,
   MFU and MBU at most 1, a ``torch_dense`` row missing only at T 32768
   and only with an out-of-memory error line; each graph captured
   exactly its chain's launches through the wrapper.  (2)
   ``bench_prefill_sweep``, ``--prefill-only --rounds 4`` and
   ``--decode-only --rounds 1``: 6 prefill rows (dense, the four flash
   tiles, the attention-identity arm) and 16 decode rows (dense and
   ``auto`` attention, chunks 32 and 64, contexts 512 and 2048, bf16 and
   int8 weights), no error row; flash launched once a layer a prefill in
   each flash arm and never in the dense and identity arms, the identity
   arm faster than the dense arm and no slower than the fastest flash
   arm by more than the flash arms' spread (the four run one kernel, so
   their spread is the sweep's noise, and the identity arm saves about
   1 ms of 64); decode launched in every ``auto`` arm and in no dense
   one, the W8A16 kernel in every int8 arm and no bf16 one.  (3)
   ``bench_speculative --config llama3_8b``: exit 0 (every speculative
   stream token-identical to its plain twin), its five rows, decode
   launched in the repetitive and regenerate parts and never in the perf
   analyzer's column (``max_seq`` 96: it attends densely).  Phase 3, in
   every run, holds the kernels at the tools' shapes: flash at T 2048 and
   8192 (H 16, Hkv 16) and at T 32768 on its last 512 query rows against
   the plain attention of those rows over all their keys, decode at one
   row of a 32768-key cache at lengths 8192 and 32768 (H 16, Hkv 8), at
   the sweep's longest context (2112 keys of 3072) and at the
   speculative tool's batched step (8 rows of 38 keys of 128).  The
   tools' launches make the ``bench_kernels``, ``prefill_sweep`` (with
   the W8A16 kernel's, timed at one decode step at M 1 in this mode) and
   ``bench_speculative`` rows of that line, each with its ``timed_as``;
   ``bench_kernels``' ``launches`` are what the wrappers counted (eager
   calls and captures), its ``graph_replayed_launches`` the captured
   launches times the replays (derived: a replay bypasses the wrappers).

16. serving tools, in ``python3 chip_smoke.py --serving-tools-only``
   alone, which runs phases 1-3 and 16 on ``llama3_8b`` weights drawn
   once from the seed (bf16, full width and depth) and prints the tools'
   ``{"kernels": [...]}`` line and no result line; the full script does
   not run it.  Two serving-plane tools run through their ``main``s, each
   held to its own checks (exit 0).  (a) ``python -m
   tpuserver_torch.bench_shm_data_plane --config llama3_8b``: unary p50
   in-band, system and CUDA shm over HTTP; generation TTFT/ITL in bf16,
   in-band against CUDA-region prompts and the token ring; resume attach
   against re-prefill on a float32 copy of the weights with TF32 off
   (the tool's own choice: bf16 re-prefill is not token-identical at
   8B), every cycle token-identical to the uninterrupted reference and
   every attach-mode resume (no re-prefill one) an attached admission.
   (b)
   ``python -m tpuserver_torch.bench_disagg --config llama3_8b --dtype
   bfloat16``, twice: ``--attn kernel`` (the serving default, where the
   scheduler's ``span_safe`` turns chunked prefill off) and ``--attn
   dense`` (where the 32-token chunks interleave with decode, as the tool
   was written for): fused and split fleets' identity tokens equal, every
   probe split, no fused split, prefill chunks counted by the schedulers
   (none at ``kernel``, some in both fleets at ``dense``).  Decode must
   launch in every stage; flash launches are reported (the tools' only
   flash length is the generation part's 256-token prompt).  The phase
   holds both kernels against their plain versions at the tools' shapes
   and times them there: flash at T 256, decode at the generation step
   (4 slots of a 512-key cache), the resume step (float32, 2 slots of
   512) and the disagg step (4 slots of 256); those make the
   ``bench_shm_data_plane/generation``, ``bench_shm_data_plane/resume``,
   ``bench_disagg_kernel`` and ``bench_disagg_dense`` rows.
17. distributed, in ``python3 chip_smoke.py --distributed-only`` alone,
   which runs phases 1-3 and 17 on ``llama3_8b`` weights drawn from the
   seed and prints the phase's ``{"kernels": [...]}`` line and no result
   line; the full script does not run it.  (a) The port's HTTP server in
   this process (so the wrappers count its launches) holds the llama
   (bf16, full width and depth, ``max_slots`` 8, ``max_seq`` 1024, prefix
   caching off), ResNet-50 and the fixtures; every client is a process of
   its own.  Four arms, each one ``python -m
   tpuserver_torch.perf_analyzer`` process beside the distributed mode
   (``--workers 4``: the coordinator here, it only merges, and four
   worker processes), three windows a side: generation (512-token
   prompts, 32 tokens) at 8 streams against 4 x 2; ResNet-50 batch 1 at
   16 against 4 x 4 in band, over system regions and over CUDA regions.
   Checked: no error; tokens and generations; the merged completions
   equal the workers' sum, window by window (the coordinator's merge is
   wrapped to read them); ``--report-csv`` with the JAX tool's header, a
   row a window; flash launched once a layer an admitted prefill and
   decode launched; no region left in the server's registries or under
   ``/dev/shm``.  Both sides' infer/s or tokens/s, latency, TTFT and ITL
   are printed with the card's name and power limit.  (b) ``python -m
   tpuserver_torch.bench_router_tier`` at the JAX tool's defaults (10200
   streams; fewer, printed, only where the host's descriptor limit
   cannot hold them): every stream held, no dial error, none
   peer-forwarded, a takeover, victims token-identical, survivors never
   reconnecting.  Phase 3 holds flash at T 512; this mode adds decode at
   the served step (8 rows of a 1024-key cache).  The generation arm's
   launches make the ``distributed_single`` and ``distributed_workers``
   rows.

18. prefix cache, in ``python3 chip_smoke.py --prefix-cache-only`` alone,
   which runs phases 1-3 and 18 and prints the phase's ``{"kernels":
   [...]}`` line and no result line; the full script does not run it.
   (a) ``python -m tpuserver_torch.bench_prefix_cache --config llama3_8b
   --dtype bfloat16 --attn dense`` through its ``main`` (the tool draws
   one tree from seed 0; the preset's flash prefill would keep the radix
   cache off): exit 0, the warm rows' hit rate 93.8 (240 of 256 tokens),
   16 live streams at four slots' memory, both fleet rows with a measured
   hit rate (the tool holds the router's fleet counters to the replicas'
   sum), the headline row, decode launched in each llama part and flash in
   none.  Cold and warm TTFT, their ratio, both fleet hit rates and
   tokens/s and the headline p50/p99 are printed with the card's name and
   power limit; which fleet arm wins is printed, not checked.  (b) The
   server-side demos: ``simple_http_router_torch.py --config llama3_8b
   --dtype float32`` in this process (its tree drawn after (a)'s is
   freed; PASS with a handoff, decode launched), ``simple_fleet_torch.py
   --device cuda`` as a process (PASS: a SIGKILLed ``serve.py`` replica
   respawned, no client error) and ``simple_http_cudashm_client.py`` as a
   process against a port HTTP server here (OUTPUT0/OUTPUT1 right over
   CUDA IPC, no region left in the server's registries or under
   ``/dev/shm``).  The mode holds the decode kernel against its plain
   version and times it at the parts' steps (the warm/cold step, 2 rows
   of 512 keys; the capacity step, 16 rows of 128; the fleet step, 4 rows
   of 128; the router demo's float32 step, 2 rows of 128): the
   ``bench_prefix_cache/*`` and ``router_demo`` rows.

19. router view, in ``python3 chip_smoke.py --router-view-only`` alone,
   which runs phases 1-3 and 19 on ``llama3_8b`` weights drawn from the
   seed and prints the phase's ``{"kernels": [...]}`` line, the card's
   name and power limit and the result line; the full script does not
   run it.  (a) Two port servers in this process (so the wrappers count
   their launches), scopes ``replica-a`` and ``replica-b``, each serving
   the one bf16 tree (full width and depth) behind
   ``LlamaGenerateModel(max_slots=4, max_seq=1024)`` with prefix caching
   off, each behind the port's HTTP server and both behind the port's
   ``FleetRouter``; two arms, each one ``python -m
   tpuserver_torch.perf_analyzer --backend http -u <router> --generation
   -m llama_generate --concurrency-range 4 --prompt-len 512 --max-tokens
   32`` process (three 3 s windows, the same ``--seed``): plain, then with
   ``http.generate_stream`` severs armed on each scope (``raise``, 3
   times, after 8 events).  Checked: exit 0 and no error in both; the
   router's ``handoffs + failovers`` above 0 in the sever arm; the rows'
   ``router_failovers``, ``router_handoffs``, ``router_resumed_streams``
   and ``router_shed`` at 0 or more and the ``router failovers=`` footer;
   flash launched once a layer for each prefill whose length tiles (the
   512-token admissions; a handoff's re-prefill of prompt and history
   runs dense), decode launched; each handed-off stream's tokens before
   its first handoff equal the plain arm's for its prompt (after it the
   agreement is printed: a bf16 re-prefill can flip near-ties).  Both
   arms' tokens/s, TTFT and ITL p50/p99 and the router's deltas are
   printed with the card's name and power limit; no number is compared
   across arms.  (b) A ``FleetSupervisor`` over two ``python -m
   tpuserver_torch.serve --device cuda --models fixtures`` replica
   processes; one is SIGKILLed inside the windows of a ``perf_analyzer
   --backend http -u <its router> -m simple --concurrency-range 2``
   process.  Checked: exit 0, the row's ``supervisor_replica_restarts``,
   ``supervisor_scale_up_events``, ``supervisor_scale_down_events`` and
   ``supervisor_retired_replicas``, ``supervisor restarts=`` in its
   output, the kill healed, no child left.  The mode holds the decode
   kernel against its plain version and times it at (a)'s served step (4
   rows of 520-544 keys in a 1024-key cache; phase 3 holds flash at T
   512); both arms' launches make the ``router_view`` rows.

20. kernel domain, in ``python3 chip_smoke.py --kernel-domain-only``
   alone, which runs phases 1-3 and 20 and prints the phase's ``{"kernels":
   [...]}`` line, the card's name and power limit and the result line; the
   full script does not run it.  TF32 off for the phase.  (a) Each route
   at the shapes beyond the main path's (bf16 on the tensor cores at head
   dims other than 64 and 128, float32 on "simt") against its plain
   version and timed (CUDA events, L2 flushed) beside its bound, the plain
   version, ``ptxas``' registers and spilled bytes of the kernel instance
   the shape launches, and one library call at the same dtype (masked
   SDPA; for decode also SDPA over
   the live prefix; for the W8A16 product a float32 ``torch.matmul`` over
   the dequantized weight): flash float32 at ``llama3_8b`` and
   ``llama3_1b`` (T 512), bf16 at D 8 (``tiny``), bf16 and float32 at D 96
   and 256 over one kv head; decode bf16 at H 128 over Hkv 8 (length 4096
   of 8192), float32 multi-query (H 32, Hkv 1), bf16 at D 96 and 256, and
   at (b)'s and (c)'s served steps; the W8A16 float32 route at M 1 and 8
   over ``llama3_8b``'s weights (one decode step's products) and one ragged
   shape.  (b) ``llama3_8b`` drawn in float32 from the seed, served
   through ``InferenceServer`` and ``LlamaGenerateModel`` over HTTP at one
   slot and at ``KD_SLOTS`` (the paged scheduler): a 512-token prompt
   (and a second at ``KD_SLOTS``), 32 greedy tokens; flash's and decode's
   float32 routes launched; the same weights at ``attn_impl="dense"``: the
   prefill's last-row logits within ``KD_LOGITS_TOL`` row-relative, the
   tokens side by side, a difference failing unless the dense arm's top-2
   gap there is a near tie (``KD_GAP_TOL``).  (d) the same tree quantized
   (int8 weights, float32 activations), one stream: the W8A16 float32
   route launched; one decode step's logits within ``KD_INT8_LOGITS_TOL``
   of the same step with ``quant.int8_matmul`` bound to its plain version
   (put back after), a planted fault beyond it; the peak with both trees.
   (c) ``tiny`` (vocab 128) and a narrow multi-query model (H 16, Hkv 1,
   D 96, 2 layers), bf16 at ``attn_impl="kernel"``: JAX's
   ``test_llama_decode_pallas_matches_xla`` (a 128-token prompt, 12
   tokens in chunks of 4, ``max_seq`` 256): tokens identical to the dense
   arm's, the tensor-core routes launched and "simt" never.  The rows of
   the line: each
   path's kernels on their routes, and each timed route no path runs with
   its 0 launches.

The peaks of every bound come from ``tpuserver_torch.ops.perf`` by the
card's name (phase 1 fails on a card the table does not know).  Every
row of a kernels line names the route (``kernel_route``) of the shape it
is timed at; the full script's rows also name every route of their
kernel with the largest row-relative error phase 3 held it to
(``routes_held_in_phase3``).  The line
before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src", "python"))

# the card's published peaks (HBM bytes/s, dense bf16 tensor-core
# operations/s, float32 FMA operations/s on the CUDA cores), read from
# tpuserver_torch.ops.perf by name in phase 1
SPEC = None

# kernel vs plain tolerances on the card.  The measure is row-relative:
# for each output row (one query head's D values) the largest |kernel -
# plain| over that row's largest |plain|, the worst row counting.  An
# absolute limit would not do: a decode row at length 4096 is about 0.03
# in size, so an absolute 3e-2 would pass a kernel that skipped a tile.
# bf16: both sides round to 8 mantissa bits (one ulp is at most 2^-7 =
# 7.8e-3 of the row's largest value) and the flash kernel also rounds its
# probabilities to bf16 before the P.V product, as the TPU kernel does;
# 2e-2 leaves about 2.5x that.  float32 differs only in the order of
# summation.  phase_kernels checks that planted faults (a skipped key tile,
# a wrong kv head) break these limits.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# model check: last-position prefill logits, kernels vs plain attention,
# bf16 weights and activations over 32 layers
LOGITS_TOL = 0.25

SEED = 0

# the batched decode shape timed in phase 3 and profiled in phase 6: 8
# live slots near length 600
BATCHED_LENGTHS = tuple(600 - 7 * i for i in range(8))
# phase 13's served decode (the benchmark's streams behind
# ``max_slots=8``): eight 8-token prompts halfway through their 64 tokens,
# in the 512-key cache of ``bench_full.LLAMA_MAX_SEQ``
BENCH_SERVED_LENGTHS = (40,) * 8
BENCH_SERVED_SEQ = 512
# phase 14's batched decode: two slots of a 128-token cache (the least
# the decode kernel's blocks tile: at the soak's default 64 the model
# attends densely), the longest row a 24-token prompt re-prefilled with
# 6 tokens of history
CHAOS_LENGTHS = (30, 24)
CHAOS_SEQ = 128
# phase 15's shapes: bench_kernels' flash at T 2048, 8192 and 32768 (H =
# Hkv = 16, D 128; the last held on its last rows) and its decode over
# caches of 32768 keys (H 16, Hkv 8); the prefill sweep's longest decode
# context (2048 + 64 keys of its 3072-key cache); bench_speculative's
# batched decode (8 rows halfway through their 12 + 52 tokens, in its
# 128-key cache)
TOOLS_FLASH_TS = (2048, 8192, 32768)
TOOLS_HEADS, TOOLS_KV_HEADS = 16, 8
TOOLS_DECODE_SEQ = 32768
TOOLS_DECODE_LENGTHS = (8192, 32768)
SWEEP_DECODE_LENGTHS, SWEEP_SEQ = (2112,), 3072
SPEC_TOOL_LENGTHS, SPEC_TOOL_SEQ = (38,) * 8, 128
# flash at T 32768 is held on its last LONG_CHECK_ROWS query rows: the
# plain attention of all its rows would need 64 GiB of float32 scores
LONG_CHECK_ROWS = 512
# prompt lengths of phase 4b's requests, four of each; phase 3 checks the
# flash kernel at every one whose admission prefill it runs
BATCHED_PROMPT_LENGTHS = (512, 256, 77)
# phase 4c's fault rounds: a step fails when a 600-token prompt's row is
# at position HEAL_TRIGGER_POS, which has it admitted again (prompt +
# history prefilled) at HEAL_TRIGGER_POS - 1 = 640 tokens, a flash length
HEAL_PROMPT_LENGTHS = (600, 512, 256, 77) * 2
HEAL_BUDGET = 48
HEAL_TRIGGER_POS = 641
READMIT_LENGTH = HEAL_TRIGGER_POS - 1
# phase 4c: the watchdog's limit, and the injected host stall
STEP_TIMEOUT_S = 1.0
HANG_S = 3 * STEP_TIMEOUT_S
SPEC_K = 4
# phase 4c's speculative fault round: 512-token repetitive prompts; the
# verify stalls once a row has reached SPEC_HEAL_TRIGGER_POS
SPEC_HEAL_BUDGET = 32
SPEC_HEAL_TRIGGER_POS = 512 + 12
# phase 6's wall-time samples per step
WALL_REPS = 5
# phase 10: tensor-parallel serving, four ranks sharing the one card over
# gloo (NCCL refuses two ranks on one device) and one rank over NCCL
TP_RANKS = 4
# phase 10 (b): tp=4 logits against the unsharded model's, row-relative
# as TOL.  Every row-parallel product sums four bf16 partials that the
# unsharded product sums in float32 inside one GEMM, each partial rounded
# to bf16 first (2^-9 of its size), and the layers carry that on (32 gave
# 0.015-0.023); the kernel-vs-plain model check moves the same logits by
# about 0.09 of a largest |logit| near 5 (phase 5).  A planted fault
# (layer 0's wo all-reduce dropped: three quarters of its heads missing)
# must move them ten times as far
TP_LOGITS_TOL = 0.05
TP_FAULT_LAYER = 0
# seconds a tp collective may wait (the followers' first kernel loads)
TP_TIMEOUT_S = 300.0
# phase 10 (b)-(d) at tp=4, where every collective passes through gloo on
# the host (about 5.5 ms each among four processes on one H100's host,
# tools/torch_tp_collectives.py), two a layer and a step: the full width
# at depth TP4_LAYERS (the 32 layers took about 165 s of the script's
# 1200 s there; tp=1 keeps them, and phase 4's tokens, and gives tp=4
# its reference logits at this depth from the same seed), and the
# teacher-forced steps, the served stream's tokens (twice the tokens
# before a park), the repeat's and int8's tokens, 4b's budgets (capped),
# the tokens before a park, and the profile's wall samples
TP4_LAYERS = 4
TP_FORCED_STEPS = 16
TP_REPEAT_TOKENS = 16
TP_BATCHED_BUDGET = 8
TP_INT8_TOKENS = 16
TP_PARK_TOKENS = 16
TP_SINGLE_TOKENS = 2 * TP_PARK_TOKENS
TP_WALL_REPS = 3
# phase 11 (a): llama3_8b at full width and depth trains at tp=1 (world 1
# over NCCL) for TRAIN_STEPS steps on one repeated batch of TRAIN_BATCH x
# TRAIN_LEN tokens at JAX's default learning rate
TRAIN_BATCH = 1
TRAIN_LEN = 512
TRAIN_STEPS = 3
TRAIN_LR = 3e-4
# (a): step 0's loss against the unsharded forward's loss on the same
# params and tokens (mean NLL near ln(128256) = 11.8).  The two differ in
# attention alone: the flash kernel rounds its probabilities to bf16
# before P.V, the training fold keeps float32, and phase 5 finds the two
# paths' logits about 0.09 apart (of a largest |logit| near 5).  A
# token's NLL moves by at most twice its logits' largest move and the
# mean over 512 tokens averages the moves out
TRAIN_LOSS_TOL = 0.05
# (b): the (dp, sp, tp) mesh mesh_factorize(4) gives, JAX's dry-run mesh,
# as four processes sharing the card over gloo (NCCL refuses two ranks on
# one device), full width, depth cut to TRAIN_MESH_LAYERS (four ranks'
# params, gradients and AdamW state at full depth would need about 128
# GB), B 2 and T 1024 (512 a rank)
TRAIN_MESH = (1, 2, 2)
TRAIN_MESH_LAYERS = 4
TRAIN_MESH_BATCH = 2
TRAIN_MESH_LEN = 1024
# (b)'s steps a run (the world-1 reference, ring, Ulysses): two, so the
# script keeps within its 1200 s; each mesh step sums its gradients over
# gloo through host memory, several seconds a step
TRAIN_MESH_STEPS = 2
# (b) against a world-1 run of the same model, batch and seed, both bf16:
# rank 0's gradient of each leaf against the matching slice, relative
# norm.  The mesh rounds each rank's bf16 partial (tp partial products,
# each rank's share of a gradient over dp x sp) before the float32 sum,
# where world 1 sums inside one GEMM: a few bf16 roundings (2^-9 each)
# per value, carried through four layers.  The planted fault drops half
# of the gradient at layer 0's norm outputs (the other tp rank's heads
# and columns), about 0.7 of layer 0's norm gradients, which must be ten
# times this.  These functions run on the CPU at a narrow width (d_model
# 512, vocab 4096, bf16, depth 4) gave a worst leaf of 0.025 and the
# fault 0.85
TRAIN_GRAD_TOL = 0.06
# (b): the steps' losses against world 1's (the same roundings, a loss
# near 12)
TRAIN_MESH_LOSS_TOL = 0.02
# (b): ring against Ulysses, step 0's loss: JAX's own limit
# (tests/test_llama.py)
TRAIN_SP_TOL = 5e-3
TRAIN_FAULT_LAYER = 0
# phase 4e (b): the child process's region: the 512-token prompt at 0, a
# ring of 64 slots of 8 bytes, then their 4-byte seq words
CHILD_RING_OFF = 2048
CHILD_SEQ_OFF = CHILD_RING_OFF + 64 * 8
CHILD_REGION_BYTES = 4096


def log(*args):
    print(*args, flush=True)


def fail(msg):
    log("FAIL:", msg)
    sys.exit(1)


# -- phase 1: device ---------------------------------------------------------


def phase_device(torch):
    global SPEC
    from tpuserver_torch.ops import perf

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    name = torch.cuda.get_device_name(0)
    SPEC = perf.chip_spec(0)
    if SPEC is None:
        fail("no published spec for {} in tpuserver_torch.ops.perf: the "
             "bounds need its peaks".format(name))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    log("device:", name, "count:", torch.cuda.device_count(),
        "torch", torch.__version__, "cuda", torch.version.cuda, "spec",
        SPEC)
    return name, smi.stdout.strip().splitlines()[0]


# -- phase 2: build ----------------------------------------------------------


def phase_build():
    from tpuserver_torch.ops import _build

    t0 = time.monotonic()
    _build.load_library()
    log("build: {:.1f} s (nvcc {:.1f} s) -> {}".format(
        time.monotonic() - t0, _build.last_build_seconds, _build.BUILD_DIR))
    nvlog = _build.BUILD_DIR / "nvcc.log"
    if nvlog.exists():
        for line in nvlog.read_text().splitlines():
            if any(k in line for k in ("registers", "spill", "C7518")) or \
                    line.startswith("=="):
                log("  ptxas:", line.strip())


def ptxas_instances(text):
    """{kernel entry (mangled name): {"registers", "spill_stores",
    "spill_loads"}} from an nvcc log written with ``-Xptxas -v``."""
    out, name, spill = {}, None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = {"registers": int(m.group(1)),
                         "spill_stores": spill[0], "spill_loads": spill[1]}
            name = None
    return out


def _padded_head_dim(d):
    """The head dim an attention tensor-core instance runs at (csrc's
    D_p): 64, 128, 192 or 256."""
    return next(p for p in (64, 128, 192, 256) if d <= p)


def kernel_instance(kname, route, d=None, n_rep=1):
    """The fragment of the mangled name of the kernel instance that a
    row of ``kname`` on ``route`` at head dim ``d`` and ``n_rep`` query
    heads a kv head launches (the templates of ``csrc/*.cu``)."""
    if kname == "flash_attention":
        return ("flash_attention_kernelILi{}E".format(_padded_head_dim(d))
                if route == "wgmma" else
                "flash_attention_simt_kernelILi{}E".format(1 if d <= 128
                                                           else 2))
    if kname == "decode_attention":
        if route == "mma":
            dp = _padded_head_dim(d)
            return "decode_attention_mma_kernelILi{}ELi{}ELb{}E".format(
                dp, 8 if n_rep <= 8 and dp < 256 else 16,
                int(d in (64, 128)))
        rep = next(r for r in (1, 2, 4, 8) if min(n_rep, 8) <= r)
        return "decode_attention_kernelIfLi{}E".format(rep)
    return "w8a32_kernel" if route == "simt" else "w8a16_mma_kernel"


def ptxas_of(instances, fragment):
    """The registers and spilled bytes of the instances whose name holds
    ``fragment`` (the most of each over them, and how many matched)."""
    hits = [v for k, v in instances.items() if fragment in k]
    if not hits:
        return None
    return {"instances": len(hits),
            **{key: max(h[key] for h in hits)
               for key in ("registers", "spill_stores", "spill_loads")}}


# -- phase 3: kernels against their plain versions ---------------------------


def _time_ms(torch, fn, iters, flush):
    """Mean device time of ``fn`` over ``iters`` launches, each timed by
    its own CUDA events after an L2 flush (the serving loop finds the
    KV cache cold: a layer's weights pass through L2 between calls).

    The flush reads 64 MB, leaving L2 full of clean lines.  A flush by
    writing (``zero_``) leaves up to 50 MB of dirty lines that the timed
    kernel then pays to write back, which added up to tens of us to a
    small kernel's time on the H100."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda.synchronize()
    # hold the card while the host enqueues every launch, so the events
    # time the device work and not the host's launch overhead
    torch.cuda._sleep(int(4e6) * iters)
    for i in range(iters):
        flush.sum(dtype=torch.int32)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def row_rel_err(out, ref):
    """Largest |out - ref| of each last-dim row over that row's largest
    |ref|, the worst row; a row whose reference is all zeros must match
    it exactly."""
    diff = (out.float() - ref.float()).abs().amax(dim=-1)
    scale = ref.float().abs().amax(dim=-1).clamp_min(1e-30)
    return (diff / scale).max().item()


def _bound_ms(nbytes, ops, ops_per_s):
    t_bytes = nbytes / SPEC.hbm_bandwidth
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _flash_case(torch, F, fl, dev, gen, b, t, h, hkv, d, causal, dtype,
                timed, flush):
    q = torch.randn(b, t, h, d, device=dev, generator=gen).to(dtype)
    k = torch.randn(b, t, hkv, d, device=dev, generator=gen).to(dtype)
    v = torch.randn(b, t, hkv, d, device=dev, generator=gen).to(dtype)
    before = fl.flash_attention.launches
    out = fl.flash_attention(q, k, v, causal=causal)
    again = fl.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if fl.flash_attention.launches != before + 2:
        fail("flash_attention did not launch its kernel")
    if not torch.equal(out, again):
        fail("flash_attention: two calls on the same inputs differ")
    ref = fl.flash_attention_reference(q, k, v, causal=causal)
    err = (out.float() - ref.float()).abs().max().item()
    row = {"b": b, "t": t, "h": h, "hkv": hkv, "d": d, "causal": causal,
           "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
           "row_rel_err": row_rel_err(out, ref)}
    # planted faults, on the plain version: the last key tile dropped (the
    # queries stop one tile short) and every query head on the next kv head
    cut = t - 64
    faults = {
        "skipped_tile": torch.cat([fl.flash_attention_reference(
            q[:, :cut], k[:, :cut], v[:, :cut], causal=causal),
            fl.flash_attention_reference(
                q[:, cut:], k[:, :cut], v[:, :cut], causal=False)], dim=1)
        if causal else fl.flash_attention_reference(
            q, k[:, :cut], v[:, :cut], causal=False),
        "wrong_kv_head": fl.flash_attention_reference(
            q, k.roll(1, dims=2), v.roll(1, dims=2), causal=causal)}
    row["planted_fault_err"] = {n: row_rel_err(f, ref)
                                for n, f in faults.items()}
    if timed:
        n_rep = h // hkv
        ke = k.repeat_interleave(n_rep, dim=2).transpose(1, 2)
        ve = v.repeat_interleave(n_rep, dim=2).transpose(1, 2)
        qt = q.transpose(1, 2)
        row["ms"] = _time_ms(torch, lambda: fl.flash_attention(
            q, k, v, causal=causal), 50, flush)
        row["plain_ms"] = _time_ms(torch, lambda: fl.flash_attention_reference(
            q, k, v, causal=causal), 10, flush)
        row["library_ms"] = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, ke, ve, is_causal=causal), 50, flush)
        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
        isz = q.element_size()
        nbytes = (2 * b * t * h * d + 2 * b * t * hkv * d) * isz
        row["bound_ms"], row["bound_by"] = _bound_ms(
            nbytes, 4 * pairs * d, SPEC.peak_bf16_flops
            if dtype == torch.bfloat16 else SPEC.peak_fp32_flops)
    return row


def _flash_rows_reference(torch, fl, q, k, v, start, stop, keys=None):
    """The plain version's attention (float32, causal) of query rows
    [start, stop) over keys [0, ``keys``) (default ``stop``), the rows at
    their own positions: a slice of ``flash_attention_reference``'s
    output that never forms the other rows' scores."""
    keys = stop if keys is None else keys
    n_rep = q.shape[2] // k.shape[2]
    kf = k[:, :keys].float().repeat_interleave(n_rep, dim=2)
    vf = v[:, :keys].float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q[:, start:stop].float(),
                     kf) * q.shape[-1] ** -0.5
    q_pos = torch.arange(start, stop, device=q.device)[:, None]
    k_pos = torch.arange(keys, device=q.device)[None, :]
    s = s.masked_fill(k_pos > q_pos, float("-inf"))
    return fl._fold(s, vf, "bhqk,bkhd->bqhd").to(q.dtype)


def _flash_long_case(torch, F, fl, dev, gen, t, h, hkv, d, flush):
    """The flash kernel at a length whose plain attention does not fit
    (causal, bf16): held on its last ``LONG_CHECK_ROWS`` rows against the
    plain attention of those rows over all their keys; timed beside the
    plain version computed in 512-row slices, masked SDPA and the bound."""
    bf16 = torch.bfloat16
    q = torch.randn(1, t, h, d, device=dev, generator=gen).to(bf16)
    k = torch.randn(1, t, hkv, d, device=dev, generator=gen).to(bf16)
    v = torch.randn(1, t, hkv, d, device=dev, generator=gen).to(bf16)
    before = fl.flash_attention.launches
    out = fl.flash_attention(q, k, v, causal=True)
    again = fl.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    if fl.flash_attention.launches != before + 2:
        fail("flash_attention did not launch its kernel")
    if not torch.equal(out, again):
        fail("flash_attention: two calls on the same inputs differ")
    del again
    start = t - LONG_CHECK_ROWS
    ref = _flash_rows_reference(torch, fl, q, k, v, start, t)
    got = out[:, start:]
    row = {"b": 1, "t": t, "h": h, "hkv": hkv, "d": d, "causal": True,
           "dtype": "bfloat16", "checked_rows": [start, t],
           "max_abs_err": (got.float() - ref.float()).abs().max().item(),
           "row_rel_err": row_rel_err(got, ref)}
    # planted faults, on the plain version: the last 64 keys dropped, and
    # every query head on the next kv head
    row["planted_fault_err"] = {
        "skipped_tile": row_rel_err(_flash_rows_reference(
            torch, fl, q, k, v, start, t, keys=t - 64), ref),
        "wrong_kv_head": row_rel_err(_flash_rows_reference(
            torch, fl, q, k.roll(1, dims=2), v.roll(1, dims=2), start, t),
            ref)}
    del out, got, ref

    def plain():
        return torch.cat([
            _flash_rows_reference(torch, fl, q, k, v, lo,
                                  lo + LONG_CHECK_ROWS)
            for lo in range(0, t, LONG_CHECK_ROWS)], dim=1)

    n_rep = h // hkv
    qt = q.transpose(1, 2)
    ke = k.repeat_interleave(n_rep, dim=2).transpose(1, 2)
    ve = v.repeat_interleave(n_rep, dim=2).transpose(1, 2)
    row["ms"] = _time_ms(torch, lambda: fl.flash_attention(
        q, k, v, causal=True), 10, flush)
    row["plain_ms"] = _time_ms(torch, plain, 2, flush)
    row["plain"] = "in {}-row slices".format(LONG_CHECK_ROWS)
    row["library_ms"] = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, ke, ve, is_causal=True), 10, flush)
    pairs = h * t * (t + 1) // 2
    nbytes = (2 * t * h * d + 2 * t * hkv * d) * q.element_size()
    row["bound_ms"], row["bound_by"] = _bound_ms(
        nbytes, 4 * pairs * d, SPEC.peak_bf16_flops)
    return row


def _decode_case(torch, F, fl, dev, gen, lengths, s, h, hkv, d, dtype, timed,
                 flush):
    b = len(lengths)
    q = torch.randn(b, h, d, device=dev, generator=gen).to(dtype)
    kc = torch.randn(b, s, hkv, d, device=dev, generator=gen).to(dtype)
    vc = torch.randn(b, s, hkv, d, device=dev, generator=gen).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = fl.decode_attention.launches
    out = fl.decode_attention(q, kc, vc, lens)
    again = fl.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    if fl.decode_attention.launches != before + 2:
        fail("decode_attention did not launch its kernel")
    if not torch.equal(out, again):
        fail("decode_attention: two calls on the same inputs differ")
    ref = fl.decode_attention_reference(q, kc, vc, lens)
    n_split = fl.decode_splits(b, hkv, s, fl._sm_count(q.device))
    split_ref = fl.decode_attention_split_reference(q, kc, vc, lens, n_split)
    err = (out.float() - ref.float()).abs().max().item()
    for i, n in enumerate(lengths):
        if n == 0 and out[i].abs().max().item() != 0.0:
            fail("decode_attention: length-0 row is not zeros")
    row = {"lengths": list(lengths), "s": s, "h": h, "hkv": hkv, "d": d,
           "dtype": str(dtype).split(".")[-1], "n_split": n_split,
           "max_abs_err": err, "row_rel_err": max(
               row_rel_err(out, ref), row_rel_err(out, split_ref))}
    # planted faults, on the plain version: the last 256-key tile of every
    # row longer than one tile skipped, and every query head on the next
    # kv head
    if max(lengths) > 256 and hkv > 1:
        row["planted_fault_err"] = {
            "skipped_tile": row_rel_err(fl.decode_attention_reference(
                q, kc, vc, torch.where(lens > 256, lens - 256, lens)), ref),
            "wrong_kv_head": row_rel_err(fl.decode_attention_reference(
                q, kc.roll(1, dims=2), vc.roll(1, dims=2), lens), ref)}
    if timed:
        n_rep = h // hkv
        ke = kc.repeat_interleave(n_rep, dim=2).transpose(1, 2)
        ve = vc.repeat_interleave(n_rep, dim=2).transpose(1, 2)
        mask = (torch.arange(s, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        qt = q[:, :, None, :]
        row["ms"] = _time_ms(torch, lambda: fl.decode_attention(
            q, kc, vc, lens), 200, flush)
        row["plain_ms"] = _time_ms(torch, lambda: fl.decode_attention_reference(
            q, kc, vc, lens), 20, flush)
        row["library_ms"] = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, ke, ve, attn_mask=mask), 200, flush)
        # SDPA over the live prefix only (the longest row's, masked for
        # the shorter rows): the masked call above reads the whole padded
        # cache
        live_s = max(lengths)
        kl, vl = ke[:, :, :live_s], ve[:, :, :live_s]
        live_mask = None if b == 1 else mask[..., :live_s]
        row["library_live_ms"] = _time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kl, vl, attn_mask=live_mask), 200, flush)
        isz = q.element_size()
        live = sum(lengths)
        nbytes = (2 * live * hkv * d + 2 * b * h * d) * isz + 4 * b
        row["bound_ms"], row["bound_by"] = _bound_ms(
            nbytes, 4 * live * h * d, SPEC.peak_bf16_flops
            if dtype == torch.bfloat16 else SPEC.peak_fp32_flops)
    return row


def _flash_admissions(llama, cfg, max_seq, lengths):
    """The prefill lengths at which the scheduler's admissions of prompts
    of ``lengths`` tokens run the flash kernel (the rest prefill dense)."""
    padded = (llama.prefill_bucket(cfg, max_seq, n) for n in lengths)
    return [t for t in padded if None not in llama._flash_blocks(t, cfg)]


def phase_kernels(torch):
    """Every kernel against its plain version; returns the timed rows of
    the main path's shapes and the largest error, by kernel name."""
    import torch.nn.functional as F

    from tpuserver_torch.models import llama
    from tpuserver_torch.ops import flash as fl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # Llama-3-8B attention geometry
    h, hkv, d, s = 32, 8, 128, 4096
    timed = {}
    rows = []
    # causal at every flash prefill length of the served paths: phase 4's
    # 512-token prompt, each tileable admission of phases 4b and 4c, and
    # the re-admission length phase 4c's fault rounds produce (the others
    # it produces are checked after it, by phase_flash_lengths)
    prefill_ts = sorted({512, READMIT_LENGTH, *_flash_admissions(
        llama, llama.llama3_8b(), s,
        BATCHED_PROMPT_LENGTHS + HEAL_PROMPT_LENGTHS)})
    # one rank's heads at tp 4 (phase 10): H 8, Hkv 2
    h4, hkv4 = h // TP_RANKS, hkv // TP_RANKS
    for b, t, causal, dtype, hh, kk, dd in (
            *((1, t, True, bf16, h, hkv, d) for t in prefill_ts),
            (1, 512, False, bf16, h, hkv, d),
            (1, 2048, True, bf16, h, hkv, d),
            (1, 2048, False, bf16, h, hkv, d),
            (2, 256, True, bf16, 16, 8, 64),  # Llama-3.2-1B head dim
            # phase 10's tp=4 prefills: 4b's tileable prompt lengths
            (1, 512, True, bf16, h4, hkv4, d),
            (1, 256, True, bf16, h4, hkv4, d),
            # phase 15's bench_kernels at T 2048 and 8192 (T 32768 below)
            *((1, t, True, bf16, TOOLS_HEADS, TOOLS_HEADS, d)
              for t in TOOLS_FLASH_TS[:-1])):
        main = (t == 512 and causal and dtype == bf16 and hh == h)
        readmit = (t == READMIT_LENGTH and b == 1)
        tp4 = (t == 512 and hh == h4)
        tools = hh == TOOLS_HEADS and kk == TOOLS_HEADS
        row = _flash_case(torch, F, fl, dev, gen, b, t, hh, kk, dd, causal,
                          dtype, main or readmit or tp4 or tools or (
                              t == 2048 and causal), flush)
        row["kernel"] = "flash_attention"
        rows.append(row)
        if main:
            timed["flash_attention"] = row
        if readmit:
            timed["flash_attention_readmission"] = row
        if tp4:
            timed["flash_attention_tp4"] = row
        if t == 2048 and causal and hh == h:
            timed["flash_attention_T2048"] = row
        if tools:
            timed["flash_attention_tools_T{}".format(t)] = row
    row = _flash_long_case(torch, F, fl, dev, gen, TOOLS_FLASH_TS[-1],
                           TOOLS_HEADS, TOOLS_HEADS, d, flush)
    row["kernel"] = "flash_attention"
    rows.append(row)
    timed["flash_attention_tools_T{}".format(TOOLS_FLASH_TS[-1])] = row
    n_sms = fl._sm_count(dev)
    for lengths, ss, dtype, hh, kk, dd in (
            ((576,), s, bf16, h, hkv, d),    # the main path's longest decode
            ((1,), s, bf16, h, hkv, d),      # fewer keys than splits
            ((15,), s, bf16, h, hkv, d),     # the edges of a 16-key split
            ((16,), s, bf16, h, hkv, d),
            ((17,), s, bf16, h, hkv, d),
            ((63,), s, bf16, h, hkv, d),     # the edges of a 64-key tile
            ((64,), s, bf16, h, hkv, d),
            ((65,), s, bf16, h, hkv, d),
            ((4096,), s, bf16, h, hkv, d),
            ((77, 1000, 4096, 0), s, bf16, h, hkv, d),
            ((77,) * 34, s, bf16, h, hkv, d),  # B * Hkv >= 2 waves: 1 split
            # the batched step's shape: 8 slots, ragged, inert rows at 1
            ((1, 77, 1, 600, 4096, 1, 3000, 1), s, bf16, h, hkv, d),
            (BATCHED_LENGTHS, s, bf16, h, hkv, d),
            (BENCH_SERVED_LENGTHS, BENCH_SERVED_SEQ, bf16, h, hkv, d),
            (CHAOS_LENGTHS, CHAOS_SEQ, f32, h, hkv, d),
            ((40, 17), 64, f32, 6, 2, 16),
            # phase 10's tp=4 decode: one rank's heads
            ((576,), s, bf16, h4, hkv4, d),
            (BATCHED_LENGTHS, s, bf16, h4, hkv4, d),
            # phase 15: bench_kernels' one row over 32768 keys, the
            # prefill sweep's longest context, bench_speculative's step
            *(((n,), TOOLS_DECODE_SEQ, bf16, TOOLS_HEADS, TOOLS_KV_HEADS,
               d) for n in TOOLS_DECODE_LENGTHS),
            (SWEEP_DECODE_LENGTHS, SWEEP_SEQ, bf16, h, hkv, d),
            (SPEC_TOOL_LENGTHS, SPEC_TOOL_SEQ, bf16, h, hkv, d)):
        main = lengths == (576,) and hh == h and ss == s
        batched = lengths == BATCHED_LENGTHS and hh == h
        served = lengths == BENCH_SERVED_LENGTHS
        chaos = lengths == CHAOS_LENGTHS
        tp4 = hh == h4 and kk == hkv4 and dd == d
        tools = hh == TOOLS_HEADS and kk == TOOLS_KV_HEADS
        sweep = lengths == SWEEP_DECODE_LENGTHS and ss == SWEEP_SEQ
        spec_tool = lengths == SPEC_TOOL_LENGTHS and ss == SPEC_TOOL_SEQ
        row = _decode_case(torch, F, fl, dev, gen, lengths, ss, hh, kk, dd,
                           dtype, main or batched or served or chaos or tp4
                           or tools or sweep or spec_tool
                           or lengths == (4096,), flush)
        row["kernel"] = "decode_attention"
        rows.append(row)
        if main:
            timed["decode_attention"] = row
        if batched:
            timed["decode_attention_batched"] = row
        if served:
            timed["decode_attention_bench_served"] = row
        if chaos:
            timed["decode_attention_chaos"] = row
        if tp4:
            timed["decode_attention_tp4" + (
                "_batched" if len(lengths) > 1 else "")] = row
        if tools:
            timed["decode_attention_tools_S{}_L{}".format(
                ss, lengths[0])] = row
        if sweep:
            timed["decode_attention_sweep"] = row
        if spec_tool:
            timed["decode_attention_spec_tool"] = row
        if len(lengths) == 34 and row["n_split"] != 1:
            fail("decode_splits chose {} splits for B 34 (want 1)".format(
                row["n_split"]))
        if lengths == (1,) and not row["n_split"] > 1:
            fail("decode_splits chose 1 split for one 8B stream on {} "
                 "SMs".format(n_sms))
    # the W8A16 kernel at one tp=4 rank's shard shapes (phase 10's int8
    # decode steps, at its depth), one row
    from tpuserver_torch.ops import perf, quant

    int8_tp4 = {}
    for k, n in sorted({(k, n) for _, k, n in INT8_TP4_WEIGHTS}):
        for row in _int8_cases(torch, quant, perf, dev, gen, k, n, flush,
                               m_rows=(1,)):
            log("kernel_case:", json.dumps(row))
            int8_tp4[(1, k, n)] = row
            if not row["row_rel_err"] <= INT8_TOL or not row[
                    "planted_fault_err"]["skipped_rows"] > INT8_TOL:
                fail("int8_matmul at a tp=4 shard shape: {}".format(row))
    timed["int8_matmul_tp4_step"] = _int8_step_sum(
        int8_tp4, 1, TP4_LAYERS, INT8_TP4_WEIGHTS)
    timed["int8_matmul_tp4_step"]["max_abs_err"] = max(
        r["max_abs_err"] for r in int8_tp4.values())
    log("timed: int8_matmul, one tp=4 rank's decode step at M 1: {}".format(
        json.dumps(timed["int8_matmul_tp4_step"])))
    bad, blind = [], []
    for row in rows:
        if "lengths" in row and len(row["lengths"]) > 8:
            row["lengths"] = "{} x {}".format(len(row["lengths"]),
                                              row["lengths"][0])
        log("kernel_case:", json.dumps(row))
        tol = TOL[row["dtype"]]
        if not row["row_rel_err"] <= tol:
            bad.append(row)
        if any(not e > tol for e in row.get("planted_fault_err", {}).values()):
            blind.append(row)
    for row in rows:
        if "ms" in row:
            # rank against the faster of the two library yardsticks
            lib = min(v for k, v in row.items()
                      if k in ("library_ms", "library_live_ms"))
            log("timed: {} {} ms, bound {} ms ({}), plain {} ms, faster "
                "library call {} ms ({:.3f}x the kernel)".format(
                    row["kernel"], row["ms"], row["bound_ms"],
                    row["bound_by"], row["plain_ms"], lib, lib / row["ms"]))
    if bad:
        fail("kernels disagree with their plain versions: {}".format(bad))
    if blind:
        fail("a planted fault passes the tolerance: {}".format(blind))
    del flush
    torch.cuda.empty_cache()
    rows += phase_route_checks(torch)
    max_err = {}
    for row in rows:
        max_err[row["kernel"]] = max(max_err.get(row["kernel"], 0.0),
                                     row["max_abs_err"])
    return {"timed": timed, "max_err": max_err,
            "route_err": _route_errors(rows + list(int8_tp4.values())),
            "flash_lengths": set(prefill_ts)}


def _route_errors(rows):
    """{kernel: {route: the largest row-relative error against its plain
    version}} over phase 3's cases, each under the route its shape
    took."""
    out = {}
    for row in rows:
        by_route = out.setdefault(row["kernel"], {})
        route = _route_of(row["kernel"], row)
        by_route[route] = max(by_route.get(route, 0.0), row["row_rel_err"])
    return out


# phase 3's check of the kernels' routes beyond the shapes the main path
# runs (bf16 on the tensor cores at head dims other than 64 and 128, the
# head dim padded inside the kernel; the float32 "simt" routes; the decode
# kernel past 8 query heads a kv head, where its blocks take the heads in
# groups of 16 on "mma" and 8 on "simt"), each against its plain version
# at a small shape with a planted fault; correctness only (phase 20 times
# them).  flash: (b, t, h, hkv, d, causal, dtype); t is no multiple of the
# routes' 32- and 64-key tiles where it can be
ROUTE_FLASH_CASES = (
    (2, 200, 8, 2, 128, True, "float32"),     # llama3_8b's heads, simt
    (1, 128, 8, 4, 8, True, "bfloat16"),      # tiny's: wgmma at D_p 64
    (1, 160, 16, 1, 96, True, "bfloat16"),    # multi-query, D 96: D_p 128
    (1, 96, 4, 1, 256, False, "float32"),
    (1, 72, 4, 2, 256, True, "bfloat16"),     # D_p 256, one warpgroup
    (1, 200, 8, 2, 192, True, "bfloat16"),    # D_p 192
    (1, 72, 6, 3, 24, False, "float32"),
    (2, 136, 8, 2, 64, True, "float32"))      # llama3_1b's head dim
# decode: (lengths, s, h, hkv, d, dtype)
ROUTE_DECODE_CASES = (
    ((0, 1, 300, 512), 512, 128, 8, 128, "bfloat16"),  # mma, 1 group of 16
    ((9, 200), 256, 40, 4, 64, "bfloat16"),            # mma, 1 group of 10
    ((576,), 4096, 32, 1, 128, "float32"),             # simt, 4 groups of 8
    ((0, 77, 512), 512, 16, 1, 96, "bfloat16"),        # mma, D_p 128
    ((33, 256), 256, 8, 2, 256, "bfloat16"),           # mma, D_p 256
    ((0, 139, 512), 512, 16, 1, 24, "bfloat16"),       # mma, n_rep 16, D 24
    ((1, 300), 512, 34, 2, 8, "bfloat16"),             # mma, groups 16 + 1
    ((40, 17, 64), 64, 12, 1, 24, "float32"))
# the W8A16 product's float32 route: (m, k, n); 4099 x 1005 and 37 x 29
# take its byte loads (N no multiple of 4), 14336 x 4096 its split K
ROUTE_INT8_CASES = ((1, 4096, 4096), (3, 37, 29), (8, 14336, 4096),
                    (13, 1040, 200), (5, 4096 + 3, 1000 + 5))


def _route_counts():
    """Each kernel wrapper's launches by route."""
    from tpuserver_torch.ops import flash as fl
    from tpuserver_torch.ops import quant

    return {"flash_attention": dict(fl.flash_attention.route_launches),
            "decode_attention": dict(fl.decode_attention.route_launches),
            "int8_matmul": dict(quant.int8_matmul.route_launches)}


def _route_launched(kname, route, before, n):
    """Fail unless ``kname`` launched ``n`` times on ``route`` since the
    counts ``before``, and on no other route."""
    after = _route_counts()[kname]
    moved = {r: after[r] - before[kname][r] for r in after}
    if moved != {r: (n if r == route else 0) for r in after}:
        fail("{} launched {} by route (want {} on {})".format(
            kname, moved, n, route))


def _route_of(kname, row):
    """The route the shape of a timed ``row`` takes: its own
    ``kernel_route``, else the one ``tpuserver_torch.ops``' route tables
    give its dtype and head dim (a row without a dtype is bf16); None for
    an attention row that names no head dim."""
    import torch

    from tpuserver_torch.ops import flash as fl
    from tpuserver_torch.ops import quant

    if "kernel_route" in row:
        return row["kernel_route"]
    if kname != "int8_matmul" and "d" not in row:
        return None
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        row.get("dtype", "bfloat16")]
    if kname == "flash_attention":
        return fl.flash_route(dtype, row["d"])
    if kname == "decode_attention":
        return fl.decode_route(dtype, row["d"], row["h"] // row["hkv"])
    return quant.int8_route(dtype)


def _skipped_keys_reference(fl, q, k, v, causal, keys):
    """Flash's plain version with every key at or past ``keys`` dropped
    (the rows before ``keys`` causal as they are)."""
    if not causal:
        return fl.flash_attention_reference(q, k[:, :keys], v[:, :keys],
                                            causal=False)
    import torch

    return torch.cat([
        fl.flash_attention_reference(q[:, :keys], k[:, :keys], v[:, :keys],
                                     causal=True),
        fl.flash_attention_reference(q[:, keys:], k[:, :keys], v[:, :keys],
                                     causal=False)], dim=1)


def phase_route_checks(torch):
    """Phase 3, the routes: every case of ``ROUTE_*_CASES`` through its
    wrapper on the card (two calls the same bits, the route the table
    names launched once a call) against its plain version within ``TOL``
    row-relative, and planted faults the limit must see (the last 32 keys
    dropped or a length shortened by 32; a rolled kv head where there are
    two; the last 32 weight rows zeroed); returns the rows (untimed)."""
    from tpuserver_torch.ops import flash as fl
    from tpuserver_torch.ops import quant

    t0 = time.monotonic()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    rows = []

    def twice(kname, route, fn):
        before = _route_counts()
        out, again = fn(), fn()
        torch.cuda.synchronize()
        _route_launched(kname, route, before, 2)
        if not torch.equal(out, again):
            fail("{} ({}): two calls on the same inputs differ".format(
                kname, route))
        return out

    tensor_cores = {"flash_attention": "wgmma", "decode_attention": "mma"}

    def route_for(kname, dt, route):
        """``route``, which must be the tensor-core one for bf16 and
        "simt" for float32."""
        want = tensor_cores[kname] if dt == "bfloat16" else "simt"
        if route != want:
            fail("{} takes {} on {} (want {})".format(kname, dt, route,
                                                      want))
        return route

    for b, t, h, hkv, d, causal, dt in ROUTE_FLASH_CASES:
        dtype = dtypes[dt]
        q, k, v = (torch.randn(b, t, hh, d, device=dev, generator=gen).to(
            dtype) for hh in (h, hkv, hkv))
        route = route_for("flash_attention", dt, fl.flash_route(dtype, d))
        out = twice("flash_attention", route, lambda: fl.flash_attention(
            q, k, v, causal=causal, block_q=t, block_k=t))
        ref = fl.flash_attention_reference(q, k, v, causal=causal)
        faults = {"skipped_keys": _skipped_keys_reference(
            fl, q, k, v, causal, t - 32)}
        if hkv > 1:
            faults["wrong_kv_head"] = fl.flash_attention_reference(
                q, k.roll(1, dims=2), v.roll(1, dims=2), causal=causal)
        rows.append({"kernel": "flash_attention", "kernel_route": route,
                     "b": b, "t": t, "h": h, "hkv": hkv, "d": d,
                     "causal": causal, "dtype": dt,
                     "max_abs_err": (out.float() - ref.float()).abs().max()
                     .item(), "row_rel_err": row_rel_err(out, ref),
                     "planted_fault_err": {n: row_rel_err(f, ref)
                                           for n, f in faults.items()}})
    for lengths, ss, h, hkv, d, dt in ROUTE_DECODE_CASES:
        dtype = dtypes[dt]
        bb = len(lengths)
        q = torch.randn(bb, h, d, device=dev, generator=gen).to(dtype)
        kc, vc = (torch.randn(bb, ss, hkv, d, device=dev, generator=gen).to(
            dtype) for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        route = route_for("decode_attention", dt,
                          fl.decode_route(dtype, d, h // hkv))
        out = twice("decode_attention", route,
                    lambda: fl.decode_attention(q, kc, vc, lens))
        ref = fl.decode_attention_reference(q, kc, vc, lens)
        n_split = fl.decode_splits(bb, hkv, ss, fl._sm_count(dev))
        split_ref = fl.decode_attention_split_reference(q, kc, vc, lens,
                                                        n_split)
        for i, n in enumerate(lengths):
            if n == 0 and out[i].abs().max().item() != 0.0:
                fail("decode_attention ({}): a length-0 row is not "
                     "zeros".format(route))
        faults = {"shortened": fl.decode_attention_reference(
            q, kc, vc, (lens - 32).clamp_min(0))}
        if hkv > 1:
            faults["wrong_kv_head"] = fl.decode_attention_reference(
                q, kc.roll(1, dims=2), vc.roll(1, dims=2), lens)
        rows.append({"kernel": "decode_attention", "kernel_route": route,
                     "lengths": list(lengths), "s": ss, "h": h, "hkv": hkv,
                     "d": d, "dtype": dt, "n_split": n_split,
                     "max_abs_err": (out.float() - ref.float()).abs().max()
                     .item(), "row_rel_err": max(
                         row_rel_err(out, ref), row_rel_err(out, split_ref)),
                     "planted_fault_err": {n: row_rel_err(f, ref)
                                           for n, f in faults.items()}})
    for m, k, n in ROUTE_INT8_CASES:
        w = torch.randn(k, n, device=dev, generator=gen) / k ** 0.5
        qw = quant.quantize_int8(w)
        x = torch.randn(m, k, device=dev, generator=gen)
        route = quant.int8_route(x.dtype)
        out = twice("int8_matmul", route,
                    lambda: quant.int8_matmul(x, qw["q"], qw["s"]))
        if not torch.equal(out[:1], quant.int8_matmul(x[:1], qw["q"],
                                                      qw["s"])):
            fail("int8_matmul ({}): a row differs from itself computed "
                 "alone".format(route))
        ref = quant.int8_matmul_reference(x, qw["q"], qw["s"])
        cut = qw["q"].clone()
        cut[-32:] = 0
        rows.append({"kernel": "int8_matmul", "kernel_route": route, "m": m,
                     "k": k, "n": n, "dtype": "float32",
                     "max_abs_err": (out - ref).abs().max().item(),
                     "row_rel_err": row_rel_err(out, ref),
                     "planted_fault_err": {"skipped_rows": row_rel_err(
                         quant.int8_matmul_reference(x, cut, qw["s"]),
                         ref)}})
    bad = [r for r in rows if not r["row_rel_err"] <= TOL[r["dtype"]]]
    blind = [r for r in rows if any(not e > TOL[r["dtype"]] for e in
                                    r["planted_fault_err"].values())]
    for row in rows:
        log("route_case:", json.dumps(row))
    torch.cuda.empty_cache()
    routes = sorted({(r["kernel"], r["kernel_route"]) for r in rows})
    log("phase 3 (routes): {} cases, routes {} held in {:.1f} s".format(
        len(rows), ["{}/{}".format(*kr) for kr in routes],
        time.monotonic() - t0))
    if bad:
        fail("routes disagree with their plain versions: {}".format(bad))
    if blind:
        fail("a planted fault passes a route's tolerance: {}".format(blind))
    return rows


def phase_flash_lengths(torch, rows, lengths, timed_as=None):
    """Phase 3, continued: the flash kernel against its plain version at
    every prefill length a later phase ran through it that phase 3 did
    not check (phase 4c's re-admissions and phase 4g's handoff
    re-prefills depend on when a fault hit).  With ``timed_as``, also
    time it at the least of ``lengths`` that tiles, kept under that
    name."""
    import torch.nn.functional as F

    from tpuserver_torch.models import llama
    from tpuserver_torch.ops import flash as fl

    cfg = llama.llama3_8b()
    tiled = sorted(t for t in set(lengths)
                   if None not in llama._flash_blocks(t, cfg))
    new = [t for t in tiled if t not in rows["flash_lengths"]]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    if timed_as is not None and tiled:
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        row = _flash_case(torch, F, fl, dev, gen, 1, tiled[0], 32, 8, 128,
                          True, torch.bfloat16, True, flush)
        del flush
        row["kernel"] = "flash_attention"
        log("kernel_case:", json.dumps(row))
        if not row["row_rel_err"] <= TOL["bfloat16"]:
            fail("flash kernel at prefill length {}: {}".format(tiled[0],
                                                                row))
        rows["timed"][timed_as] = row
    for t in new:
        row = _flash_case(torch, F, fl, dev, gen, 1, t, 32, 8, 128, True,
                          torch.bfloat16, False, None)
        row["kernel"] = "flash_attention"
        log("kernel_case:", json.dumps(row))
        if not row["row_rel_err"] <= TOL["bfloat16"] or any(
                not e > TOL["bfloat16"]
                for e in row["planted_fault_err"].values()):
            fail("flash kernel at prefill length {}: {}".format(t, row))
        rows["max_err"]["flash_attention"] = max(
            rows["max_err"]["flash_attention"], row["max_abs_err"])
        rows["flash_lengths"].add(t)
    log("phase 3 (continued): flash held at later prefill lengths {} "
        "(every length a phase ran through the kernel: {})".format(
            new, sorted(rows["flash_lengths"])))


# -- phase 4: serve ----------------------------------------------------------


def _sse_events(port, body, last_event_id=None, stop_after=None,
                on_event=None):
    """POST one /generate_stream request with the JSON ``body`` (with a
    ``Last-Event-ID`` header when given; the connection closes after
    ``stop_after`` events; ``on_event(n)`` runs after the n-th event).
    Returns (status, events, final marker seen, POST time): each event
    is (its ``id:`` value, its JSON object, arrival time); for a status
    other than 200, the error body instead of the events."""
    import http.client

    headers = {"Content-Type": "application/json"}
    if last_event_id:
        headers["Last-Event-ID"] = last_event_id
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.monotonic()
        conn.request("POST", "/v2/models/llama_generate/generate_stream",
                     json.dumps(body), headers)
        resp = conn.getresponse()
        if resp.status != 200:
            return resp.status, resp.read()[:500], False, t0
        events, final, last_id = [], False, None
        for raw in resp:
            line = raw.decode("utf-8").strip()
            if line.startswith("id: "):
                last_id = line[len("id: "):]
            if not line.startswith("data: "):
                continue
            event = json.loads(line[len("data: "):])
            if event.get("final"):
                final = True
                break
            if "error" in event:
                fail("in-band stream error: {}".format(event["error"]))
            events.append((last_id, event, time.monotonic()))
            if on_event is not None:
                on_event(len(events))
            if len(events) == stop_after:
                break
        return 200, events, final, t0
    finally:
        conn.close()


def _body(prompt, max_tokens, parameters=None):
    return {"inputs": [
        {"name": "PROMPT_IDS", "datatype": "INT32", "shape": [len(prompt)],
         "data": [int(t) for t in prompt]},
        {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
         "data": [max_tokens]}], "parameters": dict(parameters or {})}


def _sse(port, prompt, max_tokens, last_event_id=None, stop_after=None,
         parameters=None):
    """POST one /generate_stream request (``_sse_events``) for ``prompt``;
    each event comes back as (its ``id:`` value, token, logprob, arrival
    time)."""
    status, events, final, t0 = _sse_events(
        port, _body(prompt, max_tokens, parameters), last_event_id,
        stop_after)
    if status != 200:
        return status, events, final, t0
    out = []
    for last_id, event, t in events:
        o = {x["name"]: x["data"] for x in event["outputs"]}
        out.append((last_id, int(o["TOKEN"][0]), float(o["LOGPROB"][0]), t))
    return 200, out, final, t0


def _stream(port, prompt, max_tokens):
    """POST one /generate_stream request; returns (tokens, ttft_s,
    decode tokens/s, saw_final, the events' ``id:`` values)."""
    status, events, final, t0 = _sse(port, prompt, max_tokens)
    if status != 200:
        fail("generate_stream answered {}: {}".format(status, events))
    stamps = [e[3] for e in events]
    ttft = stamps[0] - t0 if stamps else float("nan")
    rate = ((len(stamps) - 1) / (stamps[-1] - stamps[0])
            if len(stamps) > 1 else float("nan"))
    return ([e[1] for e in events], ttft, rate, final,
            [e[0] for e in events if e[0] is not None])


def phase_serve(torch, np):
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.http_server import HttpServer
    from tpuserver_torch.models import llama
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel
    from tpuserver_torch.ops import flash as fl

    cfg = llama.llama3_8b()
    model = LlamaGenerateModel(cfg=cfg, max_seq=4096, seed=SEED,
                               device="cuda")
    t0 = time.monotonic()
    model.warmup()
    torch.cuda.synchronize()
    log("serve: llama3_8b weights ({} layers, d_model {}, vocab {}) drawn "
        "on the card in {:.1f} s".format(cfg.n_layers, cfg.d_model,
                                        cfg.vocab, time.monotonic() - t0))
    core = InferenceServer([model])
    http = HttpServer(core, port=0).start()
    rng = np.random.RandomState(SEED)
    long_prompt = rng.randint(0, cfg.vocab, 512)
    short_prompt = rng.randint(0, cfg.vocab, 77)
    runs, rates = [], []
    try:
        fl.reset_launch_counts()
        for name, prompt, n in (("flash_prefill", long_prompt, 64),
                                ("dense_prefill", short_prompt, 32),
                                ("repeat", long_prompt, 64)):
            tokens, ttft, rate, final, _ = _stream(http.port, prompt, n)
            rates.append(rate)
            log("request {}: prompt {} tokens, {} tokens streamed, ttft "
                "{:.1f} ms, decode {:.1f} tokens/s".format(
                    name, len(prompt), len(tokens), ttft * 1e3, rate))
            if len(tokens) != n or not final:
                fail("request {}: {} events (want {}), final marker {}".format(
                    name, len(tokens), n, final))
            runs.append(tokens)
        torch.cuda.synchronize()
        launches = {"flash_attention": fl.flash_attention.launches,
                    "decode_attention": fl.decode_attention.launches}
    finally:
        http.stop()
    log("serve: kernel launches", json.dumps(launches))
    if runs[2] != runs[0]:
        fail("repeated request gave other tokens")
    if launches["flash_attention"] < cfg.n_layers:
        fail("flash kernel launched {} times (want >= {})".format(
            launches["flash_attention"], cfg.n_layers))
    if launches["decode_attention"] < cfg.n_layers * 95:
        fail("decode kernel launched {} times (want >= {})".format(
            launches["decode_attention"], cfg.n_layers * 95))
    return model, core, long_prompt, launches, runs[0], rates, {
        "long": (long_prompt, runs[0]), "short": (short_prompt, runs[1])}


# -- phase 4b: continuous batching -------------------------------------------


def _batched_round(port, prompts, budgets, order):
    """Send every request in ``order``, 50 ms apart, each on its own
    thread; returns ({index: (tokens, ttft, rate, final, ids)}, wall s)."""
    import threading

    results, errors = {}, []

    def one(i):
        try:
            results[i] = _stream(port, prompts[i], budgets[i])
        except SystemExit as e:  # fail() inside a worker thread
            errors.append(e)

    threads = []
    t0 = time.monotonic()
    for i in order:
        threads.append(threading.Thread(target=one, args=(i,), daemon=True))
        threads[-1].start()
        time.sleep(0.05)
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    if errors or len(results) != len(prompts):
        fail("batched round: {} of {} streams completed".format(
            len(results), len(prompts)))
    return results, wall


def phase_serve_batched(torch, np, model1, long_prompt, single_tokens,
                        single_rates):
    """``llama3_8b`` behind ``LlamaGenerateModel(max_slots=8)`` on phase
    4's weights: 12 concurrent streams over 8 slots (four 512-token
    prompts and four of 256 through the flash kernel, four of 77 dense;
    budgets 24-64, so slots retire at different steps and the last four
    admit mid-flight), then the same 12 in reverse arrival order.  Checks
    gap-free ``seq``, final markers, identical tokens per prompt in both
    rounds and the kernels' launches; then one batched paged step of the
    512-token prompt in slot 3 against the single-stream decode step.
    Returns (launch counts, the batched steps phase 6 profiles, the
    batched state phase 4c starts from, the prompts and budgets, and the
    forward round's tokens by prompt)."""
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.http_server import HttpServer
    from tpuserver_torch.models import llama
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel
    from tpuserver_torch.ops import flash as fl

    cfg = model1._cfg
    params = model1._ensure_params()
    max_seq, slots = 4096, 8
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = LlamaGenerateModel(cfg=cfg, max_seq=max_seq, max_slots=slots,
                               params=params, device="cuda")
    model.warmup()
    if model._ensure_params()["embed"].data_ptr() != \
            params["embed"].data_ptr():
        fail("the batched model copied the weights instead of sharing them")
    core = InferenceServer([model])
    http = HttpServer(core, port=0).start()
    rng = np.random.RandomState(SEED + 1)
    lengths = BATCHED_PROMPT_LENGTHS * 4
    prompts = [rng.randint(0, cfg.vocab, n) for n in lengths]
    prompts[0] = long_prompt  # phase 4's prompt: greedy agreement reported
    budgets = [64, 24, 40, 32, 56, 28, 48, 36, 44, 24, 60, 32]
    tileable = len(_flash_admissions(llama, cfg, max_seq, lengths))
    rounds = []
    try:
        fl.reset_launch_counts()
        steps0 = model.scheduler_stats()["steps"]
        for name, order in (("forward", range(12)),
                            ("reverse", range(11, -1, -1))):
            results, wall = _batched_round(http.port, prompts, budgets,
                                           list(order))
            total = 0
            for i in order:
                tokens, ttft, rate, final, ids = results[i]
                total += len(tokens)
                seqs = [int(x.rsplit("/", 1)[1]) for x in ids]
                log("batched {} request {}: prompt {} tokens, {} tokens "
                    "streamed, ttft {:.1f} ms, decode {:.1f} tokens/s, "
                    "final {}, seq 0..{} gap-free {}".format(
                        name, i, len(prompts[i]), len(tokens), ttft * 1e3,
                        rate, final, len(seqs) - 1,
                        seqs == list(range(len(tokens)))))
                if len(tokens) != budgets[i] or not final:
                    fail("batched request {}: {} events (want {}), final "
                         "marker {}".format(i, len(tokens), budgets[i],
                                            final))
                if seqs != list(range(len(tokens))) or len({
                        x.rsplit("/", 1)[0] for x in ids}) != 1:
                    fail("batched request {}: id lines {}".format(i, ids))
            log("batched {} round: {} tokens in {:.3f} s, aggregate {:.1f} "
                "tokens/s against single-stream decode rates {}".format(
                    name, total, wall, total / wall,
                    ["{:.1f}".format(r) for r in single_rates]))
            rounds.append({i: results[i][0] for i in order})
        torch.cuda.synchronize()
        steps = model.scheduler_stats()["steps"] - steps0
        launches = {"flash_attention": fl.flash_attention.launches,
                    "decode_attention": fl.decode_attention.launches}
        stats = model.scheduler_stats()
    finally:
        http.stop()
        core.close()
    log("serve_batched: kernel launches", json.dumps(launches),
        "batched steps", steps, "tileable admissions", 2 * tileable,
        "scheduler", json.dumps(stats))
    same = [rounds[0][i] == rounds[1][i] for i in range(12)]
    agree = sum(a == b for a, b in zip(rounds[0][0], single_tokens))
    log("serve_batched: rows identical across arrival orders: {}/12; "
        "greedy agreement of the 512-token prompt with the single-stream "
        "path: {}/{} tokens (reported, not required)".format(
            sum(same), agree, len(single_tokens)))
    if not all(same):
        fail("a prompt streamed other tokens in reverse arrival order: "
             "{}".format([i for i, ok in enumerate(same) if not ok]))
    if launches["decode_attention"] < cfg.n_layers * steps:
        fail("decode kernel launched {} times (want >= {})".format(
            launches["decode_attention"], cfg.n_layers * steps))
    if launches["flash_attention"] < cfg.n_layers * 2 * tileable:
        fail("flash kernel launched {} times (want >= {})".format(
            launches["flash_attention"], cfg.n_layers * 2 * tileable))
    if stats["live_streams"] != 0 or (
            stats["pages_free"] != stats["pages_total"]):
        fail("the batched run leaked slots or pages: {}".format(stats))

    # one batched step of the 512-token prompt in slot 3 (every other row
    # inert) against the single-stream decode step at the same position
    fns = llama.make_scheduler_fns(cfg, max_seq, slots, device="cuda")
    ppseq, n_pages = fns["pages_per_seq"], fns["n_pages"]
    n = len(long_prompt)
    tokens_in = torch.tensor(long_prompt, dtype=torch.long,
                             device="cuda")[None, :]
    with torch.inference_mode():
        cache = llama.init_kv_cache(cfg, 1, max_seq, "cuda")
        logits1, cache = llama.prefill(params, cache, tokens_in, cfg)
        pages, logits_all = fns["init_cache"](), fns["init_logits"]()
        slot_logits, slot_cache = fns["prefill"](
            params, fns["init_slot_cache"](), long_prompt[None, :], n)
        tables = np.full((slots, ppseq), n_pages, np.int32)
        tables[3] = np.arange(3 * ppseq, 4 * ppseq)
        pages, logits_all = fns["admit"](pages, logits_all, slot_cache,
                                         slot_logits, tables[3], 3)
        del slot_cache
        positions = np.full((slots,), max_seq, np.int32)
        active = np.zeros((slots,), bool)
        active[3] = True
        no_force = np.zeros((slots,), np.int32)
        single, batched = [], []
        for step in range(16):
            tok = torch.argmax(logits1, dim=-1)
            single.append(int(tok[0]))
            logits1, cache = llama.decode_step(params, cache, tok, n + step,
                                               cfg)
            positions[3] = n + step
            toks, _, logits_all, pages = fns["step"](
                params, pages, logits_all, tables, positions, active,
                no_force, no_force.astype(bool))
            batched.append(int(np.asarray(toks)[3]))
            if step == 0:
                if not (torch.isfinite(logits_all[3]).all()
                        and logits_all.shape == (slots, cfg.vocab)):
                    fail("batched-step logits not finite or of the wrong "
                         "shape")
                err = (logits_all[3] - logits1[0]).abs().max().item()
                inert = logits_all[[0, 1, 2, 4, 5, 6, 7]].abs().max().item()
        del cache
        # the state phase 6 profiles: 8 live rows near length 600 over
        # random K/V (a step's cost does not depend on the values)
        pages.normal_(generator=torch.Generator(device="cuda").manual_seed(
            SEED))
    agree16 = sum(a == b for a, b in zip(single, batched))
    log("serve_batched: slot-3 batched-step logits max |batched - single| "
        "= {:.4g} (tolerance {}); inert rows' logits stay {}; first 16 "
        "greedy tokens agree: {}/16".format(err, LOGITS_TOL, inert,
                                            agree16))
    if not err <= LOGITS_TOL:
        fail("batched-step logits differ from the single-stream step by "
             "{}".format(err))
    if inert != 0.0:
        fail("an inert row's logits moved")

    state = {"pages": pages, "logits": logits_all}
    steps, prof_tables, prof_pos = _profiled_steps(np, fns, params, state)
    torch.cuda.synchronize()
    log("serve_batched: peak device memory {:.3f} GiB (weights, phase 4's "
        "model and this phase)".format(
            torch.cuda.max_memory_allocated() / 2 ** 30))
    return launches, steps, {
        "fns": fns, "state": state, "tables": prof_tables,
        "positions": prof_pos}, prompts, budgets, rounds[0]


def _profiled_steps(np, fns, params, state):
    """Phase 6's batched steps on ``state`` (``pages`` and ``logits`` of
    ``fns``'s pool, updated by each step): 8 live rows at lengths
    ``BATCHED_LENGTHS``, one step fetched, and four in the scheduler's
    one-deep pipeline.  Returns (the two functions, the page tables, the
    positions)."""
    slots, ppseq = len(BATCHED_LENGTHS), fns["pages_per_seq"]
    tables = np.arange(slots * ppseq, dtype=np.int32).reshape(slots, ppseq)
    positions = np.array(BATCHED_LENGTHS, np.int32) - 1
    active = np.ones((slots,), bool)
    no_force = np.zeros((slots,), np.int32)

    def dispatch():
        toks, lps, state["logits"], state["pages"] = fns["step"](
            params, state["pages"], state["logits"], tables, positions,
            active, no_force, no_force.astype(bool))
        return toks, lps

    def batched_step():
        toks, lps = dispatch()
        return np.asarray(toks), np.asarray(lps)

    def pipelined_steps(n=4):
        # the scheduler's one-deep pipeline: step i+1 is dispatched
        # before step i's tokens are fetched
        inflight = dispatch()
        for _ in range(n - 1):
            current = dispatch()
            np.asarray(inflight[0]), np.asarray(inflight[1])
            inflight = current
        return np.asarray(inflight[0]), np.asarray(inflight[1])

    return {"batched_step_8": batched_step,
            "batched_steps_8_x4_pipelined": pipelined_steps}, tables, \
        positions


# -- phase 4c: speculative verify, self-healing, resume -----------------------


def phase_spec_step(torch, np, cfg, params, batched):
    """(a) One ``spec_step`` (K = 4) against five plain ``step``s from the
    same state: 8 rows at lengths 551-600 (phase 6's state).  Rows 0-3
    draft the plain chain's own continuation (accept 4), rows 4-5 the
    same wrong at index 1 (accept 1), rows 6-7 nothing (accept 0).
    Tokens, logprobs and the selected logits must equal the plain
    chain's at each row's depth bit for bit, and rows 0-3's gathered
    pages the chain's pages.  Returns the functions phase 6 profiles: one
    ``spec_step`` and the five plain steps it stands for, each fetched,
    on phase 6's state."""
    from tpuserver_torch.ops import flash as fl

    fns, state = batched["fns"], batched["state"]
    tables, pos0 = batched["tables"], batched["positions"]
    slots, k = len(pos0), SPEC_K
    active = np.ones((slots,), bool)
    no_force = np.zeros((slots,), np.int32)
    with torch.inference_mode():
        pages, logits, chain = state["pages"].clone(), state[
            "logits"].clone(), []
        for j in range(k + 1):
            toks, lps, logits, pages = fns["step"](
                params, pages, logits, tables, pos0 + j, active, no_force,
                no_force.astype(bool))
            chain.append((np.asarray(toks), np.asarray(lps),
                          logits.clone()))
        ref = np.stack([c[0] for c in chain])  # [k+1, slots]
        draft = np.ascontiguousarray(ref[1:].T).astype(np.int32)
        draft[4:6, 1] = (draft[4:6, 1] + 1) % cfg.vocab
        draft_len = np.array([k] * 6 + [0] * 2, np.int32)
        spec_pages = state["pages"].clone()
        torch.cuda.synchronize()
        before = fl.decode_attention.launches
        toks, lps, acc, final, spec_pages = fns["spec_step"](
            params, spec_pages, state["logits"].clone(), tables, pos0,
            active, no_force, no_force.astype(bool), draft, draft_len)
        toks, lps, acc = np.asarray(toks), np.asarray(lps), np.asarray(acc)
        torch.cuda.synchronize()
        launches = fl.decode_attention.launches - before
        want = [k] * 4 + [1] * 2 + [0] * 2
        bad = []
        if acc.tolist() != want:
            bad.append("accept {} (want {})".format(acc.tolist(), want))
        for i, depth in enumerate(acc.tolist()):
            for j in range(depth + 1):
                if toks[i, j] != chain[j][0][i] or lps[i, j] != chain[j][1][i]:
                    bad.append("row {} token/logprob {}".format(i, j))
            if not torch.equal(final[i], chain[depth][2][i]):
                bad.append("row {} logits at depth {}".format(i, depth))
        for i in range(4):
            if not torch.equal(fns["gather"](spec_pages, tables[i]),
                               fns["gather"](pages, tables[i])):
                bad.append("row {} gathered pages".format(i))
        del pages, spec_pages, chain
    torch.cuda.empty_cache()
    log("spec_step (a): accept {} (want {}), decode launches {} (want >= "
        "{})".format(acc.tolist(), want, launches, cfg.n_layers * (k + 1)))
    if bad:
        fail("spec_step differs from the plain chain: {}".format(bad))
    if launches < cfg.n_layers * (k + 1):
        fail("spec_step launched the decode kernel {} times".format(
            launches))

    def spec_step():
        out = fns["spec_step"](params, state["pages"], state["logits"],
                               tables, pos0, active, no_force,
                               no_force.astype(bool), draft, draft_len)
        return [np.asarray(t) for t in out[:3]]

    def plain_steps():
        # what the verify stands for: k + 1 plain steps, fetched at the end
        logits = state["logits"]
        for j in range(k + 1):
            toks, lps, logits, _ = fns["step"](
                params, state["pages"], logits, tables, pos0 + j, active,
                no_force, no_force.astype(bool))
        return np.asarray(toks), np.asarray(lps)

    return {"spec_step_8_k4": spec_step, "plain_steps_8_x5": plain_steps}


def _serving(cfg, params, **kwargs):
    """A max_slots=8 ``LlamaGenerateModel`` on the shared weights, its
    core and HTTP server (started)."""
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.http_server import HttpServer
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel

    model = LlamaGenerateModel(cfg=cfg, max_seq=4096, max_slots=8,
                               params=params, device="cuda", **kwargs)
    core = InferenceServer([model])
    return model, core, HttpServer(core, port=0).start()


def phase_serve_spec(torch, np, cfg, params, prompts, budgets):
    """(b) Phase 4b's 12 prompts and 4 repetitive 512-token prompts (a
    32-token pattern, tiled) through ``spec_tokens=0`` and then
    ``spec_tokens=4``: each prompt's tokens must be the same.  Returns the
    spec round's launch counts."""
    from tpuserver_torch.ops import flash as fl

    prompts = list(prompts) + _repetitive_prompts(np, cfg.vocab, 4)
    budgets = [max(16, b // 2) for b in budgets] + [32] * 4
    rounds = {}
    for spec in (0, SPEC_K):
        model, core, http = _serving(cfg, params, spec_tokens=spec)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fl.reset_launch_counts()
            results, wall = _batched_round(http.port, prompts, budgets,
                                           range(len(prompts)))
            torch.cuda.synchronize()
            launches = {"flash_attention": fl.flash_attention.launches,
                        "decode_attention": fl.decode_attention.launches}
            stats = model.scheduler_stats()
        finally:
            http.stop()
            core.close()
        total = sum(len(r[0]) for r in results.values())
        log("serve_spec (b) spec_tokens={}: {} tokens in {:.3f} s, aggregate "
            "{:.1f} tokens/s; launches {}; peak device memory {:.3f} GiB; "
            "scheduler {}".format(
                spec, total, wall, total / wall, json.dumps(launches),
                torch.cuda.max_memory_allocated() / 2 ** 30,
                json.dumps(stats)))
        for i, r in results.items():
            if len(r[0]) != budgets[i] or not r[3] or [
                    int(x.rsplit("/", 1)[1]) for x in r[4]] != list(
                        range(budgets[i])):
                fail("serve_spec request {}: {} tokens, final {}, ids "
                     "{}".format(i, len(r[0]), r[3], r[4]))
        rounds[spec] = (results, launches, stats)
    same = [rounds[0][0][i][0] == rounds[SPEC_K][0][i][0]
            for i in range(len(prompts))]
    launches, stats = rounds[SPEC_K][1], rounds[SPEC_K][2]
    log("serve_spec (b): prompts identical between spec_tokens=0 and {}: "
        "{}/{}".format(SPEC_K, sum(same), len(same)))
    if not all(same):
        fail("spec_tokens={} streamed other tokens than spec_tokens=0 for "
             "prompts {}".format(SPEC_K, [i for i, ok in enumerate(same)
                                          if not ok]))
    if stats["spec_proposed"] == 0:
        fail("no stream drafted in the spec round")
    if launches["decode_attention"] < cfg.n_layers * stats["steps"]:
        fail("decode kernel launched {} times in the spec round (want >= "
             "{})".format(launches["decode_attention"],
                          cfg.n_layers * stats["steps"]))
    return launches


def _decode_threads():
    import threading

    return sum(t.name == "decode-scheduler" and t.is_alive()
               for t in threading.enumerate())


def _repetitive_prompts(np, vocab, n):
    """``n`` 512-token prompts, each a random 32-token pattern tiled: the
    self-context drafter proposes their continuation."""
    rng = np.random.RandomState(SEED + 3)
    return [np.tile(rng.randint(0, vocab, 32), 16) for _ in range(n)]


def phase_heal(torch, np, cfg, params, readmits):
    """(c) Self-healing and (d) resume over HTTP, on ``max_slots=8`` models
    built with ``step_timeout_s=STEP_TIMEOUT_S``, as ``serve.py
    --step-timeout-s`` builds them, whose ``fns["step"]``/
    ``fns["spec_step"]`` are wrapped here: armed, the wrapper runs a fault
    once, on the first call of its kind where a live row has reached the
    armed position.  Two rounds fault the plain step (a raise, then a host
    stall); a third, on a ``spec_tokens=SPEC_K`` model with repetitive
    prompts, stalls the speculative verify.  Each follows an undisturbed
    round of its model, which is the reference and the warm-up that arms
    the watchdog.  Every admission prefill's length is recorded into
    ``readmits``.  Returns the launch counts of the fault rounds and
    (d)."""
    from tpuserver_torch.ops import flash as fl

    def _key(prompt):
        return tuple(int(t) for t in prompt[:4])

    fault = {"at": None, "kind": None, "action": None, "history": {},
             "fired": 0, "fired_at": None}
    models = {}

    def heal_model(**kwargs):
        model, core, http = _serving(cfg, params,
                                     step_timeout_s=STEP_TIMEOUT_S, **kwargs)
        fns = dict(model._fns)

        def wrap(kind, real):
            def wrapped(params_, pages, logits, tables, positions, *rest):
                live = positions[positions < 4096]  # not the sentinel
                if fault["at"] is not None and fault["kind"] == kind and \
                        len(live) and live.max() >= fault["at"]:
                    fault["at"] = None
                    sched = model._scheduler
                    with sched._cond:  # what each stream had emitted
                        fault["history"] = {_key(st.prompt): len(st.history)
                                            for st in sched._streams}
                    fault["fired"] += 1
                    fault["fired_at"] = time.monotonic()
                    fault["action"]()
                return real(params_, pages, logits, tables, positions, *rest)
            return wrapped

        for kind in ("step", "spec_step"):
            fns[kind] = wrap(kind, fns[kind])
        real_prefill = fns["prefill"]

        def prefill(params_, slot_cache, tokens, true_len):
            readmits.append(int(np.asarray(tokens).shape[1]))
            return real_prefill(params_, slot_cache, tokens, true_len)

        fns["prefill"] = prefill
        model._fns = fns  # before the first request builds the scheduler
        models[id(model)] = (model, core, http)
        return model, core, http

    def launches_now():
        torch.cuda.synchronize()
        return {"flash_attention": fl.flash_attention.launches,
                "decode_attention": fl.decode_attention.launches}

    def fault_round(model, port, prompts, budgets, ref, name, kind, at,
                    action, readmit_length=None):
        """One round of 8 concurrent streams in which the wrapped ``kind``
        call runs ``action`` once; returns its launch counts."""
        sched = model._scheduler
        order = range(len(prompts))
        restarts = sched.stats()["restarts"]
        first = len(readmits)
        before = launches_now()
        fault.update(at=at, kind=kind, action=action, fired=0)
        got, wall = _batched_round(port, prompts, budgets, order)
        counts = {k: v - before[k] for k, v in launches_now().items()}
        stats = sched.stats()
        lengths = readmits[first:]
        before_ok, after_agree, after_total = True, 0, 0
        for i in order:
            h = fault["history"].get(_key(prompts[i]), 0)
            toks, ref_toks = got[i][0], ref[i][0]
            before_ok &= toks[:h] == ref_toks[:h]
            after_agree += sum(a == b for a, b in zip(toks[h:],
                                                      ref_toks[h:]))
            after_total += len(ref_toks) - h
            seqs = [int(x.rsplit("/", 1)[1]) for x in got[i][4]]
            if len(toks) != budgets[i] or not got[i][3] or \
                    seqs != list(range(budgets[i])):
                fail("heal {} request {}: {} tokens, final {}, seqs "
                     "{}".format(name, i, len(toks), got[i][3], seqs))
        log("heal (c) {}: fired {}, restarts {} -> {}, healthy {}, round "
            "{:.3f} s; histories at the fault {}; admission prefill lengths "
            "{}; tokens before the fault equal the undisturbed round's: {}; "
            "after it {}/{} agree (reported); spec steps {}; peak device "
            "memory {:.3f} GiB".format(
                name, fault["fired"], restarts, stats["restarts"],
                stats["healthy"], wall, sorted(fault["history"].values()),
                lengths, before_ok, after_agree, after_total,
                stats["spec_steps"],
                torch.cuda.max_memory_allocated() / 2 ** 30))
        if fault["fired"] != 1 or stats["restarts"] != restarts + 1 or \
                not stats["healthy"] or not before_ok:
            fail("heal {}: fired {}, restarts {} -> {}, healthy {}, tokens "
                 "before the fault equal {}".format(
                     name, fault["fired"], restarts, stats["restarts"],
                     stats["healthy"], before_ok))
        if readmit_length is not None and readmit_length not in lengths:
            fail("heal {}: no re-admission at {} tokens".format(
                name, readmit_length))
        if action is not raise_once:
            # the demoted thread wakes when its stall ends and exits
            # without delivering
            time.sleep(max(0.0, fault["fired_at"] + HANG_S + 1.0
                           - time.monotonic()))
            threads = _decode_threads()
            log("heal (c) {}: decode threads alive after the stall ended: "
                "{}; tokens {}".format(name, threads,
                                       sched.stats()["tokens"]))
            if threads != 1:
                fail("{} decode threads alive after the stall".format(
                    threads))
        return counts

    def raise_once():
        raise RuntimeError("injected step fault (chip_smoke phase 4c)")

    def stall():
        time.sleep(HANG_S)

    def add(total, counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    rng = np.random.RandomState(SEED + 4)
    prompts = [rng.randint(0, cfg.vocab, n) for n in HEAL_PROMPT_LENGTHS]
    budgets = [HEAL_BUDGET] * len(prompts)
    launches = {}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model, core, http = heal_model()
        ref, _ = _batched_round(http.port, prompts, budgets,
                                range(len(prompts)))
        for name, action in (("raise", raise_once), ("hang", stall)):
            add(launches, fault_round(model, http.port, prompts, budgets,
                                      ref, name, "step", HEAL_TRIGGER_POS,
                                      action, READMIT_LENGTH))
        before = launches_now()
        restarts = model._scheduler.stats()["restarts"]
        phase_resume(np, http.port, rng, cfg)
        add(launches, {k: v - before[k] for k, v in launches_now().items()})
        if model._scheduler.stats()["restarts"] != restarts:
            fail("resume (d): the watchdog restarted an undisturbed loop")
        log("heal (c)+(d) plain: scheduler {}; peak device memory {:.3f} "
            "GiB".format(json.dumps(model._scheduler.stats()),
                         torch.cuda.max_memory_allocated() / 2 ** 30))
        del models[id(model)]
        http.stop()
        core.close()
        # the speculative branch: its own heartbeat, same-iteration fetch
        # and epoch check, faulted in the verify
        spec_prompts = _repetitive_prompts(np, cfg.vocab, 8)
        spec_budgets = [SPEC_HEAL_BUDGET] * len(spec_prompts)
        model, core, http = heal_model(spec_tokens=SPEC_K)
        ref, _ = _batched_round(http.port, spec_prompts, spec_budgets,
                                range(len(spec_prompts)))
        if model._scheduler.stats()["spec_steps"] == 0:
            fail("heal spec: the undisturbed round ran no spec_step")
        add(launches, fault_round(model, http.port, spec_prompts,
                                  spec_budgets, ref, "spec hang",
                                  "spec_step", SPEC_HEAL_TRIGGER_POS, stall))
        log("heal (c)+(d): kernel launches in the fault rounds and (d) {}; "
            "spec scheduler {}; peak device memory {:.3f} GiB".format(
                json.dumps(launches), json.dumps(model._scheduler.stats()),
                torch.cuda.max_memory_allocated() / 2 ** 30))
    finally:
        for model, core, http in models.values():
            http.stop()
            core.close()
    return launches


def phase_resume(np, port, rng, cfg):
    """(d) A ``/generate_stream`` client drops after 5 events and
    reconnects with ``Last-Event-ID`` naming the third: the events it
    gets again must equal the first connection's and the ``id:`` seqs
    run gap-free; a completed tail replays twice; an unknown id is a
    404."""
    prompt, n = rng.randint(0, cfg.vocab, 300), HEAL_BUDGET
    status, whole, final, _ = _sse(port, prompt, n)
    if status != 200 or len(whole) != n or not final:
        fail("resume (d): the undisturbed stream: {} {}".format(status,
                                                                 whole))
    status, first, _, _ = _sse(port, prompt, n, stop_after=5)
    gen_id = first[0][0].rsplit("/", 1)[0]
    status2, second, final, _ = _sse(port, prompt, n,
                                     last_event_id=first[2][0])
    if status != 200 or status2 != 200 or not final:
        fail("resume (d): statuses {} {}: {}".format(status, status2,
                                                     second))
    joined = first[:3] + second
    seqs = [int(e[0].rsplit("/", 1)[1]) for e in joined]
    replayed = [e[:3] for e in second[:2]] == [e[:3] for e in first[3:5]]
    agree = sum(a[1] == b[1] for a, b in zip(joined, whole))
    tails = [_sse(port, prompt, n, last_event_id="{}/{}".format(
        gen_id, n - 5)) for _ in range(2)]
    unknown = _sse(port, prompt, n, last_event_id="no-such-generation/3")
    log("resume (d): seqs 0..{} gap-free {}; events replayed equal the "
        "first connection's: {}; tokens agreeing with the undisturbed "
        "stream: {}/{} (reported); completed tail replays {}; unknown id "
        "answered {}".format(
            len(seqs) - 1, seqs == list(range(n)), replayed, agree, n,
            [(t[0], len(t[1])) for t in tails], unknown[0]))
    if seqs != list(range(n)) or not replayed or {
            e[0] for e in joined} != {"{}/{}".format(gen_id, i)
                                      for i in range(n)}:
        fail("resume (d): seqs {}, replayed equal {}".format(seqs,
                                                             replayed))
    for status, tail, final, _ in tails:
        if status != 200 or not final or [e[:3] for e in tail] != [
                e[:3] for e in joined[n - 4:]]:
            fail("resume (d): completed tail replay {} {}".format(status,
                                                                 tail))
    if unknown[0] != 404:
        fail("resume (d): an unknown id answered {}".format(unknown[0]))


# -- phase 4e: the shared-memory data plane ----------------------------------


def _child(mode):
    """This script in a child process (``--child-region`` or
    ``--child-server``), driven over its stdin and stdout."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, bufsize=1)


def _child_line(proc, prefix):
    """The child's next stdout line that starts with ``prefix`` (earlier
    lines are its log), without the prefix; fails if the child ends."""
    while True:
        line = proc.stdout.readline()
        if not line:
            fail("child {} ended (exit {}) before printing {}".format(
                proc.args[-1], proc.wait(timeout=60), prefix))
        if line.startswith(prefix):
            return line[len(prefix):].strip()
        log("  child:", line.rstrip())


def _ask(proc, command, prefix):
    proc.stdin.write(command + "\n")
    proc.stdin.flush()
    return _child_line(proc, prefix)


def _stop_child(proc):
    """Ask the child to quit; kill it if it does not within a minute."""
    if proc.poll() is None:
        try:
            proc.stdin.write("quit\n")
            proc.stdin.flush()
            proc.wait(timeout=60)
        except (BrokenPipeError, subprocess.TimeoutExpired):
            proc.kill()
            proc.wait(timeout=60)


def child_region(np):
    """``--child-region``: a client process.  It makes a CUDA region of
    ``CHILD_REGION_BYTES`` with the port's module, writes the prompt it
    reads on stdin at offset 0, prints the raw handle, and on ``read N``
    prints the ring's N slots (at ``CHILD_RING_OFF``) and whether each
    one's seq word (at ``CHILD_SEQ_OFF``) commits it, read from device
    memory."""
    from tpuserver_torch import cuda_shared_memory as csm
    from tpuserver_torch import shm_ring

    prompt = np.asarray(json.loads(sys.stdin.readline()), np.int32)
    h = csm.create_shared_memory_region("child", CHILD_REGION_BYTES)
    try:
        csm.set_shared_memory_region(h, [prompt])
        print("HANDLE", csm.get_raw_handle(h).decode(), flush=True)
        for line in sys.stdin:
            cmd = line.split()
            if cmd[0] == "quit":
                break
            n = int(cmd[1])
            ring = csm.get_contents_as_numpy(h, "INT32", [n, 2],
                                             CHILD_RING_OFF)
            words = csm.get_contents_as_numpy(h, "INT32", [n],
                                              CHILD_SEQ_OFF)
            print("RING", json.dumps({
                "tokens": ring[:, 0].tolist(),
                "logprobs": np.ascontiguousarray(ring[:, 1]).view(
                    np.float32).tolist(),
                "committed": [shm_ring.slot_committed(
                    int(w) & 0xFFFFFFFF, s) for s, w in enumerate(words)]}),
                flush=True)
    finally:
        csm.destroy_shared_memory_region(h)


def child_server(torch):
    """``--child-server``: server B of the two-server handoff, the port's
    server on ``llama3_8b`` with the same seed, so the same weights, as
    phase 4's model.  Prints its port; ``reset`` zeroes its kernel
    counts, ``counts`` prints them with its scheduler's and data plane's
    counts and its peak memory."""
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.http_server import HttpServer
    from tpuserver_torch.models import llama
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel
    from tpuserver_torch.ops import flash as fl

    model = LlamaGenerateModel(cfg=llama.llama3_8b(), max_seq=4096,
                               max_slots=8, seed=SEED, device="cuda")
    model.warmup()
    core = InferenceServer([model])
    http = HttpServer(core, port=0).start()
    print("PORT", http.port, flush=True)
    try:
        for line in sys.stdin:
            cmd = line.strip()
            if cmd == "quit":
                break
            torch.cuda.synchronize()
            if cmd == "reset":
                fl.reset_launch_counts()
                print("OK", flush=True)
            elif cmd == "counts":
                print("COUNTS", json.dumps({
                    "flash_attention": fl.flash_attention.launches,
                    "decode_attention": fl.decode_attention.launches,
                    "scheduler": model.scheduler_stats(),
                    "shm": core.shm_stats(),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}),
                    flush=True)
    finally:
        http.stop()
        core.close()


def _http_json(port, method, path, body=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _register(port, name, handle_b64, byte_size):
    status, body = _http_json(
        port, "POST", "/v2/cudasharedmemory/region/{}/register".format(name),
        {"raw_handle": {"b64": handle_b64}, "device_id": 0,
         "byte_size": byte_size})
    if status != 200:
        fail("registering CUDA region {}: {} {}".format(name, status, body))


def _unregister(port, name):
    return _http_json(
        port, "POST",
        "/v2/cudasharedmemory/region/{}/unregister".format(name))[0]


def _shm_ref(name, offset, n):
    return {"name": "PROMPT_IDS", "datatype": "INT32", "shape": [n],
            "parameters": {"shared_memory_region": name,
                           "shared_memory_byte_size": 4 * n,
                           "shared_memory_offset": offset}}


def _memory(torch, csm):
    """(torch's peak GiB, GiB of live CUDA regions, GiB the whole card
    has in use) — regions come from cudaMalloc, outside torch's count."""
    free, total = torch.cuda.mem_get_info()
    regions = sum(h.byte_size for h in csm.allocated_shared_memory_regions())
    return (torch.cuda.max_memory_allocated() / 2 ** 30, regions / 2 ** 30,
            (total - free) / 2 ** 30)


def phase_shm(torch, np, cfg, params, prompts, budgets, tokens_4b):
    """(a) 4b's 12 prompts from a CUDA region, tokens into rings in it;
    (b) a child process's region: prompt, seq-guarded ring, 409/200
    unregister; (c) 8 ``kv_park`` streams dropped and resumed over their
    exports; (d) the two-server handoff over CUDA IPC.  Returns the
    launch counts of (a)+(b), of (c)'s resumes and of (d)'s decode leg on
    server B."""
    from tpuserver_torch import cuda_shared_memory as csm
    from tpuserver_torch.ops import flash as fl

    torch.cuda.empty_cache()  # server B and the exports need the card
    server_b = _child("--child-server")  # loads while (a)-(c) run
    model, core, http = _serving(cfg, params)
    out = {}
    try:
        model.warmup()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out["shm_plane"] = _shm_in_process(torch, np, fl, csm, model, core,
                                           http.port, prompts, budgets,
                                           tokens_4b)
        add = _shm_cross_process(torch, np, fl, http.port, prompts[0],
                                 tokens_4b[0])
        for k, v in add.items():
            out["shm_plane"][k] += v
        out["kv_attach"] = _park_attach(torch, np, fl, csm, cfg, model,
                                        core, http.port)
        out["kv_handoff"] = _handoff(torch, fl, server_b, core, http.port,
                                     prompts[0], tokens_4b[0])
        log("shm (a)-(d): server A data plane {}; scheduler {}".format(
            json.dumps(core.shm_stats()),
            json.dumps(model.scheduler_stats())))
    finally:
        _stop_child(server_b)
        http.stop()
        core.close()
    return out


def _shm_in_process(torch, np, fl, csm, model, core, port, prompts, budgets,
                    tokens_4b):
    """(a) one CUDA region holds 4b's 12 prompts and a ring per prompt;
    12 concurrent requests take their prompt by reference and deliver
    into their ring; the ring tokens must equal 4b's in-band tokens."""
    import threading

    p_off, r_off, off = [], [], 0
    for p in prompts:
        p_off.append(off)
        off += 4 * len(p)
    for b in budgets:
        r_off.append(off)
        off += 8 * b
    h = csm.create_shared_memory_region("plane4e", off)
    csm.set_shared_memory_region(h, [np.asarray(p, np.int32)
                                     for p in prompts])
    _register(port, "plane4e", csm.get_raw_handle(h).decode(), off)
    view = core.read_shm_input("plane4e", 4 * len(prompts[1]), p_off[1],
                               "INT32", [len(prompts[1])])
    base = h.tensor.data_ptr()
    inside = base <= view.data_ptr() < base + off and \
        view.data_ptr() == base + p_off[1]
    results, errors = {}, []

    def one(i):
        try:
            body = {"inputs": [
                _shm_ref("plane4e", p_off[i], len(prompts[i])),
                {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
                 "data": [budgets[i]]}], "parameters": {
                "shm_ring_region": "plane4e",
                "shm_ring_slots": budgets[i], "shm_ring_offset": r_off[i]}}
            results[i] = _sse_events(port, body)
        except SystemExit as e:
            errors.append(e)

    torch.cuda.synchronize()
    fl.reset_launch_counts()
    steps0 = model.scheduler_stats()["steps"]
    t0 = time.monotonic()
    threads = []
    for i in range(len(prompts)):
        threads.append(threading.Thread(target=one, args=(i,), daemon=True))
        threads[-1].start()
        time.sleep(0.05)
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    torch.cuda.synchronize()
    counts = {"flash_attention": fl.flash_attention.launches,
              "decode_attention": fl.decode_attention.launches}
    steps = model.scheduler_stats()["steps"] - steps0
    if errors or len(results) != len(prompts):
        fail("shm (a): {} of {} streams completed".format(len(results),
                                                          len(prompts)))
    same, descriptor_only = [], True
    for i in range(len(prompts)):
        status, events, final, _ = results[i]
        offs = [e[1]["parameters"]["shm_ring_offset"] for e in events]
        descriptor_only &= all(e[1]["outputs"] == [] for e in events)
        ring = csm.get_contents_as_numpy(h, "INT32", [budgets[i], 2],
                                         r_off[i])[:, 0].tolist()
        seqs = [e[1]["parameters"]["seq"] for e in events]
        same.append(ring == tokens_4b[i])
        if status != 200 or not final or seqs != list(range(budgets[i])) \
                or offs != [r_off[i] + 8 * s for s in seqs]:
            fail("shm (a) request {}: status {}, final {}, seqs {}, "
                 "offsets {}".format(i, status, final, seqs, offs))
    unreg = _unregister(port, "plane4e")
    total = sum(budgets)
    log("shm (a): 12 streams, prompts by reference from one CUDA region, "
        "tokens into its rings: {} tokens in {:.3f} s ({:.1f} tokens/s); "
        "ring tokens equal 4b's in-band tokens: {}/12; events carry only "
        "descriptors: {}; the prompt view lies in the region at its offset: "
        "{}; launches {} over {} batched steps; unregister after {}".format(
            total, wall, total / wall, sum(same), descriptor_only, inside,
            json.dumps(counts), steps, unreg))
    csm.destroy_shared_memory_region(h)
    if not all(same) or not descriptor_only or not inside or unreg != 200:
        fail("shm (a): rings equal {}, descriptor-only {}, view inside {}, "
             "unregister {}".format(same, descriptor_only, inside, unreg))
    if counts["decode_attention"] < 32 * steps or \
            counts["flash_attention"] < 32:
        fail("shm (a): launches {} over {} steps".format(counts, steps))
    return counts


def _shm_cross_process(torch, np, fl, port, prompt, tokens):
    """(b) a child process's CUDA region: the 512-token prompt by
    reference, 64 tokens into a seq-guarded ring in it, read back by the
    child from device memory; unregister answers 409 during the stream
    and 200 after."""
    child = _child("--child-region")
    try:
        child.stdin.write(json.dumps([int(t) for t in prompt]) + "\n")
        child.stdin.flush()
        handle = _child_line(child, "HANDLE ")
        _register(port, "child", handle, CHILD_REGION_BYTES)
        n = len(tokens)
        during = []
        body = {"inputs": [
            _shm_ref("child", 0, len(prompt)),
            {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
             "data": [n]}], "parameters": {
            "shm_ring_region": "child", "shm_ring_slots": n,
            "shm_ring_offset": CHILD_RING_OFF,
            "shm_ring_seq_base": CHILD_SEQ_OFF}}
        torch.cuda.synchronize()
        fl.reset_launch_counts()
        status, events, final, _ = _sse_events(
            port, body, on_event=lambda k: k == 1 and during.append(
                _unregister(port, "child")))
        torch.cuda.synchronize()
        counts = {"flash_attention": fl.flash_attention.launches,
                  "decode_attention": fl.decode_attention.launches}
        after = _unregister(port, "child")
        ring = json.loads(_ask(child, "read {}".format(n), "RING "))
    finally:
        _stop_child(child)
    inband = [e[1]["outputs"][0]["data"][0] for e in events
              if e[1]["outputs"]]
    log("shm (b): a child process's CUDA region over IPC: {} events, final "
        "{}; the child read {} ring slots from device memory, all committed "
        "{}, tokens equal 4b's {}, equal the in-band fallback {}; "
        "unregister during the stream {}, after it {}; launches {}".format(
            len(events), final, len(ring["tokens"]), all(ring["committed"]),
            ring["tokens"] == tokens, ring["tokens"] == inband, during,
            after, json.dumps(counts)))
    if status != 200 or not final or not all(ring["committed"]) or \
            ring["tokens"] != tokens or during != [409] or after != 200:
        fail("shm (b): status {}, final {}, committed {}, tokens {} vs {}, "
             "unregister {} then {}".format(status, final, ring["committed"],
                                           ring["tokens"], tokens, during,
                                           after))
    return counts


def _park_attach(torch, np, fl, csm, cfg, model, core, port):
    """(c) phase 4c (c)'s 8 prompts undisturbed, then with ``kv_park``:
    each client drops after 5 events and resumes by ``Last-Event-ID``;
    every resume must attach its export (8 attach admissions, no flash
    launch during the resumes)."""
    import threading

    rng = np.random.RandomState(SEED + 4)
    prompts = [rng.randint(0, cfg.vocab, n) for n in HEAL_PROMPT_LENGTHS]
    budgets = [HEAL_BUDGET] * len(prompts)
    order = range(len(prompts))
    ref, _ = _batched_round(port, prompts, budgets, order)

    def each(fn):
        results, errors = {}, []

        def one(i):
            try:
                results[i] = fn(i)
            except SystemExit as e:
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in order]
        for t in threads:
            t.start()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=600)
        if errors or len(results) != len(prompts):
            fail("park (c): {} of {} streams".format(len(results),
                                                     len(prompts)))
        return results

    made0 = core.shm_stats()["kv_exports_made"]
    first = each(lambda i: _sse(port, prompts[i], budgets[i], stop_after=5,
                                parameters={"kv_park": True}))
    deadline = time.monotonic() + 120
    while sum(n.startswith("kvexport/") for n in core.cuda_shm_status()) \
            < len(prompts):
        if time.monotonic() > deadline:
            fail("park (c): exports {} after 120 s".format(
                sorted(core.cuda_shm_status())))
        time.sleep(0.05)
    peak, regions, used = _memory(torch, csm)
    log("park (c): 8 streams dropped after 5 events, 8 exports parked: "
        "{:.3f} GiB in CUDA regions; torch peak {:.3f} GiB; the card has "
        "{:.3f} GiB in use".format(regions, peak, used))
    stats0 = model.scheduler_stats()
    torch.cuda.synchronize()
    fl.reset_launch_counts()
    second = each(lambda i: _sse(port, prompts[i], budgets[i],
                                 last_event_id=first[i][1][4][0]))
    torch.cuda.synchronize()
    counts = {"flash_attention": fl.flash_attention.launches,
              "decode_attention": fl.decode_attention.launches}
    stats = model.scheduler_stats()
    attaches = stats["attach_admissions"] - stats0["attach_admissions"]
    agree = total = 0
    for i in order:
        status, events, final, _ = second[i]
        joined = [e[1] for e in first[i][1][:5]] + [e[1] for e in events]
        seqs = [int(e[0].rsplit("/", 1)[1]) for e in
                first[i][1][:5] + events]
        if status != 200 or not final or seqs != list(range(budgets[i])):
            fail("park (c) request {}: status {}, final {}, seqs {}".format(
                i, status, final, seqs))
        agree += sum(a == b for a, b in zip(joined[5:], ref[i][0][5:]))
        total += budgets[i] - 5
    left = sorted(n for n in core.cuda_shm_status()
                  if n.startswith("kvexport/"))
    log("park (c): resumes by Last-Event-ID: attach admissions {} (want "
        "8); launches during the resumes {}; continuation tokens equal to "
        "the undisturbed run: {}/{} (the re-prefill resume: resume (d)); "
        "exports made {}, left after the resumes {}; prefix misses {} -> "
        "{}".format(attaches, json.dumps(counts), agree, total,
                    core.shm_stats()["kv_exports_made"] - made0, left,
                    stats0["prefix_misses"], stats["prefix_misses"]))
    if attaches != len(prompts) or counts["flash_attention"] != 0 or \
            counts["decode_attention"] == 0 or left or \
            stats["prefix_misses"] != stats0["prefix_misses"]:
        fail("park (c): attaches {}, launches {}, exports left {}".format(
            attaches, counts, left))
    return counts


def _handoff(torch, fl, server_b, core_a, port_a, prompt, fused):
    """(d) the prefill leg on server A (this process), its descriptor,
    the decode leg on server B (another process) attached over CUDA
    IPC: no flash launch on B, the fused run's tokens; then a second
    fetch is a 409, and after the release a 404."""
    port_b = int(_child_line(server_b, "PORT "))
    status, events, final, _ = _sse(port_a, prompt, 1, parameters={
        "generation_id": "handoff", "kv_phase": "prefill"})
    tok0 = [e[1] for e in events]
    status_d, desc = _http_json(port_a, "GET", "/v2/kvexport/handoff")
    if status != 200 or not final or status_d != 200:
        fail("handoff (d): prefill leg {} {}, descriptor {} {}".format(
            status, events, status_d, desc))
    desc = json.loads(desc)
    _ask(server_b, "reset", "OK")
    status, rest, final, _ = _sse(
        port_b, list(prompt) + tok0, len(fused) - 1, parameters={
            "generation_id": "handoff-d", "kv_attach": desc})
    b = json.loads(_ask(server_b, "counts", "COUNTS "))
    again = _http_json(port_a, "GET", "/v2/kvexport/handoff")[0]
    release = _http_json(port_a, "POST", "/v2/kvexport/handoff/release")[0]
    gone = _http_json(port_a, "GET", "/v2/kvexport/handoff")[0]
    tokens = tok0 + [e[1] for e in rest]
    agree = sum(a == x for a, x in zip(tokens, fused))
    log("handoff (d): descriptor position {}, {} bytes; server B decode "
        "leg: {} tokens, final {}, tokens equal the fused run's {}/{}; "
        "B's launches flash {} decode {}, attach admissions {}, prefix "
        "misses {}, exports attached {}, peak {:.3f} GiB; A: second fetch "
        "{}, release {}, fetch after it {}".format(
            desc["position"], desc["byte_size"], len(rest), final, agree,
            len(fused), b["flash_attention"], b["decode_attention"],
            b["scheduler"]["attach_admissions"],
            b["scheduler"]["prefix_misses"], b["shm"]["kv_exports_attached"],
            b["peak_gib"], again, release, gone))
    if status != 200 or not final or tokens != fused or \
            b["flash_attention"] != 0 or b["decode_attention"] == 0 or \
            b["scheduler"]["attach_admissions"] != 1 or \
            (again, release, gone) != (409, 200, 404):
        fail("handoff (d): tokens {} vs {}, B {}, fetch/release {}".format(
            tokens, fused, b, (again, release, gone)))
    return {"decode_attention": b["decode_attention"],
            "flash_attention": b["flash_attention"]}


# -- phase 4f: the gRPC front end, metrics, fault points, CoDel -------------

F_SCOPE = "phase4f"
CODEL_SCOPE = "phase4f-codel"


def _install_versions():
    """The grpcio and protobuf versions this machine has (phase 4f needs
    both)."""
    found = {}
    for name, module in (("grpcio", "grpc"), ("protobuf", "google.protobuf")):
        try:
            found[name] = __import__(module, fromlist=["__version__"]
                                     ).__version__
        except ImportError:
            found[name] = None
    return found


def _grpc_calls(url):
    """(channel, {method name: callable}) over the port's own pb2 copies:
    a raw channel, no client library."""
    import grpc

    from tpuserver_torch.grpc_proto import service

    channel = grpc.insecure_channel(url, options=[
        ("grpc.max_receive_message_length", -1)])
    calls = {}
    for name, (req_cls, resp_cls, kind) in service.METHODS.items():
        make = (channel.unary_unary if kind == "unary"
                else channel.stream_stream)
        calls[name] = make(service.method_path(name),
                           request_serializer=req_cls.SerializeToString,
                           response_deserializer=resp_cls.FromString)
    return channel, calls


def _grpc_request(np, prompt, max_tokens, request_id, parameters):
    from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb

    req = pb.ModelInferRequest(model_name="llama_generate", id=request_id)
    for name, arr in (("PROMPT_IDS", np.asarray(prompt, np.int32)),
                      ("MAX_TOKENS", np.array([max_tokens], np.int32))):
        t = req.inputs.add(name=name, datatype="INT32")
        t.shape.extend(arr.shape)
        req.raw_input_contents.append(arr.tobytes())
    for key, value in parameters.items():
        if isinstance(value, bool):
            req.parameters[key].bool_param = value
        elif isinstance(value, int):
            req.parameters[key].int64_param = value
        else:
            req.parameters[key].string_param = str(value)
    return req


def _grpc_round(np, calls, requests, spacing_s=0.05):
    """Send ``requests`` on ONE ``ModelStreamInfer`` stream, ``spacing_s``
    apart, and read it to its end.  Returns ({request id: [(token, seq)]},
    {request id: in-band error response}, the RpcError that ended the
    stream or None, wall seconds)."""
    import grpc

    def feed():
        for i, req in enumerate(requests):
            if i:
                time.sleep(spacing_s)
            yield req

    got = {r.id: [] for r in requests}
    errors, dropped = {}, None
    t0 = time.monotonic()
    try:
        for resp in calls["ModelStreamInfer"](feed(), timeout=600):
            if resp.error_message:
                errors[resp.infer_response.id] = resp
                continue
            out = resp.infer_response
            token = int(np.frombuffer(out.raw_output_contents[0],
                                      np.int32)[0])
            got[out.id].append((token, out.parameters["seq"].int64_param))
    except grpc.RpcError as e:
        dropped = e
    return got, errors, dropped, time.monotonic() - t0


def _metrics_families(text, prefix="tpu_"):
    from tpuserver_torch.metrics import parse_prometheus_text

    return {name: fam for name, fam in parse_prometheus_text(text).items()
            if name.startswith(prefix)}


def _sample(families, family, sample=None, **labels):
    """The value of ``family``'s sample ``sample`` (default: the family's
    own name) with exactly ``labels``."""
    sample = sample or family
    for name, lab, value in families.get(family, {}).get("samples", ()):
        if name == sample and lab == labels:
            return value
    fail("no sample {}{} in the exposition".format(sample, labels))


def phase_grpc(torch, np, cfg, params, prompts, budgets, tokens_4b,
               readmits):
    """Phase 4f on ``max_slots=8`` models over phase 4b's weights, driven
    through a raw gRPC channel over the port's pb2 copies: (a) 4b's 12
    prompts on one bidi stream; (b) 4c (c)'s prompts with ``kv_park``,
    the stream dropped by ``grpc.stream_infer`` after 5 responses and each
    generation resumed; (c) a ``scheduler.step`` raise; (d) CoDel on a
    second model; (e) ``ServerMetrics`` against ``GET /metrics``, the
    counters against ``scheduler_stats()``, a NOT_FOUND and a
    repository index.  Every admission prefill's length is recorded into
    ``readmits`` ((c)'s re-admissions depend on when the fault hit).
    Returns (a)'s launch counts."""
    import http.client

    import grpc

    from tpuserver_torch import fault_points
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb
    from tpuserver_torch.grpc_server import GrpcServer
    from tpuserver_torch.http_server import HttpServer
    from tpuserver_torch.models import llama
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel
    from tpuserver_torch.ops import flash as fl

    def serving(scope, **kwargs):
        model = LlamaGenerateModel(cfg=cfg, max_seq=4096, max_slots=8,
                                   params=params, device="cuda",
                                   fault_scope=scope, **kwargs)
        real_prefill = model._fns["prefill"]

        def prefill(params_, slot_cache, tokens, true_len):
            readmits.append(int(tokens.shape[1]))
            return real_prefill(params_, slot_cache, tokens, true_len)

        model._fns = dict(model._fns, prefill=prefill)
        # registered before the warm-up builds the scheduler: its
        # histograms go into this server's registry
        core = InferenceServer([model], fault_scope=scope)
        model.warmup()
        return (model, core, HttpServer(core, port=0).start(),
                GrpcServer(core, port=0).start())

    def launches_now():
        torch.cuda.synchronize()
        return {"flash_attention": fl.flash_attention.launches,
                "decode_attention": fl.decode_attention.launches}

    def check_round(name, got, errors, dropped, want):
        if errors or dropped is not None:
            fail("grpc {}: in-band errors {}, stream ended by {}".format(
                name, {k: v.error_message for k, v in errors.items()},
                dropped))
        for rid, n in want.items():
            seqs = [s for _, s in got[rid]]
            if seqs != list(range(n)):
                fail("grpc {} request {}: seqs {}".format(name, rid, seqs))

    fault_points.clear()
    torch.cuda.empty_cache()
    model, core, http_srv, grpc_srv = serving(F_SCOPE)
    channel, calls = _grpc_calls(grpc_srv.url)
    codel = None
    try:
        # (a) 4b's 12 prompts and budgets on one bidi stream, 50 ms apart
        lengths = [len(p) for p in prompts]
        tileable = len(_flash_admissions(llama, cfg, 4096, lengths))
        requests = [_grpc_request(np, p, n, str(i),
                                  {"generation_id": "f4a-{}".format(i)})
                    for i, (p, n) in enumerate(zip(prompts, budgets))]
        steps0 = model.scheduler_stats()["steps"]
        torch.cuda.synchronize()
        fl.reset_launch_counts()
        got, errors, dropped, wall = _grpc_round(np, calls, requests)
        launches = launches_now()
        steps = model.scheduler_stats()["steps"] - steps0
        check_round("(a)", got, errors, dropped,
                    {str(i): n for i, n in enumerate(budgets)})
        same = [[t for t, _ in got[str(i)]] == tokens_4b[i]
                for i in range(len(prompts))]
        total = sum(len(v) for v in got.values())
        log("grpc (a): 12 generations on one bidi stream: {} tokens in "
            "{:.3f} s ({:.1f} tokens/s); tokens equal to 4b's HTTP round "
            "{}/12; launches {}; batched steps {}; tileable admissions "
            "{}".format(total, wall, total / wall, sum(same),
                        json.dumps(launches), steps, tileable))
        if not all(same):
            fail("grpc (a): prompts {} streamed other tokens than over "
                 "HTTP".format([i for i, ok in enumerate(same) if not ok]))
        if launches["decode_attention"] < cfg.n_layers * steps or \
                launches["flash_attention"] < cfg.n_layers * tileable:
            fail("grpc (a): launches {} for {} steps and {} tileable "
                 "admissions".format(launches, steps, tileable))

        # (b) 4c (c)'s 8 prompts with kv_park: undisturbed, then the
        # stream dropped after 5 responses and every generation resumed
        rng = np.random.RandomState(SEED + 4)
        heal = [rng.randint(0, cfg.vocab, n) for n in HEAL_PROMPT_LENGTHS]

        def heal_requests(tag, extra):
            return [_grpc_request(np, p, HEAL_BUDGET, str(i), dict(
                {"generation_id": "{}-{}".format(tag, i)}, **extra))
                for i, p in enumerate(heal)]

        ref, errors, dropped, _ = _grpc_round(
            np, calls, heal_requests("f4b-ref", {}), spacing_s=0.0)
        check_round("(b) undisturbed", ref, errors, dropped,
                    {str(i): HEAL_BUDGET for i in range(len(heal))})
        fault_points.install("grpc.stream_infer", skip=5, scope=F_SCOPE)
        first, errors, dropped, _ = _grpc_round(
            np, calls, heal_requests("f4b", {"kv_park": True}),
            spacing_s=0.0)
        fired = fault_points.fired("grpc.stream_infer", F_SCOPE)
        fault_points.clear()
        if dropped is None or errors or fired != 1:
            fail("grpc (b): the stream was not dropped once (fired {}, "
                 "ended by {}, errors {})".format(fired, dropped, errors))
        deadline = time.monotonic() + 120
        while sum(n.startswith("kvexport/f4b-")
                  for n in core.cuda_shm_status()) < len(heal):
            if time.monotonic() > deadline:
                fail("grpc (b): exports {} after 120 s".format(
                    sorted(core.cuda_shm_status())))
            time.sleep(0.05)
        seen = {rid: len(v) for rid, v in first.items()}
        stats0 = model.scheduler_stats()
        torch.cuda.synchronize()
        fl.reset_launch_counts()
        resumed, errors, dropped, _ = _grpc_round(np, calls, [
            _grpc_request(np, heal[i], HEAL_BUDGET, str(i), {
                "resume_generation_id": "f4b-{}".format(i),
                "resume_from_seq": seen[str(i)]})
            for i in range(len(heal))], spacing_s=0.0)
        attach_launches = launches_now()
        stats = model.scheduler_stats()
        attaches = stats["attach_admissions"] - stats0["attach_admissions"]
        agree = total = 0
        for i in range(len(heal)):
            rid = str(i)
            joined = first[rid] + resumed[rid]
            if [s for _, s in joined] != list(range(HEAL_BUDGET)):
                fail("grpc (b) request {}: seqs {}".format(
                    i, [s for _, s in joined]))
            agree += sum(a == b for (a, _), (b, _) in zip(
                resumed[rid], ref[rid][seen[rid]:]))
            total += HEAL_BUDGET - seen[rid]
        log("grpc (b): stream dropped after 5 responses (responses per "
            "generation {}); resumed on one stream: attach admissions {} "
            "(want 8); launches during the resumes {}; continuation tokens "
            "equal to the undisturbed run {}/{}".format(
                [seen[str(i)] for i in range(len(heal))], attaches,
                json.dumps(attach_launches), agree, total))
        if errors or dropped is not None or attaches != len(heal) or \
                attach_launches["flash_attention"] != 0 or agree != total:
            fail("grpc (b): errors {}, dropped {}, attaches {}, launches "
                 "{}, agreement {}/{}".format(errors, dropped, attaches,
                                              attach_launches, agree, total))

        # (c) one raising step, mid-round
        restarts0 = _sample(_metrics_families(core.metrics_text()),
                            "tpu_scheduler_restarts_total",
                            model="llama_generate")
        fault_points.install("scheduler.step", skip=10, scope=F_SCOPE)
        got, errors, dropped, wall = _grpc_round(
            np, calls, heal_requests("f4c", {}), spacing_s=0.0)
        fired = fault_points.fired("scheduler.step", F_SCOPE)
        fault_points.clear()
        check_round("(c)", got, errors, dropped,
                    {str(i): HEAL_BUDGET for i in range(len(heal))})
        restarts = _sample(_metrics_families(core.metrics_text()),
                           "tpu_scheduler_restarts_total",
                           model="llama_generate")
        log("grpc (c): scheduler.step raised {} time(s); restarts {} -> {}; "
            "8/8 streams completed, gap-free, in {:.3f} s".format(
                fired, restarts0, restarts, wall))
        if fired != 1 or restarts != restarts0 + 1 or \
                not model.scheduler_stats()["healthy"]:
            fail("grpc (c): fired {}, restarts {} -> {}".format(
                fired, restarts0, restarts))

        # (d) CoDel on a second model over the same weights: 24 requests
        # on one stream, 50 ms apart, over 8 slots
        codel = serving(CODEL_SCOPE, target_queue_ms=50,
                        shed_interval_ms=100)
        codel_channel, codel_calls = _grpc_calls(codel[3].url)
        try:
            burst = [_grpc_request(np, prompts[i % 12], 16, str(i),
                                   {"generation_id": "f4d-{}".format(i)})
                     for i in range(24)]
            got, errors, dropped, wall = _grpc_round(np, codel_calls, burst)
        finally:
            codel_channel.close()
        sheds = {rid: resp for rid, resp in errors.items()
                 if resp.infer_response.parameters[
                     "grpc_status"].string_param == "RESOURCE_EXHAUSTED"}
        retry = sorted({int(r.infer_response.parameters[
            "retry-after"].int64_param) for r in sheds.values()})
        counted = _sample(_metrics_families(codel[1].metrics_text()),
                          "tpu_scheduler_codel_sheds_total",
                          model="llama_generate")
        completed = [rid for rid, v in got.items()
                     if rid not in errors and len(v) == 16]
        log("grpc (d): 24 requests over 8 slots, 50 ms apart: {} shed "
            "in-band as RESOURCE_EXHAUSTED with retry-after {} (the "
            "control interval is at most 100 ms: max(1, ceil) = 1); "
            "tpu_scheduler_codel_sheds_total {}; {} completed; {:.3f} "
            "s".format(len(sheds), retry, counted, len(completed), wall))
        if not sheds or retry != [1] or counted != len(sheds) or \
                len(sheds) != len(errors) or dropped is not None or \
                len(completed) + len(sheds) != 24 or [
                    s for _, s in got[completed[0]]] != list(range(16)):
            fail("grpc (d): sheds {}, retry-after {}, counter {}, errors "
                 "{}, completed {}".format(len(sheds), retry, counted,
                                           len(errors), len(completed)))

        # (e) the metrics plane over both transports
        over_grpc = calls["ServerMetrics"](pb.ServerMetadataRequest(),
                                           timeout=60).settings[
            "metrics"].string_param
        conn = http.client.HTTPConnection("127.0.0.1", http_srv.port,
                                          timeout=60)
        conn.request("GET", "/metrics")
        over_http = conn.getresponse().read().decode("utf-8")
        conn.close()
        fams_grpc = _metrics_families(over_grpc)
        fams_http = _metrics_families(over_http)
        counters = sorted(n for n, f in fams_grpc.items()
                          if f["type"] == "counter")
        differ = [n for n in counters
                  if fams_grpc[n]["samples"] != fams_http.get(n, {}).get(
                      "samples")]
        stats = model.scheduler_stats()
        checks = {
            "tpu_scheduler_admissions_total": stats["admitted"],
            "tpu_scheduler_tokens_total": stats["tokens"],
            "tpu_prefix_cache_hits_total": stats["prefix_hits"],
            "tpu_prefix_cache_misses_total": stats["prefix_misses"],
            "tpu_prefix_cache_evictions_total": stats["prefix_evictions"],
        }
        read = {n: _sample(fams_grpc, n, model="llama_generate")
                for n in checks}
        step_count = _sample(fams_grpc, "tpu_scheduler_step_seconds",
                             "tpu_scheduler_step_seconds_count",
                             model="llama_generate")
        nv = _metrics_families(over_grpc, "nv_gpu_memory_used_bytes")
        free, total_mem = torch.cuda.mem_get_info()
        nv_used = _sample(nv, "nv_gpu_memory_used_bytes", gpu="0")
        log("grpc (e): {} tpu_* counter families; ServerMetrics and GET "
            "/metrics differ on {}; counters {} against scheduler_stats() "
            "{}; step histogram count {} against {} batched steps; "
            "nv_gpu_memory_used_bytes {} beside torch.cuda.mem_get_info "
            "used {} (total {})".format(
                len(counters), differ, json.dumps(read), json.dumps(checks),
                step_count, stats["steps"], int(nv_used), total_mem - free,
                total_mem))
        if differ or read != checks or step_count != stats["steps"]:
            fail("grpc (e): differing families {}, counters {} vs {}, step "
                 "count {} vs {}".format(differ, read, checks, step_count,
                                         stats["steps"]))
        codes = []
        for method, request in (
                ("ModelMetadata", pb.ModelMetadataRequest(name="nope")),
                ("RepositoryIndex", pb.RepositoryIndexRequest())):
            try:
                calls[method](request, timeout=60)
                codes.append(None)
            except grpc.RpcError as e:
                codes.append(e.code().name)
        log("grpc (e): unknown model -> {}, RepositoryIndex -> {}".format(
            *[c or "OK" for c in codes]))
        if codes != ["NOT_FOUND", None]:
            fail("grpc (e): codes {}".format(codes))
    finally:
        fault_points.clear()
        channel.close()
        for server in ([codel] if codel else []) + [
                (model, core, http_srv, grpc_srv)]:
            server[3].stop()
            server[2].stop()
            server[1].close()
    return launches


# -- phase 4g: the fleet ----------------------------------------------------

FLEET_PROBE_S = 0.2
FLEET_DRAIN_S = 120.0
# (e)'s replicas: phase 4's model (with this script's seed, its weights)
FLEET_REPLICA_ARGS = ("--config", "llama3_8b", "--max-seq", "4096",
                      "--max-slots", "8")


def child_serve(torch, argv):
    """``--child-serve <serve.py argv>``: a fleet replica, the port's
    ``serve.py`` on this process's main thread (so its signal handlers
    install and a SIGTERM drains for real).  A daemon thread answers
    ``reset`` (zero the kernel counts) and ``counts`` (print them with
    this process's peak memory) on stdin; the server's HTTP surface has
    no kernel counter."""
    import threading

    from tpuserver_torch import serve
    from tpuserver_torch.ops import flash as fl

    def answer():
        for line in sys.stdin:
            cmd = line.strip()
            torch.cuda.synchronize()
            if cmd == "reset":
                fl.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                print("OK", flush=True)
            elif cmd == "counts":
                free, total = torch.cuda.mem_get_info()
                print("COUNTS", json.dumps({
                    "flash_attention": fl.flash_attention.launches,
                    "decode_attention": fl.decode_attention.launches,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                    "card_used_gib": (total - free) / 2 ** 30}), flush=True)

    threading.Thread(target=answer, name="child-serve-stdin",
                     daemon=True).start()
    serve.main(argv)


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _replica(port, role, nonce):
    """A ``llama3_8b`` replica process with the argv a supervisor's
    template would give it (the script's seed: phase 4b's weights)."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child-serve",
         "--config", "llama3_8b", "--max-seq", "4096", "--max-slots", "8",
         "--seed", str(SEED), "--port", str(port), "--role", role,
         "--spawn-nonce", nonce, "--drain-timeout", str(FLEET_DRAIN_S)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, bufsize=1)


def _health(port):
    """A replica's ``/v2/health/stats``, or None while it does not
    answer."""
    try:
        status, body = _http_json(port, "GET", "/v2/health/stats")
    except OSError:
        return None
    return json.loads(body) if status == 200 else None


def _router_stats(port):
    status, body = _http_json(port, "GET", "/router/stats")
    if status != 200:
        fail("router stats answered {}: {}".format(status, body[:300]))
    return json.loads(body)


def _fleet_wait(what, predicate, procs, timeout=600.0):
    """Poll ``predicate`` until it holds; fail after ``timeout`` or when
    one of ``procs`` (name -> process) has exited."""
    deadline = time.monotonic() + timeout
    while not predicate():
        for name, proc in procs.items():
            if proc.poll() is not None:
                fail("fleet: {} exited with {} while waiting for {}".format(
                    name, proc.returncode, what))
        if time.monotonic() > deadline:
            fail("fleet: {} not reached after {:.0f} s".format(what,
                                                              timeout))
        time.sleep(0.05)


def _fleet_round(port, prompts, budgets, on_event=None):
    """Every request through the router, 50 ms apart, each on its own
    thread (``on_event(i, n)`` after request i's n-th event).  Returns a
    thread that joins to {i: (tokens, ids, final, each event's seconds
    after the POST)} in ``.results``."""
    import threading

    results, errors = {}, []

    def one(i):
        try:
            status, events, final, t0 = _sse_events(
                port, _body(prompts[i], budgets[i]),
                on_event=None if on_event is None
                else (lambda n: on_event(i, n)))
            if status != 200:
                fail("fleet request {}: status {} {}".format(i, status,
                                                           events))
            tokens = [int(next(o for o in e["outputs"]
                               if o["name"] == "TOKEN")["data"][0])
                      for _, e, _ in events]
            results[i] = (tokens, [x for x, _, _ in events], final,
                          [t - t0 for _, _, t in events])
        except SystemExit as e:  # fail() inside a worker thread
            errors.append(e)

    def run():
        threads = []
        for i in range(len(prompts)):
            threads.append(threading.Thread(target=one, args=(i,),
                                            daemon=True))
            threads[-1].start()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=900)

    runner = threading.Thread(target=run, daemon=True)
    runner.results, runner.errors = results, errors
    runner.start()
    return runner


def _fleet_results(runner, budgets, what):
    """The round's results, each stream complete and gap-free."""
    runner.join(timeout=900)
    if runner.errors or len(runner.results) != len(budgets):
        fail("fleet {}: {} of {} streams completed".format(
            what, len(runner.results), len(budgets)))
    for i, (tokens, ids, final, _) in sorted(runner.results.items()):
        seqs = [int(x.rsplit("/", 1)[1]) for x in ids]
        if not final or len(tokens) != budgets[i] or \
                seqs != list(range(budgets[i])):
            fail("fleet {} request {}: {} tokens of {}, final {}, seqs "
                 "{}".format(what, i, len(tokens), budgets[i], final, seqs))
    return runner.results


def _handoff_offset(ids):
    """The offset of a stream's last router handoff (its ``id:`` lines
    read ``<gen>~<offset>/<seq>`` after one), 0 without one."""
    base = ids[-1].rsplit("/", 1)[0]
    _, tilde, off = base.rpartition("~")
    return int(off) if tilde and off.isdigit() else 0


def _port_env():
    """The environment of a ``python -m tpuserver_torch.*`` child: this
    checkout's package first on its path."""
    path = os.path.join(HERE, "src", "python")
    if os.environ.get("PYTHONPATH"):
        path += os.pathsep + os.environ["PYTHONPATH"]
    return dict(os.environ, PYTHONPATH=path)


def phase_fleet(torch, np, cfg, prompts, budgets, tokens_4b):
    """Phase 4g: two ``llama3_8b`` replica processes (``--child-serve``,
    ``--role prefill`` and ``--role decode``) behind the port's router
    (``python -m tpuserver_torch.router_cli``, a process reached over
    HTTP only): (a)
    4b's 12 prompts phase-split, (b) a SIGTERM drain of the decode
    replica mid-round, (c) a respawn with a new nonce and a SIGKILL
    mid-round, every stream handed off to the prefill replica, (d) a
    SIGTERM of the survivor.  Returns the launch counts of the three
    paths, the handoff's counted from just before the SIGKILL (so none
    of (c)'s prefill legs is among them), and the lengths of (c)'s
    handoff re-prefills that ran flash (one whose length does not tile
    runs the dense path)."""
    import signal
    import threading

    from tpuserver_torch.models import llama

    layers = cfg.n_layers
    pport, dport, rport = _free_port(), _free_port(), _free_port()
    procs = {"prefill replica": _replica(pport, "prefill", "p-1"),
             "decode replica": _replica(dport, "decode", "d-1")}
    router = subprocess.Popen(
        [sys.executable, "-m", "tpuserver_torch.router_cli",
         "--backends", "127.0.0.1:{},127.0.0.1:{}".format(pport, dport),
         "--port", str(rport), "--probe-interval", str(FLEET_PROBE_S)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        bufsize=1, env=_port_env())
    router_lines = []
    out = {}
    try:
        first = router.stdout.readline()
        if not first:
            fail("fleet: the router exited with {} before its first log "
                 "line".format(router.wait(timeout=60)))
        log("fleet: router:", first.rstrip())
        threading.Thread(target=lambda: router_lines.extend(router.stdout),
                         daemon=True).start()
        watched = dict(procs, router=router)
        t0 = time.monotonic()
        states = set()

        def booted():
            snap = _health(pport)
            if snap is not None:
                states.add(snap["state"])
            snaps = [snap, _health(dport)]
            if any(x is None or x["state"] != "ready" for x in snaps):
                return False
            if any(x["max_inflight"] is not None for x in snaps):
                fail("fleet: snapshots' max_inflight {} (want no cap: "
                     "serve.py takes none)".format(
                         [x["max_inflight"] for x in snaps]))
            disagg = _router_stats(rport)["disagg"]
            return (disagg["prefill_replicas"],
                    disagg["decode_replicas"]) == (1, 1) and all(
                r["eligible"] for r in _router_stats(rport)["replicas"])

        _fleet_wait("both replicas ready in their router pools", booted,
                    watched)
        log("fleet: replicas ready and routed in {:.1f} s; states the "
            "prefill replica's snapshot showed while it booted: {}".format(
                time.monotonic() - t0, sorted(states)))
        p_proc, d_proc = procs["prefill replica"], procs["decode replica"]

        # (a) the phase split
        tileable = len(_flash_admissions(llama, cfg, 4096,
                                         [len(p) for p in prompts]))
        for proc in (p_proc, d_proc):
            _ask(proc, "reset", "OK")
        p0, d0 = _health(pport), _health(dport)
        s0 = _router_stats(rport)["disagg"]
        t0 = time.monotonic()
        results = _fleet_results(_fleet_round(rport, prompts, budgets),
                                 budgets, "(a)")
        wall = time.monotonic() - t0
        pc = json.loads(_ask(p_proc, "counts", "COUNTS "))
        dc = json.loads(_ask(d_proc, "counts", "COUNTS "))
        p1, d1 = _health(pport), _health(dport)
        s1 = _router_stats(rport)["disagg"]
        pm0, pm1 = (x["models"]["llama_generate"] for x in (p0, p1))
        dm0, dm1 = (x["models"]["llama_generate"] for x in (d0, d1))
        p_steps, d_steps = (pm1["steps"] - pm0["steps"],
                            dm1["steps"] - dm0["steps"])
        same = sum(results[i][0] == tokens_4b[i] for i in range(12))
        times = [results[i][3] for i in range(12)]
        ttft = float(np.median([t[0] for t in times]))
        # the decode leg's first token after the prefill leg's: the
        # descriptor fetch, the attach and D's admission
        leg_gap = float(np.median([t[1] - t[0] for t in times]))
        rate = float(np.median([(len(t) - 2) / (t[-1] - t[1])
                                for t in times]))
        splits, transfers = (s1["splits"] - s0["splits"],
                             s1["transfers"] - s0["transfers"])
        nbytes = s1["transfer_bytes"] - s0["transfer_bytes"]
        attaches = dm1["attach_admissions"] - dm0["attach_admissions"]
        log("fleet (a): 12 streams through the router in {:.3f} s ({} "
            "tokens); medians: TTFT {:.1f} ms, first to second token "
            "{:.1f} ms, decode {:.1f} tokens/s after it; equal to 4b's "
            "tokens {}/12; splits {}, transfers {} "
            "({} bytes, {:.1f} ms fetching), fallbacks {}; prefill replica: "
            "flash {} decode {} over {} steps, admissions {}, peak {:.3f} "
            "GiB; decode replica: flash {} decode {} over {} steps, attach "
            "admissions {}, prefix misses {}, peak {:.3f} GiB; the card "
            "{:.3f} GiB in use".format(
                wall, sum(budgets), ttft * 1e3, leg_gap * 1e3, rate,
                same, splits, transfers, nbytes,
                s1["transfer_ms_total"] - s0["transfer_ms_total"],
                s1["fallbacks"], pc["flash_attention"],
                pc["decode_attention"], p_steps,
                pm1["admitted"] - pm0["admitted"], pc["peak_gib"],
                dc["flash_attention"], dc["decode_attention"], d_steps,
                attaches, dm1["prefix_misses"] - dm0["prefix_misses"],
                dc["peak_gib"], dc["card_used_gib"]))
        if same != 12 or (splits, transfers) != (12, 12) or nbytes <= 0:
            fail("fleet (a): tokens {}/12, splits {}, transfers {}, bytes "
                 "{}".format(same, splits, transfers, nbytes))
        if pc["flash_attention"] != layers * tileable or \
                not pc["decode_attention"] >= layers * p_steps > 0:
            fail("fleet (a): prefill replica's launches {} over {} steps "
                 "(want flash {})".format(pc, p_steps, layers * tileable))
        if dc["flash_attention"] != 0 or attaches != 12 or \
                not dc["decode_attention"] >= layers * d_steps > 0:
            fail("fleet (a): decode replica's launches {} over {} steps, "
                 "attach admissions {}".format(dc, d_steps, attaches))
        out["fleet_prefill_leg"] = pc
        out["fleet_decode_leg"] = dc

        # (b) a SIGTERM drain of the decode replica mid-round
        seen = [0] * len(prompts)
        all5 = threading.Event()

        def count(i, n):
            seen[i] = n
            if min(seen) >= 5:
                all5.set()

        s0 = _router_stats(rport)
        pm0 = _health(pport)["models"]["llama_generate"]
        runner = _fleet_round(rport, prompts, budgets, count)
        if not all5.wait(600):
            fail("fleet (b): streams' events {} after 600 s".format(seen))
        t0 = time.monotonic()
        d_proc.send_signal(signal.SIGTERM)
        state = None
        while state != "draining":
            snap = _health(dport)
            state = snap and snap["state"]
            if time.monotonic() - t0 > 30:
                fail("fleet (b): decode replica's state {} 30 s after "
                     "SIGTERM".format(state))
        to_draining = time.monotonic() - t0
        live = snap["models"]["llama_generate"]["live_streams"]
        extra = [0, 1, 2, 3]
        extra_prompts = [prompts[i] for i in extra]
        extra_budgets = [budgets[i] for i in extra]
        during = _fleet_round(rport, extra_prompts, extra_budgets)
        results = _fleet_results(runner, budgets, "(b)")
        during = _fleet_results(during, extra_budgets, "(b) while draining")
        d_exit = d_proc.wait(timeout=FLEET_DRAIN_S + 60)
        s1 = _router_stats(rport)
        pm1 = _health(pport)["models"]["llama_generate"]
        _fleet_wait("the router's decode pool empty", lambda: _router_stats(
            rport)["disagg"]["decode_replicas"] == 0, {"router": router})
        s2 = _router_stats(rport)
        fused = _fleet_results(_fleet_round(rport, extra_prompts,
                                            extra_budgets),
                               extra_budgets, "(b) after the exit")
        s3 = _router_stats(rport)
        same = sum(results[i][0] == tokens_4b[i] for i in range(12))
        same_during = sum(during[k][0] == tokens_4b[i]
                          for k, i in enumerate(extra))
        same_fused = sum(fused[k][0] == tokens_4b[i]
                         for k, i in enumerate(extra))
        log("fleet (b): SIGTERM once every stream had 5 events; the decode "
            "replica's snapshot read 'draining' after {:.4f} s with {} live "
            "streams; 12/12 streams complete, equal to 4b's tokens {}/12; "
            "4 requests sent while it drained: complete, equal to 4b's {}/4 "
            "(reported: router splits +{}, transfers +{}, handoffs +{}, "
            "failovers +{}, fallbacks {}; prefill replica admissions +{}, "
            "attach admissions +{}); decode replica exit code {}; the same "
            "4 once the router's decode pool was empty: equal to 4b's {}/4, "
            "splits +{}".format(
                to_draining, live, same, same_during,
                s1["disagg"]["splits"] - s0["disagg"]["splits"],
                s1["disagg"]["transfers"] - s0["disagg"]["transfers"],
                s1["handoffs"] - s0["handoffs"],
                s1["failovers"] - s0["failovers"], s1["disagg"]["fallbacks"],
                pm1["admitted"] - pm0["admitted"],
                pm1["attach_admissions"] - pm0["attach_admissions"],
                d_exit, same_fused,
                s3["disagg"]["splits"] - s2["disagg"]["splits"]))
        if to_draining > FLEET_PROBE_S or same != 12 or same_fused != 4 \
                or s3["disagg"]["splits"] != s2["disagg"]["splits"] \
                or d_exit != 0:
            fail("fleet (b): draining after {:.4f} s, tokens {}/12, fused "
                 "{}/4, exit {}".format(to_draining, same, same_fused,
                                        d_exit))

        # (c) a respawn with a new nonce, then a SIGKILL mid-round
        d_proc = procs["decode replica"] = _replica(dport, "decode", "d-2")
        watched["decode replica"] = d_proc

        def rejoined():
            snap = _health(dport)
            if snap is None or snap.get("spawn_nonce") != "d-2" or \
                    snap["state"] != "ready":
                return False
            stats = _router_stats(rport)
            return stats["disagg"]["decode_replicas"] == 1 and all(
                r["eligible"] for r in stats["replicas"])

        t0 = time.monotonic()
        _fleet_wait("the respawned decode replica in its pool", rejoined,
                    watched)
        log("fleet (c): decode replica respawned on port {} (nonce d-2, "
            "pid {}), routed again after {:.1f} s".format(
                dport, _health(dport)["pid"], time.monotonic() - t0))
        rng = np.random.RandomState(SEED + 4)
        heal = [rng.randint(0, cfg.vocab, n) for n in HEAL_PROMPT_LENGTHS]
        heal_budgets = [HEAL_BUDGET] * len(heal)
        ref = _fleet_results(_fleet_round(rport, heal, heal_budgets),
                             heal_budgets, "(c) undisturbed")
        seen = [0] * len(heal)
        all5.clear()
        s0 = _router_stats(rport)
        runner = _fleet_round(rport, heal, heal_budgets, count)
        if not all5.wait(600):
            fail("fleet (c): streams' events {} after 600 s".format(seen))
        # every prefill leg has run (each stream is on D): from here on
        # P counts the handoff's launches only
        _ask(p_proc, "reset", "OK")
        d_proc.send_signal(signal.SIGKILL)
        d_proc.wait(timeout=60)
        results = _fleet_results(runner, heal_budgets, "(c)")
        pc = json.loads(_ask(p_proc, "counts", "COUNTS "))
        s1 = _router_stats(rport)
        offsets = [_handoff_offset(results[i][1]) for i in range(len(heal))]
        lengths = [len(heal[i]) + offsets[i] for i in range(len(heal))]
        readmits = _flash_admissions(llama, cfg, 4096,
                                     [n for n, o in zip(lengths, offsets)
                                      if o > 1])
        agree = sum(sum(a == b for a, b in zip(results[i][0][o:],
                                               ref[i][0][o:]))
                    for i, o in enumerate(offsets))
        total = sum(HEAL_BUDGET - o for o in offsets)
        handoffs = s1["handoffs"] - s0["handoffs"]
        log("fleet (c): SIGKILL once every stream had 5 events; 8/8 "
            "streams complete and gap-free; router handoffs +{}, handoff "
            "offsets {} (re-prefill lengths {}); continuation tokens equal "
            "to the undisturbed run {}/{} (reported, not required: a bf16 "
            "re-prefill can flip near-ties); the prefill replica's "
            "launches from the SIGKILL on: flash {} (want {} = {} x {} "
            "re-prefills that tile, at {}; the others ran dense), decode "
            "{}, peak {:.3f} GiB".format(
                handoffs, offsets, lengths, agree, total,
                pc["flash_attention"], layers * len(readmits), layers,
                len(readmits), readmits, pc["decode_attention"],
                pc["peak_gib"]))
        if handoffs < len(heal) or min(offsets) < 5 or \
                pc["flash_attention"] != layers * len(readmits) \
                or pc["decode_attention"] <= 0:
            fail("fleet (c): handoffs {}, offsets {}, launches {}".format(
                handoffs, offsets, pc))
        out["fleet_handoff"] = pc

        # (d) SIGTERM the survivor
        p_proc.send_signal(signal.SIGTERM)
        p_exit = p_proc.wait(timeout=FLEET_DRAIN_S + 60)
        log("fleet (d): prefill replica exit code {} after SIGTERM".format(
            p_exit))
        if p_exit != 0:
            fail("fleet (d): the prefill replica exited {}".format(p_exit))
        return out, readmits
    finally:
        for proc in list(procs.values()) + [router]:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in list(procs.values()) + [router]:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
        log("fleet: router log after its first line:",
            json.dumps([x.rstrip() for x in router_lines][-20:]))


def _heartbeat(path):
    """The supervisor's heartbeat file (its pid, counters and each
    child's pid and state), or None while it is not written."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _pools(port):
    """``(prefill, decode)`` replicas in a router's role pools once every
    member is eligible, else None (also while the router does not
    answer)."""
    try:
        status, body = _http_json(port, "GET", "/router/stats")
    except OSError:
        return None
    if status != 200:
        return None
    stats = json.loads(body)
    if not stats["replicas"] or not all(r["eligible"]
                                        for r in stats["replicas"]):
        return None
    return (stats["disagg"]["prefill_replicas"],
            stats["disagg"]["decode_replicas"])


def phase_fleet_supervised(np, prompts, budgets, tokens_4b):
    """Phase 4g (e): a supervised fleet, ``python -m
    tpuserver_torch.fleet_cli`` under a manifest, one prefill and one
    decode ``llama3_8b`` replica (``python -m tpuserver_torch.serve``,
    ``max_seq`` 4096, ``max_slots`` 8, this script's seed: 4b's weights)
    and a ``router_cli`` process, all the supervisor's children: 4b's 12
    prompts phase-split; the round again with the decode replica
    SIGKILLed once every stream has 5 events (the supervisor restarts it);
    a SIGTERM hands the fleet over; a second supervisor on the manifest
    adopts it and serves 4 prompts; SIGINT stops it.  The counters are
    the supervisor's heartbeat file's (the same ones its in-process
    router exposes as ``tpu_fleet_*`` and ``tpu_supervisor_*``).  No
    kernel count is read: the replicas are the supervisor's children,
    and 4b's tokens are what the kernel path produced."""
    import shutil
    import signal
    import tempfile
    import threading

    from tpuserver_torch import fleetmanifest

    t_phase = time.monotonic()
    work = tempfile.mkdtemp(prefix="fleet-e-")
    beat = os.path.join(work, "heartbeat.json")
    rport = _free_port()
    argv = [sys.executable, "-m", "tpuserver_torch.fleet_cli"] + list(
        FLEET_REPLICA_ARGS) + [
            "--seed", str(SEED), "--prefill-replicas", "1",
            "--decode-replicas", "1", "--min-replicas", "1",
            "--max-replicas", "1", "--router-processes", "--router-port",
            str(rport), "--manifest", os.path.join(work, "manifest"),
            "--heartbeat-file", beat, "--probe-interval",
            str(FLEET_PROBE_S), "--drain-timeout", str(FLEET_DRAIN_S),
            "-v"]
    logs, sups, children = [], [], set()

    def start():
        logs.append(os.path.join(work, "supervisor{}.log".format(len(logs))))
        with open(logs[-1], "w") as fh:
            sups.append(subprocess.Popen(argv, stdout=fh,
                                         stderr=subprocess.STDOUT,
                                         env=_port_env()))
        return sups[-1]

    def alive(pid):
        return fleetmanifest.process_start_token(pid) is not None

    def fleet(sup, boot=None, t0=None):
        """The heartbeat once ``sup`` reports every child up and the
        router routes both pools; ``boot`` gathers each replica's seconds
        from ``t0`` to its first "up"."""
        snap = _heartbeat(beat)
        if snap is None or snap["pid"] != sup.pid:
            return None
        children.update(r["pid"] for r in snap["replicas"] + snap["routers"]
                        if r["pid"])
        if boot is not None:
            for r in snap["replicas"]:
                if r["state"] == "up" and r["pid"] not in boot:
                    boot[r["pid"]] = time.monotonic() - t0
        if not snap["routers"] or any(
                r["state"] != "up" for r in snap["replicas"]
                + snap["routers"]):
            return None
        return snap if _pools(rport) == (1, 1) else None

    def roles(snap):
        out = {}
        for r in snap["replicas"]:
            health = _health(int(r["url"].rsplit(":", 1)[1]))
            out[health["role"]] = r
        return out

    def tail(path, n=30):
        with open(path) as fh:
            return [line.rstrip() for line in fh][-n:]

    try:
        # 1. the fleet, 4b's 12 prompts phase-split
        boot = {}
        t0 = time.monotonic()
        sup = start()
        _fleet_wait("the supervised fleet up and routed",
                    lambda: fleet(sup, boot, t0), {"supervisor": sup})
        snap = fleet(sup)
        by_role = roles(snap)
        up_s = time.monotonic() - t0
        log("fleet (e): supervisor pid {}, replicas {} and the router (pid "
            "{}) up and routed in {:.1f} s; each replica's boot: prefill "
            "{:.1f} s, decode {:.1f} s".format(
                sup.pid, {k: v["pid"] for k, v in by_role.items()},
                snap["routers"][0]["pid"], up_s,
                boot[by_role["prefill"]["pid"]],
                boot[by_role["decode"]["pid"]]))
        s0 = _router_stats(rport)["disagg"]
        results = _fleet_results(_fleet_round(rport, prompts, budgets),
                                 budgets, "(e) 1")
        s1 = _router_stats(rport)["disagg"]
        same = sum(results[i][0] == tokens_4b[i] for i in range(12))
        splits, transfers = (s1["splits"] - s0["splits"],
                             s1["transfers"] - s0["transfers"])
        log("fleet (e) 1: 12 streams complete and gap-free, equal to 4b's "
            "tokens {}/12; splits {}, transfers {} ({} bytes), fallbacks "
            "{}".format(same, splits, transfers,
                        s1["transfer_bytes"] - s0["transfer_bytes"],
                        s1["fallbacks"]))
        if same != 12 or (splits, transfers) != (12, 12):
            fail("fleet (e) 1: tokens {}/12, splits {}, transfers {}".format(
                same, splits, transfers))

        # 2. the round again, the decode replica SIGKILLed mid-round
        seen = [0] * len(prompts)
        all5 = threading.Event()

        def count(i, n):
            seen[i] = n
            if min(seen) >= 5:
                all5.set()

        restarts0 = snap["replica_restarts"]
        s0 = _router_stats(rport)
        runner = _fleet_round(rport, prompts, budgets, count)
        if not all5.wait(600):
            fail("fleet (e) 2: streams' events {} after 600 s".format(seen))
        victim = by_role["decode"]["pid"]
        t0 = time.monotonic()
        os.kill(victim, signal.SIGKILL)
        results = _fleet_results(runner, budgets, "(e) 2")
        s1 = _router_stats(rport)
        boot = {}
        _fleet_wait("the decode replica respawned and routed",
                    lambda: fleet(sup, boot, t0), {"supervisor": sup})
        snap = fleet(sup)
        by_role = roles(snap)
        offsets = [_handoff_offset(results[i][1]) for i in range(12)]
        agree = sum(sum(a == b for a, b in zip(results[i][0][o:],
                                               tokens_4b[i][o:]))
                    for i, o in enumerate(offsets))
        total = sum(budgets[i] - o for i, o in enumerate(offsets))
        restarts = snap["replica_restarts"] - restarts0
        respawned = by_role["decode"]["pid"]
        log("fleet (e) 2: SIGKILL of the decode replica (pid {}) once every "
            "stream had 5 events; 12/12 streams complete and gap-free; "
            "router handoffs +{}, handoff offsets {}; continuation tokens "
            "equal to 4b's {}/{} (reported, not required: a bf16 re-prefill "
            "can flip near-ties); replica restarts +{} "
            "(tpu_fleet_replica_restarts_total), the decode replica back as "
            "pid {} and routed {:.1f} s after the kill (boot {:.1f} s)".format(
                victim, s1["handoffs"] - s0["handoffs"], offsets, agree,
                total, restarts, respawned, time.monotonic() - t0,
                boot.get(respawned, float("nan"))))
        if restarts != 1 or respawned == victim or alive(victim):
            fail("fleet (e) 2: restarts +{}, decode pid {} -> {}".format(
                restarts, victim, respawned))

        # 3. SIGTERM: the supervisor hands over, its children serve on
        pids = sorted(r["pid"] for r in snap["replicas"] + snap["routers"])
        sup.send_signal(signal.SIGTERM)
        code = sup.wait(timeout=120)
        handed = tail(logs[0])
        if code != 0 or not all(alive(p) for p in pids) or \
                "fleet handed over (children still serving)" not in handed:
            fail("fleet (e) 3: supervisor exit {}, children alive {}, log "
                 "{}".format(code, [alive(p) for p in pids], handed[-5:]))
        log("fleet (e) 3: SIGTERM: the supervisor exited {} (handover), its "
            "children {} serving".format(code, pids))

        # 4. a second supervisor on the manifest adopts the fleet
        t0 = time.monotonic()
        sup = start()
        _fleet_wait("the fleet adopted", lambda: fleet(sup),
                    {"supervisor": sup})
        snap = fleet(sup)
        adopted_s = time.monotonic() - t0
        now = sorted(r["pid"] for r in snap["replicas"] + snap["routers"])
        with open(logs[1]) as fh:
            text = fh.read()
        adopted = (text.count("adopted replica"),
                   text.count("adopted active router"))
        results = _fleet_results(_fleet_round(rport, prompts[:4],
                                              budgets[:4]),
                                 budgets[:4], "(e) 4")
        same = sum(results[i][0] == tokens_4b[i] for i in range(4))
        log("fleet (e) 4: a second supervisor (pid {}) adopted the fleet in "
            "{:.1f} s: adoptions {} ({} replicas and {} router: the counter "
            "counts each child it adopts), handovers {}, pids {} (unchanged: "
            "{}), spawns {}; 4 prompts equal to 4b's tokens {}/4".format(
                sup.pid, adopted_s, snap["adoptions"], adopted[0], adopted[1],
                snap["clean_handovers"], now, now == pids,
                text.count("spawned"), same))
        if now != pids or adopted != (2, 1) or snap["adoptions"] != 3 or \
                "spawned" in text or same != 4:
            fail("fleet (e) 4: pids {} -> {}, adopted {}, adoptions {}, "
                 "tokens {}/4".format(pids, now, adopted, snap["adoptions"],
                                      same))

        # 5. SIGINT stops the fleet
        t0 = time.monotonic()
        sup.send_signal(signal.SIGINT)
        code = sup.wait(timeout=FLEET_DRAIN_S + 120)
        stop_s = time.monotonic() - t0
        left = [p for p in children if alive(p)]
        replica_log = tail(logs[0], 400)
        # a replica's "stopped" and the router's "router stopped" are each
        # one write, their newlines another, into the one inherited file:
        # the two can share a line ("stoppedrouter stopped")
        stopped = sum(1 for line in replica_log
                      if line.replace("router stopped", "") == "stopped")
        with open(logs[1]) as fh:
            reaped = [line.rstrip() for line in fh if "reaped" in line]
        log("fleet (e) 5: SIGINT: the supervisor exited {} after {:.1f} s "
            "(drain timeout {} s); the replicas printed 'stopped' {} "
            "times; {}; children left {}".format(
                code, stop_s, FLEET_DRAIN_S, stopped, reaped, left))
        if code != 0 or left or stopped != 2 or \
                any("SIGKILL" in line for line in reaped):
            fail("fleet (e) 5: exit {}, children left {}, replicas stopped "
                 "{}, reaped {}".format(code, left, stopped, reaped))
        log("fleet (e): {:.1f} s".format(time.monotonic() - t_phase))
    finally:
        for sup in sups:
            if sup.poll() is None:
                sup.send_signal(signal.SIGINT)
                try:
                    sup.wait(timeout=FLEET_DRAIN_S + 60)
                except subprocess.TimeoutExpired:
                    sup.kill()
                    sup.wait(timeout=60)
        for pid in children:
            if alive(pid):
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
        for path in logs:
            log("fleet (e): {} (last lines): {}".format(
                os.path.basename(path), json.dumps(tail(path, 12))))
        shutil.rmtree(work, ignore_errors=True)


# -- phase 7: int8 weights ---------------------------------------------------

# Llama-3-8B's int8 matmul weights, (K, N) by name: a decode step runs each
# layer's seven and the lm_head's once through the W8A16 kernel
INT8_WEIGHTS = (("wq", 4096, 4096), ("wk", 4096, 1024), ("wv", 4096, 1024),
                ("wo", 4096, 4096), ("w_gate", 4096, 14336),
                ("w_up", 4096, 14336), ("w_down", 14336, 4096),
                ("lm_head", 4096, 128256))
# rows the kernel is held at: one stream's decode (1), a batched or
# speculative sub-step of 8 slots (8), and 40 (8 slots x 5 verify
# positions, for a verify in one pass: the port's chains 5 steps of 8)
INT8_ROWS = (1, 8, 40)
# one rank's shards of those weights at tp 4 (phase 10): column-parallel
# weights split on N, row-parallel (wo, w_down) on K
INT8_TP4_WEIGHTS = tuple(
    (name, k // 4, n) if name in ("wo", "w_down") else (name, k, n // 4)
    for name, k, n in INT8_WEIGHTS)
# W8A16 kernel vs plain, row-relative as TOL: both round the float32 sum
# to bf16 and then the product with the bf16 scale, but sum in another
# order, so a rounding can move by one bf16 step, twice (at most 2^-7 of
# the row's largest value each); a skipped block of 32 weight rows breaks it
INT8_TOL = 2e-2
# int8 model check, kernels against plain versions: twice LOGITS_TOL.  The
# prefill's w8a8 product rounds every activation to a step of 1/127 of its
# row's largest value, about twice bf16's relative step there, so the
# last-bit differences of flash against dense attention (phase 5) move the
# 32 layers' products up to twice as far; and the lm_head product itself
# now differs between the paths (the W8A16 kernel's and cuBLAS's sums, each
# rounded twice to bf16).  A planted fault (the last 32 of each product's
# input rows dropped) must break it
INT8_LOGITS_TOL = 2 * LOGITS_TOL
INT8_BUDGET_REPETITIVE = 24
# the batched and speculative rounds hold 4b's budgets to at most this
# many tokens (24 to 32 a request, still unequal), so the script keeps
# within its 1200 s
INT8_BUDGET_CAP = 32


def _int8_cases(torch, quant, perf, dev, gen, k, n, flush,
                m_rows=INT8_ROWS):
    """The W8A16 kernel against its plain version at one weight shape and
    each of ``m_rows``: two calls equal, each row equal bit for bit to
    the row computed alone, the row-relative error, a planted fault (the
    last 32 weight rows zeroed), and the times of the kernel, the plain
    version, the bf16 ``torch.matmul`` of the unquantized weight and the
    library's W8A16 call (``torch._weight_int8pack_mm``, which takes the
    weight as [N, K] and bf16 scales), beside the byte and operation
    bound and the kernel's bandwidth share."""
    w = (torch.randn(k, n, device=dev, generator=gen) / k ** 0.5).to(
        torch.bfloat16)
    qw = quant.quantize_int8(w)
    q, s = qw["q"], qw["s"]
    x = torch.randn(max(m_rows), k, device=dev, generator=gen).to(
        torch.bfloat16)
    alone = torch.cat([quant.int8_matmul(x[i:i + 1], q, s)
                       for i in range(len(x))])
    cut = q.clone()
    cut[-32:] = 0
    wt, sb = q.t().contiguous(), s.to(torch.bfloat16)
    rows = []
    for m in m_rows:
        xm = x[:m]
        before = quant.int8_matmul.launches
        out = quant.int8_matmul(xm, q, s)
        again = quant.int8_matmul(xm, q, s)
        torch.cuda.synchronize()
        if quant.int8_matmul.launches != before + 2:
            fail("int8_matmul did not launch its kernel")
        if not torch.equal(out, again):
            fail("int8_matmul: two calls on the same inputs differ")
        if not torch.equal(out, alone[:m]):
            fail("int8_matmul at ({}, {}): rows inside M {} differ from "
                 "the same rows computed alone".format(k, n, m))
        ref = quant.int8_matmul_reference(xm, q, s)
        row = {"kernel": "int8_matmul", "m": m, "k": k, "n": n,
               "dtype": "bfloat16",
               "max_abs_err": (out.float() - ref.float()).abs().max().item(),
               "row_rel_err": row_rel_err(out, ref),
               "planted_fault_err": {"skipped_rows": row_rel_err(
                   quant.int8_matmul_reference(xm, cut, s), ref)},
               "ms": _time_ms(torch, lambda: quant.int8_matmul(xm, q, s),
                              50, flush),
               "plain_ms": _time_ms(
                   torch, lambda: quant.int8_matmul_reference(xm, q, s), 10,
                   flush),
               "bf16_matmul_ms": _time_ms(torch, lambda: xm @ w, 50, flush)}
        try:
            lib = torch._weight_int8pack_mm(xm, wt, sb)
            row["library_row_rel_err"] = row_rel_err(lib, ref)
            row["library_ms"] = _time_ms(
                torch, lambda: torch._weight_int8pack_mm(xm, wt, sb), 10,
                flush)
        except (AttributeError, RuntimeError, NotImplementedError) as e:
            row["library_ms"] = None
            row["library_error"] = str(e)[:200]
        nbytes = k * n + 4 * n + 2 * m * k + 2 * m * n
        row["bound_ms"], row["bound_by"] = _bound_ms(
            nbytes, 2 * m * k * n, SPEC.peak_bf16_flops)
        # the kernel's bandwidth share: the bytes the product must move
        # over its time, against the card's peak (ops/perf.py)
        row["bandwidth_share"] = perf.mbu(nbytes, row["ms"] / 1e3, SPEC)
        rows.append(row)
    return rows


def _int8_step_sum(cases, m, n_layers, weights=INT8_WEIGHTS,
                   keys=("ms", "plain_ms", "bound_ms", "bf16_matmul_ms",
                         "library_ms")):
    """One decode step's W8A16 work at ``m`` rows from the timed shapes
    (``weights``: the model's, or one tp rank's shards): every layer's
    seven products and the lm_head's, summed (each of ``keys``)."""
    uses = {}
    for name, k, n in weights:
        uses[(k, n)] = uses.get((k, n), 0) + (1 if name == "lm_head"
                                              else n_layers)
    out = {"m": m, "shape": "{} layers x (wq, wk, wv, wo, w_gate, w_up, "
           "w_down) + lm_head".format(n_layers)}
    for key in keys:
        vals = [(c, cases[(m,) + kn][key]) for kn, c in uses.items()]
        out[key] = (None if any(v is None for _, v in vals)
                    else sum(c * v for c, v in vals))
    out["bound_by"] = ("bytes" if all(cases[(m,) + kn]["bound_by"] ==
                                      "bytes" for kn in uses)
                       else "operations")
    return out


def _tree_bytes(quant, tree):
    if quant.is_quantized(tree) or not isinstance(tree, (dict, list)):
        return quant.quantized_bytes(tree)
    return sum(_tree_bytes(quant, v) for v in (
        tree.values() if isinstance(tree, dict) else tree))


def _int8_counts(fl, quant):
    return {"flash_attention": fl.flash_attention.launches,
            "decode_attention": fl.decode_attention.launches,
            "int8_matmul": quant.int8_matmul.launches}


def _int8_logits(torch, llama, quant, params, cfg, prompt):
    """The last-position prefill logits of ``prompt`` and one decode
    step's (fed the kernel path's greedy token), through the kernels
    (flash, decode, W8A16), through the plain path (dense attention, and
    the W8A16 plain version swapped in for the kernel here), and through
    the plain path with a planted fault (each W8A16 product without its
    last 32 input rows)."""
    import dataclasses

    tokens = torch.tensor(prompt, dtype=torch.long, device="cuda")[None, :]
    cfg_plain = dataclasses.replace(cfg, attn_impl="dense",
                                    decode_impl="dense")
    out, tok = {}, None
    kernel = quant.int8_matmul
    swaps = {"kernel": kernel, "plain": quant.int8_matmul_reference,
             "fault": lambda x, q, s: quant.int8_matmul_reference(
                 x[..., :-32], q[:-32], s)}
    with torch.inference_mode():
        for name, c in (("kernel", cfg), ("plain", cfg_plain),
                        ("fault", cfg_plain)):
            quant.int8_matmul = swaps[name]
            try:
                cache = llama.init_kv_cache(c, 1, 4096, "cuda")
                first, cache = llama.prefill(params, cache, tokens, c)
                if tok is None:
                    tok = torch.argmax(first, dim=-1)
                second, cache = llama.decode_step(params, cache, tok,
                                                  tokens.shape[1], c)
                out[name] = (first, second)
                del cache
            finally:
                quant.int8_matmul = kernel
    return out


def phase_int8(torch, np, bf16_tokens, prompts, budgets):
    """(a) The W8A16 kernel at the five distinct ``llama3_8b`` weight
    shapes and ``INT8_ROWS`` rows; (b) ``llama3_8b`` served with int8
    weights (``LlamaGenerateModel(quantize=True)``, ``max_seq`` 4096):
    phase 4's three requests single-stream, then phase 4b's 12 prompts
    (budgets capped at ``INT8_BUDGET_CAP``) and 4 repetitive ones over
    ``max_slots=8`` forward and in reverse, and
    the same 16 with ``spec_tokens=4``: tokens identical per prompt across
    the three, launches of all three kernels, TTFT, decode and aggregate
    rates, the decode-token bandwidth share, peak memory and the tree's
    bytes; the kernel path's logits against the plain path's; the int8
    tokens' agreement with bf16's (reported).  Returns (the kernel cases
    by (m, k, n), launch counts by path, the profile of the int8 model)."""
    import gc

    from tpuserver_torch import ops
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.http_server import HttpServer
    from tpuserver_torch.models import llama
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel
    from tpuserver_torch.ops import flash as fl
    from tpuserver_torch.ops import perf, quant

    dev = torch.device("cuda")
    cfg = llama.llama3_8b()
    # (a) the kernel against its plain version
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cases = {}
    for k, n in sorted({(k, n) for _, k, n in INT8_WEIGHTS}):
        for row in _int8_cases(torch, quant, perf, dev, gen, k, n, flush):
            log("kernel_case:", json.dumps(row))
            cases[(row["m"], k, n)] = row
    # the prefill's w8a8 product (torch._int_mm, cuBLASLt) at a 512-token
    # prompt and w_gate's shape: the int8 weight as stored ([K, N], N
    # contiguous), the same values column-major, and the bf16 product
    xq = torch.randint(-127, 128, (512, 4096), device=dev,
                       generator=gen).to(torch.int8)
    wq = torch.randint(-127, 128, (4096, 14336), device=dev,
                       generator=gen).to(torch.int8)
    wq_cm = wq.t().contiguous().t()
    if not torch.equal(torch._int_mm(xq, wq_cm), quant._int8_product(xq, wq)):
        fail("torch._int_mm differs between the weight's two layouts")
    xb, wb = xq.to(torch.bfloat16), wq.to(torch.bfloat16)
    log("w8a8 product at M 512, K 4096, N 14336: {}".format(json.dumps({
        "stored_layout_ms": _time_ms(
            torch, lambda: quant._int8_product(xq, wq), 20, flush),
        "column_major_ms": _time_ms(
            torch, lambda: torch._int_mm(xq, wq_cm), 20, flush),
        "bf16_matmul_ms": _time_ms(torch, lambda: xb @ wb, 20, flush)})))
    del flush, xq, wq, wq_cm, xb, wb
    torch.cuda.empty_cache()
    bad = [r for r in cases.values() if not r["row_rel_err"] <= INT8_TOL]
    blind = [r for r in cases.values()
             if not r["planted_fault_err"]["skipped_rows"] > INT8_TOL]
    if bad:
        fail("int8_matmul disagrees with its plain version: {}".format(bad))
    if blind:
        fail("a planted fault passes the int8 tolerance: {}".format(blind))
    # one decode step's products at each timed row count (M 40 is on no
    # path: a verify of 8 slots x 5 positions in one pass)
    steps = {m: _int8_step_sum(cases, m, cfg.n_layers) for m in INT8_ROWS}
    for m, row in steps.items():
        log("timed: int8_matmul, one decode step at M {}: {} ms, bound {} "
            "ms ({}), bf16 torch.matmul of the same weights {} ms, plain {} "
            "ms, library {} ms".format(
                m, row["ms"], row["bound_ms"], row["bound_by"],
                row["bf16_matmul_ms"], row["plain_ms"], row["library_ms"]))

    # (b) the int8 server: weights drawn and quantized on the card
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = LlamaGenerateModel(cfg=cfg, max_seq=4096, seed=SEED,
                               device="cuda", quantize=True)
    t0 = time.monotonic()
    model.warmup()
    torch.cuda.synchronize()
    params = model._ensure_params()
    memory = {"load_s": time.monotonic() - t0,
              "load_peak_gib": (torch.cuda.max_memory_allocated() - base)
              / 2 ** 30,
              "quantized_bytes": _tree_bytes(quant, params),
              "bf16_bytes": perf.param_count(cfg) * 2}
    if not quant.is_quantized(params["lm_head"]) or not all(
            quant.is_quantized(layer[w]) for layer in params["layers"]
            for w in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")):
        fail("the int8 model serves weights that are not quantized")
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.RandomState(SEED)  # phase 4's prompts
    long_prompt = rng.randint(0, cfg.vocab, 512)
    short_prompt = rng.randint(0, cfg.vocab, 77)
    core = InferenceServer([model])
    http = HttpServer(core, port=0).start()
    runs, rates, ttfts, launches = [], [], [], {}
    try:
        ops.reset_launch_counts()
        for name, prompt, n in (("flash_prefill", long_prompt, 64),
                                ("dense_prefill", short_prompt, 32),
                                ("repeat", long_prompt, 64)):
            tokens, ttft, rate, final, _ = _stream(http.port, prompt, n)
            log("int8 request {}: prompt {} tokens, {} tokens streamed, "
                "ttft {:.1f} ms, decode {:.1f} tokens/s".format(
                    name, len(prompt), len(tokens), ttft * 1e3, rate))
            if len(tokens) != n or not final:
                fail("int8 request {}: {} events (want {}), final marker "
                     "{}".format(name, len(tokens), n, final))
            runs.append(tokens)
            rates.append(rate)
            ttfts.append(ttft)
        torch.cuda.synchronize()
        launches["serve_int8"] = _int8_counts(fl, quant)
    finally:
        http.stop()
        core.close()
    memory["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if runs[2] != runs[0]:
        fail("int8: the repeated request gave other tokens")
    counts = launches["serve_int8"]
    per_step = 7 * cfg.n_layers + 1  # W8A16 launches of one decode step
    if (counts["flash_attention"] < cfg.n_layers
            or counts["decode_attention"] < cfg.n_layers * 95
            or counts["int8_matmul"] < per_step * 95):
        fail("int8 single-stream launches {} (want flash >= {}, decode >= "
             "{}, int8 >= {})".format(counts, cfg.n_layers,
                                      cfg.n_layers * 95, per_step * 95))
    ctx = len(long_prompt) + 32
    nbytes = perf.decode_bytes_per_token(cfg, ctx, weight_bytes_per_param=1)
    rate = rates[0]
    share = perf.mbu(nbytes, 1.0 / rate, SPEC)
    agree = sum(a == b for a, b in zip(runs[0], bf16_tokens))
    log("int8 serve: launches {}; TTFT {} ms; decode {} tokens/s; decode "
        "bandwidth share {} ({} bytes a token at context {}, 1-byte "
        "weights; client clock); greedy tokens shared with bf16's: {}/{} "
        "(reported, not required); memory {}".format(
            json.dumps(counts), [t * 1e3 for t in ttfts], rates, share,
            nbytes, ctx, agree, len(bf16_tokens), json.dumps(memory)))

    # the kernel path's logits against the plain path's
    logits = _int8_logits(torch, llama, quant, params, cfg, long_prompt)
    errs, faults, ranges = [], [], []
    for i, what in enumerate(("prefill", "decode step")):
        lk, lp = logits["kernel"][i], logits["plain"][i]
        if not (torch.isfinite(lk).all() and lk.shape == (1, cfg.vocab)):
            fail("int8 kernel-path {} logits not finite or of the wrong "
                 "shape".format(what))
        errs.append((lk - lp).abs().max().item())
        faults.append((logits["fault"][i] - lp).abs().max().item())
        ranges.append((lp.min().item(), lp.max().item()))
    log("int8 model check: logits max |kernel - plain| prefill {:.4g}, "
        "decode step {:.4g} (tolerance {}); planted fault {:.4g}, {:.4g}; "
        "plain logits ranges {}".format(errs[0], errs[1], INT8_LOGITS_TOL,
                                        faults[0], faults[1], ranges))
    if not max(errs) <= INT8_LOGITS_TOL:
        fail("int8 kernel-path logits differ from the plain path by "
             "{}".format(errs))
    if not faults[1] > INT8_LOGITS_TOL:
        fail("int8 model check: the planted fault passes the tolerance")
    del logits

    # batched, in both arrival orders, then speculative
    prompts = list(prompts) + _repetitive_prompts(np, cfg.vocab, 4)
    budgets = [min(b, INT8_BUDGET_CAP) for b in budgets] + [
        INT8_BUDGET_REPETITIVE] * 4
    tileable = len(_flash_admissions(llama, cfg, 4096,
                                     [len(p) for p in prompts]))
    rounds = {}
    for path, spec, orders in (
            ("serve_int8_batched", 0, (range(len(prompts)),
                                       range(len(prompts) - 1, -1, -1))),
            ("serve_int8_spec", SPEC_K, (range(len(prompts)),))):
        bmodel = LlamaGenerateModel(cfg=cfg, max_seq=4096, max_slots=8,
                                    params=params, device="cuda",
                                    quantize=True, spec_tokens=spec)
        bmodel.warmup()
        if bmodel._ensure_params()["lm_head"]["q"].data_ptr() != \
                params["lm_head"]["q"].data_ptr():
            fail("the batched int8 model copied the weights")
        bcore = InferenceServer([bmodel])
        bhttp = HttpServer(bcore, port=0).start()
        try:
            ops.reset_launch_counts()
            for order in orders:
                results, wall = _batched_round(bhttp.port, prompts, budgets,
                                               list(order))
                total = sum(len(r[0]) for r in results.values())
                log("int8 {} round: {} tokens in {:.3f} s, aggregate {:.1f} "
                    "tokens/s; TTFT median {:.1f} ms".format(
                        path, total, wall, total / wall, sorted(
                            r[1] for r in results.values())[
                                len(results) // 2] * 1e3))
                for i, r in results.items():
                    if len(r[0]) != budgets[i] or not r[3] or [
                            int(x.rsplit("/", 1)[1]) for x in r[4]] != list(
                                range(budgets[i])):
                        fail("int8 {} request {}: {} tokens, final {}, ids "
                             "{}".format(path, i, len(r[0]), r[3], r[4]))
                rounds.setdefault(path, []).append(
                    {i: r[0] for i, r in results.items()})
            torch.cuda.synchronize()
            launches[path] = _int8_counts(fl, quant)
            stats = bmodel.scheduler_stats()
        finally:
            bhttp.stop()
            bcore.close()
        del bmodel, bcore, bhttp
        gc.collect()
        torch.cuda.empty_cache()
        counts = launches[path]
        log("int8 {}: launches {}, scheduler {}".format(
            path, json.dumps(counts), json.dumps(stats)))
        n_rounds = len(orders)
        if (counts["decode_attention"] < cfg.n_layers * stats["steps"]
                or counts["int8_matmul"] < per_step * stats["steps"]
                or counts["flash_attention"]
                < cfg.n_layers * n_rounds * tileable):
            fail("int8 {} launches {} over {} steps and {} tileable "
                 "admissions".format(path, counts, stats["steps"],
                                     n_rounds * tileable))
        if spec and stats["spec_proposed"] == 0:
            fail("no stream drafted in the int8 spec round")
    plain = rounds["serve_int8_batched"]
    same = [plain[0][i] == plain[1][i] == rounds["serve_int8_spec"][0][i]
            for i in range(len(prompts))]
    log("int8: prompts identical across arrival orders and with "
        "spec_tokens={}: {}/{}".format(SPEC_K, sum(same), len(same)))
    if not all(same):
        fail("int8: prompts streamed other tokens in another slot or with "
             "speculation: {}".format([i for i, ok in enumerate(same)
                                       if not ok]))

    # where the time goes, on a fresh pool of random K/V
    fns = llama.make_scheduler_fns(cfg, 4096, 8, device="cuda")
    with torch.inference_mode():
        state = {"pages": fns["init_cache"](), "logits": fns["init_logits"]()}
        state["pages"].normal_(generator=torch.Generator(
            device="cuda").manual_seed(SEED))
    prof_steps, _, _ = _profiled_steps(np, fns, params, state)
    profile = phase_profile(torch, model, long_prompt, prof_steps,
                            label="profile_int8")
    del state, prof_steps, fns, model, params
    gc.collect()
    torch.cuda.empty_cache()
    return cases, steps, launches, profile


# -- phase 8: vision ---------------------------------------------------------

# phase 8 (a): the served bf16 logits against a float32 forward of the same
# weights on the card (TF32 off), row-relative as above over each image's
# 1000 logits.  The bf16 error after 53 (ResNet-50) or 121 (DenseNet-121)
# convolutions measured about 3e-3 at full width on the CPU; the planted
# fault (the last block's last convolution skipped) moves the logits by
# 0.13 (DenseNet-121) to 0.67 (ResNet-50).  The same limit holds (b)'s
# batched answers against the same images served alone, and (c)'s region
# answer against the in-band one.
VISION_TOL = 1e-2
VISION_BATCHES = (1, 32)
IMAGE = (224, 224, 3)
IMAGE_BYTES = 224 * 224 * 3 * 4
OUTPUT_BYTES = 1000 * 4
# (e): client threads, and timed requests per thread, at each concurrency
VISION_LOAD = ((1, 100), (16, 20))
# (e) and phase 9 (c): CUDA-event samples per forward, each alone behind
# a hold of the card while the host enqueues it (a DenseNet-121 forward is
# about 440 launches and 6 ms of host time, a BERT-base one about 480 and
# 9-12 ms; ten at once would overrun the launch queue, and the host would
# pace the card); 6e7 cycles hold it about 30 ms
FORWARD_ITERS = 10
FORWARD_HOLD_CYCLES = int(6e7)


def _vision_infer_request(np, model, images=None, shm_in=None, shm_out=None,
                          request_id=""):
    """A ``ModelInferRequest`` of ``model``'s INPUT: ``images`` in band,
    or ``shm_in`` (region, shape) by reference; OUTPUT into ``shm_out``
    (region, bytes) or in band."""
    from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb

    req = pb.ModelInferRequest(model_name=model, id=request_id)
    t = req.inputs.add(name="INPUT", datatype="FP32")
    if shm_in is None:
        t.shape.extend(images.shape)
        req.raw_input_contents.append(np.ascontiguousarray(images).tobytes())
    else:
        region, shape = shm_in
        t.shape.extend(shape)
        t.parameters["shared_memory_region"].string_param = region
        t.parameters["shared_memory_byte_size"].int64_param = int(
            np.prod(shape)) * 4
    if shm_out is not None:
        out = req.outputs.add(name="OUTPUT")
        out.parameters["shared_memory_region"].string_param = shm_out[0]
        out.parameters["shared_memory_byte_size"].int64_param = shm_out[1]
    return req


def _vision_output(np, resp):
    out = resp.outputs[0]
    return np.frombuffer(resp.raw_output_contents[0], np.float32).reshape(
        list(out.shape))


def _np_row_rel_err(np, out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float((np.abs(out - ref).max(-1)
                  / np.maximum(np.abs(ref).max(-1), 1e-30)).max())


def _skip_last_conv(tv, model, params):
    """The planted fault: ``params`` with the last block's last
    convolution zeroed (the layer skipped), tensors otherwise shared."""
    faulty = tv.tree_map(lambda t: t, params)
    if "stages" in faulty:
        leaf = faulty["stages"][-1][-1]
        leaf["w3"] = leaf["w3"].new_zeros(leaf["w3"].shape)
    else:
        leaf = faulty["blocks"][-1][-1]
        leaf["w2"] = leaf["w2"].new_zeros(leaf["w2"].shape)
    return faulty


def _vision_model_check(torch, np, tv, models, core):
    """(a): each model's served bf16 logits against its float32 forward
    at batch 1 and 32, the planted fault caught; the image ensemble equal
    to resnet50 on RAW_IMAGE / 255 at each batch."""
    from tpuserver_torch.core import InferRequest

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for model in models:
            p32 = tv.tree_cast(model.params(), torch.float32)
            faulty = _skip_last_conv(tv, model, p32)
            for b in VISION_BATCHES:
                x = torch.rand((b,) + IMAGE, generator=gen, device="cuda")
                with torch.inference_mode():
                    served = model.logits(x)
                    ref = model.logits(x, p32)
                    bad = model.logits(x, faulty)
                err = row_rel_err(served, ref)
                fault = row_rel_err(bad, ref)
                log("vision (a): {} batch {}: bf16 logits vs float32 {:.6g} "
                    "(limit {}), planted fault {:.6g}, logits |max| "
                    "{:.4g}".format(model.name, b, err, VISION_TOL, fault,
                                    ref.abs().max().item()))
                if not err <= VISION_TOL or not fault > VISION_TOL:
                    fail("vision (a): {} batch {}: error {} planted fault {} "
                         "against the limit {}".format(model.name, b, err,
                                                       fault, VISION_TOL))
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    rng = np.random.RandomState(SEED)
    for b in VISION_BATCHES:
        raw = rng.randint(0, 256, (b,) + IMAGE, dtype=np.uint8)
        ens = core.infer(InferRequest("image_ensemble", inputs={
            "RAW_IMAGE": raw})).outputs[0][1]
        pixels = raw.astype(np.float32) / 255.0
        direct, again = (core.infer(InferRequest("resnet50", inputs={
            "INPUT": pixels})).outputs[0][1] for _ in range(2))
        err = _np_row_rel_err(np, ens, direct)
        # cuDNN's autotuned algorithms need not be deterministic (split
        # reductions): resnet50 run twice on the same input says whether
        # a last-bit difference is the ensemble's or the card's
        log("vision (a): image_ensemble vs resnet50 on RAW_IMAGE/255, batch "
            "{}: error {:.3g} (limit {}), bitwise equal {}; resnet50 twice "
            "on the same input bitwise equal {}".format(
                b, err, VISION_TOL, np.array_equal(ens, direct),
                np.array_equal(direct, again)))
        if err > VISION_TOL:
            fail("vision (a): the ensemble's answer differs from resnet50's "
                 "at batch {}: {}".format(b, err))


def _stats(port, model):
    status, body = _http_json(port, "GET",
                              "/v2/models/{}/stats".format(model))
    if status != 200:
        fail("stats of {}: {} {}".format(model, status, body))
    st = json.loads(body)["model_stats"][0]
    return st["inference_count"], st["execution_count"]


def _vision_batching(np, calls, port, images):
    """(b): 32 concurrent batch-1 requests over gRPC, then the same 32 in
    reverse order; each within VISION_TOL of the image served alone, and
    fewer executions than inferences."""
    import threading

    alone = [_vision_output(np, calls["ModelInfer"](_vision_infer_request(
        np, "resnet50", images[i:i + 1]), timeout=120))
        for i in range(len(images))]
    for order in ("forward", "reversed"):
        idx = list(range(len(images)))
        if order == "reversed":
            idx.reverse()
        got = [None] * len(images)
        barrier = threading.Barrier(len(images))

        def call(i):
            req = _vision_infer_request(np, "resnet50", images[i:i + 1])
            barrier.wait()
            got[i] = _vision_output(np, calls["ModelInfer"](req, timeout=120))

        inf0, exe0 = _stats(port, "resnet50")
        threads = [threading.Thread(target=call, args=(i,)) for i in idx]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        inf1, exe1 = _stats(port, "resnet50")
        errs = [_np_row_rel_err(np, g, a) for g, a in zip(got, alone)]
        log("vision (b) {}: {} requests in {} executions (mean batch "
            "{:.2f}), largest error against the lone answers {:.6g} (limit "
            "{})".format(order, inf1 - inf0, exe1 - exe0,
                         (inf1 - inf0) / max(exe1 - exe0, 1), max(errs),
                         VISION_TOL))
        if inf1 - inf0 != len(images) or not exe1 - exe0 < inf1 - inf0:
            fail("vision (b) {}: {} inferences in {} executions".format(
                order, inf1 - inf0, exe1 - exe0))
        if max(errs) > VISION_TOL:
            fail("vision (b) {}: batched answers off their lone answers: "
                 "{}".format(order, errs))
    return alone


def _memcpys(path):
    """(kind, bytes) of each host<->device copy in a chrome trace."""
    with open(path) as f:
        trace = json.load(f)
    out = []
    for ev in trace.get("traceEvents", []):
        name = ev.get("name", "")
        if ev.get("cat") == "gpu_memcpy" or name.startswith("Memcpy"):
            out.append((name, (ev.get("args") or {}).get("bytes")))
    return out


def _vision_zero_copy(torch, np, csm, calls, resnet, image, inband):
    """(c): the image in a CUDA region, the output into a second one,
    both registered over gRPC by raw handle: the model's input is a view
    inside the region, and the profiled request moves neither the image
    nor the output between host and device."""
    import base64

    from torch.profiler import ProfilerActivity, profile

    from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb

    region_in = csm.create_shared_memory_region("vision_in", IMAGE_BYTES)
    region_out = csm.create_shared_memory_region("vision_out", OUTPUT_BYTES)
    seen = []
    forward = resnet.forward

    def spy(INPUT):
        seen.append((INPUT.data_ptr(), INPUT.numel() * INPUT.element_size()))
        return forward(INPUT)

    try:
        csm.set_shared_memory_region(region_in, [torch.from_numpy(
            np.ascontiguousarray(image)).cuda()])
        for name, h in (("vision_in", region_in), ("vision_out", region_out)):
            calls["CudaSharedMemoryRegister"](pb.CudaSharedMemoryRegisterRequest(
                name=name, raw_handle=base64.b64decode(csm.get_raw_handle(h)),
                device_id=0, byte_size=h.byte_size), timeout=60)
        req = _vision_infer_request(np, "resnet50",
                                    shm_in=("vision_in", (1,) + IMAGE),
                                    shm_out=("vision_out", OUTPUT_BYTES))
        calls["ModelInfer"](req, timeout=120)  # settle
        resnet.forward = spy
        trace = os.path.join(HERE, "build", "vision_cuda_shm_trace.json")
        os.makedirs(os.path.dirname(trace), exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            resp = calls["ModelInfer"](req, timeout=120)
            torch.cuda.synchronize()
        resnet.forward = forward
        prof.export_chrome_trace(trace)
        copies = _memcpys(trace)
        base = region_in.tensor.data_ptr()
        inside = bool(seen) and all(
            base <= p and p + n <= base + region_in.byte_size
            for p, n in seen)
        host = [(k, n) for k, n in copies
                if "HtoD" in k or "DtoH" in k]
        of_tensors = [(k, n) for k, n in host
                      if n is None or n >= OUTPUT_BYTES]
        got = csm.get_contents_as_numpy(region_out, np.float32, [1, 1000])
        err = _np_row_rel_err(np, got, inband)
        params = resp.outputs[0].parameters
        log("vision (c): model input at 0x{:x} ({} bytes) inside the region "
            "[0x{:x}, +{}): {}; transfers during the request: {}; host<->"
            "device: {}; the region's answer vs in-band {:.6g}; response "
            "names region {!r}".format(
                seen[0][0] if seen else 0, seen[0][1] if seen else 0, base,
                region_in.byte_size, inside, copies or "none", host or "none",
                err, params["shared_memory_region"].string_param))
        if not inside:
            fail("vision (c): the model's input is not the region's memory: "
                 "{}".format(seen))
        if of_tensors:
            fail("vision (c): host<->device copies of the image or the "
                 "output: {}".format(of_tensors))
        if err > VISION_TOL or resp.raw_output_contents[0] != b"":
            fail("vision (c): region answer error {} or in-band bytes".format(
                err))
    finally:
        resnet.forward = forward
        for name in ("vision_in", "vision_out"):
            calls["CudaSharedMemoryUnregister"](
                pb.CudaSharedMemoryUnregisterRequest(name=name), timeout=60)
        csm.destroy_shared_memory_region(region_in)
        csm.destroy_shared_memory_region(region_out)


def _vision_fixtures(np, calls, port):
    """(d): the fixture models on the card's server, each exact."""
    import http.client

    from tpuserver_torch import tensor_io
    from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb

    in0 = np.arange(16, dtype=np.int32).reshape(1, 16)
    in1 = np.full((1, 16), 3, dtype=np.int32)
    want = [(in0 + in1).reshape(-1).tolist(), (in0 - in1).reshape(-1).tolist()]
    body = {"inputs": [{"name": n, "datatype": "INT32", "shape": [1, 16],
                        "data": a.reshape(-1).tolist()}
                       for n, a in (("INPUT0", in0), ("INPUT1", in1))]}
    status, data = _http_json(port, "POST", "/v2/models/simple/infer", body)
    outs = json.loads(data)["outputs"] if status == 200 else []
    json_ok = [o["data"] for o in outs] == want
    header = json.dumps({"inputs": [
        {"name": n, "datatype": "INT32", "shape": [1, 16],
         "parameters": {"binary_data_size": 64}} for n in ("INPUT0",
                                                           "INPUT1")],
        "parameters": {"binary_data_output": True}}).encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v2/models/simple/infer",
                     header + in0.tobytes() + in1.tobytes(),
                     {"Inference-Header-Content-Length": str(len(header))})
        resp = conn.getresponse()
        raw = resp.read()
        n = int(resp.getheader("Inference-Header-Content-Length"))
    finally:
        conn.close()
    binary_ok = np.frombuffer(raw[n:], np.int32).reshape(2, 16).tolist() \
        == want

    def grpc_infer(model, tensors, params=None):
        req = pb.ModelInferRequest(model_name=model)
        for name, datatype, shape, data in tensors:
            t = req.inputs.add(name=name, datatype=datatype)
            t.shape.extend(shape)
            req.raw_input_contents.append(data)
        for key, value in (params or {}).items():
            if isinstance(value, bool):
                req.parameters[key].bool_param = value
            else:
                req.parameters[key].int64_param = value
        return calls["ModelInfer"](req, timeout=60)

    s0 = np.array([str(v).encode() for v in range(16)], dtype=np.object_)
    s1 = np.array([b"5"] * 16, dtype=np.object_)
    resp = grpc_infer("simple_string", [
        (n, "BYTES", [1, 16], tensor_io.serialize_byte_tensor(a))
        for n, a in (("INPUT0", s0), ("INPUT1", s1))])
    strings = [tensor_io.deserialize_bytes_tensor(r).tolist()
               for r in resp.raw_output_contents]
    bytes_ok = strings == [[str(v + 5).encode() for v in range(16)],
                           [str(v - 5).encode() for v in range(16)]]
    bits = np.random.RandomState(SEED).randint(
        0, 1 << 16, (2, 64)).astype(np.uint16)
    resp = grpc_infer("identity_bf16",
                      [("INPUT0", "BF16", [2, 64], bits.tobytes())])
    bf16_ok = resp.raw_output_contents[0] == bits.tobytes() and \
        resp.outputs[0].datatype == "BF16"
    acc = []
    for i, v in enumerate((4, 10, -3)):
        resp = grpc_infer("sequence_accumulate", [
            ("INPUT", "INT32", [1], np.array([v], np.int32).tobytes())],
            {"sequence_id": 8008, "sequence_start": i == 0,
             "sequence_end": i == 2})
        acc.append(int(np.frombuffer(resp.raw_output_contents[0],
                                     np.int32)[0]))
    seq_ok = acc == [4, 14, 11]
    values = np.array([7, 8, 9, 10], np.int32)
    req = pb.ModelInferRequest(model_name="repeat_int32", id="rep")
    for name, datatype, arr in (("IN", "INT32", values),
                                ("DELAY", "UINT32", np.zeros(4, np.uint32)),
                                ("WAIT", "UINT32", np.zeros(1, np.uint32))):
        t = req.inputs.add(name=name, datatype=datatype)
        t.shape.extend(arr.shape)
        req.raw_input_contents.append(arr.tobytes())
    streamed = [int(np.frombuffer(r.infer_response.raw_output_contents[0],
                                  np.int32)[0])
                for r in calls["ModelStreamInfer"](iter([req]), timeout=60)]
    repeat_ok = streamed == values.tolist()
    checks = {"simple_json": json_ok, "simple_binary": binary_ok,
              "simple_string": bytes_ok, "identity_bf16": bf16_ok,
              "sequence_accumulate": seq_ok, "repeat_int32": repeat_ok}
    log("vision (d): fixtures on the card's server, exact: {}".format(
        json.dumps(checks)))
    if not all(checks.values()):
        fail("vision (d): fixture mismatch: {}".format(checks))


def _percentile(values, q):
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(round(q * (len(ordered) - 1))))]


def _vision_load(torch, np, csm, url, calls, image, plane, clients, per):
    """(e), in the load process: ``clients`` threads, each with its own
    channel, sending ``per`` timed batch-1 ResNet-50 requests back to
    back over gRPC (after one untimed), the image in band, in a system
    region or in a CUDA region of this process (written once, as
    perf_analyzer's shared-memory modes do; the server maps it over CUDA
    IPC), the output in band or into a region of the same kind.  Returns
    (infer/s, p50 ms, p99 ms)."""
    import base64
    import threading

    from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb

    regions, files, handles = [], [], []
    try:
        reqs = []
        for c in range(clients):
            if plane == "inband":
                reqs.append(_vision_infer_request(np, "resnet50",
                                                  image[None]))
                continue
            names = ("vis_{}_{}_in".format(plane, c),
                     "vis_{}_{}_out".format(plane, c))
            if plane == "system":
                for name, size in zip(names, (IMAGE_BYTES, OUTPUT_BYTES)):
                    key = "/tt_{}_{}".format(os.getpid(), name)
                    path = "/dev/shm" + key
                    with open(path, "wb") as f:
                        f.write(np.ascontiguousarray(image).tobytes()
                                if size == IMAGE_BYTES else bytes(size))
                    files.append(path)
                    calls["SystemSharedMemoryRegister"](
                        pb.SystemSharedMemoryRegisterRequest(
                            name=name, key=key, offset=0, byte_size=size),
                        timeout=60)
                    regions.append(("system", name))
            else:
                for name, size in zip(names, (IMAGE_BYTES, OUTPUT_BYTES)):
                    h = csm.create_shared_memory_region(name, size)
                    handles.append(h)
                    if size == IMAGE_BYTES:
                        csm.set_shared_memory_region(h, [image])
                    calls["CudaSharedMemoryRegister"](
                        pb.CudaSharedMemoryRegisterRequest(
                            name=name, raw_handle=base64.b64decode(
                                csm.get_raw_handle(h)),
                            device_id=0, byte_size=size), timeout=60)
                    regions.append(("cuda", name))
            reqs.append(_vision_infer_request(
                np, "resnet50", shm_in=(names[0], (1,) + IMAGE),
                shm_out=(names[1], OUTPUT_BYTES)))
        lat = [[] for _ in range(clients)]
        barrier = threading.Barrier(clients + 1)
        errors = []

        def client(c):
            channel, own = _grpc_calls(url)
            try:
                own["ModelInfer"](reqs[c], timeout=120)
                barrier.wait()
                for _ in range(per):
                    t0 = time.monotonic()
                    own["ModelInfer"](reqs[c], timeout=120)
                    lat[c].append((time.monotonic() - t0) * 1e3)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
                barrier.abort()
            finally:
                channel.close()

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        barrier.wait()
        t0 = time.monotonic()
        for t in threads:
            t.join(600)
        wall = time.monotonic() - t0
        if errors:
            fail("vision (e) {} x{}: {}".format(plane, clients, errors[:3]))
        every = [v for per_client in lat for v in per_client]
        return (len(every) / wall, _percentile(every, 0.5),
                _percentile(every, 0.99))
    finally:
        for kind, name in regions:
            if kind == "system":
                calls["SystemSharedMemoryUnregister"](
                    pb.SystemSharedMemoryUnregisterRequest(name=name),
                    timeout=60)
            else:
                calls["CudaSharedMemoryUnregister"](
                    pb.CudaSharedMemoryUnregisterRequest(name=name),
                    timeout=60)
        for path in files:
            os.unlink(path)
        for h in handles:
            csm.destroy_shared_memory_region(h)


def _time_forward_ms(torch, fn, iters, flush):
    """Mean device time of ``fn`` by CUDA events, each sample alone: the
    card held (``FORWARD_HOLD_CYCLES``) while the host enqueues it, after
    an L2 flush."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(FORWARD_HOLD_CYCLES)
        flush.sum(dtype=torch.int32)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def child_load(torch, np, url):
    """``--child-load <gRPC url>``: phase 8 (e)'s clients, in a process of
    their own (as a load generator would be, so client and server do not
    share an interpreter): every plane at every concurrency of
    ``VISION_LOAD``, then one ``LOAD <json>`` line."""
    from tpuserver_torch import cuda_shared_memory as csm

    image = np.random.RandomState(SEED + 8).rand(*IMAGE).astype(np.float32)
    channel, calls = _grpc_calls(url)
    out = {}
    try:
        for plane in ("inband", "system", "cuda"):
            for clients, per in VISION_LOAD:
                rate, p50, p99 = _vision_load(torch, np, csm, url, calls,
                                              image, plane, clients, per)
                out["{}_c{}".format(plane, clients)] = {
                    "infer_per_s": rate, "p50_ms": p50, "p99_ms": p99}
    finally:
        channel.close()
    print("LOAD " + json.dumps(out), flush=True)


def _vision_class(name):
    low = name.lower()
    if any(k in low for k in ("fprop", "conv", "implicit", "cudnn",
                              "winograd", "nhwckrsc", "xmma_fprop")):
        return "conv"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "cutlass")):
        # cuBLAS: the fc, and the 1x1 convolutions cuDNN hands to it
        return "gemm"
    if "pool" in low:
        return "pool"
    if "cat" in low:
        return "concat"
    if "pad" in low:
        return "pad"
    if "softmax" in low:
        return "softmax"
    if "reduce" in low:
        return "mean"
    if "elementwise" in low or "addcmul" in low or "relu" in low:
        return "elementwise"
    return "other"


def _forward_numbers(torch, fn, ops, nbytes, classify):
    """One forward's numbers: device time by CUDA events (L2 flushed, the
    card held while the host enqueues) against its bound (``ops`` at the
    bf16 tensor-core peak, ``nbytes`` at the memory rate), the median
    wall time of ``WALL_REPS``, and under torch.profiler the device time
    by kernel class (``classify(name)``) and the busy share."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    ms = _time_forward_ms(torch, fn, FORWARD_ITERS, flush)
    bound_ms, bound_by = _bound_ms(nbytes, ops, SPEC.peak_bf16_flops)
    walls = []
    for _ in range(WALL_REPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
    wall_ms = sorted(walls)[WALL_REPS // 2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_class, kernels, launches = {}, [], 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us <= 0 or not str(ev.device_type).endswith("CUDA"):
            continue
        cls = classify(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, ev.count, ev.key[:80]))
        launches += ev.count
    device_ms = sum(by_class.values())
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "gflop": ops / 1e9, "bytes": nbytes,
            "wall_ms": wall_ms, "wall_ms_samples": walls,
            "profiled_device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "device_launches": launches, "device_ms_by_class": by_class,
            "top_kernels": sorted(kernels, reverse=True)[:6]}


def _vision_forward_numbers(torch, models, smi):
    """(e): each model's forward at batch 1 and 32 (``_forward_numbers``;
    the bound's bytes: the weights, the images in, the logits out)."""
    from tpuserver_torch.models.tree import tree_leaves

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = {}
    for model in models:
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in tree_leaves(model.params()))
        for b in VISION_BATCHES:
            x = torch.rand((b,) + IMAGE, generator=gen, device="cuda")

            def fn():
                with torch.inference_mode():
                    return model.logits(x)

            key = "{}_b{}".format(model.name, b)
            row = out[key] = _forward_numbers(
                torch, fn, model.operations(b),
                weight_bytes + b * (IMAGE_BYTES + 1000 * 2), _vision_class)
            row["images_per_s"] = b / row["ms"] * 1e3
            log("vision (e) forward {}: {:.4f} ms device (events), bound "
                "{:.4f} ms ({}; {:.3f} GFLOP), {:.1f} images/s; wall {:.3f} "
                "ms, busy share {:.3f}, {} kernels; {}".format(
                    key, row["ms"], row["bound_ms"], row["bound_by"],
                    row["gflop"], row["images_per_s"], row["wall_ms"],
                    row["busy_share"] or 0, row["device_launches"], smi))
    log("vision (e) forwards: {}".format(json.dumps(out)))


def phase_vision(torch, np, smi):
    """Phase 8: the vision zoo and the fixture models behind HTTP and
    gRPC on a fresh core, bf16 at full width and depth, weights from the
    script's seed: (a) the model check, (b) dynamic batching, (c) a CUDA
    region in and out with no host copy, (d) the fixtures, (e) the
    numbers.  No kernel of the port may run on this path (it runs cuDNN
    and cuBLAS): their launch counts must stay 0."""
    from tpuserver_torch import cuda_shared_memory as csm
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.grpc_server import GrpcServer
    from tpuserver_torch.http_server import HttpServer
    from tpuserver_torch.models import default_models
    from tpuserver_torch.models import vision as tv
    from tpuserver_torch.models.tree import tree_leaves
    from tpuserver_torch.ops import flash as fl
    from tpuserver_torch.ops import quant

    t_start = time.monotonic()
    models = tv.vision_models(device="cuda", seed=SEED)
    resnet, densenet = models[0], models[1]
    core = InferenceServer(default_models() + models, ready=False)
    http = HttpServer(core, port=0).start()
    grpc_srv = GrpcServer(core, port=0).start()
    channel, calls = _grpc_calls(grpc_srv.url)
    try:
        t0 = time.monotonic()
        core.warmup()
        core.mark_ready()
        log("vision: warm-up of every bucket {} of both nets, on this "
            "thread and each batcher executor, {:.1f} s; "
            "weights {:.1f} MB (resnet50) and {:.1f} MB (densenet121); "
            "torch peak {:.3f} GiB".format(
                resnet.buckets(), time.monotonic() - t0,
                *(sum(t.numel() * t.element_size()
                      for t in tree_leaves(m.params())) / 1e6
                  for m in (resnet, densenet)),
                torch.cuda.max_memory_allocated() / 2 ** 30))
        fl.reset_launch_counts()
        quant.int8_matmul.launches = 0
        _vision_model_check(torch, np, tv, (resnet, densenet), core)
        rng = np.random.RandomState(SEED + 8)
        images = rng.rand(32, *IMAGE).astype(np.float32)
        alone = _vision_batching(np, calls, http.port, images)
        _vision_zero_copy(torch, np, csm, calls, resnet, images[0], alone[0])
        _vision_fixtures(np, calls, http.port)
        inf0, exe0 = _stats(http.port, "resnet50")
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child-load",
             grpc_srv.url], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, timeout=900)
        lines = [ln for ln in child.stdout.splitlines()
                 if ln.startswith("LOAD ")]
        if child.returncode != 0 or not lines:
            fail("vision (e): the load process exited {}: {} {}".format(
                child.returncode, child.stdout[-2000:],
                child.stderr[-2000:]))
        load = json.loads(lines[-1][len("LOAD "):])
        for key, row in load.items():
            plane, clients = key.rsplit("_c", 1)
            log("vision (e) ResNet-50 over gRPC, {} plane, concurrency {}: "
                "{:.1f} infer/s, p50 {:.3f} ms, p99 {:.3f} ms; {}".format(
                    plane, clients, row["infer_per_s"], row["p50_ms"],
                    row["p99_ms"], smi))
        inf, exe = _stats(http.port, "resnet50")
        log("vision (e) load process: {} inferences in {} executions (mean "
            "batch {:.2f})".format(inf - inf0, exe - exe0,
                                   (inf - inf0) / max(exe - exe0, 1)))
        log("vision (e) load: {}; resnet50 served {} inferences in {} "
            "executions (mean batch {:.2f})".format(
                json.dumps(load), inf, exe, inf / max(exe, 1)))
        torch.cuda.synchronize()
        launches = {"flash_attention": fl.flash_attention.launches,
                    "decode_attention": fl.decode_attention.launches,
                    "int8_matmul": quant.int8_matmul.launches}
        _vision_forward_numbers(torch, (resnet, densenet), smi)
        log("vision: the port's kernels launched on this path: {} (none "
            "expected: convolutions, pools and products are cuDNN's and "
            "cuBLAS's); phase {:.1f} s".format(
                json.dumps(launches), time.monotonic() - t_start))
        if any(launches.values()):
            fail("vision: a kernel of the llama path ran on the vision path: "
                 "{}".format(launches))
    finally:
        channel.close()
        grpc_srv.stop()
        http.stop()
        core.close()


# -- phase 9: the BERT ensemble (config #4) ------------------------------------

# bf16 pooler logits (before the tanh) against a float32 forward of the same
# weights, row-relative, at full width: 0.0101-0.0105 measured on the CPU
# over 8 rows; the last layer's MLP skipped moves them by 0.20-0.23 and the
# mask ignored a padded row by 0.79-1.26 (tests/test_torch_bert.py).  The
# same limit holds (b)'s streamed answers against the unary ones.
BERT_TOL = 1.5e-2
BERT_BATCHES = (1, 8)
BERT_SEQ = 128
BERT_D = 768
# (b), (c): distinct texts a pipelined stream carries at each in-flight depth
BERT_TEXTS = 100
BERT_INFLIGHT = (1, 16)
# (e): the park region of llama3_8b's whole KV cache at max_seq 4096 (bf16)
LLAMA_KV_BYTES = 512 << 20
BERT_WORDS = ("alpha", "brown", "crane", "delta", "ember", "frost", "grove",
              "heron")


def _bert_text(i):
    """bench_full.py's distinct text of request ``i``."""
    return "bench {} {} {}".format(i, BERT_WORDS[i % 8],
                                   BERT_WORDS[(i // 8) % 8]).encode()


def _bytes_contents(texts):
    """The raw wire bytes of a BYTES tensor: each element's 4-byte
    little-endian length, then its bytes."""
    import struct

    return b"".join(struct.pack("<I", len(t)) + t for t in texts)


def _bert_request(model, request_id, texts=None, ids=None, mask=None):
    """A ``ModelInferRequest``: ``texts`` as TEXT [n, 1] (the ensemble,
    the tokenizer), or ``ids`` and ``mask`` [n, 128] (the encoder)."""
    from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb

    req = pb.ModelInferRequest(model_name=model, id=request_id)
    if texts is not None:
        t = req.inputs.add(name="TEXT", datatype="BYTES")
        t.shape.extend([len(texts), 1])
        req.raw_input_contents.append(_bytes_contents(texts))
        return req
    for name, arr in (("INPUT_IDS", ids), ("ATTENTION_MASK", mask)):
        t = req.inputs.add(name=name, datatype="INT32")
        t.shape.extend(arr.shape)
        req.raw_input_contents.append(arr.astype("<i4").tobytes())
    return req


def _bert_outputs(np, resp):
    """{output name: array} of a ``ModelInferResponse``."""
    dtypes = {"FP32": np.float32, "INT32": np.int32}
    return {out.name: np.frombuffer(raw, dtypes[out.datatype]).reshape(
        list(out.shape))
        for out, raw in zip(resp.outputs, resp.raw_output_contents)}


def _bert_stream(np, calls, requests, inflight):
    """Send ``requests`` on ONE ``ModelStreamInfer`` stream with at most
    ``inflight`` of them unanswered (the next goes out as an answer comes
    back, bench_full.py's pipelined client).  Returns ({id: POOLED},
    {id: seconds from send to answer}, wall seconds)."""
    import queue

    pending = queue.Queue()
    sent = {}

    def feed():
        while True:
            req = pending.get()
            if req is None:
                return
            sent[req.id] = time.monotonic()
            yield req

    for req in requests[:inflight]:
        pending.put(req)
    nxt = inflight
    out, lat = {}, {}
    t0 = time.monotonic()
    for resp in calls["ModelStreamInfer"](feed(), timeout=600):
        if resp.error_message:
            fail("bert: stream request {} failed: {}".format(
                resp.infer_response.id, resp.error_message))
        r = resp.infer_response
        lat[r.id] = time.monotonic() - sent[r.id]
        out[r.id] = _bert_outputs(np, r)["POOLED"]
        if nxt < len(requests):
            pending.put(requests[nxt])
            nxt += 1
        elif len(out) == len(requests):
            pending.put(None)  # the request side ends; the stream follows
    return out, lat, time.monotonic() - t0


def _skip_last_mlp(params):
    """The planted fault: the last layer's MLP skipped (its output
    projection zeroed), tensors otherwise shared."""
    faulty = dict(params, layers=list(params["layers"]))
    last = dict(faulty["layers"][-1])
    last["w_out"] = last["w_out"].new_zeros(last["w_out"].shape)
    faulty["layers"][-1] = last
    return faulty


def _bert_inputs(torch, np, batch):
    """(a)'s rows on the card: ids in the tokenizer's range after [CLS];
    row 1 (the second) padded from token 40.  Batch 1 is row 0."""
    rng = np.random.RandomState(SEED + 9)
    ids = rng.randint(1000, 29000, (8, BERT_SEQ)).astype(np.int32)
    ids[:, 0] = 101
    mask = np.ones((8, BERT_SEQ), np.int32)
    mask[1, 40:] = 0
    ids[1, 40:] = 0
    ids[1, 39] = 102
    return (torch.from_numpy(ids[:batch]).cuda(),
            torch.from_numpy(mask[:batch]).cuda())


def _bert_model_check(torch, np, encoder):
    """(a): the served bf16 pooler logits against a float32 forward of the
    same weights (TF32 off) at batch 1 and 8, and two planted faults: the
    last layer's MLP skipped, and the mask ignored (it changes only the
    padded row).  The error must stay within ``BERT_TOL``; each fault
    must pass ten times it on the batch of 8, which holds both, and the
    first must pass ``BERT_TOL`` on the lone row too (one row's move
    varies 0.14-0.23 with the row, 8 rows' largest 0.20-0.23)."""
    from tpuserver_torch.models.tree import tree_cast

    p32 = tree_cast(encoder.params(), torch.float32)
    faulty = _skip_last_mlp(encoder.params())
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for b in BERT_BATCHES:
            ids, mask = _bert_inputs(torch, np, b)
            with torch.inference_mode():
                served = encoder.pooled_logits(ids, mask)
                ref = encoder.pooled_logits(ids, mask, params=p32)
                skipped = encoder.pooled_logits(ids, mask, params=faulty)
                unmasked = encoder.pooled_logits(
                    ids, torch.ones_like(mask)) if b > 1 else None
            err = row_rel_err(served, ref)
            pooled = row_rel_err(torch.tanh(served), torch.tanh(ref))
            faults = {"last_mlp_skipped": row_rel_err(skipped, ref)}
            if unmasked is not None:
                faults["mask_ignored_padded_row"] = row_rel_err(
                    unmasked[1], ref[1])
            log("bert (a): batch {}: bf16 pooler logits vs float32 {:.6g} "
                "(limit {}), POOLED (after the tanh) {:.6g}, planted "
                "faults {} ({} the limit), logits |max| {:.4g}, POOLED "
                "entries beyond 0.999 {:.3f}".format(
                    b, err, BERT_TOL, pooled, json.dumps(faults),
                    json.dumps({k: round(v / BERT_TOL, 2)
                                for k, v in faults.items()}),
                    ref.abs().max().item(),
                    (torch.tanh(ref).abs() > 0.999).float().mean().item()))
            if not err <= BERT_TOL:
                fail("bert (a): batch {}: bf16 error {} over the limit "
                     "{}".format(b, err, BERT_TOL))
            need = 10 * BERT_TOL if b > 1 else BERT_TOL
            small = {k: v for k, v in faults.items() if not v > need}
            if small:
                fail("bert (a): batch {}: planted faults within {} : "
                     "{}".format(b, need, small))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _bert_ensemble_check(np, calls):
    """(b), first half: ``bert_ensemble`` over one gRPC stream (7 texts
    alone and 8 at once) against ``bert_encoder`` on ``bert_tokenizer``'s
    output for the same texts, each by unary ``ModelInfer``."""
    groups = [[_bert_text(i)] for i in range(7)] + [
        [_bert_text(100 + i) for i in range(8)], [b""]]
    reqs = [_bert_request("bert_ensemble", str(i), texts=g)
            for i, g in enumerate(groups)]
    streamed, _, _ = _bert_stream(np, calls, reqs, len(reqs))
    worst, bitwise = 0.0, True
    for i, texts in enumerate(groups):
        tok = _bert_outputs(np, calls["ModelInfer"](_bert_request(
            "bert_tokenizer", "t{}".format(i), texts=texts), timeout=120))
        enc = _bert_outputs(np, calls["ModelInfer"](_bert_request(
            "bert_encoder", "e{}".format(i), ids=tok["INPUT_IDS"],
            mask=tok["ATTENTION_MASK"]), timeout=120))["POOLED"]
        got = streamed[str(i)]
        if got.shape != (len(texts), BERT_D) or not np.isfinite(got).all():
            fail("bert (b): ensemble answer {} of shape {} (finite {})".format(
                i, got.shape, np.isfinite(got).all()))
        worst = max(worst, _np_row_rel_err(np, got, enc))
        bitwise = bitwise and np.array_equal(got, enc)
    log("bert (b): bert_ensemble over one ModelStreamInfer stream ({} "
        "requests, batches 1 and 8) vs bert_encoder on bert_tokenizer's "
        "output: largest POOLED error {:.3g} (limit {}), bitwise equal "
        "{}".format(len(groups), worst, BERT_TOL, bitwise))
    if worst > BERT_TOL:
        fail("bert (b): the ensemble differs from the encoder on the "
             "tokenizer's output: {}".format(worst))


def child_bert(np, url):
    """``--child-bert <gRPC url>``: (b)'s and (c)'s client, in a process
    of its own: at each in-flight depth of ``BERT_INFLIGHT``, a pipelined
    stream of ``BERT_TEXTS`` distinct texts to ``bert_ensemble`` (after
    one untimed), its infer/s and p50/p99; then each text's unary
    ``ModelInfer`` answer, which every streamed answer must match.  Ends
    with one ``BERT <json>`` line."""
    channel, calls = _grpc_calls(url)
    out = {}
    try:
        offset = 0
        for inflight in BERT_INFLIGHT:
            texts = [_bert_text(offset + i) for i in range(BERT_TEXTS)]
            offset += BERT_TEXTS
            _bert_stream(np, calls, [_bert_request(
                "bert_ensemble", "warm", texts=[b"warm up"])], 1)
            reqs = [_bert_request("bert_ensemble", str(i), texts=[t])
                    for i, t in enumerate(texts)]
            got, lat, wall = _bert_stream(np, calls, reqs, inflight)
            ms = [v * 1e3 for v in lat.values()]
            worst, same = 0.0, 0
            for i, text in enumerate(texts):
                unary = _bert_outputs(np, calls["ModelInfer"](_bert_request(
                    "bert_ensemble", "u{}".format(i), texts=[text]),
                    timeout=120))["POOLED"]
                worst = max(worst, _np_row_rel_err(np, got[str(i)], unary))
                same += bool(np.array_equal(got[str(i)], unary))
            out["c{}".format(inflight)] = {
                "requests": len(got), "infer_per_s": len(got) / wall,
                "p50_ms": _percentile(ms, 0.5), "p99_ms": _percentile(ms, 0.99),
                "wall_s": wall, "vs_unary_max_err": worst,
                "bitwise_equal": same,
                "distinct_answers": len({got[k].tobytes() for k in got})}
    finally:
        channel.close()
    print("BERT " + json.dumps(out), flush=True)


def _bert_class(name):
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "nvjet", "cutlass", "xmma")):
        return "gemm"
    if "softmax" in low:
        return "softmax"
    if "gelu" in low:
        return "gelu"
    if "index" in low or "gather" in low or "embedding" in low:
        return "gather"
    if "reduce" in low:
        return "layernorm_stats"
    if "copy" in low or "cast" in low:
        return "copy_cast"
    if "elementwise" in low or "where" in low or "clamp" in low:
        return "elementwise"
    return "other"


def _bert_forward_numbers(torch, np, encoder, smi):
    """(c): the encoder's forward at batch 1 and 8 (``_forward_numbers``;
    the bound's bytes: the weights read whole, one gathered table row a
    token, the ids and mask in, POOLED out)."""
    weight_bytes = encoder.weight_bytes()
    out = {}
    for b in BERT_BATCHES:
        ids, mask = _bert_inputs(torch, np, b)

        def fn():
            with torch.inference_mode():
                return encoder.forward(ids, mask)

        key = "bert_encoder_b{}".format(b)
        row = out[key] = _forward_numbers(
            torch, fn, encoder.operations(b),
            weight_bytes + b * (BERT_SEQ * BERT_D * 2 + 2 * BERT_SEQ * 4
                                + BERT_D * 4), _bert_class)
        row["sequences_per_s"] = b / row["ms"] * 1e3
        log("bert (c) forward {}: {:.4f} ms device (events), bound {:.4f} ms "
            "({}; {:.3f} GFLOP, {} bytes), {:.1f} sequences/s; wall {:.3f} "
            "ms, busy share {:.3f}, {} kernels; by class {}; {}".format(
                key, row["ms"], row["bound_ms"], row["bound_by"],
                row["gflop"], row["bytes"], row["sequences_per_s"],
                row["wall_ms"], row["busy_share"] or 0,
                row["device_launches"], json.dumps(row["device_ms_by_class"]),
                smi))
    log("bert (c) forwards: {}".format(json.dumps(out)))


def _bert_bad_ids(np, port):
    """(d): ``bert_encoder`` over HTTP with ids -1, 30522 and 10**6 in a
    row answers 200, equal to the same request with them clamped as JAX
    clamps them (30521 each), and the next request still succeeds: the
    CUDA context survived."""
    ids, mask = [0] * BERT_SEQ, [1] * BERT_SEQ
    ids[:6] = [101, -1, 30522, 10 ** 6, 2000, 102]

    def infer(row):
        body = {"inputs": [
            {"name": "INPUT_IDS", "datatype": "INT32", "shape": [1, BERT_SEQ],
             "data": row},
            {"name": "ATTENTION_MASK", "datatype": "INT32",
             "shape": [1, BERT_SEQ], "data": mask}]}
        status, raw = _http_json(port, "POST", "/v2/models/bert_encoder/infer",
                                 body)
        data = json.loads(raw) if status == 200 else raw[:300]
        return status, (np.asarray(data["outputs"][0]["data"], np.float32)
                        if status == 200 else data)

    bad_status, bad = infer(ids)
    clamped = list(ids)
    clamped[1:4] = [30521, 30521, 30521]
    ok_status, ref = infer(clamped)
    next_status, nxt = infer([101, 3000, 102] + [0] * (BERT_SEQ - 3))
    log("bert (d): ids -1, 30522, 10**6 -> {} (clamped request {}, equal "
        "{}); the next request -> {} (finite {})".format(
            bad_status, ok_status,
            bad_status == ok_status == 200 and np.array_equal(bad, ref),
            next_status, next_status == 200 and bool(np.isfinite(nxt).all())))
    if not (bad_status == ok_status == next_status == 200
            and np.array_equal(bad, ref) and np.isfinite(nxt).all()):
        fail("bert (d): out-of-range ids: {} {} {}".format(
            bad_status, ok_status, next_status))


def _bert_ensemble_json(np, port, text):
    """``bert_ensemble``'s POOLED for ``text`` over HTTP /infer."""
    body = {"inputs": [{"name": "TEXT", "datatype": "BYTES", "shape": [1, 1],
                        "data": [text]}]}
    status, raw = _http_json(port, "POST", "/v2/models/bert_ensemble/infer",
                             body)
    if status != 200:
        fail("bert (e): bert_ensemble answered {}: {}".format(status,
                                                             raw[:300]))
    return np.asarray(json.loads(raw)["outputs"][0]["data"], np.float32)


def _bert_serve_py(np, port):
    """(e): ``serve.py --models bert`` as a process on the card (no
    ``--device``: the card; the script's seed, so this phase's weights)
    answers ``bert_ensemble`` as this phase's server on ``port`` does,
    then stops on SIGINT."""
    import signal
    import threading

    own = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpuserver_torch.serve", "--models", "bert",
         "--port", str(own), "--seed", str(SEED)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src", "python")))
    watchdog = threading.Timer(300, proc.kill)
    watchdog.start()
    try:
        t0 = time.monotonic()
        line = proc.stdout.readline()
        while line and "serving" not in line:
            line = proc.stdout.readline()
        if "bert_ensemble" not in line:
            fail("bert (e): serve.py --models bert never served: {!r}".format(
                line))
        text = "served by serve.py alpha brown"
        got = _bert_ensemble_json(np, own, text)
        want = _bert_ensemble_json(np, port, text)
        err = _np_row_rel_err(np, got[None], want[None])
        log("bert (e): serve.py --models bert on the card, ready in {:.1f} "
            "s: {}; its bert_ensemble vs this phase's server {:.3g} (limit "
            "{}), bitwise equal {}".format(
                time.monotonic() - t0, line.strip(), err, BERT_TOL,
                np.array_equal(got, want)))
        if err > BERT_TOL:
            fail("bert (e): serve.py's answer differs: {}".format(err))
    finally:
        watchdog.cancel()
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _example(script, argv, label="bert (e)"):
    """Run an example of ``src/python/examples`` as a process; returns
    its output after checking its PASS line.  The output goes through
    files: a pipe would stay open while any process the example started
    lives."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src", "python"))
    with tempfile.TemporaryFile("w+") as out, \
            tempfile.TemporaryFile("w+") as err:
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "src", "python", "examples",
                                          script)] + argv,
            stdout=out, stderr=err, text=True, timeout=600, env=env)
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
    passed = [ln for ln in stdout.splitlines() if ln.startswith("PASS")]
    log("{}: {} {} -> exit {}: {}".format(
        label, script, " ".join(argv), proc.returncode, passed))
    if proc.returncode != 0 or not passed:
        fail("{}: {} {} failed: {} {}".format(
            label, script, argv, stdout[-2000:], stderr[-2000:]))
    return stdout


def _bert_clients(core, url):
    """(e): the CUDA-region example clients as processes against this
    phase's gRPC front end: ``simple_grpc_cudashm_client.py`` on the
    fixtures, then ``llama_streaming_cudashm_client.py`` in ring and in
    KV-park mode on a ``llama3_8b`` registered with the same core (drawn
    again from the script's seed: phase 4's weights were released for
    phase 4g).  Returns the kernel launches of the llama runs and the
    model, whose weights phase 12 serves again."""
    from tpuserver_torch.models import llama
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel
    from tpuserver_torch.ops import flash as fl

    _example("simple_grpc_cudashm_client.py", ["-u", url])
    t0 = time.monotonic()
    model = LlamaGenerateModel(cfg=llama.PRESETS["llama3_8b"](),
                               max_seq=4096, seed=SEED, device="cuda")
    core.register_model(model)
    fl.reset_launch_counts()
    ring = _example("llama_streaming_cudashm_client.py",
                    ["-u", url, "--mode", "ring", "-n", "16"])
    park = _example("llama_streaming_cudashm_client.py",
                    ["-u", url, "--mode", "kv-park", "-n", "16",
                     "--kv-bytes", str(LLAMA_KV_BYTES)])
    launches = {"flash_attention": fl.flash_attention.launches,
                "decode_attention": fl.decode_attention.launches}
    ring_tokens = [ln for ln in ring.splitlines()
                   if ln.startswith("ring tokens:")]
    log("bert (e): llama3_8b over CUDA regions: {}; {}; launches {}; "
        "{:.1f} s with the draw".format(
            ring_tokens, [ln for ln in park.splitlines()
                          if ln.startswith(("first:", "resumed:"))],
            json.dumps(launches), time.monotonic() - t0))
    return launches, model


def phase_bert(torch, np, smi):
    """Phase 9: the BERT ensemble and the fixture models behind HTTP and
    gRPC on a fresh core, bf16 at full width (BERT-base, weights from the
    script's seed): (a) the model check, (b) the ensemble over a stream,
    (c) the numbers, (d) out-of-range ids, (e) ``serve.py --models
    bert`` and the CUDA-region example clients.  No kernel of the port may run on (a)-(d): the encoder is
    cuBLAS and elementwise torch; (e)'s llama runs are counted apart.
    Returns (e)'s launch counts and its ``llama3_8b`` model."""
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.grpc_server import GrpcServer
    from tpuserver_torch.http_server import HttpServer
    from tpuserver_torch.models import bert as tb
    from tpuserver_torch.models import default_models
    from tpuserver_torch.ops import flash as fl
    from tpuserver_torch.ops import quant

    t_start = time.monotonic()
    models = tb.bert_models(device="cuda", seed=SEED)
    encoder = models[1]
    core = InferenceServer(default_models() + models, ready=False)
    http = HttpServer(core, port=0).start()
    grpc_srv = GrpcServer(core, port=0).start()
    channel, calls = _grpc_calls(grpc_srv.url)
    try:
        t0 = time.monotonic()
        core.warmup()
        core.mark_ready()
        log("bert: warm-up (batch 1 and 8) {:.1f} s; weights {:.1f} MB read "
            "whole a forward plus a {:.1f} MB token table; torch peak {:.3f} "
            "GiB".format(time.monotonic() - t0, encoder.weight_bytes() / 1e6,
                         encoder.params()["tok_embed"].numel() * 2 / 1e6,
                         torch.cuda.max_memory_allocated() / 2 ** 30))
        fl.reset_launch_counts()
        quant.int8_matmul.launches = 0
        _bert_model_check(torch, np, encoder)
        _bert_ensemble_check(np, calls)
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child-bert",
             grpc_srv.url], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, timeout=900)
        lines = [ln for ln in child.stdout.splitlines()
                 if ln.startswith("BERT ")]
        if child.returncode != 0 or not lines:
            fail("bert (b): the client process exited {}: {} {}".format(
                child.returncode, child.stdout[-2000:],
                child.stderr[-2000:]))
        load = json.loads(lines[-1][len("BERT "):])
        for key, row in sorted(load.items()):
            log("bert (b) stream of {} distinct texts, {} in flight: each "
                "answer vs its unary ModelInfer answer, largest error {:.3g} "
                "(limit {}), bitwise equal {}/{}, {} distinct answers".format(
                    row["requests"], key[1:], row["vs_unary_max_err"],
                    BERT_TOL, row["bitwise_equal"], row["requests"],
                    row["distinct_answers"]))
            log("bert (c) bert_ensemble over a gRPC stream, {} in flight: "
                "{:.1f} infer/s, p50 {:.3f} ms, p99 {:.3f} ms; {}".format(
                    key[1:], row["infer_per_s"], row["p50_ms"],
                    row["p99_ms"], smi))
            if row["vs_unary_max_err"] > BERT_TOL or \
                    row["requests"] < BERT_TEXTS:
                fail("bert (b): streamed answers vs unary: {}".format(row))
        log("bert (c) load: {}".format(json.dumps(load)))
        torch.cuda.synchronize()
        _bert_forward_numbers(torch, np, encoder, smi)
        _bert_bad_ids(np, http.port)
        launches = {"flash_attention": fl.flash_attention.launches,
                    "decode_attention": fl.decode_attention.launches,
                    "int8_matmul": quant.int8_matmul.launches}
        log("bert: the port's kernels launched on (a)-(d): {} (none "
            "expected: the encoder's products are cuBLAS's); {:.1f} s".format(
                json.dumps(launches), time.monotonic() - t_start))
        if any(launches.values()):
            fail("bert: a kernel of the llama path ran on the BERT path: "
                 "{}".format(launches))
        _bert_serve_py(np, http.port)
        client_launches, llama_model = _bert_clients(core, grpc_srv.url)
        log("bert: phase {:.1f} s; torch peak {:.3f} GiB".format(
            time.monotonic() - t_start,
            torch.cuda.max_memory_allocated() / 2 ** 30))
        return client_launches, llama_model
    finally:
        channel.close()
        grpc_srv.stop()
        http.stop()
        core.close()


# -- phase 5: model check ----------------------------------------------------


def phase_model_check(torch, model, prompt):
    """Prefill logits and greedy tokens through the kernels against the
    same weights through the plain attention paths, on the card."""
    import dataclasses

    from tpuserver_torch.models import llama

    params = model._ensure_params()
    cfg_kernel = model._cfg
    cfg_plain = dataclasses.replace(cfg_kernel, attn_impl="dense",
                                    decode_impl="dense")
    tokens = torch.tensor(prompt, dtype=torch.long, device="cuda")[None, :]
    results = {}
    with torch.inference_mode():
        for name, cfg in (("kernel", cfg_kernel), ("plain", cfg_plain)):
            cache = llama.init_kv_cache(cfg, 1, 4096, "cuda")
            logits, cache = llama.prefill(params, cache, tokens, cfg)
            toks, _, _, _ = llama.decode_chunk(
                params, cache, logits, tokens.shape[1], cfg, 16)
            results[name] = (logits, toks[:, 0].tolist())
            del cache
    lk, tk = results["kernel"]
    lp, tp = results["plain"]
    if not (torch.isfinite(lk).all() and lk.shape == (1, cfg_kernel.vocab)):
        fail("kernel-path logits not finite or of the wrong shape")
    err = (lk - lp).abs().max().item()
    agree = sum(a == b for a, b in zip(tk, tp))
    log("model check: last-position logits max |kernel - plain| = {:.4g} "
        "(tolerance {}), logits range [{:.3f}, {:.3f}], first 16 greedy "
        "tokens agree: {}/16".format(err, LOGITS_TOL, lp.min().item(),
                                    lp.max().item(), agree))
    if not err <= LOGITS_TOL:
        fail("kernel-path logits differ from the plain path by {}".format(
            err))


# -- phase 6: where the time goes --------------------------------------------


def _kernel_class(name):
    if "w8a16" in name:
        return "int8_matmul"
    if "decode_attention" in name:
        return "decode_attention"
    if "flash_attention" in name:
        return "flash_attention"
    low = name.lower()
    if "indexselect" in low or "vectorized_gather" in low:
        # the paged step's per-layer gather of each row's pages
        # (index_select, two launches a layer); the embedding lookup of
        # the step's 8 tokens (one launch, 64 KB) lands here too
        return "page_gather"
    if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "matmul")):
        return "matmul"
    return "other"


def phase_profile(torch, model, prompt, batched_steps, label="profile"):
    """One 512-token prefill and one 8-token decode chunk of the served
    model, and ``batched_steps`` (name -> function: one batched paged
    step, and four in the scheduler's pipeline, fetched): wall time (no
    profiler; the median of ``WALL_REPS`` runs, each kept), device kernel
    time by class and the top kernels
    (torch.profiler), and the device's busy share, logged under
    ``label`` and returned."""
    from tpuserver_torch.models import llama

    params, cfg = model._ensure_params(), model._cfg
    tokens = torch.tensor(prompt, dtype=torch.long, device="cuda")[None, :]
    with torch.inference_mode():
        cache = llama.init_kv_cache(cfg, 1, 4096, "cuda")
        logits, _ = llama.prefill(params, cache, tokens, cfg)
        out = _profile_fns(torch, {
            "prefill_512": lambda: llama.prefill(params, cache, tokens, cfg),
            "decode_chunk_8": lambda: llama.decode_chunk(
                params, cache, logits, tokens.shape[1], cfg, 8),
            **batched_steps,
        })
        del cache
    log(label + ":", json.dumps(out))
    if not any(v["device_ms"] > 0 for v in out.values()):
        log(label + ": torch.profiler recorded no device time")
    return out


def _profile_fns(torch, steps, classify=_kernel_class, reps=WALL_REPS,
                 warm=True):
    """Each of ``steps`` (name -> function): its wall time (no profiler;
    the median of ``reps`` runs, each kept, after one warm-up run unless
    ``warm`` is False), its device kernel time by ``classify``'s class
    and the top kernels (torch.profiler), and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with torch.inference_mode():
        for name, fn in steps.items():
            if warm:
                fn()
            # the host's clock moves far more than device time between
            # machines: keep every sample, rate by the median
            walls = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                fn()
                torch.cuda.synchronize()
                walls.append((time.monotonic() - t0) * 1e3)
            wall_ms = sorted(walls)[reps // 2]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            # the raw events, summed by name here: the profiler's own
            # averages build a Python object an event, seconds for the
            # thousands of launches of a decode chunk
            by_name = {}
            for ev in prof.profiler.kineto_results.events():
                if not str(ev.device_type()).endswith("CUDA") or \
                        ev.duration_ns() <= 0:
                    continue
                ms, count = by_name.get(ev.name(), (0.0, 0))
                by_name[ev.name()] = (ms + ev.duration_ns() / 1e6, count + 1)
            by_class = {}
            for key, (ms, _) in by_name.items():
                cls = classify(key)
                by_class[cls] = by_class.get(cls, 0.0) + ms
            kernels = sorted((ms, count, key[:80])
                             for key, (ms, count) in by_name.items())
            device_ms = sum(by_class.values())
            out[name] = {
                "wall_ms": wall_ms, "wall_ms_samples": walls,
                "device_ms": device_ms,
                "busy_share": device_ms / wall_ms if wall_ms else None,
                "device_ms_by_class": by_class,
                "top_kernels": kernels[::-1][:6]}
    return out


# -- phase 10: tensor-parallel serving ---------------------------------------


def _tp_world(n, backend):
    """Ranks 1 .. n-1 spawned as followers of this process (rank 0, the
    driver) on the one card; ``backend`` carries the collectives."""
    from tpuserver_torch.parallel import MeshConfig, spmd

    store = os.path.join(HERE, "build", "tp_store", "{}-{}-{}".format(
        os.getpid(), n, time.monotonic_ns()))
    os.makedirs(os.path.dirname(store), exist_ok=True)
    t0 = time.monotonic()
    mesh, followers = spmd.start(n, store, device="cuda", backend=backend,
                                 config=MeshConfig(tp=n),
                                 timeout_s=TP_TIMEOUT_S)
    log("tp: {} rank(s) over {} on one card up in {:.1f} s".format(
        n, backend, time.monotonic() - t0))
    return mesh, followers


def _tp_close(torch, mesh, followers):
    from tpuserver_torch.parallel import spmd

    codes = spmd.shutdown(mesh, followers, timeout=60)
    gc.collect()
    torch.cuda.empty_cache()
    if any(codes):
        fail("tp followers exited with {}".format(codes))


def _tp_reports(mesh, **resets):
    """Every rank's ``spmd.rank_report`` (launches, memory), tp order."""
    from tpuserver_torch.parallel import spmd

    return spmd.mirror(mesh).gather(spmd.rank_report, **resets)


def _tp_launches(mesh):
    """Each kernel's launches on every rank since the last reset."""
    reports = _tp_reports(mesh)
    return {k: [r["launches"][k] for r in reports]
            for k in ("flash_attention", "decode_attention", "int8_matmul")}


def _gib(reports, key):
    return [round(r[key] / 2 ** 30, 3) for r in reports]


@contextlib.contextmanager
def _served(model):
    """``model`` behind a fresh core and HTTP server; yields the port."""
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.http_server import HttpServer

    core = InferenceServer([model])
    http = HttpServer(core, port=0).start()
    try:
        yield http.port
    finally:
        http.stop()
        core.close()


def _tp_forced_logits(torch, np, llama, mesh, cfg, params, prompt, tokens):
    """The prefill logits of ``prompt`` and the decode logits after
    feeding each of ``tokens`` (teacher forcing), [1 + len(tokens),
    vocab] float32, through ``make_tp_serving`` and ``make_tp_step``."""
    init_cache, prefill_fn, _ = llama.make_tp_serving(mesh, cfg)
    step = llama.make_tp_step(mesh, cfg)
    with torch.inference_mode():
        cache = init_cache(1, 4096)
        logits, cache = prefill_fn(params, cache, np.asarray(prompt)[None, :])
        rows = [logits[0].clone()]
        for i, t in enumerate(tokens):
            logits, cache = step(params, cache, np.array([t]),
                                 len(prompt) + i)
            rows.append(logits[0].clone())
    return torch.stack(rows)


def _sse_tokens(port, prompt, max_tokens, parameters):
    status, events, final, _ = _sse(port, prompt, max_tokens,
                                    parameters=parameters)
    if status != 200 or not final:
        fail("generate_stream answered {} (final {}): {}".format(
            status, final, events))
    return [e[1] for e in events]


def _tp_class(name):
    # the gloo collectives' staging through host memory
    return "collective_copy" if "memcpy" in name.lower() else _kernel_class(
        name)


def phase_tp(torch, np, single, prompts, budgets, tokens_4b):
    """Tensor-parallel serving of ``llama3_8b`` (full width, ``max_seq``
    4096, the seed's weights, each rank drawing every leaf and keeping its
    slice).  (a) tp=1 over NCCL at full depth:
    ``LlamaGenerateModel(mesh=)`` single-stream on phase 4's two prompts
    and ``max_slots=8`` on 4b's 12, bitwise phase 4's and 4b's tokens;
    then, at depth ``TP4_LAYERS``, the logits of the 512-token prompt and
    of ``TP_FORCED_STEPS`` steps teacher-forced with phase 4's tokens kept
    as the reference.  (b)-(d) run at depth ``TP4_LAYERS``.  (b) tp=4,
    four ranks sharing the card over gloo: those logits within
    ``TP_LOGITS_TOL`` of the reference, layer 0's wo all-reduce dropped
    ten times beyond it; the prompt served for ``TP_SINGLE_TOKENS``
    tokens and again for ``TP_REPEAT_TOKENS`` (the same tokens); a
    prefill's and an 8-token chunk's wall time and rank 0's device time
    by class; 4b's 12 requests, budgets capped at ``TP_BATCHED_BUDGET``,
    at ``max_slots=8`` both ways (same tokens per prompt); each rank's
    memory.  (c) int8 at
    tp=4: ``TP_INT8_TOKENS`` tokens twice, the same, the W8A16 kernel
    launched on every rank.  (d) a tp=4 generation parked in a
    CUDA region (full layout) resumed at tp=4, bitwise the unparked
    continuation, and attached at tp=1, its logits within the tolerance
    of tp=4's.  Returns each path's launches by rank."""
    from tpuserver_torch import cuda_shared_memory as csm
    from tpuserver_torch.models import llama
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel
    from tpuserver_torch.parallel import spmd

    t_phase = time.monotonic()
    cfg = llama.llama3_8b()
    long_prompt, long_tokens = single["long"]
    short_prompt, short_tokens = single["short"]
    paths = {}
    log("tp: this process holds {:.3f} GiB before phase 10".format(
        torch.cuda.memory_allocated() / 2 ** 30))

    # (a) tp=1 over NCCL: every line of the TP path, trivial collectives
    mesh, followers = _tp_world(1, "nccl")
    model = LlamaGenerateModel(cfg=cfg, max_seq=4096, seed=SEED, mesh=mesh)
    t0 = time.monotonic()
    model.warmup()
    torch.cuda.synchronize()
    log("tp1: weights drawn in {:.1f} s".format(time.monotonic() - t0))
    params = model._ensure_params()
    with _served(model) as port:
        _tp_reports(mesh, reset_launches=True)
        got_long = _stream(port, long_prompt, len(long_tokens))[0]
        got_short = _stream(port, short_prompt, len(short_tokens))[0]
        paths["tp1_single"] = _tp_launches(mesh)
    batched = LlamaGenerateModel(cfg=cfg, max_seq=4096, max_slots=8,
                                 params=params, mesh=mesh)
    with _served(batched) as port:
        _tp_reports(mesh, reset_launches=True)
        results, wall = _batched_round(port, prompts, budgets, range(12))
        paths["tp1_batched"] = _tp_launches(mesh)
    same = sum(results[i][0] == tokens_4b[i] for i in range(12))
    log("tp1: single-stream tokens equal phase 4's: {} and {}; batched "
        "equal phase 4b's: {}/12 ({:.1f} s round); launches {}".format(
            got_long == long_tokens, got_short == short_tokens, same, wall,
            json.dumps(paths)))
    if got_long != long_tokens or got_short != short_tokens or same != 12:
        fail("tp=1 tokens differ from the unsharded model's")
    del model, batched, params
    # tp=4's depth, drawn from the same seed as tp=4 draws it
    cfg = dataclasses.replace(cfg, n_layers=TP4_LAYERS)
    params = llama.tp_params(mesh, cfg, seed=SEED)
    reference = _tp_forced_logits(torch, np, llama, mesh, cfg, params,
                                  long_prompt, long_tokens[:TP_FORCED_STEPS])
    if not (torch.isfinite(reference).all()
            and reference.shape == (TP_FORCED_STEPS + 1, cfg.vocab)):
        fail("tp=1 logits not finite or of the wrong shape")
    del params
    _tp_close(torch, mesh, followers)

    # (b) tp=4: four ranks sharing the card, gloo through host memory
    mesh, followers = _tp_world(TP_RANKS, "gloo")
    mirror = spmd.mirror(mesh)
    _tp_reports(mesh, reset_peak=True)
    model = LlamaGenerateModel(cfg=cfg, max_seq=4096, seed=SEED, mesh=mesh)
    t0 = time.monotonic()
    model.warmup()
    load_s = time.monotonic() - t0
    load = _tp_reports(mesh, reset_peak=True)
    params = model._ensure_params()
    log("tp4 (depth {}): weights drawn in {:.1f} s; GiB by rank: held {}, "
        "draw peak {}".format(cfg.n_layers, load_s,
                              _gib(load, "allocated_bytes"),
                              _gib(load, "peak_bytes")))
    forced = _tp_forced_logits(torch, np, llama, mesh, cfg, params,
                               long_prompt, long_tokens[:TP_FORCED_STEPS])
    err_prefill = row_rel_err(forced[:1], reference[:1])
    err_decode = row_rel_err(forced[1:], reference[1:])
    init_cache, prefill_fn, decode_fn = llama.make_tp_serving(mesh, cfg)
    mirror.call(llama.tp_plant_fault, TP_FAULT_LAYER, tp=spmd.LOCAL)
    try:
        with torch.inference_mode():
            faulty, _ = prefill_fn(params, init_cache(1, 4096),
                                   long_prompt[None, :])
    finally:
        mirror.call(llama.tp_plant_fault, None, tp=spmd.LOCAL)
    err_fault = row_rel_err(faulty, reference[:1])
    del faulty
    log("tp4 logits vs the unsharded model (row-relative, tolerance {}): "
        "prefill {}, {} teacher-forced decode steps {}; layer {}'s wo "
        "all-reduce dropped: {} ({:.1f}x the tolerance)".format(
            TP_LOGITS_TOL, err_prefill, TP_FORCED_STEPS, err_decode,
            TP_FAULT_LAYER, err_fault, err_fault / TP_LOGITS_TOL))
    if not max(err_prefill, err_decode) <= TP_LOGITS_TOL:
        fail("tp=4 logits differ from the unsharded model's")
    if not err_fault >= 10 * TP_LOGITS_TOL:
        fail("the planted fault moves the logits less than ten times the "
             "tolerance")
    with _served(model) as port:
        _tp_reports(mesh, reset_launches=True)
        served = [_stream(port, long_prompt, n)
                  for n in (TP_SINGLE_TOKENS, TP_REPEAT_TOKENS)]
        paths["tp4_single"] = _tp_launches(mesh)
    tp4_tokens = served[0][0]
    repeat_same = served[1][0] == tp4_tokens[:TP_REPEAT_TOKENS]
    log("tp4 single: {} tokens, ttft {} ms, decode {} tokens/s; a "
        "repeat's {} tokens identical {}; launches {}".format(
            len(tp4_tokens), [round(r[1] * 1e3, 1) for r in served],
            [round(r[2], 2) for r in served], TP_REPEAT_TOKENS, repeat_same,
            json.dumps(paths["tp4_single"])))
    if not repeat_same or len(tp4_tokens) != TP_SINGLE_TOKENS:
        fail("tp=4 repeat gave other tokens")
    with torch.inference_mode():
        cache = init_cache(1, 4096)
        logits, _ = prefill_fn(params, cache, long_prompt[None, :])
        times = _profile_fns(torch, {
            "prefill_512": lambda: prefill_fn(params, cache,
                                              long_prompt[None, :]),
            "decode_chunk_8": lambda: decode_fn(params, cache, logits,
                                                len(long_prompt))},
            classify=_tp_class, reps=TP_WALL_REPS, warm=False)
        del cache, logits
    log("tp4 profile (gloo through host, four ranks sharing one card; "
        "rank 0's device time):", json.dumps(times))
    batched = LlamaGenerateModel(cfg=cfg, max_seq=4096, max_slots=8,
                                 params=params, mesh=mesh)
    capped = [min(n, TP_BATCHED_BUDGET) for n in budgets]
    with _served(batched) as port:
        _tp_reports(mesh, reset_launches=True)
        fwd, fwd_s = _batched_round(port, prompts, capped, range(12))
        rev, rev_s = _batched_round(port, prompts, capped,
                                    range(11, -1, -1))
        paths["tp4_batched"] = _tp_launches(mesh)
    serving = _tp_reports(mesh)
    same = [fwd[i][0] == rev[i][0] for i in range(12)]
    log("tp4 batched ({} tokens a request): rounds {:.1f} s and {:.1f} s; "
        "rows identical across arrival orders {}/12; launches {}; GiB by "
        "rank: held {}, serving peak {}".format(
            TP_BATCHED_BUDGET, fwd_s, rev_s, sum(same),
            json.dumps(paths["tp4_batched"]),
            _gib(serving, "allocated_bytes"), _gib(serving, "peak_bytes")))
    if not all(same):
        fail("tp=4: a prompt streamed other tokens in reverse order")
    del batched

    # (c) int8 at tp=4: each full leaf quantized, then sharded
    qmodel = LlamaGenerateModel(cfg=cfg, max_seq=4096, seed=SEED, mesh=mesh,
                                quantize=True)
    t0 = time.monotonic()
    qmodel.warmup()
    log("tp4 int8: weights drawn and quantized in {:.1f} s".format(
        time.monotonic() - t0))
    with _served(qmodel) as port:
        _tp_reports(mesh, reset_launches=True)
        qruns = [_stream(port, long_prompt, TP_INT8_TOKENS)[0]
                 for _ in range(2)]
        paths["tp4_int8"] = _tp_launches(mesh)
    agree = sum(a == b for a, b in zip(qruns[0], tp4_tokens))
    log("tp4 int8: repeat identical {}; greedy agreement with tp4 bf16 "
        "{}/{} (reported); launches {}".format(
            qruns[0] == qruns[1], agree, TP_INT8_TOKENS,
            json.dumps(paths["tp4_int8"])))
    if qruns[0] != qruns[1]:
        fail("tp=4 int8 repeat gave other tokens")
    del qmodel

    # (d) park at tp=4 (the full layout), attach at tp=4 and at tp=1
    n = TP_PARK_TOKENS
    nbytes = cfg.n_layers * 2 * 4096 * cfg.n_kv_heads * cfg.head_dim * 2
    region = csm.create_shared_memory_region("tp_park", nbytes)
    pos = len(long_prompt) + n - 1
    try:
        with _served(model) as port:
            _register(port, "tp_park", csm.get_raw_handle(region).decode(),
                      nbytes)
            first = _sse_tokens(port, long_prompt, n, {
                "kv_cache_region": "tp_park"})
            second = _sse_tokens(port, first[-1:], n, {
                "kv_cache_region": "tp_park", "kv_cache_resume": True,
                "kv_cache_position": pos})
            # the model's core is this server's: read the park there
            parked = model._server.cuda_shm_region(
                "tp_park").parked_tensor(0).clone()
            _unregister(port, "tp_park")
    finally:
        csm.destroy_shared_memory_region(region)
    step = llama.make_tp_step(mesh, cfg)
    with torch.inference_mode():
        logits4 = step(params, llama.tp_scatter_cache(mesh, parked),
                       np.array(first[-1:]), pos)[0][0].clone()
    log("tp4 park: shape {} ({} tokens then {} resumed); park equal to the "
        "unparked tokens {}, resume equal to the unparked continuation "
        "{}".format(tuple(parked.shape), n, n, first == tp4_tokens[:n],
                    second == tp4_tokens[n:2 * n]))
    if first != tp4_tokens[:n] or second != tp4_tokens[n:2 * n]:
        fail("tp=4 park and resume differ from the unparked generation")
    del model, params, step, init_cache, prefill_fn, decode_fn, mirror
    _tp_close(torch, mesh, followers)
    mesh, followers = _tp_world(1, "nccl")
    params = llama.tp_params(mesh, cfg, seed=SEED)
    with torch.inference_mode():
        logits1 = llama.make_tp_step(mesh, cfg)(
            params, llama.tp_scatter_cache(mesh, parked),
            np.array(first[-1:]), pos)[0][0].clone()
    err = row_rel_err(logits1, logits4)
    log("tp1 attach of the tp4 park: logits vs tp4's {} (tolerance {}); "
        "next token {} and {}".format(
            err, TP_LOGITS_TOL, int(logits1.argmax()), int(logits4.argmax())))
    del params, parked
    _tp_close(torch, mesh, followers)
    if not err <= TP_LOGITS_TOL:
        fail("a tp=4 park attached at tp=1 differs from tp=4")
    for path, counts in paths.items():
        idle = [k for k in ("flash_attention", "decode_attention")
                + (("int8_matmul",) if "int8" in path else ())
                if not all(counts[k])]
        if idle:
            fail("tp path {}: {} not launched on every rank: {}".format(
                path, idle, counts))
    log("tp: phase 10 {:.1f} s".format(time.monotonic() - t_phase))
    return paths


# -- phase 11: SPMD training -------------------------------------------------


def _train_tokens(np, batch, length, vocab):
    """The seed's [batch, length] tokens and their next-token targets
    (``roll(tokens, -1)``, as JAX's own training check takes them)."""
    tokens = np.random.RandomState(SEED).randint(
        0, vocab, (batch, length)).astype(np.int64)
    return tokens, np.roll(tokens, -1, axis=1)


def _train_mesh(torch, config, rank, world, store, device, backend):
    """The default group (``world`` ranks over the ``file://`` store) and
    a mesh of ``config`` over it, on ``device``."""
    import datetime

    import torch.distributed as dist

    from tpuserver_torch.parallel import make_mesh

    dist.init_process_group(
        backend, init_method="file://" + store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    return make_mesh(config, device=device, backend=backend,
                     timeout_s=TP_TIMEOUT_S)


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak_gib(torch, device, reset=False):
    if torch.device(device).type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return peak


def _launch_counts(reset=False):
    from tpuserver_torch.ops import flash, quant

    counts = {"flash_attention": flash.flash_attention.launches,
              "decode_attention": flash.decode_attention.launches,
              "int8_matmul": quant.int8_matmul.launches}
    if reset:
        flash.reset_launch_counts()
        quant.reset_launch_counts()
    return counts


def _timed_steps(torch, device, step_fn, params, opt, tokens, targets, n,
                 after_first=None):
    """``n`` train steps, each timed on the host clock to its end (the
    step returns its loss as a float): (params, opt, losses, ms)."""
    losses, walls = [], []
    for i in range(n):
        _sync(torch, device)
        t0 = time.monotonic()
        params, opt, loss = step_fn(params, opt, tokens, targets)
        _sync(torch, device)
        walls.append((time.monotonic() - t0) * 1e3)
        losses.append(loss)
        if i == 0 and after_first is not None:
            after_first(params)
    return params, opt, losses, walls


def _train_class(name):
    low = name.lower()
    if "adam" in low:
        return "optimizer"
    if "nccl" in low or "memcpy" in low:
        # NCCL's kernels, and the host copies of gloo's staging (and of
        # the step's tokens in and its loss out)
        return "collectives"
    if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "matmul")):
        return "matmul"
    return "other"


def _train_profile(torch, llama, fn):
    """One call of ``fn`` (a train step) under ``torch.profiler``: the
    device ms by class: ``attention_fold`` (the ring fold's forward,
    inside a ``record_function`` range, and its backward: the autograd
    nodes whose sequence numbers the fold's forward ops recorded),
    ``matmul`` (the other GEMMs), ``optimizer`` (the fused AdamW
    kernels), ``collectives`` and ``other``; and the profiled wall ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    ring = llama.ring_attention

    def fold(*args, **kwargs):
        with record_function("attention_fold"):
            return ring(*args, **kwargs)

    llama.ring_attention = fold
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    finally:
        llama.ring_attention = ring
    events = prof.events()

    def subtree(e):
        yield e
        for c in e.cpu_children:
            yield from subtree(c)

    by_class, fold_kernels, fold_seq = {}, [], set()
    for e in events:
        if str(e.device_type).endswith("CUDA"):
            cls = _train_class(e.name)
            by_class[cls] = by_class.get(cls, 0.0) + \
                e.time_range.elapsed_us() / 1e3
        elif e.name == "attention_fold":
            for d in subtree(e):
                fold_kernels += d.kernels
                if d.sequence_nr >= 0:
                    fold_seq.add(d.sequence_nr)
    backward = 0
    for e in events:
        if e.name.startswith("autograd::engine::evaluate_function:") and \
                e.sequence_nr in fold_seq:
            backward += 1
            for d in subtree(e):
                fold_kernels += d.kernels
    fold_ms = 0.0
    for k in fold_kernels:
        cls = _train_class(k.name)
        by_class[cls] = by_class.get(cls, 0.0) - k.duration / 1e3
        fold_ms += k.duration / 1e3
    by_class["attention_fold"] = fold_ms
    return {"wall_ms": wall_ms, "device_ms": sum(by_class.values()),
            "device_ms_by_class": by_class,
            "fold_backward_nodes": backward}


def train_single(torch, np, cfg, device="cuda", backend="nccl", store=None,
                 batch=TRAIN_BATCH, length=TRAIN_LEN):
    """Phase 11 (a), in a process of its own: ``cfg`` at tp=1, world 1,
    ``TRAIN_STEPS`` steps on one repeated batch.  Step 0's loss beside the
    unsharded ``forward``'s on the same params (the flash kernel's
    launches there counted apart), the losses, each step's wall ms, the
    peak memory, the launches of the three kernels during the steps, and
    on the card one more step profiled."""
    import torch.nn.functional as F

    from tpuserver_torch.models import llama
    from tpuserver_torch.ops import perf
    from tpuserver_torch.parallel import MeshConfig
    from tpuserver_torch.parallel.collectives import mesh_context

    mesh = _train_mesh(torch, MeshConfig(), 0, 1, store, device, backend)
    tokens, targets = _train_tokens(np, batch, length, cfg.vocab)
    step_fn, init_fn = llama.make_train_step(mesh, cfg,
                                             learning_rate=TRAIN_LR,
                                             device=device)
    t0 = time.monotonic()
    params, opt = init_fn(SEED, tokens)
    _sync(torch, device)
    draw_s = time.monotonic() - t0
    _launch_counts(reset=True)
    with torch.no_grad():
        logits = llama.forward(params, torch.from_numpy(tokens).to(device),
                               cfg)
        ref_loss = F.cross_entropy(
            logits.reshape(-1, cfg.vocab),
            torch.from_numpy(targets).to(device).reshape(-1)).item()
    del logits
    ref_launches = _launch_counts(reset=True)
    held_gib = _peak_gib(torch, device, reset=True)
    mesh_context(mesh).stats(reset=True)
    params, opt, losses, walls = _timed_steps(
        torch, device, step_fn, params, opt, tokens, targets, TRAIN_STEPS)
    out = {"draw_s": draw_s, "reference_loss": ref_loss, "losses": losses,
           "step_ms": walls, "held_before_steps_gib": held_gib,
           "peak_gib": _peak_gib(torch, device),
           "reference_launches": ref_launches,
           "step_launches": _launch_counts(),
           "collectives": mesh_context(mesh).stats(reset=True),
           "params": perf.param_count(cfg), "tokens": batch * length}
    if torch.device(device).type == "cuda":
        median_ms = sorted(walls)[len(walls) // 2]
        prof = _train_profile(torch, llama, lambda: step_fn(
            params, opt, tokens, targets))
        prof["busy_share"] = prof["device_ms"] / median_ms
        out["profile"] = prof
        out["median_step_ms"] = median_ms
        out["mfu"] = perf.mfu(perf.train_step_flops(cfg, batch * length),
                              median_ms / 1e3, perf.chip_spec(0))
        out["step_launches"] = _launch_counts()
    return out


def _leaf_paths(params):
    """{"embed": t, "layers.0.wq": t, ...} of a params tree."""
    out = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, prefix + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, prefix + (str(i),))
        else:
            out[".".join(prefix)] = tree

    walk(params, ())
    return out


def train_reference(torch, np, cfg, ref_path, device="cuda",
                    backend="nccl", store=None, batch=TRAIN_MESH_BATCH,
                    length=TRAIN_MESH_LEN):
    """Phase 11 (b)'s reference, in a process of its own: ``cfg`` (the
    depth-cut model) at world 1 on the mesh's batch, ``TRAIN_MESH_STEPS``
    steps; step 0's gradient of every leaf, cut to the mesh's rank 0
    slice (tp coordinate 0), saved to ``ref_path``."""
    from tpuserver_torch.models import llama
    from tpuserver_torch.parallel import MeshConfig
    from tpuserver_torch.parallel.mesh import shard

    mesh = _train_mesh(torch, MeshConfig(), 0, 1, store, device, backend)
    tokens, targets = _train_tokens(np, batch, length, cfg.vocab)
    step_fn, init_fn = llama.make_train_step(mesh, cfg,
                                             learning_rate=TRAIN_LR,
                                             device=device)
    params, opt = init_fn(SEED, tokens)
    specs = _leaf_paths(llama.param_specs(cfg))

    def save(params):
        torch.save({path: shard(t.grad, specs[path], TRAIN_MESH[2], 0).cpu()
                    for path, t in _leaf_paths(params).items()}, ref_path)

    _peak_gib(torch, device, reset=True)
    params, opt, losses, walls = _timed_steps(
        torch, device, step_fn, params, opt, tokens, targets,
        TRAIN_MESH_STEPS, after_first=save)
    return {"losses": losses, "step_ms": walls,
            "peak_gib": _peak_gib(torch, device)}


def _grad_errors(torch, params, ref):
    """Each leaf's gradient against ``ref`` (path -> the same slice of the
    reference gradient): |g - ref| / |ref| in float32."""
    out = {}
    for path, t in _leaf_paths(params).items():
        r = ref[path].to(t.grad.device).float()
        out[path] = (torch.linalg.vector_norm(t.grad.float() - r)
                     / torch.linalg.vector_norm(r)).item()
    return out


def train_mesh_rank(torch, np, cfg, rank, store, ref_path, device="cuda",
                    backend="gloo", batch=TRAIN_MESH_BATCH,
                    length=TRAIN_MESH_LEN):
    """One rank of phase 11 (b), in a process of its own: the
    ``TRAIN_MESH`` mesh over ``backend``; ``TRAIN_MESH_STEPS`` steps with
    ring attention, the same with Ulysses, then one step with ring attention
    and the planted fault (layer ``TRAIN_FAULT_LAYER``'s ``copy_to_tp``
    without its backward sum), each from the seed's params.  Every run:
    the losses, each step's wall ms and the part of it the gradient sum
    over dp x sp took, this rank's collectives in step 0, its peak
    memory; on rank 0 also step 0's gradient of every leaf
    against the reference's slice (``ref_path``)."""
    from tpuserver_torch.models import llama
    from tpuserver_torch.parallel import MeshConfig
    from tpuserver_torch.parallel.collectives import mesh_context

    world = MeshConfig(*TRAIN_MESH).size
    mesh = _train_mesh(torch, MeshConfig(*TRAIN_MESH), rank, world, store,
                       device, backend)
    ctx = mesh_context(mesh)
    ref = torch.load(ref_path) if rank == 0 else None
    tokens, targets = _train_tokens(np, batch, length, cfg.vocab)
    out = {"rank": rank,
           "coords": [ctx.dp_rank, ctx.sp.rank, ctx.tp.rank]}
    sum_grads, sums = llama._sum_grads, []

    def timed_sum(*args, **kwargs):
        # each step's gradient sum over dp x sp, on the host clock
        _sync(torch, device)
        t0 = time.monotonic()
        sum_grads(*args, **kwargs)
        _sync(torch, device)
        sums.append((time.monotonic() - t0) * 1e3)

    for run, strategy, fault, steps in (
            ("ring", "ring", None, TRAIN_MESH_STEPS),
            ("ulysses", "ulysses", None, TRAIN_MESH_STEPS),
            ("fault", "ring", TRAIN_FAULT_LAYER, 1)):
        c = dataclasses.replace(cfg, sp_strategy=strategy)
        step_fn, init_fn = llama.make_train_step(mesh, c,
                                                 learning_rate=TRAIN_LR,
                                                 device=device)
        params, opt = init_fn(SEED, tokens)
        _peak_gib(torch, device, reset=True)
        ctx.stats(reset=True)
        seen = {}

        def first(params):
            seen["collectives"] = ctx.stats(reset=True)
            if ref is not None:
                seen["grad_err"] = _grad_errors(torch, params, ref)

        llama.train_plant_fault(mesh, fault)
        llama._sum_grads = timed_sum
        try:
            params, opt, losses, walls = _timed_steps(
                torch, device, step_fn, params, opt, tokens, targets, steps,
                after_first=first)
        finally:
            llama.train_plant_fault(mesh, None)
            llama._sum_grads = sum_grads
        out[run] = dict(seen, losses=losses, step_ms=walls,
                        grad_sum_ms=sums[-steps:],
                        peak_gib=_peak_gib(torch, device))
        del params, opt, step_fn, init_fn
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    out["step_launches"] = _launch_counts()
    return out


def child_train(torch, np, argv):
    """``--child-train <mode> <rank> <store> <reference path>``: one
    process of phase 11 (modes ``single``, ``reference``, ``mesh``); its
    result is the line ``train-result: <json>``."""
    import torch.distributed as dist

    from tpuserver_torch.models import llama

    mode, rank, store, ref_path = argv[0], int(argv[1]), argv[2], argv[3]
    cfg = llama.llama3_8b()
    cut = dataclasses.replace(cfg, n_layers=TRAIN_MESH_LAYERS)
    try:
        if mode == "single":
            result = train_single(torch, np, cfg, store=store)
        elif mode == "reference":
            result = train_reference(torch, np, cut, ref_path, store=store)
        else:
            result = train_mesh_rank(torch, np, cut, rank, store, ref_path)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print("train-result: " + json.dumps(result), flush=True)


def _train_children(mode, world=1, ref_path="", timeout=900):
    """``world`` processes of ``--child-train <mode>`` (one per rank, all
    started at once, one store), their output in files under build/;
    each one's result, in rank order.  Fails if any exits non-zero."""
    run = os.path.join(HERE, "build", "train", "{}-{}-{}".format(
        mode, os.getpid(), time.monotonic_ns()))
    os.makedirs(run, exist_ok=True)
    store = os.path.join(run, "store")
    procs, files = [], []
    for rank in range(world):
        files.append(open(os.path.join(run, "rank{}.log".format(rank)), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child-train",
             mode, str(rank), store, ref_path],
            stdout=files[-1], stderr=subprocess.STDOUT, text=True))
    results = []
    try:
        for rank, (proc, f) in enumerate(zip(procs, files)):
            try:
                code = proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                code = "timeout"
            f.seek(0)
            lines = f.read().splitlines()
            found = [ln[len("train-result: "):] for ln in lines
                     if ln.startswith("train-result: ")]
            if code != 0 or not found:
                log("\n".join("  train {} rank {}: {}".format(mode, rank, ln)
                              for ln in lines[-40:]))
                fail("phase 11 {} rank {} exited {}".format(mode, rank,
                                                            code))
            results.append(json.loads(found[0]))
    finally:
        for proc, f in zip(procs, files):
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
            f.close()
    return results


def phase_train(torch, np):
    """SPMD training (``make_train_step``), each run in processes of its
    own, none of which holds this process's memory.  (a) ``llama3_8b`` at
    full width and depth, tp=1 over NCCL, three steps on one repeated
    batch (B ``TRAIN_BATCH``, T ``TRAIN_LEN``, lr ``TRAIN_LR``): step 0's
    loss within ``TRAIN_LOSS_TOL`` of the unsharded ``forward``'s, finite
    and falling losses; a step's wall time, device time by class, busy
    share, peak memory and share of the bf16 peak.  (b) the ``TRAIN_MESH``
    mesh (dp 1, sp 2, tp 2), four processes sharing the card over gloo,
    full width at depth ``TRAIN_MESH_LAYERS``, B ``TRAIN_MESH_BATCH``, T
    ``TRAIN_MESH_LEN``, ring then Ulysses: step 0's loss and rank 0's
    gradient of every leaf within ``TRAIN_MESH_LOSS_TOL`` and
    ``TRAIN_GRAD_TOL`` of a world-1 run of the same model, batch and seed,
    the three steps' losses too, ring within ``TRAIN_SP_TOL`` of Ulysses,
    the planted fault at least ten times the gradient limit.  Returns the
    reference forward's launches and the steps' (which should be 0)."""
    t_phase = time.monotonic()
    log("train: this process holds {:.3f} GiB before phase 11".format(
        torch.cuda.memory_allocated() / 2 ** 30))

    (a,) = _train_children("single")
    prof = a["profile"]
    err0 = abs(a["losses"][0] - a["reference_loss"])
    log("train (a) llama3_8b tp=1: draw {:.1f} s; losses {}; step 0 vs "
        "forward's {} (|diff| {}, tolerance {}); step ms {} (median {}); "
        "peak {} GiB (before the steps: {} GiB, the draw and the "
        "forward); 6ND share of the bf16 peak {}; "
        "profiled step: wall {} ms, device {} ms by class {}, busy share "
        "{} ({} fold backward nodes); launches: forward {}, steps {}".format(
            a["draw_s"], a["losses"], a["reference_loss"], err0,
            TRAIN_LOSS_TOL, a["step_ms"], a["median_step_ms"], a["peak_gib"],
            a["held_before_steps_gib"], a["mfu"], prof["wall_ms"],
            prof["device_ms"], json.dumps(prof["device_ms_by_class"]),
            prof["busy_share"], prof["fold_backward_nodes"],
            a["reference_launches"], a["step_launches"]))
    if not all(math.isfinite(x) for x in a["losses"]):
        fail("train (a): a loss is not finite")
    if not a["losses"][-1] < a["losses"][0]:
        fail("train (a): the loss did not fall")
    if not err0 <= TRAIN_LOSS_TOL:
        fail("train (a): step 0's loss differs from forward's")

    ref_path = os.path.join(HERE, "build", "train_reference.pt")
    (ref,) = _train_children("reference", ref_path=ref_path)
    log("train (b) reference, world 1, depth {}: losses {}; step ms {}; "
        "peak {} GiB".format(TRAIN_MESH_LAYERS, ref["losses"],
                             ref["step_ms"], ref["peak_gib"]))
    ranks = _train_children("mesh", world=math.prod(TRAIN_MESH),
                            ref_path=ref_path)
    os.remove(ref_path)
    r0 = ranks[0]
    for run in ("ring", "ulysses"):
        worst = max(r0[run]["grad_err"].items(), key=lambda kv: kv[1])
        loss_err = max(abs(x - y) for x, y in zip(r0[run]["losses"],
                                                  ref["losses"]))
        log("train (b) mesh {} {}: losses {} (vs world 1: {}; tolerance "
            "{}); rank 0's worst leaf gradient {} (tolerance {}); step ms "
            "by rank {}, of which the gradient sum over dp x sp {}; peak "
            "GiB by rank {}; rank 0's collectives in step 0 {}".format(
                TRAIN_MESH, run, r0[run]["losses"], loss_err,
                TRAIN_MESH_LOSS_TOL, worst, TRAIN_GRAD_TOL,
                [r[run]["step_ms"] for r in ranks],
                [r[run]["grad_sum_ms"] for r in ranks],
                [r[run]["peak_gib"] for r in ranks],
                json.dumps(r0[run]["collectives"])))
        if any(r[run]["losses"] != r0[run]["losses"] for r in ranks):
            fail("train (b) {}: the ranks return other losses".format(run))
        if not loss_err <= TRAIN_MESH_LOSS_TOL:
            fail("train (b) {}: the losses differ from world 1's".format(run))
        if not worst[1] <= TRAIN_GRAD_TOL:
            fail("train (b) {}: a gradient differs from world 1's".format(
                run))
    sp_err = abs(r0["ring"]["losses"][0] - r0["ulysses"]["losses"][0])
    fault = max(r0["fault"]["grad_err"].items(), key=lambda kv: kv[1])
    log("train (b): ring vs Ulysses step 0 loss {} (tolerance {}), all "
        "steps {}; planted fault (layer {}'s copy_to_tp without its "
        "backward sum): worst leaf {} ({:.1f}x the tolerance)".format(
            sp_err, TRAIN_SP_TOL,
            [abs(x - y) for x, y in zip(r0["ring"]["losses"],
                                        r0["ulysses"]["losses"])],
            TRAIN_FAULT_LAYER, fault, fault[1] / TRAIN_GRAD_TOL))
    if not sp_err < TRAIN_SP_TOL:
        fail("train (b): ring and Ulysses disagree")
    if not fault[1] >= 10 * TRAIN_GRAD_TOL:
        fail("train (b): the planted fault moves the gradients less than "
             "ten times the tolerance")
    steps = {k: a["step_launches"][k] + sum(r["step_launches"][k]
                                            for r in ranks)
             for k in a["step_launches"]}
    log("train: the steps launched {} of the port's kernels; phase 11 "
        "{:.1f} s".format(steps, time.monotonic() - t_phase))
    return {"reference_launches": a["reference_launches"],
            "step_launches": steps}


# -- phase 12: the perf analyzer in-process ----------------------------------

# (a): the generation load, through the code of ``python -m
# tpuserver_torch.perf_analyzer`` (``main(argv, core=...)``): 512-token
# prompts (a flash length), 32 tokens a stream, 1 and 8 streams, 3 s
# windows, at most four.  256 distinct prompts, so no prompt comes round again within
# the run and every admission prefills its whole prompt (the prefix cache
# shares nothing between random ids)
PERF_GEN_ARGS = ("-m", "llama_generate", "--generation", "--prompt-len", "512",
                 "--max-tokens", "32", "--concurrency-range", "1:8:7",
                 "--measurement-interval", "3000", "--max-trials", "4",
                 "--input-pool", "256")
PERF_GEN_TOKENS = 32
# (b): batch-1 ResNet-50 requests at concurrency 1 and 16 on each data
# plane, 1 s windows, at most three; a shm plane's output goes into a
# region of its kind, as phase 8 (e)'s clients put it.  In band runs first
# and again last: the second run tells a plane's own cost from a drift
# over the phase
PERF_UNARY_ARGS = ("-m", "resnet50", "--concurrency-range", "1:16:15",
                   "--measurement-interval", "1000", "--max-trials", "3")
PERF_PLANES = ("none", "system", "cuda", "none")
# the phase's share of the script's 1200 s: reported, not enforced
PERF_BUDGET_S = 150.0


def _perf_run(argv, core):
    """The port's perf analyzer CLI (``main``) on ``core``, its standard
    output captured: (the JSON rows, tokens per stream by level, the
    text).  A non-zero exit fails the phase."""
    import contextlib
    import io

    from tpuserver_torch import perf_analyzer

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = perf_analyzer.main(list(argv), core=core)
    text = buf.getvalue()
    if rc != 0:
        fail("perf: python -m tpuserver_torch.perf_analyzer {} exited {}: "
             "{}".format(" ".join(argv), rc, text[-2000:]))
    rows = [json.loads(ln) for ln in text.splitlines() if ln.startswith('{"')]
    streams = {}
    for ln in text.splitlines():
        if ln.startswith("tokens per stream at level "):
            head, _, counts = ln.partition(": ")
            streams[int(head.rsplit(" ", 1)[1])] = {
                int(k): v for k, v in json.loads(counts).items()}
    return rows, streams, text


def _perf_generation(torch, cfg, params, smi):
    """(a): ``llama3_8b`` behind ``max_slots=8`` at ``max_seq`` 4096 on the
    given weights; returns the kernels' launches and the rows."""
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel
    from tpuserver_torch.ops import flash as fl
    from tpuserver_torch.ops import quant
    from tpuserver_torch.perfanalyzer.report import GENERATION_ROW_KEYS

    model = LlamaGenerateModel(cfg=cfg, max_seq=4096, max_slots=8,
                               params=params, device="cuda")
    core = InferenceServer([model])
    try:
        model.warmup()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fl.reset_launch_counts()
        quant.int8_matmul.launches = 0
        t0 = time.monotonic()
        rows, streams, text = _perf_run(PERF_GEN_ARGS, core)
        torch.cuda.synchronize()
        launches = {"flash_attention": fl.flash_attention.launches,
                    "decode_attention": fl.decode_attention.launches,
                    "int8_matmul": quant.int8_matmul.launches}
        seconds = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        core.close()
    log(text.rstrip())
    for row in rows:
        log("perf (a) llama3_8b, {} stream(s), in-process: TTFT p50 {:.3f} "
            "ms, p99 {:.3f} ms; ITL p50 {:.3f} ms, p99 {:.3f} ms; {:.2f} "
            "tokens/s; {} streams completed in the merged windows, {} "
            "errors; stable {} after {} windows; tokens per stream at this "
            "level {}; {}".format(
                row["level"], row["ttft_p50_ms"], row["ttft_p99_ms"],
                row["itl_p50_ms"], row["itl_p99_ms"], row["value"],
                row["generations"], row["errors"], row["stable"],
                row["trials"], streams.get(row["level"]), smi))
    log("perf (a) launches around the run {} (int8_matmul: bf16 weights, "
        "none expected); peak device memory {:.3f} GiB (torch's allocator); "
        "{:.1f} s".format(json.dumps(launches), peak, seconds))
    if [r["level"] for r in rows] != [1, 8]:
        fail("perf (a): levels {}, want [1, 8]".format(
            [r["level"] for r in rows]))
    for row in rows:
        if row["errors"] or not row["generations"]:
            fail("perf (a): level {}: {} errors, {} streams".format(
                row["level"], row["errors"], row["generations"]))
        if set(row) != GENERATION_ROW_KEYS:
            fail("perf (a): row keys differ from the pinned ones: {}".format(
                sorted(set(row) ^ GENERATION_ROW_KEYS)))
        counts = streams.get(row["level"], {})
        if list(counts) != [PERF_GEN_TOKENS]:
            fail("perf (a): level {}: tokens per stream {}, want {} every "
                 "stream".format(row["level"], counts, PERF_GEN_TOKENS))
    if not launches["flash_attention"] or not launches["decode_attention"]:
        fail("perf (a): a kernel never launched: {}".format(launches))
    if launches["int8_matmul"]:
        fail("perf (a): the W8A16 kernel ran on bf16 weights")
    return launches, rows


def _perf_one_request(np, core, plane, image, inband):
    """(b): one request through the perf analyzer's own staging on
    ``plane`` (input, and for a shm plane the output, in regions of its
    kind); its output against the in-band one."""
    from tpuserver_torch.perfanalyzer.client_backend import (
        InProcessBackend,
        ShmInferDataManager,
    )

    backend = InProcessBackend(core)
    shm = None
    try:
        if plane == "none":
            resp = backend.infer(backend.prepare(
                "resnet50", [{"INPUT": image}])[0])
            got = resp.outputs[0][1]
        else:
            shm = ShmInferDataManager(backend, plane, tag="check",
                                      device="cuda")
            refs = shm.stage_input_sets([{"INPUT": image}],
                                        {"INPUT": "FP32"})
            name, handle = shm.create_region("out", OUTPUT_BYTES)
            backend.infer(backend.prepare_shm(
                "resnet50", refs, [("OUTPUT", name, OUTPUT_BYTES, 0)])[0])
            got = shm.read(handle, np.float32, [1, 1000])
    finally:
        if shm is not None:
            shm.close()
        backend.close()
    return _np_row_rel_err(np, got, inband)


def _perf_unary(torch, np, smi):
    """(b): ResNet-50 (phase 8's model, bf16, the dynamic batcher) at
    concurrency 1 and 16 on each data plane; returns (label, row)
    pairs."""
    from tpuserver_torch import cuda_shared_memory as csm
    from tpuserver_torch.core import InferenceServer, InferRequest
    from tpuserver_torch.models import vision as tv
    from tpuserver_torch.perfanalyzer.report import CONCURRENCY_ROW_KEYS

    resnet = tv.ResNet50Model(device="cuda", seed=SEED)
    core = InferenceServer([resnet])
    all_rows = []
    try:
        t0 = time.monotonic()
        core.warmup()
        log("perf (b): ResNet-50 warm-up of every bucket on each executor "
            "{:.1f} s".format(time.monotonic() - t0))
        image = np.random.RandomState(SEED + 12).rand(1, *IMAGE).astype(
            np.float32)
        inband = core.infer(InferRequest(
            "resnet50", inputs={"INPUT": image})).outputs[0][1]
        for i, plane in enumerate(PERF_PLANES):
            label = plane + (" (again)" if plane in PERF_PLANES[:i] else "")
            stats0 = core.model_statistics("resnet50")["model_stats"][0]
            reads0 = core.shm_stats()["shm_zero_copy_reads"]
            argv = list(PERF_UNARY_ARGS) + ["--shared-memory", plane]
            if plane != "none":
                argv += ["--output-shared-memory-size", str(OUTPUT_BYTES)]
            rows, _, text = _perf_run(argv, core)
            stats1 = core.model_statistics("resnet50")["model_stats"][0]
            reads = core.shm_stats()["shm_zero_copy_reads"] - reads0
            done = (stats1["inference_stats"]["success"]["count"]
                    - stats0["inference_stats"]["success"]["count"])
            err = _perf_one_request(np, core, plane, image, inband)
            log(text.rstrip())
            for row in rows:
                log("perf (b) ResNet-50 in-process, {} plane, concurrency "
                    "{}: {:.1f} infer/s, p50 {:.3f} ms, p99 {:.3f} ms; "
                    "server queue {:.1f} us, compute infer {:.1f} us a "
                    "request; mean batch {:.2f}; {} errors; stable {}; "
                    "{}".format(
                        label, row["level"], row["value"],
                        row["p50_usec"] / 1e3, row["p99_usec"] / 1e3,
                        row["queue_usec"], row["compute_infer_usec"],
                        row["server_inference_count"]
                        / max(1, row["server_execution_count"]),
                        row["errors"], row["stable"], smi))
            log("perf (b) {} plane: {} requests served, {} zero-copy reads; "
                "one request's output vs in band {:.3g} (limit {})".format(
                    label, done, reads, err, VISION_TOL))
            if [r["level"] for r in rows] != [1, 16]:
                fail("perf (b) {}: levels {}".format(
                    plane, [r["level"] for r in rows]))
            for row in rows:
                if row["errors"] or set(row) != CONCURRENCY_ROW_KEYS:
                    fail("perf (b) {}: {} errors; keys {}".format(
                        plane, row["errors"], sorted(row)))
            if reads != (done if plane == "cuda" else 0):
                fail("perf (b) {}: {} zero-copy reads for {} requests".format(
                    plane, reads, done))
            if err > VISION_TOL:
                fail("perf (b) {}: output vs in band {}".format(plane, err))
            all_rows += [(label, row) for row in rows]
    finally:
        core.close()
    left = [h.name for h in csm.allocated_shared_memory_regions()
            if h.name.startswith("pa_")]
    files = [f for f in os.listdir("/dev/shm") if f.startswith("pa_")]
    if left or files or core.cuda_shm_status() or core.system_shm_status():
        fail("perf (b): regions left behind: {} {}".format(left, files))
    return all_rows


def phase_perf(torch, np, cfg, params, smi):
    """Phase 12: the port's perf analyzer (``python -m
    tpuserver_torch.perf_analyzer``'s ``main``, handed a full-size core)
    in-process: (a) ``llama3_8b`` generation at 1 and 8 streams on the
    given weights, (b) ResNet-50 at concurrency 1 and 16 in band, over
    system and over CUDA regions, (c) the report.  Returns (a)'s kernel
    launches."""
    t_start = time.monotonic()
    launches, gen_rows = _perf_generation(torch, cfg, params, smi)
    unary_rows = _perf_unary(torch, np, smi)
    for label, row in ([("generation", r) for r in gen_rows]
                       + [(p + " plane", r) for p, r in unary_rows]):
        log("perf (c) row, {}: {}".format(label, json.dumps(row)))
    seconds = time.monotonic() - t_start
    log("perf: phase 12 {:.1f} s ({} its {:.0f} s budget)".format(
        seconds, "within" if seconds <= PERF_BUDGET_S else "OVER",
        PERF_BUDGET_S))
    return launches


# -- phase 13: the BASELINE benchmark over the port's sockets ----------------

# ``python -m tpuserver_torch.bench_full``'s flags: 0.5 s windows, two of
# them (config 1 to two stable windows), the continuous-batching rows at
# 1, 4 and 8 streams
BENCH_ARGV = ("--window-s", "0.5", "--windows", "2", "--llama-config",
              "llama3_8b", "--llama-slots", "8")
# every kind of row the five configs print at these flags
BENCH_KINDS = {"simple_http", "vision", "vision_cuda_shm",
               "vision_concurrent", "vision_concurrent_best", "bert_stream",
               "bert_bound", "llama_prefill", "llama_decode", "llama_stream",
               "llama_multistream", "llama_scaling"}
# the in-process floor under the socket rows, on the same core before
# the benchmark: the port's perf analyzer with no transport on config 1's
# model, config 2's at one request, config 4's ensemble at its 8 in
# flight, and config 5's streams (8-token prompts, 64 tokens, at its
# largest row's 8 streams); at most three windows each (0.5 s; the
# streams' 3 s), an unstable level reported
BENCH_FLOOR = (
    ("-m", "simple", "--concurrency-range", "1"),
    ("-m", "resnet50", "--concurrency-range", "1"),
    ("-m", "bert_ensemble", "--concurrency-range", "8"),
    ("-m", "llama_generate", "--generation", "--prompt-len", "8",
     "--max-tokens", "64", "--concurrency-range", "8",
     "--input-pool", "64", "--measurement-interval", "3000"))
BENCH_FLOOR_WINDOWS = ("--measurement-interval", "500", "--max-trials",
                       "3")
# the phase's share of the script's 1200 s: reported, not enforced
BENCH_BUDGET_S = 150.0


def phase_bench(torch, np, cfg, params, smi, device="cuda"):
    """Phase 13: the BASELINE benchmark (``tpuserver_torch.bench_full``'s
    ``main``) on a core of the fixture models and the serving zoo on
    ``device``, with ``params`` (``llama3_8b``) behind ``max_slots=8``,
    after the in-process floor of its socket rows (``BENCH_FLOOR``);
    returns the kernels' launches over the benchmark by path: config 5's
    direct rows (``bench``) and the served streams (``bench_served``)."""
    import io

    from tpuserver_torch import bench_full
    from tpuserver_torch import cuda_shared_memory as csm
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.models import default_models, serving_models
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel
    from tpuserver_torch.ops import flash as fl

    t_start = time.monotonic()
    llama_model = LlamaGenerateModel(
        cfg=cfg, max_seq=bench_full.LLAMA_MAX_SEQ, decode_chunk=32,
        params=params, device=device, max_slots=8)
    core = InferenceServer(
        default_models()
        + serving_models(include_llama=False, device=device, seed=SEED)
        + [llama_model])
    out, err = io.StringIO(), io.StringIO()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    try:
        core.warmup()
        sync()
        log("bench: the zoo built and warm in {:.1f} s".format(
            time.monotonic() - t_start))
        for argv in BENCH_FLOOR:
            # the trailing flags win: the llama floor keeps its 3 s
            # windows
            floor, streams, _ = _perf_run(
                BENCH_FLOOR_WINDOWS + argv
                + (("--device", "cpu") if device == "cpu" else ()), core)
            for row in floor:
                log("bench floor, in-process, {}: {}{}".format(
                    smi, json.dumps(row),
                    "; tokens per stream {}".format(streams[row["level"]])
                    if row["level"] in streams else ""))
                if row["errors"]:
                    fail("bench floor: {} errors in {}".format(
                        row["errors"], row["metric"]))
        reads0 = core.shm_stats()["shm_zero_copy_reads"]
        dispatches0 = bench_full.bench_vision_cuda_shm.dispatches
        keys0 = len(bench_full._vision_call_system_shm.keys)
        # config 5's direct rows run alone (no stream is live), so the
        # launches inside ``bench_llama_direct`` are its own; the rest
        # are the served streams'
        direct = {"flash_attention": 0, "decode_attention": 0}
        llama_direct = bench_full.bench_llama_direct

        def counted_direct(*args, **kwargs):
            before = {k: getattr(fl, k).launches for k in direct}
            try:
                return llama_direct(*args, **kwargs)
            finally:
                for k in direct:
                    direct[k] += getattr(fl, k).launches - before[k]

        fl.reset_launch_counts()
        t0 = time.monotonic()
        bench_full.bench_llama_direct = counted_direct
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = bench_full.main(list(BENCH_ARGV), core=core,
                                     llama_params=params)
        finally:
            bench_full.bench_llama_direct = llama_direct
        sync()
        launches = {
            "bench": direct,
            "bench_served": {k: getattr(fl, k).launches - direct[k]
                             for k in direct}}
        seconds = time.monotonic() - t0
        reads = core.shm_stats()["shm_zero_copy_reads"] - reads0
        dispatches = bench_full.bench_vision_cuda_shm.dispatches - \
            dispatches0
    finally:
        core.close()
    log(out.getvalue().rstrip())
    if err.getvalue().strip():
        log("bench stderr: " + err.getvalue().strip()[-4000:])
    rows = [json.loads(ln) for ln in out.getvalue().splitlines()
            if ln.startswith('{"config"')]
    for row in rows:
        log("bench row (config {}), {}: {}".format(
            row["config"], smi, json.dumps(row)))
    log("bench: main ran {:.1f} s, exit {}; launches {}; {} CUDA-region "
        "requests, {} zero-copy reads".format(
            seconds, rc, json.dumps(launches), dispatches, reads))
    errors = [ln for ln in err.getvalue().splitlines()
              if ln.startswith('{"config"')]
    if rc != 0 or errors:
        fail("bench: exit {}, errors {}".format(rc, errors))
    kinds = set()
    for row in rows:
        kind = bench_full.row_kind(row["metric"])
        if kind is None or set(row) != bench_full.ROW_KEYS[kind]:
            fail("bench: row {} has keys {}, not the JAX bench's".format(
                row["metric"], sorted(row)))
        if row.get("suspect"):
            fail("bench: {} is above the card's peak: {}".format(
                row["metric"], row))
        kinds.add(kind)
    if kinds != BENCH_KINDS:
        fail("bench: kinds of row {} missing".format(
            sorted(BENCH_KINDS - kinds)))
    if not (launches["bench"]["flash_attention"]
            and launches["bench"]["decode_attention"]
            and launches["bench_served"]["decode_attention"]):
        fail("bench: a kernel never launched on its path: {}".format(
            launches))
    if not dispatches or reads != dispatches:
        fail("bench: {} zero-copy reads for {} CUDA-region requests".format(
            reads, dispatches))
    # this run's regions only: its CUDA regions in this process's
    # registry, and the system regions' files by the keys it made
    mine = ("resnet50_", "densenet121_", "bench_kv")
    left = [h.name for h in csm.allocated_shared_memory_regions()
            if h.name.startswith(mine)]
    keys = bench_full._vision_call_system_shm.keys[keys0:]
    files = [k for k in keys if os.path.exists("/dev/shm" + k)]
    if len(keys) != 1:
        fail("bench: system regions {} made, want config 2's one".format(
            keys))
    if left or files or core.cuda_shm_status() or core.system_shm_status():
        fail("bench: regions left behind: {} {}".format(left, files))
    total = time.monotonic() - t_start
    log("bench: phase 13 {:.1f} s ({} its {:.0f} s budget)".format(
        total, "within" if total <= BENCH_BUDGET_S else "OVER",
        BENCH_BUDGET_S))
    return launches


# -- phase 14: the chaos soak's in-process modes -----------------------------


# the soak's serving settings (the JAX tool's two slots and six tokens;
# four rounds, one whole FAULT_CYCLE where JAX's eight run it twice, so
# the script keeps within its 1200 s; max_seq CHAOS_SEQ, where JAX's is
# 64) on llama3_8b in float32 on the card
CHAOS_ARGV = ("--config", "llama3_8b", "--dtype", "float32", "--slots", "2",
              "--budget", "6", "--rounds", "4", "--max-seq", str(CHAOS_SEQ))
CHAOS_MODES = ((), ("--kill-loop",), ("--shm",))
# the phase's share of the script's 1200 s: reported, not enforced
CHAOS_BUDGET_S = 150.0


def _upcast(tree):
    """Every tensor leaf of ``tree`` to float32, in place, one leaf at a
    time: each bfloat16 leaf is freed as soon as its copy replaces it
    (when nothing else holds it), so the peak stays near the float32
    tree."""
    for key in list(tree.keys() if isinstance(tree, dict)
                    else range(len(tree))):
        if isinstance(tree[key], (dict, list)):
            _upcast(tree[key])
        else:
            tree[key] = tree[key].float()


def _chaos_margins(torch, llama, cfg, params, reference, prompts, device):
    """Each prompt's reference tokens against the one-pass prefill of
    ``prompt + reference`` (what a restart's re-prefill computes): the
    first position where the prefill's argmax differs from the decode's
    token (None when none does) and the smallest top-2 logit gap over
    the generated positions."""
    out = []
    for prompt, ref in zip(prompts, reference):
        ids = [int(t) for t in prompt] + list(ref)
        tokens = torch.tensor([ids[:-1]], device=device)
        with torch.inference_mode():
            logits = llama.forward(params, tokens, cfg)[0, len(prompt) - 1:]
        top2 = logits.topk(2, dim=-1)
        picks = top2.indices[:, 0].tolist()
        gaps = (top2.values[:, 0] - top2.values[:, 1]).tolist()
        first = next((j for j, (a, b) in enumerate(zip(picks, ref))
                      if a != b), None)
        out.append({"prompt": len(prompt), "diverges_at": first,
                    "gap_there": None if first is None else gaps[first],
                    "min_top2_gap": min(gaps)})
    return out


def phase_chaos(torch, cfg, params, smi, device="cuda"):
    """Phase 14: the chaos soak's default rounds (with the overload
    phase), ``--kill-loop`` and ``--shm`` over a CUDA region, through
    ``tpuserver_torch.chaos_smoke.main`` on ``params`` upcast to float32
    in place (``cfg`` their config); returns the kernels' launches over
    the three runs.  ``device="cpu"`` runs it on the CPU (a smaller
    ``CHAOS_ARGV`` config then), without the card's memory counts."""
    import io

    from tpuserver_torch import chaos_smoke
    from tpuserver_torch import cuda_shared_memory as csm
    from tpuserver_torch.models import llama
    from tpuserver_torch.ops import flash as fl

    card = device == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    t_start = time.monotonic()
    gc.collect()
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _upcast(params)
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    sync()
    log("chaos: weights upcast to float32 in {:.1f} s, {:.3f} GiB "
        "allocated".format(time.monotonic() - t_start,
                           torch.cuda.memory_allocated() / 2 ** 30
                           if card else 0.0))
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    regions0 = len(csm.allocated_shared_memory_regions())
    launches = {"flash_attention": 0, "decode_attention": 0}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    reference = None
    try:
        for mode in CHAOS_MODES:
            name = mode[0][2:] if mode else "default"
            out, err = io.StringIO(), io.StringIO()
            fl.reset_launch_counts()
            t0 = time.monotonic()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = chaos_smoke.main(
                    list(CHAOS_ARGV + mode + ("--device", device)),
                    params=params)
            sync()
            seconds = time.monotonic() - t0
            counts = {k: getattr(fl, k).launches for k in launches}
            for k in launches:
                launches[k] += counts[k]
            stats = chaos_smoke.STATS
            ok = [ln for ln in out.getvalue().splitlines()
                  if "chaos smoke OK" in ln]
            log("chaos {}, {}: exit {}, {:.1f} s, rounds {}, restarts {}, "
                "ring lanes read {}, data plane {}, launches {}".format(
                    name, smi, rc, seconds, stats.get("rounds"),
                    stats.get("restarts"), stats.get("ring_reads"),
                    json.dumps(stats.get("shm")), json.dumps(counts)))
            log("chaos {}: {}".format(name, ok[0] if ok else "no OK line"))
            if rc != 0 or not ok:
                log("chaos {} output: {}".format(name, out.getvalue()[-4000:]))
                log("chaos {} errors: {}".format(name, err.getvalue()[-8000:]))
                fail("chaos: {} exited {}".format(name, rc))
            if not counts["decode_attention"]:
                fail("chaos: {} never launched decode_attention".format(name))
            if mode and stats.get("restarts") != stats.get("rounds"):
                fail("chaos: {} restarted {} times in {} rounds".format(
                    name, stats.get("restarts"), stats.get("rounds")))
            reference = reference or stats.get("reference")
            if stats.get("reference") != reference:
                fail("chaos: {}'s reference tokens {} differ from the "
                     "default rounds' {}".format(
                         name, stats.get("reference"), reference))
        margins = _chaos_margins(torch, llama, cfg32, params, reference,
                                 chaos_smoke.PROMPTS, device)
        log("chaos: one-pass prefill of prompt + reference against the "
            "decode's tokens, {}: {}".format(smi, json.dumps(margins)))
        if any(m["diverges_at"] is not None for m in margins):
            fail("chaos: a one-pass prefill disagrees with the decode: "
                 "{}".format(margins))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if launches["flash_attention"]:
        fail("chaos: flash_attention launched {} times (every prefill "
             "should run dense)".format(launches["flash_attention"]))
    left = len(csm.allocated_shared_memory_regions()) - regions0
    if left:
        fail("chaos: {} regions left allocated".format(left))
    total = time.monotonic() - t_start
    log("chaos: phase 14 {:.1f} s ({} its {:.0f} s budget), peak {:.3f} "
        "GiB allocated, launches {}".format(
            total, "within" if total <= CHAOS_BUDGET_S else "OVER",
            CHAOS_BUDGET_S,
            torch.cuda.max_memory_allocated() / 2 ** 30 if card else 0.0,
            json.dumps(launches)))
    return launches


# -- phase 15: the model-path tuning tools ----------------------------------


# the prefill sweep in two calls: the prefill arms at the JAX tool's
# default 4 rounds (the identity arm saves about 1 ms of a 64 ms prefill
# at T 2048, under the one-round spread of the four flash arms, which run
# one kernel), the decode arms at one round (each chains two chunks)
SWEEP_PREFILL_ARGV = ("--prefill-only", "--rounds", "4")
SWEEP_DECODE_ARGV = ("--decode-only", "--rounds", "1")
# the CPU rehearsal (``phase_tools(..., device="cpu")``): the sweep on
# ``tiny`` at T 128 (its decode arms at their contexts, 512 and 2048), on
# weights it draws
TOOLS_CPU_SWEEP = ("--config", "tiny", "--t", "128", "--device", "cpu")
SPEC_PARTS = ("bench_repetitive", "bench_agentic_regenerate",
              "bench_perfanalyzer_column")


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def _tool_main(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with its stdout and stderr captured and
    logged, failing unless it returns 0; returns (stdout, stderr,
    seconds)."""
    import io

    out, err = io.StringIO(), io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(*args, **kwargs)
    seconds = time.monotonic() - t0
    for line in out.getvalue().splitlines():
        log("tools {}: {}".format(name, line))
    for line in err.getvalue().splitlines():
        log("tools {} (stderr): {}".format(name, line))
    log("tools {}: exit {}, {:.1f} s".format(name, rc, seconds))
    if rc != 0:
        fail("tools: {} exited {}".format(name, rc))
    return out.getvalue(), err.getvalue(), seconds


@contextlib.contextmanager
def _swapped(module, values):
    """``module``'s attributes set to ``values`` for the block."""
    saved = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def _counted_parts(module, names, by_part):
    """``module``'s functions ``names`` wrapped, each recording the flash
    and decode launches of its call into ``by_part[name]``."""
    from tpuserver_torch.ops import flash as fl

    def counted(name, fn):
        def run(*args, **kwargs):
            fl.reset_launch_counts()
            try:
                return fn(*args, **kwargs)
            finally:
                by_part[name] = {k: getattr(fl, k).launches for k in (
                    "flash_attention", "decode_attention")}
        return run

    return {name: counted(name, getattr(module, name)) for name in names}


def _tools_kernels(card):
    """Phase 15 (1): bench_kernels' sweep (its module's shapes); the
    launches its wrappers counted, the launches its graphs replayed, and
    its seconds."""
    from tpuserver_torch import bench_kernels
    from tpuserver_torch.ops import flash as fl

    fl.reset_launch_counts()
    out, err, seconds = _tool_main("bench_kernels", bench_kernels.main,
                                   [] if card else ["--device", "cpu"])
    rows = [r for r in _json_lines(out) if "impl" in r]
    errors = _json_lines(err)
    for row in rows:
        value = row.get("ms", row.get("us"))
        share = row.get("mfu", row.get("mbu"))
        if not (value is not None and math.isfinite(value) and value > 0):
            fail("tools: bench_kernels row without a time: {}".format(row))
        if card and not (share is not None and 0 < share <= 1):
            fail("tools: bench_kernels row's share of the peak: {}".format(
                row))
    have = {(r["op"], r.get("T", r.get("S")), r.get("valid"), r["impl"])
            for r in rows}
    flash_sizes = [(t, None) for t in bench_kernels.FLASH_LENS]
    decode_sizes = [(n, int(n * f)) for n, f in bench_kernels.DECODE_CASES]
    for op, impl, sizes in (
            ("flash_attention", "cuda_flash", flash_sizes),
            ("flash_attention", "torch_dense", flash_sizes),
            ("decode_attention", "cuda_decode", decode_sizes),
            ("decode_attention", "torch_dense", decode_sizes)):
        for size, valid in sizes:
            if (op, size, valid, impl) in have:
                continue
            oom = [e for e in errors if e.get("op") == op
                   and e.get("T", e.get("S")) == size
                   and "out of memory" in e.get("error", "").lower()]
            if impl == "torch_dense" and size == TOOLS_FLASH_TS[-1] and oom:
                log("tools bench_kernels: no {} row at {} {} (out of "
                    "memory, {} attempts)".format(impl, op, size, len(oom)))
                continue
            fail("tools: bench_kernels has no {} row for {} at {}".format(
                impl, op, size))
    counted = {k: v["counted"] for k, v in bench_kernels.LAUNCHES.items()}
    replayed = {k: v["replayed"] for k, v in bench_kernels.LAUNCHES.items()}
    wrapped = {k: getattr(fl, k).launches for k in counted}
    log("tools bench_kernels: launches counted by the wrappers {} (eager "
        "calls and captures; the tool's own tally {}), replayed by the "
        "graphs {} (each graph's captured launches times its replays)"
        .format(json.dumps(wrapped), json.dumps(counted),
                json.dumps(replayed)))
    if card and not (wrapped == counted and all(counted.values())
                     and all(replayed.values())):
        fail("tools: bench_kernels' launches: wrappers {}, tool {}, "
             "replayed {}".format(wrapped, counted, replayed))
    return wrapped, replayed, seconds


def _tools_sweep(params, card):
    """Phase 15 (2): the prefill/decode sweep on ``params``; its launches
    summed over the arms, and its seconds."""
    from tpuserver_torch import bench_prefill_sweep as sweep

    cpu = () if card else TOOLS_CPU_SWEEP
    out, _, seconds = _tool_main(
        "prefill_sweep", sweep.main, list(SWEEP_PREFILL_ARGV + cpu),
        params=params)
    stats = {"prefill": sweep.STATS["prefill"]}
    decode_out, _, decode_seconds = _tool_main(
        "prefill_sweep", sweep.main, list(SWEEP_DECODE_ARGV + cpu),
        params=params)
    stats["decode"] = sweep.STATS["decode"]
    seconds += decode_seconds
    rows = _json_lines(out + decode_out)
    prefill = {r["arm"]: r for r in rows if r.get("phase") == "prefill"}
    decode = [r for r in rows if r.get("phase") == "decode"]
    bad = [r for r in rows if "error" in r]
    if bad or len(prefill) != 6 or len(decode) != 16:
        fail("tools: the sweep printed {} prefill and {} decode rows, "
             "errors {}".format(len(prefill), len(decode), bad))
    for row in rows:
        value = row.get("ms", row.get("tokens_per_sec"))
        share = row.get("mfu", row.get("mbu"))
        if not (math.isfinite(value) and value > 0) or (
                card and not (share is not None and 0 < share <= 1)):
            fail("tools: sweep row {}".format(row))
    log("tools prefill_sweep: launches by arm {}".format(json.dumps(stats)))
    # the four flash arms run one kernel: their spread is the sweep's own
    # noise, the margin the identity arm is held to
    flash_ms = sorted(r["ms"] for arm, r in prefill.items()
                      if arm.startswith("flash_"))
    spread = flash_ms[-1] - flash_ms[0]
    identity = prefill["attention_identity"]["ms"]
    dense = prefill["dense"]["ms"]
    log("tools prefill_sweep: identity arm {} ms, {:.3f} of the fastest "
        "flash arm's {} ms, faster than every flash arm: {}; flash arms' "
        "spread {:.3f} ms (one kernel, the sweep's own noise); dense arm "
        "{} ms".format(identity, identity / flash_ms[0], flash_ms[0],
                       identity < flash_ms[0], spread, dense))
    if card:
        if not (identity < dense - spread
                and identity <= flash_ms[0] + spread):
            fail("tools: the identity arm ({} ms) is not faster than the "
                 "dense arm ({} ms) or is slower than the flash arms ({}) "
                 "by more than their spread".format(identity, dense,
                                                    flash_ms))
        for arm, counts in stats["prefill"].items():
            want = (len(params["layers"]) * counts["prefills"]
                    if arm.startswith("flash_") else 0)
            if counts["flash_attention"] != want:
                fail("tools: prefill arm {} launched flash {} times "
                     "(want {})".format(arm, counts["flash_attention"], want))
        for key, counts in stats["decode"].items():
            weights, impl = key.split("/")[:2]
            if (counts["decode_attention"] > 0) != (impl == "auto"):
                fail("tools: decode arm {} launched decode {} times".format(
                    key, counts["decode_attention"]))
            if (counts["int8_matmul"] > 0) != (weights == "int8"):
                fail("tools: decode arm {} launched W8A16 {} times".format(
                    key, counts["int8_matmul"]))
    launches = {k: sum(c[k] for part in ("prefill", "decode")
                       for c in stats[part].values())
                for k in ("flash_attention", "decode_attention",
                          "int8_matmul")}
    return launches, seconds


def _tools_speculative(params, card, out_path):
    """Phase 15 (3): bench_speculative on ``params`` (token identity is
    checked inside it); its launches summed over its parts, and its
    seconds."""
    from tpuserver_torch import bench_speculative as spec_tool

    by_part = {}
    config = "llama3_8b" if card else "tiny"
    with _swapped(spec_tool, _counted_parts(spec_tool, SPEC_PARTS, by_part)):
        out, _, seconds = _tool_main(
            "bench_speculative", spec_tool.main,
            ["--config", config, "--out", out_path]
            + ([] if card else ["--device", "cpu"]), params=params)
    with open(out_path) as fh:
        payload = json.load(fh)
    log("tools bench_speculative: rows {}".format(json.dumps(
        {r["metric"]: r["value"] for r in payload["rows"]})))
    log("tools bench_speculative: note: {}".format(payload["note"]))
    log("tools bench_speculative: launches by part {}".format(
        json.dumps(by_part)))
    if len(payload["rows"]) != 5 or "identical" not in out:
        fail("tools: bench_speculative wrote {} rows".format(
            len(payload["rows"])))
    if card and not (by_part["bench_repetitive"]["decode_attention"]
                     and by_part["bench_agentic_regenerate"][
                         "decode_attention"]
                     and not by_part["bench_perfanalyzer_column"][
                         "decode_attention"]):
        fail("tools: bench_speculative's decode launches by part: "
             "{}".format(by_part))
    return {k: sum(part[k] for part in by_part.values())
            for k in ("flash_attention", "decode_attention")}, seconds


def phase_tools(torch, params, smi, device="cuda"):
    """Phase 15: the three model-path tuning tools (``python -m
    tpuserver_torch.bench_kernels``, ``bench_prefill_sweep`` and
    ``bench_speculative``) through their ``main``s, the last two on
    ``params`` (``llama3_8b``'s, bf16); returns each tool's kernel
    launches (bench_kernels' with its ``graph_replayed`` ones).
    ``device="cpu"`` rehearses it on the CPU, without the card's launch,
    share and timing checks: bench_kernels at its module's shapes (the
    caller makes them small), the sweep on ``tiny`` at T 128 on weights
    it draws, bench_speculative on ``params`` (``tiny``'s at vocab
    512)."""
    import tempfile

    card = device == "cuda"
    t_start = _tools_phase_start(torch, card, "tools")
    launches, seconds = {}, {}
    counted, replayed, seconds["bench_kernels"] = _tools_kernels(card)
    launches["bench_kernels"] = dict(counted, graph_replayed=replayed)
    launches["prefill_sweep"], seconds["prefill_sweep"] = _tools_sweep(
        params if card else None, card)
    _release(torch, card)
    with tempfile.TemporaryDirectory() as tmp:
        launches["bench_speculative"], seconds["bench_speculative"] = \
            _tools_speculative(params, card,
                               os.path.join(tmp, "bench_speculative.json"))
    _tools_phase_end(torch, card, "tools: phase 15", t_start, seconds, smi,
                     launches)
    return launches


def _release(torch, card):
    """Collect the dropped models and, on the card, return their memory."""
    gc.collect()
    if card:
        torch.cuda.empty_cache()


def _tools_phase_start(torch, card, label):
    """A tools phase's start: memory released, the card's peak reset and
    its allocation logged; returns the start time."""
    _release(torch, card)
    if card:
        torch.cuda.reset_peak_memory_stats()
        log("{}: {:.3f} GiB allocated at the start".format(
            label, torch.cuda.memory_allocated() / 2 ** 30))
    return time.monotonic()


def _tools_phase_end(torch, card, label, t_start, seconds, smi, launches):
    """A tools phase's end: memory released, and its seconds (each tool's
    too), the card, its peak allocation and the launches logged."""
    _release(torch, card)
    log("{} {:.1f} s ({}), {}, peak {:.3f} GiB allocated, "
        "launches {}".format(
            label, time.monotonic() - t_start, ", ".join(
                "{} {:.1f} s".format(k, v) for k, v in seconds.items()),
            smi, torch.cuda.max_memory_allocated() / 2 ** 30 if card
            else 0.0, json.dumps(launches)))


#: the source of each kernel of the tools' rows, and the TPU kernel it
#: replaces
KERNEL_SRC = "src/python/tpuserver_torch/csrc/{}.cu"
KERNEL_TPU = {"flash_attention": "src/python/tpuserver/ops/flash.py:139",
              "decode_attention": "src/python/tpuserver/ops/flash.py:263"}


def _kernel_row(kname, path, launches, max_err, row, timed_as):
    """A tools phase's kernels-line row: ``kname``'s ``launches`` on
    ``path`` beside its time ``row`` at the ``timed_as`` shape."""
    return {
        "name": kname, "route": "cuda", "source": KERNEL_SRC.format(kname),
        "kernel_route": _route_of(kname, row),
        "replaces": KERNEL_TPU[kname], "path": path, "launches": launches,
        "max_abs_err": max_err, "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "library_live_ms": row.get("library_live_ms"),
        "timed_as": timed_as}


def _tools_kernel_rows(torch, rows, launches):
    """The kernels line's rows for phase 15's launches: flash and decode
    timed as phase 3 timed them at each tool's shape (bench_kernels'
    flash at T 8192 and decode over 32768 keys, the sweep's flash at its
    2048-token prefill and decode at its longest context,
    bench_speculative's decode at its batched step), and the W8A16
    kernel over one ``llama3_8b`` decode step at M 1, held against its
    plain version and timed here."""
    from tpuserver_torch.models import llama
    from tpuserver_torch.ops import perf, quant

    kernels = []
    for kname, path, timed_as in (
            ("flash_attention", "bench_kernels",
             "flash_attention_tools_T{}".format(TOOLS_FLASH_TS[1])),
            ("decode_attention", "bench_kernels",
             "decode_attention_tools_S{}_L{}".format(
                 TOOLS_DECODE_SEQ, TOOLS_DECODE_LENGTHS[-1])),
            ("flash_attention", "prefill_sweep", "flash_attention_T2048"),
            ("decode_attention", "prefill_sweep", "decode_attention_sweep"),
            ("decode_attention", "bench_speculative",
             "decode_attention_spec_tool")):
        counts = launches[path]
        kernels.append(_kernel_row(kname, path, counts[kname],
                                   rows["max_err"][kname],
                                   rows["timed"][timed_as], timed_as))
        if "graph_replayed" in counts:
            kernels[-1]["graph_replayed_launches"] = counts[
                "graph_replayed"][kname]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cases = {}
    for k, n in sorted({(k, n) for _, k, n in INT8_WEIGHTS}):
        for row in _int8_cases(torch, quant, perf, dev, gen, k, n, flush,
                               m_rows=(1,)):
            log("kernel_case:", json.dumps(row))
            cases[(1, k, n)] = row
            if not row["row_rel_err"] <= INT8_TOL or not row[
                    "planted_fault_err"]["skipped_rows"] > INT8_TOL:
                fail("int8_matmul at M 1: {}".format(row))
    del flush
    step = _int8_step_sum(cases, 1, llama.llama3_8b().n_layers)
    kernels.append({
        "name": "int8_matmul", "route": "cuda",
        "source": KERNEL_SRC.format("int8_matmul"),
        "replaces": "src/python/tpuserver/ops/quant.py:68",
        "path": "prefill_sweep",
        "launches": launches["prefill_sweep"]["int8_matmul"],
        "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
        "ms": step["ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
        "library_ms": step["library_ms"],
        "bf16_matmul_ms": step["bf16_matmul_ms"],
        "timed_as": "one decode step at M 1: {}".format(step["shape"])})
    return kernels


# -- phase 16: the serving-plane tools ---------------------------------------


# the shapes phase 16 holds and times the kernels at: the generation
# part's 256-token prompts (flash) and its step (4 slots of a 512-key
# cache, one stream at a time halfway through its 16 tokens, the rest
# inert), the resume part's float32 step (2 slots of 512, the resumed
# stream halfway through its 24 tokens), and the disagg step (3
# background streams halfway through their 8 + 48 tokens beside a probe's
# decode token)
SERVING_TOOLS_FLASH_T = 256
SERVING_TOOLS_DECODE = {
    "generation": ((264, 1, 1, 1), 512, "bfloat16"),
    "resume": ((460, 1), 512, "float32"),
    "disagg": ((32, 32, 32, 161), 256, "bfloat16"),
}
SHM_PARTS = ("bench_unary", "bench_generation", "bench_resume_attach")
DISAGG_ATTNS = ("kernel", "dense")


def _serving_shm(params, card, out_path):
    """Phase 16 (a): bench_shm_data_plane; its launches by part and its
    seconds."""
    from tpuserver_torch import bench_shm_data_plane as shm_tool

    by_part = {}
    argv = ["--out", out_path]
    argv += (["--config", "llama3_8b"] if card
             else ["--dtype", "float32", "--device", "cpu"])
    with _swapped(shm_tool, _counted_parts(shm_tool, SHM_PARTS, by_part)):
        _, _, seconds = _tool_main("bench_shm_data_plane", shm_tool.main,
                                   argv, params=params)
    with open(out_path) as fh:
        payload = json.load(fh)
    rows = {r["metric"]: r for r in payload["rows"]}
    log("tools bench_shm_data_plane: rows {}".format(json.dumps(
        {k: r["value"] for k, r in rows.items()})))
    log("tools bench_shm_data_plane: note: {}".format(payload["note"]))
    log("tools bench_shm_data_plane: launches by part {}".format(
        json.dumps(by_part)))
    resume = [r for k, r in rows.items() if k.startswith("resume_")]
    if len(rows) != 9 or len(resume) != 2 or not all(
            r["token_identical"] and r["dtype"] == "float32" for r in resume):
        fail("tools: bench_shm_data_plane's rows: {}".format(rows))
    for row in rows.values():
        if not (math.isfinite(row["value"]) and row["value"] > 0):
            fail("tools: bench_shm_data_plane row {}".format(row))
    if card and not (by_part["bench_generation"]["decode_attention"]
                     and by_part["bench_generation"]["flash_attention"]
                     and by_part["bench_resume_attach"]["decode_attention"]):
        fail("tools: bench_shm_data_plane's launches by part: {}".format(
            by_part))
    return by_part, seconds


def _serving_disagg(params, card, attn, out_path):
    """Phase 16 (b): bench_disagg at ``--attn attn``; its launches and
    its seconds."""
    from tpuserver_torch import bench_disagg
    from tpuserver_torch.ops import flash as fl

    argv = ["--attn", attn, "--out", out_path]
    argv += (["--config", "llama3_8b", "--dtype", "bfloat16"] if card
             else ["--dtype", "float32", "--device", "cpu"])
    fl.reset_launch_counts()
    _, _, seconds = _tool_main("bench_disagg_" + attn, bench_disagg.main,
                               argv, params=params)
    launches = {k: getattr(fl, k).launches
                for k in ("flash_attention", "decode_attention")}
    with open(out_path) as fh:
        payload = json.load(fh)
    rows = {r["metric"]: r for r in payload["rows"]}
    split = [r for k, r in rows.items() if k.endswith("_split")]
    log("tools bench_disagg_{}: rows {}".format(attn, json.dumps(
        {k: [r["value"], r["prefill_chunks"]] for k, r in rows.items()})))
    log("tools bench_disagg_{}: split rows {}".format(attn,
                                                      json.dumps(split)))
    log("tools bench_disagg_{}: note: {}".format(attn, payload["note"]))
    log("tools bench_disagg_{}: launches {}".format(attn,
                                                    json.dumps(launches)))
    chunks = {r["prefill_chunks"] for r in rows.values()}
    if len(rows) != 4 or not all(
            r["attn_impl"] == attn and r["token_identical"]
            and r["splits"] >= bench_disagg.N_PROBES for r in split):
        fail("tools: bench_disagg_{}'s rows: {}".format(attn, rows))
    # the schedulers' own count: no chunk where span prefill is unsafe
    # (the flash presets), some in both fleets where it is safe
    if not (chunks == {0} if attn == "kernel" else 0 not in chunks):
        fail("tools: bench_disagg_{} ran prefill chunks {}".format(
            attn, chunks))
    if card and not launches["decode_attention"]:
        fail("tools: bench_disagg_{} launched no decode kernel".format(attn))
    return launches, seconds


def phase_serving_tools(torch, params, smi, device="cuda"):
    """Phase 16: the serving-plane tools (``python -m
    tpuserver_torch.bench_shm_data_plane`` and ``bench_disagg``) through
    their ``main``s on ``params`` (``llama3_8b``'s, bf16); returns each
    stage's kernel launches: ``bench_shm_data_plane/<part>`` and
    ``bench_disagg_<attn>``.  ``device="cpu"`` rehearses it on the CPU,
    without the card's launch checks: each tool on ``tiny`` at float32
    on weights it draws (the two tools' ``tiny`` differ in vocabulary)."""
    import tempfile

    card = device == "cuda"
    t_start = _tools_phase_start(torch, card, "serving tools")
    launches, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        by_part, seconds["bench_shm_data_plane"] = _serving_shm(
            params if card else None, card,
            os.path.join(tmp, "bench_shm_data_plane.json"))
        launches["bench_shm_data_plane/generation"] = by_part[
            "bench_generation"]
        launches["bench_shm_data_plane/resume"] = by_part[
            "bench_resume_attach"]
        for attn in DISAGG_ATTNS:
            _release(torch, card)
            name = "bench_disagg_" + attn
            launches[name], seconds[name] = _serving_disagg(
                params if card else None, card, attn,
                os.path.join(tmp, name + ".json"))
    _tools_phase_end(torch, card, "serving tools: phase 16", t_start,
                     seconds, smi, launches)
    return launches


def _serving_tools_timed(torch):
    """Both kernels held against their plain versions and timed at phase
    16's shapes (Llama-3-8B's heads); the rows by ``timed_as`` key, and
    the largest error of each kernel."""
    import torch.nn.functional as F

    from tpuserver_torch.ops import flash as fl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    h, hkv, d = 32, 8, 128
    timed = {"flash_attention_serving_T{}".format(SERVING_TOOLS_FLASH_T):
             _flash_case(torch, F, fl, dev, gen, 1, SERVING_TOOLS_FLASH_T,
                         h, hkv, d, True, torch.bfloat16, True, flush)}
    for part, (lengths, s, dtype) in SERVING_TOOLS_DECODE.items():
        timed["decode_attention_serving_" + part] = _decode_case(
            torch, F, fl, dev, gen, lengths, s, h, hkv, d,
            getattr(torch, dtype), True, flush)
    del flush
    torch.cuda.empty_cache()
    for key, row in timed.items():
        log("kernel_case: {} {}".format(key, json.dumps(row)))
        if not row["row_rel_err"] <= TOL[row["dtype"]] or any(
                not e > TOL[row["dtype"]]
                for e in row.get("planted_fault_err", {}).values()):
            fail("serving tools: {} against its plain version: {}".format(
                key, row))
    max_err = {}
    for key, row in timed.items():
        kname = key.split("_serving_")[0]
        max_err[kname] = max(max_err.get(kname, 0.0), row["max_abs_err"])
    return timed, max_err


def _serving_tools_kernel_rows(launches, timed, max_err):
    """The kernels line's rows for phase 16's launches: each stage's flash
    and decode launches beside the kernel's time at that stage's shape
    (flash at T 256 for every stage: the only flash length the tools
    run)."""
    flash_key = "flash_attention_serving_T{}".format(SERVING_TOOLS_FLASH_T)
    decode_key = {"bench_shm_data_plane/generation": "generation",
                  "bench_shm_data_plane/resume": "resume",
                  "bench_disagg_kernel": "disagg",
                  "bench_disagg_dense": "disagg"}
    kernels = []
    for path, counts in launches.items():
        for kname, timed_as in (
                ("flash_attention", flash_key),
                ("decode_attention",
                 "decode_attention_serving_" + decode_key[path])):
            kernels.append(_kernel_row(kname, path, counts[kname],
                                       max_err[kname], timed[timed_as],
                                       timed_as))
    return kernels

# -- phase 17: the distributed perf analyzer and the router-tier bench -------


# the server's llama: max_seq a multiple of the decode kernel's 256 blocks
# and room for a 512-token prompt and its 32 tokens; prefix caching off,
# so every admission prefills its whole prompt (a flash launch a layer)
DIST_SEQ = 1024
# the decode kernel at the served step: 8 slots of a 1024-key cache, each
# row between its 512-token prompt and its last token
DIST_DECODE_LENGTHS = tuple(512 + 4 * i for i in range(8))
# the arms: generation of 32 tokens from 512-token prompts, 3 s windows;
# ResNet-50 batch 1 in band, then over system and CUDA regions (the
# output in a region of the input's kind), 1 s windows.  Each arm runs
# its single process at ``single`` streams, then ``workers`` processes at
# ``per_worker`` each, three windows a side
DIST_GEN_ARGS = ("-m", "llama_generate", "--generation", "--prompt-len",
                 "512", "--max-tokens", "32", "--input-pool", "64",
                 "--measurement-interval", "3000")
DIST_UNARY_ARGS = ("-m", "resnet50", "--measurement-interval", "1000")
DIST_SHM_ARGS = ("--output-shared-memory-size", str(OUTPUT_BYTES))
DIST_ARMS = (
    ("generation", DIST_GEN_ARGS, "none", 8, 4, 2),
    ("resnet50", DIST_UNARY_ARGS, "none", 16, 4, 4),
    ("resnet50", DIST_UNARY_ARGS, "system", 16, 4, 4),
    ("resnet50", DIST_UNARY_ARGS, "cuda", 16, 4, 4))
DIST_WINDOWS = 3
# python -m tpuserver_torch.bench_router_tier's flags (none: the JAX
# tool's defaults, 10200 streams)
ROUTER_TIER_ARGV = ()
ROUTER_TIER_STREAMS = 10200
# the phase's share of a run: reported, not enforced
DIST_BUDGET_S = 300.0


def _served_decode_timed(torch, label, lengths, s, seed):
    """The decode kernel held against its plain version (the planted
    faults beyond the tolerance) and timed at a served ``llama3_8b`` step
    of bf16 rows of ``lengths`` in an ``s``-key cache; its row."""
    import torch.nn.functional as F

    from tpuserver_torch.ops import flash as fl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    row = _decode_case(torch, F, fl, dev, gen, lengths, s, 32, 8, 128,
                       torch.bfloat16, True, flush)
    del flush
    torch.cuda.empty_cache()
    log("kernel_case: decode_attention_{} {}".format(
        label.replace(" ", "_"), json.dumps(row)))
    if not row["row_rel_err"] <= TOL[row["dtype"]] or any(
            not e > TOL[row["dtype"]]
            for e in row.get("planted_fault_err", {}).values()):
        fail("{}: decode_attention against its plain version: {}".format(
            label, row))
    return row


def _distributed_timed(torch):
    """The decode kernel held and timed at phase 17's batched step (the
    flash kernel's T 512 prefill is phase 3's ``flash_attention`` row)."""
    return _served_decode_timed(torch, "distributed", DIST_DECODE_LENGTHS,
                                DIST_SEQ, SEED + 17)


def _dist_quiet(model, timeout=120.0):
    """Wait until the served llama holds no stream (the clients' last
    generations finish or are cancelled); its scheduler's stats."""
    deadline = time.monotonic() + timeout
    while True:
        stats = model.scheduler_stats() or {}
        if not stats.get("live_streams") and not stats.get("pending"):
            return stats
        if time.monotonic() > deadline:
            fail("distributed: streams still live after the run: {}".format(
                stats))
        time.sleep(0.05)


def _dist_single(url, args, plane, level, device):
    """The single-process arm: ``python -m tpuserver_torch.perf_analyzer``
    as a process of its own at ``level``; (its rows, its output)."""
    argv = [sys.executable, "-m", "tpuserver_torch.perf_analyzer",
            "--backend", "http", "-u", url, "--shared-memory", plane,
            "--concurrency-range", str(level),
            "--max-trials", str(DIST_WINDOWS)] + list(args)
    if device == "cpu":
        argv += ["--device", "cpu"]
    proc = subprocess.run(argv, capture_output=True, text=True,
                          env=_port_env(), cwd=HERE, timeout=600)
    if proc.returncode != 0:
        fail("distributed: the single process exited {}: {} {}".format(
            proc.returncode, proc.stdout[-2000:], proc.stderr[-2000:]))
    rows = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith('{"')]
    return rows, proc.stdout


def _dist_workers(url, args, plane, workers, level, csv_path, device):
    """The distributed arm: the coordinator (``perf_analyzer.main`` with
    ``--workers``, here; it only merges) and its worker processes; (its
    rows, its output, each window's completions by worker)."""
    import io

    from tpuserver_torch import perf_analyzer
    from tpuserver_torch.perfanalyzer import coordinator

    argv = ["--backend", "http", "-u", url, "--shared-memory", plane,
            "--workers", str(workers), "--concurrency-range", str(level),
            "--windows", str(DIST_WINDOWS), "--report-csv", csv_path
            ] + list(args)
    if device == "cpu":
        argv += ["--device", "cpu"]
    by_window = []
    merge = coordinator.merge_worker_windows

    def recording(results):
        by_window.append([int(r.get("completed", 0)) for r in results])
        return merge(results)

    buf = io.StringIO()
    coordinator.merge_worker_windows = recording
    try:
        with contextlib.redirect_stdout(buf):
            rc = perf_analyzer.main(argv)
    finally:
        coordinator.merge_worker_windows = merge
    if rc != 0:
        fail("distributed: the coordinator exited {}: {}".format(
            rc, buf.getvalue()[-2000:]))
    rows = [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith('{"')]
    return rows, buf.getvalue(), by_window


def _dist_summary(label, side, row, smi):
    """One side's numbers in a line: infer/s and latency for a unary row,
    tokens/s, TTFT and ITL for a generation row."""
    if row.get("unit") == "tokens/sec":
        return ("distributed {} {}: {:.2f} tokens/s, {} generations, "
                "TTFT p50 {} ms p99 {} ms, ITL p50 {} ms p99 {} ms, {} "
                "errors; {}".format(
                    label, side, row["value"], row["generations"],
                    row["ttft_p50_ms"], row["ttft_p99_ms"],
                    row["itl_p50_ms"], row["itl_p99_ms"], row["errors"],
                    smi))
    return ("distributed {} {}: {:.2f} infer/s, {} completed, p50 {} us "
            "p99 {} us, {} errors; {}".format(
                label, side, row["value"], row["completed"],
                row["p50_usec"], row["p99_usec"], row["errors"], smi))


def _dist_regions_left(core, keys):
    """The regions the phase left: the server's registries, and the files
    under ``/dev/shm`` of the system regions its clients registered
    (``keys``: a scan would see other processes' files)."""
    files = [k for k in keys if os.path.exists("/dev/shm" + k)]
    return core.cuda_shm_status(), core.system_shm_status(), files


def _dist_arm(core, model, url, arm, smi, device, tmp, keys):
    """One arm, single process then workers: the two rows, the launches
    of each side and its admissions."""
    import csv

    from tpuserver_torch.ops import flash as fl
    from tpuserver_torch.perfanalyzer.report import WINDOW_CSV_COLUMNS

    kind, args, plane, single, workers, per_worker = arm
    label = kind if plane == "none" else "{} {}".format(kind, plane)
    out = {}
    for side in ("single", "workers"):
        before = _dist_quiet(model)
        keys0 = len(keys)
        reads0 = core.shm_stats()["shm_zero_copy_reads"]
        fl.reset_launch_counts()
        t0 = time.monotonic()
        if side == "single":
            rows, text = _dist_single(url, args, plane, single, device)
            by_window = None
        else:
            csv_path = os.path.join(tmp, "windows.csv")
            rows, text, by_window = _dist_workers(
                url, args, plane, workers, per_worker, csv_path, device)
        after = _dist_quiet(model)
        seconds = time.monotonic() - t0
        launches = {"flash_attention": fl.flash_attention.launches,
                    "decode_attention": fl.decode_attention.launches}
        admitted = after.get("admitted", 0) - before.get("admitted", 0)
        reads = core.shm_stats()["shm_zero_copy_reads"] - reads0
        log(text.rstrip())
        if len(rows) != 1:
            fail("distributed {} {}: {} rows, want 1".format(
                label, side, len(rows)))
        row = rows[0]
        log(_dist_summary(label, side, row, smi))
        log("distributed {} {}: {:.1f} s; launches {}; {} admissions; "
            "{} zero-copy reads".format(label, side, seconds,
                                        json.dumps(launches), admitted,
                                        reads))
        if row["errors"]:
            fail("distributed {} {}: {} errors".format(
                label, side, row["errors"]))
        if kind == "generation":
            if not row["tokens"] or not row["generations"]:
                fail("distributed {} {}: tokens {}, generations {}".format(
                    label, side, row["tokens"], row["generations"]))
            if device == "cuda" and (
                    launches["flash_attention"]
                    != model._cfg.n_layers * admitted
                    or not admitted or not launches["decode_attention"]):
                fail("distributed {} {}: launches {} for {} admitted "
                     "prefills (flash wants {} a prefill)".format(
                         label, side, launches, admitted,
                         model._cfg.n_layers))
        elif not row["completed"]:
            fail("distributed {} {}: nothing completed".format(label, side))
        if side == "workers":
            if row["workers"] != workers or row["level"] != (
                    workers * per_worker) or len(by_window) != DIST_WINDOWS:
                fail("distributed {}: workers {}, level {}, windows {}"
                     .format(label, row["workers"], row["level"],
                             by_window))
            summed = sum(sum(w) for w in by_window)
            if row["completed"] != summed or any(
                    len(w) != workers for w in by_window):
                fail("distributed {}: merged completions {} != the "
                     "workers' sum {} ({})".format(
                         label, row["completed"], summed, by_window))
            log("distributed {}: completions by window and worker {} "
                "(sum {} = merged)".format(label, by_window, summed))
            with open(csv_path, newline="") as fh:
                lines = list(csv.reader(fh))
            if lines[0] != [h for h, _ in WINDOW_CSV_COLUMNS] or \
                    len(lines) != 1 + DIST_WINDOWS:
                fail("distributed {}: --report-csv {}".format(label, lines))
        if plane == "system" and len(keys) == keys0:
            fail("distributed {} {}: no system region registered".format(
                label, side))
        left = _dist_regions_left(core, keys)
        if any(left):
            fail("distributed {} {}: regions left behind: {}".format(
                label, side, left))
        out[side] = {"row": row, "launches": launches,
                     "admitted": admitted, "seconds": seconds}
    ratio = out["workers"]["row"]["value"] / max(
        out["single"]["row"]["value"], 1e-9)
    log("distributed {}: {} workers x {} = {:.2f} {} against one process "
        "at {} = {:.2f}: ratio {:.3f}; {}".format(
            label, workers, per_worker, out["workers"]["row"]["value"],
            out["workers"]["row"]["unit"], single,
            out["single"]["row"]["value"], ratio, smi))
    return out


def _router_tier(smi, tmp):
    """(b): ``python -m tpuserver_torch.bench_router_tier`` as a process,
    at the JAX tool's defaults unless the host's descriptor limit cannot
    hold its streams (then at the most it can, the cut printed); its rows
    and the streams asked for."""
    import resource

    from tpuserver_torch import bench_router_tier

    streams = ROUTER_TIER_STREAMS
    argv = list(ROUTER_TIER_ARGV)
    hard = resource.getrlimit(resource.RLIMIT_NOFILE)[1]
    if hard != resource.RLIM_INFINITY and hard < \
            bench_router_tier.descriptors_needed(streams, 1000, 4):
        streams = (hard - bench_router_tier.FD_SLACK) // 12 * 12
        argv += ["--streams", str(streams)]
        log("distributed: router tier CUT to {} streams: RLIMIT_NOFILE's "
            "hard limit {} cannot hold {}".format(
                streams, hard, ROUTER_TIER_STREAMS))
    out_path = os.path.join(tmp, "bench_router_tier.json")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "tpuserver_torch.bench_router_tier",
         "--out", out_path] + argv, capture_output=True, text=True,
        env=_port_env(), cwd=tmp, timeout=900)
    seconds = time.monotonic() - t0
    lines = [ln for ln in proc.stdout.splitlines()
             if not ln.startswith(("stub replica", "fleet router",
                                   "router "))]
    log("\n".join(lines))
    if proc.returncode != 0:
        fail("distributed: bench_router_tier exited {}: {}".format(
            proc.returncode, proc.stderr[-3000:]))
    with open(out_path) as fh:
        rows = json.load(fh)["rows"]
    for row in rows:
        log("router tier row: {}".format(json.dumps(row)))
    log("distributed: bench_router_tier {:.1f} s on the card's host "
        "({}; no device work)".format(seconds, smi))
    by = {(r["config"], r["metric"]): r for r in rows}
    held = by[("3-active selector tier", "concurrent_streams_held")]
    takeover = by[("takeover (SIGKILL 1 of 3 actives)",
                   "takeover_window_p99_s")]
    want = int(dict(zip(argv[::2], argv[1::2])).get("--streams", streams))
    if held["value"] != want or held["dial_errors"] or \
            held["peer_forwarded"]:
        fail("distributed: router tier held {} of {} (dial errors {}, "
             "peer-forwarded {})".format(held["value"], want,
                                         held["dial_errors"],
                                         held["peer_forwarded"]))
    if takeover["survivor_reconnects"] or not takeover["token_identical"] \
            or not takeover["victim_reconnects"]:
        fail("distributed: takeover row {}".format(takeover))
    return rows, seconds


def phase_distributed(torch, cfg, params, smi, device="cuda", vision=None):
    """Phase 17: the distributed perf analyzer (``python -m
    tpuserver_torch.perf_analyzer --workers``) beside one client process,
    every client a process of its own, against the port's HTTP server in
    this process (``params``' llama behind ``max_slots=8`` at ``max_seq``
    :data:`DIST_SEQ`, ResNet-50 and the fixtures; the wrappers count its
    launches here), then (b) ``python -m tpuserver_torch.bench_router_tier``;
    returns the generation arm's launches by side.  ``device="cpu"`` (with
    a narrow ``vision`` model) rehearses it on the CPU, without the
    card's launch checks."""
    import tempfile

    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.http_server import HttpServer
    from tpuserver_torch.models import default_models
    from tpuserver_torch.models import vision as tv
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel

    card = device == "cuda"
    t_start = _tools_phase_start(torch, card, "distributed")
    model = LlamaGenerateModel(cfg=cfg, max_seq=DIST_SEQ, max_slots=8,
                               params=params, device=device,
                               prefix_cache=False)
    if vision is None:
        vision = tv.ResNet50Model(device=device, seed=SEED)
    core = InferenceServer(default_models() + [vision, model])
    # the keys of the system regions the clients register, for the leak
    # check
    keys = []
    register = core.register_system_shm

    def recording(name, key, offset, byte_size):
        keys.append(key)
        return register(name, key, offset, byte_size)

    core.register_system_shm = recording
    http = None
    arms = []
    try:
        core.warmup()
        http = HttpServer(core, port=0).start()
        url = "127.0.0.1:{}".format(http.port)
        log("distributed: the server built and warm in {:.1f} s at {}"
            .format(time.monotonic() - t_start, url))
        with tempfile.TemporaryDirectory() as tmp:
            for arm in DIST_ARMS:
                if arm[2] == "cuda" and not card:
                    continue  # a CPU region attaches only in-process
                arms.append(_dist_arm(core, model, url, arm, smi, device,
                                      tmp, keys))
            perf_seconds = time.monotonic() - t_start
            http.stop()
            http = None
            core.close()
            core = None
            _release(torch, card)
            _, tier_seconds = _router_tier(smi, tmp)
    finally:
        if http is not None:
            http.stop()
        if core is not None:
            core.close()
    launches = {"distributed_single": arms[0]["single"]["launches"],
                "distributed_workers": arms[0]["workers"]["launches"]}
    _tools_phase_end(torch, card, "distributed: phase 17", t_start,
                     {"perf arms": perf_seconds,
                      "bench_router_tier": tier_seconds}, smi, launches)
    log("distributed: phase 17 {} its {:.0f} s budget".format(
        "within" if time.monotonic() - t_start <= DIST_BUDGET_S else "OVER",
        DIST_BUDGET_S))
    return launches


def _distributed_kernel_rows(rows, decode_row, launches):
    """The kernels line's rows for phase 17's generation arm: each side's
    flash and decode launches beside flash at its 512-token prefill
    (phase 3) and decode at the served step."""
    kernels = []
    for path, counts in launches.items():
        kernels.append(_kernel_row(
            "flash_attention", path, counts["flash_attention"],
            rows["max_err"]["flash_attention"], rows["timed"][
                "flash_attention"], "flash_attention"))
        kernels.append(_kernel_row(
            "decode_attention", path, counts["decode_attention"],
            max(rows["max_err"]["decode_attention"],
                decode_row["max_abs_err"]), decode_row,
            "decode_attention_distributed: 8 rows of {} keys, lengths {}"
            .format(DIST_SEQ, list(DIST_DECODE_LENGTHS))))
    return kernels


# -- phase 18: the prefix-cache bench and the server-side demos --------------


# python -m tpuserver_torch.bench_prefix_cache on the card: the 8B preset
# prefills with the flash kernel, where the scheduler keeps the radix cache
# off (span_safe), so the bench runs dense prefill on one bf16 tree the tool
# draws from seed 0
PREFIX_ARGV = ("--config", "llama3_8b", "--dtype", "bfloat16", "--attn",
               "dense")
# the CPU rehearsal: float32 ``tiny`` at vocab 512, drawn by the tool
PREFIX_CPU_ARGV = ("--dtype", "float32", "--device", "cpu")
# the bench's parts that run the llama, and their paths in the kernels line
# (the headline part serves the ``simple`` model alone)
PREFIX_PARTS = {
    "bench_warm_vs_cold_prefill": "bench_prefix_cache/warm_vs_cold",
    "bench_capacity_beyond_slots": "bench_prefix_cache/capacity",
    "bench_affinity_vs_blind": "bench_prefix_cache/affinity_vs_blind"}
# the warm admissions' hit rate: 240 of the prompt's 256 tokens (15 of its
# 16 pages) from the cache; and the live streams at four slots' memory
PREFIX_HIT_PCT = 93.8
PREFIX_STREAMS = 16
# the router demo on the card: the 8B preset in float32 (TF32 off), drawn
# by the demo after the bench's tree is freed
ROUTER_DEMO_ARGV = ("--config", "llama3_8b", "--dtype", "float32")
# the shapes phase 18 holds and times the decode kernel at (Llama-3-8B's
# heads): the warm/cold step (2 slots of a 512-key cache, one stream at a
# time just past its 256-token prompt, the other slot inert), the capacity
# step (16 streams of 128 keys, between their 3-token prompts and their
# 16th token), the fleet step (4 streams of 128, between their 72-token
# prompts and their 8th token) and the router demo's float32 step (2 slots
# of 128, one stream between its 5-token prompt and its 8th token)
PREFIX_DECODE = {
    "bench_prefix_cache/warm_vs_cold": ((258, 1), 512, "bfloat16"),
    "bench_prefix_cache/capacity": (tuple(range(3, 19)), 128, "bfloat16"),
    "bench_prefix_cache/affinity_vs_blind": ((72, 74, 77, 80), 128,
                                             "bfloat16"),
    "router_demo": ((9, 1), 128, "float32"),
}


def _prefix_cache_timed(torch):
    """The decode kernel held against its plain version and timed at phase
    18's shapes; the rows by path, and the largest error."""
    import torch.nn.functional as F

    from tpuserver_torch.ops import flash as fl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timed = {path: _decode_case(torch, F, fl, dev, gen, lengths, s, 32, 8,
                                128, getattr(torch, dtype), True, flush)
             for path, (lengths, s, dtype) in PREFIX_DECODE.items()}
    del flush
    torch.cuda.empty_cache()
    for path, row in timed.items():
        log("kernel_case: decode_attention {} {}".format(path,
                                                         json.dumps(row)))
        if not row["row_rel_err"] <= TOL[row["dtype"]] or any(
                not e > TOL[row["dtype"]]
                for e in row.get("planted_fault_err", {}).values()):
            fail("prefix cache: decode_attention at {} against its plain "
                 "version: {}".format(path, row))
    return timed, max(row["max_abs_err"] for row in timed.values())


def _prefix_bench_checks(rows, by_part, card):
    """Phase 18 (a)'s checks of bench_prefix_cache's rows and, on the
    card, of its launches by part: decode in every llama part, flash in
    none (dense prefill)."""
    by = {r["metric"]: r for r in rows}
    warm = by.get("prefill_ttft_warm_256tok")
    if warm is None or warm["radix_hit_rate_pct"] != PREFIX_HIT_PCT:
        fail("prefix cache: the warm row's hit rate is not {}: {}".format(
            PREFIX_HIT_PCT, warm))
    live = by.get("concurrent_streams_equal_memory")
    if live is None or live["value"] != PREFIX_STREAMS:
        fail("prefix cache: live streams at four slots' memory: {}".format(
            live))
    for arm in ("affinity", "hash_blind"):
        row = by.get("hit_rate_" + arm)
        if row is None or not (
                isinstance(row["value"], (int, float))
                and 0 <= row["value"] <= 100
                and row["prefix_cache_hits"] + row["prefix_cache_misses"]):
            fail("prefix cache: the {} fleet row: {}".format(arm, row))
    if "simple_inprocess_headline" not in by:
        fail("prefix cache: no headline row")
    if card:
        for part in PREFIX_PARTS:
            counts = by_part.get(part, {})
            if not counts.get("decode_attention") or counts.get(
                    "flash_attention"):
                fail("prefix cache: {} launched {} (decode wanted, flash "
                     "not)".format(part, counts))


def _prefix_bench(card, out_path, smi):
    """Phase 18 (a): bench_prefix_cache through its ``main``; its
    launches by part and its seconds."""
    from tpuserver_torch import bench_prefix_cache as tool

    by_part = {}
    argv = list(PREFIX_ARGV if card else PREFIX_CPU_ARGV) + ["--out",
                                                             out_path]
    with _swapped(tool, _counted_parts(tool, PREFIX_PARTS, by_part)):
        _, _, seconds = _tool_main("bench_prefix_cache", tool.main, argv)
    with open(out_path) as fh:
        payload = json.load(fh)
    rows = payload["rows"]
    for row in rows:
        log("prefix cache row: {}".format(json.dumps(row)))
    log("prefix cache: note: {}".format(payload["note"]))
    log("prefix cache: launches by part {}".format(json.dumps(by_part)))
    _prefix_bench_checks(rows, by_part, card)
    by = {r["metric"]: r for r in rows}
    cold = by["prefill_ttft_cold_256tok"]["value"]
    warm = by["prefill_ttft_warm_256tok"]
    log("prefix cache: 256-token TTFT cold {} ms, warm {} ms (cold/warm "
        "{:.3f}) at {}% radix hits; {}".format(
            cold, warm["value"], cold / warm["value"],
            warm["radix_hit_rate_pct"], smi))
    aff, blind = by["hit_rate_affinity"], by["hit_rate_hash_blind"]
    log("prefix cache: fleet hit rate affinity {}% ({} tokens/s, TTFT p50 "
        "{} ms) vs hash-blind {}% ({} tokens/s, TTFT p50 {} ms): affinity "
        "{} hash-blind; {}".format(
            aff["value"], aff["tokens_per_sec"], aff["ttft_p50_ms"],
            blind["value"], blind["tokens_per_sec"], blind["ttft_p50_ms"],
            "above" if aff["value"] > blind["value"] else "not above", smi))
    head = by["simple_inprocess_headline"]
    log("prefix cache: simple in-process {} infer/s, p50 {} us, p99 {} us; "
        "{}".format(head["value"], head["p50_usec"], head["p99_usec"], smi))
    return by_part, seconds


def _load_example(script):
    """An example of ``src/python/examples`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        script[:-3], os.path.join(HERE, "src", "python", "examples", script))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _router_demo(card):
    """Phase 18 (b) 1: the router demo in this process (so the wrappers
    count its replicas' launches); its launches and its seconds."""
    from tpuserver_torch.ops import flash as fl

    demo = _load_example("simple_http_router_torch.py")
    fl.reset_launch_counts()
    out, _, seconds = _tool_main(
        "router_demo", demo.main,
        list(ROUTER_DEMO_ARGV) if card else ["--device", "cpu"])
    launches = {k: getattr(fl, k).launches
                for k in ("flash_attention", "decode_attention")}
    absorbed = [ln for ln in out.splitlines()
                if ln.startswith("router absorbed it: handoffs=")]
    handoffs = int(absorbed[0].split("=")[1].split()[0]) if absorbed else 0
    log("prefix cache (b): router demo: {} handoffs, launches {}".format(
        handoffs, json.dumps(launches)))
    if "PASS:" not in out or handoffs < 1:
        fail("prefix cache (b): the router demo: {}".format(out[-2000:]))
    if card and not launches["decode_attention"]:
        fail("prefix cache (b): the router demo launched no decode kernel")
    return launches, seconds


def _fleet_demo(card):
    """Phase 18 (b) 2: the fleet demo as a process over ``python -m
    tpuserver_torch.serve`` replicas; its seconds."""
    t0 = time.monotonic()
    out = _example("simple_fleet_torch.py",
                   ["--device", "cuda" if card else "cpu"],
                   label="prefix cache (b)")
    healed = [ln for ln in out.splitlines()
              if ln.startswith(("healed:", "healthy fleet:",
                                "one replica dead:", "healed fleet:"))]
    log("prefix cache (b): fleet demo: {}".format(healed))
    return time.monotonic() - t0


def _http_cudashm_client(card):
    """Phase 18 (b) 3: the HTTP CUDA-region client against a port server in
    this process (on the card as a process of its own, its regions mapped
    over CUDA IPC; on the CPU in this process over CPU regions, which
    attach nowhere else); its seconds."""
    from tpuserver_torch import cuda_shared_memory as csm
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.http_server import HttpServer
    from tpuserver_torch.models import default_models

    script = "simple_http_cudashm_client.py"
    t0 = time.monotonic()
    shm_before = set(os.listdir("/dev/shm"))
    core = InferenceServer(default_models())
    http = HttpServer(core, port=0).start()
    url = "127.0.0.1:{}".format(http.port)
    try:
        if card:
            out = _example(script, ["-u", url], label="prefix cache (b)")
        else:
            make = csm.create_shared_memory_region
            with _swapped(csm, {"create_shared_memory_region": (
                    lambda name, size, device_id=0: make(name, size,
                                                         device="cpu"))}):
                out, _, _ = _tool_main("http_cudashm_client",
                                       _load_example(script).main,
                                       ["-u", url])
        left = (core.cuda_shm_status(), core.system_shm_status(),
                sorted(set(os.listdir("/dev/shm")) - shm_before))
    finally:
        http.stop()
        core.close()
    sums = [ln for ln in out.splitlines() if " + " in ln or " - " in ln]
    log("prefix cache (b): HTTP CUDA-region client: {} output lines, "
        "regions left {}".format(len(sums), left))
    if "PASS: cuda shared memory" not in out or len(sums) != 32:
        fail("prefix cache (b): the HTTP CUDA-region client: {}".format(
            out[-2000:]))
    if any(left):
        fail("prefix cache (b): regions left behind: {}".format(left))
    return time.monotonic() - t0


def phase_prefix_cache(torch, smi, device="cuda"):
    """Phase 18: (a) ``python -m tpuserver_torch.bench_prefix_cache``
    through its ``main`` at :data:`PREFIX_ARGV` (the tool draws its tree),
    then (b) the three server-side demos: the router demo in this process
    at :data:`ROUTER_DEMO_ARGV`, the fleet demo and the HTTP CUDA-region
    client; returns the launches by path.  ``device="cpu"`` rehearses it
    on the CPU, without the card's launch checks."""
    import tempfile

    card = device == "cuda"
    t_start = _tools_phase_start(torch, card, "prefix cache")
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        by_part, seconds["bench_prefix_cache"] = _prefix_bench(
            card, os.path.join(tmp, "bench_prefix_cache.json"), smi)
    launches = {path: by_part[part] for part, path in PREFIX_PARTS.items()}
    _release(torch, card)
    launches["router_demo"], seconds["router_demo"] = _router_demo(card)
    _release(torch, card)
    seconds["fleet_demo"] = _fleet_demo(card)
    seconds["http_cudashm_client"] = _http_cudashm_client(card)
    _tools_phase_end(torch, card, "prefix cache: phase 18", t_start,
                     seconds, smi, launches)
    return launches


def _prefix_cache_kernel_rows(launches, timed, max_err):
    """The kernels line's rows for phase 18: each path's decode launches
    beside the kernel's time at that path's step (no path runs flash: the
    bench prefills dense, the demo in float32)."""
    return [_kernel_row("decode_attention", path, counts["decode_attention"],
                        max_err, timed[path],
                        "decode_attention_prefix_cache: {} rows of {} keys, "
                        "lengths {}, {}".format(
                            len(PREFIX_DECODE[path][0]),
                            PREFIX_DECODE[path][1],
                            list(PREFIX_DECODE[path][0]),
                            PREFIX_DECODE[path][2]))
            for path, counts in launches.items()]


# -- phase 19: the perf analyzer's fleet-router view -------------------------


# (a)'s replicas: two port servers in this process behind the port's
# FleetRouter, each serving the shared llama3_8b tree behind 4 slots of a
# 1024-key cache, prefix caching off (so each admission prefills its whole
# prompt; on the card the flash prefill keeps the radix cache off anyway)
ROUTER_VIEW_SEQ = 1024
ROUTER_VIEW_SLOTS = 4
ROUTER_VIEW_SCOPES = ("replica-a", "replica-b")
# each arm: one perf_analyzer process through the router, 4 streams of 32
# tokens from 512-token prompts, three 3 s windows; a pool of 16 prompts,
# which the plain arm covers, so each handed-off stream of the sever arm
# has the plain arm's tokens for its prompt
ROUTER_VIEW_ARGS = ("-m", "llama_generate", "--generation",
                    "--concurrency-range", "4", "--prompt-len", "512",
                    "--max-tokens", "32", "--input-pool", "16",
                    "--measurement-interval", "3000", "--max-trials", "3",
                    "--seed", str(SEED))
# the CPU rehearsal: float32 tiny at vocab 512, short prompts and windows
ROUTER_VIEW_CPU_ARGS = ("-m", "llama_generate", "--generation",
                        "--concurrency-range", "2", "--prompt-len", "8",
                        "--max-tokens", "16", "--input-pool", "4",
                        "--measurement-interval", "400", "--max-trials", "3",
                        "--seed", str(SEED), "--warmup", "0.1")
# the sever arm's faults, armed on each replica's scope: JAX's
# test_perf_analyzer_e2e.py:150-152
ROUTER_VIEW_SEVER = {"mode": "raise", "times": 3, "skip": 8}
# the decode kernel at (a)'s served step: 4 slots of a 1024-key cache,
# each row between its 512-token prompt and its 32nd token
ROUTER_VIEW_DECODE_LENGTHS = (520, 528, 536, 544)
# (b)'s load through the supervised replicas (the fleet supervisor test's
# command serving the fixture models): 0.6 s windows, each printed (-v),
# so the SIGKILL lands after the first and the level's last snapshot
# follows the restart
ROUTER_VIEW_FLEET_ARGS = ("-m", "simple", "--concurrency-range", "2",
                          "--measurement-interval", "600", "--max-trials",
                          "8", "--warmup", "0.5", "-v")
# the phase's share of a run: reported, not enforced
ROUTER_VIEW_BUDGET_S = 300.0


def _router_view_timed(torch):
    """The decode kernel held and timed at phase 19's served step (the
    flash kernel's T 512 prefill is phase 3's ``flash_attention`` row)."""
    return _served_decode_timed(torch, "router view",
                                ROUTER_VIEW_DECODE_LENGTHS, ROUTER_VIEW_SEQ,
                                SEED + 19)


def _router_view_perf(url, args):
    """``python -m tpuserver_torch.perf_analyzer --backend http -u url``
    as a process: its one row and its stdout."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpuserver_torch.perf_analyzer",
         "--backend", "http", "-u", url] + list(args),
        capture_output=True, text=True, env=_port_env(), cwd=HERE,
        timeout=600)
    log(proc.stdout.rstrip())
    if proc.returncode != 0:
        fail("router view: perf_analyzer exited {}: {} {}".format(
            proc.returncode, proc.stdout[-2000:], proc.stderr[-2000:]))
    rows = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith('{"')]
    if len(rows) != 1:
        fail("router view: {} rows, want 1".format(len(rows)))
    return rows[0], proc.stdout


def _router_view_streams(router, seen, first_handoff):
    """The router's generations not in ``seen`` (added to it): by id,
    (prompt, tokens, the tokens emitted before its first handoff or None
    where none happened; ``first_handoff`` by id)."""
    out = {}
    with router._lock:
        gens = [entry[0] for entry in router._gens.values()]
    for gen in gens:
        if gen.gen_id in seen or gen.prompt is None:
            continue
        seen.add(gen.gen_id)
        with gen._lock:
            out[gen.gen_id] = (tuple(gen.prompt), list(gen._tokens or []),
                               first_handoff.get(gen.gen_id))
    return out


def _first_handoffs(fleet_router, first_handoff):
    """The router's ``handoff_request`` (a handoff's re-admission body)
    wrapped to record, by generation id, the tokens emitted before its
    first handoff."""
    real = fleet_router._Generation.handoff_request

    def handoff_request(gen):
        with gen._lock:
            emitted = len(gen._tokens or [])
        first_handoff.setdefault(gen.gen_id, emitted)
        return real(gen)

    return {"handoff_request": handoff_request}


def _router_view_line(label, row, smi):
    """One arm's numbers and the router's deltas in a line."""
    deltas = {k: v for k, v in row.items()
              if k.startswith(("router_", "disagg_", "supervisor_"))}
    return ("router view {}: {} tokens/s, {} generations, TTFT p50 {} ms "
            "p99 {} ms, ITL p50 {} ms p99 {} ms, {} errors, resumed "
            "streams {}; router deltas {}; {}".format(
                label, row.get("value"), row.get("generations"),
                row.get("ttft_p50_ms"), row.get("ttft_p99_ms"),
                row.get("itl_p50_ms"), row.get("itl_p99_ms"),
                row.get("errors"), row.get("resumed_streams"),
                json.dumps(deltas, sort_keys=True), smi))


def _router_view_checks(arm, row, text, absorbed, cfg, launches, lengths,
                        admitted):
    """Phase 19 (a)'s checks of one arm: its row (no error, tokens, the
    router keys at 0 or more), the footer in its output, the router's
    handoffs and failovers over the sever arm, and on the card
    (``launches`` not None) flash once a layer for each prefill whose
    length tiles, a 512-token one among them, and decode launched."""
    from tpuserver_torch.models import llama

    if row.get("errors") or not row.get("tokens"):
        fail("router view {}: {} errors, {} tokens".format(
            arm, row.get("errors"), row.get("tokens")))
    missing = [k for k in ("router_failovers", "router_handoffs",
                           "router_resumed_streams", "router_shed")
               if not isinstance(row.get(k), int) or row[k] < 0]
    if missing or "router failovers=" not in text:
        fail("router view {}: router keys {} missing or negative, footer "
             "{}".format(arm, missing, "router failovers=" in text))
    if arm == "sever" and not absorbed["handoffs"] + absorbed["failovers"]:
        fail("router view sever: no handoff or failover: {}".format(
            absorbed))
    if launches is None:
        return
    tileable = [t for t in lengths if None not in llama._flash_blocks(t, cfg)]
    if (launches["flash_attention"] != cfg.n_layers * len(tileable)
            or len(lengths) != admitted or 512 not in lengths
            or not launches["decode_attention"]):
        fail("router view {}: launches {} for {} admissions at lengths {} "
             "(flash wants {} a tileable prefill)".format(
                 arm, launches, admitted, lengths, cfg.n_layers))


def _router_view_agreement(handed, plain):
    """Each handed-off stream ``(prompt, tokens, tokens before its first
    handoff)`` against ``plain``'s tokens for its prompt: equal before
    the handoff (the same path produced them), the agreement after it
    printed (a re-prefill of prompt and history produced those, and a
    bf16 one can flip near-ties)."""
    before = after = total = 0
    for prompt, tokens, offset in handed:
        ref = plain[prompt]
        if tokens[:offset] != ref[:offset]:
            fail("router view: a handed-off stream's tokens before its "
                 "first handoff at {} differ from the plain arm's: {} vs "
                 "{}".format(offset, tokens, ref))
        before += offset
        tail = list(zip(tokens[offset:], ref[offset:]))
        after += sum(a == b for a, b in tail)
        total += len(tail)
    log("router view: {} handed-off streams (first handoffs at {}); their "
        "tokens before it equal the plain arm's ({} tokens); after it {}/{} "
        "agree (reported, not required: a bf16 re-prefill can flip "
        "near-ties)".format(len(handed), sorted(s[2] for s in handed),
                            before, after, total))
    return after, total


def _router_view_generation(torch, cfg, params, smi, device, first_handoff):
    """Phase 19 (a): two port servers here, behind the port's FleetRouter,
    and a plain arm and a sever arm of perf_analyzer processes through
    it; the launches of each arm.  ``first_handoff`` is filled by the
    router's wrapped ``handoff_request`` (:func:`_first_handoffs`)."""
    from tpuserver_torch import chaos_campaign, fault_points
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.fleet_router import FleetRouter
    from tpuserver_torch.http_server import HttpServer
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel
    from tpuserver_torch.ops import flash as fl

    card = device == "cuda"
    prefills = []
    models, cores, https = [], [], []
    router = None
    arms = {}
    try:
        for scope in ROUTER_VIEW_SCOPES:
            model = LlamaGenerateModel(
                cfg=cfg, max_seq=ROUTER_VIEW_SEQ,
                max_slots=ROUTER_VIEW_SLOTS, params=params, device=device,
                fault_scope=scope, prefix_cache=False)
            real_prefill = model._fns["prefill"]

            def prefill(params_, slot_cache, tokens, true_len,
                        real_prefill=real_prefill):
                prefills.append(int(tokens.shape[1]))
                return real_prefill(params_, slot_cache, tokens, true_len)

            model._fns = dict(model._fns, prefill=prefill)
            # registered before the warm-up builds the scheduler
            core = InferenceServer([model], fault_scope=scope)
            model.warmup()
            models.append(model)
            cores.append(core)
            https.append(HttpServer(core, port=0).start())
        router = FleetRouter(
            ["127.0.0.1:{}".format(h.port) for h in https],
            probe_interval_s=0.1, gen_ttl_s=3600.0,
            gen_capacity=1 << 20).start()
        deadline = time.monotonic() + 60
        while sum(r["eligible"] for r in router.stats()["replicas"]) < 2:
            if time.monotonic() > deadline:
                fail("router view: the replicas never turned eligible")
            time.sleep(0.05)
        seen = set()
        args = ROUTER_VIEW_ARGS if card else ROUTER_VIEW_CPU_ARGS
        for arm in ("plain", "sever"):
            for model in models:
                _dist_quiet(model)
            if arm == "sever":
                for scope in ROUTER_VIEW_SCOPES:
                    fault_points.install("http.generate_stream",
                                         scope=scope, **ROUTER_VIEW_SEVER)
            s0 = router.stats()
            admitted0 = sum(m.scheduler_stats()["admitted"] for m in models)
            del prefills[:]
            if card:
                torch.cuda.synchronize()
            fl.reset_launch_counts()
            t0 = time.monotonic()
            try:
                row, text = _router_view_perf(router.url, args)
            finally:
                fault_points.clear("http.generate_stream")
            for model in models:
                _dist_quiet(model)
            if card:
                torch.cuda.synchronize()
            launches = {"flash_attention": fl.flash_attention.launches,
                        "decode_attention": fl.decode_attention.launches}
            seconds = time.monotonic() - t0
            s1 = router.stats()
            admitted = sum(m.scheduler_stats()["admitted"]
                           for m in models) - admitted0
            lengths = list(prefills)
            streams = _router_view_streams(router, seen, first_handoff)
            absorbed = {k: s1[k] - s0[k] for k in (
                "handoffs", "failovers", "resumed_streams", "shed")}
            log(_router_view_line(arm, row, smi))
            log("router view {}: {:.1f} s; launches {}; {} admissions, "
                "prefill lengths {}; the router absorbed {} over the run; "
                "{} streams recorded".format(
                    arm, seconds, json.dumps(launches), admitted,
                    sorted(set(lengths)), json.dumps(absorbed),
                    len(streams)))
            _router_view_checks(arm, row, text, absorbed, cfg, launches
                                if card else None, lengths, admitted)
            arms[arm] = {"row": row, "launches": launches,
                         "streams": streams, "absorbed": absorbed,
                         "seconds": seconds}
        # every handed-off stream against the plain arm's tokens for its
        # prompt: up to its first handoff the same path produced them
        # (required), after it a re-prefill of prompt + history did
        # (reported: a bf16 re-prefill can flip near-ties); a failover
        # before the first token hands off at 0
        plain = {}
        for prompt, tokens, _ in arms["plain"]["streams"].values():
            if len(tokens) > len(plain.get(prompt, ())):
                plain[prompt] = tokens
        handed = [s for s in arms["sever"]["streams"].values()
                  if s[2] is not None]
        budget = int(args[args.index("--max-tokens") + 1])
        for prompt in {s[0] for s in handed} - set(plain):
            # a prompt the plain arm did not finish: one undisturbed
            # stream of it now
            plain[prompt] = [
                int(out["data"][0])
                for event in chaos_campaign.generate_stream(
                    [router.url], "llama_generate", list(prompt), budget)
                for out in event.get("outputs", [])
                if out["name"] == "TOKEN"]
        _router_view_agreement(handed, plain)
    finally:
        fault_points.clear("http.generate_stream")
        if router is not None:
            router.stop()
        for h in https:
            h.stop()
        for core in cores:
            core.close()
    return {arm: arms[arm]["launches"] for arm in arms}


def _router_view_fleet(smi, device):
    """Phase 19 (b): a FleetSupervisor over two ``python -m
    tpuserver_torch.serve --models fixtures`` replica processes, one
    SIGKILLed inside the window of a perf_analyzer process through the
    supervisor's router; its seconds."""
    import signal
    import tempfile

    from tpuserver_torch import fleetmanifest
    from tpuserver_torch.fleet import FleetSupervisor

    t0 = time.monotonic()
    command = [sys.executable, "-m", "tpuserver_torch.serve", "--device",
               device, "--models", "fixtures", "--port", "{port}",
               "--fault-scope", "{scope}"]
    supervisor = FleetSupervisor(
        command, replicas=2, min_replicas=2, max_replicas=2,
        probe_interval_s=0.15, probe_timeout_s=5.0, unhealthy_after=20,
        start_timeout_s=180.0, drain_grace_s=5.0, max_restarts=6,
        restart_window_s=3600.0, restart_backoff_s=0.05,
        scope_prefix="router-view-r",
        router_kwargs={"probe_interval_s": 0.1},
        env={"PYTHONPATH": os.path.join(HERE, "src", "python")}).start()
    pids = set()
    proc = None
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "perf.log")
        try:
            if not supervisor.wait_ready(timeout_s=180):
                fail("router view (b): the supervised fleet never turned "
                     "ready: {}".format(supervisor.stats()))
            pids = {r["pid"] for r in supervisor.stats()["replicas"]}
            restarts0 = supervisor.stats()["replica_restarts"]
            with open(path, "w") as out:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "tpuserver_torch.perf_analyzer",
                     "--backend", "http", "-u", supervisor.router.url]
                    + list(ROUTER_VIEW_FLEET_ARGS),
                    stdout=out, stderr=subprocess.STDOUT,
                    env=dict(_port_env(), PYTHONUNBUFFERED="1"), cwd=HERE)
            # the kill lands inside the level's windows: once the first
            # window is printed
            deadline = time.monotonic() + 120
            while True:
                with open(path) as fh:
                    if "trial  1:" in fh.read():
                        break
                if proc.poll() is not None or time.monotonic() > deadline:
                    fail("router view (b): perf_analyzer never measured")
                time.sleep(0.02)
            ups = [r for r in supervisor.stats()["replicas"]
                   if r["state"] == "up" and r["pid"]]
            victim = ups[-1]["pid"]
            os.kill(victim, signal.SIGKILL)
            killed_at = time.monotonic()
            rc = proc.wait(timeout=300)
            deadline = time.monotonic() + 180
            while supervisor.stats()["replica_restarts"] <= restarts0:
                if time.monotonic() > deadline:
                    fail("router view (b): the SIGKILL was not healed: {}"
                         .format(supervisor.stats()))
                time.sleep(0.1)
            if not supervisor.wait_ready(timeout_s=180):
                fail("router view (b): the fleet did not heal back to 2")
            healed_s = time.monotonic() - killed_at
            stats = supervisor.stats()
            pids |= {r["pid"] for r in stats["replicas"]}
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            supervisor.stop()
        with open(path) as fh:
            text = fh.read()
    log(text.rstrip())
    left = [pid for pid in pids
            if pid and fleetmanifest.process_start_token(pid) is not None]
    rows = [json.loads(ln) for ln in text.splitlines()
            if ln.startswith('{"')]
    row = rows[0] if len(rows) == 1 else {}
    keys = ("supervisor_replica_restarts", "supervisor_scale_up_events",
            "supervisor_scale_down_events", "supervisor_retired_replicas")
    log("router view (b): perf_analyzer exit {}; {} infer/s, p50 {} us, "
        "p99 {} us, {} errors; supervisor deltas {}; router deltas {}; "
        "replica restarts {} (healed in {:.1f} s), retired {}; children "
        "left {}; {}".format(
            rc, row.get("value"), row.get("p50_usec"), row.get("p99_usec"),
            row.get("errors"), json.dumps({k: row.get(k) for k in keys}),
            json.dumps({k: v for k, v in row.items()
                        if k.startswith("router_")}, sort_keys=True),
            stats["replica_restarts"], healed_s, stats["retired_replicas"],
            left, smi))
    if rc != 0 or len(rows) != 1:
        fail("router view (b): perf_analyzer exited {} with {} rows".format(
            rc, len(rows)))
    if any(not isinstance(row.get(k), int) for k in keys) or \
            "supervisor restarts=" not in text:
        fail("router view (b): the supervisor keys or footer missing: {}"
             .format(row))
    if row["supervisor_replica_restarts"] < 1:
        fail("router view (b): the level's row missed the restart its "
             "window held: {}".format(row))
    if stats["replica_restarts"] < 1 or stats["retired_replicas"]:
        fail("router view (b): restarts {}, retired {}".format(
            stats["replica_restarts"], stats["retired_replicas"]))
    if left:
        fail("router view (b): children left: {}".format(left))
    return time.monotonic() - t0


def phase_router_view(torch, cfg, params, smi, device="cuda"):
    """Phase 19: the perf analyzer's fleet-router view, (a) generation
    through the port's FleetRouter over two replicas here, plain and with
    the replicas' streams severed, then (b) a supervised fleet's healing
    counters after a SIGKILL; returns (a)'s launches by arm.
    ``device="cpu"`` rehearses it on the CPU, without the card's launch
    checks."""
    from tpuserver_torch import fleet_router

    card = device == "cuda"
    t_start = _tools_phase_start(torch, card, "router view")
    first_handoff = {}
    with _swapped(fleet_router._Generation,
                  _first_handoffs(fleet_router, first_handoff)):
        launches = _router_view_generation(torch, cfg, params, smi, device,
                                           first_handoff)
    generation_s = time.monotonic() - t_start
    _release(torch, card)
    fleet_s = _router_view_fleet(smi, device)
    _tools_phase_end(torch, card, "router view: phase 19", t_start,
                     {"generation arms": generation_s,
                      "supervised fleet": fleet_s}, smi, launches)
    log("router view: phase 19 {} its {:.0f} s budget".format(
        "within" if time.monotonic() - t_start <= ROUTER_VIEW_BUDGET_S
        else "OVER", ROUTER_VIEW_BUDGET_S))
    return launches


def _router_view_kernel_rows(rows, decode_row, launches):
    """The kernels line's rows for phase 19: both arms' flash and decode
    launches (the ``router_view`` column) beside flash at its 512-token
    prefill (phase 3) and decode at the served step."""
    total = {k: sum(arm[k] for arm in launches.values())
             for k in ("flash_attention", "decode_attention")}
    return [
        _kernel_row("flash_attention", "router_view",
                    total["flash_attention"],
                    rows["max_err"]["flash_attention"],
                    rows["timed"]["flash_attention"], "flash_attention"),
        _kernel_row("decode_attention", "router_view",
                    total["decode_attention"],
                    max(rows["max_err"]["decode_attention"],
                        decode_row["max_abs_err"]), decode_row,
                    "decode_attention_router_view: {} rows of {} keys, "
                    "lengths {}".format(len(ROUTER_VIEW_DECODE_LENGTHS),
                                        ROUTER_VIEW_SEQ,
                                        list(ROUTER_VIEW_DECODE_LENGTHS)))]


# -- phase 20: the kernels' whole reference domain --------------------------

# (a) the routes timed, each against its plain version: flash (label, b, t,
# h, hkv, d, causal, dtype), decode (label, lengths, s, h, hkv, d, dtype),
# the W8A16 product's float32 route at one decode step's products at M 1
# and 8 (llama3_8b's weights, INT8_WEIGHTS) and one ragged shape
KD_FLASH_CASES = (
    ("f32_8b", 1, 512, 32, 8, 128, True, "float32"),     # llama3_8b
    ("f32_1b", 1, 512, 32, 8, 64, True, "float32"),      # llama3_1b
    ("bf16_d8", 1, 128, 8, 4, 8, True, "bfloat16"),      # tiny
    ("bf16_d96", 1, 512, 16, 1, 96, True, "bfloat16"),
    ("f32_d96", 1, 512, 16, 1, 96, False, "float32"),
    ("bf16_d256", 1, 512, 16, 1, 256, True, "bfloat16"),
    ("f32_d256", 1, 512, 16, 1, 256, True, "float32"))
KD_DECODE_CASES = (
    ("bf16_h128", (4096,), 8192, 128, 8, 128, "bfloat16"),  # 405B's heads
    ("f32_mqa", (576,), 4096, 32, 1, 128, "float32"),
    ("bf16_d96", (576,), 4096, 16, 1, 96, "bfloat16"),
    ("bf16_d256", (576,), 4096, 8, 2, 256, "bfloat16"),
    # (b)'s served steps: one stream, and four slots, of llama3_8b float32
    ("f32_8b", (544,), 1024, 32, 8, 128, "float32"),
    ("f32_8b_batched", (544, 543, 542, 541), 1024, 32, 8, 128, "float32"),
    # (c)'s steps: tiny and the narrow D 96 model, a 128-token prompt and
    # 12 tokens in a 256-key cache
    ("bf16_tiny", (139,), 256, 8, 4, 8, "bfloat16"),
    ("bf16_narrow", (139,), 256, 16, 1, 96, "bfloat16"))
KD_INT8_ROWS = (1, 8)
KD_INT8_RAGGED = (4096 + 3, 1000 + 5)
# (b) and (d): llama3_8b in float32 (TF32 off) behind max_seq KD_SEQ, a
# KD_PROMPT-token prompt (a flash length) and KD_TOKENS greedy tokens, at
# one slot and at KD_SLOTS; (d) serves KD_INT8_TOKENS
KD_SEQ = 1024
KD_PROMPT = 512
KD_TOKENS = 32
KD_SLOTS = 4
KD_INT8_TOKENS = 8
# the CPU rehearsal's (b) and (d): float32 tiny at vocab 512, a 128-token
# prompt, 8 tokens, max_seq 256
KD_CPU = {"vocab": 512, "seq": 256, "prompt": 128, "tokens": 8}
# (b): the kernel arm's prefill logits against the dense arm's (the same
# weights at attn_impl="dense"), row-relative: both float32, the flash
# route's sums in another order (float32 round-off, about 1e-6 of a logit,
# carried through 32 layers); a difference of greedy tokens fails unless
# the dense arm's top-2 gap at the first differing position is under
# KD_GAP_TOL of that row's largest |logit| (a near tie)
KD_LOGITS_TOL = 1e-3
KD_GAP_TOL = 1e-3
# (d): one decode step's logits with the W8A16 float32 route against the
# same step with the plain product bound in its place (both float32, the
# products' sums in another order)
KD_INT8_LOGITS_TOL = 1e-3
# (c): tiny (vocab 128) and a narrow multi-query model (H 16, Hkv 1, D 96,
# 2 layers), bf16, attn_impl="kernel", decode_impl="auto", against their
# dense arms: JAX's test_llama_decode_pallas_matches_xla (max_seq 256, a
# 128-token prompt, 12 tokens in chunks of 4; tokens identical, the last
# logits within 5e-2)
KD_SMALL_SEQ = 256
KD_SMALL_PROMPT = 128
KD_SMALL_TOKENS = 12
KD_SMALL_CHUNK = 4
KD_SMALL_LOGITS_TOL = 5e-2
KD_NARROW = {"d_model": 1536, "n_layers": 2, "n_heads": 16, "n_kv_heads": 1,
             "d_ff": 4096}
# the phase's share of a run: reported, not enforced
KD_BUDGET_S = 300.0


def kd_routes_launched(label, counts, want):
    """Fail unless each route ``want`` names ({kernel: route}) launched
    on the path ``label``; ``counts`` as ``_route_counts`` gives them."""
    missing = ["{}/{}".format(k, r) for k, r in want.items()
               if not counts.get(k, {}).get(r)]
    if missing:
        fail("kernel domain {}: routes never launched: {} (launches "
             "{})".format(label, missing, json.dumps(counts)))


def kd_token_rule(label, got, want, gap_at):
    """The kernel arm's greedy tokens ``got`` against the dense arm's
    ``want``: equal, or the first position where they differ is a near
    tie of the dense arm: ``gap_at(j)`` gives (top-2 gap, largest |logit|)
    of the dense logits that chose ``want[j]``, and the gap must be under
    ``KD_GAP_TOL`` of it.  Fails otherwise; returns the record it logs."""
    got, want = list(got), list(want)
    first = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
    if first is None and len(got) != len(want):
        fail("kernel domain {}: {} tokens against the dense arm's "
             "{}".format(label, len(got), len(want)))
    rec = {"agree": sum(a == b for a, b in zip(got, want)),
           "of": len(want), "first_diff": first}
    if first is not None:
        gap, top = gap_at(first)
        rec.update(top2_gap=gap, largest_logit=top,
                   near_tie=bool(gap < KD_GAP_TOL * top))
    log("kernel domain {}: tokens kernel {} | dense {}; {}".format(
        label, got, want, json.dumps(rec)))
    if first is not None and not rec["near_tie"]:
        fail("kernel domain {}: tokens differ from the dense arm's at {} "
             "where its top-2 gap {} is no near tie (largest |logit| "
             "{})".format(label, first, rec["top2_gap"], rec["largest_logit"]))
    return rec


@contextlib.contextmanager
def kd_plain_int8(quant, product=None):
    """``quant.int8_matmul`` (the name the model calls) bound to
    ``product`` (default: its plain version), and put back however the
    block ends."""
    kernel = quant.int8_matmul
    quant.int8_matmul = product or quant.int8_matmul_reference
    try:
        yield
    finally:
        quant.int8_matmul = kernel


def _kd_gap_at(torch, llama, params, cfg, prompt, tokens, device):
    """``gap_at`` for ``kd_token_rule``: the dense forward of prompt +
    tokens; position j's row is the one that chose ``tokens[j]``."""
    ids = torch.tensor([[int(t) for t in prompt] + list(tokens)[:-1]],
                       device=device)
    with torch.inference_mode():
        logits = llama.forward(params, ids, cfg)[0, len(prompt) - 1:].float()

    def gap_at(j):
        top2 = logits[j].topk(2)
        return ((top2.values[0] - top2.values[1]).item(),
                logits[j].abs().max().item())

    return gap_at


def _kd_flash_case(torch, F, fl, dev, gen, case, flush):
    label, b, t, h, hkv, d, causal, dt = case
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt]
    before = _route_counts()
    row = _flash_case(torch, F, fl, dev, gen, b, t, h, hkv, d, causal, dtype,
                      True, flush)
    row.update(kernel="flash_attention", label=label,
               kernel_route=fl.flash_route(dtype, d))
    if not _route_counts()["flash_attention"][row["kernel_route"]] > \
            before["flash_attention"][row["kernel_route"]]:
        fail("flash_attention {}: the {} route did not launch".format(
            label, row["kernel_route"]))
    if hkv == 1:  # a rolled kv head is the same head
        row["planted_fault_err"].pop("wrong_kv_head")
    return row


def _kd_decode_case(torch, F, fl, dev, gen, case, flush):
    label, lengths, s, h, hkv, d, dt = case
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt]
    before = _route_counts()
    row = _decode_case(torch, F, fl, dev, gen, lengths, s, h, hkv, d, dtype,
                       True, flush)
    route = fl.decode_route(dtype, d, h // hkv)
    row.update(kernel="decode_attention", label=label, kernel_route=route)
    if not _route_counts()["decode_attention"][route] > \
            before["decode_attention"][route]:
        fail("decode_attention {}: the {} route did not launch".format(
            label, route))
    # the planted fault every case takes: each length shortened by 32
    # keys, on the same inputs (drawn again from the case's seed)
    g2 = torch.Generator(device=dev).manual_seed(SEED + 20 + s + h + d)
    q = torch.randn(len(lengths), h, d, device=dev, generator=g2).to(dtype)
    kc, vc = (torch.randn(len(lengths), s, hkv, d, device=dev,
                          generator=g2).to(dtype) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out = fl.decode_attention(q, kc, vc, lens)
    ref = fl.decode_attention_reference(q, kc, vc, lens)
    row["row_rel_err"] = max(row["row_rel_err"], row_rel_err(out, ref))
    row.setdefault("planted_fault_err", {})["shortened"] = row_rel_err(
        fl.decode_attention_reference(q, kc, vc, (lens - 32).clamp_min(0)),
        ref)
    return row


def _kd_int8_cases(torch, quant, dev, gen, k, n, flush, m_rows):
    """The W8A16 float32 route against its plain version at (k, n) and
    each of ``m_rows`` rows: two calls equal, rows equal to the rows
    computed alone, a planted fault (the last 32 weight rows zeroed), and
    the times of the kernel, the plain version and the library's float32
    ``torch.matmul`` over the dequantized weight, beside the bound."""
    w = torch.randn(k, n, device=dev, generator=gen) / k ** 0.5
    qw = quant.quantize_int8(w)
    q, s = qw["q"], qw["s"]
    deq = q.float() * s
    x = torch.randn(max(m_rows), k, device=dev, generator=gen)
    alone = torch.cat([quant.int8_matmul(x[i:i + 1], q, s)
                       for i in range(len(x))])
    cut = q.clone()
    cut[-32:] = 0
    rows = {}
    for m in m_rows:
        xm = x[:m]
        before = _route_counts()
        out, again = quant.int8_matmul(xm, q, s), quant.int8_matmul(xm, q, s)
        torch.cuda.synchronize()
        _route_launched("int8_matmul", "simt", before, 2)
        if not torch.equal(out, again) or not torch.equal(out, alone[:m]):
            fail("int8_matmul float32 at ({}, {}), M {}: calls or rows "
                 "alone differ".format(k, n, m))
        ref = quant.int8_matmul_reference(xm, q, s)
        row = {"kernel": "int8_matmul", "kernel_route": "simt", "m": m,
               "k": k, "n": n, "dtype": "float32",
               "max_abs_err": (out - ref).abs().max().item(),
               "row_rel_err": row_rel_err(out, ref),
               "planted_fault_err": {"skipped_rows": row_rel_err(
                   quant.int8_matmul_reference(xm, cut, s), ref)},
               "ms": _time_ms(torch, lambda: quant.int8_matmul(xm, q, s),
                              50, flush),
               "plain_ms": _time_ms(
                   torch, lambda: quant.int8_matmul_reference(xm, q, s), 10,
                   flush),
               "library_ms": _time_ms(torch, lambda: xm @ deq, 50, flush),
               "library": "float32 torch.matmul over the dequantized weight"}
        nbytes = k * n + 4 * n + 4 * m * k + 4 * m * n
        row["bound_ms"], row["bound_by"] = _bound_ms(
            nbytes, 2 * m * k * n, SPEC.peak_fp32_flops)
        rows[(m, k, n)] = row
    return rows


def _kernel_domain_timed(torch):
    """(a) Every route of ``KD_*_CASES`` against its plain version and
    timed (CUDA events, L2 flushed) beside its bound, the plain version
    and the library call; returns the rows by label (the W8A16 rows by
    (m, k, n), and its decode-step sums as ``int8_f32_step_m<M>``)."""
    import torch.nn.functional as F

    from tpuserver_torch.ops import _build
    from tpuserver_torch.ops import flash as fl
    from tpuserver_torch.ops import quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    for case in KD_FLASH_CASES:
        rows["flash_" + case[0]] = _kd_flash_case(torch, F, fl, dev, gen,
                                                  case, flush)
    for case in KD_DECODE_CASES:
        rows["decode_" + case[0]] = _kd_decode_case(torch, F, fl, dev, gen,
                                                    case, flush)
    int8 = {}
    for k, n in sorted({(k, n) for _, k, n in INT8_WEIGHTS}
                       | {KD_INT8_RAGGED}):
        int8.update(_kd_int8_cases(torch, quant, dev, gen, k, n, flush,
                                   KD_INT8_ROWS))
    del flush
    torch.cuda.empty_cache()
    for m in KD_INT8_ROWS:
        step = _int8_step_sum(int8, m, 32, keys=(
            "ms", "plain_ms", "bound_ms", "library_ms"))
        step.update(kernel="int8_matmul", kernel_route="simt",
                    dtype="float32", max_abs_err=max(
                        r["max_abs_err"] for r in int8.values()))
        rows["int8_f32_step_m{}".format(m)] = step
    m, k, n = 8, *KD_INT8_RAGGED
    rows["int8_f32_ragged"] = int8[(m, k, n)]
    nvlog = _build.BUILD_DIR / "nvcc.log"
    instances = ptxas_instances(nvlog.read_text()) if nvlog.exists() else {}
    for row in rows.values():
        row["ptxas"] = ptxas_of(instances, kernel_instance(
            row["kernel"], row["kernel_route"], row.get("d"),
            row.get("h", 1) // row.get("hkv", 1)))
    bad, blind = [], []
    for key, row in list(rows.items()) + [
            ("int8 {}".format(kmn), r) for kmn, r in int8.items()]:
        log("kernel_domain_case: {} {}".format(key, json.dumps(
            row, default=str)))
        tol = TOL[row["dtype"]]
        if "row_rel_err" in row and not row["row_rel_err"] <= tol:
            bad.append(key)
        if any(not e > tol for e in row.get("planted_fault_err",
                                            {}).values()):
            blind.append(key)
    for key, row in rows.items():
        ptx = row["ptxas"] or {}
        log("kernel domain (a): {} ({}) {} ms, bound {} ms ({}), plain {} "
            "ms, library {} ms; ptxas {} registers, {} / {} bytes spilled "
            "(stores / loads)".format(
                key, row["kernel_route"], row["ms"], row["bound_ms"],
                row["bound_by"], row["plain_ms"], row["library_ms"],
                ptx.get("registers"), ptx.get("spill_stores"),
                ptx.get("spill_loads")))
    if bad:
        fail("kernel domain (a): routes disagree with their plain "
             "versions: {}".format(bad))
    if blind:
        fail("kernel domain (a): a planted fault passes the tolerance: "
             "{}".format(blind))
    return rows


def _kd_serve(torch, cfg, params, device, max_slots, prompts, n_tokens,
              max_seq, **kwargs):
    """``prompts`` through an ``InferenceServer`` with a
    ``LlamaGenerateModel`` on ``params`` behind the port's HTTP server
    (all at once when there are several); returns (each prompt's
    streamed tokens, the launches by route, the model)."""
    from tpuserver_torch import ops
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.http_server import HttpServer
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel

    model = LlamaGenerateModel(cfg=cfg, max_seq=max_seq, max_slots=max_slots,
                               params=params, device=device, **kwargs)
    model.warmup()
    core = InferenceServer([model])
    http = HttpServer(core, port=0).start()
    try:
        ops.reset_launch_counts()
        results, _ = _batched_round(http.port, prompts,
                                    [n_tokens] * len(prompts),
                                    range(len(prompts)))
        if device == "cuda":
            torch.cuda.synchronize()
        counts = _route_counts()
    finally:
        http.stop()
        core.close()
    tokens = [results[i][0] for i in range(len(prompts))]
    if any(len(t) != n_tokens or not results[i][3]
           for i, t in enumerate(tokens)):
        fail("kernel domain: a stream ended short: {}".format(
            [len(t) for t in tokens]))
    return tokens, counts, model


def _kd_prefill_logits(torch, llama, params, cfg, prompt, max_seq, device):
    tokens = torch.tensor([[int(t) for t in prompt]], device=device)
    with torch.inference_mode():
        cache = llama.init_kv_cache(cfg, 1, max_seq, device)
        logits, cache = llama.prefill(params, cache, tokens, cfg)
    return logits.float(), cache


def _kernel_domain_f32(torch, np, smi, device):
    """(b) and (d): llama3_8b in float32 (float32 tiny on the CPU) served
    with the kernels at one slot and at ``KD_SLOTS`` against its dense
    arm, then quantized (int8 weights, float32 activations) against its
    own step with the plain W8A16 product; returns the launches by path."""
    from tpuserver_torch.models import llama
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel
    from tpuserver_torch.ops import quant

    card = device == "cuda"
    if card:
        cfg = dataclasses.replace(llama.llama3_8b(), dtype=torch.float32)
        seq, n_prompt, n_tokens = KD_SEQ, KD_PROMPT, KD_TOKENS
    else:
        cfg = dataclasses.replace(llama.tiny(vocab=KD_CPU["vocab"]),
                                  dtype=torch.float32, attn_impl="kernel")
        seq, n_prompt, n_tokens = (KD_CPU["seq"], KD_CPU["prompt"],
                                   KD_CPU["tokens"])
    dense = dataclasses.replace(cfg, attn_impl="dense", decode_impl="dense")
    t0 = time.monotonic()
    params = LlamaGenerateModel(cfg=cfg, seed=SEED,
                                device=device)._ensure_params()
    if card:
        torch.cuda.synchronize()
    log("kernel domain (b): {} float32 weights drawn in {:.1f} s, {:.3f} "
        "GiB allocated".format("llama3_8b" if card else "tiny",
                               time.monotonic() - t0,
                               torch.cuda.memory_allocated() / 2 ** 30
                               if card else 0.0))
    rng = np.random.RandomState(SEED + 20)
    prompts = [rng.randint(0, cfg.vocab, n_prompt) for _ in range(2)]
    launches = {}
    single, launches["f32_serve"], _ = _kd_serve(
        torch, cfg, params, device, 1, prompts[:1], n_tokens, seq)
    batched, launches["f32_serve_batched"], _ = _kd_serve(
        torch, cfg, params, device, KD_SLOTS, prompts, n_tokens, seq)
    plain, dense_counts, _ = _kd_serve(torch, dense, params, device, 1,
                                       prompts[:1], n_tokens, seq)
    log("kernel domain (b): launches by route: single {}, batched {}, "
        "dense arm {}".format(json.dumps(launches["f32_serve"]),
                              json.dumps(launches["f32_serve_batched"]),
                              json.dumps(dense_counts)))
    if card:
        for path in ("f32_serve", "f32_serve_batched"):
            kd_routes_launched(path, launches[path], {
                "flash_attention": "simt", "decode_attention": "simt"})
            if launches[path]["flash_attention"]["wgmma"] or \
                    launches[path]["decode_attention"]["mma"]:
                fail("kernel domain (b) {}: a float32 call launched a "
                     "tensor-core route: {}".format(
                         path, json.dumps(launches[path])))
        if any(n for by_route in dense_counts.values()
               for n in by_route.values()):
            fail("kernel domain (b): the dense arm launched a kernel")
    lk, _ = _kd_prefill_logits(torch, llama, params, cfg, prompts[0], seq,
                               device)
    ld, _ = _kd_prefill_logits(torch, llama, params, dense, prompts[0], seq,
                               device)
    err = row_rel_err(lk, ld)
    log("kernel domain (b): prefill last-row logits, kernel arm against "
        "dense arm, row-relative {} (limit {}), {}".format(
            err, KD_LOGITS_TOL, smi))
    if not err <= KD_LOGITS_TOL:
        fail("kernel domain (b): prefill logits {} from the dense arm's "
             "(limit {})".format(err, KD_LOGITS_TOL))
    gap_at = _kd_gap_at(torch, llama, params, dense, prompts[0], plain[0],
                        device)
    agreement = {
        "single": kd_token_rule("(b) one slot", single[0], plain[0], gap_at),
        "batched": kd_token_rule("(b) {} slots".format(KD_SLOTS), batched[0],
                                 plain[0], gap_at)}

    # (d) int8 weights, float32 activations, one stream
    if card:
        torch.cuda.reset_peak_memory_stats()
    qtokens, launches["f32_int8_serve"], qmodel = _kd_serve(
        torch, cfg, params, device, 1, prompts[:1], KD_INT8_TOKENS, seq,
        quantize=True)
    qparams = qmodel._ensure_params()
    if card:
        kd_routes_launched("f32_int8_serve", launches["f32_int8_serve"], {
            "flash_attention": "simt", "decode_attention": "simt",
            "int8_matmul": "simt"})
        if launches["f32_int8_serve"]["int8_matmul"]["mma"]:
            fail("kernel domain (d): the bf16 W8A16 route ran on float32 "
                 "activations")
    first, cache = _kd_prefill_logits(torch, llama, qparams, cfg, prompts[0],
                                      seq, device)
    tok = torch.argmax(first, dim=-1)
    steps = {}
    with torch.inference_mode():
        steps["kernel"], _ = llama.decode_step(qparams, cache, tok, n_prompt,
                                               cfg)
        with kd_plain_int8(quant):
            steps["plain"], _ = llama.decode_step(qparams, cache, tok,
                                                  n_prompt, cfg)
        # the planted fault: each product without its last 32 input rows
        with kd_plain_int8(quant, lambda x, q, s:
                           quant.int8_matmul_reference(x[..., :-32],
                                                       q[:-32], s)):
            steps["fault"], _ = llama.decode_step(qparams, cache, tok,
                                                  n_prompt, cfg)
    int8_err = row_rel_err(steps["kernel"], steps["plain"])
    fault_err = row_rel_err(steps["fault"], steps["plain"])
    log("kernel domain (d): one decode step's logits, W8A16 float32 route "
        "against the plain product: row-relative {} (limit {}), planted "
        "fault {}; tokens {}; peak {:.3f} GiB allocated (float32 tree and "
        "int8 tree together), launches {}, {}".format(
            int8_err, KD_INT8_LOGITS_TOL, fault_err, qtokens[0],
            torch.cuda.max_memory_allocated() / 2 ** 30 if card else 0.0,
            json.dumps(launches["f32_int8_serve"]), smi))
    if not int8_err <= KD_INT8_LOGITS_TOL:
        fail("kernel domain (d): the W8A16 float32 route's step {} from "
             "the plain product's".format(int8_err))
    if not fault_err > KD_INT8_LOGITS_TOL:
        fail("kernel domain (d): the planted fault passes the limit "
             "({})".format(fault_err))
    del cache, qmodel, qparams, params
    return launches, {"logits_err": err, "int8_step_err": int8_err,
                      "agreement": agreement}


def _kd_generate(torch, llama, params, cfg, prompt, device):
    """JAX's test_llama_decode_pallas_matches_xla generation: prefill,
    then ``KD_SMALL_TOKENS`` greedy tokens in chunks of
    ``KD_SMALL_CHUNK``; returns (tokens, the last logits)."""
    tokens = torch.tensor([[int(t) for t in prompt]], device=device)
    out, pos = [], len(prompt)
    with torch.inference_mode():
        cache = llama.init_kv_cache(cfg, 1, KD_SMALL_SEQ, device)
        logits, cache = llama.prefill(params, cache, tokens, cfg)
        for _ in range(KD_SMALL_TOKENS // KD_SMALL_CHUNK):
            toks, _, logits, cache = llama.decode_chunk(
                params, cache, logits, pos, cfg, KD_SMALL_CHUNK)
            out += toks[:, 0].tolist()
            pos += KD_SMALL_CHUNK
    return out, logits.float()


def _kernel_domain_small(torch, np, device):
    """(c) tiny (vocab 128) and the narrow D 96 multi-query model, bf16,
    with the kernels against their dense arms: tokens identical, the last
    logits within ``KD_SMALL_LOGITS_TOL``; returns the launches by model."""
    from tpuserver_torch import ops
    from tpuserver_torch.models import llama
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel

    card = device == "cuda"
    tiny = dataclasses.replace(llama.tiny(vocab=128), attn_impl="kernel",
                               decode_impl="auto")
    narrow = dataclasses.replace(tiny, **KD_NARROW)
    launches = {}
    for path, cfg in (("tiny_kernel", tiny), ("narrow_d96", narrow)):
        params = LlamaGenerateModel(cfg=cfg, seed=SEED + 5,
                                    device=device)._ensure_params()
        prompt = np.random.RandomState(9).randint(0, cfg.vocab,
                                                  KD_SMALL_PROMPT)
        ops.reset_launch_counts()
        got, lk = _kd_generate(torch, llama, params, cfg, prompt, device)
        if card:
            torch.cuda.synchronize()
        launches[path] = _route_counts()
        dense = dataclasses.replace(cfg, attn_impl="dense",
                                    decode_impl="dense")
        want, ld = _kd_generate(torch, llama, params, dense, prompt, device)
        err = (lk - ld).abs().max().item()
        log("kernel domain (c) {} (H {}, Hkv {}, D {}): tokens kernel {} | "
            "dense {}; last logits max |kernel - dense| {} (limit {}); "
            "launches {}".format(path, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim, got, want, err,
                                 KD_SMALL_LOGITS_TOL,
                                 json.dumps(launches[path])))
        if got != want:
            fail("kernel domain (c) {}: tokens differ from the dense "
                 "arm's".format(path))
        if not err <= KD_SMALL_LOGITS_TOL:
            fail("kernel domain (c) {}: last logits {} from the dense "
                 "arm's".format(path, err))
        if card:
            kd_routes_launched(path, launches[path], {
                "flash_attention": "wgmma", "decode_attention": "mma"})
            if any(launches[path][k]["simt"] for k in (
                    "flash_attention", "decode_attention")):
                fail("kernel domain (c) {}: a bf16 call launched a simt "
                     "route: {}".format(path, json.dumps(launches[path])))
    return launches


def phase_kernel_domain(torch, np, smi, device="cuda"):
    """Phase 20: (a) every route timed against its plain version; (b)
    llama3_8b in float32 served through the flash and decode kernels'
    float32 routes, one slot and ``KD_SLOTS``, against its dense arm; (d)
    its int8 form through the W8A16 float32 route; (c) tiny and the
    narrow D 96 model through the other-head-dim routes.  TF32 off for
    the phase and restored after.  Returns (the timed rows, the launches
    by path).  ``device="cpu"`` rehearses (b)-(d) on the CPU at float32
    tiny, without (a) and the card's launch checks."""
    card = device == "cuda"
    t_start = _tools_phase_start(torch, card, "kernel domain")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}
    try:
        timed = _kernel_domain_timed(torch) if card else {}
        seconds["(a)"] = time.monotonic() - t_start
        t0 = time.monotonic()
        launches, checks = _kernel_domain_f32(torch, np, smi, device)
        seconds["(b), (d)"] = time.monotonic() - t0
        _release(torch, card)
        t0 = time.monotonic()
        launches.update(_kernel_domain_small(torch, np, device))
        seconds["(c)"] = time.monotonic() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    _tools_phase_end(torch, card, "kernel domain: phase 20", t_start,
                     seconds, smi, launches)
    log("kernel domain: phase 20 {} its {:.0f} s budget; checks {}".format(
        "within" if time.monotonic() - t_start <= KD_BUDGET_S else "OVER",
        KD_BUDGET_S, json.dumps(checks)))
    return timed, launches


#: phase 20's paths: the kernels each runs and the (a) row each is timed
#: as, by kernel
KD_PATHS = {
    "f32_serve": {"flash_attention": "flash_f32_8b",
                  "decode_attention": "decode_f32_8b"},
    "f32_serve_batched": {"flash_attention": "flash_f32_8b",
                          "decode_attention": "decode_f32_8b_batched"},
    "f32_int8_serve": {"flash_attention": "flash_f32_8b",
                       "decode_attention": "decode_f32_8b",
                       "int8_matmul": "int8_f32_step_m1"},
    "tiny_kernel": {"flash_attention": "flash_bf16_d8",
                    "decode_attention": "decode_bf16_tiny"},
    "narrow_d96": {"flash_attention": "flash_bf16_d96",
                   "decode_attention": "decode_bf16_narrow"}}
KD_INT8_SRC = ("src/python/tpuserver_torch/csrc/int8_matmul.cu",
               "src/python/tpuserver/ops/quant.py:68")


def _kd_row(kname, path, counts, row, timed_as):
    """A kernels-line row of phase 20: ``kname``'s launches on its timed
    route on ``path`` (every route's beside them) and its time there."""
    src, replaces = ((KD_INT8_SRC[0], KD_INT8_SRC[1])
                     if kname == "int8_matmul"
                     else (KERNEL_SRC.format(kname), KERNEL_TPU[kname]))
    route = row["kernel_route"]
    return {
        "name": kname, "route": "cuda", "source": src, "replaces": replaces,
        "path": path, "kernel_route": route,
        "launches": counts.get(route, 0) if counts is not None else 0,
        "route_launches": counts, "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "library_live_ms": row.get("library_live_ms"), "timed_as": timed_as,
        "ptxas": row.get("ptxas")}


def kernel_domain_rows(timed, launches):
    """The kernels line's rows for phase 20: each path's kernels on their
    routes (launched there), then every other timed route with the 0
    launches of a shape no path of the phase runs."""
    out, used = [], set()
    for path, kernels in KD_PATHS.items():
        for kname, key in kernels.items():
            out.append(_kd_row(kname, path, launches[path][kname],
                               timed[key], key))
            used.add(key)
    for key, row in timed.items():
        if key not in used:
            r = _kd_row(row["kernel"], "timed_only", None, row, key)
            r["expected_launches"] = 0
            out.append(r)
    return out


# -- main --------------------------------------------------------------------


def _phase_done(started, name):
    """Log the script's seconds when phase ``name`` ended."""
    log("chip_smoke: {} done at {:.1f} s".format(
        name, time.monotonic() - started))


def main():
    import numpy as np
    import torch

    if sys.argv[1:] == ["--child-region"]:
        return child_region(np)
    if sys.argv[1:] == ["--child-server"]:
        return child_server(torch)
    if sys.argv[1:2] == ["--child-serve"]:
        return child_serve(torch, sys.argv[2:])
    if sys.argv[1:2] == ["--child-load"]:
        return child_load(torch, np, sys.argv[2])
    if sys.argv[1:2] == ["--child-bert"]:
        return child_bert(np, sys.argv[2])
    if sys.argv[1:2] == ["--child-train"]:
        return child_train(torch, np, sys.argv[2:])
    if sys.argv[1:] == ["--train-only"]:
        # phases 1, 2 and 11 alone, for work on the training path; prints
        # no result line
        name, smi = phase_device(torch)
        log("nvidia-smi:", smi)
        phase_build()
        phase_train(torch, np)
        log("train-only: done")
        log(smi)
        return 1
    if sys.argv[1:] == ["--bert-only"]:
        # phases 1, 2 and 9 alone, for work on the BERT path; prints no
        # result line
        name, smi = phase_device(torch)
        log("nvidia-smi:", smi)
        phase_build()
        phase_bert(torch, np, smi)
        log("bert-only: done")
        return 1
    if sys.argv[1:] == ["--tp-only"]:
        # phases 1-4b and 10 alone, for work on the TP path (4 and 4b
        # give the unsharded tokens phase 10 holds tp=1 to); prints no
        # result line
        name, smi = phase_device(torch)
        log("nvidia-smi:", smi)
        phase_build()
        phase_kernels(torch)
        model, core, prompt, _, tokens, rates, single = phase_serve(torch, np)
        b_prompts, b_budgets, b_tokens = phase_serve_batched(
            torch, np, model, prompt, tokens, rates)[3:]
        core.close()
        del model, core
        gc.collect()
        torch.cuda.empty_cache()
        phase_tp(torch, np, single, b_prompts, b_budgets, b_tokens)
        log("tp-only: done")
        log(smi)
        return 1
    if sys.argv[1:] == ["--fleet-only"]:
        # phases 1-4b (4b's tokens are what the fleet must stream) and 4g
        # alone, for work on the fleet tier; prints no result line
        name, smi = phase_device(torch)
        log("nvidia-smi:", smi)
        phase_build()
        model, core, prompt, _, tokens, rates, single = phase_serve(torch, np)
        b_prompts, b_budgets, b_tokens = phase_serve_batched(
            torch, np, model, prompt, tokens, rates)[3:]
        cfg = model._cfg
        core.close()
        del model, core
        gc.collect()
        torch.cuda.empty_cache()
        started = time.monotonic()
        phase_fleet(torch, np, cfg, b_prompts, b_budgets, b_tokens)
        log("fleet: (a)-(d) {:.1f} s".format(time.monotonic() - started))
        phase_fleet_supervised(np, b_prompts, b_budgets, b_tokens)
        log("fleet-only: done")
        log(smi)
        return 1
    if sys.argv[1:] == ["--perf-only"]:
        # phases 1-4b and 12 alone, for work on the perf analyzer; phase
        # 12 serves phase 4's weights; prints no result line
        name, smi = phase_device(torch)
        log("nvidia-smi:", smi)
        phase_build()
        phase_kernels(torch)
        model, core, prompt, _, tokens, rates, single = phase_serve(torch, np)
        phase_serve_batched(torch, np, model, prompt, tokens, rates)
        core.close()
        cfg, params = model._cfg, model._ensure_params()
        del model, core
        gc.collect()
        torch.cuda.empty_cache()
        phase_perf(torch, np, cfg, params, smi)
        log("perf-only: done")
        log(smi)
        return 1
    if sys.argv[1:] == ["--bench-only"]:
        # phases 1-3 and 13 alone, for work on the benchmark; phase 13 on
        # weights drawn from the seed; prints no result line
        from tpuserver_torch.models import llama
        from tpuserver_torch.models.llama_serving import LlamaGenerateModel

        name, smi = phase_device(torch)
        log("nvidia-smi:", smi)
        phase_build()
        phase_kernels(torch)
        drawn = LlamaGenerateModel(cfg=llama.llama3_8b(), seed=SEED,
                                   device="cuda")
        phase_bench(torch, np, drawn._cfg, drawn._ensure_params(), smi)
        log("bench-only: done")
        log(smi)
        return 1
    if sys.argv[1:] == ["--chaos-only"]:
        # phases 1-3 and 14 alone, for work on the chaos soak; phase 14 on
        # weights drawn from the seed; prints no result line
        from tpuserver_torch.models import llama
        from tpuserver_torch.models.llama_serving import LlamaGenerateModel

        name, smi = phase_device(torch)
        log("nvidia-smi:", smi)
        phase_build()
        phase_kernels(torch)
        drawn = LlamaGenerateModel(cfg=llama.llama3_8b(), seed=SEED,
                                   device="cuda")
        params = drawn._ensure_params()
        del drawn
        phase_chaos(torch, llama.llama3_8b(), params, smi)
        log("chaos-only: done")
        log(smi)
        return 1
    if sys.argv[1:] == ["--tools-only"]:
        # phases 1-3 and 15 alone, phase 15 on weights drawn from the
        # seed; prints the tools' kernels line and no result line
        from tpuserver_torch.models import llama
        from tpuserver_torch.models.llama_serving import LlamaGenerateModel

        name, smi = phase_device(torch)
        log("nvidia-smi:", smi)
        phase_build()
        rows = phase_kernels(torch)
        drawn = LlamaGenerateModel(cfg=llama.llama3_8b(), seed=SEED,
                                   device="cuda")
        params = drawn._ensure_params()
        del drawn
        launches = phase_tools(torch, params, smi)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"kernels": _tools_kernel_rows(torch, rows,
                                                        launches)}))
        log("tools-only: done")
        log(smi)
        return 1
    if sys.argv[1:] == ["--serving-tools-only"]:
        # phases 1-3 and 16 alone, phase 16 on weights drawn from the
        # seed; prints the tools' kernels line and no result line
        from tpuserver_torch.models import llama
        from tpuserver_torch.models.llama_serving import LlamaGenerateModel

        name, smi = phase_device(torch)
        log("nvidia-smi:", smi)
        phase_build()
        phase_kernels(torch)
        timed, max_err = _serving_tools_timed(torch)
        drawn = LlamaGenerateModel(cfg=llama.llama3_8b(), seed=SEED,
                                   device="cuda")
        params = drawn._ensure_params()
        del drawn
        launches = phase_serving_tools(torch, params, smi)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"kernels": _serving_tools_kernel_rows(
            launches, timed, max_err)}))
        log("serving-tools-only: done")
        log(smi)
        return 1
    if sys.argv[1:] == ["--distributed-only"]:
        # phases 1-3 and 17 alone, phase 17 on weights drawn from the
        # seed; prints the phase's kernels line and no result line
        from tpuserver_torch.models import llama
        from tpuserver_torch.models.llama_serving import LlamaGenerateModel

        name, smi = phase_device(torch)
        log("nvidia-smi:", smi)
        phase_build()
        rows = phase_kernels(torch)
        decode_row = _distributed_timed(torch)
        drawn = LlamaGenerateModel(cfg=llama.llama3_8b(), seed=SEED,
                                   device="cuda")
        cfg, params = drawn._cfg, drawn._ensure_params()
        del drawn
        launches = phase_distributed(torch, cfg, params, smi)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"kernels": _distributed_kernel_rows(
            rows, decode_row, launches)}))
        log("distributed-only: done")
        log(smi)
        return 1
    if sys.argv[1:] == ["--prefix-cache-only"]:
        # phases 1-3 and 18 alone; phase 18's tools draw their weights from
        # the seed; prints the phase's kernels line and no result line
        name, smi = phase_device(torch)
        log("nvidia-smi:", smi)
        phase_build()
        phase_kernels(torch)
        timed, max_err = _prefix_cache_timed(torch)
        launches = phase_prefix_cache(torch, smi)
        print(json.dumps({"kernels": _prefix_cache_kernel_rows(
            launches, timed, max_err)}))
        log("prefix-cache-only: done")
        log(smi)
        return 1
    if sys.argv[1:] == ["--router-view-only"]:
        # phases 1-3 and 19 alone, phase 19 on weights drawn from the
        # seed; prints the phase's kernels line and the result line
        from tpuserver_torch.models import llama
        from tpuserver_torch.models.llama_serving import LlamaGenerateModel

        started = time.monotonic()
        name, smi = phase_device(torch)
        log("nvidia-smi:", smi)
        phase_build()
        rows = phase_kernels(torch)
        decode_row = _router_view_timed(torch)
        drawn = LlamaGenerateModel(cfg=llama.llama3_8b(), seed=SEED,
                                   device="cuda")
        cfg, params = drawn._cfg, drawn._ensure_params()
        del drawn
        launches = phase_router_view(torch, cfg, params, smi)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log("router-view-only: done in {:.1f} s".format(
            time.monotonic() - started))
        log(smi)
        print(json.dumps({"kernels": _router_view_kernel_rows(
            rows, decode_row, launches)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--kernel-domain-only"]:
        # phases 1-3 and 20 alone; prints the phase's kernels line and
        # the result line
        started = time.monotonic()
        name, smi = phase_device(torch)
        log("nvidia-smi:", smi)
        phase_build()
        phase_kernels(torch)
        _phase_done(started, "kernels (3)")
        timed, launches = phase_kernel_domain(torch, np, smi)
        log("kernel-domain-only: done in {:.1f} s".format(
            time.monotonic() - started))
        log(smi)
        print(json.dumps({"kernels": kernel_domain_rows(timed, launches)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--vision-only"]:
        # phases 1, 2 and 8 alone, for work on the vision path; prints no
        # result line
        name, smi = phase_device(torch)
        log("nvidia-smi:", smi)
        phase_build()
        phase_vision(torch, np, smi)
        log("vision-only: done")
        return 1
    started = time.monotonic()
    log("installs: grpcio {grpcio}, protobuf {protobuf}".format(
        **_install_versions()))
    name, smi = phase_device(torch)
    log("nvidia-smi:", smi)
    phase_build()
    rows = phase_kernels(torch)
    _phase_done(started, "kernels (3)")
    model, core, prompt, launches, tokens, rates, single = phase_serve(
        torch, np)
    _phase_done(started, "serve (4)")
    batched_launches, batched_steps, batched, b_prompts, b_budgets, \
        b_tokens = phase_serve_batched(torch, np, model, prompt, tokens,
                                       rates)
    _phase_done(started, "serve_batched (4b)")
    cfg, params = model._cfg, model._ensure_params()
    batched_steps.update(phase_spec_step(torch, np, cfg, params, batched))
    spec_launches = phase_serve_spec(torch, np, cfg, params, b_prompts,
                                     b_budgets)
    _phase_done(started, "spec (4c a, b)")
    readmits = []
    heal_launches = phase_heal(torch, np, cfg, params, readmits)
    _phase_done(started, "heal (4c c, d)")
    shm_launches = phase_shm(torch, np, cfg, params, b_prompts, b_budgets,
                             b_tokens)
    _phase_done(started, "shm (4e)")
    grpc_launches = phase_grpc(torch, np, cfg, params, b_prompts, b_budgets,
                               b_tokens, readmits)
    _phase_done(started, "grpc (4f)")
    phase_flash_lengths(torch, rows, readmits)
    phase_model_check(torch, model, prompt)
    _phase_done(started, "model check (5)")
    profile = phase_profile(torch, model, prompt, batched_steps)
    _phase_done(started, "profile (6)")
    core.close()
    # phase 4g's two replica processes need the card: release this
    # process's models first
    del model, core, params, batched, batched_steps
    gc.collect()
    torch.cuda.empty_cache()
    log("fleet: this process holds {:.3f} GiB after releasing its "
        "models".format(torch.cuda.memory_allocated() / 2 ** 30))
    fleet_launches, handoff_lengths = phase_fleet(
        torch, np, cfg, b_prompts, b_budgets, b_tokens)
    _phase_done(started, "fleet (4g a-d)")
    phase_fleet_supervised(np, b_prompts, b_budgets, b_tokens)
    _phase_done(started, "fleet (4g e)")
    phase_flash_lengths(torch, rows, handoff_lengths,
                        timed_as="flash_attention_handoff")
    int8_cases, int8_steps, int8_launches, int8_profile = phase_int8(
        torch, np, tokens, b_prompts, b_budgets)
    log("int8 vs bf16, device ms by kernel class: {}".format(json.dumps({
        name: {"bf16": profile[name]["device_ms_by_class"],
               "int8": int8_profile[name]["device_ms_by_class"]}
        for name in int8_profile})))
    _phase_done(started, "int8 (7)")
    phase_vision(torch, np, smi)
    _phase_done(started, "vision (8)")
    client_launches, llama_model = phase_bert(torch, np, smi)
    _phase_done(started, "bert (9)")
    # phase 12 serves phase 9 (e)'s weights again, then releases them: the
    # TP phase's ranks need the card
    perf_launches = phase_perf(torch, np, llama_model._cfg,
                               llama_model._ensure_params(), smi)
    _phase_done(started, "perf (12)")
    # phase 13 serves the same weights again behind the benchmark's zoo
    bench_launches = phase_bench(torch, np, llama_model._cfg,
                                 llama_model._ensure_params(), smi)
    _phase_done(started, "bench (13)")
    # phase 14 upcasts them to float32 in place and soaks them
    cfg8b, params8b = llama_model._cfg, llama_model._ensure_params()
    del llama_model
    chaos_launches = phase_chaos(torch, cfg8b, params8b, smi)
    _phase_done(started, "chaos (14)")
    del params8b
    gc.collect()
    torch.cuda.empty_cache()
    tp_launches = phase_tp(torch, np, single, b_prompts, b_budgets, b_tokens)
    _phase_done(started, "tp (10)")
    train = phase_train(torch, np)
    _phase_done(started, "train (11)")

    kernels = []
    # each kernel once per path: the single-stream serve (phase 4, timed
    # at one row), the batched serve (phase 4b; decode timed at the
    # batched shape, flash at the same 512-token prefill), the speculative
    # serve (phase 4c b), the re-admissions of phase 4c's fault rounds
    # and resumes (c, d; flash timed at the 640-token re-admission), and
    # phase 4e's paths: the shm plane (a, b), the attach resumes (c) and
    # the decode leg on server B (d); phase 4f (a), the gRPC stream; and
    # phase 4g's replica processes: the prefill replica's legs (a), the
    # decode replica's attached legs (a) and the prefill replica's
    # handoff re-prefills after the decode replica's SIGKILL (c), whose
    # flash row stands only when a re-prefill's length tiled (timed at
    # the least such length; the others ran dense)
    decode_src = "src/python/tpuserver_torch/csrc/decode_attention.cu"
    flash_src = "src/python/tpuserver_torch/csrc/flash_attention.cu"
    decode_tpu = "src/python/tpuserver/ops/flash.py:263"
    flash_tpu = "src/python/tpuserver/ops/flash.py:139"
    paths = [
        ("flash_attention", flash_src, flash_tpu, "serve",
         "flash_attention", launches),
        ("decode_attention", decode_src, decode_tpu, "serve",
         "decode_attention", launches),
        ("flash_attention", flash_src, flash_tpu, "serve_batched",
         "flash_attention", batched_launches),
        ("decode_attention", decode_src, decode_tpu, "serve_batched",
         "decode_attention_batched", batched_launches),
        ("decode_attention", decode_src, decode_tpu, "serve_spec",
         "decode_attention_batched", spec_launches),
        ("flash_attention", flash_src, flash_tpu, "readmission",
         "flash_attention_readmission", heal_launches),
        ("decode_attention", decode_src, decode_tpu, "readmission",
         "decode_attention_batched", heal_launches),
        ("flash_attention", flash_src, flash_tpu, "shm_plane",
         "flash_attention", shm_launches["shm_plane"]),
        ("decode_attention", decode_src, decode_tpu, "shm_plane",
         "decode_attention_batched", shm_launches["shm_plane"]),
        ("decode_attention", decode_src, decode_tpu, "kv_attach",
         "decode_attention_batched", shm_launches["kv_attach"]),
        ("decode_attention", decode_src, decode_tpu, "kv_handoff",
         "decode_attention_batched", shm_launches["kv_handoff"]),
        ("flash_attention", flash_src, flash_tpu, "serve_grpc",
         "flash_attention", grpc_launches),
        ("decode_attention", decode_src, decode_tpu, "serve_grpc",
         "decode_attention_batched", grpc_launches),
        ("flash_attention", flash_src, flash_tpu, "fleet_prefill_leg",
         "flash_attention", fleet_launches["fleet_prefill_leg"]),
        ("decode_attention", decode_src, decode_tpu, "fleet_prefill_leg",
         "decode_attention_batched", fleet_launches["fleet_prefill_leg"]),
        ("decode_attention", decode_src, decode_tpu, "fleet_decode_leg",
         "decode_attention_batched", fleet_launches["fleet_decode_leg"]),
        ("decode_attention", decode_src, decode_tpu, "fleet_handoff",
         "decode_attention_batched", fleet_launches["fleet_handoff"])]
    if fleet_launches["fleet_handoff"]["flash_attention"]:
        paths.append(
            ("flash_attention", flash_src, flash_tpu, "fleet_handoff",
             "flash_attention_handoff", fleet_launches["fleet_handoff"]))
    # phase 12 (a): the perf analyzer's generation load, in-process,
    # batched (decode timed at the batched shape, flash at the 512-token
    # prefill)
    paths += [("flash_attention", flash_src, flash_tpu,
               "perf_inprocess_generation", "flash_attention", perf_launches),
              ("decode_attention", decode_src, decode_tpu,
               "perf_inprocess_generation", "decode_attention_batched",
               perf_launches)]
    # phase 13: config 5's direct rows (flash timed at their 2048-token
    # prefill; decode at one row of 576 keys, the direct decode's
    # contexts being 512-704), and the served streams (decode timed at
    # the batched step's eight rows in the 512-key cache; their 8-token
    # prompts run dense, so a flash row stands only if one tiled)
    paths += [("flash_attention", flash_src, flash_tpu, "bench",
               "flash_attention_T2048", bench_launches["bench"]),
              ("decode_attention", decode_src, decode_tpu, "bench",
               "decode_attention", bench_launches["bench"]),
              ("decode_attention", decode_src, decode_tpu, "bench_served",
               "decode_attention_bench_served",
               bench_launches["bench_served"])]
    if bench_launches["bench_served"]["flash_attention"]:
        paths.append(("flash_attention", flash_src, flash_tpu,
                      "bench_served", "flash_attention",
                      bench_launches["bench_served"]))
    # phase 14: the chaos soak's batched decode in float32 (timed at its
    # two slots of a 128-token cache); its prefills run dense, and the
    # flash row stands with its 0 launches, which the phase asserts
    paths.append(("decode_attention", decode_src, decode_tpu, "chaos",
                  "decode_attention_chaos", chaos_launches))
    # phase 9 (e): the llama client's single-stream generations over CUDA
    # regions (4-token prompts: their prefills run dense, no flash)
    paths.append(("decode_attention", decode_src, decode_tpu,
                  "cudashm_client", "decode_attention", client_launches))
    if client_launches["flash_attention"]:
        paths.append(("flash_attention", flash_src, flash_tpu,
                      "cudashm_client", "flash_attention", client_launches))
    # phase 7's int8 paths: single-stream, batched, speculative
    for path, timed_as in (("serve_int8", "decode_attention"),
                           ("serve_int8_batched", "decode_attention_batched"),
                           ("serve_int8_spec", "decode_attention_batched")):
        paths += [("flash_attention", flash_src, flash_tpu, path,
                   "flash_attention", int8_launches[path]),
                  ("decode_attention", decode_src, decode_tpu, path,
                   timed_as, int8_launches[path])]
    for kname, src, replaces, path, timed_as, counts in paths:
        row = rows["timed"][timed_as]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "kernel_route": _route_of(kname, row),
            "replaces": replaces, "path": path, "launches": counts[kname],
            "max_abs_err": rows["max_err"][kname],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_live_ms": row.get("library_live_ms")})
    # the W8A16 kernel has no Pallas counterpart: it replaces the XLA
    # fusion of the JAX package's weight-only product.  Its times are one
    # decode step's worth (every layer's seven weights and the lm_head)
    # at the step's rows, each shape timed in phase 7 (a)
    int8_err = max(r["max_abs_err"] for r in int8_cases.values())
    for path, m in (("serve_int8", 1), ("serve_int8_batched", 8),
                    ("serve_int8_spec", 8)):
        step = int8_steps[m]
        kernels.append({
            "name": "int8_matmul", "route": "cuda",
            "kernel_route": _route_of("int8_matmul", step),
            "source": "src/python/tpuserver_torch/csrc/int8_matmul.cu",
            "replaces": "src/python/tpuserver/ops/quant.py:68",
            "path": path,
            "launches": int8_launches[path]["int8_matmul"],
            "max_abs_err": int8_err, "ms": step["ms"],
            "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
            "bound_by": step["bound_by"], "library_ms": step["library_ms"],
            "bf16_matmul_ms": step["bf16_matmul_ms"],
            "timed_as": "one decode step at M {}: {}".format(
                m, step["shape"])})
    # phase 10's paths: launches summed over the ranks (each rank's
    # beside them); the tp=4 rows timed at one rank's shapes (H 8, Hkv 2;
    # the W8A16 shard products of one decode step), tp=1 at the model's
    int8_src = "src/python/tpuserver_torch/csrc/int8_matmul.cu"
    for kname, src, replaces, path, timed_as in (
            ("flash_attention", flash_src, flash_tpu, "tp1_single",
             "flash_attention"),
            ("decode_attention", decode_src, decode_tpu, "tp1_single",
             "decode_attention"),
            ("flash_attention", flash_src, flash_tpu, "tp1_batched",
             "flash_attention"),
            ("decode_attention", decode_src, decode_tpu, "tp1_batched",
             "decode_attention_batched"),
            ("flash_attention", flash_src, flash_tpu, "tp4_single",
             "flash_attention_tp4"),
            ("decode_attention", decode_src, decode_tpu, "tp4_single",
             "decode_attention_tp4"),
            ("flash_attention", flash_src, flash_tpu, "tp4_batched",
             "flash_attention_tp4"),
            ("decode_attention", decode_src, decode_tpu, "tp4_batched",
             "decode_attention_tp4_batched"),
            ("flash_attention", flash_src, flash_tpu, "tp4_int8",
             "flash_attention_tp4"),
            ("decode_attention", decode_src, decode_tpu, "tp4_int8",
             "decode_attention_tp4"),
            ("int8_matmul", int8_src, "src/python/tpuserver/ops/quant.py:68",
             "tp4_int8", "int8_matmul_tp4_step")):
        row = rows["timed"][timed_as]
        by_rank = tp_launches[path][kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "kernel_route": _route_of(kname, row),
            "replaces": replaces, "path": path, "launches": sum(by_rank),
            "launches_by_rank": by_rank,
            "max_abs_err": (row["max_abs_err"] if kname == "int8_matmul"
                            else rows["max_err"][kname]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "timed_as": row.get("shape") or "h {} hkv {}".format(
                row["h"], row["hkv"])})
    # phase 11: the training steps run none of the kernels (JAX trains
    # through its ring fold, no Pallas kernel, and so does the port); the
    # unsharded forward that step 0's loss is held against runs flash at
    # T 512.  Their launches (the steps', 0 when all is well) stand in
    # that row as ``train_step_launches``
    row = rows["timed"]["flash_attention"]
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": flash_src,
        "kernel_route": _route_of("flash_attention", row),
        "replaces": flash_tpu, "path": "train_reference_forward",
        "launches": train["reference_launches"]["flash_attention"],
        "max_abs_err": rows["max_err"]["flash_attention"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "train_step_launches": train["step_launches"]})
    row = rows["timed"]["flash_attention"]
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": flash_src,
        "kernel_route": _route_of("flash_attention", row),
        "replaces": flash_tpu, "path": "chaos",
        "launches": chaos_launches["flash_attention"],
        "expected_launches": 0,
        "max_abs_err": rows["max_err"]["flash_attention"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"]})
    # every route of each kernel by name, with the error phase 3 held it to
    for k in kernels:
        k["routes_held_in_phase3"] = rows["route_err"][k["name"]]
    idle = [(k["name"], k["path"]) for k in kernels
            if "expected_launches" not in k and (
                not k["launches"]
                or not all(k.get("launches_by_rank", [1])))]
    if idle:
        fail("kernels of a path never launched on it: {}".format(idle))
    log("chip_smoke: {:.1f} s".format(time.monotonic() - started))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
