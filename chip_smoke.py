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
   over the live prefix alone);
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
   kernel launches on stdin), behind the JAX package's router run as a
   process (``tools/router.py --probe-interval 0.2``, reached over HTTP
   only; its first log line is printed, and its exit fails the phase):
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
   re-prefill lengths; (d) P SIGTERMed exits 0;
7. int8, last: (a) the W8A16 kernel (``csrc/int8_matmul.cu``) against its
   plain version at the five distinct Llama-3-8B weight shapes and 1, 8
   and 40 rows (row-relative ``INT8_TOL``, a planted fault, each row bit
   for bit the same row computed alone), timed beside its bound (and its
   bandwidth share, ``perf.mbu``), the bf16 ``torch.matmul`` of the
   unquantized weight, the plain version and the library's W8A16 call,
   and summed to one decode step's products at each of the three row
   counts; (b) ``llama3_8b`` with int8 weights
   (``LlamaGenerateModel(quantize=True)``, drawn and quantized on the
   card): phase 4's three requests, then 4b's 12 prompts and 4 repetitive
   ones over ``max_slots=8`` forward and reversed and with
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
   launches are read and must be 0).

The peaks of every bound come from ``tpuserver_torch.ops.perf`` by the
card's name (phase 1 fails on a card the table does not know).  The line
before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src", "python"))

# the card's published peaks (HBM bytes/s, dense bf16 tensor-core
# operations/s), read from tpuserver_torch.ops.perf by name in phase 1;
# float32 outside the tensor cores is not in that table (H100 SXM, NVIDIA
# data sheet)
SPEC = None
F32_OPS_PER_S = 67e12

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
            if dtype == torch.bfloat16 else F32_OPS_PER_S)
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
            if dtype == torch.bfloat16 else F32_OPS_PER_S)
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
    for b, t, causal, dtype, hh, kk, dd in (
            *((1, t, True, bf16, h, hkv, d) for t in prefill_ts),
            (1, 512, False, bf16, h, hkv, d),
            (1, 2048, True, bf16, h, hkv, d),
            (1, 2048, False, bf16, h, hkv, d),
            (2, 256, True, bf16, 16, 8, 64)):  # Llama-3.2-1B head dim
        main = (t == 512 and causal and dtype == bf16)
        readmit = (t == READMIT_LENGTH and b == 1)
        row = _flash_case(torch, F, fl, dev, gen, b, t, hh, kk, dd, causal,
                          dtype, main or readmit or (t == 2048 and causal),
                          flush)
        row["kernel"] = "flash_attention"
        rows.append(row)
        if main:
            timed["flash_attention"] = row
        if readmit:
            timed["flash_attention_readmission"] = row
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
            ((40, 17), 64, f32, 6, 2, 16)):
        main = lengths == (576,)
        batched = lengths == BATCHED_LENGTHS
        row = _decode_case(torch, F, fl, dev, gen, lengths, ss, hh, kk, dd,
                           dtype, main or batched or lengths == (4096,),
                           flush)
        row["kernel"] = "decode_attention"
        rows.append(row)
        if main:
            timed["decode_attention"] = row
        if batched:
            timed["decode_attention_batched"] = row
        if len(lengths) == 34 and row["n_split"] != 1:
            fail("decode_splits chose {} splits for B 34 (want 1)".format(
                row["n_split"]))
        if lengths == (1,) and not row["n_split"] > 1:
            fail("decode_splits chose 1 split for one 8B stream on {} "
                 "SMs".format(n_sms))
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
    max_err = {}
    for row in rows:
        max_err[row["kernel"]] = max(max_err.get(row["kernel"], 0.0),
                                     row["max_abs_err"])
    return {"timed": timed, "max_err": max_err,
            "flash_lengths": set(prefill_ts)}


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
    return model, core, long_prompt, launches, runs[0], rates


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


def phase_fleet(torch, np, cfg, prompts, budgets, tokens_4b):
    """Phase 4g: two ``llama3_8b`` replica processes (``--child-serve``,
    ``--role prefill`` and ``--role decode``) behind the JAX package's
    router (``tools/router.py``, a process reached over HTTP only): (a)
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
        [sys.executable, os.path.join(HERE, "tools", "router.py"),
         "--backends", "127.0.0.1:{},127.0.0.1:{}".format(pport, dport),
         "--port", str(rport), "--probe-interval", str(FLEET_PROBE_S)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        bufsize=1)
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
INT8_BUDGET_REPETITIVE = 32


def _int8_cases(torch, quant, perf, dev, gen, k, n, flush):
    """The W8A16 kernel against its plain version at one weight shape and
    each of ``INT8_ROWS``: two calls equal, each row equal bit for bit to
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
    x = torch.randn(max(INT8_ROWS), k, device=dev, generator=gen).to(
        torch.bfloat16)
    alone = torch.cat([quant.int8_matmul(x[i:i + 1], q, s)
                       for i in range(len(x))])
    cut = q.clone()
    cut[-32:] = 0
    wt, sb = q.t().contiguous(), s.to(torch.bfloat16)
    rows = []
    for m in INT8_ROWS:
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


def _int8_step_sum(cases, m, n_layers):
    """One decode step's W8A16 work at ``m`` rows from the timed shapes:
    every layer's seven products and the lm_head's, summed."""
    uses = {}
    for name, k, n in INT8_WEIGHTS:
        uses[(k, n)] = uses.get((k, n), 0) + (1 if name == "lm_head"
                                              else n_layers)
    out = {"m": m, "shape": "{} layers x (wq, wk, wv, wo, w_gate, w_up, "
           "w_down) + lm_head".format(n_layers)}
    for key in ("ms", "plain_ms", "bound_ms", "bf16_matmul_ms",
                "library_ms"):
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
    and 4 repetitive ones over ``max_slots=8`` forward and in reverse, and
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
    budgets = list(budgets) + [INT8_BUDGET_REPETITIVE] * 4
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
# (e): CUDA-event samples per forward, each alone behind a hold of the
# card while the host enqueues it (a DenseNet-121 forward is about 440
# launches and 6 ms of host time; ten at once would overrun the launch
# queue, and the host would pace the card)
VISION_ITERS = 10
VISION_HOLD_CYCLES = int(3e7)


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


def _leaves(tv, tree):
    """The tensors of a vision parameter tree."""
    out = []
    tv.tree_map(out.append, tree)
    return out


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
    card held (``VISION_HOLD_CYCLES``) while the host enqueues it, after
    an L2 flush."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(VISION_HOLD_CYCLES)
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


def _vision_forward_numbers(torch, tv, models, smi):
    """(e): each model's forward at batch 1 and 32: device time by CUDA
    events (L2 flushed, the card held while the host enqueues) against
    its bound, and under torch.profiler the device time by kernel class
    and the busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = {}
    for model in models:
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in _leaves(tv, model.params()))
        for b in VISION_BATCHES:
            x = torch.rand((b,) + IMAGE, generator=gen, device="cuda")

            def fn():
                with torch.inference_mode():
                    return model.logits(x)

            ms = _time_forward_ms(torch, fn, VISION_ITERS, flush)
            ops = model.operations(b)
            nbytes = weight_bytes + b * (IMAGE_BYTES + 1000 * 2)
            bound_ms, bound_by = _bound_ms(nbytes, ops,
                                           SPEC.peak_bf16_flops)
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
                cls = _vision_class(ev.key)
                by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
                kernels.append((dev_us / 1e3, ev.count, ev.key[:80]))
                launches += ev.count
            device_ms = sum(by_class.values())
            key = "{}_b{}".format(model.name, b)
            out[key] = {
                "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "gflop": ops / 1e9, "bytes": nbytes,
                "images_per_s": b / ms * 1e3,
                "wall_ms": wall_ms, "wall_ms_samples": walls,
                "profiled_device_ms": device_ms,
                "busy_share": device_ms / wall_ms if wall_ms else None,
                "device_launches": launches,
                "device_ms_by_class": by_class,
                "top_kernels": sorted(kernels, reverse=True)[:6]}
            log("vision (e) forward {}: {:.4f} ms device (events), bound "
                "{:.4f} ms ({}; {:.3f} GFLOP), {:.1f} images/s; wall {:.3f} "
                "ms, busy share {:.3f}, {} kernels; {}".format(
                    key, ms, bound_ms, bound_by, ops / 1e9, b / ms * 1e3,
                    wall_ms, device_ms / wall_ms if wall_ms else 0,
                    launches, smi))
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
                      for t in _leaves(tv, m.params())) / 1e6
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
        _vision_forward_numbers(torch, tv, (resnet, densenet), smi)
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
    from torch.profiler import ProfilerActivity, profile

    from tpuserver_torch.models import llama

    params, cfg = model._ensure_params(), model._cfg
    tokens = torch.tensor(prompt, dtype=torch.long, device="cuda")[None, :]
    out = {}
    with torch.inference_mode():
        cache = llama.init_kv_cache(cfg, 1, 4096, "cuda")
        logits, _ = llama.prefill(params, cache, tokens, cfg)
        steps = {
            "prefill_512": lambda: llama.prefill(params, cache, tokens, cfg),
            "decode_chunk_8": lambda: llama.decode_chunk(
                params, cache, logits, tokens.shape[1], cfg, 8),
            **batched_steps,
        }
        for name, fn in steps.items():
            fn()
            # the host's clock moves far more than device time between
            # machines: keep every sample, rate by the median
            walls = []
            for _ in range(WALL_REPS):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                fn()
                torch.cuda.synchronize()
                walls.append((time.monotonic() - t0) * 1e3)
            wall_ms = sorted(walls)[WALL_REPS // 2]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         acc_events=True) as prof:
                fn()
                torch.cuda.synchronize()
            by_class, kernels, host = {}, [], []
            for ev in prof.key_averages():
                if ev.key.startswith("aten::") and ev.self_cpu_time_total > 0:
                    host.append((ev.self_cpu_time_total / 1e3, ev.count,
                                 ev.key))
                dev_us = getattr(ev, "self_device_time_total",
                                 getattr(ev, "self_cuda_time_total", 0))
                if dev_us <= 0 or not str(ev.device_type).endswith("CUDA"):
                    continue
                cls = _kernel_class(ev.key)
                by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
                kernels.append((dev_us / 1e3, ev.count, ev.key[:80]))
            device_ms = sum(by_class.values())
            out[name] = {
                "wall_ms": wall_ms, "wall_ms_samples": walls,
                "device_ms": device_ms,
                "busy_share": device_ms / wall_ms if wall_ms else None,
                "device_ms_by_class": by_class,
                "top_kernels": sorted(kernels, reverse=True)[:6],
                "top_host_ops_ms": sorted(host, reverse=True)[:6]}
        del cache
    log(label + ":", json.dumps(out))
    if not any(v["device_ms"] > 0 for v in out.values()):
        log(label + ": torch.profiler recorded no device time")
    return out


# -- main --------------------------------------------------------------------


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
    model, core, prompt, launches, tokens, rates = phase_serve(torch, np)
    batched_launches, batched_steps, batched, b_prompts, b_budgets, \
        b_tokens = phase_serve_batched(torch, np, model, prompt, tokens,
                                       rates)
    cfg, params = model._cfg, model._ensure_params()
    batched_steps.update(phase_spec_step(torch, np, cfg, params, batched))
    spec_launches = phase_serve_spec(torch, np, cfg, params, b_prompts,
                                     b_budgets)
    readmits = []
    heal_launches = phase_heal(torch, np, cfg, params, readmits)
    shm_launches = phase_shm(torch, np, cfg, params, b_prompts, b_budgets,
                             b_tokens)
    grpc_launches = phase_grpc(torch, np, cfg, params, b_prompts, b_budgets,
                               b_tokens, readmits)
    phase_flash_lengths(torch, rows, readmits)
    phase_model_check(torch, model, prompt)
    profile = phase_profile(torch, model, prompt, batched_steps)
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
    phase_flash_lengths(torch, rows, handoff_lengths,
                        timed_as="flash_attention_handoff")
    int8_cases, int8_steps, int8_launches, int8_profile = phase_int8(
        torch, np, tokens, b_prompts, b_budgets)
    log("int8 vs bf16, device ms by kernel class: {}".format(json.dumps({
        name: {"bf16": profile[name]["device_ms_by_class"],
               "int8": int8_profile[name]["device_ms_by_class"]}
        for name in int8_profile})))
    phase_vision(torch, np, smi)

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
    idle = [(k["name"], k["path"]) for k in kernels if not k["launches"]]
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
