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
   UNIMPLEMENTED for a repository verb;
5. model check: the 512-token prompt's last-position prefill logits
   through the kernels against the same model through the plain
   attention versions, and the greedy tokens of both;
6. profile: one prefill, one decode chunk, one batched paged step (8
   live rows near length 600), four in the scheduler's pipeline, and one
   speculative verify (K 4) beside the five plain steps it stands for,
   under ``torch.profiler``: device time by kernel class (the page gather
   apart) beside the wall time.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src", "python"))

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# bf16 tensor-core operations/s, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
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
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    log("device:", name, "count:", torch.cuda.device_count(),
        "torch", torch.__version__, "cuda", torch.version.cuda)
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
    t_bytes = nbytes / HBM_BYTES_PER_S
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
            nbytes, 4 * pairs * d, BF16_OPS_PER_S
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
            nbytes, 4 * live * h * d, BF16_OPS_PER_S
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


def phase_flash_lengths(torch, rows, lengths):
    """Phase 3, continued: the flash kernel against its plain version at
    every prefill length a later phase ran through it that phase 3 did
    not check (phase 4c's re-admissions depend on when a fault hit)."""
    import torch.nn.functional as F

    from tpuserver_torch.models import llama
    from tpuserver_torch.ops import flash as fl

    cfg = llama.llama3_8b()
    new = sorted(t for t in set(lengths) - rows["flash_lengths"]
                 if None not in llama._flash_blocks(t, cfg))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
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

    prof_tables = np.arange(slots * ppseq, dtype=np.int32).reshape(
        slots, ppseq)
    prof_pos = np.array(BATCHED_LENGTHS, np.int32) - 1
    prof_active = np.ones((slots,), bool)
    state = {"pages": pages, "logits": logits_all}

    def dispatch():
        toks, lps, state["logits"], state["pages"] = fns["step"](
            params, state["pages"], state["logits"], prof_tables, prof_pos,
            prof_active, no_force, no_force.astype(bool))
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

    torch.cuda.synchronize()
    log("serve_batched: peak device memory {:.3f} GiB (weights, phase 4's "
        "model and this phase)".format(
            torch.cuda.max_memory_allocated() / 2 ** 30))
    return launches, {"batched_step_8": batched_step,
                      "batched_steps_8_x4_pipelined": pipelined_steps}, {
        "fns": fns, "state": state, "tables": prof_tables,
        "positions": prof_pos}, prompts, budgets, rounds[0]


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
    counters against ``scheduler_stats()``, a NOT_FOUND and an
    UNIMPLEMENTED.  Every admission prefill's length is recorded into
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
            *codes))
        if codes != ["NOT_FOUND", "UNIMPLEMENTED"]:
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


def phase_profile(torch, model, prompt, batched_steps):
    """One 512-token prefill and one 8-token decode chunk of the served
    model, and ``batched_steps`` (name -> function: one batched paged
    step, and four in the scheduler's pipeline, fetched): wall time (no
    profiler; the median of ``WALL_REPS`` runs, each kept), device kernel
    time by class and the top kernels
    (torch.profiler), and the device's busy share."""
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
    log("profile:", json.dumps(out))
    if not any(v["device_ms"] > 0 for v in out.values()):
        log("profile: torch.profiler recorded no device time")


# -- main --------------------------------------------------------------------


def main():
    import numpy as np
    import torch

    if sys.argv[1:] == ["--child-region"]:
        return child_region(np)
    if sys.argv[1:] == ["--child-server"]:
        return child_server(torch)
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
    phase_profile(torch, model, prompt, batched_steps)
    core.close()

    kernels = []
    # each kernel once per path: the single-stream serve (phase 4, timed
    # at one row), the batched serve (phase 4b; decode timed at the
    # batched shape, flash at the same 512-token prefill), the speculative
    # serve (phase 4c b), the re-admissions of phase 4c's fault rounds
    # and resumes (c, d; flash timed at the 640-token re-admission), and
    # phase 4e's paths: the shm plane (a, b), the attach resumes (c) and
    # the decode leg on server B (d); and phase 4f (a), the gRPC stream
    decode_src = "src/python/tpuserver_torch/csrc/decode_attention.cu"
    flash_src = "src/python/tpuserver_torch/csrc/flash_attention.cu"
    decode_tpu = "src/python/tpuserver/ops/flash.py:263"
    flash_tpu = "src/python/tpuserver/ops/flash.py:139"
    for kname, src, replaces, path, timed_as, counts in (
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
             "decode_attention_batched", grpc_launches)):
        row = rows["timed"][timed_as]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "path": path, "launches": counts[kname],
            "max_abs_err": rows["max_err"][kname],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_live_ms": row.get("library_live_ms")})
    idle = [(k["name"], k["path"]) for k in kernels if not k["launches"]]
    if idle:
        fail("kernels of a path never launched on it: {}".format(idle))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
