"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. device: require CUDA, print the card's name and power limit;
2. build: compile the port's CUDA kernels from ``src/python/tpuserver_torch/
   csrc`` (into ``build/tpuserver_torch``), print the build seconds;
3. kernels: each kernel against its plain PyTorch version on the card at
   Llama-3-8B shapes (flash at every prefill length phases 4 and 4b give
   it), with the stated tolerances (decode also against the
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
5. model check: the 512-token prompt's last-position prefill logits
   through the kernels against the same model through the plain
   attention versions, and the greedy tokens of both;
6. profile: one prefill, one decode chunk and one batched paged step (8
   live rows near length 600) under ``torch.profiler``, device time by
   kernel class (the page gather apart) beside the wall time.

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
# phase 6's wall-time samples per step
WALL_REPS = 5


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
    # 512-token prompt and each tileable admission of phase 4b
    prefill_ts = sorted({512, *_flash_admissions(
        llama, llama.llama3_8b(), s, BATCHED_PROMPT_LENGTHS)})
    for b, t, causal, dtype, hh, kk, dd in (
            *((1, t, True, bf16, h, hkv, d) for t in prefill_ts),
            (1, 512, False, bf16, h, hkv, d),
            (1, 2048, True, bf16, h, hkv, d),
            (1, 2048, False, bf16, h, hkv, d),
            (2, 256, True, bf16, 16, 8, 64)):  # Llama-3.2-1B head dim
        main = (t == 512 and causal and dtype == bf16)
        row = _flash_case(torch, F, fl, dev, gen, b, t, hh, kk, dd, causal,
                          dtype, main or (t == 2048 and causal), flush)
        row["kernel"] = "flash_attention"
        rows.append(row)
        if main:
            timed["flash_attention"] = row
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
    return {"timed": timed, "max_err": max_err}


# -- phase 4: serve ----------------------------------------------------------


def _stream(port, prompt, max_tokens):
    """POST one /generate_stream request; returns (tokens, ttft_s,
    decode tokens/s, saw_final, the events' ``id:`` values)."""
    import http.client

    body = json.dumps({"inputs": [
        {"name": "PROMPT_IDS", "datatype": "INT32", "shape": [len(prompt)],
         "data": [int(t) for t in prompt]},
        {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
         "data": [max_tokens]}]})
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.monotonic()
    conn.request("POST", "/v2/models/llama_generate/generate_stream", body,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        fail("generate_stream answered {}: {}".format(
            resp.status, resp.read()[:500]))
    tokens, stamps, final, ids = [], [], False, []
    for raw in resp:
        line = raw.decode("utf-8").strip()
        if line.startswith("id: "):
            ids.append(line[len("id: "):])
        if not line.startswith("data: "):
            continue
        event = json.loads(line[len("data: "):])
        if event.get("final"):
            final = True
            break
        if "error" in event:
            fail("in-band stream error: {}".format(event["error"]))
        out = {o["name"]: o["data"] for o in event["outputs"]}
        tokens.append(int(out["TOKEN"][0]))
        stamps.append(time.monotonic())
    conn.close()
    ttft = stamps[0] - t0 if stamps else float("nan")
    rate = ((len(stamps) - 1) / (stamps[-1] - stamps[0])
            if len(stamps) > 1 else float("nan"))
    return tokens, ttft, rate, final, ids


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
    Returns (launch counts, the batched step phase 6 profiles)."""
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
                      "batched_steps_8_x4_pipelined": pipelined_steps}


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

    name, smi = phase_device(torch)
    log("nvidia-smi:", smi)
    phase_build()
    rows = phase_kernels(torch)
    model, core, prompt, launches, tokens, rates = phase_serve(torch, np)
    batched_launches, batched_steps = phase_serve_batched(
        torch, np, model, prompt, tokens, rates)
    phase_model_check(torch, model, prompt)
    phase_profile(torch, model, prompt, batched_steps)
    core.close()

    kernels = []
    # each kernel once per path: the single-stream serve (phase 4, timed
    # at one row) and the batched serve (phase 4b; decode timed at the
    # batched shape, flash at the same 512-token prefill)
    for kname, src, replaces, path, timed_as, counts in (
            ("flash_attention", "src/python/tpuserver_torch/csrc/"
             "flash_attention.cu", "src/python/tpuserver/ops/flash.py:139",
             "serve", "flash_attention", launches),
            ("decode_attention", "src/python/tpuserver_torch/csrc/"
             "decode_attention.cu", "src/python/tpuserver/ops/flash.py:263",
             "serve", "decode_attention", launches),
            ("flash_attention", "src/python/tpuserver_torch/csrc/"
             "flash_attention.cu", "src/python/tpuserver/ops/flash.py:139",
             "serve_batched", "flash_attention", batched_launches),
            ("decode_attention", "src/python/tpuserver_torch/csrc/"
             "decode_attention.cu", "src/python/tpuserver/ops/flash.py:263",
             "serve_batched", "decode_attention_batched",
             batched_launches)):
        row = rows["timed"][timed_as]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "path": path, "launches": counts[kname],
            "max_abs_err": rows["max_err"][kname],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_live_ms": row.get("library_live_ms")})
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
