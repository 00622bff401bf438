"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. device: require CUDA, print the card's name and power limit;
2. build: compile the port's CUDA kernels from ``src/python/tpuserver_torch/
   csrc`` (into ``build/tpuserver_torch``), print the build seconds;
3. kernels: each kernel against its plain PyTorch version on the card at
   Llama-3-8B shapes, with the stated tolerances (decode also against the
   plain model of its split-K), and timed beside its bound, its plain
   version and one PyTorch library call (for single-row decode also SDPA
   over the live prefix alone);
4. serve: ``tpuserver_torch``'s server and HTTP front end serving
   ``llama3_8b`` (full width and depth, random weights from a seed,
   ``max_seq`` 4096) three ``/generate_stream`` requests over a socket,
   with the kernels' launch counts read around them;
5. model check: the 512-token prompt's last-position prefill logits
   through the kernels against the same model through the plain
   attention versions, and the greedy tokens of both;
6. profile: one prefill and one decode chunk under ``torch.profiler``,
   device time by kernel class beside the wall time.

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
        if b == 1:
            # SDPA over the live prefix only: the masked call above reads
            # the whole padded cache
            kl, vl = ke[:, :, :lengths[0]], ve[:, :, :lengths[0]]
            row["library_live_ms"] = _time_ms(
                torch, lambda: F.scaled_dot_product_attention(qt, kl, vl),
                200, flush)
        isz = q.element_size()
        live = sum(lengths)
        nbytes = (2 * live * hkv * d + 2 * b * h * d) * isz + 4 * b
        row["bound_ms"], row["bound_by"] = _bound_ms(
            nbytes, 4 * live * h * d, BF16_OPS_PER_S
            if dtype == torch.bfloat16 else F32_OPS_PER_S)
    return row


def phase_kernels(torch):
    """Every kernel against its plain version; returns the timed rows of
    the main path's shapes and the largest error, by kernel name."""
    import torch.nn.functional as F

    from tpuserver_torch.ops import flash as fl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # Llama-3-8B attention geometry
    h, hkv, d, s = 32, 8, 128, 4096
    timed = {}
    rows = []
    for b, t, causal, dtype, hh, kk, dd in (
            (1, 512, True, bf16, h, hkv, d),
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
            ((40, 17), 64, f32, 6, 2, 16)):
        main = lengths == (576,)
        row = _decode_case(torch, F, fl, dev, gen, lengths, ss, hh, kk, dd,
                           dtype, main or lengths == (4096,), flush)
        row["kernel"] = "decode_attention"
        rows.append(row)
        if main:
            timed["decode_attention"] = row
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
    decode tokens/s, saw_final)."""
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
    tokens, stamps, final = [], [], False
    for raw in resp:
        line = raw.decode("utf-8").strip()
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
    return tokens, ttft, rate, final


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
    runs = []
    try:
        fl.reset_launch_counts()
        for name, prompt, n in (("flash_prefill", long_prompt, 64),
                                ("dense_prefill", short_prompt, 32),
                                ("repeat", long_prompt, 64)):
            tokens, ttft, rate, final = _stream(http.port, prompt, n)
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
    return model, core, long_prompt, launches


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
    if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "matmul")):
        return "matmul"
    return "other"


def phase_profile(torch, model, prompt):
    """One 512-token prefill and one 8-token decode chunk of the served
    model: wall time (no profiler), device kernel time by class and the
    top kernels (torch.profiler), and the device's busy share."""
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
        }
        for name, fn in steps.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
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
                "wall_ms": wall_ms, "device_ms": device_ms,
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
    model, core, prompt, launches = phase_serve(torch, np)
    phase_model_check(torch, model, prompt)
    phase_profile(torch, model, prompt)
    core.close()

    kernels = []
    for kname, src, replaces in (
            ("flash_attention", "src/python/tpuserver_torch/csrc/"
             "flash_attention.cu", "src/python/tpuserver/ops/flash.py:139"),
            ("decode_attention", "src/python/tpuserver_torch/csrc/"
             "decode_attention.cu", "src/python/tpuserver/ops/flash.py:263")):
        row = rows["timed"][kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
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
