"""Shared-memory data-plane benchmark of the port.

    PYTHONPATH=src/python python -m tpuserver_torch.bench_shm_data_plane \\
        [--config tiny] [--dtype bfloat16] [--device cpu] \\
        [--out build/bench_shm_data_plane.json]

The port's counterpart of the JAX package's data-plane benchmark.  It
measures the three deltas the zero-copy generation data plane exists
for, on the port's core, HTTP front end and perf analyzer backends, and
writes BENCH-schema rows (nine, with the JAX tool's keys) to ``--out``:

1. **Unary infer p50** over a real localhost HTTP front end:
   ``identity_fp32`` driven through ``HttpBackend`` with in-band tensors
   against ``system`` and ``cuda`` shared memory, staged by
   ``ShmInferDataManager`` (the JAX tool's ``xla`` mode is ``cuda``
   here).  A shm request moves a descriptor while its tensors sit in the
   region.
2. **Generation TTFT / ITL** over HTTP SSE: in-band JSON prompts and
   per-token tensor events against prompts read from a CUDA region
   (``shm_input_ref``) and a token ring in another one (events shrink to
   slot descriptors).  The server shares the client's process, so the
   region's device memory feeds the prefill with no host copy.
3. **Resume attach against re-prefill**: a disconnected generation
   resumed from its server-owned KV export (``kv_park``: the parked pages
   scatter back, one forced token) against the re-prefill path (``prompt
   + history`` runs again), every cycle's tokens checked against an
   uninterrupted reference, and every resume of the attach mode (none of
   the re-prefill mode) counted as an attached admission by the
   scheduler.  A failed check prints a FATAL line and the run exits 1.

Differences from the JAX tool: the ``cuda`` mode and ``cuda_shm_ring``
metric names; a ``dtype`` key on the generation and resume rows; every
``max_seq`` rounded up to a multiple of 256, the decode kernel's
``block_k`` (the JAX tool's would send every decode step to dense
attention); the resume part always in float32 with TF32 off (bf16
re-prefill is not token-identical at 8B, float32 is); the attached
admission count checked.

One weight tree serves every model the run builds: ``--config``
(``tiny`` at vocab 256 by default, as the JAX tool's) drawn from seed 0
in ``--dtype`` on ``--device`` (the card unless ``cpu``), or the
caller's through ``main(argv, params=)``, whose depth is then the run's;
the resume part serves a float32 copy of it.
"""

import argparse
import contextlib
import gc
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from tpuserver_torch._bench_common import (
    DTYPES,
    default_out,
    device_name,
    serving,
)
from tpuserver_torch.core import InferenceServer, InferRequest
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import default_models, llama
from tpuserver_torch.models.llama_serving import LlamaGenerateModel
from tpuserver_torch.perfanalyzer.client_backend import (
    HttpBackend,
    InProcessBackend,
    ShmInferDataManager,
    shm_input_ref,
)

#: where the rows go without ``--out``: the ignored build directory
DEFAULT_OUT = default_out("bench_shm_data_plane")
#: the ``max_seq`` multiple whose cache the decode kernel tiles (its
#: ``block_k``)
SEQ_MULTIPLE = 256


class ResumeCheckFailed(Exception):
    """A resumed generation's tokens differ from the reference's, or a
    mode's resumes did not take its path (attach or re-prefill)."""


def max_seq_for(prompt_len, max_tokens):
    """The JAX tool's cache length (room for the prompt, the tokens and 8
    more, in 16s), rounded up to a multiple of :data:`SEQ_MULTIPLE`."""
    seq = -(-(prompt_len + max_tokens + 8) // 16) * 16
    return -(-seq // SEQ_MULTIPLE) * SEQ_MULTIPLE


def _dtype_name(cfg):
    return str(cfg.dtype).split(".")[-1]


def p50_us(samples):
    return round(statistics.median(samples) * 1e6, 2)


def bench_unary(rows, iters=150, dim=256, device=None):
    """Unary shm-vs-none over a real localhost HTTP front end (the
    transport whose serialization shm exists to bypass): identity_fp32
    with ``dim x dim`` fp32 tensors (256 KB each way at 256).  In-band
    requests pay binary staging both ways, shm requests move a descriptor
    while the tensors sit in the mapped region; ``cuda`` regions live on
    ``device``."""
    core = InferenceServer(default_models())
    http = HttpServer(core).start()
    nbytes = dim * dim * 4
    rng = np.random.RandomState(0)
    pool = [
        {"INPUT0": rng.rand(dim, dim).astype(np.float32)}
        for _ in range(4)
    ]
    results = {}
    try:
        for mode in ("none", "system", "cuda"):
            backend = HttpBackend(http.url, max_inflight=2)
            shm = None
            try:
                if mode == "none":
                    prepared = backend.prepare("identity_fp32", pool)
                else:
                    shm = ShmInferDataManager(backend, mode, device=device)
                    refs = shm.stage_input_sets(pool)
                    out_refs = shm.stage_outputs(["OUTPUT0"], nbytes + 256)
                    prepared = backend.prepare_shm(
                        "identity_fp32", refs, out_refs)
                for req in prepared:  # first uses outside the window
                    backend.infer(req)
                samples = []
                for i in range(iters):
                    req = prepared[i % len(prepared)]
                    t0 = time.perf_counter()
                    backend.infer(req)
                    samples.append(time.perf_counter() - t0)
                results[mode] = p50_us(samples)
            finally:
                if shm is not None:
                    shm.close()
                backend.close()
    finally:
        http.stop()
        core.close()
    base = results["none"]
    for mode in ("none", "system", "cuda"):
        rows.append({
            "config": "shm_data_plane",
            "metric": "unary_infer_p50_{}".format(mode),
            "value": results[mode],
            "unit": "us",
            "vs_baseline": None,
            "delta_vs_none_pct": (
                None if mode == "none"
                else round(100.0 * (results[mode] - base) / base, 1)),
            "transport": "http",
            "tensor_bytes": nbytes,
            "iters": iters,
        })
    return results


def _drive_stream(backend, inputs, params, take=None):
    """(ttft_s, itls_s, responses) of one generation; ``take`` stops
    after that many responses (a disconnect)."""
    t0 = time.perf_counter()
    ttft = None
    prev = None
    itls = []
    n = 0
    gen = backend.generate_stream("llama_generate", inputs, params)
    for _count in gen:
        now = time.perf_counter()
        if ttft is None:
            ttft = now - t0
        else:
            itls.append(now - prev)
        prev = now
        n += 1
        if take is not None and n >= take:
            gen.close()
            break
    return ttft, itls, n


def bench_generation(rows, serve, streams=10, prompt_len=256,
                     max_tokens=16):
    """Generation TTFT/ITL over the real HTTP SSE transport: in-band JSON
    prompts and per-token tensor events against prompts by reference into
    a CUDA region and the token ring (events shrink to slot descriptors;
    the server shares the client's process, so the region's device memory
    feeds the prefill)."""
    core = InferenceServer([LlamaGenerateModel(
        cfg=serve.cfg, max_seq=max_seq_for(prompt_len, max_tokens),
        max_slots=4, prefix_cache=False, params=serve.params,
        device=serve.device)])
    http = HttpServer(core).start()
    backend = HttpBackend(http.url, max_inflight=2)
    shm = None
    try:
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, 200, size=(prompt_len,)).astype(np.int32)
                   for _ in range(streams)]
        mt = np.array([max_tokens], dtype=np.int32)

        # in-band baseline (stream 0 twice: the first warms the prefill
        # bucket)
        ttfts, all_itls = [], []
        for i, p in enumerate([prompts[0]] + prompts):
            ttft, itls, n = _drive_stream(
                backend, {"PROMPT_IDS": p, "MAX_TOKENS": mt}, {})
            if i > 0:
                ttfts.append(ttft)
                all_itls.extend(itls)
        base_ttft, base_itl = p50_us(ttfts) / 1e3, p50_us(all_itls) / 1e3

        # prompts in a CUDA region, tokens into a ring in another
        shm = ShmInferDataManager(backend, "cuda", device=serve.device)
        nbytes = prompts[0].nbytes
        region, handle = shm.create_region("prompts", nbytes * streams)
        ring_bytes = max_tokens * 8
        ring, _ = shm.create_region("ring", ring_bytes * streams)
        for i, p in enumerate(prompts):
            shm.write(handle, [p], offset=i * nbytes)
        ttfts, all_itls = [], []
        for i, p in enumerate([prompts[0]] + prompts):
            slot = max(0, i - 1)
            ref = shm_input_ref(
                region, nbytes, slot * nbytes, "INT32", p.shape)
            ttft, itls, n = _drive_stream(
                backend, {"PROMPT_IDS": ref, "MAX_TOKENS": mt},
                {"shm_ring_region": ring, "shm_ring_slots": max_tokens,
                 "shm_ring_offset": slot * ring_bytes})
            if i > 0:
                ttfts.append(ttft)
                all_itls.extend(itls)
        shm_ttft, shm_itl = p50_us(ttfts) / 1e3, p50_us(all_itls) / 1e3
    finally:
        if shm is not None:
            shm.close()
        backend.close()
        http.stop()
        core.close()

    for metric, none_v, shm_v in (
            ("generation_ttft_p50", base_ttft, shm_ttft),
            ("generation_itl_p50", base_itl, shm_itl)):
        for mode, value in (("none", none_v), ("cuda_shm_ring", shm_v)):
            rows.append({
                "config": "shm_data_plane",
                "metric": "{}_{}".format(metric, mode),
                "value": round(value, 3),
                "unit": "ms",
                "vs_baseline": None,
                "delta_vs_none_pct": (
                    None if mode == "none"
                    else round(100.0 * (value - none_v) / none_v, 1)),
                "transport": "http_sse",
                "streams": streams,
                "prompt_tokens": prompt_len,
                "max_tokens": max_tokens,
                "dtype": _dtype_name(serve.cfg),
            })


def _reference_tokens(core, prompt, mt):
    """The uninterrupted generation's tokens."""
    ref = []
    for resp in core.infer_stream(InferRequest(
            "llama_generate",
            inputs={"PROMPT_IDS": prompt, "MAX_TOKENS": mt},
            parameters={"generation_id": "ref"})):
        ref.append(int(resp.outputs[0][1][0]))
    return ref


@contextlib.contextmanager
def _tf32_off():
    """Float32 products in full float32 for the block, whatever the
    caller set (TF32 would round them to 10 mantissa bits)."""
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed


def _attach_admissions(model):
    """The scheduler's admissions over an attached KV export so far."""
    return (model.scheduler_stats() or {}).get("attach_admissions", 0)


def bench_resume_attach(rows, serve, prompt_len=448, head=8, max_tokens=24):
    """Resume attach against re-prefill, each cycle's tokens checked
    against the uninterrupted reference and each mode's resumes counted
    by the scheduler's ``attach_admissions`` (:class:`ResumeCheckFailed`
    when either fails).  448-token prompts: long enough that the re-prefill
    outweighs the page scatter even on a toy 2-layer model, whose short
    prefills cost less than the scatter."""
    rng = np.random.RandomState(1)
    prompt = rng.randint(1, 200, size=(prompt_len,)).astype(np.int32)
    mt = np.array([max_tokens], dtype=np.int32)
    max_seq = max_seq_for(prompt_len, max_tokens)

    def fresh_core():
        # prefix_cache off: the re-prefill row measures the re-prefill,
        # not a radix restore of donated pages
        return InferenceServer([LlamaGenerateModel(
            cfg=serve.cfg, max_seq=max_seq, max_slots=2,
            prefix_cache=False, params=serve.params, device=serve.device)])

    core = fresh_core()
    try:
        ref = _reference_tokens(core, prompt, mt)
    finally:
        core.close()
        del core

    results = {}
    cycles = 4
    for mode, kv_park in (("reprefill", False), ("attach", True)):
        gc.collect()
        core = fresh_core()
        try:
            backend = InProcessBackend(core)
            model = core._models["llama_generate"]
            attached = _attach_admissions(model)
            samples = []
            for cycle in range(cycles):
                gid = "g{}".format(cycle)
                params = {"generation_id": gid, "kv_park": kv_park}
                _drive_stream(
                    backend, {"PROMPT_IDS": prompt, "MAX_TOKENS": mt},
                    params, take=head)
                # wait for the reap to park (and export, in attach mode)
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    stats = model.scheduler_stats() or {}
                    if stats.get("replay_entries"):
                        break
                    time.sleep(0.01)
                tokens = []
                t0 = time.perf_counter()
                first_live = None
                for resp in core.infer_stream(InferRequest(
                        "llama_generate",
                        inputs={"PROMPT_IDS": prompt, "MAX_TOKENS": mt},
                        parameters={"resume_generation_id": gid,
                                    "resume_from_seq": 0})):
                    tokens.append(int(resp.outputs[0][1][0]))
                    if len(tokens) == head + 1 and first_live is None:
                        first_live = time.perf_counter() - t0
                if tokens != ref:
                    raise ResumeCheckFailed(
                        "{} resume diverged from the uninterrupted "
                        "reference in cycle {}: {} != {}".format(
                            mode, cycle, tokens, ref))
                if cycle > 0:  # cycle 0 takes the resume path's first uses
                    samples.append(first_live * 1e3)
            attached = _attach_admissions(model) - attached
            if attached != (cycles if kv_park else 0):
                raise ResumeCheckFailed(
                    "{} mode attached {} of its {} resumes".format(
                        mode, attached, cycles))
            results[mode] = round(statistics.median(samples), 2)
        finally:
            core.close()
            del core

    for mode in ("reprefill", "attach"):
        rows.append({
            "config": "shm_data_plane",
            "metric": "resume_first_live_token_{}".format(mode),
            "value": results[mode],
            "unit": "ms",
            "vs_baseline": None,
            "speedup_vs_reprefill": (
                None if mode == "reprefill"
                else round(results["reprefill"] / results["attach"], 2)),
            "prompt_tokens": prompt_len,
            "head_tokens": head,
            "token_identical": True,
            "dtype": _dtype_name(serve.cfg),
        })


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--config", default="tiny",
                    choices=sorted(llama.PRESETS),
                    help="the llama config (default tiny, at vocab 256)")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES),
                    help="the weights' dtype when drawn (default bfloat16)")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu'")
    return ap


def main(argv=None, params=None):
    """Run the three parts and write their rows to ``--out``; returns 0,
    or 1 when a resume diverged.  ``params``: the weights every model
    serves (else drawn)."""
    args = build_parser().parse_args(argv)
    serve = serving(args.config, args.device, params, vocab=256,
                    dtype=DTYPES[args.dtype])
    rows = []
    bench_unary(rows, device=serve.device)
    bench_generation(rows, serve)
    # the resume part serves a float32 copy with TF32 off: a bf16
    # re-prefill is not token-identical to the uninterrupted decode at 8B,
    # and every cycle's tokens are checked
    resume = serve.cast(torch.float32)
    try:
        with _tf32_off():
            bench_resume_attach(rows, resume)
    except ResumeCheckFailed as e:
        print("FATAL: {}".format(e), file=sys.stderr)
        return 1
    finally:
        del resume
        gc.collect()

    payload = {
        "n": 8,
        "cmd": "python -m tpuserver_torch.bench_shm_data_plane " + " ".join(
            argv if argv is not None else sys.argv[1:]),
        "rc": 0,
        "note": "shared-memory data plane on the PyTorch port: unary p50 "
                "in-band vs system vs CUDA shm over HTTP, generation "
                "TTFT/ITL over HTTP SSE in-band vs CUDA-region prompts and "
                "the token ring, and resume attach vs re-prefill from the "
                "server-owned KV export; llama {} ({} layers) in {} on {}, "
                "the resume part in float32 (TF32 off); token identity is "
                "the run's, the times its device's".format(
                    args.config, serve.cfg.n_layers, _dtype_name(serve.cfg),
                    device_name(serve.device)),
        "rows": rows,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(payload, fh, indent=1)
        fh.write("\n")
    print(json.dumps(payload, indent=1))
    print("wrote {} rows to {}".format(len(rows), args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
