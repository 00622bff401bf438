"""Speculative decoding benchmark of the port.

    PYTHONPATH=src/python python -m tpuserver_torch.bench_speculative \\
        [--config tiny] [--device cpu] [--out build/bench_speculative.json]

The port's counterpart of the JAX package's speculative benchmark, on
the port's scheduler (``DecodeScheduler`` over
``llama.make_scheduler_fns``, ``max_seq`` 128), its core and its perf
analyzer.  Writes BENCH-schema rows (five, with the JAX tool's keys) to
``--out``:

1. **Repetitive decode.**  One hot prompt the scheduler has served
   before, re-requested by 8 concurrent clients: the radix tree holds
   the exact continuation from the first service, so the drafter
   proposes it verbatim and accepted tokens per step approach the draft
   budget; per-stream tokens/s of ``spec_tokens=4`` beside
   ``spec_tokens=0`` on the identical (checked) streams.
2. **Agentic regenerate.**  The same prompt re-submitted with a larger
   budget re-decodes its first generation token for token, which the
   tree already holds from the first run's retirement.
3. **The perf analyzer's acceptance column.**  One generation-profiler
   window against a speculating in-process model (``max_seq`` 96, which
   neither 256 nor 128 tiles: that model attends densely, as JAX's
   does), the ``accept/step`` / ``spec-hit%`` columns end to end.

A config whose prefill runs the flash kernel (every preset but ``tiny``)
gets no radix tree from the scheduler (its ``span_safe`` rule, JAX's as
well): its drafts then come from each stream's own prompt and history.

Every speculative stream is checked token for token against its plain
twin before its timing is reported.  One weight tree serves every
scheduler and model the run builds: ``--config`` (``tiny`` at vocab 512
by default, as the JAX tool's) drawn from seed 0 on ``--device`` (the
card unless ``cpu``), or the caller's through ``main(argv, params=)``,
whose dtype and depth are then the run's.
"""

import argparse
import json
import os
import statistics
import sys
import threading
import time

import numpy as np

from tpuserver_torch._bench_common import default_out, device_name, serving
from tpuserver_torch.core import InferenceServer
from tpuserver_torch.models import llama
from tpuserver_torch.models.llama_serving import LlamaGenerateModel
from tpuserver_torch.perfanalyzer.client_backend import create_backend
from tpuserver_torch.perfanalyzer.generation import GenerationProfiler
from tpuserver_torch.scheduler import DecodeScheduler

#: where the rows go without ``--out``: the ignored build directory
DEFAULT_OUT = default_out("bench_speculative")

REPETITIVE = [7, 9] * 6
AGENTIC = [12, 34, 56, 78, 11, 22, 33, 44, 55, 66, 77, 88, 99, 111,
           222, 333]
MAX_SEQ = 128


def _build(spec_tokens, slots=2, serve=None):
    fns = llama.make_scheduler_fns(serve.cfg, MAX_SEQ, max_slots=slots,
                                   device=serve.device)
    return DecodeScheduler(fns, serve.params, slots, MAX_SEQ,
                           spec_tokens=spec_tokens)


def _run(sched, prompt, n):
    t0 = time.perf_counter()
    toks = [t for t, _ in sched.submit(np.asarray(prompt, np.int32), n)]
    return toks, time.perf_counter() - t0


def _run_concurrent(sched, prompt, n, streams):
    """``streams`` clients submit the same prompt at once; returns
    (per-stream token lists, wall seconds)."""
    outs = [None] * streams

    def worker(i):
        outs[i] = [
            t for t, _ in sched.submit(np.asarray(prompt, np.int32), n)]

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(streams)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs, time.perf_counter() - t0


def _check_identity(ok):
    if not ok:
        raise AssertionError("token identity broken")


def bench_repetitive(rows, serve):
    streams = 8
    # prompt(12) + 52 = 64 tokens = 4 full pages: the first service
    # donates the WHOLE stream to the radix tree (donation is
    # page-granular), so re-service drafts have exact coverage
    n = 52
    plain = _build(0, slots=streams, serve=serve)
    spec = _build(4, slots=streams, serve=serve)
    try:
        # first uses land outside the measurement: a same-bucket
        # repetitive warm-up prompt runs every path (the prefill bucket,
        # the plain step and the spec verify step, which its first draft
        # fires)
        warm = [21, 23] * 6
        _run(plain, warm, 16)
        _run(spec, warm, 16)
        # first service of the hot prompt: retirement donates
        # prompt + output to each scheduler's radix tree
        ref, _ = _run(plain, REPETITIVE, n)
        got, _ = _run(spec, REPETITIVE, n)
        _check_identity(got == ref and len(ref) == n)
        before = spec.stats()
        t_plain, t_spec = [], []
        for _trial in range(3):
            outs, dt = _run_concurrent(plain, REPETITIVE, n, streams)
            _check_identity(all(o == ref for o in outs))
            t_plain.append(dt)
            outs, dt = _run_concurrent(spec, REPETITIVE, n, streams)
            _check_identity(all(o == ref for o in outs))
            t_spec.append(dt)
        stats = spec.stats()
    finally:
        plain.close()
        spec.close()
    steps = stats["spec_steps"] - before["spec_steps"]
    accepted = stats["spec_accepted"] - before["spec_accepted"]
    accept_per_step = (steps + accepted) / steps if steps else 0.0
    tps_plain = n / statistics.median(t_plain)
    tps_spec = n / statistics.median(t_spec)
    print("repetitive hot prompt, {} concurrent streams x{} tokens: "
          "accept/step {:.2f}, per-stream {:.1f} -> {:.1f} tok/s "
          "({:.2f}x), streams identical".format(
              streams, n, accept_per_step, tps_plain, tps_spec,
              tps_spec / tps_plain))
    rows.append({
        "config": "speculative", "metric": "accept_per_step_repetitive",
        "value": round(accept_per_step, 3), "unit": "tokens/step",
        "vs_baseline": 1.0, "spec_tokens": 4, "gen_tokens": n,
        "streams": streams,
        "rollbacks": stats["spec_rollbacks"] - before["spec_rollbacks"]})
    rows.append({
        "config": "speculative", "metric": "stream_tokens_per_sec",
        "value": round(tps_spec, 1), "unit": "tokens/sec",
        "vs_baseline": round(tps_plain, 1),
        "speedup": round(tps_spec / tps_plain, 2),
        "streams": streams, "trials": 3,
        "token_identical": True})
    rows.append({
        # scheduler iterations (each one step call and one host round)
        # per emitted token
        "config": "speculative", "metric": "steps_per_token_repetitive",
        "value": round(1.0 / accept_per_step, 3) if accept_per_step
        else None,
        "unit": "steps/token", "vs_baseline": 1.0})


def bench_agentic_regenerate(rows, serve):
    spec = _build(4, serve=serve)
    plain = _build(0, serve=serve)
    try:
        warm = [21, 23] * 8  # same 16-token prefill bucket, drafts fire
        _run(spec, warm, 16)
        _run(plain, warm, 16)
        # turn 1: cold generation; retirement donates prompt+output
        # to the radix tree
        _run(spec, AGENTIC, 20)
        _run(plain, AGENTIC, 20)
        before = spec.stats()
        # turn 2: the regenerate/extend shape — greedy determinism
        # re-decodes turn 1's tokens, which the tree now drafts
        ref, t_plain = _run(plain, AGENTIC, 32)
        got, t_spec = _run(spec, AGENTIC, 32)
        stats = spec.stats()
    finally:
        spec.close()
        plain.close()
    _check_identity(got == ref)
    steps = stats["spec_steps"] - before["spec_steps"]
    accepted = stats["spec_accepted"] - before["spec_accepted"]
    proposed = stats["spec_proposed"] - before["spec_proposed"]
    accept_per_step = (steps + accepted) / steps if steps else 0.0
    print("agentic regenerate: accept/step {:.2f} ({}/{} drafts "
          "accepted), {:.1f} -> {:.1f} tok/s".format(
              accept_per_step, accepted, proposed, 32 / t_plain,
              32 / t_spec))
    rows.append({
        "config": "speculative", "metric": "accept_per_step_regenerate",
        "value": round(accept_per_step, 3), "unit": "tokens/step",
        "vs_baseline": 1.0, "spec_tokens": 4,
        "draft_hit_pct": round(100.0 * accepted / proposed, 1)
        if proposed else None,
        "tokens_per_sec": round(32 / t_spec, 1),
        "baseline_tokens_per_sec": round(32 / t_plain, 1)})


def bench_perfanalyzer_column(rows, serve):
    """The acceptance column end to end: the generation profiler against
    a speculating in-process model reports spec_accept_per_step."""
    core = InferenceServer([LlamaGenerateModel(
        cfg=serve.cfg, max_seq=96, max_slots=4, spec_tokens=4,
        params=serve.params, device=serve.device)])
    backend = None
    try:
        pool = [{
            "PROMPT_IDS": np.asarray(REPETITIVE, np.int32),
            "MAX_TOKENS": np.array([24], np.int32),
        }]
        backend = create_backend("inprocess", core=core, max_inflight=2)
        profiler = GenerationProfiler(
            backend, "llama_generate", pool,
            measurement_interval_s=2.0, max_trials=3, warmup_s=0.5)
        result = profiler.profile_level(2)
        profiler.stop()
    finally:
        if backend is not None:
            backend.close()
        core.close()
    print("perfanalyzer columns: accept/step {} spec-hit% {} at "
          "{:.0f} tok/s".format(
              result.get("spec_accept_per_step"),
              result.get("spec_hit_pct"), result["throughput"]))
    rows.append({
        "config": "speculative", "metric": "perfanalyzer_accept_per_step",
        "value": round(result.get("spec_accept_per_step") or 0.0, 3),
        "unit": "tokens/step", "vs_baseline": 1.0,
        "spec_hit_pct": round(result.get("spec_hit_pct") or 0.0, 1),
        "tokens_per_sec": round(result["throughput"], 1),
        "streams": 2})


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--config", default="tiny",
                    choices=sorted(llama.PRESETS),
                    help="the llama config (default tiny, at vocab 512)")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu'")
    return ap


def main(argv=None, params=None):
    """Run the three parts and write their rows to ``--out``; returns 0.
    ``params``: the weights every scheduler serves (else drawn)."""
    args = build_parser().parse_args(argv)
    serve = serving(args.config, args.device, params)
    rows = []
    bench_repetitive(rows, serve)
    bench_agentic_regenerate(rows, serve)
    bench_perfanalyzer_column(rows, serve)

    payload = {
        "n": 11,
        "cmd": "python -m tpuserver_torch.bench_speculative " + " ".join(
            argv if argv is not None else sys.argv[1:]),
        "rc": 0,
        "note": "speculative decoding fed by the radix cache on the "
                "PyTorch port: llama {} ({} layers) in {} on {}; "
                "acceptance rates and token identity are the run's, the "
                "tokens/s its device's".format(
                    args.config, serve.cfg.n_layers,
                    str(serve.cfg.dtype).split(".")[-1],
                    device_name(serve.device)),
        "rows": rows,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(payload, fh, indent=1)
        fh.write("\n")
    print("wrote {} rows to {}".format(len(rows), args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
