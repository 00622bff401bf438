"""Paged-KV / radix-prefix-cache benchmark of the port.

    PYTHONPATH=src/python python -m tpuserver_torch.bench_prefix_cache \\
        [--config tiny] [--dtype bfloat16] [--attn kernel|dense] \\
        [--device cpu] [--skip-fleet] [--out build/bench_prefix_cache.json]

The port's counterpart of the JAX package's prefix-cache benchmark, on
the port's scheduler, core, HTTP server, fleet router and perf analyzer.
It writes BENCH-schema rows, with the JAX tool's keys, to ``--out``:

1. **Warm prefill against cold prefill.**  Time to first token of a
   256-token prompt against a scheduler whose radix cache already holds
   the prompt's pages, beside the same prompt against a cold cache: the
   warm admission prefills only its unique suffix (240 of its 256 tokens
   come from the cache, a 93.8% hit rate).
2. **Admission bounded by pages, not slots.**  16 concurrent short
   streams decode at once over a page pool that holds four full-length
   sequences.
3. **Affinity routing against hash-blind routing.**  The perf analyzer's
   generation profiler (its ``prefix_hit_pct``, window-diffed from the
   router's fleet-aggregated ``/metrics``) drives 8 shared prefixes
   through two replicas whose page pools cannot each hold every prefix,
   once with the router's prefix-affinity bonus and once without.  The
   router's fleet counters must equal the replicas' own sum at the end of
   each run, so a fleet view that loses a replica's counters fails the
   run instead of writing a wrong rate.  Which arm wins is printed, not
   checked: at this size the two stay within a few points of each other.

Plus the headline: one ``python -m tpuserver_torch.perf_analyzer -m
simple --backend inprocess`` process, its per-request p50 and p99.

The radix cache runs only where the scheduler's ``span_safe`` allows
shared-prefix prefill, which the flash-kernel presets do not (``--attn
kernel``, every preset but ``tiny``): there the warm part would count no
hit and no miss, so the run stops before it builds anything, names
``--attn dense`` and exits 2.  A failed check prints a ``FATAL:`` line
and exits 1.

One weight tree serves every scheduler and model the run builds:
``--config`` (``tiny`` at vocab 512 by default, as the JAX tool's) drawn
from seed 0 in ``--dtype`` on ``--device`` (the card unless ``cpu``), or
the caller's through ``main(argv, params=)``, whose dtype and depth are
then the run's.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

from tpuserver_torch._bench_common import (
    DTYPES,
    default_out,
    device_name,
    run_config,
    serving,
)
from tpuserver_torch.core import InferenceServer
from tpuserver_torch.fleet_router import FleetRouter
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import llama
from tpuserver_torch.models.llama_serving import LlamaGenerateModel
from tpuserver_torch.perfanalyzer.client_backend import create_backend
from tpuserver_torch.perfanalyzer.generation import GenerationProfiler
from tpuserver_torch.scheduler import DecodeScheduler

#: where the rows go without ``--out``: the ignored build directory
DEFAULT_OUT = default_out("bench_prefix_cache")
#: the directory that holds the package: the headline process's PYTHONPATH
SRC_PYTHON = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WARM_MAX_SEQ = 512
PROMPT_LEN = 256
CAPACITY_MAX_SEQ = 128
PAGE = 16
OLD_BOUND = 4  # full-length sequences the capacity part's memory holds
STREAMS_TARGET = 16
# the fleet part: prefix 64 + suffix 8 + 8 tokens fit in 96 (JAX's
# max_seq); 128 is the least length the decode kernel tiles
FLEET_MAX_SEQ = 128
FLEET_PAGES = 32
# the generation profiler's windows (JAX's)
FLEET_WINDOW_S = 1.5
FLEET_TRIALS = 3
FLEET_WARMUP_S = 0.5
#: seconds the router may take to see both replicas, and the replicas to
#: finish their streams after the profiler stopped
READY_S = 60.0


class CheckFailed(RuntimeError):
    """A check of the run failed: ``main`` prints it and exits 1."""


def _ttft(sched, prompt, max_tokens=4):
    t0 = time.monotonic()
    stream = sched.submit(np.asarray(prompt, np.int32), max_tokens)
    next(stream)
    ttft = time.monotonic() - t0
    for _ in stream:
        pass
    return ttft


def bench_warm_vs_cold_prefill(rows, serve):
    fns = llama.make_scheduler_fns(serve.cfg, WARM_MAX_SEQ, max_slots=2,
                                   device=serve.device)
    sched = DecodeScheduler(fns, serve.params, 2, WARM_MAX_SEQ)
    rng = np.random.RandomState(0)
    target = rng.randint(1, 500, size=(PROMPT_LEN,)).astype(np.int32)
    warmup = rng.randint(1, 500, size=(PROMPT_LEN,)).astype(np.int32)
    try:
        # the first prefill of this length (and everything else) out of
        # the measurement, with a DIFFERENT prompt (no cache overlap)
        _ttft(sched, warmup)
        cold = _ttft(sched, target)  # cache miss: full-prompt prefill
        before = sched.stats()
        warm = [_ttft(sched, target) for _ in range(8)]
        stats = sched.stats()
    finally:
        sched.close()
    # hit rate OF THE WARM ADMISSIONS (delta over the warm phase: the
    # warmup and cold prefills are misses by construction)
    dh = stats["prefix_hits"] - before["prefix_hits"]
    dm = stats["prefix_misses"] - before["prefix_misses"]
    if dh + dm == 0:
        raise CheckFailed("the warm admissions counted no prefix hit and "
                          "no miss: the radix cache is off")
    hit_rate = 100.0 * dh / (dh + dm)
    warm_ms = statistics.median(warm) * 1e3
    cold_ms = cold * 1e3
    print("prefill TTFT: cold {:.1f} ms -> warm {:.1f} ms "
          "({:.2f}x) at {:.1f}% radix hit rate".format(
              cold_ms, warm_ms, cold_ms / warm_ms, hit_rate))
    rows.append({
        "config": "paged_kv", "metric": "prefill_ttft_cold_256tok",
        "value": round(cold_ms, 2), "unit": "ms", "vs_baseline": None,
        "prompt_tokens": PROMPT_LEN})
    rows.append({
        "config": "paged_kv", "metric": "prefill_ttft_warm_256tok",
        "value": round(warm_ms, 2), "unit": "ms", "vs_baseline": None,
        "prompt_tokens": PROMPT_LEN,
        "speedup_vs_cold": round(cold_ms / warm_ms, 2),
        "radix_hit_rate_pct": round(hit_rate, 1)})


def bench_capacity_beyond_slots(rows, serve):
    ppseq = CAPACITY_MAX_SEQ // PAGE
    fns = llama.make_scheduler_fns(
        serve.cfg, CAPACITY_MAX_SEQ, max_slots=STREAMS_TARGET,
        kv_pages=OLD_BOUND * ppseq, device=serve.device)
    sched = DecodeScheduler(fns, serve.params, STREAMS_TARGET,
                            CAPACITY_MAX_SEQ, prefix_cache=False)
    try:
        streams = [
            sched.submit(np.array([i + 1, i + 2, i + 3], np.int32), 16)
            for i in range(STREAMS_TARGET)
        ]
        for s in streams:
            next(s)  # every stream admitted and decoding
        live = sched.stats()["live_streams"]
        for s in streams:
            for _ in s:
                pass
    finally:
        sched.close()
    if live != STREAMS_TARGET:
        raise CheckFailed("{} streams live at once, want {}".format(
            live, STREAMS_TARGET))
    print("concurrent streams at the memory of {} full-length slots: "
          "{}".format(OLD_BOUND, live))
    rows.append({
        "config": "paged_kv", "metric": "concurrent_streams_equal_memory",
        "value": live, "unit": "streams", "vs_baseline": None,
        "old_max_slots_bound": OLD_BOUND,
        "kv_pages": OLD_BOUND * ppseq, "page_size": PAGE})


def _wait(what, predicate):
    deadline = time.monotonic() + READY_S
    while not predicate():
        if time.monotonic() > deadline:
            raise CheckFailed("{} within {} s".format(what, READY_S))
        time.sleep(0.02)


def _replica_counters(models):
    """The replicas' own prefix counters, summed: ``{"hits", "misses"}``."""
    stats = [m.scheduler_stats() or {} for m in models]
    return {"hits": sum(s.get("prefix_hits", 0) for s in stats),
            "misses": sum(s.get("prefix_misses", 0) for s in stats)}


def _fleet_hit_rate(affinity_bonus, serve, groups=8, suffixes=4):
    """One 2-replica fleet + router run through the perfanalyzer
    generation profiler; returns its result, with the router's fleet
    prefix counters (``fleet_counters``) and the replicas' own sum
    (``replica_counters``) read once every stream has ended."""
    # per-replica pool: 32 pages.  ~4 in-flight streams pin ~10-20; the
    # 8 prefix groups' cached pages (5 each) need 40: one replica holds
    # its HALF of the groups warm (4x5=20), but nowhere near all 8:
    # hash-blind duplication LRU-thrashes, affinity partitioning does not
    models = [
        LlamaGenerateModel(cfg=serve.cfg, max_seq=FLEET_MAX_SEQ, max_slots=4,
                           kv_pages=FLEET_PAGES, params=serve.params,
                           device=serve.device)
        for _ in range(2)
    ]
    cores = [InferenceServer([m]) for m in models]
    for core in cores:
        core.warmup()
    frontends = [HttpServer(core).start() for core in cores]
    urls = [f.url for f in frontends]
    router = FleetRouter(urls, probe_interval_s=0.1,
                         affinity_bonus=affinity_bonus).start()
    backend = None
    try:
        _wait("the router did not see both replicas routable",
              lambda: all(r["eligible"]
                          for r in router.stats()["replicas"]))
        rng = np.random.RandomState(42)
        prefixes = [rng.randint(1, 500, size=(64,)).astype(np.int32)
                    for _ in range(groups)]
        pool = []
        for g in range(groups):
            for s in range(suffixes):
                suffix = np.random.RandomState(
                    100 * g + s).randint(1, 500, size=(8,)).astype(
                        np.int32)
                pool.append({
                    "PROMPT_IDS": np.concatenate([prefixes[g], suffix]),
                    "MAX_TOKENS": np.array([8], np.int32),
                })
        backend = create_backend("http", url=router.url, max_inflight=4)
        profiler = GenerationProfiler(
            backend, "llama_generate", pool,
            measurement_interval_s=FLEET_WINDOW_S, max_trials=FLEET_TRIALS,
            warmup_s=FLEET_WARMUP_S)
        result = profiler.profile_level(4)
        profiler.stop()
        _wait("the replicas still held streams after the profiler stopped",
              lambda: not any(
                  (m.scheduler_stats() or {}).get("live_streams")
                  for m in models))
        result["fleet_counters"] = backend.prefix_cache_snapshot()
        result["replica_counters"] = _replica_counters(models)
        return result
    finally:
        if backend is not None:
            backend.close()
        router.stop()
        for f in frontends:
            f.stop()
        for c in cores:
            c.close()


def _checked_hit_rate(name, affinity_bonus, serve):
    """``_fleet_hit_rate``, failing unless the router's fleet counters are
    the replicas' sum and the window counted prefix tokens."""
    res = _fleet_hit_rate(affinity_bonus, serve)
    if res["fleet_counters"] != res["replica_counters"]:
        raise CheckFailed(
            "{}: the router's fleet prefix counters {} are not the "
            "replicas' sum {}".format(name, res["fleet_counters"],
                                      res["replica_counters"]))
    if res.get("prefix_hit_pct") is None:
        raise CheckFailed("{}: no prefix hit rate (counters {})".format(
            name, res["fleet_counters"]))
    return res


def bench_affinity_vs_blind(rows, serve):
    affine = _checked_hit_rate("affinity", 2.0, serve)
    blind = _checked_hit_rate("hash-blind", 0.0, serve)
    print("fleet prefix-cache hit rate: affinity {:.1f}% vs "
          "hash-blind {:.1f}% (tokens/sec {:.0f} vs {:.0f}); affinity "
          "{} hash-blind".format(
              affine["prefix_hit_pct"], blind["prefix_hit_pct"],
              affine["throughput"], blind["throughput"],
              "above" if affine["prefix_hit_pct"] > blind["prefix_hit_pct"]
              else "not above"))
    for name, res in (("affinity", affine), ("hash_blind", blind)):
        rows.append({
            "config": "fleet_prefix_cache",
            "metric": "hit_rate_{}".format(name),
            "value": round(res["prefix_hit_pct"], 1),
            "unit": "percent", "vs_baseline": None,
            "tokens_per_sec": round(res["throughput"], 1),
            "ttft_p50_ms": round(res["ttft_p50_ms"] or 0.0, 2),
            "replicas": 2, "prefix_groups": 8,
            "kv_pages_per_replica": FLEET_PAGES,
            "prefix_cache_hits": res["prefix_cache_hits"],
            "prefix_cache_misses": res["prefix_cache_misses"]})


def bench_simple_headline(rows, device=None):
    """The simple model's in-process per-request latency, from one
    ``python -m tpuserver_torch.perf_analyzer`` process on ``device``
    (None: the card)."""
    argv = [sys.executable, "-m", "tpuserver_torch.perf_analyzer", "-m",
            "simple", "--backend", "inprocess", "--concurrency-range", "1",
            "--measurement-interval", "2000"]
    if device is not None:
        argv += ["--device", str(device)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC_PYTHON, env.get("PYTHONPATH")) if p)
    result = subprocess.run(argv, capture_output=True, text=True,
                            timeout=300, env=env)
    if result.returncode != 0:
        print("headline run failed:\n" + result.stderr, file=sys.stderr)
        return
    row = next(json.loads(line) for line in result.stdout.splitlines()
               if line.startswith('{"'))
    print("simple inprocess: {:.0f} infer/sec, p50 {:.1f} us".format(
        row["value"], row["p50_usec"]))
    rows.append({
        "config": 1, "metric": "simple_inprocess_headline",
        "value": row["value"], "unit": "infer/sec",
        "vs_baseline": None, "p50_usec": row["p50_usec"],
        "p99_usec": row["p99_usec"],
        "note": "the port's in-process core, one request in flight"})


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-fleet", action="store_true",
                    help="skip the 2-replica fleet A/B (the slow part)")
    ap.add_argument("--config", default="tiny",
                    choices=sorted(llama.PRESETS),
                    help="the llama config (default tiny, at vocab 512)")
    ap.add_argument("--attn", default=None, choices=("kernel", "dense"),
                    help="prefill attention (default: the config's)")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES),
                    help="the weights' dtype when drawn (default bfloat16)")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu'")
    return ap


def main(argv=None, params=None):
    """Run the parts and write their rows to ``--out``; returns 0, 1 when
    a check failed, or 2 when the run's prefill attention keeps the radix
    cache off.  ``params``: the weights every scheduler and model serves
    (else drawn)."""
    args = build_parser().parse_args(argv)
    cfg = run_config(args.config, attn=args.attn)
    if not llama.make_scheduler_fns(cfg, WARM_MAX_SEQ, 2,
                                    device=args.device)["span_safe"]:
        print("{} prefills with attn_impl {!r}, where the scheduler keeps "
              "the radix prefix cache off (span_safe is false): the warm "
              "part would count no hit; run it with --attn dense".format(
                  args.config, cfg.attn_impl), file=sys.stderr)
        return 2
    serve = serving(args.config, args.device, params, vocab=512,
                    dtype=DTYPES[args.dtype], attn=args.attn)

    rows = []
    try:
        bench_warm_vs_cold_prefill(rows, serve)
        bench_capacity_beyond_slots(rows, serve)
        if not args.skip_fleet:
            bench_affinity_vs_blind(rows, serve)
    except CheckFailed as e:
        print("FATAL: {}".format(e), file=sys.stderr)
        return 1
    bench_simple_headline(rows, args.device)

    payload = {
        "n": 7,
        "cmd": "python -m tpuserver_torch.bench_prefix_cache " + " ".join(
            argv if argv is not None else sys.argv[1:]),
        "rc": 0,
        "note": "paged KV + radix prefix cache + affinity routing on the "
                "PyTorch port: llama {} ({} layers) in {} on {}, attn_impl "
                "{}; the times are its device's".format(
                    args.config, serve.cfg.n_layers,
                    str(serve.cfg.dtype).split(".")[-1],
                    device_name(serve.device), serve.cfg.attn_impl),
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
