"""The port's perf analyzer: measure a model of the port's server to
stability and report a table + BENCH-schema JSON rows.

    python -m tpuserver_torch.perf_analyzer -m <model> [options]

``tools/perf_analyzer.py`` on ``tpuserver_torch.perfanalyzer``: a load
mode (concurrency sweep, request-rate sweep, or token-streaming
generation) and a measurement config; the harness drives load, waits
for 3 consecutive stable windows per level, and reports client
percentiles plus the server-side queue/compute breakdown.  The backend
is the port's core in-process (``--backend inprocess``, the default: no
transport, the floor a socket client's numbers are measured against) or
a live server over a socket (``--backend http|grpc -u host:port``).  The
in-process core, and CUDA regions, live on the card unless ``--device
cpu`` is given; without a card and without it the run fails
(RuntimeError).

An http ``-u`` may be the port's fleet router (``python -m
tpuserver_torch.router_cli``, or a supervised fleet's): each level then
carries the router's counter deltas under the window (``router_*``, and
``supervisor_*`` and ``disagg_*`` where the router has them; see
``tpuserver_torch.perfanalyzer.metrics.attach_router_delta``), and the
table ends with one ``level N: router failovers= handoffs= ...`` line
per level.  A plain replica answers ``/router/stats`` with a 404 once
and is not asked again.

Examples:

    # the fixture models, on the CPU
    python -m tpuserver_torch.perf_analyzer -m simple --device cpu \\
        --concurrency-range 1:4

    # a live server over gRPC (python -m tpuserver_torch.serve ...)
    python -m tpuserver_torch.perf_analyzer -m simple --backend grpc \\
        -u 127.0.0.1:8001 --concurrency-range 1:8:7

    # open-loop Poisson arrivals, inputs staged in CUDA regions
    python -m tpuserver_torch.perf_analyzer -m simple \\
        --request-rate-range 100:400:100 --request-distribution poisson \\
        --shared-memory cuda

    # token-level generation metrics (TTFT / ITL / tokens/sec) on tiny
    # llama, with a TOKEN/LOGPROB ring in a system region
    python -m tpuserver_torch.perf_analyzer -m llama_generate \\
        --generation --concurrency-range 1:4 --max-tokens 16 \\
        --shared-memory system

    # distributed: 4 worker processes on barrier-synchronized windows,
    # one merged report (python -m tpuserver_torch.serve ... --port 8000)
    python -m tpuserver_torch.perf_analyzer -m resnet50 --backend http \\
        -u 127.0.0.1:8000 --workers 4 --concurrency-range 4 --windows 3 \\
        --report-csv windows.csv

A caller that holds a server of its own (a full-size model) passes it:
``main(argv, core=server)`` measures that core and leaves it open.

``--workers N`` is the distributed mode (the reference's MPI driver; see
``tpuserver_torch.perfanalyzer.coordinator``): the parent spawns N
``python -m tpuserver_torch.perf_analyzer --worker-connect ...``
processes, each an http client pinned round-robin to one of ``--urls``
(or all driving ``-u``), runs ``--windows`` barrier-synchronized windows
and prints ONE merged row (throughput the sum of the workers'
completions, percentiles over their pooled raw samples).  It measures
one concurrency level per worker, closed loop, and generation only in
band.  ``--urls`` without ``--workers`` is the JAX tool's pool backend,
which the port leaves to the client side (exit 2).

SIGINT is two-stage (reference perf_analyzer.cc:39-53): the first ^C
finishes the current window and reports the partial results (exit 0);
a second ^C aborts immediately (exit nonzero).
"""

import argparse
import itertools
import json
import os
import signal
import subprocess
import sys
import threading
import time

from tpuserver_torch import resolve_device

#: the directory that holds the package: the spawned workers' PYTHONPATH
SRC_PYTHON = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Interrupt:
    """The two-stage SIGINT of one run: the first sets ``event`` (finish
    the window, report), the second exits at once."""

    def __init__(self):
        self.event = threading.Event()
        self._count = 0

    def handler(self, signum, frame):
        self._count += 1
        if self._count == 1:
            self.event.set()
            print("\ncaught SIGINT: finishing the current window and "
                  "reporting partial results (^C again to abort)",
                  file=sys.stderr, flush=True)
        else:
            print("\nsecond SIGINT: aborting", file=sys.stderr, flush=True)
            os._exit(2)


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m tpuserver_torch.perf_analyzer",
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-m", "--model", required=True,
                    help="model to profile")
    ap.add_argument("--backend", default="inprocess",
                    choices=["inprocess", "http", "grpc"],
                    help="client backend: the port's core in-process "
                         "(default), or a live server over HTTP or gRPC")
    ap.add_argument("-u", "--url", default="127.0.0.1:8000",
                    help="server host:port (http/grpc backends); an "
                         "http target may be a fleet router "
                         "(python -m tpuserver_torch.router_cli), in "
                         "which case per-level router "
                         "failover/handoff/shed counters land in the "
                         "report")
    ap.add_argument("--device", default=None,
                    help="device of the in-process server and of CUDA "
                         "regions (default: the card; 'cpu' for a CPU run)")
    ap.add_argument("--concurrency-range", default=None,
                    help="start:end[:step] closed-loop concurrency sweep")
    ap.add_argument("--request-rate-range", default=None,
                    help="start:end[:step] open-loop request/sec sweep")
    ap.add_argument("--request-distribution", default="constant",
                    choices=["constant", "poisson"],
                    help="inter-arrival distribution for rate mode")
    ap.add_argument("--measurement-interval", type=int, default=2000,
                    help="measurement window length in ms (default 2000)")
    ap.add_argument("--measurement-mode", default="time_windows",
                    choices=["time_windows", "count_windows"])
    ap.add_argument("--measurement-request-count", type=int, default=50,
                    help="completions per window in count_windows mode")
    ap.add_argument("--stability-percentage", type=float, default=10.0,
                    help="windows agree within this pct (default 10)")
    ap.add_argument("--max-trials", type=int, default=10,
                    help="max windows per level before giving up stable")
    ap.add_argument("-b", "--batch-size", type=int, default=1)
    ap.add_argument("--shape", action="append", default=[],
                    metavar="NAME:d1,d2,...",
                    help="pin a dynamic input dim (repeatable)")
    ap.add_argument("--input-const", action="append", default=[],
                    metavar="NAME:value",
                    help="fill an input with one fixed value instead "
                         "of random data (control knobs like DELAY_US; "
                         "repeatable)")
    ap.add_argument("--input-pool", type=int, default=16,
                    help="distinct random input sets rotated per context")
    ap.add_argument("--shared-memory", default="none",
                    choices=["none", "system", "cuda"],
                    help="stage request tensors in shared memory "
                         "(reference InferDataManagerShm role): inputs "
                         "are written into created-and-registered "
                         "regions once, outside the timed path, and "
                         "requests carry {region, offset} references; "
                         "with 'cuda' the model reads a view of the "
                         "region's device memory, no host copy.  "
                         "Generation mode adds a token ring: TOKEN/LOGPROB "
                         "land in the ring region")
    ap.add_argument("--output-shared-memory-size", type=int, default=0,
                    help="bytes reserved per declared output in a "
                         "shared output region; 0 (default) keeps "
                         "outputs in-band")
    ap.add_argument("--max-outstanding", type=int, default=512,
                    help="request-rate mode: backend executor capacity "
                         "(the open-loop depth before the schedule "
                         "would queue client-side)")
    ap.add_argument("--warmup", type=float, default=0.3,
                    help="seconds of load before the first window")
    ap.add_argument("--seed", type=int, default=0)
    # generation mode
    ap.add_argument("--generation", action="store_true",
                    help="token-streaming mode: TTFT/ITL/tokens-sec")
    ap.add_argument("--max-tokens", type=int, default=16,
                    help="generation: tokens requested per stream")
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="generation: synthetic prompt length")
    ap.add_argument("--shared-prefix-tokens", type=int, default=0,
                    help="generation: prepend ONE common prefix of N "
                         "tokens to every prompt (each prompt keeps its "
                         "own --prompt-len unique suffix); the report's "
                         "prefix-hit%% column shows how much of it the "
                         "radix prefix cache absorbed")
    # in-process server construction
    ap.add_argument("--llama-slots", type=int, default=None,
                    help="generation: continuous-batching slots of the "
                         "tiny llama server (default: the max swept "
                         "concurrency)")
    # distributed multi-process mode (perfanalyzer.coordinator — the
    # reference's MPI-barrier coordination, SURVEY §2.2, over a
    # localhost socket control channel)
    ap.add_argument("--urls", default=None,
                    help="distributed mode: comma-separated replica URLs "
                         "the workers are pinned to round-robin")
    ap.add_argument("--workers", type=int, default=0,
                    help="spawn N perf_analyzer worker processes, each "
                         "pinned round-robin to one of --urls (or all "
                         "driving -u, e.g. a fleet router); "
                         "barrier-synchronized windows, ONE merged "
                         "report (throughput = sum of worker "
                         "inferences, percentiles from merged raw "
                         "samples)")
    ap.add_argument("--windows", type=int, default=3,
                    help="distributed mode: synchronized measurement "
                         "windows per run (default 3)")
    ap.add_argument("--report-csv", default=None,
                    help="distributed mode: per-window CSV in the "
                         "reference report_writer schema")
    ap.add_argument("--worker-connect", default=None,
                    help=argparse.SUPPRESS)  # the spawned child mode
    ap.add_argument("--worker-id", type=int, default=0,
                    help=argparse.SUPPRESS)
    # output
    ap.add_argument("--csv", default=None, help="write CSV here")
    ap.add_argument("--json", default=None,
                    help="write JSON rows here (also printed to stdout)")
    ap.add_argument("-v", "--verbose", action="store_true")
    return ap


def parse_shapes(entries):
    shapes = {}
    for entry in entries:
        name, _, dims = entry.partition(":")
        if not dims:
            raise SystemExit(
                "--shape wants NAME:d1,d2,... (got {!r})".format(entry))
        shapes[name] = [int(d) for d in dims.split(",")]
    return shapes


def parse_consts(entries):
    consts = {}
    for entry in entries:
        name, _, value = entry.partition(":")
        if not value:
            raise SystemExit(
                "--input-const wants NAME:value (got {!r})".format(entry))
        try:
            consts[name] = int(value)
        except ValueError:
            try:
                consts[name] = float(value)
            except ValueError:
                consts[name] = value
    return consts


def build_inprocess_core(args, levels, device):
    """An in-process InferenceServer shaped for the requested profile
    (the analogue of the reference's Triton C-API backend server): the
    fixture models, or for generation a ``tiny`` llama behind the
    continuous-batching scheduler, on ``device``."""
    from tpuserver_torch.core import InferenceServer

    if args.generation or args.model == "llama_generate":
        from tpuserver_torch.models import llama
        from tpuserver_torch.models.llama_serving import LlamaGenerateModel

        slots = args.llama_slots or max(levels)
        need = (args.shared_prefix_tokens + args.prompt_len
                + args.max_tokens + 8)
        # the paged KV pool wants page_size (16) | max_seq
        max_seq = -(-max(64, need) // 16) * 16
        model = LlamaGenerateModel(
            cfg=llama.tiny(vocab=256), max_seq=max_seq,
            max_slots=slots, device=device)
        core = InferenceServer([model])
        model.warmup()
        return core
    from tpuserver_torch.models import default_models

    return InferenceServer(default_models())


def build_generation_pool(metadata, args, seed=None, shared_seed=None):
    """Prompt pool for generation mode: DISTINCT random prompts per
    stream; MAX_TOKENS pinned from the CLI.  With
    ``--shared-prefix-tokens N`` every prompt carries the SAME leading
    N tokens (drawn from ``shared_seed``, default ``--seed`` + 7777)
    ahead of its unique suffix — the shared-system-prompt shape the
    radix prefix cache exists for.  The prompts are the JAX tool's, bit
    for bit, for a seed.

    Distributed workers pass ``seed`` offset per worker (no two workers
    replay the same suffix stream) and leave ``shared_seed`` at the
    run's base, so the shared prefix is the same across the workers."""
    import numpy as np

    if seed is None:
        seed = args.seed
    if shared_seed is None:
        shared_seed = args.seed + 7777
    shared = None
    if args.shared_prefix_tokens > 0:
        shared = np.random.RandomState(shared_seed).randint(
            1, 200, size=(args.shared_prefix_tokens,)).astype(np.int32)
    pool = []
    for i in range(args.input_pool):
        rng = np.random.RandomState(seed + i)
        inputs = {}
        for spec in metadata.get("inputs", []):
            name = spec["name"]
            if name.upper() == "MAX_TOKENS":
                inputs[name] = np.array([args.max_tokens], dtype=np.int32)
            elif any(int(d) < 0 for d in spec["shape"]):
                # dynamic prompt axis: synthesize at --prompt-len with
                # small ids (valid for every vocab the zoo uses)
                suffix = rng.randint(
                    1, 200, size=(args.prompt_len,)).astype(np.int32)
                inputs[name] = (
                    np.concatenate([shared, suffix])
                    if shared is not None else suffix)
            else:
                dims = [int(d) for d in spec["shape"]]
                inputs[name] = rng.randint(
                    1, 200, size=dims).astype(np.int32)
        pool.append(inputs)
    return pool


def _token_ring(shm, lanes, max_tokens):
    """A TOKEN/LOGPROB ring region with one lane per stream slot
    (``lanes``), and the per-stream parameters that hand each stream the
    next lane, so concurrent generations never share slots."""
    slots = max(1, max_tokens)
    lane_bytes = slots * 8
    ring_name, _ = shm.create_region("ring", lanes * lane_bytes)
    counter = itertools.count()
    lane_lock = threading.Lock()

    def gen_params():
        with lane_lock:
            lane = next(counter) % lanes
        return {"shm_ring_region": ring_name,
                "shm_ring_slots": slots,
                "shm_ring_offset": lane * lane_bytes}

    return gen_params


def _wait_window(duration_s, early_exit):
    """Sleep out one measurement window (or until ``early_exit``);
    returns the seconds it lasted."""
    t0 = time.monotonic()
    early_exit.wait(duration_s)
    return time.monotonic() - t0


def run_worker(args, early_exit):
    """Hidden child mode (``--worker-connect``): one worker process of
    a distributed run.  Drives closed-loop concurrency against its
    pinned replica (``--urls`` round-robined by ``--worker-id``, else
    ``-u``) continuously, and measures exactly the windows the
    coordinator's barrier releases — raw latency records ship back so
    the parent merges samples, never percentiles."""
    from tpuserver_torch.perfanalyzer.client_backend import (
        ShmInferDataManager,
        build_input_pool,
        create_backend,
    )
    from tpuserver_torch.perfanalyzer.coordinator import WorkerChannel
    from tpuserver_torch.perfanalyzer.load_manager import ConcurrencyManager
    from tpuserver_torch.perfanalyzer.profiler import parse_range

    level = parse_range(args.concurrency_range or "1")[0]
    urls = ([u.strip() for u in args.urls.split(",") if u.strip()]
            if args.urls else [args.url])
    url = urls[args.worker_id % len(urls)]
    backend = create_backend("http", url=url, max_inflight=level)
    manager = None
    channel = None
    shm = None
    gen_profiler = None
    try:
        metadata = backend.model_metadata(args.model)
        if args.generation:
            from tpuserver_torch.perfanalyzer.generation import (
                GenerationProfiler,
            )

            # per-worker suffix stream, run-wide shared prefix (see
            # build_generation_pool)
            pool = build_generation_pool(
                metadata, args, seed=args.seed + 1000 * args.worker_id,
                shared_seed=args.seed + 7777)
            gen_profiler = GenerationProfiler(
                backend, args.model, pool,
                measurement_interval_s=args.measurement_interval / 1000.0,
                early_exit=early_exit)
            gen_profiler.change_level(level)
            collector = gen_profiler.collector
            # warmup gate before saying hello: the first barrier window
            # must not eat this worker's cold start
            gate = time.monotonic() + 120.0
            while (collector.lifetime_generations() == 0
                   and time.monotonic() < gate
                   and not early_exit.is_set()):
                time.sleep(0.02)
            channel = WorkerChannel(args.worker_connect, args.worker_id)

            def run_gen_window(duration_s, index):
                collector.start_window()
                duration = _wait_window(duration_s, early_exit)
                window = collector.end_window()
                # raw TTFT/ITL samples ship to the parent — the merge
                # pools samples, never percentiles
                return {"completed": window["generations"],
                        "errors": window["errors"],
                        "duration_s": duration,
                        "latencies_s": [],
                        "tokens": window["tokens"],
                        "ttfts_s": window["ttfts_s"],
                        "itls_s": window["itls_s"],
                        "generations": window["generations"],
                        "resumed_streams": window["resumed_streams"],
                        "resume_events": window["resume_events"]}

            channel.serve(run_gen_window)
            return 0
        config = backend.model_config(args.model)
        pool = build_input_pool(
            metadata, config,
            pool_size=args.input_pool,
            batch_size=args.batch_size,
            shape_overrides=parse_shapes(args.shape),
            const_overrides=parse_consts(args.input_const),
            # distinct per-worker streams of inputs: no two workers
            # replay the same request sequence in lockstep
            seed=args.seed + 1000 * args.worker_id)
        if args.shared_memory != "none":
            # every worker process creates and registers its OWN
            # regions (names carry its tag) and tears exactly those
            # down on exit: N workers against one server never collide
            # or leak
            device = (resolve_device(args.device)
                      if args.shared_memory == "cuda" else None)
            shm = ShmInferDataManager(
                backend, args.shared_memory,
                tag="w{}".format(args.worker_id), device=device)
            refs = shm.stage_input_sets(
                pool, {t["name"]: t["datatype"]
                       for t in metadata.get("inputs", [])})
            out_refs = None
            if args.output_shared_memory_size > 0:
                out_refs = shm.stage_outputs(
                    [o["name"] for o in metadata.get("outputs", [])],
                    args.output_shared_memory_size)
            prepared = backend.prepare_shm(args.model, refs, out_refs)
        else:
            prepared = backend.prepare(args.model, pool)
        manager = ConcurrencyManager(backend, args.model, prepared)
        manager.change_level(level)
        collector = manager.collector
        channel = WorkerChannel(args.worker_connect, args.worker_id)

        def run_window(duration_s, index):
            collector.start_window()
            duration = _wait_window(duration_s, early_exit)
            latencies, errors = collector.end_window()
            # tokens is part of the window-result contract; scalar
            # workers always send 0
            return {"completed": len(latencies), "errors": errors,
                    "duration_s": duration, "latencies_s": latencies,
                    "tokens": 0}

        channel.serve(run_window)
    finally:
        if channel is not None:
            channel.close()
        if manager is not None:
            manager.stop()
        if gen_profiler is not None:
            gen_profiler.stop()
        if shm is not None:
            shm.close()
        backend.close()
    return 0


def _prefix_snapshot_with_grace(probe, early_exit, grace_s=3.0):
    """One ``/metrics`` prefix-counter snapshot, re-polled briefly when
    the families are absent (a router's fleet fold that found no live
    replica carries none: one single-shot miss would drop the
    prefix-hit%% column from the whole run)."""
    deadline = time.monotonic() + grace_s
    snap = probe.prefix_cache_snapshot()
    while snap is None and time.monotonic() < deadline:
        if early_exit.wait(0.1):
            break
        snap = probe.prefix_cache_snapshot()
    return snap


def worker_argv(args, level, address, worker_id):
    """The argv of distributed worker ``worker_id``: this CLI's flags
    that shape a worker's load at ``level``, and the hidden child
    mode's."""
    argv = [sys.executable, "-m", "tpuserver_torch.perf_analyzer",
            "-m", args.model, "--backend", "http", "-u", args.url,
            "--concurrency-range", str(level),
            "--input-pool", str(args.input_pool),
            "-b", str(args.batch_size), "--seed", str(args.seed),
            "--shared-memory", args.shared_memory,
            "--output-shared-memory-size",
            str(args.output_shared_memory_size)]
    if args.device:
        argv += ["--device", args.device]
    if args.urls:
        argv += ["--urls", args.urls]
    if args.generation:
        argv += ["--generation",
                 "--max-tokens", str(args.max_tokens),
                 "--prompt-len", str(args.prompt_len),
                 "--shared-prefix-tokens", str(args.shared_prefix_tokens)]
    for entry in args.shape:
        argv += ["--shape", entry]
    for entry in args.input_const:
        argv += ["--input-const", entry]
    return argv + ["--worker-connect", address,
                   "--worker-id", str(worker_id)]


def run_coordinator(args, early_exit):
    """Parent mode (``--workers N``): spawn N worker processes, run
    barrier-synchronized windows, merge, and emit ONE report."""
    from tpuserver_torch.perfanalyzer import metrics
    from tpuserver_torch.perfanalyzer.client_backend import create_backend
    from tpuserver_torch.perfanalyzer.coordinator import (
        Coordinator,
        merge_windows,
        reap_workers,
    )
    from tpuserver_torch.perfanalyzer.profiler import (
        ProfileResult,
        parse_range,
    )
    from tpuserver_torch.perfanalyzer.report import ReportWriter

    if args.request_rate_range:
        raise SystemExit(
            "--workers drives the closed-loop modes; the request-rate "
            "mode is single-process")
    if args.generation and args.shared_memory != "none":
        raise SystemExit(
            "--workers --generation is in-band only; drop "
            "--shared-memory (token rings are a direct-replica mode)")
    if args.backend not in ("http",):
        raise SystemExit(
            "--workers spawns http worker processes; --backend {} is "
            "single-process".format(args.backend))
    levels = parse_range(args.concurrency_range or "1")
    if len(levels) != 1:
        raise SystemExit(
            "--workers measures ONE concurrency level per run "
            "(got sweep {})".format(levels))
    level = levels[0]
    window_s = args.measurement_interval / 1000.0
    dist_mode = ("distributed_generation" if args.generation
                 else "distributed_concurrency")
    coord = Coordinator(args.workers).listen()
    print("*** Measurement Settings ***\n"
          "  model: {}  backend: http  mode: {}\n"
          "  workers: {}  concurrency/worker: {}  windows: {} x {} ms "
          "(barrier-synchronized)".format(
              args.model, dist_mode, args.workers, level, args.windows,
              args.measurement_interval), flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC_PYTHON, env.get("PYTHONPATH")) if p)
    procs = []
    window_rows = []
    # the fleet prefix-hit%% is the parent's: one probe backend reads
    # the target's /metrics prefix counters before/after the windows
    prefix_before = prefix_after = None
    probe = None
    if args.generation:
        probe = create_backend("http", url=args.url, max_inflight=1)
    try:
        for i in range(args.workers):
            procs.append(subprocess.Popen(
                worker_argv(args, level, coord.address, i), env=env))
        coord.wait_for_workers(timeout_s=120.0)
        if args.warmup > 0:
            # load is already flowing (workers start their managers
            # before dialing in); the parent just waits it out
            early_exit.wait(args.warmup)
        if probe is not None:
            prefix_before = _prefix_snapshot_with_grace(probe, early_exit)
        for index in range(args.windows):
            if early_exit.is_set():
                break
            row = coord.run_window(index, window_s)
            row["concurrency"] = level * args.workers
            if row.get("tokens") and row["duration_s"] > 0:
                row["tokens_per_sec"] = row["tokens"] / row["duration_s"]
            window_rows.append(row)
            if args.verbose:
                print("  window {:2d}: {:8.1f} infer/sec over {} "
                      "workers".format(index + 1, row["throughput"],
                                       row["workers"]), flush=True)
        if probe is not None:
            prefix_after = _prefix_snapshot_with_grace(probe, early_exit)
    finally:
        coord.shutdown()
        reap_workers(procs)
        if probe is not None:
            probe.close()
    if not window_rows:
        print(json.dumps({"error": "no synchronized windows completed"}),
              flush=True)
        return 1
    merged = merge_windows(window_rows)
    result = ProfileResult(
        mode=dist_mode,
        level=level * args.workers,
        stable=True,
        interrupted=early_exit.is_set(),
        trials=len(window_rows),
        workers=args.workers,
    )
    result.update(merged)
    if args.generation:
        # token-rate throughput + TTFT/ITL percentiles over the POOLED
        # raw samples of every worker and window (raw sample lists
        # dropped from the report)
        duration = merged.get("duration_s", 0.0)
        result["throughput"] = (
            merged.get("tokens", 0) / duration if duration > 0 else 0.0)
        result["generations"] = merged.get("generations", 0)
        result["gen_per_sec"] = (
            merged.get("generations", 0) / duration
            if duration > 0 else 0.0)
        ttfts = result.pop("ttfts_s", None) or []
        itls = result.pop("itls_s", None) or []
        for prefix_key, sample in (("ttft", ttfts), ("itl", itls)):
            if sample:
                ms = sorted(v * 1e3 for v in sample)
                result[prefix_key + "_avg_ms"] = sum(ms) / len(ms)
                for p in (50, 90, 95, 99):
                    result["{}_p{}_ms".format(prefix_key, p)] = (
                        metrics.percentile(ms, p, presorted=True))
            else:
                result[prefix_key + "_avg_ms"] = None
                for p in (50, 90, 95, 99):
                    result["{}_p{}_ms".format(prefix_key, p)] = None
        if prefix_before is not None and prefix_after is not None:
            dh = max(0, prefix_after["hits"] - prefix_before["hits"])
            dm = max(0, prefix_after["misses"] - prefix_before["misses"])
            result["prefix_cache_hits"] = dh
            result["prefix_cache_misses"] = dm
            result["prefix_hit_pct"] = (
                100.0 * dh / (dh + dm) if dh + dm else None)
    writer = ReportWriter(
        args.model, "http-x{}".format(args.workers),
        extra_tags={"early_exit": True} if early_exit.is_set() else None)
    writer.print_table([result])
    print()
    writer.print_json([result])
    if args.csv:
        writer.write_csv(args.csv, [result])
    if args.json:
        writer.write_json(args.json, [result])
    if args.report_csv:
        writer.write_window_csv(args.report_csv, window_rows)
    return 0


def main(argv=None, core=None):
    """Run the CLI on ``argv``; returns the exit code.  With ``core`` (an
    ``InferenceServer``) it measures that server and leaves it open;
    otherwise it builds one on the resolved device and closes it."""
    args = build_parser().parse_args(argv)
    if args.urls and not (args.workers or args.worker_connect):
        print("--urls without --workers is the pool backend, which the "
              "port leaves to the client side: run tools/perf_analyzer.py "
              "--backend pool --urls {}".format(args.urls),
              file=sys.stderr, flush=True)
        return 2
    interrupt = _Interrupt()
    previous = None
    if threading.current_thread() is threading.main_thread():
        previous = signal.signal(signal.SIGINT, interrupt.handler)
    try:
        if args.worker_connect:
            return run_worker(args, interrupt.event)
        if args.workers:
            return run_coordinator(args, interrupt.event)
        # a socket run touches a device only through CUDA regions
        device = None
        if args.backend == "inprocess" or args.shared_memory == "cuda":
            device = resolve_device(args.device)
        return _run(args, core, device, interrupt.event)
    finally:
        if previous is not None:
            signal.signal(signal.SIGINT, previous)


def _run(args, core, device, early_exit):
    from tpuserver_torch.perfanalyzer.client_backend import (
        ShmInferDataManager,
        build_input_pool,
        create_backend,
    )
    from tpuserver_torch.perfanalyzer.generation import GenerationProfiler
    from tpuserver_torch.perfanalyzer.load_manager import (
        ConcurrencyManager,
        RequestRateManager,
    )
    from tpuserver_torch.perfanalyzer.profiler import (
        InferenceProfiler,
        parse_range,
    )
    from tpuserver_torch.perfanalyzer.report import ReportWriter

    if args.concurrency_range and args.request_rate_range:
        raise SystemExit(
            "--concurrency-range and --request-rate-range are mutually "
            "exclusive")
    if args.generation and args.request_rate_range:
        raise SystemExit(
            "generation mode is concurrency-based (N worker streams); "
            "--request-rate-range is not supported with --generation")
    rate_mode = bool(args.request_rate_range)
    levels = parse_range(
        args.request_rate_range or args.concurrency_range or "1")

    own_core = core is None and args.backend == "inprocess"
    if own_core:
        core = build_inprocess_core(args, levels, device)
    backend = create_backend(
        args.backend, url=args.url, core=core,
        # size the backend for the load it must carry: swept
        # concurrency (closed loop) or the open-loop outstanding depth
        max_inflight=(args.max_outstanding if rate_mode
                      else max(levels)))

    interval_s = args.measurement_interval / 1000.0
    mode = ("generation" if args.generation
            else "request_rate" if rate_mode else "concurrency")
    print("*** Measurement Settings ***\n"
          "  model: {}  backend: {}  mode: {}  device: {}\n"
          "  levels: {}  window: {} ms ({})  stability: {}% over 3 "
          "windows, max {} trials".format(
              args.model, args.backend if args.backend == "inprocess"
              else "{} {}".format(args.backend, args.url), mode, device,
              levels,
              args.measurement_interval, args.measurement_mode,
              args.stability_percentage, args.max_trials), flush=True)

    manager = None
    shm = None
    profiler = None
    try:
        metadata = backend.model_metadata(args.model)
        datatypes = {t["name"]: t["datatype"]
                     for t in metadata.get("inputs", [])}
        if args.shared_memory != "none":
            shm = ShmInferDataManager(backend, args.shared_memory,
                                      device=device)
        if args.generation:
            pool = build_generation_pool(metadata, args)
            gen_params = None
            if shm is not None:
                # prompts stage once into a shm region (requests carry
                # references); every stream gets its own token-ring
                # lane
                refs = shm.stage_input_sets(
                    [{"PROMPT_IDS": s["PROMPT_IDS"]} for s in pool],
                    datatypes)
                pool = [dict(s, PROMPT_IDS=r["PROMPT_IDS"])
                        for s, r in zip(pool, refs)]
                gen_params = _token_ring(shm, 2 * max(levels),
                                         args.max_tokens)
            profiler = GenerationProfiler(
                backend, args.model, pool,
                parameters=gen_params,
                measurement_interval_s=interval_s,
                stability_pct=args.stability_percentage,
                max_trials=args.max_trials,
                warmup_s=args.warmup,
                early_exit=early_exit,
                verbose=args.verbose)
        else:
            config = backend.model_config(args.model)
            pool = build_input_pool(
                metadata, config,
                pool_size=args.input_pool,
                batch_size=args.batch_size,
                shape_overrides=parse_shapes(args.shape),
                const_overrides=parse_consts(args.input_const),
                seed=args.seed)
            if shm is not None:
                refs = shm.stage_input_sets(pool, datatypes)
                out_refs = None
                if args.output_shared_memory_size > 0:
                    out_refs = shm.stage_outputs(
                        [o["name"]
                         for o in metadata.get("outputs", [])],
                        args.output_shared_memory_size)
                prepared = backend.prepare_shm(
                    args.model, refs, out_refs)
            else:
                prepared = backend.prepare(args.model, pool)
            if rate_mode:
                manager = RequestRateManager(
                    backend, args.model, prepared,
                    distribution=args.request_distribution,
                    seed=args.seed)
            else:
                manager = ConcurrencyManager(
                    backend, args.model, prepared)
            profiler = InferenceProfiler(
                backend, args.model, manager,
                measurement_mode=args.measurement_mode,
                measurement_interval_s=interval_s,
                measurement_request_count=args.measurement_request_count,
                stability_pct=args.stability_percentage,
                max_trials=args.max_trials,
                # open-loop latencies trend with queue depth by design;
                # judge rate-mode stability on throughput alone (the
                # reference's request-rate exemption)
                check_latency_stability=not rate_mode,
                warmup_s=args.warmup,
                early_exit=early_exit,
                verbose=args.verbose)
        results = profiler.sweep(levels)
    finally:
        if manager is not None:
            manager.stop()
        if shm is not None:
            # unregister on the server, destroy the client's regions
            shm.close()
        backend.close()
        if own_core:
            core.close()

    if not results:
        print(json.dumps({"error": "no measurements completed"}),
              flush=True)
        return 1
    writer = ReportWriter(
        args.model, args.backend,
        extra_tags={"early_exit": True} if early_exit.is_set() else None)
    writer.print_table(results)
    if args.generation:
        # every stream's token count, by level (not a report column: the
        # rows keep the JAX tool's keys)
        for level, counts in sorted(profiler.stream_tokens.items()):
            print("tokens per stream at level {}: {}".format(
                level, json.dumps({str(n): c for n, c in
                                   sorted(counts.items())})), flush=True)
    print()
    writer.print_json(results)
    if args.csv:
        writer.write_csv(args.csv, results)
    if args.json:
        writer.write_json(args.json, results)
    unstable = [r["level"] for r in results if not r["stable"]]
    if unstable and not early_exit.is_set():
        print("warning: levels {} never reached {}% stability within "
              "{} trials; numbers reported from the last {} windows"
              .format(unstable, args.stability_percentage,
                      args.max_trials, 3),
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
