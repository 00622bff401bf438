"""The port's perf analyzer: measure a model of the port's in-process
``InferenceServer`` to stability and report a table + BENCH-schema JSON
rows.

    python -m tpuserver_torch.perf_analyzer -m <model> [options]

The in-process path of ``tools/perf_analyzer.py`` on
``tpuserver_torch.perfanalyzer``: a load mode (concurrency sweep,
request-rate sweep, or token-streaming generation) and a measurement
config; the harness drives load, waits for 3 consecutive stable windows
per level, and reports client percentiles plus the server-side
queue/compute breakdown.  No transport: the floor a socket client's
numbers are measured against.  The core runs on the card unless
``--device cpu`` is given; without a card and without it the run fails
(RuntimeError).  Over sockets the port is measured by the client-side
``tools/perf_analyzer.py -u``.

Examples:

    # the fixture models, on the CPU
    python -m tpuserver_torch.perf_analyzer -m simple --device cpu \\
        --concurrency-range 1:4

    # open-loop Poisson arrivals, inputs staged in CUDA regions
    python -m tpuserver_torch.perf_analyzer -m simple \\
        --request-rate-range 100:400:100 --request-distribution poisson \\
        --shared-memory cuda

    # token-level generation metrics (TTFT / ITL / tokens/sec) on tiny
    # llama, with a TOKEN/LOGPROB ring in a system region
    python -m tpuserver_torch.perf_analyzer -m llama_generate \\
        --generation --concurrency-range 1:4 --max-tokens 16 \\
        --shared-memory system

A caller that holds a server of its own (a full-size model) passes it:
``main(argv, core=server)`` measures that core and leaves it open.

SIGINT is two-stage (reference perf_analyzer.cc:39-53): the first ^C
finishes the current window and reports the partial results (exit 0);
a second ^C aborts immediately (exit nonzero).
"""

import argparse
import itertools
import json
import os
import signal
import sys
import threading

from tpuserver_torch import resolve_device


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
    ap.add_argument("--backend", default="inprocess", choices=["inprocess"],
                    help="client backend: the port's core in-process")
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


def build_generation_pool(metadata, args):
    """Prompt pool for generation mode: DISTINCT random prompts per
    stream; MAX_TOKENS pinned from the CLI.  With
    ``--shared-prefix-tokens N`` every prompt carries the SAME leading
    N tokens (seeded apart from the pool index) ahead of its unique
    suffix — the shared-system-prompt shape the radix prefix cache
    exists for.  The prompts are the JAX tool's, bit for bit, for a
    seed."""
    import numpy as np

    shared = None
    if args.shared_prefix_tokens > 0:
        shared = np.random.RandomState(args.seed + 7777).randint(
            1, 200, size=(args.shared_prefix_tokens,)).astype(np.int32)
    pool = []
    for i in range(args.input_pool):
        rng = np.random.RandomState(args.seed + i)
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


def main(argv=None, core=None):
    """Run the CLI on ``argv``; returns the exit code.  With ``core`` (an
    ``InferenceServer``) it measures that server and leaves it open;
    otherwise it builds one on the resolved device and closes it."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    interrupt = _Interrupt()
    previous = None
    if threading.current_thread() is threading.main_thread():
        previous = signal.signal(signal.SIGINT, interrupt.handler)
    try:
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

    own_core = core is None
    if own_core:
        core = build_inprocess_core(args, levels, device)
    backend = create_backend(
        args.backend, core=core,
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
              args.model, args.backend, mode, device, levels,
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
