"""Disaggregated prefill/decode benchmark of the port.

    PYTHONPATH=src/python python -m tpuserver_torch.bench_disagg \\
        [--config tiny] [--attn kernel|dense] [--dtype bfloat16] \\
        [--device cpu] [--out build/bench_disagg.json]

The port's counterpart of the JAX package's phase-split benchmark, on
the port's core, HTTP front end and fleet router.  It measures the phase
split's claim, TTFT under co-batched long-prompt load against the fused
fleet, and writes BENCH-schema rows (four, with the JAX tool's keys) to
``--out``.

The A/B holds everything equal except the roles: the same two in-process
llama replicas behind the same ``FleetRouter`` serve the same workload,
background decode streams keeping the fleet busy while long-prompt probe
admissions measure TTFT, once as a fused fleet (role-less: the router
never splits) and once as a phase-split fleet (one ``prefill`` and one
``decode`` replica: every admission runs the prefill leg, the KV export's
transfer and the decode leg).

Why the split should win the tail: on a fused replica a long prompt's
chunked prefill interleaves with every co-batched decode stream's steps,
so the probe's TTFT queues behind decode work it does not need.  On the
prefill replica the only co-tenants are other prefill legs (one token
each, no decode residency).  Chunked prefill runs only where the
scheduler's ``span_safe`` allows it, which the flash-kernel presets do
not (``--attn kernel``): there every prompt prefills whole.  Each row
therefore names its ``attn_impl`` and the prefill chunks the two
replicas ran, read from their schedulers' counters.

Token identity is checked, not assumed: one pinned prompt must give the
same greedy tokens through both fleets (the export, import and rebase
seam loses nothing).  The split fleet must split every probe, the fused
fleet none; a failed check prints a FATAL line and the run exits 1.

One weight tree serves both replicas of both fleets: ``--config``
(``tiny`` at vocab 512 by default, as the JAX tool's) drawn from seed 0
in ``--dtype`` on ``--device`` (the card unless ``cpu``), or the
caller's through ``main(argv, params=)``, whose dtype and depth are then
the run's.  ``--attn`` sets the config's ``attn_impl`` (default: the
config's own).
"""

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

from tpuserver_torch._bench_common import (
    DTYPES,
    default_out,
    device_name,
    serving,
)
from tpuserver_torch.core import InferenceServer
from tpuserver_torch.fleet_router import FleetRouter
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import llama
from tpuserver_torch.models.llama_serving import LlamaGenerateModel
from tpuserver_torch.perfanalyzer.metrics import percentile
from tpuserver_torch.resumable_stream import sse_generation

#: where the rows go without ``--out``: the ignored build directory
DEFAULT_OUT = default_out("bench_disagg")

MAX_SEQ = 256
PROBE_TOKENS = 160        # long-prompt probe: 5 prefill chunks of 32
PREFILL_CHUNK = 32
BG_PROMPT_TOKENS = 8      # background streams: decode-bound on purpose
BG_MAX_TOKENS = 48
BG_WORKERS = 3
N_PROBES = 24
#: seconds the router may take to see both replicas (and both roles)
READY_S = 60.0


def _probe_prompt(i):
    """A distinct prompt per probe (same length, one prefill bucket): a
    repeated prompt would hit the radix prefix cache and skip the very
    prefill this benchmark measures."""
    rng = np.random.RandomState(1000 + i)
    return rng.randint(1, 500, size=(PROBE_TOKENS,)).astype(np.int32)


def _stream(url, prompt, max_tokens):
    """One SSE generation through the router: ``(ttft_s, tokens)``."""
    body = json.dumps({"inputs": [
        {"name": "PROMPT_IDS", "datatype": "INT32",
         "shape": [len(prompt)], "data": [int(t) for t in prompt]},
        {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
         "data": [int(max_tokens)]}]})
    tokens, ttft = [], None
    t0 = time.perf_counter()
    for event in sse_generation([url], "llama_generate", body):
        for out in event.get("outputs", []):
            if out["name"] == "TOKEN":
                if ttft is None:
                    ttft = time.perf_counter() - t0
                tokens.append(int(out["data"][0]))
    return ttft, tokens


def _wait_ready(router, split):
    """Until the router's prober sees both replicas routable and, for the
    split fleet, both role pools: a stream admitted before that rides the
    fused path."""
    deadline = time.monotonic() + READY_S
    while True:
        stats = router.stats()
        eligible = all(r["eligible"] for r in stats["replicas"])
        disagg = stats["disagg"]
        if eligible and (not split or (disagg["prefill_replicas"] >= 1
                                       and disagg["decode_replicas"] >= 1)):
            return
        if time.monotonic() > deadline:
            raise RuntimeError(
                "the router did not see the fleet ready in {} s: {}".format(
                    READY_S, stats))
        time.sleep(0.02)


def run_fleet(split, serve):
    """One fleet run: ``{"ttfts": [...], "identity_tokens": [...],
    "disagg": the router's disagg stats, "prefill_chunks": the chunks
    both replicas' schedulers ran}``."""
    roles = ("prefill", "decode") if split else (None, None)
    models = [
        LlamaGenerateModel(cfg=serve.cfg, max_seq=MAX_SEQ, max_slots=4,
                           prefill_chunk_tokens=PREFILL_CHUNK,
                           params=serve.params, device=serve.device)
        for _ in roles
    ]
    cores = [InferenceServer([m], role=r)
             for m, r in zip(models, roles)]
    frontends = [HttpServer(core).start() for core in cores]
    urls = [f.url for f in frontends]
    router = FleetRouter(urls, probe_interval_s=0.1).start()
    stop = threading.Event()

    def bg_worker(seed):
        rng = np.random.RandomState(seed)
        while not stop.is_set():
            prompt = rng.randint(
                1, 500, size=(BG_PROMPT_TOKENS,)).astype(np.int32)
            _stream(router.url, prompt, BG_MAX_TOKENS)

    try:
        _wait_ready(router, split)
        # both replicas' prefill buckets and decode (and, split, the
        # export/import seam) take their first uses out of the measurement
        for i in range(3):
            _stream(router.url, _probe_prompt(10_000 + i), 4)
            _stream(router.url, np.arange(1, BG_PROMPT_TOKENS + 1,
                                          dtype=np.int32), 4)
        identity_prompt = np.random.RandomState(7).randint(
            1, 500, size=(PROBE_TOKENS,)).astype(np.int32)
        _, identity_tokens = _stream(router.url, identity_prompt, 8)

        workers = [threading.Thread(target=bg_worker, args=(100 + w,),
                                    daemon=True)
                   for w in range(BG_WORKERS)]
        for w in workers:
            w.start()
        time.sleep(1.0)  # background decode load in steady state
        ttfts = []
        for i in range(N_PROBES):
            ttft, tokens = _stream(router.url, _probe_prompt(i), 2)
            if ttft is None or len(tokens) != 2:
                raise RuntimeError(
                    "probe {} came back short: ttft={} tokens={}"
                    .format(i, ttft, tokens))
            ttfts.append(ttft)
        stop.set()
        for w in workers:
            w.join(timeout=60)
        return {
            "ttfts": ttfts,
            "identity_tokens": identity_tokens,
            "disagg": router.stats()["disagg"],
            "prefill_chunks": sum(
                (m.scheduler_stats() or {}).get("prefill_chunks", 0)
                for m in models),
        }
    finally:
        stop.set()
        router.stop()
        for f in frontends:
            f.stop()
        for c in cores:
            c.close()


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
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
    """Run both fleets and write their rows to ``--out``; returns 0, or 1
    when a check failed.  ``params``: the weights every replica serves
    (else drawn)."""
    args = build_parser().parse_args(argv)
    serve = serving(args.config, args.device, params, vocab=512,
                    dtype=DTYPES[args.dtype], attn=args.attn)

    print("fused fleet (2 role-less replicas)...")
    fused = run_fleet(split=False, serve=serve)
    print("phase-split fleet (1 prefill + 1 decode replica)...")
    split = run_fleet(split=True, serve=serve)

    if fused["identity_tokens"] != split["identity_tokens"]:
        print("FATAL: split tokens diverged from fused: {} != {}".format(
            split["identity_tokens"], fused["identity_tokens"]),
            file=sys.stderr)
        return 1
    disagg = split["disagg"]
    if disagg["splits"] < N_PROBES:
        print("FATAL: split fleet did not phase-split the probes "
              "(disagg={})".format(disagg), file=sys.stderr)
        return 1
    if fused["disagg"]["splits"] != 0:
        print("FATAL: fused fleet took the split path "
              "(disagg={})".format(fused["disagg"]), file=sys.stderr)
        return 1

    rows = []
    stats = {}
    for name, res in (("fused", fused), ("split", split)):
        stats[name] = {
            "p50": percentile(res["ttfts"], 50) * 1e3,
            "p99": percentile(res["ttfts"], 99) * 1e3,
        }
    print("attn_impl {}, prefill chunks run: fused {}, split {}".format(
        serve.cfg.attn_impl, fused["prefill_chunks"],
        split["prefill_chunks"]))
    for pct in ("p50", "p99"):
        f_ms, s_ms = stats["fused"][pct], stats["split"][pct]
        delta = 100.0 * (s_ms - f_ms) / f_ms
        print("co-batched long-prompt TTFT {}: fused {:.1f} ms -> "
              "split {:.1f} ms ({:+.1f}%)".format(
                  pct, f_ms, s_ms, delta))
        common = {
            "unit": "ms", "vs_baseline": None,
            "prompt_tokens": PROBE_TOKENS,
            "prefill_chunk_tokens": PREFILL_CHUNK,
            "bg_streams": BG_WORKERS, "bg_max_tokens": BG_MAX_TOKENS,
            "probes": N_PROBES, "replicas": 2,
            "attn_impl": serve.cfg.attn_impl,
        }
        rows.append(dict(common, config="disagg_phase_split",
                         metric="cobatch_ttft_{}_fused".format(pct),
                         value=round(f_ms, 2),
                         prefill_chunks=fused["prefill_chunks"]))
        rows.append(dict(
            common, config="disagg_phase_split",
            metric="cobatch_ttft_{}_split".format(pct),
            value=round(s_ms, 2),
            delta_vs_fused_pct=round(delta, 1),
            token_identical=True,
            splits=disagg["splits"],
            kv_transfer_ms_avg=round(
                disagg["transfer_ms_total"]
                / max(1, disagg["transfers"]), 3),
            prefill_chunks=split["prefill_chunks"]))

    payload = {
        "n": 9,
        "cmd": "python -m tpuserver_torch.bench_disagg " + " ".join(
            argv if argv is not None else sys.argv[1:]),
        "rc": 0,
        "note": "disaggregated prefill/decode serving on the PyTorch "
                "port: TTFT of long-prompt probe admissions under "
                "co-batched background decode load, phase-split fleet (1 "
                "prefill + 1 decode replica) vs the same two replicas "
                "fused; token identity checked across the export, import "
                "and rebase seam; llama {} ({} layers) in {} on {}, "
                "attn_impl {}; the times are its device's".format(
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
