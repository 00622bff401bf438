#!/usr/bin/env python3
"""Fleet-router demo on the PyTorch port: a PLAIN ``tritonclient.http``
client pointed at a ``tpuserver_torch.fleet_router.FleetRouter`` over two
in-process port replicas gets health-aware routing, drain rotation, and
cross-replica stream handoff for free — no EndpointPool, no client-side
smarts.

The demo (1) streams a generation through the router while an injected
fault (the ``http.generate_stream`` fault point) severs the serving
replica's connection mid-stream: the router re-admits prompt + emitted
history on the other replica and the client sees one continuous
token-identical stream; (2) drains one replica mid-traffic: unary
requests keep succeeding because the prober rotates it out before
anything lands there.

Self-contained: the replicas and the router are spun up in-process (a
handoff demo needs a replica it is allowed to kill), so no external
server is required.  ``-u`` is accepted for harness compatibility and
ignored.  Both replicas serve one weight tree: ``--config`` (``tiny`` at
vocab 256 by default) drawn from seed 0 in ``--dtype`` on ``--device``
(the card unless ``cpu``).  The default dtype is float32, with TF32 off:
the handoff re-prefills prompt + history, and in bf16 a near-tie can
flip a greedy token there.  In production run the router as its own
process: ``python -m tpuserver_torch.router_cli --backends a:8000,b:8000``.

    PYTHONPATH=src/python python src/python/examples/\\
simple_http_router_torch.py [--config llama3_8b] [--device cpu]
"""

import argparse
import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch

import tritonclient.http as httpclient
from tpuserver_torch import fault_points, resolve_device
from tpuserver_torch.core import InferenceServer
from tpuserver_torch.fleet_router import FleetRouter
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import llama
from tpuserver_torch.models.llama_serving import LlamaGenerateModel
from tpuserver_torch.models.simple import SimpleModel

# the replicas' cache length: the least the decode kernel tiles (128)
MAX_SEQ = 128


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("-u", "--url", default=None,
                        help="ignored: this demo severs streams on its "
                             "own in-process replicas")
    parser.add_argument("-t", "--max-tokens", type=int, default=8)
    parser.add_argument("--config", default="tiny",
                        choices=sorted(llama.PRESETS),
                        help="the llama config (default tiny, at vocab 256)")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--device", default=None,
                        help="the card unless 'cpu'")
    return parser.parse_args(argv)


@contextlib.contextmanager
def _tf32_off(dtype):
    """TF32 off for float32 products on the card, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = (llama.tiny(vocab=256) if args.config == "tiny"
           else llama.PRESETS[args.config]())
    cfg = dataclasses.replace(cfg, dtype=getattr(torch, args.dtype))
    with _tf32_off(cfg.dtype):
        params = llama.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device)
        failures = run(args, cfg, params, device)
    del params

    if failures:
        for failure in failures:
            print("FAIL: {}".format(failure))
        return 1
    print("PASS: replica death and drain were invisible to a plain "
          "client behind the router")
    return 0


def run(args, cfg, params, device):
    """Both acts on two replicas of ``params``; the failures."""
    scopes = ("demo-a", "demo-b")
    cores = [
        InferenceServer(
            [LlamaGenerateModel(cfg=cfg, max_seq=MAX_SEQ, max_slots=2,
                                restart_backoff_s=0.01, params=params,
                                device=device),
             SimpleModel()],
            fault_scope=scope)
        for scope in scopes
    ]
    frontends = [HttpServer(core, port=0).start() for core in cores]
    urls = ["127.0.0.1:{}".format(f.port) for f in frontends]
    router = FleetRouter(urls, probe_interval_s=0.1).start()
    print("replicas: {}".format(urls))
    print("router:   {}".format(router.url))

    prompt = np.array([3, 1, 4, 1, 5], dtype=np.int32)
    budget = np.array([args.max_tokens], dtype=np.int32)
    client = httpclient.InferenceServerClient(router.url,
                                              verbose=args.verbose)
    failures = []

    def stream_tokens():
        return [
            int(out["data"][0])
            for event in client.generate_stream(
                "llama_generate",
                {"PROMPT_IDS": prompt, "MAX_TOKENS": budget})
            for out in event.get("outputs", [])
            if out["name"] == "TOKEN"
        ]

    try:
        # fault-free reference: greedy decode is deterministic and the
        # replicas share weights, so every later stream must match this
        reference = stream_tokens()
        print("reference tokens: {}".format(reference))

        print("--- severing the serving replica's connection mid-stream ---")
        for scope in scopes:  # whichever replica is home drops the stream
            fault_points.install("http.generate_stream", mode="raise",
                                 times=1, skip=3, scope=scope)
        tokens = stream_tokens()
        fault_points.clear()
        stats = router.stats()
        print("tokens through the kill: {}".format(tokens))
        print("router absorbed it: handoffs={} failovers={}".format(
            stats["handoffs"], stats["failovers"]))
        if tokens != reference:
            failures.append("handoff stream diverged: {} != {}".format(
                tokens, reference))
        if stats["handoffs"] < 1:
            failures.append("no cross-replica handoff recorded")

        print("--- draining replica A mid-traffic ---")
        cores[0].begin_drain()
        deadline = time.monotonic() + 5.0
        while (any(r["eligible"] and r["url"] == urls[0]
                   for r in router.stats()["replicas"])
               and time.monotonic() < deadline):
            time.sleep(0.05)
        data = np.arange(16, dtype=np.int32)
        inputs = [httpclient.InferInput("INPUT0", [16], "INT32"),
                  httpclient.InferInput("INPUT1", [16], "INT32")]
        inputs[0].set_data_from_numpy(data)
        inputs[1].set_data_from_numpy(np.ones(16, dtype=np.int32))
        for i in range(6):
            try:
                result = client.infer("simple", inputs)
                if not np.array_equal(result.as_numpy("OUTPUT0"), data + 1):
                    failures.append("wrong unary result at {}".format(i))
            except Exception as e:  # noqa: BLE001 — counted as a failure
                failures.append("unary request {} failed during drain: "
                                "{}".format(i, e))
        cores[0].mark_ready()
        for rep in router.stats()["replicas"]:
            print("replica {url}: eligible={eligible} requests={requests} "
                  "failures={failures}".format(**rep))
    finally:
        fault_points.clear()
        client.close()
        router.stop()
        for f in frontends:
            f.stop()
        for c in cores:
            c.close()
    return failures


if __name__ == "__main__":
    sys.exit(main())
