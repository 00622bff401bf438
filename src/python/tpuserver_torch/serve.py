"""Serve llama generation from the port over HTTP, and over gRPC too.

    python -m tpuserver_torch.serve --config llama3_8b --max-seq 4096 \\
        --port 8000 [--grpc-port 8001] [--device cuda] [--seed 0] \\
        [--models llama,fixtures,vision] \\
        [--quantize] [--max-slots 8 [--page-size 16] [--kv-pages N]
        [--spec-tokens K] [--step-timeout-s S] [--kv-export]
        [--target-queue-ms MS [--shed-interval-ms MS]]] \\
        [--fault-scope NAME] \\
        [--role prefill|decode] [--spawn-nonce N] [--drain-timeout S]

``--models`` names what is served, a comma-separated list (default
``llama``): ``llama`` (``llama_generate``, the options below),
``fixtures`` (the fixture models of ``models/simple.py``: ``simple``,
``simple_string``, the identities, ``sequence_accumulate``,
``repeat_int32``) and ``vision`` (ResNet-50, DenseNet-121, the image
preprocess model and ``image_ensemble``, bf16, every batch bucket warmed
before the server turns ready), all through the KServe-v2 ``/infer`` and
``ModelInfer`` verbs.

Weights are random, drawn from ``--seed`` on the device; ``--quantize``
serves them as int8 with per-output-channel scales
(``LlamaGenerateModel(quantize=True)``: about half the bytes, the few-row
products through the W8A16 kernel).  With
``--max-slots`` above 1, concurrent requests share one batched decode
step over a paged KV pool of ``--kv-pages`` pages of ``--page-size``
tokens (default: room for ``--max-slots`` full-length sequences); each
step verifies up to ``--spec-tokens`` drafted tokens per stream, and a
device call stalled past ``--step-timeout-s`` restarts the decode loop
(admission prefills get ten times it, and the first call of each kind,
which loads the kernel library, is not timed), and ``--kv-export`` parks
every disconnected generation's KV for its resume to attach (the default
of the ``kv_park`` request parameter).  ``--target-queue-ms`` turns on
sojourn-time shedding of admissions (a 429 with a computed
``Retry-After`` once the queue's head has waited longer than that for a
``--shed-interval-ms`` control interval).

``--grpc-port`` also serves the KServe-v2 gRPC service on the same core
(``tpuserver_torch.grpc_server``, which needs ``grpcio``; without the
flag it is not imported).  Both serve ``/metrics``: ``GET /metrics`` and
the ``ServerMetrics`` unary.  ``--fault-scope`` names this server at the
fault points (``tpuserver_torch.fault_points``), which the
``TPUSERVER_FAULTS`` environment variable arms at start.

A fleet replica: this is the command a fleet supervisor's template runs
(``tpuserver/fleet.py`` appends ``--role`` and ``--spawn-nonce``), and
a fleet router probes its ``/v2/health/stats``.  ``--role`` advertises
the disaggregated-serving phase this replica serves (a router splits a
generation into a prefill leg on a ``prefill`` replica and a decode leg
that attaches its KV export on a ``decode`` one); ``--spawn-nonce`` is
echoed in the snapshot.  The front ends listen while
the model warms up, with the server ``starting`` (not ready), and it
turns ready after the warm-up.  SIGTERM drains: admission stops and
readiness flips at once, live streams finish within ``--drain-timeout``
seconds, and the process exits 0 once the server has stopped, stopping
its front ends only then.  A SIGTERM during the warm-up waits for it to
end and then drains a server that never turned ready.  SIGINT stops at
once.
"""

import argparse
import os
import signal
import threading

from tpuserver_torch import resolve_device
from tpuserver_torch.core import InferenceServer, install_sigterm_drain
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import default_models, llama
from tpuserver_torch.models.llama_serving import LlamaGenerateModel

#: the model groups ``--models`` may name
MODEL_GROUPS = ("llama", "fixtures", "vision")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="llama3_8b",
                        choices=sorted(llama.PRESETS))
    parser.add_argument("--max-seq", type=int, default=4096)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--grpc-port", type=int, default=None,
                        help="also serve gRPC on this port (0: a free one)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--models", default="llama",
                        help="comma-separated model groups to serve: "
                             "{} (default: llama)".format(
                                 ", ".join(MODEL_GROUPS)))
    parser.add_argument("--quantize", action="store_true",
                        help="serve int8 weights (per-output-channel "
                             "scales) instead of bf16")
    parser.add_argument("--max-slots", type=int, default=1,
                        help="concurrent generations per batched decode "
                             "step (1: one request at a time)")
    parser.add_argument("--page-size", type=int, default=16,
                        help="tokens per KV page (--max-slots > 1)")
    parser.add_argument("--kv-pages", type=int, default=None,
                        help="KV pool pages (--max-slots > 1; default "
                             "max_slots * max_seq / page_size)")
    parser.add_argument("--spec-tokens", type=int, default=0,
                        help="tokens drafted and verified per batched step "
                             "(--max-slots > 1; 0: no speculation)")
    parser.add_argument("--step-timeout-s", type=float, default=None,
                        help="restart the decode loop when a device call "
                             "stalls this long (--max-slots > 1; default: "
                             "no watchdog)")
    parser.add_argument("--kv-export", action="store_true",
                        help="export a disconnected generation's KV as a "
                             "CUDA-shm region its resume attaches "
                             "(--max-slots > 1; the kv_park default)")
    parser.add_argument("--target-queue-ms", type=float, default=None,
                        help="shed admissions once the queue's sojourn "
                             "stays above this (--max-slots > 1; default: "
                             "off)")
    parser.add_argument("--shed-interval-ms", type=float, default=100.0,
                        help="the shedding controller's control interval")
    parser.add_argument("--fault-scope", default=None,
                        help="this server's scope at the fault points")
    parser.add_argument("--role", choices=("prefill", "decode"),
                        default=None,
                        help="the disaggregated-serving phase this replica "
                             "serves (default: fused)")
    parser.add_argument("--spawn-nonce", default=None,
                        help="the spawner's identity nonce, echoed in "
                             "/v2/health/stats")
    parser.add_argument("--drain-timeout", type=float, default=30.0,
                        help="seconds a SIGTERM drain lets live streams "
                             "run before it fails them")
    args = parser.parse_args(argv)
    groups = [g for g in args.models.split(",") if g]
    unknown = sorted(set(groups) - set(MODEL_GROUPS))
    if unknown or not groups:
        parser.error("--models: unknown group(s) {}; choose from {}".format(
            unknown, ", ".join(MODEL_GROUPS)))

    device = resolve_device(args.device)
    cfg = llama.PRESETS[args.config]()
    models = []
    if "llama" in groups:
        models.append(LlamaGenerateModel(
            cfg=cfg, max_seq=args.max_seq, seed=args.seed, device=device,
            max_slots=args.max_slots, page_size=args.page_size,
            kv_pages=args.kv_pages, spec_tokens=args.spec_tokens,
            step_timeout_s=args.step_timeout_s, kv_export=args.kv_export,
            target_queue_ms=args.target_queue_ms,
            shed_interval_ms=args.shed_interval_ms,
            fault_scope=args.fault_scope, quantize=args.quantize))
    if "fixtures" in groups:
        models += default_models()
    if "vision" in groups:
        from tpuserver_torch.models.vision import vision_models

        models += vision_models(device=device, seed=args.seed)
    # registered before the warm-up builds the scheduler, whose latency
    # histograms go into the server's registry; not ready until it ends
    core = InferenceServer(models, ready=False, fault_scope=args.fault_scope,
                           role=args.role, spawn_nonce=args.spawn_nonce)
    http = HttpServer(core, host=args.host, port=args.port).start()
    frontends = [http]
    if args.grpc_port is not None:
        from tpuserver_torch.grpc_server import GrpcServer

        grpc_server = GrpcServer(core, host=args.host,
                                 port=args.grpc_port).start()
        frontends.append(grpc_server)  # a collected grpc server stops
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    # a SIGTERM during the warm-up is held until it ends: a drain then
    # would close the model the warm-up is still building
    term = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: term.set())
    core.warmup()
    install_sigterm_drain(core, drain_timeout=args.drain_timeout)
    if term.is_set():
        print("SIGTERM during the warm-up: draining", flush=True)
        core.drain(args.drain_timeout)
    else:
        # a SIGTERM from here on drains on its own thread, and this
        # switch from starting never undoes that drain
        core.mark_ready(undrain=False)
        if "llama" in groups:
            print("serving {} on http://{} ({}, {} weights, max_slots {}, "
                  "role {}, pid {})".format(
                      args.config, http.url, device,
                      "int8" if args.quantize else
                      str(cfg.dtype).split(".")[-1], args.max_slots,
                      args.role or "fused", os.getpid()), flush=True)
        others = [m.name for m in models if m.name != "llama_generate"]
        if others:
            print("serving {} on http://{} ({}, pid {})".format(
                ", ".join(others), http.url, device, os.getpid()),
                flush=True)
        if args.grpc_port is not None:
            print("serving gRPC on {}".format(frontends[-1].url),
                  flush=True)
    while core.server_state() != "stopped" and not stop.wait(0.1):
        pass
    # after a drain every stream has had its last event; only an
    # interrupt still fails live ones (close() ends them in-band)
    core.close()
    for frontend in reversed(frontends):
        frontend.stop(grace=5.0)
    print("stopped", flush=True)


if __name__ == "__main__":
    main()
