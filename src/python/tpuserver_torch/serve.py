"""Serve llama generation from the port over HTTP, and over gRPC too.

    python -m tpuserver_torch.serve --config llama3_8b --max-seq 4096 \\
        --port 8000 [--grpc-port 8001] [--device cuda] [--seed 0] \\
        [--max-slots 8 [--page-size 16] [--kv-pages N] [--spec-tokens K]
        [--step-timeout-s S] [--kv-export] [--target-queue-ms MS
        [--shed-interval-ms MS]]] [--fault-scope NAME]

Weights are random, drawn from ``--seed`` on the device.  With
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
``TPUSERVER_FAULTS`` environment variable arms at start.  The server
runs until interrupted (SIGINT/SIGTERM).
"""

import argparse
import signal
import threading

from tpuserver_torch import resolve_device
from tpuserver_torch.core import InferenceServer
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import llama
from tpuserver_torch.models.llama_serving import LlamaGenerateModel


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
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    model = LlamaGenerateModel(cfg=llama.PRESETS[args.config](),
                               max_seq=args.max_seq, seed=args.seed,
                               device=device, max_slots=args.max_slots,
                               page_size=args.page_size,
                               kv_pages=args.kv_pages,
                               spec_tokens=args.spec_tokens,
                               step_timeout_s=args.step_timeout_s,
                               kv_export=args.kv_export,
                               target_queue_ms=args.target_queue_ms,
                               shed_interval_ms=args.shed_interval_ms,
                               fault_scope=args.fault_scope)
    # registered before the warm-up builds the scheduler, whose latency
    # histograms go into the server's registry
    core = InferenceServer([model], fault_scope=args.fault_scope)
    model.warmup()
    http = HttpServer(core, host=args.host, port=args.port).start()
    frontends = [http]
    print("serving {} on http://{} ({}, max_slots {})".format(
        args.config, http.url, device, args.max_slots), flush=True)
    if args.grpc_port is not None:
        from tpuserver_torch.grpc_server import GrpcServer

        grpc_server = GrpcServer(core, host=args.host,
                                 port=args.grpc_port).start()
        frontends.append(grpc_server)  # a collected grpc server stops
        print("serving gRPC on {}".format(grpc_server.url), flush=True)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    for frontend in reversed(frontends):
        frontend.stop()
    core.close()


if __name__ == "__main__":
    main()
