"""Serve llama generation from the port over HTTP.

    python -m tpuserver_torch.serve --config llama3_8b --max-seq 4096 \\
        --port 8000 [--device cuda] [--seed 0]

Weights are random, drawn from ``--seed`` on the device.  The server
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
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    model = LlamaGenerateModel(cfg=llama.PRESETS[args.config](),
                               max_seq=args.max_seq, seed=args.seed,
                               device=device)
    model.warmup()
    core = InferenceServer([model])
    http = HttpServer(core, host=args.host, port=args.port).start()
    print("serving {} on http://{} ({})".format(
        args.config, http.url, device), flush=True)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    http.stop()
    core.close()


if __name__ == "__main__":
    main()
