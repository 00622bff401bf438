"""Headline benchmark on the port: sync HTTP infer/sec on the `simple`
model, concurrency 1.

    python -m tpuserver_torch.bench [--driver auto|python]

The port's counterpart of the repo's ``bench.py``: the reference's
quick-start measurement (perf_analyzer -m simple, HTTP, concurrency 1 ->
1407.84 infer/sec on the reference's GPU box; reference
docs/quick_start.md:94-108, BASELINE.md) against the port's
``HttpServer`` with the `simple` add/sub model, in this process.  The
driver is the repo's C++ perf_analyzer (built from ``src/c++`` with
``cmake`` and ``ninja`` into ``build/cc``) when the toolchain can build
it, else the port's ``HttpBackend`` through its profiler — a full wire
round trip per request over a real socket either way, measured with the
reference's stability-window methodology.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"p50_usec", "p50_vs_baseline", "driver"}, where ``driver`` is
``"native"`` or ``"python"``.
"""

import argparse
import json
import os
import shutil
import subprocess

from tpuserver_torch.bench_full import BASELINES, profile_simple_http

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _build_cc():
    """The C++ perf_analyzer's path, built from ``src/c++``, or None when
    the toolchain is missing or the build fails."""
    if shutil.which("cmake") is None or shutil.which("ninja") is None:
        return None
    build = os.path.join(REPO, "build", "cc")
    try:
        subprocess.run(
            ["cmake", "-S", os.path.join(REPO, "src", "c++"), "-B", build,
             "-G", "Ninja"],
            check=True, capture_output=True, timeout=300,
        )
        subprocess.run(
            ["ninja", "-C", build, "perf_analyzer"],
            check=True, capture_output=True, timeout=600,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    path = os.path.join(build, "perf_analyzer")
    return path if os.path.exists(path) else None


def _native_once(perf_analyzer, url, window_ms):
    """One perf_analyzer run; returns (infer/sec, p50_usec) or None."""
    csv_path = os.path.join(REPO, "build", "bench_simple_torch.csv")
    result = subprocess.run(
        [perf_analyzer, "-m", "simple", "-u", url, "-p", str(window_ms),
         "--max-trials", "10", "-f", csv_path],
        capture_output=True, text=True, timeout=180,
    )
    if result.returncode != 0:
        return None
    with open(csv_path) as f:
        lines = f.read().strip().splitlines()
    if len(lines) < 2:
        return None
    cols = lines[1].split(",")
    return float(cols[1]), float(cols[9])


def _bench_native(perf_analyzer, url):
    """Median of 5 measured runs after a warmup pass: 3 s windows, each
    run to the reference's stability (3 windows within +-10%)."""
    if _native_once(perf_analyzer, url, 1000) is None:  # warmup/smoke
        return None
    runs = []
    for _ in range(5):
        r = _native_once(perf_analyzer, url, 3000)
        if r is not None:
            runs.append(r)
    if len(runs) < 3:
        return None
    rates = sorted(r[0] for r in runs)
    p50s = sorted(r[1] for r in runs)
    return rates[len(rates) // 2], p50s[len(p50s) // 2]


def _bench_python(url):
    """Config 1's measurement (``bench_full.profile_simple_http``): 1.5 s
    windows to 3-window stability, at most 10 of them."""
    res = profile_simple_http(url, 1.5, 3, 10, 0.5)
    return res["throughput"], res["p50_usec"]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m tpuserver_torch.bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--driver", default="auto", choices=["auto", "python"],
                    help="auto: the C++ perf_analyzer when it builds, "
                         "else the Python driver")
    args = ap.parse_args(argv)

    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.http_server import HttpServer
    from tpuserver_torch.models import default_models

    core = InferenceServer(default_models())
    frontend = HttpServer(core, port=0).start()
    url = "127.0.0.1:{}".format(frontend.port)
    try:
        measured, driver = None, "python"
        if args.driver == "auto":
            perf_analyzer = _build_cc()
            if perf_analyzer is not None:
                measured, driver = _bench_native(perf_analyzer, url), "native"
        if measured is None:
            measured, driver = _bench_python(url), "python"
        value, p50_usec = measured
        print(json.dumps({
            "metric": "simple_http_sync_conc1_infer_per_sec",
            "value": round(value, 2),
            "unit": "infer/sec",
            "vs_baseline": round(value / BASELINES["simple_http"], 4),
            "p50_usec": round(p50_usec, 1),
            "p50_vs_baseline": round(
                p50_usec / BASELINES["simple_http_p50"], 4),
            "driver": driver,
        }), flush=True)
    finally:
        frontend.stop()
        core.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
