"""The port's distributed perf analyzer (``python -m
tpuserver_torch.perf_analyzer --workers N``) beside the JAX tool's
(``tools/perf_analyzer.py --workers N``) on the same arguments:

- two workers pinned by ``--urls`` to two ``tests/fleet_stub.py``
  replicas: one merged row whose keys equal the JAX tool's, throughput
  the merged completions over the synchronized windows, and a
  ``--report-csv`` with the JAX tool's header, one row a window;
- generation mode against the port's HTTP server on float32 ``tiny``:
  the JAX tool's row keys, tokens and generations, no error;
- ``--shared-memory system`` workers register regions on the port's
  server and leave none behind, registered or under ``/dev/shm``;
- the four refusals exit as the JAX tool's, with its messages, and
  ``--urls`` without ``--workers`` exits 2 naming the client-side tool.

The numbers are each run's own and are checked only for sense."""

import contextlib
import csv
import dataclasses
import io
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from tpuserver_torch import perf_analyzer
from tpuserver_torch.chaos_campaign import free_port, wait_ready
from tpuserver_torch.core import InferenceServer
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import default_models
from tpuserver_torch.models import llama as tl
from tpuserver_torch.models.llama_serving import LlamaGenerateModel
from tpuserver_torch.perfanalyzer.report import WINDOW_CSV_COLUMNS

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from torch_port_helpers import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

JAX_CLI = os.path.join(REPO, "tools", "perf_analyzer.py")
STUB = os.path.join(HERE, "fleet_stub.py")
FAST = ["--windows", "3", "--measurement-interval", "250", "--warmup",
        "0.2"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src", "python")
    env["JAX_PLATFORMS"] = "cpu"
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    return env


def _both(args, tmp_path):
    """The port's CLI and the JAX tool on ``args`` at once, each with a
    ``--report-csv`` of its own: per side (exit code, stdout, stderr,
    rows, the CSV's lines)."""
    procs = {}
    for side, head in (("port", ["-m", "tpuserver_torch.perf_analyzer"]),
                       ("jax", [JAX_CLI])):
        path = str(tmp_path / (side + ".csv"))
        procs[side] = (path, subprocess.Popen(
            [sys.executable] + head + args + ["--report-csv", path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(), cwd=REPO))
    out = {}
    for side, (path, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=240)
        rows = [json.loads(line) for line in stdout.splitlines()
                if line.startswith('{"')]
        lines = []
        if os.path.exists(path):
            with open(path, newline="") as fh:
                lines = list(csv.reader(fh))
        out[side] = (proc.returncode, stdout, stderr, rows, lines)
    return out


def _check_csv(lines, level):
    header, data = lines[0], lines[1:]
    assert header == [h for h, _ in WINDOW_CSV_COLUMNS]
    assert len(data) == 3
    for row in data:
        assert int(row[0]) == level
        assert float(row[1]) > 0


@pytest.fixture(scope="module")
def stubs():
    """Two stub replicas: their urls."""
    ports = [free_port() for _ in range(2)]
    procs = [subprocess.Popen([sys.executable, STUB, "--port", str(p),
                               "--infer-delay-ms", "1"],
                              stdout=subprocess.DEVNULL, env=_env())
             for p in ports]
    try:
        for p in ports:
            assert wait_ready(p), "stub replica never became ready"
        yield ["127.0.0.1:{}".format(p) for p in ports]
    finally:
        for proc in procs:
            proc.kill()
            proc.wait(timeout=10)


@pytest.fixture(scope="module")
def server():
    """The port's HTTP server on the CPU: the fixture models and a
    float32 ``tiny`` llama behind four slots.  Yields (core, url)."""
    cfg = dataclasses.replace(tl.tiny(vocab=256), dtype=torch.float32)
    model = LlamaGenerateModel(cfg=cfg, max_seq=64, max_slots=4,
                               device="cpu")
    core = InferenceServer(default_models() + [model])
    model.warmup()
    http = HttpServer(core, port=0).start()
    try:
        yield core, "127.0.0.1:{}".format(http.port)
    finally:
        http.stop()
        core.close()


def test_two_workers_over_urls_match_the_jax_tool(stubs, tmp_path):
    args = ["-m", "stub", "--backend", "http", "--urls", ",".join(stubs),
            "--workers", "2", "--concurrency-range", "2"] + FAST
    out = _both(args, tmp_path)
    for side, (rc, stdout, stderr, rows, lines) in out.items():
        assert rc == 0, (side, stdout, stderr)
        assert len(rows) == 1, (side, rows)  # ONE merged report
        row = rows[0]
        assert row["mode"] == "distributed_concurrency"
        assert row["workers"] == 2 and row["level"] == 4
        assert row["windows"] == 3 and row["trials"] == 3
        assert row["errors"] == 0 and row["completed"] > 0
        # fleet throughput: the merged completions over the windows
        assert row["value"] == pytest.approx(
            row["completed"] / row["duration_s"], rel=0.01)
        assert row["p50_usec"] <= row["p90_usec"] <= row["p99_usec"]
        _check_csv(lines, 4)
    port_row, jax_row = out["port"][3][0], out["jax"][3][0]
    assert set(port_row) == set(jax_row)
    assert port_row["metric"] == jax_row["metric"]
    assert out["port"][4][0] == out["jax"][4][0]


def test_generation_workers_on_the_port_server_match_the_jax_tool(
        server, tmp_path):
    _core, url = server
    args = ["-m", "llama_generate", "--backend", "http", "-u", url,
            "--generation", "--prompt-len", "8", "--max-tokens", "8",
            "--workers", "2", "--concurrency-range", "1"] + FAST
    out = _both(args, tmp_path)
    for side, (rc, stdout, stderr, rows, lines) in out.items():
        assert rc == 0, (side, stdout, stderr)
        assert len(rows) == 1, (side, rows)
        row = rows[0]
        assert row["mode"] == "distributed_generation"
        assert row["unit"] == "tokens/sec" and row["value"] > 0
        assert row["tokens"] > 0 and row["generations"] > 0
        assert row["errors"] == 0
        assert row["ttft_p50_ms"] <= row["ttft_p99_ms"]
        _check_csv(lines, 2)
    assert set(out["port"][3][0]) == set(out["jax"][3][0])
    assert out["port"][4][0] == out["jax"][4][0]


def test_system_shm_workers_leave_no_region(server, tmp_path):
    core, url = server
    keys = []
    register = core.register_system_shm

    def recording(name, key, offset, byte_size):
        keys.append(key)
        return register(name, key, offset, byte_size)

    core.register_system_shm = recording
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "tpuserver_torch.perf_analyzer",
             "-m", "simple", "--backend", "http", "-u", url,
             "--shared-memory", "system", "--workers", "2",
             "--concurrency-range", "2"] + FAST,
            capture_output=True, text=True, env=_env(), cwd=REPO,
            timeout=240)
    finally:
        core.register_system_shm = register
    assert proc.returncode == 0, proc.stdout + proc.stderr
    row = [json.loads(line) for line in proc.stdout.splitlines()
           if line.startswith('{"')][0]
    assert row["errors"] == 0 and row["completed"] > 0
    # each worker registered its own tagged regions, one per input
    assert sorted({k.split("_")[1] for k in keys}) == ["w0", "w1"]
    assert len(keys) == 4
    assert not core.system_shm_status()
    assert not [k for k in keys if os.path.exists("/dev/shm" + k)]


REFUSALS = {
    "request_rate": ["--request-rate-range", "10"],
    "generation_shm": ["--generation", "--shared-memory", "system"],
    "grpc": ["--backend", "grpc"],
    "sweep": ["--concurrency-range", "1:4"],
}


def _jax_main():
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_perf_analyzer",
                                                  JAX_CLI)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_exit_as_the_jax_tool(case):
    argv = (["-m", "simple", "--backend", "http", "-u", "127.0.0.1:9",
             "--workers", "2"] + REFUSALS[case])
    previous = signal.getsignal(signal.SIGINT)
    exits = {}
    try:
        for side, main in (("port", perf_analyzer.main),
                           ("jax", _jax_main())):
            with pytest.raises(SystemExit) as info:
                main(list(argv))
            exits[side] = info.value.code
    finally:
        signal.signal(signal.SIGINT, previous)
    assert exits["port"] == exits["jax"]
    assert isinstance(exits["port"], str)  # a message: exit code 1


def test_urls_without_workers_exits_2_naming_the_client_tool(stubs):
    err = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stderr(err):
        rc = perf_analyzer.main(["-m", "stub", "--backend", "http",
                                 "--urls", ",".join(stubs)])
    assert rc == 2
    assert "tools/perf_analyzer.py --backend pool" in err.getvalue()
    assert time.monotonic() - t0 < 5  # refused before any load
