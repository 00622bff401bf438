"""End to end: ``python -m tpuserver_torch.perf_analyzer --device cpu``
as a subprocess against the port's in-process server, beside
``tools/perf_analyzer.py --backend inprocess`` on the same flags where the
two are compared.

What is compared, with no tolerance: the JSON rows' keys (equal to each
other and to ``tpuserver_torch.perfanalyzer.report``'s pinned key sets);
the measured numbers are each run's own and are only checked for sense
(positive rates, ordered percentiles, no errors)."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from tpuserver_torch.perfanalyzer.report import (
    CONCURRENCY_ROW_KEYS,
    GENERATION_ROW_KEYS,
)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CLI = os.path.join(REPO, "tools", "perf_analyzer.py")
PORT_CLI = ["-m", "tpuserver_torch.perf_analyzer"]
FAST = ["--measurement-interval", "250", "--max-trials", "6",
        "--warmup", "0.1"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src", "python")
    env["JAX_PLATFORMS"] = "cpu"
    # no card, whatever the host has: the runs say --device cpu, and the
    # run without it must find none
    env["CUDA_VISIBLE_DEVICES"] = ""
    # one intra-op thread per process: tests of other files share the
    # cores
    env["OMP_NUM_THREADS"] = "1"
    return env


def _spawn(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE):
    return subprocess.Popen([sys.executable] + argv, stdout=stdout,
                            stderr=stderr, text=True, env=_env(), cwd=REPO)


def _finish(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    rows = [json.loads(line) for line in out.splitlines()
            if line.startswith('{"')]
    return proc.returncode, out, err, rows


def _both(args):
    """The port's CLI and the JAX tool on the same flags, at once."""
    port = _spawn(PORT_CLI + ["--device", "cpu"] + args)
    jax = _spawn([JAX_CLI, "--backend", "inprocess"] + args)
    return _finish(port), _finish(jax)


def test_concurrency_sweep_on_simple_keys_equal_jax():
    (rc, out, err, rows), (jrc, jout, jerr, jrows) = _both(
        ["-m", "simple", "--concurrency-range", "1:2"] + FAST)
    assert rc == 0, out + err
    assert jrc == 0, jout + jerr
    assert "*** perf_analyzer" in out  # the stdout table
    assert "device: cpu" in out
    assert [r["level"] for r in rows] == [1, 2]
    for row, jrow in zip(rows, jrows):
        assert set(row) == set(jrow) == CONCURRENCY_ROW_KEYS
        assert row["metric"] == jrow["metric"]
        assert row["unit"] == "infer/sec" and row["value"] > 0
        assert row["errors"] == 0
        assert 0 <= row["client_overhead_pct"] <= 100
        assert (row["p50_usec"] <= row["p90_usec"] <= row["p95_usec"]
                <= row["p99_usec"])
        # the fixtures run unbatched: one execution a request
        assert row["server_execution_count"] == row["server_inference_count"]


def test_request_rate_poisson_tracks_the_schedule():
    rc, out, err, rows = _finish(_spawn(
        PORT_CLI + ["--device", "cpu", "-m", "simple",
                    "--request-rate-range", "100",
                    "--request-distribution", "poisson"] + FAST))
    assert rc == 0, out + err
    assert len(rows) == 1
    row = rows[0]
    assert row["mode"] == "request_rate"
    assert set(row) == CONCURRENCY_ROW_KEYS
    # open loop at 100 req/s: the measured rate tracks the schedule, not
    # the server's appetite
    assert 50 < row["value"] < 150
    assert row["p50_usec"] is not None


def _stream_tokens(out):
    """``tokens per stream at level N: {...}`` lines -> {N: {tokens:
    streams}}."""
    got = {}
    for line in out.splitlines():
        if line.startswith("tokens per stream at level "):
            head, _, counts = line.partition(": ")
            got[int(head.rsplit(" ", 1)[1])] = {
                int(k): v for k, v in json.loads(counts).items()}
    return got


def test_generation_on_tiny_llama_every_stream_complete_keys_equal_jax():
    (rc, out, err, rows), (jrc, jout, jerr, jrows) = _both(
        ["-m", "llama_generate", "--generation", "--concurrency-range",
         "2", "--max-tokens", "8", "--measurement-interval", "300",
         "--max-trials", "5", "--warmup", "0.1"])
    assert rc == 0, out + err
    assert jrc == 0, jout + jerr
    assert len(rows) == len(jrows) == 1
    row = rows[0]
    assert set(row) == set(jrows[0]) == GENERATION_ROW_KEYS
    assert row["metric"] == jrows[0]["metric"]
    assert row["unit"] == "tokens/sec" and row["value"] > 0
    assert row["errors"] == 0 and row["generations"] > 0
    assert 0 < row["ttft_p50_ms"] <= row["ttft_p99_ms"]
    assert 0 < row["itl_p50_ms"] <= row["itl_p99_ms"]
    # every stream, warm-up and drain included, returned --max-tokens
    streams = _stream_tokens(out)
    assert list(streams) == [2]
    assert list(streams[2]) == [8] and streams[2][8] >= row["generations"]


def test_import_hygiene_after_a_generation_run_over_cuda_regions():
    """A run through ``main`` in one process (generation with the prompts
    and the token ring in CUDA regions, CPU ones here) leaves none of
    JAX, ``tpuserver``, ``perfanalyzer`` or ``tritonclient`` imported,
    and no region behind."""
    code = (
        "import json, sys\n"
        "from tpuserver_torch import perf_analyzer\n"
        "from tpuserver_torch import cuda_shared_memory as csm\n"
        "rc = perf_analyzer.main(['-m', 'llama_generate', '--device', "
        "'cpu', '--generation', '--concurrency-range', '2', "
        "'--max-tokens', '4', '--measurement-interval', '200', "
        "'--max-trials', '3', '--warmup', '0', '--shared-memory', "
        "'cuda'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpuserver', 'perfanalyzer', 'tritonclient'))\n"
        "print('HYGIENE ' + json.dumps({'rc': rc, 'bad': bad, 'regions': "
        "len(csm.allocated_shared_memory_regions())}))\n")
    rc, out, err, rows = _finish(_spawn(["-c", code]))
    assert rc == 0, out + err
    line = [ln for ln in out.splitlines() if ln.startswith("HYGIENE ")]
    report = json.loads(line[-1][len("HYGIENE "):])
    assert report == {"rc": 0, "bad": [], "regions": 0}
    assert rows and rows[0]["errors"] == 0
    assert list(_stream_tokens(out)[2]) == [4]


def test_no_card_and_no_device_cpu_fails_naming_the_device():
    rc, out, err, rows = _finish(_spawn(
        PORT_CLI + ["-m", "simple", "--concurrency-range", "1"]))
    assert rc != 0
    assert "CUDA device" in err and "device='cpu'" in err
    assert not rows


class _Reader:
    """Drains a pipe on a thread; flags when the settings banner (the
    'measurement is underway' cue) has been printed."""

    def __init__(self, pipe):
        self.lines = []
        self.banner = threading.Event()
        self._thread = threading.Thread(
            target=self._drain, args=(pipe,), daemon=True)
        self._thread.start()

    def _drain(self, pipe):
        for line in pipe:
            self.lines.append(line)
            if "Measurement Settings" in line:
                self.banner.set()

    def text(self):
        self._thread.join(timeout=10)
        return "".join(self.lines)


def test_first_sigint_yields_partial_report_exit_zero():
    # a window far longer than the test: only SIGINT can end it
    proc = _spawn(PORT_CLI + [
        "--device", "cpu", "-m", "simple", "--concurrency-range", "1:8",
        "--measurement-interval", "120000", "--warmup", "0"],
        stderr=subprocess.DEVNULL)
    reader = _Reader(proc.stdout)
    try:
        assert reader.banner.wait(timeout=120), "CLI never started"
        time.sleep(1.0)  # inside the first (huge) window
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    out = reader.text()
    assert rc == 0, out
    rows = [json.loads(line) for line in out.splitlines()
            if line.startswith('{"')]
    # a valid partial report: one measured level, flagged
    assert len(rows) == 1, out
    assert rows[0]["early_exit"] is True
    assert set(rows[0]) == CONCURRENCY_ROW_KEYS | {"early_exit"}
    assert rows[0]["value"] > 0 and rows[0]["p50_usec"] is not None
