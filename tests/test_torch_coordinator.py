"""The port's distributed perf analyzer coordinator
(``tpuserver_torch.perfanalyzer.coordinator``) and its per-window CSV
(``ReportWriter.write_window_csv``) against the JAX package's.

- the merge math equals JAX's key for key on seeded synthetic windows
  (scalar and generation workers), and the merged completions are the
  sum of the workers';
- the barrier keeps every worker's windows aligned, and a dead worker
  surfaces as a ``RuntimeError`` naming it;
- the newline-JSON protocol interoperates: the port's coordinator with
  JAX workers and JAX's coordinator with the port's, byte for byte the
  same messages;
- the per-window CSV is byte-identical to JAX's for the same rows."""

import json
import socket
import threading
import time

import numpy as np
import pytest

from perfanalyzer import coordinator as jax_coordinator
from perfanalyzer.report import ReportWriter as JaxReportWriter
from tpuserver_torch.perfanalyzer import coordinator
from tpuserver_torch.perfanalyzer.report import (
    WINDOW_CSV_COLUMNS,
    ReportWriter,
)

pytestmark = pytest.mark.torch_port

PACKAGES = {"port": coordinator, "jax": jax_coordinator}


def _synthetic_workers(seed, n_workers, generation):
    """``n_workers`` window results drawn from ``seed``: raw latencies
    of differing spreads, and for generation workers TTFT/ITL samples
    and stream counters."""
    rng = np.random.RandomState(seed)
    results = []
    for w in range(n_workers):
        n = int(rng.randint(1, 40))
        result = {
            "completed": n, "errors": int(rng.randint(0, 3)),
            "duration_s": float(1.0 + rng.rand() * 0.05),
            "latencies_s": [float(x) for x in
                            rng.lognormal(-5 + w, 0.5, size=n)],
            "tokens": int(rng.randint(0, 500)) if generation else 0,
        }
        if generation:
            result["latencies_s"] = []
            result["ttfts_s"] = [float(x) for x in rng.rand(n)]
            result["itls_s"] = [float(x) for x in rng.rand(3 * n) / 50]
            result["generations"] = n
            result["resumed_streams"] = int(rng.randint(0, 2))
            result["resume_events"] = int(rng.randint(0, 3))
        results.append(result)
    return results


@pytest.mark.parametrize("generation", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merges_equal_jax_key_for_key(seed, generation):
    windows = [_synthetic_workers(seed * 10 + k, 3, generation)
               for k in range(3)]
    rows = [coordinator.merge_worker_windows(w) for w in windows]
    jax_rows = [jax_coordinator.merge_worker_windows(w) for w in windows]
    for row, jrow, workers in zip(rows, jax_rows, windows):
        assert row == jrow
        assert row["completed"] == sum(r["completed"] for r in workers)
        assert row["workers"] == 3
    merged = coordinator.merge_windows(rows)
    assert merged == jax_coordinator.merge_windows(jax_rows)
    assert merged["completed"] == sum(
        r["completed"] for w in windows for r in w)
    assert merged["windows"] == 3
    assert ("ttfts_s" in merged) == generation


def _thread_worker(package, address, worker_id, delay_s, spans, lock):
    channel = package.WorkerChannel(address, worker_id)

    def run_window(duration_s, index):
        start = time.monotonic()
        time.sleep(delay_s)
        end = time.monotonic()
        with lock:
            spans.append((worker_id, index, start, end))
        return {"completed": worker_id + 1, "errors": 0,
                "duration_s": delay_s,
                "latencies_s": [0.001 * (worker_id + 1)]}

    try:
        channel.serve(run_window)
    finally:
        channel.close()


@pytest.mark.parametrize("parent,child", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_barrier_keeps_windows_aligned_across_packages(parent, child):
    """Window k+1 starts on no worker before every worker finished
    window k, whichever package drives and whichever answers."""
    coord = PACKAGES[parent].Coordinator(
        workers=2, result_timeout_s=30.0).listen()
    spans, lock = [], threading.Lock()
    threads = [threading.Thread(
        target=_thread_worker,
        args=(PACKAGES[child], coord.address, i, 0.05 * (i + 1), spans,
              lock), daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    try:
        coord.wait_for_workers(timeout_s=30.0)
        rows = coord.run_windows(windows=3, window_s=0.05)
    finally:
        coord.shutdown()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(rows) == 3
    for row in rows:
        assert row["workers"] == 2
        assert row["completed"] == 3  # 1 + 2: the sum of the workers'
        assert row["duration_s"] == pytest.approx(0.10)
    by_index = {}
    for _worker, index, start, end in spans:
        by_index.setdefault(index, []).append((start, end))
    for index in range(2):
        latest_end = max(end for _, end in by_index[index])
        earliest_next = min(start for start, _ in by_index[index + 1])
        assert earliest_next >= latest_end


def test_a_dead_worker_surfaces_naming_it():
    coord = coordinator.Coordinator(workers=1, result_timeout_s=5.0).listen()

    def worker():
        channel = coordinator.WorkerChannel(coord.address, 0)
        channel._reader.recv(10.0)  # the start_window, then die
        channel.close()

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        coord.wait_for_workers(timeout_s=10.0)
        with pytest.raises(RuntimeError, match="worker 0"):
            coord.run_window(0, 0.05)
    finally:
        coord.shutdown()
    thread.join(timeout=10)


def _wire(package, worker_id, window_result):
    """Every byte a package's coordinator and worker put on the wire for
    one window and a shutdown, as (parent's bytes, worker's bytes), read
    by a raw socket on the other end of each."""
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    host, port = listener.getsockname()
    seen = {}

    def worker_side():
        channel = package.WorkerChannel(
            "{}:{}".format(host, port), worker_id)
        channel.serve(lambda duration_s, index: dict(window_result))
        channel.close()

    thread = threading.Thread(target=worker_side, daemon=True)
    thread.start()
    conn, _ = listener.accept()
    conn.settimeout(10)
    try:
        conn.sendall(b'{"type": "start_window", "window": 0, '
                     b'"duration_s": 0.5}\n')
        buf = b""
        while buf.count(b"\n") < 2:
            buf += conn.recv(65536)
        conn.sendall(b'{"type": "shutdown"}\n')
        seen["worker"] = buf
    finally:
        thread.join(timeout=10)
        conn.close()
        listener.close()

    coord = package.Coordinator(workers=1, result_timeout_s=10.0).listen()
    sock = socket.create_connection(coord.address.rsplit(":", 1))
    try:
        sock.sendall(b'{"type": "hello", "worker": 0}\n')
        coord.wait_for_workers(timeout_s=10.0)
        result = {}

        def drive():
            result["row"] = coord.run_window(0, 0.5)

        driver = threading.Thread(target=drive, daemon=True)
        driver.start()
        sock.settimeout(10)
        buf = b""
        while b"\n" not in buf:
            buf += sock.recv(65536)
        payload = dict(window_result, type="window_result", window=0)
        sock.sendall((json.dumps(payload) + "\n").encode("utf-8"))
        driver.join(timeout=10)
        coord.shutdown()
        while buf.count(b"\n") < 2:
            chunk = sock.recv(65536)
            if not chunk:
                break
            buf += chunk
        seen["parent"] = buf
    finally:
        sock.close()
    return seen["parent"], seen["worker"]


def test_wire_bytes_equal_jax():
    result = {"completed": 2, "errors": 0, "duration_s": 0.5,
              "latencies_s": [0.001, 0.002], "tokens": 0}
    assert _wire(coordinator, 3, result) == _wire(jax_coordinator, 3,
                                                  result)


def test_window_csv_byte_identical_to_jax(tmp_path):
    windows = [coordinator.merge_worker_windows(
        _synthetic_workers(k, 2, generation=False)) for k in range(3)]
    for w in windows:
        w["concurrency"] = 4
    windows[1]["tokens_per_sec"] = 12.5
    path, jax_path = tmp_path / "port.csv", tmp_path / "jax.csv"
    ReportWriter("stub", "http-x2").write_window_csv(str(path), windows)
    JaxReportWriter("stub", "http-x2").write_window_csv(str(jax_path),
                                                        windows)
    assert path.read_bytes() == jax_path.read_bytes()
    header = path.read_text().splitlines()[0].split(",")
    assert header == [h for h, _ in WINDOW_CSV_COLUMNS]
    assert len(path.read_text().splitlines()) == 1 + len(windows)
