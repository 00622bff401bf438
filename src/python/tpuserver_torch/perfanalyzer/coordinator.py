"""Distributed multi-process perfanalyzer coordination.

The port's copy of ``perfanalyzer/coordinator.py``, the Python port of
the reference's optional MPI driver (``MPIDriver``, mpi_utils.h:32-83,
used at perf_analyzer.cc:353-368): one parent coordinator forks N
perf_analyzer *worker processes* — each pinned to a replica, or all
driving one fleet router — and runs **barrier-synchronized measurement
windows** over a localhost socket control channel (the
``MPI_Barrier``-around-``Profile`` analog with no libmpi).  One process
can saturate neither a fleet nor its own GIL; N processes measuring the
SAME wall-clock window can, and their merged report is the number the
single process cannot produce.

Protocol (newline-delimited JSON over one TCP connection per worker),
byte for byte the JAX package's, so a worker of either package reports
to a coordinator of the other:

    worker -> parent   {"type": "hello", "worker": i}
    parent -> workers  {"type": "start_window", "window": k,
                        "duration_s": w}          # the barrier release
    worker -> parent   {"type": "window_result", "window": k,
                        "completed": n, "errors": e, "duration_s": d,
                        "latencies_s": [...], "tokens": t}
                       # tokens: 0 from scalar workers; generation
                       # workers fill it and add ttfts_s / itls_s /
                       # generations / resumed_streams / resume_events
    parent -> workers  {"type": "shutdown"}

The parent broadcasts ``start_window`` only after every worker's
previous ``window_result`` arrived — that gather+broadcast IS the
barrier, so every worker's window k covers the same wall-clock span.
Workers keep their load loops running *between* windows (windows gate
measurement, not load).

**Merge raw samples, never average percentiles**
(:func:`merge_worker_windows` concatenates every worker's raw latency
records before computing p50/p90/p95/p99), and fleet throughput is the
*sum of worker completions* over the synchronized window.

``python -m tpuserver_torch.perf_analyzer --workers N`` is the CLI front
door.  This module imports only the standard library and the port's
``perfanalyzer.metrics``.
"""

import json
import socket
import time

from tpuserver_torch.perfanalyzer import metrics

__all__ = [
    "Coordinator",
    "WorkerChannel",
    "merge_worker_windows",
    "merge_windows",
    "reap_workers",
]


def _send_json(sock, obj):
    sock.sendall((json.dumps(obj) + "\n").encode("utf-8"))


class _LineReader:
    """Newline-delimited JSON reader over one socket."""

    def __init__(self, sock):
        self._sock = sock
        self._buf = b""

    def recv(self, timeout_s):
        self._sock.settimeout(timeout_s)
        while b"\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("control channel closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        return json.loads(line)


# -- merge math (pure, clock-free — the unit-pinned part) -------------------


def merge_worker_windows(worker_results):
    """Merge one synchronized window's per-worker results into the
    fleet-level window row.

    ``worker_results`` is a list of dicts carrying ``completed``,
    ``errors``, ``duration_s``, ``latencies_s`` (raw per-request
    seconds) and optionally ``tokens``.  Fleet throughput is the SUM
    of worker completions over the synchronized window span (the
    longest worker duration — the barrier released them together, so
    the spans coincide up to scheduling jitter); latency percentiles
    come from the POOLED raw samples, never from averaging per-worker
    percentiles (reference MergePerfStatusReports semantics)."""
    latencies = [lat for r in worker_results
                 for lat in r.get("latencies_s", [])]
    completed = sum(int(r.get("completed", 0)) for r in worker_results)
    errors = sum(int(r.get("errors", 0)) for r in worker_results)
    tokens = sum(int(r.get("tokens", 0)) for r in worker_results)
    duration = max(
        (float(r.get("duration_s", 0.0)) for r in worker_results),
        default=0.0)
    row = {
        "workers": len(worker_results),
        "completed": completed,
        "errors": errors,
        "tokens": tokens,
        "duration_s": duration,
        "throughput": completed / duration if duration > 0 else 0.0,
        "latencies_s": latencies,
    }
    row.update(metrics.latency_summary(latencies))
    # generation-mode workers additionally ship raw TTFT/ITL samples
    # and stream counters; pool/sum them under the same raw-samples
    # rule so the parent can compute fleet token percentiles
    if any("ttfts_s" in r or "generations" in r for r in worker_results):
        row["ttfts_s"] = [t for r in worker_results
                          for t in r.get("ttfts_s", [])]
        row["itls_s"] = [t for r in worker_results
                         for t in r.get("itls_s", [])]
        for key in ("generations", "resumed_streams", "resume_events"):
            row[key] = sum(int(r.get(key, 0)) for r in worker_results)
    return row


def merge_windows(window_rows):
    """Collapse the per-window merged rows into ONE report sample:
    total completions over total duration, percentiles over every raw
    record of every window (same math as the single-process
    profiler's 3-window merge, across the whole run)."""
    latencies = [lat for w in window_rows
                 for lat in w.get("latencies_s", [])]
    duration = sum(w.get("duration_s", 0.0) for w in window_rows)
    completed = sum(w.get("completed", 0) for w in window_rows)
    merged = {
        "completed": completed,
        "errors": sum(w.get("errors", 0) for w in window_rows),
        "tokens": sum(w.get("tokens", 0) for w in window_rows),
        "duration_s": duration,
        "throughput": completed / duration if duration > 0 else 0.0,
        "windows": len(window_rows),
    }
    merged.update(metrics.latency_summary(latencies))
    if any("ttfts_s" in w or "generations" in w for w in window_rows):
        merged["ttfts_s"] = [t for w in window_rows
                             for t in w.get("ttfts_s", [])]
        merged["itls_s"] = [t for w in window_rows
                            for t in w.get("itls_s", [])]
        for key in ("generations", "resumed_streams", "resume_events"):
            merged[key] = sum(int(w.get(key, 0)) for w in window_rows)
    return merged


# -- the parent --------------------------------------------------------------


class Coordinator:
    """The parent side: listen, admit N workers, drive the barrier.

    Use as::

        coord = Coordinator(workers=2).listen()
        procs = [spawn(argv + ["--worker-connect", coord.address,
                               "--worker-id", str(i)]) ...]
        coord.wait_for_workers(timeout_s=60)
        window_rows = coord.run_windows(windows=3, window_s=2.0)
        coord.shutdown()

    Every worker failure surfaces as a raised ``RuntimeError`` naming
    the worker — a silent partial fleet would report numbers that look
    like the whole fleet's.
    """

    def __init__(self, workers, host="127.0.0.1", port=0,
                 result_timeout_s=120.0):
        if workers < 1:
            raise ValueError("need at least one worker")
        self._want = int(workers)
        self._result_timeout_s = float(result_timeout_s)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(
            socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._conns = []    # (worker_id, sock, reader), hello order
        self._listening = False

    def listen(self):
        self._listener.listen(self._want)
        self._listening = True
        return self

    @property
    def address(self):
        host, port = self._listener.getsockname()
        return "{}:{}".format(host, port)

    def wait_for_workers(self, timeout_s=60.0):
        """Accept connections until every worker said hello."""
        if not self._listening:
            self.listen()
        deadline = time.monotonic() + float(timeout_s)
        while len(self._conns) < self._want:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise RuntimeError(
                    "only {}/{} workers connected within {}s".format(
                        len(self._conns), self._want, timeout_s))
            self._listener.settimeout(remaining)
            try:
                sock, _addr = self._listener.accept()
            except socket.timeout:
                continue
            reader = _LineReader(sock)
            hello = reader.recv(min(10.0, remaining))
            if hello.get("type") != "hello":
                sock.close()
                raise RuntimeError(
                    "worker handshake sent {!r}, not hello".format(hello))
            self._conns.append((int(hello.get("worker", -1)), sock, reader))

    def _broadcast(self, obj):
        for _wid, sock, _reader in self._conns:
            _send_json(sock, obj)

    def run_window(self, index, window_s):
        """One barrier-synchronized window: broadcast the release,
        gather every worker's result, merge.  The broadcast happens
        only once the previous gather completed, so all N windows
        cover the same wall-clock span."""
        self._broadcast({"type": "start_window", "window": index,
                         "duration_s": window_s})
        results = []
        for wid, _sock, reader in self._conns:
            try:
                msg = reader.recv(self._result_timeout_s + window_s)
            except (ConnectionError, socket.timeout, OSError) as e:
                raise RuntimeError(
                    "worker {} died mid-window {}: {}".format(
                        wid, index, e))
            if msg.get("type") != "window_result" or \
                    msg.get("window") != index:
                raise RuntimeError(
                    "worker {} answered window {} with {!r}".format(
                        wid, index, msg))
            results.append(msg)
        return merge_worker_windows(results)

    def run_windows(self, windows, window_s):
        return [self.run_window(i, window_s) for i in range(windows)]

    def shutdown(self):
        try:
            self._broadcast({"type": "shutdown"})
        except OSError:
            pass
        for _wid, sock, _reader in self._conns:
            try:
                sock.close()
            except OSError:
                pass
        self._conns = []
        self._listener.close()


# -- the worker --------------------------------------------------------------


class WorkerChannel:
    """The worker side of the control channel: connect, say hello,
    then serve barrier windows until shutdown.

    ``run_window_fn(duration_s, index)`` must return the window-result
    payload fields (``completed``/``errors``/``duration_s``/
    ``latencies_s``/optionally ``tokens``); this class owns only the
    framing.
    """

    def __init__(self, address, worker_id, connect_timeout_s=30.0):
        host, sep, port = address.rpartition(":")
        if not sep:
            raise ValueError(
                "coordinator address must be host:port (got {!r})"
                .format(address))
        self.worker_id = int(worker_id)
        self._sock = socket.create_connection(
            (host, int(port)), timeout=connect_timeout_s)
        self._reader = _LineReader(self._sock)
        _send_json(self._sock, {"type": "hello", "worker": self.worker_id})

    def serve(self, run_window_fn, idle_timeout_s=600.0):
        """Window loop; returns the number of windows served."""
        served = 0
        while True:
            msg = self._reader.recv(idle_timeout_s)
            kind = msg.get("type")
            if kind == "shutdown":
                return served
            if kind != "start_window":
                raise RuntimeError(
                    "unexpected control message {!r}".format(msg))
            index = int(msg.get("window", served))
            result = run_window_fn(
                float(msg.get("duration_s", 1.0)), index)
            payload = {"type": "window_result", "window": index}
            payload.update(result)
            _send_json(self._sock, payload)
            served += 1

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


# -- worker-process plumbing -------------------------------------------------


def reap_workers(procs, timeout_s=30.0):
    """Join every worker process; kill stragglers past the deadline.
    Returns the list of exit codes."""
    import subprocess

    deadline = time.monotonic() + float(timeout_s)
    codes = []
    for proc in procs:
        remaining = max(0.0, deadline - time.monotonic())
        try:
            codes.append(proc.wait(timeout=remaining))
        except subprocess.TimeoutExpired:
            proc.kill()
            try:
                codes.append(proc.wait(timeout=5))
            except subprocess.TimeoutExpired:
                codes.append(None)
    return codes
