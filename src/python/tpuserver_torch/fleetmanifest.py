"""Fleet-state manifest: crash durability for the supervisor itself.

The port's copy of ``tpuserver.fleetmanifest``, its format
byte-identical, so either package's supervisor adopts a fleet the
other's manifest records.  The journal (journal.py) makes the ROUTER
tier crash-durable; without this manifest the supervisor is an
unsupervised singleton with amnesia — SIGKILL it and the
fleet silently stops healing, restart it and it respawns a perfectly
healthy fleet from scratch, burning restart budgets and cache warmth
for nothing.  This module records everything a SUCCESSOR supervisor
needs to *adopt* the running fleet instead:

- ``spawn``          — one replica spawn: index, role, port, scope,
  pid + process start-time identity token, argv template hash, and
  the spawn nonce the child advertises in ``/v2/health/stats``.
- ``restart`` / ``retire`` — the restart-budget window state (sliding
  ``restart_times``; CLOCK_MONOTONIC is system-wide on Linux, so the
  raw timestamps stay comparable across supervisor processes).
- ``scale``          — elastic up/down membership changes.
- ``router_spawn`` / ``router_restart`` / ``router_retire`` /
  ``promote`` — the supervised front tier's twin records (role swaps
  by stable port).
- ``config``         — fleet-level facts with no per-process home
  (the router journal directory a successor must RE-ATTACH).
- ``checkpoint``     — a full-state snapshot; the writer compacts on
  every checkpoint (fresh segment seeded with the snapshot, older
  segments pruned), so replay cost stays bounded.

**Wire format** — byte-identical to ``journal.py``: each record is
framed ``<u32 length><u32 crc32>`` + UTF-8 JSON, and recovery is
torn-tail-tolerant (a half-written final record truncates, never
fatal).  The framing/recovery helpers are imported from journal.py
rather than re-implemented, so the two logs can never drift.

**Adoption contract** (``FleetSupervisor`` start with a manifest):
a recorded child is claimed only when THREE independent identities
agree — the pid is alive AND its ``/proc`` start-time token matches
the record (pid reuse cannot forge this) AND its health snapshot
echoes the recorded spawn nonce (a foreign server squatting the port
cannot forge this).  :class:`AdoptedProcess` then wraps the non-child
pid with a ``subprocess.Popen``-shaped surface (``poll`` via the
start token — a zombie or recycled pid reads as exited; ``wait`` by
polling, since ``waitpid`` only works on children).

**Single-writer discipline**: an exclusive ``flock`` on
``<dir>/lock`` — two supervisors can NEVER both heal one fleet.  The
second comer gets a typed :class:`ManifestLocked` refusal (or waits,
with ``--takeover``); the kernel drops the lock the instant the
holder dies, so a SIGKILLed supervisor never wedges its successor.

The writer thread mirrors the journal writer's hot-path contract:
``append`` is one lock-free deque append; framing, I/O, fsync, and
compaction all happen on the (daemon AND joined — tpulint R5's
writer-thread companion check) ``fleet-manifest-writer`` thread.

See docs/resilience.md "Supervisor crash durability".
"""

import binascii
import fcntl
import json
import os
import signal
import subprocess
import threading
import time
import zlib
from collections import deque

from tpuserver_torch.journal import (  # the SAME framing + recovery
    _FRAME, _list_segments, read_journal)

__all__ = [
    "AdoptedProcess",
    "ManifestLocked",
    "ManifestWriter",
    "acquire_manifest_lock",
    "argv_template_hash",
    "fold_manifest",
    "new_spawn_nonce",
    "process_start_token",
    "read_manifest",
    "release_manifest_lock",
]

#: counters a checkpoint snapshots and incremental records replay over
COUNTER_KEYS = (
    "replica_restarts", "scale_up_events", "scale_down_events",
    "retired_replicas", "router_restarts", "router_takeovers",
    "router_retired", "adoptions", "clean_handovers",
    "stale_children_reaped", "manifest_records",
)


def new_spawn_nonce():
    """A per-spawn identity nonce the child echoes back through
    ``/v2/health/stats`` — the port-squatter-proof leg of the adoption
    contract."""
    return binascii.hexlify(os.urandom(8)).decode("ascii")


def argv_template_hash(argv):
    """Stable hash of a command TEMPLATE (pre-substitution).  A
    successor started with a different template must not adopt
    children built from the old one — the running binary no longer
    matches what a respawn would produce."""
    blob = "\x00".join(str(a) for a in argv).encode("utf-8")
    return "{:08x}".format(zlib.crc32(blob) & 0xFFFFFFFF)


def process_start_token(pid):
    """The process's start-time identity token (``/proc/<pid>/stat``
    field 22, in clock ticks since boot), or None when the pid is
    gone, unreadable, or a ZOMBIE — a zombie is an exited process
    whose parent has not reaped it yet, never adoptable.  pid reuse
    cannot forge the token: a recycled pid starts at a later tick."""
    if not pid:
        return None
    try:
        with open("/proc/{}/stat".format(int(pid)), "rb") as fh:
            data = fh.read().decode("ascii", errors="replace")
    except (OSError, ValueError):
        return None
    # the comm field may contain spaces and parens; real fields resume
    # after the LAST ')'
    idx = data.rfind(")")
    if idx < 0:
        return None
    rest = data[idx + 2:].split()
    if not rest or rest[0] == "Z":
        return None
    try:
        return int(rest[19])  # field 22: starttime
    except (IndexError, ValueError):
        return None


class AdoptedProcess:
    """``subprocess.Popen``-shaped handle over a process THIS
    supervisor did not spawn (an adopted child).  Liveness goes
    through the start-time token so pid reuse reads as exited, not
    alive; the exit status of a non-child is unobservable, so a gone
    process reports returncode 0 (the supervisor only branches on
    exited-or-not)."""

    def __init__(self, pid, start_token):
        self.pid = int(pid)
        self.start_token = start_token
        self.returncode = None

    def poll(self):
        if self.returncode is not None:
            return self.returncode
        if (self.start_token is not None
                and process_start_token(self.pid) == self.start_token):
            return None
        self.returncode = 0
        return self.returncode

    def wait(self, timeout=None):
        deadline = (None if timeout is None
                    else time.monotonic() + max(0.0, timeout))
        while self.poll() is None:
            if deadline is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired(
                    "adopted-pid-{}".format(self.pid), timeout)
            time.sleep(0.02)
        return self.returncode

    def send_signal(self, signum):
        if self.poll() is None:
            os.kill(self.pid, signum)

    def terminate(self):
        self.send_signal(signal.SIGTERM)

    def kill(self):
        self.send_signal(signal.SIGKILL)


# -- single-writer lock ------------------------------------------------------


class ManifestLocked(RuntimeError):
    """Another supervisor holds this fleet's manifest lock — two
    supervisors healing one fleet would double-spawn replicas and
    interleave manifest frames.  Retry with ``takeover=True`` to wait
    for the incumbent's handover (or death: the kernel releases the
    flock with the process)."""

    def __init__(self, directory, holder_pid=None):
        self.directory = directory
        self.holder_pid = holder_pid
        super().__init__(
            "fleet manifest {} is locked by another supervisor{} — "
            "refusing to double-supervise one fleet (use --takeover "
            "to wait for its handover)".format(
                directory,
                " (pid {})".format(holder_pid) if holder_pid else ""))


def _lock_path(directory):
    return os.path.join(directory, "lock")


def acquire_manifest_lock(directory, takeover=False, timeout_s=30.0):
    """Take the exclusive manifest flock; returns the held fd.  With
    ``takeover`` the call blocks (bounded by ``timeout_s``) until the
    incumbent releases — the supervised-handover path; without it a
    held lock is an immediate typed :class:`ManifestLocked`."""
    os.makedirs(directory, exist_ok=True)
    fd = os.open(_lock_path(directory), os.O_RDWR | os.O_CREAT, 0o644)
    deadline = time.monotonic() + max(0.0, timeout_s)
    while True:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            if not takeover or time.monotonic() >= deadline:
                holder = None
                try:
                    with open(_lock_path(directory)) as fh:
                        holder = int(fh.read().strip() or 0) or None
                except (OSError, ValueError):
                    pass
                os.close(fd)
                raise ManifestLocked(directory, holder)
            time.sleep(0.05)
            continue
        # debuggability only — the FLOCK is the discipline, the pid in
        # the file is advisory (stale after a SIGKILL until retaken)
        try:
            os.ftruncate(fd, 0)
            os.pwrite(fd, str(os.getpid()).encode("ascii"), 0)
        except OSError:
            pass
        return fd


def release_manifest_lock(fd):
    if fd is None:
        return
    try:
        fcntl.flock(fd, fcntl.LOCK_UN)
    except OSError:
        pass
    try:
        os.close(fd)
    except OSError:
        pass


# -- reading + folding -------------------------------------------------------


def read_manifest(directory):
    """Replay every retained manifest record, oldest segment first;
    returns ``(records, truncated)`` with journal.py's torn-tail
    semantics (a half-written final record truncates, never fatal; a
    missing directory recovers to nothing)."""
    return read_journal(directory)


def _blank_state():
    return {
        "replicas": {},
        "routers": {},
        "counters": {key: 0 for key in COUNTER_KEYS},
        "next_index": 0,
        "router_journal": None,
        "journal_owned": False,
    }


def _rows_to_map(rows, key):
    out = {}
    for row in rows or []:
        try:
            out[int(row[key])] = dict(row)
        except (KeyError, TypeError, ValueError):
            continue
    return out


def fold_manifest(records):
    """Fold a record stream into the successor's fleet state:
    ``replicas`` (by index), ``routers`` (by stable port), restored
    counters, ``next_index``, and the router journal directory to
    re-attach.  A ``checkpoint`` resets the fold (that is the
    compaction contract); later records replay over it."""
    state = _blank_state()
    for rec in records:
        kind = rec.get("type")
        if kind == "checkpoint":
            snap = rec.get("state") or {}
            state = _blank_state()
            state["replicas"] = _rows_to_map(
                snap.get("replicas"), "index")
            state["routers"] = _rows_to_map(snap.get("routers"), "port")
            for key in COUNTER_KEYS:
                state["counters"][key] = int(
                    (snap.get("counters") or {}).get(key, 0))
            state["next_index"] = int(snap.get("next_index") or 0)
            state["router_journal"] = snap.get("router_journal")
            state["journal_owned"] = bool(snap.get("journal_owned"))
        elif kind == "spawn":
            index = int(rec["index"])
            row = state["replicas"].setdefault(index, {"index": index})
            row.update({
                "index": index,
                "role": rec.get("role"),
                "port": rec.get("port"),
                "scope": rec.get("scope"),
                "pid": rec.get("pid"),
                "start_token": rec.get("start_token"),
                "nonce": rec.get("nonce"),
                "argv_hash": rec.get("argv_hash"),
            })
            row.setdefault("restarts", 0)
            row.setdefault("restart_times", [])
            state["next_index"] = max(state["next_index"], index + 1)
        elif kind == "restart":
            row = state["replicas"].get(int(rec["index"]))
            if row is not None:
                row["restarts"] = int(rec.get("restarts") or 0)
                row["restart_times"] = list(
                    rec.get("restart_times") or [])
            state["counters"]["replica_restarts"] += 1
        elif kind == "retire":
            row = state["replicas"].get(int(rec["index"]))
            if row is not None:
                row["retired"] = True
                row["restart_times"] = list(
                    rec.get("restart_times") or row.get(
                        "restart_times") or [])
            state["counters"]["retired_replicas"] += 1
        elif kind == "scale":
            if rec.get("action") == "down":
                state["replicas"].pop(int(rec["index"]), None)
                state["counters"]["scale_down_events"] += 1
            else:
                # the paired spawn record carries the new replica
                state["counters"]["scale_up_events"] += 1
        elif kind == "router_spawn":
            port = int(rec["port"])
            row = state["routers"].setdefault(port, {"port": port})
            row.update({
                "port": port,
                "role": rec.get("role"),
                "partition": rec.get("partition"),
                "pid": rec.get("pid"),
                "start_token": rec.get("start_token"),
                "nonce": rec.get("nonce"),
            })
            row.setdefault("restarts", 0)
            row.setdefault("restart_times", [])
        elif kind == "router_restart":
            row = state["routers"].get(int(rec["port"]))
            if row is not None:
                row["restarts"] = int(rec.get("restarts") or 0)
                row["restart_times"] = list(
                    rec.get("restart_times") or [])
            state["counters"]["router_restarts"] += 1
        elif kind == "router_retire":
            row = state["routers"].get(int(rec["port"]))
            if row is not None:
                row["retired"] = True
            state["counters"]["router_retired"] += 1
        elif kind == "promote":
            for row in state["routers"].values():
                if row["port"] == rec.get("active_port"):
                    row["role"] = "active"
                    # partitioned tier: the promotion moved the dead
                    # active's partition onto the standby
                    if rec.get("partition") is not None:
                        row["partition"] = rec.get("partition")
                elif row["port"] == rec.get("standby_port"):
                    row["role"] = "standby"
                    if rec.get("partition") is not None:
                        row["partition"] = None
            state["counters"]["router_takeovers"] += 1
        elif kind == "config":
            if "router_journal" in rec:
                state["router_journal"] = rec.get("router_journal")
                state["journal_owned"] = bool(rec.get("journal_owned"))
    return state


# -- the writer --------------------------------------------------------------


class ManifestWriter:
    """The append side: a lock-free queue drained by one dedicated
    ``fleet-manifest-writer`` thread (daemon AND joined in
    :meth:`close` — the journal writer's lifecycle, pinned by tpulint
    R5's writer-thread companion check).

    Unlike the journal's time-based rotation, the manifest compacts on
    CHECKPOINT: a ``checkpoint`` record opens a fresh segment, lands
    as its first record, and prunes all but the newest two segments —
    everything before the snapshot is redundant by construction (the
    predecessor survives one extra generation so a torn checkpoint
    write still recovers from the previous fold)."""

    _RETAIN_SEGMENTS = 2

    def __init__(self, directory, flush_interval_s=0.02,
                 queue_capacity=8192):
        self._dir = directory
        os.makedirs(directory, exist_ok=True)
        self._flush_interval_s = float(flush_interval_s)
        # supervision-plane cadence, not a token hot path — but the
        # same lock-free enqueue contract keeps the monitor tick from
        # ever blocking on manifest I/O
        self._queue = deque(maxlen=int(queue_capacity))
        self._lock = threading.Lock()
        self._records = 0       # guarded-by: _lock
        self._checkpoints = 0   # guarded-by: _lock
        self._drain_passes = 0  # guarded-by: _lock
        self._closed = False    # guarded-by: _lock
        segments = _list_segments(directory)
        self._next_index = (segments[-1][0] + 1) if segments else 1
        self._fh = None  # writer-thread-owned
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="fleet-manifest-writer", daemon=True)
        self._thread.start()

    def append(self, record):
        """Enqueue one record dict; framing + I/O happen on the writer
        thread."""
        self._queue.append(record)
        self._wake.set()

    def checkpoint(self, state):
        """Enqueue a compacting full-state snapshot."""
        self.append({"type": "checkpoint", "state": state})

    # -- writer thread -----------------------------------------------------

    def _open_segment(self):
        if self._fh is not None:
            self._fh.close()
        path = os.path.join(
            self._dir, "seg-{:08d}.log".format(self._next_index))
        self._next_index += 1
        self._fh = open(path, "ab")
        segments = _list_segments(self._dir)
        for _idx, old in segments[:-self._RETAIN_SEGMENTS]:
            try:
                os.remove(old)
            except OSError:
                pass

    def _write_frames(self, frames):
        if not frames:
            return
        if self._fh is None:
            self._open_segment()
        self._fh.write(b"".join(frames))
        self._fh.flush()
        os.fsync(self._fh.fileno())

    @staticmethod
    def _frame(record):
        payload = json.dumps(
            record, separators=(",", ":")).encode("utf-8")
        return _FRAME.pack(
            len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload

    def _drain(self):
        batch = []
        while True:
            try:
                batch.append(self._queue.popleft())
            except IndexError:
                break
        frames = []
        checkpoints = 0
        for record in batch:
            if record.get("type") == "checkpoint":
                # compaction boundary: flush what precedes it, rotate,
                # seed the fresh segment with the snapshot
                self._write_frames(frames)
                frames = []
                self._open_segment()
                checkpoints += 1
            frames.append(self._frame(record))
        self._write_frames(frames)
        with self._lock:
            self._records += len(batch)
            self._checkpoints += checkpoints
            self._drain_passes += 1

    def _run(self):
        while not self._stop.is_set():
            self._wake.wait(self._flush_interval_s)
            self._wake.clear()
            try:
                self._drain()
            except OSError:
                # a full/readonly disk degrades durability; it must
                # never take the supervision plane down
                pass
        try:
            self._drain()
        except OSError:
            pass
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- lifecycle / observability -----------------------------------------

    def flush(self, timeout_s=5.0):
        """Block until everything enqueued so far is written + fsynced
        (a drain pass that STARTED after this call and left the queue
        empty covers every earlier enqueue)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            target = self._drain_passes
        while time.monotonic() < deadline:
            self._wake.set()
            with self._lock:
                passes = self._drain_passes
            if not self._queue and passes > target:
                return True
            time.sleep(0.005)
        return False

    def close(self, timeout_s=5.0):
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=timeout_s)

    def stats(self):
        with self._lock:
            return {
                "records": self._records,
                "checkpoints": self._checkpoints,
                "queued": len(self._queue),
            }
