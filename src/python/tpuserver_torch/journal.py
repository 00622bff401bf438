"""Crash-durable generation journal for the fleet router.

The port's copy of ``tpuserver.journal``: the record framing and the
segment names are byte-identical, so either package's router reads and
tails the other's journal.  Without a journal every sticky binding,
handoff offset rebase, and replay buffer lives only in the router
process's heap, so a RESTARTED router must answer a handoff-marked resume (``gen~offset/seq``) with a typed 404 —
the offset map that would make the replay point meaningful is gone.
This module closes the hole with an **append-only record log** of the
router's resume-critical state:

- ``bind``    — a generation's identity: id, request path, the original
  request JSON (the handoff re-prefill source), and its first home.
- ``home``    — a (re)homing: the owning replica url and the current
  handoff offset (router seq = offset + backend seq).
- ``ev``      — one relayed SSE event: router seq, the exact ``id:``
  line the client saw (epoch marker included), and the payload.  The
  per-generation relayed-seq watermark is implicit in the highest seq.
- ``fin`` / ``drop`` — terminal outcomes.

**Wire format.**  Each record is framed ``<u32 length><u32 crc32>``
followed by ``length`` bytes of UTF-8 JSON.  Frames are the recovery
contract: a half-written final record (torn write at crash) fails its
length or checksum and is **truncated, never fatal** — recovery keeps
every complete record before it.

**Hot-path contract.**  The relay loop only *enqueues*: `append` is a
single ``collections.deque.append`` (GIL-atomic, lock-free — the
bounded deque drops the oldest enqueued record under backpressure
rather than ever blocking a token relay).  A dedicated writer thread
drains the queue in batches, frames + writes + fsyncs, and owns every
file handle.  The event path therefore acquires **zero new locks**.

**Segment rotation.**  The log lives in a directory of
``seg-<n>.log`` files.  The writer rotates to a fresh segment every
``rotate_interval_s`` (align it with the router's generation TTL) and
retains the newest ``retain_segments`` — records older than the TTL
window describe generations no resume can name anymore, so dropping
whole expired segments bounds the disk footprint without per-record
compaction.

Readers: :func:`read_journal` replays every retained record at boot
(``FleetRouter(journal=...)`` recovery), and :class:`JournalFollower`
tails the directory incrementally (the ``--standby`` router's warm
copy).  See docs/resilience.md "Router HA & state durability".
"""

import json
import os
import re
import struct
import threading
import time
import zlib
from collections import deque

__all__ = [
    "JournalFollower",
    "JournalWriter",
    "read_journal",
]

_FRAME = struct.Struct("<II")  # (payload length, crc32(payload))
_SEGMENT_RE = re.compile(r"^seg-(\d+)\.log$")

#: A sanity bound on one record's framed length: a length prefix past
#: it is torn-tail garbage (or a foreign file), never a real record.
_MAX_RECORD_BYTES = 16 * 1024 * 1024


def _segment_index(name):
    m = _SEGMENT_RE.match(name)
    return int(m.group(1)) if m else None


def _list_segments(directory):
    """``[(index, path)]`` of the directory's segments, oldest first."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for name in names:
        idx = _segment_index(name)
        if idx is not None:
            out.append((idx, os.path.join(directory, name)))
    out.sort()
    return out


def _read_records(blob, offset=0):
    """Parse complete records out of ``blob`` starting at ``offset``.

    Returns ``(records, next_offset, clean)``: ``next_offset`` is the
    byte position after the last COMPLETE record, and ``clean`` is
    False when trailing bytes exist that do not frame a complete,
    checksum-valid record — a torn tail (crash mid-write) or
    corruption.  The caller decides whether that tail is "still being
    written" (follower: retry later) or "truncate and move on"
    (recovery)."""
    records = []
    n = len(blob)
    pos = offset
    while pos + _FRAME.size <= n:
        length, crc = _FRAME.unpack_from(blob, pos)
        if length > _MAX_RECORD_BYTES:
            return records, pos, False
        end = pos + _FRAME.size + length
        if end > n:
            return records, pos, False  # incomplete tail
        payload = blob[pos + _FRAME.size:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return records, pos, False  # torn/corrupt record
        try:
            records.append(json.loads(payload))
        except ValueError:
            return records, pos, False
        pos = end
    return records, pos, pos == n


def read_journal(directory):
    """Replay every retained record, oldest segment first.

    Returns ``(records, truncated)``: ``truncated`` counts segments
    whose tail did not parse — a torn final write is expected after a
    crash (the final segment), and recovery simply keeps the clean
    prefix.  A missing or empty directory recovers to nothing, not an
    error (a first boot with ``--journal`` pointing at a fresh
    directory must just work)."""
    records = []
    truncated = 0
    for _idx, path in _list_segments(directory):
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError:
            truncated += 1
            continue
        segment_records, _pos, clean = _read_records(blob)
        records.extend(segment_records)
        if not clean:
            truncated += 1
    return records, truncated


class JournalWriter:
    """The append side: a bounded lock-free queue drained by one
    dedicated writer thread.

    Parameters
    ----------
    directory : str
        The journal directory (created if missing).  The writer always
        opens a FRESH segment — it never appends to a predecessor's
        file, so a torn tail from a crashed writer stays where
        recovery already truncated it.
    rotate_interval_s : float
        Segment rotation cadence.  Align with the router's generation
        TTL: a dropped segment then only ever drops records no resume
        can name.
    retain_segments : int
        Newest segments kept on rotation (>= 2 so the retained span
        always covers at least one full rotation interval).
    flush_interval_s : float
        Writer wake cadence; also the crash-loss upper bound for
        enqueued-but-unwritten records.
    queue_capacity : int
        Bounded queue depth; overflow drops the OLDEST enqueued record
        (durability degrades, the token relay never blocks).
    """

    def __init__(self, directory, rotate_interval_s=60.0,
                 retain_segments=3, flush_interval_s=0.02,
                 queue_capacity=65536, clock=None):
        self._dir = directory
        os.makedirs(directory, exist_ok=True)
        self._rotate_interval_s = float(rotate_interval_s)
        self._retain_segments = max(2, int(retain_segments))
        self._flush_interval_s = float(flush_interval_s)
        # the hot-path queue: deque.append/popleft are GIL-atomic, so
        # the relay loop enqueues without acquiring ANY lock; maxlen
        # makes overflow drop-oldest instead of blocking
        self._queue = deque(maxlen=int(queue_capacity))
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._records = 0       # guarded-by: _lock
        self._bytes = 0         # guarded-by: _lock
        self._fsyncs = 0        # guarded-by: _lock
        self._drain_passes = 0  # guarded-by: _lock
        self._closed = False    # guarded-by: _lock
        segments = _list_segments(directory)
        self._next_index = (segments[-1][0] + 1) if segments else 1
        self._fh = None                 # writer-thread-owned
        self._segment_started = None    # writer-thread-owned
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="router-journal-writer", daemon=True)
        self._thread.start()

    # -- hot path ----------------------------------------------------------

    def append(self, record):
        """Enqueue one record dict.  Lock-free (a single deque append);
        encoding, framing, and I/O all happen on the writer thread."""
        self._queue.append(record)
        self._wake.set()

    # -- writer thread -----------------------------------------------------

    def _open_segment(self):
        if self._fh is not None:
            self._fh.close()
        path = os.path.join(
            self._dir, "seg-{:08d}.log".format(self._next_index))
        self._next_index += 1
        self._fh = open(path, "ab")
        self._segment_started = self._clock()
        # retention: count-based (restart-safe — no wall-clock ages),
        # newest retain_segments survive
        segments = _list_segments(self._dir)
        for _idx, old in segments[:-self._retain_segments]:
            try:
                os.remove(old)
            except OSError:
                pass

    def _drain(self):
        """Write every queued record as one batch, then fsync once."""
        batch = []
        while True:
            try:
                batch.append(self._queue.popleft())
            except IndexError:
                break
        if not batch:
            with self._lock:
                self._drain_passes += 1
            return
        if (self._fh is None
                or self._clock() - self._segment_started
                >= self._rotate_interval_s):
            self._open_segment()
        frames = []
        for record in batch:
            payload = json.dumps(
                record, separators=(",", ":")).encode("utf-8")
            frames.append(_FRAME.pack(
                len(payload), zlib.crc32(payload) & 0xFFFFFFFF))
            frames.append(payload)
        blob = b"".join(frames)
        self._fh.write(blob)
        self._fh.flush()
        os.fsync(self._fh.fileno())
        with self._lock:
            self._records += len(batch)
            self._bytes += len(blob)
            self._fsyncs += 1
            self._drain_passes += 1

    def _run(self):
        while not self._stop.is_set():
            self._wake.wait(self._flush_interval_s)
            self._wake.clear()
            try:
                self._drain()
            except OSError:
                # a full/readonly disk must degrade durability, never
                # take the serving path down; the next drain retries
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
        (the SIGTERM-drain path: flush, then exit).  Completion is a
        drain pass that both STARTED after this call and left the
        queue empty — every record enqueued before the call is then
        covered by that pass's (or an earlier) fsync."""
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
                "bytes": self._bytes,
                "fsyncs": self._fsyncs,
                "queued": len(self._queue),
            }


class JournalFollower:
    """Incremental reader for the standby router: remembers its
    position and yields only complete new records on each
    :meth:`poll`.

    A torn tail is ambiguous while the writer lives — the record may
    simply still be in flight — so the follower retries the same
    offset next poll.  Once a NEWER segment exists the writer has
    moved on and will never complete that tail, so the follower
    abandons it and advances.  (Single-writer discipline: only the
    ACTIVE router writes; a standby promotes only after the active is
    gone.)"""

    def __init__(self, directory):
        self._dir = directory
        self._segment = None   # (index, path)
        self._offset = 0

    def poll(self):
        """Every complete record appended since the last poll."""
        records = []
        while True:
            segments = _list_segments(self._dir)
            if not segments:
                return records
            if self._segment is None:
                self._segment = segments[0]
                self._offset = 0
            current_idx = self._segment[0]
            newer = [s for s in segments if s[0] > current_idx]
            try:
                with open(self._segment[1], "rb") as fh:
                    fh.seek(self._offset)
                    blob = fh.read()
            except OSError:
                blob = b""
            got, consumed, clean = _read_records(blob)
            records.extend(got)
            self._offset += consumed
            if clean and not newer:
                return records
            if not clean and not newer:
                # torn-or-in-flight tail and the writer still owns this
                # segment: retry the same offset next poll
                return records
            # the writer moved to a newer segment: whatever tail this
            # one has will never complete — advance
            self._segment = newer[0]
            self._offset = 0
