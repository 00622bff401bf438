"""The client side of a resumable generation stream.

A generation that the server numbers (``seq`` on every token event) can
be resumed after its connection drops: the client reconnects, the server
replays from the last event the client saw, and the client drops the
replayed duplicates.  :class:`Resumer` keeps that bookkeeping for one
generation whatever the wire; :func:`sse_generation` is the stdlib reader
of ``/generate_stream`` server-sent events built on it (the perf
analyzer's HTTP backend and the chaos campaign read streams through it;
the gRPC backend drives a :class:`Resumer` over its decoupled stream).
Standard library only.
"""

import http.client
import json
import time


class StreamError(Exception):
    """A generation stream failed in a way its client sees."""


class Resumer:
    """The resume bookkeeping of one generation: the last ``seq`` seen,
    whether a token was yielded, the attempts made.

    ``max_reconnects`` reconnects at most, the Nth after
    ``min(backoff_s * 2 ** (N - 1), 2.0)`` seconds; ``on_reconnect(
    attempt, error)`` runs before each."""

    def __init__(self, max_reconnects=10, backoff_s=0.05, on_reconnect=None):
        self.max_reconnects = max_reconnects
        self.backoff_s = backoff_s
        self.on_reconnect = on_reconnect
        self.last_seq = -1
        self.yielded_any = False
        self.attempt = 0

    def fresh(self, seq):
        """False for a replayed duplicate (``seq`` already seen); else
        records ``seq`` (None: an unnumbered event, always fresh)."""
        if seq is None:
            return True
        if seq <= self.last_seq:
            return False
        self.last_seq = seq
        return True

    def reconnect(self, dropped, resumable):
        """After the attempt that ``dropped`` ended: raise ``dropped``
        when no reconnect is left, or when tokens were yielded and the
        stream cannot be resumed (``resumable`` false: a reconnect would
        replay them); else report and back off."""
        self.attempt += 1
        if self.attempt > self.max_reconnects or (self.yielded_any
                                                  and not resumable):
            raise dropped
        if self.on_reconnect is not None:
            self.on_reconnect(self.attempt, dropped)
        time.sleep(min(self.backoff_s * 2 ** (self.attempt - 1), 2.0))


def sse_generation(urls, model, body, max_reconnects=10, backoff_s=0.05,
                   read_timeout=600.0, on_reconnect=None):
    """Yield each event of the ``generate_stream`` generation that the
    JSON ``body`` asks for, resuming a dropped stream: the same body is
    re-POSTed with ``Last-Event-ID`` (the last ``id:`` line seen),
    rotating through ``urls`` (attempt N dials ``urls[N % len]``), as
    :class:`Resumer` paces it.  A 404 on a resume and a 429/503 before
    the terminal event are transitions and ride the reconnect path; an
    in-band error event and any other status raise :class:`StreamError`.
    Replayed duplicates (a seq already seen) are skipped.  The contract
    of the client library's ``generate_stream`` with ``fallback_urls``."""
    path = "/v2/models/{}/generate_stream".format(model)
    resumer = Resumer(max_reconnects, backoff_s, on_reconnect)
    last_event_id = None
    while True:
        host, _, port = urls[resumer.attempt % len(urls)].rpartition(":")
        conn = http.client.HTTPConnection(host, int(port),
                                          timeout=read_timeout)
        dropped = None
        try:
            headers = {"Content-Type": "application/json"}
            if last_event_id is not None:
                headers["Last-Event-ID"] = last_event_id
            try:
                conn.request("POST", path, body, headers)
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException) as e:
                dropped, resp = e, None
            if resp is not None and (
                    (resp.status == 404 and last_event_id is not None)
                    or (resp.status in (429, 503) and (
                        last_event_id is not None
                        or not resumer.yielded_any))):
                dropped = StreamError("status {}: {}".format(
                    resp.status, resp.read()[:200]))
                resp = None
            elif resp is not None and resp.status != 200:
                raise StreamError("generate_stream failed: {} {}".format(
                    resp.status, resp.read()[:200]))
            if resp is not None:
                event_id = None
                try:
                    for line in resp:
                        line = line.strip()
                        if line.startswith(b"id: "):
                            event_id = line[4:].decode("utf-8", "replace")
                            continue
                        if not line.startswith(b"data: "):
                            continue
                        event = json.loads(line[len(b"data: "):])
                        if "error" in event:
                            raise StreamError(event["error"])
                        if event.get("final"):
                            return
                        if not resumer.fresh(
                                (event.get("parameters") or {}).get("seq")):
                            event_id = None
                            continue  # a replayed duplicate
                        if event_id is not None:
                            last_event_id, event_id = event_id, None
                        resumer.yielded_any = True
                        yield event
                    dropped = ConnectionError(
                        "stream ended without its terminal event")
                except (OSError, http.client.HTTPException) as e:
                    dropped = e
        finally:
            conn.close()
        if not isinstance(dropped, StreamError):
            dropped = StreamError("generate_stream connection lost: {}".format(
                dropped))
        resumer.reconnect(dropped, last_event_id is not None)
