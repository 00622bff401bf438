"""Disaggregated prefill/decode orchestration — the phase-split layer
over KV-export regions (the port's copy of ``tpuserver.disagg``; on the
port's replicas an export is a CUDA region ``kvexport/<gen_id>`` and the
descriptor the orchestrator relays carries its IPC handle unchanged).

Chunked prefill only stops prefill stalling decode *within* a replica;
under mixed long-prompt traffic TTFT still competes with ITL for the
same decode loop.  This module splits the two phases across the fleet:

- **prefill replicas** (``InferenceServer(role="prefill")``) run the
  admission's prefill (plus exactly one decode step) and publish the
  finished KV pages as a server-owned ``kvexport/<gen_id>`` region;
- **decode replicas** (``role="decode"``) attach the export, re-scatter
  it into their own page table, and stream from the second token — no
  re-prefill, token-identity preserved (greedy decode is deterministic
  and the attach path is A/B-pinned against the fused run).

The orchestrator lives in the fleet router's admission path.  A fresh
generation admission becomes, when both role pools are routable:

1. a **prefill leg** — the original request with ``MAX_TOKENS=1`` and
   ``kv_phase=prefill``, routed with prefix affinity over the prefill
   pool (that is where the radix cache lives); its single token relays
   to the client immediately (it IS the TTFT) and its KV exports on
   finish;
2. a **KV transfer** — one ``GET /v2/kvexport/<gen_id>`` on the prefill
   replica: the one-shot claimed wire descriptor (typed 404 when the
   export is gone, 409 on a double claim — both fall back);
3. a **decode leg** — the router's existing handoff body (prompt +
   token 0, ``MAX_TOKENS`` shrunk by one) with the descriptor injected
   as ``kv_attach``, admitted on the least-loaded decode replica.

Every edge degrades to the fused path, token-identically: a fleet with
no role-tagged replicas (or a single replica) never enters this module;
a prefill leg that dies before its token is a plain failover; one that
dies after it — or a failed/conflicted descriptor fetch — becomes an
ordinary re-prefill handoff on the existing machinery.  Mid-handoff
death of either role therefore heals exactly like any other replica
death.

This module deliberately does not import
``tpuserver_torch.fleet_router`` (the router imports it); everything it needs from the router — replica
snapshots, pick_* routing, counters — is reached through the instance
handed to :class:`PhaseSplitOrchestrator`.
"""

import http.client
import json
import socket
import threading
import time
from urllib.parse import quote

#: The two dedicated phase roles a replica can advertise in its health
#: snapshot; anything else (None included) reads as "fused".
PREFILL_ROLE = "prefill"
DECODE_ROLE = "decode"
FUSED_ROLE = "fused"


def _coerce_int(value, default=0):
    try:
        return int(value)
    except (TypeError, ValueError):
        return default


#: Replica-side generation-id suffix for the prefill leg.  The leg's
#: record on the prefill replica is a COMPLETED one-token generation
#: (its ``MAX_TOKENS`` was rewritten to 1) — if it lived under the real
#: generation id, a router that crashed mid-split and recovered
#: ``home = prefill replica`` from its journal would resume against
#: that record, get an instant ``final``, and silently truncate the
#: stream to one token (chaos campaign seed 7: router_sigkill composed
#: with replica churn).  Under a derived id, that stale resume answers
#: typed-404 instead, which the relay loop already heals via a
#: token-identical re-prefill handoff.  Never digits after the tilde,
#: so the router's ``gen~offset`` handoff-epoch parsing cannot
#: mistake it.
PREFILL_LEG_ID_SUFFIX = "~prefill"


def prefill_leg_id(gen_id):
    """The replica-side generation id of ``gen_id``'s prefill leg."""
    return gen_id + PREFILL_LEG_ID_SUFFIX


def prefill_leg_body(body):
    """Rewrite a fresh admission body into its prefill leg: exactly one
    decode step (``MAX_TOKENS=1`` — the first token is the TTFT the
    split exists to protect), ``kv_phase=prefill`` so the replica
    exports the KV when the leg finishes, and the leg's DERIVED
    generation id (:func:`prefill_leg_id`) so the completed one-token
    record can never satisfy a resume of the real generation."""
    request = json.loads(body)
    inputs = []
    for tin in request.get("inputs") or []:
        tin = dict(tin)
        if tin.get("name") == "MAX_TOKENS":
            tin["data"] = [1]
        inputs.append(tin)
    request["inputs"] = inputs
    params = dict(request.get("parameters") or {})
    params["kv_phase"] = PREFILL_ROLE
    gid = str(params.get("generation_id") or "")
    if gid:
        params["generation_id"] = prefill_leg_id(gid)
    request["parameters"] = params
    return json.dumps(request).encode("utf-8")


def attach_body(handoff_body, descriptor):
    """Inject a KV-export wire descriptor into a handoff re-admission
    body: the decode replica imports it and scatters instead of
    re-prefilling.  The body stays a valid fused re-admission — a
    replica that cannot attach (export died under the claim) silently
    prefills the same prompt, token-identically."""
    request = json.loads(handoff_body)
    params = dict(request.get("parameters") or {})
    params["kv_attach"] = descriptor
    request["parameters"] = params
    return json.dumps(request).encode("utf-8")


class PhaseSplitOrchestrator:
    """Router-resident phase-split admission: role pools, the prefill
    leg, the KV transfer, and the disagg counters /metrics exposes."""

    def __init__(self, router):
        self._router = router
        self._lock = threading.Lock()
        self._splits = 0            # guarded-by: _lock
        self._fallbacks = {}        # reason -> count  # guarded-by: _lock
        self._transfers = 0         # guarded-by: _lock
        self._transfer_bytes = 0    # guarded-by: _lock
        self._transfer_ms = 0.0     # guarded-by: _lock
        self._prefill_queue_ms = 0.0  # guarded-by: _lock

    # -- pools & telemetry -------------------------------------------------

    def pools(self):
        """``(prefill, decode)`` replica lists by advertised role.
        Role-less replicas belong to neither: they serve the fused
        path (and any fallback pick), so a mixed fleet keeps its
        fused capacity out of the split's way."""
        prefill, decode = [], []
        for rep in self._router._replicas_snapshot():
            role = rep.role()
            if role == PREFILL_ROLE:
                prefill.append(rep)
            elif role == DECODE_ROLE:
                decode.append(rep)
        return prefill, decode

    def phase_queue_depth(self):
        """``{phase: queued + live generations}`` summed from the
        prober's health snapshots — the per-phase queue-depth signal
        (a deep prefill queue with idle decode capacity means the
        role targets are mis-sized, and vice versa)."""
        depths = {}
        for rep in self._router._replicas_snapshot():
            snap = rep.health()
            if not isinstance(snap, dict):
                continue
            role = snap.get("role") or FUSED_ROLE
            depth = _coerce_int(snap.get("inflight"))
            for stats in (snap.get("models") or {}).values():
                if isinstance(stats, dict):
                    depth += _coerce_int(stats.get("pending"))
                    depth += _coerce_int(stats.get("live_streams"))
            depths[role] = depths.get(role, 0) + depth
        return depths

    def _count_fallback(self, reason):
        with self._lock:
            self._fallbacks[reason] = self._fallbacks.get(reason, 0) + 1

    def stats(self):
        prefill, decode = self.pools()
        with self._lock:
            return {
                "splits": self._splits,
                "fallbacks": dict(self._fallbacks),
                "transfers": self._transfers,
                "transfer_bytes": self._transfer_bytes,
                "transfer_ms_total": self._transfer_ms,
                "prefill_queue_ms_total": self._prefill_queue_ms,
                "prefill_replicas": len(prefill),
                "decode_replicas": len(decode),
                "phase_queue_depth": self.phase_queue_depth(),
            }

    # -- admission ---------------------------------------------------------

    def try_admit(self, handler, gen):
        """Attempt the phase-split admission of a fresh generation.

        Returns None when the split does not apply (no role pools, no
        generate contract, too few tokens, explicit phase parameters):
        nothing was sent anywhere and the caller runs today's fused
        path, byte-identically.  Otherwise runs the prefill leg —
        relaying its token to the client through ``handler`` — and
        returns a plan dict:

        - ``{"terminal": "complete"|"error"|"fail"}`` — the generation
          already ended during the prefill leg (single-token request /
          EOS on token 0 / typed in-band failure);
        - ``{"rep", "body", "headers", "release"}`` — the prepared
          decode leg (``rep`` may be None when no replica is left;
          ``release`` is an optional callable freeing the export once
          the decode replica's first token proves the attach landed).
        """
        router = self._router
        if gen.prompt is None or not gen.prompt:
            return None
        if gen.max_tokens is None or gen.max_tokens < 2:
            return None  # nothing left for a decode leg to stream
        params = gen.request.get("parameters") or {}
        if params.get("kv_phase") or params.get("kv_attach"):
            return None  # explicit phase control: the caller drives
        prefill_pool, decode_pool = self.pools()
        if not prefill_pool or not decode_pool:
            return None  # fused fleet (or a single role): today's path
        rep = router.pick_for_generation(gen, replicas=prefill_pool)
        if rep is None:
            self._count_fallback("no_prefill_replica")
            return None
        gen.set_home(rep.url)
        body, headers = gen.upstream_request(resuming=False)
        outcome = self._run_prefill_leg(
            handler, gen, rep, prefill_leg_body(body), headers)
        if outcome == "error":
            return {"terminal": "error"}
        if outcome in ("rejected", "died") and gen.emitted() == 0:
            # nothing relayed anywhere: a plain failover back to the
            # fused admission path (which may pick any replica)
            self._count_fallback("prefill_" + outcome)
            return None
        descriptor = None
        if outcome == "final":
            # the export is published under the LEG's derived id (that
            # is the generation_id the prefill replica saw)
            descriptor = self._fetch_descriptor(
                rep, prefill_leg_id(gen.gen_id))
        else:
            # token 0 reached the client, then the leg died: the
            # export never finished — re-prefill handoff below
            self._count_fallback("prefill_died_after_token")
        handoff = gen.handoff_request()
        if handoff == b"":
            # EOS on token 0 (or a single-token budget racing the
            # check): the stream is complete
            return {"terminal": "complete"}
        if handoff is None:
            # an event without a TOKEN output made the generation
            # unresumable — cannot happen on the scheduler contract
            return {"terminal": "fail"}
        release = None
        if descriptor is not None:
            handoff = attach_body(handoff, descriptor)
            release = self._releaser(rep, prefill_leg_id(gen.gen_id))
            with self._lock:
                self._splits += 1
        decode_rep = (router.pick_replica(replicas=decode_pool)
                      or router.pick_for_generation(
                          gen, exclude={rep.url}))
        if decode_rep is None:
            # no decode replica AND no fallback: let the caller's
            # retry loop fail typed exactly like the fused path
            decode_rep = router.pick_for_generation(gen)
        if decode_rep is not None:
            gen.set_home(decode_rep.url, rebase=True)
        return {
            "rep": decode_rep,
            "body": handoff,
            "headers": {"Content-Type": "application/json"},
            "release": release,
        }

    # -- legs --------------------------------------------------------------

    def _run_prefill_leg(self, handler, gen, rep, body, headers):
        """POST the prefill leg and relay its events (normally exactly
        one token) to the client through the handler's recording relay.
        Returns ``"final"`` / ``"error"`` / ``"died"`` / ``"rejected"``.
        """
        router = self._router
        t0 = time.monotonic()
        conn = None
        rep.begin_request()
        try:
            conn = http.client.HTTPConnection(
                rep.host, rep.port, timeout=router._read_timeout_s)
            conn.request("POST", gen.path, body=body, headers=headers)
            resp = conn.getresponse()
            if resp.status != 200:
                resp.read()
                rep.note_typed_failure()
                return "rejected"

            def note_first():
                elapsed = time.monotonic() - t0
                with self._lock:
                    self._prefill_queue_ms += elapsed * 1000.0
                # the prefill leg's TTFT feeds the replica's stream
                # digest the same way a fused admission's does
                rep.note_latency("generate_stream", elapsed)

            outcome = handler._relay_events(gen, resp, note_first)
            if outcome == "died":
                rep.mark_unreachable()
            return outcome
        except (ConnectionError, socket.timeout, OSError,
                http.client.HTTPException):
            rep.mark_unreachable()
            return "died"
        finally:
            rep.end_request()
            if conn is not None:
                conn.close()

    def _fetch_descriptor(self, rep, gen_id):
        """One-shot KV-export descriptor fetch, or None (counted, by
        reason) — a missing/claimed/unreachable export means the decode
        leg re-prefills instead, it never means a user-visible error."""
        router = self._router
        t0 = time.monotonic()
        conn = None
        try:
            conn = http.client.HTTPConnection(
                rep.host, rep.port, timeout=router._probe_timeout_s)
            conn.request("GET", "/v2/kvexport/" + quote(gen_id, safe=""))
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                self._count_fallback(
                    "descriptor_conflict" if resp.status == 409
                    else "descriptor_missing")
                return None
            descriptor = json.loads(data)
            elapsed_ms = (time.monotonic() - t0) * 1000.0
            with self._lock:
                self._transfers += 1
                self._transfer_ms += elapsed_ms
                self._transfer_bytes += _coerce_int(
                    descriptor.get("byte_size"))
            return descriptor
        except (ConnectionError, socket.timeout, OSError,
                http.client.HTTPException, ValueError):
            self._count_fallback("descriptor_unreachable")
            return None
        finally:
            if conn is not None:
                conn.close()

    def _releaser(self, rep, gen_id):
        """Deferred, best-effort export release: fired (off the relay
        hot path) once the decode leg's first token proves the attach
        consumed the region.  A leg that dies before that leaves the
        claim to the prefill replica's replay-TTL sweep — late cleanup,
        never a dangling attach."""
        def release():
            def _post():
                conn = None
                try:
                    conn = http.client.HTTPConnection(
                        rep.host, rep.port,
                        timeout=self._router._probe_timeout_s)
                    conn.request(
                        "POST",
                        "/v2/kvexport/{}/release".format(
                            quote(gen_id, safe="")))
                    conn.getresponse().read()
                except (ConnectionError, socket.timeout, OSError,
                        http.client.HTTPException):
                    pass  # TTL sweep owns the backstop
                finally:
                    if conn is not None:
                        conn.close()
            threading.Thread(
                target=_post, name="kvexport-release", daemon=True
            ).start()
        return release
