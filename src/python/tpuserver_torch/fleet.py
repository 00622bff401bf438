"""Fleet supervisor: process-level replica healing and elastic scaling.

The port's copy of ``tpuserver.fleet``.  The scheduler self-heals
*inside* a process (supervised decode loop) and the fleet router routes
*around* a dead replica — but neither brings a replica *back*: without
a supervisor a SIGKILL'd server process is gone for good and the
router's replica set is frozen at construction.
:class:`FleetSupervisor` lifts the supervised-restart pattern from
thread granularity (``DecodeScheduler._supervise``) to **process**
granularity — the reference survey's multi-process coordination role
(SURVEY §2.2/§5) applied to the serving tier — so the *fleet* becomes
the unit that survives, not any single replica:

1. **Ownership.**  The supervisor spawns N replica server processes
   from one command template (per-replica port, fault scope, index),
   fronts them with a :class:`~tpuserver_torch.fleet_router.FleetRouter`, and keeps
   the router's live membership in sync: a replica joins the routing
   set only once its ``/v2/health/stats`` probe reports ready, and
   leaves it *before* the supervisor touches the process.
2. **Liveness.**  Two signals, both necessary: process exit (SIGKILL,
   crash, OOM) restarts immediately; an alive-but-unhealthy process —
   tripped scheduler (restart budget exhausted inside the process) or
   a wedge (consecutive probe failures while the process runs) — gets
   a **SIGTERM drain first** (the replica's ``install_sigterm_drain``
   path finishes in-flight generations; the router's cross-replica
   splice absorbs the rest), then SIGKILL past the grace window.
3. **Restart budget.**  Restarts per replica are bounded by
   ``max_restarts`` inside ``restart_window_s`` with exponential
   backoff between attempts; a replica that exhausts the budget is
   **retired** — the fleet degrades deterministically instead of
   flapping, exactly like the in-process scheduler's sticky trip.
4. **Elastic scaling.**  The supervisor reads each replica's scheduler
   utilization from the same health snapshot the router probes
   (``pending/max_pending``, ``live_streams/max_slots``) and scales the
   replica count between ``min_replicas``/``max_replicas`` with
   hysteresis: only *sustained* spill pressure scales up, only
   *sustained* idleness drains one replica down, a middle-band reading
   resets both streaks, and a cooldown follows every action — a single
   noisy window can never flap the fleet.
5. **A supervised front tier** (``router_command=``).  Every guarantee
   above flows through the router — so the router process itself gets
   the same treatment the replicas do: the supervisor spawns it (with
   ``--journal`` for crash-durable sticky state), probes it, heals a
   wedge drain-first under the same restart budget, and retires it on
   exhaustion.  With ``router_standby=True`` a second router process
   tails the same journal as a warm standby; on active-router death
   the supervisor PROMOTES the standby (``POST /router/promote`` — one
   reconnect for clients carrying both urls, never a lost stream) and
   respawns the casualty as the new standby.  Without a standby the
   active respawns on its own port with ``--journal``, recovering the
   sticky registry from disk.  Router ports are stable across every
   restart and role swap, so a client's url list never goes stale.

``python -m tpuserver_torch.fleet_cli`` is the CLI (its replicas are
``python -m tpuserver_torch.serve`` processes);
``python -m tpuserver_torch.chaos_campaign`` composes SIGKILL-mid-traffic
healing of replicas and the front tier with other faults;
docs/resilience.md "Fleet supervisor & elastic scaling" and "Router HA
& state durability" have the full semantics.
"""

import http.client
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque

from tpuserver_torch import fleetmanifest
from tpuserver_torch.fleet_router import FleetRouter

__all__ = ["FleetSupervisor", "ReplicaProcess", "RouterProcess"]


def _free_port(host):
    """Ask the kernel for a free port.  The tiny bind-to-spawn race is
    accepted: replica servers fail fast on a taken port and the restart
    budget absorbs the retry."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.bind((host, 0))
        return sock.getsockname()[1]
    finally:
        sock.close()


def _fetch_health(host, port, timeout_s):
    """One ``/v2/health/stats`` probe, or None when unreachable —
    the same snapshot (and the same cheapness argument) as the
    router's prober."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        conn.request("GET", "/v2/health/stats")
        resp = conn.getresponse()
        if resp.status != 200:
            return None
        return json.loads(resp.read())
    except (OSError, ValueError, http.client.HTTPException):
        return None
    finally:
        conn.close()


def _snapshot_utilization(snap):
    """A replica's load factor in ``[0, 1]`` from its health snapshot:
    the max of every scheduler's slot and admission-queue occupancy
    (sustained ``pending`` pressure == spill — the scale-up signal),
    falling back to the server-wide in-flight ratio for replicas with
    no scheduler-backed model."""
    if not isinstance(snap, dict):
        return 0.0
    util = 0.0
    seen_scheduler = False
    for stats in (snap.get("models") or {}).values():
        if not isinstance(stats, dict):
            continue
        seen_scheduler = True
        slots = stats.get("max_slots") or 0
        if slots:
            util = max(util, float(stats.get("live_streams") or 0) / slots)
        pending_cap = stats.get("max_pending") or 0
        if pending_cap:
            util = max(
                util, float(stats.get("pending") or 0) / pending_cap)
    if not seen_scheduler:
        cap = snap.get("max_inflight") or 0
        if cap:
            util = float(snap.get("inflight") or 0) / cap
    return min(1.0, util)


def _snapshot_tripped(snap):
    """Whether any model's scheduler reports a sticky trip (in-process
    restart budget exhausted): the replica is alive but will never
    serve again without a process restart."""
    if not isinstance(snap, dict):
        return False
    return any(
        isinstance(stats, dict) and stats.get("tripped")
        for stats in (snap.get("models") or {}).values()
    )


class ReplicaProcess:
    """One supervised replica: the OS process, its address, and the
    healing state machine (``starting`` → ``up`` → ``stopping`` /
    ``backoff`` → … → ``retired``).  All mutable state is owned by the
    supervisor's monitor thread; readers go through :meth:`stats`."""

    def __init__(self, index, host, port, scope, role=None):
        self.index = index
        self.host = host
        self.port = port
        self.scope = scope
        # phase role ("prefill"/"decode") or None for a fused replica;
        # immutable for the handle's lifetime — healing respawns the
        # process with the same role, so a phase pool never shrinks
        # because one of its members crashed
        self.role = role
        self.url = "{}:{}".format(host, port)
        self._lock = threading.Lock()
        self.proc = None           # guarded-by: _lock
        self.state = "starting"    # guarded-by: _lock
        self.in_router = False     # guarded-by: _lock
        self.restarts = 0          # guarded-by: _lock
        self.started_at = 0.0      # guarded-by: _lock
        self.stop_deadline = 0.0   # guarded-by: _lock
        self.spawn_at = 0.0        # guarded-by: _lock
        self.probe_failures = 0    # guarded-by: _lock
        self.last_util = 0.0       # guarded-by: _lock
        self.scale_down = False    # guarded-by: _lock
        # the spawn nonce the live child advertises (manifest mode)
        self.nonce = None          # guarded-by: _lock
        # restart timestamps inside the sliding budget window
        self.restart_times = deque()  # guarded-by: _lock
        # manifest row describing a predecessor's child to try
        # adopting at start(); consumed (set to None) by start()
        self.adopt_row = None

    def pid(self):
        with self._lock:
            return self.proc.pid if self.proc is not None else None

    def stats(self):
        with self._lock:
            return {
                "index": self.index,
                "url": self.url,
                "scope": self.scope,
                "role": self.role,
                "state": self.state,
                "pid": self.proc.pid if self.proc is not None else None,
                "restarts": self.restarts,
                "in_router": self.in_router,
                "utilization": round(self.last_util, 4),
            }


class RouterProcess:
    """One supervised router process — the ACTIVE front tier or its
    warm STANDBY.  Same healing state machine as a replica
    (``starting`` → ``up`` → ``stopping``/``backoff`` → … →
    ``retired``); the ``role`` swaps on takeover while the port stays
    stable, so a client's url list never goes stale."""

    def __init__(self, role, host, port, partition=None):
        self.host = host
        self.port = port
        self.url = "{}:{}".format(host, port)
        self._lock = threading.Lock()
        self.role = role           # guarded-by: _lock
        # the generation-id partition this router OWNS (multi-active
        # tier); moves with the role on takeover, None for the standby
        self.partition = partition  # guarded-by: _lock
        self.proc = None           # guarded-by: _lock
        self.state = "starting"    # guarded-by: _lock
        self.restarts = 0          # guarded-by: _lock
        self.started_at = 0.0      # guarded-by: _lock
        self.stop_deadline = 0.0   # guarded-by: _lock
        self.spawn_at = 0.0        # guarded-by: _lock
        self.probe_failures = 0    # guarded-by: _lock
        self.nonce = None          # guarded-by: _lock
        self.restart_times = deque()  # guarded-by: _lock
        self.adopt_row = None      # predecessor's row (see ReplicaProcess)

    def stats(self):
        with self._lock:
            return {
                "role": self.role,
                "url": self.url,
                "state": self.state,
                "pid": self.proc.pid if self.proc is not None else None,
                "restarts": self.restarts,
                "partition": self.partition,
            }


class _RouterAdminClient:
    """The in-process :class:`~tpuserver_torch.fleet_router.FleetRouter` surface
    the supervisor (and its callers) use, spoken over HTTP to
    supervised router PROCESSES: ``url`` tracks the active router
    across takeovers, membership mutations broadcast to active and
    standby (the standby keeps its membership live too), reads go to
    the active."""

    def __init__(self, supervisor):
        self._sup = supervisor

    @property
    def url(self):
        return self._sup.active_router_url()

    @property
    def port(self):
        return int(self.url.rpartition(":")[2])

    def start(self):
        return self  # the supervisor owns the processes

    def stop(self):
        pass

    def attach_supervisor(self, stats_fn):
        pass  # cross-process: /router/stats cannot call back in-process

    def _get(self, path):
        host, _, port = self.url.rpartition(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=5)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            if resp.status != 200:
                return None
            return json.loads(resp.read())
        except (OSError, ValueError, http.client.HTTPException):
            return None
        finally:
            conn.close()

    def stats(self):
        return self._get("/router/stats") or {}

    def membership(self):
        got = self._get("/router/replicas")
        return (got or {}).get("replicas", [])

    def add_replica(self, url):
        self._sup._router_membership_post("add", url)

    def remove_replica(self, url):
        self._sup._router_membership_post("remove", url)


class FleetSupervisor:
    """Own N replica server processes end-to-end and front them with a
    dynamically-membered :class:`~tpuserver_torch.fleet_router.FleetRouter`.

    Parameters
    ----------
    command : list[str]
        argv template for one replica process; ``{port}``, ``{scope}``
        and ``{index}`` are substituted per spawn (see
        ``tpuserver_torch.fleet_cli.replica_command`` for the port's
        server, ``python -m tpuserver_torch.serve``).
    replicas / min_replicas / max_replicas
        Initial process count and the elastic-scaling bounds.  With
        role pools the bounds apply PER POOL (each phase scales
        between them independently).
    prefill_replicas / decode_replicas
        Opt-in disaggregated prefill/decode: spawn this many replicas
        per phase role (both must be >= 1 when either is set).  Each
        role-tagged replica gets ``--role <role>`` appended to its
        argv, advertises the role in its health snapshot, and is
        healed/scaled within its own pool; ``replicas`` then only adds
        extra fused capacity on top (its default is ignored).
    probe_interval_s / probe_timeout_s
        Monitor cadence and per-probe timeout.
    start_timeout_s
        How long a spawned replica may stay not-ready (warmup compiles
        included) before the start counts as a failed restart.
    drain_grace_s
        SIGTERM-to-SIGKILL window for planned restarts and scale-down
        (the replica's ``install_sigterm_drain`` drains inside it).
    max_restarts / restart_window_s / restart_backoff_s
        Per-replica restart budget (sliding window) and the exponential
        backoff base between attempts; budget exhausted ⇒ retired.
    unhealthy_after
        Consecutive failed probes of a live process that count as a
        wedge (a booted replica that stops answering without exiting).
    scale_high / scale_low
        Fleet-mean utilization thresholds (hysteresis band edges).
    scale_up_windows / scale_down_windows
        Consecutive monitor ticks the signal must persist before a
        scaling action fires; a middle-band tick resets both streaks.
    scale_cooldown_s
        Dead time after any scaling action (and any restart) before the
        next one may fire — boot transients never read as pressure.
    router_kwargs
        Extra :class:`FleetRouter` construction kwargs (e.g.
        ``probe_interval_s``, ``max_inflight``, ``port``) — the
        in-process router mode.
    router_command
        Opt-in SUPERVISED FRONT TIER: an argv template for a router
        *process* (``{port}``, ``{backends}``, ``{journal}``
        substituted per spawn — see ``python -m
        tpuserver_torch.fleet_cli --router-processes`` for the default
        built on ``python -m tpuserver_torch.router_cli``).  The
        supervisor spawns, probes, and
        heals the router under the same drain-first, restart-budgeted,
        retire-on-exhaustion policy replicas get; ``self.router``
        becomes an HTTP admin shim with the same surface.  None
        (default) keeps the in-process FleetRouter.
    router_standby
        With ``router_command``: also run a warm-standby router
        process tailing the same journal; on active death the standby
        is PROMOTED (and the casualty respawns as the new standby).
    router_journal
        The journal directory both router processes share.  Default: a
        fresh temporary directory owned (and removed) by the
        supervisor.
    router_port / standby_port
        Stable listen ports for the two router processes (0 = pick a
        free one at construction; the port then stays stable across
        restarts and role swaps).
    active_routers
        Horizontal front tier (requires ``router_command``): run N
        SIMULTANEOUSLY-ACTIVE routers, each owning a stable partition
        of the generation-id space with its own journal subdirectory
        (``p<index>`` under ``router_journal`` — single-writer stays
        an invariant per partition) and peer-forwarding requests that
        hash to a sibling.  On an active's death the standby promotes
        INTO the dead router's partition; partition-map changes
        broadcast to every router under a monotonically-bumped epoch.
        1 (default) keeps the single-active tier.
    env
        Extra environment for replica processes (merged over
        ``os.environ``).
    manifest_dir
        Opt-in SUPERVISOR CRASH DURABILITY: the fleet-state manifest
        directory (``tpuserver_torch.fleetmanifest``).  Every spawn /
        restart / retire / scale / promote is recorded off the hot
        path; a successor supervisor started with the SAME directory
        replays it and ADOPTS still-live children (pid + start-time
        token + spawn-nonce echo all required) instead of respawning
        a healthy fleet.  An exclusive ``flock`` on the directory
        enforces single-writer discipline — a second concurrent
        supervisor gets a typed :class:`fleetmanifest.ManifestLocked`
        refusal.
    takeover / takeover_timeout_s
        With ``manifest_dir``: wait (bounded) for the incumbent
        supervisor's lock instead of refusing — the supervised
        handover path.
    heartbeat_file
        Stamp a monotonic heartbeat (seq + adoption/healing counters
        + per-replica state) to this path every monitor tick, written
        atomically — an external watchdog or chaos harness detects a
        wedged/killed supervisor by the seq going stale.
    """

    #: manifest records between compacting checkpoints
    _CHECKPOINT_EVERY = 256

    def __init__(self, command, replicas=2, min_replicas=1,
                 max_replicas=None, host="127.0.0.1",
                 probe_interval_s=0.5, probe_timeout_s=2.0,
                 start_timeout_s=120.0, drain_grace_s=10.0,
                 max_restarts=5, restart_window_s=60.0,
                 restart_backoff_s=0.2, unhealthy_after=3,
                 scale_high=0.85, scale_low=0.10,
                 scale_up_windows=3, scale_down_windows=6,
                 scale_cooldown_s=2.0, scope_prefix="fleet-r",
                 router_kwargs=None, env=None, verbose=False,
                 router_command=None, router_standby=False,
                 router_journal=None, router_port=0, standby_port=0,
                 active_routers=1,
                 prefill_replicas=0, decode_replicas=0,
                 manifest_dir=None, takeover=False,
                 takeover_timeout_s=30.0, heartbeat_file=None):
        prefill_replicas = int(prefill_replicas)
        decode_replicas = int(decode_replicas)
        role_mode = prefill_replicas > 0 or decode_replicas > 0
        if role_mode and (prefill_replicas < 1 or decode_replicas < 1):
            raise ValueError(
                "a phase-split fleet needs at least one replica of "
                "EACH role (got prefill={}, decode={}) — a missing "
                "pool would silently serve every request fused"
                .format(prefill_replicas, decode_replicas))
        if role_mode:
            # role mode: the per-role targets ARE the fleet; 'replicas'
            # only adds extra fused capacity on top when given
            replicas = max(0, int(replicas)) if replicas != 2 else 0
        if replicas < 1 and not role_mode:
            raise ValueError("a fleet needs at least one replica")
        if min_replicas < 1 or (max_replicas is not None
                                and max_replicas < min_replicas):
            raise ValueError(
                "need 1 <= min_replicas <= max_replicas (got {}..{})"
                .format(min_replicas, max_replicas))
        if not (0.0 <= scale_low < scale_high <= 1.0):
            raise ValueError(
                "hysteresis band must satisfy 0 <= scale_low < "
                "scale_high <= 1 (got {}..{})".format(
                    scale_low, scale_high))
        self._command = list(command)
        self._host = host
        self._min_replicas = int(min_replicas)
        self._max_replicas = (int(max_replicas)
                              if max_replicas is not None else None)
        self._probe_interval_s = float(probe_interval_s)
        self._probe_timeout_s = float(probe_timeout_s)
        self._start_timeout_s = float(start_timeout_s)
        self._drain_grace_s = float(drain_grace_s)
        self._max_restarts = int(max_restarts)
        self._restart_window_s = float(restart_window_s)
        self._restart_backoff_s = float(restart_backoff_s)
        self._unhealthy_after = int(unhealthy_after)
        self._scale_high = float(scale_high)
        self._scale_low = float(scale_low)
        self._scale_up_windows = int(scale_up_windows)
        self._scale_down_windows = int(scale_down_windows)
        self._scale_cooldown_s = float(scale_cooldown_s)
        self._scope_prefix = scope_prefix
        self._env = dict(env or {})
        self._verbose = verbose
        self._lock = threading.Lock()
        # the managed set; retired handles stay (visible in stats) but
        # are skipped by every healing/scaling path
        # guarded-by: _lock
        self._handles = []
        self._next_index = 0       # guarded-by: _lock
        self._restarts_total = 0   # guarded-by: _lock
        self._scale_ups = 0        # guarded-by: _lock
        self._scale_downs = 0      # guarded-by: _lock
        self._retired = 0          # guarded-by: _lock
        # front-tier healing counters (router_command mode)
        self._router_restarts = 0  # guarded-by: _lock
        self._router_takeovers = 0  # guarded-by: _lock
        self._router_retired = 0   # guarded-by: _lock
        self._cooldown_until = 0.0
        self._stop = threading.Event()
        self._monitor = None
        # per-role scaling streaks (keys: None/"prefill"/"decode") —
        # each phase pool accumulates pressure independently, so a
        # decode-heavy workload grows decode capacity without touching
        # the prefill pool (and vice versa)
        self._role_up_streaks = {}
        self._role_down_streaks = {}
        # -- crash durability (manifest mode) -----------------------------
        self._heartbeat_file = heartbeat_file
        self._heartbeat_seq = 0          # guarded-by: _lock
        self._adoptions = 0              # guarded-by: _lock
        self._clean_handovers = 0        # guarded-by: _lock
        self._stale_reaped = 0           # guarded-by: _lock
        self._manifest_records = 0       # guarded-by: _lock
        self._records_since_checkpoint = 0  # guarded-by: _lock
        self._manifest = None
        self._manifest_lock_fd = None
        self._argv_hash = fleetmanifest.argv_template_hash(self._command)
        recovered = None
        if manifest_dir is not None:
            # single-writer discipline FIRST: the lock must be held
            # before we read state another supervisor may be writing
            self._manifest_lock_fd = fleetmanifest.acquire_manifest_lock(
                manifest_dir, takeover=takeover,
                timeout_s=takeover_timeout_s)
            records, _torn = fleetmanifest.read_manifest(manifest_dir)
            if records:
                recovered = fleetmanifest.fold_manifest(records)
            self._manifest = fleetmanifest.ManifestWriter(manifest_dir)
        if recovered is not None:
            counters = recovered["counters"]
            self._restarts_total = counters["replica_restarts"]
            self._scale_ups = counters["scale_up_events"]
            self._scale_downs = counters["scale_down_events"]
            self._retired = counters["retired_replicas"]
            self._router_restarts = counters["router_restarts"]
            self._router_takeovers = counters["router_takeovers"]
            self._router_retired = counters["router_retired"]
            self._adoptions = counters["adoptions"]
            self._clean_handovers = counters["clean_handovers"]
            self._stale_reaped = counters["stale_children_reaped"]
            self._manifest_records = counters["manifest_records"]
        if recovered is not None and recovered["replicas"]:
            # the manifest IS the fleet: rebuild handles with their
            # ports, roles, and restart-budget windows intact; start()
            # decides adopt-vs-respawn per child
            for index in sorted(recovered["replicas"]):
                row = recovered["replicas"][index]
                handle = ReplicaProcess(
                    index, host, int(row["port"]),
                    row.get("scope")
                    or "{}{}".format(scope_prefix, index),
                    role=row.get("role"))
                handle.restarts = int(row.get("restarts") or 0)
                handle.restart_times = deque(
                    row.get("restart_times") or [])
                if row.get("retired"):
                    handle.state = "retired"
                handle.adopt_row = dict(row)
                with self._lock:
                    self._handles.append(handle)
            with self._lock:
                self._next_index = max(
                    int(recovered["next_index"] or 0),
                    max(recovered["replicas"]) + 1)
            role_mode = role_mode or any(
                row.get("role")
                for row in recovered["replicas"].values())
        else:
            for _ in range(int(replicas)):
                self._register_handle()
            for _ in range(prefill_replicas):
                self._register_handle(role="prefill")
            for _ in range(decode_replicas):
                self._register_handle(role="decode")
        self._role_mode = role_mode
        self._router_command = (list(router_command)
                                if router_command else None)
        self._router_standby = bool(router_standby)
        self._active_routers = max(1, int(active_routers))
        if self._active_routers > 1 and self._router_command is None:
            raise ValueError(
                "active_routers > 1 needs router_command — only "
                "supervised router PROCESSES can partition the "
                "generation-id space (the in-process router is one "
                "object)")
        # partition-map epoch: bumps on every map change (takeover,
        # member coming up); routers adopt only strictly newer maps,
        # so a late broadcast can never roll ownership backwards.
        # Recovery: the epoch only ever bumps alongside a broadcast,
        # and takeovers are the floor — 1 + takeovers is >= any epoch
        # a predecessor pushed for those takeovers, and the adopting
        # supervisor re-broadcasts (bumping again) before it matters.
        self._partition_epoch = 1 + self._router_takeovers  # guarded-by: _lock
        self._journal_tmp = None
        self._router_journal = router_journal
        # router PROCESS handles (router_command mode); role swaps on
        # takeover, the list itself is fixed at construction
        # guarded-by: _lock
        self._router_handles = []
        if self._router_command is not None:
            # the supervised front tier: router processes sharing one
            # crash journal, fronted to callers by the admin shim
            if self._router_journal is None:
                if recovered is not None and recovered["router_journal"]:
                    # RE-ATTACH the predecessor's journal: the live
                    # (or respawning) routers' sticky state lives
                    # there, and ownership of a temp directory
                    # transfers to the adopting supervisor
                    self._router_journal = recovered["router_journal"]
                    if recovered["journal_owned"]:
                        self._journal_tmp = self._router_journal
                else:
                    self._journal_tmp = tempfile.mkdtemp(
                        prefix="tpu-router-journal-")
                    self._router_journal = self._journal_tmp
            if recovered is not None and recovered["routers"]:
                handles = []
                for port in sorted(
                        recovered["routers"],
                        key=lambda p: (recovered["routers"][p].get(
                            "role") != "active", p)):
                    row = recovered["routers"][port]
                    rhandle = RouterProcess(
                        row.get("role") or "active", host, port,
                        partition=row.get("partition"))
                    rhandle.restarts = int(row.get("restarts") or 0)
                    rhandle.restart_times = deque(
                        row.get("restart_times") or [])
                    if row.get("retired"):
                        rhandle.state = "retired"
                    rhandle.adopt_row = dict(row)
                    handles.append(rhandle)
                parts = [h.partition for h in handles
                         if h.partition is not None]
                if parts:
                    # the manifest IS the partition map too: the
                    # active-set width is however many partitions the
                    # predecessor ran, whatever this process was told
                    self._active_routers = max(
                        self._active_routers, max(parts) + 1)
                actives = sum(
                    1 for h in handles if h.role == "active")
                self._router_standby = (self._router_standby
                                        or len(handles) > actives)
            else:
                handles = [RouterProcess(
                    "active", host,
                    int(router_port) or _free_port(host),
                    partition=0 if self._active_routers > 1 else None)]
                for part in range(1, self._active_routers):
                    handles.append(RouterProcess(
                        "active", host, _free_port(host),
                        partition=part))
                if self._router_standby:
                    handles.append(RouterProcess(
                        "standby", host,
                        int(standby_port) or _free_port(host)))
            with self._lock:
                self._router_handles = handles
            self.router = _RouterAdminClient(self)
            self._manifest_append({
                "type": "config",
                "router_journal": self._router_journal,
                "journal_owned": self._journal_tmp is not None,
            })
        else:
            self.router = FleetRouter(
                [h.url for h in self._handles_snapshot()],
                **dict(router_kwargs or {}))
            self.router.attach_supervisor(self.stats)
        # the initial handles ARE the router's constructed membership
        # (in-process construction list / the spawned router's
        # --backends); record that so a replica dying before its first
        # ready probe still leaves the routing set instead of
        # lingering as a stale member
        for handle in self._handles_snapshot():
            with handle._lock:
                handle.in_router = True

    # -- lifecycle ---------------------------------------------------------

    def _register_handle(self, role=None):
        """Allocate a port + scope and register a fresh handle (called
        from __init__ and scale-up; ``role`` tags a phase-pool
        member)."""
        port = _free_port(self._host)
        with self._lock:
            index = self._next_index
            self._next_index += 1
            handle = ReplicaProcess(
                index, self._host, port,
                "{}{}".format(self._scope_prefix, index), role=role)
            self._handles.append(handle)
        return handle

    def _handles_snapshot(self):
        with self._lock:
            return list(self._handles)

    def start(self):
        now = time.monotonic()
        for handle in self._handles_snapshot():
            row, handle.adopt_row = handle.adopt_row, None
            if handle.stats()["state"] == "retired":
                continue
            if row is not None:
                if self._try_adopt_replica(handle, row):
                    continue
                # adoption refused (dead/stale/unreachable child): the
                # normal budget path charges the restart and schedules
                # the respawn with backoff — a crash-looping replica
                # must not dodge retirement by crashing the supervisor
                self._finish_stop(handle, now)
                continue
            self._spawn(handle)
        for rhandle in self._router_handles_snapshot():
            row, rhandle.adopt_row = rhandle.adopt_row, None
            if rhandle.stats()["state"] == "retired":
                continue
            if row is not None:
                if self._try_adopt_router(rhandle, row):
                    continue
                self._finish_router_stop(rhandle, now)
                continue
            self._spawn_router(rhandle)
        self.router.start()
        if self._manifest is not None:
            self._checkpoint_manifest()
        self._stamp_heartbeat()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="fleet-supervisor",
            daemon=True)
        self._monitor.start()
        return self

    def stop(self, drain_timeout_s=None):
        """Stop the fleet: SIGTERM every live replica AND router
        process (drain-first — the router flushes its journal inside
        the grace window), SIGKILL whatever outlives it."""
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=10)
            self._monitor = None
        grace = (self._drain_grace_s if drain_timeout_s is None
                 else drain_timeout_s)
        handles = self._handles_snapshot() + self._router_handles_snapshot()
        for handle in handles:
            self._signal(handle, signal.SIGTERM)
        deadline = time.monotonic() + grace
        for handle in handles:
            self._reap(handle, deadline - time.monotonic())
        for handle in self._router_handles_snapshot():
            # past-grace stragglers: the reap's kill covered them, but
            # an unkillable process must not wedge shutdown
            self._signal(handle, signal.SIGKILL)
        self.router.stop()
        # the final checkpoint records the fleet's last known shape;
        # the children are dead, so a successor respawns everything
        self._close_manifest(checkpoint=True)
        if self._journal_tmp is not None:
            shutil.rmtree(self._journal_tmp, ignore_errors=True)

    def handover(self, timeout_s=10.0):
        """Graceful supervisor handover (the manifest-mode SIGTERM
        disposition): checkpoint the manifest, release the writer
        lock, and exit WITHOUT touching the children — they keep
        serving unsupervised until a successor adopts them.  The
        in-process router (no router_command) cannot outlive this
        process, so it still stops; supervised router PROCESSES keep
        serving like the replicas."""
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=timeout_s)
            self._monitor = None
        with self._lock:
            self._clean_handovers += 1
        self._stamp_heartbeat()
        self._close_manifest(checkpoint=True)
        if not self._router_handles_snapshot():
            self.router.stop()

    def crash(self):
        """Die like SIGKILL (test/chaos hook): no checkpoint, no child
        signals, no journal cleanup — only what the kernel would do
        anyway (release the flock when the process vanishes), plus
        stopping the in-process router this process hosts."""
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=10)
            self._monitor = None
        if self._manifest is not None:
            self._manifest.close()
            self._manifest = None
        if self._manifest_lock_fd is not None:
            fleetmanifest.release_manifest_lock(self._manifest_lock_fd)
            self._manifest_lock_fd = None
        if not self._router_handles_snapshot():
            self.router.stop()

    def wait_ready(self, count=None, timeout_s=60.0):
        """Block until ``count`` replicas (default: every non-retired
        one) are up and routed; returns True on success."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            stats = self.stats()
            want = count if count is not None else sum(
                1 for r in stats["replicas"] if r["state"] != "retired")
            if sum(1 for r in stats["replicas"]
                   if r["state"] == "up") >= want:
                return True
            if self._stop.wait(0.05):
                return False
        return False

    # -- process plumbing --------------------------------------------------

    def _log(self, msg):
        if self._verbose:
            print("[fleet-supervisor] " + msg, file=sys.stderr,
                  flush=True)

    def _spawn(self, handle):
        argv = [
            t.format(port=handle.port, scope=handle.scope,
                     index=handle.index)
            for t in self._command
        ]
        if handle.role:
            # phase-pool member: the replica advertises its role in
            # /v2/health/stats so the router's prober can partition
            # the fleet into prefill/decode pools
            argv += ["--role", handle.role]
        nonce = None
        if self._manifest is not None:
            # the adoption contract's third identity: a successor only
            # adopts a pid whose /v2/health/stats echoes THIS nonce
            nonce = fleetmanifest.new_spawn_nonce()
            argv += ["--spawn-nonce", nonce]
        env = dict(os.environ)
        env.update(self._env)
        try:
            proc = subprocess.Popen(argv, env=env)
        except OSError as e:
            self._log("spawn of replica {} failed: {}".format(
                handle.url, e))
            proc = None
        now = time.monotonic()
        with handle._lock:
            handle.proc = proc
            handle.state = "starting"
            handle.started_at = now
            handle.probe_failures = 0
            handle.nonce = nonce
        if proc is not None and self._manifest is not None:
            self._manifest_append({
                "type": "spawn",
                "index": handle.index,
                "role": handle.role,
                "port": handle.port,
                "scope": handle.scope,
                "pid": proc.pid,
                "start_token": fleetmanifest.process_start_token(
                    proc.pid),
                "nonce": nonce,
                "argv_hash": self._argv_hash,
            })
        self._log("spawned replica {} (pid {})".format(
            handle.url, proc.pid if proc else "-"))

    def _signal(self, handle, signum):
        with handle._lock:
            proc = handle.proc
        if proc is None or proc.poll() is not None:
            return
        try:
            proc.send_signal(signum)
        except (ProcessLookupError, OSError):
            pass

    def _reap(self, handle, timeout_s):
        with handle._lock:
            proc = handle.proc
        if proc is None:
            return
        killed = False
        try:
            proc.wait(timeout=max(0.0, timeout_s))
        except subprocess.TimeoutExpired:
            killed = True
            try:
                proc.kill()
            except (ProcessLookupError, OSError):
                pass
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
        # an adopted pid is no child of ours: its exit code is unknown
        self._log("reaped {} (pid {}){}: exit code {}".format(
            handle.url, proc.pid, " after SIGKILL" if killed else "",
            "unknown (adopted)"
            if isinstance(proc, fleetmanifest.AdoptedProcess)
            else proc.returncode))

    def _leave_router(self, handle):
        with handle._lock:
            was_member = handle.in_router
            handle.in_router = False
        if not was_member:
            return
        try:
            self.router.remove_replica(handle.url)
        except KeyError:
            pass

    def _join_router(self, handle):
        with handle._lock:
            if handle.in_router:
                return
            handle.in_router = True
        try:
            self.router.add_replica(handle.url)
        except ValueError:
            pass  # already a member (initial membership)

    # -- the supervised front tier (router_command mode) -------------------

    def _router_handles_snapshot(self):
        with self._lock:
            return list(self._router_handles)

    def active_router_url(self):
        """The ACTIVE router's stable address (in-process mode: the
        embedded router's).  When no handle holds the active role —
        e.g. the active retired while its standby was down — prefer a
        LIVE handle over list order: admin reads against a corpse
        would answer nothing forever while a serving peer exists."""
        handles = self._router_handles_snapshot()
        if not handles:
            return self.router.url  # in-process FleetRouter
        rows = [(h, h.stats()) for h in handles]
        for handle, st in rows:
            if st["role"] == "active" and st["state"] != "retired":
                return handle.url
        for handle, st in rows:
            if st["state"] == "up":
                return handle.url
        return handles[0].url

    def router_urls(self):
        """Every router address, active first — the url list clients
        carry so a takeover costs one reconnect (the auto-resume
        helpers' ``fallback_urls``)."""
        handles = self._router_handles_snapshot()
        if not handles:
            return [self.router.url]
        ordered = sorted(
            handles, key=lambda h: h.stats()["role"] != "active")
        return [h.url for h in ordered]

    def _partition_map_snapshot(self):
        """url-by-partition for the active set ("" for a partition
        with no live owner — retired, or mid-takeover)."""
        urls = [""] * self._active_routers
        for handle in self._router_handles_snapshot():
            st = handle.stats()
            part = st.get("partition")
            if part is not None and st["state"] != "retired":
                urls[int(part)] = handle.url
        return urls

    def _router_argv(self, handle):
        backends = ",".join(
            h.url for h in self._handles_snapshot()
            if h.stats()["state"] != "retired")
        argv = [
            t.format(port=handle.port, backends=backends,
                     journal=self._router_journal)
            for t in self._router_command
        ]
        st = handle.stats()
        if st["role"] == "standby":
            argv.append("--standby")
        if self._active_routers > 1:
            # the partitioned tier: actives get their stable partition
            # index, the standby only the count (it tails EVERY
            # partition's journal until promoted into one); all carry
            # the current map + epoch so a respawn rejoins current
            argv += ["--partition-count", str(self._active_routers)]
            if st.get("partition") is not None:
                argv += ["--partition-index", str(st["partition"])]
            with self._lock:
                epoch = self._partition_epoch
            argv += ["--peers", ",".join(self._partition_map_snapshot()),
                     "--epoch", str(epoch)]
        return argv

    def _spawn_router(self, handle):
        argv = self._router_argv(handle)
        nonce = None
        if self._manifest is not None:
            nonce = fleetmanifest.new_spawn_nonce()
            argv += ["--spawn-nonce", nonce]
        env = dict(os.environ)
        env.update(self._env)
        try:
            proc = subprocess.Popen(argv, env=env)
        except OSError as e:
            self._log("spawn of router {} failed: {}".format(
                handle.url, e))
            proc = None
        now = time.monotonic()
        with handle._lock:
            role = handle.role
            partition = handle.partition
            handle.proc = proc
            handle.state = "starting"
            handle.started_at = now
            handle.probe_failures = 0
            handle.nonce = nonce
        if proc is not None and self._manifest is not None:
            self._manifest_append({
                "type": "router_spawn",
                "role": role,
                "partition": partition,
                "port": handle.port,
                "pid": proc.pid,
                "start_token": fleetmanifest.process_start_token(
                    proc.pid),
                "nonce": nonce,
            })
        self._log("spawned {} router {} (pid {})".format(
            role, handle.url, proc.pid if proc else "-"))

    def _router_membership_post(self, action, url):
        """Apply one membership mutation to EVERY live router process
        (the standby keeps its membership warm too).  A router that is
        down simply misses the post — its respawn rebuilds
        ``--backends`` from the current handle set."""
        body = json.dumps({"action": action, "url": url})
        for handle in self._router_handles_snapshot():
            if handle.stats()["state"] not in ("up", "starting"):
                continue
            conn = http.client.HTTPConnection(
                handle.host, handle.port, timeout=self._probe_timeout_s)
            try:
                conn.request("POST", "/router/replicas", body,
                             {"Content-Type": "application/json"})
                conn.getresponse().read()
            except (OSError, http.client.HTTPException):
                pass
            finally:
                conn.close()

    def _promote_standby(self, handle, payload=None):
        """POST the takeover signal to a standby router; True when the
        promotion was acknowledged.  ``payload`` (partitioned tier)
        names the partition the standby promotes INTO plus the new
        map + epoch it should serve."""
        body = (json.dumps(payload).encode("utf-8")
                if payload else b"{}")
        conn = http.client.HTTPConnection(
            handle.host, handle.port, timeout=self._probe_timeout_s)
        try:
            conn.request("POST", "/router/promote", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            # a 200 from an already-active router counts too: the
            # takeover's goal state (an active on that address) holds
            return resp.status == 200
        except (OSError, http.client.HTTPException):
            return False
        finally:
            conn.close()

    def _bump_partition_epoch(self):
        """Mint the next partition-map epoch (bumped eagerly — a
        broadcast/promote that then fails just skips a value; epochs
        only need monotonicity, not density)."""
        with self._lock:
            self._partition_epoch += 1
            return self._partition_epoch

    def _broadcast_partition_map(self):
        """Push the current partition map under a FRESH epoch to every
        live router: actives peer-forward by it, the standby keeps it
        warm for promotion.  Routers adopt only strictly newer epochs,
        so a reordered/late post can never roll ownership backwards; a
        router that is down simply misses the post — its respawn argv
        carries the then-current map."""
        if self._active_routers <= 1:
            return
        body = json.dumps({
            "action": "set_map",
            "map": self._partition_map_snapshot(),
            "epoch": self._bump_partition_epoch(),
        })
        for handle in self._router_handles_snapshot():
            if handle.stats()["state"] not in ("up", "starting"):
                continue
            conn = http.client.HTTPConnection(
                handle.host, handle.port, timeout=self._probe_timeout_s)
            try:
                conn.request("POST", "/router/partition", body,
                             {"Content-Type": "application/json"})
                conn.getresponse().read()
            except (OSError, http.client.HTTPException):
                pass
            finally:
                conn.close()

    def _router_takeover(self, casualty, alive):
        """The active router died (or wedged): promote the warm
        standby when one is up — clients carrying both urls reconnect
        once and resume against journal-recovered state — and re-roll
        the casualty as the NEW standby; otherwise the casualty simply
        respawns active with ``--journal`` and recovers from disk."""
        standby = None
        for handle in self._router_handles_snapshot():
            if handle is casualty:
                continue
            st = handle.stats()
            if st["role"] == "standby" and st["state"] == "up":
                standby = handle
                break
        if standby is not None and alive:
            # single-writer discipline: a wedged-but-RUNNING active
            # may still be appending to the journal, and the promoted
            # standby is about to open its own writer — draining the
            # casualty here would interleave two writers in one
            # directory.  A wedged router's streams are already lost
            # to their clients (that is what the probe failures mean);
            # resuming them through the new active IS the recovery
            # path, so the casualty goes down hard, and the promote
            # only fires once its process is provably gone.
            self._begin_router_restart(casualty, "wedged", drain=False)
            deadline = time.monotonic() + 2.0
            while time.monotonic() < deadline:
                with casualty._lock:
                    proc = casualty.proc
                if proc is None or proc.poll() is not None:
                    break
                time.sleep(0.02)
        payload = None
        part = None
        if standby is not None:
            with casualty._lock:
                part = casualty.partition
            if part is not None:
                # partitioned tier: the standby promotes INTO the
                # casualty's partition — scoped journal re-attach plus
                # the map rebind, under a fresh epoch
                peers = self._partition_map_snapshot()
                peers[part] = standby.url
                payload = {"partition": part, "peers": peers,
                           "epoch": self._bump_partition_epoch()}
        if standby is not None and self._promote_standby(standby,
                                                         payload):
            with standby._lock:
                standby.role = "active"
                standby.partition = part
            with casualty._lock:
                casualty.role = "standby"
                casualty.partition = None
            with self._lock:
                self._router_takeovers += 1
            self._manifest_append({
                "type": "promote",
                "active_port": standby.port,
                "standby_port": casualty.port,
                "partition": part,
            })
            if part is not None:
                # siblings (and the demoted slot, once respawned)
                # learn the rebind; clients chase it via the epoch in
                # /router/stats and resume answers
                self._broadcast_partition_map()
            self._log(
                "router takeover: standby {} promoted to active"
                "{}; {} will respawn as the new standby".format(
                    standby.url,
                    " (partition {})".format(part)
                    if part is not None else "",
                    casualty.url))
        if alive:
            if standby is None:
                # no standby to protect: drain first (the router
                # flushes its journal on SIGTERM), SIGKILL past the
                # grace window — there is no second writer to race
                self._begin_router_restart(casualty, "wedged",
                                           drain=True)
        else:
            self._finish_router_stop(casualty, time.monotonic())

    def _begin_router_restart(self, handle, reason, drain):
        self._log("restarting router {} ({}{})".format(
            handle.url, reason, ", drain-first" if drain else ""))
        now = time.monotonic()
        with handle._lock:
            handle.state = "stopping"
            handle.stop_deadline = now + (self._drain_grace_s
                                          if drain else 0.0)
        self._signal(handle,
                     signal.SIGTERM if drain else signal.SIGKILL)

    def _finish_router_stop(self, handle, now):
        """The router process is gone: retire on an exhausted budget,
        else schedule the respawn with backoff (same sliding-window
        policy the replicas get)."""
        with handle._lock:
            window = handle.restart_times
            while window and now - window[0] > self._restart_window_s:
                window.popleft()
            if len(window) >= self._max_restarts:
                handle.state = "retired"
                retired = True
            else:
                window.append(now)
                handle.restarts += 1
                handle.state = "backoff"
                handle.spawn_at = now + self._restart_backoff_s * (
                    2 ** max(0, len(window) - 1))
                retired = False
            restarts = handle.restarts
            window_copy = list(window)
        with self._lock:
            if retired:
                self._router_retired += 1
            else:
                self._router_restarts += 1
        self._manifest_append({
            "type": "router_retire" if retired else "router_restart",
            "port": handle.port,
            "restarts": restarts, "restart_times": window_copy,
        })
        if retired:
            self._log(
                "router {} exhausted its restart budget ({} in {}s) — "
                "retired; the front tier degrades to its peer".format(
                    handle.url, self._max_restarts,
                    self._restart_window_s))

    def _tick_routers(self, now):
        for handle in self._router_handles_snapshot():
            with handle._lock:
                state = handle.state
                role = handle.role
                proc = handle.proc
                stop_deadline = handle.stop_deadline
                spawn_at = handle.spawn_at
                started_at = handle.started_at
            if state == "retired":
                continue
            exited = proc is None or proc.poll() is not None
            if state == "stopping":
                if exited:
                    self._finish_router_stop(handle, now)
                elif now >= stop_deadline:
                    self._signal(handle, signal.SIGKILL)
                continue
            if state == "backoff":
                if now >= spawn_at:
                    self._spawn_router(handle)
                continue
            if exited:
                # unplanned death (SIGKILL/crash): an active's standby
                # promotes NOW — the takeover, the whole point of the
                # warm copy — and the casualty respawns as standby
                if role == "active":
                    self._router_takeover(handle, alive=False)
                else:
                    self._finish_router_stop(handle, now)
                continue
            snap = _fetch_health(handle.host, handle.port,
                                 self._probe_timeout_s)
            if snap is None:
                with handle._lock:
                    handle.probe_failures += 1
                    failures = handle.probe_failures
                if state == "starting":
                    if now - started_at > self._start_timeout_s:
                        self._begin_router_restart(
                            handle, "never came up", drain=False)
                elif failures >= self._unhealthy_after:
                    # alive but not answering: a wedged front tier is
                    # a total outage — fail over to the standby first,
                    # then drain-replace the process
                    if role == "active":
                        self._router_takeover(handle, alive=True)
                    else:
                        self._begin_router_restart(
                            handle, "wedged", drain=True)
                continue
            with handle._lock:
                handle.probe_failures = 0
                if handle.state == "starting":
                    handle.state = "up"
                    came_up = True
                else:
                    came_up = False
            if came_up:
                self._log("{} router {} is up".format(role, handle.url))
                # partitioned tier: a member coming up (respawned
                # casualty, healed active) re-syncs everyone's map —
                # its own argv carried the spawn-time map, but siblings
                # may have learned it is back only just now
                self._broadcast_partition_map()

    # -- healing -----------------------------------------------------------

    def _begin_restart(self, handle, reason, drain):
        """Take a replica out of rotation and (drain-)stop its process;
        the monitor finishes the restart once the process exits."""
        self._log("restarting replica {} ({}{})".format(
            handle.url, reason, ", drain-first" if drain else ""))
        self._leave_router(handle)
        now = time.monotonic()
        with handle._lock:
            handle.state = "stopping"
            handle.stop_deadline = now + (self._drain_grace_s
                                          if drain else 0.0)
        if drain:
            self._signal(handle, signal.SIGTERM)
        else:
            self._signal(handle, signal.SIGKILL)

    def _finish_stop(self, handle, now):
        """The process is gone: either drop it (scale-down), retire it
        (budget exhausted), or schedule the respawn with backoff."""
        with handle._lock:
            scale_down = handle.scale_down
        if scale_down:
            with self._lock:
                if handle in self._handles:
                    self._handles.remove(handle)
            self._manifest_append({
                "type": "scale", "action": "down",
                "index": handle.index,
            })
            self._log("scale-down of replica {} complete".format(
                handle.url))
            return
        with handle._lock:
            window = handle.restart_times
            while window and now - window[0] > self._restart_window_s:
                window.popleft()
            if len(window) >= self._max_restarts:
                handle.state = "retired"
                retired = True
            else:
                window.append(now)
                handle.restarts += 1
                handle.state = "backoff"
                handle.spawn_at = now + self._restart_backoff_s * (
                    2 ** max(0, len(window) - 1))
                retired = False
            restarts = handle.restarts
            window_copy = list(window)
        with self._lock:
            if retired:
                self._retired += 1
            else:
                self._restarts_total += 1
        # CLOCK_MONOTONIC is system-wide: the recorded window stays
        # comparable in a successor supervisor, so an adopted replica
        # cannot dodge retirement across a supervisor restart
        if retired:
            self._manifest_append({
                "type": "retire", "index": handle.index,
                "restart_times": window_copy,
            })
        else:
            self._manifest_append({
                "type": "restart", "index": handle.index,
                "restarts": restarts, "restart_times": window_copy,
            })
        if retired:
            self._log(
                "replica {} exhausted its restart budget ({} in {}s) — "
                "retired; the fleet degrades, it does not flap".format(
                    handle.url, self._max_restarts,
                    self._restart_window_s))

    # -- crash durability (manifest mode) ----------------------------------

    def _manifest_append(self, record):
        """Record one fleet-state mutation (no-op without a manifest);
        the enqueue is lock-free, so healing never blocks on I/O."""
        if self._manifest is None:
            return
        self._manifest.append(record)
        with self._lock:
            self._manifest_records += 1
            self._records_since_checkpoint += 1

    def _checkpoint_manifest(self):
        if self._manifest is None:
            return
        self._manifest.checkpoint(self._manifest_state())
        with self._lock:
            self._records_since_checkpoint = 0

    def _handle_start_token(self, handle):
        """The recorded/observable start token for a handle's process:
        an adopted child carries its own, a spawned child's is read
        from /proc."""
        with handle._lock:
            proc = handle.proc
        if proc is None:
            return None
        token = getattr(proc, "start_token", None)
        if token is not None:
            return token
        return fleetmanifest.process_start_token(proc.pid)

    def _manifest_state(self):
        """The checkpoint snapshot: everything ``fold_manifest`` would
        reconstruct from the full record stream, captured live."""
        with self._lock:
            handles = list(self._handles)
            router_handles = list(self._router_handles)
            counters = {
                "replica_restarts": self._restarts_total,
                "scale_up_events": self._scale_ups,
                "scale_down_events": self._scale_downs,
                "retired_replicas": self._retired,
                "router_restarts": self._router_restarts,
                "router_takeovers": self._router_takeovers,
                "router_retired": self._router_retired,
                "adoptions": self._adoptions,
                "clean_handovers": self._clean_handovers,
                "stale_children_reaped": self._stale_reaped,
                "manifest_records": self._manifest_records,
            }
            next_index = self._next_index
        replicas = []
        for handle in handles:
            token = self._handle_start_token(handle)
            with handle._lock:
                replicas.append({
                    "index": handle.index,
                    "role": handle.role,
                    "port": handle.port,
                    "scope": handle.scope,
                    "pid": (handle.proc.pid
                            if handle.proc is not None else None),
                    "start_token": token,
                    "nonce": handle.nonce,
                    "argv_hash": self._argv_hash,
                    "restarts": handle.restarts,
                    "restart_times": list(handle.restart_times),
                    "retired": handle.state == "retired",
                })
        routers = []
        for handle in router_handles:
            token = self._handle_start_token(handle)
            with handle._lock:
                routers.append({
                    "port": handle.port,
                    "role": handle.role,
                    "partition": handle.partition,
                    "pid": (handle.proc.pid
                            if handle.proc is not None else None),
                    "start_token": token,
                    "nonce": handle.nonce,
                    "restarts": handle.restarts,
                    "restart_times": list(handle.restart_times),
                    "retired": handle.state == "retired",
                })
        return {
            "counters": counters,
            "next_index": next_index,
            "router_journal": self._router_journal,
            "journal_owned": self._journal_tmp is not None,
            "replicas": replicas,
            "routers": routers,
        }

    def _stamp_heartbeat(self):
        """Externally observable supervisor liveness + adoption
        counters (tmp + atomic replace; an unwritable path degrades
        observability, never supervision)."""
        if self._heartbeat_file is None:
            return
        with self._lock:
            self._heartbeat_seq += 1
            beat = {
                "seq": self._heartbeat_seq,
                "monotonic": time.monotonic(),
                "pid": os.getpid(),
                "adoptions": self._adoptions,
                "clean_handovers": self._clean_handovers,
                "stale_children_reaped": self._stale_reaped,
                "replica_restarts": self._restarts_total,
            }
            handles = list(self._handles)
            router_handles = list(self._router_handles)
        beat["replicas"] = [
            {"index": r["index"], "pid": r["pid"], "url": r["url"],
             "state": r["state"], "restarts": r["restarts"]}
            for r in (h.stats() for h in handles)]
        beat["routers"] = [
            {"role": r["role"], "pid": r["pid"], "url": r["url"],
             "state": r["state"], "restarts": r["restarts"]}
            for r in (h.stats() for h in router_handles)]
        tmp = self._heartbeat_file + ".tmp"
        try:
            with open(tmp, "w") as fh:
                json.dump(beat, fh)
            os.replace(tmp, self._heartbeat_file)
        except OSError:
            pass

    def _close_manifest(self, checkpoint=True):
        if self._manifest is not None:
            if checkpoint:
                self._checkpoint_manifest()
            self._manifest.flush()
            self._manifest.close()
            self._manifest = None
        if self._manifest_lock_fd is not None:
            fleetmanifest.release_manifest_lock(self._manifest_lock_fd)
            self._manifest_lock_fd = None

    def _try_adopt_replica(self, handle, row):
        """Claim a predecessor's live child when all three identities
        agree (pid start token, spawn nonce echo, argv template); a
        live-but-stale child is reaped drain-first, a dead one just
        reports unadoptable — the caller charges the restart budget
        either way."""
        pid = row.get("pid")
        token = row.get("start_token")
        if not pid or token is None or not row.get("nonce"):
            self._log("replica {}: manifest row incomplete — "
                      "respawning".format(handle.url))
            return False
        if fleetmanifest.process_start_token(pid) != token:
            self._log("replica {}: recorded pid {} is gone — "
                      "respawning".format(handle.url, pid))
            return False
        proc = fleetmanifest.AdoptedProcess(pid, token)
        if row.get("argv_hash") != self._argv_hash:
            self._reap_stale(handle, proc,
                             "argv template changed", drain=True)
            return False
        snap = _fetch_health(handle.host, handle.port,
                             self._probe_timeout_s)
        if snap is None:
            self._reap_stale(handle, proc, "unreachable", drain=True)
            return False
        if snap.get("spawn_nonce") != row["nonce"]:
            self._reap_stale(handle, proc,
                             "spawn nonce mismatch", drain=True)
            return False
        now = time.monotonic()
        with handle._lock:
            handle.proc = proc
            handle.state = "up" if snap.get("ready") else "starting"
            handle.started_at = now
            handle.probe_failures = 0
            handle.nonce = row["nonce"]
            # already a member when it reads up (see the monitor's boot
            # path): the router's membership was built from every
            # handle, adopted ones included
            handle.in_router = True
        with self._lock:
            self._adoptions += 1
        self._log("adopted replica {} (pid {}, {} restart(s) on the "
                  "books)".format(handle.url, pid, handle.restarts))
        return True

    def _try_adopt_router(self, handle, row):
        """Router twin of :meth:`_try_adopt_replica`.  A stale router
        goes down HARD (SIGKILL): it may still hold the journal
        writer, and the respawn opening its own would interleave two
        writers in one directory."""
        pid = row.get("pid")
        token = row.get("start_token")
        if not pid or token is None or not row.get("nonce"):
            return False
        if fleetmanifest.process_start_token(pid) != token:
            self._log("router {}: recorded pid {} is gone — "
                      "respawning".format(handle.url, pid))
            return False
        proc = fleetmanifest.AdoptedProcess(pid, token)
        snap = _fetch_health(handle.host, handle.port,
                             self._probe_timeout_s)
        if snap is None or snap.get("spawn_nonce") != row["nonce"]:
            self._reap_stale(
                handle, proc,
                "unreachable" if snap is None else "spawn nonce "
                "mismatch", drain=False)
            return False
        now = time.monotonic()
        with handle._lock:
            handle.proc = proc
            handle.state = "up"
            handle.started_at = now
            handle.probe_failures = 0
            handle.nonce = row["nonce"]
        with self._lock:
            self._adoptions += 1
        if self._active_routers > 1:
            # epoch floor: the live router may hold a higher epoch
            # than 1 + takeovers (came-up broadcasts bump it too);
            # adopting its value keeps our next broadcast adoptable
            conn = http.client.HTTPConnection(
                handle.host, handle.port, timeout=self._probe_timeout_s)
            try:
                conn.request("GET", "/router/stats")
                resp = conn.getresponse()
                if resp.status == 200:
                    got = json.loads(resp.read())
                    with self._lock:
                        self._partition_epoch = max(
                            self._partition_epoch,
                            int(got.get("epoch") or 0))
            except (OSError, ValueError, http.client.HTTPException):
                pass
            finally:
                conn.close()
        self._log("adopted {} router {} (pid {})".format(
            handle.role, handle.url, pid))
        return True

    def _reap_stale(self, handle, proc, reason, drain):
        """A live process squats an adoptable slot but fails the
        identity contract: stop it (drain-first for replicas, hard for
        routers) before the slot respawns on its port."""
        self._log("reaping stale child on {} ({})".format(
            handle.url, reason))
        with handle._lock:
            handle.proc = proc
        self._signal(handle,
                     signal.SIGTERM if drain else signal.SIGKILL)
        self._reap(handle, self._drain_grace_s if drain else 5.0)
        with handle._lock:
            handle.proc = None
        with self._lock:
            self._stale_reaped += 1

    # -- the monitor -------------------------------------------------------

    def _monitor_loop(self):
        while not self._stop.wait(self._probe_interval_s):
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 — the supervisor
                # must outlive any single bad tick (a dying monitor
                # would silently end all healing)
                self._log("monitor tick failed: {}".format(e))

    def _tick(self):
        now = time.monotonic()
        self._stamp_heartbeat()
        if self._manifest is not None:
            with self._lock:
                due = (self._records_since_checkpoint
                       >= self._CHECKPOINT_EVERY)
            if due:
                self._checkpoint_manifest()
        self._tick_routers(now)
        utils = []
        for handle in self._handles_snapshot():
            with handle._lock:
                state = handle.state
                proc = handle.proc
                stop_deadline = handle.stop_deadline
                spawn_at = handle.spawn_at
                started_at = handle.started_at
            if state == "retired":
                continue
            exited = proc is None or proc.poll() is not None
            if state == "stopping":
                if exited:
                    self._finish_stop(handle, now)
                elif now >= stop_deadline:
                    self._signal(handle, signal.SIGKILL)
                continue
            if state == "backoff":
                if now >= spawn_at:
                    self._spawn(handle)
                continue
            if exited:
                # unplanned death (SIGKILL, crash, OOM): there is
                # nothing left to drain — restart immediately
                self._leave_router(handle)
                self._finish_stop(handle, now)
                continue
            snap = _fetch_health(handle.host, handle.port,
                                 self._probe_timeout_s)
            if snap is None:
                with handle._lock:
                    handle.probe_failures += 1
                    failures = handle.probe_failures
                if state == "starting":
                    if now - started_at > self._start_timeout_s:
                        self._begin_restart(
                            handle, "never became ready", drain=False)
                elif failures >= self._unhealthy_after:
                    # alive but not answering: a wedge — drain what can
                    # still drain, then replace the process
                    self._begin_restart(handle, "wedged", drain=True)
                continue
            with handle._lock:
                handle.probe_failures = 0
                handle.last_util = _snapshot_utilization(snap)
                utils.append((handle, handle.last_util))
            if _snapshot_tripped(snap):
                self._begin_restart(
                    handle, "scheduler tripped", drain=True)
                continue
            if snap.get("ready"):
                if state == "starting":
                    # join first: ``up`` is what wait_ready() and the
                    # stats report, so a caller that sends traffic the
                    # moment it reads ``up`` finds the replica routed
                    self._join_router(handle)
                    with handle._lock:
                        handle.state = "up"
                    self._log("replica {} is up".format(handle.url))
                    # boot is not a utilization signal; let the
                    # cooldown absorb the membership change
                    self._cooldown_until = max(
                        self._cooldown_until,
                        now + self._scale_cooldown_s)
            elif (state == "starting"
                    and now - started_at > self._start_timeout_s):
                # answers probes but never reports ready: the start
                # failed just as surely as a dead socket — without
                # this branch such a replica would sit in 'starting'
                # forever (probes succeed, so neither the timeout-on-
                # unreachable nor the wedge path can fire).  The
                # process is alive: drain what can drain.
                self._begin_restart(
                    handle, "never became ready", drain=True)
        self._evaluate_scaling(
            [(h, u) for h, u in utils if h.stats()["state"] == "up"],
            now)

    # -- elastic scaling ---------------------------------------------------

    def _evaluate_scaling(self, pairs, now):
        """Role-aware elastic scaling: each phase pool (``prefill`` /
        ``decode`` / fused ``None``) accumulates its own hysteresis
        streaks from its own members' utilization and scales between
        ``min_replicas``/``max_replicas`` (interpreted per pool)
        independently — a prompt-heavy workload grows the prefill pool
        without adding idle decode capacity, and vice versa.  Streak
        accounting always runs; at most one scaling ACTION fires per
        tick, and the global cooldown + settling gates cover every
        pool (a booting prefill spawn also defers decode actions — the
        fleet mean is in flux either way)."""
        if not pairs:
            return
        by_role = {}
        for handle, util in pairs:
            by_role.setdefault(handle.role, []).append(util)
        ready = []
        for role in sorted(by_role,
                           key=lambda r: (r is not None, r or "")):
            utils = by_role[role]
            pool_util = sum(utils) / len(utils)
            up = self._role_up_streaks.get(role, 0)
            down = self._role_down_streaks.get(role, 0)
            if pool_util >= self._scale_high:
                up += 1
                down = 0
            elif pool_util <= self._scale_low:
                down += 1
                up = 0
            else:
                # the hysteresis band: a noisy middle window resets
                # both streaks — scaling only fires on SUSTAINED signal
                up = 0
                down = 0
            self._role_up_streaks[role] = up
            self._role_down_streaks[role] = down
            ready.append((role, pool_util, up, down))
        if now < self._cooldown_until:
            return
        states = [h.stats()["state"] for h in self._handles_snapshot()]
        if any(s in ("starting", "backoff", "stopping") for s in states):
            # the fleet is still SETTLING from a previous action (a
            # spawn booting, a drain in flight, a respawn pending):
            # the utilization mean does not yet reflect that decision,
            # so acting again would double-fire — e.g. a scale-up's
            # replica boots slower than the streak re-accumulates
            return
        for role, pool_util, up, down in ready:
            pool = [h for h in self._handles_snapshot()
                    if h.role == role and h.stats()["state"] != "retired"]
            label = role or "fused"
            if (up >= self._scale_up_windows
                    and (self._max_replicas is None
                         or len(pool) < self._max_replicas)):
                self._role_up_streaks[role] = 0
                self._cooldown_until = now + self._scale_cooldown_s
                with self._lock:
                    self._scale_ups += 1
                handle = self._register_handle(role=role)
                self._manifest_append({
                    "type": "scale", "action": "up",
                    "index": handle.index,
                })
                self._log(
                    "scale-up: {} pool utilization {:.2f} sustained — "
                    "spawning replica {}".format(
                        label, pool_util, handle.url))
                self._spawn(handle)
                return
            if (down >= self._scale_down_windows
                    and len(pool) > self._min_replicas):
                self._role_down_streaks[role] = 0
                self._cooldown_until = now + self._scale_cooldown_s
                ups = [h for h in pool if h.stats()["state"] == "up"]
                if not ups:
                    continue
                # drain the least-loaded, youngest replica of the pool
                victim = min(
                    ups,
                    key=lambda h: (h.stats()["utilization"], -h.index))
                with self._lock:
                    self._scale_downs += 1
                with victim._lock:
                    victim.scale_down = True
                self._log(
                    "scale-down: {} pool utilization {:.2f} sustained "
                    "— draining replica {}".format(
                        label, pool_util, victim.url))
                self._begin_restart(victim, "scale-down", drain=True)
                return

    # -- observability -----------------------------------------------------

    def stats(self):
        """Counters + per-replica state; the flat counter names are
        what ``/router/stats`` (and with it the perf tooling's
        ``router_snapshot`` window diffs) carry."""
        with self._lock:
            out = {
                "replica_restarts": self._restarts_total,
                "scale_up_events": self._scale_ups,
                "scale_down_events": self._scale_downs,
                "retired_replicas": self._retired,
                "min_replicas": self._min_replicas,
                "max_replicas": self._max_replicas,
                "adoptions": self._adoptions,
                "clean_handovers": self._clean_handovers,
                "stale_children_reaped": self._stale_reaped,
                "manifest_records": self._manifest_records,
            }
            handles = list(self._handles)
            router_handles = list(self._router_handles)
            router_restarts = self._router_restarts
            router_takeovers = self._router_takeovers
            router_retired = self._router_retired
        out["replicas"] = [h.stats() for h in handles]
        out["up"] = sum(1 for r in out["replicas"] if r["state"] == "up")
        if self._role_mode:
            # phase-pool occupancy: up-replica counts per role (what a
            # caller reads after role-aware scaling and healing)
            phase_up = {}
            for row in out["replicas"]:
                if row["state"] == "up":
                    key = row["role"] or "fused"
                    phase_up[key] = phase_up.get(key, 0) + 1
            out["phase_replicas_up"] = phase_up
        if router_handles:
            # the supervised front tier (router_command mode)
            out["router_restarts"] = router_restarts
            out["router_takeovers"] = router_takeovers
            out["router_retired"] = router_retired
            out["routers"] = [h.stats() for h in router_handles]
            if self._active_routers > 1:
                out["partition_map"] = self._partition_map_snapshot()
                with self._lock:
                    out["partition_epoch"] = self._partition_epoch
        return out
