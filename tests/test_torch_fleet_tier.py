"""The port's fleet tier (``tpuserver_torch``'s journal, fleetmanifest,
disagg and fleet_router) held against the JAX package's on the same
inputs.  The JAX fleet tier needs no JAX arrays, so both run in this
process.

- the journal: byte-identical segment files, each package reading and
  tailing the other's, a torn tail cut at the same record;
- the manifest: byte-identical segments, equal folds, the same argv
  hash, and each package's lock excluding the other's holder;
- disagg: the leg helpers and the orchestrator's stats keys;
- the router: identical picks over 50 prompts with shared prefixes on
  the same injected health snapshots; over the same ``fleet_stub.py``
  backends the same ``/router/stats`` keys, ``/metrics`` families and
  relayed SSE bytes; a standby of one package taking over the other's
  journal and resuming a handed-off (``gen~offset/seq``) generation;
- the slice end to end: float32 ``tiny`` prefill and decode replicas
  (``HttpServer``, ``device="cpu"``) behind the port's router against
  JAX replicas behind JAX's: the same tokens, splits and transfers,
  and the same tokens fused once the decode pool is emptied;
- isolation: the fleet-tier modules import no JAX and no
  ``tpuserver``, and ``router_cli`` starts with ``-m`` in an
  interpreter that has no ``tpuserver`` on its path.

Every wait polls its condition under a deadline of its own; every
spawned process is reaped in a ``finally``."""

import http.client
import json
import os
import shutil
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from tpuserver import disagg as jd
from tpuserver import fleetmanifest as jm
from tpuserver import journal as jj
from tpuserver import router as jr
from tpuserver_torch import disagg as td
from tpuserver_torch import fleet_router as tr
from tpuserver_torch import fleetmanifest as tm
from tpuserver_torch import journal as tj

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SRC_PY = os.path.join(REPO, "src", "python")
STUB = os.path.join(HERE, "fleet_stub.py")
sys.path.insert(0, HERE)
from fleet_stub import free_port, wait_ready  # noqa: E402
from torch_port_helpers import (  # noqa: E402,F401 (fixtures)
    one_torch_thread, tiny_cfgs, tparams, wait_for)

pytestmark = pytest.mark.torch_port

PKGS = {"jax": (jj, jm, jd, jr), "port": (tj, tm, td, tr)}
DIRECTIONS = [("jax", "port"), ("port", "jax")]
STUB_PATH = "/v2/models/stub/generate_stream"
FLEET_TIER = ("_clock", "_retry", "_http_base", "journal", "fleetmanifest",
              "disagg", "fleet_router", "router_cli", "fleet", "fleet_cli",
              "chaoslib", "chaos_campaign")


class _Clock:
    """A hand-stepped monotonic clock for the journal writers."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


# the resume-critical records a router journals, every kind once or more
RECORDS = (
    [{"t": "bind", "gen": "g1", "path": STUB_PATH,
      "req": {"inputs": [{"name": "PROMPT_IDS", "data": [5, 7, 9]}],
              "parameters": {"generation_id": "g1"}},
      "home": "127.0.0.1:8001"},
     {"t": "home", "gen": "g1", "url": "127.0.0.1:8002", "offset": 3}]
    + [{"t": "ev", "gen": "g1", "seq": i, "id": "g1~3/{}".format(i),
        "payload": {"outputs": [{"name": "TOKEN", "data": [i * 7 % 100]}],
                    "parameters": {"seq": i, "note": "é ü"}}}
       for i in range(6)]
    + [{"t": "fin", "gen": "g1"}, {"t": "drop", "gen": "g2"}])


def _write_journal(mod, directory, batches):
    """``batches`` through one writer of ``mod``, the clock stepped past
    the rotation interval between batches (one segment each)."""
    clock = _Clock()
    writer = mod.JournalWriter(directory, rotate_interval_s=10.0,
                               flush_interval_s=0.005, clock=clock)
    try:
        for batch in batches:
            for rec in batch:
                writer.append(rec)
            assert writer.flush()
            clock.now += 11.0
    finally:
        writer.close()


def _segments(directory):
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


# -- the journal --------------------------------------------------------------


def test_journal_segments_are_byte_identical(tmp_path):
    """The same records through both writers, in two rotated segments:
    the same file names and the same bytes (``<u32 len><u32 crc32>``
    framing over compact JSON)."""
    batches = [RECORDS[:5], RECORDS[5:]]
    for name, (mod, *_) in PKGS.items():
        _write_journal(mod, str(tmp_path / name), batches)
    jax_segs, port_segs = (_segments(str(tmp_path / n)) for n in PKGS)
    assert list(jax_segs) == ["seg-00000001.log", "seg-00000002.log"]
    assert port_segs == jax_segs


@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=["jax-written", "port-written"])
def test_read_journal_reads_the_other_packages_segments(tmp_path, writer,
                                                        reader):
    d = str(tmp_path / "j")
    _write_journal(PKGS[writer][0], d, [RECORDS[:4], RECORDS[4:]])
    records, truncated = PKGS[reader][0].read_journal(d)
    assert (records, truncated) == (RECORDS, 0)
    assert PKGS[writer][0].read_journal(d) == (records, truncated)


@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=["jax-writer", "port-writer"])
def test_follower_tails_the_other_packages_writer(tmp_path, writer, reader):
    """A follower of one package tails a live writer of the other
    incrementally, across a rotation."""
    d = str(tmp_path / "j")
    clock = _Clock()
    w = PKGS[writer][0].JournalWriter(d, rotate_interval_s=10.0,
                                      flush_interval_s=0.005, clock=clock)
    follower = PKGS[reader][0].JournalFollower(d)
    try:
        for rec in RECORDS[:3]:
            w.append(rec)
        assert w.flush()
        assert follower.poll() == RECORDS[:3]
        assert follower.poll() == []
        clock.now += 11.0
        for rec in RECORDS[3:]:
            w.append(rec)
        assert w.flush()
        assert follower.poll() == RECORDS[3:]
    finally:
        w.close()
    assert len(os.listdir(d)) == 2


@pytest.mark.parametrize("damage", ["torn", "corrupt"])
def test_torn_tail_is_cut_at_the_same_record(tmp_path, damage):
    """A torn final frame (a length promising bytes never written) or a
    checksum-corrupt last record: both packages keep the same clean
    prefix and count one truncated segment."""
    d = str(tmp_path / "j")
    _write_journal(jj, d, [RECORDS])
    path = os.path.join(d, "seg-00000001.log")
    clean = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(clean + b"\x40\x00\x00\x00\x01\x02torn" if damage == "torn"
                 else clean[:-3] + b"XYZ")
    want = RECORDS if damage == "torn" else RECORDS[:-1]
    assert jj.read_journal(d) == (want, 1)
    assert tj.read_journal(d) == (want, 1)
    # a follower of either package stops at the same record
    assert tj.JournalFollower(d).poll() == jj.JournalFollower(d).poll() \
        == want


# -- the manifest -------------------------------------------------------------


def _manifest_stream():
    """Spawns, a restart, an adoption-shaped respawn, a retire, scaling,
    the router tier's records, a config and a compacting checkpoint with
    records replayed over it."""
    spawn = [{"type": "spawn", "index": i, "role": role, "port": 9100 + i,
              "scope": "fleet-r{}".format(i), "pid": 4000 + i,
              "start_token": 777 + i, "nonce": "n{}".format(i),
              "argv_hash": "deadbeef"}
             for i, role in enumerate(["prefill", "decode", None])]
    before = spawn + [
        {"type": "config", "router_journal": "/var/j", "journal_owned": 1},
        {"type": "router_spawn", "port": 9000, "role": "active",
         "partition": None, "pid": 5000, "start_token": 1, "nonce": "r0"},
        {"type": "router_spawn", "port": 9001, "role": "standby",
         "partition": None, "pid": 5001, "start_token": 2, "nonce": "r1"},
        {"type": "restart", "index": 1, "restarts": 1,
         "restart_times": [12.5]},
        dict(spawn[1], pid=4011, start_token=900, nonce="n1b"),
        {"type": "scale", "action": "up", "index": 3},
        dict(spawn[2], index=3, port=9103, scope="fleet-r3", pid=4003),
        {"type": "scale", "action": "down", "index": 2},
        {"type": "retire", "index": 0, "restart_times": [1.0, 2.0]},
        {"type": "promote", "active_port": 9001, "standby_port": 9000},
        {"type": "router_restart", "port": 9000, "restarts": 1,
         "restart_times": [40.0]},
    ]
    state = jm.fold_manifest(before)
    checkpoint = {"type": "checkpoint", "state": {
        "replicas": list(state["replicas"].values()),
        "routers": list(state["routers"].values()),
        "counters": dict(state["counters"], adoptions=2,
                         clean_handovers=1),
        "next_index": state["next_index"],
        "router_journal": state["router_journal"],
        "journal_owned": state["journal_owned"]}}
    after = [
        {"type": "restart", "index": 3, "restarts": 1,
         "restart_times": [50.0]},
        {"type": "router_retire", "port": 9000},
        dict(spawn[0], index=4, port=9104, scope="fleet-r4", pid=4004),
    ]
    return before, checkpoint, after


def test_manifest_folds_and_segments_equal(tmp_path):
    """One record stream (before a checkpoint, the checkpoint, after
    it) through both ``ManifestWriter``s: byte-identical segments, each
    package's ``read_manifest`` reads the other's, and the folds of
    every prefix of the stream are equal."""
    before, checkpoint, after = _manifest_stream()
    stream = before + [checkpoint] + after
    for i in range(len(stream) + 1):
        assert tm.fold_manifest(stream[:i]) == jm.fold_manifest(stream[:i])
    dirs = {}
    for name, (_, mod, *_) in PKGS.items():
        d = dirs[name] = str(tmp_path / name)
        writer = mod.ManifestWriter(d)
        try:
            for rec in before:
                writer.append(rec)
            writer.checkpoint(checkpoint["state"])
            for rec in after:
                writer.append(rec)
            assert writer.flush()
        finally:
            writer.close()
    assert _segments(dirs["port"]) == _segments(dirs["jax"])
    jax_records = jm.read_manifest(dirs["port"])
    assert tm.read_manifest(dirs["jax"]) == jax_records
    assert tm.fold_manifest(jax_records[0]) == jm.fold_manifest(
        jax_records[0])
    folded = tm.fold_manifest(jax_records[0])
    assert sorted(folded["replicas"]) == [0, 1, 3, 4]
    assert folded["counters"]["adoptions"] == 2


@pytest.mark.parametrize("argv", [
    [sys.executable, "-m", "tpuserver_torch.serve", "--port", "{port}",
     "--fault-scope", "{scope}"],
    ["python", "tests/fleet_stub.py", "--port", "{port}", "--scope",
     "{scope}", "--spec-tokens", 4],
    []], ids=["serve", "stub", "empty"])
def test_argv_template_hash_is_equal(argv):
    assert tm.argv_template_hash(argv) == jm.argv_template_hash(argv)


@pytest.mark.parametrize("holder,comer", DIRECTIONS,
                         ids=["jax-holds", "port-holds"])
def test_manifest_lock_excludes_the_other_packages_holder(tmp_path, holder,
                                                          comer):
    """One package's supervisor lock refuses the other's (typed
    ``ManifestLocked`` naming the holder), and a bounded takeover wait
    succeeds once it is released."""
    d = str(tmp_path / "m")
    fd = PKGS[holder][1].acquire_manifest_lock(d)
    try:
        with pytest.raises(PKGS[comer][1].ManifestLocked) as err:
            PKGS[comer][1].acquire_manifest_lock(d)
        assert err.value.holder_pid == os.getpid()
        released = threading.Timer(
            0.2, PKGS[holder][1].release_manifest_lock, args=(fd,))
        released.start()
        fd2 = PKGS[comer][1].acquire_manifest_lock(d, takeover=True,
                                                   timeout_s=10.0)
        released.join()
        PKGS[comer][1].release_manifest_lock(fd2)
    finally:
        PKGS[holder][1].release_manifest_lock(fd)


# -- disagg -------------------------------------------------------------------


def _gen_json(prompt, max_tokens, **params):
    return {"inputs": [
        {"name": "PROMPT_IDS", "datatype": "INT32", "shape": [len(prompt)],
         "data": list(prompt)},
        {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
         "data": [max_tokens]}], "parameters": params}


DESCRIPTOR = {"generation_id": "g", "name": "kvexport/g",
              "raw_handle": {"b64": "AAAA"}, "position": 21,
              "shape": [2, 2, 1, 64, 2, 16], "dtype": "float32",
              "byte_size": 32768, "device_id": 0}


@pytest.mark.parametrize("body", [
    _gen_json([1, 2, 3], 10, generation_id="g-1"),
    _gen_json(list(range(40)), 1, generation_id="g-2", eos_id=7),
    _gen_json([9], 5),
    {"inputs": [{"name": "TEXT", "data": ["x"]}]}],
    ids=["gid", "eos", "no-gid", "no-contract"])
def test_disagg_leg_helpers_are_equal(body):
    raw = json.dumps(body).encode("utf-8")
    assert td.PREFILL_LEG_ID_SUFFIX == jd.PREFILL_LEG_ID_SUFFIX
    gid = (body.get("parameters") or {}).get("generation_id", "")
    assert td.prefill_leg_id(gid) == jd.prefill_leg_id(gid)
    assert td.prefill_leg_body(raw) == jd.prefill_leg_body(raw)
    assert td.attach_body(raw, DESCRIPTOR) == jd.attach_body(raw,
                                                             DESCRIPTOR)


def _unstarted(mod, urls, **kwargs):
    return mod.FleetRouter(urls, port=0, **kwargs)


def _close(router):
    # never started, so there is no serve loop for stop() to shut down
    router._httpd.server_close()


def test_orchestrator_stats_keys_are_equal():
    routers = {k: _unstarted(PKGS[k][3], ["127.0.0.1:1"]) for k in PKGS}
    try:
        stats = {k: r.disagg.stats() for k, r in routers.items()}
    finally:
        for r in routers.values():
            _close(r)
    assert stats["port"] == stats["jax"]
    assert set(stats["port"]) == {
        "splits", "fallbacks", "transfers", "transfer_bytes",
        "transfer_ms_total", "prefill_queue_ms_total", "prefill_replicas",
        "decode_replicas", "phase_queue_depth"}


# -- router decisions ---------------------------------------------------------


def _snapshot(ready=True, state="ready", inflight=0, live=0, pending=0,
              role=None, tripped=False):
    return {"ready": ready, "state": state, "inflight": inflight,
            "role": role, "models": {"llama_generate": {
                "live_streams": live, "pending": pending,
                "tripped": tripped}}}


# per replica, the snapshots of three rounds (round r from prompt 17 r on)
ROUNDS = [
    [_snapshot(inflight=1), _snapshot(live=2), _snapshot(pending=1),
     _snapshot(ready=False, state="starting")],
    [_snapshot(state="draining", ready=False), _snapshot(live=1),
     _snapshot(pending=3), _snapshot()],
    [_snapshot(inflight=2), _snapshot(tripped=True), _snapshot(live=1),
     _snapshot(live=1)],
]


def _prompts():
    """50 prompts in 6 families sharing a 16-token prefix (one KV
    page, the affinity key's span), suffixes diverse."""
    rng = np.random.RandomState(7)
    heads = [list(rng.randint(0, 512, 16)) for _ in range(6)]
    return [heads[i % 6] + list(rng.randint(0, 512, 1 + i % 5))
            for i in range(50)]


def test_router_picks_are_identical_over_shared_prefix_prompts():
    """Both routers over the same four replicas, fed the same health
    snapshots (three rounds: load, a drain, a trip): the same
    ``pick_for_generation`` choice for each of 50 prompts with shared
    prefixes (affinity map and its counter included), the same
    ``pick_replica`` choice with and without exclusions, and the same
    affinity hit count.  Each pick holds one in-flight request on its
    replica, so the load moves as it would under traffic."""
    urls = ["127.0.0.1:{}".format(9500 + i) for i in range(4)]
    routers = {k: _unstarted(PKGS[k][3], urls) for k in PKGS}
    picks = {k: [] for k in PKGS}
    try:
        for name, router in routers.items():
            mod = PKGS[name][3]
            reps = router._replicas_snapshot()
            for i, prompt in enumerate(_prompts()):
                if i % 17 == 0:
                    for rep, snap in zip(reps, ROUNDS[i // 17]):
                        rep.update_snapshot(snap)
                gen = mod._Generation("g{}".format(i), STUB_PATH,
                                      _gen_json(prompt, 8))
                rep = router.pick_for_generation(gen)
                rep.begin_request()
                if i % 5 == 4:
                    reps[i % 4].end_request()  # a stream finished
                plain = router.pick_replica(exclude=(rep.url,))
                healthy = router.pick_replica(healthy_only=True)
                picks[name].append((rep.url, plain.url,
                                    healthy and healthy.url))
            picks[name].append(router.stats()["affinity_routed"])
    finally:
        for r in routers.values():
            _close(r)
    assert picks["port"] == picks["jax"]
    assert picks["jax"][-1] > 0  # affinity decided some picks
    assert len({p[0] for p in picks["jax"][:-1]}) > 1


# -- over fleet_stub backends -------------------------------------------------


def _spawn_stubs(roles):
    ports, procs = [], []
    for role in roles:
        ports.append(free_port())
        cmd = [sys.executable, STUB, "--port", str(ports[-1])]
        if role:
            cmd += ["--role", role]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.DEVNULL))
    for port in ports:
        assert wait_ready(port), "stub replica never became ready"
    return ports, procs


def _reap(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
    for proc in procs:
        proc.wait(timeout=30)


def _stub_body(gid, n_tokens, delay_ms=0, prompt=(5, 7, 9)):
    return json.dumps(_gen_json(list(prompt), n_tokens, generation_id=gid,
                                token_delay_ms=delay_ms)).encode("utf-8")


def _raw_stream(port, body, last_event_id=None):
    """``(status, the response body's bytes)``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    headers = {"Content-Type": "application/json"}
    if last_event_id is not None:
        headers["Last-Event-ID"] = last_event_id
    try:
        conn.request("POST", STUB_PATH, body, headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _events(port, body, last_event_id=None, stop_after=None, on_event=None):
    """``[(id line, payload)]`` up to the final event (or ``stop_after``
    events, the connection then dropped), and whether it was final."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    headers = {"Content-Type": "application/json"}
    if last_event_id is not None:
        headers["Last-Event-ID"] = last_event_id
    events, final, id_line = [], False, None
    try:
        conn.request("POST", STUB_PATH, body, headers)
        resp = conn.getresponse()
        assert resp.status == 200, (resp.status, resp.read())
        for raw in resp:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b"id: "):
                id_line = line[4:].decode("utf-8")
            elif line.startswith(b"data: "):
                payload = json.loads(line[len(b"data: "):])
                if payload.get("final"):
                    final = True
                    break
                assert "error" not in payload, payload
                events.append((id_line, payload))
                if on_event is not None:
                    on_event(len(events))
                if stop_after is not None and len(events) >= stop_after:
                    break
    finally:
        conn.close()
    return events, final


def _tokens(events):
    return [e[1]["outputs"][0]["data"][0] for e in events]


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode("utf-8")
    finally:
        conn.close()


def _key_tree(obj):
    """The nested key structure of a JSON value (values dropped; a
    list's entries merged)."""
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        merged = {}
        for item in obj:
            sub = _key_tree(item)
            if isinstance(sub, dict):
                merged.update(sub)
        return [merged] if merged else []
    return None


def _families(text):
    return sorted(line.split()[2] for line in text.splitlines()
                  if line.startswith("# TYPE "))


def test_routers_over_the_same_stubs_give_the_same_wire():
    """Both routers, started over one ``prefill`` and one ``decode``
    stub: the same generation phase-split through each gives the same
    SSE bytes (ids, payloads, terminal event) and the same split and
    transfer counts; ``/router/stats`` has the same key tree,
    ``/metrics`` the same families, and a unary verb and an unknown
    generation's resume get the same status."""
    ports, procs = _spawn_stubs(["prefill", "decode"])
    urls = ["127.0.0.1:{}".format(p) for p in ports]
    routers = {}
    try:
        for name in PKGS:
            routers[name] = PKGS[name][3].FleetRouter(
                urls, probe_interval_s=0.1).start()
            wait_for(lambda: routers[name].disagg.stats()[
                "decode_replicas"] == 1, "the decode pool")
        out = {}
        for name, router in routers.items():
            status, body = _raw_stream(router.port,
                                       _stub_body("same-gen", 8))
            missing = _raw_stream(router.port, _stub_body("nope", 8),
                                  last_event_id="nope~2/4")[0]
            ready = _get(router.port, "/v2/health/ready")[0]
            stats = json.loads(_get(router.port, "/router/stats")[1])
            metrics = _get(router.port, "/metrics")[1]
            out[name] = (status, body, missing, ready,
                         stats["disagg"]["splits"],
                         stats["disagg"]["transfers"], _key_tree(stats),
                         _families(metrics))
    finally:
        for router in routers.values():
            router.stop()
        _reap(procs)
    assert out["port"] == out["jax"]
    status, body, _, _, splits, transfers = out["port"][:6]
    assert status == 200 and splits == transfers == 1
    assert body.count(b"data: ") == 9 and b'"final": true' in body
    fams = out["port"][-1]
    for prefix in ("tpu_router_", "tpu_disagg_"):
        assert any(f.startswith(prefix) for f in fams), prefix


@pytest.mark.parametrize("active_pkg,standby_pkg", DIRECTIONS,
                         ids=["jax-active", "port-active"])
def test_standby_takes_over_the_other_packages_journal(tmp_path, active_pkg,
                                                       standby_pkg):
    """An active router of one package journals a generation whose home
    replica is SIGKILLed after 3 events (a cross-replica handoff: its
    ids turn ``gen~offset/seq``); the client drops after 8.  A standby
    of the other package tails the same journal, is promoted once the
    active is gone, and serves the marked resume: the tokens equal an
    uninterrupted run, seqs gap-free."""
    ports, procs = _spawn_stubs([None, None])
    urls = ["127.0.0.1:{}".format(p) for p in ports]
    jdir = str(tmp_path / "journal")
    active = standby = None
    try:
        reference = _tokens(_events(ports[0], _stub_body("ref", 12))[0])
        active = PKGS[active_pkg][3].FleetRouter(
            urls, journal=jdir, probe_interval_s=0.1,
            journal_flush_s=0.005).start()
        standby = PKGS[standby_pkg][3].FleetRouter(
            urls, journal=jdir, standby=True, probe_interval_s=0.1).start()
        killed = []

        def kill_home(n):
            if n == 3 and not killed:
                home = active.generation_snapshot("hagen")["home"]
                procs[urls.index(home)].send_signal(signal.SIGKILL)
                killed.append(home)

        events, _ = _events(active.port, _stub_body("hagen", 12, 40),
                            stop_after=8, on_event=kill_home)
        last_id = events[-1][0]
        assert killed and "~" in last_id, last_id
        assert _tokens(events) == reference[:8]
        wait_for(lambda: (standby.generation_snapshot("hagen")
                                or {}).get("seq", 0) >= 8,
                       "the standby's copy of the 8 relayed events")
        active.stop()
        standby.promote()
        assert standby.stats()["takeovers"] == 1
        assert standby.stats()["recovered_generations"] >= 1
        events2, final = _events(standby.port, _stub_body("hagen", 12),
                                 last_event_id=last_id)
        assert final
        assert _tokens(events) + _tokens(events2) == reference
        assert [e[1]["parameters"]["seq"] for e in events2] == list(
            range(8, 12))
    finally:
        for router in (active, standby):
            if router is not None:
                router.stop()
        _reap(procs)


# -- the slice end to end on float32 tiny -------------------------------------


MAX_SEQ = 64
N_TOK = 8
LLAMA_PATH = "/v2/models/llama_generate/generate_stream"


def _llama_prompts():
    rng = np.random.RandomState(11)
    return [list(map(int, rng.randint(1, 512, n))) for n in (20, 7, 33)]


def _llama_stream(port, prompt, gid):
    """(tokens, seqs) of one generation through a router."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    body = json.dumps(_gen_json(prompt, N_TOK, generation_id=gid))
    tokens, seqs, final = [], [], False
    try:
        conn.request("POST", LLAMA_PATH, body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200, (resp.status, resp.read())
        for raw in resp:
            line = raw.strip()
            if line.startswith(b"id: "):
                seqs.append(int(line.rsplit(b"/", 1)[1]))
            elif line.startswith(b"data: "):
                event = json.loads(line[len(b"data: "):])
                if event.get("final"):
                    final = True
                    break
                assert "error" not in event, event
                tokens.append(event["outputs"][0]["data"][0])
    finally:
        conn.close()
    assert final
    return tokens, seqs


def _jax_replicas():
    from tpuserver.core import InferenceServer
    from tpuserver.http_frontend import HttpFrontend
    from tpuserver.models.llama_serving import LlamaGenerateModel

    out = []
    for role in ("prefill", "decode"):
        core = InferenceServer([LlamaGenerateModel(
            cfg=tiny_cfgs()[0], max_seq=MAX_SEQ, max_slots=4)], role=role)
        out.append((core, HttpFrontend(core, port=0).start()))
    return out


def _port_replicas(tparams):
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.http_server import HttpServer
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel

    out = []
    for role in ("prefill", "decode"):
        core = InferenceServer([LlamaGenerateModel(
            cfg=tiny_cfgs()[1], max_seq=MAX_SEQ, max_slots=4,
            params=tparams, device="cpu")], role=role)
        out.append((core, HttpServer(core, port=0).start()))
    return out


def _run_slice(router_mod, replicas):
    """Each prompt phase-split through a router of ``router_mod`` over
    ``replicas``, then again with the decode replica removed (fused on
    the prefill one): (split tokens, fused tokens, splits, transfers,
    splits after the removal, the decode replica's attach count or
    None)."""
    urls = ["127.0.0.1:{}".format(fe.port) for _, fe in replicas]
    router = router_mod.FleetRouter(urls, probe_interval_s=0.1,
                                    gen_ttl_s=30.0).start()
    try:
        wait_for(lambda: router.disagg.stats()["decode_replicas"] == 1
                       and router.disagg.stats()["prefill_replicas"] == 1,
                       "both role pools", timeout=120)
        split = []
        for i, prompt in enumerate(_llama_prompts()):
            tokens, seqs = _llama_stream(router.port, prompt,
                                         "split-{}".format(i))
            assert seqs == list(range(N_TOK))
            split.append(tokens)
        s1 = router.disagg.stats()
        router.remove_replica(urls[1])
        wait_for(lambda: router.disagg.stats()["decode_replicas"] == 0,
                       "the decode pool empty")
        fused = [_llama_stream(router.port, p, "fused-{}".format(i))[0]
                 for i, p in enumerate(_llama_prompts())]
        s2 = router.disagg.stats()
        snap = replicas[1][0].health_snapshot()["models"]["llama_generate"]
        return (split, fused, s1["splits"], s1["transfers"], s2["splits"],
                snap.get("attach_admissions"))
    finally:
        router.stop()


def test_phase_split_slice_streams_jax_tokens_through_the_port_tier(
        tparams):
    """Float32 ``tiny`` (weights bridged from ``init_params(PRNGKey(0))``):
    a port prefill and decode replica (``HttpServer``, ``device="cpu"``)
    behind the port's router, and JAX replicas (``HttpFrontend``) behind
    JAX's: identical tokens per prompt, 3 splits and 3 transfers on
    both, every decode leg attached on the port's decode replica; with
    the decode pool emptied both fuse on the prefill replica with the
    same tokens."""
    results = {}
    for name, make in (("jax", _jax_replicas),
                       ("port", lambda: _port_replicas(tparams))):
        replicas = make()
        try:
            results[name] = _run_slice(PKGS[name][3], replicas)
        finally:
            for core, fe in replicas:
                fe.stop()
                core.close()
    jax_out, port_out = results["jax"], results["port"]
    assert port_out[0] == jax_out[0]
    assert port_out[1] == jax_out[1] == jax_out[0]
    assert port_out[2:5] == jax_out[2:5] == (3, 3, 3)
    assert port_out[5] == 3


# -- isolation ----------------------------------------------------------------


def test_fleet_tier_modules_import_neither_jax_nor_tpuserver():
    """The twelve fleet-tier modules are among the port's walked
    modules, and importing all of them (with the rest of the package)
    in a fresh interpreter loads no jax, tpuserver, tritonclient or
    ml_dtypes, and not torch either: the router and supervisor
    processes carry no model runtime."""
    script = (
        "import pkgutil, sys\n"
        "tier = ['tpuserver_torch.' + n for n in sys.argv[1:]]\n"
        "for n in tier:\n"
        "    __import__(n)\n"
        "light = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "               ('torch', 'numpy'))\n"
        "import tpuserver_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    tpuserver_torch.__path__, 'tpuserver_torch.')]\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'tpuserver', 'tritonclient', 'ml_dtypes'))\n"
        "print(len(names), len(set(tier) - set(names)), bad, light)\n")
    proc = subprocess.run(
        [sys.executable, "-c", script] + list(FLEET_TIER),
        env=dict(os.environ, PYTHONPATH=SRC_PY), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count, unwalked, bad, light = proc.stdout.split(" ", 3)
    assert int(count) >= 10 + len(FLEET_TIER)
    assert (unwalked, bad, light.strip()) == ("0", "[]", "[]")


def _isolated_path(tmp_path):
    """A directory holding a copy of the port alone (no ``tpuserver``,
    no ``tritonclient``)."""
    root = tmp_path / "isolated"
    shutil.copytree(os.path.join(SRC_PY, "tpuserver_torch"),
                    str(root / "tpuserver_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return str(root)


def test_router_cli_starts_without_tpuserver_on_the_path(tmp_path):
    """``python -m tpuserver_torch.router_cli`` from a path that holds the
    port alone (``import tpuserver`` fails there) serves a stub fleet,
    and its SIGTERM drains and exits 0."""
    path = _isolated_path(tmp_path)
    env = dict(os.environ, PYTHONPATH=path)
    check = subprocess.run([sys.executable, "-c", "import tpuserver"],
                           env=env, cwd=path, capture_output=True)
    assert check.returncode != 0
    ports, procs = _spawn_stubs([None])
    router = subprocess.Popen(
        [sys.executable, "-m", "tpuserver_torch.router_cli", "--backends",
         "127.0.0.1:{}".format(ports[0]), "--port", "0",
         "--probe-interval", "0.1"], env=env, cwd=path,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        first = router.stdout.readline()
        assert first.startswith("fleet router listening on"), first
        port = int(first.split()[4].rsplit(":", 1)[1])
        events, final = _events(port, _stub_body("iso", 5))
        assert final and len(events) == 5
        router.send_signal(signal.SIGTERM)
        assert router.wait(timeout=30) == 0
        assert "router stopped" in router.stdout.read()
    finally:
        if router.poll() is None:
            router.kill()
            router.wait(timeout=30)
        _reap(procs)
