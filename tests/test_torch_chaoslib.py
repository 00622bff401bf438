"""The port's chaos engine (``tpuserver_torch.chaoslib`` and
``tpuserver_torch.chaos_campaign``) held against the JAX package's on
the same inputs: the seeded fault schedules entry for entry over every
fault kind, each invariant check's verdict and violation fields on
planted inputs, the metrics monotonicity check against one scrape
target, and the campaign CLI's printed schedule.  The port's one
deliberate difference: ``check_shm_consistency`` is written against
``cuda_shm_status``, where a port core keeps its ``kvexport/*``
regions, and a planted export that was never released is a violation
there.  Two short campaigns on a supervised stub fleet end clean."""

import json
import os
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest
import torch

from tpuserver import chaoslib as jc
from tpuserver_torch import chaoslib as tc

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SRC_PY = os.path.join(REPO, "src", "python")
JAX_TOOL = os.path.join(REPO, "tools", "chaos_campaign.py")

pytestmark = pytest.mark.torch_port

ALL_KINDS = sorted(jc.FAULT_KINDS)


def test_fault_kinds_are_equal():
    assert tc.FAULT_KINDS == jc.FAULT_KINDS
    assert tc.SERIAL_GAP_S == jc.SERIAL_GAP_S


@pytest.mark.parametrize("seed", range(21))
def test_fault_schedule_matches_jax(seed):
    """Every kind composed over three cycles: the same entries (cycle,
    kind, offset, pick, knobs), the same description, and the same
    fired prefix per cycle."""
    port = tc.FaultSchedule.compose(seed, ALL_KINDS, 3, window_s=2.0)
    jax = jc.FaultSchedule.compose(seed, ALL_KINDS, 3, window_s=2.0)
    assert port.to_json() == jax.to_json()
    assert port.describe() == jax.describe()
    assert [port.kinds_through(c) for c in range(3)] == [
        jax.kinds_through(c) for c in range(3)]


def _violations(recorder):
    return [(v.invariant, v.context, v.details) for v in recorder.violations]


def _adoption_case(mod, rec):
    before = {0: {"index": 0, "pid": 10, "restarts": 0, "role": "prefill"},
              1: {"index": 1, "pid": 11, "restarts": 1, "role": "decode"},
              2: {"index": 2, "pid": 12, "restarts": 0, "role": None}}
    after = {"adoptions": 1, "replicas": [
        {"index": 0, "pid": 10, "restarts": 0, "role": "prefill"},
        {"index": 1, "pid": 99, "restarts": 2, "role": "decode"},
        {"index": 2, "pid": 12, "restarts": 0, "role": "decode"}]}
    return [mod.check_supervisor_adoption(rec, before, {0, 2}, after,
                                          context="c"),
            mod.check_supervisor_adoption(rec, before, {0, 1, 2}, {
                "adoptions": 3, "replicas": list(before.values())})]


# each: (name, a function of (module, recorder) -> the verdicts)
CHECKS = {
    "token_identity": lambda m, r: [
        m.check_token_identity(r, [1, 2], [1, 2]),
        m.check_token_identity(r, [1, 2], [1, 3], context="c0")],
    "seq_continuity": lambda m, r: [
        m.check_seq_continuity(r, [0, 1, 2], expected_len=3),
        m.check_seq_continuity(r, [0, 2]),
        m.check_seq_continuity(r, [0, 0, 1], context="dup"),
        m.check_seq_continuity(r, [0, 1], expected_len=3)],
    "counters_monotonic": lambda m, r: [
        m.check_counters_monotonic(r, {"a": 1, "b": 5}, {"a": 1, "b": 9},
                                   ("a", "b")),
        m.check_counters_monotonic(r, {"a": 4}, {"a": 2}, ("a",),
                                   context="k")],
    "journal_single_writer": lambda m, r: [
        m.check_journal_single_writer(r, [
            {"role": "active", "state": "up", "pid": 1},
            {"role": "standby", "state": "up", "pid": 2}]),
        m.check_journal_single_writer(r, [
            {"role": "active", "state": "up", "pid": 1},
            {"role": "active", "state": "up", "pid": 2}], context="two"),
        m.check_journal_single_writer(r, [
            {"role": "active", "state": "up", "pid": 1, "partition": 0},
            {"role": "active", "state": "up", "pid": 2, "partition": 1}])],
    "partition_blast_radius": lambda m, r: [
        m.check_partition_blast_radius(r, [
            {"partition": 0, "reconnects": 0, "seqs": [0, 1, 2]}]),
        m.check_partition_blast_radius(r, [
            {"partition": 1, "reconnects": 2},
            {"partition": 1, "reconnects": 0, "seqs": [0, 2]}],
            context="p")],
    "supervisor_adoption": _adoption_case,
    "shm_consistency_fields": lambda m, r: [
        m.check_shm_consistency(r, {"ring"}, {"ring"}),
        m.check_shm_consistency(r, {"ring", "kvexport/g1"},
                                {"ring", "other"}, context="s")],
    "stream_drain": lambda m, r: [
        m.wait_stream_drain(lambda: {"live_streams": 0, "pending": 0},
                            timeout_s=1.0),
        m.wait_stream_drain(lambda: {"live_streams": 2, "pending": 1},
                            timeout_s=0.05)],
    "fleet_converged": lambda m, r: [
        m.wait_fleet_converged(
            lambda: {"replica_restarts": 1, "up": 2, "retired_replicas": 0,
                     "phase_replicas_up": {"prefill": 1, "decode": 1}},
            membership_fn=lambda: [{"url": "a"}, {"url": "b"}],
            restarts_above=0, up=2, phase_up={"prefill": 1, "decode": 1},
            members=2, timeout_s=1.0, poll_s=0.01),
        m.wait_fleet_converged(
            lambda: {"replica_restarts": 5, "up": 2,
                     "retired_replicas": 1}, up=2, timeout_s=0.05,
            poll_s=0.01)],
}


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_check_matches_jax_on_planted_inputs(name):
    """Each check on the same planted inputs: the same verdicts and the
    same violations (invariant, context, structured details); the
    messages too, except ``shm_consistency``'s, which names the status
    it reads."""
    out = {}
    for key, mod in (("jax", jc), ("port", tc)):
        rec = mod.InvariantRecorder()
        verdicts = CHECKS[name](mod, rec)
        out[key] = (verdicts, _violations(rec),
                    [v.message for v in rec.violations])
    assert out["port"][:2] == out["jax"][:2]
    assert True in out["port"][0] or name in ("stream_drain",
                                              "fleet_converged")
    if name == "shm_consistency_fields":
        (message,) = out["port"][2]
        assert "cuda_shm_status inconsistent" in message
        assert out["jax"][2] == [message.replace("cuda_shm", "xla_shm")]
    else:
        assert out["port"][2] == out["jax"][2]


def test_thread_leak_check_matches_jax():
    release = threading.Event()
    leaker = threading.Thread(target=release.wait, name="campaign-leaker",
                              daemon=False)
    out = {}
    baselines = {"jax": jc.thread_baseline(), "port": tc.thread_baseline()}
    assert baselines["jax"] == baselines["port"]
    leaker.start()
    try:
        for key, mod in (("jax", jc), ("port", tc)):
            rec = mod.InvariantRecorder()
            ok = mod.check_no_thread_leaks(rec, baselines[key], grace_s=0.1)
            out[key] = (ok, _violations(rec))
    finally:
        release.set()
        leaker.join(timeout=5)
    assert out["port"] == out["jax"]
    assert out["port"][0] is False


class _MetricsTarget:
    """A stdlib ``/metrics`` endpoint whose exposition the test sets."""

    def __init__(self):
        state = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                body = state.text.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.text = ""
        self.server = HTTPServer(("127.0.0.1", 0), Handler)
        self.url = "127.0.0.1:{}".format(self.server.server_address[1])
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)


def test_metrics_monotonicity_check_matches_jax():
    """Both packages' checks scrape one target through a baseline, an
    increase, a decrease with a vanished family, a rebind and the
    target's death: the same violations, and the same prefix counts."""
    target = _MetricsTarget()
    recs = {"jax": jc.InvariantRecorder(), "port": tc.InvariantRecorder()}
    checks = {k: m.MetricsMonotonicityCheck(target.url, "t", recs[k],
                                            require_prefix=True)
              for k, m in (("jax", jc), ("port", tc))}
    texts = ["tpu_a_total 5\ntpu_b_total 1\n",
             "tpu_a_total 7\ntpu_b_total 1\ntpu_prefix_cache_hits_total 3\n",
             "tpu_a_total 3\ntpu_prefix_cache_hits_total 4\n"]
    try:
        for cycle, text in enumerate(texts):
            target.text = text
            for check in checks.values():
                check.check(cycle)
        for check in checks.values():
            check.rebind(target.url)
            check.check(3)
    finally:
        target.close()
    for check in checks.values():
        assert not check.scrapeable()
        check.check(4)
    assert _violations(recs["port"]) == _violations(recs["jax"])
    assert [v.message for v in recs["port"].violations] == [
        v.message for v in recs["jax"].violations]
    kinds = [v.details["kind"] for v in recs["port"].violations]
    assert sorted(set(kinds)) == ["decreased", "prefix_missing",
                                  "unscrapeable", "vanished"]
    assert checks["port"].prefix_hits == checks["jax"].prefix_hits


def test_campaign_runner_fires_the_same_entries():
    kinds = ["gray_slow", "stream_sever", "partition"]
    fired = {}
    for key, mod in (("jax", jc), ("port", tc)):
        schedule = mod.FaultSchedule.compose(4, kinds, 1, window_s=0.15)
        rec = mod.InvariantRecorder()
        seen = []

        def broken(entry, seen=seen):
            seen.append(entry.kind)
            raise ValueError("injector exploded")

        runner = mod.CampaignRunner(
            schedule, {k: (broken if k == "partition" else
                           (lambda e, seen=seen: seen.append(e.kind)))
                       for k in kinds}, rec)
        runner.run_cycle(0)
        fired[key] = (seen, [e.as_dict() for e in runner.fired],
                      _violations(rec))
        with pytest.raises(ValueError, match="no injector"):
            mod.CampaignRunner(schedule, {}, rec)
    assert fired["port"] == fired["jax"]


def test_minimized_repro_names_the_ports_tool():
    assert tc.minimized_repro(9, 1, ["a", "b"]) == (
        "python -m tpuserver_torch.chaos_campaign --seed 9 --cycles 2 "
        "--faults a,b")
    assert tc.minimized_repro(0, 0, ["x"], tool="t.py",
                              extra_args=("--quick",)) == \
        jc.minimized_repro(0, 0, ["x"], tool="t.py",
                           extra_args=("--quick",))


# -- the shm invariant on a port core -----------------------------------------


def test_shm_consistency_reports_a_leaked_cuda_export_on_a_port_core():
    """A port core keeps a server-owned KV export as the CUDA region
    ``kvexport/<gid>`` (a CPU region here) and answers
    ``xla_shm_status`` with nothing, so a check fed that status could
    never fail.  Fed ``cuda_shm_status``, an export that was never
    released is a violation naming it; once dropped, the check holds."""
    from tpuserver_torch.core import InferenceServer

    core = InferenceServer([])
    try:
        rec = tc.InvariantRecorder()
        assert tc.check_shm_consistency(rec, core.cuda_shm_status(), set())
        core.export_kv_region("leak-1", torch.zeros(2, 2, 1, 8, 2, 4), 5)
        assert core.xla_shm_status() == {}
        assert not tc.check_shm_consistency(
            rec, core.cuda_shm_status(), set(), context="planted")
        (v,) = rec.violations
        assert (v.invariant, v.details["leaked"], v.details["missing"]) == (
            "shm_consistency", ["kvexport/leak-1"], [])
        assert "cuda_shm_status" in v.message
        core.drop_kv_region("leak-1")
        assert tc.check_shm_consistency(rec, core.cuda_shm_status(), set())
        assert rec.count == 1
    finally:
        core.close()


# -- the campaign CLI ---------------------------------------------------------


def _port_cli(*args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "tpuserver_torch.chaos_campaign"]
        + list(args), capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=SRC_PY))


def test_campaign_cli_prints_the_jax_tools_schedule():
    args = ("--print-schedule", "--seed", "11", "--cycles", "2", "--faults",
            "prefill_sigkill,gray_slow,stream_sever,router_sigkill")
    port = _port_cli(*args)
    jax = subprocess.run([sys.executable, JAX_TOOL] + list(args),
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert port.returncode == jax.returncode == 0, port.stderr + jax.stderr
    assert port.stdout == jax.stdout
    assert "schedule seed=11 cycles=2" in port.stdout
    bad = _port_cli("--faults", "warp_core_breach", "--print-schedule")
    assert bad.returncode == 2 and "unknown fault kind" in bad.stderr


@pytest.mark.parametrize("faults", [
    "prefill_sigkill,gray_slow,stream_sever",
    "supervisor_sigkill,replica_sigkill,stream_sever"],
    ids=["default", "supervisor"])
def test_two_cycle_campaign_on_a_stub_fleet_ends_clean(tmp_path, faults):
    """``python -m tpuserver_torch.chaos_campaign``: a supervised stub
    fleet (one prefill and one decode replica, an active and a standby
    ``router_cli`` process on one journal) through two seeded cycles;
    the supervisor case SIGKILLs the supervisor each cycle and its
    successor adopts the survivors.  No violation; the report counts
    every stream."""
    report = tmp_path / "report.json"
    proc = _port_cli("--seed", "0", "--cycles", "2", "--faults", faults,
                     "--json", str(report), timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "chaos campaign OK: seed 0, 2 cycle(s)" in proc.stdout
    data = json.loads(report.read_text())
    assert data["violations"] == []
    assert data["summary"]["cycles_run"] == 2
    assert data["summary"]["streams"] == 12
    if faults.startswith("supervisor"):
        assert data["summary"]["supervisor_restarts"] == 2
        assert data["summary"]["adoptions"] >= 2
