"""``python -m tpuserver_torch.bench_router_tier`` run small beside the
JAX package's ``tools/bench_router_tier.py`` on the same arguments: the
same rows (configs, metrics, keys), and every check of the tool holds on
the port's tier (every stream held and alive, no dial error, no
peer-forwarded stream, a takeover, victims token-identical, survivors
never reconnecting); the selector tier holds its streams on fewer
threads than the threaded control.  Also the descriptor arithmetic and
the exit 2 where the hard limit cannot hold the streams."""

import json
import os
import subprocess
import sys

import pytest

from tpuserver_torch import bench_router_tier

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--streams", "240", "--control-streams", "60",
         "--takeover-streams", "6", "--workers", "2", "--tokens", "16",
         "--token-delay-ms", "50"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src", "python")
    env["JAX_PLATFORMS"] = "cpu"
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Both tools' reports at :data:`SMALL`, run at once."""
    tmp = tmp_path_factory.mktemp("router_tier")
    procs = {}
    for side, head in (
            ("port", ["-m", "tpuserver_torch.bench_router_tier"]),
            ("jax", [os.path.join(REPO, "tools", "bench_router_tier.py")])):
        out = str(tmp / (side + ".json"))
        procs[side] = (out, subprocess.Popen(
            [sys.executable] + head + SMALL + ["--out", out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env(), cwd=str(tmp)))
    got = {}
    for side, (out, proc) in procs.items():
        log, _ = proc.communicate(timeout=240)
        assert proc.returncode == 0, (side, log[-4000:])
        with open(out) as fh:
            got[side] = json.load(fh)
    return got


def test_rows_equal_the_jax_tools(reports):
    port, jax = reports["port"]["rows"], reports["jax"]["rows"]
    assert [(r["config"], r["metric"]) for r in port] == \
        [(r["config"], r["metric"]) for r in jax]
    for row, jrow in zip(port, jax):
        assert set(row) == set(jrow), row["metric"]
        assert row["unit"] == jrow["unit"]


def test_every_check_holds_on_the_port_tier(reports):
    rows = {(r["config"], r["metric"]): r for r in reports["port"]["rows"]}
    held = rows[("3-active selector tier", "concurrent_streams_held")]
    assert held["value"] == 240 and held["vs_baseline"] == 60
    assert held["dial_errors"] == 0 and held["peer_forwarded"] == 0
    sel = rows[("3-active selector tier", "resident_threads_per_router")]
    thr = rows[("threaded-relay control", "resident_threads_per_router")]
    assert sel["value"] < thr["value"]
    assert thr["streams"] == 60
    takeover = rows[("takeover (SIGKILL 1 of 3 actives)",
                     "takeover_window_p99_s")]
    assert takeover["victim_streams"] == 6
    assert takeover["survivor_streams"] == 12
    assert takeover["victim_reconnects"] >= 1
    assert takeover["survivor_reconnects"] == 0
    assert takeover["token_identical"] is True


def test_descriptors_needed_covers_the_busiest_process():
    # the upstream holds every stream; a router two a partition's share
    assert bench_router_tier.descriptors_needed(10200, 1000, 4) == (
        bench_router_tier.FD_SLACK + 10200)
    assert bench_router_tier.descriptors_needed(300, 1000, 4) == (
        bench_router_tier.FD_SLACK + 2000)


def test_exits_2_when_the_hard_limit_cannot_hold_the_streams():
    """A process whose hard limit is below the count refuses before it
    spawns anything (the limit lowered in the child alone)."""
    code = ("import resource, sys\n"
            "resource.setrlimit(resource.RLIMIT_NOFILE, (256, 256))\n"
            "from tpuserver_torch import bench_router_tier\n"
            "sys.exit(bench_router_tier.main(['--streams', '10200']))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=60)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "RLIMIT_NOFILE's hard limit is 256" in proc.stderr
    assert "phase 1" not in proc.stdout
